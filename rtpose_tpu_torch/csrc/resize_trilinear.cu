// Trilinear resize with align_corners=True, forward, channels-last bf16:
// (B, Zi, Yi, Xi, C) -> (B, Zo, Yo, Xo, C), optionally plus an addend of the
// output's shape, written to a buffer whose voxels may be wider than C (a
// channel slice of a concat).
//
// Replaces no TPU kernel: rtpose_tpu/ops/interpolate.py writes the resize as
// three single-axis interpolation einsums for XLA.  Added for HRNet's fuse
// layers and final fuse (models/hrnet3d.py), where the plain version beside
// this kernel (rtpose_tpu_torch/ops/interpolate.py::resize_reference: a
// permute to channels-first, ATen's upsample_trilinear3d, whose threads walk
// every batch item and channel at a stride of a whole volume, a permute back
// with a copy, then a separate bf16 add or torch.cat) took ~9.4 ms of a
// ~23.4 ms B=8 batch of the flagship on an H100.
//
// Arithmetic: ATen's.  Per output index along each axis, the source index
// r = scale * o with the float32 scale (in - 1) / (out - 1), i0 its floor,
// i1 = i0 + 1 clamped at the edge, the weights 1 - (r - i0) and r - i0; the
// blend along x, then y, then z, in ATen's nesting
//   t0 * (h0 * (w0 * x000 + w1 * x001) + h1 * (w0 * x010 + w1 * x011)) + t1 * (...)
// in float32, each product and sum rounded on its own (__fmul_rn,
// __fadd_rn: no fma, so ops/interpolate.py::kernel_reference models it bit
// for bit; ATen's compiled kernel may contract some into fma, within one bf16
// ulp), rounded once to bf16.  The addend's epilogue rounds as the two
// operations it replaces: bf16(addend + bf16(resize)).
//
// Bound on the H100: bytes.  No arithmetic to speak of; the output written
// (and the addend read) dominate, the input is 1/8 to 1/512 of the output.
// The flagship's 13 resizes a frame write ~120 MB and read ~73 MB (addends
// and inputs): 0.058 ms a frame at 3.35 TB/s.
//
// Design, one kernel:
//   * a block owns `rows` consecutive output rows (b, zo, yo..) of one
//     output plane.  They read two input planes (z0, z1) and the input rows
//     y0 of the first to y1 of the last: the block copies those rows, whole
//     (Xi x C, contiguous in the input), into shared memory with 16-byte
//     cp.async, once; neighbouring output rows of an up-sample read the same
//     input rows from there;
//   * a thread owns one 16-byte output vector (8 channels) of an output x in
//     every row of the block (the wrapper sizes the block so its threads
//     cover whole rows).  It blends along x for the four (plane, row) pairs
//     an output row reads and keeps the four blends in registers while the
//     next rows read the same input rows, then blends along y and z, rounds,
//     adds the addend, and stores: a warp's 32 stores are 512 contiguous
//     bytes of a row (in 64-byte runs for a 32-channel slice of a wider
//     buffer), coalesced;
//   * nothing is accumulated across blocks: no atomics, every launch on the
//     same input gives the same bits, so a CUDA graph replay equals the
//     eager call.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 512;
constexpr int kMaxSmem = 96 * 1024;

struct Params {
  const uint4* x;       // (B, Zi, Yi, Xi, C) bf16, 8 channels a vector
  const uint4* addend;  // (B, Zo, Yo, Xo, C) bf16, or null
  uint4* out;           // (B, Zo, Yo, Xo) voxels of `stride` vectors, the first V written
  int Zi, Yi, Xi, Zo, Yo, Xo;
  int V;                // C / 8
  int stride;           // vectors between neighbouring output voxels
  int rows;             // output rows a block
  int tiles;            // blocks an output plane: ceil(Yo / rows)
  float sz, sy, sx;     // (in - 1) / (out - 1), or 0 for one output
};

struct Axis {
  int i0, i1;
  float l0, l1;
};

__host__ __device__ __forceinline__ float mul_rn(float a, float b) {
#ifdef __CUDA_ARCH__
  return __fmul_rn(a, b);
#else
  return a * b;
#endif
}

__host__ __device__ __forceinline__ float sub_rn(float a, float b) {
#ifdef __CUDA_ARCH__
  return __fsub_rn(a, b);
#else
  return a - b;
#endif
}

// ATen's area_pixel_compute_source_index for align_corners, then its floor,
// edge clamp and weights (UpSampleTrilinear3d.cu)
__host__ __device__ __forceinline__ Axis axis(float scale, int o, int n_in) {
  const float r = mul_rn(scale, static_cast<float>(o));
  Axis a;
  a.i0 = static_cast<int>(r);
  a.i1 = a.i0 + (a.i0 < n_in - 1 ? 1 : 0);
  a.l1 = sub_rn(r, static_cast<float>(a.i0));
  a.l0 = sub_rn(1.0f, a.l1);
  return a;
}

// Eight bf16 (a 16-byte vector, element 0 in the low half of .x) to float32.
__device__ __forceinline__ void unpack(const uint4& v, float (&f)[8]) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    f[2 * k] = __uint_as_float(w[k] << 16);
    f[2 * k + 1] = __uint_as_float(w[k] & 0xffff0000u);
  }
}

__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

__device__ __forceinline__ uint4 pack8(const float (&f)[8]) {
  uint4 o;
  o.x = pack(f[0], f[1]);
  o.y = pack(f[2], f[3]);
  o.z = pack(f[4], f[5]);
  o.w = pack(f[6], f[7]);
  return o;
}

// w0 * a + w1 * b for the 8 channels of a and b
__device__ __forceinline__ void blend_x(const uint4& a, const uint4& b, float w0, float w1,
                                        float (&q)[8]) {
  float fa[8], fb[8];
  unpack(a, fa);
  unpack(b, fb);
#pragma unroll
  for (int j = 0; j < 8; ++j) q[j] = __fadd_rn(__fmul_rn(w0, fa[j]), __fmul_rn(w1, fb[j]));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(d), "l"(src) : "memory");
}

__global__ void __launch_bounds__(kMaxThreads) upsample_trilinear3d_cl_kernel(Params p) {
  extern __shared__ uint4 smem[];
  const int tile = blockIdx.x % p.tiles;
  const int plane = blockIdx.x / p.tiles;  // b * Zo + zo
  const int b = plane / p.Zo;
  const int zo = plane - b * p.Zo;
  const int yo0 = tile * p.rows;
  const int yo1 = min(p.Yo, yo0 + p.rows);
  const Axis az = axis(p.sz, zo, p.Zi);
  const int ya = axis(p.sy, yo0, p.Yi).i0;
  const int row_vecs = p.Xi * p.V;
  const int span = (axis(p.sy, yo1 - 1, p.Yi).i1 - ya + 1) * row_vecs;

  // the rows ya.. of planes z0 and z1 (one copy where they are the same plane)
  const uint4* src0 = p.x + (static_cast<long long>(b * p.Zi + az.i0) * p.Yi + ya) * row_vecs;
  const uint4* src1 = p.x + (static_cast<long long>(b * p.Zi + az.i1) * p.Yi + ya) * row_vecs;
  const uint4* s0 = smem;
  const uint4* s1 = az.i1 != az.i0 ? smem + span : smem;
  for (int i = threadIdx.x; i < span; i += blockDim.x) cp_async16(smem + i, src0 + i);
  if (az.i1 != az.i0)
    for (int i = threadIdx.x; i < span; i += blockDim.x) cp_async16(smem + span + i, src1 + i);
  asm volatile("cp.async.wait_all;" ::: "memory");
  __syncthreads();

  const int items = p.Xo * p.V;
  for (int it = threadIdx.x; it < items; it += blockDim.x) {
    const int xo = it / p.V;
    const int v = it - xo * p.V;
    const Axis ax = axis(p.sx, xo, p.Xi);
    const int c0 = ax.i0 * p.V + v;
    const int c1 = ax.i1 * p.V + v;
    // the x blends of (plane z0, row y0), (z0, y1), (z1, y0), (z1, y1)
    float q00[8], q01[8], q10[8], q11[8];
    int cached = -1;
    for (int yo = yo0; yo < yo1; ++yo) {
      const Axis ay = axis(p.sy, yo, p.Yi);
      if (ay.i0 != cached) {  // the same for the whole block
        const int r0 = (ay.i0 - ya) * row_vecs;
        const int r1 = (ay.i1 - ya) * row_vecs;
        blend_x(s0[r0 + c0], s0[r0 + c1], ax.l0, ax.l1, q00);
        blend_x(s0[r1 + c0], s0[r1 + c1], ax.l0, ax.l1, q01);
        blend_x(s1[r0 + c0], s1[r0 + c1], ax.l0, ax.l1, q10);
        blend_x(s1[r1 + c0], s1[r1 + c1], ax.l0, ax.l1, q11);
        cached = ay.i0;
      }
      float f[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float y0 = __fadd_rn(__fmul_rn(ay.l0, q00[j]), __fmul_rn(ay.l1, q01[j]));
        const float y1 = __fadd_rn(__fmul_rn(ay.l0, q10[j]), __fmul_rn(ay.l1, q11[j]));
        f[j] = __fadd_rn(__fmul_rn(az.l0, y0), __fmul_rn(az.l1, y1));
      }
      const long long voxel = (static_cast<long long>(plane) * p.Yo + yo) * p.Xo + xo;
      uint4 o = pack8(f);
      if (p.addend != nullptr) {
        float a[8], r[8];
        unpack(__ldg(p.addend + voxel * p.V + v), a);
        unpack(o, r);
#pragma unroll
        for (int j = 0; j < 8; ++j) f[j] = __fadd_rn(a[j], r[j]);
        o = pack8(f);
      }
      p.out[voxel * p.stride + v] = o;
    }
  }
}

}  // namespace

// x: (B, Zi, Yi, Xi, C) bf16, contiguous; addend: (B, Zo, Yo, Xo, C) bf16,
// contiguous, or null; out: (B, Zo, Yo, Xo) voxels of `stride` bf16 (the
// first C written): all 16-byte aligned, C and stride multiples of 8, stride
// >= C.  rows: output rows a block; threads: a block's, a multiple of 32 up
// to 512.  Returns cudaGetLastError(), or cudaErrorInvalidValue for shapes it
// does not take (a block's input rows beyond the shared memory it may use).
extern "C" int rtpose_resize_trilinear(const void* x, const void* addend, void* out, int B,
                                       int Zi, int Yi, int Xi, int Zo, int Yo, int Xo, int C,
                                       int stride, int rows, int threads, void* stream) {
  if (B <= 0 || Zi <= 0 || Yi <= 0 || Xi <= 0 || Zo <= 0 || Yo <= 0 || Xo <= 0 || C <= 0 ||
      C % 8 != 0 || stride % 8 != 0 || stride < C || rows <= 0 || threads <= 0 ||
      threads > kMaxThreads || threads % 32 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  static uint64_t attr_set = 0;
  int device = 0;
  cudaGetDevice(&device);
  if (device < 64 && !((attr_set >> device) & 1)) {
    cudaFuncSetAttribute(upsample_trilinear3d_cl_kernel,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    attr_set |= 1ull << device;
  }
  Params p;
  p.x = static_cast<const uint4*>(x);
  p.addend = static_cast<const uint4*>(addend);
  p.out = static_cast<uint4*>(out);
  p.Zi = Zi;
  p.Yi = Yi;
  p.Xi = Xi;
  p.Zo = Zo;
  p.Yo = Yo;
  p.Xo = Xo;
  p.V = C / 8;
  p.stride = stride / 8;
  p.rows = rows;
  p.tiles = (Yo + rows - 1) / rows;
  p.sz = Zo > 1 ? static_cast<float>(Zi - 1) / static_cast<float>(Zo - 1) : 0.0f;
  p.sy = Yo > 1 ? static_cast<float>(Yi - 1) / static_cast<float>(Yo - 1) : 0.0f;
  p.sx = Xo > 1 ? static_cast<float>(Xi - 1) / static_cast<float>(Xo - 1) : 0.0f;
  // the most input rows a block reads, as the kernel finds them
  int span = 0;
  for (int t = 0; t < p.tiles; ++t) {
    const int last = (t + 1) * rows < Yo ? (t + 1) * rows - 1 : Yo - 1;
    const int n = axis(p.sy, last, Yi).i1 - axis(p.sy, t * rows, Yi).i0 + 1;
    span = n > span ? n : span;
  }
  const long long smem = 2LL * span * Xi * C * 2;
  const long long grid = static_cast<long long>(B) * Zo * p.tiles;
  if (smem > kMaxSmem || grid > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  upsample_trilinear3d_cl_kernel<<<static_cast<unsigned>(grid), threads, smem,
                                   static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}
