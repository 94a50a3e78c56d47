// Deformable 2-D convolution v1, forward, channels-last bf16: a 3x3 conv
// with stride 1 and dilation 1 whose taps are moved by float32 offsets,
// (N, H, W, C) -> (N, Ho, Wo, Cout), in one launch: the bilinear sampling,
// its weighting, the boundary rules and the contraction.  The deformed
// im2col tensor never reaches device memory.
//
// Replaces no TPU kernel: rtpose_tpu/ops/deform_conv.py builds the same
// function from XLA gathers and an einsum, and the plain version beside this
// kernel (rtpose_tpu_torch/ops/deform_conv.py::_columns) from index_select
// and a matmul, writing every stage (a padded four-corner copy of the input,
// an int64 index per sample, the (samples, 4, C / dg) gather, eight bf16
// elementwise passes over the column tensors) to device memory and reading
// it back.  Added for the deformable head's eval path, where that took ~70 ms
// a conv at B * Z = 128 images of 64 x 160 x 128 channels.
//
// Bound on the H100: one conv at that shape does 2 * 1,310,720 * 1,152 * 128
// = 386.5 GFLOP (0.39 ms at 989 TFLOP/s) and must move x (335.5 MB bf16),
// the float32 offsets (377.5 MB) and the output (335.5 MB): 1.05 GB, 0.31 ms
// at 3.35 TB/s.  Inside the SM the limit is the corner reads: every sample
// reads four corners of C / dg channels, ~12 GB a conv, which neighbouring
// positions and taps share, so they come from L1 and L2.
//
// Design (implicit GEMM, M = output positions, N = 128 output channels, K =
// 9 taps x C input channels):
//   * a persistent grid (one block of two warpgroups a SM) walks tiles of
//     128 consecutive output positions (n, y, x) and, for Cout > 128, blocks
//     of 128 output channels.  A tile's offsets (128 x dg x 18 float32, one
//     contiguous run) are copied to shared memory with cp.async while the
//     tile before it computes;
//   * K is walked in steps of 64 input channels of one tap, tap-major (tap k
//     = ky * 3 + kx, the plain version's order).  In each step a thread
//     samples 8 channels (one group's: C / dg a multiple of 8) at 4 positions,
//     8 lanes a position: the sample position in float32 exactly as the
//     plain version computes it (the integer base grid rounded to bf16, the
//     float32 offset added in float32), the same boundary rules (a moved
//     center outside (-1, H) x (-1, W) is zero; each corner off the map is
//     zero on its own), each corner one 16-byte load through L1 (the 8 lanes
//     of a position read 128 contiguous bytes, so a warp's load touches 4
//     cache lines), the bilinear sum formed in float32 and rounded once to
//     bf16 into the step's A tile in shared memory;
//   * the A tile (128 x 64 bf16) and the step's weights (64 x 128 bf16,
//     cp.async from the (9, C / 64, Cout, 64) [tap][ci / 64][co][ci % 64]
//     layout the wrapper prepares) are K-major 128-byte rows with the 128B
//     swizzle, so the wgmma reads and the sampling threads' 16-byte stores
//     (8 lanes: one row's 8 chunks) are free of bank conflicts;
//   * two warpgroups each own 64 rows: wgmma.mma_async m64n128k16, bf16 in,
//     float32 accumulators in registers, four a step;
//   * A and B are double-buffered and the MMAs are asynchronous: step s's
//     products run on the tensor cores while the threads sample step s + 1
//     of the tile; one barrier a step;
//   * the epilogue rounds the float32 sums to bf16 once and stores the
//     tile's rows of (n, Ho, Wo, Cout).  No split-K and no atomics:
//     deterministic, so a CUDA-graph replay equals the eager call bit for bit.
// A sample reads global memory wherever its offset takes it: no halo, no
// assumption on the offsets' size.  At the cell's shape the sampling, not
// the tensor cores, sets the time: the kernel takes ~3.6 ms a conv on an H100,
// ~9x its bound (PERF.md).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kM = 128;                  // output positions a tile
constexpr int kN = 128;                  // output channels a block
constexpr int kKC = 64;                  // input channels a step: one 128-byte row of A and of B
constexpr int kThreads = 256;            // two warpgroups
constexpr int kPos = 4;                  // positions a thread samples a step
constexpr int kTileBytes = kM * 128;     // 16 KB: A or B of one step (kN == kM)
constexpr int kMaxSmem = 232448;         // 227 KB, the H100's block limit

struct Params {
  const __nv_bfloat16* x;    // (N, H, W, C)
  const float* off;          // (N, Ho, Wo, dg * 18), [group][tap][dy, dx]
  const __nv_bfloat16* w;    // (9, C / 64, Cout, 64)
  __nv_bfloat16* out;        // (N, Ho, Wo, Cout)
  long long positions;       // N * Ho * Wo
  long long tiles;           // ceil(positions / kM)
  int H, W, C, Ho, Wo, Cout, cg, pad;
  int q;                     // steps a tap: C / kKC
  int nblk;                  // output-channel blocks: Cout / kN
  int off_bytes;             // a tile's offsets: kM * dg * 18 float32
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// The 128-byte swizzle of a shared-memory address: the 16-byte chunk within
// a 128-byte row XOR the row's index within its 1 KB atom, as wgmma reads
// an operand laid out with the 128B swizzle
__device__ __forceinline__ uint32_t swizzle(uint32_t addr) { return addr ^ ((addr >> 3) & 0x70); }

// wgmma descriptor of a K-major operand in 128-byte rows with the 128B
// swizzle: 8-row atoms 1 KB apart (SBO), the start advanced 32 bytes a k16
// step within the row
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (1ull << 16) | (64ull << 32) |
         (1ull << 62);
}

__device__ __forceinline__ void acc_fence(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// The zeroing is a volatile asm move, as in conv_k3.cu: the compiler may not
// sink it in between the wgmmas
__device__ __forceinline__ void acc_zero(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("mov.b32 %0, 0;" : "=f"(d[i]));
}

// D (64 x 128, f32) += A (64 x 16, bf16, smem) * B (16 x 128, bf16, smem),
// both K-major
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]),
        "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]),
        "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),
        "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "n"(1));
}

// 16 bytes global -> shared, of which the first `bytes` are read and the
// rest are zero
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, uint32_t bytes = 16) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(dst), "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

// One step's weights, the block's 128 output channels' rows of 64 input
// channels, into the B tile at `dst`: 1,024 16-byte chunks, four a thread
__device__ __forceinline__ void load_weights(const Params& p, uint32_t dst, int tap, int q,
                                             int nb, int tid) {
  const __nv_bfloat16* src =
      p.w + ((static_cast<long long>(tap) * p.q + q) * p.Cout + nb * kN) * kKC;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int j = tid + r * kThreads;  // row j / 8, chunk j % 8
    cp_async16(swizzle(dst + j * 16), src + j * 8);
  }
}

// A tile's offsets, contiguous in device memory, into `dst`; past the last
// position, zeros
__device__ __forceinline__ void load_offsets(const Params& p, uint32_t dst, long long tile,
                                             int tid) {
  const char* src = reinterpret_cast<const char*>(p.off) + tile * p.off_bytes;
  const long long left = (p.positions - tile * kM) * (p.off_bytes / kM);  // bytes to the end
  for (int j = tid * 16; j < p.off_bytes; j += kThreads * 16) {
    const long long n = left - j;  // zero-filled past the end
    cp_async16(dst + j, n > 0 ? src + j : src,
               n >= 16 ? 16u : n > 0 ? static_cast<uint32_t>(n) : 0u);
  }
}

__device__ __forceinline__ float lo_f(uint32_t v) { return __uint_as_float(v << 16); }
__device__ __forceinline__ float hi_f(uint32_t v) { return __uint_as_float(v & 0xffff0000u); }

__device__ __forceinline__ uint32_t word(const uint4& v, int e) {
  return e == 0 ? v.x : e == 1 ? v.y : e == 2 ? v.z : v.w;
}

__device__ __forceinline__ uint32_t pack_bf16(float a, float b) {
  __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<uint32_t*>(&h);
}

// Channels c0 .. c0 + 7 of tap `tap` at the thread's kPos positions (row
// m[r] of the tile; image n[r], or -1 past the last position; y, x packed in
// yx[r]), moved by the tile's offsets at `offs`: one 16-byte chunk of each
// position's row of the A tile at `a`.  The 8 lanes that share a position
// read 128 contiguous bytes of each corner, so a warp's load touches 4 cache
// lines
__device__ __forceinline__ void sample(const Params& p, const int (&m)[kPos], const int (&n)[kPos],
                                       const int (&yx)[kPos], int tap, int c0, const char* offs,
                                       uint32_t a) {
  const int ky = tap / 3, kx = tap - 3 * (tap / 3);
  const int pos_bytes = (p.C / p.cg) * 18 * 4;          // one position's offsets
  const int ot = ((c0 / p.cg) * 9 + tap) * 8;           // its group's (dy, dx) at this tap
  float wt[kPos][4];
  uint4 v[kPos][4];  // all 16 corner loads in flight together
#pragma unroll
  for (int r = 0; r < kPos; ++r) {
    const float2 o = *reinterpret_cast<const float2*>(offs + m[r] * pos_bytes + ot);
    const int y = yx[r] >> 16, x = yx[r] & 0xffff;
    // the base grid in the input's dtype (exact up to 256), as the plain version builds it
    const float gy = __bfloat162float(__float2bfloat16_rn(static_cast<float>(y - p.pad + ky)));
    const float gx = __bfloat162float(__float2bfloat16_rn(static_cast<float>(x - p.pad + kx)));
    const float ys = gy + o.x, xs = gx + o.y;
    const bool inside = n[r] >= 0 && ys > -1.0f && ys < static_cast<float>(p.H) &&
                        xs > -1.0f && xs < static_cast<float>(p.W);
    bool cok[4] = {false, false, false, false};
    int y0 = 0, x0 = 0;
#pragma unroll
    for (int c = 0; c < 4; ++c) wt[r][c] = 0.0f;
    if (inside) {
      const float y0f = floorf(ys), x0f = floorf(xs);
      const float wy = ys - y0f, wx = xs - x0f;
      y0 = static_cast<int>(y0f);
      x0 = static_cast<int>(x0f);
      wt[r][0] = (1.0f - wy) * (1.0f - wx);
      wt[r][1] = (1.0f - wy) * wx;
      wt[r][2] = wy * (1.0f - wx);
      wt[r][3] = wy * wx;
      cok[0] = y0 >= 0 && x0 >= 0;
      cok[1] = y0 >= 0 && x0 + 1 < p.W;
      cok[2] = y0 + 1 < p.H && x0 >= 0;
      cok[3] = y0 + 1 < p.H && x0 + 1 < p.W;
    }
    const __nv_bfloat16* src =
        p.x + ((static_cast<long long>(n[r] > 0 ? n[r] : 0) * p.H + y0) * p.W + x0) * p.C + c0;
#pragma unroll
    for (int c = 0; c < 4; ++c)
      v[r][c] = cok[c] ? __ldg(reinterpret_cast<const uint4*>(
                             src + ((c >> 1) * static_cast<long long>(p.W) + (c & 1)) * p.C))
                       : make_uint4(0, 0, 0, 0);
  }
#pragma unroll
  for (int r = 0; r < kPos; ++r) {
    uint32_t res[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float lo = 0.0f, hi = 0.0f;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const uint32_t u = word(v[r][c], e);
        lo = fmaf(wt[r][c], lo_f(u), lo);
        hi = fmaf(wt[r][c], hi_f(u), hi);
      }
      res[e] = pack_bf16(lo, hi);
    }
    asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};" ::"r"(
                     swizzle(a + m[r] * 128 + (c0 % kKC) * 2)),
                 "r"(res[0]), "r"(res[1]), "r"(res[2]), "r"(res[3])
                 : "memory");
  }
}

// The tile's sums, rounded once to bf16: row wg * 64 + warp * 16 + lane / 4
// (+ 8), columns 8 j + 2 (lane % 4) (+ 1) of the block's 128
__device__ __forceinline__ void store(const Params& p, const float (&acc)[64], long long work,
                                      int tid) {
  const long long tile = work / p.nblk;
  const int nb = static_cast<int>(work - tile * p.nblk);
  const int lane = tid % 32;
  const int row = (tid / 128) * 64 + ((tid % 128) / 32) * 16 + lane / 4;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const long long mg = tile * kM + row + 8 * h;
    if (mg >= p.positions) continue;
    __nv_bfloat16* o = p.out + mg * p.Cout + nb * kN + (lane % 4) * 2;
#pragma unroll
    for (int j = 0; j < 16; ++j)
      *reinterpret_cast<uint32_t*>(o + 8 * j) =
          pack_bf16(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
  }
}

__global__ void __launch_bounds__(kThreads, 1) deform_conv2d_fwd_kernel(const Params p) {
  extern __shared__ __align__(1024) uint8_t smem[];
  const uint32_t a_base = (smem_u32(smem) + 1023) & ~1023u;  // swizzle atoms are 1 KB
  const uint32_t b_base = a_base + 2 * kTileBytes;
  const uint32_t o_base = b_base + 2 * kTileBytes;           // two tiles' offsets
  const int tid = threadIdx.x;
  const int half = tid / 128;  // the thread's warpgroup: rows 64 half .. 64 half + 63
  // the thread samples channels 8 (lane % 8) .. + 7 of a step at rows
  // 16 warp + 4 r + lane / 8 of the tile
  const int c8 = 8 * (tid % 8);
  int m[kPos];
#pragma unroll
  for (int r = 0; r < kPos; ++r) m[r] = (tid / 32) * 16 + 4 * r + (tid % 32) / 8;
  const int steps = 9 * p.q;
  const long long works = p.tiles * p.nblk;
  long long work = blockIdx.x;
  if (work >= works) return;
  float acc[64];
  // the first tile's offsets, read before the first wait of the loop, and its first weights
  load_offsets(p, o_base, work / p.nblk, tid);
  load_weights(p, b_base, 0, 0, static_cast<int>(work % p.nblk), tid);
  cp_async_commit();
  asm volatile("cp.async.wait_group 0;" ::: "memory");
  __syncthreads();
  int buf = 0, obuf = 0;
  for (; work < works; work += gridDim.x, obuf ^= 1) {
    const long long tile = work / p.nblk;
    int n[kPos], yx[kPos];
#pragma unroll
    for (int r = 0; r < kPos; ++r) {
      const long long mg = tile * kM + m[r];
      const long long hw = static_cast<long long>(p.Ho) * p.Wo;
      const int img = static_cast<int>(mg / hw);
      const int rem = static_cast<int>(mg - img * hw);
      n[r] = mg < p.positions ? img : -1;
      yx[r] = ((rem / p.Wo) << 16) | (rem % p.Wo);
    }
    const char* offs = reinterpret_cast<const char*>(smem) + (o_base - smem_u32(smem)) +
                       obuf * p.off_bytes;
    acc_zero(acc);  // no product in flight: the last tile's were waited for
    for (int s = 0; s < steps; ++s) {
      const int tap = s / p.q, c0 = (s - tap * p.q) * kKC + c8;
      // sample step s while the tensor cores run step s - 1
      sample(p, m, n, yx, tap, c0, offs, a_base + buf * kTileBytes);
      // step s's weights; at step 1 the next tile's offsets may still load
      if (s == 1)
        asm volatile("cp.async.wait_group 1;" ::: "memory");
      else
        asm volatile("cp.async.wait_group 0;" ::: "memory");
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
      acc_fence(acc);
      __syncthreads();  // step s's tiles complete; step s - 1's products read theirs
      long long next = work;
      int ns = s + 1;
      if (ns == steps) {
        ns = 0;
        next += gridDim.x;
      }
      if (next < works)
        load_weights(p, b_base + (buf ^ 1) * kTileBytes, ns / p.q, ns % p.q,
                     static_cast<int>(next % p.nblk), tid);
      cp_async_commit();
      if (s == 0) {  // the next tile's offsets, into the other buffer (its last reader was
                     // the tile before this one)
        if (work + gridDim.x < works)
          load_offsets(p, o_base + (obuf ^ 1) * p.off_bytes, (work + gridDim.x) / p.nblk, tid);
        cp_async_commit();
      }
      const uint32_t a_tile = a_base + buf * kTileBytes + half * 64 * 128;
      const uint32_t b_tile = b_base + buf * kTileBytes;
      asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
#pragma unroll
      for (int ks = 0; ks < 4; ++ks)
        wgmma_m64n128k16(acc, smem_desc(a_tile + ks * 32), smem_desc(b_tile + ks * 32));
      asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
      acc_fence(acc);
      buf ^= 1;
    }
    // the epilogue waits for the tile's last products (ptxas 12.9 crashes on
    // an epilogue deferred into the next tile's first step)
    asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
    acc_fence(acc);
    store(p, acc, work, tid);
  }
}

}  // namespace

// x: (N, H, W, C) bf16, 16-byte aligned; off: (N, Ho, Wo, dg * 18) float32,
// 16-byte aligned; w: (9, C / 64, Cout, 64) bf16 [ky * 3 + kx][ci / 64][co][ci
// % 64], 16-byte aligned; out: (N, Ho, Wo, Cout) bf16.  C a multiple of 64,
// C / dg of 8, Cout of 128, dg at most 8 (two tiles' offsets in shared
// memory); Ho = H + 2 pad - 2, Wo = W + 2 pad - 2, both below 65536.  grid:
// blocks of the persistent launch.  Returns cudaGetLastError(), or
// cudaErrorInvalidValue if dg needs more shared memory than a block has.
extern "C" int rtpose_deform_conv2d(const void* x, const void* off, const void* w, void* out,
                                    int N, int H, int W, int C, int Cout, int dg, int pad,
                                    int grid, void* stream) {
  static uint64_t attr_set = 0;
  int device = 0;
  cudaGetDevice(&device);
  if (device < 64 && !((attr_set >> device) & 1)) {
    cudaFuncSetAttribute(deform_conv2d_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         kMaxSmem);
    attr_set |= 1ull << device;
  }
  Params p;
  p.x = static_cast<const __nv_bfloat16*>(x);
  p.off = static_cast<const float*>(off);
  p.w = static_cast<const __nv_bfloat16*>(w);
  p.out = static_cast<__nv_bfloat16*>(out);
  p.H = H;
  p.W = W;
  p.C = C;
  p.Ho = H + 2 * pad - 2;
  p.Wo = W + 2 * pad - 2;
  p.Cout = Cout;
  p.cg = C / dg;
  p.pad = pad;
  p.q = C / kKC;
  p.nblk = Cout / kN;
  p.positions = static_cast<long long>(N) * p.Ho * p.Wo;
  p.tiles = (p.positions + kM - 1) / kM;
  p.off_bytes = kM * dg * 18 * 4;
  // A and B double-buffered, two tiles' offsets, and 1 KB to align the swizzle atoms
  const int smem_bytes = 4 * kTileBytes + 2 * p.off_bytes + 1024;
  if (smem_bytes > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  deform_conv2d_fwd_kernel<<<grid, kThreads, smem_bytes, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}
