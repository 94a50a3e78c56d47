// Stride-1 3x3x3 convolution, 32 -> 32 channels, on channels-last bf16
// volumes: (B, Z, Y, X, 32) -> (B, Z, Y, X, 32), float32 accumulation,
// optional float32 bias added before the one rounding to bf16.  The same
// kernel runs the grad-input conv of the backward on flipped,
// channel-swapped weights.
//
// Replaces the TPU kernel of rtpose_tpu/ops/pallas_conv.py: _pallas_forward
// (_kernel at :105-145, pallas_call at :176), reached through _fused and
// conv3d_folded_gather_fast, and its grad-input in _fused_bwd (:211-217).
// Like the Pallas kernel it keeps whole rows of input planes resident and
// reads every tap as a shifted flat-row view of one buffer; it drops the
// TPU's X-fold, (8, 128) tiling and slab sizing.
//
// Bound on the H100: operations.  Per output voxel the conv does
// 27 * 32 * 32 multiply-adds (55,296 FLOP) over 64 bytes read and 64 bytes
// written, about 430 FLOP per byte, above the card's ~295 bf16 FLOP/byte
// ridge.  At (1, 16, 64, 160), 163,840 voxels, that is 9.06 GFLOP, about
// 9.2 us at 989 TFLOP/s.  Inside the SM the limit is shared-memory reads:
// a wgmma reads its A (64 x 16) and B (16 x N) tiles from shared memory,
// so with N = 32 (the output channels) it reads 3 KB per 64 x 32 x 16
// product, faster than the SM's 128 B/clock can feed the tensor cores.
//
// Design (implicit GEMM, M = output positions, N = 3 x 32, K = 9 x 32):
//   * persistent grid of about one block per SM; the work is the list of
//     tile-planes (b, y tile, x tile, z) with z fastest, and each block
//     takes one contiguous range of it, walking each column's input planes
//     in z order: every input plane of a column is loaded once;
//   * the weights, 55,296 B laid out [dy * 3 + dx][ci / 8][dz][co][ci % 8],
//     are loaded into shared memory once per block by bulk copies, in three
//     parts (one per dy, each behind its own mbarrier) interleaved with the
//     first input planes, so the math starts before the last part lands;
//   * one producer warp streams input planes through a ring of S stages
//     with TMA (cp.async.bulk.tensor, completion on mbarriers).  A stage
//     holds the tile's halo, (Ty + 2) rows of Wp = Tx + 2 positions, stored
//     channel-chunk planar: [c8 in 0..3][y * Wp + x][8 channels], four box
//     loads of a 16-byte inner extent.  The tensor map's out-of-bounds zero
//     fill is the conv's zero padding;
//   * output rows M are the same flattened padded (y, x) positions
//     m = ty * Wp + tx, so for tap (dy, dx) the A operand is the stage at
//     position offset dy * Wp + dx: every 8-row core matrix is 128
//     contiguous bytes (M stride 128 B, K stride one c8 plane), a plain
//     unswizzled wgmma descriptor, free of bank conflicts.  The two pad
//     columns of each row are computed and dropped;
//   * dz is folded into N: input plane p is the A operand once, against
//     the three dz slices of the weights side by side (wgmma.mma_async
//     m64n96k16, bf16 in, float32 accumulators in registers, 9 taps x 2
//     K-steps), and its three 32-column parts add into the running sums of
//     output planes p + 1, p and p - 1.  After plane p the sum of output
//     p - 1 is complete and the sums shift down one plane (the 48
//     accumulators of a wgmma are one contiguous register range, so they
//     shift rather than rotate).  Each product reads 5 KB of shared memory
//     for 64 x 96 x 16, not 9 KB;
//   * two consumer warpgroups each own one or two 64-row blocks of the
//     tile; each input plane is released as soon as its products are done,
//     so the producer refills the ring under the epilogue and the next
//     plane's math;
//   * the epilogue adds the bias in float32, rounds once and stores only
//     the valid (y, x) rows of the range's own output planes.  No split-K
//     and no atomics: deterministic.
// The tile shape (Tx, Ty, blocks per warpgroup, stages) comes from the
// wrapper's launch plan (rtpose_tpu_torch/ops/conv_k3.py::plan).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kC = 32;
constexpr int kN = 3 * kC;                   // dz x co: the wgmma's N
constexpr int kChunkBytes = kN * 16;         // 1,536: one (tap, ci/8) chunk of B
constexpr int kTapBytes = 4 * kChunkBytes;   // 6,144: one (dy, dx) tap, all dz
constexpr int kWBytes = 9 * kTapBytes;       // 55,296
constexpr int kConsumers = 2;                // consumer warpgroups
constexpr int kThreads = kConsumers * 128 + 32;  // + one producer warp
constexpr int kMaxSmem = 232448;             // 227 KB, the H100's block limit

struct Params {
  const float* bias;
  __nv_bfloat16* out;
  long long tiles;  // tile-planes: B * ny * nx * Z
  int Z, Y, X;
  int wp, ty;       // padded row width (Tx + 2), output rows per tile
  int positions;    // positions per c8 plane of a stage (multiple of 8)
  int stages;
  int nx, ny;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_u32(bar)) : "memory");
}

// wait until the phase of parity `parity` has completed (the spin loop
// inside the asm, as a divergent C++ loop can make ptxas serialize wgmma)
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n"
      "}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}

__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];" ::"r"(
          smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ void tma_load_5d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2, int c3, int c4) {
  asm volatile(
      "cp.async.bulk.tensor.5d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6, %7}], [%2];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3), "r"(c4)
      : "memory");
}

// wgmma shared-memory descriptor, no swizzle: start address, LBO (stride
// between the two 8-element K chunks) and SBO (stride between 8-row groups)
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) | (static_cast<uint64_t>(sbo >> 4) << 32);
}

__device__ __forceinline__ void acc_fence(float (&d)[48]) {
#pragma unroll
  for (int i = 0; i < 48; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// D (64 x 96, f32) += A (64 x 16, bf16, smem) * B (16 x 96, bf16, smem),
// both K-major.  The 48 accumulators are one contiguous register range.
__device__ __forceinline__ void wgmma_m64n96k16(float (&d)[48], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %50, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47}, "
      "%48, %49, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]),
        "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]),
        "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
      : "l"(da), "l"(db), "r"(1));
}

// One contiguous run of output planes [za, zb) of one column, and the input
// planes [plo, phi] it reads.
struct Segment {
  int b, x0, y0, za, zb, plo, phi;
};

__device__ __forceinline__ Segment segment_at(const Params& p, long long L, long long end) {
  const long long col = L / p.Z;
  Segment s;
  s.za = static_cast<int>(L - col * p.Z);
  const long long left = end - L;
  s.zb = left < p.Z - s.za ? s.za + static_cast<int>(left) : p.Z;
  const int ix = static_cast<int>(col % p.nx);
  const long long t = col / p.nx;
  const int iy = static_cast<int>(t % p.ny);
  s.b = static_cast<int>(t / p.ny);
  s.x0 = ix * (p.wp - 2);
  s.y0 = iy * p.ty;
  s.plo = s.za > 0 ? s.za - 1 : 0;
  s.phi = s.zb < p.Z ? s.zb : p.Z - 1;
  return s;
}

// The consumer warpgroup's side of the kernel: its accumulators and the
// constants of its rows.
template <int NBW>
struct Consumer {
  const Params p;
  uint64_t* full;
  uint64_t* empty;
  uint64_t* wbar;
  uint32_t wbase, sbase, stage_bytes, plane_bytes;
  int lane;
  // the rows this thread holds: block j, half h -> tile row
  // (wg * NBW + j) * 64 + warp * 16 + lane / 4 + 8 h
  int rty[NBW][2], rtx[NBW][2];
  bool rok[NBW][2];
  float bv[4][2];  // bias of this thread's 8 channels 8 g + 2 (lane % 4) + e
  // running sums of three output planes, per block: columns 0-31 output
  // p + 1, 32-63 output p, 64-95 output p - 1 while input plane p is in use
  float acc[NBW][48];

  // The zeroing and the shift are volatile asm moves: plain assignments let
  // the compiler sink the loop-carried copies in between the next plane's
  // wgmmas, where ptxas then has to serialize them.
  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int j = 0; j < NBW; ++j)
#pragma unroll
      for (int i = 0; i < 48; ++i) asm volatile("mov.b32 %0, 0;" : "=f"(acc[j][i]));
  }

  // Input plane p of the segment (ring plane c): wait for it, add its
  // products into the sums of outputs p + 1, p and p - 1 (the weights' dz
  // 0, 1, 2 columns), release it, finish output p - 1 if it belongs to the
  // segment, and shift the sums down by one plane for input plane p + 1.
  __device__ __forceinline__ void plane(const Segment& sg, int pz, uint32_t c) {
    mbar_wait(&full[c % p.stages], (c / p.stages) & 1);
    const uint32_t a_stage = sbase + (c % p.stages) * stage_bytes;
#pragma unroll
    for (int j = 0; j < NBW; ++j) acc_fence(acc[j]);
#pragma unroll
    for (int dy = 0; dy < 3; ++dy) {
      mbar_wait(&wbar[dy], 0);  // at once after the first planes
      asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
#pragma unroll
      for (int dx = 0; dx < 3; ++dx) {
        const uint32_t a_tap = a_stage + (dy * p.wp + dx) * 16;
        const uint32_t w_tap = wbase + (dy * 3 + dx) * kTapBytes;
#pragma unroll
        for (int ks = 0; ks < 2; ++ks) {
          const uint64_t db = smem_desc(w_tap + 2 * ks * kChunkBytes, kChunkBytes, 128);
#pragma unroll
          for (int j = 0; j < NBW; ++j)
            wgmma_m64n96k16(acc[j],
                            smem_desc(a_tap + ks * 2 * plane_bytes + j * 1024, plane_bytes, 128),
                            db);
        }
      }
      asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
    }
    asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
#pragma unroll
    for (int j = 0; j < NBW; ++j) acc_fence(acc[j]);
    mbar_arrive(&empty[c % p.stages]);
    if (pz - 1 >= sg.za && pz - 1 < sg.zb) store(sg, pz - 1);
#pragma unroll
    for (int j = 0; j < NBW; ++j)
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        asm volatile("mov.b32 %0, %1;" : "=f"(acc[j][32 + i]) : "f"(acc[j][16 + i]));
        asm volatile("mov.b32 %0, %1;" : "=f"(acc[j][16 + i]) : "f"(acc[j][i]));
        asm volatile("mov.b32 %0, 0;" : "=f"(acc[j][i]));
      }
  }

  // epilogue of output plane z, the sums in columns 64-95: bias in float32,
  // one rounding, valid rows stored
  __device__ __forceinline__ void store(const Segment& sg, int z) {
    __nv_bfloat162 res[NBW][2][4];
#pragma unroll
    for (int j = 0; j < NBW; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int g = 0; g < 4; ++g)
          res[j][h][g] = __floats2bfloat162_rn(acc[j][32 + g * 4 + h * 2] + bv[g][0],
                                               acc[j][32 + g * 4 + h * 2 + 1] + bv[g][1]);
    const long long plane = (static_cast<long long>(sg.b) * p.Z + z) * p.Y;
#pragma unroll
    for (int j = 0; j < NBW; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int y = sg.y0 + rty[j][h], x = sg.x0 + rtx[j][h];
        if (!rok[j][h] || y >= p.Y || x >= p.X) continue;
        __nv_bfloat16* o = p.out + ((plane + y) * p.X + x) * kC + (lane % 4) * 2;
#pragma unroll
        for (int g = 0; g < 4; ++g) *reinterpret_cast<__nv_bfloat162*>(o + g * 8) = res[j][h][g];
      }
  }
};

// NBW: 64-row blocks per consumer warpgroup (1 or 2)
template <int NBW>
__global__ void __launch_bounds__(kThreads, 1)
    conv3d_k3_kernel(const __grid_constant__ CUtensorMap xmap,
                     const __nv_bfloat16* __restrict__ w, const Params p) {
  extern __shared__ __align__(1024) uint8_t smem[];
  const uint32_t plane_bytes = p.positions * 16;  // one c8 plane of a stage
  const uint32_t stage_bytes = 4 * plane_bytes;
  uint8_t* wsm = smem;
  uint8_t* stages = smem + kWBytes;
  uint64_t* full = reinterpret_cast<uint64_t*>(stages + p.stages * stage_bytes);
  uint64_t* empty = full + p.stages;
  uint64_t* wbar = empty + p.stages;  // one per dy: the weights of taps (dy, 0..2)
  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < p.stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumers * 128);
    }
    for (int dy = 0; dy < 3; ++dy) mbar_init(&wbar[dy], 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  const long long start = p.tiles * blockIdx.x / gridDim.x;
  const long long end = p.tiles * (blockIdx.x + 1) / gridDim.x;

  if (tid >= kConsumers * 128) {
    // ---- producer: one thread issues every copy ----
    if (tid != kConsumers * 128) return;
    auto load_weights = [&](int dy) {
      mbar_expect_tx(&wbar[dy], 3 * kTapBytes);
      for (int t = 3 * dy; t < 3 * dy + 3; ++t)
        bulk_load(wsm + t * kTapBytes, w + t * (kTapBytes / 2), kTapBytes, &wbar[dy]);
    };
    load_weights(0);
    const uint32_t box_bytes = 4u * 16u * p.wp * (p.ty + 2);
    uint32_t cnt = 0;
    for (long long L = start; L < end;) {
      const Segment sg = segment_at(p, L, end);
      for (int pz = sg.plo; pz <= sg.phi; ++pz, ++cnt) {
        const uint32_t s = cnt % p.stages;
        mbar_wait(&empty[s], ((cnt / p.stages) & 1) ^ 1);
        mbar_expect_tx(&full[s], box_bytes);
        uint8_t* dst = stages + s * stage_bytes;
#pragma unroll
        for (int c8 = 0; c8 < 4; ++c8)
          tma_load_5d(dst + c8 * plane_bytes, &xmap, &full[s], c8 * 8, sg.x0 - 1, sg.y0 - 1, pz,
                      sg.b);
        if (cnt < 2) load_weights(cnt + 1);  // dy 1 after the first plane, dy 2 after the second
      }
      L += sg.zb - sg.za;
    }
    for (; cnt < 2; ++cnt) load_weights(cnt + 1);  // a range of fewer than two input planes
    return;
  }

  // ---- consumers: two warpgroups ----
  const int wg = tid / 128;
  Consumer<NBW> cs{p, full, empty, wbar, smem_u32(wsm),
                   smem_u32(stages) + static_cast<uint32_t>(wg * NBW) * 64u * 16u, stage_bytes,
                   plane_bytes, tid % 32};
#pragma unroll
  for (int j = 0; j < NBW; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = (wg * NBW + j) * 64 + ((tid % 128) / 32) * 16 + cs.lane / 4 + 8 * h;
      cs.rty[j][h] = m / p.wp;
      cs.rtx[j][h] = m - cs.rty[j][h] * p.wp;
      cs.rok[j][h] = cs.rty[j][h] < p.ty && cs.rtx[j][h] < p.wp - 2;
    }
#pragma unroll
  for (int g = 0; g < 4; ++g)
#pragma unroll
    for (int e = 0; e < 2; ++e)
      cs.bv[g][e] = p.bias != nullptr ? p.bias[g * 8 + (cs.lane % 4) * 2 + e] : 0.0f;

  uint32_t cnt = 0;  // input planes of earlier segments
  for (long long L = start; L < end;) {
    const Segment sg = segment_at(p, L, end);
    cs.zero();
    for (int pz = sg.plo; pz <= sg.phi; ++pz) cs.plane(sg, pz, cnt + (pz - sg.plo));
    // a range that reaches the last plane of the volume: output Z - 1 has
    // no plane after it, its sum is complete after plane Z - 1
    if (sg.zb == p.Z) cs.store(sg, p.Z - 1);
    cnt += sg.phi - sg.plo + 1;
    L += sg.zb - sg.za;
  }
}

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled is a driver-API symbol: fetched through the runtime,
// so the library needs no -lcuda
EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaError_t rc = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &ptr, 12000,
                                                      cudaEnableDefault, &q);
#else
    cudaError_t rc = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &q);
#endif
    if (rc == cudaSuccess && q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(ptr);
  }
  return fn;
}

}  // namespace

// x, out: (B, Z, Y, X, 32) bf16, 16-byte aligned; w: (9, 4, 3, 32, 8) bf16
// [dy * 3 + dx][ci / 8][dz][co][ci % 8], 16-byte aligned; bias: 32 float32
// or null.  wp, ty, nbw, positions, stages, grid: the launch plan.  Returns
// cudaGetLastError(), or 100000 + the driver's code if the tensor map
// cannot be encoded.
extern "C" int rtpose_conv3d_k3(const void* x, const void* w, const void* bias, void* out, int B,
                                int Z, int Y, int X, int wp, int ty, int nbw, int positions,
                                int stages, int grid, void* stream) {
  EncodeTiledFn enc = encode_tiled();
  if (enc == nullptr) return 100000 + CUDA_ERROR_NOT_FOUND;
  CUtensorMap map;
  const cuuint64_t dims[5] = {static_cast<cuuint64_t>(kC), static_cast<cuuint64_t>(X),
                              static_cast<cuuint64_t>(Y), static_cast<cuuint64_t>(Z),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t row = 2ull * kC;
  const cuuint64_t strides[4] = {row, row * X, row * X * Y, row * X * Y * Z};
  const cuuint32_t box[5] = {8, static_cast<cuuint32_t>(wp), static_cast<cuuint32_t>(ty + 2), 1,
                             1};
  const cuuint32_t estride[5] = {1, 1, 1, 1, 1};
  const CUresult cr = enc(&map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 5, const_cast<void*>(x), dims,
                          strides, box, estride, CU_TENSOR_MAP_INTERLEAVE_NONE,
                          CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                          CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (cr != CUDA_SUCCESS) return 100000 + static_cast<int>(cr);
  // the shared-memory limit is a per-device attribute: set once per device
  static uint64_t attr_set = 0;
  int device = 0;
  cudaGetDevice(&device);
  if (device < 64 && !((attr_set >> device) & 1)) {
    cudaFuncSetAttribute(conv3d_k3_kernel<1>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         kMaxSmem);
    cudaFuncSetAttribute(conv3d_k3_kernel<2>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         kMaxSmem);
    attr_set |= 1ull << device;
  }
  Params p;
  p.bias = static_cast<const float*>(bias);
  p.out = static_cast<__nv_bfloat16*>(out);
  p.Z = Z;
  p.Y = Y;
  p.X = X;
  p.wp = wp;
  p.ty = ty;
  p.positions = positions;
  p.stages = stages;
  p.nx = (X + wp - 3) / (wp - 2);
  p.ny = (Y + ty - 1) / ty;
  p.tiles = static_cast<long long>(B) * p.ny * p.nx * Z;
  const size_t smem_bytes =
      kWBytes + static_cast<size_t>(stages) * 64 * positions + 8 * (2 * stages + 3);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const __nv_bfloat16* wp_ = static_cast<const __nv_bfloat16*>(w);
  if (nbw == 2)
    conv3d_k3_kernel<2><<<grid, kThreads, smem_bytes, st>>>(map, wp_, p);
  else
    conv3d_k3_kernel<1><<<grid, kThreads, smem_bytes, st>>>(map, wp_, p);
  return static_cast<int>(cudaGetLastError());
}
