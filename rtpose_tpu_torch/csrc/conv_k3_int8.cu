// Int8 stride-1 3x3x3 conv, 32 -> 32 channels, channels-last, for sm_90a.
//
// Not a port of a TPU kernel: the JAX package runs its int8 convs on XLA
// (rtpose_tpu/ops/quant.py::conv3d_int8), and PyTorch has no int8 conv3d on
// CUDA.  This is the port's own kernel for the K3 shape of the int8 serving
// path (rtpose_tpu_torch/ops/conv_k3_int8.py is its wrapper and holds the
// plain version).
//
//   out[b, z, y, x, co] = rnd(fadd(fmul(float(acc), scale[co]), bias[co]))
//   acc = sum over (dz, dy, dx, ci) of x[b, z+dz-1, y+dy-1, x+dx-1, ci] * w[co, ci, dz, dy, dx]
//
// with zero padding, acc an exact int32 (|acc| <= 864 * 128 * 127 < 2^24, so
// float(acc) is exact too), the multiply and add as separate IEEE operations
// (__fmul_rn, __fadd_rn: nvcc may not contract them into an FMA) and one
// round-to-nearest-even to bf16 (or none for float32).  That is the plain
// version's arithmetic operation for operation, and integer sums do not
// depend on their order: the two agree bit for bit.
//
// What bounds it on an H100: both, about equally.  2 * 27 * 32 * 32 int8
// operations per voxel, at (1, 16, 64, 160) 9.06 G operations (4.6 us at
// 1979 TOPS), against 32 bytes read and 64 (bf16) written per voxel, 15.7
// MB (4.7 us at 3.35 TB/s).  So the tensor cores must not wait on loads or
// on the epilogue, and the stores must be whole lines.  The design is the
// one of conv_k3.cu (the bf16 K3 kernel), in int8:
//   * persistent grid of about one block per SM; the work is the list of
//     tile-planes (b, y tile, x tile, z) with z fastest, and each block
//     takes one contiguous range of it, walking each column's input planes
//     in z order: every input plane of a column is loaded once;
//   * one producer warp streams input planes through a ring of S stages
//     with TMA (uint8 tensor map, completion on mbarriers).  A stage holds
//     the tile's halo, (Ty + 2) rows of Wp = Tx + 2 positions, stored
//     channel-chunk planar: [c16 in 0..1][y * Wp + x][16 channels], two
//     box loads of a 16-byte inner extent.  The tensor map's out-of-bounds
//     zero fill is the conv's zero padding (a zero byte is int8 0);
//   * output rows M are the same flattened padded (y, x) positions
//     m = ty * Wp + tx, so for tap (dy, dx) the A operand is the stage at
//     position offset dy * Wp + dx: every 8-row core matrix is 128
//     contiguous bytes (M stride 128 B, K stride one c16 plane), a plain
//     unswizzled wgmma descriptor.  The two pad columns of each row are
//     computed and dropped;
//   * dz is folded into N: input plane p is the A operand once, against the
//     three dz slices of the weights side by side (wgmma.mma_async
//     m64n96k32, s8 x s8 -> s32 accumulators in registers, 9 taps x one
//     K-step of all 32 channels).  Integer wgmma has no transpose flags:
//     both operands are K-major.  The three 32-column groups hold the
//     running sums of three output planes.  Rather than shifting the sums
//     down a plane after each input plane (96 register moves), the weights
//     rotate: the 27,648 B of weights ([dy * 3 + dx][ci / 16][dz][n][ci %
//     16]) are loaded once per block by bulk copies into shared memory with
//     each (tap, c16) chunk holding the dz slices 0, 1, 2, 0, 1 (46,080 B),
//     so that the B operand of rotation R, slices R, R + 1, R + 2, is the
//     same descriptor 512 * R bytes on.  After plane p, output p - 1 is
//     complete in one group; it is stored and the group zeroed to collect
//     output p + 2;
//   * two consumer warpgroups each own one or two 64-row blocks of the
//     tile and take turns (two mbarriers): one issues its products of a
//     plane while the other stores its finished output, so the epilogue
//     (int-to-float conversions at a quarter of the ALU rate, the most of
//     its time) runs under the other's tensor-core work.  A warpgroup hands
//     the turn on as soon as its last products are issued;
//   * the epilogue scales in float32 and rounds once.  The weights' N order
//     within a dz slice is permuted (row n holds output channel 8 (n / 2 %
//     4) + 2 (n / 8) + n % 2) so that the accumulator columns a thread holds
//     are 8 contiguous channels of its rows: each thread stores 16 bytes
//     (bf16) or 32 (float32) of a row, a warp 8 rows consecutive in x, as
//     whole lines, with no shuffles and no shared memory.  Only the valid
//     (y, x) rows of the range's own output planes are stored.  No split-K
//     and no atomics: deterministic.
// The tile shape (Tx, Ty, blocks per warpgroup, stages) comes from the
// wrapper's launch plan (rtpose_tpu_torch/ops/conv_k3_int8.py::plan).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kC = 32;
constexpr int kN = 3 * kC;                   // dz x co: the wgmma's N
constexpr int kChunkBytes = kN * 16;         // 1,536: one (tap, ci/16) chunk of the weights
// in shared memory each chunk holds the dz slices 0, 1, 2, 0, 1 (32 rows of
// 16 bytes each), so that N rows r * 32 .. r * 32 + 95 are the dz slices
// r, r + 1, r + 2 (mod 3): the rotation the running sums need
constexpr int kSlice = kC * 16;              // 512: one dz slice of a chunk
constexpr int kWChunk = 5 * kSlice;          // 2,560
constexpr int kWTap = 2 * kWChunk;           // 5,120: one (dy, dx) tap
constexpr int kWSmem = 9 * kWTap;            // 46,080
constexpr int kConsumers = 2;                // consumer warpgroups
constexpr int kThreads = kConsumers * 128 + 32;  // + one producer warp
constexpr int kMaxSmem = 232448;             // 227 KB, the H100's block limit

struct Params {
  const float* scale;
  const float* bias;
  void* out;
  long long tiles;  // tile-planes: B * ny * nx * Z
  int Z, Y, X;
  int wp, ty;       // padded row width (Tx + 2), output rows per tile
  int positions;    // positions per c16 plane of a stage (multiple of 8)
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
// between the two 16-byte K chunks) and SBO (stride between 8-row groups)
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) | (static_cast<uint64_t>(sbo >> 4) << 32);
}

__device__ __forceinline__ void acc_fence(int (&d)[48]) {
#pragma unroll
  for (int i = 0; i < 48; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// D (64 x 96, s32) += A (64 x 32, s8, smem) * B (32 x 96, s8, smem), both
// K-major.  The 48 accumulators are one contiguous register range.
__device__ __forceinline__ void wgmma_m64n96k32(int (&d)[48], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %50, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47}, "
      "%48, %49, p;\n"
      "}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]),
        "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]),
        "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]),
        "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
        "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]),
        "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]),
        "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]), "+r"(d[42]),
        "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47])
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

// 16 bytes to global memory if `pred`: predicated, so the epilogue has no
// branch around its stores
__device__ __forceinline__ void st_v4_if(void* ptr, uint32_t a, uint32_t b, uint32_t c,
                                         uint32_t d, bool pred) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %5, 0;\n"
      "@p st.global.v4.b32 [%0], {%1, %2, %3, %4};\n"
      "}\n" ::"l"(ptr),
      "r"(a), "r"(b), "r"(c), "r"(d), "r"(static_cast<int>(pred))
      : "memory");
}

// The consumer warpgroup's side of the kernel: its accumulators and the
// constants of its rows.
template <int NBW, bool F32OUT>
struct Consumer {
  const Params p;
  uint64_t* full;
  uint64_t* empty;
  uint64_t* turn;  // turn[k]: warpgroup k may issue its products
  uint64_t* wbar;
  uint32_t wbase, sbase, stage_bytes, plane_bytes;
  int wg, lane;
  uint32_t stage, phase, turns;  // the ring's next stage and its parity; turns taken
  // the rows this thread holds: block j, half h -> tile row
  // (wg * NBW + j) * 64 + warp * 16 + lane / 4 + 8 h
  int rty[NBW][2], rtx[NBW][2];
  bool rok[NBW][2];
  // scale and bias of this thread's channels 8 (lane % 4) + 2 g + e (the
  // weights' N order puts them in its accumulator columns 8 g + 2 (lane %
  // 4) + e); the bias is -0.0 without one (x + -0.0 == x for every x, so
  // the sum is exactly the plain version's product alone)
  float sc[4][2], bv[4][2];
  // running sums of three output planes, per block: 16 registers (32
  // columns) a group; input plane p adds its dz slice (R + k) % 3 into
  // group k, where R = 0, 1, 2, 0, ... is the plane's rotation within its
  // segment, so group k holds output p + 1 - (R + k) % 3
  int acc[NBW][48];
  // the segment's rows: element offset of row (j, h) within an output
  // plane (at channel 8 (lane % 4)), and whether it is an output voxel
  long long seg_off[NBW][2];
  bool seg_ok[NBW][2];

  __device__ __forceinline__ void begin(const Segment& sg) {
    // the zeroing is volatile asm moves: plain assignments let the compiler
    // sink them in between the next plane's wgmmas, where ptxas then has to
    // serialize them
#pragma unroll
    for (int j = 0; j < NBW; ++j)
#pragma unroll
      for (int i = 0; i < 48; ++i) asm volatile("mov.b32 %0, 0;" : "=r"(acc[j][i]));
#pragma unroll
    for (int j = 0; j < NBW; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int y = sg.y0 + rty[j][h], x = sg.x0 + rtx[j][h];
        seg_ok[j][h] = rok[j][h] && y < p.Y && x < p.X;
        seg_off[j][h] = (static_cast<long long>(y) * p.X + x) * kC + (lane % 4) * 8;
      }
  }

  // Input plane p, rotation R: wait for it and for this warpgroup's turn,
  // add its products into the running sums (the weights' dz slices R,
  // R + 1, R + 2 side by side as N), hand the turn to the other warpgroup
  // once the last products are issued, wait for them and release the
  // plane.  The turns alternate the two warpgroups' products, so that one's
  // epilogue runs while the tensor cores work through the other's.
  __device__ __forceinline__ void products(int R) {
    mbar_wait(&full[stage], phase);
    mbar_wait(&turn[wg], turns & 1);
    ++turns;
    const uint32_t a_stage = sbase + stage * stage_bytes;
    const uint32_t w_rot = wbase + R * kSlice;
#pragma unroll
    for (int j = 0; j < NBW; ++j) acc_fence(acc[j]);
#pragma unroll
    for (int dy = 0; dy < 3; ++dy) {
      mbar_wait(&wbar[dy], 0);  // at once after the first planes
      asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
#pragma unroll
      for (int dx = 0; dx < 3; ++dx) {
        const uint32_t a_tap = a_stage + (dy * p.wp + dx) * 16;
        const uint64_t db = smem_desc(w_rot + (dy * 3 + dx) * kWTap, kWChunk, 128);
#pragma unroll
        for (int j = 0; j < NBW; ++j)
          wgmma_m64n96k32(acc[j], smem_desc(a_tap + j * 1024, plane_bytes, 128), db);
      }
      asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
    }
    mbar_arrive(&turn[1 - wg]);
    asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
#pragma unroll
    for (int j = 0; j < NBW; ++j) acc_fence(acc[j]);
    mbar_arrive(&empty[stage]);
    if (++stage == static_cast<uint32_t>(p.stages)) {
      stage = 0;
      phase ^= 1;
    }
  }

  // A segment's input planes, then (when it reaches the volume's last
  // plane) one more step without products.  After step p, of rotation
  // R = (p - plo) % 3, output p - 1 is complete in group (2 - R) mod 3: it
  // is stored if it is the segment's, and its group zeroed to collect
  // output p + 2.  (After the extra step Z, that is output Z - 1.)
  __device__ __forceinline__ void segment(const Segment& sg) {
    begin(sg);
    const int last = sg.zb == p.Z ? p.Z : sg.phi;
    int R = 0;
    for (int pz = sg.plo; pz <= last; ++pz) {
      if (pz <= sg.phi) products(R);
      const bool out = pz - 1 >= sg.za && pz - 1 < sg.zb;
      if (R == 0)
        finish<2>(sg, pz - 1, out);
      else if (R == 1)
        finish<1>(sg, pz - 1, out);
      else
        finish<0>(sg, pz - 1, out);
      R = R == 2 ? 0 : R + 1;
    }
  }

  // epilogue of output plane z from accumulator group K (if `out`):
  // float(acc) * scale + bias in float32, one rounding, each thread's 8
  // contiguous channels of a valid row stored as 16 bytes (bf16) or 32
  // (float32); then the group is zeroed
  template <int K>
  __device__ __forceinline__ void finish(const Segment& sg, int z, bool out) {
    if (out) {
      const long long base = (static_cast<long long>(sg.b) * p.Z + z) * p.Y * p.X * kC;
#pragma unroll
      for (int j = 0; j < NBW; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          uint32_t u[8];  // channels 8 (lane % 4) + 2 g + e at u[2 g + e]
#pragma unroll
          for (int g = 0; g < 4; ++g)
#pragma unroll
            for (int e = 0; e < 2; ++e)
              u[2 * g + e] = __float_as_uint(__fadd_rn(
                  __fmul_rn(static_cast<float>(acc[j][16 * K + g * 4 + h * 2 + e]), sc[g][e]),
                  bv[g][e]));
          if (F32OUT) {
            float* dst = static_cast<float*>(p.out) + base + seg_off[j][h];
            st_v4_if(dst, u[0], u[1], u[2], u[3], seg_ok[j][h]);
            st_v4_if(dst + 4, u[4], u[5], u[6], u[7], seg_ok[j][h]);
          } else {
            uint32_t b[4];
#pragma unroll
            for (int g = 0; g < 4; ++g) {
              const __nv_bfloat162 b2 =
                  __floats2bfloat162_rn(__uint_as_float(u[2 * g]), __uint_as_float(u[2 * g + 1]));
              b[g] = *reinterpret_cast<const uint32_t*>(&b2);
            }
            st_v4_if(static_cast<__nv_bfloat16*>(p.out) + base + seg_off[j][h], b[0], b[1], b[2],
                     b[3], seg_ok[j][h]);
          }
        }
    }
#pragma unroll
    for (int j = 0; j < NBW; ++j)
#pragma unroll
      for (int i = 0; i < 16; ++i) asm volatile("mov.b32 %0, 0;" : "=r"(acc[j][16 * K + i]));
  }
};

// NBW: 64-row blocks per consumer warpgroup (1 or 2); F32OUT: float32
// output, else bf16
template <int NBW, bool F32OUT>
__global__ void __launch_bounds__(kThreads, 1)
    conv3d_k3_int8_kernel(const __grid_constant__ CUtensorMap xmap,
                          const int8_t* __restrict__ w, const Params p) {
  extern __shared__ __align__(1024) uint8_t smem[];
  const uint32_t plane_bytes = p.positions * 16;  // one c16 plane of a stage
  const uint32_t stage_bytes = 2 * plane_bytes;
  uint8_t* wsm = smem;
  uint8_t* stages = smem + kWSmem;
  uint64_t* full = reinterpret_cast<uint64_t*>(stages + p.stages * stage_bytes);
  uint64_t* empty = full + p.stages;
  uint64_t* wbar = empty + p.stages;  // one per dy: the weights of taps (dy, 0..2)
  uint64_t* turn = wbar + 3;          // one per consumer warpgroup
  const int tid = threadIdx.x;
  // the warp index through a shuffle, so that ptxas sees it is uniform in
  // the warp and the role branches below warp-uniform
  const int warp = __shfl_sync(0xffffffffu, tid / 32, 0);
  if (tid == 0) {
    for (int s = 0; s < p.stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumers * 128);
    }
    for (int dy = 0; dy < 3; ++dy) mbar_init(&wbar[dy], 1);
    for (int k = 0; k < kConsumers; ++k) mbar_init(&turn[k], 128);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  const long long start = p.tiles * blockIdx.x / gridDim.x;
  const long long end = p.tiles * (blockIdx.x + 1) / gridDim.x;

  if (warp >= kConsumers * 4) {
    // ---- producer: one thread issues every copy ----
    if (tid != kConsumers * 128) return;
    // the chunks (tap, c16) of taps (dy, 0..2), each as dz slices 0, 1, 2, 0, 1
    auto load_weights = [&](int dy) {
      mbar_expect_tx(&wbar[dy], 6 * (kChunkBytes + 2 * kSlice));
      for (int t = 6 * dy; t < 6 * dy + 6; ++t) {
        bulk_load(wsm + t * kWChunk, w + t * kChunkBytes, kChunkBytes, &wbar[dy]);
        bulk_load(wsm + t * kWChunk + 3 * kSlice, w + t * kChunkBytes, 2 * kSlice, &wbar[dy]);
      }
    };
    load_weights(0);
    const uint32_t box_bytes = 2u * 16u * p.wp * (p.ty + 2);
    uint32_t cnt = 0, s = 0, phase = 0;  // planes loaded; the ring's stage and its parity
    for (long long L = start; L < end;) {
      const Segment sg = segment_at(p, L, end);
      for (int pz = sg.plo; pz <= sg.phi; ++pz, ++cnt) {
        mbar_wait(&empty[s], phase ^ 1);
        mbar_expect_tx(&full[s], box_bytes);
        uint8_t* dst = stages + s * stage_bytes;
#pragma unroll
        for (int c16 = 0; c16 < 2; ++c16)
          tma_load_5d(dst + c16 * plane_bytes, &xmap, &full[s], c16 * 16, sg.x0 - 1, sg.y0 - 1,
                      pz, sg.b);
        if (cnt == 0) {  // the rest of the weights right behind the first plane
          load_weights(1);
          load_weights(2);
        }
        if (++s == static_cast<uint32_t>(p.stages)) {
          s = 0;
          phase ^= 1;
        }
      }
      L += sg.zb - sg.za;
    }
    if (cnt == 0) {  // a range without input planes
      load_weights(1);
      load_weights(2);
    }
    return;
  }

  // ---- consumers: two warpgroups ----
  const int wg = warp / 4;
  Consumer<NBW, F32OUT> cs{p, full, empty, turn, wbar, smem_u32(wsm),
                           smem_u32(stages) + static_cast<uint32_t>(wg * NBW) * 64u * 16u,
                           stage_bytes, plane_bytes, wg, tid % 32, 0, 0, 0};
#pragma unroll
  for (int j = 0; j < NBW; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = (wg * NBW + j) * 64 + (warp % 4) * 16 + cs.lane / 4 + 8 * h;
      cs.rty[j][h] = m / p.wp;
      cs.rtx[j][h] = m - cs.rty[j][h] * p.wp;
      cs.rok[j][h] = cs.rty[j][h] < p.ty && cs.rtx[j][h] < p.wp - 2;
    }
#pragma unroll
  for (int g = 0; g < 4; ++g)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int co = (cs.lane % 4) * 8 + g * 2 + e;
      cs.sc[g][e] = p.scale[co];
      cs.bv[g][e] = p.bias != nullptr ? p.bias[co] : -0.0f;
    }
  if (wg == 1) mbar_arrive(&turn[0]);  // warpgroup 0 takes the first turn

  for (long long L = start; L < end;) {
    const Segment sg = segment_at(p, L, end);
    cs.segment(sg);
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

template <int NBW, bool F32OUT>
void set_smem_limit() {
  cudaFuncSetAttribute(conv3d_k3_int8_kernel<NBW, F32OUT>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
}

}  // namespace

// x: (B, Z, Y, X, 32) int8, 16-byte aligned; w: (9, 2, 3, 32, 16) int8
// [dy * 3 + dx][ci / 16][dz][n][ci % 16] (row n in the N order above),
// 16-byte aligned; scale: 32 float32; bias: 32 float32 or null; out:
// (B, Z, Y, X, 32) float32 if out_f32 else bf16, 16-byte aligned.  wp, ty, nbw, positions, stages,
// grid: the launch plan.  Returns cudaGetLastError(), or 100000 + the
// driver's code if the tensor map cannot be encoded.
extern "C" int rtpose_conv3d_k3_int8(const void* x, const void* w, const void* scale,
                                     const void* bias, void* out, int out_f32, int B, int Z,
                                     int Y, int X, int wp, int ty, int nbw, int positions,
                                     int stages, int grid, void* stream) {
  EncodeTiledFn enc = encode_tiled();
  if (enc == nullptr) return 100000 + CUDA_ERROR_NOT_FOUND;
  CUtensorMap map;
  const cuuint64_t dims[5] = {static_cast<cuuint64_t>(kC), static_cast<cuuint64_t>(X),
                              static_cast<cuuint64_t>(Y), static_cast<cuuint64_t>(Z),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t row = kC;
  const cuuint64_t strides[4] = {row, row * X, row * X * Y, row * X * Y * Z};
  const cuuint32_t box[5] = {16, static_cast<cuuint32_t>(wp), static_cast<cuuint32_t>(ty + 2),
                             1, 1};
  const cuuint32_t estride[5] = {1, 1, 1, 1, 1};
  const CUresult cr = enc(&map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 5, const_cast<void*>(x), dims,
                          strides, box, estride, CU_TENSOR_MAP_INTERLEAVE_NONE,
                          CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                          CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (cr != CUDA_SUCCESS) return 100000 + static_cast<int>(cr);
  // the shared-memory limit is a per-device attribute: set once per device
  static uint64_t attr_set = 0;
  int device = 0;
  cudaGetDevice(&device);
  if (device < 64 && !((attr_set >> device) & 1)) {
    set_smem_limit<1, false>();
    set_smem_limit<2, false>();
    set_smem_limit<1, true>();
    set_smem_limit<2, true>();
    attr_set |= 1ull << device;
  }
  Params p;
  p.scale = static_cast<const float*>(scale);
  p.bias = static_cast<const float*>(bias);
  p.out = out;
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
      kWSmem + static_cast<size_t>(stages) * 32 * positions + 8 * (2 * stages + 5);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int8_t* wi = static_cast<const int8_t*>(w);
  if (nbw == 2 && out_f32)
    conv3d_k3_int8_kernel<2, true><<<grid, kThreads, smem_bytes, st>>>(map, wi, p);
  else if (nbw == 2)
    conv3d_k3_int8_kernel<2, false><<<grid, kThreads, smem_bytes, st>>>(map, wi, p);
  else if (out_f32)
    conv3d_k3_int8_kernel<1, true><<<grid, kThreads, smem_bytes, st>>>(map, wi, p);
  else
    conv3d_k3_int8_kernel<1, false><<<grid, kThreads, smem_bytes, st>>>(map, wi, p);
  return static_cast<int>(cudaGetLastError());
}
