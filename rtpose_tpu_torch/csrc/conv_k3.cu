// Stride-1 3x3x3 convolution, 32 -> 32 channels, on channels-last bf16
// volumes: (B, Z, Y, X, 32) -> (B, Z, Y, X, 32), float32 accumulation,
// optional float32 bias added before the one rounding to bf16.
//
// Replaces the TPU kernel of rtpose_tpu/ops/pallas_conv.py: _pallas_forward
// (_kernel at :105-145, pallas_call at :176), reached through _fused and
// conv3d_folded_gather_fast.  The TPU kernel ran on the 4-wide X-folded
// layout that feeds a 128-lane MXU; this one reads the unfolded NDHWC
// tensor directly, so no layout change surrounds it.
//
// Bound on the H100: operations.  Per output voxel the conv does
// 27 * 32 * 32 multiply-adds (55,296 FLOP) over 64 bytes read and 64 bytes
// written, about 430 FLOP per byte, above the card's ~295 bf16 FLOP/byte
// ridge.  At the flagship full-resolution shape (1, 16, 64, 160), 163,840
// voxels, that is 9.06 GFLOP, about 9.2 us at 989 TFLOP/s.
//
// Design (a simple implicit GEMM, M = output voxels, N = 32, K = 27 * 32):
//   * one block of 4 warps owns an 8 (y) x 16 (x) output tile of one
//     (b, z) plane;
//   * the block stages the tile's input halo, 3 (z) x 10 (y) x 18 (x)
//     positions x 32 channels of bf16 (34.5 KB), in shared memory once, with
//     16-byte loads; positions outside the volume are written as zeros, so
//     the conv's zero padding is a mask on the load, not a padded copy;
//   * each warp owns two output rows of 16 voxels and all 32 output
//     channels: four 16x16 float32 WMMA accumulators.  For each of the 27
//     taps and both 16-channel halves of K it loads one A fragment per row
//     straight out of the halo (the shifted rows of a tap are a strided view
//     of it) and two B fragments of the (27, 32, 32) [tap][ci][co] weights,
//     and issues tensor-core mma.sync;
//   * the accumulators go through shared memory (reusing the halo) so the
//     epilogue adds the bias in float32, rounds once and writes each output
//     row's 16 x 32 channels as one contiguous 1 KB run.
// wgmma, TMA and a deeper pipeline are left for later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace {

using namespace nvcuda;

constexpr int kC = 32;        // input = output channels
constexpr int kTileX = 16;    // output x per tile = one WMMA M stripe
constexpr int kTileY = 8;     // output y rows per tile
constexpr int kWarps = 4;     // kTileY / kWarps rows per warp
constexpr int kRowsPerWarp = kTileY / kWarps;
constexpr int kHaloX = kTileX + 2;
constexpr int kHaloY = kTileY + 2;
constexpr int kHaloElems = 3 * kHaloY * kHaloX * kC;
static_assert(kTileY * kTileX * kC * sizeof(float) <=
                  kHaloElems * sizeof(__nv_bfloat16),
              "the float32 staging tile must fit in the halo buffer");

__global__ void __launch_bounds__(kWarps * 32) conv3d_k3_kernel(
    const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ w,
    const float* __restrict__ bias, __nv_bfloat16* __restrict__ out, int Z,
    int Y, int X) {
  __shared__ __align__(128) __nv_bfloat16 halo[kHaloElems];
  const int x0 = blockIdx.x * kTileX;
  const int y0 = blockIdx.y * kTileY;
  const int b = blockIdx.z / Z;
  const int z = blockIdx.z - b * Z;
  const int tid = threadIdx.x;
  const int warp = tid / 32;

  // 1. halo: (dz, hy, hx) positions, four 16-byte vectors of 8 channels each
  constexpr int kVecs = 3 * kHaloY * kHaloX * (kC / 8);
  for (int v = tid; v < kVecs; v += kWarps * 32) {
    const int c8 = v & 3;
    const int p = v >> 2;
    const int hx = p % kHaloX;
    const int q = p / kHaloX;
    const int hy = q % kHaloY;
    const int dz = q / kHaloY;
    const int zz = z + dz - 1;
    const int yy = y0 + hy - 1;
    const int xx = x0 + hx - 1;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (zz >= 0 && zz < Z && yy >= 0 && yy < Y && xx >= 0 && xx < X) {
      val = *reinterpret_cast<const uint4*>(
          x + ((((int64_t)b * Z + zz) * Y + yy) * X + xx) * kC + c8 * 8);
    }
    *reinterpret_cast<uint4*>(halo + p * kC + c8 * 8) = val;
  }
  __syncthreads();

  // 2. implicit GEMM over 27 taps x 2 channel halves
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[kRowsPerWarp][2];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    wmma::fill_fragment(acc[r][0], 0.0f);
    wmma::fill_fragment(acc[r][1], 0.0f);
  }
  for (int tap = 0; tap < 27; ++tap) {
    const int dz = tap / 9;
    const int dy = (tap / 3) % 3;
    const int dx = tap % 3;
#pragma unroll
    for (int kc = 0; kc < 2; ++kc) {
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> bf[2];
      const __nv_bfloat16* wk = w + (tap * kC + kc * 16) * kC;
      wmma::load_matrix_sync(bf[0], wk, kC);
      wmma::load_matrix_sync(bf[1], wk + 16, kC);
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        const int ty = warp * kRowsPerWarp + r;
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> af;
        wmma::load_matrix_sync(
            af, halo + ((dz * kHaloY + ty + dy) * kHaloX + dx) * kC + kc * 16, kC);
        wmma::mma_sync(acc[r][0], af, bf[0], acc[r][0]);
        wmma::mma_sync(acc[r][1], af, bf[1], acc[r][1]);
      }
    }
  }
  __syncthreads();  // every warp is done reading the halo

  // 3. epilogue: stage float32, add bias, round once, store 2 channels a thread
  float* stage = reinterpret_cast<float*>(halo);
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    float* row = stage + (warp * kRowsPerWarp + r) * kTileX * kC;
    wmma::store_matrix_sync(row, acc[r][0], kC, wmma::mem_row_major);
    wmma::store_matrix_sync(row + 16, acc[r][1], kC, wmma::mem_row_major);
  }
  __syncthreads();
  for (int e = tid; e < kTileY * kTileX * kC / 2; e += kWarps * 32) {
    const int idx = e * 2;
    const int c = idx % kC;
    const int p = idx / kC;
    const int yy = y0 + p / kTileX;
    const int xx = x0 + p % kTileX;
    if (yy < Y && xx < X) {
      float v0 = stage[idx];
      float v1 = stage[idx + 1];
      if (bias != nullptr) {
        v0 += bias[c];
        v1 += bias[c + 1];
      }
      *reinterpret_cast<__nv_bfloat162*>(
          out + ((((int64_t)b * Z + z) * Y + yy) * X + xx) * kC + c) =
          __floats2bfloat162_rn(v0, v1);
    }
  }
}

}  // namespace

// x, out: (B, Z, Y, X, 32) bf16, 16-byte aligned; w: (27, 32, 32) bf16
// [tap][ci][co]; bias: 32 float32 or null.  Returns cudaGetLastError().
extern "C" int rtpose_conv3d_k3(const void* x, const void* w, const void* bias,
                                void* out, int B, int Z, int Y, int X,
                                void* stream) {
  const dim3 grid((X + kTileX - 1) / kTileX, (Y + kTileY - 1) / kTileY, B * Z);
  conv3d_k3_kernel<<<grid, kWarps * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(w),
      static_cast<const float*>(bias), static_cast<__nv_bfloat16*>(out), Z, Y, X);
  return static_cast<int>(cudaGetLastError());
}
