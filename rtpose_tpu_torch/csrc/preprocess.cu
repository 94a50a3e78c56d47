// Radar-cube preprocess: ROI crop + (x - n0) * inv_scale + clamp >= 0 +
// channels-last transpose, (B, D, Z, Y, X) -> (B, Z', Y', X', D) float32.
//
// Replaces the TPU kernels of rtpose_tpu/ops/preprocess.py:
//   K1 fused_preprocess_batch (_make_batch_kernel, pallas_call at :173)
//   K2 fused_preprocess       (_make_kernel,       pallas_call at :95),
//      which is this kernel launched with B = 1.
//
// Bound on the H100: bytes.  The function reads each cropped input element
// once (2 bytes for the f16 on-disk dtype) and writes 4 bytes per output
// element; it does one subtract, one multiply and one compare per element.
// At the flagship shape (32, 16, 64, 160) that is 10.5 MB in and 21 MB out
// per frame, about 9.4 us at 3.35 TB/s.
//
// Design for that bound: one block owns a (32 x-positions) x (32 channels)
// tile of one (b, z', y') output row.  Warps read the input coalesced along
// X (each channel is a separate plane of the raw cube), the tile is
// transposed through shared memory (padded rows, no bank conflicts), and the
// block writes the output tile, which is one contiguous run of 32 * D floats
// when D == 32.  f16 and bf16 are read natively (the TPU kernel handed f16 to
// XLA), and any ROI height works (the TPU kernel's yo % 2 restriction was a
// VMEM budget).  The math is float32 (x - n0) * inv_scale, then max(., 0),
// exactly what the plain version in ops/preprocess.py computes.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTileX = 32;  // x positions per tile (one warp's read)
constexpr int kTileD = 32;  // channels per tile
constexpr int kRows = 8;    // warps per block

template <typename T>
__device__ __forceinline__ float to_f32(T v);
template <>
__device__ __forceinline__ float to_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ float to_f32<__half>(__half v) { return __half2float(v); }
template <>
__device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__global__ void __launch_bounds__(kTileX * kRows) preprocess_kernel(
    const T* __restrict__ in, float* __restrict__ out, int D, int Z, int Y,
    int X, int z0, int y0, int x0, int Zo, int Yo, int Xo, float n0,
    float inv_scale) {
  __shared__ float tile[kTileD][kTileX + 1];
  const int xt = blockIdx.x * kTileX;
  const int yo = blockIdx.y;
  const int b = blockIdx.z / Zo;
  const int zo = blockIdx.z - b * Zo;
  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  const int tid = ty * kTileX + tx;
  const int nx = min(kTileX, Xo - xt);

  const int64_t plane = (int64_t)Z * Y * X;
  const T* src = in + (int64_t)b * D * plane +
                 ((int64_t)(z0 + zo) * Y + (y0 + yo)) * X + x0 + xt;
  float* dst = out + ((((int64_t)b * Zo + zo) * Yo + yo) * Xo + xt) * D;

  for (int d0 = 0; d0 < D; d0 += kTileD) {
    const int nd = min(kTileD, D - d0);
    if (d0 > 0) __syncthreads();  // previous tile fully written out
    if (tx < nx) {
      for (int d = ty; d < nd; d += kRows) {
        const float v = (to_f32(src[(int64_t)(d0 + d) * plane + tx]) - n0) * inv_scale;
        tile[d][tx] = v < 0.0f ? 0.0f : v;  // NaN propagates, as in the plain version
      }
    }
    __syncthreads();
    for (int e = tid; e < nx * nd; e += kTileX * kRows) {
      const int x = e / nd;
      const int d = e - x * nd;
      dst[(int64_t)x * D + d0 + d] = tile[d][x];
    }
  }
}

}  // namespace

// dtype: 0 = float32, 1 = float16, 2 = bfloat16.  Returns cudaGetLastError().
extern "C" int rtpose_preprocess(const void* in, void* out, int dtype, int B,
                                 int D, int Z, int Y, int X, int z0, int y0,
                                 int x0, int Zo, int Yo, int Xo, float n0,
                                 float inv_scale, void* stream) {
  const dim3 grid((Xo + kTileX - 1) / kTileX, Yo, B * Zo);
  const dim3 block(kTileX, kRows);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* o = static_cast<float*>(out);
  switch (dtype) {
    case 0:
      preprocess_kernel<float><<<grid, block, 0, s>>>(
          static_cast<const float*>(in), o, D, Z, Y, X, z0, y0, x0, Zo, Yo, Xo,
          n0, inv_scale);
      break;
    case 1:
      preprocess_kernel<__half><<<grid, block, 0, s>>>(
          static_cast<const __half*>(in), o, D, Z, Y, X, z0, y0, x0, Zo, Yo,
          Xo, n0, inv_scale);
      break;
    case 2:
      preprocess_kernel<__nv_bfloat16><<<grid, block, 0, s>>>(
          static_cast<const __nv_bfloat16*>(in), o, D, Z, Y, X, z0, y0, x0, Zo,
          Yo, Xo, n0, inv_scale);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
