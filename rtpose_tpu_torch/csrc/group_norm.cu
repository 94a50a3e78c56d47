// GroupNorm, forward, channels-last bf16: (B, S, C) -> (B, S, C), with S the
// positions of a batch item (Z * Y * X).  Each group's statistics are taken
// over its S x C / groups values in float32 (centred sums: a Welford mean and
// M2, merged with Chan's formula; never E[x^2] - E[x]^2), rstd = 1 /
// sqrt(M2 / n + eps), and every channel is applied as one fused multiply-add
// x * scale + shift with scale = w * rstd and shift = b - mean * scale,
// rounded once to bf16.
//
// Replaces no TPU kernel: rtpose_tpu/models/layers.py::GroupNorm8 is stock
// XLA ops (ops/fold_conv.py::group_norm_folded on the X-folded layout).  Added
// for the eval path, where the plain version beside this kernel
// (rtpose_tpu_torch/ops/group_norm.py::group_norm_reference: a cast to
// float32, two means, two broadcast subtractions, a square, rsqrt, a
// multiply, the affine and a cast back, each a pass over a float32 copy)
// took 19-22 ms of a ~44 ms B=8 batch of the flagship on an H100.
//
// Bound on the H100: bytes.  The statistics need one read of x, the output
// one more read and one write: 6 bytes an element.  The flagship trunk's 48
// calls a frame hold 91.0 M elements: 0.55 GB a frame, 4.37 GB a B=8 batch,
// 1.30 ms at 3.35 TB/s.
//
// Design, two kernels on one stream:
//   * statistics: block (b, chunk) reads a chunk of whole rows of batch item
//     b with 16-byte loads, 8 channels a load; a thread always reads the same
//     8 channels (the block's thread count is a multiple of C / 8 vectors) and
//     keeps a float32 Welford mean and M2 for each.  The block merges its
//     threads per channel in a fixed tree through shared memory, then the
//     channels of each group, and writes (count, mean, M2) per group to the
//     scratch the wrapper allocates.  The wrapper sizes the chunks so that
//     the grid fills the card at B = 1 as at B = 8;
//   * apply: each block merges its batch item's partials in one fixed order
//     (a warp a group: lane l the chunks l, l + 32, ..., then a shuffle
//     tree), forms each channel's scale and shift in shared memory, and writes
//     its chunk with 16-byte loads and stores.  It takes the chunks in the
//     reverse order of the statistics pass, so its first blocks read what
//     that pass left in L2.
// No atomics: every launch on the same input gives the same bits, so a CUDA
// graph replay equals the eager call.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;               // 16-byte loads a thread issues together
constexpr int kMaxC = 8 * kThreads;      // one vector of 8 channels a thread and row

struct Moments {
  float n, mean, m2;
};

// Chan's merge of b into a.
__device__ __forceinline__ void merge(Moments& a, const Moments& b) {
  if (b.n == 0.0f) return;
  const float n = a.n + b.n;
  const float r = b.n / n;
  const float d = b.mean - a.mean;
  a.mean = fmaf(d, r, a.mean);
  a.m2 = a.m2 + b.m2 + d * d * a.n * r;
  a.n = n;
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

__global__ void __launch_bounds__(kThreads) group_norm_stats_kernel(
    const uint4* __restrict__ x, float* __restrict__ part, int S, int C, int groups,
    int chunks, int rows) {
  __shared__ float s_mean[8][kThreads];
  __shared__ float s_m2[8][kThreads];
  __shared__ float s_n[kThreads];
  const int V = C >> 3;        // vectors a row
  const int R = kThreads / V;  // rows a sweep of the block
  const int t = threadIdx.x;
  const int b = blockIdx.x / chunks;
  const int chunk = blockIdx.x - b * chunks;
  const int slot = t % V;
  const int r = t / V;
  const long long row0 = static_cast<long long>(chunk) * rows;
  const long long row1 = min(static_cast<long long>(S), row0 + rows);

  float mean[8], m2[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) mean[j] = m2[j] = 0.0f;
  int n = 0;
  if (r < R) {
    const uint4* src = x + static_cast<long long>(b) * S * V + slot;
    for (long long row = row0 + r; row < row1; row += static_cast<long long>(kUnroll) * R) {
      uint4 v[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const long long rr = row + static_cast<long long>(u) * R;
        v[u] = rr < row1 ? __ldg(src + rr * V) : make_uint4(0u, 0u, 0u, 0u);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (row + static_cast<long long>(u) * R < row1) {
          float f[8];
          unpack(v[u], f);
          ++n;
          const float inv = 1.0f / static_cast<float>(n);
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const float d = f[j] - mean[j];
            mean[j] = fmaf(d, inv, mean[j]);
            m2[j] = fmaf(d, f[j] - mean[j], m2[j]);
          }
        }
      }
    }
  }
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    s_mean[j][t] = mean[j];
    s_m2[j][t] = m2[j];
  }
  s_n[t] = static_cast<float>(n);
  __syncthreads();

  // the R threads of a slot into its first: pairs (r, r + h), h halving
  int h = 1;
  while (h < R) h <<= 1;
  for (h >>= 1; h > 0; h >>= 1) {
    if (r < h && r + h < R) {
      const int o = t + h * V;
      const float na = s_n[t], nb = s_n[o];
      if (nb > 0.0f) {
        const float nn = na + nb, q = nb / nn;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float d = s_mean[j][o] - s_mean[j][t];
          s_mean[j][t] = fmaf(d, q, s_mean[j][t]);
          s_m2[j][t] = s_m2[j][t] + s_m2[j][o] + d * d * na * q;
        }
        s_n[t] = nn;
      }
    }
    __syncthreads();
  }

  // the channels of each group, in order
  const int G = C / groups;
  for (int g = t; g < groups; g += kThreads) {
    Moments a = {0.0f, 0.0f, 0.0f};
    for (int c = g * G; c < (g + 1) * G; ++c) {
      const int sl = c >> 3, j = c & 7;
      merge(a, Moments{s_n[sl], s_mean[j][sl], s_m2[j][sl]});
    }
    float* p = part + ((static_cast<long long>(b) * chunks + chunk) * groups + g) * 3;
    p[0] = a.n;
    p[1] = a.mean;
    p[2] = a.m2;
  }
}

__global__ void __launch_bounds__(kThreads) group_norm_apply_kernel(
    const uint4* __restrict__ x, uint4* __restrict__ out, const float* __restrict__ part,
    const float* __restrict__ w, const float* __restrict__ bias, int S, int C, int groups,
    int chunks, int rows, float eps) {
  extern __shared__ float smem[];
  float* s_scale = smem;
  float* s_shift = smem + C;
  float* s_mean = smem + 2 * C;
  float* s_rstd = s_mean + groups;
  const int V = C >> 3;
  const int R = kThreads / V;
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int blk = gridDim.x - 1 - blockIdx.x;
  const int b = blk / chunks;
  const int chunk = blk - b * chunks;

  const float* pb = part + static_cast<long long>(b) * chunks * groups * 3;
  for (int g = t >> 5; g < groups; g += kThreads / 32) {
    Moments a = {0.0f, 0.0f, 0.0f};
    for (int k = lane; k < chunks; k += 32) {
      const float* p = pb + (static_cast<long long>(k) * groups + g) * 3;
      merge(a, Moments{p[0], p[1], p[2]});
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      Moments m;
      m.n = __shfl_down_sync(0xffffffffu, a.n, o);
      m.mean = __shfl_down_sync(0xffffffffu, a.mean, o);
      m.m2 = __shfl_down_sync(0xffffffffu, a.m2, o);
      merge(a, m);   // lane 0's chain reads lanes 1-31 only
    }
    if (lane == 0) {
      s_mean[g] = a.mean;
      s_rstd[g] = 1.0f / sqrtf(a.m2 / a.n + eps);
    }
  }
  __syncthreads();
  const int G = C / groups;
  for (int c = t; c < C; c += kThreads) {
    const int g = c / G;
    const float sc = w[c] * s_rstd[g];
    s_scale[c] = sc;
    s_shift[c] = fmaf(-s_mean[g], sc, bias[c]);
  }
  __syncthreads();

  const int slot = t % V;
  const int r = t / V;
  if (r >= R) return;
  float sc[8], sh[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    sc[j] = s_scale[slot * 8 + j];
    sh[j] = s_shift[slot * 8 + j];
  }
  const long long row0 = static_cast<long long>(chunk) * rows;
  const long long row1 = min(static_cast<long long>(S), row0 + rows);
  const long long base = static_cast<long long>(b) * S * V + slot;
  for (long long row = row0 + r; row < row1; row += static_cast<long long>(kUnroll) * R) {
    uint4 v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long rr = row + static_cast<long long>(u) * R;
      v[u] = rr < row1 ? __ldg(x + base + rr * V) : make_uint4(0u, 0u, 0u, 0u);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long rr = row + static_cast<long long>(u) * R;
      if (rr < row1) {
        float f[8];
        unpack(v[u], f);
        uint4 o;
        o.x = pack(fmaf(f[0], sc[0], sh[0]), fmaf(f[1], sc[1], sh[1]));
        o.y = pack(fmaf(f[2], sc[2], sh[2]), fmaf(f[3], sc[3], sh[3]));
        o.z = pack(fmaf(f[4], sc[4], sh[4]), fmaf(f[5], sc[5], sh[5]));
        o.w = pack(fmaf(f[6], sc[6], sh[6]), fmaf(f[7], sc[7], sh[7]));
        out[base + rr * V] = o;
      }
    }
  }
}

}  // namespace

// x, out: (B, S, C) bf16, contiguous, 16-byte aligned; w, bias: (C,) float32;
// part: (B, chunks, groups, 3) float32 scratch; chunks * rows >= S.
// Returns cudaGetLastError() after the two launches (or the first's error).
extern "C" int rtpose_group_norm(const void* x, const void* w, const void* bias, void* part,
                                 void* out, int B, int S, int C, int groups, int chunks,
                                 int rows, float eps, void* stream) {
  if (B <= 0 || S <= 0 || C <= 0 || C % 8 != 0 || C > kMaxC || groups <= 0 ||
      C % groups != 0 || chunks <= 0 || rows <= 0 ||
      static_cast<long long>(chunks) * rows < S ||
      static_cast<long long>(B) * chunks > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int grid = B * chunks;
  group_norm_stats_kernel<<<grid, kThreads, 0, s>>>(static_cast<const uint4*>(x),
                                                    static_cast<float*>(part), S, C, groups,
                                                    chunks, rows);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t smem = (2 * static_cast<size_t>(C) + 2 * static_cast<size_t>(groups)) * sizeof(float);
  group_norm_apply_kernel<<<grid, kThreads, smem, s>>>(
      static_cast<const uint4*>(x), static_cast<uint4*>(out), static_cast<const float*>(part),
      static_cast<const float*>(w), static_cast<const float*>(bias), S, C, groups, chunks, rows,
      eps);
  return static_cast<int>(cudaGetLastError());
}
