// Int8 stride-1 3x3x3 conv, 32 -> 32 channels, channels-last, for sm_90a.
//
// Not a port of a TPU kernel: the JAX package runs its int8 convs on XLA
// (rtpose_tpu/ops/quant.py::conv3d_int8), and PyTorch has no int8 conv3d on
// CUDA.  This is the port's own kernel for the K3 shape of the int8 serving
// path (rtpose_tpu_torch/ops/conv_k3_int8.py is its wrapper and holds the
// plain version).
//
//   out[b, z, y, x, co] = rnd(fadd(fmul(float(acc), scale[co]), bias[co]))
//   acc = sum over (dz, dy, dx, ci) of x[b, z+dz-1, y+dy-1, x+dx-1, ci] * w[tap][co][ci]
//
// with zero padding, acc an exact int32 (|acc| <= 864 * 127 * 127 < 2^24, so
// float(acc) is exact too), the multiply and add as separate IEEE operations
// (__fmul_rn, __fadd_rn: nvcc may not contract them into an FMA) and one
// round-to-nearest-even to bf16 (or none for float32).  That is the plain
// version's arithmetic operation for operation: the two agree bit for bit.
//
// What bounds it on an H100: 2 * 27 * 32 * 32 int8 operations per voxel, at
// (1, 16, 64, 160) 9.06 G operations (4.6 us at 1979 TOPS) against 15.7 MB
// moved (4.7 us at 3.35 TB/s): both, about equally.  The design is the
// simple one, right first: the 27 KB of weights resident in shared memory
// (loaded once per block of a persistent grid), one halo tile of the input
// in shared memory per output tile, and mma.sync.m16n8k32 (int8 in, int32
// accumulate) with K = the 32 input channels of one tap.  No TMA, no wgmma,
// no pipelining of the halo load: later work.
//
// Tile: 2 (z) x 16 (y) x 16 (x) output voxels, 8 warps; warp w owns the
// four rows (z, y) 4w .. 4w + 3, each row one 16-voxel M tile, times the
// four 8-wide N tiles of the 32 output channels: 64 accumulators a thread.
// Halo: 4 x 18 x 18 voxels of 32 bytes (41,472 B).  Fragments: a thread
// loads 8 contiguous bytes of a voxel row (input channels 8t .. 8t + 7,
// t = lane % 4) as its two A registers of one row, and 8 bytes of a weight
// row as its two B registers; A and B see the same permutation of K, so
// the product is unchanged, and every load is one conflict-free 64-bit
// shared-memory access per half-warp.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int C = 32;
constexpr int TZ = 2, TY = 16, TX = 16;
constexpr int HZ = TZ + 2, HY = TY + 2, HX = TX + 2;
constexpr int THREADS = 256;
constexpr int W_BYTES = 27 * C * C;                 // 27,648
constexpr int IN_BYTES = HZ * HY * HX * C;          // 41,472
constexpr int SMEM = W_BYTES + IN_BYTES;            // 69,120

__device__ __forceinline__ void mma_s8(int (&c)[4], int a0, int a1, int a2, int a3,
                                       int b0, int b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
        : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

template <bool F32OUT>
__device__ __forceinline__ void store2(void* out, size_t idx, float v0, float v1) {
    if (F32OUT) {
        *reinterpret_cast<float2*>(static_cast<float*>(out) + idx) = make_float2(v0, v1);
    } else {
        __nv_bfloat162 h;
        h.x = __float2bfloat16_rn(v0);
        h.y = __float2bfloat16_rn(v1);
        *reinterpret_cast<__nv_bfloat162*>(static_cast<__nv_bfloat16*>(out) + idx) = h;
    }
}

template <bool F32OUT>
__global__ void __launch_bounds__(THREADS)
conv3d_k3_int8_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
                      const float* __restrict__ scale, const float* __restrict__ bias,
                      void* __restrict__ out, int B, int Z, int Y, int X) {
    extern __shared__ __align__(16) int8_t smem[];
    int8_t* w_s = smem;                  // [27][32 co][32 ci]
    int8_t* in_s = smem + W_BYTES;       // [HZ][HY][HX][32 ci]
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int gid = lane >> 2, tig = lane & 3;

    for (int i = tid; i < W_BYTES / 16; i += THREADS)
        reinterpret_cast<int4*>(w_s)[i] = reinterpret_cast<const int4*>(w)[i];

    const int nz = (Z + TZ - 1) / TZ, ny = (Y + TY - 1) / TY, nx = (X + TX - 1) / TX;
    const long long tiles = (long long)B * nz * ny * nx;
    for (long long t = blockIdx.x; t < tiles; t += gridDim.x) {
        const int ix = (int)(t % nx);
        const int iy = (int)((t / nx) % ny);
        const int iz = (int)((t / ((long long)nx * ny)) % nz);
        const int b = (int)(t / ((long long)nx * ny * nz));
        const int z0 = iz * TZ, y0 = iy * TY, x0 = ix * TX;

        __syncthreads();     // the previous tile's reads of in_s are done
        for (int i = tid; i < HZ * HY * HX * 2; i += THREADS) {
            const int v = i >> 1, half = i & 1;
            const int hx = v % HX, hy = (v / HX) % HY, hz = v / (HX * HY);
            const int gz = z0 - 1 + hz, gy = y0 - 1 + hy, gx = x0 - 1 + hx;
            int4 val = make_int4(0, 0, 0, 0);
            if (gz >= 0 && gz < Z && gy >= 0 && gy < Y && gx >= 0 && gx < X) {
                const size_t g = ((((size_t)b * Z + gz) * Y + gy) * X + gx) * C + half * 16;
                val = *reinterpret_cast<const int4*>(x + g);
            }
            reinterpret_cast<int4*>(in_s)[i] = val;
        }
        __syncthreads();

        int acc[4][4][4];
#pragma unroll
        for (int mt = 0; mt < 4; ++mt)
#pragma unroll
            for (int nt = 0; nt < 4; ++nt)
#pragma unroll
                for (int j = 0; j < 4; ++j) acc[mt][nt][j] = 0;

#pragma unroll 1
        for (int tap = 0; tap < 27; ++tap) {
            const int dz = tap / 9, dy = (tap / 3) % 3, dx = tap % 3;
            int bf[4][2];
#pragma unroll
            for (int nt = 0; nt < 4; ++nt) {
                const int2 v = *reinterpret_cast<const int2*>(
                    w_s + (tap * C + nt * 8 + gid) * C + tig * 8);
                bf[nt][0] = v.x;
                bf[nt][1] = v.y;
            }
#pragma unroll
            for (int mt = 0; mt < 4; ++mt) {
                const int row = warp * 4 + mt;
                const int lz = row / TY, ly = row % TY;
                const int8_t* base = in_s + (((lz + dz) * HY + (ly + dy)) * HX + dx) * C + tig * 8;
                const int2 lo = *reinterpret_cast<const int2*>(base + gid * C);
                const int2 hi = *reinterpret_cast<const int2*>(base + (gid + 8) * C);
#pragma unroll
                for (int nt = 0; nt < 4; ++nt)
                    mma_s8(acc[mt][nt], lo.x, hi.x, lo.y, hi.y, bf[nt][0], bf[nt][1]);
            }
        }

#pragma unroll
        for (int mt = 0; mt < 4; ++mt) {
            const int row = warp * 4 + mt;
            const int gz = z0 + row / TY, gy = y0 + row % TY;
            if (gz >= Z || gy >= Y) continue;
#pragma unroll
            for (int h = 0; h < 2; ++h) {
                const int gx = x0 + gid + 8 * h;
                if (gx >= X) continue;
                const size_t o = ((((size_t)b * Z + gz) * Y + gy) * X + gx) * C;
#pragma unroll
                for (int nt = 0; nt < 4; ++nt) {
                    // this thread's output channels: nt * 8 + 2 * tig + {0, 1}
                    const int co = nt * 8 + 2 * tig;
                    float v0 = __fmul_rn((float)acc[mt][nt][2 * h], __ldg(scale + co));
                    float v1 = __fmul_rn((float)acc[mt][nt][2 * h + 1], __ldg(scale + co + 1));
                    if (bias != nullptr) {
                        v0 = __fadd_rn(v0, __ldg(bias + co));
                        v1 = __fadd_rn(v1, __ldg(bias + co + 1));
                    }
                    store2<F32OUT>(out, o + nt * 8 + 2 * tig, v0, v1);
                }
            }
        }
    }
}

template <bool F32OUT>
int launch(const int8_t* x, const int8_t* w, const float* scale, const float* bias,
           void* out, int B, int Z, int Y, int X, int grid, cudaStream_t stream) {
    static bool configured = false;
    if (!configured) {
        cudaError_t e = cudaFuncSetAttribute(conv3d_k3_int8_kernel<F32OUT>,
                                             cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
        if (e != cudaSuccess) return (int)e;
        configured = true;
    }
    conv3d_k3_int8_kernel<F32OUT><<<grid, THREADS, SMEM, stream>>>(x, w, scale, bias, out,
                                                                   B, Z, Y, X);
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" int rtpose_conv3d_k3_int8(const void* x, const void* w, const void* scale,
                                     const void* bias, void* out, int out_f32, int B, int Z,
                                     int Y, int X, int grid, void* stream) {
    const int8_t* xi = static_cast<const int8_t*>(x);
    const int8_t* wi = static_cast<const int8_t*>(w);
    const float* s = static_cast<const float*>(scale);
    const float* bi = static_cast<const float*>(bias);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    return out_f32 ? launch<true>(xi, wi, s, bi, out, B, Z, Y, X, grid, st)
                   : launch<false>(xi, wi, s, bi, out, B, Z, Y, X, grid, st);
}
