// branch_matmul: grouped GEMM over balanced parallel branches, sm_90a.
//
//     out[g] = x[g] @ w[g]      x (G, M, K), w (G, K, N) -> out (G, M, N)
//
// Replaces the Pallas kernel ``branch_matmul`` of
// src/repro/kernels/branch_matmul/branch_matmul.py: the G branches of a
// §3.1-balanced group (attention heads, experts) run as ONE launch with the
// branch index as a grid axis, instead of G separate products.
//
// Types: float32 or bfloat16 operands, fp32 accumulation by plain FMA (no
// TF32, so fp32 keeps the reference's 2e-5 tolerance), output in x's type.
//
// What bounds it: at the fused planner path's shapes (G=6, M=512, K=2560,
// N=240 and G=6, M=512, K=80, N=2560, fp32) the product does far more
// operations per byte than the card's fp32 FMA rate over its memory rate,
// so it is bound by operations.  The design keeps each operand tile in
// shared memory and reuses it from registers: a 64x64 output tile per
// block of 256 threads, each thread a 4x4 register tile, K staged 16 at a
// time.  Fast Hopper paths (wgmma, TMA, a ring of stages) are later work.
//
// Determinism: every output element is summed by one thread over k in
// ascending order (no split-K, no atomics), so two runs are bit-identical.
// Edges are bounds-checked: any M, K and N (zeros fill the ragged tiles
// and add exact zeros), unlike the TPU kernel's block alignment.
//
// C interface (ctypes): returns the CUDA error of the launch, 0 on success.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 64;                     // output rows per block
constexpr int BN = 64;                     // output columns per block
constexpr int BK = 16;                     // depth of one shared-memory stage
constexpr int TM = 4;                      // register tile rows per thread
constexpr int TN = 4;                      // register tile columns per thread
constexpr int THREADS = (BM / TM) * (BN / TN);   // 256
constexpr int PAD = 4;                     // keeps rows 16-byte aligned

__device__ __forceinline__ float load_f32(const float* p) { return *p; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_f32(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f32(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);                // round to nearest even
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
branch_matmul_kernel(const T* __restrict__ x, const T* __restrict__ w,
                     T* __restrict__ out, int M, int K, int N) {
  // k-major tiles: a thread reads 4 consecutive rows of A and 4
  // consecutive columns of B as one 16-byte load each
  __shared__ __align__(16) float As[BK][BM + PAD];
  __shared__ __align__(16) float Bs[BK][BN + PAD];

  const int g = blockIdx.z;
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  const T* xg = x + (size_t)g * M * K;
  const T* wg = w + (size_t)g * K * N;
  T* og = out + (size_t)g * M * N;

  const int tid = threadIdx.x;
  const int tx = tid % (BN / TN);          // column group of the thread
  const int ty = tid / (BN / TN);          // row group of the thread

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += BK) {
    // A tile (BM x BK): consecutive threads walk k, the contiguous axis
#pragma unroll
    for (int l = 0; l < BM * BK / THREADS; ++l) {
      const int i = tid + l * THREADS;
      const int r = i / BK, c = i % BK;
      const int gm = m0 + r, gk = k0 + c;
      As[c][r] = (gm < M && gk < K) ? load_f32(xg + (size_t)gm * K + gk)
                                    : 0.f;
    }
    // B tile (BK x BN): consecutive threads walk n, the contiguous axis
#pragma unroll
    for (int l = 0; l < BK * BN / THREADS; ++l) {
      const int i = tid + l * THREADS;
      const int r = i / BN, c = i % BN;
      const int gk = k0 + r, gn = n0 + c;
      Bs[r][c] = (gk < K && gn < N) ? load_f32(wg + (size_t)gk * N + gn)
                                    : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      const float4 a = *reinterpret_cast<const float4*>(&As[kk][ty * TM]);
      const float4 b = *reinterpret_cast<const float4*>(&Bs[kk][tx * TN]);
      const float av[TM] = {a.x, a.y, a.z, a.w};
      const float bv[TN] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int gm = m0 + ty * TM + i;
    if (gm >= M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int gn = n0 + tx * TN + j;
      if (gn < N) store_f32(og + (size_t)gm * N + gn, acc[i][j]);
    }
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x, w and out alike).
extern "C" int branch_matmul(const void* x, const void* w, void* out, int G,
                             int M, int K, int N, int dtype, void* stream) {
  if (G == 0 || M == 0 || N == 0) return 0;
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM, G);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    branch_matmul_kernel<float><<<grid, THREADS, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(w),
        static_cast<float*>(out), M, K, N);
  } else if (dtype == 1) {
    branch_matmul_kernel<__nv_bfloat16><<<grid, THREADS, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x),
        static_cast<const __nv_bfloat16*>(w),
        static_cast<__nv_bfloat16*>(out), M, K, N);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
