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
// so it is bound by the CUDA cores' FMA rate.  The design keeps the FMA
// pipes fed:
//   - each thread holds a TM x TN register tile (8 x 4 or 4 x 4): every
//     16-byte shared-memory read feeds 16 or more FMAs.  A is kept m-major
//     in shared memory and read four k at a time per row, B k-major and
//     read as float4 per k; a thread's rows are strided by the number of
//     thread rows, so a warp's A reads fall in distinct banks (rows
//     padded by 16 bytes) and its B reads are contiguous;
//   - global -> shared by 16-byte cp.async copies into a ring of two or
//     three stages (4-byte copies where K or N is not a multiple of 4),
//     one barrier a stage, so the next stages load while one is computed;
//   - the block tile is chosen per shape so the grid fills the SMs: 64 x
//     64 (16 deep, three stages) where that gives every SM four blocks or
//     more, else 32 x 64 (32 deep, two stages), twice as many blocks so
//     the last wave is not half empty.  Both 128 threads, at most 128
//     registers each.  benchmarks/torch_kernel_variants.py times them
//     beside other tile, depth and ring shapes at the planner's two sites.
// bfloat16 shares the tiling; its tiles are converted to fp32 on the way
// into shared memory, through registers (synchronous loads).  Tensor cores
// for bf16 wait for the shapes of a live MoE path.
//
// Determinism: every output element is one FMA chain over k in ascending
// order starting from 0, computed by one thread (no split-K, no atomics, no
// second partial sum), so two runs are bit-identical — and equal to cuBLAS
// sgemm's, which sums in the same order at these shapes.  Edges are
// bounds-checked: any M, K and N (zeros fill the ragged tiles and add exact
// zeros), unlike the TPU kernel's block alignment.
//
// C interface (ctypes): returns the CUDA error of the launch, 0 on success.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int APAD = 4;                    // A rows: 16 bytes of padding

// a BM x BN block tile, BK deep a stage, STAGES stages in the ring; each
// thread a TM x TN register tile, its rows strided by BM / TM and its
// columns TN / 4 groups of 4 strided by BN / (TN / 4)
template <int BM_, int BN_, int BK_, int TM_, int TN_, int STAGES_>
struct Tile {
  static constexpr int BM = BM_, BN = BN_, BK = BK_, TM = TM_, TN = TN_;
  static constexpr int STAGES = STAGES_;
  static constexpr int kGroups = TN / 4;              // float4 column groups
  static constexpr int kThreadCols = BN / TN;
  static constexpr int kThreadRows = BM / TM;
  static constexpr int kThreads = kThreadCols * kThreadRows;
  static constexpr int kAStride = BK + APAD;            // floats
  static constexpr int kAStage = BM * kAStride;
  static constexpr int kBStage = BK * BN;
  static constexpr size_t kBytes =
      sizeof(float) * (size_t)STAGES * (kAStage + kBStage);
  // every thread copies whole 16-byte chunks of both tiles
  static_assert(BM * BK / 4 % kThreads == 0, "A tile split");
  static_assert(BK * BN / 4 % kThreads == 0, "B tile split");
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

// 4 consecutive elements (n valid of them, 0..4) into 16 bytes of shared
// memory as fp32; `vec`: n is 0 or 4 and src is 16-byte aligned (fp32) or
// 8-byte aligned (bf16)
__device__ __forceinline__ void load4(float* dst, const float* src, int n,
                                      bool vec) {
  if (vec) {
    cp_async16(dst, src, n > 0 ? 16 : 0);
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e) cp_async4(dst + e, src + (e < n ? e : 0),
                                          e < n ? 4 : 0);
  }
}

__device__ __forceinline__ void load4(float* dst, const __nv_bfloat16* src,
                                      int n, bool vec) {
  float4 f = make_float4(0.f, 0.f, 0.f, 0.f);
  if (vec) {
    if (n > 0) {
      const uint2 raw = *reinterpret_cast<const uint2*>(src);
      const __nv_bfloat162 lo = *reinterpret_cast<const __nv_bfloat162*>(
          &raw.x);
      const __nv_bfloat162 hi = *reinterpret_cast<const __nv_bfloat162*>(
          &raw.y);
      f = make_float4(__low2float(lo), __high2float(lo), __low2float(hi),
                      __high2float(hi));
    }
  } else {
    if (n > 0) f.x = __bfloat162float(src[0]);
    if (n > 1) f.y = __bfloat162float(src[1]);
    if (n > 2) f.z = __bfloat162float(src[2]);
    if (n > 3) f.w = __bfloat162float(src[3]);
  }
  *reinterpret_cast<float4*>(dst) = f;
}

// out[0..4) = v[0..4) for the first n (0..4) of them; `vec`: 16-byte
// (fp32) or 8-byte (bf16) aligned when n == 4
__device__ __forceinline__ void store4(float* dst, float v0, float v1,
                                       float v2, float v3, int n, bool vec) {
  if (vec && n == 4) {
    *reinterpret_cast<float4*>(dst) = make_float4(v0, v1, v2, v3);
  } else {
    if (n > 0) dst[0] = v0;
    if (n > 1) dst[1] = v1;
    if (n > 2) dst[2] = v2;
    if (n > 3) dst[3] = v3;
  }
}

__device__ __forceinline__ void store4(__nv_bfloat16* dst, float v0,
                                       float v1, float v2, float v3, int n,
                                       bool vec) {
  if (vec && n == 4) {                      // round to nearest even
    uint2 raw;
    *reinterpret_cast<__nv_bfloat162*>(&raw.x) =
        __floats2bfloat162_rn(v0, v1);
    *reinterpret_cast<__nv_bfloat162*>(&raw.y) =
        __floats2bfloat162_rn(v2, v3);
    *reinterpret_cast<uint2*>(dst) = raw;
  } else {
    if (n > 0) dst[0] = __float2bfloat16(v0);
    if (n > 1) dst[1] = __float2bfloat16(v1);
    if (n > 2) dst[2] = __float2bfloat16(v2);
    if (n > 3) dst[3] = __float2bfloat16(v3);
  }
}

__device__ __forceinline__ int clamp4(int n) {
  return n < 0 ? 0 : (n > 4 ? 4 : n);
}

// at most 128 registers a thread: 512 threads resident an SM at least
template <typename T, class C>
__global__ void __launch_bounds__(C::kThreads, 512 / C::kThreads)
branch_matmul_kernel(const T* __restrict__ x, const T* __restrict__ w,
                     T* __restrict__ out, int M, int K, int N, int vec_flag) {
  constexpr int BM = C::BM, BN = C::BN, BK = C::BK, TM = C::TM, TN = C::TN;
  constexpr int STAGES = C::STAGES;
  constexpr int kGroups = C::kGroups;
  constexpr int kGroupStride = BN / kGroups;
  constexpr int kTC = C::kThreadCols;
  constexpr int kTR = C::kThreadRows;
  constexpr int kThreads = C::kThreads;
  extern __shared__ __align__(16) float smem[];
  float* As = smem;                           // STAGES x (BM, BK + APAD)
  float* Bs = smem + STAGES * C::kAStage;     // STAGES x (BK, BN)

  const bool vec = vec_flag != 0;
  const int g = blockIdx.z;
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  const T* xg = x + (size_t)g * M * K;
  const T* wg = w + (size_t)g * K * N;
  T* og = out + (size_t)g * M * N;

  const int tid = threadIdx.x;
  const int tx = tid % kTC;                   // columns tx*4 + q*BN/groups
  const int ty = tid / kTC;                   // rows ty + kTR * i

  // one stage: the A tile (BM x BK) and the B tile (BK x BN) at depth k0
  auto load_stage = [&](int stage, int k0) {
    float* as = As + stage * C::kAStage;
    float* bs = Bs + stage * C::kBStage;
#pragma unroll
    for (int l = 0; l < BM * BK / 4 / kThreads; ++l) {
      const int i = tid + l * kThreads;
      const int r = i / (BK / 4);
      const int c = (i % (BK / 4)) * 4;
      const int gm = m0 + r, gk = k0 + c;
      const int n = gm < M ? clamp4(K - gk) : 0;
      load4(as + r * C::kAStride + c, xg + (n > 0 ? (size_t)gm * K + gk : 0),
            n, vec);
    }
#pragma unroll
    for (int l = 0; l < BK * BN / 4 / kThreads; ++l) {
      const int i = tid + l * kThreads;
      const int r = i / (BN / 4);
      const int c = (i % (BN / 4)) * 4;
      const int gk = k0 + r, gn = n0 + c;
      const int n = gk < K ? clamp4(N - gn) : 0;
      load4(bs + r * BN + c, wg + (n > 0 ? (size_t)gk * N + gn : 0), n,
            vec);
    }
  };

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  const int nk = (K + BK - 1) / BK;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nk) load_stage(s, s * BK);
    cp_async_commit();
  }

  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<STAGES - 2>();              // stage kt has landed
    __syncthreads();                          // and stage kt - 1 is free
    const int next = kt + STAGES - 1;
    if (next < nk) load_stage(next % STAGES, next * BK);
    cp_async_commit();

    const float* as = As + (kt % STAGES) * C::kAStage;
    const float* bs = Bs + (kt % STAGES) * C::kBStage;
#pragma unroll
    for (int kq = 0; kq < BK; kq += 4) {
      float4 a[TM];
#pragma unroll
      for (int i = 0; i < TM; ++i)
        a[i] = *reinterpret_cast<const float4*>(
            as + (ty + kTR * i) * C::kAStride + kq);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {        // k ascending within the stage
        const float* brow = bs + (kq + kk) * BN + tx * 4;
        float bv[TN];
#pragma unroll
        for (int q = 0; q < kGroups; ++q) {
          const float4 b = *reinterpret_cast<const float4*>(
              brow + q * kGroupStride);
          bv[4 * q] = b.x;
          bv[4 * q + 1] = b.y;
          bv[4 * q + 2] = b.z;
          bv[4 * q + 3] = b.w;
        }
#pragma unroll
        for (int i = 0; i < TM; ++i) {
          const float av = kk == 0 ? a[i].x : kk == 1 ? a[i].y
                         : kk == 2 ? a[i].z : a[i].w;
#pragma unroll
          for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(av, bv[j], acc[i][j]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int gm = m0 + ty + kTR * i;
    if (gm >= M) continue;
    T* orow = og + (size_t)gm * N;
#pragma unroll
    for (int q = 0; q < kGroups; ++q) {
      const int gn = n0 + q * kGroupStride + tx * 4;
      if (gn >= N) continue;                  // past the row: never written
      const float* a = acc[i] + q * 4;
      store4(orow + gn, a[0], a[1], a[2], a[3], min(N - gn, 4), vec);
    }
  }
}

template <typename T, class C>
int launch(const void* x, const void* w, void* out, int G, int M, int K,
           int N, int vec, cudaStream_t s) {
  static_assert(C::kBytes <= 48 * 1024, "more needs an opt-in");
  const dim3 grid((N + C::BN - 1) / C::BN, (M + C::BM - 1) / C::BM, G);
  branch_matmul_kernel<T, C><<<grid, C::kThreads, C::kBytes, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(w),
      static_cast<T*>(out), M, K, N, vec);
  return static_cast<int>(cudaGetLastError());
}

// the current device's SM count, asked once a device
int sm_count() {
  static int count[64];
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < 0 || dev >= 64) return 132;
  if (count[dev] == 0)
    cudaDeviceGetAttribute(&count[dev], cudaDevAttrMultiProcessorCount, dev);
  return count[dev] > 0 ? count[dev] : 132;
}

template <typename T>
int dispatch(const void* x, const void* w, void* out, int G, int M, int K,
             int N, cudaStream_t s) {
  // vector copies: K and N multiples of 4 and every base aligned to them
  const uintptr_t align = 4 * sizeof(T);
  const bool vec = K % 4 == 0 && N % 4 == 0
                   && reinterpret_cast<uintptr_t>(x) % align == 0
                   && reinterpret_cast<uintptr_t>(w) % align == 0
                   && reinterpret_cast<uintptr_t>(out) % align == 0;
  const int sms = sm_count();
  // 64 x 64 tiles where they give every SM four blocks or more (the out
  // site: 1920), else twice as many 32 x 64 tiles, so the last wave is
  // not half empty (the qkv site: 384 blocks, 192 of 64 x 64)
  const long long tiles = (long long)((N + 63) / 64) * ((M + 63) / 64) * G;
  if (tiles >= 4LL * sms)
    return launch<T, Tile<64, 64, 16, 8, 4, 3>>(x, w, out, G, M, K, N, vec,
                                                s);
  return launch<T, Tile<32, 64, 32, 4, 4, 2>>(x, w, out, G, M, K, N, vec, s);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x, w and out alike).
extern "C" int branch_matmul(const void* x, const void* w, void* out, int G,
                             int M, int K, int N, int dtype, void* stream) {
  if (G == 0 || M == 0 || N == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch<float>(x, w, out, G, M, K, N, s);
  if (dtype == 1) return dispatch<__nv_bfloat16>(x, w, out, G, M, K, N, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
