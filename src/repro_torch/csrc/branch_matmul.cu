// branch_matmul: grouped GEMM over balanced parallel branches, sm_90a.
//
//     out[g] = x[g] @ w[g]      x (G, M, K), w (G, K, N) -> out (G, M, N)
//
// Replaces the Pallas kernel ``branch_matmul`` of
// src/repro/kernels/branch_matmul/branch_matmul.py: the G branches of a
// §3.1-balanced group (attention heads, experts) run as ONE launch with the
// branch index as a grid axis, instead of G separate products.
//
// Per-group row counts (optional, `counts`, int32 (G,) on the device):
// group g holds min(max(counts[g], 0), M) valid rows; the rows past them
// are written as exact zeros, and a block whose first row lies past them
// writes its zeros and loads nothing, so a group with no row reads none of
// its weights.  This is how the MoE channel computes only the routed rows
// (JAX's dropless path passes the same counts to jax.lax.ragged_dot as
// group_sizes).  The counts are read by the kernel, never by the host.
//
// Types: float32 or bfloat16 operands, fp32 accumulation, output in x's
// type.  Two kernels:
//
// float32 (the §3 planner's fused sites, G=6, M=512, K=2560, N=240 and
// G=6, M=512, K=80, N=2560): CUDA-core FMAs (no TF32, so fp32 keeps the
// reference's 2e-5 tolerance), bound by the FMA rate at those shapes.
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
//     more, else 32 x 64 (32 deep, two stages).  Both 128 threads, at most
//     128 registers each.  Every output is one FMA chain over k in
//     ascending order from 0, computed by one thread: two runs are
//     bit-identical, and equal to cuBLAS sgemm's, which sums in the same
//     order at these shapes.
//
// bfloat16 (the MoE expert GEMMs: dbrx-132b G=16, K/N 6144/10752; kimi-k2
// G=384, K/N 7168/2048; M the bucket capacity, 8 at a decode step of 8
// rows, hundreds at a prefill): the tensor cores, mma.sync m16n8k16 (bf16
// in, fp32 accumulate).  At decode the product reads every routed
// expert's K x N weights for a few rows, so it is bound by bytes; at a
// prefill's capacities by operations.  The design:
//   - bf16 tiles go straight into shared memory by 16-byte cp.async copies
//     (element loads where K or N is not a multiple of 8 or a base is off
//     16 bytes, into the same layout) through a ring of four stages; A
//     fragments by ldmatrix.x4, B fragments by ldmatrix.x4.trans from the
//     k-major w tile; rows padded by 16 bytes, so the eight row addresses
//     of an ldmatrix fall in distinct banks;
//   - three block tiles, picked by M (the caller's capacity): 16 x 128
//     (one m16 of rows, 64 deep, four warps side by side) up to 16 rows,
//     so a decode step streams each expert's weights once with about 60 KB
//     of loads in flight per block; 64 x 128 (32 deep, 2 x 2 warps of 32 x
//     64) below 512 rows, where many small groups would leave most of a
//     taller tile empty (kimi's prefill: 43 rows a group on average); 128
//     x 128 (32 deep, 2 x 4 warps of 64 x 32) from 512 rows.  Over 48 KB of
//     shared memory: each launch opts in first;
//   - the grid runs the row tiles of one (column tile, group) side by
//     side (blockIdx.x over rows), so the blocks that read one strip of a
//     group's weights run together and share it through L2;
//   - no split-K: the grid holds hundreds of blocks at every MoE shape.
//   benchmarks/torch_kernel_variants.py times the tiles, depths and ring
//   lengths at the MoE decode and prefill shapes (none of its variants
//   beats these three there, PERF.md).
//
// Determinism (both types): each output is summed over k in ascending
// order into one fp32 accumulator that starts at 0 — in bf16, the same
// sequence of m16n8k16 steps over the k16 chunks that hold a k < K,
// whatever the tile — and rounded to the output type once.  No split-K,
// no atomics, so two runs are bit-identical and a row's bits do not depend
// on M, the tile, the counts or the other rows.  Edges are bounds-checked:
// any M, K and N (zeros fill the ragged tiles and add exact zeros), unlike
// the TPU kernel's block alignment.
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

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
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

// rows of group g: all M without counts, else counts[g] clamped to [0, M]
__device__ __forceinline__ int group_rows(const int* counts, int g, int M) {
  if (counts == nullptr) return M;
  const int c = counts[g];
  return c < 0 ? 0 : (c > M ? M : c);
}

__device__ __forceinline__ void set_zero(float* p) { *p = 0.f; }

__device__ __forceinline__ void set_zero(__nv_bfloat16* p) {
  *p = __float2bfloat16(0.f);
}

// zeros into rows [r0, r1) x columns [c0, c1) of a row-major (., N)
// output, by the block's threads; `vec`: N, c0 and c1 multiples of 16
// bytes' worth of elements and the output 16-byte aligned
template <typename T>
__device__ __forceinline__ void zero_tile(T* og, int r0, int r1, int c0,
                                          int c1, int N, bool vec) {
  constexpr int kV = 16 / sizeof(T);
  if (vec) {
    const int chunks = (c1 - c0) / kV;
    for (int i = threadIdx.x; i < (r1 - r0) * chunks; i += blockDim.x)
      *reinterpret_cast<uint4*>(og + (size_t)(r0 + i / chunks) * N + c0
                                + (i % chunks) * kV) = make_uint4(0, 0, 0, 0);
  } else {
    const int cols = c1 - c0;
    for (int i = threadIdx.x; i < (r1 - r0) * cols; i += blockDim.x)
      set_zero(og + (size_t)(r0 + i / cols) * N + c0 + i % cols);
  }
}

// 4 consecutive elements (n valid of them, 0..4) into 16 bytes of shared
// memory as fp32; `vec`: n is 0 or 4 and src is 16-byte aligned
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

// out[0..4) = v[0..4) for the first n (0..4) of them; `vec`: 16-byte
// aligned when n == 4
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

__device__ __forceinline__ int clamp4(int n) {
  return n < 0 ? 0 : (n > 4 ? 4 : n);
}

// ---------------------------------------------------------------------------
// float32: CUDA-core FMAs
// ---------------------------------------------------------------------------

// at most 128 registers a thread: 512 threads resident an SM at least
template <class C>
__global__ void __launch_bounds__(C::kThreads, 512 / C::kThreads)
branch_matmul_kernel(const float* __restrict__ x,
                     const float* __restrict__ w, float* __restrict__ out,
                     const int* __restrict__ counts, int M, int K, int N,
                     int vec_flag) {
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
  const int rows = group_rows(counts, g, M);
  float* og = out + (size_t)g * M * N;
  if (m0 >= rows) {                           // past the count: zeros only
    zero_tile(og, m0, min(m0 + BM, M), n0, min(n0 + BN, N), N, vec);
    return;
  }
  const float* xg = x + (size_t)g * M * K;
  const float* wg = w + (size_t)g * K * N;

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
      const int n = gm < rows ? clamp4(K - gk) : 0;
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
    const bool live = gm < rows;              // else a zero row
    float* orow = og + (size_t)gm * N;
#pragma unroll
    for (int q = 0; q < kGroups; ++q) {
      const int gn = n0 + q * kGroupStride + tx * 4;
      if (gn >= N) continue;                  // past the row: never written
      const float* a = acc[i] + q * 4;
      store4(orow + gn, live ? a[0] : 0.f, live ? a[1] : 0.f,
             live ? a[2] : 0.f, live ? a[3] : 0.f, min(N - gn, 4), vec);
    }
  }
}

template <class C>
int launch(const void* x, const void* w, void* out, const int* counts,
           int G, int M, int K, int N, int vec, cudaStream_t s) {
  static_assert(C::kBytes <= 48 * 1024, "more needs an opt-in");
  const dim3 grid((N + C::BN - 1) / C::BN, (M + C::BM - 1) / C::BM, G);
  branch_matmul_kernel<C><<<grid, C::kThreads, C::kBytes, s>>>(
      static_cast<const float*>(x), static_cast<const float*>(w),
      static_cast<float*>(out), counts, M, K, N, vec);
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

bool aligned16(const void* x, const void* w, const void* out) {
  return reinterpret_cast<uintptr_t>(x) % 16 == 0
         && reinterpret_cast<uintptr_t>(w) % 16 == 0
         && reinterpret_cast<uintptr_t>(out) % 16 == 0;
}

int dispatch_f32(const void* x, const void* w, void* out, const int* counts,
                 int G, int M, int K, int N, cudaStream_t s) {
  // vector copies: K and N multiples of 4 and every base on 16 bytes
  const bool vec = K % 4 == 0 && N % 4 == 0 && aligned16(x, w, out);
  const int sms = sm_count();
  // 64 x 64 tiles where they give every SM four blocks or more (the out
  // site: 1920), else twice as many 32 x 64 tiles, so the last wave is
  // not half empty (the qkv site: 384 blocks, 192 of 64 x 64)
  const long long tiles = (long long)((N + 63) / 64) * ((M + 63) / 64) * G;
  if (tiles >= 4LL * sms)
    return launch<Tile<64, 64, 16, 8, 4, 3>>(x, w, out, counts, G, M, K, N,
                                             vec, s);
  return launch<Tile<32, 64, 32, 4, 4, 2>>(x, w, out, counts, G, M, K, N,
                                           vec, s);
}

// ---------------------------------------------------------------------------
// bfloat16: tensor cores (mma.sync m16n8k16, bf16 in, fp32 accumulate)
// ---------------------------------------------------------------------------

namespace tc {

typedef __nv_bfloat16 bf16;

constexpr int kPad = 8;                    // rows: 16 bytes of padding

// a BM x BN block tile, BK deep a stage, STAGES stages in the ring;
// WARPS_M x WARPS_N warps, each a (BM / WARPS_M) x (BN / WARPS_N) tile of
// m16 x n8 accumulators; registers capped so MIN_BLOCKS blocks fit an SM
// (as many as its shared memory holds)
template <int BM_, int BN_, int BK_, int WARPS_M_, int WARPS_N_,
          int STAGES_, int MIN_BLOCKS_>
struct Tile {
  static constexpr int BM = BM_, BN = BN_, BK = BK_, STAGES = STAGES_;
  static constexpr int kWarpsM = WARPS_M_, kWarpsN = WARPS_N_;
  static constexpr int kMinBlocks = MIN_BLOCKS_;
  static constexpr int kThreads = 32 * kWarpsM * kWarpsN;
  static constexpr int kMT = BM / kWarpsM / 16;      // m16 tiles a warp
  static constexpr int kNT = BN / kWarpsN / 8;       // n8 tiles a warp
  static constexpr int kAStride = BK + kPad;         // elements a row
  static constexpr int kBStride = BN + kPad;
  static constexpr int kAStage = BM * kAStride;
  static constexpr int kBStage = BK * kBStride;
  static constexpr size_t kBytes =
      sizeof(bf16) * (size_t)STAGES * (kAStage + kBStage);
  static_assert(BM % (16 * kWarpsM) == 0, "warp rows: whole m16 tiles");
  static_assert(BN % (16 * kWarpsN) == 0, "warp columns: whole n16 pairs");
  static_assert(BK % 16 == 0, "whole k16 steps a stage");
  // every thread copies whole 16-byte chunks of both tiles
  static_assert(BM * BK / 8 % kThreads == 0, "A tile split");
  static_assert(BK * BN / 8 % kThreads == 0, "B tile split");
  // an odd number of 16-byte units a row: the eight rows an ldmatrix
  // reads fall in distinct banks
  static_assert(kAStride / 8 % 2 == 1 && kBStride / 8 % 2 == 1,
                "conflict-free rows");
  static_assert(kMinBlocks * (kBytes + 1024) <= 228 * 1024,
                "shared memory of MIN_BLOCKS blocks an SM");
};

// decode: one m16 of rows (77 KB, 2 blocks an SM); prefill: 64 rows (54
// KB, 4 blocks) or 128 rows (74 KB, 2 blocks of 256 threads)
typedef Tile<16, 128, 64, 1, 4, 4, 2> DecodeTile;
typedef Tile<64, 128, 32, 2, 2, 4, 4> MidTile;
typedef Tile<128, 128, 32, 2, 4, 4, 2> PrefillTile;

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4],
                                            const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// c (16 x 8, fp32) += a (16 x 16, bf16, row) . b (16 x 8, bf16, col)
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ int clamp8(int n) {
  return n < 0 ? 0 : (n > 8 ? 8 : n);
}

// 8 consecutive elements (n valid of them, 0..8) into 16 bytes of shared
// memory, zeros past n; `vec`: n is 0 or 8 and src is 16-byte aligned
// (an asynchronous copy), else element by element
__device__ __forceinline__ void load8(bf16* dst, const bf16* src, int n,
                                      bool vec) {
  if (vec) {
    cp_async16(dst, src, n > 0 ? 16 : 0);
  } else {
    const bf16 zero = __float2bfloat16(0.f);
#pragma unroll
    for (int e = 0; e < 8; ++e) dst[e] = e < n ? src[e] : zero;
  }
}

// (v0, v1) to dst[0..2), the first n (0..2) of them; `vec`: 4-byte
// aligned when n == 2
__device__ __forceinline__ void store2(bf16* dst, float v0, float v1, int n,
                                       bool vec) {
  if (vec && n == 2) {                       // round to nearest even
    *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(v0, v1);
  } else {
    if (n > 0) dst[0] = __float2bfloat16(v0);
    if (n > 1) dst[1] = __float2bfloat16(v1);
  }
}

template <class C>
__global__ void __launch_bounds__(C::kThreads, C::kMinBlocks)
branch_matmul_tc_kernel(const bf16* __restrict__ x,
                        const bf16* __restrict__ w, bf16* __restrict__ out,
                        const int* __restrict__ counts, int M, int K, int N,
                        int vec_flag) {
  constexpr int BM = C::BM, BN = C::BN, BK = C::BK, STAGES = C::STAGES;
  constexpr int kMT = C::kMT, kNT = C::kNT;
  constexpr int kThreads = C::kThreads;
  extern __shared__ __align__(16) float smem[];
  bf16* As = reinterpret_cast<bf16*>(smem);   // STAGES x (BM, BK + kPad)
  bf16* Bs = As + STAGES * C::kAStage;        // STAGES x (BK, BN + kPad)

  const bool vec = vec_flag != 0;
  const int g = blockIdx.z;
  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int rows = group_rows(counts, g, M);
  bf16* og = out + (size_t)g * M * N;
  if (m0 >= rows) {                           // past the count: zeros only
    zero_tile(og, m0, min(m0 + BM, M), n0, min(n0 + BN, N), N, vec);
    return;
  }
  const bf16* xg = x + (size_t)g * M * K;
  const bf16* wg = w + (size_t)g * K * N;

  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const int wm0 = (warp / C::kWarpsN) * (BM / C::kWarpsM);  // warp's rows
  const int wn0 = (warp % C::kWarpsN) * (BN / C::kWarpsN);  // and columns

  // one stage: the A tile (BM x BK; rows past the count zero) and the B
  // tile (BK x BN) at depth k0
  auto load_stage = [&](int stage, int k0) {
    bf16* as = As + stage * C::kAStage;
    bf16* bs = Bs + stage * C::kBStage;
#pragma unroll
    for (int l = 0; l < BM * BK / 8 / kThreads; ++l) {
      const int i = tid + l * kThreads;
      const int r = i / (BK / 8);
      const int c = (i % (BK / 8)) * 8;
      const int gm = m0 + r, gk = k0 + c;
      const int n = gm < rows ? clamp8(K - gk) : 0;
      load8(as + r * C::kAStride + c, xg + (n > 0 ? (size_t)gm * K + gk : 0),
            n, vec);
    }
#pragma unroll
    for (int l = 0; l < BK * BN / 8 / kThreads; ++l) {
      const int i = tid + l * kThreads;
      const int r = i / (BN / 8);
      const int c = (i % (BN / 8)) * 8;
      const int gk = k0 + r, gn = n0 + c;
      const int n = gk < K ? clamp8(N - gn) : 0;
      load8(bs + r * C::kBStride + c,
            wg + (n > 0 ? (size_t)gk * N + gn : 0), n, vec);
    }
  };

  float acc[kMT][kNT][4];
#pragma unroll
  for (int i = 0; i < kMT; ++i)
#pragma unroll
    for (int j = 0; j < kNT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

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

    const bf16* as = As + (kt % STAGES) * C::kAStage;
    const bf16* bs = Bs + (kt % STAGES) * C::kBStage;
    // only the k16 steps that hold a k < K: every tile depth runs the
    // same steps, so a row's bits do not depend on BK
    const int steps = min(BK / 16, (K - kt * BK + 15) / 16);
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      if (kk >= steps) break;
      uint32_t af[kMT][4];
#pragma unroll
      for (int i = 0; i < kMT; ++i)
        ldmatrix_x4(af[i], as + (wm0 + i * 16 + lane % 16) * C::kAStride
                               + kk * 16 + (lane / 16) * 8);
#pragma unroll
      for (int jp = 0; jp < kNT / 2; ++jp) {
        uint32_t bf[4];                       // k16 x n16: two n8 fragments
        ldmatrix_x4_trans(bf, bs + (kk * 16 + lane % 8 + ((lane / 8) % 2) * 8)
                                   * C::kBStride
                                   + wn0 + jp * 16 + (lane / 16) * 8);
#pragma unroll
        for (int i = 0; i < kMT; ++i) {
          mma(acc[i][2 * jp], af[i], bf[0], bf[1]);
          mma(acc[i][2 * jp + 1], af[i], bf[2], bf[3]);
        }
      }
    }
  }

  // each lane holds rows lane / 4 and lane / 4 + 8 of an m16 tile, two
  // adjacent columns (lane % 4) * 2 of an n8 tile
#pragma unroll
  for (int i = 0; i < kMT; ++i) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int gm = m0 + wm0 + i * 16 + lane / 4 + h * 8;
      if (gm >= M) continue;
      const bool live = gm < rows;            // else a zero row
      bf16* orow = og + (size_t)gm * N;
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
        const int gn = n0 + wn0 + j * 8 + (lane % 4) * 2;
        if (gn >= N) continue;
        store2(orow + gn, live ? acc[i][j][2 * h] : 0.f,
               live ? acc[i][j][2 * h + 1] : 0.f, min(N - gn, 2), vec);
      }
    }
  }
}

template <class C>
int launch(const void* x, const void* w, void* out, const int* counts,
           int G, int M, int K, int N, int vec, cudaStream_t s) {
  // past 48 KB of dynamic shared memory only after an opt-in; a launch
  // refused for it never runs, and only cudaGetLastError says so
  cudaError_t err = cudaFuncSetAttribute(
      branch_matmul_tc_kernel<C>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)C::kBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((M + C::BM - 1) / C::BM, (N + C::BN - 1) / C::BN, G);
  branch_matmul_tc_kernel<C><<<grid, C::kThreads, C::kBytes, s>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w),
      static_cast<bf16*>(out), counts, M, K, N, vec);
  return static_cast<int>(cudaGetLastError());
}

int dispatch(const void* x, const void* w, void* out, const int* counts,
             int G, int M, int K, int N, cudaStream_t s) {
  // vector copies: K and N multiples of 8 and every base on 16 bytes
  const int vec = K % 8 == 0 && N % 8 == 0 && aligned16(x, w, out);
  if (M <= DecodeTile::BM)
    return launch<DecodeTile>(x, w, out, counts, G, M, K, N, vec, s);
  if (M < 512)
    return launch<MidTile>(x, w, out, counts, G, M, K, N, vec, s);
  return launch<PrefillTile>(x, w, out, counts, G, M, K, N, vec, s);
}

}  // namespace tc

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x, w and out alike).  counts: null, or
// int32 (G,) on the device: rows past min(max(counts[g], 0), M) are zeros.
extern "C" int branch_matmul(const void* x, const void* w, void* out,
                             const void* counts, int G, int M, int K, int N,
                             int dtype, void* stream) {
  if (G == 0 || M == 0 || N == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* c = static_cast<const int*>(counts);
  if (dtype == 0) return dispatch_f32(x, w, out, c, G, M, K, N, s);
  if (dtype == 1) return tc::dispatch(x, w, out, c, G, M, K, N, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
