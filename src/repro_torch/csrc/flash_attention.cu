// Blockwise (flash) attention for Hopper (sm_90a): causal and/or
// sliding-window attention over a whole sequence, forward only.
//
// Replaces: src/repro/kernels/flash_attention/flash_attention.py,
//   flash_attention (the Pallas kernel _kernel).  The TPU kernel has no
//   backward pass, and neither has this one.
//
// Contract (identical to the TPU kernel):
//   q (B, H, S, D), k/v (B, K, T, D), out (B, H, S, D), each indexed
//   through its own element strides with unit stride over D — the model
//   passes its (B, S, H, D) activations as they lie.  D <= 128.  Query
//   head h reads KV head h / (H / K).  Query and key positions both
//   start at 0; key j is valid for query i iff (not causal or j <= i) and
//   (window == 0 or j > i - window).  Scores are scaled in fp32; online
//   softmax with m, l and the accumulator in fp32; masked scores are
//   -1e30 (never -inf, which would make a row with no valid key NaN);
//   the denominator is clamped at 1e-30; the output is in q's type.
//   A row with no valid key (T == 0, or window > 0 and i >= T + window -
//   1, for either value of causal) is the mean of V over all T keys, as
//   the TPU kernel's softmax over T scores of -1e30 gives: the epilogue
//   writes that mean for exactly those rows.  Keys past T in a tile are
//   padding and never enter the denominator.
//
// What bounds it on this card: operations.  A causal pass does 4 * D
// flops per valid (query, key) pair on operands read once per query tile,
// far above the ~295 flops a byte where the H100 turns compute bound in
// bf16 (~20 in fp32).
//
// bf16: tensor cores, in FlashAttention-2's shape (mma.sync m16n8k16,
// bf16 in, fp32 accumulate).  One block of four warps takes 64 query rows
// of one (head, batch), 16 rows a warp.  Q is loaded once into registers
// (ldmatrix); K/V tiles of 64 keys go into a two-stage ring in shared
// memory by 16-byte cp.async copies, so the next tile's load overlaps this
// tile's math.  S = Q K^T in fp32; the scale and log2(e) are folded into
// one multiply of the fp32 score before exp2f (products of bf16 values
// are exact in fp32, so this keeps the TPU kernel's q.astype(f32) * scale
// up to summation order).  Row max and sum by quad shuffles in a fixed
// order.  P stays in registers as the A operand of the P V product: it
// never goes through shared memory.  The TPU kernel multiplies p by v in
// fp32; the tensor cores take bf16, so P goes in as two bf16 parts, the
// rounded weight and the rounding of the remainder, and P V is two
// products whose sum carries each weight to ~2^-17.  With one product
// alone (P rounded to bf16, 2^-9 a weight, as SDPA and FlashAttention do)
// stablelm-3b's bf16 prefill logits read 1.995e-2 from the plain
// version's against the 2e-2 check, with two 1.831e-2, within 3 % of the
// fp32-P kernel's 1.780e-2 (H100, PERF.md); the second product costs
// ~15 % of the kernel's time.  D is zero-padded in shared memory to a
// multiple of 16 (the mma depth); rows are padded by 16 bytes so
// ldmatrix's eight row addresses fall in distinct banks.
// Operands that are not 16-byte aligned (D or a stride not a multiple of
// 8, or an offset base) are loaded element by element, synchronously.
//
// fp32: the CUDA-core kernel of the first port (TF32 would break the 2e-5
// tolerance): 64-row query tiles, K/V staged in shared memory as fp32,
// each of 256 threads holding a 4 x 4 block of scores and a 4 x ceil(D /
// 16) block of the accumulator in registers.
//
// Both: key tiles wholly above the causal diagonal or wholly before the
// window are skipped; query tiles are issued heaviest first (the causal
// tail); each output is summed over keys in tile order — no split over T
// and no atomics, so two launches are bit-identical.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <initializer_list>

namespace {

constexpr int kMaxD = 128;
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

// the score of a padding key (past T): exp of it is 0 whatever the row max
__device__ __forceinline__ float pad_score() {
  return -__int_as_float(0x7f800000);
}

// first query row with no valid key: T == 0 -> every row; window > 0 ->
// i >= T + window - 1 (causal or not); else none
__device__ __forceinline__ long long first_empty_row(int T, int window) {
  if (T == 0) return 0;
  return window > 0 ? (long long)T + window - 1 : (1LL << 62);
}

// ---------------------------------------------------------------------------
// fp32: CUDA cores
// ---------------------------------------------------------------------------

namespace f32 {

constexpr int kBQ = 64;              // query rows per block
constexpr int kBK = 64;              // keys per tile
constexpr int kTX = 16;              // threads across keys / dims
constexpr int kTY = 16;              // threads across query rows
constexpr int kThreads = kTX * kTY;
constexpr int kRows = kBQ / kTY;     // query rows per thread
constexpr int kCols = kBK / kTX;     // score columns per thread
constexpr int kDC = kMaxD / kTX;     // output columns per thread, at most

size_t smem_bytes(int D) {
  const size_t dp = D + 1;             // padded rows: no bank conflicts
  return sizeof(float) * (2 * kBQ * dp + (size_t)kBK * D
                          + (size_t)kBQ * (kBK + 1) + kMaxD);
}

__global__ void __launch_bounds__(kThreads)
flash_kernel(const float* __restrict__ q, const float* __restrict__ k,
             const float* __restrict__ v, float* __restrict__ out, int H,
             int K, int S, int T_len, int D, long long qsb, long long qsh,
             long long qss, long long ksb, long long ksk, long long kst,
             long long vsb, long long vsk, long long vst, long long osb,
             long long osh, long long oss, int causal, int window,
             float scale) {
  extern __shared__ float smem[];
  const int DP = D + 1;
  float* q_s = smem;                   // (BQ, DP) scaled queries
  float* k_s = q_s + kBQ * DP;         // (BK, DP)
  float* v_s = k_s + kBK * DP;         // (BK, D)
  float* p_s = v_s + kBK * D;          // (BQ, BK + 1) weights
  float* mean_s = p_s + kBQ * (kBK + 1);   // (kMaxD) mean of V

  const int n_qt = (S + kBQ - 1) / kBQ;
  const int q0 = (n_qt - 1 - (int)blockIdx.x) * kBQ;   // heaviest first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kh = h / (H / K);
  const int tid = threadIdx.x;
  const int tx = tid % kTX;
  const int ty = tid / kTX;

  const float* qb = q + (size_t)b * qsb + (size_t)h * qsh;
  for (int i = tid; i < kBQ * D; i += kThreads) {
    const int r = i / D;
    const int d = i - r * D;
    const int row = q0 + r;
    q_s[r * DP + d] = row < S ? qb[(size_t)row * qss + d] * scale : 0.f;
  }

  float m[kRows], l[kRows], acc[kRows][kDC];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < kDC; ++c) acc[i][c] = 0.f;
  }

  // key tiles that hold a valid key for some row of this query tile
  int k_end = T_len;
  if (causal) k_end = min(T_len, q0 + kBQ);
  int k_begin = 0;
  if (window > 0) {
    const int first = q0 - window + 1;   // first key of the top row
    if (first > 0) k_begin = (first / kBK) * kBK;
  }
  const float* kb = k + (size_t)b * ksb + (size_t)kh * ksk;
  const float* vb = v + (size_t)b * vsb + (size_t)kh * vsk;

  for (int k0 = k_begin; k0 < k_end; k0 += kBK) {
    __syncthreads();                   // the previous tile is consumed
    for (int i = tid; i < kBK * D; i += kThreads) {
      const int r = i / D;
      const int d = i - r * D;
      const int key = k0 + r;
      const bool in = key < T_len;
      k_s[r * DP + d] = in ? kb[(size_t)key * kst + d] : 0.f;
      v_s[r * D + d] = in ? vb[(size_t)key * vst + d] : 0.f;
    }
    __syncthreads();

    // scores of rows ty * kRows + i, keys tx + kTX * j
    float sc[kRows][kCols];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kCols; ++j) sc[i][j] = 0.f;
    for (int d = 0; d < D; ++d) {
      float a[kRows], bk[kCols];
#pragma unroll
      for (int i = 0; i < kRows; ++i) a[i] = q_s[(ty * kRows + i) * DP + d];
#pragma unroll
      for (int j = 0; j < kCols; ++j) bk[j] = k_s[(tx + kTX * j) * DP + d];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < kCols; ++j) sc[i][j] = fmaf(a[i], bk[j], sc[i][j]);
    }

    // mask, then the online-softmax update of each row (the 16 threads of
    // a row are 16 lanes of one warp: xor-shuffles below 16 stay inside).
    // Padding keys (past T) get -inf: exp of it is 0 whatever the row max.
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int qpos = q0 + ty * kRows + i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int kpos = k0 + tx + kTX * j;
        bool valid = true;
        if (causal) valid = valid && kpos <= qpos;
        if (window > 0) valid = valid && kpos > qpos - window;
        if (kpos >= T_len) sc[i][j] = pad_score();
        else if (!valid) sc[i][j] = kNegInf;
        mx = fmaxf(mx, sc[i][j]);
      }
#pragma unroll
      for (int o = kTX / 2; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float psum = 0.f;
      float* prow = p_s + (ty * kRows + i) * (kBK + 1);
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const float p = expf(sc[i][j] - m_new);
        prow[tx + kTX * j] = p;
        psum += p;
      }
#pragma unroll
      for (int o = kTX / 2; o > 0; o >>= 1)
        psum += __shfl_xor_sync(0xffffffffu, psum, o);
      l[i] = l[i] * alpha + psum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < kDC; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();

    // acc += P . V over the tile's keys, in key order
    for (int t = 0; t < kBK; ++t) {
      float vv[kDC];
#pragma unroll
      for (int c = 0; c < kDC; ++c) {
        const int d = tx + kTX * c;
        vv[c] = d < D ? v_s[t * D + d] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const float p = p_s[(ty * kRows + i) * (kBK + 1) + t];
#pragma unroll
        for (int c = 0; c < kDC; ++c) acc[i][c] = fmaf(p, vv[c], acc[i][c]);
      }
    }
  }

  // rows with no valid key: the mean of V over all T keys, in key order
  const long long empty = first_empty_row(T_len, window);
  if (q0 + kBQ - 1 >= empty) {
    if (tid < D) {
      float sum = 0.f;
      for (int t = 0; t < T_len; ++t) sum += vb[(size_t)t * vst + tid];
      mean_s[tid] = T_len > 0 ? sum / (float)T_len : 0.f;
    }
    __syncthreads();
  }

  float* ob = out + (size_t)b * osb + (size_t)h * osh;
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int row = q0 + ty * kRows + i;
    if (row >= S) continue;
    const float denom = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int c = 0; c < kDC; ++c) {
      const int d = tx + kTX * c;
      if (d < D)
        ob[(size_t)row * oss + d] =
            row >= empty ? mean_s[d] : acc[i][c] / denom;
    }
  }
}

int launch(const void* q, const void* k, const void* v, void* out, int B,
           int H, int K, int S, int T_len, int D, const long long* qs,
           const long long* ks, const long long* vs, const long long* os,
           int causal, int window, float scale, cudaStream_t stream) {
  const size_t shmem = smem_bytes(D);
  cudaError_t err = cudaFuncSetAttribute(
      flash_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)shmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((S + kBQ - 1) / kBQ, H, B);
  flash_kernel<<<grid, kThreads, shmem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), H, K, S,
      T_len, D, qs[0], qs[1], qs[2], ks[0], ks[1], ks[2], vs[0], vs[1],
      vs[2], os[0], os[1], os[2], causal, window, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace f32

// ---------------------------------------------------------------------------
// bf16: tensor cores (mma.sync m16n8k16)
// ---------------------------------------------------------------------------

namespace tc {

typedef __nv_bfloat16 bf16;

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kBQ = 16 * kWarps;     // query rows per block, 16 a warp
constexpr int kBK = 64;              // keys per tile
constexpr int kPad = 8;              // row padding: 16 bytes

template <int DP>
struct Layout {                      // DP: D rounded up to 16
  static constexpr int kStride = DP + kPad;          // elements a row
  static constexpr int kQ = kBQ * kStride;
  static constexpr int kKV = kBK * kStride;
  static constexpr size_t kBytes =
      sizeof(bf16) * (size_t)(kQ + 4 * kKV) + sizeof(float) * kMaxD;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

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

__device__ __forceinline__ uint32_t as_u32(__nv_bfloat162 x) {
  return *reinterpret_cast<uint32_t*>(&x);
}

// rows [r0, r0 + ROWS) of a (rows, D) operand into a (ROWS, DP) tile,
// zeros past `limit` rows and past D columns; 16-byte cp.async copies
// when `vec`, else element by element
template <int DP, int ROWS>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src,
                                          long long rs, int r0, int limit,
                                          int D, bool vec) {
  constexpr int kChunks = DP / 8;    // 16-byte chunks a row
  const bf16 zero = __float2bfloat16(0.f);
  for (int i = threadIdx.x; i < ROWS * kChunks; i += kThreads) {
    const int r = i / kChunks;
    const int col = (i - r * kChunks) * 8;
    const int row = r0 + r;
    bf16* d = dst + r * Layout<DP>::kStride + col;
    if (vec) {
      const bool in = row < limit && col < D;
      cp_async16(d, in ? src + (size_t)row * rs + col : src, in ? 16 : 0);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e)
        d[e] = row < limit && col + e < D ? src[(size_t)row * rs + col + e]
                                          : zero;
    }
  }
}

template <int DP>
__global__ void __launch_bounds__(kThreads, 2)
flash_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                const bf16* __restrict__ v, bf16* __restrict__ out, int H,
                int K, int S, int T_len, int D, long long qsb, long long qsh,
                long long qss, long long ksb, long long ksk, long long kst,
                long long vsb, long long vsk, long long vst, long long osb,
                long long osh, long long oss, int causal, int window,
                float scale_log2, int vec_flag) {
  typedef Layout<DP> L;
  constexpr int kStride = L::kStride;
  constexpr int kKS = DP / 16;       // mma depth steps over D
  constexpr int kNT = kBK / 8;       // score n-tiles of 8 keys
  constexpr int kDT = DP / 8;        // output n-tiles of 8 dims
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* q_s = reinterpret_cast<bf16*>(smem_raw);     // (BQ, stride)
  bf16* k_s = q_s + L::kQ;                           // 2 x (BK, stride)
  bf16* v_s = k_s + 2 * L::kKV;                      // 2 x (BK, stride)
  float* mean_s = reinterpret_cast<float*>(v_s + 2 * L::kKV);

  const bool vec = vec_flag != 0;
  const int h = blockIdx.x % H;
  const int b = blockIdx.x / H;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBQ;  // heaviest first
  const int kh = h / (H / K);
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane / 4;            // row of the fragment (and g + 8)
  const int tig = lane % 4;          // column pair of the fragment

  const bf16* qb = q + (size_t)b * qsb + (size_t)h * qsh;
  const bf16* kb = k + (size_t)b * ksb + (size_t)kh * ksk;
  const bf16* vb = v + (size_t)b * vsb + (size_t)kh * vsk;

  int k_end = T_len;
  if (causal) k_end = min(T_len, q0 + kBQ);
  int k_begin = 0;
  if (window > 0) {
    const int first = q0 - window + 1;   // first key of the top row
    if (first > 0) k_begin = (first / kBK) * kBK;
  }
  const int n_tiles = k_begin < k_end ? (k_end - k_begin + kBK - 1) / kBK
                                      : 0;

  load_tile<DP, kBQ>(q_s, qb, qss, q0, S, D, vec);
  cp_async_commit();
  if (n_tiles > 0) {
    load_tile<DP, kBK>(k_s, kb, kst, k_begin, T_len, D, vec);
    load_tile<DP, kBK>(v_s, vb, vst, k_begin, T_len, D, vec);
  }
  cp_async_commit();
  cp_async_wait<1>();                // Q has landed
  __syncthreads();

  uint32_t qf[kKS][4];
#pragma unroll
  for (int kk = 0; kk < kKS; ++kk)
    ldmatrix_x4(qf[kk], q_s + (warp * 16 + lane % 16) * kStride + kk * 16
                            + (lane / 16) * 8);

  float o[kDT][4];
#pragma unroll
  for (int n = 0; n < kDT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
  float m_r[2] = {kNegInf, kNegInf};
  float l_r[2] = {0.f, 0.f};         // this thread's share of the row sum
  const int row0 = q0 + warp * 16 + g;

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = k_begin + t * kBK;
    const bf16* kt = k_s + (t & 1) * L::kKV;
    const bf16* vt = v_s + (t & 1) * L::kKV;
    if (t + 1 < n_tiles) {           // the next tile, into the other stage
      load_tile<DP, kBK>(k_s + ((t + 1) & 1) * L::kKV, kb, kst, k0 + kBK,
                         T_len, D, vec);
      load_tile<DP, kBK>(v_s + ((t + 1) & 1) * L::kKV, vb, vst, k0 + kBK,
                         T_len, D, vec);
    }
    cp_async_commit();
    cp_async_wait<1>();              // tile t has landed
    __syncthreads();

    // S = Q K^T: keys n-tile j, rows g (s[j][0..1]) and g + 8 (s[j][2..3])
    float s[kNT][4];
#pragma unroll
    for (int j = 0; j < kNT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kKS; ++kk) {
#pragma unroll
      for (int np = 0; np < kNT / 2; ++np) {
        uint32_t kf[4];
        ldmatrix_x4(kf, kt + (np * 16 + lane % 8 + (lane / 16) * 8) * kStride
                            + kk * 16 + ((lane / 8) % 2) * 8);
        mma(s[2 * np], qf[kk], kf[0], kf[1]);
        mma(s[2 * np + 1], qf[kk], kf[2], kf[3]);
      }
    }

    // scale (log2 domain), mask only the tiles that cross an edge
    const bool edge = k0 + kBK > T_len
                      || (causal && k0 + kBK - 1 > q0)
                      || (window > 0 && k0 <= q0 + kBQ - 1 - window);
#pragma unroll
    for (int j = 0; j < kNT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[j][e] * scale_log2;
        if (edge) {
          const int kpos = k0 + j * 8 + tig * 2 + (e & 1);
          const int qpos = row0 + (e >> 1) * 8;
          if (kpos >= T_len) {
            x = pad_score();         // never in the denominator
          } else if ((causal && kpos > qpos)
                     || (window > 0 && kpos <= qpos - window)) {
            x = kNegInf;
          }
        }
        s[j][e] = x;
      }
    }

    // online softmax: the four threads of a quad hold one row's scores
    float mx[2] = {m_r[0], m_r[1]};
#pragma unroll
    for (int j = 0; j < kNT; ++j) {
      mx[0] = fmaxf(mx[0], fmaxf(s[j][0], s[j][1]));
      mx[1] = fmaxf(mx[1], fmaxf(s[j][2], s[j][3]));
    }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      alpha[r] = exp2f(m_r[r] - mx[r]);
      m_r[r] = mx[r];
      l_r[r] *= alpha[r];
    }
#pragma unroll
    for (int n = 0; n < kDT; ++n) {
      o[n][0] *= alpha[0];
      o[n][1] *= alpha[0];
      o[n][2] *= alpha[1];
      o[n][3] *= alpha[1];
    }

    // P as the A operand of P V (key step kk = j / 2), in two bf16 parts:
    // the rounded weight and the rounding of the remainder p - hi
    uint32_t p_hi[kNT / 2][4], p_lo[kNT / 2][4];
#pragma unroll
    for (int j = 0; j < kNT; ++j) {
      const float p[4] = {exp2f(s[j][0] - mx[0]), exp2f(s[j][1] - mx[0]),
                          exp2f(s[j][2] - mx[1]), exp2f(s[j][3] - mx[1])};
      const __nv_bfloat162 r0 = __floats2bfloat162_rn(p[0], p[1]);  // row g
      const __nv_bfloat162 r8 = __floats2bfloat162_rn(p[2], p[3]);  // g + 8
      p_hi[j / 2][(j % 2) * 2] = as_u32(r0);
      p_hi[j / 2][(j % 2) * 2 + 1] = as_u32(r8);
      p_lo[j / 2][(j % 2) * 2] = as_u32(__floats2bfloat162_rn(
          p[0] - __low2float(r0), p[1] - __high2float(r0)));
      p_lo[j / 2][(j % 2) * 2 + 1] = as_u32(__floats2bfloat162_rn(
          p[2] - __low2float(r8), p[3] - __high2float(r8)));
      l_r[0] += p[0] + p[1];
      l_r[1] += p[2] + p[3];
    }

    // O += P V: V tile read transposed by ldmatrix
#pragma unroll
    for (int kk = 0; kk < kNT / 2; ++kk) {
#pragma unroll
      for (int dp = 0; dp < kDT / 2; ++dp) {
        uint32_t vf[4];
        ldmatrix_x4_trans(vf, vt + (kk * 16 + lane % 8 + ((lane / 8) % 2) * 8)
                                  * kStride + dp * 16 + (lane / 16) * 8);
        mma(o[2 * dp], p_hi[kk], vf[0], vf[1]);
        mma(o[2 * dp + 1], p_hi[kk], vf[2], vf[3]);
        mma(o[2 * dp], p_lo[kk], vf[0], vf[1]);
        mma(o[2 * dp + 1], p_lo[kk], vf[2], vf[3]);
      }
    }
    __syncthreads();                 // this stage is consumed
  }

  // the row sums over the quad, in a fixed order
  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_r[r] += __shfl_xor_sync(0xffffffffu, l_r[r], 1);
    l_r[r] += __shfl_xor_sync(0xffffffffu, l_r[r], 2);
    inv[r] = 1.f / fmaxf(l_r[r], 1e-30f);
  }

  // rows with no valid key: the mean of V over all T keys, in key order
  const long long empty = first_empty_row(T_len, window);
  if (q0 + kBQ - 1 >= empty && tid < D) {
    float sum = 0.f;
    for (int t = 0; t < T_len; ++t)
      sum += __bfloat162float(vb[(size_t)t * vst + tid]);
    mean_s[tid] = T_len > 0 ? sum / (float)T_len : 0.f;
  }
  __syncthreads();                   // Q's tile is free; the mean is in

  // stage the output tile in q_s, then store it row by row
  bf16* o_s = q_s;
#pragma unroll
  for (int n = 0; n < kDT; ++n) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int rr = warp * 16 + g + r * 8;
      const int col = n * 8 + tig * 2;
      float x0 = o[n][2 * r] * inv[r];
      float x1 = o[n][2 * r + 1] * inv[r];
      if (q0 + rr >= empty) {
        x0 = col < D ? mean_s[col] : 0.f;
        x1 = col + 1 < D ? mean_s[col + 1] : 0.f;
      }
      *reinterpret_cast<__nv_bfloat162*>(o_s + rr * kStride + col) =
          __floats2bfloat162_rn(x0, x1);
    }
  }
  __syncthreads();

  bf16* ob = out + (size_t)b * osb + (size_t)h * osh;
  constexpr int kChunks = DP / 8;
  for (int i = tid; i < kBQ * kChunks; i += kThreads) {
    const int r = i / kChunks;
    const int col = (i - r * kChunks) * 8;
    const int row = q0 + r;
    if (row >= S || col >= D) continue;
    const bf16* src = o_s + r * kStride + col;
    bf16* dst = ob + (size_t)row * oss + col;
    if (vec) {
      *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
    } else {
      for (int e = 0; e < 8 && col + e < D; ++e) dst[e] = src[e];
    }
  }
}

template <int DP>
int launch_dp(const void* q, const void* k, const void* v, void* out, int B,
              int H, int K, int S, int T_len, int D, const long long* qs,
              const long long* ks, const long long* vs, const long long* os,
              int causal, int window, float scale, int vec,
              cudaStream_t stream) {
  const size_t shmem = Layout<DP>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(
      flash_tc_kernel<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)shmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(B * H, (S + kBQ - 1) / kBQ);
  flash_tc_kernel<DP><<<grid, kThreads, shmem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(out), H, K, S, T_len,
      D, qs[0], qs[1], qs[2], ks[0], ks[1], ks[2], vs[0], vs[1], vs[2],
      os[0], os[1], os[2], causal, window, scale * kLog2e, vec);
  return static_cast<int>(cudaGetLastError());
}

int launch(const void* q, const void* k, const void* v, void* out, int B,
           int H, int K, int S, int T_len, int D, const long long* qs,
           const long long* ks, const long long* vs, const long long* os,
           int causal, int window, float scale, cudaStream_t stream) {
  // 16-byte copies need D, every stride and every base in 8-element units
  bool vec = D % 8 == 0;
  for (const void* p : {q, k, v, static_cast<const void*>(out)})
    vec = vec && reinterpret_cast<uintptr_t>(p) % 16 == 0;
  for (const long long* st : {qs, ks, vs, os})
    for (int i = 0; i < 3; ++i) vec = vec && st[i] % 8 == 0;
#define FLASH_TC_CASE(DP)                                                  \
  case DP / 16:                                                            \
    return launch_dp<DP>(q, k, v, out, B, H, K, S, T_len, D, qs, ks, vs,   \
                         os, causal, window, scale, vec ? 1 : 0, stream);
  switch ((D + 15) / 16) {
    FLASH_TC_CASE(16)
    FLASH_TC_CASE(32)
    FLASH_TC_CASE(48)
    FLASH_TC_CASE(64)
    FLASH_TC_CASE(80)
    FLASH_TC_CASE(96)
    FLASH_TC_CASE(112)
    FLASH_TC_CASE(128)
  }
#undef FLASH_TC_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace tc

}  // namespace

// strides: four arrays of 3 element strides each, over (batch, head,
// position) of q, k, v and out; D has unit stride.  1 <= D <= 128.
// dtype: 0 = float32 (CUDA cores), 1 = bfloat16 (tensor cores).  Grids:
// fp32 (ceil(S/64), H, B), bf16 (B * H, ceil(S/64)).  Returns
// cudaGetLastError() after the launch (0 on success).  Allocates nothing;
// runs on `stream`.
extern "C" int flash_attention(
    const void* q, const void* k, const void* v, void* out,
    const void* strides, int B, int H, int K, int S, int T, int D,
    int causal, int window, float scale, int dtype, void* stream) {
  if (D < 1 || D > kMaxD) return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || H == 0 || S == 0) return 0;
  const long long* st = static_cast<const long long*>(strides);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return f32::launch(q, k, v, out, B, H, K, S, T, D, st, st + 3, st + 6,
                       st + 9, causal, window, scale, s);
  if (dtype == 1)
    return tc::launch(q, k, v, out, B, H, K, S, T, D, st, st + 3, st + 6,
                      st + 9, causal, window, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
