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
//   passes its (B, S, H, D) activations as they lie.  Query head h reads
//   KV head h / (H / K).  Query and key positions both start at 0; key j
//   is valid for query i iff (not causal or j <= i) and (window == 0 or
//   j > i - window).  q is scaled by `scale` in fp32 before the products;
//   online softmax with m, l and the accumulator in fp32 (no TF32, no
//   tensor cores); masked scores are -1e30; the denominator is clamped at
//   1e-30; the output is in q's type.
//
// What bounds it on this card: operations.  A causal pass does 4 * D
// flops per valid (query, key) pair on operands read once per query tile,
// far above the ~20 flops a byte where the H100 turns compute bound in
// fp32 (and ~295 in bf16).  This first kernel computes in fp32 on the CUDA
// cores: one thread block per (query tile of 64 rows, head, row); K/V
// tiles of 64 keys staged in shared memory as fp32; each of 256 threads
// holds a 4 x 4 block of scores and a 4 x ceil(D / 16) block of the
// output accumulator in registers.  Key tiles wholly above the causal
// diagonal or wholly before the window are skipped, so the work is the
// valid pairs plus the partial tiles on the edges.  Query tiles are
// issued heaviest first (the causal tail), to shorten the last wave.
// Each output is summed over keys in tile order: no split over T and no
// atomics, so a launch is deterministic.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBQ = 64;              // query rows per block
constexpr int kBK = 64;              // keys per tile
constexpr int kTX = 16;              // threads across keys / dims
constexpr int kTY = 16;              // threads across query rows
constexpr int kThreads = kTX * kTY;
constexpr int kRows = kBQ / kTY;     // query rows per thread
constexpr int kCols = kBK / kTX;     // score columns per thread
constexpr int kMaxD = 128;
constexpr int kDC = kMaxD / kTX;     // output columns per thread, at most
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

size_t smem_bytes(int D) {
  const size_t dp = D + 1;             // padded rows: no bank conflicts
  return sizeof(float) * (2 * kBQ * dp + (size_t)kBK * D
                          + (size_t)kBQ * (kBK + 1));
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, T* __restrict__ out, int H, int K,
             int S, int T_len, int D, long long qsb, long long qsh,
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

  const int n_qt = (S + kBQ - 1) / kBQ;
  const int q0 = (n_qt - 1 - (int)blockIdx.x) * kBQ;   // heaviest first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kh = h / (H / K);
  const int tid = threadIdx.x;
  const int tx = tid % kTX;
  const int ty = tid / kTX;

  const T* qb = q + (size_t)b * qsb + (size_t)h * qsh;
  for (int i = tid; i < kBQ * D; i += kThreads) {
    const int r = i / D;
    const int d = i - r * D;
    const int row = q0 + r;
    q_s[r * DP + d] =
        row < S ? to_float(qb[(size_t)row * qss + d]) * scale : 0.f;
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
  const T* kb = k + (size_t)b * ksb + (size_t)kh * ksk;
  const T* vb = v + (size_t)b * vsb + (size_t)kh * vsk;

  for (int k0 = k_begin; k0 < k_end; k0 += kBK) {
    __syncthreads();                   // the previous tile is consumed
    for (int i = tid; i < kBK * D; i += kThreads) {
      const int r = i / D;
      const int d = i - r * D;
      const int key = k0 + r;
      const bool in = key < T_len;
      k_s[r * DP + d] = in ? to_float(kb[(size_t)key * kst + d]) : 0.f;
      v_s[r * D + d] = in ? to_float(vb[(size_t)key * vst + d]) : 0.f;
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
    // a row are 16 lanes of one warp: xor-shuffles below 16 stay inside)
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int qpos = q0 + ty * kRows + i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int kpos = k0 + tx + kTX * j;
        bool valid = kpos < T_len;
        if (causal) valid = valid && kpos <= qpos;
        if (window > 0) valid = valid && kpos > qpos - window;
        if (!valid) sc[i][j] = kNegInf;
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

  T* ob = out + (size_t)b * osb + (size_t)h * osh;
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int row = q0 + ty * kRows + i;
    if (row >= S) continue;
    const float denom = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int c = 0; c < kDC; ++c) {
      const int d = tx + kTX * c;
      if (d < D) ob[(size_t)row * oss + d] = from_float<T>(acc[i][c] / denom);
    }
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* out, int B,
           int H, int K, int S, int T_len, int D, const long long* qs,
           const long long* ks, const long long* vs, const long long* os,
           int causal, int window, float scale, cudaStream_t stream) {
  const size_t shmem = smem_bytes(D);
  cudaError_t err = cudaFuncSetAttribute(
      flash_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)shmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((S + kBQ - 1) / kBQ, H, B);
  flash_kernel<T><<<grid, kThreads, shmem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), H, K, S, T_len, D,
      qs[0], qs[1], qs[2], ks[0], ks[1], ks[2], vs[0], vs[1], vs[2], os[0],
      os[1], os[2], causal, window, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// strides: four arrays of 3 element strides each, over (batch, head,
// position) of q, k, v and out; D has unit stride.  D <= 128.  dtype: 0 =
// float32, 1 = bfloat16.  Returns cudaGetLastError() after the launch (0
// on success).  Allocates nothing; runs on `stream`.
extern "C" int flash_attention(
    const void* q, const void* k, const void* v, void* out,
    const void* strides, int B, int H, int K, int S, int T, int D,
    int causal, int window, float scale, int dtype, void* stream) {
  if (D < 1 || D > kMaxD) return static_cast<int>(cudaErrorInvalidValue);
  const long long* st = static_cast<const long long*>(strides);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(q, k, v, out, B, H, K, S, T, D, st, st + 3, st + 6,
                         st + 9, causal, window, scale, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k, v, out, B, H, K, S, T, D, st, st + 3,
                                 st + 6, st + 9, causal, window, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
