// Paged decode attention for Hopper (sm_90a): one query token per row
// against K/V block pools walked through the row's block table.
//
// Replaces: src/repro/kernels/paged_attention/paged_attention.py,
//   paged_decode_attention (the Pallas kernel _decode_kernel).
//
// Contract (identical to the TPU kernel):
//   q (B, H, D); pools (nb + 1, bs, K, D); tables (B, bpr) int32;
//   cache_len (B,) int32.  Query head h reads KV head h / (H / K).  Key
//   position t of row b is valid iff t <= cache_len[b] (and, with a
//   window, t > cache_len[b] - window).  Online softmax with m, l and the
//   accumulator in fp32; q scaled by `scale` in fp32; masked scores are
//   -1e30; the denominator is clamped at 1e-30; the output is in q's type.
//
// What bounds it on this card: bytes.  Each KV block of the row is read
// once per KV head and used for H / K query heads, about 2 flops a byte
// at MHA, far under the ~295 flops a byte where an H100 turns compute
// bound.  The design reads each K/V row of the block table once per
// (row, KV head): one thread block per (b, k) serves the whole query-head
// group from shared memory, loads its own table entries (the TPU kernel's
// scalar prefetch), and stops at the last block that holds a valid
// position — blocks past cache_len (and wholly before the window) are
// masked in the TPU kernel's walk and skipped here, which yields the same
// result.  The reduction order is fixed (one warp per score, tree order
// inside the warp; one thread per head for max and sum; serial over the
// block's tokens for P.V): no split over blocks and no atomics, so a row's
// result never depends on the other rows or on the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kThreads = 128;

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

template <typename T>
__global__ void __launch_bounds__(kThreads)
paged_decode_kernel(const T* __restrict__ q, const T* __restrict__ k_pool,
                    const T* __restrict__ v_pool,
                    const int* __restrict__ tables,
                    const int* __restrict__ cache_len, T* __restrict__ out,
                    int H, int K, int D, int bs, int bpr, int window,
                    float scale) {
  extern __shared__ float smem[];
  const int kh = blockIdx.x;            // KV head
  const int b = blockIdx.y;             // row
  const int G = H / K;                  // query heads per KV head
  const int GD = G * D;
  float* q_s = smem;                    // (G, D) scaled query
  float* acc = q_s + GD;                // (G, D) running P.V
  float* p_s = acc + GD;                // (G, bs) scores, then weights
  float* m_s = p_s + G * bs;            // (G,) running max
  float* l_s = m_s + G;                 // (G,) running denominator
  float* a_s = l_s + G;                 // (G,) rescale of this block

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int n_warps = blockDim.x >> 5;

  const T* qb = q + ((size_t)b * H + (size_t)kh * G) * D;
  for (int i = tid; i < GD; i += blockDim.x) {
    q_s[i] = to_float(qb[i]) * scale;
    acc[i] = 0.f;
  }
  if (tid < G) {
    m_s[tid] = kNegInf;
    l_s[tid] = 0.f;
  }

  const int len = cache_len[b];
  // logical blocks holding positions 0..len, clipped to the table
  const int n_blk = min(len / bs + 1, bpr);
  int i0 = 0;
  if (window > 0) {
    const int first = len - window + 1;   // first position in the window
    if (first > 0) i0 = first / bs;
  }
  const size_t tok_stride = (size_t)K * D;          // one token of a block
  const size_t row_stride = (size_t)bs * tok_stride;  // one pool row
  const int* tb = tables + (size_t)b * bpr;
  __syncthreads();

  for (int i = i0; i < n_blk; ++i) {
    const size_t base = (size_t)tb[i] * row_stride + (size_t)kh * D;
    const T* kb = k_pool + base;
    const T* vb = v_pool + base;
    // scores: one warp per (head, token)
    for (int w = warp; w < G * bs; w += n_warps) {
      const int g = w / bs;
      const int t = w - g * bs;
      const T* kr = kb + (size_t)t * tok_stride;
      const float* qg = q_s + g * D;
      float sum = 0.f;
      for (int d = lane; d < D; d += 32) sum += qg[d] * to_float(kr[d]);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
      if (lane == 0) {
        const int pos = i * bs + t;
        bool valid = pos <= len;
        if (window > 0) valid = valid && pos > len - window;
        p_s[w] = valid ? sum : kNegInf;
      }
    }
    __syncthreads();
    // online-softmax state: one thread per head, serial over the block
    if (tid < G) {
      float* s = p_s + tid * bs;
      float mx = s[0];
      for (int t = 1; t < bs; ++t) mx = fmaxf(mx, s[t]);
      const float m_prev = m_s[tid];
      const float m_new = fmaxf(m_prev, mx);
      float psum = 0.f;
      for (int t = 0; t < bs; ++t) {
        const float p = expf(s[t] - m_new);
        s[t] = p;
        psum += p;
      }
      const float alpha = expf(m_prev - m_new);
      l_s[tid] = l_s[tid] * alpha + psum;
      m_s[tid] = m_new;
      a_s[tid] = alpha;
    }
    __syncthreads();
    // acc = acc * alpha + P.V: one thread per (head, dim), serial over t
    for (int j = tid; j < GD; j += blockDim.x) {
      const int g = j / D;
      const int d = j - g * D;
      const float* p = p_s + g * bs;
      float pv = 0.f;
      for (int t = 0; t < bs; ++t)
        pv += p[t] * to_float(vb[(size_t)t * tok_stride + d]);
      acc[j] = acc[j] * a_s[g] + pv;
    }
    __syncthreads();
  }

  T* ob = out + ((size_t)b * H + (size_t)kh * G) * D;
  for (int j = tid; j < GD; j += blockDim.x)
    ob[j] = from_float<T>(acc[j] / fmaxf(l_s[j / D], 1e-30f));
}

template <typename T>
int launch(const void* q, const void* k_pool, const void* v_pool,
           const int* tables, const int* cache_len, void* out, int B, int H,
           int K, int D, int bs, int bpr, int window, float scale,
           cudaStream_t stream) {
  const int G = H / K;
  const size_t shmem = sizeof(float) * (2 * G * D + G * bs + 3 * G);
  dim3 grid(K, B);
  paged_decode_kernel<T><<<grid, kThreads, shmem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_pool),
      static_cast<const T*>(v_pool), tables, cache_len,
      static_cast<T*>(out), H, K, D, bs, bpr, window, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Returns cudaGetLastError() after the
// launch (0 on success).  Allocates nothing; runs on `stream`.
extern "C" int paged_decode_attention(
    const void* q, const void* k_pool, const void* v_pool,
    const void* tables, const void* cache_len, void* out, int B, int H,
    int K, int D, int bs, int bpr, int window, float scale, int dtype,
    void* stream) {
  const int* tb = static_cast<const int*>(tables);
  const int* ln = static_cast<const int*>(cache_len);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(q, k_pool, v_pool, tb, ln, out, B, H, K, D, bs,
                         bpr, window, scale, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k_pool, v_pool, tb, ln, out, B, H, K,
                                 D, bs, bpr, window, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
