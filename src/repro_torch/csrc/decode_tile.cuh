// One tile of flash-decode: the per-tile arithmetic shared by the paged
// and the dense decode-attention kernels (paged_decode_attention.cu and
// decode_attention.cu).
//
// Both kernels run one thread block per (row, KV head) that serves the
// G = H / K query heads of the group from shared memory and walks the
// row's KV positions tile by tile, in a fixed order, keeping the online
// softmax state (running max m, denominator l, accumulator) in fp32.
// They differ only in where a tile lies: a block-table lookup for the
// paged pool, a stride for the dense cache.  Keeping the arithmetic of a
// tile in this one header is what makes the two kernels bit-identical on
// the same K/V with the same tile size (the dense cache as the paged
// path's baseline, as in the JAX package).
//
// Reduction order of a tile, for every (head g, token t):
//   score  — one warp per (g, t): lane-strided products over d, then a
//            butterfly (xor) tree over the 32 lanes;
//   state  — one thread per head, serially over the tile's tokens: max,
//            then exp and sum;
//   P . V  — one thread per (g, d), serially over the tile's tokens.
// A token whose position is invalid gets the score -1e30; its weight is
// then an exact 0 (the callers walk only tiles that hold a valid token,
// so the running max is a real score), and P . V adds 0 * V for it, as
// the TPU kernels do.  Only the first `n_in` tokens of a tile are read:
// a dense cache's last tile may run past T.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace decode_tile {

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

// Absolute position `pos` is attended by a query at position `len` iff
// 0 <= pos <= len and, with a window w > 0, pos > len - w.
__device__ __forceinline__ bool position_valid(int pos, int len,
                                               int window) {
  bool valid = pos >= 0 && pos <= len;
  if (window > 0) valid = valid && pos > len - window;
  return valid;
}

// Dynamic shared memory of one block: G heads of dim D, tiles of `tile`.
inline size_t smem_bytes(int G, int D, int tile) {
  return sizeof(float) * (2 * (size_t)G * D + (size_t)G * tile + 3 * G);
}

struct State {
  float* q_s;     // (G, D) scaled query
  float* acc;     // (G, D) running P . V
  float* p_s;     // (G, tile) scores, then weights
  float* m_s;     // (G,) running max
  float* l_s;     // (G,) running denominator
  float* a_s;     // (G,) rescale of the current tile
  int G, D, tile;
};

// Carve the block's shared memory, load the group's query heads scaled by
// `scale` in fp32 and reset the softmax state.  Ends with a barrier.
template <typename T>
__device__ __forceinline__ State begin(float* smem,
                                       const T* __restrict__ qb, int G,
                                       int D, int tile, float scale) {
  State s;
  s.G = G;
  s.D = D;
  s.tile = tile;
  s.q_s = smem;
  s.acc = s.q_s + G * D;
  s.p_s = s.acc + G * D;
  s.m_s = s.p_s + G * tile;
  s.l_s = s.m_s + G;
  s.a_s = s.l_s + G;
  for (int i = threadIdx.x; i < G * D; i += blockDim.x) {
    s.q_s[i] = to_float(qb[i]) * scale;
    s.acc[i] = 0.f;
  }
  if (threadIdx.x < G) {
    s.m_s[threadIdx.x] = kNegInf;
    s.l_s[threadIdx.x] = 0.f;
  }
  __syncthreads();
  return s;
}

// Fold one tile into the state.  `kb` / `vb` point at the tile's first
// token of this KV head; consecutive tokens are `tok_stride` elements
// apart; tokens n_in.. of the tile lie outside the cache.  valid(t) says
// whether token t (< tile) is attended; it is false from n_in on.  Ends
// with a barrier.
template <typename T, typename Valid>
__device__ __forceinline__ void fold(const State& s,
                                     const T* __restrict__ kb,
                                     const T* __restrict__ vb,
                                     size_t tok_stride, int n_in,
                                     Valid valid) {
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int n_warps = blockDim.x >> 5;
  const int G = s.G, D = s.D, tile = s.tile;
  // scores: one warp per (head, token); the loads do not wait on the
  // mask (a token past the cache reads the last one in it instead)
  for (int w = warp; w < G * tile; w += n_warps) {
    const int g = w / tile;
    const int t = w - g * tile;
    const T* kr = kb + (size_t)min(t, n_in - 1) * tok_stride;
    const float* qg = s.q_s + g * D;
    float sum = 0.f;
    for (int d = lane; d < D; d += 32) sum += qg[d] * to_float(kr[d]);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      sum += __shfl_xor_sync(0xffffffffu, sum, o);
    if (lane == 0) s.p_s[w] = valid(t) ? sum : kNegInf;
  }
  __syncthreads();
  // online-softmax state: one thread per head, serial over the tile
  if (tid < G) {
    float* p = s.p_s + tid * tile;
    float mx = p[0];
    for (int t = 1; t < tile; ++t) mx = fmaxf(mx, p[t]);
    const float m_prev = s.m_s[tid];
    const float m_new = fmaxf(m_prev, mx);
    float psum = 0.f;
    for (int t = 0; t < tile; ++t) {
      const float e = expf(p[t] - m_new);
      p[t] = e;
      psum += e;
    }
    const float alpha = expf(m_prev - m_new);
    s.l_s[tid] = s.l_s[tid] * alpha + psum;
    s.m_s[tid] = m_new;
    s.a_s[tid] = alpha;
  }
  __syncthreads();
  // acc = acc * alpha + P . V: one thread per (head, dim), serial over t
  for (int j = tid; j < G * D; j += blockDim.x) {
    const int g = j / D;
    const int d = j - g * D;
    const float* p = s.p_s + g * tile;
    float pv = 0.f;
    for (int t = 0; t < n_in; ++t)
      pv += p[t] * to_float(vb[(size_t)t * tok_stride + d]);
    s.acc[j] = s.acc[j] * s.a_s[g] + pv;
  }
  __syncthreads();
}

// out = acc / max(l, 1e-30), in the output type.
template <typename T>
__device__ __forceinline__ void finish(const State& s,
                                       T* __restrict__ ob) {
  for (int j = threadIdx.x; j < s.G * s.D; j += blockDim.x)
    ob[j] = from_float<T>(s.acc[j] / fmaxf(s.l_s[j / s.D], 1e-30f));
}

// Allow more than the default 48 KB of dynamic shared memory when needed.
template <typename Kernel>
inline cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

}  // namespace decode_tile
