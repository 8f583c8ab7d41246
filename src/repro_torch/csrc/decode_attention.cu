// Dense flash-decode for Hopper (sm_90a): one query token per row against
// the row's dense KV cache, read in place in the model's layout.
//
// Replaces: src/repro/kernels/decode_attention/decode_attention.py,
//   decode_attention (the Pallas kernel _kernel).
//
// Contract (identical to the TPU kernel):
//   q (B, H, D) contiguous; k/v indexed as (B, K, T, D) through element
//   strides (sb, sk, st) with unit stride over D — the model's cache is
//   (B, T, K, D) and is passed as it lies, never transposed; pos (T,)
//   int32, the absolute position held by each slot (-1 = empty; ring
//   caches hold them out of order); cache_len (B,) int32.  Query head h
//   reads KV head h / (H / K).  Slot t of row b is valid iff
//   0 <= pos[t] <= cache_len[b] (and, with a window w, pos[t] >
//   cache_len[b] - w).  Online softmax with m, l and the accumulator in
//   fp32; q scaled by `scale` in fp32; masked scores are -1e30; the
//   denominator is clamped at 1e-30; the output is in q's type.
//
// What bounds it on this card: bytes.  Every valid K/V row is read once
// per KV head and serves the H / K query heads of its group (about 2
// flops a byte at MHA, far under the ~295 flops a byte where an H100
// turns compute bound).  One thread block per (b, k) serves the group
// from shared memory and walks the slots in tiles of `tile`, in slot
// order, with no split over T and no atomics.  A tile whose slots are
// all invalid (past cache_len, before the window, empty, or past T) is
// skipped after reading only its `tile` positions, so the K/V bytes read
// are the valid ones.  The arithmetic of a tile is decode_tile.cuh, the
// same code as the paged kernel's: with pos = arange(T) and tile equal to
// the pool's block size, a row walks the same tiles in the same order and
// the result is bit-identical to paged_decode_attention on the same K/V.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "decode_tile.cuh"

namespace {

using decode_tile::kThreads;

template <typename T>
__global__ void __launch_bounds__(kThreads)
dense_decode_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const int* __restrict__ pos,
                    const int* __restrict__ cache_len, T* __restrict__ out,
                    int H, int K, int D, int n_slots, int tile, long long sb,
                    long long sk, long long st, int window, float scale) {
  extern __shared__ float smem[];
  const int kh = blockIdx.x;            // KV head
  const int b = blockIdx.y;             // row
  const int G = H / K;                  // query heads per KV head
  const size_t head0 = (size_t)b * H + (size_t)kh * G;
  const decode_tile::State s =
      decode_tile::begin(smem, q + head0 * D, G, D, tile, scale);

  const int len = cache_len[b];
  const size_t row = (size_t)b * sb + (size_t)kh * sk;
  const int n_tiles = (n_slots + tile - 1) / tile;
  for (int i = 0; i < n_tiles; ++i) {
    const auto valid = [=](int t) {
      const int slot = i * tile + t;
      return slot < n_slots
          && decode_tile::position_valid(pos[slot], len, window);
    };
    int any = 0;
    for (int t = threadIdx.x; t < tile; t += blockDim.x) any |= valid(t);
    if (!__syncthreads_or(any)) continue;   // no valid slot: skip the tile
    const size_t base = row + (size_t)i * tile * st;
    decode_tile::fold(s, k + base, v + base, (size_t)st,
                      min(tile, n_slots - i * tile), valid);
  }
  decode_tile::finish(s, out + head0 * D);
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const int* pos,
           const int* cache_len, void* out, int B, int H, int K, int D,
           int n_slots, int tile, long long sb, long long sk, long long st,
           int window, float scale, cudaStream_t stream) {
  const size_t shmem = decode_tile::smem_bytes(H / K, D, tile);
  cudaError_t err = decode_tile::allow_smem(dense_decode_kernel<T>, shmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(K, B);
  dense_decode_kernel<T><<<grid, kThreads, shmem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), pos, cache_len, static_cast<T*>(out), H, K,
      D, n_slots, tile, sb, sk, st, window, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  k and v share the element strides
// (sb, sk, st).  Returns cudaGetLastError() after the launch (0 on
// success).  Allocates nothing; runs on `stream`.
extern "C" int decode_attention(
    const void* q, const void* k, const void* v, const void* pos,
    const void* cache_len, void* out, int B, int H, int K, int D, int T,
    int tile, long long sb, long long sk, long long st, int window,
    float scale, int dtype, void* stream) {
  const int* ps = static_cast<const int*>(pos);
  const int* ln = static_cast<const int*>(cache_len);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(q, k, v, ps, ln, out, B, H, K, D, T, tile, sb, sk,
                         st, window, scale, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k, v, ps, ln, out, B, H, K, D, T, tile,
                                 sb, sk, st, window, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
