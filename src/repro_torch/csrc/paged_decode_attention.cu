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
// result.  The reduction order is fixed (decode_tile.cuh, shared with the
// dense decode_attention.cu, so the two agree bit for bit at tile = bs):
// no split over blocks and no atomics, so a row's result never depends on
// the other rows or on the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "decode_tile.cuh"

namespace {

using decode_tile::kThreads;

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
  const size_t head0 = (size_t)b * H + (size_t)kh * G;
  const decode_tile::State st =
      decode_tile::begin(smem, q + head0 * D, G, D, bs, scale);

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

  for (int i = i0; i < n_blk; ++i) {
    const size_t base = (size_t)tb[i] * row_stride + (size_t)kh * D;
    decode_tile::fold(st, k_pool + base, v_pool + base, tok_stride, bs,
                      [=](int t) {
                        return decode_tile::position_valid(i * bs + t, len,
                                                           window);
                      });
  }
  decode_tile::finish(st, out + head0 * D);
}

template <typename T>
int launch(const void* q, const void* k_pool, const void* v_pool,
           const int* tables, const int* cache_len, void* out, int B, int H,
           int K, int D, int bs, int bpr, int window, float scale,
           cudaStream_t stream) {
  const size_t shmem = decode_tile::smem_bytes(H / K, D, bs);
  cudaError_t err = decode_tile::allow_smem(paged_decode_kernel<T>, shmem);
  if (err != cudaSuccess) return static_cast<int>(err);
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
