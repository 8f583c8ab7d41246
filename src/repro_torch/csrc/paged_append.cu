// Paged KV append for Hopper (sm_90a): write a chunk's K/V straight into
// the block pools, in place.
//
// Replaces: src/repro/kernels/paged_attention/paged_attention.py,
//   paged_append (the Pallas kernel _append_kernel, whose index maps steer
//   each grid step at its target block row).
//
// Contract (identical to the TPU kernel):
//   pools (nb + 1, bs, K, D); k_new/v_new (B, C, K, D); tables (B, bpr);
//   lens, n_valid (B,) int32.  Token c of row b goes to pool row
//   tables[b, clip((lens[b] + c) / bs, 0, bpr - 1)], slot
//   (lens[b] + c) % bs, when c < n_valid[b]; otherwise to the scratch row
//   (nb), slot 0.  Everything else in the pools is untouched.
//
// What bounds it on this card: bytes — each token's K and V rows are read
// once and written once (2 * 2 * K * D elements), no arithmetic.  The
// design gives each (b, c) token one thread block that computes its own
// target from the table (the TPU kernel's scalar prefetch) and copies the
// K * D elements with neighbouring threads on neighbouring addresses.
// The TPU grid runs in order, so of several writes steered to the scratch
// row the last in (b, c) order wins; blocks here run in no order, so only
// that last scratch write is performed (the others would be overwritten)
// and the pools end bit-identical to the TPU kernel's.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;

template <typename T>
__global__ void __launch_bounds__(kThreads)
paged_append_kernel(T* __restrict__ k_pool, T* __restrict__ v_pool,
                    const T* __restrict__ k_new, const T* __restrict__ v_new,
                    const int* __restrict__ tables,
                    const int* __restrict__ lens,
                    const int* __restrict__ n_valid, int B, int C, int KD,
                    int bs, int bpr, int scratch) {
  const int b = blockIdx.x / C;
  const int c = blockIdx.x - b * C;
  int bid;
  int off;
  if (c < n_valid[b]) {
    const int p = lens[b] + c;
    const int blk = min(max(p / bs, 0), bpr - 1);
    bid = tables[(size_t)b * bpr + blk];
    off = p % bs;
  } else {
    // invalid (b, c) positions are c >= n_valid[b], so a row's last one
    // is c == C - 1; the overall last one is in the last such row
    if (c != C - 1) return;
    for (int r = b + 1; r < B; ++r)
      if (n_valid[r] < C) return;
    bid = scratch;
    off = 0;
  }
  const size_t dst = ((size_t)bid * bs + off) * KD;
  const size_t src = ((size_t)b * C + c) * KD;
  for (int i = threadIdx.x; i < KD; i += blockDim.x) {
    k_pool[dst + i] = k_new[src + i];
    v_pool[dst + i] = v_new[src + i];
  }
}

template <typename T>
int launch(void* k_pool, void* v_pool, const void* k_new, const void* v_new,
           const int* tables, const int* lens, const int* n_valid, int B,
           int C, int KD, int bs, int bpr, int scratch,
           cudaStream_t stream) {
  paged_append_kernel<T><<<B * C, kThreads, 0, stream>>>(
      static_cast<T*>(k_pool), static_cast<T*>(v_pool),
      static_cast<const T*>(k_new), static_cast<const T*>(v_new), tables,
      lens, n_valid, B, C, KD, bs, bpr, scratch);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Returns cudaGetLastError() after the
// launch (0 on success).  Allocates nothing; runs on `stream`.
extern "C" int paged_append(void* k_pool, void* v_pool, const void* k_new,
                            const void* v_new, const void* tables,
                            const void* lens, const void* n_valid, int B,
                            int C, int KD, int bs, int bpr, int scratch,
                            int dtype, void* stream) {
  const int* tb = static_cast<const int*>(tables);
  const int* ln = static_cast<const int*>(lens);
  const int* nv = static_cast<const int*>(n_valid);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(k_pool, v_pool, k_new, v_new, tb, ln, nv, B, C, KD,
                         bs, bpr, scratch, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(k_pool, v_pool, k_new, v_new, tb, ln, nv,
                                 B, C, KD, bs, bpr, scratch, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
