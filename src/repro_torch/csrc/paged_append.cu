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
// once and written once (2 * 2 * K * D elements), no arithmetic; at the
// decode shape (B = 8, C = 1, K = 32, D = 80, bf16) that is 82 KB, so a
// launch and two dependent memory latencies are what it costs.  The
// design spreads the copy over the card and keeps the latencies from
// adding up: a block of 64 threads per (token, slice of K * D), each
// thread moving one element of K and one of V — 320 blocks at the decode
// shape.  (16-byte vectors, 40 blocks, time the same there: the launch
// and the target chain dominate, so the element path alone is kept.)  A
// thread issues its K and V loads first: they do not depend on the
// target, so they are in flight while the target chain n_valid -> lens ->
// tables resolves, and only the stores wait for it.  The TPU grid runs in
// order, so of several writes steered to the scratch row the last in
// (b, c) order wins; blocks here run in no order, so only that last
// scratch write is performed (the others would be overwritten) and the
// pools end bit-identical to the TPU kernel's.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 64;

// T: the element type; units: K * D elements a token row.
// grid (B * C, slices).
template <typename T>
__global__ void __launch_bounds__(kThreads)
paged_append_kernel(T* __restrict__ k_pool, T* __restrict__ v_pool,
                    const T* __restrict__ k_new, const T* __restrict__ v_new,
                    const int* __restrict__ tables,
                    const int* __restrict__ lens,
                    const int* __restrict__ n_valid, int B, int C, int units,
                    int bs, int bpr, int scratch) {
  const int tok = blockIdx.x;
  const int b = tok / C;
  const int c = tok - b * C;
  const int u = blockIdx.y * kThreads + threadIdx.x;
  const bool in = u < units;
  const size_t src = (size_t)tok * units + u;
  T kv{}, vv{};
  if (in) {
    kv = k_new[src];
    vv = v_new[src];
  }
  const int nv = n_valid[b];
  const int len = lens[b];
  int bid;
  int off;
  if (c < nv) {
    const int p = len + c;
    bid = tables[(size_t)b * bpr + min(max(p / bs, 0), bpr - 1)];
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
  if (!in) return;
  const size_t dst = ((size_t)bid * bs + off) * units + u;
  k_pool[dst] = kv;
  v_pool[dst] = vv;
}

template <typename T>
int launch(void* k_pool, void* v_pool, const void* k_new, const void* v_new,
           const int* tables, const int* lens, const int* n_valid, int B,
           int C, int units, int bs, int bpr, int scratch,
           cudaStream_t stream) {
  const dim3 grid(B * C, (units + kThreads - 1) / kThreads);
  paged_append_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<T*>(k_pool), static_cast<T*>(v_pool),
      static_cast<const T*>(k_new), static_cast<const T*>(v_new), tables,
      lens, n_valid, B, C, units, bs, bpr, scratch);
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
  if (dtype != 0 && dtype != 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0)
    return launch<float>(k_pool, v_pool, k_new, v_new, tb, ln, nv, B, C, KD,
                         bs, bpr, scratch, s);
  return launch<__nv_bfloat16>(k_pool, v_pool, k_new, v_new, tb, ln, nv, B,
                               C, KD, bs, bpr, scratch, s);
}
