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
// What bounds it on this card: bytes.  Every valid K/V row is read once per
// KV head and serves the H / K query heads of its group (about 2 flops a byte
// at MHA, 8 at GQA 32/8, far under the ~295 flops a byte where an H100 turns
// compute bound), so the design keeps bytes in flight: the slots are split
// over blocks, a fixed number of tiles of `tile` slots each
// (decode_tile.cuh's Shape), so that a row's positions spread over the SMs;
// lanes load 16-byte vectors, and each lane group keeps its next chunk's
// loads in flight.  A block first reads its split's `pos` entries into shared
// memory; a split with no valid slot (past cache_len, before the window,
// empty, or past T) reads no K/V, and neither does an invalid slot inside a
// split, so the K/V bytes read are the valid ones.  The splits merge in split
// order in the last block to finish, in one launch.  The arithmetic is
// decode_tile.cuh, the same code as the paged kernel's: with pos = arange(T)
// and tile equal to the pool's block size, a row splits into the same
// positions in the same order and the result is bit-identical to
// paged_decode_attention on the same K/V. The result of a row does not depend
// on T past its last valid slot.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "decode_tile.cuh"

namespace {

// A split's slots: valid flags in shared memory, rows by stride.
struct DenseRows {
  const unsigned char* ok;        // (P,) slot attended
  size_t base, st;                // element offset of the split's first slot
  __device__ __forceinline__ bool valid(int j) const { return ok[j] != 0; }
  __device__ __forceinline__ size_t offset(int j) const {
    return base + (size_t)j * st;
  }
};

template <typename T, int NV, int GC>
__global__ void __launch_bounds__(decode_tile::Shape<NV, GC>::kThreads,
                                  decode_tile::Shape<NV, GC>::kMinBlocks)
dense_decode_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const int* __restrict__ pos,
                    const int* __restrict__ cache_len, T* __restrict__ out,
                    float* __restrict__ scratch, int* __restrict__ counters,
                    int H, int K, int D, int n_slots, int tile, long long sb,
                    long long sk, long long st, int window, float scale,
                    int aligned) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const decode_tile::Where w = decode_tile::where<GC>(H, K);
  const int P = decode_tile::Shape<NV, GC>::kSplitTiles * tile;
  const int s0 = w.split * P;
  unsigned char* ok = reinterpret_cast<unsigned char*>(
      smem + decode_tile::state_floats<T, NV, GC>(D));
  const int len = cache_len[w.b];
  int any = 0;
  for (int j = threadIdx.x; j < P; j += blockDim.x) {
    const int slot = s0 + j;
    const bool valid = slot < n_slots
        && decode_tile::position_valid(pos[slot], len, window);
    ok[j] = valid;
    any |= valid;
  }
  any = __syncthreads_or(any);
  const DenseRows rows{ok,
                       (size_t)w.b * sb + (size_t)w.kh * sk
                           + (size_t)s0 * st,
                       (size_t)st};
  decode_tile::run_split<T, NV, GC>(rows, any != 0, w, q, k, v, out,
                                    scratch, counters, H, D, P, scale,
                                    aligned != 0, smem);
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const int* pos,
           const int* cache_len, void* out, float* scratch, int* counters,
           int B, int H, int K, int D, int n_slots, int tile, long long sb,
           long long sk, long long st, int window, float scale, int aligned,
           cudaStream_t stream) {
  return decode_tile::dispatch<T>(D, H / K, [&](auto nv, auto gc) {
    constexpr int NV = decltype(nv)::value;
    constexpr int GC = decltype(gc)::value;
    constexpr int kThreads = decode_tile::Shape<NV, GC>::kThreads;
    const int P = decode_tile::Shape<NV, GC>::kSplitTiles * tile;
    const size_t shmem =
        sizeof(float) * decode_tile::state_floats<T, NV, GC>(D) + P;
    cudaError_t err = decode_tile::allow_smem(dense_decode_kernel<T, NV, GC>,
                                              shmem);
    if (err != cudaSuccess) return static_cast<int>(err);
    const dim3 grid((n_slots + P - 1) / P, K * ((H / K + GC - 1) / GC), B);
    dense_decode_kernel<T, NV, GC><<<grid, kThreads, shmem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), pos, cache_len, static_cast<T*>(out),
        scratch, counters, H, K, D, n_slots, tile, sb, sk, st, window, scale,
        aligned);
    return static_cast<int>(cudaGetLastError());
  });
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  k and v share the element strides
// (sb, sk, st).  scratch: B * H * n * (D + 2) floats for n =
// decode_splits(D, H / K, dtype, ceil(T / tile)) > 1 (else unused);
// counters: B * H ints, zero, and zero again after the launch.  aligned:
// q, k, v and the strides on 16 bytes.  Returns cudaGetLastError() after the
// launch (0 on success).  Allocates nothing; runs on `stream`.
extern "C" int decode_attention(
    const void* q, const void* k, const void* v, const void* pos,
    const void* cache_len, void* out, void* scratch, void* counters, int B,
    int H, int K, int D, int T, int tile, long long sb, long long sk,
    long long st, int window, float scale, int dtype, int aligned,
    void* stream) {
  const int* ps = static_cast<const int*>(pos);
  const int* ln = static_cast<const int*>(cache_len);
  float* sc = static_cast<float*>(scratch);
  int* cn = static_cast<int*>(counters);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(q, k, v, ps, ln, out, sc, cn, B, H, K, D, T, tile,
                         sb, sk, st, window, scale, aligned, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k, v, ps, ln, out, sc, cn, B, H, K, D,
                                 T, tile, sb, sk, st, window, scale, aligned,
                                 s);
  return static_cast<int>(cudaErrorInvalidValue);
}
