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
// What bounds it on this card: bytes.  Each KV block of the row is read once
// per KV head and used for H / K query heads, about 2 flops a byte at MHA,
// far under the ~295 flops a byte where an H100 turns compute bound.  So the
// design keeps bytes in flight: a row's table is split over blocks, a fixed
// number of pool blocks each (decode_tile.cuh's Shape), so that its positions
// spread over the SMs; lanes load 16-byte vectors, and each lane group keeps
// its next chunk's loads in flight.  A block reads its split's table entries
// once, at its start, beside cache_len (the TPU kernel's scalar prefetch); it
// reads K/V only from pool blocks that hold a valid position: blocks past
// cache_len and wholly before the window are masked in the TPU kernel's walk
// and never read here, which yields the same result; a stale cache_len past
// the table stays clipped to it.  The splits merge in split order in the last
// block to finish, in one launch, so a row's result depends neither on the
// other rows, nor on bpr past its last valid block, nor on the launch; the
// arithmetic is decode_tile.cuh, shared with the dense decode_attention.cu,
// so the two agree bit for bit at tile = bs.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "decode_tile.cuh"

namespace {

// A split's positions: rows through the table entries in shared memory,
// validity from the position itself.
struct PagedRows {
  const int* tb;                  // pool rows of the split's blocks
  int bs, p0, n_pos, len, window; // first position, positions in the table
  size_t tok_stride, head;        // one token of a block; this KV head
  __device__ __forceinline__ bool valid(int j) const {
    return j < n_pos && decode_tile::position_valid(p0 + j, len, window);
  }
  __device__ __forceinline__ size_t offset(int j) const {
    const int blk = j / bs;
    return ((size_t)tb[blk] * bs + (j - blk * bs)) * tok_stride + head;
  }
};

template <typename T, int NV, int GC>
__global__ void __launch_bounds__(decode_tile::Shape<NV, GC>::kThreads,
                                  decode_tile::Shape<NV, GC>::kMinBlocks)
paged_decode_kernel(const T* __restrict__ q, const T* __restrict__ k_pool,
                    const T* __restrict__ v_pool,
                    const int* __restrict__ tables,
                    const int* __restrict__ cache_len, T* __restrict__ out,
                    float* __restrict__ scratch, int* __restrict__ counters,
                    int H, int K, int D, int bs, int bpr, int window,
                    float scale, int aligned) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  constexpr int S = decode_tile::Shape<NV, GC>::kSplitTiles;
  const decode_tile::Where w = decode_tile::where<GC>(H, K);
  const int P = S * bs;
  const int p0 = w.split * P;
  const int len = cache_len[w.b];
  // valid positions of the split: [lo, hi], clipped to the table
  const int n_pos = min(P, bpr * bs - p0);
  const int lo = max(p0, window > 0 ? len - window + 1 : 0);
  const int hi = min(len, p0 + n_pos - 1);
  const bool any = lo <= hi;
  int* tb = reinterpret_cast<int*>(smem
                                   + decode_tile::state_floats<T, NV, GC>(D));
  if (threadIdx.x < S) {              // read beside cache_len, not after
    const int i = p0 / bs + threadIdx.x;        // logical block
    tb[threadIdx.x] = i < bpr ? tables[(size_t)w.b * bpr + i] : 0;
  }
  __syncthreads();
  const PagedRows rows{tb, bs, p0, n_pos, len, window, (size_t)K * D,
                       (size_t)w.kh * D};
  decode_tile::run_split<T, NV, GC>(rows, any, w, q, k_pool, v_pool, out,
                                    scratch, counters, H, D, P, scale,
                                    aligned != 0, smem);
}

template <typename T>
int launch(const void* q, const void* k_pool, const void* v_pool,
           const int* tables, const int* cache_len, void* out,
           float* scratch, int* counters, int B, int H, int K, int D, int bs,
           int bpr, int window, float scale, int aligned,
           cudaStream_t stream) {
  return decode_tile::dispatch<T>(D, H / K, [&](auto nv, auto gc) {
    constexpr int NV = decltype(nv)::value;
    constexpr int GC = decltype(gc)::value;
    constexpr int kThreads = decode_tile::Shape<NV, GC>::kThreads;
    constexpr int S = decode_tile::Shape<NV, GC>::kSplitTiles;
    const size_t shmem =
        sizeof(float) * decode_tile::state_floats<T, NV, GC>(D)
        + sizeof(int) * S;
    cudaError_t err = decode_tile::allow_smem(paged_decode_kernel<T, NV, GC>,
                                              shmem);
    if (err != cudaSuccess) return static_cast<int>(err);
    const dim3 grid((bpr + S - 1) / S, K * ((H / K + GC - 1) / GC), B);
    paged_decode_kernel<T, NV, GC><<<grid, kThreads, shmem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k_pool),
        static_cast<const T*>(v_pool), tables, cache_len,
        static_cast<T*>(out), scratch, counters, H, K, D, bs, bpr, window,
        scale, aligned);
    return static_cast<int>(cudaGetLastError());
  });
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. scratch: B * H * n * (D + 2) floats for n
// = decode_splits(D, H / K, dtype, bpr) > 1 (else unused); counters: B * H
// ints, zero, and zero again after the launch.  aligned: q and the pools on
// 16 bytes and D a multiple of 16 bytes.  Returns cudaGetLastError() after
// the launch (0 on success). Allocates nothing; runs on `stream`.
extern "C" int paged_decode_attention(
    const void* q, const void* k_pool, const void* v_pool,
    const void* tables, const void* cache_len, void* out, void* scratch,
    void* counters, int B, int H, int K, int D, int bs, int bpr, int window,
    float scale, int dtype, int aligned, void* stream) {
  const int* tb = static_cast<const int*>(tables);
  const int* ln = static_cast<const int*>(cache_len);
  float* sc = static_cast<float*>(scratch);
  int* cn = static_cast<int*>(counters);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(q, k_pool, v_pool, tb, ln, out, sc, cn, B, H, K, D,
                         bs, bpr, window, scale, aligned, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k_pool, v_pool, tb, ln, out, sc, cn, B,
                                 H, K, D, bs, bpr, window, scale, aligned, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
