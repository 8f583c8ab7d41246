// Flash-decode split over positions: the arithmetic shared by the paged
// and the dense decode-attention kernels (paged_decode_attention.cu and
// decode_attention.cu).
//
// Both kernels run one thread block per (row, KV head, split): a split is
// a fixed number of tiles of positions (Shape::kSplitTiles; pool blocks on
// the paged side, `tile` slots on the dense side), P = kSplitTiles * tile
// positions.  A block
// serves up to GC query heads of the KV head's group (G = H / K; a larger
// group takes ceil(G / GC) blocks) and keeps the online-softmax state in
// fp32.  The two kernels differ only in where a position's K/V row lies
// (a block-table lookup, a stride) and how it is known to be attended;
// everything below is this one header, which is what makes the two
// bit-identical on the same K/V with the same tile size.
//
// Inside a split (no block-wide barrier until its end):
//   lanes  — kLanes lanes share a K/V row and load it as 16-byte vectors
//            (8 bf16 or 4 fp32; element by element off 16-byte alignment),
//            each lane NV vectors; a warp holds 32 / kLanes such groups;
//   chunks — the split's positions in chunks of U; group i of the block
//            folds chunks i, i + groups, i + 2 groups, ... in order, the
//            next one's loads in flight (register ping-pong) while the
//            current one computes;
//   score  — per (head, position) a fixed-order FMA chain over the lane's
//            elements, then a butterfly (xor) tree over the group's lanes,
//            which leaves the same bits in every lane;
//   state  — per (group, head): m, l and the accumulator in registers;
//            per chunk the max over its attended scores, one rescale, the
//            weights in position order;
//   merge  — the groups' states through shared memory once, in group
//            order: M = max m_i, L = sum l_i e^(m_i - M), same for acc.
// Across splits: with one split the block writes the output; otherwise it
// writes (M, L, acc) to scratch, and the last block of the (row, head
// chunk) to arrive — an arrival counter picks it, never the order —
// merges all splits in split order, the same way, and resets the counter.
//
// Exactness: a position that is not attended is never loaded; its weight
// is 0 and its row 0, so it adds an exact 0, and a chunk, group or split
// with none attended leaves the state exactly as it was (m = -1e30, l = 0,
// acc = 0 when empty).  The reduction order of a row therefore depends
// only on P and on its own attended positions: not on the other rows, on
// T or bpr past the last attended position, or on which block finishes
// last.  A row with no attended position at all gets 0.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

namespace decode_tile {

constexpr float kNegInf = -1e30f;
constexpr unsigned kFull = 0xffffffffu;

// 16-byte vectors of T: elements in one, lanes that share a K/V row.
template <typename T> struct Vec;

template <> struct Vec<float> {
  static constexpr int kElems = 4;
  static constexpr int kLanes = 32;
  static __device__ __forceinline__ void unpack(const uint4& r,
                                                float (&f)[kElems]) {
    f[0] = __uint_as_float(r.x);
    f[1] = __uint_as_float(r.y);
    f[2] = __uint_as_float(r.z);
    f[3] = __uint_as_float(r.w);
  }
  // elements [0, n) from p one by one, zeros after
  static __device__ __forceinline__ uint4 load_elems(const float* p,
                                                     int n) {
    uint4 r = make_uint4(0u, 0u, 0u, 0u);
    if (n > 0) r.x = __float_as_uint(p[0]);
    if (n > 1) r.y = __float_as_uint(p[1]);
    if (n > 2) r.z = __float_as_uint(p[2]);
    if (n > 3) r.w = __float_as_uint(p[3]);
    return r;
  }
};

template <> struct Vec<__nv_bfloat16> {
  static constexpr int kElems = 8;
  static constexpr int kLanes = 16;
  // bf16 -> fp32 is the 16 bits moved up: exact
  static __device__ __forceinline__ void unpack(const uint4& r,
                                                float (&f)[kElems]) {
    const unsigned w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      f[2 * i] = __uint_as_float(w[i] << 16);
      f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
  static __device__ __forceinline__ uint4 load_elems(
      const __nv_bfloat16* p, int n) {
    const unsigned short* u = reinterpret_cast<const unsigned short*>(p);
    unsigned w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
    for (int i = 0; i < kElems; ++i)
      if (i < n) w[i / 2] |= static_cast<unsigned>(u[i]) << (16 * (i % 2));
    return make_uint4(w[0], w[1], w[2], w[3]);
  }
};

template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Elements [e0, e0 + kElems) of a row of D: one 16-byte load when the
// operands are aligned and the vector lies inside the row, else element
// by element (zeros past D).
template <typename T>
__device__ __forceinline__ uint4 load_vec(const T* __restrict__ row, int e0,
                                          int D, bool aligned) {
  if (aligned && e0 + Vec<T>::kElems <= D)
    return __ldg(reinterpret_cast<const uint4*>(row + e0));
  return Vec<T>::load_elems(row + e0, D - e0);
}

// Absolute position `pos` is attended by a query at position `len` iff
// 0 <= pos <= len and, with a window w > 0, pos > len - w.
__device__ __forceinline__ bool position_valid(int pos, int len,
                                               int window) {
  bool valid = pos >= 0 && pos <= len;
  if (window > 0) valid = valid && pos > len - window;
  return valid;
}

// Query heads a block serves: G rounded up to a power of two, at most
// `most`.
inline int heads_per_block(int G, int most) {
  int gc = 1;
  while (gc < G && gc < most) gc *= 2;
  return gc;
}

// The launch shape for NV vectors a lane and GC heads a block, the same
// for both kernels (chosen by benchmarks/torch_kernel_variants.py): tiles
// a split; warps a block; positions a lane group folds at once, fewer as
// the registers a position (NV) and the heads (GC) grow; blocks an SM the
// registers are capped for (65536 / (threads x blocks) a thread).  One
// head a block (MHA) takes shorter splits, wider blocks and shorter
// chunks, so that more lane groups share a short row's positions.
template <int NV, int GC>
struct Shape {
  static constexpr bool kOneHead = NV == 1 && GC == 1;
  static constexpr int kSplitTiles = kOneHead ? 16 : 32;
  static constexpr int kRegs = NV * (GC > 2 ? GC / 2 : 1);
  static constexpr int kWarps = kOneHead ? 8 : 4;
  static constexpr int kThreads = 32 * kWarps;
  static constexpr int kChunk = kOneHead ? 2 : kRegs >= 4 ? 1 : 4 / kRegs;
  static constexpr int kMinBlocks = kOneHead ? 3 : NV == 1 && GC <= 4 ? 4
                                                                      : 2;
  static_assert(kSplitTiles <= kThreads, "one thread per table entry");
};

// Shared memory of the groups' states: m, l (groups x GC) and acc
// (groups x GC x D), floats.  A kernel puts its own prologue data after.
template <typename T, int NV, int GC>
__host__ __device__ inline size_t state_floats(int D) {
  return (size_t)(Shape<NV, GC>::kThreads / Vec<T>::kLanes) * GC * (D + 2);
}

// Calls f(NV, GC) as integral constants for head dim D and group G:
// NV vectors a lane, GC heads a block.  D up to 2 * kLanes vectors.
template <int N> using Int = std::integral_constant<int, N>;
template <typename T, typename F>
inline int dispatch(int D, int G, F f) {
  const int nvec = (D + Vec<T>::kElems - 1) / Vec<T>::kElems;
  if (nvec <= Vec<T>::kLanes) {
    const int gc = heads_per_block(G, 8);
    if (gc == 1) return f(Int<1>(), Int<1>());
    if (gc == 2) return f(Int<1>(), Int<2>());
    if (gc == 4) return f(Int<1>(), Int<4>());
    return f(Int<1>(), Int<8>());
  }
  if (nvec <= 2 * Vec<T>::kLanes) {
    const int gc = heads_per_block(G, 4);
    if (gc == 1) return f(Int<2>(), Int<1>());
    if (gc == 2) return f(Int<2>(), Int<2>());
    return f(Int<2>(), Int<4>());
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// Which (row, heads, split) a block serves.  Grid: (splits, K * head
// chunks, B).
struct Where {
  int b, kh, h0, gn;      // row, KV head, first query head, heads served
  int split, n_split;
  int counter;            // arrival counter of this (row, head chunk)
};

template <int GC>
__device__ __forceinline__ Where where(int H, int K) {
  Where w;
  const int G = H / K;
  const int n_hc = (G + GC - 1) / GC;
  w.split = blockIdx.x;
  w.n_split = gridDim.x;
  w.kh = blockIdx.y / n_hc;
  const int hc = blockIdx.y - w.kh * n_hc;
  w.b = blockIdx.z;
  w.h0 = w.kh * G + hc * GC;
  w.gn = min(GC, G - hc * GC);
  w.counter = blockIdx.z * gridDim.y + blockIdx.y;
  return w;
}

template <int NV, int GC, int E>
struct Heads {
  float q[GC][NV][E];     // this lane's elements, scaled
  float acc[GC][NV][E];
  float m[GC], l[GC];
};

template <int NV, int U>
struct Chunk {
  uint4 k[U][NV], v[U][NV];
  bool ok[U];
};

// Positions [j0, j0 + U) of the split, those before `j_end` that are
// attended; the rest stay zero and are never loaded.
template <typename T, int NV, int U, typename Rows>
__device__ __forceinline__ void load_chunk(Chunk<NV, U>& c, const Rows& rows,
                                           const T* __restrict__ k,
                                           const T* __restrict__ v, int j0,
                                           int j_end, int lg, int D,
                                           bool aligned) {
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int j = j0 + u;
    c.ok[u] = j < j_end && rows.valid(j);
#pragma unroll
    for (int n = 0; n < NV; ++n) {
      c.k[u][n] = make_uint4(0u, 0u, 0u, 0u);
      c.v[u][n] = make_uint4(0u, 0u, 0u, 0u);
    }
    if (c.ok[u]) {
      const size_t off = rows.offset(j);
#pragma unroll
      for (int n = 0; n < NV; ++n) {
        const int e0 = (lg + n * Vec<T>::kLanes) * Vec<T>::kElems;
        c.k[u][n] = load_vec(k + off, e0, D, aligned);
        c.v[u][n] = load_vec(v + off, e0, D, aligned);
      }
    }
  }
}

// Fold one chunk into the group's state.  Called by every lane of the
// warp (the shuffles need all 32); a chunk that no lane of the warp
// attends changes nothing and is skipped.
template <typename T, int NV, int GC, int U>
__device__ __forceinline__ void fold_chunk(
    Heads<NV, GC, Vec<T>::kElems>& h, const Chunk<NV, U>& c) {
  constexpr int E = Vec<T>::kElems;
  bool any = false;
#pragma unroll
  for (int u = 0; u < U; ++u) any = any || c.ok[u];
  if (!__any_sync(kFull, any)) return;
  float s[GC][U];
#pragma unroll
  for (int u = 0; u < U; ++u) {
    float kf[NV][E];
#pragma unroll
    for (int n = 0; n < NV; ++n) Vec<T>::unpack(c.k[u][n], kf[n]);
#pragma unroll
    for (int g = 0; g < GC; ++g) {
      float a = 0.f;
#pragma unroll
      for (int n = 0; n < NV; ++n)
#pragma unroll
        for (int e = 0; e < E; ++e) a = fmaf(h.q[g][n][e], kf[n][e], a);
      s[g][u] = a;
    }
  }
#pragma unroll
  for (int g = 0; g < GC; ++g)
#pragma unroll
    for (int u = 0; u < U; ++u)
#pragma unroll
      for (int o = Vec<T>::kLanes / 2; o > 0; o >>= 1)
        s[g][u] += __shfl_xor_sync(kFull, s[g][u], o);
#pragma unroll
  for (int g = 0; g < GC; ++g) {
    float mx = h.m[g];
#pragma unroll
    for (int u = 0; u < U; ++u)
      if (c.ok[u]) mx = fmaxf(mx, s[g][u]);
    const float alpha = expf(h.m[g] - mx);
    float psum = 0.f;
#pragma unroll
    for (int u = 0; u < U; ++u) {
      s[g][u] = c.ok[u] ? expf(s[g][u] - mx) : 0.f;    // now the weight
      psum += s[g][u];
    }
    h.l[g] = fmaf(h.l[g], alpha, psum);
    h.m[g] = mx;
#pragma unroll
    for (int n = 0; n < NV; ++n)
#pragma unroll
      for (int e = 0; e < E; ++e)
        h.acc[g][n][e] = __fmul_rn(h.acc[g][n][e], alpha);
  }
#pragma unroll
  for (int u = 0; u < U; ++u) {
    float vf[NV][E];
#pragma unroll
    for (int n = 0; n < NV; ++n) Vec<T>::unpack(c.v[u][n], vf[n]);
#pragma unroll
    for (int g = 0; g < GC; ++g)
#pragma unroll
      for (int n = 0; n < NV; ++n)
#pragma unroll
        for (int e = 0; e < E; ++e)
          h.acc[g][n][e] = fmaf(s[g][u], vf[n][e], h.acc[g][n][e]);
  }
}

// The states (m, l, acc) of `n` parts merged in part order: M = max m_i,
// L = sum l_i e^(m_i - M), A = sum acc_i e^(m_i - M).  An empty part
// (m = -1e30, l = 0, acc = 0) adds an exact 0.  m(i), l(i), acc(i) read
// part i.
template <typename M, typename L, typename A>
__device__ __forceinline__ void merge(int n, M m, L l, A acc, float& out_m,
                                      float& out_l, float& out_a) {
  float mx = kNegInf;
#pragma unroll 16
  for (int i = 0; i < n; ++i) mx = fmaxf(mx, m(i));
  float sl = 0.f, sa = 0.f;
#pragma unroll 16
  for (int i = 0; i < n; ++i) {
    const float w = expf(m(i) - mx);
    sl = fmaf(l(i), w, sl);
    sa = fmaf(acc(i), w, sa);
  }
  out_m = mx;
  out_l = sl;
  out_a = sa;
}

// out = acc / max(l, 1e-30), in the output type.
template <typename T>
__device__ __forceinline__ T finish(float a, float l) {
  return from_float<T>(a / fmaxf(l, 1e-30f));
}

// One block's split: fold its attended positions (none when `any` is
// false), merge the groups, then write the output (one split) or the
// split's state, and let the last block of the (row, head chunk) merge
// the splits.  Rows: valid(j) and offset(j) (element offset of position
// j's K/V row) for j < P.  `smem` holds state_floats<T, NV, GC>(D) floats.
// scratch: (B H n_split) x 2 floats of (m, l), then (B H n_split) x D of
// acc; counters: one int per (row, head chunk), 0 between launches.
template <typename T, int NV, int GC, typename Rows>
__device__ __forceinline__ void run_split(
    const Rows& rows, bool any, const Where& w, const T* __restrict__ q,
    const T* __restrict__ k, const T* __restrict__ v, T* __restrict__ out,
    float* __restrict__ scratch, int* __restrict__ counters, int H, int D,
    int P, float scale, bool aligned, float* smem) {
  constexpr int E = Vec<T>::kElems;
  constexpr int kLanes = Vec<T>::kLanes;
  constexpr int NG = Shape<NV, GC>::kThreads / kLanes;   // lane groups
  constexpr int U = Shape<NV, GC>::kChunk;
  const int lg = threadIdx.x % kLanes;
  const int grp = threadIdx.x / kLanes;
  float* m_s = smem;                            // (NG, GC)
  float* l_s = m_s + NG * GC;                   // (NG, GC)
  float* a_s = l_s + NG * GC;                   // (NG, GC, D)
  const T* qh = q + (size_t)((size_t)w.b * H + w.h0) * D;

  if (any) {
    Heads<NV, GC, E> h;
#pragma unroll
    for (int g = 0; g < GC; ++g) {
#pragma unroll
      for (int n = 0; n < NV; ++n) {
        const int e0 = (lg + n * kLanes) * E;
        float f[E];
        Vec<T>::unpack(g < w.gn ? load_vec(qh + (size_t)g * D, e0, D, aligned)
                                : make_uint4(0u, 0u, 0u, 0u), f);
#pragma unroll
        for (int e = 0; e < E; ++e) {
          h.q[g][n][e] = __fmul_rn(f[e], scale);
          h.acc[g][n][e] = 0.f;
        }
      }
      h.m[g] = kNegInf;
      h.l[g] = 0.f;
    }
    // group grp folds chunks grp, grp + NG, ... of U positions
    const int stride = U * NG;
    const int j0 = grp * U;
    const int n_chunks = (P + stride - 1) / stride;   // the same for all
    Chunk<NV, U> a, b;
    load_chunk<T>(a, rows, k, v, j0, P, lg, D, aligned);
#pragma unroll 1
    for (int c = 0; c < n_chunks; c += 2) {
      if (c + 1 < n_chunks)
        load_chunk<T>(b, rows, k, v, j0 + (c + 1) * stride, P, lg, D,
                      aligned);
      fold_chunk<T>(h, a);
      if (c + 2 < n_chunks)
        load_chunk<T>(a, rows, k, v, j0 + (c + 2) * stride, P, lg, D,
                      aligned);
      if (c + 1 < n_chunks) fold_chunk<T>(h, b);
    }
#pragma unroll
    for (int g = 0; g < GC; ++g) {
      if (lg == 0) {
        m_s[grp * GC + g] = h.m[g];
        l_s[grp * GC + g] = h.l[g];
      }
#pragma unroll
      for (int n = 0; n < NV; ++n)
#pragma unroll
        for (int e = 0; e < E; ++e) {
          const int d = (lg + n * kLanes) * E + e;
          if (d < D) a_s[(size_t)(grp * GC + g) * D + d] = h.acc[g][n][e];
        }
    }
  }
  __syncthreads();

  const size_t bh0 = (size_t)w.b * H + w.h0;
  const size_t n_rows = (size_t)gridDim.z * H * w.n_split;
  float* ml = scratch;                          // (B H n_split, 2)
  float* acc = scratch + 2 * n_rows;            // (B H n_split, D)
  for (int j = threadIdx.x; j < w.gn * D; j += blockDim.x) {
    const int g = j / D;
    const int d = j - g * D;
    float M = kNegInf, L = 0.f, A = 0.f;
    if (any)
      merge(
          NG, [&](int i) { return m_s[i * GC + g]; },
          [&](int i) { return l_s[i * GC + g]; },
          [&](int i) { return a_s[(size_t)(i * GC + g) * D + d]; }, M, L,
          A);
    if (w.n_split == 1) {
      out[(bh0 + g) * D + d] = finish<T>(A, L);
    } else {
      const size_t slot = (bh0 + g) * w.n_split + w.split;
      if (d == 0) {
        ml[2 * slot] = M;
        ml[2 * slot + 1] = L;
      }
      acc[slot * D + d] = A;
    }
  }
  if (w.n_split == 1) return;

  // the last block of this (row, head chunk) to arrive merges the splits
  __shared__ int last;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    last = atomicAdd(counters + w.counter, 1) == w.n_split - 1;
    if (last) counters[w.counter] = 0;          // ready for the next launch
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  for (int j = threadIdx.x; j < w.gn * D; j += blockDim.x) {
    const int g = j / D;
    const int d = j - g * D;
    const float* mlh = ml + 2 * (bh0 + g) * w.n_split;
    const float* ah = acc + (bh0 + g) * w.n_split * D + d;
    float M, L, A;
    merge(
        w.n_split, [&](int i) { return __ldcg(mlh + 2 * i); },
        [&](int i) { return __ldcg(mlh + 2 * i + 1); },
        [&](int i) { return __ldcg(ah + (size_t)i * D); }, M, L, A);
    out[(bh0 + g) * D + d] = finish<T>(A, L);
  }
}

// Allow more than the default 48 KB of dynamic shared memory when needed.
template <typename Kernel>
inline cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

}  // namespace decode_tile

// Splits of a row of n_tiles tiles at head dim D, G query heads per KV
// head and dtype (0 = float32, 1 = bfloat16), for the wrappers' scratch.
extern "C" int decode_splits(int D, int G, int dtype, int n_tiles) {
  const auto splits = [&](auto nv, auto gc) {
    constexpr int S = decode_tile::Shape<decltype(nv)::value,
                                         decltype(gc)::value>::kSplitTiles;
    return (n_tiles + S - 1) / S;
  };
  if (dtype == 0) return decode_tile::dispatch<float>(D, G, splits);
  return decode_tile::dispatch<__nv_bfloat16>(D, G, splits);
}
