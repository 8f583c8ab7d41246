// Chunked Mamba-2 SSD scan for Hopper (sm_90a), from a zero start state.
//
// Replaces: src/repro/kernels/ssd_scan/ssd_scan.py, ssd_scan (the Pallas
//   kernel _kernel) with its layout wrapper ops.py:ssd_scan_op.
//
// Contract (the TPU kernel's function, in the models' layout):
//   x (b, S, H, P), dt (b, S, H), B and C (b, S, G, N), all fp32 and read
//   through element strides with unit stride over the last axis; A (H,)
//   fp32 contiguous (negative); y (b, S, H, P) fp32 contiguous.  Head h
//   reads group h / (H / G) of B and C — the group broadcast is a stride,
//   not a copy.  The sequence is walked in nc = S / L chunks of length L
//   (any L >= 1 that divides S, L = S included); N <= 128.  Per (batch,
//   head), with a (P, N) state h that starts at 0:
//     cs     = cumsum(dt * a) within the chunk (inclusive)
//     y_i    = sum_{j <= i} (C_i . B_j) exp(cs_i - cs_j) x_j dt_j
//              + exp(cs_i) C_i . h
//     h     <- exp(cs_{L-1}) h + sum_j (x_j dt_j) (B_j exp(cs_{L-1} - cs_j))^T
//   The exponential is taken only for j <= i: above the diagonal
//   cs_i - cs_j > 0 may overflow, and inf * 0 would be NaN.
//
// What bounds it on this card: operations.  At the prefill shape (b = 2,
// H = 32, S = 2048, L = 256, P = 64, N = 128) the chunked algorithm does
// about 6.1 GFLOP of fp32 here (C.B^T once per group, not per head)
// against ~90 MB of traffic, scratch included, so the CUDA cores' fp32
// rate bounds it (67 TFLOP/s on an H100 SXM by its data sheet; TF32
// tensor cores would round past the 2e-4 tolerance).  At jamba's N = 16
// the bytes do (x read twice and y written, ~400 MB).
//
// Design: Mamba-2's own chunk-parallel split, in four launches.  The TPU
// grid carries the state from chunk to chunk in VMEM; here that carry is
// a short pass of its own over the chunk states, and everything else runs
// with a block per chunk.
//   1. ssd_scan_chunk_state: a block per (chunk x head-dim tile, head,
//      batch) computes the chunk's cumsum (written to a (b, H, S) scratch)
//      and the chunk's own state sum_j (x_j dt_j w_j) B_j^T, w_j =
//      exp(cs_{L-1} - cs_j), into slot c of a (b, nc, H, N, P) scratch (the
//      last chunk's state is never needed), its x and B tiles coming
//      through a two-stage cp.async ring.
//   2. ssd_scan_state_pass: h <- exp(cs_{L-1}) h + state_c in chunk order,
//      per (batch, head, element), leaving in slot c the state before
//      chunk c (zero for c = 0); eight chunks' loads in flight at once.
//      A launch of its own: run instead by the last chunk-state block of
//      each (batch, head) to arrive, it was slower at every shape timed
//      (benchmarks/torch_kernel_variants.py).
//   3. ssd_scan_chunk_scores: C_i . B_j does not depend on the head, so a
//      block per (64 x 64 tile on or below the diagonal, chunk, batch x
//      group) computes it once for the H / G heads of a group (32 at
//      mamba2-370m), into a scratch of the lower-triangle tiles.
//   4. ssd_scan_chunk_out: a block per (64-row query tile, 64-column
//      head-dim tile, chunk, head, batch), the tiles with the most key
//      tiles launched first.  It reads the carried state in, exp(cs_i)
//      C_i . h, over slices of 64 d_state columns of C and the state,
//      then walks the key tiles up to the diagonal: each score tile is
//      decayed by exp(cs_i - cs_j) and masked in place, then multiplied
//      with the x dt tile.  Every step's operands come through a
//      two-stage cp.async ring, so the next step's loads overlap this
//      step's arithmetic; ~71 KB of shared memory and at most 85
//      registers a thread let three blocks share an SM.
// Everything is fp32 FMA on the CUDA cores, each output, score and state
// one FMA chain in a fixed order (ascending n, ascending j), no atomics on
// data.  The within-chunk cumsum is a block-wide prefix scan (segments
// per thread, then warp shuffles), whose order differs from jnp.cumsum, so
// results agree with the JAX kernel to the 2e-4 tolerance of its tests,
// not bit for bit; reruns, one batch row alone and a prefix of whole
// chunks give the same bits (a chunk reads only earlier chunks), and so
// does every choice above (ring depth, tile heights, slices, pass).

#include <cuda_pipeline.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int TQ = 64;             // query rows per output block
constexpr int TK = 64;             // key rows per tile
constexpr int PT = 64;             // head-dim columns per block
constexpr int NS = 64;             // d_state columns per ring stage
constexpr int kStages = 2;         // ring stages: kStages - 1 loads ahead
constexpr int TJ = 64;             // positions per tile of the state kernel
constexpr int kMaxN = 128;         // d_state: 8 n per thread in the state
constexpr int RT = TQ / 16;        // query rows per thread
constexpr int LDS = TK + 4;        // score rows, in floats
constexpr int LDX = PT + 4;        // x tile and state rows, in floats
constexpr int kPassBatch = 8;      // chunks in flight per thread in the pass
constexpr int kMinBlocks = 3;      // output blocks an SM (registers <= 85)

static_assert(kThreads == 256 && PT == 64 && TK == 64 && TJ == 64,
              "thread maps below");
static_assert(TQ % 16 == 0 && TK % TQ == 0 && NS % 4 == 0, "tile shapes");
static_assert(kStages >= 1 && kStages <= 3, "ring depth");

struct Args {
  const float* x;
  const float* dt;
  const float* A;
  const float* B;
  const float* C;
  float* y;
  float* cs;          // (b, H, S): within-chunk cumsums
  float* st;          // (b, nc, H, N, P): chunk states, then carried states
  float* cb;          // (b, nc, G, score tiles, TK, TK): C.B^T, per group
  int batch, S, H, P, G, N, L, nc, vec;
  long long sxb, sxs, sxh, sdb, sds, sdh, sbb, sbs, sbg, scb, scs, scg;
};

__host__ __device__ inline int round4(int n) { return (n + 3) & ~3; }

// ---------------------------------------------------------------------------
// 1. chunk states and the state pass
// ---------------------------------------------------------------------------

// cs[t] = sum_{k <= t} dt[t0 + k] * a for t < L: each thread scans a
// contiguous segment, then the segment totals are scanned across the block.
__device__ void chunk_cumsum(float* cs, const float* dt, long long sds,
                             int t0, int L, float a, float* warp_tot) {
  const int seg = (L + kThreads - 1) / kThreads;
  const int s0 = min(L, (int)threadIdx.x * seg);
  const int s1 = min(L, s0 + seg);
  float run = 0.f;
  for (int t = s0; t < s1; ++t) {
    run += dt[(long long)(t0 + t) * sds] * a;
    cs[t] = run;
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float inc = run;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float v = __shfl_up_sync(0xffffffffu, inc, o);
    if (lane >= o) inc += v;
  }
  if (lane == 31) warp_tot[warp] = inc;
  __syncthreads();
  float off = inc - run;
  for (int w = 0; w < warp; ++w) off += warp_tot[w];
  for (int t = s0; t < s1; ++t) cs[t] += off;
  __syncthreads();
}

// floats of dynamic shared memory of the state kernel: cs[L] (then the
// weights w), and two stages of the x tile [TJ][LDX], the B tile
// [TJ][16 MN + 4] and dt [TJ]
__host__ __device__ inline int state_stage_floats(int MN) {
  return TJ * LDX + TJ * (16 * MN + 4) + TJ;
}
__host__ __device__ inline size_t state_smem_floats(int L, int MN) {
  return (size_t)round4(L) + 2 * (size_t)state_stage_floats(MN);
}

template <typename V>
__device__ __forceinline__ V zero();
template <>
__device__ __forceinline__ float4 zero<float4>() {
  return make_float4(0.f, 0.f, 0.f, 0.f);
}
template <>
__device__ __forceinline__ float zero<float>() { return 0.f; }

__device__ __forceinline__ float4 fma4(float d, float4 h, float4 v) {
  return make_float4(d * h.x + v.x, d * h.y + v.y, d * h.z + v.z,
                     d * h.w + v.w);
}
__device__ __forceinline__ float fma4(float d, float h, float v) {
  return d * h + v;
}

// The state pass of one (batch, head) over elements e0, e0 + de, ... of a
// slot, V = float4 or float at a time: slot c <- the state before chunk c,
// h <- exp(cs_{L-1}) h + (chunk c's own state).  The loads of kPassBatch
// chunks are in flight together.
template <typename V>
__device__ void state_pass(const Args& g, int b, int h, int e0, int de) {
  constexpr int W = sizeof(V) / sizeof(float);
  const long long slot = (long long)g.H * g.N * g.P / W;
  V* st = reinterpret_cast<V*>(g.st)
      + ((long long)b * g.nc * g.H + h) * g.N * g.P / W;
  const float* cl = g.cs + ((long long)b * g.H + h) * g.S + g.L - 1;
  const int n_el = g.N * g.P / W, last = g.nc - 1;
  for (int e = e0; e < n_el; e += de) {
    V* s = st + e;
    V hv = zero<V>();
    for (int c = 0; c < last; c += kPassBatch) {
      V v[kPassBatch];
      float d[kPassBatch];
#pragma unroll
      for (int u = 0; u < kPassBatch; ++u) {
        v[u] = zero<V>();
        d[u] = 0.f;
        if (c + u < last) {
          v[u] = __ldcg(s + (c + u) * slot);
          d[u] = expf(__ldcg(cl + (long long)(c + u) * g.L));
        }
      }
#pragma unroll
      for (int u = 0; u < kPassBatch; ++u) {
        if (c + u < last) {
          s[(c + u) * slot] = hv;
          hv = fma4(d[u], hv, v[u]);
        }
      }
    }
    s[last * slot] = hv;
  }
}


// 4 consecutive floats (n valid of them) into 16 bytes of shared memory,
// zeros past n.  vec: n is 0 or 4 and src is 16-byte aligned.
__device__ __forceinline__ void copy4(float* dst, const float* src, int n,
                                      bool vec, const float* any) {
  if (vec) {
    __pipeline_memcpy_async(dst, n > 0 ? src : any, 16, n > 0 ? 0 : 16);
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e)
      __pipeline_memcpy_async(dst + e, e < n ? src + e : any, 4,
                              e < n ? 0 : 4);
  }
}

__device__ __forceinline__ void copy1(float* dst, const float* src, bool ok,
                                      const float* any) {
  __pipeline_memcpy_async(dst, ok ? src : any, 4, ok ? 0 : 4);
}

// grid (nc * head-dim tiles, H, b).  MN: d_state rows per thread (N <=
// 16 MN); a thread holds the (MN n) x (4 p) corner of the chunk's state.
// Tiles of TJ positions come through a two-stage cp.async ring; each is
// scaled in place to x dt w before its products.
template <int MN>
__global__ void __launch_bounds__(kThreads)
ssd_scan_chunk_state_kernel(Args g) {
  extern __shared__ __align__(16) float smem[];
  __shared__ float warp_tot[kThreads / 32];
  constexpr int NB = 16 * MN, LDB = NB + 4;
  const int L = g.L, N = g.N, P = g.P;
  const int npt = (P + PT - 1) / PT;
  const int c = blockIdx.x / npt;
  const int pt = blockIdx.x - c * npt;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int p0 = pt * PT;
  const int t0 = c * L;
  const int tid = threadIdx.x;
  const int grp = h / (g.H / g.G);
  const bool vec = g.vec;
  float* cs = smem;                    // cs, then w = exp(cs_{L-1} - cs)
  float* ring = cs + round4(L);        // stages: x [j][p], B [j][n], dt [j]
  const int sf = state_stage_floats(MN);
  const float* xh = g.x + b * g.sxb + h * g.sxh;
  const float* dth = g.dt + b * g.sdb + h * g.sdh;
  const float* Bg = g.B + b * g.sbb + grp * g.sbg;
  const bool has_state = c < g.nc - 1;  // the last chunk's state is unused
  const int n_tiles = (L + TJ - 1) / TJ;

  auto issue = [&](int jt) {
    float* xs = ring + (jt & 1) * sf;
    float* Bs = xs + TJ * LDX;
    float* ds = Bs + TJ * LDB;
    const int j0 = jt * TJ;
    for (int k = tid; k < TJ * (PT / 4); k += kThreads) {
      const int j = k / (PT / 4), p = (k - j * (PT / 4)) * 4;
      const int cnt = j0 + j < L ? max(0, min(4, P - p0 - p)) : 0;
      copy4(&xs[j * LDX + p], xh + (long long)(t0 + j0 + j) * g.sxs + p0 + p,
            cnt, vec, xh);
    }
    for (int k = tid; k < TJ * (NB / 4); k += kThreads) {
      const int j = k / (NB / 4), n = (k - j * (NB / 4)) * 4;
      const int cnt = j0 + j < L ? max(0, min(4, N - n)) : 0;
      copy4(&Bs[j * LDB + n], Bg + (long long)(t0 + j0 + j) * g.sbs + n, cnt,
            vec, Bg);
    }
    for (int j = tid; j < TJ; j += kThreads)
      copy1(&ds[j], dth + (long long)(t0 + j0 + j) * g.sds, j0 + j < L, dth);
  };

  if (has_state) issue(0);
  __pipeline_commit();
  chunk_cumsum(cs, dth, g.sds, t0, L, g.A[h], warp_tot);
  if (pt == 0) {
    float* csg = g.cs + ((long long)b * g.H + h) * g.S + t0;
    for (int k = tid; k < L; k += kThreads) csg[k] = cs[k];
  }

  if (has_state) {
    const float cs_last = cs[L - 1];
    __syncthreads();
    for (int k = tid; k < L; k += kThreads) cs[k] = expf(cs_last - cs[k]);
    const int tp = tid & 15, tn = tid >> 4;
    float acc[MN][4] = {};
    for (int jt = 0; jt < n_tiles; ++jt) {
      if (jt + 1 < n_tiles) issue(jt + 1);
      __pipeline_commit();
      __pipeline_wait_prior(1);
      __syncthreads();
      float* xs = ring + (jt & 1) * sf;
      const float* Bs = xs + TJ * LDX;
      const float* ds = Bs + TJ * LDB;
      const int j0 = jt * TJ;
      for (int k = tid; k < TJ * PT; k += kThreads) {
        const int j = k / PT, p = k - j * PT;
        xs[j * LDX + p] = xs[j * LDX + p] * ds[j] * cs[min(j0 + j, L - 1)];
      }
      __syncthreads();
      const int jn = min(TJ, L - j0);
      for (int j = 0; j < jn; ++j) {
        const float4 xv = *reinterpret_cast<const float4*>(
            &xs[j * LDX + tp * 4]);
        const float xc[4] = {xv.x, xv.y, xv.z, xv.w};
        float bv[MN];
        if constexpr (MN % 4 == 0) {
#pragma unroll
          for (int m = 0; m < MN; m += 4) {
            const float4 v = *reinterpret_cast<const float4*>(
                &Bs[j * LDB + tn * MN + m]);
            bv[m] = v.x;
            bv[m + 1] = v.y;
            bv[m + 2] = v.z;
            bv[m + 3] = v.w;
          }
        } else {
#pragma unroll
          for (int m = 0; m < MN; ++m) bv[m] = Bs[j * LDB + tn * MN + m];
        }
#pragma unroll
        for (int m = 0; m < MN; ++m)
#pragma unroll
          for (int q = 0; q < 4; ++q) acc[m][q] += xc[q] * bv[m];
      }
      __syncthreads();                 // the stage is free for jt + 2
    }
    float* sc = g.st + (((long long)b * g.nc + c) * g.H + h) * N * P;
#pragma unroll
    for (int m = 0; m < MN; ++m) {
      const int n = tn * MN + m;
      if (n >= N) continue;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int p = p0 + tp * 4 + q;
        if (p < P) sc[(long long)n * P + p] = acc[m][q];
      }
    }
  }
}

// grid (element slices, H, b), one element (or 4) per thread
__global__ void __launch_bounds__(kThreads)
ssd_scan_state_pass_kernel(Args g) {
  const int e = blockIdx.x * kThreads + threadIdx.x;
  if (g.N * g.P % 4 == 0)
    state_pass<float4>(g, blockIdx.z, blockIdx.y, e, gridDim.x * kThreads);
  else
    state_pass<float>(g, blockIdx.z, blockIdx.y, e, gridDim.x * kThreads);
}

// ---------------------------------------------------------------------------
// 2. chunk scores C.B^T, once per group
// ---------------------------------------------------------------------------

// A chunk's C.B^T is kept as its lower-triangle TK x TK tiles: tile (qt,
// kt), kt <= qt, is tile qt (qt + 1) / 2 + kt of the chunk's slot.
__host__ __device__ constexpr int score_tiles(int L) {
  return (L + TK - 1) / TK * ((L + TK - 1) / TK + 1) / 2;
}

// s[r][q] += sum_{k < w} Cq[ti + 16 r][k] Bk[tj + 16 q][k]: scores of rows
// ti + 16 r and columns tj + 16 q, ascending k
template <int R>
__device__ __forceinline__ void scores_tile(float (&s)[R][4],
                                            const float* Cq, int ldc,
                                            const float* Bk, int ldk, int w,
                                            int ti, int tj) {
  for (int k = 0; k < w; k += 4) {
    float4 cv[R], bv[4];
#pragma unroll
    for (int r = 0; r < R; ++r)
      cv[r] = *reinterpret_cast<const float4*>(&Cq[(ti + 16 * r) * ldc + k]);
#pragma unroll
    for (int q = 0; q < 4; ++q)
      bv[q] = *reinterpret_cast<const float4*>(&Bk[(tj + 16 * q) * ldk + k]);
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        s[r][q] += cv[r].x * bv[q].x;
        s[r][q] += cv[r].y * bv[q].y;
        s[r][q] += cv[r].z * bv[q].z;
        s[r][q] += cv[r].w * bv[q].w;
      }
  }
}

// grid (score tiles * nc, b * G): one TK x TK tile of a chunk's C.B^T
// over the whole d_state, C and B rows zero past L
__global__ void __launch_bounds__(kThreads)
ssd_scan_chunk_scores_kernel(Args g) {
  extern __shared__ __align__(16) float smem[];
  const int L = g.L, N = g.N, Np = round4(N), ld = Np + 4;
  const int nt = score_tiles(L);
  const int c = blockIdx.x / nt;
  const int pair = blockIdx.x - c * nt;
  int qt = 0;
  while ((qt + 1) * (qt + 2) / 2 <= pair) ++qt;
  const int kt = pair - qt * (qt + 1) / 2;
  const int b = blockIdx.y / g.G;
  const int grp = blockIdx.y - b * g.G;
  const int t0 = c * L, i0 = qt * TK, j0 = kt * TK;
  const int tid = threadIdx.x, ti = tid >> 4, tj = tid & 15;
  float* Cs = smem;
  float* Bs = Cs + TK * ld;
  const float* Cg = g.C + b * g.scb + grp * g.scg;
  const float* Bg = g.B + b * g.sbb + grp * g.sbg;
  for (int k = tid; k < TK * (Np / 4); k += kThreads) {
    const int i = k / (Np / 4), n = (k - i * (Np / 4)) * 4;
    const int cnt = max(0, min(4, N - n));
    copy4(&Cs[i * ld + n], Cg + (long long)(t0 + i0 + i) * g.scs + n,
          i0 + i < L ? cnt : 0, g.vec, Cg);
    copy4(&Bs[i * ld + n], Bg + (long long)(t0 + j0 + i) * g.sbs + n,
          j0 + i < L ? cnt : 0, g.vec, Bg);
  }
  __pipeline_commit();
  __pipeline_wait_prior(0);
  __syncthreads();
  float s[TK / 16][4] = {};
  scores_tile(s, Cs, ld, Bs, ld, Np, ti, tj);
  float* out = g.cb
      + (((long long)b * g.nc + c) * g.G + grp) * nt * TK * TK
      + (long long)pair * TK * TK;
#pragma unroll
  for (int r = 0; r < TK / 16; ++r)
#pragma unroll
    for (int q = 0; q < 4; ++q)
      out[(ti + 16 * r) * TK + tj + 16 * q] = s[r][q];
}

// ---------------------------------------------------------------------------
// 3. chunk outputs
// ---------------------------------------------------------------------------

// floats of a ring stage: for the state read in, a slice of C's query tile
// [TQ][NS + 4] and of the state [NS][LDX]; for a key tile, its scores
// [TQ][LDS], its x [TK][LDX], cumsums [TK] and dt [TK]
__host__ __device__ constexpr int stage_floats() {
  return TQ * (NS + 4) + NS * LDX > TQ * LDS + TK * LDX + 2 * TK
      ? TQ * (NS + 4) + NS * LDX : TQ * LDS + TK * LDX + 2 * TK;
}
// ... and the ring with the query rows' cumsums
__host__ __device__ constexpr size_t out_smem_floats() {
  return (size_t)kStages * stage_floats() + TQ;
}

__device__ __forceinline__ float lane(const float4& v, int e) {
  return e == 0 ? v.x : e == 1 ? v.y : e == 2 ? v.z : v.w;
}

// acc[r][q] += sum_{k < w} A[ti + 16 r][k] Bt[k][tj 4 + q]: the state read
// in (A = a slice of C's query tile, Bt = a state slice) and the decayed
// scores times x dt (A = the scores, Bt = the x dt tile); ascending k
__device__ __forceinline__ void rows_times_tile(float (&acc)[RT][4],
                                                const float* A, int lda,
                                                const float* Bt, int ldb,
                                                int w, int ti, int tj) {
  for (int k = 0; k < w; k += 4) {
    float4 a[RT];
#pragma unroll
    for (int r = 0; r < RT; ++r)
      a[r] = *reinterpret_cast<const float4*>(&A[(ti + 16 * r) * lda + k]);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float4 bv = *reinterpret_cast<const float4*>(
          &Bt[(k + e) * ldb + tj * 4]);
#pragma unroll
      for (int r = 0; r < RT; ++r) {
        const float av = lane(a[r], e);
        acc[r][0] += av * bv.x;
        acc[r][1] += av * bv.y;
        acc[r][2] += av * bv.z;
        acc[r][3] += av * bv.w;
      }
    }
  }
}

// grid (query tiles * head-dim tiles * nc * H * b): heavy query tiles
// (more key tiles) first
__global__ void __launch_bounds__(kThreads, kMinBlocks)
ssd_scan_chunk_out_kernel(Args g) {
  extern __shared__ __align__(16) float smem[];
  const int L = g.L, N = g.N, P = g.P, Np = round4(N);
  const int nq = (L + TQ - 1) / TQ, npt = (P + PT - 1) / PT;
  long long id = blockIdx.x;
  const long long per_q = (long long)npt * g.nc * g.H * g.batch;
  const int qi = nq - 1 - (int)(id / per_q);
  id -= (long long)(nq - 1 - qi) * per_q;
  const int pt = (int)(id % npt);
  id /= npt;
  const int c = (int)(id % g.nc);
  id /= g.nc;
  const int h = (int)(id % g.H);
  const int b = (int)(id / g.H);
  const int i0 = qi * TQ, p0 = pt * PT, t0 = c * L;
  const int qt = i0 / TK;                    // the score tiles' row tile
  const int tid = threadIdx.x, ti = tid >> 4, tj = tid & 15;
  const int grp = h / (g.H / g.G);
  const bool vec = g.vec;

  constexpr int sf = stage_floats();
  float* ring = smem;                        // kStages x sf
  float* csq = ring + kStages * sf;          // [TQ]

  const float* xh = g.x + b * g.sxb + h * g.sxh;
  const float* dth = g.dt + b * g.sdb + h * g.sdh;
  const float* Cg = g.C + b * g.scb + grp * g.scg;
  const float* csh = g.cs + ((long long)b * g.H + h) * g.S + t0;
  const float* sth = g.st + (((long long)b * g.nc + c) * g.H + h) * N * P;
  // row i0 of score tile (qt, 0) of this chunk and group
  const float* cbq = g.cb
      + (((long long)b * g.nc + c) * g.G + grp) * score_tiles(L) * TK * TK
      + (long long)qt * (qt + 1) / 2 * TK * TK + (i0 - qt * TK) * TK;

  const int n_slices = (Np + NS - 1) / NS;
  const int n_keys = (min(i0 + TQ, L) - 1) / TK + 1;  // key tiles to the diagonal
  const int n_h = c > 0 ? n_slices : 0;     // chunk 0 starts from zero
  const int n_steps = n_h + n_keys;

  for (int i = tid; i < TQ; i += kThreads)
    copy1(&csq[i], csh + i0 + i, i0 + i < L, csh);

  // step s: d_state slice s of C's query tile and of the state (s < n_h),
  // else key tile s - n_h: its scores, x, cumsums and dt
  auto issue = [&](int s) {
    float* dst = ring + (s % kStages) * sf;
    if (s < n_h) {
      const int n0 = s * NS, w = min(NS, Np - n0);
      for (int k = tid; k < TQ * (w / 4); k += kThreads) {
        const int i = k / (w / 4), n = n0 + (k - i * (w / 4)) * 4;
        const int cnt = i0 + i < L ? max(0, min(4, N - n)) : 0;
        copy4(&dst[i * (w + 4) + n - n0],
              Cg + (long long)(t0 + i0 + i) * g.scs + n, cnt, vec, Cg);
      }
      float* hs = dst + TQ * (w + 4);
      for (int k = tid; k < w * (PT / 4); k += kThreads) {
        const int nn = k / (PT / 4), p = (k - nn * (PT / 4)) * 4;
        const int cnt = n0 + nn < N ? max(0, min(4, P - p0 - p)) : 0;
        copy4(&hs[nn * LDX + p], sth + (long long)(n0 + nn) * P + p0 + p,
              cnt, vec, sth);
      }
      return;
    }
    const int kj = s - n_h, j0 = kj * TK;
    const float* cbt = cbq + (long long)kj * TK * TK;
    for (int k = tid; k < TQ * (TK / 4); k += kThreads) {
      const int i = k / (TK / 4), j = (k - i * (TK / 4)) * 4;
      copy4(&dst[i * LDS + j], cbt + i * TK + j, 4, true, cbt);
    }
    float* xd = dst + TQ * LDS;
    for (int k = tid; k < TK * (PT / 4); k += kThreads) {
      const int j = k / (PT / 4), p = (k - j * (PT / 4)) * 4;
      const int cnt = j0 + j < L ? max(0, min(4, P - p0 - p)) : 0;
      copy4(&xd[j * LDX + p], xh + (long long)(t0 + j0 + j) * g.sxs + p0 + p,
            cnt, vec, xh);
    }
    float* ck = xd + TK * LDX;
    for (int j = tid; j < TK; j += kThreads) {
      const bool ok = j0 + j < L;
      copy1(&ck[j], csh + j0 + j, ok, csh);
      copy1(&ck[TK + j], dth + (long long)(t0 + j0 + j) * g.sds, ok, dth);
    }
  };

  if (kStages == 1) __pipeline_commit();
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n_steps) issue(s);
    __pipeline_commit();
  }

  float yacc[RT][4] = {};
  for (int s = 0; s < n_steps; ++s) {
    if (s + kStages - 1 < n_steps) issue(s + kStages - 1);
    __pipeline_commit();
    __pipeline_wait_prior(kStages - 1);
    __syncthreads();
    float* stage = ring + (s % kStages) * sf;
    if (s < n_h) {
      // the state carried in: exp(cs_i) C_i . h
      const int w = min(NS, Np - s * NS);
      rows_times_tile(yacc, stage, w + 4, stage + TQ * (w + 4), LDX, w, ti,
                      tj);
      if (s == n_h - 1) {
#pragma unroll
        for (int r = 0; r < RT; ++r) {
          const int i = ti + 16 * r;
          const float d = i0 + i < L ? expf(csq[i]) : 0.f;
#pragma unroll
          for (int q = 0; q < 4; ++q) yacc[r][q] *= d;
        }
      }
    } else {
      const int j0 = (s - n_h) * TK;
      float* St = stage;
      float* xd = St + TQ * LDS;
      const float* ck = xd + TK * LDX;
      const float* dk = ck + TK;
      for (int k = tid; k < TK * PT; k += kThreads) {
        const int j = k / PT, p = k - j * PT;
        xd[j * LDX + p] *= dk[j];
      }
      // the scores decayed and masked in place, each by its own thread
#pragma unroll
      for (int r = 0; r < RT; ++r) {
        const int i = i0 + ti + 16 * r;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int j = j0 + tj + 16 * q;
          float& v = St[(ti + 16 * r) * LDS + tj + 16 * q];
          v = (i < L && j <= i) ? v * expf(csq[ti + 16 * r] - ck[tj + 16 * q])
                                : 0.f;
        }
      }
      __syncthreads();
      rows_times_tile(yacc, St, LDS, xd, LDX, round4(min(TK, L - j0)), ti,
                      tj);
    }
    __syncthreads();                         // the stage is free
  }

  float* yb = g.y + (long long)b * g.S * g.H * P;
#pragma unroll
  for (int r = 0; r < RT; ++r) {
    const int i = i0 + ti + 16 * r;
    if (i >= L) continue;
    float* yr = yb + ((long long)(t0 + i) * g.H + h) * P;
    const int p = p0 + tj * 4;
    if (vec && p < P) {
      *reinterpret_cast<float4*>(&yr[p]) =
          make_float4(yacc[r][0], yacc[r][1], yacc[r][2], yacc[r][3]);
    } else {
#pragma unroll
      for (int q = 0; q < 4; ++q)
        if (p + q < P) yr[p + q] = yacc[r][q];
    }
  }
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

template <int MN>
cudaError_t launch_state(const Args& g, cudaStream_t stream) {
  const size_t bytes = state_smem_floats(g.L, MN) * sizeof(float);
  cudaError_t err = allow_smem(ssd_scan_chunk_state_kernel<MN>, bytes);
  if (err != cudaSuccess) return err;
  const int npt = (g.P + PT - 1) / PT;
  ssd_scan_chunk_state_kernel<MN>
      <<<dim3(g.nc * npt, g.H, g.batch), kThreads, bytes, stream>>>(g);
  return cudaGetLastError();
}

}  // namespace

// Floats of the three scratch buffers of ssd_scan, into floats[0..2]: cs,
// the chunk cumsums (b, H, S); st, the chunk states (b, S / L, H, N, P);
// cb, per (batch, chunk, group) the lower-triangle TK x TK tiles of C.B^T.
extern "C" void ssd_scan_scratch(int batch, int S, int H, int G, int P,
                                 int N, int L, long long* floats) {
  const long long nc = S / L;
  floats[0] = (long long)batch * H * S;
  floats[1] = batch * nc * H * N * P;
  floats[2] = batch * nc * G * score_tiles(L) * TK * TK;
}

// Returns the first CUDA error of the four (or three) launches, 0 on
// success.  Allocates nothing; runs on `stream`.  cs, st, cb: scratch of
// ssd_scan_scratch's sizes, st and cb 16-byte aligned.  vec: x, B and C (pointers
// and strides) on 16 bytes and P, N multiples of 4.  Requires H % G == 0,
// S % L == 0, 1 <= N <= 128.
extern "C" int ssd_scan(
    const void* x, const void* dt, const void* A, const void* B,
    const void* C, void* y, void* cs, void* st, void* cb, int batch,
    int S, int H, int P, int G, int N, int L, long long sxb, long long sxs,
    long long sxh, long long sdb, long long sds, long long sdh,
    long long sbb, long long sbs, long long sbg, long long scb,
    long long scs, long long scg, int vec, void* stream) {
  if (N < 1 || N > kMaxN || P < 1 || L < 1 || S % L || G < 1 || H % G)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  Args g{static_cast<const float*>(x), static_cast<const float*>(dt),
         static_cast<const float*>(A), static_cast<const float*>(B),
         static_cast<const float*>(C), static_cast<float*>(y),
         static_cast<float*>(cs), static_cast<float*>(st),
         static_cast<float*>(cb), batch, S, H, P, G, N, L, S / L, vec,
         sxb, sxs, sxh, sdb, sds, sdh, sbb, sbs, sbg, scb, scs, scg};
  cudaError_t err = N <= 16 ? launch_state<1>(g, s)
      : N <= 32 ? launch_state<2>(g, s)
      : N <= 64 ? launch_state<4>(g, s)
      : launch_state<8>(g, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (g.nc > 1) {
    const int per = N * P % 4 == 0 ? N * P / 4 : N * P;
    ssd_scan_state_pass_kernel<<<dim3((per + kThreads - 1) / kThreads, H,
                                      batch), kThreads, 0, s>>>(g);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const size_t sbytes = (size_t)2 * TK * (round4(N) + 4) * sizeof(float);
  err = allow_smem(ssd_scan_chunk_scores_kernel, sbytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  ssd_scan_chunk_scores_kernel<<<dim3(score_tiles(L) * g.nc, batch * G),
                                 kThreads, sbytes, s>>>(g);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t bytes = out_smem_floats() * sizeof(float);
  err = allow_smem(ssd_scan_chunk_out_kernel, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned blocks = (unsigned)((L + TQ - 1) / TQ)
      * ((P + PT - 1) / PT) * g.nc * H * batch;
  ssd_scan_chunk_out_kernel<<<blocks, kThreads, bytes, s>>>(g);
  return static_cast<int>(cudaGetLastError());
}
