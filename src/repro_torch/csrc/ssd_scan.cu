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
//   not a copy.  The sequence is walked in S / L chunks of length L (any
//   L >= 1).  Per (batch, head), with a (P, N) state h that starts at 0:
//     cs     = cumsum(dt * a) within the chunk (inclusive)
//     y_i    = sum_{j <= i} (C_i . B_j) exp(cs_i - cs_j) x_j dt_j
//              + exp(cs_i) C_i . h
//     h     <- exp(cs_{L-1}) h + sum_j (x_j dt_j) (B_j exp(cs_{L-1} - cs_j))^T
//   The exponential is taken only for j <= i: above the diagonal
//   cs_i - cs_j > 0 may overflow, and inf * 0 would be NaN.
//
// What bounds it on this card: operations.  At the prefill shape (b = 2,
// H = 32, S = 2048, L = 256, P = 64, N = 128) the chunk products need
// about 10.8 GFLOP of fp32 against 72 MB of traffic (~150 flops a byte),
// so the CUDA cores' fp32 rate bounds it (67 TFLOP/s on an H100 SXM by
// its data sheet; TF32 tensor cores would round past the 2e-4
// tolerance).
//
// Design.  The TPU grid walks chunks in order with the state in VMEM; here
// one thread block per (head-dim tile of PT columns, head, batch) walks
// the chunks in order with its (PT, N) slice of the state in shared
// memory.  Splitting P keeps the state recurrence exact (rows of the state
// are independent) and doubles the blocks at P = 64 (128 blocks for 132
// SMs at b = 2, H = 32), at the price of computing C.B^T once per tile.
// The L x L score matrix does not fit in shared memory at L = 256 (256
// KB), so a chunk is cut into TQ-row query tiles and TK-row key tiles;
// tiles above the diagonal are skipped.  The last query tile walks every
// key tile of the chunk, so it also folds the chunk into the state.
// Everything is fp32 FMA on the CUDA cores with a fixed summation order
// and no atomics; the within-chunk cumsum is a block-wide prefix scan
// (segments per thread, then warp shuffles), whose order differs from
// jnp.cumsum, so results agree with the JAX kernel to the 2e-4 tolerance
// of its tests, not bit for bit.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int TQ = 64;            // query rows per tile
constexpr int TK = 64;            // key rows per tile (== TQ: diagonal skip)
constexpr int PT = 32;            // head-dim columns per block
constexpr int kMaxN = 128;        // d_state: one 4-wide n group a thread
constexpr int LDQ = TQ + 4;       // row strides in floats, 16-byte aligned
constexpr int LDK = TK + 4;
constexpr int LDS = TK + 1;       // score rows: conflict-free column reads
constexpr int LDP = PT + 4;

static_assert(TQ == TK, "the diagonal skip pairs query and key tiles");
static_assert(PT == 32 && kThreads == 256, "thread maps below");

struct Args {
  const float* x;
  const float* dt;
  const float* A;
  const float* B;
  const float* C;
  float* y;
  int S, H, P, G, N, L;
  long long sxb, sxs, sxh, sdb, sds, sdh, sbb, sbs, sbg, scb, scs, scg;
};

// floats of dynamic shared memory: cs[L], wk[TK], Ct[N][LDQ], Bt[N][LDK],
// St[TQ][LDS], xdt[TK][LDP], st[N][LDP]
__host__ __device__ inline size_t smem_floats(int N, int L) {
  const size_t tail = TK + (size_t)N * LDQ + (size_t)N * LDK
      + (size_t)TQ * LDS + (size_t)TK * LDP + (size_t)N * LDP;
  return ((size_t)L + 3) / 4 * 4 + tail;        // keep the tiles aligned
}

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

__global__ void __launch_bounds__(kThreads)
ssd_scan_kernel(Args g) {
  extern __shared__ __align__(16) float smem[];
  __shared__ float warp_tot[kThreads / 32];
  const int N = g.N, L = g.L, P = g.P;
  float* cs = smem;
  float* wk = cs + ((size_t)L + 3) / 4 * 4;
  float* Ct = wk + TK;                 // C tile, transposed: [n][i]
  float* Bt = Ct + (size_t)N * LDQ;    // B tile, transposed: [n][j]
  float* St = Bt + (size_t)N * LDK;    // decayed scores: [i][j]
  float* xd = St + TQ * LDS;           // x * dt tile: [j][p]
  float* st = xd + TK * LDP;           // state slice, transposed: [n][p]

  const int tid = threadIdx.x;
  const int p0 = blockIdx.x * PT;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int grp = h / (g.H / g.G);
  const float a = g.A[h];
  const float* xh = g.x + b * g.sxb + h * g.sxh;
  const float* dth = g.dt + b * g.sdb + h * g.sdh;
  const float* Bg = g.B + b * g.sbb + grp * g.sbg;
  const float* Cg = g.C + b * g.scb + grp * g.scg;
  float* yh = g.y + ((long long)b * g.S * g.H + h) * P;
  const long long sys = (long long)g.H * P;

  for (int k = tid; k < N * LDP; k += kThreads) st[k] = 0.f;

  // thread maps: scores 4x4 at (ti, tj); outputs 2x4 at (yi, yp); state
  // 4 (p) x 4 (n) at (sp, sn)
  const int ti = tid >> 4, tj = tid & 15;
  const int yi = tid >> 3, yp = tid & 7;
  const int sp = tid & 7, sn = tid >> 3;

  const int n_chunks = g.S / L;
  const int n_tiles = (L + TQ - 1) / TQ;
  for (int c = 0; c < n_chunks; ++c) {
    const int t0 = c * L;
    chunk_cumsum(cs, dth, g.sds, t0, L, a, warp_tot);
    const float cs_last = cs[L - 1];
    float sacc[4][4] = {};

    for (int qi = 0; qi < n_tiles; ++qi) {
      const int i0 = qi * TQ;
      for (int k = tid; k < TQ * N; k += kThreads) {
        const int i = k / N, n = k - i * N;
        Ct[n * LDQ + i] = i0 + i < L
            ? Cg[(long long)(t0 + i0 + i) * g.scs + n] : 0.f;
      }
      __syncthreads();

      // the state carried in: exp(cs_i) C_i . h
      float yacc[2][4] = {};
      for (int n = 0; n < N; ++n) {
        const float2 cv = *reinterpret_cast<const float2*>(
            &Ct[n * LDQ + yi * 2]);
        const float4 sv = *reinterpret_cast<const float4*>(
            &st[n * LDP + yp * 4]);
        const float cr[2] = {cv.x, cv.y};
        const float sc[4] = {sv.x, sv.y, sv.z, sv.w};
#pragma unroll
        for (int r = 0; r < 2; ++r)
#pragma unroll
          for (int q = 0; q < 4; ++q) yacc[r][q] += cr[r] * sc[q];
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int i = i0 + yi * 2 + r;
        const float d = i < L ? expf(cs[i]) : 0.f;
#pragma unroll
        for (int q = 0; q < 4; ++q) yacc[r][q] *= d;
      }

      const bool last = qi == n_tiles - 1;
      for (int kj = 0; kj <= qi; ++kj) {
        const int j0 = kj * TK;
        for (int k = tid; k < TK * N; k += kThreads) {
          const int j = k / N, n = k - j * N;
          Bt[n * LDK + j] = j0 + j < L
              ? Bg[(long long)(t0 + j0 + j) * g.sbs + n] : 0.f;
        }
        for (int k = tid; k < TK * PT; k += kThreads) {
          const int j = k / PT, p = k - j * PT;
          const long long t = t0 + j0 + j;
          xd[j * LDP + p] = (j0 + j < L && p0 + p < P)
              ? xh[t * g.sxs + p0 + p] * dth[t * g.sds] : 0.f;
        }
        if (tid < TK)
          wk[tid] = j0 + tid < L ? expf(cs_last - cs[j0 + tid]) : 0.f;
        __syncthreads();

        // decayed, causal scores of this (query, key) tile pair
        float s[4][4] = {};
        for (int n = 0; n < N; ++n) {
          const float4 cv = *reinterpret_cast<const float4*>(
              &Ct[n * LDQ + ti * 4]);
          const float4 bv = *reinterpret_cast<const float4*>(
              &Bt[n * LDK + tj * 4]);
          const float cr[4] = {cv.x, cv.y, cv.z, cv.w};
          const float bc[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
          for (int r = 0; r < 4; ++r)
#pragma unroll
            for (int q = 0; q < 4; ++q) s[r][q] += cr[r] * bc[q];
        }
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int i = i0 + ti * 4 + r;
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const int j = j0 + tj * 4 + q;
            St[(ti * 4 + r) * LDS + tj * 4 + q] =
                (i < L && j <= i) ? s[r][q] * expf(cs[i] - cs[j]) : 0.f;
          }
        }
        __syncthreads();

        const int jn = min(TK, L - j0);
        for (int j = 0; j < jn; ++j) {
          const float4 xv = *reinterpret_cast<const float4*>(
              &xd[j * LDP + yp * 4]);
          const float xc[4] = {xv.x, xv.y, xv.z, xv.w};
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const float sv = St[(yi * 2 + r) * LDS + j];
#pragma unroll
            for (int q = 0; q < 4; ++q) yacc[r][q] += sv * xc[q];
          }
        }
        if (last && sn * 4 < N) {
          // fold this key tile into the state: (x dt)^T (B exp(cs_L - cs))
          for (int j = 0; j < jn; ++j) {
            const float4 xv = *reinterpret_cast<const float4*>(
                &xd[j * LDP + sp * 4]);
            const float w = wk[j];
            const float xc[4] = {xv.x * w, xv.y * w, xv.z * w, xv.w * w};
#pragma unroll
            for (int m = 0; m < 4; ++m) {
              const float bv = sn * 4 + m < N
                  ? Bt[(sn * 4 + m) * LDK + j] : 0.f;
#pragma unroll
              for (int q = 0; q < 4; ++q) sacc[q][m] += xc[q] * bv;
            }
          }
        }
        __syncthreads();
      }

#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int i = i0 + yi * 2 + r;
        if (i >= L) continue;
        float* yr = yh + (long long)(t0 + i) * sys;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int p = p0 + yp * 4 + q;
          if (p < P) yr[p] = yacc[r][q];
        }
      }
    }

    // every read of the carried state in this chunk is behind the last
    // barrier: carry it to the chunk's end and add the chunk's own part
    const float decay = expf(cs_last);
    if (sn * 4 < N) {
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        const int n = sn * 4 + m;
        if (n >= N) continue;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          float& v = st[n * LDP + sp * 4 + q];
          v = decay * v + sacc[q][m];
        }
      }
    }
    __syncthreads();
  }
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 on success).  Allocates
// nothing; runs on `stream`.  Requires H % G == 0, S % L == 0, N <= 128.
extern "C" int ssd_scan(
    const void* x, const void* dt, const void* A, const void* B,
    const void* C, void* y, int batch, int S, int H, int P, int G, int N,
    int L, long long sxb, long long sxs, long long sxh, long long sdb,
    long long sds, long long sdh, long long sbb, long long sbs,
    long long sbg, long long scb, long long scs, long long scg,
    void* stream) {
  if (N < 1 || N > kMaxN || L < 1 || S % L || G < 1 || H % G)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t shmem = smem_floats(N, L) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)shmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  Args g{static_cast<const float*>(x), static_cast<const float*>(dt),
         static_cast<const float*>(A), static_cast<const float*>(B),
         static_cast<const float*>(C), static_cast<float*>(y),
         S, H, P, G, N, L, sxb, sxs, sxh, sdb, sds, sdh, sbb, sbs, sbg,
         scb, scs, scg};
  dim3 grid((P + PT - 1) / PT, H, batch);
  ssd_scan_kernel<<<grid, kThreads, shmem,
                    static_cast<cudaStream_t>(stream)>>>(g);
  return static_cast<int>(cudaGetLastError());
}
