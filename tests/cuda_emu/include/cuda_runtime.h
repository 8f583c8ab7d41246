// A CPU stand-in for the pieces of the CUDA runtime that the port's
// kernels (the decode pair with csrc/decode_tile.cuh, ssd_scan,
// paged_append and branch_matmul) use, so that g++ can
// build them and run them on the CPU: one std::thread per CUDA thread,
// the blocks of a grid one after another, __syncthreads and the warp
// shuffles, votes and tensor-core instructions (ldmatrix, mma.sync) as
// barriers over shared arrays.  It checks the kernels' indexing, masking,
// fragment layouts and merge order, not their speed, and not what only
// nvcc checks (__host__ / __device__ attributes).
#pragma once
#include <algorithm>
#include <atomic>
#include <barrier>
#include <cmath>
#include <cstring>
#include <cstdint>
#include <cstddef>
#include <functional>
#include <map>
#include <memory>
#include <thread>
#include <vector>
using std::min; using std::max;

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)

struct dim3 { unsigned x, y, z; dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {} };
struct uint2 { unsigned x, y; };
struct uint4 { unsigned x, y, z, w; };
struct float4 { float x, y, z, w; };
inline uint4 make_uint4(unsigned a, unsigned b, unsigned c, unsigned d) { return {a, b, c, d}; }
inline float4 make_float4(float a, float b, float c, float d) { return {a, b, c, d}; }
typedef void* cudaStream_t;
enum cudaError_t { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
namespace emu {
inline cudaError_t last_error = cudaSuccess;
// per kernel: the dynamic shared memory it may use past the 48 KB default
inline std::map<const void*, int> max_dynamic_smem;
}  // namespace emu
enum cudaDeviceAttr { cudaDevAttrMultiProcessorCount = 16 };
inline cudaError_t cudaGetDevice(int* d) { *d = 0; return cudaSuccess; }
// an H100's 132 SMs, so a kernel picks its launch shape as on the card
inline cudaError_t cudaDeviceGetAttribute(int* v, cudaDeviceAttr, int) { *v = 132; return cudaSuccess; }
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize = 8 };
// an H100 grants a block at most 227 KB of shared memory
template <typename F> inline cudaError_t cudaFuncSetAttribute(F f, cudaFuncAttribute, int v) {
  if (v < 0 || v > 232448) return cudaErrorInvalidValue;
  emu::max_dynamic_smem[reinterpret_cast<const void*>(f)] = v;
  return cudaSuccess;
}
inline cudaError_t cudaGetLastError() { cudaError_t e = emu::last_error; emu::last_error = cudaSuccess; return e; }

namespace emu {
inline thread_local dim3 tidx;
inline dim3 bidx, bdim, gdim;
inline std::unique_ptr<std::barrier<>> block_bar;
inline std::vector<std::unique_ptr<std::barrier<>>> warp_bars;
inline float xch[1024];
inline int ixch[1024];
inline uint32_t uxch[1024][6];
inline const void* pxch[1024];
alignas(16) inline float4 shared_mem[65536];
// The blocks of the grid run one after another on one set of threads, in
// reverse launch order (the card promises no order, so a kernel that
// leans on launch order shows): before each block the host side sets
// blockIdx and fills shared memory with garbage, then every thread runs
// the kernel body once.  A launch asking for more than 48 KB of dynamic
// shared memory without the kernel's opt-in is refused, as on the card:
// it never runs and cudaGetLastError reports it.
inline void launch(dim3 grid, unsigned threads, size_t shmem, cudaStream_t, const void* kernel, std::function<void()> fn) {
  if (shmem > sizeof(shared_mem)) throw 1;
  if (shmem > 48 * 1024) {
    auto it = max_dynamic_smem.find(kernel);
    if (it == max_dynamic_smem.end() || (size_t)it->second < shmem) { last_error = cudaErrorInvalidValue; return; }
  }
  gdim = grid; bdim = dim3(threads);
  block_bar = std::make_unique<std::barrier<>>(threads);
  warp_bars.clear();
  for (unsigned w = 0; w < threads / 32; ++w) warp_bars.push_back(std::make_unique<std::barrier<>>(32));
  const size_t n_blocks = (size_t)grid.x * grid.y * grid.z;
  std::barrier<> start(threads + 1), done(threads + 1);
  std::vector<std::thread> ts;
  for (unsigned t = 0; t < threads; ++t)
    ts.emplace_back([t, &fn, &start, &done, n_blocks] {
      tidx = dim3(t);
      for (size_t k = 0; k < n_blocks; ++k) {
        start.arrive_and_wait();
        fn();
        done.arrive_and_wait();
      }
    });
  for (size_t k = n_blocks; k-- > 0;) {
    bidx = dim3(k % grid.x, k / grid.x % grid.y, k / grid.x / grid.y);
    std::memset(shared_mem, 0x7f, shmem);       // garbage, as on the card
    start.arrive_and_wait();
    done.arrive_and_wait();
  }
  for (auto& t : ts) t.join();
}
}  // namespace emu
#define threadIdx emu::tidx
#define blockIdx emu::bidx
#define blockDim emu::bdim
#define gridDim emu::gdim

inline void __syncthreads() { emu::block_bar->arrive_and_wait(); }
inline int __syncthreads_or(int p) {
  emu::ixch[threadIdx.x] = p != 0;
  __syncthreads();
  int r = 0;
  for (unsigned i = 0; i < blockDim.x; ++i) r |= emu::ixch[i];
  __syncthreads();
  return r;
}
inline float __shfl_xor_sync(unsigned, float v, int o) {
  auto& bar = *emu::warp_bars[threadIdx.x / 32];
  emu::xch[threadIdx.x] = v;
  bar.arrive_and_wait();
  float r = emu::xch[(threadIdx.x & ~31u) | ((threadIdx.x & 31u) ^ (unsigned)o)];
  bar.arrive_and_wait();
  return r;
}
inline float __shfl_up_sync(unsigned, float v, unsigned o) {
  auto& bar = *emu::warp_bars[threadIdx.x / 32];
  emu::xch[threadIdx.x] = v;
  bar.arrive_and_wait();
  const unsigned lane = threadIdx.x & 31u;
  float r = lane >= o ? emu::xch[threadIdx.x - o] : v;
  bar.arrive_and_wait();
  return r;
}
inline int __any_sync(unsigned, int p) {
  auto& bar = *emu::warp_bars[threadIdx.x / 32];
  emu::ixch[threadIdx.x] = p != 0;
  bar.arrive_and_wait();
  int r = 0;
  for (unsigned i = threadIdx.x & ~31u; i < (threadIdx.x & ~31u) + 32; ++i) r |= emu::ixch[i];
  bar.arrive_and_wait();
  return r;
}
inline uint4 __ldg(const uint4* p) { return *p; }
inline float __ldcg(const float* p) { return *p; }
inline float4 __ldcg(const float4* p) { return *p; }
inline void __threadfence() { std::atomic_thread_fence(std::memory_order_seq_cst); }
inline int atomicAdd(int* p, int v) { return __atomic_fetch_add(p, v, __ATOMIC_SEQ_CST); }
inline float __fmul_rn(float a, float b) { return a * b; }
inline float __uint_as_float(unsigned u) { float f; std::memcpy(&f, &u, 4); return f; }
inline unsigned __float_as_uint(float f) { unsigned u; std::memcpy(&u, &f, 4); return u; }

// ldmatrix.sync.aligned.m8n8.x4(.trans).shared.b16: lanes 8i..8i+7 give
// the row addresses (16 bytes each, in shared memory) of 8 x 8 matrix i;
// r[i] of lane l holds its elements (l / 4, 2 (l % 4) + {0, 1}), or with
// .trans (2 (l % 4) + {0, 1}, l / 4), the first in the low half
inline void __emu_ldmatrix_x4(uint32_t (&r)[4], const void* p, bool trans) {
  const char* lo = reinterpret_cast<const char*>(emu::shared_mem);
  const char* c = static_cast<const char*>(p);
  if (c < lo || c + 16 > lo + sizeof(emu::shared_mem) || (c - lo) % 16) throw 3;
  auto& bar = *emu::warp_bars[threadIdx.x / 32];
  emu::pxch[threadIdx.x] = p;
  bar.arrive_and_wait();
  const unsigned base = threadIdx.x & ~31u, lane = threadIdx.x & 31u;
  for (int i = 0; i < 4; ++i) {
    uint32_t v = 0;
    for (unsigned j = 0; j < 2; ++j) {
      const unsigned row = trans ? 2 * (lane % 4) + j : lane / 4;
      const unsigned col = trans ? lane / 4 : 2 * (lane % 4) + j;
      uint16_t e;
      std::memcpy(&e, static_cast<const char*>(emu::pxch[base + 8 * i + row]) + 2 * col, 2);
      v |= (uint32_t)e << (16 * j);
    }
    r[i] = v;
  }
  bar.arrive_and_wait();
}

// mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32, c += a . b: lane l
// (group l / 4, t = l % 4) holds a (16 x 16) rows l / 4 and + 8 at columns
// 2t + {0, 1} and + 8 as a[0] (row, k < 8), a[1] (row + 8), a[2] (k + 8),
// a[3]; b (16 x 8) column l / 4 at rows 2t + {0, 1} (b0) and + 8 (b1);
// c (16 x 8) rows l / 4 (c[0], c[1]) and + 8 (c[2], c[3]) at columns
// 2t + {0, 1}.  Each output adds its 16 exact products to c in order of k.
inline void __emu_mma_m16n8k16_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  auto& bar = *emu::warp_bars[threadIdx.x / 32];
  uint32_t* mine = emu::uxch[threadIdx.x];
  for (int i = 0; i < 4; ++i) mine[i] = a[i];
  mine[4] = b0;
  mine[5] = b1;
  bar.arrive_and_wait();
  const unsigned base = threadIdx.x & ~31u, lane = threadIdx.x & 31u;
  auto half = [](uint32_t v, unsigned k) { return __uint_as_float((k % 2 ? v >> 16 : v & 0xffffu) << 16); };
  auto A = [&](unsigned row, unsigned k) {
    return half(emu::uxch[base + (row % 8) * 4 + (k % 8) / 2][(row >= 8) + 2 * (k >= 8)], k);
  };
  auto B = [&](unsigned k, unsigned col) {
    return half(emu::uxch[base + col * 4 + (k % 8) / 2][4 + (k >= 8)], k);
  };
  float d[4];
  for (unsigned e = 0; e < 4; ++e) {
    const unsigned row = lane / 4 + 8 * (e / 2), col = 2 * (lane % 4) + e % 2;
    float s = c[e];
    for (unsigned k = 0; k < 16; ++k) s += A(row, k) * B(k, col);
    d[e] = s;
  }
  bar.arrive_and_wait();
  for (int e = 0; e < 4; ++e) c[e] = d[e];
}
