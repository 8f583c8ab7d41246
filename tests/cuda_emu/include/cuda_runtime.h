// A CPU stand-in for the pieces of the CUDA runtime that the port's
// kernels (the decode pair with csrc/decode_tile.cuh, ssd_scan,
// paged_append and branch_matmul) use, so that g++ can
// build them and run them on the CPU: one std::thread per CUDA thread,
// the blocks of a grid one after another, __syncthreads and the warp
// shuffles and votes as barriers over shared arrays.  It checks the
// kernels' indexing, masking and merge order, not their speed, and not
// what only nvcc checks (__host__ / __device__ attributes).
#pragma once
#include <algorithm>
#include <atomic>
#include <barrier>
#include <cmath>
#include <cstring>
#include <cstdint>
#include <cstddef>
#include <functional>
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
enum cudaDeviceAttr { cudaDevAttrMultiProcessorCount = 16 };
inline cudaError_t cudaGetDevice(int* d) { *d = 0; return cudaSuccess; }
// an H100's 132 SMs, so a kernel picks its launch shape as on the card
inline cudaError_t cudaDeviceGetAttribute(int* v, cudaDeviceAttr, int) { *v = 132; return cudaSuccess; }
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize = 8 };
template <typename F> inline cudaError_t cudaFuncSetAttribute(F, cudaFuncAttribute, int) { return cudaSuccess; }
inline cudaError_t cudaGetLastError() { return cudaSuccess; }

namespace emu {
inline thread_local dim3 tidx;
inline dim3 bidx, bdim, gdim;
inline std::unique_ptr<std::barrier<>> block_bar;
inline std::vector<std::unique_ptr<std::barrier<>>> warp_bars;
inline float xch[1024];
inline int ixch[1024];
alignas(16) inline float4 shared_mem[65536];
// The blocks of the grid run one after another on one set of threads, in
// reverse launch order (the card promises no order, so a kernel that
// leans on launch order shows): before each block the host side sets
// blockIdx and fills shared memory with garbage, then every thread runs
// the kernel body once.
inline void launch(dim3 grid, unsigned threads, size_t shmem, cudaStream_t, std::function<void()> fn) {
  if (shmem > sizeof(shared_mem)) throw 1;
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
