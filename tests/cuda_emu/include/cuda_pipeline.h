// The cp.async primitives (cuda_pipeline.h) for the CPU stand-in of the
// CUDA runtime: a thread's copies wait in its own groups and land in
// shared memory only when a __pipeline_wait_prior lets their group
// complete, so a read before the wait sees the stale tile, as on the card.
#pragma once
#include "cuda_runtime.h"
#include <deque>

namespace emu {
struct Copy { void* dst; const void* src; size_t bytes, zfill; };
inline thread_local std::vector<Copy> open_group;
inline thread_local std::deque<std::vector<Copy>> groups;
}  // namespace emu

inline void __pipeline_memcpy_async(void* dst, const void* src, size_t bytes, size_t zfill = 0) {
  if (bytes != 4 && bytes != 8 && bytes != 16) throw 2;
  emu::open_group.push_back({dst, src, bytes, zfill});
}
inline void __pipeline_commit() {
  emu::groups.push_back(std::move(emu::open_group));
  emu::open_group.clear();
}
inline void __pipeline_wait_prior(size_t n) {
  while (emu::groups.size() > n) {
    for (auto& c : emu::groups.front()) {
      std::memcpy(c.dst, c.src, c.bytes - c.zfill);
      std::memset(static_cast<char*>(c.dst) + (c.bytes - c.zfill), 0, c.zfill);
    }
    emu::groups.pop_front();
  }
}
