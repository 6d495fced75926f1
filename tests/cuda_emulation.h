// Stand-ins for the CUDA primitives a kernel's device code uses, so that a
// host compiler can build it and run it on the CPU, one block at a time.
// Every CUDA thread is a fiber (ucontext) on the calling OS thread: a fiber
// runs until it waits at __syncthreads, __syncwarp or a shuffle, then the
// scheduler resumes the others, warp by warp. One fiber runs at a time, so
// threadIdx, blockIdx and blockDim are plain globals and a run is deterministic.
// Dynamic shared memory is a static array, filled with 0xff bytes (a NaN
// pattern) before each block.
//
// Include this, then the kernel's source, then call emulate_blocks. It finds
// faults of indexing and of synchronisation between phases (a barrier that
// not every thread reaches is reported as a deadlock); it cannot find a race
// on an asynchronous copy, which here completes at once.
#pragma once

#include <ucontext.h>

#include <array>
#include <cmath>
#include <cstddef>
#include <cstring>
#include <functional>
#include <vector>

#define __global__
#define __device__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __shared__
#define __align__(n)

struct Dim3 {
  int x, y, z;
};
static Dim3 threadIdx, blockIdx, gridDim, blockDim;

// `extern __shared__ unsigned char smem_raw[]` inside a kernel of an
// anonymous namespace names this array.
namespace {
alignas(16) unsigned char smem_raw[1 << 18];
}

namespace emulation {

struct Fiber {
  ucontext_t context;
  std::vector<char> stack;
  bool done = false;
};
struct Barrier {
  int parties = 0, arrived = 0;
  long generation = 0;
};

static ucontext_t scheduler;
static std::vector<Fiber> fibers;
static std::function<void()> body;
static Barrier of_block;
static std::vector<Barrier> of_warp;
static std::array<Barrier, 16> named;  // bar.sync id, count: parties set at first use
static std::vector<std::array<double, 32>> exchange;  // one slot a lane
static long progress;  // arrivals at barriers and finished fibers
// Resume a block's warps last to first (a test's choice): a kernel whose
// warps hand values to each other must then still order them by barriers.
static bool warps_reversed = false;

inline void wait(Barrier& barrier) {
  ++progress;
  const long generation = barrier.generation;
  if (++barrier.arrived == barrier.parties) {
    barrier.arrived = 0;
    ++barrier.generation;
    return;
  }
  const int me = threadIdx.x;
  while (barrier.generation == generation) swapcontext(&fibers[me].context, &scheduler);
}

inline void run_fiber() {
  const int me = threadIdx.x;
  body();
  fibers[me].done = true;
  ++progress;
  swapcontext(&fibers[me].context, &scheduler);  // never resumed
}

inline void resume(int thread) {
  threadIdx = {thread, 0, 0};
  swapcontext(&scheduler, &fibers[thread].context);
}

}  // namespace emulation

inline void __syncthreads() { emulation::wait(emulation::of_block); }
// bar.sync id, threads: the first `threads` threads to arrive at barrier id
// (the kernel names which, as on the card, by the warps that reach it).
inline void __named_sync(int id, int threads) {
  emulation::Barrier& barrier = emulation::named[id];
  if (barrier.parties == 0) barrier.parties = threads;
  emulation::wait(barrier);
}
inline void __syncwarp() { emulation::wait(emulation::of_warp[threadIdx.x >> 5]); }

// With a width below 32 the warp is cut into segments of that many lanes and
// source_lane counts from the start of the caller's segment.
template <typename T>
inline T __shfl_sync(unsigned, T value, int source_lane, int width = 32) {
  auto& slots = emulation::exchange[threadIdx.x >> 5];
  const int lane = threadIdx.x & 31;
  slots[lane] = static_cast<double>(value);
  __syncwarp();
  const T got = static_cast<T>(slots[(lane & ~(width - 1)) + (source_lane & (width - 1))]);
  __syncwarp();
  return got;
}

template <typename T>
inline T __shfl_xor_sync(unsigned mask, T value, int lane_mask, int width = 32) {
  return __shfl_sync(mask, value, (threadIdx.x & 31) ^ lane_mask, width);
}

// Bit l of the result is lane l's predicate, for every lane of the warp.
inline unsigned __ballot_sync(unsigned, int predicate) {
  auto& slots = emulation::exchange[threadIdx.x >> 5];
  slots[threadIdx.x & 31] = predicate ? 1.0 : 0.0;
  __syncwarp();
  unsigned votes = 0;
  for (int lane = 0; lane < 32; ++lane)
    if (slots[lane] != 0.0) votes |= 1u << lane;
  __syncwarp();
  return votes;
}

// The position of the lowest set bit, from 1; 0 for no bit.
inline int __ffs(unsigned x) { return __builtin_ffs(static_cast<int>(x)); }

// Runs kernel(args...) for `blocks` blocks of `threads` threads (a multiple
// of 32), one block after the other. Returns 0, or 1 when the threads of a
// block stopped at barriers that can never open.
template <typename Kernel, typename... Args>
int emulate_blocks(int blocks, int threads, Kernel kernel, Args... args) {
  using namespace emulation;
  constexpr size_t kStackBytes = 256 * 1024;
  gridDim = {blocks, 1, 1};
  blockDim = {threads, 1, 1};
  const int warps = threads / 32;
  body = [=] { kernel(args...); };
  for (int block = 0; block < blocks; ++block) {
    blockIdx = {block, 0, 0};
    std::memset(smem_raw, 0xff, sizeof(smem_raw));
    of_block = Barrier{threads};
    of_warp.assign(warps, Barrier{32});
    named.fill(Barrier{});
    exchange.assign(warps, {});
    fibers.clear();
    fibers.resize(threads);
    for (Fiber& fiber : fibers) {
      fiber.stack.resize(kStackBytes);
      getcontext(&fiber.context);
      fiber.context.uc_stack.ss_sp = fiber.stack.data();
      fiber.context.uc_stack.ss_size = kStackBytes;
      fiber.context.uc_link = nullptr;
      makecontext(&fiber.context, run_fiber, 0);
    }
    // A warp is cycled while any of its lanes arrives somewhere: its lanes
    // pass their warp barriers in step. Then the next warp; all of them
    // again when the block barrier may have opened.
    bool all_done = false;
    while (!all_done) {
      all_done = true;
      const long before_pass = progress;
      for (int turn = 0; turn < warps; ++turn) {
        const int warp = warps_reversed ? warps - 1 - turn : turn;
        long before_cycle;
        do {
          before_cycle = progress;
          for (int thread = 32 * warp; thread < 32 * (warp + 1); ++thread)
            if (!fibers[thread].done) resume(thread);
        } while (progress != before_cycle);
        for (int thread = 32 * warp; thread < 32 * (warp + 1); ++thread)
          all_done = all_done && fibers[thread].done;
      }
      if (!all_done && progress == before_pass) return 1;
    }
  }
  fibers.clear();
  return 0;
}
