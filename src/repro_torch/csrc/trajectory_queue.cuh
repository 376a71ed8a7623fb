// The trajectory work queue of the adaptive SDE ensemble kernel
// (sde_adaptive_ensemble.cu).
//
// An adaptive trajectory makes as many attempts as its own error control
// asks for, so with one trajectory per thread a warp runs as long as its
// slowest lane and the lanes that finished early idle in it.  On the queue
// a kernel runs a persistent grid (`persistent_grid`: the blocks per SM the
// occupancy API reports, times the SMs, capped by the blocks N
// trajectories fill).  A thread starts on trajectory
// blockIdx.x·blockDim.x + threadIdx.x, so the first loads and stores
// coalesce, and each time its trajectory ends it takes the next index from
// a device counter (`next`); the loop ends when the index reaches N.  A
// warp then idles only at the tail of the run.  Which thread runs a
// trajectory changes nothing in it: every input, output and random number
// of a trajectory is keyed by its index, so the results are those of one
// trajectory per thread, bit for bit.
//
// The counter is one 32-bit word that the wrapper allocates and zeroes on
// the launch's stream (src/repro_torch/kernels/queue.py); the kernel
// allocates nothing.  It counts the indices handed out past the grid's
// first ones.

#pragma once

#include <cuda_runtime.h>

namespace repro_queue {

// Blocks of `block` threads for a persistent launch of `kernel` over N
// trajectories.
template <class Kernel>
inline int persistent_grid(Kernel kernel, int block, int N) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, block, 0);
  const long long fill = (static_cast<long long>(N) + block - 1) / block;
  const long long grid =
      static_cast<long long>(per_sm > 0 ? per_sm : 1) * (sms > 0 ? sms : 1);
  return static_cast<int>(grid < fill ? grid : fill);
}

// The next trajectory of a thread whose trajectory ended: the lanes of a
// warp that ask together take consecutive indices with one atomicAdd, made
// by the lowest of them.  Blocks are 1-D and a multiple of 32 threads.
__device__ __forceinline__ unsigned next(unsigned* counter) {
  const unsigned mask = __activemask();
  const unsigned lane = threadIdx.x & 31u;
  const int leader = __ffs(mask) - 1;
  unsigned base = 0;
  if (lane == static_cast<unsigned>(leader))
    base = atomicAdd(counter, static_cast<unsigned>(__popc(mask)));
  base = __shfl_sync(mask, base, leader);
  return gridDim.x * blockDim.x + base +
         static_cast<unsigned>(__popc(mask & ((1u << lane) - 1u)));
}

}  // namespace repro_queue
