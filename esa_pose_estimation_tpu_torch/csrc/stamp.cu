// Stage stamps for Hopper (sm_90a): one thread writes the card's
// %globaltimer (nanoseconds) into a ring of call slots on the device.
//
// Replaces no TPU kernel: the JAX package's compiled programs are timed
// from outside, by XLA's profiler.  It is the device half of the port's
// in-memory recorder (obs/profiling.py, Recorder), which marks stage
// boundaries inside the CUDA graphs, where no host range is emitted by a
// replay.
//
// Layout: ring[(counter % capacity) * stride + index] = globaltimer.  The
// counter is the number of calls the ring has seen; the launch that ends
// a call (advance = 1) also moves it on.  Every stamp of a call runs in
// stream order behind the stamp that ended the call before, so all of a
// call's stamps land in one slot however many calls are in flight, and
// the host needs no bookkeeping per stamp.
//
// Bound: launch latency (one thread, one 8-byte load and one or two
// 8-byte stores); a stamp node costs its place in the graph's chain.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void stamp_kernel(long long* ring, long long* counter,
                             long long capacity, int stride, int index,
                             int advance) {
  unsigned long long now;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(now));
  const long long c = *counter;
  ring[(c % capacity) * stride + index] = static_cast<long long>(now);
  if (advance) *counter = c + 1;
}

}  // namespace

extern "C" int stamp_launch(int device, void* ring, void* counter,
                            long long capacity, int stride, int index,
                            int advance, void* stream) {
  int current = -1;
  cudaError_t err = cudaGetDevice(&current);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (current != device) {
    err = cudaSetDevice(device);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  stamp_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<long long*>(ring), static_cast<long long*>(counter),
      capacity, stride, index, advance);
  err = cudaGetLastError();
  if (current != device) cudaSetDevice(current);
  return static_cast<int>(err);
}
