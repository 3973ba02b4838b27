// The device segments' stamp (train/profiling.py): a one-thread kernel that
// reads the card's nanosecond clock (%globaltimer) where the stream reaches
// it and adds the time since the stream's previous stamp to a segment's sum.
//
// It replaces no TPU kernel: the JAX package has no counterpart (XLA's own
// profiler names its fused ops). It exists because a CUDA graph's replay is
// one host call, so no host clock can split it: the stamps are nodes of the
// graph, and each replay runs them between the modules' kernels. Its cost is
// its launch inside the graph (a microsecond or two), not its work.
//
// words, int64 on the card, made outside any graph pool by the caller:
//   words[0]      the clock at the last stamp
//   words[1]      the steps begun (a stamp with segment -1)
//   words[2 + k]  segment k's nanoseconds
// Stamps of one stream run in order, each after the kernels before it, so
// the read-modify-writes need no atomics.
#include <cstdint>
#include <cuda_runtime.h>

__global__ void segment_stamp_kernel(unsigned long long* words, int segment) {
  unsigned long long now;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(now));
  if (segment < 0) {
    words[1] += 1;
  } else {
    words[2 + segment] += now - words[0];
  }
  words[0] = now;
}

extern "C" int segment_stamp_launch(void* words, int segment, void* stream) {
  segment_stamp_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<unsigned long long*>(words), segment);
  return static_cast<int>(cudaGetLastError());
}
