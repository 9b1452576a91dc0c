// The stamp of a traced region (exposure_tpu_torch/utils/trace.py).
//
// One thread reads the device's nanosecond clock (%globaltimer), takes the
// next slot of a ring with an atomic add on its count, and writes
// (code, time) there; a stamp that finds the ring full writes nothing, and
// the count, which keeps growing, tells how many were dropped.  The ring
// is never wrapped: a reading after an overflow holds the first stamps.
//
// Launched on the traced work's stream, a stamp runs after the kernels
// queued before it and before those queued after it, so the slots come in
// the order the stamps ran.  Inside a CUDA graph capture the launch
// becomes a kernel node with the ring's and the count's addresses, and
// every replay stamps again.

#include <cuda_runtime.h>

namespace {

__global__ void trace_stamp_kernel(long long* ring, unsigned long long* count,
                                   unsigned long long capacity,
                                   long long code) {
    unsigned long long now;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(now));
    unsigned long long slot = atomicAdd(count, 1ULL);
    if (slot < capacity) {
        ring[2 * slot] = code;
        ring[2 * slot + 1] = (long long)now;
    }
}

}  // namespace

extern "C" {

// ring: [capacity, 2] int64 on the device; count: one int64 on the device.
// Launches on `stream` and returns cudaGetLastError() (0 on success).
int trace_stamp_launch(void* ring, void* count, long long capacity,
                       long long code, void* stream) {
    trace_stamp_kernel<<<1, 1, 0, (cudaStream_t)stream>>>(
        (long long*)ring, (unsigned long long*)count,
        (unsigned long long)capacity, code);
    return (int)cudaGetLastError();
}

const char* trace_stamp_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
