// A stream hold for timing: one thread spins on the device until the host
// sets a flag in pinned host memory, or until a timeout passes.
//
// Not a port of any kernel: chip_smoke.py's device_time_ms enqueues a
// chunk of timed calls behind this kernel and sets the flag after the
// chunk's last launch, so the calls then run back to back and each pair of
// CUDA events around a call times device work only, with no host time in
// it.  The timeout (globaltimer nanoseconds) ends the spin if the host
// never sets the flag, e.g. because a timed call waited on the device;
// the kernel then writes 1 to `timed_out`, which the host checks.
#include <cuda_runtime.h>

__global__ void stream_hold_kernel(const volatile int* flag, int* timed_out,
                                   long long timeout_ns) {
  unsigned long long t0, t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t0));
  while (*flag == 0) {
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    if ((long long)(t - t0) > timeout_ns) {
      *timed_out = 1;
      return;
    }
    __nanosleep(500);
  }
}

// host_flag: a pinned (page-locked) host int the host sets to nonzero;
// timed_out: a device int, left alone unless the timeout passes.
extern "C" int stream_hold_launch(int* host_flag, int* timed_out,
                                  long long timeout_ns, cudaStream_t stream) {
  int* flag = nullptr;
  cudaError_t err = cudaHostGetDevicePointer((void**)&flag, host_flag, 0);
  if (err != cudaSuccess) return (int)err;
  stream_hold_kernel<<<1, 1, 0, stream>>>(flag, timed_out, timeout_ns);
  return (int)cudaGetLastError();
}
