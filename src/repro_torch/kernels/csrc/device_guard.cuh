// Make one card current for a launch and give the caller's back afterwards.
//
// Every launcher takes the tensor's device index; launching on a stream of
// another card than the current one is an error, so the launcher switches
// to that card.  The guard restores the caller's current device when it
// goes out of scope (after the launcher has read cudaGetLastError()), so a
// launch on cuda:1 does not move later work of the calling thread there.
#pragma once

#include <cuda_runtime.h>

struct DeviceGuard {
  int prev = -1;
  cudaError_t err = cudaSuccess;

  explicit DeviceGuard(int device) {
    err = cudaGetDevice(&prev);
    if (err == cudaSuccess && prev != device) {
      err = cudaSetDevice(device);
    } else {
      prev = -1;  // nothing to restore
    }
  }
  ~DeviceGuard() {
    if (prev >= 0) cudaSetDevice(prev);
  }
  DeviceGuard(const DeviceGuard&) = delete;
  DeviceGuard& operator=(const DeviceGuard&) = delete;
};
