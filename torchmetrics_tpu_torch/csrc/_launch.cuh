// Copyright The TorchMetrics-TPU contributors.
// Licensed under the Apache License, Version 2.0.
//
// Launch policy shared by the port's kernels: the block size, the
// shared-memory limits, and the card's SM count.
#pragma once

#include <cuda_runtime.h>

#include <cstddef>

namespace hist_launch {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr size_t kDefaultSmem = 48 * 1024;
constexpr int kMaxDevices = 64;

// What the runtime is asked once per kernel instantiation and device, then
// kept: the queries and the attribute call cost more host time than the
// launch itself.
struct LaunchCache {
  int sms;            // 0: not asked yet
  size_t smem_optin;  // dynamic shared memory the kernel may already use
};

// The SM count of the current device, and the opt-in above 48 KB of dynamic
// shared memory for `kernel`, both through `cache` (kMaxDevices entries).
template <typename Kernel>
cudaError_t prepare(Kernel kernel, size_t smem, LaunchCache* cache, int* sms) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  LaunchCache scratch = {0, kDefaultSmem};
  LaunchCache* slot = device < kMaxDevices ? &cache[device] : &scratch;
  if (slot->sms == 0) {
    if ((err = cudaDeviceGetAttribute(&slot->sms, cudaDevAttrMultiProcessorCount, device)) != cudaSuccess) return err;
    if (slot->smem_optin < kDefaultSmem) slot->smem_optin = kDefaultSmem;
  }
  if (smem > slot->smem_optin) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    slot->smem_optin = smem;
  }
  *sms = slot->sms;
  return cudaSuccess;
}

}  // namespace hist_launch
