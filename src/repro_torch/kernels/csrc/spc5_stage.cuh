// Staging and launch helpers shared by the SPC5 kernels of this directory:
// copies from global into shared memory (plain loads, or cp.async for a
// double buffer) and the dynamic-shared-memory opt-in before a launch.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Copy n floats (n a multiple of 4, both pointers 16-byte aligned) from
// global to shared memory with all threads of the CTA: asynchronously with
// cp.async, or with plain 16-byte loads and stores.
template <bool kAsync>
__device__ __forceinline__ void stage(float* dst, const float* src, int n) {
  const int n4 = n >> 2;
  for (int i = threadIdx.x; i < n4; i += blockDim.x) {
    if (kAsync) {
      cp_async16(dst + 4 * i, src + 4 * i);
    } else {
      reinterpret_cast<float4*>(dst)[i] = __ldg(reinterpret_cast<const float4*>(src) + i);
    }
  }
}

// Copy n 32-bit words (any n, 4-byte aligned) with all threads of the CTA.
template <bool kAsync>
__device__ __forceinline__ void stage_words(int* dst, const int* src, int n) {
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    if (kAsync) {
      cp_async4(dst + i, src + i);
    } else {
      dst[i] = __ldg(src + i);
    }
  }
}

// Opt in to more than 48 KB of dynamic shared memory where needed, and,
// where asked, count the CTAs that fit on the card at once.
template <typename Kernel>
cudaError_t prepare_launch(Kernel kernel, int device, size_t smem, int threads, int* ctas_per_card) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  if (ctas_per_card != nullptr) {
    int sms = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
    if (err != cudaSuccess) return err;
    *ctas_per_card = sms * (per_sm > 0 ? per_sm : 1);
  }
  return cudaSuccess;
}

}  // namespace
