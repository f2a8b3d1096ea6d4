// Helpers shared by the SPC5 kernels of this directory: copies from global
// into shared memory (plain loads, cp.async for a double buffer, Hopper's
// bulk copy completing on an mbarrier, or strided runs of table entries by
// cp.async or vector loads) and the dynamic-shared-memory opt-in before a
// launch.
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

// Hopper's bulk copy, the one-dimensional form of the TMA: one thread copies
// a contiguous run of bytes (both ends 16-byte aligned, a multiple of 16
// long) into the CTA's shared memory, and the mbarrier at bar counts the
// bytes as they land. The thread that issues the copies of a phase first
// announces their total with mbar_expect_tx (its arrival, the barrier's
// only one); every thread then waits for the phase with mbar_wait.
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_u32(bar)) : "memory");
}

// Makes the mbarrier_init of this thread visible to the async proxy; a
// __syncthreads() after it makes it visible to the other threads.
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void bulk_copy(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// Wait until the mbarrier's phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  } while (!done);
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

// Copy runs x run_bytes bytes, run j starting at src + j * stride, into dst
// back to back, with all threads of the CTA: in 16-byte pieces where src,
// run_bytes and stride allow, else in 4-byte pieces (every run here is a
// multiple of 4 bytes at a 4-byte aligned address; dst is 16-byte aligned).
// Where runs > 1, run_bytes is a power of two (c times a table's width, or
// 4), and so are the pieces per run: a piece finds its run by a shift.
// kAsync: cp.async, completed by the caller's wait. Otherwise vector loads,
// up to four pieces in flight per thread before their stores.
template <bool kAsync>
__device__ __forceinline__ void copy_runs(unsigned char* dst, const char* src, int runs,
                                          int run_bytes, int stride) {
  const bool wide = ((reinterpret_cast<uintptr_t>(src) | run_bytes | stride) & 15) == 0;
  const int lsz = wide ? 4 : 2;                               // log2 of the piece size
  const int lq = runs == 1 ? 0 : __ffs(run_bytes >> lsz) - 1;  // log2 of the pieces per run
  const int n = runs == 1 ? run_bytes >> lsz : runs << lq;
  auto from = [&](int j) {
    return runs == 1 ? src + ((size_t)j << lsz)
                     : src + (size_t)(j >> lq) * stride + ((j & ((1 << lq) - 1)) << lsz);
  };
  if (kAsync) {
    for (int j = threadIdx.x; j < n; j += blockDim.x) {
      if (wide) {
        cp_async16(dst + (size_t)j * 16, from(j));
      } else {
        cp_async4(dst + (size_t)j * 4, from(j));
      }
    }
    return;
  }
  for (int j0 = threadIdx.x; j0 < n; j0 += 4 * blockDim.x) {
    int4 v[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int j = j0 + u * blockDim.x;
      if (j < n) {
        if (wide) {
          v[u] = __ldg(reinterpret_cast<const int4*>(from(j)));
        } else {
          v[u].x = __ldg(reinterpret_cast<const int*>(from(j)));
        }
      }
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int j = j0 + u * blockDim.x;
      if (j < n) {
        if (wide) {
          reinterpret_cast<int4*>(dst)[j] = v[u];
        } else {
          reinterpret_cast<int*>(dst)[j] = v[u].x;
        }
      }
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
