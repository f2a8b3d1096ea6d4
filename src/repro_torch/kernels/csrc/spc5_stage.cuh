// Helpers shared by the SPC5 kernels of this directory: copies from global
// into shared memory (plain loads, cp.async for a double buffer, Hopper's
// bulk copy completing on an mbarrier, or strided runs of table entries by
// cp.async or vector loads), the value stores' decode and staged windows,
// and the dynamic-shared-memory opt-in before a launch.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// The value stores a kernel may stage: f32, or the value-dtype axis's
// quantised stores, bf16 and int8 (one f32 scale a chunk). dequant is one
// staged value as f32, what the reference's _expand_vals makes of it
// before the product with x: bf16 upcast, int8 upcast then times its
// chunk's scale, f32 as it is (the scale unread).
__device__ __forceinline__ float dequant(float v, float) { return v; }
__device__ __forceinline__ float dequant(__nv_bfloat16 v, float) { return __bfloat162float(v); }
__device__ __forceinline__ float dequant(int8_t v, float scale) { return (float)v * scale; }

// Chunk g's scale for values of type V: an int8 store's, from its chunk
// scales; 1 (unread) for the others.
template <typename V>
__device__ __forceinline__ float value_scale(const float* scale, size_t g) {
  if constexpr (sizeof(V) == 1) {
    return __ldg(scale + g);
  } else {
    return 1.f;
  }
}

// Shared memory of one staged window of vmax values of vsize bytes: an f32
// window as it lies (16-byte aligned where vbase is a multiple of 4), a
// narrow one as the 16-byte aligned span that covers it (value_span), 16
// bytes more: an int8 window starts on any multiple of 8 bytes. The
// wrappers' copy: kernels/spc5_spmv_desc.py: value_window_bytes.
__host__ __device__ inline int value_window(int vsize, int vmax) {
  return ((vsize * vmax + 15) & ~15) + (vsize < 4 ? 16 : 0);
}

// The 16-byte aligned span that covers the narrow window [vb, vb + vmax) of
// values (16-byte aligned, as the wrappers check), kept inside the nvalues
// values there are: returns its start; off is the index of the window's
// first value in it and bytes what to copy, a multiple of 16 (at most
// value_window) unless the span's last 16-byte piece would reach past
// values' end. A window starts and ends on a multiple of 4 bytes (8 for
// bf16, and for int8 at the default alignment of 8 values), inside values,
// whose length is a multiple of 4 bytes, so that happens exactly where the
// window ends past values' last 16-byte boundary; bytes then stops at
// values' end, 4, 8 or 12 bytes into the last piece (8 past a bf16 or an
// int8 plan aligned to 8 values, 4 or 12 past an int8 plan aligned to 4).
// (Integer compares on value indices only: a pointer compare cost the
// synchronous panel descriptor SpMV kernels registers.) The wrappers' copy:
// kernels/spc5_spmv.py: value_span.
template <typename V>
__device__ __forceinline__ const char* value_span(const V* values, int vb, int vmax, int nvalues,
                                                  int& bytes, int& off) {
  constexpr int kPerPiece = 16 / (int)sizeof(V);  // values a 16-byte piece holds
  const uintptr_t p = reinterpret_cast<uintptr_t>(values + vb);
  const uintptr_t lo = p & ~(uintptr_t)15;
  off = (int)(p - lo) / (int)sizeof(V);
  bytes = (int)((p - lo + sizeof(V) * (uintptr_t)vmax + 15) & ~(uintptr_t)15);
  // the span then ends on the 16-byte boundary after values' end: stop at
  // values' end, (nvalues * sizeof(V)) % 16 bytes into the last piece
  if (vb + vmax > (nvalues & ~(kPerPiece - 1))) bytes += ((nvalues * (int)sizeof(V)) & 15) - 16;
  return reinterpret_cast<const char*>(lo);
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(gmem));
}

__device__ __forceinline__ void cp_async8(void* smem, const void* gmem) {
  unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s), "l"(gmem));
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

// Copy bytes of a span value_span returned into shared memory at dst (16-byte
// aligned), as the thread that issues a stage's bulk copies: its whole
// 16-byte pieces by one bulk copy on bar, and where value_span stopped the
// span at values' end inside its last piece, the 4, 8 or 12 bytes before it
// by cp.async, completed by the caller's cp.async wait. The barrier expects
// span_bulk_bytes(bytes).
__device__ __forceinline__ uint32_t span_bulk_bytes(int bytes) { return (uint32_t)(bytes & ~15); }

__device__ __forceinline__ void copy_span(unsigned char* dst, const char* span, int bytes,
                                          uint64_t* bar) {
  const int whole = bytes & ~15;
  if (whole > 0) bulk_copy(dst, span, (uint32_t)whole, bar);
  if (bytes & 12) {  // a span stopped at values' end: rare, one test
    if (bytes & 8) cp_async8(dst + whole, span + whole);
    if (bytes & 4) cp_async4(dst + (bytes & ~7), span + (bytes & ~7));
  }
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

// Copy bytes of a span value_span returned into dst (16-byte aligned) with
// all threads of the CTA: its whole 16-byte pieces by copy_runs (always in
// 16-byte pieces: the span starts on a 16-byte boundary), and where
// value_span stopped the span at values' end inside its last piece, the 4,
// 8 or 12 bytes before it by the last thread (cp.async, completed by the
// caller's wait, or vector loads).
template <bool kAsync>
__device__ __forceinline__ void copy_span_runs(unsigned char* dst, const char* span, int bytes) {
  const int whole = bytes & ~15;
  copy_runs<kAsync>(dst, span, 1, whole, 0);
  if ((bytes & 12) && threadIdx.x == blockDim.x - 1) {
    const int tail = bytes & ~7;  // where a last 4-byte piece starts
    if (kAsync) {
      if (bytes & 8) cp_async8(dst + whole, span + whole);
      if (bytes & 4) cp_async4(dst + tail, span + tail);
    } else {
      if (bytes & 8) {
        *reinterpret_cast<uint2*>(dst + whole) = __ldg(reinterpret_cast<const uint2*>(span + whole));
      }
      if (bytes & 4) {
        *reinterpret_cast<unsigned*>(dst + tail) =
            __ldg(reinterpret_cast<const unsigned*>(span + tail));
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
