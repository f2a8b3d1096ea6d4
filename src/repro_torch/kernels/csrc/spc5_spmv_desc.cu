// SPC5 descriptor SpMV for Hopper (sm_90a): the bit-mask decode of the mask
// kernels (spc5_spmv.cu) expanded once at build time into per-lane gather
// tables (repro_torch/core/formats.py: chunk_descriptors), over the two
// chunked layouts.
//
// Replaces the four Pallas TPU kernels of src/repro/kernels/spc5_spmv.py:
//   spc5_spmv_desc_whole_s1   <- spmv_pallas_desc           (_spmv_desc_kernel)
//   spc5_spmv_desc_whole_s2   <- spmv_pallas_desc_db        (_spmv_desc_db_kernel)
//   spc5_spmv_desc_panels_s1  <- spmv_pallas_panels_desc    (_spmv_panel_desc_kernel)
//   spc5_spmv_desc_panels_s2  <- spmv_pallas_panels_desc_db (_spmv_panel_desc_db_kernel)
// All four compute what _desc_contrib computes: per block lane, if the lane
// is valid, value window[vidx] times x[xcol], added into y[yrow].
//
// Bound: memory. Each block lane (r*c per block, set or not) carries one int8
// valid byte and three index entries, each int8, int16 or int32 as the
// build narrowed it (1 + 3..12 bytes a lane), so the tables outweigh the
// mask kernels' 16 bytes a block r*c-fold over; the packed values (4 B per
// nonzero), x and y are read or written once. Two flops per nonzero.
//
// Whole-vector kernels (spmv_desc_whole_kernel):
//   * lanes on threads: a chunk's tables are contiguous (cb, r*c) arrays and
//     thread t takes lanes t, t + blockDim, ..., so a warp reads 32
//     neighbouring narrow entries of each table; the tables are read as built
//     (the index width is a launch argument, the same for the whole launch,
//     so the load's switch is uniform), never widened;
//   * the value window [vbase, vbase + vmax) is staged in shared memory as
//     in the mask kernels (spc5_stage.cuh), synchronously or, for kStages ==
//     2, with the next chunk's window prefetched by cp.async;
//   * unset lanes are skipped: no x gather and nothing added (the Pallas
//     kernels gather at the clipped index and multiply by 0 instead);
//   * consecutive lanes of a warp with the same yrow are summed with warp
//     shuffles first, and each such run adds once into a zeroed y with a
//     global atomicAdd (neighbouring chunks can share rows), so the f32 sum
//     order varies from run to run.
//
// Panel kernels (spmv_desc_panels_kernel), built for latency, not for the
// TPU's sequential grid:
//   * split grid: each panel's chunk list is cut into S contiguous ranges,
//     one CTA each (grid npanels * S; the wrapper picks S from the card's
//     occupancy). A CTA sums its range into a (pr,) y tile in shared memory
//     and adds the tile's nonzero rows into a zeroed y with one global
//     atomicAdd per row (plain stores when S == 1);
//   * staged tables: a stage holds a chunk's valid and vidx runs, the c xcol
//     entries of each block's first row, each block's lane-0 yrow entry,
//     the value window and the x window, all copied in 16-byte pieces where
//     alignment allows (4-byte ones otherwise). kStages >= 2 keeps a ring of
//     stages filled by cp.async, kStages - 1 chunks ahead of the decode, with
//     one barrier per chunk; no table is read from device memory in the
//     decode. kStages == 1 is the synchronous twin: the same stage loaded
//     with 16-byte vector loads before each decode (cut into slices of
//     blocks when a whole chunk's tables do not fit one CTA);
//   * only what differs is read: chunk_descriptors repeats each block's
//     columns over its rows (xcol[k] == xcol[k % c]) and, in the panel
//     layout, where nothing is clipped, its rows over its columns (yrow[k] ==
//     yrow[0] + k / c), so c xcol entries and one yrow entry per block carry
//     everything (held by tests/test_torch_desc_panels.py);
//   * decode from shared memory, four lanes a thread: lanes 4q .. 4q + 3 lie
//     in one block row (c is 4 or 8), so a 4-byte word holds their valid
//     flags and one 4- to 16-byte load each their vidx and xcol entries; a
//     quad with no flag set (most of them: a block holds Avg of its r*c
//     lanes) gathers nothing. A row's two quads (c = 8) are summed with one
//     xor shuffle and the row adds once into the tile with a shared-memory
//     atomic.
//
// Each launcher runs on the caller's stream, allocates nothing, does not
// synchronise, and returns cudaGetLastError() (0 on success).

#include "spc5_stage.cuh"

namespace {

// Sum v over each run of consecutive warp lanes that share key and hand the
// run's total to add(key, total) once, from the run's first lane. Every lane
// of the warp calls it; a lane outside the chunk passes key -1 and v 0. A
// run whose total is 0 (all its lanes unset) adds nothing.
template <typename Add>
__device__ __forceinline__ void warp_run_add(int key, float v, Add add) {
  const unsigned full = 0xffffffffu;
  const int lane = threadIdx.x & 31;
  const int prev = __shfl_up_sync(full, key, 1);
  const bool head = lane == 0 || prev != key;
  const unsigned heads = __ballot_sync(full, head);
  const unsigned later = lane == 31 ? 0u : heads >> (lane + 1);
  const int end = later ? lane + __ffs(later) - 1 : 31;  // last lane of the run
  for (int off = 1; off < 32; off <<= 1) {
    const float o = __shfl_down_sync(full, v, off);
    if (lane + off <= end) v += o;
  }
  if (head && key >= 0 && v != 0.f) add(key, v);
}

// One pass over a chunk's lanes, all threads of the CTA in step (blockDim is
// a multiple of 32, so every warp is whole in every step).
template <typename XLoad, typename Add>
__device__ __forceinline__ void chunk_lanes(size_t lane0, int lanes, const signed char* valid,
                                            const void* vidx, const void* xcol, const void* yrow,
                                            int wv, int wx, int wy, const float* vwin,
                                            XLoad xload, Add add) {
  for (int i0 = 0; i0 < lanes; i0 += blockDim.x) {
    const int i = i0 + threadIdx.x;
    int key = -1;
    float v = 0.f;
    if (i < lanes) {
      const size_t l = lane0 + i;
      key = load_index(yrow, l, wy);
      if (__ldg(valid + l)) v = vwin[load_index(vidx, l, wv)] * xload(load_index(xcol, l, wx));
    }
    warp_run_add(key, v, add);
  }
}

// ---------------------------------------------------------------------------
// whole-vector layout: grid-stride over chunks, global atomics into y
// ---------------------------------------------------------------------------
template <int kStages>
__global__ void __launch_bounds__(256)
spmv_desc_whole_kernel(const int* __restrict__ chunk_vbase, const signed char* __restrict__ valid,
                       const void* __restrict__ vidx, const void* __restrict__ xcol,
                       const void* __restrict__ yrow, const float* __restrict__ values,
                       const float* __restrict__ x, float* __restrict__ y, int nchunks,
                       int lanes, int vmax, int wv, int wx, int wy) {
  extern __shared__ __align__(16) float smem[];
  int ch = blockIdx.x;
  if (ch >= nchunks) return;
  if (kStages == 2) {
    stage<true>(smem, values + chunk_vbase[ch], vmax);
    cp_async_commit();
  }
  for (int it = 0; ch < nchunks; ch += gridDim.x, ++it) {
    float* vwin = smem;
    if (kStages == 2) {
      vwin = smem + (it & 1) * vmax;
      const int nxt = ch + gridDim.x;
      if (nxt < nchunks) stage<true>(smem + ((it + 1) & 1) * vmax, values + chunk_vbase[nxt], vmax);
      cp_async_commit();   // possibly empty: keeps the group count uniform
      cp_async_wait<1>();  // everything but the prefetch just issued
    } else {
      stage<false>(vwin, values + chunk_vbase[ch], vmax);
    }
    __syncthreads();
    chunk_lanes(
        (size_t)ch * lanes, lanes, valid, vidx, xcol, yrow, wv, wx, wy, vwin,
        [&](int col) { return __ldg(x + col); },
        [&](int row, float s) { atomicAdd(y + row, s); });
    __syncthreads();  // the window is overwritten by the next stage
  }
}

// ---------------------------------------------------------------------------
// panel layout: S CTAs per panel, staged tables, (pr,) y tile per CTA
// ---------------------------------------------------------------------------

struct PanelArgs {
  const int* vbase;  // (npanels, nchunks) value window starts
  const int* xbase;  // (npanels, nchunks) x window starts
  const signed char* valid;
  const char* vidx;  // the index tables, as bytes (entries wv, wx, wy wide)
  const char* xcol;
  const char* yrow;
  const float* values;
  const float* xpad;
  float* y;
  int nchunks, cb, r, c, vmax, xw, pr, nrows, wv, wx, wy;
  int split;  // S: CTAs per panel, each a contiguous range of its chunks
  int nb;     // blocks whose tables one stage holds (cb, or a slice of it)
};

__host__ __device__ inline int round16(int n) { return (n + 15) & ~15; }

// Byte offsets of one stage's parts, each 16-byte aligned: the value window,
// the x window, then for nb blocks the valid and vidx runs, the c xcol
// entries of each block's first row and each block's lane-0 yrow entry in a
// 4-byte slot. The y tile (pr floats) comes before the first stage. The
// wrapper plans with its copy (kernels/spc5_spmv_desc.py: panels_smem_bytes)
// and passes its figure in; a launch whose figure differs is refused, and
// spc5_spmv_desc_panels_smem exposes this one for the wrapper's tests.
struct StageLayout {
  int vwin, xwin, valid, vidx, xcol, yrow, bytes;
};

__host__ __device__ inline StageLayout stage_layout(const PanelArgs& a) {
  const int rc = a.r * a.c;
  StageLayout L;
  L.vwin = 0;
  L.xwin = L.vwin + round16(4 * a.vmax);
  L.valid = L.xwin + round16(4 * a.xw);
  L.vidx = L.valid + round16(a.nb * rc);
  L.xcol = L.vidx + round16(a.nb * rc * a.wv);
  L.yrow = L.xcol + round16(a.nb * a.c * a.wx);
  L.bytes = L.yrow + round16(4 * a.nb);
  return L;
}

inline size_t panels_smem(const PanelArgs& a, int stages) {
  return (size_t)round16(4 * a.pr) + (size_t)stages * stage_layout(a).bytes;
}

// Copy runs x run_bytes bytes, run j starting at src + j * stride, into dst
// back to back, with all threads of the CTA: in 16-byte pieces where src,
// run_bytes and stride allow, else in 4-byte pieces (every run here is a
// multiple of 4 bytes at a 4-byte aligned address; dst is 16-byte aligned).
// kAsync: cp.async, completed by the caller's wait. Otherwise vector loads,
// up to four pieces in flight per thread before their stores.
template <bool kAsync>
__device__ __forceinline__ void copy_runs(unsigned char* dst, const char* src, int runs,
                                          int run_bytes, int stride) {
  const bool wide = ((reinterpret_cast<uintptr_t>(src) | run_bytes | stride) & 15) == 0;
  const int sz = wide ? 16 : 4;
  const int q = run_bytes / sz;  // pieces per run
  const int n = runs * q;
  auto from = [&](int j) {
    return runs == 1 ? src + (size_t)j * sz : src + (size_t)(j / q) * stride + (j % q) * sz;
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

// Stage the tables of blocks [b0, b0 + nb) of global chunk g (and, where
// windows is set, its value window at vb and its x window at xb).
template <bool kAsync>
__device__ __forceinline__ void stage_chunk(unsigned char* st, const StageLayout& L,
                                            const PanelArgs& a, size_t g, int b0, int nb,
                                            bool windows, int vb, int xb) {
  const int rc = a.r * a.c;
  const size_t lane0 = (g * a.cb + b0) * rc;
  if (windows) {
    copy_runs<kAsync>(st + L.vwin, reinterpret_cast<const char*>(a.values + vb), 1, 4 * a.vmax, 0);
    copy_runs<kAsync>(st + L.xwin, reinterpret_cast<const char*>(a.xpad + xb), 1, 4 * a.xw, 0);
  }
  copy_runs<kAsync>(st + L.valid, reinterpret_cast<const char*>(a.valid) + lane0, 1, nb * rc, 0);
  copy_runs<kAsync>(st + L.vidx, a.vidx + lane0 * a.wv, 1, nb * rc * a.wv, 0);
  // xcol[k] == xcol[k % c]: the c entries of each block's first row
  copy_runs<kAsync>(st + L.xcol, a.xcol + lane0 * a.wx, nb, a.c * a.wx, rc * a.wx);
  // yrow[k] == yrow[0] + k / c: the 4-byte word holding each block's lane-0
  // entry (r*c >= 4, so the word is aligned and inside the block's entries)
  copy_runs<kAsync>(st + L.yrow, a.yrow + lane0 * a.wy, nb, 4, rc * a.wy);
}

// Entries 4q .. 4q + 3 of a narrow index table in shared memory, with one
// 4-, 8- or 16-byte load (the table starts 16-byte aligned).
__device__ __forceinline__ void smem_index4(const unsigned char* t, int q, int width,
                                            int out[4]) {
  if (width == 1) {
    const int w = reinterpret_cast<const int*>(t)[q];
    out[0] = (int)(signed char)w;
    out[1] = (int)(signed char)(w >> 8);
    out[2] = (int)(signed char)(w >> 16);
    out[3] = w >> 24;
  } else if (width == 2) {
    const int2 w = reinterpret_cast<const int2*>(t)[q];
    out[0] = (int)(short)w.x;
    out[1] = w.x >> 16;
    out[2] = (int)(short)w.y;
    out[3] = w.y >> 16;
  } else {
    const int4 w = reinterpret_cast<const int4*>(t)[q];
    out[0] = w.x;
    out[1] = w.y;
    out[2] = w.z;
    out[3] = w.w;
  }
}

// Add the nb staged blocks into the y tile. Thread t takes lane quads t,
// t + blockDim, ...: lanes 4q .. 4q + 3, which lie in one block row (c is 4
// or 8), so one 4-byte word holds their valid flags and one load each their
// vidx and xcol entries; a quad with no flag set gathers nothing. For c = 8
// the two quads of a row (neighbouring threads) are summed with one xor
// shuffle; the row's first quad adds it into the tile.
__device__ __forceinline__ void decode_stage(const unsigned char* st, const StageLayout& L,
                                             const PanelArgs& a, int nb, int lrc, int lc,
                                             float* ytile) {
  const float* vwin = reinterpret_cast<const float*>(st + L.vwin);
  const float* xwin = reinterpret_cast<const float*>(st + L.xwin);
  const int* flags4 = reinterpret_cast<const int*>(st + L.valid);
  const int* yword = reinterpret_cast<const int*>(st + L.yrow);
  const int rc = 1 << lrc, c = 1 << lc;
  const int quads = (nb << lrc) >> 2;
  for (int q0 = 0; q0 < quads; q0 += blockDim.x) {
    const int q = q0 + threadIdx.x;
    const bool live = q < quads;  // whole rows: quads per row (1 or 2) divide 32
    const int b = (q << 2) >> lrc, k = (q << 2) & (rc - 1);
    const int flags = live ? flags4[q] : 0;
    float v = 0.f;
    if (flags) {
      int vi[4], xc[4];
      smem_index4(st + L.vidx, q, a.wv, vi);
      smem_index4(st + L.xcol, ((b << lc) + (k & (c - 1))) >> 2, a.wx, xc);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        if ((flags >> (8 * u)) & 0xff) v += vwin[vi[u]] * xwin[xc[u]];
      }
    }
    if (c == 8) v += __shfl_xor_sync(0xffffffffu, v, 1);
    if (live && (k & (c - 1)) == 0 && v != 0.f) {
      const int w = yword[b];
      const int row = a.wy == 1 ? (int)(signed char)w : a.wy == 2 ? (int)(short)w : w;
      atomicAdd(ytile + row + (k >> lc), v);
    }
  }
}

template <int kStages>
__global__ void __launch_bounds__(256) spmv_desc_panels_kernel(const PanelArgs a) {
  extern __shared__ __align__(16) float smem[];  // one name and type per file
  const StageLayout L = stage_layout(a);
  float* ytile = smem;
  unsigned char* ring = reinterpret_cast<unsigned char*>(smem) + round16(4 * a.pr);
  const int lrc = __ffs(a.r * a.c) - 1, lc = __ffs(a.c) - 1;
  const int p = blockIdx.x / a.split;
  const int part = blockIdx.x - p * a.split;
  const int c0 = (int)((long long)part * a.nchunks / a.split);
  const int n = (int)((long long)(part + 1) * a.nchunks / a.split) - c0;
  const size_t g0 = (size_t)p * a.nchunks + c0;  // global index of the range's first chunk
  const int* vbase = a.vbase + g0;
  const int* xbase = a.xbase + g0;
  for (int i = threadIdx.x; i < a.pr; i += blockDim.x) ytile[i] = 0.f;

  if constexpr (kStages == 1) {
    int vb = n > 0 ? __ldg(vbase) : 0, xb = n > 0 ? __ldg(xbase) : 0;
    for (int j = 0; j < n; ++j) {
      const int vj = vb, xj = xb;
      if (j + 1 < n) {  // the next chunk's window starts, in flight during this one
        vb = __ldg(vbase + j + 1);
        xb = __ldg(xbase + j + 1);
      }
      for (int b0 = 0; b0 < a.cb; b0 += a.nb) {
        const int nb = min(a.nb, a.cb - b0);
        __syncthreads();  // the previous decode (or the tile's zeroing) is done
        stage_chunk<false>(ring, L, a, g0 + j, b0, nb, b0 == 0, vj, xj);
        __syncthreads();
        decode_stage(ring, L, a, nb, lrc, lc, ytile);
      }
    }
  } else {
    // the ring: chunk j lives in stage j % kStages; kStages - 1 chunks are
    // in flight while one decodes
    for (int s = 0; s < kStages - 1; ++s) {
      if (s < n) {
        stage_chunk<true>(ring + s * L.bytes, L, a, g0 + s, 0, a.cb, true, __ldg(vbase + s),
                          __ldg(xbase + s));
      }
      cp_async_commit();
    }
    int vb = 0, xb = 0;  // window starts of the next chunk to stage
    if (kStages - 1 < n) {
      vb = __ldg(vbase + kStages - 1);
      xb = __ldg(xbase + kStages - 1);
    }
    for (int j = 0; j < n; ++j) {
      cp_async_wait<kStages - 2>();  // chunk j has landed (this thread's copies)
      __syncthreads();               // ... everyone's; chunk j - 1's stage is free
      const int jn = j + kStages - 1;
      if (jn < n) {
        stage_chunk<true>(ring + (jn % kStages) * L.bytes, L, a, g0 + jn, 0, a.cb, true, vb, xb);
      }
      cp_async_commit();  // possibly empty: keeps the group count uniform
      if (jn + 1 < n) {
        vb = __ldg(vbase + jn + 1);
        xb = __ldg(xbase + jn + 1);
      }
      decode_stage(ring + (j % kStages) * L.bytes, L, a, a.cb, lrc, lc, ytile);
    }
  }
  __syncthreads();
  const int row0 = p * a.pr;
  const int nout = min(a.pr, a.nrows - row0);
  for (int i = threadIdx.x; i < nout; i += blockDim.x) {
    const float t = ytile[i];
    if (a.split == 1) {
      a.y[row0 + i] = t;
    } else if (t != 0.f) {
      atomicAdd(a.y + row0 + i, t);
    }
  }
}

template <int kStages>
int launch_whole(const int* vbase, const signed char* valid, const void* vidx, const void* xcol,
                 const void* yrow, const float* values, const float* x, float* y, int nchunks,
                 int lanes, int vmax, int wv, int wx, int wy, int threads, int device,
                 void* stream) {
  const size_t smem = (size_t)kStages * vmax * sizeof(float);
  int ctas = 0;
  cudaError_t err = prepare_launch(spmv_desc_whole_kernel<kStages>, device, smem, threads, &ctas);
  if (err != cudaSuccess) return (int)err;
  const int grid = nchunks < ctas ? nchunks : ctas;
  spmv_desc_whole_kernel<kStages><<<grid, threads, smem, (cudaStream_t)stream>>>(
      vbase, valid, vidx, xcol, yrow, values, x, y, nchunks, lanes, vmax, wv, wx, wy);
  return (int)cudaGetLastError();
}

template <int kStages>
int launch_panels(const PanelArgs& a, int npanels, int smem_planned, int threads, int device,
                  void* stream) {
  const size_t smem = panels_smem(a, kStages);
  if (a.split < 1 || a.nb < 1 || a.nb > a.cb || (long long)npanels * a.split > 0x7fffffffLL ||
      smem != (size_t)smem_planned) {
    return (int)cudaErrorInvalidValue;
  }
  cudaError_t err = prepare_launch(spmv_desc_panels_kernel<kStages>, device, smem, threads, nullptr);
  if (err != cudaSuccess) return (int)err;
  spmv_desc_panels_kernel<kStages>
      <<<npanels * a.split, threads, smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

template <int kStages>
int panels_occupancy(int threads, int smem, int device, int* out) {
  cudaError_t err =
      prepare_launch(spmv_desc_panels_kernel<kStages>, device, (size_t)smem, threads, nullptr);
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(out, spmv_desc_panels_kernel<kStages>,
                                                        threads, (size_t)smem);
  }
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(out + 1, cudaDevAttrMultiProcessorCount, device);
  return (int)err;
}

PanelArgs panel_args(const int* vbase, const int* xbase, const signed char* valid,
                     const void* vidx, const void* xcol, const void* yrow, const float* values,
                     const float* xpad, float* y, int nchunks, int cb, int r, int c, int vmax,
                     int xw, int pr, int nrows, int wv, int wx, int wy, int split, int nb) {
  return PanelArgs{vbase,  xbase, valid, static_cast<const char*>(vidx),
                   static_cast<const char*>(xcol), static_cast<const char*>(yrow),
                   values, xpad,  y,     nchunks, cb, r, c, vmax, xw, pr, nrows, wv, wx, wy,
                   split,  nb};
}

}  // namespace

extern "C" {

int spc5_spmv_desc_whole_s1(const int* vbase, const signed char* valid, const void* vidx,
                            const void* xcol, const void* yrow, const float* values,
                            const float* x, float* y, int nchunks, int lanes, int vmax, int wv,
                            int wx, int wy, int threads, int device, void* stream) {
  return launch_whole<1>(vbase, valid, vidx, xcol, yrow, values, x, y, nchunks, lanes, vmax, wv,
                         wx, wy, threads, device, stream);
}

int spc5_spmv_desc_whole_s2(const int* vbase, const signed char* valid, const void* vidx,
                            const void* xcol, const void* yrow, const float* values,
                            const float* x, float* y, int nchunks, int lanes, int vmax, int wv,
                            int wx, int wy, int threads, int device, void* stream) {
  return launch_whole<2>(vbase, valid, vidx, xcol, yrow, values, x, y, nchunks, lanes, vmax, wv,
                         wx, wy, threads, device, stream);
}

// The synchronous panel kernel: nb blocks' tables per stage (nb == cb
// unless a whole chunk's tables do not fit), split CTAs per panel. smem is
// the wrapper's figure for the CTA's dynamic shared memory (checked).
int spc5_spmv_desc_panels_s1(const int* vbase, const int* xbase, const signed char* valid,
                             const void* vidx, const void* xcol, const void* yrow,
                             const float* values, const float* xpad, float* y, int npanels,
                             int nchunks, int cb, int r, int c, int vmax, int xw, int pr,
                             int nrows, int wv, int wx, int wy, int split, int nb, int smem,
                             int threads, int device, void* stream) {
  const PanelArgs a = panel_args(vbase, xbase, valid, vidx, xcol, yrow, values, xpad, y, nchunks,
                                 cb, r, c, vmax, xw, pr, nrows, wv, wx, wy, split, nb);
  return launch_panels<1>(a, npanels, smem, threads, device, stream);
}

// The staged-ahead panel kernel: a ring of `stages` whole chunks, 3 or, where
// three do not fit, 2.
int spc5_spmv_desc_panels_s2(const int* vbase, const int* xbase, const signed char* valid,
                             const void* vidx, const void* xcol, const void* yrow,
                             const float* values, const float* xpad, float* y, int npanels,
                             int nchunks, int cb, int r, int c, int vmax, int xw, int pr,
                             int nrows, int wv, int wx, int wy, int split, int stages, int smem,
                             int threads, int device, void* stream) {
  const PanelArgs a = panel_args(vbase, xbase, valid, vidx, xcol, yrow, values, xpad, y, nchunks,
                                 cb, r, c, vmax, xw, pr, nrows, wv, wx, wy, split, cb);
  switch (stages) {
    case 2: return launch_panels<2>(a, npanels, smem, threads, device, stream);
    case 3: return launch_panels<3>(a, npanels, smem, threads, device, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The panel kernel's occupancy at `stages` (1: the synchronous kernel),
// `threads` and `smem` bytes of dynamic shared memory per CTA: out[0] the
// CTAs one SM holds at once, out[1] the SMs of the device.
int spc5_spmv_desc_panels_occupancy(int stages, int threads, int smem, int device, int* out) {
  switch (stages) {
    case 1: return panels_occupancy<1>(threads, smem, device, out);
    case 2: return panels_occupancy<2>(threads, smem, device, out);
    case 3: return panels_occupancy<3>(threads, smem, device, out);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The dynamic shared memory of one panel-kernel CTA with `stages` stages of
// nb blocks each, as the launch computes it (stage_layout).
int spc5_spmv_desc_panels_smem(int stages, int nb, int r, int c, int vmax, int xw, int pr,
                               int wv, int wx) {
  PanelArgs a{};
  a.nb = nb;
  a.r = r;
  a.c = c;
  a.vmax = vmax;
  a.xw = xw;
  a.pr = pr;
  a.wv = wv;
  a.wx = wx;
  return (int)panels_smem(a, stages);
}

}  // extern "C"
