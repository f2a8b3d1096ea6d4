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
// nonzero), x and y are read or written once. Two flops per nonzero. What
// the design does about it:
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
//     shuffles first, and each such run adds once: one add per block row
//     instead of one per lane. The runs are found from the yrow table alone;
//   * whole-vector: CTAs walk chunks in a grid-stride loop and add into a
//     zeroed y with global atomicAdd (neighbouring chunks can share rows),
//     so the f32 sum order varies from run to run;
//   * panels: one CTA per panel holds the (pr,) y tile in shared memory,
//     adds into it with shared-memory atomics and writes each row once; the
//     xw-wide x window is staged beside the value window.
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
// panel layout: one CTA per panel, (pr,) y tile in shared memory
// ---------------------------------------------------------------------------
template <int kStages>
__global__ void __launch_bounds__(256)
spmv_desc_panels_kernel(const int* __restrict__ chunk_vbase, const int* __restrict__ chunk_xbase,
                        const signed char* __restrict__ valid, const void* __restrict__ vidx,
                        const void* __restrict__ xcol, const void* __restrict__ yrow,
                        const float* __restrict__ values, const float* __restrict__ xpad,
                        float* __restrict__ y, int nchunks, int lanes, int vmax, int xw, int pr,
                        int nrows, int wv, int wx, int wy) {
  // layout: kStages value windows, kStages x windows, then the y tile (the
  // windows are multiples of 8 floats, so each stays 16-byte aligned)
  extern __shared__ __align__(16) float smem[];
  float* vwins = smem;
  float* xwins = smem + kStages * vmax;
  float* ytile = xwins + kStages * xw;
  const int p = blockIdx.x;
  const int* vbase = chunk_vbase + (size_t)p * nchunks;
  const int* xbase = chunk_xbase + (size_t)p * nchunks;
  for (int i = threadIdx.x; i < pr; i += blockDim.x) ytile[i] = 0.f;
  if (kStages == 2) {
    stage<true>(vwins, values + vbase[0], vmax);
    stage<true>(xwins, xpad + xbase[0], xw);
    cp_async_commit();
  }
  for (int i = 0; i < nchunks; ++i) {
    float* vwin = vwins;
    float* xwin = xwins;
    if (kStages == 2) {
      vwin = vwins + (i & 1) * vmax;
      xwin = xwins + (i & 1) * xw;
      if (i + 1 < nchunks) {
        const int nb = (i + 1) & 1;
        stage<true>(vwins + nb * vmax, values + vbase[i + 1], vmax);
        stage<true>(xwins + nb * xw, xpad + xbase[i + 1], xw);
      }
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      stage<false>(vwin, values + vbase[i], vmax);
      stage<false>(xwin, xpad + xbase[i], xw);
    }
    __syncthreads();  // also orders the y tile's zeroing before the first add
    chunk_lanes(
        ((size_t)p * nchunks + i) * lanes, lanes, valid, vidx, xcol, yrow, wv, wx, wy, vwin,
        [&](int col) { return xwin[col]; },
        [&](int row, float s) { atomicAdd(ytile + row, s); });
    __syncthreads();
  }
  const int row0 = p * pr;
  const int nout = min(pr, nrows - row0);
  for (int i = threadIdx.x; i < nout; i += blockDim.x) y[row0 + i] = ytile[i];
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
int launch_panels(const int* vbase, const int* xbase, const signed char* valid, const void* vidx,
                  const void* xcol, const void* yrow, const float* values, const float* xpad,
                  float* y, int npanels, int nchunks, int lanes, int vmax, int xw, int pr,
                  int nrows, int wv, int wx, int wy, int threads, int device, void* stream) {
  const size_t smem = (size_t)kStages * (vmax + xw) * sizeof(float) + (size_t)pr * sizeof(float);
  cudaError_t err = prepare_launch(spmv_desc_panels_kernel<kStages>, device, smem, threads, nullptr);
  if (err != cudaSuccess) return (int)err;
  spmv_desc_panels_kernel<kStages><<<npanels, threads, smem, (cudaStream_t)stream>>>(
      vbase, xbase, valid, vidx, xcol, yrow, values, xpad, y, nchunks, lanes, vmax, xw, pr, nrows,
      wv, wx, wy);
  return (int)cudaGetLastError();
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

int spc5_spmv_desc_panels_s1(const int* vbase, const int* xbase, const signed char* valid,
                             const void* vidx, const void* xcol, const void* yrow,
                             const float* values, const float* xpad, float* y, int npanels,
                             int nchunks, int lanes, int vmax, int xw, int pr, int nrows, int wv,
                             int wx, int wy, int threads, int device, void* stream) {
  return launch_panels<1>(vbase, xbase, valid, vidx, xcol, yrow, values, xpad, y, npanels,
                          nchunks, lanes, vmax, xw, pr, nrows, wv, wx, wy, threads, device,
                          stream);
}

int spc5_spmv_desc_panels_s2(const int* vbase, const int* xbase, const signed char* valid,
                             const void* vidx, const void* xcol, const void* yrow,
                             const float* values, const float* xpad, float* y, int npanels,
                             int nchunks, int lanes, int vmax, int xw, int pr, int nrows, int wv,
                             int wx, int wy, int threads, int device, void* stream) {
  return launch_panels<2>(vbase, xbase, valid, vidx, xcol, yrow, values, xpad, y, npanels,
                          nchunks, lanes, vmax, xw, pr, nrows, wv, wx, wy, threads, device,
                          stream);
}

}  // extern "C"
