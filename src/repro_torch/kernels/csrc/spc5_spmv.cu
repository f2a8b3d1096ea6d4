// SPC5 mask-decode SpMV for Hopper (sm_90a): beta(r,c) blocks with bit masks
// and no zero padding, over the two chunked layouts of
// repro_torch/core/formats.py.
//
// Replaces the four Pallas TPU kernels of src/repro/kernels/spc5_spmv.py:
//   spc5_spmv_whole_s1   <- spmv_pallas           (_spmv_kernel)
//   spc5_spmv_whole_s2   <- spmv_pallas_db        (_spmv_db_kernel)
//   spc5_spmv_panels_s1  <- spmv_pallas_panels    (_spmv_panel_kernel)
//   spc5_spmv_panels_s2  <- spmv_pallas_panels_db (_spmv_panel_db_kernel)
// All four share one decode, the counterpart of _decode_chunk: mask bits ->
// running rank -> value from the staged window -> times x -> add into y.
//
// Bound: memory. One SpMV reads each packed f32 value once (4 B per nonzero)
// plus 16 B of chunk metadata per block slot (col, mask, voff, row), x once
// and writes y once; it does 2 flops per nonzero, far below the card's
// f32 rate per byte. What the design does about it:
//   * values are staged per chunk into shared memory with 16-byte copies
//     (vbase and vmax are multiples of 8 values, so every window is
//     16-byte aligned and whole float4s); kStages == 2 prefetches the next
//     chunk's window with cp.async while the current one decodes, the
//     counterpart of the Pallas double buffer;
//   * block metadata is read once, one thread per block slot, so neighbouring
//     threads read neighbouring words;
//   * unset lanes are skipped (the Pallas kernels clip their indices and
//     multiply by 0 instead), so no x or y element outside the matrix is
//     touched and a lane costs nothing unless its bit is set;
//   * whole-vector: chunks are cut every cb blocks whatever the row interval,
//     so neighbouring chunks can share y rows; CTAs walk chunks in a
//     grid-stride loop and add into a zeroed y with one global atomicAdd per
//     (block, row) that has a nonzero. The f32 sum order therefore varies
//     from run to run;
//   * panels: one CTA owns one panel's pr rows (pr is a multiple of r, so no
//     block straddles two panels), keeps the (pr,) y tile in shared memory,
//     adds into it with shared-memory atomics and writes it once; the xw-wide
//     x window is staged beside the value window (both double-buffered for
//     kStages == 2). No global atomics.
//
// Each launcher runs on the caller's stream, allocates nothing, does not
// synchronise, and returns cudaGetLastError() (0 on success).

#include "spc5_stage.cuh"

namespace {

// Decode one block: for each local row with a set bit, the dot product of
// its packed values with x, handed to add(row, sum). Bits are walked in
// order, so the running rank v is the exclusive popcount of the bits below.
template <typename XLoad, typename Add>
__device__ __forceinline__ void decode_block(uint32_t mask, const float* vwin,
                                             int voff, int r, int c,
                                             XLoad xload, Add add) {
  // c <= 8 and r * c <= 32, so every shift below is in range
  const uint32_t row_mask = (1u << c) - 1u;
  int v = voff;
  for (int lr = 0; lr < r; ++lr) {
    const uint32_t rowbits = (mask >> (lr * c)) & row_mask;
    if (rowbits == 0u) continue;
    float acc = 0.f;
    for (int lc = 0; lc < c; ++lc) {
      if ((rowbits >> lc) & 1u) acc = fmaf(vwin[v++], xload(lc), acc);
    }
    add(lr, acc);
  }
}

// ---------------------------------------------------------------------------
// whole-vector layout: grid-stride over chunks, global atomics into y
// ---------------------------------------------------------------------------
template <int kStages>
__global__ void __launch_bounds__(256)
spmv_whole_kernel(const int* __restrict__ chunk_vbase, const int* __restrict__ chunk_col,
                  const uint32_t* __restrict__ chunk_mask, const int* __restrict__ chunk_voff,
                  const int* __restrict__ chunk_row, const float* __restrict__ values,
                  const float* __restrict__ x, float* __restrict__ y, int nchunks, int cb,
                  int vmax, int r, int c) {
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
      cp_async_commit();  // possibly empty: keeps the group count uniform
      cp_async_wait<1>();  // everything but the prefetch just issued
    } else {
      stage<false>(vwin, values + chunk_vbase[ch], vmax);
    }
    __syncthreads();
    for (int b = threadIdx.x; b < cb; b += blockDim.x) {
      const size_t slot = (size_t)ch * cb + b;
      const uint32_t mask = chunk_mask[slot];
      if (mask == 0u) continue;  // padding block
      const int col = chunk_col[slot];
      const int row = chunk_row[slot];
      decode_block(
          mask, vwin, chunk_voff[slot], r, c, [&](int lc) { return __ldg(x + col + lc); },
          [&](int lr, float s) { atomicAdd(y + row + lr, s); });
    }
    __syncthreads();  // the window is overwritten by the next stage
  }
}

// ---------------------------------------------------------------------------
// panel layout: one CTA per panel, (pr,) y tile in shared memory
// ---------------------------------------------------------------------------
template <int kStages>
__global__ void __launch_bounds__(256)
spmv_panels_kernel(const int* __restrict__ chunk_vbase, const int* __restrict__ chunk_xbase,
                   const int* __restrict__ chunk_col, const uint32_t* __restrict__ chunk_mask,
                   const int* __restrict__ chunk_voff, const int* __restrict__ chunk_row,
                   const float* __restrict__ values, const float* __restrict__ xpad,
                   float* __restrict__ y, int nchunks, int cb, int vmax, int xw, int pr,
                   int nrows, int r, int c) {
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
    const size_t chunk0 = ((size_t)p * nchunks + i) * cb;
    for (int b = threadIdx.x; b < cb; b += blockDim.x) {
      const size_t slot = chunk0 + b;
      const uint32_t mask = chunk_mask[slot];
      if (mask == 0u) continue;  // padding block or padding chunk
      const int col = chunk_col[slot];
      const int row = chunk_row[slot];
      decode_block(
          mask, vwin, chunk_voff[slot], r, c, [&](int lc) { return xwin[col + lc]; },
          [&](int lr, float s) { atomicAdd(ytile + row + lr, s); });
    }
    __syncthreads();
  }
  const int row0 = p * pr;
  const int nout = min(pr, nrows - row0);
  for (int i = threadIdx.x; i < nout; i += blockDim.x) y[row0 + i] = ytile[i];
}

template <int kStages>
int launch_whole(const int* vbase, const int* col, const uint32_t* mask, const int* voff,
                 const int* row, const float* values, const float* x, float* y, int nchunks,
                 int cb, int vmax, int r, int c, int threads, int device, void* stream) {
  const size_t smem = (size_t)kStages * vmax * sizeof(float);
  int ctas = 0;
  cudaError_t err = prepare_launch(spmv_whole_kernel<kStages>, device, smem, threads, &ctas);
  if (err != cudaSuccess) return (int)err;
  const int grid = nchunks < ctas ? nchunks : ctas;
  spmv_whole_kernel<kStages><<<grid, threads, smem, (cudaStream_t)stream>>>(
      vbase, col, mask, voff, row, values, x, y, nchunks, cb, vmax, r, c);
  return (int)cudaGetLastError();
}

template <int kStages>
int launch_panels(const int* vbase, const int* xbase, const int* col, const uint32_t* mask,
                  const int* voff, const int* row, const float* values, const float* xpad,
                  float* y, int npanels, int nchunks, int cb, int vmax, int xw, int pr,
                  int nrows, int r, int c, int threads, int device, void* stream) {
  const size_t smem = (size_t)kStages * (vmax + xw) * sizeof(float) + (size_t)pr * sizeof(float);
  cudaError_t err = prepare_launch(spmv_panels_kernel<kStages>, device, smem, threads, nullptr);
  if (err != cudaSuccess) return (int)err;
  spmv_panels_kernel<kStages><<<npanels, threads, smem, (cudaStream_t)stream>>>(
      vbase, xbase, col, mask, voff, row, values, xpad, y, nchunks, cb, vmax, xw, pr, nrows, r,
      c);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int spc5_spmv_whole_s1(const int* vbase, const int* col, const uint32_t* mask, const int* voff,
                       const int* row, const float* values, const float* x, float* y,
                       int nchunks, int cb, int vmax, int r, int c, int threads, int device,
                       void* stream) {
  return launch_whole<1>(vbase, col, mask, voff, row, values, x, y, nchunks, cb, vmax, r, c,
                         threads, device, stream);
}

int spc5_spmv_whole_s2(const int* vbase, const int* col, const uint32_t* mask, const int* voff,
                       const int* row, const float* values, const float* x, float* y,
                       int nchunks, int cb, int vmax, int r, int c, int threads, int device,
                       void* stream) {
  return launch_whole<2>(vbase, col, mask, voff, row, values, x, y, nchunks, cb, vmax, r, c,
                         threads, device, stream);
}

int spc5_spmv_panels_s1(const int* vbase, const int* xbase, const int* col, const uint32_t* mask,
                        const int* voff, const int* row, const float* values, const float* xpad,
                        float* y, int npanels, int nchunks, int cb, int vmax, int xw, int pr,
                        int nrows, int r, int c, int threads, int device, void* stream) {
  return launch_panels<1>(vbase, xbase, col, mask, voff, row, values, xpad, y, npanels, nchunks,
                          cb, vmax, xw, pr, nrows, r, c, threads, device, stream);
}

int spc5_spmv_panels_s2(const int* vbase, const int* xbase, const int* col, const uint32_t* mask,
                        const int* voff, const int* row, const float* values, const float* xpad,
                        float* y, int npanels, int nchunks, int cb, int vmax, int xw, int pr,
                        int nrows, int r, int c, int threads, int device, void* stream) {
  return launch_panels<2>(vbase, xbase, col, mask, voff, row, values, xpad, y, npanels, nchunks,
                          cb, vmax, xw, pr, nrows, r, c, threads, device, stream);
}

}  // extern "C"
