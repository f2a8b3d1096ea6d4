// SPC5 mask-decode SpMM for Hopper (sm_90a): Y = A @ X with A in beta(r,c)
// blocks with bit masks and no zero padding, over the two chunked layouts of
// repro_torch/core/formats.py. X is (ncols, nvec) and Y (nrows, nvec), both
// row-major f32, the reference's layout.
//
// Replaces the three Pallas TPU mask-SpMM kernels of
// src/repro/kernels/spc5_spmm.py:
//   spc5_spmm_whole      <- spmm_pallas            (_spmm_kernel)
//   spc5_spmm_panels_s1  <- spmm_pallas_panels     (_spmm_panel_kernel)
//   spc5_spmm_panels_s2  <- spmm_pallas_panels_db  (_spmm_panel_db_kernel)
//
// Work split. The columns of X and Y go to lanes: a warp is cut into groups
// of tw lanes (tw a power of two, at most 32, picked by the wrapper), and
// lane l of a group owns column tile * tw + l, so neighbouring lanes read
// neighbouring words of one X row and add into neighbouring words of one Y
// row. Column tiles are on the grid, beside the chunk (whole-vector) or the
// panel: blockIdx.x = unit * ntiles + tile, so the CTAs of one unit run
// side by side and share its bytes through L2. In a CTA each group walks a
// contiguous run of the staged chunk's blocks, decodes each block's mask
// once (the control flow is uniform within the group) and applies each
// packed value to all tw columns. The decode walks only the set bits with a
// running rank, as the SpMV kernels do, so no row or column outside the
// matrix is touched.
//
// Bound. The work is 2 flops per nonzero and column, and the bytes are the
// plan's (4 B per packed value, 16 B of metadata per block slot) plus X and
// Y once each: at small nvec the bytes bind, at nvec = 128 the f32 rate. In
// practice each nonzero also reads tw words of X through L1/L2, one load
// per multiply-add. What the design does about it:
//   * the chunk's value window and metadata are staged once per CTA with
//     16-byte (values) and 4-byte (metadata) copies and shared by all of its
//     groups; kStages == 2 prefetches the next chunk's with cp.async while
//     the current one decodes, the counterpart of the Pallas double buffer;
//   * X is read through the read-only path, coalesced across the group. The
//     Pallas kernels keep X resident (whole-vector) or stage an (xw, nvt)
//     slab per chunk (panels); at the reference's pr = xw = 512 and nvt = 128
//     that is 786 KB per CTA against 227 KB, and a chunk of a sparse panel
//     uses far fewer X rows than the xw it would stage, so no slab is staged;
//   * whole-vector: to_chunked walks blocks in row-interval order, so a
//     group's run of blocks spans few intervals. Each (row, column) is
//     summed in registers while the interval is unchanged and flushed with
//     one global atomicAdd when it changes (into a zeroed Y), not one atomic
//     per block. The f32 sum order varies from run to run;
//   * panels: one CTA owns one panel's pr rows (pr is a multiple of r) and
//     one column tile, keeps the (pr, tw) Y tile in shared memory, adds into
//     it with shared-memory atomics at the same interval changes, and writes
//     it once. No global atomics.
//
// Each launcher runs on the caller's stream, allocates nothing, does not
// synchronise, and returns cudaGetLastError() (0 on success).

#include "spc5_stage.cuh"

namespace {

constexpr int kThreads = 256;

// Stage one chunk: its value window and its four metadata rows
// (col, mask, voff, row; cb words each).
template <bool kAsync>
__device__ __forceinline__ void stage_chunk(float* vwin, int* meta, const float* values, int vbase,
                                            const int* col, const uint32_t* mask, const int* voff,
                                            const int* row, size_t slot0, int cb, int vmax) {
  stage<kAsync>(vwin, values + vbase, vmax);
  stage_words<kAsync>(meta, col + slot0, cb);
  stage_words<kAsync>(meta + cb, reinterpret_cast<const int*>(mask) + slot0, cb);
  stage_words<kAsync>(meta + 2 * cb, voff + slot0, cb);
  stage_words<kAsync>(meta + 3 * cb, row + slot0, cb);
}

template <int R>
__device__ __forceinline__ void flush_rows(float* out, int ldo, int row, const float (&acc)[R],
                                           uint32_t touched, bool live) {
  if (!live) return;
#pragma unroll
  for (int lr = 0; lr < R; ++lr) {
    if ((touched >> lr) & 1u) atomicAdd(out + (size_t)(row + lr) * ldo, acc[lr]);
  }
}

// Walk blocks [b0, b1) of a staged chunk for one column: x points at the
// column in X's first row (the window's first row for panels), out at the
// column in Y's (or the Y tile's) first row. Rows of one interval are summed
// in acc and flushed when the interval changes; `touched` marks the rows
// with a set bit, so rows past nrows are never written.
template <int R>
__device__ __forceinline__ void walk_blocks(const int* meta, const float* vwin,
                                            const float* __restrict__ x, int ldx, int b0, int b1,
                                            int cb, int c, float* out, int ldo, bool live) {
  const int* s_col = meta;
  const uint32_t* s_mask = reinterpret_cast<const uint32_t*>(meta + cb);
  const int* s_voff = meta + 2 * cb;
  const int* s_row = meta + 3 * cb;
  // c <= 8 and R * c <= 32, so every shift below is in range
  const uint32_t row_mask = (1u << c) - 1u;
  float acc[R];
  int cur = 0;
  uint32_t touched = 0u;
  for (int b = b0; b < b1; ++b) {
    const uint32_t mask = s_mask[b];
    if (mask == 0u) continue;  // padding block
    const int row = s_row[b];
    if (touched == 0u || row != cur) {
      if (touched != 0u) flush_rows<R>(out, ldo, cur, acc, touched, live);
      cur = row;
      touched = 0u;
#pragma unroll
      for (int lr = 0; lr < R; ++lr) acc[lr] = 0.f;
    }
    const float* xb = x + (size_t)s_col[b] * ldx;
    int v = s_voff[b];
#pragma unroll
    for (int lr = 0; lr < R; ++lr) {
      uint32_t bits = (mask >> (lr * c)) & row_mask;
      if (bits == 0u) continue;
      touched |= 1u << lr;
      float a = acc[lr];
      do {
        const int lc = __ffs(bits) - 1;
        bits &= bits - 1u;
        a = fmaf(vwin[v++], __ldg(xb + (size_t)lc * ldx), a);
      } while (bits != 0u);
      acc[lr] = a;
    }
  }
  if (touched != 0u) flush_rows<R>(out, ldo, cur, acc, touched, live);
}

// ---------------------------------------------------------------------------
// whole-vector layout: one CTA per (chunk, column tile), global atomics
// ---------------------------------------------------------------------------
template <int R>
__global__ void __launch_bounds__(kThreads)
spmm_whole_kernel(const int* __restrict__ chunk_vbase, const int* __restrict__ chunk_col,
                  const uint32_t* __restrict__ chunk_mask, const int* __restrict__ chunk_voff,
                  const int* __restrict__ chunk_row, const float* __restrict__ values,
                  const float* __restrict__ x, float* __restrict__ y, int cb, int vmax, int c,
                  int nvec, int tw, int ntiles) {
  // layout: the value window (a multiple of 8 floats), then the metadata
  extern __shared__ __align__(16) float smem[];
  float* vwin = smem;
  int* meta = reinterpret_cast<int*>(smem + vmax);
  const int ch = blockIdx.x / ntiles;
  const int tile = blockIdx.x - ch * ntiles;
  stage_chunk<false>(vwin, meta, values, chunk_vbase[ch], chunk_col, chunk_mask, chunk_voff,
                     chunk_row, (size_t)ch * cb, cb, vmax);
  __syncthreads();
  const Lanes t = lanes_of(tw, tile, nvec, cb);
  walk_blocks<R>(meta, vwin, x + t.jc, nvec, t.b0, t.b1, cb, c, y + t.jc, nvec, t.live);
}

// ---------------------------------------------------------------------------
// panel layout: one CTA per (panel, column tile), (pr, tw) Y tile in smem
// ---------------------------------------------------------------------------
template <int R, int kStages>
__global__ void __launch_bounds__(kThreads)
spmm_panels_kernel(const int* __restrict__ chunk_vbase, const int* __restrict__ chunk_xbase,
                   const int* __restrict__ chunk_col, const uint32_t* __restrict__ chunk_mask,
                   const int* __restrict__ chunk_voff, const int* __restrict__ chunk_row,
                   const float* __restrict__ values, const float* __restrict__ x,
                   float* __restrict__ y, int nchunks, int cb, int vmax, int pr, int nrows, int c,
                   int nvec, int tw, int ntiles) {
  // layout: kStages value windows (multiples of 8 floats, so each stays
  // 16-byte aligned), kStages metadata blocks of 4 * cb words, the Y tile
  extern __shared__ __align__(16) float smem[];
  float* vwins = smem;
  int* metas = reinterpret_cast<int*>(smem + kStages * vmax);
  float* ytile = reinterpret_cast<float*>(metas + kStages * 4 * cb);
  const int p = blockIdx.x / ntiles;
  const int tile = blockIdx.x - p * ntiles;
  const int* vbase = chunk_vbase + (size_t)p * nchunks;
  const int* xbase = chunk_xbase + (size_t)p * nchunks;
  const size_t slot0 = (size_t)p * nchunks * cb;
  for (int i = threadIdx.x; i < pr * tw; i += blockDim.x) ytile[i] = 0.f;
  if (kStages == 2) {
    stage_chunk<true>(vwins, metas, values, vbase[0], chunk_col, chunk_mask, chunk_voff,
                      chunk_row, slot0, cb, vmax);
    cp_async_commit();
  }
  const Lanes t = lanes_of(tw, tile, nvec, cb);
  for (int i = 0; i < nchunks; ++i) {
    const int buf = kStages == 2 ? (i & 1) : 0;
    float* vwin = vwins + buf * vmax;
    int* meta = metas + buf * 4 * cb;
    if (kStages == 2) {
      if (i + 1 < nchunks) {
        stage_chunk<true>(vwins + (buf ^ 1) * vmax, metas + (buf ^ 1) * 4 * cb, values,
                          vbase[i + 1], chunk_col, chunk_mask, chunk_voff, chunk_row,
                          slot0 + (size_t)(i + 1) * cb, cb, vmax);
      }
      cp_async_commit();  // possibly empty: keeps the group count uniform
      cp_async_wait<1>();  // everything but the prefetch just issued
    } else {
      stage_chunk<false>(vwin, meta, values, vbase[i], chunk_col, chunk_mask, chunk_voff,
                         chunk_row, slot0 + (size_t)i * cb, cb, vmax);
    }
    __syncthreads();  // also orders the Y tile's zeroing before the first add
    walk_blocks<R>(meta, vwin, x + (size_t)xbase[i] * nvec + t.jc, nvec, t.b0, t.b1, cb, c,
                   ytile + t.lane, tw, t.live);
    __syncthreads();  // the buffers are overwritten by the next stage
  }
  const int row0 = p * pr;
  const int nout = min(pr, nrows - row0);
  for (int i = threadIdx.x; i < nout * tw; i += blockDim.x) {
    const int rr = i / tw;
    const int j = tile * tw + (i - rr * tw);
    if (j < nvec) y[(size_t)(row0 + rr) * nvec + j] = ytile[i];
  }
}

template <int R>
int launch_whole(const int* vbase, const int* col, const uint32_t* mask, const int* voff,
                 const int* row, const float* values, const float* x, float* y, int nchunks,
                 int cb, int vmax, int c, int nvec, int tw, int device, void* stream) {
  const size_t smem = ((size_t)vmax + 4 * (size_t)cb) * 4;
  cudaError_t err = prepare_launch(spmm_whole_kernel<R>, device, smem, kThreads, nullptr);
  if (err != cudaSuccess) return (int)err;
  const int ntiles = (nvec + tw - 1) / tw;
  spmm_whole_kernel<R><<<nchunks * ntiles, kThreads, smem, (cudaStream_t)stream>>>(
      vbase, col, mask, voff, row, values, x, y, cb, vmax, c, nvec, tw, ntiles);
  return (int)cudaGetLastError();
}

template <int R, int kStages>
int launch_panels(const int* vbase, const int* xbase, const int* col, const uint32_t* mask,
                  const int* voff, const int* row, const float* values, const float* x,
                  float* y, int npanels, int nchunks, int cb, int vmax, int pr, int nrows, int c,
                  int nvec, int tw, int device, void* stream) {
  const size_t smem = ((size_t)kStages * (vmax + 4 * (size_t)cb) + (size_t)pr * tw) * 4;
  cudaError_t err =
      prepare_launch(spmm_panels_kernel<R, kStages>, device, smem, kThreads, nullptr);
  if (err != cudaSuccess) return (int)err;
  const int ntiles = (nvec + tw - 1) / tw;
  spmm_panels_kernel<R, kStages><<<npanels * ntiles, kThreads, smem, (cudaStream_t)stream>>>(
      vbase, xbase, col, mask, voff, row, values, x, y, nchunks, cb, vmax, pr, nrows, c, nvec,
      tw, ntiles);
  return (int)cudaGetLastError();
}

template <int kStages>
int panels_for_r(const int* vbase, const int* xbase, const int* col, const uint32_t* mask,
                 const int* voff, const int* row, const float* values, const float* x, float* y,
                 int npanels, int nchunks, int cb, int vmax, int pr, int nrows, int r, int c,
                 int nvec, int tw, int device, void* stream) {
#define SPC5_PANELS(R)                                                                       \
  launch_panels<R, kStages>(vbase, xbase, col, mask, voff, row, values, x, y, npanels,       \
                            nchunks, cb, vmax, pr, nrows, c, nvec, tw, device, stream)
  switch (r) {
    case 1: return SPC5_PANELS(1);
    case 2: return SPC5_PANELS(2);
    case 4: return SPC5_PANELS(4);
    case 8: return SPC5_PANELS(8);
    default: return (int)cudaErrorInvalidValue;
  }
#undef SPC5_PANELS
}

}  // namespace

extern "C" {

int spc5_spmm_whole(const int* vbase, const int* col, const uint32_t* mask, const int* voff,
                    const int* row, const float* values, const float* x, float* y, int nchunks,
                    int cb, int vmax, int r, int c, int nvec, int tw, int device, void* stream) {
#define SPC5_WHOLE(R) \
  launch_whole<R>(vbase, col, mask, voff, row, values, x, y, nchunks, cb, vmax, c, nvec, tw, \
                  device, stream)
  switch (r) {
    case 1: return SPC5_WHOLE(1);
    case 2: return SPC5_WHOLE(2);
    case 4: return SPC5_WHOLE(4);
    case 8: return SPC5_WHOLE(8);
    default: return (int)cudaErrorInvalidValue;
  }
#undef SPC5_WHOLE
}

int spc5_spmm_panels_s1(const int* vbase, const int* xbase, const int* col, const uint32_t* mask,
                        const int* voff, const int* row, const float* values, const float* x,
                        float* y, int npanels, int nchunks, int cb, int vmax, int pr, int nrows,
                        int r, int c, int nvec, int tw, int device, void* stream) {
  return panels_for_r<1>(vbase, xbase, col, mask, voff, row, values, x, y, npanels, nchunks, cb,
                         vmax, pr, nrows, r, c, nvec, tw, device, stream);
}

int spc5_spmm_panels_s2(const int* vbase, const int* xbase, const int* col, const uint32_t* mask,
                        const int* voff, const int* row, const float* values, const float* x,
                        float* y, int npanels, int nchunks, int cb, int vmax, int pr, int nrows,
                        int r, int c, int nvec, int tw, int device, void* stream) {
  return panels_for_r<2>(vbase, xbase, col, mask, voff, row, values, x, y, npanels, nchunks, cb,
                         vmax, pr, nrows, r, c, nvec, tw, device, stream);
}

}  // extern "C"
