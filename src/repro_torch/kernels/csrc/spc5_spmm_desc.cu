// SPC5 descriptor SpMM for Hopper (sm_90a): Y = A @ X with the bit-mask
// decode expanded once at build time into per-lane gather tables
// (repro_torch/core/formats.py: chunk_descriptors), over the two chunked
// layouts. X is (xrows, nvec) and Y (nrows, nvec), both row-major f32.
//
// Replaces the three Pallas TPU descriptor SpMM kernels of
// src/repro/kernels/spc5_spmm.py:
//   spc5_spmm_desc_whole      <- spmm_pallas_desc           (_spmm_desc_kernel)
//   spc5_spmm_desc_panels_s1  <- spmm_pallas_panels_desc    (_spmm_panel_desc_kernel)
//   spc5_spmm_desc_panels_s2  <- spmm_pallas_panels_desc_db (_spmm_panel_desc_db_kernel)
// Each computes, for every valid lane of a block, Y[yrow, :] += window[vidx]
// * X[xcol, :], reading the tables per block as the reference does: lanes k
// and k + c share a column, so xcol[b, lc] (lc < c) is the block's column lc
// and yrow[b, lr * c] its row lr. For panels xcol is relative to the chunk's
// x window (global column xbase + xcol) and yrow to the panel.
//
// Work split: that of spc5_spmm.cu. The columns of X and Y go to lanes in
// groups of tw (a power of two, at most 32, picked by the wrapper); (unit,
// column tile) is on the grid, unit a chunk (whole-vector) or a panel; each
// group walks a contiguous run of the staged chunk's blocks.
//
// Bound. 2 flops per nonzero and column; the bytes the product needs are
// 4 B per packed value, per block lane one int8 valid byte and a vidx entry
// (set or not), per block c xcol and r yrow entries (the rest of those
// tables repeats them), and X and Y once each: the per-lane bytes bind at
// small nvec, the f32 rate at nvec = 128. As in spc5_spmm.cu each nonzero
// also reads tw words of X through L1/L2, one load per multiply-add. What
// the design does about it:
//   * per chunk, the CTA stages its value window and, where shared memory
//     allows, its vidx table as built (int8/16/32, never widened); otherwise
//     vidx is read through L1 at the set lanes only (25-30 % slower on the
//     vocab panel plan, PERF.md). It also stages one word
//     per block and column (xcol[b, lc], plus the window's xbase), per block
//     and row (yrow[b, lr * c]) and per block (the valid bytes folded into an
//     r*c-bit mask by one or two vector loads), so the walk visits set lanes
//     only and reads nothing of an unset one; kStages == 2 prefetches the
//     next chunk's window and vidx with cp.async while the current chunk is
//     walked, the counterpart of the Pallas double buffer;
//   * a column at or past X's rows (xrows) is staged as -1 and its lanes are
//     skipped: the reference pads X with zero rows up to ncols_pad, and the
//     clipped columns of unset lanes and padding blocks may point past ncols;
//     X is never read there and never copied to pad it;
//   * X is read through the read-only path, coalesced across the group. The
//     Pallas kernels stage an (xw, nvt) X slab per chunk: 256 KB at xw = 512
//     and nvt = 128, more than a CTA's 227 KB with the Y tile beside it;
//   * each (row, column) is summed in a register while the block row's
//     yrow entry is unchanged and added once when it changes: into a zeroed
//     Y with global atomicAdd (whole-vector, neighbouring chunks can share
//     rows; the f32 sum order varies from run to run), or into the panel's
//     (pr, tw) Y tile in shared memory, written out once (panels).
//
// Each launcher runs on the caller's stream, allocates nothing, does not
// synchronise, and returns cudaGetLastError() (0 on success).

#include "spc5_stage.cuh"

namespace {

constexpr int kThreads = 256;

__host__ __device__ __forceinline__ int round16(int n) { return (n + 15) & ~15; }

// Byte offsets of one staged chunk's parts in shared memory; every part
// starts 16-byte aligned (vmax is a multiple of 8 floats) and so does the
// next stage. The wrapper reckons the same sizes (spc5_spmm_desc.py).
struct Stage {
  int vidx, bcol, brow, bmask, bytes;  // the value window is at 0
};

__host__ __device__ __forceinline__ Stage stage_layout(int cb, int r, int c, int vmax, int wv,
                                                       bool stage_vidx) {
  Stage s;
  s.vidx = 4 * vmax;
  s.bcol = s.vidx + (stage_vidx ? round16(cb * r * c * wv) : 0);
  s.brow = s.bcol + 4 * cb * c;
  s.bmask = s.brow + 4 * cb * r;
  s.bytes = round16(s.bmask + 4 * cb);
  return s;
}

// Bit i: byte i of w is not zero.
__device__ __forceinline__ uint32_t nonzero_bytes(uint32_t w) {
  const uint32_t t = __vcmpne4(w, 0u) & 0x01010101u;
  return (t * 0x01020408u) >> 24;
}

// The rc valid bytes of one block (rc in 4, 8, 16, 32; the block's bytes
// start at a multiple of rc, the table at 16 bytes) as an rc-bit mask.
__device__ __forceinline__ uint32_t block_mask(const signed char* v, int rc) {
  if (rc == 4) return nonzero_bytes(__ldg(reinterpret_cast<const unsigned*>(v)));
  if (rc == 8) {
    const uint2 q = __ldg(reinterpret_cast<const uint2*>(v));
    return nonzero_bytes(q.x) | nonzero_bytes(q.y) << 4;
  }
  const uint4 q = __ldg(reinterpret_cast<const uint4*>(v));
  uint32_t m = nonzero_bytes(q.x) | nonzero_bytes(q.y) << 4 | nonzero_bytes(q.z) << 8 |
               nonzero_bytes(q.w) << 12;
  if (rc == 32) {
    const uint4 h = __ldg(reinterpret_cast<const uint4*>(v) + 1);
    m |= (nonzero_bytes(h.x) | nonzero_bytes(h.y) << 4 | nonzero_bytes(h.z) << 8 |
          nonzero_bytes(h.w) << 12)
         << 16;
  }
  return m;
}

// Stage one chunk (lanes lane0 .. lane0 + cb*r*c of the tables) into st.
template <bool kAsync, typename VT>
__device__ __forceinline__ void stage_chunk(char* st, const Stage& L, const float* values,
                                            int vbase, const signed char* valid, const VT* vidx,
                                            const void* xcol, const void* yrow, size_t lane0,
                                            int cb, int r, int c, int vmax, int wx, int wy,
                                            int xbase, int xrows, bool stage_vidx) {
  const int rc = r * c;
  stage<kAsync>(reinterpret_cast<float*>(st), values + vbase, vmax);
  if (stage_vidx) {
    stage_bytes<kAsync>(st + L.vidx, reinterpret_cast<const char*>(vidx + lane0),
                        cb * rc * (int)sizeof(VT));
  }
  int* bcol = reinterpret_cast<int*>(st + L.bcol);
  for (int i = threadIdx.x; i < cb * c; i += blockDim.x) {
    const int b = i / c;
    const int col = xbase + load_index(xcol, lane0 + (size_t)b * rc + (i - b * c), wx);
    bcol[i] = col < xrows ? col : -1;
  }
  int* brow = reinterpret_cast<int*>(st + L.brow);
  for (int i = threadIdx.x; i < cb * r; i += blockDim.x) {
    const int b = i / r;
    brow[i] = load_index(yrow, lane0 + (size_t)b * rc + (i - b * r) * c, wy);
  }
  uint32_t* bmask = reinterpret_cast<uint32_t*>(st + L.bmask);
  for (int b = threadIdx.x; b < cb; b += blockDim.x) {
    bmask[b] = block_mask(valid + lane0 + (size_t)b * rc, rc);
  }
}

// Walk blocks [b0, b1) of a staged chunk for one column: x points at the
// column in X's row 0, out at the column in Y's (or the Y tile's) row 0, and
// gvidx at the chunk's vidx table in global memory (read there when it is
// not staged). acc[lr] sums the products of block row lr while its yrow
// entry stays cur[lr] (-1: nothing summed yet).
template <int R, typename VT>
__device__ __forceinline__ void walk_blocks(const char* st, const Stage& L, const VT* gvidx,
                                            bool stage_vidx, const float* __restrict__ x,
                                            int ldx, int b0, int b1, int c, float* out, int ldo,
                                            bool live) {
  const float* vwin = reinterpret_cast<const float*>(st);
  const VT* svidx = reinterpret_cast<const VT*>(st + L.vidx);
  const int* bcol = reinterpret_cast<const int*>(st + L.bcol);
  const int* brow = reinterpret_cast<const int*>(st + L.brow);
  const uint32_t* bmask = reinterpret_cast<const uint32_t*>(st + L.bmask);
  const int rc = R * c;
  // c <= 8 and R * c <= 32, so every shift below is in range
  const uint32_t row_mask = (1u << c) - 1u;
  float acc[R];
  int cur[R];
#pragma unroll
  for (int lr = 0; lr < R; ++lr) {
    acc[lr] = 0.f;
    cur[lr] = -1;
  }
  for (int b = b0; b < b1; ++b) {
    const uint32_t mask = bmask[b];
    if (mask == 0u) continue;  // padding block
    const size_t k0 = (size_t)b * rc;
#pragma unroll
    for (int lr = 0; lr < R; ++lr) {
      uint32_t bits = (mask >> (lr * c)) & row_mask;
      if (bits == 0u) continue;
      const int row = brow[b * R + lr];
      if (row != cur[lr]) {
        if (cur[lr] >= 0 && live) atomicAdd(out + (size_t)cur[lr] * ldo, acc[lr]);
        cur[lr] = row;
        acc[lr] = 0.f;
      }
      float a = acc[lr];
      do {
        const int lc = __ffs(bits) - 1;
        bits &= bits - 1u;
        const int col = bcol[b * c + lc];
        if (col >= 0) {
          const size_t k = k0 + lr * c + lc;
          const int vi = stage_vidx ? (int)svidx[k] : (int)__ldg(gvidx + k);
          a = fmaf(vwin[vi], __ldg(x + (size_t)col * ldx), a);
        }
      } while (bits != 0u);
      acc[lr] = a;
    }
  }
#pragma unroll
  for (int lr = 0; lr < R; ++lr) {
    if (cur[lr] >= 0 && live) atomicAdd(out + (size_t)cur[lr] * ldo, acc[lr]);
  }
}

// ---------------------------------------------------------------------------
// whole-vector layout: one CTA per (chunk, column tile), global atomics
// ---------------------------------------------------------------------------
template <int R, typename VT>
__global__ void __launch_bounds__(kThreads)
spmm_desc_whole_kernel(const int* __restrict__ chunk_vbase, const signed char* __restrict__ valid,
                       const VT* __restrict__ vidx, const void* __restrict__ xcol,
                       const void* __restrict__ yrow, const float* __restrict__ values,
                       const float* __restrict__ x, float* __restrict__ y, int cb, int c,
                       int vmax, int wx, int wy, int ncols, int nvec, int tw, int ntiles,
                       bool stage_vidx) {
  extern __shared__ __align__(16) char smem[];
  const Stage L = stage_layout(cb, R, c, vmax, (int)sizeof(VT), stage_vidx);
  const int ch = blockIdx.x / ntiles;
  const int tile = blockIdx.x - ch * ntiles;
  const size_t lane0 = (size_t)ch * cb * R * c;
  stage_chunk<false, VT>(smem, L, values, chunk_vbase[ch], valid, vidx, xcol, yrow, lane0, cb, R,
                         c, vmax, wx, wy, 0, ncols, stage_vidx);
  __syncthreads();
  const Lanes t = lanes_of(tw, tile, nvec, cb);
  walk_blocks<R, VT>(smem, L, vidx + lane0, stage_vidx, x + t.jc, nvec, t.b0, t.b1, c, y + t.jc,
                     nvec, t.live);
}

// ---------------------------------------------------------------------------
// panel layout: one CTA per (panel, column tile), (pr, tw) Y tile in smem
// ---------------------------------------------------------------------------
template <int R, typename VT, int kStages>
__global__ void __launch_bounds__(kThreads)
spmm_desc_panels_kernel(const int* __restrict__ chunk_vbase, const int* __restrict__ chunk_xbase,
                        const signed char* __restrict__ valid, const VT* __restrict__ vidx,
                        const void* __restrict__ xcol, const void* __restrict__ yrow,
                        const float* __restrict__ values, const float* __restrict__ x,
                        float* __restrict__ y, int nchunks, int cb, int c, int vmax, int pr,
                        int nrows, int xrows, int wx, int wy, int nvec, int tw, int ntiles,
                        bool stage_vidx) {
  // layout: kStages staged chunks, then the Y tile
  extern __shared__ __align__(16) char smem[];
  const Stage L = stage_layout(cb, R, c, vmax, (int)sizeof(VT), stage_vidx);
  float* ytile = reinterpret_cast<float*>(smem + kStages * L.bytes);
  const int p = blockIdx.x / ntiles;
  const int tile = blockIdx.x - p * ntiles;
  const int* vbase = chunk_vbase + (size_t)p * nchunks;
  const int* xbase = chunk_xbase + (size_t)p * nchunks;
  const size_t lanes = (size_t)cb * R * c;
  const size_t lane_p = (size_t)p * nchunks * lanes;
  for (int i = threadIdx.x; i < pr * tw; i += blockDim.x) ytile[i] = 0.f;
  if (kStages == 2) {
    stage_chunk<true, VT>(smem, L, values, vbase[0], valid, vidx, xcol, yrow, lane_p, cb, R, c,
                          vmax, wx, wy, xbase[0], xrows, stage_vidx);
    cp_async_commit();
  }
  const Lanes t = lanes_of(tw, tile, nvec, cb);
  for (int i = 0; i < nchunks; ++i) {
    const int buf = kStages == 2 ? (i & 1) : 0;
    char* st = smem + buf * L.bytes;
    const size_t lane0 = lane_p + (size_t)i * lanes;
    if (kStages == 2) {
      if (i + 1 < nchunks) {
        stage_chunk<true, VT>(smem + (buf ^ 1) * L.bytes, L, values, vbase[i + 1], valid, vidx,
                              xcol, yrow, lane0 + lanes, cb, R, c, vmax, wx, wy, xbase[i + 1],
                              xrows, stage_vidx);
      }
      cp_async_commit();   // possibly empty: keeps the group count uniform
      cp_async_wait<1>();  // everything but the prefetch just issued
    } else {
      stage_chunk<false, VT>(st, L, values, vbase[i], valid, vidx, xcol, yrow, lane0, cb, R, c,
                             vmax, wx, wy, xbase[i], xrows, stage_vidx);
    }
    __syncthreads();  // also orders the Y tile's zeroing before the first add
    walk_blocks<R, VT>(st, L, vidx + lane0, stage_vidx, x + t.jc, nvec, t.b0, t.b1, c,
                       ytile + t.lane, tw, t.live);
    __syncthreads();  // the stage is overwritten by the next prefetch
  }
  const int row0 = p * pr;
  const int nout = min(pr, nrows - row0);
  for (int i = threadIdx.x; i < nout * tw; i += blockDim.x) {
    const int rr = i / tw;
    const int j = tile * tw + (i - rr * tw);
    if (j < nvec) y[(size_t)(row0 + rr) * nvec + j] = ytile[i];
  }
}

template <int R, typename VT>
int launch_whole(const int* vbase, const signed char* valid, const void* vidx, const void* xcol,
                 const void* yrow, const float* values, const float* x, float* y, int nchunks,
                 int cb, int c, int vmax, int wx, int wy, int ncols, int nvec, int tw,
                 bool stage_vidx, int device, void* stream) {
  const size_t smem = stage_layout(cb, R, c, vmax, (int)sizeof(VT), stage_vidx).bytes;
  cudaError_t err = prepare_launch(spmm_desc_whole_kernel<R, VT>, device, smem, kThreads, nullptr);
  if (err != cudaSuccess) return (int)err;
  const int ntiles = (nvec + tw - 1) / tw;
  spmm_desc_whole_kernel<R, VT><<<nchunks * ntiles, kThreads, smem, (cudaStream_t)stream>>>(
      vbase, valid, static_cast<const VT*>(vidx), xcol, yrow, values, x, y, cb, c, vmax, wx, wy,
      ncols, nvec, tw, ntiles, stage_vidx);
  return (int)cudaGetLastError();
}

template <int R, typename VT, int kStages>
int launch_panels(const int* vbase, const int* xbase, const signed char* valid, const void* vidx,
                  const void* xcol, const void* yrow, const float* values, const float* x,
                  float* y, int npanels, int nchunks, int cb, int c, int vmax, int pr, int nrows,
                  int xrows, int wx, int wy, int nvec, int tw, bool stage_vidx, int device,
                  void* stream) {
  const size_t smem =
      (size_t)kStages * stage_layout(cb, R, c, vmax, (int)sizeof(VT), stage_vidx).bytes +
      (size_t)pr * tw * sizeof(float);
  cudaError_t err =
      prepare_launch(spmm_desc_panels_kernel<R, VT, kStages>, device, smem, kThreads, nullptr);
  if (err != cudaSuccess) return (int)err;
  const int ntiles = (nvec + tw - 1) / tw;
  spmm_desc_panels_kernel<R, VT, kStages>
      <<<npanels * ntiles, kThreads, smem, (cudaStream_t)stream>>>(
          vbase, xbase, valid, static_cast<const VT*>(vidx), xcol, yrow, values, x, y, nchunks,
          cb, c, vmax, pr, nrows, xrows, wx, wy, nvec, tw, ntiles, stage_vidx);
  return (int)cudaGetLastError();
}

// Dispatch on the block height r and the vidx width wv (1, 2 or 4 bytes).
#define SPC5_DISPATCH(CALL)                         \
  switch (r * 8 + wv) {                             \
    case 1 * 8 + 1: return CALL(1, signed char);    \
    case 1 * 8 + 2: return CALL(1, short);          \
    case 1 * 8 + 4: return CALL(1, int);            \
    case 2 * 8 + 1: return CALL(2, signed char);    \
    case 2 * 8 + 2: return CALL(2, short);          \
    case 2 * 8 + 4: return CALL(2, int);            \
    case 4 * 8 + 1: return CALL(4, signed char);    \
    case 4 * 8 + 2: return CALL(4, short);          \
    case 4 * 8 + 4: return CALL(4, int);            \
    case 8 * 8 + 1: return CALL(8, signed char);    \
    case 8 * 8 + 2: return CALL(8, short);          \
    case 8 * 8 + 4: return CALL(8, int);            \
    default: return (int)cudaErrorInvalidValue;     \
  }

template <int kStages>
int panels(const int* vbase, const int* xbase, const signed char* valid, const void* vidx,
           const void* xcol, const void* yrow, const float* values, const float* x, float* y,
           int npanels, int nchunks, int cb, int vmax, int pr, int nrows, int xrows, int r, int c,
           int wv, int wx, int wy, int nvec, int tw, int stage_vidx, int device, void* stream) {
#define SPC5_PANELS(R, VT)                                                                        \
  launch_panels<R, VT, kStages>(vbase, xbase, valid, vidx, xcol, yrow, values, x, y, npanels,    \
                                nchunks, cb, c, vmax, pr, nrows, xrows, wx, wy, nvec, tw,         \
                                stage_vidx != 0, device, stream)
  if (r < 1 || r > 8 || c < 1 || c > 8 || 32 % (r * c) != 0 || r * c < 4) {
    return (int)cudaErrorInvalidValue;
  }
  SPC5_DISPATCH(SPC5_PANELS)
#undef SPC5_PANELS
}

}  // namespace

extern "C" {

int spc5_spmm_desc_whole(const int* vbase, const signed char* valid, const void* vidx,
                         const void* xcol, const void* yrow, const float* values, const float* x,
                         float* y, int nchunks, int cb, int vmax, int r, int c, int wv, int wx,
                         int wy, int ncols, int nvec, int tw, int stage_vidx, int device,
                         void* stream) {
#define SPC5_WHOLE(R, VT)                                                                     \
  launch_whole<R, VT>(vbase, valid, vidx, xcol, yrow, values, x, y, nchunks, cb, c, vmax, wx, \
                      wy, ncols, nvec, tw, stage_vidx != 0, device, stream)
  if (r < 1 || r > 8 || c < 1 || c > 8 || 32 % (r * c) != 0 || r * c < 4) {
    return (int)cudaErrorInvalidValue;
  }
  SPC5_DISPATCH(SPC5_WHOLE)
#undef SPC5_WHOLE
}

int spc5_spmm_desc_panels_s1(const int* vbase, const int* xbase, const signed char* valid,
                             const void* vidx, const void* xcol, const void* yrow,
                             const float* values, const float* x, float* y, int npanels,
                             int nchunks, int cb, int vmax, int pr, int nrows, int xrows, int r,
                             int c, int wv, int wx, int wy, int nvec, int tw, int stage_vidx,
                             int device, void* stream) {
  return panels<1>(vbase, xbase, valid, vidx, xcol, yrow, values, x, y, npanels, nchunks, cb,
                   vmax, pr, nrows, xrows, r, c, wv, wx, wy, nvec, tw, stage_vidx, device, stream);
}

int spc5_spmm_desc_panels_s2(const int* vbase, const int* xbase, const signed char* valid,
                             const void* vidx, const void* xcol, const void* yrow,
                             const float* values, const float* x, float* y, int npanels,
                             int nchunks, int cb, int vmax, int pr, int nrows, int xrows, int r,
                             int c, int wv, int wx, int wy, int nvec, int tw, int stage_vidx,
                             int device, void* stream) {
  return panels<2>(vbase, xbase, valid, vidx, xcol, yrow, values, x, y, npanels, nchunks, cb,
                   vmax, pr, nrows, xrows, r, c, wv, wx, wy, nvec, tw, stage_vidx, device, stream);
}

}  // extern "C"
