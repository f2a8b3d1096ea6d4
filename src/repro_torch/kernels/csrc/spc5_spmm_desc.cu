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
// Bound. 2 flops per nonzero and column; the bytes the product needs are
// 4 B per packed value (2 B in bf16, 1 B and an f32 scale a chunk in int8),
// per block lane one int8 valid byte and a vidx entry (set or not), per block c xcol entries and one yrow entry (the rest of
// those tables repeats them), and X and Y once each: the per-lane bytes bind
// at small nvec, the f32 rate at nvec = 128, where what a nonzero costs in
// instructions decides.
//
// Whole-vector kernel (spmm_whole_kernel<DescWhole<T>, R, C, V>), built for
// the H100, not for the TPU's sequential grid: the skeleton of
// spc5_spmm_whole.cuh (G contiguous chunk ranges, a ring of staged rounds
// where it costs no CTAs an SM, a per-round list of nonzeros ordered by
// row, lane groups walking equal shares of it four entries at a time with
// 16-byte X loads, a deterministic combine in a shared Y tile, no shared
// float atomic), shared with the mask kernel of spc5_spmm.cu. Its own
// part: a stage holds what differs at the tables' built widths, the value
// windows, the valid and vidx runs, the c xcol entries of each block's
// first row and the 4-byte word of each block's lane-0 yrow entry (the
// identities the panel kernels below rely on hold in this layout too;
// tests/test_torch_desc_whole.py pins them); a block's entries are its
// valid lanes in lane order, each window[vidx[k]] (no packed order is
// assumed) decoded to f32 once, as the mask kernel's list does, so the walk
// never sees the value store (T, as in the panel kernels below: a narrow
// window staged as its aligned span, its offset in it and its chunk's scale
// written beside by thread 0), less lanes whose column lies at or past X's
// rows. What bounds it: at nvec 16 the tables' bytes (the plan is 9.5x the
// mask plan's) and each round's fixed costs; at nvec 128 the walk's
// instructions, as for the mask kernel.
//
// Panel kernels (spmm_desc_panels_kernel and their column-map twins,
// spmm_desc_panels_cmap_kernel): spc5_spmm_desc_panels.cuh, shared with
// spc5_spmm_desc_cmap.cu, which builds the twins in a library of their own
// so that both compile in parallel.
//
// Each launcher runs on the caller's stream, allocates nothing, does not
// synchronise, and returns cudaGetLastError() (0 on success).

#include "spc5_spmm_panels.cuh"
#include "spc5_spmm_desc_panels.cuh"
#include "spc5_spmm_whole.cuh"
#include "spc5_stage.cuh"

namespace {

// ---------------------------------------------------------------------------
// whole-vector layout: the skeleton of spc5_spmm_whole.cuh, G contiguous
// chunk ranges, a ring of staged rounds, a per-round nonzero list
// ---------------------------------------------------------------------------

// The descriptor kernel's part, for values of type T. A stage holds what
// differs, at the tables' built widths: q value windows (vstride bytes
// apart: value_window, a narrow one as its aligned span), for narrow values
// each chunk's window offset and scale (8 bytes), for nb blocks the valid
// and vidx runs, the c xcol entries of each block's first row (xcol[k] ==
// xcol[k % c]) and the 4-byte word holding each block's lane-0 yrow entry
// (on valid lanes yrow[k] == yrow[0] + k / c; lanes past nrows or ncols are
// clipped, and invalid; tests/test_torch_desc_whole.py pins both), then a
// 16-byte mbarrier slot. A block's lanes are its valid ones whose column
// lies below X's rows, each listed with window[vidx[k]] decoded to f32 (no
// packed order is assumed).
template <typename T>
struct DescWholeArgs {
  WholeGeom g;
  const int* vbase;  // (nchunks,) value window starts
  const signed char* valid;
  const char* vidx;  // the index tables, as bytes (entries wv, wx, wy wide)
  const char* xcol;
  const char* yrow;
  const T* values;
  int wv, wx, wy;
  const float* scale;  // (nchunks,) int8 scales; unread otherwise
  int nvalues;         // values' length: no staged span reaches past it
};

// f32 values take no scale and no span: their arguments are the ones the
// kernel had before the narrow stores, as for the mask kernel's
// (spc5_spmm.cu: MaskWholeArgs<float>).
template <>
struct DescWholeArgs<float> {
  WholeGeom g;
  const int* vbase;
  const signed char* valid;
  const char* vidx;
  const char* xcol;
  const char* yrow;
  const float* values;
  int wv, wx, wy;
};

template <typename T>
struct DescWhole {
  using Args = DescWholeArgs<T>;

  static constexpr bool kNarrow = sizeof(T) < 4;

  __host__ __device__ static int rc(const Args& a) { return a.g.r * a.g.c; }
  __host__ __device__ static int vstride(const Args& a) {
    return value_window((int)sizeof(T), a.g.vmax);
  }
  __host__ __device__ static int wmeta(const Args& a) { return a.g.q * vstride(a); }
  __host__ __device__ static int valid_off(const Args& a) {
    return wmeta(a) + (kNarrow ? wr16(8 * a.g.q) : 0);
  }
  __host__ __device__ static int vidx_off(const Args& a) {
    return valid_off(a) + round16(a.g.nb * rc(a));
  }
  __host__ __device__ static int xcol_off(const Args& a) {
    return vidx_off(a) + round16(a.g.nb * rc(a) * a.wv);
  }
  __host__ __device__ static int yrow_off(const Args& a) {
    return xcol_off(a) + round16(a.g.nb * a.g.c * a.wx);
  }
  __host__ __device__ static int bar_offset(const Args& a) {
    return yrow_off(a) + round16(4 * a.g.nb);
  }
  __host__ __device__ static int stage_bytes(const Args& a) { return bar_offset(a) + 16; }

  // Stage blocks [b0, b0 + nb) of global chunks g .. g + qn - 1 and, where
  // `window`, their value windows (a narrow one as its span, its offset in
  // it and its chunk's scale written beside): thread 0 announces and issues
  // the bulk copies (the windows; the valid and vidx runs where 16-byte
  // aligned), all completing on the stage's mbarrier, one phase per call;
  // every thread issues its share of the rest (the strided xcol and yrow
  // runs) by cp.async (a span's last 4 to 12 bytes are thread 0's).
  __device__ static void fill(unsigned char* st, const Args& a, size_t g, int b0, int nb, int qn,
                              bool window) {
    const size_t lane0 = (g * a.g.cb + b0) * rc(a);
    const char* valid = reinterpret_cast<const char*>(a.valid) + lane0;
    const char* vidx = a.vidx + lane0 * a.wv;
    const int nvalid = nb * rc(a), nvidx = nvalid * a.wv;
    const bool bulk = ((reinterpret_cast<uintptr_t>(valid) | reinterpret_cast<uintptr_t>(vidx) |
                        (uintptr_t)nvalid) & 15) == 0;
    if (threadIdx.x == 0) {
      uint64_t* bar = reinterpret_cast<uint64_t*>(st + bar_offset(a));
      if constexpr (!kNarrow) {
        mbar_expect_tx(bar, (window ? 4 * a.g.vmax * qn : 0) + (bulk ? nvalid + nvidx : 0));
        for (int i = 0; window && i < qn; ++i) {
          bulk_copy(st + vstride(a) * i, a.values + __ldg(a.vbase + g + i), 4 * a.g.vmax, bar);
        }
      } else {
        int2* wm = reinterpret_cast<int2*>(st + wmeta(a));
        uint32_t wbytes = 0;
        for (int i = 0; window && i < qn; ++i) {
          int bytes, off;
          value_span(a.values, __ldg(a.vbase + g + i), a.g.vmax, a.nvalues, bytes, off);
          wm[i] = make_int2(off, __float_as_int(value_scale<T>(a.scale, g + i)));
          wbytes += span_bulk_bytes(bytes);
        }
        mbar_expect_tx(bar, wbytes + (bulk ? nvalid + nvidx : 0));
        for (int i = 0; window && i < qn; ++i) {
          int bytes, off;
          const char* span =
              value_span(a.values, __ldg(a.vbase + g + i), a.g.vmax, a.nvalues, bytes, off);
          copy_span(st + vstride(a) * i, span, bytes, bar);
        }
      }
      if (bulk) {
        bulk_copy(st + valid_off(a), valid, nvalid, bar);
        bulk_copy(st + vidx_off(a), vidx, nvidx, bar);
      }
    }
    if (!bulk) {
      copy_runs<true>(st + valid_off(a), valid, 1, nvalid, 0);
      copy_runs<true>(st + vidx_off(a), vidx, 1, nvidx, 0);
    }
    copy_runs<true>(st + xcol_off(a), a.xcol + lane0 * a.wx, nb, a.g.c * a.wx, rc(a) * a.wx);
    // the 4-byte word holding each block's lane-0 yrow entry (r*c >= 4, so the
    // word is aligned and inside the block's entries)
    copy_runs<true>(st + yrow_off(a), a.yrow + lane0 * a.wy, nb, 4, rc(a) * a.wy);
  }

  __device__ static int first_row(const unsigned char* st, const Args& a) {
    return smem_entry(st + yrow_off(a), 0, a.wy);
  }

  template <int R, int C>
  __device__ static WholeBlock block(const unsigned char* st, const Args& a, int b) {
    constexpr int RC = R * C;
    uint32_t m = smem_block_mask<RC>(st + valid_off(a) + b * RC);
    // a block's columns grow from lane 0 on (those past ncols are clipped
    // to its last): where the last lies below X's rows, so do all
    if (m != 0u && smem_entry(st + xcol_off(a), b * C + C - 1, a.wx) >= a.g.xrows) {
      uint32_t cols = 0u;  // the block's columns below X's rows
#pragma unroll
      for (int lc = 0; lc < C; ++lc) {
        cols |= (uint32_t)(smem_entry(st + xcol_off(a), b * C + lc, a.wx) < a.g.xrows) << lc;
      }
      uint32_t lanes = 0u;
#pragma unroll
      for (int lr = 0; lr < R; ++lr) lanes |= cols << (lr * C);
      m &= lanes;
    }
    return WholeBlock{m, smem_entry(st + yrow_off(a) + 4 * b, 0, a.wy)};
  }

  // The block's kept lanes row by row, lane order within a row, row lr's
  // from list[pos[lr]] on, each value decoded to f32.
  template <int R, int C>
  __device__ static void emit(const unsigned char* st, const Args& a, int b, uint32_t kept,
                              const int (&pos)[R], int4* list, int room) {
    constexpr uint32_t kRow = (1u << C) - 1u;
    const int slot = a.g.q == 1 ? 0 : b / a.g.cb;  // the block's chunk in the stage
    const T* vwin = reinterpret_cast<const T*>(st + slot * vstride(a));
    float sc = 1.f;
    if constexpr (kNarrow) {
      const int2 w = reinterpret_cast<const int2*>(st + wmeta(a))[slot];  // offset, scale
      vwin += w.x;
      sc = __int_as_float(w.y);
    }
    const int y = smem_entry(st + yrow_off(a) + 4 * b, 0, a.wy);
#pragma unroll
    for (int lr = 0; lr < R; ++lr) {
      uint32_t kb = (kept >> (lr * C)) & kRow;
      int p = pos[lr];
      while (kb != 0u) {
        const int lc = __ffs(kb) - 1;
        kb &= kb - 1u;
        if (p < room) {
          const float v =
              dequant(vwin[smem_entry(st + vidx_off(a), b * R * C + lr * C + lc, a.wv)], sc);
          const int col = smem_entry(st + xcol_off(a), b * C + lc, a.wx);
          list[p] = make_int4(__float_as_int(v), col * a.g.nvec, y + lr, 0);
        }
        ++p;
      }
    }
  }
};

template <typename T>
using DescWholeKernel = void (*)(typename DescWhole<T>::Args);

template <typename T, int R, int C>
DescWholeKernel<T> desc_whole_rc(int vec) {
  switch (vec) {
    case 1: return spmm_whole_kernel<DescWhole<T>, R, C, 1>;
    case 2: return spmm_whole_kernel<DescWhole<T>, R, C, 2>;
    case 4: return spmm_whole_kernel<DescWhole<T>, R, C, 4>;
    default: return nullptr;
  }
}

// The whole-vector kernel for values of type T, block shape (r, c) (every
// shape of formats.SUPPORTED_BLOCKS) and vec columns a lane; nullptr for
// any other.
template <typename T>
DescWholeKernel<T> desc_whole_kernel(int r, int c, int vec) {
  switch (r * 16 + c) {
    case 1 * 16 + 4: return desc_whole_rc<T, 1, 4>(vec);
    case 1 * 16 + 8: return desc_whole_rc<T, 1, 8>(vec);
    case 2 * 16 + 4: return desc_whole_rc<T, 2, 4>(vec);
    case 2 * 16 + 8: return desc_whole_rc<T, 2, 8>(vec);
    case 4 * 16 + 4: return desc_whole_rc<T, 4, 4>(vec);
    case 4 * 16 + 8: return desc_whole_rc<T, 4, 8>(vec);
    case 8 * 16 + 4: return desc_whole_rc<T, 8, 4>(vec);
    default: return nullptr;
  }
}

WholeGeom desc_whole_geom(int nchunks, int cb, int vmax, int nrows, int xrows, int r, int c,
                          int nvec, int tw, int vec, int grid, int stages, int q, int nb,
                          int tile_rows) {
  return WholeGeom{nullptr, nullptr, nchunks, cb, r, c, vmax, nrows, xrows, nvec, tw, vec,
                   tw > 0 ? (nvec + tw - 1) / tw : 0, grid, stages, q, nb, tile_rows};
}

// The CTA's dynamic shared memory of the kernel for T values at geometry g
// and table widths wv, wx.
template <typename T>
int desc_whole_bytes(const WholeGeom& g, int wv, int wx, int threads) {
  typename DescWhole<T>::Args a{};
  a.g = g;
  a.wv = wv;
  a.wx = wx;
  return whole_layout(g, DescWhole<T>::stage_bytes(a), threads).bytes;
}

int desc_whole_smem(int vsize, const WholeGeom& g, int wv, int wx, int threads) {
  switch (vsize) {
    case 4: return desc_whole_bytes<float>(g, wv, wx, threads);
    case 2: return desc_whole_bytes<__nv_bfloat16>(g, wv, wx, threads);
    case 1: return desc_whole_bytes<int8_t>(g, wv, wx, threads);
    default: return -1;
  }
}

bool widths_ok(int wv, int wx, int wy) {
  auto ok = [](int w) { return w == 1 || w == 2 || w == 4; };
  return ok(wv) && ok(wx) && ok(wy);
}

template <typename T>
int launch_desc_whole(const WholeGeom& g, const int* vbase, const signed char* valid,
                      const void* vidx, const void* xcol, const void* yrow, const void* values,
                      const float* scale, int nvalues, int wv, int wx, int wy, int smem,
                      int threads, int device, void* stream) {
  typename DescWhole<T>::Args a{};
  a.g = g;
  a.vbase = vbase;
  a.valid = valid;
  a.vidx = static_cast<const char*>(vidx);
  a.xcol = static_cast<const char*>(xcol);
  a.yrow = static_cast<const char*>(yrow);
  a.values = static_cast<const T*>(values);
  a.wv = wv;
  a.wx = wx;
  a.wy = wy;
  if constexpr (sizeof(T) < 4) {
    a.scale = scale;
    a.nvalues = nvalues;
  }
  const DescWholeKernel<T> kernel = desc_whole_kernel<T>(g.r, g.c, g.vec);
  const size_t bytes = whole_layout(g, DescWhole<T>::stage_bytes(a), threads).bytes;
  if (kernel == nullptr || !widths_ok(wv, wx, wy) || !whole_geom_ok(g, threads) ||
      bytes != (size_t)smem || (sizeof(T) == 1 && scale == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaError_t err = prepare_launch(kernel, device, bytes, threads, nullptr);
  if (err != cudaSuccess) return (int)err;
  void* args[] = {&a};
  err = cudaLaunchKernel(reinterpret_cast<const void*>(kernel),
                         dim3((unsigned)(g.grid * g.ntiles)), dim3(threads), args, bytes,
                         (cudaStream_t)stream);
  return (int)(err != cudaSuccess ? err : cudaGetLastError());
}

template <typename Kernel>
int whole_occupancy(Kernel kernel, int threads, int smem, int device, int* out) {
  if (kernel == nullptr) return (int)cudaErrorInvalidValue;
  cudaError_t err = prepare_launch(kernel, device, (size_t)smem, threads, nullptr);
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(out, kernel, threads, (size_t)smem);
  }
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(out + 1, cudaDevAttrMultiProcessorCount, device);
  return (int)err;
}

}  // namespace

extern "C" {

// The whole-vector kernel (spc5_spmm_whole.cuh): Y = A @ X over all
// nchunks chunks of cb blocks, the tables at their built widths (wv, wx, wy
// bytes), X (xrows, nvec) read in place, Y (nrows, nvec) zeroed by the
// caller, values of vsize bytes (4 f32, 2 bf16, 1 int8 with its (nchunks,)
// scales; scale is unread otherwise), nvalues of them. G = grid CTAs a
// column tile of tw columns, vec columns a lane, rounds of q chunks (nb = q
// * cb blocks) in a ring of `stages` (2, or 1 with nb < cb a slice of a
// chunk), a Y tile of tile_rows rows, `threads` a power of two in [32,
// 512]. smem is the wrapper's figure for the CTA's dynamic shared memory
// (checked).
int spc5_spmm_desc_whole(const int* vbase, const signed char* valid, const void* vidx,
                         const void* xcol, const void* yrow, const void* values,
                         const float* scale, const float* x, float* y, int nchunks, int cb,
                         int vmax, int nrows, int xrows, int r, int c, int vsize, int nvalues,
                         int wv, int wx, int wy, int nvec, int tw, int vec, int grid,
                         int stages, int q, int nb, int tile_rows, int smem, int threads,
                         int device, void* stream) {
  WholeGeom g = desc_whole_geom(nchunks, cb, vmax, nrows, xrows, r, c, nvec, tw, vec, grid,
                                stages, q, nb, tile_rows);
  g.x = x;
  g.y = y;
  switch (vsize) {
    case 4:
      return launch_desc_whole<float>(g, vbase, valid, vidx, xcol, yrow, values, scale, nvalues,
                                      wv, wx, wy, smem, threads, device, stream);
    case 2:
      return launch_desc_whole<__nv_bfloat16>(g, vbase, valid, vidx, xcol, yrow, values, scale,
                                              nvalues, wv, wx, wy, smem, threads, device,
                                              stream);
    case 1:
      return launch_desc_whole<int8_t>(g, vbase, valid, vidx, xcol, yrow, values, scale,
                                       nvalues, wv, wx, wy, smem, threads, device, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The whole-vector kernel's occupancy for vsize-byte values, block shape
// (r, c), vec columns a lane, `threads` and `smem` bytes of dynamic shared
// memory per CTA: out[0] the CTAs one SM holds at once, out[1] the SMs of
// the device.
int spc5_spmm_desc_whole_occupancy(int vsize, int r, int c, int vec, int threads, int smem,
                                   int device, int* out) {
  switch (vsize) {
    case 4: return whole_occupancy(desc_whole_kernel<float>(r, c, vec), threads, smem, device, out);
    case 2:
      return whole_occupancy(desc_whole_kernel<__nv_bfloat16>(r, c, vec), threads, smem, device,
                             out);
    case 1:
      return whole_occupancy(desc_whole_kernel<int8_t>(r, c, vec), threads, smem, device, out);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The dynamic shared memory of one whole-vector CTA for vsize-byte values,
// as the launch computes it (whole_layout with this kernel's stage).
int spc5_spmm_desc_whole_smem(int stages, int q, int nb, int r, int c, int vmax, int wv, int wx,
                              int tw, int vec, int tile_rows, int threads, int vsize) {
  return desc_whole_smem(
      vsize, desc_whole_geom(1, nb, vmax, 1, 0, r, c, 1, tw, vec, 1, stages, q, nb, tile_rows), wv,
      wx, threads);
}

// The synchronous panel kernel: split CTAs per (panel, row part, column
// tile), q chunks a stage of nb blocks (nb == q * cb, or q == 1 and nb < cb
// where a whole chunk's stage does not fit), `parts` row parts of prows
// rows, tw columns a tile, vec columns a lane (4 or 2 need nvec a multiple
// of it and X so aligned), `threads` a power of two in [32, 512], values of
// vsize bytes (4 f32, 2 bf16, 1 int8 with its (npanels, nchunks) scales;
// scale is unread otherwise). smem is the wrapper's figure for the CTA's
// dynamic shared memory (checked).
int spc5_spmm_desc_panels_s1(const int* vbase, const int* xbase, const signed char* valid,
                             const void* vidx, const void* xcol, const void* yrow,
                             const void* values, const float* scale, const float* x, float* y,
                             int npanels, int nchunks, int cb, int r, int c, int vmax, int pr,
                             int nrows, int xrows, int vsize, int nvalues, int wv, int wx, int wy,
                             int nvec, int tw, int vec, int parts, int prows, int split, int q,
                             int nb, int smem, int threads, int device, void* stream) {
  const PanelArgs a = panel_args(vbase, xbase, valid, vidx, xcol, yrow, values, scale, x, y,
                                 nchunks, cb, r, c, vmax, pr, nrows, xrows, vsize, nvalues, wv,
                                 wx, wy, nvec, tw, vec, parts, prows, split, q, nb);
  return launch_panels(1, a, npanels, smem, threads, device, stream);
}

// The staged-ahead panel kernel: a ring of two stages of q whole chunks.
int spc5_spmm_desc_panels_s2(const int* vbase, const int* xbase, const signed char* valid,
                             const void* vidx, const void* xcol, const void* yrow,
                             const void* values, const float* scale, const float* x, float* y,
                             int npanels, int nchunks, int cb, int r, int c, int vmax, int pr,
                             int nrows, int xrows, int vsize, int nvalues, int wv, int wx, int wy,
                             int nvec, int tw, int vec, int parts, int prows, int split, int q,
                             int smem, int threads, int device, void* stream) {
  const PanelArgs a = panel_args(vbase, xbase, valid, vidx, xcol, yrow, values, scale, x, y,
                                 nchunks, cb, r, c, vmax, pr, nrows, xrows, vsize, nvalues, wv,
                                 wx, wy, nvec, tw, vec, parts, prows, split, q, q * cb);
  return launch_panels(2, a, npanels, smem, threads, device, stream);
}

// The panel kernel's occupancy at `stages` (1: the synchronous kernel, 2:
// the ring), vsize-byte values, block shape (r, c), vec columns a lane,
// `threads` and `smem` bytes of dynamic shared memory per CTA: out[0] the
// CTAs one SM holds at once, out[1] the SMs of the device.
int spc5_spmm_desc_panels_occupancy(int stages, int vsize, int r, int c, int vec, int threads,
                                    int smem, int device, int* out) {
  return panel_occupancy(panel_kernel<PanelArgs>(vsize, r, c, vec, stages), threads, smem,
                         device, out);
}

// The dynamic shared memory of one panel CTA with `stages` stages of nb
// blocks of q chunks each, vsize-byte values and a (prows, tw) Y tile, as
// the launch computes it (panel_layout).
int spc5_spmm_desc_panels_smem(int stages, int q, int nb, int r, int c, int vmax, int prows,
                               int tw, int wv, int wx, int vsize) {
  PanelArgs a{};
  a.vsize = vsize;
  a.q = q;
  a.nb = nb;
  a.r = r;
  a.c = c;
  a.vmax = vmax;
  a.prows = prows;
  a.tw = tw;
  a.wv = wv;
  a.wx = wx;
  return (int)panel_smem(a, stages);
}

}  // extern "C"
