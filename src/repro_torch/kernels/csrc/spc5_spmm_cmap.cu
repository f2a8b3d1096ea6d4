// SPC5 mask-decode SpMM for Hopper (sm_90a) with a column map: the kernels
// of spc5_spmm.cu (spc5_spmm_mask.cuh) built for a reordered plan's fused
// column permutation. X (xrows, nvec) stays in the original row order, and
// a kept lane of permuted column col reads X's row cmap[col].
//
// Replaces the column-map path (col_map) of the three Pallas TPU mask-SpMM
// kernels of src/repro/kernels/spc5_spmm.py:
//   spc5_spmm_whole_cmap      <- spmm_pallas            (col_map)
//   spc5_spmm_panels_cmap_s1  <- spmm_pallas_panels     (col_map)
//   spc5_spmm_panels_cmap_s2  <- spmm_pallas_panels_db  (col_map)
// The reference keeps all of x and the map in VMEM while they fit 2 MiB and
// materialises x[col_map] past that; these kernels map at every width.
//
// A library of its own: its instantiations (three value types; seven block
// shapes and three lane widths whole-vector, two block widths, three lane
// widths and two rings in panels) compile beside spc5_spmm.cu's in parallel
// instead of after them.
//
// Each launcher runs on the caller's stream, allocates nothing, does not
// synchronise, and returns cudaGetLastError() (0 on success).

#include "spc5_spmm_mask.cuh"

extern "C" {

// The whole-vector kernel with a column map: the arguments of
// spc5_spmm_whole, then cmap ((xrows,) int32, the row of X each permuted
// column reads).
int spc5_spmm_whole_cmap(const int* vbase, const int* col, const uint32_t* mask,
                         const int* voff, const int* row, const void* values,
                         const float* scale, const float* x, float* y, int nchunks, int cb,
                         int vmax, int nrows, int xrows, int r, int c, int vsize, int nvalues,
                         int nvec, int tw, int vec, int grid, int stages, int q, int nb,
                         int tile_rows, int smem, int threads, int device, void* stream,
                         const int* cmap) {
  WholeGeom g = mask_whole_geom(nchunks, cb, vmax, nrows, xrows, r, c, nvec, tw, vec, grid,
                                stages, q, nb, tile_rows);
  g.x = x;
  g.y = y;
  return launch_mask_whole<true>(vsize, g, vbase, col, mask, voff, row, values, scale, nvalues,
                                 cmap, smem, threads, device, stream);
}

// The occupancy of the whole-vector kernel with a column map, as
// spc5_spmm_whole_occupancy reports its twin's.
int spc5_spmm_whole_cmap_occupancy(int vsize, int r, int c, int vec, int threads, int smem,
                                   int device, int* out) {
  return mask_whole_occupancy<true>(vsize, r, c, vec, threads, smem, device, out);
}

// The synchronous panel kernel with a column map: the arguments of
// spc5_spmm_panels_s1, then cmap.
int spc5_spmm_panels_cmap_s1(const int* vbase, const int* xbase, const int* col,
                             const uint32_t* mask, const int* voff, const int* row,
                             const void* values, const float* scale, const float* x, float* y,
                             int npanels, int nchunks, int cb, int vmax, int pr, int nrows,
                             int xrows, int r, int c, int vsize, int nvalues, int nvec, int tw,
                             int vec, int parts, int prows, int split, int q, int smem,
                             int threads, int device, void* stream, const int* cmap) {
  CmapPanelArgs a{};
  static_cast<PanelArgs&>(a) =
      panel_args(vbase, xbase, col, mask, voff, row, values, scale, x, y, nchunks, cb, vmax, pr,
                 nrows, xrows, r, c, vsize, nvalues, nvec, tw, vec, parts, prows, split, q);
  a.cmap = cmap;
  return launch_panels(1, a, npanels, smem, threads, device, stream);
}

// The staged-ahead panel kernel with a column map: the arguments of
// spc5_spmm_panels_s2, then cmap.
int spc5_spmm_panels_cmap_s2(const int* vbase, const int* xbase, const int* col,
                             const uint32_t* mask, const int* voff, const int* row,
                             const void* values, const float* scale, const float* x, float* y,
                             int npanels, int nchunks, int cb, int vmax, int pr, int nrows,
                             int xrows, int r, int c, int vsize, int nvalues, int nvec, int tw,
                             int vec, int parts, int prows, int split, int q, int smem,
                             int threads, int device, void* stream, const int* cmap) {
  CmapPanelArgs a{};
  static_cast<PanelArgs&>(a) =
      panel_args(vbase, xbase, col, mask, voff, row, values, scale, x, y, nchunks, cb, vmax, pr,
                 nrows, xrows, r, c, vsize, nvalues, nvec, tw, vec, parts, prows, split, q);
  a.cmap = cmap;
  return launch_panels(2, a, npanels, smem, threads, device, stream);
}

// The occupancy of the panel kernel with a column map, as
// spc5_spmm_panels_occupancy reports its twin's.
int spc5_spmm_panels_cmap_occupancy(int stages, int vsize, int c, int vec, int threads, int smem,
                                    int device, int* out) {
  return occupancy(panel_kernel<CmapPanelArgs>(vsize, c, vec, stages), threads, smem, device,
                   out);
}

}  // extern "C"
