// SPC5 panel descriptor SpMM for Hopper (sm_90a) with a column map: the
// panel kernels of spc5_spmm_desc.cu (spc5_spmm_desc_panels.cuh) built for
// CmapPanelArgs, a reordered plan's fused column permutation. X (xrows,
// nvec) stays in the original row order, and a set lane of permuted column
// col reads X's row cmap[col].
//
// Replaces the column-map path (col_map) of the two Pallas TPU panel
// descriptor SpMM kernels of src/repro/kernels/spc5_spmm.py:
//   spc5_spmm_desc_panels_cmap_s1  <- spmm_pallas_panels_desc    (col_map)
//   spc5_spmm_desc_panels_cmap_s2  <- spmm_pallas_panels_desc_db (col_map)
// The reference keeps all of x and the map in VMEM while they fit 2 MiB and
// materialises x[col_map] past that; these kernels map at every width.
//
// A library of its own: its 126 instantiations (three value types, seven
// block shapes, three lane widths, two rings) compile beside
// spc5_spmm_desc.cu's in parallel instead of after them.
//
// Each launcher runs on the caller's stream, allocates nothing, does not
// synchronise, and returns cudaGetLastError() (0 on success).

#include "spc5_spmm_desc_panels.cuh"

namespace {

CmapPanelArgs cmap_args(const PanelArgs& base, const int* cmap) {
  CmapPanelArgs a{};
  static_cast<PanelArgs&>(a) = base;
  a.cmap = cmap;
  return a;
}

}  // namespace

extern "C" {

// The synchronous panel kernel with a column map: the arguments of
// spc5_spmm_desc_panels_s1, then cmap ((xrows,) int32, the row of X each
// permuted column reads).
int spc5_spmm_desc_panels_cmap_s1(const int* vbase, const int* xbase, const signed char* valid,
                                  const void* vidx, const void* xcol, const void* yrow,
                                  const void* values, const float* scale, const float* x,
                                  float* y, int npanels, int nchunks, int cb, int r, int c,
                                  int vmax, int pr, int nrows, int xrows, int vsize, int nvalues,
                                  int wv, int wx, int wy, int nvec, int tw, int vec, int parts,
                                  int prows, int split, int q, int nb, int smem, int threads,
                                  int device, void* stream, const int* cmap) {
  const CmapPanelArgs a = cmap_args(
      panel_args(vbase, xbase, valid, vidx, xcol, yrow, values, scale, x, y, nchunks, cb, r, c,
                 vmax, pr, nrows, xrows, vsize, nvalues, wv, wx, wy, nvec, tw, vec, parts, prows,
                 split, q, nb),
      cmap);
  return launch_panels(1, a, npanels, smem, threads, device, stream);
}

// The staged-ahead panel kernel with a column map: the arguments of
// spc5_spmm_desc_panels_s2, then cmap.
int spc5_spmm_desc_panels_cmap_s2(const int* vbase, const int* xbase, const signed char* valid,
                                  const void* vidx, const void* xcol, const void* yrow,
                                  const void* values, const float* scale, const float* x,
                                  float* y, int npanels, int nchunks, int cb, int r, int c,
                                  int vmax, int pr, int nrows, int xrows, int vsize, int nvalues,
                                  int wv, int wx, int wy, int nvec, int tw, int vec, int parts,
                                  int prows, int split, int q, int smem, int threads, int device,
                                  void* stream, const int* cmap) {
  const CmapPanelArgs a = cmap_args(
      panel_args(vbase, xbase, valid, vidx, xcol, yrow, values, scale, x, y, nchunks, cb, r, c,
                 vmax, pr, nrows, xrows, vsize, nvalues, wv, wx, wy, nvec, tw, vec, parts, prows,
                 split, q, q * cb),
      cmap);
  return launch_panels(2, a, npanels, smem, threads, device, stream);
}

// The occupancy of the panel kernel with a column map, as
// spc5_spmm_desc_panels_occupancy reports its twin's.
int spc5_spmm_desc_panels_cmap_occupancy(int stages, int vsize, int r, int c, int vec,
                                         int threads, int smem, int device, int* out) {
  return panel_occupancy(panel_kernel<CmapPanelArgs>(vsize, r, c, vec, stages), threads, smem,
                         device, out);
}

}  // extern "C"
