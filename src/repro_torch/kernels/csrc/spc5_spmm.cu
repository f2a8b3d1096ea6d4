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
// The kernels, their design and their launch checks are in
// spc5_spmm_mask.cuh, which spc5_spmm_cmap.cu includes too for their
// column-map twins.
//
// Each launcher runs on the caller's stream, allocates nothing, does not
// synchronise, and returns cudaGetLastError() (0 on success).

#include "spc5_spmm_mask.cuh"

extern "C" {

// The whole-vector kernel (spc5_spmm_whole.cuh): Y = A @ X over all
// nchunks chunks of cb blocks, X (xrows, nvec) read in place, Y (nrows,
// nvec) zeroed by the caller, values of vsize bytes (4 f32, 2 bf16, 1 int8
// with its (nchunks,) scales; scale is unread otherwise), nvalues of them.
// G = grid CTAs a column tile of tw columns, vec columns a lane, rounds of q
// chunks (nb = q * cb blocks) in a ring of `stages` (2, or 1 with nb < cb a
// slice of a chunk), a Y tile of tile_rows rows, `threads` a power of two in
// [32, 512]. smem is the wrapper's figure for the CTA's dynamic shared
// memory (checked).
int spc5_spmm_whole(const int* vbase, const int* col, const uint32_t* mask, const int* voff,
                    const int* row, const void* values, const float* scale, const float* x,
                    float* y, int nchunks, int cb, int vmax, int nrows, int xrows, int r, int c,
                    int vsize, int nvalues, int nvec, int tw, int vec, int grid, int stages,
                    int q, int nb, int tile_rows, int smem, int threads, int device,
                    void* stream) {
  WholeGeom g = mask_whole_geom(nchunks, cb, vmax, nrows, xrows, r, c, nvec, tw, vec, grid,
                                stages, q, nb, tile_rows);
  g.x = x;
  g.y = y;
  return launch_mask_whole<false>(vsize, g, vbase, col, mask, voff, row, values, scale, nvalues,
                                  nullptr, smem, threads, device, stream);
}

// The whole-vector kernel's occupancy for vsize-byte values, block shape
// (r, c), vec columns a lane, `threads` and `smem` bytes of dynamic shared
// memory per CTA: out[0] the CTAs one SM holds at once, out[1] the SMs of
// the device.
int spc5_spmm_whole_occupancy(int vsize, int r, int c, int vec, int threads, int smem, int device,
                              int* out) {
  return mask_whole_occupancy<false>(vsize, r, c, vec, threads, smem, device, out);
}

// The dynamic shared memory of one whole-vector CTA for vsize-byte values,
// as the launch computes it (whole_layout with this kernel's stage).
int spc5_spmm_whole_smem(int stages, int q, int nb, int r, int c, int vmax, int tw, int vec,
                         int tile_rows, int threads, int vsize) {
  return mask_whole_smem(
      vsize, mask_whole_geom(1, nb, vmax, 1, 0, r, c, 1, tw, vec, 1, stages, q, nb, tile_rows),
      threads);
}

// The synchronous panel kernel: S = split CTAs per (panel, row part, column
// tile), each a contiguous range of the panel's chunks, q chunks a stage,
// copied and waited for before the walk; `parts` row parts of prows rows,
// tw columns a tile, vec columns a lane (4 or 2 need nvec a multiple of it
// and X so aligned), `threads` a power of two in [32, 512]; X is (xrows,
// nvec), read in place; values of vsize bytes (4 f32, 2 bf16, 1 int8 with
// its (npanels, nchunks) scales; scale is unread otherwise), nvalues of
// them. smem is the wrapper's figure for the CTA's dynamic shared memory
// (checked).
int spc5_spmm_panels_s1(const int* vbase, const int* xbase, const int* col, const uint32_t* mask,
                        const int* voff, const int* row, const void* values, const float* scale,
                        const float* x, float* y, int npanels, int nchunks, int cb, int vmax,
                        int pr, int nrows, int xrows, int r, int c, int vsize, int nvalues,
                        int nvec, int tw, int vec, int parts, int prows, int split, int q,
                        int smem, int threads, int device, void* stream) {
  return launch_panels(1,
                       panel_args(vbase, xbase, col, mask, voff, row, values, scale, x, y, nchunks,
                                  cb, vmax, pr, nrows, xrows, r, c, vsize, nvalues, nvec, tw,
                                  vec, parts, prows, split, q),
                       npanels, smem, threads, device, stream);
}

// The staged-ahead panel kernel: a ring of two stages of q chunks, one
// round ahead of the walk.
int spc5_spmm_panels_s2(const int* vbase, const int* xbase, const int* col, const uint32_t* mask,
                        const int* voff, const int* row, const void* values, const float* scale,
                        const float* x, float* y, int npanels, int nchunks, int cb, int vmax,
                        int pr, int nrows, int xrows, int r, int c, int vsize, int nvalues,
                        int nvec, int tw, int vec, int parts, int prows, int split, int q,
                        int smem, int threads, int device, void* stream) {
  return launch_panels(2,
                       panel_args(vbase, xbase, col, mask, voff, row, values, scale, x, y, nchunks,
                                  cb, vmax, pr, nrows, xrows, r, c, vsize, nvalues, nvec, tw,
                                  vec, parts, prows, split, q),
                       npanels, smem, threads, device, stream);
}

// The panel kernel's occupancy at `stages` (1: the synchronous kernel, 2:
// the ring), vsize-byte values, block width c, vec columns a lane,
// `threads` and `smem` bytes of dynamic shared memory per CTA: out[0] the
// CTAs one SM holds at once, out[1] the SMs of the device.
int spc5_spmm_panels_occupancy(int stages, int vsize, int c, int vec, int threads, int smem,
                               int device, int* out) {
  return occupancy(panel_kernel<PanelArgs>(vsize, c, vec, stages), threads, smem, device, out);
}

// The dynamic shared memory of one panel CTA with `stages` stages of q
// chunks of cb blocks, a (prows, tw) Y tile and vsize-byte values, as the
// launch computes it (panel_layout).
int spc5_spmm_panels_smem(int stages, int q, int cb, int vmax, int prows, int tw, int vsize) {
  PanelArgs a{};
  a.q = q;
  a.cb = cb;
  a.vmax = vmax;
  a.prows = prows;
  a.tw = tw;
  a.vsize = vsize;
  return (int)panel_smem(a, stages);
}

}  // extern "C"
