// The singleton tail of the beta(r,c)_test split for Hopper (sm_90a): the
// blocks with one nonzero, as COO sorted into one bucket per row panel.
//
// Replaces the Pallas TPU kernel of src/repro/kernels/spc5_spmv.py:
//   spc5_spmv_tail  <- spmv_tail_pallas (_spmv_tail_kernel)
// It computes what that kernel computes: for each panel bucket p and each of
// its smax slots, y_tile[clip(row, 0, pr-1)] += val * x[xbase[p] +
// clip(col - xbase[p], 0, xw-1)], with x zero past its end, and writes the
// (pr,) tile once to y[p*pr, p*pr + pr) cut at nrows. Padding slots (val 0,
// local row 0, column 0) are multiplied like any other, as the reference
// multiplies them.
//
// Bound: memory. Each slot is read once (int32 row, int32 col, f32 value:
// 12 bytes) and does 2 flops; x (reused by every panel) stays in L1/L2. What
// the design does about it:
//   * one CTA per panel bucket, with the (pr,) y tile in shared memory:
//     each output row is written once and no global atomic is used (the
//     property of the panel kernels). On a 64,000-row layer with pr = 512
//     that is 125 CTAs for 132 SMs, so each CTA keeps many loads in flight:
//     1024 threads, each warp loading kUnroll groups of 32 consecutive slots
//     (128-byte coalesced loads) before it uses any;
//   * x is read in place through L1 at the clipped index (no staged window:
//     the widest bucket's span can be the whole row of x), and a column at or
//     past ncols reads 0, which is what the reference's zero padding of x up
//     to tail_ncols_pad gives, without a copy;
//   * colliding adds: inside a bucket the slots are sorted by (local row,
//     column), so neighbouring lanes mostly share a row (about 125 slots per
//     row on that layer) and a shared atomicAdd per slot would serialise
//     32-way. Each group of 32 is instead reduced in the warp first: the
//     lanes where the row changes are found with one ballot, each lane sums
//     its run's suffix with five shuffles, and only the first lane of each
//     run adds into the tile (one shared atomic per run, which two warps
//     meet only at the run that straddles their groups).
// The f32 sum of a row is taken in another order than the reference's.
//
// The launcher runs on the caller's stream, allocates nothing, does not
// synchronise, and returns cudaGetLastError() (0 on success).

#include "spc5_stage.cuh"

namespace {

constexpr int kThreads = 1024;
constexpr int kUnroll = 4;
constexpr unsigned kFull = 0xffffffffu;

__global__ void __launch_bounds__(kThreads)
spmv_tail_kernel(const int* __restrict__ xbase, const int* __restrict__ rows,
                 const int* __restrict__ cols, const float* __restrict__ vals,
                 const float* __restrict__ x, float* __restrict__ y, int smax, int pr, int xw,
                 int nrows, int ncols) {
  extern __shared__ float ytile[];
  const int p = blockIdx.x;
  for (int i = threadIdx.x; i < pr; i += blockDim.x) ytile[i] = 0.f;
  __syncthreads();
  const int xb = xbase[p];
  const size_t base = (size_t)p * smax;
  const int lane = threadIdx.x & 31;
  const int nwarps = blockDim.x >> 5;
  // warp w takes groups [g, g + kUnroll) of 32 slots, then steps over the
  // groups the other warps take
  for (int g = (threadIdx.x >> 5) * kUnroll; g * 32 < smax; g += nwarps * kUnroll) {
    int row[kUnroll], col[kUnroll];
    float val[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int s = (g + u) * 32 + lane;
      const bool in = s < smax;
      // -1 marks a lane past the bucket's end: its own run, never written
      row[u] = in ? min(max(__ldg(rows + base + s), 0), pr - 1) : -1;
      col[u] = in ? __ldg(cols + base + s) : 0;
      val[u] = in ? __ldg(vals + base + s) : 0.f;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      float xv = 0.f;
      if (row[u] >= 0) {
        const int xi = xb + min(max(col[u] - xb, 0), xw - 1);
        if (xi < ncols) xv = __ldg(x + xi);
      }
      val[u] *= xv;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int r = row[u];
      const int prev = __shfl_up_sync(kFull, r, 1);
      const bool head = lane == 0 || prev != r;
      const unsigned heads = __ballot_sync(kFull, head);
      // the run of lane i is [i, end): end is the next head after i, or 32
      const unsigned later = lane == 31 ? 0u : heads >> (lane + 1);
      const int end = later ? lane + __ffs(later) : 32;
      float v = val[u];
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const float o = __shfl_down_sync(kFull, v, d);
        if (lane + d < end) v += o;
      }
      if (head && r >= 0) atomicAdd(ytile + r, v);
    }
  }
  __syncthreads();
  const int row0 = p * pr;
  const int nout = min(pr, nrows - row0);
  for (int i = threadIdx.x; i < nout; i += blockDim.x) y[row0 + i] = ytile[i];
}

}  // namespace

extern "C" {

int spc5_spmv_tail(const int* xbase, const int* rows, const int* cols, const float* vals,
                   const float* x, float* y, int npanels, int smax, int pr, int xw, int nrows,
                   int ncols, int device, void* stream) {
  const size_t smem = (size_t)pr * sizeof(float);
  cudaError_t err = prepare_launch(spmv_tail_kernel, device, smem, kThreads, nullptr);
  if (err != cudaSuccess) return (int)err;
  spmv_tail_kernel<<<npanels, kThreads, smem, (cudaStream_t)stream>>>(
      xbase, rows, cols, vals, x, y, smax, pr, xw, nrows, ncols);
  return (int)cudaGetLastError();
}

}  // extern "C"
