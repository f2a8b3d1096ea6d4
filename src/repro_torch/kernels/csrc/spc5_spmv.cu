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
// f32 rate per byte. Unset lanes are skipped (the Pallas kernels clip their
// indices and multiply by 0 instead), so no x or y element outside the
// matrix is touched and a lane costs nothing unless its bit is set.
//
// Whole-vector kernels (spmv_whole_kernel):
//   * values are staged per chunk into shared memory with 16-byte copies
//     (vbase and vmax are multiples of 8 values, so every window is
//     16-byte aligned and whole float4s); kStages == 2 prefetches the next
//     chunk's window with cp.async while the current one decodes, the
//     counterpart of the Pallas double buffer;
//   * block metadata is read once, one thread per block slot, so neighbouring
//     threads read neighbouring words;
//   * chunks are cut every cb blocks whatever the row interval, so
//     neighbouring chunks can share y rows; CTAs walk chunks in a
//     grid-stride loop and add into a zeroed y with one global atomicAdd per
//     (block, row) that has a nonzero. The f32 sum order therefore varies
//     from run to run.
//
// Panel kernels (spmv_panels_kernel), built for latency, not for the TPU's
// sequential grid:
//   * split grid: each panel's chunk list is cut into S contiguous ranges,
//     one CTA each (grid npanels * S; the wrapper picks S from the card's
//     occupancy). A CTA sums its range into a (pr,) y tile in shared memory
//     (pr is a multiple of r, so no block straddles two panels) and adds the
//     tile's nonzero rows into a zeroed y with one global atomicAdd per row
//     (plain stores when S == 1), so the f32 sum order varies run to run;
//   * staged metadata: a stage holds the chunk's value window and its cb
//     entries of chunk_col, chunk_mask, chunk_voff and chunk_row (16 B a
//     block slot). One thread issues them as bulk copies (the TMA's
//     one-dimensional form: one instruction a contiguous run) that complete
//     on the stage's mbarrier; only metadata rows that are not 16-byte
//     aligned (cb % 4 != 0) are copied by every thread, in 4-byte cp.async
//     pieces. kStages >= 2 keeps a ring of stages kStages - 1 chunks ahead
//     of the decode, with one CTA barrier per chunk; kStages == 1 is the
//     synchronous twin: one stage, copied and waited for before each
//     decode, nothing staged ahead. The decode reads no metadata from
//     device memory;
//   * a block row per thread: thread t takes row t % r of blocks t / r,
//     t / r + blockDim / r, ... and finds a row's first packed value by one
//     popcount of the mask bits before it, then walks only the row's set
//     bits (a beta(4,8) block holds about 4 nonzeros of its 32 lanes) and
//     adds the row's sum into the tile with one shared-memory atomic, only
//     where a bit is set;
//   * few instructions a chunk: the copies cost the CTA a handful of
//     instructions, and what a thread decodes in every chunk (ThreadPlan)
//     is worked out once per CTA, so a chunk costs a thread its rows' decode,
//     an mbarrier wait and the ring's barrier;
//   * x is read in place through L1 at each set lane, x[xbase + col + lc]:
//     a panel chunk's blocks are sorted by column, so its set lanes read a
//     few neighbouring x sectors (staging the xw-wide x window with the
//     chunk was slower on the H100, and so was a bounds check per lane: the
//     decode is bound by its instructions). The wrapper pads an x shorter
//     than ncols_pad, as the Pallas wrappers do.
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
// panel layout: S CTAs per panel, staged chunk metadata, a block row per
// thread, (pr,) y tile per CTA
// ---------------------------------------------------------------------------

struct PanelArgs {
  const int* vbase;  // (npanels, nchunks) value window starts
  const int* xbase;  // (npanels, nchunks) x window starts
  const int* col;    // (npanels, nchunks, cb) window-relative block columns
  const uint32_t* mask;
  const int* voff;   // offsets of the blocks' first values in the window
  const int* row;    // panel-relative first rows
  const float* values;
  const float* x;    // at least ncols_pad entries
  float* y;
  int nchunks, cb, vmax, pr, nrows, r, c;
  int split;  // S: CTAs per panel, each a contiguous range of its chunks
};

__host__ __device__ inline int round16(int n) { return (n + 15) & ~15; }

// Byte offsets of one stage's parts, each 16-byte aligned: the value window,
// the chunk's four metadata rows (col, mask, voff, row; meta_stride bytes
// apart) and a 16-byte slot holding the chunk's x window start and, at byte
// 8, the stage's mbarrier. The y tile (pr floats) comes before the first
// stage. The wrapper plans with its copy (kernels/spc5_spmv.py:
// panels_smem_bytes) and passes its figure in; a launch whose figure
// differs is refused, and spc5_spmv_panels_smem exposes this one for the
// wrapper's tests.
struct StageLayout {
  int vwin, meta, meta_stride, xb, bytes;
};

__host__ __device__ inline StageLayout stage_layout(const PanelArgs& a) {
  StageLayout L;
  L.vwin = 0;
  L.meta = round16(4 * a.vmax);
  L.meta_stride = round16(4 * a.cb);
  L.xb = L.meta + 4 * L.meta_stride;
  L.bytes = L.xb + 16;
  return L;
}

inline size_t panels_smem(const PanelArgs& a, int stages) {
  return (size_t)round16(4 * a.pr) + (size_t)stages * stage_layout(a).bytes;
}

// What each thread of a panel CTA does in every chunk, fixed for the whole
// launch: its block rows (row lr = threadIdx % r of blocks threadIdx / r,
// + blockDim / r, ...; r divides 32, blockDim is a multiple of 32) and,
// where the metadata rows are not 16-byte aligned, its share of their copy
// (row m = threadIdx % 4, 4-byte pieces threadIdx / 4, + blockDim / 4, ...).
struct ThreadPlan {
  const char* msrc;  // its metadata row's array, as bytes
  int mdst;          // that row's offset in a stage
  int b0, bstep;     // its first block and the step to the next
  int lr, shift;     // its row in a block, and lr * c: the row's bits in a mask
  uint32_t below;    // the mask bits before its row
};

__device__ __forceinline__ ThreadPlan thread_plan(const PanelArgs& a, const StageLayout& L) {
  ThreadPlan t;
  const int m = threadIdx.x & 3;
  const int* row = m == 0   ? a.col
                   : m == 1 ? reinterpret_cast<const int*>(a.mask)
                   : m == 2 ? a.voff
                            : a.row;
  t.msrc = reinterpret_cast<const char*>(row);
  t.mdst = L.meta + m * L.meta_stride;
  const int lr_bits = __ffs(a.r) - 1;
  t.b0 = threadIdx.x >> lr_bits;
  t.bstep = blockDim.x >> lr_bits;
  t.lr = threadIdx.x & (a.r - 1);
  t.shift = t.lr * a.c;  // < 32: r * c <= 32
  t.below = (1u << t.shift) - 1u;
  return t;
}

// The stage's mbarrier, in its slot after the x window start.
__device__ __forceinline__ uint64_t* stage_bar(unsigned char* st, const StageLayout& L) {
  return reinterpret_cast<uint64_t*>(st + L.xb + 8);
}

// Start the copy of chunk g's stage: thread 0 writes the chunk's x window
// start xb into the stage's slot and issues bulk copies of the value window
// at vb and, where `wide`, the chunk's four metadata rows, all completing on
// the stage's mbarrier; where not (cb % 4 != 0, or an array off a 16-byte
// boundary), every thread copies its share of the metadata rows with 4-byte
// cp.async, completed by the caller's cp.async wait.
__device__ __forceinline__ void stage_chunk(unsigned char* st, const StageLayout& L,
                                            const PanelArgs& a, const ThreadPlan& t, bool wide,
                                            size_t g, int vb, int xb) {
  const int nbytes = 4 * a.cb;  // a metadata row
  if (threadIdx.x == 0) {
    *reinterpret_cast<int*>(st + L.xb) = xb;
    uint64_t* bar = stage_bar(st, L);
    mbar_expect_tx(bar, 4 * a.vmax + (wide ? 4 * nbytes : 0));
    bulk_copy(st + L.vwin, a.values + vb, 4 * a.vmax, bar);
    if (wide) {
      bulk_copy(st + L.meta, a.col + g * a.cb, nbytes, bar);
      bulk_copy(st + L.meta + L.meta_stride, a.mask + g * a.cb, nbytes, bar);
      bulk_copy(st + L.meta + 2 * L.meta_stride, a.voff + g * a.cb, nbytes, bar);
      bulk_copy(st + L.meta + 3 * L.meta_stride, a.row + g * a.cb, nbytes, bar);
    }
  }
  if (!wide) {
    const char* msrc = t.msrc + g * nbytes;
    for (int k = 4 * (threadIdx.x >> 2); k < nbytes; k += blockDim.x) {
      cp_async4(st + t.mdst + k, msrc + k);
    }
  }
}

// Add the staged chunk into the y tile, a block row per thread (ThreadPlan).
// The row's first value is voff + popc(mask bits before the row); only the
// row's set bits are walked, each reading x in place (the wrapper makes x
// long enough for every chunk's window), and the row adds into the tile
// once, if a bit is set.
__device__ __forceinline__ void decode_stage(const unsigned char* st, const StageLayout& L,
                                             const PanelArgs& a, const ThreadPlan& t,
                                             float* ytile) {
  const float* vwin = reinterpret_cast<const float*>(st + L.vwin);
  const int xb = *reinterpret_cast<const int*>(st + L.xb);  // the chunk's x window start
  const uint32_t row_mask = (1u << a.c) - 1u;
  const int ms = L.meta_stride;
  for (int b = t.b0; b < a.cb; b += t.bstep) {
    const unsigned char* w = st + L.meta + 4 * b;  // the block's col word
    const uint32_t mask = *reinterpret_cast<const uint32_t*>(w + ms);
    uint32_t bits = (mask >> t.shift) & row_mask;
    if (bits == 0u) continue;  // an empty row, a padding block or chunk
    const float* v = vwin + *reinterpret_cast<const int*>(w + 2 * ms) + __popc(mask & t.below);
    const int xi = xb + *reinterpret_cast<const int*>(w);
    float acc = 0.f;
    do {
      acc = fmaf(*v++, __ldg(a.x + (xi + __ffs(bits) - 1)), acc);
      bits &= bits - 1u;
    } while (bits);
    atomicAdd(ytile + *reinterpret_cast<const int*>(w + 3 * ms) + t.lr, acc);
  }
}

template <int kStages>
__global__ void __launch_bounds__(256) spmv_panels_kernel(const PanelArgs a) {
  extern __shared__ __align__(16) float smem[];
  const StageLayout L = stage_layout(a);
  const ThreadPlan t = thread_plan(a, L);
  const bool wide = ((reinterpret_cast<uintptr_t>(a.col) | reinterpret_cast<uintptr_t>(a.mask) |
                      reinterpret_cast<uintptr_t>(a.voff) | reinterpret_cast<uintptr_t>(a.row) |
                      (uintptr_t)(4 * a.cb)) & 15) == 0;
  float* ytile = smem;
  unsigned char* ring = reinterpret_cast<unsigned char*>(smem) + round16(4 * a.pr);
  const int p = blockIdx.x / a.split;
  const int part = blockIdx.x - p * a.split;
  const int c0 = (int)((long long)part * a.nchunks / a.split);
  const int n = (int)((long long)(part + 1) * a.nchunks / a.split) - c0;
  const size_t g0 = (size_t)p * a.nchunks + c0;  // global index of the range's first chunk
  const int* vbase = a.vbase + g0;
  const int* xbase = a.xbase + g0;
  for (int i = threadIdx.x; i < a.pr; i += blockDim.x) ytile[i] = 0.f;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) mbar_init(stage_bar(ring + s * L.bytes, L));
    mbar_fence_init();
  }
  __syncthreads();  // the barriers are initialised and the tile zeroed

  if constexpr (kStages == 1) {
    // one stage, copied and waited for before each decode: nothing is staged
    // ahead (the next chunk's window starts are)
    int vb = n > 0 ? __ldg(vbase) : 0, xb = n > 0 ? __ldg(xbase) : 0;
    for (int j = 0; j < n; ++j) {
      const int vj = vb, xj = xb;
      if (j + 1 < n) {
        vb = __ldg(vbase + j + 1);
        xb = __ldg(xbase + j + 1);
      }
      if (j > 0) __syncthreads();  // the previous decode is done
      stage_chunk(ring, L, a, t, wide, g0 + j, vj, xj);
      cp_async_commit();
      cp_async_wait<0>();
      mbar_wait(stage_bar(ring, L), j & 1);
      __syncthreads();  // everyone's copies, and the slot's xb
      decode_stage(ring, L, a, t, ytile);
    }
  } else {
    // the ring: chunk j lives in stage j % kStages; kStages - 1 chunks are
    // in flight while one decodes
    for (int s = 0; s < kStages - 1; ++s) {
      if (s < n) {
        stage_chunk(ring + s * L.bytes, L, a, t, wide, g0 + s, __ldg(vbase + s), __ldg(xbase + s));
      }
      cp_async_commit();
    }
    int vb = 0, xb = 0;  // window starts of the next chunk to stage
    if (kStages - 1 < n) {
      vb = __ldg(vbase + kStages - 1);
      xb = __ldg(xbase + kStages - 1);
    }
    int dec = 0, fill = kStages - 1;  // the stages of chunks j and j + kStages - 1
    uint32_t parity = 0;              // bit s: the parity of stage s's next phase
    for (int j = 0; j < n; ++j) {
      unsigned char* st = ring + dec * L.bytes;
      cp_async_wait<kStages - 2>();  // chunk j's 4-byte copies of this thread
      mbar_wait(stage_bar(st, L), (parity >> dec) & 1u);
      parity ^= 1u << dec;
      __syncthreads();  // ... everyone's; chunk j - 1's stage is free
      const int jn = j + kStages - 1;
      if (jn < n) stage_chunk(ring + fill * L.bytes, L, a, t, wide, g0 + jn, vb, xb);
      cp_async_commit();  // possibly empty: keeps the group count uniform
      if (jn + 1 < n) {
        vb = __ldg(vbase + jn + 1);
        xb = __ldg(xbase + jn + 1);
      }
      decode_stage(st, L, a, t, ytile);
      dec = dec + 1 == kStages ? 0 : dec + 1;
      fill = fill + 1 == kStages ? 0 : fill + 1;
    }
  }
  __syncthreads();
  const int row0 = p * a.pr;
  const int nout = min(a.pr, a.nrows - row0);
  for (int i = threadIdx.x; i < nout; i += blockDim.x) {
    const float y = ytile[i];
    if (a.split == 1) {
      a.y[row0 + i] = y;
    } else if (y != 0.f) {
      atomicAdd(a.y + row0 + i, y);
    }
  }
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

using PanelKernel = void (*)(PanelArgs);

// The panel kernel of a ring of `stages` (1: the synchronous twin); nullptr
// for any other ring.
PanelKernel panels_kernel(int stages) {
  switch (stages) {
    case 1: return spmv_panels_kernel<1>;
    case 2: return spmv_panels_kernel<2>;
    case 3: return spmv_panels_kernel<3>;
    default: return nullptr;
  }
}

int launch_panels(int stages, const int* vbase, const int* xbase, const int* col,
                  const uint32_t* mask, const int* voff, const int* row, const float* values,
                  const float* x, float* y, int npanels, int nchunks, int cb, int vmax, int pr,
                  int nrows, int r, int c, int split, int smem_planned, int threads, int device,
                  void* stream) {
  const PanelArgs a{vbase, xbase, col, mask, voff, row, values, x, y,
                    nchunks, cb, vmax, pr, nrows, r, c, split};
  const PanelKernel kernel = panels_kernel(stages);
  const size_t smem = panels_smem(a, stages);
  if (kernel == nullptr || split < 1 || split > nchunks ||
      (long long)npanels * split > 0x7fffffffLL || smem != (size_t)smem_planned ||
      threads < 32 || threads > 256 || threads % 32 != 0) {
    return (int)cudaErrorInvalidValue;
  }
  cudaError_t err = prepare_launch(kernel, device, smem, threads, nullptr);
  if (err != cudaSuccess) return (int)err;
  void* args[] = {const_cast<PanelArgs*>(&a)};
  err = cudaLaunchKernel(reinterpret_cast<const void*>(kernel), dim3(npanels * split),
                         dim3(threads), args, smem, (cudaStream_t)stream);
  return (int)(err != cudaSuccess ? err : cudaGetLastError());
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

// The synchronous panel kernel: split CTAs per panel. smem is the wrapper's
// figure for the CTA's dynamic shared memory (checked).
int spc5_spmv_panels_s1(const int* vbase, const int* xbase, const int* col, const uint32_t* mask,
                        const int* voff, const int* row, const float* values, const float* x,
                        float* y, int npanels, int nchunks, int cb, int vmax, int pr, int nrows,
                        int r, int c, int split, int smem, int threads, int device, void* stream) {
  return launch_panels(1, vbase, xbase, col, mask, voff, row, values, x, y, npanels, nchunks, cb,
                       vmax, pr, nrows, r, c, split, smem, threads, device, stream);
}

// The staged-ahead panel kernel: a ring of `stages` chunks, 2 or 3.
int spc5_spmv_panels_s2(const int* vbase, const int* xbase, const int* col, const uint32_t* mask,
                        const int* voff, const int* row, const float* values, const float* x,
                        float* y, int npanels, int nchunks, int cb, int vmax, int pr, int nrows,
                        int r, int c, int split, int stages, int smem, int threads, int device,
                        void* stream) {
  if (stages < 2) return (int)cudaErrorInvalidValue;
  return launch_panels(stages, vbase, xbase, col, mask, voff, row, values, x, y, npanels,
                       nchunks, cb, vmax, pr, nrows, r, c, split, smem, threads, device, stream);
}

// The panel kernel's occupancy at `stages` (1: the synchronous kernel),
// `threads` and `smem` bytes of dynamic shared memory per CTA: out[0] the
// CTAs one SM holds at once, out[1] the SMs of the device.
int spc5_spmv_panels_occupancy(int stages, int threads, int smem, int device, int* out) {
  const PanelKernel kernel = panels_kernel(stages);
  if (kernel == nullptr) return (int)cudaErrorInvalidValue;
  cudaError_t err = prepare_launch(kernel, device, (size_t)smem, threads, nullptr);
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(out, kernel, threads, (size_t)smem);
  }
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(out + 1, cudaDevAttrMultiProcessorCount, device);
  return (int)err;
}

// The dynamic shared memory of one panel-kernel CTA with `stages` stages, as
// the launch computes it (stage_layout).
int spc5_spmv_panels_smem(int stages, int cb, int vmax, int pr) {
  PanelArgs a{};
  a.cb = cb;
  a.vmax = vmax;
  a.pr = pr;
  return (int)panels_smem(a, stages);
}

}  // extern "C"
