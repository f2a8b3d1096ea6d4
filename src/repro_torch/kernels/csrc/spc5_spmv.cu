// SPC5 mask-decode SpMV for Hopper (sm_90a): beta(r,c) blocks with bit masks
// and no zero padding, over the two chunked layouts of
// repro_torch/core/formats.py.
//
// Replaces the four Pallas TPU kernels of src/repro/kernels/spc5_spmv.py:
//   spc5_spmv_whole_s1   <- spmv_pallas           (_spmv_kernel)
//   spc5_spmv_whole_s2   <- spmv_pallas_db        (_spmv_db_kernel)
//   spc5_spmv_panels_s1  <- spmv_pallas_panels    (_spmv_panel_kernel)
//   spc5_spmv_panels_s2  <- spmv_pallas_panels_db (_spmv_panel_db_kernel)
// All four compute what _decode_chunk computes: mask bits -> exclusive rank
// -> value from the staged window -> times x -> add into y; all four stage a
// chunk's value window and metadata alike and decode a block row per thread,
// the rank taken by one popcount.
//
// Bound: memory. One SpMV reads each packed value once (4 B per nonzero in
// f32, 2 in bf16, 1 in int8 plus an f32 scale a chunk) plus 16 B of chunk
// metadata per block slot (col, mask, voff, row), x once and writes y once;
// it does 2 flops per nonzero, far below the card's f32 rate per byte.
// Unset lanes are skipped (the Pallas kernels clip their indices and
// multiply by 0 instead), so no x or y element outside the matrix is
// touched and a lane costs nothing unless its bit is set.
//
// Whole-vector kernels (spmv_whole_kernel), built for latency, not for the
// TPU's sequential grid:
//   * contiguous chunk ranges: the launch's G CTAs (the wrapper picks G from
//     the card's occupancy with the panel kernels' split rule) each take a
//     contiguous range of the nchunks chunks, so neighbouring chunks, which
//     share rows (to_chunked cuts every cb blocks whatever the row), meet in
//     one CTA;
//   * staged chunk metadata, as in the panel kernels below: a stage holds the
//     chunk's value window and its cb entries of chunk_col, chunk_mask,
//     chunk_voff and chunk_row (16 B a block slot), copied by bulk copies on
//     the stage's mbarrier (4-byte cp.async pieces for metadata rows that
//     are not 16-byte aligned). kStages == 2 keeps a ring of two stages, one
//     chunk ahead of the decode, with one CTA barrier per chunk (a launch
//     whose every CTA takes one chunk holds one stage: there is nothing to
//     stage ahead, and the second would only cost CTAs an SM); kStages == 1
//     is the synchronous twin: one stage, copied and waited for before each
//     decode. The decode reads no metadata from device memory; x is read in
//     place through L1 at each set lane;
//   * a block row per thread (the panel kernels' ThreadPlan): thread t takes
//     row t % r of blocks t / r, t / r + blockDim / r, ..., finds the row's
//     first packed value by one popcount and walks only the row's set bits;
//   * row runs in registers: every lane of a warp decodes one block row a
//     step, in steps the warp takes together, and adds its sum to a run
//     kept while no lane's row changes. A thread keeps the same row of
//     blocks that mostly share a block row (a chunk of the vocab weight spans
//     one or two block rows), so its run often outlasts a chunk;
//   * no same-address storm and no shared float atomic (a compare-and-swap
//     loop on this card, ATOMS.CAST.SPIN): when a lane's row changes, the
//     warp combines its runs. A warp holds 32 / r neighbouring blocks, the
//     same row of each in every r-th lane, so on a plan whose block rows come
//     sorted (every plan to_chunked builds) equal rows are neighbours in that
//     subsequence; a segmented shuffle scan sums each row's runs into its
//     last lane, which adds it into the warp's own y tile with a plain load
//     and store. Rows that come out of order, or block rows not on a
//     multiple of r, are added straight into y with a global atomic instead,
//     so any chunk_row in [0, nrows) in any order is right;
//   * per-warp y tiles, summed in warp order: each warp owns `tile` rows of
//     shared memory based at a chunk's first row. When the next chunk's first
//     row leaves the tiles' first half, and at the end, the CTA sums each
//     tile row over the warps in a fixed order and adds it into a zeroed y
//     with one global atomicAdd; a row outside the tiles goes straight into
//     y. The f32 sum order is fixed within a CTA and varies from run to run
//     only through the global atomics.
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
// Values (both layouts): the value store is the kernels' template parameter
// V, float, __nv_bfloat16 or int8_t, decoded as the reference's _expand_vals
// does (spc5_stage.cuh: dequant): upcast to f32, an int8 value then times its
// chunk's f32 scale, before the product with x, summed in f32; the f32
// kernels are the code they were. A narrow window starts on any multiple of
// 8 bytes, and bulk copies need 16-byte aligned ends: it is staged as the
// 16-byte aligned span that covers it, kept inside values (value_span,
// copy_span: its last 4 to 12 bytes by cp.async), and thread 0 writes the
// window's offset in its span into the stage's slot beside the x window
// start; each thread loads the chunk's scale (int8) before waiting for the
// chunk's stage.
//
// Column maps (both layouts; spc5_spmv_whole_cmap_s1 / _s2 and
// spc5_spmv_panels_cmap_s1 / _s2, the col_map path of the same four Pallas
// kernels: a reordered plan's fused column permutation). x stays in the
// original column order and unpadded, and a set lane of permuted column j
// reads x[cmap[j]]: the map entry, then x, both through L1, one dependent
// load more a nonzero and no shared memory more (the whole-vector twins ask
// for a smaller shared-memory carve-out, so that L1 holds x and the map:
// kCmapWholeCarveout). A set lane always lies at
// a real column (j < ncols), so neither the map nor x is read out of
// bounds; unset lanes read nothing. Each twin is its own kernel
// (spmv_whole_cmap_kernel, spmv_panels_cmap_kernel) over the same body, its
// map a field of a derived argument struct (CmapWholeArgs,
// CmapPanelArgs), so the kernels without one keep their code.
//
// Each launcher runs on the caller's stream, allocates nothing, does not
// synchronise, and returns cudaGetLastError() (0 on success).

#include "spc5_stage.cuh"

namespace {

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
  const void* values;  // vsize bytes a value: float, __nv_bfloat16 or int8_t
  const float* x;    // at least ncols_pad entries
  float* y;
  int nchunks, cb, vmax, pr, nrows, r, c;
  int split;  // S: CTAs per panel, each a contiguous range of its chunks
  // last, so the other fields keep the offsets the f32 kernels had:
  const float* scale;  // (npanels, nchunks) int8 scales; unread otherwise
  int vsize;    // the values' bytes: 4, 2 or 1
  int nvalues;  // values' length: no staged span reaches past it
};

// A panel launch with a column map: PanelArgs' fields as they are, then
// the map. x is then (ncols,), in the original column order.
struct CmapPanelArgs : PanelArgs {
  const int* cmap;  // (ncols,): the column of x each permuted column reads
};

template <typename A>
constexpr bool kMapped = false;
template <>
constexpr bool kMapped<CmapPanelArgs> = true;

// The x entry a set lane of (permuted) column j reads: x[j], or with a
// column map x[cmap[j]], the map entry loaded first.
template <typename A>
__device__ __forceinline__ float x_at(const A& a, int j) {
  if constexpr (kMapped<A>) {
    return __ldg(a.x + __ldg(a.cmap + j));
  } else {
    return __ldg(a.x + j);
  }
}

__host__ __device__ inline int round16(int n) { return (n + 15) & ~15; }

// Byte offsets of one stage's parts, each 16-byte aligned: the value window
// (value_window bytes of vsize-byte values: a narrow one as its aligned
// span), the chunk's four metadata rows (col, mask, voff, row; meta_stride
// bytes apart) and a 16-byte slot holding the chunk's x window start, at
// byte 4 (narrow values) the window's offset in its span and, at byte 8,
// the stage's mbarrier. Both layouts stage a chunk so (the whole-vector
// kernels with an x window start of 0: their columns are absolute). The y
// tile (pr floats; in the whole-vector layout the warps' tiles) comes before
// the first stage. The wrappers plan with their copies (kernels/
// spc5_spmv.py: panels_smem_bytes, whole_smem_bytes) and pass their figure
// in; a launch whose figure differs is refused, and spc5_spmv_panels_smem /
// spc5_spmv_whole_smem expose these for the wrapper's tests.
struct StageLayout {
  int vwin, meta, meta_stride, xb, bytes;
};

template <typename A>
__host__ __device__ inline StageLayout stage_layout(const A& a, int vsize) {
  StageLayout L;
  L.vwin = 0;
  L.meta = value_window(vsize, a.vmax);
  L.meta_stride = round16(4 * a.cb);
  L.xb = L.meta + 4 * L.meta_stride;
  L.bytes = L.xb + 16;
  return L;
}

inline size_t panels_smem(const PanelArgs& a, int stages) {
  return (size_t)round16(4 * a.pr) + (size_t)stages * stage_layout(a, a.vsize).bytes;
}

// What each thread of a CTA (either layout) does in every chunk, fixed for
// the whole launch: its block rows (row lr = threadIdx % r of blocks threadIdx / r,
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

template <typename A>
__device__ __forceinline__ ThreadPlan thread_plan(const A& a, const StageLayout& L) {
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
// at vb (a narrow one as its span, value_span / copy_span, the window's
// offset in it written into the slot beside xb) and, where `wide`, the
// chunk's four metadata rows, all completing on the stage's mbarrier; where
// not (cb % 4 != 0, or an array off a 16-byte boundary), every thread
// copies its share of the metadata rows with 4-byte cp.async, completed by
// the caller's cp.async wait (as are a span's last 4 to 12 bytes).
template <typename V, typename A>
__device__ __forceinline__ void stage_chunk(unsigned char* st, const StageLayout& L,
                                            const A& a, const ThreadPlan& t, bool wide,
                                            size_t g, int vb, int xb) {
  const int nbytes = 4 * a.cb;  // a metadata row
  if (threadIdx.x == 0) {
    const V* values = static_cast<const V*>(a.values);
    uint64_t* bar = stage_bar(st, L);
    if constexpr (sizeof(V) == 4) {
      *reinterpret_cast<int*>(st + L.xb) = xb;
      mbar_expect_tx(bar, 4 * a.vmax + (wide ? 4 * nbytes : 0));
      bulk_copy(st + L.vwin, values + vb, 4 * a.vmax, bar);
    } else {
      int bytes, off;
      const char* span = value_span(values, vb, a.vmax, a.nvalues, bytes, off);
      *reinterpret_cast<int2*>(st + L.xb) = make_int2(xb, off);
      mbar_expect_tx(bar, span_bulk_bytes(bytes) + (wide ? 4 * nbytes : 0));
      copy_span(st + L.vwin, span, bytes, bar);
    }
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

// The staged window's first value: at the stage's start, or (narrow values)
// at the offset in its span that stage_chunk wrote into the slot.
template <typename V>
__device__ __forceinline__ const V* staged_window(const unsigned char* st, const StageLayout& L) {
  const V* vwin = reinterpret_cast<const V*>(st + L.vwin);
  if constexpr (sizeof(V) < 4) vwin += *reinterpret_cast<const int*>(st + L.xb + 4);
  return vwin;
}

// Add the staged chunk into the y tile, a block row per thread (ThreadPlan).
// The row's first value is voff + popc(mask bits before the row); only the
// row's set bits are walked, each reading x in place (x_at: the wrapper
// makes x long enough for every chunk's window, or a set lane's mapped
// column is a real one), and the row adds into the tile once, if a bit is
// set. s is the chunk's scale (int8 only).
template <typename V, typename A>
__device__ __forceinline__ void decode_stage(const unsigned char* st, const StageLayout& L,
                                             const A& a, const ThreadPlan& t,
                                             float* ytile, float s) {
  const V* vwin = staged_window<V>(st, L);
  const int xb = *reinterpret_cast<const int*>(st + L.xb);  // the chunk's x window start
  const uint32_t row_mask = (1u << a.c) - 1u;
  const int ms = L.meta_stride;
  for (int b = t.b0; b < a.cb; b += t.bstep) {
    const unsigned char* w = st + L.meta + 4 * b;  // the block's col word
    const uint32_t mask = *reinterpret_cast<const uint32_t*>(w + ms);
    uint32_t bits = (mask >> t.shift) & row_mask;
    if (bits == 0u) continue;  // an empty row, a padding block or chunk
    const V* v = vwin + *reinterpret_cast<const int*>(w + 2 * ms) + __popc(mask & t.below);
    const int xi = xb + *reinterpret_cast<const int*>(w);
    float acc = 0.f;
    do {
      acc = fmaf(dequant(*v++, s), x_at(a, xi + __ffs(bits) - 1), acc);
      bits &= bits - 1u;
    } while (bits);
    atomicAdd(ytile + *reinterpret_cast<const int*>(w + 3 * ms) + t.lr, acc);
  }
}

// The panel kernels' body, for launch arguments A (PanelArgs, or
// CmapPanelArgs with a column map).
template <typename V, int kStages, typename A>
__device__ __forceinline__ void panels_body(const A& a) {
  extern __shared__ __align__(16) float smem[];
  const StageLayout L = stage_layout(a, (int)sizeof(V));
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
      const float s = value_scale<V>(a.scale, g0 + j);
      if (j > 0) __syncthreads();  // the previous decode is done
      stage_chunk<V>(ring, L, a, t, wide, g0 + j, vj, xj);
      cp_async_commit();
      cp_async_wait<0>();
      mbar_wait(stage_bar(ring, L), j & 1);
      __syncthreads();  // everyone's copies, and the slot's xb
      decode_stage<V>(ring, L, a, t, ytile, s);
    }
  } else {
    // the ring: chunk j lives in stage j % kStages; kStages - 1 chunks are
    // in flight while one decodes
    for (int s = 0; s < kStages - 1; ++s) {
      if (s < n) {
        stage_chunk<V>(ring + s * L.bytes, L, a, t, wide, g0 + s, __ldg(vbase + s),
                       __ldg(xbase + s));
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
      const float s = value_scale<V>(a.scale, g0 + j);  // loaded before the wait
      cp_async_wait<kStages - 2>();  // chunk j's 4-byte copies of this thread
      mbar_wait(stage_bar(st, L), (parity >> dec) & 1u);
      parity ^= 1u << dec;
      __syncthreads();  // ... everyone's; chunk j - 1's stage is free
      const int jn = j + kStages - 1;
      if (jn < n) stage_chunk<V>(ring + fill * L.bytes, L, a, t, wide, g0 + jn, vb, xb);
      cp_async_commit();  // possibly empty: keeps the group count uniform
      if (jn + 1 < n) {
        vb = __ldg(vbase + jn + 1);
        xb = __ldg(xbase + jn + 1);
      }
      decode_stage<V>(st, L, a, t, ytile, s);
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

template <typename V, int kStages>
__global__ void __launch_bounds__(256) spmv_panels_kernel(const PanelArgs a) {
  panels_body<V, kStages>(a);
}

template <typename V, int kStages>
__global__ void __launch_bounds__(256) spmv_panels_cmap_kernel(const CmapPanelArgs a) {
  panels_body<V, kStages>(a);
}

// ---------------------------------------------------------------------------
// whole-vector layout: contiguous chunk ranges, staged chunk metadata, a
// block row per thread, row runs combined in the warp, per-warp y tiles
// ---------------------------------------------------------------------------

struct WholeArgs {
  const int* vbase;  // (nchunks,) value window starts
  const int* col;    // (nchunks, cb) block columns
  const uint32_t* mask;
  const int* voff;   // offsets of the blocks' first values in the window
  const int* row;    // first rows of the blocks
  const void* values;  // vsize bytes a value: float, __nv_bfloat16 or int8_t
  const float* x;    // (ncols,), read in place
  float* y;          // (nrows,), zeroed
  int nchunks, cb, vmax, nrows, r, c;
  int grid;  // G: CTAs, each a contiguous range of the chunks
  int tile;  // rows of each warp's y tile
  // last, so the other fields keep the offsets the f32 kernels had:
  const float* scale;  // (nchunks,) int8 scales; unread otherwise
  int vsize;    // the values' bytes: 4, 2 or 1
  int nvalues;  // values' length: no staged span reaches past it
};

// A whole-vector launch with a column map: WholeArgs' fields as they are,
// then the map. x is (ncols,), in the original column order.
struct CmapWholeArgs : WholeArgs {
  const int* cmap;  // (ncols,): the column of x each permuted column reads
};

template <>
constexpr bool kMapped<CmapWholeArgs> = true;

// The warps' y tiles, then `stages` stages (stage_layout).
inline size_t whole_smem(const WholeArgs& a, int stages, int threads) {
  return (size_t)round16(4 * a.tile * (threads / 32)) +
         (size_t)stages * stage_layout(a, a.vsize).bytes;
}

constexpr unsigned kFullWarp = 0xffffffffu;
// The key of a lane with no block row: a padding block, or a block past cb.
// Above every row, so it keeps a sorted subsequence sorted.
constexpr int kNoRow = 0x7fffffff;

// A lane's row run: the sum of its block rows since its key last changed.
struct Run {
  int key = kNoRow;
  float sum = 0.f;
};

// Add every lane's run (key, v) of the warp into the warp's y tile wtile
// (rows tbase .. tbase + tile) or into y. Lane l holds row l % r (t.lr) of
// the warp's (l / r)-th block, so the lanes of one lr are a subsequence of
// stride r. Where every such subsequence is sorted and every key lies on its
// lr (key % r == lr: block rows on multiples of r, as to_chunked builds
// them), equal keys are neighbours of one subsequence and no two
// subsequences share a key: a segmented scan sums each key's runs into its
// last lane, which alone adds the key, with a plain load and store into the
// tile (the warp's own) or, outside it, a global atomic. Otherwise each
// lane adds its own run into y with a global atomic.
__device__ __forceinline__ void flush_runs(const WholeArgs& a, const ThreadPlan& t,
                                           float* wtile, int tbase, int key, float v) {
  const int lane = threadIdx.x & 31;
  const int r = a.r;
  const int before = __shfl_up_sync(kFullWarp, key, r);
  const bool sorted = key == kNoRow || ((key & (r - 1)) == t.lr && (lane < r || before <= key));
  if (__all_sync(kFullWarp, sorted)) {
    for (int d = r; d < 32; d <<= 1) {
      const float vd = __shfl_up_sync(kFullWarp, v, d);
      const int kd = __shfl_up_sync(kFullWarp, key, d);
      if (lane >= d && kd == key) v += vd;
    }
    const int after = __shfl_down_sync(kFullWarp, key, r);
    __syncwarp();  // the warp's earlier tile adds are seen
    if (key != kNoRow && (lane + r >= 32 || after != key) && v != 0.f) {
      const unsigned i = (unsigned)(key - tbase);
      if (i < (unsigned)a.tile) {
        wtile[i] += v;
      } else {
        atomicAdd(a.y + key, v);
      }
    }
  } else if (key != kNoRow && v != 0.f) {
    atomicAdd(a.y + key, v);
  }
}

// Add the staged chunk into the lanes' runs, a block row per thread
// (ThreadPlan: row t.lr of blocks t.b0, t.b0 + t.bstep, ...), in `steps`
// steps the warp takes together. A lane's key is its block row's row
// (empty rows included, so every lane's key comes from the same step), or
// kNoRow; a step whose keys all equal the runs' adds each row's sum into
// its run, any other flushes the warp's runs (flush_runs) and starts them
// again. The row's first value is voff + popc(mask bits before the row);
// only the row's set bits are walked, each reading x in place (x_at). s is
// the chunk's scale (int8 only).
template <typename V, typename A>
__device__ __forceinline__ void decode_whole(const unsigned char* st, const StageLayout& L,
                                             const A& a, const ThreadPlan& t, int steps,
                                             float* wtile, int tbase, Run& run, float s) {
  const V* vwin = staged_window<V>(st, L);
  const uint32_t row_mask = (1u << a.c) - 1u;
  const int ms = L.meta_stride;
  int b = t.b0;
  for (int i = 0; i < steps; ++i, b += t.bstep) {
    int key = kNoRow;
    float acc = 0.f;
    if (b < a.cb) {
      const unsigned char* w = st + L.meta + 4 * b;  // the block's col word
      const uint32_t mask = *reinterpret_cast<const uint32_t*>(w + ms);
      if (mask != 0u) {  // else a padding block
        key = *reinterpret_cast<const int*>(w + 3 * ms) + t.lr;
        uint32_t bits = (mask >> t.shift) & row_mask;
        if (bits != 0u) {
          const V* v =
              vwin + *reinterpret_cast<const int*>(w + 2 * ms) + __popc(mask & t.below);
          const int xi = *reinterpret_cast<const int*>(w);
          do {
            acc = fmaf(dequant(*v++, s), x_at(a, xi + __ffs(bits) - 1), acc);
            bits &= bits - 1u;
          } while (bits);
        }
      }
    }
    if (__all_sync(kFullWarp, key == run.key)) {
      run.sum += acc;
    } else {
      flush_runs(a, t, wtile, tbase, run.key, run.sum);
      run.key = key;
      run.sum = acc;
    }
  }
}

// Add the warps' tiles (rows tbase, tbase + 1, ...) into y, each row summed
// over the warps in warp order and added with one global atomic where
// nonzero, and, where `clear`, zero them. Each thread reads and clears its
// own rows.
__device__ __forceinline__ void flush_tiles(float* ytile, const WholeArgs& a, int tbase,
                                            bool clear) {
  const int warps = blockDim.x >> 5;
  for (int i = threadIdx.x; i < a.tile; i += blockDim.x) {
    float s = 0.f;
    for (int w = 0; w < warps; ++w) {
      float* p = ytile + w * a.tile + i;
      s += *p;
      if (clear) *p = 0.f;
    }
    if (s != 0.f && tbase + i < a.nrows) atomicAdd(a.y + tbase + i, s);
  }
}

// At the start of chunk j of a CTA's range, once its stage has landed (st)
// and the previous chunk is decoded: the first chunk bases the tiles at its
// first row; a later one whose first row leaves the tiles' first half
// flushes them and bases them there. Uniform over the CTA.
__device__ __forceinline__ void move_tiles(const unsigned char* st, const StageLayout& L,
                                           const WholeArgs& a, int j, float* ytile, int& tbase) {
  const int r0 = *reinterpret_cast<const int*>(st + L.meta + 3 * L.meta_stride);
  if (j == 0) {
    tbase = r0;
  } else if ((unsigned)(r0 - tbase) >= (unsigned)((a.tile + 1) >> 1)) {
    flush_tiles(ytile, a, tbase, true);
    tbase = r0;
    __syncthreads();  // the tiles are clear before the decode adds into them
  }
}

// The whole-vector kernels' body, for launch arguments A (WholeArgs, or
// CmapWholeArgs with a column map). Taken by value: by reference, the
// kernels without a map compiled to other SASS than before the twins.
template <typename V, int kStages, typename A>
__device__ __forceinline__ void whole_body(const A a) {
  extern __shared__ __align__(16) float smem[];
  const StageLayout L = stage_layout(a, (int)sizeof(V));
  const ThreadPlan t = thread_plan(a, L);
  const bool wide = ((reinterpret_cast<uintptr_t>(a.col) | reinterpret_cast<uintptr_t>(a.mask) |
                      reinterpret_cast<uintptr_t>(a.voff) | reinterpret_cast<uintptr_t>(a.row) |
                      (uintptr_t)(4 * a.cb)) & 15) == 0;
  const int warps = blockDim.x >> 5;
  float* ytile = smem;  // (warps, tile)
  float* wtile = ytile + (threadIdx.x >> 5) * a.tile;
  unsigned char* ring = reinterpret_cast<unsigned char*>(smem) + round16(4 * a.tile * warps);
  const int c0 = (int)((long long)blockIdx.x * a.nchunks / a.grid);
  const int n = (int)((long long)(blockIdx.x + 1) * a.nchunks / a.grid) - c0;
  const int* vbase = a.vbase + c0;
  const int steps = (a.cb + t.bstep - 1) / t.bstep;  // the same for every thread
  for (int i = threadIdx.x; i < a.tile * warps; i += blockDim.x) ytile[i] = 0.f;
  if (threadIdx.x == 0) {
    // only the stages this range uses: the launch holds no more than the
    // longest range needs (whole_ring)
    for (int s = 0; s < kStages && s < n; ++s) mbar_init(stage_bar(ring + s * L.bytes, L));
    mbar_fence_init();
  }
  __syncthreads();  // the barriers are initialised and the tiles zeroed
  int tbase = 0;
  Run run;

  if constexpr (kStages == 1) {
    // one stage, copied and waited for before each decode (the next
    // chunk's window start is loaded a chunk ahead)
    int vb = n > 0 ? __ldg(vbase) : 0;
    for (int j = 0; j < n; ++j) {
      const int vj = vb;
      if (j + 1 < n) vb = __ldg(vbase + j + 1);
      const float s = value_scale<V>(a.scale, (size_t)c0 + j);
      if (j > 0) __syncthreads();  // the previous decode is done
      stage_chunk<V>(ring, L, a, t, wide, (size_t)c0 + j, vj, 0);
      cp_async_commit();
      cp_async_wait<0>();
      mbar_wait(stage_bar(ring, L), j & 1);
      __syncthreads();  // everyone's copies
      move_tiles(ring, L, a, j, ytile, tbase);
      decode_whole<V>(ring, L, a, t, steps, wtile, tbase, run, s);
    }
  } else {
    // the ring: chunk j lives in stage j % kStages; kStages - 1 chunks are
    // in flight while one decodes
    for (int s = 0; s < kStages - 1; ++s) {
      if (s < n) {
        stage_chunk<V>(ring + s * L.bytes, L, a, t, wide, (size_t)c0 + s, __ldg(vbase + s), 0);
      }
      cp_async_commit();
    }
    int vb = kStages - 1 < n ? __ldg(vbase + kStages - 1) : 0;  // the next chunk to stage
    int dec = 0, fill = kStages - 1;  // the stages of chunks j and j + kStages - 1
    uint32_t parity = 0;              // bit s: the parity of stage s's next phase
    for (int j = 0; j < n; ++j) {
      unsigned char* st = ring + dec * L.bytes;
      const float s = value_scale<V>(a.scale, (size_t)c0 + j);  // loaded before the wait
      cp_async_wait<kStages - 2>();  // chunk j's 4-byte copies of this thread
      mbar_wait(stage_bar(st, L), (parity >> dec) & 1u);
      parity ^= 1u << dec;
      __syncthreads();  // ... everyone's; chunk j - 1's stage is free
      move_tiles(st, L, a, j, ytile, tbase);
      const int jn = j + kStages - 1;
      if (jn < n) stage_chunk<V>(ring + fill * L.bytes, L, a, t, wide, (size_t)c0 + jn, vb, 0);
      cp_async_commit();  // possibly empty: keeps the group count uniform
      if (jn + 1 < n) vb = __ldg(vbase + jn + 1);
      decode_whole<V>(st, L, a, t, steps, wtile, tbase, run, s);
      dec = dec + 1 == kStages ? 0 : dec + 1;
      fill = fill + 1 == kStages ? 0 : fill + 1;
    }
  }
  flush_runs(a, t, wtile, tbase, run.key, run.sum);
  __syncthreads();
  flush_tiles(ytile, a, tbase, false);
}

template <typename V, int kStages>
__global__ void __launch_bounds__(256) spmv_whole_kernel(const WholeArgs a) {
  whole_body<V, kStages>(a);
}

template <typename V, int kStages>
__global__ void __launch_bounds__(256) spmv_whole_cmap_kernel(const CmapWholeArgs a) {
  whole_body<V, kStages>(a);
}

template <typename V, typename A>
void (*whole_kernel_v(int stages))(A) {
  if constexpr (kMapped<A>) {
    switch (stages) {
      case 1: return spmv_whole_cmap_kernel<V, 1>;
      case 2: return spmv_whole_cmap_kernel<V, 2>;
      default: return nullptr;
    }
  } else {
    switch (stages) {
      case 1: return spmv_whole_kernel<V, 1>;
      case 2: return spmv_whole_kernel<V, 2>;
      default: return nullptr;
    }
  }
}

// The whole-vector kernel for vsize-byte values (4 float, 2 bf16, 1 int8),
// a ring of `stages` (1: the synchronous twin, or 2) and launch arguments A
// (with a column map for CmapWholeArgs); nullptr for any other.
template <typename A>
void (*whole_kernel(int vsize, int stages))(A) {
  switch (vsize) {
    case 4: return whole_kernel_v<float, A>(stages);
    case 2: return whole_kernel_v<__nv_bfloat16, A>(stages);
    case 1: return whole_kernel_v<int8_t, A>(stages);
    default: return nullptr;
  }
}

// The shared-memory carve-out the whole-vector column-map twins ask for, in
// percent of the most an SM gives (228 KB): 164 KB, so that L1 keeps 92 KB
// for x and the map, which every set lane reads through it. Left to the
// CUDA runtime, the vocab layer's ring twin got 228 KB (12 CTAs of 17.6 KB)
// and L1 28 KB, too little for x and the map (16 KB each): the twin took
// 2.37x its kernel on x[col_perm], 1.13x at this carve-out, which also cut
// the band's ring twin from 1.69x to 1.45x (PERF.md §6).
constexpr int kCmapWholeCarveout = 72;

// The stages a launch of the `stages` kernel holds: a ring no longer than
// the longest chunk range (ceil(nchunks / grid)), since a CTA uses no more
// stages than it has chunks: where every CTA takes one chunk, one stage.
int whole_ring(int stages, const WholeArgs& a) {
  const int longest = (a.nchunks + a.grid - 1) / a.grid;
  return stages < longest ? stages : longest;
}

// Launch the whole-vector kernel of `stages` with the wrapper's plan: a
// grid, tile, shared-memory figure (whole_ring stages) or thread count it
// did not plan (or the kernel cannot take), or int8 values without their
// scales, is refused with cudaErrorInvalidValue, launching nothing (as is a
// column map launch without its map).
template <typename A>
int launch_whole(int stages, const A& a, int smem_planned, int threads, int device,
                 void* stream) {
  const auto kernel = whole_kernel<A>(a.vsize, stages);
  bool bad_map = false;
  if constexpr (kMapped<A>) bad_map = a.cmap == nullptr;
  if (kernel == nullptr || bad_map || a.grid < 1 || a.grid > a.nchunks || a.cb < 1 || a.tile < 1 ||
      a.r < 1 || 32 % a.r != 0 || a.c < 1 || a.r * a.c > 32 || threads < 32 || threads > 256 ||
      threads % 32 != 0 || (a.vsize == 1 && a.scale == nullptr) ||
      whole_smem(a, whole_ring(stages, a), threads) != (size_t)smem_planned) {
    return (int)cudaErrorInvalidValue;
  }
  const size_t smem = (size_t)smem_planned;
  cudaError_t err = prepare_launch(kernel, device, smem, threads, nullptr);
  if constexpr (kMapped<A>) {
    if (err == cudaSuccess) {
      err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                                 kCmapWholeCarveout);
    }
  }
  if (err != cudaSuccess) return (int)err;
  void* args[] = {const_cast<A*>(&a)};
  err = cudaLaunchKernel(reinterpret_cast<const void*>(kernel), dim3(a.grid), dim3(threads), args,
                         smem, (cudaStream_t)stream);
  return (int)(err != cudaSuccess ? err : cudaGetLastError());
}

template <typename V, typename A>
void (*panels_kernel_v(int stages))(A) {
  if constexpr (kMapped<A>) {
    switch (stages) {
      case 1: return spmv_panels_cmap_kernel<V, 1>;
      case 2: return spmv_panels_cmap_kernel<V, 2>;
      case 3: return spmv_panels_cmap_kernel<V, 3>;
      default: return nullptr;
    }
  } else {
    switch (stages) {
      case 1: return spmv_panels_kernel<V, 1>;
      case 2: return spmv_panels_kernel<V, 2>;
      case 3: return spmv_panels_kernel<V, 3>;
      default: return nullptr;
    }
  }
}

// The panel kernel for vsize-byte values (4 float, 2 bf16, 1 int8), a ring
// of `stages` (1: the synchronous twin) and launch arguments A (with a
// column map for CmapPanelArgs); nullptr for any other.
template <typename A>
void (*panels_kernel(int vsize, int stages))(A) {
  switch (vsize) {
    case 4: return panels_kernel_v<float, A>(stages);
    case 2: return panels_kernel_v<__nv_bfloat16, A>(stages);
    case 1: return panels_kernel_v<int8_t, A>(stages);
    default: return nullptr;
  }
}

PanelArgs panel_args(const int* vbase, const int* xbase, const int* col, const uint32_t* mask,
                     const int* voff, const int* row, const void* values, const float* scale,
                     const float* x, float* y, int nchunks, int cb, int vmax, int pr, int nrows,
                     int r, int c, int vsize, int nvalues, int split) {
  return PanelArgs{vbase, xbase, col,   mask,  voff, row,   values, x,     y,
                   nchunks, cb, vmax, pr, nrows, r, c, split, scale, vsize, nvalues};
}

// Launch the panel kernel of `stages` over npanels panels with the
// wrapper's plan: a split, shared-memory figure or thread count it did not
// plan (or the kernel cannot take), int8 values without their scales, or a
// column map launch without its map, is refused with cudaErrorInvalidValue,
// launching nothing.
template <typename A>
int launch_panels(int stages, const A& a, int npanels, int smem_planned, int threads, int device,
                  void* stream) {
  const auto kernel = panels_kernel<A>(a.vsize, stages);
  const size_t smem = panels_smem(a, stages);
  bool bad_map = false;
  if constexpr (kMapped<A>) bad_map = a.cmap == nullptr;
  if (kernel == nullptr || bad_map || a.split < 1 || a.split > a.nchunks ||
      (long long)npanels * a.split > 0x7fffffffLL || smem != (size_t)smem_planned ||
      threads < 32 || threads > 256 || threads % 32 != 0 || (a.vsize == 1 && a.scale == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaError_t err = prepare_launch(kernel, device, smem, threads, nullptr);
  if (err != cudaSuccess) return (int)err;
  void* args[] = {const_cast<A*>(&a)};
  err = cudaLaunchKernel(reinterpret_cast<const void*>(kernel), dim3(npanels * a.split),
                         dim3(threads), args, smem, (cudaStream_t)stream);
  return (int)(err != cudaSuccess ? err : cudaGetLastError());
}

template <typename Kernel>
int occupancy(Kernel kernel, int threads, int smem, int device, int* out) {
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

// The synchronous whole-vector kernel: `grid` CTAs, each a contiguous range
// of the chunks, one stage; warps' tiles of `tile` rows; values of vsize
// bytes (4 f32, 2 bf16, 1 int8 with its (nchunks,) scales; scale is unread
// otherwise), nvalues of them. smem and threads are the wrapper's plan
// (checked).
int spc5_spmv_whole_s1(const int* vbase, const int* col, const uint32_t* mask, const int* voff,
                       const int* row, const void* values, const float* scale, const float* x,
                       float* y, int nchunks, int cb, int vmax, int nrows, int r, int c, int vsize,
                       int nvalues, int grid, int tile, int smem, int threads, int device,
                       void* stream) {
  const WholeArgs a{vbase, col,  mask, voff,  row,   values, x,       y,     nchunks, cb,
                    vmax,  nrows, r,   c,    grid,  tile,  scale,  vsize, nvalues};
  return launch_whole(1, a, smem, threads, device, stream);
}

// The staged-ahead whole-vector kernel: a ring of two chunks (one stage
// where every CTA takes one chunk).
int spc5_spmv_whole_s2(const int* vbase, const int* col, const uint32_t* mask, const int* voff,
                       const int* row, const void* values, const float* scale, const float* x,
                       float* y, int nchunks, int cb, int vmax, int nrows, int r, int c, int vsize,
                       int nvalues, int grid, int tile, int smem, int threads, int device,
                       void* stream) {
  const WholeArgs a{vbase, col,  mask, voff,  row,   values, x,       y,     nchunks, cb,
                    vmax,  nrows, r,   c,    grid,  tile,  scale,  vsize, nvalues};
  return launch_whole(2, a, smem, threads, device, stream);
}

// The whole-vector kernel's occupancy at `stages` (1: the synchronous
// kernel, 2: the ring), vsize-byte values, `threads` and `smem` bytes of
// dynamic shared memory per CTA: out[0] the CTAs one SM holds at once,
// out[1] the SMs of the device.
int spc5_spmv_whole_occupancy(int stages, int vsize, int threads, int smem, int device, int* out) {
  return occupancy(whole_kernel<WholeArgs>(vsize, stages), threads, smem, device, out);
}

// The synchronous whole-vector kernel with a column map: the arguments of
// spc5_spmv_whole_s1, then cmap ((ncols,) int32, the column of x each
// permuted column reads); x is (ncols,) in the original column order.
int spc5_spmv_whole_cmap_s1(const int* vbase, const int* col, const uint32_t* mask,
                            const int* voff, const int* row, const void* values,
                            const float* scale, const float* x, float* y, int nchunks, int cb,
                            int vmax, int nrows, int r, int c, int vsize, int nvalues, int grid,
                            int tile, int smem, int threads, int device, void* stream,
                            const int* cmap) {
  CmapWholeArgs a{};
  static_cast<WholeArgs&>(a) = WholeArgs{vbase, col,  mask, voff,  row,   values, x,
                                         y,     nchunks, cb, vmax,  nrows, r,      c,
                                         grid,  tile,  scale, vsize, nvalues};
  a.cmap = cmap;
  return launch_whole(1, a, smem, threads, device, stream);
}

// The staged-ahead whole-vector kernel with a column map: the arguments of
// spc5_spmv_whole_s2, then cmap.
int spc5_spmv_whole_cmap_s2(const int* vbase, const int* col, const uint32_t* mask,
                            const int* voff, const int* row, const void* values,
                            const float* scale, const float* x, float* y, int nchunks, int cb,
                            int vmax, int nrows, int r, int c, int vsize, int nvalues, int grid,
                            int tile, int smem, int threads, int device, void* stream,
                            const int* cmap) {
  CmapWholeArgs a{};
  static_cast<WholeArgs&>(a) = WholeArgs{vbase, col,  mask, voff,  row,   values, x,
                                         y,     nchunks, cb, vmax,  nrows, r,      c,
                                         grid,  tile,  scale, vsize, nvalues};
  a.cmap = cmap;
  return launch_whole(2, a, smem, threads, device, stream);
}

// The occupancy of the whole-vector kernel with a column map, as
// spc5_spmv_whole_occupancy reports its twin's, at the twin's carve-out.
int spc5_spmv_whole_cmap_occupancy(int stages, int vsize, int threads, int smem, int device,
                                   int* out) {
  const auto kernel = whole_kernel<CmapWholeArgs>(vsize, stages);
  if (kernel != nullptr) {
    cudaError_t err = cudaSetDevice(device);
    if (err == cudaSuccess) {
      err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                                 kCmapWholeCarveout);
    }
    if (err != cudaSuccess) return (int)err;
  }
  return occupancy(kernel, threads, smem, device, out);
}

// The dynamic shared memory of one whole-vector CTA of `threads` threads
// with `stages` stages, warps' tiles of `tile` rows and vsize-byte values,
// as the launch computes it (whole_smem).
int spc5_spmv_whole_smem(int stages, int cb, int vmax, int tile, int threads, int vsize) {
  WholeArgs a{};
  a.cb = cb;
  a.vmax = vmax;
  a.tile = tile;
  a.vsize = vsize;
  return (int)whole_smem(a, stages, threads);
}

// The synchronous panel kernel: split CTAs per panel, values of vsize bytes
// (4 f32, 2 bf16, 1 int8 with its (npanels, nchunks) scales; scale is
// unread otherwise), nvalues of them. smem is the wrapper's figure for the
// CTA's dynamic shared memory (checked).
int spc5_spmv_panels_s1(const int* vbase, const int* xbase, const int* col, const uint32_t* mask,
                        const int* voff, const int* row, const void* values, const float* scale,
                        const float* x, float* y, int npanels, int nchunks, int cb, int vmax,
                        int pr, int nrows, int r, int c, int vsize, int nvalues, int split,
                        int smem, int threads, int device, void* stream) {
  return launch_panels(1,
                       panel_args(vbase, xbase, col, mask, voff, row, values, scale, x, y,
                                  nchunks, cb, vmax, pr, nrows, r, c, vsize, nvalues, split),
                       npanels, smem, threads, device, stream);
}

// The staged-ahead panel kernel: a ring of `stages` chunks, 2 or 3.
int spc5_spmv_panels_s2(const int* vbase, const int* xbase, const int* col, const uint32_t* mask,
                        const int* voff, const int* row, const void* values, const float* scale,
                        const float* x, float* y, int npanels, int nchunks, int cb, int vmax,
                        int pr, int nrows, int r, int c, int vsize, int nvalues, int split,
                        int stages, int smem, int threads, int device, void* stream) {
  if (stages < 2) return (int)cudaErrorInvalidValue;
  return launch_panels(stages,
                       panel_args(vbase, xbase, col, mask, voff, row, values, scale, x, y,
                                  nchunks, cb, vmax, pr, nrows, r, c, vsize, nvalues, split),
                       npanels, smem, threads, device, stream);
}

// The panel kernel's occupancy at `stages` (1: the synchronous kernel),
// vsize-byte values, `threads` and `smem` bytes of dynamic shared memory
// per CTA: out[0] the CTAs one SM holds at once, out[1] the SMs of the
// device.
int spc5_spmv_panels_occupancy(int stages, int vsize, int threads, int smem, int device,
                               int* out) {
  return occupancy(panels_kernel<PanelArgs>(vsize, stages), threads, smem, device, out);
}

// The synchronous panel kernel with a column map: the arguments of
// spc5_spmv_panels_s1, then cmap ((ncols,) int32, the column of x each
// permuted column reads); x is (ncols,) in the original column order,
// unpadded.
int spc5_spmv_panels_cmap_s1(const int* vbase, const int* xbase, const int* col,
                             const uint32_t* mask, const int* voff, const int* row,
                             const void* values, const float* scale, const float* x, float* y,
                             int npanels, int nchunks, int cb, int vmax, int pr, int nrows, int r,
                             int c, int vsize, int nvalues, int split, int smem, int threads,
                             int device, void* stream, const int* cmap) {
  CmapPanelArgs a{};
  static_cast<PanelArgs&>(a) = panel_args(vbase, xbase, col, mask, voff, row, values, scale, x,
                                          y, nchunks, cb, vmax, pr, nrows, r, c, vsize, nvalues,
                                          split);
  a.cmap = cmap;
  return launch_panels(1, a, npanels, smem, threads, device, stream);
}

// The staged-ahead panel kernel with a column map: the arguments of
// spc5_spmv_panels_s2, then cmap.
int spc5_spmv_panels_cmap_s2(const int* vbase, const int* xbase, const int* col,
                             const uint32_t* mask, const int* voff, const int* row,
                             const void* values, const float* scale, const float* x, float* y,
                             int npanels, int nchunks, int cb, int vmax, int pr, int nrows, int r,
                             int c, int vsize, int nvalues, int split, int stages, int smem,
                             int threads, int device, void* stream, const int* cmap) {
  if (stages < 2) return (int)cudaErrorInvalidValue;
  CmapPanelArgs a{};
  static_cast<PanelArgs&>(a) = panel_args(vbase, xbase, col, mask, voff, row, values, scale, x,
                                          y, nchunks, cb, vmax, pr, nrows, r, c, vsize, nvalues,
                                          split);
  a.cmap = cmap;
  return launch_panels(stages, a, npanels, smem, threads, device, stream);
}

// The occupancy of the panel kernel with a column map, as
// spc5_spmv_panels_occupancy reports its twin's.
int spc5_spmv_panels_cmap_occupancy(int stages, int vsize, int threads, int smem, int device,
                                    int* out) {
  return occupancy(panels_kernel<CmapPanelArgs>(vsize, stages), threads, smem, device, out);
}

// The dynamic shared memory of one panel-kernel CTA with `stages` stages
// and vsize-byte values, as the launch computes it (stage_layout).
int spc5_spmv_panels_smem(int stages, int cb, int vmax, int pr, int vsize) {
  PanelArgs a{};
  a.cb = cb;
  a.vmax = vmax;
  a.pr = pr;
  a.vsize = vsize;
  return (int)panels_smem(a, stages);
}

}  // extern "C"
