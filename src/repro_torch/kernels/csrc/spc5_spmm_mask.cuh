// The mask-decode SpMM kernels of spc5_spmm.cu and their column-map twins,
// built by spc5_spmm_cmap.cu: Y = A @ X with A in beta(r,c) blocks with bit
// masks and no zero padding, over the two chunked layouts of
// repro_torch/core/formats.py. X is (xrows, nvec) and Y (nrows, nvec), both
// row-major f32, the reference's layout.
//
// Bound. The work is 2 flops per nonzero and column, and the bytes are the
// plan's (4 B per packed value in f32, 2 in bf16, 1 in int8 plus an f32
// scale a chunk, 16 B of metadata per block slot) plus X and Y once each:
// at small nvec the bytes bind, at nvec = 128 the f32 rate. In
// practice each nonzero also reads its columns of X through L1/L2, and what
// a nonzero costs in instructions decides. The Pallas kernels keep X
// resident (whole-vector) or stage an (xw, nvt) slab per chunk (panels); at
// the reference's pr = xw = 512 and nvt = 128 that is 786 KB per CTA
// against 227 KB, and a chunk of a sparse panel uses far fewer X rows than
// the xw it would stage, so both kernels read X in place through L1.
//
// Whole-vector kernel (spmm_whole_kernel<MaskWhole, R, C, V>), built for
// the H100, not for the TPU's sequential grid: the skeleton of
// spc5_spmm_whole.cuh, shared with the descriptor kernel of
// spc5_spmm_desc.cu. On the vocab weight a chunk of cb = 256 beta(4,8)
// blocks spans only 4-8 rows, so the kernel neither gives a CTA a chunk nor
// cuts rows among lane groups: G CTAs each take a contiguous range of the
// chunks (G from the card's occupancy), stage rounds of q chunks (value
// windows and the four metadata rows) by bulk copies on an mbarrier, a ring
// of two where an SM holds as many CTAs as with one stage; once a round the
// CTA lists its nonzeros ordered by (row of the block, block, lane), each
// the next value of the window in packed order (no rank) with its X row
// offset and row, leaving out lanes whose column lies at or past X's rows;
// the lane groups walk equal shares of the list four entries at a time with
// 16-byte X loads (four columns a lane, tiles of up to 128 columns) and
// combine row sums in a shared Y tile through per-group slots, in a fixed
// order, with no shared float atomic. What bounds it: at nvec 16 the plan's
// bytes and each round's fixed costs (its copies, barriers and the list's
// scan); at nvec 128 the instructions each nonzero costs in the walk (an
// entry, an X load, V FMAs), which the list keeps at the panel kernels'
// count.
//
// Panel kernels (spmm_panels_kernel), built for the H100, not for the TPU's
// sequential grid:
//   * split grid: each panel's chunk list is cut into S contiguous ranges
//     (the wrapper picks S with the panel SpMV pairs' rule), its rows into
//     H row parts of prows rows (a multiple of r) and its columns into
//     tiles of tw; the parts and tiles of one range take neighbouring
//     blockIdx values, so their metadata reads meet in L2. A CTA sums the
//     blocks of its range that lie in its part into a (prows, tw) Y tile in
//     shared memory and adds the tile into a zeroed Y with one global atomic
//     per (row, column) it holds (four columns to a vector atomic), or
//     stores it at S = 1. The wrapper takes the widest tile (128 columns)
//     and the fewest parts at which two CTAs fit an SM;
//   * staged chunks: a stage holds q chunks' value windows, x window
//     starts and four metadata rows (col, mask, voff, row). One thread
//     issues the windows and, where 16-byte aligned, the metadata rows as
//     bulk copies on the stage's mbarrier (every thread its share by
//     cp.async where not). kStages == 2 keeps a ring of two stages, one round ahead of the walk;
//     kStages == 1 copies a stage and waits for it. The wrapper takes the
//     most chunks a stage that keep the CTAs an SM;
//   * the decode, once a stage: the stage's blocks in the CTA's row part
//     are ranked by (block row, index), each listed block's nonzeros go
//     into a list in that order, one thread a block: the set lanes of a
//     block come in the order its values are packed, so lane k takes the
//     next value of the window (no rank), row + k / c and column + k % c;
//     a lane whose column lies at or past X's rows is left out (X is read
//     in place, never padded, and nothing of X is read for it);
//   * one writer per Y-tile row: lanes form groups, each lane V = 4, 2 or 1
//     neighbouring columns of the tile (one 16-, 8- or 4-byte X load where
//     nvec and X's alignment allow). The list is cut into one contiguous
//     range per group of about as many nonzeros, each moved to a block-row
//     boundary, so no two groups ever add into one tile row and every add
//     is a plain load and store (a shared float atomicAdd is a
//     compare-and-swap loop on this card), for any row order and any
//     repeats (a chunk that spans several columns repeats block rows). A
//     group walks its range four nonzeros at a time: their X rows loaded
//     together, then multiplied in order, a row run summed in registers and
//     added once.
// The Y-tile helpers are shared with the descriptor panel SpMM kernels
// (spc5_spmm_panels.cuh).
//
// Values (all three kernels): the value store is a template parameter T,
// float, __nv_bfloat16 or int8_t. Both layouts put a nonzero's value into
// their list as f32, so the decode happens once, where the list is built,
// as the reference's _expand_vals does it (spc5_stage.cuh: dequant): upcast,
// an int8 value then times its chunk's f32 scale; the walk, its products
// with X and its f32 sums never see the width, and the f32 kernels keep
// their registers and instructions. A narrow window starts on any multiple of 8 bytes, and
// bulk copies need 16-byte aligned ends: it is staged as the 16-byte aligned
// span that covers it, kept inside values (value_span, copy_span), and
// thread 0, which issues the copies, writes each chunk's offset in its span
// and its scale beside the stage's x window starts (8 bytes a chunk).
//
// Column maps (spmm_panels_cmap_kernel and spmm_whole_kernel<MaskWholeCmap<T>,
// R, C, V>, the col_map path of the same three Pallas kernels: a reordered
// plan's fused column permutation). X stays in the original row order, and
// a kept lane of permuted column col reads X's row cmap[col]: the list entry
// that a nonzero becomes holds cmap[col] * nvec in place of col * nvec, so the
// map costs one load through L1 a nonzero and round, shared by every column
// of the tile, and nothing in the walk. A kept lane lies at a real column
// (col < xrows), so the map is never read out of bounds. Each twin's map is
// a field of its own argument struct (CmapPanelArgs, CmapMaskWholeArgs), so
// the kernels without one keep their code.
#pragma once

#include <type_traits>

#include "spc5_spmm_panels.cuh"
#include "spc5_spmm_whole.cuh"
#include "spc5_stage.cuh"

namespace {

__host__ __device__ __forceinline__ int round16(int n) { return (n + 15) & ~15; }

// ---------------------------------------------------------------------------
// panel layout: S CTAs per (panel, row part, column tile), staged chunks,
// one writer per Y-tile row
// ---------------------------------------------------------------------------

struct PanelArgs {
  const int* vbase;       // (npanels, nchunks) value window starts
  const int* xbase;       // (npanels, nchunks) x window starts
  const int* col;         // (npanels, nchunks, cb) block columns in the x window
  const uint32_t* mask;   // (npanels, nchunks, cb) r*c-bit masks, 0: padding
  const int* voff;        // (npanels, nchunks, cb) first values in the window
  const int* row;         // (npanels, nchunks, cb) panel-relative first rows
  const void* values;     // vsize bytes a value: float, __nv_bfloat16 or int8_t
  const float* x;  // (xrows, nvec), read in place
  float* y;        // (nrows, nvec)
  int nchunks, cb, r, c, vmax, pr, nrows, xrows, nvec;
  int tw;      // columns of a tile: vec times the lanes of a group (at most 32 lanes)
  int vec;     // columns a lane owns: 4 or 2 (one 16- or 8-byte X load) or 1
  int ntiles;  // ceil(nvec / tw)
  int parts;   // H: row parts of a panel, each prows rows (a multiple of r; H * prows >= pr)
  int prows;
  int split;   // S: CTAs per (panel, part, tile), each a contiguous range of the panel's chunks
  int q;       // chunks a stage holds
  // last, so the other fields keep the offsets the f32 kernels had:
  const float* scale;  // (npanels, nchunks) int8 scales; unread otherwise
  int vsize;    // the values' bytes: 4, 2 or 1
  int nvalues;  // values' length: no staged span reaches past it
};

// A panel launch with a column map: PanelArgs' fields as they are, then
// the map. X is then (xrows, nvec) in the original row order.
struct CmapPanelArgs : PanelArgs {
  const int* cmap;  // (xrows,): the row of X each permuted column reads
};

template <typename A>
constexpr bool kMapped = false;
template <>
constexpr bool kMapped<CmapPanelArgs> = true;

// The row of X a kept lane of (permuted) column col reads: col, or with a
// column map cmap[col], read through L1 (one load a nonzero, shared by
// every column of the tile).
template <typename A>
__device__ __forceinline__ int x_row(const A& a, int col) {
  if constexpr (kMapped<A>) {
    return __ldg(a.cmap + col);
  } else {
    return col;
  }
}

// Byte offsets of the Y tile's end (the first stage starts there) and of one
// stage's parts, each 16-byte aligned: q value windows of vmax values
// (vstride = value_window bytes apart: a narrow one as its aligned span),
// the q chunks' x window starts, for narrow values each chunk's window
// offset and scale (8 bytes), the four metadata
// rows of their nb = q * cb blocks (col, mask, voff, row; meta_stride bytes
// apart) and a 16-byte slot holding the stage's mbarrier and, at byte 8,
// two counters (the stage's blocks and nonzeros in the CTA's row part);
// after the stages, the sort keys of nb blocks (4 bytes a block) and the
// walk's list of the stage's nonzeros (16 bytes each, at most q vmax: a
// chunk's nonzeros fit its value window). The wrapper plans with its copy
// (kernels/spc5_spmm.py: panels_smem_bytes) and passes its figure in; a
// launch whose figure differs is refused, and spc5_spmm_panels_smem exposes
// this one for the wrapper's tests.
struct PanelLayout {
  int tile, vstride, xbase, wmeta, meta, meta_stride, bar, stage, keys, order;
};

__host__ __device__ inline PanelLayout panel_layout(const PanelArgs& a, int vsize) {
  const int nb = a.q * a.cb;
  PanelLayout L;
  L.tile = round16(4 * a.prows * a.tw);
  L.vstride = value_window(vsize, a.vmax);
  L.xbase = a.q * L.vstride;
  L.wmeta = L.xbase + round16(4 * a.q);
  L.meta = L.wmeta + (vsize < 4 ? round16(8 * a.q) : 0);
  L.meta_stride = round16(4 * nb);
  L.bar = L.meta + 4 * L.meta_stride;
  L.stage = L.bar + 16;
  L.keys = round16(4 * nb);
  L.order = L.keys + 16 * a.q * a.vmax;
  return L;
}

inline size_t panel_smem(const PanelArgs& a, int stages) {
  const PanelLayout L = panel_layout(a, a.vsize);
  return (size_t)L.tile + (size_t)stages * L.stage + L.order;
}

// Start staging the qn chunks from global chunk g on into stage st: thread
// 0 zeroes the stage's counters, announces and issues the bulk copies of
// the chunks' value windows (a narrow one as its span, its offset in it and
// its chunk's scale written beside) and, where `bulk`, of their four
// metadata rows (contiguous: the chunks are neighbours in one panel), all
// completing on the stage's mbarrier, so the mbarrier completes one phase
// per call; every thread issues its share of the other pieces (the
// metadata rows where not `bulk`, the x window starts; a span's last 4 to
// 12 bytes are thread 0's) by cp.async.
template <typename T>
__device__ __forceinline__ void fill_stage(unsigned char* st, const PanelLayout& L,
                                           const PanelArgs& a, size_t g, int qn, bool bulk) {
  const int nbytes = 4 * qn * a.cb;  // one metadata row of the qn chunks
  const size_t slot0 = g * a.cb;
  const char* rows[4] = {reinterpret_cast<const char*>(a.col + slot0),
                         reinterpret_cast<const char*>(a.mask + slot0),
                         reinterpret_cast<const char*>(a.voff + slot0),
                         reinterpret_cast<const char*>(a.row + slot0)};
  if (threadIdx.x == 0) {
    uint64_t* bar = reinterpret_cast<uint64_t*>(st + L.bar);
    *reinterpret_cast<int2*>(st + L.bar + 8) = make_int2(0, 0);  // the counters
    const T* values = static_cast<const T*>(a.values);
    if constexpr (sizeof(T) == 4) {
      mbar_expect_tx(bar, 4 * a.vmax * qn + (bulk ? 4 * nbytes : 0));
      for (int i = 0; i < qn; ++i) {
        bulk_copy(st + L.vstride * i, values + __ldg(a.vbase + g + i), 4 * a.vmax, bar);
      }
    } else {
      int2* wmeta = reinterpret_cast<int2*>(st + L.wmeta);
      uint32_t wbytes = 0;
      for (int i = 0; i < qn; ++i) {
        int bytes, off;
        value_span(values, __ldg(a.vbase + g + i), a.vmax, a.nvalues, bytes, off);
        wmeta[i] = make_int2(off, __float_as_int(value_scale<T>(a.scale, g + i)));
        wbytes += span_bulk_bytes(bytes);
      }
      mbar_expect_tx(bar, wbytes + (bulk ? 4 * nbytes : 0));
      for (int i = 0; i < qn; ++i) {
        int bytes, off;
        const char* span =
            value_span(values, __ldg(a.vbase + g + i), a.vmax, a.nvalues, bytes, off);
        copy_span(st + L.vstride * i, span, bytes, bar);
      }
    }
    if (bulk) {
#pragma unroll
      for (int m = 0; m < 4; ++m) bulk_copy(st + L.meta + m * L.meta_stride, rows[m], nbytes, bar);
    }
  }
  if (!bulk) {
#pragma unroll
    for (int m = 0; m < 4; ++m) copy_runs<true>(st + L.meta + m * L.meta_stride, rows[m], 1, nbytes, 0);
  }
  copy_runs<true>(st + L.xbase, reinterpret_cast<const char*>(a.xbase + g), 1, 4 * qn, 0);
}

// The lanes of a block of width C whose column lies below `lim` (the
// columns left in X from the block's first): bit k for k % C < lim.
template <int C>
__device__ __forceinline__ uint32_t lanes_below(int lim) {
  constexpr uint32_t kRows = C == 4 ? 0x11111111u : 0x01010101u;  // bit 0 of every row
  if (lim >= C) return 0xffffffffu;
  return lim <= 0 ? 0u : ((1u << lim) - 1u) * kRows;
}

// Expand the stage's blocks that lie in the CTA's row part [row0, row0 +
// prows) into the list of their nonzeros that the walk takes, ordered by
// (block row, block index), each nonzero (value bits, X offset x_row(col) *
// nvec, block row, row; tile rows): the block's set lanes in the order their
// values are packed (lane k: the next value of the window, row + k / C,
// column + k % C), less those whose column lies at or past X's rows (which
// the reference reads as zero: nothing of X is read for them), each value
// decoded to f32 (dequant with its chunk's scale). Pass 1: each
// block of the part gets the key (row * nb + b) << 6 | its nonzeros,
// appended to a compact list by a warp ballot, and the nonzeros are
// counted; pass 2: each listed block finds where its nonzeros go by summing
// those of the keys below its own (the blocks before it in the order) and
// writes them. Returns the nonzeros listed. Barriers: one after each pass;
// the caller's next barrier frees the lists.
template <typename T, int C, typename A>
__device__ __forceinline__ int expand_stage(unsigned char* st, const PanelLayout& L,
                                            const A& a, int nb, int row0,
                                            unsigned* keys, int4* nz) {
  constexpr int kColShift = C == 4 ? 2 : 3;
  const unsigned char* meta = st + L.meta;
  const int* s_col = reinterpret_cast<const int*>(meta);
  const uint32_t* s_mask = reinterpret_cast<const uint32_t*>(meta + L.meta_stride);
  const int* s_voff = reinterpret_cast<const int*>(meta + 2 * L.meta_stride);
  const int* s_row = reinterpret_cast<const int*>(meta + 3 * L.meta_stride);
  const int* s_xbase = reinterpret_cast<const int*>(st + L.xbase);
  const T* vwins = reinterpret_cast<const T*>(st);
  int* counts = reinterpret_cast<int*>(st + L.bar + 8);
  const int lane = threadIdx.x & 31;
  // the list's room: every plan to_panels builds packs a chunk's nonzeros
  // into its window; a chunk that holds more (blocks repeating the same
  // values) loses the nonzeros past the room, never writes past it
  const int cap = a.q * a.vmax;
  for (int b0 = 0; b0 < nb; b0 += blockDim.x) {
    const int b = b0 + threadIdx.x;
    int nnz = 0;
    unsigned key = 0u;
    if (b < nb) {
      const int y = s_row[b] - row0;
      const uint32_t m = s_mask[b];
      if ((unsigned)y < (unsigned)a.prows && m != 0u) {
        const int slot = a.q == 1 ? 0 : b / a.cb;
        nnz = __popc(m & lanes_below<C>(a.xrows - s_xbase[slot] - s_col[b]));
        key = (unsigned)(y * nb + b) << 6 | (unsigned)nnz;
      }
    }
    const uint32_t in = __ballot_sync(0xffffffffu, nnz > 0);
    if (in != 0u) {
      const int leader = __ffs(in) - 1;
      int base = 0;
      if (lane == leader) base = atomicAdd(counts, __popc(in));
      base = __shfl_sync(0xffffffffu, base, leader);
      if (nnz > 0) {
        keys[base + __popc(in & ((1u << lane) - 1u))] = key;
        atomicAdd(counts + 1, nnz);
      }
    }
  }
  __syncthreads();
  const int n = counts[0];
  for (int t = threadIdx.x; t < n; t += blockDim.x) {
    const unsigned key = keys[t];
    int pos = 0, i = 0;
    for (; i + 4 <= n; i += 4) {  // keys starts 16-byte aligned
      const uint4 k4 = *reinterpret_cast<const uint4*>(keys + i);
      pos += (k4.x < key ? (int)(k4.x & 63u) : 0) + (k4.y < key ? (int)(k4.y & 63u) : 0) +
             (k4.z < key ? (int)(k4.z & 63u) : 0) + (k4.w < key ? (int)(k4.w & 63u) : 0);
    }
    for (; i < n; ++i) pos += keys[i] < key ? (int)(keys[i] & 63u) : 0;
    const int rb = (int)(key >> 6);
    const int b = rb % nb, by = rb / nb;
    const int slot = a.q == 1 ? 0 : b / a.cb;
    const int xc = s_xbase[slot] + s_col[b];
    const int lim = a.xrows - xc;
    const T* vwin = vwins;
    float sc = 1.f;
    int vi;
    if constexpr (sizeof(T) == 4) {
      vi = slot * (L.vstride >> 2) + s_voff[b];
    } else {
      const int2 m = reinterpret_cast<const int2*>(st + L.wmeta)[slot];  // offset, scale
      vwin = reinterpret_cast<const T*>(st + slot * L.vstride) + m.x;
      sc = __int_as_float(m.y);
      vi = s_voff[b];
    }
    for (uint32_t bits = s_mask[b]; bits != 0u; bits &= bits - 1u, ++vi) {
      const int k = __ffs(bits) - 1;
      const int lc = k & (C - 1);
      if (lc < lim) {
        if (pos < cap) {
          nz[pos] = make_int4(__float_as_int(dequant(vwin[vi], sc)), x_row(a, xc + lc) * a.nvec,
                              by, by + (k >> kColShift));
        }
        ++pos;
      }
    }
  }
  const int total = min(counts[1], cap);
  __syncthreads();
  return total;
}

// Walk nonzeros [i, e) of the stage's list with this lane's group, kBatch
// at a time: their entries, then their X rows loaded through L1 together
// (an empty slot of the last batch loads the last nonzero's row again),
// then multiplied in order, summed in registers while the tile row stays
// and added into the tile, which the group owns, when it changes.
template <int V>
__device__ __forceinline__ void walk_nonzeros(const int4* nz, int i, int e, const PanelArgs& a,
                                              float* ytile, const float* xp, int jv) {
  constexpr int kBatch = 4;
  int cur = -1;
  float acc[V];
#pragma unroll
  for (int u = 0; u < V; ++u) acc[u] = 0.f;
  for (; i < e; i += kBatch) {
    int4 w[kBatch];
    float x[kBatch][V];
#pragma unroll
    for (int j = 0; j < kBatch; ++j) w[j] = nz[min(i + j, e - 1)];
#pragma unroll
    for (int j = 0; j < kBatch; ++j) load_row<V>(xp + w[j].y, x[j]);
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      if (i + j >= e) break;
      if (w[j].w != cur) {
        if (cur >= 0) add_row<V>(ytile, cur, a.tw, jv, a.prows, acc);
        cur = w[j].w;
#pragma unroll
        for (int u = 0; u < V; ++u) acc[u] = 0.f;
      }
      const float v = __int_as_float(w[j].x);
#pragma unroll
      for (int u = 0; u < V; ++u) acc[u] = fmaf(v, x[j][u], acc[u]);
    }
  }
  if (cur >= 0) add_row<V>(ytile, cur, a.tw, jv, a.prows, acc);
}

// Walk the nonzeros of a stage's blocks that lie in the CTA's row part into
// its Y tile (tile rows relative to row0): listed in order by expand_stage
// and cut into one range per lane group of 1 << lg lanes, each moved to a
// block-row boundary (row_range), so that every row of the stage has one
// writer and the groups take about as many nonzeros each.
template <typename T, int C, int V, typename A>
__device__ __forceinline__ void walk_stage(unsigned char* st, const PanelLayout& L,
                                           const A& a, int nb, int row0, float* ytile,
                                           unsigned char* scratch, const float* xp, int jv,
                                           int lg) {
  unsigned* keys = reinterpret_cast<unsigned*>(scratch);
  int4* nz = reinterpret_cast<int4*>(scratch + L.keys);
  const int e = expand_stage<T, C>(st, L, a, nb, row0, keys, nz);
  const int2 range = row_range(nz, e, (int)(blockDim.x >> lg), (int)(threadIdx.x >> lg));
  walk_nonzeros<V>(nz, range.x, range.y, a, ytile, xp, jv);
}

// The panel kernels' body, for launch arguments A (PanelArgs, or
// CmapPanelArgs with a column map).
template <typename T, int C, int V, int kStages, typename A>
__device__ __forceinline__ void panels_body(const A& a) {
  extern __shared__ __align__(16) float psmem[];
  const PanelLayout L = panel_layout(a, (int)sizeof(T));
  float* ytile = psmem;
  unsigned char* ring = reinterpret_cast<unsigned char*>(psmem) + L.tile;
  unsigned char* scratch = ring + kStages * L.stage;
  const bool bulk = ((reinterpret_cast<uintptr_t>(a.col) | reinterpret_cast<uintptr_t>(a.mask) |
                      reinterpret_cast<uintptr_t>(a.voff) | reinterpret_cast<uintptr_t>(a.row) |
                      (uintptr_t)(4 * a.cb)) & 15) == 0;
  const int tile = blockIdx.x % a.ntiles;
  const int h = (blockIdx.x / a.ntiles) % a.parts;  // the row part
  const int unit = blockIdx.x / (a.ntiles * a.parts);  // p * S + part
  const int p = unit / a.split, part = unit - p * a.split;
  const int row0 = h * a.prows;
  const int c0 = (int)((long long)part * a.nchunks / a.split);
  const int n = (int)((long long)(part + 1) * a.nchunks / a.split) - c0;
  const size_t g0 = (size_t)p * a.nchunks + c0;  // global index of the range's first chunk
  for (int i = threadIdx.x; i < L.tile / 16; i += blockDim.x) {
    reinterpret_cast<float4*>(ytile)[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(reinterpret_cast<uint64_t*>(ring + s * L.stage + L.bar));
    }
    mbar_fence_init();
  }
  __syncthreads();  // the barriers are initialised and the tile zeroed
  const int lg = __ffs(a.tw / V) - 1;  // log2 of the lanes of a group
  const int jv = (threadIdx.x & ((1 << lg) - 1)) * V;
  const int col0 = tile * a.tw + jv;
  const float* xp = a.x + (col0 < a.nvec ? col0 : 0);  // an idle lane reads column 0

  // round k stages chunks k q .. k q + q - 1 of the range
  const int rounds = (n + a.q - 1) / a.q;
  auto round_chunks = [&](int k) { return min(a.q, n - k * a.q); };
  if constexpr (kStages == 1) {
    uint64_t* bar = reinterpret_cast<uint64_t*>(ring + L.bar);
    for (int k = 0; k < rounds; ++k) {
      const int qn = round_chunks(k);
      if (k > 0) __syncthreads();  // the previous walk is done
      fill_stage<T>(ring, L, a, g0 + (size_t)k * a.q, qn, bulk);
      cp_async_commit();
      cp_async_wait<0>();
      mbar_wait(bar, k & 1);
      __syncthreads();  // everyone's copies
      walk_stage<T, C, V>(ring, L, a, qn * a.cb, row0, ytile, scratch, xp, jv, lg);
    }
  } else {
    // the ring: round k lives in stage k % 2, round k + 1 is in flight
    // while round k is walked
    fill_stage<T>(ring, L, a, g0, round_chunks(0), bulk);  // n >= 1: split <= nchunks
    cp_async_commit();
    uint32_t parity = 0;  // bit s: the parity of stage s's next phase
    for (int k = 0; k < rounds; ++k) {
      const int dec = k & 1;
      unsigned char* st = ring + dec * L.stage;
      cp_async_wait<0>();  // round k's cp.async pieces of this thread
      mbar_wait(reinterpret_cast<uint64_t*>(st + L.bar), (parity >> dec) & 1u);
      parity ^= 1u << dec;
      __syncthreads();  // ... everyone's; round k - 1's stage is free
      if (k + 1 < rounds) {
        fill_stage<T>(ring + (dec ^ 1) * L.stage, L, a, g0 + (size_t)(k + 1) * a.q,
                      round_chunks(k + 1), bulk);
      }
      cp_async_commit();
      walk_stage<T, C, V>(st, L, a, round_chunks(k) * a.cb, row0, ytile, scratch, xp, jv, lg);
    }
  }
  __syncthreads();
  write_tile<V>(ytile, a, p, h, tile, lg);
}

template <typename T, int C, int V, int kStages>
__global__ void __launch_bounds__(512, 2) spmm_panels_kernel(const PanelArgs a) {
  panels_body<T, C, V, kStages>(a);
}

template <typename T, int C, int V, int kStages>
__global__ void __launch_bounds__(512, 2) spmm_panels_cmap_kernel(const CmapPanelArgs a) {
  panels_body<T, C, V, kStages>(a);
}

template <typename T, int C, int V, typename A>
void (*panel_kernel_v(int stages))(A) {
  if constexpr (kMapped<A>) {
    return stages == 1 ? spmm_panels_cmap_kernel<T, C, V, 1>
                       : stages == 2 ? spmm_panels_cmap_kernel<T, C, V, 2> : nullptr;
  } else {
    return stages == 1 ? spmm_panels_kernel<T, C, V, 1>
                       : stages == 2 ? spmm_panels_kernel<T, C, V, 2> : nullptr;
  }
}

template <typename T, int C, typename A>
void (*panel_kernel_c(int vec, int stages))(A) {
  switch (vec) {
    case 1: return panel_kernel_v<T, C, 1, A>(stages);
    case 2: return panel_kernel_v<T, C, 2, A>(stages);
    case 4: return panel_kernel_v<T, C, 4, A>(stages);
    default: return nullptr;
  }
}

template <typename T, typename A>
void (*panel_kernel_t(int c, int vec, int stages))(A) {
  switch (c) {
    case 4: return panel_kernel_c<T, 4, A>(vec, stages);
    case 8: return panel_kernel_c<T, 8, A>(vec, stages);
    default: return nullptr;
  }
}

// The panel kernel for vsize-byte values (4 float, 2 bf16, 1 int8), block
// width c (4 or 8; the kernel walks a block's set lanes whatever its
// height), vec columns a lane, a ring of `stages` (1: the synchronous
// kernel) and launch arguments A (with a column map for CmapPanelArgs);
// nullptr for any other.
template <typename A>
void (*panel_kernel(int vsize, int c, int vec, int stages))(A) {
  switch (vsize) {
    case 4: return panel_kernel_t<float, A>(c, vec, stages);
    case 2: return panel_kernel_t<__nv_bfloat16, A>(c, vec, stages);
    case 1: return panel_kernel_t<int8_t, A>(c, vec, stages);
    default: return nullptr;
  }
}

// Launch the panel kernel of `stages` with the wrapper's plan: a geometry,
// shared-memory figure or thread count it did not plan (or the kernel
// cannot take), int8 values without their scales, or a column map launch
// without its map, is refused with cudaErrorInvalidValue, launching
// nothing.
template <typename A>
int launch_panels(int stages, const A& a, int npanels, int smem_planned, int threads,
                  int device, void* stream) {
  const auto kernel = panel_kernel<A>(a.vsize, a.c, a.vec, stages);
  bool bad_map = false;
  if constexpr (kMapped<A>) bad_map = a.cmap == nullptr;
  const size_t smem = panel_smem(a, stages);
  const int lanes = a.vec > 0 ? a.tw / a.vec : 0;
  const long long grid = (long long)npanels * a.split * a.parts * a.ntiles;
  const long long nb = (long long)a.q * a.cb;
  if (kernel == nullptr || bad_map || (a.r != 1 && a.r != 2 && a.r != 4 && a.r != 8) || a.r * a.c > 32 ||
      a.nvec < 1 || a.cb < 1 || a.vmax < 4 || a.vmax % 4 != 0 || a.pr < a.r ||
      a.split < 1 || a.split > a.nchunks || a.parts < 1 || a.prows < a.r ||
      a.prows % a.r != 0 || (long long)a.parts * a.prows < a.pr ||
      (long long)(a.parts - 1) * a.prows >= a.pr || a.q < 1 || lanes < 1 || lanes > 32 ||
      lanes * a.vec != a.tw || (lanes & (lanes - 1)) != 0 || a.nvec % a.vec != 0 ||
      a.ntiles != (a.nvec + a.tw - 1) / a.tw || threads < 32 || threads > 512 ||
      (threads & (threads - 1)) != 0 || grid < 1 || grid > 0x7fffffffLL ||
      (a.prows + 1) * nb > (1LL << 26) || (a.vsize == 1 && a.scale == nullptr) ||
      smem != (size_t)smem_planned) {
    return (int)cudaErrorInvalidValue;
  }
  cudaError_t err = prepare_launch(kernel, device, smem, threads, nullptr);
  if (err != cudaSuccess) return (int)err;
  void* args[] = {const_cast<A*>(&a)};
  err = cudaLaunchKernel(reinterpret_cast<const void*>(kernel), dim3((unsigned)grid),
                         dim3(threads), args, smem, (cudaStream_t)stream);
  return (int)(err != cudaSuccess ? err : cudaGetLastError());
}

PanelArgs panel_args(const int* vbase, const int* xbase, const int* col, const uint32_t* mask,
                     const int* voff, const int* row, const void* values, const float* scale,
                     const float* x, float* y, int nchunks, int cb, int vmax, int pr, int nrows,
                     int xrows, int r, int c, int vsize, int nvalues, int nvec, int tw, int vec,
                     int parts, int prows, int split, int q) {
  return PanelArgs{vbase, xbase, col,   mask,  voff,  row,   values, x,     y,
                   nchunks, cb, r, c, vmax, pr, nrows, xrows, nvec, tw, vec,
                   tw > 0 ? (nvec + tw - 1) / tw : 0, parts, prows, split, q, scale, vsize,
                   nvalues};
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

// ---------------------------------------------------------------------------
// whole-vector layout: the skeleton of spc5_spmm_whole.cuh, G contiguous
// chunk ranges, a ring of staged rounds, a per-round nonzero list
// ---------------------------------------------------------------------------

// The mask kernel's part, for values of type T: a stage holds q value
// windows (vstride bytes apart: value_window, a narrow one as its aligned
// span), for narrow values each chunk's window offset and scale (8 bytes),
// the four metadata rows of its nb blocks (col, mask, voff, row;
// meta_stride bytes apart) and a 16-byte mbarrier slot; a block's lanes are
// its set bits, less those whose column lies at or past X's rows, each
// listed with the next value of the window decoded to f32 (the values are
// packed in lane order: no rank).
template <typename T>
struct MaskWholeArgs {
  WholeGeom g;
  const int* vbase;       // (nchunks,) value window starts
  const int* col;         // (nchunks, cb) block columns
  const uint32_t* mask;   // (nchunks, cb) r*c-bit masks, 0: padding
  const int* voff;        // (nchunks, cb) first values in the window
  const int* row;         // (nchunks, cb) first rows
  const T* values;
  const float* scale;     // (nchunks,) int8 scales; unread otherwise
  int nvalues;            // values' length: no staged span reaches past it
};

// f32 values take no scale and no span: their arguments are the ones the
// kernel had before the narrow stores (a larger parameter block changed the
// f32 kernels' registers and spills).
template <>
struct MaskWholeArgs<float> {
  WholeGeom g;
  const int* vbase;
  const int* col;
  const uint32_t* mask;
  const int* voff;
  const int* row;
  const float* values;
};

template <typename T>
struct MaskWhole {
  using Args = MaskWholeArgs<T>;

  static constexpr bool kNarrow = sizeof(T) < 4;

  __host__ __device__ static int vstride(const Args& a) {
    return value_window((int)sizeof(T), a.g.vmax);
  }
  __host__ __device__ static int wmeta(const Args& a) { return a.g.q * vstride(a); }
  __host__ __device__ static int meta(const Args& a) {
    return wmeta(a) + (kNarrow ? wr16(8 * a.g.q) : 0);
  }
  __host__ __device__ static int meta_stride(const Args& a) { return wr16(4 * a.g.nb); }
  __host__ __device__ static int bar_offset(const Args& a) {
    return meta(a) + 4 * meta_stride(a);
  }
  __host__ __device__ static int stage_bytes(const Args& a) { return bar_offset(a) + 16; }

  // Stage blocks [b0, b0 + nb) of global chunks g .. g + qn - 1 (contiguous:
  // one row each of the four metadata arrays) and, where `window`, the qn
  // value windows (a narrow one as its span, its offset in it and its
  // chunk's scale written beside): thread 0 announces and issues the bulk
  // copies (the windows; the metadata rows where 16-byte aligned), all
  // completing on the stage's mbarrier, one phase per call; every thread
  // issues its share of the rest by cp.async (a span's last 4 to 12 bytes
  // are thread 0's).
  __device__ static void fill(unsigned char* st, const Args& a, size_t g, int b0, int nb, int qn,
                              bool window) {
    const size_t slot0 = g * a.g.cb + b0;
    const int nbytes = 4 * nb;
    const char* rows[4] = {reinterpret_cast<const char*>(a.col + slot0),
                           reinterpret_cast<const char*>(a.mask + slot0),
                           reinterpret_cast<const char*>(a.voff + slot0),
                           reinterpret_cast<const char*>(a.row + slot0)};
    const bool bulk = ((reinterpret_cast<uintptr_t>(rows[0]) | reinterpret_cast<uintptr_t>(rows[1]) |
                        reinterpret_cast<uintptr_t>(rows[2]) | reinterpret_cast<uintptr_t>(rows[3]) |
                        (uintptr_t)nbytes) & 15) == 0;
    unsigned char* m = st + meta(a);
    if (threadIdx.x == 0) {
      uint64_t* bar = reinterpret_cast<uint64_t*>(st + bar_offset(a));
      if constexpr (!kNarrow) {
        mbar_expect_tx(bar, (window ? 4 * a.g.vmax * qn : 0) + (bulk ? 4 * nbytes : 0));
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
        mbar_expect_tx(bar, wbytes + (bulk ? 4 * nbytes : 0));
        for (int i = 0; window && i < qn; ++i) {
          int bytes, off;
          const char* span =
              value_span(a.values, __ldg(a.vbase + g + i), a.g.vmax, a.nvalues, bytes, off);
          copy_span(st + vstride(a) * i, span, bytes, bar);
        }
      }
      if (bulk) {
#pragma unroll
        for (int k = 0; k < 4; ++k) bulk_copy(m + k * meta_stride(a), rows[k], nbytes, bar);
      }
    }
    if (!bulk) {
#pragma unroll
      for (int k = 0; k < 4; ++k) copy_runs<true>(m + k * meta_stride(a), rows[k], 1, nbytes, 0);
    }
  }

  __device__ static const int* meta_row(const unsigned char* st, const Args& a, int k) {
    return reinterpret_cast<const int*>(st + meta(a) + k * meta_stride(a));
  }

  __device__ static int first_row(const unsigned char* st, const Args& a) {
    return meta_row(st, a, 3)[0];
  }

  template <int R, int C>
  __device__ static WholeBlock block(const unsigned char* st, const Args& a, int b) {
    const uint32_t m = (uint32_t)meta_row(st, a, 1)[b];
    const uint32_t kept = m != 0u ? m & lanes_below<C>(a.g.xrows - meta_row(st, a, 0)[b]) : 0u;
    return WholeBlock{kept, meta_row(st, a, 3)[b]};
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
    const uint32_t full = (uint32_t)meta_row(st, a, 1)[b];
    const int xc = meta_row(st, a, 0)[b], y = meta_row(st, a, 3)[b];
    int vi = meta_row(st, a, 2)[b];
#pragma unroll
    for (int lr = 0; lr < R; ++lr) {
      uint32_t fb = (full >> (lr * C)) & kRow;
      const uint32_t kb = (kept >> (lr * C)) & kRow;
      int p = pos[lr];
      while (fb != 0u) {
        const int lc = __ffs(fb) - 1;
        fb &= fb - 1u;
        if ((kb >> lc) & 1u) {
          if (p < room) {
            list[p] = make_int4(__float_as_int(dequant(vwin[vi], sc)), (xc + lc) * a.g.nvec,
                                y + lr, 0);
          }
          ++p;
        }
        ++vi;
      }
    }
  }
};

// The column-map twin's arguments: the mask kernel's as they are, then the
// map (X in the original row order).
template <typename T>
struct CmapMaskWholeArgs : MaskWholeArgs<T> {
  const int* cmap;  // (xrows,): the row of X each permuted column reads
};

template <typename T>
constexpr bool kMapped<CmapMaskWholeArgs<T>> = true;

// The whole-vector mask kernel with a column map: MaskWhole's stage, rows
// and lanes, each listed entry's X row read through the map. Its emit is
// MaskWhole's with cmap[col] for col: one emit templated on the argument
// struct compiled the f32 kernels without a map to other SASS.
template <typename T>
struct MaskWholeCmap : MaskWhole<T> {
  using Args = CmapMaskWholeArgs<T>;
  using Base = MaskWhole<T>;

  // The block's kept lanes as MaskWhole::emit lists them, each entry's X
  // offset cmap[col] * nvec.
  template <int R, int C>
  __device__ static void emit(const unsigned char* st, const Args& a, int b, uint32_t kept,
                              const int (&pos)[R], int4* list, int room) {
    constexpr uint32_t kRow = (1u << C) - 1u;
    const int slot = a.g.q == 1 ? 0 : b / a.g.cb;  // the block's chunk in the stage
    const T* vwin = reinterpret_cast<const T*>(st + slot * Base::vstride(a));
    float sc = 1.f;
    if constexpr (Base::kNarrow) {
      const int2 w = reinterpret_cast<const int2*>(st + Base::wmeta(a))[slot];  // offset, scale
      vwin += w.x;
      sc = __int_as_float(w.y);
    }
    const uint32_t full = (uint32_t)Base::meta_row(st, a, 1)[b];
    const int xc = Base::meta_row(st, a, 0)[b], y = Base::meta_row(st, a, 3)[b];
    int vi = Base::meta_row(st, a, 2)[b];
#pragma unroll
    for (int lr = 0; lr < R; ++lr) {
      uint32_t fb = (full >> (lr * C)) & kRow;
      const uint32_t kb = (kept >> (lr * C)) & kRow;
      int p = pos[lr];
      while (fb != 0u) {
        const int lc = __ffs(fb) - 1;
        fb &= fb - 1u;
        if ((kb >> lc) & 1u) {
          if (p < room) {
            list[p] = make_int4(__float_as_int(dequant(vwin[vi], sc)),
                                __ldg(a.cmap + xc + lc) * a.g.nvec, y + lr, 0);
          }
          ++p;
        }
        ++vi;
      }
    }
  }
};

// P: MaskWhole<T>, or MaskWholeCmap<T> with a column map.
template <typename P>
using MaskWholeKernel = void (*)(typename P::Args);

template <typename P, int R, int C>
MaskWholeKernel<P> mask_whole_rc(int vec) {
  switch (vec) {
    case 1: return spmm_whole_kernel<P, R, C, 1>;
    case 2: return spmm_whole_kernel<P, R, C, 2>;
    case 4: return spmm_whole_kernel<P, R, C, 4>;
    default: return nullptr;
  }
}

// The whole-vector kernel of policy P, block shape (r, c) (every shape of
// formats.SUPPORTED_BLOCKS) and vec columns a lane; nullptr for any other.
template <typename P>
MaskWholeKernel<P> mask_whole_kernel(int r, int c, int vec) {
  switch (r * 16 + c) {
    case 1 * 16 + 4: return mask_whole_rc<P, 1, 4>(vec);
    case 1 * 16 + 8: return mask_whole_rc<P, 1, 8>(vec);
    case 2 * 16 + 4: return mask_whole_rc<P, 2, 4>(vec);
    case 2 * 16 + 8: return mask_whole_rc<P, 2, 8>(vec);
    case 4 * 16 + 4: return mask_whole_rc<P, 4, 4>(vec);
    case 4 * 16 + 8: return mask_whole_rc<P, 4, 8>(vec);
    case 8 * 16 + 4: return mask_whole_rc<P, 8, 4>(vec);
    default: return nullptr;
  }
}

WholeGeom mask_whole_geom(int nchunks, int cb, int vmax, int nrows, int xrows, int r, int c,
                          int nvec, int tw, int vec, int grid, int stages, int q, int nb,
                          int tile_rows) {
  return WholeGeom{nullptr, nullptr, nchunks, cb, r, c, vmax, nrows, xrows, nvec, tw, vec,
                   tw > 0 ? (nvec + tw - 1) / tw : 0, grid, stages, q, nb, tile_rows};
}

// The CTA's dynamic shared memory of the kernel for T values at geometry g.
template <typename T>
int mask_whole_bytes(const WholeGeom& g, int threads) {
  typename MaskWhole<T>::Args a{};
  a.g = g;
  return whole_layout(g, MaskWhole<T>::stage_bytes(a), threads).bytes;
}

int mask_whole_smem(int vsize, const WholeGeom& g, int threads) {
  switch (vsize) {
    case 4: return mask_whole_bytes<float>(g, threads);
    case 2: return mask_whole_bytes<__nv_bfloat16>(g, threads);
    case 1: return mask_whole_bytes<int8_t>(g, threads);
    default: return -1;
  }
}

// Launch the whole-vector kernel of policy P (values of type T) with the
// wrapper's plan: a geometry, shared-memory figure or thread count it did
// not plan, int8 values without their scales, or a column map launch
// without its map, is refused with cudaErrorInvalidValue, launching
// nothing.
template <typename T, typename P>
int launch_mask_whole_p(const WholeGeom& g, const int* vbase, const int* col,
                        const uint32_t* mask, const int* voff, const int* row,
                        const void* values, const float* scale, int nvalues, const int* cmap,
                        int smem, int threads, int device, void* stream) {
  typename P::Args a{};
  a.g = g;
  a.vbase = vbase;
  a.col = col;
  a.mask = mask;
  a.voff = voff;
  a.row = row;
  a.values = static_cast<const T*>(values);
  if constexpr (sizeof(T) < 4) {
    a.scale = scale;
    a.nvalues = nvalues;
  }
  bool bad_map = false;
  if constexpr (kMapped<typename P::Args>) {
    a.cmap = cmap;
    bad_map = cmap == nullptr;
  }
  const MaskWholeKernel<P> kernel = mask_whole_kernel<P>(g.r, g.c, g.vec);
  const size_t bytes = whole_layout(g, P::stage_bytes(a), threads).bytes;
  if (kernel == nullptr || bad_map || !whole_geom_ok(g, threads) || bytes != (size_t)smem ||
      (sizeof(T) == 1 && scale == nullptr)) {
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

// The whole-vector launch for vsize-byte values (4 f32, 2 bf16, 1 int8 with
// its scales), with the column-map twin where `mapped`.
template <bool kMap>
int launch_mask_whole(int vsize, const WholeGeom& g, const int* vbase, const int* col,
                      const uint32_t* mask, const int* voff, const int* row, const void* values,
                      const float* scale, int nvalues, const int* cmap, int smem, int threads,
                      int device, void* stream) {
  switch (vsize) {
    case 4:
      return launch_mask_whole_p<float, std::conditional_t<kMap, MaskWholeCmap<float>,
                                                           MaskWhole<float>>>(
          g, vbase, col, mask, voff, row, values, scale, nvalues, cmap, smem, threads, device,
          stream);
    case 2:
      return launch_mask_whole_p<__nv_bfloat16,
                                 std::conditional_t<kMap, MaskWholeCmap<__nv_bfloat16>,
                                                    MaskWhole<__nv_bfloat16>>>(
          g, vbase, col, mask, voff, row, values, scale, nvalues, cmap, smem, threads, device,
          stream);
    case 1:
      return launch_mask_whole_p<int8_t, std::conditional_t<kMap, MaskWholeCmap<int8_t>,
                                                            MaskWhole<int8_t>>>(
          g, vbase, col, mask, voff, row, values, scale, nvalues, cmap, smem, threads, device,
          stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The whole-vector kernel's occupancy (policy MaskWhole, or MaskWholeCmap
// where kMap) for vsize-byte values, block shape (r, c), vec columns a lane,
// `threads` and `smem` bytes of dynamic shared memory per CTA.
template <bool kMap>
int mask_whole_occupancy(int vsize, int r, int c, int vec, int threads, int smem, int device,
                         int* out) {
  switch (vsize) {
    case 4:
      return occupancy(
          mask_whole_kernel<std::conditional_t<kMap, MaskWholeCmap<float>, MaskWhole<float>>>(
              r, c, vec),
          threads, smem, device, out);
    case 2:
      return occupancy(mask_whole_kernel<std::conditional_t<kMap, MaskWholeCmap<__nv_bfloat16>,
                                                            MaskWhole<__nv_bfloat16>>>(r, c, vec),
                       threads, smem, device, out);
    case 1:
      return occupancy(
          mask_whole_kernel<std::conditional_t<kMap, MaskWholeCmap<int8_t>, MaskWhole<int8_t>>>(
              r, c, vec),
          threads, smem, device, out);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace
