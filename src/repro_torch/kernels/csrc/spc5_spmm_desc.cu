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
// Panel kernels (spmm_desc_panels_kernel), built for the H100, not for the
// TPU's sequential grid:
//   * split grid: each panel's chunk list is cut into S contiguous ranges
//     (the wrapper picks S with the panel SpMV pairs' rule), its rows into
//     H row parts of prows rows (a multiple of r) and its columns into
//     tiles of tw; the parts and tiles of one range take neighbouring
//     blockIdx values, so their table reads meet in L2. A CTA sums the
//     blocks of its range that lie in its part into a (prows, tw) Y tile in
//     shared memory and adds the tile into a zeroed Y with one global atomic
//     per (row, column) it holds (four columns to a vector atomic), or
//     stores it at S = 1. The wrapper takes the widest tile (128 columns)
//     and the fewest parts at which two CTAs fit an SM;
//   * staged tables: a stage holds the chunk's value window, its valid and
//     vidx runs at their built widths, the c xcol entries of each block's
//     first row and the 4-byte word holding each block's lane-0 yrow entry
//     (xcol[k] == xcol[k % c] and, on valid lanes, yrow[k] == yrow[0] +
//     k / c in this layout; tests/test_torch_desc_panels.py and
//     tests/test_torch_spmm_desc_panels.py pin both). One thread issues the
//     value window and, where 16-byte aligned, the valid and vidx runs as
//     bulk copies on the stage's mbarrier; every thread issues its share of
//     the strided xcol and yrow runs by cp.async (copy_runs). kStages == 2
//     keeps a ring of two stages, one chunk ahead of the walk; kStages == 1
//     copies a stage and waits for it (cut into slices of blocks when a
//     whole chunk's stage does not fit). Nothing is read per element from
//     device memory but X;
//   * one writer per Y-tile row: lanes form groups of L, each lane V = 4, 2
//     or 1 neighbouring columns of the tile (tw = L V; one 16- or 8-byte X
//     load where nvec and X's alignment allow). Per stage the CTA sorts its
//     part's blocks by row (a rank count over the staged yrow words) and
//     cuts them into one contiguous range per group, each moved to a row
//     boundary. So every row of the stage belongs to one group, no two
//     groups ever add into one tile row, and every add is a plain load and
//     store (a shared float atomicAdd is a compare-and-swap loop on this
//     card), right for any yrow order and any repeats (a chunk that spans
//     several columns repeats block rows). A group sums a row run across
//     blocks in registers and adds it once;
//   * per block, a group of a whole warp first reads lane k's entry (value
//     window[vidx], X offset of its column) into lane k, then walks the set
//     lanes in order, four at a time: their entries by shuffle (narrower
//     groups read them themselves), their X rows loaded together through
//     L1, then multiplied in order. A lane whose column lies at or past X's
//     rows reads nothing of X and adds nothing;
//   * the value store is the kernels' template parameter T: float, bf16 or
//     int8 (the quantised decode of the reference's _expand_vals: a lane's
//     value upcast to f32, an int8 one then times its chunk's f32 scale,
//     before its products with X, summed in f32). The bulk copy needs
//     16-byte aligned ends, so a narrow window is staged as the aligned
//     span that covers it (an int8 window starts on any multiple of 8
//     bytes); thread 0 writes each staged chunk's offset into its span and
//     its scale beside the chunk's x window start, and the walk reads them
//     once a block, as it reads that start.
// The Y-tile helpers (an X row's load, row adds, the groups' row-aligned
// ranges, the tile's write) are shared with the mask panel SpMM kernels of
// spc5_spmm.cu through spc5_spmm_panels.cuh.
//
// Each launcher runs on the caller's stream, allocates nothing, does not
// synchronise, and returns cudaGetLastError() (0 on success).

#include "spc5_spmm_panels.cuh"
#include "spc5_spmm_whole.cuh"
#include "spc5_stage.cuh"

namespace {

__host__ __device__ __forceinline__ int round16(int n) { return (n + 15) & ~15; }

// Bit i: byte i of w is not zero.
__device__ __forceinline__ uint32_t nonzero_bytes(uint32_t w) {
  const uint32_t t = __vcmpne4(w, 0u) & 0x01010101u;
  return (t * 0x01020408u) >> 24;
}

// ---------------------------------------------------------------------------
// panel layout: S CTAs per (panel, row part, column tile), staged tables,
// one writer per Y-tile row
// ---------------------------------------------------------------------------

struct PanelArgs {
  const int* vbase;  // (npanels, nchunks) value window starts
  const int* xbase;  // (npanels, nchunks) x window starts
  const signed char* valid;
  const char* vidx;  // the index tables, as bytes (entries wv, wx, wy wide)
  const char* xcol;
  const char* yrow;
  const void* values;  // vsize bytes a value: float, __nv_bfloat16 or int8_t
  const float* scale;  // (npanels, nchunks) int8 scales; unread otherwise
  const float* x;  // (xrows, nvec), read in place
  float* y;        // (nrows, nvec)
  int nchunks, cb, r, c, vmax, pr, nrows, xrows, vsize, wv, wx, wy;
  int nvec;
  int tw;      // columns of a tile: vec times the lanes of a group (at most 32 lanes)
  int vec;     // columns a lane owns: 4 or 2 (one 16- or 8-byte X load) or 1
  int ntiles;  // ceil(nvec / tw)
  int parts;   // H: row parts of a panel, each prows rows (a multiple of r; H * prows >= pr)
  int prows;
  int split;   // S: CTAs per (panel, part, tile), each a contiguous range of the panel's chunks
  int q;       // chunks a stage holds (1 where a stage holds a slice of one)
  int nb;      // blocks whose tables one stage holds (q * cb, or a slice of a chunk)
  int nvalues;  // values' length: no staged span reaches past it (last, so
                // the other fields keep the offsets the f32 kernels had)
};

// Byte offsets of the Y tile's end (the first stage starts there) and of one
// stage's parts, each 16-byte aligned: the value windows (value_window bytes
// each) and x window starts of its q chunks, for narrow values each chunk's
// window offset and scale (8 bytes), for nb blocks the valid and vidx runs,
// the c xcol entries
// of each block's first row, each block's lane-0 yrow entry in a 4-byte
// slot, and a 16-byte slot for the stage's mbarrier; after the stages, the
// walk's order of nb blocks (16 bytes a block) and their sort keys (4 bytes
// a block). The wrapper plans with its copy (kernels/spc5_spmm_desc.py:
// panels_smem_bytes) and passes its figure in; a launch whose figure
// differs is refused, and spc5_spmm_desc_panels_smem exposes this one for
// the wrapper's tests.
struct PanelLayout {
  int tile, vwin, xbase, wmeta, valid, vidx, xcol, yrow, bar, stage, order;
};

__host__ __device__ inline PanelLayout panel_layout(const PanelArgs& a) {
  const int rc = a.r * a.c;
  PanelLayout L;
  L.tile = round16(4 * a.prows * a.tw);
  L.vwin = 0;  // q value windows of vmax values (vmax a multiple of 4)
  L.xbase = a.q * value_window(a.vsize, a.vmax);
  L.wmeta = L.xbase + round16(4 * a.q);
  L.valid = L.wmeta + (a.vsize < 4 ? round16(8 * a.q) : 0);
  L.vidx = L.valid + round16(a.nb * rc);
  L.xcol = L.vidx + round16(a.nb * rc * a.wv);
  L.yrow = L.xcol + round16(a.nb * a.c * a.wx);
  L.bar = L.yrow + round16(4 * a.nb);
  L.stage = L.bar + 16;
  L.order = 16 * a.nb + round16(4 * a.nb);  // after the ring: the walk's order, keys
  return L;
}

inline size_t panel_smem(const PanelArgs& a, int stages) {
  const PanelLayout L = panel_layout(a);
  return (size_t)L.tile + (size_t)stages * L.stage + L.order;
}

// Start staging nb blocks from block b0 of global chunk g on into stage st:
// the qn chunks they span (one, or q whole ones) and, where `windows`,
// those chunks' value windows (a narrow one as the aligned span that covers
// it, kept inside values (copy_span), its offset in the span and its
// chunk's scale written beside). Thread 0
// announces and issues the bulk copies (the windows; the valid and vidx
// runs where `bulk`), all completing on the stage's mbarrier, so the
// mbarrier completes one phase per call; every thread issues its share of
// the other pieces by cp.async.
template <typename T>
__device__ __forceinline__ void fill_stage(unsigned char* st, const PanelLayout& L,
                                           const PanelArgs& a, size_t g, int b0, int nb, int qn,
                                           bool windows, bool bulk) {
  const int rc = a.r * a.c;
  const size_t lane0 = (g * a.cb + b0) * rc;
  const char* valid = reinterpret_cast<const char*>(a.valid) + lane0;
  const char* vidx = a.vidx + lane0 * a.wv;
  const int nvalid = nb * rc, nvidx = nb * rc * a.wv;
  if (threadIdx.x == 0) {
    uint64_t* bar = reinterpret_cast<uint64_t*>(st + L.bar);
    const T* values = static_cast<const T*>(a.values);
    if constexpr (sizeof(T) == 4) {
      mbar_expect_tx(bar, (windows ? 4 * a.vmax * qn : 0) + (bulk ? nvalid + nvidx : 0));
      for (int i = 0; windows && i < qn; ++i) {
        bulk_copy(st + L.vwin + 4 * a.vmax * i, values + __ldg(a.vbase + g + i), 4 * a.vmax, bar);
      }
    } else {
      const int stride = value_window(a.vsize, a.vmax);
      int2* meta = reinterpret_cast<int2*>(st + L.wmeta);
      uint32_t wbytes = 0;
      for (int i = 0; windows && i < qn; ++i) {
        int bytes, off;
        value_span(values, __ldg(a.vbase + g + i), a.vmax, a.nvalues, bytes, off);
        float sc = 1.f;
        if constexpr (sizeof(T) == 1) sc = __ldg(a.scale + g + i);
        meta[i] = make_int2(off, __float_as_int(sc));
        wbytes += span_bulk_bytes(bytes);
      }
      mbar_expect_tx(bar, wbytes + (bulk ? nvalid + nvidx : 0));
      for (int i = 0; windows && i < qn; ++i) {
        int bytes, off;
        const char* span =
            value_span(values, __ldg(a.vbase + g + i), a.vmax, a.nvalues, bytes, off);
        copy_span(st + L.vwin + stride * i, span, bytes, bar);
      }
    }
    if (bulk) {
      bulk_copy(st + L.valid, valid, nvalid, bar);
      bulk_copy(st + L.vidx, vidx, nvidx, bar);
    }
  }
  if (!bulk) {
    copy_runs<true>(st + L.valid, valid, 1, nvalid, 0);
    copy_runs<true>(st + L.vidx, vidx, 1, nvidx, 0);
  }
  copy_runs<true>(st + L.xbase, reinterpret_cast<const char*>(a.xbase + g), 1, 4 * qn, 0);
  // xcol[k] == xcol[k % c]: the c entries of each block's first row
  copy_runs<true>(st + L.xcol, a.xcol + lane0 * a.wx, nb, a.c * a.wx, rc * a.wx);
  // yrow[k] == yrow[0] + k / c on valid lanes: the 4-byte word holding each
  // block's lane-0 entry (r*c >= 4, so the word is aligned and inside the
  // block's entries)
  copy_runs<true>(st + L.yrow, a.yrow + lane0 * a.wy, nb, 4, rc * a.wy);
}

// Entry i of a table of w-byte entries (1, 2 or 4; never negative) in
// shared memory, from the aligned 4-byte word holding it.
__device__ __forceinline__ int smem_entry(const unsigned char* t, int i, int w) {
  const int byte = i * w;
  const unsigned word = *reinterpret_cast<const unsigned*>(t + (byte & ~3));
  unsigned v;
  asm("bfe.u32 %0, %1, %2, %3;" : "=r"(v) : "r"(word), "r"((byte & 3) << 3), "r"(w << 3));
  return (int)v;
}

// The RC valid bytes of one staged block (at a multiple of RC bytes past a
// 16-byte boundary) as an RC-bit mask.
template <int RC>
__device__ __forceinline__ uint32_t smem_block_mask(const unsigned char* v) {
  if constexpr (RC == 4) {
    return nonzero_bytes(*reinterpret_cast<const unsigned*>(v));
  } else if constexpr (RC == 8) {
    const uint2 q = *reinterpret_cast<const uint2*>(v);
    return nonzero_bytes(q.x) | nonzero_bytes(q.y) << 4;
  } else {
    const uint4 q = *reinterpret_cast<const uint4*>(v);
    uint32_t m = nonzero_bytes(q.x) | nonzero_bytes(q.y) << 4 | nonzero_bytes(q.z) << 8 |
                 nonzero_bytes(q.w) << 12;
    if constexpr (RC == 32) {
      const uint4 h = reinterpret_cast<const uint4*>(v)[1];
      m |= (nonzero_bytes(h.x) | nonzero_bytes(h.y) << 4 | nonzero_bytes(h.z) << 8 |
            nonzero_bytes(h.w) << 12)
           << 16;
    }
    return m;
  }
}

// Four zeros, read where a lane has no X row.
__device__ __align__(16) const float kNoX[4] = {0.f, 0.f, 0.f, 0.f};

// X at offset off (a row's start; -1: none, read as zeros from kNoX) of
// this lane's V columns (p: X at the lane's first column). The load is
// never skipped, so a batch's loads issue together.
template <int V>
__device__ __forceinline__ void load_x(const float* p, int off, float (&out)[V]) {
  load_row<V>(off < 0 ? kNoX : p + off, out);
}

// Lane k of a staged block: its value and its column's offset in X (col *
// nvec); {0, -1} where the lane is not set or its column lies at or past
// X's rows, which the reference reads as zero.
struct LaneEntry {
  float v;
  int off;
};

template <typename T, int C>
__device__ __forceinline__ LaneEntry lane_entry(const T* vwin, float s, const unsigned char* bvidx,
                                                const unsigned char* bxcol, uint32_t bm, int k,
                                                int xb, const PanelArgs& a) {
  LaneEntry e{0.f, -1};
  if ((bm >> k) & 1u) {
    const int col = xb + smem_entry(bxcol, k & (C - 1), a.wx);
    if (col < a.xrows) {
      e.v = dequant(vwin[smem_entry(bvidx, k, a.wv)], s);
      e.off = col * a.nvec;
    }
  }
  return e;
}

// Walk one block (b, mask bm, first tile row by) with this lane's group of
// 1 << lg lanes: its set lanes in order, kBatch at a time (their X rows
// loaded through L1 together, then multiplied in order), summed in
// registers (acc) while the tile row (cur) stays, from block to block, and
// added into the tile when it changes. A group of a whole warp first reads
// lane k's entry into lane k and passes it on by shuffle; narrower groups
// read each set lane's entry themselves. The block's chunk's window starts at
// vwin; s is its scale (int8 only).
template <typename T, int R, int C, int V>
__device__ __forceinline__ void walk_block(const T* vwin, float s, const unsigned char* svidx,
                                           const unsigned char* sxcol, int b, uint32_t bm,
                                           int by, int xb, const PanelArgs& a, float* ytile,
                                           const float* xp, int jv, int lg, int& cur,
                                           float (&acc)[V]) {
  constexpr int RC = R * C;
  constexpr int kColShift = C == 4 ? 2 : 3;
  constexpr int kBatch = 4;
  const unsigned char* bvidx = svidx + b * RC * a.wv;
  const unsigned char* bxcol = sxcol + b * C * a.wx;
  const bool pre = lg == 5;
  const int j = threadIdx.x & 31;
  LaneEntry e0{0.f, -1};
  if (pre && j < RC) e0 = lane_entry<T, C>(vwin, s, bvidx, bxcol, bm, j, xb, a);
  uint32_t bits = bm;
  while (bits != 0u) {
    int k[kBatch];
    LaneEntry e[kBatch];
#pragma unroll
    for (int i = 0; i < kBatch; ++i) {  // the next kBatch set lanes (-1: none)
      k[i] = bits != 0u ? __ffs(bits) - 1 : -1;
      bits &= bits - 1u;
      if (pre) {
        e[i].v = __shfl_sync(0xffffffffu, e0.v, max(k[i], 0));
        e[i].off = __shfl_sync(0xffffffffu, e0.off, max(k[i], 0));
      } else {
        e[i] = lane_entry<T, C>(vwin, s, bvidx, bxcol, bm, max(k[i], 0), xb, a);
      }
      if (k[i] < 0) e[i].off = -1;
    }
    float x[kBatch][V];
#pragma unroll
    for (int i = 0; i < kBatch; ++i) load_x<V>(xp, e[i].off, x[i]);
#pragma unroll
    for (int i = 0; i < kBatch; ++i) {
      if (k[i] < 0) break;
      const int row = by + (k[i] >> kColShift);
      if (row != cur) {
        if (cur >= 0) add_row<V>(ytile, cur, a.tw, jv, a.prows, acc);
        cur = row;
#pragma unroll
        for (int u = 0; u < V; ++u) acc[u] = 0.f;
      }
#pragma unroll
      for (int u = 0; u < V; ++u) acc[u] = fmaf(e[i].v, x[i][u], acc[u]);
    }
  }
}

// Order the stage's nb blocks for the walk by (row, index), the blocks
// outside the CTA's row part [row0, row0 + prows) last, as padding:
// keys[b] = (row - row0) * nb + b (prows for padding), and info[rank] =
// (b, valid mask, row - row0) (mask 0 for padding). Returns the blocks
// before the padding. Barriers: one a pass of blockDim blocks, and one; the
// caller's next barrier frees the arrays again.
template <int RC>
__device__ __forceinline__ int order_blocks(const unsigned char* st, const PanelLayout& L,
                                            const PanelArgs& a, int nb, int row0, int* keys,
                                            int4* info) {
  int n = 0;
  for (int b0 = 0; b0 < nb; b0 += blockDim.x) {
    const int b = b0 + threadIdx.x;
    bool in = false;
    if (b < nb) {
      const int y = smem_entry(st + L.yrow + 4 * b, 0, a.wy) - row0;
      in = (unsigned)y < (unsigned)a.prows && smem_block_mask<RC>(st + L.valid + b * RC) != 0u;
      keys[b] = (in ? y : a.prows) * nb + b;
    }
    n += __syncthreads_count(in);
  }
  for (int b = threadIdx.x; b < nb; b += blockDim.x) {
    const int key = keys[b];
    int rank = 0, i = 0;
    for (; i + 4 <= nb; i += 4) {  // keys starts 16-byte aligned
      const int4 q = *reinterpret_cast<const int4*>(keys + i);
      rank += (q.x < key) + (q.y < key) + (q.z < key) + (q.w < key);
    }
    for (; i < nb; ++i) rank += keys[i] < key;
    const int y = key / nb;
    info[rank] = make_int4(b, y < a.prows ? (int)smem_block_mask<RC>(st + L.valid + b * RC) : 0,
                           y, 0);
  }
  __syncthreads();
  return n;
}

// Walk the nb staged blocks of a stage that lie in the CTA's row part into
// its Y tile (tile rows relative to row0). The CTA's lane groups cut the
// blocks, in the order of order_blocks, into contiguous ranges of about
// equal length, each moved to a row boundary: so every row of the stage
// belongs to one group, which adds into it with plain loads and stores and
// sums a row run across blocks.
template <typename T, int R, int C, int V>
__device__ __forceinline__ void walk_stage(const unsigned char* st, const PanelLayout& L,
                                           const PanelArgs& a, int nb, int row0, float* ytile,
                                           int* scratch, const float* xp, int jv, int lg) {
  constexpr int RC = R * C;
  const int* xbases = reinterpret_cast<const int*>(st + L.xbase);
  const int2* wmeta = reinterpret_cast<const int2*>(st + L.wmeta);
  const unsigned char* svidx = st + L.vidx;
  const unsigned char* sxcol = st + L.xcol;
  int4* info = reinterpret_cast<int4*>(scratch);
  int* keys = scratch + 4 * nb;
  const int groups = (int)(blockDim.x >> lg), u = threadIdx.x >> lg;
  const int n = order_blocks<RC>(st, L, a, nb, row0, keys, info);  // the padding left out
  const int2 range = row_range(info, n, groups, u);
  int cur = -1;
  float acc[V];
#pragma unroll
  for (int w = 0; w < V; ++w) acc[w] = 0.f;
  for (int i = range.x; i < range.y; ++i) {
    const int4 w = info[i];
    const int b = w.x, by = w.z;
    const uint32_t bm = (uint32_t)w.y;
    const int slot = a.q == 1 ? 0 : b / a.cb;  // the block's chunk in the stage
    const T* vwin;
    float s = 1.f;
    if constexpr (sizeof(T) == 4) {
      vwin = reinterpret_cast<const T*>(st + L.vwin) + slot * a.vmax;
    } else {
      const int2 m = wmeta[slot];  // the window's offset in its span, the chunk's scale
      vwin = reinterpret_cast<const T*>(st + L.vwin + slot * value_window(a.vsize, a.vmax)) + m.x;
      s = __int_as_float(m.y);
    }
    walk_block<T, R, C, V>(vwin, s, svidx, sxcol, b, bm, by, xbases[slot], a, ytile, xp, jv, lg,
                           cur, acc);
  }
  if (cur >= 0) add_row<V>(ytile, cur, a.tw, jv, a.prows, acc);
}

template <typename T, int R, int C, int V, int kStages>
__global__ void __launch_bounds__(512, 2) spmm_desc_panels_kernel(const PanelArgs a) {
  extern __shared__ __align__(16) float psmem[];
  const PanelLayout L = panel_layout(a);
  float* ytile = psmem;
  unsigned char* ring = reinterpret_cast<unsigned char*>(psmem) + L.tile;
  int* scratch = reinterpret_cast<int*>(ring + kStages * L.stage);
  const bool bulk = ((reinterpret_cast<uintptr_t>(a.valid) | reinterpret_cast<uintptr_t>(a.vidx) |
                      (uintptr_t)(a.cb * R * C) | (uintptr_t)(a.nb * R * C)) & 15) == 0;
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

  if constexpr (kStages == 1) {
    uint64_t* bar = reinterpret_cast<uint64_t*>(ring + L.bar);
    uint32_t phase = 0;
    for (int j = 0; j < n; j += a.q) {  // q chunks a stage, or slices of one
      const int qn = min(a.q, n - j), span = qn * a.cb;
      for (int b0 = 0; b0 < span; b0 += a.nb) {
        const int nb = min(a.nb, span - b0);
        if (j > 0 || b0 > 0) __syncthreads();  // the previous walk is done
        fill_stage<T>(ring, L, a, g0 + j, b0, nb, qn, b0 == 0, bulk);
        cp_async_commit();
        cp_async_wait<0>();
        mbar_wait(bar, phase & 1u);
        ++phase;
        __syncthreads();  // everyone's copies
        walk_stage<T, R, C, V>(ring, L, a, nb, row0, ytile, scratch, xp, jv, lg);
      }
    }
  } else {
    // the ring: round k (chunks k q .. k q + q - 1) lives in stage k % 2,
    // round k + 1 is in flight while round k is walked
    const int rounds = (n + a.q - 1) / a.q;
    if (n > 0) fill_stage<T>(ring, L, a, g0, 0, min(a.q, n) * a.cb, min(a.q, n), true, bulk);
    cp_async_commit();
    uint32_t parity = 0;  // bit s: the parity of stage s's next phase
    for (int k = 0; k < rounds; ++k) {
      const int dec = k & 1;
      unsigned char* st = ring + dec * L.stage;
      const int qn = min(a.q, n - k * a.q);
      cp_async_wait<0>();  // round k's cp.async pieces of this thread
      mbar_wait(reinterpret_cast<uint64_t*>(st + L.bar), (parity >> dec) & 1u);
      parity ^= 1u << dec;
      __syncthreads();  // ... everyone's; round k - 1's stage is free
      if (k + 1 < rounds) {
        const int qn1 = min(a.q, n - (k + 1) * a.q);
        fill_stage<T>(ring + (dec ^ 1) * L.stage, L, a, g0 + (k + 1) * a.q, 0, qn1 * a.cb, qn1,
                      true, bulk);
      }
      cp_async_commit();
      walk_stage<T, R, C, V>(st, L, a, qn * a.cb, row0, ytile, scratch, xp, jv, lg);
    }
  }
  __syncthreads();
  write_tile<V>(ytile, a, p, h, tile, lg);
}

using PanelKernel = void (*)(PanelArgs);

template <typename T, int R, int C, int V>
PanelKernel panel_kernel_v(int stages) {
  return stages == 1 ? spmm_desc_panels_kernel<T, R, C, V, 1>
                     : stages == 2 ? spmm_desc_panels_kernel<T, R, C, V, 2> : nullptr;
}

template <typename T, int R, int C>
PanelKernel panel_kernel_rc(int vec, int stages) {
  switch (vec) {
    case 1: return panel_kernel_v<T, R, C, 1>(stages);
    case 2: return panel_kernel_v<T, R, C, 2>(stages);
    case 4: return panel_kernel_v<T, R, C, 4>(stages);
    default: return nullptr;
  }
}

template <typename T>
PanelKernel panel_kernel_t(int r, int c, int vec, int stages) {
  switch (r * 16 + c) {
    case 1 * 16 + 4: return panel_kernel_rc<T, 1, 4>(vec, stages);
    case 1 * 16 + 8: return panel_kernel_rc<T, 1, 8>(vec, stages);
    case 2 * 16 + 4: return panel_kernel_rc<T, 2, 4>(vec, stages);
    case 2 * 16 + 8: return panel_kernel_rc<T, 2, 8>(vec, stages);
    case 4 * 16 + 4: return panel_kernel_rc<T, 4, 4>(vec, stages);
    case 4 * 16 + 8: return panel_kernel_rc<T, 4, 8>(vec, stages);
    case 8 * 16 + 4: return panel_kernel_rc<T, 8, 4>(vec, stages);
    default: return nullptr;
  }
}

// The panel kernel for vsize-byte values (4 float, 2 bf16, 1 int8), block
// shape (r, c), vec columns a lane and a ring of `stages` (1: the
// synchronous kernel); nullptr for any other.
PanelKernel panel_kernel(int vsize, int r, int c, int vec, int stages) {
  switch (vsize) {
    case 4: return panel_kernel_t<float>(r, c, vec, stages);
    case 2: return panel_kernel_t<__nv_bfloat16>(r, c, vec, stages);
    case 1: return panel_kernel_t<int8_t>(r, c, vec, stages);
    default: return nullptr;
  }
}

int launch_panels(int stages, const PanelArgs& a, int npanels, int smem_planned, int threads,
                  int device, void* stream) {
  const PanelKernel kernel = panel_kernel(a.vsize, a.r, a.c, a.vec, stages);
  const size_t smem = panel_smem(a, stages);
  const int lanes = a.vec > 0 ? a.tw / a.vec : 0;
  const long long grid = (long long)npanels * a.split * a.parts * a.ntiles;
  if (kernel == nullptr || a.nvec < 1 || a.pr < a.r || a.split < 1 || a.split > a.nchunks ||
      a.parts < 1 || a.prows < a.r || a.prows % a.r != 0 || (long long)a.parts * a.prows < a.pr ||
      (long long)(a.parts - 1) * a.prows >= a.pr ||
      a.q < 1 || a.nb < 1 || a.nb > a.q * a.cb || (a.q > 1 && a.nb != a.q * a.cb) ||
      (stages > 1 && a.nb != a.q * a.cb) || lanes < 1 || lanes > 32 ||
      lanes * a.vec != a.tw || (lanes & (lanes - 1)) != 0 || a.nvec % a.vec != 0 ||
      a.ntiles != (a.nvec + a.tw - 1) / a.tw || threads < 32 || threads > 512 ||
      (threads & (threads - 1)) != 0 || grid < 1 || grid > 0x7fffffffLL ||
      (long long)(a.prows + 1) * a.nb > 0x7fffffffLL || (a.vsize == 1 && a.scale == nullptr) ||
      smem != (size_t)smem_planned) {
    return (int)cudaErrorInvalidValue;
  }
  cudaError_t err = prepare_launch(kernel, device, smem, threads, nullptr);
  if (err != cudaSuccess) return (int)err;
  void* args[] = {const_cast<PanelArgs*>(&a)};
  err = cudaLaunchKernel(reinterpret_cast<const void*>(kernel), dim3((unsigned)grid),
                         dim3(threads), args, smem, (cudaStream_t)stream);
  return (int)(err != cudaSuccess ? err : cudaGetLastError());
}

PanelArgs panel_args(const int* vbase, const int* xbase, const signed char* valid,
                     const void* vidx, const void* xcol, const void* yrow, const void* values,
                     const float* scale, const float* x, float* y, int nchunks, int cb, int r,
                     int c, int vmax, int pr, int nrows, int xrows, int vsize, int nvalues,
                     int wv, int wx, int wy, int nvec, int tw, int vec, int parts, int prows,
                     int split, int q, int nb) {
  return PanelArgs{vbase,  xbase, valid, static_cast<const char*>(vidx),
                   static_cast<const char*>(xcol), static_cast<const char*>(yrow),
                   values, scale, x,     y,     nchunks, cb, r, c, vmax, pr, nrows, xrows, vsize,
                   wv,     wx,    wy,    nvec,  tw,    vec,   tw > 0 ? (nvec + tw - 1) / tw : 0,
                   parts,  prows, split, q,     nb,    nvalues};
}

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
  const PanelKernel kernel = panel_kernel(vsize, r, c, vec, stages);
  if (kernel == nullptr) return (int)cudaErrorInvalidValue;
  cudaError_t err = prepare_launch(kernel, device, (size_t)smem, threads, nullptr);
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(out, kernel, threads, (size_t)smem);
  }
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(out + 1, cudaDevAttrMultiProcessorCount, device);
  return (int)err;
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
