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
// Bound. The work is 2 flops per nonzero and column, and the bytes are the
// plan's (4 B per packed value, 16 B of metadata per block slot) plus X and
// Y once each: at small nvec the bytes bind, at nvec = 128 the f32 rate. In
// practice each nonzero also reads its columns of X through L1/L2, and what
// a nonzero costs in instructions decides. The Pallas kernels keep X
// resident (whole-vector) or stage an (xw, nvt) slab per chunk (panels); at
// the reference's pr = xw = 512 and nvt = 128 that is 786 KB per CTA
// against 227 KB, and a chunk of a sparse panel uses far fewer X rows than
// the xw it would stage, so both kernels read X in place through L1.
//
// Whole-vector kernel (spmm_whole_kernel): one CTA per (chunk, column tile
// of tw <= 32 columns), a warp cut into groups of tw lanes, lane l of a
// group owning column tile * tw + l; the chunk's value window and metadata
// are staged with plain loads and each group walks a contiguous run of its
// blocks, decoding each block's mask once (uniform control flow in the
// group) and applying each packed value to all tw columns. to_chunked
// walks blocks in row-interval order, so each (row, column) is summed in
// registers while the interval is unchanged and flushed with one global
// atomicAdd when it changes (into a zeroed Y); the f32 sum order varies
// from run to run.
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
// Each launcher runs on the caller's stream, allocates nothing, does not
// synchronise, and returns cudaGetLastError() (0 on success).

#include "spc5_spmm_panels.cuh"
#include "spc5_stage.cuh"

namespace {

constexpr int kThreads = 256;

__host__ __device__ __forceinline__ int round16(int n) { return (n + 15) & ~15; }

// Stage one chunk: its value window and its four metadata rows
// (col, mask, voff, row; cb words each).
template <bool kAsync>
__device__ __forceinline__ void stage_chunk(float* vwin, int* meta, const float* values, int vbase,
                                            const int* col, const uint32_t* mask, const int* voff,
                                            const int* row, size_t slot0, int cb, int vmax) {
  stage<kAsync>(vwin, values + vbase, vmax);
  stage_words<kAsync>(meta, col + slot0, cb);
  stage_words<kAsync>(meta + cb, reinterpret_cast<const int*>(mask) + slot0, cb);
  stage_words<kAsync>(meta + 2 * cb, voff + slot0, cb);
  stage_words<kAsync>(meta + 3 * cb, row + slot0, cb);
}

template <int R>
__device__ __forceinline__ void flush_rows(float* out, int ldo, int row, const float (&acc)[R],
                                           uint32_t touched, bool live) {
  if (!live) return;
#pragma unroll
  for (int lr = 0; lr < R; ++lr) {
    if ((touched >> lr) & 1u) atomicAdd(out + (size_t)(row + lr) * ldo, acc[lr]);
  }
}

// Walk blocks [b0, b1) of a staged chunk for one column: x points at the
// column in X's first row (the window's first row for panels), out at the
// column in Y's (or the Y tile's) first row. Rows of one interval are summed
// in acc and flushed when the interval changes; `touched` marks the rows
// with a set bit, so rows past nrows are never written.
template <int R>
__device__ __forceinline__ void walk_blocks(const int* meta, const float* vwin,
                                            const float* __restrict__ x, int ldx, int b0, int b1,
                                            int cb, int c, float* out, int ldo, bool live) {
  const int* s_col = meta;
  const uint32_t* s_mask = reinterpret_cast<const uint32_t*>(meta + cb);
  const int* s_voff = meta + 2 * cb;
  const int* s_row = meta + 3 * cb;
  // c <= 8 and R * c <= 32, so every shift below is in range
  const uint32_t row_mask = (1u << c) - 1u;
  float acc[R];
  int cur = 0;
  uint32_t touched = 0u;
  for (int b = b0; b < b1; ++b) {
    const uint32_t mask = s_mask[b];
    if (mask == 0u) continue;  // padding block
    const int row = s_row[b];
    if (touched == 0u || row != cur) {
      if (touched != 0u) flush_rows<R>(out, ldo, cur, acc, touched, live);
      cur = row;
      touched = 0u;
#pragma unroll
      for (int lr = 0; lr < R; ++lr) acc[lr] = 0.f;
    }
    const float* xb = x + (size_t)s_col[b] * ldx;
    int v = s_voff[b];
#pragma unroll
    for (int lr = 0; lr < R; ++lr) {
      uint32_t bits = (mask >> (lr * c)) & row_mask;
      if (bits == 0u) continue;
      touched |= 1u << lr;
      float a = acc[lr];
      do {
        const int lc = __ffs(bits) - 1;
        bits &= bits - 1u;
        a = fmaf(vwin[v++], __ldg(xb + (size_t)lc * ldx), a);
      } while (bits != 0u);
      acc[lr] = a;
    }
  }
  if (touched != 0u) flush_rows<R>(out, ldo, cur, acc, touched, live);
}

// ---------------------------------------------------------------------------
// whole-vector layout: one CTA per (chunk, column tile), global atomics
// ---------------------------------------------------------------------------
template <int R>
__global__ void __launch_bounds__(kThreads)
spmm_whole_kernel(const int* __restrict__ chunk_vbase, const int* __restrict__ chunk_col,
                  const uint32_t* __restrict__ chunk_mask, const int* __restrict__ chunk_voff,
                  const int* __restrict__ chunk_row, const float* __restrict__ values,
                  const float* __restrict__ x, float* __restrict__ y, int cb, int vmax, int c,
                  int nvec, int tw, int ntiles) {
  // layout: the value window (a multiple of 8 floats), then the metadata
  extern __shared__ __align__(16) float smem[];
  float* vwin = smem;
  int* meta = reinterpret_cast<int*>(smem + vmax);
  const int ch = blockIdx.x / ntiles;
  const int tile = blockIdx.x - ch * ntiles;
  stage_chunk<false>(vwin, meta, values, chunk_vbase[ch], chunk_col, chunk_mask, chunk_voff,
                     chunk_row, (size_t)ch * cb, cb, vmax);
  __syncthreads();
  const Lanes t = lanes_of(tw, tile, nvec, cb);
  walk_blocks<R>(meta, vwin, x + t.jc, nvec, t.b0, t.b1, cb, c, y + t.jc, nvec, t.live);
}

template <int R>
int launch_whole(const int* vbase, const int* col, const uint32_t* mask, const int* voff,
                 const int* row, const float* values, const float* x, float* y, int nchunks,
                 int cb, int vmax, int c, int nvec, int tw, int device, void* stream) {
  const size_t smem = ((size_t)vmax + 4 * (size_t)cb) * 4;
  cudaError_t err = prepare_launch(spmm_whole_kernel<R>, device, smem, kThreads, nullptr);
  if (err != cudaSuccess) return (int)err;
  const int ntiles = (nvec + tw - 1) / tw;
  spmm_whole_kernel<R><<<nchunks * ntiles, kThreads, smem, (cudaStream_t)stream>>>(
      vbase, col, mask, voff, row, values, x, y, cb, vmax, c, nvec, tw, ntiles);
  return (int)cudaGetLastError();
}

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
  const float* values;
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
};

// Byte offsets of the Y tile's end (the first stage starts there) and of one
// stage's parts, each 16-byte aligned: q value windows of vmax floats
// (vstride bytes apart), the q chunks' x window starts, the four metadata
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
  int tile, vstride, xbase, meta, meta_stride, bar, stage, keys, order;
};

__host__ __device__ inline PanelLayout panel_layout(const PanelArgs& a) {
  const int nb = a.q * a.cb;
  PanelLayout L;
  L.tile = round16(4 * a.prows * a.tw);
  L.vstride = round16(4 * a.vmax);
  L.xbase = a.q * L.vstride;
  L.meta = L.xbase + round16(4 * a.q);
  L.meta_stride = round16(4 * nb);
  L.bar = L.meta + 4 * L.meta_stride;
  L.stage = L.bar + 16;
  L.keys = round16(4 * nb);
  L.order = L.keys + 16 * a.q * a.vmax;
  return L;
}

inline size_t panel_smem(const PanelArgs& a, int stages) {
  const PanelLayout L = panel_layout(a);
  return (size_t)L.tile + (size_t)stages * L.stage + L.order;
}

// Start staging the qn chunks from global chunk g on into stage st: thread
// 0 zeroes the stage's counters, announces and issues the bulk copies of
// the chunks' value windows and, where `bulk`, of their four metadata rows
// (contiguous: the chunks are neighbours in one panel), all completing on
// the stage's mbarrier, so the mbarrier completes one phase per call;
// every thread issues its share of the other pieces (the metadata rows
// where not `bulk`, the x window starts) by cp.async.
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
    mbar_expect_tx(bar, 4 * a.vmax * qn + (bulk ? 4 * nbytes : 0));
    for (int i = 0; i < qn; ++i) {
      bulk_copy(st + L.vstride * i, a.values + __ldg(a.vbase + g + i), 4 * a.vmax, bar);
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
// (block row, block index), each nonzero (value bits, X offset col * nvec,
// block row, row; tile rows): the block's set lanes in the order their
// values are packed (lane k: the next value of the window, row + k / C,
// column + k % C), less those whose column lies at or past X's rows (which
// the reference reads as zero: nothing of X is read for them). Pass 1: each
// block of the part gets the key (row * nb + b) << 6 | its nonzeros,
// appended to a compact list by a warp ballot, and the nonzeros are
// counted; pass 2: each listed block finds where its nonzeros go by summing
// those of the keys below its own (the blocks before it in the order) and
// writes them. Returns the nonzeros listed. Barriers: one after each pass;
// the caller's next barrier frees the lists.
template <int C>
__device__ __forceinline__ int expand_stage(unsigned char* st, const PanelLayout& L,
                                            const PanelArgs& a, int nb, int row0,
                                            unsigned* keys, int4* nz) {
  constexpr int kColShift = C == 4 ? 2 : 3;
  const unsigned char* meta = st + L.meta;
  const int* s_col = reinterpret_cast<const int*>(meta);
  const uint32_t* s_mask = reinterpret_cast<const uint32_t*>(meta + L.meta_stride);
  const int* s_voff = reinterpret_cast<const int*>(meta + 2 * L.meta_stride);
  const int* s_row = reinterpret_cast<const int*>(meta + 3 * L.meta_stride);
  const int* s_xbase = reinterpret_cast<const int*>(st + L.xbase);
  const float* vwins = reinterpret_cast<const float*>(st);
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
    int vi = slot * (L.vstride >> 2) + s_voff[b];
    for (uint32_t bits = s_mask[b]; bits != 0u; bits &= bits - 1u, ++vi) {
      const int k = __ffs(bits) - 1;
      const int lc = k & (C - 1);
      if (lc < lim) {
        if (pos < cap) {
          nz[pos] = make_int4(__float_as_int(vwins[vi]), (xc + lc) * a.nvec, by,
                              by + (k >> kColShift));
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
template <int C, int V>
__device__ __forceinline__ void walk_stage(unsigned char* st, const PanelLayout& L,
                                           const PanelArgs& a, int nb, int row0, float* ytile,
                                           unsigned char* scratch, const float* xp, int jv,
                                           int lg) {
  unsigned* keys = reinterpret_cast<unsigned*>(scratch);
  int4* nz = reinterpret_cast<int4*>(scratch + L.keys);
  const int e = expand_stage<C>(st, L, a, nb, row0, keys, nz);
  const int2 range = row_range(nz, e, (int)(blockDim.x >> lg), (int)(threadIdx.x >> lg));
  walk_nonzeros<V>(nz, range.x, range.y, a, ytile, xp, jv);
}

template <int C, int V, int kStages>
__global__ void __launch_bounds__(512, 2) spmm_panels_kernel(const PanelArgs a) {
  extern __shared__ __align__(16) float psmem[];
  const PanelLayout L = panel_layout(a);
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
      fill_stage(ring, L, a, g0 + (size_t)k * a.q, qn, bulk);
      cp_async_commit();
      cp_async_wait<0>();
      mbar_wait(bar, k & 1);
      __syncthreads();  // everyone's copies
      walk_stage<C, V>(ring, L, a, qn * a.cb, row0, ytile, scratch, xp, jv, lg);
    }
  } else {
    // the ring: round k lives in stage k % 2, round k + 1 is in flight
    // while round k is walked
    fill_stage(ring, L, a, g0, round_chunks(0), bulk);  // n >= 1: split <= nchunks
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
        fill_stage(ring + (dec ^ 1) * L.stage, L, a, g0 + (size_t)(k + 1) * a.q,
                   round_chunks(k + 1), bulk);
      }
      cp_async_commit();
      walk_stage<C, V>(st, L, a, round_chunks(k) * a.cb, row0, ytile, scratch, xp, jv, lg);
    }
  }
  __syncthreads();
  write_tile<V>(ytile, a, p, h, tile, lg);
}

using PanelKernel = void (*)(PanelArgs);

template <int C, int V>
PanelKernel panel_kernel_v(int stages) {
  return stages == 1 ? spmm_panels_kernel<C, V, 1>
                     : stages == 2 ? spmm_panels_kernel<C, V, 2> : nullptr;
}

template <int C>
PanelKernel panel_kernel_c(int vec, int stages) {
  switch (vec) {
    case 1: return panel_kernel_v<C, 1>(stages);
    case 2: return panel_kernel_v<C, 2>(stages);
    case 4: return panel_kernel_v<C, 4>(stages);
    default: return nullptr;
  }
}

// The panel kernel for block width c (4 or 8; the kernel walks a block's
// set lanes whatever its height), vec columns a lane and a ring of
// `stages` (1: the synchronous kernel); nullptr for any other.
PanelKernel panel_kernel(int c, int vec, int stages) {
  switch (c) {
    case 4: return panel_kernel_c<4>(vec, stages);
    case 8: return panel_kernel_c<8>(vec, stages);
    default: return nullptr;
  }
}

int launch_panels(int stages, const PanelArgs& a, int npanels, int smem_planned, int threads,
                  int device, void* stream) {
  const PanelKernel kernel = panel_kernel(a.c, a.vec, stages);
  const size_t smem = panel_smem(a, stages);
  const int lanes = a.vec > 0 ? a.tw / a.vec : 0;
  const long long grid = (long long)npanels * a.split * a.parts * a.ntiles;
  const long long nb = (long long)a.q * a.cb;
  if (kernel == nullptr || (a.r != 1 && a.r != 2 && a.r != 4 && a.r != 8) || a.r * a.c > 32 ||
      a.nvec < 1 || a.cb < 1 || a.vmax < 4 || a.vmax % 4 != 0 || a.pr < a.r ||
      a.split < 1 || a.split > a.nchunks || a.parts < 1 || a.prows < a.r ||
      a.prows % a.r != 0 || (long long)a.parts * a.prows < a.pr ||
      (long long)(a.parts - 1) * a.prows >= a.pr || a.q < 1 || lanes < 1 || lanes > 32 ||
      lanes * a.vec != a.tw || (lanes & (lanes - 1)) != 0 || a.nvec % a.vec != 0 ||
      a.ntiles != (a.nvec + a.tw - 1) / a.tw || threads < 32 || threads > 512 ||
      (threads & (threads - 1)) != 0 || grid < 1 || grid > 0x7fffffffLL ||
      (a.prows + 1) * nb > (1LL << 26) || smem != (size_t)smem_planned) {
    return (int)cudaErrorInvalidValue;
  }
  cudaError_t err = prepare_launch(kernel, device, smem, threads, nullptr);
  if (err != cudaSuccess) return (int)err;
  void* args[] = {const_cast<PanelArgs*>(&a)};
  err = cudaLaunchKernel(reinterpret_cast<const void*>(kernel), dim3((unsigned)grid),
                         dim3(threads), args, smem, (cudaStream_t)stream);
  return (int)(err != cudaSuccess ? err : cudaGetLastError());
}

int panels_entry(int stages, const int* vbase, const int* xbase, const int* col,
                 const uint32_t* mask, const int* voff, const int* row, const float* values,
                 const float* x, float* y, int npanels, int nchunks, int cb, int vmax, int pr,
                 int nrows, int xrows, int r, int c, int nvec, int tw, int vec, int parts,
                 int prows, int split, int q, int smem, int threads, int device, void* stream) {
  const PanelArgs a{vbase, xbase, col,   mask,  voff,  row,   values, x,     y,
                    nchunks, cb, r, c, vmax, pr, nrows, xrows, nvec, tw, vec,
                    tw > 0 ? (nvec + tw - 1) / tw : 0, parts, prows, split, q};
  return launch_panels(stages, a, npanels, smem, threads, device, stream);
}

}  // namespace

extern "C" {

int spc5_spmm_whole(const int* vbase, const int* col, const uint32_t* mask, const int* voff,
                    const int* row, const float* values, const float* x, float* y, int nchunks,
                    int cb, int vmax, int r, int c, int nvec, int tw, int device, void* stream) {
#define SPC5_WHOLE(R) \
  launch_whole<R>(vbase, col, mask, voff, row, values, x, y, nchunks, cb, vmax, c, nvec, tw, \
                  device, stream)
  switch (r) {
    case 1: return SPC5_WHOLE(1);
    case 2: return SPC5_WHOLE(2);
    case 4: return SPC5_WHOLE(4);
    case 8: return SPC5_WHOLE(8);
    default: return (int)cudaErrorInvalidValue;
  }
#undef SPC5_WHOLE
}

// The synchronous panel kernel: S = split CTAs per (panel, row part, column
// tile), each a contiguous range of the panel's chunks, q chunks a stage,
// copied and waited for before the walk; `parts` row parts of prows rows,
// tw columns a tile, vec columns a lane (4 or 2 need nvec a multiple of it
// and X so aligned), `threads` a power of two in [32, 512]; X is (xrows,
// nvec), read in place. smem is the wrapper's figure for the CTA's dynamic
// shared memory (checked).
int spc5_spmm_panels_s1(const int* vbase, const int* xbase, const int* col, const uint32_t* mask,
                        const int* voff, const int* row, const float* values, const float* x,
                        float* y, int npanels, int nchunks, int cb, int vmax, int pr, int nrows,
                        int xrows, int r, int c, int nvec, int tw, int vec, int parts, int prows,
                        int split, int q, int smem, int threads, int device, void* stream) {
  return panels_entry(1, vbase, xbase, col, mask, voff, row, values, x, y, npanels, nchunks, cb,
                      vmax, pr, nrows, xrows, r, c, nvec, tw, vec, parts, prows, split, q, smem,
                      threads, device, stream);
}

// The staged-ahead panel kernel: a ring of two stages of q chunks, one
// round ahead of the walk.
int spc5_spmm_panels_s2(const int* vbase, const int* xbase, const int* col, const uint32_t* mask,
                        const int* voff, const int* row, const float* values, const float* x,
                        float* y, int npanels, int nchunks, int cb, int vmax, int pr, int nrows,
                        int xrows, int r, int c, int nvec, int tw, int vec, int parts, int prows,
                        int split, int q, int smem, int threads, int device, void* stream) {
  return panels_entry(2, vbase, xbase, col, mask, voff, row, values, x, y, npanels, nchunks, cb,
                      vmax, pr, nrows, xrows, r, c, nvec, tw, vec, parts, prows, split, q, smem,
                      threads, device, stream);
}

// The panel kernel's occupancy at `stages` (1: the synchronous kernel, 2:
// the ring), block width c, vec columns a lane, `threads` and `smem` bytes
// of dynamic shared memory per CTA: out[0] the CTAs one SM holds at once,
// out[1] the SMs of the device.
int spc5_spmm_panels_occupancy(int stages, int c, int vec, int threads, int smem, int device,
                               int* out) {
  const PanelKernel kernel = panel_kernel(c, vec, stages);
  if (kernel == nullptr) return (int)cudaErrorInvalidValue;
  cudaError_t err = prepare_launch(kernel, device, (size_t)smem, threads, nullptr);
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(out, kernel, threads, (size_t)smem);
  }
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(out + 1, cudaDevAttrMultiProcessorCount, device);
  return (int)err;
}

// The dynamic shared memory of one panel CTA with `stages` stages of q
// chunks of cb blocks and a (prows, tw) Y tile, as the launch computes it
// (panel_layout).
int spc5_spmm_panels_smem(int stages, int q, int cb, int vmax, int prows, int tw) {
  PanelArgs a{};
  a.q = q;
  a.cb = cb;
  a.vmax = vmax;
  a.prows = prows;
  a.tw = tw;
  return (int)panel_smem(a, stages);
}

}  // extern "C"
