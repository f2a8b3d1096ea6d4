// SPC5 descriptor SpMV for Hopper (sm_90a): the bit-mask decode of the mask
// kernels (spc5_spmv.cu) expanded once at build time into per-lane gather
// tables (repro_torch/core/formats.py: chunk_descriptors), over the two
// chunked layouts.
//
// Replaces the four Pallas TPU kernels of src/repro/kernels/spc5_spmv.py:
//   spc5_spmv_desc_whole_s1   <- spmv_pallas_desc           (_spmv_desc_kernel)
//   spc5_spmv_desc_whole_s2   <- spmv_pallas_desc_db        (_spmv_desc_db_kernel)
//   spc5_spmv_desc_panels_s1  <- spmv_pallas_panels_desc    (_spmv_panel_desc_kernel)
//   spc5_spmv_desc_panels_s2  <- spmv_pallas_panels_desc_db (_spmv_panel_desc_db_kernel)
// All four compute what _desc_contrib computes: per block lane, if the lane
// is valid, value window[vidx] times x[xcol], added into y[yrow].
//
// Bound: memory. Each block lane (r*c per block, set or not) carries one int8
// valid byte and three index entries, each int8, int16 or int32 as the
// build narrowed it (1 + 3..12 bytes a lane), so the tables outweigh the
// mask kernels' 16 bytes a block r*c-fold over; the packed values (4 B per
// nonzero), x and y are read or written once. Two flops per nonzero.
//
// Whole-vector kernels (spmv_desc_whole_kernel), built for latency, not for
// the TPU's sequential grid:
//   * contiguous chunk ranges: the launch's G CTAs (the wrapper picks G from
//     the card's occupancy with the panel kernels' split rule) each take a
//     contiguous range of the nchunks chunks, so neighbouring chunks, which
//     share rows (to_chunked cuts every cb blocks whatever the row), meet in
//     one CTA;
//   * staged tables: a stage holds the chunk's value window, its valid and
//     vidx runs, the c xcol entries of each block's first row, each block's
//     lane-0 yrow word and the stage's mbarrier. One thread issues the value
//     window and, where 16-byte aligned (cb * r * c % 16 == 0), the valid and
//     vidx runs as bulk copies completing on the mbarrier; every thread
//     issues its share of the rest as 4- or 16-byte cp.async pieces. kStages
//     == 2 keeps a ring of two stages, one chunk ahead of the decode, with
//     one barrier per chunk; kStages == 1 is the synchronous twin: one
//     stage, copied and waited for before each decode (cut into slices of
//     blocks, the value window staged with the first, when a whole chunk's
//     stage does not fit one CTA). No table is read from device memory in
//     the decode; x is read in place through L1;
//   * only what differs is read: xcol[k] == xcol[k % c], and on valid lanes
//     yrow[k] == yrow[0] + k / c (lanes past nrows or ncols are clipped, and
//     invalid, in this layout; pinned by tests/test_torch_desc_whole.py);
//   * decode from shared memory, four lanes a thread, as in the panel
//     kernels below (decode_whole); the wrapper gives a CTA a thread for
//     every two lane quads of a stage, 64 to 512 (one quad a thread was
//     up to 1.7x slower on the H100, at most 256 threads up to 1.14x);
//   * row sums in registers: a thread keeps the same lane quad of every
//     (threads / quads-a-block)-th block, so the same row of blocks that
//     mostly share a block row (to_chunked keeps a block row's blocks
//     together), and sums a run of equal rows before adding it once. A
//     shared-memory float atomicAdd is a compare-and-swap loop on this card
//     (ATOMS.CAST.SPIN), which a chunk's hundreds of adds into 4-8 rows
//     kept retrying;
//   * a y tile: a CTA adds its row sums into `tile` rows of shared memory
//     based at the first row of a chunk, and adds each nonzero tile row
//     into a zeroed y with one global atomicAdd when the next chunk's first
//     row leaves the tile's first half (and at the end). A row outside the
//     tile (a chunk spanning more rows, or rows out of order, as a permuted
//     plan brings) is added into y directly, so any yrow in [0, nrows) is
//     right; the f32 sum order varies from run to run.
//
// Panel kernels (spmv_desc_panels_kernel), built for latency, not for the
// TPU's sequential grid:
//   * split grid: each panel's chunk list is cut into S contiguous ranges,
//     one CTA each (grid npanels * S; the wrapper picks S from the card's
//     occupancy). A CTA sums its range into a (pr,) y tile in shared memory
//     and adds the tile's nonzero rows into a zeroed y with one global
//     atomicAdd per row (plain stores when S == 1);
//   * staged tables: a stage holds a chunk's valid and vidx runs, the c xcol
//     entries of each block's first row, each block's lane-0 yrow entry,
//     the value window and the x window, all copied in 16-byte pieces where
//     alignment allows (4-byte ones otherwise). kStages >= 2 keeps a ring of
//     stages filled by cp.async, kStages - 1 chunks ahead of the decode, with
//     one barrier per chunk; no table is read from device memory in the
//     decode. kStages == 1 is the synchronous twin: the same stage loaded
//     with 16-byte vector loads before each decode (cut into slices of
//     blocks when a whole chunk's tables do not fit one CTA);
//   * only what differs is read: chunk_descriptors repeats each block's
//     columns over its rows (xcol[k] == xcol[k % c]) and, in the panel
//     layout, where nothing is clipped, its rows over its columns (yrow[k] ==
//     yrow[0] + k / c), so c xcol entries and one yrow entry per block carry
//     everything (held by tests/test_torch_desc_panels.py);
//   * decode from shared memory, four lanes a thread: lanes 4q .. 4q + 3 lie
//     in one block row (c is 4 or 8), so a 4-byte word holds their valid
//     flags and one 4- to 16-byte load each their vidx and xcol entries; a
//     quad with no flag set (most of them: a block holds Avg of its r*c
//     lanes) gathers nothing. A row's two quads (c = 8) are summed with one
//     xor shuffle and the row adds once into the tile with a shared-memory
//     atomic.
//
// Each launcher runs on the caller's stream, allocates nothing, does not
// synchronise, and returns cudaGetLastError() (0 on success).

#include "spc5_stage.cuh"

namespace {

__host__ __device__ inline int round16(int n) { return (n + 15) & ~15; }

// Entries 4q .. 4q + 3 of a narrow index table in shared memory, with one
// 4-, 8- or 16-byte load (the table starts 16-byte aligned).
__device__ __forceinline__ void smem_index4(const unsigned char* t, int q, int width,
                                            int out[4]) {
  if (width == 1) {
    const int w = reinterpret_cast<const int*>(t)[q];
    out[0] = (int)(signed char)w;
    out[1] = (int)(signed char)(w >> 8);
    out[2] = (int)(signed char)(w >> 16);
    out[3] = w >> 24;
  } else if (width == 2) {
    const int2 w = reinterpret_cast<const int2*>(t)[q];
    out[0] = (int)(short)w.x;
    out[1] = w.x >> 16;
    out[2] = (int)(short)w.y;
    out[3] = w.y >> 16;
  } else {
    const int4 w = reinterpret_cast<const int4*>(t)[q];
    out[0] = w.x;
    out[1] = w.y;
    out[2] = w.z;
    out[3] = w.w;
  }
}

// The entry of width 1, 2 or 4 bytes at the low end of 4-byte word w.
__device__ __forceinline__ int low_entry(int w, int width) {
  return width == 1 ? (int)(signed char)w : width == 2 ? (int)(short)w : w;
}

// ---------------------------------------------------------------------------
// whole-vector layout: contiguous chunk ranges, staged tables, a y tile
// ---------------------------------------------------------------------------

struct WholeArgs {
  const int* vbase;  // (nchunks,) value window starts
  const signed char* valid;
  const char* vidx;  // the index tables, as bytes (entries wv, wx, wy wide)
  const char* xcol;
  const char* yrow;
  const float* values;
  const float* x;
  float* y;
  int nchunks, cb, r, c, vmax, wv, wx, wy;
  int grid;  // G: CTAs, each a contiguous range of the chunks
  int nb;    // blocks whose tables one stage holds (cb, or a slice of it)
  int tile;  // rows of the y tile
};

// Byte offsets of one stage's parts, each 16-byte aligned: the value window,
// then for nb blocks the valid and vidx runs, the c xcol entries of each
// block's first row, each block's lane-0 yrow entry in a 4-byte slot, and a
// 16-byte slot for the stage's mbarrier. The y tile (tile floats) comes
// before the first stage. The wrapper plans with its copy (kernels/
// spc5_spmv_desc.py: whole_smem_bytes) and passes its figure in; a launch
// whose figure differs is refused, and spc5_spmv_desc_whole_smem exposes
// this one for the wrapper's tests.
struct WholeLayout {
  int vwin, valid, vidx, xcol, yrow, bar, bytes;
};

__host__ __device__ inline WholeLayout whole_layout(const WholeArgs& a) {
  const int rc = a.r * a.c;
  WholeLayout L;
  L.vwin = 0;
  L.valid = round16(4 * a.vmax);
  L.vidx = L.valid + round16(a.nb * rc);
  L.xcol = L.vidx + round16(a.nb * rc * a.wv);
  L.yrow = L.xcol + round16(a.nb * a.c * a.wx);
  L.bar = L.yrow + round16(4 * a.nb);
  L.bytes = L.bar + 16;
  return L;
}

inline size_t whole_smem(const WholeArgs& a, int stages) {
  return (size_t)round16(4 * a.tile) + (size_t)stages * whole_layout(a).bytes;
}

// Start staging blocks [b0, b0 + nb) of chunk g into stage st (and, where
// `window`, the chunk's value window, which starts at vb): thread 0
// announces and issues the bulk copies (the window; the valid and vidx runs
// where `bulk`), all completing on the stage's mbarrier, so the mbarrier
// completes one phase per call; every thread issues its share of the other
// pieces by cp.async.
__device__ __forceinline__ void fill_stage(unsigned char* st, const WholeLayout& L,
                                           const WholeArgs& a, size_t g, int b0, int nb,
                                           bool window, int vb, bool bulk) {
  const int rc = a.r * a.c;
  const size_t lane0 = (g * a.cb + b0) * rc;
  const char* valid = reinterpret_cast<const char*>(a.valid) + lane0;
  const char* vidx = a.vidx + lane0 * a.wv;
  const int nvalid = nb * rc, nvidx = nb * rc * a.wv;
  if (threadIdx.x == 0) {
    uint64_t* bar = reinterpret_cast<uint64_t*>(st + L.bar);
    mbar_expect_tx(bar, (window ? 4 * a.vmax : 0) + (bulk ? nvalid + nvidx : 0));
    if (window) bulk_copy(st + L.vwin, a.values + vb, 4 * a.vmax, bar);
    if (bulk) {
      bulk_copy(st + L.valid, valid, nvalid, bar);
      bulk_copy(st + L.vidx, vidx, nvidx, bar);
    }
  }
  if (!bulk) {
    copy_runs<true>(st + L.valid, valid, 1, nvalid, 0);
    copy_runs<true>(st + L.vidx, vidx, 1, nvidx, 0);
  }
  // xcol[k] == xcol[k % c]: the c entries of each block's first row
  copy_runs<true>(st + L.xcol, a.xcol + lane0 * a.wx, nb, a.c * a.wx, rc * a.wx);
  // yrow[k] == yrow[0] + k / c on valid lanes: the 4-byte word holding each
  // block's lane-0 entry (r*c >= 4, so the word is aligned and inside the
  // block's entries)
  copy_runs<true>(st + L.yrow, a.yrow + lane0 * a.wy, nb, 4, rc * a.wy);
}

// A thread's pending row sum ("row sums in registers" above), added once
// into the y tile where the row lies in [tbase, tbase + tile), else
// straight into y.
struct RowSum {
  int row = -1;
  float sum = 0.f;
};

__device__ __forceinline__ void add_row(const WholeArgs& a, float* ytile, int tbase, int row,
                                        float v) {
  const unsigned t = (unsigned)(row - tbase);
  if (t < (unsigned)a.tile) {
    atomicAdd(ytile + t, v);
  } else {
    atomicAdd(a.y + row, v);
  }
}

__device__ __forceinline__ void flush_row(const WholeArgs& a, float* ytile, int tbase,
                                          RowSum& rs) {
  if (rs.sum != 0.f) add_row(a, ytile, tbase, rs.row, rs.sum);
  rs.sum = 0.f;
}

// Add the nb staged blocks into the threads' row sums, four lanes a thread
// as decode_stage below does (one 4-byte word of valid flags, one load each
// of vidx and xcol, nothing gathered for a quad with no flag set, one xor
// shuffle joining a row's two quads for c = 8), x read in place through
// L1. Thread t keeps quad t % (r*c/4) of every (blockDim / (r*c/4))-th
// block: the same row of each, and a warp reads neighbouring words.
__device__ __forceinline__ void decode_whole(const unsigned char* st, const WholeLayout& L,
                                             const WholeArgs& a, int nb, int lrc, int lc,
                                             float* ytile, int tbase, RowSum& rs) {
  const float* vwin = reinterpret_cast<const float*>(st + L.vwin);
  const int* flags4 = reinterpret_cast<const int*>(st + L.valid);
  const int* yword = reinterpret_cast<const int*>(st + L.yrow);
  const int c = 1 << lc;
  const int lq = lrc - 2;                  // log2 of the quads a block
  const int p = threadIdx.x & ((1 << lq) - 1);
  const int k = p << 2;                    // the quad's first lane
  const int lanes = blockDim.x >> lq;      // threads on the same quad
  const bool leader = (k & (c - 1)) == 0;  // the row's first quad
  const int steps = (nb + lanes - 1) / lanes;  // the same for every thread
  for (int i = 0, b = threadIdx.x >> lq; i < steps; ++i, b += lanes) {
    const bool live = b < nb;  // whole rows: quads per row (1 or 2) divide 32
    const int q = (b << lq) + p;
    const int flags = live ? flags4[q] : 0;
    float v = 0.f;
    if (flags) {
      int vi[4], xc[4];
      smem_index4(st + L.vidx, q, a.wv, vi);
      smem_index4(st + L.xcol, ((b << lc) + (k & (c - 1))) >> 2, a.wx, xc);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        if ((flags >> (8 * u)) & 0xff) v += vwin[vi[u]] * __ldg(a.x + xc[u]);
      }
    }
    if (c == 8) v += __shfl_xor_sync(0xffffffffu, v, 1);
    if (leader && live && v != 0.f) {
      const int row = low_entry(yword[b], a.wy) + (k >> lc);
      if (row != rs.row) {
        flush_row(a, ytile, tbase, rs);
        rs.row = row;
      }
      rs.sum += v;
    }
  }
}

// Add the tile's nonzero rows into y (rows tbase, tbase + 1, ...) and, where
// `clear`, zero the tile. Each thread reads and clears its own rows.
__device__ __forceinline__ void flush_tile(float* ytile, const WholeArgs& a, int tbase,
                                           bool clear) {
  for (int i = threadIdx.x; i < a.tile; i += blockDim.x) {
    const float t = ytile[i];
    if (t != 0.f) {
      atomicAdd(a.y + tbase + i, t);
      if (clear) ytile[i] = 0.f;
    }
  }
}

// At the start of chunk j of a CTA's range, once its first stage has landed
// (st) and the previous chunk is decoded: the first chunk bases the tile at
// its first row; a later one whose first row leaves the tile's first half
// flushes the tile and bases it there. Uniform over the CTA.
__device__ __forceinline__ void move_tile(const unsigned char* st, const WholeLayout& L,
                                          const WholeArgs& a, int j, float* ytile, int& tbase) {
  const int r0 = low_entry(*reinterpret_cast<const int*>(st + L.yrow), a.wy);
  if (j == 0) {
    tbase = r0;
  } else if ((unsigned)(r0 - tbase) >= (unsigned)((a.tile + 1) >> 1)) {
    flush_tile(ytile, a, tbase, true);
    tbase = r0;
    __syncthreads();  // the tile is clear before the decode adds into it
  }
}

template <int kStages>
__global__ void __launch_bounds__(512) spmv_desc_whole_kernel(const WholeArgs a) {
  extern __shared__ __align__(16) float smem[];  // one name and type per file
  const WholeLayout L = whole_layout(a);
  float* ytile = smem;
  unsigned char* ring = reinterpret_cast<unsigned char*>(smem) + round16(4 * a.tile);
  const int rc = a.r * a.c;
  const int lrc = __ffs(rc) - 1, lc = __ffs(a.c) - 1;
  const bool bulk = ((reinterpret_cast<uintptr_t>(a.valid) | reinterpret_cast<uintptr_t>(a.vidx) |
                      (uintptr_t)(a.cb * rc) | (uintptr_t)(a.nb * rc)) & 15) == 0;
  const int c0 = (int)((long long)blockIdx.x * a.nchunks / a.grid);
  const int n = (int)((long long)(blockIdx.x + 1) * a.nchunks / a.grid) - c0;
  const int* vbase = a.vbase + c0;
  for (int i = threadIdx.x; i < a.tile; i += blockDim.x) ytile[i] = 0.f;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) mbar_init(reinterpret_cast<uint64_t*>(ring + s * L.bytes + L.bar));
    mbar_fence_init();
  }
  __syncthreads();  // the barriers are initialised and the tile zeroed
  int tbase = 0;
  RowSum rs;

  if constexpr (kStages == 1) {
    uint64_t* bar = reinterpret_cast<uint64_t*>(ring + L.bar);
    uint32_t phase = 0;
    // the window start of the next chunk, loaded a chunk ahead (thread 0
    // issues the copies)
    int vb = threadIdx.x == 0 && n > 0 ? __ldg(vbase) : 0;
    for (int j = 0; j < n; ++j) {
      const int vj = vb;
      if (threadIdx.x == 0 && j + 1 < n) vb = __ldg(vbase + j + 1);
      for (int b0 = 0; b0 < a.cb; b0 += a.nb) {
        const int nb = min(a.nb, a.cb - b0);
        if (j > 0 || b0 > 0) __syncthreads();  // the previous decode is done
        fill_stage(ring, L, a, (size_t)c0 + j, b0, nb, b0 == 0, vj, bulk);
        cp_async_commit();
        cp_async_wait<0>();
        mbar_wait(bar, phase & 1u);
        ++phase;
        __syncthreads();  // everyone's copies
        if (b0 == 0) move_tile(ring, L, a, j, ytile, tbase);
        decode_whole(ring, L, a, nb, lrc, lc, ytile, tbase, rs);
      }
    }
  } else {
    // the ring: chunk j lives in stage j % kStages; kStages - 1 chunks are
    // in flight while one decodes
    for (int s = 0; s < kStages - 1; ++s) {
      if (s < n) {
        fill_stage(ring + s * L.bytes, L, a, (size_t)c0 + s, 0, a.cb, true,
                   threadIdx.x == 0 ? __ldg(vbase + s) : 0, bulk);
      }
      cp_async_commit();
    }
    int vb = threadIdx.x == 0 && kStages - 1 < n ? __ldg(vbase + kStages - 1) : 0;
    int dec = 0, fill = kStages - 1;  // the stages of chunks j and j + kStages - 1
    uint32_t parity = 0;              // bit s: the parity of stage s's next phase
    for (int j = 0; j < n; ++j) {
      unsigned char* st = ring + dec * L.bytes;
      cp_async_wait<kStages - 2>();  // chunk j's cp.async pieces of this thread
      mbar_wait(reinterpret_cast<uint64_t*>(st + L.bar), (parity >> dec) & 1u);
      parity ^= 1u << dec;
      __syncthreads();  // ... everyone's; chunk j - 1's stage is free
      move_tile(st, L, a, j, ytile, tbase);
      const int jn = j + kStages - 1;
      if (jn < n) fill_stage(ring + fill * L.bytes, L, a, (size_t)c0 + jn, 0, a.cb, true, vb, bulk);
      cp_async_commit();  // possibly empty: keeps the group count uniform
      if (threadIdx.x == 0 && jn + 1 < n) vb = __ldg(vbase + jn + 1);
      decode_whole(st, L, a, a.cb, lrc, lc, ytile, tbase, rs);
      dec = dec + 1 == kStages ? 0 : dec + 1;
      fill = fill + 1 == kStages ? 0 : fill + 1;
    }
  }
  flush_row(a, ytile, tbase, rs);
  __syncthreads();
  flush_tile(ytile, a, tbase, false);
}

// ---------------------------------------------------------------------------
// panel layout: S CTAs per panel, staged tables, (pr,) y tile per CTA
// ---------------------------------------------------------------------------

struct PanelArgs {
  const int* vbase;  // (npanels, nchunks) value window starts
  const int* xbase;  // (npanels, nchunks) x window starts
  const signed char* valid;
  const char* vidx;  // the index tables, as bytes (entries wv, wx, wy wide)
  const char* xcol;
  const char* yrow;
  const float* values;
  const float* xpad;
  float* y;
  int nchunks, cb, r, c, vmax, xw, pr, nrows, wv, wx, wy;
  int split;  // S: CTAs per panel, each a contiguous range of its chunks
  int nb;     // blocks whose tables one stage holds (cb, or a slice of it)
};

// Byte offsets of one stage's parts, each 16-byte aligned: the value window,
// the x window, then for nb blocks the valid and vidx runs, the c xcol
// entries of each block's first row and each block's lane-0 yrow entry in a
// 4-byte slot. The y tile (pr floats) comes before the first stage. The
// wrapper plans with its copy (kernels/spc5_spmv_desc.py: panels_smem_bytes)
// and passes its figure in; a launch whose figure differs is refused, and
// spc5_spmv_desc_panels_smem exposes this one for the wrapper's tests.
struct StageLayout {
  int vwin, xwin, valid, vidx, xcol, yrow, bytes;
};

__host__ __device__ inline StageLayout stage_layout(const PanelArgs& a) {
  const int rc = a.r * a.c;
  StageLayout L;
  L.vwin = 0;
  L.xwin = L.vwin + round16(4 * a.vmax);
  L.valid = L.xwin + round16(4 * a.xw);
  L.vidx = L.valid + round16(a.nb * rc);
  L.xcol = L.vidx + round16(a.nb * rc * a.wv);
  L.yrow = L.xcol + round16(a.nb * a.c * a.wx);
  L.bytes = L.yrow + round16(4 * a.nb);
  return L;
}

inline size_t panels_smem(const PanelArgs& a, int stages) {
  return (size_t)round16(4 * a.pr) + (size_t)stages * stage_layout(a).bytes;
}

// Stage the tables of blocks [b0, b0 + nb) of global chunk g (and, where
// windows is set, its value window at vb and its x window at xb).
template <bool kAsync>
__device__ __forceinline__ void stage_chunk(unsigned char* st, const StageLayout& L,
                                            const PanelArgs& a, size_t g, int b0, int nb,
                                            bool windows, int vb, int xb) {
  const int rc = a.r * a.c;
  const size_t lane0 = (g * a.cb + b0) * rc;
  if (windows) {
    copy_runs<kAsync>(st + L.vwin, reinterpret_cast<const char*>(a.values + vb), 1, 4 * a.vmax, 0);
    copy_runs<kAsync>(st + L.xwin, reinterpret_cast<const char*>(a.xpad + xb), 1, 4 * a.xw, 0);
  }
  copy_runs<kAsync>(st + L.valid, reinterpret_cast<const char*>(a.valid) + lane0, 1, nb * rc, 0);
  copy_runs<kAsync>(st + L.vidx, a.vidx + lane0 * a.wv, 1, nb * rc * a.wv, 0);
  // xcol[k] == xcol[k % c]: the c entries of each block's first row
  copy_runs<kAsync>(st + L.xcol, a.xcol + lane0 * a.wx, nb, a.c * a.wx, rc * a.wx);
  // yrow[k] == yrow[0] + k / c: the 4-byte word holding each block's lane-0
  // entry (r*c >= 4, so the word is aligned and inside the block's entries)
  copy_runs<kAsync>(st + L.yrow, a.yrow + lane0 * a.wy, nb, 4, rc * a.wy);
}

// Add the nb staged blocks into the y tile. Thread t takes lane quads t,
// t + blockDim, ...: lanes 4q .. 4q + 3, which lie in one block row (c is 4
// or 8), so one 4-byte word holds their valid flags and one load each their
// vidx and xcol entries; a quad with no flag set gathers nothing. For c = 8
// the two quads of a row (neighbouring threads) are summed with one xor
// shuffle; the row's first quad adds it into the tile.
__device__ __forceinline__ void decode_stage(const unsigned char* st, const StageLayout& L,
                                             const PanelArgs& a, int nb, int lrc, int lc,
                                             float* ytile) {
  const float* vwin = reinterpret_cast<const float*>(st + L.vwin);
  const float* xwin = reinterpret_cast<const float*>(st + L.xwin);
  const int* flags4 = reinterpret_cast<const int*>(st + L.valid);
  const int* yword = reinterpret_cast<const int*>(st + L.yrow);
  const int rc = 1 << lrc, c = 1 << lc;
  const int quads = (nb << lrc) >> 2;
  for (int q0 = 0; q0 < quads; q0 += blockDim.x) {
    const int q = q0 + threadIdx.x;
    const bool live = q < quads;  // whole rows: quads per row (1 or 2) divide 32
    const int b = (q << 2) >> lrc, k = (q << 2) & (rc - 1);
    const int flags = live ? flags4[q] : 0;
    float v = 0.f;
    if (flags) {
      int vi[4], xc[4];
      smem_index4(st + L.vidx, q, a.wv, vi);
      smem_index4(st + L.xcol, ((b << lc) + (k & (c - 1))) >> 2, a.wx, xc);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        if ((flags >> (8 * u)) & 0xff) v += vwin[vi[u]] * xwin[xc[u]];
      }
    }
    if (c == 8) v += __shfl_xor_sync(0xffffffffu, v, 1);
    if (live && (k & (c - 1)) == 0 && v != 0.f) {
      const int w = yword[b];
      const int row = a.wy == 1 ? (int)(signed char)w : a.wy == 2 ? (int)(short)w : w;
      atomicAdd(ytile + row + (k >> lc), v);
    }
  }
}

template <int kStages>
__global__ void __launch_bounds__(256) spmv_desc_panels_kernel(const PanelArgs a) {
  extern __shared__ __align__(16) float smem[];  // one name and type per file
  const StageLayout L = stage_layout(a);
  float* ytile = smem;
  unsigned char* ring = reinterpret_cast<unsigned char*>(smem) + round16(4 * a.pr);
  const int lrc = __ffs(a.r * a.c) - 1, lc = __ffs(a.c) - 1;
  const int p = blockIdx.x / a.split;
  const int part = blockIdx.x - p * a.split;
  const int c0 = (int)((long long)part * a.nchunks / a.split);
  const int n = (int)((long long)(part + 1) * a.nchunks / a.split) - c0;
  const size_t g0 = (size_t)p * a.nchunks + c0;  // global index of the range's first chunk
  const int* vbase = a.vbase + g0;
  const int* xbase = a.xbase + g0;
  for (int i = threadIdx.x; i < a.pr; i += blockDim.x) ytile[i] = 0.f;

  if constexpr (kStages == 1) {
    int vb = n > 0 ? __ldg(vbase) : 0, xb = n > 0 ? __ldg(xbase) : 0;
    for (int j = 0; j < n; ++j) {
      const int vj = vb, xj = xb;
      if (j + 1 < n) {  // the next chunk's window starts, in flight during this one
        vb = __ldg(vbase + j + 1);
        xb = __ldg(xbase + j + 1);
      }
      for (int b0 = 0; b0 < a.cb; b0 += a.nb) {
        const int nb = min(a.nb, a.cb - b0);
        __syncthreads();  // the previous decode (or the tile's zeroing) is done
        stage_chunk<false>(ring, L, a, g0 + j, b0, nb, b0 == 0, vj, xj);
        __syncthreads();
        decode_stage(ring, L, a, nb, lrc, lc, ytile);
      }
    }
  } else {
    // the ring: chunk j lives in stage j % kStages; kStages - 1 chunks are
    // in flight while one decodes
    for (int s = 0; s < kStages - 1; ++s) {
      if (s < n) {
        stage_chunk<true>(ring + s * L.bytes, L, a, g0 + s, 0, a.cb, true, __ldg(vbase + s),
                          __ldg(xbase + s));
      }
      cp_async_commit();
    }
    int vb = 0, xb = 0;  // window starts of the next chunk to stage
    if (kStages - 1 < n) {
      vb = __ldg(vbase + kStages - 1);
      xb = __ldg(xbase + kStages - 1);
    }
    for (int j = 0; j < n; ++j) {
      cp_async_wait<kStages - 2>();  // chunk j has landed (this thread's copies)
      __syncthreads();               // ... everyone's; chunk j - 1's stage is free
      const int jn = j + kStages - 1;
      if (jn < n) {
        stage_chunk<true>(ring + (jn % kStages) * L.bytes, L, a, g0 + jn, 0, a.cb, true, vb, xb);
      }
      cp_async_commit();  // possibly empty: keeps the group count uniform
      if (jn + 1 < n) {
        vb = __ldg(vbase + jn + 1);
        xb = __ldg(xbase + jn + 1);
      }
      decode_stage(ring + (j % kStages) * L.bytes, L, a, a.cb, lrc, lc, ytile);
    }
  }
  __syncthreads();
  const int row0 = p * a.pr;
  const int nout = min(a.pr, a.nrows - row0);
  for (int i = threadIdx.x; i < nout; i += blockDim.x) {
    const float t = ytile[i];
    if (a.split == 1) {
      a.y[row0 + i] = t;
    } else if (t != 0.f) {
      atomicAdd(a.y + row0 + i, t);
    }
  }
}

using WholeKernel = void (*)(WholeArgs);

// The whole-vector kernel of a ring of `stages`: 1 (the synchronous twin)
// or 2 (a ring of 3 was slower on the H100: fewer CTAs an SM); nullptr for
// any other.
WholeKernel whole_kernel(int stages) {
  switch (stages) {
    case 1: return spmv_desc_whole_kernel<1>;
    case 2: return spmv_desc_whole_kernel<2>;
    default: return nullptr;
  }
}

int launch_whole(int stages, const WholeArgs& a, int smem_planned, int threads, int device,
                 void* stream) {
  const WholeKernel kernel = whole_kernel(stages);
  const size_t smem = whole_smem(a, stages);
  if (kernel == nullptr || a.grid < 1 || a.grid > a.nchunks || a.nb < 1 || a.nb > a.cb ||
      (stages > 1 && a.nb != a.cb) || a.tile < 1 || (a.c != 4 && a.c != 8) ||
      smem != (size_t)smem_planned || threads < 32 || threads > 512 || threads % 32 != 0) {
    return (int)cudaErrorInvalidValue;
  }
  cudaError_t err = prepare_launch(kernel, device, smem, threads, nullptr);
  if (err != cudaSuccess) return (int)err;
  void* args[] = {const_cast<WholeArgs*>(&a)};
  err = cudaLaunchKernel(reinterpret_cast<const void*>(kernel), dim3(a.grid), dim3(threads), args,
                         smem, (cudaStream_t)stream);
  return (int)(err != cudaSuccess ? err : cudaGetLastError());
}

WholeArgs whole_args(const int* vbase, const signed char* valid, const void* vidx,
                     const void* xcol, const void* yrow, const float* values, const float* x,
                     float* y, int nchunks, int cb, int r, int c, int vmax, int wv, int wx,
                     int wy, int grid, int nb, int tile) {
  return WholeArgs{vbase, valid, static_cast<const char*>(vidx), static_cast<const char*>(xcol),
                   static_cast<const char*>(yrow), values, x, y, nchunks, cb, r, c, vmax,
                   wv, wx, wy, grid, nb, tile};
}

template <int kStages>
int launch_panels(const PanelArgs& a, int npanels, int smem_planned, int threads, int device,
                  void* stream) {
  const size_t smem = panels_smem(a, kStages);
  if (a.split < 1 || a.nb < 1 || a.nb > a.cb || (long long)npanels * a.split > 0x7fffffffLL ||
      smem != (size_t)smem_planned) {
    return (int)cudaErrorInvalidValue;
  }
  cudaError_t err = prepare_launch(spmv_desc_panels_kernel<kStages>, device, smem, threads, nullptr);
  if (err != cudaSuccess) return (int)err;
  spmv_desc_panels_kernel<kStages>
      <<<npanels * a.split, threads, smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

template <int kStages>
int panels_occupancy(int threads, int smem, int device, int* out) {
  cudaError_t err =
      prepare_launch(spmv_desc_panels_kernel<kStages>, device, (size_t)smem, threads, nullptr);
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(out, spmv_desc_panels_kernel<kStages>,
                                                        threads, (size_t)smem);
  }
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(out + 1, cudaDevAttrMultiProcessorCount, device);
  return (int)err;
}

PanelArgs panel_args(const int* vbase, const int* xbase, const signed char* valid,
                     const void* vidx, const void* xcol, const void* yrow, const float* values,
                     const float* xpad, float* y, int nchunks, int cb, int r, int c, int vmax,
                     int xw, int pr, int nrows, int wv, int wx, int wy, int split, int nb) {
  return PanelArgs{vbase,  xbase, valid, static_cast<const char*>(vidx),
                   static_cast<const char*>(xcol), static_cast<const char*>(yrow),
                   values, xpad,  y,     nchunks, cb, r, c, vmax, xw, pr, nrows, wv, wx, wy,
                   split,  nb};
}

}  // namespace

extern "C" {

// The synchronous whole-vector kernel: `grid` CTAs, each a contiguous range
// of the chunks; nb blocks' tables per stage (nb == cb unless a whole
// chunk's stage does not fit); a y tile of `tile` rows. smem is the
// wrapper's figure for the CTA's dynamic shared memory (checked).
int spc5_spmv_desc_whole_s1(const int* vbase, const signed char* valid, const void* vidx,
                            const void* xcol, const void* yrow, const float* values,
                            const float* x, float* y, int nchunks, int cb, int r, int c,
                            int vmax, int wv, int wx, int wy, int grid, int nb, int tile,
                            int smem, int threads, int device, void* stream) {
  const WholeArgs a = whole_args(vbase, valid, vidx, xcol, yrow, values, x, y, nchunks, cb, r, c,
                                 vmax, wv, wx, wy, grid, nb, tile);
  return launch_whole(1, a, smem, threads, device, stream);
}

// The staged-ahead whole-vector kernel: a ring of two whole chunks.
int spc5_spmv_desc_whole_s2(const int* vbase, const signed char* valid, const void* vidx,
                            const void* xcol, const void* yrow, const float* values,
                            const float* x, float* y, int nchunks, int cb, int r, int c,
                            int vmax, int wv, int wx, int wy, int grid, int tile, int smem,
                            int threads, int device, void* stream) {
  const WholeArgs a = whole_args(vbase, valid, vidx, xcol, yrow, values, x, y, nchunks, cb, r, c,
                                 vmax, wv, wx, wy, grid, cb, tile);
  return launch_whole(2, a, smem, threads, device, stream);
}

// The whole-vector kernel's occupancy at `stages` (1: the synchronous
// kernel, 2: the ring), `threads` and `smem` bytes of dynamic shared memory per CTA:
// out[0] the CTAs one SM holds at once, out[1] the SMs of the device.
int spc5_spmv_desc_whole_occupancy(int stages, int threads, int smem, int device, int* out) {
  const WholeKernel kernel = whole_kernel(stages);
  if (kernel == nullptr) return (int)cudaErrorInvalidValue;
  cudaError_t err = prepare_launch(kernel, device, (size_t)smem, threads, nullptr);
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(out, kernel, threads, (size_t)smem);
  }
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(out + 1, cudaDevAttrMultiProcessorCount, device);
  return (int)err;
}

// The dynamic shared memory of one whole-vector CTA with `stages` stages of
// nb blocks each and a y tile of `tile` rows, as the launch computes it
// (whole_layout).
int spc5_spmv_desc_whole_smem(int stages, int nb, int r, int c, int vmax, int tile, int wv,
                              int wx) {
  WholeArgs a{};
  a.nb = nb;
  a.r = r;
  a.c = c;
  a.vmax = vmax;
  a.tile = tile;
  a.wv = wv;
  a.wx = wx;
  return (int)whole_smem(a, stages);
}

// The synchronous panel kernel: nb blocks' tables per stage (nb == cb
// unless a whole chunk's tables do not fit), split CTAs per panel. smem is
// the wrapper's figure for the CTA's dynamic shared memory (checked).
int spc5_spmv_desc_panels_s1(const int* vbase, const int* xbase, const signed char* valid,
                             const void* vidx, const void* xcol, const void* yrow,
                             const float* values, const float* xpad, float* y, int npanels,
                             int nchunks, int cb, int r, int c, int vmax, int xw, int pr,
                             int nrows, int wv, int wx, int wy, int split, int nb, int smem,
                             int threads, int device, void* stream) {
  const PanelArgs a = panel_args(vbase, xbase, valid, vidx, xcol, yrow, values, xpad, y, nchunks,
                                 cb, r, c, vmax, xw, pr, nrows, wv, wx, wy, split, nb);
  return launch_panels<1>(a, npanels, smem, threads, device, stream);
}

// The staged-ahead panel kernel: a ring of `stages` whole chunks, 3 or, where
// three do not fit, 2.
int spc5_spmv_desc_panels_s2(const int* vbase, const int* xbase, const signed char* valid,
                             const void* vidx, const void* xcol, const void* yrow,
                             const float* values, const float* xpad, float* y, int npanels,
                             int nchunks, int cb, int r, int c, int vmax, int xw, int pr,
                             int nrows, int wv, int wx, int wy, int split, int stages, int smem,
                             int threads, int device, void* stream) {
  const PanelArgs a = panel_args(vbase, xbase, valid, vidx, xcol, yrow, values, xpad, y, nchunks,
                                 cb, r, c, vmax, xw, pr, nrows, wv, wx, wy, split, cb);
  switch (stages) {
    case 2: return launch_panels<2>(a, npanels, smem, threads, device, stream);
    case 3: return launch_panels<3>(a, npanels, smem, threads, device, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The panel kernel's occupancy at `stages` (1: the synchronous kernel),
// `threads` and `smem` bytes of dynamic shared memory per CTA: out[0] the
// CTAs one SM holds at once, out[1] the SMs of the device.
int spc5_spmv_desc_panels_occupancy(int stages, int threads, int smem, int device, int* out) {
  switch (stages) {
    case 1: return panels_occupancy<1>(threads, smem, device, out);
    case 2: return panels_occupancy<2>(threads, smem, device, out);
    case 3: return panels_occupancy<3>(threads, smem, device, out);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The dynamic shared memory of one panel-kernel CTA with `stages` stages of
// nb blocks each, as the launch computes it (stage_layout).
int spc5_spmv_desc_panels_smem(int stages, int nb, int r, int c, int vmax, int xw, int pr,
                               int wv, int wx) {
  PanelArgs a{};
  a.nb = nb;
  a.r = r;
  a.c = c;
  a.vmax = vmax;
  a.xw = xw;
  a.pr = pr;
  a.wv = wv;
  a.wx = wx;
  return (int)panels_smem(a, stages);
}

}  // extern "C"
