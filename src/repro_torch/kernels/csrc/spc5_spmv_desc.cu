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
// nonzero in f32, 2 B in bf16, 1 B and an f32 scale a chunk in int8), x and
// y are read or written once. Two flops per nonzero.
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
//   * the value store is the kernels' template parameter V, as in the panel
//     kernels below: a narrow window is staged as its 16-byte aligned span
//     (value_span, copy_span: whole pieces by the bulk copy, its last 4 to
//     12 bytes by cp.async, the mbarrier expecting only the bulk bytes), and
//     thread 0 writes the window's offset in the span into the stage's
//     mbarrier slot; every thread loads the chunk's int8 scale before the
//     chunk's wait. The synchronous twin stages a chunk's window with its
//     first slice only, so the offset and the scale are a chunk's, kept for
//     its later slices;
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
//     atomic;
//   * the value store is the kernels' template parameter V: float, bf16 or
//     int8 (the quantised decode of the reference's _expand_vals: a value
//     upcast to f32, an int8 one then times its chunk's f32 scale, before
//     the product with x, summed in f32). A narrow window is staged as the
//     16-byte aligned span that covers it (an int8 window starts on any
//     multiple of 8 bytes), each thread finding the window's offset in it
//     and the chunk's scale once a chunk, before the chunk's barrier;
//   * a column map (spmv_desc_panels_cmap_kernel, the reference's col_map:
//     a reordered plan's fused column permutation): x stays in the original
//     column order and unpadded. The synchronous twin gathers a stage's x
//     window instead of copying it, window entry j being x[cmap[xb + j]],
//     or 0 at or past ncols (so a padding lane never reads x), and decodes
//     as without a map. The ring stages no x window: its decode reads each
//     set lane's x[cmap[xb + xcol]] through L1 (the map entries of a quad
//     loaded together, then their x entries). A window gathered into the
//     ring by 4-byte cp.async, each piece waiting for its map entry, made
//     the ring 2.3x slower than the same kernel on x[col_perm] on the
//     reordered band (its map loads stall the prefetch; 512 random x reads
//     a chunk for about 160 nonzeros), and the lane lookup in the
//     synchronous twin made it slower on the vocab layer than the window
//     (PERF.md, PR 27). The map is the kernel's own launch argument
//     (CmapPanelArgs), so the kernels without one keep their code.
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
  const float* values;  // f32 (QWholeArgs' kernels read it as their own type)
  const float* x;
  float* y;
  int nchunks, cb, r, c, vmax, wv, wx, wy;
  int grid;  // G: CTAs, each a contiguous range of the chunks
  int nb;    // blocks whose tables one stage holds (cb, or a slice of it)
  int tile;  // rows of the y tile
};

// The narrow stores' arguments (bf16, int8): the f32 ones, values' address
// in `values` (read as its own type), then the chunks' scales and values'
// length. The f32 kernels take WholeArgs as it was before the narrow stores
// (a larger parameter block changed f32 code, spc5_spmm.cu: MaskWholeArgs).
struct QWholeArgs : WholeArgs {
  const float* scale;  // (nchunks,) int8 scales; unread for bf16
  int nvalues;         // values' length: no staged span reaches past it
};

template <typename V>
struct WholeArgsFor {
  using type = QWholeArgs;
};
template <>
struct WholeArgsFor<float> {
  using type = WholeArgs;
};

// Byte offsets of one stage's parts, each 16-byte aligned: the value window
// (value_window bytes of vsize-byte values: a narrow one as its aligned
// span), then for nb blocks the valid and vidx runs, the c xcol entries of
// each block's first row, each block's lane-0 yrow entry in a 4-byte slot,
// and a 16-byte slot for the stage's mbarrier (and, at byte 8, a narrow
// window's offset in its span). The y tile (tile floats) comes before the
// first stage. The wrapper plans with its copy (kernels/spc5_spmv_desc.py:
// whole_smem_bytes) and passes its figure in; a launch whose figure differs
// is refused, and spc5_spmv_desc_whole_smem exposes this one for the
// wrapper's tests.
struct WholeLayout {
  int vwin, valid, vidx, xcol, yrow, bar, bytes;
};

__host__ __device__ inline WholeLayout whole_layout(const WholeArgs& a, int vsize) {
  const int rc = a.r * a.c;
  WholeLayout L;
  L.vwin = 0;
  // (an f32 window's bytes as the f32 kernels computed them before the
  // narrow stores: the same value, and the same f32 code)
  L.valid = vsize == 4 ? round16(4 * a.vmax) : value_window(vsize, a.vmax);
  L.vidx = L.valid + round16(a.nb * rc);
  L.xcol = L.vidx + round16(a.nb * rc * a.wv);
  L.yrow = L.xcol + round16(a.nb * a.c * a.wx);
  L.bar = L.yrow + round16(4 * a.nb);
  L.bytes = L.bar + 16;
  return L;
}

inline size_t whole_smem(const WholeArgs& a, int stages, int vsize) {
  return (size_t)round16(4 * a.tile) + (size_t)stages * whole_layout(a, vsize).bytes;
}

// Start staging blocks [b0, b0 + nb) of chunk g into stage st (and, where
// `window`, the chunk's value window, which starts at vb; a narrow one as
// its span, value_span / copy_span, the window's offset in it written into
// the mbarrier slot's second half): thread 0 announces and issues the bulk
// copies (the window; the valid and vidx runs where `bulk`), all completing
// on the stage's mbarrier, so the mbarrier completes one phase per call;
// every thread issues its share of the other pieces by cp.async (a span's
// last 4 to 12 bytes are thread 0's).
template <typename V, typename A>
__device__ __forceinline__ void fill_stage(unsigned char* st, const WholeLayout& L, const A& a,
                                           size_t g, int b0, int nb, bool window, int vb,
                                           bool bulk) {
  const int rc = a.r * a.c;
  const size_t lane0 = (g * a.cb + b0) * rc;
  const char* valid = reinterpret_cast<const char*>(a.valid) + lane0;
  const char* vidx = a.vidx + lane0 * a.wv;
  const int nvalid = nb * rc, nvidx = nb * rc * a.wv;
  if (threadIdx.x == 0) {
    uint64_t* bar = reinterpret_cast<uint64_t*>(st + L.bar);
    const V* values = reinterpret_cast<const V*>(a.values);
    if constexpr (sizeof(V) == 4) {
      mbar_expect_tx(bar, (window ? 4 * a.vmax : 0) + (bulk ? nvalid + nvidx : 0));
      if (window) bulk_copy(st + L.vwin, values + vb, 4 * a.vmax, bar);
    } else {
      int bytes = 0, off = 0;
      const char* span = nullptr;
      if (window) {
        span = value_span(values, vb, a.vmax, a.nvalues, bytes, off);
        *reinterpret_cast<int*>(st + L.bar + 8) = off;
      }
      mbar_expect_tx(bar, span_bulk_bytes(bytes) + (bulk ? nvalid + nvidx : 0));
      if (window) copy_span(st + L.vwin, span, bytes, bar);
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

// Chunk g's scale: an int8 store's (either layout's arguments: QWholeArgs,
// PanelArgs), 1 (unread) for the others.
template <typename V, typename A>
__device__ __forceinline__ float chunk_scale(const A& a, size_t g) {
  if constexpr (sizeof(V) == 1) {
    return __ldg(a.scale + g);
  } else {
    return 1.f;
  }
}

// The index of the staged window's first value in the stage: 0 for f32,
// staged as it lies; for a narrow window its offset in its span, which
// fill_stage wrote into the mbarrier slot.
template <typename V>
__device__ __forceinline__ int staged_offset(const unsigned char* st, const WholeLayout& L) {
  if constexpr (sizeof(V) == 4) {
    return 0;
  } else {
    return *reinterpret_cast<const int*>(st + L.bar + 8);
  }
}

// Add the nb staged blocks into the threads' row sums, four lanes a thread
// as decode_stage below does (one 4-byte word of valid flags, one load each
// of vidx and xcol, nothing gathered for a quad with no flag set, one xor
// shuffle joining a row's two quads for c = 8), x read in place through
// L1. Thread t keeps quad t % (r*c/4) of every (blockDim / (r*c/4))-th
// block: the same row of each, and a warp reads neighbouring words. The
// window's values start at entry voff of the stage (staged_offset); s is
// the chunk's scale (int8 only).
template <typename V>
__device__ __forceinline__ void decode_whole(const unsigned char* st, const WholeLayout& L,
                                             const WholeArgs& a, int nb, int lrc, int lc,
                                             float* ytile, int tbase, RowSum& rs, int voff,
                                             float s) {
  const V* vwin = reinterpret_cast<const V*>(st + L.vwin) + voff;
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
        if ((flags >> (8 * u)) & 0xff) v += dequant(vwin[vi[u]], s) * __ldg(a.x + xc[u]);
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

template <typename V, int kStages>
__global__ void __launch_bounds__(512)
    spmv_desc_whole_kernel(const typename WholeArgsFor<V>::type a) {
  extern __shared__ __align__(16) float smem[];  // one name and type per file
  const WholeLayout L = whole_layout(a, (int)sizeof(V));
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
      // the chunk's scale, for all its slices (the window is staged once)
      const float s = chunk_scale<V>(a, (size_t)c0 + j);
      for (int b0 = 0; b0 < a.cb; b0 += a.nb) {
        const int nb = min(a.nb, a.cb - b0);
        if (j > 0 || b0 > 0) __syncthreads();  // the previous decode is done
        fill_stage<V>(ring, L, a, (size_t)c0 + j, b0, nb, b0 == 0, vj, bulk);
        cp_async_commit();
        cp_async_wait<0>();
        mbar_wait(bar, phase & 1u);
        ++phase;
        __syncthreads();  // everyone's copies, and the window's offset
        if (b0 == 0) move_tile(ring, L, a, j, ytile, tbase);
        decode_whole<V>(ring, L, a, nb, lrc, lc, ytile, tbase, rs, staged_offset<V>(ring, L), s);
      }
    }
  } else {
    // the ring: chunk j lives in stage j % kStages; kStages - 1 chunks are
    // in flight while one decodes
    for (int s = 0; s < kStages - 1; ++s) {
      if (s < n) {
        fill_stage<V>(ring + s * L.bytes, L, a, (size_t)c0 + s, 0, a.cb, true,
                      threadIdx.x == 0 ? __ldg(vbase + s) : 0, bulk);
      }
      cp_async_commit();
    }
    int vb = threadIdx.x == 0 && kStages - 1 < n ? __ldg(vbase + kStages - 1) : 0;
    int dec = 0, fill = kStages - 1;  // the stages of chunks j and j + kStages - 1
    uint32_t parity = 0;              // bit s: the parity of stage s's next phase
    for (int j = 0; j < n; ++j) {
      unsigned char* st = ring + dec * L.bytes;
      const float s = chunk_scale<V>(a, (size_t)c0 + j);  // loaded before the wait
      cp_async_wait<kStages - 2>();  // chunk j's cp.async pieces of this thread
      mbar_wait(reinterpret_cast<uint64_t*>(st + L.bar), (parity >> dec) & 1u);
      parity ^= 1u << dec;
      __syncthreads();  // ... everyone's; chunk j - 1's stage is free
      move_tile(st, L, a, j, ytile, tbase);
      const int jn = j + kStages - 1;
      if (jn < n) {
        fill_stage<V>(ring + fill * L.bytes, L, a, (size_t)c0 + jn, 0, a.cb, true, vb, bulk);
      }
      cp_async_commit();  // possibly empty: keeps the group count uniform
      if (threadIdx.x == 0 && jn + 1 < n) vb = __ldg(vbase + jn + 1);
      decode_whole<V>(st, L, a, a.cb, lrc, lc, ytile, tbase, rs, staged_offset<V>(st, L), s);
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
  const void* values;  // vsize bytes a value: float, __nv_bfloat16 or int8_t
  const float* scale;  // (npanels, nchunks) int8 scales; unread otherwise
  const float* xpad;
  float* y;
  int nchunks, cb, r, c, vmax, xw, pr, nrows, vsize, wv, wx, wy;
  int split;  // S: CTAs per panel, each a contiguous range of its chunks
  int nb;     // blocks whose tables one stage holds (cb, or a slice of it)
  int nvalues;  // values' length: no staged span reaches past it (last, so
                // the other fields keep the offsets the f32 kernels had)
};

// A launch with a column map: PanelArgs' fields as they are, then the map.
// xpad is then x itself, (ncols,) in the original column order.
struct CmapPanelArgs : PanelArgs {
  const int* cmap;  // (ncols,): the column of x each permuted column reads
  int ncols;
};

template <typename A>
constexpr bool kMapped = false;
template <>
constexpr bool kMapped<CmapPanelArgs> = true;

// Byte offsets of one stage's parts, each 16-byte aligned: the value window
// (value_window bytes), the x window, then for nb blocks the valid and vidx
// runs, the c xcol
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
  L.xwin = L.vwin + value_window(a.vsize, a.vmax);
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

// Gather the x window at xb of a mapped launch into dst with all threads of
// the CTA, with loads: entry j is x[cmap[xb + j]], 0 at or past ncols. Up
// to four entries a thread are in flight: their map entries loaded
// together, then their x entries, then the stores.
__device__ __forceinline__ void gather_window(float* dst, const CmapPanelArgs& a, int xb) {
  for (int j0 = threadIdx.x; j0 < a.xw; j0 += 4 * blockDim.x) {
    int src[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int j = j0 + u * blockDim.x, col = xb + j;
      src[u] = j < a.xw && col < a.ncols ? __ldg(a.cmap + col) : -1;
    }
    float v[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) v[u] = src[u] >= 0 ? __ldg(a.xpad + src[u]) : 0.f;
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int j = j0 + u * blockDim.x;
      if (j < a.xw) dst[j] = v[u];
    }
  }
}

// Stage the tables of blocks [b0, b0 + nb) of global chunk g (and, where
// windows is set, its value window at vb, a narrow one as the aligned span
// that covers it, kept inside values (copy_span_runs), and its x window at
// xb: copied, or for a mapped launch gathered through the map by the
// synchronous twin and not staged at all by the ring, which reads x at each
// set lane).
template <bool kAsync, typename V, typename A>
__device__ __forceinline__ void stage_chunk(unsigned char* st, const StageLayout& L,
                                            const A& a, size_t g, int b0, int nb,
                                            bool windows, int vb, int xb) {
  const int rc = a.r * a.c;
  const size_t lane0 = (g * a.cb + b0) * rc;
  if (windows) {
    const V* values = static_cast<const V*>(a.values);
    if constexpr (sizeof(V) == 4) {
      copy_runs<kAsync>(st + L.vwin, reinterpret_cast<const char*>(values + vb), 1, 4 * a.vmax, 0);
    } else {
      int bytes, off;
      const char* span = value_span(values, vb, a.vmax, a.nvalues, bytes, off);
      copy_span_runs<kAsync>(st + L.vwin, span, bytes);
    }
    if constexpr (kMapped<A>) {
      if constexpr (!kAsync) gather_window(reinterpret_cast<float*>(st + L.xwin), a, xb);
    } else {
      copy_runs<kAsync>(st + L.xwin, reinterpret_cast<const char*>(a.xpad + xb), 1, 4 * a.xw, 0);
    }
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
// shuffle; the row's first quad adds it into the tile. The window's values
// start at entry voff of the staged span (0 for f32); s is the chunk's
// scale (int8 only). kLaneMap (a mapped ring): no x window is staged, and
// a set lane of window column xc reads x[cmap[xb + xc]].
template <typename V, bool kLaneMap, typename A>
__device__ __forceinline__ void decode_stage(const unsigned char* st, const StageLayout& L,
                                             const A& a, int nb, int lrc, int lc,
                                             float* ytile, int voff, float s, int xb) {
  const V* vwin = reinterpret_cast<const V*>(st + L.vwin) + voff;
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
      if constexpr (kLaneMap) {
        int src[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          src[u] = ((flags >> (8 * u)) & 0xff) ? __ldg(a.cmap + xb + xc[u]) : -1;
        }
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          if (src[u] >= 0) v += dequant(vwin[vi[u]], s) * __ldg(a.xpad + src[u]);
        }
      } else {
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          if ((flags >> (8 * u)) & 0xff) v += dequant(vwin[vi[u]], s) * xwin[xc[u]];
        }
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

// The index of window [vb, vb + vmax) 's first value in the span value_span
// stages (0 for f32, staged as it lies).
template <typename V>
__device__ __forceinline__ int window_offset(const PanelArgs& a, int vb) {
  if constexpr (sizeof(V) == 4) {
    return 0;
  } else {
    const uintptr_t p = reinterpret_cast<uintptr_t>(static_cast<const V*>(a.values) + vb);
    return (int)(p & 15) / (int)sizeof(V);
  }
}

// The panel kernels' body, for launch arguments A (PanelArgs, or
// CmapPanelArgs with a column map).
template <typename V, int kStages, typename A>
__device__ __forceinline__ void panels_body(const A& a) {
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
      const int voff = window_offset<V>(a, vj);
      const float s = chunk_scale<V>(a, g0 + j);
      for (int b0 = 0; b0 < a.cb; b0 += a.nb) {
        const int nb = min(a.nb, a.cb - b0);
        __syncthreads();  // the previous decode (or the tile's zeroing) is done
        stage_chunk<false, V>(ring, L, a, g0 + j, b0, nb, b0 == 0, vj, xj);
        __syncthreads();
        decode_stage<V, false>(ring, L, a, nb, lrc, lc, ytile, voff, s, 0);
      }
    }
  } else {
    // the ring: chunk j lives in stage j % kStages; kStages - 1 chunks are
    // in flight while one decodes
    for (int s = 0; s < kStages - 1; ++s) {
      if (s < n) {
        stage_chunk<true, V>(ring + s * L.bytes, L, a, g0 + s, 0, a.cb, true, __ldg(vbase + s),
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
      // chunk j's window offset and scale, loaded before the wait
      const int voff = sizeof(V) == 4 ? 0 : window_offset<V>(a, __ldg(vbase + j));
      const float s = chunk_scale<V>(a, g0 + j);
      cp_async_wait<kStages - 2>();  // chunk j has landed (this thread's copies)
      __syncthreads();               // ... everyone's; chunk j - 1's stage is free
      const int jn = j + kStages - 1;
      if (jn < n) {
        stage_chunk<true, V>(ring + (jn % kStages) * L.bytes, L, a, g0 + jn, 0, a.cb, true, vb,
                             xb);
      }
      cp_async_commit();  // possibly empty: keeps the group count uniform
      if (jn + 1 < n) {
        vb = __ldg(vbase + jn + 1);
        xb = __ldg(xbase + jn + 1);
      }
      decode_stage<V, kMapped<A>>(ring + (j % kStages) * L.bytes, L, a, a.cb, lrc, lc, ytile,
                                  voff, s, kMapped<A> ? __ldg(xbase + j) : 0);
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

template <typename V, int kStages>
__global__ void __launch_bounds__(256) spmv_desc_panels_kernel(const PanelArgs a) {
  panels_body<V, kStages>(a);
}

template <typename V, int kStages>
__global__ void __launch_bounds__(256) spmv_desc_panels_cmap_kernel(const CmapPanelArgs a) {
  panels_body<V, kStages>(a);
}

template <typename V>
using WholeKernel = void (*)(typename WholeArgsFor<V>::type);

// The whole-vector kernel for values of type V and a ring of `stages`: 1
// (the synchronous twin) or 2 (a ring of 3 was slower on the H100: fewer
// CTAs an SM); nullptr for any other.
template <typename V>
WholeKernel<V> whole_kernel(int stages) {
  switch (stages) {
    case 1: return spmv_desc_whole_kernel<V, 1>;
    case 2: return spmv_desc_whole_kernel<V, 2>;
    default: return nullptr;
  }
}

// Launch the whole-vector kernel of `stages` for values of type V with the
// wrapper's plan: a grid, slice, tile, shared-memory figure or thread count
// it did not plan (or the kernel cannot take), or int8 values without their
// scales, is refused with cudaErrorInvalidValue, launching nothing.
template <typename V>
int launch_whole(int stages, const typename WholeArgsFor<V>::type& a, int smem_planned,
                 int threads, int device, void* stream) {
  const WholeKernel<V> kernel = whole_kernel<V>(stages);
  const size_t smem = whole_smem(a, stages, (int)sizeof(V));
  bool no_scale = false;
  if constexpr (sizeof(V) == 1) no_scale = a.scale == nullptr;
  if (kernel == nullptr || a.grid < 1 || a.grid > a.nchunks || a.nb < 1 || a.nb > a.cb ||
      (stages > 1 && a.nb != a.cb) || a.tile < 1 || (a.c != 4 && a.c != 8) ||
      smem != (size_t)smem_planned || threads < 32 || threads > 512 || threads % 32 != 0 ||
      no_scale) {
    return (int)cudaErrorInvalidValue;
  }
  cudaError_t err = prepare_launch(kernel, device, smem, threads, nullptr);
  if (err != cudaSuccess) return (int)err;
  void* args[] = {const_cast<typename WholeArgsFor<V>::type*>(&a)};
  err = cudaLaunchKernel(reinterpret_cast<const void*>(kernel), dim3(a.grid), dim3(threads), args,
                         smem, (cudaStream_t)stream);
  return (int)(err != cudaSuccess ? err : cudaGetLastError());
}

WholeArgs whole_args(const int* vbase, const signed char* valid, const void* vidx,
                     const void* xcol, const void* yrow, const void* values, const float* x,
                     float* y, int nchunks, int cb, int r, int c, int vmax, int wv, int wx,
                     int wy, int grid, int nb, int tile) {
  return WholeArgs{vbase, valid, static_cast<const char*>(vidx), static_cast<const char*>(xcol),
                   static_cast<const char*>(yrow), static_cast<const float*>(values), x, y,
                   nchunks, cb, r, c, vmax, wv, wx, wy, grid, nb, tile};
}

// Launch the whole-vector kernel for vsize-byte values (4 f32, 2 bf16, 1
// int8 with its scales), nvalues of them.
int launch_whole_values(int stages, int vsize, const WholeArgs& a, const float* scale,
                        int nvalues, int smem, int threads, int device, void* stream) {
  QWholeArgs q{};
  static_cast<WholeArgs&>(q) = a;
  q.scale = scale;
  q.nvalues = nvalues;
  switch (vsize) {
    case 4: return launch_whole<float>(stages, a, smem, threads, device, stream);
    case 2: return launch_whole<__nv_bfloat16>(stages, q, smem, threads, device, stream);
    case 1: return launch_whole<int8_t>(stages, q, smem, threads, device, stream);
    default: return (int)cudaErrorInvalidValue;
  }
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

using PanelKernel = void (*)(PanelArgs);
using CmapPanelKernel = void (*)(CmapPanelArgs);

template <typename V>
PanelKernel panel_kernel_v(int stages) {
  switch (stages) {
    case 1: return spmv_desc_panels_kernel<V, 1>;
    case 2: return spmv_desc_panels_kernel<V, 2>;
    case 3: return spmv_desc_panels_kernel<V, 3>;
    default: return nullptr;
  }
}

template <typename V>
CmapPanelKernel cmap_panel_kernel_v(int stages) {
  switch (stages) {
    case 1: return spmv_desc_panels_cmap_kernel<V, 1>;
    case 2: return spmv_desc_panels_cmap_kernel<V, 2>;
    case 3: return spmv_desc_panels_cmap_kernel<V, 3>;
    default: return nullptr;
  }
}

// The panel kernel for vsize-byte values (4 float, 2 bf16, 1 int8), a ring
// of `stages` (1: the synchronous kernel) and launch arguments A (with a
// column map for CmapPanelArgs); nullptr for any other.
template <typename A>
void (*panel_kernel(int vsize, int stages))(A) {
  if constexpr (kMapped<A>) {
    switch (vsize) {
      case 4: return cmap_panel_kernel_v<float>(stages);
      case 2: return cmap_panel_kernel_v<__nv_bfloat16>(stages);
      case 1: return cmap_panel_kernel_v<int8_t>(stages);
      default: return nullptr;
    }
  } else {
    switch (vsize) {
      case 4: return panel_kernel_v<float>(stages);
      case 2: return panel_kernel_v<__nv_bfloat16>(stages);
      case 1: return panel_kernel_v<int8_t>(stages);
      default: return nullptr;
    }
  }
}

template <typename A>
int launch_panels(int stages, const A& a, int npanels, int smem_planned, int threads,
                  int device, void* stream) {
  const auto kernel = panel_kernel<A>(a.vsize, stages);
  const size_t smem = panels_smem(a, stages);
  bool bad_map = false;
  if constexpr (kMapped<A>) bad_map = a.cmap == nullptr || a.ncols < 1;
  if (kernel == nullptr || a.split < 1 || a.nb < 1 || a.nb > a.cb ||
      (stages > 1 && a.nb != a.cb) || (long long)npanels * a.split > 0x7fffffffLL ||
      (a.vsize == 1 && a.scale == nullptr) || smem != (size_t)smem_planned || bad_map) {
    return (int)cudaErrorInvalidValue;
  }
  cudaError_t err = prepare_launch(kernel, device, smem, threads, nullptr);
  if (err != cudaSuccess) return (int)err;
  void* args[] = {const_cast<A*>(&a)};
  err = cudaLaunchKernel(reinterpret_cast<const void*>(kernel), dim3(npanels * a.split),
                         dim3(threads), args, smem, (cudaStream_t)stream);
  return (int)(err != cudaSuccess ? err : cudaGetLastError());
}

PanelArgs panel_args(const int* vbase, const int* xbase, const signed char* valid,
                     const void* vidx, const void* xcol, const void* yrow, const void* values,
                     const float* scale, const float* xpad, float* y, int nchunks, int cb, int r,
                     int c, int vmax, int xw, int pr, int nrows, int vsize, int nvalues, int wv,
                     int wx, int wy, int split, int nb) {
  return PanelArgs{vbase,  xbase, valid, static_cast<const char*>(vidx),
                   static_cast<const char*>(xcol), static_cast<const char*>(yrow),
                   values, scale, xpad,  y,     nchunks, cb, r, c, vmax, xw, pr, nrows, vsize,
                   wv,     wx,    wy,    split, nb, nvalues};
}

}  // namespace

extern "C" {

// The synchronous whole-vector kernel: `grid` CTAs, each a contiguous range
// of the chunks; nb blocks' tables per stage (nb == cb unless a whole
// chunk's stage does not fit); a y tile of `tile` rows; values of vsize
// bytes (4 f32, 2 bf16, 1 int8 with its (nchunks,) scales; scale is unread
// otherwise), nvalues of them. smem is the wrapper's figure for the CTA's
// dynamic shared memory (checked).
int spc5_spmv_desc_whole_s1(const int* vbase, const signed char* valid, const void* vidx,
                            const void* xcol, const void* yrow, const void* values,
                            const float* scale, const float* x, float* y, int nchunks, int cb,
                            int r, int c, int vmax, int vsize, int nvalues, int wv, int wx,
                            int wy, int grid, int nb, int tile, int smem, int threads,
                            int device, void* stream) {
  const WholeArgs a = whole_args(vbase, valid, vidx, xcol, yrow, values, x, y, nchunks, cb, r, c,
                                 vmax, wv, wx, wy, grid, nb, tile);
  return launch_whole_values(1, vsize, a, scale, nvalues, smem, threads, device, stream);
}

// The staged-ahead whole-vector kernel: a ring of two whole chunks.
int spc5_spmv_desc_whole_s2(const int* vbase, const signed char* valid, const void* vidx,
                            const void* xcol, const void* yrow, const void* values,
                            const float* scale, const float* x, float* y, int nchunks, int cb,
                            int r, int c, int vmax, int vsize, int nvalues, int wv, int wx,
                            int wy, int grid, int tile, int smem, int threads, int device,
                            void* stream) {
  const WholeArgs a = whole_args(vbase, valid, vidx, xcol, yrow, values, x, y, nchunks, cb, r, c,
                                 vmax, wv, wx, wy, grid, cb, tile);
  return launch_whole_values(2, vsize, a, scale, nvalues, smem, threads, device, stream);
}

// The whole-vector kernel's occupancy at `stages` (1: the synchronous
// kernel, 2: the ring), vsize-byte values, `threads` and `smem` bytes of
// dynamic shared memory per CTA: out[0] the CTAs one SM holds at once,
// out[1] the SMs of the device.
int spc5_spmv_desc_whole_occupancy(int stages, int vsize, int threads, int smem, int device,
                                   int* out) {
  switch (vsize) {
    case 4: return whole_occupancy(whole_kernel<float>(stages), threads, smem, device, out);
    case 2:
      return whole_occupancy(whole_kernel<__nv_bfloat16>(stages), threads, smem, device, out);
    case 1: return whole_occupancy(whole_kernel<int8_t>(stages), threads, smem, device, out);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The dynamic shared memory of one whole-vector CTA with `stages` stages of
// nb blocks each, a y tile of `tile` rows and vsize-byte values, as the
// launch computes it (whole_layout).
int spc5_spmv_desc_whole_smem(int stages, int nb, int r, int c, int vmax, int tile, int wv,
                              int wx, int vsize) {
  WholeArgs a{};
  a.nb = nb;
  a.r = r;
  a.c = c;
  a.vmax = vmax;
  a.tile = tile;
  a.wv = wv;
  a.wx = wx;
  return (int)whole_smem(a, stages, vsize);
}

// The synchronous panel kernel: nb blocks' tables per stage (nb == cb
// unless a whole chunk's tables do not fit), split CTAs per panel, values of
// vsize bytes (4 f32, 2 bf16, 1 int8 with its (npanels, nchunks) scales;
// scale is unread otherwise). smem is the wrapper's figure for the CTA's
// dynamic shared memory (checked).
int spc5_spmv_desc_panels_s1(const int* vbase, const int* xbase, const signed char* valid,
                             const void* vidx, const void* xcol, const void* yrow,
                             const void* values, const float* scale, const float* xpad, float* y,
                             int npanels, int nchunks, int cb, int r, int c, int vmax, int xw,
                             int pr, int nrows, int vsize, int nvalues, int wv, int wx, int wy,
                             int split, int nb, int smem, int threads, int device, void* stream) {
  const PanelArgs a = panel_args(vbase, xbase, valid, vidx, xcol, yrow, values, scale, xpad, y,
                                 nchunks, cb, r, c, vmax, xw, pr, nrows, vsize, nvalues, wv, wx,
                                 wy, split, nb);
  return launch_panels(1, a, npanels, smem, threads, device, stream);
}

// The staged-ahead panel kernel: a ring of `stages` whole chunks, 3 or, where
// three do not fit, 2.
int spc5_spmv_desc_panels_s2(const int* vbase, const int* xbase, const signed char* valid,
                             const void* vidx, const void* xcol, const void* yrow,
                             const void* values, const float* scale, const float* xpad, float* y,
                             int npanels, int nchunks, int cb, int r, int c, int vmax, int xw,
                             int pr, int nrows, int vsize, int nvalues, int wv, int wx, int wy,
                             int split, int stages, int smem, int threads, int device,
                             void* stream) {
  const PanelArgs a = panel_args(vbase, xbase, valid, vidx, xcol, yrow, values, scale, xpad, y,
                                 nchunks, cb, r, c, vmax, xw, pr, nrows, vsize, nvalues, wv, wx,
                                 wy, split, cb);
  if (stages != 2 && stages != 3) return (int)cudaErrorInvalidValue;
  return launch_panels(stages, a, npanels, smem, threads, device, stream);
}

// The panel kernels with a column map: the arguments of their twins above,
// then cmap ((ncols,) int32, the column of x each permuted column reads);
// xpad is x itself, (ncols,) in the original column order.
int spc5_spmv_desc_panels_cmap_s1(const int* vbase, const int* xbase, const signed char* valid,
                                  const void* vidx, const void* xcol, const void* yrow,
                                  const void* values, const float* scale, const float* x,
                                  float* y, int npanels, int nchunks, int cb, int r, int c,
                                  int vmax, int xw, int pr, int nrows, int vsize, int nvalues,
                                  int wv, int wx, int wy, int split, int nb, int smem,
                                  int threads, int device, void* stream, const int* cmap,
                                  int ncols) {
  CmapPanelArgs a{};
  static_cast<PanelArgs&>(a) =
      panel_args(vbase, xbase, valid, vidx, xcol, yrow, values, scale, x, y, nchunks, cb, r, c,
                 vmax, xw, pr, nrows, vsize, nvalues, wv, wx, wy, split, nb);
  a.cmap = cmap;
  a.ncols = ncols;
  return launch_panels(1, a, npanels, smem, threads, device, stream);
}

int spc5_spmv_desc_panels_cmap_s2(const int* vbase, const int* xbase, const signed char* valid,
                                  const void* vidx, const void* xcol, const void* yrow,
                                  const void* values, const float* scale, const float* x,
                                  float* y, int npanels, int nchunks, int cb, int r, int c,
                                  int vmax, int xw, int pr, int nrows, int vsize, int nvalues,
                                  int wv, int wx, int wy, int split, int stages, int smem,
                                  int threads, int device, void* stream, const int* cmap,
                                  int ncols) {
  CmapPanelArgs a{};
  static_cast<PanelArgs&>(a) =
      panel_args(vbase, xbase, valid, vidx, xcol, yrow, values, scale, x, y, nchunks, cb, r, c,
                 vmax, xw, pr, nrows, vsize, nvalues, wv, wx, wy, split, cb);
  a.cmap = cmap;
  a.ncols = ncols;
  if (stages != 2 && stages != 3) return (int)cudaErrorInvalidValue;
  return launch_panels(stages, a, npanels, smem, threads, device, stream);
}

// The panel kernel's occupancy at `stages` (1: the synchronous kernel),
// vsize-byte values, `threads` and `smem` bytes of dynamic shared memory per
// CTA, of the kernel with a column map: out[0] the CTAs one SM holds at
// once, out[1] the SMs of the device.
int spc5_spmv_desc_panels_cmap_occupancy(int stages, int vsize, int threads, int smem,
                                         int device, int* out) {
  const CmapPanelKernel kernel = panel_kernel<CmapPanelArgs>(vsize, stages);
  if (kernel == nullptr) return (int)cudaErrorInvalidValue;
  cudaError_t err = prepare_launch(kernel, device, (size_t)smem, threads, nullptr);
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(out, kernel, threads, (size_t)smem);
  }
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(out + 1, cudaDevAttrMultiProcessorCount, device);
  return (int)err;
}

// The panel kernel's occupancy at `stages` (1: the synchronous kernel),
// vsize-byte values, `threads` and `smem` bytes of dynamic shared memory per
// CTA: out[0] the CTAs one SM holds at once, out[1] the SMs of the device.
int spc5_spmv_desc_panels_occupancy(int stages, int vsize, int threads, int smem, int device,
                                    int* out) {
  const PanelKernel kernel = panel_kernel<PanelArgs>(vsize, stages);
  if (kernel == nullptr) return (int)cudaErrorInvalidValue;
  cudaError_t err = prepare_launch(kernel, device, (size_t)smem, threads, nullptr);
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(out, kernel, threads, (size_t)smem);
  }
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(out + 1, cudaDevAttrMultiProcessorCount, device);
  return (int)err;
}

// The dynamic shared memory of one panel-kernel CTA with `stages` stages of
// nb blocks each and vsize-byte values, as the launch computes it
// (stage_layout).
int spc5_spmv_desc_panels_smem(int stages, int nb, int r, int c, int vmax, int xw, int pr,
                               int wv, int wx, int vsize) {
  PanelArgs a{};
  a.nb = nb;
  a.r = r;
  a.c = c;
  a.vmax = vmax;
  a.xw = xw;
  a.pr = pr;
  a.wv = wv;
  a.wx = wx;
  a.vsize = vsize;
  return (int)panels_smem(a, stages);
}

}  // extern "C"
