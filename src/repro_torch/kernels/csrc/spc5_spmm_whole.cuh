// The skeleton shared by the two whole-vector SpMM kernels, spc5_spmm.cu's
// mask kernel (spc5_spmm_whole) and spc5_spmm_desc.cu's descriptor kernel
// (spc5_spmm_desc_whole), as spc5_spmm_panels.cuh is shared by the panel
// pairs. Y = A @ X, X (xrows, nvec) and Y (nrows, nvec) row-major f32, Y
// zeroed by the wrapper. Each kernel brings a policy P: its argument struct
// (P::Args, holding a WholeGeom g), its stage (P::stage_bytes, P::fill), a
// stage's first row (P::first_row), and per block its kept lanes and row
// (P::block) and its list entries (P::emit). This header holds the rest:
//
//   * the grid: G CTAs each take a contiguous range of all the chunks (to_
//     chunked cuts every cb blocks whatever the row, so neighbouring chunks
//     share rows and meet in one CTA); column tiles of tw <= 128 columns take
//     neighbouring blockIdx values, so their table reads meet in L2;
//   * the staging ring: a round stages q whole chunks (or, with one stage, a
//     slice of nb blocks of one chunk, the value window with the first
//     slice); P::fill issues bulk copies on the stage's mbarrier and
//     cp.async pieces. With stages == 2 round k + 1 is in flight while round
//     k is listed and walked;
//   * the list, once a round: every kept lane (set, and its column below X's
//     rows) becomes an entry (value, X offset col * nvec, row), ordered by
//     (row of the block lr, block, lane). Two passes over the blocks, one
//     thread a block: the totals per lr, then a CTA-wide exclusive scan of
//     each block's r counts (16-bit fields, two to a word) gives each entry
//     its place. Where the blocks' rows come sorted and block rows do not
//     overlap (every plan to_chunked builds), each row of the round is then
//     one contiguous segment of the list ("segmented"), whatever the rows;
//   * the walk: the list is cut into one range per lane group of equal
//     length, lanes of V = 4, 2 or 1 neighbouring columns (a 16-, 8- or
//     4-byte X load), four entries at a time: their X rows loaded together,
//     then multiplied in order, a row run summed in registers;
//   * the combine, deterministic within the CTA and with no shared float
//     atomic (a compare-and-swap loop on the H100): on a segmented list a run
//     that lies inside a group's range is its row's only sum in the round and
//     is added into the Y tile with a plain load and store; a run cut by a
//     range boundary goes to the group's slot (A: its first run, continued
//     from the group before; B: its last, continued by the group after), and
//     after a barrier the group holding a B slot adds the B and A slots of
//     that row in group order into the tile. A list that is not segmented
//     (rows out of order or overlapping, as a permuted plan brings) adds
//     every run straight into Y with a global atomic;
//   * the Y tile: `tile` rows of tw columns, based at a round's first row;
//     when a round's first row leaves the tile's first half the tile's
//     nonzero rows are added into Y (one global atomic per row and column,
//     four columns to a vector atomic) and the tile is rebased there, as at
//     the end. A row outside the tile goes straight to Y with a global
//     atomic, so any row order and any repeats give the right result; the
//     f32 sum order still varies from run to run through the global atomics.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "spc5_spmm_panels.cuh"
#include "spc5_stage.cuh"

namespace {

struct WholeGeom {
  const float* x;  // (xrows, nvec), read in place
  float* y;        // (nrows, nvec), zeroed
  int nchunks, cb, r, c, vmax, nrows, xrows, nvec;
  int tw;      // columns of a tile: vec times the lanes of a group (at most 32 lanes)
  int vec;     // columns a lane owns: 4, 2 or 1
  int ntiles;  // ceil(nvec / tw)
  int grid;    // G: CTAs a column tile, each a contiguous range of the chunks
  int stages;  // 2: a ring, one round ahead of the walk; 1: copied, then walked
  int q;       // chunks a round stages
  int nb;      // blocks a round stages: q * cb, or (stages == 1, q == 1) a slice of a chunk
  int tile;    // rows of the Y tile
};

__host__ __device__ __forceinline__ int wr16(int n) { return (n + 15) & ~15; }

// Words of the scan's scratch: two areas (alternate batches) of 16 warps x 8
// words (the r counts, two to a word, and the last row).
constexpr int kWholeScratchWords = 2 * 16 * 8;

// Byte offsets of a CTA's shared memory, each 16-byte aligned: the (tile, tw)
// f32 Y tile at 0, the groups' A and B slots (tw floats each), their headers
// (an int4 a group: A's row, whether A goes on into the next group, B's
// row), the scan's scratch, the list (room entries of 16 bytes: room = the
// most kept lanes a round can hold, min(q * vmax, nb * r * c)), then the
// ring of `stages` stages of the policy's `stage` bytes. The wrappers reckon
// the same (kernels/spc5_spmm.py: whole_smem_bytes; kernels/spc5_spmm_desc.py:
// whole_smem_bytes) and pass their figure in; a launch whose figure differs is
// refused.
struct WholeLayout {
  int slots, heads, scratch, list, ring, stage, room, bytes;
};

__host__ __device__ inline WholeLayout whole_layout(const WholeGeom& g, int stage_bytes,
                                                    int threads) {
  const int lanes = g.vec > 0 ? g.tw / g.vec : 1;
  const int groups = lanes > 0 ? threads / lanes : 0;
  WholeLayout L;
  L.slots = wr16(4 * g.tile * g.tw);
  L.heads = L.slots + wr16(8 * groups * g.tw);
  L.scratch = L.heads + 16 * groups;
  L.list = L.scratch + 4 * kWholeScratchWords;
  const long long room = (long long)g.nb * g.r * g.c;
  L.room = (int)((long long)g.q * g.vmax < room ? (long long)g.q * g.vmax : room);
  L.ring = L.list + 16 * L.room;
  L.stage = stage_bytes;
  L.bytes = L.ring + g.stages * stage_bytes;
  return L;
}

// Add V floats into Y at p with one global atomic (one vector red.global.add
// for four where the toolkit has it).
template <int V>
__device__ __forceinline__ void red_add(float* p, const float (&v)[V]) {
  if constexpr (V == 4) {
#if __CUDACC_VER_MAJOR__ * 100 + __CUDACC_VER_MINOR__ >= 1201
    atomicAdd(reinterpret_cast<float4*>(p), make_float4(v[0], v[1], v[2], v[3]));
#else
#pragma unroll
    for (int u = 0; u < 4; ++u) atomicAdd(p + u, v[u]);
#endif
  } else {
#pragma unroll
    for (int u = 0; u < V; ++u) atomicAdd(p + u, v[u]);
  }
}

template <int V>
__device__ __forceinline__ void store_v(float* p, const float (&v)[V]) {
  if constexpr (V == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else if constexpr (V == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
  } else {
    p[0] = v[0];
  }
}

template <int V>
__device__ __forceinline__ void load_v(const float* p, float (&v)[V]) {
  if constexpr (V == 4) {
    const float4 q = *reinterpret_cast<const float4*>(p);
    v[0] = q.x;
    v[1] = q.y;
    v[2] = q.z;
    v[3] = q.w;
  } else if constexpr (V == 2) {
    const float2 q = *reinterpret_cast<const float2*>(p);
    v[0] = q.x;
    v[1] = q.y;
  } else {
    v[0] = p[0];
  }
}

// Where a lane's sums go: the tile, its slots, Y.
struct WholeOut {
  float* ytile;   // the Y tile at this lane's first column
  float* slots;   // this group's A slot at this lane's first column (B: + tw)
  float* yp;      // Y at this lane's first column
  int tbase;      // the tile's first row
  int tile, tw, nvec, nrows;
  bool live;      // the lane's columns lie inside X
  bool fast;      // the round's list is segmented
};

// A row's sum that no other group adds to in this round: into the tile
// (plain load and store) where the list is segmented and the row in the
// tile, else into Y with a global atomic.
template <int V>
__device__ __forceinline__ void add_run(const WholeOut& o, int row, const float (&acc)[V]) {
  const unsigned t = (unsigned)(row - o.tbase);
  if (o.fast && t < (unsigned)o.tile) {
    float* p = o.ytile + (size_t)t * o.tw;
    float v[V];
    load_v<V>(p, v);
#pragma unroll
    for (int u = 0; u < V; ++u) v[u] += acc[u];
    store_v<V>(p, v);
  } else if (o.live && (unsigned)row < (unsigned)o.nrows) {
    red_add<V>(o.yp + (size_t)row * o.nvec, acc);
  }
}

// Add the tile's nonzero rows into Y (tile rows tbase, tbase + 1, ...) and,
// where `clear`, zero the tile: each thread reads and clears its own
// V-column pieces.
template <int V>
__device__ __forceinline__ void flush_tile(float* ytile, const WholeGeom& g, int col_tile,
                                           int tbase, bool clear) {
  const int per_row = g.tw / V;
  for (int i = threadIdx.x; i < g.tile * per_row; i += blockDim.x) {
    const int row = i / per_row, q = i - row * per_row;
    const int col = col_tile * g.tw + q * V;
    float* t = ytile + (size_t)row * g.tw + q * V;
    float v[V];
    load_v<V>(t, v);
    bool nz = false;
#pragma unroll
    for (int u = 0; u < V; ++u) nz |= v[u] != 0.f;
    if (!nz) continue;
    if (col < g.nvec && tbase + row < g.nrows) {
      red_add<V>(g.y + (size_t)(tbase + row) * g.nvec + col, v);
    }
    if (clear) {
      const float z[V] = {};
      store_v<V>(t, z);
    }
  }
}

// The r counts of a block's kept lanes, 16-bit fields two to a word: row lr
// in word lr / 2, bits 16 (lr % 2) up.
template <int R, int C>
__device__ __forceinline__ void row_counts(uint32_t kept, uint32_t (&w)[(R + 1) / 2]) {
  constexpr uint32_t kRow = (1u << C) - 1u;
#pragma unroll
  for (int i = 0; i < (R + 1) / 2; ++i) w[i] = 0u;
#pragma unroll
  for (int lr = 0; lr < R; ++lr) {
    w[lr >> 1] += (uint32_t)__popc((kept >> (lr * C)) & kRow) << (16 * (lr & 1));
  }
}

// A staged block as a policy's block() reads it: its kept lanes (set, and
// the column below X's rows; 0 for padding) and its first row.
struct WholeBlock {
  uint32_t kept;
  int y;
};

// The last nonempty block's row of a and b (b after a): b's where it has one.
__device__ __forceinline__ int last_row(int a, int b) { return b >= 0 ? b : a; }

// List the kept lanes of the round's nbk staged blocks (ordered by (lr,
// block, lane), see the top of this file) into list, at most `room`; returns
// the entries listed. `segmented` is set where every nonempty block's row
// equals the previous nonempty block's or lies r or more past it, so each
// row is one contiguous segment of the list. Barriers: one after the
// totals, one a batch of blockDim blocks, and one that also tells
// `segmented`; the walk may start right after.
template <class P, int R, int C>
__device__ __forceinline__ int build_list(const unsigned char* st, const typename P::Args& a,
                                          int nbk, int4* list, int room, int* scratch,
                                          bool& segmented) {
  constexpr int W = (R + 1) / 2;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = (int)(blockDim.x >> 5);
  // pass 1: the totals of each lr over the round
  uint32_t tot[W];
#pragma unroll
  for (int i = 0; i < W; ++i) tot[i] = 0u;
  for (int b = threadIdx.x; b < nbk; b += blockDim.x) {
    uint32_t w[W];
    row_counts<R, C>(P::template block<R, C>(st, a, b).kept, w);
#pragma unroll
    for (int i = 0; i < W; ++i) tot[i] += w[i];
  }
#pragma unroll
  for (int i = 0; i < W; ++i) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) tot[i] += __shfl_xor_sync(0xffffffffu, tot[i], off);
  }
  if (lane == 0) {
#pragma unroll
    for (int i = 0; i < W; ++i) scratch[warp * 8 + i] = (int)tot[i];
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < W; ++i) tot[i] = 0u;
  for (int wp = 0; wp < nwarps; ++wp) {
#pragma unroll
    for (int i = 0; i < W; ++i) tot[i] += (uint32_t)scratch[wp * 8 + i];
  }
  int base[R];
  int total = 0;
#pragma unroll
  for (int lr = 0; lr < R; ++lr) {
    base[lr] = total;
    total += (int)((tot[lr >> 1] >> (16 * (lr & 1))) & 0xffffu);
  }
  // pass 2: each block's place, batch by batch of blockDim blocks
  uint32_t carry[W];
#pragma unroll
  for (int i = 0; i < W; ++i) carry[i] = 0u;
  int carry_y = -1;
  bool ok = true;
  int area = 1;
  for (int b0 = 0; b0 < nbk; b0 += blockDim.x, area ^= 1) {
    int* sc = scratch + area * 16 * 8;
    const int b = b0 + (int)threadIdx.x;
    const WholeBlock blk = b < nbk ? P::template block<R, C>(st, a, b) : WholeBlock{0u, -1};
    uint32_t mine[W], w[W];
    row_counts<R, C>(blk.kept, mine);
    const int my_y = blk.kept != 0u ? blk.y : -1;
    int ly = my_y;
#pragma unroll
    for (int i = 0; i < W; ++i) w[i] = mine[i];
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
#pragma unroll
      for (int i = 0; i < W; ++i) {
        const uint32_t t = __shfl_up_sync(0xffffffffu, w[i], off);
        if (lane >= off) w[i] += t;
      }
      const int t = __shfl_up_sync(0xffffffffu, ly, off);
      if (lane >= off) ly = last_row(t, ly);
    }
    int before_y = __shfl_up_sync(0xffffffffu, ly, 1);  // the warp's, before this lane
    if (lane == 0) before_y = -1;
    if (lane == 31) {
#pragma unroll
      for (int i = 0; i < W; ++i) sc[warp * 8 + i] = (int)w[i];
      sc[warp * 8 + 4] = ly;
    }
    __syncthreads();
    uint32_t pre[W];
#pragma unroll
    for (int i = 0; i < W; ++i) pre[i] = carry[i] + w[i] - mine[i];
    int prev_y = carry_y;
    for (int wp = 0; wp < nwarps; ++wp) {
      const int wy = sc[wp * 8 + 4];
#pragma unroll
      for (int i = 0; i < W; ++i) {
        const uint32_t t = (uint32_t)sc[wp * 8 + i];
        carry[i] += t;
        if (wp < warp) pre[i] += t;
      }
      if (wp < warp) prev_y = last_row(prev_y, wy);
      carry_y = last_row(carry_y, wy);
    }
    prev_y = last_row(prev_y, before_y);
    if (my_y >= 0) {
      if (prev_y >= 0 && my_y != prev_y && my_y < prev_y + R) ok = false;
      int pos[R];
#pragma unroll
      for (int lr = 0; lr < R; ++lr) {
        pos[lr] = base[lr] + (int)((pre[lr >> 1] >> (16 * (lr & 1))) & 0xffffu);
      }
      P::template emit<R, C>(st, a, b, blk.kept, pos, list, room);
    }
  }
  segmented = __syncthreads_and(ok) != 0;
  return total < room ? total : room;
}

// Walk entries [s, e) of the round's n listed ones with this lane's group,
// four at a time (an empty slot of the last batch loads the last entry's X
// row again), summing row runs in registers, and hand each run on (the top
// of this file): to add_run, or to the group's A or B slot. Writes the
// group's slot header.
template <int V>
__device__ __forceinline__ void walk_range(const int4* list, int n, int s, int e,
                                           const float* xp, const WholeOut& o, int4* head,
                                           bool leader) {
  constexpr int kBatch = 4;
  if (s >= e) {
    if (leader) *head = make_int4(-2, 1, -1, 0);  // nothing: the chains pass it by
    return;
  }
  const bool from_prev = o.fast && s > 0 && list[s - 1].z == list[s].z;
  const bool into_next = o.fast && e < n && list[e].z == list[e - 1].z;
  int cur = -1, row_a = -1, cont_a = 0, row_b = -1;
  bool first = true;
  float acc[V];
#pragma unroll
  for (int u = 0; u < V; ++u) acc[u] = 0.f;
  for (int i = s; i < e; i += kBatch) {
    int4 w[kBatch];
    float x[kBatch][V];
#pragma unroll
    for (int j = 0; j < kBatch; ++j) w[j] = list[min(i + j, e - 1)];
#pragma unroll
    for (int j = 0; j < kBatch; ++j) load_row<V>(xp + w[j].y, x[j]);
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      if (i + j >= e) break;
      if (w[j].z != cur) {
        if (cur >= 0) {  // a run that is not the range's last
          if (first && from_prev) {
            store_v<V>(o.slots, acc);
            row_a = cur;
          } else {
            add_run<V>(o, cur, acc);
          }
          first = false;
        }
        cur = w[j].z;
#pragma unroll
        for (int u = 0; u < V; ++u) acc[u] = 0.f;
      }
      const float v = __int_as_float(w[j].x);
#pragma unroll
      for (int u = 0; u < V; ++u) acc[u] = fmaf(v, x[j][u], acc[u]);
    }
  }
  if (first && from_prev) {
    store_v<V>(o.slots, acc);
    row_a = cur;
    cont_a = into_next;
  } else if (into_next) {
    store_v<V>(o.slots + o.tw, acc);
    row_b = cur;
  } else {
    add_run<V>(o, cur, acc);
  }
  if (leader) *head = make_int4(row_a, cont_a, row_b, 0);
}

// After the walk's barrier: a group holding a B slot adds it and the A slots
// of the groups after it that carry the same row (in group order, passing
// empty ranges by) into the tile or Y. Every such row has one chain, so no
// two threads add into one place.
template <int V>
__device__ __forceinline__ void reduce_slots(const float* slots, const int4* heads, int grp,
                                             int groups, int jv, const WholeOut& o) {
  const int4 h = heads[grp];
  if (h.z < 0) return;
  float sum[V];
  load_v<V>(slots + (size_t)(2 * grp + 1) * o.tw + jv, sum);
  for (int g = grp + 1; g < groups; ++g) {
    const int4 n = heads[g];
    if (n.x == -2) continue;
    if (n.x != h.z) break;  // never on a segmented list
    float v[V];
    load_v<V>(slots + (size_t)(2 * g) * o.tw + jv, v);
#pragma unroll
    for (int u = 0; u < V; ++u) sum[u] += v[u];
    if (!n.y) break;
  }
  add_run<V>(o, h.z, sum);
}

// The kernel. blockIdx.x = range * ntiles + column tile.
template <class P, int R, int C, int V>
__global__ void __launch_bounds__(512, 2) spmm_whole_kernel(const typename P::Args a) {
  extern __shared__ __align__(16) unsigned char wsmem[];
  const WholeGeom& g = a.g;
  const WholeLayout L = whole_layout(g, P::stage_bytes(a), (int)blockDim.x);
  float* ytile = reinterpret_cast<float*>(wsmem);
  float* slots = reinterpret_cast<float*>(wsmem + L.slots);
  int4* heads = reinterpret_cast<int4*>(wsmem + L.heads);
  int* scratch = reinterpret_cast<int*>(wsmem + L.scratch);
  int4* list = reinterpret_cast<int4*>(wsmem + L.list);
  unsigned char* ring = wsmem + L.ring;

  const int col_tile = (int)(blockIdx.x % g.ntiles), range = (int)(blockIdx.x / g.ntiles);
  const int c0 = (int)((long long)range * g.nchunks / g.grid);
  const int n = (int)((long long)(range + 1) * g.nchunks / g.grid) - c0;
  const int lg = __ffs(g.tw / V) - 1;  // log2 of the lanes of a group
  const int grp = (int)(threadIdx.x >> lg), groups = (int)(blockDim.x >> lg);
  const int jv = (int)(threadIdx.x & ((1u << lg) - 1u)) * V;
  const int col0 = col_tile * g.tw + jv;
  WholeOut o;
  o.live = col0 < g.nvec;
  o.ytile = ytile + jv;
  o.slots = slots + (size_t)(2 * grp) * g.tw + jv;
  o.yp = g.y + (o.live ? col0 : 0);
  o.tbase = -1;
  o.tile = g.tile;
  o.tw = g.tw;
  o.nvec = g.nvec;
  o.nrows = g.nrows;
  const float* xp = g.x + (o.live ? col0 : 0);  // an idle lane reads column 0

  for (int i = threadIdx.x; i < L.slots / 16; i += blockDim.x) {
    reinterpret_cast<float4*>(ytile)[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  if (threadIdx.x == 0) {
    for (int s = 0; s < g.stages; ++s) {
      mbar_init(reinterpret_cast<uint64_t*>(ring + s * L.stage + P::bar_offset(a)));
    }
    mbar_fence_init();
  }
  __syncthreads();  // the barriers are initialised and the tile zeroed

  // round k: q whole chunks from c0 + k q on, or slice k % slices of chunk
  // c0 + k / slices
  const int slices = g.nb < g.cb ? (g.cb + g.nb - 1) / g.nb : 1;
  const int rounds = slices > 1 ? n * slices : (n + g.q - 1) / g.q;
  auto fill = [&](unsigned char* st, int k) {
    if (slices > 1) {
      const int b0 = (k % slices) * g.nb;
      P::fill(st, a, (size_t)c0 + k / slices, b0, min(g.nb, g.cb - b0), 1, b0 == 0);
    } else {
      const int qn = min(g.q, n - k * g.q);
      P::fill(st, a, (size_t)c0 + (size_t)k * g.q, 0, qn * g.cb, qn, true);
    }
  };
  auto blocks = [&](int k) {
    return slices > 1 ? min(g.nb, g.cb - (k % slices) * g.nb) : min(g.q, n - k * g.q) * g.cb;
  };
  if (g.stages == 2) fill(ring, 0);  // n >= 1: grid <= nchunks
  cp_async_commit();
  uint32_t parity = 0;  // bit s: the parity of stage s's next phase
  for (int k = 0; k < rounds; ++k) {
    const int s = g.stages == 2 ? (k & 1) : 0;
    unsigned char* st = ring + s * L.stage;
    if (g.stages == 1) {  // the previous round's list is built: the stage is free
      fill(st, k);
      cp_async_commit();
    }
    cp_async_wait<0>();  // round k's cp.async pieces of this thread
    mbar_wait(reinterpret_cast<uint64_t*>(st + P::bar_offset(a)), (parity >> s) & 1u);
    parity ^= 1u << s;
    __syncthreads();  // ... everyone's; the previous round's slots are added
    if (g.stages == 2 && k + 1 < rounds) fill(ring + (s ^ 1) * L.stage, k + 1);
    cp_async_commit();
    const int r0 = P::first_row(st, a);
    if (o.tbase < 0 || (unsigned)(r0 - o.tbase) >= (unsigned)((g.tile + 1) >> 1)) {
      if (o.tbase >= 0) flush_tile<V>(ytile, g, col_tile, o.tbase, true);
      o.tbase = r0;  // the list's barriers order the flush before the walk
    }
    bool fast;
    const int nl = build_list<P, R, C>(st, a, blocks(k), list, L.room, scratch, fast);
    o.fast = fast;
    const int s0 = (int)((long long)grp * nl / groups);
    const int e0 = (int)((long long)(grp + 1) * nl / groups);
    walk_range<V>(list, nl, s0, e0, xp, o, heads + grp, jv == 0);
    __syncthreads();  // every group's slots and headers
    if (fast) reduce_slots<V>(slots, heads, grp, groups, jv, o);
  }
  __syncthreads();
  flush_tile<V>(ytile, g, col_tile, o.tbase, false);
}

// The launch checks both kernels share, given the policy's stage bytes:
// false where the geometry is one the kernel does not take.
inline bool whole_geom_ok(const WholeGeom& g, int threads) {
  const int lanes = g.vec > 0 ? g.tw / g.vec : 0;
  return g.nchunks >= 1 && g.cb >= 1 && g.vmax >= 4 && g.vmax % 4 == 0 && g.nvec >= 1 &&
         g.nrows >= 1 && g.xrows >= 0 && (g.vec == 1 || g.vec == 2 || g.vec == 4) &&
         lanes >= 1 && lanes <= 32 && (lanes & (lanes - 1)) == 0 && lanes * g.vec == g.tw &&
         g.nvec % g.vec == 0 && g.ntiles == (g.nvec + g.tw - 1) / g.tw && g.grid >= 1 &&
         g.grid <= g.nchunks && (long long)g.grid * g.ntiles <= 0x7fffffffLL &&
         (g.stages == 1 || g.stages == 2) && g.q >= 1 && g.nb >= 1 &&
         (g.q > 1 ? g.nb == g.q * g.cb : g.nb <= g.cb) && (g.stages == 1 || g.nb == g.q * g.cb) &&
         (long long)g.nb * g.c < 65536 && g.tile >= 1 && threads >= 32 && threads <= 512 &&
         (threads & (threads - 1)) == 0 && threads >= lanes;
}

}  // namespace
