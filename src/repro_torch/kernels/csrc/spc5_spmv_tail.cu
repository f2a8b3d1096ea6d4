// The singleton tail of the beta(r,c)_test split for Hopper (sm_90a): the
// blocks with one nonzero, as COO sorted into one bucket per row panel
// ((npanels, smax) arrays of panel-local rows, columns and values, each
// bucket sorted by (local row, column) and padded at its end with zero
// values at local row 0 and column 0).
//
// Two kernels:
//   spc5_spmv_tail  <- spmv_tail_pallas (_spmv_tail_kernel) of
//                      src/repro/kernels/spc5_spmv.py
//   spc5_spmm_tail  <- no TPU kernel: the reference computes the SpMM tail
//                      with the jnp spmm_coo (src/repro/core/ref_spmv.py,
//                      called from src/repro/core/plan.py's
//                      _lower_spmm_test); added because it took most of the
//                      test layer's SpMM time as plain PyTorch.
//
// SpMV (spmv_tail_kernel) computes what the Pallas kernel computes: for
// each bucket p and each of its smax slots, y[p*pr + clip(row, 0, pr-1)] +=
// val * x[xbase[p] + clip(col - xbase[p], 0, xw-1)], x zero past its end, y
// cut at nrows. Padding slots are multiplied like any other, as the
// reference multiplies them. Bound: memory, 12 bytes a slot read once and 2
// flops; x (4,096 floats on the vocab layer) stays in L1. The design:
//   * split buckets: each bucket's slots are cut into S contiguous ranges of
//     whole groups of kGroup slots, one CTA each (S from the card's
//     occupancy, chosen by the wrapper); a bucket sorted by (row, column)
//     gives each CTA a contiguous row range. Small CTAs, several an SM;
//   * 16-byte loads: lane l of a warp takes four neighbouring slots (one
//     int4 / float4 of each array) of a 128-slot step, so a warp reads 512
//     contiguous bytes of each array per load; a CTA's ranges start anywhere
//     (a bucket starts at p*smax), so the steps run on the arrays' own
//     16-byte quads and slots outside the range are masked (4-byte loads
//     where an array is not 16-byte aligned). The loads are marked
//     evict-first (ld.global.cs), and a warp takes one step at a time at
//     32 registers, so that an SM holds 64 warps; on the H100 the read-only
//     path, two or four steps loaded together, and the next step's loads
//     issued before the current step's sums were each slower (PERF.md, section 6);
//   * runs combined in the warp: a row holds about 125 slots on the vocab
//     layer, so a row ends in almost every 128-slot step and a run carried
//     across steps would be flushed at once. Instead each lane sums its four
//     slots by row (the first and last row of its quad, and any row wholly
//     inside it), and a segmented shuffle scan by row over the lanes' last
//     rows sums each row of the step into one lane; that lane adds it into
//     y with one global atomic (a zeroed y; rows are added by the few CTAs
//     and steps that hold them, never by a shared-memory float atomic, which
//     is a compare-and-swap loop on this card). A step whose rows do not
//     come sorted (padding after a bucket's last row, or a permuted bucket)
//     adds each slot into y on its own, so any row order is right.
// The f32 sum of a row is taken in another order than the reference's, and
// through global atomics in an order that varies from run to run.
//
// SpMM (spmm_tail_kernel<V>) computes what the test layout's SpMM computes
// for a bucketed tail: Y[p*pr + row, :] += val * X[col, :] over every slot,
// no column clip and no x window (the reference's jnp path), Y cut at nrows.
// It skips slots of value 0 (the padding) and slots whose column lies
// outside X, reading nothing of X for them: a deliberate difference from
// spmm_coo, which multiplies the padding (Y differs only where X holds inf or
// NaN at such a column). Bound: the bucket bytes at nvec 16, the X rows
// gathered from L2 (nvec * 4 bytes a slot) at nvec 128. The buckets already
// list the nonzeros sorted by row, which is what the whole-vector SpMM
// kernels build once a round (spc5_spmm_whole.cuh), so this kernel reuses
// that skeleton's walk, group combine and Y tile:
//   * grid: G contiguous ranges of the flattened slots (whole groups of
//     kGroup slots, G from the card's occupancy) times column tiles of up to
//     128 columns; the tiles of one range take neighbouring blockIdx values;
//   * rounds of 4 * blockDim slots: every thread stages its own quad of each
//     array with cp.async (16 bytes, or 4-byte pieces where not aligned), a
//     round ahead of its use, into a slot of shared memory only it reads;
//   * the list: each thread turns its kept slots into the skeleton's entries
//     (value, X offset col * nvec, global row), placed by a CTA-wide scan of
//     the counts, and checks with a running maximum of the rows that the
//     round's entries come sorted ("segmented", else every run goes to Y by
//     global atomics);
//   * the walk (walk_range), the slots of runs cut between lane groups
//     (reduce_slots) and the Y tile of `tile` rows flushed into Y by one
//     global atomic per row and column (flush_tile), as in the whole-vector
//     kernels: one writer per Y-tile row, no shared float atomic.
//
// Each launcher runs on the caller's stream, allocates nothing, does not
// synchronise, refuses a launch other than the wrapper's plan (grid,
// threads, shared-memory figure) with cudaErrorInvalidValue, and returns
// cudaGetLastError() (0 on success).

#include "spc5_spmm_whole.cuh"
#include "spc5_stage.cuh"

namespace {

// Slots of a group, the unit both grids cut: one warp step of the SpMV
// kernel (32 lanes x 4 slots).
constexpr int kGroup = 128;
constexpr unsigned kFull = 0xffffffffu;
// Keys of masked slots: before the CTA's range, and after it. They keep a
// sorted step sorted and are never added.
constexpr int kBefore = -1;
constexpr int kAfter = 0x7fffffff;

__host__ __device__ inline int tail_groups(long long slots) {
  return (int)((slots + kGroup - 1) / kGroup);
}

// A quad of an array: one 16-byte load where the arrays are so aligned
// (a quad that holds a slot of the array lies in the array's 16-byte piece,
// so it is read whole), else the slots of [lo, hi) one by one, the others 0.
__device__ __forceinline__ void load_quad(const int* p, int q, bool wide, int lo, int hi,
                                          int (&out)[4]) {
  if (wide) {
    const int4 v = __ldcs(reinterpret_cast<const int4*>(p) + q);
    out[0] = v.x;
    out[1] = v.y;
    out[2] = v.z;
    out[3] = v.w;
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j) out[j] = 4 * q + j >= lo && 4 * q + j < hi ? __ldcs(p + 4 * q + j) : 0;
  }
}

__device__ __forceinline__ void load_quad(const float* p, int q, bool wide, int lo, int hi,
                                          float (&out)[4]) {
  if (wide) {
    const float4 v = __ldcs(reinterpret_cast<const float4*>(p) + q);
    out[0] = v.x;
    out[1] = v.y;
    out[2] = v.z;
    out[3] = v.w;
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      out[j] = 4 * q + j >= lo && 4 * q + j < hi ? __ldcs(p + 4 * q + j) : 0.f;
    }
  }
}

// ---------------------------------------------------------------------------
// SpMV: S CTAs a bucket, four slots a lane, rows combined in the warp
// ---------------------------------------------------------------------------

struct TailArgs {
  const int* xbase;  // (npanels,) each bucket's x window start
  const int* rows;   // (npanels, smax) panel-local rows
  const int* cols;   // (npanels, smax) columns
  const float* vals;
  const float* x;    // (ncols,), read in place
  float* y;          // (nrows,), zeroed
  int npanels, smax, pr, xw, nrows, ncols;
  int split;  // S: CTAs a bucket, each a contiguous range of its groups
};

// Add v into y at the panel's row `key` (0 <= key < nout: the rows the
// panel holds inside y), where it is not a masked slot's key and not 0.
__device__ __forceinline__ void emit(float* yp, int nout, int key, float v) {
  if ((unsigned)key < (unsigned)nout && v != 0.f) atomicAdd(yp + key, v);
}

// One step of a warp: lane l holds four neighbouring slots, keys k (rows
// clipped into the panel, or kBefore / kAfter) and products v. Where every
// key comes sorted in (lane, slot) order, each row's sum of the step is
// added into y once: a lane's rows strictly between its first (kf) and last
// (kl) go in directly; the lanes' last-row sums are scanned by row (equal
// keys are neighbours, so a lane adds its left neighbour's sum at distance
// d only where their keys are equal), and the last lane of each row adds
// it, or hands it to the next lane, whose first row it is and which adds it
// with its own first-row sum. Otherwise every slot is added on its own.
__device__ __forceinline__ void combine_step(const int (&k)[4], const float (&v)[4], float* yp,
                                             int nout) {
  const int lane = threadIdx.x & 31;
  const int kf = k[0], kl = k[3];
  const int prev_kl = __shfl_up_sync(kFull, kl, 1);
  const bool sorted = k[0] <= k[1] && k[1] <= k[2] && k[2] <= k[3] && (lane == 0 || prev_kl <= kf);
  if (!__all_sync(kFull, sorted)) {
#pragma unroll
    for (int j = 0; j < 4; ++j) emit(yp, nout, k[j], v[j]);
    return;
  }
  float head = 0.f, tail = 0.f, mid = 0.f;
  int mk = kf;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    if (k[j] == kf) {
      head += v[j];
    } else if (k[j] == kl) {
      tail += v[j];
    } else {  // a row wholly inside the quad
      if (k[j] != mk) {
        if (mk != kf) emit(yp, nout, mk, mid);
        mk = k[j];
        mid = 0.f;
      }
      mid += v[j];
    }
  }
  if (mk != kf) emit(yp, nout, mk, mid);
  const bool single = kf == kl;  // the quad is one row: its sum is in head
  float s = single ? head : tail;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const float sd = __shfl_up_sync(kFull, s, d);
    const int kd = __shfl_up_sync(kFull, kl, d);
    if (lane >= d && kd == kl) s += sd;
  }
  const int next_kf = __shfl_down_sync(kFull, kf, 1);
  const float prev_s = __shfl_up_sync(kFull, s, 1);
  if (lane == 31 || next_kf != kl) emit(yp, nout, kl, s);
  if (!single) emit(yp, nout, kf, head + (lane > 0 && prev_kl == kf ? prev_s : 0.f));
}

// 32 registers a thread, so that an SM holds 2,048 threads
__global__ void __launch_bounds__(512, 4) spmv_tail_kernel(const TailArgs a) {
  const int p = (int)(blockIdx.x / a.split), part = (int)(blockIdx.x % a.split);
  const int ngroups = tail_groups(a.smax);
  const int g0 = (int)((long long)part * ngroups / a.split);
  const int g1 = (int)((long long)(part + 1) * ngroups / a.split);
  // slots [lo, hi) of the flattened buckets (fewer than 2^31: checked)
  const int base = p * a.smax;
  const int lo = base + g0 * kGroup;
  const int hi = base + min(g1 * kGroup, a.smax);
  const int q0 = lo >> 2, q1 = (hi + 3) >> 2;  // the quads holding [lo, hi)
  const int nsteps = (q1 - q0 + 31) >> 5;
  const bool wide = ((reinterpret_cast<uintptr_t>(a.rows) | reinterpret_cast<uintptr_t>(a.cols) |
                      reinterpret_cast<uintptr_t>(a.vals)) & 15) == 0;
  const int xb = __ldg(a.xbase + p);
  float* yp = a.y + (size_t)p * a.pr;
  const int nout = min(a.pr, a.nrows - p * a.pr);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, warps = blockDim.x >> 5;
  // warp w takes steps w, w + warps, ...
  for (int t = warp; t < nsteps; t += warps) {
    const int q = q0 + t * 32 + lane;
    int row[4] = {0, 0, 0, 0}, col[4] = {0, 0, 0, 0};
    float val[4] = {0.f, 0.f, 0.f, 0.f};
    if (q < q1) {
      load_quad(a.rows, q, wide, lo, hi, row);
      load_quad(a.cols, q, wide, lo, hi, col);
      load_quad(a.vals, q, wide, lo, hi, val);
    }
    int key[4];
    float prod[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int s = 4 * q + j;
      if (s < lo) {
        key[j] = kBefore;
        prod[j] = 0.f;
      } else if (s >= hi) {
        key[j] = kAfter;
        prod[j] = 0.f;
      } else {
        key[j] = min(max(row[j], 0), a.pr - 1);
        const int xi = xb + min(max(col[j] - xb, 0), a.xw - 1);
        const float xv = (unsigned)xi < (unsigned)a.ncols ? __ldg(a.x + xi) : 0.f;
        prod[j] = val[j] * xv;
      }
    }
    combine_step(key, prod, yp, nout);
  }
}

// The SpMV tail launch's checks: the wrapper's S (1 .. the groups of a
// bucket), threads (whole warps, 32 .. 512) and shared memory (none).
int launch_spmv_tail(const TailArgs& a, int threads, int smem, int device, void* stream) {
  if (a.npanels < 1 || a.smax < 1 || a.pr < 1 || a.xw < 1 || a.nrows < 0 || a.ncols < 0 ||
      (long long)a.npanels * a.smax > 0x7fffffffLL - 4 * kGroup || a.split < 1 ||
      a.split > tail_groups(a.smax) ||
      (long long)a.npanels * a.split > 0x7fffffffLL || threads < 32 || threads > 512 ||
      threads % 32 != 0 || smem != 0) {
    return (int)cudaErrorInvalidValue;
  }
  cudaError_t err = prepare_launch(spmv_tail_kernel, device, 0, threads, nullptr);
  if (err != cudaSuccess) return (int)err;
  spmv_tail_kernel<<<a.npanels * a.split, threads, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// SpMM: G slot ranges x column tiles, per-thread staged quads, the
// whole-vector skeleton's list walk and Y tile
// ---------------------------------------------------------------------------

struct SpmmTailArgs {
  WholeGeom g;  // x, y, nrows, xrows, nvec, tw, vec, ntiles, grid (G), tile; the rest unused
  const int* rows;  // (npanels, smax) panel-local rows
  const int* cols;  // (npanels, smax) columns (rows of X)
  const float* vals;
  int npanels, smax, pr;
};

// Byte offsets of the CTA's shared memory, each 16-byte aligned: the (tile,
// tw) Y tile at 0, the groups' A and B slots (tw floats each) and headers
// (an int4 a group), the warps' scan totals (an int4 a warp), the list (an
// entry of 16 bytes for each of a round's 4 * threads slots), then each
// thread's staged quad of rows, columns and values (48 bytes a thread). The
// wrapper reckons the same (kernels/spc5_spmv_tail.py: spmm_tail_smem_bytes).
struct TailLayout {
  int slots, heads, scratch, list, stage, bytes;
};

__host__ __device__ inline TailLayout tail_layout(int tw, int vec, int tile, int threads) {
  const int lanes = vec > 0 ? tw / vec : 1;
  const int groups = lanes > 0 ? threads / lanes : 0;
  TailLayout L;
  L.slots = wr16(4 * tile * tw);
  L.heads = L.slots + wr16(8 * groups * tw);
  L.scratch = L.heads + 16 * groups;
  L.list = L.scratch + 16 * (threads / 32);
  L.stage = L.list + 64 * threads;
  L.bytes = L.stage + 48 * threads;
  return L;
}

// Stage this thread's quad q of each array (slots outside the arrays are
// not copied) into its own 16 bytes of rows, columns and values.
__device__ __forceinline__ void stage_quad(int4* stage, const SpmmTailArgs& a, int q, int nslots,
                                           bool wide) {
  const int t = threadIdx.x, n = blockDim.x;
  const void* src[3] = {a.rows, a.cols, a.vals};
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    int4* dst = stage + k * n + t;
    if (wide) {
      cp_async16(dst, reinterpret_cast<const int4*>(src[k]) + q);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (4 * q + j < nslots) {
          cp_async4(reinterpret_cast<int*>(dst) + j,
                    reinterpret_cast<const int*>(src[k]) + 4 * q + j);
        }
      }
    }
  }
}

// The kernel. blockIdx.x = range * ntiles + column tile.
template <int V>
__global__ void __launch_bounds__(512, 2) spmm_tail_kernel(const SpmmTailArgs a) {
  extern __shared__ __align__(16) unsigned char tsmem[];
  const WholeGeom& g = a.g;
  const int nthreads = (int)blockDim.x, t = (int)threadIdx.x;
  const TailLayout L = tail_layout(g.tw, g.vec, g.tile, nthreads);
  float* ytile = reinterpret_cast<float*>(tsmem);
  float* slots = reinterpret_cast<float*>(tsmem + L.slots);
  int4* heads = reinterpret_cast<int4*>(tsmem + L.heads);
  int4* scratch = reinterpret_cast<int4*>(tsmem + L.scratch);
  int4* list = reinterpret_cast<int4*>(tsmem + L.list);
  int4* stage = reinterpret_cast<int4*>(tsmem + L.stage);

  const int col_tile = (int)(blockIdx.x % g.ntiles), range = (int)(blockIdx.x / g.ntiles);
  // slots [lo, hi) of the flattened buckets (fewer than 2^31: checked)
  const int nslots = a.npanels * a.smax;
  const int ngroups = tail_groups(nslots);
  const int lo = (int)((long long)range * ngroups / g.grid) * kGroup;
  const int hi = min((int)((long long)(range + 1) * ngroups / g.grid) * kGroup, nslots);
  const int q0 = lo >> 2, q1 = (hi + 3) >> 2;
  const int rounds = (q1 - q0 + nthreads - 1) / nthreads;
  const bool wide = ((reinterpret_cast<uintptr_t>(a.rows) | reinterpret_cast<uintptr_t>(a.cols) |
                      reinterpret_cast<uintptr_t>(a.vals)) & 15) == 0;

  const int lg = __ffs(g.tw / V) - 1;  // log2 of the lanes of a group
  const int grp = t >> lg, groups = nthreads >> lg;
  const int jv = (t & ((1 << lg) - 1)) * V;
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
  const int lane = t & 31, warp = t >> 5, warps = nthreads >> 5;

  for (int i = t; i < L.slots / 16; i += nthreads) {
    reinterpret_cast<float4*>(ytile)[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  if (q0 + t < q1) stage_quad(stage, a, q0 + t, nslots, wide);
  cp_async_commit();
  // (the first round's B1 barrier orders the tile's zeroing before its use)

  for (int k = 0; k < rounds; ++k) {
    const int q = q0 + k * nthreads + t;
    cp_async_wait<0>();  // this thread's quad of round k
    // pass 1 over the quad: the kept slots' count, first and last rows, and
    // whether they come sorted
    int cnt = 0, fk = kAfter, lk = kBefore;
    bool ok = true;
    if (q < q1) {
      const int4 r4 = stage[t], c4 = stage[nthreads + t], v4 = stage[2 * nthreads + t];
      const int rr[4] = {r4.x, r4.y, r4.z, r4.w};
      const int cc[4] = {c4.x, c4.y, c4.z, c4.w};
      const int vv[4] = {v4.x, v4.y, v4.z, v4.w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int s = 4 * q + j;
        const int key = s / a.smax * a.pr + rr[j];  // the global row
        if (s >= lo && s < hi && __int_as_float(vv[j]) != 0.f &&
            (unsigned)cc[j] < (unsigned)g.xrows) {
          ok = ok && key >= lk;
          if (cnt == 0) fk = key;
          lk = key;
          ++cnt;
        }
      }
    }
    // the warp's counts (inclusive) and running maximum of the last rows
    int incl = cnt, mx = lk;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int c = __shfl_up_sync(kFull, incl, d);
      const int m = __shfl_up_sync(kFull, mx, d);
      if (lane >= d) {
        incl += c;
        mx = max(mx, m);
      }
    }
    int before = __shfl_up_sync(kFull, mx, 1);  // the warp's lanes before this one
    if (lane == 0) before = kBefore;
    const unsigned any = __ballot_sync(kFull, cnt > 0);
    const int wfirst = __shfl_sync(kFull, fk, any ? __ffs(any) - 1 : 0);
    if (lane == 31) scratch[warp] = make_int4(incl, mx, any ? wfirst : kAfter, 0);
    __syncthreads();  // B1: the warps' totals; the previous round is added
    int pos = incl - cnt, total = 0, r0 = kAfter;
    for (int w = 0; w < warps; ++w) {
      const int4 s = scratch[w];
      if (w < warp) {
        pos += s.x;
        before = max(before, s.y);
      }
      if (r0 == kAfter && s.x > 0) r0 = s.z;
      total += s.x;
    }
    ok = ok && (cnt == 0 || fk >= before);
    if (total > 0 && (o.tbase < 0 || (unsigned)(r0 - o.tbase) >= (unsigned)((g.tile + 1) >> 1))) {
      if (o.tbase >= 0) flush_tile<V>(ytile, g, col_tile, o.tbase, true);
      o.tbase = r0;  // B2 orders the flush before the walk
    }
    // pass 2: the kept slots' entries, read from the staged quad again
    if (cnt > 0) {
      const int4 r4 = stage[t], c4 = stage[nthreads + t], v4 = stage[2 * nthreads + t];
      const int rr[4] = {r4.x, r4.y, r4.z, r4.w};
      const int cc[4] = {c4.x, c4.y, c4.z, c4.w};
      const int vv[4] = {v4.x, v4.y, v4.z, v4.w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int s = 4 * q + j;
        if (s >= lo && s < hi && __int_as_float(vv[j]) != 0.f &&
            (unsigned)cc[j] < (unsigned)g.xrows) {
          list[pos++] = make_int4(vv[j], cc[j] * g.nvec, s / a.smax * a.pr + rr[j], 0);
        }
      }
    }
    // the quad's values are stored: its slot takes the next round's (the
    // stores above wait on the loads; the asm keeps the compiler's order)
    asm volatile("" ::: "memory");
    if (k + 1 < rounds && q + nthreads < q1) stage_quad(stage, a, q + nthreads, nslots, wide);
    cp_async_commit();
    const bool fast = __syncthreads_and(ok) != 0;  // B2: the list
    o.fast = fast;
    const int s0 = (int)((long long)grp * total / groups);
    const int e0 = (int)((long long)(grp + 1) * total / groups);
    walk_range<V>(list, total, s0, e0, xp, o, heads + grp, jv == 0);
    __syncthreads();  // B3: every group's slots and headers
    if (fast) reduce_slots<V>(slots, heads, grp, groups, jv, o);
  }
  __syncthreads();
  if (o.tbase >= 0) flush_tile<V>(ytile, g, col_tile, o.tbase, false);
}

using SpmmTailKernel = void (*)(SpmmTailArgs);

SpmmTailKernel spmm_tail_kernel_of(int vec) {
  switch (vec) {
    case 1: return spmm_tail_kernel<1>;
    case 2: return spmm_tail_kernel<2>;
    case 4: return spmm_tail_kernel<4>;
    default: return nullptr;
  }
}

// The SpMM tail launch's checks: the geometry the kernel takes, the
// wrapper's G (1 .. the groups of all slots), threads and shared memory.
int launch_spmm_tail(const SpmmTailArgs& a, int threads, int smem, int device, void* stream) {
  const WholeGeom& g = a.g;
  const SpmmTailKernel kernel = spmm_tail_kernel_of(g.vec);
  const int lanes = g.vec > 0 ? g.tw / g.vec : 0;
  const long long nslots = (long long)a.npanels * a.smax;
  if (kernel == nullptr || a.npanels < 1 || a.smax < 1 || a.pr < 1 || nslots > 0x7fffffffLL - 4 * kGroup ||
      g.nrows < 1 || g.xrows < 0 || g.nvec < 1 || lanes < 1 || lanes > 32 ||
      (lanes & (lanes - 1)) != 0 || lanes * g.vec != g.tw || g.nvec % g.vec != 0 ||
      g.ntiles != (g.nvec + g.tw - 1) / g.tw || g.grid < 1 || g.grid > tail_groups(nslots) ||
      (long long)g.grid * g.ntiles > 0x7fffffffLL || g.tile < 1 || threads < 32 ||
      threads > 512 || (threads & (threads - 1)) != 0 || threads < lanes ||
      tail_layout(g.tw, g.vec, g.tile, threads).bytes != smem) {
    return (int)cudaErrorInvalidValue;
  }
  cudaError_t err = prepare_launch(kernel, device, (size_t)smem, threads, nullptr);
  if (err != cudaSuccess) return (int)err;
  void* args[] = {const_cast<SpmmTailArgs*>(&a)};
  err = cudaLaunchKernel(reinterpret_cast<const void*>(kernel), dim3(g.grid * g.ntiles),
                         dim3(threads), args, (size_t)smem, (cudaStream_t)stream);
  return (int)(err != cudaSuccess ? err : cudaGetLastError());
}

// (CTAs one SM holds at once, SMs) of `kernel` at `threads` and `smem`.
template <typename Kernel>
int occupancy(Kernel kernel, int threads, int smem, int device, int* out) {
  cudaError_t err = prepare_launch(kernel, device, (size_t)smem, threads, nullptr);
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(out, kernel, threads, (size_t)smem);
  }
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(out + 1, cudaDevAttrMultiProcessorCount, device);
  return (int)err;
}

}  // namespace

extern "C" {

// The SpMV tail: npanels * split CTAs of `threads`, each a contiguous
// range of one bucket's groups; smem must be 0 (the kernel uses none).
int spc5_spmv_tail(const int* xbase, const int* rows, const int* cols, const float* vals,
                   const float* x, float* y, int npanels, int smax, int pr, int xw, int nrows,
                   int ncols, int split, int threads, int smem, int device, void* stream) {
  const TailArgs a{xbase, rows, cols, vals, x, y, npanels, smax, pr, xw, nrows, ncols, split};
  return launch_spmv_tail(a, threads, smem, device, stream);
}

// The SpMV tail kernel's occupancy at `threads`: out[0] the CTAs one SM
// holds at once, out[1] the SMs of the device.
int spc5_spmv_tail_occupancy(int threads, int device, int* out) {
  return occupancy(spmv_tail_kernel, threads, 0, device, out);
}

// The SpMM tail: grid * ntiles CTAs of `threads`; tiles of tw columns, vec
// a lane; a Y tile of tile_rows rows. smem is the wrapper's figure (checked).
int spc5_spmm_tail(const int* rows, const int* cols, const float* vals, const float* x, float* y,
                   int npanels, int smax, int pr, int nrows, int xrows, int nvec, int tw, int vec,
                   int grid, int tile_rows, int threads, int smem, int device, void* stream) {
  SpmmTailArgs a{};
  a.g = WholeGeom{x, y, 0, 0, 1, 1, 4, nrows, xrows, nvec, tw, vec,
                  tw > 0 ? (nvec + tw - 1) / tw : 0, grid, 1, 1, 1, tile_rows};
  a.rows = rows;
  a.cols = cols;
  a.vals = vals;
  a.npanels = npanels;
  a.smax = smax;
  a.pr = pr;
  return launch_spmm_tail(a, threads, smem, device, stream);
}

// The SpMM tail kernel's occupancy for `vec` columns a lane at `threads`
// and `smem` bytes: out[0] the CTAs one SM holds at once, out[1] the SMs.
int spc5_spmm_tail_occupancy(int vec, int threads, int smem, int device, int* out) {
  const SpmmTailKernel kernel = spmm_tail_kernel_of(vec);
  if (kernel == nullptr) return (int)cudaErrorInvalidValue;
  return occupancy(kernel, threads, smem, device, out);
}

// The dynamic shared memory of one SpMM tail CTA, as the launch computes it
// (tail_layout).
int spc5_spmm_tail_smem(int tw, int vec, int tile_rows, int threads) {
  return tail_layout(tw, vec, tile_rows, threads).bytes;
}

}  // extern "C"
