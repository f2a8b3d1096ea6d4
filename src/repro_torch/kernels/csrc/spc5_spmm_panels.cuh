// Device helpers shared by the panel SpMM kernels of spc5_spmm.cu (mask
// decode) and spc5_spmm_desc.cu (descriptor tables): both cut a panel's
// chunks among S CTAs, keep a (prows, tw) f32 Y tile of one row part in
// shared memory, rank a stage's blocks by row and hand each lane group one
// row-aligned range of them, so that every Y-tile row has one writer. A
// lane owns V = 4, 2 or 1 neighbouring columns of the tile (one 16-, 8- or
// 4-byte X load). Args is the kernel's argument struct; write_tile reads its
// y, nvec, nrows, pr, prows, tw and split.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// X at p (a row's start at this lane's first column): this lane's V
// columns, through the read-only path.
template <int V>
__device__ __forceinline__ void load_row(const float* p, float (&out)[V]) {
  if constexpr (V == 4) {
    const float4 q = __ldg(reinterpret_cast<const float4*>(p));
    out[0] = q.x;
    out[1] = q.y;
    out[2] = q.z;
    out[3] = q.w;
  } else if constexpr (V == 2) {
    const float2 q = __ldg(reinterpret_cast<const float2*>(p));
    out[0] = q.x;
    out[1] = q.y;
  } else {
    out[0] = __ldg(p);
  }
}

// Add a row run's sums into Y-tile row `row` of the CTA's row part (this
// lane's V columns at jv), which this lane's group owns: a plain load and
// store.
template <int V>
__device__ __forceinline__ void add_row(float* ytile, int row, int tw, int jv, int prows,
                                        const float (&acc)[V]) {
  if ((unsigned)row >= (unsigned)prows) return;  // never on the plans' own tables
  float* t = ytile + row * tw + jv;
  if constexpr (V == 4) {
    float4 q = *reinterpret_cast<float4*>(t);
    q.x += acc[0];
    q.y += acc[1];
    q.z += acc[2];
    q.w += acc[3];
    *reinterpret_cast<float4*>(t) = q;
  } else if constexpr (V == 2) {
    float2 q = *reinterpret_cast<float2*>(t);
    q.x += acc[0];
    q.y += acc[1];
    *reinterpret_cast<float2*>(t) = q;
  } else {
    t[0] += acc[0];
  }
}

// The range [s, e) of the n ordered items (blocks or nonzeros; info[i].z:
// the first tile row of the item's block) that lane group u of `groups`
// walks: about n / groups items, each end moved past the items of the
// block row before it, so that every row belongs to one group.
__device__ __forceinline__ int2 row_range(const int4* info, int n, int groups, int u) {
  int s = (int)((long long)u * n / groups), e = (int)((long long)(u + 1) * n / groups);
  while (s > 0 && s < n && info[s].z == info[s - 1].z) ++s;
  while (e > 0 && e < n && info[e].z == info[e - 1].z) ++e;
  return make_int2(s, e);
}

// Add (S > 1) or store (S == 1) the Y tile's rows into Y: part h of panel p.
template <int V, typename Args>
__device__ __forceinline__ void write_tile(const float* ytile, const Args& a, int p, int h,
                                           int tile, int lg) {
  const int row0 = p * a.pr + h * a.prows;  // the part's first row in Y
  const int nout = min(min(a.prows, a.pr - h * a.prows), a.nrows - row0);
  for (int i = threadIdx.x; i < (nout << lg); i += blockDim.x) {
    const int rr = i >> lg, q = i & ((1 << lg) - 1);
    const int col = tile * a.tw + q * V;
    if (col >= a.nvec) continue;
    const float* t = ytile + rr * a.tw + q * V;
    float* out = a.y + (size_t)(row0 + rr) * a.nvec + col;
    if constexpr (V == 4) {
      const float4 v = *reinterpret_cast<const float4*>(t);
      if (a.split == 1) {
        *reinterpret_cast<float4*>(out) = v;
      } else if (v.x != 0.f || v.y != 0.f || v.z != 0.f || v.w != 0.f) {
#if __CUDACC_VER_MAJOR__ * 100 + __CUDACC_VER_MINOR__ >= 1201
        atomicAdd(reinterpret_cast<float4*>(out), v);  // one vector red.global.add
#else
        atomicAdd(out, v.x);
        atomicAdd(out + 1, v.y);
        atomicAdd(out + 2, v.z);
        atomicAdd(out + 3, v.w);
#endif
      }
    } else {
#pragma unroll
      for (int u = 0; u < V; ++u) {
        if (a.split == 1) {
          out[u] = t[u];
        } else if (t[u] != 0.f) {
          atomicAdd(out + u, t[u]);
        }
      }
    }
  }
}

}  // namespace
