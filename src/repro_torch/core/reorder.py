"""Matrix reordering: permutations that densify blocks and shrink x windows.

The port's copy of ``repro.core.reorder``, whose permutations and ``stats``
it reproduces byte for byte (``tests/test_torch_reorder.py``). SPC5's block
kernels (Bramas & Kus, arXiv:1801.01134) pay where nonzeros cluster into
r x c blocks, and the panel layout's traffic is the number of x windows
(chunks) each row panel touches: both are properties of the ordering, so
this module computes ``(row_perm, col_perm)`` pairs that improve them
before the layout is built:

  * :func:`sigma_window_rows`: SELL-C-sigma-style row sorting (Kreutzer et
    al., arXiv:1307.6209): within windows of ``sigma`` rows (a multiple of
    the panel height ``pr``) rows are stably sorted by descending nnz;
  * :func:`rcm_blocks`: reverse Cuthill-McKee over the block connectivity
    graph, whose nodes are r-row intervals, so blocks never straddle the
    permutation (square matrices: the same order on the columns;
    rectangular ones: rows only);
  * :func:`column_window_cluster`: columns ordered by the first row panel
    that touches them, so each panel's windows are as contiguous as the
    structure allows.

:func:`reorder` builds candidates, scores them with
:func:`repro_torch.core.structure.profile` (total panel chunks, then mean
bandwidth), and declines (returns the identity, the comparison in
``stats``) when none beats the original ordering. A :class:`Reordering` is
host data; the plan applies it (``repro_torch.core.plan``): x gathered by
``col_perm`` (fused into the kernels' column map, or into ``xcol`` at build
time), y recovered by the inverse row permutation (or fused into the
scatter indices).

The sorts use ``formats._sorted_unique`` where the reference calls
``np.unique``: the same arrays, without numpy 2.3's slow ``np.unique`` on
a GPU machine's host. And :func:`reorder` scores a candidate by the two
numbers it compares, ``(nchunks_total, bandwidth_mean)``, computed from the
permuted nonzero positions (:func:`_score`), where the reference builds the
permuted CSR and its whole ``structure.profile``: the same numbers (the
chunks depend only on the block cover of the positions; the bandwidth is a
mean of integers, exact in any order), from one sort instead of five on a
26 M-nonzero layer.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple, Union

import numpy as np

from . import formats as F

#: Strategy names accepted by :func:`reorder` (plus "none"/"identity" and
#: "auto", which tries all of these and keeps the best-scoring one).
STRATEGIES: Tuple[str, ...] = ("sigma", "rcm", "colwindow")

_ALIASES = {"sigma": "sigma", "sell": "sigma", "sigma_sort": "sigma",
            "rcm": "rcm", "bandwidth": "rcm",
            "colwindow": "colwindow", "columns": "colwindow",
            "colwise": "colwindow",
            "none": "none", "identity": "none", "auto": "auto"}


@dataclasses.dataclass(frozen=True)
class Reordering:
    """A row/column permutation pair plus the evidence it was built on.

    Convention: the permuted matrix is ``A'[i, j] = A[row_perm[i],
    col_perm[j]]``, so ``A' @ x[col_perm] == (A @ x)[row_perm]`` -- apply
    gathers x by ``col_perm`` and recovers y by the inverse row
    permutation (``y = y'[row_iperm]``). ``stats`` holds scalar metrics
    (pre/post bandwidth and panel-chunk totals, whether the strategy
    declined); JSON-serialisable by construction so it can ride along in
    benchmark records.
    """

    row_perm: np.ndarray          # int64 (nrows,)
    col_perm: np.ndarray          # int64 (ncols,)
    strategy: str = "none"
    stats: Dict[str, float] = dataclasses.field(default_factory=dict)

    @property
    def nrows(self) -> int:
        return int(self.row_perm.shape[0])

    @property
    def ncols(self) -> int:
        return int(self.col_perm.shape[0])

    @property
    def row_iperm(self) -> np.ndarray:
        """Inverse row permutation: ``row_iperm[row_perm[i]] == i``."""
        return _invert(self.row_perm)

    @property
    def col_iperm(self) -> np.ndarray:
        return _invert(self.col_perm)

    @property
    def identity_rows(self) -> bool:
        return bool(np.array_equal(self.row_perm,
                                   np.arange(self.nrows, dtype=np.int64)))

    @property
    def identity_cols(self) -> bool:
        return bool(np.array_equal(self.col_perm,
                                   np.arange(self.ncols, dtype=np.int64)))

    @property
    def is_identity(self) -> bool:
        return self.identity_rows and self.identity_cols

    def rows_interval_contiguous(self, r: int) -> bool:
        """True when every aligned r-row group of the *permuted* matrix maps
        to r consecutive ascending original rows.

        This is the fusion condition for the whole-vector layout: a block
        covers permuted rows [i0, i0 + r) with i0 a multiple of r, so when
        those map to an ascending original run the kernel can scatter y at
        the original base row directly and the inverse-permute of y
        disappears into ``chunk_row`` (no output gather at all). Trivially
        true for r == 1 and for interval-level permutations (RCM) whose
        last interval is full.
        """
        n = self.nrows
        if n % r:              # a partial trailing group can't stay aligned
            full = (n // r) * r
            if not np.array_equal(self.row_perm[full:],
                                  np.arange(full, n, dtype=np.int64)):
                return False
            groups = self.row_perm[:full].reshape(-1, r)
        else:
            groups = self.row_perm.reshape(-1, r)
        if groups.size == 0:
            return True
        return bool(np.all(groups == groups[:, :1]
                           + np.arange(r, dtype=np.int64)[None, :]))

    def permute_csr(self, csr: F.CSRMatrix) -> F.CSRMatrix:
        """``A' = A[row_perm][:, col_perm]`` (sparse throughout)."""
        rowlen = np.diff(csr.rowptr).astype(np.int64)
        rows = np.repeat(np.arange(csr.nrows, dtype=np.int64), rowlen)
        return F.csr_from_coo(csr.shape, self.row_iperm[rows],
                              self.col_iperm[csr.colidx.astype(np.int64)],
                              csr.values)

    def permute_spc5(self, mat: F.SPC5Matrix) -> F.SPC5Matrix:
        """Permute and re-block at the same (r, c) -- the permuted matrix's
        block coverage is rebuilt because permutations change it (that is
        the point). The reference's bytes (its CSR round trip turns a -0.0
        value into 0.0, as the ``+ 0`` here does), built from the permuted
        positions directly (``formats.coo_to_spc5``)."""
        rows, cols, vals = F.spc5_to_coo(mat)
        return F.coo_to_spc5(mat.shape, self.row_iperm[rows],
                             self.col_iperm[cols], vals + vals.dtype.type(0),
                             mat.r, mat.c)

    def apply_x(self, x: np.ndarray) -> np.ndarray:
        """Gather x into permuted column order (host-side reference)."""
        return np.asarray(x)[self.col_perm]

    def unpermute_y(self, y: np.ndarray) -> np.ndarray:
        """Recover y in original row order from the permuted product."""
        return np.asarray(y)[self.row_iperm]


def _invert(perm: np.ndarray) -> np.ndarray:
    inv = np.empty(perm.shape[0], dtype=np.int64)
    inv[perm] = np.arange(perm.shape[0], dtype=np.int64)
    return inv


def identity(shape: Tuple[int, int], strategy: str = "none",
             stats: Optional[Dict[str, float]] = None) -> Reordering:
    return Reordering(np.arange(shape[0], dtype=np.int64),
                      np.arange(shape[1], dtype=np.int64),
                      strategy=strategy, stats=stats or {})


# ----------------------------------------------------------------------------
# Strategies (each returns a Reordering with empty stats; the driver scores)
# ----------------------------------------------------------------------------

def sigma_window_rows(csr: F.CSRMatrix, sigma: int = 4096, pr: int = 512,
                      descending: bool = True) -> Reordering:
    """SELL-C-sigma-style row sort: stable by nnz within sigma-row windows.

    ``sigma`` is rounded up to a multiple of ``pr`` (the panel height plays
    SELL-C-sigma's chunk-height C role): every panel then draws its rows
    from a single sorted window, so panels hold similar-length rows and
    block fill rises without rows drifting further than sigma from home.
    Deterministic: ties keep original row order (stable argsort).
    """
    nrows = csr.nrows
    pr = max(1, pr)
    sigma = max(pr, -(-sigma // pr) * pr)
    nnz_row = np.diff(csr.rowptr).astype(np.int64)
    window = np.arange(nrows, dtype=np.int64) // sigma
    key = -nnz_row if descending else nnz_row
    # lexsort: primary window, then nnz key, then original index (stable)
    row_perm = np.lexsort((np.arange(nrows), key, window)).astype(np.int64)
    return Reordering(row_perm, np.arange(csr.ncols, dtype=np.int64),
                      strategy="sigma", stats={"sigma": float(sigma)})


def _interval_adjacency(csr: F.CSRMatrix, r: int, c: int
                        ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """CSR-style adjacency (indptr, indices, degree) of the block
    connectivity graph: nodes are r-row intervals.

    Square matrices connect interval(i) -- interval(col) for every nonzero
    (the pattern of A + A^T at interval granularity, the classic RCM
    graph). Rectangular matrices chain intervals sharing a c-column group
    (consecutive in sorted order, not a clique, so a popular column adds
    O(k) edges, not O(k^2)).
    """
    nrows, ncols = csr.shape
    nnodes = -(-nrows // r)
    rowlen = np.diff(csr.rowptr).astype(np.int64)
    rows_ivl = np.repeat(np.arange(nrows, dtype=np.int64) // r, rowlen)
    cols = csr.colidx.astype(np.int64)
    if nrows == ncols:
        a, b = rows_ivl, cols // r
    else:
        cg = cols // c
        key = F._sorted_unique(cg * np.int64(nnodes + 1) + rows_ivl)
        pcg, pivl = key // np.int64(nnodes + 1), key % np.int64(nnodes + 1)
        same = pcg[1:] == pcg[:-1]              # consecutive, same col group
        a, b = pivl[:-1][same], pivl[1:][same]
    keep = a != b
    a, b = a[keep], b[keep]
    und = F._sorted_unique(np.concatenate([a * np.int64(nnodes) + b,
                                          b * np.int64(nnodes) + a]))
    src = (und // nnodes).astype(np.int64)
    dst = (und % nnodes).astype(np.int64)
    indptr = np.zeros(nnodes + 1, dtype=np.int64)
    np.add.at(indptr, src + 1, 1)
    indptr = np.cumsum(indptr)
    degree = np.diff(indptr)
    return indptr, dst, degree


def _cuthill_mckee(indptr: np.ndarray, indices: np.ndarray,
                   degree: np.ndarray) -> np.ndarray:
    """Cuthill-McKee over all components (min-degree starts, degree-sorted
    neighbour visits); caller reverses. Deterministic: ties by node id."""
    n = degree.shape[0]
    visited = np.zeros(n, dtype=bool)
    out = np.empty(n, dtype=np.int64)
    pos = 0
    by_degree = np.lexsort((np.arange(n), degree))
    for start in by_degree:
        if visited[start]:
            continue
        visited[start] = True
        queue = [int(start)]
        head = 0
        while head < len(queue):
            u = queue[head]
            head += 1
            nbrs = indices[indptr[u]:indptr[u + 1]]
            nbrs = nbrs[~visited[nbrs]]
            if nbrs.shape[0]:
                nbrs = nbrs[np.lexsort((nbrs, degree[nbrs]))]
                visited[nbrs] = True
                queue.extend(int(v) for v in nbrs)
        out[pos:pos + len(queue)] = queue
        pos += len(queue)
    assert pos == n
    return out


def rcm_blocks(csr: F.CSRMatrix, r: int = 1, c: int = 8) -> Reordering:
    """Reverse-Cuthill-McKee over the block connectivity graph.

    Permutes whole r-row intervals (rows inside an interval keep their
    order), so the r-row-aligned blocks of beta(r, c) never straddle the
    permutation and -- for square matrices, where the same interval order
    is applied to columns -- the classic symmetric bandwidth reduction
    carries over to the block structure the kernels see.
    """
    nrows, ncols = csr.shape
    if csr.nnz == 0 or nrows == 0:
        return identity(csr.shape, strategy="rcm")
    indptr, indices, degree = _interval_adjacency(csr, r, c)
    order = _cuthill_mckee(indptr, indices, degree)[::-1]   # the R in RCM
    starts = order * r
    lens = np.minimum(starts + r, nrows) - starts
    cum = np.concatenate([[0], np.cumsum(lens)[:-1]])
    row_perm = (np.repeat(starts, lens)
                + np.arange(int(lens.sum()), dtype=np.int64)
                - np.repeat(cum, lens))
    if nrows == ncols:
        col_perm = row_perm.copy()      # symmetric permutation
    else:
        col_perm = np.arange(ncols, dtype=np.int64)
    return Reordering(row_perm, col_perm, strategy="rcm",
                      stats={"graph_nodes": float(degree.shape[0]),
                             "graph_edges": float(indices.shape[0] / 2)})


def column_window_cluster(csr: F.CSRMatrix, pr: int = 512) -> Reordering:
    """Greedy column packing by panel co-access.

    Columns are ordered by the first ``pr``-row panel that touches them
    (ties by column index), empty columns last: each panel's gathers start
    from a contiguous run of x, so the greedy chunk packer needs fewer
    ``xw``-wide windows per panel. Row order is untouched.
    """
    nrows, ncols = csr.shape
    if csr.nnz == 0:
        return identity(csr.shape, strategy="colwindow")
    pr = max(1, pr)
    rowlen = np.diff(csr.rowptr).astype(np.int64)
    panel = np.repeat(np.arange(nrows, dtype=np.int64) // pr, rowlen)
    cols = csr.colidx.astype(np.int64)
    order = np.lexsort((cols, panel))
    # position of each column's first occurrence in (panel, col) order
    first_touch = np.full(ncols, np.int64(np.iinfo(np.int64).max))
    np.minimum.at(first_touch, cols[order],
                  np.arange(order.shape[0], dtype=np.int64))
    col_perm = np.lexsort((np.arange(ncols), first_touch)).astype(np.int64)
    return Reordering(np.arange(nrows, dtype=np.int64), col_perm,
                      strategy="colwindow", stats={"pr": float(pr)})


_BUILDERS = {
    "sigma": lambda csr, r, c, pr, xw, cb, sigma:
        sigma_window_rows(csr, sigma=sigma or 8 * pr, pr=pr),
    "rcm": lambda csr, r, c, pr, xw, cb, sigma: rcm_blocks(csr, r=r, c=c),
    "colwindow": lambda csr, r, c, pr, xw, cb, sigma:
        column_window_cluster(csr, pr=pr),
}


# ----------------------------------------------------------------------------
# Driver
# ----------------------------------------------------------------------------

def _positions(csr: F.CSRMatrix) -> Tuple[np.ndarray, np.ndarray]:
    """Row and column of each nonzero of ``csr``, int64."""
    rowlen = np.diff(csr.rowptr).astype(np.int64)
    return (np.repeat(np.arange(csr.nrows, dtype=np.int64), rowlen),
            csr.colidx.astype(np.int64))


def _score(shape: Tuple[int, int], rows: np.ndarray, cols: np.ndarray,
           r: int, c: int, pr: int, xw: int, cb: int,
           align: int) -> Tuple[int, float]:
    """``(nchunks_total, bandwidth_mean)`` of ``structure.profile`` at this
    geometry for the matrix whose nonzeros sit at (rows, cols), distinct,
    in any order: the chunks of the (pr, cb, xw) panel layout over the
    greedy beta(r,c) block cover of the positions, and the mean of
    |col - row| (integers, so the float sum is exact in any order)."""
    nrows, ncols = shape
    bw = float(np.abs(cols - rows).mean()) if rows.shape[0] else 0.0
    span = ncols + c
    ukeys = F._sorted_unique((rows // r) * span + cols)
    starts = ukeys[F._greedy_opens(ukeys, c, span)]
    n_intervals = -(-nrows // r)
    rowptr = np.zeros(n_intervals + 1, dtype=np.int64)
    rowptr[1:] = np.cumsum(np.bincount(starts // span,
                                       minlength=n_intervals))
    nblocks = starts.shape[0]
    cover = F.SPC5Matrix(shape, r, c, rowptr,
                         (starts % span).astype(np.int32),
                         np.zeros(nblocks, np.uint32),
                         np.zeros(nblocks, np.int64), np.zeros(0, np.float32))
    chunks = F.count_panel_chunks(cover, pr=pr, cb=cb, xw=xw, align=align)
    return int(chunks.sum()), bw


def reorder(m: Union[F.CSRMatrix, F.SPC5Matrix], strategy: str = "auto", *,
            r: Optional[int] = None, c: Optional[int] = None, pr: int = 512,
            xw: int = 512, cb: int = 64, sigma: Optional[int] = None,
            decline: bool = True, align: int = 8) -> Reordering:
    """Build (and score) a reordering for ``m``.

    ``strategy`` is one of :data:`STRATEGIES` (or an alias), "none", or
    "auto" (try all strategies, keep the best). Candidates are scored as
    :func:`structure.profile` scores them at the given panel geometry
    (:func:`_score`), on ``(nchunks_total, bandwidth_mean)`` -- fewer x
    windows first, bandwidth as the tiebreak. With ``decline=True`` (default) a candidate
    that does not strictly beat the original ordering is rejected and the
    identity comes back with the measured comparison in ``stats`` --
    reordering never silently makes the layout worse.

    The returned stats always carry ``bw_pre``/``bw_post``,
    ``nchunks_pre``/``nchunks_post`` and ``applied`` (0.0/1.0), which is
    what benchmark records persist as the post-reorder features.
    """
    name = _ALIASES.get(strategy)
    if name is None:
        raise ValueError(f"unknown reorder strategy {strategy!r}; "
                         f"expected one of {sorted(_ALIASES)}")
    if isinstance(m, F.SPC5Matrix):
        r = r if r is not None else m.r
        c = c if c is not None else m.c
    r = r if r is not None else 1
    c = c if c is not None else 8
    csr = F.as_csr(m)
    if name == "none" or csr.nnz == 0 or csr.nrows == 0:
        return identity(csr.shape, strategy="none",
                        stats={"applied": 0.0, "declined": 0.0})

    rows, cols = _positions(csr)
    geom = dict(r=r, c=c, pr=pr, xw=xw, cb=cb, align=align)
    pre_score = _score(csr.shape, rows, cols, **geom)
    candidates = STRATEGIES if name == "auto" else (name,)

    best: Optional[Reordering] = None
    best_score = pre_score
    for cand in candidates:
        reo = _BUILDERS[cand](csr, r, c, pr, xw, cb, sigma)
        if reo.is_identity:
            continue
        score = _score(csr.shape, reo.row_iperm[rows], reo.col_iperm[cols],
                       **geom)
        if score < best_score or (best is None and not decline):
            best, best_score = reo, score
    base_stats = {"bw_pre": pre_score[1], "nchunks_pre": float(pre_score[0]),
                  "pr": float(pr), "xw": float(xw), "cb": float(cb)}
    if best is None or (decline and best_score >= pre_score):
        return identity(csr.shape, strategy=name, stats={
            **base_stats, "applied": 0.0, "declined": 1.0,
            "bw_post": pre_score[1], "nchunks_post": float(pre_score[0])})
    return dataclasses.replace(best, stats={
        **best.stats, **base_stats, "applied": 1.0, "declined": 0.0,
        "bw_post": best_score[1], "nchunks_post": float(best_score[0])})
