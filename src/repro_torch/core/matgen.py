"""Synthetic sparse-matrix generators structurally matched to the paper's sets.

A numpy copy of the reference package's ``repro.core.matgen``: the same
seeds give the same CSR bytes in both packages. Each paper matrix is
replaced by a generator reproducing its qualitative structure (band / FEM
small dense blocks / power-law graph / uniform random / dense); SET_A and
SET_B keep the reference's sizes, and larger runs (``chip_smoke.py``) call
the generators directly at a bigger ``dim``.
"""
from __future__ import annotations

from typing import Callable, Dict, Tuple

import numpy as np

from .formats import CSRMatrix, csr_from_coo


def banded(dim: int, band: int, fill: float, seed: int = 0) -> CSRMatrix:
    """Band-diagonal with random fill inside the band (atmosmodd/rajat-like)."""
    rng = np.random.default_rng(seed)
    nnz_per_row = max(1, int(band * fill))
    rows = np.repeat(np.arange(dim), nnz_per_row)
    offs = rng.integers(-band, band + 1, size=rows.shape[0])
    cols = np.clip(rows + offs, 0, dim - 1)
    vals = rng.standard_normal(rows.shape[0])
    return csr_from_coo((dim, dim), rows, cols, vals)


def scrambled_banded(dim: int, band: int, fill: float,
                     seed: int = 0) -> CSRMatrix:
    """A banded matrix hidden under a random symmetric permutation.

    The classic bandwidth-reduction test case: the nonzeros are scattered
    (mean |col - row| ~ dim/3, panel chunks maximal) but a reordering
    (repro.core.reorder's RCM strategy) can recover the band exactly --
    this is the structural class where reordering pays most, used by the
    reorder benchmarks to demonstrate the nchunks reduction.
    """
    csr = banded(dim, band, fill, seed=seed)
    perm = np.random.default_rng(seed + 1).permutation(dim).astype(np.int64)
    inv = np.empty(dim, dtype=np.int64)
    inv[perm] = np.arange(dim, dtype=np.int64)
    rowlen = np.diff(csr.rowptr).astype(np.int64)
    rows = np.repeat(np.arange(dim, dtype=np.int64), rowlen)
    return csr_from_coo((dim, dim), inv[rows],
                        inv[csr.colidx.astype(np.int64)], csr.values)


def fem_blocks(dim: int, bs: int, blocks_per_row: int, seed: int = 0) -> CSRMatrix:
    """Small dense bs x bs blocks scattered near the diagonal (bone010/ldoor-like)."""
    rng = np.random.default_rng(seed)
    nb = dim // bs
    rows_l, cols_l = [], []
    for ib in range(nb):
        # neighbours concentrated near the diagonal, as in FEM meshes
        nbrs = np.unique(np.clip(
            ib + rng.integers(-max(2, nb // 50), max(3, nb // 50) + 1,
                              size=blocks_per_row), 0, nb - 1))
        for jb in nbrs:
            rr, cc = np.meshgrid(np.arange(bs), np.arange(bs), indexing="ij")
            rows_l.append((ib * bs + rr).ravel())
            cols_l.append((jb * bs + cc).ravel())
    rows = np.concatenate(rows_l)
    cols = np.concatenate(cols_l)
    vals = np.random.default_rng(seed + 1).standard_normal(rows.shape[0])
    return csr_from_coo((dim, dim), rows, cols, vals)


def powerlaw(dim: int, avg_deg: int, alpha: float = 1.8,
             seed: int = 0) -> CSRMatrix:
    """Power-law degree graph (kron/wikipedia-like): scattered, hard to block."""
    rng = np.random.default_rng(seed)
    # preferential-attachment-ish: column popularity ~ zipf
    n_edges = dim * avg_deg
    rows = rng.integers(0, dim, size=n_edges)
    ranks = (rng.pareto(alpha, size=n_edges) + 1.0)
    cols = np.minimum((dim / ranks).astype(np.int64), dim - 1)
    vals = rng.standard_normal(n_edges)
    return csr_from_coo((dim, dim), rows, cols, vals)


def uniform_random(dim: int, nnz_per_row: int, seed: int = 0) -> CSRMatrix:
    rng = np.random.default_rng(seed)
    rows = np.repeat(np.arange(dim), nnz_per_row)
    cols = rng.integers(0, dim, size=rows.shape[0])
    vals = rng.standard_normal(rows.shape[0])
    return csr_from_coo((dim, dim), rows, cols, vals)


def dense(dim: int, seed: int = 0) -> CSRMatrix:
    rng = np.random.default_rng(seed)
    d = rng.standard_normal((dim, dim))
    rows = np.repeat(np.arange(dim), dim)
    cols = np.tile(np.arange(dim), dim)
    return csr_from_coo((dim, dim), rows, cols, d.ravel())


def pruned_weight(rows: int, cols: int, density: float, block: Tuple[int, int],
                  seed: int = 0) -> CSRMatrix:
    """Magnitude-pruned-weight-like structure for the SparseLinear layer:
    nonzeros clustered into (block) tiles with per-tile Bernoulli occupancy."""
    rng = np.random.default_rng(seed)
    br, bc = block
    tr, tc = rows // br, cols // bc
    tile_on = rng.random((tr, tc)) < min(1.0, density * 4)
    rr, cc = np.nonzero(tile_on)
    rows_l, cols_l, vals_l = [], [], []
    for r0, c0 in zip(rr, cc):
        keep = rng.random((br, bc)) < 0.5
        lr, lc = np.nonzero(keep)
        rows_l.append(r0 * br + lr)
        cols_l.append(c0 * bc + lc)
        vals_l.append(rng.standard_normal(lr.shape[0]))
    if not rows_l:
        rows_l, cols_l, vals_l = [np.zeros(1, np.int64)], [np.zeros(1, np.int64)], [np.ones(1)]
    return csr_from_coo((rows, cols), np.concatenate(rows_l),
                        np.concatenate(cols_l), np.concatenate(vals_l))


# -- Paper set analogues (scaled) --------------------------------------------
# name -> factory.  Dim/NNZ chosen so the full benchmark suite runs on CPU in
# minutes while preserving each matrix's structural class.

SET_A: Dict[str, Callable[[], CSRMatrix]] = {
    "atmosmodd":      lambda: banded(40_000, 6, 1.0, seed=1),           # stencil
    "Ga19As19H42":    lambda: fem_blocks(30_000, 2, 16, seed=2),
    "mip1":           lambda: fem_blocks(12_000, 8, 10, seed=3),        # dense-ish rows
    "rajat31":        lambda: banded(60_000, 3, 1.0, seed=4),           # circuit
    "bone010":        lambda: fem_blocks(36_000, 4, 12, seed=5),
    "HV15R":          lambda: fem_blocks(24_000, 6, 14, seed=6),        # CFD
    "mixtank_new":    lambda: fem_blocks(18_000, 2, 18, seed=7),
    "Si41Ge41H72":    lambda: fem_blocks(30_000, 2, 20, seed=8),
    "cage15":         lambda: banded(50_000, 12, 0.5, seed=9),          # DNA graph
    "in-2004":        lambda: powerlaw(40_000, 10, 1.4, seed=10),       # web (runs)
    "nd6k":           lambda: fem_blocks(9_000, 8, 16, seed=11),
    "Si87H76":        lambda: fem_blocks(24_000, 2, 14, seed=12),
    "circuit5M":      lambda: banded(60_000, 4, 0.8, seed=13),
    "indochina-2004": lambda: powerlaw(40_000, 16, 1.3, seed=14),
    "ns3Da":          lambda: uniform_random(16_000, 16, seed=15),      # scattered
    "CO":             lambda: fem_blocks(20_000, 2, 12, seed=16),
    "kron_g500-logn21": lambda: powerlaw(36_000, 20, 2.6, seed=17),     # worst case
    "pdb1HYS":        lambda: fem_blocks(10_000, 8, 12, seed=18),
    "torso1":         lambda: fem_blocks(14_000, 8, 14, seed=19),
    "crankseg_2":     lambda: fem_blocks(12_000, 6, 18, seed=20),
    "ldoor":          lambda: fem_blocks(30_000, 8, 8, seed=21),
    "pwtk":           lambda: fem_blocks(16_000, 8, 10, seed=22),
    "Dense-800":      lambda: dense(800, seed=23),                      # Dense-8000 analogue
}

SET_B: Dict[str, Callable[[], CSRMatrix]] = {
    "bundle_adj":        lambda: fem_blocks(20_000, 8, 8, seed=31),
    "Cube_Coup_dt0":     lambda: fem_blocks(24_000, 8, 10, seed=32),
    "dielFilterV2real":  lambda: fem_blocks(24_000, 2, 10, seed=33),
    "Emilia_923":        lambda: fem_blocks(24_000, 4, 10, seed=34),
    "FullChip":          lambda: banded(48_000, 4, 0.6, seed=35),
    "Hook_1498":         lambda: fem_blocks(24_000, 4, 12, seed=36),
    "RM07R":             lambda: fem_blocks(18_000, 4, 16, seed=37),
    "Serena":            lambda: fem_blocks(24_000, 4, 11, seed=38),
    "spal_004":          lambda: uniform_random(10_000, 64, seed=39),   # wide dense rows
    "TSOPF_RS_b2383_c1": lambda: fem_blocks(10_000, 8, 20, seed=40),
    "wikipedia-20060925": lambda: powerlaw(36_000, 12, 2.8, seed=41),
}
