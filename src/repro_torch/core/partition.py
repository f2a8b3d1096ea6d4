"""Static balanced row partitioning (paper §Parallelization).

The port's copy of ``repro.core.partition``, line for line, so both
packages cut a matrix at the same rows. Its user in the port is the shard
pass (:func:`repro_torch.core.plan.shard_plan`).

Row intervals are chosen so every worker owns an equal share of WORK,
never splitting an r-row interval across workers: the paper's OpenMP
split, reused verbatim for devices. Ownership of disjoint row ranges is
what lets the merge happen with no synchronization (no collective inside
the SpMV hot loop).

Two balance objectives share one boundary algorithm:

  * ``mode="blocks"`` -- the paper's split: ~N_blocks/N_workers blocks per
    worker. Right when blocks carry similar nnz (uniform fill).
  * ``mode="nnz"`` -- cumulative-nonzero balance: ~nnz/N_workers nonzeros
    per worker. Right for skewed matrices (power-law rows, a few dense
    rows) where block counts hide an nnz imbalance and the heaviest shard
    straggles the whole mesh (arXiv:1805.11938's load-imbalance result).

``interval_nnz``/``nnz_skew`` are the structure signals the plan
pipeline's shard pass uses to pick a mode under ``partition="auto"``.
"""
from __future__ import annotations

from typing import List, Tuple

import numpy as np

from .formats import SPC5Matrix

PARTITION_MODES = ("blocks", "nnz")


def balanced_bounds(cum: np.ndarray, nparts: int) -> List[int]:
    """Interval boundaries equalising any cumulative work curve.

    ``cum`` is a monotone cumulative array over row intervals (cumulative
    block counts, cumulative nnz, ...). Boundary for part t sits where the
    cumulative work is closest to (t+1) * total / nparts (the paper's
    |(tid+1)*N_b/t - cum| test), clamped monotone.
    """
    cum = np.asarray(cum, dtype=np.int64)
    n_intervals = cum.shape[0] - 1
    total = int(cum[-1])
    bounds = [0]
    for t in range(1, nparts):
        target = t * total / nparts
        j = int(np.searchsorted(cum, target))
        # pick the closer of the two neighbours, clamped monotone
        if j > 0 and (j >= cum.shape[0]
                      or abs(cum[j - 1] - target) <= abs(cum[j] - target)):
            j = j - 1
        j = min(max(j, bounds[-1]), n_intervals)
        bounds.append(j)
    bounds.append(n_intervals)
    return bounds


def block_balanced_intervals(block_rowptr: np.ndarray, nparts: int
                             ) -> List[Tuple[int, int]]:
    """Partition row-interval indices [0, n_intervals) into nparts slices
    balancing the per-part BLOCK count (the paper's split)."""
    bounds = balanced_bounds(block_rowptr, nparts)
    return [(bounds[i], bounds[i + 1]) for i in range(nparts)]


def interval_nnz(mat: SPC5Matrix) -> np.ndarray:
    """Per-row-interval nonzero counts, (n_intervals,) int64.

    Read straight off the format's exclusive-prefix-popcount ``voffset``
    at the interval boundaries -- no mask decode, no CSR conversion.
    """
    voff = np.concatenate([mat.block_voffset.astype(np.int64),
                           [np.int64(mat.nnz)]])
    return np.diff(voff[mat.block_rowptr.astype(np.int64)])


def nnz_balanced_intervals(mat: SPC5Matrix, nparts: int
                           ) -> List[Tuple[int, int]]:
    """Partition row intervals balancing the per-part NONZERO count."""
    cum = np.concatenate([[0], np.cumsum(interval_nnz(mat))])
    bounds = balanced_bounds(cum, nparts)
    return [(bounds[i], bounds[i + 1]) for i in range(nparts)]


def partition_intervals(mat: SPC5Matrix, nparts: int, mode: str = "blocks"
                        ) -> List[Tuple[int, int]]:
    """The per-part row-interval ranges under ``mode`` (see module doc)."""
    if mode == "nnz":
        return nnz_balanced_intervals(mat, nparts)
    if mode == "blocks":
        return block_balanced_intervals(mat.block_rowptr, nparts)
    raise ValueError(f"unknown partition mode {mode!r}; "
                     f"expected one of {PARTITION_MODES}")


def part_nnz(mat: SPC5Matrix, intervals: List[Tuple[int, int]]) -> np.ndarray:
    """Per-part nonzero counts for a candidate interval partition."""
    cum = np.concatenate([[0], np.cumsum(interval_nnz(mat))])
    return np.array([int(cum[iv1] - cum[iv0]) for iv0, iv1 in intervals],
                    dtype=np.int64)


def nnz_skew(mat: SPC5Matrix, nparts: int, mode: str = "blocks") -> float:
    """Load-imbalance factor of a partition: max-shard nnz over the ideal
    nnz/nparts share (1.0 = perfectly balanced). The shard pass's
    ``partition="auto"`` signal."""
    if mat.nnz == 0:
        return 1.0
    ivs = partition_intervals(mat, nparts, mode)
    return float(part_nnz(mat, ivs).max() * nparts / mat.nnz)


def partition_matrix(mat: SPC5Matrix, nparts: int, mode: str = "blocks"
                     ) -> List[SPC5Matrix]:
    """Split into per-worker sub-matrices over disjoint row intervals.

    Each part gets its own four arrays (the paper's NUMA localisation: the
    sub-arrays are placed on the owning worker's memory). Row indices are
    LOCAL to the part; part p covers global rows [iv0*r, iv1*r).
    """
    parts: List[SPC5Matrix] = []
    r = mat.r
    for iv0, iv1 in partition_intervals(mat, nparts, mode):
        b0, b1 = int(mat.block_rowptr[iv0]), int(mat.block_rowptr[iv1])
        v0 = int(mat.block_voffset[b0]) if b0 < mat.nblocks else mat.nnz
        v1 = int(mat.block_voffset[b1]) if b1 < mat.nblocks else mat.nnz
        rowptr = (mat.block_rowptr[iv0:iv1 + 1] - b0).astype(mat.block_rowptr.dtype)
        parts.append(SPC5Matrix(
            shape=((iv1 - iv0) * r, mat.shape[1]),
            r=r, c=mat.c,
            block_rowptr=rowptr,
            block_colidx=mat.block_colidx[b0:b1],
            block_masks=mat.block_masks[b0:b1],
            block_voffset=(mat.block_voffset[b0:b1] - v0),
            values=mat.values[v0:v1],
        ))
    return parts


def partition_row_starts(mat: SPC5Matrix, nparts: int, mode: str = "blocks"
                         ) -> np.ndarray:
    """Global first row of each part (int32, (nparts,))."""
    ivs = partition_intervals(mat, nparts, mode)
    return np.array([iv0 * mat.r for iv0, _ in ivs], dtype=np.int32)
