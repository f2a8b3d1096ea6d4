"""Structure analysis: one cheap report driving reordering and tuning.

The port's copy of ``repro.core.structure``. SPC5's block kernels (Bramas &
Kus, arXiv:1801.01134) win where nonzeros cluster into r x c blocks, and the
panel layout's cost is the number of distinct x windows (chunks) each row
panel touches: both are properties of the matrix's ordering.
:func:`profile` measures them in one pass, so that the reorder strategies
(:mod:`repro_torch.core.reorder`) can accept or decline a candidate on the
metrics the layout pays for, and ``selector.tune`` can read them as its
interpolation coordinates (:meth:`StructureProfile.features`). Everything
is computed from CSR (or a converted beta(r,c) matrix) without a dense
array.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple, Union

import numpy as np

from . import formats as F
from . import selector as S

#: Block geometries :func:`profile` measures by default: short-wide, square
#: and tall shapes of the paper's SUPPORTED_BLOCKS.
DEFAULT_PROFILE_BLOCKS: Tuple[Tuple[int, int], ...] = ((1, 8), (2, 4), (4, 4))


@dataclasses.dataclass(frozen=True)
class StructureProfile:
    """Locality and blockability report of one matrix.

    ``bandwidth_*`` are |col - row| statistics over the nonzeros (what RCM
    minimises); ``diag_frac`` is the fraction of rows whose diagonal entry
    is present, ``diag_dominance`` the fraction of nonempty rows where
    |a_ii| >= sum_{j != i} |a_ij|. ``block_fill`` maps "rxc" to (nblocks,
    Avg(r,c), fill ratio), the paper's table 1-2 statistics.
    ``panel_chunks`` is the chunk count of each panel of the (pr, xw, cb)
    panel layout, and ``nchunks_total`` their sum: each chunk is one value
    window and one x window to stage."""

    nrows: int
    ncols: int
    nnz: int
    nnz_row_mean: float
    nnz_row_max: int
    bandwidth_mean: float
    bandwidth_max: int
    diag_frac: float
    diag_dominance: float
    block_fill: Dict[str, Tuple[int, float, float]]
    panel_chunks: np.ndarray      # (npanels,) int64
    nchunks_total: int
    r: int                        # block geometry the panel metrics used
    c: int
    pr: int
    xw: int
    cb: int

    def features(self, kernel: Optional[str] = None) -> S.MatrixFeatures:
        """This profile as the selector's interpolation coordinates.

        ``kernel`` ("rxc") picks which profiled block geometry supplies
        Avg/fill; defaults to the geometry the panel metrics used.
        """
        kernel = kernel or f"{self.r}x{self.c}"
        if kernel not in self.block_fill:
            raise KeyError(f"{kernel!r} not profiled; have "
                           f"{sorted(self.block_fill)}")
        _, avg, fill = self.block_fill[kernel]
        return S.MatrixFeatures(self.nrows, self.ncols, self.nnz,
                                self.nnz / max(self.nrows, 1),
                                self.bandwidth_mean, avg, fill)

    def summary(self) -> str:
        """One line for logs."""
        return (f"bw={self.bandwidth_mean:.1f}/{self.bandwidth_max}"
                f";nchunks={self.nchunks_total}"
                f";chunks_per_panel={self.chunks_per_panel_mean:.2f}"
                f";diag={self.diag_frac:.2f}")

    @property
    def chunks_per_panel_mean(self) -> float:
        return float(self.panel_chunks.mean()) if self.panel_chunks.size \
            else 0.0


def profile(m: Union[F.CSRMatrix, F.SPC5Matrix],
            blocks: Sequence[Tuple[int, int]] = DEFAULT_PROFILE_BLOCKS,
            r: Optional[int] = None, c: Optional[int] = None,
            pr: int = 512, xw: int = 512, cb: int = 64,
            align: int = 8) -> StructureProfile:
    """Measure a matrix's ordering-sensitive structure.

    ``m`` is CSR or a converted beta(r,c), which pins the panel metrics to
    its (r, c) unless ``r`` / ``c`` say otherwise. ``pr``/``xw``/``cb`` are
    the panel geometry whose chunks are counted, by the same pass-1 planner
    ``to_panels`` runs (:func:`repro_torch.core.formats.
    count_panel_chunks`), so they are the layout's real chunk counts."""
    if isinstance(m, F.SPC5Matrix):
        r = r if r is not None else m.r
        c = c if c is not None else m.c
    r = r if r is not None else blocks[0][0]
    c = c if c is not None else blocks[0][1]
    csr = F.as_csr(m)
    nrows, ncols = csr.shape
    nnz = csr.nnz
    rowlen = np.diff(csr.rowptr).astype(np.int64)
    if nnz:
        rows = np.repeat(np.arange(nrows, dtype=np.int64), rowlen)
        dist = np.abs(csr.colidx.astype(np.int64) - rows)
        bw_mean, bw_max = float(dist.mean()), int(dist.max())
        on_diag = dist == 0
        diag_frac = float(on_diag.sum() / max(min(nrows, ncols), 1))
        absv = np.abs(csr.values.astype(np.float64))
        row_abs = np.zeros(nrows)
        np.add.at(row_abs, rows, absv)
        diag_abs = np.zeros(nrows)
        np.add.at(diag_abs, rows[on_diag], absv[on_diag])
        dominated = diag_abs >= (row_abs - diag_abs) - 1e-12
        diag_dominance = float(dominated[rowlen > 0].mean()) \
            if (rowlen > 0).any() else 0.0
    else:
        bw_mean, bw_max, diag_frac, diag_dominance = 0.0, 0, 0.0, 0.0

    block_fill: Dict[str, Tuple[int, float, float]] = {}
    geoms = {tuple(bc) for bc in blocks} | {(r, c)}
    for (br, bc) in sorted(geoms):
        nb, avg = F.block_stats(csr, br, bc)
        block_fill[f"{br}x{bc}"] = (nb, avg, avg / (br * bc))

    mat = m if (isinstance(m, F.SPC5Matrix) and (m.r, m.c) == (r, c)) \
        else F.csr_to_spc5(csr, r, c)
    panel_chunks = F.count_panel_chunks(mat, pr=pr, cb=cb, xw=xw, align=align)

    return StructureProfile(
        nrows=nrows, ncols=ncols, nnz=nnz,
        nnz_row_mean=nnz / max(nrows, 1),
        nnz_row_max=int(rowlen.max()) if nrows else 0,
        bandwidth_mean=bw_mean, bandwidth_max=bw_max,
        diag_frac=diag_frac, diag_dominance=diag_dominance,
        block_fill=block_fill, panel_chunks=panel_chunks,
        nchunks_total=int(panel_chunks.sum()),
        r=r, c=c, pr=pr, xw=xw, cb=cb)
