"""Wrappers of the CUDA mask-decode SpMM kernels (``csrc/spc5_spmm.cu``).

One wrapper per Pallas mask-SpMM kernel of ``repro.kernels.spc5_spmm``,
with the same arguments minus ``interpret``:

  =======================  ====================  ==========================
  wrapper                  CUDA entry point      replaces
  =======================  ====================  ==========================
  ``spmm_cuda``            spc5_spmm_whole       ``spmm_pallas``
  ``spmm_cuda_panels``     spc5_spmm_panels_s1   ``spmm_pallas_panels``
  ``spmm_cuda_panels_db``  spc5_spmm_panels_s2   ``spmm_pallas_panels_db``
  =======================  ====================  ==========================

X is (ncols, nvec) and Y (nrows, nvec), both row-major float32, as in the
reference. ``nvt`` keeps the reference's rule: ``nvec`` must be a multiple
of ``min(nvt, nvec)``, else ``ValueError``. The kernels cut the columns into
their own tiles of at most 32 (one lane per column, see the source), which
changes nothing in the result.

A CPU tensor goes to the plain PyTorch version (:mod:`repro_torch.core.
ref_spmv`); a CUDA tensor goes to the kernel, or the wrapper raises. Each
wrapper counts the launches of its kernel in :data:`LAUNCHES` (CPU calls
launch nothing and count nothing).
"""
from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

from repro_torch.core import ref_spmv as R

from . import _build
from .spc5_spmv import (MAX_SMEM_BYTES, _aligned, _check, _check_smem,
                        _raise_on, _stream, _unsupported)

#: Launches per wrapper since the last :func:`reset_launches`.
LAUNCHES: Dict[str, int] = {"spmm_cuda": 0, "spmm_cuda_panels": 0,
                            "spmm_cuda_panels_db": 0}

_MAX_TILE = 32               # columns per lane group: one warp
_MAX_GRID = 2 ** 31 - 1      # CTAs on the grid's x dimension


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _nvec(x: torch.Tensor, nvt: int) -> int:
    """X's width, held to the reference's tile rule."""
    if x.dim() != 2:
        raise ValueError(f"X must be 2-D (ncols, nvec), got shape "
                         f"{tuple(x.shape)}")
    nvec = x.shape[1]
    tile = min(nvt, nvec)
    if tile < 1 or nvec % tile:
        raise ValueError(f"nvec={nvec} not divisible by tile {tile}")
    return nvec


def column_tile(nvec: int,
                smem_bytes: Callable[[int], int] = lambda tw: 0) -> int:
    """The kernels' column tile: the smallest power of two covering nvec,
    at most 32, halved while the CTA's shared memory (``smem_bytes(tw)``)
    would not fit."""
    tw = min(_MAX_TILE, 1 << max(0, nvec - 1).bit_length())
    while tw > 1 and smem_bytes(tw) > MAX_SMEM_BYTES:
        tw //= 2
    return tw


def _grid(units: int, nvec: int, tw: int, fn: str) -> None:
    if units * -(-nvec // tw) > _MAX_GRID:
        raise ValueError(f"{fn}: {units} units x {-(-nvec // tw)} column "
                         f"tiles exceed the grid's {_MAX_GRID} CTAs")


def whole_smem_bytes(cb: int, vmax: int) -> int:
    """Dynamic shared memory of one whole-vector CTA: the value window and
    the chunk's metadata."""
    return 4 * (vmax + 4 * cb)


def panels_smem_bytes(stages: int, cb: int, vmax: int, pr: int,
                      tw: int) -> int:
    """Dynamic shared memory of one panel CTA: ``stages`` value windows and
    metadata blocks, and the (pr, tw) Y tile."""
    return 4 * (stages * (vmax + 4 * cb) + pr * tw)


def spmm_cuda(chunk_vbase, chunk_col, chunk_mask, chunk_voff, chunk_row,
              values, x, col_map=None, value_scale=None, *, r: int, c: int,
              cb: int, vmax: int, nrows: int, ncols: int,
              nvt: int = 128) -> torch.Tensor:
    """Whole-vector SpMM, one CTA per (chunk, column tile), rows summed in
    registers across a row interval and added into a zeroed Y with global
    atomics (replaces ``spmm_pallas``, which has no double-buffered twin).
    ``chunk_mask`` is the int32 view of the uint32 masks."""
    fn = "spmm_cuda"
    _unsupported(col_map, value_scale)
    nchunks = chunk_col.shape[0]
    named = dict(chunk_vbase=chunk_vbase, chunk_col=chunk_col,
                 chunk_mask=chunk_mask, chunk_voff=chunk_voff,
                 chunk_row=chunk_row, values=values, x=x)
    _check(named, {"chunk_vbase": (nchunks,),
                   **{k: (nchunks, cb) for k in ("chunk_col", "chunk_mask",
                                                 "chunk_voff", "chunk_row")}},
           values.device)
    nvec = _nvec(x, nvt)
    if x.shape[0] != ncols:
        raise ValueError(f"X has shape {tuple(x.shape)}, expected "
                         f"({ncols}, nvec)")
    if values.device.type == "cpu":
        return R.spmm(R.SPC5Device(values, chunk_col, chunk_mask, chunk_voff,
                                   chunk_row, chunk_vbase), x,
                      r=r, c=c, nrows=nrows, ncols=ncols)
    if values.device.type != "cuda":
        raise ValueError(f"no kernel for device {values.device}")
    _check_smem(whole_smem_bytes(cb, vmax), fn)
    tw = column_tile(nvec)
    _grid(nchunks, nvec, tw, fn)
    _aligned({"values": values})
    lib = _build.load_library("spc5_spmm")
    y = torch.zeros((nrows, nvec), dtype=torch.float32, device=values.device)
    err = lib.spc5_spmm_whole(
        chunk_vbase.data_ptr(), chunk_col.data_ptr(), chunk_mask.data_ptr(),
        chunk_voff.data_ptr(), chunk_row.data_ptr(), values.data_ptr(),
        x.data_ptr(), y.data_ptr(), nchunks, cb, vmax, r, c, nvec, tw,
        values.device.index or 0, _stream(values.device))
    _raise_on(err, fn)
    LAUNCHES[fn] += 1
    return y


def _panels(fn: str, stages: int, chunk_vbase, chunk_xbase, chunk_col,
            chunk_mask, chunk_voff, chunk_row, values, x, *, r, c, cb, vmax,
            xw, pr, nrows, ncols_pad, nvt):
    npanels, nchunks = chunk_vbase.shape
    named = dict(chunk_vbase=chunk_vbase, chunk_xbase=chunk_xbase,
                 chunk_col=chunk_col, chunk_mask=chunk_mask,
                 chunk_voff=chunk_voff, chunk_row=chunk_row, values=values,
                 x=x)
    _check(named, {"chunk_xbase": (npanels, nchunks),
                   **{k: (npanels, nchunks, cb)
                      for k in ("chunk_col", "chunk_mask", "chunk_voff",
                                "chunk_row")}}, values.device)
    nvec = _nvec(x, nvt)
    if npanels * pr < nrows:
        raise ValueError(f"{npanels} panels of {pr} rows cannot hold "
                         f"{nrows} rows")
    if values.device.type == "cpu":
        return R.spmm_panels(
            R.SPC5PanelDevice(values, chunk_col, chunk_mask, chunk_voff,
                              chunk_row, chunk_vbase, chunk_xbase), x,
            r=r, c=c, pr=pr, nrows=nrows, ncols_pad=ncols_pad)
    if values.device.type != "cuda":
        raise ValueError(f"no kernel for device {values.device}")
    tw = column_tile(nvec, lambda tw: panels_smem_bytes(stages, cb, vmax,
                                                        pr, tw))
    _check_smem(panels_smem_bytes(stages, cb, vmax, pr, tw), fn)
    _grid(npanels, nvec, tw, fn)
    # the kernels read X rows xbase + col, all inside the matrix; X shorter
    # than ncols_pad is padded as the Pallas wrappers pad it
    xp = (x if x.shape[0] >= ncols_pad else
          torch.nn.functional.pad(x, (0, 0, 0, ncols_pad - x.shape[0])))
    _aligned({"values": values})
    lib = _build.load_library("spc5_spmm")
    y = torch.empty((nrows, nvec), dtype=torch.float32, device=values.device)
    err = getattr(lib, f"spc5_spmm_panels_s{stages}")(
        chunk_vbase.data_ptr(), chunk_xbase.data_ptr(), chunk_col.data_ptr(),
        chunk_mask.data_ptr(), chunk_voff.data_ptr(), chunk_row.data_ptr(),
        values.data_ptr(), xp.data_ptr(), y.data_ptr(), npanels, nchunks, cb,
        vmax, pr, nrows, r, c, nvec, tw, values.device.index or 0,
        _stream(values.device))
    _raise_on(err, fn)
    LAUNCHES[fn] += 1
    return y


def spmm_cuda_panels(chunk_vbase, chunk_xbase, chunk_col, chunk_mask,
                     chunk_voff, chunk_row, values, x,
                     col_map: Optional[torch.Tensor] = None,
                     value_scale: Optional[torch.Tensor] = None, *, r: int,
                     c: int, cb: int, vmax: int, xw: int, pr: int,
                     nrows: int, ncols_pad: int,
                     nvt: int = 128) -> torch.Tensor:
    """Row-panel SpMM, one CTA per (panel, column tile) with its (pr, tw) Y
    tile in shared memory (replaces ``spmm_pallas_panels``). X is
    (ncols, nvec); ``xw`` is the layout's window, kept for the signature."""
    _unsupported(col_map, value_scale)
    return _panels("spmm_cuda_panels", 1, chunk_vbase, chunk_xbase,
                   chunk_col, chunk_mask, chunk_voff, chunk_row, values, x,
                   r=r, c=c, cb=cb, vmax=vmax, xw=xw, pr=pr, nrows=nrows,
                   ncols_pad=ncols_pad, nvt=nvt)


def spmm_cuda_panels_db(chunk_vbase, chunk_xbase, chunk_col, chunk_mask,
                        chunk_voff, chunk_row, values, x,
                        col_map: Optional[torch.Tensor] = None,
                        value_scale: Optional[torch.Tensor] = None, *,
                        r: int, c: int, cb: int, vmax: int, xw: int, pr: int,
                        nrows: int, ncols_pad: int,
                        nvt: int = 128) -> torch.Tensor:
    """Row-panel SpMM with the next chunk's value window and metadata
    prefetched by cp.async (replaces ``spmm_pallas_panels_db``)."""
    _unsupported(col_map, value_scale)
    return _panels("spmm_cuda_panels_db", 2, chunk_vbase, chunk_xbase,
                   chunk_col, chunk_mask, chunk_voff, chunk_row, values, x,
                   r=r, c=c, cb=cb, vmax=vmax, xw=xw, pr=pr, nrows=nrows,
                   ncols_pad=ncols_pad, nvt=nvt)
