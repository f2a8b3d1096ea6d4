"""Wrappers of the CUDA descriptor SpMV kernels (``csrc/spc5_spmv_desc.cu``).

One wrapper per Pallas descriptor kernel of ``repro.kernels.spc5_spmv``,
with the same arguments minus ``interpret``:

  ============================  ========================  =================================
  wrapper                       CUDA entry point          replaces
  ============================  ========================  =================================
  ``spmv_cuda_desc``            spc5_spmv_desc_whole_s1   ``spmv_pallas_desc``
  ``spmv_cuda_desc_db``         spc5_spmv_desc_whole_s2   ``spmv_pallas_desc_db``
  ``spmv_cuda_panels_desc``     spc5_spmv_desc_panels_s1  ``spmv_pallas_panels_desc``
  ``spmv_cuda_panels_desc_db``  spc5_spmv_desc_panels_s2  ``spmv_pallas_panels_desc_db``
  ============================  ========================  =================================

The tables are taken as built (:func:`repro_torch.core.formats.
chunk_descriptors`): ``desc_valid`` int8 and each index table in the
narrowest signed dtype its bound allows (``vidx`` by ``vmax``, ``xcol`` by
``ncols`` or ``xw``, ``yrow`` by ``nrows`` or ``pr``). A table in any other
dtype raises: the wrapper never widens one, which would add a copy and
four times the bytes.

A CPU tensor goes to the plain PyTorch version (:mod:`repro_torch.core.
ref_spmv`); a CUDA tensor goes to the kernel, or the wrapper raises. Each
wrapper counts the launches of its kernel in :data:`LAUNCHES` (CPU calls
launch nothing and count nothing).
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.core import formats as F
from repro_torch.core import ref_spmv as R

from . import _build
from . import spc5_spmv as K

#: Launches per wrapper since the last :func:`reset_launches`.
LAUNCHES: Dict[str, int] = {"spmv_cuda_desc": 0, "spmv_cuda_desc_db": 0,
                            "spmv_cuda_panels_desc": 0,
                            "spmv_cuda_panels_desc_db": 0}

_TORCH_INT = {np.dtype(np.int8): torch.int8, np.dtype(np.int16): torch.int16,
              np.dtype(np.int32): torch.int32}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _check_tables(tables: Dict[str, torch.Tensor], bounds: Dict[str, int],
                  shape, device: torch.device) -> None:
    """Device, shape, contiguity and the built dtype of each table: int8 for
    ``desc_valid``, ``narrow_index_dtype(bound - 1)`` for an index table."""
    for name, t in tables.items():
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name} must be a torch.Tensor, got {type(t)}")
        if t.device != device:
            raise ValueError(f"{name} is on {t.device}, values on {device}")
        want = (torch.int8 if name == "desc_valid" else
                _TORCH_INT[F.narrow_index_dtype(max(bounds[name] - 1, 0))])
        if t.dtype != want:
            raise TypeError(
                f"{name} must be {want} as chunk_descriptors builds it for "
                f"this geometry, got {t.dtype} (tables are never widened)")
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                             f"expected {tuple(shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _widths(vidx, xcol, yrow):
    return vidx.element_size(), xcol.element_size(), yrow.element_size()


# ----------------------------------------------------------------------------
# whole-vector layout
# ----------------------------------------------------------------------------

def _whole(fn: str, stages: int, chunk_vbase, desc_valid, desc_vidx,
           desc_xcol, desc_yrow, values, x, *, r, c, cb, vmax, nrows, ncols):
    nchunks = desc_valid.shape[0]
    K._check(dict(chunk_vbase=chunk_vbase, values=values, x=x),
             {"chunk_vbase": (nchunks,), "x": (ncols,)}, values.device)
    tables = dict(desc_valid=desc_valid, desc_vidx=desc_vidx,
                  desc_xcol=desc_xcol, desc_yrow=desc_yrow)
    _check_tables(tables, dict(desc_vidx=vmax, desc_xcol=ncols,
                               desc_yrow=nrows),
                  (nchunks, cb, r * c), values.device)
    if values.device.type == "cpu":
        return R.spmv_desc(R.SPC5DescDevice(values, desc_valid, desc_vidx,
                                            desc_xcol, desc_yrow,
                                            chunk_vbase), x, nrows=nrows)
    if values.device.type != "cuda":
        raise ValueError(f"no kernel for device {values.device}")
    K._check_smem(stages * vmax * 4, fn)
    K._aligned({"values": values})
    lib = _build.load_library("spc5_spmv_desc")
    lanes = cb * r * c
    y = torch.zeros(nrows, dtype=torch.float32, device=values.device)
    err = getattr(lib, f"spc5_spmv_desc_whole_s{stages}")(
        chunk_vbase.data_ptr(), desc_valid.data_ptr(), desc_vidx.data_ptr(),
        desc_xcol.data_ptr(), desc_yrow.data_ptr(), values.data_ptr(),
        x.data_ptr(), y.data_ptr(), nchunks, lanes, vmax,
        *_widths(desc_vidx, desc_xcol, desc_yrow), K._threads(lanes),
        values.device.index or 0, K._stream(values.device))
    K._raise_on(err, fn)
    LAUNCHES[fn] += 1
    return y


def spmv_cuda_desc(chunk_vbase, desc_valid, desc_vidx, desc_xcol, desc_yrow,
                   values, x, value_scale=None, *, r: int, c: int, cb: int,
                   vmax: int, nrows: int, ncols: int) -> torch.Tensor:
    """Whole-vector descriptor SpMV, one staged value window per chunk
    (replaces ``spmv_pallas_desc``). A column permutation would already be
    folded into ``desc_xcol``, so there is no ``col_map``."""
    K._unsupported(None, value_scale)
    return _whole("spmv_cuda_desc", 1, chunk_vbase, desc_valid, desc_vidx,
                  desc_xcol, desc_yrow, values, x, r=r, c=c, cb=cb,
                  vmax=vmax, nrows=nrows, ncols=ncols)


def spmv_cuda_desc_db(chunk_vbase, desc_valid, desc_vidx, desc_xcol,
                      desc_yrow, values, x, value_scale=None, *, r: int,
                      c: int, cb: int, vmax: int, nrows: int,
                      ncols: int) -> torch.Tensor:
    """Whole-vector descriptor SpMV with the next chunk's value window
    prefetched by cp.async (replaces ``spmv_pallas_desc_db``)."""
    K._unsupported(None, value_scale)
    return _whole("spmv_cuda_desc_db", 2, chunk_vbase, desc_valid,
                  desc_vidx, desc_xcol, desc_yrow, values, x, r=r, c=c,
                  cb=cb, vmax=vmax, nrows=nrows, ncols=ncols)


# ----------------------------------------------------------------------------
# panel layout
# ----------------------------------------------------------------------------

def _panels(fn: str, stages: int, chunk_vbase, chunk_xbase, desc_valid,
            desc_vidx, desc_xcol, desc_yrow, values, x, *, r, c, cb, vmax,
            xw, pr, nrows, ncols_pad):
    npanels, nchunks = chunk_vbase.shape
    K._check(dict(chunk_vbase=chunk_vbase, chunk_xbase=chunk_xbase,
                  values=values, x=x),
             {"chunk_xbase": (npanels, nchunks)}, values.device)
    tables = dict(desc_valid=desc_valid, desc_vidx=desc_vidx,
                  desc_xcol=desc_xcol, desc_yrow=desc_yrow)
    _check_tables(tables, dict(desc_vidx=vmax, desc_xcol=xw, desc_yrow=pr),
                  (npanels, nchunks, cb, r * c), values.device)
    if x.dim() != 1:
        raise ValueError(f"x must be 1-D, got shape {tuple(x.shape)}")
    if npanels * pr < nrows:
        raise ValueError(f"{npanels} panels of {pr} rows cannot hold "
                         f"{nrows} rows")
    if values.device.type == "cpu":
        return R.spmv_panels_desc(
            R.SPC5PanelDescDevice(values, desc_valid, desc_vidx, desc_xcol,
                                  desc_yrow, chunk_vbase, chunk_xbase), x,
            pr=pr, nrows=nrows, ncols_pad=ncols_pad)
    if values.device.type != "cuda":
        raise ValueError(f"no kernel for device {values.device}")
    K._check_smem(stages * (vmax + xw) * 4 + pr * 4, fn)
    # every chunk stages an xw-wide window of x at chunk_xbase: pad x so the
    # last window stays in bounds, as the Pallas wrappers do
    xp = torch.nn.functional.pad(x, (0, max(0, ncols_pad - x.shape[0])))
    K._aligned({"values": values, "x": xp})
    lib = _build.load_library("spc5_spmv_desc")
    lanes = cb * r * c
    y = torch.empty(nrows, dtype=torch.float32, device=values.device)
    err = getattr(lib, f"spc5_spmv_desc_panels_s{stages}")(
        chunk_vbase.data_ptr(), chunk_xbase.data_ptr(), desc_valid.data_ptr(),
        desc_vidx.data_ptr(), desc_xcol.data_ptr(), desc_yrow.data_ptr(),
        values.data_ptr(), xp.data_ptr(), y.data_ptr(), npanels, nchunks,
        lanes, vmax, xw, pr, nrows, *_widths(desc_vidx, desc_xcol, desc_yrow),
        K._threads(lanes), values.device.index or 0,
        K._stream(values.device))
    K._raise_on(err, fn)
    LAUNCHES[fn] += 1
    return y


def spmv_cuda_panels_desc(chunk_vbase, chunk_xbase, desc_valid, desc_vidx,
                          desc_xcol, desc_yrow, values, x,
                          col_map: Optional[torch.Tensor] = None,
                          value_scale: Optional[torch.Tensor] = None, *,
                          r: int, c: int, cb: int, vmax: int, xw: int,
                          pr: int, nrows: int,
                          ncols_pad: int) -> torch.Tensor:
    """Row-panel descriptor SpMV, one CTA per panel with its (pr,) y tile
    in shared memory (replaces ``spmv_pallas_panels_desc``). x is (ncols,),
    padded here."""
    K._unsupported(col_map, value_scale)
    return _panels("spmv_cuda_panels_desc", 1, chunk_vbase, chunk_xbase,
                   desc_valid, desc_vidx, desc_xcol, desc_yrow, values, x,
                   r=r, c=c, cb=cb, vmax=vmax, xw=xw, pr=pr, nrows=nrows,
                   ncols_pad=ncols_pad)


def spmv_cuda_panels_desc_db(chunk_vbase, chunk_xbase, desc_valid,
                             desc_vidx, desc_xcol, desc_yrow, values, x,
                             col_map: Optional[torch.Tensor] = None,
                             value_scale: Optional[torch.Tensor] = None, *,
                             r: int, c: int, cb: int, vmax: int, xw: int,
                             pr: int, nrows: int,
                             ncols_pad: int) -> torch.Tensor:
    """Row-panel descriptor SpMV with the next chunk's value and x windows
    prefetched by cp.async (replaces ``spmv_pallas_panels_desc_db``)."""
    K._unsupported(col_map, value_scale)
    return _panels("spmv_cuda_panels_desc_db", 2, chunk_vbase, chunk_xbase,
                   desc_valid, desc_vidx, desc_xcol, desc_yrow, values, x,
                   r=r, c=c, cb=cb, vmax=vmax, xw=xw, pr=pr, nrows=nrows,
                   ncols_pad=ncols_pad)
