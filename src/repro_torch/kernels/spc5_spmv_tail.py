"""Wrapper of the CUDA singleton-tail kernel (``csrc/spc5_spmv_tail.cu``).

  ===================  ====================  ==========================
  wrapper              CUDA entry point      replaces
  ===================  ====================  ==========================
  ``spmv_tail_cuda``   spc5_spmv_tail        ``spmv_tail_pallas``
  ===================  ====================  ==========================

The beta(r,c)_test split (``layout="test"``) runs this kernel for its
singleton tail when the tail is bucketed by row panel (``tail_pr > 0``,
a panel multi sub-plan). Its other tail paths are no kernel in the
reference either, and are plain PyTorch in the port on every device: the
flat tail of a whole-vector multi sub-plan (``ref_spmv.spmv_coo``), every
SpMM tail (``ref_spmv.spmm_coo``) and the sum of the multi and tail
products.

A CPU tensor goes to the plain PyTorch version
(``ref_spmv.spmv_coo_panels``); a CUDA tensor goes to the kernel, or the
wrapper raises. There is no fallback from one to the other. The wrapper
counts the launches of its kernel in :data:`LAUNCHES`.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.core import ref_spmv as R

from . import _build
from .spc5_spmv import _check, _check_smem, _raise_on, _stream

#: Launches since the last :func:`reset_launches`.
LAUNCHES: Dict[str, int] = {"spmv_tail_cuda": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def spmv_tail_cuda(tail_xbase, rows, cols, vals, x, *, pr: int, xw: int,
                   nrows: int, ncols_pad: int) -> torch.Tensor:
    """The panel-bucketed singleton tail times x (replaces
    ``spmv_tail_pallas``): ``rows`` (panel-local), ``cols`` and ``vals`` are
    the (npanels, smax) buckets, ``tail_xbase`` (npanels,) each bucket's x
    window start, ``xw`` the window width, x (ncols,). One CTA per bucket
    sums into its (pr,) slice of y; returns y (nrows,).

    ``ncols_pad`` is kept for the reference's signature: the reference pads
    x with zeros up to it, the kernel reads x in place and a column at or
    past x's end adds nothing."""
    if not isinstance(rows, torch.Tensor) or rows.dim() != 2:
        raise ValueError("rows must be a 2-D (npanels, smax) tensor")
    npanels, smax = rows.shape
    _check(dict(tail_xbase=tail_xbase, rows=rows, cols=cols, values=vals,
                x=x),
           {"tail_xbase": (npanels,),
            **{k: (npanels, smax) for k in ("cols", "values")}},
           vals.device)
    if x.dim() != 1:
        raise ValueError(f"x must be 1-D, got shape {tuple(x.shape)}")
    if npanels * pr < nrows:
        raise ValueError(f"{npanels} panels of {pr} rows cannot hold "
                         f"{nrows} rows")
    if pr < 1 or xw < 1:
        raise ValueError(f"pr and xw must be positive, got {pr}, {xw}")
    if vals.device.type == "cpu":
        return R.spmv_coo_panels(rows, cols, vals, x, pr=pr, nrows=nrows)
    if vals.device.type != "cuda":
        raise ValueError(f"no kernel for device {vals.device}")
    _check_smem(pr * 4, "spmv_tail_cuda")
    y = torch.empty(nrows, dtype=torch.float32, device=vals.device)
    if nrows == 0:
        return y
    lib = _build.load_library("spc5_spmv_tail")
    err = lib.spc5_spmv_tail(
        tail_xbase.data_ptr(), rows.data_ptr(), cols.data_ptr(),
        vals.data_ptr(), x.data_ptr(), y.data_ptr(), npanels, smax, pr, xw,
        nrows, x.shape[0], vals.device.index or 0, _stream(vals.device))
    _raise_on(err, "spmv_tail_cuda")
    LAUNCHES["spmv_tail_cuda"] += 1
    return y
