"""Wrappers of the CUDA mask-decode SpMV kernels (``csrc/spc5_spmv.cu``).

One wrapper per Pallas kernel of ``repro.kernels.spc5_spmv``, with the same
arguments minus ``interpret``:

  ======================  =====================  ===========================
  wrapper                 CUDA entry point       replaces
  ======================  =====================  ===========================
  ``spmv_cuda``           spc5_spmv_whole_s1     ``spmv_pallas``
  ``spmv_cuda_db``        spc5_spmv_whole_s2     ``spmv_pallas_db``
  ``spmv_cuda_panels``    spc5_spmv_panels_s1    ``spmv_pallas_panels``
  ``spmv_cuda_panels_db`` spc5_spmv_panels_s2    ``spmv_pallas_panels_db``
  ======================  =====================  ===========================

A CPU tensor goes to the plain PyTorch version (:mod:`repro_torch.core.
ref_spmv`); a CUDA tensor goes to the kernel, or the wrapper raises. There
is no fallback from one to the other. Each wrapper counts the launches of
its kernel in :data:`LAUNCHES` (CPU calls launch nothing and count nothing).
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch

from repro_torch.core import ref_spmv as R

from . import _build

#: Launches per wrapper since the last :func:`reset_launches`.
LAUNCHES: Dict[str, int] = {"spmv_cuda": 0, "spmv_cuda_db": 0,
                            "spmv_cuda_panels": 0, "spmv_cuda_panels_db": 0}

#: Dynamic shared memory one CTA may use on Hopper (232,448 bytes).
MAX_SMEM_BYTES = 227 * 1024

_MAX_THREADS = 256          # the kernels' __launch_bounds__


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _threads(cb: int) -> int:
    """One thread per block slot, in whole warps, 64..256 per CTA."""
    return min(_MAX_THREADS, max(64, -(-cb // 32) * 32))


def _unsupported(col_map, value_scale) -> None:
    if col_map is not None:
        raise NotImplementedError(
            "col_map (fused column permutation) is not ported yet: ROADMAP "
            "queue 1, item 5 (reorder pass)")
    if value_scale is not None:
        raise NotImplementedError(
            "value_scale (int8 values) is not ported yet: ROADMAP queue 1, "
            "item 5 (bf16/int8 values)")


def _check(named: Dict[str, torch.Tensor], shapes: Dict[str, Sequence[int]],
           device: torch.device) -> None:
    """Device, dtype, shape and contiguity of every operand."""
    for name, t in named.items():
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name} must be a torch.Tensor, got {type(t)}")
        if t.device != device:
            raise ValueError(f"{name} is on {t.device}, values on {device}")
        want = (torch.float32 if name in ("values", "x")
                else torch.int32)
        if t.dtype != want:
            raise TypeError(f"{name} must be {want}, got {t.dtype} (only f32 "
                            f"values and x are ported so far)")
        if name in shapes and tuple(t.shape) != tuple(shapes[name]):
            raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                             f"expected {tuple(shapes[name])}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _check_smem(nbytes: int, what: str) -> None:
    if nbytes > MAX_SMEM_BYTES:
        raise ValueError(
            f"{what} needs {nbytes} bytes of shared memory per CTA, more "
            f"than the {MAX_SMEM_BYTES} a Hopper CTA can have; use a smaller "
            f"cb (or pr/xw)")


def _aligned(named: Dict[str, torch.Tensor], boundary: int = 16) -> None:
    """The kernels stage windows with 16-byte copies (other arrays may
    need less: ``boundary``)."""
    for name, t in named.items():
        if t.data_ptr() % boundary:
            raise ValueError(
                f"{name} must start on a {boundary}-byte boundary")


def _raise_on(err: int, fn: str) -> None:
    if err != 0:
        raise RuntimeError(f"{fn} failed to launch: CUDA error {err}")


def _stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


# ----------------------------------------------------------------------------
# whole-vector layout
# ----------------------------------------------------------------------------

def _whole(fn: str, stages: int, chunk_vbase, chunk_col, chunk_mask,
           chunk_voff, chunk_row, values, x, *, r, c, cb, vmax, nrows,
           ncols):
    nchunks = chunk_col.shape[0]
    named = dict(chunk_vbase=chunk_vbase, chunk_col=chunk_col,
                 chunk_mask=chunk_mask, chunk_voff=chunk_voff,
                 chunk_row=chunk_row, values=values, x=x)
    _check(named, {"chunk_vbase": (nchunks,),
                   **{k: (nchunks, cb) for k in ("chunk_col", "chunk_mask",
                                                 "chunk_voff", "chunk_row")},
                   "x": (ncols,)}, values.device)
    if values.device.type == "cpu":
        return R.spmv(R.SPC5Device(values, chunk_col, chunk_mask, chunk_voff,
                                   chunk_row, chunk_vbase), x,
                      r=r, c=c, nrows=nrows, ncols=ncols)
    if values.device.type != "cuda":
        raise ValueError(f"no kernel for device {values.device}")
    _check_smem(stages * vmax * 4, fn)
    _aligned({"values": values})
    lib = _build.load_library("spc5_spmv")
    y = torch.zeros(nrows, dtype=torch.float32, device=values.device)
    err = getattr(lib, f"spc5_spmv_whole_s{stages}")(
        chunk_vbase.data_ptr(), chunk_col.data_ptr(), chunk_mask.data_ptr(),
        chunk_voff.data_ptr(), chunk_row.data_ptr(), values.data_ptr(),
        x.data_ptr(), y.data_ptr(), nchunks, cb, vmax, r, c, _threads(cb),
        values.device.index or 0, _stream(values.device))
    _raise_on(err, fn)
    LAUNCHES[fn] += 1
    return y


def spmv_cuda(chunk_vbase, chunk_col, chunk_mask, chunk_voff, chunk_row,
              values, x, col_map=None, value_scale=None, *, r: int, c: int,
              cb: int, vmax: int, nrows: int, ncols: int) -> torch.Tensor:
    """Whole-vector SpMV, one staged value window per chunk (replaces
    ``spmv_pallas``). ``chunk_mask`` is the int32 view of the uint32 masks."""
    _unsupported(col_map, value_scale)
    return _whole("spmv_cuda", 1, chunk_vbase, chunk_col, chunk_mask,
                  chunk_voff, chunk_row, values, x, r=r, c=c, cb=cb,
                  vmax=vmax, nrows=nrows, ncols=ncols)


def spmv_cuda_db(chunk_vbase, chunk_col, chunk_mask, chunk_voff, chunk_row,
                 values, x, col_map=None, value_scale=None, *, r: int,
                 c: int, cb: int, vmax: int, nrows: int,
                 ncols: int) -> torch.Tensor:
    """Whole-vector SpMV with the next chunk's value window prefetched by
    cp.async while the current one decodes (replaces ``spmv_pallas_db``)."""
    _unsupported(col_map, value_scale)
    return _whole("spmv_cuda_db", 2, chunk_vbase, chunk_col, chunk_mask,
                  chunk_voff, chunk_row, values, x, r=r, c=c, cb=cb,
                  vmax=vmax, nrows=nrows, ncols=ncols)


# ----------------------------------------------------------------------------
# panel layout
# ----------------------------------------------------------------------------

def _panels(fn: str, stages: int, chunk_vbase, chunk_xbase, chunk_col,
            chunk_mask, chunk_voff, chunk_row, values, x, *, r, c, cb, vmax,
            xw, pr, nrows, ncols_pad):
    npanels, nchunks = chunk_vbase.shape
    named = dict(chunk_vbase=chunk_vbase, chunk_xbase=chunk_xbase,
                 chunk_col=chunk_col, chunk_mask=chunk_mask,
                 chunk_voff=chunk_voff, chunk_row=chunk_row, values=values,
                 x=x)
    _check(named, {"chunk_xbase": (npanels, nchunks),
                   **{k: (npanels, nchunks, cb)
                      for k in ("chunk_col", "chunk_mask", "chunk_voff",
                                "chunk_row")}}, values.device)
    if x.dim() != 1:
        raise ValueError(f"x must be 1-D, got shape {tuple(x.shape)}")
    if npanels * pr < nrows:
        raise ValueError(f"{npanels} panels of {pr} rows cannot hold "
                         f"{nrows} rows")
    if values.device.type == "cpu":
        return R.spmv_panels(
            R.SPC5PanelDevice(values, chunk_col, chunk_mask, chunk_voff,
                              chunk_row, chunk_vbase, chunk_xbase), x,
            r=r, c=c, pr=pr, nrows=nrows, ncols_pad=ncols_pad)
    if values.device.type != "cuda":
        raise ValueError(f"no kernel for device {values.device}")
    _check_smem(stages * (vmax + xw) * 4 + pr * 4, fn)
    # every chunk stages an xw-wide window of x at chunk_xbase: pad x so the
    # last window stays in bounds, as the Pallas wrappers do (ncols_pad can
    # also be below ncols, when the last columns hold no nonzero)
    xp = torch.nn.functional.pad(x, (0, max(0, ncols_pad - x.shape[0])))
    _aligned({"values": values, "x": xp})
    lib = _build.load_library("spc5_spmv")
    y = torch.empty(nrows, dtype=torch.float32, device=values.device)
    err = getattr(lib, f"spc5_spmv_panels_s{stages}")(
        chunk_vbase.data_ptr(), chunk_xbase.data_ptr(), chunk_col.data_ptr(),
        chunk_mask.data_ptr(), chunk_voff.data_ptr(), chunk_row.data_ptr(),
        values.data_ptr(), xp.data_ptr(), y.data_ptr(), npanels, nchunks, cb,
        vmax, xw, pr, nrows, r, c, _threads(cb), values.device.index or 0,
        _stream(values.device))
    _raise_on(err, fn)
    LAUNCHES[fn] += 1
    return y


def spmv_cuda_panels(chunk_vbase, chunk_xbase, chunk_col, chunk_mask,
                     chunk_voff, chunk_row, values, x,
                     col_map: Optional[torch.Tensor] = None,
                     value_scale: Optional[torch.Tensor] = None, *, r: int,
                     c: int, cb: int, vmax: int, xw: int, pr: int,
                     nrows: int, ncols_pad: int) -> torch.Tensor:
    """Row-panel SpMV, one CTA per panel with its (pr,) y tile in shared
    memory (replaces ``spmv_pallas_panels``). x is (ncols,), padded here."""
    _unsupported(col_map, value_scale)
    return _panels("spmv_cuda_panels", 1, chunk_vbase, chunk_xbase,
                   chunk_col, chunk_mask, chunk_voff, chunk_row, values, x,
                   r=r, c=c, cb=cb, vmax=vmax, xw=xw, pr=pr, nrows=nrows,
                   ncols_pad=ncols_pad)


def spmv_cuda_panels_db(chunk_vbase, chunk_xbase, chunk_col, chunk_mask,
                        chunk_voff, chunk_row, values, x,
                        col_map: Optional[torch.Tensor] = None,
                        value_scale: Optional[torch.Tensor] = None, *,
                        r: int, c: int, cb: int, vmax: int, xw: int, pr: int,
                        nrows: int, ncols_pad: int) -> torch.Tensor:
    """Row-panel SpMV with the next chunk's value and x windows prefetched
    by cp.async (replaces ``spmv_pallas_panels_db``)."""
    _unsupported(col_map, value_scale)
    return _panels("spmv_cuda_panels_db", 2, chunk_vbase, chunk_xbase,
                   chunk_col, chunk_mask, chunk_voff, chunk_row, values, x,
                   r=r, c=c, cb=cb, vmax=vmax, xw=xw, pr=pr, nrows=nrows,
                   ncols_pad=ncols_pad)
