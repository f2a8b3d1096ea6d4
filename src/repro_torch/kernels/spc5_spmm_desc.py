"""Wrappers of the CUDA descriptor SpMM kernels (``csrc/spc5_spmm_desc.cu``).

One wrapper per Pallas descriptor SpMM kernel of ``repro.kernels.spc5_spmm``,
with the same arguments minus ``interpret``:

  ============================  ========================  =================================
  wrapper                       CUDA entry point          replaces
  ============================  ========================  =================================
  ``spmm_cuda_desc``            spc5_spmm_desc_whole      ``spmm_pallas_desc``
  ``spmm_cuda_panels_desc``     spc5_spmm_desc_panels_s1  ``spmm_pallas_panels_desc``
  ``spmm_cuda_panels_desc_db``  spc5_spmm_desc_panels_s2  ``spmm_pallas_panels_desc_db``
  ============================  ========================  =================================

The reference has no double-buffered whole-vector descriptor SpMM, so
neither has the port. X is (ncols, nvec) and Y (nrows, nvec), both
row-major float32; ``nvt`` keeps the reference's rule (``nvec`` a multiple
of ``min(nvt, nvec)``, else ``ValueError``) and the kernels cut the columns
into their own tiles of at most 32, as the mask SpMM kernels do
(:mod:`.spc5_spmm`). The tables are taken only in the dtypes
:func:`repro_torch.core.formats.chunk_descriptors` builds for the geometry,
never widened (:func:`.spc5_spmv_desc._check_tables`).

A CPU tensor goes to the plain PyTorch version (:mod:`repro_torch.core.
ref_spmv`); a CUDA tensor goes to the kernel, or the wrapper raises. Each
wrapper counts the launches of its kernel in :data:`LAUNCHES` (CPU calls
launch nothing and count nothing).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.core import ref_spmv as R

from . import _build
from . import spc5_spmm as KM
from . import spc5_spmv as K
from .spc5_spmv_desc import _check_tables, _widths

#: Launches per wrapper since the last :func:`reset_launches`.
LAUNCHES: Dict[str, int] = {"spmm_cuda_desc": 0, "spmm_cuda_panels_desc": 0,
                            "spmm_cuda_panels_desc_db": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _round16(n: int) -> int:
    return -(-n // 16) * 16


def stage_bytes(cb: int, r: int, c: int, vmax: int, vidx_width: int,
                stage_vidx: bool) -> int:
    """Shared memory of one staged chunk: the value window, the chunk's
    vidx table as built (when staged), and one 32-bit word per block and
    column, per block and row and per block (the valid mask), rounded up to
    16 bytes (``Stage`` in the source)."""
    vidx = _round16(cb * r * c * vidx_width) if stage_vidx else 0
    return _round16(4 * vmax + vidx + 4 * cb * (c + r + 1))


def smem_plan(stages: int, cb: int, r: int, c: int, vmax: int,
              vidx_width: int, nvec: int, pr: int = 0
              ) -> Tuple[int, bool, int]:
    """The launch's column tile, whether vidx is staged, and the dynamic
    shared memory per CTA: ``stages`` staged chunks plus, for panels, the
    (pr, tw) Y tile. The column tile is halved while the CTA would not
    fit; vidx is staged when the CTA fits with it at some tile, else it is
    read through L1."""
    def smem(tw: int, staged: bool) -> int:
        return (stages * stage_bytes(cb, r, c, vmax, vidx_width, staged)
                + 4 * pr * tw)
    for staged in (True, False):
        tw = KM.column_tile(nvec, lambda t: smem(t, staged))
        if smem(tw, staged) <= K.MAX_SMEM_BYTES or not staged:
            return tw, staged, smem(tw, staged)


def _block(r: int, c: int) -> None:
    """The kernels fold a block's r*c valid bytes into a mask with 4-byte
    words: r*c must be 4, 8, 16 or 32, with r <= 8 and c <= 8."""
    if r not in (1, 2, 4, 8) or c not in (1, 2, 4, 8) or r * c not in (
            4, 8, 16, 32):
        raise ValueError(f"no descriptor SpMM kernel for beta({r},{c})")


def _launch_checks(fn: str, smem: int, r: int, c: int, values, desc_valid):
    K._check_smem(smem, fn)
    _block(r, c)
    # 16-byte value-window copies and vector loads of the valid bytes
    K._aligned({"values": values, "desc_valid": desc_valid})


# ----------------------------------------------------------------------------
# whole-vector layout
# ----------------------------------------------------------------------------

def spmm_cuda_desc(chunk_vbase, desc_valid, desc_vidx, desc_xcol, desc_yrow,
                   values, x, value_scale=None, *, r: int, c: int, cb: int,
                   vmax: int, nrows: int, ncols: int,
                   nvt: int = 128) -> torch.Tensor:
    """Whole-vector descriptor SpMM, one CTA per (chunk, column tile), each
    (row, column) summed in a register across a run of blocks and added
    into a zeroed Y with global atomics (replaces ``spmm_pallas_desc``). A
    column permutation would already be folded into ``desc_xcol``, so there
    is no ``col_map``."""
    fn = "spmm_cuda_desc"
    K._unsupported(None, value_scale)
    nchunks = desc_valid.shape[0]
    K._check(dict(chunk_vbase=chunk_vbase, values=values, x=x),
             {"chunk_vbase": (nchunks,)}, values.device)
    tables = dict(desc_valid=desc_valid, desc_vidx=desc_vidx,
                  desc_xcol=desc_xcol, desc_yrow=desc_yrow)
    _check_tables(tables, dict(desc_vidx=vmax, desc_xcol=ncols,
                               desc_yrow=nrows),
                  (nchunks, cb, r * c), values.device)
    nvec = KM._nvec(x, nvt)
    if x.shape[0] != ncols:
        raise ValueError(f"X has shape {tuple(x.shape)}, expected "
                         f"({ncols}, nvec)")
    if values.device.type == "cpu":
        return R.spmm_desc(R.SPC5DescDevice(values, desc_valid, desc_vidx,
                                            desc_xcol, desc_yrow,
                                            chunk_vbase), x, nrows=nrows)
    if values.device.type != "cuda":
        raise ValueError(f"no kernel for device {values.device}")
    wv, wx, wy = _widths(desc_vidx, desc_xcol, desc_yrow)
    tw, staged, smem = smem_plan(1, cb, r, c, vmax, wv, nvec)
    _launch_checks(fn, smem, r, c, values, desc_valid)
    KM._grid(nchunks, nvec, tw, fn)
    lib = _build.load_library("spc5_spmm_desc")
    y = torch.zeros((nrows, nvec), dtype=torch.float32, device=values.device)
    err = lib.spc5_spmm_desc_whole(
        chunk_vbase.data_ptr(), desc_valid.data_ptr(), desc_vidx.data_ptr(),
        desc_xcol.data_ptr(), desc_yrow.data_ptr(), values.data_ptr(),
        x.data_ptr(), y.data_ptr(), nchunks, cb, vmax, r, c, wv, wx, wy,
        ncols, nvec, tw, int(staged), values.device.index or 0,
        K._stream(values.device))
    K._raise_on(err, fn)
    LAUNCHES[fn] += 1
    return y


# ----------------------------------------------------------------------------
# panel layout
# ----------------------------------------------------------------------------

def _panels(fn: str, stages: int, chunk_vbase, chunk_xbase, desc_valid,
            desc_vidx, desc_xcol, desc_yrow, values, x, *, r, c, cb, vmax,
            xw, pr, nrows, ncols_pad, nvt):
    npanels, nchunks = chunk_vbase.shape
    K._check(dict(chunk_vbase=chunk_vbase, chunk_xbase=chunk_xbase,
                  values=values, x=x),
             {"chunk_xbase": (npanels, nchunks)}, values.device)
    tables = dict(desc_valid=desc_valid, desc_vidx=desc_vidx,
                  desc_xcol=desc_xcol, desc_yrow=desc_yrow)
    _check_tables(tables, dict(desc_vidx=vmax, desc_xcol=xw, desc_yrow=pr),
                  (npanels, nchunks, cb, r * c), values.device)
    nvec = KM._nvec(x, nvt)
    if npanels * pr < nrows:
        raise ValueError(f"{npanels} panels of {pr} rows cannot hold "
                         f"{nrows} rows")
    if values.device.type == "cpu":
        return R.spmm_panels_desc(
            R.SPC5PanelDescDevice(values, desc_valid, desc_vidx, desc_xcol,
                                  desc_yrow, chunk_vbase, chunk_xbase), x,
            pr=pr, nrows=nrows, ncols_pad=ncols_pad)
    if values.device.type != "cuda":
        raise ValueError(f"no kernel for device {values.device}")
    wv, wx, wy = _widths(desc_vidx, desc_xcol, desc_yrow)
    tw, staged, smem = smem_plan(stages, cb, r, c, vmax, wv, nvec, pr)
    _launch_checks(fn, smem, r, c, values, desc_valid)
    KM._grid(npanels, nvec, tw, fn)
    lib = _build.load_library("spc5_spmm_desc")
    y = torch.empty((nrows, nvec), dtype=torch.float32, device=values.device)
    # X is read in place: the kernels skip any column at or past its rows,
    # which is what the reference's zero padding up to ncols_pad adds
    err = getattr(lib, f"spc5_spmm_desc_panels_s{stages}")(
        chunk_vbase.data_ptr(), chunk_xbase.data_ptr(), desc_valid.data_ptr(),
        desc_vidx.data_ptr(), desc_xcol.data_ptr(), desc_yrow.data_ptr(),
        values.data_ptr(), x.data_ptr(), y.data_ptr(), npanels, nchunks, cb,
        vmax, pr, nrows, x.shape[0], r, c, wv, wx, wy, nvec, tw, int(staged),
        values.device.index or 0, K._stream(values.device))
    K._raise_on(err, fn)
    LAUNCHES[fn] += 1
    return y


def spmm_cuda_panels_desc(chunk_vbase, chunk_xbase, desc_valid, desc_vidx,
                          desc_xcol, desc_yrow, values, x,
                          col_map: Optional[torch.Tensor] = None,
                          value_scale: Optional[torch.Tensor] = None, *,
                          r: int, c: int, cb: int, vmax: int, xw: int,
                          pr: int, nrows: int, ncols_pad: int,
                          nvt: int = 128) -> torch.Tensor:
    """Row-panel descriptor SpMM, one CTA per (panel, column tile) with its
    (pr, tw) Y tile in shared memory (replaces
    ``spmm_pallas_panels_desc``). X is (ncols, nvec)."""
    K._unsupported(col_map, value_scale)
    return _panels("spmm_cuda_panels_desc", 1, chunk_vbase, chunk_xbase,
                   desc_valid, desc_vidx, desc_xcol, desc_yrow, values, x,
                   r=r, c=c, cb=cb, vmax=vmax, xw=xw, pr=pr, nrows=nrows,
                   ncols_pad=ncols_pad, nvt=nvt)


def spmm_cuda_panels_desc_db(chunk_vbase, chunk_xbase, desc_valid,
                             desc_vidx, desc_xcol, desc_yrow, values, x,
                             col_map: Optional[torch.Tensor] = None,
                             value_scale: Optional[torch.Tensor] = None, *,
                             r: int, c: int, cb: int, vmax: int, xw: int,
                             pr: int, nrows: int, ncols_pad: int,
                             nvt: int = 128) -> torch.Tensor:
    """Row-panel descriptor SpMM with the next chunk's value window and
    vidx table prefetched by cp.async (replaces
    ``spmm_pallas_panels_desc_db``)."""
    K._unsupported(col_map, value_scale)
    return _panels("spmm_cuda_panels_desc_db", 2, chunk_vbase, chunk_xbase,
                   desc_valid, desc_vidx, desc_xcol, desc_yrow, values, x,
                   r=r, c=c, cb=cb, vmax=vmax, xw=xw, pr=pr, nrows=nrows,
                   ncols_pad=ncols_pad, nvt=nvt)
