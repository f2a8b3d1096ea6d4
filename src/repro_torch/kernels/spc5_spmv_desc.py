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

The panel kernels split each panel's chunks among S CTAs (chosen here
from the card's occupancy, :func:`panels_launch`) and stage the tables in
shared memory (:func:`panels_stages`); ``split`` overrides the choice
of S.

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

import ctypes
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import formats as F
from repro_torch.core import ref_spmv as R

from . import _build
from . import spc5_spmv as K
# one split rule for both panel SpMV pairs (SPLIT_WAVES is re-exported)
from .spc5_spmv import SPLIT_WAVES, _r16, panels_split  # noqa: F401

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

#: Stages in the ring of ``spmv_cuda_panels_desc_db``: chunks staged ahead of
#: the decode are DB_STAGES - 1 (``time_panels_desc.py`` times rings of 2 and
#: 3). A ring that does not fit a CTA shortens to 2 (:func:`panels_stages`).
DB_STAGES = 3


def panels_smem_bytes(stages: int, nb: int, r: int, c: int, vmax: int,
                      xw: int, pr: int, wv: int, wx: int) -> int:
    """Dynamic shared memory of one panel-kernel CTA: the (pr,) f32 y tile,
    then ``stages`` stages, each the value and x windows and ``nb`` blocks'
    tables (valid and vidx per lane, the c xcol entries of each block's
    first row, a 4-byte slot for its lane-0 yrow entry), every part 16-byte
    aligned. The kernel's ``stage_layout`` (``csrc/spc5_spmv_desc.cu``)
    refuses a launch whose figure differs from its own."""
    rc = r * c
    stage = (_r16(4 * vmax) + _r16(4 * xw) + _r16(nb * rc)
             + _r16(nb * rc * wv) + _r16(nb * c * wx) + _r16(4 * nb))
    return _r16(4 * pr) + stages * stage


def panels_stages(stages: int, cb: int, r: int, c: int, vmax: int, xw: int,
                  pr: int, wv: int, wx: int,
                  what: str = "panel kernel") -> Tuple[int, int, int]:
    """(stages, blocks per stage, shared bytes per CTA) of a panel launch.

    ``stages == 1`` is the synchronous kernel: one stage of whole chunks,
    cut into slices of fewer blocks (halved) while it does not fit a CTA.
    Otherwise a ring of ``stages`` whole chunks, shortened (down to 2) while
    it does not fit. Raises ``ValueError`` when even that does not fit."""
    def nbytes(s, nb):
        return panels_smem_bytes(s, nb, r, c, vmax, xw, pr, wv, wx)
    nb = cb
    if stages == 1:
        while nb > 1 and nbytes(1, nb) > K.MAX_SMEM_BYTES:
            nb = -(-nb // 2)
    else:
        while stages > 2 and nbytes(stages, nb) > K.MAX_SMEM_BYTES:
            stages -= 1
    K._check_smem(nbytes(stages, nb), what)
    return stages, nb, nbytes(stages, nb)


_OCCUPANCY: Dict[Tuple[int, int, int, int], Tuple[int, int]] = {}


def panels_occupancy(stages: int, threads: int, smem: int,
                     device: torch.device) -> Tuple[int, int]:
    """(CTAs one SM holds at once, SMs) for the panel kernel at ``stages``
    (1: the synchronous one), as the CUDA runtime reports them."""
    key = (stages, threads, smem, device.index or 0)
    if key not in _OCCUPANCY:
        lib = _build.load_library("spc5_spmv_desc")
        out = (ctypes.c_int * 2)()
        err = lib.spc5_spmv_desc_panels_occupancy(
            stages, threads, smem, key[3], ctypes.addressof(out))
        K._raise_on(err, "spc5_spmv_desc_panels_occupancy")
        _OCCUPANCY[key] = (out[0], out[1])
    return _OCCUPANCY[key]


def panels_launch(stages: int, npanels: int, nchunks: int, *, cb: int,
                  r: int, c: int, vmax: int, xw: int, pr: int, wv: int,
                  wx: int, device: torch.device, split: Optional[int] = None,
                  what: str = "panel kernel") -> Dict[str, int]:
    """The launch a panel wrapper makes on ``device`` (a card): ``stages``,
    ``blocks_per_stage``, ``smem_bytes`` and ``threads`` per CTA, the card's
    ``ctas_per_sm`` and ``sms``, ``split`` (S, from :func:`panels_split`
    unless given) and ``grid`` (npanels * S)."""
    stages, nb, smem = panels_stages(stages, cb, r, c, vmax, xw, pr, wv, wx,
                                     what)
    threads = K._threads(nb * r * c // 4)       # a thread per lane quad
    per_sm, sms = panels_occupancy(stages, threads, smem, device)
    if split is None:
        split = panels_split(npanels, nchunks, per_sm, sms)
    if not 1 <= split <= nchunks:
        raise ValueError(f"split must be in [1, {nchunks}] (the chunks of a "
                         f"panel), got {split}")
    return dict(stages=stages, blocks_per_stage=nb, smem_bytes=smem,
                threads=threads, ctas_per_sm=per_sm, sms=sms, split=split,
                grid=npanels * split)


def _panels(fn: str, stages: int, chunk_vbase, chunk_xbase, desc_valid,
            desc_vidx, desc_xcol, desc_yrow, values, x, *, r, c, cb, vmax,
            xw, pr, nrows, ncols_pad, split=None):
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
    wv, wx, wy = _widths(desc_vidx, desc_xcol, desc_yrow)
    launch = panels_launch(stages, npanels, nchunks, cb=cb, r=r, c=c,
                           vmax=vmax, xw=xw, pr=pr, wv=wv, wx=wx,
                           device=values.device, split=split, what=fn)
    # every chunk stages an xw-wide window of x at chunk_xbase: pad x so the
    # last window stays in bounds, as the Pallas wrappers do
    xp = torch.nn.functional.pad(x, (0, max(0, ncols_pad - x.shape[0])))
    K._aligned({"values": values, "x": xp})
    # the tables are copied in 4-byte pieces where 16-byte ones do not align
    K._aligned(tables, 4)
    lib = _build.load_library("spc5_spmv_desc")
    # S > 1 CTAs add into each panel's rows, so y starts at 0
    y = (torch.zeros if launch["split"] > 1 else torch.empty)(
        nrows, dtype=torch.float32, device=values.device)
    entry = "spc5_spmv_desc_panels_s1" if stages == 1 else \
        "spc5_spmv_desc_panels_s2"
    err = getattr(lib, entry)(
        chunk_vbase.data_ptr(), chunk_xbase.data_ptr(), desc_valid.data_ptr(),
        desc_vidx.data_ptr(), desc_xcol.data_ptr(), desc_yrow.data_ptr(),
        values.data_ptr(), xp.data_ptr(), y.data_ptr(), npanels, nchunks, cb,
        r, c, vmax, xw, pr, nrows, wv, wx, wy, launch["split"],
        launch["blocks_per_stage"] if stages == 1 else launch["stages"],
        launch["smem_bytes"], launch["threads"], values.device.index or 0,
        K._stream(values.device))
    K._raise_on(err, fn)
    LAUNCHES[fn] += 1
    return y


def spmv_cuda_panels_desc(chunk_vbase, chunk_xbase, desc_valid, desc_vidx,
                          desc_xcol, desc_yrow, values, x,
                          col_map: Optional[torch.Tensor] = None,
                          value_scale: Optional[torch.Tensor] = None, *,
                          r: int, c: int, cb: int, vmax: int, xw: int,
                          pr: int, nrows: int, ncols_pad: int,
                          split: Optional[int] = None) -> torch.Tensor:
    """Row-panel descriptor SpMV, each panel's chunks split among S CTAs
    that stage one chunk's tables at a time with vector loads and sum into
    a (pr,) y tile in shared memory (replaces ``spmv_pallas_panels_desc``).
    x is (ncols,), padded here."""
    K._unsupported(col_map, value_scale)
    return _panels("spmv_cuda_panels_desc", 1, chunk_vbase, chunk_xbase,
                   desc_valid, desc_vidx, desc_xcol, desc_yrow, values, x,
                   r=r, c=c, cb=cb, vmax=vmax, xw=xw, pr=pr, nrows=nrows,
                   ncols_pad=ncols_pad, split=split)


def spmv_cuda_panels_desc_db(chunk_vbase, chunk_xbase, desc_valid,
                             desc_vidx, desc_xcol, desc_yrow, values, x,
                             col_map: Optional[torch.Tensor] = None,
                             value_scale: Optional[torch.Tensor] = None, *,
                             r: int, c: int, cb: int, vmax: int, xw: int,
                             pr: int, nrows: int, ncols_pad: int,
                             split: Optional[int] = None) -> torch.Tensor:
    """Row-panel descriptor SpMV with a ring of :data:`DB_STAGES` chunks
    staged ahead by cp.async, tables, value and x windows alike (replaces
    ``spmv_pallas_panels_desc_db``)."""
    K._unsupported(col_map, value_scale)
    return _panels("spmv_cuda_panels_desc_db", DB_STAGES,
                   chunk_vbase, chunk_xbase, desc_valid, desc_vidx,
                   desc_xcol, desc_yrow, values, x, r=r, c=c, cb=cb,
                   vmax=vmax, xw=xw, pr=pr, nrows=nrows,
                   ncols_pad=ncols_pad, split=split)
