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

The panel wrappers also take ``col_map``, a reordered plan's column
permutation (the Pallas kernels' ``col_map``): with it they launch the
column-map twins ``spc5_spmv_desc_panels_cmap_s1`` / ``_s2`` on x in the
original order (the synchronous one gathers each chunk's x window through
the map, the ring reads x through it at each set lane), and count the
launch as ``spmv_cuda_panels_desc_cmap`` /
``spmv_cuda_panels_desc_db_cmap``.

The whole-vector kernels cut the chunks into G contiguous ranges, one CTA
each (chosen here from the card's occupancy by the panel kernels' split
rule, :func:`whole_launch`; ``grid`` overrides it), stage the tables in
shared memory (:func:`whole_stages`) and sum rows in a y tile of
:data:`WHOLE_TILE_ROWS` rows. The panel kernels
split each panel's chunks among S CTAs (:func:`panels_launch`) and stage
the tables likewise (:func:`panels_stages`); ``split`` overrides the choice
of S.

The tables are taken as built (:func:`repro_torch.core.formats.
chunk_descriptors`): ``desc_valid`` int8 and each index table in the
narrowest signed dtype its bound allows (``vidx`` by ``vmax``, ``xcol`` by
``ncols`` or ``xw``, ``yrow`` by ``nrows`` or ``pr``). A table in any other
dtype raises: the wrapper never widens one, which would add a copy and
four times the bytes.

Values are f32, bf16 or int8 (with ``value_scale``, one f32 scale a
chunk). All four kernels take all three: bf16 upcast in the decode, int8
upcast and then multiplied by its chunk's scale, before the product with x,
which is summed in f32. A narrow window is staged as the 16-byte aligned
span that covers it, kept inside ``values`` (:func:`~.spc5_spmv.
value_span`).

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
# one split rule and one cut into chunk ranges for every SpMV pair, and one
# value window for every kernel that takes narrow values (SPLIT_WAVES and
# chunk_ranges are re-exported)
from .spc5_spmv import (SPLIT_WAVES, _r16, chunk_ranges,  # noqa: F401
                        panels_split, value_window_bytes)

#: Launches per wrapper since the last :func:`reset_launches`.
LAUNCHES: Dict[str, int] = {"spmv_cuda_desc": 0, "spmv_cuda_desc_db": 0,
                            "spmv_cuda_panels_desc": 0,
                            "spmv_cuda_panels_desc_db": 0,
                            "spmv_cuda_panels_desc_cmap": 0,
                            "spmv_cuda_panels_desc_db_cmap": 0}

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
# launch planning shared by both layouts
# ----------------------------------------------------------------------------

def _fit(stages: int, cb: int, nbytes) -> Tuple[int, int, int]:
    """(stages, blocks per stage, shared bytes per CTA) from
    ``nbytes(stages, blocks per stage)``: ``stages == 1`` stages whole chunks
    cut into slices of fewer blocks (halved) while they do not fit a CTA;
    a ring of ``stages`` whole chunks is shortened (down to 2) while it does
    not fit. The bytes may still be more than a CTA has."""
    nb = cb
    if stages == 1:
        while nb > 1 and nbytes(1, nb) > K.MAX_SMEM_BYTES:
            nb = -(-nb // 2)
    else:
        while stages > 2 and nbytes(stages, nb) > K.MAX_SMEM_BYTES:
            stages -= 1
    return stages, nb, nbytes(stages, nb)


def _fit_stages(stages: int, cb: int, nbytes, what: str
                ) -> Tuple[int, int, int]:
    """:func:`_fit`, raising ``ValueError`` when even that does not fit."""
    stages, nb, smem = _fit(stages, cb, nbytes)
    K._check_smem(smem, what)
    return stages, nb, smem


_OCCUPANCY: Dict[Tuple, Tuple[int, int]] = {}


def _occupancy(layout: str, stages: int, threads: int, smem: int,
               device: torch.device, vsize: int = 4) -> Tuple[int, int]:
    """(CTAs one SM holds at once, SMs) for the ``layout`` kernel ("whole",
    "panels" or "panels_cmap", the panel kernel with a column map) of
    ``vsize``-byte values at ``stages`` (1: the synchronous one), as the
    CUDA runtime reports them."""
    key = (layout, stages, vsize, threads, smem, device.index or 0)
    if key not in _OCCUPANCY:
        lib = _build.load_library("spc5_spmv_desc")
        out = (ctypes.c_int * 2)()
        fn = f"spc5_spmv_desc_{layout}_occupancy"
        err = getattr(lib, fn)(stages, vsize, threads, smem, key[-1],
                               ctypes.addressof(out))
        K._raise_on(err, fn)
        _OCCUPANCY[key] = (out[0], out[1])
    return _OCCUPANCY[key]


# ----------------------------------------------------------------------------
# whole-vector layout
# ----------------------------------------------------------------------------

#: Stages in the ring of ``spmv_cuda_desc_db``, the only ring its kernel is
#: built for: one chunk is staged ahead of the decode. A ring of 3 (two CTAs
#: an SM on the token plan, against three) was slower on every smoke plan
#: on the H100 (PERF.md §6). A ring that does not fit a CTA is refused.
WHOLE_DB_STAGES = 2

#: Rows of the y tile a whole-vector CTA sums into before it adds them into
#: y, one global atomic a nonzero row. A chunk of the vocab token plan spans
#: 4-8 rows, one of the FEM plan about 85; tiles of 64 and 4,096 rows were
#: no faster on the H100 (PERF.md §6).
WHOLE_TILE_ROWS = 512

#: Lane quads of a stage each whole-vector thread decodes, and the most
#: threads a CTA has: on the H100 one quad a thread was 1.5-1.7x slower on
#: the flat-tail plan's β(2,4) chunks, four 1.1x slower on FEM's, and 256
#: threads at most up to 1.14x slower (PERF.md §6).
WHOLE_QUADS_PER_THREAD = 2
WHOLE_THREADS = 512


def whole_smem_bytes(stages: int, nb: int, r: int, c: int, vmax: int,
                     tile: int, wv: int, wx: int, vsize: int = 4) -> int:
    """Dynamic shared memory of one whole-vector CTA: the (tile,) f32 y
    tile, then ``stages`` stages, each the value window
    (:func:`value_window_bytes` of ``vsize``-byte values) and ``nb`` blocks'
    tables (valid and vidx per lane, the c xcol entries of each block's
    first row, a 4-byte slot for its lane-0 yrow entry) and a 16-byte
    mbarrier slot (which also holds a narrow window's offset in its span),
    every part 16-byte aligned. The kernel's ``whole_layout``
    (``csrc/spc5_spmv_desc.cu``) refuses a launch whose figure differs from
    its own."""
    rc = r * c
    stage = (value_window_bytes(vmax, vsize) + _r16(nb * rc)
             + _r16(nb * rc * wv) + _r16(nb * c * wx) + _r16(4 * nb) + 16)
    return _r16(4 * tile) + stages * stage


def whole_stages(stages: int, cb: int, r: int, c: int, vmax: int, tile: int,
                 wv: int, wx: int, what: str = "whole-vector kernel",
                 vsize: int = 4) -> Tuple[int, int, int]:
    """(stages, blocks per stage, shared bytes per CTA) of a whole-vector
    launch (:func:`_fit_stages`) for ``vsize``-byte values: ``stages`` is 1
    (the synchronous kernel) or :data:`WHOLE_DB_STAGES`, never
    shortened."""
    if stages not in (1, WHOLE_DB_STAGES):
        raise ValueError(f"the whole-vector kernels stage 1 or "
                         f"{WHOLE_DB_STAGES} chunks, not {stages}")
    return _fit_stages(stages, cb, lambda s, nb: whole_smem_bytes(
        s, nb, r, c, vmax, tile, wv, wx, vsize), what)


def whole_launch(stages: int, nchunks: int, *, cb: int, r: int, c: int,
                 vmax: int, wv: int, wx: int, device: torch.device,
                 grid: Optional[int] = None,
                 what: str = "whole-vector kernel",
                 vsize: int = 4) -> Dict[str, int]:
    """The launch a whole-vector wrapper makes on ``device`` (a card) for
    ``vsize``-byte values: ``stages``, ``blocks_per_stage``,
    ``smem_bytes``, ``threads`` and ``tile_rows`` per CTA, the card's
    ``ctas_per_sm`` and ``sms``, ``grid`` (G, from :func:`panels_split`
    over one "panel" of every chunk unless given) and ``chunks_per_cta``
    (the longest range)."""
    tile = WHOLE_TILE_ROWS
    stages, nb, smem = whole_stages(stages, cb, r, c, vmax, tile, wv, wx,
                                    what, vsize)
    quads = nb * r * c // 4
    threads = min(WHOLE_THREADS, max(64, -(-quads // (
        32 * WHOLE_QUADS_PER_THREAD)) * 32))
    per_sm, sms = _occupancy("whole", stages, threads, smem, device, vsize)
    if grid is None:
        grid = panels_split(1, nchunks, per_sm, sms)
    if not 1 <= grid <= nchunks:
        raise ValueError(f"grid must be in [1, {nchunks}] (the chunks), "
                         f"got {grid}")
    return dict(stages=stages, blocks_per_stage=nb, smem_bytes=smem,
                threads=threads, tile_rows=tile, ctas_per_sm=per_sm, sms=sms,
                grid=grid, chunks_per_cta=-(-nchunks // grid))


def _whole(fn: str, stages: int, chunk_vbase, desc_valid, desc_vidx,
           desc_xcol, desc_yrow, values, x, value_scale, *, r, c, cb, vmax,
           nrows, ncols, grid=None):
    nchunks = desc_valid.shape[0]
    K._check(dict(chunk_vbase=chunk_vbase, values=values, x=x),
             {"chunk_vbase": (nchunks,), "x": (ncols,)}, values.device)
    K._check_values(fn, values, value_scale, (nchunks,))
    tables = dict(desc_valid=desc_valid, desc_vidx=desc_vidx,
                  desc_xcol=desc_xcol, desc_yrow=desc_yrow)
    _check_tables(tables, dict(desc_vidx=vmax, desc_xcol=ncols,
                               desc_yrow=nrows),
                  (nchunks, cb, r * c), values.device)
    if values.device.type == "cpu":
        return R.spmv_desc(R.SPC5DescDevice(values, desc_valid, desc_vidx,
                                            desc_xcol, desc_yrow,
                                            chunk_vbase), x, value_scale,
                           nrows=nrows)
    if values.device.type != "cuda":
        raise ValueError(f"no kernel for device {values.device}")
    if vmax % 4:
        raise ValueError(f"vmax must be a multiple of 4 (whole 16-byte "
                         f"value windows), got {vmax}")
    wv, wx, wy = _widths(desc_vidx, desc_xcol, desc_yrow)
    vsize = values.element_size()
    launch = whole_launch(stages, nchunks, cb=cb, r=r, c=c, vmax=vmax, wv=wv,
                          wx=wx, device=values.device, grid=grid, what=fn,
                          vsize=vsize)
    K._aligned({"values": values})
    # the tables are copied in 4-byte pieces where 16-byte ones do not align
    K._aligned(tables, 4)
    lib = _build.load_library("spc5_spmv_desc")
    # every CTA adds its rows into y
    y = torch.zeros(nrows, dtype=torch.float32, device=values.device)
    err = getattr(lib, f"spc5_spmv_desc_whole_s{stages}")(
        chunk_vbase.data_ptr(), desc_valid.data_ptr(), desc_vidx.data_ptr(),
        desc_xcol.data_ptr(), desc_yrow.data_ptr(), values.data_ptr(),
        K._scale_ptr(value_scale), x.data_ptr(), y.data_ptr(), nchunks, cb,
        r, c, vmax, vsize, values.numel(), wv, wx, wy, launch["grid"],
        *([launch["blocks_per_stage"]] if stages == 1 else []),
        launch["tile_rows"], launch["smem_bytes"], launch["threads"],
        values.device.index or 0, K._stream(values.device))
    K._raise_on(err, fn)
    LAUNCHES[fn] += 1
    return y


def spmv_cuda_desc(chunk_vbase, desc_valid, desc_vidx, desc_xcol, desc_yrow,
                   values, x, value_scale=None, *, r: int, c: int, cb: int,
                   vmax: int, nrows: int, ncols: int,
                   grid: Optional[int] = None) -> torch.Tensor:
    """Whole-vector descriptor SpMV, the chunks cut into ``grid`` contiguous
    ranges (one CTA each; default from the card's occupancy), each chunk's
    stage copied and waited for before its decode, rows summed in a y tile
    (replaces ``spmv_pallas_desc``). A column permutation would already be
    folded into ``desc_xcol``, so there is no ``col_map``. ``values`` f32,
    bf16 or int8 (with ``value_scale``, (nchunks,) float32)."""
    return _whole("spmv_cuda_desc", 1, chunk_vbase, desc_valid, desc_vidx,
                  desc_xcol, desc_yrow, values, x, value_scale, r=r, c=c,
                  cb=cb,
                  vmax=vmax, nrows=nrows, ncols=ncols, grid=grid)


def spmv_cuda_desc_db(chunk_vbase, desc_valid, desc_vidx, desc_xcol,
                      desc_yrow, values, x, value_scale=None, *, r: int,
                      c: int, cb: int, vmax: int, nrows: int, ncols: int,
                      grid: Optional[int] = None) -> torch.Tensor:
    """Whole-vector descriptor SpMV with a ring of :data:`WHOLE_DB_STAGES`
    chunks (tables and value window) staged ahead by bulk copies and
    cp.async (replaces ``spmv_pallas_desc_db``); ``grid`` and ``values`` as
    in :func:`spmv_cuda_desc`."""
    return _whole("spmv_cuda_desc_db", WHOLE_DB_STAGES, chunk_vbase,
                  desc_valid, desc_vidx, desc_xcol, desc_yrow, values, x,
                  value_scale, r=r, c=c, cb=cb, vmax=vmax, nrows=nrows, ncols=ncols,
                  grid=grid)


# ----------------------------------------------------------------------------
# panel layout
# ----------------------------------------------------------------------------

#: Stages in the ring of ``spmv_cuda_panels_desc_db``: chunks staged ahead of
#: the decode are DB_STAGES - 1 (``time_panels_desc.py`` times rings of 2 and
#: 3). A ring that does not fit a CTA shortens to 2 (:func:`panels_stages`).
DB_STAGES = 3


def panels_smem_bytes(stages: int, nb: int, r: int, c: int, vmax: int,
                      xw: int, pr: int, wv: int, wx: int,
                      vsize: int = 4) -> int:
    """Dynamic shared memory of one panel-kernel CTA: the (pr,) f32 y tile,
    then ``stages`` stages, each the value window (:func:`value_window_bytes`
    of ``vsize``-byte values) and x window and ``nb`` blocks' tables (valid
    and vidx per lane, the c xcol entries of each block's first row, a
    4-byte slot for its lane-0 yrow entry), every part 16-byte aligned. The
    kernel's ``stage_layout`` (``csrc/spc5_spmv_desc.cu``) refuses a launch
    whose figure differs from its own."""
    rc = r * c
    stage = (value_window_bytes(vmax, vsize) + _r16(4 * xw) + _r16(nb * rc)
             + _r16(nb * rc * wv) + _r16(nb * c * wx) + _r16(4 * nb))
    return _r16(4 * pr) + stages * stage


def panels_stages(stages: int, cb: int, r: int, c: int, vmax: int, xw: int,
                  pr: int, wv: int, wx: int,
                  what: str = "panel kernel",
                  vsize: int = 4) -> Tuple[int, int, int]:
    """(stages, blocks per stage, shared bytes per CTA) of a panel launch
    (:func:`_fit_stages`)."""
    return _fit_stages(stages, cb, lambda s, nb: panels_smem_bytes(
        s, nb, r, c, vmax, xw, pr, wv, wx, vsize), what)


def panels_occupancy(stages: int, threads: int, smem: int,
                     device: torch.device, vsize: int = 4,
                     mapped: bool = False) -> Tuple[int, int]:
    """(CTAs one SM holds at once, SMs) for the panel kernel of
    ``vsize``-byte values at ``stages`` (1: the synchronous one), with a
    column map where ``mapped``, as the CUDA runtime reports them."""
    return _occupancy("panels_cmap" if mapped else "panels", stages, threads,
                      smem, device, vsize)


def panels_launch(stages: int, npanels: int, nchunks: int, *, cb: int,
                  r: int, c: int, vmax: int, xw: int, pr: int, wv: int,
                  wx: int, device: torch.device, split: Optional[int] = None,
                  what: str = "panel kernel", vsize: int = 4,
                  mapped: bool = False) -> Dict[str, int]:
    """The launch a panel wrapper makes on ``device`` (a card) for
    ``vsize``-byte values, with a column map where ``mapped`` (the same
    stages; the occupancy is the map kernel's): ``stages``,
    ``blocks_per_stage``, ``smem_bytes`` and ``threads`` per CTA, the
    card's ``ctas_per_sm`` and ``sms``, ``split`` (S, from
    :func:`panels_split` unless given) and ``grid`` (npanels * S)."""
    stages, nb, smem = panels_stages(stages, cb, r, c, vmax, xw, pr, wv, wx,
                                     what, vsize)
    threads = K._threads(nb * r * c // 4)       # a thread per lane quad
    per_sm, sms = panels_occupancy(stages, threads, smem, device, vsize,
                                   **({"mapped": True} if mapped else {}))
    if split is None:
        split = panels_split(npanels, nchunks, per_sm, sms)
    if not 1 <= split <= nchunks:
        raise ValueError(f"split must be in [1, {nchunks}] (the chunks of a "
                         f"panel), got {split}")
    return dict(stages=stages, blocks_per_stage=nb, smem_bytes=smem,
                threads=threads, ctas_per_sm=per_sm, sms=sms, split=split,
                grid=npanels * split)


def _panels(fn: str, stages: int, chunk_vbase, chunk_xbase, desc_valid,
            desc_vidx, desc_xcol, desc_yrow, values, x, col_map, value_scale,
            *, r, c, cb, vmax, xw, pr, nrows, ncols_pad, split=None):
    npanels, nchunks = chunk_vbase.shape
    K._check(dict(chunk_vbase=chunk_vbase, chunk_xbase=chunk_xbase,
                  values=values, x=x),
             {"chunk_xbase": (npanels, nchunks)}, values.device)
    K._check_values(fn, values, value_scale, (npanels, nchunks))
    tables = dict(desc_valid=desc_valid, desc_vidx=desc_vidx,
                  desc_xcol=desc_xcol, desc_yrow=desc_yrow)
    _check_tables(tables, dict(desc_vidx=vmax, desc_xcol=xw, desc_yrow=pr),
                  (npanels, nchunks, cb, r * c), values.device)
    if x.dim() != 1:
        raise ValueError(f"x must be 1-D, got shape {tuple(x.shape)}")
    if npanels * pr < nrows:
        raise ValueError(f"{npanels} panels of {pr} rows cannot hold "
                         f"{nrows} rows")
    K._check_map(col_map, x.shape[0], values.device)
    if values.device.type == "cpu":
        return R.spmv_panels_desc(
            R.SPC5PanelDescDevice(values, desc_valid, desc_vidx, desc_xcol,
                                  desc_yrow, chunk_vbase, chunk_xbase), x,
            col_map, value_scale, pr=pr, nrows=nrows, ncols_pad=ncols_pad)
    if values.device.type != "cuda":
        raise ValueError(f"no kernel for device {values.device}")
    mapped = col_map is not None
    wv, wx, wy = _widths(desc_vidx, desc_xcol, desc_yrow)
    vsize = values.element_size()
    launch = panels_launch(stages, npanels, nchunks, cb=cb, r=r, c=c,
                           vmax=vmax, xw=xw, pr=pr, wv=wv, wx=wx,
                           device=values.device, split=split, what=fn,
                           vsize=vsize, mapped=mapped)
    if mapped:
        # x is read in place through the map, 4 bytes at a time, never at
        # or past ncols
        xp = x
        K._aligned({"values": values})
    else:
        # every chunk stages an xw-wide window of x at chunk_xbase: pad x so
        # the last window stays in bounds, as the Pallas wrappers do
        xp = torch.nn.functional.pad(x, (0, max(0, ncols_pad - x.shape[0])))
        K._aligned({"values": values, "x": xp})
    # the tables are copied in 4-byte pieces where 16-byte ones do not align
    K._aligned(tables, 4)
    lib = _build.load_library("spc5_spmv_desc")
    # S > 1 CTAs add into each panel's rows, so y starts at 0
    y = (torch.zeros if launch["split"] > 1 else torch.empty)(
        nrows, dtype=torch.float32, device=values.device)
    entry = (f"spc5_spmv_desc_panels{'_cmap' if mapped else ''}_s"
             f"{1 if stages == 1 else 2}")
    err = getattr(lib, entry)(
        chunk_vbase.data_ptr(), chunk_xbase.data_ptr(), desc_valid.data_ptr(),
        desc_vidx.data_ptr(), desc_xcol.data_ptr(), desc_yrow.data_ptr(),
        values.data_ptr(),
        K._scale_ptr(value_scale), xp.data_ptr(),
        y.data_ptr(), npanels, nchunks, cb, r, c, vmax, xw, pr, nrows, vsize,
        values.numel(), wv, wx, wy, launch["split"],
        launch["blocks_per_stage"] if stages == 1 else launch["stages"],
        launch["smem_bytes"], launch["threads"], values.device.index or 0,
        K._stream(values.device),
        *((col_map.data_ptr(), x.shape[0]) if mapped else ()))
    fn = f"{fn}_cmap" if mapped else fn
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
    x is (ncols,), padded here. ``values`` f32, bf16 or int8 (with
    ``value_scale``, (npanels, nchunks) float32). ``col_map`` (int32, as
    long as x: a reordered plan's column permutation) launches the
    column-map twin, which gathers each x window through it from x in the
    original order (counted as ``spmv_cuda_panels_desc_cmap``); the ring's
    twin reads x through it at each set lane."""
    return _panels("spmv_cuda_panels_desc", 1, chunk_vbase, chunk_xbase,
                   desc_valid, desc_vidx, desc_xcol, desc_yrow, values, x,
                   col_map, value_scale, r=r, c=c, cb=cb, vmax=vmax, xw=xw, pr=pr, nrows=nrows,
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
    ``spmv_pallas_panels_desc_db``); ``values`` and ``col_map`` as in
    :func:`spmv_cuda_panels_desc` (counted as
    ``spmv_cuda_panels_desc_db_cmap`` with a map)."""
    return _panels("spmv_cuda_panels_desc_db", DB_STAGES,
                   chunk_vbase, chunk_xbase, desc_valid, desc_vidx,
                   desc_xcol, desc_yrow, values, x, col_map, value_scale, r=r, c=c, cb=cb,
                   vmax=vmax, xw=xw, pr=pr, nrows=nrows,
                   ncols_pad=ncols_pad, split=split)


# ----------------------------------------------------------------------------
# shared-memory contracts (the static verifier's vmem-budget rule)
# ----------------------------------------------------------------------------

def table_widths(geom, layout: str) -> Tuple[int, int]:
    """(vidx, xcol) bytes of a descriptor plan's tables, as the build
    narrows them (:func:`repro_torch.core.formats.chunk_descriptors`) from
    the geometry: vidx under vmax, xcol under ncols (whole-vector) or xw
    (panels)."""
    xmax = geom["ncols"] if layout == "whole_vector" else geom["xw"]
    return (F.narrow_index_dtype(max(geom["vmax"] - 1, 0)).itemsize,
            F.narrow_index_dtype(max(xmax - 1, 0)).itemsize)


def whole_contract(geom, vsize: int = 4, nvec: int = 1) -> int:
    """Shared memory a CTA of the whole-vector descriptor SpMV kernels asks
    for at one stage, the fewest their launcher (:func:`whole_stages`)
    takes, for a plan of geometry ``geom`` and ``vsize``-byte values;
    computed on the host, without a card."""
    r, c, vmax = geom["r"], geom["c"], geom["vmax"]
    wv, wx = table_widths(geom, "whole_vector")
    return _fit(1, geom["cb"], lambda s, nb: whole_smem_bytes(
        s, nb, r, c, vmax, WHOLE_TILE_ROWS, wv, wx, vsize))[2]


def panels_contract(geom, vsize: int = 4, nvec: int = 1) -> int:
    """The same for the panel descriptor SpMV kernels
    (:func:`panels_stages`)."""
    r, c, vmax = geom["r"], geom["c"], geom["vmax"]
    wv, wx = table_widths(geom, "panels")
    return _fit(1, geom["cb"], lambda s, nb: panels_smem_bytes(
        s, nb, r, c, vmax, geom["xw"], geom["pr"], wv, wx, vsize))[2]


#: The descriptor lowering's SpMV contracts (:data:`.spc5_spmv.
#: SMEM_CONTRACTS`).
SMEM_CONTRACTS = {
    ("whole_vector", "descriptor"): whole_contract,
    ("panels", "descriptor"): panels_contract,
}
