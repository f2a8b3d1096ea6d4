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
their own tiles, which changes nothing in the result: the whole-vector
kernel tiles of at most 32 columns, one lane a column
(:func:`column_tile`); the panel kernels tiles of up to 128 columns, four
columns a lane, with S CTAs per panel, row part and tile
(:func:`panels_launch`; ``split`` overrides S). The panel kernels read X in
place: a column at or past its rows adds nothing, which is what the
reference's zero padding to ``ncols_pad`` gives.

A CPU tensor goes to the plain PyTorch version (:mod:`repro_torch.core.
ref_spmv`); a CUDA tensor goes to the kernel, or the wrapper raises. Each
wrapper counts the launches of its kernel in :data:`LAUNCHES` (CPU calls
launch nothing and count nothing).
"""
from __future__ import annotations

import ctypes
from typing import Callable, Dict, List, Optional, Tuple

import torch

from repro_torch.core import ref_spmv as R

from . import _build
from .spc5_spmv import (MAX_SMEM_BYTES, _aligned, _check, _check_smem,
                        _raise_on, _stream, _unsupported, panels_split)

#: Launches per wrapper since the last :func:`reset_launches`.
LAUNCHES: Dict[str, int] = {"spmm_cuda": 0, "spmm_cuda_panels": 0,
                            "spmm_cuda_panels_db": 0}

_MAX_TILE = 32               # whole-vector columns per lane group: one warp
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
    """The whole-vector kernels' column tile (``spmm_cuda``, and the
    descriptor ``spmm_cuda_desc``): the smallest power of two covering nvec,
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




# ----------------------------------------------------------------------------
# panel layout
# ----------------------------------------------------------------------------

#: Stages in the ring of ``spmm_cuda_panels_db``: one stage is filled while
#: the other is walked. The synchronous kernel holds one stage.
PANEL_DB_STAGES = 2

#: Threads of a panel CTA, a power of two. ``None`` (:func:`panels_plan`):
#: 512 where a lane group is a whole warp, else 256.
#: ``time_spmm_desc.py --lowering mask`` sweeps it.
PANEL_THREADS: Optional[int] = None

#: The widest column tile a panel CTA takes: 32 lanes of four columns.
PANEL_TILE = 128

#: The fewest row parts a panel is cut into (each part its own CTA with a
#: Y tile of its rows); more until two CTAs fit an SM, or one does.
PANEL_ROW_PARTS = 1

#: The most chunks a stage holds, so that a CTA lists and walks that many
#: chunks' nonzeros between two barriers; fewer where more would cost
#: CTAs an SM (by shared memory, and by registers: the kernels take at most
#: 64 a thread). Four were 2.1x faster than one at nvec 128 on the H100
#: (PERF.md §6); ``time_spmm_desc.py --lowering mask`` sweeps 1, 2, 4.
PANEL_STAGE_CHUNKS = 4

#: An H100 SM's shared memory, 1 KB of it reserved per CTA, and what one CTA
#: may use when two share it; its registers, and the most a panel-kernel
#: thread takes (``__launch_bounds__(512, 2)``).
SM_SMEM_BYTES = 228 * 1024
TWO_CTA_SMEM_BYTES = SM_SMEM_BYTES // 2 - 1024
SM_REGISTERS = 65536
MAX_REGISTERS = 64


def _r16(n: int) -> int:
    return -(-n // 16) * 16


def panels_vector(nvec: int, x: Optional[torch.Tensor] = None) -> int:
    """The columns of X a panel-kernel lane owns: 4 (one 16-byte load) or 2
    (8 bytes) where they divide nvec and X is so aligned, else 1."""
    for vec in (4, 2):
        if nvec % vec == 0 and (x is None or x.data_ptr() % (4 * vec) == 0):
            return vec
    return 1


def panels_smem_bytes(stages: int, q: int, cb: int, vmax: int, prows: int,
                      tw: int) -> int:
    """Dynamic shared memory of one panel CTA: the (prows, tw) f32 Y tile
    of its row part, then ``stages`` stages, each the value windows and x
    window starts of its ``q`` chunks, the four metadata rows of their q *
    cb blocks (col, mask, voff, row) and a 16-byte slot for the mbarrier and
    two counters, then the sort keys of the q * cb blocks (4 bytes a block)
    and the walk's list of the stage's nonzeros (16 bytes each, at most q *
    vmax), every part 16-byte aligned. The kernel's ``panel_layout``
    (``csrc/spc5_spmm.cu``) refuses a launch whose figure differs from its
    own."""
    nb = q * cb
    stage = q * _r16(4 * vmax) + _r16(4 * q) + 4 * _r16(4 * nb) + 16
    return (_r16(4 * prows * tw) + stages * stage + _r16(4 * nb)
            + 16 * q * vmax)


def panels_tiles(nvec: int, vec: int) -> List[int]:
    """The column tiles a panel launch may take, widest first: a power of
    two covering nvec, at most :data:`PANEL_TILE` and 32 lanes of ``vec``
    columns, halved down to 1. A tile of tw columns has tw / min(vec, tw)
    lanes a group."""
    tw = min(PANEL_TILE, 32 * vec, 1 << max(0, nvec - 1).bit_length())
    out = []
    while tw >= 1:
        out.append(tw)
        tw //= 2
    return out


def _panel_block(r: int, c: int) -> None:
    """The panel kernels walk blocks of c = 4 or 8 columns and r = 1, 2, 4
    or 8 rows, r * c <= 32 (every shape of ``formats.SUPPORTED_BLOCKS``)."""
    if r not in (1, 2, 4, 8) or c not in (4, 8) or r * c > 32:
        raise ValueError(f"no panel SpMM kernel for beta({r},{c})")


def panels_plan(stages: int, cb: int, r: int, c: int, vmax: int, pr: int,
                nvec: int, vec: int,
                what: str = "panel kernel") -> Dict[str, int]:
    """The CTA of a panel launch: the widest tile of :func:`panels_tiles`,
    cut among the fewest row parts (from :data:`PANEL_ROW_PARTS`, doubling,
    each a multiple of r rows) at which two CTAs fit an SM
    (:data:`TWO_CTA_SMEM_BYTES`), else at which one CTA fits; a stage holds
    the most chunks, up to :data:`PANEL_STAGE_CHUNKS`, that keep the CTAs an
    SM holds with one. Returns ``chunks_per_stage``, ``tile_columns``, ``vector``
    (columns a lane), ``lanes`` (of a group), ``threads``, ``row_parts``,
    ``part_rows`` and ``smem_bytes``; raises ``ValueError`` when nothing
    fits or there is no kernel for beta(r,c)."""
    _panel_block(r, c)
    if stages not in (1, PANEL_DB_STAGES):
        raise ValueError(f"the panel kernels stage 1 or {PANEL_DB_STAGES} "
                         f"chunks, not {stages}")
    for tw in panels_tiles(nvec, vec):
        v = min(vec, tw)
        threads = PANEL_THREADS or (512 if tw // v == 32 else 256)
        for budget in (TWO_CTA_SMEM_BYTES, MAX_SMEM_BYTES):
            parts = PANEL_ROW_PARTS
            while True:
                prows = -(-pr // (parts * r)) * r

                def nbytes(q, prows=prows, tw=tw):
                    return panels_smem_bytes(stages, q, cb, vmax, prows, tw)

                def ctas(q):  # an SM's CTAs by shared memory and registers
                    return min(SM_SMEM_BYTES // (nbytes(q) + 1024),
                               SM_REGISTERS // (MAX_REGISTERS * threads))
                fits = [q for q in range(PANEL_STAGE_CHUNKS, 0, -1)
                        if nbytes(q) <= budget and ctas(q) >= ctas(1)]
                if fits:
                    return dict(chunks_per_stage=fits[0], tile_columns=tw,
                                vector=v, lanes=tw // v, threads=threads,
                                row_parts=-(-pr // prows), part_rows=prows,
                                smem_bytes=nbytes(fits[0]))
                if prows == r:
                    break
                parts *= 2
    _check_smem(nbytes(1), what)


_OCCUPANCY: Dict[Tuple[int, ...], Tuple[int, int]] = {}


def panels_occupancy(stages: int, c: int, vec: int, threads: int, smem: int,
                     device: torch.device) -> Tuple[int, int]:
    """(CTAs one SM holds at once, SMs) for the panel kernel of block width
    c, ``vec`` columns a lane and ``stages`` (1: the synchronous one), as
    the CUDA runtime reports them."""
    key = (stages, c, vec, threads, smem, device.index or 0)
    if key not in _OCCUPANCY:
        lib = _build.load_library("spc5_spmm")
        out = (ctypes.c_int * 2)()
        err = lib.spc5_spmm_panels_occupancy(*key, ctypes.addressof(out))
        _raise_on(err, "spc5_spmm_panels_occupancy")
        _OCCUPANCY[key] = (out[0], out[1])
    return _OCCUPANCY[key]


def panels_launch(stages: int, npanels: int, nchunks: int, *, cb: int,
                  r: int, c: int, vmax: int, pr: int, nvec: int, vec: int,
                  device: torch.device, split: Optional[int] = None,
                  what: str = "panel kernel") -> Dict[str, int]:
    """The launch a panel wrapper makes on ``device`` (a card) for lanes of
    at most ``vec`` columns (:func:`panels_vector`): ``stages``, the CTA of
    :func:`panels_plan`, ``ntiles``, the card's ``ctas_per_sm`` and ``sms``,
    ``split`` (S, from :func:`~.spc5_spmv.panels_split` over npanels x row
    parts x ntiles units unless given), ``grid`` (npanels x S x row parts x
    ntiles) and ``chunks_per_cta`` (the longest range)."""
    cta = panels_plan(stages, cb, r, c, vmax, pr, nvec, vec, what)
    per_sm, sms = panels_occupancy(stages, c, cta["vector"], cta["threads"],
                                   cta["smem_bytes"], device)
    ntiles = -(-nvec // cta["tile_columns"])
    units = npanels * cta["row_parts"] * ntiles
    if split is None:
        split = panels_split(units, nchunks, per_sm, sms)
    if not 1 <= split <= nchunks:
        raise ValueError(f"split must be in [1, {nchunks}] (the chunks of a "
                         f"panel), got {split}")
    grid = units * split
    if grid > _MAX_GRID:
        raise ValueError(f"{what}: {grid} CTAs exceed the grid's "
                         f"{_MAX_GRID}")
    return dict(stages=stages, **cta, ntiles=ntiles, ctas_per_sm=per_sm,
                sms=sms, split=split, grid=grid,
                chunks_per_cta=-(-nchunks // split))


def _panels(fn: str, stages: int, chunk_vbase, chunk_xbase, chunk_col,
            chunk_mask, chunk_voff, chunk_row, values, x, *, r, c, cb, vmax,
            xw, pr, nrows, ncols_pad, nvt, split=None):
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
    if vmax % 4:
        raise ValueError(f"vmax must be a multiple of 4 (whole 16-byte "
                         f"value windows), got {vmax}")
    if x.numel() >= 2 ** 31:
        raise ValueError(f"X has {x.numel()} elements; the kernels index it "
                         f"with 32-bit offsets")
    launch = panels_launch(stages, npanels, nchunks, cb=cb, r=r, c=c,
                           vmax=vmax, pr=pr, nvec=nvec,
                           vec=panels_vector(nvec, x), device=values.device,
                           split=split, what=fn)
    _aligned({"values": values})
    lib = _build.load_library("spc5_spmm")
    # S > 1 CTAs add into each panel's rows, so Y starts at 0
    y = (torch.zeros if launch["split"] > 1 else torch.empty)(
        (nrows, nvec), dtype=torch.float32, device=values.device)
    # X is read in place: the kernels skip any column at or past its rows,
    # which is what the reference's zero padding up to ncols_pad adds
    err = getattr(lib, f"spc5_spmm_panels_s{stages}")(
        chunk_vbase.data_ptr(), chunk_xbase.data_ptr(), chunk_col.data_ptr(),
        chunk_mask.data_ptr(), chunk_voff.data_ptr(), chunk_row.data_ptr(),
        values.data_ptr(), x.data_ptr(), y.data_ptr(), npanels, nchunks, cb,
        vmax, pr, nrows, x.shape[0], r, c, nvec, launch["tile_columns"],
        launch["vector"], launch["row_parts"], launch["part_rows"],
        launch["split"], launch["chunks_per_stage"], launch["smem_bytes"],
        launch["threads"], values.device.index or 0, _stream(values.device))
    _raise_on(err, fn)
    LAUNCHES[fn] += 1
    return y


def spmm_cuda_panels(chunk_vbase, chunk_xbase, chunk_col, chunk_mask,
                     chunk_voff, chunk_row, values, x,
                     col_map: Optional[torch.Tensor] = None,
                     value_scale: Optional[torch.Tensor] = None, *, r: int,
                     c: int, cb: int, vmax: int, xw: int, pr: int,
                     nrows: int, ncols_pad: int, nvt: int = 128,
                     split: Optional[int] = None) -> torch.Tensor:
    """Row-panel SpMM, each panel's chunks split among S CTAs a row part
    and column tile (``split``; default from the card's occupancy), each
    stage of chunks copied and waited for before the walk, one lane group
    adding each row of the Y tile (replaces ``spmm_pallas_panels``). X is
    (ncols, nvec); ``xw`` is the layout's window, kept for the
    signature."""
    _unsupported(col_map, value_scale)
    return _panels("spmm_cuda_panels", 1, chunk_vbase, chunk_xbase,
                   chunk_col, chunk_mask, chunk_voff, chunk_row, values, x,
                   r=r, c=c, cb=cb, vmax=vmax, xw=xw, pr=pr, nrows=nrows,
                   ncols_pad=ncols_pad, nvt=nvt, split=split)


def spmm_cuda_panels_db(chunk_vbase, chunk_xbase, chunk_col, chunk_mask,
                        chunk_voff, chunk_row, values, x,
                        col_map: Optional[torch.Tensor] = None,
                        value_scale: Optional[torch.Tensor] = None, *,
                        r: int, c: int, cb: int, vmax: int, xw: int, pr: int,
                        nrows: int, ncols_pad: int, nvt: int = 128,
                        split: Optional[int] = None) -> torch.Tensor:
    """Row-panel SpMM with a ring of :data:`PANEL_DB_STAGES` stages of
    chunks (value windows and metadata) staged ahead by bulk copies
    (replaces ``spmm_pallas_panels_db``); ``split`` as in
    :func:`spmm_cuda_panels`."""
    _unsupported(col_map, value_scale)
    return _panels("spmm_cuda_panels_db", PANEL_DB_STAGES, chunk_vbase,
                   chunk_xbase, chunk_col, chunk_mask, chunk_voff, chunk_row,
                   values, x, r=r, c=c, cb=cb, vmax=vmax, xw=xw, pr=pr,
                   nrows=nrows, ncols_pad=ncols_pad, nvt=nvt, split=split)
