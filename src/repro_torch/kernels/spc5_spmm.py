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
their own tiles, which changes nothing in the result: tiles of up to 128
columns, four columns a lane where nvec and X's alignment allow
(:func:`panels_vector`). The whole-vector kernel cuts all the chunks into G
contiguous ranges a tile (:func:`whole_launch`; ``grid`` overrides G), the
panel kernels each panel's chunks among S CTAs per row part and tile
(:func:`panels_launch`; ``split`` overrides S). The kernels read X in
place: a column at or past its rows adds nothing, which is what the
reference's zero padding to ``ncols_pad`` gives. The whole-vector launch
planning (:func:`whole_plan`, :func:`whole_grid`) is shared with the
descriptor kernel of :mod:`.spc5_spmm_desc`.

Values are f32, bf16 or int8 (with ``value_scale``, one f32 scale a
chunk): each kernel is built for the three, and decodes a value once, as
it lists the nonzeros, the way the reference's ``_expand_vals`` does (bf16
upcast, int8 upcast and then multiplied by its chunk's scale); the walk
and its f32 sums never see the width. A narrow window is staged as the
16-byte aligned span that covers it, kept inside ``values``
(:func:`~.spc5_spmv.value_span`).

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
                        _check_map, _check_values, _raise_on,
                        _refuse_map_on_card, _scale_ptr, _stream,
                        panels_split, value_window_bytes)

#: Launches per wrapper since the last :func:`reset_launches`.
LAUNCHES: Dict[str, int] = {"spmm_cuda": 0, "spmm_cuda_panels": 0,
                            "spmm_cuda_panels_db": 0}

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


#: An H100 SM's shared memory, 1 KB of it reserved per CTA, and what one CTA
#: may use when two share it; its registers, and the most a thread of a
#: panel or whole-vector SpMM kernel takes (``__launch_bounds__(512, 2)``).
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


# ----------------------------------------------------------------------------
# whole-vector layout
# ----------------------------------------------------------------------------

#: Stages in the ring of a whole-vector CTA: one round of chunks is staged
#: while the one before is listed and walked. :func:`whole_plan` takes a
#: single stage instead where that lets an SM hold more CTAs (or a round
#: does not fit a ring), and slices of a chunk where no whole chunk fits.
WHOLE_DB_STAGES = 2

#: Whether a whole-vector CTA stages rounds in a ring: ``None``
#: (:func:`whole_plan`) where an SM then holds as many CTAs as with one
#: stage; ``True`` / ``False`` force it (``time_spmm_desc.py --layout
#: whole`` sweeps both).
WHOLE_RING: Optional[bool] = None

#: Threads of a whole-vector CTA, a power of two. ``None``
#: (:func:`whole_plan`): 512 where a lane group is a whole warp, else 256.
#: ``time_spmm_desc.py --layout whole`` sweeps it.
WHOLE_THREADS: Optional[int] = None

#: The widest column tile a whole-vector CTA takes: 32 lanes of four columns.
WHOLE_TILE = 128

#: Rows of a whole-vector CTA's Y tile. A chunk of the vocab token plan
#: spans 4-8 rows, one of the FEM plan about 85 (its other rows go straight
#: to Y); tiles of 32 and 64 rows were no faster on the H100 (PERF.md §6).
#: ``time_spmm_desc.py --layout whole`` sweeps 16, 32 and 64.
WHOLE_TILE_ROWS = 16

#: The most chunks a whole-vector round stages; fewer where more would cost
#: CTAs an SM (:func:`whole_plan`).
WHOLE_STAGE_CHUNKS = 4

#: 32-bit words of the whole-vector CTA's scan scratch (two areas of 16
#: warps x 8 words).
WHOLE_SCRATCH_WORDS = 2 * 16 * 8


def whole_layout_bytes(stage: int, stages: int, q: int, nb: int, r: int,
                       c: int, vmax: int, tw: int, vec: int, tile_rows: int,
                       threads: int) -> int:
    """Dynamic shared memory of one whole-vector CTA of either lowering
    (``whole_layout`` in ``csrc/spc5_spmm_whole.cuh``) with stages of
    ``stage`` bytes: the (tile_rows, tw) f32 Y tile, each lane group's A and
    B slots (tw floats each) and its 16-byte header, the scan's scratch, the
    list of a round's kept lanes (16 bytes each, at most min(q * vmax, nb *
    r * c)), then ``stages`` stages, every part 16-byte aligned."""
    groups = threads // (tw // vec)
    room = min(q * vmax, nb * r * c)
    return (_r16(4 * tile_rows * tw) + _r16(8 * groups * tw) + 16 * groups
            + 4 * WHOLE_SCRATCH_WORDS + 16 * room + stages * stage)


def _window_meta_bytes(q: int, vsize: int) -> int:
    """Each chunk's window offset and scale (8 bytes) where values are
    narrow: a stage's ``wmeta`` part."""
    return _r16(8 * q) if vsize < 4 else 0


def whole_stage_bytes(q: int, nb: int, vmax: int, vsize: int = 4) -> int:
    """One stage of the mask kernel: q value windows
    (:func:`~.spc5_spmv.value_window_bytes` of ``vsize``-byte values), for
    narrow values each chunk's window offset and scale, the four metadata
    rows of nb blocks (col, mask, voff, row) and a 16-byte mbarrier
    slot."""
    return (q * value_window_bytes(vmax, vsize) + _window_meta_bytes(q, vsize)
            + 4 * _r16(4 * nb) + 16)


def whole_smem_bytes(stages: int, q: int, nb: int, r: int, c: int, vmax: int,
                     tw: int, vec: int, tile_rows: int, threads: int,
                     vsize: int = 4) -> int:
    """Dynamic shared memory of one whole-vector mask CTA
    (:func:`whole_layout_bytes` with :func:`whole_stage_bytes` of
    ``vsize``-byte values). The kernel's launcher refuses a launch whose
    figure differs from its own (``spc5_spmm_whole_smem`` exposes it)."""
    return whole_layout_bytes(whole_stage_bytes(q, nb, vmax, vsize), stages,
                              q, nb, r, c, vmax, tw, vec, tile_rows, threads)


def whole_tiles(nvec: int, vec: int) -> List[int]:
    """The column tiles a whole-vector launch may take, widest first: a power
    of two covering nvec, at most :data:`WHOLE_TILE` and 32 lanes of ``vec``
    columns, halved down to 1."""
    tw = min(WHOLE_TILE, 32 * vec, 1 << max(0, nvec - 1).bit_length())
    out = []
    while tw >= 1:
        out.append(tw)
        tw //= 2
    return out


def whole_plan(nbytes: Callable[..., int], cb: int, r: int, c: int,
               vmax: int, nvec: int, vec: int,
               what: str = "whole-vector kernel") -> Dict[str, int]:
    """The CTA of a whole-vector launch of either lowering, given
    ``nbytes(stages, q, nb, tw, v, tile_rows, threads)``, its shared memory,
    with a Y tile of :data:`WHOLE_TILE_ROWS` rows: the widest tile of
    :func:`whole_tiles`; then, of the rounds of whole chunks (a ring of
    :data:`WHOLE_DB_STAGES` or one stage, as :data:`WHOLE_RING` allows, up
    to :data:`WHOLE_STAGE_CHUNKS` chunks a round) that fit a CTA, the one at
    which an SM holds the most CTAs (by shared memory and by registers, 64
    a thread), then a ring, then the most chunks a round. Where no whole
    chunk fits, one stage of a slice of a chunk (halved). Returns
    ``stages``, ``chunks_per_stage``, ``blocks_per_stage``,
    ``tile_columns``, ``vector`` (columns a lane), ``lanes`` (of a group),
    ``threads``, ``tile_rows`` and ``smem_bytes``; raises ``ValueError``
    when nothing fits."""
    rings = {None: (WHOLE_DB_STAGES, 1), True: (WHOLE_DB_STAGES,),
             False: (1,)}[WHOLE_RING]
    rows = WHOLE_TILE_ROWS
    least = None
    for tw in whole_tiles(nvec, vec):
        v = min(vec, tw)
        lanes = tw // v
        threads = WHOLE_THREADS or (512 if lanes == 32 else 256)
        if threads < lanes:
            continue

        def ctas(n):  # an SM's CTAs by shared memory and registers
            return min(SM_SMEM_BYTES // (n + 1024),
                       SM_REGISTERS // (MAX_REGISTERS * threads))
        rounds = [(stages, q, q * cb) for stages in rings
                  for q in range(WHOLE_STAGE_CHUNKS, 0, -1)]
        nb = cb
        while nb > 1:  # slices of a chunk, where no whole chunk fits
            nb = -(-nb // 2)
            rounds.append((1, 1, nb))
        best = None
        for stages, q, nb in rounds:
            n = nbytes(stages, q, nb, tw, v, rows, threads)
            least = n if least is None else min(least, n)
            if n > MAX_SMEM_BYTES:
                continue
            if nb < cb and best is not None:
                break
            key = (ctas(n), stages, q)
            if best is None or key > best[0]:
                best = (key, dict(stages=stages, chunks_per_stage=q,
                                  blocks_per_stage=nb, tile_columns=tw,
                                  vector=v, lanes=lanes, threads=threads,
                                  tile_rows=rows, smem_bytes=n))
        if best is not None:
            return best[1]
    _check_smem(least, what)
    raise ValueError(f"{what}: no launch fits")


def whole_grid(plan: Dict[str, int], occupancy, nchunks: int, nvec: int,
                 grid: Optional[int] = None,
                 what: str = "whole-vector kernel") -> Dict[str, int]:
    """The launch of a whole-vector CTA ``plan`` (:func:`whole_plan`) on
    the card: ``ntiles``, the card's ``ctas_per_sm`` and ``sms`` (from
    ``occupancy(threads, smem)``), ``grid`` (G, the CTAs of a column tile,
    each a contiguous range of the chunks: from
    :func:`~.spc5_spmv.panels_split` over the ntiles units unless given)
    and ``chunks_per_cta`` (the longest range)."""
    per_sm, sms = occupancy(plan["threads"], plan["smem_bytes"])
    ntiles = -(-nvec // plan["tile_columns"])
    if grid is None:
        grid = panels_split(ntiles, nchunks, per_sm, sms)
    if not 1 <= grid <= nchunks:
        raise ValueError(f"grid must be in [1, {nchunks}] (the chunks), got "
                         f"{grid}")
    if grid * ntiles > _MAX_GRID:
        raise ValueError(f"{what}: {grid * ntiles} CTAs exceed the grid's "
                         f"{_MAX_GRID}")
    return dict(**plan, ntiles=ntiles, ctas_per_sm=per_sm, sms=sms,
                grid=grid, chunks_per_cta=-(-nchunks // grid))


_WHOLE_OCCUPANCY: Dict[Tuple[int, ...], Tuple[int, int]] = {}


def whole_occupancy(r: int, c: int, vec: int, threads: int, smem: int,
                    device: torch.device, vsize: int = 4) -> Tuple[int, int]:
    """(CTAs one SM holds at once, SMs) for the whole-vector mask kernel of
    ``vsize``-byte values, block shape (r, c) and ``vec`` columns a lane,
    as the CUDA runtime reports them."""
    key = (vsize, r, c, vec, threads, smem, device.index or 0)
    if key not in _WHOLE_OCCUPANCY:
        lib = _build.load_library("spc5_spmm")
        out = (ctypes.c_int * 2)()
        err = lib.spc5_spmm_whole_occupancy(*key, ctypes.addressof(out))
        _raise_on(err, "spc5_spmm_whole_occupancy")
        _WHOLE_OCCUPANCY[key] = (out[0], out[1])
    return _WHOLE_OCCUPANCY[key]


def whole_cta(*, cb: int, r: int, c: int, vmax: int, nvec: int, vec: int,
              what: str = "whole-vector kernel",
              vsize: int = 4) -> Dict[str, int]:
    """The CTA ``spmm_cuda`` plans for lanes of at most ``vec`` columns
    (:func:`panels_vector`) and ``vsize``-byte values: :func:`whole_plan`
    with :func:`whole_smem_bytes`."""
    _panel_block(r, c, "whole-vector")
    return whole_plan(lambda s, q, nb, tw, v, rows, t: whole_smem_bytes(
        s, q, nb, r, c, vmax, tw, v, rows, t, vsize), cb, r, c, vmax, nvec,
        vec, what)


def whole_launch(nchunks: int, *, cb: int, r: int, c: int, vmax: int,
                 nvec: int, vec: int, device: torch.device,
                 grid: Optional[int] = None,
                 what: str = "whole-vector kernel",
                 vsize: int = 4) -> Dict[str, int]:
    """The launch ``spmm_cuda`` makes on ``device`` (a card) for
    ``vsize``-byte values: the CTA of :func:`whole_cta`, then
    :func:`whole_grid`."""
    cta = whole_cta(cb=cb, r=r, c=c, vmax=vmax, nvec=nvec, vec=vec,
                    what=what, vsize=vsize)
    return whole_grid(cta, lambda t, n: whole_occupancy(
        r, c, cta["vector"], t, n, device, vsize), nchunks, nvec, grid,
        what)


def spmm_cuda(chunk_vbase, chunk_col, chunk_mask, chunk_voff, chunk_row,
              values, x, col_map=None, value_scale=None, *, r: int, c: int,
              cb: int, vmax: int, nrows: int, ncols: int,
              nvt: int = 128, grid: Optional[int] = None) -> torch.Tensor:
    """Whole-vector SpMM: the chunks cut into ``grid`` contiguous ranges a
    column tile (default from the card's occupancy), rounds of chunks staged
    in a ring, each round's nonzeros listed by row and walked four at a time
    by the lane groups, rows summed in a Y tile (replaces ``spmm_pallas``,
    which has no double-buffered twin). ``chunk_mask`` is the int32 view of
    the uint32 masks; ``values`` f32, bf16 or int8 (with ``value_scale``,
    (nchunks,) float32). ``col_map`` (int32, (ncols,)) is taken on the CPU
    (the plain version reads ``X[col_map]``); on the card it raises
    (ROADMAP queue 2 B, item 4)."""
    fn = "spmm_cuda"
    nchunks = chunk_col.shape[0]
    named = dict(chunk_vbase=chunk_vbase, chunk_col=chunk_col,
                 chunk_mask=chunk_mask, chunk_voff=chunk_voff,
                 chunk_row=chunk_row, values=values, x=x)
    _check(named, {"chunk_vbase": (nchunks,),
                   **{k: (nchunks, cb) for k in ("chunk_col", "chunk_mask",
                                                 "chunk_voff", "chunk_row")}},
           values.device)
    _check_values(fn, values, value_scale, (nchunks,))
    nvec = _nvec(x, nvt)
    if x.shape[0] != ncols:
        raise ValueError(f"X has shape {tuple(x.shape)}, expected "
                         f"({ncols}, nvec)")
    _check_map(col_map, ncols, values.device)
    _refuse_map_on_card(fn, col_map, values.device, 4)
    if values.device.type == "cpu":
        if col_map is not None:
            x = x.index_select(0, col_map)
        return R.spmm(R.SPC5Device(values, chunk_col, chunk_mask, chunk_voff,
                                   chunk_row, chunk_vbase), x, value_scale,
                      r=r, c=c, nrows=nrows, ncols=ncols)
    if values.device.type != "cuda":
        raise ValueError(f"no kernel for device {values.device}")
    if vmax % 4:
        raise ValueError(f"vmax must be a multiple of 4 (whole 16-byte "
                         f"value windows), got {vmax}")
    if x.numel() >= 2 ** 31:
        raise ValueError(f"X has {x.numel()} elements; the kernels index it "
                         f"with 32-bit offsets")
    vsize = values.element_size()
    launch = whole_launch(nchunks, cb=cb, r=r, c=c, vmax=vmax, nvec=nvec,
                          vec=panels_vector(nvec, x), device=values.device,
                          grid=grid, what=fn, vsize=vsize)
    _aligned({"values": values})
    lib = _build.load_library("spc5_spmm")
    # every CTA adds into Y
    y = torch.zeros((nrows, nvec), dtype=torch.float32, device=values.device)
    err = lib.spc5_spmm_whole(
        chunk_vbase.data_ptr(), chunk_col.data_ptr(), chunk_mask.data_ptr(),
        chunk_voff.data_ptr(), chunk_row.data_ptr(), values.data_ptr(),
        _scale_ptr(value_scale), x.data_ptr(), y.data_ptr(), nchunks, cb,
        vmax, nrows, x.shape[0], r, c, vsize, values.numel(), nvec,
        launch["tile_columns"], launch["vector"], launch["grid"],
        launch["stages"], launch["chunks_per_stage"],
        launch["blocks_per_stage"], launch["tile_rows"], launch["smem_bytes"],
        launch["threads"], values.device.index or 0, _stream(values.device))
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

def panels_smem_bytes(stages: int, q: int, cb: int, vmax: int, prows: int,
                      tw: int, vsize: int = 4) -> int:
    """Dynamic shared memory of one panel CTA: the (prows, tw) f32 Y tile
    of its row part, then ``stages`` stages, each the value windows
    (:func:`~.spc5_spmv.value_window_bytes` of ``vsize``-byte values) and x
    window starts of its ``q`` chunks, for narrow values each chunk's window
    offset and scale (8 bytes), the four metadata rows of their q *
    cb blocks (col, mask, voff, row) and a 16-byte slot for the mbarrier and
    two counters, then the sort keys of the q * cb blocks (4 bytes a block)
    and the walk's list of the stage's nonzeros (16 bytes each, at most q *
    vmax), every part 16-byte aligned. The kernel's ``panel_layout``
    (``csrc/spc5_spmm.cu``) refuses a launch whose figure differs from its
    own."""
    nb = q * cb
    stage = (q * value_window_bytes(vmax, vsize) + _r16(4 * q)
             + _window_meta_bytes(q, vsize) + 4 * _r16(4 * nb) + 16)
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


def _panel_block(r: int, c: int, layout: str = "panel") -> None:
    """The panel and whole-vector kernels walk blocks of c = 4 or 8 columns
    and r = 1, 2, 4 or 8 rows, r * c <= 32 (every shape of
    ``formats.SUPPORTED_BLOCKS``)."""
    if r not in (1, 2, 4, 8) or c not in (4, 8) or r * c > 32:
        raise ValueError(f"no {layout} SpMM kernel for beta({r},{c})")


def panels_plan(stages: int, cb: int, r: int, c: int, vmax: int, pr: int,
                nvec: int, vec: int, what: str = "panel kernel",
                vsize: int = 4) -> Dict[str, int]:
    """The CTA of a panel launch for ``vsize``-byte values: the widest tile
    of :func:`panels_tiles`,
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
                    return panels_smem_bytes(stages, q, cb, vmax, prows, tw,
                                             vsize)

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
                     device: torch.device, vsize: int = 4) -> Tuple[int, int]:
    """(CTAs one SM holds at once, SMs) for the panel kernel of
    ``vsize``-byte values, block width c, ``vec`` columns a lane and
    ``stages`` (1: the synchronous one), as the CUDA runtime reports
    them."""
    key = (stages, vsize, c, vec, threads, smem, device.index or 0)
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
                  what: str = "panel kernel",
                  vsize: int = 4) -> Dict[str, int]:
    """The launch a panel wrapper makes on ``device`` (a card) for lanes of
    at most ``vec`` columns (:func:`panels_vector`) and ``vsize``-byte
    values: ``stages``, the CTA of
    :func:`panels_plan`, ``ntiles``, the card's ``ctas_per_sm`` and ``sms``,
    ``split`` (S, from :func:`~.spc5_spmv.panels_split` over npanels x row
    parts x ntiles units unless given), ``grid`` (npanels x S x row parts x
    ntiles) and ``chunks_per_cta`` (the longest range)."""
    cta = panels_plan(stages, cb, r, c, vmax, pr, nvec, vec, what, vsize)
    per_sm, sms = panels_occupancy(stages, c, cta["vector"], cta["threads"],
                                   cta["smem_bytes"], device, vsize)
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
            chunk_mask, chunk_voff, chunk_row, values, x, col_map,
            value_scale, *, r, c, cb, vmax, xw, pr, nrows, ncols_pad, nvt,
            split=None):
    npanels, nchunks = chunk_vbase.shape
    named = dict(chunk_vbase=chunk_vbase, chunk_xbase=chunk_xbase,
                 chunk_col=chunk_col, chunk_mask=chunk_mask,
                 chunk_voff=chunk_voff, chunk_row=chunk_row, values=values,
                 x=x)
    _check(named, {"chunk_xbase": (npanels, nchunks),
                   **{k: (npanels, nchunks, cb)
                      for k in ("chunk_col", "chunk_mask", "chunk_voff",
                                "chunk_row")}}, values.device)
    _check_values(fn, values, value_scale, (npanels, nchunks))
    nvec = _nvec(x, nvt)
    if npanels * pr < nrows:
        raise ValueError(f"{npanels} panels of {pr} rows cannot hold "
                         f"{nrows} rows")
    _check_map(col_map, x.shape[0], values.device)
    _refuse_map_on_card(fn, col_map, values.device, 4)
    if values.device.type == "cpu":
        return R.spmm_panels(
            R.SPC5PanelDevice(values, chunk_col, chunk_mask, chunk_voff,
                              chunk_row, chunk_vbase, chunk_xbase), x,
            col_map, value_scale, r=r, c=c, pr=pr, nrows=nrows,
            ncols_pad=ncols_pad)
    if values.device.type != "cuda":
        raise ValueError(f"no kernel for device {values.device}")
    if vmax % 4:
        raise ValueError(f"vmax must be a multiple of 4 (whole 16-byte "
                         f"value windows), got {vmax}")
    if x.numel() >= 2 ** 31:
        raise ValueError(f"X has {x.numel()} elements; the kernels index it "
                         f"with 32-bit offsets")
    vsize = values.element_size()
    launch = panels_launch(stages, npanels, nchunks, cb=cb, r=r, c=c,
                           vmax=vmax, pr=pr, nvec=nvec,
                           vec=panels_vector(nvec, x), device=values.device,
                           split=split, what=fn, vsize=vsize)
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
        values.data_ptr(), _scale_ptr(value_scale), x.data_ptr(),
        y.data_ptr(), npanels, nchunks, cb, vmax, pr, nrows, x.shape[0], r, c,
        vsize, values.numel(), nvec, launch["tile_columns"],
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
    signature; ``values`` f32, bf16 or int8 (with ``value_scale``,
    (npanels, nchunks) float32). ``col_map`` (int32, one entry a row of X)
    is taken on the CPU; on the card it raises (ROADMAP queue 2 B, item
    4)."""
    return _panels("spmm_cuda_panels", 1, chunk_vbase, chunk_xbase,
                   chunk_col, chunk_mask, chunk_voff, chunk_row, values, x,
                   col_map, value_scale, r=r, c=c, cb=cb, vmax=vmax, xw=xw, pr=pr, nrows=nrows,
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
    (replaces ``spmm_pallas_panels_db``); ``split`` and ``values`` as in
    :func:`spmm_cuda_panels`; ``col_map`` too."""
    return _panels("spmm_cuda_panels_db", PANEL_DB_STAGES, chunk_vbase,
                   chunk_xbase, chunk_col, chunk_mask, chunk_voff, chunk_row,
                   values, x, col_map, value_scale, r=r, c=c, cb=cb, vmax=vmax, xw=xw, pr=pr,
                   nrows=nrows, ncols_pad=ncols_pad, nvt=nvt, split=split)
