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

The panel wrappers also take ``col_map``, a reordered plan's column
permutation (the Pallas kernels' ``col_map``): with it they launch the
column-map twins of ``csrc/spc5_spmm_desc_cmap.cu`` (a library of its own,
``spc5_spmm_desc_panels_cmap_s1`` / ``_s2``), which read X's row
``col_map[col]`` for a lane of permuted column col, and count the launch as
``spmm_cuda_panels_desc_cmap`` / ``spmm_cuda_panels_desc_db_cmap``.

The reference has no double-buffered whole-vector descriptor SpMM, so
the port has no public twin either (its one kernel keeps a ring of staged
rounds inside). X is (ncols, nvec) and Y (nrows, nvec), both row-major
float32; ``nvt`` keeps the reference's rule (``nvec`` a multiple of
``min(nvt, nvec)``, else ``ValueError``) and the kernels cut the columns
into their own tiles of up to 128 columns, four a lane, as the mask kernels
do (:mod:`.spc5_spmm`): the whole-vector kernel with G contiguous chunk
ranges a tile (:func:`whole_launch`, the mask kernel's planning; ``grid``
overrides G), the panel kernels with S CTAs per panel, row part and tile
(:func:`panels_launch`; ``split`` overrides S). The tables are taken
only in the dtypes :func:`repro_torch.core.formats.chunk_descriptors`
builds for the geometry, never widened
(:func:`.spc5_spmv_desc._check_tables`).

Values are f32, bf16 or int8 (with ``value_scale``, one f32 scale a
chunk): all three kernels take all three, upcasting (and scaling) each
value before its products with X, summed in f32; a narrow window is staged
as the 16-byte aligned span that covers it, kept inside ``values``.

A CPU tensor goes to the plain PyTorch version (:mod:`repro_torch.core.
ref_spmv`); a CUDA tensor goes to the kernel, or the wrapper raises. Each
wrapper counts the launches of its kernel in :data:`LAUNCHES` (CPU calls
launch nothing and count nothing).
"""
from __future__ import annotations

import ctypes
from typing import Dict, List, Optional, Tuple

import torch

from repro_torch.core import ref_spmv as R

from . import _build
from . import spc5_spmm as KM
from . import spc5_spmv as K
from .spc5_spmv_desc import (_check_tables, _widths, table_widths,
                             value_window_bytes)

#: Launches per wrapper since the last :func:`reset_launches`.
LAUNCHES: Dict[str, int] = {"spmm_cuda_desc": 0, "spmm_cuda_panels_desc": 0,
                            "spmm_cuda_panels_desc_db": 0,
                            "spmm_cuda_panels_desc_cmap": 0,
                            "spmm_cuda_panels_desc_db_cmap": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _round16(n: int) -> int:
    return -(-n // 16) * 16


#: The columns of X a lane owns, as the mask kernels'.
panels_vector = KM.panels_vector


def _block(r: int, c: int) -> None:
    """The kernels fold a block's r*c valid bytes into a mask with 4-byte
    words: r*c must be 4, 8, 16 or 32, with r <= 8 and c <= 8."""
    if r not in (1, 2, 4, 8) or c not in (1, 2, 4, 8) or r * c not in (
            4, 8, 16, 32):
        raise ValueError(f"no descriptor SpMM kernel for beta({r},{c})")


# ----------------------------------------------------------------------------
# whole-vector layout
# ----------------------------------------------------------------------------

def whole_stage_bytes(q: int, nb: int, r: int, c: int, vmax: int, wv: int,
                      wx: int, vsize: int = 4) -> int:
    """One stage of the whole-vector descriptor kernel: q value windows
    (:func:`~.spc5_spmv_desc.value_window_bytes` of ``vsize``-byte values),
    for narrow values each chunk's window offset and scale (8 bytes), for
    nb blocks the valid and vidx runs, the c xcol entries of each block's
    first row and a 4-byte slot for its lane-0 yrow entry, and a 16-byte
    mbarrier slot, every part 16-byte aligned."""
    rc = r * c
    return (q * value_window_bytes(vmax, vsize)
            + KM._window_meta_bytes(q, vsize)
            + _round16(nb * rc) + _round16(nb * rc * wv)
            + _round16(nb * c * wx) + _round16(4 * nb) + 16)


def whole_smem_bytes(stages: int, q: int, nb: int, r: int, c: int, vmax: int,
                     wv: int, wx: int, tw: int, vec: int, tile_rows: int,
                     threads: int, vsize: int = 4) -> int:
    """Dynamic shared memory of one whole-vector descriptor CTA
    (:func:`.spc5_spmm.whole_layout_bytes` with :func:`whole_stage_bytes`
    of ``vsize``-byte values). The kernel's launcher refuses a launch whose
    figure differs from its own (``spc5_spmm_desc_whole_smem`` exposes
    it)."""
    return KM.whole_layout_bytes(
        whole_stage_bytes(q, nb, r, c, vmax, wv, wx, vsize), stages, q, nb, r,
        c, vmax, tw, vec, tile_rows, threads)


_WHOLE_OCCUPANCY: Dict[Tuple[int, ...], Tuple[int, int]] = {}


def whole_occupancy(r: int, c: int, vec: int, threads: int, smem: int,
                    device: torch.device, vsize: int = 4) -> Tuple[int, int]:
    """(CTAs one SM holds at once, SMs) for the whole-vector descriptor
    kernel of ``vsize``-byte values, block shape (r, c) and ``vec`` columns
    a lane, as the CUDA runtime reports them."""
    key = (vsize, r, c, vec, threads, smem, device.index or 0)
    if key not in _WHOLE_OCCUPANCY:
        lib = _build.load_library("spc5_spmm_desc")
        out = (ctypes.c_int * 2)()
        err = lib.spc5_spmm_desc_whole_occupancy(*key, ctypes.addressof(out))
        K._raise_on(err, "spc5_spmm_desc_whole_occupancy")
        _WHOLE_OCCUPANCY[key] = (out[0], out[1])
    return _WHOLE_OCCUPANCY[key]


def whole_cta(*, cb: int, r: int, c: int, vmax: int, nvec: int, vec: int,
              wv: int, wx: int, what: str = "whole-vector kernel",
              vsize: int = 4) -> Dict[str, int]:
    """The CTA ``spmm_cuda_desc`` plans for lanes of at most ``vec`` columns
    (:func:`panels_vector`), vidx / xcol tables ``wv`` / ``wx`` bytes wide
    and ``vsize``-byte values: the mask kernel's planning
    (:func:`.spc5_spmm.whole_plan`) with :func:`whole_smem_bytes`."""
    KM._panel_block(r, c, "whole-vector")
    return KM.whole_plan(lambda s, q, nb, tw, v, rows, t: whole_smem_bytes(
        s, q, nb, r, c, vmax, wv, wx, tw, v, rows, t, vsize), cb, r, c, vmax,
        nvec, vec, what)


def whole_launch(nchunks: int, *, cb: int, r: int, c: int, vmax: int,
                 nvec: int, vec: int, wv: int, wx: int, device: torch.device,
                 grid: Optional[int] = None,
                 what: str = "whole-vector kernel",
                 vsize: int = 4) -> Dict[str, int]:
    """The launch ``spmm_cuda_desc`` makes on ``device`` (a card) for
    ``vsize``-byte values: the CTA of :func:`whole_cta`, then
    :func:`.spc5_spmm.whole_grid`."""
    cta = whole_cta(cb=cb, r=r, c=c, vmax=vmax, nvec=nvec, vec=vec, wv=wv,
                    wx=wx, what=what, vsize=vsize)
    return KM.whole_grid(cta, lambda t, n: whole_occupancy(
        r, c, cta["vector"], t, n, device, vsize), nchunks, nvec, grid, what)


def spmm_cuda_desc(chunk_vbase, desc_valid, desc_vidx, desc_xcol, desc_yrow,
                   values, x, value_scale=None, *, r: int, c: int, cb: int,
                   vmax: int, nrows: int, ncols: int, nvt: int = 128,
                   grid: Optional[int] = None) -> torch.Tensor:
    """Whole-vector descriptor SpMM: the chunks cut into ``grid`` contiguous
    ranges a column tile (default from the card's occupancy), rounds of
    chunks' tables staged in a ring, each round's valid lanes listed by row
    and walked four at a time by the lane groups, rows summed in a Y tile
    (replaces ``spmm_pallas_desc``). A column permutation would already be
    folded into ``desc_xcol``, so there is no ``col_map``. ``values`` f32,
    bf16 or int8 (with ``value_scale``, (nchunks,) float32)."""
    fn = "spmm_cuda_desc"
    nchunks = desc_valid.shape[0]
    K._check(dict(chunk_vbase=chunk_vbase, values=values, x=x),
             {"chunk_vbase": (nchunks,)}, values.device)
    K._check_values(fn, values, value_scale, (nchunks,))
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
                                            chunk_vbase), x, value_scale,
                           nrows=nrows)
    if values.device.type != "cuda":
        raise ValueError(f"no kernel for device {values.device}")
    if vmax % 4:
        raise ValueError(f"vmax must be a multiple of 4 (whole 16-byte "
                         f"value windows), got {vmax}")
    if x.numel() >= 2 ** 31:
        raise ValueError(f"X has {x.numel()} elements; the kernels index it "
                         f"with 32-bit offsets")
    wv, wx, wy = _widths(desc_vidx, desc_xcol, desc_yrow)
    vsize = values.element_size()
    launch = whole_launch(nchunks, cb=cb, r=r, c=c, vmax=vmax, nvec=nvec,
                          vec=panels_vector(nvec, x), wv=wv, wx=wx,
                          device=values.device, grid=grid, what=fn,
                          vsize=vsize)
    K._aligned({"values": values})
    # the tables are copied in 4-byte pieces where 16-byte ones do not align
    K._aligned(tables, 4)
    lib = _build.load_library("spc5_spmm_desc")
    # every CTA adds into Y
    y = torch.zeros((nrows, nvec), dtype=torch.float32, device=values.device)
    err = lib.spc5_spmm_desc_whole(
        chunk_vbase.data_ptr(), desc_valid.data_ptr(), desc_vidx.data_ptr(),
        desc_xcol.data_ptr(), desc_yrow.data_ptr(), values.data_ptr(),
        K._scale_ptr(value_scale), x.data_ptr(), y.data_ptr(), nchunks, cb,
        vmax, nrows, x.shape[0], r, c, vsize, values.numel(), wv, wx, wy,
        nvec, launch["tile_columns"], launch["vector"],
        launch["grid"], launch["stages"], launch["chunks_per_stage"],
        launch["blocks_per_stage"], launch["tile_rows"], launch["smem_bytes"],
        launch["threads"], values.device.index or 0, K._stream(values.device))
    K._raise_on(err, fn)
    LAUNCHES[fn] += 1
    return y


# ----------------------------------------------------------------------------
# panel layout
# ----------------------------------------------------------------------------

#: Stages in the ring of ``spmm_cuda_panels_desc_db``: one stage is filled
#: while the other is walked. The synchronous kernel holds one stage.
PANEL_DB_STAGES = 2

#: Threads of a panel CTA, a power of two. ``None`` (:func:`panels_plan`):
#: 512 where a lane group is a whole warp (16 groups, whose walks wait on
#: shared memory and L1), else 256 (more groups would outnumber a stage's
#: blocks). ``time_spmm_desc.py`` sweeps it.
PANEL_THREADS: Optional[int] = None

#: The widest column tile a panel CTA takes: 32 lanes of four columns.
#: ``time_spmm_desc.py`` sweeps 32 and 64.
PANEL_TILE = 128

#: The fewest row parts a panel is cut into (each part its own CTA with a
#: Y tile of its rows); more until two CTAs fit an SM, or one does.
#: ``time_spmm_desc.py`` sweeps 8.
PANEL_ROW_PARTS = 1

#: An H100 SM's shared memory and what one CTA may use when two share it
#: (:mod:`.spc5_spmm`, whose panel pair plans with the same card figures).
SM_SMEM_BYTES = KM.SM_SMEM_BYTES
TWO_CTA_SMEM_BYTES = KM.TWO_CTA_SMEM_BYTES

#: The most chunks a stage holds (each with its value window), so that a
#: CTA orders and walks that many chunks' blocks between two barriers:
#: taken where an SM then holds as many CTAs as with one (by shared memory,
#: and by registers: the kernels take at most 64 a thread).
#: ``time_spmm_desc.py`` sweeps 1 and 4.
PANEL_STAGE_CHUNKS = 2

def panels_smem_bytes(stages: int, q: int, nb: int, r: int, c: int,
                      vmax: int, prows: int, tw: int, wv: int, wx: int,
                      vsize: int = 4) -> int:
    """Dynamic shared memory of one panel CTA: the (prows, tw) f32 Y tile
    of its row part, then ``stages`` stages, each the value windows
    (:func:`~.spc5_spmv_desc.value_window_bytes` of ``vsize``-byte values)
    and x window starts of its ``q`` chunks, for narrow values each chunk's
    8-byte window offset and scale, ``nb`` blocks' tables (valid and vidx
    per lane, the c xcol entries of each block's first row, a 4-byte slot
    for its lane-0 yrow entry) and a 16-byte mbarrier slot, then the walk's
    order of the nb blocks (16 bytes a block) and their sort keys (4 bytes
    a block), every part 16-byte aligned. The kernel's ``panel_layout``
    (``csrc/spc5_spmm_desc.cu``) refuses a launch whose figure differs from
    its own."""
    rc = r * c
    stage = (q * value_window_bytes(vmax, vsize) + _round16(4 * q)
             + (_round16(8 * q) if vsize < 4 else 0) + _round16(nb * rc)
             + _round16(nb * rc * wv) + _round16(nb * c * wx)
             + _round16(4 * nb) + 16)
    return (_round16(4 * prows * tw) + stages * stage
            + 16 * nb + _round16(4 * nb))


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


def panels_plan(stages: int, cb: int, r: int, c: int, vmax: int, pr: int,
                nvec: int, vec: int, wv: int, wx: int,
                what: str = "panel kernel", vsize: int = 4) -> Dict[str, int]:
    """The CTA of a panel launch: the widest tile of :func:`panels_tiles`,
    cut among the fewest row parts (from :data:`PANEL_ROW_PARTS`, doubling,
    each a multiple of r rows) at which two CTAs with stages of one whole
    chunk fit an SM (:data:`TWO_CTA_SMEM_BYTES`), else at which one CTA
    fits, the synchronous kernel (``stages == 1``) then cutting a chunk's
    tables into slices of fewer blocks (halved) before it takes more parts;
    the ring holds whole chunks. A stage holds :data:`PANEL_STAGE_CHUNKS`
    chunks where that keeps the CTAs an SM holds. Returns
    ``chunks_per_stage``, ``blocks_per_stage``, ``tile_columns``,
    ``vector`` (columns a lane), ``lanes`` (of a group), ``threads``,
    ``row_parts``, ``part_rows`` and ``smem_bytes``; raises ``ValueError``
    when nothing fits. ``vsize`` is the values' bytes (4, 2 or 1)."""
    if stages not in (1, PANEL_DB_STAGES):
        raise ValueError(f"the panel kernels stage 1 or {PANEL_DB_STAGES} "
                         f"chunks, not {stages}")
    for tw in panels_tiles(nvec, vec):
        v = min(vec, tw)
        threads = PANEL_THREADS or (512 if tw // v == 32 else 256)
        for budget in (TWO_CTA_SMEM_BYTES, K.MAX_SMEM_BYTES):
            parts = PANEL_ROW_PARTS
            while True:
                prows = -(-pr // (parts * r)) * r

                def nbytes(q, nb, prows=prows, tw=tw):
                    return panels_smem_bytes(stages, q, nb, r, c, vmax, prows,
                                             tw, wv, wx, vsize)

                def ctas(q):  # an SM's CTAs by shared memory and registers
                    return min(SM_SMEM_BYTES // (nbytes(q, q * cb) + 1024),
                               KM.SM_REGISTERS // (KM.MAX_REGISTERS * threads))
                fits = [(q, q * cb) for q in (PANEL_STAGE_CHUNKS, 1)
                        if nbytes(q, q * cb) <= budget and ctas(q) >= ctas(1)]
                nb = cb
                while (not fits and budget == K.MAX_SMEM_BYTES and stages == 1
                       and nb > 1):
                    nb = -(-nb // 2)
                    if nbytes(1, nb) <= budget:
                        fits = [(1, nb)]
                if fits:
                    q, nb = fits[0]
                    return dict(chunks_per_stage=q, blocks_per_stage=nb,
                                tile_columns=tw, vector=v, lanes=tw // v,
                                threads=threads, row_parts=-(-pr // prows),
                                part_rows=prows, smem_bytes=nbytes(q, nb))
                if prows == r:
                    break
                parts *= 2
    K._check_smem(nbytes(1, nb), what)


_OCCUPANCY: Dict[Tuple[int, ...], Tuple[int, int]] = {}


def _library(mapped: bool) -> str:
    """The library of the panel kernels with (or without) a column map."""
    return "spc5_spmm_desc_cmap" if mapped else "spc5_spmm_desc"


def panels_occupancy(stages: int, r: int, c: int, vec: int, threads: int,
                     smem: int, device: torch.device,
                     vsize: int = 4, mapped: bool = False) -> Tuple[int, int]:
    """(CTAs one SM holds at once, SMs) for the panel kernel of block shape
    (r, c), ``vec`` columns a lane, ``vsize``-byte values and ``stages`` (1:
    the synchronous one), with a column map where ``mapped``, as the CUDA
    runtime reports them."""
    key = (stages, vsize, r, c, vec, threads, smem, device.index or 0)
    if (mapped,) + key not in _OCCUPANCY:
        fn = f"spc5_spmm_desc_panels{'_cmap' if mapped else ''}_occupancy"
        lib = _build.load_library(_library(mapped))
        out = (ctypes.c_int * 2)()
        err = getattr(lib, fn)(*key, ctypes.addressof(out))
        K._raise_on(err, fn)
        _OCCUPANCY[(mapped,) + key] = (out[0], out[1])
    return _OCCUPANCY[(mapped,) + key]


def panels_launch(stages: int, npanels: int, nchunks: int, *, cb: int,
                  r: int, c: int, vmax: int, pr: int, nvec: int, vec: int,
                  wv: int, wx: int, device: torch.device,
                  split: Optional[int] = None,
                  what: str = "panel kernel", vsize: int = 4,
                  mapped: bool = False) -> Dict[str, int]:
    """The launch a panel wrapper makes on ``device`` (a card) for lanes of
    at most ``vec`` columns (:func:`panels_vector`) and ``vsize``-byte
    values: ``stages``, the CTA of
    :func:`panels_plan`, ``ntiles``, the card's
    ``ctas_per_sm`` and ``sms``, ``split`` (S, from
    :func:`~.spc5_spmv.panels_split` over npanels x row parts x ntiles
    units unless given), ``grid`` (npanels x S x row parts x ntiles) and
    ``chunks_per_cta`` (the longest range). ``mapped``: the launch of the
    kernel with a column map (the same CTA, its own occupancy)."""
    cta = panels_plan(stages, cb, r, c, vmax, pr, nvec, vec, wv, wx, what,
                      vsize)
    per_sm, sms = panels_occupancy(stages, r, c, cta["vector"], cta["threads"],
                                   cta["smem_bytes"], device, vsize=vsize,
                                   **({"mapped": True} if mapped else {}))
    ntiles = -(-nvec // cta["tile_columns"])
    units = npanels * cta["row_parts"] * ntiles
    if split is None:
        split = K.panels_split(units, nchunks, per_sm, sms)
    if not 1 <= split <= nchunks:
        raise ValueError(f"split must be in [1, {nchunks}] (the chunks of a "
                         f"panel), got {split}")
    grid = units * split
    if grid > KM._MAX_GRID:
        raise ValueError(f"{what}: {grid} CTAs exceed the grid's "
                         f"{KM._MAX_GRID}")
    return dict(stages=stages, **cta, ntiles=ntiles,
                ctas_per_sm=per_sm, sms=sms, split=split, grid=grid,
                chunks_per_cta=-(-nchunks // split))


def _panels(fn: str, stages: int, chunk_vbase, chunk_xbase, desc_valid,
            desc_vidx, desc_xcol, desc_yrow, values, x, col_map, value_scale,
            *, r, c, cb, vmax, xw, pr, nrows, ncols_pad, nvt, split=None):
    npanels, nchunks = chunk_vbase.shape
    K._check(dict(chunk_vbase=chunk_vbase, chunk_xbase=chunk_xbase,
                  values=values, x=x),
             {"chunk_xbase": (npanels, nchunks)}, values.device)
    K._check_values(fn, values, value_scale, (npanels, nchunks))
    tables = dict(desc_valid=desc_valid, desc_vidx=desc_vidx,
                  desc_xcol=desc_xcol, desc_yrow=desc_yrow)
    _check_tables(tables, dict(desc_vidx=vmax, desc_xcol=xw, desc_yrow=pr),
                  (npanels, nchunks, cb, r * c), values.device)
    nvec = KM._nvec(x, nvt)
    if npanels * pr < nrows:
        raise ValueError(f"{npanels} panels of {pr} rows cannot hold "
                         f"{nrows} rows")
    K._check_map(col_map, x.shape[0], values.device)
    if values.device.type == "cpu":
        return R.spmm_panels_desc(
            R.SPC5PanelDescDevice(values, desc_valid, desc_vidx, desc_xcol,
                                  desc_yrow, chunk_vbase, chunk_xbase), x,
            col_map, value_scale, pr=pr, nrows=nrows, ncols_pad=ncols_pad)
    if values.device.type != "cuda":
        raise ValueError(f"no kernel for device {values.device}")
    if vmax % 4:
        raise ValueError(f"vmax must be a multiple of 4 (whole 16-byte "
                         f"value windows), got {vmax}")
    if x.numel() >= 2 ** 31:
        raise ValueError(f"X has {x.numel()} elements; the kernels index it "
                         f"with 32-bit offsets")
    _block(r, c)
    wv, wx, wy = _widths(desc_vidx, desc_xcol, desc_yrow)
    vsize = values.element_size()
    mapped = col_map is not None
    launch = panels_launch(stages, npanels, nchunks, cb=cb, r=r, c=c,
                           vmax=vmax, pr=pr, nvec=nvec,
                           vec=panels_vector(nvec, x), wv=wv, wx=wx,
                           device=values.device, split=split, what=fn,
                           vsize=vsize, mapped=mapped)
    K._aligned({"values": values})
    # the tables are copied in 4-byte pieces where 16-byte ones do not align
    K._aligned(tables, 4)
    lib = _build.load_library(_library(mapped))
    # S > 1 CTAs add into each panel's rows, so Y starts at 0
    y = (torch.zeros if launch["split"] > 1 else torch.empty)(
        (nrows, nvec), dtype=torch.float32, device=values.device)
    # X is read in place: the kernels skip any column at or past its rows,
    # which is what the reference's zero padding up to ncols_pad adds (with
    # a map, a lane of column col < X's rows reads X's row col_map[col])
    err = getattr(lib, f"spc5_spmm_desc_panels{'_cmap' if mapped else ''}"
                       f"_s{stages}")(
        chunk_vbase.data_ptr(), chunk_xbase.data_ptr(), desc_valid.data_ptr(),
        desc_vidx.data_ptr(), desc_xcol.data_ptr(), desc_yrow.data_ptr(),
        values.data_ptr(),
        K._scale_ptr(value_scale), x.data_ptr(),
        y.data_ptr(), npanels, nchunks, cb, r, c, vmax, pr, nrows, x.shape[0],
        vsize, values.numel(), wv, wx, wy, nvec,
        launch["tile_columns"], launch["vector"], launch["row_parts"],
        launch["part_rows"], launch["split"], launch["chunks_per_stage"],
        *([launch["blocks_per_stage"]] if stages == 1 else []),
        launch["smem_bytes"], launch["threads"],
        values.device.index or 0, K._stream(values.device),
        *((col_map.data_ptr(),) if mapped else ()))
    fn = f"{fn}_cmap" if mapped else fn
    K._raise_on(err, fn)
    LAUNCHES[fn] += 1
    return y


def spmm_cuda_panels_desc(chunk_vbase, chunk_xbase, desc_valid, desc_vidx,
                          desc_xcol, desc_yrow, values, x,
                          col_map: Optional[torch.Tensor] = None,
                          value_scale: Optional[torch.Tensor] = None, *,
                          r: int, c: int, cb: int, vmax: int, xw: int,
                          pr: int, nrows: int, ncols_pad: int,
                          nvt: int = 128,
                          split: Optional[int] = None) -> torch.Tensor:
    """Row-panel descriptor SpMM, each panel's chunks split among S CTAs a
    column tile (``split``; default from the card's occupancy), each
    chunk's stage copied and waited for before the walk, one lane group
    adding each row of the Y tile (replaces ``spmm_pallas_panels_desc``).
    X is (ncols, nvec); ``values`` f32, bf16 or int8 (with ``value_scale``,
    (npanels, nchunks) float32). ``col_map`` (int32, one entry a row of X:
    a reordered plan's column permutation) launches the column-map twin,
    which reads X's row ``col_map[col]`` for a lane of permuted column col
    (counted as ``spmm_cuda_panels_desc_cmap``)."""
    return _panels("spmm_cuda_panels_desc", 1, chunk_vbase, chunk_xbase,
                   desc_valid, desc_vidx, desc_xcol, desc_yrow, values, x,
                   col_map, value_scale, r=r, c=c, cb=cb, vmax=vmax, xw=xw, pr=pr, nrows=nrows,
                   ncols_pad=ncols_pad, nvt=nvt, split=split)


def spmm_cuda_panels_desc_db(chunk_vbase, chunk_xbase, desc_valid,
                             desc_vidx, desc_xcol, desc_yrow, values, x,
                             col_map: Optional[torch.Tensor] = None,
                             value_scale: Optional[torch.Tensor] = None, *,
                             r: int, c: int, cb: int, vmax: int, xw: int,
                             pr: int, nrows: int, ncols_pad: int,
                             nvt: int = 128,
                             split: Optional[int] = None) -> torch.Tensor:
    """Row-panel descriptor SpMM with a ring of :data:`PANEL_DB_STAGES`
    chunks (tables and value window) staged ahead by bulk copies and
    cp.async (replaces ``spmm_pallas_panels_desc_db``); ``split`` and
    ``values`` and ``col_map`` as in :func:`spmm_cuda_panels_desc`
    (counted as ``spmm_cuda_panels_desc_db_cmap`` with a map)."""
    return _panels("spmm_cuda_panels_desc_db", PANEL_DB_STAGES, chunk_vbase,
                   chunk_xbase, desc_valid, desc_vidx, desc_xcol, desc_yrow,
                   values, x, col_map, value_scale, r=r, c=c, cb=cb, vmax=vmax, xw=xw, pr=pr,
                   nrows=nrows, ncols_pad=ncols_pad, nvt=nvt, split=split)


# ----------------------------------------------------------------------------
# shared-memory contracts (the static verifier's vmem-budget rule)
# ----------------------------------------------------------------------------

def whole_contract(geom, vsize: int = 4, nvec: int = 1) -> int:
    """Shared memory of the CTA ``spmm_cuda_desc`` plans (:func:`whole_cta`)
    for a plan of geometry ``geom``, its tables as the build narrows them,
    ``vsize``-byte values and X of ``nvec`` columns; computed on the host,
    without a card. Raises ``ValueError`` where no launch fits."""
    wv, wx = table_widths(geom, "whole_vector")
    return whole_cta(cb=geom["cb"], r=geom["r"], c=geom["c"],
                     vmax=geom["vmax"], nvec=nvec,
                     vec=KM.panels_vector(nvec), wv=wv, wx=wx,
                     vsize=vsize)["smem_bytes"]


def panels_contract(geom, vsize: int = 4, nvec: int = 1) -> int:
    """The same for the synchronous panel descriptor SpMM kernel
    (:func:`panels_plan` at one stage, the fewest its launcher takes)."""
    wv, wx = table_widths(geom, "panels")
    return panels_plan(1, geom["cb"], geom["r"], geom["c"], geom["vmax"],
                       geom["pr"], nvec, KM.panels_vector(nvec), wv, wx,
                       vsize=vsize)["smem_bytes"]


#: The descriptor lowering's SpMM contracts (:data:`.spc5_spmm.
#: SMEM_CONTRACTS`).
SMEM_CONTRACTS = {
    ("whole_vector", "descriptor"): whole_contract,
    ("panels", "descriptor"): panels_contract,
}
