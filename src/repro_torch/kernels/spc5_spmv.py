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

Each wrapper also takes ``col_map``, a reordered plan's column permutation
(the Pallas kernels' ``col_map``): with it, on the card, it launches its
column-map twin (``spc5_spmv_whole_cmap_s1`` / ``_s2``,
``spc5_spmv_panels_cmap_s1`` / ``_s2``) on x in the original column order,
unpadded, each set lane of permuted column j reading ``x[col_map[j]]``, and
counts the launch as ``<wrapper>_cmap`` (``spmv_cuda_cmap`` and so on).

The whole-vector kernels cut the chunks into G contiguous ranges, one CTA
each (G chosen here from the card's occupancy by the panel kernels' split
rule, :func:`whole_launch`; ``grid`` overrides it); the panel kernels split
each panel's chunks among S CTAs (:func:`panels_launch`; ``split``
overrides it). Both stage each chunk's value window and metadata in shared
memory and decode a block row per thread.

Values are f32, bf16 or int8 (with ``value_scale``, one f32 scale a chunk):
each kernel is built for the three (its template parameter), decoding as
the reference's ``_expand_vals`` does: bf16 upcast, int8 upcast and then
multiplied by its chunk's scale, before the product with x, summed in f32.
A narrow window is staged as the 16-byte aligned span that covers it, kept
inside ``values`` (:func:`value_span`).

A CPU tensor goes to the plain PyTorch version (:mod:`repro_torch.core.
ref_spmv`); a CUDA tensor goes to the kernel, or the wrapper raises. There
is no fallback from one to the other. Each wrapper counts the launches of
its kernel in :data:`LAUNCHES` (CPU calls launch nothing and count nothing).
"""
from __future__ import annotations

import ctypes
from typing import Dict, Optional, Sequence, Tuple

import torch

from repro_torch.core import ref_spmv as R

from . import _build

#: Launches per wrapper since the last :func:`reset_launches`.
LAUNCHES: Dict[str, int] = {"spmv_cuda": 0, "spmv_cuda_db": 0,
                            "spmv_cuda_panels": 0, "spmv_cuda_panels_db": 0,
                            "spmv_cuda_cmap": 0, "spmv_cuda_db_cmap": 0,
                            "spmv_cuda_panels_cmap": 0,
                            "spmv_cuda_panels_db_cmap": 0}

#: Dynamic shared memory one CTA may use on Hopper (232,448 bytes).
MAX_SMEM_BYTES = 227 * 1024

_MAX_THREADS = 256          # the kernels' __launch_bounds__

#: Stages in the ring of ``spmv_cuda_panels_db``: chunks staged ahead of the
#: decode are DB_STAGES - 1. ``time_panels_desc.py`` times rings of 2 and 3;
#: on the H100 a ring of 2 was the faster on both smoke plans (PERF.md,
#: PR 17). A ring that does not fit a CTA shortens to 2
#: (:func:`panels_stages`).
DB_STAGES = 2

#: Block rows of a chunk each panel-kernel thread decodes, one at a time
#: (:func:`panel_threads`): two were faster than one or four on the H100
#: (PERF.md, PR 17).
ROWS_PER_THREAD = 2

#: Waves of CTAs the split aims at (:func:`panels_split`): more, shorter
#: chunk ranges keep every SM busy to the end. One rule for the mask and the
#: descriptor panel SpMV kernels.
SPLIT_WAVES = 4


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _threads(cb: int) -> int:
    """One thread per block slot, in whole warps, 64..256 per CTA."""
    return min(_MAX_THREADS, max(64, -(-cb // 32) * 32))


def _r16(n: int) -> int:
    return -(-n // 16) * 16


def _check_map(col_map, ncols: int, device: torch.device) -> None:
    """A column map (a fused column permutation: the decode reads x, kept in
    the original order, at ``col_map[column]``): a contiguous int32
    (ncols,) tensor on the values' device."""
    if col_map is not None:
        _check(dict(col_map=col_map), {"col_map": (ncols,)}, device)


#: The value stores a wrapper takes: f32, and the value-dtype axis's
#: quantised stores, bf16 and int8 (int8 with one f32 scale a chunk).
VALUE_DTYPES = (torch.float32, torch.bfloat16, torch.int8)


def value_window_bytes(vmax: int, vsize: int = 4) -> int:
    """Shared memory of one staged value window of ``vmax`` values of
    ``vsize`` bytes (4 f32, 2 bf16, 1 int8), as every kernel that takes
    narrow values stages it: an f32 window as it lies (its start 16-byte
    aligned where vbase is a multiple of 4), a narrow one as the 16-byte
    aligned span that covers it (:func:`value_span`), which needs 16 bytes
    more (an int8 window starts on any multiple of 8 bytes);
    ``value_window`` in ``csrc/spc5_stage.cuh``."""
    return _r16(vsize * vmax) + (16 if vsize < 4 else 0)


def value_span(vb: int, vmax: int, vsize: int,
               nvalues: int) -> Tuple[int, int, int]:
    """What a kernel copies of the narrow window [vb, vb + vmax) of
    ``vsize``-byte values (2 bf16, 1 int8) out of a ``values`` of
    ``nvalues`` values that starts on a 16-byte boundary (the wrappers
    check it), as ``value_span`` in ``csrc/spc5_stage.cuh`` does:
    ``(start, nbytes, end)``, in bytes from ``values``' start. The 16-byte
    aligned span that covers the window runs from ``start`` to ``end``; a
    window that ends past values' last 16-byte boundary (the last window of
    a plan whose values end 4, 8 or 12 bytes past one) has its span stopped
    at values' end, so ``start + nbytes`` stays inside ``values``; what is
    copied still covers the window, which lies inside ``values``."""
    p = vb * vsize
    start, end = p & ~15, _r16(p + vsize * vmax)
    per_piece = 16 // vsize
    stop = (nvalues * vsize if vb + vmax > nvalues // per_piece * per_piece
            else end)
    return start, stop - start, end


def _check_values(fn: str, values: torch.Tensor, value_scale,
                  scale_shape: Optional[Sequence[int]]) -> None:
    """The value store of a wrapper (its dtype already one of
    :data:`VALUE_DTYPES`, :func:`_check`): ``value_scale`` comes with int8
    values, and only with them, as a contiguous float32 tensor of
    ``scale_shape`` (one scale a chunk; None: the kernel has no chunks and
    takes no scale, so int8 values raise) on the values' device."""
    if value_scale is not None and values.dtype != torch.int8:
        raise NotImplementedError(
            f"{fn}: value_scale with {values.dtype} values is not ported: "
            f"the port scales int8 values only")
    if values.dtype == torch.int8:
        if value_scale is None or scale_shape is None:
            raise ValueError(f"{fn}: int8 values need their value_scale, one "
                             f"float32 scale a chunk")
        _check(dict(value_scale=value_scale), {"value_scale": scale_shape},
               values.device)


def _check(named: Dict[str, torch.Tensor], shapes: Dict[str, Sequence[int]],
           device: torch.device) -> None:
    """Device, dtype, shape and contiguity of every operand: ``values`` one
    of :data:`VALUE_DTYPES`, ``x`` and ``value_scale`` float32, the rest
    int32."""
    for name, t in named.items():
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name} must be a torch.Tensor, got {type(t)}")
        if t.device != device:
            raise ValueError(f"{name} is on {t.device}, values on {device}")
        if name == "values":
            if t.dtype not in VALUE_DTYPES:
                raise TypeError(f"values must be one of {VALUE_DTYPES}, got "
                                f"{t.dtype}")
        elif t.dtype != (torch.float32 if name in ("x", "value_scale")
                         else torch.int32):
            want = (torch.float32 if name in ("x", "value_scale")
                    else torch.int32)
            raise TypeError(f"{name} must be {want}, got {t.dtype}")
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


def _scale_ptr(value_scale: Optional[torch.Tensor]) -> int:
    """The address a launcher takes for an int8 store's scales (0, unread,
    for the other stores)."""
    return 0 if value_scale is None else value_scale.data_ptr()


def _raise_on(err: int, fn: str) -> None:
    if err != 0:
        raise RuntimeError(f"{fn} failed to launch: CUDA error {err}")


def _stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


# ----------------------------------------------------------------------------
# whole-vector layout
# ----------------------------------------------------------------------------

#: Stages in the ring of ``spmv_cuda_db``, the only ring its kernel is built
#: for: one chunk is staged ahead of the decode. A ring that does not fit a
#: CTA is refused; a launch whose every CTA takes one chunk holds one stage
#: (:func:`whole_launch`).
WHOLE_DB_STAGES = 2

#: Rows of each warp's y tile in a whole-vector CTA (rows past it are added
#: into y directly). A chunk of the vocab weight spans 4-8 rows, one of the
#: FEM matrix about 88; there each CTA takes one chunk, and 128-row tiles,
#: zeroed and summed over the warps by every CTA, were 15 % slower than 32
#: on the H100, 16 rows no faster (PERF.md, PR 22).
WHOLE_TILE_ROWS = 32

#: Block rows of a chunk each whole-vector thread decodes, one a step
#: (:func:`whole_threads`): WHOLE_ROWS_PER_THREAD where a chunk's block rows
#: hold more than WHOLE_SPARSE_ROW_NNZ nonzeros on average (by vmax), else
#: WHOLE_SPARSE_ROWS_PER_THREAD. A block row with one nonzero is a short
#: step; one with four waits on four x loads and wants more warps. On the
#: H100, 4 were 11 % faster than 8 on the FEM matrix's full beta(4,4) blocks
#: and 8 were 9 % faster than 4 on the vocab weight's (1.1 nonzeros a block
#: row; PERF.md, PR 22).
WHOLE_ROWS_PER_THREAD = 4
WHOLE_SPARSE_ROWS_PER_THREAD = 8
WHOLE_SPARSE_ROW_NNZ = 2


def _stage_bytes(cb: int, vmax: int, vsize: int = 4) -> int:
    """One stage of either layout: the value window
    (:func:`value_window_bytes` of ``vsize``-byte values), the chunk's four
    metadata rows (cb int32 entries each) and a 16-byte slot for the
    chunk's x window start, a narrow window's offset in its span and the
    stage's mbarrier, each part 16-byte aligned."""
    return value_window_bytes(vmax, vsize) + 4 * _r16(4 * cb) + 16


def whole_threads(cb: int, r: int, vmax: int) -> int:
    """Threads of a whole-vector CTA: one per :data:`WHOLE_ROWS_PER_THREAD`
    block rows of a chunk (cb * r rows), or one per
    :data:`WHOLE_SPARSE_ROWS_PER_THREAD` where the value window (vmax) holds
    at most :data:`WHOLE_SPARSE_ROW_NNZ` nonzeros a block row; in whole
    warps, 32..256."""
    sparse = vmax <= WHOLE_SPARSE_ROW_NNZ * cb * r
    per = WHOLE_SPARSE_ROWS_PER_THREAD if sparse else WHOLE_ROWS_PER_THREAD
    rows = -(-cb * r // per)
    return min(_MAX_THREADS, max(32, -(-rows // 32) * 32))


def whole_smem_bytes(stages: int, cb: int, vmax: int, tile: int,
                     threads: int, vsize: int = 4) -> int:
    """Dynamic shared memory of one whole-vector CTA: each warp's (tile,)
    f32 y tile, then ``stages`` stages (:func:`_stage_bytes` of
    ``vsize``-byte values). The kernel's ``whole_smem``
    (``csrc/spc5_spmv.cu``) refuses a launch whose figure differs from its
    own."""
    return (_r16(4 * tile * (threads // 32))
            + stages * _stage_bytes(cb, vmax, vsize))


_WHOLE_OCCUPANCY: Dict[Tuple[int, ...], Tuple[int, int]] = {}


def whole_occupancy(stages: int, threads: int, smem: int,
                    device: torch.device, vsize: int = 4,
                    mapped: bool = False) -> Tuple[int, int]:
    """(CTAs one SM holds at once, SMs) for the whole-vector kernel of
    ``vsize``-byte values at ``stages`` (1: the synchronous one), its
    column-map twin where ``mapped``, as the CUDA runtime reports them."""
    key = (stages, vsize, threads, smem, device.index or 0)
    if (mapped,) + key not in _WHOLE_OCCUPANCY:
        fn = f"spc5_spmv_whole{'_cmap' if mapped else ''}_occupancy"
        lib = _build.load_library("spc5_spmv")
        out = (ctypes.c_int * 2)()
        err = getattr(lib, fn)(*key, ctypes.addressof(out))
        _raise_on(err, fn)
        _WHOLE_OCCUPANCY[(mapped,) + key] = (out[0], out[1])
    return _WHOLE_OCCUPANCY[(mapped,) + key]


def whole_launch(stages: int, nchunks: int, *, cb: int, r: int, vmax: int,
                 device: torch.device, grid: Optional[int] = None,
                 what: str = "whole-vector kernel",
                 vsize: int = 4, mapped: bool = False) -> Dict[str, int]:
    """The launch a whole-vector wrapper makes on ``device`` (a card) with
    the kernel of ``stages`` (1, or :data:`WHOLE_DB_STAGES`) for
    ``vsize``-byte values (its column-map twin where ``mapped``: the same
    plan at the twin's occupancy): ``grid`` (G,
    from :func:`panels_split` over one "panel" of every chunk at the
    occupancy of the whole ring, unless given), ``chunks_per_cta`` (the
    longest range), ``stages`` (the stages it holds: the ring, or one where
    every CTA takes one chunk and there is nothing to stage ahead),
    ``smem_bytes``, ``threads`` and ``tile_rows`` per CTA and the card's
    ``ctas_per_sm`` and ``sms`` at that launch. Raises ``ValueError`` where
    the kernel's stages do not fit a CTA (a ring is never shortened to
    fit)."""
    if stages not in (1, WHOLE_DB_STAGES):
        raise ValueError(f"the whole-vector kernels stage 1 or "
                         f"{WHOLE_DB_STAGES} chunks, not {stages}")
    tile = WHOLE_TILE_ROWS
    threads = whole_threads(cb, r, vmax)
    smem = whole_smem_bytes(stages, cb, vmax, tile, threads, vsize)
    _check_smem(smem, what)
    per_sm, sms = whole_occupancy(stages, threads, smem, device, vsize,
                                  **({"mapped": True} if mapped else {}))
    if grid is None:
        grid = panels_split(1, nchunks, per_sm, sms)
    if not 1 <= grid <= nchunks:
        raise ValueError(f"grid must be in [1, {nchunks}] (the chunks), "
                         f"got {grid}")
    longest = -(-nchunks // grid)
    if longest < stages:
        # the kernel's whole_ring: a CTA uses no more stages than chunks
        smem = whole_smem_bytes(longest, cb, vmax, tile, threads, vsize)
        per_sm, sms = whole_occupancy(stages, threads, smem, device, vsize,
                                      **({"mapped": True} if mapped else {}))
    return dict(stages=min(stages, longest), smem_bytes=smem,
                threads=threads, tile_rows=tile, ctas_per_sm=per_sm,
                sms=sms, grid=grid, chunks_per_cta=longest)


def _whole(fn: str, stages: int, chunk_vbase, chunk_col, chunk_mask,
           chunk_voff, chunk_row, values, x, col_map, value_scale, *, r, c,
           cb, vmax, nrows, ncols, grid=None):
    nchunks = chunk_col.shape[0]
    named = dict(chunk_vbase=chunk_vbase, chunk_col=chunk_col,
                 chunk_mask=chunk_mask, chunk_voff=chunk_voff,
                 chunk_row=chunk_row, values=values, x=x)
    _check(named, {"chunk_vbase": (nchunks,),
                   **{k: (nchunks, cb) for k in ("chunk_col", "chunk_mask",
                                                 "chunk_voff", "chunk_row")},
                   "x": (ncols,)}, values.device)
    _check_values(fn, values, value_scale, (nchunks,))
    _check_map(col_map, ncols, values.device)
    if values.device.type == "cpu":
        xg = x if col_map is None else x.index_select(0, col_map)
        return R.spmv(R.SPC5Device(values, chunk_col, chunk_mask, chunk_voff,
                                   chunk_row, chunk_vbase), xg, value_scale,
                      r=r, c=c, nrows=nrows, ncols=ncols)
    if values.device.type != "cuda":
        raise ValueError(f"no kernel for device {values.device}")
    if vmax % 4:
        raise ValueError(f"vmax must be a multiple of 4 (whole 16-byte "
                         f"value windows), got {vmax}")
    vsize = values.element_size()
    mapped = col_map is not None
    launch = whole_launch(stages, nchunks, cb=cb, r=r, vmax=vmax,
                          device=values.device, grid=grid, what=fn,
                          vsize=vsize, mapped=mapped)
    _aligned({"values": values})
    lib = _build.load_library("spc5_spmv")
    # every CTA adds its rows into y
    y = torch.zeros(nrows, dtype=torch.float32, device=values.device)
    err = getattr(lib, f"spc5_spmv_whole{'_cmap' if mapped else ''}_s"
                       f"{stages}")(
        chunk_vbase.data_ptr(), chunk_col.data_ptr(), chunk_mask.data_ptr(),
        chunk_voff.data_ptr(), chunk_row.data_ptr(), values.data_ptr(),
        _scale_ptr(value_scale), x.data_ptr(), y.data_ptr(), nchunks, cb,
        vmax, nrows, r, c, vsize, values.numel(),
        launch["grid"], launch["tile_rows"], launch["smem_bytes"],
        launch["threads"], values.device.index or 0, _stream(values.device),
        *((col_map.data_ptr(),) if mapped else ()))
    fn = f"{fn}_cmap" if mapped else fn
    _raise_on(err, fn)
    LAUNCHES[fn] += 1
    return y


def spmv_cuda(chunk_vbase, chunk_col, chunk_mask, chunk_voff, chunk_row,
              values, x, col_map=None, value_scale=None, *, r: int, c: int,
              cb: int, vmax: int, nrows: int, ncols: int,
              grid: Optional[int] = None) -> torch.Tensor:
    """Whole-vector SpMV, the chunks cut into ``grid`` contiguous ranges
    (one CTA each; default from the card's occupancy), each chunk's value
    window and metadata copied and waited for before its decode (replaces
    ``spmv_pallas``). ``chunk_mask`` is the int32 view of the uint32
    masks; ``values`` f32, bf16 or int8 (with ``value_scale``, (nchunks,)
    float32). ``col_map`` (int32, (ncols,)), a fused column permutation:
    on the card the column-map twin reads ``x[col_map[j]]`` at each set
    lane of permuted column j (counted as ``spmv_cuda_cmap``), on the CPU
    the plain version reads ``x[col_map]``."""
    return _whole("spmv_cuda", 1, chunk_vbase, chunk_col, chunk_mask,
                  chunk_voff, chunk_row, values, x, col_map, value_scale, r=r,
                  c=c,
                  cb=cb,
                  vmax=vmax, nrows=nrows, ncols=ncols, grid=grid)


def spmv_cuda_db(chunk_vbase, chunk_col, chunk_mask, chunk_voff, chunk_row,
                 values, x, col_map=None, value_scale=None, *, r: int,
                 c: int, cb: int, vmax: int, nrows: int, ncols: int,
                 grid: Optional[int] = None) -> torch.Tensor:
    """Whole-vector SpMV with a ring of :data:`WHOLE_DB_STAGES` chunks
    (value window and metadata) staged ahead by bulk copies (replaces
    ``spmv_pallas_db``); ``grid``, ``values`` and ``col_map`` as in
    :func:`spmv_cuda` (counted as ``spmv_cuda_db_cmap`` with a map)."""
    return _whole("spmv_cuda_db", WHOLE_DB_STAGES, chunk_vbase, chunk_col,
                  chunk_mask, chunk_voff, chunk_row, values, x, col_map,
                  value_scale,
                  r=r, c=c, cb=cb, vmax=vmax, nrows=nrows, ncols=ncols, grid=grid)


# ----------------------------------------------------------------------------
# panel layout
# ----------------------------------------------------------------------------

def panel_threads(cb: int, r: int) -> int:
    """Threads of a panel-kernel CTA: one per :data:`ROWS_PER_THREAD` block
    rows of a chunk (cb * r rows), in whole warps, 32..256."""
    rows = -(-cb * r // ROWS_PER_THREAD)
    return min(_MAX_THREADS, max(32, -(-rows // 32) * 32))


def panels_smem_bytes(stages: int, cb: int, vmax: int, pr: int,
                      vsize: int = 4) -> int:
    """Dynamic shared memory of one panel-kernel CTA: the (pr,) f32 y tile,
    then ``stages`` stages (:func:`_stage_bytes` of ``vsize``-byte values),
    every part 16-byte aligned. The kernel's ``stage_layout``
    (``csrc/spc5_spmv.cu``) refuses a launch whose figure differs from its
    own."""
    return _r16(4 * pr) + stages * _stage_bytes(cb, vmax, vsize)


def panels_stages(stages: int, cb: int, vmax: int, pr: int,
                  what: str = "panel kernel",
                  vsize: int = 4) -> Tuple[int, int]:
    """(stages, shared bytes per CTA) of a panel launch: ``stages == 1`` is
    the synchronous kernel; a ring that does not fit a CTA is shortened
    (down to 2). Raises ``ValueError`` when even that does not fit."""
    def nbytes(s):
        return panels_smem_bytes(s, cb, vmax, pr, vsize)
    while stages > 2 and nbytes(stages) > MAX_SMEM_BYTES:
        stages -= 1
    _check_smem(nbytes(stages), what)
    return stages, nbytes(stages)


def panels_split(npanels: int, nchunks: int, ctas_per_sm: int,
                 sms: int) -> int:
    """S, the CTAs among which each panel's chunk list is cut: enough CTAs
    for :data:`SPLIT_WAVES` waves of the ``ctas_per_sm * sms`` the card
    holds at once, at most one a chunk."""
    slots = max(1, ctas_per_sm * sms)
    return max(1, min(nchunks, -(-SPLIT_WAVES * slots // max(1, npanels))))


def chunk_ranges(nchunks: int, parts: int):
    """The contiguous chunk range ``(first, count)`` of each of ``parts``
    CTAs, as the kernels cut it (a panel's chunks, or all the whole-vector
    chunks): part p starts at ``p * nchunks // parts``."""
    return [(p * nchunks // parts,
             (p + 1) * nchunks // parts - p * nchunks // parts)
            for p in range(parts)]


_OCCUPANCY: Dict[Tuple[int, ...], Tuple[int, int]] = {}


def panels_occupancy(stages: int, threads: int, smem: int,
                     device: torch.device, vsize: int = 4,
                     mapped: bool = False) -> Tuple[int, int]:
    """(CTAs one SM holds at once, SMs) for the panel kernel of
    ``vsize``-byte values at ``stages`` (1: the synchronous one), its
    column-map twin where ``mapped``, as the CUDA runtime reports them."""
    key = (stages, vsize, threads, smem, device.index or 0)
    if (mapped,) + key not in _OCCUPANCY:
        fn = f"spc5_spmv_panels{'_cmap' if mapped else ''}_occupancy"
        lib = _build.load_library("spc5_spmv")
        out = (ctypes.c_int * 2)()
        err = getattr(lib, fn)(*key, ctypes.addressof(out))
        _raise_on(err, fn)
        _OCCUPANCY[(mapped,) + key] = (out[0], out[1])
    return _OCCUPANCY[(mapped,) + key]


def panels_launch(stages: int, npanels: int, nchunks: int, *, cb: int,
                  r: int, vmax: int, pr: int, device: torch.device,
                  split: Optional[int] = None, what: str = "panel kernel",
                  vsize: int = 4, mapped: bool = False) -> Dict[str, int]:
    """The launch a panel wrapper makes on ``device`` (a card) for
    ``vsize``-byte values (its column-map twin where ``mapped``: the same
    plan at the twin's occupancy): ``stages``,
    ``smem_bytes`` and ``threads`` per CTA, the card's ``ctas_per_sm`` and
    ``sms``, ``split`` (S, from :func:`panels_split` unless given) and
    ``grid`` (npanels * S)."""
    stages, smem = panels_stages(stages, cb, vmax, pr, what, vsize)
    threads = panel_threads(cb, r)
    per_sm, sms = panels_occupancy(stages, threads, smem, device, vsize,
                                   **({"mapped": True} if mapped else {}))
    if split is None:
        split = panels_split(npanels, nchunks, per_sm, sms)
    if not 1 <= split <= nchunks:
        raise ValueError(f"split must be in [1, {nchunks}] (the chunks of a "
                         f"panel), got {split}")
    return dict(stages=stages, smem_bytes=smem, threads=threads,
                ctas_per_sm=per_sm, sms=sms, split=split,
                grid=npanels * split)


def panel_x(x: torch.Tensor, ncols_pad: int, mapped: bool) -> torch.Tensor:
    """The x a panel kernel reads in place at its set lanes: without a map
    every lane lies inside its chunk's window, so an x shorter than
    ncols_pad is padded with zeros as the Pallas wrappers pad it; with a
    map x is read at ``col_map[j]`` for set lanes of permuted column j <
    ncols only, so it goes as it is (no copy). Lanes at or past ncols are
    unset: they read nothing, where the reference reads ``x[0]`` times a
    zero value (its ``pad_cmap`` pads the map with column 0)."""
    if mapped or x.shape[0] >= ncols_pad:
        return x
    return torch.nn.functional.pad(x, (0, ncols_pad - x.shape[0]))


def _panels(fn: str, stages: int, chunk_vbase, chunk_xbase, chunk_col,
            chunk_mask, chunk_voff, chunk_row, values, x, col_map,
            value_scale, *, r, c, cb, vmax, xw, pr, nrows, ncols_pad,
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
    if x.dim() != 1:
        raise ValueError(f"x must be 1-D, got shape {tuple(x.shape)}")
    if npanels * pr < nrows:
        raise ValueError(f"{npanels} panels of {pr} rows cannot hold "
                         f"{nrows} rows")
    _check_map(col_map, x.shape[0], values.device)
    if values.device.type == "cpu":
        return R.spmv_panels(
            R.SPC5PanelDevice(values, chunk_col, chunk_mask, chunk_voff,
                              chunk_row, chunk_vbase, chunk_xbase), x,
            col_map, value_scale, r=r, c=c, pr=pr, nrows=nrows,
            ncols_pad=ncols_pad)
    if values.device.type != "cuda":
        raise ValueError(f"no kernel for device {values.device}")
    vsize = values.element_size()
    mapped = col_map is not None
    launch = panels_launch(stages, npanels, nchunks, cb=cb, r=r, vmax=vmax,
                           pr=pr, device=values.device, split=split, what=fn,
                           vsize=vsize, mapped=mapped)
    xp = panel_x(x, ncols_pad, mapped)
    _aligned({"values": values})
    lib = _build.load_library("spc5_spmv")
    # S > 1 CTAs add into each panel's rows, so y starts at 0
    y = (torch.zeros if launch["split"] > 1 else torch.empty)(
        nrows, dtype=torch.float32, device=values.device)
    ring = () if stages == 1 else (launch["stages"],)
    err = getattr(lib, f"spc5_spmv_panels{'_cmap' if mapped else ''}_s"
                       f"{1 if stages == 1 else 2}")(
        chunk_vbase.data_ptr(), chunk_xbase.data_ptr(), chunk_col.data_ptr(),
        chunk_mask.data_ptr(), chunk_voff.data_ptr(), chunk_row.data_ptr(),
        values.data_ptr(), _scale_ptr(value_scale), xp.data_ptr(),
        y.data_ptr(), npanels, nchunks, cb, vmax, pr, nrows, r, c, vsize,
        values.numel(), launch["split"], *ring, launch["smem_bytes"],
        launch["threads"], values.device.index or 0, _stream(values.device),
        *((col_map.data_ptr(),) if mapped else ()))
    fn = f"{fn}_cmap" if mapped else fn
    _raise_on(err, fn)
    LAUNCHES[fn] += 1
    return y


def spmv_cuda_panels(chunk_vbase, chunk_xbase, chunk_col, chunk_mask,
                     chunk_voff, chunk_row, values, x,
                     col_map: Optional[torch.Tensor] = None,
                     value_scale: Optional[torch.Tensor] = None, *, r: int,
                     c: int, cb: int, vmax: int, xw: int, pr: int,
                     nrows: int, ncols_pad: int,
                     split: Optional[int] = None) -> torch.Tensor:
    """Row-panel SpMV, each panel's chunks split among S CTAs that copy one
    chunk's value window and metadata at a time, waiting for it before the
    decode, and sum into a (pr,) y tile in shared memory (replaces
    ``spmv_pallas_panels``). x is (ncols,), read in place (padded where
    shorter than ncols_pad); ``values`` f32, bf16 or int8 (with
    ``value_scale``, (npanels, nchunks) float32). ``col_map`` (int32, as
    long as x, which then holds every column of the plan), a fused column
    permutation: the column-map twin reads x, unpadded, at
    ``col_map[j]`` for each set lane of permuted column j (counted as
    ``spmv_cuda_panels_cmap``); the plain version maps each column through
    it (:func:`panel_x`)."""
    return _panels("spmv_cuda_panels", 1, chunk_vbase, chunk_xbase,
                   chunk_col, chunk_mask, chunk_voff, chunk_row, values, x,
                   col_map, value_scale, r=r, c=c, cb=cb, vmax=vmax, xw=xw, pr=pr, nrows=nrows,
                   ncols_pad=ncols_pad, split=split)


def spmv_cuda_panels_db(chunk_vbase, chunk_xbase, chunk_col, chunk_mask,
                        chunk_voff, chunk_row, values, x,
                        col_map: Optional[torch.Tensor] = None,
                        value_scale: Optional[torch.Tensor] = None, *,
                        r: int, c: int, cb: int, vmax: int, xw: int, pr: int,
                        nrows: int, ncols_pad: int,
                        split: Optional[int] = None) -> torch.Tensor:
    """Row-panel SpMV with a ring of :data:`DB_STAGES` chunks (value
    window and metadata) staged ahead by bulk copies (replaces
    ``spmv_pallas_panels_db``); ``values`` and ``col_map`` as in
    :func:`spmv_cuda_panels` (counted as ``spmv_cuda_panels_db_cmap`` with
    a map)."""
    return _panels("spmv_cuda_panels_db", DB_STAGES, chunk_vbase,
                   chunk_xbase, chunk_col, chunk_mask, chunk_voff, chunk_row,
                   values, x, col_map, value_scale, r=r, c=c, cb=cb, vmax=vmax, xw=xw, pr=pr,
                   nrows=nrows, ncols_pad=ncols_pad, split=split)


# ----------------------------------------------------------------------------
# shared-memory contracts (the static verifier's vmem-budget rule)
# ----------------------------------------------------------------------------

def whole_contract(geom, vsize: int = 4, nvec: int = 1) -> int:
    """Shared memory a CTA of the whole-vector SpMV kernels asks for at one
    stage, the fewest their launcher (:func:`whole_launch`) takes, for a
    plan of geometry ``geom`` and ``vsize``-byte values; computed on the
    host, without a card."""
    cb, vmax = geom["cb"], geom["vmax"]
    return whole_smem_bytes(1, cb, vmax, WHOLE_TILE_ROWS,
                            whole_threads(cb, geom["r"], vmax), vsize)


def panels_contract(geom, vsize: int = 4, nvec: int = 1) -> int:
    """Shared memory a CTA of the panel SpMV kernels asks for at one stage
    (:func:`panels_stages`), as :func:`whole_contract`."""
    return panels_smem_bytes(1, geom["cb"], geom["vmax"], geom["pr"], vsize)


#: (layout, lowering) -> ``contract(geom, vsize, nvec)``: the shared memory
#: of the SpMV kernels a plan of that layout and lowering launches, which
#: ``repro_torch.analysis.verify`` holds to :data:`MAX_SMEM_BYTES` (with
#: :data:`.spc5_spmv_desc.SMEM_CONTRACTS`, the descriptor lowering's).
SMEM_CONTRACTS = {
    ("whole_vector", "mask"): whole_contract,
    ("panels", "mask"): panels_contract,
}
