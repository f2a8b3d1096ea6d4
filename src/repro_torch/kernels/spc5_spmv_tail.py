"""Wrappers of the CUDA singleton-tail kernels (``csrc/spc5_spmv_tail.cu``).

  ===================  ====================  ===============================
  wrapper              CUDA entry point      replaces
  ===================  ====================  ===============================
  ``spmv_tail_cuda``   spc5_spmv_tail        ``spmv_tail_pallas``
  ``spmm_tail_cuda``   spc5_spmm_tail        no TPU kernel: the reference's
                                             jnp ``spmm_coo`` on the bucketed
                                             tail
  ===================  ====================  ===============================

The beta(r,c)_test split (``layout="test"``) runs these kernels for its
singleton tail when the tail is bucketed by row panel (``tail_pr > 0``,
a panel multi sub-plan): SpMV through ``spmv_tail_cuda``, SpMM through
``spmm_tail_cuda``. Its flat tail (a whole-vector multi sub-plan) is no
kernel in the reference and stays plain PyTorch in the port on every
device (``ref_spmv.spmv_coo`` / ``spmm_coo``), as does the sum of the multi
and tail products.

Both kernels cut the buckets into groups of :data:`TAIL_GROUP` slots: the
SpMV kernel each bucket's groups into S contiguous ranges, one CTA each
(:func:`tail_launch`; ``split`` overrides S), the SpMM kernel all the
groups into G contiguous ranges a column tile (:func:`spmm_tail_launch`;
``grid`` overrides G), S and G from the card's occupancy by the panel
kernels' split rule (:func:`~.spc5_spmv.panels_split`).

A CPU tensor goes to the plain PyTorch version (``ref_spmv.
spmv_coo_panels`` / ``spmm_coo_panels``); a CUDA tensor goes to the kernel,
or the wrapper raises. There is no fallback from one to the other. Each
wrapper counts the launches of its kernel in :data:`LAUNCHES`.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import torch

from repro_torch.core import ref_spmv as R

from . import _build
from .spc5_spmm import _MAX_GRID, _nvec, panels_vector, whole_tiles
from .spc5_spmv import (_check, _check_smem, _raise_on, _stream,
                        panels_split)

#: Launches since the last :func:`reset_launches`.
LAUNCHES: Dict[str, int] = {"spmv_tail_cuda": 0, "spmm_tail_cuda": 0}

#: Slots of a group, the unit both kernels' grids cut (``kGroup`` in the
#: source): one step of an SpMV warp, 32 lanes of four slots.
TAIL_GROUP = 128

#: Threads of an SpMV tail CTA (whole warps, 32..512); at the kernel's 32
#: registers an SM holds 2,048 threads whatever the CTA's size, and 128,
#: 256 and 512 were within 2 % on the H100 (PERF.md §6).
#: ``time_panels_desc.py --layout tail`` sweeps the other two.
TAIL_THREADS = 256

#: Rows of an SpMM tail CTA's Y tile. A round of 1,024 slots spans about 8
#: rows of the vocab test layer's tail. ``time_spmm_desc.py --layout tail``
#: sweeps 16, 32 and 64.
SPMM_TAIL_TILE_ROWS = 32

#: Threads of an SpMM tail CTA, a power of two. ``None``: 512 where a lane
#: group is a whole warp, else 128. ``time_spmm_desc.py --layout tail``
#: sweeps 128, 256 and 512.
SPMM_TAIL_THREADS: Optional[int] = None


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def tail_groups(slots: int) -> int:
    """The groups of :data:`TAIL_GROUP` slots that hold ``slots``."""
    return -(-slots // TAIL_GROUP)


def _check_buckets(rows, cols, vals, x, pr: int, nrows: int):
    """Device, dtype, shape and contiguity of the buckets and x / X; returns
    (npanels, smax)."""
    if not isinstance(rows, torch.Tensor) or rows.dim() != 2:
        raise ValueError("rows must be a 2-D (npanels, smax) tensor")
    npanels, smax = rows.shape
    _check(dict(rows=rows, cols=cols, values=vals, x=x),
           {k: (npanels, smax) for k in ("cols", "values")}, vals.device)
    if npanels * pr < nrows:
        raise ValueError(f"{npanels} panels of {pr} rows cannot hold "
                         f"{nrows} rows")
    if pr < 1:
        raise ValueError(f"pr must be positive, got {pr}")
    if npanels * smax >= 2 ** 31 - 4 * TAIL_GROUP:
        raise ValueError(f"{npanels * smax} slots; the kernels index them "
                         f"with 32-bit offsets")
    return npanels, smax


# ----------------------------------------------------------------------------
# SpMV
# ----------------------------------------------------------------------------

_OCCUPANCY: Dict[Tuple[int, int], Tuple[int, int]] = {}


def tail_occupancy(threads: int, device: torch.device) -> Tuple[int, int]:
    """(CTAs one SM holds at once, SMs) for the SpMV tail kernel at
    ``threads``, as the CUDA runtime reports them."""
    key = (threads, device.index or 0)
    if key not in _OCCUPANCY:
        lib = _build.load_library("spc5_spmv_tail")
        out = (ctypes.c_int * 2)()
        err = lib.spc5_spmv_tail_occupancy(threads, key[1],
                                           ctypes.addressof(out))
        _raise_on(err, "spc5_spmv_tail_occupancy")
        _OCCUPANCY[key] = (out[0], out[1])
    return _OCCUPANCY[key]


def tail_launch(npanels: int, smax: int, *, device: torch.device,
                split: Optional[int] = None) -> Dict[str, int]:
    """The launch ``spmv_tail_cuda`` makes on ``device`` (a card):
    :data:`TAIL_THREADS` threads and no shared memory a CTA, the card's
    ``ctas_per_sm`` and ``sms``, ``split`` (S, the CTAs of a bucket: from
    :func:`~.spc5_spmv.panels_split` over a bucket's groups unless given),
    ``grid`` (npanels * S), ``groups`` (a bucket's) and ``groups_per_cta``
    (the longest range)."""
    threads = TAIL_THREADS
    if threads < 32 or threads > 512 or threads % 32:
        raise ValueError(f"TAIL_THREADS must be whole warps, 32..512, got "
                         f"{threads}")
    groups = tail_groups(smax)
    per_sm, sms = tail_occupancy(threads, device)
    if split is None:
        split = panels_split(npanels, groups, per_sm, sms)
    if not 1 <= split <= groups:
        raise ValueError(f"split must be in [1, {groups}] (the groups of "
                         f"{TAIL_GROUP} slots of a bucket), got {split}")
    if npanels * split > _MAX_GRID:
        raise ValueError(f"{npanels * split} CTAs exceed the grid's "
                         f"{_MAX_GRID}")
    return dict(threads=threads, smem_bytes=0, ctas_per_sm=per_sm, sms=sms,
                split=split, grid=npanels * split, groups=groups,
                groups_per_cta=-(-groups // split))


def spmv_tail_cuda(tail_xbase, rows, cols, vals, x, *, pr: int, xw: int,
                   nrows: int, ncols_pad: int,
                   split: Optional[int] = None) -> torch.Tensor:
    """The panel-bucketed singleton tail times x (replaces
    ``spmv_tail_pallas``): ``rows`` (panel-local), ``cols`` and ``vals`` are
    the (npanels, smax) buckets, ``tail_xbase`` (npanels,) each bucket's x
    window start, ``xw`` the window width, x (ncols,). Each bucket's slots
    are cut among S CTAs (``split``; default from the card's occupancy),
    which add each row's sums into a zeroed y; returns y (nrows,).

    ``ncols_pad`` is kept for the reference's signature: the reference pads
    x with zeros up to it, the kernel reads x in place and a column at or
    past x's end adds nothing."""
    npanels, smax = _check_buckets(rows, cols, vals, x, pr, nrows)
    _check(dict(tail_xbase=tail_xbase), {"tail_xbase": (npanels,)},
           vals.device)
    if x.dim() != 1:
        raise ValueError(f"x must be 1-D, got shape {tuple(x.shape)}")
    if xw < 1:
        raise ValueError(f"xw must be positive, got {xw}")
    if vals.device.type == "cpu":
        return R.spmv_coo_panels(rows, cols, vals, x, pr=pr, nrows=nrows)
    if vals.device.type != "cuda":
        raise ValueError(f"no kernel for device {vals.device}")
    # S CTAs, and the steps of a CTA, add into each bucket's rows
    y = torch.zeros(nrows, dtype=torch.float32, device=vals.device)
    if nrows == 0 or smax == 0:
        return y
    launch = tail_launch(npanels, smax, device=vals.device, split=split)
    lib = _build.load_library("spc5_spmv_tail")
    err = lib.spc5_spmv_tail(
        tail_xbase.data_ptr(), rows.data_ptr(), cols.data_ptr(),
        vals.data_ptr(), x.data_ptr(), y.data_ptr(), npanels, smax, pr, xw,
        nrows, x.shape[0], launch["split"], launch["threads"],
        launch["smem_bytes"], vals.device.index or 0, _stream(vals.device))
    _raise_on(err, "spmv_tail_cuda")
    LAUNCHES["spmv_tail_cuda"] += 1
    return y


# ----------------------------------------------------------------------------
# SpMM
# ----------------------------------------------------------------------------

def spmm_tail_smem_bytes(tw: int, vec: int, tile_rows: int,
                         threads: int) -> int:
    """Dynamic shared memory of one SpMM tail CTA (``tail_layout`` in the
    source): the (tile_rows, tw) f32 Y tile, each lane group's A and B
    slots (tw floats each) and its 16-byte header, a 16-byte scan total a
    warp, the list (16 bytes for each of a round's 4 * threads slots) and
    each thread's staged quad of rows, columns and values (48 bytes), every
    part 16-byte aligned. The launcher refuses a launch whose figure
    differs (``spc5_spmm_tail_smem`` exposes its own)."""
    groups = threads // (tw // vec)
    return (-(-4 * tile_rows * tw // 16) * 16 + -(-8 * groups * tw // 16) * 16
            + 16 * groups + 16 * (threads // 32) + 64 * threads
            + 48 * threads)


def spmm_tail_cta(nvec: int, vec: int) -> Dict[str, int]:
    """The CTA ``spmm_tail_cuda`` plans for lanes of at most ``vec``
    columns (:func:`~.spc5_spmm.panels_vector`): the widest column tile of
    :func:`~.spc5_spmm.whole_tiles`, its lanes, :data:`SPMM_TAIL_THREADS`
    threads (by default 512 for a whole warp of lanes, else 128),
    :data:`SPMM_TAIL_TILE_ROWS` and the shared memory. Raises
    ``ValueError`` where it does not fit a CTA."""
    tw = whole_tiles(nvec, vec)[0]
    v = min(vec, tw)
    lanes = tw // v
    threads = SPMM_TAIL_THREADS or (512 if lanes == 32 else 128)
    if threads & (threads - 1) or not max(32, lanes) <= threads <= 512:
        raise ValueError(f"SpMM tail threads must be a power of two in "
                         f"[{max(32, lanes)}, 512], got {threads}")
    rows = SPMM_TAIL_TILE_ROWS
    smem = spmm_tail_smem_bytes(tw, v, rows, threads)
    _check_smem(smem, "spmm_tail_cuda")
    return dict(tile_columns=tw, vector=v, lanes=lanes, threads=threads,
                tile_rows=rows, smem_bytes=smem)


_SPMM_OCCUPANCY: Dict[Tuple[int, ...], Tuple[int, int]] = {}


def spmm_tail_occupancy(vec: int, threads: int, smem: int,
                        device: torch.device) -> Tuple[int, int]:
    """(CTAs one SM holds at once, SMs) for the SpMM tail kernel of ``vec``
    columns a lane, as the CUDA runtime reports them."""
    key = (vec, threads, smem, device.index or 0)
    if key not in _SPMM_OCCUPANCY:
        lib = _build.load_library("spc5_spmv_tail")
        out = (ctypes.c_int * 2)()
        err = lib.spc5_spmm_tail_occupancy(*key, ctypes.addressof(out))
        _raise_on(err, "spc5_spmm_tail_occupancy")
        _SPMM_OCCUPANCY[key] = (out[0], out[1])
    return _SPMM_OCCUPANCY[key]


def spmm_tail_launch(slots: int, nvec: int, vec: int, *,
                     device: torch.device,
                     grid: Optional[int] = None) -> Dict[str, int]:
    """The launch ``spmm_tail_cuda`` makes on ``device`` (a card) for
    ``slots`` bucket slots: the CTA of :func:`spmm_tail_cta`, ``ntiles``,
    the card's ``ctas_per_sm`` and ``sms``, ``grid`` (G, the CTAs of a
    column tile, each a contiguous range of the groups: from
    :func:`~.spc5_spmv.panels_split` over the ntiles units unless given),
    ``groups`` and ``groups_per_cta`` (the longest range)."""
    cta = spmm_tail_cta(nvec, vec)
    per_sm, sms = spmm_tail_occupancy(cta["vector"], cta["threads"],
                                      cta["smem_bytes"], device)
    ntiles = -(-nvec // cta["tile_columns"])
    groups = tail_groups(slots)
    if grid is None:
        grid = panels_split(ntiles, groups, per_sm, sms)
    if not 1 <= grid <= groups:
        raise ValueError(f"grid must be in [1, {groups}] (the groups of "
                         f"{TAIL_GROUP} slots), got {grid}")
    if grid * ntiles > _MAX_GRID:
        raise ValueError(f"{grid * ntiles} CTAs exceed the grid's "
                         f"{_MAX_GRID}")
    return dict(**cta, ntiles=ntiles, ctas_per_sm=per_sm, sms=sms, grid=grid,
                groups=groups, groups_per_cta=-(-groups // grid))


def spmm_tail_cuda(rows, cols, vals, x, *, pr: int, nrows: int,
                   nvt: int = 128, grid: Optional[int] = None
                   ) -> torch.Tensor:
    """The panel-bucketed singleton tail times X (ncols, nvec): Y[p * pr +
    rows[p, s]] += vals[p, s] * X[cols[p, s]] over every bucket p and slot s
    (no column clip and no x window, as the reference's jnp path computes
    it), Y (nrows, nvec). The flattened slots are cut into ``grid``
    contiguous ranges a column tile (default from the card's occupancy),
    each staged in rounds, listed by row and walked four entries at a time
    by the lane groups, rows summed in a Y tile. ``nvt`` keeps the
    reference's tile rule (``nvec`` a multiple of ``min(nvt, nvec)``).

    The kernel skips slots of value 0 (the buckets' padding) and slots whose
    column lies outside X, reading nothing of X for them; the plain version
    multiplies them, as ``spmm_coo`` does, so the two differ only where X
    holds inf or NaN at such a column."""
    fn = "spmm_tail_cuda"
    npanels, smax = _check_buckets(rows, cols, vals, x, pr, nrows)
    nvec = _nvec(x, nvt)
    if vals.device.type == "cpu":
        return R.spmm_coo_panels(rows, cols, vals, x, pr=pr, nrows=nrows)
    if vals.device.type != "cuda":
        raise ValueError(f"no kernel for device {vals.device}")
    if x.numel() >= 2 ** 31:
        raise ValueError(f"X has {x.numel()} elements; the kernel indexes it "
                         f"with 32-bit offsets")
    # every CTA adds into Y
    y = torch.zeros((nrows, nvec), dtype=torch.float32, device=vals.device)
    if nrows == 0 or smax == 0:
        return y
    launch = spmm_tail_launch(npanels * smax, nvec, panels_vector(nvec, x),
                              device=vals.device, grid=grid)
    lib = _build.load_library("spc5_spmv_tail")
    err = lib.spc5_spmm_tail(
        rows.data_ptr(), cols.data_ptr(), vals.data_ptr(), x.data_ptr(),
        y.data_ptr(), npanels, smax, pr, nrows, x.shape[0], nvec,
        launch["tile_columns"], launch["vector"], launch["grid"],
        launch["tile_rows"], launch["threads"], launch["smem_bytes"],
        vals.device.index or 0, _stream(vals.device))
    _raise_on(err, fn)
    LAUNCHES[fn] += 1
    return y
