"""Plain PyTorch SpMV and SpMM over the chunked SPC5 device layouts.

These are the port's plain versions of the kernels: composed torch ops,
device-agnostic, mirroring the reference's jnp oracle
(``repro.core.ref_spmv.spmv`` / ``spmv_panels`` / ``spmm`` /
``spmm_panels`` / ``spmv_desc`` / ``spmv_panels_desc`` / ``spmm_desc`` /
``spmm_panels_desc`` and the beta(r,c)_test tail's ``spmv_coo`` /
``spmm_coo`` / ``spmv_coo_panels``, with the bucketed SpMM tail that the
reference's test layout computes inline as ``spmm_coo_panels``). Values may
be stored as f32, bf16 or int8 (with one f32 ``value_scale`` a chunk): every
decode upcasts them to f32 and applies the scale before any multiply
(:func:`_upcast`, the reference's contract), so products and sums are f32.
The CPU tests run them in place of the CUDA kernels, and ``chip_smoke.py``
holds every kernel against them on the card. The mask decode is

    ranks = cumsum(mask_bits) - mask_bits        # rank of each set bit
    expanded[k] = values[vbase + voff + ranks[k]]

so only the packed values are read, as in the paper. The descriptor
lowering reads that expansion from build-time tables instead
(:func:`spmv_desc`, :func:`spmv_panels_desc`, :func:`spmm_desc`,
:func:`spmm_panels_desc`).

Masks are ``uint32`` in the host formats and bit 31 is used (r*c = 32 for
4x8 and 8x4). torch has no right shift for ``UInt32`` on the CPU, so the
device views carry masks as an ``int32`` view of the same bits: after an
arithmetic shift ``(m >> k) & 1`` is still bit k.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Union

import numpy as np
import torch

from .formats import BF16_HOST, ChunkDescriptors, SPC5Chunked, SPC5Panels

Device = Union[str, torch.device]


class SPC5Device(NamedTuple):
    """Tensor view of :class:`SPC5Chunked` (static meta kept python-side)."""

    values: torch.Tensor       # (nvals_padded,) float32, bfloat16 or int8
    chunk_col: torch.Tensor    # (nchunks, cb) int32
    chunk_mask: torch.Tensor   # (nchunks, cb) int32 view of the uint32 masks
    chunk_voff: torch.Tensor   # (nchunks, cb) int32
    chunk_row: torch.Tensor    # (nchunks, cb) int32
    chunk_vbase: torch.Tensor  # (nchunks,) int32


class SPC5PanelDevice(NamedTuple):
    """Tensor view of :class:`SPC5Panels` (static meta kept python-side)."""

    values: torch.Tensor       # (nvals_padded,) float32, bfloat16 or int8
    chunk_col: torch.Tensor    # (npanels, nchunks, cb) int32, window-relative
    chunk_mask: torch.Tensor   # (npanels, nchunks, cb) int32 view of uint32
    chunk_voff: torch.Tensor   # (npanels, nchunks, cb) int32
    chunk_row: torch.Tensor    # (npanels, nchunks, cb) int32, panel-relative
    chunk_vbase: torch.Tensor  # (npanels, nchunks) int32
    chunk_xbase: torch.Tensor  # (npanels, nchunks) int32


def to_tensor(a: np.ndarray, device: Device) -> torch.Tensor:
    """One host array -> a contiguous tensor on ``device``.

    ``uint32`` becomes its ``int32`` view (same bytes); bf16 values, the
    port's bit patterns (``formats.BF16_HOST``) or the reference's
    ``ml_dtypes.bfloat16`` (known by its dtype name, with no import), become
    ``torch.bfloat16`` with the same bits; other float values become
    float32, which is what the reference stores too: its ``jnp.asarray``
    drops the generators' float64 to float32 because JAX runs without
    x64."""
    a = np.ascontiguousarray(a)
    if not a.flags.writeable:           # e.g. a JAX array's host view
        a = a.copy()
    if a.dtype.name == "bfloat16":
        a = a.view(BF16_HOST)
    if a.dtype == BF16_HOST:
        return torch.from_numpy(a.view(np.int16)).to(device).view(
            torch.bfloat16)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    elif a.dtype.kind == "f":
        a = a.astype(np.float32, copy=False)
    return torch.from_numpy(a).to(device)


def device_put(chunked: SPC5Chunked, device: Device) -> SPC5Device:
    return SPC5Device(*(to_tensor(getattr(chunked, n), device)
                        for n in SPC5Device._fields))


def device_put_panels(panels: SPC5Panels, device: Device) -> SPC5PanelDevice:
    return SPC5PanelDevice(*(to_tensor(getattr(panels, n), device)
                             for n in SPC5PanelDevice._fields))


def _upcast(vals: torch.Tensor, scale=None) -> torch.Tensor:
    """The reference's f32-accumulation contract, shared by every decode:
    int kinds and floats narrower than 4 bytes (int8, bf16) are upcast to
    f32, then the optional per-chunk ``scale`` (the leading chunk dims,
    broadcast over the trailing (cb, r*c) lane dims) is applied; f32 without
    a scale passes through as it is."""
    if not vals.is_floating_point() or vals.element_size() < 4:
        vals = vals.float()
    if scale is not None:
        vals = vals * scale.to(vals.dtype)[..., None, None]
    return vals


def _decode(values, chunk_mask, chunk_voff, chunk_vbase, r: int, c: int,
            scale=None):
    """Shared mask decode over any leading chunk shape: returns the expanded
    values (upcast and scaled, :func:`_upcast`; set lanes only, others 0),
    the lane index k and the lane bits, each with a trailing r*c axis."""
    rc = r * c
    k = torch.arange(rc, dtype=torch.int32, device=values.device)
    bits = (chunk_mask[..., None] >> k) & 1
    ranks = torch.cumsum(bits, dim=-1, dtype=torch.int32) - bits
    vidx = chunk_vbase[..., None, None] + chunk_voff[..., None] + ranks
    vidx = vidx.clamp(0, values.shape[0] - 1).long()
    vals = _upcast(values[vidx], scale)
    return vals * bits.to(vals.dtype), k, bits


def spmv(dev: SPC5Device, x: torch.Tensor, value_scale=None, *, r: int,
         c: int, nrows: int, ncols: int) -> torch.Tensor:
    """y = A @ x with A in chunked beta(r, c) (whole-vector layout);
    ``value_scale`` (nchunks,) dequantises int8 values (:func:`_upcast`).

    Unset lanes carry a zero value; their clamped gather/scatter indices
    stay in bounds and add nothing (the reference's jnp scatter drops
    out-of-range rows instead, with the same result)."""
    vals, k, _ = _decode(dev.values, dev.chunk_mask, dev.chunk_voff,
                         dev.chunk_vbase, r, c, value_scale)
    xcol = (dev.chunk_col[..., None] + k % c).clamp(0, ncols - 1).long()
    yrow = (dev.chunk_row[..., None] + k // c).clamp(0, nrows - 1).long()
    contrib = vals * x[xcol]
    y = torch.zeros(nrows, dtype=contrib.dtype, device=contrib.device)
    return y.index_add_(0, yrow.reshape(-1), contrib.reshape(-1))


def pad_cmap(cmap: torch.Tensor, ncols_pad: int) -> torch.Tensor:
    """A column map of ncols entries extended to the layout's padded width:
    entry j >= ncols is j itself, so a column at or past ncols reads x's
    zero padding. (The reference pads with 0, so such a column, which only
    an unset lane ever names, reads x[0] times a zero value: the same sum
    unless x[0] is inf or NaN.)"""
    n = cmap.shape[0]
    if ncols_pad <= n:
        return cmap
    return torch.cat([cmap, torch.arange(n, ncols_pad, dtype=cmap.dtype,
                                         device=cmap.device)])


def _mapped(xcol: torch.Tensor, cmap, ncols_pad: int) -> torch.Tensor:
    """Window columns (in [0, ncols_pad)) through the column map ``cmap``
    (None: unmapped), as int64 indices into x padded to ncols_pad."""
    if cmap is None:
        return xcol.long()
    return pad_cmap(cmap.long(), ncols_pad)[xcol.long()]


def spmv_panels(dev: SPC5PanelDevice, x: torch.Tensor, cmap=None,
                value_scale=None, *, r: int, c: int, pr: int, nrows: int,
                ncols_pad: int) -> torch.Tensor:
    """y = A @ x with A in the row-panel-tiled layout; x (ncols,).
    ``value_scale`` (npanels, nchunks) dequantises int8 values. ``cmap``
    ((ncols,) integers) is a fused column permutation: block columns are
    contiguous in the permuted column space, and the decode reads x, kept
    in the original order, at ``cmap[column]`` (:func:`pad_cmap`)."""
    npanels = dev.chunk_mask.shape[0]
    xp = torch.nn.functional.pad(x, (0, max(0, ncols_pad - x.shape[0])))
    vals, k, _ = _decode(dev.values, dev.chunk_mask, dev.chunk_voff,
                         dev.chunk_vbase, r, c, value_scale)
    xcol = _mapped((dev.chunk_xbase[..., None, None] + dev.chunk_col[..., None]
                    + k % c).clamp(0, ncols_pad - 1), cmap, ncols_pad)
    panel_row0 = (torch.arange(npanels, dtype=torch.int32, device=x.device)
                  * pr)[:, None, None, None]
    yrow = (panel_row0 + dev.chunk_row[..., None]
            + k // c).clamp(0, npanels * pr - 1).long()
    contrib = vals * xp[xcol]
    y = torch.zeros(npanels * pr, dtype=contrib.dtype, device=contrib.device)
    y.index_add_(0, yrow.reshape(-1), contrib.reshape(-1))
    return y[:nrows]


#: Most elements (set lanes x columns) one column slice of the plain SpMM
#: materialises per temporary: 2**28 f32 values are 1 GiB, so the plain
#: product of a full-width layer fits on the card beside its kernels.
_SLICE_ELEMS = 2 ** 28


def _spmm_set_lanes(vals, bits, xcol, yrow, x: torch.Tensor,
                    nrows: int) -> torch.Tensor:
    """Y[yrow] += vals * X[xcol] over the set lanes only, X (ncols, nvec).

    A set lane always names a row and a column inside the matrix, so no
    index is clamped and X needs no padding; the columns of X go through in
    slices of at most ``_SLICE_ELEMS`` products."""
    keep = bits.bool()
    return _spmm_scatter(vals[keep], xcol[keep].long(), yrow[keep].long(),
                         x, nrows)


def _spmm_scatter(vals, xcol, yrow, x: torch.Tensor,
                  nrows: int) -> torch.Tensor:
    """Y[yrow] += vals * X[xcol] over a flat list of lanes (int64 indices
    inside X and Y), the columns of X in slices of at most
    ``_SLICE_ELEMS`` products."""
    nvec = x.shape[1]
    y = torch.zeros(nrows, nvec, dtype=vals.dtype, device=vals.device)
    step = max(1, _SLICE_ELEMS // max(1, vals.shape[0]))
    for j0 in range(0, nvec, step):
        xs = x[:, j0:j0 + step]
        part = torch.zeros(nrows, xs.shape[1], dtype=vals.dtype,
                           device=vals.device)
        y[:, j0:j0 + step] = part.index_add_(0, yrow, vals[:, None] * xs[xcol])
    return y


def spmm(dev: SPC5Device, x: torch.Tensor, value_scale=None, *, r: int,
         c: int, nrows: int, ncols: int) -> torch.Tensor:
    """Y = A @ X with A in chunked beta(r, c) (whole-vector layout); X is
    (ncols, nvec) and Y (nrows, nvec), both row-major; ``value_scale`` as
    in :func:`spmv`."""
    vals, k, bits = _decode(dev.values, dev.chunk_mask, dev.chunk_voff,
                            dev.chunk_vbase, r, c, value_scale)
    xcol = dev.chunk_col[..., None] + k % c
    yrow = dev.chunk_row[..., None] + k // c
    return _spmm_set_lanes(vals, bits, xcol, yrow, x, nrows)


def spmm_panels(dev: SPC5PanelDevice, x: torch.Tensor, cmap=None,
                value_scale=None, *, r: int, c: int, pr: int, nrows: int,
                ncols_pad: int) -> torch.Tensor:
    """Y = A @ X with A in the row-panel-tiled layout; X (ncols, nvec);
    ``cmap`` and ``value_scale`` as in :func:`spmv_panels`.

    ``ncols_pad`` is kept for the reference's signature: set lanes never
    reach past the matrix's columns, so X is not padded here."""
    npanels = dev.chunk_mask.shape[0]
    vals, k, bits = _decode(dev.values, dev.chunk_mask, dev.chunk_voff,
                            dev.chunk_vbase, r, c, value_scale)
    xcol = (dev.chunk_xbase[..., None, None] + dev.chunk_col[..., None]
            + k % c)
    if cmap is not None:
        # a set lane's column lies below ncols; unset lanes are dropped
        xcol = _mapped(xcol.clamp(0, ncols_pad - 1), cmap, ncols_pad)
    panel_row0 = (torch.arange(npanels, dtype=torch.int32, device=x.device)
                  * pr)[:, None, None, None]
    yrow = panel_row0 + dev.chunk_row[..., None] + k // c
    return _spmm_set_lanes(vals, bits, xcol, yrow, x, nrows)


# ----------------------------------------------------------------------------
# Descriptor lowering: build-time gather tables, no mask decode
# ----------------------------------------------------------------------------

class SPC5DescDevice(NamedTuple):
    """Tensor view of the whole-vector descriptor lowering (the reference's
    field order). The index tables keep the narrowed dtypes they were built
    with (:func:`repro_torch.core.formats.chunk_descriptors`)."""

    values: torch.Tensor       # (nvals_padded,) float32, bfloat16 or int8
    desc_valid: torch.Tensor   # (nchunks, cb, r*c) int8, 0 => padding lane
    desc_vidx: torch.Tensor    # (nchunks, cb, r*c) int8/16/32, in window
    desc_xcol: torch.Tensor    # (nchunks, cb, r*c) int8/16/32, global x
    desc_yrow: torch.Tensor    # (nchunks, cb, r*c) int8/16/32, global y
    chunk_vbase: torch.Tensor  # (nchunks,) int32


class SPC5PanelDescDevice(NamedTuple):
    """Tensor view of the panel descriptor lowering (``desc_xcol``
    window-relative, ``desc_yrow`` panel-relative)."""

    values: torch.Tensor       # (nvals_padded,) float32, bfloat16 or int8
    desc_valid: torch.Tensor   # (npanels, nchunks, cb, r*c) int8
    desc_vidx: torch.Tensor    # (npanels, nchunks, cb, r*c) int8/16/32
    desc_xcol: torch.Tensor    # (npanels, nchunks, cb, r*c), window-rel
    desc_yrow: torch.Tensor    # (npanels, nchunks, cb, r*c), panel-rel
    chunk_vbase: torch.Tensor  # (npanels, nchunks) int32
    chunk_xbase: torch.Tensor  # (npanels, nchunks) int32


def device_put_desc(values: np.ndarray, desc: ChunkDescriptors,
                    chunk_vbase: np.ndarray, device: Device,
                    chunk_xbase: np.ndarray = None):
    """Host descriptor tables -> :class:`SPC5DescDevice` (or, with
    ``chunk_xbase``, :class:`SPC5PanelDescDevice`) on ``device``, each
    table in the narrow dtype it was built with."""
    arrays = (values, desc.valid, desc.vidx, desc.xcol, desc.yrow,
              chunk_vbase)
    if chunk_xbase is None:
        return SPC5DescDevice(*(to_tensor(a, device) for a in arrays))
    return SPC5PanelDescDevice(*(to_tensor(a, device)
                                 for a in arrays + (chunk_xbase,)))


def _desc_vals(values, valid, vidx, vbase, scale=None):
    """The descriptor expand: one gather from the chunk's value window
    (upcast and scaled, :func:`_upcast`) and the valid mask (narrow tables
    promote to int64 for indexing)."""
    gidx = vbase[..., None, None].long() + vidx.long()
    vals = _upcast(values[gidx.clamp(0, values.shape[0] - 1)], scale)
    return vals * valid.to(vals.dtype)


def spmv_desc(dev: SPC5DescDevice, x: torch.Tensor, value_scale=None, *,
              nrows: int) -> torch.Tensor:
    """y = A @ x through the whole-vector descriptors; ``value_scale``
    (nchunks,) dequantises int8 values. Unset lanes carry a zero value and
    in-bounds (clipped) indices, as in the reference."""
    vals = _desc_vals(dev.values, dev.desc_valid, dev.desc_vidx,
                      dev.chunk_vbase, value_scale)
    contrib = vals * x[dev.desc_xcol.long()]
    y = torch.zeros(nrows, dtype=contrib.dtype, device=contrib.device)
    return y.index_add_(0, dev.desc_yrow.reshape(-1).long(),
                        contrib.reshape(-1))


def spmv_panels_desc(dev: SPC5PanelDescDevice, x: torch.Tensor, cmap=None,
                     value_scale=None, *, pr: int, nrows: int,
                     ncols_pad: int) -> torch.Tensor:
    """y = A @ x through the panel descriptors; x (ncols,); ``value_scale``
    (npanels, nchunks) dequantises int8 values, ``cmap`` maps columns as in
    :func:`spmv_panels`."""
    npanels = dev.desc_valid.shape[0]
    xp = torch.nn.functional.pad(x, (0, max(0, ncols_pad - x.shape[0])))
    vals = _desc_vals(dev.values, dev.desc_valid, dev.desc_vidx,
                      dev.chunk_vbase, value_scale)
    xcol = _mapped((dev.chunk_xbase[..., None, None].long()
                    + dev.desc_xcol.long()).clamp(0, ncols_pad - 1), cmap,
                   ncols_pad)
    panel_row0 = (torch.arange(npanels, device=x.device)
                  * pr)[:, None, None, None]
    yrow = panel_row0 + dev.desc_yrow.long()
    contrib = vals * xp[xcol]
    y = torch.zeros(npanels * pr, dtype=contrib.dtype, device=contrib.device)
    y.index_add_(0, yrow.reshape(-1), contrib.reshape(-1))
    return y[:nrows]


def _desc_set_lanes(dev, scale=None):
    """The valid lanes of a descriptor view as flat int64 indices: each
    lane's unit (chunk, or panel * nchunks + chunk), its value (upcast, and
    times its unit's ``scale``) and its table entries. A valid lane names a
    value in its window and a row and column inside the matrix, so nothing
    is clamped."""
    lanes = torch.nonzero(dev.desc_valid.reshape(-1)).squeeze(1)
    unit = lanes // max(1, math.prod(dev.desc_valid.shape[-2:]))
    vals = _upcast(dev.values[dev.chunk_vbase.reshape(-1)[unit].long()
                              + dev.desc_vidx.reshape(-1)[lanes].long()])
    if scale is not None:
        vals = vals * scale.reshape(-1)[unit].to(vals.dtype)
    xcol = dev.desc_xcol.reshape(-1)[lanes].long()
    yrow = dev.desc_yrow.reshape(-1)[lanes].long()
    return unit, vals, xcol, yrow


def spmm_desc(dev: SPC5DescDevice, x: torch.Tensor, value_scale=None, *,
              nrows: int) -> torch.Tensor:
    """Y = A @ X through the whole-vector descriptors; X (ncols, nvec).

    Only the valid lanes are multiplied (the reference multiplies every
    lane, unset ones by 0: about 27 G products for a 64,000 x 4,096 layer
    in beta(4,8) at nvec = 128, which do not fit the card). ``value_scale``
    as in :func:`spmv_desc`."""
    _, vals, xcol, yrow = _desc_set_lanes(dev, value_scale)
    return _spmm_scatter(vals, xcol, yrow, x, nrows)


def spmm_panels_desc(dev: SPC5PanelDescDevice, x: torch.Tensor, cmap=None,
                     value_scale=None, *, pr: int, nrows: int,
                     ncols_pad: int) -> torch.Tensor:
    """Y = A @ X through the panel descriptors; X (ncols, nvec).

    The reference pads X with zero rows up to ``ncols_pad``; a lane whose
    column is at or past X's rows is dropped here instead, which adds the
    same nothing without a copy of X. ``cmap`` and ``value_scale`` as in
    :func:`spmv_panels_desc` (with a map, X has as many rows as the map)."""
    nchunks = dev.chunk_vbase.shape[1]
    unit, vals, xcol, yrow = _desc_set_lanes(dev, value_scale)
    xcol = xcol + dev.chunk_xbase.reshape(-1)[unit].long()
    yrow = yrow + (unit // nchunks) * pr
    inside = xcol < x.shape[0]
    vals, xcol, yrow = vals[inside], xcol[inside], yrow[inside]
    if cmap is not None:
        xcol = cmap.long()[xcol]
    return _spmm_scatter(vals, xcol, yrow, x, nrows)


# ----------------------------------------------------------------------------
# The beta(r,c)_test split's singleton tail (COO)
# ----------------------------------------------------------------------------

def spmv_dense_oracle(dense: np.ndarray, x: np.ndarray) -> np.ndarray:
    """Ground-truth product for tests (numpy, f64 accumulate), as in the
    reference."""
    return dense.astype(np.float64) @ x.astype(np.float64)


def spmv_coo(rows: torch.Tensor, cols: torch.Tensor, vals: torch.Tensor,
             x: torch.Tensor, *, nrows: int) -> torch.Tensor:
    """y = the singleton tail times x, the tail as flat COO (n_single,):
    one x element per nonzero, summed into its row (``index_add_``). The
    reference computes this outside any kernel (a jnp segment sum)."""
    prod = _upcast(vals) * x[cols.long()]
    y = torch.zeros(nrows, dtype=prod.dtype, device=prod.device)
    return y.index_add_(0, rows.long(), prod)


def spmm_coo(rows: torch.Tensor, cols: torch.Tensor, vals: torch.Tensor,
             x: torch.Tensor, *, nrows: int) -> torch.Tensor:
    """Y = the singleton tail times X (ncols, nvec), the tail as flat COO.
    The columns of X go through in slices of at most ``_SLICE_ELEMS``
    products, with the reference's arithmetic (a product per nonzero and
    column, summed into its row); the reference has no kernel for it."""
    return _spmm_scatter(_upcast(vals), cols.long(), rows.long(), x, nrows)


def spmv_coo_panels(rows: torch.Tensor, cols: torch.Tensor,
                    vals: torch.Tensor, x: torch.Tensor, *, pr: int,
                    nrows: int) -> torch.Tensor:
    """y = the panel-bucketed singleton tail times x: ``rows`` are
    panel-local, and ``rows``, ``cols`` and ``vals`` are (npanels, smax)
    buckets padded with zero values at local row 0 and column 0. Each
    panel's entries are summed into its (pr,) slice of y; a row outside
    [0, pr) is dropped, as the reference's segment sum drops it. Returns
    y[:nrows]. The plain version of ``spmv_tail_cuda``."""
    npanels = rows.shape[0]
    prod = _upcast(vals) * x[cols.long()]                  # (npanels, smax)
    inside = (rows >= 0) & (rows < pr)
    prod = torch.where(inside, prod, torch.zeros_like(prod))
    grow = (torch.arange(npanels, device=rows.device)[:, None] * pr
            + rows.long().clamp(0, pr - 1))
    y = torch.zeros(npanels * pr, dtype=prod.dtype, device=prod.device)
    y.index_add_(0, grow.reshape(-1), prod.reshape(-1))
    return y[:nrows]


def spmm_coo_panels(rows: torch.Tensor, cols: torch.Tensor,
                    vals: torch.Tensor, x: torch.Tensor, *, pr: int,
                    nrows: int) -> torch.Tensor:
    """Y = the panel-bucketed singleton tail times X (ncols, nvec): the
    (npanels, smax) buckets' panel-local rows made global (``p * pr +
    row``), then :func:`spmm_coo` over the flattened slots and npanels * pr
    rows, cut at nrows. Padding slots are multiplied like any other, as the
    reference's test layout multiplies them (it computes this outside any
    kernel, in ``_lower_spmm_test``). The plain version of
    ``spmm_tail_cuda``."""
    npanels = rows.shape[0]
    grows = (torch.arange(npanels, dtype=rows.dtype, device=rows.device)
             [:, None] * pr + rows)
    return spmm_coo(grows.reshape(-1), cols.reshape(-1), vals.reshape(-1),
                    x, nrows=npanels * pr)[:nrows]
