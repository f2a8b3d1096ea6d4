"""Static plan/format invariant checker: prove a plan before executing it.

The port's copy of ``repro.analysis.verify``, with the reference's rule
names, paths and messages. The SPC5 design rests on structural invariants
-- per-chunk bitmasks whose popcounts partition ``nnz`` exactly, descriptor
gather tables that stay in-bounds, blocking geometry that fits the kernels
-- but a corrupted descriptor or a non-permutation ``col_perm`` only ever
surfaced as silently wrong output. This module proves those invariants
WITHOUT running a kernel:

    report = verify_plan(plan)          # -> VerifyReport
    report.raise_if_failed()            # PlanVerificationError on violation

Every invariant is a named rule (see :func:`plan_rule_names`), individually
testable: corrupt a valid plan and exactly the matching rule fires. The
rules read the port's registry (``repro_torch.core.plan``), the format
semantics (``repro_torch.core.formats``) and the plan's tensors, copied to
the host (bf16 values read as their bit patterns, the masks' int32 view as
the uint32 masks they are), so a plan on the CPU and the same plan on the
card get the same report.

``vmem-budget`` keeps its name and its first half, the layout's registry
cost against the reference's ``VMEM_WHOLE_VECTOR_BUDGET`` (a TPU figure,
kept so a demotion the pipeline traced stays provable). Its second half
holds the port's kernels to the card: for the plan's (layout, lowering),
the shared memory a CTA of its SpMV and its SpMM kernels asks for at the
fewest stages their launchers take, at the plan's value width and ``nvec``
(the ``SMEM_CONTRACTS`` of ``kernels/spc5_*.py``, computed on the host),
against ``spc5_spmv.MAX_SMEM_BYTES`` (227 KB). A (layout, lowering) with no
contract fires the rule.

Layering: ``repro_torch.core.plan`` never imports this module at module
scope -- ``make_plan(verify=...)`` pulls it in lazily, so the checker can
import the registry freely.

``verify_records`` is the record-store counterpart: schema completeness of
every selector record (the port's ``backend`` field included) plus the
loader's malformed-line count (``RecordStore.skipped``).
"""
from __future__ import annotations

import dataclasses
import math
import re
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import formats as F
from repro_torch.core import plan as P
from repro_torch.kernels import (spc5_spmm, spc5_spmm_desc, spc5_spmv,
                                 spc5_spmv_desc)

__all__ = [
    "Violation", "VerifyReport", "PlanVerificationError",
    "verify_plan", "verify_records", "plan_rule_names",
]


# ----------------------------------------------------------------------------
# Report types
# ----------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Violation:
    """One invariant breach: the rule that proved it, where, and why."""

    rule: str
    path: str       # "plan", "plan.multi", "records[3]", ...
    message: str

    def __str__(self) -> str:
        return f"{self.path}: [{self.rule}] {self.message}"


class PlanVerificationError(ValueError):
    """Raised by :meth:`VerifyReport.raise_if_failed` on any violation."""

    def __init__(self, report: "VerifyReport"):
        self.report = report
        super().__init__(report.summary())


@dataclasses.dataclass(frozen=True)
class VerifyReport:
    """Outcome of a verification run.

    ``checked`` lists the rules that actually validated something (rules
    inapplicable to the plan's layout/lowering are absent); ``violations``
    is empty iff the plan proved clean.
    """

    violations: Tuple[Violation, ...]
    checked: Tuple[str, ...]

    @property
    def ok(self) -> bool:
        return not self.violations

    @property
    def rules_fired(self) -> frozenset:
        return frozenset(v.rule for v in self.violations)

    def summary(self) -> str:
        if self.ok:
            return f"verify: ok ({len(self.checked)} rules)"
        lines = [f"verify: {len(self.violations)} violation(s):"]
        lines += [f"  {v}" for v in self.violations]
        return "\n".join(lines)

    def raise_if_failed(self) -> "VerifyReport":
        if not self.ok:
            raise PlanVerificationError(self)
        return self


# ----------------------------------------------------------------------------
# Rule registry + per-plan context
# ----------------------------------------------------------------------------

_PLAN_RULES: Dict[str, Callable] = {}


def _rule(name: str):
    def deco(fn):
        fn.rule_name = name
        _PLAN_RULES[name] = fn
        return fn
    return deco


def plan_rule_names() -> Tuple[str, ...]:
    """Every named plan invariant, in evaluation order."""
    return tuple(_PLAN_RULES)


@dataclasses.dataclass
class _Ctx:
    """Per-(sub)plan verification context handed to every rule."""

    plan: Any
    path: str
    out: List[Violation]
    checked: List[str]
    nvec: int = 1
    budget: int = P.VMEM_WHOLE_VECTOR_BUDGET
    geom: Dict[str, Any] = dataclasses.field(default_factory=dict)
    spec: Optional[P.LayoutSpec] = None
    lowering: str = P.LOWERING_MASK
    vdtype: str = ""
    names: Tuple[str, ...] = ()
    host: Dict[str, np.ndarray] = dataclasses.field(default_factory=dict)

    def fail(self, rule: str, message: str) -> None:
        self.out.append(Violation(rule, self.path, message))

    def a(self, name: str) -> np.ndarray:
        return self.host[name]

    def fired(self, rule: str) -> bool:
        return any(v.rule == rule and v.path == self.path for v in self.out)


def _masked(ctx: _Ctx) -> bool:
    return ctx.lowering != P.LOWERING_DESC


def _host(a, name: str = "") -> np.ndarray:
    """A plan tensor as the reference's host array: bf16 as its bit
    patterns (``formats.BF16_HOST``), ``chunk_mask``'s int32 view as the
    uint32 masks."""
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu()
        if a.dtype == torch.bfloat16:
            return a.view(torch.int16).numpy().view(F.BF16_HOST)
        a = a.numpy()
    a = np.asarray(a)
    if name == "chunk_mask" and a.dtype == np.int32:
        a = a.view(np.uint32)
    return a


# ----------------------------------------------------------------------------
# Preconditions: registry membership, then geometry/shape schema
# ----------------------------------------------------------------------------

@_rule("layout-registered")
def _r_layout_registered(ctx: _Ctx) -> bool:
    """The layout key resolves in the registry and the plan's lowering is
    one the layout declared."""
    rule = "layout-registered"
    layout = ctx.plan.layout
    if layout not in P.layout_names():
        ctx.fail(rule, f"layout {layout!r} is not registered; "
                       f"have {P.layout_names()}")
        return True
    ctx.spec = P.get_layout(layout)
    ctx.geom = dict(ctx.plan.meta)
    ctx.lowering = ctx.geom.get("lowering", P.LOWERING_MASK)
    ctx.vdtype = ctx.geom.get("vdtype", "")
    if ctx.lowering not in ctx.spec.lowerings:
        ctx.fail(rule, f"lowering {ctx.lowering!r} is not registered by "
                       f"layout {layout!r} (declares {ctx.spec.lowerings})")
    return True


#: Required positive-integer geometry keys per layout (beyond the shared
#: nrows/ncols/nnz and the lowering tag).
_GEOM_KEYS = {
    P.LAYOUT_WHOLE: ("r", "c", "cb", "vmax"),
    P.LAYOUT_PANELS: ("r", "c", "pr", "cb", "xw", "vmax", "npanels",
                      "nchunks", "ncols_pad"),
    P.LAYOUT_TEST: (),
}


def _expected_shapes(ctx: _Ctx) -> Dict[str, Tuple[int, ...]]:
    g = ctx.geom
    layout, rc = ctx.plan.layout, g["r"] * g["c"]
    if layout == P.LAYOUT_WHOLE:
        nch = int(ctx.host["chunk_vbase"].shape[0])
        per_chunk = ((nch, g["cb"], rc) if ctx.lowering == P.LOWERING_DESC
                     else (nch, g["cb"]))
        names = {n: per_chunk for n in ctx.names
                 if n not in ("values", "chunk_vbase", "value_scale")}
        names["chunk_vbase"] = (nch,)
        if "value_scale" in ctx.names:      # one f32 scale per chunk
            names["value_scale"] = (nch,)
        return names
    per_chunk = ((g["npanels"], g["nchunks"], g["cb"], rc)
                 if ctx.lowering == P.LOWERING_DESC
                 else (g["npanels"], g["nchunks"], g["cb"]))
    names = {n: per_chunk for n in ctx.names
             if n not in ("values", "chunk_vbase", "chunk_xbase",
                          "value_scale")}
    names["chunk_vbase"] = (g["npanels"], g["nchunks"])
    names["chunk_xbase"] = (g["npanels"], g["nchunks"])
    if "value_scale" in ctx.names:
        names["value_scale"] = (g["npanels"], g["nchunks"])
    return names


@_rule("geometry-schema")
def _r_geometry_schema(ctx: _Ctx) -> bool:
    """Geometry keys present/positive and device-array shapes consistent
    with them (the precondition every array rule relies on)."""
    rule = "geometry-schema"
    g, layout = ctx.geom, ctx.plan.layout
    for key in ("nrows", "ncols", "nnz"):
        v = g.get(key)
        if not isinstance(v, (int, np.integer)) or v < 0:
            ctx.fail(rule, f"geometry key {key!r} missing or negative: {v!r}")
    if ctx.lowering not in P._LOWERING_NAMES:
        ctx.fail(rule, f"geometry 'lowering' must be one of "
                       f"{P._LOWERING_NAMES}, got {ctx.lowering!r}")
    for key in _GEOM_KEYS.get(layout, ()):
        v = g.get(key)
        if not isinstance(v, (int, np.integer)) or v < 1:
            ctx.fail(rule, f"geometry key {key!r} missing or non-positive: "
                           f"{v!r}")
    if ctx.fired(rule):
        return True
    if layout in (P.LAYOUT_WHOLE, P.LAYOUT_PANELS):
        if g["r"] * g["c"] > 32:
            ctx.fail(rule, f"block mask must fit uint32: r*c = "
                           f"{g['r'] * g['c']}")
        if layout == P.LAYOUT_PANELS:
            if g["pr"] % g["r"]:
                ctx.fail(rule, f"pr={g['pr']} is not a multiple of r={g['r']}")
            if g["xw"] < g["c"]:
                ctx.fail(rule, f"xw={g['xw']} cannot hold a c={g['c']} block")
            if g["ncols_pad"] < g["xw"]:
                ctx.fail(rule, f"ncols_pad={g['ncols_pad']} < xw={g['xw']}")
    if ctx.vdtype not in ("",) + F.VDTYPES:
        ctx.fail(rule, f"geometry 'vdtype' must be one of {F.VDTYPES} or "
                       f"'' (legacy), got {ctx.vdtype!r}")
        return True
    ctx.names = ctx.spec.plan_array_names(ctx.lowering, ctx.vdtype)
    if len(ctx.plan.arrays) != len(ctx.names):
        ctx.fail(rule, f"expected {len(ctx.names)} device arrays "
                       f"{ctx.names}, got {len(ctx.plan.arrays)}")
        return True
    ctx.host = {n: _host(a, n) for n, a in zip(ctx.names, ctx.plan.arrays)}
    if layout == P.LAYOUT_TEST:
        return True                      # tail shapes: the test-split rule
    if ctx.host["values"].ndim != 1:
        ctx.fail(rule, f"values must be 1-D (packed, no zero padding), got "
                       f"shape {ctx.host['values'].shape}")
    for name, want in _expected_shapes(ctx).items():
        got = ctx.host[name].shape
        if tuple(got) != tuple(want):
            ctx.fail(rule, f"array {name!r} has shape {tuple(got)}, "
                           f"geometry implies {tuple(want)}")
    return True


# ----------------------------------------------------------------------------
# Mask-lowering rules
# ----------------------------------------------------------------------------

@_rule("mask-popcount")
def _r_mask_popcount(ctx: _Ctx) -> bool:
    """Mask popcounts partition nnz exactly (the paper's packed-values
    property: every set bit is one stored value, no zero padding)."""
    if ctx.plan.layout == P.LAYOUT_TEST or not _masked(ctx):
        return False
    total = int(F.popcount_u32(ctx.a("chunk_mask")).sum())
    if total != ctx.geom["nnz"]:
        ctx.fail("mask-popcount",
                 f"mask popcounts sum to {total}, geometry says "
                 f"nnz={ctx.geom['nnz']}")
    return True


@_rule("mask-voff-window")
def _r_mask_voff_window(ctx: _Ctx) -> bool:
    """Per chunk, ``chunk_voff`` is the exclusive prefix popcount of the
    chunk's masks and the chunk's values fit its static vmax window."""
    if ctx.plan.layout == P.LAYOUT_TEST or not _masked(ctx):
        return False
    rule = "mask-voff-window"
    cb = ctx.geom["cb"]
    mask = ctx.a("chunk_mask").reshape(-1, cb)
    voff = ctx.a("chunk_voff").reshape(-1, cb)
    pop = F.popcount_u32(mask)
    expect = F.exclusive_prefix_popcount(mask, axis=1)
    bad = (voff != expect) & (mask != 0)
    if bad.any():
        ch, sl = np.argwhere(bad)[0]
        ctx.fail(rule, f"chunk_voff[{ch},{sl}]={voff[ch, sl]} but the "
                       f"exclusive prefix popcount is {expect[ch, sl]}")
    per_chunk = pop.sum(axis=1)
    if (per_chunk > ctx.geom["vmax"]).any():
        ch = int(np.argmax(per_chunk > ctx.geom["vmax"]))
        ctx.fail(rule, f"chunk {ch} holds {int(per_chunk[ch])} values, "
                       f"vmax window is {ctx.geom['vmax']}")
    return True


@_rule("values-window-bounds")
def _r_values_window_bounds(ctx: _Ctx) -> bool:
    """Every chunk's ``[vbase, vbase + vmax)`` DMA window lies inside the
    packed values array (both lowerings share chunk_vbase)."""
    if ctx.plan.layout == P.LAYOUT_TEST:
        return False
    rule = "values-window-bounds"
    vbase = ctx.a("chunk_vbase").ravel().astype(np.int64)
    nvals = ctx.a("values").shape[0]
    if (vbase < 0).any():
        ctx.fail(rule, f"negative chunk_vbase: {int(vbase.min())}")
    hi = int(vbase.max()) + ctx.geom["vmax"] if vbase.size else 0
    if hi > nvals:
        ctx.fail(rule, f"value window [vbase, vbase+vmax) reaches {hi}, "
                       f"values array has {nvals} entries")
    return True


@_rule("chunk-row-bounds")
def _r_chunk_row_bounds(ctx: _Ctx) -> bool:
    """``chunk_row`` scatter bases in range: whole-vector rows are
    r-aligned global rows in [0, nrows), monotone over real blocks (unless
    the build fused a row permutation in); panel rows are panel-relative in
    [0, pr - r]."""
    if ctx.plan.layout == P.LAYOUT_TEST or not _masked(ctx):
        return False
    rule = "chunk-row-bounds"
    g = ctx.geom
    row = ctx.a("chunk_row")
    real = ctx.a("chunk_mask") != 0
    rows = row[real].astype(np.int64)
    if rows.size == 0:
        return True
    if ctx.plan.layout == P.LAYOUT_WHOLE:
        if rows.min() < 0 or rows.max() >= g["nrows"]:
            ctx.fail(rule, f"chunk_row out of [0, nrows={g['nrows']}): "
                           f"min={int(rows.min())} max={int(rows.max())}")
        if not ctx.plan.rows_fused:
            if (rows % g["r"]).any():
                ctx.fail(rule, f"chunk_row not r={g['r']}-aligned")
            flat = row.reshape(-1)[real.reshape(-1)]
            if (np.diff(flat.astype(np.int64)) < 0).any():
                ctx.fail(rule, "chunk_row not monotone over real blocks "
                               "(blocks must stay in interval order)")
    else:
        if rows.min() < 0 or rows.max() > g["pr"] - g["r"]:
            ctx.fail(rule, f"panel-relative chunk_row out of "
                           f"[0, pr-r={g['pr'] - g['r']}]: "
                           f"min={int(rows.min())} max={int(rows.max())}")
        elif (rows % g["r"]).any():
            ctx.fail(rule, f"chunk_row not r={g['r']}-aligned")
    return True


@_rule("chunk-col-bounds")
def _r_chunk_col_bounds(ctx: _Ctx) -> bool:
    """``chunk_col`` gather bases in range: whole-vector block columns in
    [0, ncols); panel columns window-relative in [0, xw - c] with every
    x window inside the padded vector."""
    if ctx.plan.layout == P.LAYOUT_TEST or not _masked(ctx):
        return False
    rule = "chunk-col-bounds"
    g = ctx.geom
    cols = ctx.a("chunk_col")[ctx.a("chunk_mask") != 0].astype(np.int64)
    if ctx.plan.layout == P.LAYOUT_WHOLE:
        if cols.size and (cols.min() < 0 or cols.max() >= g["ncols"]):
            ctx.fail(rule, f"chunk_col out of [0, ncols={g['ncols']}): "
                           f"min={int(cols.min())} max={int(cols.max())}")
    else:
        if cols.size and (cols.min() < 0 or cols.max() > g["xw"] - g["c"]):
            ctx.fail(rule, f"window-relative chunk_col out of "
                           f"[0, xw-c={g['xw'] - g['c']}]: "
                           f"min={int(cols.min())} max={int(cols.max())}")
        xbase = ctx.a("chunk_xbase").astype(np.int64)
        if (xbase < 0).any():
            ctx.fail(rule, f"negative chunk_xbase: {int(xbase.min())}")
        if xbase.size and int(xbase.max()) + g["xw"] > g["ncols_pad"]:
            ctx.fail(rule, f"x window [xbase, xbase+xw) reaches "
                           f"{int(xbase.max()) + g['xw']}, "
                           f"ncols_pad={g['ncols_pad']}")
    return True


# ----------------------------------------------------------------------------
# Descriptor-lowering rules
# ----------------------------------------------------------------------------

@_rule("descriptor-valid-mask")
def _r_descriptor_valid(ctx: _Ctx) -> bool:
    """Descriptor ``valid`` lanes are 0/1 and partition nnz exactly (the
    expanded image of the mask popcount invariant)."""
    if ctx.plan.layout == P.LAYOUT_TEST or _masked(ctx):
        return False
    rule = "descriptor-valid-mask"
    valid = ctx.a("desc_valid")
    if not np.isin(valid, (0, 1)).all():
        ctx.fail(rule, "desc_valid has entries outside {0, 1}")
    total = int(valid.sum())
    if total != ctx.geom["nnz"]:
        ctx.fail(rule, f"desc_valid lanes sum to {total}, geometry says "
                       f"nnz={ctx.geom['nnz']}")
    return True


@_rule("descriptor-bounds")
def _r_descriptor_bounds(ctx: _Ctx) -> bool:
    """Descriptor gather/scatter tables in-bounds: vidx < vmax, xcol <
    xmax (ncols / xw), yrow < ymax (nrows / pr) -- for EVERY lane, since
    the build clips padding lanes too (their gathered garbage is zeroed by
    valid, but an OOB index would still fault the DMA)."""
    if ctx.plan.layout == P.LAYOUT_TEST or _masked(ctx):
        return False
    rule = "descriptor-bounds"
    g = ctx.geom
    if ctx.plan.layout == P.LAYOUT_WHOLE:
        xmax, ymax = g["ncols"], g["nrows"]
    else:
        xmax, ymax = g["xw"], g["pr"]
    for name, limit in (("desc_vidx", g["vmax"]), ("desc_xcol", xmax),
                        ("desc_yrow", ymax)):
        t = ctx.a(name)
        if t.size and (t.min() < 0 or t.max() >= limit):
            ctx.fail(rule, f"{name} out of [0, {limit}): "
                           f"min={int(t.min())} max={int(t.max())}")
    return True


@_rule("descriptor-vidx-consistent")
def _r_descriptor_vidx(ctx: _Ctx) -> bool:
    """Within each chunk, the valid lanes' ``vidx`` enumerate the chunk's
    packed values exactly once in lane order (0, 1, 2, ... -- the cumsum
    the mask decode would have produced). Guarantees the no-padding value
    packing survived descriptor expansion."""
    if ctx.plan.layout == P.LAYOUT_TEST or _masked(ctx):
        return False
    rule = "descriptor-vidx-consistent"
    rc = ctx.geom["r"] * ctx.geom["c"]
    lanes = ctx.geom["cb"] * rc
    valid = ctx.a("desc_valid").reshape(-1, lanes)
    vidx = ctx.a("desc_vidx").reshape(-1, lanes)
    expect = np.cumsum(valid, axis=1) - valid
    bad = (vidx != expect) & (valid == 1)
    if bad.any():
        ch, ln = np.argwhere(bad)[0]
        ctx.fail(rule, f"chunk {ch} lane {ln}: vidx={int(vidx[ch, ln])} but "
                       f"the lane-order value rank is {int(expect[ch, ln])}")
    return True


@_rule("descriptor-index-width")
def _r_descriptor_index_width(ctx: _Ctx) -> bool:
    """Descriptor gather tables carry the NARROWED index dtypes the chunk
    geometry allows: each table's dtype both covers its bound (a too-narrow
    dtype would have wrapped at build time) and IS the narrowest signed
    integer that does (``formats.narrow_index_dtype`` -- a silently widened
    table would undo the bytes-per-nnz win the descriptor lowering exists
    for). ``desc_lane_nbytes`` in the geometry must equal the actual
    per-lane byte count of the stored tables."""
    if ctx.plan.layout == P.LAYOUT_TEST or _masked(ctx):
        return False
    rule = "descriptor-index-width"
    g = ctx.geom
    if ctx.plan.layout == P.LAYOUT_WHOLE:
        xmax, ymax = g["ncols"], g["nrows"]
    else:
        xmax, ymax = g["xw"], g["pr"]
    for name, limit in (("desc_vidx", g["vmax"]), ("desc_xcol", xmax),
                        ("desc_yrow", ymax)):
        dt = ctx.a(name).dtype
        if dt.kind != "i":
            ctx.fail(rule, f"{name} dtype {dt} is not a signed integer")
            continue
        if np.iinfo(dt).max < limit - 1:
            ctx.fail(rule, f"{name} dtype {dt} cannot represent its bound "
                           f"{limit - 1} (indices wrapped at build time)")
        want = F.narrow_index_dtype(max(limit - 1, 0))
        if dt.itemsize > want.itemsize:
            ctx.fail(rule, f"{name} stored as {dt} but bound {limit - 1} "
                           f"narrows to {want} (table not narrowed)")
    if ctx.a("desc_valid").dtype.itemsize != 1:
        ctx.fail(rule, f"desc_valid must be a 1-byte flag, got "
                       f"{ctx.a('desc_valid').dtype}")
    lane = (1 + ctx.a("desc_vidx").dtype.itemsize
            + ctx.a("desc_xcol").dtype.itemsize
            + ctx.a("desc_yrow").dtype.itemsize)
    declared = g.get("desc_lane_nbytes")
    if declared is not None and int(declared) != lane:
        ctx.fail(rule, f"geometry desc_lane_nbytes={declared} but the "
                       f"stored tables take {lane} bytes per lane")
    return True


# ----------------------------------------------------------------------------
# Value-dtype rules
# ----------------------------------------------------------------------------

@_rule("value-dtype")
def _r_value_dtype(ctx: _Ctx) -> bool:
    """The plan's value store matches its declared ``vdtype``: stored
    values carry the declared dtype, and int8 plans carry one finite,
    strictly positive f32 dequantisation scale per chunk (shape-checked by
    geometry-schema; corrupt scales would silently rescale whole chunks of
    output)."""
    if ctx.plan.layout == P.LAYOUT_TEST or not ctx.vdtype:
        return False                    # legacy dtype= passthrough: no claim
    rule = "value-dtype"
    want = F.value_dtype(ctx.vdtype)
    got = ctx.a("values").dtype
    if got != want:
        ctx.fail(rule, f"vdtype {ctx.vdtype!r} declares values dtype "
                       f"{want}, stored array is {got}")
    if ctx.vdtype != "int8":
        return True
    if "value_scale" not in ctx.names:
        ctx.fail(rule, "int8 plan is missing its value_scale array")
        return True
    scale = ctx.a("value_scale")
    if scale.dtype != np.float32:
        ctx.fail(rule, f"value_scale must be f32, got {scale.dtype}")
    if not np.isfinite(scale).all():
        ctx.fail(rule, "value_scale has non-finite entries")
    elif scale.size and float(scale.min()) <= 0.0:
        ctx.fail(rule, f"value_scale must be strictly positive "
                       f"(dequantisation divides by it at build time); "
                       f"min={float(scale.min())}")
    return True


# ----------------------------------------------------------------------------
# Cross-cutting rules
# ----------------------------------------------------------------------------

@_rule("permutation")
def _r_permutation(ctx: _Ctx) -> bool:
    """``col_perm``/``row_iperm`` riding on the plan are true permutations
    of [0, ncols) / [0, nrows)."""
    rule = "permutation"
    ran = False
    for name, n in (("col_perm", ctx.geom.get("ncols")),
                    ("row_iperm", ctx.geom.get("nrows"))):
        perm = getattr(ctx.plan, name)
        if perm is None or n is None:
            continue
        ran = True
        perm = _host(perm)
        if perm.shape != (n,):
            ctx.fail(rule, f"{name} has shape {perm.shape}, expected ({n},)")
        elif not np.array_equal(np.sort(perm.astype(np.int64)), np.arange(n)):
            ctx.fail(rule, f"{name} is not a permutation of [0, {n})")
    return ran


def smem_contracts() -> Dict[str, Dict[Tuple[str, str], Callable]]:
    """{"SpMV": ..., "SpMM": ...}: the kernel modules' shared-memory
    contracts by (layout, lowering), read at each call."""
    return {"SpMV": {**spc5_spmv.SMEM_CONTRACTS,
                     **spc5_spmv_desc.SMEM_CONTRACTS},
            "SpMM": {**spc5_spmm.SMEM_CONTRACTS,
                     **spc5_spmm_desc.SMEM_CONTRACTS}}


@_rule("vmem-budget")
def _r_vmem_budget(ctx: _Ctx) -> bool:
    """The layout's registry cost fits the auto-selection budget (so a
    demotion traced by the pipeline is provable from the plan alone) and
    the shared memory the plan's SpMV and SpMM kernels ask for a CTA
    (:func:`smem_contracts`) fits the card's, both at the plan's ACTUAL
    value itemsize."""
    if ctx.plan.layout == P.LAYOUT_TEST:
        return False                     # children carry their own budget
    rule = "vmem-budget"
    g = ctx.geom
    itemsize = int(ctx.a("values").dtype.itemsize)
    cost = ctx.spec.cost(g["nrows"], g["ncols"], itemsize, ctx.nvec)
    if cost > ctx.budget:
        ctx.fail(rule, f"layout {ctx.plan.layout!r} costs {cost} bytes at "
                       f"itemsize={itemsize} nvec={ctx.nvec}, over the "
                       f"{ctx.budget}-byte budget (should have been demoted)")
    key = (ctx.plan.layout, ctx.lowering)
    limit = spc5_spmv.MAX_SMEM_BYTES
    for label, contracts in smem_contracts().items():
        contract = contracts.get(key)
        if contract is None:
            ctx.fail(rule, f"no {label} shared-memory contract declared for "
                           f"{key}")
            continue
        try:
            smem = contract(g, itemsize, nvec=ctx.nvec)
        except ValueError as e:         # the launch planner found no fit
            ctx.fail(rule, f"{label} kernel contract: {e}")
            continue
        if smem > limit:
            ctx.fail(rule, f"{label} kernel contract needs {smem} bytes of "
                           f"shared memory per CTA, over the {limit}-byte "
                           f"ceiling of a Hopper CTA")
    return True


_TRACE_PASSES = ("tune", "reorder", "layout", "build")
_TUNE_SOURCES = ("store", "no-store", "explicit", "disabled", "delegated")
_TRACE_KEYS = {"tune": ("source", "duration_s"),
               "reorder": ("strategy", "applied", "duration_s"),
               "layout": ("layout", "reason", "lowering", "vdtype",
                          "duration_s"),
               "build": ("layout", "rows_fused", "duration_s"),
               "degrade": ("rung", "reason", "duration_s")}


@_rule("trace-schema")
def _r_trace_schema(ctx: _Ctx) -> bool:
    """``plan.trace`` is complete and schema-valid: every pipeline pass
    present in order, required keys per pass, the build/layout entries
    naming THIS plan's layout, and every demotion flag carrying a sibling
    ``*_reason`` (demotions must be explained, not just flagged). The
    degradation ladder may append trailing ``degrade`` entries after
    ``build`` -- each must name the rung it demoted to and the failure
    that forced it."""
    rule = "trace-schema"
    try:
        trace = ctx.plan.trace
    except Exception as e:              # malformed trace_json
        ctx.fail(rule, f"trace_json does not parse: {e}")
        return True
    if (not isinstance(trace, list)
            or any(not isinstance(e, dict) for e in trace)):
        ctx.fail(rule, "trace is not a list of pass entries")
        return True
    passes = tuple(e.get("pass") for e in trace)
    n = len(_TRACE_PASSES)
    if passes[:n] != _TRACE_PASSES or \
            any(p != "degrade" for p in passes[n:]):
        ctx.fail(rule, f"pass sequence {passes} != {_TRACE_PASSES} "
                       f"(+ optional trailing 'degrade' entries)")
        return True
    for entry in trace:
        name = entry["pass"]
        for key in _TRACE_KEYS[name]:
            if key not in entry:
                ctx.fail(rule, f"{name} entry is missing {key!r}")
        for key, val in entry.items():
            if key.endswith("demoted") and val \
                    and not entry.get(key + "_reason"):
                ctx.fail(rule, f"{name} entry flags {key!r} without a "
                               f"{key}_reason")
    tune, _, layout, build = trace[:n]
    if tune.get("source") not in _TUNE_SOURCES:
        ctx.fail(rule, f"tune source {tune.get('source')!r} not in "
                       f"{_TUNE_SOURCES}")
    for entry, label in ((layout, "layout"), (build, "build")):
        if entry.get("layout") != ctx.plan.layout:
            ctx.fail(rule, f"{label} entry names layout "
                           f"{entry.get('layout')!r}, plan is "
                           f"{ctx.plan.layout!r}")
    if "rows_fused" in build \
            and bool(build["rows_fused"]) != bool(ctx.plan.rows_fused):
        ctx.fail(rule, f"build entry rows_fused={build['rows_fused']} "
                       f"disagrees with plan.rows_fused="
                       f"{ctx.plan.rows_fused}")
    return True


@_rule("test-split")
def _r_test_split(ctx: _Ctx) -> bool:
    """The beta_test split partitions nnz between the multi-block sub-plan
    and the singleton tail, and the tail arrays (flat or panel-bucketed)
    stay in bounds."""
    if ctx.plan.layout != P.LAYOUT_TEST:
        return False
    rule = "test-split"
    g = ctx.geom
    if len(ctx.plan.children) != 1:
        ctx.fail(rule, f"test split must carry exactly one multi sub-plan, "
                       f"has {len(ctx.plan.children)} children")
        return True
    multi_nnz = dict(ctx.plan.children[0].meta).get("nnz")
    n_single = g.get("n_single")
    if not isinstance(n_single, (int, np.integer)) or n_single < 0:
        ctx.fail(rule, f"geometry key 'n_single' missing or negative: "
                       f"{n_single!r}")
        return True
    if multi_nnz is None or multi_nnz + n_single != g["nnz"]:
        ctx.fail(rule, f"multi.nnz ({multi_nnz}) + n_single ({n_single}) "
                       f"!= nnz ({g['nnz']}): the split lost or invented "
                       f"values")
    rows, cols, vals, xbase = (ctx.host[n] for n in ctx.names)
    if not (rows.shape == cols.shape == vals.shape):
        ctx.fail(rule, f"tail arrays disagree on shape: rows "
                       f"{rows.shape}, cols {cols.shape}, values "
                       f"{vals.shape}")
        return True
    if g.get("tail_pr"):
        if rows.ndim != 2:
            ctx.fail(rule, f"bucketed tail arrays must be 2-D "
                           f"(npanels, smax), got {rows.shape}")
            return True
        if rows.size and (rows.min() < 0 or rows.max() >= g["tail_pr"]):
            ctx.fail(rule, f"panel-relative tail rows out of "
                           f"[0, tail_pr={g['tail_pr']})")
        if cols.size and (cols.min() < 0 or cols.max() >= g["ncols"]):
            ctx.fail(rule, f"tail cols out of [0, ncols={g['ncols']})")
        xb = xbase.astype(np.int64)
        if xb.size and (xb.min() < 0
                        or int(xb.max()) + g["tail_xw"]
                        > g["tail_ncols_pad"]):
            ctx.fail(rule, f"tail x window [xbase, xbase+tail_xw) exceeds "
                           f"tail_ncols_pad={g['tail_ncols_pad']}")
    else:
        if rows.ndim != 1:
            ctx.fail(rule, f"flat tail arrays must be 1-D, got {rows.shape}")
            return True
        if rows.shape[0] != n_single:
            ctx.fail(rule, f"flat tail holds {rows.shape[0]} singletons, "
                           f"geometry says n_single={n_single}")
        if rows.size and (rows.min() < 0 or rows.max() >= g["nrows"]):
            ctx.fail(rule, f"tail rows out of [0, nrows={g['nrows']})")
        if cols.size and (cols.min() < 0 or cols.max() >= g["ncols"]):
            ctx.fail(rule, f"tail cols out of [0, ncols={g['ncols']})")
    return True


# ----------------------------------------------------------------------------
# Driver
# ----------------------------------------------------------------------------

#: Rules that need the geometry/shape precondition to have passed before
#: they can index device arrays safely.
_ARRAY_RULES = ("mask-popcount", "mask-voff-window", "values-window-bounds",
                "chunk-row-bounds", "chunk-col-bounds",
                "descriptor-valid-mask", "descriptor-bounds",
                "descriptor-vidx-consistent", "descriptor-index-width",
                "value-dtype", "vmem-budget", "test-split")


def verify_plan(plan: P.SPC5Plan, *, nvec: int = 1,
                budget_bytes: int = P.VMEM_WHOLE_VECTOR_BUDGET
                ) -> VerifyReport:
    """Statically prove every applicable invariant of ``plan`` (and its
    sub-plans) without executing a kernel.

    ``nvec`` is the widest SpMM batch the plan will serve (the same knob
    ``make_plan`` budgets with); ``budget_bytes`` overrides the
    whole-vector VMEM budget the cost rule proves against. Returns a
    :class:`VerifyReport`; call ``raise_if_failed()`` to turn violations
    into a :class:`PlanVerificationError`.
    """
    out: List[Violation] = []
    checked: List[str] = []
    _verify_into(plan, "plan", nvec, budget_bytes, out, checked)
    return VerifyReport(tuple(out), tuple(dict.fromkeys(checked)))


def _run(ctx: _Ctx, name: str) -> None:
    try:
        ran = _PLAN_RULES[name](ctx)
    except Exception as e:              # a rule must never crash the report
        ctx.fail(name, f"internal check error: {type(e).__name__}: {e}")
        ran = True
    if ran:
        ctx.checked.append(name)


def _verify_into(plan, path: str, nvec: int, budget: int,
                 out: List[Violation], checked: List[str]) -> None:
    ctx = _Ctx(plan=plan, path=path, out=out, checked=checked, nvec=nvec,
               budget=budget)
    _run(ctx, "layout-registered")
    if ctx.fired("layout-registered"):
        return                          # nothing else is interpretable
    _run(ctx, "geometry-schema")
    geometry_ok = not ctx.fired("geometry-schema")
    _run(ctx, "trace-schema")
    _run(ctx, "permutation")
    if geometry_ok:
        for name in _ARRAY_RULES:
            _run(ctx, name)
    for i, child in enumerate(plan.children):
        sub = f"{path}.multi" if i == 0 else f"{path}.children[{i}]"
        _verify_into(child, sub, nvec, budget, out, checked)


# ----------------------------------------------------------------------------
# Record-store verification (selector schema v5)
# ----------------------------------------------------------------------------

_KERNEL_RE = re.compile(r"^(\d+)x(\d+)(?:_test)?$")


def _backend_ok(backend) -> bool:
    """An empty backend (a record of an older file), "cpu" or
    "cuda:<card name>"."""
    return (backend in ("", "cpu")
            or (isinstance(backend, str) and backend.startswith("cuda:")
                and len(backend) > len("cuda:")))


def verify_records(store) -> VerifyReport:
    """Schema-v5 completeness of a selector record store (the port's or the
    reference's: a record without ``backend`` reads as "").

    Rule ``record-schema``: every record's kernel parses as ``rxc`` with a
    uint32-expressible mask, workers/gflops/avg sane and finite, layout,
    lowering and vdtype canonical, backend "", "cpu" or "cuda:<card
    name>". Rule ``store-load``: the loader dropped no lines
    (``RecordStore.skipped`` -- malformed JSONL lines are skipped with a
    count instead of poisoning the merge; a nonzero count is surfaced here).
    """
    out: List[Violation] = []
    for i, r in enumerate(store.records):
        path = f"records[{i}]"

        def bad(msg, path=path):
            out.append(Violation("record-schema", path, msg))

        m = _KERNEL_RE.match(r.kernel or "")
        if not m:
            bad(f"kernel {r.kernel!r} does not parse as 'rxc'")
        elif int(m.group(1)) * int(m.group(2)) > 32:
            bad(f"kernel {r.kernel!r}: r*c > 32 cannot mask a uint32")
        if r.workers < 1:
            bad(f"workers={r.workers} (measurements need >= 1)")
        for key in ("gflops", "avg"):
            v = getattr(r, key)
            if not math.isfinite(v) or v < 0:
                bad(f"{key}={v!r} is not a finite non-negative number")
        for key in ("pr", "xw", "cb", "nchunks"):
            if getattr(r, key) < 0:
                bad(f"{key}={getattr(r, key)} is negative")
        try:
            P.canonical_layout(r.layout)
        except ValueError as e:
            bad(str(e))
        try:
            P.canonical_lowering(r.lowering or "")
        except ValueError as e:
            bad(str(e))
        try:
            F.canonical_vdtype(r.vdtype or "")
        except ValueError as e:
            bad(str(e))
        backend = getattr(r, "backend", "")
        if not _backend_ok(backend):
            bad(f"backend {backend!r} is not '', 'cpu' or 'cuda:<card "
                f"name>'")
    skipped = int(getattr(store, "skipped", 0) or 0)
    if skipped:
        out.append(Violation(
            "store-load", "store",
            f"loader skipped {skipped} malformed record line(s)"))
    return VerifyReport(tuple(out), ("record-schema", "store-load"))
