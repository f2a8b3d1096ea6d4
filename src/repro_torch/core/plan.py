"""Execution plans: a layout registry, the plan passes and one executor.

The port's counterpart of ``repro.core.plan``, cut to the SpMV and SpMM
slices ported so far:

  * **Registry** (:class:`LayoutSpec`, :func:`register_layout`): the
    ``whole_vector``, ``panels`` and ``test`` layouts, each a ``build``, a
    ``lower_spmv`` and a ``lower_spmm`` entry plus the ``cost`` that "auto"
    resolution reads (``test`` is never picked by "auto"), and the
    lowerings it registers: ``mask`` (the bit mask decoded on every call)
    and ``descriptor`` (the decode expanded into gather tables at build
    time).
  * **Plan** (:class:`SPC5Plan`): a frozen dataclass holding the layout's
    tensors (all on one device), its sub-plans (the ``test`` split's
    multi-block plan), the geometry as ``meta`` and the pass ``trace``.
    Geometry keys and array names (per lowering) resolve as attributes.
  * **Passes** (:func:`make_plan`): tune -> reorder -> layout -> build, each
    appending a ``duration_s``-stamped entry to ``plan.trace`` with the
    reference's keys.
  * **Executors** (:func:`execute_spmv`, :func:`execute_spmm`): the only
    place that dispatches on the layout key.

Values are stored as f32, bf16 or int8 (the value-dtype axis, ``vdtype``;
int8 plans carry one f32 scale a chunk, ``value_scale``). Not ported yet
(each raises ``NotImplementedError``): reordering and the record-store
tuner (ROADMAP queue 1).
"""
from __future__ import annotations

import dataclasses
import difflib
import json
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.kernels import (spc5_spmm, spc5_spmm_desc, spc5_spmv,
                                 spc5_spmv_desc, spc5_spmv_tail)

from . import formats as F
from . import ref_spmv as R

LAYOUT_WHOLE = "whole_vector"
LAYOUT_PANELS = "panels"
LAYOUT_TEST = "test"
# How a layout's kernels consume the chunk metadata: "mask" decodes the bit
# masks on every call, "descriptor" reads per-lane gather tables expanded at
# build time (formats.chunk_descriptors), trading bytes for the decode.
LOWERING_MASK = "mask"
LOWERING_DESC = "descriptor"
_LOWERING_NAMES = (LOWERING_MASK, LOWERING_DESC)
_LOWERING_SENTINELS = ("auto", "")

#: Legacy spellings accepted by :func:`canonical_layout`.
_LAYOUT_ALIASES: Dict[str, str] = {"whole": LAYOUT_WHOLE}
_LAYOUT_SENTINELS = ("auto", "")

Device = R.Device


def _not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to repro_torch yet (ROADMAP queue 1, {item})")


def refuse_unported(reorder=None, store=None, verify=False) -> None:
    """The reference's ``reorder``, ``store`` and ``verify`` keywords: their
    defaults pass, any other value raises ``NotImplementedError`` naming
    its ROADMAP item (reordering 5, the record store 6, the verifier 7)."""
    if reorder is not None:
        raise _not_ported("reordering", "item 5")
    if store is not None:
        raise _not_ported("a record store (selector-driven block choice and "
                          "tuning)", "item 6")
    if verify:
        raise _not_ported("the static plan verifier", "item 7")


def canonical_lowering(name: str) -> str:
    """Validate a lowering name ("auto"/"" pass through, like layouts)."""
    if name in _LOWERING_SENTINELS or name in _LOWERING_NAMES:
        return name
    close = difflib.get_close_matches(str(name), _LOWERING_NAMES, n=1,
                                      cutoff=0.6)
    hint = f" -- did you mean {close[0]!r}?" if close else ""
    raise ValueError(f"unknown lowering {name!r}; expected one of "
                     f"{_LOWERING_NAMES} or 'auto'{hint}")


# ----------------------------------------------------------------------------
# Registry
# ----------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class LayoutSpec:
    """One device layout: ``array_names`` fixes the order of the plan's
    tensors, ``build(state)`` returns ``(arrays, geom)`` or ``(arrays, geom,
    extra)`` (``extra["children"]``: sub-plans), ``lower_spmv`` runs
    y = A @ x and ``lower_spmm`` Y = A @ X, ``cost(nrows, ncols, itemsize,
    nvec)`` is the footprint "auto" resolution compares with the budget;
    ``auto_eligible=False`` keeps a layout (the test split) out of "auto".
    ``lowerings`` lists the lowerings the layout registers ("mask" first,
    the tie-break winner of the cost arbitration); a descriptor plan's
    tensors are named by ``desc_array_names`` and viewed by
    ``desc_device_view``."""

    name: str
    array_names: Tuple[str, ...]
    build: Callable
    lower_spmv: Callable
    lower_spmm: Callable
    cost: Callable
    device_view: Optional[Callable] = None
    auto_eligible: bool = True
    lowerings: Tuple[str, ...] = (LOWERING_MASK,)
    desc_array_names: Optional[Tuple[str, ...]] = None
    desc_device_view: Optional[Callable] = None

    def plan_array_names(self, lowering: str,
                         vdtype: str = "f32") -> Tuple[str, ...]:
        """The tensor names of a plan of this layout under ``lowering`` and
        ``vdtype``: an int8 plan's per-chunk f32 ``value_scale`` trails the
        layout's arrays (only layouts with a packed ``values`` array
        quantise; the test layout's tail keeps its values)."""
        names = (self.desc_array_names
                 if lowering == LOWERING_DESC and self.desc_array_names
                 else self.array_names)
        if vdtype == "int8" and "values" in names:
            names = names + ("value_scale",)
        return names


_REGISTRY: Dict[str, LayoutSpec] = {}
_AUTO_ORDER: List[str] = []


def register_layout(spec: LayoutSpec) -> LayoutSpec:
    """Add a layout to the registry (idempotent by name, last wins)."""
    if spec.name in _LAYOUT_SENTINELS:
        raise ValueError(f"{spec.name!r} is reserved")
    if spec.name not in _REGISTRY and spec.auto_eligible:
        _AUTO_ORDER.append(spec.name)
    _REGISTRY[spec.name] = spec
    return spec


def layout_names() -> Tuple[str, ...]:
    return tuple(sorted(_REGISTRY))


def canonical_layout(name: str) -> str:
    if name in _LAYOUT_SENTINELS or name in _REGISTRY:
        return name
    if name in _LAYOUT_ALIASES:
        return _LAYOUT_ALIASES[name]
    raise ValueError(f"unknown layout {name!r}; expected one of "
                     f"{layout_names()} or 'auto'")


def get_layout(name: str) -> LayoutSpec:
    return _REGISTRY[canonical_layout(name)]


# The reference's whole-vector rule, kept as it is for now: x (ncols) and y
# (nrows) must fit a 2 MiB budget. That number is the TPU's VMEM budget
# (16 MiB VMEM with headroom for the decode), not anything measured on an
# H100, where x and y live in device memory and L2 either way; an H100 rule
# needs the port's own measurements (PERF.md, open questions). SpMM scales
# the footprint by its tile width, nvt = min(nvec, 128), as the reference's
# whole-vector SpMM kernel holds (ncols, nvt) and (nrows, nvt) tiles.
VMEM_WHOLE_VECTOR_BUDGET = 2 * 2**20


def _cost_whole(nrows: int, ncols: int, itemsize: int, nvec: int) -> int:
    return (nrows + ncols) * itemsize * min(max(nvec, 1), 128)


def _cost_panels(nrows: int, ncols: int, itemsize: int, nvec: int) -> int:
    return 0                            # bounded per CTA: always fits


def fits_whole_vector(nrows: int, ncols: int, itemsize: int = 4,
                      budget_bytes: int = VMEM_WHOLE_VECTOR_BUDGET,
                      nvec: int = 1) -> bool:
    """The reference's rule: whole-vector only when x and y, at the widest
    SpMM batch ``nvec`` the plan will see, fit the budget."""
    return _cost_whole(nrows, ncols, itemsize, nvec) <= budget_bytes


# The reference's closed-form lowering arbitration, kept with its constants
# so both packages choose the same lowering for the same request. They are
# the TPU's figures (v5e HBM bandwidth and a coarse decode throughput), not
# anything measured on an H100; an H100 rule waits for the port's sweep
# (ROADMAP queue 1, item 11). lowering_cost is the roofline max of bytes
# (formats.spmv_bytes_per_nnz, where the descriptor tables' r*c-fold index
# bytes enter) and decode operations per nonzero.
LOWERING_HBM_BW = 819e9      # bytes/s (TPU v5e)
LOWERING_DECODE_FLOPS = 2e11  # effective decode op throughput, ops/s (TPU)
_MASK_LANE_OPS = 8.0          # shift+and+cumsum+rank+3 idx ops+mask mul
_DESC_LANE_OPS = 2.0          # gather-index add + mask mul


def lowering_cost(r: int, c: int, avg: float, itemsize: int,
                  lowering: str) -> float:
    """Estimated seconds per nonzero of one SpMV pass under ``lowering``
    (the reference's model, on the TPU constants above)."""
    rc = r * c
    avg = max(avg, 1e-12)
    bytes_nnz = F.spmv_bytes_per_nnz(r, c, avg, lowering, s_float=itemsize)
    lane_ops = _DESC_LANE_OPS if lowering == LOWERING_DESC else _MASK_LANE_OPS
    flops_nnz = 2.0 + lane_ops * rc / avg
    return max(bytes_nnz / LOWERING_HBM_BW,
               flops_nnz / LOWERING_DECODE_FLOPS)


def _meta_lowering(meta) -> str:
    for k, v in meta:
        if k == "lowering":
            return v
    return LOWERING_MASK


def _meta_vdtype(meta) -> str:
    """The plan's resolved value dtype ("" = the legacy passthrough, f32
    here)."""
    for k, v in meta:
        if k == "vdtype":
            return v
    return ""


# ----------------------------------------------------------------------------
# The plan
# ----------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class SPC5Plan:
    """Layout key + the layout's tensors (one device) + geometry + the
    sub-plans (``children``) + trace."""

    layout: str
    arrays: Tuple[torch.Tensor, ...]
    meta: Tuple[Tuple[str, Any], ...]
    children: Tuple["SPC5Plan", ...] = ()
    trace_json: str = "[]"

    def __getattr__(self, name):
        meta = object.__getattribute__(self, "meta")
        for k, v in meta:
            if k == name:
                return v
        names = _REGISTRY[object.__getattribute__(self, "layout")] \
            .plan_array_names(_meta_lowering(meta), _meta_vdtype(meta))
        if name in names:
            return object.__getattribute__(self, "arrays")[names.index(name)]
        raise AttributeError(f"SPC5Plan ({self.layout!r}) has no attribute "
                             f"{name!r}")

    @property
    def shape(self) -> Tuple[int, int]:
        return (self.nrows, self.ncols)

    @property
    def device(self) -> torch.device:
        return self.arrays[0].device

    @property
    def dev(self):
        """The layout's tensor view for the plan's lowering
        (``SPC5Device`` / ``SPC5PanelDevice``, or their descriptor twins).
        An int8 plan's trailing ``value_scale`` is not part of the view, as
        in the reference: read it as ``plan.value_scale``."""
        spec = _REGISTRY[self.layout]
        lowering = _meta_lowering(self.meta)
        view = (spec.desc_device_view if lowering == LOWERING_DESC
                else spec.device_view)
        if view is None:
            raise AttributeError(f"layout {self.layout!r} has no dev view")
        return view(self.arrays[:len(spec.plan_array_names(lowering))])

    @property
    def multi(self) -> "SPC5Plan":
        """The test split's multi-nonzero-block sub-plan."""
        if not self.children:
            raise AttributeError(f"layout {self.layout!r} has no sub-plans")
        return self.children[0]

    @property
    def trace(self) -> List[dict]:
        return json.loads(self.trace_json)

    def apply(self, x: torch.Tensor, **kw) -> torch.Tensor:
        """y = A @ x: :func:`execute_spmv` for a 1-D x, :func:`execute_spmm`
        for a 2-D X, as in the reference."""
        return (execute_spmv if x.dim() == 1 else execute_spmm)(self, x, **kw)


# ----------------------------------------------------------------------------
# Pipeline state + passes
# ----------------------------------------------------------------------------

@dataclasses.dataclass
class PlanState:
    mat: F.SPC5Matrix
    device: torch.device
    layout: str = "auto"
    multi_layout: str = "auto"      # the test split's inner-layout request
    lowering: str = "auto"
    pr: Optional[int] = None
    xw: Optional[int] = None
    cb: Optional[int] = None
    nvec: int = 1
    align: int = 8
    vdtype: str = "auto"
    tune: bool = True
    dtype: Any = None
    trace: List[dict] = dataclasses.field(default_factory=list)

    @property
    def itemsize(self) -> int:
        """Bytes per stored value as the reference's "auto" rule counts
        them: the vdtype's (4, 2 or 1) where one is in effect, else the
        requested ``dtype`` or the matrix's own (8 for the generators'
        float64, though both packages store f32)."""
        if self.vdtype in F.VDTYPES:
            return F.value_itemsize(self.vdtype)
        return np.dtype(self.dtype or self.mat.values.dtype).itemsize


def _tune_pass(st: PlanState) -> None:
    """The port has no record store yet: the pass records why it did not
    consult one, with the reference's sources for that ("delegated": the
    test split's multi sub-plan runs its own passes)."""
    explicit = (st.layout != "auto" or st.pr is not None
                or st.xw is not None or st.cb is not None)
    source = ("delegated" if st.layout == LAYOUT_TEST else
              "disabled" if not st.tune else
              "explicit" if explicit else "no-store")
    st.trace.append({"pass": "tune", "source": source})


def _reorder_pass(st: PlanState) -> None:
    st.trace.append({"pass": "reorder", "strategy": "", "applied": False})


def _layout_pass(st: PlanState) -> None:
    entry: dict = {"pass": "layout"}
    if st.vdtype == "auto":
        st.vdtype = ""
    entry["vdtype"] = st.vdtype
    if st.layout == "auto":
        entry["reason"] = "vmem-fit"
        st.layout = next(name for name in _AUTO_ORDER
                         if _REGISTRY[name].cost(st.mat.nrows, st.mat.ncols,
                                                 st.itemsize, st.nvec)
                         <= VMEM_WHOLE_VECTOR_BUDGET)
    else:
        entry["reason"] = "requested"
    entry["layout"] = st.layout
    if st.layout == LAYOUT_TEST:
        # the multi sub-plan resolves its own lowering; the tail's arrays
        # do not depend on it
        entry["lowering"] = st.lowering
        entry["lowering_reason"] = "delegated"
        st.trace.append(entry)
        return
    # the lowering: a request the layout did not register is demoted to
    # "mask" (traced); "auto" is arbitrated by lowering_cost
    spec = _REGISTRY[st.layout]
    if (st.lowering not in _LOWERING_SENTINELS
            and st.lowering not in spec.lowerings):
        st.lowering = LOWERING_MASK
        entry["lowering_demoted"] = True
        entry["lowering_demoted_reason"] = "unregistered-lowering"
    if st.lowering in _LOWERING_SENTINELS:
        st.lowering = min(
            spec.lowerings,
            key=lambda n: lowering_cost(st.mat.r, st.mat.c,
                                        st.mat.avg_nnz_per_block,
                                        st.itemsize, n))
        entry["lowering_reason"] = "cost-model"
    entry["lowering"] = st.lowering
    st.trace.append(entry)


def _build_pass(st: PlanState) -> SPC5Plan:
    spec = _REGISTRY[st.layout]
    t0 = time.perf_counter()
    arrays, geom, *extra = spec.build(st)
    children = tuple(extra[0].get("children", ())) if extra else ()
    st.trace.append({"pass": "build", "layout": st.layout,
                     "duration_s": time.perf_counter() - t0,
                     "rows_fused": False,
                     **{k: v for k, v in sorted(geom.items())
                        if isinstance(v, (int, float, str, bool))}})
    return SPC5Plan(layout=st.layout, arrays=tuple(arrays),
                    meta=tuple(sorted(geom.items())), children=children,
                    trace_json=json.dumps(st.trace, sort_keys=True))


def make_plan(mat: F.SPC5Matrix, *, device: Device, layout: str = "auto",
              lowering: str = "auto", pr: Optional[int] = None,
              xw: Optional[int] = None, cb: Optional[int] = None,
              nvec: int = 1, align: int = 8, dtype=None,
              vdtype: str = "auto", tune: bool = True,
              multi_layout: str = "auto", store=None, reorder=None,
              verify=False) -> SPC5Plan:
    """The plan pipeline: tune -> reorder -> layout -> build.

    ``nvec`` is the widest SpMM batch the plan will see; "auto" layout
    budgets x and y at that width, as the reference does. ``lowering`` is
    "mask", "descriptor" or "auto" (the reference's :func:`lowering_cost`
    arbitration). ``multi_layout`` is the test split's request for its
    multi sub-plan's layout (read only with ``layout="test"``).

    ``vdtype`` is the value-dtype axis, as in the reference: "f32", "bf16"
    or "int8" stores the values in that dtype (int8 with one f32 scale a
    chunk, ``plan.value_scale``), and every product still accumulates and
    returns f32; "auto" (no record store here) and "" keep float32, which
    is what the reference holds for the generators' float64 values too.
    The vdtype's width sizes "auto"'s budget and the lowering's cost.
    ``dtype`` may only be None or float32, and not together with a
    ``vdtype`` other than "auto" (the reference's ``ValueError``: the
    value-dtype axis owns the cast).
    ``store``, ``reorder`` and ``verify`` take the reference's defaults
    (None, None, False); any other value raises ``NotImplementedError``
    (:func:`refuse_unported`)."""
    refuse_unported(reorder, store, verify)
    vdtype = F.canonical_vdtype(vdtype)
    if vdtype not in ("", "auto") and dtype is not None:
        raise ValueError(
            f"pass either dtype= (legacy passthrough) or vdtype={vdtype!r}, "
            f"not both -- the value-dtype axis owns the cast")
    if dtype is not None and not _is_f32(dtype):
        raise _not_ported(f"dtype={dtype!r}", "item 5")
    st = PlanState(mat=mat, device=torch.device(device),
                   layout=canonical_layout(layout),
                   multi_layout=canonical_layout(multi_layout),
                   lowering=canonical_lowering(lowering), pr=pr,
                   xw=xw, cb=cb, nvec=nvec, align=align, vdtype=vdtype,
                   tune=tune, dtype=None if dtype is None else np.float32)
    for pass_fn in (_tune_pass, _reorder_pass, _layout_pass):
        t0 = time.perf_counter()
        pass_fn(st)
        st.trace[-1]["duration_s"] = time.perf_counter() - t0
    return _build_pass(st)


def _is_f32(dtype) -> bool:
    if isinstance(dtype, torch.dtype):
        return dtype == torch.float32
    return np.dtype(dtype) == np.float32


# ----------------------------------------------------------------------------
# Executor (the ONLY layout dispatch)
# ----------------------------------------------------------------------------

def execute_spmv(plan: SPC5Plan, x: torch.Tensor, *,
                 double_buffer: bool = True) -> torch.Tensor:
    """y = A @ x through the plan's registered lowering, on the plan's
    device: the CUDA kernels for a plan on the card, the plain PyTorch
    version for a plan on the CPU. ``x`` must be float32 on that device."""
    _check_device(plan, x)
    return _REGISTRY[plan.layout].lower_spmv(plan, x,
                                             double_buffer=double_buffer)


def execute_spmm(plan: SPC5Plan, x: torch.Tensor, *, nvt: int = 128,
                 double_buffer: bool = True) -> torch.Tensor:
    """Y = A @ X, X of shape (ncols, nvec) float32 on the plan's device,
    through the plan's registered lowering (the CUDA kernels on the card,
    the plain PyTorch version on the CPU). ``nvt`` is the reference's
    column tile: nvec must be a multiple of min(nvt, nvec)."""
    _check_device(plan, x)
    return _REGISTRY[plan.layout].lower_spmm(plan, x, nvt=nvt,
                                             double_buffer=double_buffer)


def _check_device(plan: SPC5Plan, x) -> None:
    if not isinstance(x, torch.Tensor) or x.device != plan.device:
        raise ValueError(f"x must be a tensor on the plan's device "
                         f"{plan.device}")


def _reordered(col_perm, row_iperm, rows_fused) -> bool:
    return col_perm is not None or row_iperm is not None or bool(rows_fused)


def plan_parts(plan):
    """(layout, arrays, meta, children) of another package's plan, read by
    attribute (``layout``, ``arrays``, ``meta``, ``children``), with no
    import of that package. A plan that a reorder pass permuted
    (``is_reordered``, or any of ``col_perm``, ``row_iperm``,
    ``rows_fused`` set) raises ``NotImplementedError``: its permutation
    lives outside its arrays and meta, and the port cannot apply it yet
    (ROADMAP queue 1, item 5)."""
    if getattr(plan, "is_reordered", False) or _reordered(
            getattr(plan, "col_perm", None), getattr(plan, "row_iperm", None),
            getattr(plan, "rows_fused", False)):
        raise _not_ported("a reordered plan (col_perm / row_iperm / "
                          "rows_fused)", "item 5")
    return (plan.layout, plan.arrays, plan.meta,
            tuple(getattr(plan, "children", ())))


def plan_from_arrays(layout, arrays=None, meta=None, *, device: Device,
                     children=(), col_perm=None, row_iperm=None,
                     rows_fused: bool = False) -> SPC5Plan:
    """A port plan from another plan's host arrays and geometry.

    ``arrays`` are the layout's arrays in registry order for the lowering
    ``meta`` names (each anything ``np.asarray`` takes, e.g. a JAX plan's
    device arrays; descriptor tables keep their narrow dtypes) and ``meta``
    its ``(key, value)`` geometry, so the port computes with exactly the
    bytes the other package built. A test plan also takes its multi
    sub-plan as ``children=[(layout, arrays, meta)]`` (e.g. a JAX plan's
    ``handle.multi.layout``, ``.arrays`` and ``.meta``) or as that plan
    whole.

    A quantised plan's values come as built: int8, or bf16 (the reference's
    ``ml_dtypes.bfloat16``, or the port's ``uint16`` bit patterns), and an
    int8 plan's ``value_scale`` trails its arrays.

    ``layout`` may instead be the other package's plan whole (a JAX
    ``SPC5Plan``, read by attribute: :func:`plan_parts`), with ``arrays``
    and ``meta`` left out; its children are read the same way. Arrays and
    meta alone cannot show a reordering, so a reordered plan must come
    whole or with its ``col_perm``, ``row_iperm`` and ``rows_fused``: a
    plan with any of them set, or whose ``is_reordered`` is true, raises
    ``NotImplementedError`` (ROADMAP queue 1, item 5) rather than compute
    another product."""
    if _reordered(col_perm, row_iperm, rows_fused):
        raise _not_ported("a reordered plan (col_perm / row_iperm / "
                          "rows_fused)", "item 5")
    if not isinstance(layout, str):
        if arrays is not None or meta is not None or children:
            raise ValueError("pass a plan whole, or its layout, arrays and "
                             "meta, not both")
        layout, arrays, meta, children = plan_parts(layout)
    elif arrays is None or meta is None:
        raise ValueError("plan_from_arrays needs arrays and meta with a "
                         "layout name")
    spec = get_layout(layout)
    children = tuple(plan_from_arrays(*child, device=device)
                     if isinstance(child, (tuple, list))
                     else plan_from_arrays(child, device=device)
                     for child in children)
    want = 1 if spec.name == LAYOUT_TEST else 0
    if len(children) != want:
        raise ValueError(f"layout {spec.name!r} takes {want} sub-plans, got "
                         f"{len(children)}")
    meta = tuple(sorted((str(k), v) for k, v in meta))
    m = dict(meta)
    lowering = m.get("lowering", LOWERING_MASK)
    if lowering not in spec.lowerings:
        raise ValueError(f"layout {spec.name!r} has no lowering "
                         f"{lowering!r}")
    arrays = [np.asarray(a) for a in arrays]
    names = spec.plan_array_names(lowering, m.get("vdtype", ""))
    if len(arrays) != len(names):
        raise ValueError(f"layout {spec.name!r} ({lowering}) has arrays "
                         f"{names}, got {len(arrays)}")
    return SPC5Plan(layout=spec.name,
                    arrays=tuple(R.to_tensor(a, device) for a in arrays),
                    meta=meta, children=children)


def _value_store(values: np.ndarray, chunk_vbase: np.ndarray,
                 chunk_mask: np.ndarray, st: PlanState):
    """The resolved value-dtype axis applied to a build's packed values:
    the values as they are where no vdtype is in effect (float32 on the
    device, :func:`repro_torch.core.ref_spmv.to_tensor`), else the formats
    store (bf16 bits, or int8 with per-chunk f32 scales over each chunk's
    own nonzeros). Returns ``(values, scales_or_None)``."""
    if not st.vdtype:
        return values, None
    return F.quantize_chunk_values(values, chunk_vbase, chunk_mask,
                                   st.vdtype)


def _plan_scale(plan: SPC5Plan):
    """The per-chunk dequantisation scales of an int8 plan (None otherwise),
    which every lowering passes to its kernel or plain version."""
    if _meta_vdtype(plan.meta) == "int8":
        return plan.value_scale
    return None


def _with_scale(arrays, scales, device):
    arrays = tuple(arrays)
    if scales is None:
        return arrays
    return arrays + (R.to_tensor(scales, device),)


# ----------------------------------------------------------------------------
# whole_vector layout
# ----------------------------------------------------------------------------

def _build_whole(st: PlanState):
    ch = F.to_chunked(st.mat, cb=256 if st.cb is None else st.cb,
                      align=st.align)
    geom = dict(r=ch.r, c=ch.c, cb=ch.cb, vmax=ch.vmax, nrows=ch.nrows,
                ncols=ch.ncols, nnz=ch.nnz, nblocks=int(st.mat.nblocks),
                lowering=st.lowering, vdtype=st.vdtype)
    values, scales = _value_store(ch.values, ch.chunk_vbase, ch.chunk_mask,
                                  st)
    if st.lowering == LOWERING_DESC:
        desc = F.chunk_descriptors(ch.chunk_mask, ch.chunk_voff,
                                   ch.chunk_col, ch.chunk_row, r=ch.r,
                                   c=ch.c, vmax=ch.vmax, xmax=ch.ncols,
                                   ymax=ch.nrows)
        geom["desc_lane_nbytes"] = desc.lane_nbytes
        return _with_scale(R.device_put_desc(values, desc, ch.chunk_vbase,
                                             st.device), scales,
                           st.device), geom
    ch = dataclasses.replace(ch, values=values)
    return _with_scale(R.device_put(ch, st.device), scales, st.device), geom


def _lower_spmv_whole(plan: SPC5Plan, x, *, double_buffer):
    scale = _plan_scale(plan)
    if plan.lowering == LOWERING_DESC:
        fn = (spc5_spmv_desc.spmv_cuda_desc_db if double_buffer
              else spc5_spmv_desc.spmv_cuda_desc)
        return fn(plan.chunk_vbase, plan.desc_valid, plan.desc_vidx,
                  plan.desc_xcol, plan.desc_yrow, plan.values, x, scale,
                  r=plan.r, c=plan.c, cb=plan.cb, vmax=plan.vmax,
                  nrows=plan.nrows, ncols=plan.ncols)
    fn = spc5_spmv.spmv_cuda_db if double_buffer else spc5_spmv.spmv_cuda
    return fn(plan.chunk_vbase, plan.chunk_col, plan.chunk_mask,
              plan.chunk_voff, plan.chunk_row, plan.values, x, None, scale,
              r=plan.r, c=plan.c, cb=plan.cb, vmax=plan.vmax,
              nrows=plan.nrows, ncols=plan.ncols)


def _lower_spmm_whole(plan: SPC5Plan, x, *, nvt, double_buffer):
    # the reference has one whole-vector SpMM kernel per lowering: no
    # double buffer
    scale = _plan_scale(plan)
    if plan.lowering == LOWERING_DESC:
        return spc5_spmm_desc.spmm_cuda_desc(
            plan.chunk_vbase, plan.desc_valid, plan.desc_vidx, plan.desc_xcol,
            plan.desc_yrow, plan.values, x, scale, r=plan.r, c=plan.c,
            cb=plan.cb, vmax=plan.vmax, nrows=plan.nrows, ncols=plan.ncols,
            nvt=nvt)
    return spc5_spmm.spmm_cuda(
        plan.chunk_vbase, plan.chunk_col, plan.chunk_mask, plan.chunk_voff,
        plan.chunk_row, plan.values, x, None, scale, r=plan.r, c=plan.c,
        cb=plan.cb, vmax=plan.vmax, nrows=plan.nrows, ncols=plan.ncols,
        nvt=nvt)


register_layout(LayoutSpec(
    name=LAYOUT_WHOLE,
    array_names=R.SPC5Device._fields,
    build=_build_whole,
    lower_spmv=_lower_spmv_whole,
    lower_spmm=_lower_spmm_whole,
    cost=_cost_whole,
    device_view=lambda arrays: R.SPC5Device(*arrays),
    lowerings=_LOWERING_NAMES,
    desc_array_names=R.SPC5DescDevice._fields,
    desc_device_view=lambda arrays: R.SPC5DescDevice(*arrays),
))


# ----------------------------------------------------------------------------
# panels layout
# ----------------------------------------------------------------------------

def _build_panels(st: PlanState):
    pan = F.to_panels(st.mat, pr=512 if st.pr is None else st.pr,
                      cb=64 if st.cb is None else st.cb,
                      xw=512 if st.xw is None else st.xw, align=st.align)
    geom = dict(r=pan.r, c=pan.c, pr=pan.pr, cb=pan.cb, xw=pan.xw,
                vmax=pan.vmax, npanels=pan.npanels, nchunks=pan.nchunks,
                nrows=pan.nrows, ncols=pan.ncols, ncols_pad=pan.ncols_pad,
                nnz=pan.nnz, nblocks=int(st.mat.nblocks),
                lowering=st.lowering, vdtype=st.vdtype)
    values, scales = _value_store(pan.values, pan.chunk_vbase,
                                  pan.chunk_mask, st)
    if st.lowering == LOWERING_DESC:
        # window-relative xcol and panel-relative yrow tables
        desc = F.chunk_descriptors(pan.chunk_mask, pan.chunk_voff,
                                   pan.chunk_col, pan.chunk_row, r=pan.r,
                                   c=pan.c, vmax=pan.vmax, xmax=pan.xw,
                                   ymax=pan.pr)
        geom["desc_lane_nbytes"] = desc.lane_nbytes
        return _with_scale(R.device_put_desc(values, desc, pan.chunk_vbase,
                                             st.device, pan.chunk_xbase),
                           scales, st.device), geom
    pan = dataclasses.replace(pan, values=values)
    return _with_scale(R.device_put_panels(pan, st.device), scales,
                       st.device), geom


def _lower_spmv_panels(plan: SPC5Plan, x, *, double_buffer):
    scale = _plan_scale(plan)
    if plan.lowering == LOWERING_DESC:
        fn = (spc5_spmv_desc.spmv_cuda_panels_desc_db if double_buffer
              else spc5_spmv_desc.spmv_cuda_panels_desc)
        return fn(plan.chunk_vbase, plan.chunk_xbase, plan.desc_valid,
                  plan.desc_vidx, plan.desc_xcol, plan.desc_yrow,
                  plan.values, x, None, scale, r=plan.r, c=plan.c,
                  cb=plan.cb, vmax=plan.vmax, xw=plan.xw, pr=plan.pr,
                  nrows=plan.nrows, ncols_pad=plan.ncols_pad)
    fn = (spc5_spmv.spmv_cuda_panels_db if double_buffer
          else spc5_spmv.spmv_cuda_panels)
    return fn(plan.chunk_vbase, plan.chunk_xbase, plan.chunk_col,
              plan.chunk_mask, plan.chunk_voff, plan.chunk_row, plan.values,
              x, None, scale, r=plan.r, c=plan.c, cb=plan.cb, vmax=plan.vmax,
              xw=plan.xw, pr=plan.pr, nrows=plan.nrows,
              ncols_pad=plan.ncols_pad)


def _lower_spmm_panels(plan: SPC5Plan, x, *, nvt, double_buffer):
    scale = _plan_scale(plan)
    if plan.lowering == LOWERING_DESC:
        fn = (spc5_spmm_desc.spmm_cuda_panels_desc_db if double_buffer
              else spc5_spmm_desc.spmm_cuda_panels_desc)
        return fn(plan.chunk_vbase, plan.chunk_xbase, plan.desc_valid,
                  plan.desc_vidx, plan.desc_xcol, plan.desc_yrow,
                  plan.values, x, None, scale, r=plan.r, c=plan.c,
                  cb=plan.cb, vmax=plan.vmax, xw=plan.xw, pr=plan.pr,
                  nrows=plan.nrows, ncols_pad=plan.ncols_pad, nvt=nvt)
    fn = (spc5_spmm.spmm_cuda_panels_db if double_buffer
          else spc5_spmm.spmm_cuda_panels)
    return fn(plan.chunk_vbase, plan.chunk_xbase, plan.chunk_col,
              plan.chunk_mask, plan.chunk_voff, plan.chunk_row, plan.values,
              x, None, scale, r=plan.r, c=plan.c, cb=plan.cb, vmax=plan.vmax,
              xw=plan.xw, pr=plan.pr, nrows=plan.nrows,
              ncols_pad=plan.ncols_pad, nvt=nvt)


register_layout(LayoutSpec(
    name=LAYOUT_PANELS,
    array_names=R.SPC5PanelDevice._fields,
    build=_build_panels,
    lower_spmv=_lower_spmv_panels,
    lower_spmm=_lower_spmm_panels,
    cost=_cost_panels,
    device_view=lambda arrays: R.SPC5PanelDevice(*arrays),
    lowerings=_LOWERING_NAMES,
    desc_array_names=R.SPC5PanelDescDevice._fields,
    desc_device_view=lambda arrays: R.SPC5PanelDescDevice(*arrays),
))


# ----------------------------------------------------------------------------
# test layout: beta(r,c)_test split (multi-block sub-plan + COO tail)
# ----------------------------------------------------------------------------

_TEST_ARRAYS = ("single_rows", "single_cols", "single_values", "tail_xbase")


def _bucket_tail_by_panel(rows: np.ndarray, cols: np.ndarray,
                          vals: np.ndarray, pr: int, npanels: int,
                          align: int = 8):
    """Sort the singleton COO tail into per-panel buckets padded to the
    largest panel's count (zero values at local row 0 and column 0), plus
    one aligned x window per panel covering its bucket's column span, of
    one width for every panel. The reference's builder, line for line
    (byte-equal buckets); the tail must not be empty."""
    n = rows.shape[0]
    panel = rows.astype(np.int64) // pr
    order = np.lexsort((cols, rows, panel))
    counts = np.bincount(panel, minlength=npanels).astype(np.int64)
    smax = int(counts.max())
    brows = np.zeros((npanels, smax), dtype=np.int32)
    bcols = np.zeros((npanels, smax), dtype=np.int32)
    bvals = np.zeros((npanels, smax), dtype=vals.dtype)
    cum = np.concatenate([[0], np.cumsum(counts)[:-1]])
    slot = np.arange(n, dtype=np.int64) - np.repeat(cum, counts)
    p_sorted = panel[order]
    brows[p_sorted, slot] = (rows[order].astype(np.int64) % pr).astype(np.int32)
    bcols[p_sorted, slot] = cols[order]
    bvals[p_sorted, slot] = vals[order]
    cmin = np.full(npanels, np.iinfo(np.int64).max, dtype=np.int64)
    cmax = np.zeros(npanels, dtype=np.int64)
    np.minimum.at(cmin, panel, cols.astype(np.int64))
    np.maximum.at(cmax, panel, cols.astype(np.int64))
    cmin[counts == 0] = 0
    cmax[counts == 0] = 0
    xbase = (cmin // align) * align
    span = int((cmax - xbase + 1).max())
    tail_xw = max(align, -(-span // align) * align)
    ncols_pad = int(xbase.max()) + tail_xw
    return brows, bcols, bvals, xbase.astype(np.int32), tail_xw, ncols_pad


def _build_test(st: PlanState):
    """The split, the multi sub-plan through this pipeline (its own passes,
    no reordering) and the tail: bucketed by the sub-plan's panels when it
    is a panel plan, else flat (zero-length arrays: no singletons). As in
    the reference, a bf16 tail stores bf16 (the tail paths upcast before
    any multiply) and an int8 tail keeps f32 values: the tail has no chunks
    to hang scales off, and its bytes are few."""
    split = F.split_singletons(st.mat)
    if st.vdtype == "bf16":
        dt = F.value_dtype("bf16")
    elif st.vdtype == "int8":
        dt = np.float32
    else:
        dt = st.dtype or st.mat.values.dtype

    def store(vals):
        return F.bf16_bits(vals) if dt == F.BF16_HOST else vals.astype(dt)
    multi = make_plan(split.multi, device=st.device, layout=st.multi_layout,
                      pr=st.pr, xw=st.xw, cb=st.cb, nvec=st.nvec,
                      align=st.align, dtype=st.dtype,
                      vdtype=st.vdtype or "auto", tune=st.tune,
                      lowering=st.lowering)
    n_single = int(split.single_values.shape[0])
    if multi.layout == LAYOUT_PANELS and n_single:
        brows, bcols, bvals, xbase, tail_xw, tail_pad = \
            _bucket_tail_by_panel(split.single_rows, split.single_cols,
                                  store(split.single_values), multi.pr,
                                  multi.npanels, align=st.align)
        arrays = (brows, bcols, bvals, xbase)
        tail_pr = multi.pr
    else:
        arrays = (split.single_rows, split.single_cols,
                  store(split.single_values), np.zeros((0,), np.int32))
        tail_pr, tail_xw, tail_pad = 0, 0, 0
    geom = dict(nrows=st.mat.nrows, ncols=st.mat.ncols, nnz=st.mat.nnz,
                tail_pr=tail_pr, tail_xw=tail_xw, tail_ncols_pad=tail_pad,
                n_single=n_single, lowering=multi.lowering,
                vdtype=multi.vdtype)
    return (tuple(R.to_tensor(a, st.device) for a in arrays), geom,
            {"children": (multi,)})


def _tail_spmv(plan: SPC5Plan, x):
    """The singleton tail's y: the CUDA tail kernel (or, for a plan on the
    CPU, its plain version) for panel buckets; for a flat tail the plain
    ``spmv_coo`` on any device, as the reference computes it outside any
    kernel."""
    rows, cols, vals, xbase = plan.arrays
    if plan.tail_pr:
        return spc5_spmv_tail.spmv_tail_cuda(
            xbase, rows, cols, vals, x, pr=plan.tail_pr, xw=plan.tail_xw,
            nrows=plan.nrows, ncols_pad=plan.tail_ncols_pad)
    return R.spmv_coo(rows, cols, vals, x, nrows=plan.nrows)


def _lower_spmv_test(plan: SPC5Plan, x, *, double_buffer):
    y = execute_spmv(plan.multi, x, double_buffer=double_buffer)
    if plan.single_values.numel():
        y = y + _tail_spmv(plan, x)
    return y


def _lower_spmm_test(plan: SPC5Plan, x, *, nvt, double_buffer):
    """The multi sub-plan's SpMM plus the tail's: the CUDA tail kernel (or,
    for a plan on the CPU, its plain version ``spmm_coo_panels``) for panel
    buckets; for a flat tail the plain ``spmm_coo`` on any device, as the
    reference computes it outside any kernel."""
    y = execute_spmm(plan.multi, x, nvt=nvt, double_buffer=double_buffer)
    if plan.single_values.numel():
        rows, cols, vals = (plan.single_rows, plan.single_cols,
                            plan.single_values)
        if plan.tail_pr:
            tail = spc5_spmv_tail.spmm_tail_cuda(
                rows, cols, vals, x, pr=plan.tail_pr, nrows=plan.nrows,
                nvt=nvt)
        else:
            tail = R.spmm_coo(rows, cols, vals, x, nrows=plan.nrows)
        y = y + tail
    return y


register_layout(LayoutSpec(
    name=LAYOUT_TEST,
    array_names=_TEST_ARRAYS,
    build=_build_test,
    lower_spmv=_lower_spmv_test,
    lower_spmm=_lower_spmm_test,
    cost=lambda nrows, ncols, itemsize, nvec: 0,
    auto_eligible=False,
    # the lowering is the multi sub-plan's; the tail's arrays do not
    # depend on it
    lowerings=_LOWERING_NAMES,
))
