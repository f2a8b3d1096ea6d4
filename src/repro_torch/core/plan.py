"""Execution plans: a layout registry, the plan passes and one executor.

The port's counterpart of ``repro.core.plan``:

  * **Registry** (:class:`LayoutSpec`, :func:`register_layout`): the
    ``whole_vector``, ``panels`` and ``test`` layouts, each a ``build``, a
    ``lower_spmv`` and a ``lower_spmm`` entry plus the ``cost`` that "auto"
    resolution reads (``test`` is never picked by "auto"), and the
    lowerings it registers: ``mask`` (the bit mask decoded on every call)
    and ``descriptor`` (the decode expanded into gather tables at build
    time).
  * **Plan** (:class:`SPC5Plan`): a frozen dataclass holding the layout's
    tensors (all on one device), its sub-plans (the ``test`` split's
    multi-block plan), the permutations a reorder pass left on it
    (``col_perm``, ``row_iperm``, ``rows_fused``), the geometry as ``meta``
    and the pass ``trace``. Geometry keys and array names (per lowering)
    resolve as attributes.
  * **Passes** (:func:`make_plan`): tune -> reorder -> layout -> build, each
    under an ``obs`` span (``plan.tune`` ... ``plan.build``) and appending
    a ``duration_s``-stamped entry to ``plan.trace`` with the reference's
    keys; the build checks the fault point ``plan.build`` and the
    executors ``exec.spmv`` / ``exec.spmm`` (:mod:`repro_torch.obs.faults`,
    no-ops unless armed). The tune pass consults a record store
    (:mod:`repro_torch.core.selector`) for the records of the plan's
    device only; the reorder pass (:mod:`repro_torch.core.reorder`)
    permutes the matrix before the layout is built; the builds fold what
    they can of the permutations into their index arrays. ``verify=``
    proves the finished plan (:mod:`repro_torch.analysis.verify`).
  * **Executors** (:func:`execute_spmv`, :func:`execute_spmm`): with the
    shard pass's :func:`local_execute_spmv`, the only places that dispatch
    on the layout key. x and y are in the original
    order: a lowering gathers x by ``col_perm`` (or passes it to the kernel
    as its column map) and the executor gathers y by ``row_iperm``.
  * **Cache substrate** (:func:`matrix_fingerprint`, :func:`plan_cache_key`,
    :func:`append_trace_entries`, :func:`plan_nbytes`): the reference's
    digests, digit for digit, and its footprint figure.
  * **Shard pass** (:func:`shard_plan`, :class:`ShardedPlan`,
    :func:`local_execute_spmv`): the matrix tuned at ``workers=ndev``,
    reordered and cut into row slabs, each slab built by its layout's
    ``shard_build`` hook and stacked, byte for byte the reference's stacks;
    one shard's SpMV is the sharded twin of :func:`execute_spmv`
    (:mod:`repro_torch.core.distributed` runs it over a process group).

Values are stored as f32, bf16 or int8 (the value-dtype axis, ``vdtype``;
int8 plans carry one f32 scale a chunk, ``value_scale``).
"""
from __future__ import annotations

import dataclasses
import difflib
import hashlib
import json
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import obs
from repro_torch.kernels import (spc5_spmm, spc5_spmm_desc, spc5_spmv,
                                 spc5_spmv_desc, spc5_spmv_tail)

from . import formats as F
from . import ref_spmv as R
from . import reorder as RE
from . import selector as S

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
    ``desc_device_view``. ``plain_spmv`` / ``plain_spmm`` compute the same
    products with the plain PyTorch versions on the plan's device (the
    executors' ``use_pallas=False``).

    ``shard_build`` / ``local_spmv`` are the distributed hooks, as in the
    reference: stack the row slabs of a :class:`ShardState` into host
    arrays with a leading shard axis, and run one shard's SpMV on its slice
    of them; ``shard_build_desc`` / ``local_spmv_desc`` are the descriptor
    lowering's twins (:attr:`shard_lowerings`)."""

    name: str
    array_names: Tuple[str, ...]
    build: Callable
    lower_spmv: Callable
    lower_spmm: Callable
    cost: Callable
    plain_spmv: Callable
    plain_spmm: Callable
    device_view: Optional[Callable] = None
    shard_build: Optional[Callable] = None
    local_spmv: Optional[Callable] = None
    shard_build_desc: Optional[Callable] = None
    local_spmv_desc: Optional[Callable] = None
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

    @property
    def shard_lowerings(self) -> Tuple[str, ...]:
        """The lowerings a sharded plan of this layout can take: those with
        both a stacking and a local SpMV hook."""
        out = []
        if self.shard_build is not None and self.local_spmv is not None:
            out.append(LOWERING_MASK)
        if (self.shard_build_desc is not None
                and self.local_spmv_desc is not None):
            out.append(LOWERING_DESC)
        return tuple(out)


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


def _resolve_attr(obj, name):
    """Attribute resolution of both plan classes: a geometry key of
    ``meta`` first, then one of the layout's tensors by its name under the
    plan's lowering and value dtype."""
    meta = object.__getattribute__(obj, "meta")
    for k, v in meta:
        if k == name:
            return v
    layout = object.__getattribute__(obj, "layout")
    names = _REGISTRY[layout].plan_array_names(_meta_lowering(meta),
                                               _meta_vdtype(meta))
    if name in names:
        return object.__getattribute__(obj, "arrays")[names.index(name)]
    raise AttributeError(f"{type(obj).__name__} ({layout!r}) has no "
                         f"attribute {name!r}")


# ----------------------------------------------------------------------------
# The plan
# ----------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class SPC5Plan:
    """Layout key + the layout's tensors (one device) + geometry + the
    sub-plans (``children``) + the permutations of a reordered plan + trace.

    ``col_perm`` (int32, (ncols,)) is the column permutation the lowering
    gathers x by, None where there is none or the build folded it into its
    tables; ``row_iperm`` (int32, (nrows,)) the inverse row permutation the
    executor gathers y by, None where there is none or the build folded it
    into its scatter indices (``rows_fused``)."""

    layout: str
    arrays: Tuple[torch.Tensor, ...]
    meta: Tuple[Tuple[str, Any], ...]
    children: Tuple["SPC5Plan", ...] = ()
    col_perm: Optional[torch.Tensor] = None
    row_iperm: Optional[torch.Tensor] = None
    rows_fused: bool = False
    trace_json: str = "[]"

    def __getattr__(self, name):
        return _resolve_attr(self, name)

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

    @property
    def is_reordered(self) -> bool:
        """True where a reorder pass permuted this plan."""
        return (self.col_perm is not None or self.row_iperm is not None
                or self.rows_fused)

    @property
    def strategy(self) -> str:
        """The reorder strategy applied ("" where none was)."""
        for e in self.trace:
            if e.get("pass") == "reorder" and e.get("applied"):
                return e.get("strategy", "")
        return ""

    @property
    def stats(self) -> dict:
        """The reorder pass's scalar evidence ({} without one)."""
        for e in self.trace:
            if e.get("pass") == "reorder" and "stats" in e:
                return e["stats"]
        return {}

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
    store: Optional[S.RecordStore] = None
    reorder: Any = None             # strategy name or Reordering (request)
    reo: Optional[RE.Reordering] = None     # the applied reordering
    rows_fusible: bool = False
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
    """Selector consult, as in the reference: fill (layout, pr, xw, cb,
    lowering, vdtype, reorder) from a record store when the caller requested
    nothing explicit ("delegated": the test split's multi sub-plan runs its
    own passes). Only the records of the plan's device
    (:func:`~repro_torch.core.selector.backend_of`) are consulted: a store
    without one is "no-store", so records of another device, the
    reference's among them, never tune a port plan."""
    entry: dict = {"pass": "tune"}
    explicit = (st.layout != "auto" or st.pr is not None
                or st.xw is not None or st.cb is not None)
    if st.layout == LAYOUT_TEST:
        entry["source"] = "delegated"
    elif not st.tune:
        entry["source"] = "disabled"
    elif explicit:
        entry["source"] = "explicit"
    else:
        tstore = st.store if st.store is not None else S.get_default_store()
        backend = S.backend_of(st.device)
        if S.has_backend(tstore, backend):
            _apply_store(st, tstore, backend, entry)
        else:
            entry["source"] = "no-store"
    st.trace.append(entry)


def _apply_store(st: PlanState, store: S.RecordStore, backend: str,
                 entry: dict) -> None:
    """The tune pass's store branch (the reference's, with ``backend``):
    the tuned config, clamped to the matrix, fills every axis the caller
    left at its default, and ``entry`` records it."""
    mat = st.mat
    tuned = S.tune(S.spc5_features(mat), store=store,
                   kernel=f"{mat.r}x{mat.c}", backend=backend)
    cfg = S.clamp_config(tuned, nrows=mat.nrows, ncols=mat.ncols, r=mat.r,
                         c=mat.c, nblocks=mat.nblocks, align=st.align)
    # clamp_config demotes a lowering the layout did not register to
    # "mask"; the demotion is traced
    lowering_demoted = tuned.lowering != cfg.lowering
    demoted = False
    if (cfg.layout == LAYOUT_WHOLE
            and not fits_whole_vector(*mat.shape, st.itemsize,
                                      nvec=st.nvec)):
        # the reference's TPU budget (kept for parity): a tuned whole-vector
        # pick past it becomes panels at the panel layout's own defaults,
        # not the whole layout's cb
        cfg = S.PanelConfig(layout=LAYOUT_PANELS)
        demoted = True
    st.layout = cfg.layout
    st.pr = cfg.pr or None
    st.xw = cfg.xw or None
    st.cb = cfg.cb
    if st.lowering == "auto" and cfg.lowering:
        st.lowering = cfg.lowering
    # only a quantised pick flips the value-dtype axis: a tuned "f32"
    # leaves the plan byte-equal to an untuned one
    if st.vdtype == "auto" and cfg.vdtype in ("bf16", "int8"):
        st.vdtype = cfg.vdtype
    if st.reorder is None and cfg.reorder:
        st.reorder = cfg.reorder
    entry.update(source="store", layout=cfg.layout, pr=int(cfg.pr or 0),
                 xw=int(cfg.xw or 0), cb=int(cfg.cb or 0),
                 reorder=cfg.reorder, lowering=cfg.lowering,
                 vdtype=cfg.vdtype, demoted=demoted)
    if demoted:
        entry["demoted_reason"] = "vmem-budget"
    if lowering_demoted:
        entry["lowering_demoted"] = True
        entry["lowering_demoted_reason"] = "unregistered-lowering"


def _scalar_stats(stats: dict) -> dict:
    return {k: v for k, v in stats.items()
            if isinstance(v, (int, float, str, bool))}


def as_reordering(reo) -> RE.Reordering:
    """The port's :class:`~repro_torch.core.reorder.Reordering`, or another
    package's read by attribute (``row_perm``, ``col_perm``, ``strategy``,
    ``stats``), e.g. the reference's, with no import of that package."""
    if isinstance(reo, RE.Reordering):
        return reo
    return RE.Reordering(np.asarray(reo.row_perm, dtype=np.int64),
                         np.asarray(reo.col_perm, dtype=np.int64),
                         strategy=str(getattr(reo, "strategy", "none")),
                         stats=dict(getattr(reo, "stats", {}) or {}))


def _reorder_pass(st: PlanState) -> None:
    """The permutation transform, as in the reference: resolve the
    ``reorder`` request (a strategy name is built and scored at the
    geometry in effect, and may decline; a Reordering is taken as it is),
    permute the matrix and record whether the whole-vector build can fold
    the inverse row permutation into ``chunk_row`` (``rows_fusible``)."""
    entry: dict = {"pass": "reorder", "strategy": "", "applied": False}
    reo = st.reorder
    if reo is not None and not isinstance(reo, str):
        reo = as_reordering(reo)
        if (reo.nrows, reo.ncols) != st.mat.shape:
            raise ValueError(
                f"reordering is for shape {(reo.nrows, reo.ncols)}, "
                f"matrix is {st.mat.shape}")
    elif reo is not None:
        reo = RE.reorder(st.mat, str(reo), r=st.mat.r, c=st.mat.c,
                         pr=512 if st.pr is None else st.pr,
                         xw=512 if st.xw is None else st.xw,
                         cb=st.cb if st.cb else 64, align=st.align)
    if reo is not None and not reo.is_identity:
        st.mat = reo.permute_spc5(st.mat)
        st.reo = reo
        st.rows_fusible = (not reo.identity_rows
                           and reo.rows_interval_contiguous(st.mat.r))
        entry.update(strategy=reo.strategy, applied=True,
                     rows_fusible=st.rows_fusible,
                     stats=_scalar_stats(reo.stats))
    elif reo is not None:               # declined, or an explicit identity
        entry.update(strategy=reo.strategy, stats=_scalar_stats(reo.stats))
    st.trace.append(entry)


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


def _perm_tensor(perm, device) -> torch.Tensor:
    return torch.from_numpy(np.array(perm, dtype=np.int32)).to(device)


def _build_pass(st: PlanState) -> SPC5Plan:
    """The layout's build, then the permutations attached, as in the
    reference: ``extra["cols_fused"]`` (the whole-vector descriptor build
    folded ``col_perm`` into ``xcol``) drops the column permutation,
    ``extra["rows_fused"]`` the inverse row permutation."""
    obs.faults.get_faults().maybe_fail("plan.build")
    spec = _REGISTRY[st.layout]
    with obs.span("plan.build", layout=st.layout) as sp:
        arrays, geom, *extra = spec.build(st)
    extra = extra[0] if extra else {}
    rows_fused = bool(extra.get("rows_fused", False))
    cols_fused = bool(extra.get("cols_fused", False))
    col_perm = row_iperm = None
    if st.reo is not None:
        if not (cols_fused or st.reo.identity_cols):
            col_perm = _perm_tensor(st.reo.col_perm, st.device)
        if not (rows_fused or st.reo.identity_rows):
            row_iperm = _perm_tensor(st.reo.row_iperm, st.device)
    st.trace.append({"pass": "build", "layout": st.layout,
                     "duration_s": sp.duration_s,
                     "rows_fused": rows_fused,
                     **{k: v for k, v in sorted(geom.items())
                        if isinstance(v, (int, float, str, bool))}})
    return SPC5Plan(layout=st.layout, arrays=tuple(arrays),
                    meta=tuple(sorted(geom.items())),
                    children=tuple(extra.get("children", ())),
                    col_perm=col_perm, row_iperm=row_iperm,
                    rows_fused=rows_fused,
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
    returns f32; "auto" takes a quantised tuned pick where the store has
    one, else, like "", keeps float32, which is what the reference holds
    for the generators' float64 values too. The vdtype's width sizes
    "auto"'s budget and the lowering's cost. ``dtype`` may only be None or
    float32 (no kernel of the port takes another value store than
    ``vdtype``'s: any other ``dtype`` raises ``NotImplementedError``, a
    deliberate difference), and not together with a ``vdtype`` other than
    "auto" (the reference's ``ValueError``: the value-dtype axis owns the
    cast).
    ``reorder`` is a strategy name ("sigma", "rcm", "colwindow", their
    aliases, "auto" or "none"; :func:`repro_torch.core.reorder.reorder`,
    scored at the geometry in effect and free to decline) or a prebuilt
    Reordering (the port's, or another package's read by attribute:
    :func:`as_reordering`); the plan keeps what its build could not fold
    of the permutations (``col_perm``, ``row_iperm``), and x and y stay in
    the original order.

    ``store`` (a :class:`~repro_torch.core.selector.RecordStore`; None: the
    default store, ``selector.set_default_store`` or ``$SPC5_RECORDS``)
    tunes the plan when nothing explicit was requested, as in the
    reference, from the records of the plan's device only
    (``selector.backend_of``): a store without one leaves the plan untuned
    ("no-store" in its trace).

    ``verify`` is the static verifier's hook, as in the reference: True
    runs :func:`repro_torch.analysis.verify.verify_plan` on the finished
    plan (at ``nvec``) and raises its ``PlanVerificationError`` on any
    violation; a callable receives the report instead."""
    vdtype = F.canonical_vdtype(vdtype)
    if vdtype not in ("", "auto") and dtype is not None:
        raise ValueError(
            f"pass either dtype= (legacy passthrough) or vdtype={vdtype!r}, "
            f"not both -- the value-dtype axis owns the cast")
    if dtype is not None and not _is_f32(dtype):
        raise NotImplementedError(
            f"dtype={dtype!r}: the port stores values as float32, or as "
            f"vdtype='bf16' / 'int8'; no kernel takes another value store "
            f"(ROADMAP §3, deliberate differences)")
    st = PlanState(mat=mat, device=torch.device(device),
                   layout=canonical_layout(layout),
                   multi_layout=canonical_layout(multi_layout),
                   lowering=canonical_lowering(lowering), pr=pr,
                   xw=xw, cb=cb, nvec=nvec, align=align, vdtype=vdtype,
                   tune=tune, dtype=None if dtype is None else np.float32,
                   store=store, reorder=reorder)
    for pass_name, pass_fn in (("tune", _tune_pass),
                               ("reorder", _reorder_pass),
                               ("layout", _layout_pass)):
        with obs.span(f"plan.{pass_name}") as sp:
            pass_fn(st)
        st.trace[-1]["duration_s"] = sp.duration_s
    plan = _build_pass(st)
    if verify:
        from repro_torch.analysis.verify import verify_plan
        report = verify_plan(plan, nvec=nvec)
        if callable(verify):
            verify(report)
        else:
            report.raise_if_failed()
    return plan


def _is_f32(dtype) -> bool:
    if isinstance(dtype, torch.dtype):
        return dtype == torch.float32
    return np.dtype(dtype) == np.float32


# ----------------------------------------------------------------------------
# Executor (the layout dispatch; its sharded twin is local_execute_spmv)
# ----------------------------------------------------------------------------

def execute_spmv(plan: SPC5Plan, x: torch.Tensor, *,
                 use_pallas: Optional[bool] = None,
                 double_buffer: bool = True,
                 interpret: Optional[bool] = None) -> torch.Tensor:
    """y = A @ x through the plan's registered lowering, on the plan's
    device: the CUDA kernels for a plan on the card, the plain PyTorch
    version for a plan on the CPU. ``x`` must be float32 on that device.

    ``use_pallas`` keeps the reference's keyword: None and True run as
    above; False runs the plain PyTorch version on the plan's device (an
    explicit request, not a fallback; ``double_buffer`` then changes
    nothing). ``interpret`` changes nothing on a CPU plan; True on a card
    plan raises ``ValueError``: the port has no kernel interpreter. The
    fault point ``exec.spmv`` is checked first (a no-op unless armed)."""
    obs.faults.get_faults().maybe_fail("exec.spmv")
    spec = _executor(plan, x, interpret)
    if use_pallas is False:
        y = spec.plain_spmv(plan, x)
    else:
        y = spec.lower_spmv(plan, x, double_buffer=double_buffer)
    return _unpermuted(plan, y)


def execute_spmm(plan: SPC5Plan, x: torch.Tensor, *,
                 use_pallas: Optional[bool] = None, nvt: int = 128,
                 double_buffer: bool = True,
                 interpret: Optional[bool] = None) -> torch.Tensor:
    """Y = A @ X, X of shape (ncols, nvec) float32 on the plan's device,
    through the plan's registered lowering (the CUDA kernels on the card,
    the plain PyTorch version on the CPU). ``nvt`` is the reference's
    column tile: nvec must be a multiple of min(nvt, nvec).
    ``use_pallas`` and ``interpret`` as in :func:`execute_spmv`; its fault
    point is ``exec.spmm``."""
    obs.faults.get_faults().maybe_fail("exec.spmm")
    spec = _executor(plan, x, interpret)
    if use_pallas is False:
        y = spec.plain_spmm(plan, x)
    else:
        y = spec.lower_spmm(plan, x, nvt=nvt, double_buffer=double_buffer)
    return _unpermuted(plan, y)


def _executor(plan: SPC5Plan, x, interpret: Optional[bool]) -> LayoutSpec:
    """The plan's layout, once x and ``interpret`` are checked."""
    if not isinstance(x, torch.Tensor) or x.device != plan.device:
        raise ValueError(f"x must be a tensor on the plan's device "
                         f"{plan.device}")
    if interpret and plan.device.type != "cpu":
        raise ValueError("interpret=True: the port has no kernel "
                         "interpreter; a plan on the CPU runs the plain "
                         "versions, use_pallas=False runs them on the card")
    return _REGISTRY[plan.layout]


def _unpermuted(plan: SPC5Plan, y: torch.Tensor) -> torch.Tensor:
    """y in the original row order: gathered by ``row_iperm``, a plain
    ``index_select`` outside every kernel (the reference's ``jnp.take``),
    unless the build fused the inverse row permutation."""
    return y if plan.row_iperm is None else y.index_select(0,
                                                           plan.row_iperm)


def _gathered_x(plan: SPC5Plan, x: torch.Tensor) -> torch.Tensor:
    """x in the permuted column order (``x[col_perm]``), where the lowering
    has no kernel that maps columns itself."""
    return x if plan.col_perm is None else x.index_select(0, plan.col_perm)


def plan_parts(plan):
    """(layout, arrays, meta, children, permutations) of another package's
    plan, read by attribute (``layout``, ``arrays``, ``meta``,
    ``children``; ``col_perm``, ``row_iperm``, ``rows_fused`` and
    ``trace_json`` where it has them), with no import of that package."""
    perms = dict(col_perm=getattr(plan, "col_perm", None),
                 row_iperm=getattr(plan, "row_iperm", None),
                 rows_fused=bool(getattr(plan, "rows_fused", False)),
                 trace_json=getattr(plan, "trace_json", "[]"))
    return (plan.layout, plan.arrays, plan.meta,
            tuple(getattr(plan, "children", ())), perms)


def _perm_operand(perm, n: int, what: str, device):
    if perm is None:
        return None
    perm = np.asarray(perm)
    if perm.shape != (n,) or perm.dtype.kind not in "iu":
        raise ValueError(f"{what} must be ({n},) integers, got "
                         f"{perm.dtype} {perm.shape}")
    return _perm_tensor(perm, device)


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

    A reordered plan carries its permutations outside its arrays and meta:
    ``col_perm`` ((ncols,) integers, the columns x is gathered by),
    ``row_iperm`` ((nrows,), the rows y is gathered by) and ``rows_fused``,
    taken as the reference's plan holds them (None where its build folded
    them).

    ``layout`` may instead be the other package's plan whole (a JAX
    ``SPC5Plan``, read by attribute: :func:`plan_parts`), with ``arrays``,
    ``meta`` and the permutations left out; its permutations and trace
    come with it, and its children are read the same way."""
    trace_json = "[]"
    if not isinstance(layout, str):
        if (arrays is not None or meta is not None or children
                or col_perm is not None or row_iperm is not None
                or rows_fused):
            raise ValueError("pass a plan whole, or its layout, arrays and "
                             "meta, not both")
        layout, arrays, meta, children, perms = plan_parts(layout)
        col_perm, row_iperm = perms["col_perm"], perms["row_iperm"]
        rows_fused, trace_json = perms["rows_fused"], perms["trace_json"]
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
                    meta=meta, children=children,
                    col_perm=_perm_operand(col_perm, m["ncols"], "col_perm",
                                           device),
                    row_iperm=_perm_operand(row_iperm, m["nrows"],
                                            "row_iperm", device),
                    rows_fused=bool(rows_fused),
                    trace_json=str(trace_json))


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
# Fingerprints + plan footprint (the serving tier's cache substrate)
# ----------------------------------------------------------------------------

def matrix_fingerprint(mat: F.SPC5Matrix) -> str:
    """Content hash of a beta(r,c) matrix: structure (block geometry,
    row/col/mask/voffset arrays) + values + value dtype, the reference's
    digest byte for byte (both packages hash the same host arrays).

    Two matrices with identical content hash identically however their
    arrays were produced; one flipped mask bit or one edited value changes
    the digest. The build-once half of :func:`plan_cache_key`."""
    h = hashlib.blake2b(digest_size=16)
    h.update(np.asarray([mat.shape[0], mat.shape[1], mat.r, mat.c],
                        dtype=np.int64).tobytes())
    h.update(str(np.dtype(mat.values.dtype)).encode())
    for a in (mat.block_rowptr, mat.block_colidx, mat.block_masks,
              mat.block_voffset, mat.values):
        h.update(np.ascontiguousarray(a).tobytes())
    return h.hexdigest()


def plan_cache_key(mat: F.SPC5Matrix, **request) -> str:
    """The plan cache's key: :func:`matrix_fingerprint` + the prepare
    request (layout / lowering / reorder / geometry / dtype / nvec / ...),
    as in the reference.

    Every decision that changes the built plan is part of the key;
    omitted / None / "auto" / "" / False knobs normalise away, so spelling
    a default explicitly does not split the cache."""
    norm = {}
    for k in sorted(request):
        v = request[k]
        if v is None or v == "auto" or v == "" or v is False:
            continue                    # defaults don't split the cache
        if k == "dtype":           # a torch dtype keys as its numpy twin
            v = (str(v).removeprefix("torch.") if isinstance(v, torch.dtype)
                 else str(np.dtype(v)))
        elif not isinstance(v, (bool, int, float, str)):
            v = str(v)                  # PanelConfig / Reordering reprs
        norm[k] = v
    h = hashlib.blake2b(digest_size=16)
    h.update(matrix_fingerprint(mat).encode())
    h.update(json.dumps(norm, sort_keys=True).encode())
    return h.hexdigest()


def append_trace_entries(plan: SPC5Plan, entries: List[dict]) -> SPC5Plan:
    """A copy of ``plan`` with ``entries`` appended to its pass trace (the
    degradation ladder's ``{"pass": "degrade", ...}`` entries, which the
    verifier's trace-schema rule admits after ``build``)."""
    return dataclasses.replace(
        plan, trace_json=json.dumps(plan.trace + list(entries),
                                    sort_keys=True))


def plan_nbytes(plan: SPC5Plan) -> int:
    """The bytes of a plan's tensors (``numel() * element_size()``), its
    sub-plans and permutations included: the plan cache's currency, equal
    to the reference's figure on byte-equal plans."""
    n = sum(a.numel() * a.element_size() for a in plan.arrays)
    for child in plan.children:
        n += plan_nbytes(child)
    for p in (plan.col_perm, plan.row_iperm):
        if p is not None:
            n += p.numel() * p.element_size()
    return n


# ----------------------------------------------------------------------------
# whole_vector layout
# ----------------------------------------------------------------------------

def _build_whole(st: PlanState):
    ch = F.to_chunked(st.mat, cb=256 if st.cb is None else st.cb,
                      align=st.align)
    rows_fused = False
    if st.reo is not None and st.rows_fusible:
        # each block's r permuted rows are r consecutive original rows:
        # chunk_row points at the original base row, and y needs no gather
        ch = dataclasses.replace(
            ch, chunk_row=st.reo.row_perm[ch.chunk_row].astype(np.int32))
        rows_fused = True
    geom = dict(r=ch.r, c=ch.c, cb=ch.cb, vmax=ch.vmax, nrows=ch.nrows,
                ncols=ch.ncols, nnz=ch.nnz, nblocks=int(st.mat.nblocks),
                lowering=st.lowering, vdtype=st.vdtype)
    values, scales = _value_store(ch.values, ch.chunk_vbase, ch.chunk_mask,
                                  st)
    if st.lowering == LOWERING_DESC:
        # a column permutation folds into the static xcol table, so the
        # plan keeps no col_perm and the kernels take no column map
        cmap = None
        if st.reo is not None and not st.reo.identity_cols:
            cmap = st.reo.col_perm
        desc = F.chunk_descriptors(ch.chunk_mask, ch.chunk_voff,
                                   ch.chunk_col, ch.chunk_row, r=ch.r,
                                   c=ch.c, vmax=ch.vmax, xmax=ch.ncols,
                                   ymax=ch.nrows, col_map=cmap)
        geom["desc_lane_nbytes"] = desc.lane_nbytes
        return (_with_scale(R.device_put_desc(values, desc, ch.chunk_vbase,
                                              st.device), scales, st.device),
                geom, {"rows_fused": rows_fused,
                       "cols_fused": cmap is not None})
    ch = dataclasses.replace(ch, values=values)
    return (_with_scale(R.device_put(ch, st.device), scales, st.device),
            geom, {"rows_fused": rows_fused})


def _lower_spmv_whole(plan: SPC5Plan, x, *, double_buffer):
    scale = _plan_scale(plan)
    if plan.lowering == LOWERING_DESC:
        fn = (spc5_spmv_desc.spmv_cuda_desc_db if double_buffer
              else spc5_spmv_desc.spmv_cuda_desc)
        return fn(plan.chunk_vbase, plan.desc_valid, plan.desc_vidx,
                  plan.desc_xcol, plan.desc_yrow, plan.values, x, scale,
                  r=plan.r, c=plan.c, cb=plan.cb, vmax=plan.vmax,
                  nrows=plan.nrows, ncols=plan.ncols)
    # the mask kernels take the column map, as the reference's do
    fn = spc5_spmv.spmv_cuda_db if double_buffer else spc5_spmv.spmv_cuda
    return fn(plan.chunk_vbase, plan.chunk_col, plan.chunk_mask,
              plan.chunk_voff, plan.chunk_row, plan.values, x, plan.col_perm,
              scale,
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
        plan.chunk_row, plan.values, x, plan.col_perm, scale, r=plan.r,
        c=plan.c,
        cb=plan.cb, vmax=plan.vmax, nrows=plan.nrows, ncols=plan.ncols,
        nvt=nvt)


def _plain_whole(plan: SPC5Plan, x, spmm: bool):
    scale = _plan_scale(plan)
    if plan.lowering == LOWERING_DESC:
        fn = R.spmm_desc if spmm else R.spmv_desc
        return fn(plan.dev, x, scale, nrows=plan.nrows)
    fn = R.spmm if spmm else R.spmv
    return fn(plan.dev, _gathered_x(plan, x), scale, r=plan.r, c=plan.c,
              nrows=plan.nrows, ncols=plan.ncols)


def _padded_stack(built, name: str, lead) -> np.ndarray:
    """Array ``name`` of every shard's build, zero-padded on its leading
    axes to the sizes ``lead`` and stacked on a new leading shard axis."""
    arrays = [getattr(b, name) for b in built]
    return np.stack([np.pad(a, [(0, n - m) for n, m in zip(lead, a.shape)]
                            + [(0, 0)] * (a.ndim - len(lead)))
                     for a in arrays])


def _stacked_values(built, nvals: int, st: "ShardState") -> np.ndarray:
    """Every shard's packed values zero-padded to ``nvals`` and stacked, in
    the shard pass's value store (bf16 as bit patterns; float64 values
    become float32 on the device, as the reference's do)."""
    stack = _padded_stack(built, "values", (nvals,))
    dt = np.dtype(st.dtype or st.mat.values.dtype)
    return F.bf16_bits(stack) if dt == F.BF16_HOST else stack.astype(dt)


def _stack_whole(st: "ShardState"):
    """The whole-vector stacks both lowerings share, as in the reference:
    each slab chunked at ``cb`` (256 by default) and padded to the largest
    shard's chunks, values to the largest ``len + vmax``. Returns the
    stacked values, ``pad(name)`` (a chunk array of every shard, stacked)
    and the geometry."""
    cb = 256 if st.cb is None else st.cb
    chunked = [F.to_chunked(p, cb=cb) for p in st.parts]
    nch = max(ch.nchunks for ch in chunked)
    vmax = max(ch.vmax for ch in chunked)
    nvals = max(ch.values.shape[0] + vmax for ch in chunked)
    values = _stacked_values(chunked, nvals, st)
    geom = dict(r=st.mat.r, c=st.mat.c, cb=cb, vmax=vmax,
                rows_max=max(p.shape[0] for p in st.parts),
                nrows=st.mat.shape[0], ncols=st.mat.shape[1], nnz=st.mat.nnz)
    return values, lambda name: _padded_stack(chunked, name, (nch,)), geom


def _shard_build_whole(st: "ShardState"):
    """The mask lowering's stacks in ``SPC5Device`` order (masks as
    int32)."""
    values, pad, geom = _stack_whole(st)
    return (values, pad("chunk_col"), pad("chunk_mask").astype(np.int32),
            pad("chunk_voff"), pad("chunk_row"), pad("chunk_vbase")), geom


def _shard_build_whole_desc(st: "ShardState"):
    """The descriptor lowering's stacks: the stacked masks expanded once
    (``xmax=ncols``, ``ymax=rows_max``); a padding chunk's lanes are unset,
    so it adds nothing."""
    values, pad, geom = _stack_whole(st)
    desc = F.chunk_descriptors(pad("chunk_mask"), pad("chunk_voff"),
                               pad("chunk_col"), pad("chunk_row"),
                               r=geom["r"], c=geom["c"], vmax=geom["vmax"],
                               xmax=geom["ncols"], ymax=geom["rows_max"])
    return (values, desc.valid, desc.vidx, desc.xcol, desc.yrow,
            pad("chunk_vbase")), geom


def _local_spmv_whole(sh: "ShardedPlan", local, x):
    """One shard's whole-vector mask SpMV: ``spmv_cuda_db`` on the card,
    its plain version on the CPU."""
    dev = R.SPC5Device(*local)
    return spc5_spmv.spmv_cuda_db(
        dev.chunk_vbase, dev.chunk_col, dev.chunk_mask, dev.chunk_voff,
        dev.chunk_row, dev.values, x, r=sh.r, c=sh.c, cb=sh.cb, vmax=sh.vmax,
        nrows=sh.rows_max, ncols=sh.ncols)


def _local_spmv_whole_desc(sh: "ShardedPlan", local, x):
    """One shard's whole-vector descriptor SpMV: ``spmv_cuda_desc_db`` on
    the card, its plain version on the CPU."""
    dev = R.SPC5DescDevice(*local)
    return spc5_spmv_desc.spmv_cuda_desc_db(
        dev.chunk_vbase, dev.desc_valid, dev.desc_vidx, dev.desc_xcol,
        dev.desc_yrow, dev.values, x, r=sh.r, c=sh.c, cb=sh.cb, vmax=sh.vmax,
        nrows=sh.rows_max, ncols=sh.ncols)


register_layout(LayoutSpec(
    name=LAYOUT_WHOLE,
    array_names=R.SPC5Device._fields,
    build=_build_whole,
    lower_spmv=_lower_spmv_whole,
    lower_spmm=_lower_spmm_whole,
    cost=_cost_whole,
    plain_spmv=lambda plan, x: _plain_whole(plan, x, False),
    plain_spmm=lambda plan, x: _plain_whole(plan, x, True),
    device_view=lambda arrays: R.SPC5Device(*arrays),
    shard_build=_shard_build_whole,
    local_spmv=_local_spmv_whole,
    shard_build_desc=_shard_build_whole_desc,
    local_spmv_desc=_local_spmv_whole_desc,
    lowerings=_LOWERING_NAMES,
    desc_array_names=R.SPC5DescDevice._fields,
    desc_device_view=lambda arrays: R.SPC5DescDevice(*arrays),
))


# ----------------------------------------------------------------------------
# panels layout
# ----------------------------------------------------------------------------

def _panel_row_permutation(reo: RE.Reordering, pr: int, nrows: int,
                           npanels: int) -> Optional[np.ndarray]:
    """The panel layout's row fusion, as in the reference: where every
    pr-row panel of the permuted matrix is one pr-aligned ascending slab of
    original rows, the row permutation is a permutation of whole panels,
    ``pperm[p]`` the original panel of permuted panel p; None where it is
    not (a partial panel must stay last)."""
    if reo.identity_rows:
        return None
    rp = reo.row_perm
    pperm = np.empty(npanels, dtype=np.int64)
    for p in range(npanels):
        lo, hi = p * pr, min((p + 1) * pr, nrows)
        if lo >= hi:
            pperm[p] = p
            continue
        s = int(rp[lo])
        if s % pr:
            return None
        if not np.array_equal(rp[lo:hi], np.arange(s, s + hi - lo)):
            return None
        if hi - lo < pr and s != (npanels - 1) * pr:
            return None
        pperm[p] = s // pr
    return pperm


def _build_panels(st: PlanState):
    pan = F.to_panels(st.mat, pr=512 if st.pr is None else st.pr,
                      cb=64 if st.cb is None else st.cb,
                      xw=512 if st.xw is None else st.xw, align=st.align)
    rows_fused = False
    if st.reo is not None:
        pperm = _panel_row_permutation(st.reo, pan.pr, pan.nrows,
                                       pan.npanels)
        if pperm is not None:
            # permuted panel p's arrays go to grid position pperm[p], so
            # output panel q is original rows [q pr, (q + 1) pr) and no row
            # gather remains (chunk_vbase indexes values absolutely)
            inv = np.empty_like(pperm)
            inv[pperm] = np.arange(pperm.shape[0])
            pan = dataclasses.replace(
                pan, chunk_col=pan.chunk_col[inv],
                chunk_mask=pan.chunk_mask[inv],
                chunk_voff=pan.chunk_voff[inv],
                chunk_row=pan.chunk_row[inv],
                chunk_vbase=pan.chunk_vbase[inv],
                chunk_xbase=pan.chunk_xbase[inv])
            rows_fused = True
    geom = dict(r=pan.r, c=pan.c, pr=pan.pr, cb=pan.cb, xw=pan.xw,
                vmax=pan.vmax, npanels=pan.npanels, nchunks=pan.nchunks,
                nrows=pan.nrows, ncols=pan.ncols, ncols_pad=pan.ncols_pad,
                nnz=pan.nnz, nblocks=int(st.mat.nblocks),
                lowering=st.lowering, vdtype=st.vdtype)
    values, scales = _value_store(pan.values, pan.chunk_vbase,
                                  pan.chunk_mask, st)
    if st.lowering == LOWERING_DESC:
        # window-relative xcol and panel-relative yrow tables; a column
        # permutation cannot fold in (the windows lie in permuted column
        # space), so the plan keeps col_perm and the kernels map columns
        desc = F.chunk_descriptors(pan.chunk_mask, pan.chunk_voff,
                                   pan.chunk_col, pan.chunk_row, r=pan.r,
                                   c=pan.c, vmax=pan.vmax, xmax=pan.xw,
                                   ymax=pan.pr)
        geom["desc_lane_nbytes"] = desc.lane_nbytes
        return (_with_scale(R.device_put_desc(values, desc, pan.chunk_vbase,
                                              st.device, pan.chunk_xbase),
                            scales, st.device), geom,
                {"rows_fused": rows_fused})
    pan = dataclasses.replace(pan, values=values)
    return (_with_scale(R.device_put_panels(pan, st.device), scales,
                        st.device), geom, {"rows_fused": rows_fused})


def _lower_spmv_panels(plan: SPC5Plan, x, *, double_buffer):
    # a kept col_perm goes to every panel kernel as its column map, at any
    # width: the reference materialises x[col_perm] past its 2 MiB VMEM
    # budget (_panel_fused_x), a TPU guard the H100 kernels, which keep no
    # whole x on chip, do not need (ROADMAP, deliberate differences)
    scale = _plan_scale(plan)
    if plan.lowering == LOWERING_DESC:
        fn = (spc5_spmv_desc.spmv_cuda_panels_desc_db if double_buffer
              else spc5_spmv_desc.spmv_cuda_panels_desc)
        return fn(plan.chunk_vbase, plan.chunk_xbase, plan.desc_valid,
                  plan.desc_vidx, plan.desc_xcol, plan.desc_yrow,
                  plan.values, x, plan.col_perm, scale, r=plan.r, c=plan.c,
                  cb=plan.cb, vmax=plan.vmax, xw=plan.xw, pr=plan.pr,
                  nrows=plan.nrows, ncols_pad=plan.ncols_pad)
    fn = (spc5_spmv.spmv_cuda_panels_db if double_buffer
          else spc5_spmv.spmv_cuda_panels)
    return fn(plan.chunk_vbase, plan.chunk_xbase, plan.chunk_col,
              plan.chunk_mask, plan.chunk_voff, plan.chunk_row, plan.values,
              x, plan.col_perm, scale, r=plan.r, c=plan.c, cb=plan.cb, vmax=plan.vmax,
              xw=plan.xw, pr=plan.pr, nrows=plan.nrows,
              ncols_pad=plan.ncols_pad)


def _lower_spmm_panels(plan: SPC5Plan, x, *, nvt, double_buffer):
    scale = _plan_scale(plan)
    if plan.lowering == LOWERING_DESC:
        fn = (spc5_spmm_desc.spmm_cuda_panels_desc_db if double_buffer
              else spc5_spmm_desc.spmm_cuda_panels_desc)
        return fn(plan.chunk_vbase, plan.chunk_xbase, plan.desc_valid,
                  plan.desc_vidx, plan.desc_xcol, plan.desc_yrow,
                  plan.values, x, plan.col_perm, scale, r=plan.r, c=plan.c,
                  cb=plan.cb, vmax=plan.vmax, xw=plan.xw, pr=plan.pr,
                  nrows=plan.nrows, ncols_pad=plan.ncols_pad, nvt=nvt)
    fn = (spc5_spmm.spmm_cuda_panels_db if double_buffer
          else spc5_spmm.spmm_cuda_panels)
    return fn(plan.chunk_vbase, plan.chunk_xbase, plan.chunk_col,
              plan.chunk_mask, plan.chunk_voff, plan.chunk_row, plan.values,
              x, plan.col_perm, scale, r=plan.r, c=plan.c, cb=plan.cb, vmax=plan.vmax,
              xw=plan.xw, pr=plan.pr, nrows=plan.nrows,
              ncols_pad=plan.ncols_pad, nvt=nvt)


def _plain_panels(plan: SPC5Plan, x, spmm: bool):
    scale = _plan_scale(plan)
    geom = dict(pr=plan.pr, nrows=plan.nrows, ncols_pad=plan.ncols_pad)
    if plan.lowering == LOWERING_DESC:
        fn = R.spmm_panels_desc if spmm else R.spmv_panels_desc
    else:
        fn = R.spmm_panels if spmm else R.spmv_panels
        geom.update(r=plan.r, c=plan.c)
    return fn(plan.dev, x, plan.col_perm, scale, **geom)


def _stack_panels(st: "ShardState"):
    """The panel stacks both lowerings share, as in the reference: each
    slab panelled at (pr, cb, xw) (512, 64, 512 by default) and padded to
    the largest shard's panels and chunks, values to the largest
    ``chunk_vbase.max() + vmax``. Returns the stacked values, ``pad(name)``
    and the geometry (``rows_max`` = the padded panels' rows)."""
    pans = [F.to_panels(p, pr=512 if st.pr is None else st.pr,
                        cb=64 if st.cb is None else st.cb,
                        xw=512 if st.xw is None else st.xw)
            for p in st.parts]
    pr = pans[0].pr                     # normalised to a multiple of r
    npan = max(p.npanels for p in pans)
    nch = max(p.nchunks for p in pans)
    vmax = max(p.vmax for p in pans)
    nvals = max(int(p.chunk_vbase.max()) + vmax for p in pans)
    values = _stacked_values(pans, nvals, st)
    geom = dict(r=st.mat.r, c=st.mat.c, pr=pr, cb=pans[0].cb, xw=pans[0].xw,
                vmax=vmax, rows_max=npan * pr, nrows=st.mat.shape[0],
                ncols=st.mat.shape[1],
                ncols_pad=max(p.ncols_pad for p in pans), nnz=st.mat.nnz)
    return (values, lambda name: _padded_stack(pans, name, (npan, nch)),
            geom)


def _shard_build_panels(st: "ShardState"):
    """The mask lowering's stacks in ``SPC5PanelDevice`` order (masks as
    int32)."""
    values, pad, geom = _stack_panels(st)
    return (values, pad("chunk_col"), pad("chunk_mask").astype(np.int32),
            pad("chunk_voff"), pad("chunk_row"), pad("chunk_vbase"),
            pad("chunk_xbase")), geom


def _shard_build_panels_desc(st: "ShardState"):
    """The descriptor lowering's stacks: the stacked masks expanded once,
    window-relative ``xcol`` (``xmax=xw``) and panel-relative ``yrow``
    (``ymax=pr``)."""
    values, pad, geom = _stack_panels(st)
    desc = F.chunk_descriptors(pad("chunk_mask"), pad("chunk_voff"),
                               pad("chunk_col"), pad("chunk_row"),
                               r=geom["r"], c=geom["c"], vmax=geom["vmax"],
                               xmax=geom["xw"], ymax=geom["pr"])
    return (values, desc.valid, desc.vidx, desc.xcol, desc.yrow,
            pad("chunk_vbase"), pad("chunk_xbase")), geom


def _local_spmv_panels(sh: "ShardedPlan", local, x):
    """One shard's panel mask SpMV: ``spmv_cuda_panels_db`` on the card,
    its plain version on the CPU."""
    dev = R.SPC5PanelDevice(*local)
    return spc5_spmv.spmv_cuda_panels_db(
        dev.chunk_vbase, dev.chunk_xbase, dev.chunk_col, dev.chunk_mask,
        dev.chunk_voff, dev.chunk_row, dev.values, x, r=sh.r, c=sh.c,
        cb=sh.cb, vmax=sh.vmax, xw=sh.xw, pr=sh.pr, nrows=sh.rows_max,
        ncols_pad=sh.ncols_pad)


def _local_spmv_panels_desc(sh: "ShardedPlan", local, x):
    """One shard's panel descriptor SpMV: ``spmv_cuda_panels_desc_db`` on
    the card, its plain version on the CPU."""
    dev = R.SPC5PanelDescDevice(*local)
    return spc5_spmv_desc.spmv_cuda_panels_desc_db(
        dev.chunk_vbase, dev.chunk_xbase, dev.desc_valid, dev.desc_vidx,
        dev.desc_xcol, dev.desc_yrow, dev.values, x, r=sh.r, c=sh.c,
        cb=sh.cb, vmax=sh.vmax, xw=sh.xw, pr=sh.pr, nrows=sh.rows_max,
        ncols_pad=sh.ncols_pad)


register_layout(LayoutSpec(
    name=LAYOUT_PANELS,
    array_names=R.SPC5PanelDevice._fields,
    build=_build_panels,
    lower_spmv=_lower_spmv_panels,
    lower_spmm=_lower_spmm_panels,
    cost=_cost_panels,
    plain_spmv=lambda plan, x: _plain_panels(plan, x, False),
    plain_spmm=lambda plan, x: _plain_panels(plan, x, True),
    device_view=lambda arrays: R.SPC5PanelDevice(*arrays),
    shard_build=_shard_build_panels,
    local_spmv=_local_spmv_panels,
    shard_build_desc=_shard_build_panels_desc,
    local_spmv_desc=_local_spmv_panels_desc,
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
                      vdtype=st.vdtype or "auto", store=st.store,
                      tune=st.tune, lowering=st.lowering)
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
    xg = _gathered_x(plan, x)
    y = execute_spmv(plan.multi, xg, double_buffer=double_buffer)
    if plan.single_values.numel():
        y = y + _tail_spmv(plan, xg)
    return y


def _lower_spmm_test(plan: SPC5Plan, x, *, nvt, double_buffer):
    """The multi sub-plan's SpMM plus the tail's: the CUDA tail kernel (or,
    for a plan on the CPU, its plain version ``spmm_coo_panels``) for panel
    buckets; for a flat tail the plain ``spmm_coo`` on any device, as the
    reference computes it outside any kernel."""
    xg = _gathered_x(plan, x)
    y = execute_spmm(plan.multi, xg, nvt=nvt, double_buffer=double_buffer)
    if plan.single_values.numel():
        rows, cols, vals = (plan.single_rows, plan.single_cols,
                            plan.single_values)
        if plan.tail_pr:
            tail = spc5_spmv_tail.spmm_tail_cuda(
                rows, cols, vals, xg, pr=plan.tail_pr, nrows=plan.nrows,
                nvt=nvt)
        else:
            tail = R.spmm_coo(rows, cols, vals, xg, nrows=plan.nrows)
        y = y + tail
    return y


def _plain_test(plan: SPC5Plan, x, spmm: bool):
    xg = _gathered_x(plan, x)
    y = (execute_spmm if spmm else execute_spmv)(plan.multi, xg,
                                                 use_pallas=False)
    if plan.single_values.numel():
        rows, cols, vals, _ = plan.arrays
        if plan.tail_pr:
            fn = R.spmm_coo_panels if spmm else R.spmv_coo_panels
            y = y + fn(rows, cols, vals, xg, pr=plan.tail_pr,
                       nrows=plan.nrows)
        else:
            fn = R.spmm_coo if spmm else R.spmv_coo
            y = y + fn(rows, cols, vals, xg, nrows=plan.nrows)
    return y


register_layout(LayoutSpec(
    name=LAYOUT_TEST,
    array_names=_TEST_ARRAYS,
    build=_build_test,
    lower_spmv=_lower_spmv_test,
    lower_spmm=_lower_spmm_test,
    cost=lambda nrows, ncols, itemsize, nvec: 0,
    plain_spmv=lambda plan, x: _plain_test(plan, x, False),
    plain_spmm=lambda plan, x: _plain_test(plan, x, True),
    auto_eligible=False,
    # the lowering is the multi sub-plan's; the tail's arrays do not
    # depend on it
    lowerings=_LOWERING_NAMES,
))


# ----------------------------------------------------------------------------
# Shard pass: row slabs as per-shard sub-plans, stacked
# ----------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ShardedPlan:
    """The sub-plans of one registered layout over ``ndev`` row slabs,
    stacked, as in the reference.

    ``arrays`` hold the layout's tensors with a leading shard axis (each
    shard padded to the largest; a padding chunk's mask is 0 and adds
    nothing), in the order of the layout's array names for the plan's
    lowering, so :func:`local_execute_spmv` takes one shard's slice without
    knowing the layout. ``row_start`` is each shard's first global row.
    With ``rank=None`` the stacks hold every shard, all on one device;
    with ``rank=k`` they hold shard k's slice alone (leading size 1), the
    analogue of the reference's stack placed on a mesh by
    ``NamedSharding``: rank k of a process group holds its own shard.
    A reordering applied before the partition rides along (``col_perm``,
    ``row_iperm``) as on :class:`SPC5Plan`."""

    layout: str
    arrays: Tuple[torch.Tensor, ...]
    row_start: torch.Tensor         # (ndev,) int32, every shard's
    meta: Tuple[Tuple[str, Any], ...]
    col_perm: Optional[torch.Tensor] = None
    row_iperm: Optional[torch.Tensor] = None
    reorder: str = ""
    trace_json: str = "[]"
    rank: Optional[int] = None

    def __getattr__(self, name):
        return _resolve_attr(self, name)

    @property
    def ndev(self) -> int:
        """The shards of the partition: the stacks' leading size where the
        plan holds every shard."""
        return int(self.row_start.shape[0])

    @property
    def trace(self) -> List[dict]:
        return json.loads(self.trace_json)

    def local(self, k: int) -> Tuple[torch.Tensor, ...]:
        """Shard k's tensors: its slice of every stack (views, no copy)."""
        if self.rank is not None:
            if k != self.rank:
                raise ValueError(f"this plan holds shard {self.rank} only, "
                                 f"not shard {k}")
            k = 0
        elif not 0 <= k < self.ndev:
            raise ValueError(f"shard {k} is not in [0, {self.ndev})")
        return tuple(a[k] for a in self.arrays)


@dataclasses.dataclass
class ShardState:
    """What a layout's ``shard_build`` hook builds from: the (permuted)
    matrix, its row slabs and the geometry requested."""

    mat: F.SPC5Matrix
    parts: List[F.SPC5Matrix]
    pr: Optional[int] = None
    xw: Optional[int] = None
    cb: Optional[int] = None
    dtype: Any = None


def shard_plan(mat: F.SPC5Matrix, ndev: int, *, layout: str = "auto",
               cb: Optional[int] = None, dtype=None, vdtype: str = "auto",
               pr: Optional[int] = None, xw: int = 512,
               store: Optional[S.RecordStore] = None,
               config: Optional[S.PanelConfig] = None, tune: bool = True,
               reorder=None, lowering: str = "auto",
               partition: str = "auto", device: Optional[Device] = None,
               rank: Optional[int] = None) -> ShardedPlan:
    """The shard pass, as in the reference: tune -> reorder -> lowering ->
    partition -> per-layout stacking, each under an ``obs`` span
    (``shard.tune`` ... ``shard.build``) and appending a
    ``duration_s``-stamped entry to the plan's trace with the reference's
    keys.

    The tune pass runs at ``workers=ndev`` on the records of the plan's
    device only (:func:`~repro_torch.core.selector.backend_of`) and clamps
    the tuned config against one shard's rows. ``layout`` is a registry key
    or "auto" (the tuned config's layout, panels where ``pr`` is given,
    else whole-vector); ``lowering`` an explicit lowering the layout's
    shard hooks serve (:attr:`LayoutSpec.shard_lowerings`; anything else
    raises), or "auto" (the tuned pick, else :func:`lowering_cost`).
    ``vdtype`` as in :func:`make_plan`, except that "int8" demotes to
    "bf16" (``vdtype_demoted`` on the lowering entry): the stacks carry no
    per-chunk scales. ``dtype`` may only be None or float32, and not with
    a ``vdtype``. ``reorder`` (a strategy name or a Reordering) permutes
    the whole matrix before the partition. ``partition`` is "blocks" (the
    paper's equal-block split), "nnz" (equal nonzeros) or "auto" ("nnz"
    where it cuts the heaviest shard's share of the nonzeros by more than
    5 %, with the evidence on the trace).

    The plan's tensors go to ``device`` (None: the card, which raises where
    there is none; ``"cpu"`` runs the plain versions). With ``rank=k`` only
    shard k's slice goes there (:class:`ShardedPlan`); the host builds
    every shard either way, as the reference's host does before placing
    the stack."""
    from repro_torch.kernels import ops
    from . import partition as P

    lowering = canonical_lowering(lowering)
    vdtype = F.canonical_vdtype(vdtype)
    if vdtype not in ("", "auto") and dtype is not None:
        raise ValueError(
            f"pass either dtype= (legacy passthrough) or vdtype={vdtype!r}, "
            f"not both -- the value-dtype axis owns the cast")
    if dtype is not None and not _is_f32(dtype):
        raise NotImplementedError(
            f"dtype={dtype!r}: the port stores values as float32, or as "
            f"vdtype='bf16' / 'int8'; no kernel takes another value store "
            f"(ROADMAP §3, deliberate differences)")
    if partition not in P.PARTITION_MODES + ("auto",):
        raise ValueError(
            f"unknown partition mode {partition!r}; expected one of "
            f"{P.PARTITION_MODES + ('auto',)}")
    if rank is not None and not 0 <= rank < ndev:
        raise ValueError(f"rank {rank} is not in [0, {ndev})")
    dev = ops.resolve_device(device)
    if dtype is not None:
        dtype = np.float32
    if vdtype == "auto":
        vdtype = ""
    # the stacks carry no per-chunk scales: int8 demotes to bf16, traced
    vdtype_demoted = vdtype == "int8"
    if vdtype_demoted:
        vdtype = "bf16"
    if vdtype:
        dtype = F.value_dtype(vdtype)
    trace: List[dict] = []

    # tune at workers=ndev; no whole-vector demotion, as each shard's kernel
    # sees only its own rows
    sp = obs.span("shard.tune", workers=int(ndev))
    tentry: dict = {"pass": "tune", "workers": int(ndev)}
    if config is None and tune and pr is None and cb is None:
        tstore = store if store is not None else S.get_default_store()
        backend = S.backend_of(dev)
        if S.has_backend(tstore, backend):
            config = S.tune(S.spc5_features(mat), store=tstore,
                            kernel=f"{mat.r}x{mat.c}", workers=ndev,
                            backend=backend)
            tentry.update(source="store", layout=config.layout,
                          pr=int(config.pr or 0), xw=int(config.xw or 0),
                          cb=int(config.cb or 0), reorder=config.reorder)
        else:
            tentry["source"] = "no-store"
    else:
        tentry["source"] = ("explicit" if (config is not None
                                           or pr is not None
                                           or cb is not None)
                            else "disabled")
    tentry["duration_s"] = sp.finish().duration_s
    trace.append(tentry)
    if reorder is None and config is not None and config.reorder:
        reorder = config.reorder

    sp = obs.span("shard.reorder")
    rentry: dict = {"pass": "reorder", "strategy": "", "applied": False}
    reo = None
    if reorder is not None:
        if isinstance(reorder, str):
            reo = RE.reorder(mat, reorder, r=mat.r, c=mat.c,
                             pr=(config.pr if config is not None
                                 and config.layout == LAYOUT_PANELS
                                 else pr) or 512,
                             xw=xw, cb=cb or 64)
        else:
            reo = as_reordering(reorder)
            if (reo.nrows, reo.ncols) != mat.shape:
                raise ValueError(
                    f"reordering is for shape {(reo.nrows, reo.ncols)}, "
                    f"matrix is {mat.shape}")
        rentry.update(strategy=reo.strategy, stats=_scalar_stats(reo.stats))
        if reo.is_identity:
            reo = None
        else:
            mat = reo.permute_spc5(mat)
            rentry["applied"] = True
    rentry["duration_s"] = sp.finish().duration_s
    trace.append(rentry)

    sp = obs.span("shard.lowering")
    req_layout = canonical_layout(layout)
    layout = LAYOUT_WHOLE
    spr, sxw, scb = pr, xw, cb
    if config is not None:
        # clamped against one shard's rows and blocks, not the matrix's
        config = S.clamp_config(
            config, nrows=max(-(-mat.nrows // max(ndev, 1)), mat.r),
            ncols=mat.ncols, r=mat.r, c=mat.c,
            nblocks=max(1, -(-mat.nblocks // max(ndev, 1))))
        if config.layout == LAYOUT_PANELS:
            layout = LAYOUT_PANELS
            spr = config.pr or 512
            sxw = config.xw or 512
            scb = config.cb or 64
        else:
            scb = config.cb if cb is None else cb
    if layout != LAYOUT_PANELS and pr is not None:
        layout = LAYOUT_PANELS
        spr, scb = pr, (64 if scb is None else scb)
    if req_layout not in _LAYOUT_SENTINELS:
        # an explicit layout wins over the tuned or pr-derived one
        layout = req_layout
        if layout == LAYOUT_PANELS and spr is None:
            spr, scb = 512, (64 if scb is None else scb)
    spec = _REGISTRY[layout]
    served = spec.shard_lowerings
    if not served:
        raise ValueError(
            f"layout {layout!r} registers no sharded stacking hooks; "
            f"shardable layouts: "
            f"{[n for n in _REGISTRY if _REGISTRY[n].shard_lowerings]}")
    lentry: dict = {"pass": "lowering", "layout": layout}
    if lowering not in _LOWERING_SENTINELS:
        if lowering not in served:
            raise ValueError(
                f"layout {layout!r} has no sharded {lowering!r} stacking "
                f"hooks (serves {served}); pass lowering='auto' or one of "
                f"{served}")
        lentry["reason"] = "requested"
    elif config is not None and config.lowering in served:
        lowering = config.lowering
        lentry["reason"] = "tuned"
    else:
        itemsize = np.dtype(dtype or mat.values.dtype).itemsize
        lowering = min(served, key=lambda n: lowering_cost(
            mat.r, mat.c, mat.avg_nnz_per_block, itemsize, n))
        lentry["reason"] = "cost-model"
    lentry["lowering"] = lowering
    lentry["vdtype"] = vdtype
    if vdtype_demoted:
        lentry["vdtype_demoted"] = True
        lentry["vdtype_demoted_reason"] = "no-sharded-int8-scales"
    lentry["duration_s"] = sp.finish().duration_s
    trace.append(lentry)

    # "auto": the nnz-balanced split where it cuts the heaviest shard's
    # share by more than 5 % (arXiv:1805.11938's load-imbalance criterion)
    sp = obs.span("shard.partition", ndev=int(ndev))
    pentry: dict = {"pass": "partition", "requested": partition,
                    "ndev": int(ndev)}
    mode = partition
    if partition == "auto":
        skew_blocks = P.nnz_skew(mat, ndev, "blocks")
        skew_nnz = P.nnz_skew(mat, ndev, "nnz")
        mode = "nnz" if skew_nnz < 0.95 * skew_blocks else "blocks"
        pentry.update(skew_blocks=round(skew_blocks, 4),
                      skew_nnz=round(skew_nnz, 4))
    pentry["mode"] = mode
    pentry["duration_s"] = sp.finish().duration_s
    trace.append(pentry)

    sp = obs.span("shard.build", layout=layout, ndev=int(ndev),
                  lowering=lowering)
    state = ShardState(mat=mat, parts=P.partition_matrix(mat, ndev, mode),
                       pr=spr, xw=sxw, cb=scb, dtype=dtype)
    build = (spec.shard_build_desc if lowering == LOWERING_DESC
             else spec.shard_build)
    stacks, geom = build(state)
    geom["lowering"] = lowering
    geom["vdtype"] = vdtype
    trace.append({"pass": "shard", "layout": layout, "ndev": int(ndev),
                  "duration_s": sp.finish().duration_s,
                  **{k: v for k, v in sorted(geom.items())
                     if isinstance(v, (int, float, str, bool))}})
    held = slice(None) if rank is None else slice(rank, rank + 1)
    col_perm = row_iperm = None
    if reo is not None:
        col_perm = _perm_tensor(reo.col_perm, dev)
        row_iperm = _perm_tensor(reo.row_iperm, dev)
    return ShardedPlan(
        layout=layout, arrays=tuple(R.to_tensor(a[held], dev)
                                    for a in stacks),
        row_start=torch.from_numpy(
            P.partition_row_starts(mat, ndev, mode)).to(dev),
        meta=tuple(sorted(geom.items())), col_perm=col_perm,
        row_iperm=row_iperm, reorder="" if reo is None else reo.strategy,
        trace_json=json.dumps(trace, sort_keys=True), rank=rank)


def local_execute_spmv(sh: ShardedPlan, local: Tuple[torch.Tensor, ...],
                       x: torch.Tensor) -> torch.Tensor:
    """One shard's y slab ((rows_max,) float32) from its tensors ``local``
    (:meth:`ShardedPlan.local`) and the whole x in the permuted column
    order: the sharded twin of :func:`execute_spmv`, and like it the only
    dispatch on the layout and lowering. On the card it launches the
    kernel :func:`execute_spmv` launches for the layout and lowering at
    ``double_buffer=True``; on the CPU it runs the plain version."""
    spec = _REGISTRY[sh.layout]
    hook = (spec.local_spmv_desc if _meta_lowering(sh.meta) == LOWERING_DESC
            else spec.local_spmv)
    return hook(sh, local, x)
