"""Execution plans: a layout registry, the plan passes and one executor.

The port's counterpart of ``repro.core.plan``, cut to the SpMV and SpMM
slices ported so far:

  * **Registry** (:class:`LayoutSpec`, :func:`register_layout`): the
    ``whole_vector`` and ``panels`` layouts, each a ``build``, a
    ``lower_spmv`` and a ``lower_spmm`` entry plus the ``cost`` that "auto"
    resolution reads, and the lowerings it registers: ``mask`` (the bit
    mask decoded on every call) and ``descriptor`` (the decode expanded
    into gather tables at build time).
  * **Plan** (:class:`SPC5Plan`): a frozen dataclass holding the layout's
    tensors (all on one device), the geometry as ``meta`` and the pass
    ``trace``. Geometry keys and array names (per lowering) resolve as
    attributes.
  * **Passes** (:func:`make_plan`): tune -> reorder -> layout -> build, each
    appending a ``duration_s``-stamped entry to ``plan.trace`` with the
    reference's keys.
  * **Executors** (:func:`execute_spmv`, :func:`execute_spmm`): the only
    place that dispatches on the layout key.

Not ported yet (each raises ``NotImplementedError``): bf16/int8 values,
reordering, the ``test`` layout and the record-store tuner (ROADMAP
queue 1).
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
                                 spc5_spmv_desc)

from . import formats as F
from . import ref_spmv as R

LAYOUT_WHOLE = "whole_vector"
LAYOUT_PANELS = "panels"
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
    tensors, ``build(state)`` returns ``(arrays, geom)``, ``lower_spmv`` runs
    y = A @ x and ``lower_spmm`` Y = A @ X, ``cost(nrows, ncols, itemsize,
    nvec)`` is the footprint "auto" resolution compares with the budget.
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
    device_view: Callable
    lowerings: Tuple[str, ...] = (LOWERING_MASK,)
    desc_array_names: Optional[Tuple[str, ...]] = None
    desc_device_view: Optional[Callable] = None

    def plan_array_names(self, lowering: str) -> Tuple[str, ...]:
        """The tensor names of a plan of this layout under ``lowering``."""
        if lowering == LOWERING_DESC and self.desc_array_names:
            return self.desc_array_names
        return self.array_names


_REGISTRY: Dict[str, LayoutSpec] = {}
_AUTO_ORDER: List[str] = []


def register_layout(spec: LayoutSpec) -> LayoutSpec:
    """Add a layout to the registry (idempotent by name, last wins)."""
    if spec.name in _LAYOUT_SENTINELS:
        raise ValueError(f"{spec.name!r} is reserved")
    if spec.name not in _REGISTRY:
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
    if name == "test":
        raise _not_ported("the beta(r,c)_test layout", "item 5")
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


# ----------------------------------------------------------------------------
# The plan
# ----------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class SPC5Plan:
    """Layout key + the layout's tensors (one device) + geometry + trace."""

    layout: str
    arrays: Tuple[torch.Tensor, ...]
    meta: Tuple[Tuple[str, Any], ...]
    trace_json: str = "[]"

    def __getattr__(self, name):
        meta = object.__getattribute__(self, "meta")
        for k, v in meta:
            if k == name:
                return v
        names = _REGISTRY[object.__getattribute__(self, "layout")] \
            .plan_array_names(_meta_lowering(meta))
        if name in names:
            return object.__getattribute__(self, "arrays")[names.index(name)]
        raise AttributeError(f"SPC5Plan ({self.layout!r}) has no attribute "
                             f"{name!r}")

    @property
    def device(self) -> torch.device:
        return self.arrays[0].device

    @property
    def dev(self):
        """The layout's tensor view for the plan's lowering
        (``SPC5Device`` / ``SPC5PanelDevice``, or their descriptor twins)."""
        spec = _REGISTRY[self.layout]
        if _meta_lowering(self.meta) == LOWERING_DESC:
            return spec.desc_device_view(self.arrays)
        return spec.device_view(self.arrays)

    @property
    def trace(self) -> List[dict]:
        return json.loads(self.trace_json)


# ----------------------------------------------------------------------------
# Pipeline state + passes
# ----------------------------------------------------------------------------

@dataclasses.dataclass
class PlanState:
    mat: F.SPC5Matrix
    device: torch.device
    layout: str = "auto"
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
        """Bytes per value as the reference's "auto" rule counts them: 4 for
        an explicit f32, else the requested ``dtype`` or the matrix's own
        (8 for the generators' float64, though both packages store f32)."""
        if self.vdtype == "f32":
            return 4
        return np.dtype(self.dtype or self.mat.values.dtype).itemsize


def _tune_pass(st: PlanState) -> None:
    """The port has no record store yet: the pass records why it did not
    consult one, with the reference's three sources for that."""
    explicit = (st.layout != "auto" or st.pr is not None
                or st.xw is not None or st.cb is not None)
    source = ("disabled" if not st.tune else
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
    arrays, geom = spec.build(st)
    st.trace.append({"pass": "build", "layout": st.layout,
                     "duration_s": time.perf_counter() - t0,
                     "rows_fused": False,
                     **{k: v for k, v in sorted(geom.items())
                        if isinstance(v, (int, float, str, bool))}})
    return SPC5Plan(layout=st.layout, arrays=tuple(arrays),
                    meta=tuple(sorted(geom.items())),
                    trace_json=json.dumps(st.trace, sort_keys=True))


def make_plan(mat: F.SPC5Matrix, *, device: Device, layout: str = "auto",
              lowering: str = "auto", pr: Optional[int] = None,
              xw: Optional[int] = None, cb: Optional[int] = None,
              nvec: int = 1, align: int = 8, dtype=None,
              vdtype: str = "auto", tune: bool = True) -> SPC5Plan:
    """The plan pipeline: tune -> reorder -> layout -> build.

    ``nvec`` is the widest SpMM batch the plan will see; "auto" layout
    budgets x and y at that width, as the reference does. ``lowering`` is
    "mask", "descriptor" or "auto" (the reference's :func:`lowering_cost`
    arbitration). Values are stored as float32 ("" / "f32"), which is what
    the reference holds for the generators' float64 values too. ``dtype``
    may only be None or float32."""
    vdtype = F.canonical_vdtype(vdtype)
    if vdtype not in ("", "auto", "f32"):
        raise _not_ported(f"vdtype={vdtype!r}", "item 5")
    if dtype is not None and not _is_f32(dtype):
        raise _not_ported(f"dtype={dtype!r}", "item 5")
    st = PlanState(mat=mat, device=torch.device(device),
                   layout=canonical_layout(layout),
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


def plan_from_arrays(layout: str, arrays, meta, *,
                     device: Device) -> SPC5Plan:
    """A port plan from another plan's host arrays and geometry.

    ``arrays`` are the layout's arrays in registry order for the lowering
    ``meta`` names (each anything ``np.asarray`` takes, e.g. a JAX plan's
    device arrays; descriptor tables keep their narrow dtypes) and ``meta``
    its ``(key, value)`` geometry, so the port computes with exactly the
    bytes the other package built."""
    spec = get_layout(layout)
    meta = tuple(sorted((str(k), v) for k, v in meta))
    m = dict(meta)
    lowering = m.get("lowering", LOWERING_MASK)
    if lowering not in spec.lowerings:
        raise ValueError(f"layout {spec.name!r} has no lowering "
                         f"{lowering!r}")
    if m.get("vdtype", "") not in ("", "f32"):
        raise _not_ported(f"vdtype={m['vdtype']!r}", "item 5")
    arrays = [np.asarray(a) for a in arrays]
    names = spec.plan_array_names(lowering)
    if len(arrays) != len(names):
        raise ValueError(f"layout {spec.name!r} ({lowering}) has arrays "
                         f"{names}, got {len(arrays)}")
    return SPC5Plan(layout=spec.name,
                    arrays=tuple(R.to_tensor(a, device) for a in arrays),
                    meta=meta)


# ----------------------------------------------------------------------------
# whole_vector layout
# ----------------------------------------------------------------------------

def _build_whole(st: PlanState):
    ch = F.to_chunked(st.mat, cb=256 if st.cb is None else st.cb,
                      align=st.align)
    geom = dict(r=ch.r, c=ch.c, cb=ch.cb, vmax=ch.vmax, nrows=ch.nrows,
                ncols=ch.ncols, nnz=ch.nnz, nblocks=int(st.mat.nblocks),
                lowering=st.lowering, vdtype=st.vdtype)
    if st.lowering == LOWERING_DESC:
        desc = F.chunk_descriptors(ch.chunk_mask, ch.chunk_voff,
                                   ch.chunk_col, ch.chunk_row, r=ch.r,
                                   c=ch.c, vmax=ch.vmax, xmax=ch.ncols,
                                   ymax=ch.nrows)
        geom["desc_lane_nbytes"] = desc.lane_nbytes
        return tuple(R.device_put_desc(ch.values, desc, ch.chunk_vbase,
                                       st.device)), geom
    return tuple(R.device_put(ch, st.device)), geom


def _lower_spmv_whole(plan: SPC5Plan, x, *, double_buffer):
    if plan.lowering == LOWERING_DESC:
        fn = (spc5_spmv_desc.spmv_cuda_desc_db if double_buffer
              else spc5_spmv_desc.spmv_cuda_desc)
        return fn(plan.chunk_vbase, plan.desc_valid, plan.desc_vidx,
                  plan.desc_xcol, plan.desc_yrow, plan.values, x, r=plan.r,
                  c=plan.c, cb=plan.cb, vmax=plan.vmax, nrows=plan.nrows,
                  ncols=plan.ncols)
    fn = spc5_spmv.spmv_cuda_db if double_buffer else spc5_spmv.spmv_cuda
    return fn(plan.chunk_vbase, plan.chunk_col, plan.chunk_mask,
              plan.chunk_voff, plan.chunk_row, plan.values, x,
              r=plan.r, c=plan.c, cb=plan.cb, vmax=plan.vmax,
              nrows=plan.nrows, ncols=plan.ncols)


def _lower_spmm_whole(plan: SPC5Plan, x, *, nvt, double_buffer):
    # the reference has one whole-vector SpMM kernel per lowering: no
    # double buffer
    if plan.lowering == LOWERING_DESC:
        return spc5_spmm_desc.spmm_cuda_desc(
            plan.chunk_vbase, plan.desc_valid, plan.desc_vidx, plan.desc_xcol,
            plan.desc_yrow, plan.values, x, r=plan.r, c=plan.c, cb=plan.cb,
            vmax=plan.vmax, nrows=plan.nrows, ncols=plan.ncols, nvt=nvt)
    return spc5_spmm.spmm_cuda(
        plan.chunk_vbase, plan.chunk_col, plan.chunk_mask, plan.chunk_voff,
        plan.chunk_row, plan.values, x, r=plan.r, c=plan.c, cb=plan.cb,
        vmax=plan.vmax, nrows=plan.nrows, ncols=plan.ncols, nvt=nvt)


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
    if st.lowering == LOWERING_DESC:
        # window-relative xcol and panel-relative yrow tables
        desc = F.chunk_descriptors(pan.chunk_mask, pan.chunk_voff,
                                   pan.chunk_col, pan.chunk_row, r=pan.r,
                                   c=pan.c, vmax=pan.vmax, xmax=pan.xw,
                                   ymax=pan.pr)
        geom["desc_lane_nbytes"] = desc.lane_nbytes
        return tuple(R.device_put_desc(pan.values, desc, pan.chunk_vbase,
                                       st.device, pan.chunk_xbase)), geom
    return tuple(R.device_put_panels(pan, st.device)), geom


def _lower_spmv_panels(plan: SPC5Plan, x, *, double_buffer):
    if plan.lowering == LOWERING_DESC:
        fn = (spc5_spmv_desc.spmv_cuda_panels_desc_db if double_buffer
              else spc5_spmv_desc.spmv_cuda_panels_desc)
        return fn(plan.chunk_vbase, plan.chunk_xbase, plan.desc_valid,
                  plan.desc_vidx, plan.desc_xcol, plan.desc_yrow,
                  plan.values, x, r=plan.r, c=plan.c, cb=plan.cb,
                  vmax=plan.vmax, xw=plan.xw, pr=plan.pr, nrows=plan.nrows,
                  ncols_pad=plan.ncols_pad)
    fn = (spc5_spmv.spmv_cuda_panels_db if double_buffer
          else spc5_spmv.spmv_cuda_panels)
    return fn(plan.chunk_vbase, plan.chunk_xbase, plan.chunk_col,
              plan.chunk_mask, plan.chunk_voff, plan.chunk_row, plan.values,
              x, r=plan.r, c=plan.c, cb=plan.cb, vmax=plan.vmax, xw=plan.xw,
              pr=plan.pr, nrows=plan.nrows, ncols_pad=plan.ncols_pad)


def _lower_spmm_panels(plan: SPC5Plan, x, *, nvt, double_buffer):
    if plan.lowering == LOWERING_DESC:
        fn = (spc5_spmm_desc.spmm_cuda_panels_desc_db if double_buffer
              else spc5_spmm_desc.spmm_cuda_panels_desc)
        return fn(plan.chunk_vbase, plan.chunk_xbase, plan.desc_valid,
                  plan.desc_vidx, plan.desc_xcol, plan.desc_yrow,
                  plan.values, x, r=plan.r, c=plan.c, cb=plan.cb,
                  vmax=plan.vmax, xw=plan.xw, pr=plan.pr, nrows=plan.nrows,
                  ncols_pad=plan.ncols_pad, nvt=nvt)
    fn = (spc5_spmm.spmm_cuda_panels_db if double_buffer
          else spc5_spmm.spmm_cuda_panels)
    return fn(plan.chunk_vbase, plan.chunk_xbase, plan.chunk_col,
              plan.chunk_mask, plan.chunk_voff, plan.chunk_row, plan.values,
              x, r=plan.r, c=plan.c, cb=plan.cb, vmax=plan.vmax, xw=plan.xw,
              pr=plan.pr, nrows=plan.nrows, ncols_pad=plan.ncols_pad,
              nvt=nvt)


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
