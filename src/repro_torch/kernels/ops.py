"""Public entry points of the port: :func:`prepare`, :func:`spmv`,
:func:`spmm` and :func:`spmv_test`.

The counterpart of ``repro.kernels.ops`` for the SpMV and SpMM slices.
:func:`prepare` runs the plan passes (``repro_torch.core.plan``) and puts
the plan's tensors on a device: the card unless the caller asks for the
CPU. :func:`spmv` and :func:`spmm` multiply through the plan executors,
which run the CUDA kernels for a plan on the card and the plain PyTorch
version for a plan on the CPU.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core import formats as F
from repro_torch.core import plan as P


def resolve_device(device: Optional[P.Device]) -> torch.device:
    """``None`` means the card. With no card present that raises: the port
    runs on the CPU only when the caller asks for it."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the plain "
            "PyTorch version on the host")
    return torch.device("cuda")


def prepare(mat: F.SPC5Matrix, *, layout: str = "auto",
            lowering: str = "auto", reorder=None, config=None, verify=False,
            pr: Optional[int] = None, xw: Optional[int] = None,
            cb: Optional[int] = None, nvec: int = 1, align: int = 8,
            dtype=None, vdtype: str = "auto", store=None, tune: bool = True,
            multi_layout: str = "auto",
            device: Optional[P.Device] = None) -> P.SPC5Plan:
    """Build an execution plan for ``mat`` on ``device`` (default: the card).

    ``layout`` is "whole_vector", "panels" (or the alias "whole"), "test"
    or "auto", which keeps the reference's rule (whole-vector when x and y
    fit ``plan.VMEM_WHOLE_VECTOR_BUDGET``) and never picks "test".
    ``layout="test"`` builds the beta(r,c)_test split: the blocks with two
    or more nonzeros in a sub-plan of layout ``multi_layout`` ("auto" by
    the same rule) and the singleton blocks as a COO tail, bucketed by row
    panel (the CUDA tail kernel) when the sub-plan is a panel plan.
    ``pr``/``xw`` default to 512 and
    ``cb`` to 256 (whole-vector) or 64 (panels). ``config`` takes a
    ``PanelConfig``-like object (``layout``, ``pr``, ``xw``, ``cb``,
    ``lowering``, ``vdtype`` attributes) whole, filling every
    axis the caller left at its default, as the reference does (so an
    explicit ``lowering`` wins over the config's). Pass
    ``nvec``, the widest SpMM batch the plan will see, so that "auto"
    budgets the SpMM tiles and not only the SpMV vectors.

    ``lowering`` is "mask", "descriptor" (build-time gather tables) or
    "auto" (the default, as in the reference): its cost model
    (``plan.lowering_cost``).
    ``vdtype`` ("f32", "bf16", "int8" or "auto", also read from a config's
    ``vdtype``) stores the values in that dtype, int8 with one f32 scale a
    chunk; products accumulate and return f32. Every layout and lowering
    takes it, on the CPU (the plain versions) and on the card (every
    kernel); a ``layout="test"`` plan keeps its singleton tail in bf16 at
    bf16 and in f32 at int8, as the reference does. ``reorder``, ``verify``
    and ``store`` take the reference's defaults (None, False, None); a ``reorder``, a truthy
    ``verify`` and a ``store`` raise ``NotImplementedError`` naming their
    ROADMAP item."""
    P.refuse_unported(reorder, store, verify)
    if config is not None:
        if layout == "auto":
            layout = getattr(config, "layout", "") or "auto"
        pr = pr if pr is not None else (getattr(config, "pr", 0) or None)
        xw = xw if xw is not None else (getattr(config, "xw", 0) or None)
        cb = cb if cb is not None else (getattr(config, "cb", 0) or None)
        if lowering == "auto":
            lowering = getattr(config, "lowering", "") or lowering
        if getattr(config, "reorder", ""):
            raise NotImplementedError(
                "reordering is not ported to repro_torch yet (ROADMAP queue "
                "1, item 5)")
        if vdtype == "auto" and getattr(config, "vdtype", "") not in ("", "f32"):
            vdtype = config.vdtype
    return P.make_plan(mat, device=resolve_device(device), layout=layout,
                       lowering=lowering, pr=pr, xw=xw, cb=cb, nvec=nvec,
                       align=align, dtype=dtype, vdtype=vdtype, tune=tune,
                       multi_layout=multi_layout, store=store,
                       reorder=reorder, verify=verify)


def spmv(plan: P.SPC5Plan, x: torch.Tensor, *,
         double_buffer: bool = True) -> torch.Tensor:
    """y = A @ x; ``x`` is a float32 (ncols,) tensor on the plan's device
    and y float32, whatever the plan's value dtype.
    ``double_buffer`` picks the kernel that prefetches the next chunk's
    windows (the default, as in the reference) or the single-buffered one."""
    return P.execute_spmv(plan, x, double_buffer=double_buffer)


def spmm(plan: P.SPC5Plan, x: torch.Tensor, *, nvt: int = 128,
         double_buffer: bool = True) -> torch.Tensor:
    """Y = A @ X; ``x`` is a contiguous float32 (ncols, nvec) tensor on the
    plan's device and Y is (nrows, nvec). ``nvt`` and ``double_buffer`` as
    in the reference (the whole-vector layout has one SpMM kernel)."""
    return P.execute_spmm(plan, x, nvt=nvt, double_buffer=double_buffer)


def spmv_test(plan: P.SPC5Plan, x: torch.Tensor, **kw) -> torch.Tensor:
    """y = A @ x over the beta(r,c)_test split: the same executor as
    :func:`spmv`, kept as a named entry point as in the reference."""
    return P.execute_spmv(plan, x, **kw)
