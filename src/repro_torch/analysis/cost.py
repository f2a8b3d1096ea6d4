"""Per-device cost of a step from its dispatch: flops, HBM bytes and
collective bytes (the port's counterpart of ``repro.analysis.hlo``).

The port has no HLO. :class:`CostMode` is a ``TorchDispatchMode`` that
sees every op a step dispatches and counts only the ops on plain tensors:
under DTensor those are each rank's own (local) ops. DTensor's own
(logical) op, whose arguments are DTensors, is handed on to DTensor
uncounted, and so are the ops of its shape propagation (on fake tensors
of the global shapes).
A ``FlopCounterMode`` around DTensor code counts each product twice, the
logical op and its local one; here each is counted once, per device.

  * flops: 2 * prod(out) * contraction of each matmul-class op
    (``torch.utils.flop_counter``'s formulas), as the reference counts
    dots only;
  * HBM bytes: operand plus output bytes of each local op (views and
    collectives' waits are free). An upper bound: eager PyTorch fuses
    nothing, where XLA's fusions keep their intermediates on chip;
  * collective bytes: each functional collective DTensor issues, by the
    reference's link model (ring algorithms): all-reduce 2x input,
    all-gather output, reduce-scatter input, all-to-all input.

The step runs on ``device="meta"`` tensors over a fake process group (the
dry run), or on real ones: the counts are the same.
"""
from __future__ import annotations

import dataclasses
import weakref
from typing import Dict

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

#: functional collectives -> the reference's HLO kind names
_COLLECTIVES = {
    "all_reduce": "all-reduce", "all_reduce_coalesced": "all-reduce",
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all", "broadcast": "collective-broadcast",
}
_FREE = ("wait_tensor", "_wrap_tensor_autograd")


@dataclasses.dataclass
class StepCost:
    """Per-device figures, keyed as ``repro.analysis.hlo.HloCost``."""
    flops: float = 0.0
    hbm_bytes: float = 0.0
    coll_bytes: float = 0.0
    coll_by_kind: Dict[str, float] = dataclasses.field(default_factory=dict)
    coll_count: Dict[str, int] = dataclasses.field(default_factory=dict)


def _nbytes(t) -> int:
    if not isinstance(t, torch.Tensor):
        return 0
    return t.numel() * t.element_size()


def _tensors(tree):
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def _is_dt(t) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(t, DTensor)


def _is_fake(t) -> bool:
    from torch._subclasses.fake_tensor import FakeTensor
    return isinstance(t, FakeTensor)


class CostMode(TorchDispatchMode):
    """Counts a step's local ops into ``self.cost``; with ``track_memory``
    also the bytes of the local tensors the ops make, while they live
    (``self.live``, ``self.peak``): an estimate of the step's temporary
    memory on one device."""

    def __init__(self, track_memory: bool = True):
        super().__init__()
        from torch.utils.flop_counter import flop_registry
        self._flops = flop_registry
        self.cost = StepCost()
        self.track_memory = track_memory
        self.live = 0
        self.peak = 0

    def _made(self, t: torch.Tensor) -> None:
        n = _nbytes(t)
        self.live += n
        self.peak = max(self.peak, self.live)

        def freed(n=n):
            self.live -= n
        weakref.finalize(t, freed)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        ins = _tensors((args, kwargs))
        if any(_is_dt(t) for t in ins):
            # DTensor's logical op: handed on to DTensor, whose local ops
            # come back through this mode
            return NotImplemented
        out = func(*args, **kwargs)
        outs = _tensors(out)
        if any(_is_fake(t) for t in ins + outs):
            return out        # DTensor's shape propagation, not a local op
        name = func._overloadpacket.__name__
        c = self.cost
        if name in _COLLECTIVES:
            kind = _COLLECTIVES[name]
            in_b = sum(_nbytes(t) for t in ins)
            out_b = sum(_nbytes(t) for t in outs)
            link = (2.0 * in_b if kind == "all-reduce"
                    else float(out_b) if kind == "all-gather"
                    else float(in_b))
            c.coll_bytes += link
            c.coll_by_kind[kind] = c.coll_by_kind.get(kind, 0.0) + link
            c.coll_count[kind] = c.coll_count.get(kind, 0) + 1
            c.hbm_bytes += in_b + out_b
        elif name not in _FREE:
            packet = func._overloadpacket
            if packet in self._flops:
                c.flops += float(self._flops[packet](
                    *args, out_val=out, **kwargs))
            if not _is_view(func, write=False):
                c.hbm_bytes += sum(_nbytes(t) for t in ins) + \
                    sum(_nbytes(t) for t in outs)
        if self.track_memory and not _is_view(func):
            for t in outs:
                self._made(t)
        return out


def _is_view(func, write: bool = True) -> bool:
    """Whether ``func`` returns an alias of an input (a view, or with
    ``write`` also an in-place op's own input): it makes no new memory,
    and a view moves no bytes."""
    return any(r.alias_info is not None
               and (write or not r.alias_info.is_write)
               for r in func._schema.returns)


def local_bytes(tree) -> int:
    """The bytes this rank holds of a tree of tensors and DTensors (each
    DTensor's local block)."""
    total = 0
    for t in _tensors(tree):
        total += _nbytes(t.to_local() if _is_dt(t) else t)
    return total

