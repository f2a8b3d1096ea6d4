"""Carry the reference's parameter, cache and optimizer trees into the
port, and the port's back to the host.

``params_from_numpy`` / ``cache_from_numpy`` / ``opt_state_from_numpy``
take a nested dict of numpy arrays -- the reference's pytree after
``jax.tree.map(np.asarray, ...)`` -- and return the same tree of tensors
on ``device``, leaf for leaf, with the dtypes kept (float32, int8, int32,
and ``ml_dtypes.bfloat16``, known by its dtype name, as ``torch.bfloat16``
with the same bits). ``tree_to_numpy`` is the way back, for float and
integer leaves. This is how the tests and the smoke give both packages
(or the card and the CPU) the same weights and training state; it imports
nothing of JAX.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Iterator, Optional

import numpy as np
import torch

Tree = Dict[str, Any]


def tree_map(fn: Callable[[Any], Any], tree: Tree) -> Tree:
    """The nested dict ``tree`` with ``fn`` applied to every leaf."""
    return {k: tree_map(fn, v) if isinstance(v, dict) else fn(v)
            for k, v in tree.items()}


def zip_map(fn: Callable[..., Any], tree: Tree, *rest: Tree) -> Tree:
    """``fn`` over the leaves of ``tree`` and the same leaves of ``rest``
    (trees of one structure), as a tree of ``tree``'s structure."""
    return {k: zip_map(fn, v, *(r[k] for r in rest)) if isinstance(v, dict)
            else fn(v, *(r[k] for r in rest)) for k, v in tree.items()}


def tree_leaves(tree: Tree) -> Iterator[Any]:
    """The leaves of the nested dict ``tree``, in its key order."""
    for v in tree.values():
        yield from (tree_leaves(v) if isinstance(v, dict) else (v,))


def tensor_from_numpy(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """One host array as a tensor on ``device``, dtype kept."""
    a = np.array(a, copy=True, order="C")
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).to(device).view(
            torch.bfloat16)
    return torch.from_numpy(a).to(device)


def params_from_numpy(tree: Tree,
                      device: Optional[torch.device] = None) -> Tree:
    """The reference's parameter tree (numpy leaves) as tensors on
    ``device`` (None: the card)."""
    from repro_torch.kernels.ops import resolve_device
    device = resolve_device(device)
    return tree_map(lambda a: tensor_from_numpy(a, device), tree)


#: The reference's KV-cache tree (numpy leaves) as tensors on ``device``:
#: the same leaf-for-leaf carry as the parameters.
cache_from_numpy = params_from_numpy


def opt_state_from_numpy(tree: Tree,
                         device: Optional[torch.device] = None) -> Tree:
    """The reference's AdamW state ``{"m", "v", "step"}`` (numpy leaves)
    as the port's on ``device`` (None: the card): ``m`` and ``v`` float32
    trees, ``step`` a 0-d int32 tensor."""
    if set(tree) != {"m", "v", "step"}:
        raise ValueError(f"an AdamW state has m, v and step; got "
                         f"{sorted(tree)}")
    from repro_torch.kernels.ops import resolve_device
    device = resolve_device(device)
    out = params_from_numpy({"m": tree["m"], "v": tree["v"]}, device)
    out["step"] = tensor_from_numpy(
        np.asarray(tree["step"], dtype=np.int32).reshape(()), device)
    return out


def tree_to_numpy(tree: Tree) -> Tree:
    """A tree of tensors as numpy arrays on the host, dtypes kept (float32,
    integers); the reverse of :func:`params_from_numpy` for those."""
    def host(t):
        if t.dtype == torch.bfloat16:
            raise TypeError("tree_to_numpy: numpy has no bfloat16 here; "
                            "cast the tree to float32 first")
        return t.detach().cpu().numpy()
    return tree_map(host, tree)
