"""Carry the reference's parameter and cache trees into the port.

``params_from_numpy`` / ``cache_from_numpy`` take a nested dict of numpy
arrays -- the reference's pytree after ``jax.tree.map(np.asarray, ...)``
-- and return the same tree of tensors on ``device``, leaf for leaf, with
the dtypes kept (float32, int8, and ``ml_dtypes.bfloat16``, known by its
dtype name, as ``torch.bfloat16`` with the same bits). This is how the
tests give both packages the same weights; it imports nothing of JAX.
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
