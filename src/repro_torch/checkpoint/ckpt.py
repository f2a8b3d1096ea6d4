"""Fault-tolerant checkpointing: atomic, manifest-driven, keep-last-k; the
port of ``repro.checkpoint.ckpt`` on the reference's on-disk layout.

Layout per step:  <dir>/step_<n>/
    manifest.json   {step, keys, shapes, dtypes, complete: true}
    arrays.npz      flattened "path/to/leaf" -> array

Leaf keys are the dict keys of the path joined by "/", exactly as the
reference's ``tree_flatten_with_path`` names them, so a checkpoint written
by either package restores into the other. Writes go to ``step_<n>.tmp``
then ``os.replace`` (atomic on POSIX), so a preemption mid-write can never
produce a checkpoint that ``latest_step`` considers valid. Restore reads
host numpy arrays and puts each leaf on its template leaf's device, in its
dtype (a template of numpy arrays gets numpy arrays back). A bfloat16
tensor is written as float32 (numpy has no bfloat16 without ``ml_dtypes``)
and cast back on restore, which loses nothing.

A sharded tree (DTensor leaves) is saved whole: every rank gathers each
leaf (``full_tensor``, a collective), rank 0 writes the reference's
layout, and the other ranks wait for it at a barrier. On restore a
DTensor template leaf gets the checkpoint's global value laid out as the
template is (each rank keeps its block), so a checkpoint written on one
mesh resumes on another, or in the reference: the elastic restore of
``repro.checkpoint.ckpt``.
"""
from __future__ import annotations

import json
import os
import shutil
from typing import Any, Dict, Iterator, Optional, Tuple

import numpy as np
import torch


def _paths(tree: Any, prefix: Tuple[str, ...] = ()
           ) -> Iterator[Tuple[str, Any]]:
    """("path/to/leaf", leaf) over a nested dict, keys sorted as the
    reference's flatten sorts them."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _paths(tree[k], prefix + (str(k),))
    else:
        yield "/".join(prefix), tree


def _is_dt(leaf: Any) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(leaf, DTensor)


def _host(leaf: Any) -> np.ndarray:
    if _is_dt(leaf):
        leaf = leaf.full_tensor()
    if torch.is_tensor(leaf):
        leaf = leaf.detach()
        if leaf.dtype == torch.bfloat16:
            leaf = leaf.float()
        return leaf.cpu().numpy()
    return np.asarray(leaf)


def _flatten(tree: Any) -> Dict[str, np.ndarray]:
    return {key: _host(leaf) for key, leaf in _paths(tree)}


def _like(arr: np.ndarray, leaf: Any) -> Any:
    """``arr`` as ``leaf`` is: a tensor on its device in its dtype (a
    DTensor laid out as it is), or a numpy array of its dtype."""
    if _is_dt(leaf):
        from torch.distributed.tensor import DTensor, Replicate
        mesh = leaf.device_mesh
        full = torch.from_numpy(np.array(arr, order="C")).to(
            device=leaf.to_local().device, dtype=leaf.dtype)
        return DTensor.from_local(full, mesh, [Replicate()] * mesh.ndim,
                                  run_check=False).redistribute(
                                      mesh, leaf.placements)
    if torch.is_tensor(leaf):
        return torch.from_numpy(np.array(arr, order="C")).to(
            device=leaf.device, dtype=leaf.dtype)
    return arr.astype(np.asarray(leaf).dtype)


def _unflatten_into(template: Any, flat: Dict[str, np.ndarray],
                    prefix: Tuple[str, ...] = ()) -> Any:
    if isinstance(template, dict):
        return {k: _unflatten_into(v, flat, prefix + (str(k),))
                for k, v in template.items()}
    key = "/".join(prefix)
    arr = flat[key]
    if tuple(arr.shape) != tuple(template.shape):
        raise ValueError(f"shape mismatch for {key}: "
                         f"ckpt {arr.shape} vs model {tuple(template.shape)}")
    return _like(arr, template)


def save_checkpoint(ckpt_dir: str, step: int, tree: Any,
                    keep_last: int = 3) -> str:
    """Write ``tree`` as step ``step``; returns its directory. Every rank of
    a sharded tree calls it (rank 0 writes)."""
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    flat = _flatten(tree)
    sharded = any(_is_dt(leaf) for _, leaf in _paths(tree))
    if sharded:
        import torch.distributed as dist
        if dist.get_rank() != 0:
            dist.barrier()
            return final
    try:
        return _write(ckpt_dir, final, step, flat, keep_last)
    finally:
        if sharded:
            dist.barrier()


def _write(ckpt_dir: str, final: str, step: int,
           flat: Dict[str, np.ndarray], keep_last: int) -> str:
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp, exist_ok=True)
    np.savez(os.path.join(tmp, "arrays.npz"), **flat)
    manifest = {
        "step": step,
        "keys": sorted(flat),
        "shapes": {k: list(v.shape) for k, v in flat.items()},
        "dtypes": {k: str(v.dtype) for k, v in flat.items()},
        "complete": True,
    }
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.replace(tmp, final)
    _gc(ckpt_dir, keep_last)
    return final


def _gc(ckpt_dir: str, keep_last: int) -> None:
    steps = sorted(_list_steps(ckpt_dir))
    for s in steps[:-keep_last] if keep_last > 0 else []:
        shutil.rmtree(os.path.join(ckpt_dir, f"step_{s:08d}"),
                      ignore_errors=True)


def _list_steps(ckpt_dir: str):
    if not os.path.isdir(ckpt_dir):
        return []
    out = []
    for name in os.listdir(ckpt_dir):
        if name.startswith("step_") and not name.endswith(".tmp"):
            mf = os.path.join(ckpt_dir, name, "manifest.json")
            try:
                with open(mf) as f:
                    if json.load(f).get("complete"):
                        out.append(int(name[5:]))
            except (OSError, ValueError, json.JSONDecodeError):
                continue
    return out


def latest_step(ckpt_dir: str) -> Optional[int]:
    steps = _list_steps(ckpt_dir)
    return max(steps) if steps else None


def restore_checkpoint(ckpt_dir: str, step: int, template: Any) -> Any:
    """The checkpoint of ``step`` in ``template``'s structure, each leaf on
    the template leaf's device and in its dtype."""
    path = os.path.join(ckpt_dir, f"step_{step:08d}")
    with np.load(os.path.join(path, "arrays.npz")) as z:
        flat = {k: z[k] for k in z.files}
    return _unflatten_into(template, flat)
