"""Device meshes over the ranks of a process group (the port of
``repro.launch.mesh``; building a mesh is a FUNCTION: importing this
module touches no process group).

The reference is one process over all local devices. The port is one
process a device, PyTorch's SPMD idiom: ``torchrun --nproc-per-node N``
starts the ranks, :func:`join_ranks` joins them (NCCL on the card, gloo on
the CPU), and a ``DeviceMesh`` names their dims with the reference's axis
names in the reference's order (("pod",) "data", "model"), the order
:func:`repro_torch.sharding.rules.placements` needs.
"""
from __future__ import annotations

import os
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

PRODUCTION_SHAPES = {False: ((16, 16), ("data", "model")),
                     True: ((2, 16, 16), ("pod", "data", "model"))}


def world_size() -> int:
    """Ranks of the initialised process group (1 without one)."""
    import torch.distributed as dist
    return dist.get_world_size() if dist.is_initialized() else 1


def rank() -> int:
    """This process's rank (0 without a process group)."""
    import torch.distributed as dist
    return dist.get_rank() if dist.is_initialized() else 0


def join_ranks(device: Optional[torch.device] = None, *,
               one_rank_group: bool = False) -> Tuple[int, int]:
    """Join the ranks ``torchrun`` describes (``RANK``, ``WORLD_SIZE``,
    ``MASTER_ADDR`` / ``MASTER_PORT`` in the environment): NCCL when
    ``device`` is the card (each rank on card ``LOCAL_RANK``), gloo on the
    CPU. An initialised group is kept as it is. Without ``torchrun`` (no
    ``WORLD_SIZE``) this process is rank 0 of 1: ``one_rank_group`` then
    makes it a group of its own (a ``HashStore``), which a 1x1 mesh
    needs; else nothing is joined. Returns (rank, world size)."""
    import torch.distributed as dist
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    if "WORLD_SIZE" not in os.environ and not one_rank_group:
        return 0, 1
    cuda = device is not None and torch.device(device).type == "cuda"
    backend = "nccl" if cuda else "gloo"
    if "WORLD_SIZE" not in os.environ:
        dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                world_size=1)
        return 0, 1
    if cuda:
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
    dist.init_process_group(backend)
    return dist.get_rank(), dist.get_world_size()


def _need(n: int, shape) -> str:
    return (f"mesh {tuple(shape)} needs {n} ranks, the process group has "
            f"{world_size()}: run under torchrun --nproc-per-node {n} "
            f"(one process a device), or on the dry run's fake process "
            f"group (python -m repro_torch.launch.dryrun)")


def mesh_over(shape: Sequence[int], axes: Sequence[str],
              device_type: str = "cpu"):
    """A ``DeviceMesh`` of ``shape`` named ``axes`` over the first
    prod(shape) ranks of the process group (row-major, as the reference
    reshapes its device list). Raises ``RuntimeError`` naming the ranks it
    needs when the group has fewer."""
    from torch.distributed.device_mesh import DeviceMesh
    n = int(np.prod(shape))
    if world_size() < n:
        raise RuntimeError(_need(n, shape))
    return DeviceMesh(device_type, torch.arange(n).reshape(tuple(shape)),
                      mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cpu"):
    """16x16 ("data", "model") or 2x16x16 ("pod", "data", "model"), the
    reference's production meshes, over the first 256 / 512 ranks (so a
    512-rank fake group builds both)."""
    shape, axes = PRODUCTION_SHAPES[multi_pod]
    return mesh_over(shape, axes, device_type)


def make_test_mesh(shape=(2, 4), axes=("data", "model"),
                   device_type: str = "cpu"):
    """A small mesh over however many ranks the process group has."""
    return mesh_over(shape, axes, device_type)


def parse_mesh(spec: str) -> Tuple[int, int]:
    """``"DxM"`` -> (D, M); empty -> (all ranks, 1), the launchers'
    default."""
    if not spec:
        return world_size(), 1
    d, m = (int(x) for x in spec.split("x"))
    return d, m


def require_ranks(d: int, m: int) -> None:
    """Exit (``SystemExit``) naming what a ``DxM`` mesh needs when the
    process group has another number of ranks."""
    if d * m != world_size():
        raise SystemExit(f"--mesh {d}x{m}: " + _need(d * m, (d, m)))


def join_mesh_ranks(spec: str, device: Optional[torch.device] = None, *,
                    one_rank_group: bool = False) -> Tuple[int, int]:
    """The launchers' ``--mesh DxM``: join the ranks ``torchrun``
    describes, exit naming what the mesh needs when the group has another
    number of ranks, then (``one_rank_group``) give a lone process the
    group of its own a 1x1 mesh needs. Returns (D, M)."""
    join_ranks(device)
    d, m = parse_mesh(spec)
    require_ranks(d, m)
    if one_rank_group:
        join_ranks(device, one_rank_group=True)
    return d, m
