"""Distributed SPC5 SpMV over a ``torch.distributed`` process group (the
paper's parallel section, Fig. 4).

The port's counterpart of ``repro.core.distributed``. The paper's
shared-memory design maps onto ranks as the reference maps it onto mesh
devices:

  paper                                  | here
  ---------------------------------------+--------------------------------
  OpenMP threads, static block balance   | ranks, the same interval split
  per-NUMA-node copies of the 4 arrays   | per-rank shards (``rank=``)
  x allocated on master, read by all     | x replicated on every rank
  y merged without synchronisation       | disjoint row slabs; one
                                         | all_gather AFTER compute

The sharding itself is the plan pipeline's shard pass
(:func:`repro_torch.core.plan.shard_plan`): the matrix is tuned, reordered
and row-partitioned, and each slab is stacked by its layout's
``shard_build`` hook into a :class:`~repro_torch.core.plan.ShardedPlan`. So
:func:`make_distributed_spmv` does not branch on the layout or lowering:
it hands the rank's shard to :func:`repro_torch.core.plan.
local_execute_spmv`, which launches the layout's SpMV kernel on the card
(its plain version on the CPU).

A group has one rank a device: NCCL with one GPU a rank (``torchrun
--nproc-per-node N``), or gloo on the CPU. One process may also hold every
shard on one device and run them one after another
(:meth:`ShardedPlan.local`); :func:`_assemble` then builds y from the slabs
as the gather path does.
"""
from __future__ import annotations

import warnings
from typing import Optional

import torch
import torch.distributed as dist

from repro_torch import obs

from . import formats as F
from . import plan as PL
from . import selector as S

# Legacy names: both sharded containers are the one ShardedPlan (inspect
# ``sh.layout``, a plan-registry key, to tell them apart).
ShardedPlan = PL.ShardedPlan
ShardedSPC5 = PL.ShardedPlan
ShardedSPC5Panels = PL.ShardedPlan


def shard_matrix(mat: F.SPC5Matrix, ndev: int, *, layout: str = "auto",
                 cb: Optional[int] = None, dtype=None, vdtype: str = "auto",
                 pr: Optional[int] = None, xw: int = 512,
                 store: Optional[S.RecordStore] = None,
                 config: Optional[S.PanelConfig] = None, tune: bool = True,
                 reorder=None, lowering: str = "auto",
                 partition: str = "auto", device=None,
                 rank: Optional[int] = None) -> PL.ShardedPlan:
    """Partition, build and stack ``mat`` into ``ndev`` row shards: the one
    distributed prepare entry point, a thin wrapper over
    :func:`repro_torch.core.plan.shard_plan` (every keyword as there).

    ``layout`` picks the shards' layout ("auto": the tuned or explicit
    config's, panels where ``pr`` is given, else whole-vector; ``cb=None``
    takes the layout's default). With no ``pr``, ``cb`` or ``config`` and
    a record store of the plan's device (``store``, or the selector's
    default), the layout is tuned at ``workers=ndev`` and clamped to one
    shard's rows; ``config`` is the explicit escape hatch and
    ``tune=False`` keeps the defaults. ``reorder`` permutes the whole
    matrix first, and :func:`make_distributed_spmv` applies the
    permutation. ``lowering`` and ``vdtype`` resolve as on ``ops.prepare``,
    except that int8 demotes to bf16 (traced). ``partition`` is "blocks",
    "nnz" or "auto".

    The plan goes to ``device``: the card unless the caller passes
    ``device="cpu"`` (with no card, None raises ``RuntimeError``). With
    ``rank=k`` the device holds shard k's tensors only, the rank's share of
    a process group; without it, every shard."""
    return PL.shard_plan(mat, ndev, layout=layout, cb=cb, dtype=dtype,
                         vdtype=vdtype, pr=pr, xw=xw, store=store,
                         config=config, tune=tune, reorder=reorder,
                         lowering=lowering, partition=partition,
                         device=device, rank=rank)


def shard_matrix_panels(mat: F.SPC5Matrix, ndev: int, pr: int = 512,
                        cb: int = 64, xw: int = 512, dtype=None, *,
                        device=None) -> PL.ShardedPlan:
    """Deprecated, as in the reference: use ``shard_matrix(mat, ndev,
    layout="panels", pr=..., tune=False)`` (explicit panel geometry, no
    tuning, the mask lowering)."""
    warnings.warn(
        "distributed.shard_matrix_panels is deprecated; use "
        "shard_matrix(mat, ndev, layout='panels', pr=..., cb=..., xw=..., "
        "tune=False)",
        DeprecationWarning, stacklevel=2)
    return shard_matrix(mat, ndev, layout=PL.LAYOUT_PANELS, pr=pr, cb=cb,
                        xw=xw, dtype=dtype, tune=False,
                        lowering=PL.LOWERING_MASK, device=device)


def _assemble(slabs: torch.Tensor, row_start: torch.Tensor,
              nrows: int) -> torch.Tensor:
    """y (nrows,) from the shards' slabs ``slabs`` (ndev, rows_max), each
    added in at its first row, as the reference's ``finish`` does. A slab
    reaches past its shard's rows (into the next shard's, or past nrows)
    only with rows that no nonzero of its shard touches, which come out
    exactly 0, so the overlapping adds are exact in any order."""
    rows_max = slabs.shape[1]
    idx = (row_start.long()[:, None]
           + torch.arange(rows_max, device=slabs.device)[None, :])
    y = torch.zeros(nrows + rows_max, dtype=slabs.dtype, device=slabs.device)
    return y.index_add_(0, idx.reshape(-1), slabs.reshape(-1))[:nrows]


def make_distributed_spmv(sh: PL.ShardedPlan, group=None,
                          gather: bool = True):
    """y = A @ x over a process group of ``sh.ndev`` ranks (None: the
    default group), rank k computing shard k's row slab.

    Every rank calls the returned function with the whole x (float32 on the
    plan's device). With ``gather=True`` the slabs are all-gathered (the
    one collective, after the compute) and assembled into the whole y on
    every rank; with ``gather=False`` the rank gets its own ``(1,
    rows_max)`` slab. A reordering on the plan is applied here: x is
    gathered by ``col_perm`` before the shard runs, and the gathered y is
    put back in the original row order by ``row_iperm`` (a ``gather=False``
    slab stays in the permuted row order; ``sh.row_iperm`` maps it back).
    Each call runs under the span ``distributed.spmv``."""
    ndev = sh.ndev
    world = dist.get_world_size(group)
    if world != ndev:
        raise ValueError(f"the plan has {ndev} shards, the group {world} "
                         f"ranks")
    local = sh.local(dist.get_rank(group))

    def run(x: torch.Tensor) -> torch.Tensor:
        with obs.span("distributed.spmv", layout=sh.layout, ndev=ndev,
                      lowering=sh.lowering):
            if sh.col_perm is not None:
                x = x.index_select(0, sh.col_perm)
            y_loc = PL.local_execute_spmv(sh, local, x)
            if not gather:
                return y_loc[None]
            slabs = [torch.empty_like(y_loc) for _ in range(ndev)]
            dist.all_gather(slabs, y_loc, group=group)
            y = _assemble(torch.stack(slabs), sh.row_start, sh.nrows)
            if sh.row_iperm is not None:
                y = y.index_select(0, sh.row_iperm)
            return y

    return run
