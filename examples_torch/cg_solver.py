"""Conjugate-gradient solver with every matvec through the SPC5 kernels --
the paper's motivating use case (Krylov subspace iterations).

    PYTHONPATH=src python examples_torch/cg_solver.py [--n 2000] \
        [--distributed] [--device cpu]
    PYTHONPATH=src torchrun --nproc-per-node N \
        examples_torch/cg_solver.py --distributed

The port of ``examples/cg_solver.py``. It runs on the card unless
``--device cpu`` is given. Each matvec is ``ops.spmv`` through the plan's
kernel (the plain PyTorch version on the CPU); the reference's
non-distributed branch calls its jnp oracle instead.

``--distributed`` runs the row-partitioned SpMV over a process group,
one shard a rank (``distributed.shard_matrix(..., rank=rank)`` and
``make_distributed_spmv``): under torchrun, NCCL with one GPU a rank, or
gloo with ``--device cpu``; without torchrun's environment, a group of one
rank in this process, as the reference runs on one device. The line before
the last gives the launches of the SpMV kernels (none on the CPU).
"""
import argparse
import json
import os

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core import distributed as D
from repro_torch.core import formats as F
from repro_torch.core import matgen
from repro_torch.kernels import ops, spc5_spmv, spc5_spmv_desc


def make_spd(n: int, seed: int = 0) -> np.ndarray:
    csr = matgen.banded(n, 4, 1.0, seed=seed)
    a = csr.to_dense()
    a = (a + a.T) / 2
    a += np.eye(n) * (np.abs(a).sum(1).max() + 1.0)
    return a.astype(np.float32)


def launches():
    """The SpMV kernels' launches so far, those that launched."""
    return {k: v for mod in (spc5_spmv, spc5_spmv_desc)
            for k, v in mod.LAUNCHES.items() if v}


def join_group(device: torch.device):
    """Join torchrun's process group (its environment names the rank and
    the world), or make a group of one rank in this process. Returns the
    rank's device, rank and world size."""
    backend = "nccl" if device.type == "cuda" else "gloo"
    if "RANK" in os.environ:
        dist.init_process_group(backend)
        if device.type == "cuda":
            device = torch.device("cuda", int(os.environ["LOCAL_RANK"]))
            torch.cuda.set_device(device)
    else:
        dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                world_size=1)
    return device, dist.get_rank(), dist.get_world_size()


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=2000)
    ap.add_argument("--iters", type=int, default=300)
    ap.add_argument("--distributed", action="store_true")
    ap.add_argument("--device", default=None,
                    help="'cpu' for the plain PyTorch versions on the host "
                         "(default: the card)")
    args = ap.parse_args(argv)
    device = ops.resolve_device(args.device)

    a = make_spd(args.n)
    csr = F.csr_from_dense(a)
    mat = F.csr_to_spc5(csr, 2, 4)
    rank = 0
    if args.distributed:
        device, rank, ndev = join_group(device)
        sh = D.shard_matrix(mat, ndev, cb=256, device=device, rank=rank)
        matvec = D.make_distributed_spmv(sh)
        what = f"distributed SpMV over {ndev} ranks ({sh.layout} + " \
               f"{sh.lowering})"
    else:
        plan = ops.prepare(mat, cb=256, device=device)
        matvec = lambda p: ops.spmv(plan, p)            # noqa: E731
        what = f"SpMV ({plan.layout} + {plan.lowering})"
    say = print if rank == 0 else (lambda *_: None)
    say(f"A: {a.shape}, nnz={csr.nnz}, beta(2,4) "
        f"avg={mat.avg_nnz_per_block:.2f}; {what} on {device}")

    b = torch.from_numpy(np.random.default_rng(1).standard_normal(
        args.n).astype(np.float32)).to(device)
    x = torch.zeros(args.n, device=device)
    r = b
    p = r
    rs = r @ r
    for it in range(args.iters):
        ap_ = matvec(p)
        alpha = rs / (p @ ap_)
        x = x + alpha * p
        r = r - alpha * ap_
        rs_new = r @ r
        if it % 25 == 0:
            say(f"  iter {it:4d} |r| = {float(rs_new.sqrt()):.3e}")
        if float(rs_new) < 1e-10:
            break
        p = r + (rs_new / rs) * p
        rs = rs_new
    xh, bh = x.cpu().numpy(), b.cpu().numpy()
    res = np.linalg.norm(a @ xh - bh) / np.linalg.norm(bh)
    if args.distributed:
        dist.destroy_process_group()
    say(f"launches: {json.dumps(launches(), sort_keys=True)}")
    say(f"converged: relative residual {res:.2e} after {it + 1} iters")


if __name__ == "__main__":
    main()
