"""The collectives one sharded train step issues on a mesh of gloo ranks,
by kind, and those of the MoE layers' forward among them.

    PYTHONPATH=src python examples_torch/sharded_collectives.py \
        [--arch granite-moe-3b-a800m] [--mesh 2x4] [--batch 8] [--seq 32]

It spawns D x M gloo ranks on the CPU (a ``FileStore`` in a temporary
directory); each takes ``value_and_grad`` of the arch's smoke config under
``make_rules(mesh)`` inside :class:`repro_torch.analysis.cost.CostMode`,
which counts each rank's own collectives with the reference's link model.
Rank 0 prints one JSON object: the step's collectives by kind (count and
bytes a rank), and each MoE forward's, with the bytes of one layer's
expert weights beside them (the reference budgets one expert-weight
gather a layer, not activation-sized sums: ``repro.sharding.rules``,
``act_spec("moe_w_in")``).
"""
import argparse
import json
import logging
import os
import tempfile

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def _rank(rank, world, store, args):
    torch.set_num_threads(1)
    logging.getLogger("torch.distributed.tensor._redistribute").setLevel(
        logging.ERROR)
    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            rank=rank, world_size=world)
    from repro_torch.analysis.cost import CostMode
    from repro_torch.configs import get_smoke_config
    from repro_torch.data.synthetic import SyntheticLM
    from repro_torch.launch import mesh as LM
    from repro_torch.models import model as MD
    from repro_torch.models import moe as M
    from repro_torch.sharding import rules as SR
    from repro_torch.train.loop import device_batch
    from repro_torch.train.step import value_and_grad
    cfg = get_smoke_config(args.arch)
    rules = SR.make_rules(LM.make_test_mesh(LM.parse_mesh(args.mesh)))
    params = rules.place_params(MD.init_params(
        cfg, torch.Generator().manual_seed(0)))
    batch = rules.place_batch(device_batch(
        SyntheticLM(cfg, args.seq, args.batch).batch(0), "cpu"))
    mode = CostMode(track_memory=False)
    layers = []
    moe_fwd = M.moe_fwd

    def counted(*a, **k):
        before = (dict(mode.cost.coll_count), dict(mode.cost.coll_by_kind))
        out = moe_fwd(*a, **k)
        layers.append({kind: [mode.cost.coll_count[kind]
                              - before[0].get(kind, 0),
                              mode.cost.coll_by_kind[kind]
                              - before[1].get(kind, 0.0)]
                       for kind in mode.cost.coll_count
                       if mode.cost.coll_count[kind]
                       != before[0].get(kind, 0)})
        return out
    M.moe_fwd = counted
    try:
        with SR.sharding_scope(rules), mode:
            value_and_grad(cfg)(params, batch)
    finally:
        M.moe_fwd = moe_fwd
    if rank == 0:
        w = 0
        if cfg.n_experts:
            n = 3 if cfg.glu else 2
            w = n * cfg.n_experts * cfg.d_model * cfg.d_ff * 4
        print(json.dumps({
            "arch": cfg.name, "mesh": args.mesh,
            "tokens": args.batch * args.seq,
            "step": {k: [mode.cost.coll_count[k], mode.cost.coll_by_kind[k]]
                     for k in mode.cost.coll_count},
            "moe_forward_calls": layers,
            "expert_weight_bytes_a_layer": w,
            "activation_bytes": args.batch * args.seq * cfg.d_model * 4}))
    dist.destroy_process_group()


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="granite-moe-3b-a800m")
    ap.add_argument("--mesh", default="2x4")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=32)
    args = ap.parse_args(argv)
    world = int(np.prod([int(x) for x in args.mesh.split("x")]))
    with tempfile.TemporaryDirectory() as d:
        mp.spawn(_rank, args=(world, os.path.join(d, "store"), args),
                 nprocs=world)


if __name__ == "__main__":
    main()
