"""Multi-pod dry run: build every (arch x shape) cell's step on the
production meshes without allocating, and write each cell's per-device
memory, flops and collective bytes as JSON (the port of
``repro.launch.dryrun``, with its flags and record keys).

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch mamba2-370m \\
        --shape decode_32k [--both-meshes] [--out-dir DIR] [--tag TAG]

The reference lowers and compiles each cell with XLA on 512 placeholder
devices. The port has no compiler to ask: :func:`main` first joins a
``fake`` process group of 512 ranks (its collectives move nothing), as
the reference sets ``XLA_FLAGS`` first, and :func:`lower_cell` builds the
cell's params, optimizer state, cache and batch as DTensors of
``device="meta"`` blocks laid out by the reference's rules on rank 0's
block of the (16, 16) or (2, 16, 16) mesh. :func:`run_cell` then runs the
step once under :class:`repro_torch.analysis.cost.CostMode`, which counts
rank 0's own ops and collectives. Every figure is per device and an
estimate of the port's eager step, not of a compiled one:

  * ``memory``: argument and output bytes are exact, from the local
    shapes; ``temp_bytes`` is the peak of the local tensors the step made
    while they lived (its outputs among them; nothing is donated, so
    ``alias_bytes`` is 0) and ``peak_bytes_per_device`` argument plus temp;
  * ``hlo``: :mod:`repro_torch.analysis.cost`'s flops, HBM bytes (an upper
    bound: nothing is fused) and collective bytes, which are DTensor's
    eager redistributions, not GSPMD's: the port's own figures;
  * ``lower_s`` / ``compile_s``: the ``dryrun.lower`` (build and lay out
    the inputs) and ``dryrun.compile`` (run the step) spans.

Records go under ``experiments/dryrun/`` (listed in ``.gitignore``).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
from typing import Optional, Sequence

import torch

from repro_torch import obs
from repro_torch.configs import ARCHS, get_config
from repro_torch.models.config import SHAPES, ModelConfig, ShapeConfig

OUT_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                       "experiments", "dryrun")
#: ranks of the fake process group: both production meshes fit
FAKE_WORLD = 512


def cell_skip_reason(cfg: ModelConfig, shape: ShapeConfig):
    if shape.name == "long_500k" and not cfg.subquadratic:
        return ("full-attention arch at 524k context (quadratic); skipped per "
                "assignment rules, see DESIGN.md §5")
    return None


def model_flops(cfg: ModelConfig, shape: ShapeConfig) -> float:
    """Assignment formula: 6*N*D (6*N_active*D for MoE), D = tokens/step.
    Decode: forward-only on one token per sequence + KV-cache attention."""
    n = cfg.n_active_params() if cfg.n_experts else cfg.n_params()
    if shape.kind == "train":
        return 6.0 * n * shape.global_batch * shape.seq_len
    if shape.kind == "prefill":
        return 2.0 * n * shape.global_batch * shape.seq_len
    attn_layers = sum(1 for i in range(cfg.n_layers)
                      if cfg.layer_pattern[i % len(cfg.layer_pattern)]
                      in ("attn", "lattn"))
    hd = cfg.resolved_head_dim if cfg.n_heads else 0
    ctx = shape.seq_len
    attn = 4.0 * shape.global_batch * attn_layers * cfg.n_heads * hd * min(
        ctx, max(cfg.window, ctx) if cfg.window == 0 else cfg.window)
    return 2.0 * n * shape.global_batch + attn


def auto_accum(cfg: ModelConfig) -> int:
    n = cfg.n_params()
    if cfg.n_experts:
        return 4     # MoE dispatch buffers are token-linear; keep them small
    if n > 2e10:
        return 4
    if n > 5e9:
        return 2
    return 1


def auto_kv(cfg: ModelConfig, shape: ShapeConfig, n_devices: int) -> str:
    """int8 KV quantisation when the bf16 cache would exceed ~4 GiB a
    device: the reference's rule and constant, set for a TPU v5e's HBM and
    kept for parity (ROADMAP §3)."""
    attn_layers = sum(1 for i in range(cfg.n_layers)
                      if cfg.layer_pattern[i % len(cfg.layer_pattern)]
                      in ("attn", "lattn"))
    if cfg.is_encdec:
        attn_layers = 2 * cfg.n_layers
    hd = cfg.resolved_head_dim if cfg.n_heads else 0
    bytes_bf16 = (2 * attn_layers * shape.global_batch * shape.seq_len
                  * cfg.kv_heads * hd * 2) / n_devices
    return "int8" if bytes_bf16 > 4 * 2**30 else "bfloat16"


def auto_fsdp(cfg: ModelConfig) -> bool:
    """FSDP everywhere, as the reference's baseline; ``--no-fsdp`` gives
    ZeRO-1 with ``cast_once``."""
    return True


def join_fake_group(world: int = FAKE_WORLD) -> None:
    """Make this process rank 0 of a ``fake`` process group of ``world``
    ranks, unless a group is initialised already."""
    import torch.distributed as dist
    if dist.is_initialized():
        return
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)


class _OnMeta(torch.overrides.TorchFunctionMode):
    """Factory calls that name a device make their tensor on the meta
    device instead (no generator): ``init_params`` without memory."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = dict(kwargs or {})
        if "device" in kwargs:
            kwargs["device"] = torch.device("meta")
            kwargs.pop("generator", None)
        return func(*args, **kwargs)


def meta_params(cfg: ModelConfig, dtype: Optional[torch.dtype] = None):
    """``init_params(cfg)``'s tree on the meta device, each floating leaf
    in ``dtype`` when given."""
    from repro_torch.models import model as MD
    from repro_torch.models.convert import tree_map
    with _OnMeta():
        params = MD.init_params(cfg, torch.Generator())
    if dtype is None:
        return params
    return tree_map(lambda t: t.to(dtype) if t.is_floating_point() else t,
                    params)


def lower_cell(cfg: ModelConfig, shape: ShapeConfig, mesh, *,
               remat: str = "nothing", kv_dtype: str = "bfloat16",
               fsdp: bool = True, seq_shard: bool = True,
               accum: int = 0, tp_enabled: bool = True):
    """Build one cell's step and its inputs, laid out on ``mesh``. Returns
    (the step, its argument tuple, {"lower_s"})."""
    from repro_torch.models import model as MD
    from repro_torch.optim import AdamWConfig, adamw_init
    from repro_torch.sharding import rules as SR
    from repro_torch.train.step import (make_prefill_step, make_serve_step,
                                        make_train_step)
    if accum == 0:
        accum = auto_accum(cfg)
    with obs.span("dryrun.lower", arch=cfg.name, shape=shape.name) as sp:
        if shape.kind == "train":
            fsdp = fsdp and auto_fsdp(cfg)
            rules = SR.make_rules(mesh, fsdp=fsdp, seq_shard=seq_shard,
                                  tp_enabled=tp_enabled)
            params = meta_params(cfg)
            mspec = rules.opt_shardings(params)
            # non-FSDP: the masters live as the moments do (ZeRO); the
            # compute copy is cast and laid out once a step (cast_once)
            pspec = rules.param_shardings(params) if fsdp else mspec
            opt = adamw_init(params)
            opt = {"m": SR.place(opt["m"], mesh, mspec),
                   "v": SR.place(opt["v"], mesh, mspec),
                   "step": opt["step"]}
            batch = rules.place_batch(MD.input_specs(cfg, shape,
                                                     dtype=cfg.dtype))
            step = make_train_step(cfg, AdamWConfig(), rules, remat,
                                   accum_steps=accum, cast_once=not fsdp)
            args = (SR.place(params, mesh, pspec), opt, batch)
        elif shape.kind == "prefill":
            rules = SR.make_rules(mesh, fsdp=False, seq_shard=seq_shard,
                                  tp_enabled=tp_enabled)
            params = rules.place_params(meta_params(cfg, torch.bfloat16))
            batch = MD.input_specs(cfg, shape, dtype=cfg.dtype)
            batch.pop("labels", None)
            step = make_prefill_step(cfg, rules)
            args = (params, rules.place_batch(batch))
        else:
            rules = SR.make_rules(mesh, fsdp=False, seq_shard=False,
                                  tp_enabled=tp_enabled)
            params = rules.place_params(meta_params(cfg, torch.bfloat16))
            if kv_dtype == "auto":
                kv_dtype = auto_kv(cfg, shape, mesh.size())
            cache = rules.place_cache(MD.cache_specs(cfg, shape,
                                                     kv_dtype=kv_dtype))
            dec = MD.decode_input_specs(cfg, shape)
            token = rules.place_batch({"token": dec["token"]})["token"]
            step = make_serve_step(cfg, rules)
            # the last position: a ring or the whole cache, each read
            args = (params, cache, token, shape.seq_len - 1)
    return step, args, {"lower_s": sp.duration_s}


def run_cell(arch: str, shape_name: str, *, multi_pod: bool = False,
             remat: str = "nothing", kv_dtype: str = "auto",
             fsdp: bool = True, seq_shard: bool = True, accum: int = 0,
             tp_enabled: bool = True, ssd_bf16: bool = False,
             out_dir: str = OUT_DIR, tag: str = "", verbose: bool = True,
             cfg: Optional[ModelConfig] = None,
             shape: Optional[ShapeConfig] = None,
             mesh_shape: Optional[Sequence[int]] = None):
    """One cell's record (also written as JSON). ``cfg`` / ``shape`` /
    ``mesh_shape`` replace the arch's config, the named shape and the
    production mesh (a cut-down cell: the mesh's axes are then ("data",
    "model")); the process must be in a process group with enough ranks
    (:func:`join_fake_group`)."""
    from repro_torch.analysis.cost import CostMode, local_bytes
    from repro_torch.launch import mesh as LM
    cfg = cfg or get_config(arch)
    if ssd_bf16:
        cfg = dataclasses.replace(cfg, ssd_dtype="bfloat16")
    shape = shape or SHAPES[shape_name]
    if mesh_shape is None:
        mesh_shape, axes = LM.PRODUCTION_SHAPES[multi_pod]
        mesh_name = "pod2x16x16" if multi_pod else "pod16x16"
    else:
        axes = ("data", "model")
        mesh_name = "x".join(str(n) for n in mesh_shape)
    n_dev = 1
    for n in mesh_shape:
        n_dev *= n
    if kv_dtype == "auto":
        kv_dtype = auto_kv(cfg, shape, n_dev)
    rec = {
        "arch": arch, "shape": shape_name, "mesh": mesh_name,
        "kind": shape.kind, "remat": remat, "kv_dtype": kv_dtype,
        "fsdp": fsdp, "seq_shard": seq_shard, "tag": tag,
        "accum": accum or auto_accum(cfg), "tp_enabled": tp_enabled,
        "n_devices": n_dev,
        "n_params": cfg.n_params(),
        "n_active_params": cfg.n_active_params(),
        "model_flops": model_flops(cfg, shape),
    }
    skip = cell_skip_reason(cfg, shape)
    if skip:
        rec["skipped"] = skip
        _write(rec, out_dir, arch, shape_name, mesh_name, tag)
        if verbose:
            print(f"[dryrun] SKIP {arch} x {shape_name} x {mesh_name}: {skip}")
        return rec

    mesh = LM.mesh_over(mesh_shape, axes)
    step, args, meta = lower_cell(cfg, shape, mesh, remat=remat,
                                  kv_dtype=kv_dtype, fsdp=fsdp,
                                  seq_shard=seq_shard, accum=accum,
                                  tp_enabled=tp_enabled)
    rec.update(meta)
    arg_bytes = local_bytes(args)
    mode = CostMode()
    with obs.span("dryrun.compile", arch=arch, shape=shape_name) as sp:
        with mode:
            out = step(*args)
    rec["compile_s"] = sp.duration_s
    out_bytes = local_bytes(out)
    del out
    rec["memory"] = {
        "argument_bytes": int(arg_bytes),
        "output_bytes": int(out_bytes),
        "temp_bytes": int(mode.peak),
        "alias_bytes": 0,
        "peak_bytes_per_device": int(arg_bytes + mode.peak),
        "estimate": "arguments and outputs exact from the local shapes; "
                    "temp the peak of the local tensors the eager step "
                    "made while they lived",
    }
    c = mode.cost
    rec["xla_cost_analysis"] = {"flops": c.flops,
                                "bytes accessed": c.hbm_bytes}
    rec["hlo"] = {
        "flops_per_device": c.flops,
        "hbm_bytes_per_device": c.hbm_bytes,
        "coll_bytes_per_device": c.coll_bytes,
        "coll_by_kind": c.coll_by_kind,
        "coll_count": c.coll_count,
    }
    if verbose:
        print(f"[dryrun] {arch} x {shape_name} x {mesh_name}: "
              f"run {rec['compile_s']:.1f}s, "
              f"peak/dev {rec['memory']['peak_bytes_per_device']/2**30:.2f} "
              f"GiB (estimate), flops/dev {c.flops:.3e}, "
              f"coll/dev {c.coll_bytes/2**20:.1f} MiB")
    _write(rec, out_dir, arch, shape_name, mesh_name, tag)
    return rec


def _write(rec, out_dir, arch, shape_name, mesh_name, tag=""):
    os.makedirs(out_dir, exist_ok=True)
    suffix = f"__{tag}" if tag else ""
    path = os.path.join(out_dir,
                        f"{arch}__{shape_name}__{mesh_name}{suffix}.json")
    with open(path, "w") as f:
        json.dump(rec, f, indent=1)


def main(argv=None):
    join_fake_group()
    import logging
    logging.getLogger("torch.distributed.tensor._redistribute").setLevel(
        logging.ERROR)
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.dryrun",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="all",
                    help=f"one of {ARCHS} or 'all'")
    ap.add_argument("--shape", default="all",
                    help=f"one of {tuple(SHAPES)} or 'all'")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--remat", default="nothing",
                    choices=["nothing", "dots", "everything"])
    ap.add_argument("--kv-dtype", default="auto",
                    choices=["auto", "bfloat16", "int8"])
    ap.add_argument("--no-fsdp", action="store_true")
    ap.add_argument("--no-seq-shard", action="store_true")
    ap.add_argument("--dp-only", action="store_true",
                    help="fold the model axis into data (no TP)")
    ap.add_argument("--ssd-bf16", action="store_true",
                    help="bf16 intra-chunk SSD math (ssm archs)")
    ap.add_argument("--accum", type=int, default=0,
                    help="microbatch count (0 = auto)")
    ap.add_argument("--out-dir", default=OUT_DIR)
    ap.add_argument("--tag", default="")
    args = ap.parse_args(argv)

    archs = list(ARCHS) if args.arch == "all" else [args.arch]
    shapes = list(SHAPES) if args.shape == "all" else [args.shape]
    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    failures = []
    for arch in archs:
        for shape in shapes:
            for mp in meshes:
                try:
                    run_cell(arch, shape, multi_pod=mp, remat=args.remat,
                             kv_dtype=args.kv_dtype, fsdp=not args.no_fsdp,
                             seq_shard=not args.no_seq_shard,
                             accum=args.accum,
                             tp_enabled=not args.dp_only,
                             ssd_bf16=args.ssd_bf16,
                             out_dir=args.out_dir, tag=args.tag)
                except Exception as e:  # noqa: BLE001 -- report all cells
                    failures.append((arch, shape, mp, repr(e)[:500]))
                    print(f"[dryrun] FAIL {arch} x {shape} multi_pod={mp}: "
                          f"{e!r}", file=sys.stderr)
    if failures:
        print(f"[dryrun] {len(failures)} failures", file=sys.stderr)
        sys.exit(1)
    print("[dryrun] all requested cells ran")


if __name__ == "__main__":
    main()
