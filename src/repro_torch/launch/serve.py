"""Batched serving launcher: greedy decode, then the vocab bench, on the
card.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch yi-6b \
        --batch 4 --tokens 32 [--kv-dtype int8] [--vocab-spmv 0.1 \
        [--qps 1000] [--metrics]]

The port of ``repro.launch.serve``. Every knob is a
:class:`repro_torch.launch.server.ServeConfig` field (the reference's, so
both CLIs take the same flags); the flags are generated from the
dataclass (``server.add_config_args``).

The decode loop runs ``--arch``'s smoke configuration in float32 with
random weights (``torch.Generator`` seed 0): ``--tokens - 1`` greedy steps
of ``--batch`` sequences from a zero token against a KV cache of
``--kv-dtype``, timed under the ``serve.decode`` span (the card
synchronised before it closes), and prints the reference's tok/s line.
The dense decoder is ported; a MoE, SSM, hybrid or encoder-decoder arch
exits naming the part of ROADMAP queue 1 item 13 that ports it, and
``--mesh`` (sharded weights) exits naming item 13 too.

``--records`` installs a record store (file or directory) as the
selector's default store (with ``--verify``, its ``verify_records``
summary is printed first). ``--vocab-spmv DENSITY`` then benches a
magnitude-pruned vocab projection of the arch's smoke shape: with ``--qps
0`` (the default) a closed-loop batch-1 microbench of a ``SparseLinear``
layer (``--panel``, ``--reorder``, ``--lowering``, ``--vdtype`` as in the
reference); with ``--qps RATE`` an open-loop Poisson run through the
persistent serving tier (plan cache, request coalescing;
``repro_torch.launch.server``). ``--metrics`` writes the port's global
obs registry as Prometheus text (``--metrics-path``) and a Chrome trace
(``--trace-path``).
"""
from __future__ import annotations

import argparse
import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch import obs
from repro_torch.launch import server as SV

def main(argv=None, *, device: Optional[str] = None) -> None:
    """Parse ``argv``, decode, then run the vocab bench or the serving tier.
    ``device`` (not a flag) is where the model and the plans go: None is
    the card, as for every entry point of the port."""
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.launch.serve",
        description="greedy decode of an LM smoke config, then bench or "
                    "serve a pruned vocab projection through the port's "
                    "SpMV kernels and serving tier")
    SV.add_config_args(ap)
    args = ap.parse_args(argv)
    config = SV.config_from_args(args)
    SV.refuse_decode_knobs(config)

    from repro_torch.core import selector as S
    if config.records:
        store = S.load_records(config.records)
        if config.verify:
            from repro_torch.analysis.verify import verify_records
            print(verify_records(store).summary())
        S.set_default_store(store)

    from repro_torch.configs import get_smoke_config
    cfg = dataclasses.replace(get_smoke_config(config.arch), dtype="float32")
    try:
        _decode(config, cfg, device)
    except NotImplementedError as e:
        raise SystemExit(str(e)) from None

    if config.vocab_spmv > 0 and config.qps > 0:
        _serve_vocab(config, cfg.vocab, cfg.d_model, device)
    elif config.vocab_spmv > 0:
        _bench_vocab(config, cfg.vocab, cfg.d_model, device)

    if config.metrics:
        # one scrape covers the whole launcher: decode span, serving-tier
        # counters and histograms, plan passes -- all on the port's global
        # registry
        reg = obs.get_registry()
        obs.export.dump_prometheus(reg, config.metrics_path)
        obs.export.dump_chrome_trace(reg, config.trace_path)
        print(f"metrics: {config.metrics_path} (Prometheus), "
              f"{config.trace_path} (chrome://tracing)")


def _decode(config: SV.ServeConfig, cfg, device: Optional[str]) -> None:
    """The greedy decode loop: ``config.tokens - 1`` steps of
    ``config.batch`` sequences from a zero token; prints the tok/s line."""
    from repro_torch.kernels.ops import resolve_device
    from repro_torch.models import model as MD
    from repro_torch.train.step import make_serve_step
    dev = resolve_device(device)
    params = MD.init_params(cfg, torch.Generator(device=dev).manual_seed(0))
    cache = MD.init_cache(cfg, config.batch, config.tokens,
                          kv_dtype=config.kv_dtype, device=dev)
    step = make_serve_step(cfg)
    with obs.span("serve.decode", arch=config.arch, batch=config.batch,
                  tokens=config.tokens) as sp:
        greedy_decode(step, params, cache, config.batch, config.tokens - 1)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
    dt = sp.duration_s
    print(f"{config.arch}: {config.batch}x{config.tokens} tokens, "
          f"{config.batch * (config.tokens - 1) / dt:.1f} tok/s "
          f"(kv={config.kv_dtype}, mesh={config.mesh or '1 device'})")


def greedy_decode(step, params, cache, batch: int, steps: int):
    """``steps`` greedy steps of ``batch`` sequences from a zero token
    through ``step`` (``make_serve_step``) against ``cache``, on the
    cache's device. Returns (the last tokens (batch, 1), the cache)."""
    from repro_torch.models.convert import tree_leaves
    device = next(tree_leaves(cache)).device
    tok = torch.zeros((batch, 1), dtype=torch.long, device=device)
    for t in range(steps):
        tok, cache = step(params, cache, tok, t)
    return tok, cache


def _serve_vocab(config: SV.ServeConfig, vocab: int, d_model: int,
                 device: Optional[str]) -> None:
    """The persistent-tier path: plan cache + coalescing + open-loop
    Poisson traffic at ``--qps`` (records already installed above)."""
    srv = SV.start(config, install_records=False, device=device)
    rng = np.random.default_rng(0)
    xs = [torch.from_numpy(rng.standard_normal(d_model).astype(np.float32))
          .to(srv.plan.device) for _ in range(8)]
    with srv:
        res = SV.open_loop(srv, xs, config.qps,
                           duration_s=config.duration_s)
        st = srv.stats()
    c = st["cache"]
    print(f"vocab_serve[{vocab}x{d_model}@{config.vocab_spmv}]: "
          f"offered={res['qps_offered']:.0f}qps "
          f"achieved={res['qps_achieved']:.0f}qps "
          f"p50={res['p50_us']:.0f}us p99={res['p99_us']:.0f}us "
          f"shed={res['shed']} expired={res['expired']} "
          f"errors={res['errors']} "
          f"(batches={st['batches']}, mean_batch={st['mean_batch']:.1f}, "
          f"degraded={st['degraded']}, restarts={st['worker_restarts']}, "
          f"cache {c['hits']}h/{c['misses']}m/{c['evictions']}e)")
    fr = obs.faults.get_faults()
    if fr:
        print("faults: " + ", ".join(
            f"{name}@{s['rate']:g} {s['fired']}/{s['checks']}"
            for name, s in fr.stats().items()))


def _bench_vocab(config: SV.ServeConfig, vocab: int, d_model: int,
                 device: Optional[str]) -> None:
    """The closed-loop batch-1 microbench (``--qps`` left at 0)."""
    from repro_torch.core.sparse_linear import SparseLinear
    kw = {}
    if config.panel:
        pr, xw, cb = (int(v) for v in config.panel.split(","))
        kw = dict(layout="panels", pr=pr, xw=xw, cb=cb)
    if config.reorder:
        kw["reorder"] = config.reorder
    kw["lowering"] = config.lowering
    kw["vdtype"] = config.vdtype
    rng = np.random.default_rng(0)
    w = rng.standard_normal((vocab, d_model)).astype(np.float32)
    dtype = np.float32 if config.vdtype == "auto" else None
    lin = SparseLinear.from_dense(w, density=config.vocab_spmv, dtype=dtype,
                                  nvec=1, device=device, **kw)
    h = lin.plan
    x = torch.from_numpy(rng.standard_normal(d_model).astype(np.float32)) \
        .to(h.device)
    if config.verify:
        # the admission gate: prove the plan's invariants before the
        # first request touches it (raises on any violation)
        from repro_torch.analysis.verify import verify_plan
        report = verify_plan(h, nvec=1).raise_if_failed()
        print(f"verify: plan ok ({len(report.checked)} rules checked)")

    def ready():
        if h.device.type == "cuda":
            torch.cuda.synchronize(h.device)

    lin(x)
    ready()
    iters = 16
    with obs.span("serve.vocab_bench", iters=iters) as sp:
        for _ in range(iters):
            lin(x)
        ready()
    us = sp.duration_s / iters * 1e6
    if h.is_reordered:
        reo_str = (f", reorder={h.strategy}"
                   f"[fused_rows={int(h.rows_fused)}]")
    elif config.reorder:
        reo_str = f", reorder={config.reorder}[declined]"
    else:
        reo_str = ""
    cfg_str = ",".join(f"{k}={v}" for k, v in h.meta
                       if k in ("pr", "xw", "cb", "lowering", "vdtype") and
                       v != "")
    src = ("explicit --panel" if config.panel
           else ("tuned" if config.records else "defaults"))
    print(f"vocab_spmv[{vocab}x{d_model}@{config.vocab_spmv}]: "
          f"{us:.1f} us/call ({h.layout}, {cfg_str}, config={src}"
          f"{reo_str})")


if __name__ == "__main__":
    main()
