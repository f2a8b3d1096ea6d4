"""The port's sharded train and decode steps on 8 gloo ranks (a 2x4
("data", "model") mesh, DTensor) against the reference's on 8 fake CPU
devices (the same mesh, GSPMD).

Both packages get the same float32 params (the port's ``init_params``,
carried leaf for leaf into the reference) and the same ``SyntheticLM``
batch. The reference runs in one subprocess (``run_with_devices``), the
port's 8 ranks in one spawn; the two run side by side and each writes
rank 0's figures to an ``.npz``. Cases: the train step of five smoke
configs under ``make_rules(mesh)`` (FSDP x TP), yi-6b also under
``cast_once`` and ``accum_steps=2``; the gradients of each; 8 greedy
decode steps of each under the serve rules.

Tolerances: loss and metrics within ``TOL`` of themselves, each gradient
leaf and each new param leaf within ``TOL`` of its max|ref|, decode
logits within ``TOL`` of max|logits| and greedy tokens equal. The step
runs AdamW with ``eps=1``: its first step then moves each entry by about
lr x its gradient, where ``eps=1e-8`` moves an entry whose gradient is
float noise by +-lr either way (``tests/test_torch_train_step.py`` holds
the default AdamW on identical gradients). granite-moe dispatches in G = 2
groups, one a data shard, on both sides: the test also shows that its
sharded loss differs from its one-group loss, so the groups' drops are
what match.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from conftest import SRC

ARCHS = ("yi-6b", "granite-moe-3b-a800m", "mamba2-370m",
         "recurrentgemma-9b", "seamless-m4t-medium")
CASES = [(a, "plain") for a in ARCHS] + [("yi-6b", "cast_once"),
                                         ("yi-6b", "accum2")]
TOL = 1e-5
SEQ, BATCH, DEC_B, DEC_S, DEC_STEPS = 32, 4, 4, 16, 8
OPT = dict(lr=1e-3, eps=1.0, weight_decay=0.1)


def _flat(tree, pre=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, pre + k + "/"))
        else:
            out[pre + k] = v
    return out


def _unflat(flat, prefix):
    tree = {}
    for key, v in flat.items():
        if not key.startswith(prefix):
            continue
        node = tree
        parts = key[len(prefix):].split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return tree


REFERENCE = r'''
import json, sys
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import Mesh
from repro.configs import get_smoke_config
from repro.models import model as MD
from repro.optim import AdamWConfig, adamw_init
from repro.sharding.rules import make_rules, sharding_scope
from repro.train.step import make_train_step

inp, out_path, cases, opt, dec = sys.argv[1], sys.argv[2], \
    json.loads(sys.argv[3]), json.loads(sys.argv[4]), json.loads(sys.argv[5])
z = dict(np.load(inp))

def unflat(prefix):
    tree = {}
    for key, v in z.items():
        if key.startswith(prefix):
            node = tree
            parts = key[len(prefix):].split("/")
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = jnp.asarray(v)
    return tree

def flat(tree, pre):
    return {pre + "/".join(str(getattr(k, "key", k)) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_leaves_with_path(tree)}

mesh = Mesh(np.asarray(jax.devices()).reshape(2, 4), ("data", "model"))
res = {}
for arch, kind in cases:
    cfg = get_smoke_config(arch)
    case = f"{arch}/{kind}"
    params = unflat(f"{arch}/params/")
    batch = unflat(f"{arch}/batch/")
    rules = make_rules(mesh)
    params = jax.device_put(params, rules.param_shardings(params))
    batch = {k: jax.device_put(v, rules.input_sharding(v.shape, k))
             for k, v in batch.items()}
    step = jax.jit(make_train_step(
        cfg, AdamWConfig(**opt), rules, cast_once=kind == "cast_once",
        accum_steps=2 if kind == "accum2" else 1))
    new, _, m = step(params, adamw_init(params), batch)
    for k, v in m.items():
        res[f"{case}/m/{k}"] = np.asarray(v)
    res.update(flat(new, f"{case}/p/"))
    if kind != "plain":
        continue
    def loss(p, b):
        with sharding_scope(rules):
            return MD.forward_loss(p, b, cfg)[0]
    res.update(flat(jax.jit(jax.grad(loss))(params, batch), f"{case}/g/"))
    srules = make_rules(mesh, fsdp=False, seq_shard=False)
    sp = jax.device_put(params, srules.param_shardings(params))
    cache = MD.init_cache(cfg, dec["b"], dec["s"])
    cache = jax.device_put(cache, srules.cache_shardings(cache))
    def dstep(p, c, t, pos):
        with sharding_scope(srules):
            return MD.decode_step(p, c, t, pos, cfg)
    dstep = jax.jit(dstep)
    tok = jnp.zeros((dec["b"], 1), jnp.int32)
    toks, logits = [], []
    for t in range(dec["steps"]):
        lg, cache = dstep(sp, cache, tok, jnp.asarray(t))
        tok = jnp.argmax(lg, axis=-1).astype(jnp.int32)[:, None]
        toks.append(np.asarray(tok))
        logits.append(np.asarray(lg))
    res[f"{case}/tok"] = np.stack(toks)
    res[f"{case}/logits"] = np.stack(logits)
np.savez(out_path, **res)
'''


def _port_rank(rank, world, store, inp, out_path):
    """One gloo rank: every case on the 2x4 mesh; rank 0 saves."""
    import logging
    torch.set_num_threads(1)
    logging.getLogger("torch.distributed.tensor._redistribute").setLevel(
        logging.ERROR)
    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            rank=rank, world_size=world)
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch import mesh as LM
    from repro_torch.models import model as MD
    from repro_torch.optim import AdamWConfig, adamw_init
    from repro_torch.sharding import rules as SR
    from repro_torch.train.step import (make_serve_step, make_train_step,
                                        value_and_grad)
    z = {k: torch.from_numpy(v) for k, v in np.load(inp).items()}
    mesh = LM.make_test_mesh((2, 4))
    res = {}
    for arch, kind in CASES:
        cfg = get_smoke_config(arch)
        case = f"{arch}/{kind}"
        params = _unflat(z, f"{arch}/params/")
        batch = _unflat(z, f"{arch}/batch/")
        rules = SR.make_rules(mesh)
        dp = rules.place_params(params)
        db = rules.place_batch(batch)
        step = make_train_step(cfg, AdamWConfig(**OPT), rules,
                               cast_once=kind == "cast_once",
                               accum_steps=2 if kind == "accum2" else 1)
        new, _, m = step(dp, adamw_init(dp), db)
        for k, v in m.items():
            res[f"{case}/m/{k}"] = v.numpy()
        for k, v in _flat(new).items():
            res[f"{case}/p/{k}"] = SR.full(v).numpy()
            res[f"{case}/placed/{k}"] = np.asarray(
                v.placements == _flat(dp)[k].placements)
        if kind != "plain":
            continue
        with SR.sharding_scope(rules):
            (_, _), g = value_and_grad(cfg)(dp, db)
        for k, v in _flat(g).items():
            res[f"{case}/g/{k}"] = SR.full(v).numpy()
        if cfg.n_experts:
            (l1, _), _ = value_and_grad(cfg)(params, batch)
            res[f"{case}/one_group_loss"] = l1.numpy()
        srules = SR.make_rules(mesh, fsdp=False, seq_shard=False)
        sp = srules.place_params(params)
        cache = srules.place_cache(MD.init_cache(cfg, DEC_B, DEC_S,
                                                 device="cpu"))
        serve = make_serve_step(cfg, srules)
        tok = torch.zeros((DEC_B, 1), dtype=torch.long)
        toks, logits = [], []
        for t in range(DEC_STEPS):
            with SR.sharding_scope(srules):
                lg, cache = MD.decode_step(sp, cache, tok, t, cfg)
            full = SR.full(lg)
            tok = full.argmax(-1)[:, None]
            toks.append(tok.numpy())
            logits.append(full.numpy())
        # the step builder's own token, on the same cache
        res[f"{case}/serve_tok"] = SR.full(
            serve(sp, cache, tok, DEC_STEPS)[0]).numpy()
        res[f"{case}/tok"] = np.stack(toks)
        res[f"{case}/logits"] = np.stack(logits)
    if rank == 0:
        np.savez(out_path, **res)
    dist.barrier()
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(reference figures, port figures): the reference's subprocess and
    the port's 8 ranks, started together."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.data.synthetic import SyntheticLM
    from repro_torch.models import model as MD
    d = tmp_path_factory.mktemp("sharding_parity")
    inp = str(d / "inputs.npz")
    arrays = {}
    for arch in ARCHS:
        cfg = get_smoke_config(arch)
        params = MD.init_params(cfg, torch.Generator().manual_seed(7))
        for k, v in _flat(params).items():
            arrays[f"{arch}/params/{k}"] = v.numpy()
        for k, v in SyntheticLM(cfg, SEQ, BATCH, seed=1).batch(0).items():
            arrays[f"{arch}/batch/{k}"] = v
    np.savez(inp, **arrays)
    env = dict(os.environ, PYTHONPATH=SRC + os.pathsep
               + os.environ.get("PYTHONPATH", ""),
               XLA_FLAGS="--xla_force_host_platform_device_count=8",
               JAX_PLATFORMS="cpu")
    ref = subprocess.Popen(
        [sys.executable, "-c", REFERENCE, inp, str(d / "ref.npz"),
         json.dumps(CASES), json.dumps(OPT),
         json.dumps(dict(b=DEC_B, s=DEC_S, steps=DEC_STEPS))],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        mp.spawn(_port_rank, args=(8, str(d / "store"), inp,
                                   str(d / "port.npz")), nprocs=8)
    finally:
        out, err = ref.communicate(timeout=600)
    assert ref.returncode == 0, err[-4000:]
    return dict(np.load(d / "ref.npz")), dict(np.load(d / "port.npz"))


def _close(got, want, tol=TOL):
    m = float(np.abs(want).max())
    err = float(np.abs(got.astype(np.float64) - want).max())
    assert err <= tol * m or (m == 0 and err == 0), (err, m)


@pytest.mark.parametrize("arch,kind", CASES)
def test_sharded_train_step_matches_the_references(runs, arch, kind):
    """Metrics within TOL of themselves, each new param leaf within TOL of
    its max, and each new param laid out as its master was."""
    ref, port = runs
    case = f"{arch}/{kind}"
    ms = [k for k in ref if k.startswith(case + "/m/")]
    assert ms
    for k in ms:
        assert float(port[k]) == pytest.approx(float(ref[k]), rel=TOL,
                                               abs=1e-12), k
    ps = [k for k in ref if k.startswith(case + "/p/")]
    assert ps and set(ps) == {k for k in port if k.startswith(case + "/p/")}
    for k in ps:
        _close(port[k], ref[k])
        assert bool(port[k.replace("/p/", "/placed/")]), k
    if arch == "granite-moe-3b-a800m":
        assert abs(float(port[case + "/one_group_loss"])
                   - float(port[case + "/m/loss"])) > 1e-4


@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_gradients_match_the_references(runs, arch):
    ref, port = runs
    case = f"{arch}/plain"
    gs = [k for k in ref if k.startswith(case + "/g/")]
    assert gs and set(gs) == {k for k in port if k.startswith(case + "/g/")}
    for k in gs:
        _close(port[k], ref[k])


@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_greedy_decode_matches_the_references(runs, arch):
    """8 greedy steps under the serve rules: equal tokens, logits within
    TOL of max|logits|; ``make_serve_step`` under the rules gives the
    argmax of the next step."""
    ref, port = runs
    case = f"{arch}/plain"
    assert np.array_equal(port[case + "/tok"], ref[case + "/tok"])
    _close(port[case + "/logits"], ref[case + "/logits"])
    assert port[case + "/serve_tok"].shape == (DEC_B, 1)
