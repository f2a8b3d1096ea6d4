"""The port's optimizer (``repro_torch.optim``) against the reference's
(``repro.optim``) on the CPU: AdamW, its clipping, the cosine schedule
and int8 gradient compression, the last on 4 gloo ranks.

Every case of ``tests/test_train.py`` that tests these modules is here
with the port in place of the reference, and each module is also held
against the reference on the same inputs. Tolerances: float32 elementwise
updates within 1e-6 of each leaf's max (both packages compute the same
formula; the global norm sums in another order); the schedule within
1e-6; the quantised payloads equal, their scales within 1 ulp.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro.optim import AdamWConfig as JAdamWConfig
from repro.optim import adamw_init as j_adamw_init
from repro.optim import adamw_update as j_adamw_update
from repro.optim import compress as JC
from repro.optim.adamw import global_norm as j_global_norm
from repro.optim.schedule import cosine_schedule as j_cosine_schedule
from repro_torch.models import convert as CV
from repro_torch.optim import AdamWConfig, adamw_init, adamw_update
from repro_torch.optim import compress as C
from repro_torch.optim.adamw import global_norm
from repro_torch.optim.schedule import cosine_schedule

TOL = 1e-6
NRANKS = 4


def _close(got, ref, tol=TOL):
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    ref = np.asarray(ref)
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=tol * max(float(np.abs(ref).max()), 1e-30))


def _tree(seed, scale=1.0):
    """A parameter-like tree: matrices, a stacked tensor and vectors."""
    rng = np.random.default_rng(seed)
    f = np.float32
    return {"w": (rng.standard_normal((4, 3)) * scale).astype(f),
            "units": {"0": {"k": (rng.standard_normal((2, 5, 6)) * scale)
                            .astype(f),
                            "norm": (rng.standard_normal((2, 6)) * scale)
                            .astype(f)}},
            "b": (rng.standard_normal((7,)) * scale).astype(f)}


def _torch(tree):
    return CV.params_from_numpy(tree, "cpu")


def _jax(tree):
    return jax.tree.map(jnp.asarray, tree)


def _leaves_close(got, ref, tol=TOL):
    """Two trees of one structure, leaf by path."""
    got, ref = _flat(got), _flat(jax.tree.map(np.asarray, ref))
    assert set(got) == set(ref)
    for path, b in ref.items():
        _close(got[path], b, tol)


# ----------------------------------------------------------------------------
# the cases of tests/test_train.py
# ----------------------------------------------------------------------------

def test_adamw_against_reference():
    """One AdamW step vs a hand-rolled numpy reference."""
    rng = np.random.default_rng(0)
    p = {"w": torch.from_numpy(rng.standard_normal((4, 3)).astype(np.float32))}
    g = {"w": torch.from_numpy(rng.standard_normal((4, 3)).astype(np.float32))}
    cfg = AdamWConfig(lr=0.1, b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.0,
                      clip_norm=1e9)
    st = adamw_init(p)
    new_p, new_st, _ = adamw_update(p, g, st, cfg)
    gm = g["w"].numpy()
    m = 0.1 * gm
    v = 0.05 * gm * gm
    mh, vh = m / 0.1, v / 0.05
    ref = p["w"].numpy() - 0.1 * mh / (np.sqrt(vh) + 1e-8)
    np.testing.assert_allclose(new_p["w"].numpy(), ref, atol=1e-5)
    assert int(new_st["step"]) == 1
    assert new_st["step"].dtype == torch.int32 and new_st["step"].dim() == 0


def test_adamw_clipping():
    p = {"w": torch.ones((2, 2))}
    g = {"w": torch.full((2, 2), 100.0)}
    cfg = AdamWConfig(lr=1.0, clip_norm=1.0, weight_decay=0.0)
    _, _, metrics = adamw_update(p, g, adamw_init(p), cfg)
    assert float(metrics["grad_norm"]) == pytest.approx(200.0, rel=1e-4)


def test_cosine_schedule():
    lr = cosine_schedule(1.0, warmup=10, total=110, floor_frac=0.1)
    assert float(lr(torch.tensor(0))) == pytest.approx(0.0)
    assert float(lr(torch.tensor(5))) == pytest.approx(0.5)
    assert float(lr(torch.tensor(10))) == pytest.approx(1.0, rel=1e-3)
    assert float(lr(torch.tensor(110))) == pytest.approx(0.1, rel=1e-3)


def test_quantize_roundtrip_error():
    rng = np.random.default_rng(1)
    g = torch.from_numpy(rng.standard_normal((64, 32)).astype(np.float32))
    q, s = C.quantize(g)
    back = C.dequantize(q, s)
    assert float((back - g).abs().max()) <= float(s.max()) * 1.01


# ----------------------------------------------------------------------------
# against the reference on the same inputs
# ----------------------------------------------------------------------------

@pytest.mark.parametrize("step", [0, 1, 5, 10, 37, 110, 200])
@pytest.mark.parametrize("warmup,total,floor", [(10, 110, 0.1),
                                                (0, 50, 0.0), (20, 300, 0.1)])
def test_cosine_schedule_matches_the_reference(step, warmup, total, floor):
    """Int and 0-d int32 tensor steps give the reference's float32 lr."""
    ref = float(j_cosine_schedule(3e-4, warmup, total, floor)(
        jnp.asarray(step, jnp.int32)))
    lr = cosine_schedule(3e-4, warmup, total, floor)
    for s in (step, torch.tensor(step, dtype=torch.int32)):
        got = lr(s)
        assert got.dtype == torch.float32 and got.dim() == 0
        assert float(got) == pytest.approx(ref, rel=TOL, abs=1e-12)


@pytest.mark.parametrize("clip", [1e9, 1.0, 0.05])
@pytest.mark.parametrize("wd", [0.0, 0.1])
@pytest.mark.parametrize("schedule", [False, True])
def test_adamw_update_matches_the_reference(clip, wd, schedule):
    """Three steps on the same params and gradients: new params, m, v,
    step and both metrics within ``TOL``; weight decay only on leaves of
    two or more dims, as the reference's."""
    p = _tree(0)
    kw = dict(b1=0.9, b2=0.95, eps=1e-8, weight_decay=wd, clip_norm=clip)
    jcfg = JAdamWConfig(lr=j_cosine_schedule(0.1, 2, 10) if schedule
                        else 0.1, **kw)
    tcfg = AdamWConfig(lr=cosine_schedule(0.1, 2, 10) if schedule else 0.1,
                       **kw)
    jp, js = _jax(p), j_adamw_init(_jax(p))
    tp, ts = _torch(p), adamw_init(_torch(p))
    for k in range(3):
        g = _tree(10 + k, scale=0.3)
        jp, js, jm = j_adamw_update(jp, _jax(g), js, jcfg)
        tp, ts, tm = adamw_update(tp, _torch(g), ts, tcfg)
        _leaves_close(tp, jp)
        _leaves_close(ts["m"], js["m"])
        _leaves_close(ts["v"], js["v"])
        assert int(ts["step"]) == int(js["step"]) == k + 1
        for key in ("grad_norm", "lr"):
            assert float(tm[key]) == pytest.approx(float(jm[key]), rel=TOL)


def test_adamw_update_is_pure():
    """The update returns new trees and leaves its inputs as they were."""
    p, g = _torch(_tree(0)), _torch(_tree(1))
    st = adamw_init(p)
    before = [t.clone() for t in CV.tree_leaves({"p": p, "g": g, "s": st})]
    new_p, new_st, _ = adamw_update(p, g, st, AdamWConfig(lr=0.1))
    after = list(CV.tree_leaves({"p": p, "g": g, "s": st}))
    assert all(torch.equal(a, b) for a, b in zip(before, after))
    assert not torch.equal(new_p["w"], p["w"])
    assert int(st["step"]) == 0 and int(new_st["step"]) == 1


def test_adamw_init_and_global_norm_match_the_reference():
    p = _tree(3)
    js, ts = j_adamw_init(_jax(p)), adamw_init(_torch(p))
    assert set(ts) == {"m", "v", "step"}
    ref = _flat(jax.tree.map(np.asarray, js["m"]))
    for path, a in _flat(ts["m"]).items():
        assert a.dtype == torch.float32 and a.shape == ref[path].shape
        assert not a.any()
    assert float(global_norm(_torch(p))) == pytest.approx(
        float(j_global_norm(_jax(p))), rel=TOL)


def test_a_reference_state_carries_into_the_port():
    """``convert.opt_state_from_numpy`` takes the reference's AdamW state
    (after a step) leaf for leaf, its step a 0-d int32 tensor, and the
    port's next update matches the reference's."""
    p, g = _tree(0), _tree(1, 0.5)
    cfg = dict(lr=0.05, weight_decay=0.1)
    jp, js, _ = j_adamw_update(_jax(p), _jax(g), j_adamw_init(_jax(p)),
                               JAdamWConfig(**cfg))
    ts = CV.opt_state_from_numpy(jax.tree.map(np.asarray, js), "cpu")
    assert ts["step"].dtype == torch.int32 and int(ts["step"]) == 1
    tp = _torch(jax.tree.map(np.asarray, jp))
    jp2, js2, _ = j_adamw_update(jp, _jax(g), js, JAdamWConfig(**cfg))
    tp2, ts2, _ = adamw_update(tp, _torch(g), ts, AdamWConfig(**cfg))
    _leaves_close(tp2, jp2)
    _leaves_close(ts2["v"], js2["v"])
    back = CV.tree_to_numpy(ts2)
    assert back["step"].dtype == np.int32 and int(back["step"]) == 2
    with pytest.raises(ValueError, match="m, v and step"):
        CV.opt_state_from_numpy({"m": {}, "v": {}}, "cpu")


@pytest.mark.parametrize("shape", [(64, 32), (7,), (3, 4, 5), (1, 1)])
def test_quantize_matches_the_reference(shape):
    rng = np.random.default_rng(sum(shape))
    g = (rng.standard_normal(shape) * 3).astype(np.float32)
    jq, js = JC.quantize(jnp.asarray(g))
    tq, ts = C.quantize(torch.from_numpy(g))
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-7)
    np.testing.assert_allclose(C.dequantize(tq, ts).numpy(),
                               np.asarray(JC.dequantize(jq, js)), rtol=1e-7)


# ----------------------------------------------------------------------------
# compressed_psum on gloo ranks
# ----------------------------------------------------------------------------

def _rank_grads(rank, k):
    """Rank ``rank``'s gradient tree of call ``k``."""
    return _tree(100 * k + rank, scale=1.0 + rank)


def _rank_main(rank, init, out_dir):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=init, rank=rank,
                            world_size=NRANKS)
    try:
        out = {}
        res = None
        for k in range(2):
            red, res = C.compressed_psum(_torch(_rank_grads(rank, k)),
                                         residual=res)
            for key, leaf in CV.tree_to_numpy(
                    {"red": red, "res": res}).items():
                for path, a in _flat(leaf).items():
                    out[f"{k}/{key}/{path}"] = a
        np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **out)
    finally:
        dist.destroy_process_group()


def _flat(tree, pre=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, pre + k + "/"))
        else:
            out[pre + k] = v
    return out


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("gloo")
    mp.spawn(_rank_main, args=(f"file://{tmp / 'store'}", str(tmp)),
             nprocs=NRANKS, join=True)
    return [dict(np.load(tmp / f"rank{r}.npz")) for r in range(NRANKS)]


def _reference_psum():
    """The reference's ``compressed_psum`` under ``jax.vmap`` with an axis
    name (its collectives over the mapped axis), two calls with the
    residual carried: {f"{k}/{red|res}/{path}": (NRANKS, ...) arrays}."""
    fn = jax.vmap(lambda g, r: JC.compressed_psum(g, "d", r),
                  axis_name="d")
    out, res = {}, None
    for k in range(2):
        g = jax.tree.map(lambda *xs: jnp.stack(xs),
                         *[_jax(_rank_grads(r, k)) for r in range(NRANKS)])
        if res is None:
            red, res = jax.vmap(lambda g: JC.compressed_psum(g, "d"),
                                axis_name="d")(g)
        else:
            red, res = fn(g, res)
        for key, tree in (("red", red), ("res", res)):
            for path, a in _flat(jax.tree.map(np.asarray, tree)).items():
                out[f"{k}/{key}/{path}"] = a
    return out


def test_compressed_psum_matches_the_reference(ranks):
    """Each rank's reduced gradients (the same on every rank) and its own
    residual, over two calls with error feedback, against the reference's
    under ``vmap``: the int8 payloads sum exactly, so the results agree
    to float32 rounding."""
    ref = _reference_psum()
    assert set(ranks[0]) == set(ref)
    for key, a in ref.items():
        for r in range(NRANKS):
            _close(ranks[r][key], a[r], 1e-6)
        if "/red/" in key:
            for r in range(1, NRANKS):
                np.testing.assert_array_equal(ranks[r][key], ranks[0][key])


def test_compressed_psum_is_near_the_mean(ranks):
    """The reduced gradient is the ranks' mean to within one quantisation
    step a rank."""
    for path in _flat(_rank_grads(0, 0)):
        mean = np.mean([_flat(_rank_grads(r, 0))[path]
                        for r in range(NRANKS)], axis=0)
        got = ranks[0][f"0/red/{path}"]
        step = max(np.abs(_flat(_rank_grads(r, 0))[path]).max()
                   for r in range(NRANKS)) / 127.0
        assert np.abs(got - mean).max() <= step
