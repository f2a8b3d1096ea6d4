"""The port's data pipeline and checkpoints (``repro_torch.data``,
``repro_torch.checkpoint``) against the reference's on the CPU.

``SyntheticLM`` batches are byte-equal to the reference's for every arch
(the vlm's ``prefix``, the enc-dec's ``frames`` and its cut tokens
included). Checkpoints keep the reference's on-disk layout, so one
written by either package restores into the other; the cases of
``tests/test_train.py`` for both modules are here with the port in place
of the reference.
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import latest_step as j_latest_step
from repro.checkpoint import restore_checkpoint as j_restore
from repro.checkpoint import save_checkpoint as j_save
from repro.configs import ARCHS
from repro.configs import get_smoke_config as ref_smoke_config
from repro.data import synthetic as JD
from repro.models.config import ShapeConfig as JShapeConfig
from repro_torch.checkpoint import (latest_step, restore_checkpoint,
                                    save_checkpoint)
from repro_torch.configs import get_smoke_config
from repro_torch.data import synthetic as D
from repro_torch.models.config import ShapeConfig
from repro_torch.train.loop import device_batch


# ----------------------------------------------------------------------------
# data
# ----------------------------------------------------------------------------

def _same(a, b):
    """Two batches: the same keys, dtypes, shapes and bytes."""
    assert set(a) == set(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        assert a[k].tobytes() == b[k].tobytes(), k


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("seq,batch,seed,step", [(32, 2, 0, 0),
                                                 (64, 3, 7, 13),
                                                 (300, 1, 2, 5)])
def test_batches_are_byte_equal_to_the_references(arch, seq, batch, seed,
                                                  step):
    ref = JD.SyntheticLM(ref_smoke_config(arch), seq, batch,
                         seed=seed).batch(step)
    got = D.SyntheticLM(get_smoke_config(arch), seq, batch,
                        seed=seed).batch(step)
    _same(got, ref)
    assert got["tokens"].dtype == np.int32
    cfg = get_smoke_config(arch)
    if cfg.frontend == "patches":
        assert got["prefix"].shape == (batch, cfg.n_prefix, cfg.d_model)
    if cfg.is_encdec:
        assert got["frames"].shape == (batch, seq, cfg.d_model)
        assert got["tokens"].shape[1] == min(seq, max(256,
                                                      seq // cfg.dec_ratio))


@pytest.mark.parametrize("arch", ["yi-6b", "seamless-m4t-medium"])
def test_make_batch_matches_the_reference(arch):
    _same(D.make_batch(get_smoke_config(arch), ShapeConfig("t", 48, 2, "t"),
                       3, seed=4),
          JD.make_batch(ref_smoke_config(arch), JShapeConfig("t", 48, 2, "t"),
                        3, seed=4))


def test_data_pipeline_deterministic_and_shifted():
    cfg = get_smoke_config("yi-6b")
    d1 = D.SyntheticLM(cfg, 32, 4, seed=7)
    d2 = D.SyntheticLM(cfg, 32, 4, seed=7)
    b1, b2 = d1.batch(13), d2.batch(13)
    np.testing.assert_array_equal(b1["tokens"], b2["tokens"])
    # labels are next-token shifted with -1 tail
    np.testing.assert_array_equal(b1["labels"][:, :-1], b1["tokens"][:, 1:])
    assert (b1["labels"][:, -1] == -1).all()
    # different steps differ
    assert not np.array_equal(d1.batch(14)["tokens"], b1["tokens"])


def test_device_batch_keeps_the_dtypes():
    b = D.SyntheticLM(get_smoke_config("internvl2-26b"), 16, 2).batch(0)
    t = device_batch(b, torch.device("cpu"))
    assert t["tokens"].dtype == torch.int32
    assert t["prefix"].dtype == torch.float32
    np.testing.assert_array_equal(t["labels"].numpy(), b["labels"])


# ----------------------------------------------------------------------------
# checkpoints: the cases of tests/test_train.py
# ----------------------------------------------------------------------------

def _tree():
    return {"a": torch.arange(6, dtype=torch.float32).reshape(2, 3),
            "b": {"c": torch.ones((4,), dtype=torch.int32)}}


def test_checkpoint_roundtrip_and_gc(tmp_path):
    d = str(tmp_path)
    tree = _tree()
    for s in [10, 20, 30, 40]:
        save_checkpoint(d, s, tree, keep_last=2)
    assert latest_step(d) == 40
    assert sorted(os.listdir(d)) == ["step_00000030", "step_00000040"]
    got = restore_checkpoint(d, 40, tree)
    assert torch.equal(got["a"], tree["a"])
    assert torch.equal(got["b"]["c"], tree["b"]["c"])
    assert got["b"]["c"].dtype == torch.int32


def test_checkpoint_incomplete_ignored(tmp_path):
    d = str(tmp_path)
    save_checkpoint(d, 5, {"x": torch.zeros(3)})
    # a torn write: directory without valid manifest
    os.makedirs(os.path.join(d, "step_00000009"))
    assert latest_step(d) == 5
    # and a write cut before os.replace
    os.makedirs(os.path.join(d, "step_00000011.tmp"))
    assert latest_step(d) == 5


def test_checkpoint_shape_mismatch_raises(tmp_path):
    d = str(tmp_path)
    save_checkpoint(d, 1, {"x": torch.zeros((3,))})
    with pytest.raises(ValueError, match="shape mismatch"):
        restore_checkpoint(d, 1, {"x": torch.zeros((4,))})


def test_elastic_restore_to_numpy_and_back(tmp_path):
    """A checkpoint stores logical (full) host arrays: it restores into a
    numpy template as numpy, and into a tensor template as tensors."""
    tree = {"w": np.arange(64, dtype=np.float32).reshape(8, 8)}
    save_checkpoint(str(tmp_path), 1, tree)
    got = restore_checkpoint(str(tmp_path), 1, tree)
    assert isinstance(got["w"], np.ndarray)
    np.testing.assert_array_equal(got["w"], tree["w"])
    got = restore_checkpoint(str(tmp_path), 1,
                             {"w": torch.zeros((8, 8))})
    np.testing.assert_array_equal(got["w"].numpy(), tree["w"])


def test_bfloat16_leaves_restore_exactly(tmp_path):
    """A bfloat16 tensor is written as float32 and cast back on restore."""
    w = torch.randn(5, 3).to(torch.bfloat16)
    save_checkpoint(str(tmp_path), 2, {"w": w})
    with open(tmp_path / "step_00000002" / "manifest.json") as f:
        assert json.load(f)["dtypes"] == {"w": "float32"}
    got = restore_checkpoint(str(tmp_path), 2, {"w": torch.zeros(5, 3,
                                                       dtype=torch.bfloat16)})
    assert got["w"].dtype == torch.bfloat16 and torch.equal(got["w"], w)


# ----------------------------------------------------------------------------
# checkpoints across the packages
# ----------------------------------------------------------------------------

def _state():
    """A training-state tree as both packages hold it: nested params
    (with stacked units) and an AdamW state with an int32 step."""
    rng = np.random.default_rng(0)
    f = np.float32
    params = {"embed": rng.standard_normal((16, 4)).astype(f),
              "units": {"0": {"attn": {"wq": rng.standard_normal((2, 4, 4))
                                       .astype(f)},
                              "norm": np.zeros((2, 4), f)}},
              "final_norm": rng.standard_normal((4,)).astype(f)}
    m = jax.tree.map(lambda a: (a * 0.5).astype(f), params)
    v = jax.tree.map(lambda a: (a * a).astype(f), params)
    return {"params": params,
            "opt": {"m": m, "v": v, "step": np.asarray(7, np.int32)}}


def _torch_tree(tree):
    return jax.tree.map(lambda a: torch.from_numpy(np.array(a)), tree)


def _flat_np(tree):
    leaves = jax.tree_util.tree_flatten_with_path(tree)[0]
    return {"/".join(str(k.key) for k in path): np.asarray(a)
            for path, a in leaves}


def test_the_layout_is_the_references(tmp_path):
    """The same tree written by both packages: the same directory names,
    the same manifest, the same arrays under the same keys."""
    state = _state()
    j_save(str(tmp_path / "ref"), 3, jax.tree.map(jnp.asarray, state))
    save_checkpoint(str(tmp_path / "port"), 3, _torch_tree(state))
    for sub in ("ref", "port"):
        assert os.listdir(tmp_path / sub) == ["step_00000003"]
        assert sorted(os.listdir(tmp_path / sub / "step_00000003")) == \
            ["arrays.npz", "manifest.json"]
    man = [json.load(open(tmp_path / sub / "step_00000003" / "manifest.json"))
           for sub in ("ref", "port")]
    assert man[0] == man[1]
    assert "opt/step" in man[0]["keys"]
    assert "params/units/0/attn/wq" in man[0]["keys"]
    a, b = (np.load(tmp_path / sub / "step_00000003" / "arrays.npz")
            for sub in ("ref", "port"))
    assert sorted(a.files) == sorted(b.files)
    for k in a.files:
        assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k])


def test_a_reference_checkpoint_restores_into_the_port(tmp_path):
    state = _state()
    d = str(tmp_path)
    j_save(d, 12, jax.tree.map(jnp.asarray, state), keep_last=1)
    assert latest_step(d) == 12
    template = jax.tree.map(torch.zeros_like, _torch_tree(state))
    got = restore_checkpoint(d, 12, template)
    assert got["opt"]["step"].dtype == torch.int32
    assert int(got["opt"]["step"]) == 7
    ref = _flat_np(state)
    for path, a in _flat_np(jax.tree.map(lambda t: t.numpy(), got)).items():
        assert np.array_equal(a, ref[path]) and a.dtype == ref[path].dtype


def test_a_port_checkpoint_restores_into_the_reference(tmp_path):
    state = _state()
    d = str(tmp_path)
    save_checkpoint(d, 4, _torch_tree(state))
    save_checkpoint(d, 8, _torch_tree(state))
    assert j_latest_step(d) == 8
    got = j_restore(d, 8, jax.tree.map(np.zeros_like, state))
    ref = _flat_np(state)
    for path, a in _flat_np(got).items():
        assert np.array_equal(a, ref[path]) and a.dtype == ref[path].dtype
