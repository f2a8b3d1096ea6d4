"""The port's dry run against the reference's: its policy functions on
every arch x shape, its meta-device input stand-ins against
``jax.eval_shape``, the mamba2 ``decode_32k`` cell on both production
meshes (the reference's test cell, in a subprocess: the CLI joins its own
fake process group of 512 ranks), and the cost reader's flops of a 2-D
sharded product.

The reference's own dry run does not run at this tree (its
``test_dryrun_compile.py`` fails: jax 0.9's ``make_mesh`` gives explicit
axes, and its embedding gather then refuses). So the cell's record is held
against the reference's record keys, read from its ``run_cell``, and its
argument bytes against the per-device shard bytes of the reference's own
specs.
"""
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import AbstractMesh

from conftest import SRC
from repro.configs import get_config as ref_config
from repro.launch import dryrun as JD
from repro.models import model as JMD
from repro.models.config import SHAPES as JSHAPES
from repro.sharding import rules as JR
from repro_torch.configs import ARCHS, get_config
from repro_torch.launch import dryrun as TD
from repro_torch.models import model as MD
from repro_torch.models.config import SHAPES

#: the keys of the reference's ``run_cell`` record (src/repro/launch/dryrun.py)
RECORD_KEYS = {"arch", "shape", "mesh", "kind", "remat", "kv_dtype", "fsdp",
               "seq_shard", "tag", "accum", "tp_enabled", "n_devices",
               "n_params", "n_active_params", "model_flops", "lower_s",
               "compile_s", "memory", "xla_cost_analysis", "hlo"}
MEMORY_KEYS = {"argument_bytes", "output_bytes", "temp_bytes", "alias_bytes",
               "peak_bytes_per_device"}
HLO_KEYS = {"flops_per_device", "hbm_bytes_per_device",
            "coll_bytes_per_device", "coll_by_kind", "coll_count"}


@pytest.mark.parametrize("arch", ARCHS)
def test_policies_are_the_references(arch):
    cfg, jcfg = get_config(arch), ref_config(arch)
    assert TD.auto_accum(cfg) == JD.auto_accum(jcfg)
    assert TD.auto_fsdp(cfg) == JD.auto_fsdp(jcfg)
    for name in SHAPES:
        s, js = SHAPES[name], JSHAPES[name]
        assert TD.cell_skip_reason(cfg, s) == JD.cell_skip_reason(jcfg, js)
        assert TD.model_flops(cfg, s) == JD.model_flops(jcfg, js)
        for n in (128, 256, 512):
            assert TD.auto_kv(cfg, s, n) == JD.auto_kv(jcfg, js, n)


def _shapes(tree):
    return {"/".join(str(getattr(k, "key", k)) for k in path):
            (tuple(v.shape), str(v.dtype))
            for path, v in jax.tree_util.tree_leaves_with_path(tree)}


def _tshapes(tree, pre=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_tshapes(v, pre + k + "/"))
        else:
            assert v.device.type == "meta"
            out[pre + k] = (tuple(v.shape), str(v.dtype).split(".")[-1])
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_input_and_cache_specs_are_the_references(arch):
    cfg, jcfg = get_config(arch), ref_config(arch)
    for name in SHAPES:
        s, js = SHAPES[name], JSHAPES[name]
        assert _tshapes(MD.input_specs(cfg, s, dtype=cfg.dtype)) == \
            _shapes(JMD.input_specs(jcfg, js, dtype=jcfg.dtype))
        assert _tshapes(MD.decode_input_specs(cfg, s)) == \
            _shapes(JMD.decode_input_specs(jcfg, js))
        if s.kind == "decode":
            for kv in ("bfloat16", "int8"):
                assert _tshapes(MD.cache_specs(cfg, s, kv_dtype=kv)) == \
                    _shapes(JMD.cache_specs(jcfg, js, kv_dtype=kv))


def _ref_shard_bytes(tree, shardings, mesh_shape, axes):
    """Sum over leaves of the bytes of one device's block under the
    reference's specs."""
    sizes = dict(zip(axes, mesh_shape))
    total = 0
    for leaf, ns in zip(jax.tree.leaves(tree), jax.tree.leaves(shardings)):
        n = int(np.prod(leaf.shape)) * jnp.dtype(leaf.dtype).itemsize
        for e in ns.spec:
            for a in ((e,) if isinstance(e, str) else (e or ())):
                n //= sizes[a]
        total += n
    return total


def test_mamba2_decode_cell_on_both_meshes_writes_the_references_record(
        tmp_path):
    env = dict(os.environ, PYTHONPATH=SRC + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "mamba2-370m", "--shape", "decode_32k", "--both-meshes",
         "--out-dir", str(tmp_path), "--tag", "t"],
        capture_output=True, text=True, timeout=600, env=env)
    assert res.returncode == 0, res.stderr[-3000:]
    assert "[dryrun] all requested cells ran" in res.stdout
    jcfg, js = ref_config("mamba2-370m"), JSHAPES["decode_32k"]
    for mesh_name, (shape, axes) in (
            ("pod16x16", ((16, 16), ("data", "model"))),
            ("pod2x16x16", ((2, 16, 16), ("pod", "data", "model")))):
        with open(tmp_path / f"mamba2-370m__decode_32k__{mesh_name}__t.json"
                  ) as f:
            rec = json.load(f)
        assert RECORD_KEYS <= set(rec)
        assert MEMORY_KEYS <= set(rec["memory"])
        assert HLO_KEYS == set(rec["hlo"])
        assert rec["n_devices"] == int(np.prod(shape))
        rules = JR.make_rules(AbstractMesh(shape, axes), fsdp=False,
                              seq_shard=False)
        params = jax.tree.map(
            lambda s: jax.ShapeDtypeStruct(s.shape, jnp.bfloat16),
            jax.eval_shape(lambda: JMD.init_params(
                jcfg, jax.random.PRNGKey(0))))
        cache = JMD.cache_specs(jcfg, js, kv_dtype=rec["kv_dtype"])
        token = JMD.decode_input_specs(jcfg, js)["token"]
        want = (_ref_shard_bytes(params, rules.param_shardings(params),
                                 shape, axes)
                + _ref_shard_bytes(cache, rules.cache_shardings(cache),
                                   shape, axes)
                + _ref_shard_bytes([token], [rules.input_sharding(
                    token.shape, "token")], shape, axes))
        # the port's pos is a Python int, the reference's a 4-byte scalar
        assert rec["memory"]["argument_bytes"] == want
        assert rec["hlo"]["flops_per_device"] > 0
        assert rec["memory"]["peak_bytes_per_device"] >= want


def test_cost_counts_a_2d_sharded_product_once_a_device():
    """(4096, 8192) split over "data" on its rows @ (8192, 2048) split over
    "model" on its columns, on a fake (16, 16) mesh: each device's product
    is (256, 8192) @ (8192, 128), 2 * 256 * 8192 * 128 flops, and no
    collective; gathering the result's columns is one all-gather."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    from repro_torch.analysis.cost import CostMode
    from repro_torch.launch import mesh as LM
    from repro_torch.sharding import rules as SR
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=256)
    try:
        mesh = LM.make_production_mesh()
        a = SR.distribute(torch.empty(4096, 8192, device="meta"), mesh,
                          SR.Spec("data", None))
        b = SR.distribute(torch.empty(8192, 2048, device="meta"), mesh,
                          SR.Spec(None, "model"))
        mode = CostMode()
        with mode:
            c = a @ b
        assert mode.cost.flops == 2 * 256 * 8192 * 128
        assert mode.cost.coll_bytes == 0 and not mode.cost.coll_count
        assert mode.cost.hbm_bytes == 4 * (256 * 8192 + 8192 * 128
                                           + 256 * 128)
        with mode:
            SR.distribute(c, mesh, SR.Spec("data", None))
        assert mode.cost.coll_count == {"all-gather": 1}
        assert mode.cost.coll_bytes == 4 * 256 * 2048
    finally:
        dist.destroy_process_group()
