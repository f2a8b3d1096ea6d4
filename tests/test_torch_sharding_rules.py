"""The port's sharding rules against the reference's, spec for spec, and
its DTensor layout against the blocks JAX puts on each device.

The reference's rules run on ``jax.sharding.AbstractMesh`` (no devices)
with its trees from ``jax.eval_shape``; the port's on a
:class:`repro_torch.sharding.rules.MeshShape` with its trees on the meta
device. For every arch, full and smoke, on meshes (2, 4), (16, 16) and
(2, 16, 16), with TP and FSDP each on and off: every param, optimizer
(ZeRO-1), cache, activation and input spec is the reference's
``PartitionSpec``, entry for entry. Then, on a fake 8-rank process group
with mesh (2, 2, 2), each rank's local block of a DTensor laid out by a
spec is the slice ``NamedSharding(...).devices_indices_map`` gives device
r (one ``devices8`` subprocess).
"""
import itertools
import json

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import AbstractMesh

from repro.configs import get_config as ref_config
from repro.configs import get_smoke_config as ref_smoke_config
from repro.models import model as JMD
from repro.models.config import SHAPES as JSHAPES
from repro.sharding import rules as JR
from repro_torch.configs import ARCHS, get_config, get_smoke_config
from repro_torch.launch.dryrun import meta_params
from repro_torch.models import model as MD
from repro_torch.models.config import SHAPES
from repro_torch.sharding import rules as SR

MESHES = [((2, 4), ("data", "model")), ((16, 16), ("data", "model")),
          ((2, 16, 16), ("pod", "data", "model"))]
OPTIONS = list(itertools.product([True, False], [True, False]))
ACT_NAMES = ("act", "act_full", "act_decode", "qkv", "kv_small", "moe_buf",
             "moe_flat", "moe_1d", "moe_group", "moe_g1", "moe_gbuf",
             "moe_w_in", "moe_w_out", "ssm_inner", "ssm_conv", "ssm_dt",
             "ssm_bc", "rec_inner", "logits", "unknown")
ACT_SHAPES = [(256, 4096, 4096), (8, 32, 64), (6, 33, 48), (512, 1, 2048),
              (32, 4096, 32, 128), (40, 16, 1536), (4, 3, 7), (128,),
              (2, 64), (16, 8, 24, 96), (5, 64, 96)]
INPUT_KINDS = ("tokens", "labels", "prefix", "frames", "token", "pos")


def _both(shape, axes, tp, fsdp, **kw):
    return (JR.make_rules(AbstractMesh(shape, axes), tp_enabled=tp,
                          fsdp=fsdp, **kw),
            SR.make_rules(SR.MeshShape(shape, axes), tp_enabled=tp,
                          fsdp=fsdp, **kw))


def _ref_specs(tree):
    """{"path/to/leaf": spec tuple} of a tree of NamedShardings."""
    return {"/".join(str(k.key) for k in path): tuple(ns.spec)
            for path, ns in jax.tree_util.tree_leaves_with_path(tree)}


def _port_specs(tree, pre=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_port_specs(v, pre + k + "/"))
        else:
            out[pre + k] = tuple(v)
    return out


def _trees(arch, full):
    """(reference params, port params, reference cache, port cache) shapes
    of ``arch``: its full config on decode_32k, or its smoke config on a
    small decode shape."""
    jcfg = (ref_config if full else ref_smoke_config)(arch)
    cfg = (get_config if full else get_smoke_config)(arch)
    jshape = JSHAPES["decode_32k"] if full else \
        JSHAPES["decode_32k"].__class__("small", 16, 8, "decode")
    shape = SHAPES["decode_32k"] if full else \
        SHAPES["decode_32k"].__class__("small", 16, 8, "decode")
    jp = jax.eval_shape(lambda: JMD.init_params(jcfg, jax.random.PRNGKey(0)))
    kv = "int8" if full and arch == "deepseek-67b" else "bfloat16"
    return (jp, meta_params(cfg), JMD.cache_specs(jcfg, jshape, kv_dtype=kv),
            MD.cache_specs(cfg, shape, kv_dtype=kv))


@pytest.mark.parametrize("full", [True, False], ids=["full", "smoke"])
@pytest.mark.parametrize("arch", ARCHS)
def test_param_opt_and_cache_specs_are_the_references(arch, full):
    jp, tp, jc, tc = _trees(arch, full)
    for (shape, axes), (tpe, fsdp) in itertools.product(MESHES, OPTIONS):
        jr, pr = _both(shape, axes, tpe, fsdp)
        want = _ref_specs(jr.param_shardings(jp))
        assert want == _port_specs(pr.param_shardings(tp)), (shape, tpe)
        assert _ref_specs(jr.opt_shardings(jp)) == \
            _port_specs(pr.opt_shardings(tp)), (shape, tpe, fsdp)
        assert _ref_specs(jr.cache_shardings(jc)) == \
            _port_specs(pr.cache_shardings(tc)), (shape, tpe)


@pytest.mark.parametrize("mesh", MESHES, ids=["2x4", "16x16", "2x16x16"])
def test_act_and_input_specs_are_the_references(mesh):
    shape, axes = mesh
    for (tpe, fsdp), seq in itertools.product(OPTIONS, [True, False]):
        jr, pr = _both(shape, axes, tpe, fsdp, seq_shard=seq)
        assert pr.dp == jr.dp and pr.tp == jr.tp
        assert pr.fsdp_ax == jr.fsdp_ax
        for name, s in itertools.product(ACT_NAMES, ACT_SHAPES):
            want = jr.act_spec(name, s)
            got = pr.act_spec(name, s)
            assert (got is None) == (want is None), (name, s)
            if want is not None:
                assert tuple(got) == tuple(want.spec), (name, s, tpe, seq)
        for kind, s in itertools.product(INPUT_KINDS, ACT_SHAPES[:4]):
            s = s[:2] if kind in ("tokens", "labels", "token") else s
            assert tuple(pr.input_sharding(s, kind)) == \
                tuple(jr.input_sharding(s, kind).spec), (kind, s)


def test_placements_put_a_tuple_entry_on_its_mesh_dims_in_order():
    from torch.distributed.tensor import Replicate, Shard
    m = SR.MeshShape((2, 16, 16), ("pod", "data", "model"))
    assert SR.placements(SR.Spec(None, ("pod", "data"), "model"), m) == (
        Shard(1), Shard(1), Shard(2))
    assert SR.placements(SR.Spec(), m) == (Replicate(),) * 3
    with pytest.raises(ValueError, match="axis order"):
        SR.placements(SR.Spec(("data", "pod")), m)


#: (global shape, spec) pairs held against the reference's device blocks
LAYOUTS = [((8, 6), (("pod", "data"), "model")),
           ((4, 8, 2), (None, ("pod", "data", "model"), None)),
           ((8, 4), ("model", ("pod", "data"))),
           ((6, 8), (None, ("data", "model"))),
           ((2, 4, 4), ("pod", None, "data"))]

_JAX_BLOCKS = r'''
import json
import numpy as np
import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
layouts = json.loads(%r)
mesh = Mesh(np.asarray(jax.devices()).reshape(2, 2, 2), ("pod", "data", "model"))
out = []
for shape, spec in layouts:
    spec = [tuple(e) if isinstance(e, list) else e for e in spec]
    m = NamedSharding(mesh, P(*spec)).devices_indices_map(tuple(shape))
    out.append({str(d.id): [[s.start or 0, s.stop if s.stop is not None else n]
                            for s, n in zip(idx, shape)]
                for d, idx in m.items()})
print(json.dumps(out))
'''


def test_each_ranks_block_is_the_block_jax_puts_on_its_device(devices8):
    from torch.distributed.tensor import DTensor, Replicate
    from torch.testing._internal.distributed.fake_pg import FakeStore
    from repro_torch.launch import mesh as LM
    blocks = json.loads(devices8(_JAX_BLOCKS % json.dumps(LAYOUTS))
                        .strip().splitlines()[-1])
    for r in range(8):
        dist.init_process_group("fake", store=FakeStore(), rank=r,
                                world_size=8)
        try:
            mesh = LM.make_test_mesh((2, 2, 2), ("pod", "data", "model"))
            for (shape, spec), want in zip(LAYOUTS, blocks):
                g = torch.arange(int(np.prod(shape))).reshape(shape)
                d = SR.distribute(g, mesh, SR.Spec(*spec))
                sl = tuple(slice(a, b) for a, b in want[str(r)])
                assert torch.equal(d.to_local(), g[sl]), (r, shape, spec)
                rep = DTensor.from_local(g, mesh, [Replicate()] * 3,
                                         run_check=False)
                assert torch.equal(SR.distribute(rep, mesh, SR.Spec(*spec))
                                   .to_local(), g[sl])
        finally:
            dist.destroy_process_group()
