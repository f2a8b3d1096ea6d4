"""The port's shard pass against the JAX package's, on the host, in one
process.

``plan.shard_plan(..., device="cpu", tune=False)`` and the reference's
``PL.shard_plan(..., tune=False)`` on the same numpy inputs, for each
layout x lowering x value dtype (f32, bf16) x partition ("blocks", "nnz",
"auto") on three matrices, and on a scrambled band with ``reorder="rcm"``:
every stacked array byte-equal (bf16 as bit patterns), ``row_start``,
``meta``, ``col_perm`` and ``row_iperm`` equal, and the trace equal less
``duration_s``; each shard's slab from the port's ``local_execute_spmv``
within ``1e-5 * max|y|`` of the reference's ``PL.local_execute_spmv`` on
its slice. Also: int8's demotion to bf16, every shard's slice of the
stacks starting on 16 bytes (values) and 4 (tables), and the mirrors of
the reference's shard API tests (trace, store tuning, descriptor stacks,
refusals, the shim's warning, the ``distributed.spmv`` span).
"""
import functools
import json

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.core import formats as JF
from repro.core import matgen as JM
from repro.core import plan as JP
from repro.core import selector as JS
from repro_torch import obs
from repro_torch.core import distributed as D
from repro_torch.core import formats as TF
from repro_torch.core import matgen as TM
from repro_torch.core import plan as TP
from repro_torch.core import selector as TS

TOL = 1e-5
NDEV = 8
MATRICES = {
    "banded": (lambda M: M.banded(1200, 6, 0.8, seed=3), (1, 8)),
    "powerlaw": (lambda M: M.powerlaw(1536, 12, alpha=1.6, seed=2), (1, 8)),
    "fem": (lambda M: M.fem_blocks(640, 4, 5, seed=4), (2, 4)),
}
GEOM = {"whole_vector": dict(cb=64), "panels": dict(pr=128, cb=16, xw=64)}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain versions on these small shards run faster on one thread
    than spread over the cores other test workers use too."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def _no_ambient_store(monkeypatch):
    for S in (JS, TS):
        monkeypatch.delenv(S.RECORDS_ENV, raising=False)
        S.set_default_store(None)
    yield
    for S in (JS, TS):
        S.set_default_store(None)


@functools.lru_cache(maxsize=None)
def _mats(name):
    """Both packages' beta(r,c) matrix of ``name``, made once (read
    only)."""
    fn, rc = MATRICES[name]
    return JF.csr_to_spc5(fn(JM), *rc), TF.csr_to_spc5(fn(TM), *rc)


def _strip(trace):
    return [{k: v for k, v in e.items() if k != "duration_s"} for e in trace]


def _host(t, like):
    """A port tensor as the reference's host array (bf16 and uint32 by
    their bits)."""
    like = np.asarray(like)
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy(), like.view(np.int16)
    a = t.numpy()
    return (a.view(np.uint32) if like.dtype == np.uint32 else a), like


def assert_same_sharded(tsh, jsh):
    assert tsh.layout == jsh.layout
    assert tuple(tsh.meta) == tuple(jsh.meta)
    assert tsh.reorder == jsh.reorder
    assert _strip(tsh.trace) == _strip(jsh.trace)
    assert np.array_equal(tsh.row_start.numpy(), np.asarray(jsh.row_start))
    assert tsh.row_start.dtype == torch.int32
    assert len(tsh.arrays) == len(jsh.arrays)
    for t, j in zip(tsh.arrays, jsh.arrays):
        t, j = _host(t, j)
        assert t.dtype == j.dtype and t.shape == j.shape
        assert t.tobytes() == j.tobytes()
    for tp, jp in ((tsh.col_perm, jsh.col_perm),
                   (tsh.row_iperm, jsh.row_iperm)):
        assert (tp is None) == (jp is None)
        if tp is not None:
            assert np.array_equal(tp.numpy(), np.asarray(jp))


def assert_same_slabs(tsh, jsh, x):
    """Each shard's slab of the port against the reference's oracle on its
    slice (x in the permuted column order)."""
    assert tsh.ndev == NDEV
    stacks = [np.asarray(a) for a in jsh.arrays]
    for k in range(NDEV):
        y = TP.local_execute_spmv(tsh, tsh.local(k), torch.from_numpy(x))
        y_ref = np.asarray(JP.local_execute_spmv(
            jsh, tuple(a[k] for a in stacks), x))
        assert y.shape == y_ref.shape == (tsh.rows_max,)
        np.testing.assert_allclose(
            y.numpy(), y_ref, rtol=0,
            atol=TOL * max(float(np.abs(y_ref).max()), 1e-30))


@pytest.mark.parametrize("partition", ["blocks", "nnz", "auto"])
@pytest.mark.parametrize("vdtype", ["f32", "bf16"])
@pytest.mark.parametrize("lowering", ["mask", "descriptor"])
@pytest.mark.parametrize("layout", ["whole_vector", "panels"])
@pytest.mark.parametrize("matrix", sorted(MATRICES))
def test_shard_plan_matches_the_reference(matrix, layout, lowering, vdtype,
                                          partition):
    jmat, tmat = _mats(matrix)
    kw = dict(layout=layout, lowering=lowering, vdtype=vdtype,
              partition=partition, tune=False, **GEOM[layout])
    jsh = JP.shard_plan(jmat, NDEV, **kw)
    tsh = TP.shard_plan(tmat, NDEV, device="cpu", **kw)
    assert_same_sharded(tsh, jsh)
    x = np.random.default_rng(0).standard_normal(tmat.ncols).astype(
        np.float32)
    assert_same_slabs(tsh, jsh, x)


@pytest.mark.parametrize("vdtype", ["f32", "bf16"])
@pytest.mark.parametrize("lowering", ["mask", "descriptor"])
@pytest.mark.parametrize("layout", ["whole_vector", "panels"])
def test_reordered_shard_plan_matches_the_reference(layout, lowering,
                                                    vdtype):
    def csr(M):
        return M.scrambled_banded(320, 4, 0.9, seed=5)
    jmat, tmat = JF.csr_to_spc5(csr(JM), 2, 4), TF.csr_to_spc5(csr(TM), 2, 4)
    kw = dict(layout=layout, lowering=lowering, vdtype=vdtype,
              reorder="rcm", tune=False, **GEOM[layout])
    jsh = JP.shard_plan(jmat, NDEV, **kw)
    tsh = TP.shard_plan(tmat, NDEV, device="cpu", **kw)
    assert tsh.reorder == "rcm" and tsh.col_perm is not None
    assert_same_sharded(tsh, jsh)
    x = np.random.default_rng(1).standard_normal(320).astype(np.float32)
    assert_same_slabs(tsh, jsh, x[tsh.col_perm.numpy()])


@pytest.mark.parametrize("layout", ["whole_vector", "panels"])
def test_shard_int8_demotes_to_bf16_with_trace(layout):
    jmat, tmat = _mats("fem")
    kw = dict(layout=layout, vdtype="int8", tune=False, **GEOM[layout])
    jsh = JP.shard_plan(jmat, 2, **kw)
    tsh = TP.shard_plan(tmat, 2, device="cpu", **kw)
    assert dict(tsh.meta)["vdtype"] == "bf16"
    assert tsh.values.dtype == torch.bfloat16
    entry = [e for e in tsh.trace if e.get("vdtype_demoted")]
    assert entry and entry[0]["vdtype_demoted_reason"] == \
        "no-sharded-int8-scales"
    assert_same_sharded(tsh, jsh)


BLOCKS = ((1, 8), (2, 4), (4, 4), (4, 8), (8, 4))


@pytest.mark.parametrize("vdtype", ["f32", "bf16"])
@pytest.mark.parametrize("rc", BLOCKS, ids=lambda rc: f"{rc[0]}x{rc[1]}")
def test_every_shards_slice_is_aligned_for_its_kernel(rc, vdtype):
    """A kernel reads shard k's slice of each stack in place: its values
    must start on 16 bytes (the kernels' staging copies) and its
    descriptor tables on 4, so each stack's row pitch must be a multiple
    of that."""
    mat = TF.csr_to_spc5(TM.powerlaw(700, 9, alpha=1.6, seed=8), *rc)
    for layout, geom in (("whole_vector", dict(cb=24)),
                         ("whole_vector", dict(cb=256)),
                         ("panels", dict(pr=48, cb=12, xw=40)),
                         ("panels", dict(pr=512, cb=64, xw=512))):
        for lowering in ("mask", "descriptor"):
            for partition in ("blocks", "nnz"):
                sh = TP.shard_plan(mat, 5, layout=layout, lowering=lowering,
                                   vdtype=vdtype, partition=partition,
                                   tune=False, device="cpu", **geom)
                names = TP.get_layout(layout).plan_array_names(lowering)
                for k in range(sh.ndev):
                    for name, a, s in zip(names, sh.arrays, sh.local(k)):
                        need = 16 if name == "values" else 4
                        assert a.is_contiguous() and s.is_contiguous()
                        assert (s.data_ptr() - a.data_ptr()) % need == 0, (
                            layout, lowering, name, k, a.shape, a.dtype)


def test_shard_plan_trace():
    tmat = TF.csr_to_spc5(TM.banded(200, 4, 1.0, seed=37), 1, 8)
    sh = D.shard_matrix(tmat, 2, cb=32, tune=False, device="cpu")
    assert [e["pass"] for e in sh.trace] == ["tune", "reorder", "lowering",
                                            "partition", "shard"]
    assert all(e["duration_s"] >= 0 for e in sh.trace)
    lowering, part, shard = sh.trace[2:]
    assert lowering["reason"] == "cost-model"
    assert lowering["lowering"] in ("mask", "descriptor")
    assert part["mode"] in ("blocks", "nnz")
    assert "skew_blocks" in part and "skew_nnz" in part
    assert shard["layout"] == "whole_vector"
    assert shard["ndev"] == 2
    assert shard["lowering"] == lowering["lowering"] == \
        dict(sh.meta)["lowering"]


def test_shard_plan_spans():
    """Each pass runs under the reference's span names."""
    tmat = TF.csr_to_spc5(TM.banded(200, 4, 1.0, seed=37), 1, 8)
    before = len(obs.get_registry().spans())
    TP.shard_plan(tmat, 2, cb=32, tune=False, device="cpu")
    names = [e.name for e in obs.get_registry().spans()[before:]]
    assert names == ["shard.tune", "shard.reorder", "shard.lowering",
                     "shard.partition", "shard.build"]


def _planted(S, best, worse, kernel, **extra):
    st = S.RecordStore()
    r, c = S.kernel_block(kernel)
    for avg in (1.0, 3.0, 6.0):
        f = S.MatrixFeatures(0, 0, 0, 5.0, 2.0, avg, avg / (r * c))
        st.add_measurement(kernel, f, S.PanelConfig(**best), 1, 2.0 + avg,
                           **extra)
        st.add_measurement(kernel, f, S.PanelConfig(**worse), 1, 1.0,
                           **extra)
    return st


BEST = dict(layout="panels", pr=64, xw=64, cb=8)
WORSE = dict(layout="whole_vector", pr=0, xw=0, cb=256)


def test_shard_matrix_tuned_and_explicit_config():
    jmat, tmat = _mats("banded")
    store = _planted(TS, BEST, WORSE, "1x8", backend="cpu")
    # tuned: panel shards with the per-shard-clamped config
    sh = D.shard_matrix(tmat, 2, store=store, device="cpu")
    assert sh.layout == TP.LAYOUT_PANELS and sh.pr == 64
    assert sh.trace[0]["source"] == "store"
    assert_same_sharded(sh, JP.shard_plan(
        jmat, 2, store=_planted(JS, BEST, WORSE, "1x8")))
    # an explicit config is the escape hatch
    sh2 = D.shard_matrix(tmat, 2, device="cpu",
                         config=TS.PanelConfig("whole_vector", 0, 0, 128))
    assert sh2.layout == TP.LAYOUT_WHOLE and sh2.cb == 128
    # no store, no config: the flat default layout
    assert D.shard_matrix(tmat, 2, tune=False,
                          device="cpu").layout == TP.LAYOUT_WHOLE
    assert D.shard_matrix(tmat, 2, device="cpu").layout == TP.LAYOUT_WHOLE


def test_records_of_another_device_leave_the_shards_untuned():
    _, tmat = _mats("banded")
    for backend in ("cuda:NVIDIA H100 80GB HBM3", ""):
        store = _planted(TS, BEST, WORSE, "1x8", backend=backend)
        sh = D.shard_matrix(tmat, 2, store=store, device="cpu")
        assert sh.trace[0]["source"] == "no-store"
        assert sh.layout == TP.LAYOUT_WHOLE


def test_shard_plan_serves_descriptor():
    tmat = TF.csr_to_spc5(TM.banded(144, 5, 1.0, seed=37), 1, 8)
    sh = D.shard_matrix(tmat, 2, cb=32, tune=False, lowering="descriptor",
                        device="cpu")
    sentry = sh.trace[-1]
    assert sentry["pass"] == "shard"
    assert sentry["lowering"] == "descriptor"
    assert "lowering_demoted" not in sentry
    lentry = [e for e in sh.trace if e.get("pass") == "lowering"][0]
    assert lentry["reason"] == "requested"
    # the stacks resolve by the descriptor name set
    assert len(sh.arrays) == len(TP.R.SPC5DescDevice._fields)
    assert sh.desc_valid.shape == sh.desc_vidx.shape
    assert sh.desc_valid.shape[0] == sh.ndev == 2
    assert sh.rows_max == dict(sh.meta)["rows_max"]


def test_refusals():
    _, tmat = _mats("fem")
    with pytest.raises(ValueError, match="not both"):
        TP.shard_plan(tmat, 2, vdtype="bf16", dtype=np.float32,
                      device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        TP.shard_plan(tmat, 2, dtype=np.float64, device="cpu")
    with pytest.raises(ValueError, match="partition"):
        TP.shard_plan(tmat, 2, partition="rows", device="cpu")
    with pytest.raises(ValueError, match="no sharded stacking hooks"):
        TP.shard_plan(tmat, 2, layout="test", device="cpu")
    with pytest.raises(ValueError, match="rank"):
        TP.shard_plan(tmat, 2, rank=2, device="cpu")
    assert TP.get_layout("test").shard_lowerings == ()
    for name in ("whole_vector", "panels"):
        assert TP.get_layout(name).shard_lowerings == ("mask", "descriptor")
    # float32 dtype= is the one legacy store the port takes
    sh = TP.shard_plan(tmat, 2, dtype=np.float32, tune=False, device="cpu")
    assert sh.values.dtype == torch.float32


def test_no_card_raises_without_device_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, tmat = _mats("fem")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        D.shard_matrix(tmat, 2, tune=False)


def test_shard_matrix_panels_shim_warns():
    jmat, tmat = _mats("fem")
    with pytest.warns(DeprecationWarning, match="shard_matrix_panels"):
        sh = D.shard_matrix_panels(tmat, 2, pr=64, cb=16, xw=64,
                                   device="cpu")
    assert (sh.layout, sh.lowering) == ("panels", "mask")
    assert sh.trace[0]["source"] == "explicit"
    assert D.ShardedSPC5 is D.ShardedSPC5Panels is TP.ShardedPlan


def test_a_rank_plan_holds_its_own_shard_only():
    _, tmat = _mats("fem")
    whole = TP.shard_plan(tmat, 4, tune=False, device="cpu")
    one = TP.shard_plan(tmat, 4, tune=False, device="cpu", rank=2)
    assert one.ndev == 4 and one.rank == 2
    assert all(a.shape[0] == 1 for a in one.arrays)
    for a, b in zip(one.local(2), whole.local(2)):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="shard 2 only"):
        one.local(1)
    with pytest.raises(ValueError, match="not in"):
        whole.local(4)
    assert np.array_equal(one.row_start.numpy(), whole.row_start.numpy())


@pytest.fixture
def one_rank(tmp_path):
    """A one-rank gloo group in this process."""
    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 's'}",
                            rank=0, world_size=1)
    yield
    dist.destroy_process_group()


def test_one_rank_group_runs_under_a_span_per_call(one_rank):
    csr = TM.fem_blocks(640, 4, 5, seed=4)
    sh = D.shard_matrix(TF.csr_to_spc5(csr, 2, 4), 1, cb=32, tune=False,
                        device="cpu")
    x = np.random.default_rng(2).standard_normal(csr.shape[1]).astype(
        np.float32)
    y64 = csr.to_dense().astype(np.float64) @ x.astype(np.float64)
    reg = obs.get_registry()
    before = len(reg.spans())
    for gather in (True, False):
        y = D.make_distributed_spmv(sh, gather=gather)(torch.from_numpy(x))
        y = y.numpy() if gather else y.numpy()[0, :csr.shape[0]]
        np.testing.assert_allclose(y, y64, rtol=0,
                                   atol=TOL * float(np.abs(y64).max()))
    spans = [e for e in reg.spans()[before:] if e.name == "distributed.spmv"]
    assert len(spans) == 2
    assert json.loads(json.dumps(spans[0].attrs, sort_keys=True)) == {
        "layout": "whole_vector", "ndev": 1, "lowering": sh.lowering}
    with pytest.raises(ValueError, match="2 shards"):
        D.make_distributed_spmv(D.shard_matrix(
            TF.csr_to_spc5(csr, 2, 4), 2, tune=False, device="cpu"))


def test_assembly_adds_each_slab_at_its_row_start():
    """The slab assembly of the gather path: slabs overlap only where the
    earlier slab holds its padding zeros."""
    slabs = torch.tensor([[1.0, 2.0, 0.0, 0.0], [3.0, 4.0, 5.0, 0.0]])
    y = D._assemble(slabs, torch.tensor([0, 2], dtype=torch.int32), 5)
    assert y.tolist() == [1.0, 2.0, 3.0, 4.0, 5.0]
