"""The port's SparseLinear layer against the JAX package's, on the CPU.

Both layers are built from the same numpy weight (made from a seed) with the
same density, block, explicit ``layout=``, ``lowering="mask"`` and
``tune=False``; the port's on ``device="cpu"``, where its kernel wrappers
take the plain PyTorch versions. The JAX layer runs its Pallas kernels in
interpret mode and its jnp oracle, as its own tests do.

Tolerance for outputs: ``rtol=1e-5``, ``atol=1e-5 * max|y_ref|`` (the f32
sums of a row are taken in another order). Plan arrays must be byte-equal.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import formats as JF
from repro.core import matgen as JM
from repro.core import selector as JS
from repro.core import sparse_linear as JL
from repro_torch.core import formats as TF
from repro_torch.core import matgen as TM
from repro_torch.core import sparse_linear as TL
from repro_torch.kernels import spc5_spmm as KM
from repro_torch.kernels import spc5_spmv as K

RTOL = 1e-5
GEOM = {"whole_vector": dict(cb=16), "panels": dict(pr=64, xw=64, cb=16)}


def assert_close(y, y_ref):
    y_ref = np.asarray(y_ref)
    np.testing.assert_allclose(np.asarray(y), y_ref, rtol=RTOL,
                               atol=RTOL * float(np.abs(y_ref).max()))


def assert_arrays_byte_equal(tplan, jplan):
    assert len(tplan.arrays) == len(jplan.arrays)
    for t, j in zip(tplan.arrays, jplan.arrays):
        j = np.asarray(j)
        if t.dtype == torch.bfloat16:     # bf16 as bit patterns, both sides
            t, j = t.view(torch.int16), j.view(np.int16)
        t = t.cpu().numpy()
        if j.dtype == np.uint32:          # masks travel as an int32 view
            t = t.view(np.uint32)
        assert t.dtype == j.dtype and t.shape == j.shape
        assert t.tobytes() == j.tobytes()


def _weight(n=300, m=200, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, m)).astype(np.float32),
            rng.standard_normal(n).astype(np.float32))


def _pair(layout, block=(4, 8), bias=None, w=None, **kw):
    w = _weight()[0] if w is None else w
    args = dict(density=0.2, block=block, bias=bias, layout=layout,
                lowering="mask", tune=False, **GEOM.get(layout, {}), **kw)
    return (JL.SparseLinear.from_dense(w, **args),
            TL.SparseLinear.from_dense(w, device="cpu", **args))


@pytest.mark.parametrize("layout", ["whole_vector", "panels"])
@pytest.mark.parametrize("rc", TF.SUPPORTED_BLOCKS)
def test_from_dense_builds_byte_equal_plans(rc, layout):
    jl, tl = _pair(layout, block=rc)
    assert tl.plan.layout == jl.handle.layout == layout
    assert_arrays_byte_equal(tl.plan, jl.handle)
    assert dict(tl.plan.meta) == dict(jl.handle.meta)
    assert tl.shape == tuple(jl.shape) and tl.density == jl.density


@pytest.mark.parametrize("bias", [False, True])
@pytest.mark.parametrize("shape", [(200,), (1, 200), (5, 200), (2, 3, 200)])
@pytest.mark.parametrize("layout", ["whole_vector", "panels"])
def test_forward_matches_reference(layout, shape, bias):
    """Batch 1 takes the SpMV route, wider batches the SpMM route, in both
    packages; x of shape (d_in,) comes back as (d_out,)."""
    w, b = _weight()
    jl, tl = _pair(layout, bias=b if bias else None, w=w)
    x = np.random.default_rng(3).standard_normal(shape).astype(np.float32)
    y = tl(torch.from_numpy(x))
    assert y.dtype == torch.float32 and y.shape == (*shape[:-1], 300)
    y = y.numpy()
    xj = jnp.asarray(x)
    assert_close(y, jl(xj, use_pallas=True))
    assert_close(y, jl(xj, use_pallas=False))
    dense = JL.prune_by_magnitude(w, 0.2).astype(np.float64)
    want = x.astype(np.float64) @ dense.T + (b if bias else 0.0)
    assert_close(y, want)


def test_forward_routes_batch_one_to_spmv(monkeypatch):
    """The port routes as the reference does (sparse_linear.py:114-127):
    batch 1 to ops.spmv, a wider batch to ops.spmm on a contiguous
    (d_in, batch) copy."""
    _, tl = _pair("panels")
    calls = []
    for name in ("spmv", "spmm"):
        real = getattr(TL.ops, name)

        def spy(plan, x, *a, _name=name, _real=real, **kw):
            calls.append((_name, tuple(x.shape), x.is_contiguous()))
            return _real(plan, x, *a, **kw)
        monkeypatch.setattr(TL.ops, name, spy)
    tl(torch.zeros(1, 200))
    tl(torch.zeros(200))
    tl(torch.zeros(2, 3, 200))
    assert calls == [("spmv", (200,), True), ("spmv", (200,), True),
                     ("spmm", (200, 6), True)]


def test_layer_is_a_module_with_a_bias_buffer_and_no_parameters():
    _, tl = _pair("whole_vector", bias=_weight()[1])
    assert isinstance(tl, torch.nn.Module)
    assert list(tl.parameters()) == []
    assert set(tl.state_dict()) == {"bias"}
    assert tl.bias.dtype == torch.float32 and tl.bias.shape == (300,)
    _, plain = _pair("whole_vector")
    assert plain.bias is None and list(plain.state_dict()) == []


@pytest.mark.parametrize("nvec,want", [(1, "whole_vector"), (128, "panels")])
def test_auto_layout_with_nvec_matches_reference(nvec, want):
    """from_dense's nvec (default 128) feeds the auto layout's budget in
    both packages: a 3000 x 1200 layer is whole-vector at nvec=1 and panels
    at nvec=128."""
    w = np.random.default_rng(4).standard_normal((3000, 1200)).astype(
        np.float32)
    kw = dict(density=0.01, block=(4, 4), lowering="mask", tune=False)
    if nvec != 128:
        kw["nvec"] = nvec
    jl = JL.SparseLinear.from_dense(w, **kw)
    tl = TL.SparseLinear.from_dense(w, device="cpu", **kw)
    assert tl.plan.layout == jl.handle.layout == want
    strip = [{k: v for k, v in e.items() if k != "duration_s"}
             for e in tl.plan.trace]
    assert strip == [{k: v for k, v in e.items() if k != "duration_s"}
                     for e in jl.handle.trace]


@pytest.mark.parametrize("case", ["fem_4", "fem_2", "pruned_0.1",
                                  "pruned_0.5"])
def test_choose_block_matches_reference(case):
    if case.startswith("fem"):
        bs = int(case[-1])
        jcsr = JM.fem_blocks(800, bs, 6, seed=1)
        tcsr = TM.fem_blocks(800, bs, 6, seed=1)
    else:
        w = np.random.default_rng(5).standard_normal((160, 128)).astype(
            np.float32)
        density = float(case.split("_")[1])
        jcsr = JF.csr_from_dense(JL.prune_by_magnitude(w, density))
        tcsr = TF.csr_from_dense(TL.prune_by_magnitude(w, density))
    for rc in TF.SUPPORTED_BLOCKS:
        assert TF.block_stats(tcsr, *rc) == JF.block_stats(jcsr, *rc)
        assert TF.beta_breakeven_avg(*rc) == JF.beta_breakeven_avg(*rc)
    assert TL.choose_block(tcsr) == JL.choose_block(jcsr)


def test_from_dense_without_block_uses_choose_block():
    w = _weight()[0]
    jl = JL.SparseLinear.from_dense(w, density=0.3, layout="whole_vector",
                                    lowering="mask", tune=False)
    tl = TL.SparseLinear.from_dense(w, density=0.3, layout="whole_vector",
                                    lowering="mask", tune=False, device="cpu")
    assert (tl.plan.r, tl.plan.c) == (jl.handle.r, jl.handle.c)
    assert_arrays_byte_equal(tl.plan, jl.handle)


def test_prune_by_magnitude_matches_reference():
    w = _weight()[0]
    for density in (0.05, 0.5, 1.0):
        t = TL.prune_by_magnitude(w, density)
        assert t.tobytes() == JL.prune_by_magnitude(w, density).tobytes()


@pytest.mark.parametrize("layout", ["whole_vector", "panels"])
def test_from_arrays_reproduces_a_jax_layer(layout):
    w, b = _weight()
    jl = JL.SparseLinear.from_dense(w, density=0.2, block=(2, 8), bias=b,
                                    layout=layout, lowering="mask",
                                    tune=False, **GEOM[layout])
    tl = TL.SparseLinear.from_arrays(layout, jl.handle.arrays, jl.handle.meta,
                                     np.asarray(jl.bias), device="cpu")
    assert_arrays_byte_equal(tl.plan, jl.handle)
    x = np.random.default_rng(8).standard_normal((4, 200)).astype(np.float32)
    assert_close(tl(torch.from_numpy(x)).numpy(),
                 jl(jnp.asarray(x), use_pallas=False))
    assert_close(tl(torch.from_numpy(x[0])).numpy(),
                 jl(jnp.asarray(x[0]), use_pallas=False))


@pytest.mark.parametrize("kw", [
    dict(store=JS.RecordStore([])), dict(reorder="rcm"), dict(verify=True),
])
def test_unported_options_raise(kw):
    """A store and ``verify`` stay refusals. ``reorder`` (once refused)
    builds the reference's layer, whose forward the port's matches."""
    w = _weight()[0]
    if "reorder" not in kw:
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            TL.SparseLinear.from_dense(w, density=0.2, block=(2, 4),
                                       device="cpu", **kw)
        return
    tl = TL.SparseLinear.from_dense(w, density=0.2, block=(2, 4),
                                    device="cpu", tune=False, **kw)
    jl = JL.SparseLinear.from_dense(w, density=0.2, block=(2, 4),
                                    tune=False, **kw)
    assert tl.plan.strategy == jl.handle.strategy
    assert tl.plan.is_reordered == jl.handle.is_reordered
    assert_arrays_byte_equal(tl.plan, jl.handle)
    x = np.random.default_rng(8).standard_normal((4, 200)).astype(np.float32)
    assert_close(tl(torch.from_numpy(x)).numpy(),
                 jl(jnp.asarray(x), use_pallas=False))


@pytest.mark.parametrize("vdtype", ["bf16", "int8"])
def test_quantised_layer_matches_reference(vdtype):
    """``from_dense(vdtype=...)`` builds the reference's quantised plan
    byte for byte (int8 scales included) and its forward matches the
    reference's, batch 1 and wider, in f32."""
    w = _weight()[0]
    kw = dict(density=0.2, block=(2, 4), vdtype=vdtype, tune=False)
    tl = TL.SparseLinear.from_dense(w, device="cpu", **kw)
    jl = JL.SparseLinear.from_dense(w, **kw)
    assert tl.plan.vdtype == vdtype
    assert_arrays_byte_equal(tl.plan, jl.handle)
    x = np.random.default_rng(9).standard_normal((4, 200)).astype(np.float32)
    for xb in (x, x[0]):
        y = tl(torch.from_numpy(xb))
        assert y.dtype == torch.float32
        assert_close(y.numpy(), jl(jnp.asarray(xb), use_pallas=False))


def test_choose_block_with_a_store_raises():
    csr = TF.csr_from_dense(TL.prune_by_magnitude(_weight()[0], 0.2))
    with pytest.raises(NotImplementedError, match="ROADMAP queue 1, item 6"):
        TL.choose_block(csr, JS.RecordStore([]))


def test_from_dense_without_device_needs_a_card():
    w = _weight()[0]
    if torch.cuda.is_available():
        layer = TL.SparseLinear.from_dense(w, density=0.2, block=(2, 4))
        assert layer.plan.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            TL.SparseLinear.from_dense(w, density=0.2, block=(2, 4))


def test_cpu_layer_launches_no_kernel():
    _, tl = _pair("panels")
    K.reset_launches()
    KM.reset_launches()
    tl(torch.zeros(200))
    tl(torch.zeros(3, 200))
    assert not any(K.LAUNCHES.values()) and not any(KM.LAUNCHES.values())
