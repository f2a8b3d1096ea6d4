"""The test split's two tail kernels, host side: the SpMV tail
(``spmv_tail_cuda``) and the bucketed SpMM tail (``spmm_tail_cuda``).

Their launch planning (``spc5_spmv_tail.tail_launch`` / ``spmm_tail_cta``
/ ``spmm_tail_launch``, with the card's occupancy faked) and the SpMM
kernel's shared memory against a copy of the source's ``tail_layout``; the
SpMM tail's plain version ``ref_spmv.spmm_coo_panels`` against the
reference's jnp ``spmm_coo`` on globalized rows; both wrappers on the CPU
(their plain versions) against the reference's ``spmv_tail_pallas`` in
interpret mode and its jnp ``spmm_coo`` on the same buckets; the test
layout's SpMM, whose bucketed tail now goes through ``spmm_tail_cuda``,
against the reference. The CUDA kernels themselves run in
``tests/test_torch_gpu.py`` on the card.

Tolerance for outputs: ``rtol=1e-5``, ``atol=1e-5 * max|y_ref|`` (the f32
products of a row are summed in another order).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import formats as JF
from repro.core import matgen as JM
from repro.core import ref_spmv as JR
from repro.kernels import ops as jops
from repro.kernels import spc5_spmv as JK
from repro_torch.core import formats as TF
from repro_torch.core import matgen as TM
from repro_torch.core import ref_spmv as TR
from repro_torch.kernels import ops as tops
from repro_torch.kernels import spc5_spmm as KM
from repro_torch.kernels import spc5_spmv as K
from repro_torch.kernels import spc5_spmv_tail as KT

RTOL = 1e-5
CPU = torch.device("cpu")


def assert_close(y, y_ref):
    y_ref = np.asarray(y_ref)
    np.testing.assert_allclose(np.asarray(y), y_ref, rtol=RTOL,
                               atol=RTOL * max(float(np.abs(y_ref).max()),
                                               1e-30))


# ----------------------------------------------------------------------------
# launch planning on a faked card
# ----------------------------------------------------------------------------

#: A copy of the source's tail_layout (csrc/spc5_spmv_tail.cu), kept apart
#: from the wrapper's formula so that a change to one shows here.
def _tail_layout_copy(tw, vec, tile, threads):
    def r16(n):
        return (n + 15) & ~15
    groups = threads // (tw // vec)
    slots = r16(4 * tile * tw)
    heads = slots + r16(8 * groups * tw)
    scratch = heads + 16 * groups
    lst = scratch + 16 * (threads // 32)
    stage = lst + 64 * threads
    return stage + 48 * threads


@pytest.mark.parametrize("tw,vec,tile,threads", [
    (tw, vec, tile, threads)
    for tw, vec in ((1, 1), (4, 1), (8, 2), (16, 4), (32, 1), (64, 2),
                    (128, 4))
    for tile in (1, 16, 32, 64) for threads in (32, 64, 128, 256, 512)
    if threads >= tw // vec])
def test_spmm_tail_smem_matches_the_source(tw, vec, tile, threads):
    assert KT.spmm_tail_smem_bytes(tw, vec, tile, threads) == \
        _tail_layout_copy(tw, vec, tile, threads)


def _ctas_per_sm(threads, smem, regs=64):
    """CTAs an H100 SM holds by threads, shared memory and registers."""
    by_smem = (KM.SM_SMEM_BYTES // (smem + 1024)) if smem else 32
    return max(1, min(2048 // threads, by_smem,
                      KM.SM_REGISTERS // (regs * threads), 32))


@pytest.fixture
def fake_card(monkeypatch):
    """132 SMs and the occupancy ``_ctas_per_sm`` reckons (the wrappers ask
    the CUDA runtime on the card); records what was asked."""
    asked = []

    def spmv(threads, device):
        asked.append(("spmv", threads))
        return _ctas_per_sm(threads, 0, 40), 132

    def spmm(vec, threads, smem, device):
        asked.append(("spmm", vec, threads, smem))
        return _ctas_per_sm(threads, smem), 132
    monkeypatch.setattr(KT, "tail_occupancy", spmv)
    monkeypatch.setattr(KT, "spmm_tail_occupancy", spmm)
    return asked


#: (npanels, smax): the vocab test layer's tail (125 buckets of about 64 K
#: slots), one of the reference's tail test (20 buckets of a few slots) and
#: one bucket shorter than a group.
BUCKETS = {"vocab": (125, 64_321), "small": (20, 37), "one": (1, 5)}


@pytest.mark.parametrize("case", sorted(BUCKETS))
def test_spmv_tail_launch_splits_each_bucket(case, fake_card):
    npanels, smax = BUCKETS[case]
    groups = KT.tail_groups(smax)
    launch = KT.tail_launch(npanels, smax, device=CPU)
    per_sm = _ctas_per_sm(KT.TAIL_THREADS, 0, 40)
    assert fake_card[-1] == ("spmv", KT.TAIL_THREADS)
    assert launch["threads"] == KT.TAIL_THREADS and launch["smem_bytes"] == 0
    assert (launch["ctas_per_sm"], launch["sms"]) == (per_sm, 132)
    assert launch["split"] == K.panels_split(npanels, groups, per_sm, 132)
    assert launch["grid"] == npanels * launch["split"]
    assert launch["groups"] == groups == -(-smax // 128)
    assert launch["groups_per_cta"] == -(-groups // launch["split"])
    if case == "vocab":
        # about SPLIT_WAVES waves of the card's CTAs, several groups a CTA
        assert launch["grid"] >= K.SPLIT_WAVES * per_sm * 132
        assert launch["groups_per_cta"] >= 8
    for split in (1, groups):
        forced = KT.tail_launch(npanels, smax, device=CPU, split=split)
        assert forced["split"] == split and forced["grid"] == npanels * split
    for split in (0, groups + 1):
        with pytest.raises(ValueError, match="split must be in"):
            KT.tail_launch(npanels, smax, device=CPU, split=split)


def test_spmv_tail_threads_are_whole_warps(fake_card, monkeypatch):
    for threads in (128, 512):
        monkeypatch.setattr(KT, "TAIL_THREADS", threads)
        assert KT.tail_launch(125, 64_321, device=CPU)["threads"] == threads
    for threads in (16, 100, 1024):
        monkeypatch.setattr(KT, "TAIL_THREADS", threads)
        with pytest.raises(ValueError, match="whole warps"):
            KT.tail_launch(125, 64_321, device=CPU)


@pytest.mark.parametrize("nvec", [1, 3, 16, 100, 128, 256])
def test_spmm_tail_launch_on_a_faked_card(nvec, fake_card):
    """The widest tile of up to 128 columns (four a lane where nvec allows),
    512 threads for a whole warp of lanes else 128, the Y tile of
    SPMM_TAIL_TILE_ROWS rows, and G the panel kernels' split of every group
    over the column tiles."""
    slots = 125 * 64_321
    vec = KM.panels_vector(nvec)
    launch = KT.spmm_tail_launch(slots, nvec, vec, device=CPU)
    tw = min(128, 32 * vec, 1 << max(0, nvec - 1).bit_length())
    v = min(vec, tw)
    assert (launch["tile_columns"], launch["vector"]) == (tw, v)
    assert launch["lanes"] == tw // v
    assert launch["threads"] == (512 if tw // v == 32 else 128)
    assert launch["tile_rows"] == KT.SPMM_TAIL_TILE_ROWS
    assert launch["smem_bytes"] == _tail_layout_copy(
        tw, v, KT.SPMM_TAIL_TILE_ROWS, launch["threads"])
    assert fake_card[-1] == ("spmm", v, launch["threads"],
                             launch["smem_bytes"])
    per_sm = _ctas_per_sm(launch["threads"], launch["smem_bytes"])
    ntiles = -(-nvec // tw)
    groups = -(-slots // 128)
    assert launch["ntiles"] == ntiles and launch["groups"] == groups
    assert launch["grid"] == K.panels_split(ntiles, groups, per_sm, 132)
    assert launch["groups_per_cta"] == -(-groups // launch["grid"])
    for grid in (1, groups):
        assert KT.spmm_tail_launch(slots, nvec, vec, device=CPU,
                                   grid=grid)["grid"] == grid
    for grid in (0, groups + 1):
        with pytest.raises(ValueError, match="grid must be in"):
            KT.spmm_tail_launch(slots, nvec, vec, device=CPU, grid=grid)


@pytest.mark.parametrize("threads", [64, 128, 256, 512])
def test_spmm_tail_threads_knob(threads, fake_card, monkeypatch):
    monkeypatch.setattr(KT, "SPMM_TAIL_THREADS", threads)
    launch = KT.spmm_tail_launch(10_000, 128, 4, device=CPU)
    assert launch["threads"] == threads
    assert launch["smem_bytes"] == _tail_layout_copy(128, 4, 32, threads)
    monkeypatch.setattr(KT, "SPMM_TAIL_THREADS", 384)
    with pytest.raises(ValueError, match="power of two"):
        KT.spmm_tail_launch(10_000, 128, 4, device=CPU)


def test_spmm_tail_tile_rows_knob(fake_card, monkeypatch):
    for rows in (16, 64):
        monkeypatch.setattr(KT, "SPMM_TAIL_TILE_ROWS", rows)
        launch = KT.spmm_tail_launch(10_000, 16, 4, device=CPU)
        assert launch["tile_rows"] == rows
        assert launch["smem_bytes"] == _tail_layout_copy(16, 4, rows, 128)


# ----------------------------------------------------------------------------
# the plain SpMM tail against the reference
# ----------------------------------------------------------------------------

def _random_buckets(npanels=6, smax=23, pr=8, m=40, seed=3):
    """Buckets as ``_bucket_tail_by_panel`` makes them: each sorted by (row,
    column), then padded with zero values at local row 0 and column 0."""
    rng = np.random.default_rng(seed)
    rows = np.zeros((npanels, smax), np.int32)
    cols = np.zeros((npanels, smax), np.int32)
    vals = np.zeros((npanels, smax), np.float32)
    for p in range(npanels):
        n = int(rng.integers(1, smax + 1))
        r = rng.integers(0, pr, n)
        c = rng.integers(0, m, n)
        order = np.lexsort((c, r))
        rows[p, :n], cols[p, :n] = r[order], c[order]
        vals[p, :n] = rng.standard_normal(n)
    return rows, cols, vals, pr, m


def _reference_spmm_tail(rows, cols, vals, x, pr, nrows):
    """The reference's bucketed SpMM tail, as its _lower_spmm_test computes
    it: jnp spmm_coo over the globalized rows, cut at nrows."""
    npanels = rows.shape[0]
    grows = np.arange(npanels, dtype=np.int32)[:, None] * pr + rows
    return np.asarray(JR.spmm_coo(jnp.asarray(grows.reshape(-1)),
                                  jnp.asarray(cols.reshape(-1)),
                                  jnp.asarray(vals.reshape(-1)),
                                  jnp.asarray(x),
                                  nrows=npanels * pr))[:nrows]


@pytest.mark.parametrize("nvec", [1, 5, 16])
@pytest.mark.parametrize("nrows", [48, 45])
def test_spmm_coo_panels_matches_reference(nvec, nrows):
    rows, cols, vals, pr, m = _random_buckets()
    x = np.random.default_rng(4).standard_normal((m, nvec)).astype(
        np.float32)
    y = TR.spmm_coo_panels(*map(torch.from_numpy, (rows, cols, vals, x)),
                           pr=pr, nrows=nrows)
    assert y.shape == (nrows, nvec) and y.dtype == torch.float32
    assert_close(y, _reference_spmm_tail(rows, cols, vals, x, pr, nrows))


def test_spmm_coo_panels_multiplies_the_padding():
    """Padding slots (value 0 at local row 0, column 0) are multiplied, as
    the reference multiplies them: inf in X's row 0 reaches each padded
    bucket's first row as NaN, in both packages."""
    rows, cols, vals, pr, m = _random_buckets()
    x = np.ones((m, 2), np.float32)
    x[0] = np.inf
    y = TR.spmm_coo_panels(*map(torch.from_numpy, (rows, cols, vals, x)),
                           pr=pr, nrows=48).numpy()
    ref = _reference_spmm_tail(rows, cols, vals, x, pr, 48)
    padded = [p for p in range(rows.shape[0]) if vals[p, -1] == 0]
    assert padded
    for p in padded:
        assert np.isnan(y[p * pr]).all() and np.isnan(ref[p * pr]).all()
    np.testing.assert_array_equal(np.isnan(y), np.isnan(ref))


# ----------------------------------------------------------------------------
# both wrappers on the CPU against the reference's tail
# ----------------------------------------------------------------------------

def _wide_csr():
    rng = np.random.default_rng(3)
    d = ((rng.random((300, 40_000)) < 3e-3)
         * rng.standard_normal((300, 40_000))).astype(np.float32)
    return JF.csr_from_dense(d), TF.csr_from_dense(d)


#: The three bucket geometries the card's checks use: the reference's tail
#: test (powerlaw(320), pr=16, xw=32, cb=8), nrows % pr != 0, and buckets
#: spanning more than 12,288 columns.
GEOMETRIES = {
    "powerlaw": (lambda: (JM.powerlaw(320, 5, seed=17),
                          TM.powerlaw(320, 5, seed=17)),
                 dict(pr=16, xw=32, cb=8)),
    "ragged": (lambda: (JM.powerlaw(330, 5, seed=17),
                        TM.powerlaw(330, 5, seed=17)),
               dict(pr=16, xw=32, cb=8)),
    "wide": (_wide_csr, dict(pr=64, xw=512, cb=16)),
}


def _plans(case, rc=(2, 4)):
    make, geom = GEOMETRIES[case]
    jcsr, tcsr = make()
    kw = dict(layout="test", multi_layout="panels", lowering="mask",
              tune=False, **geom)
    return (jops.prepare(JF.csr_to_spc5(jcsr, *rc), **kw),
            tops.prepare(TF.csr_to_spc5(tcsr, *rc), device="cpu", **kw))


@pytest.mark.parametrize("case", sorted(GEOMETRIES))
def test_both_tail_wrappers_match_the_reference(case):
    """On the CPU the wrappers take their plain versions and launch
    nothing: ``spmv_tail_cuda`` against ``spmv_tail_pallas`` in interpret
    mode, ``spmm_tail_cuda`` against the reference's jnp ``spmm_coo`` on the
    globalized buckets, at nvec 1, 3, 16 and 128."""
    jplan, tplan = _plans(case)
    n = tplan.nrows
    assert tplan.tail_pr and tplan.n_single
    if case == "ragged":
        assert n % tplan.tail_pr
    if case == "wide":
        assert tplan.tail_xw > 12_288
    KT.reset_launches()
    rng = np.random.default_rng(5)
    x = rng.standard_normal(tplan.ncols).astype(np.float32)
    y = KT.spmv_tail_cuda(tplan.tail_xbase, tplan.single_rows,
                          tplan.single_cols, tplan.single_values,
                          torch.from_numpy(x), pr=tplan.tail_pr,
                          xw=tplan.tail_xw, nrows=n,
                          ncols_pad=tplan.tail_ncols_pad, split=1)
    y_pallas = JK.spmv_tail_pallas(
        jplan.tail_xbase, jplan.single_rows, jplan.single_cols,
        jplan.single_values, jnp.asarray(x), pr=jplan.tail_pr,
        xw=jplan.tail_xw, nrows=n, ncols_pad=jplan.tail_ncols_pad,
        interpret=True)
    assert y.shape == (n,)
    assert_close(y, y_pallas)
    rows, cols, vals = (np.asarray(a) for a in (
        jplan.single_rows, jplan.single_cols, jplan.single_values))
    for nvec in (1, 3, 16, 128):
        xm = rng.standard_normal((tplan.ncols, nvec)).astype(np.float32)
        ym = KT.spmm_tail_cuda(tplan.single_rows, tplan.single_cols,
                               tplan.single_values, torch.from_numpy(xm),
                               pr=tplan.tail_pr, nrows=n, grid=1)
        assert ym.shape == (n, nvec)
        assert_close(ym, _reference_spmm_tail(rows, cols, vals, xm,
                                              jplan.tail_pr, n))
    assert KT.LAUNCHES == {"spmv_tail_cuda": 0, "spmm_tail_cuda": 0}


def test_spmm_tail_wrapper_keeps_the_nvt_rule_and_checks_operands():
    _, tplan = _plans("powerlaw")
    args = [tplan.single_rows, tplan.single_cols, tplan.single_values]
    kw = dict(pr=tplan.tail_pr, nrows=tplan.nrows)
    x = torch.zeros(tplan.ncols, 130)
    with pytest.raises(ValueError, match="not divisible"):
        KT.spmm_tail_cuda(*args, x, **kw)
    assert KT.spmm_tail_cuda(*args, x, nvt=130, **kw).shape == (
        tplan.nrows, 130)
    with pytest.raises(ValueError, match="2-D"):
        KT.spmm_tail_cuda(*args, torch.zeros(tplan.ncols), **kw)
    x16 = torch.zeros(tplan.ncols, 16)
    with pytest.raises(ValueError, match="contiguous"):
        KT.spmm_tail_cuda(*args, x[:, :16], **kw)
    with pytest.raises(TypeError, match="float32"):
        KT.spmm_tail_cuda(*args[:2], args[2].double(), x16, **kw)
    with pytest.raises(TypeError, match="int32"):
        KT.spmm_tail_cuda(args[0].long(), *args[1:], x16, **kw)
    with pytest.raises(ValueError, match="cannot hold"):
        KT.spmm_tail_cuda(*args, x16, pr=tplan.tail_pr, nrows=10_000)
    with pytest.raises(ValueError, match="no kernel"):
        KT.spmm_tail_cuda(*[a.to("meta") for a in args], x16.to("meta"),
                          **kw)


# ----------------------------------------------------------------------------
# the test layout's SpMM through the tail wrapper
# ----------------------------------------------------------------------------

def _fem_pair(rc):
    """fem_blocks(1_200, 4, 6) thinned plus a random scatter: singletons
    and multi blocks both occur."""
    d = JM.fem_blocks(1_200, 4, 6, seed=3).to_dense()[:, :1_100]
    keep = np.random.default_rng(0).random(d.shape) < 0.3
    rng = np.random.default_rng(1)
    d = np.where(keep, d, 0.0) + ((rng.random(d.shape) < 2e-3)
                                  * rng.standard_normal(d.shape))
    d = d.astype(np.float32)
    return (JF.csr_to_spc5(JF.csr_from_dense(d), *rc),
            TF.csr_to_spc5(TF.csr_from_dense(d), *rc))


@pytest.mark.parametrize("lowering", ["mask", "descriptor"])
@pytest.mark.parametrize("multi_layout", ["whole_vector", "panels"])
@pytest.mark.parametrize("rc", [(1, 8), (2, 4), (4, 8)])
def test_test_plan_spmm_matches_reference(rc, multi_layout, lowering,
                                          monkeypatch):
    """``ops.spmm`` on a test plan: a bucketed tail (panel multi) goes
    through ``spmm_tail_cuda`` (its plain version here), a flat tail
    (whole-vector multi) through ``spmm_coo``; both match the reference's
    executor within rtol 1e-5 at nvec 16 and 128."""
    jmat, tmat = _fem_pair(rc)
    kw = dict(layout="test", multi_layout=multi_layout, lowering=lowering,
              tune=False, pr=16, xw=32, cb=8)
    jplan = jops.prepare(jmat, **kw)
    tplan = tops.prepare(tmat, device="cpu", **kw)
    assert tplan.n_single and bool(tplan.tail_pr) == (
        multi_layout == "panels")
    calls = []
    wrapper = KT.spmm_tail_cuda

    def spy(*args, **kwargs):
        calls.append(kwargs)
        return wrapper(*args, **kwargs)
    monkeypatch.setattr(KT, "spmm_tail_cuda", spy)
    rng = np.random.default_rng(7)
    for nvec in (16, 128):
        x = rng.standard_normal((tplan.ncols, nvec)).astype(np.float32)
        y = tops.spmm(tplan, torch.from_numpy(x))
        assert y.shape == (tplan.nrows, nvec)
        assert_close(y, jops.spmm(jplan, jnp.asarray(x), use_pallas=False))
    if multi_layout == "panels":
        assert [c["pr"] for c in calls] == [tplan.tail_pr] * 2
        assert all(c["nvt"] == 128 and c["nrows"] == tplan.nrows
                   for c in calls)
    else:
        assert calls == []


def test_test_plan_spmm_matches_the_pallas_reference():
    """The reference with its Pallas multi kernel in interpret mode against
    the port, whose tail goes through ``spmm_tail_cuda``."""
    jmat, tmat = _fem_pair((2, 4))
    kw = dict(layout="test", multi_layout="panels", lowering="mask",
              tune=False, pr=16, xw=32, cb=8)
    jplan = jops.prepare(jmat, **kw)
    tplan = tops.prepare(tmat, device="cpu", **kw)
    x = np.random.default_rng(8).standard_normal(
        (tplan.ncols, 16)).astype(np.float32)
    assert_close(tops.spmm(tplan, torch.from_numpy(x)),
                 jops.spmm(jplan, jnp.asarray(x), use_pallas=True,
                           interpret=True))
