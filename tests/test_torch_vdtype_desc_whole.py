"""bf16 and int8 values in the whole-vector descriptor kernels
(``spmv_cuda_desc[_db]``, ``spmm_cuda_desc``) and bf16 values in both tail
kernels (``spmv_tail_cuda``, ``spmm_tail_cuda``): their host side on the
CPU, and the products of the plans that reach them against the reference.

* The wrappers' shared-memory formulas at 4-, 2- and 1-byte values
  (``spc5_spmv_desc.whole_smem_bytes``, ``spc5_spmm_desc.
  whole_stage_bytes`` / ``whole_smem_bytes``, ``spc5_spmv_tail.
  spmm_tail_smem_bytes`` at 4 and 2) against a copy of the C layouts
  (``whole_layout`` in ``csrc/spc5_spmv_desc.cu``, ``DescWhole<T>`` in
  ``csrc/spc5_spmm_desc.cu`` with ``whole_layout`` in
  ``csrc/spc5_spmm_whole.cuh``, ``tail_layout`` in ``csrc/spc5_spmv_tail.cu``,
  ``value_window`` in ``csrc/spc5_stage.cuh``), on the token plan's
  geometry (the yi-6b vocab weight at nvec 1, ``chip_smoke.py``), FEM's, a
  sliced one and small ones.
* A narrow width never needs a larger stage: with the card's occupancy
  faked, the f32 launch each wrapper plans on the token plan (and the tail
  kernels on the vocab test layer's buckets) takes no more shared memory
  at bf16 and int8, and the narrow launch keeps the threads and at least
  the CTAs an SM, the ring and the blocks or chunks a stage.
* The span rule (``spc5_spmv.value_span``) over bf16 (align 4) and int8
  whole-vector descriptor plans of both packages, in beta(2,4) on 40
  powerlaw matrices: every window's copy covers it and ends inside
  ``values``, and on some plans the uncut span reaches past ``values``.
* The CPU wrappers (their plain versions) on quantised stores against the
  reference's ``spmv_pallas_desc[_db]``, ``spmm_pallas_desc`` and
  ``spmv_tail_pallas`` in interpret mode, on byte-equal plans.
* ``ops.spmv`` / ``ops.spmm`` on the token plan as a batch-1 caller builds
  it (``prepare(mat, vdtype=...)``: whole-vector + descriptor by the cost
  model, at every width, in both packages) and on bf16 ``layout="test"``
  plans of both multi layouts and lowerings against the reference's jnp
  oracle and ``tests/test_vdtype.py``'s pins.

Tolerance: outputs within ``1e-5 * max|y_ref|`` of the reference's (f32
sums in another order); the pins are ``2**-7 * (|A| @ |x|)`` for bf16 and
``smax / 2 * ((|A| > 0) @ |x|)`` for int8, each plus 1e-5. The kernels on
the card are ``tests/test_torch_gpu.py``'s.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import formats as JF
from repro.core import matgen as JM
from repro.core import plan as JP
from repro.kernels import ops as jops
from repro.kernels import spc5_spmm as JKM
from repro.kernels import spc5_spmv as JK
from repro_torch.core import formats as TF
from repro_torch.core import matgen as TM
from repro_torch.core import plan as TP
from repro_torch.kernels import ops as tops
from repro_torch.kernels import spc5_spmm as KM
from repro_torch.kernels import spc5_spmm_desc as KDM
from repro_torch.kernels import spc5_spmv as K
from repro_torch.kernels import spc5_spmv_desc as KD
from repro_torch.kernels import spc5_spmv_tail as KT

RTOL = 1e-5
VSIZES = (4, 2, 1)
VDTYPES = ("bf16", "int8")
VDTYPE_SIZE = {"f32": 4, "bf16": 2, "int8": 1}
CPU = torch.device("cpu")


def _r16(n):
    return -(-n // 16) * 16


def _window(vsize, vmax):
    """``value_window`` in ``csrc/spc5_stage.cuh``."""
    return _r16(vsize * vmax) + (16 if vsize < 4 else 0)


def assert_close(y, y_ref):
    y, y_ref = np.asarray(y), np.asarray(y_ref)
    np.testing.assert_allclose(y, y_ref, rtol=RTOL,
                               atol=RTOL * max(float(np.abs(y_ref).max()),
                                               1e-30))


def error_bound(dense, x, vdtype):
    """``tests/test_vdtype.py``'s elementwise pin on |y - A @ x|."""
    absA, absx = np.abs(dense), np.abs(x)
    if vdtype == "bf16":
        return (2.0 ** -7) * (absA @ absx) + 1e-5
    smax = absA.max() / 127.0
    return 0.5 * smax * ((absA > 0).astype(np.float64) @ absx) + 1e-5


# ----------------------------------------------------------------------------
# shared-memory formulas against a copy of the C layouts
# ----------------------------------------------------------------------------

def _spmv_whole_copy(stages, nb, r, c, vmax, tile, wv, wx, vsize):
    """``whole_smem`` / ``whole_layout(a, vsize)`` in
    ``csrc/spc5_spmv_desc.cu``: the y tile, then per stage the value
    window, the valid and vidx runs, c xcol entries and a yrow word a
    block, and the 16-byte mbarrier slot."""
    rc = r * c
    valid = _window(vsize, vmax)
    vidx = valid + _r16(nb * rc)
    xcol = vidx + _r16(nb * rc * wv)
    yrow = xcol + _r16(nb * c * wx)
    bar = yrow + _r16(4 * nb)
    return _r16(4 * tile) + stages * (bar + 16)


def _desc_whole_stage_copy(q, nb, r, c, vmax, wv, wx, vsize):
    """``DescWhole<T>::stage_bytes`` in ``csrc/spc5_spmm_desc.cu``."""
    rc = r * c
    wmeta = q * _window(vsize, vmax)
    valid = wmeta + (_r16(8 * q) if vsize < 4 else 0)
    vidx = valid + _r16(nb * rc)
    xcol = vidx + _r16(nb * rc * wv)
    yrow = xcol + _r16(nb * c * wx)
    bar = yrow + _r16(4 * nb)
    return bar + 16


def _spmm_whole_copy(stages, q, nb, r, c, vmax, wv, wx, tw, vec, rows,
                     threads, vsize):
    """``whole_layout`` in ``csrc/spc5_spmm_whole.cuh`` with
    ``DescWhole<T>``'s stage."""
    groups = threads // (tw // vec)
    slots = _r16(4 * rows * tw)
    heads = slots + _r16(8 * groups * tw)
    scratch = heads + 16 * groups
    lst = scratch + 4 * 2 * 16 * 8
    ring = lst + 16 * min(q * vmax, nb * r * c)
    return ring + stages * _desc_whole_stage_copy(q, nb, r, c, vmax, wv, wx,
                                                  vsize)


def _tail_layout_copy(tw, vec, tile, threads, vsize):
    """``tail_layout`` in ``csrc/spc5_spmv_tail.cu``: the staged quad of
    values is 4 * vsize bytes a thread."""
    groups = threads // (tw // vec)
    slots = _r16(4 * tile * tw)
    heads = slots + _r16(8 * groups * tw)
    scratch = heads + 16 * groups
    lst = scratch + 16 * (threads // 32)
    stage = lst + 64 * threads
    return stage + (32 + 4 * vsize) * threads


#: (nb, r, c, vmax, tile, vidx bytes, xcol bytes): the token plan
#: (chip_smoke.py's vocab weight at nvec 1, 25,856 chunks of cb 256), FEM,
#: a chunk sliced into stages of 160 blocks, and small ones.
SPMV_GEOMETRIES = {
    "token": (256, 4, 8, 1_144, 512, 2, 2),
    "fem": (256, 4, 4, 4_096, 512, 2, 4),
    "sliced": (160, 4, 8, 40_960, 8, 4, 2),
    "small": (16, 2, 4, 40, 512, 1, 2),
    "tall": (12, 8, 4, 24, 32, 1, 4),
}


@pytest.mark.parametrize("vsize", VSIZES)
@pytest.mark.parametrize("case", sorted(SPMV_GEOMETRIES))
@pytest.mark.parametrize("stages", [1, 2])
def test_spmv_whole_desc_smem_matches_a_copy(stages, case, vsize):
    geom = SPMV_GEOMETRIES[case]
    assert KD.whole_smem_bytes(stages, *geom, vsize) == \
        _spmv_whole_copy(stages, *geom, vsize)
    if vsize == 4:
        assert KD.whole_smem_bytes(stages, *geom) == \
            _spmv_whole_copy(stages, *geom, 4)


#: (q, nb, r, c, vmax, vidx bytes, xcol bytes, tw, vec, tile rows,
#: threads): the token plan's rounds at nvec 128 and 16, FEM's one-chunk
#: round, a slice of a chunk, and a one-column tile of beta(8,4) chunks.
SPMM_GEOMETRIES = {
    "token128": (2, 512, 4, 8, 1_144, 2, 2, 128, 4, 16, 512),
    "token16": (1, 256, 4, 8, 1_144, 2, 2, 16, 4, 16, 256),
    "fem": (1, 256, 4, 4, 4_096, 2, 4, 16, 4, 16, 256),
    "sliced": (1, 160, 4, 8, 40_960, 4, 2, 16, 4, 16, 256),
    "narrow": (3, 36, 8, 4, 40, 1, 1, 1, 1, 16, 32),
}


@pytest.mark.parametrize("vsize", VSIZES)
@pytest.mark.parametrize("case", sorted(SPMM_GEOMETRIES))
@pytest.mark.parametrize("stages", [1, 2])
def test_spmm_whole_desc_smem_matches_a_copy(stages, case, vsize):
    q, nb, r, c, vmax, wv, wx = SPMM_GEOMETRIES[case][:7]
    assert KDM.whole_stage_bytes(q, nb, r, c, vmax, wv, wx, vsize) == \
        _desc_whole_stage_copy(q, nb, r, c, vmax, wv, wx, vsize)
    geom = SPMM_GEOMETRIES[case]
    assert KDM.whole_smem_bytes(stages, *geom, vsize) == \
        _spmm_whole_copy(stages, *geom, vsize)


@pytest.mark.parametrize("vsize", [4, 2])
@pytest.mark.parametrize("tw,vec,tile,threads", [
    (1, 1, 32, 32), (4, 1, 16, 128), (8, 2, 64, 128), (16, 4, 32, 128),
    (32, 1, 32, 512), (64, 2, 16, 512), (128, 4, 32, 512),
    (128, 4, 64, 512)])
def test_spmm_tail_smem_at_both_widths_matches_the_source(tw, vec, tile,
                                                          threads, vsize):
    """``spmm_tail_smem_bytes`` at f32 and bf16 values (a thread's staged
    quad is 48 or 40 bytes)."""
    assert KT.spmm_tail_smem_bytes(tw, vec, tile, threads, vsize) == \
        _tail_layout_copy(tw, vec, tile, threads, vsize)
    assert (KT.spmm_tail_smem_bytes(tw, vec, tile, threads, 4)
            - KT.spmm_tail_smem_bytes(tw, vec, tile, threads, 2)) == \
        8 * threads


# ----------------------------------------------------------------------------
# a narrow width never needs a larger stage
# ----------------------------------------------------------------------------

def _ctas_per_sm(smem, threads):
    """An H100 SM's CTAs by its 65,536 registers (64 a thread at most),
    2,048 threads, 32 CTAs and 228 KB of shared memory (1 KB of it reserved
    per CTA)."""
    return min(32, 2048 // threads, 65_536 // (64 * threads),
               (228 * 1024) // (smem + 1024))


@pytest.fixture
def fake_card(monkeypatch):
    """Every kernel's occupancy as an H100 of 132 SMs would answer it (the
    same at every width: the kernels' registers are not counted); records
    the widths asked for."""
    asked = []

    def spmv(layout, stages, threads, smem, device, vsize=4):
        asked.append(("spmv", vsize))
        return _ctas_per_sm(smem, threads), 132

    def spmm(r, c, vec, threads, smem, device, vsize=4):
        asked.append(("spmm", vsize))
        return _ctas_per_sm(smem, threads), 132

    def tail(threads, device, vsize=4):
        asked.append(("tail", vsize))
        return _ctas_per_sm(0, threads), 132

    def spmm_tail(vec, threads, smem, device, vsize=4):
        asked.append(("spmm_tail", vsize))
        return _ctas_per_sm(smem, threads), 132
    monkeypatch.setattr(KD, "_occupancy", spmv)
    monkeypatch.setattr(KDM, "whole_occupancy", spmm)
    monkeypatch.setattr(KT, "tail_occupancy", tail)
    monkeypatch.setattr(KT, "spmm_tail_occupancy", spmm_tail)
    return asked


#: The token plan (cb, r, c, vmax, nchunks, vidx bytes, xcol bytes), a
#: sliced whole-vector plan, and the vocab test layer's tail buckets
#: (npanels, smax).
TOKEN = (256, 4, 8, 1_144, 25_856, 2, 2)
SLICED = (1_280, 4, 8, 40_960, 8, 4, 2)
VOCAB_TAIL = (125, 64_377)


@pytest.mark.parametrize("vsize", [2, 1])
@pytest.mark.parametrize("geom", ["token", "sliced"])
@pytest.mark.parametrize("stages", [1, KD.WHOLE_DB_STAGES])
def test_spmv_whole_desc_narrow_launch_is_no_larger(fake_card, stages, geom,
                                                    vsize):
    """The whole-vector descriptor SpMV pair on the token plan and on a
    chunk whose stage must be sliced: the narrow launch takes no more
    shared memory, the same threads and ring, at least the blocks a stage
    and the CTAs an SM, and asks the card about its own width. The ring
    does not fit the sliced chunk at any width."""
    cb, r, c, vmax, nchunks, wv, wx = TOKEN if geom == "token" else SLICED
    kw = dict(cb=cb, r=r, c=c, vmax=vmax, wv=wv, wx=wx, device=CPU)
    if geom == "sliced" and stages > 1:
        for v in (4, vsize):
            with pytest.raises(ValueError, match="shared memory"):
                KD.whole_launch(stages, nchunks, vsize=v, **kw)
        return
    f32 = KD.whole_launch(stages, nchunks, **kw)
    q = KD.whole_launch(stages, nchunks, vsize=vsize, **kw)
    assert fake_card[-1] == ("spmv", vsize)
    assert q["smem_bytes"] <= f32["smem_bytes"]
    assert q["smem_bytes"] == KD.whole_smem_bytes(
        q["stages"], q["blocks_per_stage"], r, c, vmax, q["tile_rows"], wv,
        wx, vsize)
    assert (q["threads"], q["stages"]) == (f32["threads"], f32["stages"])
    assert q["blocks_per_stage"] >= f32["blocks_per_stage"]
    assert q["ctas_per_sm"] >= f32["ctas_per_sm"]
    if geom == "sliced":
        assert f32["blocks_per_stage"] < cb


@pytest.mark.parametrize("vsize", [2, 1])
@pytest.mark.parametrize("nvec", [16, 128])
def test_spmm_whole_desc_narrow_launch_is_no_larger(fake_card, nvec, vsize):
    """``spmm_cuda_desc`` on the token plan at nvec 16 and 128: the narrow
    launch keeps the tile, threads and at least the ring, the chunks a
    round and the CTAs an SM; its figure is the kernel's formula at that
    width, and the f32 round needs no more at it."""
    cb, r, c, vmax, nchunks, wv, wx = TOKEN
    kw = dict(cb=cb, r=r, c=c, vmax=vmax, nvec=nvec,
              vec=KM.panels_vector(nvec), wv=wv, wx=wx, device=CPU)
    f32 = KDM.whole_launch(nchunks, **kw)
    q = KDM.whole_launch(nchunks, vsize=vsize, **kw)
    assert fake_card[-1] == ("spmm", vsize)

    def smem(launch, v):
        return KDM.whole_smem_bytes(
            launch["stages"], launch["chunks_per_stage"],
            launch["blocks_per_stage"], r, c, vmax, wv, wx,
            launch["tile_columns"], launch["vector"], launch["tile_rows"],
            launch["threads"], v)
    assert smem(f32, vsize) <= f32["smem_bytes"] == smem(f32, 4)
    assert q["smem_bytes"] == smem(q, vsize)
    assert (q["tile_columns"], q["threads"]) == (f32["tile_columns"],
                                                 f32["threads"])
    assert q["stages"] >= f32["stages"]
    assert q["chunks_per_stage"] >= f32["chunks_per_stage"]
    assert q["ctas_per_sm"] >= f32["ctas_per_sm"]


@pytest.mark.parametrize("nvec", [16, 128])
def test_tail_launches_at_bf16_are_no_larger(fake_card, nvec):
    """Both tail kernels on the vocab test layer's buckets: the SpMV launch
    is the f32 one (no shared memory), the SpMM CTA stages 8 bytes a thread
    fewer and keeps its tile, threads and at least its CTAs an SM."""
    npanels, smax = VOCAB_TAIL
    f32 = KT.tail_launch(npanels, smax, device=CPU)
    bf = KT.tail_launch(npanels, smax, device=CPU, vsize=2)
    assert fake_card[-1] == ("tail", 2)
    assert bf == f32 and bf["smem_bytes"] == 0
    vec = KM.panels_vector(nvec)
    f32 = KT.spmm_tail_launch(npanels * smax, nvec, vec, device=CPU)
    bf = KT.spmm_tail_launch(npanels * smax, nvec, vec, device=CPU, vsize=2)
    assert fake_card[-1] == ("spmm_tail", 2)
    assert bf["smem_bytes"] == f32["smem_bytes"] - 8 * f32["threads"]
    assert bf["smem_bytes"] == KT.spmm_tail_smem_bytes(
        bf["tile_columns"], bf["vector"], bf["tile_rows"], bf["threads"], 2)
    for k in ("tile_columns", "vector", "threads", "tile_rows", "ntiles"):
        assert bf[k] == f32[k]
    assert bf["ctas_per_sm"] >= f32["ctas_per_sm"]


def test_tail_wrappers_refuse_int8_values():
    """The reference keeps an int8 plan's tail in f32 (a tail has no
    scale): int8 buckets are refused by both tail wrappers, on any
    device, before the plain version or a launch."""
    rows = torch.zeros((2, 4), dtype=torch.int32)
    vals = torch.ones((2, 4), dtype=torch.int8)
    with pytest.raises(ValueError, match="value_scale"):
        KT.spmv_tail_cuda(torch.zeros(2, dtype=torch.int32), rows, rows,
                          vals, torch.zeros(8), pr=4, xw=4, nrows=8,
                          ncols_pad=8)
    with pytest.raises(ValueError, match="value_scale"):
        KT.spmm_tail_cuda(rows, rows, vals, torch.zeros(8, 2), pr=4,
                          nrows=8)


def test_no_wrapper_refuses_a_quantised_store():
    """``_check_values`` keeps its int8-scale and scale-with-f32 checks and
    lost its refusal of quantised stores on the card: every kernel takes
    them (ROADMAP queue 2 A closed)."""
    import inspect
    assert list(inspect.signature(K._check_values).parameters) == [
        "fn", "values", "value_scale", "scale_shape"]
    bf = torch.zeros(4, dtype=torch.bfloat16)
    K._check_values("f", bf, None, (2,))
    with pytest.raises(NotImplementedError, match="int8 values only"):
        K._check_values("f", bf, torch.ones(2), (2,))
    with pytest.raises(ValueError, match="value_scale"):
        K._check_values("f", torch.zeros(4, dtype=torch.int8), None, (2,))
    with pytest.raises(ValueError, match="shape"):
        K._check_values("f", torch.zeros(4, dtype=torch.int8), torch.ones(3),
                        (2,))


# ----------------------------------------------------------------------------
# the span rule on whole-vector descriptor plans of both packages
# ----------------------------------------------------------------------------

SPAN_MATRICES = 40
#: bf16 windows start off a 16-byte boundary only below the default align 8
SPAN_ALIGN = {"bf16": 4, "int8": 8}


def _spans(vbase, vmax, vsize, nvalues):
    """Asserts what the kernels rely on for every window's span; returns
    how many of the uncut spans reach past ``values``."""
    past = 0
    for vb in np.asarray(vbase).ravel().tolist():
        start, nbytes, end = K.value_span(vb, vmax, vsize, nvalues)
        assert start % 16 == 0 and end % 16 == 0
        assert start <= vb * vsize and start + nbytes >= (vb + vmax) * vsize
        assert start + nbytes <= nvalues * vsize
        assert nbytes % 8 == 0 and nbytes <= K.value_window_bytes(vmax, vsize)
        past += end > nvalues * vsize
    return past


@pytest.mark.parametrize("cb", [16, 64])
@pytest.mark.parametrize("vdtype", VDTYPES)
@pytest.mark.parametrize("package", ["port", "reference"])
def test_whole_desc_spans_stay_inside_values(package, vdtype, cb):
    """Over the whole-vector descriptor plans of 40 powerlaw matrices in
    beta(2,4) (180 to 570 rows, 6 a row on average) at ``vdtype``, built by
    the port or by the reference: every window's copy stays inside
    ``values``, and on some plans the uncut span reaches past it (the cut
    is needed, so this test can fail)."""
    vsize = VDTYPE_SIZE[vdtype]
    kw = dict(layout="whole_vector", lowering="descriptor", vdtype=vdtype,
              tune=False, cb=cb, align=SPAN_ALIGN[vdtype])
    plans_past = 0
    for seed in range(SPAN_MATRICES):
        n = 180 + 10 * seed
        if package == "port":
            plan = tops.prepare(TF.csr_to_spc5(TM.powerlaw(n, 6, seed=seed),
                                               2, 4), device="cpu", **kw)
            vbase, vmax, nvalues = (plan.chunk_vbase, plan.vmax,
                                    plan.values.numel())
            assert plan.values.element_size() == vsize
        else:
            plan = jops.prepare(JF.csr_to_spc5(JM.powerlaw(n, 6, seed=seed),
                                               2, 4), **kw)
            values = np.asarray(plan.values)
            assert values.itemsize == vsize
            vbase, vmax, nvalues = (np.asarray(plan.chunk_vbase), plan.vmax,
                                    values.size)
        plans_past += _spans(vbase, vmax, vsize, nvalues) > 0
    assert plans_past > 0


# ----------------------------------------------------------------------------
# the CPU wrappers on quantised stores against the reference's kernels
# ----------------------------------------------------------------------------

def make_mat(rc, n=96, m=80, density=0.3, seed=0):
    """``tests/test_vdtype.py``'s matrix, for both packages."""
    rng = np.random.default_rng(seed)
    dense = ((rng.random((n, m)) < density)
             * rng.standard_normal((n, m))).astype(np.float32)
    return (dense, JF.csr_to_spc5(JF.csr_from_dense(dense), *rc),
            TF.csr_to_spc5(TF.csr_from_dense(dense), *rc))


def _whole_plans(rc, vdtype, align=8):
    dense, jmat, tmat = make_mat(rc, seed=rc[0] + 3 * rc[1])
    kw = dict(layout="whole_vector", lowering="descriptor", vdtype=vdtype,
              tune=False, cb=8, align=align)
    return dense, jops.prepare(jmat, **kw), tops.prepare(tmat, device="cpu",
                                                         **kw)


DESC_NAMES = ("chunk_vbase", "desc_valid", "desc_vidx", "desc_xcol",
              "desc_yrow", "values")
SPMV_REFS = {"spmv_cuda_desc": JK.spmv_pallas_desc,
             "spmv_cuda_desc_db": JK.spmv_pallas_desc_db}


@pytest.mark.parametrize("align", [4, 8])
@pytest.mark.parametrize("rc", [(1, 8), (2, 4), (4, 4), (4, 8)])
@pytest.mark.parametrize("vdtype", VDTYPES)
@pytest.mark.parametrize("kernel", sorted(SPMV_REFS))
def test_spmv_desc_wrappers_match_pallas(kernel, vdtype, rc, align):
    """Each whole-vector descriptor SpMV wrapper on a quantised plan (its
    plain version here: upcast, int8 scaled) against the reference's Pallas
    kernel in interpret mode on the reference's byte-equal plan, windows
    at align 4 and 8, and within the pins."""
    dense, jplan, tplan = _whole_plans(rc, vdtype, align)
    x = np.random.default_rng(2).standard_normal(dense.shape[1]).astype(
        np.float32)
    geom = dict(r=tplan.r, c=tplan.c, cb=tplan.cb, vmax=tplan.vmax,
                nrows=tplan.nrows, ncols=tplan.ncols)
    scale = tplan.value_scale if vdtype == "int8" else None
    jscale = jplan.value_scale if vdtype == "int8" else None
    y = getattr(KD, kernel)(*(getattr(tplan, a) for a in DESC_NAMES),
                            torch.from_numpy(x), scale, grid=1, **geom)
    y_ref = SPMV_REFS[kernel](*(getattr(jplan, a) for a in DESC_NAMES),
                              jnp.asarray(x), jscale, **geom, interpret=True)
    assert y.dtype == torch.float32 and y.shape == (dense.shape[0],)
    assert_close(y, y_ref)
    ref = dense.astype(np.float64) @ x.astype(np.float64)
    assert np.all(np.abs(y.numpy() - ref) <= error_bound(dense, x, vdtype))


@pytest.mark.parametrize("nvec", [4, 8])
@pytest.mark.parametrize("rc", [(1, 8), (2, 4), (4, 4), (4, 8)])
@pytest.mark.parametrize("vdtype", VDTYPES)
def test_spmm_desc_wrapper_matches_pallas(vdtype, rc, nvec):
    """``spmm_cuda_desc`` on a quantised plan against ``spmm_pallas_desc``
    in interpret mode on the reference's byte-equal plan, and within the
    pins column by column."""
    dense, jplan, tplan = _whole_plans(rc, vdtype)
    X = np.random.default_rng(4).standard_normal(
        (dense.shape[1], nvec)).astype(np.float32)
    geom = dict(r=tplan.r, c=tplan.c, cb=tplan.cb, vmax=tplan.vmax,
                nrows=tplan.nrows, ncols=tplan.ncols)
    scale = tplan.value_scale if vdtype == "int8" else None
    jscale = jplan.value_scale if vdtype == "int8" else None
    y = KDM.spmm_cuda_desc(*(getattr(tplan, a) for a in DESC_NAMES),
                           torch.from_numpy(X), scale, grid=2, **geom)
    y_ref = JKM.spmm_pallas_desc(*(getattr(jplan, a) for a in DESC_NAMES),
                                 jnp.asarray(X), jscale, **geom,
                                 interpret=True)
    assert y.dtype == torch.float32 and y.shape == (dense.shape[0], nvec)
    assert_close(y, y_ref)
    ref = dense.astype(np.float64) @ X.astype(np.float64)
    for j in range(nvec):
        assert np.all(np.abs(y.numpy()[:, j] - ref[:, j])
                      <= error_bound(dense, X[:, j], vdtype))


def _test_plans(multi_layout, lowering, vdtype, n=320, seed=17):
    """A test plan of a powerlaw matrix in beta(2,4), both packages."""
    kw = dict(layout="test", multi_layout=multi_layout, lowering=lowering,
              vdtype=vdtype, tune=False, pr=16, xw=32, cb=8)
    jcsr, tcsr = JM.powerlaw(n, 5, seed=seed), TM.powerlaw(n, 5, seed=seed)
    return (tcsr, jops.prepare(JF.csr_to_spc5(jcsr, 2, 4), **kw),
            tops.prepare(TF.csr_to_spc5(tcsr, 2, 4), device="cpu", **kw))


def _dense_of(csr):
    d = np.zeros(csr.shape, dtype=np.float32)
    for i in range(csr.shape[0]):
        s, e = csr.rowptr[i], csr.rowptr[i + 1]
        d[i, csr.colidx[s:e]] = csr.values[s:e]
    return d


@pytest.mark.parametrize("n", [320, 330])
def test_bf16_tail_wrappers_match_the_reference(n):
    """A bf16 test plan's bucketed tail (bf16, as the reference stores it):
    ``spmv_tail_cuda`` against ``spmv_tail_pallas`` in interpret mode, and
    ``spmm_tail_cuda`` against the reference's jnp test-plan SpMM less its
    multi part, on byte-equal buckets (nrows % pr == 0 and not)."""
    _, jplan, tplan = _test_plans("panels", "mask", "bf16", n=n)
    assert tplan.single_values.dtype == torch.bfloat16 and tplan.tail_pr
    assert tplan.single_values.view(torch.int16).numpy().tobytes() == \
        np.asarray(jplan.single_values).tobytes()
    x = np.random.default_rng(5).standard_normal(tplan.ncols).astype(
        np.float32)
    KT.reset_launches()
    y = KT.spmv_tail_cuda(tplan.tail_xbase, tplan.single_rows,
                          tplan.single_cols, tplan.single_values,
                          torch.from_numpy(x), pr=tplan.tail_pr,
                          xw=tplan.tail_xw, nrows=tplan.nrows,
                          ncols_pad=tplan.tail_ncols_pad)
    y_ref = JK.spmv_tail_pallas(
        jplan.tail_xbase, jplan.single_rows, jplan.single_cols,
        jplan.single_values, jnp.asarray(x), pr=jplan.tail_pr,
        xw=jplan.tail_xw, nrows=tplan.nrows, ncols_pad=jplan.tail_ncols_pad,
        interpret=True)
    assert y.dtype == torch.float32
    assert_close(y, y_ref)
    X = np.random.default_rng(6).standard_normal((tplan.ncols, 4)).astype(
        np.float32)
    Y = KT.spmm_tail_cuda(tplan.single_rows, tplan.single_cols,
                          tplan.single_values, torch.from_numpy(X),
                          pr=tplan.tail_pr, nrows=tplan.nrows)
    Y_ref = (np.asarray(jops.spmm(jplan, jnp.asarray(X), use_pallas=False))
             - np.asarray(jops.spmm(jplan.multi, jnp.asarray(X),
                                    use_pallas=False)))
    assert Y.dtype == torch.float32
    np.testing.assert_allclose(Y.numpy(), Y_ref, rtol=RTOL,
                               atol=1e-4 * max(float(np.abs(Y_ref).max()),
                                               1.0))
    assert KT.LAUNCHES == {"spmv_tail_cuda": 0, "spmm_tail_cuda": 0}


# ----------------------------------------------------------------------------
# the plans that reach these kernels, through ops, against the reference
# ----------------------------------------------------------------------------

@pytest.mark.parametrize("itemsize", [4, 2, 1])
def test_token_plan_rule_picks_the_descriptor_at_every_width(itemsize):
    """The cost model both packages share gives the vocab token plan's
    beta(4,8) at Avg 3.96 the descriptor lowering at 4-, 2- and 1-byte
    values, so a quantised batch-1 plan stays whole-vector + descriptor."""
    desc = TP.lowering_cost(4, 8, 3.96, itemsize, "descriptor")
    mask = TP.lowering_cost(4, 8, 3.96, itemsize, "mask")
    assert desc < mask
    assert desc == JP.lowering_cost(4, 8, 3.96, itemsize, "descriptor")
    assert mask == JP.lowering_cost(4, 8, 3.96, itemsize, "mask")


@pytest.mark.parametrize("vdtype", VDTYPES)
@pytest.mark.parametrize("rc", [(2, 4), (4, 8)])
def test_quantised_token_plan_matches_the_reference(rc, vdtype):
    """``prepare(mat, vdtype=...)`` at its defaults, as a batch-1 caller
    builds it: whole-vector + descriptor in both packages, byte-equal;
    ``ops.spmv`` (both buffers) and ``ops.spmm`` (nvec 4) against the
    reference's jnp oracle and the pins."""
    rng = np.random.default_rng(rc[0] * 10 + rc[1])
    dense = ((rng.random((300, 200)) < 0.1)
             * rng.standard_normal((300, 200))).astype(np.float32)
    tplan = tops.prepare(TF.csr_to_spc5(TF.csr_from_dense(dense), *rc),
                         vdtype=vdtype, device="cpu")
    jplan = jops.prepare(JF.csr_to_spc5(JF.csr_from_dense(dense), *rc),
                         vdtype=vdtype)
    assert (tplan.layout, tplan.lowering) == ("whole_vector", "descriptor")
    assert jplan.layout == "whole_vector"
    assert dict(jplan.meta)["lowering"] == "descriptor"
    for t, j in zip(tplan.arrays, jplan.arrays):
        t = t.view(torch.int16).numpy() if t.dtype == torch.bfloat16 \
            else t.numpy()
        assert t.tobytes() == np.asarray(j).tobytes()
    x = rng.standard_normal(200).astype(np.float32)
    ref = dense.astype(np.float64) @ x.astype(np.float64)
    y_ref = jops.spmv(jplan, jnp.asarray(x), use_pallas=False)
    for db in (True, False):
        y = tops.spmv(tplan, torch.from_numpy(x), double_buffer=db)
        assert y.dtype == torch.float32
        assert_close(y, y_ref)
        assert np.all(np.abs(y.numpy() - ref) <= error_bound(dense, x,
                                                             vdtype))
    X = rng.standard_normal((200, 4)).astype(np.float32)
    Y = tops.spmm(tplan, torch.from_numpy(X))
    assert_close(Y, jops.spmm(jplan, jnp.asarray(X), use_pallas=False))
    ref = dense.astype(np.float64) @ X.astype(np.float64)
    for j in range(4):
        assert np.all(np.abs(Y.numpy()[:, j] - ref[:, j])
                      <= error_bound(dense, X[:, j], vdtype))


@pytest.mark.parametrize("lowering", ["mask", "descriptor"])
@pytest.mark.parametrize("multi_layout", ["whole_vector", "panels"])
def test_bf16_test_plans_match_the_reference(multi_layout, lowering):
    """bf16 ``layout="test"`` plans of both multi layouts and lowerings:
    a bf16 tail (bucketed under a panel multi, flat under a whole-vector
    one), ``ops.spmv`` (both buffers) and ``ops.spmm`` (nvec 4) against the
    reference's jnp oracle and within the bf16 pin."""
    tcsr, jplan, tplan = _test_plans(multi_layout, lowering, "bf16")
    dense = _dense_of(tcsr)
    assert tplan.single_values.dtype == torch.bfloat16
    assert bool(tplan.tail_pr) == (multi_layout == "panels")
    x = np.random.default_rng(7).standard_normal(tplan.ncols).astype(
        np.float32)
    ref = dense.astype(np.float64) @ x.astype(np.float64)
    y_ref = jops.spmv(jplan, jnp.asarray(x), use_pallas=False)
    for db in (True, False):
        y = tops.spmv(tplan, torch.from_numpy(x), double_buffer=db)
        assert_close(y, y_ref)
        assert np.all(np.abs(y.numpy() - ref) <= error_bound(dense, x,
                                                             "bf16"))
    X = np.random.default_rng(8).standard_normal((tplan.ncols, 4)).astype(
        np.float32)
    Y = tops.spmm(tplan, torch.from_numpy(X))
    assert_close(Y, jops.spmm(jplan, jnp.asarray(X), use_pallas=False))
    ref = dense.astype(np.float64) @ X.astype(np.float64)
    for j in range(4):
        assert np.all(np.abs(Y.numpy()[:, j] - ref[:, j])
                      <= error_bound(dense, X[:, j], "bf16"))
