"""The panel descriptor SpMV kernels' host side, and two plan repairs,
against the JAX package.

* The tables both packages' ``chunk_descriptors`` build for the panel layout
  repeat each block's columns over its rows (``xcol[k] == xcol[k % c]``)
  and its rows over its columns (``yrow[k] == yrow[0] + k // c``); the
  panel kernels read only the c xcol entries of each block's first row and
  its lane-0 yrow entry, so both identities are pinned here.
* The wrappers' launch planning (``panels_smem_bytes``, ``panels_stages``,
  ``panels_split``) is pure Python and is checked on the geometries
  ``chip_smoke.py`` runs; so is the tables' 4-byte alignment check.
* ``make_plan`` refuses a ``vdtype`` together with ``dtype=`` as the
  reference does, and ``SPC5Plan.shape`` / ``.apply`` give the reference's
  answers (``rtol=1e-5``, ``atol=1e-5 * max|y_ref|``: the f32 sums of a row
  are taken in another order).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import formats as JF
from repro.kernels import ops as jops
from repro_torch.core import formats as TF
from repro_torch.core import plan as TP
from repro_torch.kernels import ops as tops
from repro_torch.kernels import spc5_spmv as K
from repro_torch.kernels import spc5_spmv_desc as KD

RTOL = 1e-5


def _random(shape, density, seed):
    rng = np.random.default_rng(seed)
    return ((rng.random(shape) < density)
            * rng.standard_normal(shape)).astype(np.float32)


def assert_close(y, y_ref):
    y_ref = np.asarray(y_ref)
    np.testing.assert_allclose(np.asarray(y), y_ref, rtol=RTOL,
                               atol=RTOL * max(float(np.abs(y_ref).max()),
                                               1e-30))


# ----------------------------------------------------------------------------
# the tables' repetition identities
# ----------------------------------------------------------------------------

@pytest.mark.parametrize("col_map", [False, True])
@pytest.mark.parametrize("package", ["jax", "torch"])
@pytest.mark.parametrize("rc", TF.SUPPORTED_BLOCKS)
def test_panel_tables_repeat_columns_and_rows(rc, package, col_map):
    """Every lane of every block (padding included) on panel tables of 302
    rows (nrows % pr != 0), with and without a folded column map: xcol
    depends only on k % c, yrow is the lane-0 entry plus k // c, and no
    block row reaches past its panel (chunk_row <= pr - r)."""
    r, c = rc
    F = JF if package == "jax" else TF
    mat = F.csr_to_spc5(F.csr_from_dense(_random((302, 260), 0.08, 3 * r + c)),
                        r, c)
    pl = F.to_panels(mat, pr=64, cb=16, xw=64)
    assert pl.nrows % pl.pr and int(pl.chunk_row.max()) <= pl.pr - r
    cmap = (np.random.default_rng(2).permutation(pl.xw) if col_map
            else None)
    d = F.chunk_descriptors(pl.chunk_mask, pl.chunk_voff, pl.chunk_col,
                            pl.chunk_row, r=r, c=c, vmax=pl.vmax,
                            xmax=pl.xw, ymax=pl.pr, col_map=cmap)
    k = np.arange(r * c)
    xcol = d.xcol.astype(np.int64)
    yrow = d.yrow.astype(np.int64)
    assert np.array_equal(xcol, xcol[..., k % c])
    assert np.array_equal(yrow, yrow[..., :1] + k // c)
    assert d.valid.any()


def test_port_plan_tables_repeat_columns_and_rows():
    """The same identities on the tables a port plan hands the kernels (the
    vocab layer's shape, beta(4,8), at a small size)."""
    w = _random((1_100, 700), 0.1, 4)
    plan = tops.prepare(TF.csr_to_spc5(TF.csr_from_dense(w), 4, 8),
                        layout="panels", lowering="descriptor", tune=False,
                        device="cpu", pr=512, xw=512, cb=64)
    k = torch.arange(32)
    xcol = plan.desc_xcol.long()
    yrow = plan.desc_yrow.long()
    assert torch.equal(xcol, xcol[..., k % 8])
    assert torch.equal(yrow, yrow[..., :1] + k // 8)


# ----------------------------------------------------------------------------
# the wrappers' launch planning
# ----------------------------------------------------------------------------

#: chip_smoke.py's panel descriptor plans (its logged geometry): the
#: default vocab layer, the test layer's multi sub-plan and the FEM matrix.
#: (cb, r, c, vmax, xw, pr, vidx bytes, xcol bytes, npanels, nchunks)
SMOKE = {
    "vocab": (64, 4, 8, 312, 512, 512, 2, 2, 125, 830),
    "test_multi": (64, 2, 4, 176, 512, 512, 2, 2, 125, 992),
    "fem": (64, 4, 4, 1024, 512, 512, 2, 2, 391, 25),
}


def _ctas_per_sm(smem, threads):
    """An H100 SM's CTAs by its 2,048 threads and 228 KB of shared memory
    (1 KB of it reserved per CTA); registers not counted."""
    return min(2048 // threads, (228 * 1024) // (smem + 1024))


@pytest.mark.parametrize("stages", [1, 2, 3])
@pytest.mark.parametrize("case", sorted(SMOKE))
def test_smem_formula_counts_every_part(case, stages):
    cb, r, c, vmax, xw, pr, wv, wx, _, _ = SMOKE[case]
    rc = r * c
    parts = [4 * vmax, 4 * xw, cb * rc, cb * rc * wv, cb * c * wx, 4 * cb]
    stage = sum(-(-p // 16) * 16 for p in parts)
    assert KD.panels_smem_bytes(stages, cb, r, c, vmax, xw, pr, wv, wx) == \
        4 * pr + stages * stage
    if case == "vocab":
        # 2,048 + s * (1,248 + 2,048 + 2,048 + 4,096 + 1,024 + 256)
        assert KD.panels_smem_bytes(stages, cb, r, c, vmax, xw, pr, wv,
                                    wx) == 2_048 + stages * 10_720


@pytest.mark.parametrize("case", sorted(SMOKE))
def test_smoke_geometries_fit_whole_chunks(case):
    """On every smoke plan the synchronous kernel stages whole chunks and
    the ring keeps DB_STAGES of them."""
    cb, r, c, vmax, xw, pr, wv, wx, _, _ = SMOKE[case]
    geom = (cb, r, c, vmax, xw, pr, wv, wx)
    assert KD.panels_stages(1, *geom) == (
        1, cb, KD.panels_smem_bytes(1, *geom))
    assert KD.panels_stages(KD.DB_STAGES, *geom) == (
        KD.DB_STAGES, cb, KD.panels_smem_bytes(KD.DB_STAGES, *geom))
    assert KD.DB_STAGES == 3


@pytest.mark.parametrize("stages", [1, 2, 3])
@pytest.mark.parametrize("case", sorted(SMOKE))
def test_split_fills_the_card_on_smoke_geometries(case, stages):
    """With the CTAs an H100 holds at the plan's shared memory (four or
    more an SM), S gives SPLIT_WAVES waves of them, each CTA a range of at
    least a few chunks, where the plan has the chunks for it."""
    cb, r, c, vmax, xw, pr, wv, wx, npanels, nchunks = SMOKE[case]
    smem = KD.panels_smem_bytes(stages, cb, r, c, vmax, xw, pr, wv, wx)
    per_sm = _ctas_per_sm(smem, K._threads(cb * r * c // 4))
    assert per_sm >= 4
    s = KD.panels_split(npanels, nchunks, per_sm, 132)
    slots = per_sm * 132
    assert 1 <= s <= nchunks
    assert npanels * s >= KD.SPLIT_WAVES * slots or s == nchunks
    assert npanels * (s - 1) < KD.SPLIT_WAVES * slots
    assert nchunks // s >= 2


@pytest.mark.parametrize("npanels,nchunks,per_sm,want", [
    (125, 830, 6, 26),       # the vocab layer at DB_STAGES = 3: 3,250 CTAs
    (125, 992, 12, 51),      # the test layer's multi, 128 threads a CTA
    (391, 25, 7, 10),        # FEM
    (1, 3, 8, 3),            # one panel: every chunk its own CTA
    (10_000, 40, 8, 1),      # four waves of panels already: S = 1
    (1, 1, 8, 1),
])
def test_split_choices(npanels, nchunks, per_sm, want):
    assert KD.panels_split(npanels, nchunks, per_sm, 132) == want


def test_ring_shortens_and_chunks_slice_to_fit():
    """A 160 KB value window (1,280 full beta(4,8) blocks, int32 vidx):
    no ring of two fits, so the double-buffered kernel refuses; the
    synchronous kernel stages its tables in slices of fewer blocks. A ring
    of DB_STAGES that does not fit shortens to 2."""
    geom = dict(cb=1_280, r=4, c=8, vmax=40_960, xw=1_024, pr=64, wv=4,
                wx=2)
    args = tuple(geom.values())
    with pytest.raises(ValueError, match="shared memory"):
        KD.panels_stages(2, *args)
    stages, nb, smem = KD.panels_stages(1, *args)
    assert stages == 1 and nb < 1_280 and smem <= K.MAX_SMEM_BYTES
    assert KD.panels_smem_bytes(1, 2 * nb, *args[1:]) > K.MAX_SMEM_BYTES
    mid = (64, 4, 8, 20_000, 512, 512, 2, 2)   # an 80 KB value window
    assert KD.panels_smem_bytes(KD.DB_STAGES, *mid) > K.MAX_SMEM_BYTES
    stages, nb, smem = KD.panels_stages(KD.DB_STAGES, *mid)
    assert (stages, nb) == (2, 64) and smem <= K.MAX_SMEM_BYTES
    with pytest.raises(ValueError, match="shared memory"):
        KD.panels_stages(1, 16, 2, 4, 64, 64, 60_000, 1, 1)


@pytest.mark.parametrize("rc", TF.SUPPORTED_BLOCKS)
def test_db_ring_shortens_to_two(rc):
    """For every block shape, a chunk whose tables and value window fill a
    third of a CTA's shared memory or more gets a ring of 2 (the kernel's
    other instantiation) and whole chunks; a smaller one the full ring."""
    r, c = rc
    cb = 10_240 // (r * c)                 # 10,240 lanes, int16 vidx
    geom = (cb, r, c, cb * r * c, 1_024, 64, 2, 2)
    assert KD.panels_smem_bytes(KD.DB_STAGES, *geom) > K.MAX_SMEM_BYTES
    assert KD.panels_stages(KD.DB_STAGES, *geom) == (
        2, cb, KD.panels_smem_bytes(2, *geom))
    small = (cb // 4, *geom[1:3], cb * r * c // 4, *geom[4:])
    assert KD.panels_stages(KD.DB_STAGES, *small)[:2] == (KD.DB_STAGES,
                                                          cb // 4)


@pytest.mark.parametrize("offset", [0, 4, 8, 12])
def test_tables_need_only_4_byte_alignment(offset):
    """The panel kernels copy a table in 16-byte pieces where it is so
    aligned and in 4-byte ones otherwise, so a table view at any 4-byte
    offset passes the tables' check; the windows keep their 16-byte one."""
    base = torch.zeros(64, dtype=torch.int8)
    t = base[offset:offset + 32]
    assert t.data_ptr() % 16 == (base.data_ptr() + offset) % 16
    K._aligned({"desc_valid": t}, 4)
    with pytest.raises(ValueError, match="4-byte boundary"):
        K._aligned({"desc_valid": base[offset + 1:]}, 4)
    if t.data_ptr() % 16:
        with pytest.raises(ValueError, match="16-byte boundary"):
            K._aligned({"values": t})


# ----------------------------------------------------------------------------
# plan repairs: vdtype with dtype=, SPC5Plan.shape and .apply
# ----------------------------------------------------------------------------

def _mats(rc=(2, 4), shape=(300, 280), seed=6):
    d = _random(shape, 0.06, seed)
    return (JF.csr_to_spc5(JF.csr_from_dense(d), *rc),
            TF.csr_to_spc5(TF.csr_from_dense(d), *rc), d)


@pytest.mark.parametrize("vdtype", ["f32", "bf16", "int8"])
def test_vdtype_with_dtype_is_a_value_error_like_reference(vdtype):
    """Both packages refuse the pair with the same ValueError, for the
    ported f32 and for the not-yet-ported bf16 / int8 alike (the conflict
    is checked before anything is built or refused as not ported)."""
    jmat, tmat, _ = _mats()
    with pytest.raises(ValueError, match="not both") as jerr:
        jops.prepare(jmat, vdtype=vdtype, dtype=np.float32, tune=False)
    with pytest.raises(ValueError, match="not both") as terr:
        tops.prepare(tmat, vdtype=vdtype, dtype=np.float32, tune=False,
                     device="cpu")
    assert str(terr.value) == str(jerr.value)
    with pytest.raises(ValueError, match="not both"):
        TP.make_plan(tmat, device="cpu", vdtype=vdtype, dtype=np.float32)


PLANS = {
    "whole_vector": dict(layout="whole_vector", cb=16),
    "panels": dict(layout="panels", pr=64, xw=64, cb=16),
    "test_panels": dict(layout="test", multi_layout="panels", pr=64, xw=64,
                        cb=16),
    "test_whole": dict(layout="test", multi_layout="whole_vector", cb=16),
}


@pytest.mark.parametrize("nvec", [1, 8])
@pytest.mark.parametrize("lowering", ["mask", "descriptor"])
@pytest.mark.parametrize("case", sorted(PLANS))
def test_plan_shape_and_apply_match_reference(case, lowering, nvec):
    """``plan.shape`` is (nrows, ncols) and ``plan.apply`` runs SpMV for a
    1-D x and SpMM for a 2-D X on whole-vector, panel and test plans, as
    the reference's; the layer's shape reads the plan's."""
    jmat, tmat, d = _mats(shape=(302, 270))
    kw = dict(PLANS[case], lowering=lowering, tune=False)
    jplan = jops.prepare(jmat, **kw)
    tplan = tops.prepare(tmat, device="cpu", **kw)
    assert tplan.shape == tuple(jplan.shape) == (302, 270)
    rng = np.random.default_rng(nvec)
    x = (rng.standard_normal(270) if nvec == 1
         else rng.standard_normal((270, nvec))).astype(np.float32)
    y = tplan.apply(torch.from_numpy(x))
    y_ref = np.asarray(jplan.apply(jnp.asarray(x)))
    assert y.shape == y_ref.shape == ((302,) if nvec == 1 else (302, nvec))
    assert_close(y, y_ref)
    assert_close(y, d.astype(np.float64) @ x.astype(np.float64))


def test_sparse_linear_shape_reads_the_plan():
    from repro_torch.core.sparse_linear import SparseLinear
    w = _random((40, 24), 0.3, 7)
    layer = SparseLinear.from_dense(w, density=0.3, block=(2, 4),
                                    device="cpu")
    assert layer.shape == layer.plan.shape == (40, 24)
