"""The mask panel SpMV kernels' host side (``spmv_cuda_panels[_db]``), on the
CPU.

* The wrappers' launch planning is pure Python: the CTA's shared memory
  (``panels_smem_bytes``), the ring's fit and shortening
  (``panels_stages``), the threads (``ROWS_PER_THREAD`` block rows each,
  ``panel_threads``) and the split S (``panels_split``, one rule shared with the descriptor
  panel kernels). It is checked here on the geometries ``chip_smoke.py``
  runs: the yi-6b vocab mask layer (125 panels x 830 chunks) and the FEM
  matrix (391 x 25).
* The wrappers take ``split`` on the CPU too (the plain version ignores
  it) and agree with the JAX package's Pallas panel kernels in interpret
  mode (``rtol=1e-5``, ``atol=1e-5 * max|y_ref|``: the f32 sums of a row
  are taken in another order).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import formats as JF
from repro.kernels import ops as jops
from repro_torch.core import formats as TF
from repro_torch.kernels import ops as tops
from repro_torch.kernels import spc5_spmv as K
from repro_torch.kernels import spc5_spmv_desc as KD

RTOL = 1e-5

#: chip_smoke.py's mask panel plans (its logged geometry): (cb, r, c, vmax,
#: xw, pr, npanels, nchunks).
SMOKE = {
    "vocab": (64, 4, 8, 312, 512, 512, 125, 830),
    "fem": (64, 4, 4, 1_024, 512, 512, 391, 25),
}


def _ctas_per_sm(smem, threads):
    """An H100 SM's CTAs by its 2,048 threads and 228 KB of shared memory
    (1 KB of it reserved per CTA); registers not counted."""
    return min(2048 // threads, (228 * 1024) // (smem + 1024))


@pytest.mark.parametrize("stages", [1, 2, 3])
@pytest.mark.parametrize("case", sorted(SMOKE))
def test_smem_formula_counts_every_part(case, stages):
    """The y tile, then per stage the value window, four metadata rows of
    cb int32 entries and a 16-byte slot (the chunk's x window start and the
    stage's mbarrier), each part 16-byte aligned."""
    cb, _, _, vmax, _, pr, _, _ = SMOKE[case]
    parts = [4 * vmax] + [4 * cb] * 4 + [16]
    stage = sum(-(-p // 16) * 16 for p in parts)
    assert K.panels_smem_bytes(stages, cb, vmax, pr) == \
        4 * pr + stages * stage
    if case == "vocab":
        # 2,048 + s * (1,248 + 4 * 256 + 16)
        assert K.panels_smem_bytes(stages, cb, vmax, pr) == \
            2_048 + stages * 2_288


@pytest.mark.parametrize("cb,vmax", [(6, 48), (7, 56), (13, 104)])
def test_smem_formula_rounds_unaligned_metadata_rows(cb, vmax):
    """cb % 4 != 0: each metadata row (4 * cb bytes) is rounded up to 16
    bytes, so every row of the stage starts 16-byte aligned."""
    row = -(-4 * cb // 16) * 16
    assert row > 4 * cb
    assert K.panels_smem_bytes(1, cb, vmax, 64) == \
        256 + 4 * vmax + 4 * row + 16


@pytest.mark.parametrize("case", sorted(SMOKE))
def test_smoke_geometries_fit_every_ring(case):
    """On both smoke plans the synchronous kernel and rings of 2 (the
    DB_STAGES chosen on the H100) and 3 fit as asked, and a CTA needs far
    less than the card's shared memory."""
    cb, _, _, vmax, _, pr, _, _ = SMOKE[case]
    for stages in (1, 2, 3):
        assert K.panels_stages(stages, cb, vmax, pr) == (
            stages, K.panels_smem_bytes(stages, cb, vmax, pr))
    assert (K.DB_STAGES, K.ROWS_PER_THREAD) == (2, 2)
    assert K.panels_smem_bytes(3, cb, vmax, pr) < 24 * 1024


def test_ring_shortens_then_refuses():
    """A 94 KB stage (a dense beta(4,8) chunk of 666 blocks): a ring of 3
    does not fit a CTA and shortens to 2, which fits; a 120 KB stage fits
    only the synchronous kernel, and a 240 KB y tile fits none."""
    geom = (666, 666 * 32, 64)
    assert K.panels_smem_bytes(3, *geom) > K.MAX_SMEM_BYTES
    assert K.panels_stages(3, *geom) == (2, K.panels_smem_bytes(2, *geom))
    assert K.panels_stages(3, *geom)[1] <= K.MAX_SMEM_BYTES
    big = (840, 840 * 32, 64)
    assert K.panels_stages(1, *big)[0] == 1
    with pytest.raises(ValueError, match="shared memory"):
        K.panels_stages(3, *big)
    with pytest.raises(ValueError, match="shared memory"):
        K.panels_stages(1, 16, 64, 60_000)


@pytest.mark.parametrize("cb,r,want", [
    (64, 4, 128),     # the vocab layer and FEM: 256 block rows, two a thread
    (64, 8, 256),
    (128, 8, 256),    # 1,024 block rows: four a thread
    (64, 1, 32),
    (6, 4, 32),       # 24 block rows, one warp
    (4, 1, 32),
    (40, 4, 96),
])
def test_threads_from_block_rows(cb, r, want):
    assert K.ROWS_PER_THREAD == 2
    assert K.panel_threads(cb, r) == want
    assert want % 32 == 0 and 32 <= want <= 256
    assert want * K.ROWS_PER_THREAD >= min(cb * r, 512)


@pytest.mark.parametrize("stages", [1, 2, 3])
@pytest.mark.parametrize("case", sorted(SMOKE))
def test_split_fills_the_card_on_smoke_geometries(case, stages):
    """With the CTAs an H100 holds at the plan's launch (128 threads and
    under 25 KB each: at least eight an SM), S gives SPLIT_WAVES waves of
    them, each CTA a range of at least one chunk."""
    cb, r, _, vmax, _, pr, npanels, nchunks = SMOKE[case]
    smem = K.panels_smem_bytes(stages, cb, vmax, pr)
    per_sm = _ctas_per_sm(smem, K.panel_threads(cb, r))
    assert per_sm >= 8
    s = K.panels_split(npanels, nchunks, per_sm, 132)
    assert 1 <= s <= nchunks
    assert npanels * s >= K.SPLIT_WAVES * per_sm * 132 or s == nchunks
    assert npanels * (s - 1) < K.SPLIT_WAVES * per_sm * 132


@pytest.mark.parametrize("case,per_sm,split,grid", [
    ("vocab", 16, 68, 8_500),    # the H100's occupancy at a ring of 2
    ("fem", 12, 17, 6_647),
    ("vocab", 8, 34, 4_250),     # 256 threads a CTA
    ("fem", 8, 11, 4_301),
])
def test_split_on_smoke_geometries(case, per_sm, split, grid):
    *_, npanels, nchunks = SMOKE[case]
    s = K.panels_split(npanels, nchunks, per_sm, 132)
    assert (s, npanels * s) == (split, grid)
    assert nchunks // s >= 1


def test_descriptor_and_mask_kernels_share_one_split_rule():
    """``KD.panels_split`` (imported by the descriptor tests) is the mask
    wrapper's function, and ``SPLIT_WAVES`` one constant."""
    assert KD.panels_split is K.panels_split
    assert KD.SPLIT_WAVES == K.SPLIT_WAVES == 4
    for args in [(125, 830, 8, 132), (391, 25, 7, 132), (1, 3, 8, 132)]:
        assert KD.panels_split(*args) == K.panels_split(*args)


# ----------------------------------------------------------------------------
# the wrappers on the CPU against the JAX package
# ----------------------------------------------------------------------------

def _inputs(rc, seed=0):
    """302x700 random matrix (nrows % r != 0 for r = 8) and x."""
    rng = np.random.default_rng(seed + 10 * rc[0] + rc[1])
    d = ((rng.random((302, 700)) < 0.05)
         * rng.standard_normal((302, 700))).astype(np.float32)
    return d, rng.standard_normal(700).astype(np.float32)


@pytest.mark.parametrize("split", [None, 1, 3])
@pytest.mark.parametrize("kernel", ["spmv_cuda_panels", "spmv_cuda_panels_db"])
@pytest.mark.parametrize("rc", [(2, 4), (4, 8), (8, 4)])
def test_wrapper_with_split_matches_pallas(rc, kernel, split):
    """On the CPU the wrapper takes ``split`` and runs its plain version,
    launching nothing; y agrees with the reference's Pallas panel kernel of
    the same buffering in interpret mode, on the same layout (cb = 6: the
    kernels' 4-byte metadata staging)."""
    d, x = _inputs(rc)
    geom = dict(pr=64, xw=64, cb=6)
    db = kernel.endswith("_db")
    jplan = jops.prepare(JF.csr_to_spc5(JF.csr_from_dense(d), *rc),
                         layout="panels", lowering="mask", tune=False, **geom)
    y_ref = jops.spmv(jplan, jnp.asarray(x), use_pallas=True, interpret=True,
                      double_buffer=db)
    plan = tops.prepare(TF.csr_to_spc5(TF.csr_from_dense(d), *rc),
                        layout="panels", lowering="mask", tune=False,
                        device="cpu", **geom)
    before = dict(K.LAUNCHES)
    y = getattr(K, kernel)(
        plan.chunk_vbase, plan.chunk_xbase, plan.chunk_col, plan.chunk_mask,
        plan.chunk_voff, plan.chunk_row, plan.values, torch.from_numpy(x),
        r=plan.r, c=plan.c, cb=plan.cb, vmax=plan.vmax, xw=plan.xw,
        pr=plan.pr, nrows=plan.nrows, ncols_pad=plan.ncols_pad, split=split)
    assert K.LAUNCHES == before
    y_ref = np.asarray(y_ref)
    np.testing.assert_allclose(y.numpy(), y_ref, rtol=RTOL,
                               atol=RTOL * float(np.abs(y_ref).max()))
