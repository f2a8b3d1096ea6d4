"""The panel descriptor SpMM pair's host side, against the JAX package.

* Both packages' panel plans sort a panel's blocks by column, then by
  block row, and the tables ``chunk_descriptors`` builds for them repeat a
  block's columns over its rows (``xcol[k] == xcol[k % c]``) and its rows
  over its columns (``yrow[k] == yrow[0] + k // c``, ``yrow[0]`` a multiple
  of r): the kernels stage the c xcol entries of each block's first row and
  its lane-0 yrow word, and hand each block row to one warp by
  ``yrow[0] / r``.
* The wrappers' launch planning (``panels_vector``, ``panels_tiles``,
  ``panels_smem_bytes``, ``panels_plan`` with its row parts,
  ``panels_launch`` with the card's occupancy faked) is pure Python and is
  checked on the geometries ``chip_smoke.py`` runs and on edge cases.
* The wrappers on the CPU (the plain version) against the reference's
  ``spmm_pallas_panels_desc`` / ``_db`` in interpret mode, also on tables
  whose block rows are permuted or repeated within a chunk, which the
  kernels must take in any order (``rtol=1e-5``, ``atol=1e-5 *
  max|Y_ref|``: the f32 sums of a row are taken in another order).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import formats as JF
from repro.kernels import spc5_spmm as JK
from repro_torch.core import formats as TF
from repro_torch.kernels import ops as tops
from repro_torch.kernels import spc5_spmm_desc as KDM
from repro_torch.kernels import spc5_spmv as K
from repro_torch.kernels import spc5_spmv_desc as KD

RTOL = 1e-5
PAIR = {"spmm_cuda_panels_desc": "spmm_pallas_panels_desc",
        "spmm_cuda_panels_desc_db": "spmm_pallas_panels_desc_db"}


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
# the panel sort and the tables' identities
# ----------------------------------------------------------------------------

@pytest.mark.parametrize("package", ["jax", "torch"])
@pytest.mark.parametrize("rc", TF.SUPPORTED_BLOCKS)
def test_panel_blocks_sorted_by_column_then_block_row(rc, package):
    """The default geometry (pr 512, cb 64, xw 512) at density 0.1, 1,030
    rows (nrows % pr != 0): in chunk order, a panel's blocks come by
    global column, then by block row, no (column, row) twice; chunks of 64
    blocks span several columns and so repeat block rows; valid lanes
    carry the identities the stage relies on, and every block row is a
    multiple of r below pr."""
    r, c = rc
    F = JF if package == "jax" else TF
    mat = F.csr_to_spc5(F.csr_from_dense(_random((1_030, 700), 0.1,
                                                 7 * r + c)), r, c)
    pl = F.to_panels(mat, pr=512, cb=64, xw=512)
    d = F.chunk_descriptors(pl.chunk_mask, pl.chunk_voff, pl.chunk_col,
                            pl.chunk_row, r=r, c=c, vmax=pl.vmax,
                            xmax=pl.xw, ymax=pl.pr)
    repeats = 0
    for p in range(pl.chunk_mask.shape[0]):
        real = pl.chunk_mask[p] != 0
        cols = (pl.chunk_xbase[p][:, None] + pl.chunk_col[p])[real]
        rows = pl.chunk_row[p][real]
        keys = cols.astype(np.int64) * pl.pr + rows
        assert np.all(np.diff(keys) > 0)
        for ch in range(pl.chunk_mask.shape[1]):
            brows = pl.chunk_row[p, ch][pl.chunk_mask[p, ch] != 0]
            repeats += brows.size - np.unique(brows).size
    assert repeats > 0
    k = np.arange(r * c)
    xcol = d.xcol.astype(np.int64)
    yrow = d.yrow.astype(np.int64)
    valid = d.valid != 0
    assert np.array_equal(xcol, xcol[..., k % c])
    assert np.array_equal(np.where(valid, yrow, 0),
                          np.where(valid, yrow[..., :1] + k // c, 0))
    real = pl.chunk_mask != 0
    assert np.array_equal(yrow[..., 0][real], pl.chunk_row[real])
    assert np.array_equal(xcol[..., 0][real], pl.chunk_col[real])
    assert np.all(yrow[..., 0] % r == 0) and int(yrow.max()) < pl.pr


# ----------------------------------------------------------------------------
# the launch plan
# ----------------------------------------------------------------------------

#: chip_smoke.py's panel descriptor plans (its logged geometry): the
#: default vocab layer and the test layer's multi sub-plan.
#: (cb, r, c, vmax, pr, vidx bytes, xcol bytes, npanels, nchunks)
SMOKE = {
    "vocab": (64, 4, 8, 312, 512, 2, 2, 125, 830),
    "test_multi": (64, 2, 4, 176, 512, 2, 2, 125, 992),
}


def _ctas_per_sm(smem, threads):
    """An H100 SM's CTAs by its 65,536 registers (64 a thread at most, as
    the panel kernels are built) and 228 KB of shared memory (1 KB of it
    reserved per CTA)."""
    return min(65_536 // (64 * threads), (228 * 1024) // (smem + 1024))


@pytest.fixture
def fake_card(monkeypatch):
    """``panels_occupancy`` as an H100 of 132 SMs would answer it."""
    monkeypatch.setattr(KDM, "panels_occupancy",
                        lambda stages, r, c, vec, threads, smem, device,
                        vsize=4: (_ctas_per_sm(smem, threads), 132))


def _launch(case, stages, nvec, **kw):
    cb, r, c, vmax, pr, wv, wx, npanels, nchunks = SMOKE[case]
    return KDM.panels_launch(stages, npanels, nchunks, cb=cb, r=r, c=c,
                             vmax=vmax, pr=pr, nvec=nvec,
                             vec=KDM.panels_vector(nvec), wv=wv, wx=wx,
                             device=torch.device("cpu"), **kw)


@pytest.mark.parametrize("stages", [1, KDM.PANEL_DB_STAGES])
@pytest.mark.parametrize("case", sorted(SMOKE))
def test_smem_formula_counts_every_part(case, stages):
    """The Y tile of a row part, then per stage the value windows and x
    window starts of its q chunks, the valid and vidx runs, c xcol entries
    and a yrow word a block and an mbarrier slot, then the walk's order and
    sort keys (20 bytes a block), each part rounded up to 16 bytes."""
    cb, r, c, vmax, pr, wv, wx, _, _ = SMOKE[case]
    rc = r * c
    for q, nb in ((1, cb), (1, 7), (2, 2 * cb), (3, 3 * cb)):
        for prows, tw in ((pr, 1), (pr, 16), (pr // 2, 128), (8, 4)):
            parts = [4 * vmax] * q + [4 * q, nb * rc, nb * rc * wv,
                                      nb * c * wx, 4 * nb]
            stage = sum(-(-p // 16) * 16 for p in parts) + 16
            assert KDM.panels_smem_bytes(stages, q, nb, r, c, vmax, prows, tw,
                                         wv, wx) == (
                4 * prows * tw + stages * stage + 16 * nb
                + -(-4 * nb // 16) * 16)
    if case == "vocab":
        # (128, 128) tile + s * (2 * 1,248 + 16 + 4,096 + 8,192 + 2,048
        # + 512 + 16) + 128 * (16 + 4)
        assert KDM.panels_smem_bytes(
            stages, 2, 2 * cb, r, c, vmax, 128, 128, wv, wx
        ) == 65_536 + stages * 17_376 + 2_560


#: The vocab layer's ring at nvec 16 and 128: (tile, columns a lane, row
#: parts, chunks a stage, CTAs an SM, S).
VOCAB_DB = {16: (16, 4, 1, 1, 4, 17), 128: (128, 4, 4, 2, 2, 3)}


@pytest.mark.parametrize("nvec", sorted(VOCAB_DB))
@pytest.mark.parametrize("stages", [1, KDM.PANEL_DB_STAGES])
@pytest.mark.parametrize("case", sorted(SMOKE))
def test_smoke_launches(fake_card, case, stages, nvec):
    """Whole chunks in every stage and the ring; four columns a lane: one
    16-column tile of four lanes (256 threads) at nvec 16, and at nvec 128
    one 128-column tile of 32 lanes (512 threads), whose (512, 128) Y tile
    does not fit, so each panel is cut into row parts until two CTAs fit an
    SM (four parts of 128 rows); two chunks a stage where an SM then holds
    as many CTAs as with one; S from the panel SpMV pairs' rule over
    npanels x parts x ntiles units (on the vocab layer's ring one chunk a
    stage, four CTAs an SM and S = 17 at nvec 16; two, two and S = 3 at
    128), so every chunk range of a panel is a few chunks long or more and
    the ranges cover each chunk once."""
    cb, r, c, vmax, pr, wv, wx, npanels, nchunks = SMOKE[case]
    tw, vec, parts = VOCAB_DB[nvec][:3]
    launch = _launch(case, stages, nvec)
    q = launch["chunks_per_stage"]
    assert launch["stages"] == stages and launch["blocks_per_stage"] == q * cb
    assert (launch["tile_columns"], launch["vector"]) == (tw, vec)
    assert launch["lanes"] == tw // vec
    assert (launch["row_parts"], launch["part_rows"]) == (parts, pr // parts)
    assert launch["ntiles"] == -(-nvec // tw) == 1
    threads = 512 if tw // vec == 32 else 256

    def smem(q, prows=pr // parts):
        return KDM.panels_smem_bytes(stages, q, q * cb, r, c, vmax, prows, tw,
                                     wv, wx)
    assert launch["smem_bytes"] == smem(q) <= KDM.TWO_CTA_SMEM_BYTES
    assert parts == 1 or smem(1, pr // parts * 2) > KDM.TWO_CTA_SMEM_BYTES
    assert (q == 2) == (_ctas_per_sm(smem(2), threads)
                        >= _ctas_per_sm(smem(1), threads))
    per_sm = _ctas_per_sm(smem(q), threads)
    split = K.panels_split(npanels * parts, nchunks, per_sm, 132)
    assert (launch["ctas_per_sm"], launch["split"]) == (per_sm, split)
    if case == "vocab" and stages == KDM.PANEL_DB_STAGES:
        assert (parts, q, per_sm, split) == VOCAB_DB[nvec][2:]
    assert launch["grid"] == npanels * parts * split
    assert launch["threads"] == threads == (512 if nvec == 128 else 256)
    assert per_sm >= 2
    ranges = KD.chunk_ranges(nchunks, split)
    covered = np.concatenate([np.arange(f, f + n) for f, n in ranges])
    assert np.array_equal(covered, np.arange(nchunks))
    assert min(n for _, n in ranges) >= 2
    assert launch["chunks_per_cta"] == max(n for _, n in ranges)


@pytest.mark.parametrize("split", [1, 2, 829, 830])
def test_split_can_be_forced(fake_card, split):
    launch = _launch("vocab", KDM.PANEL_DB_STAGES, 128, split=split)
    assert launch["split"] == split
    assert launch["grid"] == 125 * launch["row_parts"] * split


@pytest.mark.parametrize("split", [0, 831])
def test_split_out_of_range_raises(fake_card, split):
    with pytest.raises(ValueError, match="split must be in"):
        _launch("vocab", 1, 16, split=split)


@pytest.mark.parametrize("nvec,offset,vec", [
    (1, 0, 1), (3, 0, 1), (4, 0, 4), (6, 0, 2), (6, 8, 2), (8, 4, 1),
    (8, 8, 2), (16, 0, 4), (40, 0, 4), (128, 0, 4), (256, 0, 4)])
def test_lane_width(nvec, offset, vec):
    """At most four columns a lane where 4 divides nvec and X is 16-byte
    aligned, two where 2 does and X is 8-byte aligned, else one."""
    buf = torch.zeros(nvec * 8 + 4)
    x = buf[offset // 4:][:nvec * 8].view(8, nvec)
    assert x.data_ptr() % 16 == offset
    assert KDM.panels_vector(nvec, x) == vec


@pytest.mark.parametrize("tile", [128, 64, 32])
@pytest.mark.parametrize("nvec,vec", [(1, 1), (3, 1), (16, 4), (40, 4),
                                      (128, 4), (128, 1), (256, 2)])
def test_tiles(monkeypatch, nvec, vec, tile):
    """Tiles are powers of two covering nvec, at most PANEL_TILE and 32
    lanes of ``vec`` columns, halved down to one column."""
    monkeypatch.setattr(KDM, "PANEL_TILE", tile)
    top = min(tile, 32 * vec, 1 << max(0, nvec - 1).bit_length())
    assert KDM.panels_tiles(nvec, vec) == [t for t in (128, 64, 32, 16, 8, 4,
                                                        2, 1) if t <= top]


def test_row_parts_slices_and_refusals(monkeypatch):
    """A tall panel (pr 4,096) cannot hold a (4,096, 128) Y tile: the plan
    keeps the 128-column tile and takes the fewest row parts (a multiple of
    r rows each) at which two CTAs fit an SM; where two never fit (a 160 KB
    value window), the synchronous kernel slices a large chunk's tables to
    fit one; a value window that fits no CTA, or a ring of them, raises
    before any launch; at least PANEL_ROW_PARTS parts are taken."""
    cta = KDM.panels_plan(2, 64, 4, 8, 312, 4_096, 128, 4, 2, 2)
    assert (cta["tile_columns"], cta["vector"], cta["lanes"]) == (128, 4, 32)
    parts, prows = cta["row_parts"], cta["part_rows"]
    assert prows % 4 == 0 and parts * prows >= 4_096 > (parts - 1) * prows
    q = cta["chunks_per_stage"]
    assert cta["smem_bytes"] == KDM.panels_smem_bytes(
        2, q, q * 64, 4, 8, 312, prows, 128, 2, 2) <= KDM.TWO_CTA_SMEM_BYTES
    half = -(-4_096 // (parts // 2 * 4)) * 4
    assert KDM.panels_smem_bytes(2, 1, 64, 4, 8, 312, half, 128, 2, 2) > \
        KDM.TWO_CTA_SMEM_BYTES
    cta = KDM.panels_plan(1, 1_280, 4, 8, 40_960, 64, 16, 4, 4, 2)
    assert cta["blocks_per_stage"] < 1_280 and cta["row_parts"] == 1
    assert cta["chunks_per_stage"] == 1
    assert cta["smem_bytes"] <= K.MAX_SMEM_BYTES < KDM.panels_smem_bytes(
        1, 1, 2 * cta["blocks_per_stage"], 4, 8, 40_960, 64, 16, 4, 2)
    with pytest.raises(ValueError, match="shared memory"):
        KDM.panels_plan(2, 1_280, 4, 8, 40_960, 64, 16, 4, 4, 2)
    with pytest.raises(ValueError, match="shared memory"):
        KDM.panels_plan(1, 16, 2, 4, 60_000, 64, 4, 4, 2, 1)
    with pytest.raises(ValueError, match="stage 1 or"):
        KDM.panels_plan(3, 64, 4, 8, 312, 512, 16, 4, 2, 2)
    monkeypatch.setattr(KDM, "PANEL_ROW_PARTS", 8)
    cta = KDM.panels_plan(2, 64, 4, 8, 312, 512, 16, 4, 2, 2)
    assert (cta["row_parts"], cta["part_rows"]) == (8, 64)
    monkeypatch.setattr(KDM, "PANEL_TILE", 16)
    assert KDM.panels_plan(2, 64, 4, 8, 312, 512, 128, 4, 2, 2)[
        "tile_columns"] == 16


# ----------------------------------------------------------------------------
# the wrappers on the CPU against the reference's Pallas kernels
# ----------------------------------------------------------------------------

def _plans(rc, seed, shape=(130, 150), density=0.12):
    """Byte-equal panel descriptor plans of both packages (pr=32, xw=32,
    cb=4: several panels, many chunks a panel, nrows % pr != 0)."""
    d = _random(shape, density, seed)
    kw = dict(layout="panels", lowering="descriptor", tune=False, pr=32,
              xw=32, cb=4)
    from repro.kernels import ops as jops
    jplan = jops.prepare(JF.csr_to_spc5(JF.csr_from_dense(d), *rc), **kw)
    tplan = tops.prepare(TF.csr_to_spc5(TF.csr_from_dense(d), *rc),
                         device="cpu", **kw)
    for t, j in zip(tplan.arrays, jplan.arrays):
        assert t.numpy().tobytes() == np.asarray(j).tobytes()
    return tplan, d


def _tables(plan, order):
    """The plan's four descriptor tables with each chunk's blocks in
    ``order``: as planned ("plan"), shuffled ("permuted"), or each chunk
    holding its first two blocks in turn, so every block row repeats
    ("repeated", which changes the product)."""
    tabs = [t.numpy() for t in (plan.desc_valid, plan.desc_vidx,
                                plan.desc_xcol, plan.desc_yrow)]
    if order == "plan":
        return tabs
    pick = (np.random.default_rng(3).permutation(plan.cb)
            if order == "permuted" else np.arange(plan.cb) % 2)
    return [np.ascontiguousarray(t[:, :, pick]) for t in tabs]


def _both(kernel, plan, tabs, x, nvt=128):
    kw = dict(r=plan.r, c=plan.c, cb=plan.cb, vmax=plan.vmax, xw=plan.xw,
              pr=plan.pr, nrows=plan.nrows, ncols_pad=plan.ncols_pad,
              nvt=nvt)
    head = (plan.chunk_vbase, plan.chunk_xbase)
    y = getattr(KDM, kernel)(*head, *(torch.from_numpy(t) for t in tabs),
                             plan.values, torch.from_numpy(x), split=3, **kw)
    y_pal = getattr(JK, PAIR[kernel])(
        *(jnp.asarray(a.numpy()) for a in head),
        *(jnp.asarray(t) for t in tabs), jnp.asarray(plan.values.numpy()),
        jnp.asarray(x), interpret=True, **kw)
    return y, y_pal


@pytest.mark.parametrize("order", ["plan", "permuted", "repeated"])
@pytest.mark.parametrize("kernel", sorted(PAIR))
@pytest.mark.parametrize("rc", TF.SUPPORTED_BLOCKS)
def test_pair_on_the_cpu_matches_pallas(rc, kernel, order):
    """The wrapper on the CPU (the plain version; ``split`` is the card's
    knob and changes nothing here) against the reference's Pallas kernel
    in interpret mode on the same tables, at nvec 4 in the plan's block
    order, with each chunk's blocks shuffled, and with each chunk's first
    two blocks repeated over it; the first two also against the f64
    product."""
    plan, d = _plans(rc, 10 * rc[0] + rc[1])
    x = np.random.default_rng(rc[1]).standard_normal(
        (d.shape[1], 4)).astype(np.float32)
    tabs = _tables(plan, order)
    y, y_pal = _both(kernel, plan, tabs, x)
    assert y.shape == (d.shape[0], 4)
    assert_close(y, y_pal)
    if order != "repeated":
        assert_close(y, d.astype(np.float64) @ x.astype(np.float64))


@pytest.mark.parametrize("nvec,nvt", [(1, 128), (3, 128), (8, 4)])
@pytest.mark.parametrize("kernel", sorted(PAIR))
def test_pair_on_the_cpu_at_other_widths(kernel, nvec, nvt):
    """nvec 1 and 3 (the kernels' one-column lanes) and 8 in reference
    tiles of 4, against the Pallas kernel on repeated block rows."""
    plan, d = _plans((2, 4), 5)
    x = np.random.default_rng(nvec).standard_normal(
        (d.shape[1], nvec)).astype(np.float32)
    y, y_pal = _both(kernel, plan, _tables(plan, "repeated"), x, nvt=nvt)
    assert_close(y, y_pal)
