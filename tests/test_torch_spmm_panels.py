"""The mask panel SpMM pair's host side, against the JAX package.

* The wrappers' launch planning (``panels_vector``, ``panels_tiles``,
  ``panels_smem_bytes``, ``panels_plan`` with its row parts and chunks a
  stage, ``panels_launch`` with the card's occupancy faked) is pure Python
  and is checked on the vocab mask layer ``chip_smoke.py`` runs, on other
  block shapes and on edge cases.
* The wrappers on the CPU (the plain version; ``split`` is the card's knob
  and changes nothing there) against the reference's ``spmm_pallas_panels``
  / ``_db`` in interpret mode, also on chunks whose blocks are permuted or
  repeated, which the kernels must take in any order (``rtol=1e-5``,
  ``atol=1e-5 * max|Y_ref|``: the f32 sums of a row are taken in another
  order).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import formats as JF
from repro.kernels import spc5_spmm as JK
from repro_torch.core import formats as TF
from repro_torch.kernels import ops as tops
from repro_torch.kernels import spc5_spmm as KM
from repro_torch.kernels import spc5_spmv as K
from repro_torch.kernels import spc5_spmv_desc as KD

RTOL = 1e-5
PAIR = {"spmm_cuda_panels": "spmm_pallas_panels",
        "spmm_cuda_panels_db": "spmm_pallas_panels_db"}


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
# the launch plan
# ----------------------------------------------------------------------------

#: chip_smoke.py's vocab mask layer (its logged geometry: 64,000 x 4,096 at
#: density 0.1 in beta(4,8), pr 512, cb 64) and panel plans of the same
#: size in other block shapes, their vmax (a multiple of 8, as
#: ``to_panels`` rounds it) and nchunks set by hand.
#: (cb, r, c, vmax, pr, npanels, nchunks)
SMOKE = {
    "vocab": (64, 4, 8, 312, 512, 125, 830),
    "beta18": (64, 1, 8, 136, 512, 125, 2_900),
    "beta24": (64, 2, 4, 112, 512, 125, 2_400),
    "beta84": (64, 8, 4, 392, 512, 125, 700),
}


def _ctas_per_sm(smem, threads):
    """An H100 SM's CTAs by its 65,536 registers (64 a thread at most, as
    the panel kernels are built) and 228 KB of shared memory (1 KB of it
    reserved per CTA)."""
    return min(65_536 // (64 * threads), (228 * 1024) // (smem + 1024))


@pytest.fixture
def fake_card(monkeypatch):
    """``panels_occupancy`` as an H100 of 132 SMs would answer it."""
    monkeypatch.setattr(KM, "panels_occupancy",
                        lambda stages, c, vec, threads, smem, device, vsize=4:
                        (_ctas_per_sm(smem, threads), 132))


def _launch(case, stages, nvec, vec=None, **kw):
    cb, r, c, vmax, pr, npanels, nchunks = SMOKE[case]
    return KM.panels_launch(stages, npanels, nchunks, cb=cb, r=r, c=c,
                            vmax=vmax, pr=pr, nvec=nvec,
                            vec=KM.panels_vector(nvec) if vec is None else vec,
                            device=torch.device("cpu"), **kw)


@pytest.mark.parametrize("stages", [1, KM.PANEL_DB_STAGES])
@pytest.mark.parametrize("case", sorted(SMOKE))
def test_smem_formula_counts_every_part(case, stages):
    """The Y tile of a row part, then per stage the q value windows, their
    x window starts, four metadata rows of q * cb words and a slot for the
    mbarrier and two counters, then the blocks' sort keys (4 bytes a block)
    and the list of the stage's nonzeros (16 bytes each, q * vmax at most),
    each part rounded up to 16 bytes."""
    cb, r, c, vmax, pr, _, _ = SMOKE[case]
    for q in (1, 2, 3):
        for prows, tw in ((pr, 1), (pr, 16), (pr // 4, 128), (8, 4)):
            nb = q * cb
            stage = (q * -(-4 * vmax // 16) * 16 + 16 * -(-4 * q // 16)
                     + 4 * -(-4 * nb // 16) * 16 + 16)
            assert KM.panels_smem_bytes(stages, q, cb, vmax, prows, tw) == (
                4 * prows * tw + stages * stage + -(-4 * nb // 16) * 16
                + 16 * q * vmax)
    if case == "vocab":
        # (128, 128) tile + s * (2 * 1,248 + 16 + 4 * 512 + 16) + 128 * 4
        # + 624 * 16
        assert KM.panels_smem_bytes(stages, 2, cb, vmax, 128, 128) == \
            65_536 + stages * 4_576 + 512 + 9_984


#: The vocab mask layer at nvec 16 and 128: (tile, columns a lane, row
#: parts, chunks a stage of the synchronous kernel and of the ring,
#: threads, CTAs an SM, S).
VOCAB = {16: (16, 4, 1, (3, 2), 256, 4, 17),
         128: (128, 4, 4, (4, 4), 512, 2, 3)}


@pytest.mark.parametrize("nvec", sorted(VOCAB))
@pytest.mark.parametrize("stages", [1, KM.PANEL_DB_STAGES])
def test_vocab_launches(fake_card, stages, nvec):
    """Four columns a lane: at nvec 16 one 16-column tile of four lanes
    (256 threads), its (512, 16) Y tile whole, four CTAs an SM (by
    registers) and S = 17 from four waves over 125 panels; at nvec 128 one
    128-column tile of 32 lanes (512 threads), whose (512, 128) Y tile does
    not fit two CTAs an SM, so each panel is cut into four row parts of 128
    rows, two CTAs an SM and S = 3 over 500 units; in a stage the most
    chunks (up to four) at which an SM holds as many CTAs as with one: four
    at nvec 128, three (synchronous) or two (ring) at nvec 16, where a
    fourth would cost a CTA an SM."""
    cb, r, c, vmax, pr, npanels, nchunks = SMOKE["vocab"]
    tw, vec, parts, qs, threads, per_sm, split = VOCAB[nvec]
    q = qs[stages - 1]
    launch = _launch("vocab", stages, nvec)
    prows = pr // parts
    assert launch["stages"] == stages
    assert (launch["tile_columns"], launch["vector"], launch["lanes"]) == (
        tw, vec, tw // vec)
    assert (launch["row_parts"], launch["part_rows"]) == (parts, prows)
    assert (launch["chunks_per_stage"], launch["threads"]) == (q, threads)
    assert launch["smem_bytes"] == KM.panels_smem_bytes(
        stages, q, cb, vmax, prows, tw) <= KM.TWO_CTA_SMEM_BYTES
    assert parts == 1 or KM.panels_smem_bytes(
        stages, 1, cb, vmax, 2 * prows, tw) > KM.TWO_CTA_SMEM_BYTES
    assert q == KM.PANEL_STAGE_CHUNKS or _ctas_per_sm(KM.panels_smem_bytes(
        stages, q + 1, cb, vmax, prows, tw), threads) < per_sm
    assert (launch["ctas_per_sm"], launch["split"]) == (per_sm, split)
    assert split == K.panels_split(npanels * parts, nchunks, per_sm, 132)
    assert launch["ntiles"] == 1
    assert launch["grid"] == npanels * parts * split
    ranges = KD.chunk_ranges(nchunks, split)
    assert launch["chunks_per_cta"] == max(n for _, n in ranges)
    covered = np.concatenate([np.arange(f, f + n) for f, n in ranges])
    assert np.array_equal(covered, np.arange(nchunks))


@pytest.mark.parametrize("nvec", [3, 16, 128])
@pytest.mark.parametrize("stages", [1, KM.PANEL_DB_STAGES])
@pytest.mark.parametrize("case", ["beta18", "beta24", "beta84"])
def test_other_block_shapes(fake_card, case, stages, nvec):
    """beta(1,8), beta(2,4) and beta(8,4): the launch depends on r only
    through the row parts (each a multiple of r rows), so the tiles, lanes
    and threads are the vocab layer's, and nvec 3 takes one column a lane
    (a tile of four, one lane idle)."""
    cb, r, c, vmax, pr, npanels, nchunks = SMOKE[case]
    launch = _launch(case, stages, nvec)
    want = {3: (4, 1, 4, 256), 16: (16, 4, 4, 256), 128: (128, 4, 32, 512)}
    assert (launch["tile_columns"], launch["vector"], launch["lanes"],
            launch["threads"]) == want[nvec]
    prows, parts = launch["part_rows"], launch["row_parts"]
    assert prows % r == 0 and parts * prows >= pr > (parts - 1) * prows
    assert launch["smem_bytes"] <= KM.TWO_CTA_SMEM_BYTES
    assert launch["split"] == K.panels_split(
        npanels * parts, nchunks, launch["ctas_per_sm"], 132)
    assert 1 <= launch["split"] <= nchunks


@pytest.mark.parametrize("split", [1, 2, 829, 830])
def test_split_can_be_forced(fake_card, split):
    launch = _launch("vocab", KM.PANEL_DB_STAGES, 128, split=split)
    assert launch["split"] == split
    assert launch["grid"] == 125 * launch["row_parts"] * split
    assert launch["chunks_per_cta"] == -(-830 // split)


@pytest.mark.parametrize("stages", [1, KM.PANEL_DB_STAGES])
@pytest.mark.parametrize("split", [0, -1, 831])
def test_split_out_of_range_raises(fake_card, stages, split):
    with pytest.raises(ValueError, match="split must be in"):
        _launch("vocab", stages, 16, split=split)


@pytest.mark.parametrize("nvec,offset,vec", [
    (1, 0, 1), (3, 0, 1), (4, 0, 4), (6, 0, 2), (6, 8, 2), (8, 4, 1),
    (8, 8, 2), (16, 4, 1), (16, 8, 2), (16, 0, 4), (128, 0, 4),
    (128, 4, 1)])
def test_lane_width(nvec, offset, vec):
    """Four columns a lane where 4 divides nvec and X is 16-byte aligned,
    two where 2 does and X is 8-byte aligned, else one (a misaligned X at
    nvec 16 or 128 takes one or two)."""
    buf = torch.zeros(nvec * 8 + 4)
    x = buf[offset // 4:][:nvec * 8].view(8, nvec)
    assert x.data_ptr() % 16 == offset
    assert KM.panels_vector(nvec, x) == vec


@pytest.mark.parametrize("offset,vec", [(4, 1), (8, 2)])
def test_misaligned_x_launch(fake_card, offset, vec):
    """The vocab layer at nvec 128 with an X 4 or 8 bytes past a 16-byte
    boundary: 32 lanes of one or two columns make a 32- or 64-column tile,
    so the panel's Y tile is narrower and fewer row parts are needed."""
    buf = torch.zeros(4_096 * 128 + 4)
    x = buf[offset // 4:][:4_096 * 128].view(4_096, 128)
    launch = _launch("vocab", KM.PANEL_DB_STAGES, 128,
                     vec=KM.panels_vector(128, x))
    assert (launch["vector"], launch["tile_columns"], launch["lanes"]) == (
        vec, 32 * vec, 32)
    assert launch["ntiles"] == 128 // (32 * vec)
    assert launch["row_parts"] == (1 if vec == 1 else 2)


@pytest.mark.parametrize("tile", [128, 64, 32])
@pytest.mark.parametrize("nvec,vec", [(1, 1), (3, 1), (16, 4), (40, 4),
                                      (128, 4), (128, 1), (256, 2)])
def test_tiles(monkeypatch, nvec, vec, tile):
    """Tiles are powers of two covering nvec, at most PANEL_TILE and 32
    lanes of ``vec`` columns, halved down to one column."""
    monkeypatch.setattr(KM, "PANEL_TILE", tile)
    top = min(tile, 32 * vec, 1 << max(0, nvec - 1).bit_length())
    assert KM.panels_tiles(nvec, vec) == [t for t in (128, 64, 32, 16, 8, 4,
                                                       2, 1) if t <= top]


def test_row_parts_stage_chunks_and_refusals(monkeypatch):
    """A tall panel (pr 4,096) keeps the 128-column tile and takes the
    fewest row parts (a multiple of r rows each) at which two CTAs fit an
    SM; a stage of one chunk where two would cost CTAs an SM; a value window
    that fits no CTA, a ring other than 1 or 2 and a block shape without a
    kernel raise before any launch; at least PANEL_ROW_PARTS parts."""
    cta = KM.panels_plan(2, 64, 4, 8, 312, 4_096, 128, 4)
    assert (cta["tile_columns"], cta["vector"], cta["lanes"]) == (128, 4, 32)
    parts, prows = cta["row_parts"], cta["part_rows"]
    assert prows % 4 == 0 and parts * prows >= 4_096 > (parts - 1) * prows
    assert cta["smem_bytes"] == KM.panels_smem_bytes(
        2, cta["chunks_per_stage"], 64, 312, prows, 128) <= \
        KM.TWO_CTA_SMEM_BYTES
    assert KM.panels_smem_bytes(2, 1, 64, 312, 2 * prows, 128) > \
        KM.TWO_CTA_SMEM_BYTES
    # dense chunks (vmax 2,048): two chunks a stage would leave one CTA an
    # SM, one leaves two
    cta = KM.panels_plan(2, 64, 4, 8, 2_048, 512, 16, 4)
    assert cta["chunks_per_stage"] == 1 and cta["row_parts"] == 1
    assert cta["smem_bytes"] <= KM.TWO_CTA_SMEM_BYTES < KM.panels_smem_bytes(
        2, 2, 64, 2_048, 512, 16)
    with pytest.raises(ValueError, match="shared memory"):
        KM.panels_plan(2, 64, 4, 8, 20_000, 512, 16, 4)
    with pytest.raises(ValueError, match="stage 1 or"):
        KM.panels_plan(3, 64, 4, 8, 312, 512, 16, 4)
    for r, c in ((3, 8), (4, 2), (8, 8)):
        with pytest.raises(ValueError, match="no panel SpMM kernel"):
            KM.panels_plan(2, 64, r, c, 312, 512, 16, 4)
    monkeypatch.setattr(KM, "PANEL_ROW_PARTS", 8)
    cta = KM.panels_plan(2, 64, 4, 8, 312, 512, 16, 4)
    assert (cta["row_parts"], cta["part_rows"]) == (8, 64)
    monkeypatch.setattr(KM, "PANEL_TILE", 16)
    assert KM.panels_plan(2, 64, 4, 8, 312, 512, 128, 4)[
        "tile_columns"] == 16


# ----------------------------------------------------------------------------
# the wrappers on the CPU against the reference's Pallas kernels
# ----------------------------------------------------------------------------

def _plans(rc, seed, shape=(136, 150), density=0.12):
    """Byte-equal panel mask plans of both packages (pr=32, xw=32, cb=4:
    several panels, many chunks a panel, nrows % pr != 0; nrows a multiple
    of every r, so a block row borrowed by another block lies whole inside
    the matrix)."""
    d = _random(shape, density, seed)
    kw = dict(layout="panels", lowering="mask", tune=False, pr=32, xw=32,
              cb=4)
    from repro.kernels import ops as jops
    jplan = jops.prepare(JF.csr_to_spc5(JF.csr_from_dense(d), *rc), **kw)
    tplan = tops.prepare(TF.csr_to_spc5(TF.csr_from_dense(d), *rc),
                         device="cpu", **kw)
    for t, j in zip(tplan.arrays, jplan.arrays):
        assert t.numpy().tobytes() == np.asarray(j).tobytes()
    return tplan, d


def _arrays(plan, order):
    """The plan's four metadata arrays (col, mask, voff, row) with each
    chunk's blocks in ``order``: as planned ("plan"), shuffled
    ("permuted"), or each block taking the row of the chunk's first or
    second block in turn, so every block row of a chunk repeats
    ("repeated", which changes the product; each chunk's nonzeros still fit
    its window)."""
    arrays = [t.numpy() for t in (plan.chunk_col, plan.chunk_mask,
                                  plan.chunk_voff, plan.chunk_row)]
    if order == "plan":
        return arrays
    if order == "repeated":
        pick = np.arange(plan.cb) % 2
        return arrays[:3] + [np.ascontiguousarray(arrays[3][:, :, pick])]
    pick = np.random.default_rng(3).permutation(plan.cb)
    return [np.ascontiguousarray(t[:, :, pick]) for t in arrays]


def _both(kernel, plan, arrays, x, nvt=128):
    kw = dict(r=plan.r, c=plan.c, cb=plan.cb, vmax=plan.vmax, xw=plan.xw,
              pr=plan.pr, nrows=plan.nrows, ncols_pad=plan.ncols_pad,
              nvt=nvt)
    head = (plan.chunk_vbase, plan.chunk_xbase)
    y = getattr(KM, kernel)(*head, *(torch.from_numpy(t) for t in arrays),
                            plan.values, torch.from_numpy(x), split=3, **kw)
    y_pal = getattr(JK, PAIR[kernel])(
        *(jnp.asarray(a.numpy()) for a in head),
        *(jnp.asarray(t) for t in arrays), jnp.asarray(plan.values.numpy()),
        jnp.asarray(x), interpret=True, **kw)
    return y, y_pal


@pytest.mark.parametrize("order", ["plan", "permuted", "repeated"])
@pytest.mark.parametrize("kernel", sorted(PAIR))
@pytest.mark.parametrize("rc", TF.SUPPORTED_BLOCKS)
def test_pair_on_the_cpu_matches_pallas(rc, kernel, order):
    """The wrapper on the CPU against the reference's Pallas kernel in
    interpret mode on the same arrays, at nvec 4 in the plan's block order,
    with each chunk's blocks shuffled, and with two block rows repeated over
    each chunk; the first two also against the f64 product."""
    plan, d = _plans(rc, 10 * rc[0] + rc[1])
    x = np.random.default_rng(rc[1]).standard_normal(
        (d.shape[1], 4)).astype(np.float32)
    y, y_pal = _both(kernel, plan, _arrays(plan, order), x)
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
    y, y_pal = _both(kernel, plan, _arrays(plan, "repeated"), x, nvt=nvt)
    assert_close(y, y_pal)


@pytest.mark.parametrize("kernel", sorted(PAIR))
def test_split_changes_nothing_on_the_cpu(kernel):
    """On the CPU ``split`` is not checked (nothing is launched), as for the
    descriptor pair; the card's wrapper refuses S outside [1, nchunks]
    before any launch (``test_split_out_of_range_raises``)."""
    plan, d = _plans((4, 8), 6)
    x = np.ones((d.shape[1], 4), np.float32)
    kw = dict(r=4, c=8, cb=plan.cb, vmax=plan.vmax, xw=plan.xw, pr=plan.pr,
              nrows=plan.nrows, ncols_pad=plan.ncols_pad)
    args = (plan.chunk_vbase, plan.chunk_xbase, plan.chunk_col,
            plan.chunk_mask, plan.chunk_voff, plan.chunk_row, plan.values,
            torch.from_numpy(x))
    fn = getattr(KM, kernel)
    assert torch.equal(fn(*args, split=0, **kw), fn(*args, **kw))
