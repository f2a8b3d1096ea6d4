"""The whole-vector descriptor SpMV kernels' host side against the JAX
package.

* The tables both packages' ``chunk_descriptors`` build for the whole-vector
  layout repeat each block's columns over its rows (``xcol[k] ==
  xcol[k % c]``) and, on valid lanes, its rows over its columns (``yrow[k]
  == yrow[0] + k // c``); lanes past ``nrows`` or ``ncols`` are clipped,
  and invalid, as are padding blocks. The kernels read only the c xcol
  entries of each block's first row and its lane-0 yrow entry, so all of
  this is pinned here.
* The wrappers' launch planning (``whole_smem_bytes``, ``whole_stages``,
  ``chunk_ranges``, ``whole_launch`` with the card's occupancy faked) is
  pure Python and is checked on the geometries ``chip_smoke.py`` runs and on
  edge cases.
* The wrappers on the CPU (the plain version; ``grid`` is the kernels'
  and changes nothing there) against ``spmv_pallas_desc`` and
  ``spmv_pallas_desc_db`` in interpret mode, also on tables whose block
  rows are permuted (``rtol=1e-5``, ``atol=1e-5 * max|y_ref|``: the f32
  sums of a row are taken in another order).
"""
import importlib.util
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import formats as JF
from repro.kernels import spc5_spmv as JK
from repro_torch.core import formats as TF
from repro_torch.kernels import ops as tops
from repro_torch.kernels import spc5_spmv as K
from repro_torch.kernels import spc5_spmv_desc as KD

RTOL = 1e-5
KERNELS = {"spmv_cuda_desc": JK.spmv_pallas_desc,
           "spmv_cuda_desc_db": JK.spmv_pallas_desc_db}


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

#: 301 x 259: nrows % r != 0 for every r > 1 and ncols % c != 0 for c in
#: (4, 8), so the last block row and the rightmost blocks have clipped lanes.
SHAPE = (301, 259)


def _chunked(F, rc, cb=16, seed=0, shape=SHAPE):
    d = _random(shape, 0.08, seed + 3 * rc[0] + rc[1])
    # a nonzero in the last row and column: blocks there reach past both
    d[-1, -1] = 1.5
    mat = F.csr_to_spc5(F.csr_from_dense(d), *rc)
    return mat, F.to_chunked(mat, cb=cb), d


@pytest.mark.parametrize("col_map", [False, True])
@pytest.mark.parametrize("package", ["jax", "torch"])
@pytest.mark.parametrize("rc", TF.SUPPORTED_BLOCKS)
def test_whole_tables_repeat_columns_and_rows(rc, package, col_map):
    """Every lane of every block (padding included) of the whole-vector
    tables, with and without a folded column map: xcol depends only on
    k % c; on valid lanes yrow is the lane-0 entry (the block's first row)
    plus k // c; a lane whose row or column lies past the matrix, and every
    lane of a padding block (row 0), is invalid."""
    r, c = rc
    F = JF if package == "jax" else TF
    mat, ch, _ = _chunked(F, rc)
    nrows, ncols = SHAPE
    cmap = (np.random.default_rng(2).permutation(ncols) if col_map
            else None)
    d = F.chunk_descriptors(ch.chunk_mask, ch.chunk_voff, ch.chunk_col,
                            ch.chunk_row, r=r, c=c, vmax=ch.vmax, xmax=ncols,
                            ymax=nrows, col_map=cmap)
    k = np.arange(r * c)
    xcol = d.xcol.astype(np.int64)
    yrow = d.yrow.astype(np.int64)
    valid = d.valid.astype(bool)
    assert np.array_equal(xcol, xcol[..., k % c])
    assert np.array_equal(yrow[..., 0], ch.chunk_row)
    assert np.array_equal(np.where(valid, yrow, 0),
                          np.where(valid, yrow[..., :1] + k // c, 0))
    row = ch.chunk_row[..., None].astype(np.int64) + k // c
    col = ch.chunk_col[..., None].astype(np.int64) + k % c
    clipped = (row >= nrows) | (col >= ncols)
    assert clipped.any() and not (valid & clipped).any()
    pad = ch.chunk_mask == 0
    assert pad.any() and mat.nblocks % ch.cb
    assert not valid[pad].any() and not ch.chunk_row[pad].any()
    assert valid.sum() == mat.nnz


def test_port_plan_tables_repeat_columns_and_rows():
    """The same identities on the tables a port plan hands the kernels (the
    token plan's shape, beta(4,8) at cb=256, int32 yrow past 32,767 rows),
    at a small density."""
    w = _random((33_000, 64), 0.05, 4)
    plan = tops.prepare(TF.csr_to_spc5(TF.csr_from_dense(w), 4, 8),
                        layout="whole_vector", lowering="descriptor",
                        tune=False, device="cpu", cb=256)
    assert plan.desc_yrow.dtype == torch.int32
    k = torch.arange(32)
    xcol = plan.desc_xcol.long()
    yrow = plan.desc_yrow.long()
    valid = plan.desc_valid.bool()
    assert torch.equal(xcol, xcol[..., k % 8])
    assert torch.equal(torch.where(valid, yrow, 0),
                       torch.where(valid, yrow[..., :1] + k // 8, 0))


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("layout", ["whole_vector", "panels"])
@pytest.mark.parametrize("rc", [(2, 4), (4, 8)])
def test_needed_bytes_count_one_yrow_entry_a_block(rc, layout):
    """chip_smoke.py's bound counts, of a descriptor plan's xcol and yrow
    tables, the c entries and the one entry per block that the identities
    above leave (both layouts), and every other byte of the plan as built
    (``whole_plan`` counts the repeated entries too)."""
    S = _chip_smoke()
    w = _random((301, 259), 0.05, 6)
    geom = (dict(cb=16) if layout == "whole_vector"
            else dict(cb=16, pr=64, xw=64))
    plan = tops.prepare(TF.csr_to_spc5(TF.csr_from_dense(w), *rc),
                        layout=layout, lowering="descriptor", tune=False,
                        device="cpu", **geom)
    blocks = plan.desc_valid.numel() // (rc[0] * rc[1])
    wx, wy = plan.desc_xcol.element_size(), plan.desc_yrow.element_size()
    whole = sum(a.numel() * a.element_size() for a in plan.arrays)
    assert S.needed_bytes(plan, whole_plan=True) == whole
    repeated = (plan.desc_xcol.numel() * wx - blocks * rc[1] * wx
                + plan.desc_yrow.numel() * wy - blocks * wy)
    assert S.needed_bytes(plan) == whole - repeated


# ----------------------------------------------------------------------------
# the wrappers' launch planning
# ----------------------------------------------------------------------------

#: chip_smoke.py's whole-vector descriptor plans (its logged geometry): the
#: vocab token plan (ops.prepare of the 64,000 x 4,096 weight at nvec 1) and
#: the FEM matrix. (cb, r, c, vmax, vidx bytes, xcol bytes, nchunks)
SMOKE = {
    "token": (256, 4, 8, 1_144, 2, 2, 25_856),
    "fem": (256, 4, 4, 4_096, 2, 4, 2_321),
}


def _ctas_per_sm(smem, threads):
    """An H100 SM's CTAs by its 2,048 threads and 228 KB of shared memory
    (1 KB of it reserved per CTA); registers not counted."""
    return min(2048 // threads, (228 * 1024) // (smem + 1024))


def _geom(case, tile=None):
    cb, r, c, vmax, wv, wx, _ = SMOKE[case]
    return (cb, r, c, vmax, KD.WHOLE_TILE_ROWS if tile is None else tile,
            wv, wx)


@pytest.mark.parametrize("stages", [1, 2])
@pytest.mark.parametrize("case", sorted(SMOKE))
def test_whole_smem_formula_counts_every_part(case, stages):
    cb, r, c, vmax, tile, wv, wx = _geom(case)
    rc = r * c
    parts = [4 * vmax, cb * rc, cb * rc * wv, cb * c * wx, 4 * cb]
    stage = sum(-(-p // 16) * 16 for p in parts) + 16     # + the mbarrier
    got = KD.whole_smem_bytes(stages, cb, r, c, vmax, tile, wv, wx)
    assert got == 4 * tile + stages * stage
    if case == "token":
        # 2,048 + s * (4,576 + 8,192 + 16,384 + 4,096 + 1,024 + 16)
        assert got == 2_048 + stages * 34_288


def _threads(nb, r, c):
    """The wrapper's threads a CTA: a thread for every two lane quads of a
    stage, in whole warps, 64 to WHOLE_THREADS (512)."""
    assert (KD.WHOLE_QUADS_PER_THREAD, KD.WHOLE_THREADS) == (2, 512)
    return min(512, max(64, -(-(nb * r * c // 8) // 32) * 32))


@pytest.mark.parametrize("case", sorted(SMOKE))
def test_smoke_geometries_stage_whole_chunks(case):
    """On both smoke plans the synchronous kernel stages whole chunks and
    the ring keeps WHOLE_DB_STAGES of them, 512 threads and three or more
    CTAs an SM."""
    geom = _geom(case)
    assert KD.whole_stages(1, *geom) == (1, geom[0],
                                         KD.whole_smem_bytes(1, *geom))
    stages, nb, smem = KD.whole_stages(KD.WHOLE_DB_STAGES, *geom)
    assert (stages, nb) == (KD.WHOLE_DB_STAGES, geom[0]) == (2, geom[0])
    assert _threads(nb, *geom[1:3]) == 512
    assert _ctas_per_sm(smem, 512) >= 3


@pytest.mark.parametrize("stages", [1, 2])
@pytest.mark.parametrize("case", sorted(SMOKE))
def test_grid_fills_the_card_on_smoke_geometries(case, stages):
    """G is the panel kernels' split of one "panel" holding every chunk:
    SPLIT_WAVES waves of the CTAs an H100 holds at the plan's shared memory
    and threads, at most one a chunk; on the token plan each CTA takes a
    range of many chunks."""
    geom = _geom(case)
    nchunks = SMOKE[case][-1]
    _, nb, smem = KD.whole_stages(stages, *geom)
    per_sm = _ctas_per_sm(smem, _threads(nb, *geom[1:3]))
    assert per_sm == (4 if stages == 1 else 3)   # by threads, by smem
    g = KD.panels_split(1, nchunks, per_sm, 132)
    assert g == min(nchunks, KD.SPLIT_WAVES * per_sm * 132) < nchunks
    if case == "token":
        assert nchunks // g >= 12


@pytest.mark.parametrize("nchunks,parts", [
    (25_856, 1_056), (2_321, 1), (2_321, 2_321), (2_321, 1_056), (7, 3),
    (1, 1), (5, 4)])
def test_chunk_ranges_cover_each_chunk_once(nchunks, parts):
    ranges = KD.chunk_ranges(nchunks, parts)
    assert len(ranges) == parts
    covered = np.concatenate([np.arange(c0, c0 + n) for c0, n in ranges])
    assert np.array_equal(covered, np.arange(nchunks))
    counts = [n for _, n in ranges]
    assert min(counts) >= 1 and max(counts) - min(counts) <= 1


@pytest.fixture
def fake_card(monkeypatch):
    """The card's occupancy as ``_ctas_per_sm`` reckons it, 132 SMs (the
    wrapper asks the CUDA runtime there)."""
    asked = []

    def occupancy(layout, stages, threads, smem, device):
        asked.append((layout, stages, threads, smem))
        return _ctas_per_sm(smem, threads), 132
    monkeypatch.setattr(KD, "_occupancy", occupancy)
    return asked


@pytest.mark.parametrize("case", sorted(SMOKE))
def test_whole_launch_picks_and_forces_the_grid(case, fake_card):
    cb, r, c, vmax, wv, wx, nchunks = SMOKE[case]
    kw = dict(cb=cb, r=r, c=c, vmax=vmax, wv=wv, wx=wx,
              device=torch.device("cpu"))
    for stages in (1, KD.WHOLE_DB_STAGES):
        launch = KD.whole_launch(stages, nchunks, **kw)
        per_sm = launch["ctas_per_sm"]
        assert fake_card[-1] == ("whole", stages, launch["threads"],
                                 launch["smem_bytes"])
        assert launch["threads"] == 512 and launch["sms"] == 132
        assert launch["grid"] == KD.panels_split(1, nchunks, per_sm, 132)
        assert launch["chunks_per_cta"] == -(-nchunks // launch["grid"])
        assert launch["tile_rows"] == KD.WHOLE_TILE_ROWS
        assert launch["stages"] == stages
        assert launch["smem_bytes"] == KD.whole_smem_bytes(
            stages, cb, r, c, vmax, KD.WHOLE_TILE_ROWS, wv, wx)
        for grid in (1, nchunks):
            forced = KD.whole_launch(stages, nchunks, grid=grid, **kw)
            assert forced["grid"] == grid
            assert forced["chunks_per_cta"] == -(-nchunks // grid)
        for grid in (0, nchunks + 1):
            with pytest.raises(ValueError, match="grid must be"):
                KD.whole_launch(stages, nchunks, grid=grid, **kw)


def test_one_chunk_gets_one_cta(fake_card):
    """A matrix of fewer blocks than cb is one chunk: one CTA, whatever the
    card holds."""
    launch = KD.whole_launch(KD.WHOLE_DB_STAGES, 1, cb=256, r=2, c=4, vmax=64,
                             wv=1, wx=1, device=torch.device("cpu"))
    assert launch["grid"] == 1 and launch["chunks_per_cta"] == 1


@pytest.mark.parametrize("cb,rc,want", [
    (256, (4, 8), 512), (256, (4, 4), 512), (256, (2, 4), 256),
    (256, (1, 4), 128), (64, (2, 4), 64), (16, (2, 4), 64), (4, (1, 4), 64),
    (6, (1, 8), 64), (1_280, (4, 8), 512)])
def test_threads_follow_the_lane_quads(cb, rc, want, fake_card):
    """A thread for every two lane quads of a stage, in whole warps, 64 to
    512 (whole warps keep a row's two quads in one warp for the xor
    shuffle): 512 on the token and FEM plans, 256 on the flat-tail plan's
    β(2,4) chunks."""
    launch = KD.whole_launch(1, 3, cb=cb, r=rc[0], c=rc[1], vmax=64, wv=1,
                             wx=1, device=torch.device("cpu"))
    assert launch["threads"] == want == _threads(cb, *rc)
    assert want % 32 == 0


@pytest.mark.parametrize("rc", [(1, 4), (2, 4), (4, 8)])
def test_cb6_stage_holds_odd_runs(rc):
    """cb = 6: a chunk's valid run is 6 * r * c bytes, not a multiple of 16
    for r * c in (4, 8) (the kernels copy it in 4-byte pieces then), and
    every part of the stage still starts 16-byte aligned."""
    r, c = rc
    for wv, wx in ((1, 1), (2, 2), (4, 4)):
        got = KD.whole_smem_bytes(2, 6, r, c, 24, 16, wv, wx)
        parts = [96, 6 * r * c, 6 * r * c * wv, 6 * c * wx, 24]
        assert got == 64 + 2 * (sum(-(-p // 16) * 16 for p in parts) + 16)
        assert got % 16 == 0


@pytest.mark.parametrize("wv", [1, 2, 4])
def test_table_widths_size_the_stage(wv):
    """vidx at each width it can have: the stage grows by cb * r * c
    bytes for each byte of width, xcol by cb * c."""
    base = KD.whole_smem_bytes(1, 64, 2, 4, 256, 512, 1, 1)
    assert KD.whole_smem_bytes(1, 64, 2, 4, 256, 512, wv, 1) == \
        base + 64 * 8 * (wv - 1)
    assert KD.whole_smem_bytes(1, 64, 2, 4, 256, 512, 1, wv) == \
        base + 64 * 4 * (wv - 1)


def test_big_windows_slice_or_refuse():
    """A 160 KB value window (1,280 full beta(4,8) blocks, int32 vidx): no
    ring of two fits, so the double-buffered kernel refuses; the
    synchronous kernel stages its tables in slices of fewer blocks. The
    whole-vector kernels are built for rings of 1 and 2 only: any other is
    refused, never shortened."""
    big = (1_280, 4, 8, 40_960, KD.WHOLE_TILE_ROWS, 4, 2)
    with pytest.raises(ValueError, match="shared memory"):
        KD.whole_stages(2, *big)
    stages, nb, smem = KD.whole_stages(1, *big)
    assert stages == 1 and nb < 1_280 and smem <= K.MAX_SMEM_BYTES
    assert KD.whole_smem_bytes(1, 2 * nb, *big[1:]) > K.MAX_SMEM_BYTES
    mid = (256, 4, 8, 12_000, KD.WHOLE_TILE_ROWS, 2, 2)   # 48 KB windows
    assert KD.whole_stages(2, *mid)[:2] == (2, 256)
    for stages in (0, 3):
        with pytest.raises(ValueError, match="stage 1 or 2 chunks"):
            KD.whole_stages(stages, *mid)
    with pytest.raises(ValueError, match="shared memory"):
        KD.whole_stages(1, 16, 2, 4, 64, 60_000, 1, 1)


# ----------------------------------------------------------------------------
# the wrappers (plain path on the CPU) against the reference's Pallas kernels
# ----------------------------------------------------------------------------

def _tables(F, ch, nrows, ncols, chunk_row=None):
    return F.chunk_descriptors(
        ch.chunk_mask, ch.chunk_voff, ch.chunk_col,
        ch.chunk_row if chunk_row is None else chunk_row, r=ch.r, c=ch.c,
        vmax=ch.vmax, xmax=ncols, ymax=nrows)


def _both(kernel, ch, d, x, nrows, ncols, **kw):
    """The port's wrapper on the CPU and the reference's Pallas kernel in
    interpret mode, on the same chunked arrays and tables ``d``."""
    args = (ch.chunk_vbase, d.valid, d.vidx, d.xcol, d.yrow, ch.values)
    geom = dict(r=ch.r, c=ch.c, cb=ch.cb, vmax=ch.vmax, nrows=nrows,
                ncols=ncols)
    y = getattr(KD, kernel)(*(torch.from_numpy(np.ascontiguousarray(a))
                              for a in args), torch.from_numpy(x),
                            **geom, **kw)
    y_ref = KERNELS[kernel](*(jnp.asarray(a) for a in args), jnp.asarray(x),
                            **geom, interpret=True)
    return y, np.asarray(y_ref)


@pytest.mark.parametrize("kernel", sorted(KERNELS))
@pytest.mark.parametrize("rc", TF.SUPPORTED_BLOCKS)
def test_wrapper_matches_pallas_desc(rc, kernel):
    """Clipped lanes and padding blocks, every block shape; the kernels'
    own ``grid`` argument passes through the CPU path."""
    _, ch, dense = _chunked(TF, rc, seed=1)
    x = np.random.default_rng(5).standard_normal(SHAPE[1]).astype(np.float32)
    d = _tables(TF, ch, *SHAPE)
    y, y_ref = _both(kernel, ch, d, x, *SHAPE, grid=1)
    assert y.shape == (SHAPE[0],) and y.dtype == torch.float32
    assert_close(y, y_ref)
    assert_close(y, dense.astype(np.float64) @ x.astype(np.float64))


def _permuted(rc, seed):
    """Chunked arrays of a 304 x 259 matrix (nrows % r == 0) whose block
    rows are permuted: chunk_row takes block row p(i) for block row i, so
    a chunk's rows jump about and neighbouring chunks no longer meet;
    returns them, the tables and the permuted dense matrix."""
    r, _ = rc
    shape = (304, SHAPE[1])
    mat, ch, dense = _chunked(TF, rc, seed=seed, shape=shape)
    perm = np.random.default_rng(seed).permutation(shape[0] // r)
    real = ch.chunk_mask != 0
    row = np.where(real, perm[ch.chunk_row // r] * r, 0).astype(np.int32)
    d = _tables(TF, ch, *shape, chunk_row=row)
    moved = np.zeros_like(dense)
    for i, p in enumerate(perm):
        moved[p * r:(p + 1) * r] = dense[i * r:(i + 1) * r]
    return ch, d, moved, shape


@pytest.mark.parametrize("kernel", sorted(KERNELS))
@pytest.mark.parametrize("rc", [(1, 8), (2, 4), (4, 4), (8, 4)])
def test_permuted_block_rows_match_pallas(rc, kernel):
    ch, d, moved, shape = _permuted(rc, seed=7 + rc[0])
    rows = d.yrow[..., 0][ch.chunk_mask != 0]
    assert (np.diff(rows.astype(np.int64)) < 0).any()     # not monotone
    x = np.random.default_rng(6).standard_normal(shape[1]).astype(np.float32)
    y, y_ref = _both(kernel, ch, d, x, *shape)
    assert_close(y, y_ref)
    assert_close(y, moved.astype(np.float64) @ x.astype(np.float64))


@pytest.mark.parametrize("kernel", sorted(KERNELS))
@pytest.mark.parametrize("case", ["one_chunk", "cb6", "empty"])
def test_edge_geometries_match_pallas(case, kernel):
    """One chunk holding every block (and padding), cb = 6 (runs that are
    not whole 16-byte pieces) and a matrix with no nonzero."""
    rc = (2, 4) if case == "cb6" else (4, 8)
    dense = _random((45, 37), 0.2, 9)
    if case == "empty":
        dense[:] = 0.0
    mat = TF.csr_to_spc5(TF.csr_from_dense(dense), *rc)
    ch = TF.to_chunked(mat, cb={"one_chunk": 256, "cb6": 6,
                                "empty": 16}[case])
    assert (ch.nchunks == 1) == (case != "cb6")
    x = np.random.default_rng(8).standard_normal(37).astype(np.float32)
    d = _tables(TF, ch, 45, 37)
    y, y_ref = _both(kernel, ch, d, x, 45, 37)
    assert_close(y, y_ref)
    assert_close(y, dense.astype(np.float64) @ x.astype(np.float64))


@pytest.mark.parametrize("width", [8, 16, 32])
@pytest.mark.parametrize("table", ["vidx", "xcol", "yrow"])
def test_table_widths_match_pallas(table, width):
    """Each index table at each width it can have, read as built by both
    packages' wrappers: vidx bounded by vmax (cb), xcol by ncols, yrow by
    nrows."""
    if table == "vidx":
        cb = {8: 4, 16: 16, 32: 1_280}[width]
        dense = (_random((64, 4_096), 1.0, 7) if width == 32
                 else _random((120, 100), 0.3, 7))
        rc = (4, 8)
    else:
        big = {8: 100, 16: 1_000, 32: 40_000}[width]
        shape = (60, big) if table == "xcol" else (big, 60)
        dense = _random(shape, min(1.0, 300 / big), 8)
        cb, rc = 16, (2, 4)
    nrows, ncols = dense.shape
    ch = TF.to_chunked(TF.csr_to_spc5(TF.csr_from_dense(dense), *rc), cb=cb)
    d = _tables(TF, ch, nrows, ncols)
    assert getattr(d, table).dtype == np.dtype(f"int{width}")
    x = np.random.default_rng(width).standard_normal(ncols).astype(
        np.float32)
    y, y_ref = _both("spmv_cuda_desc", ch, d, x, nrows, ncols)
    assert_close(y, y_ref)
