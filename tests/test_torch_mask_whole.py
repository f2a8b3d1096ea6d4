"""The whole-vector mask SpMV kernels' host side (``spmv_cuda[_db]``), on the
CPU.

* The wrappers' launch planning is pure Python: the CTA's shared memory
  (``whole_smem_bytes``: the warps' y tiles, then the stages), the threads
  (``whole_threads``: a block row per thread and step, more of them where
  block rows are sparse), the contiguous chunk ranges (``chunk_ranges``,
  one cut shared with the descriptor kernels) and the grid G
  (``whole_launch``, with the card's occupancy faked: the panel kernels'
  split rule over one "panel" of every chunk). It is checked here on the
  geometries ``chip_smoke.py`` runs: the yi-6b vocab whole-vector mask layer
  (25,856 chunks) and the FEM matrix (2,321).
* The wrappers take ``grid`` on the CPU too (the plain version ignores it)
  and agree with the JAX package's ``spmv_pallas`` / ``spmv_pallas_db`` in
  interpret mode, also on chunked arrays whose block rows are permuted by
  hand (``rtol=1e-5``, ``atol=1e-5 * max|y_ref|``: the f32 sums of a row are
  taken in another order).
"""
import importlib.util
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import spc5_spmv as JK
from repro_torch.core import formats as TF
from repro_torch.kernels import ops as tops
from repro_torch.kernels import spc5_spmv as K
from repro_torch.kernels import spc5_spmv_desc as KD

RTOL = 1e-5
KERNELS = {"spmv_cuda": JK.spmv_pallas, "spmv_cuda_db": JK.spmv_pallas_db}

#: chip_smoke.py's whole-vector mask plans (its logged geometry): (cb, r,
#: c, vmax, nchunks).
SMOKE = {
    "vocab": (256, 4, 8, 1_144, 25_856),
    "fem": (256, 4, 4, 4_096, 2_321),
}


def _ctas_per_sm(smem, threads):
    """An H100 SM's CTAs by its 2,048 threads, 32 CTAs and 228 KB of shared
    memory (1 KB of it reserved per CTA); registers not counted."""
    return min(32, 2048 // threads, (228 * 1024) // (smem + 1024))


def _stage(cb, vmax):
    """A copy of the kernel's stage: the value window, four metadata rows
    of cb int32 entries and a 16-byte slot (x window start and mbarrier),
    each part 16-byte aligned."""
    parts = [4 * vmax] + [4 * cb] * 4 + [16]
    return sum(-(-p // 16) * 16 for p in parts)


# ----------------------------------------------------------------------------
# the wrappers' launch planning
# ----------------------------------------------------------------------------

@pytest.mark.parametrize("stages", [1, 2])
@pytest.mark.parametrize("case", sorted(SMOKE))
def test_smem_formula_counts_every_part(case, stages):
    """Each warp's (tile,) f32 y tile, then ``stages`` stages."""
    cb, r, _, vmax, _ = SMOKE[case]
    for tile, threads in ((K.WHOLE_TILE_ROWS, 128), (1, 32), (512, 256)):
        want = -(-4 * tile * (threads // 32) // 16) * 16 + \
            stages * _stage(cb, vmax)
        assert K.whole_smem_bytes(stages, cb, vmax, tile, threads) == want
    if case == "vocab":
        # 4 warps x 32 rows x 4 bytes + s * (4,576 + 4 * 1,024 + 16)
        assert K.whole_smem_bytes(stages, cb, vmax, 32, 128) == \
            512 + stages * 8_688


def test_both_layouts_stage_a_chunk_alike():
    """The panel kernels' stage is the same bytes (``_stage_bytes``)."""
    for cb, vmax in ((256, 1_144), (64, 312), (6, 48)):
        assert K._stage_bytes(cb, vmax) == _stage(cb, vmax)
        assert K.panels_smem_bytes(2, cb, vmax, 64) == \
            256 + 2 * _stage(cb, vmax)


@pytest.mark.parametrize("case", sorted(SMOKE))
def test_smoke_geometries_fit_a_stage_and_a_ring(case):
    """Both smoke plans fit the synchronous kernel's stage and the ring of
    two, far below a CTA's 227 KB: several CTAs an SM either way."""
    cb, r, _, vmax, _ = SMOKE[case]
    threads = K.whole_threads(cb, r, vmax)
    for stages in (1, K.WHOLE_DB_STAGES):
        smem = K.whole_smem_bytes(stages, cb, vmax, K.WHOLE_TILE_ROWS,
                                  threads)
        assert smem <= K.MAX_SMEM_BYTES // 4
        assert _ctas_per_sm(smem, threads) >= 4


@pytest.mark.parametrize("cb,r,vmax,want", [
    # the vocab layer: 1.1 nonzeros a block row -> 8 rows a thread
    (256, 4, 1_144, 128),
    # the FEM matrix: full beta(4,4) blocks -> 4 rows a thread
    (256, 4, 4_096, 256),
    # at the threshold (2 nonzeros a block row) still sparse
    (256, 4, 2_048, 128), (256, 4, 2_056, 256),
    # beta(8,4) / beta(1,8) chunks, small chunks (whole warps, at least 32),
    # and the 256 the kernel is built for
    (256, 8, 8_192, 256), (256, 1, 2_048, 64), (16, 4, 64, 32),
    (6, 2, 96, 32), (512, 4, 14_752, 256), (1_024, 4, 32_768, 256)])
def test_thread_rule(cb, r, vmax, want):
    """A thread for every WHOLE_ROWS_PER_THREAD block rows of a chunk, or
    WHOLE_SPARSE_ROWS_PER_THREAD where the window holds at most
    WHOLE_SPARSE_ROW_NNZ nonzeros a block row; whole warps, 32 to 256."""
    assert (K.WHOLE_ROWS_PER_THREAD, K.WHOLE_SPARSE_ROWS_PER_THREAD,
            K.WHOLE_SPARSE_ROW_NNZ) == (4, 8, 2)
    assert K.whole_threads(cb, r, vmax) == want
    assert want % 32 == 0


@pytest.mark.parametrize("nchunks,parts", [
    (25_856, 8_448), (25_856, 6_336), (2_321, 1), (2_321, 2_321),
    (2_321, 1_056), (7, 3), (1, 1), (5, 4)])
def test_chunk_ranges_cover_each_chunk_once(nchunks, parts):
    """Contiguous ranges, in order, of nchunks // parts or one more chunks;
    one cut for the mask and the descriptor kernels."""
    assert KD.chunk_ranges is K.chunk_ranges
    ranges = K.chunk_ranges(nchunks, parts)
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

    def occupancy(stages, threads, smem, device, vsize=4):
        asked.append((stages, threads, smem))
        return _ctas_per_sm(smem, threads), 132
    monkeypatch.setattr(K, "whole_occupancy", occupancy)
    return asked


@pytest.mark.parametrize("case", sorted(SMOKE))
def test_grid_fills_the_faked_card(case, fake_card):
    """G is the panel kernels' split of one "panel" holding every chunk:
    SPLIT_WAVES waves of the CTAs the card holds at the launch's shared
    memory and threads, at most one a chunk; on the vocab layer each CTA
    takes a range of several chunks, on the FEM matrix one."""
    cb, r, _, vmax, nchunks = SMOKE[case]
    kw = dict(cb=cb, r=r, vmax=vmax, device=torch.device("cpu"))
    for stages in (1, K.WHOLE_DB_STAGES):
        launch = K.whole_launch(stages, nchunks, **kw)
        per_sm = launch["ctas_per_sm"]
        assert fake_card[-1] == (stages, launch["threads"],
                                 launch["smem_bytes"])
        assert launch["threads"] == K.whole_threads(cb, r, vmax)
        assert launch["sms"] == 132
        assert launch["tile_rows"] == K.WHOLE_TILE_ROWS
        assert launch["smem_bytes"] == K.whole_smem_bytes(
            launch["stages"], cb, vmax, K.WHOLE_TILE_ROWS, launch["threads"])
        assert per_sm == _ctas_per_sm(launch["smem_bytes"], launch["threads"])
        assert launch["chunks_per_cta"] == -(-nchunks // launch["grid"])
        if case == "vocab":
            # G from the whole ring's occupancy; the ring kept
            assert launch["grid"] == K.panels_split(1, nchunks, per_sm, 132) \
                == min(nchunks, K.SPLIT_WAVES * per_sm * 132)
            assert launch["chunks_per_cta"] >= 3
            assert launch["stages"] == stages
        else:
            # one chunk a CTA, so one stage: nothing to stage ahead
            assert launch["grid"] == nchunks and launch["stages"] == 1


@pytest.mark.parametrize("case", sorted(SMOKE))
def test_forced_grids(case, fake_card):
    """``grid`` forces G: one CTA for every chunk and one chunk a CTA are
    taken, anything outside [1, nchunks] refused."""
    cb, r, _, vmax, nchunks = SMOKE[case]
    kw = dict(cb=cb, r=r, vmax=vmax, device=torch.device("cpu"))
    for stages in (1, K.WHOLE_DB_STAGES):
        for grid in (1, 3, nchunks):
            forced = K.whole_launch(stages, nchunks, grid=grid, **kw)
            assert forced["grid"] == grid
            assert forced["chunks_per_cta"] == -(-nchunks // grid)
        for grid in (0, nchunks + 1):
            with pytest.raises(ValueError, match="grid must be"):
                K.whole_launch(stages, nchunks, grid=grid, **kw)


def test_one_chunk_gets_one_cta(fake_card):
    """A matrix of fewer blocks than cb is one chunk: one CTA, whatever the
    card holds, and one stage."""
    for stages in (1, K.WHOLE_DB_STAGES):
        launch = K.whole_launch(stages, 1, cb=256, r=2, vmax=64,
                                device=torch.device("cpu"))
        assert launch["grid"] == 1 and launch["chunks_per_cta"] == 1
        assert launch["stages"] == 1


@pytest.mark.parametrize("case", sorted(SMOKE))
def test_ring_holds_no_more_stages_than_the_longest_range(case, fake_card):
    """The ring of ``spmv_cuda_db`` holds two stages where a CTA takes two
    chunks or more, one where every CTA takes one (the kernel's
    ``whole_ring``); the occupancy it reports is that launch's."""
    cb, r, _, vmax, nchunks = SMOKE[case]
    kw = dict(cb=cb, r=r, vmax=vmax, device=torch.device("cpu"))
    threads = K.whole_threads(cb, r, vmax)
    for grid, ring in ((1, 2), (nchunks // 2, 2), (nchunks - 1, 2),
                       (nchunks, 1)):
        launch = K.whole_launch(K.WHOLE_DB_STAGES, nchunks, grid=grid, **kw)
        assert launch["stages"] == ring
        smem = K.whole_smem_bytes(ring, cb, vmax, K.WHOLE_TILE_ROWS, threads)
        assert launch["smem_bytes"] == smem
        assert launch["ctas_per_sm"] == _ctas_per_sm(smem, threads)


def test_rings_are_refused_not_shortened(fake_card):
    """The kernels are built for one stage and a ring of two: other rings
    are refused; a ring of two whose windows do not fit a CTA raises (the
    synchronous kernel still fits one); a window too large for one stage
    raises for both."""
    kw = dict(cb=1_024, r=4, device=torch.device("cpu"))
    for stages in (0, 3):
        with pytest.raises(ValueError, match="stage 1 or 2 chunks"):
            K.whole_launch(stages, 4, vmax=64, **kw)
    assert K.whole_launch(1, 4, vmax=32_768, **kw)["smem_bytes"] <= \
        K.MAX_SMEM_BYTES
    with pytest.raises(ValueError, match="shared memory"):
        K.whole_launch(K.WHOLE_DB_STAGES, 4, vmax=32_768, **kw)
    for stages in (1, K.WHOLE_DB_STAGES):
        with pytest.raises(ValueError, match="shared memory"):
            K.whole_launch(stages, 4, vmax=62_000, **kw)
    assert not [a for a in fake_card if a[2] > K.MAX_SMEM_BYTES]


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_chip_smoke_prints_the_wrappers_plan():
    """``chip_smoke.whole_launches`` gives, for a mask plan on the CPU, the
    threads, tile and shared memory the wrappers plan, and names the pair
    it checks at forced grids."""
    S = _chip_smoke()
    assert S.WHOLE_SPMV["mask"] == {"spmv_cuda_db": "s2", "spmv_cuda": "s1"}
    assert S.BATCH1["spmv_cuda_db"] == (("whole_vector", "mask"), True)
    assert S.BATCH1["spmv_cuda"] == (("whole_vector", "mask"), False)
    w = _random((300, 260), 0.08, 3)
    plan = tops.prepare(TF.csr_to_spc5(TF.csr_from_dense(w), 4, 8),
                        layout="whole_vector", lowering="mask", tune=False,
                        device="cpu", cb=16)
    launch = S.whole_launches(plan)
    threads = K.whole_threads(16, 4, plan.vmax)
    for key, stages in (("s1", 1), ("s2", 2)):
        assert launch[key] == dict(
            stages=stages, threads=threads, tile_rows=K.WHOLE_TILE_ROWS,
            smem_bytes=K.whole_smem_bytes(stages, 16, plan.vmax,
                                          K.WHOLE_TILE_ROWS, threads))


# ----------------------------------------------------------------------------
# the wrappers (plain path on the CPU) against the reference's Pallas kernels
# ----------------------------------------------------------------------------

def _random(shape, density, seed):
    rng = np.random.default_rng(seed)
    return ((rng.random(shape) < density)
            * rng.standard_normal(shape)).astype(np.float32)


def _both(kernel, ch, x, nrows, ncols, chunk_row=None, **kw):
    """The port's wrapper on the CPU and the reference's Pallas kernel in
    interpret mode, on the same chunked arrays (``chunk_row`` in place of
    the chunked one where given)."""
    row = ch.chunk_row if chunk_row is None else chunk_row
    args = (ch.chunk_vbase, ch.chunk_col, ch.chunk_mask, ch.chunk_voff, row,
            ch.values)
    geom = dict(r=ch.r, c=ch.c, cb=ch.cb, vmax=ch.vmax, nrows=nrows,
                ncols=ncols)
    targs = [torch.from_numpy(np.ascontiguousarray(a)) for a in args]
    targs[2] = torch.from_numpy(np.ascontiguousarray(
        ch.chunk_mask).view(np.int32))
    y = getattr(K, kernel)(*targs, torch.from_numpy(x), **geom, **kw)
    y_ref = KERNELS[kernel](*(jnp.asarray(a) for a in args), jnp.asarray(x),
                            **geom, interpret=True)
    return y, np.asarray(y_ref)


def assert_close(y, y_ref):
    y_ref = np.asarray(y_ref)
    np.testing.assert_allclose(np.asarray(y), y_ref, rtol=RTOL,
                               atol=RTOL * max(float(np.abs(y_ref).max()),
                                               1e-30))


@pytest.mark.parametrize("kernel", sorted(KERNELS))
@pytest.mark.parametrize("rc", TF.SUPPORTED_BLOCKS)
def test_wrapper_matches_pallas(rc, kernel):
    """Every block shape, nrows % r != 0 and padding blocks; the kernels'
    own ``grid`` argument passes through the CPU path."""
    d = _random((301, 259), 0.08, 1 + 3 * rc[0] + rc[1])
    ch = TF.to_chunked(TF.csr_to_spc5(TF.csr_from_dense(d), *rc), cb=12)
    assert not ch.chunk_mask[-1].all()
    x = np.random.default_rng(5).standard_normal(259).astype(np.float32)
    y, y_ref = _both(kernel, ch, x, 301, 259, grid=1)
    assert y.shape == (301,) and y.dtype == torch.float32
    assert_close(y, y_ref)
    assert_close(y, d.astype(np.float64) @ x.astype(np.float64))


def _permuted(rc, seed):
    """Chunked arrays of a 304 x 259 matrix (nrows % r == 0) whose block
    rows are permuted by hand: chunk_row takes block row p(i) for block row
    i, so a chunk's rows jump about and neighbouring chunks no longer meet;
    returns them, the new chunk_row and the permuted dense matrix."""
    r, _ = rc
    d = _random((304, 259), 0.08, seed)
    ch = TF.to_chunked(TF.csr_to_spc5(TF.csr_from_dense(d), *rc), cb=8)
    perm = np.random.default_rng(seed).permutation(304 // r)
    real = ch.chunk_mask != 0
    row = np.where(real, perm[ch.chunk_row // r] * r, 0).astype(np.int32)
    moved = np.zeros_like(d)
    for i, p in enumerate(perm):
        moved[p * r:(p + 1) * r] = d[i * r:(i + 1) * r]
    return ch, row, moved


@pytest.mark.parametrize("kernel", sorted(KERNELS))
@pytest.mark.parametrize("rc", [(1, 8), (2, 4), (4, 4), (4, 8), (8, 4)])
def test_permuted_block_rows_match_pallas(rc, kernel):
    ch, row, moved = _permuted(rc, seed=7 + rc[0])
    first = row[:, 0][ch.chunk_mask[:, 0] != 0]
    assert (np.diff(first.astype(np.int64)) < 0).any()     # not monotone
    x = np.random.default_rng(6).standard_normal(259).astype(np.float32)
    y, y_ref = _both(kernel, ch, x, 304, 259, chunk_row=row, grid=2)
    assert_close(y, y_ref)
    assert_close(y, moved.astype(np.float64) @ x.astype(np.float64))


@pytest.mark.parametrize("kernel", sorted(KERNELS))
@pytest.mark.parametrize("case", ["one_chunk", "cb6", "empty"])
def test_edge_geometries_match_pallas(case, kernel):
    """One chunk holding every block (and padding), cb = 6 (metadata rows
    that are not whole 16-byte pieces) and a matrix with no nonzero."""
    rc = (2, 4) if case == "cb6" else (4, 8)
    d = _random((45, 37), 0.2, 9)
    if case == "empty":
        d[:] = 0.0
    ch = TF.to_chunked(TF.csr_to_spc5(TF.csr_from_dense(d), *rc),
                       cb={"one_chunk": 256, "cb6": 6, "empty": 16}[case])
    assert (ch.nchunks == 1) == (case != "cb6")
    x = np.random.default_rng(8).standard_normal(37).astype(np.float32)
    y, y_ref = _both(kernel, ch, x, 45, 37)
    assert_close(y, y_ref)
    assert_close(y, d.astype(np.float64) @ x.astype(np.float64))


@pytest.mark.parametrize("double_buffer", [True, False])
def test_plan_path_matches_pallas(double_buffer):
    """``ops.spmv`` on a whole-vector mask plan reaches the wrapper of its
    buffering and gives the reference kernel's y."""
    d = _random((130, 90), 0.1, 11)
    mat = TF.csr_to_spc5(TF.csr_from_dense(d), 4, 8)
    plan = tops.prepare(mat, layout="whole_vector", lowering="mask",
                        tune=False, device="cpu", cb=16)
    x = np.random.default_rng(12).standard_normal(90).astype(np.float32)
    y = tops.spmv(plan, torch.from_numpy(x), double_buffer=double_buffer)
    kernel = "spmv_cuda_db" if double_buffer else "spmv_cuda"
    _, y_ref = _both(kernel, TF.to_chunked(mat, cb=16), x, 130, 90)
    assert_close(y, y_ref)
