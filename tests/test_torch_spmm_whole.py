"""The whole-vector SpMM pair's host side, against the JAX package.

``spmm_cuda`` (mask) and ``spmm_cuda_desc`` (descriptor) share one kernel
skeleton (``csrc/spc5_spmm_whole.cuh``) and one launch planning
(``spc5_spmm.whole_plan`` / ``whole_grid``):

* the shared-memory formulas (``spc5_spmm.whole_smem_bytes``,
  ``spc5_spmm_desc.whole_smem_bytes``) against a copy written out here;
* the launch plans with the card's occupancy faked, on the token plan's
  geometry (25,856 chunks of cb 256, vmax 1,144, beta(4,8), int16 vidx and
  xcol) at nvec 1, 3, 4, 16, 128 and 256, on FEM's beta(4,4) chunks, on
  beta(1,8) / (2,4) / (8,4), with a misaligned X, and ``grid=``;
* the wrappers on the CPU (the plain version; ``grid`` is the card's knob)
  against the reference's ``spmm_pallas`` / ``spmm_pallas_desc`` in
  interpret mode, on the plan's block order, on chunks whose blocks are
  shuffled, on permuted block rows, on repeated block rows and on chunks
  spanning more rows than a Y tile holds (``rtol=1e-5``, ``atol=1e-5 *
  max|Y_ref|``: the f32 sums of a row are taken in another order).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import formats as JF
from repro.kernels import spc5_spmm as JK
from repro_torch.core import formats as TF
from repro_torch.kernels import spc5_spmm as KM
from repro_torch.kernels import spc5_spmm_desc as KDM
from repro_torch.kernels import spc5_spmv as K

RTOL = 1e-5


def _r16(n):
    return -(-n // 16) * 16


def assert_close(y, y_ref):
    y_ref = np.asarray(y_ref)
    np.testing.assert_allclose(np.asarray(y), y_ref, rtol=RTOL,
                               atol=RTOL * max(float(np.abs(y_ref).max()),
                                               1e-30))


# ----------------------------------------------------------------------------
# shared memory
# ----------------------------------------------------------------------------

def _layout(stage, stages, q, nb, r, c, vmax, tw, vec, rows, threads):
    """The CTA as the kernel lays it out: Y tile, two slots of tw floats and
    a 16-byte header a lane group, two scan areas of 16 x 8 words, the list
    (16 bytes an entry, room for the most kept lanes of a round), the
    ring."""
    groups = threads // (tw // vec)
    room = min(q * vmax, nb * r * c)
    return (_r16(4 * rows * tw) + _r16(2 * groups * tw * 4) + 16 * groups
            + 2 * 16 * 8 * 4 + 16 * room + stages * stage)


#: (stages, q, nb, r, c, vmax, tw, vec, tile rows, threads)
SMEM_CASES = [
    (2, 1, 256, 4, 8, 1144, 128, 4, 16, 512),
    (2, 2, 512, 4, 8, 1144, 128, 4, 32, 512),
    (2, 2, 512, 4, 8, 1144, 16, 4, 64, 256),
    (1, 1, 128, 4, 4, 4096, 16, 4, 64, 256),
    (1, 1, 40, 4, 8, 40960, 16, 4, 16, 256),
    (2, 4, 64, 2, 4, 100, 4, 1, 16, 256),
    (2, 3, 48, 1, 8, 40, 1, 1, 64, 32),
    (1, 1, 5, 8, 4, 400, 64, 2, 16, 512),
]


@pytest.mark.parametrize("case", SMEM_CASES)
def test_mask_smem_formula(case):
    """A stage of the mask kernel: q value windows, four metadata rows of nb
    words and a 16-byte mbarrier slot, each part 16-byte aligned."""
    stages, q, nb, r, c, vmax, tw, vec, rows, threads = case
    stage = q * _r16(4 * vmax) + 4 * _r16(4 * nb) + 16
    assert KM.whole_smem_bytes(stages, q, nb, r, c, vmax, tw, vec, rows,
                               threads) == _layout(stage, *case[:7],
                                                   vec, rows, threads)


@pytest.mark.parametrize("widths", [(1, 1), (2, 2), (4, 4), (2, 4)])
@pytest.mark.parametrize("case", SMEM_CASES)
def test_desc_smem_formula(case, widths):
    """A stage of the descriptor kernel: q value windows, the valid and vidx
    runs of nb blocks, c xcol entries and a 4-byte yrow slot a block, and a
    16-byte mbarrier slot, each part 16-byte aligned."""
    stages, q, nb, r, c, vmax, tw, vec, rows, threads = case
    wv, wx = widths
    rc = r * c
    stage = (q * _r16(4 * vmax) + _r16(nb * rc) + _r16(nb * rc * wv)
             + _r16(nb * c * wx) + _r16(4 * nb) + 16)
    assert KDM.whole_smem_bytes(stages, q, nb, r, c, vmax, wv, wx, tw, vec,
                                rows, threads) == _layout(
        stage, *case[:7], vec, rows, threads)


def test_token_plan_smem_figures():
    """The token plan's CTAs as reckoned in PERF.md's prediction: the mask
    kernel's (ring of two rounds of two chunks) and the descriptor
    kernel's (ring of two rounds of one chunk) at nvec 16 and 128."""
    assert KM.whole_smem_bytes(2, 2, 512, 4, 8, 1144, 16, 4, 64, 256) == 85_664
    assert KM.whole_smem_bytes(2, 2, 512, 4, 8, 1144, 128, 4, 32,
                               512) == 105_376
    assert KDM.whole_smem_bytes(2, 1, 256, 4, 8, 1144, 2, 2, 16, 4, 64,
                                256) == 101_216
    assert KDM.whole_smem_bytes(2, 1, 256, 4, 8, 1144, 2, 2, 128, 4, 16,
                                512) == 112_736


# ----------------------------------------------------------------------------
# launch plans
# ----------------------------------------------------------------------------

def _ctas_per_sm(smem, threads):
    """An H100 SM's CTAs by its 65,536 registers (64 a thread at most, as
    the kernels are built) and 228 KB of shared memory (1 KB of it reserved
    per CTA)."""
    return min(65_536 // (64 * threads), (228 * 1024) // (smem + 1024))


@pytest.fixture
def fake_card(monkeypatch):
    """Both kernels' occupancy as an H100 of 132 SMs would answer it."""
    def occ(r, c, vec, threads, smem, device):
        return _ctas_per_sm(smem, threads), 132
    monkeypatch.setattr(KM, "whole_occupancy", occ)
    monkeypatch.setattr(KDM, "whole_occupancy", occ)


#: (cb, r, c, vmax, nchunks, vidx width, xcol width): the token plan of
#: chip_smoke.py (64,000 x 4,096 at density 0.1 in beta(4,8)), FEM's
#: whole-vector plan (fem_blocks(200_000, 4, 12) in beta(4,4)) and plans of
#: the same weight in other block shapes, vmax and nchunks set by hand.
GEOMS = {
    "token": (256, 4, 8, 1144, 25_856, 2, 2),
    "fem": (256, 4, 4, 4096, 37_127, 2, 4),
    "beta18": (256, 1, 8, 320, 90_000, 2, 2),
    "beta24": (256, 2, 4, 280, 80_000, 2, 2),
    "beta84": (256, 8, 4, 1600, 20_000, 2, 2),
}


def _launch(lowering, case, nvec, vec=None, **kw):
    cb, r, c, vmax, nchunks, wv, wx = GEOMS[case]
    geom = dict(cb=cb, r=r, c=c, vmax=vmax, nvec=nvec,
                vec=KM.panels_vector(nvec) if vec is None else vec,
                device=torch.device("cpu"), **kw)
    if lowering == "mask":
        return KM.whole_launch(nchunks, **geom)
    return KDM.whole_launch(nchunks, wv=wv, wx=wx, **geom)


def _smem(lowering, case, launch):
    cb, r, c, vmax, _, wv, wx = GEOMS[case]
    args = (launch["stages"], launch["chunks_per_stage"],
            launch["blocks_per_stage"], r, c, vmax)
    tail = (launch["tile_columns"], launch["vector"], launch["tile_rows"],
            launch["threads"])
    if lowering == "mask":
        return KM.whole_smem_bytes(*args, *tail)
    return KDM.whole_smem_bytes(*args, wv, wx, *tail)


#: nvec -> (tile, columns a lane, threads)
SHAPES = {1: (1, 1, 256), 3: (4, 1, 256), 4: (4, 4, 256), 16: (16, 4, 256),
          128: (128, 4, 512), 256: (128, 4, 512)}


def _rounds(lowering, case, launch):
    """Every round of whole chunks the planner may take for the launch's
    tile and threads: (CTAs an SM, stages, chunks a round) of each that
    fits a CTA."""
    out = []
    cb = GEOMS[case][0]
    for stages in (KM.WHOLE_DB_STAGES, 1):
        for q in range(1, KM.WHOLE_STAGE_CHUNKS + 1):
            cand = dict(launch, stages=stages, chunks_per_stage=q,
                        blocks_per_stage=q * cb)
            n = _smem(lowering, case, cand)
            if n <= K.MAX_SMEM_BYTES:
                out.append((_ctas_per_sm(n, launch["threads"]), stages, q))
    return out


@pytest.mark.parametrize("nvec", sorted(SHAPES))
@pytest.mark.parametrize("lowering", ["mask", "descriptor"])
@pytest.mark.parametrize("case", sorted(GEOMS))
def test_launch_plans(fake_card, case, lowering, nvec):
    """The widest tile (at most 128 columns, 32 lanes of ``vec``), 512
    threads where a lane group is a whole warp, else 256, a Y tile of
    WHOLE_TILE_ROWS rows; of the rounds of whole chunks that fit a CTA, the
    one at which an SM holds the most CTAs, then a ring, then the most
    chunks a round; its figure is the formula's; G from the split rule over the column tiles,
    one contiguous range of chunks_per_cta chunks at most each."""
    cb, r, c, vmax, nchunks, wv, wx = GEOMS[case]
    launch = _launch(lowering, case, nvec)
    tw, vec, threads = SHAPES[nvec]
    assert (launch["tile_columns"], launch["vector"], launch["threads"]) == (
        tw, vec, threads)
    assert launch["lanes"] == tw // vec
    assert launch["ntiles"] == -(-nvec // tw)
    smem = launch["smem_bytes"]
    assert smem == _smem(lowering, case, launch) <= K.MAX_SMEM_BYTES
    assert launch["ctas_per_sm"] == _ctas_per_sm(smem, threads)
    assert launch["blocks_per_stage"] == launch["chunks_per_stage"] * cb
    assert launch["tile_rows"] == KM.WHOLE_TILE_ROWS
    chosen = (launch["ctas_per_sm"], launch["stages"],
              launch["chunks_per_stage"])
    assert chosen == max(_rounds(lowering, case, launch))
    assert launch["grid"] == K.panels_split(launch["ntiles"], nchunks,
                                            launch["ctas_per_sm"], 132)
    assert launch["chunks_per_cta"] == -(-nchunks // launch["grid"])


#: The token plan's launches at nvec 16 and 128: (ring, chunks a round,
#: Y-tile rows, CTAs an SM, grid, chunks a CTA).
TOKEN = {("mask", 16): (2, 1, 16, 4, 2_112, 13),
         ("mask", 128): (2, 2, 16, 2, 1_056, 25),
         ("descriptor", 16): (1, 1, 16, 3, 1_584, 17),
         ("descriptor", 128): (2, 1, 16, 2, 1_056, 25)}


@pytest.mark.parametrize("key", sorted(TOKEN))
def test_token_plan_launches(fake_card, key):
    """At nvec 16 (256 threads) the mask kernel's ring of one chunk a round
    lets an SM hold four CTAs, and the descriptor kernel's single stage
    three (its ring two); at nvec 128 (512 threads) registers cap an SM at
    two CTAs, which the rings of two and one chunks a round keep."""
    lowering, nvec = key
    launch = _launch(lowering, "token", nvec)
    assert (launch["stages"], launch["chunks_per_stage"],
            launch["tile_rows"], launch["ctas_per_sm"], launch["grid"],
            launch["chunks_per_cta"]) == TOKEN[key]


@pytest.mark.parametrize("ring", [True, False])
def test_ring_can_be_forced(fake_card, monkeypatch, ring):
    """``WHOLE_RING`` forces a ring (True) or one stage (False)."""
    monkeypatch.setattr(KM, "WHOLE_RING", ring)
    for lowering in ("mask", "descriptor"):
        for nvec in (16, 128):
            launch = _launch(lowering, "token", nvec)
            assert launch["stages"] == (KM.WHOLE_DB_STAGES if ring else 1)


def test_fem_plan_stages_one_chunk(fake_card):
    """FEM's dense beta(4,4) chunks (vmax 4,096: a 16 KB window and a list
    of up to 4,096 entries a chunk) leave no room for a ring at nvec 16:
    one stage of one chunk a round, two CTAs an SM."""
    for lowering in ("mask", "descriptor"):
        launch = _launch(lowering, "fem", 16)
        assert launch["stages"] == 1 and launch["chunks_per_stage"] == 1
        assert launch["ctas_per_sm"] == 2


@pytest.mark.parametrize("lowering", ["mask", "descriptor"])
@pytest.mark.parametrize("grid", [1, 2, 25_855, 25_856])
def test_grid_can_be_forced(fake_card, lowering, grid):
    launch = _launch(lowering, "token", 128, grid=grid)
    assert launch["grid"] == grid
    assert launch["chunks_per_cta"] == -(-25_856 // grid)


@pytest.mark.parametrize("lowering", ["mask", "descriptor"])
@pytest.mark.parametrize("grid", [0, -1, 25_857])
def test_grid_out_of_range_raises(fake_card, lowering, grid):
    with pytest.raises(ValueError, match="grid must be in"):
        _launch(lowering, "token", 16, grid=grid)


@pytest.mark.parametrize("lowering", ["mask", "descriptor"])
@pytest.mark.parametrize("offset,vec", [(4, 1), (8, 2)])
def test_misaligned_x(fake_card, lowering, offset, vec):
    """X 4 or 8 bytes past a 16-byte boundary at nvec 128: lanes of one or
    two columns, a tile of 32 lanes (32 or 64 columns), four or two column
    tiles, G over as many tiles."""
    buf = torch.zeros(4_096 * 128 + 4)
    x = buf[offset // 4:][:4_096 * 128].view(4_096, 128)
    launch = _launch(lowering, "token", 128, vec=KM.panels_vector(128, x))
    assert (launch["vector"], launch["tile_columns"], launch["lanes"]) == (
        vec, 32 * vec, 32)
    assert launch["ntiles"] == 128 // (32 * vec)
    assert launch["grid"] == K.panels_split(launch["ntiles"], 25_856,
                                            launch["ctas_per_sm"], 132)


def test_slices_and_refusals():
    """An int32 vidx window (vmax 40,960: 160 KB) fits one stage only as
    slices of a chunk's blocks; a window of 256 KB fits no CTA; a block
    shape without a kernel raises before any launch."""
    cta = KDM.whole_cta(cb=1_280, r=4, c=8, vmax=40_960, nvec=16, vec=4,
                        wv=4, wx=2)
    assert cta["stages"] == 1 and cta["chunks_per_stage"] == 1
    assert 1 <= cta["blocks_per_stage"] < 1_280
    assert cta["smem_bytes"] <= K.MAX_SMEM_BYTES
    with pytest.raises(ValueError, match="shared memory"):
        KM.whole_cta(cb=2_048, r=4, c=8, vmax=65_536, nvec=4, vec=4)
    for r, c in ((3, 8), (4, 2), (8, 8)):
        with pytest.raises(ValueError, match="no whole-vector SpMM kernel"):
            KM.whole_cta(cb=64, r=r, c=c, vmax=312, nvec=16, vec=4)


@pytest.mark.parametrize("knob,value,field", [
    ("WHOLE_THREADS", 128, "threads"), ("WHOLE_STAGE_CHUNKS", 1,
                                        "chunks_per_stage"),
    ("WHOLE_TILE", 32, "tile_columns"), ("WHOLE_TILE_ROWS", 64,
                                         "tile_rows")])
def test_knobs(monkeypatch, knob, value, field):
    monkeypatch.setattr(KM, knob, value)
    cta = KM.whole_cta(cb=256, r=4, c=8, vmax=1144, nvec=128, vec=4)
    assert cta[field] == value


# ----------------------------------------------------------------------------
# the wrappers on the CPU against the reference's Pallas kernels
# ----------------------------------------------------------------------------

def _random(shape, density, seed):
    rng = np.random.default_rng(seed)
    return ((rng.random(shape) < density)
            * rng.standard_normal(shape)).astype(np.float32)


#: order -> (shape, density, cb)
ORDERS = {"plan": ((136, 150), 0.12, 8), "shuffled": ((136, 150), 0.12, 8),
          "rows_permuted": ((136, 150), 0.12, 8),
          "repeated": ((136, 150), 0.12, 8),
          "tall": ((600, 40), 0.02, 64)}


def _chunked(rc, order, seed):
    """Byte-equal whole-vector chunked arrays of both packages (nrows a
    multiple of every r), then the metadata in ``order``: as built ("plan",
    and "tall": 600 x 40 at density 0.02 and cb 64, so a chunk spans far
    more rows than a Y tile holds), each chunk's blocks shuffled
    ("shuffled"), block rows permuted so a chunk's rows jump up and down
    ("rows_permuted"), or each block taking the row of its chunk's first or
    second block in turn ("repeated", which changes the product). Returns
    the port's chunked matrix, the four metadata arrays, and the dense
    matrix of the product they hold (None for "repeated")."""
    shape, density, cb = ORDERS[order]
    d = _random(shape, density, seed)
    tch = TF.to_chunked(TF.csr_to_spc5(TF.csr_from_dense(d), *rc), cb=cb)
    jch = JF.to_chunked(JF.csr_to_spc5(JF.csr_from_dense(d), *rc), cb=cb)
    for name in ("values", "chunk_col", "chunk_mask", "chunk_voff",
                 "chunk_row", "chunk_vbase"):
        assert np.asarray(getattr(tch, name)).tobytes() == np.asarray(
            getattr(jch, name)).tobytes()
    meta = [tch.chunk_col, tch.chunk_mask, tch.chunk_voff, tch.chunk_row]
    r = rc[0]
    if order == "shuffled":
        pick = np.random.default_rng(3).permutation(cb)
        meta = [np.ascontiguousarray(t[:, pick]) for t in meta]
    elif order == "rows_permuted":
        perm = np.random.default_rng(seed).permutation(shape[0] // r)
        real = tch.chunk_mask != 0
        meta[3] = np.where(real, perm[tch.chunk_row // r] * r,
                           0).astype(np.int32)
        moved = np.zeros_like(d)
        for i, p in enumerate(perm):
            moved[p * r:(p + 1) * r] = d[i * r:(i + 1) * r]
        d = moved
    elif order == "repeated":
        pick = np.arange(cb) % 2
        meta[3] = np.ascontiguousarray(tch.chunk_row[:, pick])
        d = None
    return tch, meta, d


def _x(ncols, nvec, seed):
    return np.random.default_rng(seed).standard_normal(
        (ncols, nvec)).astype(np.float32)


@pytest.mark.parametrize("order", sorted(ORDERS))
@pytest.mark.parametrize("rc", TF.SUPPORTED_BLOCKS)
def test_mask_wrapper_on_the_cpu_matches_pallas(rc, order):
    """``spmm_cuda`` on the CPU (at ``grid=3``, which changes nothing there)
    against ``spmm_pallas`` in interpret mode on the same arrays at nvec 4,
    and against the f64 product of the matrix they hold."""
    ch, meta, d = _chunked(rc, order, 10 * rc[0] + rc[1])
    nrows, ncols = ch.nrows, ch.ncols
    x = _x(ncols, 4, rc[1])
    kw = dict(r=rc[0], c=rc[1], cb=ch.cb, vmax=ch.vmax, nrows=nrows,
              ncols=ncols)
    mask = [m.view(np.int32) if m.dtype == np.uint32 else m for m in meta]
    y = KM.spmm_cuda(torch.from_numpy(ch.chunk_vbase),
                     *(torch.from_numpy(np.ascontiguousarray(m))
                       for m in mask),
                     torch.from_numpy(ch.values), torch.from_numpy(x),
                     grid=3, **kw)
    y_pal = JK.spmm_pallas(jnp.asarray(ch.chunk_vbase),
                           *(jnp.asarray(m) for m in meta),
                           jnp.asarray(ch.values), jnp.asarray(x),
                           interpret=True, **kw)
    assert y.shape == (nrows, 4) and y.dtype == torch.float32
    assert_close(y, y_pal)
    if d is not None:
        assert_close(y, d.astype(np.float64) @ x.astype(np.float64))


def _tables(ch, meta):
    d = TF.chunk_descriptors(meta[1], meta[2], meta[0], meta[3], r=ch.r,
                             c=ch.c, vmax=ch.vmax, xmax=ch.ncols,
                             ymax=ch.nrows)
    return [np.ascontiguousarray(t) for t in (d.valid, d.vidx, d.xcol,
                                              d.yrow)]


@pytest.mark.parametrize("order", sorted(ORDERS))
@pytest.mark.parametrize("rc", TF.SUPPORTED_BLOCKS)
def test_desc_wrapper_on_the_cpu_matches_pallas(rc, order):
    """``spmm_cuda_desc`` on the CPU against ``spmm_pallas_desc`` in
    interpret mode on the tables ``chunk_descriptors`` builds from the same
    (reordered) metadata, at nvec 4, and against the f64 product."""
    ch, meta, d = _chunked(rc, order, 10 * rc[0] + rc[1] + 1)
    nrows, ncols = ch.nrows, ch.ncols
    tables = _tables(ch, meta)
    x = _x(ncols, 4, rc[0])
    kw = dict(r=rc[0], c=rc[1], cb=ch.cb, vmax=ch.vmax, nrows=nrows,
              ncols=ncols)
    y = KDM.spmm_cuda_desc(torch.from_numpy(ch.chunk_vbase),
                           *(torch.from_numpy(t) for t in tables),
                           torch.from_numpy(ch.values), torch.from_numpy(x),
                           grid=3, **kw)
    y_pal = JK.spmm_pallas_desc(jnp.asarray(ch.chunk_vbase),
                                *(jnp.asarray(t) for t in tables),
                                jnp.asarray(ch.values), jnp.asarray(x),
                                interpret=True, **kw)
    assert y.shape == (nrows, 4) and y.dtype == torch.float32
    assert_close(y, y_pal)
    if d is not None:
        assert_close(y, d.astype(np.float64) @ x.astype(np.float64))


@pytest.mark.parametrize("kernel", ["spmm_cuda", "spmm_cuda_desc"])
@pytest.mark.parametrize("nvec,nvt", [(1, 128), (3, 128), (8, 4)])
def test_wrappers_at_other_widths(kernel, nvec, nvt):
    """nvec 1 and 3 (one column a lane) and 8 in reference tiles of 4, on
    repeated block rows, against the Pallas kernel."""
    ch, meta, _ = _chunked((2, 4), "repeated", 5)
    x = _x(ch.ncols, nvec, nvec)
    kw = dict(r=2, c=4, cb=ch.cb, vmax=ch.vmax, nrows=ch.nrows,
              ncols=ch.ncols, nvt=nvt)
    if kernel == "spmm_cuda":
        arrays = [m.view(np.int32) if m.dtype == np.uint32 else m
                  for m in meta]
        ref = JK.spmm_pallas(jnp.asarray(ch.chunk_vbase),
                             *(jnp.asarray(m) for m in meta),
                             jnp.asarray(ch.values), jnp.asarray(x),
                             interpret=True, **kw)
        fn = KM.spmm_cuda
    else:
        arrays = _tables(ch, meta)
        ref = JK.spmm_pallas_desc(jnp.asarray(ch.chunk_vbase),
                                  *(jnp.asarray(t) for t in arrays),
                                  jnp.asarray(ch.values), jnp.asarray(x),
                                  interpret=True, **kw)
        fn = KDM.spmm_cuda_desc
    y = fn(torch.from_numpy(ch.chunk_vbase),
           *(torch.from_numpy(np.ascontiguousarray(a)) for a in arrays),
           torch.from_numpy(ch.values), torch.from_numpy(x), **kw)
    assert_close(y, ref)
