"""The port's host formats and generators against the JAX package's.

``repro_torch.core.formats`` and ``repro_torch.core.matgen`` are numpy
copies of ``repro.core.formats`` / ``repro.core.matgen``: from the same
inputs they must build the same bytes (dtype, shape and contents of every
array), for every supported block shape, including masks that use bit 31
(r*c = 32 for 4x8 and 8x4).
"""
import numpy as np
import pytest
import torch

from repro.core import formats as JF
from repro.core import matgen as JM
from repro_torch.core import formats as TF
from repro_torch.core import matgen as TM
from repro_torch.core import ref_spmv as TR

MATRICES = ("random", "fem")


def _dense(n=302, m=260, density=0.08, seed=0):
    rng = np.random.default_rng(seed)
    return ((rng.random((n, m)) < density)
            * rng.standard_normal((n, m))).astype(np.float32)


def _csr_pair(kind):
    """The same CSR built by each package (``random``: 302x260, so nrows %
    r != 0 for r in (4, 8); ``fem``: the SET_A bone010 class at 1,200 rows)."""
    if kind == "random":
        d = _dense()
        return JF.csr_from_dense(d), TF.csr_from_dense(d)
    return JM.fem_blocks(1_200, 4, 6, seed=3), TM.fem_blocks(1_200, 4, 6, seed=3)


def assert_same_bytes(a, b, fields):
    for f in fields:
        x, y = np.asarray(getattr(a, f)), np.asarray(getattr(b, f))
        assert x.dtype == y.dtype, (f, x.dtype, y.dtype)
        assert x.shape == y.shape, (f, x.shape, y.shape)
        assert x.tobytes() == y.tobytes(), f


CSR_FIELDS = ("rowptr", "colidx", "values")
SPC5_FIELDS = ("block_rowptr", "block_colidx", "block_masks",
               "block_voffset", "values")
CHUNK_FIELDS = ("chunk_col", "chunk_mask", "chunk_voff", "chunk_row",
                "chunk_vbase", "values")
PANEL_FIELDS = CHUNK_FIELDS + ("chunk_xbase",)


@pytest.mark.parametrize("kind", MATRICES)
def test_csr_builders_byte_equal(kind):
    a, b = _csr_pair(kind)
    assert a.shape == b.shape
    assert_same_bytes(a, b, CSR_FIELDS)


@pytest.mark.parametrize("kind", MATRICES)
@pytest.mark.parametrize("rc", TF.SUPPORTED_BLOCKS)
def test_csr_to_spc5_byte_equal(rc, kind):
    a, b = _csr_pair(kind)
    ja, tb = JF.csr_to_spc5(a, *rc), TF.csr_to_spc5(b, *rc)
    assert (ja.shape, ja.r, ja.c) == (tb.shape, tb.r, tb.c)
    assert_same_bytes(ja, tb, SPC5_FIELDS)


@pytest.mark.parametrize("kind", MATRICES)
@pytest.mark.parametrize("rc", TF.SUPPORTED_BLOCKS)
def test_to_chunked_byte_equal(rc, kind):
    a, b = _csr_pair(kind)
    ja = JF.to_chunked(JF.csr_to_spc5(a, *rc), cb=16)
    tb = TF.to_chunked(TF.csr_to_spc5(b, *rc), cb=16)
    assert ja.nchunks > 1
    for f in ("shape", "r", "c", "cb", "vmax", "nchunks", "nnz"):
        assert getattr(ja, f) == getattr(tb, f), f
    assert_same_bytes(ja, tb, CHUNK_FIELDS)


@pytest.mark.parametrize("kind", MATRICES)
@pytest.mark.parametrize("rc", TF.SUPPORTED_BLOCKS)
def test_to_panels_byte_equal(rc, kind):
    a, b = _csr_pair(kind)
    ja = JF.to_panels(JF.csr_to_spc5(a, *rc), pr=64, cb=16, xw=64)
    tb = TF.to_panels(TF.csr_to_spc5(b, *rc), pr=64, cb=16, xw=64)
    assert ja.npanels > 1 and ja.nchunks > 1
    for f in ("shape", "r", "c", "pr", "cb", "xw", "vmax", "npanels",
              "nchunks", "ncols_pad", "nnz"):
        assert getattr(ja, f) == getattr(tb, f), f
    assert_same_bytes(ja, tb, PANEL_FIELDS)


@pytest.mark.parametrize("rc", [(4, 8), (8, 4)])
def test_bit31_masks_survive_the_int32_view(rc):
    """Masks with bit 31 set become negative int32 on the device view, and
    ``(m >> k) & 1`` still reads every bit of the uint32 mask."""
    d = np.ones((16, 16), np.float32)
    ch = TF.to_chunked(TF.csr_to_spc5(TF.csr_from_dense(d), *rc), cb=4)
    assert (ch.chunk_mask >> np.uint32(31)).any()
    dev = TR.device_put(ch, "cpu")
    assert dev.chunk_mask.dtype == torch.int32
    assert dev.chunk_mask.numpy().tobytes() == ch.chunk_mask.tobytes()
    k = torch.arange(32, dtype=torch.int32)
    bits = ((dev.chunk_mask[..., None] >> k) & 1).numpy()
    want = ((ch.chunk_mask[..., None] >> np.arange(32, dtype=np.uint32))
            & np.uint32(1)).astype(np.int32)
    np.testing.assert_array_equal(bits, want)


def test_device_put_stores_float32_like_the_reference():
    """The generators' values are float64; both packages put float32 on the
    device (the reference through ``jnp.asarray`` without x64)."""
    csr = TM.fem_blocks(400, 4, 6, seed=1)
    assert csr.values.dtype == np.float64
    ch = TF.to_chunked(TF.csr_to_spc5(csr, 4, 4), cb=16)
    dev = TR.device_put(ch, "cpu")
    assert dev.values.dtype == torch.float32
    np.testing.assert_array_equal(dev.values.numpy(),
                                  ch.values.astype(np.float32))


@pytest.mark.parametrize("gen", [
    ("banded", (500, 6, 1.0)), ("scrambled_banded", (400, 5, 0.8)),
    ("fem_blocks", (600, 4, 8)), ("powerlaw", (500, 6, 1.8)),
    ("uniform_random", (400, 5)), ("dense", (40,)),
    ("pruned_weight", (64, 48, 0.2, (4, 4))),
])
def test_matgen_byte_equal(gen):
    name, args = gen
    a = getattr(JM, name)(*args, seed=7)
    b = getattr(TM, name)(*args, seed=7)
    assert a.shape == b.shape
    assert_same_bytes(a, b, CSR_FIELDS)


def test_matgen_sets_match():
    assert list(JM.SET_A) == list(TM.SET_A)
    assert list(JM.SET_B) == list(TM.SET_B)
    for name in ("Dense-800", "ns3Da"):
        assert_same_bytes(JM.SET_A[name](), TM.SET_A[name](), CSR_FIELDS)


def test_popcount_helpers_match():
    m = np.random.default_rng(4).integers(0, 2**32, size=(7, 33),
                                          dtype=np.uint64).astype(np.uint32)
    np.testing.assert_array_equal(JF.popcount_u32(m), TF.popcount_u32(m))
    np.testing.assert_array_equal(JF.exclusive_prefix_popcount(m),
                                  TF.exclusive_prefix_popcount(m))


@pytest.mark.parametrize("kind", ["random", "fem", "empty", "gaps", "dense"])
@pytest.mark.parametrize("rc", TF.SUPPORTED_BLOCKS)
def test_greedy_cover_matches_reference(rc, kind):
    """The port converts all r-row intervals at once; ``block_stats`` and
    ``csr_to_spc5`` must give the reference's per-interval loops' counts
    and bytes: on the random and FEM matrices, an empty one, one with empty
    row intervals and a short last interval, and a dense one (the longest
    covers)."""
    if kind in ("random", "fem"):
        jcsr, tcsr = _csr_pair(kind)
    else:
        d = {"empty": np.zeros((37, 29), np.float32),
             "gaps": _dense(101, 67, 0.3, seed=4),
             "dense": _dense(33, 517, 1.0, seed=5)}[kind]
        if kind == "gaps":
            d[8:40] = 0.0
        jcsr, tcsr = JF.csr_from_dense(d), TF.csr_from_dense(d)
    assert TF.block_stats(tcsr, *rc) == JF.block_stats(jcsr, *rc)
    tmat = TF.csr_to_spc5(tcsr, *rc)
    assert_same_bytes(JF.csr_to_spc5(jcsr, *rc), tmat, SPC5_FIELDS)
    assert TF.block_stats(tcsr, *rc)[0] == tmat.nblocks
