"""The port's balanced row partitioning (``repro_torch.core.partition``)
against the JAX package's (``repro.core.partition``), on the host.

The same matrix goes through both packages' converters and partitioners:
every boundary, per-part count and skew must be equal, and every part
byte-equal (its arrays and shape). The properties of
``tests/test_partition.py`` are held on the port's parts too.
"""
import numpy as np
import pytest

from repro._compat.hypothesis import given, settings, strategies as st
from repro.core import formats as JF
from repro.core import matgen as JM
from repro.core import partition as JP
from repro_torch.core import formats as TF
from repro_torch.core import matgen as TM
from repro_torch.core import partition as TP

MATRICES = {
    "banded": (lambda M: M.banded(1000, 6, 0.9, seed=1), (2, 4)),
    "fem": (lambda M: M.fem_blocks(2000, 4, 8, seed=2), (4, 4)),
    "powerlaw": (lambda M: M.powerlaw(800, 6, seed=3), (1, 8)),
    "uniform": (lambda M: M.uniform_random(500, 5, seed=4), (2, 8)),
}


def _pair(name):
    make, rc = MATRICES[name]
    return (JF.csr_to_spc5(make(JM), *rc), TF.csr_to_spc5(make(TM), *rc))


def _spc5_to_dense(mat):
    rows, cols, vals = TF.spc5_to_coo(mat)
    d = np.zeros(mat.shape)
    np.add.at(d, (rows, cols), vals)
    return d


FIELDS = ("block_rowptr", "block_colidx", "block_masks", "block_voffset",
          "values")


@pytest.mark.parametrize("mode", JP.PARTITION_MODES)
@pytest.mark.parametrize("nparts", [1, 2, 7, 13])
@pytest.mark.parametrize("name", sorted(MATRICES))
def test_partition_matches_reference(name, nparts, mode):
    jmat, tmat = _pair(name)
    assert TP.PARTITION_MODES == JP.PARTITION_MODES
    ivs = TP.partition_intervals(tmat, nparts, mode)
    assert ivs == JP.partition_intervals(jmat, nparts, mode)
    assert np.array_equal(TP.interval_nnz(tmat), JP.interval_nnz(jmat))
    assert np.array_equal(TP.part_nnz(tmat, ivs), JP.part_nnz(jmat, ivs))
    assert TP.nnz_skew(tmat, nparts, mode) == JP.nnz_skew(jmat, nparts, mode)
    assert np.array_equal(TP.partition_row_starts(tmat, nparts, mode),
                          JP.partition_row_starts(jmat, nparts, mode))
    tparts = TP.partition_matrix(tmat, nparts, mode)
    jparts = JP.partition_matrix(jmat, nparts, mode)
    assert len(tparts) == len(jparts) == nparts
    for t, j in zip(tparts, jparts):
        assert (t.shape, t.r, t.c) == (j.shape, j.r, j.c)
        for f in FIELDS:
            a, b = getattr(t, f), getattr(j, f)
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), f
    # the parts cover the matrix disjointly (tests/test_partition.py)
    starts = TP.partition_row_starts(tmat, nparts, mode)
    dense = np.zeros(tmat.shape)
    for p, r0 in zip(tparts, starts):
        dense[r0:r0 + p.shape[0]] += _spc5_to_dense(p)[:tmat.nrows - r0]
    np.testing.assert_array_equal(dense, _spc5_to_dense(tmat))
    assert sum(p.nnz for p in tparts) == tmat.nnz


def test_block_balance_within_one_interval():
    """The paper's greedy split: every part within one row interval of the
    ideal block count (tests/test_partition.py::test_partition_balance)."""
    _, mat = _pair("fem")
    nparts = 13
    counts = [p.nblocks for p in TP.partition_matrix(mat, nparts)]
    ideal = mat.nblocks / nparts
    worst = np.diff(mat.block_rowptr).max()
    assert all(abs(c - ideal) <= worst + 1 for c in counts)


def test_nnz_mode_balances_a_skewed_matrix_as_the_reference():
    jmat, tmat = _pair("powerlaw")
    assert (TP.nnz_skew(tmat, 8, "nnz") == JP.nnz_skew(jmat, 8, "nnz")
            <= TP.nnz_skew(tmat, 8, "blocks"))


def test_unknown_mode_raises_like_the_reference():
    jmat, tmat = _pair("banded")
    for P, mat in ((JP, jmat), (TP, tmat)):
        with pytest.raises(ValueError, match="unknown partition mode"):
            P.partition_intervals(mat, 4, "rows")


@settings(max_examples=30, deadline=None)
@given(nint=st.integers(1, 60), nparts=st.integers(1, 16),
       seed=st.integers(0, 10_000))
def test_property_bounds_match_reference(nint, nparts, seed):
    rng = np.random.default_rng(seed)
    counts = rng.integers(0, 9, size=nint)
    rowptr = np.concatenate([[0], np.cumsum(counts)])
    ivs = TP.block_balanced_intervals(rowptr, nparts)
    assert ivs == JP.block_balanced_intervals(rowptr, nparts)
    assert TP.balanced_bounds(rowptr, nparts) == JP.balanced_bounds(rowptr,
                                                                    nparts)
    assert len(ivs) == nparts
    assert ivs[0][0] == 0 and ivs[-1][1] == nint
    for (a0, a1), (b0, b1) in zip(ivs, ivs[1:]):
        assert a1 == b0 and a0 <= a1
