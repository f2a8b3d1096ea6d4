"""The port's distributed SpMV on 8 gloo ranks on the CPU: the mirrors of
``tests/test_distributed.py``'s SPC5 tests and of
``tests/test_reorder.py::test_distributed_reorder_roundtrip``.

The 8 ranks are spawned once for the file (``torch.multiprocessing``, a
``FileStore`` under the test's temporary directory, one torch thread a
rank). Each rank builds its own shard (``shard_matrix(..., device="cpu",
rank=rank)``), runs ``make_distributed_spmv`` and saves what it got; the
tests hold each rank's y, gathered and as slabs, within ``1e-5 * max|y|``
of the float64 product.
"""
import os

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro_torch.core import distributed as D
from repro_torch.core import formats as F
from repro_torch.core import matgen
from repro_torch.core import partition as PT

NDEV = 8
TOL = 1e-5


def _gathered(mat, x, **kw):
    """The gathered y of ``shard_matrix(mat, NDEV, **kw)``."""
    sh = D.shard_matrix(mat, NDEV, device="cpu", rank=dist.get_rank(), **kw)
    return sh, D.make_distributed_spmv(sh)(torch.from_numpy(x)).numpy()


def _scenarios(out):
    """Every case, run the same way on every rank; ``out`` collects the
    arrays to save."""
    rank = dist.get_rank()
    csr = matgen.banded(1200, 6, 0.8, seed=3)
    x = np.random.default_rng(0).standard_normal(1200).astype(np.float32)
    for rc in ((1, 8), (4, 4)):
        _, out[f"allclose_{rc[0]}x{rc[1]}"] = _gathered(
            F.csr_to_spc5(csr, *rc), x, cb=64)

    # gather=False: each rank's (1, rows_max) slab, with the row starts
    csr = matgen.fem_blocks(640, 4, 5, seed=4)
    sh = D.shard_matrix(F.csr_to_spc5(csr, 2, 4), NDEV, cb=32, device="cpu",
                        rank=rank)
    x = np.random.default_rng(1).standard_normal(sh.ncols).astype(np.float32)
    out["slab"] = D.make_distributed_spmv(sh, gather=False)(
        torch.from_numpy(x)).numpy()
    out["slab_row_start"] = sh.row_start.numpy()
    out["slab_rows_max"] = np.asarray(sh.rows_max)
    out["slab_shape"] = np.asarray(sh.arrays[0].shape)

    csr = matgen.banded(1024, 6, 0.7, seed=5)
    mat = F.csr_to_spc5(csr, 1, 8)
    x = np.random.default_rng(0).standard_normal(1024).astype(np.float32)
    for layout, kw in (("whole_vector", dict(cb=64)),
                       ("panels", dict(pr=256, cb=32))):
        for lowering in ("mask", "descriptor"):
            sh, y = _gathered(mat, x, layout=layout, lowering=lowering,
                              **kw)
            out[f"lowering_{layout}_{lowering}"] = y
            entry = [e for e in sh.trace if e.get("pass") == "lowering"][0]
            out[f"lowering_{layout}_{lowering}_ok"] = np.asarray(
                entry["lowering"] == lowering
                and entry["reason"] == "requested"
                and not any(k.endswith("demoted") for e in sh.trace
                            for k in e))
    # the whole stack in every rank's process, each rank taking its shard
    sh = D.shard_matrix(mat, NDEV, cb=64, device="cpu")
    out["whole_stack"] = D.make_distributed_spmv(sh)(
        torch.from_numpy(x)).numpy()

    csr = matgen.powerlaw(1536, 12, alpha=1.6, seed=2)
    mat = F.csr_to_spc5(csr, 1, 8)
    x = np.random.default_rng(3).standard_normal(1536).astype(np.float32)
    for mode in ("blocks", "nnz"):
        sh, out[f"partition_{mode}"] = _gathered(
            mat, x, cb=64, lowering="mask", partition=mode)
        part = [e for e in sh.trace if e.get("pass") == "partition"][0]
        out[f"partition_{mode}_ok"] = np.asarray(part["mode"] == mode)

    csr = matgen.scrambled_banded(192, 5, 1.0, seed=15)
    mat = F.csr_to_spc5(csr, 1, 8)
    x = np.random.default_rng(6).standard_normal(192).astype(np.float32)
    for pr in (None, 16):
        sh = D.shard_matrix(mat, NDEV, pr=pr, xw=32, cb=8, reorder="rcm",
                            tune=False, device="cpu", rank=rank)
        key = f"reorder_{pr or 0}"
        out[f"{key}_ok"] = np.asarray(sh.reorder == "rcm"
                                      and sh.col_perm is not None)
        out[key] = D.make_distributed_spmv(sh)(torch.from_numpy(x)).numpy()
        out[f"{key}_slab"] = D.make_distributed_spmv(sh, gather=False)(
            torch.from_numpy(x)).numpy()
        out[f"{key}_row_start"] = sh.row_start.numpy()
        out[f"{key}_row_iperm"] = sh.row_iperm.numpy()
    sh0 = D.shard_matrix(mat, NDEV, tune=False, device="cpu", rank=rank)
    out["reorder_none_ok"] = np.asarray(sh0.col_perm is None
                                        and sh0.reorder == "")


def _rank_main(rank, init, out_dir):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=init, rank=rank,
                            world_size=NDEV)
    try:
        out = {}
        _scenarios(out)
        np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **out)
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """The saved arrays of every rank, one dict a rank."""
    tmp = tmp_path_factory.mktemp("gloo")
    init = f"file://{tmp / 'store'}"
    mp.spawn(_rank_main, args=(init, str(tmp)), nprocs=NDEV, join=True)
    return [dict(np.load(tmp / f"rank{k}.npz")) for k in range(NDEV)]


def assert_close(y, csr, x):
    y64 = csr.to_dense().astype(np.float64) @ x.astype(np.float64)
    np.testing.assert_allclose(y, y64, rtol=0,
                               atol=TOL * float(np.abs(y64).max()))


@pytest.mark.parametrize("rc", ["1x8", "4x4"])
def test_distributed_spmv_allclose(ranks, rc):
    csr = matgen.banded(1200, 6, 0.8, seed=3)
    x = np.random.default_rng(0).standard_normal(1200).astype(np.float32)
    for out in ranks:
        assert_close(out[f"allclose_{rc}"], csr, x)


def test_distributed_spmv_sharded_output(ranks):
    """gather=False: each rank holds its own (1, rows_max) slab and only
    its shard's tensors; the slabs added in at their row starts give y."""
    csr = matgen.fem_blocks(640, 4, 5, seed=4)
    x = np.random.default_rng(1).standard_normal(
        csr.shape[1]).astype(np.float32)
    rows_max = int(ranks[0]["slab_rows_max"])
    starts = ranks[0]["slab_row_start"]
    assert starts.shape == (NDEV,)
    y = np.zeros(csr.shape[0] + rows_max)
    for k, out in enumerate(ranks):
        assert out["slab"].shape == (1, rows_max)
        assert out["slab_shape"][0] == 1          # its own shard only
        y[starts[k]:starts[k] + rows_max] += out["slab"][0]
    assert_close(y[:csr.shape[0]], csr, x)


@pytest.mark.parametrize("layout", ["whole_vector", "panels"])
@pytest.mark.parametrize("lowering", ["mask", "descriptor"])
def test_tuned_lowerings_survive_workers(ranks, layout, lowering):
    csr = matgen.banded(1024, 6, 0.7, seed=5)
    x = np.random.default_rng(0).standard_normal(1024).astype(np.float32)
    for out in ranks:
        assert out[f"lowering_{layout}_{lowering}_ok"]
        assert_close(out[f"lowering_{layout}_{lowering}"], csr, x)


def test_every_rank_may_hold_the_whole_stack(ranks):
    """A plan of every shard in each rank's process: each rank runs its
    own shard (``ShardedPlan.local``)."""
    csr = matgen.banded(1024, 6, 0.7, seed=5)
    x = np.random.default_rng(0).standard_normal(1024).astype(np.float32)
    for out in ranks:
        assert_close(out["whole_stack"], csr, x)


def test_nnz_balanced_partition_on_devices(ranks):
    csr = matgen.powerlaw(1536, 12, alpha=1.6, seed=2)
    x = np.random.default_rng(3).standard_normal(1536).astype(np.float32)
    mat = F.csr_to_spc5(csr, 1, 8)
    for mode in ("blocks", "nnz"):
        for out in ranks:
            assert out[f"partition_{mode}_ok"]
            assert_close(out[f"partition_{mode}"], csr, x)
    assert PT.nnz_skew(mat, NDEV, "nnz") <= PT.nnz_skew(mat, NDEV, "blocks")


@pytest.mark.parametrize("pr", [0, 16])
def test_distributed_reorder_roundtrip(ranks, pr):
    """A reordered plan: the gathered y in the original row order, each
    rank's gather=False slab in the permuted row order."""
    csr = matgen.scrambled_banded(192, 5, 1.0, seed=15)
    x = np.random.default_rng(6).standard_normal(192).astype(np.float32)
    key = f"reorder_{pr}"
    for out in ranks:
        assert out[f"{key}_ok"] and out["reorder_none_ok"]
        assert_close(out[key], csr, x)
    starts = ranks[0][f"{key}_row_start"]
    rows_max = ranks[0][f"{key}_slab"].shape[1]
    yp = np.zeros(192 + rows_max)
    for k, out in enumerate(ranks):
        yp[starts[k]:starts[k] + rows_max] += out[f"{key}_slab"][0]
    assert_close(yp[:192][ranks[0][f"{key}_row_iperm"]], csr, x)
