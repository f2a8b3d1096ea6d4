"""The column-map twins of the seven mask kernels, host side, on the CPU.

* Launch planning: a twin's launch is its kernel's plan (threads, stages,
  tile, shared memory: a twin stages nothing more) at the twin's own
  occupancy. ``whole_launch`` / ``panels_launch`` of ``spc5_spmv`` and
  ``spc5_spmm`` with ``mapped=True`` are checked with the card faked (one
  answer for the twins, another for their kernels, so a launch that asks
  the wrong one shows) on the geometries ``chip_smoke.py`` runs: the vocab
  layer's mask plans, FEM's, and a reordered band of the smoke's class
  (``scrambled_banded`` after RCM, in beta(1,8)); every shared-memory
  figure is held against a copy of the C layouts.
* No module of the port refuses a map on the card any more.
* The mapped panel SpMV wrapper hands x to its twin as it is
  (``panel_x``): on reordered mask plans every set lane's permuted column
  lies below ncols, so the twin reads the map and x in bounds, and every
  lane at or past ncols is unset; the wrapper with the map on the CPU
  matches the reference's ``spmv_pallas_panels[_db]`` with ``col_map`` in
  interpret mode, whose ``pad_cmap`` pads the map with column 0 (it reads
  x[0] times a zero value there, the twin reads nothing).
"""
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import formats as JF
from repro.core import matgen as JM
from repro.kernels import ops as jops
from repro.kernels import spc5_spmv as JK
from repro_torch.core import formats as TF
from repro_torch.core import matgen as TM
from repro_torch.kernels import ops as tops
from repro_torch.kernels import spc5_spmm as KM
from repro_torch.kernels import spc5_spmv as K

RTOL = 1e-5
CPU = torch.device("cpu")
PORT = Path(__file__).resolve().parents[1] / "src" / "repro_torch"


def _r16(n):
    return -(-n // 16) * 16


def _window(vsize, vmax):
    """A copy of ``value_window`` (csrc/spc5_stage.cuh): a narrow window is
    staged as the 16-byte aligned span that covers it, 16 bytes more."""
    return _r16(vsize * vmax) + (16 if vsize < 4 else 0)


def _spmv_stage(cb, vmax, vsize):
    """A copy of csrc/spc5_spmv.cu's ``stage_layout``: the value window,
    four metadata rows of cb words and a 16-byte slot."""
    return _window(vsize, vmax) + 4 * _r16(4 * cb) + 16


def _spmm_panel_smem(stages, q, cb, vmax, prows, tw, vsize):
    """A copy of ``panel_layout`` (csrc/spc5_spmm_mask.cuh): the Y tile,
    per stage the q windows, their x window starts, (narrow) the windows'
    offsets and scales, four metadata rows of q cb words and the mbarrier
    slot, then the sort keys and the nonzero list."""
    nb = q * cb
    stage = (q * _window(vsize, vmax) + _r16(4 * q)
             + (_r16(8 * q) if vsize < 4 else 0) + 4 * _r16(4 * nb) + 16)
    return _r16(4 * prows * tw) + stages * stage + _r16(4 * nb) + 16 * q * vmax


def _spmm_whole_smem(launch, r, c, vmax, vsize):
    """A copy of ``whole_layout`` (csrc/spc5_spmm_whole.cuh) with
    ``MaskWhole``'s stage (csrc/spc5_spmm_mask.cuh)."""
    q, nb, tw = (launch["chunks_per_stage"], launch["blocks_per_stage"],
                 launch["tile_columns"])
    stage = (q * _window(vsize, vmax) + (_r16(8 * q) if vsize < 4 else 0)
             + 4 * _r16(4 * nb) + 16)
    groups = launch["threads"] // (tw // launch["vector"])
    room = min(q * vmax, nb * r * c)
    return (_r16(4 * launch["tile_rows"] * tw) + _r16(8 * groups * tw)
            + 16 * groups + 2 * 16 * 8 * 4 + 16 * room
            + launch["stages"] * stage)


# ----------------------------------------------------------------------------
# geometries
# ----------------------------------------------------------------------------

#: chip_smoke.py's mask plans (their logged geometry). Whole-vector: (cb,
#: r, c, vmax, nchunks); panels: (cb, r, c, vmax, pr, npanels, nchunks).
WHOLE = {"vocab": (256, 4, 8, 1_144, 25_856), "fem": (256, 4, 4, 4_096, 2_321)}
PANELS = {"vocab": (64, 4, 8, 312, 512, 125, 830),
          "fem": (64, 4, 4, 1_024, 512, 391, 25)}


@pytest.fixture(scope="module")
def band():
    """Mask plans of a reordered band of the smoke's class (scrambled_banded
    after RCM, beta(1,8); panels at pr 256, xw 512, cb 64, as the smoke
    builds them), cut to 20,000 rows: their geometries."""
    mat = TF.csr_to_spc5(TM.scrambled_banded(20_000, 8, 1.0, seed=42), 1, 8)
    plans = {layout: tops.prepare(mat, layout=layout, lowering="mask",
                                  tune=False, reorder="rcm", device="cpu",
                                  **({"pr": 256, "xw": 512, "cb": 64}
                                     if layout == "panels" else {}))
             for layout in ("panels", "whole_vector")}
    for plan in plans.values():
        assert plan.col_perm is not None
    return plans


def _geometry(kind, case, band):
    if case != "band":
        return (WHOLE if kind == "whole" else PANELS)[case]
    if kind == "whole":
        p = band["whole_vector"]
        return (p.cb, p.r, p.c, p.vmax, p.chunk_col.shape[0])
    p = band["panels"]
    return (p.cb, p.r, p.c, p.vmax, p.pr, p.npanels, p.nchunks)


def _ctas(smem, threads):
    """An H100 SM's CTAs by its 65,536 registers (64 a thread), 2,048
    threads and 228 KB of shared memory (1 KB reserved per CTA)."""
    return max(1, min(65_536 // (64 * threads), 2048 // threads,
                      (228 * 1024) // (smem + 1024)))


@pytest.fixture
def fake_card(monkeypatch):
    """Every mask kernel's occupancy as an H100 of 132 SMs would answer it,
    a twin's one CTA an SM fewer than its kernel's (down to one), so that
    the launch shows whose occupancy it asked for. Records each ask."""
    asked = []

    def spmv(stages, threads, smem, device, vsize=4, mapped=False):
        asked.append(mapped)
        return max(1, _ctas(smem, threads) - mapped), 132

    def spmm_panels(stages, c, vec, threads, smem, device, vsize=4,
                    mapped=False):
        asked.append(mapped)
        return max(1, _ctas(smem, threads) - mapped), 132

    def spmm_whole(r, c, vec, threads, smem, device, vsize=4, mapped=False):
        asked.append(mapped)
        return max(1, _ctas(smem, threads) - mapped), 132
    monkeypatch.setattr(K, "whole_occupancy", spmv)
    monkeypatch.setattr(K, "panels_occupancy", spmv)
    monkeypatch.setattr(KM, "panels_occupancy", spmm_panels)
    monkeypatch.setattr(KM, "whole_occupancy", spmm_whole)
    return asked


def _same_plan(twin, kernel, split_key):
    """Everything but the occupancy and the grid it decides is the same."""
    skip = {"ctas_per_sm", "grid", "chunks_per_cta", split_key}
    assert {k: v for k, v in twin.items() if k not in skip} == \
        {k: v for k, v in kernel.items() if k not in skip}
    assert twin["ctas_per_sm"] == max(1, kernel["ctas_per_sm"] - 1)


# ----------------------------------------------------------------------------
# launch planning
# ----------------------------------------------------------------------------

@pytest.mark.parametrize("vsize", [4, 2, 1])
@pytest.mark.parametrize("case", ["vocab", "fem", "band"])
def test_spmv_whole_twin_launch(fake_card, band, case, vsize):
    """``spmv_cuda[_db]``'s twin: its kernel's plan, G split at the twin's
    occupancy, the shared memory of the kernel's own layout."""
    cb, r, _, vmax, nchunks = _geometry("whole", case, band)
    for stages in (1, K.WHOLE_DB_STAGES):
        kw = dict(cb=cb, r=r, vmax=vmax, device=CPU, vsize=vsize)
        kernel = K.whole_launch(stages, nchunks, **kw)
        assert fake_card[-1] is False
        twin = K.whole_launch(stages, nchunks, mapped=True, **kw)
        assert fake_card[-1] is True
        _same_plan(twin, kernel, "grid")
        assert twin["grid"] == K.panels_split(1, nchunks, twin["ctas_per_sm"],
                                              132)
        warps = twin["threads"] // 32
        assert twin["smem_bytes"] == (
            _r16(4 * K.WHOLE_TILE_ROWS * warps)
            + twin["stages"] * _spmv_stage(cb, vmax, vsize))


@pytest.mark.parametrize("vsize", [4, 2, 1])
@pytest.mark.parametrize("case", ["vocab", "fem", "band"])
def test_spmv_panels_twin_launch(fake_card, band, case, vsize):
    """``spmv_cuda_panels[_db]``'s twin: its kernel's plan, S split at the
    twin's occupancy."""
    cb, r, _, vmax, pr, npanels, nchunks = _geometry("panels", case, band)
    for stages in (1, K.DB_STAGES):
        kw = dict(cb=cb, r=r, vmax=vmax, pr=pr, device=CPU, vsize=vsize)
        kernel = K.panels_launch(stages, npanels, nchunks, **kw)
        twin = K.panels_launch(stages, npanels, nchunks, mapped=True, **kw)
        assert fake_card[-2:] == [False, True]
        _same_plan(twin, kernel, "split")
        assert twin["split"] == K.panels_split(npanels, nchunks,
                                               twin["ctas_per_sm"], 132)
        assert twin["grid"] == npanels * twin["split"]
        assert twin["smem_bytes"] == (_r16(4 * pr) + twin["stages"]
                                      * _spmv_stage(cb, vmax, vsize))


@pytest.mark.parametrize("nvec", [3, 16, 128])
@pytest.mark.parametrize("vsize", [4, 2, 1])
@pytest.mark.parametrize("case", ["vocab", "fem", "band"])
def test_spmm_panels_twin_launch(fake_card, band, case, vsize, nvec):
    """``spmm_cuda_panels[_db]``'s twin: its kernel's CTA (tile, lanes,
    row parts, chunks a stage), S split at the twin's occupancy."""
    cb, r, c, vmax, pr, npanels, nchunks = _geometry("panels", case, band)
    for stages in (1, KM.PANEL_DB_STAGES):
        kw = dict(cb=cb, r=r, c=c, vmax=vmax, pr=pr, nvec=nvec,
                  vec=KM.panels_vector(nvec), device=CPU, vsize=vsize)
        kernel = KM.panels_launch(stages, npanels, nchunks, **kw)
        twin = KM.panels_launch(stages, npanels, nchunks, mapped=True, **kw)
        assert fake_card[-2:] == [False, True]
        _same_plan(twin, kernel, "split")
        units = npanels * twin["row_parts"] * twin["ntiles"]
        assert twin["split"] == K.panels_split(units, nchunks,
                                               twin["ctas_per_sm"], 132)
        assert twin["smem_bytes"] == _spmm_panel_smem(
            stages, twin["chunks_per_stage"], cb, vmax, twin["part_rows"],
            twin["tile_columns"], vsize)


@pytest.mark.parametrize("nvec", [3, 16, 128])
@pytest.mark.parametrize("vsize", [4, 2, 1])
@pytest.mark.parametrize("case", ["vocab", "fem", "band"])
def test_spmm_whole_twin_launch(fake_card, band, case, vsize, nvec):
    """``spmm_cuda``'s twin: its kernel's CTA (tile, ring, round, Y tile),
    G at the twin's occupancy."""
    cb, r, c, vmax, nchunks = _geometry("whole", case, band)
    kw = dict(cb=cb, r=r, c=c, vmax=vmax, nvec=nvec,
              vec=KM.panels_vector(nvec), device=CPU, vsize=vsize)
    kernel = KM.whole_launch(nchunks, **kw)
    twin = KM.whole_launch(nchunks, mapped=True, **kw)
    assert fake_card[-1] is True and False in fake_card
    _same_plan(twin, kernel, "grid")
    assert twin["grid"] == K.panels_split(twin["ntiles"], nchunks,
                                          twin["ctas_per_sm"], 132)
    assert twin["smem_bytes"] == _spmm_whole_smem(twin, r, c, vmax, vsize)


@pytest.mark.parametrize("layout", ["panels", "whole_vector"])
def test_forced_grids_take_the_twin(fake_card, band, layout):
    """A forced S or G is taken by a twin's launch as by its kernel's."""
    p = band[layout]
    n = int(p.chunk_vbase.shape[-1])
    for g in (1, n):
        if layout == "panels":
            twin = K.panels_launch(1, p.npanels, n, cb=p.cb, r=p.r,
                                   vmax=p.vmax, pr=p.pr, device=CPU, split=g,
                                   mapped=True)
            assert twin["split"] == g and twin["grid"] == p.npanels * g
        else:
            twin = K.whole_launch(1, n, cb=p.cb, r=p.r, vmax=p.vmax,
                                  device=CPU, grid=g, mapped=True)
            assert twin["grid"] == g
    assert set(fake_card) == {True}


# ----------------------------------------------------------------------------
# no refusal left
# ----------------------------------------------------------------------------

def test_no_module_refuses_a_map_on_the_card():
    """The refusal that named ROADMAP queue 2 B is gone from every module
    and kernel source of the port, and each mask wrapper counts a twin."""
    files = [p for p in PORT.rglob("*")
             if p.suffix in (".py", ".cu", ".cuh")]
    assert len(files) > 20
    for path in files:
        text = path.read_text(encoding="utf-8")
        assert "queue 2 B" not in text, path
    assert not hasattr(K, "_refuse_map_on_card")
    for mod, names in ((K, ("spmv_cuda", "spmv_cuda_db", "spmv_cuda_panels",
                            "spmv_cuda_panels_db")),
                       (KM, ("spmm_cuda", "spmm_cuda_panels",
                             "spmm_cuda_panels_db"))):
        for name in names:
            assert {name, f"{name}_cmap"} <= set(mod.LAUNCHES)


# ----------------------------------------------------------------------------
# the mapped panel SpMV wrapper's x and the padding lanes
# ----------------------------------------------------------------------------

def test_panel_x_pads_only_without_a_map():
    """Without a map an x shorter than ncols_pad is padded with zeros (a
    copy); with one x goes to the twin as it is, no copy."""
    x = torch.arange(1, 11, dtype=torch.float32)
    padded = K.panel_x(x, 16, mapped=False)
    assert padded.shape == (16,) and bool((padded[10:] == 0).all())
    assert torch.equal(padded[:10], x)
    assert K.panel_x(x, 16, mapped=True) is x
    assert K.panel_x(x, 10, mapped=False) is x


def _pair(layout):
    """Byte-equal reordered mask plans of both packages: a scrambled band
    of 600 columns (600 % 32 != 0: the last windows reach columns at or
    past ncols) after RCM, beta(1,8); panels of 32 rows, windows of 32
    columns, cb 4, or whole-vector at cb 8."""
    kw = dict(layout=layout, lowering="mask", tune=False, reorder="rcm",
              **(dict(pr=32, xw=32, cb=4) if layout == "panels"
                 else dict(cb=8)))
    tplan = tops.prepare(TF.csr_to_spc5(TM.scrambled_banded(
        600, 8, 1.0, seed=42), 1, 8), device="cpu", **kw)
    jplan = jops.prepare(JF.csr_to_spc5(JM.scrambled_banded(
        600, 8, 1.0, seed=42), 1, 8), **kw)
    assert tplan.col_perm is not None
    assert np.array_equal(tplan.col_perm.numpy(),
                          np.asarray(jplan.col_perm))
    return tplan, jplan


@pytest.mark.parametrize("layout", ["panels", "whole_vector"])
def test_set_lanes_lie_below_ncols(layout):
    """Every set lane of a reordered mask plan names a permuted column
    below ncols (the twins read ``col_map[j]`` and x there with no bounds
    check), and the panel layout's lanes at or past ncols, whose columns
    the reference's ``pad_cmap`` sends to x[0], are all unset."""
    plan, _ = _pair(layout)
    k = torch.arange(plan.r * plan.c)
    mask = plan.chunk_mask.view(torch.int32).long() & 0xffffffff
    bits = ((mask[..., None] >> k) & 1).bool()
    col = plan.chunk_col.long()[..., None] + k % plan.c
    if layout == "panels":
        col = col + plan.chunk_xbase.long()[..., None, None]
        assert plan.ncols_pad > plan.ncols
        assert bool((col >= plan.ncols).any())  # padding lanes exist
    assert int(col[bits].max()) < plan.ncols
    assert not bool(bits[col >= plan.ncols].any())


@pytest.mark.parametrize("kernel", ["spmv_cuda_panels", "spmv_cuda_panels_db"])
def test_mapped_panel_wrapper_matches_pallas_pad_cmap(kernel):
    """The mapped panel SpMV wrapper on the CPU (x of ncols entries, never
    padded by the caller) and the reference's Pallas panel kernel in
    interpret mode with the same ``col_map``, padded there with column 0,
    on the reordered plan: the same y. x[0] is large, so a padding lane
    that read it with a nonzero value would show."""
    tplan, jplan = _pair("panels")
    x = np.random.default_rng(4).standard_normal(tplan.ncols).astype(
        np.float32)
    x[0] = 1e6
    args = (tplan.chunk_vbase, tplan.chunk_xbase, tplan.chunk_col,
            tplan.chunk_mask, tplan.chunk_voff, tplan.chunk_row,
            tplan.values)
    geom = dict(r=tplan.r, c=tplan.c, cb=tplan.cb, vmax=tplan.vmax,
                xw=tplan.xw, pr=tplan.pr, nrows=tplan.nrows,
                ncols_pad=tplan.ncols_pad)
    before = dict(K.LAUNCHES)
    y = getattr(K, kernel)(*args, torch.from_numpy(x), tplan.col_perm,
                           **geom)
    assert K.LAUNCHES == before
    y_pal = getattr(JK, kernel.replace("_cuda", "_pallas"))(
        *[jnp.asarray(a.numpy()) for a in args], jnp.asarray(x),
        jnp.asarray(np.asarray(jplan.col_perm).astype(np.int32)),
        interpret=True, **geom)
    y_ref = np.asarray(y_pal, dtype=np.float64)
    np.testing.assert_allclose(y.numpy().astype(np.float64), y_ref,
                               rtol=RTOL,
                               atol=RTOL * float(np.abs(y_ref).max()))
