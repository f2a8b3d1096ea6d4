"""bf16 and int8 values in the seven mask kernels (``spmv_cuda[_db]``,
``spmv_cuda_panels[_db]``, ``spmm_cuda``, ``spmm_cuda_panels[_db]``): their
host side on the CPU, and the value span rule of every kernel that stages
narrow windows.

* The wrappers' shared-memory formulas at 4-, 2- and 1-byte values
  (``spc5_spmv.whole_smem_bytes`` / ``panels_smem_bytes``,
  ``spc5_spmm.whole_stage_bytes`` / ``whole_smem_bytes`` /
  ``panels_smem_bytes``) against a copy of the C layouts (``stage_layout``
  in ``csrc/spc5_spmv.cu``; ``panel_layout`` and ``MaskWhole`` in
  ``csrc/spc5_spmm.cu``; ``whole_layout`` in ``csrc/spc5_spmm_whole.cuh``;
  ``value_window`` in ``csrc/spc5_stage.cuh``), on the yi-6b vocab mask
  layers' geometries ``chip_smoke.py`` runs and on small ones.
* A narrow width never needs a larger stage: with the card's occupancy
  faked, the f32 launch both vocab mask layers plan (SpMV, and SpMM at nvec
  16 and 128) takes no more shared memory at bf16 and int8, and the narrow
  launch keeps the threads and at least the CTAs an SM, the ring and the
  chunks a stage.
* The span rule (``spc5_spmv.value_span``, the kernels' ``value_span``):
  over bf16 (at align 4: at the default 8 every bf16 window starts and ends
  on a 16-byte boundary) and int8 plans of both packages, every layout and
  lowering, on 40 powerlaw matrices in beta(4,8), what a kernel copies of
  each window
  covers the window, starts on a 16-byte boundary, fits the staged window
  and ends inside ``values``; the 16-byte aligned span it was cut from
  reaches past ``values`` on some of the plans (so the cut is needed and
  this test can fail). int8 plans aligned to 4 values end 4 or 12 bytes
  past a 16-byte boundary: their copies stop at ``values``' exact end,
  where cutting 8 bytes off the span copied past it.

The products themselves (every layout and lowering at bf16 and int8, on
the CPU through the wrappers' plain versions, against the reference's
Pallas kernels and the pins) are ``tests/test_torch_vdtype.py``'s; the
kernels on the card are ``tests/test_torch_gpu.py``'s.
"""
import numpy as np
import pytest
import torch

from repro.core import formats as JF
from repro.core import matgen as JM
from repro.kernels import ops as jops
from repro_torch.core import formats as TF
from repro_torch.core import matgen as TM
from repro_torch.kernels import ops as tops
from repro_torch.kernels import spc5_spmm as KM
from repro_torch.kernels import spc5_spmv as K
from repro_torch.kernels import spc5_spmv_desc as KD

VSIZES = (4, 2, 1)
VDTYPE_SIZE = {"bf16": 2, "int8": 1}

#: chip_smoke.py's vocab mask layers (their logged geometry): the
#: whole-vector layer (cb, r, c, vmax, nchunks) and the panel layer (cb, r,
#: c, vmax, pr, npanels, nchunks).
VOCAB_WHOLE = (256, 4, 8, 1_144, 25_856)
VOCAB_PANELS = (64, 4, 8, 312, 512, 125, 830)


def _r16(n):
    return -(-n // 16) * 16


def _window(vsize, vmax):
    """``value_window`` in ``csrc/spc5_stage.cuh``."""
    return _r16(vsize * vmax) + (16 if vsize < 4 else 0)


def _spmv_stage(cb, vmax, vsize):
    """``stage_layout(a, vsize).bytes`` in ``csrc/spc5_spmv.cu``: the value
    window, four metadata rows of cb int32 entries and the 16-byte slot."""
    meta = _window(vsize, vmax)
    meta_stride = _r16(4 * cb)
    return meta + 4 * meta_stride + 16


def _spmv_whole_copy(stages, cb, vmax, tile, threads, vsize):
    """``whole_smem`` in ``csrc/spc5_spmv.cu``."""
    return _r16(4 * tile * (threads // 32)) + stages * _spmv_stage(cb, vmax,
                                                                   vsize)


def _spmv_panels_copy(stages, cb, vmax, pr, vsize):
    """``panels_smem`` in ``csrc/spc5_spmv.cu``."""
    return _r16(4 * pr) + stages * _spmv_stage(cb, vmax, vsize)


def _spmm_panels_copy(stages, q, cb, vmax, prows, tw, vsize):
    """``panel_layout`` / ``panel_smem`` in ``csrc/spc5_spmm.cu``."""
    nb = q * cb
    tile = _r16(4 * prows * tw)
    vstride = _window(vsize, vmax)
    xbase = q * vstride
    wmeta = xbase + _r16(4 * q)
    meta = wmeta + (_r16(8 * q) if vsize < 4 else 0)
    meta_stride = _r16(4 * nb)
    bar = meta + 4 * meta_stride
    stage = bar + 16
    keys = _r16(4 * nb)
    order = keys + 16 * q * vmax
    return tile + stages * stage + order


def _mask_whole_stage_copy(q, nb, vmax, vsize):
    """``MaskWhole<T>::stage_bytes`` in ``csrc/spc5_spmm.cu``."""
    wmeta = q * _window(vsize, vmax)
    meta = wmeta + (_r16(8 * q) if vsize < 4 else 0)
    return meta + 4 * _r16(4 * nb) + 16


def _spmm_whole_copy(stages, q, nb, r, c, vmax, tw, vec, tile_rows, threads,
                     vsize):
    """``whole_layout`` in ``csrc/spc5_spmm_whole.cuh`` with the mask
    kernel's stage."""
    groups = threads // (tw // vec)
    slots = _r16(4 * tile_rows * tw)
    heads = slots + _r16(8 * groups * tw)
    scratch = heads + 16 * groups
    lst = scratch + 4 * 2 * 16 * 8
    room = min(q * vmax, nb * r * c)
    ring = lst + 16 * room
    return ring + stages * _mask_whole_stage_copy(q, nb, vmax, vsize)


# ----------------------------------------------------------------------------
# shared-memory formulas
# ----------------------------------------------------------------------------

@pytest.mark.parametrize("vsize", VSIZES)
@pytest.mark.parametrize("geom", [(256, 1_144, 32, 64), (256, 4_096, 32, 128),
                                  (16, 40, 32, 32), (16, 88, 16, 256),
                                  (64, 312, 32, 256)])
@pytest.mark.parametrize("stages", [1, 2])
def test_spmv_whole_smem_matches_a_copy(stages, geom, vsize):
    """``spc5_spmv.whole_smem_bytes`` (cb, vmax, tile, threads) at 4-, 2-
    and 1-byte values: the vocab whole-vector layer, FEM and small ones."""
    assert K.whole_smem_bytes(stages, *geom, vsize) == \
        _spmv_whole_copy(stages, *geom, vsize)


@pytest.mark.parametrize("vsize", VSIZES)
@pytest.mark.parametrize("geom", [(64, 312, 512), (64, 176, 512),
                                  (16, 40, 64), (8, 24, 32), (256, 4_096, 512)])
@pytest.mark.parametrize("stages", [1, 2, 3])
def test_spmv_panels_smem_matches_a_copy(stages, geom, vsize):
    """``spc5_spmv.panels_smem_bytes`` (cb, vmax, pr) at 4-, 2- and 1-byte
    values: the vocab panel layer, FEM's and small ones."""
    assert K.panels_smem_bytes(stages, *geom, vsize) == \
        _spmv_panels_copy(stages, *geom, vsize)


@pytest.mark.parametrize("vsize", VSIZES)
@pytest.mark.parametrize("geom", [(4, 64, 312, 512, 128), (3, 64, 312, 256, 16),
                                  (2, 64, 312, 128, 128), (1, 16, 40, 64, 4),
                                  (3, 12, 40, 64, 1)])
@pytest.mark.parametrize("stages", [1, 2])
def test_spmm_panels_smem_matches_a_copy(stages, geom, vsize):
    """``spc5_spmm.panels_smem_bytes`` (q, cb, vmax, prows, tw) at 4-, 2-
    and 1-byte values: the vocab panel layer's plans at nvec 128 and 16 and
    small ones."""
    assert KM.panels_smem_bytes(stages, *geom, vsize) == \
        _spmm_panels_copy(stages, *geom, vsize)


@pytest.mark.parametrize("vsize", VSIZES)
@pytest.mark.parametrize("geom", [(4, 1_024, 4, 8, 1_144, 128, 4, 16, 512),
                                  (1, 256, 4, 8, 1_144, 16, 4, 16, 256),
                                  (1, 128, 4, 4, 4_096, 16, 4, 16, 256),
                                  (2, 32, 2, 4, 40, 4, 1, 16, 256),
                                  (1, 8, 8, 4, 24, 2, 2, 16, 256)])
@pytest.mark.parametrize("stages", [1, 2])
def test_spmm_whole_smem_matches_a_copy(stages, geom, vsize):
    """``spc5_spmm.whole_stage_bytes`` / ``whole_smem_bytes`` (q, nb, r, c,
    vmax, tw, vec, tile rows, threads) at 4-, 2- and 1-byte values: the
    vocab whole-vector layer's rounds at nvec 128 and 16, FEM's slice of a
    chunk and small ones."""
    q, nb, _, _, vmax = geom[:5]
    assert KM.whole_stage_bytes(q, nb, vmax, vsize) == \
        _mask_whole_stage_copy(q, nb, vmax, vsize)
    assert KM.whole_smem_bytes(stages, *geom, vsize) == \
        _spmm_whole_copy(stages, *geom, vsize)


@pytest.mark.parametrize("vsize", VSIZES)
@pytest.mark.parametrize("vmax", [8, 40, 312, 1_144])
def test_value_window_is_the_kernels(vmax, vsize):
    """One value window rule for every kernel that stages narrow values:
    ``value_window_bytes`` (re-exported by ``spc5_spmv_desc``) is
    ``value_window``, and a narrow one holds its widest span."""
    assert K.value_window_bytes(vmax, vsize) == _window(vsize, vmax)
    assert KD.value_window_bytes is K.value_window_bytes
    if vsize < 4:
        worst = max(K.value_span(vb, vmax, vsize, 10 ** 6)[2]
                    - K.value_span(vb, vmax, vsize, 10 ** 6)[0]
                    for vb in range(0, 64, 8 // vsize))
        assert worst <= K.value_window_bytes(vmax, vsize)


# ----------------------------------------------------------------------------
# a narrow width never needs a larger stage
# ----------------------------------------------------------------------------

def _ctas_per_sm(smem, threads):
    """An H100 SM's CTAs by its 65,536 registers (64 a thread at most),
    2,048 threads, 32 CTAs and 228 KB of shared memory (1 KB of it reserved
    per CTA)."""
    return min(32, 2048 // threads, 65_536 // (64 * threads),
               (228 * 1024) // (smem + 1024))


@pytest.fixture
def fake_card(monkeypatch):
    """Every mask kernel's occupancy as an H100 of 132 SMs would answer it
    (the same at every width: the kernels' registers are not counted)."""
    def spmv(stages, threads, smem, device, vsize=4):
        return _ctas_per_sm(smem, threads), 132

    def spmm_panels(stages, c, vec, threads, smem, device, vsize=4):
        return _ctas_per_sm(smem, threads), 132

    def spmm_whole(r, c, vec, threads, smem, device, vsize=4):
        return _ctas_per_sm(smem, threads), 132
    monkeypatch.setattr(K, "whole_occupancy", spmv)
    monkeypatch.setattr(K, "panels_occupancy", spmv)
    monkeypatch.setattr(KM, "panels_occupancy", spmm_panels)
    monkeypatch.setattr(KM, "whole_occupancy", spmm_whole)


CPU = torch.device("cpu")


def _planned(kernel, stages, vsize, nvec=None):
    """The launch a vocab mask layer's wrapper plans for ``vsize``-byte
    values."""
    if kernel == "spmv_whole":
        cb, r, _, vmax, nchunks = VOCAB_WHOLE
        return K.whole_launch(stages, nchunks, cb=cb, r=r, vmax=vmax,
                              device=CPU, vsize=vsize)
    if kernel == "spmv_panels":
        cb, r, _, vmax, pr, npanels, nchunks = VOCAB_PANELS
        return K.panels_launch(stages, npanels, nchunks, cb=cb, r=r,
                               vmax=vmax, pr=pr, device=CPU, vsize=vsize)
    if kernel == "spmm_whole":
        cb, r, c, vmax, nchunks = VOCAB_WHOLE
        return KM.whole_launch(nchunks, cb=cb, r=r, c=c, vmax=vmax,
                               nvec=nvec, vec=KM.panels_vector(nvec),
                               device=CPU, vsize=vsize)
    cb, r, c, vmax, pr, npanels, nchunks = VOCAB_PANELS
    return KM.panels_launch(stages, npanels, nchunks, cb=cb, r=r, c=c,
                            vmax=vmax, pr=pr, nvec=nvec,
                            vec=KM.panels_vector(nvec), device=CPU,
                            vsize=vsize)


def _smem(kernel, launch, vsize):
    """The shared memory a CTA of ``launch`` (a vocab mask layer's) takes
    at ``vsize``-byte values, by the wrapper's formula."""
    if kernel == "spmv_whole":
        return K.whole_smem_bytes(launch["stages"], VOCAB_WHOLE[0],
                                  VOCAB_WHOLE[3], launch["tile_rows"],
                                  launch["threads"], vsize)
    if kernel == "spmv_panels":
        return K.panels_smem_bytes(launch["stages"], VOCAB_PANELS[0],
                                   VOCAB_PANELS[3], VOCAB_PANELS[4], vsize)
    if kernel == "spmm_whole":
        cb, r, c, vmax, _ = VOCAB_WHOLE
        return KM.whole_smem_bytes(launch["stages"],
                                   launch["chunks_per_stage"],
                                   launch["blocks_per_stage"], r, c, vmax,
                                   launch["tile_columns"], launch["vector"],
                                   launch["tile_rows"], launch["threads"],
                                   vsize)
    return KM.panels_smem_bytes(launch["stages"], launch["chunks_per_stage"],
                                VOCAB_PANELS[0], VOCAB_PANELS[3],
                                launch["part_rows"], launch["tile_columns"],
                                vsize)


@pytest.mark.parametrize("vsize", [2, 1])
@pytest.mark.parametrize("case", [
    ("spmv_whole", 1, None), ("spmv_whole", K.WHOLE_DB_STAGES, None),
    ("spmv_panels", 1, None), ("spmv_panels", K.DB_STAGES, None),
    ("spmm_whole", None, 16), ("spmm_whole", None, 128),
    ("spmm_panels", 1, 16), ("spmm_panels", 1, 128),
    ("spmm_panels", KM.PANEL_DB_STAGES, 16),
    ("spmm_panels", KM.PANEL_DB_STAGES, 128)], ids=str)
def test_narrow_values_plan_no_larger_stages(fake_card, case, vsize):
    """Both vocab mask layers' planned launches at bf16 and int8: the f32
    launch's CTA takes no more shared memory at the narrow width, and the
    narrow launch keeps the threads, at least the CTAs an SM, the ring and,
    for SpMM, the chunks a stage (it may take more chunks a stage, where
    they fit the CTAs an SM); its figure is the kernel's formula at that
    width."""
    kernel, stages, nvec = case
    f32 = _planned(kernel, stages, 4, nvec)
    q = _planned(kernel, stages, vsize, nvec)
    assert _smem(kernel, f32, vsize) <= f32["smem_bytes"] == \
        _smem(kernel, f32, 4)
    assert q["smem_bytes"] == _smem(kernel, q, vsize)
    assert q["threads"] == f32["threads"]
    assert q["ctas_per_sm"] >= f32["ctas_per_sm"]
    assert q["stages"] >= f32["stages"]
    if kernel.startswith("spmm"):
        assert q["chunks_per_stage"] >= f32["chunks_per_stage"]
    else:
        assert q["smem_bytes"] <= f32["smem_bytes"]


# ----------------------------------------------------------------------------
# the span rule: no narrow window's copy reaches past values
# ----------------------------------------------------------------------------

SPAN_GEOM = {"whole_vector": dict(cb=16), "panels": dict(pr=32, xw=32, cb=8)}
SPAN_MATRICES = 40
#: The plans' window alignment, in values: bf16 windows start off a 16-byte
#: boundary only below the default 8.
SPAN_ALIGN = {"bf16": 4, "int8": 8}


def _spans(vbase, vmax, vsize, nvalues):
    """Every window's span, and how many of the aligned spans reach past
    ``values``; asserts what the kernels rely on for each."""
    past = 0
    for vb in np.asarray(vbase).ravel().tolist():
        start, nbytes, end = K.value_span(vb, vmax, vsize, nvalues)
        assert start % 16 == 0 and end % 16 == 0
        assert start <= vb * vsize and start + nbytes >= (vb + vmax) * vsize
        assert start + nbytes <= nvalues * vsize
        assert nbytes % 8 == 0 and nbytes <= K.value_window_bytes(vmax, vsize)
        assert nbytes in (end - start, end - start - 8)
        past += end > nvalues * vsize
    return past


def _port_plan(seed, layout, lowering, vdtype):
    dim = 200 + 10 * seed
    mat = TF.csr_to_spc5(TM.powerlaw(dim, 5, seed=seed), 4, 8)
    return tops.prepare(mat, layout=layout, lowering=lowering, vdtype=vdtype,
                        tune=False, device="cpu", align=SPAN_ALIGN[vdtype],
                        **SPAN_GEOM[layout])


@pytest.mark.parametrize("vdtype", sorted(VDTYPE_SIZE))
@pytest.mark.parametrize("lowering", ["mask", "descriptor"])
@pytest.mark.parametrize("layout", sorted(SPAN_GEOM))
@pytest.mark.parametrize("package", ["port", "reference"])
def test_no_clamped_span_ends_past_values(package, layout, lowering, vdtype):
    """Over the plans of 40 powerlaw matrices in beta(4,8) (200 to 590 rows,
    5 a row on average) at ``vdtype`` (:data:`SPAN_ALIGN`), built by the
    port or by the reference (byte-equal), every window's copy stays inside
    ``values``, and on some plans the aligned span it was cut from does
    not."""
    vsize = VDTYPE_SIZE[vdtype]
    plans_past = 0
    for seed in range(SPAN_MATRICES):
        tplan = _port_plan(seed, layout, lowering, vdtype)
        vbase, nvalues = tplan.chunk_vbase, tplan.values.numel()
        if package == "reference":
            jmat = JF.csr_to_spc5(JM.powerlaw(200 + 10 * seed, 5, seed=seed),
                                  4, 8)
            jplan = jops.prepare(jmat, layout=layout, lowering=lowering,
                                 vdtype=vdtype, tune=False,
                                 align=SPAN_ALIGN[vdtype],
                                 **SPAN_GEOM[layout])
            at = {id(a): i for i, a in enumerate(tplan.arrays)}
            vbase = np.asarray(jplan.arrays[at[id(tplan.chunk_vbase)]])
            values = np.asarray(jplan.arrays[at[id(tplan.values)]])
            assert values.itemsize == vsize
            nvalues = values.size
        plans_past += _spans(vbase, tplan.vmax, vsize, nvalues) > 0
    assert plans_past > 0


def test_span_rule_cases():
    """The rule on its own: a window ending 8 bytes past a 16-byte boundary
    at values' end loses the span's last 8 bytes; anywhere else nothing is
    cut."""
    # int8, vmax 8: window [8, 16) of 16 values: the span [0, 16) fits
    assert K.value_span(8, 8, 1, 16) == (0, 16, 16)
    # window [16, 24) of 24 values: the span [16, 32) would pass 24
    assert K.value_span(16, 8, 1, 24) == (16, 8, 32)
    # the same window with values to spare: nothing is cut
    assert K.value_span(16, 8, 1, 32) == (16, 16, 32)
    # bf16, vmax 12: window [4, 16) values = bytes [8, 32), 32 values
    assert K.value_span(4, 12, 2, 16) == (0, 32, 32)
    # bf16 window [8, 20) = bytes [16, 40) of 20 values: span to 48, cut
    assert K.value_span(8, 12, 2, 20) == (16, 24, 48)


def _old_stop(vb, vmax, vsize, nvalues):
    """Where the span rule before the int8 align-4 repair stopped a copy:
    8 bytes short of the span's end wherever it was cut."""
    start, _, end = K.value_span(vb, vmax, vsize, nvalues)
    per_piece = 16 // vsize
    return end - 8 if vb + vmax > nvalues // per_piece * per_piece else end


@pytest.mark.parametrize("lowering", ["mask", "descriptor"])
@pytest.mark.parametrize("layout", sorted(SPAN_GEOM))
@pytest.mark.parametrize("package", ["port", "reference"])
def test_int8_spans_at_align_4_stay_inside_values(package, layout, lowering):
    """int8 plans aligned to 4 values (windows on 4-byte boundaries, values
    4 or 12 bytes past a 16-byte one) of both packages: every window's copy
    covers it and ends inside ``values`` (stopping 4, 8 or 12 bytes into its
    last piece), and on some plans the rule that cut 8 bytes off the span
    (the kernels' before this repair) copied past ``values``."""
    over = 0
    for seed in range(SPAN_MATRICES):
        n = 200 + 10 * seed
        kw = dict(layout=layout, lowering=lowering, vdtype="int8",
                  tune=False, align=4, **SPAN_GEOM[layout])
        if package == "port":
            plan = tops.prepare(TF.csr_to_spc5(TM.powerlaw(n, 5, seed=seed),
                                               4, 8), device="cpu", **kw)
            vbase, nvalues = plan.chunk_vbase.numpy(), plan.values.numel()
        else:
            plan = jops.prepare(JF.csr_to_spc5(JM.powerlaw(n, 5, seed=seed),
                                               4, 8), **kw)
            vbase = np.asarray(plan.chunk_vbase)
            nvalues = np.asarray(plan.values).size
        for vb in vbase.ravel().tolist():
            start, nbytes, end = K.value_span(vb, plan.vmax, 1, nvalues)
            assert start % 16 == 0 and nbytes % 4 == 0
            assert start <= vb and start + nbytes >= vb + plan.vmax
            assert start + nbytes <= nvalues
            assert nbytes <= K.value_window_bytes(plan.vmax, 1)
            over += _old_stop(vb, plan.vmax, 1, nvalues) > nvalues
    assert over > 0


def test_span_rule_stops_at_values_end():
    """The rule at values' exact end: int8 values 4 and 12 bytes past a
    16-byte boundary (align 4) keep 4 and 12 bytes of the last piece."""
    # window [16, 20) of 20 int8 values: the span [16, 32) stops at 20
    assert K.value_span(16, 4, 1, 20) == (16, 4, 32)
    # window [4, 28) of 28 values: [0, 32) stops at 28 (12 bytes in)
    assert K.value_span(4, 24, 1, 28) == (0, 28, 32)
    # window [12, 20) of 20 values: [0, 32) stops at 20
    assert K.value_span(12, 8, 1, 20) == (0, 20, 32)
    # and nothing is cut inside values
    assert K.value_span(12, 8, 1, 36) == (0, 32, 32)
