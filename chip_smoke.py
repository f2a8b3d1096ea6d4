#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main paths on one NVIDIA GPU and check them.

    python3 chip_smoke.py

What it does, in order, failing (exit code 1, no result line) at the first
phase that goes wrong:

1. prints the card's name and power limit (``nvidia-smi``);
2. builds the CUDA kernels from ``src/repro_torch/kernels/csrc`` with nvcc
   for sm_90a, one nvcc per source, all started together, and prints the
   build time and each kernel's registers (``-Xptxas -v``); meanwhile it
   makes the host-only inputs of the later phases (the FEM matrix, the
   band and its RCM reordering, the vocab weight);
3. holds all sixteen kernels against their plain PyTorch versions on
   small matrices of every supported block shape (SpMM at nvec 3, 16 and
   128), the seven descriptor kernels also on a matrix wider and one
   taller than 32,767 (int32 ``xcol`` / ``yrow`` tables), and the test
   split's two tail kernels (SpMV, and SpMM at nvec 3, 16 and 128) on
   three bucket geometries (the reference's tail test, nrows % pr != 0,
   and a window wider than 12,288 columns), each at its planned launch, at
   S = 1 / G = 1 and at one group of 128 slots a CTA, at f32 and at bf16
   (the test layout keeps a bf16 plan's tail in bf16); and the fourteen
   kernels that take bf16 and int8 values (the seven descriptor kernels
   and the seven mask kernels) at both widths on every block shape (SpMV
   at its planned launch, S / G = 1 and one chunk a CTA; SpMM at nvec 3,
   16 and 128, planned launch and S / G = 1), with all-zero chunks (scale
   1.0), int8 windows that start off a 16-byte boundary and int8 plans
   whose last window's 16-byte aligned span would reach past their values
   (the kernels copy it short of that); and the eleven kernels with a
   column map (a reordered plan's column permutation, each counted under
   its own name, ``spmv_cuda_panels_desc_cmap``, ``spmv_cuda_cmap`` and so
   on: the four panel descriptor twins and the seven mask twins) at f32,
   bf16 and int8 on every block shape with a random permutation, on panel
   plans whose windows reach columns at or past ncols and on whole-vector
   mask plans (also with their chunks in a random order: block rows out
   of order), and on an int8 plan of each layout and lowering whose last
   span would reach past its exact-length values (SpMV at the planned
   launch, S / G = 1 and one chunk a CTA; SpMM at nvec 3, 16 and 128,
   planned launch and S / G = 1);
4. SpMV path: builds ``matgen.fem_blocks(200_000, 4, 12, seed=5)``, the
   SET_A bone010 structure class at 200,000 rows (about 9.5 M nonzeros), in
   beta(4,4), and drives ``ops.prepare`` + ``ops.spmv`` through both
   layouts (whole-vector, cb=256; panels, pr=512, cb=64, xw=512) and both
   lowerings (mask, descriptor), each with ``double_buffer`` True and
   False; checks that ``lowering="auto"`` resolves to the descriptor
   lowering by the cost model, as in the reference; the mask panel SpMV
   kernels are also held at S = 1 and both whole-vector SpMV pairs (mask
   and descriptor) at one CTA for all chunks and at one chunk a CTA (each
   launch's grid, chunks a CTA, threads, shared bytes, ring, CTAs per SM
   and registers printed);
4a. tune and verify on the card: the FEM matrix's four plans of 4's
   beta(4,4) and four of each of beta(2,4) and beta(4,8) (built with
   ``verify=True``) timed at batch 1 through ``ops.spmv`` (each output held
   against its plain version and the f64 product), each time a selector
   ``Record`` of the card's backend (``"cuda:<card name>"``, gflops = 2 nnz
   / t) in a store written with ``save_jsonl``, read back with
   ``load_records`` and held to ``verify_records``; then
   ``ops.prepare(fem, store=store, verify=True)`` with the matrix's values
   in float32 must be tuned from the store to the config measured fastest
   (its SpMV checked, its launch counted, timed beside the untuned plan
   and beside the plan tuned from the generator's float64 values, whose
   whole-vector pick the reference's 2 MiB rule demotes to panels),
   ``choose_block(csr, store)`` must pick the shape measured fastest, and
   ``SparseLinear.from_dense`` on the vocab weight's first 4,096 rows with
   the store and ``verify=True`` runs its forward (batch 1 and 16) on the
   card against ``use_pallas=False``; ``verify_plan``'s host seconds and
   ``plan_nbytes`` are printed for the FEM plans;
4b. reorder path: ``matgen.scrambled_banded(1_000_000, 8, 1.0, seed=42)``
   (the reference bench's reorder matrix class, about 6.5 M nonzeros) in
   beta(1,8): its RCM ``Reordering`` built once on the host
   (``reorder.reorder(mat, "rcm")`` at pr=256, xw=512, cb=64, its seconds
   printed) and handed to ``ops.prepare(layout="panels", pr=256, xw=512,
   cb=64, tune=False, reorder=reo)``, which must be panels + descriptor
   with ``col_perm`` and ``row_iperm`` kept and fewer chunks than the
   original order, and to two mask plans, ``layout="panels",
   lowering="mask"`` (same geometry) and ``layout="whole_vector",
   lowering="mask"``, each with ``col_perm`` kept; beside them the
   unreordered plans, whole-vector + descriptor and whole-vector + mask
   (the original order's panel plan would pad every panel to the largest
   panel's chunk count, each chunk about one block: far past the card);
   on each reordered plan ``ops.spmv`` with both buffer settings and
   ``ops.spmm`` at 16 and 128 with both run its map kernels and nothing
   else, each output held against the unreordered plan of its lowering and
   the float64 CSR product; each map kernel timed in turns with
   the same kernel on the same arrays against x[col_perm] with no map (the
   map's cost), beside its bound (the map's 4 * ncols bytes counted once),
   its plain version and cuSPARSE on the same CSR, and the SpMV of all five
   band plans through ``ops`` beside cuSPARSE;
4c. sharding: the FEM matrix cut into 8 row shards by
   ``distributed.shard_matrix`` (``partition="auto"``, its mode and nnz
   skews printed) at ``benchmarks/bench_spmv_par.py``'s geometries
   (whole-vector cb=512; panels pr=1024, cb=64, xw=512), both layouts x
   both lowerings at f32 and whole-vector mask at bf16, and the band with
   its RCM ``Reordering`` on panels + mask; each plan's 8 shards run one
   after another through ``plan.local_execute_spmv`` on the card, with the
   counts at 0 (exactly 8 launches of the layout's kernel and nothing
   else), y assembled by the gather path's helper
   (``distributed._assemble``) and held to ``1e-5 * max|y|`` of the
   unsharded ``ops.spmv`` and of the float64 product (bf16: of the
   dequantised values, and within ``tests/test_vdtype.py``'s pin); each
   shard timed, with their sum, max and max / mean (the max a model of an
   8-card step before its all_gather, not a measurement of 8 cards) and
   the unsharded plan's time; then ``make_distributed_spmv`` on a
   one-shard plan through a one-rank NCCL group (gathered and
   ``gather=False``), and ``examples_torch/cg_solver.py`` with and without
   ``--distributed`` as subprocesses, each converging with its SpMV
   kernel launched;
5. SparseLinear path: the vocab projection of yi-6b (64,000 x 4,096, the
   weight ``serve.py``'s vocab bench draws: ``default_rng(0)``, standard
   normal, float32), magnitude-pruned to density 0.1 (beta(4,8) by eq. 4),
   through ``SparseLinear.from_dense(w, density=0.1, nvec=128)`` with every
   other argument at its default, the reference's default layer, whose
   layout pass must resolve to panels + descriptor (its forward runs
   ``spmm_cuda_panels_desc_db``); beside it two mask layers on the same
   converted matrix (``ops.prepare(lowering="mask")``: auto layout, panels,
   and whole-vector); both panel SpMM kernels of each lowering are also
   held at S = 1, each launch printed (S, grid, row parts, tile, columns a
   lane, threads, shared bytes, CTAs per SM, registers);
   ``ops.spmm(..., double_buffer=False)`` on both panel
   layers at batches of 16 and 128, and batch 1 (one decode token): the
   three layers' forwards and ``ops.spmv(..., double_buffer=False)`` on
   each, so all four panel SpMV kernels and the whole-vector mask pair run
   (their launches, S or G, grid, threads, shared bytes, CTAs per SM and
   registers are printed; the whole-vector mask pair also held at G = 1
   and at one chunk a CTA);
   then the whole-vector descriptor plan of the same weight:
   ``ops.prepare(mat)`` at nvec=1 (whole-vector + descriptor, the
   reference's pick for one decode token), ``ops.spmv`` with
   ``double_buffer`` True and False (both kernels also at one chunk a CTA)
   and ``ops.spmm`` at batches of 16 and 128, printing the tables' bytes,
   the pair's launches and the host time of ``chunk_descriptors``; the
   same token plan at bf16 and int8 (``ops.prepare(mat, vdtype=...)``,
   which must resolve to whole-vector + descriptor by the cost model at
   every width; about 1.9 GB each, freed after the phase) through
   ``ops.spmv`` with both buffer settings and ``ops.spmm`` at 16 and 128,
   each width's counts holding ``spmv_cuda_desc[_db]`` / ``spmm_cuda_desc``
   and nothing else, each output checked as the quantised layers' below and
   each kernel timed in turns with the f32 token plan; and the
   default layer and both mask layers at bf16 and int8 values:
   ``ops.prepare(mat, vdtype=..., nvec=128)`` on the same converted matrix
   must resolve to panels + descriptor in beta(4,8), ``ops.prepare(mat,
   lowering="mask", vdtype=..., nvec=128)`` to panels, beside
   ``ops.prepare(mat, layout="whole_vector", lowering="mask", ...)``; their
   forwards at batch 1 and at 16 and 128 and ``ops.spmv`` / ``ops.spmm(...,
   double_buffer=False)`` run the eleven quantised kernels in their
   quantised instantiations (only these layers run between the counts'
   reset and reading), each output held against its plain version, the
   f64 product of the dequantised values (the plain version in float64)
   and, within ``tests/test_vdtype.py``'s bf16 / int8 pins, the f64
   product of the f32 weight; each kernel is timed beside the same kernel
   on the f32 layer in turns, its bound, its plain version and cuSPARSE
   (on bf16 values where the card's torch takes them), and the values'
   share of the needed bytes is printed for each layer at each width;
   then the reordered vocab layer: (3a) ``SparseLinear.from_dense(w,
   density=0.1, nvec=128, reorder="auto")`` (the host pass tries sigma,
   RCM and column-window clustering and keeps the best or declines; its
   trace entry is printed and checked for consistency), every forward held
   against the unreordered default layer's; (3b) the same call with a
   prebuilt Reordering (the 125 row panels in a random order, the columns
   by ``default_rng(7)``), which must be panels + descriptor with the rows
   fused and ``col_perm`` kept, and the same Reordering through the two
   mask layers (``lowering="mask"``, auto layout panels, and
   ``layout="whole_vector", lowering="mask"``), rows fused and
   ``col_perm`` kept, at f32, the default layer also at bf16 and the mask
   panel layer also at int8 (the other narrow (3b) layers were cut for
   the serving phase's time; the small check holds every map kernel at
   both widths): forwards at batch 1, 16 and 128 and their
   ``double_buffer=False`` twins run the eleven map kernels at every width
   and nothing else, each output held against its plain version, the f64
   product and the unreordered layer of its layout and lowering; each map
   kernel timed in turns against its twin on x[col_perm];
5a. serving tier (``repro_torch.launch.server``) on the same vocab matrix:
   two tiers, ``server.start(ServeConfig(vocab_spmv=0.1, verify=True,
   cache_mb=4096), mat=vocab)`` (the token plan, whole-vector +
   descriptor: ``spmv_cuda_desc_db`` / ``spmm_cuda_desc``) and the same
   with ``lowering="mask"`` (whole-vector + mask: ``spmv_cuda_db`` /
   ``spmm_cuda``), each plan's size, build and ``verify_plan`` seconds
   printed and a second ``get_or_build`` a cache hit; on each, 64 vectors
   submitted at once plus one alone, every y within ``1e-5 * max|y|`` of
   the f64 product and a lone ``ops.spmv``, no batch degraded, the SpMV
   kernel counting exactly the width-1 batches and the SpMM kernel every
   wider one, no other kernel launched; ``saturation_sweep`` (from 1,000
   QPS, doubling, up to six points of 0.5 s) with each point's achieved
   QPS, p50 / p99, batches, mean batch and ``PlanExecStats``, the
   ``serve.submit`` / ``serve.batch`` span times, against the ceilings of
   the kernel times alone; the mask tier under ``exec.spmv``,
   ``exec.spmm``, ``serve.gather`` and ``serve.exec`` at 10 % (fixed
   seeds) for one ``open_loop``: every request correct or failed with a
   typed error, some batches degraded and some workers restarted; a fresh
   ``PlanCache`` with ``plan.build:1`` armed on the weight's first 4,096
   rows lands on the ``reference`` rung and its SpMV runs on the card;
   ``python -m repro_torch.launch.serve --vocab-spmv 0.1 --qps 500
   --metrics`` once, its Prometheus file parsed and its Chrome trace
   holding a ``serve.batch`` span under a ``serve.submit`` span; then
   ``python -m repro_torch.launch.chaos_smoke`` in a subprocess with
   ``SPC5_FAULTS`` set to the same four points at 10 %, which must exit 0;
5b. LM decode (ROADMAP queue 1 item 13, the dense decoder): (a) the
   smoke configs of the five dense archs, one set of params drawn on the
   host and carried to both devices with ``convert.params_from_numpy``,
   decoded teacher-forced on the card and on the CPU at a bf16 and an int8
   KV cache (``lm_hold``): the logits within 1e-4 of max|logits| at every
   step, with the int8 cache up to the step where the quantised keys part
   and 5e-3 after it; the int8 quantiser giving the same bits on the card
   for the CPU's inputs, the first split at a rounding tie (within 1e-3
   of a step), the caches within the logits' limit of their max and their
   int8 entries at most one step apart in under 2e-2 of them; (b)
   yi-6b at full width and depth (``get_config("yi-6b")``, about 6.06 B
   parameters): f32 masters drawn on the card (24.2 GB), teacher-forced
   ``decode_step`` over 32 positions at batch 4 against ``prefill`` at
   lengths 1, 2, 8, 16 and 32 (TF32 off), then ``cast_params`` to bf16
   once and the same check at bf16, then ``ServeConfig``'s default greedy
   decode (4 sequences, 31 steps, ``serve.greedy_decode``) timed once with
   CUDA events at both KV dtypes after two untimed steps, its ms a step
   and tok/s printed beside the bound (the bytes a step must read over
   3.35 TB/s), one step at the bf16 KV cache under the profiler; (c)
   ``python -m repro_torch.launch.serve --arch yi-6b --vocab-spmv 0.1``
   on the card: it decodes, prints the reference's tok/s line, then its
   vocab bench launches an SpMV kernel, counted with the counts set to 0
   just before;
6. beta(r,c)_test path: the same weight in beta(2,4) (whose singleton
   blocks hold about 30 % of the nonzeros) as
   ``SparseLinear.from_dense(w, density=0.1, block=(2, 4), layout="test",
   nvec=128)``: its multi sub-plan is panels by the 2 MiB rule, lowered by
   the cost model, and its tail is bucketed by panel; batch 1 runs the
   multi SpMV kernel + ``spmv_tail_cuda``, batches of 16 and 128 the multi
   SpMM kernel + ``spmm_tail_cuda`` (whose launches are counted at each
   batch); both panel descriptor SpMV kernels also run on the multi
   sub-plan alone (``ops.spmv``), and both panel descriptor SpMM kernels at
   S = 1 and one chunk a CTA, checked against its plain version and the
   f64 product less the tail's; both tail kernels also alone on the tail,
   at their planned launch, S = 1 / G = 1 and one group a CTA, against
   their plain versions and the f64 product of the tail. Beside it the
   flat-tail plan ``ops.prepare(beta(2,4), layout="test")`` at nvec = 1:
   whole-vector multi, tail through the plain ``spmv_coo``, no tail kernel;
   both whole-vector descriptor SpMV kernels also run on its multi
   sub-plan alone, at the launch their wrappers pick and at one chunk a
   CTA. Prints the host time of ``split_singletons``. Then the same path at
   bf16: layer (a) as ``ops.prepare(beta(2,4), layout="test", vdtype="bf16",
   nvec=128)`` (panels multi, bf16 buckets: both tail kernels run their
   bf16 instantiations) and the flat-tail plan (b) at bf16 (its
   whole-vector multi runs ``spmv_cuda_desc_db`` on bf16 values), driven
   and counted as at f32, every output held against its plain version, the
   f64 product of the dequantised values and the bf16 pin, both tail kernels
   also alone, then each tail kernel timed in turns on the same buckets at
   f32 and bf16 (and the flat plan's multi, bf16 against f32);
7. in each path every launch counter is set to 0 just before and read just
   after, and every kernel of the path must have launched; every output is
   checked against the kernel's plain version on the card and against a
   float64 scipy product on the host, both within ``1e-5 * max|y_ref|``
   (f32 sums in another order);
8. times each kernel, its plain version and the cuSPARSE call on the same
   inputs (``torch.mv`` / ``@`` on a ``torch.sparse_csr_tensor``; timed
   only, never used by the port) with CUDA events, after warm-up, with L2
   flushed before every launch, and computes each kernel's bound from the
   bytes this run's product needs over 3.35 TB/s and its flops over 67
   TFLOP/s (for a descriptor kernel, whose ``xcol`` / ``yrow`` tables
   repeat each block's columns and rows, c ``xcol`` entries per block and
   one ``yrow`` entry; beside
   it the bound on the whole plan's bytes, the mask plan's bound for the
   same product and the mask kernel's time on the mask plan); both tail
   kernels beside their bounds (the 12-byte slots, padding included, X and
   Y), cuSPARSE on the tail alone and their plain versions, each launch
   printed, and the test layer's forwards beside the default layer's and
   cuSPARSE on the whole weight;
   the four panel SpMV kernels at batch 1 on the vocab layers, each beside
   its twin of the other lowering, the whole-vector mask pair at batch 1
   on its layer beside the mask panel pair, and for context plain torch
   sums reading the whole descriptor plan and the sectors its panel
   kernels read of it (``time_panels_desc.py`` times the panel kernels at
   other splits and ring lengths, the whole-vector pairs at other grids,
   threads and tiles);
9. prints its total time, the ``{"kernels": [...]}`` line (each kernel's
   ``value_dtypes``, the widths it launched at on the main path, and at
   bf16 / int8 its launches, errors and times in turns under
   ``quantised``, its launches in the serving phase under
   ``serve_launches``, in the sharding phase under ``shard_launches`` and
   in the LM launcher's run under ``lm_launches``), then, last, the
   ``{"ok": true, "device": ...}`` line; before them a ``{"sharding":
   ..., "examples": ...}`` line with the sharding phase's numbers and a
   ``{"lm_decode": ...}`` line with the LM phase's.

It needs the repository beside it (``src/repro_torch``) and a CUDA device;
it never runs on the CPU.
"""
from __future__ import annotations

import dataclasses
import json
import os
import re
import subprocess
import sys
import threading
import time
import warnings

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "src"))

#: H100 SXM published peaks (NVIDIA data sheet, dense): HBM3 bandwidth and
#: f32 rate outside the tensor cores, at the full 700 W power limit.
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12

TOL = 1e-5                       # |y - y_ref| <= TOL * max|y_ref|
FLUSH_BYTES = 512 * 2**20        # > 50 MB L2, and keeps the card busy while
                                 # the host enqueues the timed launch
REPS = 30

MATRIX = dict(dim=200_000, bs=4, blocks_per_row=12, seed=5, rc=(4, 4))
GEOM = {"whole_vector": dict(cb=256), "panels": dict(pr=512, cb=64, xw=512)}
#: yi-6b's vocab projection (src/repro/configs/yi_6b.py: vocab 64,000,
#: d_model 4,096) as serve.py's vocab bench builds it, pruned to 10 %.
VOCAB = dict(rows=64_000, cols=4_096, density=0.1, block=(4, 8), seed=0,
             nvec=128)
SPMM_NVECS = (16, 128)
SPMM_KERNELS = {
    # name: (layout, double_buffer, the Pallas function it replaces)
    "spmm_cuda_panels_db": ("panels", True,
                            "src/repro/kernels/spc5_spmm.py:449"),
    "spmm_cuda_panels": ("panels", False,
                         "src/repro/kernels/spc5_spmm.py:309"),
    "spmm_cuda": ("whole_vector", False,
                  "src/repro/kernels/spc5_spmm.py:140"),
}
KERNELS = {
    # name: (layout, lowering, double_buffer, the Pallas function it
    # replaces)
    "spmv_cuda_db": ("whole_vector", "mask", True,
                     "src/repro/kernels/spc5_spmv.py:1000"),
    "spmv_cuda": ("whole_vector", "mask", False,
                  "src/repro/kernels/spc5_spmv.py:223"),
    "spmv_cuda_panels_db": ("panels", "mask", True,
                            "src/repro/kernels/spc5_spmv.py:490"),
    "spmv_cuda_panels": ("panels", "mask", False,
                         "src/repro/kernels/spc5_spmv.py:376"),
    "spmv_cuda_desc_db": ("whole_vector", "descriptor", True,
                          "src/repro/kernels/spc5_spmv.py:729"),
    "spmv_cuda_desc": ("whole_vector", "descriptor", False,
                       "src/repro/kernels/spc5_spmv.py:657"),
    "spmv_cuda_panels_desc_db": ("panels", "descriptor", True,
                                 "src/repro/kernels/spc5_spmv.py:925"),
    "spmv_cuda_panels_desc": ("panels", "descriptor", False,
                              "src/repro/kernels/spc5_spmv.py:824"),
}
SOURCE = {"mask": "src/repro_torch/kernels/csrc/spc5_spmv.cu",
          "descriptor": "src/repro_torch/kernels/csrc/spc5_spmv_desc.cu"}
SPMM_SOURCE = "src/repro_torch/kernels/csrc/spc5_spmm.cu"
DESC_SPMM_KERNELS = {
    # name: (layout, double_buffer, the Pallas function it replaces)
    "spmm_cuda_panels_desc_db": ("panels", True,
                                 "src/repro/kernels/spc5_spmm.py:768"),
    "spmm_cuda_panels_desc": ("panels", False,
                              "src/repro/kernels/spc5_spmm.py:654"),
    "spmm_cuda_desc": ("whole_vector", False,
                       "src/repro/kernels/spc5_spmm.py:546"),
}
DESC_SPMM_SOURCE = "src/repro_torch/kernels/csrc/spc5_spmm_desc.cu"
#: The mask kernel each descriptor SpMM kernel is timed beside.
MASK_TWIN = {"spmm_cuda_panels_desc_db": "spmm_cuda_panels_db",
             "spmm_cuda_panels_desc": "spmm_cuda_panels",
             "spmm_cuda_desc": "spmm_cuda"}
#: Matrices whose whole-vector descriptor xcol (ncols) or yrow (nrows)
#: bound needs int32 tables.
WIDE_TALL = {"wide": (300, 40_000), "tall": (40_000, 300)}
#: The test split's tail kernels: SpMV, and the bucketed SpMM tail, which
#: replaces no TPU kernel (the reference computes it with jnp).
TAIL_KERNEL = "spmv_tail_cuda"
SPMM_TAIL_KERNEL = "spmm_tail_cuda"
TAIL_SOURCE = "src/repro_torch/kernels/csrc/spc5_spmv_tail.cu"
TAIL_REPLACES = "src/repro/kernels/spc5_spmv.py:558"
SPMM_TAIL_REPLACES = ("no TPU kernel (the reference's jnp spmm_coo, "
                      "src/repro/core/ref_spmv.py:352)")
#: beta(2,4), one of the two shapes the reference's bench runs the paper's
#: beta_test variants on (benchmarks/bench_spmv_seq.py:207-217).
TEST_BLOCK = (2, 4)


#: Itanium mangling of the kernels' vidx and value type parameters (int8
#: is the same ``a`` in both).
INDEX_TYPE = {"a": "int8", "s": "int16", "i": "int32", "f": "f32",
              "13__nv_bfloat16": "bf16"}

#: Registers per thread of each kernel, from the build's ``-Xptxas -v``
#: report (``build_kernels``), by the label it prints.
REGISTERS = {}


class SmokeFailure(Exception):
    pass


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def start_build():
    """Start building every kernel (``_build.build_all``: one nvcc process a
    source, all together) in a thread, so that host work goes on beside it.
    Returns a function that waits for the build, raises what it raised and
    prints its report (:func:`build_kernels`)."""
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    done = {}

    def run():
        try:
            _build.build_all()
        except BaseException as e:  # re-raised by the caller's wait
            done["error"] = e
        done["seconds"] = time.perf_counter() - t0

    thread = threading.Thread(target=run, daemon=True)
    thread.start()

    def wait():
        thread.join()
        if "error" in done:
            raise done["error"]
        report_build(done["seconds"])
    return wait


def build_kernels() -> None:
    start_build()()


def report_build(seconds) -> None:
    """Print the build's time and each kernel's registers (``-Xptxas -v``),
    keeping them in :data:`REGISTERS`."""
    from repro_torch.kernels import _build
    print(f"build: {seconds:.2f} s (nvcc {' '.join(_build.NVCC_FLAGS)})")
    for name, rec in _build.BUILD_LOG.items():
        print(f"  {name}: nvcc {rec['seconds']:.2f} s")
        kernel = ""
        for line in str(rec["log"]).splitlines():
            if "Compiling entry function" in line:
                m = re.search(r"(sp(?:mv|mm)(?:(?:_desc)?_(?:whole|panels)"
                              r"(?:_cmap)?|_tail)_kernel)I(?:NS_\d+(\w+?)E)?"
                              r"((?:Li\d+E|[asif]|13__nv_bfloat16)+)E", line)
                if m:
                    targs = [n or INDEX_TYPE[t] for n, t in re.findall(
                        r"Li(\d+)E|(13__nv_bfloat16|[asif])", m.group(3))]
                    policy = m.group(2)
                    if policy:  # a policy of the value store: *Whole<T>
                        policy = re.sub(
                            r"I(13__nv_bfloat16|[asif])E$",
                            lambda t: f"<{INDEX_TYPE[t.group(1)]}>", policy)
                    kernel = (f"{m.group(1)}<"
                              f"{','.join(([policy] if policy else []) + targs)}>")
                else:
                    kernel = line.split("'")[1]
            elif "Used" in line and kernel:
                print(f"    {kernel}: {line.split(':', 1)[1].strip()}")
                regs = re.search(r"Used (\d+) registers", line)
                if regs:
                    REGISTERS[kernel] = int(regs.group(1))
    if not _build.BUILD_LOG:
        print("  loaded from an earlier build")


def tail_y(plan, x):
    """A test plan's singleton tail times x (1-D) or X (2-D), in plain
    PyTorch: for panel buckets ``spmv_coo_panels`` / ``spmm_coo_panels``
    (the tail kernels' plain versions), for a flat tail ``spmv_coo`` /
    ``spmm_coo``. For an f64 x the values are upcast to f64 first."""
    from repro_torch.core import ref_spmv as R
    rows, cols, vals = plan.single_rows, plan.single_cols, plan.single_values
    if x.dtype != vals.dtype and x.element_size() > 4:
        vals = vals.to(x.dtype)  # an f64 product: the values upcast, exactly
    if plan.tail_pr:
        fn = R.spmv_coo_panels if x.dim() == 1 else R.spmm_coo_panels
        return fn(rows, cols, vals, x, pr=plan.tail_pr, nrows=plan.nrows)
    fn = R.spmv_coo if x.dim() == 1 else R.spmm_coo
    return fn(rows, cols, vals, x, nrows=plan.nrows)


def tail_launch(plan, nvec=None, x=None, **forced):
    """The launch a tail wrapper makes on the plan's buckets: the SpMV
    kernel's (``nvec`` None: S, grid, threads, shared bytes, groups, CTAs
    per SM) or the SpMM kernel's at batch nvec on X (G, grid, tile, columns
    a lane, threads, Y-tile rows, shared bytes, CTAs per SM), each with the
    kernel's registers (``-Xptxas -v``); ``forced``: ``split`` or ``grid``.
    On the CPU only what needs no card."""
    from repro_torch.kernels import spc5_spmm as KM
    from repro_torch.kernels import spc5_spmv_tail as KT
    npanels, smax = plan.single_rows.shape
    vsize = plan.single_values.element_size()
    label = {4: "f32", 2: "bf16"}[vsize]
    if nvec is None:
        if plan.device.type != "cuda":
            return dict(threads=KT.TAIL_THREADS, smem_bytes=0,
                        groups=KT.tail_groups(smax))
        out = KT.tail_launch(npanels, smax, device=plan.device, vsize=vsize,
                             **forced)
        out["registers"] = REGISTERS.get(f"spmv_tail_kernel<{label}>")
        return out
    vec = KM.panels_vector(nvec, x)
    if plan.device.type != "cuda":
        return KT.spmm_tail_cta(nvec, vec, vsize)
    out = KT.spmm_tail_launch(npanels * smax, nvec, vec, device=plan.device,
                              vsize=vsize, **forced)
    out["registers"] = REGISTERS.get(
        f"spmm_tail_kernel<{label},{out['vector']}>")
    return out


def plain_y(plan, x, dtype=None):
    """The plain version of the plan's kernel: SpMV for a 1-D x, SpMM for a
    2-D X (for a test plan: its multi sub-plan's plus its tail's), an int8
    plan's ``value_scale`` applied. ``dtype`` (torch.float64): the same
    product with the stored values (upcast, then scaled), the scales and x
    in that dtype, e.g. the f64 product of a quantised plan's dequantised
    values. A reordered plan's kept ``col_perm`` maps the columns as its
    lowering does (the panel kernels' column map; x gathered first for the
    others); y stays in the kernels' row order (``row_iperm`` is the
    executor's, not a kernel's)."""
    from repro_torch.core import ref_spmv as R
    from repro_torch.core.plan import _plan_scale
    cmap = plan.col_perm
    if cmap is not None and plan.layout != "panels":
        x, cmap = x.index_select(0, cmap), None
    if plan.layout == "test":
        y = plain_y(plan.multi, x, dtype)
        xt = x if dtype is None else x.to(dtype)
        return y + tail_y(plan, xt) if plan.n_single else y
    dev, scale = plan.dev, _plan_scale(plan)
    if dtype is not None:
        dev = dev._replace(values=dev.values.to(dtype))
        scale = None if scale is None else scale.to(dtype)
        x = x.to(dtype)
    if plan.lowering == "descriptor":
        if plan.layout == "panels":
            fn = R.spmv_panels_desc if x.dim() == 1 else R.spmm_panels_desc
            return fn(dev, x, cmap, scale, pr=plan.pr, nrows=plan.nrows,
                      ncols_pad=plan.ncols_pad)
        fn = R.spmv_desc if x.dim() == 1 else R.spmm_desc
        return fn(dev, x, scale, nrows=plan.nrows)
    if plan.layout == "panels":
        fn = R.spmv_panels if x.dim() == 1 else R.spmm_panels
        return fn(dev, x, cmap, scale, r=plan.r, c=plan.c, pr=plan.pr,
                  nrows=plan.nrows, ncols_pad=plan.ncols_pad)
    fn = R.spmv if x.dim() == 1 else R.spmm
    return fn(dev, x, scale, r=plan.r, c=plan.c, nrows=plan.nrows,
              ncols=plan.ncols)


def value_label(plan) -> str:
    """The plan's value store as the register labels name it: f32, bf16 or
    int8."""
    return {4: "f32", 2: "bf16", 1: "int8"}[plan.values.element_size()]


def rel_err(y, y_ref) -> float:
    import torch
    y_ref = torch.as_tensor(y_ref, device=y.device)
    scale = max(float(y_ref.abs().max()), 1.0)
    return float((y.double() - y_ref.double()).abs().max()) / scale


SMALL_GEOM = {"whole_vector": dict(cb=16),
              "panels": dict(pr=64, xw=64, cb=16)}


def small_check(device) -> None:
    """All sixteen kernels against their plain versions, every block
    shape, several chunks and panels (302x260, cb=16, pr=xw=64); the SpMM
    kernels at nvec 3, 16 and 128; the descriptor kernels also on the
    :data:`WIDE_TALL` matrices, whose whole-vector xcol / yrow tables are
    int32."""
    import torch
    from repro_torch.core import formats as F
    from repro_torch.kernels import ops
    worst = 0.0
    cases = [(rc, (302, 260), 0.08) for rc in F.SUPPORTED_BLOCKS]
    cases += [((2, 4), shape, 3e-3) for shape in WIDE_TALL.values()]
    for rc, (n, m), density in cases:
        rng = np.random.default_rng(10 * rc[0] + rc[1] + n)
        d = ((rng.random((n, m)) < density)
             * rng.standard_normal((n, m))).astype(np.float32)
        mat = F.csr_to_spc5(F.csr_from_dense(d), *rc)
        x = torch.from_numpy(rng.standard_normal(m).astype(np.float32))
        x = x.to(device)
        plans = {(layout, lowering): ops.prepare(
                    mat, layout=layout, lowering=lowering, tune=False,
                    device=device, **geom)
                 for layout, geom in SMALL_GEOM.items()
                 for lowering in ("mask", "descriptor")}
        wide_tall = (n, m) in WIDE_TALL.values()
        if wide_tall:
            table = "desc_xcol" if m > n else "desc_yrow"
            dtype = getattr(plans["whole_vector", "descriptor"], table).dtype
            if dtype != torch.int32:
                raise SmokeFailure(f"small check: {n}x{m} {table} is {dtype}")
        runs = [(name, (layout, lowering), x, lambda p, v, db=db: ops.spmv(
                    p, v, double_buffer=db))
                for name, (layout, lowering, db, _) in KERNELS.items()
                if lowering == "descriptor" or not wide_tall]
        for nvec in (3, 16, 128):
            xm = torch.from_numpy(rng.standard_normal(
                (m, nvec)).astype(np.float32)).to(device)
            spmm = [(name, (layout, "descriptor"), db)
                    for name, (layout, db, _) in DESC_SPMM_KERNELS.items()]
            if not wide_tall:
                spmm += [(name, (layout, "mask"), db)
                         for name, (layout, db, _) in SPMM_KERNELS.items()]
            runs += [(f"{name} nvec={nvec}", key, xm,
                      lambda p, v, db=db: ops.spmm(p, v, double_buffer=db))
                     for name, key, db in spmm]
        for name, key, v, run in runs:
            err = rel_err(run(plans[key], v), plain_y(plans[key], v))
            worst = max(worst, err)
            if not err <= TOL:
                raise SmokeFailure(f"small check: {name} {rc} {n}x{m} rel "
                                   f"err {err}")
    worst = max(worst, small_check_tail(device))
    worst = max(worst, small_check_quantised(device))
    worst = max(worst, small_check_cmap(device))
    nkernels = (len(KERNELS) + len(SPMM_KERNELS) + len(DESC_SPMM_KERNELS)
                + 2)
    print(f"small check: {nkernels} kernels: {nkernels - 2} x "
          f"{len(F.SUPPORTED_BLOCKS)} block shapes (SpMM at nvec 3, 16, 128), "
          f"the 7 descriptor kernels on the {' and '.join(WIDE_TALL)} "
          f"matrices (int32 xcol / yrow), {TAIL_KERNEL} and "
          f"{SPMM_TAIL_KERNEL} (nvec 3, 16, 128) on {len(TAIL_SMALL)} bucket "
          f"geometries at f32 and bf16, each also at S = 1 / G = 1 and one "
          f"group a CTA; all agree with the plain versions (worst "
          f"{worst:.3g} of max|y|)")


#: The kernels the vocab layers run at bf16 and int8, each with the layer
#: (layout, lowering) it runs on: the four panel descriptor kernels and the
#: seven mask kernels.
QUANTISED = {
    "spmv_cuda_panels_desc_db": ("panels", "descriptor"),
    "spmv_cuda_panels_desc": ("panels", "descriptor"),
    "spmm_cuda_panels_desc_db": ("panels", "descriptor"),
    "spmm_cuda_panels_desc": ("panels", "descriptor"),
    "spmv_cuda_panels_db": ("panels", "mask"),
    "spmv_cuda_panels": ("panels", "mask"),
    "spmm_cuda_panels_db": ("panels", "mask"),
    "spmm_cuda_panels": ("panels", "mask"),
    "spmv_cuda_db": ("whole_vector", "mask"),
    "spmv_cuda": ("whole_vector", "mask"),
    "spmm_cuda": ("whole_vector", "mask"),
}
#: The whole-vector descriptor kernels, which the token plan runs at bf16 and
#: int8 (:func:`build_token_plan`).
TOKEN_QUANTISED = {
    "spmv_cuda_desc_db": ("whole_vector", "descriptor"),
    "spmv_cuda_desc": ("whole_vector", "descriptor"),
    "spmm_cuda_desc": ("whole_vector", "descriptor"),
}
#: Every kernel that takes int8 values, and bf16: the small check's.
SMALL_QUANTISED = {**QUANTISED, **TOKEN_QUANTISED}
VDTYPES = ("bf16", "int8")
#: The widths each tail kernel takes: the test layout keeps a bf16 plan's
#: tail in bf16 and an int8 plan's in f32 (the reference's rule: a tail has
#: no scale).
TAIL_VDTYPES = ("bf16",)


def live_chunks(plan):
    """Which chunks hold a block (a set mask bit or valid lane)."""
    t = plan.desc_valid if plan.lowering == "descriptor" else plan.chunk_mask
    return t.reshape(*plan.chunk_vbase.shape, -1).ne(0).any(-1)


def spans_past_values(plan):
    """Whether a narrow window's 16-byte aligned span reaches past the
    plan's values (``spc5_spmv.value_span``; the kernels copy such a span
    up to the values' end)."""
    from repro_torch.kernels import spc5_spmv as K
    vsize, nvalues = plan.values.element_size(), plan.values.numel()
    return any(K.value_span(vb, plan.vmax, vsize, nvalues)[2]
               > nvalues * vsize
               for vb in plan.chunk_vbase.flatten().tolist())


def small_check_quantised(device) -> float:
    """The fourteen :data:`SMALL_QUANTISED` kernels at bf16 and int8 against
    their plain versions on every block shape (302x260, :data:`SMALL_GEOM`:
    the panel and whole-vector plans of both lowerings), the SpMV
    kernels at their planned launch, S = 1 / G = 1 and one chunk a CTA, the
    SpMM kernels at nvec 3, 16 and 128 at their planned launch and S = 1 /
    G = 1. The first 64 rows' values are zeros kept as nonzeros, so their
    chunks are all zero and take scale 1.0; some int8 windows start off a
    16-byte boundary, and some int8 plans' last span would reach past their
    values (the kernels cut it short). Returns the worst error over
    max|y|."""
    import torch
    from repro_torch.core import formats as F
    from repro_torch.kernels import ops
    worst, unaligned, reaching = 0.0, 0, 0
    layers = sorted(set(SMALL_QUANTISED.values()))
    for rc in F.SUPPORTED_BLOCKS:
        rng = np.random.default_rng(7 * rc[0] + rc[1])
        d = ((rng.random((302, 260)) < 0.08)
             * rng.standard_normal((302, 260))).astype(np.float32)
        csr = F.csr_from_dense(d)
        csr.values[:csr.rowptr[64]] = 0.0       # all-zero chunks, kept
        mat = F.csr_to_spc5(csr, *rc)
        x = torch.from_numpy(rng.standard_normal(260).astype(
            np.float32)).to(device)
        xs = {n: torch.from_numpy(rng.standard_normal((260, n)).astype(
            np.float32)).to(device) for n in (3, 16, 128)}
        for vdtype in VDTYPES:
            plans = {(layout, lowering): ops.prepare(
                        mat, layout=layout, lowering=lowering, vdtype=vdtype,
                        tune=False, device=device, **SMALL_GEOM[layout])
                     for layout, lowering in layers}
            for key, plan in plans.items():
                if vdtype != "int8":
                    continue
                vbase = plan.chunk_vbase.cpu().numpy()
                unaligned += int(np.count_nonzero(vbase % 16))
                reaching += spans_past_values(plan)
                if not bool(((plan.value_scale == 1.0)
                             & live_chunks(plan)).any()):
                    raise SmokeFailure(f"small check: {rc} int8 {key} has no "
                                       f"all-zero chunk of scale 1.0")
            for name, key in SMALL_QUANTISED.items():
                plan = plans[key]
                spmm = name.startswith("spmm")
                n = int(plan.chunk_vbase.shape[-1])
                force = "grid" if key[0] == "whole_vector" else "split"
                forced = (None, 1) if spmm else (None, 1, n)
                for v in (xs.values() if spmm else (x,)):
                    want = plain_y(plan, v)
                    for f in forced:
                        got = kernel_call(name, plan, v, **(
                            {} if f is None else {force: f}))()
                        err = rel_err(got, want)
                        worst = max(worst, err)
                        if (tuple(got.shape) != tuple(want.shape)
                                or not err <= TOL):
                            raise SmokeFailure(
                                f"small check: {name} {vdtype} {rc} "
                                f"{tuple(v.shape)} {force}={f}: rel err "
                                f"{err}")
    if not unaligned:
        raise SmokeFailure("small check: no int8 window starts off a 16-byte "
                           "boundary")
    if not reaching:
        raise SmokeFailure("small check: no int8 plan's last span reaches "
                           "past its values")
    print(f"  quantised: the {len(SMALL_QUANTISED)} quantised kernels (7 "
          f"descriptor, 7 mask) at bf16 and int8 x {len(F.SUPPORTED_BLOCKS)} "
          f"block shapes (SpMV at the planned launch, S / G = 1, one chunk a "
          f"CTA; SpMM nvec 3, 16, 128 at the planned launch, S / G = 1), "
          f"all-zero chunks at scale 1.0, {unaligned} int8 windows off a "
          f"16-byte boundary, {reaching} int8 plans whose last span would "
          f"reach past their values; worst {worst:.3g} of max|y|")
    return worst


#: The tail kernel's small geometries: the reference's tail test
#: (tests/test_plan.py:312-330), nrows % pr != 0, and buckets spanning more
#: than 12,288 columns (48 KB of f32).
TAIL_SMALL = {
    "powerlaw(320)": ("powerlaw", 320, dict(pr=16, xw=32, cb=8)),
    "powerlaw(330)": ("powerlaw", 330, dict(pr=16, xw=32, cb=8)),
    "300x40000": ("wide", 300, dict(pr=64, xw=512, cb=16)),
}


def small_check_tail(device) -> float:
    """``spmv_tail_cuda`` against ``spmv_coo_panels`` and ``spmm_tail_cuda``
    against ``spmm_coo_panels`` (nvec 3, 16 and 128) on each
    :data:`TAIL_SMALL` geometry in beta(2,4), f32 and bf16 (the test plan
    built at ``vdtype="bf16"``: bf16 buckets), each at its planned launch,
    at S = 1 / G = 1 and at one group of slots a CTA, and the whole test
    plan's SpMV and SpMM against their plain versions. Returns the worst
    error over max|y|."""
    import torch
    from repro_torch.core import formats as F
    from repro_torch.core import matgen
    from repro_torch.kernels import ops
    from repro_torch.kernels import spc5_spmv_tail as KT
    worst = 0.0
    for (label, (kind, n, geom)), vdtype in (
            (case, v) for case in TAIL_SMALL.items()
            for v in ("f32", *TAIL_VDTYPES)):
        if kind == "powerlaw":
            csr = matgen.powerlaw(n, 5, seed=17)
        else:
            rng = np.random.default_rng(3)
            m = WIDE_TALL["wide"][1]
            csr = F.csr_from_dense(((rng.random((n, m)) < 3e-3)
                                    * rng.standard_normal((n, m)))
                                   .astype(np.float32))
        plan = ops.prepare(F.csr_to_spc5(csr, *TEST_BLOCK), layout="test",
                           multi_layout="panels", lowering="mask",
                           tune=False, device=device, vdtype=vdtype, **geom)
        if plan.single_values.dtype != (torch.bfloat16 if vdtype == "bf16"
                                        else torch.float32):
            raise SmokeFailure(f"small check: {label} {vdtype} tail is "
                               f"{plan.single_values.dtype}")
        smax = int(plan.single_rows.shape[1])
        shape = dict(nrows=plan.nrows, pr=plan.tail_pr, xw=plan.tail_xw,
                     smax=smax)
        if ((kind == "wide" and plan.tail_xw <= 12_288)
                or (n == 330 and n % plan.tail_pr == 0)):
            raise SmokeFailure(f"small check: tail geometry {label} is "
                               f"{shape}")
        rng = np.random.default_rng(5)
        x = torch.from_numpy(rng.standard_normal(plan.ncols).astype(
            np.float32)).to(device)
        buckets = (plan.single_rows, plan.single_cols, plan.single_values)
        kw = dict(pr=plan.tail_pr, xw=plan.tail_xw, nrows=plan.nrows,
                  ncols_pad=plan.tail_ncols_pad)
        runs = [(f"{TAIL_KERNEL} S={split}", KT.spmv_tail_cuda(
                    plan.tail_xbase, *buckets, x, **kw,
                    **({} if split is None else {"split": split})),
                 tail_y(plan, x))
                for split in (None, 1, KT.tail_groups(smax))]
        runs.append(("plan SpMV", ops.spmv(plan, x), plain_y(plan, x)))
        for nvec in (3, 16, 128):
            xm = torch.from_numpy(rng.standard_normal(
                (plan.ncols, nvec)).astype(np.float32)).to(device)
            plain = tail_y(plan, xm)
            runs += [(f"{SPMM_TAIL_KERNEL} nvec={nvec} G={grid}",
                      KT.spmm_tail_cuda(
                          *buckets, xm, pr=plan.tail_pr, nrows=plan.nrows,
                          **({} if grid is None else {"grid": grid})), plain)
                     for grid in (None, 1,
                                  KT.tail_groups(plan.single_rows.numel()))]
            runs.append((f"plan SpMM nvec={nvec}", ops.spmm(plan, xm),
                         plain_y(plan, xm)))
        for what, got, want in runs:
            err = rel_err(got, want)
            worst = max(worst, err)
            if tuple(got.shape) != tuple(want.shape) or not err <= TOL:
                raise SmokeFailure(f"small check: {what} {label} {vdtype} "
                                   f"{shape}: rel err {err}")
        print(f"  tail kernels {label} {vdtype}: {shape}; launches "
              f"{tail_launch(plan)}, nvec=16 {tail_launch(plan, 16)}")
    return worst


def make_matrix(dim=MATRIX["dim"]):
    from repro_torch.core import formats as F
    from repro_torch.core import matgen
    t0 = time.perf_counter()
    csr = matgen.fem_blocks(dim, MATRIX["bs"], MATRIX["blocks_per_row"],
                            seed=MATRIX["seed"])
    t1 = time.perf_counter()
    mat = F.csr_to_spc5(csr, *MATRIX["rc"])
    t2 = time.perf_counter()
    print(f"matrix: fem_blocks({dim}, {MATRIX['bs']}, "
          f"{MATRIX['blocks_per_row']}, seed={MATRIX['seed']}) -> beta"
          f"{MATRIX['rc']}: {csr.nnz} nnz, {mat.nblocks} blocks "
          f"(host: generator {t1 - t0:.1f} s, csr_to_spc5 {t2 - t1:.1f} s)")
    return csr, mat


LOWERINGS = ("mask", "descriptor")


def check_auto_lowering(mat, device) -> None:
    """``lowering="auto"`` must resolve to the descriptor lowering by the
    cost model, as the reference resolves it for this matrix."""
    from repro_torch.kernels import ops
    plan = ops.prepare(mat, lowering="auto", tune=False, device=device)
    entry = next(e for e in plan.trace if e["pass"] == "layout")
    print(f"auto lowering: layout pass {json.dumps(entry, sort_keys=True)}")
    if (entry["lowering"], entry.get("lowering_reason")) != ("descriptor",
                                                            "cost-model"):
        raise SmokeFailure(f"lowering='auto' resolved to {entry}")


def panel_launches(plan):
    """The launches the two panel SpMV wrappers of the plan's lowering make
    on it (``panels_launch`` of :mod:`spc5_spmv` or :mod:`spc5_spmv_desc`):
    stages, shared memory and threads per CTA, the card's CTAs per SM, S,
    the grid and the kernel's registers (for the descriptor kernels also
    blocks per stage). On the CPU only the shared-memory plan (no card to
    ask for occupancy)."""
    from repro_torch.kernels import spc5_spmv as K
    from repro_torch.kernels import spc5_spmv_desc as KD
    desc = plan.lowering == "descriptor"
    mod = KD if desc else K
    out = {}
    vsize = plan.values.element_size()
    for name, stages in (("s1", 1), ("s2", mod.DB_STAGES)):
        if desc:
            geom = dict(cb=plan.cb, r=plan.r, c=plan.c, vmax=plan.vmax,
                        xw=plan.xw, pr=plan.pr,
                        wv=plan.desc_vidx.element_size(),
                        wx=plan.desc_xcol.element_size())
        else:
            geom = dict(cb=plan.cb, r=plan.r, vmax=plan.vmax, pr=plan.pr)
        if plan.device.type == "cuda":
            out[name] = mod.panels_launch(
                stages, plan.npanels, plan.nchunks, device=plan.device,
                **geom, vsize=vsize)
            kernel = (f"spmv_desc_panels_kernel<{value_label(plan)}," if desc
                      else f"spmv_panels_kernel<{value_label(plan)},")
            out[name]["registers"] = REGISTERS.get(
                f"{kernel}{out[name]['stages']}>")
        elif desc:
            s, nb, smem = KD.panels_stages(stages, *geom.values(),
                                           vsize=vsize)
            out[name] = dict(stages=s, blocks_per_stage=nb, smem_bytes=smem)
        else:
            s, smem = K.panels_stages(stages, plan.cb, plan.vmax, plan.pr,
                                      vsize=vsize)
            out[name] = dict(stages=s, smem_bytes=smem,
                             threads=K.panel_threads(plan.cb, plan.r))
    return out


#: The whole-vector SpMV pair of each lowering, also held at forced grids
#: (:func:`check_whole_grids`): kernel -> its entry in
#: :func:`whole_launches`.
WHOLE_DESC_SPMV = {"spmv_cuda_desc_db": "s2", "spmv_cuda_desc": "s1"}
WHOLE_MASK_SPMV = {"spmv_cuda_db": "s2", "spmv_cuda": "s1"}
WHOLE_SPMV = {"descriptor": WHOLE_DESC_SPMV, "mask": WHOLE_MASK_SPMV}


def whole_launches(plan):
    """The launches the whole-vector SpMV wrappers of the plan's lowering
    make on it (``whole_launch`` of :mod:`spc5_spmv_desc` or
    :mod:`spc5_spmv`): grid, chunks a CTA, threads, shared bytes, ring
    length (stages), tile rows (for the descriptor kernels also blocks a
    stage), the card's CTAs per SM and the kernel's registers. On the CPU
    only the shared-memory plan (no card to ask for occupancy)."""
    from repro_torch.kernels import spc5_spmv as K
    from repro_torch.kernels import spc5_spmv_desc as KD
    nchunks = int(plan.chunk_vbase.shape[0])
    desc = plan.lowering == "descriptor"
    vsize = plan.values.element_size()
    if desc:
        mod, kernel = KD, f"spmv_desc_whole_kernel<{value_label(plan)},"
        geom = dict(cb=plan.cb, r=plan.r, c=plan.c, vmax=plan.vmax,
                    wv=plan.desc_vidx.element_size(),
                    wx=plan.desc_xcol.element_size(), vsize=vsize)
    else:
        mod, kernel = K, f"spmv_whole_kernel<{value_label(plan)},"
        geom = dict(cb=plan.cb, r=plan.r, vmax=plan.vmax, vsize=vsize)
    out = {}
    for name, stages in (("s1", 1), ("s2", mod.WHOLE_DB_STAGES)):
        if plan.device.type == "cuda":
            out[name] = mod.whole_launch(stages, nchunks, device=plan.device,
                                         **geom)
            out[name]["registers"] = REGISTERS.get(
                f"{kernel}{out[name]['stages']}>")
        elif desc:
            s, nb, smem = KD.whole_stages(stages, tile=KD.WHOLE_TILE_ROWS,
                                          **geom)
            out[name] = dict(stages=s, blocks_per_stage=nb, smem_bytes=smem)
        else:
            threads = K.whole_threads(plan.cb, plan.r, plan.vmax)
            out[name] = dict(stages=stages, threads=threads,
                             tile_rows=K.WHOLE_TILE_ROWS,
                             smem_bytes=K.whole_smem_bytes(
                                 stages, plan.cb, plan.vmax,
                                 K.WHOLE_TILE_ROWS, threads, vsize))
    return out


def print_plan(name, plan) -> None:
    """Geometry, the kernels' dynamic shared memory per CTA (ptxas reports
    only static shared memory, which is 0) and, for a descriptor plan, the
    tables' dtypes and bytes; for a panel plan the SpMV kernels' launches
    (:func:`panel_launches`: S, grid, CTAs per SM, registers)."""
    g = {k: getattr(plan, k) for k in ("cb", "vmax", "pr", "xw", "ncols_pad",
                                       "npanels", "nchunks",
                                       "desc_lane_nbytes")
         if k in dict(plan.meta)}
    if plan.layout == "whole_vector":
        g["nchunks"] = int(plan.chunk_vbase.shape[0])
    g["spmv_launch"] = (panel_launches(plan) if plan.layout == "panels"
                        else whole_launches(plan))
    if plan.lowering == "descriptor":
        tables = [getattr(plan, f"desc_{t}")
                  for t in ("valid", "vidx", "xcol", "yrow")]
        g["tables"] = "/".join(str(t.dtype).replace("torch.", "")
                               for t in tables)
        g["table_bytes"] = sum(t.numel() * t.element_size() for t in tables)
    g["plan_bytes"] = sum(a.numel() * a.element_size() for a in plan.arrays)
    print(f"plan {name}: {g}, build {plan.trace[-1]['duration_s']:.1f} s")


def drive(mat, x, device):
    """The main path, through the entry points a user calls: both layouts
    and both lowerings. Returns the plans (keyed by layout and lowering),
    each kernel's y and the launch counts of this run alone."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.kernels import spc5_spmv as K
    from repro_torch.kernels import spc5_spmv_desc as KD
    K.reset_launches()
    KD.reset_launches()
    plans, ys = {}, {}
    for layout, geom in GEOM.items():
        for lowering in LOWERINGS:
            plans[layout, lowering] = ops.prepare(
                mat, layout=layout, lowering=lowering, tune=False,
                device=device, **geom)
    for name, (layout, lowering, db, _) in KERNELS.items():
        ys[name] = ops.spmv(plans[layout, lowering], x, double_buffer=db)
    if device.type == "cuda":
        torch.cuda.synchronize()
    launches = {**K.LAUNCHES, **KD.LAUNCHES}
    for (layout, lowering), plan in plans.items():
        print_plan(f"{layout} {lowering}", plan)
    return plans, ys, launches


def check_y(name, y, plan, x, y64, launches, path):
    """The kernel launched on its path, and y is finite, of the right shape
    and within tolerance of the plain version and of the f64 product.
    Returns max|y - plain|."""
    import torch
    if launches.get(name, 0) <= 0:
        raise SmokeFailure(f"{name} was not launched on the {path} "
                           f"(counts {launches})")
    if tuple(y.shape) != (plan.nrows,) or not bool(torch.isfinite(y).all()):
        raise SmokeFailure(f"{name}: bad output {tuple(y.shape)}")
    plain = plain_y(plan, x)
    abs_err = float((y - plain).abs().max())
    e_plain, e64 = rel_err(y, plain), rel_err(y, torch.from_numpy(y64))
    print(f"check {name} ({path}): max|y - plain| = {abs_err:.3g} "
          f"({e_plain:.3g} of max|y|), vs f64 scipy {e64:.3g} of max|y|")
    if not (e_plain <= TOL and e64 <= TOL):
        raise SmokeFailure(f"{name} disagrees: {e_plain} / {e64} > {TOL}")
    return abs_err


#: The mask panel SpMV kernels, also held at S = 1 (:func:`check_forced`).
MASK_PANEL_SPMV = ("spmv_cuda_panels_db", "spmv_cuda_panels")


def check_forced(name, plan, x, y64, path, **kw):
    """Kernel ``name`` with its wrapper's launch forced by ``kw`` (``split``
    of a panel kernel, ``grid`` of a whole-vector one) against the plain
    version and the f64 product, as :func:`check_y` holds the launch its
    wrapper picks. Not a launch of the path (its counts are already
    read)."""
    import torch
    y = kernel_call(name, plan, x, **kw)()
    e_plain = rel_err(y, plain_y(plan, x))
    e64 = rel_err(y, torch.from_numpy(y64))
    what = (", ".join(f"{k} = {v}" for k, v in kw.items())
            or "its wrapper's launch")
    print(f"check {name} at {what} ({path}): {e_plain:.3g} of max|y| from "
          f"the plain version, {e64:.3g} from f64 scipy")
    if not (tuple(y.shape) == (plan.nrows, *x.shape[1:]) and e_plain <= TOL
            and e64 <= TOL):
        raise SmokeFailure(f"{name} at {what} disagrees: {e_plain} / {e64} "
                           f"> {TOL}")


#: The panel SpMM pair of each lowering, also held at forced splits
#: (:func:`check_panel_spmm`).
PANEL_SPMM = {"descriptor": ("spmm_cuda_panels_desc_db",
                             "spmm_cuda_panels_desc"),
              "mask": ("spmm_cuda_panels_db", "spmm_cuda_panels")}


def check_panel_spmm(plan, x, y64, path, one_chunk=False):
    """Both panel SpMM kernels of the plan's lowering at X's batch: prints
    the launch each wrapper picks (:func:`spmm_panel_launches`) and holds
    each at it, at S = 1 and, where ``one_chunk``, at one chunk a CTA,
    against the plain version and the f64 product, each such launch printed
    too."""
    nvec = x.shape[1]
    splits = (None, 1) + ((plan.nchunks,) if one_chunk else ())
    for split in splits:
        launch = spmm_panel_launches(plan, nvec, split)
        for name in PANEL_SPMM[plan.lowering]:
            key = "s2" if name.endswith("_db") else "s1"
            print(f"launch {name} nvec={nvec} ({path}"
                  f"{'' if split is None else f', split = {split}'}): "
                  f"{launch[key]}")
            check_forced(name, plan, x, y64, path,
                         **({} if split is None else {"split": split}))


def check_whole_grids(plan, x, y64, path, one_cta=False):
    """Both whole-vector SpMV kernels of the plan's lowering at one chunk a
    CTA and, where ``one_cta``, at one CTA for every chunk; prints the
    launches the wrappers pick (:func:`whole_launches`)."""
    nchunks = int(plan.chunk_vbase.shape[0])
    launch = whole_launches(plan)
    for name, key in WHOLE_SPMV[plan.lowering].items():
        print(f"launch {name} ({path}): {launch[key]}")
        for grid in ((1, nchunks) if one_cta else (nchunks,)):
            check_forced(name, plan, x, y64, path, grid=grid)


#: The whole-vector SpMM kernel of each lowering.
WHOLE_SPMM = {"mask": "spmm_cuda", "descriptor": "spmm_cuda_desc"}


def check_whole_spmm(plan, x, y64, path):
    """The plan's whole-vector SpMM kernel at X's batch: at the launch its
    wrapper picks, at G = 1 and at one chunk a CTA, each launch printed
    (:func:`whole_spmm_launch`) and each Y held against the plain version
    and the f64 product (:func:`check_forced`)."""
    name = WHOLE_SPMM[plan.lowering]
    nvec = x.shape[1]
    for grid in (None, 1, int(plan.chunk_vbase.shape[0])):
        launch = whole_spmm_launch(plan, nvec, grid, x)
        print(f"launch {name} nvec={nvec} ({path}"
              f"{'' if grid is None else f', grid = {grid}'}): {launch}")
        check_forced(name, plan, x, y64, path,
                     **({} if grid is None else {"grid": grid}))


def check_fem_spmm(plans, csr, device, nvec=16):
    """Both whole-vector SpMM kernels on the FEM matrix's whole-vector plans
    (both lowerings) at batch ``nvec``, by :func:`check_whole_spmm`."""
    import torch
    x = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (csr.shape[1], nvec)).astype(np.float32)).to(device)
    y64 = f64_matrix(csr) @ x.cpu().double().numpy()
    for lowering in LOWERINGS:
        check_whole_spmm(plans["whole_vector", lowering], x, y64,
                         "FEM whole-vector plan")


def check(plans, ys, launches, x, y64):
    """Every kernel launched, and each y checked by :func:`check_y` (the
    mask panel kernels also at S = 1, both whole-vector pairs at G = 1 and
    one chunk a CTA)."""
    errs = {name: check_y(name, ys[name], plans[layout, lowering], x, y64,
                          launches, "SpMV path")
            for name, (layout, lowering, _, _) in KERNELS.items()}
    for name in MASK_PANEL_SPMV:
        check_forced(name, plans["panels", "mask"], x, y64, "SpMV path",
                     split=1)
    for lowering in LOWERINGS:
        check_whole_grids(plans["whole_vector", lowering], x, y64,
                          "SpMV path", one_cta=True)
    return errs


def cuda_time_ms(fn, device, reps=REPS, clean=False):
    """Median device time of ``fn`` in ms: CUDA events around each call,
    after warm-up, with the L2 cache flushed (a 512 MiB write) before
    every call. Prints the spread (min and max of the calls). ``clean``
    flushes by reading the 512 MiB instead, so that L2 holds clean lines
    and the call's reads evict nothing that must be written back (context:
    the main path's numbers all use the write)."""
    import torch
    flush = torch.empty(FLUSH_BYTES // 4, dtype=torch.float32, device=device)
    for _ in range(3):
        fn()
    times = []
    for _ in range(reps):
        if clean:
            flush.sum()
        else:
            flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    del flush
    print(f"    {reps} calls: min {min(times):.4f} ms, median "
          f"{float(np.median(times)):.4f} ms, max {max(times):.4f} ms")
    return float(np.median(times))


def needed_bytes(plan, whole_plan=False):
    """The bytes of the plan that the product must read: every array as
    built, padding included, except that a descriptor plan's ``xcol`` table
    repeats each block's c columns over its r rows, so the product needs
    only c ``xcol`` entries per block (``valid`` and ``vidx`` per lane).
    Its ``yrow`` table repeats each block's r rows over its c columns, and
    on every valid lane the row is the lane-0 entry plus k // c (in both
    layouts: the whole-vector layout clips lanes past nrows, and they are
    invalid; pinned by tests/test_torch_desc_panels.py and
    tests/test_torch_desc_whole.py), so one entry per block. ``whole_plan``
    counts every byte of the plan instead."""
    total = sum(a.numel() * a.element_size() for a in plan.arrays)
    if plan.lowering == "descriptor" and not whole_plan:
        rc = plan.r * plan.c
        for table, kept in (("desc_xcol", plan.c), ("desc_yrow", 1)):
            t = getattr(plan, table)
            total -= t.numel() * t.element_size() // rc * (rc - kept)
    return total


def bound(plan, nnz, nvec=1, whole_plan=False):
    """The least time for one SpMV (nvec = 1) or SpMM: the plan bytes the
    product needs (:func:`needed_bytes`) and X read once and Y written
    once, over the HBM rate; 2 flops per nonzero and column over the f32
    rate. Returns (ms, "bytes" | "operations", bytes)."""
    nbytes = (needed_bytes(plan, whole_plan)
              + 4 * nvec * (plan.ncols + plan.nrows))
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = 2 * nnz * nvec / F32_FLOP_PER_S
    return (1e3 * max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations", nbytes)


def desc_bounds(plan, mask_plan, nnz, nvec=1):
    """A descriptor kernel's two other bounds, printed and kept beside its
    own: the mask plan's for the same product, and one that reads every
    byte of the descriptor plan as built (the repeated ``xcol`` / ``yrow``
    entries too)."""
    out = {"mask_bound_ms": bound(mask_plan, nnz, nvec)[0],
           "plan_bound_ms": bound(plan, nnz, nvec, whole_plan=True)[0]}
    print(f"    mask plan's bound {out['mask_bound_ms']:.4f} ms, bound on "
          f"the whole descriptor plan's bytes {out['plan_bound_ms']:.4f} ms")
    return out


def scipy_csr(m, device):
    """A scipy CSR (a tail's) as a ``torch.sparse_csr_tensor``."""
    from repro_torch.core import formats as F
    return sparse_csr(F.CSRMatrix(m.shape, m.indptr, m.indices, m.data),
                      device)


def sparse_csr(csr, device, values=None, dtype=np.float32):
    """The CSR (or, with ``values``, its pattern with those values) as a
    ``torch.sparse_csr_tensor`` of ``dtype``: cuSPARSE, timed only, and
    the float64 products that checks compare with."""
    import torch
    with warnings.catch_warnings():     # "beta state" / invariant notices
        warnings.simplefilter("ignore", UserWarning)
        return torch.sparse_csr_tensor(
            torch.from_numpy(csr.rowptr.astype(np.int32)),
            torch.from_numpy(csr.colidx.astype(np.int32)),
            torch.from_numpy((csr.values if values is None else values)
                             .astype(dtype)),
            size=csr.shape, device=device)


def kernel_call(name, plan, x, values=None, **extra):
    """A call of kernel ``name``'s wrapper on the plan's arrays (an int8
    plan's ``value_scale`` too; ``values`` in place of the plan's where
    given) and x (``extra``: the wrapper's own keywords, e.g. ``split`` or
    ``col_map``)."""
    from repro_torch.core.plan import _plan_scale
    from repro_torch.kernels import spc5_spmm as KM
    from repro_torch.kernels import spc5_spmm_desc as KDM
    from repro_torch.kernels import spc5_spmv as K
    from repro_torch.kernels import spc5_spmv_desc as KD
    module = ({True: KDM, False: KM} if name.startswith("spmm")
              else {True: KD, False: K})["desc" in name]
    fn = getattr(module, name)
    args = ((plan.chunk_vbase, plan.chunk_xbase) if plan.layout == "panels"
            else (plan.chunk_vbase,))
    vals = plan.values if values is None else values
    if plan.lowering == "descriptor":
        args += (plan.desc_valid, plan.desc_vidx, plan.desc_xcol,
                 plan.desc_yrow, vals, x)
    else:
        args += (plan.chunk_col, plan.chunk_mask, plan.chunk_voff,
                 plan.chunk_row, vals, x)
    kw = dict(r=plan.r, c=plan.c, cb=plan.cb, vmax=plan.vmax,
              nrows=plan.nrows)
    kw.update(dict(xw=plan.xw, pr=plan.pr, ncols_pad=plan.ncols_pad)
              if plan.layout == "panels" else dict(ncols=plan.ncols))
    if _plan_scale(plan) is not None:
        kw["value_scale"] = _plan_scale(plan)
    return lambda: fn(*args, **kw, **extra)


def measure(plans, x, csr, launches, errs, timer=cuda_time_ms):
    import torch
    device = x.device
    csr_t = sparse_csr(csr, device)
    print("  timing cuSPARSE CSR (torch.mv on sparse_csr_tensor)")
    library_ms = timer(lambda: torch.mv(csr_t, x), device)
    plain_ms = {}
    for key, plan in plans.items():
        print(f"  timing the plain version, {key[0]} {key[1]}")
        plain_ms[key] = timer(lambda p=plan: plain_y(p, x), device)
    rows = []
    for name, (layout, lowering, db, replaces) in KERNELS.items():
        plan = plans[layout, lowering]
        print(f"  timing {name}")
        ms = timer(kernel_call(name, plan, x), device)
        bound_ms, bound_by, nbytes = bound(plan, csr.nnz)
        print(f"time {name}: {ms:.4f} ms, plain "
              f"{plain_ms[layout, lowering]:.4f} ms, cuSPARSE CSR "
              f"{library_ms:.4f} ms, bound {bound_ms:.4f} ms ({nbytes} "
              f"bytes)")
        row = {"name": name, "route": "cuda", "source": SOURCE[lowering],
               "replaces": replaces, "launches": launches[name],
               "max_abs_err": errs[name], "ms": ms,
               "plain_ms": plain_ms[layout, lowering], "bound_ms": bound_ms,
               "bound_by": bound_by, "library_ms": library_ms}
        if lowering == "descriptor":
            row.update(desc_bounds(plan, plans[layout, "mask"], csr.nnz))
        row["launch"] = (panel_launches(plan) if layout == "panels"
                         else whole_launches(plan))["s2" if db else "s1"]
        rows.append(row)
    return rows


# ----------------------------------------------------------------------------
# Sharded SpMV: row slabs, one shard after another on the card
# ----------------------------------------------------------------------------

#: The shard phase: 8 shards, the partition chosen by the nnz skew, and
#: ``benchmarks/bench_spmv_par.py``'s geometries (flat shards at cb=512,
#: panel shards at pr=1024 with the panel defaults cb=64, xw=512).
SHARD = dict(ndev=8, partition="auto")
SHARD_GEOM = {"whole_vector": dict(cb=512),
              "panels": dict(pr=1024, cb=64, xw=512)}
#: (matrix, layout, lowering, vdtype) of each sharded plan: both layouts x
#: both lowerings at f32 and whole-vector mask at bf16 on the FEM matrix,
#: and panels + mask on the band with its RCM Reordering.
SHARD_PLANS = (("fem", "whole_vector", "mask", "f32"),
               ("fem", "whole_vector", "descriptor", "f32"),
               ("fem", "panels", "mask", "f32"),
               ("fem", "panels", "descriptor", "f32"),
               ("fem", "whole_vector", "mask", "bf16"),
               ("band", "panels", "mask", "f32"))
SHARD_KERNEL = {("whole_vector", "mask"): "spmv_cuda_db",
                ("whole_vector", "descriptor"): "spmv_cuda_desc_db",
                ("panels", "mask"): "spmv_cuda_panels_db",
                ("panels", "descriptor"): "spmv_cuda_panels_desc_db"}


def shard_inputs(csr, x, vdtype):
    """The float64 references of a sharded product on ``csr``: the product
    of the values as the plan stores them (f32, or bf16-rounded) and, for
    bf16, ``tests/test_vdtype.py``'s pin with the product of the f32
    values it bounds. Returns (y64, None or (pin, y64 of the f32
    values))."""
    import scipy.sparse
    import torch
    xh = x.cpu().double().numpy()

    def product(vals, v=xh):
        return scipy.sparse.csr_matrix((vals, csr.colidx, csr.rowptr),
                                       shape=csr.shape) @ v
    vals = csr.values.astype(np.float32)
    y32 = product(vals.astype(np.float64))
    if vdtype != "bf16":
        return y32, None
    deq = torch.from_numpy(vals).to(torch.bfloat16).double().numpy()
    pin = 2.0 ** -7 * product(np.abs(vals).astype(np.float64),
                              np.abs(xh)) + 1e-5
    return product(deq), (pin, y32)


def sharded_y(sh, x):
    """y of a sharded plan on one card: every shard's
    ``local_execute_spmv`` one after another on x in the plan's column
    order, the slabs assembled by the gather path's helper
    (``distributed._assemble``), then put back in the original row
    order."""
    import torch
    from repro_torch.core import distributed as D
    from repro_torch.core import plan as PL
    xp = x if sh.col_perm is None else x.index_select(0, sh.col_perm)
    slabs = torch.stack([PL.local_execute_spmv(sh, sh.local(k), xp)
                         for k in range(sh.ndev)])
    y = D._assemble(slabs, sh.row_start, sh.nrows)
    return y if sh.row_iperm is None else y.index_select(0, sh.row_iperm)


def shard_one(name, csr, mat, layout, lowering, vdtype, reo, device,
              timer=cuda_time_ms):
    """One sharded plan (:data:`SHARD_PLANS`): built by ``shard_matrix``
    on the card, driven once with the counts at 0 (exactly ``ndev``
    launches of the layout's kernel, nothing else), held against the
    unsharded ``ops.spmv`` and the float64 product, then each shard
    timed. Returns its launches, error and times."""
    import torch
    from repro_torch.core import distributed as D
    from repro_torch.core import plan as PL
    from repro_torch.kernels import ops
    kw = dict(layout=layout, lowering=lowering, vdtype=vdtype, tune=False,
              reorder=reo, **SHARD_GEOM[layout])
    t0 = time.perf_counter()
    sh = D.shard_matrix(mat, SHARD["ndev"], partition=SHARD["partition"],
                        device=device, **kw)
    t1 = time.perf_counter()
    plan = ops.prepare(mat, device=device, **kw)
    part = next(e for e in sh.trace if e["pass"] == "partition")
    print(f"shard {name}: shard_matrix {t1 - t0:.1f} s of host, partition "
          f"{part['mode']} (skew blocks {part['skew_blocks']}, nnz "
          f"{part['skew_nnz']}), rows_max {sh.rows_max}, row starts "
          f"{sh.row_start.tolist()}, "
          f"{sum(a.numel() * a.element_size() for a in sh.arrays)} bytes "
          f"of stacks; unsharded plan {plan.layout} + {plan.lowering}")
    kernel = SHARD_KERNEL[layout, lowering]
    if (sh.layout, sh.lowering, sh.vdtype) != (layout, lowering, vdtype):
        raise SmokeFailure(f"shard {name} built {sh.layout} + "
                           f"{sh.lowering} at {sh.vdtype!r}")
    x = torch.from_numpy(np.random.default_rng(4).standard_normal(
        mat.ncols).astype(np.float32)).to(device)
    counts = reset_all_launches()
    y = sharded_y(sh, x)
    torch.cuda.synchronize()
    launched = {k: v for k, v in counts().items() if v}
    print(f"  launches: {launched}")
    if launched != {kernel: sh.ndev}:
        raise SmokeFailure(f"shard {name}: launches {launched}, expected "
                           f"{sh.ndev} of {kernel} and nothing else")
    if tuple(y.shape) != (mat.nrows,) or not bool(torch.isfinite(y).all()):
        raise SmokeFailure(f"shard {name}: bad y {tuple(y.shape)}")
    y_plan = ops.spmv(plan, x)
    y64, pin = shard_inputs(csr, x, vdtype)
    e_plan, e64 = rel_err(y, y_plan), rel_err(y, y64)
    used = 0.0
    if pin is not None:
        used = float((np.abs(y.cpu().double().numpy() - pin[1])
                      / pin[0]).max())
    print(f"  y vs the unsharded ops.spmv {e_plan:.3g} of max|y|, vs the "
          f"f64 product {e64:.3g}"
          + (f", {used:.3g} of the bf16 pin" if pin is not None else ""))
    if not (e_plan <= TOL and e64 <= TOL and used <= 1.0):
        raise SmokeFailure(f"shard {name} disagrees: {e_plan} / {e64} > "
                           f"{TOL} or pin share {used} > 1")
    xp = x if sh.col_perm is None else x.index_select(0, sh.col_perm)
    per = []
    for k in range(sh.ndev):
        local = sh.local(k)
        print(f"  timing shard {k}")
        per.append(timer(lambda local=local: PL.local_execute_spmv(
            sh, local, xp), device))
    print("  timing the unsharded plan")
    whole = timer(lambda: ops.spmv(plan, x), device)
    mean = sum(per) / len(per)
    print(f"time shard {name} ({kernel}): shards {[round(t, 4) for t in per]}"
          f" ms, sum {sum(per):.4f}, max {max(per):.4f}, max / mean "
          f"{max(per) / mean:.3f}, unsharded {whole:.4f} ms; the max models "
          f"an {sh.ndev}-card step before its all_gather (a model, not a "
          f"measurement of {sh.ndev} cards)")
    return {"kernel": kernel, "launches": sh.ndev, "max_abs_err": float(
        (y - y_plan).abs().max()), "rel_err_f64": e64, "shard_ms": per,
        "sum_ms": sum(per), "max_ms": max(per),
        "max_over_mean": max(per) / mean, "unsharded_ms": whole,
        "partition": part["mode"], "skew_blocks": part["skew_blocks"],
        "skew_nnz": part["skew_nnz"]}


def nccl_one_rank(mat, device):
    """``make_distributed_spmv`` on a one-shard plan of ``mat`` through a
    one-rank NCCL group on the card (an in-process ``HashStore``), gathered
    and as a slab, each against ``ops.spmv`` of the same layout, one
    launch of its kernel a call."""
    import torch
    import torch.distributed as dist
    from repro_torch.core import distributed as D
    from repro_torch.kernels import ops
    kw = dict(layout="whole_vector", lowering="mask", tune=False,
              **SHARD_GEOM["whole_vector"])
    sh = D.shard_matrix(mat, 1, device=device, **kw)
    plan = ops.prepare(mat, device=device, **kw)
    x = torch.from_numpy(np.random.default_rng(6).standard_normal(
        mat.ncols).astype(np.float32)).to(device)
    y_plan = ops.spmv(plan, x)
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        counts = reset_all_launches()
        y = D.make_distributed_spmv(sh)(x)
        slab = D.make_distributed_spmv(sh, gather=False)(x)
        torch.cuda.synchronize()
        launched = {k: v for k, v in counts().items() if v}
    finally:
        dist.destroy_process_group()
    errs = (rel_err(y, y_plan), rel_err(slab[0, :mat.nrows], y_plan))
    print(f"nccl one-rank group: launches {launched}, gathered y "
          f"{errs[0]:.3g} of max|y| from ops.spmv, slab {errs[1]:.3g}")
    if launched != {"spmv_cuda_db": 2} or max(errs) > TOL:
        raise SmokeFailure(f"the one-rank NCCL SpMV: {launched}, {errs}")


def run_example(argv):
    """An ``examples_torch`` script in a subprocess on the card: it must
    exit 0, converge (relative residual under 1e-4) and have launched its
    SpMV kernel. Returns its launches."""
    env = dict(os.environ, PYTHONPATH=os.path.join(HERE, "src"))
    t0 = time.perf_counter()
    out = subprocess.run([sys.executable, *argv], capture_output=True,
                         text=True, timeout=600, cwd=HERE, env=env)
    lines = out.stdout.strip().splitlines()
    print(f"example {' '.join(argv)}: exit {out.returncode}, "
          f"{time.perf_counter() - t0:.1f} s; "
          + " | ".join(lines[:1] + lines[-2:]))
    if out.returncode != 0 or len(lines) < 2:
        raise SmokeFailure(f"example {argv} failed: {out.stderr[-2000:]}")
    launches = json.loads(lines[-2].removeprefix("launches: "))
    residual = float(lines[-1].split()[3])
    if not (residual < 1e-4 and sum(launches.values()) > 0):
        raise SmokeFailure(f"example {argv}: residual {residual}, "
                           f"launches {launches}")
    return launches


def sharding(csr, mat, bcsr, bmat, breo, device):
    """Phase: the sharded plans of :data:`SHARD_PLANS`, the one-rank NCCL
    group and the CG solver with and without ``--distributed``. Returns
    {kernel: launches on the sharded plans} and each plan's numbers."""
    per = {}
    shard_launches = {}
    for matrix, layout, lowering, vdtype in SHARD_PLANS:
        name = f"{matrix} {layout} {lowering} {vdtype}"
        c, m, reo = (csr, mat, None) if matrix == "fem" else (bcsr, bmat,
                                                             breo)
        per[name] = shard_one(name, c, m, layout, lowering, vdtype, reo,
                              device)
        k = per[name]["kernel"]
        shard_launches[k] = shard_launches.get(k, 0) + per[name]["launches"]
    nccl_one_rank(mat, device)
    examples = {
        "cg_solver": run_example(["examples_torch/cg_solver.py"]),
        "cg_solver --distributed": run_example(
            ["examples_torch/cg_solver.py", "--distributed"])}
    return shard_launches, per, examples


# ----------------------------------------------------------------------------
# SparseLinear path: the yi-6b vocab projection
# ----------------------------------------------------------------------------

#: The block shapes of the FEM matrix the tune phase measures beside
#: MATRIX["rc"] (whose plans the SpMV path built), and the rows of the vocab
#: weight its layer takes.
TUNE_SHAPES = ((2, 4), (4, 8))
TUNE_LAYER_ROWS = 4_096


def tune_and_verify(csr, mat, plans, x, y64, w, device, timer=cuda_time_ms):
    """Phase: tune and verify on the card. Every FEM plan of
    ``MATRIX["rc"]`` (the SpMV path's, both layouts and lowerings) and of
    :data:`TUNE_SHAPES` (built here with ``verify=True``) is timed at batch
    1 through ``ops.spmv`` (L2 flushed, median of 30), its output held
    against its plain version and the f64 product; each time becomes a
    ``Record`` of the card's backend (gflops = 2 nnz / t, the matrix's
    features, the plan's config), written with ``save_jsonl`` into a
    temporary directory, read back with ``load_records`` and held to
    ``verify_records``. Then ``ops.prepare(mat32, store=..., verify=True)``,
    ``mat32`` the matrix with its values in float32 (what every plan
    stores), must be tuned from the store ("store") to the config measured
    fastest on ``MATRIX["rc"]`` (the exact feature match returns its
    mean), its SpMV within ``TOL`` of the plain version, timed beside the
    untuned plan (``tune=False``: the reference's rules) and the plan tuned
    from the generator's float64 matrix: the tune pass budgets a
    whole-vector pick by the matrix's value dtype (the reference's 2 MiB
    TPU rule, kept for parity), and 200,000 float64 rows and columns take
    3.2 MB, so that pick must come back demoted to panels + mask at the
    panel defaults, traced ("vmem-budget");
    ``choose_block(csr, store)`` must pick the shape whose whole-vector
    records measured fastest (their mean: what the sequential predictor
    returns at the matrix's own Avg); and ``SparseLinear.from_dense`` on the
    first :data:`TUNE_LAYER_ROWS` rows of the vocab weight with the store
    and ``verify=True`` builds a layer whose forward (batch 1 and 16) runs
    its kernels on the card, held against ``use_pallas=False`` (the plain
    versions on the card). Prints ``verify_plan``'s host seconds and
    ``plan_nbytes`` of the FEM plans. Returns the phase's numbers."""
    import tempfile
    import torch
    from repro_torch.analysis import verify as V
    from repro_torch.core import formats as F
    from repro_torch.core import plan as P
    from repro_torch.core import selector as S
    from repro_torch.core.sparse_linear import SparseLinear, choose_block
    from repro_torch.kernels import ops
    backend = S.backend_of(device)
    shapes = {MATRIX["rc"]: (mat, plans)}
    host = {}
    for rc in TUNE_SHAPES:
        t = time.perf_counter()
        m = F.csr_to_spc5(csr, *rc)
        shapes[rc] = (m, {(layout, lowering): ops.prepare(
            m, layout=layout, lowering=lowering, tune=False, verify=True,
            device=device, **geom)
            for layout, geom in GEOM.items() for lowering in LOWERINGS})
        host[f"{rc[0]}x{rc[1]} convert + 4 prepares (verify=True)"] = \
            time.perf_counter() - t
    verify_s = {}
    for (layout, lowering), plan in plans.items():
        t = time.perf_counter()
        report = V.verify_plan(plan)
        verify_s[f"{layout} {lowering}"] = time.perf_counter() - t
        print(f"verify_plan fem {MATRIX['rc']} {layout} {lowering}: "
              f"{report.summary()}, {verify_s[f'{layout} {lowering}']:.3f} s "
              f"host; plan_nbytes {P.plan_nbytes(plan)}")
        if not report.ok:
            raise SmokeFailure(f"the SpMV path's {layout} {lowering} plan "
                               f"does not verify: {report.summary()}")
    store, times = S.RecordStore(), {}
    for rc, (m, ps) in shapes.items():
        kernel = f"{rc[0]}x{rc[1]}"
        feats = S.spc5_features(m)
        for (layout, lowering), plan in ps.items():
            y = ops.spmv(plan, x)
            e_plain, e64 = (rel_err(y, plain_y(plan, x)),
                            rel_err(y, torch.from_numpy(y64)))
            if not (e_plain <= TOL and e64 <= TOL):
                raise SmokeFailure(f"fem {kernel} {layout} {lowering}: "
                                   f"{e_plain} / {e64} > {TOL}")
            print(f"time ops.spmv fem beta({kernel}) {layout} {lowering} "
                  f"({e_plain:.3g} of max|y| from plain, {e64:.3g} from "
                  f"f64):")
            ms = timer(lambda plan=plan: ops.spmv(plan, x), device)
            times[kernel, layout, lowering] = ms
            geom = GEOM[layout]
            cfg = S.PanelConfig(layout=layout, pr=geom.get("pr", 0),
                                xw=geom.get("xw", 0), cb=geom["cb"],
                                lowering=lowering, vdtype="f32")
            store.add_measurement(kernel, feats, cfg, 1,
                                  2 * m.nnz / (ms * 1e6),
                                  matrix="fem_blocks", backend=backend)
    del shapes
    with tempfile.TemporaryDirectory() as tmp:
        store.save_jsonl(os.path.join(tmp, "fem_card.jsonl"))
        loaded = S.load_records(tmp)
    report = V.verify_records(loaded)
    print(f"card store: {len(loaded.records)} records, backend "
          f"{sorted({r.backend for r in loaded.records})}, verify_records "
          f"{report.summary()}")
    if loaded.records != store.records or not report.ok:
        raise SmokeFailure(f"the card store did not round-trip clean: "
                           f"{report.summary()}")
    for rec in loaded.records:
        print(f"  record {rec.kernel} {rec.layout} {rec.lowering}: "
              f"{rec.gflops:.2f} GFLOP/s (avg {rec.avg:.3f})")
    kernel = f"{MATRIX['rc'][0]}x{MATRIX['rc'][1]}"
    fastest = max((r for r in loaded.records if r.kernel == kernel),
                  key=lambda r: r.gflops)

    def config(plan):
        return (plan.layout, plan.lowering, plan.cb,
                plan.pr if plan.layout == "panels" else 0)
    mat32 = dataclasses.replace(mat, values=mat.values.astype(np.float32))
    t = time.perf_counter()
    tuned = ops.prepare(mat32, store=loaded, verify=True, device=device)
    host["tuned prepare (verify=True)"] = time.perf_counter() - t
    entry = tuned.trace[0]
    got = config(tuned)
    want = (fastest.layout, fastest.lowering, fastest.cb, fastest.pr)
    print(f"tuned plan (f32 values): tune entry "
          f"{json.dumps(entry, sort_keys=True)}; plan {got}, fastest "
          f"record {want}")
    if entry["source"] != "store" or got != want:
        raise SmokeFailure(f"prepare(store=...) tuned to {got} ({entry}), "
                           f"not the fastest measured {want}")
    tuned64 = ops.prepare(mat, store=loaded, verify=True, device=device)
    entry64 = tuned64.trace[0]
    print(f"tuned plan (float64 values): tune entry "
          f"{json.dumps(entry64, sort_keys=True)}; plan {config(tuned64)}")
    demote = (fastest.layout == "whole_vector" and not P.fits_whole_vector(
        *mat.shape, mat.values.dtype.itemsize))
    if (entry64["source"] != "store" or entry64["demoted"] != demote
            or (demote and config(tuned64)[:3] != ("panels", "mask", 64))):
        raise SmokeFailure(f"the float64 matrix's tune entry is {entry64}")
    untuned = ops.prepare(mat, tune=False, device=device)
    print(f"untuned plan (tune=False): {config(untuned)}")
    t = time.perf_counter()
    report = V.verify_plan(tuned)
    verify_s["tuned"] = time.perf_counter() - t
    print(f"verify_plan tuned: {verify_s['tuned']:.3f} s host; plan_nbytes "
          f"{P.plan_nbytes(tuned)}")
    wl = w[:TUNE_LAYER_ROWS]
    t = time.perf_counter()
    with warnings.catch_warnings():
        # the sequential predictor fits its records of one Avg (one point
        # per kernel's layout): numpy warns, the fit returns their mean
        warnings.filterwarnings("ignore", message="Polyfit may be poorly")
        block = choose_block(csr, loaded)
        layer = SparseLinear.from_dense(wl, density=VOCAB["density"],
                                        store=loaded, verify=True)
    host["choose_block + from_dense (verify=True)"] = time.perf_counter() - t
    means = {}
    for r in loaded.records:
        if r.pr == 0:
            means.setdefault(r.kernel, []).append(r.gflops)
    best = max(means, key=lambda k: float(np.mean(means[k])))
    print(f"choose_block(fem, store): {block}; whole-vector means "
          f"{ {k: round(float(np.mean(v)), 2) for k, v in means.items()} }")
    if block != S.kernel_block(best):
        raise SmokeFailure(f"choose_block picked {block}, the store's "
                           f"fastest shape is {best}")
    lp = layer.plan
    print(f"layer from_dense(w[:{TUNE_LAYER_ROWS}], store, verify=True): "
          f"beta({lp.r},{lp.c}) {lp.layout} + {lp.lowering}, tune entry "
          f"{json.dumps(lp.trace[0], sort_keys=True)}")
    if (lp.r, lp.c) != block or lp.trace[0]["source"] != "store":
        raise SmokeFailure(f"the layer is beta({lp.r},{lp.c}), tuned by "
                           f"{lp.trace[0]}")
    rng = np.random.default_rng(2)
    a16 = torch.from_numpy(rng.standard_normal(
        (SPMM_NVECS[0], wl.shape[1])).astype(np.float32)).to(device)
    counts = reset_all_launches()
    y1 = ops.spmv(tuned, x)
    y64t = ops.spmv(tuned64, x)
    l1 = layer(a16[0])
    l16 = layer(a16)
    torch.cuda.synchronize()
    launches = {k: v for k, v in counts().items() if v}
    want = {}
    for name in (kernel_name(tuned), kernel_name(tuned64), kernel_name(lp),
                 kernel_name(lp, spmm=True)):
        want[name] = want.get(name, 0) + 1
    print(f"launches on the tune path: {launches}")
    if launches != want:
        raise SmokeFailure(f"the tune path launched {launches}, not {want}")
    errs = {"tuned": rel_err(y1, plain_y(tuned, x)),
            "tuned_f64": rel_err(y1, torch.from_numpy(y64)),
            "tuned_float64_matrix": rel_err(y64t, plain_y(tuned64, x)),
            "layer_1": rel_err(l1, layer(a16[0], use_pallas=False)),
            "layer_16": rel_err(l16, layer(a16, use_pallas=False))}
    print(f"check the tune path: {errs} (of max|y|)")
    if not all(e <= TOL for e in errs.values()):
        raise SmokeFailure(f"the tune path disagrees: {errs} > {TOL}")
    # in turns (untuned, from float64, tuned, then back), each figure the
    # mean of its two medians: the card's spread between timings a few
    # seconds apart is larger than the gaps measured
    turns = {"untuned": untuned, "tuned from float64": tuned64,
             "tuned": tuned}
    ms = {k: [] for k in turns}
    for names in (list(turns), list(turns)[::-1]):
        for name in names:
            plan = turns[name]
            print(f"time ops.spmv, {name} FEM plan {config(plan)}:")
            ms[name].append(timer(lambda plan=plan: ops.spmv(plan, x),
                                  device))
    untuned_ms, tuned64_ms, tuned_ms = (float(np.mean(ms[k])) for k in turns)
    print(f"{card_line()}: FEM SpMV in turns, untuned {config(untuned)} "
          f"{untuned_ms:.4f} ms, tuned {config(tuned)} {tuned_ms:.4f} ms "
          f"({untuned_ms / tuned_ms:.2f}x), tuned from float64 values "
          f"({'' if demote else 'not '}demoted) {tuned64_ms:.4f} ms "
          f"(medians {ms})")
    out = {"records": [{"kernel": r.kernel, "layout": r.layout,
                        "lowering": r.lowering, "gflops": r.gflops,
                        "ms": times[r.kernel, r.layout, r.lowering]}
                       for r in loaded.records],
           "backend": backend, "tuned": list(got),
           "tuned_float64_matrix": list(config(tuned64)),
           "untuned": list(config(untuned)), "choose_block": block,
           "untuned_ms": untuned_ms, "tuned_ms": tuned_ms,
           "tuned_float64_matrix_ms": tuned64_ms,
           "verify_s": verify_s, "host_s": host, "launches": launches,
           "errs": errs}
    print(json.dumps({"tune_verify": out}))
    return out


def make_vocab():
    """The vocab weight as serve.py's vocab bench draws it (float64 normal
    from ``default_rng(0)``, cast to float32), and its CSR and beta(4,8)
    matrix pruned and converted as ``SparseLinear.from_dense`` does it: the
    CSR feeds the f64 product and cuSPARSE, the matrix the mask layers and
    the token plan."""
    from repro_torch.core import formats as F
    from repro_torch.core.sparse_linear import prune_by_magnitude
    t0 = time.perf_counter()
    w = np.random.default_rng(VOCAB["seed"]).standard_normal(
        (VOCAB["rows"], VOCAB["cols"])).astype(np.float32)
    t1 = time.perf_counter()
    csr = F.csr_from_dense(prune_by_magnitude(w, VOCAB["density"]))
    t2 = time.perf_counter()
    mat = F.csr_to_spc5(csr, *VOCAB["block"])
    t3 = time.perf_counter()
    print(f"vocab weight: {VOCAB['rows']} x {VOCAB['cols']} at density "
          f"{VOCAB['density']} -> beta{VOCAB['block']}: {csr.nnz} nnz, "
          f"{mat.nblocks} blocks, Avg {csr.nnz / mat.nblocks:.3f} (host: "
          f"draw {t1 - t0:.1f} s, prune + CSR {t2 - t1:.1f} s, csr_to_spc5 "
          f"{t3 - t2:.1f} s)")
    return w, csr, mat


def spmm_panel_launches(plan, nvec, split=None):
    """The launches the panel SpMM wrappers of the plan's lowering make at
    batch nvec (``panels_launch`` of :mod:`spc5_spmm` for a mask plan, of
    :mod:`spc5_spmm_desc` for a descriptor plan): S, grid, column tile,
    columns a lane, row parts, threads, shared bytes, ring, chunks (and,
    descriptor, blocks) a stage, CTAs per SM and the kernel's registers
    (``-Xptxas -v``). On the CPU only the shared-memory plan (no card to ask
    for occupancy)."""
    from repro_torch.kernels import spc5_spmm as KM
    from repro_torch.kernels import spc5_spmm_desc as KDM
    vec = KM.panels_vector(nvec)
    geom = dict(cb=plan.cb, r=plan.r, c=plan.c, vmax=plan.vmax, pr=plan.pr,
                nvec=nvec, vec=vec, vsize=plan.values.element_size())
    if plan.lowering == "descriptor":
        mod = KDM
        kernel = (f"spmm_desc_panels_kernel<{value_label(plan)},{plan.r},"
                  f"{plan.c},{vec},")
        geom.update(wv=plan.desc_vidx.element_size(),
                    wx=plan.desc_xcol.element_size())
    else:
        mod = KM
        kernel = f"spmm_panels_kernel<{value_label(plan)},{plan.c},{vec},"
    out = {}
    for name, stages in (("s1", 1), ("s2", mod.PANEL_DB_STAGES)):
        if plan.device.type == "cuda":
            out[name] = mod.panels_launch(stages, plan.npanels, plan.nchunks,
                                          device=plan.device, split=split,
                                          **geom)
            out[name]["registers"] = REGISTERS.get(f"{kernel}{stages}>")
        else:
            out[name] = dict(stages=stages, **mod.panels_plan(stages,
                                                              **geom))
    return out


def whole_spmm_launch(plan, nvec, grid=None, x=None):
    """The launch the whole-vector SpMM wrapper of the plan's lowering makes
    at batch nvec on X (``whole_launch`` of :mod:`spc5_spmm` for a mask
    plan, of :mod:`spc5_spmm_desc` for a descriptor plan; ``grid`` forces
    G): G, chunks a CTA, the ring's stages, chunks and blocks a stage, tile
    columns, columns a lane, threads, Y-tile rows, shared bytes, CTAs per SM
    and the kernel's registers (``-Xptxas -v``). On the CPU only the CTA
    (no card to ask for occupancy)."""
    from repro_torch.kernels import spc5_spmm as KM
    from repro_torch.kernels import spc5_spmm_desc as KDM
    geom = dict(cb=plan.cb, r=plan.r, c=plan.c, vmax=plan.vmax, nvec=nvec,
                vec=KM.panels_vector(nvec, x))
    if plan.lowering == "descriptor":
        mod, policy = KDM, f"DescWhole<{value_label(plan)}>"
        geom.update(wv=plan.desc_vidx.element_size(),
                    wx=plan.desc_xcol.element_size())
    else:
        mod, policy = KM, f"MaskWhole<{value_label(plan)}>"
    geom.update(vsize=plan.values.element_size())
    if plan.device.type != "cuda":
        return mod.whole_cta(**geom)
    out = mod.whole_launch(int(plan.chunk_vbase.shape[0]), device=plan.device,
                           grid=grid, **geom)
    out["registers"] = REGISTERS.get(
        f"spmm_whole_kernel<{policy},{plan.r},{plan.c},{out['vector']}>")
    return out


def print_spmm_plan(name, plan) -> None:
    """Geometry and each SpMM kernel's launch at every batch (a panel plan's
    by :func:`spmm_panel_launches`, a whole-vector plan's by
    :func:`whole_spmm_launch`), and a descriptor plan's tables' dtypes and
    bytes."""
    g = {k: getattr(plan, k) for k in ("cb", "vmax", "pr", "xw", "npanels",
                                       "nchunks", "desc_lane_nbytes")
         if k in dict(plan.meta)}
    panels = plan.layout == "panels"
    for nvec in SPMM_NVECS:
        g[f"nvec{nvec}_launch"] = (spmm_panel_launches(plan, nvec) if panels
                                   else whole_spmm_launch(plan, nvec))
    if plan.lowering == "descriptor":
        tables = [getattr(plan, f"desc_{t}")
                  for t in ("valid", "vidx", "xcol", "yrow")]
        g["tables"] = "/".join(str(t.dtype).replace("torch.", "")
                               for t in tables)
        g["table_bytes"] = sum(t.numel() * t.element_size() for t in tables)
    if panels:
        g["spmv_launch"] = panel_launches(plan)
    g["plan_bytes"] = sum(a.numel() * a.element_size() for a in plan.arrays)
    print(f"  plan {name}: {g}, build {plan.trace[-1]['duration_s']:.1f} s")


def build_layers(w, mat, device):
    """The layers of the path. ``SparseLinear.from_dense(w, density=0.1,
    nvec=128)`` with every other argument at its default, the reference's
    default layer: its layout pass must pick panels (from nvec) and the
    descriptor lowering (by the cost model). Beside it, two mask layers on
    the same converted matrix through ``ops.prepare(lowering="mask")``: the
    auto layout (panels) and whole-vector."""
    from repro_torch.core.sparse_linear import SparseLinear
    from repro_torch.kernels import ops
    t0 = time.perf_counter()
    default = SparseLinear.from_dense(w, density=VOCAB["density"],
                                      nvec=VOCAB["nvec"])
    t1 = time.perf_counter()
    panels = SparseLinear(ops.prepare(mat, lowering="mask",
                                      nvec=VOCAB["nvec"], device=device))
    whole = SparseLinear(ops.prepare(mat, layout="whole_vector",
                                     lowering="mask", nvec=VOCAB["nvec"],
                                     device=device))
    t2 = time.perf_counter()
    print(f"layers: from_dense {t1 - t0:.1f} s (prune, convert, plan), "
          f"the two mask plans {t2 - t1:.1f} s")
    print(f"  default layer's trace: {json.dumps(default.plan.trace)}")
    entry = next(e for e in default.plan.trace if e["pass"] == "layout")
    got = (default.plan.layout, default.plan.lowering, entry["reason"],
           entry.get("lowering_reason"), (default.plan.r, default.plan.c))
    if got != ("panels", "descriptor", "vmem-fit", "cost-model",
               VOCAB["block"]):
        raise SmokeFailure(f"from_dense at its defaults built {got}, not "
                           f"panels + descriptor in beta{VOCAB['block']}")
    if panels.plan.layout != "panels":
        raise SmokeFailure(f"the mask layer's auto layout is "
                           f"{panels.plan.layout!r}, not panels")
    print(f"  default layer: {entry['layout']} ({entry['reason']}) + "
          f"{entry['lowering']} ({entry['lowering_reason']})")
    layers = {("panels", "descriptor"): default, ("panels", "mask"): panels,
              ("whole_vector", "mask"): whole}
    for (layout, lowering), layer in layers.items():
        print_spmm_plan(f"{layout} {lowering}", layer.plan)
    return layers


def layer_key(name):
    """The layer (layout, lowering) SpMM kernel ``name`` runs on."""
    lowering = "descriptor" if name in DESC_SPMM_KERNELS else "mask"
    table = DESC_SPMM_KERNELS if lowering == "descriptor" else SPMM_KERNELS
    return table[name][0], lowering


VOCAB_SPMM = ("spmm_cuda_panels_desc_db", "spmm_cuda_panels_desc",
              "spmm_cuda_panels_db", "spmm_cuda_panels", "spmm_cuda")
#: Batch 1 (one decode token) on the vocab layers: kernel -> (layer,
#: double_buffer). The layer's forward runs the double-buffered kernel; the
#: synchronous twin goes through ``ops.spmv(..., double_buffer=False)``.
BATCH1 = {"spmv_cuda_panels_desc_db": (("panels", "descriptor"), True),
          "spmv_cuda_panels_desc": (("panels", "descriptor"), False),
          "spmv_cuda_panels_db": (("panels", "mask"), True),
          "spmv_cuda_panels": (("panels", "mask"), False),
          "spmv_cuda_db": (("whole_vector", "mask"), True),
          "spmv_cuda": (("whole_vector", "mask"), False)}
#: The kernel each batch-1 kernel is timed beside: a panel kernel's twin of
#: the other lowering; for the whole-vector mask pair, the mask panel
#: layer's kernel with the same buffering.
BATCH1_TWIN = {"spmv_cuda_panels_desc_db": "spmv_cuda_panels_db",
               "spmv_cuda_panels_desc": "spmv_cuda_panels",
               "spmv_cuda_panels_db": "spmv_cuda_panels_desc_db",
               "spmv_cuda_panels": "spmv_cuda_panels_desc",
               "spmv_cuda_db": "spmv_cuda_panels_db",
               "spmv_cuda": "spmv_cuda_panels"}


def reset_all_launches():
    from repro_torch.kernels import (spc5_spmm, spc5_spmm_desc, spc5_spmv,
                                     spc5_spmv_desc, spc5_spmv_tail)
    mods = (spc5_spmv, spc5_spmv_desc, spc5_spmm, spc5_spmm_desc,
            spc5_spmv_tail)
    for mod in mods:
        mod.reset_launches()
    return lambda: {k: v for mod in mods for k, v in mod.LAUNCHES.items()}


def drive_vocab(layers, acts, device):
    """The SparseLinear path, through the entry points a user calls: every
    layer's forward on every batch, ``ops.spmm(..., double_buffer=False)``
    on both panel layers, and at batch 1 every layer's forward and
    ``ops.spmv(..., double_buffer=False)`` (:data:`BATCH1`).
    Returns each kernel's Y (rows, nvec) per batch, the batch-1 ys and this
    run's launch counts."""
    import torch
    from repro_torch.kernels import ops
    counts = reset_all_launches()
    default = layers["panels", "descriptor"]
    panels, whole = layers["panels", "mask"], layers["whole_vector", "mask"]
    ys = {}
    for nvec, a in acts.items():
        ys["spmm_cuda_panels_desc_db", nvec] = default(a).t()
        ys["spmm_cuda_panels_desc", nvec] = ops.spmm(
            default.plan, a.t().contiguous(), double_buffer=False)
        ys["spmm_cuda_panels_db", nvec] = panels(a).t()
        ys["spmm_cuda_panels", nvec] = ops.spmm(
            panels.plan, a.t().contiguous(), double_buffer=False)
        ys["spmm_cuda", nvec] = whole(a).t()
    x1 = acts[SPMM_NVECS[0]][0]
    y1 = {name: layers[key](x1) if db else ops.spmv(
              layers[key].plan, x1, double_buffer=False)
          for name, (key, db) in BATCH1.items()}
    if device.type == "cuda":
        torch.cuda.synchronize()
    return ys, y1, counts()


def check_spmm(name, y, plan, x, y64, path):
    """Y is finite, of the right shape and within tolerance of the plain
    version and of the f64 product. Returns max|Y - plain|."""
    import torch
    nvec = x.shape[1]
    if (tuple(y.shape) != (plan.nrows, nvec)
            or not bool(torch.isfinite(y).all())):
        raise SmokeFailure(f"{name}: bad output {tuple(y.shape)}")
    plain = plain_y(plan, x)
    abs_err = float((y - plain).abs().max())
    e_plain, e64 = rel_err(y, plain), rel_err(y, torch.from_numpy(y64))
    del plain
    print(f"check {name} nvec={nvec} ({path}): max|Y - plain| = "
          f"{abs_err:.3g} ({e_plain:.3g} of max|Y|), vs f64 scipy "
          f"{e64:.3g} of max|Y|")
    if not (e_plain <= TOL and e64 <= TOL):
        raise SmokeFailure(f"{name} nvec={nvec} disagrees: {e_plain} / "
                           f"{e64} > {TOL}")
    return abs_err


def f64_matrix(csr):
    import scipy.sparse
    return scipy.sparse.csr_matrix((csr.values.astype(np.float64),
                                    csr.colidx, csr.rowptr), shape=csr.shape)


def check_vocab(layers, ys, y1, launches, acts, csr):
    """Every SpMM kernel of the path and the six batch-1 SpMV kernels
    launched; each output is checked by :func:`check_spmm` (batch 1 by
    :func:`check_y`), the panel kernels also at S = 1
    (:func:`check_panel_spmm`, :func:`check_forced`), the whole-vector mask
    pair also at G = 1 and one chunk a CTA (:func:`check_whole_grids`)."""
    for name in (*VOCAB_SPMM, *BATCH1):
        if launches.get(name, 0) <= 0:
            raise SmokeFailure(f"{name} was not launched on the SparseLinear "
                               f"path (counts {launches})")
    a64 = f64_matrix(csr)
    errs = {}
    for nvec, act in acts.items():
        x = act.t().contiguous()
        y64 = a64 @ x.cpu().double().numpy()
        for name in VOCAB_SPMM:
            err = check_spmm(name, ys[name, nvec], layers[layer_key(name)].plan,
                             x, y64, "SparseLinear path")
            errs[name] = max(errs.get(name, 0.0), err)
        for lowering in PANEL_SPMM:
            check_panel_spmm(layers["panels", lowering].plan, x, y64,
                             "SparseLinear path")
        check_whole_spmm(layers["whole_vector", "mask"].plan, x, y64,
                         "SparseLinear path")
    x1 = acts[SPMM_NVECS[0]][0]
    y64 = a64 @ x1.cpu().double().numpy()
    for name, (key, _) in BATCH1.items():
        errs[name] = check_y(name, y1[name], layers[key].plan, x1, y64,
                             launches, "SparseLinear path, batch 1")
    for name in MASK_PANEL_SPMV:
        check_forced(name, layers["panels", "mask"].plan, x1, y64,
                     "SparseLinear path, batch 1", split=1)
    check_whole_grids(layers["whole_vector", "mask"].plan, x1, y64,
                      "SparseLinear path, batch 1", one_cta=True)
    return errs


def measure_batch1(layers, x1, csr, launches, errs, timer=cuda_time_ms):
    """The six batch-1 SpMV kernels (rows 1-2 on the whole-vector mask
    layer, 3-4 on the panel mask layer, 8-9 on the default descriptor
    layer): each beside its bound (for a descriptor kernel also the
    whole-plan and mask-plan bounds), cuSPARSE ``torch.mv``, its layer's
    plain version, its launch plan (S or G, grid, threads, shared bytes,
    CTAs per SM, registers), the kernel :data:`BATCH1_TWIN` names and
    :func:`plan_read_ms` of the descriptor plan. Returns {kernel: numbers}
    for the kernels' ``vocab_batch1``."""
    import torch
    device = x1.device
    csr_t = sparse_csr(csr, device)
    print("  batch 1: timing cuSPARSE CSR (torch.mv on sparse_csr_tensor)")
    library_ms = timer(lambda: torch.mv(csr_t, x1), device)
    plain_ms, launch, ms = {}, {}, {}
    for key in dict.fromkeys(key for key, _ in BATCH1.values()):
        plan = layers[key].plan
        print(f"  batch 1: timing the plain version, {key[0]} {key[1]}")
        plain_ms[key] = timer(lambda p=plan: plain_y(p, x1), device)
        launch[key] = (panel_launches(plan) if key[0] == "panels"
                       else whole_launches(plan))
    read_ms = plan_read_ms(layers["panels", "descriptor"].plan, timer)
    for name, (key, _) in BATCH1.items():
        print(f"  batch 1: timing {name}")
        ms[name] = timer(kernel_call(name, layers[key].plan, x1), device)
    per = {}
    for name, (key, db) in BATCH1.items():
        plan = layers[key].plan
        bound_ms, bound_by, nbytes = bound(plan, csr.nnz)
        twin = BATCH1_TWIN[name]
        lplan = launch[key]["s2" if db else "s1"]
        print(f"time {name} (vocab, batch 1): {ms[name]:.4f} ms, plain "
              f"{plain_ms[key]:.4f} ms, cuSPARSE CSR {library_ms:.4f} ms, "
              f"bound {bound_ms:.4f} ms by {bound_by} ({nbytes} bytes, "
              f"{bound_ms / ms[name]:.3f} of it), {twin} {ms[twin]:.4f} ms; "
              f"launch {lplan}")
        per[name] = {"launches": launches[name], "max_abs_err": errs[name],
                     "ms": ms[name], "plain_ms": plain_ms[key],
                     "bound_ms": bound_ms, "bound_by": bound_by,
                     "library_ms": library_ms, "twin": twin,
                     "twin_ms": ms[twin], "launch": lplan}
        if key[1] == "descriptor":
            per[name].update(desc_bounds(plan, layers["panels", "mask"].plan,
                                         csr.nnz), **read_ms)
    return per


def plan_read_ms(plan, timer=cuda_time_ms):
    """Context for a panel descriptor plan: how long plain torch sums (each
    array viewed as float32) take to read (a) every byte of the plan and (b)
    what the panel SpMV kernels read: every array whole but, of each
    block's xcol and yrow rows, the first c entries and the first 4 bytes.
    Reads at this card's reachable rate, beside the kernels' times."""
    import torch
    wx = plan.desc_xcol.element_size()
    whole = [a.view(torch.float32) for a in plan.arrays]
    kept = {id(plan.desc_xcol): plan.c * wx // 4, id(plan.desc_yrow): 1}
    read = [a.view(torch.float32)[..., :kept[id(a)]] if id(a) in kept
            else a.view(torch.float32) for a in plan.arrays]
    out = {}
    for key, arrays in (("plan_read_ms", whole), ("kernel_read_ms", read)):
        nbytes = sum(4 * a.numel() for a in arrays)
        print(f"  timing torch sums over {nbytes} bytes ({key})")
        out[key] = timer(lambda t=arrays: [a.sum() for a in t], plan.device)
        print(f"context: {key} {out[key]:.4f} ms for {nbytes} bytes")
    return out


def measure_vocab(layers, acts, csr, timer=cuda_time_ms):
    """cuSPARSE SpMM, each layer's plain version and each SpMM kernel at
    every batch. Returns {(name, nvec): numbers} and cuSPARSE's ms per
    batch."""
    import torch
    device = next(iter(acts.values())).device
    csr_t = sparse_csr(csr, device)
    per, library = {}, {}
    for nvec, act in acts.items():
        x = act.t().contiguous()
        print(f"  nvec={nvec}: timing cuSPARSE SpMM (sparse_csr_tensor @ X)")
        library[nvec] = timer(lambda: csr_t @ x, device)
        if nvec == max(acts):
            dense = csr_t.to_dense()
            print(f"  nvec={nvec}: timing dense torch.matmul of the pruned "
                  f"weight (context only)")
            dense_ms = timer(lambda: dense @ x, device)
            print(f"context: dense f32 matmul {dense_ms:.4f} ms")
            del dense
        plain_ms = {}
        for key, layer in layers.items():
            print(f"  nvec={nvec}: timing the plain version, {key}")
            plain_ms[key] = timer(lambda p=layer.plan: plain_y(p, x), device)
        for name in VOCAB_SPMM:
            key = layer_key(name)
            plan = layers[key].plan
            print(f"  nvec={nvec}: timing {name}")
            ms = timer(kernel_call(name, plan, x), device)
            bound_ms, bound_by, nbytes = bound(plan, csr.nnz, nvec)
            print(f"time {name} nvec={nvec}: {ms:.4f} ms, plain "
                  f"{plain_ms[key]:.4f} ms, cuSPARSE SpMM "
                  f"{library[nvec]:.4f} ms, bound {bound_ms:.4f} ms by "
                  f"{bound_by} ({nbytes} bytes)")
            per[name, nvec] = {"ms": ms, "plain_ms": plain_ms[key],
                               "bound_ms": bound_ms, "bound_by": bound_by,
                               "library_ms": library[nvec]}
            if key[1] == "descriptor":
                per[name, nvec].update(desc_bounds(
                    plan, layers[key[0], "mask"].plan, csr.nnz, nvec))
            if key[0] == "panels":
                per[name, nvec]["launch"] = spmm_panel_launches(plan, nvec)[
                    "s2" if name.endswith("_db") else "s1"]
            else:
                per[name, nvec]["launch"] = whole_spmm_launch(plan, nvec,
                                                              x=x)
    for name in VOCAB_SPMM:
        if name in MASK_TWIN:
            for nvec in acts:
                per[name, nvec]["mask_ms"] = per[MASK_TWIN[name], nvec]["ms"]
    return per, library


def spmm_rows(names, per, launches, errs):
    """One JSON row per SpMM kernel: nvec=128 in the main keys, nvec=16
    beside."""
    rows = []
    for name in names:
        desc = name in DESC_SPMM_KERNELS
        replaces = (DESC_SPMM_KERNELS if desc else SPMM_KERNELS)[name][-1]
        rows.append({"name": name, "route": "cuda",
                     "source": DESC_SPMM_SOURCE if desc else SPMM_SOURCE,
                     "replaces": replaces, "launches": launches[name],
                     "max_abs_err": errs[name],
                     **per[name, VOCAB["nvec"]], "nvec": VOCAB["nvec"],
                     **{f"nvec_{n}": per[name, n] for n in SPMM_NVECS
                        if n != VOCAB["nvec"]}})
    return rows


# ----------------------------------------------------------------------------
# The vocab layers at bf16 and int8 (the value-dtype axis): the default layer
# and both mask layers
# ----------------------------------------------------------------------------

#: Each quantised kernel's aim: at most this many times the same kernel's
#: f32 time on the f32 layer of its lowering and layout, in the same run.
QUANTISED_AIM = 1.05

#: Calls a quantised layer's plain version is timed over (its median): the
#: plain versions take 10-120 ms a call on the vocab layers.
QUANTISED_PLAIN_REPS = 10

#: What a quantised layer runs, through the entry points a user calls:
#: layer -> (the forward's SpMV kernel, ``ops.spmv(double_buffer=False)``'s,
#: the forward's SpMM kernel, ``ops.spmm(double_buffer=False)``'s or None
#: where the layout has no twin).
QUANTISED_LAYERS = {
    ("panels", "descriptor"): ("spmv_cuda_panels_desc_db",
                               "spmv_cuda_panels_desc",
                               "spmm_cuda_panels_desc_db",
                               "spmm_cuda_panels_desc"),
    ("panels", "mask"): ("spmv_cuda_panels_db", "spmv_cuda_panels",
                         "spmm_cuda_panels_db", "spmm_cuda_panels"),
    ("whole_vector", "mask"): ("spmv_cuda_db", "spmv_cuda", "spmm_cuda",
                               None),
}


def build_quantised(mat, device):
    """The vocab layers at bf16 and int8 on the converted vocab matrix, every
    other argument at its default: the default layer, ``ops.prepare(mat,
    vdtype=..., nvec=128)``, whose layout pass must pick panels and the
    descriptor lowering in beta(4,8), as for f32 (:func:`build_layers`);
    the mask layer ``ops.prepare(mat, lowering="mask", vdtype=...,
    nvec=128)``, which must resolve to panels ((64,000 + 4,096) * 4 * 128
    bytes is far above the 2 MiB rule at any width); and the whole-vector
    mask layer ``ops.prepare(mat, layout="whole_vector", lowering="mask",
    vdtype=..., nvec=128)``. Returns {vdtype: {(layout, lowering):
    SparseLinear}}."""
    from repro_torch.core.sparse_linear import SparseLinear
    from repro_torch.kernels import ops
    dtype = {"bf16": "torch.bfloat16", "int8": "torch.int8"}
    layers = {}
    for vdtype in VDTYPES:
        layers[vdtype] = {}
        for key, kw in ((("panels", "descriptor"), {}),
                        (("panels", "mask"), dict(lowering="mask")),
                        (("whole_vector", "mask"),
                         dict(layout="whole_vector", lowering="mask"))):
            t0 = time.perf_counter()
            plan = ops.prepare(mat, vdtype=vdtype, nvec=VOCAB["nvec"],
                               device=device, **kw)
            entry = next((e for e in plan.trace if e["pass"] == "layout"),
                         {})
            got = ((plan.layout, plan.lowering), (plan.r, plan.c),
                   plan.vdtype, str(plan.values.dtype))
            want = (key, VOCAB["block"], vdtype, dtype[vdtype])
            if key == ("panels", "descriptor"):
                got += (entry.get("reason"), entry.get("lowering_reason"))
                want += ("vmem-fit", "cost-model")
            if got != want:
                raise SmokeFailure(f"prepare(vdtype={vdtype!r}, {kw}) built "
                                   f"{got}, not {want}")
            print(f"quantised layer {vdtype} {key[0]} {key[1]}: "
                  f"{plan.layout} ({entry.get('reason')}) + "
                  f"{plan.lowering} ({entry.get('lowering_reason')}), "
                  f"prepare {time.perf_counter() - t0:.1f} s")
            print_spmm_plan(f"{vdtype} {key[0]} {key[1]}", plan)
            layers[vdtype][key] = SparseLinear(plan)
    return layers


def drive_quantised(layers, acts, device):
    """One width's three quantised layers through the entry points a user
    calls (:data:`QUANTISED_LAYERS`): each forward at batch 1 and at every
    batch, ``ops.spmv`` / ``ops.spmm`` with ``double_buffer=False`` (the
    twins). Only these layers run between the counts' reset and their
    reading, so each count is a launch of a quantised instantiation.
    Returns {(kernel, batch): y} and the counts."""
    import torch
    from repro_torch.kernels import ops
    counts = reset_all_launches()
    x1 = acts[SPMM_NVECS[0]][0]
    ys = {}
    for key, layer in layers.items():
        spmv, spmv_twin, spmm, spmm_twin = QUANTISED_LAYERS[key]
        ys[spmv, 1] = layer(x1)
        ys[spmv_twin, 1] = ops.spmv(layer.plan, x1, double_buffer=False)
        for nvec, a in acts.items():
            ys[spmm, nvec] = layer(a).t()
            if spmm_twin is not None:
                ys[spmm_twin, nvec] = ops.spmm(
                    layer.plan, a.t().contiguous(), double_buffer=False)
    if device.type == "cuda":
        torch.cuda.synchronize()
    return ys, counts()


def quantised_refs(csr, acts):
    """The f64 products a quantised output is pinned to: for x (batch 1) and
    each batch's X, (A @ x, |A| @ |x|, (|A| > 0) @ |x|) of the f32 weight
    ``csr``, on the card; and smax = max|A| / 127 (at least every chunk's
    int8 scale). Returns ({batch: x}, {batch: refs}, smax)."""
    device = next(iter(acts.values())).device
    a64, absa, nza = (sparse_csr(csr, device, v, np.float64) for v in (
        None, np.abs(csr.values), (csr.values != 0).astype(np.float64)))
    xs = {1: acts[SPMM_NVECS[0]][0]}
    xs.update({n: a.t().contiguous() for n, a in acts.items()})
    refs = {}
    for n, x in xs.items():
        xd = x.double() if x.dim() == 2 else x.double()[:, None]
        refs[n] = (a64 @ xd, absa @ xd.abs(), nza @ xd.abs())
    return xs, refs, float(np.abs(csr.values).max()) / 127.0


def check_quantised_y(name, vdtype, plan, y, x, ref, smax, what):
    """One quantised output: finite, of its shape, within ``TOL`` of max|y|
    of its plain version on the card and of the f64 product of the
    dequantised values (the plain version in float64), and, elementwise,
    within the pins of ``tests/test_vdtype.py`` of the f64 product of the f32
    weight (``ref``, :func:`quantised_refs`): ``2**-7 * (|A| @ |x|)`` for
    bf16, ``smax / 2 * ((|A| > 0) @ |x|)`` for int8, each plus 1e-5. Returns
    max|y - plain| and the share of the pin used."""
    import torch
    n = 1 if x.dim() == 1 else x.shape[1]
    shape = (plan.nrows,) if x.dim() == 1 else (plan.nrows, n)
    if tuple(y.shape) != shape or not bool(torch.isfinite(y).all()):
        raise SmokeFailure(f"{name} {vdtype}: bad output {tuple(y.shape)}")
    plain = plain_y(plan, x)
    abs_err = float((y - plain).abs().max())
    e_plain = rel_err(y, plain)
    del plain
    e_deq = rel_err(y, plain_y(plan, x, torch.float64))
    y64, absb, nzb = (r if x.dim() == 2 else r[:, 0] for r in ref)
    pin = (2.0 ** -7 * absb if vdtype == "bf16" else 0.5 * smax * nzb) + 1e-5
    used = float(((y.double() - y64).abs() / pin).max())
    print(f"check {name} {vdtype} batch {n} ({what}): max|y - plain| = "
          f"{abs_err:.3g} ({e_plain:.3g} of max|y|), vs the f64 dequantised "
          f"product {e_deq:.3g} of max|y|, vs the f64 f32-weight product "
          f"{used:.3g} of its {vdtype} pin")
    if not (e_plain <= TOL and e_deq <= TOL and used <= 1.0):
        raise SmokeFailure(f"{name} {vdtype} batch {n} disagrees: {e_plain} "
                           f"/ {e_deq} > {TOL} or pin share {used} > 1")
    return abs_err, used


def check_quantised(layers, ys, launches, acts, csr):
    """For each width: the eleven quantised kernels launched, in the counts
    and in nothing else; each output checked by :func:`check_quantised_y`.
    Returns {vdtype: {kernel: max|y - plain|}} and the worst share of a pin
    used."""
    xs, refs, smax = quantised_refs(csr, acts)
    errs, worst_pin = {}, {}
    for vdtype, width in layers.items():
        want = {name: len(acts) if name.startswith("spmm") else 1
                for name in QUANTISED}
        got = {k: v for k, v in launches[vdtype].items() if v}
        if got != want:
            raise SmokeFailure(f"{vdtype} layers: launches {got}, expected "
                               f"{want} (the quantised instantiations)")
        errs[vdtype], worst_pin[vdtype] = {}, 0.0
        for (name, n), y in ys[vdtype].items():
            plan = width[QUANTISED[name]].plan
            abs_err, used = check_quantised_y(
                name, vdtype, plan, y, xs[n], refs[n], smax,
                f"quantised {plan.layout} {plan.lowering} layer")
            errs[vdtype][name] = max(errs[vdtype].get(name, 0.0), abs_err)
            worst_pin[vdtype] = max(worst_pin[vdtype], used)
    return errs, worst_pin


def values_bytes(plan):
    """The bytes of the plan's values and, for int8, their scales."""
    from repro_torch.core.plan import _plan_scale
    scale = _plan_scale(plan)
    return (plan.values.numel() * plan.values.element_size()
            + (0 if scale is None else scale.numel() * scale.element_size()))


def csr_library_ms(csr, x, f32_ms, timer, t=None):
    """cuSPARSE's time for the product on bf16 values and bf16 x where the
    card's torch takes it (``torch.mv`` / ``@`` on a bf16
    ``sparse_csr_tensor``), else the f32 figure ``f32_ms``: returns (ms,
    which). ``t``: the f32 ``sparse_csr_tensor`` in place of ``csr``'s."""
    import torch
    t = sparse_csr(csr, x.device) if t is None else t
    tb = torch.sparse_csr_tensor(t.crow_indices(), t.col_indices(),
                                 t.values().to(torch.bfloat16), size=t.shape)
    xb = x.to(torch.bfloat16)
    fn = ((lambda: torch.mv(tb, xb)) if x.dim() == 1 else (lambda: tb @ xb))
    try:
        fn()
        torch.cuda.synchronize()
    except (RuntimeError, NotImplementedError) as e:
        print(f"  cuSPARSE on bf16 values not taken by this torch "
              f"({str(e).splitlines()[0][:120]}); the f32 figure is used")
        return f32_ms, "f32"
    print(f"  timing cuSPARSE on bf16 values and x ({tuple(x.shape)})")
    return timer(fn, x.device), "bf16"


def quantised_launch(name, plan, nvec):
    """The launch kernel ``name``'s wrapper makes on the plan at batch nvec
    (:func:`panel_launches`, :func:`whole_launches`,
    :func:`spmm_panel_launches` or :func:`whole_spmm_launch`)."""
    ring = "s2" if name.endswith("_db") else "s1"
    if name.startswith("spmm") and plan.layout == "whole_vector":
        return whole_spmm_launch(plan, nvec)
    if name.startswith("spmm"):
        return spmm_panel_launches(plan, nvec)[ring]
    if plan.layout == "whole_vector":
        return whole_launches(plan)[ring]
    return panel_launches(plan)[ring]


def quantised_library(csr, acts, f32_library, timer=cuda_time_ms):
    """cuSPARSE on the weight at batch 1 and every SpMM batch, on bf16
    values where the card takes it (:func:`csr_library_ms`; ``f32_library``
    {batch: ms} the f32 figures otherwise): {batch: (ms, which)}."""
    xs = {1: acts[SPMM_NVECS[0]][0].contiguous()}
    xs.update({n: a.t().contiguous() for n, a in acts.items()})
    return {n: csr_library_ms(csr, x, f32_library[n], timer)
            for n, x in xs.items()}


def measure_quantised(layers, f32_layers, acts, csr, lib, kernels=QUANTISED,
                      timer=cuda_time_ms):
    """Each quantised kernel of ``kernels`` (name -> layer key) at batch 1
    (SpMV) or 16 and 128 (SpMM) beside the same kernel on the f32 layer of
    its layout and lowering, timed in turns (f32, bf16, int8, int8, bf16,
    f32; each width's two medians averaged), its bound (the plan's arrays
    as built: values at their stored width, int8 scales, checked against
    the f32 plan's figure), its plain version (median of
    :data:`QUANTISED_PLAIN_REPS` calls) and cuSPARSE (``lib``,
    :func:`quantised_library`). Returns {kernel: {vdtype: {batch:
    numbers}}}."""
    for key, f32_layer in f32_layers.items():
        fplan = f32_layer.plan
        f32_vals = values_bytes(fplan)
        shares = [("f32", fplan)]
        for vdtype, width in layers.items():
            plan = width[key].plan
            q = values_bytes(plan)
            if needed_bytes(plan) != needed_bytes(fplan) - f32_vals + q:
                raise SmokeFailure(f"{vdtype} {key}: needed bytes "
                                   f"{needed_bytes(plan)} are not the f32 "
                                   f"plan's with its values at {q} bytes")
            shares.append((vdtype, plan))
        for label, plan in shares:
            print(f"values' share of the needed bytes, {key[0]} {key[1]} "
                  f"{label}: {values_bytes(plan)} of {needed_bytes(plan)} "
                  f"bytes ({values_bytes(plan) / needed_bytes(plan):.4f}, "
                  f"int8 scales included)")
    xs = {1: acts[SPMM_NVECS[0]][0].contiguous()}
    xs.update({n: a.t().contiguous() for n, a in acts.items()})
    plain = {}
    for vdtype, width in layers.items():
        for key, layer in width.items():
            for n, x in xs.items():
                print(f"  {vdtype} {key[0]} {key[1]} batch {n}: timing the "
                      f"plain version")
                plain[vdtype, key, n] = timer(
                    lambda p=layer.plan, v=x: plain_y(p, v), x.device,
                    reps=QUANTISED_PLAIN_REPS)
    out = {}
    for name, key in kernels.items():
        spmm = name.startswith("spmm")
        out[name] = {v: {} for v in layers}
        plans = {"f32": f32_layers[key].plan,
                 **{v: width[key].plan for v, width in layers.items()}}
        for n in (SPMM_NVECS if spmm else (1,)):
            x = xs[n]
            order = list(plans) + list(plans)[::-1]
            times = {v: [] for v in plans}
            for v in order:
                print(f"  timing {name} {v} batch {n}")
                times[v].append(timer(kernel_call(name, plans[v], x),
                                      x.device))
            f32_ms = float(np.mean(times["f32"]))
            f32_launch = quantised_launch(name, plans["f32"], n)
            for vdtype in layers:
                plan = plans[vdtype]
                ms = float(np.mean(times[vdtype]))
                bound_ms, bound_by, nbytes = bound(plan, csr.nnz, n)
                f32_bound = bound(plans["f32"], csr.nnz, n)[0]
                ratio = ms / f32_ms
                launch = quantised_launch(name, plan, n)
                print(f"time {name} {vdtype} batch {n}: {ms:.4f} ms ("
                      f"{times[vdtype][0]:.4f} / {times[vdtype][1]:.4f}), "
                      f"f32 {f32_ms:.4f} ms, {ratio:.3f}x f32 (aim <= "
                      f"{QUANTISED_AIM}: "
                      f"{'met' if ratio <= QUANTISED_AIM else 'MISSED'}), "
                      f"bound {bound_ms:.4f} ms by {bound_by} ({nbytes} "
                      f"bytes, {bound_ms / ms:.3f} of it; f32 "
                      f"{f32_bound:.4f} ms), plain "
                      f"{plain[vdtype, key, n]:.4f} ms, cuSPARSE "
                      f"({lib[n][1]}) {lib[n][0]:.4f} ms; launch {launch}; "
                      f"f32 launch {f32_launch}")
                out[name][vdtype][n] = {
                    "ms": ms, "f32_ms": f32_ms, "ratio_to_f32": ratio,
                    "aim_met": ratio <= QUANTISED_AIM, "bound_ms": bound_ms,
                    "bound_by": bound_by, "f32_bound_ms": f32_bound,
                    "plain_ms": plain[vdtype, key, n],
                    "library_ms": lib[n][0], "library_values": lib[n][1],
                    "launch": launch}
    return out


# ----------------------------------------------------------------------------
# The whole-vector descriptor plan: one decode token through the vocab
# weight (SpMV), and the same plan's SpMM
# ----------------------------------------------------------------------------

TOKEN_KERNELS = ("spmv_cuda_desc_db", "spmv_cuda_desc")


def build_token_plan(mat, device, vdtype=None):
    """``ops.prepare(mat)`` at nvec=1 with the lowering left at its default,
    as a batch-1 caller builds it (at ``vdtype`` where given: bf16 or
    int8): the layout pass must pick whole-vector and the descriptor
    lowering (the reference's choice, at every width). The host time of
    ``formats.chunk_descriptors`` inside the build is taken by wrapping it
    for this one call."""
    from repro_torch.core import formats as F
    from repro_torch.kernels import ops
    seconds = []
    expand = F.chunk_descriptors

    def timed(*args, **kw):
        t0 = time.perf_counter()
        out = expand(*args, **kw)
        seconds.append(time.perf_counter() - t0)
        return out

    F.chunk_descriptors = timed
    try:
        t0 = time.perf_counter()
        plan = ops.prepare(mat, device=device, **(
            {} if vdtype is None else {"vdtype": vdtype}))
        total = time.perf_counter() - t0
    finally:
        F.chunk_descriptors = expand
    entry = next(e for e in plan.trace if e["pass"] == "layout")
    label = value_label(plan)
    print(f"token plan {label}: layout pass "
          f"{json.dumps(entry, sort_keys=True)}; prepare {total:.1f} s, of "
          f"which chunk_descriptors {sum(seconds):.1f} s (host); "
          f"{needed_bytes(plan, whole_plan=True)} bytes")
    if (plan.layout, plan.lowering, entry.get("lowering_reason"),
            label) != ("whole_vector", "descriptor", "cost-model",
                       vdtype or "f32"):
        raise SmokeFailure(f"the batch-1 plan at {vdtype} is {plan.layout} "
                           f"/ {plan.lowering} ({label} values): {entry}")
    print_plan(f"vocab whole_vector descriptor {label}", plan)
    print_spmm_plan(f"vocab whole_vector descriptor {label}", plan)
    return plan


def drive_token(plan, x1, acts, device):
    """``ops.spmv`` with both buffer settings and ``ops.spmm`` at every
    batch on the whole-vector descriptor plan; launch counts of this run."""
    import torch
    from repro_torch.kernels import ops
    counts = reset_all_launches()
    ys = {name: ops.spmv(plan, x1, double_buffer=name.endswith("_db"))
          for name in TOKEN_KERNELS}
    for nvec, a in acts.items():
        ys["spmm_cuda_desc", nvec] = ops.spmm(plan, a.t().contiguous())
    if device.type == "cuda":
        torch.cuda.synchronize()
    return ys, counts()


def measure_token(plan, mask_plan, x1, acts, csr, launches, errs, vper,
                  library, timer=cuda_time_ms):
    """Each whole-vector descriptor SpMV kernel at batch 1, its plain
    version, cuSPARSE ``torch.mv`` and, for context, the mask kernel with
    the same buffering on the mask plan of the same weight; then
    ``spmm_cuda_desc`` at every batch beside its plain version (cuSPARSE
    SpMM and ``spmm_cuda`` on the mask plan come from
    :func:`measure_vocab`). Returns the SpMV numbers and adds
    ``spmm_cuda_desc``'s to ``vper``."""
    import torch
    device = x1.device
    csr_t = sparse_csr(csr, device)
    print("  token: timing cuSPARSE CSR (torch.mv on sparse_csr_tensor)")
    library_ms = timer(lambda: torch.mv(csr_t, x1), device)
    print("  token: timing the plain version")
    plain_ms = timer(lambda: plain_y(plan, x1), device)
    per = {}
    launch = whole_launches(plan)
    for name in TOKEN_KERNELS:
        print(f"  token: timing {name}")
        ms = timer(kernel_call(name, plan, x1), device)
        mask_name = name.replace("_desc", "")
        print(f"  token: timing {mask_name} on the mask plan (context)")
        mask_ms = timer(kernel_call(mask_name, mask_plan, x1), device)
        bound_ms, bound_by, nbytes = bound(plan, csr.nnz)
        print(f"time {name} (token): {ms:.4f} ms, plain {plain_ms:.4f} ms, "
              f"cuSPARSE CSR {library_ms:.4f} ms, bound {bound_ms:.4f} ms "
              f"by {bound_by} ({nbytes} bytes), {mask_name} "
              f"{mask_ms:.4f} ms")
        per[name] = {"launches": launches[name], "max_abs_err": errs[name],
                     "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                     "bound_by": bound_by, "library_ms": library_ms,
                     **desc_bounds(plan, mask_plan, csr.nnz),
                     "mask_ms": mask_ms,
                     "launch": launch[WHOLE_DESC_SPMV[name]]}
    name = "spmm_cuda_desc"
    for nvec, act in acts.items():
        x = act.t().contiguous()
        print(f"  nvec={nvec}: timing the plain version, whole_vector "
              f"descriptor")
        spmm_plain_ms = timer(lambda: plain_y(plan, x), device)
        print(f"  nvec={nvec}: timing {name}")
        ms = timer(kernel_call(name, plan, x), device)
        bound_ms, bound_by, nbytes = bound(plan, csr.nnz, nvec)
        mask_ms = vper["spmm_cuda", nvec]["ms"]
        print(f"time {name} nvec={nvec}: {ms:.4f} ms, plain "
              f"{spmm_plain_ms:.4f} ms, cuSPARSE SpMM {library[nvec]:.4f} "
              f"ms, bound {bound_ms:.4f} ms by {bound_by} ({nbytes} bytes), "
              f"spmm_cuda {mask_ms:.4f} ms")
        vper[name, nvec] = {"ms": ms, "plain_ms": spmm_plain_ms,
                            "bound_ms": bound_ms, "bound_by": bound_by,
                            "library_ms": library[nvec],
                            **desc_bounds(plan, mask_plan, csr.nnz, nvec),
                            "mask_ms": mask_ms,
                            "launch": whole_spmm_launch(plan, nvec, x=x)}
    return per


def token_quantised(mat, tplan, acts, csr, lib, timer=cuda_time_ms):
    """The token plan at bf16 and int8 (:func:`build_token_plan`: each must
    resolve to whole-vector + descriptor by the cost model): ``ops.spmv``
    with both buffer settings and ``ops.spmm`` at every batch
    (:func:`drive_token`, each width's counts holding its three kernels and
    nothing else), every output checked by :func:`check_quantised_y`, then
    each kernel timed in turns with the f32 token plan ``tplan``
    (:func:`measure_quantised`). Both plans are freed before it returns.
    Returns ({vdtype: counts}, {vdtype: {kernel: max|y - plain|}},
    {vdtype: worst pin share}, the timings)."""
    from repro_torch.core.sparse_linear import SparseLinear
    device = tplan.device
    x1 = acts[SPMM_NVECS[0]][0].contiguous()
    xs, refs, smax = quantised_refs(csr, acts)
    key = ("whole_vector", "descriptor")
    plans, launches, errs, pins = {}, {}, {}, {}
    for vdtype in VDTYPES:
        plan = build_token_plan(mat, device, vdtype)
        ys, launches[vdtype] = drive_token(plan, x1, acts, device)
        print(f"launches on the {vdtype} whole-vector descriptor path: "
              f"{launches[vdtype]}")
        want = {"spmv_cuda_desc_db": 1, "spmv_cuda_desc": 1,
                "spmm_cuda_desc": len(acts)}
        got = {k: v for k, v in launches[vdtype].items() if v}
        if got != want:
            raise SmokeFailure(f"{vdtype} token plan: launches {got}, "
                               f"expected {want}")
        errs[vdtype], pins[vdtype] = {}, 0.0
        for k, y in ys.items():
            name, n = (k, 1) if isinstance(k, str) else k
            abs_err, used = check_quantised_y(
                name, vdtype, plan, y, xs[n], refs[n], smax,
                "quantised token plan")
            errs[vdtype][name] = max(errs[vdtype].get(name, 0.0), abs_err)
            pins[vdtype] = max(pins[vdtype], used)
        del ys
        plans[vdtype] = plan
    per = measure_quantised(
        {v: {key: SparseLinear(p)} for v, p in plans.items()},
        {key: SparseLinear(tplan)}, acts, csr, lib, kernels=TOKEN_QUANTISED,
        timer=timer)
    plans.clear()
    return launches, errs, pins, per


# ----------------------------------------------------------------------------
# beta(r,c)_test path: the vocab weight in beta(2,4), singleton blocks split
# off into a COO tail
# ----------------------------------------------------------------------------

def kernel_name(plan, spmm=False, double_buffer=True):
    """The kernel ``ops.spmv`` (or ``ops.spmm``) launches for a whole-vector
    or panel plan (the whole-vector layout has one SpMM kernel)."""
    panels = plan.layout == "panels"
    return ("spmm_cuda" if spmm else "spmv_cuda") + (
        "_panels" if panels else "") + (
        "_desc" if plan.lowering == "descriptor" else "") + (
        "_db" if double_buffer and (panels or not spmm) else "")


def describe_test_plan(name, plan) -> None:
    """The split's numbers and its multi sub-plan's choices."""
    entry = next(e for e in plan.multi.trace if e["pass"] == "layout")
    smax = int(plan.single_rows.shape[1]) if plan.tail_pr else 0
    tail_bytes = sum(a.numel() * a.element_size() for a in plan.arrays)
    print(f"{name}: multi {plan.multi.layout} ({entry['reason']}) + "
          f"{plan.multi.lowering} ({entry.get('lowering_reason')}); "
          f"n_single {plan.n_single} of {plan.nnz} nnz "
          f"({100 * plan.n_single / plan.nnz:.1f} %), multi "
          f"{plan.multi.nblocks} blocks, Avg "
          f"{(plan.nnz - plan.n_single) / max(plan.multi.nblocks, 1):.3f}; "
          f"tail_pr {plan.tail_pr}, tail_xw {plan.tail_xw}, smax {smax}, "
          f"buckets {tuple(plan.single_rows.shape)}, tail {tail_bytes} "
          f"bytes")
    print_spmm_plan(f"{name} multi {plan.multi.layout} "
                    f"{plan.multi.lowering}", plan.multi)


def build_test_layer(w, device):
    """(a) ``SparseLinear.from_dense(w, density=0.1, block=(2, 4),
    layout="test", nvec=128)``: the multi sub-plan must be panels by the
    2 MiB rule (its lowering is the cost model's) and the tail bucketed by
    its panels. The host time of ``formats.split_singletons`` inside the
    build is taken by wrapping it for this one call."""
    from repro_torch.core import formats as F
    from repro_torch.core.sparse_linear import SparseLinear
    seconds = []
    split = F.split_singletons

    def timed(*args, **kw):
        t0 = time.perf_counter()
        out = split(*args, **kw)
        seconds.append(time.perf_counter() - t0)
        return out

    F.split_singletons = timed
    try:
        t0 = time.perf_counter()
        layer = SparseLinear.from_dense(
            w, density=VOCAB["density"], block=TEST_BLOCK, layout="test",
            nvec=VOCAB["nvec"])
        total = time.perf_counter() - t0
    finally:
        F.split_singletons = split
    plan = layer.plan
    print(f"test layer (a): from_dense {total:.1f} s (prune, convert, "
          f"split, plan), of which split_singletons {sum(seconds):.2f} s "
          f"(host)")
    describe_test_plan("test layer (a)", plan)
    entry = next(e for e in plan.multi.trace if e["pass"] == "layout")
    got = (plan.layout, plan.multi.layout, entry["reason"],
           entry.get("lowering_reason"), (plan.multi.r, plan.multi.c))
    if (got != ("test", "panels", "vmem-fit", "cost-model", TEST_BLOCK)
            or plan.tail_pr != plan.multi.pr or not plan.n_single):
        raise SmokeFailure(f"the test layer is {got}, tail_pr "
                           f"{plan.tail_pr}")
    return layer


def convert_test_block(csr):
    """The vocab weight's CSR in beta(2,4) (:data:`TEST_BLOCK`)."""
    from repro_torch.core import formats as F
    t0 = time.perf_counter()
    mat = F.csr_to_spc5(csr, *TEST_BLOCK)
    print(f"beta{TEST_BLOCK}: csr_to_spc5 {time.perf_counter() - t0:.1f} s "
          f"(host)")
    return mat


def build_flat_test_plan(mat, device, vdtype=None):
    """(b) ``ops.prepare(beta(2,4), layout="test")`` at nvec = 1 (at
    ``vdtype`` where given): the multi sub-plan must be whole-vector, so the
    tail stays flat."""
    from repro_torch.kernels import ops
    t0 = time.perf_counter()
    plan = ops.prepare(mat, layout="test", device=device, **(
        {} if vdtype is None else {"vdtype": vdtype}))
    label = value_label(plan.multi)
    print(f"flat-tail plan (b) {label}: prepare "
          f"{time.perf_counter() - t0:.1f} s (host)")
    describe_test_plan(f"flat-tail plan (b) {label}", plan)
    if ((plan.multi.layout, plan.multi.lowering, label) != (
            "whole_vector", "descriptor", vdtype or "f32")
            or plan.tail_pr):
        raise SmokeFailure(f"the flat-tail plan's multi is "
                           f"{plan.multi.layout} + {plan.multi.lowering} "
                           f"({label}), tail_pr {plan.tail_pr}")
    return plan


def build_test_layer_q(mat, device, vdtype):
    """(a) at ``vdtype`` (bf16: the tail stays bf16) from the same beta(2,4)
    matrix, ``ops.prepare(mat, layout="test", vdtype=vdtype, nvec=128)``,
    as a ``SparseLinear``: the multi sub-plan must be panels by the 2 MiB
    rule (lowered by the cost model) and the tail bucketed by its panels,
    both at that width."""
    from repro_torch.core.sparse_linear import SparseLinear
    from repro_torch.kernels import ops
    t0 = time.perf_counter()
    plan = ops.prepare(mat, layout="test", vdtype=vdtype, nvec=VOCAB["nvec"],
                       device=device)
    print(f"test layer (a) {vdtype}: prepare {time.perf_counter() - t0:.1f} "
          f"s (host)")
    describe_test_plan(f"test layer (a) {vdtype}", plan)
    entry = next(e for e in plan.multi.trace if e["pass"] == "layout")
    got = (plan.multi.layout, entry["reason"], entry.get("lowering_reason"),
           (plan.multi.r, plan.multi.c), value_label(plan.multi),
           {2: "bf16", 4: "f32"}[plan.single_values.element_size()])
    if (got != ("panels", "vmem-fit", "cost-model", TEST_BLOCK, vdtype,
                vdtype) or plan.tail_pr != plan.multi.pr
            or not plan.n_single):
        raise SmokeFailure(f"the {vdtype} test layer is {got}, tail_pr "
                           f"{plan.tail_pr}")
    return SparseLinear(plan)


#: The panel descriptor SpMV kernels (rows 8 and 9) run alone on the test
#: layer's multi sub-plan: kernel -> double_buffer.
MULTI_SPMV = {"spmv_cuda_panels_desc_db": True,
              "spmv_cuda_panels_desc": False}


def drive_test(layer, flat, x1, acts, device):
    """(a) the test layer's forward at batch 1 and at every SpMM batch, and
    ``ops.spmv`` on its multi sub-plan alone with both buffer settings;
    (b) ``ops.spmv`` on the flat-tail plan. Launch counts of each run; (a)'s
    also holds the SpMM tail kernel's launches at each batch
    (``"spmm_tail_cuda nvec=<n>"``)."""
    import torch
    from repro_torch.kernels import ops
    counts = reset_all_launches()
    ys = {1: layer(x1)}
    for name, db in MULTI_SPMV.items():
        ys[name] = ops.spmv(layer.plan.multi, x1, double_buffer=db)
    per_nvec = {}
    for nvec, a in acts.items():
        before = counts()[SPMM_TAIL_KERNEL]
        ys[nvec] = layer(a).t()
        per_nvec[f"{SPMM_TAIL_KERNEL} nvec={nvec}"] = (
            counts()[SPMM_TAIL_KERNEL] - before)
    if device.type == "cuda":
        torch.cuda.synchronize()
    launches_a = dict(counts(), **per_nvec)
    counts = reset_all_launches()
    y_flat = ops.spmv(flat, x1)
    if device.type == "cuda":
        torch.cuda.synchronize()
    return ys, y_flat, launches_a, counts()


def check_test_launches(plan, flat, launches_a, launches_b, acts, path):
    """(a) launched both tail kernels (the SpMM one at every batch) and the
    multi SpMV and SpMM kernels, (b) the multi SpMV kernel and no tail
    kernel."""
    for name in (TAIL_KERNEL, kernel_name(plan.multi),
                 kernel_name(plan.multi, spmm=True), SPMM_TAIL_KERNEL,
                 *(f"{SPMM_TAIL_KERNEL} nvec={n}" for n in acts)):
        if launches_a.get(name, 0) <= 0:
            raise SmokeFailure(f"{name} was not launched on the {path} "
                               f"(counts {launches_a})")
    if (launches_b.get(TAIL_KERNEL, 0) != 0
            or launches_b.get(SPMM_TAIL_KERNEL, 0) != 0
            or launches_b.get(kernel_name(flat.multi), 0) <= 0):
        raise SmokeFailure(f"the flat-tail plan's launches on the {path} are "
                           f"{launches_b}")


def check_test(layer, flat, ys, y_flat, launches_a, launches_b, x1, acts,
               csr):
    """The test path's launches (:func:`check_test_launches`) and every
    output within tolerance of the plain path on the card and of the f64
    product."""
    plan = layer.plan
    check_test_launches(plan, flat, launches_a, launches_b, acts, "test path")
    flat_name = kernel_name(flat.multi)
    a64 = f64_matrix(csr)
    y64 = a64 @ x1.cpu().double().numpy()
    check_y(TAIL_KERNEL, ys[1], plan, x1, y64, launches_a,
            f"test path (a), batch 1, with {kernel_name(plan.multi)}")
    tail = tail_parts(plan)[2]
    for nvec, act in acts.items():
        x = act.t().contiguous()
        xh = x.cpu().double().numpy()
        check_spmm(f"{kernel_name(plan.multi, spmm=True)} + "
                   f"{SPMM_TAIL_KERNEL}", ys[nvec], plan, x, a64 @ xh,
                   "test path (a)")
        # the multi sub-plan alone: the whole weight's product less the
        # tail's
        check_panel_spmm(plan.multi, x, a64 @ xh - tail @ xh,
                         "test path (a), multi sub-plan alone",
                         one_chunk=True)
    check_y(flat_name, y_flat, flat, x1, y64, launches_b,
            "test path (b), with spmv_coo")
    # (b)'s multi sub-plan alone: both whole-vector descriptor SpMV kernels
    # at the launch their wrappers pick and at one chunk a CTA
    import scipy.sparse
    rows, cols, vals = (a.cpu().numpy() for a in (
        flat.single_rows, flat.single_cols, flat.single_values))
    flat_tail = scipy.sparse.csr_matrix(
        (vals.astype(np.float64), (rows, cols)), shape=flat.shape)
    y64_flat = y64 - flat_tail @ x1.cpu().double().numpy()
    path = "test path (b), multi sub-plan alone"
    for name in WHOLE_DESC_SPMV:
        check_forced(name, flat.multi, x1, y64_flat, path)
    check_whole_grids(flat.multi, x1, y64_flat, path)
    # the multi sub-plan alone: its f64 product is the whole weight's less
    # the tail's
    y64_multi = y64 - tail @ x1.cpu().double().numpy()
    return {name: check_y(name, ys[name], plan.multi, x1, y64_multi,
                          launches_a, "test path (a), multi sub-plan alone")
            for name in MULTI_SPMV}


def tail_parts(plan):
    """The tail kernel's arguments, and the tail as a host scipy CSR in
    float64 (the padding slots dropped: a singleton's value is never 0; bf16
    values upcast, exactly)."""
    import scipy.sparse
    args = (plan.tail_xbase, plan.single_rows, plan.single_cols,
            plan.single_values)
    kw = dict(pr=plan.tail_pr, xw=plan.tail_xw, nrows=plan.nrows,
              ncols_pad=plan.tail_ncols_pad)
    rows = plan.single_rows.cpu().numpy().astype(np.int64)
    rows += np.arange(rows.shape[0], dtype=np.int64)[:, None] * plan.tail_pr
    vals = plan.single_values.float().cpu().numpy()
    keep = vals != 0
    tail = scipy.sparse.csr_matrix(
        (vals[keep].astype(np.float64),
         (rows[keep], plan.single_cols.cpu().numpy()[keep])),
        shape=(plan.nrows, plan.ncols))
    if tail.nnz != plan.n_single:
        raise SmokeFailure(f"the tail holds {tail.nnz} nonzeros, the plan "
                           f"says {plan.n_single}")
    return args, kw, tail


def check_tail(plan, x1, acts):
    """Both tail kernels alone against their plain versions on the card and
    the f64 product of the tail: ``spmv_tail_cuda`` at its planned launch,
    S = 1 and one group a CTA; ``spmm_tail_cuda`` at every batch at its
    planned launch, G = 1 and one group a CTA (each launch printed).
    Returns max|y - plain| of each at its planned launch and the tail's
    CSR."""
    import torch
    from repro_torch.kernels import spc5_spmv_tail as KT
    args, kw, tail = tail_parts(plan)
    npanels, smax = plan.single_rows.shape
    runs = []
    for split in (None, 1, KT.tail_groups(smax)):
        forced = {} if split is None else {"split": split}
        runs.append((TAIL_KERNEL, forced, x1, KT.spmv_tail_cuda(
            *args, x1, **kw, **forced), tail_launch(plan, **forced)))
    for nvec, act in acts.items():
        x = act.t().contiguous()
        for grid in (None, 1, KT.tail_groups(npanels * smax)):
            forced = {} if grid is None else {"grid": grid}
            runs.append((SPMM_TAIL_KERNEL, forced, x, KT.spmm_tail_cuda(
                *args[1:], x, pr=plan.tail_pr, nrows=plan.nrows, **forced),
                tail_launch(plan, nvec, x, **forced)))
    abs_err = {}
    for name, forced, x, y, launch in runs:
        if y.is_cuda:
            torch.cuda.synchronize()
        plain = tail_y(plan, x)
        y64 = tail @ x.cpu().double().numpy()
        e_plain, e64 = rel_err(y, plain), rel_err(y, torch.from_numpy(y64))
        what = f"{name}{'' if x.dim() == 1 else f' nvec={x.shape[1]}'}"
        print(f"check {what} alone {forced or 'planned'}: max|y - plain| = "
              f"{float((y - plain).abs().max()):.3g} ({e_plain:.3g} of "
              f"max|y|), vs f64 scipy {e64:.3g} of max|y|; launch {launch}")
        if not (e_plain <= TOL and e64 <= TOL and y.shape == plain.shape):
            raise SmokeFailure(f"{what} {forced} disagrees: {e_plain} / "
                               f"{e64} > {TOL}")
        if not forced:
            abs_err[name] = max(abs_err.get(name, 0.0),
                                float((y - plain).abs().max()))
    return abs_err[TAIL_KERNEL], abs_err[SPMM_TAIL_KERNEL], tail


def tail_bound(plan, nvec=1, ops=None, vsize=None):
    """The least time of a tail kernel: the buckets' bytes (8 a slot and
    its value's, 4 f32 or 2 bf16 (``vsize``, default the plan's), padding
    included, and for SpMV the window starts), X read once and Y written
    once, over the HBM rate; 2 flops per slot and column (SpMV, which
    multiplies the padding) or per singleton and column (SpMM, which skips
    it; ``ops``) over the f32 rate. Returns (ms, "bytes" | "operations",
    bytes)."""
    slots = plan.single_rows.numel()
    vsize = plan.single_values.element_size() if vsize is None else vsize
    nbytes = (8 + vsize) * slots + 4 * nvec * (plan.ncols + plan.nrows)
    if nvec == 1:
        nbytes += 4 * plan.tail_xbase.numel()
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = 2 * (slots if ops is None else ops) * nvec / F32_FLOP_PER_S
    return (1e3 * max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations", nbytes)


def measure_test(layer, flat, default, x1, acts, csr, tail, launches,
                 abs_err, spmm_abs_err, library, multi_errs,
                 timer=cuda_time_ms):
    """Both tail kernels beside their bounds, their plain versions and
    cuSPARSE on the tail alone (SpMV at batch 1, SpMM at every batch); the
    test layer's forwards beside the default layer's and cuSPARSE on the
    whole weight; the parts of each forward, the two panel descriptor SpMV
    kernels on the multi sub-plan included; the flat-tail plan's SpMV.
    Returns the multi's numbers of those two kernels and the two tail
    kernels' JSON rows."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.kernels import spc5_spmv_tail as KT
    device = x1.device
    plan = layer.plan
    args, kw, _ = tail_parts(plan)
    tail_t = scipy_csr(tail, device)
    csr_t = sparse_csr(csr, device)
    multi = plan.multi
    parts = {
        "spmv_tail": lambda: KT.spmv_tail_cuda(*args, x1, **kw),
        "spmv_coo_panels": lambda: tail_y(plan, x1),
        "cusparse_tail_batch1": lambda: torch.mv(tail_t, x1),
        "cusparse_batch1": lambda: torch.mv(csr_t, x1),
        "default_batch1": lambda: default(x1),
        "test_batch1": lambda: layer(x1),
        "multi_spmv": kernel_call(kernel_name(multi), multi, x1),
        "flat_spmv": lambda: ops.spmv(flat, x1),
        "flat_multi_spmv": kernel_call(kernel_name(flat.multi), flat.multi,
                                       x1),
        "flat_multi_spmv_s1": kernel_call(
            kernel_name(flat.multi, double_buffer=False), flat.multi, x1),
        "flat_spmv_coo": lambda: tail_y(flat, x1),
    }
    for nvec, act in acts.items():
        x = act.t().contiguous()
        parts.update({
            f"default_nvec{nvec}": lambda a=act: default(a),
            f"test_nvec{nvec}": lambda a=act: layer(a),
            f"multi_spmm_nvec{nvec}": kernel_call(
                kernel_name(multi, spmm=True), multi, x),
            f"multi_spmm_s1_nvec{nvec}": kernel_call(
                "spmm_cuda_panels_desc", multi, x),
            f"spmm_tail_nvec{nvec}": lambda x=x: KT.spmm_tail_cuda(
                *args[1:], x, pr=plan.tail_pr, nrows=plan.nrows),
            f"spmm_coo_panels_nvec{nvec}": lambda x=x: tail_y(plan, x),
            f"cusparse_tail_nvec{nvec}": lambda x=x: tail_t @ x})
    parts["multi_spmv_s1"] = kernel_call("spmv_cuda_panels_desc", multi, x1)
    forwards = {}
    for key, fn in parts.items():
        print(f"  test: timing {key}")
        forwards[key] = timer(fn, device)
    slots = plan.single_rows.numel()
    b_ms, b_by, b_bytes = tail_bound(plan)
    print(f"time {TAIL_KERNEL}: {forwards['spmv_tail']:.4f} ms, plain "
          f"{forwards['spmv_coo_panels']:.4f} ms, cuSPARSE on the tail "
          f"{forwards['cusparse_tail_batch1']:.4f} ms, bound {b_ms:.4f} ms "
          f"by {b_by} ({b_bytes} bytes, {slots} slots); launch "
          f"{tail_launch(plan)}")
    spmm_per = {}
    for nvec, act in acts.items():
        sb = tail_bound(plan, nvec, ops=plan.n_single)
        spmm_per[nvec] = {
            "ms": forwards[f"spmm_tail_nvec{nvec}"],
            "plain_ms": forwards[f"spmm_coo_panels_nvec{nvec}"],
            "bound_ms": sb[0], "bound_by": sb[1], "bound_bytes": sb[2],
            "library_ms": forwards[f"cusparse_tail_nvec{nvec}"],
            "launch": tail_launch(plan, nvec, act.t().contiguous())}
        print(f"time {SPMM_TAIL_KERNEL} nvec={nvec}: "
              f"{spmm_per[nvec]['ms']:.4f} ms, plain "
              f"{spmm_per[nvec]['plain_ms']:.4f} ms, cuSPARSE on the tail "
              f"{spmm_per[nvec]['library_ms']:.4f} ms, bound {sb[0]:.4f} ms "
              f"by {sb[1]} ({sb[2]} bytes); launch "
              f"{spmm_per[nvec]['launch']}")
    print(f"time test layer (a), batch 1: {forwards['test_batch1']:.4f} ms "
          f"({kernel_name(multi)} {forwards['multi_spmv']:.4f} + "
          f"{TAIL_KERNEL} {forwards['spmv_tail']:.4f}); default layer "
          f"{forwards['default_batch1']:.4f} ms; cuSPARSE on the whole "
          f"weight {forwards['cusparse_batch1']:.4f} ms")
    for nvec in acts:
        print(f"time test layer (a), nvec={nvec}: "
              f"{forwards[f'test_nvec{nvec}']:.4f} ms "
              f"({kernel_name(multi, spmm=True)} "
              f"{forwards[f'multi_spmm_nvec{nvec}']:.4f} + "
              f"{SPMM_TAIL_KERNEL} {forwards[f'spmm_tail_nvec{nvec}']:.4f}); "
              f"default layer {forwards[f'default_nvec{nvec}']:.4f} ms; "
              f"cuSPARSE SpMM {library[nvec]:.4f} ms; spmm_cuda_panels_desc "
              f"on the multi {forwards[f'multi_spmm_s1_nvec{nvec}']:.4f} ms")
    multi_bound = bound(multi, plan.nnz - plan.n_single)
    print(f"time {kernel_name(multi)} / spmv_cuda_panels_desc on the multi "
          f"sub-plan, batch 1: {forwards['multi_spmv']:.4f} / "
          f"{forwards['multi_spmv_s1']:.4f} ms, bound {multi_bound[0]:.4f} "
          f"ms by {multi_bound[1]} ({multi_bound[2]} bytes); launch "
          f"{panel_launches(multi)}")
    print(f"time flat-tail plan (b), batch 1: {forwards['flat_spmv']:.4f} "
          f"ms ({kernel_name(flat.multi)} "
          f"{forwards['flat_multi_spmv']:.4f} + spmv_coo "
          f"{forwards['flat_spmv_coo']:.4f}); "
          f"{kernel_name(flat.multi, double_buffer=False)} "
          f"{forwards['flat_multi_spmv_s1']:.4f} ms; launch "
          f"{whole_launches(flat.multi)}")
    multi_rows = {name: {
        "launches": launches[name], "max_abs_err": multi_errs[name],
        "ms": forwards["multi_spmv" if db else "multi_spmv_s1"],
        "bound_ms": multi_bound[0], "bound_by": multi_bound[1],
        "plan_bound_ms": bound(multi, plan.nnz - plan.n_single,
                               whole_plan=True)[0]}
        for name, db in MULTI_SPMV.items()}
    big = VOCAB["nvec"]
    spmm_row = {
        "name": SPMM_TAIL_KERNEL, "route": "cuda", "source": TAIL_SOURCE,
        "replaces": SPMM_TAIL_REPLACES,
        "launches": launches[SPMM_TAIL_KERNEL],
        "max_abs_err": spmm_abs_err,
        **{k: v for k, v in spmm_per[big].items() if k != "launch"},
        "nvec": big, **{f"nvec_{n}": spmm_per[n] for n in acts if n != big},
        "launch": spmm_per[big]["launch"], "slots": slots,
        "n_single": plan.n_single}
    return multi_rows, {
        "name": TAIL_KERNEL, "route": "cuda", "source": TAIL_SOURCE,
        "replaces": TAIL_REPLACES, "launches": launches[TAIL_KERNEL],
        "max_abs_err": abs_err, "ms": forwards["spmv_tail"],
        "plain_ms": forwards["spmv_coo_panels"], "bound_ms": b_ms,
        "bound_by": b_by, "library_ms": forwards["cusparse_tail_batch1"],
        "bound_bytes": b_bytes, "slots": slots, "n_single": plan.n_single,
        "launch": tail_launch(plan), "test_path_ms": forwards}, spmm_row


def test_quantised(f32_layer, f32_flat, mat, acts, csr, lib,
                   timer=cuda_time_ms):
    """The test path at bf16: layer (a) (:func:`build_test_layer_q`, so both
    tail kernels run on bf16 buckets) and the flat-tail plan (b)
    (:func:`build_flat_test_plan`, whose bf16 whole-vector multi runs
    ``spmv_cuda_desc_db``), driven as at f32 (:func:`drive_test`), every
    output checked by :func:`check_quantised_y` (the multi sub-plan alone
    against its plain version and its f64 dequantised product), both tail
    kernels alone by :func:`check_tail`, then timed in turns with f32
    (:func:`measure_test_quantised`). Both plans are freed before it
    returns. Returns the counts of (a) and (b), the tails' max|y - plain|
    and worst pin share, and the timings."""
    import torch
    device = f32_flat.device
    x1 = acts[SPMM_NVECS[0]][0].contiguous()
    layer = build_test_layer_q(mat, device, "bf16")
    flat = build_flat_test_plan(mat, device, "bf16")
    plan, fplan = layer.plan, f32_layer.plan
    same = all(torch.equal(getattr(plan, a), getattr(fplan, a))
               for a in ("single_rows", "single_cols", "tail_xbase"))
    print(f"bf16 test layer (a): buckets {tuple(plan.single_rows.shape)}, "
          f"the f32 layer's rows and columns: {same}")
    ys, y_flat, la, lb = drive_test(layer, flat, x1, acts, device)
    print(f"launches on the bf16 test path: (a) {la}; (b) {lb}")
    check_test_launches(plan, flat, la, lb, acts, "bf16 test path")
    flat_name = kernel_name(flat.multi)
    xs, refs, smax = quantised_refs(csr, acts)
    pins = [check_quantised_y(
        TAIL_KERNEL, "bf16", plan, ys[1], x1, refs[1], smax,
        f"bf16 test layer (a) with {kernel_name(plan.multi)}")[1]]
    for n in acts:
        pins.append(check_quantised_y(
            SPMM_TAIL_KERNEL, "bf16", plan, ys[n], xs[n], refs[n], smax,
            f"bf16 test layer (a) with {kernel_name(plan.multi, spmm=True)}"
        )[1])
    pins.append(check_quantised_y(
        flat_name, "bf16", flat, y_flat, x1, refs[1], smax,
        "bf16 flat-tail plan (b), with spmv_coo")[1])
    for name in MULTI_SPMV:
        y = ys[name]
        e_plain = rel_err(y, plain_y(plan.multi, x1))
        e_deq = rel_err(y, plain_y(plan.multi, x1, torch.float64))
        print(f"check {name} bf16 (bf16 test layer (a), multi sub-plan "
              f"alone): {e_plain:.3g} of max|y| from the plain version, "
              f"{e_deq:.3g} from the f64 dequantised product")
        if not (e_plain <= TOL and e_deq <= TOL):
            raise SmokeFailure(f"{name} bf16 multi disagrees: {e_plain} / "
                               f"{e_deq} > {TOL}")
    del ys, y_flat
    tail_err, spmm_tail_err, _ = check_tail(plan, x1, acts)
    per = measure_test_quantised(plan, flat, f32_flat, x1, acts, lib, timer)
    del layer, flat, plan
    return la, lb, {TAIL_KERNEL: tail_err, SPMM_TAIL_KERNEL: spmm_tail_err}, \
        max(pins), per


def measure_test_quantised(plan, flat, f32_flat, x1, acts, lib,
                           timer=cuda_time_ms):
    """Both tail kernels on the bf16 test layer's buckets beside the same
    buckets with their values upcast to f32 (the same rows and columns),
    timed in turns (f32, bf16, bf16, f32; each width's two medians
    averaged), with each width's bound (:func:`tail_bound`: 10 or 12 bytes
    a slot), the plain version at bf16 and cuSPARSE on the tail (on bf16
    values where the card takes it, else ``lib``'s f32 figure); and the flat
    plan's whole-vector multi at bf16 beside the f32 flat plan's, both
    whole-vector descriptor SpMV kernels in turns. Returns {kernel: {batch:
    numbers}} and {kernel: flat-multi numbers}."""
    from repro_torch.kernels import spc5_spmv_tail as KT
    device = x1.device
    args, kw, tail = tail_parts(plan)
    vals32 = plan.single_values.float()
    tail_t = scipy_csr(tail, device)
    xs = {1: x1}
    xs.update({n: a.t().contiguous() for n, a in acts.items()})
    out = {TAIL_KERNEL: {}, SPMM_TAIL_KERNEL: {}}
    for name, n in ((TAIL_KERNEL, 1),
                    *((SPMM_TAIL_KERNEL, n) for n in acts)):
        x = xs[n]

        def call(vals, x=x, n=n):
            if n == 1:
                return lambda: KT.spmv_tail_cuda(*args[:3], vals, x, **kw)
            return lambda: KT.spmm_tail_cuda(*args[1:3], vals, x,
                                             pr=plan.tail_pr,
                                             nrows=plan.nrows)
        fns = {"f32": call(vals32), "bf16": call(plan.single_values)}
        times = {v: [] for v in fns}
        for v in ("f32", "bf16", "bf16", "f32"):
            print(f"  timing {name} {v} batch {n} (bf16 test layer's "
                  f"buckets)")
            times[v].append(timer(fns[v], device))
        f32_ms, ms = (float(np.mean(times[v])) for v in ("f32", "bf16"))
        ops = None if n == 1 else plan.n_single
        b = tail_bound(plan, n, ops)
        f32_bound = tail_bound(plan, n, ops, vsize=4)[0]
        print(f"  bf16 tail batch {n}: timing the plain version")
        plain_ms = timer(lambda x=x: tail_y(plan, x), device,
                         reps=QUANTISED_PLAIN_REPS)
        library = csr_library_ms(None, x, lib[n], timer, t=tail_t)
        launch = tail_launch(plan, None if n == 1 else n, x)
        ratio = ms / f32_ms
        print(f"time {name} bf16 batch {n}: {ms:.4f} ms ("
              f"{times['bf16'][0]:.4f} / {times['bf16'][1]:.4f}), f32 "
              f"{f32_ms:.4f} ms, {ratio:.3f}x f32 (aim <= {QUANTISED_AIM}: "
              f"{'met' if ratio <= QUANTISED_AIM else 'MISSED'}), bound "
              f"{b[0]:.4f} ms by {b[1]} ({b[2]} bytes, {b[0] / ms:.3f} of "
              f"it; f32 {f32_bound:.4f} ms), plain {plain_ms:.4f} ms, "
              f"cuSPARSE on the tail ({library[1]}) {library[0]:.4f} ms; "
              f"launch {launch}")
        out[name][n] = {
            "ms": ms, "f32_ms": f32_ms, "ratio_to_f32": ratio,
            "aim_met": ratio <= QUANTISED_AIM, "bound_ms": b[0],
            "bound_by": b[1], "f32_bound_ms": f32_bound,
            "plain_ms": plain_ms, "library_ms": library[0],
            "library_values": library[1], "launch": launch}
    multi = {}
    nnz = flat.nnz - flat.n_single
    for name in WHOLE_DESC_SPMV:
        fns = {"f32": kernel_call(name, f32_flat.multi, x1),
               "bf16": kernel_call(name, flat.multi, x1)}
        times = {v: [] for v in fns}
        for v in ("f32", "bf16", "bf16", "f32"):
            print(f"  timing {name} {v} on the flat plan's multi")
            times[v].append(timer(fns[v], device))
        f32_ms, ms = (float(np.mean(times[v])) for v in ("f32", "bf16"))
        b, fb = bound(flat.multi, nnz), bound(f32_flat.multi, nnz)
        print(f"time {name} bf16 (flat plan's multi), batch 1: {ms:.4f} ms, "
              f"f32 {f32_ms:.4f} ms, {ms / f32_ms:.3f}x f32, bound "
              f"{b[0]:.4f} ms by {b[1]} (f32 {fb[0]:.4f} ms)")
        multi[name] = {"ms": ms, "f32_ms": f32_ms,
                       "ratio_to_f32": ms / f32_ms, "bound_ms": b[0],
                       "bound_by": b[1], "f32_bound_ms": fb[0]}
    return out, multi


# ----------------------------------------------------------------------------
# The reorder pass: a reordered plan's column permutation (column maps) in
# the four panel descriptor kernels and the seven mask kernels, on the
# reference's reorder matrix and on the vocab layer
# ----------------------------------------------------------------------------

#: The eleven kernels with a column map, by the name their wrappers count
#: their launches under: the kernel without a map (the same wrapper, called
#: without ``col_map``) and the Pallas function whose ``col_map`` path they
#: replace. The four panel descriptor twins, then the seven mask twins.
CMAP_KERNELS = {
    "spmv_cuda_panels_desc_db_cmap": ("spmv_cuda_panels_desc_db",
                                      "src/repro/kernels/spc5_spmv.py:925"),
    "spmv_cuda_panels_desc_cmap": ("spmv_cuda_panels_desc",
                                   "src/repro/kernels/spc5_spmv.py:824"),
    "spmm_cuda_panels_desc_db_cmap": ("spmm_cuda_panels_desc_db",
                                      "src/repro/kernels/spc5_spmm.py:768"),
    "spmm_cuda_panels_desc_cmap": ("spmm_cuda_panels_desc",
                                   "src/repro/kernels/spc5_spmm.py:654"),
    "spmv_cuda_db_cmap": ("spmv_cuda_db",
                          "src/repro/kernels/spc5_spmv.py:1000"),
    "spmv_cuda_cmap": ("spmv_cuda", "src/repro/kernels/spc5_spmv.py:223"),
    "spmv_cuda_panels_db_cmap": ("spmv_cuda_panels_db",
                                 "src/repro/kernels/spc5_spmv.py:490"),
    "spmv_cuda_panels_cmap": ("spmv_cuda_panels",
                              "src/repro/kernels/spc5_spmv.py:376"),
    "spmm_cuda_cmap": ("spmm_cuda", "src/repro/kernels/spc5_spmm.py:140"),
    "spmm_cuda_panels_db_cmap": ("spmm_cuda_panels_db",
                                 "src/repro/kernels/spc5_spmm.py:449"),
    "spmm_cuda_panels_cmap": ("spmm_cuda_panels",
                              "src/repro/kernels/spc5_spmm.py:309"),
}
#: Each map kernel's source, by (SpMM, descriptor).
CMAP_SOURCE = {
    (False, True): "src/repro_torch/kernels/csrc/spc5_spmv_desc.cu",
    (True, True): "src/repro_torch/kernels/csrc/spc5_spmm_desc_cmap.cu",
    (False, False): "src/repro_torch/kernels/csrc/spc5_spmv.cu",
    (True, False): "src/repro_torch/kernels/csrc/spc5_spmm_cmap.cu"}
#: The reference bench's reorder matrix class (benchmarks/bench_spmv_seq.py:
#: 79-97, a band under a random symmetric permutation) at atmosmodd scale
#: (about 6.5 M nonzeros), in beta(1,8), and the bench's first panel
#: geometry.
REORDER = dict(dim=1_000_000, band=8, fill=1.0, seed=42, block=(1, 8),
               pr=256, xw=512, cb=64)
#: The map kernels' aim: at most this many times the same kernel run on the
#: same arrays against x[col_perm] with no map, timed in turns.
CMAP_AIM = 1.10
#: The plans the small check holds the map kernels on: (layout, lowering,
#: geometry).
SMALL_CMAP_PLANS = (("panels", "descriptor", dict(pr=64, xw=64, cb=4)),
                    ("panels", "mask", dict(pr=64, xw=64, cb=4)),
                    ("whole_vector", "mask", dict(cb=16)))


def cmap_plan_key(name):
    """The plan (layout, lowering) map kernel ``name`` runs on."""
    if "desc" in name:
        return "panels", "descriptor"
    return ("panels" if "panels" in name else "whole_vector"), "mask"


def plan_kernels(plan):
    """The map kernels that run on ``plan``'s layout and lowering."""
    return [k for k in CMAP_KERNELS
            if cmap_plan_key(k) == (plan.layout, plan.lowering)]


def mapped_plain(plan, dev, scale, v, cmap):
    """The plain version of ``plan``'s product (its tensors ``dev``) with
    column map ``cmap``: the panel layouts map each column through it, the
    whole-vector one reads ``x[cmap]``."""
    from repro_torch.core import ref_spmv as R
    spmm = v.dim() == 2
    if plan.lowering == "descriptor":
        fn = R.spmm_panels_desc if spmm else R.spmv_panels_desc
        return fn(dev, v, cmap, scale, pr=plan.pr, nrows=plan.nrows,
                  ncols_pad=plan.ncols_pad)
    if plan.layout == "panels":
        fn = R.spmm_panels if spmm else R.spmv_panels
        return fn(dev, v, cmap, scale, r=plan.r, c=plan.c, pr=plan.pr,
                  nrows=plan.nrows, ncols_pad=plan.ncols_pad)
    fn = R.spmm if spmm else R.spmv
    return fn(dev, v.index_select(0, cmap), scale, r=plan.r, c=plan.c,
              nrows=plan.nrows, ncols=plan.ncols)


def cmap_check(plan, cmap, x, xs, values=None):
    """The map kernels of ``plan``'s layout and lowering with map ``cmap``
    against their plain version: SpMV at the planned launch, S = 1 / G = 1
    and one chunk a CTA; SpMM on each X of ``xs`` at the planned launch and
    S = 1 / G = 1. Returns (worst error over max|y|, calls per kernel)."""
    from repro_torch.core.plan import _plan_scale
    dev = plan.dev if values is None else plan.dev._replace(values=values)
    scale = _plan_scale(plan)
    key = "split" if plan.layout == "panels" else "grid"
    nchunks = int(plan.chunk_vbase.shape[-1])
    worst, calls = 0.0, {}
    for name in plan_kernels(plan):
        twin = CMAP_KERNELS[name][0]
        spmm = name.startswith("spmm")
        forced = (None, 1) if spmm else (None, 1, nchunks)
        for v in (xs.values() if spmm else (x,)):
            want = mapped_plain(plan, dev, scale, v, cmap)
            for f in forced:
                got = kernel_call(twin, plan, v, values=values, col_map=cmap,
                                  **({} if f is None else {key: f}))()
                err = rel_err(got, want)
                worst = max(worst, err)
                calls[name] = calls.get(name, 0) + 1
                if tuple(got.shape) != tuple(want.shape) or not err <= TOL:
                    raise SmokeFailure(
                        f"small check: {name} {value_label(plan)} "
                        f"{(plan.r, plan.c)} {tuple(v.shape)} {key}={f}: rel "
                        f"err {err}")
    return worst, calls


def reaching_int8_plan(device, layout="panels", lowering="descriptor",
                       geom=None):
    """An int8 plan (powerlaw, beta(4,8); panels of 64 rows, windows of 64
    columns, cb 4, unless ``geom``) whose last window's 16-byte aligned
    span would reach past its values."""
    from repro_torch.core import formats as F
    from repro_torch.core import matgen
    from repro_torch.kernels import ops
    geom = dict(pr=64, xw=64, cb=4) if geom is None else geom
    for seed in range(40):
        mat = F.csr_to_spc5(matgen.powerlaw(200 + 10 * seed, 5, seed=seed),
                            4, 8)
        plan = ops.prepare(mat, layout=layout, lowering=lowering,
                           vdtype="int8", tune=False, device=device, **geom)
        if spans_past_values(plan):
            return plan
    raise SmokeFailure(f"small check: no int8 {layout} {lowering} plan's "
                       f"last span reaches past its values")


def shuffled_chunks(plan, seed):
    """``plan`` with its chunks in a random order (the values stay where
    they lie, each chunk's window start goes with it): the whole-vector
    kernels then meet block rows out of order."""
    import dataclasses
    import torch
    n = int(plan.chunk_vbase.shape[0])
    perm = torch.from_numpy(np.random.default_rng(seed).permutation(n)).to(
        plan.values.device)
    arrays = tuple(a if a is plan.values else a.index_select(0, perm)
                   for a in plan.arrays)
    return dataclasses.replace(plan, arrays=arrays)


def small_check_cmap(device) -> float:
    """The eleven map kernels at f32, bf16 and int8 on every block shape
    (302 x 700; the panel plans in panels of 64 rows and windows of 64
    columns, cb 4: 700 % 64 != 0, so the last windows reach columns at or
    past ncols; the whole-vector mask plan at cb 16), each with a random
    permutation as its map: SpMV at its planned launch, S = 1 / G = 1 and
    one chunk a CTA, SpMM at nvec 3, 16 and 128 at its planned launch and
    S = 1 / G = 1; the whole-vector mask twins also on a plan whose chunks
    come in a random order (block rows out of order); an int8 plan of each
    layout and lowering whose last span would reach past its values,
    copied into a tensor of exactly their length; each counted once a call
    under its own name. Returns the worst error over max|y|."""
    import torch
    from repro_torch.core import formats as F
    from repro_torch.kernels import ops
    counts = reset_all_launches()
    worst, calls = 0.0, {}

    def run(plan, cmap, x, xs, values=None):
        nonlocal worst
        err, n = cmap_check(plan, cmap, x, xs, values)
        worst = max(worst, err)
        for k, v in n.items():
            calls[k] = calls.get(k, 0) + v

    def inputs(rng, ncols, nvecs):
        cmap = torch.from_numpy(rng.permutation(ncols).astype(
            np.int32)).to(device)
        x = torch.from_numpy(rng.standard_normal(ncols).astype(
            np.float32)).to(device)
        xs = {n: torch.from_numpy(rng.standard_normal((ncols, n)).astype(
            np.float32)).to(device) for n in nvecs}
        return cmap, x, xs

    for rc in F.SUPPORTED_BLOCKS:
        rng = np.random.default_rng(5 * rc[0] + rc[1])
        d = ((rng.random((302, 700)) < 0.05)
             * rng.standard_normal((302, 700))).astype(np.float32)
        mat = F.csr_to_spc5(F.csr_from_dense(d), *rc)
        cmap, x, xs = inputs(rng, 700, (3, 16, 128))
        for vdtype in ("f32", *VDTYPES):
            for layout, lowering, geom in SMALL_CMAP_PLANS:
                plan = ops.prepare(mat, layout=layout, lowering=lowering,
                                   vdtype=vdtype, tune=False, device=device,
                                   **geom)
                if layout == "panels" and (plan.ncols % plan.xw == 0
                                           or plan.ncols_pad <= plan.ncols):
                    raise SmokeFailure(f"small check: {rc} windows stay "
                                       f"inside ncols ({plan.ncols}, "
                                       f"{plan.xw})")
                run(plan, cmap, x, xs)
                if layout == "whole_vector" and vdtype == "f32":
                    run(shuffled_chunks(plan, 5), cmap, x, xs)
    for seed, (layout, lowering, geom) in enumerate(SMALL_CMAP_PLANS):
        plan = reaching_int8_plan(device, layout, lowering, geom)
        exact = torch.empty(plan.values.numel(), dtype=plan.values.dtype,
                            device=device)
        exact.copy_(plan.values)
        cmap, x, xs = inputs(np.random.default_rng(3 + seed), plan.ncols,
                             (16,))
        run(plan, cmap, x, xs, values=exact)
    launches = counts()
    for name in CMAP_KERNELS:
        if launches[name] != calls[name]:
            raise SmokeFailure(f"small check: {name} counted "
                               f"{launches[name]} launches for {calls[name]} "
                               f"calls")
    others = {k: v for k, v in launches.items() if v and k not in calls}
    if others:
        raise SmokeFailure(f"small check: the map calls counted {others}")
    print(f"  column maps: the {len(CMAP_KERNELS)} map kernels at f32, bf16 "
          f"and int8 x {len(F.SUPPORTED_BLOCKS)} block shapes on panel "
          f"descriptor, panel mask and whole-vector mask plans (SpMV at the "
          f"planned launch, S / G = 1, one chunk a CTA; SpMM nvec 3, 16, 128 "
          f"at the planned launch and S / G = 1), windows past ncols, "
          f"whole-vector chunks out of order, int8 plans whose last span "
          f"would reach past their exact-length values; launches {calls}; "
          f"worst {worst:.3g} of max|y|")
    return worst


def map_bound(plan, nnz, nvec=1):
    """A map kernel's bound: :func:`bound`'s bytes with the map's 4 * ncols
    bytes counted once. Returns (ms, "bytes" | "operations", bytes)."""
    _, _, nbytes = bound(plan, nnz, nvec)
    nbytes += 4 * plan.ncols
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = 2 * nnz * nvec / F32_FLOP_PER_S
    return (1e3 * max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations", nbytes)


def in_turns(plan, name, v, timer=cuda_time_ms):
    """Map kernel ``name`` on ``plan`` (its kept col_perm as the map) and
    its twin on the same arrays against x[col_perm] with no map, timed in
    turns (map, no map, no map, map): the same arithmetic, so the ratio is
    the map's cost. Returns {"ms", "no_map_ms", "ratio"}."""
    twin = CMAP_KERNELS[name][0]
    cmap = plan.col_perm
    xg = v.index_select(0, cmap).contiguous()
    t = {"map": [], "none": []}
    for which in ("map", "none", "none", "map"):
        print(f"  timing {name} ({'map' if which == 'map' else 'no map, '
                                 'x[col_perm]'})")
        fn = (kernel_call(twin, plan, v, col_map=cmap) if which == "map"
              else kernel_call(twin, plan, xg))
        t[which].append(timer(fn, v.device))
    ms, none_ms = float(np.mean(t["map"])), float(np.mean(t["none"]))
    return {"ms": ms, "no_map_ms": none_ms, "ratio": ms / none_ms}


def make_band():
    """:data:`REORDER`'s matrix and its beta(1,8) conversion."""
    from repro_torch.core import formats as F
    from repro_torch.core import matgen
    t0 = time.perf_counter()
    csr = matgen.scrambled_banded(REORDER["dim"], REORDER["band"],
                                  REORDER["fill"], seed=REORDER["seed"])
    t1 = time.perf_counter()
    mat = F.csr_to_spc5(csr, *REORDER["block"])
    print(f"reorder matrix: scrambled_banded({REORDER['dim']}, "
          f"{REORDER['band']}, {REORDER['fill']}, seed={REORDER['seed']}): "
          f"{csr.nnz} nnz -> beta{REORDER['block']}, {mat.nblocks} blocks "
          f"(host: generate {t1 - t0:.1f} s, csr_to_spc5 "
          f"{time.perf_counter() - t1:.1f} s)")
    return csr, mat


def band_reordering(mat):
    """The band's RCM Reordering, built once on the host
    (``reorder.reorder(mat, "rcm")`` at the panel geometry: what
    ``ops.prepare(reorder="rcm")`` builds there). Returns it and its host
    seconds."""
    from repro_torch.core import reorder as RE
    geom = {k: REORDER[k] for k in ("pr", "xw", "cb")}
    t0 = time.perf_counter()
    reo = RE.reorder(mat, "rcm", r=mat.r, c=mat.c, **geom)
    seconds = time.perf_counter() - t0
    print(f"band RCM reordering: reorder() {seconds:.1f} s of host, stats "
          f"{json.dumps(reo.stats, sort_keys=True)}")
    return reo, seconds


def build_band_plans(mat, reo, device):
    """The plans the band's Reordering ``reo`` (:func:`band_reordering`)
    goes to:
    ``ops.prepare(mat, layout="panels", pr=256, xw=512, cb=64, tune=False,
    reorder=reo)``, which must be panels + descriptor (the cost model's
    pick) with col_perm and row_iperm kept and fewer chunks than the
    original order; the mask plans ``layout="panels", lowering="mask"`` at
    the same geometry (col_perm and row_iperm kept) and ``layout=
    "whole_vector", lowering="mask"`` (col_perm kept, the rows fused). Beside
    them the unreordered plans, whole-vector + descriptor and whole-vector +
    mask (the original order's panel plan at this geometry pads every panel
    to the largest panel's count of chunks, each about one block in this
    scattered structure: far past the card; the stats say how many).
    Returns {name: plan}."""
    from repro_torch.kernels import ops
    geom = {k: REORDER[k] for k in ("pr", "xw", "cb")}
    t1 = time.perf_counter()
    plan = ops.prepare(mat, layout="panels", tune=False, reorder=reo,
                       device=device, **geom)
    if plan.lowering != "descriptor":
        print(f"  the reordered plan resolved to {plan.layout} + "
              f"{plan.lowering}; rebuilt with lowering='descriptor'")
        plan = ops.prepare(mat, layout="panels", lowering="descriptor",
                           tune=False, reorder=reo, device=device, **geom)
    plans = {"descriptor": plan}
    plans["mask_panels"] = ops.prepare(mat, layout="panels", lowering="mask",
                                       tune=False, reorder=reo, device=device,
                                       **geom)
    plans["mask_whole"] = ops.prepare(mat, layout="whole_vector",
                                      lowering="mask", tune=False,
                                      reorder=reo, device=device)
    t2 = time.perf_counter()
    print(f"reordered plans: prepare {t2 - t1:.1f} s for the three")
    for name, (layout, lowering) in (
            ("descriptor", ("panels", "descriptor")),
            ("mask_panels", ("panels", "mask")),
            ("mask_whole", ("whole_vector", "mask"))):
        p = plans[name]
        whole = layout == "whole_vector"
        got = (p.layout, p.lowering, p.strategy, p.col_perm is not None,
               p.row_iperm is None, p.rows_fused)
        if got != (layout, lowering, "rcm", True, whole, whole):
            raise SmokeFailure(f"the reordered {name} plan is {got}")
    stats = plan.stats
    if not stats["nchunks_post"] < stats["nchunks_pre"]:
        raise SmokeFailure(f"RCM did not cut the chunks: {stats}")
    npanels = plan.npanels
    print(f"  chunks: {stats['nchunks_pre']:.0f} in the original order "
          f"({stats['nchunks_pre'] / npanels:.1f} a panel over {npanels} "
          f"panels), {stats['nchunks_post']:.0f} after RCM "
          f"({stats['nchunks_post'] / npanels:.1f} a panel; the descriptor "
          f"plan pads to {plan.nchunks}, the mask plan to "
          f"{plans['mask_panels'].nchunks}); bandwidth {stats['bw_pre']:.1f} "
          f"-> {stats['bw_post']:.1f}")
    print_spmm_plan("reordered band panels descriptor", plan)
    print_spmm_plan("reordered band panels mask", plans["mask_panels"])
    print_spmm_plan("reordered band whole-vector mask", plans["mask_whole"])
    for name, lowering in (("base", "descriptor"), ("base_mask", "mask")):
        t3 = time.perf_counter()
        plans[name] = ops.prepare(mat, layout="whole_vector",
                                  lowering=lowering, tune=False,
                                  device=device)
        print(f"unreordered plan: whole_vector + {lowering}, prepare "
              f"{time.perf_counter() - t3:.1f} s, "
              f"{sum(a.numel() * a.element_size() for a in plans[name].arrays)}"
              f" bytes")
    for name in ("descriptor", "mask_panels", "mask_whole", "base_mask"):
        p = plans[name]
        print(f"  band {name}: {sum(a.numel() * a.element_size() for a in p.arrays)} "
              f"bytes of plan, needed {needed_bytes(p)}")
    return plans


def band_inputs(n, device, nvecs=SPMM_NVECS):
    """x and each X of ``nvecs`` columns for the band, from
    ``default_rng(2)``."""
    import torch
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.standard_normal(n).astype(np.float32)).to(
        device)
    xs = {m: torch.from_numpy(rng.standard_normal((n, m)).astype(
        np.float32)).to(device) for m in nvecs}
    return x, xs


def drive_band(plan, x, xs):
    """A reordered band plan through ``ops``: ``ops.spmv`` with
    ``double_buffer`` True and False, ``ops.spmm`` at each batch with both;
    the map kernels of its layout and lowering must have run and nothing
    else. Returns the outputs and the counts."""
    import torch
    from repro_torch.kernels import ops
    kernels = plan_kernels(plan)
    counts = reset_all_launches()
    ys = {("spmv", True): ops.spmv(plan, x),
          ("spmv", False): ops.spmv(plan, x, double_buffer=False)}
    for m, xm in xs.items():
        for db in (True, False):
            ys["spmm", db, m] = ops.spmm(plan, xm, double_buffer=db)
    torch.cuda.synchronize()
    launches = counts()
    for name in kernels:
        if launches[name] <= 0:
            raise SmokeFailure(f"{name} was not launched on the reordered "
                               f"band (counts {launches})")
    others = {k: v for k, v in launches.items() if v and k not in kernels}
    if others:
        raise SmokeFailure(f"the reordered band ran other kernels: {others}")
    return ys, launches


def base_outputs(plan, x, xs):
    """An unreordered plan's SpMV and SpMM outputs (uncounted)."""
    from repro_torch.kernels import ops
    return {"spmv": ops.spmv(plan, x),
            **{("spmm", m): ops.spmm(plan, xm) for m, xm in xs.items()}}


def check_band(name, plan, base_ys, y64s, x, xs, ys):
    """Every output of reordered plan ``name`` within ``TOL`` of max|y| of
    its unreordered plan's (``base_ys``) and of the float64 CSR product
    (``y64s``; x and y in the original order); each map kernel's own output
    (its launch uncounted) against its plain version. Returns each map
    kernel's max|y - plain|."""
    errs = {}
    for key, y in ys.items():
        ref_key = "spmv" if key[0] == "spmv" else ("spmm", key[2])
        e_base, e64 = rel_err(y, base_ys[ref_key]), rel_err(y, y64s[ref_key])
        print(f"check reordered band {name} {key}: vs the unreordered plan "
              f"{e_base:.3g}, vs f64 scipy {e64:.3g} of max|y|")
        if not (e_base <= TOL and e64 <= TOL):
            raise SmokeFailure(f"reordered band {name} {key} disagrees: "
                               f"{e_base} / {e64} > {TOL}")
    for kernel in plan_kernels(plan):
        twin = CMAP_KERNELS[kernel][0]
        for v in ((x,) if kernel.startswith("spmv") else xs.values()):
            got = kernel_call(twin, plan, v, col_map=plan.col_perm)()
            plain = plain_y(plan, v)
            err = rel_err(got, plain)
            errs[kernel] = max(errs.get(kernel, 0.0),
                               float((got - plain).abs().max()))
            del plain
            if not err <= TOL:
                raise SmokeFailure(f"{kernel} on the reordered band: {err}")
    print(f"  map kernels against their plain versions on the reordered "
          f"band ({name}): max|y - plain| {errs}")
    return errs


def measure_band(plans, csr, x, xs, timer=cuda_time_ms):
    """Each map kernel on its reordered band plan: in turns with its twin
    on x[col_perm] (:func:`in_turns`), its bound (:func:`map_bound`), its
    plain version and cuSPARSE on the same CSR; and the SpMV of every band
    plan through ``ops`` beside cuSPARSE. Returns {kernel: {batch:
    numbers}} and the SpMV path's numbers."""
    import torch
    from repro_torch.kernels import ops
    t = sparse_csr(csr, x.device)
    lib = {1: timer(lambda: torch.mv(t, x), x.device)}
    print(f"  cuSPARSE on the band, batch 1: {lib[1]:.4f} ms")
    for m, xm in xs.items():
        lib[m] = timer(lambda xm=xm: t @ xm, x.device)
    out = {}
    for name in ("descriptor", "mask_panels", "mask_whole"):
        plan = plans[name]
        for kernel in plan_kernels(plan):
            for m, v in (((1, x),) if kernel.startswith("spmv")
                         else xs.items()):
                row = in_turns(plan, kernel, v, timer)
                row["plain_ms"] = timer(lambda v=v: plain_y(plan, v),
                                        x.device, reps=QUANTISED_PLAIN_REPS)
                row["bound_ms"], row["bound_by"], row["bytes"] = map_bound(
                    plan, csr.nnz, m)
                row["library_ms"] = lib[m]
                print(f"time {kernel} band batch {m}: {row['ms']:.4f} ms, no "
                      f"map on x[col_perm] {row['no_map_ms']:.4f} ms "
                      f"({row['ratio']:.3f}x, aim <= {CMAP_AIM}), plain "
                      f"{row['plain_ms']:.4f} ms, cuSPARSE {lib[m]:.4f} ms, "
                      f"bound {row['bound_ms']:.4f} ms ({row['bytes']} "
                      f"bytes)")
                out.setdefault(kernel, {})[m] = row
    spmv = {f"{name}_ms": timer(lambda p=p: ops.spmv(p, x), x.device)
            for name, p in plans.items()}
    spmv["library_ms"] = lib[1]
    print(f"time band SpMV through ops (the default double buffer): "
          f"reordered panels descriptor (map kernel + row gather) "
          f"{spmv['descriptor_ms']:.4f} ms, reordered panels mask (map "
          f"kernel + row gather) {spmv['mask_panels_ms']:.4f} ms, reordered "
          f"whole-vector mask (map kernel, rows fused) "
          f"{spmv['mask_whole_ms']:.4f} ms, unreordered whole-vector "
          f"descriptor {spmv['base_ms']:.4f} ms, unreordered whole-vector "
          f"mask {spmv['base_mask_ms']:.4f} ms, cuSPARSE {lib[1]:.4f} ms")
    return out, spmv


def reorder_band(csr, mat, reo, device, timer=cuda_time_ms):
    """Phase: the reordered SpMV and SpMM on :data:`REORDER`'s matrix
    (``csr``, ``mat``: :func:`make_band`; ``reo``: :func:`band_reordering`),
    the panel descriptor plan and both mask plans."""
    plans = build_band_plans(mat, reo, device)
    del mat
    x, xs = band_inputs(plans["base"].ncols, device)
    a64 = f64_matrix(csr)
    y64s = {"spmv": a64 @ x.cpu().double().numpy(),
            **{("spmm", m): a64 @ xm.cpu().double().numpy()
               for m, xm in xs.items()}}
    bases = {lowering: base_outputs(plans[name], x, xs)
             for name, lowering in (("base", "descriptor"),
                                    ("base_mask", "mask"))}
    launches, errs = {}, {}
    for name in ("descriptor", "mask_panels", "mask_whole"):
        plan = plans[name]
        ys, counted = drive_band(plan, x, xs)
        print(f"launches on the reordered band ({name}): "
              f"{ {k: v for k, v in counted.items() if v} }")
        launches.update({k: counted[k] for k in plan_kernels(plan)})
        errs.update(check_band(name, plan, bases[plan.lowering], y64s, x, xs,
                               ys))
        del ys
    del bases, y64s
    per, spmv = measure_band(plans, csr, x, xs, timer)
    return {"launches": launches, "errs": errs, "per": per, "spmv": spmv,
            "stats": plans["descriptor"].stats}


def panel_rows_reordering(seed=7):
    """(3b)'s prebuilt Reordering of the vocab weight: its 125 row panels of
    512 rows in a random order (whole panels, so the panel layout fuses the
    rows) and a random column permutation from ``default_rng(7)``.

    Its ``permute_spc5`` re-blocks the matrix it was last given once and
    hands the same permuted matrix to every later prepare of that matrix
    (26 M nonzeros re-blocked on the host each time otherwise); the
    plan pipeline reads the matrix and never writes it, as every prepare
    of the unpermuted weight shares it. ``reblocked`` counts the
    re-blockings and their seconds."""
    from repro_torch.core import reorder as RE

    class ReblockOnce(RE.Reordering):
        def permute_spc5(self, mat):
            memo = self.__dict__.get("_memo")
            if memo is None or memo[0] is not mat:
                t = time.perf_counter()
                memo = (mat, super().permute_spc5(mat))
                object.__setattr__(self, "_memo", memo)
                self.reblocked.append(time.perf_counter() - t)
            return memo[1]

    rng = np.random.default_rng(seed)
    cols = rng.permutation(VOCAB["cols"]).astype(np.int64)
    panels = rng.permutation(VOCAB["rows"] // 512)
    rows = (panels[:, None] * 512 + np.arange(512)).reshape(-1)
    reo = ReblockOnce(rows.astype(np.int64), cols, "custom")
    object.__setattr__(reo, "reblocked", [])
    return reo


#: (3b)'s layers: (layout, lowering) -> the ``ops.prepare`` keywords that
#: build it beside ``nvec=128`` and the Reordering, and its value widths.
#: Every layer runs at f32, the default layer also at bf16 and the mask
#: panel layer also at int8, so the reordered quantised path runs at vocab
#: width at both narrow widths: each reordered prepare of the weight
#: re-blocks 26 M nonzeros on the host (16-31 s), and the smoke's time is
#: capped (the serving phase took the room of the other narrow layers); the
#: small check holds the eleven map kernels at bf16 and int8.
VOCAB_REORDERED = {
    ("panels", "descriptor"): ({}, ("f32", "bf16")),
    ("panels", "mask"): (dict(lowering="mask"), ("f32", "int8")),
    ("whole_vector", "mask"): (dict(layout="whole_vector", lowering="mask"),
                               ("f32",)),
}


def build_vocab_reordered(w, mat, device):
    """(3a) ``SparseLinear.from_dense(w, density=0.1, nvec=128,
    reorder="auto")``: the host reorder pass tries the three strategies on
    the pruned weight and keeps the best, or declines; (3b) the same call
    with :func:`panel_rows_reordering`, which must be panels + descriptor
    with the rows fused and col_perm kept, and the same Reordering through
    the two mask layers of :data:`VOCAB_REORDERED` (``lowering="mask"``,
    whose auto layout must be panels, and ``layout="whole_vector",
    lowering="mask"``), each with the rows fused and col_perm kept, at the
    value widths :data:`VOCAB_REORDERED` names. Returns (layer a, {(vdtype,
    (layout, lowering)): layer b}, host seconds)."""
    from repro_torch.core.sparse_linear import SparseLinear
    from repro_torch.kernels import ops
    t0 = time.perf_counter()
    auto = SparseLinear.from_dense(w, density=VOCAB["density"],
                                   nvec=VOCAB["nvec"], reorder="auto")
    t1 = time.perf_counter()
    entry = next(e for e in auto.plan.trace if e["pass"] == "reorder")
    print(f"vocab (3a) reorder='auto': from_dense {t1 - t0:.1f} s (host "
          f"reorder pass {entry['duration_s']:.1f} s); reorder entry "
          f"{json.dumps(entry, sort_keys=True)}; plan {auto.plan.layout} + "
          f"{auto.plan.lowering}, col_perm kept "
          f"{auto.plan.col_perm is not None}, row_iperm kept "
          f"{auto.plan.row_iperm is not None}, rows_fused "
          f"{auto.plan.rows_fused}")
    stats = entry.get("stats", {})
    better = ((stats.get("nchunks_post"), stats.get("bw_post"))
              < (stats.get("nchunks_pre"), stats.get("bw_pre")))
    if (entry["applied"] != bool(stats.get("applied"))
            or entry["applied"] != better
            or (entry["strategy"] == "auto") == entry["applied"]):
        raise SmokeFailure(f"(3a)'s reorder entry is inconsistent: {entry}")
    reo = panel_rows_reordering()
    t2 = time.perf_counter()
    desc = ("panels", "descriptor")
    layers = {("f32", desc): SparseLinear.from_dense(
        w, density=VOCAB["density"], nvec=VOCAB["nvec"], reorder=reo)}
    t3 = time.perf_counter()
    host = {}
    for key, (kw, vdtypes) in VOCAB_REORDERED.items():
        for vdtype in vdtypes:
            if (vdtype, key) in layers:
                continue
            t = time.perf_counter()
            layers[vdtype, key] = SparseLinear(ops.prepare(
                mat, nvec=VOCAB["nvec"], reorder=reo, device=device,
                **({} if vdtype == "f32" else {"vdtype": vdtype}), **kw))
            host[f"{vdtype} {key[0]} {key[1]}"] = time.perf_counter() - t
    t4 = time.perf_counter()
    object.__setattr__(reo, "_memo", None)
    for (vdtype, key), layer in layers.items():
        p = layer.plan
        got = (p.layout, p.lowering, p.rows_fused, p.col_perm is not None,
               p.row_iperm is None, p.strategy, value_label(p))
        if got != (*key, True, True, True, "custom", vdtype):
            raise SmokeFailure(f"(3b) {vdtype} {key} plan is {got}")
    print(f"vocab (3b) prebuilt Reordering (whole 512-row panels, columns by "
          f"default_rng(7)): from_dense {t3 - t2:.1f} s, the other layers' "
          f"prepare {t4 - t3:.1f} s ({ {k: round(v, 1) for k, v in host.items()} }; "
          f"re-blocked {len(reo.reblocked)} times, "
          f"{[round(v, 1) for v in reo.reblocked]} s); each rows fused, "
          f"col_perm kept")
    for key in VOCAB_REORDERED:
        print_spmm_plan(f"vocab (3b) f32 {key[0]} {key[1]}",
                        layers["f32", key].plan)
    return auto, layers, {"a_s": t1 - t0, "b_s": t4 - t2,
                          "a_reorder_s": entry["duration_s"]}


def drive_vocab_reordered(auto, layers, acts, device):
    """(3a)'s forwards at batch 1, 16 and 128 (counted alone), then (3b)'s
    layers at every width through the entry points a user calls, as the
    quantised layers run (:data:`QUANTISED_LAYERS`): the forward at each
    batch and ``ops.spmv`` / ``ops.spmm(double_buffer=False)``, so all
    eleven map kernels run at each width; (3b)'s counts hold the map
    kernels, each as often as its calls, and nothing else. Returns (3a)'s
    outputs and counts, (3b)'s outputs ({(vdtype, layer, kernel, batch):
    y}) and counts."""
    import torch
    from repro_torch.kernels import ops
    x1 = acts[SPMM_NVECS[0]][0].contiguous()
    counts = reset_all_launches()
    ya = {1: auto(x1), **{n: auto(a).t() for n, a in acts.items()}}
    torch.cuda.synchronize()
    la = counts()
    counts = reset_all_launches()
    yb, want = {}, dict.fromkeys(CMAP_KERNELS, 0)
    for (vdtype, key), layer in layers.items():
        fwd1, twin1, fwdm, twinm = (None if k is None else f"{k}_cmap"
                                    for k in QUANTISED_LAYERS[key])
        yb[vdtype, key, fwd1, 1] = layer(x1)
        yb[vdtype, key, twin1, 1] = ops.spmv(layer.plan, x1,
                                             double_buffer=False)
        want[fwd1] += 1
        want[twin1] += 1
        for n, a in acts.items():
            yb[vdtype, key, fwdm, n] = layer(a).t()
            want[fwdm] += 1
            if twinm is not None:
                yb[vdtype, key, twinm, n] = ops.spmm(
                    layer.plan, a.t().contiguous(), double_buffer=False)
                want[twinm] += 1
    torch.cuda.synchronize()
    lb = counts()
    for name in CMAP_KERNELS:
        if lb[name] != want[name] or not want[name]:
            raise SmokeFailure(f"(3b) launched {name} {lb[name]} times, not "
                               f"{want[name]} ({lb})")
    others = {k: v for k, v in lb.items() if v and k not in CMAP_KERNELS}
    if others:
        raise SmokeFailure(f"(3b) ran other kernels: {others}")
    return ya, la, yb, lb


def check_vocab_reordered(layers, ya, yb, f32_layers, qlayers, acts, csr):
    """(3a): every output within ``TOL`` of max|y| of the unreordered
    default layer's. (3b): f32 and bf16 outputs within ``TOL`` of the
    unreordered layer of the same layout, lowering and width (bf16 values
    do not depend on the chunking; int8 scales do, one a chunk, and the
    column permutation regroups the chunks, so int8 is held to the pins
    only), every width against its plain version, the f64 dequantised
    product and, at bf16 / int8, ``tests/test_vdtype.py``'s pins of the f32
    weight's f64 product (:func:`check_quantised_y`); f32 also against the
    f64 product. Returns each map kernel's max|y - plain| by width and the
    pins used."""
    import torch
    x1 = acts[SPMM_NVECS[0]][0].contiguous()
    xs = {1: x1, **{n: a.t().contiguous() for n, a in acts.items()}}
    default = f32_layers["panels", "descriptor"]
    for n, y in ya.items():
        ref = default(x1) if n == 1 else default(acts[n]).t()
        err = rel_err(y, ref)
        print(f"check (3a) batch {n}: vs the unreordered default layer "
              f"{err:.3g} of max|y|")
        if not err <= TOL:
            raise SmokeFailure(f"(3a) batch {n} disagrees with the default "
                               f"layer: {err}")
    _, qrefs, smax = quantised_refs(csr, acts)
    a64 = f64_matrix(csr)
    errs, pins, bases = {}, {}, {}
    for (vdtype, key, name, n), y in yb.items():
        plan = layers[vdtype, key].plan
        x = xs[n]
        if (vdtype, key, n) not in bases:
            base = (f32_layers if vdtype == "f32" else qlayers[vdtype])[key]
            bases[vdtype, key, n] = base(x1) if n == 1 else base(acts[n]).t()
        e_base = rel_err(y, bases[vdtype, key, n])
        if vdtype == "f32":
            plain = plain_y(plan, x)
            err = float((y - plain).abs().max())
            e_plain = rel_err(y, plain)
            del plain
            e64 = rel_err(y, torch.from_numpy(a64 @ x.cpu().double()
                                              .numpy()))
            print(f"check {name} f32 batch {n} (vocab (3b) {key}): max|y - "
                  f"plain| = {err:.3g} ({e_plain:.3g} of max|y|), vs f64 "
                  f"scipy {e64:.3g} of max|y|")
            if not (e_plain <= TOL and e64 <= TOL):
                raise SmokeFailure(f"(3b) {name} f32 batch {n} disagrees: "
                                   f"{e_plain} / {e64} > {TOL}")
            used = 0.0
        else:
            err, used = check_quantised_y(name, vdtype, plan, y, x, qrefs[n],
                                          smax, f"vocab (3b) {key}")
        print(f"  (3b) {name} {vdtype} batch {n}: vs the unreordered "
              f"{vdtype} {key[0]} {key[1]} layer {e_base:.3g} of max|y|")
        if vdtype != "int8" and not e_base <= TOL:
            raise SmokeFailure(f"(3b) {name} {vdtype} batch {n} disagrees "
                               f"with the unreordered layer: {e_base}")
        errs.setdefault(name, {})[vdtype] = max(
            errs.get(name, {}).get(vdtype, 0.0), err)
        pins[vdtype] = max(pins.get(vdtype, 0.0), used)
    return errs, pins


def measure_vocab_reordered(layers, acts, csr, library, timer=cuda_time_ms):
    """Each map kernel on (3b)'s layer of its layout and lowering at every
    width, in turns with its twin on x[col_perm] with no map
    (:func:`in_turns`), beside its bound (:func:`map_bound`), its plain
    version (f32) and cuSPARSE on the f32 weight (``library``, {batch:
    ms}). Returns {kernel: {vdtype: {batch: numbers}}}."""
    x1 = acts[SPMM_NVECS[0]][0].contiguous()
    xs = {1: x1, **{n: a.t().contiguous() for n, a in acts.items()}}
    out = {}
    for name in CMAP_KERNELS:
        spmm = name.startswith("spmm")
        for (vdtype, key), layer in layers.items():
            if key != cmap_plan_key(name):
                continue
            plan = layer.plan
            for n, v in xs.items():
                if (n > 1) != spmm:
                    continue
                row = in_turns(plan, name, v, timer)
                if vdtype == "f32":
                    row["plain_ms"] = timer(lambda v=v: plain_y(plan, v),
                                            v.device,
                                            reps=QUANTISED_PLAIN_REPS)
                row["bound_ms"], row["bound_by"], row["bytes"] = map_bound(
                    plan, csr.nnz, n)
                row["library_ms"] = library[n]
                print(f"time {name} vocab (3b) {vdtype} batch {n}: "
                      f"{row['ms']:.4f} ms, no map on x[col_perm] "
                      f"{row['no_map_ms']:.4f} ms ({row['ratio']:.3f}x, aim "
                      f"<= {CMAP_AIM}), bound {row['bound_ms']:.4f} ms")
                out.setdefault(name, {}).setdefault(vdtype, {})[n] = row
    return out


def vocab_reordered(w, mat, f32_layers, qlayers, acts, csr, library, device,
                    timer=cuda_time_ms):
    """Phase: the vocab layer reordered, (3a) and (3b)."""
    auto, layers, host = build_vocab_reordered(w, mat, device)
    ya, la, yb, lb = drive_vocab_reordered(auto, layers, acts, device)
    print(f"launches on the vocab (3a) path: "
          f"{ {k: v for k, v in la.items() if v} }; (3b): "
          f"{ {k: v for k, v in lb.items() if v} }")
    del auto
    errs, pins = check_vocab_reordered(layers, ya, yb, f32_layers, qlayers,
                                       acts, csr)
    del ya, yb
    per = measure_vocab_reordered(layers, acts, csr, library, timer)
    return {"launches": lb, "launches_a": la, "errs": errs, "pins": pins,
            "per": per, "host": host}


def cmap_rows(band, vocab):
    """The eleven map kernels' rows of the ``kernels`` line: the band's
    numbers in the main keys (SpMV batch 1, SpMM nvec 128), every batch of
    the band and of (3b) at f32 / bf16 / int8 beside."""
    rows = []
    for name, (twin, replaces) in CMAP_KERNELS.items():
        spmm = name.startswith("spmm")
        main = band["per"][name][VOCAB["nvec"] if spmm else 1]
        rows.append({
            "name": name, "route": "cuda",
            "source": CMAP_SOURCE[spmm, "desc" in name],
            "replaces": replaces,
            "launches": band["launches"][name] + vocab["launches"][name],
            "max_abs_err": max([band["errs"][name],
                                *vocab["errs"][name].values()]),
            "ms": main["ms"], "plain_ms": main["plain_ms"],
            "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
            "library_ms": main["library_ms"], "twin": twin,
            "no_map_ms": main["no_map_ms"], "vs_no_map": main["ratio"],
            "value_dtypes": ["f32", *VDTYPES],
            "band": {f"batch_{n}": r for n, r in band["per"][name].items()},
            "vocab_3b": {v: {f"batch_{n}": r for n, r in per.items()}
                         for v, per in vocab["per"][name].items()}})
    return rows


# ----------------------------------------------------------------------------
# The serving tier (repro_torch.launch.server / serve) on the vocab weight
# ----------------------------------------------------------------------------

#: The serving phase: two tiers on the vocab weight (phase 5's host matrix),
#: each ``server.start(ServeConfig(vocab_spmv=0.1, verify=True, ...),
#: mat=vocab)`` on the card, with a cache that holds the token plan (2.0 GB;
#: the reference admits a plan past the capacity only after evicting
#: everything). tier: (ServeConfig keywords, (layout, lowering) it must
#: build, its SpMV kernel, its SpMM kernel).
SERVE_TIERS = {
    "token": ({}, ("whole_vector", "descriptor"), "spmv_cuda_desc_db",
              "spmm_cuda_desc"),
    "mask": (dict(lowering="mask"), ("whole_vector", "mask"),
             "spmv_cuda_db", "spmm_cuda"),
}
SERVE = dict(cache_mb=4096, requests=64, qps0=1000.0, factor=2.0,
             max_points=6, duration_s=0.5, chaos_qps=2000.0,
             chaos="exec.spmv:0.1:11,exec.spmm:0.1:12,serve.gather:0.1:13,"
                   "serve.exec:0.1:14", ladder_rows=4_096, cli_qps=500)
#: Per-request ceilings from the kernel times alone (PERF.md §5, H100 80GB
#: HBM3, 700.00 W): (batch-1 SpMV ms, width-128 SpMM ms) of each tier.
SERVE_KERNEL_MS = {"token": (0.5962, 2.3403), "mask": (0.1384, 1.6862)}


def _serve_counts(section, fn, total, allowed):
    """Run ``fn`` between a launch-count reset and a read; the counts must
    name only ``allowed`` kernels. Adds them into ``total`` (the serving
    phase's launches in the kernels line) and returns (fn's result,
    counts)."""
    import torch
    counts = reset_all_launches()
    out = fn()
    torch.cuda.synchronize()
    got = {k: v for k, v in counts().items() if v}
    others = {k: v for k, v in got.items() if k not in allowed}
    if others:
        raise SmokeFailure(f"serving tier, {section}: other kernels "
                           f"launched: {others} (allowed {sorted(allowed)})")
    for k, v in got.items():
        total[k] = total.get(k, 0) + v
    return out, got


def _tie_launches(section, got, before, after, spmv_names, spmm_names):
    """With nothing armed, every batch between two stats snapshots
    (``before`` / ``after``: ``requests``, ``coalesced``, ``batches``,
    ``degraded``) ran on its kernel: none degraded, and the SpMV kernels'
    launches ``got`` equal the width-1 batches, the SpMM kernels' every
    wider batch."""
    d = {k: after[k] - before[k]
         for k in ("requests", "coalesced", "batches", "degraded")}
    ones = d["requests"] - d["coalesced"]
    want = (ones, d["batches"] - ones)
    have = (sum(got.get(k, 0) for k in spmv_names),
            sum(got.get(k, 0) for k in spmm_names))
    print(f"  {section}: {d['batches']} batches ({want[0]} of width 1), "
          f"degraded {d['degraded']}; SpMV / SpMM launches {have}")
    if d["degraded"] or have != want:
        raise SmokeFailure(f"serving tier, {section}: degraded "
                           f"{d['degraded']}, SpMV / SpMM launches {have} "
                           f"for {want} width-1 / wider batches")


def _span_ms(registry, name, last=None):
    """Mean and count of the last ``last`` finished spans called ``name``
    (the span buffer keeps the newest 4,096), in ms."""
    d = [e.duration_s for e in registry.spans() if e.name == name]
    d = d[-last:] if last else d
    return (1e3 * float(np.mean(d)) if d else 0.0), len(d)


class _PerPoint:
    """Passes ``saturation_sweep``'s calls to a server and snapshots its
    stats at each ``open_loop``'s first warm-up call, so each point's
    batches are read (each point starts with two synchronous warm-up
    requests, one batch each, which are taken off)."""

    def __init__(self, srv):
        self.srv = srv
        self.marks = []
        self._fresh = True

    def spmv(self, x, timeout=None):
        if self._fresh:
            self.marks.append(self.srv.stats())
            self._fresh = False
        return self.srv.spmv(x, timeout)

    def submit(self, x, **kw):
        self._fresh = True
        return self.srv.submit(x, **kw)

    def points(self, warmup=2):
        marks = self.marks + [self.srv.stats()]
        out = []
        for a, b in zip(marks, marks[1:]):
            batches = b["batches"] - a["batches"] - warmup
            requests = b["requests"] - a["requests"] - warmup
            out.append({"batches": batches, "requests": requests,
                        "mean_batch": requests / batches if batches else 0.0,
                        "widest_batch": b["widest_batch"],
                        "plan": b["plan"]})
        return out


class _Recorded:
    """Passes ``open_loop``'s calls to a server and keeps every submitted
    request's vector index and outcome (its future, or the error submit
    raised), so the chaos run can check each one."""

    def __init__(self, srv, xs):
        self.srv = srv
        self.index = {id(x): i for i, x in enumerate(xs)}
        self.calls = []

    def spmv(self, x, timeout=None):
        return self.submit(x).result(timeout)

    def submit(self, x, **kw):
        i = self.index[id(x)]
        try:
            fut = self.srv.submit(x, **kw)
        except Exception as e:      # noqa: BLE001 -- checked below
            self.calls.append((i, e))
            raise
        self.calls.append((i, fut))
        return fut


def build_serve_tier(name, mat, device):
    """``server.start`` for one tier; prints its plan, build and verify
    seconds, and checks that a second ``get_or_build`` is a hit."""
    from repro_torch.core import plan as P
    from repro_torch.launch import server as SV
    kw, want, _, _ = SERVE_TIERS[name]
    cfg = SV.ServeConfig(vocab_spmv=VOCAB["density"], verify=True,
                         cache_mb=SERVE["cache_mb"], **kw)
    t0 = time.perf_counter()
    srv = SV.start(cfg, mat=mat)
    t1 = time.perf_counter()
    plan = srv.plan
    build_ms, _ = _span_ms(srv.registry, "cache.build")
    verify_ms, _ = _span_ms(srv.registry, "cache.verify")
    got = (plan.layout, plan.lowering)
    print(f"serve tier {name}: ServeConfig({kw}) -> {got[0]} + {got[1]}, "
          f"{P.plan_nbytes(plan) / 1e6:.1f} MB, max_batch {srv.max_batch}; "
          f"start {t1 - t0:.1f} s (cache.build {build_ms / 1e3:.2f} s, "
          f"of it verify_plan {verify_ms / 1e3:.2f} s)")
    if got != want or plan.device.type != device.type:
        srv.close()
        raise SmokeFailure(f"serve tier {name} built {got} on "
                           f"{plan.device}, not {want} on {device}")
    t2 = time.perf_counter()
    again = srv.cache.get_or_build(mat, **SV.plan_request(cfg))
    hits = srv.cache.stats()["hits"]
    print(f"  second get_or_build: hit {again is plan} ({hits} hit, "
          f"{time.perf_counter() - t2:.2f} s: the key hashes the matrix)")
    if again is not plan or hits != 1:
        srv.close()
        raise SmokeFailure(f"serve tier {name}: the second get_or_build "
                           f"was not a cache hit")
    return srv, {"start_s": t1 - t0, "build_s": build_ms / 1e3,
                 "verify_s": verify_ms / 1e3,
                 "plan_mb": P.plan_nbytes(plan) / 1e6}


def check_serve_tier(name, srv, xs, y64, total):
    """Submit ``SERVE["requests"]`` vectors at once plus one alone (host
    numpy arrays, as a client sends them); the tier's SpMV kernel must
    count exactly the width-1 batches and its SpMM kernel every wider one,
    no other kernel may launch, no batch may degrade, and every y must be
    within TOL of max|y| of the f64 product and of a lone ``ops.spmv``."""
    import torch
    from repro_torch.kernels import ops
    _, _, spmv_name, spmm_name = SERVE_TIERS[name]
    n = SERVE["requests"]

    def drive():
        futs = [srv.submit(x) for x in xs[:n]]
        ys = [f.result(timeout=120) for f in futs]
        return ys + [srv.spmv(xs[n], timeout=120)]

    ys, got = _serve_counts(f"tier {name}", drive, total,
                            {spmv_name, spmm_name})
    widths = [e.attrs["n"] for e in srv.registry.spans()
              if e.name == "serve.batch"]
    st = srv.stats()
    want = {spmv_name: sum(w == 1 for w in widths),
            spmm_name: sum(w > 1 for w in widths)}
    print(f"  tier {name}: {n} + 1 requests in {st['batches']} batches of "
          f"{widths}; launches {got}; degraded {st['degraded']}")
    if ({k: v for k, v in want.items() if v} != got
            or st["widest_batch"] <= 1 or st["degraded"]):
        raise SmokeFailure(f"serve tier {name}: launches {got} for batch "
                           f"widths {widths} (want {want}), widest "
                           f"{st['widest_batch']}, degraded {st['degraded']}")
    worst = (0.0, 0.0)
    for i, (x, y) in enumerate(zip(xs, ys)):
        lone = ops.spmv(srv.plan, torch.from_numpy(x).to(srv.plan.device))
        e_lone = rel_err(y, lone)
        e64 = rel_err(y, torch.from_numpy(
            np.ascontiguousarray(y64[:, i])))
        worst = (max(worst[0], e_lone), max(worst[1], e64))
        if not (e_lone <= TOL and e64 <= TOL):
            raise SmokeFailure(f"serve tier {name} request {i}: {e_lone} "
                               f"of a lone ops.spmv, {e64} of the f64 "
                               f"product (> {TOL})")
    print(f"  tier {name}: every y within {worst[0]:.3g} of max|y| of a "
          f"lone ops.spmv and {worst[1]:.3g} of the f64 product")
    return {"launches": got, "widths": widths, "err_lone": worst[0],
            "err_f64": worst[1]}


def sweep_serve_tier(name, srv, xs_dev, total):
    """``saturation_sweep`` on the tier; prints each point against the
    kernel-time ceilings and where the time went (the ``serve.submit`` and
    ``serve.batch`` spans)."""
    from repro_torch.launch import server as SV
    _, _, spmv_name, spmm_name = SERVE_TIERS[name]
    per = _PerPoint(srv)
    before = srv.stats()
    pts, got = _serve_counts(
        f"sweep {name}", lambda: SV.saturation_sweep(
            per, xs_dev, qps0=SERVE["qps0"], factor=SERVE["factor"],
            max_points=SERVE["max_points"], duration_s=SERVE["duration_s"]),
        total, {spmv_name, spmm_name})
    _tie_launches(f"sweep {name}", got, before, srv.stats(), {spmv_name},
                  {spmm_name})
    spmv_ms, spmm_ms = SERVE_KERNEL_MS[name]
    print(f"  tier {name} ceilings from the kernel times alone: "
          f"{1e3 / spmv_ms:.0f} requests/s at batch 1, "
          f"{128e3 / spmm_ms:.0f}/s at width 128")
    rows = []
    for p, b in zip(pts, per.points()):
        row = dict(p, **b)
        rows.append(row)
        print(f"  tier {name} offered {p['qps_offered']:.0f} qps: achieved "
              f"{p['qps_achieved']:.1f}, p50 {p['p50_us']:.1f} us, p99 "
              f"{p['p99_us']:.1f} us, shed {p['shed']}, errors "
              f"{p['errors']}; batches {b['batches']}, mean_batch "
              f"{b['mean_batch']:.2f}; plan {json.dumps(b['plan'])}")
    submit_ms, nsub = _span_ms(srv.registry, "serve.submit", 4096)
    batch_ms, nbat = _span_ms(srv.registry, "serve.batch", 4096)
    hist = srv.registry.histogram("spc5_server_batch_seconds")
    print(f"  tier {name} spans (newest of the last point): serve.submit "
          f"{submit_ms:.4f} ms mean over {nsub}; serve.batch {batch_ms:.4f} "
          f"ms mean over {nbat}, all batches p50 {hist.percentile(50) * 1e3:.4f}"
          f" / p99 {hist.percentile(99) * 1e3:.4f} ms")
    return {"points": rows, "submit_ms": submit_ms, "batch_ms": batch_ms,
            "batch_p50_ms": hist.percentile(50) * 1e3,
            "ceiling_rps": [1e3 / spmv_ms, 128e3 / spmm_ms]}


def serve_host_costs(srv, xs_dev, reps=50):
    """Host-clock costs of the tier's per-request and per-batch work on an
    idle tier (nothing queued on the card), through the server's own
    steps: ``_validate`` (the finiteness check ends in a device sync),
    ``_stack`` (the (ncols, width) operand with its zero padding) and
    ``_split`` (one slice a column), each timed to a synchronised end;
    medians of ``reps``, in microseconds. Against ``serve.submit`` under
    traffic they tell validation from waiting behind the executor's
    kernels on the shared stream."""
    import torch
    dev = srv.plan.device

    def median_us(fn):
        times = []
        for _ in range(reps):
            torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize(dev)
            times.append(time.perf_counter() - t0)
        return 1e6 * float(np.median(times))

    out = {"validate_us": median_us(lambda: srv._validate(xs_dev[0]))}
    for n in (16, 64):
        xs = [xs_dev[i % len(xs_dev)] for i in range(n)]
        out[f"stack_{n}_us"] = median_us(lambda xs=xs: srv._stack(xs))
    Y = torch.zeros(srv.plan.nrows, 128, device=dev)
    out["slices_128_us"] = median_us(lambda: srv._split(Y, 128))
    print(f"  tier host costs, idle (medians of {reps}, us): "
          f"{ {k: round(v, 1) for k, v in out.items()} }")
    return out


def chaos_serve_tier(srv, xs_dev, ys_ref, total):
    """The mask tier under ``SERVE["chaos"]`` (exec.spmv, exec.spmm,
    serve.gather and serve.exec at 10 %, fixed seeds) for one open_loop:
    every request returns a y within TOL of max|y| of its f64 product
    (``ys_ref``, one column a vector of ``xs_dev``) or fails with a
    typed error; some batches degrade and some workers restart."""
    import concurrent.futures
    import torch
    from repro_torch.launch import resilience as RS
    from repro_torch.launch import server as SV
    from repro_torch.obs import faults as FL
    _, _, spmv_name, spmm_name = SERVE_TIERS["mask"]
    before = srv.stats()
    rec = _Recorded(srv, xs_dev)
    FL.set_faults(FL.Faults(SERVE["chaos"]))
    try:
        res, _ = _serve_counts(
            "chaos", lambda: SV.open_loop(rec, xs_dev, SERVE["chaos_qps"],
                                          duration_s=SERVE["duration_s"]),
            total, {spmv_name, spmm_name})
        fired = FL.get_faults().stats()
    finally:
        FL.set_faults(None)
    typed = (FL.FaultError, RS.DeadlineExceededError, RS.ShedError,
             RS.CircuitOpenError, concurrent.futures.CancelledError)
    outcomes, worst = {}, 0.0
    for i, out in rec.calls:
        if isinstance(out, concurrent.futures.Future):
            if not out.done():
                raise SmokeFailure("chaos: a request never resolved")
            exc = out.exception() if not out.cancelled() else \
                concurrent.futures.CancelledError()
            if exc is None:
                err = rel_err(out.result(), torch.from_numpy(
                    np.ascontiguousarray(ys_ref[:, i])))
                worst = max(worst, err)
                if not err <= TOL:
                    raise SmokeFailure(f"chaos: a y is off by {err} of "
                                       f"max|y|")
                kind = "ok"
            else:
                out = exc
        if not isinstance(out, concurrent.futures.Future):
            if not isinstance(out, typed):
                raise SmokeFailure(f"chaos: untyped failure {out!r}")
            kind = type(out).__name__
        outcomes[kind] = outcomes.get(kind, 0) + 1
    after = srv.stats()
    degraded = after["degraded"] - before["degraded"]
    restarts = after["worker_restarts"] - before["worker_restarts"]
    print(f"  chaos on the mask tier ({SERVE['chaos']}): {res['submitted']} "
          f"submitted at {SERVE['chaos_qps']:.0f} qps, achieved "
          f"{res['qps_achieved']:.1f}; outcomes {outcomes}; worst y "
          f"{worst:.3g} of max|y|; degraded batches {degraded}, worker "
          f"restarts {restarts}; draws {fired}")
    if degraded <= 0 or restarts <= 0 or not outcomes.get("ok"):
        raise SmokeFailure(f"chaos: degraded {degraded}, restarts "
                           f"{restarts}, outcomes {outcomes}")
    return {"outcomes": outcomes, "degraded": degraded,
            "restarts": restarts, "qps_achieved": res["qps_achieved"],
            "worst_err": worst}


def ladder_serve(csr, device, total):
    """A fresh ``PlanCache`` (plans on the card) with ``plan.build:1``
    armed on the vocab weight's first ``SERVE["ladder_rows"]`` rows: every
    unsuppressed build fails, so the plan comes from the ``reference``
    rung, with the ``degrade`` entries in its trace; its SpMV runs on the
    card and is checked against the f64 product."""
    import torch
    from repro_torch.core import formats as F
    from repro_torch.kernels import ops
    from repro_torch.launch import server as SV
    from repro_torch.obs import faults as FL
    rows = SERVE["ladder_rows"]
    sub = F.CSRMatrix((rows, csr.shape[1]), csr.rowptr[:rows + 1],
                      csr.colidx[:csr.rowptr[rows]],
                      csr.values[:csr.rowptr[rows]])
    mat = F.csr_to_spc5(sub, *VOCAB["block"])
    cache = SV.PlanCache(capacity_bytes=SERVE["cache_mb"] << 20)
    FL.set_faults(FL.Faults("plan.build:1:0"))
    try:
        plan = cache.get_or_build(mat, **SV.plan_request(SV.ServeConfig()))
    finally:
        FL.set_faults(None)
    rungs = [e["rung"] for e in plan.trace if e["pass"] == "degrade"]
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(
        csr.shape[1]).astype(np.float32)).to(device)
    y, got = _serve_counts("ladder", lambda: ops.spmv(plan, x), total,
                           set(KERNELS))
    err = rel_err(y, torch.from_numpy(f64_matrix(sub) @ x.cpu().double()
                                      .numpy()))
    print(f"  build ladder (plan.build:1, {rows} rows): rungs {rungs}, plan "
          f"{plan.layout} + {plan.lowering} on {plan.device}, degraded "
          f"{cache.stats()['degraded']}; SpMV launches {got}, vs f64 "
          f"{err:.3g} of max|y|")
    if (rungs != ["mask-lowering", "f32-values", "reference"]
            or plan.device.type != device.type or not got
            or not err <= TOL):
        raise SmokeFailure(f"build ladder: rungs {rungs} on {plan.device}, "
                           f"launches {got}, error {err}")
    return {"rungs": rungs, "launches": got, "err": err}


def cli_serve(total):
    """``repro_torch.launch.serve.main`` once, with ``--metrics`` into a
    temporary directory: the Prometheus file must parse and the Chrome
    trace must hold a ``serve.batch`` span whose parent is a
    ``serve.submit`` span."""
    import tempfile
    from repro_torch import obs
    from repro_torch.launch import serve
    with tempfile.TemporaryDirectory() as tmp:
        prom = os.path.join(tmp, "serve_metrics.prom")
        trace = os.path.join(tmp, "serve_trace.json")
        argv = ["--vocab-spmv", str(VOCAB["density"]), "--qps",
                str(SERVE["cli_qps"]), "--duration-s",
                str(SERVE["duration_s"]), "--metrics", "--metrics-path",
                prom, "--trace-path", trace]
        reg = obs.Registry()
        prev = obs.set_registry(reg)
        try:
            _, got = _serve_counts("CLI", lambda: serve.main(argv), total,
                                   set(KERNELS) | {"spmm_cuda_desc",
                                                   "spmm_cuda"})
        finally:
            obs.set_registry(prev)
        names = ("requests", "coalesced", "batches", "degraded")
        after = {k: reg.counter(f"spc5_server_{k}_total").value
                 for k in names}
        _tie_launches("CLI", got, dict.fromkeys(names, 0), after,
                      {k for k in got if k.startswith("spmv")},
                      {k for k in got if k.startswith("spmm")})
        with open(prom) as f:
            samples = obs.export.parse_prometheus(f.read())
        with open(trace) as f:
            events = json.load(f)["traceEvents"]
    names = {e["args"]["span_id"]: e["name"] for e in events}
    linked = sum(names.get(e["args"].get("parent_id")) == "serve.submit"
                 for e in events if e["name"] == "serve.batch")
    print(f"  CLI {' '.join(argv[:6])} --metrics: launches {got}; "
          f"{len(samples)} Prometheus samples "
          f"(spc5_server_requests_total "
          f"{samples.get('spc5_server_requests_total')}), {len(events)} "
          f"trace events, {linked} serve.batch spans under a serve.submit")
    if not samples.get("spc5_server_requests_total") or not linked:
        raise SmokeFailure("the serve CLI's metrics do not parse or its "
                           "trace is not connected")
    return {"launches": got, "samples": len(samples), "linked": linked}


def serving_tier(mat, csr, device):
    """Phase: the serving tier on the vocab weight (:data:`SERVE_TIERS`):
    build and cache-hit, correctness and launch counts, the saturation
    sweep, chaos on the mask tier, the build ladder, the CLI. Returns the
    phase's numbers and ``launches``, every kernel's launches over the
    tiers' runs (the lone ``ops.spmv`` comparisons left out)."""
    import torch
    total, out = {}, {}
    rng = np.random.default_rng(17)
    xs = [rng.standard_normal(VOCAB["cols"]).astype(np.float32)
          for _ in range(SERVE["requests"] + 1)]
    t0 = time.perf_counter()
    y64 = f64_matrix(csr) @ np.stack(xs, axis=1).astype(np.float64)
    print(f"serving tier: f64 products of {len(xs)} vectors "
          f"{time.perf_counter() - t0:.1f} s")
    xs_dev = [torch.from_numpy(x).to(device) for x in xs[:SERVE["requests"]]]
    for name in SERVE_TIERS:
        srv, built = build_serve_tier(name, mat, device)
        try:
            checked = check_serve_tier(name, srv, xs, y64, total)
            swept = sweep_serve_tier(name, srv, xs_dev, total)
            swept["host"] = serve_host_costs(srv, xs_dev)
            if name == "mask":
                out["chaos"] = chaos_serve_tier(srv, xs_dev, y64, total)
            out[name] = {**built, **checked, **swept,
                         "stats": {k: v for k, v in srv.stats().items()
                                   if k not in ("cache", "plan")}}
        finally:
            srv.close(timeout=30)
        del srv
    out["ladder"] = ladder_serve(csr, device, total)
    out["cli"] = cli_serve(total)
    out["launches"] = total
    print(f"launches on the serving path: {total}")
    print(json.dumps({"serving_tier": out}))
    return out


# ----------------------------------------------------------------------------
# LM decode (ROADMAP queue 1 item 13, the dense decoder)
# ----------------------------------------------------------------------------

#: The smoke configs held card against CPU, and the full-size decode: yi-6b
#: (``get_config("yi-6b")``: 32 layers, d_model 4,096, vocab 64,000) at
#: ``ServeConfig``'s default batch and tokens, teacher-forced over
#: ``positions`` and checked against ``prefill`` at ``checked`` lengths.
LM = dict(smoke_archs=("yi-6b", "gemma-2b", "glm4-9b", "deepseek-67b",
                       "internvl2-26b"), smoke_batch=2, smoke_len=12,
          arch="yi-6b", batch=4, positions=32, checked=(1, 2, 8, 16, 32),
          seed=0, warm_steps=2)
LM_KV = ("bfloat16", "int8")
#: |card - CPU| <= tol * max|CPU| on the smoke configs' f32 logits, by KV
#: dtype. A bf16 key (the cache in the configs' f32): the f32 tolerance
#: ``tests/test_torch_lm_models.py`` starts from, at every step. An int8
#: one: the same up to the first step whose quantised keys differ on the
#: two devices, ``int8`` from there on. The int8 quantiser is the same
#: function on both (:func:`lm_quantiser_split`), but a key a few 1e-5 of
#: a step from a rounding tie lands one step apart, and the decodes part
#: from there. On an H100, of the five dense smoke configs, two parted
#: (gemma-2b at step 9, deepseek-67b at step 1), their logits at most
#: 2.08e-4 and 2.89e-3 apart; the rest stayed within 7.6e-7. The int8
#: limit stays under one quantisation step, 1/127.
LM_SMOKE_TOL = {"bfloat16": 1e-4, "int8": 5e-3}
#: The int8 entries of two KV caches: at most one quantisation step apart,
#: in under this share of the cache's int8 entries (0.0013 and 0.0065
#: measured where the decodes parted, 0 elsewhere).
LM_INT8_SHARE = 2e-2
#: Where the quantised keys first differ, the quantiser's inputs on the two
#: devices must agree to this many quantisation steps (|k / scale| gaps of
#: 3.6e-5 and 4.6e-5 measured), and the keys that part lie this close to a
#: rounding tie (9.5e-6 and 1.7e-5): the split is a tie, not a wrong key.
LM_SPLIT_GAP = 1e-3
#: |decode - prefill| <= tol * max|prefill| at full size: f32 (TF32 off),
#: and bf16 weights with a bf16 KV cache (each product rounded to bf16 in
#: both paths, in other orders, through 32 layers: 0.0231 measured on an
#: H100, as far from the f32 logits as from each other).
LM_FULL_TOL = {"float32": 1e-4, "bfloat16": 2.0 ** -4}


def lm_err(y, ref) -> float:
    """max|y - ref| / max|ref|, in float64 on ``y``'s device."""
    ref = ref.to(y.device).double()
    return float((y.double() - ref).abs().max() / ref.abs().max())


def lm_cache_err(cache, ref, kv):
    """Two KV caches of one tree, leaf for leaf: the int8 leaves must hold
    int8 entries (a card that never quantised fails here) at most one step
    from ``ref``'s, in under :data:`LM_INT8_SHARE` of the cache's int8
    entries; every other leaf is held as the logits are, to
    :data:`LM_SMOKE_TOL`. Returns (the greatest float-leaf error, the
    share of int8 entries one step apart); raises on a miss."""
    import torch
    from repro_torch.models.convert import tree_leaves
    err, apart, n, most = 0.0, 0, 0, 0
    for a, b in zip(tree_leaves(cache), tree_leaves(ref)):
        if b.dtype == torch.int8:
            if a.dtype != b.dtype:
                raise SmokeFailure(f"LM decode: an int8 cache leaf came "
                                   f"back {a.dtype}")
            d = (a.cpu().int() - b.int()).abs()
            apart, n = apart + int((d > 0).sum()), n + d.numel()
            most = max(most, int(d.max()))
        elif float(b.abs().max()):
            err = max(err, lm_err(a.cpu(), b))
    share = apart / n if n else 0.0
    if most > 1 or not share < LM_INT8_SHARE:
        raise SmokeFailure(f"LM decode, kv={kv}: int8 cache entries up to "
                           f"{most} steps apart in {share:.3g} of them")
    if not err <= LM_SMOKE_TOL[kv]:
        raise SmokeFailure(f"LM decode, kv={kv}: cache off by {err} of "
                           f"max|cache|")
    return err, share


def _lm_decode(params, cfg, toks, kv, calls):
    """Teacher-forced ``decode_step`` over ``toks`` (B, S) on their device:
    (logits (B, S, vocab), the cache). Every call of the int8 quantiser
    appends (its input, q, scale) on the host to ``calls``."""
    import torch
    from repro_torch.models import layers as L
    from repro_torch.models import model as MD
    B, S = toks.shape
    cache = MD.init_cache(cfg, B, S, kv_dtype=kv, device=toks.device)
    quantize = L.quantize_kv

    def recorded(k):
        q, scale = quantize(k)
        calls.append((k.cpu(), q.cpu(), scale.cpu()))
        return q, scale
    L.quantize_kv = recorded
    try:
        steps = []
        for t in range(S):
            lg, cache = MD.decode_step(params, cache, toks[:, t:t + 1], t,
                                       cfg)
            steps.append(lg)
    finally:
        L.quantize_kv = quantize
    return torch.stack(steps, dim=1), cache


def lm_quantiser_split(card, host, steps, device):
    """The int8 quantiser's calls of a card and a CPU decode of ``steps``
    steps (in the same order): every CPU input quantised again on the card
    must give the CPU's q and scale bit for bit, so cache entries that
    differ come from inputs that differ, not from the quantiser. Returns
    the number of calls and, at the first call whose q differs (None if
    none does), its step, the entries one step apart, the greatest |k /
    scale| gap between the devices there and at those entries, and those
    entries' greatest distance from a rounding tie (|frac(|k / scale|) -
    0.5| on the CPU). Raises where the quantiser differs, or the gap or
    the distance from a tie passes :data:`LM_SPLIT_GAP`."""
    import torch
    from repro_torch.models import layers as L
    for k, q, scale in host:
        q2, s2 = L.quantize_kv(k.to(device))
        if not (torch.equal(q2.cpu(), q) and torch.equal(s2.cpu(), scale)):
            raise SmokeFailure("LM decode: the int8 quantiser gives "
                               "another q or scale on the card for the "
                               "CPU's input")
    out = {"calls": len(host), "first_split": None}
    for i, ((kc, qc, sc), (kh, qh, sh)) in enumerate(zip(card, host)):
        apart = qc != qh
        if apart.any():
            rc, rh = kc.double() / sc.double(), kh.double() / sh.double()
            gap = (rc - rh).abs()
            tie = (rh.abs() - rh.abs().floor() - 0.5).abs()
            out["first_split"] = split = {
                "step": i // (len(host) // steps),
                "entries": int(apart.sum()), "of": apart.numel(),
                "gap_max": float(gap.max()),
                "gap_split": float(gap[apart].max()),
                "tie_split": float(tie[apart].max())}
            if not max(split["gap_max"], split["tie_split"]) <= LM_SPLIT_GAP:
                raise SmokeFailure(f"LM decode: the int8 keys part away "
                                   f"from a rounding tie: {split}")
            break
    return out


def lm_hold(card, host, kv, device):
    """A card and a CPU run of :func:`_lm_decode` ((logits, cache, calls)
    each) held to each other: the logits by :data:`LM_SMOKE_TOL` (at int8
    the f32 tolerance up to the step where the quantised keys part), the
    caches by :func:`lm_cache_err`, the quantiser by
    :func:`lm_quantiser_split`. Returns the readings; raises on a miss."""
    (lc, cc, qc), (lh, ch, qh) = card, host
    steps = lh.shape[1]
    errs = [lm_err(lc[:, t], lh[:, t]) for t in range(steps)]
    case = {"logits": max(errs)}
    parted = steps
    if kv == "int8":
        case["quantiser"] = q = lm_quantiser_split(qc, qh, steps, device)
        if q["first_split"] is not None:
            parted = q["first_split"]["step"]
    for t, err in enumerate(errs):
        tol = LM_SMOKE_TOL["bfloat16" if t < parted else kv]
        if not err <= tol:
            raise SmokeFailure(f"LM decode, kv={kv}: card against CPU off "
                               f"by {err} of max|logits| at step {t} "
                               f"(limit {tol}); {case}")
    case["cache"], case["int8_one_step"] = lm_cache_err(cc, ch, kv)
    return case


def lm_card_vs_cpu(device):
    """(a) The smoke configs of :data:`LM`'s archs, one set of params made
    on the host from a seed and carried to both devices as numpy leaves
    (``convert.params_from_numpy``), decoded teacher-forced at both KV
    dtypes on the card and on the CPU and held by :func:`lm_hold`.
    Returns, for each case, the logits' error, the cache's, the share of
    int8 cache entries one step apart and the quantiser's readings."""
    import torch
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import convert as CV
    from repro_torch.models import model as MD
    out = {}
    B, S = LM["smoke_batch"], LM["smoke_len"]
    for arch in LM["smoke_archs"]:
        cfg = get_smoke_config(arch)
        host = MD.init_params(cfg, torch.Generator().manual_seed(LM["seed"]))
        tree = CV.tree_map(lambda t: t.numpy(), host)
        toks = torch.from_numpy(np.random.default_rng(LM["seed"] + 1)
                                .integers(0, cfg.vocab, (B, S)))
        for kv in LM_KV:
            runs = []
            for dev in (device, torch.device("cpu")):
                calls = []
                runs.append((*_lm_decode(CV.params_from_numpy(tree, dev),
                                         cfg, toks.to(dev), kv, calls),
                             calls))
            out[f"{arch}/{kv}"] = lm_hold(*runs, kv, device)
    print(f"  (a) smoke configs, card against CPU, {B}x{S} teacher-forced "
          f"steps, worst |err| / max (logits, cache), share of int8 cache "
          f"entries one step apart: "
          + "; ".join(f"{k} {v['logits']:.3g}, {v['cache']:.3g}, "
                      f"{v['int8_one_step']:.3g}" for k, v in out.items())
          + f" (logits limits {LM_SMOKE_TOL}, int8 share < "
          f"{LM_INT8_SHARE}); int8 quantiser: "
          + json.dumps({k: v["quantiser"] for k, v in out.items()
                        if "quantiser" in v}))
    return out


def lm_weight_bytes(params, cfg, batch, max_seq, kv_bytes):
    """Bytes a decode step must move at least: every weight leaf read once
    (the embedding table: only the batch's rows), the KV cache read once,
    the logits written once."""
    from repro_torch.models.convert import tree_leaves
    emb = params["embed"]
    total = sum(t.numel() * t.element_size() for t in tree_leaves(params))
    total -= emb.numel() * emb.element_size()
    total += batch * emb.shape[1] * emb.element_size()
    hd = cfg.resolved_head_dim
    total += cfg.n_layers * 2 * batch * max_seq * cfg.kv_heads * hd * kv_bytes
    return total + batch * cfg.vocab * 4


def _lm_teacher_forced(params, cfg, toks, kv):
    """Logits (B, T, vocab) of ``decode_step`` over ``toks`` (B, T), and
    the greatest |decode - prefill| / max|prefill| at :data:`LM`'s
    checked lengths."""
    import torch
    from repro_torch.models import model as MD
    B, T = toks.shape
    cache = MD.init_cache(cfg, B, T, kv_dtype=kv, device=toks.device)
    steps = []
    for t in range(T):
        lg, cache = MD.decode_step(params, cache, toks[:, t:t + 1], t, cfg)
        steps.append(lg)
    del cache
    worst = 0.0
    for n in LM["checked"]:
        ref, _ = MD.prefill(params, {"tokens": toks[:, :n]}, cfg)
        worst = max(worst, lm_err(steps[n - 1], ref))
    return torch.stack(steps, dim=1), worst


def _lm_time_decode(params, cfg, kv, device, profiled):
    """``ServeConfig``'s default greedy loop (``batch`` sequences, ``tokens
    - 1`` steps from a zero token, ``serve.greedy_decode``) on a fresh
    cache, timed with CUDA events after :data:`LM`'s ``warm_steps``
    untimed steps; where ``profiled``, one step after those under
    ``torch.profiler``: the top-level host ops it issues, the kernels it
    launches and their summed device time in ms (None where the profiler
    saw no device time, or did not run). Returns ({ms_per_step,
    host_ops, kernels, device_ms}, the ServeConfig)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.launch.serve import greedy_decode
    from repro_torch.launch.server import ServeConfig
    from repro_torch.models import model as MD
    from repro_torch.train.step import make_serve_step
    sc = ServeConfig()
    step = make_serve_step(cfg)

    def fresh():
        return MD.init_cache(cfg, sc.batch, sc.tokens, kv_dtype=kv,
                             device=device)
    warm = LM["warm_steps"]
    tok, cache = greedy_decode(step, params, fresh(), sc.batch, warm)
    torch.cuda.synchronize()
    out = {"host_ops": None, "kernels": None, "device_ms": None}
    if profiled:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            step(params, cache, tok, warm)
            torch.cuda.synchronize()
        events = prof.events()
        kernels = [e for e in events if e.device_type == DeviceType.CUDA]
        device_us = sum(e.device_time_total for e in kernels)
        out = {"host_ops": sum(e.cpu_parent is None
                               and e.device_type == DeviceType.CPU
                               for e in events),
               "kernels": len(kernels),
               "device_ms": device_us / 1e3 if device_us else None}
    del cache
    cache = fresh()
    torch.cuda.synchronize()
    e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    e0.record()
    greedy_decode(step, params, cache, sc.batch, sc.tokens - 1)
    e1.record()
    torch.cuda.synchronize()
    out["ms_per_step"] = e0.elapsed_time(e1) / (sc.tokens - 1)
    return out, sc


def lm_full_size(device):
    """(b) yi-6b at full width and depth: f32 masters drawn on the card,
    teacher-forced ``decode_step`` against ``prefill`` (f32, TF32 off);
    then ``cast_params`` to bf16 once (the f32 copy freed), the same check
    at bf16, and ``ServeConfig``'s default greedy decode timed at both KV
    dtypes beside the bound (the bytes of :func:`lm_weight_bytes` over the
    card's memory rate)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import model as MD
    from repro_torch.models.convert import tree_leaves
    from repro_torch.train.step import cast_params
    full = get_config(LM["arch"])
    cfg32 = dataclasses.replace(full, dtype="float32")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = MD.init_params(
        cfg32, torch.Generator(device=device).manual_seed(LM["seed"]))
    torch.cuda.synchronize()
    nbytes = sum(t.numel() * t.element_size() for t in tree_leaves(params))
    print(f"  (b) {full.name}: {full.n_layers} layers, d_model "
          f"{full.d_model}, {full.n_heads} heads (kv {full.kv_heads}), d_ff "
          f"{full.d_ff}, vocab {full.vocab}; n_params {full.n_params():,}; "
          f"f32 masters {nbytes / 1e9:.2f} GB drawn on the card in "
          f"{time.perf_counter() - t0:.3f} s")
    B, T = LM["batch"], LM["positions"]
    toks = torch.from_numpy(np.random.default_rng(LM["seed"] + 2).integers(
        0, full.vocab, (B, T))).to(device)
    out = {"n_params": full.n_params(), "f32_bytes": nbytes}
    logits32, err = _lm_teacher_forced(params, cfg32, toks, "bfloat16")
    out["f32"] = {"decode_vs_prefill": err}
    print(f"      f32: decode against prefill at lengths {LM['checked']}: "
          f"{err:.3g} of max|logits| (tol {LM_FULL_TOL['float32']:g})")
    if not err <= LM_FULL_TOL["float32"]:
        raise SmokeFailure(f"LM decode, {full.name} f32: decode against "
                           f"prefill off by {err} of max|logits|")
    t0 = time.perf_counter()
    params = cast_params(params, torch.bfloat16)
    torch.cuda.synchronize()
    out["cast_s"] = time.perf_counter() - t0
    torch.cuda.empty_cache()
    out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    logits16, err = _lm_teacher_forced(params, full, toks, "bfloat16")
    against32 = lm_err(logits16, logits32)
    del logits32, logits16
    out["bf16"] = {"decode_vs_prefill": err, "against_f32": against32}
    print(f"      bf16 (cast once, {out['cast_s']:.3f} s; card peak "
          f"{out['peak_gb']:.1f} GB): decode against prefill {err:.3g} of "
          f"max|logits| (tol {LM_FULL_TOL['bfloat16']:g}); bf16 decode "
          f"against f32 decode {against32:.3g}")
    if not err <= LM_FULL_TOL["bfloat16"]:
        raise SmokeFailure(f"LM decode, {full.name} bf16: decode against "
                           f"prefill off by {err} of max|logits|")
    for kv in LM_KV:
        d, sc = _lm_time_decode(params, full, kv, device,
                                profiled=kv == LM_KV[0])
        kvb = 1 if kv == "int8" else 2
        bound = lm_weight_bytes(params, full, sc.batch, sc.tokens, kvb) \
            / HBM_BYTES_PER_S * 1e3
        out[f"decode_{kv}"] = {**d, "tok_s": sc.batch / d["ms_per_step"]
                               * 1e3, "bound_ms": bound, "bound_by": "bytes"}
    del params
    torch.cuda.empty_cache()
    return out


def lm_launcher():
    """(c) ``repro_torch.launch.serve.main(["--arch", "yi-6b",
    "--vocab-spmv", "0.1"])`` on the card: it decodes (its tok/s line is
    printed) and then runs the vocab bench through ``SparseLinear``; the
    counts, set to 0 just before, must show SpMV kernels and nothing else.
    Returns the counts."""
    import contextlib
    import io
    import torch
    from repro_torch.launch import serve
    argv = ["--arch", LM["arch"], "--vocab-spmv", str(VOCAB["density"])]
    counts = reset_all_launches()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        serve.main(argv)
    torch.cuda.synchronize()
    got = {k: v for k, v in counts().items() if v}
    lines = buf.getvalue().strip().splitlines()
    print(f"  (c) python -m repro_torch.launch.serve {' '.join(argv)}: "
          + " | ".join(lines) + f"; launches {got}")
    decoded = any(re.search(r"tok/s \(kv=bfloat16, mesh=1 device\)", ln)
                  for ln in lines)
    if (not decoded or not got or any(not k.startswith("spmv")
                                      for k in got)):
        raise SmokeFailure(f"LM launcher: decoded {decoded}, launches "
                           f"{got}")
    return got


def chaos_module():
    """``python -m repro_torch.launch.chaos_smoke`` in a subprocess on the
    card, ``SPC5_FAULTS`` set to phase 5a's four points at 10 %
    (``SERVE["chaos"]``): it must exit 0 (every request correct or failed
    with a catalogued error, at least one landed)."""
    env = dict(os.environ, PYTHONPATH=os.path.join(HERE, "src"),
               SPC5_FAULTS=SERVE["chaos"])
    t0 = time.perf_counter()
    out = subprocess.run([sys.executable, "-m",
                          "repro_torch.launch.chaos_smoke"],
                         capture_output=True, text=True, timeout=600,
                         cwd=HERE, env=env)
    lines = out.stdout.strip().splitlines()
    print(f"chaos module (SPC5_FAULTS={SERVE['chaos']}): exit "
          f"{out.returncode}, {time.perf_counter() - t0:.1f} s; "
          + " | ".join(ln.removeprefix("chaos_smoke: ").strip()
                       for ln in lines))
    if out.returncode != 0:
        raise SmokeFailure(f"the chaos module failed: "
                           f"{out.stderr[-2000:]}")
    return {"exit": out.returncode, "lines": lines}


def lm_decode(device):
    """Phase: LM decode (item 13, dense): (a) card against CPU on smoke
    configs, (b) yi-6b at full width and depth, (c) the launcher. Prints
    the phase's numbers on a ``{"lm_decode": ...}`` line and returns them
    with ``launches``, the launcher's kernel counts."""
    out = {"card_vs_cpu": lm_card_vs_cpu(device)}
    out["full"] = lm_full_size(device)
    for kv in LM_KV:
        d = out["full"][f"decode_{kv}"]
        busy = ("device time not measured" if d["device_ms"] is None else
                f"{d['device_ms']:.3f} ms of device time a step (busy "
                f"{d['device_ms'] / d['ms_per_step']:.3f}, idle "
                f"{1 - d['device_ms'] / d['ms_per_step']:.3f})")
        prof = ("not profiled" if d["kernels"] is None else
                f"one step under the profiler: {d['host_ops']} host ops, "
                f"{d['kernels']} kernels, {busy}")
        print(f"  decode {LM['arch']} bf16 weights, kv {kv}, "
              f"{LM['batch']} sequences: {d['ms_per_step']:.3f} ms a step, "
              f"{d['tok_s']:.1f} tok/s, weight-read bound "
              f"{d['bound_ms']:.3f} ms a step "
              f"({d['ms_per_step'] / d['bound_ms']:.2f}x); {prof}")
    out["launches"] = lm_launcher()
    print(json.dumps({"lm_decode": out}))
    return out


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the card",
              file=sys.stderr)
        return 1
    device = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    print(card_line())
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}")
    try:
        # the host-only inputs are made while nvcc builds the kernels
        wait_build = start_build()
        t_host = time.perf_counter()
        csr, mat = make_matrix()
        bcsr, bmat = make_band()
        breo, _ = band_reordering(bmat)
        w, vcsr, vmat = make_vocab()
        print(f"host inputs made beside the build: "
              f"{time.perf_counter() - t_host:.1f} s")
        wait_build()
        t_phase = time.perf_counter()
        small_check(device)
        print(f"phase small check: {time.perf_counter() - t_phase:.1f} s")
        t_phase = time.perf_counter()
        x_host = np.random.default_rng(0).standard_normal(
            mat.ncols).astype(np.float32)
        y64 = f64_matrix(csr) @ x_host.astype(np.float64)
        x = torch.from_numpy(x_host).to(device)
        check_auto_lowering(mat, device)
        plans, ys, launches = drive(mat, x, device)
        print(f"launches on the SpMV path: {launches}")
        errs = check(plans, ys, launches, x, y64)
        check_fem_spmm(plans, csr, device)
        rows = measure(plans, x, csr, launches, errs)
        print(f"phase SpMV path: {time.perf_counter() - t_phase:.1f} s")
        t_phase = time.perf_counter()
        tune_and_verify(csr, mat, plans, x, y64, w, device)
        del plans, ys
        print(f"phase tune and verify: {time.perf_counter() - t_phase:.1f} s")
        t_band = time.perf_counter()
        band = reorder_band(bcsr, bmat, breo, device)
        print(f"phase reordered band: {time.perf_counter() - t_band:.1f} s")
        t_phase = time.perf_counter()
        shard_launches, shard_per, examples = sharding(csr, mat, bcsr, bmat,
                                                       breo, device)
        del bcsr, bmat
        print(f"phase sharding: {time.perf_counter() - t_phase:.1f} s")
        t_phase = time.perf_counter()
        layers = build_layers(w, vmat, device)
        test_layer = build_test_layer(w, device)
        rng = np.random.default_rng(1)
        acts = {n: torch.from_numpy(rng.standard_normal(
            (n, VOCAB["cols"])).astype(np.float32)).to(device)
            for n in SPMM_NVECS}
        vys, y1, vlaunches = drive_vocab(layers, acts, device)
        print(f"launches on the SparseLinear path: {vlaunches}")
        verrs = check_vocab(layers, vys, y1, vlaunches, acts, vcsr)
        del vys, y1
        vper, library = measure_vocab(layers, acts, vcsr)
        batch1 = measure_batch1(layers, acts[SPMM_NVECS[0]][0].contiguous(),
                                vcsr, vlaunches, verrs)
        qlayers = build_quantised(vmat, device)
        qys, qlaunches = {}, {}
        for vdtype, width in qlayers.items():
            qys[vdtype], qlaunches[vdtype] = drive_quantised(width, acts,
                                                             device)
            print(f"launches on the {vdtype} SparseLinear path: "
                  f"{qlaunches[vdtype]}")
        qerrs, qpin = check_quantised(qlayers, qys, qlaunches, acts, vcsr)
        del qys
        qlib = quantised_library(vcsr, acts, {
            1: batch1["spmv_cuda_panels_desc_db"]["library_ms"], **library})
        qper = measure_quantised(qlayers, layers, acts, vcsr, qlib)
        print(f"phase SparseLinear path at f32, bf16 and int8: "
              f"{time.perf_counter() - t_phase:.1f} s")
        t_vreo = time.perf_counter()
        vreo = vocab_reordered(
            w, vmat, layers, qlayers, acts, vcsr,
            {1: batch1["spmv_cuda_panels_desc_db"]["library_ms"], **library},
            device)
        print(f"phase reordered vocab layer: "
              f"{time.perf_counter() - t_vreo:.1f} s")
        del qlayers, w
        tplan = build_token_plan(vmat, device)
        x1 = acts[SPMM_NVECS[0]][0].contiguous()
        tys, tlaunches = drive_token(tplan, x1, acts, device)
        print(f"launches on the whole-vector descriptor path: {tlaunches}")
        a64 = f64_matrix(vcsr)
        y64 = a64 @ x1.cpu().double().numpy()
        terrs = {name: check_y(name, tys[name], tplan, x1, y64, tlaunches,
                               "token path") for name in TOKEN_KERNELS}
        check_whole_grids(tplan, x1, y64, "token path")
        if tlaunches["spmm_cuda_desc"] <= 0:
            raise SmokeFailure(f"spmm_cuda_desc was not launched on the "
                               f"whole-vector descriptor path ({tlaunches})")
        for nvec, act in acts.items():
            x = act.t().contiguous()
            err = check_spmm("spmm_cuda_desc", tys["spmm_cuda_desc", nvec],
                             tplan, x, a64 @ x.cpu().double().numpy(),
                             "whole-vector descriptor path")
            terrs["spmm_cuda_desc"] = max(terrs.get("spmm_cuda_desc", 0.0),
                                          err)
            check_whole_spmm(tplan, x, a64 @ x.cpu().double().numpy(),
                             "whole-vector descriptor path")
        del tys
        token = measure_token(tplan, layers["whole_vector", "mask"].plan, x1,
                              acts, vcsr, tlaunches, terrs, vper, library)
        tq_launches, tq_errs, tq_pins, tq_per = token_quantised(
            vmat, tplan, acts, vcsr, qlib)
        for row in rows:
            for numbers in (token, batch1):
                if row["name"] in numbers:
                    row["vocab_batch1"] = numbers[row["name"]]
        rows += spmm_rows(VOCAB_SPMM, vper, vlaunches, verrs)
        rows += spmm_rows(("spmm_cuda_desc",), vper, tlaunches, terrs)
        del tplan
        t_phase = time.perf_counter()
        serve = serving_tier(vmat, vcsr, device)
        del vmat
        chaos_module()
        print(f"phase serving tier: {time.perf_counter() - t_phase:.1f} s")
        t_phase = time.perf_counter()
        lm = lm_decode(device)
        print(f"phase LM decode: {time.perf_counter() - t_phase:.1f} s")
        mat24 = convert_test_block(vcsr)
        flat = build_flat_test_plan(mat24, device)
        ys, y_flat, la, lb = drive_test(test_layer, flat, x1, acts, device)
        print(f"launches on the test path: (a) {la}; (b) {lb}")
        multi_errs = check_test(test_layer, flat, ys, y_flat, la, lb, x1,
                                acts, vcsr)
        del ys, y_flat
        tail_err, spmm_tail_err, tail = check_tail(test_layer.plan, x1,
                                                   acts)
        multi, tail_row, spmm_tail_row = measure_test(
            test_layer, flat, layers["panels", "descriptor"], x1, acts, vcsr,
            tail, la, tail_err, spmm_tail_err, library, multi_errs)
        for row in rows:
            if row["name"] in multi:
                row["test_multi_batch1"] = multi[row["name"]]
            if row["name"] in WHOLE_DESC_SPMV:
                row["flat_multi_batch1_ms"] = tail_row["test_path_ms"][
                    "flat_multi_spmv" + ("" if row["name"].endswith("_db")
                                         else "_s1")]
        rows += [tail_row, spmm_tail_row]
        rows += cmap_rows(band, vreo)
        tail_lib = {1: tail_row["library_ms"],
                    **{n: (spmm_tail_row if n == VOCAB["nvec"]
                           else spmm_tail_row[f"nvec_{n}"])["library_ms"]
                       for n in acts}}
        la_q, _, tq_tail_errs, tq_tail_pin, (tq_tail_per, tq_flat) = \
            test_quantised(test_layer, flat, mat24, acts, vcsr, tail_lib)
        del mat24
        for row in rows:
            name = row["name"]
            if name in SMALL_QUANTISED:
                launches, errs, pins, per = (
                    (qlaunches, qerrs, qpin, qper) if name in QUANTISED
                    else (tq_launches, tq_errs, tq_pins, tq_per))
                row["value_dtypes"] = ["f32", *VDTYPES]
                row["quantised"] = {
                    v: {"launches": launches[v][name],
                        "max_abs_err": errs[v][name],
                        "worst_pin_share": pins[v],
                        **{f"batch_{n}": numbers
                           for n, numbers in per[name][v].items()}}
                    for v in VDTYPES}
                if name in tq_flat:
                    row["quantised"]["bf16"]["flat_multi_batch1"] = \
                        tq_flat[name]
            elif name in (TAIL_KERNEL, SPMM_TAIL_KERNEL):
                row["value_dtypes"] = ["f32", *TAIL_VDTYPES]
                row["quantised"] = {"bf16": {
                    "launches": la_q[name], "max_abs_err": tq_tail_errs[name],
                    "worst_pin_share": tq_tail_pin,
                    **{f"batch_{n}": numbers
                       for n, numbers in tq_tail_per[name].items()}}}
        for row in rows:
            row["serve_launches"] = serve["launches"].get(row["name"], 0)
            row["shard_launches"] = shard_launches.get(row["name"], 0)
            row["lm_launches"] = lm["launches"].get(row["name"], 0)
        print(json.dumps({"sharding": shard_per, "examples": examples}))
    except SmokeFailure as e:
        print(f"chip_smoke FAILED: {e}", file=sys.stderr)
        return 1
    print(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
