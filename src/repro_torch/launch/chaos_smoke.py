"""End-to-end chaos smoke for the ``SPC5_FAULTS`` environment arming path.

    SPC5_FAULTS=plan.build:0.1:1,cache.admit:0.1:2,exec.spmv:0.1:3,\\
    exec.spmm:0.1:4,serve.gather:0.1:5,serve.exec:0.1:6 \\
        PYTHONPATH=src python -m repro_torch.launch.chaos_smoke [--device cpu]

The port of the reference's ``tools/chaos_smoke.py``. The resilience
tests arm their own fault sets programmatically; this module goes through
the deployment path -- ``SPC5_FAULTS`` in the environment, armed once when
``repro_torch.obs.faults`` is imported -- and then proves the serving
tier's contract under it: every request either lands with the correct
result (within 1e-5 of a suppressed-injection oracle, the plain PyTorch
version on the plan's device) or fails with a catalogued resilience error,
and at least one request lands. With fixed seeds a failure replays
bit-identically from the same spec string.

The plan and the requests go to the card unless ``--device`` (or
``main(device=...)``) names another device, as for every entry point of
the port.

Exit status: 0 when the contract held, 1 otherwise.
"""
from __future__ import annotations

import argparse
import functools
import sys
from typing import Optional


def main(argv=None, *, device: Optional[str] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.launch.chaos_smoke",
        description="serve SpMV requests under the SPC5_FAULTS fault set "
                    "and hold every landed result to the oracle")
    ap.add_argument("--device", default=device,
                    help="where the plan runs (default: the card)")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    from repro_torch import obs
    from repro_torch.core import formats as F
    from repro_torch.core import matgen
    from repro_torch.core import plan as P
    from repro_torch.kernels import ops
    from repro_torch.launch import resilience
    from repro_torch.launch import server as SV

    faults = obs.faults.get_faults()
    if not faults:
        print("chaos_smoke: SPC5_FAULTS is not set or armed nothing; "
              "this smoke only means something under injection",
              file=sys.stderr)
        return 1
    print(f"chaos_smoke: armed points = {list(faults.points)}")
    dev = ops.resolve_device(args.device)

    csr = matgen.pruned_weight(256, 128, 0.1, (1, 8), seed=0)
    mat = F.csr_to_spc5(csr, 1, 8)
    cache = SV.PlanCache(capacity_bytes=16 << 20, verify_on_admit=True,
                         builder=functools.partial(ops.prepare, device=dev))
    # plan.build / cache.admit chaos: the ladder must still land a plan
    plan = cache.get_or_build(mat, layout="panels", pr=64, xw=16, cb=32,
                              tune=False, lowering="mask")

    rng = np.random.default_rng(0)
    xs = [torch.from_numpy(rng.standard_normal(mat.shape[1])
                           .astype(np.float32)).to(plan.device)
          for _ in range(8)]
    with faults.suppress():
        refs = [P.execute_spmv(plan, x, use_pallas=False,
                               double_buffer=False).cpu().numpy()
                for x in xs]
        # the first call of a kernel builds it (nvcc, up to minutes on the
        # card): build the SpMV and SpMM kernels before requests are timed
        P.execute_spmv(plan, xs[0])
        P.execute_spmm(plan, torch.stack(xs[:4], dim=1))

    ok = failed = 0
    with SV.SPC5Server(plan, cache=cache, window_us=500,
                       max_batch=4) as srv:
        futs = [srv.submit(xs[i % len(xs)]) for i in range(32)]
        for i, f in enumerate(futs):
            try:
                y = f.result(timeout=120).cpu().numpy()
            except (resilience.ShedError,
                    resilience.DeadlineExceededError,
                    resilience.CircuitOpenError,
                    obs.faults.FaultError):
                failed += 1
                continue
            if not np.allclose(y, refs[i % len(xs)], rtol=1e-5, atol=1e-5):
                print(f"chaos_smoke: request {i} diverged from the oracle",
                      file=sys.stderr)
                return 1
            ok += 1
        st = srv.stats()

    print(f"chaos_smoke: plan {plan.layout} + {plan.lowering} on "
          f"{plan.device}; ok={ok} failed={failed} "
          f"degraded={st['degraded']} restarts={st['worker_restarts']} "
          f"breaker={st['breaker']}")
    for point, ps in faults.stats().items():
        print(f"chaos_smoke:   {point}: checks={ps['checks']} "
              f"fired={ps['fired']} (rate={ps['rate']}, seed={ps['seed']})")
    if ok == 0:
        print("chaos_smoke: no request landed; the ladder never recovered",
              file=sys.stderr)
        return 1
    print("chaos_smoke: contract held (every landed result matched the "
          "oracle)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
