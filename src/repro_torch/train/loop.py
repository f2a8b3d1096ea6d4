"""Fault-tolerant training loop: checkpoint/restart, watchdog, preemption;
the port of ``repro.train.loop``.

  * auto-resume from the latest complete checkpoint (manifest-validated);
  * periodic + preemption-signal checkpointing (SIGTERM hook);
  * straggler watchdog: step times > tolerance x running median are logged
    and counted;
  * stateless data pipeline keyed by step -> exact-resume semantics.

Each step runs in an ``obs`` span (``train.step``) and is timed on
``obs.monotonic`` until the card has finished it
(``torch.cuda.synchronize``), as the serve launcher times
``serve.decode``; the clock is read directly so that a disabled registry,
whose spans last 0 s, does not blind the watchdog.
"""
from __future__ import annotations

import dataclasses
import signal
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch import obs
from repro_torch.checkpoint import (latest_step, restore_checkpoint,
                                    save_checkpoint)
from repro_torch.data.synthetic import SyntheticLM
from repro_torch.models.config import ModelConfig, ShapeConfig
from repro_torch.models.convert import tree_leaves


@dataclasses.dataclass
class TrainLoopConfig:
    steps: int = 100
    ckpt_dir: str = ""
    ckpt_every: int = 50
    keep_last: int = 3
    log_every: int = 10
    straggler_tolerance: float = 3.0
    seed: int = 0


def device_batch(batch: Dict[str, np.ndarray], device: torch.device
                 ) -> Dict[str, torch.Tensor]:
    """A host batch of :class:`SyntheticLM` as tensors on ``device``, dtypes
    kept (int32 tokens and labels: the model indexes and gathers with
    them as they are)."""
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
            for k, v in batch.items()}


def train_loop(train_step: Callable, params: Any, opt_state: Any,
               cfg: ModelConfig, shape: ShapeConfig,
               loop_cfg: TrainLoopConfig,
               put_batch: Optional[Callable] = None,
               log_fn: Callable = print) -> Dict[str, Any]:
    """Run the loop; returns {params, opt_state, history, stragglers,
    step_times}. ``put_batch`` (default :func:`device_batch` on the
    params' device) takes each host batch to the device; a sharded run's
    lays the batch out by the rules. In a sharded run every rank runs the
    loop and its own watchdog, and every rank takes part in each
    checkpoint, which rank 0 writes; the launcher gives the other ranks a
    silent ``log_fn``."""
    device = next(tree_leaves(params)).device
    if put_batch is None:
        def put_batch(b):
            return device_batch(b, device)
    data = SyntheticLM(cfg, shape.seq_len, shape.global_batch,
                       seed=loop_cfg.seed)
    start = 0
    if loop_cfg.ckpt_dir:
        last = latest_step(loop_cfg.ckpt_dir)
        if last is not None:
            state = restore_checkpoint(loop_cfg.ckpt_dir, last,
                                       {"params": params, "opt": opt_state})
            params, opt_state = state["params"], state["opt"]
            start = last
            log_fn(f"[resume] restored step {last} from {loop_cfg.ckpt_dir}")

    preempted = {"flag": False}

    def _on_term(signum, frame):
        preempted["flag"] = True

    prev_handler = signal.signal(signal.SIGTERM, _on_term)

    history: List[Dict[str, float]] = []
    step_times: List[float] = []
    stragglers = 0
    try:
        for step in range(start, loop_cfg.steps):
            batch = put_batch(data.batch(step))
            with obs.span("train.step", step=step):
                t0 = obs.monotonic()
                params, opt_state, metrics = train_step(params, opt_state,
                                                        batch)
                if device.type == "cuda":
                    torch.cuda.synchronize(device)
                dt = obs.monotonic() - t0
            step_times.append(dt)
            med = float(np.median(step_times[-32:]))
            if len(step_times) > 4 and dt > loop_cfg.straggler_tolerance * med:
                stragglers += 1
                log_fn(f"[watchdog] step {step} took {dt:.3f}s "
                       f"(median {med:.3f}s) -- straggler flagged")
            if step % loop_cfg.log_every == 0 or step == loop_cfg.steps - 1:
                row = {k: float(v) for k, v in metrics.items()}
                row.update(step=step, step_time=dt)
                history.append(row)
                log_fn(f"[train] step {step} loss={row['loss']:.4f} "
                       f"gnorm={row.get('grad_norm', 0):.3f} {dt*1e3:.0f}ms")
            ckpt_due = (loop_cfg.ckpt_dir
                        and (step + 1) % loop_cfg.ckpt_every == 0)
            if ckpt_due or (preempted["flag"] and loop_cfg.ckpt_dir):
                save_checkpoint(loop_cfg.ckpt_dir, step + 1,
                                {"params": params, "opt": opt_state},
                                keep_last=loop_cfg.keep_last)
            if preempted["flag"]:
                log_fn(f"[preempt] checkpointed at step {step + 1}, exiting")
                break
    finally:
        signal.signal(signal.SIGTERM, prev_handler)

    if loop_cfg.ckpt_dir and not preempted["flag"]:
        save_checkpoint(loop_cfg.ckpt_dir, loop_cfg.steps,
                        {"params": params, "opt": opt_state},
                        keep_last=loop_cfg.keep_last)
    return {"params": params, "opt_state": opt_state, "history": history,
            "stragglers": stragglers, "step_times": step_times}
