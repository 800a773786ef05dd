"""Fault-tolerant training driver, the port of the JAX package's
``training/driver.py``.

Deterministic data (restart-exact), a checkpoint every N steps with
atomic publish, automatic resume from LATEST, a straggler watchdog
(step-time EMA; slow steps fire a callback that a fleet controller would
use to evict or replace the slow host), and a failure injector used to
prove restart-exactness.

The model is trained in place: ``train`` resumes a checkpoint into its
parameters and returns it.  Checkpoints hold ``{"params": the JAX
layout, "opt": AdamWState}`` in the JAX package's format, so either
package resumes the other's (float32 configs: the JAX package restores
a bfloat16 leaf as raw ``|V2`` bytes).  On a mesh (parameters that are
DTensors) a checkpoint holds the full tensors, so a job resumes on any
mesh.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, Optional

import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.data import BatchPipeline
from repro_torch.distributed.elastic import place_like
from repro_torch.models.convert import (adamw_state_from_jax,
                                        lm_load_params, lm_to_params)
from .optimizer import AdamW
from .step import make_train_step


@dataclasses.dataclass
class StragglerWatchdog:
    """Flags steps slower than ``threshold`` x EMA(step_time).

    A fleet controller collects these events over all hosts; a host that
    flags persistently gets drained and its data-parallel shard
    re-assigned.  Here: detection + callback.
    """
    threshold: float = 3.0
    alpha: float = 0.1
    on_straggler: Optional[Callable[[int, float, float], None]] = None
    _ema: float = 0.0
    events: int = 0

    def observe(self, step: int, dt: float) -> bool:
        if self._ema == 0.0:
            self._ema = dt
            return False
        slow = dt > self.threshold * self._ema
        if slow:
            self.events += 1
            if self.on_straggler:
                self.on_straggler(step, dt, self._ema)
        # EMA excludes outliers so one hiccup doesn't mask the next
        if not slow:
            self._ema = (1 - self.alpha) * self._ema + self.alpha * dt
        return slow


class FailureInjector:
    """Deterministic crash at a given step (tests restart-exactness)."""

    def __init__(self, at_step: Optional[int] = None):
        self.at_step = at_step
        self.fired = False

    def maybe_fail(self, step: int) -> None:
        if self.at_step is not None and step == self.at_step and not self.fired:
            self.fired = True
            raise RuntimeError(f"injected failure at step {step}")


def train(cfg, model, opt: AdamW, pipeline: BatchPipeline, *,
          steps: int, ckpt_dir: Optional[str] = None, ckpt_every: int = 50,
          train_step: Optional[Callable] = None,
          watchdog: Optional[StragglerWatchdog] = None,
          injector: Optional[FailureInjector] = None,
          log_every: int = 10,
          log: Callable[[str], None] = print,
          place_batch: Optional[Callable[[Dict], Dict]] = None
          ) -> Dict[str, Any]:
    """Run (or resume) a training job on ``model``'s device.  Returns the
    trained model (``params``), the optimizer state, the history and each
    step's seconds.  ``place_batch`` maps a step's batch of this rank's
    rows on the device to what the step takes (on a mesh: DTensors)."""
    step_fn = train_step or make_train_step(cfg, opt)
    dev = model.device
    params = lm_to_params(model)
    opt_state = opt.init(params)
    start_step = 0
    mgr = CheckpointManager(ckpt_dir, every=ckpt_every) if ckpt_dir else None

    if mgr is not None:
        restored = mgr.restore_or_none({"params": params, "opt": opt_state})
        if restored is not None:
            tree, ck_step, extra = restored
            lm_load_params(model, tree["params"])
            # on a mesh the moments go where the fresh state's DTensors are
            opt_state = place_like(adamw_state_from_jax(tree["opt"], dev),
                                   opt_state)
            start_step = ck_step
            log(f"[driver] resumed from checkpoint step {ck_step}")
    del params

    history, seconds = [], []
    watchdog = watchdog or StragglerWatchdog()
    for step in range(start_step, steps):
        if injector is not None:
            injector.maybe_fail(step)
        x, y = pipeline.batch_at(step)
        batch = {"tokens": torch.from_numpy(x).to(dev),
                 "labels": torch.from_numpy(y).to(dev)}
        if place_batch is not None:
            batch = place_batch(batch)
        t0 = time.perf_counter()
        model, opt_state, metrics = step_fn(model, opt_state, batch)
        loss = float(metrics["loss"])   # blocks; also the step boundary
        dt = time.perf_counter() - t0
        watchdog.observe(step, dt)
        history.append(loss)
        seconds.append(dt)
        if step % log_every == 0:
            log(f"[driver] step {step} loss {loss:.4f} "
                f"({dt*1e3:.0f} ms/step)")
        # the tree is built only for a step that saves: it copies the
        # parameters into the stacked layout
        if mgr is not None and (step + 1) % mgr.every == 0:
            mgr.maybe_save(step + 1, {"params": lm_to_params(model),
                                      "opt": opt_state},
                           extra={"pipeline_step": step + 1})
    return {"params": model, "opt_state": opt_state, "history": history,
            "step_seconds": seconds, "straggler_events": watchdog.events,
            "last_step": steps}
