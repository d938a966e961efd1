"""Fault-tolerant training loop (counterpart of ``repro/train/trainer.py``)
on one device or, with a ``mesh``, on every rank of it.

  * checkpoint/restart: async atomic checkpoints every ``ckpt_interval``
    steps in the reference's format; on a step failure the trainer
    restores the newest checkpoint and replays (``data_fn(step)`` is
    stateless, so replay is deterministic). A step that fails again after
    its replay re-raises instead of looping.
  * stragglers: steps slower than ``straggler_factor`` x the running
    median are counted.
  * elastic scaling: checkpoints hold the logical (mesh-independent)
    tables, so a run resumes on any mesh size (the optimizer state keeps
    the reference's physical layout: ``models.recsys.model.
    export_opt_state``).

On a mesh (``launch.mesh``; one rank a device) every rank runs the loop on
its data-parallel block of the same global batches
(``train_step.build_train_step``, ``mode`` gspmd or manual); every
rank takes part in a checkpoint's gather, rank 0 writes it and logs.
"""
from __future__ import annotations

import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.configs.base import TrainConfig
from repro_torch.data.pipeline import put_batch
from repro_torch.launch import mesh as meshlib
from repro_torch.models.recsys.model import (
    export_logical_params, export_opt_state, import_logical_params,
    import_opt_state,
)
from repro_torch.train import checkpoint as ckpt_lib
from repro_torch.train.train_step import build_train_step, init_opt_state


class Trainer:

    def __init__(self, model, tcfg: TrainConfig, data_fn: Callable, *,
                 ckpt_dir: Optional[str] = None, ckpt_interval: int = 50,
                 mode: str = "gspmd", straggler_factor: float = 3.0):
        self.model = model
        self.mesh = getattr(model, "mesh", None)
        self.device = model.device
        self.tcfg = tcfg
        self.data_fn = data_fn            # step -> host batch dict
        self.ckpt_dir = ckpt_dir
        self.ckpt_interval = ckpt_interval
        #: rank 0 of a mesh writes the checkpoints and logs
        self.lead = self.mesh is None or meshlib.axis_index(
            self.mesh, meshlib.all_axes(self.mesh)) == 0
        self.saver = ckpt_lib.AsyncSaver(ckpt_dir) \
            if ckpt_dir and self.lead else None
        self.straggler_factor = straggler_factor
        self.step_times: List[float] = []
        self.stragglers = 0
        self._step = build_train_step(model, tcfg, self.mesh, mode)
        #: test hook: callable(step) that may raise to simulate a failure
        self.failure_injector: Optional[Callable[[int], None]] = None

    # -- state ----------------------------------------------------------------

    def init_state(self, seed: int = 0):
        params = self.model.init(torch.Generator().manual_seed(seed))
        return params, init_opt_state(params, self.tcfg)

    def _barrier(self):
        if self.mesh is not None:
            dist.barrier(group=meshlib.axis_group(
                self.mesh, meshlib.all_axes(self.mesh)))

    def save(self, step: int, params, opt_state):
        if self.ckpt_dir is None:
            return
        # every rank gathers (a collective on a mesh); rank 0 writes
        tree = {"params": export_logical_params(self.model, params),
                "opt": export_opt_state(self.model, opt_state)}
        if self.saver is not None:
            self.saver.save(step, tree, meta={"step": step})

    def restore(self):
        """Load the newest checkpoint, once any save in flight has landed:
        ``(step, params, opt_state)`` or None."""
        if self.ckpt_dir is None:
            return None
        if self.saver is not None:
            self.saver.wait()
        self._barrier()
        step = ckpt_lib.latest_step(self.ckpt_dir)
        if step is None:
            return None
        tree, _ = ckpt_lib.load_tree(self.ckpt_dir, step, device=self.device)
        return (step, import_logical_params(self.model, tree["params"]),
                import_opt_state(self.model, tree["opt"]))

    # -- loop -----------------------------------------------------------------

    def train(self, num_steps: int, *, seed: int = 0, log_every: int = 0,
              initial_state=None) -> Dict:
        """``initial_state=(params, opt_state)`` seeds the loop with
        weights already held (``opt_state=None`` re-inits the optimizer);
        a checkpoint in ``ckpt_dir`` still takes precedence."""
        if initial_state is not None:
            params, opt_state = initial_state
            if opt_state is None:
                opt_state = init_opt_state(params, self.tcfg)
        else:
            params, opt_state = self.init_state(seed)
        start = 0
        restored = self.restore()
        if restored is not None:
            start, params, opt_state = restored
            start += 1
        history = []
        failed = set()
        step = start
        while step < num_steps:
            try:
                if self.failure_injector is not None:
                    self.failure_injector(step)
                t0 = time.perf_counter()
                batch = put_batch(self.data_fn(step), self.device,
                                  self.mesh)
                params, opt_state, metrics = self._step(params, opt_state,
                                                        batch)
                loss = float(metrics["loss"])
                dt = time.perf_counter() - t0
                self._watch_stragglers(dt)
                history.append({"step": step, "loss": loss, "time": dt})
                if log_every and step % log_every == 0 and self.lead:
                    print(f"step {step}: loss={loss:.4f} ({dt*1e3:.1f} ms)")
                if self.ckpt_dir and step % self.ckpt_interval == 0:
                    self.save(step, params, opt_state)
                step += 1
            except (OSError, RuntimeError, ValueError):
                # node failure path: restore + replay, once per step
                if step in failed:
                    raise
                failed.add(step)
                restored = self.restore()
                if restored is None:
                    params, opt_state = self.init_state(seed)
                    step = 0
                else:
                    rstep, params, opt_state = restored
                    step = rstep + 1
        if self.ckpt_dir is not None:
            self.save(num_steps - 1, params, opt_state)
            if self.saver is not None:
                self.saver.wait()
            self._barrier()
        return {"params": params, "opt_state": opt_state,
                "history": history, "stragglers": self.stragglers}

    def _watch_stragglers(self, dt: float):
        if len(self.step_times) >= 5:
            med = float(np.median(self.step_times[-50:]))
            if dt > self.straggler_factor * med:
                self.stragglers += 1
        self.step_times.append(dt)
