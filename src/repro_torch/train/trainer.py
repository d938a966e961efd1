"""Fault-tolerant training loop on one device (counterpart of
``repro/train/trainer.py``).

  * checkpoint/restart: async atomic checkpoints every ``ckpt_interval``
    steps in the reference's format; on a step failure the trainer
    restores the newest checkpoint and replays (``data_fn(step)`` is
    stateless, so replay is deterministic). A step that fails again after
    its replay re-raises instead of looping.
  * stragglers: steps slower than ``straggler_factor`` x the running
    median are counted.
"""
from __future__ import annotations

import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch.configs.base import TrainConfig
from repro_torch.models.recsys.model import (
    export_logical_params, import_logical_params,
)
from repro_torch.train import checkpoint as ckpt_lib
from repro_torch.train.train_step import build_train_step, init_opt_state


def put_batch(batch: Dict[str, np.ndarray], device) -> Dict:
    """A host batch (``dense``, ``cat``, ``label``) as tensors on
    ``device``."""
    dtypes = {"dense": torch.float32, "cat": torch.int32,
              "label": torch.float32}
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(
        device=device, dtype=dtypes.get(k))
        for k, v in batch.items()}


class Trainer:

    def __init__(self, model, tcfg: TrainConfig, data_fn: Callable, *,
                 ckpt_dir: Optional[str] = None, ckpt_interval: int = 50,
                 straggler_factor: float = 3.0):
        self.model = model
        self.device = model.device
        self.tcfg = tcfg
        self.data_fn = data_fn            # step -> host batch dict
        self.ckpt_dir = ckpt_dir
        self.ckpt_interval = ckpt_interval
        self.saver = ckpt_lib.AsyncSaver(ckpt_dir) if ckpt_dir else None
        self.straggler_factor = straggler_factor
        self.step_times: List[float] = []
        self.stragglers = 0
        self._step = build_train_step(model, tcfg)
        #: test hook: callable(step) that may raise to simulate a failure
        self.failure_injector: Optional[Callable[[int], None]] = None

    # -- state ----------------------------------------------------------------

    def init_state(self, seed: int = 0):
        params = self.model.init(torch.Generator().manual_seed(seed))
        return params, init_opt_state(params, self.tcfg)

    def save(self, step: int, params, opt_state):
        if self.saver is None:
            return
        tree = {"params": export_logical_params(self.model, params),
                "opt": opt_state}
        self.saver.save(step, tree, meta={"step": step})

    def restore(self):
        """Load the newest checkpoint, once any save in flight has landed:
        ``(step, params, opt_state)`` or None."""
        if self.ckpt_dir is None:
            return None
        if self.saver is not None:
            self.saver.wait()
        step = ckpt_lib.latest_step(self.ckpt_dir)
        if step is None:
            return None
        tree, _ = ckpt_lib.load_tree(self.ckpt_dir, step, device=self.device)
        return step, import_logical_params(self.model, tree["params"]), \
            tree["opt"]

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
                batch = put_batch(self.data_fn(step), self.device)
                params, opt_state, metrics = self._step(params, opt_state,
                                                        batch)
                loss = float(metrics["loss"])
                dt = time.perf_counter() - t0
                self._watch_stragglers(dt)
                history.append({"step": step, "loss": loss, "time": dt})
                if log_every and step % log_every == 0:
                    print(f"step {step}: loss={loss:.4f} ({dt*1e3:.1f} ms)")
                if self.saver and step % self.ckpt_interval == 0:
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
        if self.saver:
            self.save(num_steps - 1, params, opt_state)
            self.saver.wait()
        return {"params": params, "opt_state": opt_state,
                "history": history, "stragglers": self.stragglers}

    def _watch_stragglers(self, dt: float):
        if len(self.step_times) >= 5:
            med = float(np.median(self.step_times[-50:]))
            if dt > self.straggler_factor * med:
                self.stragglers += 1
        self.step_times.append(dt)
