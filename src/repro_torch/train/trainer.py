"""Fault-tolerant training loop: data + checkpoint + watchdog + restart.

The port of ``repro.train.trainer``, the loop the launcher runs:
  * deterministic data (restart-safe by construction),
  * periodic async checkpoints (atomic, keep-k),
  * failure handling: a ``SimulatedFailure`` (tests) triggers restore from
    the latest checkpoint and the run continues (elastic re-sharding onto a
    smaller mesh is not ported: ROADMAP queue 1 item 12),
  * the straggler watchdog escalates to the same checkpoint-restart path.
The model's parameters are updated in place; the device is read on the host
only for the metrics of every ``log_every``-th step and for checkpoints.
"""
from __future__ import annotations

import dataclasses
import logging
import os
import tempfile

import torch

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.data.pipeline import DataConfig, SyntheticLM, to_device
from repro_torch.ft import FailureInjector, SimulatedFailure, StepWatchdog
from repro_torch.optim.adamw import OptConfig, named
from repro_torch.train.step import make_train_step

log = logging.getLogger("repro_torch.trainer")


@dataclasses.dataclass
class TrainerConfig:
    total_steps: int = 100
    ckpt_every: int = 20
    ckpt_dir: str = dataclasses.field(default_factory=lambda: os.path.join(
        tempfile.gettempdir(), "repro_torch_ckpt"))
    ckpt_keep: int = 3
    log_every: int = 10
    max_restarts: int = 3
    async_ckpt: bool = True


class Trainer:
    def __init__(self, model, opt_cfg: OptConfig, data_cfg: DataConfig,
                 tcfg: TrainerConfig, *,
                 failure_injector: FailureInjector = None):
        self.model = model
        self.tcfg = tcfg
        self.data = SyntheticLM(data_cfg)
        self.ckpt = CheckpointManager(tcfg.ckpt_dir, keep=tcfg.ckpt_keep,
                                      async_save=tcfg.async_ckpt)
        self.watchdog = StepWatchdog()
        self.injector = failure_injector or FailureInjector()
        self.step_fn, self.opt = make_train_step(model, opt_cfg)
        self.metrics_history = []

    # ------------------------------------------------------------------
    def init_state(self, seed: int = 0):
        """The model's parameters re-initialized from ``seed`` (in place)
        and a fresh optimizer state."""
        params = self.model.params
        with torch.no_grad():
            for p, q in zip(params.parameters(),
                            self.model.init(seed).parameters()):
                p.copy_(q)
        return params, self.opt.init(params), 0

    @staticmethod
    def _state_tree(params, opt_state):
        """The checkpoint's tree: parameters and optimizer state under the
        port's names."""
        tree = {f"params/{k}": v for k, v in named(params).items()}
        tree["opt/step"] = opt_state.step
        for part in ("mu", "nu"):
            moments = getattr(opt_state, part)
            if moments is not None:
                tree.update({f"opt/{part}/{k}": v
                             for k, v in moments.items()})
        return tree

    def _restore(self, params, opt_state):
        step = self.ckpt.latest_step()
        if step is None:
            return None
        _, extra = self.ckpt.restore(self._state_tree(params, opt_state))
        log.warning("restored checkpoint at step %d", step)
        self.data.set_step(extra.get("data_step", step))
        return params, opt_state, step

    # ------------------------------------------------------------------
    def run(self):
        params, opt_state, start = self.init_state()
        restored = self._restore(params, opt_state)
        if restored:
            params, opt_state, start = restored
            self.data.set_step(start)
        restarts = 0
        step = start
        while step < self.tcfg.total_steps:
            try:
                batch = to_device(self.data.batch_at(step), self.model.device)
                self.injector.check(step)
                self.watchdog.start()
                params, opt_state, metrics = self.step_fn(
                    params, opt_state, batch)
                escalate = self.watchdog.stop(step)
                if escalate:
                    raise SimulatedFailure(
                        f"straggler watchdog escalation at step {step}")
                step += 1
                if step % self.tcfg.log_every == 0 or \
                        step == self.tcfg.total_steps:
                    m = {k: float(v) for k, v in metrics.items()}
                    m["step"] = step
                    self.metrics_history.append(m)
                    log.info("step %d: %s", step, m)
                if step % self.tcfg.ckpt_every == 0:
                    self.ckpt.save(step, self._state_tree(params, opt_state),
                                   extra={"data_step": step})
            except SimulatedFailure as e:
                restarts += 1
                log.warning("FAILURE: %s (restart %d)", e, restarts)
                if restarts > self.tcfg.max_restarts:
                    raise
                self.ckpt.wait()
                restored = self._restore(params, opt_state)
                if restored is None:          # no checkpoint yet: restart
                    params, opt_state, step = self.init_state()
                else:
                    params, opt_state, step = restored
        self.ckpt.wait()
        self.ckpt.save(step, self._state_tree(params, opt_state),
                       extra={"data_step": step})
        self.ckpt.wait()
        return params, opt_state, self.metrics_history
