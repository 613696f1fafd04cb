"""Fault tolerance: failure injection, restart policy, straggler detection.

  - every K steps an async checkpoint is written;
  - a node failure surfaces as an exception -> the runner restores the
    latest checkpoint and replays from its step (the data pipeline gives
    the same batch for a step after a restart, so the replay is exact);
  - stragglers are handled by a per-step deadline: a step that exceeds
    ``straggler_factor x`` the EWMA step time raises StragglerDetected so the
    runner can flag the slow host (tests inject synthetic delays).

The port's copy of ``repro/ft/failures.py``, with one deliberate
difference: after a straggler the run resumes from the slow step's result
(:meth:`FaultTolerantRunner.run`), where the JAX copy resumes from the
state its segment started with.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional


class NodeFailure(RuntimeError):
    pass


class StragglerDetected(RuntimeError):
    def __init__(self, step: int, t: float, ewma: float):
        super().__init__(f"step {step} took {t:.3f}s vs ewma {ewma:.3f}s")
        self.step = step


@dataclasses.dataclass
class FailurePlan:
    """Deterministic failure schedule for tests/drills."""
    fail_at_steps: tuple = ()
    straggle_at_steps: tuple = ()
    straggle_seconds: float = 0.5
    kill_nodes: int = 1


@dataclasses.dataclass
class FTConfig:
    ckpt_every: int = 10
    max_restarts: int = 10
    straggler_factor: float = 3.0
    ewma_alpha: float = 0.2
    min_steps_for_ewma: int = 3


@dataclasses.dataclass
class RunState:
    step: int = 0
    restarts: int = 0
    ewma_step_time: float = 0.0
    excluded_nodes: int = 0
    history: List[Dict] = dataclasses.field(default_factory=list)


class FaultTolerantRunner:
    """Drives step_fn with checkpoint/restart + straggler detection.

    step_fn(state_dict, step) -> state_dict   (pure training step closure)
    save_fn(step, state_dict), restore_fn() -> (step, state_dict) | None
    """

    def __init__(self, cfg: FTConfig, step_fn, save_fn, restore_fn,
                 plan: Optional[FailurePlan] = None,
                 on_restart: Optional[Callable[[RunState], None]] = None):
        self.cfg = cfg
        self.step_fn = step_fn
        self.save_fn = save_fn
        self.restore_fn = restore_fn
        self.plan = plan or FailurePlan()
        self.on_restart = on_restart
        self.state = RunState()

    def _maybe_inject(self, step: int):
        if step in self.plan.fail_at_steps:
            # only fail once per scheduled step
            self.plan = dataclasses.replace(
                self.plan, fail_at_steps=tuple(
                    s for s in self.plan.fail_at_steps if s != step))
            raise NodeFailure(f"injected node failure at step {step}")
        if step in self.plan.straggle_at_steps:
            self.plan = dataclasses.replace(
                self.plan, straggle_at_steps=tuple(
                    s for s in self.plan.straggle_at_steps if s != step))
            time.sleep(self.plan.straggle_seconds)

    def run(self, init_state, n_steps: int):
        rs = self.state
        train_state = init_state
        while rs.step < n_steps:
            try:
                self._run_segment(train_state, n_steps)
                return self._final
            except NodeFailure as e:
                rs.restarts += 1
                rs.history.append({"step": rs.step, "event": str(e)})
                if rs.restarts > self.cfg.max_restarts:
                    raise
                restored = self.restore_fn()
                if restored is None:
                    rs.step = 0
                    train_state = init_state
                else:
                    rs.step, train_state = restored
                if self.on_restart:
                    self.on_restart(rs)
            except StragglerDetected as e:
                rs.history.append({"step": e.step, "event": str(e)})
                rs.excluded_nodes += 1
                # continue without restart: the slow host is flagged for the
                # next scheduling decision; the step already completed, so
                # the run goes on from the state that step returned (the
                # JAX copy goes on from the state the segment started
                # with, which is stale)
                train_state = self._final
        return self._final

    def _run_segment(self, train_state, n_steps: int):
        rs = self.state
        while rs.step < n_steps:
            self._maybe_inject(rs.step)
            t0 = time.perf_counter()
            train_state = self.step_fn(train_state, rs.step)
            dt = time.perf_counter() - t0
            rs.step += 1
            if rs.step % self.cfg.ckpt_every == 0:
                self.save_fn(rs.step, train_state)
            self._final = train_state
            # straggler detection on EWMA
            if rs.ewma_step_time == 0.0:
                rs.ewma_step_time = dt
            slow = (rs.step > self.cfg.min_steps_for_ewma and
                    dt > self.cfg.straggler_factor * rs.ewma_step_time)
            rs.ewma_step_time = ((1 - self.cfg.ewma_alpha) * rs.ewma_step_time
                                 + self.cfg.ewma_alpha * dt)
            if slow:
                raise StragglerDetected(rs.step - 1, dt, rs.ewma_step_time)
        return train_state
