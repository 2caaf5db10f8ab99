"""Fault tolerance & straggler mitigation for the training driver.

  * `StragglerDetector` — per-step wall-time EWMA with robust z-score; a
    host whose step times exceed `threshold` sigma flags itself (on real
    multi-host deployments this feeds the coordinator's restart/evict
    decision; single-process here, the mechanism is identical).
  * `RestartPolicy` — crash-loop accounting: bounded restarts within a
    window, exponential backoff.
  * `run_resilient` — wraps a step function with checkpoint/restore so a
    raised fault (or injected test fault) resumes from the last checkpoint
    — the integration tests kill the loop mid-run and assert bitwise
    recovery of progress.
"""

from __future__ import annotations

import dataclasses
import time


@dataclasses.dataclass
class StragglerDetector:
    alpha: float = 0.1          # EWMA factor
    threshold: float = 3.0      # sigma
    warmup: int = 10
    mean: float = 0.0
    var: float = 0.0
    n: int = 0

    def observe(self, step_time_s: float) -> bool:
        """Record one step; True if this step looks like a straggler.

        The z-score is computed against the *pre-update* statistics so an
        outlier cannot mask itself by inflating the EWMA it is judged by.
        """
        self.n += 1
        if self.n == 1:
            self.mean = step_time_s
            return False
        sigma = max(self.var ** 0.5, 1e-9)
        is_straggler = (self.n >= self.warmup
                        and (step_time_s - self.mean) / sigma > self.threshold)
        delta = step_time_s - self.mean
        self.mean += self.alpha * delta
        self.var = (1 - self.alpha) * (self.var + self.alpha * delta * delta)
        return is_straggler


@dataclasses.dataclass
class RestartPolicy:
    max_restarts: int = 5
    window_s: float = 3600.0
    backoff_s: float = 1.0
    history: list = dataclasses.field(default_factory=list)

    def should_restart(self, now: float | None = None) -> bool:
        now = time.time() if now is None else now
        self.history = [t for t in self.history if now - t < self.window_s]
        return len(self.history) < self.max_restarts

    def record(self, now: float | None = None) -> float:
        """Record a restart; returns the backoff delay to apply."""
        now = time.time() if now is None else now
        self.history.append(now)
        return self.backoff_s * (2 ** (len(self.history) - 1))


def run_resilient(state, data, step_fn, manager, *, n_steps: int,
                  checkpoint_every: int = 10,
                  fault_at: int | None = None, _policy=None):
    """Checkpoint/restart training loop.

    `fault_at`: injects a crash at that step (tests).  On any exception the
    loop restores the latest checkpoint and continues; data batches are
    addressed by step so no data is replayed or skipped.
    """
    policy = _policy or RestartPolicy()
    detector = StragglerDetector()
    faults_remaining = 1 if fault_at is not None else 0
    metrics_log = []
    step = int(state.step)
    while step < n_steps:
        try:
            t0 = time.time()
            if faults_remaining and step == fault_at:
                faults_remaining -= 1
                raise RuntimeError(f"injected fault at step {step}")
            batch = data.batch(step)
            state, metrics = step_fn(state, batch)
            straggler = detector.observe(time.time() - t0)
            metrics["straggler"] = straggler
            metrics_log.append({k: float(v) if hasattr(v, "item") or
                                isinstance(v, (int, float)) else v
                                for k, v in metrics.items()})
            step = int(state.step)
            if step % checkpoint_every == 0:
                manager.save(step, state)
        except Exception as e:  # noqa: BLE001 — resilience boundary
            if not policy.should_restart():
                raise
            delay = policy.record()
            print(f"fault: {e}; restarting (backoff {delay:.1f}s)")
            restored_step, restored = manager.restore_latest(state)
            if restored is not None:
                state = restored
                step = restored_step
            else:
                step = 0
    manager.wait()
    return state, metrics_log
