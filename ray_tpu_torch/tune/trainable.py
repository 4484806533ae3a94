"""Trainable — the class-based trial API: the port's copy of
``ray_tpu/tune/trainable.py`` (pure Python).

Reference parity: ray.tune.Trainable (tune/trainable/trainable.py:58):
subclasses implement `setup(config)`, `step()`, `save_checkpoint()`,
`load_checkpoint(state)`; the framework drives `train()` which wraps one
`step()` with iteration bookkeeping. Tune runs a Trainable subclass as a
trial by looping train() and shipping `save_checkpoint()` blobs through
the session, so schedulers (ASHA stop, PBT/PB2 exploit) can pause a
trial and any restart resumes from the last checkpoint instead of from
scratch.
"""

from __future__ import annotations

import time


class Trainable:
    """Subclass and implement setup/step/save_checkpoint/load_checkpoint.

    Unlike the function-trainable (which calls `tune.report` itself), the
    class API inverts control: the trial loop calls `train()` repeatedly
    and persists checkpoints between steps.
    """

    def __init__(self, config: dict | None = None):
        self.config = config or {}
        self._iteration = 0
        self._time_total = 0.0
        self.setup(self.config)

    # -- subclass surface -------------------------------------------------

    def setup(self, config: dict):
        """One-time initialization (reference: Trainable.setup)."""

    def step(self) -> dict:
        """One training iteration; returns a metrics dict (reference:
        Trainable.step — MUST be overridden)."""
        raise NotImplementedError

    def save_checkpoint(self) -> dict:
        """Return picklable state capturing everything `load_checkpoint`
        needs to resume (reference: Trainable.save_checkpoint)."""
        return {}

    def load_checkpoint(self, state: dict):
        """Restore from a `save_checkpoint` payload."""

    def cleanup(self):
        """Release resources (actors, files) at trial end."""

    # -- framework surface ------------------------------------------------

    @property
    def iteration(self) -> int:
        return self._iteration

    def train(self) -> dict:
        """One step + bookkeeping (reference: Trainable.train :331 wraps
        step with iteration/time accounting)."""
        t0 = time.perf_counter()
        result = self.step() or {}
        dt = time.perf_counter() - t0
        self._iteration += 1
        self._time_total += dt
        result.setdefault("training_iteration", self._iteration)
        result.setdefault("time_this_iter_s", dt)
        result.setdefault("time_total_s", self._time_total)
        return result

    def stop(self):
        self.cleanup()

    # -- session bridging (used by the Tuner's class-trainable driver) ---

    def _full_state(self) -> dict:
        return {"__trainable__": self.save_checkpoint(),
                "__iteration__": self._iteration,
                "__time_total__": self._time_total}

    def _restore_full_state(self, state: dict):
        self._iteration = int(state.get("__iteration__", 0))
        self._time_total = float(state.get("__time_total__", 0.0))
        self.load_checkpoint(state.get("__trainable__", {}))


def is_trainable_class(obj) -> bool:
    return isinstance(obj, type) and issubclass(obj, Trainable)
