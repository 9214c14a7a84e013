"""Fault tolerance (own copy of the straggler detector of
``repro.distributed.fault_tolerance``): the training controller tracks
each step's wall time as an EWMA; a step slower than ``factor`` times the
EWMA is suspect, and ``patience`` suspect steps in a row ask for a
re-mesh.  The elastic re-mesh itself belongs to the sharded path, which
is not ported."""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class StragglerDetector:
    factor: float = 2.5
    patience: int = 3
    ewma: float = 0.0
    alpha: float = 0.1
    suspect_streak: int = 0

    def observe(self, step_time: float) -> str:
        """-> 'ok' | 'suspect' | 'remesh'."""
        if self.ewma == 0.0:
            self.ewma = step_time
            return "ok"
        verdict = "ok"
        if step_time > self.factor * self.ewma:
            self.suspect_streak += 1
            verdict = "suspect"
            if self.suspect_streak >= self.patience:
                verdict = "remesh"
                self.suspect_streak = 0
        else:
            self.suspect_streak = 0
            self.ewma = (1 - self.alpha) * self.ewma + self.alpha * step_time
        return verdict
