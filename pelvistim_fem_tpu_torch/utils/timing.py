"""Per-phase wall-time counters of the apps (stdlib twin of
pelvistim_fem_tpu/utils/timing.py).

Times are host wall clock: a phase that launches device work must
synchronise before it ends (the solvers read a stopping flag every
iteration, so their phases do).
"""

from __future__ import annotations

import time
from contextlib import contextmanager


class PhaseTimer:
    """Seconds per named phase, summed over the phase's runs."""

    def __init__(self):
        self.phases: dict[str, float] = {}

    @contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.phases[name] = (self.phases.get(name, 0.0)
                                 + time.perf_counter() - t0)

    def report(self) -> dict:
        return dict(self.phases)
