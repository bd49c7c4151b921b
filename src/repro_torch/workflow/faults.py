"""Deterministic fault injection for workflow/fault-tolerance tests.

Failures are keyed on (job name, attempt) so tests reproduce exactly:
``FaultInjector(fail={"cluster_3": 2})`` makes job cluster_3 fail its
first two attempts and succeed on the third (if the retry budget allows).
A rate-based mode drives soak tests with a seeded RNG.
"""

from __future__ import annotations

import random
from dataclasses import dataclass, field


@dataclass
class FaultInjector:
    fail: dict[str, int] = field(default_factory=dict)  # name -> #attempts to fail
    rate: float = 0.0  # random failure probability per attempt
    seed: int = 0

    def __post_init__(self):
        self._rng = random.Random(self.seed)

    def should_fail(self, job_name: str, attempt: int) -> bool:
        if self.fail.get(job_name, 0) >= attempt:
            return True
        if self.rate > 0.0:
            return self._rng.random() < self.rate
        return False
