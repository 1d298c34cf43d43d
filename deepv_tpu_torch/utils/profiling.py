"""Phase timing for the rollout.

Counterpart of ``deepv_tpu/utils/profiling.py::PhaseTimer``: an accumulating
wall-clock timer over named phases. With ``sync=True`` a phase waits for the
card (``torch.cuda.synchronize``) before it stops the clock, so it measures
the device work and not only its launch.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from typing import Dict

import torch


def synchronize(device) -> None:
    """Wait for all work queued on ``device`` (a no-op for the CPU)."""
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class PhaseTimer:
    """Accumulating wall-clock timer; phases may nest, and a nested phase's
    time counts in its parent's too."""

    def __init__(self, sync: bool = False, device="cpu"):
        #: when False, phases time host-side launch only (device work is
        #: asynchronous); when True each phase ends with a device sync
        self.sync = sync
        self.device = device
        self._total = defaultdict(float)
        self._count = defaultdict(int)

    @contextlib.contextmanager
    def phase(self, name: str):
        if self.sync:
            synchronize(self.device)
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if self.sync:
                synchronize(self.device)
            self._total[name] += time.perf_counter() - t0
            self._count[name] += 1

    def stats(self) -> Dict[str, Dict[str, float]]:
        """Per phase: total seconds, count and mean seconds."""
        return {k: {"total_s": self._total[k], "count": self._count[k],
                    "mean_s": self._total[k] / max(self._count[k], 1)}
                for k in self._total}
