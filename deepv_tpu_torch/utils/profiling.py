"""Phase timing and trace capture for the rollout.

Counterpart of ``deepv_tpu/utils/profiling.py``: an accumulating wall-clock
timer over named phases (``PhaseTimer``), a wait for the device values of a
nested structure (``force_completion``) and one-call trace capture
(``device_trace``, deepv_tpu's ``tpu_trace``). With ``sync=True`` a phase
waits for the card (``torch.cuda.synchronize``) before it stops the clock,
so it measures the device work and not only its launch.
"""

from __future__ import annotations

import contextlib
import json
import os
import tempfile
import time
from collections import defaultdict
from typing import Dict, Optional

import torch


def synchronize(device) -> None:
    """Wait for all work queued on ``device`` (a no-op for the CPU)."""
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _tensors(x):
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, dict):
        for v in x.values():
            yield from _tensors(v)
    elif isinstance(x, (list, tuple)):
        for v in x:
            yield from _tensors(v)


def force_completion(x) -> None:
    """Wait for every tensor of ``x`` (a tensor, or dicts, lists and tuples
    of them; other leaves are skipped): each card that holds one is
    synchronised once."""
    for device in {t.device for t in _tensors(x)}:
        synchronize(device)


class PhaseTimer:
    """Accumulating wall-clock timer; phases may nest, and a nested phase's
    time counts in its parent's too.

    >>> timer = PhaseTimer()
    >>> with timer.phase("denoise"):
    ...     ...
    >>> timer.stats()
    {"denoise": {"total_s": ..., "count": ..., "mean_s": ...}}
    """

    def __init__(self, sync: bool = False, device="cpu"):
        #: when False, phases time host-side launch only (device work is
        #: asynchronous); when True each phase ends with a device sync
        self.sync = sync
        self.device = device
        self._total = defaultdict(float)
        self._count = defaultdict(int)

    @contextlib.contextmanager
    def phase(self, name: str, sync_value=None):
        """Time the block under ``name``; before the clock stops, wait for
        the tensors of ``sync_value`` (``force_completion``) and, with
        ``sync``, for the whole device."""
        if self.sync:
            synchronize(self.device)
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if sync_value is not None:
                force_completion(sync_value)
            if self.sync:
                synchronize(self.device)
            self.add(name, time.perf_counter() - t0)

    def add(self, name: str, seconds: float) -> None:
        """Count ``seconds`` measured elsewhere as one call of ``name``."""
        self._total[name] += seconds
        self._count[name] += 1

    def stats(self) -> Dict[str, Dict[str, float]]:
        """Per phase: total seconds, count and mean seconds, to 4 places."""
        return {k: {"total_s": round(self._total[k], 4), "count": self._count[k],
                    "mean_s": round(self._total[k] / max(self._count[k], 1), 4)}
                for k in self._total}

    def report(self) -> str:
        """``stats()`` as indented JSON."""
        return json.dumps(self.stats(), indent=2)


#: the trace file ``device_trace`` writes in its directory
TRACE_FILE = "trace.json"


@contextlib.contextmanager
def device_trace(logdir: Optional[str] = None, device="cuda"):
    """Capture a ``torch.profiler`` trace of the block: host operations and,
    when ``device`` is a card, its kernels (CUDA activity), written on exit
    to ``logdir/trace.json`` as a Chrome trace (Perfetto and
    chrome://tracing read it). ``logdir`` defaults to ``deepv_trace`` in
    the temporary directory. Yields ``logdir``."""
    from torch.profiler import ProfilerActivity, profile

    logdir = os.path.join(tempfile.gettempdir(), "deepv_trace") if logdir is None else logdir
    device = torch.device(device)
    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("device_trace on a card, but no CUDA device is available; "
                               "pass device='cpu' to trace the CPU")
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield logdir
        synchronize(device)        # the block's kernels end inside the capture
    prof.export_chrome_trace(os.path.join(logdir, TRACE_FILE))
