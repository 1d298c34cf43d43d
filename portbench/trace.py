"""The profiler over a slice of a traced run's window, and what is read
from it: the seconds in which a kernel ran (the union of kernel
intervals), the slice's wall seconds, each kernel name's device seconds,
the idle gaps between kernels by the host phase that was open, and the
device seconds of the marked K1 calls."""

from __future__ import annotations

import bisect
import time
from collections import defaultdict
from typing import Dict, Optional

import torch

from .stats import merged, union_length

#: host ranges that idle gaps are attributed to (the program's phases and
#: the benchmark's mark of K1), innermost first. A served step runs its
#: phases on the server's thread, whose ranges the profiler did not record
#: on the card, so a served run's gaps read as "host (no phase open)"
RANGES = ("portbench.attention", "prime", "vae_encode", "vae_decode", "stream_decode",
          "denoise_unit")


class Tracer:
    def __init__(self, device):
        from torch.profiler import ProfilerActivity, profile

        self.device = torch.device(device)
        acts = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        self.prof = profile(activities=acts)
        self.running = False
        self.wall_s: Optional[float] = None
        self._t0 = None

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def start(self) -> None:
        self._sync()
        self.prof.start()
        self._t0 = time.perf_counter()
        self.running = True

    def stop(self) -> None:
        self._sync()
        self.wall_s = time.perf_counter() - self._t0
        self.prof.stop()
        self.running = False

    def reduce(self) -> Optional[Dict]:
        """The slice's numbers; None when no slice was recorded or no
        kernel ran in it. Read from the profiler's raw events: a kernel's
        launch is the runtime call with its correlation id, and a kernel
        belongs to a marked range when its launch lies inside the range on
        the range's thread."""
        if self.wall_s is None:
            return None
        from torch.autograd import DeviceType

        events = self.prof.profiler.kineto_results.events()
        kernels, hosts, launches = [], [], {}
        for e in events:
            if e.device_type() == DeviceType.CUDA:
                if not e.is_user_annotation():
                    kernels.append((e.start_ns(), e.end_ns(), e.name(), e.correlation_id()))
            elif e.name() in RANGES:
                hosts.append((e.name(), e.start_ns(), e.end_ns(), e.start_thread_id()))
            elif e.name().startswith("cu") and e.correlation_id():
                # a runtime call (cudaLaunchKernel, cuLaunchKernelEx, ...)
                launches[e.correlation_id()] = (e.start_ns(), e.start_thread_id())
        if not kernels:
            return None
        spans = [(a, b) for a, b, _, _ in kernels]
        busy = union_length(spans) / 1e9
        by_name = defaultdict(float)
        for a, b, name, _ in kernels:
            by_name[name] += (b - a) / 1e9
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]

        # a sweep over the host ranges' ends and the gaps' midpoints: each
        # gap goes to the innermost range open at its middle
        order = {n: i for i, n in enumerate(RANGES)}
        marks = []
        for name, a, b, _ in hosts:
            marks.append((a, 0, order[name], 0.0))
            marks.append((b, 2, order[name], 0.0))
        ivs = merged(spans)
        for (_, a), (b, _) in zip(ivs, ivs[1:]):
            marks.append((0.5 * (a + b), 1, -1, (b - a) / 1e9))
        marks.sort()
        open_ = [0] * len(RANGES)
        gaps = defaultdict(float)
        for _, kind, which, length in marks:
            if kind == 0:
                open_[which] += 1
            elif kind == 2:
                open_[which] -= 1
            else:
                inner = next((i for i, n in enumerate(open_) if n > 0), None)
                gaps["host (no phase open)" if inner is None else RANGES[inner]] += length
        top_gaps = sorted(gaps.items(), key=lambda kv: -kv[1])[:10]

        # the device seconds of kernels launched inside a marked K1 call
        marked = sorted((a, b, tid) for name, a, b, tid in hosts if name == "portbench.attention")
        starts = [a for a, _, _ in marked]
        attn = 0.0
        for a, b, _, corr in kernels:
            launch = launches.get(corr)
            if launch is None:
                continue
            i = bisect.bisect_right(starts, launch[0]) - 1
            if i >= 0 and marked[i][1] >= launch[0] and marked[i][2] == launch[1]:
                attn += (b - a) / 1e9
        return {"busy_s": busy, "window_s": self.wall_s, "kernels": len(kernels),
                "device_ops": [[n, v] for n, v in top], "idle_gaps": [[n, v] for n, v in top_gaps],
                "attention_device_s": attn}
