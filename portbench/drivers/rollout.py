"""Offline rollouts: ``InferencePipeline.generate`` called back to back,
closed loop, one request after the other, as ``run.py`` users run it.

The window opens before the first rollout and closes at the first frame
delivery (``on_frames``, the card's frames ready) at or after its length;
the rollout in flight then stops, and counts the frames it delivered.
"""

from __future__ import annotations

import traceback
from types import SimpleNamespace

import numpy as np
import torch

from .. import loadgen, system
from ..inputs import sub_seed
from ..recorder import Recorder, StopWindow

#: rollouts drawn before the window (more are drawn if the window needs them)
PREDRAWN = 12
#: the numbers the check reads in every window of this traffic (rollouts of
#: more than one chunk add those of a boundary)
CHECKED = ("unit.2rows", "flow_flags", "decode", "encode.image")


class SeededNoise:
    """The rollout's Gaussian draws, from the benchmark's own generator on
    the pipeline's device."""

    def __init__(self, seed: int, device):
        self.device = torch.device(device)
        self.g = torch.Generator(device=self.device)
        self.g.manual_seed(seed)

    def normal(self, kind, shape, dtype):
        return torch.randn(tuple(shape), generator=self.g, device=self.device, dtype=dtype)

    def uniform(self, kind, shape, low, high, dtype=torch.float32):
        u = torch.rand(tuple(shape), generator=self.g, device=self.device, dtype=dtype)
        return u * (high - low) + low


def setup(cell, seed: int, device, traced: bool, warm: bool = True) -> SimpleNamespace:
    cfg = cell.config
    s, p = cfg["serving"], cfg["pipeline"]
    pipe, _ = system.build(cfg, seed, device)
    rec = Recorder(pipe, cfg, seed, traced)
    pipe.on_frames = rec.frames_delivered
    units, carried = p["max_temporal_length"], p["num_input_unit"]
    gen = loadgen.rollouts(cell.mix, seed, s["height"], s["width"], units, carried)
    queue = [next(gen) for _ in range(PREDRAWN)]
    if warm:
        # every shape of the mix, once: a rollout of as many chunks as its
        # longest, up to 2 (a boundary and a chunk after it)
        chunks = min(2, max(r["chunks"] for r in queue))
        img = np.random.default_rng(sub_seed(seed, "warm")).uniform(
            -1.0, 1.0, (1, 3, s["height"], s["width"])).astype(np.float32)
        pipe.generate(_batch(img, "(FN)" * loadgen.actions_for(chunks, units, carried)),
                      noise=SeededNoise(sub_seed(seed, "warm"), device))
    return SimpleNamespace(cell=cell, seed=seed, device=torch.device(device), pipe=pipe,
                           recorder=rec, queue=queue, more=gen, units=units)


def _batch(img, actions: str) -> dict:
    from deepv_tpu_torch.actions import prepare_motion_prompts
    return {"img": img, "prompt": np.array(prepare_motion_prompts("action", actions)),
            "prompt_type": "action"}


def measure(st, seconds: float) -> SimpleNamespace:
    pipe, rec = st.pipe, st.recorder
    if st.device.type == "cuda":
        torch.cuda.synchronize(st.device)
        torch.cuda.reset_peak_memory_stats(st.device)
    if rec.traced:
        # the last unit of the first chunk, its boundary (the carry to the
        # next chunk or the next rollout) and the unit after it
        rec.trace_units = (st.units - 1, st.units)
    rec.stop_after = seconds
    attempted = failed = 0
    request_s, sync = [], [0.0]
    rec.start()
    i = 0
    while True:
        req = st.queue[i] if i < len(st.queue) else next(st.more)
        batch = _batch(req["image"], req["actions"])
        rec.request_image = torch.from_numpy(req["image"])[:, :, None]
        attempted += 1
        t0 = rec.now()
        try:
            pipe.generate(batch, noise=SeededNoise(sub_seed(st.seed, f"rollout:{i}"), st.device))
        except StopWindow:
            request_s.append(rec.now() - t0)
            sync.append(rec.sync_s)
            break
        except Exception:
            traceback.print_exc()
            failed += 1
            if rec.now() >= seconds:
                break
        request_s.append(rec.now() - t0)
        sync.append(rec.sync_s)
        i += 1
    rec.active = False
    peak = torch.cuda.max_memory_allocated(st.device) if st.device.type == "cuda" else 0
    frames = sum(n for _, n in rec.deliveries)
    window_s = rec.deliveries[-1][0] if rec.deliveries else rec.now()
    return SimpleNamespace(window_s=window_s, frames=frames, steps=[], attempted=attempted,
                           failed=failed, peak_bytes=peak, request_s=request_s,
                           request_sync=[b - a for a, b in zip(sync, sync[1:])])


def teardown(st) -> dict:
    """Take the wrappers off and free the program's state; returns what
    the check needs besides the samples."""
    st.recorder.close()
    st.pipe.on_frames = None
    st.pipe = None
    return {"client_rgb": None}
