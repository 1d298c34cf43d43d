"""What a run records of the program's work inside its window, from
wrappers around the calls into its layers.

The pipeline's chunk prologue (``_open_chunk``), its unit step
(``_next_unit``: one unit denoised and, streaming, decoded), the history
retrieval at a chunk boundary (``_retrieve_history``: the frame chosen
and its encode), the VAE encode of one batch row (``_encode_row``, whose
posterior moments it keeps) and the ``on_frames`` hook are wrapped on the
pipeline instance. Each wrapper hands the program a noise source that
passes every draw on and keeps it, and counts the work it saw in model
operations (``counting.py``). Seeded reservoirs keep one sample of each
kind of work for the check after the window (``check.py``): a 2-row unit
and a 3-row unit (history rows) whose guidance rows differ, the first
two decoded windows of a chunk, a rollout's image encode, a boundary's
conditioning encode (their posterior moments) and a history retrieval
(the candidate frames and poses it chose from, on the host, the frame
chosen and its moments).

In a traced run (``--trace 1``) the pipeline's phase timer is swapped for
one that waits for the card and marks each phase for the profiler, every
K1 call (``models.mmdit.attention``) is marked and its allowed pairs are
counted, and the profiler (``trace.Tracer``) records a slice of units
around a chunk boundary. Inside the slice the phases are marked but
neither timed nor waited for, so the profile sees the pipeline as it runs
untraced; the slice's seconds (the profiler's stop with them), work and
frames are kept apart (``slice``) and left out of the spans and rates.
"""

from __future__ import annotations

import contextlib
import random
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import torch

from . import counting
from .inputs import NEGATIVE, sub_seed, text_tokens


class StopWindow(Exception):
    """Raised after the unit whose frames closed the window."""


class RecordingNoise:
    """Passes every draw of the wrapped noise source on and keeps it."""

    def __init__(self, inner):
        self.inner = inner
        self.draws: List[Tuple[str, torch.Tensor]] = []

    def normal(self, kind, shape, dtype):
        x = self.inner.normal(kind, shape, dtype)
        self.draws.append((kind, x))
        return x

    def uniform(self, kind, shape, low, high, dtype=torch.float32):
        return self.inner.uniform(kind, shape, low, high, dtype)

    def of(self, kind: str) -> List[torch.Tensor]:
        return [x for k, x in self.draws if k == kind]


class Reservoir:
    """One item kept of a stream, each with the same chance, by a seeded
    generator of its own."""

    def __init__(self, seed: int):
        self.rng = random.Random(seed)
        self.seen = 0
        self.item = None

    def offer(self) -> bool:
        """Whether the next item replaces the kept one."""
        self.seen += 1
        return self.rng.random() * self.seen < 1.0


@dataclass
class ChunkRecord:
    first: bool                   # the rollout's first chunk (starts from the image)
    draw: torch.Tensor            # the chunk's noise latents, as drawn
    conditioning: torch.Tensor    # the conditioning latents (generated[0])
    windows: list = field(default_factory=list)   # (unit latent, rgb, disparity, delivery)
    offered: bool = False         # its first two windows went to the decode sample


@dataclass
class UnitRecord:
    chunk: ChunkRecord
    unit: int
    rows: int
    generated: List[torch.Tensor]
    history: Optional[torch.Tensor]
    prompt: str
    guidance: float
    block_z: List[torch.Tensor]
    out: torch.Tensor
    ran: tuple


@dataclass
class DecodeRecord:
    first: bool
    conditioning: torch.Tensor
    units: List[torch.Tensor]
    frames: List[Tuple[torch.Tensor, torch.Tensor]]
    deliveries: List[int]


@dataclass
class EncodeRecord:
    image: torch.Tensor               # the rgb pixels encoded
    disparity: Optional[torch.Tensor]  # None for a rollout's image
    moments: torch.Tensor             # the encoder's mean and log-variance, a row each


@dataclass
class HistoryRecord:
    frames: torch.Tensor      # [1, 3, n, H, W]: every 8th frame of the rollout so far (host)
    disparity: torch.Tensor   # the same frames' post-mapped disparity (host)
    poses: torch.Tensor       # [n, 4, 4]: the rollout's camera-to-world poses (host)
    scale_frame: torch.Tensor  # the disparity frame the carry's scale is taken from (host)
    n_unit: int
    index: int                # the frame the program retrieved
    moments: torch.Tensor     # the encoder's moments of its rgb and disparity


def every_nth(chunks: List[torch.Tensor], n: int) -> torch.Tensor:
    """Frames 0, n, 2n, ... of the frames of ``chunks`` laid end to end
    along axis 2, copied to the host (without joining them on the card)."""
    out, offset = [], 0
    for x in chunks:
        out.append(x[:, :, (-offset) % n::n].to("cpu"))
        offset += x.shape[2]
    return torch.cat(out, dim=2)


class TracedTimer:
    """A phase timer that waits for the card at each phase's end and marks
    the phase for the profiler; ``stats()`` as the program's timer."""

    def __init__(self, base_cls, device):
        self.inner = base_cls(sync=True, device=device)
        #: False inside the profiled slice: phases are only marked there
        self.timing = True

    @contextlib.contextmanager
    def phase(self, name, sync_value=None):
        from torch.profiler import record_function
        with record_function(name):
            if self.timing:
                with self.inner.phase(name, sync_value):
                    yield
            else:
                yield

    def __getattr__(self, name):
        return getattr(self.inner, name)


class Recorder:
    """The wrappers on ``pipe`` and what they record while ``active``."""

    HOOKS = ("_open_chunk", "_next_unit", "_retrieve_history", "_encode_row")

    def __init__(self, pipe, config: Dict, seed: int, traced: bool = False):
        self.pipe = pipe
        self.config = config
        self.device = pipe.device
        self.traced = traced
        self.active = False
        self.stop_after = None           # seconds: close the window after the unit past it
        self.stopping = False
        self.t0 = None
        self.deliveries: List[Tuple[float, int]] = []   # (seconds into the window, frames)
        #: seconds the deliveries waited for the card
        self.sync_s = 0.0
        self.window_end = None
        self.units_done = 0
        #: the work the window saw, counted in model operations after it
        #: closes (``ops``): ("unit", args of counting.unit_ops) or
        #: ("vae", args of counting.vae_ops) with a multiplicity
        self.work: List[tuple] = []
        self.current: Optional[Tuple[int, ChunkRecord]] = None
        names = ("unit2", "unit3", "decode", "encode.image", "encode", "history")
        self.samples = {n: Reservoir(sub_seed(seed, "sample:" + n)) for n in names}
        self.tracer = None
        self.trace_units: Optional[Tuple[int, int]] = None
        #: the profiled slice: its start and length in window seconds, and
        #: the indices into ``work`` and ``deliveries`` it spans
        self.slice: Optional[Dict] = None
        self.attn_calls: list = []
        self.session_steps: List[float] = []
        self.moments: List[torch.Tensor] = []   # of the encode in progress, a row each
        #: the image [1, 3, 1, H, W] of the rollout the driver sends next
        self.request_image: Optional[torch.Tensor] = None
        s = config["serving"]
        self.ds = config["pipeline"]["vae_downsample"]
        self.lat_hw = (s["height"] // self.ds, s["width"] // self.ds)
        self.z = config["vae"]["encoder_out_channels"]
        self.vkey = counting.vae_key(config["vae"])
        self._orig = {name: getattr(pipe, name) for name in self.HOOKS}
        for name in self.HOOKS:
            setattr(pipe, name, getattr(self, "_" + name.lstrip("_")))
        self._patched = []
        if traced:
            self._install_trace()

    # -- lifecycle ------------------------------------------------------------

    def start(self) -> None:
        """Open the window: from here work is recorded and timed."""
        self.t0 = time.perf_counter()
        self.active = True

    def now(self) -> float:
        return time.perf_counter() - self.t0

    def close(self) -> None:
        """Stop recording, keep the phase totals, take the wrappers off and
        let go of the pipeline."""
        self.active = False
        if self.tracer is not None and self.tracer.running:
            self.end_slice()
        self.phases = self.pipe.timer.stats() if self.traced else None
        for name in self.HOOKS:
            self.pipe.__dict__.pop(name, None)
        for obj, name, value in reversed(self._patched):
            setattr(obj, name, value)
        self._patched = []
        self.pipe = None

    # -- the hooks --------------------------------------------------------------

    def frames_delivered(self, rgb, disparity) -> None:
        """The ``on_frames`` hook: wait for the window's pixels, then time
        their delivery."""
        if not self.active:
            return
        t = self.now()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.sync_s += self.now() - t
        t = self.now()
        self.deliveries.append((t, int(rgb.shape[2])))
        if self.stop_after is not None and t >= self.stop_after:
            self.stopping = True

    def _encode_row(self, x, chunked):
        moments = self._orig["_encode_row"](x, chunked)
        self.moments.append(moments)
        return moments

    def _open_chunk(self, noise, *args, **kwargs):
        proxy = RecordingNoise(noise)
        self.moments = []
        ch = self._orig["_open_chunk"](proxy, *args, **kwargs)
        if not self.active:
            return ch
        image, disparity = args[0], args[1]
        rec = ChunkRecord(first=bool(ch.firstframe_mask), draw=proxy.of("latents")[0],
                          conditioning=ch.generated[0])
        self.current = (id(ch), rec)
        rows = 1 if disparity is None else 2
        self.work.append(("vae", rows, ("encode", tuple(image[:1].shape))))
        if not rec.first and ch.stream and not ch.full_window:
            shape = (1, self.z) + tuple(ch.generated[0].shape[2:])
            self.work.append(("vae", 2, ("prime", shape)))
        pool = self.samples["encode.image" if rec.first else "encode"]
        if pool.offer():
            # a rollout's image as the benchmark drew it, not as the program cast it
            pool.item = EncodeRecord(self.request_image if rec.first else image, disparity,
                                     torch.cat(self.moments))
        return ch

    def _next_unit(self, noise, ch, prompt, guidance):
        if not self.active:
            return self._orig["_next_unit"](noise, ch, prompt, guidance)
        k = self.units_done
        if self.tracer is not None and self.trace_units and k == self.trace_units[0]:
            self.begin_slice()
        rec = self.current[1] if self.current and self.current[0] == id(ch) else None
        unit, rows, first = ch.unit_index, ch.num_rows, bool(ch.firstframe_mask)
        before, history = list(ch.generated), ch.input_history
        n_windows = len(ch.rgb_frames)
        proxy = RecordingNoise(noise)
        ran = self._orig["_next_unit"](proxy, ch, prompt, guidance)
        out = ch.generated[-1]
        self.units_done += 1

        n = self.config["serving"]["text_len"]
        toks = (text_tokens(NEGATIVE, n),) + (text_tokens(prompt, n),) * (rows - 1)
        self.work.append(("unit", 1, (unit, first, rows, toks, tuple(tuple(r) for r in ran))))
        if len(ch.rgb_frames) > n_windows:
            mode = "init" if first and unit == 1 else "cont"
            self.work.append(("vae", 2, ("decode", (1, self.z, 1) + self.lat_hw, mode)))
        if rec is not None:
            pool = self.samples[f"unit{rows}"]
            # a unit prompted with the negative prompt (a first chunk's
            # first) guides between two equal rows: its guidance reads
            # nothing, so it is not sampled
            if prompt != NEGATIVE and pool.offer():
                pool.item = UnitRecord(rec, unit, rows, before, history, prompt, float(guidance),
                                       proxy.of("block"), out, tuple(tuple(r) for r in ran))
            if len(ch.rgb_frames) > n_windows and not rec.offered:
                rec.windows.append((out, ch.rgb_frames[-1], ch.disp_frames[-1],
                                    len(self.deliveries) - 1))
                if len(rec.windows) == 2:
                    pool = self.samples["decode"]
                    if pool.offer():
                        pool.item = DecodeRecord(rec.first, rec.conditioning,
                                                 [w[0] for w in rec.windows],
                                                 [(w[1], w[2]) for w in rec.windows],
                                                 [w[3] for w in rec.windows])
                    rec.windows, rec.offered = [], True
        if self.tracer is not None and self.trace_units and k == self.trace_units[1]:
            self.end_slice()
        if self.stopping:
            raise StopWindow
        return ran

    def _retrieve_history(self, noise, images_list, disparity_list, trans3d_list,
                          trans2d_list, scale_factor, n_unit):
        self.moments = []
        out, idx = self._orig["_retrieve_history"](noise, images_list, disparity_list,
                                                   trans3d_list, trans2d_list, scale_factor,
                                                   n_unit)
        if self.active:
            rgb = images_list[0]
            self.work.append(("vae", 2, ("encode", (1, rgb.shape[1], 1) + tuple(rgb.shape[3:]))))
            if self.samples["history"].offer():
                n_img = self.config["pipeline"]["num_input_image"]
                self.samples["history"].item = HistoryRecord(
                    frames=every_nth(images_list, self.ds), disparity=every_nth(disparity_list, self.ds),
                    poses=torch.cat(trans3d_list, dim=1)[0].to("cpu"),
                    scale_frame=disparity_list[-1][:, :, -n_img].to("cpu"), n_unit=int(n_unit),
                    index=int(idx), moments=torch.cat(self.moments))
        return out, idx

    def ops(self) -> float:
        """The model operations of the work the window saw outside the
        profiled slice."""
        p = dict(self.config["pipeline"], text_len=self.config["serving"]["text_len"])
        t = self.config["transformer"]
        work = self.work
        if self.slice is not None:
            work = work[:self.slice["work"][0]] + work[self.slice["work"][1]:]
        total = 0.0
        for kind, times, args in work:
            if kind == "unit":
                total += times * counting.unit_ops(p, t, self.lat_hw, *args)[0]
            else:
                total += times * counting.vae_ops(self.vkey, *args)
        return total

    # -- traced runs ----------------------------------------------------------------

    def begin_slice(self) -> None:
        """Start the profiler; phases are marked, not timed, until
        ``end_slice``."""
        self.slice = {"t": self.now(), "work": [len(self.work)],
                      "deliveries": [len(self.deliveries)]}
        self.pipe.timer.timing = False
        self.tracer.start()

    def end_slice(self) -> None:
        """Stop the profiler and note what the slice spanned; its seconds
        end once the profiler has stopped."""
        self.tracer.stop()
        self.pipe.timer.timing = True
        sl = self.slice
        sl["seconds"] = self.now() - sl["t"]
        sl["work"].append(len(self.work))
        sl["deliveries"].append(len(self.deliveries))

    def slice_frames(self) -> int:
        """Frames delivered inside the profiled slice."""
        if self.slice is None:
            return 0
        a, b = self.slice["deliveries"]
        return sum(n for _, n in self.deliveries[a:b])

    def _patch(self, obj, name, value) -> None:
        self._patched.append((obj, name, obj.__dict__[name]))
        setattr(obj, name, value)

    def _install_trace(self) -> None:
        import deepv_tpu_torch.models.mmdit as mm
        from deepv_tpu_torch.utils.profiling import PhaseTimer
        from torch.profiler import record_function

        from .trace import Tracer

        self.pipe.timer = TracedTimer(PhaseTimer, self.device)
        self.tracer = Tracer(self.device)
        orig = mm.attention
        memo = {}

        def attention(q, k, v, valid, times, n_last=0):
            if not self.tracer.running:
                return orig(q, k, v, valid, times, n_last=n_last)
            key = (id(valid), id(times))
            if memo.get("key") != key:
                allowed = (valid[:, :, None] == valid[:, None, :]) & (times[:, None] >= times[None, :])[None]
                memo.update(key=key, pairs=allowed.sum())
            self.attn_calls.append(tuple(q.shape) + (q.element_size(), memo["pairs"]))
            with record_function("portbench.attention"):
                return orig(q, k, v, valid, times, n_last=n_last)

        self._patch(mm, "attention", attention)

    def time_session_steps(self, session_cls) -> None:
        """Time ``session_cls.step`` (each call waits for the card at its
        end): the session's share of a served step."""
        orig = session_cls.step
        rec = self

        def step(sess, action):
            t0 = time.perf_counter()
            out = orig(sess, action)
            if rec.device.type == "cuda":
                torch.cuda.synchronize(rec.device)
            if rec.active:
                rec.session_steps.append(time.perf_counter() - t0)
            return out

        self._patch(session_cls, "step", step)

