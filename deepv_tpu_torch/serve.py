"""Interactive world-model serving.

Counterpart of ``deepv_tpu/serve.py``. A deployed world model holds state,
accepts one action at a time and returns the newly generated frames at
once, where the batch CLI renders a whole action string first:

  - ``InteractiveSession``: the chunked autoregressive rollout of
    ``InferencePipeline.generate`` suspended between latent units,
    ``start(image)`` then ``step(action) -> frames``. Each step denoises
    ONE unit and streams it through the carried causal VAE decoder caches,
    so a step's pixels arrive after one unit's work rather than a whole
    chunk's. Chunk boundaries (the 25-frame overlap carry, the uint8 round
    trip, pose chaining, history retrieval) are handled inside ``step``.
  - ``SessionServer``: a stdlib HTTP server exposing sessions over JSON,
    with a /metrics endpoint.
  - ``prewarm`` and ``cli`` (``python -m deepv_tpu_torch.serve``);
    ``--aot_cache DIR`` keeps the compiled kernel libraries in DIR
    (``utils/aot.py``), and ``prewarm`` logs the cache's statistics.

Over a mesh (a pipeline built with ``mesh=``, one process per rank): an
``InteractiveSession`` on each rank, stepped in lockstep, runs the
tensor-parallel denoise and the context-parallel VAE. ``SessionServer``
runs on rank 0 only; every other rank runs ``follow``. Rank 0 sends the
followers every operation that touches the device, in the order it runs
them under its device lock (``start`` with the session id it drew,
``step``, ``close`` and TTL eviction, ``prewarm``, ``stop``), over a gloo
group of all ranks (NCCL carries only CUDA tensors); after each one the
ranks exchange whether it raised. An operation that raises the same way on
every rank (an unknown action) answers 500 and leaves every rank serving;
one that raised on a follower only answers 500 naming the rank.
``SessionServer.stop()`` ends the followers. deepv_tpu serves one program
over its mesh, which needs none of this (``deepv_tpu/serve.py``).

Exactness: a session stepping through the unit sequence produces the same
frames as ``generate`` on the equivalent prompt list and seed: it runs the
pipeline's own chunk prologue, unit and epilogue, making the same draws
from one noise source in the same order, paused between units
(tests/test_torch_port_serve.py pins this).

Threads: HTTP handlers run each request in a thread of its own, where
inference mode is off and the current CUDA device is device 0. Every public
session method therefore enters ``torch.inference_mode()`` and, on a CUDA
pipeline, ``torch.cuda.device`` of the pipeline's card itself: the kernels
launch on the calling thread's current device.
"""

from __future__ import annotations

import base64
import contextlib
import json
import threading
import time
import traceback
import uuid
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from .pipeline import InferencePipeline, TorchNoise, _disparity_postmap
from .utils import aot
from .utils.profiling import synchronize


class InteractiveSession:
    """One world-model rollout, advanced one latent unit per ``step``.

    Prompt semantics: every ``step(action)`` drives exactly one unit with
    that action's embedding. (``generate`` instead indexes a padded prompt
    list in which chunk-boundary entries are skipped; use
    ``actions_from_prompt_list`` to convert.)

    The rollout is ``generate``'s: the session holds its state between
    chunks (``rollout``) and within one (``chunk``), and runs the pipeline's
    own chunk prologue, unit and epilogue, pausing after each unit.
    """

    def __init__(self, pipe: InferencePipeline, guidance_scale: float = 4.0,
                 video_guidance_scale: float = 3.5, reuse_decoder_cache: bool = False,
                 history_limit_chunks: Optional[int] = None):
        self.pipe = pipe
        #: deepv_tpu's session parameters with its defaults, which are
        #: ``generate``'s: each unit is guided by ``video_guidance_scale``
        #: (so a default session equals ``generate``); ``guidance_scale`` is
        #: kept as deepv_tpu keeps it, unread by the unit
        self.guidance_scale = guidance_scale
        self.video_guidance_scale = video_guidance_scale
        #: keep only the last N completed chunks of rollout state. Retrieval
        #: by camera pose searches the whole rollout otherwise: fine for a
        #: batch render, unbounded for a long-lived session (~tens of MB of
        #: frames per chunk). With a limit, retrieval searches the last N
        #: chunks and ``result()`` returns only that window; per-step outputs
        #: are unaffected. None (default) keeps everything, as ``generate``.
        assert history_limit_chunks is None or history_limit_chunks >= 1, \
            "history_limit_chunks must be None or >= 1"
        self.history_limit_chunks = history_limit_chunks
        #: carry the streaming VAE-decoder caches across chunk boundaries
        #: instead of priming fresh caches from the re-encoded overlap (what
        #: ``generate`` does). Removes the boundary's cache rebuild.
        #: Deliberate fidelity deviation, OFF by default: chunk >= 2 pixels
        #: decode through the previous chunk's cache state rather than the
        #: re-encoded overlap's, and since carried pixels feed the next
        #: chunk's conditioning, the rollout drifts from the second boundary.
        self.reuse_decoder_cache = reuse_decoder_cache
        self.started = False
        self.frames_out = 0
        self.steps_done = 0
        #: the last step's per-stage recompute flags (the pipeline's
        #: ``recompute_log`` holds ``generate``'s only)
        self.recompute_log: List[tuple] = []
        # the card the pipeline's tensors live on (an explicit index even
        # when the pipeline was built with device="cuda")
        self._device = pipe.raymap_mean.device

    # -- prompt-list compatibility -------------------------------------------

    @staticmethod
    def actions_from_prompt_list(cfg, prompts: List[str]) -> List[str]:
        """The per-unit action sequence that ``generate(prompts)`` executes.

        The rollout's unit k consumes padded prompt k-1 exactly (chunk 1
        units 1..T drive prompts[0..T-1]; chunk c >= 2 units n..T-1 drive
        the next T-1-n prompts), so this is ``generate``'s padding rule
        applied to the list."""
        T, n = cfg.max_temporal_length, cfg.num_input_unit
        padded = list(prompts)
        while (len(padded) - T) % (T - n) != 0 or len(padded) < T:
            padded.append(padded[-1])
        return padded

    def _scope(self) -> contextlib.ExitStack:
        """Inference mode and the pipeline's card as the current device:
        both are per thread, and a server calls from many threads."""
        stack = contextlib.ExitStack()
        stack.enter_context(torch.inference_mode())
        if self._device.type == "cuda":
            stack.enter_context(torch.cuda.device(self._device))
        return stack

    # -- lifecycle ------------------------------------------------------------

    def start(self, img, seed: int = 666, prompt_type: str = "action", noise=None) -> None:
        """Begin a rollout from one conditioning image [3, H, W] or
        [1, 3, H, W] in [-1, 1]; ``generate``'s prologue. ``noise`` replaces
        the default ``TorchNoise(seed, device)``."""
        with self._scope():
            self.use_motion = prompt_type == "action"
            self.noise = noise if noise is not None else TorchNoise(seed, self._device)
            self.rollout = self.pipe._new_rollout(img)
            self.started = True
            self.frames_out = 0
            self.steps_done = 0
            self._begin_chunk()

    def _begin_chunk(self) -> None:
        """The next chunk's prologue from the rollout's carry: its latents,
        the conditioning encode and the streaming decoder's start."""
        r = self.rollout
        dec_state, r.dec_state = r.dec_state, None
        self.chunk = self.pipe._open_chunk(
            self.noise, r.input_image, r.input_disparity, r.input_raymap, r.input_history,
            dec_state=dec_state, carry_rgb_latent=r.carry_lat, stream=True)
        self.chunk_prompts: List[str] = []

    def step(self, action: str) -> Dict:
        """Denoise one unit with ``action`` and return its decoded frames.

        Returns {"rgb": [1, 3, f, H, W] in [-1, 1], "disparity": [1, 3, f,
        H, W] post-mapped as ``generate`` maps it, "chunk_complete": bool,
        "frames_total": int}. Handles the chunk boundary internally.
        """
        assert self.started, "call start() first"
        with self._scope():
            p = self.pipe
            prompt = action if self.use_motion else str(action)
            self.chunk_prompts.append(prompt)
            # no local binding of the chunk: at a boundary _finish_chunk
            # must be able to release it
            self.recompute_log = p._next_unit(self.noise, self.chunk, prompt,
                                              self.video_guidance_scale)
            yi, yd = self.chunk.rgb_frames[-1], self.chunk.disp_frames[-1]

            # per-unit disparity post-map: scale_factor is constant within a
            # chunk, so this equals the end-of-chunk map. no_need_depth zeroes
            # the raw frames first, as the rollout does (zeros post-map to the
            # 0.25/0.95 constant), keeping the step stream equal to result()
            raw = torch.zeros_like(yd) if p.cfg.no_need_depth else yd
            disp = _disparity_postmap(raw, self.rollout.scale_factor)

            self.steps_done += 1
            chunk_complete = self.chunk.unit_index >= self.chunk.num_units
            if chunk_complete:
                self._finish_chunk()
            self.frames_out += int(yi.shape[2])
            return {"rgb": yi, "disparity": disp, "chunk_complete": chunk_complete,
                    "frames_total": self.frames_out}

    def _finish_chunk(self) -> None:
        """The chunk's epilogue and ``generate``'s bookkeeping (poses,
        post-map, the overlap carry, history retrieval), then the next
        chunk."""
        p, cfg, r = self.pipe, self.pipe.cfg, self.rollout
        chunk_out = p._end_chunk(self.chunk, keep_caches=self.reuse_decoder_cache)
        # release the finished chunk's decoder caches and frames before the
        # carry's encodes and the next chunk's priming, as generate_i2v does
        # by returning
        self.chunk = None
        # _accumulate_chunk slices off the overlap units' prompts for chunks
        # after the first; the session's list holds only consumed actions, so
        # pad it back to generate()'s full motion-prompt layout
        motion = list(self.chunk_prompts)
        if r.now_iter > 0:
            motion = [""] * cfg.num_input_unit + motion
        p._carry_chunk(self.noise, r, chunk_out, motion)
        del chunk_out
        if (self.history_limit_chunks is not None
                and len(r.images_list) > self.history_limit_chunks):
            # pose chaining and the overlap carry only read the LAST chunk's
            # entries; truncation narrows the retrieval window. It must also
            # keep _retrieve_history's ::ds frame-to-pose pairing: the first
            # chunk holds 57 = 1 (mod 8) frames, so every stride-8 pick lands
            # on a unit's final frame; after dropping whole chunks (32 = 0
            # mod 8 each), trim the new head chunk's leading ds-1 frames to
            # restore that phase.
            keep, ds = self.history_limit_chunks, cfg.vae_downsample
            for lst in (r.images_list, r.disparity_list, r.motion_prompt_list,
                        r.trans3d_list, r.trans2d_list):
                del lst[:-keep]
            if r.images_list[0].shape[2] % ds != 1:
                r.images_list[0] = r.images_list[0][:, :, ds - 1:]
                r.disparity_list[0] = r.disparity_list[0][:, :, ds - 1:]
        self._begin_chunk()

    # -- whole-rollout views --------------------------------------------------

    def result(self) -> Dict:
        """Rollout so far in ``generate``'s output format (completed chunks)."""
        assert self.rollout.images_list, "no completed chunks yet"
        with self._scope():
            return self.rollout.output()


# ---------------------------------------------------------------------------
# HTTP serving (stdlib only)
# ---------------------------------------------------------------------------

def _np_b64(x) -> Dict:
    """The wire format: float16 values, base64, with shape and dtype. A
    bfloat16 tensor goes through float32 (exact), so each value is rounded
    to float16 once, as from any other float type."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        x = (x.float() if x.dtype == torch.bfloat16 else x).numpy()
    a = np.asarray(x, np.float16)
    return {"shape": list(a.shape), "dtype": "float16",
            "data": base64.b64encode(a.tobytes()).decode()}


def _b64_np(d) -> np.ndarray:
    a = np.frombuffer(base64.b64decode(d["data"]), np.dtype(d["dtype"]))
    return a.reshape(d["shape"]).astype(np.float32)


class _Lockstep:
    """The control channel of a mesh pipeline's ranks: rank 0 sends each
    operation to the others, and after it every rank reports whether it
    raised. A gloo group of all ranks carries both (the default group when
    it is gloo); every rank creates it once, as ``SessionServer`` (rank 0)
    and ``follow`` (the others) do."""

    def __init__(self):
        self.group = (dist.group.WORLD if dist.get_backend() == "gloo"
                      else dist.new_group(backend="gloo"))

    def send(self, msg) -> None:
        dist.broadcast_object_list([msg], src=0, group=self.group)

    def receive(self):
        box = [None]
        dist.broadcast_object_list(box, src=0, group=self.group)
        return box[0]

    def status(self, error: Optional[str]) -> List[Optional[str]]:
        """Every rank's error (None where the operation ran), in rank order."""
        out = [None] * dist.get_world_size(self.group)
        dist.all_gather_object(out, error, group=self.group)
        return out


def _error_text(e: BaseException) -> str:
    return f"{type(e).__name__}: {e}"


def follow(pipe: InferencePipeline) -> List[tuple]:
    """The loop of a mesh rank other than 0 while rank 0 serves: run each
    operation rank 0 sends, on this rank's own sessions, until ``stop``.
    Returns what it ran: ``(operation, session id(s), ok)`` in order."""
    if pipe.mesh is None or pipe.mesh.rank == 0:
        raise ValueError("follow runs on the ranks of a mesh pipeline other than 0; rank 0 "
                         "runs SessionServer")
    channel = _Lockstep()
    sessions: Dict[str, InteractiveSession] = {}
    ran: List[tuple] = []
    while True:
        msg = channel.receive()
        op, error = msg[0], None
        try:
            if op == "start":
                _, sid, img, seed, prompt_type, options = msg
                sessions[sid] = InteractiveSession(pipe, **options)
                try:
                    sessions[sid].start(img, seed=seed, prompt_type=prompt_type)
                except Exception:
                    del sessions[sid]
                    raise
            elif op == "step":
                sessions[msg[1]].step(msg[2])
            elif op == "close":
                for sid in msg[1]:
                    sessions.pop(sid, None)
            elif op == "prewarm":
                prewarm(pipe, **msg[1])
            elif op != "stop":
                raise ValueError(f"unknown operation {op!r}")
        except Exception as e:   # reported to rank 0; this rank keeps serving
            traceback.print_exc()
            error = _error_text(e)
        ran.append((op, msg[1] if len(msg) > 1 else None, error is None))
        channel.status(error)
        if op == "stop":
            return ran


class SessionServer:
    """Minimal JSON-over-HTTP server around ``InteractiveSession``s.

    Endpoints:
      POST /session {"image": npb64, "seed": int, "prompt_type": str}
                      -> {"session_id": ...} (409 when max_sessions held)
      POST /step    {"session_id": ..., "action": str}
                      -> {"rgb": npb64, "disparity": npb64,
                          "chunk_complete": bool, "frames_total": int}
      POST /close   {"session_id": ...} -> {"closed": true}
      GET  /metrics -> {"sessions": n, "frames_out": n, "steps": n,
                        "streams": n, "stream_sessions": [n, ...], ...}

    ``pipe`` may be ONE pipeline or a LIST of pipelines, one per card
    (multi-stream serving): request throughput scales by running one
    independent stream per card (``run.load_pipeline(..., device=
    f"cuda:{i}")``). Sessions are assigned to the least-loaded stream at
    creation and pinned there.

    One device lock PER STREAM serialises that card's work; steps on
    different streams run concurrently. HTTP threads only queue requests.
    The sessions *registry* has its own fast lock, never held across device
    work, so ``/metrics`` (and ``/close``) answer while a chunk-boundary step
    holds a card: metrics counters are monotonic ints mutated only by the
    one step holding that stream's device lock, so reading them without it
    is safe (worst case: one step stale). Served sessions keep a bounded
    rollout history (``history_limit_chunks``, default 4) so long-lived
    sessions cannot exhaust device memory; clients consume frames from /step
    responses. Sessions idle longer than ``session_ttl_s`` (default 15 min;
    None disables) are evicted lazily on the next request, releasing their
    device state; ``/metrics`` reports the eviction count. A failing step
    answers 500 with the error's summary and prints its traceback here.

    On a mesh pipeline the server runs on rank 0 and the other ranks in
    ``follow`` (module docstring): each device operation is sent to them
    under the device lock before rank 0 runs it. A close or an eviction is
    sent when the device lock is free, at once or right after the operation
    holding it, so ``/close`` and ``/metrics`` never wait for a step.
    """

    def __init__(self, pipe: InferencePipeline, host: str = "127.0.0.1", port: int = 0,
                 max_sessions: int = 4, history_limit_chunks: int = 4,
                 session_ttl_s: Optional[float] = 900.0, reuse_decoder_cache: bool = False):
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

        self.pipes: List[InferencePipeline] = (
            list(pipe) if isinstance(pipe, (list, tuple)) else [pipe])
        self.max_sessions = max_sessions
        self.history_limit_chunks = history_limit_chunks
        self.session_ttl_s = session_ttl_s
        #: sessions carry decoder caches across chunk boundaries (quality-
        #: gated; see InteractiveSession.reuse_decoder_cache)
        self.reuse_decoder_cache = reuse_decoder_cache
        self.sessions: Dict[str, InteractiveSession] = {}
        self._last_used: Dict[str, float] = {}
        self._stream_of: Dict[str, int] = {}    # session id -> stream index
        # one lock per stream: each serialises ITS card's work; streams on
        # distinct cards step concurrently
        self._device_locks = [threading.Lock() for _ in self.pipes]
        self._registry_lock = threading.Lock()  # sessions dict; never held
        #                                         across device work
        self.evicted_total = 0
        mesh = self.pipes[0].mesh
        if mesh is not None and (len(self.pipes) > 1 or mesh.rank != 0):
            raise ValueError("a mesh pipeline is served by one SessionServer on rank 0; the "
                             "other ranks run serve.follow")
        #: the control channel to the other ranks of a mesh pipeline
        self._lockstep = None if mesh is None else _Lockstep()
        self._pending_close: List[str] = []
        outer = self

        def forget(sid: str) -> bool:
            """Drop a session's registry entries (registry lock held); on a
            mesh, queue its close for the other ranks."""
            outer._last_used.pop(sid, None)
            outer._stream_of.pop(sid, None)
            known = outer.sessions.pop(sid, None) is not None
            if known and outer._lockstep is not None:
                outer._pending_close.append(sid)
            return known

        def per_stream() -> List[int]:
            """Sessions pinned to each stream (registry lock held)."""
            counts = [0] * len(outer.pipes)
            for i in outer._stream_of.values():
                counts[i] += 1
            return counts

        def evict_expired() -> None:
            """Drop sessions idle past the TTL (registry lock only: device
            memory is released when the tensors lose their last reference)."""
            if outer.session_ttl_s is None:
                return
            now = time.time()
            with outer._registry_lock:
                dead = [sid for sid, t in outer._last_used.items()
                        if now - t > outer.session_ttl_s]
                for sid in dead:
                    forget(sid)
                outer.evicted_total += len(dead)
            outer._send_closes()

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, fmt, *args):
                pass

            def _json(self, code: int, obj) -> None:
                body = json.dumps(obj).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                if self.path == "/metrics":
                    evict_expired()
                    # counters read WITHOUT any device lock: /metrics must
                    # answer during a running step
                    with outer._registry_lock:
                        sessions = list(outer.sessions.values())
                        counts = per_stream()
                    self._json(200, {
                        "sessions": len(sessions),
                        "frames_out": sum(s.frames_out for s in sessions),
                        "steps": sum(s.steps_done for s in sessions),
                        "evicted_total": outer.evicted_total,
                        "session_ttl_s": outer.session_ttl_s,
                        "streams": len(outer.pipes),
                        "stream_sessions": counts,
                    })
                else:
                    self._json(404, {"error": "unknown path"})

            def do_POST(self):
                try:
                    n = int(self.headers.get("Content-Length", 0))
                    req = json.loads(self.rfile.read(n) or b"{}")
                    evict_expired()
                    if self.path == "/session":
                        sid = uuid.uuid4().hex[:12]
                        with outer._registry_lock:
                            if len(outer.sessions) >= outer.max_sessions:
                                self._json(409, {
                                    "error": f"max_sessions={outer.max_sessions} "
                                             "held; POST /close one first"})
                                return
                            # pin the session to the least-loaded stream
                            counts = per_stream()
                            stream = counts.index(min(counts))
                            sess = InteractiveSession(
                                outer.pipes[stream],
                                reuse_decoder_cache=outer.reuse_decoder_cache,
                                history_limit_chunks=outer.history_limit_chunks)
                            # reserve the slot before the (slow) start so a
                            # concurrent /session cannot oversubscribe
                            outer.sessions[sid] = sess
                            outer._last_used[sid] = time.time()
                            outer._stream_of[sid] = stream
                        img, seed = _b64_np(req["image"]), int(req.get("seed", 666))
                        prompt_type = req.get("prompt_type", "action")
                        options = dict(reuse_decoder_cache=outer.reuse_decoder_cache,
                                       history_limit_chunks=outer.history_limit_chunks)
                        try:
                            with outer._device_locks[stream]:
                                outer._on_ranks(
                                    ("start", sid, img, seed, prompt_type, options),
                                    lambda: sess.start(img, seed=seed, prompt_type=prompt_type))
                        except Exception:
                            with outer._registry_lock:
                                forget(sid)
                            raise
                        finally:
                            outer._send_closes()
                        self._json(200, {"session_id": sid})
                    elif self.path == "/close":
                        with outer._registry_lock:
                            closed = forget(req.get("session_id", ""))
                        outer._send_closes()
                        self._json(200 if closed else 404, {"closed": closed})
                    elif self.path == "/step":
                        sid = req.get("session_id", "")
                        with outer._registry_lock:
                            sess = outer.sessions.get(sid)
                            stream = outer._stream_of.get(sid, 0)
                        if sess is None:
                            self._json(404, {"error": "unknown session"})
                            return
                        action = req["action"]
                        try:
                            with outer._device_locks[stream]:
                                # re-check: a /close racing the queue wait
                                # must not resurrect the session's device state
                                with outer._registry_lock:
                                    if outer.sessions.get(sid) is not sess:
                                        self._json(404, {"error": "session closed"})
                                        return
                                    outer._last_used[sid] = time.time()
                                out = outer._on_ranks(("step", sid, action),
                                                      lambda: sess.step(action))
                                rgb = _np_b64(out["rgb"])
                                disp = _np_b64(out["disparity"])
                        finally:
                            outer._send_closes()
                        with outer._registry_lock:
                            # a /close may have raced the step: refresh only
                            # a session that still exists, or a _last_used
                            # entry would outlive its session
                            if outer.sessions.get(sid) is sess:
                                outer._last_used[sid] = time.time()
                        self._json(200, {
                            "rgb": rgb, "disparity": disp,
                            "chunk_complete": bool(out["chunk_complete"]),
                            "frames_total": int(out["frames_total"])})
                    else:
                        self._json(404, {"error": "unknown path"})
                except Exception as e:   # surface errors to the client; keep
                    # the traceback server-side (the body carries the summary)
                    traceback.print_exc()
                    self._json(500, {"error": f"{type(e).__name__}: {e}"})

        self.httpd = ThreadingHTTPServer((host, port), Handler)
        self.port = self.httpd.server_address[1]
        self._thread: Optional[threading.Thread] = None

    def _on_ranks(self, msg, fn):
        """``fn()`` on this rank; on a mesh, ``msg`` sent to the other ranks
        first and their outcome gathered after (the device lock held).
        Raises what ``fn`` raised, or, where only another rank failed, a
        RuntimeError naming it."""
        if self._lockstep is None:
            return fn()
        self._lockstep.send(msg)
        try:
            out = fn()
        except Exception as e:
            self._lockstep.status(_error_text(e))
            raise
        failed = [(r, e) for r, e in enumerate(self._lockstep.status(None)) if e is not None]
        if failed:
            raise RuntimeError("; ".join(f"rank {r}: {e}" for r, e in failed))
        return out

    def _send_closes(self) -> None:
        """Send the queued closes to the other ranks of a mesh if the device
        lock is free; where an operation holds it, its holder calls this
        again once it has let go."""
        lock = self._device_locks[0]
        while self._pending_close and lock.acquire(blocking=False):
            try:
                with self._registry_lock:
                    sids, self._pending_close = self._pending_close, []
                if sids:
                    self._on_ranks(("close", sids), lambda: None)
            finally:
                lock.release()

    def prewarm(self, height: int = 384, width: int = 512, seed: int = 0, log=print) -> float:
        """``prewarm`` of the (first) pipeline, on every rank of a mesh."""
        kw = dict(height=height, width=width, reuse_decoder_cache=self.reuse_decoder_cache,
                  seed=seed)
        with self._device_locks[0]:
            return self._on_ranks(("prewarm", kw), lambda: prewarm(self.pipes[0], log=log, **kw))

    def start(self) -> int:
        self._thread = threading.Thread(target=self.httpd.serve_forever, daemon=True)
        self._thread.start()
        return self.port

    def stop(self) -> None:
        """Stop serving; on a mesh, the other ranks' ``follow`` returns."""
        self.httpd.shutdown()
        self.httpd.server_close()
        if self._thread:
            self._thread.join(timeout=5)
        if self._lockstep is not None:
            with self._device_locks[0]:
                with self._registry_lock:
                    sids, self._pending_close = self._pending_close, []
                if sids:
                    self._on_ranks(("close", sids), lambda: None)
                self._on_ranks(("stop",), lambda: None)
            self._lockstep = None


def prewarm(pipe: InferencePipeline, height: int = 384, width: int = 512,
            reuse_decoder_cache: bool = False, seed: int = 0, log=print) -> float:
    """Drive one throwaway session across a chunk boundary BEFORE the server
    accepts traffic, so the first client request does not pay the process's
    first-use costs: the nvcc build of the kernels (``utils/cuda_build``),
    cuDNN's first calls and the caching allocator's growth. Steps one unit
    past the boundary so the chunk >= 2 work (3-row CFG denoise, carry
    re-encode, cache priming or reuse) runs too. Returns the seconds."""
    t0 = time.time()
    cfg = pipe.cfg
    sess = InteractiveSession(pipe, reuse_decoder_cache=reuse_decoder_cache)
    img = np.random.default_rng(seed).uniform(-1.0, 1.0, (1, 3, height, width))
    sess.start(img.astype(np.float32), seed=seed)
    # units 1..T-1 fill chunk 1; one more crosses into chunk 2
    n_steps = cfg.max_temporal_length
    for _ in range(n_steps):
        sess.step("Move forward. The perspective hasn't changed.")
    synchronize(sess._device)
    dt = time.time() - t0
    log(f"[serve] prewarm: {n_steps} units (one chunk + boundary) ran in {dt:.1f}s")
    if aot.cache_dir() is not None:
        s = aot.stats()
        log(f"[serve] aot cache: {s['loaded']} kernel libraries loaded ({s['loaded_mb']} MB), "
            f"{s['compiled']} compiled with nvcc ({aot.cache_dir()})")
    return dt


def cli():
    """python -m deepv_tpu_torch.serve --model_path ./ckpts [--random_weights] [--port 8631] ...

    ``--model_path`` names a DeepVerse snapshot (``run.load_pipeline``);
    ``--random_weights`` draws seeded random weights instead."""
    import argparse

    from .config import create_model_config
    from .run import load_pipeline

    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--model_path", required=True)
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8631)
    p.add_argument("--no_need_depth", action="store_true")
    p.add_argument("--random_weights", action="store_true",
                   help="random-initialise the full model with a seeded torch generator "
                        "instead of loading the snapshot at --model_path")
    p.add_argument("--tp_shards", type=int, default=1,
                   help="serve one pipeline sharded over this many cards (TP denoise + "
                        "spatial-CP VAE), one rank per card over NCCL; rank 0 binds the "
                        "HTTP port; 1 = single device")
    p.add_argument("--streams", type=int, default=1,
                   help="run this many INDEPENDENT pipelines, one per card (multi-stream "
                        "serving: request throughput scales with cards; latency per "
                        "session does not). Mutually exclusive with --tp_shards")
    p.add_argument("--fast", action="store_true",
                   help="quality-gated fast preset: flow caching (skip_odd) + int8 VAE "
                        "conv + int8 MMDiT linears")
    p.add_argument("--carry_latents", action="store_true",
                   help="quality-gated boundary fast mode: carry generated rgb latents "
                        "across chunk boundaries instead of re-encoding the carry pixels")
    p.add_argument("--reuse_decoder_cache", action="store_true",
                   help="quality-gated boundary fast mode: sessions carry the streaming "
                        "decoder's conv caches across chunk boundaries instead of priming "
                        "them from the re-encoded overlap")
    p.add_argument("--flow_cache", default=None,
                   help="flow-caching mode: none | skip_odd | adaptive[:tau] (overrides "
                        "the --fast preset's choice)")
    p.add_argument("--no_prewarm", action="store_true",
                   help="skip the pre-bind warm-up session; the first client request then "
                        "pays the first-use costs (kernel builds, cuDNN, allocator)")
    p.add_argument("--aot_cache", default=None, metavar="DIR",
                   help="keep the compiled kernel libraries under DIR (utils/aot.py): the "
                        "first launch builds them there with nvcc as prewarm loads them; "
                        "later launches load them and need no CUDA toolkit. DIR must be "
                        "writable by trusted users only (loading a library runs its code)")
    p.add_argument("--height", type=int, default=384)
    p.add_argument("--width", type=int, default=512)
    args = p.parse_args()
    if args.aot_cache:
        aot.configure(args.aot_cache)

    model_cfg = create_model_config(args.model_path, no_need_depth=args.no_need_depth,
                                    use_motion_prompt=True)
    options = dict(random_weights=args.random_weights, fast=args.fast,
                   flow_cache=args.flow_cache, carry_latents=args.carry_latents)
    if args.streams > 1:
        if args.tp_shards > 1:
            raise SystemExit("--streams and --tp_shards are mutually exclusive (per-chip "
                             "pipelines vs one pipeline sharded across chips)")
        n_cards = torch.cuda.device_count()
        if args.streams > n_cards:
            raise SystemExit(f"--streams {args.streams} > {n_cards} visible devices")
        pipe = [load_pipeline(args.model_path, model_cfg, device=f"cuda:{i}", **options)
                for i in range(args.streams)]
    elif args.tp_shards > 1:
        from .parallel.launch import spawn
        cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if cards < args.tp_shards:
            raise RuntimeError(f"--tp_shards {args.tp_shards} serves one rank per card over "
                               f"NCCL and needs {args.tp_shards} cards; this machine has {cards}")
        spawn(_serve_rank, args.tp_shards, (args, model_cfg, options), backend="nccl")
        return
    else:
        pipe = load_pipeline(args.model_path, model_cfg, **options)
    if not args.no_prewarm:
        # warm BEFORE binding the port, so the first client request does not
        # pay the process's first-use costs (prewarm docstring)
        pipes = pipe if isinstance(pipe, list) else [pipe]
        for i, pp in enumerate(pipes):
            print(f"[serve] prewarming stream {i}/{len(pipes)} ...", flush=True)
            prewarm(pp, height=args.height, width=args.width,
                    reuse_decoder_cache=args.reuse_decoder_cache)
    _serve(args, SessionServer(pipe, host=args.host, port=args.port,
                               reuse_decoder_cache=args.reuse_decoder_cache))


def _serve_rank(args, model_cfg, options) -> None:
    """One rank of ``cli --tp_shards``, inside the process group: rank 0
    serves (prewarming every rank first), the others follow. Each rank
    configures ``--aot_cache`` itself: a spawned rank starts anew."""
    from .run import load_pipeline

    if args.aot_cache:
        aot.configure(args.aot_cache)
    pipe = load_pipeline(args.model_path, model_cfg, tp_shards=args.tp_shards, **options)
    if pipe.mesh.rank != 0:
        follow(pipe)
        return
    # the port is bound here and accepts once the warm-up has run
    server = SessionServer(pipe, host=args.host, port=args.port,
                           reuse_decoder_cache=args.reuse_decoder_cache)
    if not args.no_prewarm:
        print(f"[serve] prewarming the {args.tp_shards} ranks ...", flush=True)
        server.prewarm(height=args.height, width=args.width)
    _serve(args, server)


def _serve(args, server: SessionServer) -> None:
    """Accept requests until interrupted."""
    port = server.start()
    print(f"[serve] listening on http://{args.host}:{port} "
          f"(POST /session, POST /step, POST /close, GET /metrics)", flush=True)
    try:
        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        server.stop()


if __name__ == "__main__":
    cli()
