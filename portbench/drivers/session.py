"""Interactive play: players over ``serve.SessionServer``'s HTTP API on
localhost, served in this process, with the benchmark as their client.

Set-up starts the player's session (``POST /session``) and steps it
``warm_steps`` times, through its first chunk and one unit past the
boundary. In the window the player is closed loop with no think time:
the next action is sent when the previous step's frames have arrived.
Each step is timed at the client from sending its ``POST /step`` to
having read the whole reply. The window closes with the first reply at or
after its length.
"""

from __future__ import annotations

import base64
import http.client
import json
import time
from types import SimpleNamespace

import numpy as np
import torch

from .. import loadgen, system
from ..inputs import sentence, sub_seed
from ..recorder import Recorder

#: seconds a step may take before the client gives up on it
TIMEOUT = 300
#: the numbers the check can read from this traffic: every unit has
#: history rows once set-up has passed the first chunk
CHECKED = ("unit.3rows", "flow_flags", "decode", "encode", "history_index", "history")


def wire(x: np.ndarray) -> dict:
    """An array in the API's wire format (float16, base64)."""
    a = np.asarray(x, np.float16)
    return {"shape": list(a.shape), "dtype": "float16",
            "data": base64.b64encode(a.tobytes()).decode()}


def unwire(d: dict) -> np.ndarray:
    a = np.frombuffer(base64.b64decode(d["data"]), np.dtype(d["dtype"]))
    return a.reshape(d["shape"])


def post(port: int, path: str, obj) -> tuple:
    """(status, raw body) of one request."""
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=TIMEOUT)
    try:
        conn.request("POST", path, json.dumps(obj), {"Content-Type": "application/json"})
        r = conn.getresponse()
        return r.status, r.read()
    finally:
        conn.close()


def setup(cell, seed: int, device, traced: bool, warm: bool = True) -> SimpleNamespace:
    from deepv_tpu_torch.serve import InteractiveSession, SessionServer

    cfg, mix = cell.config, cell.mix
    if mix.get("players", 1) != 1:
        raise ValueError("the session driver serves one player")
    s = cfg["serving"]
    pipe, _ = system.build(cfg, seed, device)
    rec = Recorder(pipe, cfg, seed, traced)
    pipe.on_frames = rec.frames_delivered
    if traced:
        rec.time_session_steps(InteractiveSession)
    server = SessionServer(pipe, port=0, history_limit_chunks=mix["history_limit_chunks"])
    port = server.start()
    img, actions = loadgen.session(seed, s["height"], s["width"])
    status, body = post(port, "/session", {"image": wire(img), "seed": sub_seed(seed, "session"),
                                            "prompt_type": "action"})
    if status != 200:
        raise RuntimeError(f"POST /session answered {status}: {body[:500]!r}")
    sid = json.loads(body)["session_id"]
    for _ in range(mix["warm_steps"]):
        status, body = post(port, "/step", {"session_id": sid, "action": sentence(next(actions))})
        if status != 200:
            raise RuntimeError(f"a warm-up step answered {status}: {body[:500]!r}")
    system.synchronize(pipe.device)
    return SimpleNamespace(cell=cell, seed=seed, device=torch.device(device), pipe=pipe,
                           recorder=rec, server=server, port=port, sid=sid, actions=actions,
                           bodies=[])


def measure(st, seconds: float) -> SimpleNamespace:
    rec = st.recorder
    if st.device.type == "cuda":
        torch.cuda.synchronize(st.device)
        torch.cuda.reset_peak_memory_stats(st.device)
    # the steps a traced run profiles: the step that ends a chunk and one
    # on either side
    p = st.cell.config["pipeline"]
    first, last = loadgen.boundary_steps(st.cell.mix["warm_steps"], p["max_temporal_length"],
                                          p["num_input_unit"])
    steps, attempted, failed, sync = [], 0, 0, [0.0]
    rec.start()
    while True:
        action = sentence(next(st.actions))
        attempted += 1
        if rec.tracer is not None and len(steps) == first:
            rec.begin_slice()
        t0 = time.perf_counter()
        status, body = post(st.port, "/step", {"session_id": st.sid, "action": action})
        steps.append(time.perf_counter() - t0)
        sync.append(rec.sync_s)
        if rec.tracer is not None and len(steps) == last + 1:
            rec.end_slice()
            rec.slice["steps"] = (first, last + 1)
        st.bodies.append(body if status == 200 else None)
        if status != 200:
            failed += 1
        if rec.now() >= seconds:
            break
    window_s = rec.now()
    rec.active = False
    peak = torch.cuda.max_memory_allocated(st.device) if st.device.type == "cuda" else 0
    frames = sum(n for _, n in rec.deliveries)
    return SimpleNamespace(window_s=window_s, frames=frames, steps=steps, attempted=attempted,
                           failed=failed, peak_bytes=peak, request_s=steps,
                           request_sync=[b - a for a, b in zip(sync, sync[1:])])


def teardown(st) -> dict:
    """Close the session, stop the server, take the wrappers off and free
    the program's state. Returns the rgb frames the client received for
    the deliveries the check samples."""
    post(st.port, "/close", {"session_id": st.sid})
    st.server.stop()
    st.server = None
    st.recorder.close()
    st.pipe.on_frames = None
    st.pipe = None
    want = set()
    d = st.recorder.samples["decode"].item
    if d is not None:
        want.update(d.deliveries)
    client = {}
    for i in want:
        if 0 <= i < len(st.bodies) and st.bodies[i] is not None:
            rgb = unwire(json.loads(st.bodies[i])["rgb"])
            client[i] = torch.from_numpy(rgb.astype(np.float32))
    st.bodies = []
    return {"client_rgb": client}
