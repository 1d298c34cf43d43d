"""Interactive serving in the port (``deepv_tpu_torch/serve.py``) on the CPU:
session == generate bit for bit, incremental delivery, the boundary modes,
the history limit, the HTTP server, multi-stream, TTL eviction, prewarm,
the CLI, the ``on_frames`` hook and the wire format.

The counterparts of tests/test_serve.py, at the tiny size of
tests/test_torch_port_pipeline.py (64x64, float32). Rollouts are shared
through module fixtures; every HTTP call takes a timeout.
"""

import http.client
import json
import subprocess
import sys
import threading
import time
import weakref
from pathlib import Path

import numpy as np
import pytest
import torch

from deepv_tpu_torch import serve
from deepv_tpu_torch.actions import action_vocabulary, prepare_motion_prompts
from deepv_tpu_torch.config import MMDiTConfig, PipelineConfig, VAEConfig
from deepv_tpu_torch.io.text_embeds import random_text_embeds
from deepv_tpu_torch.io.weights import random_params
from deepv_tpu_torch.pipeline import InferencePipeline, _disparity_postmap
from deepv_tpu_torch.serve import InteractiveSession, SessionServer, _b64_np, _np_b64

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
H = W = 64
PROMPT = "(FN)(FN)(FN)(FN)(FN)(FN)(FN)(fRL)(SR)(BL)(FN)"      # 11 -> 12 units, 2 chunks
FORWARD = "Move forward. The perspective hasn't changed."
#: the MMDiT of tests/test_torch_port_pipeline.py
MCFG = dict(sample_size=16, patch_size=2, in_channels=14, num_layers=2,
            attention_head_dim=8, num_attention_heads=4, caption_projection_dim=32,
            pooled_projection_dim=16, pos_embed_max_size=32, joint_attention_dim=24)
#: seconds an HTTP call may take: a tiny step is well under a second here,
#: a session start with its encode about as much
TIMEOUT = 120


def make_batch(prompt=PROMPT):
    # float16 values, so the image reaches a server's session unchanged
    img = np.random.default_rng(7).uniform(-1.0, 1.0, (1, 3, H, W)).astype(np.float16)
    img = img.astype(np.float32)
    return {"img": img, "prompt": np.array(prepare_motion_prompts("action", prompt)),
            "prompt_type": "action"}


def tiny_pipeline(params=None, **kwargs):
    cfg = PipelineConfig(no_need_depth=kwargs.pop("no_need_depth", False))
    if params is None:
        params = random_params(MMDiTConfig(**MCFG), VAEConfig.tiny(), dtype=torch.float32,
                               seed=0, device="cpu")
    embeds = random_text_embeds(0, action_vocabulary(), joint_dim=24, pooled_dim=16)
    return InferencePipeline(cfg, MMDiTConfig(**MCFG), VAEConfig.tiny(), params, embeds,
                             dtype=torch.float32, device="cpu", **kwargs)


def post(port, path, obj):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=TIMEOUT)
    try:
        conn.request("POST", path, json.dumps(obj), {"Content-Type": "application/json"})
        r = conn.getresponse()
        return r.status, json.loads(r.read())
    finally:
        conn.close()


def get(port, path):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=TIMEOUT)
    try:
        conn.request("GET", path)
        r = conn.getresponse()
        return r.status, json.loads(r.read())
    finally:
        conn.close()


@pytest.fixture(scope="module")
def params():
    return random_params(MMDiTConfig(**MCFG), VAEConfig.tiny(), dtype=torch.float32, seed=0,
                         device="cpu")


@pytest.fixture(scope="module")
def pipe(params):
    return tiny_pipeline(params)


@pytest.fixture(scope="module")
def rollout(pipe):
    """generate() on the 11-action prompt with the on_frames hook recording
    its windows, and a session stepped through the same units."""
    batch = make_batch()
    windows = []
    pipe.on_frames = lambda rgb, disp: windows.append((rgb, disp))
    try:
        ref = pipe.generate(batch, seed=21)
    finally:
        pipe.on_frames = None
    ref_log = list(pipe.recompute_log)
    actions = InteractiveSession.actions_from_prompt_list(pipe.cfg, list(batch["prompt"]))
    sess = InteractiveSession(pipe)
    # whether anything still holds the finished chunk when its carry begins
    ended, held = [], []
    end, carry = pipe._end_chunk, pipe._carry_chunk
    pipe._end_chunk = lambda ch, **k: (ended.append(weakref.ref(ch)), end(ch, **k))[1]
    pipe._carry_chunk = lambda *a, **k: (held.append(ended[-1]() is not None),
                                         carry(*a, **k))[1]
    try:
        sess.start(batch["img"], seed=21)
        steps = [sess.step(a) for a in actions]
    finally:
        del pipe._end_chunk, pipe._carry_chunk
    return dict(ref=ref, ref_log=ref_log, windows=windows, actions=actions, steps=steps,
                result=sess.result(), session=sess, log=list(pipe.recompute_log), held=held)


@pytest.fixture(scope="module")
def limited(pipe):
    """A session with history_limit_chunks=1 over 16 units (3 chunks): the
    rollout fixture's 12 actions, then 4 more. Records each step's output and
    the number of chunks it keeps after each step."""
    batch = make_batch(PROMPT + "(FN)" * 4)
    actions = InteractiveSession.actions_from_prompt_list(pipe.cfg, list(batch["prompt"]))
    assert len(actions) == 16
    sess = InteractiveSession(pipe, history_limit_chunks=1)
    sess.start(batch["img"], seed=21)
    steps, kept = [], []
    for a in actions:
        steps.append(sess.step(a))
        kept.append(len(sess.rollout.images_list))
    return dict(actions=actions, steps=steps, kept=kept, session=sess)


@pytest.fixture(scope="module")
def reuse_served(pipe, rollout):
    """A session of a SessionServer(reuse_decoder_cache=True) stepped over
    HTTP through the rollout fixture's units, with its result()."""
    server = SessionServer(pipe, port=0, reuse_decoder_cache=True)
    port = server.start()
    try:
        sid = post(port, "/session", {"image": _np_b64(make_batch()["img"]),
                                      "seed": 21})[1]["session_id"]
        steps = [post(port, "/step", {"session_id": sid, "action": a})
                 for a in rollout["actions"]]
        session = server.sessions[sid]
        return dict(steps=steps, session=session, result=session.result())
    finally:
        server.stop()


@pytest.fixture(scope="module")
def fast_modes(params):
    """generate() and a session on one pipeline with the fast modes a
    server can run: adaptive flow caching (a host decision at every step),
    carry_latents and the W8A8 denoise linears. Records the session's
    recompute decisions after each step."""
    fpipe = tiny_pipeline(params, flow_cache="adaptive:0.5", carry_latents=True,
                          denoise_int8=True)
    batch = make_batch()
    ref = fpipe.generate(batch, seed=41)
    ref_log = list(fpipe.recompute_log)
    sess = InteractiveSession(fpipe)
    sess.start(batch["img"], seed=41)
    steps, logs = [], []
    for a in InteractiveSession.actions_from_prompt_list(fpipe.cfg, list(batch["prompt"])):
        steps.append(sess.step(a))
        logs.append(sess.recompute_log)
    return dict(pipe=fpipe, ref=ref, ref_log=ref_log, steps=steps, logs=logs,
                result=sess.result())


def test_actions_from_prompt_list(pipe):
    cfg = pipe.cfg
    assert InteractiveSession.actions_from_prompt_list(cfg, list("abcdefgh")) == list("abcdefgh")
    a3 = InteractiveSession.actions_from_prompt_list(cfg, list("abc"))
    assert a3 == list("abc") + ["c"] * 5          # padded to one chunk
    a11 = InteractiveSession.actions_from_prompt_list(cfg, list("abcdefghijk"))
    assert a11 == list("abcdefghijk") + ["k"]     # padded to 2 chunks (12)


def test_session_matches_generate(rollout):
    """Stepping a session through the unit sequence reproduces generate()
    bit for bit: frames, poses, prompt bookkeeping and the retrieved
    history frame; the step-returned frames ARE the rollout."""
    ref, steps, got = rollout["ref"], rollout["steps"], rollout["result"]
    # chunk boundaries after unit 8 (step 8) and unit 12 (step 12)
    assert [s["chunk_complete"] for s in steps] == [False] * 7 + [True] + [False] * 3 + [True]
    for key in ("pred_img", "pred_disparity", "trans3d", "trans2d"):
        assert torch.equal(got[key], ref[key]), key
    for a, b in zip(got["motion_prompt_list"], ref["motion_prompt_list"], strict=True):
        np.testing.assert_array_equal(a, b)
    # the session retrieved once more: after unit 12 it opened chunk 3
    assert got["history_index"][:1] == ref["history_index"] and len(got["history_index"]) == 2
    assert torch.equal(torch.cat([s["rgb"] for s in steps], dim=2), ref["pred_img"])
    assert torch.equal(torch.cat([s["disparity"] for s in steps], dim=2), ref["pred_disparity"])


def test_session_video_guidance_scale(pipe, rollout):
    """The session takes deepv_tpu's ``video_guidance_scale`` (default 3.5,
    ``generate``'s) and guides each unit by it: a session built with 3.5
    steps the default session's frames bit for bit, another value steps
    other frames (the second step's: the first returns the decoded
    conditioning frame)."""
    batch, ref = make_batch(), rollout["steps"][1]["rgb"]
    for scale, same in ((3.5, True), (2.0, False)):
        sess = InteractiveSession(pipe, video_guidance_scale=scale)
        sess.start(batch["img"], seed=21)
        rgb = [sess.step(a)["rgb"] for a in rollout["actions"][:2]][1]
        assert torch.equal(rgb, ref) is same, scale


def test_session_incremental_delivery(rollout):
    """Each step returns that unit's frames at once: 1 frame for the first
    unit, 8 per unit after (the streaming-decode window law)."""
    steps = rollout["steps"]
    assert tuple(steps[0]["rgb"].shape) == (1, 3, 1, H, W) and steps[0]["frames_total"] == 1
    assert tuple(steps[1]["rgb"].shape) == (1, 3, 8, H, W) and steps[1]["frames_total"] == 9
    assert [s["frames_total"] for s in steps] == [1 + 8 * i for i in range(12)]
    assert float(steps[1]["rgb"].abs().max()) < 1e4
    assert tuple(steps[1]["disparity"].shape) == (1, 3, 8, H, W)
    assert float(steps[1]["disparity"].min()) >= 0.0


def test_session_keeps_the_flow_cache_log_bounded(pipe, rollout):
    """A session keeps only its last unit's stages (a forward per step)
    and leaves the pipeline's recompute log, generate()'s whole rollout, as
    it was, so a long-lived server grows neither."""
    stages = len(pipe.cfg.stages)
    every_step = (1,) * pipe.cfg.num_inference_steps
    assert rollout["session"].recompute_log == [every_step] * stages
    assert rollout["log"] == rollout["ref_log"] == [every_step] * (12 * stages)


def test_session_releases_a_finished_chunk(rollout):
    """At each boundary the session lets go of the finished chunk (its
    decoder caches and frames) before the carry's encodes and the next
    chunk's priming, as generate_i2v does by returning: nothing references
    it any more (its caches are gigabytes at full width)."""
    assert rollout["held"] == [False, False]


def test_session_matches_generate_with_flow_caching(fast_modes):
    """Under adaptive flow caching (a host decision at every step) a session
    still equals generate() bit for bit: its frames and each unit's
    recompute decisions. Over 12 steps the session holds one unit's stages
    and the pipeline's log stays generate()'s."""
    ref, ref_log, steps, logs = (fast_modes[k] for k in ("ref", "ref_log", "steps", "logs"))
    stages = len(fast_modes["pipe"].cfg.stages)
    assert len(logs) == 12 and all(len(log) == stages for log in logs)
    assert len(ref_log) == 12 * stages and [r for log in logs for r in log] == ref_log
    assert fast_modes["pipe"].recompute_log == ref_log
    # both branches ran: some forwards skipped, every stage's first kept
    later = [r for ran in ref_log for r in ran[1:]]
    assert all(ran[0] == 1 for ran in ref_log) and 0 < sum(later) < len(later)
    got = fast_modes["result"]
    for key in ("pred_img", "pred_disparity", "trans3d", "trans2d"):
        assert torch.equal(got[key], ref[key]), key
    assert torch.equal(torch.cat([s["rgb"] for s in steps], dim=2), ref["pred_img"])
    assert torch.equal(torch.cat([s["disparity"] for s in steps], dim=2), ref["pred_disparity"])


def test_on_frames_streaming_callback(rollout):
    """The serving hook fires once per decoded window with the raw pixels:
    chunk 1 pushes 8 units (1 frame, then 7 x 8 = 57 frames), chunk 2, with
    exact priming, its 4 new units only (4 x 8). The windows concatenate to
    the rollout's output, disparity after the chunk's post-map."""
    windows, ref = rollout["windows"], rollout["ref"]
    frames = [rgb.shape[2] for rgb, _ in windows]
    assert frames == [1] + [8] * 7 + [8] * 4
    assert sum(frames[:8]) == 57 and sum(frames) == ref["pred_img"].shape[2] == 89
    assert torch.equal(torch.cat([rgb for rgb, _ in windows], dim=2), ref["pred_img"])
    one = torch.tensor(1.0, dtype=torch.float32)
    chunk1 = _disparity_postmap(torch.cat([d for _, d in windows[:8]], dim=2), one)
    assert torch.equal(chunk1, ref["pred_disparity"][:, :, :57])
    # chunk 2's scale factor is the carry's: 1 / max of its first carried
    # frame's post-mapped disparity (pipeline._prepare_carry)
    sf = 1.0 / ref["pred_disparity"][:, :, 57 - 25].max()
    chunk2 = _disparity_postmap(torch.cat([d for _, d in windows[8:]], dim=2), sf)
    assert torch.equal(chunk2, ref["pred_disparity"][:, :, 57:])


def test_session_reuse_decoder_cache(rollout, reuse_served):
    """reuse_decoder_cache=True skips the boundary's cache priming from the
    re-encoded overlap: same layout, chunk 1 bit-identical to the default
    mode, chunk 2's poses identical (its conditioning is), finite pixels."""
    got, want = reuse_served["result"], rollout["result"]
    assert got["pred_img"].shape == want["pred_img"].shape
    assert torch.equal(got["pred_img"][:, :, :57], want["pred_img"][:, :, :57])
    assert torch.equal(got["trans3d"], want["trans3d"])
    assert bool(torch.isfinite(got["pred_img"]).all())


def test_session_carry_latents_matches_generate(fast_modes):
    """A session on a carry_latents pipe (with the other fast modes on)
    reproduces generate() on the same pipe bit for bit."""
    got, ref = fast_modes["result"], fast_modes["ref"]
    assert fast_modes["pipe"].carry_latents and fast_modes["pipe"].denoise_int8
    assert torch.equal(got["pred_img"], ref["pred_img"])
    assert torch.equal(got["trans3d"], ref["trans3d"])


def test_session_no_need_depth_step_parity(params):
    """With no_need_depth, each step's disparity is the rollout's post-mapped
    constant (0.25/0.95), keeping the step stream equal to result()."""
    p = tiny_pipeline(params, no_need_depth=True)
    sess = InteractiveSession(p)
    sess.start(make_batch()["img"], seed=41)
    steps = [sess.step(FORWARD) for _ in range(8)]
    for out in steps:
        np.testing.assert_allclose(out["disparity"].numpy(), 0.25 / 0.95, atol=1e-6)
    got = sess.result()
    assert torch.equal(torch.cat([o["disparity"] for o in steps], dim=2), got["pred_disparity"])


def test_session_history_limit(rollout, limited):
    """history_limit_chunks bounds rollout state; over the first 2 chunks the
    limit-1 session's frames equal the unlimited one's (retrieval only ever
    looked one chunk back)."""
    assert len(rollout["session"].rollout.images_list) == 2
    assert limited["kept"][11] == 1                      # bounded after chunk 2
    assert limited["actions"][:12] == rollout["actions"]
    for a, b in zip(limited["steps"][:12], rollout["steps"], strict=True):
        assert torch.equal(a["rgb"], b["rgb"])
        assert torch.equal(a["disparity"], b["disparity"])


def test_session_history_limit_preserves_retrieval_phase(pipe, limited):
    """When truncation drops chunks, the ::ds history subsample stays aligned
    to unit-final frames (head chunk trimmed to 1 mod ds frames): the
    frame-to-pose pairing of _retrieve_history."""
    roll, ds = limited["session"].rollout, pipe.cfg.vae_downsample
    assert limited["kept"][-1] == len(roll.images_list) == 1
    assert roll.images_list[0].shape[2] % ds == 1        # phase restored
    n_frames = roll.images_list[0].shape[2]
    n_pose = sum(t.shape[1] for t in roll.trans3d_list)
    assert (n_frames + ds - 1) // ds == n_pose
    assert len(roll.history_index) == 3
    assert bool(torch.isfinite(limited["steps"][-1]["rgb"]).all())


def test_http_server_roundtrip(pipe, rollout):
    """The four endpoints; the first step's frames over the wire equal the
    session's, rounded once to float16; 404 for an unknown session, 409
    while max_sessions are held."""
    server = SessionServer(pipe, port=0, max_sessions=1)
    port = server.start()
    try:
        img = make_batch()["img"]
        status, resp = post(port, "/session", {"image": _np_b64(img), "seed": 21})
        assert status == 200
        sid = resp["session_id"]
        status, out = post(port, "/step", {"session_id": sid, "action": rollout["actions"][0]})
        assert status == 200
        assert out["rgb"]["shape"] == [1, 3, 1, H, W]
        assert out["frames_total"] == 1 and not out["chunk_complete"]
        want = rollout["steps"][0]
        assert np.array_equal(_b64_np(out["rgb"]), want["rgb"].numpy().astype(np.float16))
        assert np.array_equal(_b64_np(out["disparity"]),
                              want["disparity"].numpy().astype(np.float16))

        _, m = get(port, "/metrics")
        assert m["sessions"] == 1 and m["frames_out"] == 1 and m["steps"] == 1
        assert post(port, "/step", {"session_id": "nope", "action": "x"})[0] == 404
        assert post(port, "/session", {"image": _np_b64(img), "seed": 24})[0] == 409
        assert post(port, "/close", {"session_id": sid}) == (200, {"closed": True})
        assert post(port, "/close", {"session_id": sid}) == (404, {"closed": False})
        assert get(port, "/metrics")[1]["sessions"] == 0
        assert get(port, "/nowhere")[0] == 404
    finally:
        server.stop()


def test_http_server_step_error_is_500(pipe):
    """A step that raises answers 500 with the error's summary, and the
    server goes on answering."""
    server = SessionServer(pipe, port=0)
    port = server.start()
    try:
        _, resp = post(port, "/session", {"image": _np_b64(make_batch()["img"]), "seed": 1})
        status, out = post(port, "/step", {"session_id": resp["session_id"],
                                           "action": "not an action"})
        assert status == 500 and out["error"].startswith("KeyError")
        assert get(port, "/metrics")[1]["sessions"] == 1
    finally:
        server.stop()


def test_multi_stream_server(params, rollout):
    """A server over two pipelines assigns sessions to the least-loaded
    stream, steps them concurrently under per-stream locks, and each stream
    returns the single-pipeline session's first step."""
    server = SessionServer([tiny_pipeline(params), tiny_pipeline(params)], port=0)
    assert server.pipes[0] is not server.pipes[1]
    port = server.start()
    try:
        img = make_batch()["img"]
        sids = [post(port, "/session", {"image": _np_b64(img), "seed": 21})[1]["session_id"]
                for _ in range(2)]
        _, m = get(port, "/metrics")
        assert m["streams"] == 2 and m["stream_sessions"] == [1, 1]
        assert {server._stream_of[s] for s in sids} == {0, 1}

        outs, seen = {}, []
        unit = [p._generate_one_unit for p in server.pipes]

        def spying(i):
            def spy(*args, **kwargs):
                seen.append((i, server._device_locks[i].locked()))
                return unit[i](*args, **kwargs)
            return spy

        for i, p in enumerate(server.pipes):
            p._generate_one_unit = spying(i)

        def hit(sid):
            outs[sid] = post(port, "/step", {"session_id": sid,
                                             "action": rollout["actions"][0]})

        threads = [threading.Thread(target=hit, args=(s,)) for s in sids]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=TIMEOUT)
        # each stream's step ran on its own pipeline, under its own lock
        assert sorted(seen) == [(0, True), (1, True)]
        want = rollout["steps"][0]["rgb"].numpy().astype(np.float16)
        for sid in sids:
            status, out = outs[sid]
            assert status == 200
            assert np.array_equal(_b64_np(out["rgb"]), want)
    finally:
        server.stop()


def test_metrics_not_blocked_by_device_lock(pipe):
    """/metrics answers while a step holds the device: hold the device lock
    as a long step would and time the metrics round trip."""
    server = SessionServer(pipe, port=0)
    port = server.start()
    try:
        with server._device_locks[0]:
            t0 = time.perf_counter()
            _, m = get(port, "/metrics")
            dt = time.perf_counter() - t0
        assert dt < 1.0, f"/metrics queued behind device work: {dt:.3f}s"
        assert m["sessions"] == 0 and m["evicted_total"] == 0
        assert "session_ttl_s" in m
    finally:
        server.stop()


def test_session_ttl_eviction(pipe):
    """Sessions idle past session_ttl_s are evicted lazily and reported."""
    server = SessionServer(pipe, port=0, session_ttl_s=0.2)
    port = server.start()
    try:
        sid = post(port, "/session", {"image": _np_b64(make_batch()["img"]),
                                      "seed": 71})[1]["session_id"]
        time.sleep(0.5)                    # idle past the TTL
        _, m = get(port, "/metrics")
        assert m["sessions"] == 0 and m["evicted_total"] == 1
        # the evicted session's state is gone; stepping it is a 404
        assert post(port, "/step", {"session_id": sid, "action": "x"})[0] == 404
    finally:
        server.stop()


def test_server_reuse_decoder_cache_flag(pipe, reuse_served):
    """SessionServer(reuse_decoder_cache=True) (the --reuse_decoder_cache
    flag) creates reuse sessions: steps cross the chunk boundary without
    priming and keep emitting finite frames."""
    assert reuse_served["session"].reuse_decoder_cache is True
    assert reuse_served["session"].chunk.full_window is False
    for status, out in reuse_served["steps"]:
        assert status == 200, out
        assert np.isfinite(_b64_np(out["rgb"])).all()
    assert [out["chunk_complete"] for _, out in reuse_served["steps"]].count(True) == 2
    assert reuse_served["steps"][-1][1]["frames_total"] == 89


def test_prewarm_runs_the_serving_path(pipe):
    """serve.prewarm drives one throwaway session across a chunk boundary and
    leaves the pipeline reusable: a real session afterwards steps from its
    first unit."""
    logs = []
    dt = serve.prewarm(pipe, height=H, width=W, seed=5, log=logs.append)
    assert dt > 0 and logs and "prewarm" in logs[0]
    sess = InteractiveSession(pipe)
    sess.start(make_batch()["img"], seed=6)
    out = sess.step(FORWARD)
    assert out["rgb"].shape[1] == 3 and out["frames_total"] == 1
    assert bool(torch.isfinite(out["rgb"]).all())


@pytest.mark.parametrize("dtype", ["float32", "float64", "bfloat16"])
def test_np_b64_matches_deepv_tpu(dtype):
    """The wire payload is byte-equal to deepv_tpu's for the same values:
    each value rounds to float16 once (bfloat16 through exact float32).
    Values span float16's normal, subnormal and overflow ranges and its ties."""
    import jax
    import jax.numpy as jnp
    from deepv_tpu.serve import _np_b64 as jax_np_b64

    rng = np.random.default_rng(3)
    x = np.concatenate([rng.standard_normal(4096), rng.standard_normal(512) * 1e-6,
                        rng.standard_normal(64) * 1e5, (np.arange(256) + 0.5) * 2.0 ** -10])
    t = torch.from_numpy(x.reshape(2, 2, -1)).to(getattr(torch, dtype))
    values = (t.float() if dtype == "bfloat16" else t).numpy()
    with jax.enable_x64():
        ref = jax_np_b64(jnp.asarray(values, dtype=getattr(jnp, dtype)))
    assert ref["shape"] == [2, 2, 1232]
    assert _np_b64(t) == ref
    assert _np_b64(values if dtype != "bfloat16" else t) == ref
    assert np.array_equal(_b64_np(ref), values.astype(np.float16).astype(np.float32))


def test_serve_help_runs():
    proc = subprocess.run([sys.executable, "-m", "deepv_tpu_torch.serve", "--help"],
                          capture_output=True, text=True, timeout=120, cwd=str(ROOT))
    assert proc.returncode == 0, proc.stderr
    for flag in ("--fast", "--carry_latents", "--reuse_decoder_cache", "--flow_cache",
                 "--no_prewarm", "--height", "--width", "--streams", "--random_weights"):
        assert flag in proc.stdout


@pytest.mark.parametrize("argv, error, match", [
    # the AOT cache is ported (M19c): a directory others may write is refused
    pytest.param(["--random_weights", "--aot_cache", "{untrusted}"], PermissionError,
                 "writable by group or others", id="argv0-NotImplementedError-M19c"),
    # serving over a mesh is ported (M17c): one NCCL rank per card, so a
    # machine without 2 cards refuses, naming its count
    pytest.param(["--random_weights", "--tp_shards", "2"], RuntimeError, "this machine has 0",
                 id="argv1-NotImplementedError-M17"),
    ([], RuntimeError, "no CUDA device"),
    (["--random_weights", "--streams", "2", "--tp_shards", "2"], SystemExit, "exclusive"),
    (["--random_weights", "--streams", "2"], SystemExit, "visible devices"),
    (["--random_weights"], RuntimeError, "no CUDA device"),
])
def test_cli_refuses_what_it_cannot_run(monkeypatch, tmp_path, argv, error, match):
    """The CLI runs on the card, with a snapshot or --random_weights; an
    --aot_cache directory group or others may write is refused, and
    --streams is checked against the visible cards."""
    untrusted = tmp_path / "cache"
    untrusted.mkdir(mode=0o777)
    untrusted.chmod(0o777)
    argv = [str(untrusted) if a == "{untrusted}" else a for a in argv]
    monkeypatch.setenv("DEEPV_TINY", "1")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    monkeypatch.setattr("sys.argv", ["serve", "--model_path", "none"] + argv)
    with pytest.raises(error, match=match):
        serve.cli()
