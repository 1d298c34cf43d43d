"""Serving over a mesh on 2 gloo ranks on the CPU: a mesh
``InteractiveSession`` against deepv_tpu's session, and ``SessionServer``
on rank 0 with ``serve.follow`` on rank 1.

One ``parallel/launch.spawn`` of 2 processes (``torch_port_mesh_worker.
serve_rank``, torch and the port only) runs:

  (a) a float64 session on the mesh through one chunk and the boundary (the
      8 units of a 7-action prompt: the eighth closes chunk 1, carries it
      over and opens chunk 2) with deepv_tpu's recorded draws, against
      deepv_tpu's single-device session, as tests/test_mesh_inference.py:
      77-97 holds deepv_tpu's mesh session to it: each step's frames within
      the f64 rollout's ATOL (1e-6, random weights amplifying summation-
      order differences);
  (b) in float32, the mesh ``generate()`` of those units, then the server:
      a prewarm sent to both ranks, a session over HTTP whose frames (the
      wire's float16) equal ``generate()``'s cast to float16 bit for bit,
      ``/metrics`` counting its steps once, a step that fails on both ranks
      (an action with no embedding) answering 500 while the next step runs,
      a TTL eviction, and ``stop()`` ending rank 1's ``follow``, which ran
      every operation in rank 0's order.
"""

import numpy as np
import pytest
import torch

import jax

import deepv_tpu.pipeline as jax_pipeline
import deepv_tpu.serve as jax_serve
from deepv_tpu.actions import action_vocabulary, prepare_motion_prompts
from deepv_tpu.io.text_embeds import random_text_embeds

from deepv_tpu_torch import raymap as port_raymap
from deepv_tpu_torch import serve
from deepv_tpu_torch.config import (MMDiTConfig as TMMDiTConfig,
                                    PipelineConfig as TPipelineConfig, VAEConfig as TVAEConfig)
from deepv_tpu_torch.io.weights import random_params
from deepv_tpu_torch.parallel.launch import spawn

import torch_port_mesh_worker as worker
from test_torch_port_pipeline import ATOL, MCFG, _batch, _run_reference, via_port

torch.set_num_threads(1)

RANKS = 2
#: one chunk: 7 actions, 8 units
PROMPT = "(FN)(FN)(SR)(SL)(FN)(FN)(FN)"
SEED32 = 5


def one_chunk_batch(img=None):
    b = _batch()
    return dict(b, img=b["img"] if img is None else img,
                prompt=np.array(prepare_motion_prompts("action", PROMPT)))


@pytest.fixture(scope="module")
def runs():
    params = random_params(TMMDiTConfig(**MCFG), TVAEConfig.tiny(), dtype=torch.float64,
                           seed=0, device="cpu")
    params = {k: jax.tree.map(lambda a: a.numpy(), v) for k, v in params.items()}
    embeds = random_text_embeds(0, action_vocabulary(), joint_dim=24, pooled_dim=16)
    ref_steps = []

    def drive_session(self, batch, seed=666, guidance_scale=4.0, video_guidance_scale=3.5):
        """deepv_tpu's session over the units generate(batch) would run."""
        sess = jax_serve.InteractiveSession(self)
        sess.start(batch["img"], seed=seed)
        for a in jax_serve.InteractiveSession.actions_from_prompt_list(
                self.cfg, list(batch["prompt"])):
            ref_steps.append({k: (np.asarray(v) if k in ("rgb", "disparity") else v)
                              for k, v in sess.step(a).items()})
        return sess.result()

    with jax.enable_x64():
        _, draws, _ = _run_reference(
            params, embeds, batch=one_chunk_batch(),
            patches=[(jax_pipeline.InferencePipeline, "generate", drive_session),
                     (jax_serve, "raymap_to_camera", via_port(port_raymap.raymap_to_camera))])
    actions = serve.InteractiveSession.actions_from_prompt_list(
        TPipelineConfig(), list(one_chunk_batch()["prompt"]))
    # the wire carries float16: an image of float16 values arrives unchanged
    img16 = _batch()["img"].astype(np.float16).astype(np.float32)
    ranks = spawn(worker.serve_rank, RANKS,
                  (MCFG, params, embeds, one_chunk_batch()["img"], draws, actions,
                   one_chunk_batch(img16), SEED32), backend="gloo")
    return ref_steps, actions, ranks


def test_ranks_import_no_jax(runs):
    _, _, ranks = runs
    assert [r["rank"] for r in ranks] == list(range(RANKS))
    assert all(r["forbidden_modules"] == [] for r in ranks)


def test_mesh_session_matches_deepv_tpu(runs):
    ref_steps, actions, ranks = runs
    assert len(actions) == len(ref_steps) == 8
    for r in ranks:
        steps = r["session"]
        assert [s["chunk_complete"] for s in steps] == [s["chunk_complete"] for s in ref_steps]
        assert [s["chunk_complete"] for s in steps] == [False] * 7 + [True]
        assert [s["frames_total"] for s in steps] == [s["frames_total"] for s in ref_steps]
        assert all(n == 0 for n in r["session_draws_left"].values()), r["session_draws_left"]
        for i, (got, want) in enumerate(zip(steps, ref_steps)):
            for key in ("rgb", "disparity"):
                assert got[key].shape == want[key].shape, (i, key)
                np.testing.assert_allclose(got[key], want[key], rtol=0, atol=ATOL,
                                           err_msg=f"rank {r['rank']} step {i + 1} {key}")
    for a, b in zip(ranks[0]["session"], ranks[1]["session"]):
        assert np.array_equal(a["rgb"], b["rgb"]) and np.array_equal(a["disparity"],
                                                                      b["disparity"])


def test_served_frames_equal_mesh_generate(runs):
    _, _, ranks = runs
    lead = ranks[0]
    gen = lead["generate"]
    assert gen.shape == (1, 3, 57, 64, 64)
    assert np.array_equal(ranks[1]["generate"], gen)
    assert lead["served"].shape == gen.shape
    assert np.array_equal(lead["served"], gen.astype(np.float16).astype(np.float32))


def test_metrics_count_each_step_once(runs):
    m = runs[2][0]["metrics"]
    assert (m["sessions"], m["steps"], m["frames_out"], m["streams"]) == (1, 8, 57, 1)


def test_failing_step_leaves_both_ranks_serving(runs):
    lead, follower = runs[2]
    status, body = lead["failed_step"]
    assert status == 500 and "KeyError" in body["error"], body
    assert lead["next_step"] == 200
    # the follower ran the same step, failed the same way and went on
    steps_b = [f for f in follower["followed"] if f[0] == "step"][8:]
    assert [ok for _, _, ok in steps_b] == [False, True]


def test_follower_ran_every_operation_and_stop_ended_it(runs):
    lead, follower = runs[2]
    ops = [(op, ok) for op, _, ok in follower["followed"]]
    want = ([("prewarm", True), ("start", True)] + [("step", True)] * 8
            + [("close", True), ("start", True), ("step", False), ("step", True),
               ("close", True), ("start", True), ("close", True), ("stop", True)])
    assert ops == want
    started = [arg for op, arg, _ in follower["followed"] if op == "start"]
    closed = [arg for op, arg, _ in follower["followed"] if op == "close"]
    assert closed == [[s] for s in started]     # the last one by the TTL
    assert started[-1] == lead["evicted_sid"]
    m = lead["evicted_metrics"]
    assert (m["sessions"], m["evicted_total"]) == (0, 1)


def test_tp_shards_with_streams_refused_as_deepv_tpu(monkeypatch):
    argv = ["serve", "--model_path", "none", "--random_weights", "--streams", "2",
            "--tp_shards", "2"]
    monkeypatch.setattr("sys.argv", argv)
    with pytest.raises(SystemExit) as ref:
        jax_serve.cli()
    with pytest.raises(SystemExit) as got:
        serve.cli()
    assert str(got.value) == str(ref.value) and "mutually exclusive" in str(got.value)
