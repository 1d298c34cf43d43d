"""The serving slice as a whole: the port's ``InteractiveSession`` against
deepv_tpu's, step by step.

Both step a session through the 11-action prompt of
tests/test_torch_port_pipeline.py (12 units, one chunk boundary: priming,
the carry re-encode, history retrieval and the 3-row CFG) at 64x64 in
float64, with the same parameters and text embeddings. deepv_tpu's session
runs under ``_run_reference``'s rounding pins (ROADMAP section 3 "Pinned")
with its Gaussian draws recorded, and the port's session replays them
through ``ReplayNoise``. Each step's frames and ``result()`` agree within
the rollout test's ATOL, for its reason (random weights amplify ulps).
"""

import numpy as np
import pytest
import torch

import jax

import deepv_tpu.pipeline as jax_pipeline
import deepv_tpu.serve as jax_serve
from deepv_tpu.actions import action_vocabulary
from deepv_tpu.io.text_embeds import random_text_embeds

from deepv_tpu_torch import raymap as port_raymap
from deepv_tpu_torch.config import (MMDiTConfig as TMMDiTConfig,
                                    PipelineConfig as TPipelineConfig,
                                    VAEConfig as TVAEConfig)
from deepv_tpu_torch.io.weights import random_params
from deepv_tpu_torch.pipeline import InferencePipeline as TorchPipeline
from deepv_tpu_torch.serve import InteractiveSession as TorchSession

from test_torch_port_pipeline import ATOL, MCFG, ReplayNoise, _batch, _run_reference, via_port

torch.set_num_threads(1)

KEYS = ("pred_img", "pred_disparity", "trans3d", "trans2d")


@pytest.fixture(scope="module")
def sessions():
    params = random_params(TMMDiTConfig(**MCFG), TVAEConfig.tiny(), dtype=torch.float64,
                           seed=0, device="cpu")
    params = {k: jax.tree.map(lambda a: a.numpy(), v) for k, v in params.items()}
    embeds = random_text_embeds(0, action_vocabulary(), joint_dim=24, pooled_dim=16)
    ref_steps = []

    def drive_session(self, batch, seed=666, guidance_scale=4.0, video_guidance_scale=3.5):
        """deepv_tpu's session over the units generate(batch) would run."""
        sess = jax_serve.InteractiveSession(self)
        sess.start(batch["img"], seed=seed)
        for a in jax_serve.InteractiveSession.actions_from_prompt_list(self.cfg,
                                                                       list(batch["prompt"])):
            out = sess.step(a)
            ref_steps.append({k: (np.asarray(v) if k in ("rgb", "disparity") else v)
                              for k, v in out.items()})
        return sess.result()

    with jax.enable_x64():
        ref, draws, ref_index = _run_reference(
            params, embeds,
            patches=[(jax_pipeline.InferencePipeline, "generate", drive_session),
                     # the session module's own binding of the pose recovery
                     (jax_serve, "raymap_to_camera", via_port(port_raymap.raymap_to_camera))])
    pipe = TorchPipeline(TPipelineConfig(), TMMDiTConfig(**MCFG), TVAEConfig.tiny(), params,
                         embeds, dtype=torch.float64, device="cpu")
    noise = ReplayNoise(draws)
    batch = _batch()
    sess = TorchSession(pipe)
    sess.start(batch["img"], seed=9, noise=noise)
    steps = [sess.step(a)
             for a in TorchSession.actions_from_prompt_list(pipe.cfg, list(batch["prompt"]))]
    return ref, ref_steps, ref_index, sess, steps, noise


def test_session_layout(sessions):
    ref, ref_steps, _, sess, steps, noise = sessions
    assert len(steps) == len(ref_steps) == 12
    assert [s["chunk_complete"] for s in steps] == [r["chunk_complete"] for r in ref_steps]
    assert [s["frames_total"] for s in steps] == [r["frames_total"] for r in ref_steps]
    assert tuple(sess.result()["pred_img"].shape) == ref["pred_img"].shape == (1, 3, 89, 64, 64)
    # every recorded draw was consumed, in the same order and shapes: the
    # session closing chunk 2 opened chunk 3 in both packages
    assert all(not q for q in noise.queues.values()), {k: len(q) for k, q in noise.queues.items()}


@pytest.mark.parametrize("key", ["rgb", "disparity"])
def test_each_step_matches_reference(sessions, key):
    _, ref_steps, _, _, steps, _ = sessions
    for i, (got, want) in enumerate(zip(steps, ref_steps, strict=True)):
        g = got[key].numpy()
        assert g.shape == want[key].shape, (i, g.shape, want[key].shape)
        assert np.isfinite(g).all(), i
        np.testing.assert_allclose(g, want[key], rtol=0, atol=ATOL, err_msg=f"step {i + 1}")


@pytest.mark.parametrize("key", KEYS)
def test_result_matches_reference(sessions, key):
    ref, _, _, sess, _, _ = sessions
    got = sess.result()[key].numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, ref[key], rtol=0, atol=ATOL)


def test_history_index_matches_reference(sessions):
    ref, _, ref_index, sess, _, _ = sessions
    assert sess.rollout.history_index == ref_index and len(ref_index) == 2
    assert [list(m) for m in sess.result()["motion_prompt_list"]] == \
        [list(m) for m in ref["motion_prompt_list"]]
