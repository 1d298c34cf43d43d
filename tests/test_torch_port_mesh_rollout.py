"""The port's rollout on a mesh (``InferencePipeline(mesh=...)``) on 2 gloo
ranks on the CPU, against deepv_tpu's single-device rollout.

deepv_tpu's own test (tests/test_mesh_inference.py) holds its mesh rollout
to its single-device one; compiling its mesh rollout is the suite's slowest
file, so the reference here is deepv_tpu's single-device rollout: one chunk
of 7 actions at 64x64 in float64 with tests/test_torch_port_pipeline.py's
configuration, parameters, pins and recorded Gaussian draws, which every
rank replays. One ``parallel/launch.spawn`` of 2 processes
(``torch_port_mesh_worker.rollout_rank``, torch and the port only) runs that
rollout, an adaptive-caching one (tau 0.5) and that rollout again decoded at
the end of the chunk as one batch-2 call (``decode_batched``) on a 2-rank
mesh: the MMDiT's 4 heads split 2 and 2, every encode and decode split over
the image height.

Tolerances: deepv_tpu's mesh test's, pixels 1e-6 and ``trans3d`` 1e-5
(the pose decode amplifies the float64 summation-order differences ~10x
over the pixels); every rank's outputs equal bit for bit, and the adaptive
rollout's decisions equal across ranks (a rank that decided otherwise
would stop at another collective). ``run.main(tp_shards=2, device="cpu")``
spawns its own 2 ranks (bfloat16, the DEEPV_TINY model) and writes a video
whose decoded frames are within a mean 8-bit gap of 6 of the single-device
``run.main``'s: the row-split products are rounded to bfloat16 on each rank
before their sum (as deepv_tpu's GSPMD reduces in bfloat16), the random
weights amplify that rounding through the rollout, and the mp4 codec adds
its own error (measured: mean 2.92).
"""

import numpy as np
import pytest
import torch
from PIL import Image

import jax

from deepv_tpu.actions import action_vocabulary, prepare_motion_prompts
from deepv_tpu.io.text_embeds import random_text_embeds

from deepv_tpu_torch import run
from deepv_tpu_torch.config import MMDiTConfig as TMMDiTConfig, VAEConfig as TVAEConfig
from deepv_tpu_torch.io.weights import random_params
from deepv_tpu_torch.parallel.launch import spawn

import torch_port_mesh_worker as worker
from test_torch_port_pipeline import MCFG, _run_reference

torch.set_num_threads(1)

PROMPT = "(FN)(FN)(SR)(SL)(FN)(FN)(FN)"
RANKS = 2
PIXEL_ATOL, TRANS3D_ATOL = 1e-6, 1e-5
#: mean |frame difference| of the decoded videos, 8-bit units (module doc)
VIDEO_MEAN_GAP = 6.0


def _batch():
    img = np.random.default_rng(7).uniform(-1.0, 1.0, (1, 3, 64, 64))
    return {"img": img, "prompt": np.array(prepare_motion_prompts("action", PROMPT)),
            "prompt_type": "action"}


@pytest.fixture(scope="module")
def rollouts():
    params = random_params(TMMDiTConfig(**MCFG), TVAEConfig.tiny(), dtype=torch.float64,
                           seed=0, device="cpu")
    params = {k: jax.tree.map(lambda a: a.numpy(), v) for k, v in params.items()}
    embeds = random_text_embeds(0, action_vocabulary(), joint_dim=24, pooled_dim=16)
    with jax.enable_x64():
        ref, draws, ref_index = _run_reference(params, embeds, batch=_batch())
    ranks = spawn(worker.rollout_rank, RANKS, (MCFG, params, embeds, _batch(), draws),
                  backend="gloo")
    return ref, ref_index, ranks


def test_ranks_import_no_jax(rollouts):
    _, _, ranks = rollouts
    assert [r["rank"] for r in ranks] == list(range(RANKS))
    assert all(r["forbidden_modules"] == [] for r in ranks)


@pytest.mark.parametrize("key, atol", [("pred_img", PIXEL_ATOL),
                                       ("pred_disparity", PIXEL_ATOL),
                                       ("trans3d", TRANS3D_ATOL), ("trans2d", TRANS3D_ATOL)])
def test_mesh_rollout_matches_single_device_deepv_tpu(rollouts, key, atol):
    ref, _, ranks = rollouts
    got = ranks[0]["exact"][key].numpy()
    assert got.shape == ref[key].shape
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, ref[key], rtol=0, atol=atol)


@pytest.mark.parametrize("key, atol", [("pred_img", PIXEL_ATOL),
                                       ("pred_disparity", PIXEL_ATOL),
                                       ("trans3d", TRANS3D_ATOL), ("trans2d", TRANS3D_ATOL)])
def test_mesh_batched_decode_matches_single_device_deepv_tpu(rollouts, key, atol):
    """``stream_decode=False, decode_batched=True`` on the mesh: rgb and
    disparity go through one batch-2 ``cp_vae_decode_chunked`` call, and the
    rollout equals deepv_tpu's at the exact rollout's tolerances."""
    ref, _, ranks = rollouts
    for r in ranks:
        assert r["batched_decode_batches"] == [2]
        assert all(n == 0 for n in r["batched_draws_left"].values())
    got = ranks[0]["batched"][key].numpy()
    assert got.shape == ref[key].shape and np.isfinite(got).all()
    np.testing.assert_allclose(got, ref[key], rtol=0, atol=atol)


def test_mesh_rollout_layout(rollouts):
    ref, ref_index, ranks = rollouts
    out = ranks[0]["exact"]
    assert tuple(out["pred_img"].shape) == (1, 3, 57, 64, 64)
    assert out["history_index"] == ref_index == []
    assert all(n == 0 for n in ranks[0]["draws_left"].values()), ranks[0]["draws_left"]


@pytest.mark.parametrize("run_name", ["exact", "adaptive", "batched"])
def test_ranks_return_the_same_bits(rollouts, run_name):
    _, _, ranks = rollouts
    for r in ranks[1:]:
        for key, value in ranks[0][run_name].items():
            other = r[run_name][key]
            if isinstance(value, torch.Tensor):
                assert torch.equal(other, value), (r["rank"], key)
            else:    # motion_prompt_list (numpy arrays), history_index
                assert [np.asarray(v).tolist() for v in other] == \
                    [np.asarray(v).tolist() for v in value], (r["rank"], key)


def test_adaptive_decisions_equal_across_ranks(rollouts):
    """Each step's decision reads the replicated latents (an ``.item()``),
    so all ranks decide alike; tau 0.5 skips some forwards but not all."""
    _, _, ranks = rollouts
    decisions = ranks[0]["adaptive_decisions"]
    assert all(r["adaptive_decisions"] == decisions for r in ranks)
    later = [d for stage in decisions for d in stage[1:]]
    # the first chunk's 8 units x 3 stages
    assert len(decisions) == 8 * 3 and 0 < sum(later) < len(later)


def _video_frames(path):
    import cv2
    cap = cv2.VideoCapture(str(path))
    frames = []
    ok, frame = cap.read()
    while ok:
        frames.append(frame.astype(np.float64))
        ok, frame = cap.read()
    cap.release()
    return np.stack(frames)


def test_run_main_tp_shards_writes_the_single_device_video(tmp_path, monkeypatch):
    image = tmp_path / "in.png"
    pixels = np.random.default_rng(0).integers(0, 256, (64, 64, 3), dtype=np.uint8)
    Image.fromarray(pixels).save(image)
    monkeypatch.setenv("DEEPV_TINY", "1")
    monkeypatch.setenv("OMP_NUM_THREADS", "1")    # the spawned ranks' torch threads
    videos = {}
    for n in (1, RANKS):
        written = run.main(str(image), "none", prompt_type="action", prompt="(FN)",
                           random_weights=True, height=64, width=64, tp_shards=n,
                           device="cpu", output_path=str(tmp_path / f"tp{n}.mp4"))
        assert str(written) == str(tmp_path / f"tp{n}.mp4")
        videos[n] = _video_frames(written)
    assert videos[1].shape == videos[RANKS].shape == (57, 64, 64, 3)
    gap = np.abs(videos[1] - videos[RANKS]).mean()
    assert gap <= VIDEO_MEAN_GAP, gap
