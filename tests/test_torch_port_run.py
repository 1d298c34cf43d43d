"""The port's CLI entry point on the CPU: one tiny rollout written to an mp4,
the GPU default of ``load_pipeline``, the ``fast`` preset and its options
through ``load_pipeline`` and ``main`` (with the PLY export), a tiny rollout
with the igemm conv backend, an ``--aot_cache`` directory it must not trust,
refused before anything runs (tests/test_torch_port_aot.py runs the cache),
and the mesh options' refusals outside what they take
(tests/test_torch_port_mesh_rollout.py runs them)."""

import os

import numpy as np
import pytest
import torch
from PIL import Image

from deepv_tpu_torch import run
from deepv_tpu_torch.actions import action_vocabulary, prepare_motion_prompts
from deepv_tpu_torch.config import MMDiTConfig, PipelineConfig, VAEConfig, create_model_config
from deepv_tpu_torch.io.text_embeds import random_text_embeds
from deepv_tpu_torch.io.weights import random_params
from deepv_tpu_torch.models.mmdit import Int8Linear
from deepv_tpu_torch.ops import causal_conv
from deepv_tpu_torch.pipeline import InferencePipeline
from deepv_tpu_torch.utils import aot

torch.set_num_threads(1)


def test_cli_writes_a_video_on_the_cpu(tmp_path, monkeypatch):
    """``run.cli`` with the DEEPV_TINY architecture at 64x64: one chunk of
    57 frames, saved as an mp4."""
    image = tmp_path / "in.png"
    pixels = np.random.default_rng(0).integers(0, 256, (80, 100, 3), dtype=np.uint8)
    Image.fromarray(pixels).save(image)
    out = tmp_path / "out" / "video.mp4"
    monkeypatch.setenv("DEEPV_TINY", "1")
    monkeypatch.setattr("sys.argv", [
        "run", "--input_image", str(image), "--model_path", "none", "--random_weights",
        "--prompt_type", "action", "--prompt", "(FN)", "--height", "64", "--width", "64",
        "--device", "cpu", "--output_path", str(out)])
    run.cli()
    assert out.is_file() and out.stat().st_size > 0


def test_load_pipeline_runs_on_the_card_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run.load_pipeline("none", create_model_config("none"), random_weights=True)


@pytest.mark.parametrize("kwargs, error, match", [
    # tp_shards is ported: each rank calls load_pipeline inside a process
    # group, and a call outside one raises
    pytest.param(dict(tp_shards=2), RuntimeError, "torch.distributed", id="kwargs1-M17"),
])
def test_load_pipeline_refuses_what_is_not_ported(monkeypatch, kwargs, error, match):
    monkeypatch.setenv("DEEPV_TINY", "1")
    kwargs = dict(dict(random_weights=True, device="cpu"), **kwargs)
    with pytest.raises(error, match=match):
        run.load_pipeline("none", create_model_config("none"), **kwargs)


@pytest.mark.parametrize("kwargs, error, match", [
    # the mesh is ported: it must be a parallel.mesh.Mesh, and it is refused
    # with tiling (both split H), as deepv_tpu/pipeline.py:303 refuses it
    pytest.param(dict(mesh=object()), TypeError, "parallel.mesh.Mesh", id="kwargs0-M17"),
    pytest.param(dict(mesh=object(), use_tiling=True), ValueError, "tiling", id="kwargs1-M17"),
])
def test_pipeline_refuses_what_is_not_ported(kwargs, error, match):
    mcfg, vcfg = MMDiTConfig.tiny(), VAEConfig.tiny()
    params = random_params(mcfg, vcfg, dtype=torch.float32, device="cpu")
    with pytest.raises(error, match=match):
        InferencePipeline(PipelineConfig(), mcfg, vcfg, params, {}, device="cpu", **kwargs)


@pytest.mark.parametrize("kwargs, flow_cache, tau, carry", [
    (dict(fast=True), "skip_odd", None, False),
    (dict(fast=True, flow_cache="adaptive:0.5", carry_latents=True), "adaptive:0.5", 0.5, True),
])
def test_load_pipeline_fast_builds_the_int8_models(monkeypatch, kwargs, flow_cache, tau, carry):
    """``fast``: flow caching (an explicit ``flow_cache`` overrides the
    preset's), the MMDiT's 21 block linears swapped for int8 ones (12 in the
    first block, 9 in the context-pre-only last one) and the VAE's 3x3x3
    convs carrying K3's weights, as deepv_tpu/run.py:87-98 builds it."""
    monkeypatch.setenv("DEEPV_TINY", "1")
    pipe = run.load_pipeline("none", create_model_config("none"), random_weights=True,
                             device="cpu", **kwargs)
    assert (pipe.flow_cache, pipe.adaptive_tau, pipe.carry_latents) == (flow_cache, tau, carry)
    assert pipe.vcfg.conv_impl == "int8" and pipe.denoise_int8
    int8 = [m for m in pipe.mmdit.modules() if isinstance(m, Int8Linear)]
    assert len(int8) == 21
    attn = pipe.mmdit.transformer_blocks[0].attn
    assert not any(isinstance(m, torch.nn.Linear) for m in attn.children())
    convs = [m for m in pipe.vae.modules()
             if isinstance(m, torch.nn.Conv3d) and m.weight.shape[2:] == (3, 3, 3)]
    assert convs and all(getattr(m, "weight_k3_packed" if m.weight.shape[1] <= 16
                                 else "weight_k3").dtype == torch.int8 for m in convs)


def test_main_writes_a_fast_video_on_the_cpu(tmp_path, monkeypatch):
    """``run.main`` with ``fast``, ``carry_latents`` and adaptive caching: a
    2-chunk DEEPV_TINY rollout at 64x128 (so every int8 product has more
    than 16 rows) written as an mp4, and with ``add_ply`` every 8th of its
    89 frames as a PLY point cloud beside it."""
    image = tmp_path / "in.png"
    pixels = np.random.default_rng(1).integers(0, 256, (64, 128, 3), dtype=np.uint8)
    Image.fromarray(pixels).save(image)
    out = tmp_path / "fast.mp4"
    monkeypatch.setenv("DEEPV_TINY", "1")
    written = run.main(str(image), "none", prompt_type="action",
                       prompt="(FN)(FN)(FN)(FN)(FN)(FN)(FN)(fRL)(SR)(BL)(FN)",
                       random_weights=True, height=64, width=128, fast=True,
                       carry_latents=True, flow_cache="adaptive:0.5", device="cpu",
                       output_path=str(out), add_ply=True)
    assert out.is_file() and out.stat().st_size > 0 and str(written) == str(out)
    plys = sorted(p.name for p in tmp_path.glob("*.ply"))
    assert plys == sorted(f"fast_frame{i}.ply" for i in range(0, 89, 8))
    for name in plys:
        header = (tmp_path / name).read_text().split("end_header")[0]
        assert "element vertex" in header and "property uchar red" in header


def test_pipeline_runs_the_igemm_conv_backend(monkeypatch):
    """``VAEConfig(conv_impl="igemm")`` through ``InferencePipeline``: a
    one-chunk f32 rollout at 64x64 whose VAE's two deep blocks have 128
    channels, so their 3x3x3 convs are eligible (the 8-channel shallow
    blocks keep the rollout cheap). A spy counts the convs routed to
    ``conv3d_igemm``; the frames match the same rollout with "xla" at atol
    1e-4: the two differ only in f32 summation order (measured ~3e-6 after
    the random-weight decoder), while a wrong mode, padding or cache gives
    errors of order 0.1."""
    mcfg = MMDiTConfig(sample_size=16, patch_size=2, in_channels=14, num_layers=2,
                       attention_head_dim=8, num_attention_heads=4, caption_projection_dim=32,
                       pooled_projection_dim=16, pos_embed_max_size=32, joint_attention_dim=24)
    channels = (8, 8, 128, 128)
    vae_kw = dict(encoder_out_channels=4, encoder_layers_per_block=(1, 1, 1, 1),
                  encoder_block_out_channels=channels, encoder_norm_num_groups=8,
                  decoder_in_channels=4, decoder_layers_per_block=(1, 1, 1, 1),
                  decoder_block_out_channels=channels, decoder_norm_num_groups=8)
    embeds = random_text_embeds(0, action_vocabulary(), joint_dim=24, pooled_dim=16)
    img = np.random.default_rng(7).uniform(-1, 1, (1, 3, 64, 64)).astype(np.float32)
    batch = {"img": img, "prompt": np.array(prepare_motion_prompts("action", "(FN)")),
             "prompt_type": "action"}
    routed = []
    orig = causal_conv.conv3d_igemm
    monkeypatch.setattr(causal_conv, "conv3d_igemm",
                        lambda *a, **k: routed.append(a[0].shape) or orig(*a, **k))
    out = {}
    for impl in ("igemm", "xla"):
        vcfg = VAEConfig(**vae_kw, conv_impl=impl)
        params = random_params(mcfg, vcfg, dtype=torch.float32, device="cpu")
        pipe = InferencePipeline(PipelineConfig(), mcfg, vcfg, params, embeds,
                                 dtype=torch.float32, device="cpu")
        out[impl] = pipe.generate(batch, seed=3)
        if impl == "igemm":
            assert routed, "no VAE layer was routed to the igemm conv"
            assert all(s[1] % 128 == 0 for s in routed)
            n_routed = len(routed)
    assert len(routed) == n_routed, "the xla rollout must not route to igemm"
    assert out["igemm"]["pred_img"].shape == (1, 3, 57, 64, 64)
    for key in ("pred_img", "pred_disparity", "trans3d"):
        np.testing.assert_allclose(out["igemm"][key].numpy(), out["xla"][key].numpy(),
                                   rtol=0, atol=1e-4, err_msg=key)


@pytest.mark.parametrize("kwargs, item", [
    # PLY export and the AOT cache (M19c) are ported; a cache directory that
    # group or others may write is refused before anything is built or read
    pytest.param(dict(add_ply=True, aot_cache=0o770), "writable by group or others",
                 id="kwargs0-M19"),
    pytest.param(dict(aot_cache=0o703), "writable by group or others", id="kwargs1-M19"),
])
def test_main_refuses_what_is_not_ported(tmp_path, kwargs, item):
    cache = tmp_path / "cache"
    cache.mkdir()
    os.chmod(cache, kwargs["aot_cache"])
    with pytest.raises(PermissionError, match=item) as err:
        run.main(str(tmp_path / "absent.png"), "none", random_weights=True, device="cpu",
                 **dict(kwargs, aot_cache=str(cache)))
    assert str(cache) in str(err.value)
    assert aot.cache_dir() is None
