"""The port's CLI entry point on the CPU: one tiny rollout written to an mp4,
the GPU default of ``load_pipeline``, and the options not ported yet, which
raise ``NotImplementedError`` instead of running another path."""

import numpy as np
import pytest
import torch
from PIL import Image

from deepv_tpu_torch import run
from deepv_tpu_torch.config import MMDiTConfig, PipelineConfig, VAEConfig, create_model_config
from deepv_tpu_torch.io.weights import random_params
from deepv_tpu_torch.pipeline import InferencePipeline

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


@pytest.mark.parametrize("kwargs, item", [
    (dict(random_weights=False), "M15"),
    (dict(fast=True), "M12"),
    (dict(tp_shards=2), "M17"),
    (dict(flow_cache="skip_odd"), "M12"),
    (dict(carry_latents=True), "M13"),
])
def test_load_pipeline_refuses_what_is_not_ported(monkeypatch, kwargs, item):
    monkeypatch.setenv("DEEPV_TINY", "1")
    kwargs = dict(dict(random_weights=True, device="cpu"), **kwargs)
    with pytest.raises(NotImplementedError, match=item):
        run.load_pipeline("none", create_model_config("none"), **kwargs)


@pytest.mark.parametrize("kwargs, item", [
    (dict(reuse_decoder_cache=True), "M13"),
    (dict(denoise_int8=True), "M14"),
    (dict(mesh=object()), "M17"),
    (dict(use_tiling=True), "M17"),
    (dict(text_encoder=object()), "M15"),
])
def test_pipeline_refuses_what_is_not_ported(kwargs, item):
    mcfg, vcfg = MMDiTConfig.tiny(), VAEConfig.tiny()
    params = random_params(mcfg, vcfg, dtype=torch.float32, device="cpu")
    with pytest.raises(NotImplementedError, match=item):
        InferencePipeline(PipelineConfig(), mcfg, vcfg, params, {}, device="cpu", **kwargs)


@pytest.mark.parametrize("conv_impl, item", [("igemm", "K2"), ("int8", "M14")])
def test_pipeline_refuses_unported_conv_backends(conv_impl, item):
    mcfg, vcfg = MMDiTConfig.tiny(), VAEConfig(**{**VAEConfig.tiny().__dict__,
                                                  "conv_impl": conv_impl})
    params = random_params(mcfg, vcfg, dtype=torch.float32, device="cpu")
    with pytest.raises(NotImplementedError, match=item):
        InferencePipeline(PipelineConfig(), mcfg, vcfg, params, {}, device="cpu")


@pytest.mark.parametrize("kwargs, item", [(dict(add_ply=True), "M19"),
                                          (dict(aot_cache="cache"), "M19")])
def test_main_refuses_what_is_not_ported(tmp_path, kwargs, item):
    with pytest.raises(NotImplementedError, match=item):
        run.main(str(tmp_path / "absent.png"), "none", random_weights=True, device="cpu",
                 **kwargs)
