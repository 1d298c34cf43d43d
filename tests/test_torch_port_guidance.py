"""The port's guidance parameters against deepv_tpu's ``pipeline.py``.

``generate`` and ``generate_i2v`` take deepv_tpu's parameters in its order,
with its defaults, the port's noise source standing where deepv_tpu takes
its PRNG key; ``generate`` adds a trailing ``noise``. ``InferencePipeline``
and ``serve.InteractiveSession`` take deepv_tpu's constructor parameters in
its order, with its defaults; the pipeline adds a trailing ``device``. Linear guidance (each
unit's guidance ``max(guidance_scale - alpha * unit, min_guidance_scale)``)
is held to deepv_tpu's on the first chunk of the tiny f64 rollout of
tests/test_torch_port_pipeline.py, deepv_tpu's recorded draws replayed, at
that file's ATOL 1e-6. The chunk is cut to 3 latent units
(``max_temporal_length=3``, both packages), which keeps the test cheap and
still reaches both sides of the decay's floor: units 1-3 take 3, 2, 1.1.
"""

import inspect

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import deepv_tpu.pipeline as jax_pipeline
import deepv_tpu.serve as jax_serve
from deepv_tpu.actions import action_vocabulary
from deepv_tpu.config import PipelineConfig
from deepv_tpu.io.text_embeds import random_text_embeds

from deepv_tpu_torch.config import (MMDiTConfig as TMMDiTConfig,
                                    PipelineConfig as TPipelineConfig,
                                    VAEConfig as TVAEConfig)
from deepv_tpu_torch.io.weights import random_params
from deepv_tpu_torch.pipeline import InferencePipeline as TorchPipeline
from deepv_tpu_torch.serve import InteractiveSession as TorchSession

import test_torch_port_pipeline
from test_torch_port_pipeline import ATOL, MCFG, ReplayNoise, _batch, _run_reference

torch.set_num_threads(1)

KEYS = ("pred_img", "pred_disparity", "trans3d", "trans2d")
LINEAR = dict(guidance_scale=4.0, video_guidance_scale=3.5, use_linear_guidance=True,
              alpha=1.0)
#: units per chunk (deepv_tpu's default is 8)
UNITS = 3


def _params(fn, skip):
    """(name, default, kind) of ``fn``'s parameters after the first ``skip``."""
    return [(p.name, p.default, p.kind) for p in
            list(inspect.signature(fn).parameters.values())[skip:]]


def test_signatures_match_deepv_tpu():
    ref = _params(jax_pipeline.InferencePipeline.generate_i2v, 2)      # self, key
    assert _params(TorchPipeline.generate_i2v, 2) == ref               # self, noise
    assert [p[0] for p in ref[6:9]] == ["guidance_scale", "video_guidance_scale",
                                        "use_linear_guidance"]
    ref = _params(jax_pipeline.InferencePipeline.generate, 1)
    port = _params(TorchPipeline.generate, 1)
    assert port[:len(ref)] == ref and [p[0] for p in port[len(ref):]] == ["noise"]
    assert [p[0] for p in ref] == ["batch", "seed", "guidance_scale", "video_guidance_scale"]
    # the constructor: deepv_tpu's parameters, names, defaults and order, then
    # device; deepv_tpu's default dtype is jnp.bfloat16, the port's its torch
    # counterpart
    ref = _params(jax_pipeline.InferencePipeline.__init__, 1)
    port = _params(TorchPipeline.__init__, 1)
    assert [p[0] for p in port] == [p[0] for p in ref] + ["device"]
    for got, want in zip(port, ref):
        if got[0] == "dtype":
            assert got[1] is torch.bfloat16 and want[1] is jnp.bfloat16
            assert got[2] == want[2]
        else:
            assert got == want, (got, want)
    assert port[-1][1] == "cuda"
    assert [p[0] for p in ref[6:15]] == ["use_tiling", "decode_window", "decode_batched",
                                         "stream_decode", "text_encoder", "flow_cache",
                                         "mesh", "mesh_axis", "reuse_decoder_cache"]
    ref = _params(jax_serve.InteractiveSession.__init__, 1)
    assert _params(TorchSession.__init__, 1) == ref
    assert [p[0] for p in ref[:3]] == ["pipe", "guidance_scale", "video_guidance_scale"]


def _tiny_pipeline(*args, **kwargs):
    params = random_params(TMMDiTConfig(**MCFG), TVAEConfig.tiny(), dtype=torch.float32,
                           seed=0, device="cpu")
    embeds = random_text_embeds(0, action_vocabulary(), joint_dim=24, pooled_dim=16)
    return TorchPipeline(TPipelineConfig(), TMMDiTConfig(**MCFG), TVAEConfig.tiny(), params,
                         embeds, *args, **kwargs)


def test_pipeline_takes_a_deepv_tpu_call():
    """A deepv_tpu-style construction builds the port's pipeline on the CPU:
    dtype, use_tiling and decode_window by position in deepv_tpu's order,
    decode_batched and mesh_axis by keyword among deepv_tpu's others;
    decode_batched=True builds and is kept."""
    pipe = _tiny_pipeline(torch.float32, False, 3, decode_batched=False, stream_decode=False,
                          flow_cache="skip_odd", mesh=None, mesh_axis="tp", device="cpu")
    assert (pipe.dtype, pipe.decode_window, pipe.stream_decode, pipe.flow_cache,
            pipe.mesh_axis) == (torch.float32, 3, False, "skip_odd", "tp")
    assert not pipe.decode_batched
    pipe = _tiny_pipeline(torch.float32, decode_batched=True, stream_decode=False, device="cpu")
    assert pipe.decode_batched and not pipe.stream_decode


def _one_chunk(pipe, batch, key_or_noise, image):
    """The first chunk of ``generate`` with linear guidance: ``image`` is
    the [1, 3, 1, H, W] input ``generate`` makes, the motion prompts the
    chunk's, no carry."""
    prompts = list(batch["prompt"])
    motion = [prompts[0]] + prompts[1:pipe.cfg.max_temporal_length]
    out = pipe.generate_i2v(key_or_noise, motion, True, image, None, None, None, **LINEAR)
    return dict(zip(KEYS, out[:4]))


@pytest.fixture(scope="module")
def chunks():
    params = random_params(TMMDiTConfig(**MCFG), TVAEConfig.tiny(), dtype=torch.float64,
                           seed=0, device="cpu")
    params = {k: jax.tree.map(lambda a: a.numpy(), v) for k, v in params.items()}
    embeds = random_text_embeds(0, action_vocabulary(), joint_dim=24, pooled_dim=16)

    def reference_chunk(self, batch, seed):
        # generate's first key split, then one generate_i2v
        _, k_chunk = jax.random.split(jax.random.PRNGKey(seed))
        image = jnp.asarray(batch["img"])[:, :, None].astype(self.dtype)
        return _one_chunk(self, batch, k_chunk, image)

    with jax.enable_x64(), pytest.MonkeyPatch.context() as mp:
        # the reference pipeline's config, cut to UNITS units a chunk
        mp.setattr(test_torch_port_pipeline, "PipelineConfig",
                   lambda: PipelineConfig(max_temporal_length=UNITS))
        ref, draws, _ = _run_reference(
            params, embeds, patches=[(jax_pipeline.InferencePipeline, "generate",
                                      reference_chunk)])
    pipe = TorchPipeline(TPipelineConfig(max_temporal_length=UNITS), TMMDiTConfig(**MCFG),
                         TVAEConfig.tiny(), params, embeds, dtype=torch.float64, device="cpu")
    guidance = []
    unit = pipe._generate_one_unit

    def spy(*args, **kwargs):
        guidance.append(kwargs["guidance"])
        return unit(*args, **kwargs)

    pipe._generate_one_unit = spy
    noise = ReplayNoise(draws)
    batch = _batch()
    with torch.inference_mode():
        out = _one_chunk(pipe, batch, noise,
                         torch.from_numpy(batch["img"])[:, :, None].to(pipe.dtype))
    return ref, out, noise, guidance


def test_linear_guidance_decays_per_unit(chunks):
    """Units 1-3 of the first chunk take max(4 - unit, 1.1)."""
    _, _, noise, guidance = chunks
    assert guidance == [max(4.0 - u, 1.1) for u in range(1, UNITS + 1)], guidance
    assert all(not q for q in noise.queues.values()), {k: len(q) for k, q in noise.queues.items()}


@pytest.mark.parametrize("key", KEYS)
def test_linear_guidance_chunk_matches_deepv_tpu(chunks, key):
    ref, out, _, _ = chunks
    got = out[key].numpy()
    assert got.shape == ref[key].shape and np.isfinite(got).all()
    np.testing.assert_allclose(got, ref[key], rtol=0, atol=ATOL)
