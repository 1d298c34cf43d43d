"""Flow caching (``pipeline._stage_scan`` with a recompute mask and the
adaptive bound) against deepv_tpu's ``_denoise_stage``, in float64.

One chunk-1 unit's stages at the tiny configuration of
tests/test_torch_port_pipeline.py, with the same parameters, conditions and
latents, and deepv_tpu's Euler step and timestep embedding pinned to the
port's rounding as there. deepv_tpu decides inside its jitted scan, so its
decisions are read by a ``jax.debug.callback`` on the forwards it runs.
Tolerance: 1e-9 on the stage's latents (f64 formulas on both sides, with
the f32 Euler update and embedding pinned).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import deepv_tpu.pipeline as jax_pipeline
from deepv_tpu.actions import action_vocabulary
from deepv_tpu.config import MMDiTConfig, PipelineConfig, VAEConfig
from deepv_tpu.io.text_embeds import random_text_embeds
from deepv_tpu.models.scheduler import FlowMatchSchedule as JaxSchedule

from deepv_tpu_torch.config import (MMDiTConfig as TMMDiTConfig,
                                    PipelineConfig as TPipelineConfig,
                                    VAEConfig as TVAEConfig)
from deepv_tpu_torch.io.weights import params_from_numpy, random_params
from deepv_tpu_torch.models.mmdit import MMDiT
from deepv_tpu_torch.models.scheduler import FlowMatchSchedule
from deepv_tpu_torch import pipeline as port_pipeline

from test_torch_port_pipeline import MCFG, correctly_rounded, euler_step_fused

torch.set_num_threads(1)

ATOL = 1e-9
MODES = ("none", "skip_odd", "adaptive:0.5", "adaptive:0")
STAGES = (0, 1, 2)
TAU = {"adaptive:0.5": 0.5, "adaptive:0": 0.0}
MALFORMED = ("adaptive=0.5", "adaptive_0.05", "adaptive:", "skip_even", "adaptive:x")


def _inputs(stage):
    """Unit 3 of chunk 1 (2 CFG rows, first-frame mask) at ``stage``: the
    generated latents so far, the stage's noisy latent and the text rows."""
    rng = np.random.default_rng(20 + stage)
    gen = rng.standard_normal((1, 14, 4, 8, 8))
    lat = rng.standard_normal((1, 14, 1) + (8 // 2 ** (2 - stage),) * 2)
    embeds = random_text_embeds(0, action_vocabulary(), joint_dim=24, pooled_dim=16)
    e, n = embeds[action_vocabulary()[1]], embeds["empty"]
    text = np.concatenate([n["prompt_embeds"], e["prompt_embeds"]]).astype(np.float64)
    mask = np.concatenate([n["prompt_attention_mask"], e["prompt_attention_mask"]])
    pooled = np.concatenate([n["pooled_prompt_embeds"], e["pooled_prompt_embeds"]])
    return gen, lat, text, mask, pooled.astype(np.float64)


def _mask(flow_cache, n):
    if flow_cache == "skip_odd":
        return tuple(1 - i % 2 for i in range(n))
    return (1,) + (0,) * (n - 1) if flow_cache.startswith("adaptive") else ()


def _reference(tree, stage, flow_cache):
    """deepv_tpu's _denoise_stage, and the timesteps whose forward ran."""
    gen, lat, text, mask, pooled = _inputs(stage)
    ss = JaxSchedule(PipelineConfig().scheduler).stage_schedule(
        PipelineConfig().num_inference_steps, stage)
    ran = []
    orig = jax_pipeline.mmdit_forward

    def spy(*args, **kwargs):
        jax.debug.callback(lambda t: ran.append(float(t[0])), args[6])
        return orig(*args, **kwargs)

    with jax.enable_x64(), pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_pipeline, "mmdit_forward", spy)
        mp.setattr(jax_pipeline, "euler_step", euler_step_fused)
        for name in ("exp", "cos", "sin"):
            mp.setattr(jnp, name, correctly_rounded(getattr(jnp, name)))
        jax.clear_caches()
        clips, times, valid = jax_pipeline.padded_conditions(
            PipelineConfig(), jax_pipeline._pyramid_list(jnp.asarray(gen), 2), 3, True, 2)[stage]
        tau = TAU.get(flow_cache)
        out = jax_pipeline._denoise_stage(
            MMDiTConfig(**MCFG), jax.tree.map(jnp.asarray, tree), clips, times, valid,
            jnp.asarray(lat), jnp.asarray(text), jnp.asarray(mask, jnp.int32),
            jnp.asarray(pooled), jnp.asarray(ss.timesteps),
            jnp.asarray(ss.sigmas[1:] - ss.sigmas[:-1]), jnp.float32(3.5), jnp.float32(1.0),
            None, None, num_rows=2, history_downsample_ratio=2, zero_depth=False,
            attn_impl="ref", recompute=_mask(flow_cache, len(ss.timesteps)),
            adaptive_tau=None if tau is None else jnp.float32(tau))
        out = np.asarray(out)
    jax.clear_caches()
    return out, tuple(int(float(t) in ran) for t in ss.timesteps)


def _port(model, stage, flow_cache):
    gen, lat, text, mask, pooled = _inputs(stage)
    ss = FlowMatchSchedule(TPipelineConfig().scheduler).stage_schedule(
        TPipelineConfig().num_inference_steps, stage)
    clips, times, valid = port_pipeline.padded_conditions(
        TPipelineConfig(), port_pipeline._pyramid_list(torch.from_numpy(gen), 2), 3, True,
        2)[stage]
    with torch.inference_mode():
        return port_pipeline._stage_scan(
            model, clips, times, valid, torch.from_numpy(lat), torch.from_numpy(text),
            torch.from_numpy(mask.astype(np.int32)), torch.from_numpy(pooled),
            torch.as_tensor(ss.timesteps), torch.as_tensor(ss.sigmas[1:] - ss.sigmas[:-1]),
            3.5, 1.0, None, None, 2, 2, False, _mask(flow_cache, len(ss.timesteps)),
            port_pipeline.parse_flow_cache(flow_cache))


@pytest.fixture(scope="module")
def stages():
    tree = random_params(TMMDiTConfig(**MCFG), TVAEConfig.tiny(), dtype=torch.float64, seed=0,
                         device="cpu")["mmdit"]
    model = params_from_numpy(MMDiT(TMMDiTConfig(**MCFG)), tree)
    tree = jax.tree.map(lambda a: a.numpy(), tree)
    out = {}
    for stage in STAGES:
        for mode in MODES:
            lat, ran = _port(model, stage, mode)
            out[mode, stage] = (lat.numpy(), ran) + (
                _reference(tree, stage, mode) if mode != "adaptive:0" else (None, None))
    return out


@pytest.mark.parametrize("stage", STAGES)
@pytest.mark.parametrize("mode", MODES[:3])
def test_stage_matches_deepv_tpu(stages, mode, stage):
    """The stage's latents, and the sequence of forwards run or skipped."""
    lat, ran, ref, ref_ran = stages[mode, stage]
    assert ran == ref_ran
    np.testing.assert_allclose(lat, ref, rtol=0, atol=ATOL)


def test_skip_odd_and_adaptive_decisions(stages):
    """skip_odd runs steps 0, 2 and 4; adaptive:0.5 skips some later steps
    and runs others across the stages; none runs all."""
    for stage in STAGES:
        assert stages["skip_odd", stage][1] == (1, 0, 1, 0, 1)
        assert stages["none", stage][1] == (1,) * 5
    later = [r for stage in STAGES for r in stages["adaptive:0.5", stage][1][1:]]
    assert 0 < sum(later) < len(later)


@pytest.mark.parametrize("stage", STAGES)
def test_adaptive_zero_is_bit_identical_to_none(stages, stage):
    lat, ran, _, _ = stages["adaptive:0", stage]
    assert ran == (1,) * 5
    np.testing.assert_array_equal(lat, stages["none", stage][0])


@pytest.mark.parametrize("bad", MALFORMED)
def test_malformed_flow_cache_raises_as_deepv_tpu(bad):
    """tests/test_pipeline.py:292's strings (and a non-numeric tau) raise
    ValueError with deepv_tpu's message, at the port's construction too."""
    with pytest.raises(ValueError) as ref:
        jax_pipeline.InferencePipeline(PipelineConfig(), MMDiTConfig.tiny(), VAEConfig.tiny(),
                                       {"mmdit": {}, "vae": {}}, {}, flow_cache=bad)
    with pytest.raises(ValueError) as got:
        port_pipeline.parse_flow_cache(bad)
    assert str(got.value) == str(ref.value)
    mcfg, vcfg = TMMDiTConfig.tiny(), TVAEConfig.tiny()
    params = random_params(mcfg, vcfg, dtype=torch.float32, device="cpu")
    with pytest.raises(ValueError, match="flow_cache"):
        port_pipeline.InferencePipeline(TPipelineConfig(), mcfg, vcfg, params, {},
                                        device="cpu", flow_cache=bad)
