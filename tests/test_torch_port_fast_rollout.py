"""The ``--fast`` composition against deepv_tpu: a 2-chunk f64 tiny rollout
with flow caching "skip_odd", the W8A8 denoise linears and the int8 VAE conv.

Both packages run the configuration of tests/test_torch_port_pipeline.py
(11 actions, the same parameters and embeddings, deepv_tpu's recorded draws
replayed), with three changes that make the int8 paths run and agree:

  * the image is 64x128, not 64x64: ``torch._int_mm``'s rule wants more than
    16 rows, and the 64x64 rollout's stage-0 products have 16 (8 one-token
    frames x 2 CFG rows); at 64x128 they have 32;
  * ``MIN_H`` is lowered to 64 in both packages, so the VAE's top level
    (64 pixels high here) takes the int8 conv, as 384x512 does at 256;
  * deepv_tpu's denoise stages and VAE windows run op by op
    (``jax.disable_jit``). XLA's fused programs round the f64 activations
    that feed each quantiser differently from op-by-op evaluation (by ~1e-15),
    and a quantiser turns a rare one of those into a one-unit int8 flip,
    which the random weights amplify to ~1e-2 (ROADMAP.md section 3 records
    it). Evaluated op by op, deepv_tpu quantises exactly what the port does.

Tolerance: the f64 rollout's ``ATOL = 1e-6``.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax

import deepv_tpu.ops.causal_conv as jax_causal_conv
import deepv_tpu.ops.conv_int8 as jax_conv_int8
import deepv_tpu.pipeline as jax_pipeline
from deepv_tpu.actions import action_vocabulary
from deepv_tpu.config import VAEConfig
from deepv_tpu.io.text_embeds import random_text_embeds

from deepv_tpu_torch.config import (MMDiTConfig as TMMDiTConfig,
                                    PipelineConfig as TPipelineConfig,
                                    VAEConfig as TVAEConfig)
from deepv_tpu_torch.io.weights import random_params
from deepv_tpu_torch.ops import causal_conv, conv_int8, linear_int8
from deepv_tpu_torch.pipeline import InferencePipeline as TorchPipeline

from test_torch_port_pipeline import ATOL, MCFG, ReplayNoise, _batch, _run_reference

torch.set_num_threads(1)

#: the fast rollout's image: 64 pixels high (the int8 level) and wide enough
#: for more than 16 rows in every int8 product
SIZE = (64, 128)
#: deepv_tpu's denoise and VAE programs called by its pipeline
EAGER = ("_denoise_stage", "_dec_window", "_dec_prime_warm", "chunk_decode",
         "chunk_decode_cont", "vae_decode", "vae_encode")
KEYS = ("pred_img", "pred_disparity", "trans3d", "trans2d")


def op_by_op(fn):
    """``fn`` run op by op (``jax.disable_jit``)."""
    def wrapped(*args, **kwargs):
        with jax.disable_jit():
            return fn(*args, **kwargs)
    return wrapped


def rollout_pair(conv_impl="xla", min_h=None, size=(64, 64), eager=False, **pipe_kwargs):
    """deepv_tpu's and the port's 2-chunk f64 rollouts of a ``size`` image
    with ``pipe_kwargs``; ``eager`` runs deepv_tpu's denoise stages and VAE
    windows op by op. Returns (reference outputs, reference history index,
    port outputs, the port's noise source, the port's pipeline, convs routed
    to int8 in deepv_tpu's traces and in the port)."""
    vcfg_t = dataclasses.replace(TVAEConfig.tiny(), conv_impl=conv_impl)
    params = random_params(TMMDiTConfig(**MCFG), vcfg_t, dtype=torch.float64, seed=0,
                           device="cpu")
    params = {k: jax.tree.map(lambda a: a.numpy(), v) for k, v in params.items()}
    embeds = random_text_embeds(0, action_vocabulary(), joint_dim=24, pooled_dim=16)
    routed = {"deepv_tpu": 0, "port": 0}
    jax_orig, port_orig = jax_causal_conv.conv3d_int8, causal_conv.conv3d_int8

    def jax_spy(*a, **k):
        routed["deepv_tpu"] += 1
        return jax_orig(*a, **k)

    def port_spy(*a, **k):
        routed["port"] += 1
        return port_orig(*a, **k)

    with pytest.MonkeyPatch.context() as mp:
        if min_h is not None:
            mp.setattr(jax_conv_int8, "MIN_H", min_h)
            mp.setattr(conv_int8, "MIN_H", min_h)
        mp.setattr(jax_causal_conv, "conv3d_int8", jax_spy)
        mp.setattr(causal_conv, "conv3d_int8", port_spy)
        patches = [(jax_pipeline, name, op_by_op(getattr(jax_pipeline, name)))
                   for name in EAGER] if eager else []
        with jax.enable_x64():
            ref, draws, ref_index = _run_reference(
                params, embeds, dataclasses.replace(VAEConfig.tiny(), conv_impl=conv_impl),
                _batch(*size), patches, **pipe_kwargs)
        pipe = TorchPipeline(TPipelineConfig(), TMMDiTConfig(**MCFG), vcfg_t, params, embeds,
                             dtype=torch.float64, device="cpu", **pipe_kwargs)
        noise = ReplayNoise(draws)
        out = pipe.generate(_batch(*size), seed=9, noise=noise)
    jax.clear_caches()
    return ref, ref_index, out, noise, pipe, routed


def check_rollout(ref, ref_index, out, noise):
    """Layout, draws, outputs within ATOL and the history index."""
    assert tuple(out["pred_img"].shape) == ref["pred_img"].shape
    assert tuple(out["pred_img"].shape[:3]) == (1, 3, 89)
    assert all(not q for q in noise.queues.values()), {k: len(q) for k, q in noise.queues.items()}
    for key in KEYS:
        got = out[key].numpy()
        assert np.isfinite(got).all(), key
        np.testing.assert_allclose(got, ref[key], rtol=0, atol=ATOL, err_msg=key)
    assert out["history_index"] == ref_index and len(ref_index) == 1


@pytest.fixture(scope="module")
def fast():
    linear_int8.calls = 0
    result = rollout_pair(conv_impl="int8", min_h=64, size=SIZE, eager=True,
                          flow_cache="skip_odd", denoise_int8=True)
    return result + (linear_int8.calls,)


def test_fast_rollout_matches_deepv_tpu(fast):
    ref, ref_index, out, noise, _, _, _ = fast
    check_rollout(ref, ref_index, out, noise)


def test_fast_rollout_runs_the_int8_paths(fast):
    """Both packages routed VAE convs to int8; the port ran every forward's
    21 quantised linears (12 in the first block, 9 in the context-pre-only
    last one) through the int8 product, and skip_odd ran steps 0, 2, 4."""
    _, _, _, _, pipe, routed, int_mm_calls = fast
    assert routed["deepv_tpu"] > 0 and routed["port"] > 0, routed
    assert set(pipe.recompute_log) == {(1, 0, 1, 0, 1)}
    forwards = sum(map(sum, pipe.recompute_log))
    assert forwards == 12 * 3 * 3
    assert int_mm_calls == forwards * 21
