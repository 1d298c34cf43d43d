"""The port's slice as a whole: a 2-chunk tiny rollout against deepv_tpu.

Both packages run the ``tiny_pipeline`` configuration of
tests/test_pipeline.py at 64x64 in float64 over the 11-action prompt (two
chunks: priming, the carry re-encode, history retrieval and the 3-row CFG),
with the same parameters and text embeddings. deepv_tpu's Gaussian draws are
recorded with monkeypatch (initial latents, block-noise z, VAE posterior
eps) and replayed through the port's noise source.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import deepv_tpu.pipeline as jax_pipeline
from deepv_tpu.actions import action_vocabulary, prepare_motion_prompts
from deepv_tpu.config import MMDiTConfig, PipelineConfig, VAEConfig
from deepv_tpu.io.text_embeds import random_text_embeds
from deepv_tpu.ops.block_noise import block_cholesky

from deepv_tpu_torch.config import (MMDiTConfig as TMMDiTConfig,
                                    PipelineConfig as TPipelineConfig,
                                    VAEConfig as TVAEConfig)
from deepv_tpu_torch import raymap as port_raymap
from deepv_tpu_torch.io.weights import random_params
from deepv_tpu_torch.pipeline import InferencePipeline as TorchPipeline

torch.set_num_threads(1)

PROMPT = "(FN)(FN)(FN)(FN)(FN)(FN)(FN)(fRL)(SR)(BL)(FN)"
MCFG = dict(sample_size=16, patch_size=2, in_channels=14, num_layers=2,
            attention_head_dim=8, num_attention_heads=4, caption_projection_dim=32,
            pooled_projection_dim=16, pos_embed_max_size=32, joint_attention_dim=24)
# the test_pipeline.py:231 precedent for f64 rollouts compared end to end
ATOL = 1e-6


def correctly_rounded(fn):
    """``fn`` (a jnp transcendental) evaluated for float32 inputs in f64 and
    rounded to f32, as the port evaluates its f32 exp/cos/sin/arccos. XLA's
    and PyTorch's f32 versions are not correctly rounded and differ by ulps,
    which the rollout's random weights amplify ~1000x (t ~ 1000 alone turns
    one ulp of the timestep frequencies into ~3e-5 of embedding)."""
    def wrapped(x, *args, **kwargs):
        if getattr(x, "dtype", None) == jnp.float32:
            return fn(jnp.asarray(x).astype(jnp.float64), *args, **kwargs).astype(jnp.float32)
        return fn(x, *args, **kwargs)
    return wrapped


def euler_step_fused(sample, velocity, dsigma):
    """deepv_tpu's f32 Euler update as one fused multiply-add (formed in f64,
    rounded once), the port's form. XLA contracts it into an FMA too, but
    whether it does depends on the fusion it picks."""
    f32, f64 = jnp.float32, jnp.float64
    out = (dsigma.astype(f32).astype(f64) * velocity.astype(f32).astype(f64)
           + sample.astype(f32).astype(f64))
    return out.astype(f32).astype(velocity.dtype)


def renoise_fused(latents, z, alpha, beta, gamma):
    """deepv_tpu's _renoise (nearest 2x upsample + block noise) in the port's
    f32 rounding order, in numpy: the block transform summed pairwise, then
    ``fma(alpha, up, beta * noise)``. XLA's order for the same expression
    changes with the array shape (measured: FMA on the alpha or the beta
    term, by size)."""
    lat = np.asarray(latents)
    b, c, t, h, w = lat.shape
    up = np.repeat(np.repeat(lat, 2, axis=-2), 2, axis=-1).astype(np.float32)
    Lt = block_cholesky(gamma).T.astype(np.float32)
    p = np.asarray(z)[..., :, None] * Lt
    blocks = (p[..., 0, :] + p[..., 1, :]) + (p[..., 2, :] + p[..., 3, :])
    noise = blocks.reshape(b, c, t, h, w, 2, 2).transpose(0, 1, 2, 3, 5, 4, 6)
    noise = noise.reshape(b, c, t, 2 * h, 2 * w)
    a32, b32 = np.float32(alpha), np.float32(beta)
    out = a32.astype(np.float64) * up + (b32 * noise).astype(np.float64)
    return jnp.asarray(out.astype(np.float32).astype(lat.dtype))


def via_port(fn):
    """A deepv_tpu call site routed through the port's function on numpy
    copies (eager f32 code whose reductions XLA orders by shape)."""
    def wrapped(*args, **kwargs):
        conv = lambda a: torch.from_numpy(np.array(a)) if hasattr(a, "shape") else a
        out = fn(*[conv(a) for a in args], **{k: conv(v) for k, v in kwargs.items()})
        if isinstance(out, tuple):
            return tuple(jnp.asarray(o.numpy()) for o in out)
        return jnp.asarray(out.numpy())
    return wrapped


def f32_via_torch(jnp_fn, torch_fn):
    """A jnp function whose concrete float32 calls run through the torch
    function the port calls at the same place (the 4x4 pose algebra:
    inverse and einsum); every other call is deepv_tpu's own."""
    def wrapped(*args, **kwargs):
        arrays = [a for a in args if hasattr(a, "dtype")]
        if not kwargs and arrays and all(a.dtype == jnp.float32 and not isinstance(a, jax.core.Tracer)
                          for a in arrays):
            conv = lambda a: torch.from_numpy(np.array(a)) if hasattr(a, "dtype") else a
            return jnp.asarray(torch_fn(*[conv(a) for a in args]).numpy())
        return jnp_fn(*args, **kwargs)
    return wrapped


def norm_via_torch(jnp_norm):
    """jnp.linalg.norm whose concrete float32 calls run through
    torch.linalg.vector_norm, as the port's (the 3-vector norms of the
    retrieval distances and the history raymap)."""
    def wrapped(x, ord=None, axis=None, keepdims=False):
        if ord is None and x.dtype == jnp.float32 and not isinstance(x, jax.core.Tracer):
            out = torch.linalg.vector_norm(torch.from_numpy(np.array(x)), dim=axis,
                                           keepdim=keepdims)
            return jnp.asarray(out.numpy())
        return jnp_norm(x, ord=ord, axis=axis, keepdims=keepdims)
    return wrapped


class ReplayNoise:
    """The port's noise source, replaying recorded draws in order per kind."""

    def __init__(self, draws):
        self.queues = {k: list(v) for k, v in draws.items()}

    def normal(self, kind, shape, dtype):
        a = self.queues[kind].pop(0)
        assert a.shape == tuple(shape), (kind, a.shape, shape)
        return torch.from_numpy(a).to(dtype)


def _batch(height=64, width=64):
    img = np.random.default_rng(7).uniform(-1.0, 1.0, (1, 3, height, width))
    return {"img": img, "prompt": np.array(prepare_motion_prompts("action", PROMPT)),
            "prompt_type": "action"}


def _run_reference(params, embeds, vcfg=None, batch=None, patches=(), **pipe_kwargs):
    """deepv_tpu's rollout of ``batch`` (default ``_batch()``) with its
    concrete Gaussian draws recorded (traced calls inside jitted programs
    pass straight through); ``vcfg`` defaults to ``VAEConfig.tiny()``,
    ``patches`` are extra (object, name, value) pins and ``pipe_kwargs`` go
    to its ``InferencePipeline`` (the fast modes)."""
    draws = {"latents": [], "block": [], "posterior": []}
    slices = []
    orig_normal = jax.random.normal
    orig_gaussian = jax_pipeline.gaussian_sample
    orig_slice = jax.lax.dynamic_slice_in_dim
    in_posterior = [False]

    def normal(key, shape=(), dtype=float, *args, **kwargs):
        out = orig_normal(key, shape, dtype, *args, **kwargs)
        if not isinstance(out, jax.core.Tracer) and not in_posterior[0]:
            draws["latents"].append(np.asarray(out))
        return out

    def renoise(latents, key, alpha, beta, gamma):
        b, c, t, h, w = latents.shape
        z = np.asarray(orig_normal(key, (b, c, t, h, w, 4), jnp.float32))
        draws["block"].append(z)
        return renoise_fused(latents, z, alpha, beta, gamma)

    def gaussian_sample(moments, key):
        if not isinstance(key, jax.core.Tracer):
            shape = (moments.shape[0], moments.shape[1] // 2) + tuple(moments.shape[2:])
            draws["posterior"].append(np.asarray(orig_normal(key, shape, moments.dtype)))
        in_posterior[0] = True
        try:
            return orig_gaussian(moments, key)
        finally:
            in_posterior[0] = False

    def dynamic_slice_in_dim(operand, start, *args, **kwargs):
        if not isinstance(start, jax.core.Tracer):
            slices.append(int(start))
        return orig_slice(operand, start, *args, **kwargs)

    pipe = jax_pipeline.InferencePipeline(PipelineConfig(), MMDiTConfig(**MCFG),
                                          vcfg or VAEConfig.tiny(),
                                          jax.tree.map(jnp.asarray, params), embeds,
                                          dtype=jnp.float64, **pipe_kwargs)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.random, "normal", normal)
        mp.setattr(jax_pipeline, "_renoise", renoise)
        mp.setattr(jax_pipeline, "euler_step", euler_step_fused)
        mp.setattr(jax_pipeline, "raymap_to_camera", via_port(port_raymap.raymap_to_camera))
        mp.setattr(jax_pipeline, "raymap_from_camera_batch",
                   via_port(port_raymap.raymap_from_camera_batch))
        mp.setattr(jnp.linalg, "inv", f32_via_torch(jnp.linalg.inv, torch.linalg.inv))
        mp.setattr(jnp, "einsum", f32_via_torch(jnp.einsum, torch.einsum))
        mp.setattr(jnp.linalg, "norm", norm_via_torch(jnp.linalg.norm))
        mp.setattr(jax_pipeline, "gaussian_sample", gaussian_sample)
        mp.setattr(jax.lax, "dynamic_slice_in_dim", dynamic_slice_in_dim)
        for name in ("exp", "cos", "sin", "arccos"):
            mp.setattr(jnp, name, correctly_rounded(getattr(jnp, name)))
        for obj, name, value in patches:
            mp.setattr(obj, name, value)
        jax.clear_caches()   # programs traced before the patch must not be reused
        out = pipe.generate(_batch() if batch is None else batch, seed=9)
        out = {k: (np.asarray(v) if k != "motion_prompt_list" else v) for k, v in out.items()}
    jax.clear_caches()
    # _retrieve_history slices 4 arrays per boundary at the retrieved index
    return out, draws, slices[::4]


@pytest.fixture(scope="module")
def rollouts():
    # one parameter tree for both, drawn by the port's random_params (the
    # same tree structure as deepv_tpu's init, which eager JAX takes ~30 s
    # to build here); deepv_tpu reads it as numpy
    params = random_params(TMMDiTConfig(**MCFG), TVAEConfig.tiny(), dtype=torch.float64,
                           seed=0, device="cpu")
    params = {k: jax.tree.map(lambda a: a.numpy(), v) for k, v in params.items()}
    embeds = random_text_embeds(0, action_vocabulary(), joint_dim=24, pooled_dim=16)
    with jax.enable_x64():
        ref, draws, ref_index = _run_reference(params, embeds)
    pipe = TorchPipeline(TPipelineConfig(), TMMDiTConfig(**MCFG), TVAEConfig.tiny(), params,
                         embeds, dtype=torch.float64, device="cpu")
    noise = ReplayNoise(draws)
    out = pipe.generate(_batch(), seed=9, noise=noise)
    return ref, ref_index, out, noise


def test_rollout_layout(rollouts):
    ref, _, out, noise = rollouts
    assert tuple(out["pred_img"].shape) == ref["pred_img"].shape == (1, 3, 89, 64, 64)
    assert tuple(out["trans3d"].shape) == ref["trans3d"].shape == (1, 12, 4, 4)
    assert [len(m) for m in out["motion_prompt_list"]] == [8, 4]
    # every recorded draw was consumed, in the same order and shapes
    assert all(not q for q in noise.queues.values()), {k: len(q) for k, q in noise.queues.items()}


@pytest.mark.parametrize("key", ["pred_img", "pred_disparity", "trans3d", "trans2d"])
def test_rollout_matches_reference(rollouts, key):
    ref, _, out, _ = rollouts
    got = out[key].numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, ref[key], rtol=0, atol=ATOL)


def test_history_index_matches_reference(rollouts):
    _, ref_index, out, _ = rollouts
    assert out["history_index"] == ref_index and len(ref_index) == 1
