"""The port's MMDiT against deepv_tpu's, in float64.

``MMDiTConfig.tiny()``-sized (the tests/test_pipeline.py:21-26 config, 14
input channels), parameters from deepv_tpu's init carried over by
``params_from_numpy``. One ``mmdit_forward`` over the rollout's
``padded_conditions`` layout at every pyramid stage, with 2 CFG rows and
with 3 rows plus history, at atol 1e-8: both run the same f64 formulas and
differ by f64 rounding only (~1e-15 measured), with the attention mask's
-1e30 fill (port) against -inf (deepv_tpu's jnp path) giving exactly zero
weight either way.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deepv_tpu.config import MMDiTConfig, PipelineConfig
from deepv_tpu.models.mmdit import init_mmdit_params, mmdit_forward as jax_forward
from deepv_tpu.pipeline import _pyramid_list as jax_pyramid, padded_conditions as jax_padded

from deepv_tpu_torch.config import MMDiTConfig as TMMDiTConfig, PipelineConfig as TPipelineConfig
from deepv_tpu_torch.io.weights import flatten_tree, params_from_numpy
from deepv_tpu_torch.models.mmdit import MMDiT, mmdit_forward as port_forward
from deepv_tpu_torch.pipeline import _pyramid_list as port_pyramid, padded_conditions as port_padded

torch.set_num_threads(1)

MCFG = dict(sample_size=16, patch_size=2, in_channels=14, num_layers=2,
            attention_head_dim=8, num_attention_heads=4, caption_projection_dim=32,
            pooled_projection_dim=16, pos_embed_max_size=32, joint_attention_dim=24)
ATOL = 1e-8


def correctly_rounded(fn):
    """``fn`` evaluated for float32 inputs in f64 and rounded to f32, as the
    port evaluates the timestep embedding's exp/cos/sin: XLA's f32 versions
    are off by ulps that t ~ 1000 scales to ~3e-5 (test_torch_port_ops
    compares the unpatched f32 embeddings at that tolerance)."""
    def wrapped(x, *args, **kwargs):
        if getattr(x, "dtype", None) == jnp.float32:
            return fn(jnp.asarray(x).astype(jnp.float64), *args, **kwargs).astype(jnp.float32)
        return fn(x, *args, **kwargs)
    return wrapped


def reference_forward(tree, *args, **kwargs):
    """deepv_tpu's forward, jitted (its eager op-by-op dispatch is ~4x
    slower here)."""
    fwd = jax.jit(jax_forward, static_argnums=0)
    return np.asarray(fwd(MMDiTConfig(**MCFG), jax.tree.map(jnp.asarray, tree), *args, **kwargs))


@pytest.fixture(scope="module")
def models():
    jax.clear_caches()   # no program traced without this module's f32 patch
    with jax.enable_x64():
        tree = init_mmdit_params(jax.random.PRNGKey(0), MMDiTConfig(**MCFG))
        tree = jax.tree.map(lambda a: np.asarray(a, np.float64), tree)
    return tree, params_from_numpy(MMDiT(TMMDiTConfig(**MCFG)), tree)


def test_state_dict_keys_are_the_tree_paths(models):
    tree, model = models
    flat = flatten_tree(tree)
    assert set(model.state_dict()) == set(flat)
    assert "transformer_blocks.1.attn.to_q.weight" in flat
    assert "transformer_blocks.1.attn.to_add_out.weight" not in flat   # last block
    for k, v in model.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), flat[k])


def _inputs(rows, stage, seed):
    rng = np.random.default_rng(seed)
    gen = rng.standard_normal((1, 14, 5, 8, 8))
    lat = rng.standard_normal((1, 14, 1) + (8 // 2 ** (2 - stage),) * 2)
    text = rng.standard_normal((rows, 77, 24))
    mask = np.zeros((rows, 77), np.int32)
    mask[0, :2] = 1
    mask[1:, :11] = 1
    pooled = rng.standard_normal((rows, 16))
    t = np.full((rows,), 700.0, np.float32)
    hist = rng.standard_normal((3, 14, 1, 8, 8)) if rows == 3 else None
    return gen, lat, text, mask, pooled, t, hist


@pytest.mark.parametrize("stage", [0, 1, 2])
@pytest.mark.parametrize("rows", [2, 3])
def test_forward_matches_reference(models, rows, stage):
    tree, model = models
    gen, lat, text, mask, pooled, t, hist = _inputs(rows, stage, seed=10 * rows + stage)
    unit, fm = (3, True) if rows == 2 else (5, False)
    hmask = np.array([[0] * 4, [0] * 4, [1] * 4], np.int32) if rows == 3 else None
    with jax.enable_x64(), pytest.MonkeyPatch.context() as mp:
        for name in ("exp", "cos", "sin"):
            mp.setattr(jnp, name, correctly_rounded(getattr(jnp, name)))
        clips, times, valid = jax_padded(PipelineConfig(), jax_pyramid(jnp.asarray(gen), 2),
                                         unit, fm, rows)[stage]
        ref = reference_forward(
            tree, list(clips) + [jnp.asarray(np.concatenate([lat] * rows))],
            jnp.asarray(text), jnp.asarray(mask), jnp.asarray(pooled), jnp.asarray(t),
            history=None if hist is None else jnp.asarray(hist),
            history_mask=None if hmask is None else jnp.asarray(hmask),
            frame_times=list(times), frame_valid=list(valid))
    clips, times, valid = port_padded(TPipelineConfig(), port_pyramid(torch.from_numpy(gen), 2),
                                      unit, fm, rows)[stage]
    out = port_forward(model, list(clips) + [torch.from_numpy(np.concatenate([lat] * rows))],
                       torch.from_numpy(text), torch.from_numpy(mask), torch.from_numpy(pooled),
                       torch.from_numpy(t),
                       history=None if hist is None else torch.from_numpy(hist),
                       history_mask=None if hmask is None else torch.from_numpy(hmask),
                       frame_times=list(times), frame_valid=list(valid), split_last_attn=True)
    assert tuple(out.shape) == ref.shape == (rows, 14, 1) + lat.shape[-2:]
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=ATOL)


def test_static_layout_forward(models):
    """Without frame times every frame is valid and frames count up."""
    tree, model = models
    rng = np.random.default_rng(3)
    clips = [rng.standard_normal((2, 14, 2, 4, 4)), rng.standard_normal((2, 14, 1, 8, 8))]
    text, pooled = rng.standard_normal((2, 77, 24)), rng.standard_normal((2, 16))
    mask = np.ones((2, 77), np.int32)
    t = np.array([10.0, 900.0], np.float32)
    with jax.enable_x64(), pytest.MonkeyPatch.context() as mp:
        for name in ("exp", "cos", "sin"):
            mp.setattr(jnp, name, correctly_rounded(getattr(jnp, name)))
        ref = reference_forward(tree, [jnp.asarray(c) for c in clips], jnp.asarray(text),
                                jnp.asarray(mask), jnp.asarray(pooled), jnp.asarray(t))
    out = port_forward(model, [torch.from_numpy(c) for c in clips], torch.from_numpy(text),
                       torch.from_numpy(mask), torch.from_numpy(pooled), torch.from_numpy(t))
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=ATOL)
