"""The port's W8A8 linear (``ops/linear_int8.py``) and ``quantize_mmdit``
against deepv_tpu's ``ops/linear_int8.py``, on the CPU.

The quantised tensors and the int32 product are integers and scales
computed by the same f32 operations, so they must be bit-equal. The f32
output differs at most by deepv_tpu's FMA contraction: XLA may fuse
``acc * sx * sw + bias`` into one rounding where the port rounds the product
and the sum apart, which moves a value by at most one f32 ulp; it is pinned
by evaluating that unfused order in numpy from deepv_tpu's own integers.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deepv_tpu.ops import linear_int8 as jli

from deepv_tpu_torch.config import MMDiTConfig as TMMDiTConfig, VAEConfig as TVAEConfig
from deepv_tpu_torch.io.weights import flatten_tree, params_from_numpy, random_params
from deepv_tpu_torch.models import mmdit as port_mmdit
from deepv_tpu_torch.ops import linear_int8 as tli
from deepv_tpu_torch.ops.basic import linear

torch.set_num_threads(1)

MCFG = dict(sample_size=16, patch_size=2, in_channels=14, num_layers=3,
            attention_head_dim=8, num_attention_heads=4, caption_projection_dim=32,
            pooled_projection_dim=16, pos_embed_max_size=32, joint_attention_dim=24)


@pytest.fixture(scope="module")
def case():
    """A D -> 4D feed-forward layer: f32 weight, bias and x [2, 37, 32] from a
    numpy seed, quantised by both packages."""
    rng = np.random.default_rng(0)
    w = (rng.standard_normal((128, 32)) * 0.05).astype(np.float32)
    b = (rng.standard_normal(128) * 0.1).astype(np.float32)
    x = (rng.standard_normal((2, 37, 32)) * 2.0).astype(np.float32)
    x[0, 3] = 0.0                                 # an all-zero token: the 1e-12 clamp
    ref = jli.quantize_linear({"weight": jnp.asarray(w), "bias": jnp.asarray(b)})
    w8, sw = tli.quantize_linear(torch.from_numpy(w))
    p = torch.nn.Module()
    p.register_buffer("weight_int8", w8)
    p.register_buffer("weight_scale", sw)
    p.register_buffer("bias", torch.from_numpy(b))
    return x, ref, p


def test_weight_quantisation_is_bit_equal(case):
    _, ref, p = case
    np.testing.assert_array_equal(p.weight_int8.numpy(), np.asarray(ref["weight_int8"]))
    np.testing.assert_array_equal(p.weight_scale.numpy(), np.asarray(ref["weight_scale"]))
    assert p.weight_int8.dtype == torch.int8 and p.weight_scale.dtype == torch.float32


def _reference_tokens(x):
    """deepv_tpu's per-token quantisation (linear_int8.py:48-50)."""
    xf = jnp.asarray(x).astype(jnp.float32)
    sx = jnp.maximum(jnp.max(jnp.abs(xf), axis=-1, keepdims=True), 1e-12) / 127.0
    return np.asarray(jnp.round(xf / sx).astype(jnp.int8)), np.asarray(sx)


def test_token_quantisation_and_product_are_bit_equal(case):
    x, ref, p = case
    x8_ref, sx_ref = _reference_tokens(x)
    x8, sx = tli.quantize_tokens(torch.from_numpy(x))
    np.testing.assert_array_equal(x8.numpy(), x8_ref)
    np.testing.assert_array_equal(sx.numpy(), sx_ref)
    acc_ref = jax.lax.dot_general(jnp.asarray(x8_ref), ref["weight_int8"],
                                  (((2,), (1,)), ((), ())), preferred_element_type=jnp.int32)
    acc = tli.int_mm(x8.reshape(-1, 32), p.weight_int8.t()).reshape(2, 37, 128)
    np.testing.assert_array_equal(acc.numpy(), np.asarray(acc_ref))


def test_output_matches_deepv_tpu(case):
    """Bit-equal to the unfused order from deepv_tpu's integers, and within
    one f32 ulp of deepv_tpu's own output (its possible FMA)."""
    x, ref, p = case
    got = linear(torch.from_numpy(x), p).numpy()
    x8_ref, sx_ref = _reference_tokens(x)
    acc = x8_ref.astype(np.int64) @ np.asarray(ref["weight_int8"]).astype(np.int64).T
    unfused = ((acc.astype(np.float32) * sx_ref) * np.asarray(ref["weight_scale"])
               + np.asarray(ref["bias"]))
    np.testing.assert_array_equal(got, unfused.astype(np.float32))
    jax_out = np.asarray(jli.linear_int8(jnp.asarray(x), ref))
    np.testing.assert_array_max_ulp(got, jax_out, maxulp=1)


@pytest.mark.parametrize("m, k, n", [(16, 32, 32), (17, 12, 32), (17, 32, 20)])
def test_int_mm_pads_outside_the_cuda_shape_rule(m, k, n):
    """Shapes ``torch._int_mm`` refuses on CUDA (16 rows; k or n not a
    multiple of 8) are zero-padded, not refused and never sent to a float
    product: the int32 sums bit-equal to the int64 product and to deepv_tpu's
    ``dot_general``, the output bit-equal to the unfused order from those
    integers and within one f32 ulp of ``jli.linear_int8`` (its possible
    FMA, as in test_output_matches_deepv_tpu)."""
    rng = np.random.default_rng(m * 1000 + k * 10 + n)
    w = (rng.standard_normal((n, k)) * 0.05).astype(np.float32)
    b = (rng.standard_normal(n) * 0.1).astype(np.float32)
    x = (rng.standard_normal((m, k)) * 2.0).astype(np.float32)
    ref = jli.quantize_linear({"weight": jnp.asarray(w), "bias": jnp.asarray(b)})
    p = torch.nn.Module()
    w8, sw = tli.quantize_linear(torch.from_numpy(w))
    p.register_buffer("weight_int8", w8)
    p.register_buffer("weight_scale", sw)
    p.register_buffer("bias", torch.from_numpy(b))
    x8, sx = tli.quantize_tokens(torch.from_numpy(x))
    before = tli.calls
    acc = tli.int_mm(x8, p.weight_int8.t())
    assert tli.calls - before == 1 and acc.dtype == torch.int32 and tuple(acc.shape) == (m, n)
    x8_ref, sx_ref = _reference_tokens(x)
    exact = x8_ref.astype(np.int64) @ np.asarray(ref["weight_int8"]).astype(np.int64).T
    np.testing.assert_array_equal(acc.numpy(), exact)
    acc_ref = jax.lax.dot_general(jnp.asarray(x8_ref), ref["weight_int8"],
                                  (((1,), (1,)), ((), ())), preferred_element_type=jnp.int32)
    np.testing.assert_array_equal(acc.numpy(), np.asarray(acc_ref))
    got = tli.linear_int8(torch.from_numpy(x), p).numpy()
    unfused = ((exact.astype(np.float32) * sx_ref) * np.asarray(ref["weight_scale"])
               + np.asarray(ref["bias"]))
    np.testing.assert_array_equal(got, unfused.astype(np.float32))
    np.testing.assert_array_max_ulp(got, np.asarray(jli.linear_int8(jnp.asarray(x), ref)),
                                    maxulp=1)


@pytest.fixture(scope="module")
def quantised_tree():
    """A 3-block MMDiT tree (f32, the port's random init)."""
    return random_params(TMMDiTConfig(**MCFG), TVAEConfig.tiny(), dtype=torch.float32,
                         seed=0, device="cpu")["mmdit"]


def test_quantize_mmdit_rewrites_deepv_tpus_set(quantised_tree):
    """The port swaps exactly the linears deepv_tpu's quantize_mmdit_params
    rewrites (the last block has no to_add_out or ff_context), with the
    same integers and scales, and keeps nothing of their float weights."""
    tree = quantised_tree
    ref = jli.quantize_mmdit_params(jax.tree.map(lambda a: jnp.asarray(a.numpy()), tree),
                                    keep_original=False)
    ref_flat = flatten_tree(ref)
    model = params_from_numpy(port_mmdit.MMDiT(TMMDiTConfig(**MCFG)), tree)
    port_mmdit.quantize_mmdit(model)
    state = model.state_dict()
    ref_int8 = sorted(k for k in ref_flat if k.endswith(".weight_int8"))
    assert sorted(k for k in state if k.endswith(".weight_int8")) == ref_int8
    assert len(ref_int8) == 12 + 12 + 9
    for k in ref_int8:
        np.testing.assert_array_equal(state[k].numpy(), np.asarray(ref_flat[k]))
        scale = k.replace("weight_int8", "weight_scale")
        np.testing.assert_array_equal(state[scale].numpy(), np.asarray(ref_flat[scale]))
        assert k.replace("weight_int8", "weight") not in state
    assert sorted(state) == sorted(ref_flat)


def test_quantize_mmdit_frees_the_block_weights(quantised_tree):
    """Once the caller drops its tree, no float block weight stays alive."""
    import gc
    import weakref

    tree = {k: v for k, v in quantised_tree.items()}
    tree["transformer_blocks"] = [
        jax.tree.map(lambda a: a.clone(), blk) for blk in quantised_tree["transformer_blocks"]]
    model = params_from_numpy(port_mmdit.MMDiT(TMMDiTConfig(**MCFG)), tree)
    block = model.transformer_blocks[0]
    refs = [weakref.ref(block.attn.to_q.weight), weakref.ref(block.ff.proj.weight),
            weakref.ref(model.transformer_blocks[-1].attn.add_v_proj.weight)]
    kept = weakref.ref(block.norm1.linear.weight)          # AdaLN stays exact
    port_mmdit.quantize_mmdit(model)
    del tree, block
    gc.collect()
    assert all(r() is None for r in refs)
    assert kept() is not None


def test_denoise_int8_forward_with_sixteen_rows(quantised_tree):
    """A W8A8 forward (deepv_tpu's ``denoise_int8``) at the 64x64 tiny
    rollout's stage-0 layout with 2 CFG rows: its video-stream products
    have 16 rows, which ``torch._int_mm`` refuses and ``int_mm`` pads. In
    f64 against deepv_tpu run op by op (``jax.disable_jit``: its jitted
    program rounds the activations that feed each quantiser differently,
    test_torch_port_fast_rollout.py), at test_torch_port_mmdit.py's atol
    1e-8: the same f64 formulas on the same int8 integers."""
    from deepv_tpu.config import MMDiTConfig, PipelineConfig
    from deepv_tpu.models.mmdit import mmdit_forward as jax_forward
    from deepv_tpu.pipeline import _pyramid_list as jax_pyramid, padded_conditions as jax_padded
    from deepv_tpu_torch.config import PipelineConfig as TPipelineConfig
    from deepv_tpu_torch.pipeline import (_pyramid_list as port_pyramid,
                                          padded_conditions as port_padded)
    from test_torch_port_mmdit import _inputs, correctly_rounded

    # one block, the fixture's last (its video stream runs every quantised
    # linear), keeps the op-by-op reference cheap: each op compiles apart
    tree = jax.tree.map(lambda a: a.numpy().astype(np.float64), quantised_tree)
    tree["transformer_blocks"] = tree["transformer_blocks"][-1:]
    cfg = dict(MCFG, num_layers=1)
    gen, lat, text, mask, pooled, t, _ = _inputs(2, 0, seed=5)
    with jax.enable_x64(), jax.disable_jit(), pytest.MonkeyPatch.context() as mp:
        for name in ("exp", "cos", "sin"):
            mp.setattr(jnp, name, correctly_rounded(getattr(jnp, name)))
        clips, times, valid = jax_padded(PipelineConfig(), jax_pyramid(jnp.asarray(gen), 2),
                                         3, True, 2)[0]
        qtree = jli.quantize_mmdit_params(jax.tree.map(jnp.asarray, tree), keep_original=False)
        ref = np.asarray(jax_forward(
            MMDiTConfig(**cfg), qtree, list(clips) + [jnp.asarray(np.concatenate([lat] * 2))],
            jnp.asarray(text), jnp.asarray(mask), jnp.asarray(pooled), jnp.asarray(t),
            frame_times=list(times), frame_valid=list(valid)))
    model = params_from_numpy(port_mmdit.MMDiT(TMMDiTConfig(**cfg)), tree)
    port_mmdit.quantize_mmdit(model)
    rows = []
    orig = tli.int_mm

    def spy(a, b):
        rows.append(a.shape[0])
        return orig(a, b)

    clips, times, valid = port_padded(TPipelineConfig(), port_pyramid(torch.from_numpy(gen), 2),
                                      3, True, 2)[0]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tli, "int_mm", spy)
        out = port_mmdit.mmdit_forward(
            model, list(clips) + [torch.from_numpy(np.concatenate([lat] * 2))],
            torch.from_numpy(text), torch.from_numpy(mask), torch.from_numpy(pooled),
            torch.from_numpy(t), frame_times=list(times), frame_valid=list(valid),
            split_last_attn=True)
    assert 16 in rows and min(rows) == 16, sorted(set(rows))
    assert tuple(out.shape) == ref.shape == (2, 14, 1, 2, 2)
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=1e-8)
