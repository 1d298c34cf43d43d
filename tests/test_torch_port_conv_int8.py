"""The port's int8 conv (``ops/conv_int8.py``, the plain version that K3 is
held to on the card) against deepv_tpu's ``ops/conv_int8.py``, on the CPU,
at h = 256 (``MIN_H``), as tests/test_conv_int8.py runs it.

The quantised input, the scales and the int32 accumulators are integers
and f32 scales made by the same operations, so they must be bit-equal. The
f32 output may differ by deepv_tpu's FMA contraction of ``acc * (sx * sw) +
bias`` (one f32 ulp); ``causal_conv3d(impl="int8")`` in all four modes, with
the cache frames inside the scale, is held to deepv_tpu's at that bound.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax import lax

from deepv_tpu.ops import causal_conv as jax_causal
from deepv_tpu.ops import conv_int8 as jci

from deepv_tpu_torch.config import MMDiTConfig, VAEConfig
from deepv_tpu_torch.io.weights import params_from_numpy, random_params
from deepv_tpu_torch.models.vae import VAE
from deepv_tpu_torch.ops import causal_conv as port_causal
from deepv_tpu_torch.ops import conv_int8 as tci

torch.set_num_threads(1)

H, W = 256, 16


def _conv(rng, co, ci):
    conv = torch.nn.Conv3d(ci, co, 3).requires_grad_(False)
    conv.weight.copy_(torch.from_numpy((rng.standard_normal((co, ci, 3, 3, 3)) * 0.05)
                                       .astype(np.float32)))
    conv.bias.copy_(torch.from_numpy((rng.standard_normal(co) * 0.01).astype(np.float32)))
    return conv


@pytest.fixture(scope="module")
def case():
    """8 -> 8 channels, x [1, 8, 2 + 2, 256, 16] f32 from a numpy seed, and
    both packages' quantised weights."""
    rng = np.random.default_rng(0)
    conv = tci.quantize_conv_weights(_conv(rng, 8, 8))
    x = rng.standard_normal((1, 8, 4, H, W)).astype(np.float32)
    ref_p = jci.quantize_conv_weights({"weight": jnp.asarray(conv.weight.numpy()),
                                       "bias": jnp.asarray(conv.bias.numpy())})
    return x, conv, ref_p, rng


def test_weight_quantisation_is_bit_equal(case):
    _, conv, ref_p, _ = case
    np.testing.assert_array_equal(conv.weight_int8.numpy(), np.asarray(ref_p["weight_int8"]))
    np.testing.assert_array_equal(conv.weight_scale.numpy(), np.asarray(ref_p["weight_scale"]))
    # K3's layout for 8 input channels (the packed kernel's) holds the same
    # integers: [co_pad, K_pad], each tap's 8 channels in turn, zero padding
    assert not hasattr(conv, "weight_k3")
    k3 = conv.weight_k3_packed.numpy()
    assert k3.shape == (16, 256)
    np.testing.assert_array_equal(
        k3[:8, :27 * 8], conv.weight_int8.numpy().transpose(0, 2, 3, 4, 1).reshape(8, 27 * 8))
    assert not k3[8:].any() and not k3[:, 27 * 8:].any()


@pytest.mark.parametrize("time_pad", [2, 0])
def test_input_quantisation_and_accumulators_are_bit_equal(case, time_pad):
    """x8, sx and the int32 accumulators of deepv_tpu's conv3d_int8
    (conv_int8.py:84-91), and the kernel's channels-last input."""
    x, conv, ref_p, _ = case
    xf = jnp.asarray(x)
    sx_ref = jnp.maximum(jnp.max(jnp.abs(xf)) / 127.0, 1e-12)
    x8_ref = jnp.round(xf / sx_ref).astype(jnp.int8)
    acc_ref = lax.conv_general_dilated(
        x8_ref, ref_p["weight_int8"], (1, 1, 1), ((time_pad, 0), (1, 1), (1, 1)),
        dimension_numbers=("NCDHW", "OIDHW", "NCDHW"), preferred_element_type=jnp.int32)
    x8, sx = tci.quantize_input(torch.from_numpy(x))
    np.testing.assert_array_equal(x8.numpy(), np.asarray(x8_ref))
    np.testing.assert_array_equal(sx.numpy(), np.asarray(sx_ref))
    acc = tci.conv3d_int8_accumulators(torch.from_numpy(x), conv, time_pad)
    np.testing.assert_array_equal(acc.numpy(), np.asarray(acc_ref))
    xk, _ = tci.quantize_input_k3(torch.from_numpy(x))
    assert xk.shape == (1, 4, H, W, 32)
    np.testing.assert_array_equal(xk[..., :8].numpy(), np.asarray(x8_ref).transpose(0, 2, 3, 4, 1))
    assert not xk[..., 8:].any()


@pytest.mark.parametrize("time_pad", [2, 0])
def test_output_matches_deepv_tpu(case, time_pad):
    x, conv, ref_p, _ = case
    got = tci.conv3d_int8(torch.from_numpy(x), conv, time_pad).numpy()
    ref = np.asarray(jci.conv3d_int8(jnp.asarray(x), ref_p,
                                     padding=((time_pad, 0), (1, 1), (1, 1))))
    np.testing.assert_array_max_ulp(got, ref, maxulp=1)


@pytest.mark.parametrize("mode", ["full", "init", "cont", "prime"])
def test_causal_conv_int8_matches_deepv_tpu(case, mode):
    """Every causal mode with impl="int8": the output within one f32 ulp and
    the cache bit-equal. The cache frames carry values up to 3x x's, so a
    scale taken over x alone would move most outputs far beyond that."""
    x, conv, ref_p, rng = case
    cache = (3.0 * rng.standard_normal((1, 8, 2, H, W))).astype(np.float32)
    use_cache = cache if mode == "cont" else None
    y, c = port_causal.causal_conv3d(torch.from_numpy(x), conv,
                                     None if use_cache is None else torch.from_numpy(use_cache),
                                     mode=mode, impl="int8")
    ry, rc = jax_causal.causal_conv3d(jnp.asarray(x), ref_p,
                                      None if use_cache is None else jnp.asarray(use_cache),
                                      mode=mode, impl="int8")
    np.testing.assert_array_max_ulp(y.numpy(), np.asarray(ry), maxulp=1)
    assert (c is None) == (rc is None)
    if c is not None:
        np.testing.assert_array_equal(c.numpy(), np.asarray(rc))
    # the int8 path ran: it differs from the exact conv by quantisation noise
    exact, _ = port_causal.causal_conv3d(torch.from_numpy(x), conv,
                                         None if use_cache is None else torch.from_numpy(use_cache),
                                         mode=mode, impl="xla")
    assert 0 < np.abs(y.numpy() - exact.numpy()).max() < 0.05 * np.abs(exact.numpy()).max()


SHAPES = [((128, 128, 3, 3, 3), (1, 1, 1), 256), ((128, 3, 3, 3, 3), (1, 1, 1), 384),
          ((3, 128, 3, 3, 3), (1, 1, 1), 384), ((128, 128, 3, 3, 3), (1, 1, 1), 192),
          ((128, 128, 1, 1, 1), (1, 1, 1), 384), ((128, 128, 3, 3, 3), (1, 2, 2), 384),
          ((128, 128, 3, 3, 3), (2, 1, 1), 384), ((256, 128, 3, 3, 3), (1, 1, 1), 255)]


@pytest.mark.parametrize("min_h", [256, 64])
def test_supports_int8_agrees_with_deepv_tpu(monkeypatch, min_h):
    """The dispatch rule on a table of shapes (ci and co = 3 included), with
    MIN_H read at call time in both packages."""
    monkeypatch.setattr(jci, "MIN_H", min_h)
    monkeypatch.setattr(tci, "MIN_H", min_h)
    for shape, stride, h in SHAPES + [((8, 8, 3, 3, 3), (1, 1, 1), 64)]:
        assert tci.supports_int8(shape, stride, h) == jci.supports_int8(shape, stride, h), \
            (shape, stride, h)
    assert tci.supports_int8((8, 8, 3, 3, 3), (1, 1, 1), 64) == (min_h == 64)


def test_vae_convs_get_the_int8_buffers():
    """quantize_vae_convs gives every 3x3x3 conv its int8 buffers and leaves
    the 1x1 convs alone (deepv_tpu's rule); conv_out's 3 channels pad to
    K3's 16-wide channel tile."""
    vcfg = VAEConfig.tiny()
    tree = random_params(MMDiTConfig.tiny(), vcfg, dtype=torch.float32, device="cpu")["vae"]
    vae = tci.quantize_vae_convs(params_from_numpy(VAE(vcfg), tree))
    convs = [m for m in vae.modules() if isinstance(m, torch.nn.Conv3d)]
    assert any(tuple(m.weight.shape[2:]) == (1, 1, 1) for m in convs)
    for m in convs:
        k3 = "weight_k3_packed" if m.weight.shape[1] <= tci.PACKED_MAX_CI else "weight_k3"
        assert hasattr(m, k3) == (tuple(m.weight.shape[2:]) == (3, 3, 3))
    assert vae.decoder.conv_out.weight_k3_packed.shape == (16, 256)     # 8 channels: packed
