"""The port's implicit-GEMM causal conv (K2) against deepv_tpu's, on the CPU.

deepv_tpu runs its Pallas kernel in interpret mode (the fixture of
tests/test_conv_igemm.py); the port's wrapper takes its plain version for
CPU tensors. Inputs come from numpy seeds and everything is float32, the
kernel's exactness dtype:

  * ``conv3d_igemm`` at tests/test_conv_igemm.py's shapes, and with x
    channels-last and with w % 8 != 0 (the two inputs of the ``cl`` path),
    atol 2e-4 / rtol 1e-4 (its tolerance: both sides accumulate in f32, in
    other orders);
  * ``supports_igemm``, the dispatch rule, against deepv_tpu's;
  * ``causal_conv3d(impl="igemm")`` in its four modes, outputs and caches;
  * the VAE encode at a config whose blocks have 128-multiple channels
    (VAE_KW), in full mode and chunked; the decode stream at that config is
    in tests/test_torch_port_conv_igemm_decode.py, so that the interpreted
    reference's compile time falls on two workers.
"""

import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deepv_tpu.config import VAEConfig
from deepv_tpu.models import vae as jax_vae
from deepv_tpu.ops import causal_conv as jax_causal
from deepv_tpu.ops import conv_igemm as jax_igemm

from deepv_tpu_torch.config import MMDiTConfig as TMMDiTConfig, VAEConfig as TVAEConfig
from deepv_tpu_torch.io.weights import params_from_numpy, random_params
from deepv_tpu_torch.models import vae as port_vae
from deepv_tpu_torch.ops import causal_conv as port_causal
from deepv_tpu_torch.ops import conv_igemm as port_igemm

torch.set_num_threads(1)

ATOL, RTOL = 2e-4, 1e-4          # tests/test_conv_igemm.py:33, :45
#: the VAE stream tolerance, as a multiple of deepv_tpu's own igemm-vs-XLA
#: gap on the same inputs: the port's plain f32 accumulation differs from
#: the interpreted kernel's only in summation order, as XLA's conv does, so
#: the port may be no further from deepv_tpu's kernel than a small multiple
#: of that gap
GAP_FACTOR = 4.0
VAE_KW = dict(encoder_out_channels=4, encoder_layers_per_block=(1, 1, 1, 1),
              encoder_block_out_channels=(128, 128, 256, 256), encoder_norm_num_groups=32,
              decoder_in_channels=4, decoder_layers_per_block=(1, 1, 1, 1),
              decoder_block_out_channels=(128, 128, 256, 256), decoder_norm_num_groups=32,
              sample_size=32)


@pytest.fixture(autouse=True)
def interpret_mode():
    jax_igemm._INTERPRET[0] = True
    yield
    jax_igemm._INTERPRET[0] = False


def conv_params(seed: int, ci: int, co: int):
    """deepv_tpu's conv init (0.02 normal) with a nonzero bias, as numpy."""
    rng = np.random.default_rng(seed)
    return {"weight": (0.02 * rng.standard_normal((co, ci, 3, 3, 3))).astype(np.float32),
            "bias": (0.1 * rng.standard_normal(co)).astype(np.float32)}


def port_params(p):
    return types.SimpleNamespace(**{k: torch.from_numpy(v) for k, v in p.items()})


def jax_params(p):
    return {k: jnp.asarray(v) for k, v in p.items()}


IGEMM_CASES = [
    (1, 128, 128, 2, 8, 8, 2, "contiguous"),
    (2, 128, 256, 1, 4, 8, 2, "contiguous"),
    (1, 256, 128, 3, 8, 16, 2, "contiguous"),
    (1, 128, 128, 4, 8, 8, 0, "contiguous"),      # cont: the 2 cache frames already concatenated
    # x channels-last, as the encoder's mid block hands it on (the cl path)
    (2, 128, 128, 2, 4, 8, 2, "channels_last"),
    # w % 8 != 0: the cl path through a channels-last copy
    (1, 128, 128, 4, 6, 10, 0, "contiguous"),
]


@pytest.mark.parametrize("b,ci,co,t,h,w,time_pad,layout", IGEMM_CASES,
                         ids=["-".join(map(str, c[:7])) + ("" if c[7] == "contiguous" else f"-{c[7]}")
                              for c in IGEMM_CASES])
def test_conv3d_igemm_matches_deepv_tpu(b, ci, co, t, h, w, time_pad, layout):
    p = conv_params(0, ci, co)
    x = np.random.default_rng(1).standard_normal((b, ci, t, h, w)).astype(np.float32)
    ref = np.asarray(jax_igemm.conv3d_igemm(jnp.asarray(x), jax_params(p), time_pad=time_pad))
    xt = torch.from_numpy(x)
    if layout == "channels_last":
        xt = xt.to(memory_format=torch.channels_last_3d)
    plain = port_igemm.conv3d_igemm_plain(xt, port_params(p), time_pad)
    wrapped = port_igemm.conv3d_igemm(xt, port_params(p), time_pad)
    assert tuple(plain.shape) == ref.shape == (b, co, t + time_pad - 2, h, w)
    np.testing.assert_allclose(plain.numpy(), ref, atol=ATOL, rtol=RTOL)
    # on the CPU the wrapper is the plain version, and launches nothing
    np.testing.assert_array_equal(wrapped.numpy(), plain.numpy())


@pytest.mark.parametrize("time_pad,t", [(2, 2), (0, 4)])
def test_3xtf32_conv_meets_the_chip_tolerance(time_pad, t, monkeypatch):
    """The f32 kernel's arithmetic (``conv3d_igemm_3xtf32``: the halo-padded
    x and the weight split into TF32 planes, three conv products summed in
    f32, the bias after the sum) against deepv_tpu's interpreted kernel on
    the same f32 inputs, in both causal modes, at the tolerance the kernel
    is held to on the card (chip_smoke.py phase 4, atol 2e-4 / rtol 1e-4).
    One TF32 product (big . big) does not meet it."""
    p = conv_params(0, 128, 128)
    x = np.random.default_rng(1).standard_normal((1, 128, t, 8, 8)).astype(np.float32)
    ref = np.asarray(jax_igemm.conv3d_igemm(jnp.asarray(x), jax_params(p), time_pad=time_pad))
    got = port_igemm.conv3d_igemm_3xtf32(torch.from_numpy(x), port_params(p), time_pad)
    assert got.dtype == torch.float32 and tuple(got.shape) == ref.shape
    np.testing.assert_allclose(got.numpy(), ref, atol=ATOL, rtol=RTOL)
    tf32 = port_igemm.tf32_split
    monkeypatch.setattr(port_igemm, "conv3d_tf32x3_products",
                        lambda xp, w: torch.nn.functional.conv3d(tf32(xp)[0], tf32(w)[0]))
    coarse = port_igemm.conv3d_igemm_3xtf32(torch.from_numpy(x), port_params(p), time_pad)
    assert not np.allclose(coarse.numpy(), ref, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("shape,stride,dtype,h,w,expected", [
    ((128, 256, 3, 3, 3), (1, 1, 1), "bfloat16", 48, 64, True),
    ((128, 256, 3, 3, 3), (1, 2, 2), "bfloat16", 48, 64, False),
    ((128, 3, 3, 3, 3), (1, 1, 1), "bfloat16", 48, 64, False),
    ((128, 128, 1, 1, 1), (1, 1, 1), "bfloat16", 48, 64, False),
    ((128, 128, 3, 3, 3), (1, 1, 1), "float64", 48, 64, False),
    ((128, 128, 3, 3, 3), (1, 1, 1), "float32", 47, 64, False),
])
def test_supports_igemm_matches_deepv_tpu(shape, stride, dtype, h, w, expected):
    assert port_igemm.supports_igemm(shape, stride, getattr(torch, dtype), h, w) is expected
    assert jax_igemm.supports_igemm(shape, stride, getattr(jnp, dtype), h, w) is expected


@pytest.mark.parametrize("mode", ["full", "init", "cont", "prime"])
def test_causal_conv3d_igemm_modes(mode):
    rng = np.random.default_rng(2)
    p = conv_params(3, 128, 128)
    x = rng.standard_normal((1, 128, 4, 8, 6)).astype(np.float32)
    cache = rng.standard_normal((1, 128, 2, 8, 6)).astype(np.float32) if mode == "cont" else None
    calls = []
    orig = port_causal.conv3d_igemm
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(port_causal, "conv3d_igemm",
                   lambda *a, **k: calls.append(1) or orig(*a, **k))
        y, c = port_causal.causal_conv3d(
            torch.from_numpy(x), port_params(p), None if cache is None else torch.from_numpy(cache),
            mode=mode, impl="igemm")
    ry, rc = jax_causal.causal_conv3d(
        jnp.asarray(x), jax_params(p), None if cache is None else jnp.asarray(cache),
        mode=mode, impl="igemm")
    assert calls == [1]
    np.testing.assert_allclose(y.numpy(), np.asarray(ry), atol=ATOL, rtol=RTOL)
    assert (c is None) == (rc is None) == (mode == "full")
    if c is not None:
        np.testing.assert_array_equal(c.numpy(), np.asarray(rc))


def leaves(tree, path=""):
    """(path, array) pairs of a nested dict/list of arrays."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves(tree[k], f"{path}.{k}")]
    if isinstance(tree, (list, tuple)):
        return [x for i, c in enumerate(tree) for x in leaves(c, f"{path}.{i}")]
    return [] if tree is None else [(path, np.asarray(tree))]


def max_gap(a, b):
    la, lb = leaves(a), leaves(b)
    assert [p for p, _ in la] == [p for p, _ in lb]
    return max(float(np.max(np.abs(x - y))) for (_, x), (_, y) in zip(la, lb))


def stream_outputs(parts):
    """The named parts of the VAE stream at VAE_KW, in f32, from the port
    (igemm) and from deepv_tpu (igemm, interpreted, and XLA), as numpy:
    ``{part: port}``, ``{impl: {part: deepv_tpu}}``. Parts: a 1-frame
    full-mode encode (the rollout's first image and history frame), a
    17-frame encode chunked into an init and a cont window, a 1-frame init
    and a 1-frame cont decode window with their caches, and the priming of
    the decoder caches on both latents. deepv_tpu runs its jitted windows
    as it does in the rollout."""
    tcfg = TVAEConfig(**VAE_KW, conv_impl="igemm")
    tree = random_params(TMMDiTConfig.tiny(), tcfg, dtype=torch.float32, device="cpu")["vae"]
    tree = jax.tree.map(lambda a: a.numpy(), tree)
    vae = params_from_numpy(port_vae.VAE(tcfg), tree)
    rng = np.random.default_rng(4)
    x = rng.uniform(-1, 1, (1, 3, 17, 32, 32)).astype(np.float32)
    z = rng.standard_normal((1, 4, 2, 4, 4)).astype(np.float32)

    def run(m, cfg, p, dec, asarray, to_np):
        xs, zs = asarray(x), asarray(z)
        out = {}
        if "encode_full" in parts:
            out["encode_full"] = m.vae_encode(cfg, p, xs[:, :, :1])
        if "encode_chunked" in parts:
            out["encode_chunked"] = m.vae_encode(cfg, p, xs, temporal_chunk=True,
                                                 window_size=8)
        if "decode_init" in parts or "decode_cont" in parts:
            y0, c0 = m._dec_window(cfg, dec, zs[:, :, :1], None, "init")
            out["decode_init"] = (y0, c0)
            out["decode_cont"] = m._dec_window(cfg, dec, zs[:, :, 1:], c0, "cont")
        if "prime" in parts:
            out["prime"] = m._dec_prime_warm(cfg, dec, zs)
        return to_np({k: out[k] for k in parts})

    port = run(port_vae, tcfg, vae, vae.decoder, torch.from_numpy,
               lambda t: jax.tree.map(lambda a: a.numpy(), t))
    ref = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_igemm, "_INTERPRET", [True])     # module scope: no autouse fixture yet
        for impl in ("igemm", "xla"):
            cfg = VAEConfig(**VAE_KW, conv_impl=impl)
            p = jax.tree.map(jnp.asarray, tree)
            ref[impl] = run(jax_vae, cfg, p, p["decoder"], jnp.asarray,
                            lambda t: jax.tree.map(np.asarray, t))
    return port, ref


def check_stream_part(stream, part):
    port, ref = stream
    gap = max_gap(ref["igemm"][part], ref["xla"][part])
    err = max_gap(port[part], ref["igemm"][part])
    assert gap > 0, "the two deepv_tpu backends agree exactly: no scale for the tolerance"
    assert err <= GAP_FACTOR * gap, f"{part}: port vs deepv_tpu igemm {err}, igemm vs XLA {gap}"


ENCODE_PARTS = ("encode_full", "encode_chunked")


@pytest.fixture(scope="module")
def encode_stream():
    return stream_outputs(ENCODE_PARTS)


@pytest.mark.parametrize("part", ENCODE_PARTS)
def test_vae_encode_igemm_matches_deepv_tpu(encode_stream, part):
    check_stream_part(encode_stream, part)
