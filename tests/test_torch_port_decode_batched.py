"""``InferencePipeline(stream_decode=False, decode_batched=True)`` against
deepv_tpu: rgb and disparity decoded as one batch-2 VAE call at the end of
each chunk, in float64 on the CPU.

The rollouts are tests/test_torch_port_pipeline.py's 2-chunk tiny rollout
(64x64, 11 actions, the same parameters, embeddings, pins and replayed
draws) in two sets of modes: the plain decode of chunk 1 with the exact
boundary priming of chunk 2, and ``reuse_decoder_cache`` with
``carry_latents``, which keeps one batch-2 decoder cache across the
boundary. Each is held to deepv_tpu's batched rollout at the f64 rollout's
``ATOL = 1e-6`` and to the port's own serial (``decode_batched=False``)
rollout bit for bit: the VAE normalises and attends each stream of a batch
as it would alone, as deepv_tpu's does.

The VAE and conv cases hold the batch-2 calls to deepv_tpu's: the tiled
decode (32-pixel tiles) at tests/test_torch_port_tiling.py's ``ATOL`` 1e-9;
the igemm conv (deepv_tpu's kernel interpreted) at its atol 2e-4 / rtol
1e-4; the int8 conv with one activation scale over the whole batch,
deepv_tpu's (its conv_int8.py:85), within one f32 ulp.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deepv_tpu.actions import action_vocabulary
from deepv_tpu.io.text_embeds import random_text_embeds
from deepv_tpu.ops import causal_conv as jax_causal
from deepv_tpu.ops import conv_igemm as jax_igemm
from deepv_tpu.ops import conv_int8 as jax_int8

from deepv_tpu_torch.config import (MMDiTConfig as TMMDiTConfig,
                                    PipelineConfig as TPipelineConfig,
                                    VAEConfig as TVAEConfig)
from deepv_tpu_torch.io.weights import params_from_numpy, random_params
from deepv_tpu_torch.models import vae as port_vae
from deepv_tpu_torch.ops import causal_conv as port_causal
from deepv_tpu_torch.ops import conv_int8 as port_int8
from deepv_tpu_torch.pipeline import InferencePipeline as TorchPipeline

from test_torch_port_conv_igemm import (ATOL as IGEMM_ATOL, RTOL as IGEMM_RTOL, conv_params,
                                        jax_params, port_params)
from test_torch_port_fast_rollout import KEYS, check_rollout
from test_torch_port_pipeline import MCFG, ReplayNoise, _batch, _run_reference
from test_torch_port_tiling import both

torch.set_num_threads(1)

MODES = {"plain_and_prime": {},
         "reuse_and_carry": dict(reuse_decoder_cache=True, carry_latents=True)}


def cache_batches(tree):
    """The batch sizes of a decoder cache tree's tensors, or None."""
    if tree is None:
        return None
    if isinstance(tree, torch.Tensor):
        return {tree.shape[0]}
    values = tree.values() if isinstance(tree, dict) else tree
    return set().union(*(cache_batches(v) or set() for v in values))


def port_rollout(params, embeds, draws, batched: bool, modes: dict):
    """The port's end-of-chunk rollout with deepv_tpu's draws replayed; spies
    record the batch of every decoder call and each chunk's kept caches."""
    pipe = TorchPipeline(TPipelineConfig(), TMMDiTConfig(**MCFG), TVAEConfig.tiny(), params,
                         embeds, dtype=torch.float64, device="cpu", stream_decode=False,
                         decode_batched=batched, **modes)
    noise = ReplayNoise(draws)
    decoder_batches, kept = set(), []
    front, end_chunk = port_vae.decoder_front, TorchPipeline._end_chunk

    def front_spy(cfg, p, z, *args, **kwargs):
        decoder_batches.add(z.shape[0])
        return front(cfg, p, z, *args, **kwargs)

    def end_spy(self, ch, keep_caches=None):
        out = end_chunk(self, ch, keep_caches)
        kept.append(None if out[4] is None else tuple(cache_batches(c) for c in out[4]))
        return out

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(port_vae, "decoder_front", front_spy)
        mp.setattr(TorchPipeline, "_end_chunk", end_spy)
        out = pipe.generate(_batch(), seed=9, noise=noise)
    return dict(out=out, noise=noise, pipe=pipe, decoder_batches=decoder_batches, kept=kept)


@pytest.fixture(scope="module", params=list(MODES))
def rollouts(request):
    """deepv_tpu's batched rollout in one set of modes, and the port's
    batched and serial ones on its draws."""
    modes = MODES[request.param]
    params = random_params(TMMDiTConfig(**MCFG), TVAEConfig.tiny(), dtype=torch.float64,
                           seed=0, device="cpu")
    params = {k: jax.tree.map(lambda a: a.numpy(), v) for k, v in params.items()}
    embeds = random_text_embeds(0, action_vocabulary(), joint_dim=24, pooled_dim=16)
    with jax.enable_x64():
        ref, draws, ref_index = _run_reference(params, embeds, stream_decode=False,
                                               decode_batched=True, **modes)
    runs = {batched: port_rollout(params, embeds, draws, batched, modes)
            for batched in (True, False)}
    return request.param, ref, ref_index, runs


def test_batched_rollout_matches_deepv_tpu(rollouts):
    _, ref, ref_index, runs = rollouts
    check_rollout(ref, ref_index, runs[True]["out"], runs[True]["noise"])


def test_batched_rollout_equals_the_serial_one(rollouts):
    _, _, _, runs = rollouts
    for key in KEYS:
        assert torch.equal(runs[True]["out"][key], runs[False]["out"][key]), key
    assert runs[True]["out"]["history_index"] == runs[False]["out"]["history_index"]


def test_batched_rollout_decodes_both_streams_in_one_call(rollouts):
    """Every decoder call of the batched rollout takes rgb and disparity
    together (batch 2), every one of the serial rollout one stream; the
    plain modes prime chunk 2 once (batched) or twice (serial), the reuse
    modes never."""
    name, _, _, runs = rollouts
    assert runs[True]["decoder_batches"] == {2}
    assert runs[False]["decoder_batches"] == {1}
    primes = [r["pipe"].timer.stats().get("prime", {}).get("count") for r in runs.values()]
    assert primes == ([1, 2] if name == "plain_and_prime" else [None, None])
    assert [r["pipe"].timer.stats()["vae_decode"]["count"] for r in runs.values()] == [2, 2]


def test_reuse_keeps_one_batch_2_cache(rollouts):
    """``reuse_decoder_cache``: after each chunk the batched rollout keeps
    (one cache at batch 2, None), as deepv_tpu keeps (rgb_cache, disp_cache);
    the serial one keeps two caches at batch 1. Without reuse nothing is
    kept."""
    name, _, _, runs = rollouts
    if name == "plain_and_prime":
        assert runs[True]["kept"] == runs[False]["kept"] == [None, None]
    else:
        assert runs[True]["kept"] == [({2}, None)] * 2
        assert runs[False]["kept"] == [({1}, {1})] * 2


class _ZeroNoise:
    """A noise source of zeros."""

    def normal(self, kind, shape, dtype):
        return torch.zeros(shape, dtype=dtype)


def test_streaming_ignores_decode_batched():
    """The streamed windows stay two batch-1 calls, as deepv_tpu's do."""
    params = random_params(TMMDiTConfig(**MCFG), TVAEConfig.tiny(), dtype=torch.float64,
                           seed=0, device="cpu")
    pipe = TorchPipeline(TPipelineConfig(), TMMDiTConfig(**MCFG), TVAEConfig.tiny(), params,
                         {}, dtype=torch.float64, device="cpu", decode_batched=True)
    assert pipe.decode_batched and pipe.stream_decode
    z = torch.zeros((1, 2 * TVAEConfig.tiny().decoder_in_channels + TPipelineConfig().raymap_dim,
                     1, 8, 8),
                    dtype=torch.float64)
    ch = pipe._open_chunk(_ZeroNoise(), torch.zeros((1, 3, 1, 64, 64), dtype=torch.float64),
                          None, None, None)
    batches = []
    front = port_vae.decoder_front
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(port_vae, "decoder_front",
                   lambda cfg, p, zz, *a, **k: batches.append(zz.shape[0]) or front(cfg, p, zz,
                                                                                    *a, **k))
        pipe._push_frames(ch, z)
    assert batches == [1, 1] and len(ch.rgb_frames) == len(ch.disp_frames) == 1


def test_tiled_decode_at_batch_2_matches_deepv_tpu():
    """``vae_decode(use_tiling=True)`` of rgb and disparity latents in one
    batch-2 call, chunked as the pipeline decodes: deepv_tpu's batch-2
    decode within 1e-9, and the port's two batch-1 decodes bit for bit."""
    tree = random_params(TMMDiTConfig.tiny(), TVAEConfig.tiny(), dtype=torch.float64,
                         device="cpu")["vae"]
    tree = jax.tree.map(lambda a: a.numpy(), tree)
    vae = params_from_numpy(port_vae.VAE(TVAEConfig.tiny()), tree)
    z = np.random.default_rng(6).standard_normal((2, 4, 3, 8, 8))
    z[1] *= 3.0
    kw = dict(use_tiling=True, tile_sample_min_size=32, temporal_chunk=True, window_size=2)
    ref, got = both(tree, vae, "vae_decode", z, **kw)
    assert got.shape == ref.shape == (2, 3, 17, 64, 64)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-9)
    serial = np.concatenate([port_vae.vae_decode(TVAEConfig.tiny(), vae,
                                                 torch.from_numpy(z[i:i + 1]), **kw).numpy()
                             for i in range(2)])
    np.testing.assert_array_equal(got, serial)


@pytest.fixture
def interpret_mode():
    jax_igemm._INTERPRET[0] = True
    yield
    jax_igemm._INTERPRET[0] = False


@pytest.mark.parametrize("mode", ["init", "cont", "prime"])
def test_igemm_conv_at_batch_2_matches_deepv_tpu(interpret_mode, mode):
    """``causal_conv3d(impl="igemm")`` on a batch of two streams in the
    modes the batched decode runs (its plain version on the CPU), against
    deepv_tpu's interpreted kernel: outputs and caches."""
    rng = np.random.default_rng(8)
    p = conv_params(5, 128, 128)
    x = rng.standard_normal((2, 128, 3, 8, 8)).astype(np.float32)
    x[1] *= 2.0
    cache = rng.standard_normal((2, 128, 2, 8, 8)).astype(np.float32) if mode == "cont" else None
    y, c = port_causal.causal_conv3d(
        torch.from_numpy(x), port_params(p), None if cache is None else torch.from_numpy(cache),
        mode=mode, impl="igemm")
    ry, rc = jax_causal.causal_conv3d(
        jnp.asarray(x), jax_params(p), None if cache is None else jnp.asarray(cache),
        mode=mode, impl="igemm")
    assert tuple(y.shape) == np.asarray(ry).shape and y.shape[0] == 2
    np.testing.assert_allclose(y.numpy(), np.asarray(ry), atol=IGEMM_ATOL, rtol=IGEMM_RTOL)
    np.testing.assert_array_equal(c.numpy(), np.asarray(rc))


@pytest.mark.parametrize("mode", ["init", "cont", "prime"])
def test_int8_conv_at_batch_2_takes_one_scale(mode):
    """``causal_conv3d(impl="int8")`` on a batch of two streams whose
    amplitudes differ 4x: one activation scale over the whole batch (and
    the cache frames), deepv_tpu's (conv_int8.py:85), so the batched conv is
    not two serial ones; the output within one f32 ulp of deepv_tpu's and
    the cache bit-equal. deepv_tpu's conv runs op by op (pin F1)."""
    rng = np.random.default_rng(9)
    h, w = port_int8.MIN_H, 16
    conv = torch.nn.Conv3d(8, 8, 3).requires_grad_(False)
    conv.weight.copy_(torch.from_numpy((0.05 * rng.standard_normal((8, 8, 3, 3, 3)))
                                       .astype(np.float32)))
    conv.bias.copy_(torch.from_numpy((0.01 * rng.standard_normal(8)).astype(np.float32)))
    port_int8.quantize_conv_weights(conv)
    ref_p = jax_int8.quantize_conv_weights({"weight": jnp.asarray(conv.weight.numpy()),
                                            "bias": jnp.asarray(conv.bias.numpy())})
    x = rng.standard_normal((2, 8, 3, h, w)).astype(np.float32)
    x[1] *= 4.0
    cache = rng.standard_normal((2, 8, 2, h, w)).astype(np.float32) if mode == "cont" else None
    with jax.disable_jit():
        ry, rc = jax_causal.causal_conv3d(
            jnp.asarray(x), ref_p, None if cache is None else jnp.asarray(cache), mode=mode,
            impl="int8")
    y, c = port_causal.causal_conv3d(
        torch.from_numpy(x), conv, None if cache is None else torch.from_numpy(cache),
        mode=mode, impl="int8")
    np.testing.assert_array_max_ulp(y.numpy(), np.asarray(ry), maxulp=1)
    np.testing.assert_array_equal(c.numpy(), np.asarray(rc))
    # the scale is the whole batch's: stream 0 alone would take a smaller one
    read = np.concatenate([cache, x], axis=2) if cache is not None else x
    _, sx = port_int8.quantize_input(torch.from_numpy(read))
    _, sx0 = port_int8.quantize_input(torch.from_numpy(read[:1]))
    assert float(sx) == np.float32(np.abs(read).max() / np.float32(127.0)) and sx0 < sx
    alone, _ = port_causal.causal_conv3d(
        torch.from_numpy(x[:1]), conv, None if cache is None else torch.from_numpy(cache[:1]),
        mode=mode, impl="int8")
    assert not torch.equal(alone, y[:1])
