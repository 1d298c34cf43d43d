"""The port's spatial VAE tiling against deepv_tpu's, in float64.

The VAE-level cases are the port counterparts of tests/test_vae.py's tiling
tests (``VAEConfig.tiny()``, ``tile_sample_min_size=32``), each output held
to deepv_tpu's at ``ATOL`` 1e-9 (the tests/test_torch_port_vae.py
tolerance for f64 VAE math). The pipeline cases run the 2-chunk tiny
rollout of tests/test_torch_port_pipeline.py with ``use_tiling=True`` in
both packages, with the streaming decode and with the end-of-chunk decode.
Its 64x64 image is below the default 256-pixel tile, so both packages'
pipelines call ``vae_encode``/``vae_decode`` with a 32-pixel tile here
(their module-level names, patched for the rollout); tolerance: the f64
rollout's ``ATOL`` 1e-6.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import deepv_tpu.pipeline as jax_pipeline
from deepv_tpu.config import VAEConfig
from deepv_tpu.models import vae as jax_vae

import deepv_tpu_torch.pipeline as port_pipeline
from deepv_tpu_torch.config import (MMDiTConfig as TMMDiTConfig,
                                    PipelineConfig as TPipelineConfig,
                                    VAEConfig as TVAEConfig)
from deepv_tpu_torch.io.weights import params_from_numpy, random_params
from deepv_tpu_torch.models import vae as port_vae

from test_torch_port_fast_rollout import check_rollout, rollout_pair

torch.set_num_threads(1)

ATOL = 1e-9
TILE = 32


@pytest.fixture(scope="module")
def vaes():
    tree = random_params(TMMDiTConfig.tiny(), TVAEConfig.tiny(), dtype=torch.float64,
                         device="cpu")["vae"]
    tree = jax.tree.map(lambda a: a.numpy(), tree)
    return tree, params_from_numpy(port_vae.VAE(TVAEConfig.tiny()), tree)


def both(tree, vae, fn_name, arr, **kwargs):
    """deepv_tpu's and the port's ``fn_name`` (vae_encode or vae_decode)
    on the same f64 input, as numpy."""
    with jax.enable_x64():
        p = jax.tree.map(jnp.asarray, tree)
        ref = np.asarray(getattr(jax_vae, fn_name)(VAEConfig.tiny(), p, jnp.asarray(arr),
                                                   **kwargs))
    got = getattr(port_vae, fn_name)(TVAEConfig.tiny(), vae, torch.from_numpy(arr), **kwargs)
    return ref, got.numpy()


def case_decode_structure(tree, vae):
    """Tiled decode equals deepv_tpu's and is deterministic; a tile covering
    the whole plane skips the branch, bit for bit the untiled decode."""
    z = np.random.default_rng(3).standard_normal((1, 4, 2, 8, 8))
    ref, got = both(tree, vae, "vae_decode", z, use_tiling=True, tile_sample_min_size=TILE)
    full = port_vae.vae_decode(TVAEConfig.tiny(), vae, torch.from_numpy(z)).numpy()
    assert got.shape == ref.shape == full.shape == (1, 3, 9, 64, 64)
    np.testing.assert_allclose(got, ref, rtol=0, atol=ATOL)
    again = port_vae.vae_decode(TVAEConfig.tiny(), vae, torch.from_numpy(z), use_tiling=True,
                                tile_sample_min_size=TILE).numpy()
    np.testing.assert_array_equal(again, got)
    assert np.abs(got - full).max() > 1e-3      # the seams really differ from untiled
    ref_big, big = both(tree, vae, "vae_decode", z, use_tiling=True, tile_sample_min_size=64)
    np.testing.assert_array_equal(big, full)
    np.testing.assert_allclose(big, ref_big, rtol=0, atol=ATOL)


def case_blend_seams(tree, vae):
    """Seam blends: constant tiles give the ramp y / extent (tests/test_vae.py),
    random tiles deepv_tpu's blend."""
    a, b = torch.zeros((1, 1, 1, 8, 8), dtype=torch.float64), torch.ones((1, 1, 1, 8, 8),
                                                                         dtype=torch.float64)
    out = port_vae._blend_v(a, b, 4)
    np.testing.assert_allclose(out[0, 0, 0, :4, 0].numpy(), [0, 0.25, 0.5, 0.75], atol=ATOL)
    np.testing.assert_allclose(out[0, 0, 0, 4:, 0].numpy(), 1.0)
    out = port_vae._blend_h(a, b, 4)
    np.testing.assert_allclose(out[0, 0, 0, 0, :4].numpy(), [0, 0.25, 0.5, 0.75], atol=ATOL)
    rng = np.random.default_rng(4)
    x, y = rng.standard_normal((2, 1, 3, 2, 6, 5))
    for name in ("_blend_v", "_blend_h"):
        for extent in (3, 9):               # 9 is clipped to the tiles' extent
            with jax.enable_x64():
                ref = np.asarray(getattr(jax_vae, name)(jnp.asarray(x), jnp.asarray(y), extent))
            got = getattr(port_vae, name)(torch.from_numpy(x), torch.from_numpy(y), extent)
            np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=ATOL)
    # bf16 tiles blend with bf16 weights, as deepv_tpu casts them
    a16 = torch.from_numpy(x).to(torch.bfloat16)
    w = (torch.arange(3, dtype=torch.float32) / 3).to(torch.bfloat16).reshape(1, 1, 1, 3, 1)
    seam = a16[:, :, :, -3:] * (1 - w) + a16[:, :, :, :3] * w
    assert torch.equal(port_vae._blend_v(a16, a16, 3)[:, :, :, :3], seam)


def case_encode_shape(tree, vae):
    """Tiled encode equals deepv_tpu's (the rollouts below also run the
    tiled, temporally chunked carry re-encode)."""
    x = np.random.default_rng(5).uniform(-1, 1, (1, 3, 9, 64, 64))
    ref, got = both(tree, vae, "vae_encode", x, use_tiling=True, tile_sample_min_size=TILE)
    assert got.shape == ref.shape == (1, 8, 2, 8, 8)
    np.testing.assert_allclose(got, ref, rtol=0, atol=ATOL)


def case_chunked_decode(tree, vae):
    """The pipeline's decode: tiling with temporal chunking equals
    deepv_tpu's, and the port's tiled decode without chunking."""
    z = np.random.default_rng(6).standard_normal((1, 4, 3, 8, 8))
    ref, got = both(tree, vae, "vae_decode", z, use_tiling=True, tile_sample_min_size=TILE,
                    temporal_chunk=True, window_size=1)
    whole = port_vae.vae_decode(TVAEConfig.tiny(), vae, torch.from_numpy(z), use_tiling=True,
                                tile_sample_min_size=TILE).numpy()
    assert got.shape == ref.shape == (1, 3, 17, 64, 64)
    np.testing.assert_allclose(got, ref, rtol=0, atol=ATOL)
    np.testing.assert_allclose(got, whole, rtol=0, atol=ATOL)


@pytest.mark.parametrize("case", [case_decode_structure, case_blend_seams, case_encode_shape,
                                  case_chunked_decode],
                         ids=["decode_structure", "blend_seams_exact", "encode_shape",
                              "chunked_decode_matches_reference_combination"])
def test_tiled_vae_matches_deepv_tpu(vaes, case):
    case(*vaes)


MODES = {"stream": True, "end_of_chunk": False}


@pytest.fixture(scope="module")
def tiled():
    """Both packages' 2-chunk tiled rollouts (32-pixel tiles), per decode
    mode. The two reference rollouts run under the same pins, so the
    second reuses the first's compiled programs: JAX's caches are cleared
    once before and once after both, not between them."""
    clear = jax.clear_caches
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        for mod, vae_mod in ((jax_pipeline, jax_vae), (port_pipeline, port_vae)):
            for name in ("vae_encode", "vae_decode"):
                mp.setattr(mod, name, functools.partial(getattr(vae_mod, name),
                                                        tile_sample_min_size=TILE))
        clear()
        mp.setattr(jax, "clear_caches", lambda: None)
        try:
            for mode, stream in MODES.items():
                out[mode] = rollout_pair(stream_decode=stream, use_tiling=True)
        finally:
            clear()
    return out


@pytest.mark.parametrize("mode", MODES)
def test_tiled_rollout_matches_deepv_tpu(tiled, mode):
    ref, ref_index, out, noise, _, _ = tiled[mode]
    check_rollout(ref, ref_index, out, noise)


@pytest.mark.parametrize("mode", MODES)
def test_tiled_rollout_turns_priming_off(tiled, mode):
    """Under tiling the boundary re-decodes the whole overlap (no priming);
    every forward ran."""
    _, _, _, _, pipe, _ = tiled[mode]
    assert pipe.use_tiling and pipe._prime_need is None
    assert pipe.timer.stats().get("prime") is None
    assert set(pipe.recompute_log) == {(1, 1, 1, 1, 1)}


def test_tiling_refuses_decoder_cache_reuse():
    mcfg, vcfg = TMMDiTConfig.tiny(), TVAEConfig.tiny()
    params = random_params(mcfg, vcfg, dtype=torch.float32, device="cpu")
    with pytest.raises(ValueError, match="reuse_decoder_cache"):
        port_pipeline.InferencePipeline(TPipelineConfig(), mcfg, vcfg, params, {},
                                        device="cpu", use_tiling=True,
                                        reuse_decoder_cache=True)
