"""The port's causal VAE against deepv_tpu's, in float64.

``VAEConfig.tiny()``, one parameter tree for both, loaded into the port by
``params_from_numpy``. Encode and decode in full mode and chunked (init +
cont windows), and the chunk-boundary decoder priming against the full warm
decode's caches (the tests/test_prime_decode.py check). Each output is
compared with deepv_tpu's at atol 1e-9, the tests/test_torch_oracle_vae.py
precedent for f64 VAE math (random-weight group-norm chains amplify
rounding, so f64 keeps the comparison meaningful).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deepv_tpu.config import VAEConfig
from deepv_tpu.models import vae as jax_vae

from deepv_tpu_torch.config import MMDiTConfig as TMMDiTConfig, VAEConfig as TVAEConfig
from deepv_tpu_torch.io.weights import params_from_numpy, random_params
from deepv_tpu_torch.models import vae as port_vae

torch.set_num_threads(1)

ATOL = 1e-9


@pytest.fixture(scope="module")
def vaes():
    """One f64 tree in deepv_tpu's layout, drawn with the port's
    random_params (its init distributions; eager JAX init is slower here)."""
    tree = random_params(TMMDiTConfig.tiny(), TVAEConfig.tiny(), dtype=torch.float64,
                         device="cpu")["vae"]
    tree = jax.tree.map(lambda a: a.numpy(), tree)
    return tree, params_from_numpy(port_vae.VAE(TVAEConfig.tiny()), tree)


def leaves(cache, path=""):
    """(path, array) pairs of a nested dict/list cache, Nones kept."""
    if isinstance(cache, dict):
        return [x for k in sorted(cache) for x in leaves(cache[k], f"{path}.{k}")]
    if isinstance(cache, (list, tuple)):
        return [x for i, c in enumerate(cache) for x in leaves(c, f"{path}.{i}")]
    return [(path, None if cache is None else np.asarray(cache))]


def assert_caches_equal(a, b, atol=ATOL):
    la, lb = leaves(a), leaves(b)
    assert [p for p, _ in la] == [p for p, _ in lb]
    for (p, x), (_, y) in zip(la, lb):
        assert (x is None) == (y is None), p
        if x is not None:
            np.testing.assert_allclose(x, y, rtol=0, atol=atol, err_msg=p)


def test_encode_full_and_chunked(vaes):
    tree, vae = vaes
    x = np.random.default_rng(0).uniform(-1, 1, (1, 3, 25, 32, 32))
    with jax.enable_x64():
        p = jax.tree.map(jnp.asarray, tree)
        ref_full = np.asarray(jax_vae.vae_encode(VAEConfig.tiny(), p, jnp.asarray(x)))
        ref_chunk = np.asarray(jax_vae.vae_encode(VAEConfig.tiny(), p, jnp.asarray(x),
                                                  temporal_chunk=True, window_size=8))
    xt = torch.from_numpy(x)
    full = port_vae.vae_encode(TVAEConfig.tiny(), vae, xt).numpy()
    chunk = port_vae.vae_encode(TVAEConfig.tiny(), vae, xt, temporal_chunk=True,
                                window_size=8).numpy()
    assert full.shape == ref_full.shape == (1, 8, 4, 4, 4)
    np.testing.assert_allclose(full, ref_full, rtol=0, atol=ATOL)
    np.testing.assert_allclose(chunk, ref_chunk, rtol=0, atol=ATOL)
    np.testing.assert_allclose(chunk, full, rtol=0, atol=ATOL)     # chunked == full


def test_decode_full_and_chunked(vaes):
    tree, vae = vaes
    z = np.random.default_rng(1).standard_normal((1, 4, 4, 4, 4))
    with jax.enable_x64():
        p = jax.tree.map(jnp.asarray, tree)
        ref_full = np.asarray(jax_vae.vae_decode(VAEConfig.tiny(), p, jnp.asarray(z)))
        ref_chunk = np.asarray(jax_vae.vae_decode(VAEConfig.tiny(), p, jnp.asarray(z),
                                                  temporal_chunk=True, window_size=2))
    zt = torch.from_numpy(z)
    full = port_vae.vae_decode(TVAEConfig.tiny(), vae, zt).numpy()
    chunk = port_vae.vae_decode(TVAEConfig.tiny(), vae, zt, temporal_chunk=True,
                                window_size=2).numpy()
    assert full.shape == ref_full.shape == (1, 3, 25, 32, 32)
    np.testing.assert_allclose(full, ref_full, rtol=0, atol=ATOL)
    np.testing.assert_allclose(chunk, ref_chunk, rtol=0, atol=ATOL)
    np.testing.assert_allclose(chunk, full, rtol=0, atol=ATOL)


def test_primed_caches_equal_full_warm(vaes):
    """_dec_prime_warm's caches equal the per-frame warm decode's, in both
    packages, and decoding the next latent through either is identical."""
    tree, vae = vaes
    rng = np.random.default_rng(2)
    z = rng.standard_normal((1, 4, 4, 8, 8))
    z_next = rng.standard_normal((1, 4, 1, 8, 8))
    cfg, tcfg = VAEConfig.tiny(), TVAEConfig.tiny()
    with jax.enable_x64():
        pd = jax.tree.map(jnp.asarray, tree["decoder"])
        ref_primed = jax_vae._dec_prime_warm(cfg, pd, jnp.asarray(z))
        ref_next, _ = jax_vae._dec_window(cfg, pd, jnp.asarray(z_next), ref_primed, "cont")
        ref_primed, ref_next = jax.tree.map(np.asarray, (ref_primed, ref_next))

    zt = torch.from_numpy(z)
    full = None
    for fi in range(z.shape[2]):
        _, full = port_vae._dec_window(tcfg, vae.decoder, zt[:, :, fi:fi + 1], full,
                                       "init" if fi == 0 else "cont")
    primed = port_vae._dec_prime_warm(tcfg, vae.decoder, zt)
    assert_caches_equal(primed, full)
    assert_caches_equal(primed, ref_primed)
    nt = torch.from_numpy(z_next)
    ya, _ = port_vae._dec_window(tcfg, vae.decoder, nt, full, "cont")
    yb, _ = port_vae._dec_window(tcfg, vae.decoder, nt, primed, "cont")
    np.testing.assert_allclose(yb.numpy(), ya.numpy(), rtol=0, atol=ATOL)
    np.testing.assert_allclose(yb.numpy(), ref_next, rtol=0, atol=ATOL)


def test_gaussian_mode_and_sample_shapes(vaes):
    m = torch.from_numpy(np.random.default_rng(3).standard_normal((2, 8, 3, 4, 4)))
    eps = torch.zeros((2, 4, 3, 4, 4), dtype=torch.float64)
    np.testing.assert_array_equal(port_vae.gaussian_sample(m, eps).numpy(),
                                  port_vae.gaussian_mode(m).numpy())


def test_boundary_decode_primed_equals_full_redecode():
    """The pipeline's non-streaming chunk-boundary decode: priming the
    decoder caches on the carried latents and decoding only the new ones
    gives exactly the new frames of the full re-decode."""
    from deepv_tpu_torch.config import PipelineConfig
    from deepv_tpu_torch.pipeline import InferencePipeline

    params = random_params(TMMDiTConfig.tiny(), TVAEConfig.tiny(), dtype=torch.float64,
                           device="cpu")
    pipe = InferencePipeline(PipelineConfig(), TMMDiTConfig.tiny(), TVAEConfig.tiny(), params,
                             {}, dtype=torch.float64, device="cpu", stream_decode=False)
    lat = torch.from_numpy(np.random.default_rng(4).standard_normal((1, 4, 8, 4, 4)))
    n_ov = 4
    assert pipe._prime_eligible(lat[:, :, :n_ov])
    full = pipe._decode_latents(lat)
    primed = pipe._decode_latents_primed(lat, n_ov)
    t_ov = 1 + (n_ov - 1) * 2 ** sum(TVAEConfig.tiny().decoder_temporal_up_sample)
    assert primed.shape[2] == full.shape[2] - t_ov
    np.testing.assert_allclose(primed.numpy(), full[:, :, t_ov:].numpy(), rtol=0, atol=ATOL)
