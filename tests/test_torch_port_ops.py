"""The port's core ops against deepv_tpu's, on numpy-seeded inputs.

Layers, RoPE, resampling, block noise and the schedule are compared in
float64 under ``jax.enable_x64()`` at atol 1e-10: both packages compute the
same float64 formulas, so only f64 rounding separates them. The few ops the
JAX package runs in float32 on purpose (the Euler update, the renoise, the
posterior's std, the timestep embedding, the raymap codec) are compared at a
float32 tolerance stated beside each.
"""

import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deepv_tpu.models import mmdit as jax_mmdit
from deepv_tpu.models import scheduler as jax_sched
from deepv_tpu.models.vae import gaussian_sample as jax_gaussian_sample
from deepv_tpu.ops import basic as jax_basic
from deepv_tpu.ops import block_noise as jax_bn
from deepv_tpu.ops import resample as jax_rs
from deepv_tpu.ops import rope as jax_rope
from deepv_tpu import pipeline as jax_pipeline
from deepv_tpu import raymap as jax_raymap

from deepv_tpu_torch.config import SchedulerConfig
from deepv_tpu_torch.models import mmdit as port_mmdit
from deepv_tpu_torch.models import scheduler as port_sched
from deepv_tpu_torch.models.vae import gaussian_sample as port_gaussian_sample
from deepv_tpu_torch.ops import basic as port_basic
from deepv_tpu_torch.ops import block_noise as port_bn
from deepv_tpu_torch.ops import resample as port_rs
from deepv_tpu_torch.ops import rope as port_rope
from deepv_tpu_torch import pipeline as port_pipeline
from deepv_tpu_torch import raymap as port_raymap

torch.set_num_threads(1)

F64_ATOL = 1e-10


@pytest.fixture(autouse=True)
def _x64():
    with jax.enable_x64():
        yield


def rng(seed=0):
    return np.random.default_rng(seed)


def both(x):
    """The same numpy array as a jnp array and a torch tensor."""
    return jnp.asarray(x), torch.from_numpy(np.array(x))


def close(j, t, atol=F64_ATOL, rtol=0.0):
    np.testing.assert_allclose(t.numpy() if isinstance(t, torch.Tensor) else t,
                               np.asarray(j), atol=atol, rtol=rtol)


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

def test_linear():
    x, w, b = rng().standard_normal((3, 5, 7)), rng(1).standard_normal((4, 7)), rng(2).standard_normal(4)
    (xj, xt), (wj, wt), (bj, bt) = both(x), both(w), both(b)
    close(jax_basic.linear(xj, {"weight": wj, "bias": bj}),
          port_basic.linear(xt, types.SimpleNamespace(weight=wt, bias=bt)))


@pytest.mark.parametrize("affine", [False, True])
def test_layer_norm(affine):
    x = rng().standard_normal((2, 6, 16)) * 3 + 1
    w, b = (rng(1).standard_normal(16), rng(2).standard_normal(16)) if affine else (None, None)
    xj, xt = both(x)
    kj = dict(weight=jnp.asarray(w), bias=jnp.asarray(b)) if affine else {}
    kt = dict(weight=torch.from_numpy(w), bias=torch.from_numpy(b)) if affine else {}
    close(jax_basic.layer_norm(xj, **kj), port_basic.layer_norm(xt, **kt))


def test_rms_norm():
    x, w = rng().standard_normal((2, 6, 4, 8)), rng(1).standard_normal(8)
    (xj, xt), (wj, wt) = both(x), both(w)
    close(jax_basic.rms_norm(xj, wj, 1e-5), port_basic.rms_norm(xt, wt, 1e-5))


def test_group_norm():
    x, w, b = rng().standard_normal((3, 8, 5, 6)), rng(1).standard_normal(8), rng(2).standard_normal(8)
    (xj, xt), (wj, wt), (bj, bt) = both(x), both(w), both(b)
    close(jax_basic.group_norm(xj, 4, wj, bj), port_basic.group_norm(xt, 4, wt, bt))


def test_activations():
    xj, xt = both(rng().standard_normal((4, 33)) * 4)
    close(jax_basic.gelu_tanh(xj), port_basic.gelu_tanh(xt))
    close(jax_basic.silu(xj), port_basic.silu(xt))


@pytest.mark.parametrize("stride,padding", [
    ((1, 1, 1), ((2, 0), (1, 1), (1, 1))),     # causal full mode
    ((1, 2, 2), ((0, 0), (1, 1), (1, 1))),     # spatial downsampler
    ((2, 1, 1), ((0, 0), (1, 1), (1, 1))),     # temporal downsampler
])
def test_conv3d(stride, padding):
    x, w, b = rng().standard_normal((1, 3, 5, 8, 6)), rng(1).standard_normal((4, 3, 3, 3, 3)), rng(2).standard_normal(4)
    (xj, xt), (wj, wt), (bj, bt) = both(x), both(w), both(b)
    close(jax_basic.conv3d(xj, {"weight": wj, "bias": bj}, stride=stride, padding=padding),
          port_basic.conv3d(xt, types.SimpleNamespace(weight=wt, bias=bt), stride=stride,
                            padding=padding))


def test_conv2d():
    x, w, b = rng().standard_normal((2, 3, 9, 7)), rng(1).standard_normal((5, 3, 3, 3)), rng(2).standard_normal(5)
    (xj, xt), (wj, wt), (bj, bt) = both(x), both(w), both(b)
    padding = ((1, 1), (2, 0))
    close(jax_basic.conv2d(xj, {"weight": wj, "bias": bj}, stride=(2, 1), padding=padding),
          port_basic.conv2d(xt, types.SimpleNamespace(weight=wt, bias=bt), stride=(2, 1),
                            padding=padding))


# ---------------------------------------------------------------------------
# rope
# ---------------------------------------------------------------------------

def test_rope_tables_and_rotation():
    pos = np.repeat(np.arange(-3, 6, dtype=np.float32), 4)
    cj, sj = jax_rope.rope_tables(pos, 16)
    cp, sp = port_rope.rope_tables(pos, 16)
    np.testing.assert_array_equal(cp, cj)
    np.testing.assert_array_equal(sp, sj)
    ct, st = port_rope.rope_tables_torch(torch.from_numpy(pos), 16)
    cjt, sjt = jax_rope.rope_tables_jax(jnp.asarray(pos), 16)
    close(cjt, ct)
    close(sjt, st)
    x = rng().standard_normal((2, pos.size, 3, 16))
    xj, xt = both(x)
    close(jax_rope.apply_rope(xj, cjt, sjt), port_rope.apply_rope(xt, ct, st))


def test_rope_rotates_interleaved_pairs():
    """Pair (x0, x1) of a single position rotates by the first frequency,
    which is 1 rad at position 1: interleaved pairs, not split halves."""
    x = torch.zeros(1, 1, 1, 8, dtype=torch.float64)
    x[..., 0] = 1.0
    c, s = port_rope.rope_tables_torch(torch.tensor([1.0]), 8)
    out = port_rope.apply_rope(x, c, s)
    np.testing.assert_allclose(out[0, 0, 0, :2].numpy(), [np.cos(1.0), np.sin(1.0)], atol=1e-15)
    assert float(out[0, 0, 0, 2:].abs().max()) == 0.0


# ---------------------------------------------------------------------------
# resampling
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(2, 3, 8, 12), (2, 3, 7, 9)])
def test_down2x_bilinear(shape):
    xj, xt = both(rng().standard_normal(shape))
    close(jax_rs.down2x_bilinear(xj), port_rs.down2x_bilinear(xt))


def test_up2x_nearest_and_avg_pool():
    xj, xt = both(rng().standard_normal((2, 3, 4, 6)))
    close(jax_rs.up2x_nearest(xj), port_rs.up2x_nearest(xt))
    close(jax_rs.avg_pool2d(xj, 2), port_rs.avg_pool2d(xt, 2))


@pytest.mark.parametrize("size", [(6, 8), (3, 4), (9, 13), (48, 64)])
def test_resize_bilinear_non_2x(size):
    """The crop resize of cropped_pos_embed (a 24x32 patch grid to a
    condition clip's 6x8 / 12x16), and upsampling."""
    xj, xt = both(rng().standard_normal((1, 5, 24, 32)))
    close(jax_rs.resize_bilinear(xj, size), port_rs.resize_bilinear(xt, size))


def test_resize_linear_1d():
    xj, xt = both(rng().standard_normal((3, 17)))
    for n in (5, 9, 40):
        close(jax_rs.resize_linear_1d(xj, n), port_rs.resize_linear_1d(xt, n))


def test_cropped_pos_embed():
    from deepv_tpu.config import MMDiTConfig
    from deepv_tpu_torch.config import MMDiTConfig as TMMDiTConfig
    table = rng().standard_normal((1, 32 * 32, 12))
    tj, tt = both(table)
    cfg, tcfg = MMDiTConfig.tiny(), TMMDiTConfig.tiny()
    for h, w, oh, ow in [(12, 16, 48, 64), (24, 32, 48, 64), (48, 64, 48, 64), (8, 8, 16, 16)]:
        close(jax_mmdit.cropped_pos_embed(tj, cfg, h, w, oh, ow),
              port_mmdit.cropped_pos_embed(tt, tcfg, h, w, oh, ow))


# ---------------------------------------------------------------------------
# block noise and schedule
# ---------------------------------------------------------------------------

def test_block_noise_from_injected_z():
    """Same z -> same correlated noise (f32 by design in both packages; the
    port's fixed pairwise sum matches XLA's CPU dot here exactly)."""
    np.testing.assert_array_equal(port_bn.block_cholesky(0.3333), jax_bn.block_cholesky(0.3333))
    key = jax.random.PRNGKey(3)
    shape = (1, 6, 2, 16, 24)
    z = np.asarray(jax.random.normal(key, port_bn.block_noise_shape(shape), jnp.float32))
    ref = jax_bn.sample_block_noise(key, shape, 0.3333)
    close(ref, port_bn.block_noise_from_z(torch.from_numpy(z), 0.3333), atol=0.0)


def test_schedule_tables():
    cfg = SchedulerConfig()
    j, t = jax_sched.FlowMatchSchedule(), port_sched.FlowMatchSchedule(cfg)
    for i in range(cfg.stages):
        np.testing.assert_array_equal(t.timesteps_per_stage[i], j.timesteps_per_stage[i])
        np.testing.assert_array_equal(t.sigmas_per_stage[i], j.sigmas_per_stage[i])
        a, b = j.stage_schedule(5, i), t.stage_schedule(5, i)
        np.testing.assert_array_equal(b.timesteps, a.timesteps)
        np.testing.assert_array_equal(b.sigmas, a.sigmas)
        if i:
            assert t.renoise_coeffs(i) == j.renoise_coeffs(i)
    assert (t.sigma_min, t.sigma_max) == (j.sigma_min, j.sigma_max)


def test_euler_step_fused_f32():
    """The Euler update as the rollout runs it (jitted, where XLA fuses it
    into an f32 FMA) equals the port's single-rounding FMA exactly; eager
    JAX rounds the product first, at most 1 f32 ulp away."""
    s, v = rng().standard_normal((2, 4, 8, 8)), rng(1).standard_normal((2, 4, 8, 8))
    dsig = np.float32(-0.21)
    out = port_sched.euler_step(torch.from_numpy(s), torch.from_numpy(v), dsig)
    close(jax.jit(jax_sched.euler_step)(jnp.asarray(s), jnp.asarray(v), jnp.float32(dsig)),
          out, atol=0.0)
    close(jax_sched.euler_step(jnp.asarray(s), jnp.asarray(v), jnp.float32(dsig)), out,
          atol=5e-7)


def test_renoise_with_injected_z():
    """Upsample + block noise, f32: equal to deepv_tpu's jitted _renoise up
    to the f32 FMA XLA places by array size (within 1 f32 ulp of ~4)."""
    lat = rng().standard_normal((1, 14, 1, 8, 8))
    key = jax.random.PRNGKey(9)
    z = np.asarray(jax.random.normal(key, (1, 14, 1, 8, 8, 4), jnp.float32))
    ref = jax_pipeline._renoise(jnp.asarray(lat), key, jnp.float32(0.7), jnp.float32(0.4),
                                gamma=0.3333)
    out = port_pipeline._renoise(torch.from_numpy(lat), torch.from_numpy(z), 0.7, 0.4, 0.3333)
    close(ref, out, atol=5e-7)


def test_gaussian_sample_with_injected_eps():
    """mean + std * eps; std is exp in f32 in both packages, correctly
    rounded in the port and within 1 f32 ulp in XLA."""
    m = rng().standard_normal((2, 8, 3, 4, 4))
    key = jax.random.PRNGKey(4)
    eps = np.asarray(jax.random.normal(key, (2, 4, 3, 4, 4), jnp.float64))
    close(jax_gaussian_sample(jnp.asarray(m), key),
          port_gaussian_sample(torch.from_numpy(m), torch.from_numpy(eps)), atol=1e-6)


def test_timestep_embedding_f32():
    """f32 embeddings: the port's correctly rounded exp/cos/sin against
    XLA's f32 ones, whose ulps the arguments (t up to 1000) scale to ~3e-5."""
    t = np.concatenate([jax_sched.FlowMatchSchedule().stage_schedule(5, i).timesteps
                        for i in range(3)])
    close(jax_mmdit.timestep_embedding(jnp.asarray(t)),
          port_mmdit.timestep_embedding(torch.from_numpy(t)), atol=5e-5)


# ---------------------------------------------------------------------------
# raymap codec (float32 in both packages)
# ---------------------------------------------------------------------------

def _cameras(t=4, seed=0):
    r = rng(seed)
    trans2d = np.zeros((1, t, 4, 4), np.float32)
    trans2d[..., 0, 0] = trans2d[..., 1, 1] = 300.0 + 20 * r.random(t)
    trans2d[..., 0, 2], trans2d[..., 1, 2] = 256.0, 192.0
    trans2d[..., 2, 2] = trans2d[..., 3, 3] = 1.0
    trans3d = np.zeros((1, t, 4, 4), np.float32)
    for i in range(t):
        a = 0.2 * r.standard_normal(3)
        kx = np.array([[0, -a[2], a[1]], [a[2], 0, -a[0]], [-a[1], a[0], 0]])
        rot = np.eye(3) + np.sin(0.5) * kx + (1 - np.cos(0.5)) * kx @ kx
        u, _, vt = np.linalg.svd(rot)
        trans3d[0, i, :3, :3] = u @ vt
        trans3d[0, i, :3, 3] = r.standard_normal(3)
        trans3d[0, i, 3, 3] = 1.0
    return trans2d, trans3d


def test_raymap_round_trip_against_reference():
    trans2d, trans3d = _cameras()
    encode = jax.jit(jax_raymap.raymap_from_camera_batch, static_argnums=(2, 3))
    rj = encode(jnp.asarray(trans2d), jnp.asarray(trans3d), (64, 96), 8)
    rt = port_raymap.raymap_from_camera_batch(torch.from_numpy(trans2d),
                                              torch.from_numpy(trans3d), (64, 96),
                                              vae_downsample=8)
    close(rj, rt, atol=2e-6)     # f32, unit-norm rays and O(1) origins
    ray = np.asarray(rj).transpose(0, 2, 1, 3, 4)
    decode = jax.jit(jax_raymap.raymap_to_camera, static_argnums=(1, 2, 3, 4))
    pj, ij = decode(jnp.asarray(ray), 1.0, True, True, 8)
    pt, it = port_raymap.raymap_to_camera(torch.from_numpy(ray), append_first_reference=True,
                                          from_relative_to_absolute=True, vae_downsample=8)
    close(pj, pt, atol=2e-5)     # f32 poses chained over 5 frames
    close(ij, it, rtol=2e-6, atol=0.0)   # f32 focal lengths of ~300
