"""The port's packed masked attention against deepv_tpu's.

``attention_plain`` (what the port runs on the CPU, and what the CUDA kernel
is held to on the card) against ``attention_pallas(..., interpret=True)``
and ``attention_reference`` on the layouts of tests/test_attention.py. The
kernel itself has no CPU form; here only its wrapper's dispatch is tested.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deepv_tpu.ops.attention import attention_pallas, attention_reference

from deepv_tpu_torch.ops import attention as port_attention
from deepv_tpu_torch.ops.attention import attention, attention_plain

torch.set_num_threads(1)

# tests/test_attention.py:31 (f32) and :49-50 (bf16)
F32_TOL = dict(atol=2e-5, rtol=1e-4)
BF16_TOL = dict(atol=3e-2, rtol=3e-2)


def make(b=2, s=70, h=3, d=16, seed=0):
    """test_attention.py's layout: masked ctx tokens at time 0, then four
    frames of video tokens; the inputs come from a numpy seed."""
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((b, s, h, d)).astype(np.float32) for _ in range(3))
    valid = np.ones((b, s), np.int32)
    valid[:, 8:12] = 0
    times = np.zeros(s, np.float32)
    n_ctx = 14
    per = (s - n_ctx) // 4
    for f in range(4):
        times[n_ctx + f * per: n_ctx + (f + 1) * per] = f
    times[n_ctx + 4 * per:] = 3
    return q, k, v, valid, times


def split_layout(s=96, n_last=32):
    """test_attention.py:73-89: padding frames in the prefix and a current
    unit of ``n_last`` tokens with the strictly largest time."""
    q, k, v, valid, times = make(s=s)
    valid[:, 20:30] = 0
    times[-n_last:] = 7.0
    valid[:, -n_last:] = 1
    return q, k, v, valid, times


def port(q, k, v, valid, times, dtype=torch.float32, n_last=0):
    t = lambda a: torch.from_numpy(a)
    return attention(t(q).to(dtype), t(k).to(dtype), t(v).to(dtype), t(valid), t(times),
                     n_last=n_last).to(torch.float32).numpy()


def jax_pallas(q, k, v, valid, times, dtype=jnp.float32, n_last=0):
    j = lambda a: jnp.asarray(a).astype(dtype)
    out = attention_pallas(j(q), j(k), j(v), jnp.asarray(valid), jnp.asarray(times),
                           block_q=32, interpret=True, n_last=n_last)
    return np.asarray(out, np.float32)


@pytest.mark.parametrize("s", [70, 96])
def test_plain_matches_pallas_and_reference_f32(s):
    q, k, v, valid, times = make(s=s)
    ref = np.asarray(attention_reference(*(jnp.asarray(a) for a in (q, k, v, valid, times))))
    got = port(q, k, v, valid, times)
    np.testing.assert_allclose(got, ref, **F32_TOL)
    np.testing.assert_allclose(got, jax_pallas(q, k, v, valid, times), **F32_TOL)


def test_plain_matches_pallas_bf16():
    q, k, v, valid, times = make()
    got = port(q, k, v, valid, times, dtype=torch.bfloat16)
    np.testing.assert_allclose(got, jax_pallas(q, k, v, valid, times, dtype=jnp.bfloat16),
                               **BF16_TOL)


@pytest.mark.parametrize("n_last", [14, 32])
def test_split_with_padding_frames(n_last):
    """With n_last (the rollout's current unit) and invalid prefix frames the
    port equals the TPU kernel's split path and the unsplit reference."""
    q, k, v, valid, times = split_layout(n_last=n_last)
    got = port(q, k, v, valid, times, n_last=n_last)
    np.testing.assert_allclose(got, jax_pallas(q, k, v, valid, times, n_last=n_last), **F32_TOL)
    ref = np.asarray(attention_reference(*(jnp.asarray(a) for a in (q, k, v, valid, times))))
    np.testing.assert_allclose(got, ref, **F32_TOL)
    # n_last is a promise about the layout; it never changes the result
    np.testing.assert_array_equal(got, port(q, k, v, valid, times))


@pytest.mark.parametrize("layout", ["frames", "split"])
def test_gradient_matches_reference(layout):
    """Autograd through the port's ``attention`` on the CPU (what training
    differentiates there) against ``jax.grad`` of ``attention_reference``,
    the jnp attention deepv_tpu trains through; f32 on both sides, so the
    forward's f32 tolerance."""
    q, k, v, valid, times = make() if layout == "frames" else split_layout()
    rng = np.random.default_rng(5)
    dout = rng.standard_normal(q.shape).astype(np.float32)
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    out = attention(*leaves, torch.from_numpy(valid), torch.from_numpy(times))
    got = torch.autograd.grad(out, leaves, torch.from_numpy(dout))
    ref = jax.grad(lambda q, k, v: jnp.sum(attention_reference(q, k, v, valid, times) * dout),
                   argnums=(0, 1, 2))(*(jnp.asarray(a) for a in (q, k, v)))
    for name, g, r in zip("qkv", got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), **F32_TOL, err_msg=f"d{name}")


def test_tf32_split_rebuilds_f32():
    """The f32 backward kernels' operand split: big and small are TF32
    values (the low 13 mantissa bits zero), big is x rounded to nearest
    TF32 (within 2^-11 of |x|), and big + small rebuilds x to within 2^-21
    of |x|, over magnitudes from 1e-30 to 1e30 and both signs."""
    rng = np.random.default_rng(3)
    x = (rng.standard_normal(20000) * 10.0 ** rng.uniform(-30, 30, 20000)).astype(np.float32)
    big, small = port_attention.tf32_split(torch.from_numpy(x))
    for part in (big, small):
        assert not bool((part.view(torch.int32) & 0x1FFF).any())
    x64, big64, small64 = (np.asarray(a, np.float64) for a in (x, big, small))
    assert np.all(np.abs(big64 - x64) <= 2.0 ** -11 * np.abs(x64))
    assert np.all(np.abs(big64 + small64 - x64) <= 2.0 ** -21 * np.abs(x64))
    # ties go away from zero, as cvt.rna.tf32.f32 rounds them
    tie = np.array([1 + 2.0 ** -11, -(1 + 2.0 ** -11)], np.float32)
    got = port_attention.tf32_split(torch.from_numpy(tie))[0].numpy()
    np.testing.assert_array_equal(got, [1 + 2.0 ** -10, -(1 + 2.0 ** -10)])


@pytest.mark.parametrize("layout", ["frames", "split"])
def test_3xtf32_backward_meets_the_chip_tolerance(layout, monkeypatch):
    """Every product of the backward in the three-product TF32 form, as the
    f32 kernels take them (S = 96, 2 heads of 64, f32), lies within the
    tolerance the kernels are held to on the card (chip_smoke.py's
    BWD_F32_ATOL / BWD_F32_RTOL, 5e-5 / 1e-4) of the f64 plain backward;
    one TF32 product (big . big) does not."""
    q, k, v, valid, times = (make(s=96, h=2, d=64) if layout == "frames"
                             else split_layout(s=96, n_last=32))
    if layout == "split":
        rng = np.random.default_rng(1)
        q, k, v = (rng.standard_normal((2, 96, 2, 64)).astype(np.float32) for _ in range(3))
    dout = np.random.default_rng(9).standard_normal(q.shape).astype(np.float32)
    t = lambda a: torch.from_numpy(a)
    ref = port_attention.attention_backward_plain(
        *(t(a).double() for a in (q, k, v, dout)), t(valid), t(times))
    got = port_attention.attention_backward_3xtf32(t(q), t(k), t(v), t(dout), t(valid), t(times))
    for name, g, r in zip(("dq", "dk", "dv"), got, ref):
        assert g.dtype == torch.float32
        torch.testing.assert_close(g.double(), r, atol=5e-5, rtol=1e-4,
                                   msg=lambda m: f"d{name}: {m}")
    tf32 = port_attention.tf32_split
    monkeypatch.setattr(port_attention, "matmul_3xtf32", lambda a, b: tf32(a)[0] @ tf32(b)[0])
    coarse = port_attention.attention_backward_3xtf32(t(q), t(k), t(v), t(dout), t(valid),
                                                      t(times))
    assert any(not torch.allclose(g.double(), r, atol=5e-5, rtol=1e-4)
               for g, r in zip(coarse, ref))


def middle_skip_layout(s=96):
    """chip_smoke.py's middle-skip edge layout, cut to ``s`` tokens: rows at
    time 0 skip the time-5 keys in the middle of the sequence, then attend
    the time -1 keys after them."""
    rng = np.random.default_rng(6)
    q, k, v = (rng.standard_normal((2, s, 2, 64)).astype(np.float32) for _ in range(3))
    times = np.zeros(s, np.float32)
    times[s * 3 // 10:s * 7 // 10] = 5.0
    times[s * 7 // 10:] = -1.0
    return q, k, v, np.ones((2, s), np.int32), times


FORWARD_LAYOUTS = {
    "causal": lambda: make(s=96, h=2, d=64),
    "middle_skip": middle_skip_layout,
    "short": lambda: make(s=37, h=2, d=64),        # S < 64: one ragged tile
}


@pytest.mark.parametrize("layout", sorted(FORWARD_LAYOUTS))
def test_3xtf32_forward_meets_the_chip_tolerance(layout, monkeypatch):
    """The f32 forward kernel's arithmetic (``attention_3xtf32``: S = Q.K^T
    and O = P.V each three TF32 products, the softmax in base 2) against
    ``attention_pallas(..., interpret=True)`` and ``attention_reference`` on
    the same f32 inputs, at the f32 tolerance the kernel is held to on the
    card (chip_smoke.py phase 3, atol 2e-5 / rtol 1e-4); its LSE within
    phase 14's 1e-4 plus 1e-5 of the largest |LSE| of the f64 plain LSE.
    One TF32 product (big . big) does not meet the tolerance."""
    q, k, v, valid, times = FORWARD_LAYOUTS[layout]()
    t = lambda a: torch.from_numpy(a)
    refs = [jax_pallas(q, k, v, valid, times),
            np.asarray(attention_reference(*(jnp.asarray(a) for a in (q, k, v, valid, times))))]
    out, lse = port_attention.attention_3xtf32(t(q), t(k), t(v), t(valid), t(times))
    assert out.dtype == lse.dtype == torch.float32
    for ref in refs:
        np.testing.assert_allclose(out.numpy(), ref, **F32_TOL)
    lse_ref = port_attention.attention_lse_plain(t(q).double(), t(k).double(), t(valid),
                                                 t(times))
    assert (lse.double() - lse_ref).abs().max() <= 1e-4 + 1e-5 * lse_ref.abs().max()
    tf32 = port_attention.tf32_split
    monkeypatch.setattr(port_attention, "matmul_3xtf32", lambda a, b: tf32(a)[0] @ tf32(b)[0])
    coarse = port_attention.attention_3xtf32(t(q), t(k), t(v), t(valid), t(times))[0].numpy()
    assert not any(np.allclose(coarse, ref, **F32_TOL) for ref in refs)


class _CudaTensor(torch.Tensor):
    """A CPU tensor that reports a CUDA device, to reach the kernel path of
    the wrapper without a GPU."""

    @property
    def device(self):
        return torch.device("cuda", 0)


def _as_cuda(arrays):
    return [torch.from_numpy(a).as_subclass(_CudaTensor) for a in arrays]


def test_cuda_tensor_without_kernel_raises(monkeypatch):
    """On a CUDA tensor the wrapper launches the kernel or raises: a missing
    kernel library is an error, never a fallback to the plain version."""
    def no_library():
        raise RuntimeError("kernel library not built")

    def plain_must_not_run(*args):
        raise AssertionError("fell back to the plain version")

    monkeypatch.setattr(port_attention, "load_library", no_library)
    monkeypatch.setattr(port_attention, "attention_plain", plain_must_not_run)
    q, k, v, valid, times = make(d=64)
    before = port_attention.launches
    with pytest.raises(RuntimeError, match="not built"):
        attention(*_as_cuda([q, k, v, valid, times]))
    assert port_attention.launches == before


def test_cuda_tensor_without_nvcc_raises(monkeypatch):
    """The real loader, with no CUDA toolkit to build from, raises too."""
    from deepv_tpu_torch.utils import cuda_build
    monkeypatch.setattr(port_attention, "_library", None)
    monkeypatch.setattr(cuda_build, "BUILD_DIR", cuda_build.BUILD_DIR / "absent-for-test")
    monkeypatch.setattr(cuda_build, "find_nvcc", lambda: None)
    q, k, v, valid, times = make(d=64)
    with pytest.raises(RuntimeError, match="nvcc"):
        attention(*_as_cuda([q, k, v, valid, times]))


@pytest.mark.parametrize("bad", ["dtype", "head_dim", "valid_dtype", "contiguous", "too_long",
                                 "misaligned"])
def test_kernel_path_rejects_what_the_kernel_does_not_take(bad):
    s = port_attention.MAX_SEQ + 1 if bad == "too_long" else 70
    q, k, v, valid, times = make(s=s, h=1 if bad == "too_long" else 3,
                                 d=64 if bad != "head_dim" else 16)
    if bad == "dtype":
        q, k, v = (a.astype(np.float64) for a in (q, k, v))
    if bad == "valid_dtype":
        valid = valid.astype(np.int64)
    qt, kt, vt, vat, tt = _as_cuda([q, k, v, valid, times])
    if bad == "contiguous":
        qt = qt.transpose(1, 2).contiguous().transpose(1, 2)
    if bad == "misaligned":       # a contiguous view 4 bytes into its storage: TMA needs 16
        flat = torch.from_numpy(np.concatenate([[0.0], q.ravel()]).astype(np.float32))
        qt = flat[1:].reshape(q.shape).as_subclass(_CudaTensor)
    with pytest.raises((TypeError, ValueError)):
        attention(qt, kt, vt, vat, tt)
