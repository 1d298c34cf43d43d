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


@pytest.mark.parametrize("bad", ["dtype", "head_dim", "valid_dtype", "contiguous"])
def test_kernel_path_rejects_what_the_kernel_does_not_take(bad):
    q, k, v, valid, times = make(d=64 if bad != "head_dim" else 16)
    if bad == "dtype":
        q, k, v = (a.astype(np.float64) for a in (q, k, v))
    if bad == "valid_dtype":
        valid = valid.astype(np.int64)
    qt, kt, vt, vat, tt = _as_cuda([q, k, v, valid, times])
    if bad == "contiguous":
        qt = qt.transpose(1, 2).contiguous().transpose(1, 2)
    with pytest.raises((TypeError, ValueError)):
        attention(qt, kt, vt, vat, tt)
