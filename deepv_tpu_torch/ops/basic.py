"""Layer primitives on tensors, with the JAX package's torch-layout weights.

Counterpart of ``deepv_tpu/ops/basic.py``. Linear weights are ``[out, in]``
and conv weights ``[out, in, *kernel]``, which is PyTorch's own layout, so
the functions call ``F.linear``/``F.conv3d`` directly. Norms compute in at
least float32 and never force float32: a float64 input stays float64, which
the f64 parity tests rely on.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from .linear_int8 import linear_int8


def compute_dtype(dtype: torch.dtype) -> torch.dtype:
    """At-least-float32 (``jnp.promote_types(dtype, float32)``)."""
    return torch.promote_types(dtype, torch.float32)


def fma_f32(a, b, c) -> torch.Tensor:
    """a * b + c in float32 with one rounding (a fused multiply-add, the form
    XLA compiles such an expression to). The product of two f32 values is
    exact in f64, so forming it and the sum in f64 and rounding once gives
    the fused result."""
    f64 = torch.float64
    return (a.to(torch.float32).to(f64) * b.to(torch.float32).to(f64)
            + c.to(torch.float32).to(f64)).to(torch.float32)


def exp_f32(x: torch.Tensor) -> torch.Tensor:
    """exp of float32 values, correctly rounded: evaluated in f64 and
    rounded to f32, so the result carries no library's f32 ulps."""
    return torch.exp(x.to(torch.float32).to(torch.float64)).to(torch.float32)


def linear(x: torch.Tensor, p) -> torch.Tensor:
    """y = x @ W^T + b with W stored [out, in]; ``p`` holds ``weight`` and
    an optional ``bias`` (an ``nn.Linear`` or any module with those). A
    module carrying ``weight_int8`` (``models/mmdit.quantize_mmdit``) runs
    the W8A8 path, ``ops/linear_int8.py``."""
    if hasattr(p, "weight_int8"):
        return linear_int8(x, p)
    y = F.linear(x, p.weight.to(x.dtype))
    bias = getattr(p, "bias", None)
    if bias is not None:
        y = y + bias.to(y.dtype)
    return y


def layer_norm(x: torch.Tensor, eps: float = 1e-6,
               weight: Optional[torch.Tensor] = None,
               bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """LayerNorm over the last axis in at-least-f32."""
    ct = compute_dtype(x.dtype)
    xf = x.to(ct)
    mean = xf.mean(dim=-1, keepdim=True)
    var = (xf - mean).square().mean(dim=-1, keepdim=True)
    out = (xf - mean) * torch.rsqrt(var + eps)
    if weight is not None:
        out = out * weight.to(ct)
    if bias is not None:
        out = out + bias.to(ct)
    return out.to(x.dtype)


def rms_norm(x: torch.Tensor, weight: Optional[torch.Tensor], eps: float) -> torch.Tensor:
    """RMSNorm over the last axis in at-least-f32; the weight multiplies
    after the cast back, as in the JAX package."""
    xf = x.to(compute_dtype(x.dtype))
    var = xf.square().mean(dim=-1, keepdim=True)
    out = (xf * torch.rsqrt(var + eps)).to(x.dtype)
    if weight is not None:
        out = out * weight.to(x.dtype)
    return out


def group_norm(x: torch.Tensor, num_groups: int, weight: torch.Tensor,
               bias: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """GroupNorm over a channels-first tensor ``[b, c, *spatial]``; callers
    fold time into batch so statistics never cross frames."""
    b, c = x.shape[0], x.shape[1]
    spatial = x.shape[2:]
    ct = compute_dtype(x.dtype)
    xf = x.to(ct).reshape(b, num_groups, c // num_groups, -1)
    mean = xf.mean(dim=(2, 3), keepdim=True)
    var = (xf - mean).square().mean(dim=(2, 3), keepdim=True)
    xf = ((xf - mean) * torch.rsqrt(var + eps)).reshape(b, c, *spatial)
    shape = (1, c) + (1,) * len(spatial)
    out = xf * weight.to(ct).reshape(shape) + bias.to(ct).reshape(shape)
    return out.to(x.dtype)


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    """gelu(approximate='tanh'), the DiT feed-forward activation."""
    return F.gelu(x, approximate="tanh")


def silu(x: torch.Tensor) -> torch.Tensor:
    return F.silu(x)


def conv3d(x: torch.Tensor, p, stride=(1, 1, 1),
           padding=((0, 0), (0, 0), (0, 0))) -> torch.Tensor:
    """3D convolution, x: [b, c_in, t, h, w]; weight [c_out, c_in, kt, kh, kw].
    ``padding`` is per axis (before, after), as in ``lax.conv``."""
    x, sym = _split_pad(x, padding)
    y = F.conv3d(x, p.weight.to(x.dtype), stride=stride, padding=sym)
    if getattr(p, "bias", None) is not None:
        y = y + p.bias.to(y.dtype).reshape(1, -1, 1, 1, 1)
    return y


def conv2d(x: torch.Tensor, p, stride=(1, 1),
           padding=((0, 0), (0, 0))) -> torch.Tensor:
    """2D convolution, x: [b, c, h, w]; weight [c_out, c_in, kh, kw]."""
    x, sym = _split_pad(x, padding)
    y = F.conv2d(x, p.weight.to(x.dtype), stride=stride, padding=sym)
    if getattr(p, "bias", None) is not None:
        y = y + p.bias.to(y.dtype).reshape(1, -1, 1, 1)
    return y


def _split_pad(x: torch.Tensor, padding):
    """Split per-axis (before, after) zero padding into the symmetric part,
    which the convolution applies itself, and the rest, padded here."""
    sym = tuple(min(lo, hi) for lo, hi in padding)
    flat = []
    for (lo, hi), s in zip(reversed(tuple(padding)), reversed(sym)):
        flat += [lo - s, hi - s]
    return (F.pad(x, flat) if any(flat) else x), sym
