"""Temporal rotary position embedding (RoPE) for the packed MMDiT sequence.

Counterpart of ``deepv_tpu/ops/rope.py``. The cos/sin tables are ``[seq, d/2]``
and rotate *interleaved* (even, odd) feature pairs:
``out_even = cos*x_even - sin*x_odd; out_odd = sin*x_even + cos*x_odd``.
"""

from __future__ import annotations

import numpy as np
import torch

from .basic import compute_dtype


def rope_tables(pos: np.ndarray, dim: int, theta: float = 10000.0):
    """Host cos/sin tables for positions ``pos`` ([seq]) -> each [seq, dim//2],
    computed in float64."""
    assert dim % 2 == 0
    scale = np.arange(0, dim, 2, dtype=np.float64) / dim
    omega = 1.0 / (theta ** scale)
    out = np.asarray(pos, dtype=np.float64)[:, None] * omega[None, :]
    return np.cos(out), np.sin(out)


def rope_tables_torch(pos: torch.Tensor, dim: int, theta: float = 10000.0):
    """Tables for positions held in a tensor (the rollout's per-token times),
    computed in float64 on ``pos``'s device; ``apply_rope`` casts them to
    its compute type."""
    scale = torch.arange(0, dim, 2, dtype=torch.float64, device=pos.device) / dim
    omega = 1.0 / (theta ** scale)
    out = pos.to(torch.float64)[:, None] * omega[None, :]
    return torch.cos(out), torch.sin(out)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Rotate interleaved feature pairs of ``x`` [..., seq, heads, dim];
    cos/sin [seq, dim//2]. Computed in at-least-f32."""
    ct = compute_dtype(x.dtype)
    *lead, s, h, d = x.shape
    xf = x.to(ct).reshape(*lead, s, h, d // 2, 2)
    c = cos.to(ct)[:, None, :]          # [seq, 1 (head), d/2]
    si = sin.to(ct)[:, None, :]
    even, odd = xf[..., 0], xf[..., 1]
    rot = torch.stack([c * even - si * odd, si * even + c * odd], dim=-1)
    return rot.reshape(*lead, s, h, d).to(x.dtype)
