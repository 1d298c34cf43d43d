"""Spatial resampling with ``F.interpolate`` semantics.

Counterpart of ``deepv_tpu/ops/resample.py``: an exact 2x bilinear
downsample is a 2x2 mean, an exact 2x nearest upsample is a repeat, and the
generic resize is half-pixel linear interpolation without antialias
(``align_corners=False, antialias=False``). Inputs are channels-first
``[..., h, w]``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def down2x_bilinear(x: torch.Tensor) -> torch.Tensor:
    """2x bilinear downsample: a 2x2 mean for even dims, else the generic
    resize."""
    *lead, h, w = x.shape
    if h % 2 or w % 2:
        return resize_bilinear(x, (h // 2, w // 2))
    return x.reshape(*lead, h // 2, 2, w // 2, 2).mean(dim=(-3, -1))


def up2x_nearest(x: torch.Tensor) -> torch.Tensor:
    """Exact 2x nearest upsample == pixel duplication."""
    return x.repeat_interleave(2, dim=-2).repeat_interleave(2, dim=-1)


def resize_bilinear(x: torch.Tensor, size) -> torch.Tensor:
    """Bilinear resize of the trailing two axes, half-pixel centres, no
    antialias."""
    *lead, h, w = x.shape
    y = F.interpolate(x.reshape(-1, 1, h, w), size=tuple(size), mode="bilinear",
                      align_corners=False, antialias=False)
    return y.reshape(*lead, *size)


def resize_linear_1d(x: torch.Tensor, size: int) -> torch.Tensor:
    """Linear resize of the last axis, half-pixel centres, no antialias."""
    *lead, n = x.shape
    y = F.interpolate(x.reshape(-1, 1, n), size=size, mode="linear",
                      align_corners=False)
    return y.reshape(*lead, size)


def avg_pool2d(x: torch.Tensor, k: int) -> torch.Tensor:
    """Non-overlapping k x k average pool over the trailing two axes."""
    *lead, h, w = x.shape
    return x.reshape(*lead, h // k, k, w // k, k).mean(dim=(-3, -1))
