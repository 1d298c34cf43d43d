"""Causal 3D convolution with an explicit temporal cache.

Counterpart of ``deepv_tpu/ops/causal_conv.py`` (without the context- and
temporal-parallel halos). The temporal axis is padded only in the past; a
chunked pass carries the last two input frames of every kt=3 layer, so
consecutive chunks give the same output as one full pass. Modes:

  - ``full``:  whole clip at once, 2 zero frames of temporal padding;
  - ``init``:  first chunk; output as ``full``, and the cache is the last 2
               frames of the front-padded input;
  - ``cont``:  later chunk; the cached frames are prepended instead of
               padding. Stride 1 uses both cached frames, temporal stride 2
               only the last one, which keeps the stride phase;
  - ``prime``: cache rebuild; the input's own leading kt-1 frames are the
               context, so the output is kt-1 frames shorter and the cache
               equals a full pass's.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from .basic import conv3d


def causal_conv3d(x: torch.Tensor, p, cache: Optional[torch.Tensor], *,
                  mode: str = "full", stride: Tuple[int, int, int] = (1, 1, 1)
                  ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Apply a causal conv3d (``p`` holds weight [co, ci, kt, kh, kw] and
    bias). Returns ``(y, new_cache)``; the cache is None in ``full`` mode
    and for kt == 1 layers."""
    kt, kh, kw = p.weight.shape[2:]
    hp, wp = kh // 2, kw // 2
    time_pad = kt - 1
    if mode != "full" and kt not in (1, 3):
        raise ValueError(f"cached conv modes support kt in (1, 3); got kt={kt}")
    spatial = ((hp, hp), (wp, wp))

    if mode == "full" or kt == 1:
        return conv3d(x, p, stride=stride, padding=((time_pad, 0),) + spatial), None

    if mode == "init":
        xp = torch.cat([x.new_zeros(x.shape[:2] + (time_pad,) + x.shape[3:]), x], dim=2)
        return conv3d(xp, p, stride=stride, padding=((0, 0),) + spatial), _tail(xp, 2)

    if mode == "prime":
        if tuple(stride) != (1, 1, 1):
            raise ValueError("prime mode supports stride-1 convs only")
        if x.shape[2] <= time_pad:
            raise ValueError("prime mode needs more than kt-1 input frames")
        y = conv3d(x, p, stride=stride, padding=((0, 0),) + spatial)
        return y, _tail(x, kt - 1)

    if mode == "cont":
        if cache is None:
            raise ValueError("cont mode requires the previous chunk's cache")
        ctx = cache if stride[0] == 1 else cache[:, :, -1:]
        xp = torch.cat([ctx.to(x.dtype), x], dim=2)
        return conv3d(xp, p, stride=stride, padding=((0, 0),) + spatial), _tail(xp, 2)

    raise ValueError(f"unknown causal conv mode: {mode!r}")


def _tail(x: torch.Tensor, n: int) -> torch.Tensor:
    """The last n frames as their own tensor, so a cache never keeps the
    whole input alive."""
    return x[:, :, -n:].clone()
