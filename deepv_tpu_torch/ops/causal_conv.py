"""Causal 3D convolution with an explicit temporal cache.

Counterpart of ``deepv_tpu/ops/causal_conv.py``. The temporal axis is
padded only in the past; a chunked pass carries the last two input frames
of every kt=3 layer, so consecutive chunks give the same output as one full
pass. Modes:

  - ``full``:  whole clip at once, 2 zero frames of temporal padding;
  - ``init``:  first chunk; output as ``full``, and the cache is the last 2
               frames of the front-padded input;
  - ``cont``:  later chunk; the cached frames are prepended instead of
               padding. Stride 1 uses both cached frames, temporal stride 2
               only the last one, which keeps the stride phase;
  - ``prime``: cache rebuild; the input's own leading kt-1 frames are the
               context, so the output is kt-1 frames shorter and the cache
               equals a full pass's.

``impl="igemm"`` sends every layer that ``supports_igemm`` accepts through
the implicit-GEMM kernel (``ops/conv_igemm.py``); ``impl="int8"`` every
layer that ``supports_int8`` accepts through the quantised conv
(``ops/conv_int8.py``), whose activation scale covers the whole tensor the
conv reads: the cache frames with x in ``init``/``cont``/``prime`` mode, x
alone in ``full`` mode. The other layers (1x1 shortcuts, strided
down-samplers, narrow in/out convs, and for int8 the levels below
``MIN_H``) keep ``F.conv3d``, as deepv_tpu keeps XLA's conv for them.

Context parallelism (``parallel/cp.py``), one process per rank:

  - ``cp_group``: x is this rank's slice of the image height. A k=3 conv
    takes one row from each neighbour (``parallel/comm.halo``, zeros at
    the ends: the conv's own zero padding) and pads H no further; a
    spatially strided conv, whose windows start at even rows, takes the
    row above only. W keeps its padding. The cache is the last frames of
    the halo-extended input, so a carried cache already holds the
    neighbours' rows. Under ``cp_group`` every layer takes ``F.conv3d``,
    as deepv_tpu leaves its igemm and int8 layers to XLA's conv there.
  - ``tp_group``: x is this rank's slice of time, in ``cont`` mode only,
    at least 2 frames: the temporal context is the previous rank's last 2
    input frames, and rank 0 takes ``cache`` (the first window's).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.distributed as dist

from ..parallel import comm
from .basic import conv3d
from .conv_igemm import conv3d_igemm, supports_igemm
from .conv_int8 import conv3d_int8, supports_int8


def causal_conv3d(x: torch.Tensor, p, cache: Optional[torch.Tensor], *,
                  mode: str = "full", stride: Tuple[int, int, int] = (1, 1, 1),
                  impl: str = "xla", cp_group=None, tp_group=None
                  ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Apply a causal conv3d (``p`` holds weight [co, ci, kt, kh, kw] and
    bias). Returns ``(y, new_cache)``; the cache is None in ``full`` mode
    and for kt == 1 layers. ``impl`` is "xla" (``F.conv3d``), "igemm" or
    "int8". ``cp_group`` / ``tp_group``: x is this rank's slice of the
    height / of time (the module docstring)."""
    kt, kh, kw = p.weight.shape[2:]
    hp, wp = kh // 2, kw // 2
    time_pad = kt - 1
    if mode != "full" and kt not in (1, 3):
        raise ValueError(f"cached conv modes support kt in (1, 3); got kt={kt}")
    if cp_group is not None and kh == 3:
        top, bottom = comm.halo(x, 3, cp_group, before=1, after=1 if stride[1] == 1 else 0)
        x, hp = torch.cat([top, x, bottom], dim=3), 0
    if tp_group is not None and kt > 1:
        if mode != "cont" or cache is None:
            raise ValueError("temporal CP runs every rank in cont mode, with the first "
                             "window's cache")
        if x.shape[2] < 2:
            raise ValueError("temporal CP needs >= 2 local frames at every temporal level")
        prev, _ = comm.halo(x, 2, tp_group, before=2, after=0)
        if dist.get_rank(tp_group) > 0:
            cache = prev
    spatial = ((hp, hp), (wp, wp))
    split = cp_group is not None
    igemm = impl == "igemm" and not split and supports_igemm(p.weight.shape, stride, x.dtype,
                                                             x.shape[3], x.shape[4])
    int8 = impl == "int8" and not split and supports_int8(p.weight.shape, stride, x.shape[3])

    def conv(xp, pad_t):
        # eligible layers: the kernel, with the cache frames already in xp
        if igemm:
            return conv3d_igemm(xp, p, time_pad=pad_t)
        if int8:
            return conv3d_int8(xp, p, time_pad=pad_t)
        return conv3d(xp, p, stride=stride, padding=((pad_t, 0),) + spatial)

    if mode == "full" or kt == 1:
        return conv(x, time_pad), None

    if mode == "init":
        xp = torch.cat([x.new_zeros(x.shape[:2] + (time_pad,) + x.shape[3:]), x], dim=2)
        return conv(xp, 0), _tail(xp, 2)

    if mode == "prime":
        if tuple(stride) != (1, 1, 1):
            raise ValueError("prime mode supports stride-1 convs only")
        if x.shape[2] <= time_pad:
            raise ValueError("prime mode needs more than kt-1 input frames")
        return conv(x, 0), _tail(x, kt - 1)

    if mode == "cont":
        if cache is None:
            raise ValueError("cont mode requires the previous chunk's cache")
        ctx = cache if stride[0] == 1 else cache[:, :, -1:]
        xp = torch.cat([ctx.to(x.dtype), x], dim=2)
        return conv(xp, 0), _tail(xp, 2)

    raise ValueError(f"unknown causal conv mode: {mode!r}")


def _tail(x: torch.Tensor, n: int) -> torch.Tensor:
    """The last n frames as their own tensor, so a cache never keeps the
    whole input alive."""
    return x[:, :, -n:].clone()
