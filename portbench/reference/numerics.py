"""The arithmetic the reference computes in: the configuration's stated
precision, or the control's, one step below it.

Modes:

  * ``fp32``: every product and sum in float32, TF32 off (``precise``);
    the reference of a bfloat16 configuration.
  * ``fp8``: the control of a bfloat16 configuration: every operand and
    every result of a linear layer, a convolution and an attention product
    rounded to float8 e4m3 with a per-tensor scale (its largest magnitude
    at 448), multiplied and summed in float32: the program's arithmetic
    (bfloat16 tensors, float32 sums) one precision lower.
  * ``w8a8``: the reference of the fast preset, whose stated precision is
    int8 where it quantises: the per-block MMDiT linears as W8A8 (a scale
    per output channel of the weight from ``max|w|``, one per token of the
    input from ``max|x|``, rounding half to even, the integer product,
    ``acc * sx * sw + bias`` in float32) and the 3x3x3 stride-1 VAE convs
    at heights of at least ``int8_min_h`` as int8 (one scale for the whole
    input the conv reads, one per output channel of the weight); all else
    in float32.
  * ``int4``: the control of the fast preset: the same layers with 7
    levels a side instead of 127, every other product in ``fp8``, and
    every product's result rounded to fp8.

Integer-valued operands are multiplied as float32: their products are
exact and the sums round far below the limits compared.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

MODES = ("fp32", "fp8", "w8a8", "int4")
#: float8 e4m3's largest finite value
FP8_MAX = 448.0


@contextlib.contextmanager
def precise():
    """float32 products without TF32, restoring the caller's settings."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def fp8_round(x: torch.Tensor) -> torch.Tensor:
    """x through float8 e4m3 with a per-tensor scale, back in float32."""
    x = x.to(torch.float32)
    s = torch.clamp_min(x.abs().amax(), 1e-30) / FP8_MAX
    return (x / s).to(torch.float8_e4m3fn).to(torch.float32) * s


def quant_levels(x: torch.Tensor, levels: int, dim=None):
    """(integer values as float32, scale) of symmetric quantisation with
    ``levels`` a side: over the whole tensor (``dim`` None; the scale
    clamped after the division, as the int8 conv's) or per row along
    ``dim`` kept (the per-token scale, clamped before it)."""
    x = x.to(torch.float32)
    if dim is None:
        s = torch.clamp_min(x.abs().amax() / levels, 1e-12)
    else:
        s = torch.clamp_min(x.abs().amax(dim=dim, keepdim=True), 1e-12) / levels
    return torch.round(x / s), s


def quant_weight(w: torch.Tensor, levels: int):
    """(integer values as float32, per-output-channel scale [co]) of a
    weight ``[co, ...]``: ``max(max|w[co]| / levels, 1e-12)``."""
    wf = w.to(torch.float32)
    s = torch.clamp_min(wf.abs().reshape(wf.shape[0], -1).amax(dim=1) / levels, 1e-12)
    return torch.round(wf / s.reshape((-1,) + (1,) * (wf.dim() - 1))), s


class Numerics:
    """Linear layers, convolutions and attention products in one mode."""

    def __init__(self, mode: str, int8_min_h: int = 256):
        if mode not in MODES:
            raise ValueError(f"numerics mode {mode!r}: expected one of {MODES}")
        self.mode = mode
        self.int8_min_h = int8_min_h
        self.levels = {"w8a8": 127, "int4": 7}.get(mode)

    def _float(self, x: torch.Tensor) -> torch.Tensor:
        """An operand of a float product: as is, or through fp8."""
        return fp8_round(x) if self.mode in ("fp8", "int4") else x.to(torch.float32)

    def _result(self, y: torch.Tensor) -> torch.Tensor:
        """A product's result (its bias added): as is, or through fp8 in
        the controls."""
        return fp8_round(y) if self.mode in ("fp8", "int4") else y

    def linear(self, x: torch.Tensor, w: torch.Tensor, b, quantised: bool = False):
        """``x @ w^T + b`` in float32; ``quantised`` marks the layers the
        W8A8 path quantises."""
        if quantised and self.levels is not None:
            xq, sx = quant_levels(x, self.levels, dim=-1)
            wq, sw = quant_weight(w, self.levels)
            y = (xq @ wq.t()) * sx * sw
        else:
            y = self._float(x) @ self._float(w).t()
        return self._result(y if b is None else y + b.to(torch.float32))

    def matmul(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """An attention product ``a @ b`` in float32 (fp8 operands in the
        controls)."""
        return self._result(self._float(a) @ self._float(b))

    def conv3d(self, xp: torch.Tensor, w: torch.Tensor, b, stride=(1, 1, 1)) -> torch.Tensor:
        """A 3-D convolution of ``xp`` (time padding and cache frames
        already prepended), zero-padded in space by the kernel's half
        width. The int8 modes quantise a 3x3x3 stride-1 conv at heights of
        at least ``int8_min_h``, with one scale over the whole of ``xp``."""
        kh, kw = w.shape[3], w.shape[4]
        pad = (0, kh // 2, kw // 2)
        if (self.levels is not None and tuple(w.shape[2:]) == (3, 3, 3)
                and tuple(stride) == (1, 1, 1) and xp.shape[3] >= self.int8_min_h):
            xq, sx = quant_levels(xp, self.levels)
            wq, sw = quant_weight(w, self.levels)
            y = F.conv3d(xq, wq, padding=pad) * (sx * sw).reshape(1, -1, 1, 1, 1)
        else:
            y = F.conv3d(self._float(xp), self._float(w), stride=stride, padding=pad)
        return self._result(y if b is None else y + b.to(torch.float32).reshape(1, -1, 1, 1, 1))
