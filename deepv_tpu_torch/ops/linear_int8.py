"""W8A8 linear for the MMDiT's per-block products (``denoise_int8``).

Counterpart of ``deepv_tpu/ops/linear_int8.py``: per-output-channel weight
scales from ``max|w|`` (made once, ``quantize_linear``), a dynamic
per-token activation scale from ``max|x|``, an int32 product, and an f32
dequant epilogue:

    sw = max(max|w[o]| / 127, 1e-12)          w8 = round(w / sw)
    sx = max(max|x[tok]|, 1e-12) / 127         x8 = round(x / sx)
    y  = f32(x8 @ w8^T) * sx * sw  (left to right), then + bias in f32,
         cast to x's dtype

with rounding half to even. Note the two scales clamp at different points,
as deepv_tpu's do. The product is ``torch._int_mm`` (cuBLASLt on CUDA, the
same call on the CPU); it is a plain matrix product outside any kernel, as
deepv_tpu leaves it to XLA's ``dot_general``. It takes more than 16 rows and
k, n multiples of 8; ``int_mm`` zero-pads any other shape up to that rule on
every device and slices the product back. Zero rows and columns add exactly
0 to the int32 sums, so deepv_tpu's shapes (a 16-row stage-0 product, odd
widths) compute, bit-equal, and nothing falls back to a floating-point
product.

``ops/basic.linear`` dispatches here when the module carries
``weight_int8``; which layers do is decided by ``models/mmdit.quantize_mmdit``
(the per-block attention and feed-forward linears; AdaLN, embedders and
``proj_out`` stay exact).
"""

from __future__ import annotations

from typing import Tuple

import torch

#: ``torch._int_mm`` calls since the count was last set to 0
calls = 0


def quantize_linear(weight: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``[out, in]`` -> (int8 weight, f32 per-output-channel scale)."""
    wf = weight.to(torch.float32)
    sw = torch.clamp_min(wf.abs().amax(dim=1) / 127.0, 1e-12)
    return torch.round(wf / sw[:, None]).to(torch.int8), sw


def quantize_tokens(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(x8, sx [..., 1]): per-token scale over the last axis."""
    xf = x.to(torch.float32)
    sx = torch.clamp_min(xf.abs().amax(dim=-1, keepdim=True), 1e-12) / 127.0
    return torch.round(xf / sx).to(torch.int8), sx


#: ``torch._int_mm``'s CUDA shape rule: more than this many rows ...
MIN_ROWS = 16
#: ... and k, n multiples of this
K_N_STEP = 8


def int_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` (int8 [m, k] @ int8 [k, n] -> int32) by ``torch._int_mm``,
    on every device: a shape outside its CUDA rule is zero-padded to at
    least 17 rows and to k, n multiples of 8, and the product sliced back
    (the padding adds exactly 0 to every sum)."""
    global calls
    m, k = a.shape
    n = b.shape[1]
    mp = max(m, MIN_ROWS + 1)
    kp, np_ = -(-k // K_N_STEP) * K_N_STEP, -(-n // K_N_STEP) * K_N_STEP
    if (mp, kp) != (m, k):
        a = torch.nn.functional.pad(a, (0, kp - k, 0, mp - m))
    if (kp, np_) != (k, n):                # padded as [n, k]: b stays column-major
        b = torch.nn.functional.pad(b.t(), (0, kp - k, 0, np_ - n)).t()
    calls += 1
    out = torch._int_mm(a, b)
    return out if (mp, np_) == (m, n) else out[:m, :n]


def linear_int8(x: torch.Tensor, p) -> torch.Tensor:
    """y = dequant(q(x) @ q(W)^T) + b; ``p`` holds ``weight_int8`` [out, in],
    ``weight_scale`` [out] and an optional ``bias``."""
    x8, sx = quantize_tokens(x)
    w8 = p.weight_int8
    acc = int_mm(x8.reshape(-1, x8.shape[-1]), w8.t())
    acc = acc.reshape(x.shape[:-1] + (w8.shape[0],))
    y = acc.to(torch.float32) * sx * p.weight_scale
    bias = getattr(p, "bias", None)
    if bias is not None:
        y = y + bias.to(torch.float32)
    return y.to(x.dtype)
