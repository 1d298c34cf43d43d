"""Symmetric int8 3x3x3 conv: the hand-written Hopper kernel (K3) and its plain version.

Counterpart of ``deepv_tpu/ops/conv_int8.py``, the quality-gated fast path of
``VAEConfig(conv_impl="int8")``: per-output-channel weight scales from
``max|w|``, one dynamic activation scale per call from ``max|x|`` over the
whole tensor the conv reads (in ``init``/``cont``/``prime`` mode that
includes the prepended cache frames), int32 accumulation, and an f32
dequant epilogue:

    sw = max(max|w[co]| / 127, 1e-12)          w8 = round(w / sw)
    sx = max(max|x| / 127, 1e-12)              x8 = round(x / sx)
    y  = f32(conv(x8, w8)) * (sx * sw[co]) + bias[co], cast to x's dtype

with rounding half to even, the scale product formed first, the bias added
in f32 after it (deepv_tpu's ``conv_int8.py:84-95``). ``time_pad=2`` puts two
zero frames in the temporal past (``full`` mode); ``time_pad=0`` expects the
context frames already concatenated. Zero padding stays exact: 0 quantises
to 0.

``supports_int8`` is deepv_tpu's dispatch rule: 3x3x3 stride-1 convs at
heights of at least ``MIN_H``, read from the module at call time. 256 is
deepv_tpu's choice for its TPU; whether it suits the H100 is open.

The kernel (``csrc/conv_int8.cu``, ``deepv_conv3d_int8``) has no TPU
kernel to replace: deepv_tpu leaves the int8 conv to XLA, and PyTorch has no
int8 3D convolution on CUDA. It reads the quantised input channels-last,
``[b, t, h, w, ci_pad]``, and the weight as ``[27, co_pad, ci_pad]``
(``weight_k3``, made once by ``quantize_conv_weights``), and runs mma.sync
s8 products with int32 accumulators, which equal the plain version's bit
for bit. The amax, the divide, the round, the int8 cast and the
channels-last copy are PyTorch ops in the wrapper (``quantize_input``), as
they are XLA ops in deepv_tpu.

``conv3d_int8`` takes the plain version only for tensors on the CPU; for
CUDA tensors it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

#: quantise only convs at spatial heights of at least this (deepv_tpu's rule)
MIN_H = 256

#: launches of the kernel since the count was last set to 0
launches = 0

_library: Optional[ctypes.CDLL] = None
_OUT_CODE = {torch.float32: 0, torch.bfloat16: 1}
#: input channels per K step of the kernel (x8 and the weight are padded to it)
CI_STEP = 32


def supports_int8(weight_shape: Tuple[int, ...], stride: Tuple[int, int, int], h: int) -> bool:
    """Dispatch predicate: 3x3x3 stride-1 convs with h >= ``MIN_H``."""
    return (tuple(weight_shape[2:]) == (3, 3, 3) and tuple(stride) == (1, 1, 1)
            and h >= MIN_H)


def channel_tile(co: int) -> int:
    """The kernel's CTA width in output channels: 128 where co is a multiple
    of it, else 16 (the 3-channel ``conv_out``)."""
    return 128 if co % 128 == 0 else 16


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def quantize_weight(weight: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``[co, ci, 3, 3, 3]`` -> (int8 weight, f32 per-output-channel scale)."""
    wf = weight.to(torch.float32)
    sw = torch.clamp_min(wf.abs().amax(dim=(1, 2, 3, 4)) / 127.0, 1e-12)
    return torch.round(wf / sw[:, None, None, None, None]).to(torch.int8), sw


def k3_weight(w8: torch.Tensor) -> torch.Tensor:
    """int8 ``[co, ci, 3, 3, 3]`` -> the kernel's ``[27, co_pad, ci_pad]``:
    tap-major, input channels contiguous, zero-padded to the kernel's
    channel tile and to a multiple of 32 input channels."""
    co, ci = w8.shape[:2]
    out = w8.new_zeros((27, _round_up(co, channel_tile(co)), _round_up(ci, CI_STEP)))
    out[:, :co, :ci] = w8.permute(2, 3, 4, 0, 1).reshape(27, co, ci)
    return out


def quantize_conv_weights(conv: nn.Module) -> nn.Module:
    """Register the int8 weight (``weight_int8``, deepv_tpu's layout), its
    scales (``weight_scale``) and the kernel's layout (``weight_k3``) as
    buffers of ``conv``, made once; ``conv3d_int8`` reads them."""
    w8, sw = quantize_weight(conv.weight)
    conv.register_buffer("weight_int8", w8)
    conv.register_buffer("weight_scale", sw)
    conv.register_buffer("weight_k3", k3_weight(w8))
    return conv


def quantize_vae_convs(module: nn.Module) -> nn.Module:
    """Precompute the int8 buffers of every 3x3x3 conv under ``module`` (a VAE
    encoder or decoder), as deepv_tpu does once at pipeline construction;
    layers the ``MIN_H`` rule never routes to int8 carry them unused."""
    for m in module.modules():
        w = getattr(m, "weight", None)
        if isinstance(w, torch.Tensor) and w.dim() == 5 and tuple(w.shape[2:]) == (3, 3, 3):
            quantize_conv_weights(m)
    return module


def _weights(p) -> Tuple[torch.Tensor, torch.Tensor]:
    """(int8 weight, scale): the precomputed buffers, else quantised now."""
    if hasattr(p, "weight_int8"):
        return p.weight_int8, p.weight_scale
    return quantize_weight(p.weight)


def input_scale(x: torch.Tensor) -> torch.Tensor:
    """sx = max(max|f32(x)| / 127, 1e-12) in f32 over the whole tensor: one
    reduction pass, no |x| temporary. Rounding to f32 keeps order, so the
    max can be taken before the cast."""
    amax = torch.linalg.vector_norm(x, ord=float("inf")).to(torch.float32)
    return torch.clamp_min(amax / 127.0, 1e-12)


def quantize_input(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(x8 [b, ci, t, h, w] int8, sx): round(f32(x) / sx), half to even."""
    sx = input_scale(x)
    q = x.to(torch.float32, copy=True)
    return q.div_(sx).round_().to(torch.int8), sx


def quantize_input_k3(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's input: (x8 [b, t, h, w, ci_pad] int8, sx), the same
    values as ``quantize_input`` laid out channels-last with zero channels
    appended up to a multiple of 32."""
    b, ci, t, h, w = x.shape
    sx = input_scale(x)
    q = x.to(torch.float32, copy=True).div_(sx).round_()
    ci_pad = _round_up(ci, CI_STEP)
    if ci_pad == ci:
        return q.permute(0, 2, 3, 4, 1).to(torch.int8, memory_format=torch.contiguous_format), sx
    x8 = torch.zeros((b, t, h, w, ci_pad), dtype=torch.int8, device=x.device)
    x8[..., :ci] = q.permute(0, 2, 3, 4, 1)
    return x8, sx


def accumulate_plain(x8: torch.Tensor, w8: torch.Tensor, time_pad: int) -> torch.Tensor:
    """The exact integer conv: int8 values convolved in f64 (every partial
    sum is an integer below 2^53, so any order is exact), cast to int32.
    x8 [b, ci, t, h, w] -> [b, co, t + time_pad - 2, h, w]."""
    xp = F.pad(x8.to(torch.float64), (1, 1, 1, 1, time_pad, 0))
    return F.conv3d(xp, w8.to(torch.float64)).to(torch.int32)


def dequantize(acc: torch.Tensor, sx: torch.Tensor, sw: torch.Tensor, bias,
               dtype: torch.dtype) -> torch.Tensor:
    """f32(acc) * (sx * sw[co]), then + bias in f32, cast to ``dtype``."""
    shape = (1, -1, 1, 1, 1)
    out = acc.to(torch.float32) * (sx * sw).reshape(shape)
    if bias is not None:
        out = out + bias.to(torch.float32).reshape(shape)
    return out.to(dtype)


def conv3d_int8_plain(x: torch.Tensor, p, time_pad: int = 2) -> torch.Tensor:
    """Plain PyTorch version: ``quantize_input``, ``accumulate_plain``,
    ``dequantize``. x [b, ci, t, h, w] -> [b, co, t + time_pad - 2, h, w]."""
    w8, sw = _weights(p)
    x8, sx = quantize_input(x)
    acc = accumulate_plain(x8, w8, time_pad)
    return dequantize(acc, sx, sw, getattr(p, "bias", None), x.dtype)


def load_library() -> ctypes.CDLL:
    """Build (at first use) and load the kernel library."""
    global _library
    if _library is None:
        from ..utils.cuda_build import build
        lib = build("conv_int8.cu").lib
        fn = lib.deepv_conv3d_int8
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 11 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _library = lib
    return _library


def _check_kernel_inputs(x: torch.Tensor, p, time_pad: int) -> None:
    if x.dtype not in _OUT_CODE:
        raise TypeError(f"int8 conv kernel writes float32 or bfloat16, got {x.dtype}")
    if x.dim() != 5:
        raise ValueError(f"x must be [b, ci, t, h, w], got {tuple(x.shape)}")
    b, ci, t_in, h, w = x.shape
    if tuple(p.weight.shape[1:]) != (ci, 3, 3, 3):
        raise ValueError(f"weight must be [co, {ci}, 3, 3, 3], got {tuple(p.weight.shape)}")
    if time_pad not in (0, 2) or t_in + time_pad - 2 < 1:
        raise ValueError(f"time_pad must be 0 or 2 with at least one output frame; got "
                         f"time_pad={time_pad}, t_in={t_in}")
    if b * (t_in + time_pad - 2) > 65535:
        raise ValueError(f"int8 conv kernel takes at most 65535 output frames, got "
                         f"{b * (t_in + time_pad - 2)}")


def _launch(x: torch.Tensor, p, time_pad: int, acc_only: bool) -> torch.Tensor:
    """Quantise x and launch the kernel: the dequantised output in x's
    dtype, or (``acc_only``) the int32 accumulators."""
    global launches
    if x.device.type != "cuda":
        raise ValueError(f"the int8 conv kernel runs on CUDA tensors, got {x.device}")
    _check_kernel_inputs(x, p, time_pad)
    lib = load_library()
    w8, sw = _weights(p)
    wk = p.weight_k3 if hasattr(p, "weight_k3") else k3_weight(w8)
    co = p.weight.shape[0]
    b, _, t_in, h, w = x.shape
    t_out = t_in + time_pad - 2
    x8, sx = quantize_input_k3(x)
    scale = (sx * sw).contiguous()
    bias = getattr(p, "bias", None)
    bias = (scale.new_zeros((co,)) if bias is None else bias.to(torch.float32)).contiguous()
    for name, t in (("weight", wk), ("scale", scale), ("bias", bias)):
        if t.device != x.device:
            raise ValueError(f"{name} must lie on x's CUDA device, got {t.device}")
    shape = (b, co, t_out, h, w)
    if acc_only:
        acc, out = torch.empty(shape, dtype=torch.int32, device=x.device), None
    else:
        acc, out = None, torch.empty(shape, dtype=x.dtype, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = lib.deepv_conv3d_int8(
        x8.data_ptr(), wk.data_ptr(), scale.data_ptr(), bias.data_ptr(),
        None if out is None else out.data_ptr(), None if acc is None else acc.data_ptr(),
        b, x8.shape[-1], co, wk.shape[1], t_in, t_out, h, w, time_pad, _OUT_CODE[x.dtype],
        channel_tile(co), stream)
    if err != 0:
        raise RuntimeError(f"int8 conv kernel launch failed: error {err}")
    launches += 1
    return acc if acc_only else out


def conv3d_int8(x: torch.Tensor, p, time_pad: int = 2) -> torch.Tensor:
    """Quantised 3x3x3 stride-1 causal conv; ``p`` holds ``weight`` [co, ci,
    3, 3, 3], an optional ``bias`` and, after ``quantize_conv_weights``, the
    int8 buffers. x [b, ci, t, h, w] -> [b, co, t + time_pad - 2, h, w] in
    x's dtype."""
    if x.device.type == "cpu":
        return conv3d_int8_plain(x, p, time_pad)
    return _launch(x, p, time_pad, acc_only=False)


def conv3d_int8_accumulators(x: torch.Tensor, p, time_pad: int = 2) -> torch.Tensor:
    """The kernel's int32 accumulators for ``conv3d_int8(x, p, time_pad)``
    (the exactness check of ``chip_smoke.py``); on the CPU the plain
    version's."""
    if x.device.type == "cpu":
        return accumulate_plain(quantize_input(x)[0], _weights(p)[0], time_pad)
    return _launch(x, p, time_pad, acc_only=True)
