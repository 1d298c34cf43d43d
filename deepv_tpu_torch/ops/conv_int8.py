"""Symmetric int8 3x3x3 conv: the hand-written Hopper kernels (K3) and their plain version.

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

K3 (``csrc/conv_int8.cu``) has no TPU kernel to replace: deepv_tpu leaves
the int8 conv to XLA, and PyTorch has no int8 3D convolution on CUDA. A
call is two hand-written kernels after one reduction (``input_scale``):

  * ``quantize_k3_input`` (``quantize_k3``): x -> the quantised input
    channels-last, ``[b, t, h, w, ci_pad]``, in one pass (the plain version
    is ``quantize_input_k3``);
  * the conv on it and the weight's ``[27, co_pad, ci_pad]`` layout
    (``weight_k3``, made once by ``quantize_conv_weights``): int32 sums
    equal to the plain version's bit for bit, and the dequant epilogue
    reading sx, sw and the bias from the device. ``plan`` picks the kernel:
    ``wgmma`` (TMA-fed s8 ``wgmma``) where ci_pad is a multiple of 128,
    ``mma`` (``cp.async`` + ``mma.sync``) for the rest (conv_in, ci = 3).

``conv3d_int8`` takes the plain version only for tensors on the CPU; for
CUDA tensors it launches the kernels or raises.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

#: quantise only convs at spatial heights of at least this (deepv_tpu's rule)
MIN_H = 256

#: launches of the ``wgmma`` conv kernel since the count was last set to 0
launches = 0
#: launches of the ``mma`` conv kernel and of the quantise kernel, counted apart
mma_launches = 0
quantize_launches = 0

_library: Optional[ctypes.CDLL] = None
_OUT_CODE = {torch.float32: 0, torch.bfloat16: 1}
#: input channels per K step of the kernel (x8 and the weight are padded to it)
CI_STEP = 32


def supports_int8(weight_shape: Tuple[int, ...], stride: Tuple[int, int, int], h: int) -> bool:
    """Dispatch predicate: 3x3x3 stride-1 convs with h >= ``MIN_H``."""
    return (tuple(weight_shape[2:]) == (3, 3, 3) and tuple(stride) == (1, 1, 1)
            and h >= MIN_H)


def channel_tile(co: int) -> int:
    """The conv kernels' CTA width in output channels: 128 where co is a
    multiple of it, else 16 (the 3-channel ``conv_out``)."""
    return 128 if co % 128 == 0 else 16


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


#: the ``wgmma`` kernel (csrc/conv_int8.cu, namespace ``wg``): input
#: channels of a K unit (one 128-byte row of the weight's swizzled box) and
#: channels of one A box (a 16-byte core-matrix column)
WG_CHUNK = 128
WG_SLOT_CH = 16
#: the ``mma`` kernel: pixels of a CTA
MMA_BM = 128


@dataclass(frozen=True)
class Plan:
    """How one call runs on the card; ``conv_k3`` passes ``bn``, ``mb`` and
    ``segs`` to the kernel, whose grid is ``grid``. ``wgmma``: a CTA takes
    ``bm = 128 * mb`` pixels of one output row (two consumer warpgroups of
    ``run = 64 * mb`` pixels, each reading boxes of ``run + 2`` pixels that
    serve the three kw taps) and ``bn`` output channels; the grid is ``(h *
    segs, co_pad / bn, b * t_out)``. ``mma``: 128 pixels of a frame and
    ``bn`` channels; the grid is ``(ceil(h * w / 128), co_pad / bn, b *
    t_out)``. The ring stages are the kernel's own compile-time choice
    (``wg::Tile``, held to the shared memory by its static_asserts)."""

    kernel: str
    bn: int
    bm: int
    mb: int
    segs: int
    grid: Tuple[int, int, int]

    @property
    def run(self) -> int:
        return self.bm // 2

    @property
    def box_w(self) -> int:
        return self.run + 2


def plan(ci: int, co: int, h: int, w: int, b: int, t_out: int) -> Plan:
    """The kernel and tiling of one call: ``wgmma`` where the padded input
    channels are a multiple of 128 (at the rollout's 384x512 level 128->128,
    256->128 and 256->512 with 128-channel CTAs, and conv_out's 128->3 with
    16-channel ones), with 256-pixel CTAs where w > 128 (a weight tile then
    serves twice the pixels) and 128-pixel ones on narrow frames; ``mma``
    for the rest (conv_in, ci = 3)."""
    ci_pad = _round_up(ci, CI_STEP)
    bn = channel_tile(co)
    co_pad = _round_up(co, bn)
    if ci_pad % WG_CHUNK == 0:
        mb = 2 if w > 128 else 1
        bm = 128 * mb
        segs = -(-w // bm)
        return Plan("wgmma", bn, bm, mb, segs, (h * segs, co_pad // bn, b * t_out))
    return Plan("mma", bn, MMA_BM, 0, 0, (-(-h * w // MMA_BM), co_pad // bn, b * t_out))


def wgmma_units(ci_pad: int, time_pad: int, to: int) -> range:
    """The ``wgmma`` kernel's K units for output frame ``to``: (kt, kh,
    128-channel chunk), kt-major (``unit_origin``), each serving the three
    kw taps; units whose input frame lies in the causal past (kt < time_pad
    - to) are skipped."""
    chunks = ci_pad // WG_CHUNK
    return range(max(0, time_pad - to) * 3 * chunks, 9 * chunks)


def unit_origin(ci_pad: int, u: int) -> Tuple[int, int, int]:
    """(kt, kh, first channel) of K unit ``u``."""
    chunks = ci_pad // WG_CHUNK
    g, c = divmod(u, chunks)
    return g // 3, g % 3, c * WG_CHUNK


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
        lib.deepv_quantize_k3.argtypes = ([ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                                           ctypes.c_void_p] + [ctypes.c_int] * 6
                                          + [ctypes.c_void_p])
        lib.deepv_conv3d_int8.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int]
                                          + [ctypes.c_void_p] * 2 + [ctypes.c_int] * 11
                                          + [ctypes.c_void_p])
        lib.deepv_conv3d_int8_wgmma.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int]
                                                + [ctypes.c_void_p] * 2 + [ctypes.c_int] * 13
                                                + [ctypes.c_void_p])
        for fn in (lib.deepv_quantize_k3, lib.deepv_conv3d_int8, lib.deepv_conv3d_int8_wgmma):
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
    if b * (t_in + time_pad - 2) > 65535 or b * t_in > 65535 or h > 65535:
        raise ValueError(f"int8 conv kernels take at most 65535 frames and rows, got "
                         f"b={b}, t_in={t_in}, h={h}")


def _stream(x: torch.Tensor) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream


def quantize_k3(x: torch.Tensor, sx: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``quantize_input_k3`` by the quantise kernel: (x8 [b, t, h, w,
    ci_pad] int8, sx), with sx from ``input_scale`` unless given. The plain
    version for a tensor on the CPU; on CUDA the kernel, or an error."""
    global quantize_launches
    if x.device.type == "cpu":
        return quantize_input_k3(x)
    if x.device.type != "cuda":
        raise ValueError(f"the quantise kernel runs on CUDA tensors, got {x.device}")
    if x.dtype not in _OUT_CODE or x.dim() != 5:
        raise TypeError(f"the quantise kernel takes [b, ci, t, h, w] float32 or bfloat16, got "
                        f"{x.dtype} {tuple(x.shape)}")
    lib = load_library()
    x = x.contiguous()
    b, ci, t, h, w = x.shape
    sx = input_scale(x) if sx is None else sx
    if sx.dtype != torch.float32 or sx.numel() != 1 or sx.device != x.device:
        raise ValueError("sx must be one float32 on x's device")
    ci_pad = _round_up(ci, CI_STEP)
    x8 = torch.empty((b, t, h, w, ci_pad), dtype=torch.int8, device=x.device)
    err = lib.deepv_quantize_k3(x.data_ptr(), _OUT_CODE[x.dtype], sx.data_ptr(), x8.data_ptr(),
                                b, ci, ci_pad, t, h, w, _stream(x))
    if err != 0:
        raise RuntimeError(f"int8 quantise kernel launch failed: error {err}")
    quantize_launches += 1
    return x8, sx


def conv_k3(x8: torch.Tensor, sx: torch.Tensor, p, time_pad: int, dtype: torch.dtype,
            acc_only: bool = False) -> torch.Tensor:
    """The conv kernel ``plan`` picks, on a quantised input (``quantize_k3``'s
    x8 [b, t_in, h, w, ci_pad] and sx): [b, co, t_in + time_pad - 2, h, w],
    dequantised in ``dtype``, or (``acc_only``) the int32 accumulators."""
    global launches, mma_launches
    if x8.device.type != "cuda":
        raise ValueError(f"the int8 conv kernel runs on CUDA tensors, got {x8.device}")
    lib = load_library()
    w8, sw = _weights(p)
    wk = p.weight_k3 if hasattr(p, "weight_k3") else k3_weight(w8)
    bias = getattr(p, "bias", None)
    if bias is not None and bias.dtype not in _OUT_CODE:
        bias = bias.to(torch.float32)
    for name, t in (("weight", wk), ("weight scale", sw), ("bias", bias), ("sx", sx)):
        if t is not None and (t.device != x8.device or not t.is_contiguous()):
            raise ValueError(f"{name} must be contiguous on x's CUDA device, got {t.device}")
    if sw.dtype != torch.float32 or sx.dtype != torch.float32:
        raise TypeError(f"scales must be float32, got {sw.dtype} and {sx.dtype}")
    co, ci = p.weight.shape[:2]
    b, t_in, h, w, ci_pad = x8.shape
    if x8.dtype != torch.int8 or not x8.is_contiguous() or ci_pad != _round_up(ci, CI_STEP):
        raise ValueError(f"x8 must be contiguous int8 [b, t, h, w, {_round_up(ci, CI_STEP)}], "
                         f"got {x8.dtype} {tuple(x8.shape)}")
    t_out = t_in + time_pad - 2
    pl = plan(ci, co, h, w, b, t_out)
    shape = (b, co, t_out, h, w)
    if acc_only:
        acc, out = torch.empty(shape, dtype=torch.int32, device=x8.device), None
    else:
        acc, out = None, torch.empty(shape, dtype=dtype, device=x8.device)
    ptrs = (x8.data_ptr(), wk.data_ptr(), sx.data_ptr(), sw.data_ptr(),
            None if bias is None else bias.data_ptr(),
            _OUT_CODE[bias.dtype] if bias is not None else 0,
            None if out is None else out.data_ptr(), None if acc is None else acc.data_ptr())
    if pl.kernel == "wgmma":
        err = lib.deepv_conv3d_int8_wgmma(*ptrs, b, ci_pad, co, wk.shape[1], t_in, t_out, h, w,
                                          time_pad, _OUT_CODE[dtype], pl.bn, pl.mb, pl.segs,
                                          _stream(x8))
    else:
        err = lib.deepv_conv3d_int8(*ptrs, b, ci_pad, co, wk.shape[1], t_in, t_out, h, w,
                                    time_pad, _OUT_CODE[dtype], pl.bn, _stream(x8))
    if err != 0:
        raise RuntimeError(f"int8 conv kernel ({pl.kernel}) launch failed: error {err}")
    if pl.kernel == "wgmma":
        launches += 1
    else:
        mma_launches += 1
    return acc if acc_only else out


def _launch(x: torch.Tensor, p, time_pad: int, acc_only: bool) -> torch.Tensor:
    """Quantise x and launch the conv kernel: the dequantised output in x's
    dtype, or (``acc_only``) the int32 accumulators."""
    if x.device.type != "cuda":
        raise ValueError(f"the int8 conv kernel runs on CUDA tensors, got {x.device}")
    _check_kernel_inputs(x, p, time_pad)
    x8, sx = quantize_k3(x)
    return conv_k3(x8, sx, p, time_pad, x.dtype, acc_only)


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
