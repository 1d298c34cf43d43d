"""Implicit-GEMM causal conv: the hand-written Hopper kernel and its plain version.

Counterpart of ``deepv_tpu/ops/conv_igemm.py``. A 3x3x3 stride-1 conv with a
torch-layout weight ``[co, ci, 3, 3, 3]``:

    y[b, co, t, h, w] = bias[co]
        + sum_{kt, kh, kw, ci} w[co, ci, kt, kh, kw] * x_pad[b, ci, t + kt, h + kh - 1, w + kw - 1]

``time_pad=2`` puts two zero frames in the temporal past (``full`` mode);
``time_pad=0`` expects the kt-1 context frames already concatenated by the
caller (``init``/``cont``/``prime``). Spatial borders are zero. Products
accumulate in float32; the bias, cast to x's dtype, is added in float32
after the sum, and the result is rounded once to x's dtype. Those are the
TPU kernel's rounding points (``conv_igemm.py:77-85``, ``:115-116``).

Kernel (``csrc/conv_igemm.cu``), replacing
``deepv_tpu/ops/conv_igemm.py::_kernel``: at the VAE's eligible layers the
call does 1e3-1e4 operations per byte moved, far above the H100's bf16
ridge point, so the products bound it. It runs one CTA per (128 output
pixels of one frame, 128 output channels, batch * output frame); its K loop
walks the 27 taps x ci in chunks of 32 with a 3-stage ``cp.async`` ring,
zero-filling the causal and spatial halo at the load, on WMMA bf16 tensor
cores with float32 accumulators (plain float32 FMA for float32 inputs). The
wrapper makes one channels-last copy of x (contiguous 16-byte loads along
ci) and re-lays the weight out to ``[(kt, kh, kw, ci), co]`` per call; the
epilogue writes ``[b, co, t, h, w]`` directly.

``conv3d_igemm`` takes the plain version only for tensors on the CPU; for
CUDA tensors it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from .basic import compute_dtype

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

#: launches of the CUDA kernel since the count was last set to 0
launches = 0

_library: Optional[ctypes.CDLL] = None


def supports_igemm(weight_shape: Tuple[int, ...], stride: Tuple[int, int, int],
                   dtype: torch.dtype, h: int, w: int) -> bool:
    """Dispatch predicate (deepv_tpu's rule): 3x3x3 stride-1 convs in bf16
    or f32 with ci and co multiples of 128 and even h and w."""
    co, ci = weight_shape[:2]
    return (tuple(weight_shape[2:]) == (3, 3, 3)
            and tuple(stride) == (1, 1, 1)
            and dtype in (torch.bfloat16, torch.float32)
            and ci % 128 == 0 and co % 128 == 0
            and h % 2 == 0 and w % 2 == 0)


def _bias(p, co: int, like: torch.Tensor) -> torch.Tensor:
    bias = getattr(p, "bias", None)
    return like.new_zeros((co,)) if bias is None else bias.to(like.dtype)


def conv3d_igemm_plain(x: torch.Tensor, p, time_pad: int = 2) -> torch.Tensor:
    """Plain PyTorch version with the kernel's arithmetic: a channels-last
    halo-padded input, weights cast to x's dtype, at-least-f32 accumulation
    of the 27 taps' products, the bias (in x's dtype) added in that type,
    one rounding. It loops over output frames, so no tap stack of a whole
    clip is ever built. x [b, ci, t, h, w] -> [b, co, t + time_pad - 2, h, w]."""
    co, ci = p.weight.shape[:2]
    b, _, t_in, h, w = x.shape
    t_out = t_in + time_pad - 2
    if t_out < 1:
        raise ValueError(f"igemm conv needs t_in + time_pad - 2 >= 1, got t_in={t_in}, "
                         f"time_pad={time_pad}")
    acc_t = compute_dtype(x.dtype)
    # [b, t, h+2, w+2, ci] and [kt, kh, kw, ci, co], both laid out as indexed
    xp = F.pad(x, (1, 1, 1, 1, time_pad, 0)).permute(0, 2, 3, 4, 1).contiguous()
    wr = p.weight.to(x.dtype).permute(2, 3, 4, 1, 0).to(acc_t).contiguous()
    bias = _bias(p, co, x).to(acc_t)
    out = x.new_empty((b, co, t_out, h, w))
    for t in range(t_out):
        acc = torch.zeros((b, h, w, co), dtype=acc_t, device=x.device)
        for kt in range(3):
            for kh in range(3):
                for kw in range(3):
                    tap = xp[:, t + kt, kh:kh + h, kw:kw + w, :].to(acc_t)
                    acc += torch.matmul(tap, wr[kt, kh, kw])
        acc += bias
        out[:, :, t] = acc.to(x.dtype).permute(0, 3, 1, 2)
    return out


def load_library() -> ctypes.CDLL:
    """Build (at first use) and load the kernel library."""
    global _library
    if _library is None:
        from ..utils.cuda_build import build
        lib = build("conv_igemm.cu").lib
        fn = lib.deepv_conv3d_igemm
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 9 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _library = lib
    return _library


def _check_kernel_inputs(x: torch.Tensor, weight: torch.Tensor, bias, time_pad: int) -> None:
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"igemm conv kernel takes float32 or bfloat16, got {x.dtype}")
    if x.dim() != 5:
        raise ValueError(f"x must be [b, ci, t, h, w], got {tuple(x.shape)}")
    co, ci = weight.shape[:2]
    b, xc, t_in, h, w = x.shape
    if tuple(weight.shape[2:]) != (3, 3, 3) or xc != ci:
        raise ValueError(f"weight must be [co, {xc}, 3, 3, 3], got {tuple(weight.shape)}")
    if ci % 128 or co % 128 or h % 2 or w % 2:
        raise ValueError(f"igemm conv kernel needs ci, co multiples of 128 and even h, w; "
                         f"got ci={ci} co={co} h={h} w={w}")
    if time_pad not in (0, 2) or t_in + time_pad - 2 < 1:
        raise ValueError(f"time_pad must be 0 or 2 with at least one output frame; got "
                         f"time_pad={time_pad}, t_in={t_in}")
    if bias is not None and tuple(bias.shape) != (co,):
        raise ValueError(f"bias must be [{co}], got {tuple(bias.shape)}")
    for name, t in (("weight", weight), ("bias", bias)):
        if t is not None and t.device != x.device:
            raise ValueError(f"{name} must lie on x's CUDA device, got {t.device}")


def conv3d_igemm(x: torch.Tensor, p, time_pad: int = 2) -> torch.Tensor:
    """3x3x3 stride-1 causal conv; ``p`` holds ``weight`` [co, ci, 3, 3, 3]
    and an optional ``bias``. x [b, ci, t, h, w] -> [b, co, t + time_pad - 2,
    h, w] in x's dtype."""
    if x.device.type == "cpu":
        return conv3d_igemm_plain(x, p, time_pad)
    bias = getattr(p, "bias", None)
    _check_kernel_inputs(x, p.weight, bias, time_pad)
    lib = load_library()
    co, ci = p.weight.shape[:2]
    b, _, t_in, h, w = x.shape
    t_out = t_in + time_pad - 2
    xcl = x.permute(0, 2, 3, 4, 1).contiguous()                                 # [b, t, h, w, ci]
    wr = p.weight.to(x.dtype).permute(2, 3, 4, 1, 0).reshape(27 * ci, co).contiguous()
    bv = _bias(p, co, x).contiguous()
    out = torch.empty((b, co, t_out, h, w), dtype=x.dtype, device=x.device)
    err = lib.deepv_conv3d_igemm(
        xcl.data_ptr(), wr.data_ptr(), bv.data_ptr(), out.data_ptr(),
        b, ci, co, t_in, t_out, h, w, time_pad, _DTYPE_CODE[x.dtype],
        torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"igemm conv kernel launch failed: cudaError {err}")
    global launches
    launches += 1
    return out
