"""Packed masked attention: the hand-written Hopper kernel and its plain version.

Counterpart of ``deepv_tpu/ops/attention.py``. The MMDiT runs one attention
over the packed sequence of every denoise forward, with the mask rebuilt
from two per-token vectors:

    allowed(q, k) = (valid_q == valid_k) & (time_q >= time_k)

Disallowed logits are filled with -1e30 (not -inf), as in the TPU kernel.

Kernel (``csrc/attention.cu``), replacing
``deepv_tpu/ops/attention.py::_attn_kernel``: at the rollout's layouts the
call does ~10x more operations per byte than the H100's bf16 ridge point, so
the products bound it. It runs one CTA per (64-row q tile, batch*head) over
64-key tiles with an online f32 softmax (no [S, S] logits in device memory,
no length cap, so the TPU kernel's VMEM-budget fallback has no counterpart),
WMMA bf16 tensor-core products with f32 accumulation (plain FMA for f32),
and skips every key tile whose smallest time exceeds the q tile's largest
time. That skip subsumes the TPU wrapper's ``n_last`` split (the prefix x
current block is never computed) within one launch.

``attention`` takes the plain version only for tensors on the CPU; for CUDA
tensors it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from .basic import compute_dtype

#: masked-logit fill, the TPU kernel's (finite, so a fully masked row stays
#: finite)
MASKED = -1e30
HEAD_DIM = 64
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

#: launches of the CUDA kernel since the count was last set to 0
launches = 0

_library: Optional[ctypes.CDLL] = None


def attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    valid: torch.Tensor, times: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version. q/k/v [b, s, h, d]; valid [b, s]; times [s].
    Logits and the weighted sum accumulate in at-least-f32; the softmax
    weights are cast to v's dtype before the product, as in the kernel."""
    acc = compute_dtype(q.dtype)
    scale = 1.0 / math.sqrt(q.shape[-1])
    logits = torch.einsum("bqhd,bkhd->bhqk", q.to(acc), k.to(acc)) * scale
    same = valid[:, :, None] == valid[:, None, :]
    causal = times[:, None] >= times[None, :]
    allowed = (same & causal[None])[:, None]
    logits = logits.masked_fill(~allowed, MASKED)
    w = torch.softmax(logits, dim=-1).to(v.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", w.to(acc), v.to(acc)).to(v.dtype)


def load_library() -> ctypes.CDLL:
    """Build (at first use) and load the kernel library."""
    global _library
    if _library is None:
        from ..utils.cuda_build import build
        lib = build("attention.cu").lib
        fn = lib.deepv_attention_fwd
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _library = lib
    return _library


def _check_kernel_inputs(q, k, v, valid, times) -> None:
    if q.dtype not in _DTYPE_CODE:
        raise TypeError(f"attention kernel takes float32 or bfloat16, got {q.dtype}")
    for name, t in (("k", k), ("v", v)):
        if t.dtype != q.dtype or t.shape != q.shape:
            raise ValueError(f"{name} must match q: {t.dtype} {tuple(t.shape)} vs "
                             f"{q.dtype} {tuple(q.shape)}")
    b, s, h, d = q.shape
    if d != HEAD_DIM:
        raise ValueError(f"attention kernel is built for head dim {HEAD_DIM}, got {d}")
    if valid.dtype != torch.int32 or tuple(valid.shape) != (b, s):
        raise ValueError(f"valid must be int32 [{b}, {s}], got {valid.dtype} "
                         f"{tuple(valid.shape)}")
    if times.dtype != torch.float32 or tuple(times.shape) != (s,):
        raise ValueError(f"times must be float32 [{s}], got {times.dtype} "
                         f"{tuple(times.shape)}")
    for name, t in (("q", q), ("k", k), ("v", v), ("valid", valid), ("times", times)):
        if t.device.type != "cuda" or t.device != q.device:
            raise ValueError(f"{name} must lie on q's CUDA device, got {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              valid: torch.Tensor, times: torch.Tensor, n_last: int = 0) -> torch.Tensor:
    """Masked attention over a packed sequence. q/k/v [b, s, h, d]; valid
    [b, s] int32; times [s] float32. Returns [b, s, h, d].

    ``n_last`` keeps the TPU wrapper's meaning: the last ``n_last`` tokens
    carry the strictly largest time, so no earlier token attends them. The
    kernel's causal tile skip already leaves out every such block, so the
    value only has to be valid; the result does not depend on it."""
    if not 0 <= n_last <= q.shape[1]:
        raise ValueError(f"n_last={n_last} outside [0, {q.shape[1]}]")
    if q.device.type == "cpu":
        return attention_plain(q, k, v, valid, times)
    _check_kernel_inputs(q, k, v, valid, times)
    lib = load_library()
    b, s, h, d = q.shape
    out = torch.empty_like(q)
    err = lib.deepv_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), valid.data_ptr(), times.data_ptr(),
        out.data_ptr(), b, s, h, d, _DTYPE_CODE[q.dtype],
        torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"attention kernel launch failed: cudaError {err}")
    global launches
    launches += 1
    return out
