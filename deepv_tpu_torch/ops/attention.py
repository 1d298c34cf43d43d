"""Packed masked attention: the hand-written Hopper kernel and its plain version.

Counterpart of ``deepv_tpu/ops/attention.py``. The MMDiT runs one attention
over the packed sequence of every denoise forward, with the mask rebuilt
from two per-token vectors:

    allowed(q, k) = (valid_q == valid_k) & (time_q >= time_k)

Disallowed logits are filled with -1e30 (not -inf), as in the TPU kernel.

Kernel (``csrc/attention.cu``), replacing
``deepv_tpu/ops/attention.py::_attn_kernel``: at the rollout's layouts the
call does ~10x more operations per byte than the H100's bf16 ridge point, so
the products bound it. The bf16 kernel (``attn_fwd_wgmma``) runs one CTA per
(128 query rows, batch*head): TMA loads Q once and a producer warp streams
64-key K/V tiles through a 3-stage ring; two consumer warpgroups run
``wgmma`` (S = Q.K^T from shared memory, O += P.V with P from registers)
with an online f32 softmax in the accumulators' registers (no [S, S] logits
in device memory). A per-tile mask schedule, the rule of ``tile_classes``,
drops every key tile with no allowed pair and builds the mask only on
partial tiles; that subsumes the TPU wrapper's ``n_last`` split (the prefix
x current block is never computed) within one launch. The f32 kernel
(``attn_fwd_f32``, plain FMA, a time-only tile skip) is the exactness check
on the card.

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

#: tile classes of the kernel's mask schedule (``tile_classes``)
SKIP, FULL, PARTIAL = 0, 1, 2
#: the bf16 kernel's tile: query rows per CTA, keys per K/V tile
KERNEL_BLOCK_Q, KERNEL_BLOCK_K = 128, 64
#: the longest sequence the kernel takes (1,024 key tiles in its schedule)
MAX_SEQ = 65536

#: launches of the bf16 kernel (attn_fwd_wgmma) and of the f32 kernel
#: (attn_fwd_f32) since the counts were last set to 0
launches = 0
f32_launches = 0

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


def _tile_min_max(x: torch.Tensor, block: int, lowest, highest):
    """Per-block min and max of ``x`` along its last axis, blocks of
    ``block`` entries, the ragged last block over its entries only."""
    s = x.shape[-1]
    n = -(-s // block)
    pad = (*x.shape[:-1], n * block - s)
    blocks = lambda fill: torch.cat([x, x.new_full(pad, fill)], -1).reshape(
        *x.shape[:-1], n, block)
    return blocks(highest).amin(-1), blocks(lowest).amax(-1)


def tile_classes(valid: torch.Tensor, times: torch.Tensor, block_q: int = KERNEL_BLOCK_Q,
                 block_k: int = KERNEL_BLOCK_K) -> torch.Tensor:
    """The kernel's per-tile mask schedule as a plain rule: the class of every
    (query tile, key tile) block, ``[b, ceil(S / block_q), ceil(S / block_k)]``
    int8, from the min/max of ``times`` and of ``valid[b]`` over each tile's
    rows (rows past S left out):

    * SKIP: max t_q < min t_k, or the valid ranges are disjoint; the block
      holds no allowed pair;
    * FULL: min t_q >= max t_k, all four valid extremes equal, and the key
      tile lies inside S; every pair is allowed, no mask is built;
    * PARTIAL: everything else.

    ``csrc/attention.cu::attn_fwd_wgmma`` computes the same classes at
    (block_q, block_k) = (128, 64) at the start of each CTA."""
    s = times.shape[0]
    imin, imax = torch.iinfo(valid.dtype).min, torch.iinfo(valid.dtype).max
    fmin, fmax = -math.inf, math.inf
    vq_lo, vq_hi = _tile_min_max(valid, block_q, imin, imax)     # [b, nq]
    tq_lo, tq_hi = _tile_min_max(times, block_q, fmin, fmax)     # [nq]
    vk_lo, vk_hi = _tile_min_max(valid, block_k, imin, imax)     # [b, nk]
    tk_lo, tk_hi = _tile_min_max(times, block_k, fmin, fmax)     # [nk]
    skip = ((tq_hi[:, None] < tk_lo[None, :])[None]
            | (vq_hi[:, :, None] < vk_lo[:, None, :])
            | (vk_hi[:, None, :] < vq_lo[:, :, None]))
    inside = (torch.arange(1, tk_lo.shape[0] + 1, device=times.device) * block_k) <= s
    full = ((tq_lo[:, None] >= tk_hi[None, :])[None]
            & (vq_lo == vq_hi)[:, :, None] & (vk_lo == vk_hi)[:, None, :]
            & (vq_lo[:, :, None] == vk_lo[:, None, :]) & inside[None, None, :])
    out = torch.full(skip.shape, PARTIAL, dtype=torch.int8, device=times.device)
    out[full] = FULL
    out[skip] = SKIP
    return out


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
    if s > MAX_SEQ:
        raise ValueError(f"attention kernel takes sequences of at most {MAX_SEQ}, got {s}")
    for name, t in (("q", q), ("k", k), ("v", v), ("valid", valid), ("times", times)):
        if t.device.type != "cuda" or t.device != q.device:
            raise ValueError(f"{name} must lie on q's CUDA device, got {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned (TMA)")


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              valid: torch.Tensor, times: torch.Tensor, n_last: int = 0) -> torch.Tensor:
    """Masked attention over a packed sequence. q/k/v [b, s, h, d]; valid
    [b, s] int32; times [s] float32. Returns [b, s, h, d].

    ``n_last`` keeps the TPU wrapper's meaning: the last ``n_last`` tokens
    carry the strictly largest time, so no earlier token attends them. The
    kernel's mask schedule already skips every such block, so the value
    only has to be valid; the result does not depend on it."""
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
        raise RuntimeError(f"attention kernel launch failed: error {err} (cudaError_t, or "
                           "1000 + the CUresult of a tensor map)")
    global launches, f32_launches
    if q.dtype == torch.bfloat16:
        launches += 1
    else:
        f32_launches += 1
    return out
