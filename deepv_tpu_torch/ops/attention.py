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
(``attn_fwd_tf32x3``, what f32 training and f32 forwards run) has the f32
backward's shape below: one CTA per 64 query rows, the same mask schedule,
K and V tiles through a ``cp.async`` ring, and both products on the TF32
tensor cores by 3xTF32 (``attention_3xtf32`` is its arithmetic in plain
PyTorch).

Backward (``attention_backward``, ``csrc/attention.cu``; no TPU kernel:
deepv_tpu trains through its jnp attention, which ``jax.value_and_grad``
differentiates). Under autograd on CUDA, ``attention`` is a
``torch.autograd.Function``: its forward launches K1 with the row
log-sum-exp (natural log, ``[b, h, S]`` f32) and saves q, k, v, out and the
LSE; its backward launches three kernels: ``attn_bwd_delta`` (D =
rowsum(dO * O)), ``attn_bwd_dkdv_*`` (one CTA per 64 keys walking the
query tiles its mask schedule keeps, accumulating dK and dV) and
``attn_bwd_dq_*`` (one CTA per 64 query rows walking its key tiles), with
P = exp(Q.K^T * scale - LSE) recomputed in each, on the grid
``(b * h, ceil(S / 64))`` with the heaviest tiles launched first (the
first keys, the last query rows), and the dQ kernel launched as the
dK/dV kernel's programmatic dependent so that the two run side by side.
No float atomics, so two runs agree bit for bit. bf16 (``*_wgmma``) is
the forward's shape: TMA loads the own tiles, a producer warp streams the
other side's tiles through a ring, and ``wgmma`` computes the products
with P and dS repacked in registers. f32 (``*_tf32x3``) runs on the TF32
tensor cores and keeps about f32 accuracy by 3xTF32: each operand splits
as big = tf32(x) plus small = tf32(x - big) (``tf32_split``), and each
product is three TF32 products (small.big + big.small + big.big) summed
in f32 (``attention_backward_3xtf32`` is that arithmetic in plain
PyTorch). The plain backward, which the kernels
are held to, is ``torch.autograd.grad`` of ``attention_plain``
(``attention_backward_plain``).

``attention`` takes the plain version only for tensors on the CPU; for CUDA
tensors it launches the kernel or raises. On inference paths (no grad
mode, or no input requiring grad) it takes the forward alone, without the
LSE.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from .basic import compute_dtype, tf32_split

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
#: the backward kernels' tile: own rows of a CTA, rows of a streamed tile
BWD_BLOCK = 64

#: launches of the bf16 kernel (attn_fwd_wgmma) and of the f32 kernel
#: (attn_fwd_tf32x3) since the counts were last set to 0, and of the backward
#: (its three kernels, either dtype) once per ``attention_backward`` call
launches = 0
f32_launches = 0
bwd_launches = 0

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


def attention_lse_plain(q: torch.Tensor, k: torch.Tensor, valid: torch.Tensor,
                        times: torch.Tensor) -> torch.Tensor:
    """Plain version of the forward kernel's second output: the natural-log
    log-sum-exp of every row's masked, scaled logits, ``[b, h, S]`` float32."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    same = valid[:, :, None] == valid[:, None, :]
    causal = times[:, None] >= times[None, :]
    logits = logits.masked_fill(~(same & causal[None])[:, None], MASKED)
    return torch.logsumexp(logits, dim=-1)


def attention_backward_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                             dout: torch.Tensor, valid: torch.Tensor,
                             times: torch.Tensor):
    """Plain version of the backward kernels: ``torch.autograd.grad`` of
    ``attention_plain``. Returns (dq, dk, dv)."""
    with torch.enable_grad():
        leaves = [x.detach().requires_grad_(True) for x in (q, k, v)]
        out = attention_plain(*leaves, valid, times)
        return torch.autograd.grad(out, leaves, dout)


def matmul_3xtf32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` in float32 as the f32 kernels take it: three TF32
    products of the split operands, small.big + big.small + big.big, each
    product of two TF32 values exact in f32 and summed in f32."""
    ab, as_ = tf32_split(a)
    bb, bs = tf32_split(b)
    return as_ @ bb + ab @ bs + ab @ bb


def attention_3xtf32(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     valid: torch.Tensor, times: torch.Tensor):
    """The f32 forward kernel's arithmetic in plain PyTorch (float32 inputs;
    for tests): S = Q.K^T and O = P.V in the three-product form of
    ``matmul_3xtf32``, the softmax in base 2 (logits times scale log2 e,
    disallowed ones -1e30 there), the weights unnormalised in the product
    and O divided by the row sum after it. Returns (out ``[b, S, h, d]``,
    the row LSE ``[b, h, S]`` in the natural log, as the kernel writes
    it)."""
    scale_log2 = 1.0 / math.sqrt(q.shape[-1]) / math.log(2.0)
    qh, kh, vh = (x.transpose(1, 2) for x in (q, k, v))             # [b, h, S, d]
    same = valid[:, :, None] == valid[:, None, :]
    allowed = (same & (times[:, None] >= times[None, :])[None])[:, None]
    logits = (matmul_3xtf32(qh, kh.transpose(-1, -2)) * scale_log2).masked_fill(~allowed, MASKED)
    m = logits.amax(-1, keepdim=True)
    p = torch.exp2(logits - m)
    l = p.sum(-1, keepdim=True)
    out = matmul_3xtf32(p, vh) / l
    lse = (m + torch.log2(l))[..., 0] * math.log(2.0)
    return out.transpose(1, 2).contiguous(), lse


def attention_backward_3xtf32(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                              dout: torch.Tensor, valid: torch.Tensor,
                              times: torch.Tensor):
    """The f32 backward kernels' arithmetic in plain PyTorch (float32
    inputs; for tests): every product in the three-product form of
    ``matmul_3xtf32``, P taken in base 2 from the forward's f32 LSE as the
    kernels take it, D from the f32 forward. Returns (dq, dk, dv)."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    log2e = 1.0 / math.log(2.0)
    qh, kh, vh, oh = (x.transpose(1, 2) for x in (q, k, v, dout))   # [b, h, S, d]
    out = attention_plain(q, k, v, valid, times).transpose(1, 2)
    lse2 = attention_lse_plain(q, k, valid, times)[..., None] * log2e
    delta = (oh * out).sum(-1, keepdim=True)
    same = valid[:, :, None] == valid[:, None, :]
    allowed = (same & (times[:, None] >= times[None, :])[None])[:, None]
    logits = matmul_3xtf32(qh, kh.transpose(-1, -2))
    p = torch.where(allowed, torch.exp2(logits * (scale * log2e) - lse2), 0.0)
    ds = p * (matmul_3xtf32(oh, vh.transpose(-1, -2)) - delta)
    dq = matmul_3xtf32(ds, kh) * scale
    dk = matmul_3xtf32(ds.transpose(-1, -2), qh) * scale
    dv = matmul_3xtf32(p.transpose(-1, -2), oh)
    return tuple(x.transpose(1, 2).contiguous() for x in (dq, dk, dv))


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
        fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        fn = lib.deepv_attention_bwd
        fn.argtypes = [ctypes.c_void_p] * 12 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
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


def _launch_error(what: str, err: int) -> RuntimeError:
    return RuntimeError(f"{what} launch failed: error {err} (cudaError_t, or 1000 + the "
                        "CUresult of a tensor map)")


def _forward_kernel(q, k, v, valid, times, with_lse: bool):
    """K1 on CUDA tensors: (out, lse), lse ``[b, h, S]`` f32 when
    ``with_lse`` else None (the kernel is then given no LSE pointer)."""
    _check_kernel_inputs(q, k, v, valid, times)
    lib = load_library()
    b, s, h, d = q.shape
    out = torch.empty_like(q)
    lse = torch.empty((b, h, s), dtype=torch.float32, device=q.device) if with_lse else None
    err = lib.deepv_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), valid.data_ptr(), times.data_ptr(),
        out.data_ptr(), None if lse is None else lse.data_ptr(), b, s, h, d,
        _DTYPE_CODE[q.dtype], torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise _launch_error("attention kernel", err)
    global launches, f32_launches
    if q.dtype == torch.bfloat16:
        launches += 1
    else:
        f32_launches += 1
    return out, lse


def attention_backward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       out: torch.Tensor, lse: torch.Tensor, dout: torch.Tensor,
                       valid: torch.Tensor, times: torch.Tensor):
    """(dq, dk, dv) of ``attention`` given its output ``out``, the forward's
    row LSE ``[b, h, S]`` (natural log, f32) and the output's gradient
    ``dout``, all but the LSE ``[b, S, h, 64]`` in q's dtype, on CUDA:
    launches the backward kernels or raises. It serves ``_Attention``; on
    the CPU, autograd differentiates ``attention_plain`` instead."""
    _check_kernel_inputs(q, k, v, valid, times)
    for name, t in (("out", out), ("dout", dout)):
        if t.dtype != q.dtype or t.shape != q.shape or t.device != q.device:
            raise ValueError(f"{name} must match q: {t.dtype} {tuple(t.shape)} {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned (16-byte loads)")
    b, s, h, d = q.shape
    if (lse.dtype != torch.float32 or tuple(lse.shape) != (b, h, s)
            or lse.device != q.device or not lse.is_contiguous()):
        raise ValueError(f"lse must be contiguous float32 [{b}, {h}, {s}] on q's device, got "
                         f"{lse.dtype} {tuple(lse.shape)} {lse.device}")
    lib = load_library()
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    delta = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
    err = lib.deepv_attention_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), dout.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), valid.data_ptr(), times.data_ptr(),
        dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), b, s, h, d, _DTYPE_CODE[q.dtype],
        torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise _launch_error("attention backward kernels", err)
    global bwd_launches
    bwd_launches += 1
    return dq, dk, dv


class _Attention(torch.autograd.Function):
    """K1 under autograd on CUDA: the forward with the row LSE, the backward
    kernels; ``valid`` and ``times`` get no gradient."""

    @staticmethod
    def forward(ctx, q, k, v, valid, times):
        out, lse = _forward_kernel(q, k, v, valid, times, with_lse=True)
        ctx.save_for_backward(q, k, v, out, lse, valid, times)
        return out

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dout):
        q, k, v, out, lse, valid, times = ctx.saved_tensors
        dq, dk, dv = attention_backward(q, k, v, out, lse, dout.contiguous(), valid, times)
        return dq, dk, dv, None, None


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              valid: torch.Tensor, times: torch.Tensor, n_last: int = 0) -> torch.Tensor:
    """Masked attention over a packed sequence. q/k/v [b, s, h, d]; valid
    [b, s] int32; times [s] float32. Returns [b, s, h, d].

    ``n_last`` keeps the TPU wrapper's meaning: the last ``n_last`` tokens
    carry the strictly largest time, so no earlier token attends them. The
    kernel's mask schedule already skips every such block, so the value
    only has to be valid; the result does not depend on it.

    On CUDA, when autograd records (grad mode on and q, k or v requiring
    grad) the call is differentiable through the backward kernels;
    otherwise it runs the forward kernel alone."""
    if not 0 <= n_last <= q.shape[1]:
        raise ValueError(f"n_last={n_last} outside [0, {q.shape[1]}]")
    if q.device.type == "cpu":
        return attention_plain(q, k, v, valid, times)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return _Attention.apply(q, k, v, valid, times)
    return _forward_kernel(q, k, v, valid, times, with_lse=False)[0]
