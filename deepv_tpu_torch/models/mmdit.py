"""MMDiT denoiser: SD3-style joint-attention DiT over a packed sequence.

Counterpart of ``deepv_tpu/models/mmdit.py``. Per denoise call the rollout
packs ONE sequence of [text (+ history) tokens ++ condition clips at mixed
pyramid resolutions ++ the current noisy unit] and runs every joint block's
attention over it under the batch-id x temporal-causal mask, rebuilt from a
per-token ``valid`` vector and per-token times (``ops/attention.py``).

``MMDiT`` is an ``nn.Module`` whose parameter names are the dotted keys of
deepv_tpu's parameter tree (e.g. ``transformer_blocks.3.attn.to_q.weight``)
with the same torch layouts. It is built with its parameters on the
``meta`` device; ``io/weights.params_from_numpy`` loads real tensors.

Tensor parallel (``MMDiT(cfg, tp_group=group)``, ``parallel/tp.py``): each
rank holds its share of the heads and of the feed-forward width, the
column-split and row-split linears at 1/n of their width. The attention
runs on the rank's heads, read from the projections' width; after each
row-split linear the partial products are summed over the group
(``parallel/comm.reduce``) and the bias is added once, after the sum.
All else is computed whole on every rank, with the same bits. The forward
is differentiable as the single-device one: the input of every
column-split linear and the per-head-dim RMSNorm scales (replicated, but
each rank applies them to its own heads only) go through
``parallel/comm.copy``, whose backward sums their gradients over the
group, so every leaf's gradient is the single-device one. Quantised
(``quantize_mmdit``), a row-split ``Int8Linear`` takes its weight scale
and each token's activation scale as the maximum over the group and sums
the int32 products over it (``ops/linear_int8.py``).
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from ..config import MMDiTConfig
from ..ops.attention import attention
from ..ops.basic import gelu_tanh, layer_norm, linear, rms_norm, silu
from ..ops.linear_int8 import linear_int8, quantize_linear
from ..ops.resample import down2x_bilinear, resize_bilinear
from ..ops.rope import apply_rope, rope_tables_torch
from ..parallel import comm


# ---------------------------------------------------------------------------
# positional embeddings (host, static)
# ---------------------------------------------------------------------------

def _sincos_1d(embed_dim: int, pos: np.ndarray) -> np.ndarray:
    omega = np.arange(embed_dim // 2, dtype=np.float64) / (embed_dim / 2.0)
    omega = 1.0 / 10000 ** omega
    out = np.einsum("m,d->md", pos.reshape(-1), omega)
    return np.concatenate([np.sin(out), np.cos(out)], axis=1)


def sincos_2d(embed_dim: int, grid_size: int, base_size: int,
              interpolation_scale: float = 1.0) -> np.ndarray:
    """SD3 2D sincos table [grid*grid, D]."""
    grid_h = np.arange(grid_size, dtype=np.float32) / (grid_size / base_size) / interpolation_scale
    grid_w = np.arange(grid_size, dtype=np.float32) / (grid_size / base_size) / interpolation_scale
    grid = np.meshgrid(grid_w, grid_h)  # w first
    grid = np.stack(grid, axis=0).reshape([2, 1, grid_size, grid_size])
    emb_h = _sincos_1d(embed_dim // 2, grid[0])
    emb_w = _sincos_1d(embed_dim // 2, grid[1])
    return np.concatenate([emb_h, emb_w], axis=1)


def timestep_embedding(t: torch.Tensor, dim: int = 256) -> torch.Tensor:
    """DDPM sinusoidal embedding (flip_sin_to_cos=True, shift=0) in float32.

    The frequencies and the arguments are the JAX package's float32 values;
    exp, cos and sin are evaluated in float64 and rounded to float32, so the
    result does not carry a platform's f32 transcendental ulps (which move
    the embedding by up to ~3e-5 at t ~ 1000)."""
    half = dim // 2
    expo = np.float32(-math.log(10000.0)) * np.arange(half, dtype=np.float32) / np.float32(half)
    freqs = torch.as_tensor(np.exp(expo.astype(np.float64)).astype(np.float32),
                            device=t.device)
    args = (t.to(torch.float32)[:, None] * freqs[None, :]).to(torch.float64)
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1).to(torch.float32)


# ---------------------------------------------------------------------------
# packed layout
# ---------------------------------------------------------------------------

class PackedLayout:
    """Token counts and (static) time ids of one packed forward.

    clip_shapes: ((t, h, w), ...) latent dims per clip, oldest -> newest; the
    LAST clip is the unit whose velocity is returned."""

    def __init__(self, cfg: MMDiTConfig, clip_shapes: Sequence[Tuple[int, int, int]],
                 ctx_len: int):
        self.cfg = cfg
        self.clip_shapes = tuple(tuple(s) for s in clip_shapes)
        self.ctx_len = ctx_len
        p = cfg.patch_size
        self.clip_tokens = [t * (h // p) * (w // p) for (t, h, w) in clip_shapes]
        self.video_len = sum(self.clip_tokens)
        self.seq_len = ctx_len + self.video_len
        # ctx tokens at time 0; clip frames consecutive across clips
        times = [np.zeros(ctx_len, np.float32)]
        t0 = 0
        for (t, h, w) in clip_shapes:
            times.append(np.repeat(np.arange(t0, t0 + t, dtype=np.float32), (h // p) * (w // p)))
            t0 += t
        self.time_ids = np.concatenate(times)

    def frame_times(self) -> List[np.ndarray]:
        """Per-clip frame times of the static layout (consecutive frames)."""
        out, t0 = [], 0
        for (t, _, _) in self.clip_shapes:
            out.append(np.arange(t0, t0 + t, dtype=np.float32))
            t0 += t
        return out


def packed_mask(layout: PackedLayout, ctx_valid: torch.Tensor,
                frame_times: Optional[List[torch.Tensor]] = None,
                frame_valid: Optional[List[torch.Tensor]] = None):
    """Per-token mask vectors of a packed sequence: ``valid`` [b, S] int32
    (the ctx tokens' own validity, then each frame's, repeated over its
    tokens) and ``times`` [S] float32 (ctx tokens at 0, then each frame's
    time). Without frame times/validity every frame is valid and frames
    count up across clips."""
    dev = ctx_valid.device
    if frame_times is None:
        frame_times = [torch.as_tensor(ft, device=dev) for ft in layout.frame_times()]
        frame_valid = [torch.ones(s[0], dtype=torch.int32, device=dev)
                       for s in layout.clip_shapes]
    tok_times = [torch.zeros(layout.ctx_len, dtype=torch.float32, device=dev)]
    vid_valid = []
    for n_tok, (t, _, _), ft, fv in zip(layout.clip_tokens, layout.clip_shapes,
                                        frame_times, frame_valid):
        tok_times.append(ft.to(torch.float32).repeat_interleave(n_tok // t))
        vid_valid.append(fv.repeat_interleave(n_tok // t))
    vvalid = torch.cat(vid_valid)[None].expand(ctx_valid.shape[0], -1)
    valid = torch.cat([ctx_valid, vvalid.to(ctx_valid.dtype)], dim=1)
    return valid.to(torch.int32).contiguous(), torch.cat(tok_times)


# ---------------------------------------------------------------------------
# modules (parameter containers named as deepv_tpu's tree)
# ---------------------------------------------------------------------------

class _Weight(nn.Module):
    """A bare ``weight`` vector (the RMSNorm scales)."""

    def __init__(self, n: int, device):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(n, device=device))


class _AdaLN(nn.Module):
    def __init__(self, dim: int, n_out: int, device):
        super().__init__()
        self.linear = nn.Linear(dim, n_out, device=device)


class _FeedForward(nn.Module):
    def __init__(self, dim: int, device, tp: int = 1):
        super().__init__()
        self.proj = nn.Linear(dim, 4 * dim // tp, device=device)
        self.out = nn.Linear(4 * dim // tp, dim, device=device)


class _MLPEmbed(nn.Module):
    def __init__(self, n_in: int, dim: int, device):
        super().__init__()
        self.linear_1 = nn.Linear(n_in, dim, device=device)
        self.linear_2 = nn.Linear(dim, dim, device=device)


class _TimeTextEmbed(nn.Module):
    def __init__(self, cfg: MMDiTConfig, device):
        super().__init__()
        self.timestep_embedder = _MLPEmbed(256, cfg.inner_dim, device)
        self.text_embedder = _MLPEmbed(cfg.pooled_projection_dim, cfg.inner_dim, device)


class _PatchEmbed(nn.Module):
    def __init__(self, cfg: MMDiTConfig, device):
        super().__init__()
        D, c, p = cfg.inner_dim, cfg.in_channels, cfg.patch_size
        self.proj = nn.Conv2d(c, D, p, stride=p, device=device)
        self.proj_history = nn.Conv2d(c, D, p, stride=p, device=device)
        m = cfg.pos_embed_max_size
        self.pos_embed = nn.Parameter(torch.empty(1, m * m, D, device=device))


class _JointAttention(nn.Module):
    def __init__(self, cfg: MMDiTConfig, last: bool, device, tp: int = 1):
        super().__init__()
        D, hd = cfg.inner_dim, cfg.attention_head_dim
        for name in ("to_q", "to_k", "to_v", "add_q_proj", "add_k_proj", "add_v_proj"):
            setattr(self, name, nn.Linear(D, D // tp, device=device))
        self.to_out = nn.Linear(D // tp, D, device=device)
        for name in ("norm_q", "norm_k", "norm_add_q", "norm_add_k"):
            setattr(self, name, _Weight(hd, device))
        if not last:
            self.to_add_out = nn.Linear(D // tp, D, device=device)


class JointBlock(nn.Module):
    """JointTransformerBlock; the last block is context-pre-only."""

    def __init__(self, cfg: MMDiTConfig, last: bool, device, tp: int = 1):
        super().__init__()
        D = cfg.inner_dim
        self.context_pre_only = last
        self.norm1 = _AdaLN(D, 6 * D, device)
        self.norm1_context = _AdaLN(D, 2 * D if last else 6 * D, device)
        self.attn = _JointAttention(cfg, last, device, tp)
        self.ff = _FeedForward(D, device, tp)
        if not last:
            self.ff_context = _FeedForward(D, device, tp)


class Int8Linear(nn.Module):
    """A linear layer quantised for the W8A8 path (``ops/linear_int8.py``):
    buffers ``weight_int8`` [out, in], ``weight_scale`` [out] and ``bias``
    (or None). It holds no floating-point weight. ``group``: the layer is
    row-split over that group, and its weight scale is the group's maximum."""

    def __init__(self, lin: nn.Linear, group=None):
        super().__init__()
        w8, sw = quantize_linear(lin.weight, group)
        self.register_buffer("weight_int8", w8)
        self.register_buffer("weight_scale", sw)
        self.register_buffer("bias", None if lin.bias is None else lin.bias.detach())


#: per-block linears of the W8A8 path: the token-proportional D^2 products
#: of both streams. AdaLN ("norm*"), embedders and proj_out stay exact.
INT8_ATTN_KEYS = ("to_q", "to_k", "to_v", "to_out",
                  "add_q_proj", "add_k_proj", "add_v_proj", "to_add_out")
INT8_FF_KEYS = ("ff", "ff_context")


def quantize_mmdit(model: "MMDiT") -> "MMDiT":
    """Swap every joint block's attention and feed-forward ``nn.Linear``s
    for ``Int8Linear``s in place (deepv_tpu's ``quantize_mmdit_params`` with
    ``keep_original=False``): the model keeps no reference to their
    floating-point weights, which are freed once the caller's own
    references go. The last block has no ``to_add_out`` or ``ff_context``.
    Under tensor parallelism (``model.tp_group``) the row-split layers'
    weight scales are the maximum over the group, as deepv_tpu's GSPMD
    computes them on the sharded weight."""
    group = model.tp_group
    for block in model.transformer_blocks:
        for k in INT8_ATTN_KEYS:
            if hasattr(block.attn, k):
                row = group if k in ("to_out", "to_add_out") else None
                setattr(block.attn, k, Int8Linear(getattr(block.attn, k), row))
        for ff_key in INT8_FF_KEYS:
            ff = getattr(block, ff_key, None)
            if ff is not None:
                for k in ("proj", "out"):
                    setattr(ff, k, Int8Linear(getattr(ff, k), group if k == "out" else None))
    return model


class MMDiT(nn.Module):
    """The denoiser's parameters; ``forward`` is :func:`mmdit_forward`.
    With ``tp_group`` (a process group of n ranks) it holds this rank's
    tensor-parallel share (``parallel/tp.shard_mmdit_params`` cuts it) and
    its forward sums the row-split products over the group."""

    def __init__(self, cfg: MMDiTConfig, device="meta", tp_group=None):
        super().__init__()
        self.cfg = cfg
        self.tp_group = tp_group
        tp = 1 if tp_group is None else dist.get_world_size(tp_group)
        if cfg.num_attention_heads % tp:
            raise ValueError(f"{cfg.num_attention_heads} heads do not split over {tp} ranks")
        D = cfg.inner_dim
        self.pos_embed = _PatchEmbed(cfg, device)
        self.time_text_embed = _TimeTextEmbed(cfg, device)
        self.context_embedder = nn.Linear(cfg.joint_attention_dim,
                                          cfg.caption_projection_dim, device=device)
        self.transformer_blocks = nn.ModuleList(
            JointBlock(cfg, i == cfg.num_layers - 1, device, tp) for i in range(cfg.num_layers))
        self.norm_out = _AdaLN(D, 2 * D, device)
        self.proj_out = nn.Linear(D, cfg.patch_size ** 2 * cfg.out_channels, device=device)

    def forward(self, *args, **kwargs) -> torch.Tensor:
        return mmdit_forward(self, *args, **kwargs)


# ---------------------------------------------------------------------------
# patch embedding
# ---------------------------------------------------------------------------

def _patchify_frames(x: torch.Tensor, proj: nn.Module, patch: int) -> torch.Tensor:
    """Per-frame p x p conv patchify as one matmul: [b, c, t, h, w] ->
    tokens [b, t, h/p, w/p, D]; weight [D, c, p, p] in (c, p1, p2) order."""
    b, c, t, h, w = x.shape
    hp, wp = h // patch, w // patch
    xx = x.reshape(b, c, t, hp, patch, wp, patch)
    xx = xx.permute(0, 2, 3, 5, 1, 4, 6).reshape(b, t, hp, wp, c * patch * patch)
    wmat = proj.weight.reshape(proj.weight.shape[0], -1).to(x.dtype)
    return torch.matmul(xx, wmat.T) + proj.bias.to(x.dtype)


def cropped_pos_embed(pos_table: torch.Tensor, cfg: MMDiTConfig,
                      h: int, w: int, ori_h: int, ori_w: int) -> torch.Tensor:
    """SD3 cropped positional embedding with condition interpolation; all
    dims in latent pixels; table [1, M*M, D]."""
    p = cfg.patch_size
    h, w, ori_h, ori_w = h // p, w // p, ori_h // p, ori_w // p
    m = cfg.pos_embed_max_size
    grid = pos_table.reshape(1, m, m, -1)
    if cfg.interp_condition_pos:
        top = (m - ori_h) // 2
        left = (m - ori_w) // 2
        crop = grid[:, top:top + ori_h, left:left + ori_w]
        if (ori_h, ori_w) != (h, w):
            crop = resize_bilinear(crop.permute(0, 3, 1, 2), (h, w)).permute(0, 2, 3, 1)
    else:
        top = (m - h) // 2
        left = (m - w) // 2
        crop = grid[:, top:top + h, left:left + w]
    return crop.reshape(1, h * w, -1)


def embed_clips(cfg: MMDiTConfig, p: _PatchEmbed, clips: List[torch.Tensor]) -> torch.Tensor:
    """Patchify + pos-embed a clip list into video tokens [b, Lv, D]; the
    crop's reference dims come from the LAST clip."""
    patch = cfg.patch_size
    ori_h, ori_w = clips[-1].shape[-2:]
    toks = []
    for x in clips:
        y = _patchify_frames(x, p.proj, patch)
        b, t, hp, wp, d = y.shape
        pos = cropped_pos_embed(p.pos_embed, cfg, x.shape[-2], x.shape[-1], ori_h, ori_w)
        y = y.reshape(b, t, hp * wp, d) + pos[:, None].to(y.dtype)
        toks.append(y.reshape(b, t * hp * wp, d))
    return torch.cat(toks, dim=1)


def embed_history(cfg: MMDiTConfig, p: _PatchEmbed, history: torch.Tensor,
                  downsample_ratio: int) -> torch.Tensor:
    """History latent -> tokens via proj_history after a spatial downsample."""
    b, c, t, h, w = history.shape
    if downsample_ratio == 2:
        xd = down2x_bilinear(history.reshape(b, c * t, h, w)).reshape(b, c, t, h // 2, w // 2)
    elif downsample_ratio == 1:
        xd = history
    else:
        hd, wd = h // downsample_ratio, w // downsample_ratio
        xd = resize_bilinear(history.reshape(b, c * t, h, w), (hd, wd)).reshape(b, c, t, hd, wd)
    y = _patchify_frames(xd, p.proj_history, cfg.patch_size)
    bb, t, hp, wp, d = y.shape
    pos = cropped_pos_embed(p.pos_embed, cfg, xd.shape[-2], xd.shape[-1],
                            xd.shape[-2], xd.shape[-1])
    y = y.reshape(bb, t, hp * wp, d) + pos[:, None].to(y.dtype)
    return y.reshape(bb, t * hp * wp, d)


# ---------------------------------------------------------------------------
# transformer blocks
# ---------------------------------------------------------------------------

def _adaln_zero(p: _AdaLN, x: torch.Tensor, emb: torch.Tensor):
    """AdaLN-Zero: modulated x and the five gates/shifts/scales."""
    mod = linear(silu(emb), p.linear)
    shift_msa, scale_msa, gate_msa, shift_mlp, scale_mlp, gate_mlp = mod.chunk(6, dim=-1)
    xn = layer_norm(x) * (1 + scale_msa[:, None]) + shift_msa[:, None]
    return xn, gate_msa[:, None], shift_mlp[:, None], scale_mlp[:, None], gate_mlp[:, None]


def _adaln_continuous(p: _AdaLN, x: torch.Tensor, emb: torch.Tensor) -> torch.Tensor:
    """AdaLN-continuous: (scale, shift) chunk order."""
    scale, shift = linear(silu(emb), p.linear).chunk(2, dim=-1)
    return layer_norm(x) * (1 + scale[:, None]) + shift[:, None]


def _row_linear(x: torch.Tensor, p, tp_group) -> torch.Tensor:
    """A row-split linear: without a group, ``linear``; with one, this
    rank's partial product summed over the group, then the bias once (an
    ``Int8Linear``: ``linear_int8`` over the group)."""
    if tp_group is None:
        return linear(x, p)
    if hasattr(p, "weight_int8"):
        return linear_int8(x, p, tp_group)
    y = comm.reduce(F.linear(x, p.weight.to(x.dtype)), tp_group)
    return y + p.bias.to(y.dtype)


def _split_in(x: torch.Tensor, tp_group) -> torch.Tensor:
    """``x`` as the input of this rank's share of a split computation: under
    tensor parallelism its gradient is summed over the group."""
    return x if tp_group is None else comm.copy(x, tp_group)


def _ff(p: _FeedForward, x: torch.Tensor, tp_group=None) -> torch.Tensor:
    return _row_linear(gelu_tanh(linear(_split_in(x, tp_group), p.proj)), p.out, tp_group)


def joint_attention(cfg: MMDiTConfig, p: _JointAttention, hidden: torch.Tensor,
                    ctx: torch.Tensor, valid: torch.Tensor, times: torch.Tensor,
                    n_last: int, rope_cos: torch.Tensor, rope_sin: torch.Tensor,
                    context_pre_only: bool, tp_group=None):
    """Joint text+video attention over the packed sequence; ctx tokens
    lead. ``valid`` [b, S] int32 and ``times`` [S] float32 define the mask.
    The head count is the projections' width over the head dim: all heads,
    or this rank's under tensor parallelism."""
    b, lv, _ = hidden.shape
    lc = ctx.shape[1]
    hd = cfg.attention_head_dim

    hidden, ctx = _split_in(hidden, tp_group), _split_in(ctx, tp_group)
    norm = lambda m: _split_in(m.weight, tp_group)     # applied to this rank's heads

    q = rms_norm(linear(hidden, p.to_q).reshape(b, lv, -1, hd), norm(p.norm_q), 1e-5)
    k = rms_norm(linear(hidden, p.to_k).reshape(b, lv, -1, hd), norm(p.norm_k), 1e-5)
    v = linear(hidden, p.to_v).reshape(b, lv, -1, hd)
    cq = rms_norm(linear(ctx, p.add_q_proj).reshape(b, lc, -1, hd), norm(p.norm_add_q), 1e-5)
    ck = rms_norm(linear(ctx, p.add_k_proj).reshape(b, lc, -1, hd), norm(p.norm_add_k), 1e-5)
    cv = linear(ctx, p.add_v_proj).reshape(b, lc, -1, hd)

    q = apply_rope(torch.cat([cq, q], dim=1), rope_cos, rope_sin)
    k = apply_rope(torch.cat([ck, k], dim=1), rope_cos, rope_sin)
    v = torch.cat([cv, v], dim=1)

    out = attention(q, k, v, valid, times, n_last=n_last).reshape(b, lc + lv, -1)
    ctx_out, vid_out = out[:, :lc], out[:, lc:]
    vid_out = _row_linear(vid_out, p.to_out, tp_group)
    if not context_pre_only:
        ctx_out = _row_linear(ctx_out, p.to_add_out, tp_group)
    return vid_out, ctx_out


def joint_block(cfg: MMDiTConfig, p: JointBlock, hidden: torch.Tensor, ctx: torch.Tensor,
                temb: torch.Tensor, valid: torch.Tensor, times: torch.Tensor, n_last: int,
                rope_cos: torch.Tensor, rope_sin: torch.Tensor, tp_group=None):
    """JointTransformerBlock."""
    pre_only = p.context_pre_only
    hn, gate_msa, shift_mlp, scale_mlp, gate_mlp = _adaln_zero(p.norm1, hidden, temb)
    if pre_only:
        cn = _adaln_continuous(p.norm1_context, ctx, temb)
    else:
        cn, c_gate_msa, c_shift_mlp, c_scale_mlp, c_gate_mlp = _adaln_zero(
            p.norm1_context, ctx, temb)

    attn_out, ctx_attn = joint_attention(cfg, p.attn, hn, cn, valid, times, n_last,
                                         rope_cos, rope_sin, pre_only, tp_group)
    hidden = hidden + gate_msa * attn_out
    hn2 = layer_norm(hidden) * (1 + scale_mlp) + shift_mlp
    hidden = hidden + gate_mlp * _ff(p.ff, hn2, tp_group)

    if pre_only:
        return hidden, ctx
    ctx = ctx + c_gate_msa * ctx_attn
    cn2 = layer_norm(ctx) * (1 + c_scale_mlp) + c_shift_mlp
    ctx = ctx + c_gate_mlp * _ff(p.ff_context, cn2, tp_group)
    return hidden, ctx


# ---------------------------------------------------------------------------
# full forward
# ---------------------------------------------------------------------------

def mmdit_forward(model: MMDiT, clips: List[torch.Tensor],
                  text_embeds: torch.Tensor, text_mask: torch.Tensor,
                  pooled: torch.Tensor, timestep: torch.Tensor,
                  history: Optional[torch.Tensor] = None,
                  history_mask: Optional[torch.Tensor] = None,
                  history_downsample_ratio: int = 2,
                  frame_times: Optional[List[torch.Tensor]] = None,
                  frame_valid: Optional[List[torch.Tensor]] = None,
                  split_last_attn: bool = False) -> torch.Tensor:
    """One denoise forward over a packed clip list; clips oldest -> newest,
    each [b, c, t, h, w]. Returns the velocity of the LAST clip,
    [b, c, t, h, w].

    ``frame_times``/``frame_valid`` (one [t_i] tensor per clip) give each
    frame its time and validity; frames with valid 0 join the id-0 group
    (masked text, absent history, padding frames). Without them every frame
    is valid and frames count up across clips.
    ``split_last_attn``: the caller guarantees the last clip's times are
    strictly the largest, which the attention may exploit (``n_last``)."""
    cfg = model.cfg
    te = timestep_embedding(timestep).to(text_embeds.dtype)
    tte = model.time_text_embed
    temb = (linear(silu(linear(te, tte.timestep_embedder.linear_1)),
                   tte.timestep_embedder.linear_2)
            + linear(silu(linear(pooled, tte.text_embedder.linear_1)),
                     tte.text_embedder.linear_2))
    ctx = linear(text_embeds, model.context_embedder)

    ctx_valid = text_mask
    if history is not None:
        hist_tokens = embed_history(cfg, model.pos_embed, history, history_downsample_ratio)
        ctx = torch.cat([hist_tokens.to(ctx.dtype), ctx], dim=1)
        ctx_valid = torch.cat([history_mask.to(text_mask.dtype), text_mask], dim=1)

    layout = PackedLayout(cfg, [tuple(c.shape[2:]) for c in clips], ctx.shape[1])
    valid, times = packed_mask(layout, ctx_valid, frame_times, frame_valid)
    rope_cos, rope_sin = rope_tables_torch(times, cfg.attention_head_dim)
    n_last = layout.clip_tokens[-1] if split_last_attn else 0
    p_ = cfg.patch_size

    hidden = embed_clips(cfg, model.pos_embed, clips)
    for bp in model.transformer_blocks:
        hidden, ctx = joint_block(cfg, bp, hidden, ctx, temb, valid, times, n_last,
                                  rope_cos, rope_sin, model.tp_group)

    hidden = _adaln_continuous(model.norm_out, hidden, temb)
    hidden = linear(hidden, model.proj_out)

    # unpatchify only the last clip
    t, h, w = layout.clip_shapes[-1]
    hp, wp = h // p_, w // p_
    out = hidden[:, -layout.clip_tokens[-1]:]
    out = out.reshape(out.shape[0], t, hp, wp, p_, p_, cfg.out_channels)
    return out.permute(0, 6, 1, 2, 4, 3, 5).reshape(out.shape[0], cfg.out_channels, t, h, w)
