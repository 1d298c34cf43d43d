"""The MMDiT denoiser of DeepVerse 1.1 in plain PyTorch.

SD3's joint-attention DiT over one packed sequence per forward: text (and
history) tokens, then condition clips at mixed pyramid resolutions, then
the current unit, with AdaLN-Zero blocks (the last context-pre-only),
RMS-normed q/k per head, temporal RoPE on interleaved feature pairs, and
one attention whose mask allows a pair when both tokens have the same
validity id and the key's time is not after the query's
(``(valid_q == valid_k) & (time_q >= time_k)``; disallowed logits at
-1e30). Everything computes in float32 except the products, which go
through ``Numerics``.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from .numerics import Numerics
from .params import is_block_linear

MASKED = -1e30


class MMDiT:
    """The transformer's float32 weights and forward. ``params`` maps the
    tree's dotted paths (without ``mmdit.``) to tensors."""

    def __init__(self, cfg: Dict, params: Dict[str, torch.Tensor], num: Numerics):
        self.cfg = cfg
        self.p = {k: v.to(torch.float32) for k, v in params.items()}
        self.num = num
        self.d = cfg["num_attention_heads"] * cfg["attention_head_dim"]

    def lin(self, name: str, x: torch.Tensor) -> torch.Tensor:
        return self.num.linear(x, self.p[name + ".weight"], self.p.get(name + ".bias"),
                               quantised=is_block_linear(name))

    # -- embeddings -----------------------------------------------------------

    @staticmethod
    def timestep_embedding(t: torch.Tensor, dim: int = 256) -> torch.Tensor:
        """Sinusoidal embedding, cosines first, frequencies
        ``exp(-ln(10000) * i / (dim / 2))`` in float32."""
        half = dim // 2
        expo = (np.float32(-math.log(10000.0)) * np.arange(half, dtype=np.float32)
                / np.float32(half))
        freqs = torch.as_tensor(np.exp(expo.astype(np.float64)).astype(np.float32),
                                device=t.device)
        args = (t.to(torch.float32)[:, None] * freqs[None]).to(torch.float64)
        return torch.cat([torch.cos(args), torch.sin(args)], dim=-1).to(torch.float32)

    def patchify(self, x: torch.Tensor, proj: str) -> torch.Tensor:
        """Per-frame p x p patch projection: [b, c, t, h, w] -> [b, t, h/p, w/p, D]."""
        p = self.cfg["patch_size"]
        b, c, t, h, w = x.shape
        xx = x.reshape(b, c, t, h // p, p, w // p, p).permute(0, 2, 3, 5, 1, 4, 6)
        xx = xx.reshape(b, t, h // p, w // p, c * p * p)
        wmat = self.p[f"pos_embed.{proj}.weight"].reshape(self.d, -1)
        return self.num.linear(xx, wmat, self.p[f"pos_embed.{proj}.bias"])

    def pos_embed(self, h: int, w: int, ori_h: int, ori_w: int) -> torch.Tensor:
        """SD3's centre-cropped sincos table, cropped at the reference dims
        ``ori`` and resized bilinearly (half-pixel, no antialias) to the
        clip's own: ``[1, h*w/p^2, D]``."""
        p, m = self.cfg["patch_size"], self.cfg["pos_embed_max_size"]
        h, w, ori_h, ori_w = h // p, w // p, ori_h // p, ori_w // p
        grid = self.p["pos_embed.pos_embed"].reshape(1, m, m, -1)
        if self.cfg["interp_condition_pos"]:
            top, left = (m - ori_h) // 2, (m - ori_w) // 2
            crop = grid[:, top:top + ori_h, left:left + ori_w]
            if (ori_h, ori_w) != (h, w):
                planes = crop.permute(0, 3, 1, 2).reshape(-1, 1, ori_h, ori_w)
                planes = F.interpolate(planes, size=(h, w), mode="bilinear",
                                       align_corners=False, antialias=False)
                crop = planes.reshape(1, -1, h, w).permute(0, 2, 3, 1)
        else:
            top, left = (m - h) // 2, (m - w) // 2
            crop = grid[:, top:top + h, left:left + w]
        return crop.reshape(1, h * w, -1)

    def embed_clips(self, clips: List[torch.Tensor]) -> torch.Tensor:
        ori_h, ori_w = clips[-1].shape[-2:]
        toks = []
        for x in clips:
            y = self.patchify(x, "proj")
            b, t, hp, wp, d = y.shape
            y = y.reshape(b, t, hp * wp, d) + self.pos_embed(x.shape[-2], x.shape[-1],
                                                             ori_h, ori_w)[:, None]
            toks.append(y.reshape(b, t * hp * wp, d))
        return torch.cat(toks, dim=1)

    def embed_history(self, history: torch.Tensor, ratio: int) -> torch.Tensor:
        b, c, t, h, w = history.shape
        if ratio != 2:
            raise ValueError(f"history downsample ratio {ratio}: the reference takes 2")
        xd = history.reshape(b, c * t, h // 2, 2, w // 2, 2).mean(dim=(-3, -1))
        xd = xd.reshape(b, c, t, h // 2, w // 2)
        y = self.patchify(xd, "proj_history")
        bb, tt, hp, wp, d = y.shape
        y = y.reshape(bb, tt, hp * wp, d) + self.pos_embed(h // 2, w // 2, h // 2, w // 2)[:, None]
        return y.reshape(bb, tt * hp * wp, d)

    # -- blocks ------------------------------------------------------------------

    @staticmethod
    def layer_norm(x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
        mean = x.mean(dim=-1, keepdim=True)
        var = (x - mean).square().mean(dim=-1, keepdim=True)
        return (x - mean) * torch.rsqrt(var + eps)

    @staticmethod
    def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
        return x * torch.rsqrt(x.square().mean(dim=-1, keepdim=True) + eps) * w

    @staticmethod
    def rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
        """Rotate interleaved (even, odd) pairs of x [b, s, h, d]."""
        b, s, h, d = x.shape
        xf = x.reshape(b, s, h, d // 2, 2)
        c, si = cos[:, None, :], sin[:, None, :]
        even, odd = xf[..., 0], xf[..., 1]
        return torch.stack([c * even - si * odd, si * even + c * odd], dim=-1).reshape(b, s, h, d)

    def attention(self, q, k, v, valid, times) -> torch.Tensor:
        """Masked softmax attention, one batch row at a time; q/k/v
        [b, S, h, d]."""
        scale = 1.0 / math.sqrt(q.shape[-1])
        allowed = (valid[:, :, None] == valid[:, None, :]) & (times[:, None] >= times[None, :])[None]
        out = []
        for i in range(q.shape[0]):
            qi, ki, vi = (x[i].transpose(0, 1) for x in (q, k, v))       # [h, S, d]
            logits = self.num.matmul(qi, ki.transpose(1, 2)) * scale
            logits = logits.masked_fill(~allowed[i][None], MASKED)
            out.append(self.num.matmul(torch.softmax(logits, dim=-1), vi).transpose(0, 1))
        return torch.stack(out)

    def block(self, i: int, hidden, ctx, temb, valid, times, cos, sin):
        b = f"transformer_blocks.{i}"
        last = i == self.cfg["num_layers"] - 1
        hd = self.cfg["attention_head_dim"]
        e = F.silu(temb)
        sh_msa, sc_msa, g_msa, sh_mlp, sc_mlp, g_mlp = self.lin(f"{b}.norm1.linear", e).chunk(6, -1)
        hn = self.layer_norm(hidden) * (1 + sc_msa[:, None]) + sh_msa[:, None]
        cmod = self.lin(f"{b}.norm1_context.linear", e)
        if last:
            c_sc, c_sh = cmod.chunk(2, -1)
            cn = self.layer_norm(ctx) * (1 + c_sc[:, None]) + c_sh[:, None]
        else:
            c_sh_msa, c_sc_msa, c_g_msa, c_sh_mlp, c_sc_mlp, c_g_mlp = cmod.chunk(6, -1)
            cn = self.layer_norm(ctx) * (1 + c_sc_msa[:, None]) + c_sh_msa[:, None]

        nb, lv, _ = hn.shape
        lc = cn.shape[1]

        def heads(x, n):
            return x.reshape(nb, n, -1, hd)

        a = f"{b}.attn"
        q = self.rms_norm(heads(self.lin(f"{a}.to_q", hn), lv), self.p[f"{a}.norm_q.weight"])
        k = self.rms_norm(heads(self.lin(f"{a}.to_k", hn), lv), self.p[f"{a}.norm_k.weight"])
        v = heads(self.lin(f"{a}.to_v", hn), lv)
        cq = self.rms_norm(heads(self.lin(f"{a}.add_q_proj", cn), lc), self.p[f"{a}.norm_add_q.weight"])
        ck = self.rms_norm(heads(self.lin(f"{a}.add_k_proj", cn), lc), self.p[f"{a}.norm_add_k.weight"])
        cv = heads(self.lin(f"{a}.add_v_proj", cn), lc)
        q = self.rope(torch.cat([cq, q], dim=1), cos, sin)
        k = self.rope(torch.cat([ck, k], dim=1), cos, sin)
        o = self.attention(q, k, torch.cat([cv, v], dim=1), valid, times).reshape(nb, lc + lv, -1)
        hidden = hidden + g_msa[:, None] * self.lin(f"{a}.to_out", o[:, lc:])
        hn2 = self.layer_norm(hidden) * (1 + sc_mlp[:, None]) + sh_mlp[:, None]
        ff = self.lin(f"{b}.ff.out", F.gelu(self.lin(f"{b}.ff.proj", hn2), approximate="tanh"))
        hidden = hidden + g_mlp[:, None] * ff
        if last:
            return hidden, ctx
        ctx = ctx + c_g_msa[:, None] * self.lin(f"{a}.to_add_out", o[:, :lc])
        cn2 = self.layer_norm(ctx) * (1 + c_sc_mlp[:, None]) + c_sh_mlp[:, None]
        cff = self.lin(f"{b}.ff_context.out",
                       F.gelu(self.lin(f"{b}.ff_context.proj", cn2), approximate="tanh"))
        return hidden, ctx + c_g_mlp[:, None] * cff

    # -- forward -------------------------------------------------------------------

    def forward(self, clips: List[torch.Tensor], text: torch.Tensor, text_mask: torch.Tensor,
                pooled: torch.Tensor, timestep: torch.Tensor,
                history: Optional[torch.Tensor], history_mask: Optional[torch.Tensor],
                history_ratio: int, frame_times: List[torch.Tensor],
                frame_valid: List[torch.Tensor]) -> torch.Tensor:
        """The velocity of the last clip, [b, c, t, h, w], float32."""
        cfg, p = self.cfg, self.cfg["patch_size"]
        f32 = torch.float32
        clips = [c.to(f32) for c in clips]
        te = self.timestep_embedding(timestep)
        temb = (self.lin("time_text_embed.timestep_embedder.linear_2",
                         F.silu(self.lin("time_text_embed.timestep_embedder.linear_1", te)))
                + self.lin("time_text_embed.text_embedder.linear_2",
                           F.silu(self.lin("time_text_embed.text_embedder.linear_1",
                                           pooled.to(f32)))))
        ctx = self.lin("context_embedder", text.to(f32))
        ctx_valid = text_mask.to(torch.int32)
        if history is not None:
            ctx = torch.cat([self.embed_history(history.to(f32), history_ratio), ctx], dim=1)
            ctx_valid = torch.cat([history_mask.to(torch.int32), ctx_valid], dim=1)

        dev = ctx.device
        tok_times = [torch.zeros(ctx.shape[1], dtype=f32, device=dev)]
        vid_valid = []
        for x, ft, fv in zip(clips, frame_times, frame_valid):
            per_frame = (x.shape[3] // p) * (x.shape[4] // p)
            tok_times.append(ft.to(f32).repeat_interleave(per_frame))
            vid_valid.append(fv.to(torch.int32).repeat_interleave(per_frame))
        times = torch.cat(tok_times)
        vv = torch.cat(vid_valid)[None].expand(ctx.shape[0], -1)
        valid = torch.cat([ctx_valid, vv], dim=1)
        hd = cfg["attention_head_dim"]
        omega = 1.0 / (10000.0 ** (torch.arange(0, hd, 2, dtype=torch.float64, device=dev) / hd))
        ang = times.to(torch.float64)[:, None] * omega[None]
        cos, sin = torch.cos(ang).to(f32), torch.sin(ang).to(f32)

        hidden = self.embed_clips(clips)
        for i in range(cfg["num_layers"]):
            hidden, ctx = self.block(i, hidden, ctx, temb, valid, times, cos, sin)
        scale, shift = self.lin("norm_out.linear", F.silu(temb)).chunk(2, -1)
        hidden = self.layer_norm(hidden) * (1 + scale[:, None]) + shift[:, None]
        hidden = self.lin("proj_out", hidden)

        t, h, w = clips[-1].shape[2:]
        n_last = t * (h // p) * (w // p)
        c_out = cfg["in_channels"]
        out = hidden[:, -n_last:].reshape(hidden.shape[0], t, h // p, w // p, p, p, c_out)
        return out.permute(0, 6, 1, 2, 4, 3, 5).reshape(hidden.shape[0], c_out, t, h, w)
