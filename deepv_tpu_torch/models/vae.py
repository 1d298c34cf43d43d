"""Causal video VAE with explicit temporal caches.

Counterpart of ``deepv_tpu/models/vae.py`` (single device, untiled): an 8x
spatial and 8x temporal compressing KL autoencoder (57 pixel frames <-> 8
latent frames) built from causal 3D convolutions. Chunked encode/decode
thread the conv caches as nested dicts, so chunked == full exactly, and the
decoder's chunk-boundary priming rebuilds the last block's caches from the
trailing frames it needs.

``VAE`` is an ``nn.Module`` named as deepv_tpu's parameter tree
(``encoder.down_blocks.0.resnets.0.conv1.weight``, ...), built on the
``meta`` device and loaded by ``io/weights.params_from_numpy``.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from ..config import VAEConfig
from ..ops.basic import compute_dtype, exp_f32, group_norm, linear, silu
from ..ops.causal_conv import causal_conv3d


def _get(cache, key):
    return None if cache is None else cache.get(key)


def _idx(cache, i):
    return None if cache is None else cache[i]


# ---------------------------------------------------------------------------
# modules (parameter containers named as deepv_tpu's tree)
# ---------------------------------------------------------------------------

class _Norm(nn.Module):
    def __init__(self, c: int, device):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(c, device=device))
        self.bias = nn.Parameter(torch.empty(c, device=device))


def _conv(ci: int, co: int, k: int, device) -> nn.Conv3d:
    return nn.Conv3d(ci, co, k, device=device)


class _Resnet(nn.Module):
    def __init__(self, ci: int, co: int, device):
        super().__init__()
        self.norm1 = _Norm(ci, device)
        self.conv1 = _conv(ci, co, 3, device)
        self.norm2 = _Norm(co, device)
        self.conv2 = _conv(co, co, 3, device)
        if ci != co:
            self.conv_shortcut = _conv(ci, co, 1, device)


class _Attn2d(nn.Module):
    def __init__(self, c: int, device):
        super().__init__()
        self.group_norm = _Norm(c, device)
        for name in ("to_q", "to_k", "to_v", "to_out"):
            setattr(self, name, nn.Linear(c, c, device=device))


class _MidBlock(nn.Module):
    def __init__(self, c: int, device):
        super().__init__()
        self.resnets = nn.ModuleList([_Resnet(c, c, device), _Resnet(c, c, device)])
        self.attentions = nn.ModuleList([_Attn2d(c, device)])


class _Block(nn.Module):
    def __init__(self, ci: int, co: int, n_resnets: int, device, **samplers):
        super().__init__()
        self.resnets = nn.ModuleList(
            _Resnet(ci if j == 0 else co, co, device) for j in range(n_resnets))
        for name, c_out in samplers.items():
            if c_out:
                setattr(self, name, _conv(co, c_out, 3, device))


class Encoder(nn.Module):
    def __init__(self, cfg: VAEConfig, device):
        super().__init__()
        ech = cfg.encoder_block_out_channels
        z = cfg.encoder_out_channels
        self.conv_in = _conv(cfg.encoder_in_channels, ech[0], 3, device)
        blocks, c_prev = [], ech[0]
        for i, c in enumerate(ech):
            blocks.append(_Block(
                c_prev, c, cfg.encoder_layers_per_block[i], device,
                downsampler=c if cfg.encoder_spatial_down_sample[i] else 0,
                temporal_downsampler=c if cfg.encoder_temporal_down_sample[i] else 0))
            c_prev = c
        self.down_blocks = nn.ModuleList(blocks)
        self.mid_block = _MidBlock(ech[-1], device)
        self.conv_norm_out = _Norm(ech[-1], device)
        self.conv_out = _conv(ech[-1], 2 * z, 3, device)
        self.quant_conv = _conv(2 * z, 2 * z, 1, device)


class Decoder(nn.Module):
    def __init__(self, cfg: VAEConfig, device):
        super().__init__()
        dch = cfg.decoder_block_out_channels
        rev = list(reversed(dch))
        self.post_quant_conv = _conv(cfg.encoder_out_channels, cfg.decoder_in_channels, 1, device)
        self.conv_in = _conv(cfg.decoder_in_channels, dch[-1], 3, device)
        self.mid_block = _MidBlock(dch[-1], device)
        blocks, c_prev = [], rev[0]
        for i, c in enumerate(rev):
            blocks.append(_Block(
                c_prev, c, cfg.decoder_layers_per_block[i], device,
                upsampler=4 * c if cfg.decoder_spatial_up_sample[i] else 0,
                temporal_upsampler=2 * c if cfg.decoder_temporal_up_sample[i] else 0))
            c_prev = c
        self.up_blocks = nn.ModuleList(blocks)
        self.conv_norm_out = _Norm(dch[0], device)
        self.conv_out = _conv(dch[0], cfg.decoder_out_channels, 3, device)


class VAE(nn.Module):
    """The VAE's parameters: ``encoder`` and ``decoder``."""

    def __init__(self, cfg: VAEConfig, device="meta"):
        super().__init__()
        self.cfg = cfg
        self.encoder = Encoder(cfg, device)
        self.decoder = Decoder(cfg, device)


# ---------------------------------------------------------------------------
# building blocks
# ---------------------------------------------------------------------------

def causal_group_norm(x: torch.Tensor, num_groups: int, p) -> torch.Tensor:
    """GroupNorm per frame: statistics never cross the time axis."""
    b, c, t, h, w = x.shape
    x2 = x.transpose(1, 2).reshape(b * t, c, h, w)
    y = group_norm(x2, num_groups, p.weight, p.bias)
    return y.reshape(b, t, c, h, w).transpose(1, 2)


def resnet_apply(p: _Resnet, x: torch.Tensor, cache, mode: str, groups: int):
    """CausalResnetBlock3D."""
    h = silu(causal_group_norm(x, groups, p.norm1))
    h, c1 = causal_conv3d(h, p.conv1, _get(cache, "conv1"), mode=mode)
    h = silu(causal_group_norm(h, groups, p.norm2))
    h, c2 = causal_conv3d(h, p.conv2, _get(cache, "conv2"), mode=mode)
    if hasattr(p, "conv_shortcut"):
        x, _ = causal_conv3d(x, p.conv_shortcut, None, mode=mode)
    if mode == "prime":
        # each prime-mode conv consumed kt-1 leading context frames: align
        # the residual with the main path's (4 frames shorter) trailing frames
        x = x[:, :, x.shape[2] - h.shape[2]:]
    return x + h, {"conv1": c1, "conv2": c2}


def attn2d_apply(p: _Attn2d, x: torch.Tensor, groups: int) -> torch.Tensor:
    """Per-frame single-head spatial self-attention with residual: group
    norm -> qkv -> f32 softmax -> out proj -> + residual (plain matmuls)."""
    b, c, t, h, w = x.shape
    x2 = x.transpose(1, 2).reshape(b * t, c, h * w)
    xn = group_norm(x2, groups, p.group_norm.weight, p.group_norm.bias).transpose(1, 2)
    q, k, v = linear(xn, p.to_q), linear(xn, p.to_k), linear(xn, p.to_v)
    ct = compute_dtype(x.dtype)
    logits = torch.matmul(q.to(ct), k.to(ct).transpose(1, 2)) * (1.0 / math.sqrt(c))
    weights = torch.softmax(logits, dim=-1).to(v.dtype)
    out = torch.matmul(weights.to(ct), v.to(ct)).to(v.dtype)
    out = linear(out, p.to_out).transpose(1, 2) + x2
    return out.reshape(b, t, c, h, w).transpose(1, 2)


def midblock_apply(p: _MidBlock, x: torch.Tensor, cache, mode: str, groups: int):
    """CausalUNetMidBlock2D: resnet, then (attn, resnet) pairs."""
    res_cache = _get(cache, "resnets")
    x, c0 = resnet_apply(p.resnets[0], x, _idx(res_cache, 0), mode, groups)
    caches = [c0]
    for i, attn in enumerate(p.attentions):
        x = attn2d_apply(attn, x, groups)
        x, ci = resnet_apply(p.resnets[i + 1], x, _idx(res_cache, i + 1), mode, groups)
        caches.append(ci)
    return x, {"resnets": caches}


def spatial_down_apply(p, x, cache, mode: str):
    """CausalDownsample2x: causal conv with stride (1, 2, 2)."""
    return causal_conv3d(x, p, cache, mode=mode, stride=(1, 2, 2))


def temporal_down_apply(p, x, cache, mode: str):
    """CausalTemporalDownsample2x: causal conv with stride (2, 1, 1)."""
    return causal_conv3d(x, p, cache, mode=mode, stride=(2, 1, 1))


def spatial_up_apply(p, x, cache, mode: str):
    """CausalUpsample2x: conv to 4c then a 2x2 pixel shuffle."""
    y, c = causal_conv3d(x, p, cache, mode=mode)
    b, c4, t, h, w = y.shape
    y = y.reshape(b, c4 // 4, 2, 2, t, h, w).permute(0, 1, 4, 5, 2, 6, 3)
    return y.reshape(b, c4 // 4, t, h * 2, w * 2), c


def temporal_up_apply(p, x, cache, mode: str):
    """CausalTemporalUpsample2x: conv to 2c, temporal unshuffle, and in
    full/init mode drop the duplicated first frame."""
    y, c = causal_conv3d(x, p, cache, mode=mode)
    b, c2, t, h, w = y.shape
    y = y.reshape(b, c2 // 2, 2, t, h, w).transpose(2, 3).reshape(b, c2 // 2, t * 2, h, w)
    if mode in ("full", "init"):
        y = y[:, :, 1:]
    return y, c


# ---------------------------------------------------------------------------
# encoder / decoder
# ---------------------------------------------------------------------------

def encoder_apply(cfg: VAEConfig, p: Encoder, x: torch.Tensor, cache=None,
                  mode: str = "full"):
    """Encoder + quant conv -> Gaussian moments, and the new caches."""
    groups = cfg.encoder_norm_num_groups
    caches = {}
    x, caches["conv_in"] = causal_conv3d(x, p.conv_in, _get(cache, "conv_in"), mode=mode)
    block_caches = []
    for i, bp in enumerate(p.down_blocks):
        bc = _idx(_get(cache, "down_blocks"), i)
        rcaches = []
        for j, rp in enumerate(bp.resnets):
            x, rc = resnet_apply(rp, x, _idx(_get(bc, "resnets"), j), mode, groups)
            rcaches.append(rc)
        out = {"resnets": rcaches}
        if cfg.encoder_spatial_down_sample[i]:
            x, out["downsampler"] = spatial_down_apply(bp.downsampler, x,
                                                       _get(bc, "downsampler"), mode)
        if cfg.encoder_temporal_down_sample[i]:
            x, out["temporal_downsampler"] = temporal_down_apply(
                bp.temporal_downsampler, x, _get(bc, "temporal_downsampler"), mode)
        block_caches.append(out)
    caches["down_blocks"] = block_caches
    x, caches["mid_block"] = midblock_apply(p.mid_block, x, _get(cache, "mid_block"),
                                            mode, groups)
    x = silu(causal_group_norm(x, groups, p.conv_norm_out))
    x, caches["conv_out"] = causal_conv3d(x, p.conv_out, _get(cache, "conv_out"), mode=mode)
    moments, _ = causal_conv3d(x, p.quant_conv, None, mode=mode)
    return moments, caches


def _up_block(cfg: VAEConfig, i: int, bp: _Block, x: torch.Tensor, bc, mode: str):
    groups = cfg.decoder_norm_num_groups
    rcaches = []
    for j, rp in enumerate(bp.resnets):
        x, rc = resnet_apply(rp, x, _idx(_get(bc, "resnets"), j), mode, groups)
        rcaches.append(rc)
    out = {"resnets": rcaches}
    if cfg.decoder_spatial_up_sample[i]:
        x, out["upsampler"] = spatial_up_apply(bp.upsampler, x, _get(bc, "upsampler"), mode)
    if cfg.decoder_temporal_up_sample[i]:
        x, out["temporal_upsampler"] = temporal_up_apply(
            bp.temporal_upsampler, x, _get(bc, "temporal_upsampler"), mode)
    return x, out


def decoder_front(cfg: VAEConfig, p: Decoder, z: torch.Tensor, cache=None,
                  mode: str = "full"):
    """post-quant conv + conv_in + mid block + every up block but the last.
    Returns the last block's input stream and the partial caches."""
    groups = cfg.decoder_norm_num_groups
    caches = {}
    z, _ = causal_conv3d(z, p.post_quant_conv, None, mode=mode)
    x, caches["conv_in"] = causal_conv3d(z, p.conv_in, _get(cache, "conv_in"), mode=mode)
    x, caches["mid_block"] = midblock_apply(p.mid_block, x, _get(cache, "mid_block"),
                                            mode, groups)
    block_caches = []
    for i in range(len(p.up_blocks) - 1):
        x, out = _up_block(cfg, i, p.up_blocks[i], x,
                           _idx(_get(cache, "up_blocks"), i), mode)
        block_caches.append(out)
    caches["up_blocks"] = block_caches
    return x, caches


def decoder_tail(cfg: VAEConfig, p: Decoder, x: torch.Tensor, cache=None,
                 mode: str = "full"):
    """The last up block + conv_norm_out + conv_out; ``cache`` is the full
    decoder cache dict. Returns (pixels, partial caches)."""
    i = len(p.up_blocks) - 1
    x, out = _up_block(cfg, i, p.up_blocks[i], x, _idx(_get(cache, "up_blocks"), i), mode)
    caches = {"up_blocks_last": out}
    x = silu(causal_group_norm(x, cfg.decoder_norm_num_groups, p.conv_norm_out))
    x, caches["conv_out"] = causal_conv3d(x, p.conv_out, _get(cache, "conv_out"), mode=mode)
    return x, caches


def decoder_apply(cfg: VAEConfig, p: Decoder, z: torch.Tensor, cache=None,
                  mode: str = "full"):
    """post-quant conv + decoder -> pixels, and the new caches."""
    x, caches = decoder_front(cfg, p, z, cache, mode)
    x, tail = decoder_tail(cfg, p, x, cache, mode)
    caches["up_blocks"] = caches["up_blocks"] + [tail["up_blocks_last"]]
    caches["conv_out"] = tail["conv_out"]
    return x, caches


def decoder_prime_need(cfg: VAEConfig) -> Optional[int]:
    """Trailing frames of the last up block's input needed to rebuild its
    and conv_out's caches exactly (``4 * n_resnets + 2``), or None when the
    last block has an up/temporal sampler."""
    i = len(cfg.decoder_block_out_channels) - 1
    if cfg.decoder_spatial_up_sample[i] or cfg.decoder_temporal_up_sample[i]:
        return None
    return 4 * cfg.decoder_layers_per_block[i] + 2


def decoder_prime_tail(cfg: VAEConfig, p: Decoder, x: torch.Tensor):
    """Rebuild the last up block's and conv_out's caches from the trailing
    ``decoder_prime_need(cfg)`` frames of the block's input, computing no
    pixels: each prime-mode conv takes its leading 2 frames as context, and
    conv_out's cache is the last two frames of its input."""
    groups = cfg.decoder_norm_num_groups
    need = decoder_prime_need(cfg)
    if need is None or x.shape[2] < need:
        raise ValueError(f"prime tail needs {need} trailing frames, got {x.shape[2]}")
    rcaches = []
    for rp in p.up_blocks[-1].resnets:
        x, rc = resnet_apply(rp, x, None, "prime", groups)
        rcaches.append(rc)
    xn = causal_group_norm(x[:, :, -2:], groups, p.conv_norm_out)
    return {"up_blocks_last": {"resnets": rcaches}, "conv_out": silu(xn)}


# ---------------------------------------------------------------------------
# Gaussian bottleneck
# ---------------------------------------------------------------------------

def gaussian_sample(moments: torch.Tensor, eps: torch.Tensor) -> torch.Tensor:
    """mean + std * eps, with ``eps`` a standard-normal draw of mean's
    shape supplied by the caller."""
    mean, logvar = moments.chunk(2, dim=1)
    logvar = logvar.clamp(-30.0, 20.0)
    std = exp_f32(0.5 * logvar.to(torch.float32)).to(mean.dtype)
    return mean + std * eps.to(mean.dtype)


def gaussian_mode(moments: torch.Tensor) -> torch.Tensor:
    return moments.chunk(2, dim=1)[0]


# ---------------------------------------------------------------------------
# chunked drivers
# ---------------------------------------------------------------------------

def _split_windows(t: int, window: int):
    """Temporal window split [window+1, window, window, ..., rest]."""
    init = window + 1
    sizes = [min(init, t)]
    fid = init
    while fid + window <= t:
        sizes.append(window)
        fid += window
    if fid < t:
        sizes.append(t - fid)
    return sizes


def _enc_window(cfg: VAEConfig, p: Encoder, x, cache, mode: str):
    return encoder_apply(cfg, p, x, cache, mode)


def _dec_window(cfg: VAEConfig, p: Decoder, z, cache, mode: str):
    return decoder_apply(cfg, p, z, cache, mode)


def _dec_prime_warm(cfg: VAEConfig, p: Decoder, z: torch.Tensor):
    """Chunk-boundary warm: per-frame windows through the decoder front,
    keeping only the trailing frames the prime tail needs, then the prime
    tail. Caches only, no overlap pixels."""
    need = decoder_prime_need(cfg)
    t_up = 2 ** sum(cfg.decoder_temporal_up_sample)
    total = 1 + (z.shape[2] - 1) * t_up
    if need is None or total < need:
        raise ValueError(f"priming needs {need} stream frames, the window gives {total}")
    buf, cache, pos = None, None, 0
    lo = total - need
    for fi in range(z.shape[2]):
        x, cache = decoder_front(cfg, p, z[:, :, fi:fi + 1], cache,
                                 "init" if fi == 0 else "cont")
        end = pos + x.shape[2]
        if end > lo:
            part = x if pos >= lo else x[:, :, lo - pos:]
            buf = part if buf is None else torch.cat([buf, part], dim=2)
        pos = end
    tail = decoder_prime_tail(cfg, p, buf)
    cache["up_blocks"] = cache["up_blocks"] + [tail["up_blocks_last"]]
    cache["conv_out"] = tail["conv_out"]
    return cache


def chunk_encode(cfg: VAEConfig, p: Encoder, x: torch.Tensor, window_size: int = 16):
    """Temporal-chunked encode: an init window of window_size+1 frames, then
    cont windows."""
    t_down = 2 ** sum(cfg.encoder_temporal_down_sample)
    if window_size % t_down:
        raise ValueError(f"encode window_size={window_size} must be a multiple of the "
                         f"temporal downsample factor {t_down}")
    outs, cache, fid = [], None, 0
    for i, n in enumerate(_split_windows(x.shape[2], window_size)):
        m, cache = _enc_window(cfg, p, x[:, :, fid:fid + n], cache, "init" if i == 0 else "cont")
        outs.append(m)
        fid += n
    return torch.cat(outs, dim=2)


def chunk_decode(cfg: VAEConfig, p: Decoder, z: torch.Tensor, window_size: int = 2,
                 return_cache: bool = False):
    """Temporal-chunked decode: an init window, then cont windows."""
    outs, cache, fid = [], None, 0
    for i, n in enumerate(_split_windows(z.shape[2], window_size)):
        d, cache = _dec_window(cfg, p, z[:, :, fid:fid + n], cache, "init" if i == 0 else "cont")
        outs.append(d)
        fid += n
    out = torch.cat(outs, dim=2)
    return (out, cache) if return_cache else out


def chunk_decode_cont(cfg: VAEConfig, p: Decoder, z: torch.Tensor, cache,
                      window_size: int = 2, return_cache: bool = False):
    """Chunked decode continuing from a carried cache (all windows cont)."""
    outs = []
    for fid in range(0, z.shape[2], window_size):
        d, cache = _dec_window(cfg, p, z[:, :, fid:fid + window_size], cache, "cont")
        outs.append(d)
    out = torch.cat(outs, dim=2)
    return (out, cache) if return_cache else out


def vae_encode(cfg: VAEConfig, p, x: torch.Tensor, *, temporal_chunk: bool = False,
               window_size: int = 16, use_tiling: bool = False) -> torch.Tensor:
    """Encode pixels [b, 3, t, H, W] -> Gaussian moments [b, 2z, t', H/8, W/8]."""
    if use_tiling:
        raise NotImplementedError("use_tiling: spatial tiling is not ported yet")
    pe = getattr(p, "encoder", p)
    if temporal_chunk:
        return chunk_encode(cfg, pe, x, window_size)
    return _enc_window(cfg, pe, x, None, "full")[0]


def vae_decode(cfg: VAEConfig, p, z: torch.Tensor, *, temporal_chunk: bool = False,
               window_size: int = 2, use_tiling: bool = False) -> torch.Tensor:
    """Decode latents [b, z, t', h, w] -> pixels [b, 3, t, 8h, 8w]."""
    if use_tiling:
        raise NotImplementedError("use_tiling: spatial tiling is not ported yet")
    pd = getattr(p, "decoder", p)
    if temporal_chunk:
        return chunk_decode(cfg, pd, z, window_size)
    return _dec_window(cfg, pd, z, None, "full")[0]
