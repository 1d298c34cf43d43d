"""Causal video VAE with explicit temporal caches.

Counterpart of ``deepv_tpu/models/vae.py``: an 8x spatial and 8x temporal
compressing KL autoencoder (57 pixel frames <-> 8 latent frames) built from
causal 3D convolutions. Chunked encode/decode thread the conv caches as
nested dicts, so chunked == full exactly, and the decoder's chunk-boundary
priming rebuilds the last block's caches from the trailing frames it needs.
Spatial tiling (``use_tiling``) bounds the activations of a large plane:
overlapping tiles, blended at the seams.

Context parallelism (``parallel/cp.py``): every function from the resnet up
takes ``cp_group`` (x is this rank's slice of the height) and ``tp_group``
(this rank's slice of time), passed down to every conv
(``ops/causal_conv.py``). Under ``cp_group`` the group norms sum their
statistics over the group and the mid block's attention gathers the rows.

``VAE`` is an ``nn.Module`` named as deepv_tpu's parameter tree
(``encoder.down_blocks.0.resnets.0.conv1.weight``, ...), built on the
``meta`` device and loaded by ``io/weights.params_from_numpy``.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.distributed as dist
from torch import nn

from ..config import VAEConfig
from ..ops.basic import compute_dtype, exp_f32, group_norm, linear, silu
from ..ops.causal_conv import causal_conv3d
from ..parallel import comm


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

def causal_group_norm(x: torch.Tensor, num_groups: int, p, cp_group=None) -> torch.Tensor:
    """GroupNorm per frame: statistics never cross the time axis.

    Under ``cp_group`` the statistics are the whole height's: deepv_tpu's
    formula, the sum and the sum of squares in at-least-f32 summed over the
    group (one ``all_reduce``), then ``var = E[x^2] - mean^2``, eps 1e-6."""
    b, c, t, h, w = x.shape
    g, ct = num_groups, compute_dtype(x.dtype)
    if cp_group is None:
        # the statistics of each (sample, group, frame) reduce over a view
        # of x whose strides do not depend on b, so a batch of streams
        # normalises each stream as it would alone
        xf = x.to(ct).reshape(b, g, c // g, t, h * w)
        mean = xf.mean(dim=(2, 4), keepdim=True)
        var = (xf - mean).square().mean(dim=(2, 4), keepdim=True)
        xf = ((xf - mean) * torch.rsqrt(var + 1e-6)).reshape(b, c, t, h, w)
        shape = (1, c, 1, 1, 1)
        out = xf * p.weight.to(ct).reshape(shape) + p.bias.to(ct).reshape(shape)
        return out.to(x.dtype)
    xf = x.to(ct).transpose(1, 2).reshape(b * t, g, c // g, h * w)
    sums = comm.all_reduce(torch.stack([xf.sum(dim=(2, 3)), xf.square().sum(dim=(2, 3))]),
                           cp_group)
    n = (c // g) * h * w * dist.get_world_size(cp_group)
    mean = (sums[0] / n)[:, :, None, None]
    var = (sums[1] / n)[:, :, None, None] - mean.square()
    xf = ((xf - mean) * torch.rsqrt(var + 1e-6)).reshape(b * t, c, h, w)
    out = xf * p.weight.to(ct).reshape(1, c, 1, 1) + p.bias.to(ct).reshape(1, c, 1, 1)
    return out.to(x.dtype).reshape(b, t, c, h, w).transpose(1, 2)


def resnet_apply(p: _Resnet, x: torch.Tensor, cache, mode: str, groups: int,
                 impl: str = "xla", cp_group=None, tp_group=None):
    """CausalResnetBlock3D; ``impl`` routes conv1/conv2, not the shortcut."""
    par = dict(cp_group=cp_group, tp_group=tp_group)
    h = silu(causal_group_norm(x, groups, p.norm1, cp_group))
    h, c1 = causal_conv3d(h, p.conv1, _get(cache, "conv1"), mode=mode, impl=impl, **par)
    h = silu(causal_group_norm(h, groups, p.norm2, cp_group))
    h, c2 = causal_conv3d(h, p.conv2, _get(cache, "conv2"), mode=mode, impl=impl, **par)
    if hasattr(p, "conv_shortcut"):
        x, _ = causal_conv3d(x, p.conv_shortcut, None, mode=mode, cp_group=cp_group)
    if mode == "prime":
        # each prime-mode conv consumed kt-1 leading context frames: align
        # the residual with the main path's (4 frames shorter) trailing frames
        x = x[:, :, x.shape[2] - h.shape[2]:]
    return x + h, {"conv1": c1, "conv2": c2}


def attn2d_apply(p: _Attn2d, x: torch.Tensor, groups: int, cp_group=None) -> torch.Tensor:
    """Per-frame single-head spatial self-attention with residual: group
    norm -> qkv -> f32 softmax -> out proj -> + residual (plain matmuls).
    Under ``cp_group`` (at the bottleneck's resolution) the rows are
    gathered, attended whole, and this rank's slice kept."""
    if cp_group is not None:
        h_local = x.shape[3]
        y = attn2d_apply(p, comm.all_gather(x, 3, cp_group), groups)
        return y.narrow(3, dist.get_rank(cp_group) * h_local, h_local)
    b, c, t, h, w = x.shape
    # frames laid out alike at any b (a view at b = 1 would not be), so a
    # batch of streams attends each stream as it would alone
    x2 = x.transpose(1, 2).contiguous().reshape(b * t, c, h * w)
    xn = group_norm(x2, groups, p.group_norm.weight, p.group_norm.bias).transpose(1, 2)
    q, k, v = linear(xn, p.to_q), linear(xn, p.to_k), linear(xn, p.to_v)
    ct = compute_dtype(x.dtype)
    logits = torch.matmul(q.to(ct), k.to(ct).transpose(1, 2)) * (1.0 / math.sqrt(c))
    weights = torch.softmax(logits, dim=-1).to(v.dtype)
    out = torch.matmul(weights.to(ct), v.to(ct)).to(v.dtype)
    out = linear(out, p.to_out).transpose(1, 2) + x2
    return out.reshape(b, t, c, h, w).transpose(1, 2)


def midblock_apply(p: _MidBlock, x: torch.Tensor, cache, mode: str, groups: int,
                   impl: str = "xla", cp_group=None, tp_group=None):
    """CausalUNetMidBlock2D: resnet, then (attn, resnet) pairs."""
    par = dict(cp_group=cp_group, tp_group=tp_group)
    res_cache = _get(cache, "resnets")
    x, c0 = resnet_apply(p.resnets[0], x, _idx(res_cache, 0), mode, groups, impl, **par)
    caches = [c0]
    for i, attn in enumerate(p.attentions):
        x = attn2d_apply(attn, x, groups, cp_group)
        x, ci = resnet_apply(p.resnets[i + 1], x, _idx(res_cache, i + 1), mode, groups, impl,
                             **par)
        caches.append(ci)
    return x, {"resnets": caches}


def spatial_down_apply(p, x, cache, mode: str, cp_group=None, tp_group=None):
    """CausalDownsample2x: causal conv with stride (1, 2, 2)."""
    return causal_conv3d(x, p, cache, mode=mode, stride=(1, 2, 2), cp_group=cp_group,
                         tp_group=tp_group)


def temporal_down_apply(p, x, cache, mode: str, cp_group=None, tp_group=None):
    """CausalTemporalDownsample2x: causal conv with stride (2, 1, 1)."""
    return causal_conv3d(x, p, cache, mode=mode, stride=(2, 1, 1), cp_group=cp_group,
                         tp_group=tp_group)


def spatial_up_apply(p, x, cache, mode: str, impl: str = "xla", cp_group=None,
                     tp_group=None):
    """CausalUpsample2x: conv to 4c then a 2x2 pixel shuffle."""
    y, c = causal_conv3d(x, p, cache, mode=mode, impl=impl, cp_group=cp_group,
                         tp_group=tp_group)
    b, c4, t, h, w = y.shape
    y = y.reshape(b, c4 // 4, 2, 2, t, h, w).permute(0, 1, 4, 5, 2, 6, 3)
    return y.reshape(b, c4 // 4, t, h * 2, w * 2), c


def temporal_up_apply(p, x, cache, mode: str, impl: str = "xla", cp_group=None,
                      tp_group=None):
    """CausalTemporalUpsample2x: conv to 2c, temporal unshuffle, and in
    full/init mode drop the duplicated first frame."""
    y, c = causal_conv3d(x, p, cache, mode=mode, impl=impl, cp_group=cp_group,
                         tp_group=tp_group)
    b, c2, t, h, w = y.shape
    y = y.reshape(b, c2 // 2, 2, t, h, w).transpose(2, 3).reshape(b, c2 // 2, t * 2, h, w)
    if mode in ("full", "init"):
        y = y[:, :, 1:]
    return y, c


# ---------------------------------------------------------------------------
# encoder / decoder
# ---------------------------------------------------------------------------

def encoder_apply(cfg: VAEConfig, p: Encoder, x: torch.Tensor, cache=None,
                  mode: str = "full", cp_group=None, tp_group=None):
    """Encoder + quant conv -> Gaussian moments, and the new caches."""
    groups, impl = cfg.encoder_norm_num_groups, cfg.conv_impl
    par = dict(cp_group=cp_group, tp_group=tp_group)
    caches = {}
    x, caches["conv_in"] = causal_conv3d(x, p.conv_in, _get(cache, "conv_in"), mode=mode,
                                         impl=impl, **par)
    block_caches = []
    for i, bp in enumerate(p.down_blocks):
        bc = _idx(_get(cache, "down_blocks"), i)
        rcaches = []
        for j, rp in enumerate(bp.resnets):
            x, rc = resnet_apply(rp, x, _idx(_get(bc, "resnets"), j), mode, groups, impl,
                                 **par)
            rcaches.append(rc)
        out = {"resnets": rcaches}
        if cfg.encoder_spatial_down_sample[i]:
            x, out["downsampler"] = spatial_down_apply(bp.downsampler, x,
                                                       _get(bc, "downsampler"), mode, **par)
        if cfg.encoder_temporal_down_sample[i]:
            x, out["temporal_downsampler"] = temporal_down_apply(
                bp.temporal_downsampler, x, _get(bc, "temporal_downsampler"), mode, **par)
        block_caches.append(out)
    caches["down_blocks"] = block_caches
    x, caches["mid_block"] = midblock_apply(p.mid_block, x, _get(cache, "mid_block"),
                                            mode, groups, impl, **par)
    x = silu(causal_group_norm(x, groups, p.conv_norm_out, cp_group))
    x, caches["conv_out"] = causal_conv3d(x, p.conv_out, _get(cache, "conv_out"), mode=mode,
                                          impl=impl, **par)
    moments, _ = causal_conv3d(x, p.quant_conv, None, mode=mode, cp_group=cp_group)
    return moments, caches


def _up_block(cfg: VAEConfig, i: int, bp: _Block, x: torch.Tensor, bc, mode: str,
              cp_group=None, tp_group=None):
    groups, impl = cfg.decoder_norm_num_groups, cfg.conv_impl
    par = dict(cp_group=cp_group, tp_group=tp_group)
    rcaches = []
    for j, rp in enumerate(bp.resnets):
        x, rc = resnet_apply(rp, x, _idx(_get(bc, "resnets"), j), mode, groups, impl, **par)
        rcaches.append(rc)
    out = {"resnets": rcaches}
    if cfg.decoder_spatial_up_sample[i]:
        x, out["upsampler"] = spatial_up_apply(bp.upsampler, x, _get(bc, "upsampler"), mode,
                                               impl, **par)
    if cfg.decoder_temporal_up_sample[i]:
        x, out["temporal_upsampler"] = temporal_up_apply(
            bp.temporal_upsampler, x, _get(bc, "temporal_upsampler"), mode, impl, **par)
    return x, out


def decoder_front(cfg: VAEConfig, p: Decoder, z: torch.Tensor, cache=None,
                  mode: str = "full", cp_group=None, tp_group=None):
    """post-quant conv + conv_in + mid block + every up block but the last.
    Returns the last block's input stream and the partial caches."""
    groups, impl = cfg.decoder_norm_num_groups, cfg.conv_impl
    par = dict(cp_group=cp_group, tp_group=tp_group)
    caches = {}
    z, _ = causal_conv3d(z, p.post_quant_conv, None, mode=mode, cp_group=cp_group)
    x, caches["conv_in"] = causal_conv3d(z, p.conv_in, _get(cache, "conv_in"), mode=mode,
                                         impl=impl, **par)
    x, caches["mid_block"] = midblock_apply(p.mid_block, x, _get(cache, "mid_block"),
                                            mode, groups, impl, **par)
    block_caches = []
    for i in range(len(p.up_blocks) - 1):
        x, out = _up_block(cfg, i, p.up_blocks[i], x,
                           _idx(_get(cache, "up_blocks"), i), mode, **par)
        block_caches.append(out)
    caches["up_blocks"] = block_caches
    return x, caches


def decoder_tail(cfg: VAEConfig, p: Decoder, x: torch.Tensor, cache=None,
                 mode: str = "full", cp_group=None, tp_group=None):
    """The last up block + conv_norm_out + conv_out; ``cache`` is the full
    decoder cache dict. Returns (pixels, partial caches)."""
    par = dict(cp_group=cp_group, tp_group=tp_group)
    i = len(p.up_blocks) - 1
    x, out = _up_block(cfg, i, p.up_blocks[i], x, _idx(_get(cache, "up_blocks"), i), mode,
                       **par)
    caches = {"up_blocks_last": out}
    x = silu(causal_group_norm(x, cfg.decoder_norm_num_groups, p.conv_norm_out, cp_group))
    x, caches["conv_out"] = causal_conv3d(x, p.conv_out, _get(cache, "conv_out"), mode=mode,
                                          impl=cfg.conv_impl, **par)
    return x, caches


def decoder_apply(cfg: VAEConfig, p: Decoder, z: torch.Tensor, cache=None,
                  mode: str = "full", cp_group=None, tp_group=None):
    """post-quant conv + decoder -> pixels, and the new caches."""
    x, caches = decoder_front(cfg, p, z, cache, mode, cp_group, tp_group)
    x, tail = decoder_tail(cfg, p, x, cache, mode, cp_group, tp_group)
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
        x, rc = resnet_apply(rp, x, None, "prime", groups, cfg.conv_impl)
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


def _enc_window(cfg: VAEConfig, p: Encoder, x, cache, mode: str, cp_group=None,
                tp_group=None):
    return encoder_apply(cfg, p, x, cache, mode, cp_group, tp_group)


def _dec_window(cfg: VAEConfig, p: Decoder, z, cache, mode: str, cp_group=None,
                tp_group=None):
    return decoder_apply(cfg, p, z, cache, mode, cp_group, tp_group)


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


def _blend_v(a: torch.Tensor, b: torch.Tensor, extent: int) -> torch.Tensor:
    """Blend the top rows of tile b into the bottom rows of tile a above it,
    weights ``arange(extent) / extent`` made in float32 and cast to the
    tiles' dtype."""
    extent = min(a.shape[3], b.shape[3], extent)
    w = (torch.arange(extent, dtype=torch.float32, device=b.device) / extent).to(a.dtype)
    w = w.reshape(1, 1, 1, extent, 1)
    seam = a[:, :, :, -extent:, :] * (1 - w) + b[:, :, :, :extent, :] * w
    return torch.cat([seam, b[:, :, :, extent:, :]], dim=3)


def _blend_h(a: torch.Tensor, b: torch.Tensor, extent: int) -> torch.Tensor:
    """``_blend_v`` along the width: tile b's left columns into tile a's
    right ones."""
    extent = min(a.shape[4], b.shape[4], extent)
    w = (torch.arange(extent, dtype=torch.float32, device=b.device) / extent).to(a.dtype)
    w = w.reshape(1, 1, 1, 1, extent)
    seam = a[:, :, :, :, -extent:] * (1 - w) + b[:, :, :, :, :extent] * w
    return torch.cat([seam, b[:, :, :, :, extent:]], dim=4)


def _tiled(x: torch.Tensor, core, in_unit: int, out_unit: int,
           overlap_factor: float) -> torch.Tensor:
    """Spatial tiling: ``core`` on overlapping ``in_unit`` tiles of x's
    plane (stride ``in_unit * (1 - overlap_factor)``), the seams blended
    over ``out_unit * overlap_factor`` output rows and columns, each tile
    cropped to the stride in output units."""
    overlap = int(in_unit * (1 - overlap_factor))
    blend = int(out_unit * overlap_factor)
    row_limit = out_unit - blend
    rows = []
    for i in range(0, x.shape[3], overlap):
        rows.append([core(x[:, :, :, i:i + in_unit, j:j + in_unit])
                     for j in range(0, x.shape[4], overlap)])
    result_rows = []
    for i, row in enumerate(rows):
        result = []
        for j, tile in enumerate(row):
            if i > 0:
                tile = _blend_v(rows[i - 1][j], tile, blend)
            if j > 0:
                tile = _blend_h(row[j - 1], tile, blend)
            result.append(tile[:, :, :, :row_limit, :row_limit])
        result_rows.append(torch.cat(result, dim=4))
    return torch.cat(result_rows, dim=3)


def vae_encode(cfg: VAEConfig, p, x: torch.Tensor, *, temporal_chunk: bool = False,
               window_size: int = 16, use_tiling: bool = False,
               tile_sample_min_size: int = 256) -> torch.Tensor:
    """Encode pixels [b, 3, t, H, W] -> Gaussian moments [b, 2z, t', H/8, W/8].
    ``use_tiling`` encodes a plane larger than ``tile_sample_min_size``
    pixels tile by tile (``_tiled``), each tile temporally chunked when
    ``temporal_chunk``."""
    pe = getattr(p, "encoder", p)
    if use_tiling and (x.shape[-1] > tile_sample_min_size
                       or x.shape[-2] > tile_sample_min_size):
        if temporal_chunk:
            core = lambda t: chunk_encode(cfg, pe, t, window_size)
        else:
            core = lambda t: _enc_window(cfg, pe, t, None, "full")[0]
        return _tiled(x, core, tile_sample_min_size,
                      tile_sample_min_size // cfg.downsample_scale, 0.25)
    if temporal_chunk:
        return chunk_encode(cfg, pe, x, window_size)
    return _enc_window(cfg, pe, x, None, "full")[0]


def vae_decode(cfg: VAEConfig, p, z: torch.Tensor, *, temporal_chunk: bool = False,
               window_size: int = 2, use_tiling: bool = False,
               tile_sample_min_size: int = 256) -> torch.Tensor:
    """Decode latents [b, z, t', h, w] -> pixels [b, 3, t, 8h, 8w].
    ``use_tiling`` decodes a plane larger than ``tile_sample_min_size``
    pixels (``tile_sample_min_size / 8`` latents) tile by tile."""
    pd = getattr(p, "decoder", p)
    tile_latent_min_size = tile_sample_min_size // cfg.downsample_scale
    if use_tiling and (z.shape[-1] > tile_latent_min_size
                       or z.shape[-2] > tile_latent_min_size):
        if temporal_chunk:
            core = lambda t: chunk_decode(cfg, pd, t, window_size)
        else:
            core = lambda t: _dec_window(cfg, pd, t, None, "full")[0]
        return _tiled(z, core, tile_latent_min_size, tile_sample_min_size, 0.25)
    if temporal_chunk:
        return chunk_decode(cfg, pd, z, window_size)
    return _dec_window(cfg, pd, z, None, "full")[0]
