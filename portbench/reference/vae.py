"""DeepVerse's causal video VAE in plain PyTorch, with its temporal caches.

Every 3-D convolution is causal in time: two zero frames before the first
(``full`` and ``init``), or the last two input frames of the previous
window (``cont``; a temporally strided conv takes only the last one), or
its own first two frames (``prime``, which rebuilds a cache without
computing the frames before it). A window's output equals the
corresponding frames of one pass over the whole clip. Group norms take
statistics per frame; the bottleneck's mid block attends within each
frame. The decoder's last level (no sampler) can be primed: the caches a
streamed decode would hold after a clip are rebuilt from the clip's
trailing frames at that level (``prime_warm``), so decoding continues
after a chunk boundary without the overlap's pixels.

The streamed decode, its priming and the windowed encode follow the
rollout's schedule (a window of one latent frame per unit; encode windows
of 17 frames then 8), because the int8 arithmetic of the fast preset takes
one activation scale per convolution call.
"""

from __future__ import annotations

import math
from typing import Dict, List

import torch
import torch.nn.functional as F

from .numerics import Numerics


class VAE:
    """The VAE's float32 weights and its streamed encode and decode."""

    def __init__(self, cfg: Dict, params: Dict[str, torch.Tensor], num: Numerics):
        self.cfg = cfg
        self.p = {k: v.to(torch.float32) for k, v in params.items()}
        self.num = num

    # -- layers -------------------------------------------------------------

    def conv(self, name: str, x: torch.Tensor, cache, mode: str, stride=(1, 1, 1)):
        """(y, new cache) of the causal conv ``name`` in ``mode``."""
        w, b = self.p[name + ".weight"], self.p[name + ".bias"]
        kt = w.shape[2]
        if kt == 1 or mode == "full":
            xp = F.pad(x, (0, 0, 0, 0, kt - 1, 0)) if kt > 1 else x
            return self.num.conv3d(xp, w, b, stride), None
        if mode == "init":
            xp = F.pad(x, (0, 0, 0, 0, 2, 0))
        elif mode == "cont":
            ctx = cache if stride[0] == 1 else cache[:, :, -1:]
            xp = torch.cat([ctx, x], dim=2)
        elif mode == "prime":
            xp = x
        else:
            raise ValueError(f"unknown conv mode {mode!r}")
        return self.num.conv3d(xp, w, b, stride), xp[:, :, -2:]

    def group_norm(self, name: str, x: torch.Tensor, groups: int) -> torch.Tensor:
        b, c, t, h, w = x.shape
        xf = x.reshape(b, groups, c // groups, t, h * w)
        mean = xf.mean(dim=(2, 4), keepdim=True)
        var = (xf - mean).square().mean(dim=(2, 4), keepdim=True)
        xf = ((xf - mean) * torch.rsqrt(var + 1e-6)).reshape(b, c, t, h, w)
        shape = (1, c, 1, 1, 1)
        return xf * self.p[name + ".weight"].reshape(shape) + self.p[name + ".bias"].reshape(shape)

    def resnet(self, name, x, cache, mode, groups):
        cache = cache or {}
        h = F.silu(self.group_norm(f"{name}.norm1", x, groups))
        h, c1 = self.conv(f"{name}.conv1", h, cache.get("conv1"), mode)
        h = F.silu(self.group_norm(f"{name}.norm2", h, groups))
        h, c2 = self.conv(f"{name}.conv2", h, cache.get("conv2"), mode)
        if f"{name}.conv_shortcut.weight" in self.p:
            x, _ = self.conv(f"{name}.conv_shortcut", x, None, mode)
        if mode == "prime":
            x = x[:, :, x.shape[2] - h.shape[2]:]
        return x + h, {"conv1": c1, "conv2": c2}

    def attention(self, name, x, groups):
        """Single-head attention within each frame, with its residual."""
        b, c, t, h, w = x.shape
        x2 = x.transpose(1, 2).reshape(b * t, c, h * w)
        g = x2.reshape(b * t, groups, c // groups, h * w)
        mean = g.mean(dim=(2, 3), keepdim=True)
        var = (g - mean).square().mean(dim=(2, 3), keepdim=True)
        xn = ((g - mean) * torch.rsqrt(var + 1e-6)).reshape(b * t, c, h * w)
        xn = (xn * self.p[f"{name}.group_norm.weight"][:, None]
              + self.p[f"{name}.group_norm.bias"][:, None]).transpose(1, 2)
        lin = lambda k, v: self.num.linear(v, self.p[f"{name}.{k}.weight"], self.p[f"{name}.{k}.bias"])
        q, k, v = lin("to_q", xn), lin("to_k", xn), lin("to_v", xn)
        wts = torch.softmax(self.num.matmul(q, k.transpose(1, 2)) / math.sqrt(c), dim=-1)
        out = lin("to_out", self.num.matmul(wts, v)).transpose(1, 2) + x2
        return out.reshape(b, t, c, h, w).transpose(1, 2)

    def midblock(self, name, x, cache, mode, groups):
        cache = cache or {}
        x, c0 = self.resnet(f"{name}.resnets.0", x, cache.get(0), mode, groups)
        x = self.attention(f"{name}.attentions.0", x, groups)
        x, c1 = self.resnet(f"{name}.resnets.1", x, cache.get(1), mode, groups)
        return x, {0: c0, 1: c1}

    # -- encoder ----------------------------------------------------------------

    def encode_window(self, x: torch.Tensor, cache, mode: str):
        """Encoder and quant conv on one window: (moments, caches)."""
        v, cache = self.cfg, cache or {}
        g = v["encoder_norm_num_groups"]
        new = {}
        x, new["conv_in"] = self.conv("encoder.conv_in", x, cache.get("conv_in"), mode)
        for i in range(len(v["encoder_block_out_channels"])):
            pre = f"encoder.down_blocks.{i}"
            for j in range(v["encoder_layers_per_block"][i]):
                x, new[(i, j)] = self.resnet(f"{pre}.resnets.{j}", x, cache.get((i, j)), mode, g)
            if v["encoder_spatial_down_sample"][i]:
                x, new[(i, "s")] = self.conv(f"{pre}.downsampler", x, cache.get((i, "s")), mode,
                                             stride=(1, 2, 2))
            if v["encoder_temporal_down_sample"][i]:
                x, new[(i, "t")] = self.conv(f"{pre}.temporal_downsampler", x,
                                             cache.get((i, "t")), mode, stride=(2, 1, 1))
        x, new["mid"] = self.midblock("encoder.mid_block", x, cache.get("mid"), mode, g)
        x = F.silu(self.group_norm("encoder.conv_norm_out", x, g))
        x, new["conv_out"] = self.conv("encoder.conv_out", x, cache.get("conv_out"), mode)
        moments, _ = self.conv("encoder.quant_conv", x, None, mode)
        return moments, new

    def encode(self, x: torch.Tensor, window: int = 16) -> torch.Tensor:
        """Moments of pixels [1, 3, T, H, W]: one pass up to ``window + 1``
        frames, else windows of ``window + 1``, ``window``, ..., the rest."""
        x = x.to(torch.float32)
        if x.shape[2] <= window + 1:
            return self.encode_window(x, None, "full")[0]
        sizes, fid = [window + 1], window + 1
        while fid + window <= x.shape[2]:
            sizes.append(window)
            fid += window
        if fid < x.shape[2]:
            sizes.append(x.shape[2] - fid)
        outs, cache, fid = [], None, 0
        for i, n in enumerate(sizes):
            m, cache = self.encode_window(x[:, :, fid:fid + n], cache, "init" if i == 0 else "cont")
            outs.append(m)
            fid += n
        return torch.cat(outs, dim=2)

    # -- decoder ----------------------------------------------------------------

    def up_block(self, i, x, cache, mode):
        v, cache = self.cfg, cache or {}
        g = v["decoder_norm_num_groups"]
        pre = f"decoder.up_blocks.{i}"
        new = {}
        for j in range(v["decoder_layers_per_block"][i]):
            x, new[j] = self.resnet(f"{pre}.resnets.{j}", x, cache.get(j), mode, g)
        if v["decoder_spatial_up_sample"][i]:
            y, new["s"] = self.conv(f"{pre}.upsampler", x, cache.get("s"), mode)
            b, c4, t, h, w = y.shape
            y = y.reshape(b, c4 // 4, 2, 2, t, h, w).permute(0, 1, 4, 5, 2, 6, 3)
            x = y.reshape(b, c4 // 4, t, h * 2, w * 2)
        if v["decoder_temporal_up_sample"][i]:
            y, new["t"] = self.conv(f"{pre}.temporal_upsampler", x, cache.get("t"), mode)
            b, c2, t, h, w = y.shape
            x = y.reshape(b, c2 // 2, 2, t, h, w).transpose(2, 3).reshape(b, c2 // 2, t * 2, h, w)
            if mode in ("full", "init"):
                x = x[:, :, 1:]
        return x, new

    def decode_front(self, z, cache, mode):
        """post-quant conv, conv_in, the mid block and every up block but
        the last: (the last block's input, caches)."""
        cache = cache or {}
        g = self.cfg["decoder_norm_num_groups"]
        new = {}
        z, _ = self.conv("decoder.post_quant_conv", z, None, mode)
        x, new["conv_in"] = self.conv("decoder.conv_in", z, cache.get("conv_in"), mode)
        x, new["mid"] = self.midblock("decoder.mid_block", x, cache.get("mid"), mode, g)
        for i in range(len(self.cfg["decoder_block_out_channels"]) - 1):
            x, new[("up", i)] = self.up_block(i, x, cache.get(("up", i)), mode)
        return x, new

    def decode_window(self, z: torch.Tensor, cache, mode: str):
        """One window of latents -> (pixels, caches)."""
        x, new = self.decode_front(z.to(torch.float32), cache, mode)
        last = len(self.cfg["decoder_block_out_channels"]) - 1
        x, new[("up", last)] = self.up_block(last, x, (cache or {}).get(("up", last)), mode)
        x = F.silu(self.group_norm("decoder.conv_norm_out", x, self.cfg["decoder_norm_num_groups"]))
        x, new["conv_out"] = self.conv("decoder.conv_out", x, (cache or {}).get("conv_out"), mode)
        return x, new

    def prime_need(self) -> int:
        """Trailing frames of the last level's input that rebuild its caches."""
        return 4 * self.cfg["decoder_layers_per_block"][-1] + 2

    def prime_warm(self, z: torch.Tensor):
        """The caches a streamed decode of latents ``z`` would end with:
        each latent frame through the front in turn (init, then cont), the
        last level's trailing ``prime_need`` input frames kept, then the
        last level's resnets in prime mode and conv_out's cache from the
        last two normed frames."""
        v = self.cfg
        t_up = 2 ** sum(v["decoder_temporal_up_sample"])
        need, total = self.prime_need(), 1 + (z.shape[2] - 1) * t_up
        lo, pos, buf, cache = total - need, 0, [], None
        for fi in range(z.shape[2]):
            x, cache = self.decode_front(z[:, :, fi:fi + 1].to(torch.float32), cache,
                                         "init" if fi == 0 else "cont")
            end = pos + x.shape[2]
            if end > lo:
                buf.append(x if pos >= lo else x[:, :, lo - pos:])
            pos = end
        x = torch.cat(buf, dim=2)
        last = len(v["decoder_block_out_channels"]) - 1
        g = v["decoder_norm_num_groups"]
        res = {}
        for j in range(v["decoder_layers_per_block"][last]):
            x, res[j] = self.resnet(f"decoder.up_blocks.{last}.resnets.{j}", x, None, "prime", g)
        cache[("up", last)] = res
        cache["conv_out"] = F.silu(self.group_norm("decoder.conv_norm_out", x[:, :, -2:], g))
        return cache


class LatentCodec:
    """The rollout's arithmetic between latents and pixels: the latent
    normalisation (image statistics on a clip's first frame, video on the
    rest), the streamed decode of one unit a window, the primed boundary
    and the encoder's moments of the pixels a boundary encodes."""

    def __init__(self, vae: VAE, p: Dict, encode_window: int = 16):
        self.vae, self.p, self.encode_window = vae, p, encode_window

    def unnorm(self, lat: torch.Tensor, first_is_image: bool) -> torch.Tensor:
        p, lat = self.p, lat.to(torch.float32)
        video = lat / p["vae_video_scale_factor"] + p["vae_video_shift_factor"]
        if not first_is_image:
            return video
        first = lat[:, :, :1] / p["vae_scale_factor"] + p["vae_shift_factor"]
        return torch.cat([first, video[:, :, 1:]], dim=2)

    def decode_stream(self, conditioning: torch.Tensor, units: List[torch.Tensor],
                      first_chunk: bool, stream: int) -> List[torch.Tensor]:
        """The pixels of each unit's window for ``stream`` (0 rgb, 1
        disparity): a first chunk decodes its first unit in init mode with
        image statistics; a later chunk primes the caches from its
        conditioning latents and continues."""
        n = self.p["raymap_dim"]

        def part(lat):
            return lat[:, :-n].chunk(2, dim=1)[stream]

        cache, outs = None, []
        if not first_chunk:
            cache = self.vae.prime_warm(self.unnorm(part(conditioning), True))
        for i, u in enumerate(units):
            first = first_chunk and i == 0
            y, cache = self.vae.decode_window(self.unnorm(part(u), first), cache,
                                              "init" if first else "cont")
            outs.append(y)
        return outs

    def moments(self, x: torch.Tensor) -> torch.Tensor:
        """The posterior moments (mean and log-variance) of each batch row
        of pixels ``x``, encoded alone (in windows past 17 frames)."""
        return torch.cat([self.vae.encode(x[i:i + 1], self.encode_window)
                          for i in range(x.shape[0])], dim=0)
