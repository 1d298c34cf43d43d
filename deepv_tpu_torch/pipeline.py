"""Chunked autoregressive world-model rollout.

Counterpart of ``deepv_tpu/pipeline.py`` on its exact default path: one
conditioning image plus per-unit motion prompts rolls out RGB + disparity +
raymap video in 57-frame chunks with a 25-frame overlap. Each latent unit is
denoised by 3 pyramid stages x 5 Euler steps, each step one MMDiT forward
over 2 CFG rows (3 once history has been retrieved). Units are decoded as
they finish through the causal VAE's carried caches; at a chunk boundary the
decoder caches are primed exactly from the carried latents, the overlap
pixels are re-encoded, and a history frame is retrieved by camera nearness.

Every Gaussian draw goes through one noise source (``TorchNoise`` by
default, a seeded ``torch.Generator`` on the pipeline's device): the initial
latents, the iid ``z`` behind each inter-stage block noise and the VAE
posterior's eps. Options of deepv_tpu that are not ported yet raise
NotImplementedError naming their ROADMAP item.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .config import MMDiTConfig, PipelineConfig, VAEConfig
from .io.weights import params_from_numpy
from .models.mmdit import MMDiT, mmdit_forward
from .models.scheduler import FlowMatchSchedule, euler_step
from .models.vae import (VAE, _dec_prime_warm, _dec_window, chunk_decode_cont,
                         decoder_prime_need, gaussian_sample, vae_decode, vae_encode)
from .ops.basic import fma_f32
from .ops.block_noise import block_noise_from_z, block_noise_shape
from .ops.resample import down2x_bilinear, up2x_nearest
from .raymap import raymap_from_camera_batch, raymap_to_camera
from .utils.profiling import PhaseTimer


# ---------------------------------------------------------------------------
# noise
# ---------------------------------------------------------------------------

class TorchNoise:
    """The rollout's Gaussian draws from one seeded ``torch.Generator``.
    ``kind`` is "latents", "block" (the iid z of block noise) or
    "posterior" (the VAE's eps); this source draws all kinds alike."""

    def __init__(self, seed: int, device):
        self.device = torch.device(device)
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(seed)

    def normal(self, kind: str, shape, dtype) -> torch.Tensor:
        return torch.randn(tuple(shape), generator=self.generator, device=self.device,
                           dtype=dtype)


# ---------------------------------------------------------------------------
# stage loop and helpers
# ---------------------------------------------------------------------------

def _promote(a: torch.Tensor, b: torch.Tensor) -> torch.dtype:
    """The JAX result type of a binary op on two arrays (torch lets a 0-dim
    tensor take the other operand's type instead)."""
    return torch.promote_types(a.dtype, b.dtype)


def _zero_depth_channels(x: torch.Tensor) -> torch.Tensor:
    """no_need_depth: zero the disparity and raymap channels."""
    x = x.clone()
    x[:, 16:] = 0.0
    return x


def _stage_scan(model: MMDiT, conditions, frame_times, frame_valid,
                latents: torch.Tensor, text_embeds, text_mask, pooled,
                timesteps: torch.Tensor, dsigmas: torch.Tensor,
                guidance: float, history_scale: float, history, history_mask,
                num_rows: int, history_downsample_ratio: int,
                zero_depth: bool) -> torch.Tensor:
    """All Euler steps of one pyramid stage: per step, one MMDiT forward
    over the CFG rows, the guidance combine in at-least-f32, and an f32
    Euler update."""
    conds = [_zero_depth_channels(c) for c in conditions] if zero_depth else list(conditions)
    ct = torch.promote_types(latents.dtype, torch.float32)
    lat = latents
    for t, dsig in zip(timesteps, dsigmas):
        model_in = torch.cat([lat] * num_rows, dim=0)
        if zero_depth:
            model_in = _zero_depth_channels(model_in)
        v = mmdit_forward(model, conds + [model_in], text_embeds, text_mask, pooled,
                          t.to(torch.float32).expand(num_rows),
                          history=history, history_mask=history_mask,
                          history_downsample_ratio=history_downsample_ratio,
                          frame_times=list(frame_times), frame_valid=list(frame_valid),
                          split_last_attn=True)
        vu, vt = v[0:1], v[1:2]
        g = torch.tensor(guidance, dtype=torch.float32, device=v.device).to(ct)
        guided = vu.to(ct) + g * (vt - vu).to(ct)
        if num_rows == 3:
            hs = torch.tensor(history_scale, dtype=torch.float32, device=v.device).to(ct)
            guided = guided + hs * (v[2:3] - vt).to(ct)
        lat = euler_step(lat, guided.to(lat.dtype), dsig)
    return lat


def _renoise(latents: torch.Tensor, z: torch.Tensor, alpha: float, beta: float,
             gamma: float) -> torch.Tensor:
    """Inter-stage nearest-2x upsample + correlated block-noise renoising,
    in float32; ``z`` is the iid draw behind the block noise."""
    up = up2x_nearest(latents)
    noise = block_noise_from_z(z, gamma, dtype=torch.float32)
    a = torch.tensor(alpha, dtype=torch.float32, device=up.device)
    b = torch.tensor(beta, dtype=torch.float32, device=up.device)
    return fma_f32(a, up, b * noise).to(latents.dtype)


def _quantize_roundtrip(x: torch.Tensor) -> torch.Tensor:
    """uint8 round trip of the carry-over frames (the reference converts
    them through PIL)."""
    q = torch.round((x * 0.5 + 0.5).clamp(0.0, 1.0) * 255.0) / 255.0
    return (q * 2.0 - 1.0).to(x.dtype)


def _disparity_postmap(raw: torch.Tensor, scale_factor: torch.Tensor) -> torch.Tensor:
    """Decoded disparity -> displayable disparity: channel mean to [0, 1],
    squared, un-rescaled."""
    d = (raw.mean(dim=1, keepdim=True) * 0.5 + 0.5).clamp(0, 1)
    d = d.to(_promote(d, scale_factor))
    return d.repeat_interleave(3, dim=1) ** 2 / scale_factor / 0.95


def _pyramid_list(x: torch.Tensor, stage_num: int) -> List[torch.Tensor]:
    """Clean-latent pyramid, low -> high resolution."""
    levels = [x]
    for _ in range(stage_num):
        b, c, t, h, w = x.shape
        x = down2x_bilinear(x.reshape(b, c * t, h, w)).reshape(b, c, t, h // 2, w // 2)
        levels.append(x)
    return list(reversed(levels))


def padded_conditions(cfg: PipelineConfig, clean: List[torch.Tensor],
                      unit_index: int, firstframe_mask: bool, num_rows: int):
    """Shape-stable past-condition pyramid. Per stage s:
      s = 0, 1: [old@stage0 (u-1-fm frames), last@s, current]
      s = 2:    [old@stage0 (u-2-fm frames), mid@stage1, last@s, current]
    The old clip is padded to ``max_temporal_length - 2`` frames and the mid
    slot is always present, with per-frame times and validity masking the
    padding. Returns per stage (clips, frame times, frame valid)."""
    u, fm = unit_index, int(firstframe_mask)
    t_old = cfg.max_temporal_length - 2
    L = clean[0].shape[2]
    dev = clean[0].device

    def tile(x):
        return torch.cat([x] * num_rows, dim=0) if num_rows > 1 else x

    def vec(values, dtype):
        return torch.tensor(values, dtype=dtype, device=dev)

    def pad_old(n_real: int):
        b, c, _, h, w = clean[0].shape
        container = clean[0].new_zeros((b, c, t_old, h, w))
        if n_real > 0:
            container[:, :, t_old - n_real:] = clean[0][:, :, fm:fm + n_real]
        ar = torch.arange(t_old, device=dev)
        times = ar.to(torch.float32) - (t_old - n_real)
        valid = (ar >= (t_old - n_real)).to(torch.int32)
        return tile(container), times, valid

    out = []
    n_stages = len(cfg.stages)
    for i_s in range(n_stages):
        last = tile(clean[i_s][:, :, L - 1:L])
        if i_s < n_stages - 1:
            n_old = max(u - 1 - fm, 0)
            old, ot, ov = pad_old(n_old)
            clips = [old, last]
            times = [ot, vec([float(n_old)], torch.float32)]
            valid = [ov, vec([1], torch.int32)]
            cur_time = float(n_old + 1)
        else:
            mid_valid = 1 if (u - fm) >= 2 else 0
            n_old = max(u - 2 - fm, 0)
            old, ot, ov = pad_old(n_old)
            if mid_valid:
                mid = tile(clean[i_s - 1][:, :, L - 2:L - 1])
            else:
                mid = tile(torch.zeros_like(clean[i_s - 1][:, :, :1]))
            clips = [old, mid, last]
            times = [ot, vec([float(n_old)], torch.float32),
                     vec([float(n_old + mid_valid)], torch.float32)]
            valid = [ov, vec([mid_valid], torch.int32), vec([1], torch.int32)]
            cur_time = float(n_old + mid_valid + 1)
        times.append(vec([cur_time], torch.float32))
        valid.append(vec([1], torch.int32))
        out.append((tuple(clips), tuple(times), tuple(valid)))
    return out


def _not_ported(option: str, item: str):
    raise NotImplementedError(f"{option}: not ported yet (ROADMAP {item})")


# ---------------------------------------------------------------------------
# pipeline
# ---------------------------------------------------------------------------

class InferencePipeline:
    """DeepVerse rollout over the port's modules.

    ``params``: ``{"mmdit": tree, "vae": tree}`` in deepv_tpu's layout, with
    numpy or tensor leaves (``io/weights.random_params`` builds one on the
    card); they are loaded onto ``device`` in their own dtype.
    ``text_embeds`` maps a motion sentence to {"prompt_embeds" [1, 77, Dt],
    "prompt_attention_mask" [1, 77], "pooled_prompt_embeds" [1, Dp]}; the
    negative prompt is ``'empty'``."""

    def __init__(self, cfg: PipelineConfig, mmdit_cfg: MMDiTConfig,
                 vae_cfg: VAEConfig, params: Dict, text_embeds: Dict,
                 dtype=torch.bfloat16, device="cuda", use_tiling: bool = False,
                 decode_window: int = 2, stream_decode: bool = True, text_encoder=None,
                 flow_cache: str = "none", mesh=None,
                 reuse_decoder_cache: bool = False, denoise_int8: bool = False,
                 prime_decoder_cache: bool = True, carry_latents: bool = False,
                 encode_window: int = 16):
        if flow_cache != "none":
            _not_ported(f"flow_cache={flow_cache!r}", "M12 flow caching")
        if reuse_decoder_cache:
            _not_ported("reuse_decoder_cache", "M13 boundary fast modes")
        if carry_latents:
            _not_ported("carry_latents", "M13 boundary fast modes")
        if denoise_int8:
            _not_ported("denoise_int8", "M14 int8 paths")
        if vae_cfg.conv_impl == "int8":
            _not_ported("conv_impl='int8'", "M14 int8 paths")
        if text_encoder is not None:
            _not_ported("text_encoder", "M15 text encoders")
        if mesh is not None:
            _not_ported("mesh", "M17 parallelism")
        if use_tiling:
            _not_ported("use_tiling", "M17 parallelism (spatial tiling)")
        self.cfg = cfg
        self.mcfg = mmdit_cfg
        self.vcfg = vae_cfg
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("device='cuda' but no CUDA device is available; "
                               "pass device='cpu' to run on the CPU")
        self.dtype = dtype
        self.mmdit = params_from_numpy(MMDiT(mmdit_cfg), params["mmdit"], self.device)
        self.vae = params_from_numpy(VAE(vae_cfg), params["vae"], self.device)
        self.text_embeds = text_embeds
        self.decode_window = decode_window
        self.encode_window = encode_window
        #: decode each unit's latent as soon as it is denoised (exact: the
        #: causal VAE's chunked decode equals the full decode)
        self.stream_decode = stream_decode
        #: exact chunk-boundary cache priming: rebuild the decoder caches the
        #: overlap re-decode exists to produce without computing its pixels
        self._prime_need = None
        if prime_decoder_cache:
            need = decoder_prime_need(vae_cfg)
            if need is not None and self.vae.decoder.conv_out.weight.shape[2] == 3:
                self._prime_need = need
        self._embed_memo: Dict[str, Tuple] = {}
        self.schedule = FlowMatchSchedule(cfg.scheduler)
        self.timer = PhaseTimer(sync=False, device=self.device)
        self.raymap_mean = torch.tensor(cfg.raymap_mean, dtype=torch.float32,
                                        device=self.device).reshape(1, 6, 1, 1, 1)
        self.raymap_std = torch.tensor(cfg.raymap_std, dtype=torch.float32,
                                       device=self.device).reshape(1, 6, 1, 1, 1)

    # -- helpers ------------------------------------------------------------

    def _embeds_for(self, prompt: str):
        cached = self._embed_memo.get(prompt)
        if cached is not None:
            return cached
        if prompt not in self.text_embeds:
            raise KeyError(f"prompt {prompt!r} not in the precomputed text-embedding cache")
        e = self.text_embeds[prompt]
        out = (torch.as_tensor(np.asarray(e["prompt_embeds"]), device=self.device).to(self.dtype),
               torch.as_tensor(np.asarray(e["prompt_attention_mask"]),
                               device=self.device).to(torch.int32),
               torch.as_tensor(np.asarray(e["pooled_prompt_embeds"]),
                               device=self.device).to(self.dtype))
        self._embed_memo[prompt] = out
        return out

    def _norm_image_latent(self, lat: torch.Tensor) -> torch.Tensor:
        """First latent frame uses image stats, the rest video stats."""
        c = self.cfg
        first = (lat[:, :, :1] - c.vae_shift_factor) * c.vae_scale_factor
        if lat.shape[2] == 1:
            return first
        rest = (lat[:, :, 1:] - c.vae_video_shift_factor) * c.vae_video_scale_factor
        return torch.cat([first, rest], dim=2)

    def _encode_pixels(self, x: torch.Tensor, noise) -> torch.Tensor:
        """Encode each batch row (serially, temporally chunked past 17
        frames), then sample the posterior once for all rows."""
        chunked = x.shape[2] > 17
        parts = [vae_encode(self.vcfg, self.vae, x[i:i + 1].to(self.dtype),
                            temporal_chunk=chunked, window_size=self.encode_window)
                 for i in range(x.shape[0])]
        moments = torch.cat(parts, dim=0)
        mean_shape = (moments.shape[0], moments.shape[1] // 2) + tuple(moments.shape[2:])
        return gaussian_sample(moments, noise.normal("posterior", mean_shape, moments.dtype))

    def _stream_push(self, z: torch.Tensor, cache, first: bool):
        """Decode one latent window through a carried decoder cache; the very
        first window's leading frame uses image stats."""
        c = self.cfg
        if first:
            z0 = z[:, :, :1] / c.vae_scale_factor + c.vae_shift_factor
            if z.shape[2] > 1:
                rest = z[:, :, 1:] / c.vae_video_scale_factor + c.vae_video_shift_factor
                z = torch.cat([z0, rest], dim=2)
            else:
                z = z0
            mode = "init"
        else:
            z = z / c.vae_video_scale_factor + c.vae_video_shift_factor
            mode = "cont"
        return _dec_window(self.vcfg, self.vae.decoder, z.to(self.dtype), cache, mode)

    def _unnorm_latents(self, lat: torch.Tensor) -> torch.Tensor:
        """Image stats on the first frame, video stats on the rest."""
        c = self.cfg
        if lat.shape[2] == 1:
            return lat / c.vae_scale_factor + c.vae_shift_factor
        first = lat[:, :, :1] / c.vae_scale_factor + c.vae_shift_factor
        rest = lat[:, :, 1:] / c.vae_video_scale_factor + c.vae_video_shift_factor
        return torch.cat([first, rest], dim=2)

    def _prime_warm(self, lat38: torch.Tensor):
        """Primed (rgb, disparity) decoder caches for the boundary carry
        latents; replaces the full overlap re-decode exactly."""
        li, ld = lat38[:, :-self.cfg.raymap_dim].chunk(2, dim=1)
        return tuple(_dec_prime_warm(self.vcfg, self.vae.decoder,
                                     self._unnorm_latents(x).to(self.dtype)) for x in (li, ld))

    def _prime_eligible(self, lat38: torch.Tensor) -> bool:
        """Priming needs the warm stream to cover the tail's trailing window."""
        if self._prime_need is None:
            return False
        t_up = 2 ** sum(self.vcfg.decoder_temporal_up_sample)
        return 1 + (lat38.shape[2] - 1) * t_up >= self._prime_need

    def _decode_latents_primed(self, lat: torch.Tensor, n_overlap: int) -> torch.Tensor:
        """End-of-chunk boundary decode: prime the caches on the first
        ``n_overlap`` latents without their pixels, then cont-decode the new
        latents only."""
        lat = self._unnorm_latents(lat).to(self.dtype)
        dec = self.vae.decoder
        with self.timer.phase("prime"):
            cache = _dec_prime_warm(self.vcfg, dec, lat[:, :, :n_overlap])
        return chunk_decode_cont(self.vcfg, dec, lat[:, :, n_overlap:], cache,
                                 self.decode_window)

    def _decode_latents(self, lat: torch.Tensor) -> torch.Tensor:
        """Un-normalise + chunked decode."""
        return vae_decode(self.vcfg, self.vae, self._unnorm_latents(lat).to(self.dtype),
                          temporal_chunk=True, window_size=self.decode_window)

    # -- per-unit sampler ---------------------------------------------------

    def _generate_one_unit(self, noise, latents, input_history, past_conditions,
                           text_embeds, text_mask, pooled, num_rows: int,
                           guidance: float, history_scale: float):
        cfg = self.cfg
        hist = hist_mask = None
        if input_history is not None:
            hist = torch.cat([input_history] * 3, dim=0).to(self.dtype)
            r, p = cfg.history_downsample_ratio, self.mcfg.patch_size
            hlen = (input_history.shape[-1] // r // p) * (input_history.shape[-2] // r // p)
            hist_mask = torch.cat([torch.zeros((2, hlen), dtype=torch.int32, device=self.device),
                                   torch.ones((1, hlen), dtype=torch.int32, device=self.device)])
        intermed = []
        for i_s in range(len(cfg.stages)):
            if i_s > 0:
                alpha, beta = self.schedule.renoise_coeffs(i_s)
                up_shape = latents.shape[:3] + (2 * latents.shape[3], 2 * latents.shape[4])
                z = noise.normal("block", block_noise_shape(up_shape), torch.float32)
                latents = _renoise(latents, z, alpha, beta, cfg.scheduler.gamma)
            ss = self.schedule.stage_schedule(cfg.num_inference_steps, i_s)
            conditions, times, valid = past_conditions[i_s]
            latents = _stage_scan(
                self.mmdit, conditions, times, valid, latents, text_embeds, text_mask,
                pooled, torch.as_tensor(ss.timesteps, device=self.device),
                torch.as_tensor(ss.sigmas[1:] - ss.sigmas[:-1], device=self.device),
                guidance, history_scale, hist, hist_mask, num_rows,
                cfg.history_downsample_ratio, cfg.no_need_depth)
            intermed.append(latents)
        return intermed

    # -- per-chunk i2v ------------------------------------------------------

    def generate_i2v(self, noise, motion_prompt: Sequence[str], use_motion_prompt: bool,
                     input_image: torch.Tensor, input_disparity, input_raymap,
                     input_history, video_guidance_scale: float = 3.5):
        """One chunk. Returns (image, disparity, trans3d, trans2d,
        full_window); ``full_window`` is False when the overlap's pixels were
        not re-decoded (exact priming) and the caller restores them."""
        cfg, mcfg = self.cfg, self.mcfg
        firstframe_mask = input_disparity is None
        num_rows = 2 if input_history is None else 3
        _, _, n_in, height, width = input_image.shape
        ds = cfg.vae_downsample

        temp = cfg.max_temporal_length + int(firstframe_mask)
        latents = noise.normal("latents", (1, mcfg.in_channels, temp, height // ds, width // ds),
                               self.dtype)
        # downsample chain to stage-0 resolution with x2 compensation
        for _ in range(len(cfg.stages) - 1):
            bb, cc, tt, hh, ww = latents.shape
            latents = (down2x_bilinear(latents.reshape(bb, cc * tt, hh, ww)) * 2.0
                       ).reshape(bb, cc, tt, hh // 2, ww // 2)

        with self.timer.phase("vae_encode"):
            if input_disparity is not None:
                enc = self._encode_pixels(torch.cat([input_image, input_disparity]), noise)
                img_lat = self._norm_image_latent(enc[:1])
                disp_lat = self._norm_image_latent(enc[1:2])
            else:
                img_lat = self._norm_image_latent(self._encode_pixels(input_image, noise))
                disp_lat = torch.zeros_like(img_lat)

        if input_raymap is None:
            raymap_lat = img_lat.new_zeros((img_lat.shape[0], cfg.raymap_dim, 1)
                                           + tuple(img_lat.shape[3:]))
        else:
            raymap_lat = input_raymap.to(self.dtype)
        input_image_latent = torch.cat([img_lat, disp_lat, raymap_lat], dim=1).to(self.dtype)

        generated = [input_image_latent]
        num_units = temp // cfg.frame_per_unit
        start_unit_index = 1 if firstframe_mask else (n_in - 1) // ds + 1

        stream = self.stream_decode
        state = {"rgb": None, "disp": None, "first": True}
        rgb_frames, disp_frames = [], []

        def stream_push(lat38):
            li, ld = lat38[:, :-cfg.raymap_dim].chunk(2, dim=1)
            yi, state["rgb"] = self._stream_push(li, state["rgb"], state["first"])
            yd, state["disp"] = self._stream_push(ld, state["disp"], state["first"])
            rgb_frames.append(yi)
            disp_frames.append(yd)
            state["first"] = False

        full_window = True
        if stream and not firstframe_mask:
            if self._prime_eligible(input_image_latent):
                with self.timer.phase("prime"):
                    state["rgb"], state["disp"] = self._prime_warm(input_image_latent)
                state["first"] = False
                full_window = False
            else:
                # warm the caches one carried frame at a time
                for fi in range(input_image_latent.shape[2]):
                    stream_push(input_image_latent[:, :, fi:fi + 1])

        for unit_index in range(start_unit_index, num_units):
            prompt = motion_prompt[unit_index - int(firstframe_mask)]
            pe, pm, pp = self._embeds_for(prompt if use_motion_prompt else str(prompt))
            ne, nm, npo = self._embeds_for("empty")
            reps = num_rows - 1
            text_embeds = torch.cat([ne] + [pe] * reps)
            text_mask = torch.cat([nm] + [pm] * reps)
            pooled = torch.cat([npo] + [pp] * reps)

            clean = _pyramid_list(torch.cat(generated, dim=2), len(cfg.stages) - 1)
            past_conditions = padded_conditions(cfg, clean, unit_index, firstframe_mask,
                                                num_rows)
            fpu = cfg.frame_per_unit
            cur = latents[:, :, unit_index * fpu:(unit_index + 1) * fpu]
            with self.timer.phase("denoise_unit"):
                intermed = self._generate_one_unit(
                    noise, cur, input_history, past_conditions, text_embeds, text_mask,
                    pooled, num_rows, guidance=video_guidance_scale,
                    history_scale=cfg.history_guidance_scale)
            generated.append(intermed[-1])
            if stream:
                with self.timer.phase("stream_decode"):
                    stream_push(intermed[-1])

        if firstframe_mask:
            generated = generated[1:]
        gen = torch.cat(generated, dim=2)

        n_ray = cfg.raymap_dim
        lat_img, lat_disp = gen[:, :-n_ray].chunk(2, dim=1)
        gen_raymap = gen[:, -n_ray:].to(torch.float32) * self.raymap_std + self.raymap_mean
        trans3d, trans2d = raymap_to_camera(gen_raymap[:, :, 1:], append_first_reference=True,
                                            from_relative_to_absolute=True, vae_downsample=ds)

        with self.timer.phase("vae_decode"):
            if stream:
                image = torch.cat(rgb_frames, dim=2)
                disparity = torch.cat(disp_frames, dim=2)
            elif not firstframe_mask and self._prime_eligible(input_image_latent):
                n_ov = input_image_latent.shape[2]
                full_window = False
                image = self._decode_latents_primed(lat_img, n_ov)
                disparity = self._decode_latents_primed(lat_disp, n_ov)
            else:
                image = self._decode_latents(lat_img)
                disparity = self._decode_latents(lat_disp)
        if cfg.no_need_depth:
            disparity = torch.zeros_like(disparity)
        return image, disparity, trans3d, trans2d, full_window

    # -- full rollout -------------------------------------------------------

    @torch.inference_mode()
    def generate(self, batch: Dict, seed: int = 666, video_guidance_scale: float = 3.5,
                 noise=None) -> Dict:
        """Roll out ``batch`` ({"img": [1, 3, H, W] in [-1, 1], "prompt":
        per-unit sentences, "prompt_type"}). ``noise`` replaces the default
        ``TorchNoise(seed, device)``. The output adds ``history_index``: the
        frame retrieved at each chunk boundary."""
        cfg = self.cfg
        noise = noise if noise is not None else TorchNoise(seed, self.device)
        actual_unit = cfg.max_temporal_length
        n_img, n_unit = cfg.num_input_image, cfg.num_input_unit

        prompts = list(batch["prompt"])
        while ((len(prompts) - actual_unit) % (actual_unit - n_unit) != 0
               or len(prompts) < actual_unit):
            prompts.append(prompts[-1])
        total_iters = (len(prompts) - actual_unit) // (actual_unit - n_unit) + 1

        use_motion = batch.get("prompt_type") == "action"
        img = torch.as_tensor(np.asarray(batch["img"]), device=self.device)
        if img.ndim == 3:      # [3, H, W]
            img = img[None, :, None]
        elif img.ndim == 4:    # [1, 3, H, W]
            img = img[:, :, None]
        input_image = img.to(self.dtype)

        images_list, disparity_list, trans3d_list, trans2d_list = [], [], [], []
        motion_prompt_list: List[np.ndarray] = []
        history_index: List[int] = []
        input_disparity = input_raymap = input_history = None
        scale_factor = torch.tensor(1.0, dtype=torch.float32, device=self.device)
        start_unit = 0
        keep_tail = self._prime_need is not None
        tail_rgb = tail_disp = None

        for now_iter in range(total_iters):
            motion_prompt = [prompts[0]] + prompts[start_unit + 1: start_unit + actual_unit]
            if input_raymap is not None:
                input_raymap = (input_raymap - self.raymap_mean) / self.raymap_std

            images, disparitys, trans3d, trans2d, full_window = self.generate_i2v(
                noise, motion_prompt, use_motion, input_image, input_disparity,
                input_raymap, input_history, video_guidance_scale=video_guidance_scale)

            if keep_tail:
                if now_iter > 0 and not full_window:
                    # the overlap was not re-decoded (exact priming): restore
                    # the previous chunk's tail so the bookkeeping sees the
                    # full 57-frame layout; these frames are dropped below
                    images = torch.cat([tail_rgb, images], dim=2)
                    disparitys = torch.cat([tail_disp, disparitys], dim=2)
                tail_rgb = images[:, :, -n_img:]
                tail_disp = disparitys[:, :, -n_img:]

            images, disparitys = self._accumulate_chunk(
                now_iter, images, disparitys, trans3d, trans2d, motion_prompt,
                scale_factor, images_list, disparity_list, motion_prompt_list,
                trans3d_list, trans2d_list)
            start_unit += actual_unit - n_unit
            if now_iter == total_iters - 1:
                break
            (input_image, input_disparity, input_raymap, input_history, scale_factor,
             idx) = self._prepare_carry(noise, images, disparitys, scale_factor,
                                        images_list, disparity_list, trans3d_list,
                                        trans2d_list)
            history_index.append(idx)

        return {
            "pred_img": torch.cat(images_list, dim=2),
            "pred_disparity": torch.cat(disparity_list, dim=2),
            "motion_prompt_list": motion_prompt_list,
            "trans3d": torch.cat(trans3d_list, dim=1),
            "trans2d": torch.cat(trans2d_list, dim=1),
            "history_index": history_index,
        }

    # -- chunk bookkeeping ----------------------------------------------------

    def _accumulate_chunk(self, now_iter, images, disparitys, trans3d, trans2d,
                          motion_prompt, scale_factor, images_list, disparity_list,
                          motion_prompt_list, trans3d_list, trans2d_list):
        """Post-chunk disparity map + pose chaining + list appends. Returns
        the full-chunk (images, mapped disparitys) for the next carry."""
        n_img, n_unit = self.cfg.num_input_image, self.cfg.num_input_unit
        disparitys = _disparity_postmap(disparitys, scale_factor)
        trans3d = trans3d.clone()
        trans3d[:, :, :3, 3] *= scale_factor.to(trans3d.dtype)
        if now_iter == 0:
            images_list.append(images)
            disparity_list.append(disparitys)
            motion_prompt_list.append(np.asarray(motion_prompt))
            trans3d_list.append(trans3d)
            trans2d_list.append(trans2d)
        else:
            images_list.append(images[:, :, n_img:])
            disparity_list.append(disparitys[:, :, n_img:])
            motion_prompt_list.append(np.asarray(motion_prompt[n_unit:]))
            trans3d_pre = trans3d_list[-1][:, -n_unit]
            trans3d = torch.einsum("bij,btjk->btik", trans3d_pre, trans3d)
            trans3d_list.append(trans3d[:, n_unit:])
            trans2d_list.append(trans2d[:, n_unit:])
        return images, disparitys

    @staticmethod
    def _sqrt_encode_translation(trans3d: torch.Tensor, scale_factor) -> torch.Tensor:
        """Translations / scale_factor, sqrt-encoded with their sign (in the
        promoted type, stored back into the pose's float32)."""
        t3 = trans3d[:, :, :3, 3]
        t3 = t3.to(_promote(t3, scale_factor)) / scale_factor
        out = trans3d.clone()
        out[:, :, :3, 3] = (torch.sign(t3) * torch.sqrt(t3.abs())).to(out.dtype)
        return out

    def _prepare_carry(self, noise, images, disparitys, scale_factor,
                       images_list, disparity_list, trans3d_list, trans2d_list):
        """Next-chunk conditioning from the finished chunk: uint8-round-
        tripped overlap pixels, rescaled sqrt-encoded disparity, relative-
        pose raymap and the retrieved history. Returns (input_image,
        input_disparity, input_raymap [unnormalised], input_history,
        scale_factor, history index)."""
        cfg = self.cfg
        n_img, n_unit = cfg.num_input_image, cfg.num_input_unit
        input_image = _quantize_roundtrip(images[:, :, -n_img:])
        input_disparity = disparitys[:, :, -n_img:]
        if not cfg.no_need_depth:
            scale_factor = 1.0 / input_disparity[:, :, 0].max()
            input_disparity = input_disparity * scale_factor * 0.95
            input_disparity = torch.sqrt(input_disparity) * 2.0 - 1.0

        cur = torch.cat(trans3d_list, dim=1)[:, -n_unit:]
        cur = torch.einsum("bij,btjk->btik", torch.linalg.inv(cur[:, 0]), cur)
        # absolute -> consecutive relative poses
        rel = [cur[:, 0]] + [torch.einsum("bij,bjk->bik", torch.linalg.inv(cur[:, i - 1]),
                                          cur[:, i]) for i in range(1, cur.shape[1])]
        cur = self._sqrt_encode_translation(torch.stack(rel, dim=1), scale_factor)
        input_raymap = raymap_from_camera_batch(
            torch.cat(trans2d_list, dim=1)[:, -n_unit:], cur.to(torch.float32),
            tuple(input_disparity.shape[-2:]), vae_downsample=cfg.vae_downsample)
        input_raymap = input_raymap.transpose(1, 2)     # b t c h w -> b c t h w

        input_history, idx = self._retrieve_history(
            noise, images_list, disparity_list, trans3d_list, trans2d_list,
            scale_factor, n_unit)
        return input_image, input_disparity, input_raymap, input_history, scale_factor, idx

    # -- history retrieval ----------------------------------------------------

    def _retrieve_history(self, noise, images_list, disparity_list, trans3d_list,
                          trans2d_list, scale_factor, n_unit):
        """The past frame nearest the current camera (5 nearest positions,
        then the smallest viewing-angle change), encoded as history latent.
        Returns (latent, frame index)."""
        ds = self.cfg.vae_downsample
        cur_images = torch.cat(images_list, dim=2)[:, :, ::ds]
        cur_disparitys = torch.cat(disparity_list, dim=2)[:, :, ::ds]
        cur_trans3d = torch.cat(trans3d_list, dim=1)
        cur_trans2d = torch.cat(trans2d_list, dim=1)
        ref_inv = torch.linalg.inv(cur_trans3d[:, -n_unit])
        cur_trans3d = torch.einsum("bij,btjk->btik", ref_inv, cur_trans3d)

        c2w = cur_trans3d[0]
        last_pos = c2w[-1, :3, 3]
        last_fwd = c2w[-1, :3, 2]
        distances = torch.linalg.vector_norm(c2w[:-1, :3, 3] - last_pos, dim=1)
        k = min(5, distances.shape[0])
        closest = torch.topk(-distances, k).indices
        dots = (c2w[closest, :3, 2] * last_fwd).sum(dim=1)
        # arccos of the f32 dots, correctly rounded (evaluated in f64)
        angles = torch.arccos(dots.clamp(-1.0, 1.0).to(torch.float64)).to(dots.dtype)
        idx = int(closest[torch.argmin(angles)])

        cur_image = cur_images[:, :, idx:idx + 1]
        cur_disparity = cur_disparitys[:, :, idx:idx + 1]
        sel_trans3d = cur_trans3d[:, idx:idx + 1]
        sel_trans2d = cur_trans2d[:, idx:idx + 1]

        cur_disparity = torch.sqrt(cur_disparity * scale_factor * 0.95)
        cur_disparity = (cur_disparity * 2.0 - 1.0).clamp(-1.0, 1.0)
        sel_trans3d = self._sqrt_encode_translation(sel_trans3d, scale_factor)
        cur_raymap = raymap_from_camera_batch(
            sel_trans2d, sel_trans3d.to(torch.float32), tuple(cur_disparity.shape[-2:]),
            vae_downsample=ds).transpose(1, 2)
        return self._history_vae_latent(noise, cur_image, cur_disparity, cur_raymap), idx

    def _history_vae_latent(self, noise, rgb, disparity, raymap):
        """Encode rgb + disparity (one posterior draw for both rows), image
        stats on the single frame, and the normalised raymap."""
        cfg = self.cfg
        with self.timer.phase("vae_encode"):
            enc = self._encode_pixels(torch.cat([rgb, disparity]).to(self.dtype), noise)
        video = (enc[:1] - cfg.vae_shift_factor) * cfg.vae_scale_factor
        disp = (enc[1:2] - cfg.vae_shift_factor) * cfg.vae_scale_factor
        rm = raymap.to(torch.float32).clone()
        rm[:, :3] = rm[:, :3] / torch.linalg.vector_norm(rm[:, :3], dim=1, keepdim=True)
        rm = (rm - self.raymap_mean) / self.raymap_std
        return torch.cat([video, disp, rm.to(video.dtype)], dim=1)
