"""Chunked autoregressive world-model rollout.

Counterpart of ``deepv_tpu/pipeline.py`` on one device: one
conditioning image plus per-unit motion prompts rolls out RGB + disparity +
raymap video in 57-frame chunks with a 25-frame overlap. Each latent unit is
denoised by 3 pyramid stages x 5 Euler steps, each step one MMDiT forward
over 2 CFG rows (3 once history has been retrieved). Units are decoded as
they finish through the causal VAE's carried caches; at a chunk boundary the
decoder caches are primed exactly from the carried latents, the overlap
pixels are re-encoded, and a history frame is retrieved by camera nearness.

On a mesh (``mesh=parallel.mesh.make_mesh(...)``, one process per rank, all
running the same rollout) the MMDiT is tensor-parallel over the axis
``mesh_axis`` (``parallel/tp.py``) and every VAE encode and decode is
spatially context-parallel over the same ranks (``parallel/cp.py``). Every
rank holds the whole latents, frames and poses, with the same bits.

The quality-gated fast modes are options of the same rollout: flow caching
(``flow_cache="skip_odd"`` or ``"adaptive[:tau]"``), the W8A8 denoise
linears (``denoise_int8``), the int8 VAE conv (``VAEConfig(conv_impl=
"int8")``), and the chunk-boundary modes ``reuse_decoder_cache`` and
``carry_latents``. With ``stream_decode=False`` the chunk is decoded at its
end, rgb and disparity as two calls or, ``decode_batched``, as one batch-2
call.

Every Gaussian draw goes through one noise source (``TorchNoise`` by
default, a seeded ``torch.Generator`` on the pipeline's device): the initial
latents, the iid ``z`` behind each inter-stage block noise and the VAE
posterior's eps.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .config import MMDiTConfig, PipelineConfig, VAEConfig
from .io.weights import params_from_numpy
from .models.mmdit import MMDiT, mmdit_forward, quantize_mmdit
from .models.scheduler import FlowMatchSchedule, euler_step
from .models.vae import (VAE, _dec_prime_warm, _dec_window, chunk_decode,
                         chunk_decode_cont, decoder_prime_need, gaussian_sample, vae_decode,
                         vae_encode)
from .ops.basic import fma_f32
from .ops.block_noise import block_noise_from_z, block_noise_shape
from .ops.conv_int8 import quantize_vae_convs
from .ops.resample import down2x_bilinear, up2x_nearest
from .parallel.cp import cp_dec_window, cp_vae_decode_chunked, cp_vae_encode, cp_vae_encode_chunked
from .parallel.mesh import Mesh
from .parallel.tp import shard_mmdit_params
from .raymap import raymap_from_camera_batch, raymap_to_camera
from .utils.profiling import PhaseTimer


# ---------------------------------------------------------------------------
# noise
# ---------------------------------------------------------------------------

class TorchNoise:
    """Random draws from one seeded ``torch.Generator``. The rollout's
    ``kind`` is "latents", "block" (the iid z of block noise) or "posterior"
    (the VAE's eps); the training objectives' are "noise" and "sigma"
    (single clip) and "end", "prev", "block" and "ratio" (pyramid). This
    source draws all kinds alike."""

    def __init__(self, seed: int, device):
        self.device = torch.device(device)
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(seed)

    def normal(self, kind: str, shape, dtype) -> torch.Tensor:
        return torch.randn(tuple(shape), generator=self.generator, device=self.device,
                           dtype=dtype)

    def uniform(self, kind: str, shape, low: float, high: float,
                dtype=torch.float32) -> torch.Tensor:
        """Uniform on [low, high)."""
        u = torch.rand(tuple(shape), generator=self.generator, device=self.device, dtype=dtype)
        return u * (high - low) + low


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
                num_rows: int, history_downsample_ratio: int, zero_depth: bool,
                recompute: Tuple[int, ...] = (), adaptive_tau: Optional[float] = None
                ) -> Tuple[torch.Tensor, Tuple[int, ...]]:
    """All Euler steps of one pyramid stage: per step, one MMDiT forward
    over the CFG rows, the guidance combine in at-least-f32, and an f32
    Euler update. Returns the latents and, per step, 1 where the forward
    ran and 0 where it was skipped.

    Flow caching: ``recompute`` is a 0/1 mask over the steps (empty: all
    ones, the exact path); a step marked 0 skips the forward and reuses the
    previous step's guided velocity, and the Euler step is still taken.
    ``adaptive_tau`` also runs a marked-0 step's forward when the latent's
    relative L1 drift since the last forward, ``mean|lat - lat_ref| /
    (mean|lat_ref| + 1e-6)`` in f32, reaches tau. That decision is taken on
    the host, so each step after the first waits for the device."""
    n_steps = int(timesteps.shape[0])
    recompute = tuple(recompute) or (1,) * n_steps
    if len(recompute) != n_steps or recompute[0] != 1:
        raise ValueError(f"flow-cache mask {recompute} must cover all {n_steps} steps "
                         f"and recompute the first")
    conds = [_zero_depth_channels(c) for c in conditions] if zero_depth else list(conditions)
    ct = torch.promote_types(latents.dtype, torch.float32)
    tau = None if adaptive_tau is None else torch.tensor(adaptive_tau, dtype=torch.float32)

    def forward(lat, t):
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
        return guided.to(lat.dtype)

    lat = lat_ref = latents
    v = None
    decisions = []
    for t, dsig, marked in zip(timesteps, dsigmas, recompute):
        run = marked > 0
        if not run and tau is not None:
            num = (lat.to(torch.float32) - lat_ref.to(torch.float32)).abs().mean()
            den = lat_ref.to(torch.float32).abs().mean() + 1e-6
            run = bool((num / den >= tau).item())
        if run:
            v, lat_ref = forward(lat, t), lat
        decisions.append(int(run))
        lat = euler_step(lat, v, dsig)
    return lat, tuple(decisions)


def parse_flow_cache(flow_cache: str) -> Optional[float]:
    """The adaptive bound tau of a ``flow_cache`` string ("none",
    "skip_odd", "adaptive" (tau 0.3) or "adaptive:<tau>"), None for the
    first two. A malformed string raises ValueError, never a default."""
    if flow_cache.startswith("adaptive"):
        head, sep, tau_s = flow_cache.partition(":")
        bad = ValueError(f"flow_cache {flow_cache!r}: expected 'adaptive' or 'adaptive:<tau>'")
        if head != "adaptive" or (sep and not tau_s):
            raise bad
        try:
            return float(tau_s) if sep else 0.3
        except ValueError:
            raise bad from None
    if flow_cache not in ("none", "skip_odd"):
        raise ValueError(f"flow_cache {flow_cache!r}: expected 'none', 'skip_odd', "
                         f"'adaptive' or 'adaptive:<tau>'")
    return None


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


@dataclasses.dataclass
class _Chunk:
    """``generate_i2v``'s state between two units of one chunk: the chunk's
    latents, the unit latents generated so far (the conditioning latents
    first) and the streaming decoder's caches and frames. ``generate_i2v``
    runs every unit of a chunk in one loop; a serving session runs one unit
    a request."""
    latents: torch.Tensor
    generated: List[torch.Tensor]
    firstframe_mask: bool
    num_rows: int
    input_history: Optional[torch.Tensor]
    unit_index: int
    num_units: int
    stream: bool
    #: the previous chunk's decoder caches, kept for the batch decode's
    #: reuse mode (a streaming chunk starts from them instead)
    dec_state: Optional[Tuple] = None
    rgb: Optional[Tuple] = None
    disp: Optional[Tuple] = None
    first: bool = True
    rgb_frames: List[torch.Tensor] = dataclasses.field(default_factory=list)
    disp_frames: List[torch.Tensor] = dataclasses.field(default_factory=list)
    #: False when the overlap's pixels are not re-decoded (cache reuse or
    #: exact priming) and the rollout restores them from the previous chunk
    full_window: bool = True


@dataclasses.dataclass
class _Rollout:
    """``generate``'s state between chunks: the finished chunks' outputs and
    the next chunk's conditioning (``input_raymap`` normalised)."""
    input_image: torch.Tensor
    scale_factor: torch.Tensor
    input_disparity: Optional[torch.Tensor] = None
    input_raymap: Optional[torch.Tensor] = None
    input_history: Optional[torch.Tensor] = None
    images_list: List[torch.Tensor] = dataclasses.field(default_factory=list)
    disparity_list: List[torch.Tensor] = dataclasses.field(default_factory=list)
    trans3d_list: List[torch.Tensor] = dataclasses.field(default_factory=list)
    trans2d_list: List[torch.Tensor] = dataclasses.field(default_factory=list)
    motion_prompt_list: List[np.ndarray] = dataclasses.field(default_factory=list)
    history_index: List[int] = dataclasses.field(default_factory=list)
    now_iter: int = 0
    #: the last chunk's raw overlap frames, for a chunk that skips them
    tail_rgb: Optional[torch.Tensor] = None
    tail_disp: Optional[torch.Tensor] = None
    dec_state: Optional[Tuple] = None
    carry_lat: Optional[torch.Tensor] = None

    def output(self) -> Dict:
        """The rollout so far in ``generate``'s output format."""
        return {
            "pred_img": torch.cat(self.images_list, dim=2),
            "pred_disparity": torch.cat(self.disparity_list, dim=2),
            "motion_prompt_list": self.motion_prompt_list,
            "trans3d": torch.cat(self.trans3d_list, dim=1),
            "trans2d": torch.cat(self.trans2d_list, dim=1),
            "history_index": list(self.history_index),
        }


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
    negative prompt is ``'empty'``. A prompt the cache does not hold (a
    ``prompt_type="text"`` rollout) is encoded by ``text_encoder``
    (``io/weights.load_text_encoders``), once per prompt.

    ``mesh`` (a ``parallel.mesh.Mesh``, made by every rank inside its
    process group): the pipeline runs on ``mesh.device``, holds this rank's
    tensor-parallel share of the MMDiT (cut from the whole ``params``) and
    the whole VAE, and runs every encode and decode context-parallel over
    the ranks of ``mesh_axis``; exact priming is off. Latent H must divide
    by the axis size and pixel H by 8 times it. ``use_tiling`` and
    ``reuse_decoder_cache`` raise ValueError with a mesh. The fast modes
    compose with it: ``denoise_int8`` quantises this rank's share of the
    MMDiT (the row-split layers' scales and int32 sums taken over the
    ranks, ``ops/linear_int8.py``), and with ``VAEConfig(conv_impl="int8")``
    the int8 conv weights are made as on one device, while every conv under
    context parallelism runs ``F.conv3d`` on the float weights, as
    deepv_tpu's do (``ops/causal_conv.py``)."""

    def __init__(self, cfg: PipelineConfig, mmdit_cfg: MMDiTConfig,
                 vae_cfg: VAEConfig, params: Dict, text_embeds: Dict,
                 dtype=torch.bfloat16, use_tiling: bool = False,
                 decode_window: int = 2, decode_batched: bool = False,
                 stream_decode: bool = True, text_encoder=None,
                 flow_cache: str = "none", mesh=None, mesh_axis: str = "tp",
                 reuse_decoder_cache: bool = False, denoise_int8: bool = False,
                 prime_decoder_cache: bool = True, carry_latents: bool = False,
                 encode_window: int = 16, device="cuda"):
        # deepv_tpu's parameters in its order, then the port's device
        if mesh is not None:
            if use_tiling:
                raise ValueError("spatial tiling and spatial CP both bound memory by splitting "
                                 "H; use one or the other")
            if reuse_decoder_cache:
                raise ValueError("reuse_decoder_cache carries single-device decoder caches; "
                                 "it cannot be combined with a mesh")
            if not isinstance(mesh, Mesh):
                raise TypeError(f"mesh must be a parallel.mesh.Mesh (make_mesh), got "
                                f"{type(mesh).__name__}")
            if mesh_axis not in mesh.axis_names:
                raise ValueError(f"mesh has axes {mesh.axis_names}, expected {mesh_axis!r}")
            if torch.device(device).type != mesh.device.type:
                raise ValueError(f"device {device!r} and the mesh's {mesh.device} differ")
            device = mesh.device
        if reuse_decoder_cache and use_tiling:
            raise ValueError("reuse_decoder_cache carries untiled decoder caches; "
                             "it cannot be combined with use_tiling")
        #: multi-card inference: this rank's view of the mesh, or None
        self.mesh = mesh
        self.mesh_axis = mesh_axis
        self.cfg = cfg
        self.mcfg = mmdit_cfg
        self.vcfg = vae_cfg
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("device='cuda' but no CUDA device is available; "
                               "pass device='cpu' to run on the CPU")
        self.dtype = dtype
        #: flow caching: "none" runs every Euler step's forward (exact);
        #: "skip_odd" reuses the guided velocity on odd steps of each stage
        #: (2 of 5 forwards skipped); "adaptive[:tau]" (tau 0.3 by default)
        #: skips a step only while the latent's relative L1 drift since the
        #: last forward stays under tau (tau 0 is bit-identical to "none").
        #: Quality-gated: outputs deviate from the exact rollout.
        self.adaptive_tau = parse_flow_cache(flow_cache)
        self.flow_cache = flow_cache
        #: per denoise stage of the last ``generate`` call (which empties it
        #: first), 1 for each step whose forward ran and 0 for each skipped
        #: one; ``generate_i2v`` appends its units' stages
        self.recompute_log: List[Tuple[int, ...]] = []
        if mesh is None:
            self.mmdit = params_from_numpy(MMDiT(mmdit_cfg), params["mmdit"], self.device)
        else:
            self.mmdit = params_from_numpy(
                MMDiT(mmdit_cfg, tp_group=mesh.group(mesh_axis)),
                shard_mmdit_params(params["mmdit"], mesh, mesh_axis), self.device)
        #: W8A8 denoise linears (quality-gated, ops/linear_int8.py): the
        #: block linears are replaced by int8 ones and their floating-point
        #: weights dropped; AdaLN, embedders and proj_out stay exact
        self.denoise_int8 = denoise_int8
        if denoise_int8:
            quantize_mmdit(self.mmdit)
        self.vae = params_from_numpy(VAE(vae_cfg), params["vae"], self.device)
        if vae_cfg.conv_impl == "int8":
            # the int8 weights, scales and K3's weight layout, made once for
            # the encoder (the carry re-encode) and the decoder
            quantize_vae_convs(self.vae)
        #: carry the decoder caches across chunk boundaries instead of
        #: priming them from the re-encoded overlap (both decode modes). The
        #: overlap's pixels then come from the previous chunk's latents
        #: instead of the uint8-round-tripped re-encode: outputs deviate.
        self.reuse_decoder_cache = reuse_decoder_cache
        #: carry the chunk's generated rgb latents into the next chunk's
        #: conditioning instead of re-encoding the overlap pixels; disparity
        #: is always re-encoded. Quality-gated: outputs deviate.
        self.carry_latents = carry_latents
        #: optional callback ``on_frames(rgb_window, disp_window)``, fired
        #: with the raw decoded pixels of each streamed window as it is
        #: decoded (requires ``stream_decode``): the serving hook. A window
        #: covers the chunk overlap only when the boundary re-decodes it;
        #: with the default exact priming (or cache reuse) chunks >= 2 emit
        #: their new frames only (32 per chunk, not 57). Consumers that need
        #: the full re-decode stream pass ``prime_decoder_cache=False``.
        self.on_frames = None
        self.text_embeds = text_embeds
        self.decode_window = decode_window
        self.encode_window = encode_window
        #: decode rgb and disparity as one batch-2 VAE call at the end of a
        #: chunk (``stream_decode=False``; the streamed windows stay two
        #: calls). In the reuse mode the kept caches are then one batch-2
        #: cache and None, as deepv_tpu keeps them
        self.decode_batched = decode_batched
        #: decode each unit's latent as soon as it is denoised (exact: the
        #: causal VAE's chunked decode equals the full decode)
        self.stream_decode = stream_decode
        #: spatial tiling of the VAE's encodes and end-of-chunk decodes
        #: (``models/vae._tiled``); the streamed windows stay untiled
        self.use_tiling = use_tiling
        #: exact chunk-boundary cache priming: rebuild the decoder caches the
        #: overlap re-decode exists to produce without computing its pixels
        #: (untiled, single-device caches only, so off under tiling or a mesh)
        self._prime_need = None
        if prime_decoder_cache and not reuse_decoder_cache and not use_tiling and mesh is None:
            need = decoder_prime_need(vae_cfg)
            if need is not None and self.vae.decoder.conv_out.weight.shape[2] == 3:
                self._prime_need = need
        #: live encoder for prompts the cache does not hold (an
        #: ``SD3TextEncoder``: ``encoder(prompt) -> (embeds, mask, pooled)``)
        self.text_encoder = text_encoder
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
        if prompt in self.text_embeds:
            e = self.text_embeds[prompt]
            pe, mask, pooled = (torch.as_tensor(np.asarray(e[k])) for k in (
                "prompt_embeds", "prompt_attention_mask", "pooled_prompt_embeds"))
        elif self.text_encoder is not None:
            pe, mask, pooled = self.text_encoder(prompt)
        else:
            raise KeyError(
                f"prompt {prompt!r} not in the precomputed text-embedding cache and no "
                "live text encoder is configured")
        out = (pe.to(self.device, self.dtype), mask.to(self.device, torch.int32),
               pooled.to(self.device, self.dtype))
        # memoised: a prompt repeats for every unit of every chunk, and the
        # live encoder would otherwise tokenise and encode it each time
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

    def _encode_row(self, x: torch.Tensor, chunked: bool) -> torch.Tensor:
        """One batch row's moments; on a mesh context-parallel, chunked in
        windows of 8 as deepv_tpu's mesh path."""
        if self.mesh is None:
            return vae_encode(self.vcfg, self.vae, x, temporal_chunk=chunked,
                              window_size=self.encode_window, use_tiling=self.use_tiling)
        if chunked:
            return cp_vae_encode_chunked(self.vcfg, self.vae, x, self.mesh, self.mesh_axis,
                                         window_size=8)
        return cp_vae_encode(self.vcfg, self.vae, x, self.mesh, self.mesh_axis)

    def _encode_pixels(self, x: torch.Tensor, noise) -> torch.Tensor:
        """Encode each batch row (serially, temporally chunked past 17
        frames), then sample the posterior once for all rows."""
        chunked = x.shape[2] > 17
        parts = [self._encode_row(x[i:i + 1].to(self.dtype), chunked) for i in range(x.shape[0])]
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
        if self.mesh is not None:
            return cp_dec_window(self.vcfg, self.vae.decoder, z.to(self.dtype), cache, mode,
                                 self.mesh, self.mesh_axis)
        return _dec_window(self.vcfg, self.vae.decoder, z.to(self.dtype), cache, mode)

    def _carry_rgb_latent(self, lat_img: torch.Tensor) -> torch.Tensor:
        """carry_latents: the next chunk's rgb conditioning latents, the
        chunk's own last generated ones. The re-encode they replace treats
        the overlap's first frame as an image, so frame 0 is renormalised
        from video to image stats (in f32)."""
        c = self.cfg
        cl = lat_img[:, :, -(1 + (c.num_input_image - 1) // c.vae_downsample):]
        f0 = ((cl[:, :, :1].to(torch.float32) / c.vae_video_scale_factor
               + c.vae_video_shift_factor - c.vae_shift_factor) * c.vae_scale_factor)
        return torch.cat([f0.to(cl.dtype), cl[:, :, 1:]], dim=2).to(self.dtype)

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

    def _decode_latents_reuse(self, lat: torch.Tensor, cache, n_overlap: int):
        """End-of-chunk decode for ``reuse_decoder_cache``: continue the
        previous chunk's final decoder caches past the ``n_overlap`` carried
        latents, or (``cache`` None) decode the whole stream. Returns
        (pixels, final caches); both equal the streaming mode's."""
        lat = self._unnorm_latents(lat).to(self.dtype)
        dec = self.vae.decoder
        if cache is None:
            return chunk_decode(self.vcfg, dec, lat, self.decode_window, return_cache=True)
        return chunk_decode_cont(self.vcfg, dec, lat[:, :, n_overlap:], cache,
                                 self.decode_window, return_cache=True)

    def _decode_latents(self, lat: torch.Tensor) -> torch.Tensor:
        """Un-normalise + chunked (and, ``use_tiling``, tiled; on a mesh,
        context-parallel) decode."""
        lat = self._unnorm_latents(lat).to(self.dtype)
        if self.mesh is not None:
            return cp_vae_decode_chunked(self.vcfg, self.vae, lat, self.mesh, self.mesh_axis,
                                         window_size=self.decode_window)
        return vae_decode(self.vcfg, self.vae, lat, temporal_chunk=True,
                          window_size=self.decode_window, use_tiling=self.use_tiling)

    # -- per-unit sampler ---------------------------------------------------

    def _generate_one_unit(self, noise, latents, input_history, past_conditions,
                           text_embeds, text_mask, pooled, num_rows: int,
                           guidance: float, history_scale: float):
        """Denoise one unit through the pyramid stages. Returns the stages'
        latents and, per stage, 1 for each step whose forward ran and 0 for
        each skipped one."""
        cfg = self.cfg
        hist = hist_mask = None
        if input_history is not None:
            hist = torch.cat([input_history] * 3, dim=0).to(self.dtype)
            r, p = cfg.history_downsample_ratio, self.mcfg.patch_size
            hlen = (input_history.shape[-1] // r // p) * (input_history.shape[-2] // r // p)
            hist_mask = torch.cat([torch.zeros((2, hlen), dtype=torch.int32, device=self.device),
                                   torch.ones((1, hlen), dtype=torch.int32, device=self.device)])
        intermed, recompute_log = [], []
        for i_s in range(len(cfg.stages)):
            if i_s > 0:
                alpha, beta = self.schedule.renoise_coeffs(i_s)
                up_shape = latents.shape[:3] + (2 * latents.shape[3], 2 * latents.shape[4])
                z = noise.normal("block", block_noise_shape(up_shape), torch.float32)
                latents = _renoise(latents, z, alpha, beta, cfg.scheduler.gamma)
            ss = self.schedule.stage_schedule(cfg.num_inference_steps, i_s)
            n_steps = len(ss.timesteps)
            if self.flow_cache == "skip_odd":
                recompute = tuple(1 - i % 2 for i in range(n_steps))
            elif self.adaptive_tau is not None:
                # tau governs every step after the forced first one
                recompute = (1,) + (0,) * (n_steps - 1)
            else:
                recompute = ()
            conditions, times, valid = past_conditions[i_s]
            latents, ran = _stage_scan(
                self.mmdit, conditions, times, valid, latents, text_embeds, text_mask,
                pooled, torch.as_tensor(ss.timesteps, device=self.device),
                torch.as_tensor(ss.sigmas[1:] - ss.sigmas[:-1], device=self.device),
                guidance, history_scale, hist, hist_mask, num_rows,
                cfg.history_downsample_ratio, cfg.no_need_depth, recompute, self.adaptive_tau)
            recompute_log.append(ran)
            intermed.append(latents)
        return intermed, recompute_log

    # -- per-chunk i2v ------------------------------------------------------

    def _open_chunk(self, noise, input_image: torch.Tensor, input_disparity, input_raymap,
                    input_history, dec_state=None, carry_rgb_latent=None,
                    stream: Optional[bool] = None) -> _Chunk:
        """``generate_i2v``'s prologue, in its order of draws: the chunk's
        latents, the conditioning encode (its posterior eps) and the
        streaming decoder's start (cache reuse, exact priming or a warm-up
        through the carried frames). ``stream`` defaults to
        ``stream_decode``."""
        cfg, mcfg = self.cfg, self.mcfg
        firstframe_mask = input_disparity is None
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
            if carry_rgb_latent is not None:
                # carry_latents: only disparity pays the re-encode
                img_lat = carry_rgb_latent.to(self.dtype)
                disp_lat = self._norm_image_latent(self._encode_pixels(input_disparity, noise))
            elif input_disparity is not None:
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

        ch = _Chunk(latents=latents, generated=[input_image_latent],
                    firstframe_mask=firstframe_mask,
                    num_rows=2 if input_history is None else 3, input_history=input_history,
                    unit_index=1 if firstframe_mask else (n_in - 1) // ds + 1,
                    num_units=temp // cfg.frame_per_unit,
                    stream=self.stream_decode if stream is None else stream)
        if not ch.stream:
            ch.dec_state = dec_state
        elif not firstframe_mask:
            if dec_state is not None:
                # reuse_decoder_cache: the previous chunk's caches already
                # hold the overlap's conv state; only the new units decode
                ch.rgb, ch.disp = dec_state
                ch.first = False
                ch.full_window = False
            elif self._prime_eligible(input_image_latent):
                with self.timer.phase("prime"):
                    ch.rgb, ch.disp = self._prime_warm(input_image_latent)
                ch.first = False
                ch.full_window = False
            else:
                # warm the caches one carried frame at a time
                for fi in range(input_image_latent.shape[2]):
                    self._push_frames(ch, input_image_latent[:, :, fi:fi + 1])
        return ch

    def _push_frames(self, ch: _Chunk, lat38: torch.Tensor) -> None:
        """Decode one latent window through the chunk's carried decoder
        caches and hand its frames to ``on_frames``."""
        li, ld = lat38[:, :-self.cfg.raymap_dim].chunk(2, dim=1)
        yi, ch.rgb = self._stream_push(li, ch.rgb, ch.first)
        yd, ch.disp = self._stream_push(ld, ch.disp, ch.first)
        ch.rgb_frames.append(yi)
        ch.disp_frames.append(yd)
        ch.first = False
        if self.on_frames is not None:
            self.on_frames(yi, yd)

    def _next_unit(self, noise, ch: _Chunk, prompt: str, guidance: float):
        """Denoise the chunk's next unit under ``prompt``'s embedding (and,
        when streaming, decode it). Returns the unit's per-stage recompute
        flags (``_generate_one_unit``)."""
        cfg = self.cfg
        pe, pm, pp = self._embeds_for(prompt)
        ne, nm, npo = self._embeds_for("empty")
        reps = ch.num_rows - 1
        text_embeds = torch.cat([ne] + [pe] * reps)
        text_mask = torch.cat([nm] + [pm] * reps)
        pooled = torch.cat([npo] + [pp] * reps)

        clean = _pyramid_list(torch.cat(ch.generated, dim=2), len(cfg.stages) - 1)
        past_conditions = padded_conditions(cfg, clean, ch.unit_index, ch.firstframe_mask,
                                            ch.num_rows)
        fpu = cfg.frame_per_unit
        cur = ch.latents[:, :, ch.unit_index * fpu:(ch.unit_index + 1) * fpu]
        with self.timer.phase("denoise_unit"):
            intermed, recompute = self._generate_one_unit(
                noise, cur, ch.input_history, past_conditions, text_embeds, text_mask,
                pooled, ch.num_rows, guidance=guidance,
                history_scale=cfg.history_guidance_scale)
        ch.generated.append(intermed[-1])
        if ch.stream:
            with self.timer.phase("stream_decode"):
                self._push_frames(ch, intermed[-1])
        ch.unit_index += 1
        return recompute

    def _end_chunk(self, ch: _Chunk, keep_caches: Optional[bool] = None):
        """``generate_i2v``'s epilogue: the poses from the generated raymaps,
        the chunk's pixels (the streamed frames, or a batch decode) and the
        carries. Returns ``generate_i2v``'s tuple; its decoder caches are
        kept when ``keep_caches`` (default ``reuse_decoder_cache``)."""
        cfg = self.cfg
        generated = ch.generated[1:] if ch.firstframe_mask else ch.generated
        gen = torch.cat(generated, dim=2)

        n_ray = cfg.raymap_dim
        lat_img, lat_disp = gen[:, :-n_ray].chunk(2, dim=1)
        gen_raymap = gen[:, -n_ray:].to(torch.float32) * self.raymap_std + self.raymap_mean
        trans3d, trans2d = raymap_to_camera(gen_raymap[:, :, 1:], append_first_reference=True,
                                            from_relative_to_absolute=True,
                                            vae_downsample=cfg.vae_downsample)

        input_image_latent = ch.generated[0]
        full_window = ch.full_window
        with self.timer.phase("vae_decode"):
            if ch.stream:
                image = torch.cat(ch.rgb_frames, dim=2)
                disparity = torch.cat(ch.disp_frames, dim=2)
            elif self.reuse_decoder_cache:
                # continue the previous chunk's final caches past the
                # boundary; the first chunk decodes everything
                n_ov = (0 if ch.firstframe_mask or ch.dec_state is None
                        else input_image_latent.shape[2])
                full_window = n_ov == 0
                prev_rgb, prev_disp = ch.dec_state or (None, None)
                ch.dec_state = None
                if self.decode_batched:
                    # one batch-2 cache, kept as the rgb one
                    both, ch.rgb = self._decode_latents_reuse(
                        torch.cat([lat_img, lat_disp]), prev_rgb, n_ov)
                    image, disparity = both[:1], both[1:2]
                else:
                    image, ch.rgb = self._decode_latents_reuse(lat_img, prev_rgb, n_ov)
                    prev_rgb = None
                    disparity, ch.disp = self._decode_latents_reuse(lat_disp, prev_disp, n_ov)
                prev_rgb = prev_disp = None
            elif not ch.firstframe_mask and self._prime_eligible(input_image_latent):
                n_ov = input_image_latent.shape[2]
                full_window = False
                if self.decode_batched:
                    both = self._decode_latents_primed(torch.cat([lat_img, lat_disp]), n_ov)
                    image, disparity = both[:1], both[1:2]
                else:
                    image = self._decode_latents_primed(lat_img, n_ov)
                    disparity = self._decode_latents_primed(lat_disp, n_ov)
            elif self.decode_batched:
                both = self._decode_latents(torch.cat([lat_img, lat_disp]))
                image, disparity = both[:1], both[1:2]
            else:
                image = self._decode_latents(lat_img)
                disparity = self._decode_latents(lat_disp)
        if cfg.no_need_depth:
            disparity = torch.zeros_like(disparity)
        keep = self.reuse_decoder_cache if keep_caches is None else keep_caches
        dec_state = (ch.rgb, ch.disp) if keep else None
        carry = self._carry_rgb_latent(lat_img) if self.carry_latents else None
        return image, disparity, trans3d, trans2d, dec_state, carry, full_window

    def generate_i2v(self, noise, motion_prompt: Sequence[str], use_motion_prompt: bool,
                     input_image: torch.Tensor, input_disparity, input_raymap,
                     input_history, guidance_scale: float = 4.0,
                     video_guidance_scale: float = 3.5, use_linear_guidance: bool = False,
                     alpha: float = 1.0, min_guidance_scale: float = 1.1, dec_state=None,
                     carry_rgb_latent: Optional[torch.Tensor] = None):
        """One chunk; deepv_tpu's parameters in its order, with the noise
        source where deepv_tpu takes its PRNG key. Each unit's guidance is
        ``video_guidance_scale``, or with ``use_linear_guidance`` unit i's
        ``max(guidance_scale - alpha * i, min_guidance_scale)``.
        ``dec_state`` is the previous chunk's (rgb, disparity)
        decoder caches (``reuse_decoder_cache``), ``carry_rgb_latent`` its
        carried rgb latents (``carry_latents``). Returns (image, disparity,
        trans3d, trans2d, dec_state, carry latents, full_window); the two
        carries are None when their mode is off, and ``full_window`` is
        False when the overlap's pixels were not re-decoded (cache reuse or
        exact priming) and the caller restores them. Each unit's recompute
        flags are appended to ``recompute_log``."""
        ch = self._open_chunk(noise, input_image, input_disparity, input_raymap,
                              input_history, dec_state, carry_rgb_latent)
        dec_state = None
        if use_linear_guidance:
            # per-unit decayed guidance
            guidance_list = [max(guidance_scale - alpha * t_, min_guidance_scale)
                             for t_ in range(ch.num_units + 1)]
        while ch.unit_index < ch.num_units:
            if use_linear_guidance:
                video_guidance_scale = guidance_list[ch.unit_index]
            prompt = motion_prompt[ch.unit_index - int(ch.firstframe_mask)]
            self.recompute_log.extend(self._next_unit(
                noise, ch, prompt if use_motion_prompt else str(prompt), video_guidance_scale))
        return self._end_chunk(ch)

    # -- full rollout -------------------------------------------------------

    def _new_rollout(self, img) -> _Rollout:
        """A rollout's state before its first chunk, from one conditioning
        image [3, H, W] or [1, 3, H, W] in [-1, 1]."""
        img = torch.as_tensor(img if isinstance(img, torch.Tensor) else np.asarray(img),
                              device=self.device)
        if img.ndim == 3:      # [3, H, W]
            img = img[None, :, None]
        elif img.ndim == 4:    # [1, 3, H, W]
            img = img[:, :, None]
        return _Rollout(input_image=img.to(self.dtype),
                        scale_factor=torch.tensor(1.0, dtype=torch.float32, device=self.device))

    def _carry_chunk(self, noise, roll: _Rollout, chunk_out, motion_prompt,
                     carry: bool = True) -> None:
        """``generate``'s bookkeeping after one chunk (``generate_i2v``'s
        tuple): restore the overlap's pixels when the chunk did not
        re-decode them, post-map, chain the poses and append to the rollout;
        then, with ``carry``, the next chunk's conditioning and history."""
        (images, disparitys, trans3d, trans2d, roll.dec_state, roll.carry_lat,
         full_window) = chunk_out
        n_img = self.cfg.num_input_image
        if roll.now_iter > 0 and not full_window:
            # the bookkeeping sees the full 57-frame layout; these frames are
            # dropped below
            images = torch.cat([roll.tail_rgb, images], dim=2)
            disparitys = torch.cat([roll.tail_disp, disparitys], dim=2)
        roll.tail_rgb, roll.tail_disp = images[:, :, -n_img:], disparitys[:, :, -n_img:]
        images, disparitys = self._accumulate_chunk(
            roll.now_iter, images, disparitys, trans3d, trans2d, motion_prompt,
            roll.scale_factor, roll.images_list, roll.disparity_list, roll.motion_prompt_list,
            roll.trans3d_list, roll.trans2d_list)
        roll.now_iter += 1
        if not carry:
            return
        (roll.input_image, roll.input_disparity, input_raymap, roll.input_history,
         roll.scale_factor, idx) = self._prepare_carry(
            noise, images, disparitys, roll.scale_factor, roll.images_list,
            roll.disparity_list, roll.trans3d_list, roll.trans2d_list)
        roll.input_raymap = (input_raymap - self.raymap_mean) / self.raymap_std
        roll.history_index.append(idx)

    @torch.inference_mode()
    def generate(self, batch: Dict, seed: int = 666, guidance_scale: float = 4.0,
                 video_guidance_scale: float = 3.5, noise=None) -> Dict:
        """Roll out ``batch`` ({"img": [1, 3, H, W] in [-1, 1], "prompt":
        per-unit sentences, "prompt_type"}); deepv_tpu's parameters in its
        order (``guidance_scale`` reaches ``generate_i2v``, where only linear
        guidance reads it). ``noise`` replaces the default
        ``TorchNoise(seed, device)``. The output adds ``history_index``: the
        frame retrieved at each chunk boundary. ``recompute_log`` is emptied
        first, so it holds this call's decisions."""
        cfg = self.cfg
        noise = noise if noise is not None else TorchNoise(seed, self.device)
        self.recompute_log = []
        actual_unit = cfg.max_temporal_length
        n_unit = cfg.num_input_unit

        prompts = list(batch["prompt"])
        while ((len(prompts) - actual_unit) % (actual_unit - n_unit) != 0
               or len(prompts) < actual_unit):
            prompts.append(prompts[-1])
        total_iters = (len(prompts) - actual_unit) // (actual_unit - n_unit) + 1

        use_motion = batch.get("prompt_type") == "action"
        roll = self._new_rollout(batch["img"])
        start_unit = 0
        for now_iter in range(total_iters):
            motion_prompt = [prompts[0]] + prompts[start_unit + 1: start_unit + actual_unit]
            # hand the decoder caches over, so that no binding here pins the
            # previous generation while the chunk makes the next one
            ds_arg, roll.dec_state = roll.dec_state, None
            out = self.generate_i2v(
                noise, motion_prompt, use_motion, roll.input_image, roll.input_disparity,
                roll.input_raymap, roll.input_history, guidance_scale=guidance_scale,
                video_guidance_scale=video_guidance_scale, dec_state=ds_arg,
                carry_rgb_latent=roll.carry_lat)
            del ds_arg
            self._carry_chunk(noise, roll, out, motion_prompt,
                              carry=now_iter < total_iters - 1)
            del out
            start_unit += actual_unit - n_unit
        return roll.output()

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
