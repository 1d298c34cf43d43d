"""One latent unit of DeepVerse's pyramid flow-matching rollout, and the
pipeline arithmetic around the VAE, in plain PyTorch.

A unit is denoised through 3 pyramid stages of 5 Euler steps; each step
runs one MMDiT forward over the classifier-free-guidance rows (2, or 3
once a history frame conditions the chunk) and a guided float32 Euler
update; between stages the latent is upsampled 2x (nearest) and renoised
with correlated 2x2 block noise. The conditions of a unit are the chunk's
earlier latents as a shape-stable pyramid: the old frames at stage 0,
padded to ``max_temporal_length - 2`` with per-frame times and validity,
the last frame at the stage's resolution, and at the top stage the one
before it at stage 1. Flow caching ``skip_odd`` reuses the previous
step's guided velocity on odd steps.

At a chunk boundary a history frame is retrieved: of the rollout's
frames (one a unit), the five whose cameras lie nearest the last one's,
and of those the one whose viewing direction turns least from it.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .mmdit import MMDiT


class Schedule:
    """The pyramid flow-matching schedule's tables (numpy, from the
    scheduler configuration)."""

    def __init__(self, s: Dict):
        n, shift, stages = s["num_train_timesteps"], s["shift"], s["stages"]
        rng, gamma = s["stage_range"], s["gamma"]
        t = np.linspace(1, n, n, dtype=np.float32)[::-1].copy()
        sig = t / n
        sigmas = shift * sig / (1 + (shift - 1) * sig)
        timesteps = sigmas * n
        self.gamma = gamma
        self.ori_start, dist = {}, []
        for i in range(stages):
            a, b = max(int(rng[i] * n), 0), min(int(rng[i + 1] * n), n)
            start = float(sigmas[a])
            end = float(sigmas[b]) if b < n else 0.0
            self.ori_start[i] = start
            if i:
                ori = 1 - start
                start = 1 - (1 / (math.sqrt(1 + 1 / gamma) * (1 - ori) + ori)) * ori
            dist.append(start - end)
        tot = sum(dist)
        self.t_stage = {}
        for i in range(stages):
            r0 = 0.0 if i == 0 else sum(dist[:i]) / tot
            r1 = 1.0 if i == stages - 1 else sum(dist[:i + 1]) / tot
            self.t_stage[i] = np.linspace(timesteps[int(r0 * n)], timesteps[min(int(r1 * n), n - 1)],
                                          n + 1)[:-1]
        self.s_stage = np.linspace(1.0, 0.0, n + 1)[:-1]

    def stage(self, steps: int, i: int) -> Tuple[np.ndarray, np.ndarray]:
        """(timesteps [steps], sigma deltas [steps]) of stage ``i``, float32."""
        tbl = self.t_stage[i]
        ts = np.linspace(float(tbl[0]), float(tbl[-1]), steps).astype(np.float32)
        sig = np.concatenate([np.linspace(float(self.s_stage[0]), float(self.s_stage[-1]), steps),
                              [0.0]]).astype(np.float32)
        return ts, sig[1:] - sig[:-1]

    def renoise(self, i: int) -> Tuple[float, float]:
        """(alpha, beta) of the renoising before stage ``i``."""
        ori = 1 - self.ori_start[i]
        alpha = 1 / (math.sqrt(1 + 1 / self.gamma) * (1 - ori) + ori)
        return alpha, alpha * (1 - ori) / math.sqrt(self.gamma)


def down2x(x: torch.Tensor) -> torch.Tensor:
    """2x2 mean over the trailing two axes of [b, c, t, h, w]."""
    b, c, t, h, w = x.shape
    return x.reshape(b, c, t, h // 2, 2, w // 2, 2).mean(dim=(4, 6))


def block_noise(z: torch.Tensor, gamma: float) -> torch.Tensor:
    """Correlated noise [b, c, t, 2h, 2w] from iid z [b, c, t, h, w, 4]:
    each 2x2 block ``z @ L^T`` with L the Cholesky factor of
    ``(1 + gamma) I - gamma J``."""
    cov = (1.0 + gamma) * np.eye(4) - gamma * np.ones((4, 4))
    lt = torch.as_tensor(np.linalg.cholesky(cov).T, dtype=torch.float32, device=z.device)
    b, c, t, h2, w2, _ = z.shape
    blocks = (z.to(torch.float32) @ lt).reshape(b, c, t, h2, w2, 2, 2)
    return blocks.permute(0, 1, 2, 3, 5, 4, 6).reshape(b, c, t, 2 * h2, 2 * w2)


def chunk_start_latents(draw: torch.Tensor, n_stages: int) -> torch.Tensor:
    """A chunk's stage-0 noise latents from its full-resolution draw: 2x2
    means, times 2, once per stage below the top."""
    x = draw.to(torch.float32)
    for _ in range(n_stages - 1):
        x = down2x(x) * 2.0
    return x


def pyramid(x: torch.Tensor, n_stages: int) -> List[torch.Tensor]:
    levels = [x]
    for _ in range(n_stages - 1):
        x = down2x(x)
        levels.append(x)
    return list(reversed(levels))


def padded_conditions(p: Dict, clean: List[torch.Tensor], unit: int, fm: bool, rows: int):
    """Per stage (clips, frame times, frame valid) of unit ``unit``;
    ``fm``: the chunk starts from the conditioning image (first chunk)."""
    fm = int(fm)
    t_old = p["max_temporal_length"] - 2
    dev = clean[0].device
    n_stages = len(p["stages"])

    def tile(x):
        return torch.cat([x] * rows, dim=0)

    def vec(values, dtype):
        return torch.tensor(values, dtype=dtype, device=dev)

    def pad_old(n_real):
        b, c, _, h, w = clean[0].shape
        box = clean[0].new_zeros((b, c, t_old, h, w))
        if n_real > 0:
            box[:, :, t_old - n_real:] = clean[0][:, :, fm:fm + n_real]
        ar = torch.arange(t_old, device=dev)
        return tile(box), ar.to(torch.float32) - (t_old - n_real), (ar >= t_old - n_real).to(torch.int32)

    L = clean[0].shape[2]
    out = []
    for s in range(n_stages):
        last = tile(clean[s][:, :, L - 1:L])
        if s < n_stages - 1:
            n_old = max(unit - 1 - fm, 0)
            old, ot, ov = pad_old(n_old)
            clips, times, valid = [old, last], [ot, vec([float(n_old)], torch.float32)], \
                [ov, vec([1], torch.int32)]
            cur = float(n_old + 1)
        else:
            mid_valid = 1 if unit - fm >= 2 else 0
            n_old = max(unit - 2 - fm, 0)
            old, ot, ov = pad_old(n_old)
            mid = tile(clean[s - 1][:, :, L - 2:L - 1]) if mid_valid else \
                tile(torch.zeros_like(clean[s - 1][:, :, :1]))
            clips = [old, mid, last]
            times = [ot, vec([float(n_old)], torch.float32),
                     vec([float(n_old + mid_valid)], torch.float32)]
            valid = [ov, vec([mid_valid], torch.int32), vec([1], torch.int32)]
            cur = float(n_old + mid_valid + 1)
        times.append(vec([cur], torch.float32))
        valid.append(vec([1], torch.int32))
        out.append((clips, times, valid))
    return out


def flow_mask(flow_cache: str, steps: int) -> Tuple[int, ...]:
    """Which steps of a stage run their forward: all (``none``), or the
    even ones (``skip_odd``)."""
    if flow_cache == "none":
        return (1,) * steps
    if flow_cache == "skip_odd":
        return tuple(1 - i % 2 for i in range(steps))
    raise ValueError(f"flow cache {flow_cache!r}: the reference takes 'none' or 'skip_odd'")


def denoise_unit(model: MMDiT, p: Dict, sched: Schedule, start: torch.Tensor,
                 generated: Sequence[torch.Tensor], unit: int, fm: bool, rows: int,
                 text: Tuple[torch.Tensor, ...], history: Optional[torch.Tensor],
                 block_z: Sequence[torch.Tensor], guidance: float, flow_cache: str):
    """The unit's latent at each stage's end and, per stage, which steps
    ran a forward. ``start``: the unit's stage-0 noise; ``generated``: the
    chunk's latents so far (conditioning first); ``text``: (embeds [rows,
    L, Dt], mask [rows, L], pooled [rows, Dp]); ``block_z``: the iid draw
    behind each stage's renoising."""
    n_stages = len(p["stages"])
    dev = start.device
    clean = pyramid(torch.cat([g.to(torch.float32) for g in generated], dim=2), n_stages)
    conds = padded_conditions(p, clean, unit, fm, rows)
    embeds, mask, pooled = text
    hist = hist_mask = None
    if history is not None:
        hist = torch.cat([history.to(torch.float32)] * 3, dim=0)
        r, ps = p["history_downsample_ratio"], model.cfg["patch_size"]
        hlen = (history.shape[-1] // r // ps) * (history.shape[-2] // r // ps)
        hist_mask = torch.cat([torch.zeros((2, hlen), dtype=torch.int32, device=dev),
                               torch.ones((1, hlen), dtype=torch.int32, device=dev)])
    hs = p["history_guidance_scale"]
    lat = start.to(torch.float32)
    outs, ran = [], []
    for s in range(n_stages):
        if s:
            alpha, beta = sched.renoise(s)
            up = lat.repeat_interleave(2, dim=-2).repeat_interleave(2, dim=-1)
            lat = alpha * up + beta * block_noise(block_z[s - 1], sched.gamma)
        ts, dsig = sched.stage(p["num_inference_steps"], s)
        clips, times, valid = conds[s]
        v = None
        for t, ds, run in zip(ts, dsig, flow_mask(flow_cache, len(ts))):
            if run:
                x = torch.cat([lat] * rows, dim=0)
                tt = torch.full((rows,), float(t), dtype=torch.float32, device=dev)
                out = model.forward(list(clips) + [x], embeds, mask, pooled, tt, hist, hist_mask,
                                    p["history_downsample_ratio"], list(times), list(valid))
                v = out[0:1] + guidance * (out[1:2] - out[0:1])
                if rows == 3:
                    v = v + hs * (out[2:3] - out[1:2])
            lat = lat + float(ds) * v
        outs.append(lat)
        ran.append(flow_mask(flow_cache, len(ts)))
    return outs, tuple(ran)


def history_frame(poses: torch.Tensor, n_unit: int):
    """(index, distances, cosines) of the history retrieval over the
    camera-to-world ``poses`` [n, 4, 4] of a rollout's frames, one a unit,
    in float64: the poses relative to the first carried unit's (``n_unit``
    from the end); the distance of each earlier camera to the last one and
    the cosine between their viewing directions (the rotations' third
    columns); the five nearest, and of those the one with the largest
    cosine, the smallest angle."""
    c2w = np.asarray(poses, dtype=np.float64)
    c2w = np.einsum("ij,tjk->tik", np.linalg.inv(c2w[-n_unit]), c2w)
    last_pos, last_fwd = c2w[-1, :3, 3], c2w[-1, :3, 2]
    dist = np.sqrt(((c2w[:-1, :3, 3] - last_pos) ** 2).sum(axis=1))
    cos = (c2w[:-1, :3, 2] * last_fwd).sum(axis=1)
    nearest = np.argsort(dist, kind="stable")[:min(5, len(dist))]
    return int(nearest[np.argmax(np.clip(cos[nearest], -1.0, 1.0))]), dist, cos


def history_pixels(frames: torch.Tensor, disparity: torch.Tensor, scale_frame: torch.Tensor,
                   index: int) -> torch.Tensor:
    """[2, 3, 1, H, W]: the retrieved frame's rgb and its disparity, as the
    encoder takes them: rescaled by the carry's scale (0.95 over the
    largest disparity of ``scale_frame``), square-rooted and mapped to
    [-1, 1]."""
    scale = 1.0 / scale_frame.to(torch.float32).max()
    d = torch.sqrt(disparity[:, :, index:index + 1].to(torch.float32) * scale * 0.95)
    d = (d * 2.0 - 1.0).clamp(-1.0, 1.0)
    return torch.cat([frames[:, :, index:index + 1].to(torch.float32), d])
