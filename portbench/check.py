"""The check that decides ``correct``: the plain reference (``reference/``)
computes again the work a run's window sampled, from the same inputs,
and each number compared is the relative L2 gap
``|program - reference| / |reference|`` of one kind of work:

  * ``unit.2rows``, ``unit.3rows``: a unit's latent after its last
    stage, from the unit's noise draws, the chunk's latents before it and
    (3 rows) its history latent: the MMDiT forwards (K1, the linears),
    the guidance, the Euler steps and the renoising;
  * ``flow_flags``: the steps whose forward ran, against the
    configuration's flow caching (a count of mismatches, limit 0);
  * ``decode``: the first two windows a chunk streamed, rgb and
    disparity, from the chunk's conditioning latents and its units'
    latents: the streamed decode, and after a boundary the primed one;
  * ``encode.image``, ``encode``: the VAE encoder's posterior moments
    (mean and log-variance) of a rollout's image and of a boundary's
    carried pixels. The moments and not the sampled latents: with these
    weights the draw's ``std * eps`` is about 15 times the mean, so a gap
    of the latents would read the draw, which both sides share, and not
    the encoder;
  * ``history_index``: whether the frame the program retrieved at a
    boundary is the one the retrieval rule picks from the rollout's
    camera poses (0 where it is, or ties it to rounding; limit 0);
    ``history``: the moments of the frame the rule picks, its pixels
    prepared by the reference, against those the program encoded.

Where the run is a served one, the rgb frames compared are those the
client received. The control (``control_numbers``) puts the reference,
computed one precision below the configuration's, in the program's
place.
"""

from __future__ import annotations

import gc
from typing import Dict, Optional

import torch

from .inputs import NEGATIVE, action_embeds
from .reference.mmdit import MMDiT
from .reference.numerics import Numerics, precise
from .reference.params import make_params, split_tree
from .reference.rollout import (Schedule, chunk_start_latents, denoise_unit, history_frame,
                                history_pixels)
from .reference.vae import VAE, LatentCodec
from .stats import rel_l2

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
#: a retrieved frame ties the rule's where its distance and cosine lie
#: within this of the rule's (the program computes the poses in float32)
TIE = 1e-5


class Checker:
    """The reference's models on the run's weights, drawn again from its
    seed, and the outputs it computes for a run's samples."""

    def __init__(self, config: Dict, seed: int, weights_seed: int, device):
        self.config = config
        self.device = torch.device(device)
        s = config["serving"]
        params = make_params(config, weights_seed, DTYPES[s["dtype"]], self.device)
        num = Numerics(config["numerics"]["reference"], config["numerics"]["int8_min_h"])
        self.mmdit = MMDiT(config["transformer"], split_tree(params, "mmdit"), num)
        self.vae = VAE(config["vae"], split_tree(params, "vae"), num)
        del params
        self.p = dict(config["pipeline"])
        self.sched = Schedule(self.p["scheduler"])
        self.codec = LatentCodec(self.vae, self.p, s["encode_window"])
        t = config["transformer"]
        self.embeds = action_embeds(seed, s["text_len"], t["joint_attention_dim"],
                                    t["pooled_projection_dim"])

    def set_mode(self, mode: str) -> None:
        num = Numerics(mode, self.config["numerics"]["int8_min_h"])
        self.mmdit.num = self.vae.num = num

    def _text(self, prompt: str, rows: int):
        fields = ("prompt_embeds", "prompt_attention_mask", "pooled_prompt_embeds")
        neg, pos = ([torch.as_tensor(self.embeds[k][f], device=self.device) for f in fields]
                    for k in (NEGATIVE, prompt))
        return tuple(torch.cat([n] + [q] * (rows - 1)) for n, q in zip(neg, pos))

    def outputs(self, samples: Dict) -> Dict[str, object]:
        """The reference's result for each sample kept."""
        out = {}
        flow = self.config["serving"]["flow_cache"]
        n_stages = len(self.p["stages"])
        with precise(), torch.no_grad():
            for rows in (2, 3):
                u = samples[f"unit{rows}"].item
                if u is None:
                    continue
                start = chunk_start_latents(u.chunk.draw, n_stages)[:, :, u.unit:u.unit + 1]
                lats, ran = denoise_unit(self.mmdit, self.p, self.sched, start, u.generated,
                                         u.unit, u.chunk.first, u.rows, self._text(u.prompt, rows),
                                         u.history, u.block_z, self.p["video_guidance_scale"],
                                         flow)
                out[f"unit.{rows}rows"] = (lats[-1], ran)
            d = samples["decode"].item
            if d is not None:
                out["decode"] = [self.codec.decode_stream(d.conditioning, d.units, d.first, s)
                                 for s in (0, 1)]
            for key in ("encode.image", "encode"):
                e = samples[key].item
                if e is not None:
                    px = e.image if e.disparity is None else torch.cat([e.image, e.disparity])
                    out[key] = self.codec.moments(px.to(self.device))
            h = samples["history"].item
            if h is not None:
                index, dist, cos = history_frame(h.poses, h.n_unit)
                out["history_index"] = (index, dist, cos)
                px = history_pixels(h.frames, h.disparity, h.scale_frame, index)
                out["history"] = self.codec.moments(px.to(self.device))
        return out

    def release(self) -> None:
        self.mmdit = self.vae = self.codec = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()


def _cat_frames(frames) -> torch.Tensor:
    return torch.cat([f.reshape(-1).to("cpu", torch.float64) for f in frames])


def program_numbers(samples: Dict, ref: Dict,
                    client_rgb: Optional[Dict[int, torch.Tensor]] = None) -> Dict[str, float]:
    """The gaps of the program's sampled work to the reference's."""
    nums = {}
    mism = 0
    for rows in (2, 3):
        key = f"unit.{rows}rows"
        if key in ref:
            u = samples[f"unit{rows}"].item
            nums[key] = rel_l2(u.out, ref[key][0])
            mism += sum(len(a) != len(b) or any(x != y for x, y in zip(a, b))
                        for a, b in zip(u.ran, ref[key][1]))
    if any(k.startswith("unit.") for k in nums):
        nums["flow_flags"] = float(mism)
    if "decode" in ref:
        d = samples["decode"].item
        rgb = [client_rgb.get(i, f[0]) if client_rgb else f[0]
               for f, i in zip(d.frames, d.deliveries)]
        got = _cat_frames(rgb + [f[1] for f in d.frames])
        want = _cat_frames(ref["decode"][0] + ref["decode"][1])
        nums["decode"] = rel_l2(got.to(want.device), want)
    for key in ("encode.image", "encode", "history"):
        if key in ref:
            nums[key] = rel_l2(samples[key].item.moments, ref[key])
    if "history_index" in ref:
        nums["history_index"] = float(not same_frame(samples["history"].item.index,
                                                     *ref["history_index"]))
    return nums


def same_frame(got: int, want: int, dist, cos) -> bool:
    """Whether frame ``got`` is the rule's ``want`` or ties it: as near
    as the fifth nearest and turning as little as ``want``, to ``TIE``."""
    if got == want:
        return True
    if not 0 <= got < len(dist):
        return False
    fifth = float(sorted(dist)[min(5, len(dist)) - 1])
    return dist[got] <= fifth * (1 + TIE) + TIE and cos[got] >= cos[want] - TIE


def control_numbers(ref: Dict, control: Dict) -> Dict[str, float]:
    """The gaps of the control's outputs to the reference's, as
    ``program_numbers`` reads the program's."""
    nums = {}
    for key in ref:
        if key == "history_index":
            continue
        if key.startswith("unit."):
            nums[key] = rel_l2(control[key][0], ref[key][0])
        elif key == "decode":
            nums[key] = rel_l2(_cat_frames(control[key][0] + control[key][1]),
                               _cat_frames(ref[key][0] + ref[key][1]))
        else:
            nums[key] = rel_l2(control[key], ref[key])
    return nums


def describe(samples: Dict) -> Dict[str, str]:
    """Where each sampled unit lies: its index in its chunk and whether the
    chunk is a rollout's first (the gap depends on both)."""
    out = {}
    for rows in (2, 3):
        u = samples[f"unit{rows}"].item
        if u is not None:
            out[f"unit.{rows}rows"] = f"unit {u.unit} of a {'first' if u.chunk.first else 'later'} chunk"
    return out


def judge(nums: Dict[str, float], limits: Dict[str, float], required=()) -> Dict[str, Dict]:
    """Each number beside its limit; a required number that is missing
    reads as failed (value None)."""
    out = {}
    for key in list(required) + [k for k in nums if k not in required]:
        out[key] = {"value": nums.get(key), "limit": limits.get(key)}
    return out


def passed(checks: Dict[str, Dict]) -> bool:
    return bool(checks) and all(c["value"] is not None and c["limit"] is not None
                                and c["value"] <= c["limit"] for c in checks.values())
