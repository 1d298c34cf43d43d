"""Operations and bytes of the work a run does, from shapes alone.

  * K1, the packed masked attention: ``4 * h * d`` operations for each
    allowed (query, key) pair (the q.k product and the p.v product, two
    operations a multiply-add), and the bytes of q, k, v read once and the
    output written once, with the mask's two vectors.
  * The MMDiT forward's model operations: every linear layer densely, the
    attention over its allowed pairs only.
  * The VAE's model operations: every convolution densely over its
    output, the linears and products of the mid block's attention; counted
    by running the reference VAE on ``meta`` tensors with a counting
    arithmetic, once per window shape and mode.

W8A8 and int8 products count as the same model operations as their
float originals. Peaks are in ``peaks.json``.
"""

from __future__ import annotations

import functools
import json
import math
import os
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .reference.params import vae_leaves
from .reference.vae import VAE

HERE = os.path.dirname(os.path.abspath(__file__))


def peaks(kind: str) -> Dict[str, float]:
    """The published peaks of the device ``kind`` (``peaks.json``), or
    its default entry's where the kind is not listed."""
    with open(os.path.join(HERE, "peaks.json")) as f:
        table = json.load(f)
    return table.get(kind, table["default"])


# ---------------------------------------------------------------------------
# K1
# ---------------------------------------------------------------------------

def pairs_of(valid: np.ndarray, times: np.ndarray) -> int:
    """Allowed (query, key) pairs of one row: same validity id and the
    key's time not after the query's. ``valid`` [S] ints, ``times`` [S]."""
    total = 0
    for v in np.unique(valid):
        t = np.sort(times[valid == v])
        total += int(np.searchsorted(t, t, side="right").sum())
    return total


def allowed_pairs(valid, times) -> int:
    """Allowed pairs of every row of ``valid`` [b, S] under ``times`` [S]."""
    valid = np.asarray(valid.cpu() if isinstance(valid, torch.Tensor) else valid)
    times = np.asarray(times.cpu() if isinstance(times, torch.Tensor) else times, np.float64)
    return sum(pairs_of(valid[i], times) for i in range(valid.shape[0]))


def attention_cost(b: int, s: int, heads: int, head_dim: int, pairs: int,
                   elem_bytes: int = 2) -> Tuple[float, float]:
    """(operations, bytes) of one K1 call: [b, S, heads, head_dim] q, k, v
    and output, ``pairs`` allowed pairs over all rows."""
    ops = 4.0 * pairs * heads * head_dim
    nbytes = 4.0 * b * s * heads * head_dim * elem_bytes + b * s * 4 + s * 4
    return ops, nbytes


def roofline_seconds(ops: float, nbytes: float, peak_ops: float, peak_bytes: float) -> float:
    """The least time of the work: the larger of its two bounds."""
    return max(ops / peak_ops, nbytes / peak_bytes)


# ---------------------------------------------------------------------------
# the MMDiT forward
# ---------------------------------------------------------------------------

def forward_layout(p: Dict, t: Dict, lat_hw: Tuple[int, int], unit: int, fm: bool,
                   stage: int) -> Tuple[List[int], np.ndarray, np.ndarray]:
    """(tokens per clip, per-token frame valid, per-token time) of the
    video part of a forward at ``stage`` of unit ``unit``: the shape-stable
    condition layout of the rollout (``reference.rollout.padded_conditions``)
    then the current unit, at the stage's resolution."""
    n_stages = len(p["stages"])
    ps = t["patch_size"]
    t_old = p["max_temporal_length"] - 2
    fm = int(fm)

    def tokens(s):
        f = 2 ** (n_stages - 1 - s)
        return (lat_hw[0] // f // ps) * (lat_hw[1] // f // ps)

    frames: List[Tuple[int, int, float]] = []    # (tokens, valid, time) per frame
    if stage < n_stages - 1:
        n_old = max(unit - 1 - fm, 0)
        frames += [(tokens(0), int(i >= t_old - n_old), float(i - (t_old - n_old)))
                   for i in range(t_old)]
        frames.append((tokens(stage), 1, float(n_old)))
        cur = n_old + 1
        clip_frames = [t_old, 1, 1]
    else:
        mid = 1 if unit - fm >= 2 else 0
        n_old = max(unit - 2 - fm, 0)
        frames += [(tokens(0), int(i >= t_old - n_old), float(i - (t_old - n_old)))
                   for i in range(t_old)]
        frames.append((tokens(stage - 1), mid, float(n_old)))
        frames.append((tokens(stage), 1, float(n_old + mid)))
        cur = n_old + mid + 1
        clip_frames = [t_old, 1, 1, 1]
    frames.append((tokens(stage), 1, float(cur)))
    valid = np.concatenate([np.full(n, v, np.int64) for n, v, _ in frames])
    times = np.concatenate([np.full(n, tm, np.float64) for n, _, tm in frames])
    per_clip, k = [], 0
    for nf in clip_frames:
        per_clip.append(sum(n for n, _, _ in frames[k:k + nf]))
        k += nf
    return per_clip, valid, times


def mmdit_forward_ops(t: Dict, rows: int, video: int, ctx: int, text: int, history: int,
                      pairs: int) -> float:
    """Model operations of one forward over ``rows`` rows: ``video`` video
    tokens and ``ctx`` = ``text`` + ``history`` context tokens a row,
    ``pairs`` allowed attention pairs over all rows (in each layer)."""
    d = t["num_attention_heads"] * t["attention_head_dim"]
    n, ps, c = t["num_layers"], t["patch_size"], t["in_channels"]
    per_row = (256 * d + d * d + t["pooled_projection_dim"] * d + d * d   # time, text embed
               + text * t["joint_attention_dim"] * t["caption_projection_dim"]
               + (history + video) * c * ps * ps * d                       # patch projections
               + (n - 1) * (12 * d * d) + 8 * d * d                         # AdaLN
               + video * 12 * d * d * n                                     # hidden stream
               + ctx * (12 * d * d * (n - 1) + 3 * d * d)                   # context stream
               + 2 * d * d + video * d * ps * ps * c)                       # norm_out, proj_out
    return 2.0 * rows * per_row + 4.0 * pairs * d * n


def unit_ops(p: Dict, t: Dict, lat_hw: Tuple[int, int], unit: int, fm: bool, rows: int,
             text_tokens: Sequence[int], ran: Sequence[Sequence[int]]) -> Tuple[float, list]:
    """(model operations, per-forward (b, S, pairs)) of one unit whose
    stage s ran ``sum(ran[s])`` forwards; ``text_tokens``: each row's valid
    text tokens (the mask's ones) of ``L`` = ``p["text_len"]``."""
    text_len = p["text_len"]
    hist = 0
    if rows == 3:
        r = p["history_downsample_ratio"]
        hist = (lat_hw[0] // r // t["patch_size"]) * (lat_hw[1] // r // t["patch_size"])
    total, calls = 0.0, []
    for s, flags in enumerate(ran):
        per_clip, fvalid, ftimes = forward_layout(p, t, lat_hw, unit, fm, s)
        video = sum(per_clip)
        pairs = 0
        for r_i in range(rows):
            ctx_valid = np.zeros(hist + text_len, np.int64)
            if hist and r_i == 2:
                ctx_valid[:hist] = 1
            ctx_valid[hist:hist + text_tokens[r_i]] = 1
            valid = np.concatenate([ctx_valid, fvalid])
            times = np.concatenate([np.zeros(hist + text_len), ftimes])
            pairs += pairs_of(valid, times)
        n_fwd = int(sum(flags))
        total += n_fwd * mmdit_forward_ops(t, rows, video, hist + text_len, text_len, hist,
                                           pairs)
        calls += [(rows, hist + text_len + video, pairs)] * n_fwd
    return total, calls


# ---------------------------------------------------------------------------
# the VAE
# ---------------------------------------------------------------------------

class _Counting:
    """The reference's arithmetic on ``meta`` tensors, counting model
    operations."""

    def __init__(self):
        self.ops = 0.0

    def linear(self, x, w, b, quantised=False):
        self.ops += 2.0 * (x.numel() // x.shape[-1]) * w.shape[0] * w.shape[1]
        return x @ w.t()

    def matmul(self, a, b):
        self.ops += 2.0 * math.prod(a.shape) * b.shape[-1]
        return a @ b

    def conv3d(self, xp, w, b, stride=(1, 1, 1)):
        kh, kw = w.shape[3], w.shape[4]
        y = F.conv3d(xp, w, stride=stride, padding=(0, kh // 2, kw // 2))
        self.ops += 2.0 * y.numel() * math.prod(w.shape[1:])
        return y


@functools.lru_cache(maxsize=None)
def _meta_vae(vae_json: str) -> VAE:
    v = json.loads(vae_json)
    params = {n[len("vae."):] if n.startswith("vae.") else n: torch.empty(s, device="meta")
              for n, s, _ in vae_leaves(v)}
    return VAE(v, params, _Counting())


@functools.lru_cache(maxsize=None)
def vae_ops(vae_json: str, kind: str, shape: Tuple[int, ...], mode: str = "full") -> float:
    """Model operations of one VAE call on one stream: ``kind`` "decode"
    (a window of latents [1, z, t, h, w] in ``mode``), "prime" (priming
    from latents of that shape) or "encode" (pixels [1, 3, T, H, W],
    windowed as the rollout encodes them)."""
    vae = _meta_vae(vae_json)
    vae.num = counter = _Counting()
    x = torch.empty(shape, device="meta")
    if kind == "decode":
        cache = None
        if mode == "cont":
            # a cache of the right shapes: the same window decoded in init mode
            _, cache = vae.decode_window(x, None, "init")
            counter.ops = 0.0
        vae.decode_window(x, cache, mode)
    elif kind == "prime":
        vae.prime_warm(x)
    elif kind == "encode":
        vae.encode(x)
    else:
        raise ValueError(f"unknown VAE call {kind!r}")
    return counter.ops


def vae_key(v: Dict) -> str:
    """The VAE configuration as the cache key of ``vae_ops``."""
    return json.dumps(v, sort_keys=True)
