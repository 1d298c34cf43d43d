"""The counting arithmetic against hand counts at tiny sizes, and K1's
against the repo's chip smoke at its representative stage-2 shape."""

import json
import os

import numpy as np
import pytest
import torch

from portbench import counting
from portbench.reference.mmdit import MMDiT
from portbench.reference.params import mmdit_leaves
from portbench.reference.rollout import padded_conditions, pyramid
from portbench.tests import tiny

ROOT = tiny.ROOT


def test_pairs_by_hand():
    # text tokens at time 0 (two valid, one masked), frames at times 1, 2
    valid = np.array([1, 1, 0, 1, 1, 1, 0])
    times = np.array([0, 0, 0, 1, 1, 2, 2], np.float64)
    # valid 1: times 0,0,1,1,2 -> each query sees keys with time <= its own:
    # 2 + 2 + 4 + 4 + 5 = 17; valid 0: times 0, 2 -> 1 + 2 = 3
    assert counting.pairs_of(valid, times) == 20
    v2 = np.stack([valid, np.ones(7, int)])
    assert counting.allowed_pairs(v2, times) == 20 + (3 * 3 + 2 * 5 + 2 * 7)


def test_attention_cost_by_hand():
    ops, nbytes = counting.attention_cost(2, 10, 3, 4, pairs=50, elem_bytes=2)
    assert ops == 4 * 50 * 3 * 4
    assert nbytes == 4 * 2 * 10 * 3 * 4 * 2 + 2 * 10 * 4 + 10 * 4
    assert counting.roofline_seconds(1e12, 1e9, 1e12, 1e12) == 1.0


def _chip_smoke_stage2_pairs():
    """K1's allowed pairs as chip_smoke.py counts them (``check_attention``:
    ``allowed.sum()`` over its ``rollout_layouts``), stage 2 at 2 and 3
    rows."""
    import chip_smoke
    from deepv_tpu_torch.config import MMDiTConfig
    from deepv_tpu_torch.models.mmdit import PackedLayout, packed_mask

    out = {}
    for name, b, shapes, ctx, ftimes, fvalid in chip_smoke.rollout_layouts("cpu"):
        if name.startswith("stage2"):
            layout = PackedLayout(MMDiTConfig(), shapes, ctx.shape[1])
            valid, times = packed_mask(layout, ctx, ftimes, fvalid)
            allowed = ((valid[:, :, None] == valid[:, None, :])
                       & (times[:, None] >= times[None, :])[None])
            out[b] = (int(allowed.sum()), layout.seq_len, valid, times)
    return out


def test_k1_operations_agree_with_chip_smoke_at_stage_2():
    import sys
    sys.path.insert(0, ROOT)
    smoke = _chip_smoke_stage2_pairs()
    cfg = json.load(open(os.path.join(ROOT, "portbench", "configs", "deepverse1.1-exact.json")))
    t, p = cfg["transformer"], dict(cfg["pipeline"], text_len=77)
    h, d = t["num_attention_heads"], t["attention_head_dim"]
    for rows, unit, fm in ((2, 3, True), (3, 5, False)):
        pairs_smoke, s, valid, times = smoke[rows]
        assert counting.allowed_pairs(valid, times) == pairs_smoke
        # the same count from the layout alone, as a run counts it: the text
        # masks of chip_smoke's embeddings ('empty', then the first action)
        toks = [2] + [max(2, min(77, 2 + len("Stay where you are. The perspective hasn't changed.") // 6))] * (rows - 1)
        _, calls = counting.unit_ops(p, t, (48, 64), unit, fm, rows, toks, [(1,), (1,), (1,)])
        b, seq, pairs = calls[2]
        assert (b, seq, pairs) == (rows, s, pairs_smoke)
        ops, _ = counting.attention_cost(rows, s, h, d, pairs)
        # chip_smoke.py: flops = 4 * pairs * h * d
        assert ops == 4 * pairs_smoke * h * d


def test_mmdit_forward_ops_against_a_counted_forward():
    """The formula against the reference forward on meta tensors with a
    counting arithmetic (every product counted densely, attention
    included) minus the dense attention plus the allowed pairs."""
    cfg = tiny.config()
    t, p = cfg["transformer"], dict(cfg["pipeline"], text_len=77)
    params = {n: torch.empty(s, device="meta") for n, s, _ in mmdit_leaves(t)}
    counter = counting._Counting()
    model = MMDiT(t, params, counter)
    model.p = params
    rows, unit, fm, lat = 3, 5, False, (8, 8)
    gen = torch.zeros((1, t["in_channels"], unit + 1, 8, 8))
    conds = padded_conditions(p, pyramid(gen, 3), unit, fm, rows)
    clips, times, valid = conds[2]
    hlen = (8 // 2 // 2) * (8 // 2 // 2)
    text_tok = [2, 9, 9]
    mask = torch.zeros((rows, 77), dtype=torch.int32)
    for r, n in enumerate(text_tok):
        mask[r, :n] = 1
    hist_mask = torch.tensor([[0] * hlen, [0] * hlen, [1] * hlen], dtype=torch.int32)
    meta = lambda *s: torch.empty(s, device="meta")
    x = meta(rows, t["in_channels"], 1, 8, 8)
    model.attention = lambda q, k, v, valid_, times_: _dense(counter, q, k, v)
    on_meta = lambda v: torch.empty_like(v, device="meta")
    model.forward([meta(*c.shape) for c in clips] + [x], meta(rows, 77, t["joint_attention_dim"]),
                  on_meta(mask), meta(rows, t["pooled_projection_dim"]), meta(rows),
                  meta(rows, t["in_channels"], 1, 8, 8), on_meta(hist_mask), 2,
                  [on_meta(v) for v in times], [on_meta(v) for v in valid])
    total, calls = counting.unit_ops(p, t, lat, unit, fm, rows, text_tok, [(0,), (0,), (1,)])
    _, seq, pairs = calls[0]
    d = t["num_attention_heads"] * t["attention_head_dim"]
    n = t["num_layers"]
    dense_attention = n * 4.0 * rows * seq * seq * d
    assert total == pytest.approx(counter.ops - dense_attention + n * 4.0 * pairs * d, rel=1e-12)


def _dense(counter, q, k, v):
    b, s, h, d = q.shape
    counter.ops += 4.0 * b * s * s * h * d
    return torch.empty_like(q)


def test_vae_conv_ops_by_hand():
    """One decode window of the tiny VAE in cont mode, counted by hand:
    2 * taps * ci * co over each conv's output, plus the mid block's
    attention products."""
    v = tiny.config()["vae"]
    key = counting.vae_key(v)
    got = counting.vae_ops(key, "decode", (1, 4, 1, 8, 8), "cont")
    ch = v["decoder_block_out_channels"]         # [8, 8, 16, 16]
    g = lambda taps, ci, co, n: 2.0 * taps * ci * co * n
    ops = 0.0
    px = 8 * 8
    ops += g(1, 4, 4, px)                         # post_quant_conv
    ops += g(27, 4, 16, px)                       # conv_in
    ops += 4 * g(27, 16, 16, px)                  # mid block: 2 resnets x 2 convs
    ops += 4 * 2.0 * px * 16 * 16 + 2 * 2.0 * px * px * 16   # its attention
    t, hw, c = 1, px, 16
    for i, co in enumerate(reversed(ch)):        # up blocks 16, 16, 8, 8
        ci = c
        ops += g(27, ci, co, t * hw) + g(27, co, co, t * hw)
        if ci != co:
            ops += g(1, ci, co, t * hw)
        c = co
        if v["decoder_spatial_up_sample"][i]:
            ops += g(27, co, 4 * co, t * hw)
            hw *= 4
        if v["decoder_temporal_up_sample"][i]:
            ops += g(27, co, 2 * co, t * hw)
            t *= 2
    ops += g(27, ch[0], 3, t * hw)                # conv_out
    assert got == pytest.approx(ops, rel=1e-12)
