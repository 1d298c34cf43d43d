"""The attention kernel's per-tile mask schedule, as its plain rule.

``deepv_tpu_torch.ops.attention.tile_classes`` is the rule that the bf16
kernel (``csrc/attention.cu::attn_fwd_wgmma``) applies at the start of every
CTA: each (query tile, key tile) block is SKIP (no allowed pair), FULL
(every pair allowed, no mask built) or PARTIAL. Checked here against the
dense mask at the rollout's six packed layouts and at random layouts, and
by a blocked f64 emulation that walks the schedule the kernel walks: it
must give the plain result. No JAX, small shapes, a few seconds in all.
"""

import math
import os
import sys

import numpy as np
import pytest
import torch

from deepv_tpu_torch.ops.attention import (BWD_BLOCK, FULL, KERNEL_BLOCK_K, KERNEL_BLOCK_Q,
                                           PARTIAL, SKIP, attention_plain, tile_classes)

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: the forward kernel's tile, a small one, and the backward kernels' (64 own
#: rows against 64-row tiles, on either side)
BLOCKS = [(KERNEL_BLOCK_Q, KERNEL_BLOCK_K), (16, 8), (BWD_BLOCK, BWD_BLOCK)]


def dense_allowed(valid, times):
    return (valid[:, :, None] == valid[:, None, :]) & (times[:, None] >= times[None, :])[None]


def block_reduce(allowed, bq, bk, fill, op):
    """any/all of ``allowed`` [b, S, S] over each (bq, bk) block, with
    positions past S set to ``fill``."""
    b, s, _ = allowed.shape
    nq, nk = -(-s // bq), -(-s // bk)
    padded = torch.full((b, nq * bq, nk * bk), fill, dtype=torch.bool)
    padded[:, :s, :s] = allowed
    blocks = padded.reshape(b, nq, bq, nk, bk)
    return op(op(blocks, dim=4), dim=2)


def assert_exact(valid, times, bq, bk):
    """No SKIP block holds an allowed pair; every FULL block is all-allowed
    (rows past S are not stored, so they do not count; FULL key tiles lie
    inside S)."""
    cls = tile_classes(valid, times, bq, bk)
    allowed = dense_allowed(valid, times)
    any_allowed = block_reduce(allowed, bq, bk, False, torch.any)
    all_allowed = block_reduce(allowed, bq, bk, True, torch.all)
    s = times.shape[0]
    assert cls.shape == (valid.shape[0], -(-s // bq), -(-s // bk))
    assert not bool(any_allowed[cls == SKIP].any()), "a skipped tile holds an allowed pair"
    assert bool(all_allowed[cls == FULL].all()), "a full tile holds a disallowed pair"
    ragged = (torch.arange(1, cls.shape[2] + 1) * bk) > s
    assert not bool((cls[:, :, ragged] == FULL).any()), "a ragged key tile is full"
    return cls


def rollout_masks():
    """(name, valid, times) of the rollout's six packed layouts, built on the
    CPU as chip_smoke.py builds them (masks only, no model)."""
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    import chip_smoke
    from deepv_tpu_torch.config import MMDiTConfig
    from deepv_tpu_torch.models.mmdit import PackedLayout, packed_mask

    out = []
    for name, _, shapes, ctx, ftimes, fvalid in chip_smoke.rollout_layouts(torch.device("cpu")):
        layout = PackedLayout(MMDiTConfig(), shapes, ctx.shape[1])
        valid, times = packed_mask(layout, ctx, ftimes, fvalid)
        out.append((name, valid, times))
    return out


@pytest.fixture(scope="module")
def rollout():
    return rollout_masks()


def test_exact_at_the_rollout_layouts(rollout):
    assert [name for name, _, _ in rollout] == [
        f"stage{s}_b{b}" for b in (2, 3) for s in range(3)]
    for name, valid, times in rollout:
        for bq, bk in BLOCKS:
            cls = assert_exact(valid, times, bq, bk)
        # at the kernel's tile: skipped tiles are 31-41% of all, every
        # class present, every query tile keeps at least its diagonal
        cls = tile_classes(valid, times)
        frac = [float((cls == c).float().mean()) for c in (SKIP, FULL, PARTIAL)]
        assert 0.3 <= frac[0] <= 0.42, (name, frac)
        assert frac[1] > 0 and frac[2] > 0, (name, frac)
        assert bool((cls != SKIP).any(dim=2).all()), name


def random_layout(rng, b, s):
    valid = torch.from_numpy(rng.integers(-1, 3, (b, s)).astype(np.int32))
    if rng.random() < 0.5:                        # runs of equal values, as frames make
        runs = rng.integers(1, 40)
        valid = valid[:, ::runs].repeat_interleave(runs, dim=1)[:, :s].contiguous()
    times = torch.from_numpy(rng.integers(-3, 5, s).astype(np.float32))
    if rng.random() < 0.3:
        times = torch.from_numpy(rng.standard_normal(s).astype(np.float32))
    return valid, times


@pytest.mark.parametrize("seed", range(4))
def test_exact_on_random_layouts(seed):
    """Random valid in {-1, 0, 1, 2} and unsorted times, at S on and off the
    tile grid, at the kernel's tile and a small one."""
    rng = np.random.default_rng(seed)
    for _ in range(10):
        b, s = int(rng.integers(1, 4)), int(rng.integers(1, 400))
        valid, times = random_layout(rng, b, s)
        for bq, bk in BLOCKS:
            assert_exact(valid, times, bq, bk)
    # the uniform layouts: one valid group at one time is all FULL inside S
    valid = torch.ones((2, 256), dtype=torch.int32)
    cls = assert_exact(valid, torch.zeros(256), KERNEL_BLOCK_Q, KERNEL_BLOCK_K)
    assert bool((cls == FULL).all())


def blocked_attention(q, k, v, valid, times, bq, bk):
    """f64 emulation of the kernel's walk: per query tile, the key tiles of
    the schedule in order, an online softmax, the mask built on PARTIAL
    tiles only, SKIP tiles dropped."""
    b, s, h, d = q.shape
    cls = tile_classes(valid, times, bq, bk)
    scale = 1.0 / math.sqrt(d)
    out = torch.empty_like(q)
    for bi in range(b):
        for qt in range(cls.shape[1]):
            rows = slice(qt * bq, min(s, (qt + 1) * bq))
            qq = q[bi, rows].transpose(0, 1)                          # [h, rq, d]
            m = torch.full((h, qq.shape[1], 1), -math.inf, dtype=q.dtype)
            l = torch.zeros((h, qq.shape[1], 1), dtype=q.dtype)
            acc = torch.zeros_like(qq)
            for kt in range(cls.shape[2]):
                c = int(cls[bi, qt, kt])
                if c == SKIP:
                    continue
                keys = slice(kt * bk, min(s, (kt + 1) * bk))
                logits = qq @ k[bi, keys].permute(1, 2, 0) * scale        # [h, rq, rk]
                if c == PARTIAL:
                    allowed = ((valid[bi, rows][:, None] == valid[bi, keys][None, :])
                               & (times[rows][:, None] >= times[keys][None, :]))
                    logits = logits.masked_fill(~allowed[None], -1e30)
                m_new = torch.maximum(m, logits.amax(-1, keepdim=True))
                alpha = torch.exp(m - m_new)
                p = torch.exp(logits - m_new)
                l = l * alpha + p.sum(-1, keepdim=True)
                acc = acc * alpha + p @ v[bi, keys].transpose(0, 1)
                m = m_new
            out[bi, rows] = (acc / l).transpose(0, 1)
    return out


def make(b=2, s=70, h=3, d=16, seed=0):
    """tests/test_torch_port_attention.py's layout (that file imports JAX):
    masked ctx tokens at time 0, then four frames of video tokens."""
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((b, s, h, d)) for _ in range(3))
    valid = np.ones((b, s), np.int32)
    valid[:, 8:12] = 0
    times = np.zeros(s, np.float32)
    n_ctx = 14
    per = (s - n_ctx) // 4
    for f in range(4):
        times[n_ctx + f * per: n_ctx + (f + 1) * per] = f
    times[n_ctx + 4 * per:] = 3
    return q, k, v, valid, times


def split_layout(s=96, n_last=32):
    """Its split layout: padding frames in the prefix and a current unit of
    ``n_last`` tokens with the strictly largest time."""
    q, k, v, valid, times = make(s=s)
    valid[:, 20:30] = 0
    times[-n_last:] = 7.0
    valid[:, -n_last:] = 1
    return q, k, v, valid, times


def attention_case_layouts():
    return [make(s=70), make(s=96), split_layout(n_last=14), split_layout(n_last=32)]


def check_blocked(q, k, v, valid, times, bq, bk):
    t = lambda a: torch.as_tensor(a)
    q, k, v = (t(a).to(torch.float64) for a in (q, k, v))
    valid, times = t(valid), t(times)
    got = blocked_attention(q, k, v, valid, times, bq, bk)
    ref = attention_plain(q, k, v, valid, times)
    torch.testing.assert_close(got, ref, atol=1e-12, rtol=0)


@pytest.mark.parametrize("bq,bk", BLOCKS + [(32, 16)])
def test_skipping_gives_the_plain_result(bq, bk):
    for q, k, v, valid, times in attention_case_layouts():
        check_blocked(q, k, v, valid, times, bq, bk)


def test_skipping_gives_the_plain_result_rollout_shaped(rollout):
    """The smallest rollout layout (stage 0, 2 rows, S = 461) at two heads
    of 8, at the kernel's tile."""
    name, valid, times = rollout[0]
    assert name == "stage0_b2"
    rng = np.random.default_rng(7)
    b, s = valid.shape
    q, k, v = (rng.standard_normal((b, s, 2, 8)) for _ in range(3))
    check_blocked(q, k, v, valid, times, KERNEL_BLOCK_Q, KERNEL_BLOCK_K)


def training_masks():
    """(name, valid, times) of phase 15's training layouts, stages 0-2 at
    b=1, built on the CPU as chip_smoke.py builds them (masks only)."""
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    import chip_smoke
    from deepv_tpu_torch.config import MMDiTConfig
    from deepv_tpu_torch.models.mmdit import PackedLayout, packed_mask

    out = []
    for name, _, shapes, ctx, ftimes, fvalid in chip_smoke.training_layouts(torch.device("cpu")):
        layout = PackedLayout(MMDiTConfig(), shapes, ctx.shape[1])
        valid, times = packed_mask(layout, ctx, ftimes, fvalid)
        out.append((name, valid, times))
    return out


@pytest.fixture(scope="module")
def training():
    return training_masks()


@pytest.mark.parametrize("stage", range(3))
@pytest.mark.parametrize("bq,bk", [(KERNEL_BLOCK_Q, KERNEL_BLOCK_K), (BWD_BLOCK, BWD_BLOCK)])
def test_skipping_gives_the_plain_result_training_shaped(training, stage, bq, bk):
    """The training layouts (b=1, S = 461, 749, 2,093: many 64-row tiles,
    the current unit strictly later than its history) at two heads of 8,
    at the forward's tile and the backward's."""
    name, valid, times = training[stage]
    assert name == f"train_stage{stage}_b1"
    rng = np.random.default_rng(stage)
    b, s = valid.shape
    q, k, v = (rng.standard_normal((b, s, 2, 8)) for _ in range(3))
    check_blocked(q, k, v, valid, times, bq, bk)
