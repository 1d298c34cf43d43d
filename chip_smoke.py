#!/usr/bin/env python3
"""Smoke run of the PyTorch port (deepv_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero before the last line:
  1. device: requires CUDA; prints the card's name and power limit;
  2. build: compiles every kernel of the main path from deepv_tpu_torch/csrc
     with nvcc for sm_90a, one nvcc per source, all started together, and
     prints the build times and ptxas reports;
  3. attention kernel (K1) against its plain PyTorch version on the card:
     first a one-hot P check (each token its own valid group, so the bf16
     output must equal V exactly), then the rollout's packed layouts of
     pyramid stages 0, 1 and 2 with 2 CFG rows (chunk 1) and 3 rows plus
     history (chunk 2), then edge layouts that reach every branch of the
     kernel's mask schedule (S < 64, mask-free, per-token valid, time-skipped
     tiles mid-sequence); f32 at atol 2e-5 / rtol 1e-4, bf16 at atol 3e-2 /
     rtol 3e-2 and within 2e-3 plus 2^-8 of the value of an f32 evaluation
     of the same inputs. At the rollout's layouts it times the kernel, the
     plain version and SDPA with the same boolean mask (a yardstick the port
     never calls), beside the least time the card needs, counts the tile
     classes, and sums K1, SDPA and the bound over the rollout's launches;
  4. igemm conv kernel (K2) against its plain PyTorch version at every
     eligible 3x3x3 conv shape of the full-width VAE, in the causal mode the
     rollout uses there, 1-2 output frames, at the channels-last input the
     rollout hands the gather kernel, and at three edge shapes (w not a
     multiple of 64; w % 8 != 0; batch 2 with 3 frames): f32 at atol 2e-4 /
     rtol 1e-4 (tests/test_conv_igemm.py:33), bf16 within one bf16 ulp of
     the larger value plus that 2e-4 (the two sum the same exact products
     in f32 in other orders, then round once). Times the wrapper, its
     layout work alone (the weight re-layout), the plain version and
     F.conv3d (cuDNN, a yardstick the igemm path never calls), beside the
     least time. After phase 7 it prints K2, cuDNN and the bound summed
     over the igemm rollout's convs by class;
  5. main path: run.load_pipeline with random weights at full width
     (MMDiTConfig(): 24 layers, d=1536; VAEConfig()) in bf16, and generate()
     on an 11-action prompt at 384x512 (2 chunks, 89 frames, 12 units:
     history CFG, boundary priming, carry re-encode). The kernels' launch
     counts are set to 0 just before and read just after: K1 launches 4,320
     times (its bf16 kernel; the per-layout launches of phase 3 add up to
     it), its f32 kernel and K2 never (the default conv is F.conv3d);
  6. forward check: one full-width denoise forward at the stage-2, 3-row
     layout in f32 with K1's f32 kernel against the same forward with the
     plain attention;
  7. igemm path: the same rollout through InferencePipeline with
     VAEConfig(conv_impl="igemm") and the same weights, image, prompt and
     seed; counts set to 0 just before and read just after: K1 4,320 and K2
     (its wgmma and gather kernels together; the f32 kernel never) exactly
     the count the phase counts imply;
  8. decode check: one latent stream decoded at full width through an init
     window, a cont window and a primed cont window, with "igemm" and with
     "xla": f32 (TF32 off) within 1e-4 relative L2, bf16 within twice the
     relative L2 between the bf16 and f32 "xla" decodes of the same latents.
The line before the last is a JSON object {"kernels": [...]}; the last line
is {"ok": true, "device": {...}}. Extra detail goes to chiprun_out/.
"""

from __future__ import annotations

import gc
import json
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

HERE = os.path.dirname(os.path.abspath(__file__))
PROMPT = "(FN)(FN)(FN)(FN)(FN)(FN)(FN)(fRL)(SR)(BL)(FN)"
HEIGHT, WIDTH = 384, 512
#: dense peaks of one H100 SXM (NVIDIA data sheet) at its 700 W limit
PEAK_BF16_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12
SOURCES = ("attention.cu", "conv_igemm.cu")

#: every eligible 3x3x3 conv class of the full-width rollout (VAEConfig() at
#: 384x512): (layer, causal mode the rollout runs it in, ci, co, h, w,
#: output frames of the check)
CONV_CASES = (
    ("decoder mid block, up block 0 resnets", "init", 512, 512, 48, 64, 1),
    ("decoder mid block, up block 0 resnets", "cont", 512, 512, 48, 64, 1),
    ("decoder up block 0 spatial up-sampler", "cont", 512, 2048, 48, 64, 1),
    ("decoder up block 0 temporal up-sampler", "cont", 512, 1024, 96, 128, 1),
    ("decoder up block 1 resnets", "cont", 512, 512, 96, 128, 2),
    ("decoder up block 1 spatial up-sampler", "cont", 512, 2048, 96, 128, 2),
    ("decoder up block 1 temporal up-sampler", "cont", 512, 1024, 192, 256, 2),
    ("decoder up block 2 resnet 0 conv1", "cont", 512, 256, 192, 256, 2),
    ("decoder up block 2 resnets", "cont", 256, 256, 192, 256, 2),
    ("decoder up block 2 spatial up-sampler", "cont", 256, 1024, 192, 256, 2),
    ("decoder up block 2 temporal up-sampler", "cont", 256, 512, 384, 512, 1),
    ("decoder up block 3 resnet 0 conv1", "prime", 256, 128, 384, 512, 2),
    ("decoder up block 3 resnets", "prime", 128, 128, 384, 512, 2),
    ("decoder up block 3 resnets", "cont", 128, 128, 384, 512, 2),
    ("encoder down block 0 resnets", "full", 128, 128, 384, 512, 1),
    ("encoder down block 1 resnet 0 conv1", "full", 128, 256, 192, 256, 1),
    ("encoder down block 1 resnets", "init", 256, 256, 192, 256, 2),
    ("encoder down block 2 resnet 0 conv1", "cont", 256, 512, 96, 128, 1),
    ("encoder down block 2 resnets", "full", 512, 512, 96, 128, 2),
    ("encoder down block 3, mid block resnets", "cont", 512, 512, 48, 64, 1),
)
#: K2 cases beyond CONV_CASES: (name, mode, ci, co, h, w, output frames,
#: batch, x channels-last). The first is on the rollout's path: the
#: encoder's mid-block resnet after its attention block gets x channels-last
#: in full mode (the first image and the history frames), which TMA cannot
#: read along w, so it runs the gather kernel. The rest are shapes the
#: rollout does not run but K2 must take.
CONV_EDGE_CASES = (
    ("encoder mid block resnet after attention", "full", 512, 512, 48, 64, 1, 1, True),
    ("edge: w not a multiple of 64", "cont", 128, 128, 48, 80, 2, 1, False),
    ("edge: w % 8 != 0 (gather kernel)", "full", 128, 128, 6, 10, 1, 1, False),
    ("edge: batch 2, 3 frames", "full", 256, 256, 96, 128, 3, 2, False),
)
#: K2's launch counters: the wgmma kernel, the gather kernel, the f32 kernel
K2_COUNTERS = ("launches", "gather_launches", "f32_launches")


def log(*args):
    print(*args, flush=True)


def cuda_time_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back calls."""
    import torch
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def rollout_layouts(device):
    """(name, rows, clip shapes, ctx_valid, frame times, frame valid) of the
    packed attention the rollout runs: every pyramid stage, for a chunk-1
    unit (2 rows, no history) and a chunk-2 unit (3 rows, history)."""
    import torch
    from deepv_tpu_torch.actions import action_vocabulary
    from deepv_tpu_torch.config import MMDiTConfig, PipelineConfig
    from deepv_tpu_torch.io.text_embeds import random_text_embeds
    from deepv_tpu_torch.pipeline import _pyramid_list, padded_conditions

    mcfg, pcfg = MMDiTConfig(), PipelineConfig()
    embeds = random_text_embeds(0, action_vocabulary(), joint_dim=8, pooled_dim=8)
    neg = torch.as_tensor(embeds["empty"]["prompt_attention_mask"], device=device)
    pos = torch.as_tensor(embeds[action_vocabulary()[1]]["prompt_attention_mask"],
                          device=device)
    lh, lw = HEIGHT // pcfg.vae_downsample, WIDTH // pcfg.vae_downsample
    out = []
    # chunk 1, unit 3 (first-frame mask: padding frames in the old clip);
    # chunk 2, unit 5 (carried frames, history rows)
    for rows, unit, fm in ((2, 3, True), (3, 5, False)):
        gen = torch.zeros((1, mcfg.in_channels, unit + int(fm), lh, lw), device=device)
        conds = padded_conditions(pcfg, _pyramid_list(gen, len(pcfg.stages) - 1), unit, fm, rows)
        ctx = torch.cat([neg] + [pos] * (rows - 1))
        if rows == 3:
            hlen = (lh // 2 // mcfg.patch_size) * (lw // 2 // mcfg.patch_size)
            hist = torch.tensor([[0], [0], [1]], dtype=ctx.dtype, device=device).expand(3, hlen)
            ctx = torch.cat([hist, ctx], dim=1)
        for s, (clips, times, valid) in enumerate(conds):
            shapes = [tuple(c.shape[2:]) for c in clips] + [tuple(clips[-1].shape[2:])]
            times = list(times)
            valid = list(valid)
            out.append((f"stage{s}_b{rows}", rows, shapes, ctx, times, valid))
    return out


def attention_edge_layouts(device, gen):
    """(name, valid [2, S], times, what the tile classes must show) of K1's
    edge layouts, which reach every branch of its mask schedule."""
    import torch
    b, out = 2, []
    s = 37                                    # S < 64: one ragged key tile
    out.append(("edge: S=37", torch.ones((b, s), dtype=torch.int32, device=device),
                torch.zeros(s, device=device), "partial"))
    s = 768                                   # mask-free: every tile full
    out.append(("edge: mask-free S=768", torch.ones((b, s), dtype=torch.int32, device=device),
                torch.zeros(s, device=device), "full"))
    s = 1000                                  # per-token valid: most tiles partial
    valid = torch.randint(0, 2, (b, s), generator=gen, device=device, dtype=torch.int32)
    times = torch.arange(s, device=device).div(200, rounding_mode="floor").float()
    out.append(("edge: per-token valid S=1000", valid, times, "partial"))
    s = 1000                                  # time-skipped tiles in the middle of the keys
    times = torch.zeros(s, device=device)
    times[300:700] = 5.0
    times[700:] = -1.0
    out.append(("edge: middle skip S=1000", torch.ones((b, s), dtype=torch.int32, device=device),
                times, "middle"))
    return out


def check_attention_bf16(name, q, k, v, valid, times, n_last=0):
    """K1 in f32 and bf16 against the plain version, at the stated
    tolerances; returns the errors."""
    import torch
    from deepv_tpu_torch.ops import attention as att

    # f32: the kernel's arithmetic against the plain version, exactly
    o32 = att.attention(q, k, v, valid, times, n_last=n_last)
    r32 = att.attention_plain(q, k, v, valid, times)
    torch.cuda.synchronize()
    err32 = (o32 - r32).abs().max().item()
    torch.testing.assert_close(o32, r32, atol=2e-5, rtol=1e-4)

    qb, kb, vb = (x.to(torch.bfloat16) for x in (q, k, v))
    ob = att.attention(qb, kb, vb, valid, times, n_last=n_last)
    rb = att.attention_plain(qb, kb, vb, valid, times)
    rf = att.attention_plain(qb.float(), kb.float(), vb.float(), valid, times)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(ob).all()), f"{name}: non-finite bf16 output"
    torch.testing.assert_close(ob.float(), rb.float(), atol=3e-2, rtol=3e-2)
    # bench.py's 2e-3 was set for an f32 kernel (the f32 check above meets
    # it with room). A bf16 result also carries its own rounding: the
    # output's (half an ulp) and the bf16 weights' (the TPU kernel rounds
    # them too). On rows that attend few keys the outputs reach ~2, where
    # half an ulp alone is 3.9e-3, and the plain bf16 version itself is
    # ~7e-3 off the f32 evaluation. So the bound is 2e-3 plus 2^-8 of the
    # value (between half and one bf16 ulp of it).
    excess = ((ob.float() - rf).abs() - (2e-3 + rf.abs() * 2.0 ** -8)).max().item()
    assert excess <= 0, f"{name}: bf16 kernel vs f32 reference (excess {excess})"
    return (qb, kb, vb), dict(err_f32_kernel=err32,
                              err_bf16_vs_plain=(ob.float() - rb.float()).abs().max().item(),
                              err_bf16_vs_f32=(ob.float() - rf).abs().max().item(),
                              plain_bf16_err_vs_f32=(rb.float() - rf).abs().max().item())


def tile_counts(valid, times):
    """K1's tile classes at its 128 x 64 tile, counted over the call."""
    from deepv_tpu_torch.ops import attention as att
    cls = att.tile_classes(valid, times)
    return {name: int((cls == c).sum()) for name, c in
            (("skip", att.SKIP), ("full", att.FULL), ("partial", att.PARTIAL))}


def check_attention(device, results):
    """Phase 3: the kernel against its plain version: one-hot P first, then
    every rollout layout (timed), then the edge layouts."""
    import torch
    import torch.nn.functional as F
    from deepv_tpu_torch.config import MMDiTConfig, PipelineConfig
    from deepv_tpu_torch.models.mmdit import PackedLayout, packed_mask
    from deepv_tpu_torch.ops import attention as att

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    mcfg, pcfg = MMDiTConfig(), PipelineConfig()
    h, d = mcfg.num_attention_heads, mcfg.attention_head_dim
    gen = torch.Generator(device=device)
    gen.manual_seed(5)

    # one-hot P: with every token in its own valid group each row attends
    # only itself, so P is the identity and the bf16 output must be V's
    # rows exactly (P.V reads V MN-major through the transpose-B bit)
    for s in (37, 200, 2093):
        qb, kb, vb = (torch.randn((2, s, h, d), generator=gen, device=device).to(torch.bfloat16)
                      for _ in range(3))
        valid = torch.arange(s, device=device, dtype=torch.int32).repeat(2, 1)
        ob = att.attention(qb, kb, vb, valid, torch.zeros(s, device=device))
        torch.cuda.synchronize()
        diff = (ob.float() - vb.float()).abs().max().item()
        log(f"attention one-hot P, S={s}: max |out - v| = {diff}")
        assert diff == 0.0, f"one-hot P at S={s}: output differs from V by {diff}"

    # launches per rollout of each layout: units of its chunk x steps x blocks
    per_unit = pcfg.num_inference_steps * mcfg.num_layers
    units = {2: pcfg.max_temporal_length, 3: pcfg.max_temporal_length - pcfg.num_input_unit}
    rows_out = []
    for name, b, shapes, ctx, ftimes, fvalid in rollout_layouts(device):
        layout = PackedLayout(mcfg, shapes, ctx.shape[1])
        valid, times = packed_mask(layout, ctx, ftimes, fvalid)
        s = layout.seq_len
        n_last = layout.clip_tokens[-1]
        q, k, v = (torch.randn((b, s, h, d), generator=gen, device=device) for _ in range(3))
        (qb, kb, vb), errs = check_attention_bf16(name, q, k, v, valid, times, n_last)

        # the least time for this work: the allowed pairs of these inputs
        allowed = ((valid[:, :, None] == valid[:, None, :])
                   & (times[:, None] >= times[None, :])[None])
        pairs = int(allowed.sum().item())
        flops = 4 * pairs * h * d                    # q.k and p.v, 2 flops per MAC
        nbytes = 4 * b * s * h * d * 2 + valid.numel() * 4 + times.numel() * 4
        t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES
        split_pairs = b * ((s - n_last) ** 2 + n_last * s)   # the TPU wrapper's split

        ms = cuda_time_ms(lambda: att.attention(qb, kb, vb, valid, times, n_last=n_last), 20)
        plain_ms = cuda_time_ms(lambda: att.attention_plain(qb, kb, vb, valid, times), 3, 1)
        mask = allowed[:, None]
        qt, kt, vt = (x.transpose(1, 2) for x in (qb, kb, vb))
        library_ms = cuda_time_ms(
            lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask), 10)
        del allowed, mask
        row = dict(layout=name, b=b, S=s, heads=h, head_dim=d, n_last=n_last,
                   allowed_pairs=pairs, split_pairs=split_pairs, flops=flops, bytes=nbytes,
                   **errs, ms=ms, plain_ms=plain_ms,
                   library_ms=library_ms, bound_ms=1e3 * max(t_ops, t_bytes),
                   bound_by="operations" if t_ops >= t_bytes else "bytes",
                   tflops=flops / (ms * 1e-3) / 1e12, tiles=tile_counts(valid, times),
                   launches_per_rollout=units[b] * per_unit)
        rows_out.append(row)
        log("attention", json.dumps(row))

    for name, valid, times, expect in attention_edge_layouts(device, gen):
        b, s = valid.shape
        q, k, v = (torch.randn((b, s, h, d), generator=gen, device=device) for _ in range(3))
        _, errs = check_attention_bf16(name, q, k, v, valid, times)
        tiles = tile_counts(valid, times)
        cls = att.tile_classes(valid, times)
        if expect == "full":
            assert tiles["full"] == cls.numel(), (name, tiles)
        elif expect == "partial":
            assert tiles["partial"] > cls.numel() // 2, (name, tiles)
        elif expect == "middle":    # rows at time 0 skip the time-5 keys, then attend again
            first = cls[0, 0].tolist()
            skipped = [i for i, c in enumerate(first) if c == att.SKIP]
            assert skipped and min(skipped) > 0 and max(skipped) < len(first) - 1, first
        row = dict(layout=name, b=b, S=s, tiles=tiles, **errs)
        rows_out.append(row)
        log("attention", json.dumps(row))

    rollout = [r for r in rows_out if "ms" in r]
    sums = {key: sum(r["launches_per_rollout"] * r[key] for r in rollout) / 1e3
            for key in ("ms", "library_ms", "bound_ms", "plain_ms")}
    results["attention_rollout_sums_s"] = sums
    log(f"K1 over the rollout ({sum(r['launches_per_rollout'] for r in rollout)} launches): "
        f"K1 {sums['ms']:.4f} s, SDPA {sums['library_ms']:.4f} s, bound {sums['bound_ms']:.4f} s")
    results["attention_layouts"] = rows_out
    return rollout


def rollout_batch():
    """The rollout's input: a smooth 384x512 test image with seeded noise and
    the 11-action prompt."""
    import numpy as np
    from deepv_tpu_torch.actions import prepare_motion_prompts

    rng = np.random.default_rng(0)
    yy, xx = np.mgrid[0:HEIGHT, 0:WIDTH] / np.array([HEIGHT, WIDTH])[:, None, None]
    img = np.stack([np.sin(6 * xx + 2 * c) * np.cos(4 * yy - c) for c in range(3)])
    img = np.clip(img + 0.1 * rng.standard_normal(img.shape), -1, 1)[None].astype(np.float32)
    return {"img": img, "prompt": np.array(prepare_motion_prompts("action", PROMPT)),
            "prompt_type": "action"}


def drive_rollout(pipe, setup_s: float):
    """generate() with every kernel count set to 0 just before and read just
    after; checks the outputs and K1's count. Returns (summary, pred_img,
    K2 launches)."""
    import torch
    from deepv_tpu_torch.ops import attention as att
    from deepv_tpu_torch.ops import conv_igemm as cig

    pipe.timer.sync = True
    torch.cuda.reset_peak_memory_stats()
    att.launches = att.f32_launches = 0
    for name in K2_COUNTERS:
        setattr(cig, name, 0)
    t0 = time.perf_counter()
    out = pipe.generate(rollout_batch(), seed=666)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = att.launches
    assert att.f32_launches == 0, "the bf16 rollout launched the f32 attention kernel"
    conv_launches = {name: getattr(cig, name) for name in K2_COUNTERS}
    assert conv_launches["f32_launches"] == 0, "the bf16 rollout launched the f32 kernel"

    mcfg, pcfg = pipe.mcfg, pipe.cfg
    n_units = pcfg.max_temporal_length + (pcfg.max_temporal_length - pcfg.num_input_unit)
    expected = (n_units * len(pcfg.stages) * pcfg.num_inference_steps * mcfg.num_layers)
    img_out, disp = out["pred_img"], out["pred_disparity"]
    n_frames = img_out.shape[2]
    assert tuple(img_out.shape) == (1, 3, 89, HEIGHT, WIDTH), tuple(img_out.shape)
    assert tuple(disp.shape) == (1, 3, 89, HEIGHT, WIDTH), tuple(disp.shape)
    assert bool(torch.isfinite(img_out).all()), "non-finite frames"
    assert bool(torch.isfinite(disp).all()), "non-finite disparity"
    assert float(disp.min()) >= 0.0, "post-mapped disparity is a square, never negative"
    for key in ("trans3d", "trans2d"):
        assert tuple(out[key].shape) == (1, 12, 4, 4), (key, tuple(out[key].shape))
        assert bool(torch.isfinite(out[key]).all()), f"non-finite {key}"
    assert torch.allclose(out["trans3d"][0, 0].cpu(), torch.eye(4), atol=1e-5)
    assert launches == expected, f"attention kernel launched {launches} times, expected {expected}"
    stats = pipe.timer.stats()
    summary = dict(wall_s=wall, frames=n_frames, fps=n_frames / wall, setup_s=setup_s,
                   attention_launches=launches, expected_attention_launches=expected,
                   conv_igemm_launches=conv_launches, history_index=out["history_index"],
                   phases_s={k: v["total_s"] for k, v in stats.items()},
                   phase_counts={k: v["count"] for k, v in stats.items()},
                   max_memory_allocated_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
                   pixel_mean=float(img_out.float().mean()),
                   pixel_std=float(img_out.float().std()))
    return summary, img_out, conv_launches


def run_main_path(device, results):
    """Phase 5: the full-width rollout through the user's entry points."""
    import torch
    from deepv_tpu_torch.config import create_model_config
    from deepv_tpu_torch.run import load_pipeline

    t0 = time.perf_counter()
    cfg = create_model_config("none", use_motion_prompt=True)
    pipe = load_pipeline("none", cfg, random_weights=True, dtype=torch.bfloat16,
                         device=device, seed=0)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in pipe.mmdit.parameters())
    log(f"main path: pipeline with {n_params / 1e9:.3f} B MMDiT parameters ready in "
        f"{setup_s:.1f} s")
    main, frames, conv_launches = drive_rollout(pipe, setup_s)
    assert not any(conv_launches.values()), f"the default (xla) path launched K2: {conv_launches}"
    log("main path:", json.dumps(main))
    results["main_path"] = main
    return pipe, main["attention_launches"], frames


def check_forward(pipe, device, results):
    """Phase 5: one full-width forward (stage 2, 3 rows + history) in f32,
    kernel against plain attention."""
    import torch
    from deepv_tpu_torch.models import mmdit as mm
    from deepv_tpu_torch.ops import attention as att
    from deepv_tpu_torch.pipeline import _pyramid_list, padded_conditions

    model = pipe.mmdit.float()
    mcfg, pcfg = pipe.mcfg, pipe.cfg
    g = torch.Generator(device=device)
    g.manual_seed(11)
    lh, lw = HEIGHT // 8, WIDTH // 8
    gen = torch.randn((1, mcfg.in_channels, 5, lh, lw), generator=g, device=device)
    clips, ftimes, fvalid = padded_conditions(pcfg, _pyramid_list(gen, 2), 5, False, 3)[2]
    lat = torch.randn((1, mcfg.in_channels, 1, lh, lw), generator=g, device=device)
    mask = torch.cat([pipe._embeds_for("empty")[1]] * 3)
    text = torch.randn((3, 77, mcfg.joint_attention_dim), generator=g, device=device)
    pooled = torch.randn((3, mcfg.pooled_projection_dim), generator=g, device=device)
    hist = torch.randn((3, mcfg.in_channels, 1, lh, lw), generator=g, device=device)
    hlen = (lh // 2 // mcfg.patch_size) * (lw // 2 // mcfg.patch_size)
    hmask = torch.tensor([[0], [0], [1]], dtype=torch.int32, device=device).expand(3, hlen)
    args = (list(clips) + [torch.cat([lat] * 3)], text, mask, pooled,
            torch.full((3,), 700.0, device=device))
    kw = dict(history=hist, history_mask=hmask, frame_times=list(ftimes),
              frame_valid=list(fvalid), split_last_attn=True)
    with torch.inference_mode():
        before = att.f32_launches
        v_kernel = mm.mmdit_forward(model, *args, **kw)
        assert att.f32_launches - before == mcfg.num_layers, "f32 forward missed the f32 kernel"
        orig = mm.attention
        mm.attention = lambda q, k, v, valid, times, n_last=0: att.attention_plain(
            q, k, v, valid, times)
        try:
            v_plain = mm.mmdit_forward(model, *args, **kw)
        finally:
            mm.attention = orig
    torch.cuda.synchronize()
    rel = ((v_kernel - v_plain).norm() / v_plain.norm()).item()
    err = (v_kernel - v_plain).abs().max().item()
    log(f"forward check: f32 full-width forward, kernel vs plain attention: "
        f"max abs {err:.3e}, relative L2 {rel:.3e}")
    # f32 attention agrees to ~1e-6; 24 blocks of random-weight residual
    # updates keep that near 1e-5 relative
    assert rel <= 1e-4, f"forward with the kernel differs from the plain forward: {rel}"
    results["forward_check"] = dict(max_abs=err, rel_l2=rel)


def bf16_ulp(v):
    """Spacing of bfloat16 numbers at |v| (8 significant bits)."""
    import torch
    _, e = torch.frexp(v.float())
    return torch.ldexp(torch.ones_like(v, dtype=torch.float32), e - 8)


def conv_case_inputs(mode: str, ci: int, co: int, h: int, w: int, n: int, gen, device,
                     b: int = 1):
    """Input, parameters and time_pad of one K2 case: ``full`` convolves n
    frames with 2 causal zero frames; ``init`` is the same with the zero
    frames already prepended; ``cont``/``prime`` convolve n frames after 2
    context frames."""
    import types
    import torch
    if mode == "full":
        x = torch.randn((b, ci, n, h, w), generator=gen, device=device)
    else:
        x = torch.randn((b, ci, n + 2, h, w), generator=gen, device=device)
        if mode == "init":
            x[:, :, :2] = 0.0
    weight = 0.02 * torch.randn((co, ci, 3, 3, 3), generator=gen, device=device)
    bias = 0.1 * torch.randn((co,), generator=gen, device=device)
    return x, types.SimpleNamespace(weight=weight, bias=bias), 2 if mode == "full" else 0


def check_conv_igemm(device, results):
    """Phase 4: K2 against its plain version at every eligible conv class
    and at the edge shapes."""
    import torch
    import torch.nn.functional as F
    from deepv_tpu_torch.ops import conv_igemm as cig

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False      # cuDNN f32 convs default to TF32
    gen = torch.Generator(device=device)
    gen.manual_seed(9)
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    rows_out = []
    cases = [c + (1, False) for c in CONV_CASES] + list(CONV_EDGE_CASES)
    for layer, mode, ci, co, h, w, n, b, channels_last in cases:
        x32, p32, tp = conv_case_inputs(mode, ci, co, h, w, n, gen, device, b)
        if channels_last:
            x32 = x32.to(memory_format=torch.channels_last_3d)
        for dtype in (torch.bfloat16, torch.float32):
            x = x32.to(dtype)
            p = p32 if dtype == torch.float32 else type(p32)(
                weight=p32.weight.to(dtype), bias=p32.bias.to(dtype))
            kernel = cig.kernel_for(x)
            before = [getattr(cig, name) for name in K2_COUNTERS]
            y = cig.conv3d_igemm(x, p, tp)
            r = cig.conv3d_igemm_plain(x, p, tp)
            torch.cuda.synchronize()
            ran = [k for k, name, c0 in zip(("wgmma", "gather", "fma_f32"), K2_COUNTERS, before)
                   if getattr(cig, name) != c0]
            assert ran == [kernel], f"{layer} {mode}: expected the {kernel} kernel, ran {ran}"
            assert tuple(y.shape) == (b, co, n, h, w), tuple(y.shape)
            err = (y.float() - r.float()).abs()
            if dtype == torch.float32:
                torch.testing.assert_close(y, r, atol=2e-4, rtol=1e-4)
                excess = 0.0
            else:
                bound = bf16_ulp(torch.maximum(y.float().abs(), r.float().abs())) + 2e-4
                excess = float((err - bound).max())
                assert excess <= 0, f"{layer} {mode} bf16: kernel vs plain beyond one ulp"
            # F.conv3d on the same input (full mode: the zero frames prepended
            # outside the timed call); a yardstick the igemm path never calls
            xl = F.pad(x, (0, 0, 0, 0, tp, 0)) if tp else x
            lib = F.conv3d(xl, p.weight, p.bias, padding=(0, 1, 1))
            lib_err = float((lib.float() - r.float()).abs().max())
            del lib
            big = 2 * 27 * ci * co * n * h * w > 1e12
            iters = (2 if big else 5) if dtype == torch.bfloat16 else 1
            ms = cuda_time_ms(lambda: cig.conv3d_igemm(x, p, tp), iters, 1)
            if kernel == "wgmma":                # the K-major weight, no copy of x
                layout = lambda: cig.relayout_weight(p.weight, x.dtype)
            else:                                # a channels-last x and [(taps, ci), co]
                layout = lambda: (x.permute(0, 2, 3, 4, 1).contiguous(),
                                  p.weight.permute(2, 3, 4, 1, 0).reshape(27 * ci, co).contiguous())
            layout_ms = cuda_time_ms(layout, 5, 1)
            plain_ms = cuda_time_ms(lambda: cig.conv3d_igemm_plain(x, p, tp), 1, 1)
            library_ms = cuda_time_ms(
                lambda: F.conv3d(xl, p.weight, p.bias, padding=(0, 1, 1)), iters, 1)
            # the taps this input needs: in full mode the first output frames'
            # taps in the causal past read only padding, and K2 skips them
            taps = sum(9 * (3 - max(0, tp - to)) for to in range(n))
            flops = 2 * taps * ci * co * b * h * w
            esize = x.element_size()
            nbytes = (x.numel() + p.weight.numel() + co + y.numel()) * esize
            peak = PEAK_BF16_FLOPS if dtype == torch.bfloat16 else PEAK_F32_FLOPS
            t_ops, t_bytes = flops / peak, nbytes / PEAK_BYTES
            plan = cig.tile_plan(b, co, n, h, w, sms) if kernel == "wgmma" else None
            row = dict(layer=layer, mode=mode, ci=ci, co=co, h=h, w=w, frames=n, batch=b,
                       edge=layer.startswith("edge"), kernel=kernel,
                       plan=None if plan is None else dict(bn=plan.bn, grid=plan.grid),
                       dtype=str(dtype).split(".")[-1], time_pad=tp,
                       max_abs_err=float(err.max()), ulp_excess=excess,
                       cudnn_vs_plain_max_abs=lib_err, ms=ms, layout_ms=layout_ms,
                       plain_ms=plain_ms, library_ms=library_ms,
                       bound_ms=1e3 * max(t_ops, t_bytes),
                       bound_by="operations" if t_ops >= t_bytes else "bytes",
                       flops=flops, bytes=nbytes, tflops=flops / (ms * 1e-3) / 1e12,
                       library_tflops=flops / (library_ms * 1e-3) / 1e12)
            rows_out.append(row)
            log("conv_igemm", json.dumps(row))
            del y, r, x, xl
        del x32, p32
        torch.cuda.empty_cache()
    results["conv_igemm_shapes"] = rows_out
    return rows_out


def expected_conv_launches(pipe, stats, boundaries: int) -> int:
    """K2 launches of one igemm rollout, from the code: every 3x3x3 conv of
    the resnets, mid blocks and up-samplers has ci, co multiples of 128 at
    full width (conv_in, conv_out, 1x1 shortcuts and strided down-samplers
    are not eligible). Per call: a decoder window, a decoder_front window of
    the priming warm, a priming tail and an encoder window."""
    from deepv_tpu_torch.models.vae import _split_windows

    vcfg, pcfg = pipe.vcfg, pipe.cfg
    dec_layers, enc_layers = vcfg.decoder_layers_per_block, vcfg.encoder_layers_per_block
    tail = 2 * dec_layers[-1]
    front = 4 + sum(2 * n + int(up) + int(tup) for n, up, tup in zip(
        dec_layers[:-1], vcfg.decoder_spatial_up_sample, vcfg.decoder_temporal_up_sample))
    window = front + tail
    encoder = 4 + sum(2 * n for n in enc_layers)
    assert (window, front, tail, encoder) == (34, 28, 6, 20), (window, front, tail, encoder)
    # streamed decode: one latent unit of rgb and one of disparity per phase
    decoder_windows = 2 * stats["stream_decode"]["count"]
    # priming: rgb and disparity, one front window per carried latent frame
    t_down = 2 ** sum(vcfg.encoder_temporal_down_sample)
    carried = 1 + (pcfg.num_input_image - 1) // t_down
    primes = stats["prime"]["count"]
    assert primes == boundaries, (primes, boundaries)
    # encoder: the first image (1 frame, full), then per boundary the carried
    # rgb and disparity clips (chunked into windows) and the history frame's
    # rgb and disparity (1 frame each)
    clip_windows = len(_split_windows(pcfg.num_input_image, pipe.encode_window))
    encoder_windows = 1 + boundaries * (2 * clip_windows + 2)
    return (window * decoder_windows + 2 * primes * (front * carried + tail)
            + encoder * encoder_windows)


def run_igemm_path(device, results, ref_frames):
    """Phase 7: the full-width rollout with VAEConfig(conv_impl="igemm")."""
    import torch
    from deepv_tpu_torch.actions import action_vocabulary
    from deepv_tpu_torch.config import MMDiTConfig, VAEConfig, create_model_config
    from deepv_tpu_torch.io.text_embeds import random_text_embeds
    from deepv_tpu_torch.io.weights import random_params
    from deepv_tpu_torch.ops import causal_conv
    from deepv_tpu_torch.pipeline import InferencePipeline

    t0 = time.perf_counter()
    cfg = create_model_config("none", use_motion_prompt=True)
    mcfg, vcfg = MMDiTConfig(), VAEConfig(conv_impl="igemm")
    embeds = random_text_embeds(0, action_vocabulary(), joint_dim=mcfg.joint_attention_dim,
                                pooled_dim=mcfg.pooled_projection_dim)
    pipe = InferencePipeline(cfg, mcfg, vcfg,
                             random_params(mcfg, vcfg, dtype=torch.bfloat16, seed=0,
                                           device=device),
                             embeds, dtype=torch.bfloat16, device=device)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0

    # output frames per conv class, read from the calls (the kernel count
    # itself stays the wrapper's)
    frames_by_class = {}
    orig = causal_conv.conv3d_igemm

    def spy(x, p, time_pad=2):
        key = (x.shape[1], p.weight.shape[0], x.shape[3], x.shape[4])
        frames_by_class[key] = frames_by_class.get(key, 0) + (
            x.shape[0] * (x.shape[2] + time_pad - 2))
        return orig(x, p, time_pad)

    causal_conv.conv3d_igemm = spy
    try:
        summary, frames, conv_launches = drive_rollout(pipe, setup_s)
    finally:
        causal_conv.conv3d_igemm = orig
    stats = pipe.timer.stats()
    expected = expected_conv_launches(pipe, stats, len(summary["history_index"]))
    k2 = conv_launches["launches"] + conv_launches["gather_launches"]
    assert k2 == expected, f"K2 launched {k2} times ({conv_launches}), expected {expected}"
    summary["expected_conv_igemm_launches"] = expected
    summary["conv_frames_by_class"] = {f"{ci}->{co} @{h}x{w}": n
                                       for (ci, co, h, w), n in frames_by_class.items()}
    summary["max_abs_diff_vs_main_path"] = float((frames.float() - ref_frames.float()).abs().max())
    log("igemm path:", json.dumps(summary))
    results["igemm_path"] = summary
    return pipe, conv_launches, frames_by_class


def check_decode(pipe, device, results):
    """Phase 8: one full-width latent stream decoded with "igemm" and "xla"."""
    import copy
    import torch
    from deepv_tpu_torch.config import VAEConfig
    from deepv_tpu_torch.models.vae import _dec_prime_warm, _dec_window

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dec_bf16 = pipe.vae.decoder
    dec_f32 = copy.deepcopy(dec_bf16).float()
    g = torch.Generator(device=device)
    g.manual_seed(13)
    z = torch.randn((1, 16, 5, HEIGHT // 8, WIDTH // 8), generator=g, device=device)

    def decode(dec, impl, dtype):
        """init window, cont window, then caches primed on 3 latents and a
        cont window through them"""
        cfg = VAEConfig(conv_impl=impl)
        zz = z.to(dtype)
        with torch.inference_mode():
            y0, cache = _dec_window(cfg, dec, zz[:, :, :1], None, "init")
            y1, _ = _dec_window(cfg, dec, zz[:, :, 1:2], cache, "cont")
            primed = _dec_prime_warm(cfg, dec, zz[:, :, 1:4])
            y2, _ = _dec_window(cfg, dec, zz[:, :, 4:5], primed, "cont")
            return torch.cat([y0, y1, y2], dim=2).float()

    def rel(a, b):
        return float((a - b).norm() / b.norm())

    out = {}
    for name, dec, dtype in (("f32", dec_f32, torch.float32), ("bf16", dec_bf16, torch.bfloat16)):
        for impl in ("igemm", "xla"):
            t0 = time.perf_counter()
            out[impl, name] = decode(dec, impl, dtype)
            torch.cuda.synchronize()
            log(f"decode check: {impl} {name} {out[impl, name].shape[2]} frames in "
                f"{time.perf_counter() - t0:.1f} s")
    rel_f32 = rel(out["igemm", "f32"], out["xla", "f32"])
    rel_bf16 = rel(out["igemm", "bf16"], out["xla", "bf16"])
    gap = rel(out["xla", "bf16"], out["xla", "f32"])
    row = dict(frames=out["xla", "f32"].shape[2], rel_l2_f32=rel_f32, rel_l2_bf16=rel_bf16,
               rel_l2_bf16_vs_f32_xla=gap,
               rel_l2_bf16_igemm_vs_f32_xla=rel(out["igemm", "bf16"], out["xla", "f32"]))
    log("decode check:", json.dumps(row))
    results["decode_check"] = row
    assert all(bool(torch.isfinite(v).all()) for v in out.values()), "non-finite decode"
    assert rel_f32 <= 1e-4, f"f32 decode: igemm vs xla relative L2 {rel_f32}"
    assert rel_bf16 <= 2 * gap, f"bf16 decode: igemm vs xla {rel_bf16}, bf16 vs f32 {gap}"
    del dec_f32, out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    try:
        from deepv_tpu_torch.ops import attention as att
        from deepv_tpu_torch.ops import conv_igemm as cig
        from deepv_tpu_torch.utils import cuda_build
    except ImportError as e:
        print(f"chip_smoke: deepv_tpu_torch is not beside this script ({e})", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    out_dir = os.path.join(HERE, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    results = {}

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 and smi.stdout.strip() else ""
    log(f"card: {card}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")
    results["card"] = card

    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(SOURCES)) as pool:    # one nvcc per source, all at once
        builds = dict(zip(SOURCES, pool.map(cuda_build.build, SOURCES)))
    att.load_library()
    cig.load_library()
    build_s = time.perf_counter() - t0
    for src, built in builds.items():
        log(f"build: {src} -> {os.path.relpath(built.path, HERE)} (nvcc {built.seconds:.1f} s)")
        for line in built.log.splitlines():
            if any(k in line for k in ("registers", "spill", "smem", "Function properties")):
                log("  ptxas:", line.strip())
    log(f"build: all kernels in {build_s:.1f} s")
    results["build_s"] = build_s

    rows = check_attention(device, results)
    conv_rows = check_conv_igemm(device, results)
    pipe, launches, ref_frames = run_main_path(device, results)
    check_forward(pipe, device, results)
    del pipe
    gc.collect()
    torch.cuda.empty_cache()
    pipe, conv_launches, frames_by_class = run_igemm_path(device, results, ref_frames)
    del ref_frames
    check_decode(pipe, device, results)
    del pipe
    gc.collect()
    torch.cuda.empty_cache()

    assert launches == sum(r["launches_per_rollout"] for r in rows), (
        "K1's launches per layout do not add up to the rollout's")
    head = next(r for r in rows if r["layout"] == "stage2_b2")
    kernels = [{
        "name": "attn_fwd_wgmma",
        "route": "cuda",
        "source": "deepv_tpu_torch/csrc/attention.cu",
        "replaces": "deepv_tpu/ops/attention.py:73",
        "launches": launches,
        "max_abs_err": max(r["err_bf16_vs_plain"] for r in results["attention_layouts"]),
        "ms": head["ms"],
        "plain_ms": head["plain_ms"],
        "bound_ms": head["bound_ms"],
        "bound_by": head["bound_by"],
        "library_ms": head["library_ms"],
        "shape": f"stage 2, b={head['b']}, S={head['S']}, h={head['heads']}, d={head['head_dim']}, bf16",
    }]
    # K2 at the conv class with the most device time in the igemm rollout:
    # its output frames there times the kernel's ms per output frame
    bf16 = [r for r in conv_rows if r["dtype"] == "bfloat16"]
    per_frame = {}
    for r in bf16:
        if r["kernel"] == "wgmma" and not r["edge"]:
            per_frame.setdefault((r["ci"], r["co"], r["h"], r["w"]), r)
    missing = set(frames_by_class) - set(per_frame)
    assert not missing, f"rollout conv classes without a K2 check: {sorted(missing)}"
    # K2, cuDNN and the bound summed over the igemm rollout: each class's
    # output frames times its checked case's ms per output frame
    by_class = {}
    for k, n in frames_by_class.items():
        r = per_frame[k]
        per = n / r["frames"]
        by_class[k] = dict(frames=n, k2_s=per * r["ms"] / 1e3, layout_s=per * r["layout_ms"] / 1e3,
                           cudnn_s=per * r["library_ms"] / 1e3, bound_s=per * r["bound_ms"] / 1e3,
                           tflops=r["tflops"], plan=r["plan"])
    by_class = dict(sorted(by_class.items(), key=lambda kv: -kv[1]["k2_s"]))
    sums = {key: sum(v[key] for v in by_class.values())
            for key in ("k2_s", "layout_s", "cudnn_s", "bound_s")}
    names = {k: f"{k[0]}->{k[1]} @{k[2]}x{k[3]}" for k in by_class}
    results["conv_igemm_rollout_by_class"] = {names[k]: v for k, v in by_class.items()}
    results["conv_igemm_rollout_sums"] = sums
    log(f"K2 over the igemm rollout ({sum(frames_by_class.values())} output frames in "
        f"{len(by_class)} classes): K2 {sums['k2_s']:.3f} s (layout work outside the kernel "
        f"{sums['layout_s']:.3f} s), cuDNN {sums['cudnn_s']:.3f} s, bound {sums['bound_s']:.3f} s")
    for k, v in by_class.items():
        log(f"  {names[k]}: {v['frames']} frames, K2 {v['k2_s']:.3f} s, cuDNN {v['cudnn_s']:.3f} s, "
            f"bound {v['bound_s']:.3f} s, {v['tflops']:.0f} TF/s, plan {v['plan']}")
    top = per_frame[next(iter(by_class))]
    # K2's two bf16 kernels: wgmma at the class with the most K2 time, gather
    # at the channels-last encoder case, where the rollout runs it
    on_path = next(r for r in bf16 if r["layer"] == CONV_EDGE_CASES[0][0])
    for name, counter, row, rows in (
            ("conv3d_igemm_wgmma", "launches", top,
             [r for r in bf16 if r["kernel"] == "wgmma"]),
            ("conv3d_igemm_gather", "gather_launches", on_path,
             [r for r in bf16 if r["kernel"] == "gather"])):
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": "deepv_tpu_torch/csrc/conv_igemm.cu",
            "replaces": "deepv_tpu/ops/conv_igemm.py:57",
            "launches": conv_launches[counter],
            "max_abs_err": max(r["max_abs_err"] for r in rows),
            "ms": row["ms"],
            "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"],
            "library_ms": row["library_ms"],
            "shape": (f"{row['ci']}->{row['co']} @{row['h']}x{row['w']}, {row['frames']} output "
                      f"frames, {row['mode']} mode, bf16"
                      + (", x channels-last" if row is on_path else "")),
        })
    with open(os.path.join(out_dir, "chip_smoke.json"), "w") as f:
        json.dump(dict(results, kernels=kernels), f, indent=1)
    log(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
