#!/usr/bin/env python3
"""Where the port's rollout spends its time on one CUDA card.

    python3 tools/profile_port.py

Builds the full-width pipeline (``MMDiTConfig()``, ``VAEConfig()``, bf16,
random weights) and, at 384x512, measures the pieces the rollout's
phases are made of:

  * ``denoise_b2``: one chunk-1 denoise unit (2 CFG rows, 3 stages x 5 steps);
  * ``denoise_b3``: one chunk-2 denoise unit (3 rows, history tokens);
  * ``decode``: one streamed decode window (rgb + disparity, cont mode);
  * ``decode_igemm``: the same window with ``VAEConfig(conv_impl="igemm")``,
    the eligible convs on the implicit-GEMM kernel (K2);
  * ``encode`` and ``encode_igemm``: one encoder window (17 frames, init
    mode: the first window of a carried clip's encode at a chunk boundary)
    with each conv backend;
  * ``denoise_adaptive_b2``: the 2-row unit with ``flow_cache="adaptive:0.5"``
    (a host decision, and so a wait for the device, before every step after
    a stage's first);
  * ``denoise_fast_b2`` and ``denoise_fast_b3``: the two units of the fast
    preset, flow caching "skip_odd" with the W8A8 block linears;
  * ``decode_int8`` and ``encode_int8``: the decode and encoder windows with
    ``VAEConfig(conv_impl="int8")`` (K3 at the 384x512 level).

For each piece it prints the synchronised wall time without the profiler
(median of 3, after one warm-up whose own time is kept as the first call's:
it pays cuDNN's plan building and new allocations for shapes not seen
before), then, from one run under
``torch.profiler``: the device busy time (the union of kernel intervals),
the idle share ``1 - busy / wall``, the number of kernels, the device time
and launches by kernel class (the attention kernel K1, the igemm conv
kernel K2, K3's quantise kernel and its conv kernels apart, the int8
products of ``_int_mm``, other
GEMMs, cuDNN convolutions, the rest; a line per denoise unit gives K1's
seconds and launches beside the device-busy seconds) and,
for the denoise units, the rate the GEMMs reach on the linear layers'
operations counted from the shapes. Details go to
``chiprun_out/profile_port.json``. Needs a CUDA card; exits non-zero without.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HEIGHT, WIDTH = 384, 512
UNIT = 5              # a unit index past the first-frame layout's padding


def classify(name: str) -> str:
    """Kernel class from a CUDA kernel's name."""
    n = name.lower()
    if "attn_fwd" in n:
        return "attention_kernel"
    if "conv3d_igemm" in n:
        return "conv_igemm_kernel"
    if "quantize_k3_input" in n:
        return "conv_int8_quantise"
    if "conv3d_int8" in n:
        return "conv_int8_kernel"
    if "gemm" in n and any(t in n for t in ("s8", "i8", "imma", "int8")):
        return "int_mm"
    if "conv" in n or "fprop" in n or "dgrad" in n or "cudnn" in n:
        return "conv"
    if "gemm" in n or "nvjet" in n or "cutlass" in n or "xmma" in n:
        return "gemm"
    if "memcpy" in n or "memset" in n:
        return "copy"
    return "other"


def busy_us(intervals) -> float:
    """Length of the union of (start, end) intervals."""
    total, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def unit_inputs(pipe, rows: int, device):
    """Arguments of ``_generate_one_unit`` at the rollout's padded layout:
    chunk 1 (first-frame mask, 2 rows) or chunk 2 (3 rows and history)."""
    import torch
    from deepv_tpu_torch.actions import action_vocabulary
    from deepv_tpu_torch.pipeline import TorchNoise, _pyramid_list, padded_conditions

    mcfg, pcfg = pipe.mcfg, pipe.cfg
    ds = pcfg.vae_downsample
    lh, lw = HEIGHT // ds, WIDTH // ds
    fm = rows == 2
    noise = TorchNoise(3, device)
    gen = noise.normal("latents", (1, mcfg.in_channels, UNIT + int(fm), lh, lw), pipe.dtype)
    conds = padded_conditions(pcfg, _pyramid_list(gen, len(pcfg.stages) - 1), UNIT, fm, rows)
    s0 = 2 ** (len(pcfg.stages) - 1)
    cur = noise.normal("latents", (1, mcfg.in_channels, 1, lh // s0, lw // s0), pipe.dtype)
    hist = None
    if rows == 3:
        hist = noise.normal("latents", (1, mcfg.in_channels, 1, lh, lw), pipe.dtype)
    pe, pm, pp = pipe._embeds_for(action_vocabulary()[1])
    ne, nm, npo = pipe._embeds_for("empty")
    text = torch.cat([ne] + [pe] * (rows - 1))
    mask = torch.cat([nm] + [pm] * (rows - 1))
    pooled = torch.cat([npo] + [pp] * (rows - 1))
    return (noise, cur, hist, conds, text, mask, pooled, rows), conds, mask


def linear_flops(pipe, conds, text_mask, rows: int, history: bool, forwards) -> float:
    """Operations of the MMDiT's per-token linear layers for one unit, with
    ``forwards[s]`` forwards run at stage s: per block 12 D^2 multiply-adds
    a token (q, k, v, out and the 4x feed-forward), 3 D^2 for context tokens
    in the last block."""
    mcfg, pcfg = pipe.mcfg, pipe.cfg
    d, layers, p = mcfg.inner_dim, mcfg.num_layers, mcfg.patch_size
    ctx = text_mask.shape[1]
    if history:
        lh, lw = HEIGHT // pcfg.vae_downsample, WIDTH // pcfg.vae_downsample
        r = pcfg.history_downsample_ratio
        ctx += (lh // r // p) * (lw // r // p)
    total = 0.0
    for (clips, _, _), n_forwards in zip(conds, forwards):
        shapes = [tuple(c.shape[2:]) for c in clips] + [tuple(clips[-1].shape[2:])]
        video = sum(t * (h // p) * (w // p) for t, h, w in shapes)
        macs = video * 12 * d * d * layers + ctx * (12 * d * d * (layers - 1) + 3 * d * d)
        total += 2.0 * macs * rows * n_forwards
    return total


def measure(name: str, fn, extra=None):
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    first = time.perf_counter() - t0
    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    wall = statistics.median(walls)

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    by_class, count_by_class, by_name = {}, {}, {}
    for e in kernels:
        us = e.time_range.elapsed_us()
        c = classify(e.name)
        by_class[c] = by_class.get(c, 0.0) + us
        count_by_class[c] = count_by_class.get(c, 0) + 1
        n, t = by_name.get(e.name, (0, 0.0))
        by_name[e.name] = (n + 1, t + us)
    busy = busy_us((e.time_range.start, e.time_range.end) for e in kernels) / 1e6
    row = dict(piece=name, wall_s=wall, walls_s=walls, first_wall_s=first, kernels=len(kernels),
               device_busy_s=busy if kernels else None,
               idle_share=(1.0 - busy / wall) if kernels else None,
               device_s_by_class={k: v / 1e6 for k, v in sorted(by_class.items())},
               kernels_by_class=dict(sorted(count_by_class.items())))
    if extra:
        row.update(extra(row))
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:25]
    row["top_kernels"] = [dict(name=k[:120], count=n, device_s=t / 1e6) for k, (n, t) in top]
    summary = {k: v for k, v in row.items() if k != "top_kernels"}
    print(f"piece {json.dumps(summary)}", flush=True)
    for k in row["top_kernels"][:12]:
        print(f"  {k['device_s'] * 1e3:9.3f} ms  x{k['count']:<6d} {k['name']}", flush=True)
    return row


def main() -> int:
    import dataclasses

    import torch

    if not torch.cuda.is_available():
        print("profile_port: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    from deepv_tpu_torch.config import create_model_config
    from deepv_tpu_torch.models.mmdit import quantize_mmdit
    from deepv_tpu_torch.models.vae import _enc_window
    from deepv_tpu_torch.ops.conv_int8 import quantize_vae_convs
    from deepv_tpu_torch.run import load_pipeline

    device = torch.device("cuda", 0)
    print(f"card: {torch.cuda.get_device_name(0)}; torch {torch.__version__}", flush=True)
    cfg = create_model_config("none", use_motion_prompt=True)
    pipe = load_pipeline("none", cfg, random_weights=True, dtype=torch.bfloat16,
                         device=device, seed=0)
    rows_out = []

    def denoise(name, rows):
        args, conds, mask = unit_inputs(pipe, rows, device)
        # forwards run per unit: every step's, or (flow caching) those recorded
        pipe.recompute_log = []
        pipe._generate_one_unit(*args, guidance=3.5,
                                history_scale=pipe.cfg.history_guidance_scale)
        forwards = [sum(r) for r in pipe.recompute_log]
        ran = sum(forwards)
        flops = linear_flops(pipe, conds, mask, rows, rows == 3, forwards)

        def unit():
            return pipe._generate_one_unit(*args, guidance=3.5,
                                           history_scale=pipe.cfg.history_guidance_scale)

        def rates(row):
            gemm = row["device_s_by_class"].get("gemm", 0.0) + row["device_s_by_class"].get(
                "int_mm", 0.0)
            return dict(forwards=ran, linear_flops=flops,
                        gemm_tflops=flops / gemm / 1e12 if gemm else None)

        row = measure(name, unit, rates)
        rows_out.append(row)
        print(f"{name}: {ran:.0f} forwards; K1 "
              f"{row['device_s_by_class'].get('attention_kernel', 0.0):.4f} s in "
              f"{row['kernels_by_class'].get('attention_kernel', 0)} launches; _int_mm "
              f"{row['device_s_by_class'].get('int_mm', 0.0):.4f} s; device busy "
              f"{row['device_busy_s']:.4f} s of {row['wall_s']:.4f} s wall "
              f"(idle {100 * row['idle_share']:.1f}%)", flush=True)

    with torch.inference_mode():
        for rows in (2, 3):
            denoise(f"denoise_b{rows}", rows)

        ds = pipe.cfg.vae_downsample
        z = torch.randn((1, 16, 2, HEIGHT // ds, WIDTH // ds), device=device,
                        dtype=pipe.dtype)
        _, cache_rgb = pipe._stream_push(z[:, :, :1], None, True)
        _, cache_disp = pipe._stream_push(z[:, :, :1], None, True)

        def decode():
            pipe._stream_push(z[:, :, 1:], cache_rgb, False)
            pipe._stream_push(z[:, :, 1:], cache_disp, False)

        clip = torch.randn((1, 3, pipe.encode_window + 1, HEIGHT, WIDTH), device=device,
                           dtype=pipe.dtype)

        def encode():
            _enc_window(pipe.vcfg, pipe.vae.encoder, clip, None, "init")

        rows_out.append(measure("decode", decode))
        rows_out.append(measure("encode", encode))

        pipe.vcfg = dataclasses.replace(pipe.vcfg, conv_impl="igemm")
        rows_out.append(measure("decode_igemm", decode))
        rows_out.append(measure("encode_igemm", encode))

        quantize_vae_convs(pipe.vae)
        pipe.vcfg = dataclasses.replace(pipe.vcfg, conv_impl="int8")
        for name, fn in (("decode_int8", decode), ("encode_int8", encode)):
            row = measure(name, fn)
            rows_out.append(row)
            sec, cnt = row["device_s_by_class"], row["kernels_by_class"]
            print(f"{name}: K3 quantise kernel {sec.get('conv_int8_quantise', 0.0):.4f} s in "
                  f"{cnt.get('conv_int8_quantise', 0)} launches, conv kernels "
                  f"{sec.get('conv_int8_kernel', 0.0):.4f} s in "
                  f"{cnt.get('conv_int8_kernel', 0)} launches", flush=True)

        pipe.flow_cache, pipe.adaptive_tau = "adaptive:0.5", 0.5
        denoise("denoise_adaptive_b2", 2)
        quantize_mmdit(pipe.mmdit)
        pipe.flow_cache, pipe.adaptive_tau = "skip_odd", None
        for rows in (2, 3):
            denoise(f"denoise_fast_b{rows}", rows)

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout
    out_dir = os.path.join(HERE, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "profile_port.json"), "w") as f:
        json.dump(dict(card=smi.strip(), pieces=rows_out), f, indent=1)
    print(smi.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
