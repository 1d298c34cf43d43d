#!/usr/bin/env python3
"""Every tile of the igemm conv kernel (K2), checked and timed on one CUDA card.

    python3 tools/conv_igemm_plans.py            # check every plan, then time them
    python3 tools/conv_igemm_plans.py --check    # the check alone (small shapes, edges)

Builds ``csrc/conv_igemm.cu`` and runs the ``wgmma`` kernel with each tile
width (``ops/conv_igemm.TILES``) against the plain version
(bf16 within one bf16 ulp plus 2e-4, as chip_smoke.py holds it): first at
small shapes and the edge shapes (w not a multiple of 64, two batches, the
causal past), each also channels-last through the ``cl`` path's tile,
plus a w % 8 != 0 shape on the ``cl`` path, and the f32 ``tf32x3``
kernel at each shape (atol 2e-4 / rtol 1e-4); then, at
every conv case of chip_smoke.py (the 14 classes of the full-width rollout
in the modes and frame counts it checks), the time of each plan beside
``F.conv3d`` (cuDNN), with the plan ``tile_plan`` picks marked. The lines go
to stdout and ``chiprun_out/conv_igemm_plans.json``. Needs a CUDA card;
exits non-zero without one or when a check fails.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: (ci, co, h, w, b, t_in, time_pad) of the check
CHECKS = (
    (128, 128, 8, 64, 1, 3, 2), (128, 256, 16, 128, 1, 4, 0), (256, 128, 6, 64, 2, 2, 2),
    (128, 128, 48, 80, 1, 4, 0), (256, 256, 96, 128, 2, 3, 2), (128, 128, 8, 8, 1, 2, 2),
    (512, 512, 48, 64, 1, 3, 0),
)


def plans_of(cig, b, co, t_out, h, w):
    return [cig.make_plan(bn, co, b * t_out, h, w) for bn in cig.TILES if co % bn == 0]


def ulp_excess(y, r):
    from chip_smoke import bf16_ulp
    import torch
    bound = bf16_ulp(torch.maximum(y.float().abs(), r.float().abs())) + 2e-4
    return float(((y.float() - r.float()).abs() - bound).max())


def check(device) -> bool:
    import types
    import torch
    from deepv_tpu_torch.ops import conv_igemm as cig

    gen = torch.Generator(device=device)
    gen.manual_seed(3)
    ok = True
    for ci, co, h, w, b, t_in, tp in CHECKS + ((128, 128, 6, 10, 1, 1, 2),):
        x = torch.randn((b, ci, t_in, h, w), generator=gen, device=device)
        p = types.SimpleNamespace(weight=0.02 * torch.randn((co, ci, 3, 3, 3), generator=gen,
                                                            device=device),
                                  bias=0.1 * torch.randn((co,), generator=gen, device=device))
        pb = types.SimpleNamespace(weight=p.weight.bfloat16(), bias=p.bias.bfloat16())
        xb = x.bfloat16()
        ref = cig.conv3d_igemm_plain(xb, pb, tp)
        t_out = t_in + tp - 2
        xcl = xb.to(memory_format=torch.channels_last_3d)
        pl = cig.make_plan(cig.CL_BN, co, b * t_out, h, w, channels_last=True)
        runs = [(pl, cig.launch(xcl, pb, tp, pl))]
        if w % 8 == 0:
            runs += [(pl, cig.launch(xb, pb, tp, pl)) for pl in plans_of(cig, b, co, t_out, h, w)]
        for pl, y in runs:
            torch.cuda.synchronize()
            ex = ulp_excess(y, ref)
            name = f"{'cl' if pl.channels_last else 'wgmma'} bn{pl.bn}"
            ok &= ex <= 0
            print(f"check {ci}->{co} @{h}x{w} b{b} t_in{t_in} tp{tp} {name}: max abs "
                  f"{float((y.float() - ref.float()).abs().max()):.4g} ulp excess {ex:.3g} "
                  f"{'ok' if ex <= 0 else 'FAIL'}", flush=True)
        y32 = cig.launch(x, p, tp, cig.make_plan(cig.CL_BN, co, b * t_out, h, w, True))
        r32 = cig.conv3d_igemm_plain(x, p, tp)
        fine = bool(torch.allclose(y32, r32, atol=2e-4, rtol=1e-4))
        ok &= fine
        print(f"check {ci}->{co} @{h}x{w} b{b} t_in{t_in} tp{tp} tf32x3: max abs "
              f"{float((y32 - r32).abs().max()):.3g} {'ok' if fine else 'FAIL'}", flush=True)
    return ok


def sweep(device):
    import torch
    import torch.nn.functional as F
    from chip_smoke import CONV_CASES, PEAK_BF16_FLOPS, conv_case_inputs, cuda_time_ms
    from deepv_tpu_torch.ops import conv_igemm as cig

    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device=device)
    gen.manual_seed(9)
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    rows = []
    for layer, mode, ci, co, h, w, n in CONV_CASES:
        x32, p32, tp = conv_case_inputs(mode, ci, co, h, w, n, gen, device)
        x = x32.bfloat16()
        p = type(p32)(weight=p32.weight.bfloat16(), bias=p32.bias.bfloat16())
        b, t_in = x.shape[0], x.shape[2]
        chosen = cig.tile_plan(b, co, n, h, w, sms)
        ref = cig.conv3d_igemm_plain(x, p, tp)
        flops = 2 * 27 * ci * co * n * h * w
        iters = 3 if flops > 1e12 else 8
        xl = F.pad(x, (0, 0, 0, 0, tp, 0)) if tp else x
        cudnn = cuda_time_ms(lambda: F.conv3d(xl, p.weight, p.bias, padding=(0, 1, 1)), iters)
        for pl in plans_of(cig, b, co, n, h, w):
            y = cig.launch(x, p, tp, pl)
            torch.cuda.synchronize()
            ex = ulp_excess(y, ref)
            ms = cuda_time_ms(lambda: cig.launch(x, p, tp, pl), iters)
            row = dict(ci=ci, co=co, h=h, w=w, frames=n, mode=mode, bn=pl.bn,
                       ctas=pl.grid[0] * pl.grid[1] * pl.grid[2],
                       chosen=pl == chosen, ms=ms, cudnn_ms=cudnn,
                       tflops=flops / (ms * 1e-3) / 1e12,
                       bound_ms=1e3 * flops / PEAK_BF16_FLOPS, ulp_excess=ex)
            rows.append(row)
            print("plan", json.dumps(row), flush=True)
        del x, x32, xl, ref, y
        torch.cuda.empty_cache()
    return rows


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("conv_igemm_plans: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    from deepv_tpu_torch.utils import cuda_build

    device = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(f"card: {smi}; torch {torch.__version__} cuda {torch.version.cuda}", flush=True)
    t0 = time.perf_counter()
    built = cuda_build.build("conv_igemm.cu")
    print(f"build: nvcc {built.seconds:.1f} s ({time.perf_counter() - t0:.1f} s with loading)")
    for line in built.log.splitlines():
        if "registers" in line or "spill" in line or "smem" in line or "warning" in line:
            print("  ptxas:", line.strip())
    ok = check(device)
    out = dict(card=smi, check_ok=ok)
    if ok and "--check" not in sys.argv:
        out["plans"] = sweep(device)
    out_dir = os.path.join(HERE, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "conv_igemm_plans.json"), "w") as f:
        json.dump(out, f, indent=1)
    print(smi)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
