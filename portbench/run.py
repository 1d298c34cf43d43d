"""The port's benchmark: one cell of ``BENCHMARK.json``, run once.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Runs on the CUDA card and fails without one (or with fewer cards than
the cell asks for); it never falls back to the CPU. Set-up builds the
cell's configuration with weights and inputs drawn from ``--seed``, and
runs every shape the traffic uses once. The window then measures for
``--seconds``: with ``--trace 0`` the cell's end-to-end metrics, with
``--trace 1`` its per-layer metrics, from a run that times the
pipeline's phases and profiles a slice of units around a chunk boundary
(the spans and rates of a traced run leave the slice out).
After the window the program is freed and the plain reference
(``reference/``) computes again a seeded sample of the work the window
did; each gap compared is printed beside its limit (the last lines of
standard error, and ``checks``, the last key of the result). The last
line of standard output is the result:

    {"correct": ..., "attempted": ..., "failed": ..., "metrics": {...},
     "device": {...}, "breakdown": {...}, "checks": {...}}

The kernel libraries are built into ``portbench/.cache`` of the checkout,
so only a checkout's first run compiles.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from types import SimpleNamespace  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
# run as a script, this directory comes first on the path, where its
# modules (trace, inputs, ...) would shadow others of the same name
sys.path[:] = [p for p in sys.path if os.path.abspath(p or ".") != HERE]
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

#: top-level modules that no run may have loaded when it reports
FORBIDDEN = ("jax", "jaxlib", "flax", "deepv_tpu")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is forbidden, compared whole."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def execute(cell, seed: int, seconds: float, traced: bool, device, t_start: float,
            log=print) -> tuple:
    """Set-up, the window, the reading of the trace, the check and the
    metrics of one run of ``cell`` on ``device``. Returns (result, checks)."""
    import torch

    from portbench import check, spec, system
    from portbench.counting import peaks

    drv = spec.driver(cell.mix)
    st = drv.setup(cell, seed, device, traced)
    system.synchronize(device)
    setup_s = time.perf_counter() - t_start
    log(f"[portbench] set-up {setup_s:.1f} s")
    system.settle()
    m = drv.measure(st, seconds)
    n_gc, gc_s = system.unsettle()
    log(f"[portbench] window {m.window_s:.1f} s: {m.attempted} requests, {m.frames} frames, "
        f"{len(m.steps)} steps; {n_gc} collections in {gc_s:.3f} s")
    # each request's seconds, and how long its deliveries waited for the card
    for t, w in zip(getattr(m, "request_s", []), getattr(m, "request_sync", [])):
        log(f"[portbench] request {t:.3f} s, waiting for the card {w:.3f} s")
    rec = st.recorder
    extra = drv.teardown(st)
    del st
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()

    t0 = time.perf_counter()
    trace = rec.tracer.reduce() if rec.tracer is not None else None
    if rec.tracer is not None:
        log(f"[portbench] trace read in {time.perf_counter() - t0:.1f} s")
    attn_bound = None
    kind = torch.cuda.get_device_name(0) if torch.device(device).type == "cuda" else "cpu"
    pk = peaks(kind)
    if rec.attn_calls and trace is not None:
        from portbench.counting import attention_cost, roofline_seconds
        attn_bound = 0.0
        for b, s, h, d, esize, pairs in rec.attn_calls:
            ops, nbytes = attention_cost(b, s, h, d, int(pairs), esize)
            attn_bound += roofline_seconds(ops, nbytes, pk["bf16_flops"], pk["bytes_per_s"])
        rec.attn_calls = []

    # a traced run's spans and rates leave out the profiled slice: its
    # seconds (the profiler's stop with them), frames and steps
    window_s, frames, steps, session_steps = m.window_s, m.frames, m.steps, rec.session_steps
    sl = rec.slice
    if sl is not None and "seconds" in sl:
        window_s -= sl["seconds"]
        frames -= rec.slice_frames()
        a, b = sl.get("steps", (0, 0))
        steps, session_steps = steps[:a] + steps[b:], session_steps[:a] + session_steps[b:]
    run = SimpleNamespace(window_s=window_s, frames=frames, steps=steps,
                          session_steps=session_steps, setup_s=setup_s,
                          peak_bytes=m.peak_bytes, phases=rec.phases, ops=rec.ops(), trace=trace,
                          attention_bound_s=attn_bound, peaks=pk, traced=traced)

    cfg = cell.config
    t0 = time.perf_counter()
    checker = check.Checker(cfg, seed, system.weights_seed(seed), device)
    ref = checker.outputs(rec.samples)
    nums = check.program_numbers(rec.samples, ref, extra.get("client_rgb"))
    checker.release()
    checks = check.judge(nums, cfg["limits"],
                         required=[k for k in cfg["checked"] if k in drv.CHECKED])
    log(f"[portbench] reference check: {time.perf_counter() - t0:.1f} s; sampled "
        + "; ".join(f"{k}: {v}" for k, v in check.describe(rec.samples).items()))

    metrics = {}
    for mdef in (cell.per_layer if traced else cell.end_to_end):
        value = spec.reader(mdef["name"]).read(run)
        if value is not None:
            metrics[mdef["name"]] = {"value": value, "unit": mdef["unit"]}
    dev = {"platform": "gpu" if torch.device(device).type == "cuda" else "cpu", "kind": kind,
           "count": cell.chips, "memory_peak_bytes": int(m.peak_bytes)}
    result = {"correct": check.passed(checks) and m.failed == 0, "attempted": m.attempted,
              "failed": m.failed, "metrics": metrics, "device": dev}
    if traced and trace is not None:
        dev["busy_s"] = trace["busy_s"]
        dev["window_s"] = trace["window_s"]
        result["breakdown"] = {"device_ops": trace["device_ops"], "idle_gaps": trace["idle_gaps"]}
    result["checks"] = checks
    return result, checks


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from portbench import spec
    cell = spec.load_cell(args.workload, ROOT)

    import torch
    # one thread does the host's work: the program launches from one
    # thread, and idle intra-op workers only take cores from it
    torch.set_num_threads(1)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"portbench: {args.workload} needs {cell.chips} CUDA card(s); this machine has {n}",
              file=sys.stderr)
        return 2

    from portbench import system
    system.configure_caches(ROOT)
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    result, checks = execute(cell, args.seed, args.seconds, bool(args.trace), device, T_START,
                             log=lambda s: print(s, file=sys.stderr, flush=True))

    bad = forbidden_modules()
    if bad:
        print(f"portbench: the run loaded {', '.join(bad)}; no result", file=sys.stderr)
        return 3
    for name, c in checks.items():
        print(f"check {name}: {c['value']} (limit {c['limit']})", file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
