"""The readings that the limits of ``correct`` are set from, in one process.

    python3 portbench/calibrate.py --workload <cell> --seeds <n> [<n> ...] --seconds <s>

For each seed: the cell's system with that seed's weights and traffic
(without the warm-up, which only timing needs), a short window at the
cell's own load, then the reference over the window's samples and the
gaps of the program to it; then the control, the reference computed one
precision below the configuration's (its ``numerics.control``), in the
program's place, and its gaps. One JSON line a seed:
``{"seed", "program": {...}, "control": {...}}``. The benchmark's own
runs never run the control.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
# run as a script, this directory comes first on the path, where its
# modules (trace, inputs, ...) would shadow others of the same name
sys.path[:] = [p for p in sys.path if os.path.abspath(p or ".") != HERE]
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def readings(cell, seed: int, seconds: float, device, warm: bool = False,
             control: bool = True) -> dict:
    """The program's gaps on one seed and, with ``control``, the
    control's."""
    import torch

    from portbench import check, spec, system

    drv = spec.driver(cell.mix)
    st = drv.setup(cell, seed, device, False, warm=warm)
    drv.measure(st, seconds)
    rec = st.recorder
    extra = drv.teardown(st)
    del st
    gc.collect()
    t0 = time.perf_counter()
    checker = check.Checker(cell.config, seed, system.weights_seed(seed), device)
    ref = checker.outputs(rec.samples)
    t_ref = time.perf_counter() - t0
    prog = check.program_numbers(rec.samples, ref, extra.get("client_rgb"))
    ctrl = None
    if control:
        checker.set_mode(cell.config["numerics"]["control"])
        ctrl = check.control_numbers(ref, checker.outputs(rec.samples))
    checker.release()
    sampled = check.describe(rec.samples)
    del rec, ref
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    return {"seed": seed, "program": prog, "control": ctrl, "reference_s": t_ref,
            "sampled": sampled}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=30.0)
    ap.add_argument("--control-seeds", type=int, default=None,
                    help="run the control on the first this many seeds only (default all)")
    args = ap.parse_args(argv)

    import torch

    from portbench import spec, system
    cell = spec.load_cell(args.workload, ROOT)
    if not torch.cuda.is_available():
        print("calibrate: no CUDA card", file=sys.stderr)
        return 2
    system.configure_caches(ROOT)
    device = torch.device("cuda", 0)
    n_ctrl = len(args.seeds) if args.control_seeds is None else args.control_seeds
    for i, seed in enumerate(args.seeds):
        print(json.dumps(readings(cell, seed, args.seconds, device, control=i < n_ctrl)),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
