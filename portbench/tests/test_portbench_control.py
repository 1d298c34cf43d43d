"""The control: the reference one precision below the configuration's,
in the program's place, fails the limits that sound runs pass (here at
the tiny float32 size, where the limits are the tiny ones)."""

import torch

from portbench import calibrate
from portbench.tests import tiny


def test_control_fails_and_program_passes():
    torch.set_num_threads(2)
    cell = tiny.cell("exact.rollout")
    r = calibrate.readings(cell, 2 ** 31 + 31, 14.0, torch.device("cpu"))
    limits = cell.config["limits"]
    assert all(v <= limits[k] for k, v in r["program"].items()), r
    failed = [k for k, v in r["control"].items() if v > limits[k]]
    assert failed, r
    # the fp8 control misses on the denoise and the decode alike
    assert {"unit.2rows", "decode"} <= set(failed), r
