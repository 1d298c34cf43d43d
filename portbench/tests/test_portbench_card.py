"""On the card: a short run of each cell through the command the driver
runs, which must end correct with its numbers. Skips without a card; run
with ``python3 -m pytest portbench/tests -m card``."""

import json
import os
import subprocess
import sys

import pytest

from portbench.tests import tiny


def pytest_generate_tests(metafunc):
    """Every cell of BENCHMARK.json, read while the tests are collected."""
    with open(os.path.join(tiny.ROOT, "BENCHMARK.json")) as f:
        metafunc.parametrize("name", [w["name"] for w in json.load(f)["workloads"]])


@pytest.mark.card
def test_short_run_on_the_card(name, card):
    proc = subprocess.run([sys.executable, os.path.join(tiny.ROOT, "portbench", "run.py"),
                           "--workload", name, "--seed", str(2 ** 31 + 101), "--seconds", "25",
                           "--trace", "0"], capture_output=True, text=True, cwd=tiny.ROOT,
                          timeout=1200)
    assert proc.returncode == 0, proc.stderr[-4000:]
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    assert result["correct"], result["checks"]
    assert result["device"]["platform"] == "gpu"
