"""What a run loads: in a fresh interpreter, a whole tiny run through
``run.execute`` loads no module whose top-level name is ``jax``,
``jaxlib``, ``flax`` or ``deepv_tpu`` (compared whole, so the port's
``deepv_tpu_torch`` is no match), and the reference loads none of the
program either."""

import json
import subprocess
import sys

from portbench.tests import tiny

RUN = r"""
import json, sys, time
sys.path.insert(0, {root!r})
import torch
torch.set_num_threads(2)
from portbench import run
from portbench.tests import tiny
run.execute(tiny.cell("exact.rollout"), 5, 12.0, False, torch.device("cpu"), time.perf_counter(),
            log=lambda s: None)
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""

REFERENCE = r"""
import json, sys
sys.path.insert(0, {root!r})
import portbench.reference.mmdit, portbench.reference.vae, portbench.reference.rollout
import portbench.reference.params, portbench.reference.numerics
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def loaded(code: str) -> set:
    proc = subprocess.run([sys.executable, "-c", code.format(root=tiny.ROOT)],
                          capture_output=True, text=True, timeout=600, cwd=tiny.ROOT)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return set(json.loads(proc.stdout.strip().splitlines()[-1]))


def test_a_run_loads_no_jax():
    names = loaded(RUN)
    assert "deepv_tpu_torch" in names            # the program ran
    assert not names & {"jax", "jaxlib", "flax", "deepv_tpu"}, names


def test_the_reference_loads_no_program():
    names = loaded(REFERENCE)
    assert not names & {"jax", "jaxlib", "flax", "deepv_tpu", "deepv_tpu_torch"}, names
