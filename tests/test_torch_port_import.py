"""The port stands alone: importing it pulls in neither JAX nor deepv_tpu.

The import check runs in a fresh, isolated interpreter (this test process
has JAX loaded by the conftest). A source scan backs it up for imports that
only run inside functions.
"""

import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
PACKAGE = ROOT / "deepv_tpu_torch"


def port_modules():
    mods = []
    for path in sorted(PACKAGE.rglob("*.py")):
        parts = path.relative_to(ROOT).with_suffix("").parts
        mods.append(".".join(parts[:-1] if parts[-1] == "__init__" else parts))
    return mods


def test_every_module_imports_without_jax():
    code = (
        "import importlib, json, sys\n"
        f"sys.path.insert(0, {str(ROOT)!r})\n"
        f"for m in {port_modules()!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'deepv_tpu'))\n"
        "print(json.dumps(bad))\n")
    proc = subprocess.run([sys.executable, "-I", "-c", code], capture_output=True, text=True,
                          timeout=300, cwd=str(ROOT))
    assert proc.returncode == 0, proc.stderr
    assert json.loads(proc.stdout.strip().splitlines()[-1]) == []
    assert len(port_modules()) >= 20


@pytest.mark.parametrize("path", sorted(PACKAGE.rglob("*.py")) + [ROOT / "chip_smoke.py",
                                                                    ROOT / "tools" / "profile_port.py"],
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_source_imports_no_jax_or_deepv_tpu(path):
    """Also function-level imports: no ``import jax...`` and no import of
    ``deepv_tpu`` (the port keeps its own copies of what it needs)."""
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""] if node.level == 0 else []
        else:
            continue
        for name in names:
            assert name.split(".")[0] not in ("jax", "jaxlib", "deepv_tpu"), \
                f"{path.name}:{node.lineno} imports {name}"


def test_source_scan_reaches_every_kernel_module():
    """The scan above covers the modules of every kernel and int8 path."""
    scanned = {str(p.relative_to(PACKAGE)) for p in PACKAGE.rglob("*.py")}
    for module in ("ops/attention.py", "ops/conv_igemm.py", "ops/conv_int8.py",
                   "ops/linear_int8.py", "models/mmdit.py", "pipeline.py"):
        assert module in scanned, module


def test_chip_smoke_refuses_without_cuda(tmp_path):
    """Without a CUDA device, and alone in a directory, chip_smoke.py exits
    non-zero and prints no result line."""
    alone = tmp_path / "chip_smoke.py"
    alone.write_text((ROOT / "chip_smoke.py").read_text())
    for script in (ROOT / "chip_smoke.py", alone):
        env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
        proc = subprocess.run([sys.executable, str(script)], capture_output=True, text=True,
                              timeout=300, cwd=str(script.parent), env=env)
        assert proc.returncode != 0
        assert '"ok"' not in proc.stdout
