"""The port stands alone: importing it pulls in no JAX, optax, orbax or deepv_tpu.

The import check runs in a fresh, isolated interpreter (this test process
has JAX loaded by the conftest). A source scan backs it up for imports that
only run inside functions. No port module imports ``safetensors`` or
``transformers`` when it is imported: the port reads safetensors files
itself, and only the text encoder's tokenising needs ``transformers``,
imported when an encoder is built.
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
#: packages the port does not depend on: imported by no module when it is imported
ABSENT_ON_CARD = ("safetensors", "transformers")


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
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'deepv_tpu', 'optax', 'orbax',\n"
        "                                    'safetensors', 'transformers'))\n"
        "print(json.dumps(bad))\n")
    proc = subprocess.run([sys.executable, "-I", "-c", code], capture_output=True, text=True,
                          timeout=300, cwd=str(ROOT))
    assert proc.returncode == 0, proc.stderr
    assert json.loads(proc.stdout.strip().splitlines()[-1]) == []
    assert len(port_modules()) >= 20


def imported_names(node):
    """Absolute module names an import statement names ([] for others)."""
    if isinstance(node, ast.Import):
        return [a.name for a in node.names]
    if isinstance(node, ast.ImportFrom) and node.level == 0:
        return [node.module or ""]
    return []


def module_level_nodes(tree):
    """The nodes that run when the module is imported: all but the bodies
    of functions and lambdas."""
    todo = list(ast.iter_child_nodes(tree))
    while todo:
        node = todo.pop()
        yield node
        if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
            todo.extend(ast.iter_child_nodes(node))


@pytest.mark.parametrize("path", sorted(PACKAGE.rglob("*.py")) + [ROOT / "chip_smoke.py",
                                                                    ROOT / "tools" / "profile_port.py"],
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_source_imports_no_jax_or_deepv_tpu(path):
    """Also function-level imports: no ``import jax...``, no optax or orbax
    and no import of ``deepv_tpu`` (the port keeps its own copies of what it
    needs). At module level, no ``safetensors`` or ``transformers`` either:
    a machine without them still imports every module."""
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        for name in imported_names(node):
            assert name.split(".")[0] not in ("jax", "jaxlib", "deepv_tpu", "optax", "orbax"), \
                f"{path.name}:{node.lineno} imports {name}"
    for node in module_level_nodes(tree):
        for name in imported_names(node):
            assert name.split(".")[0] not in ABSENT_ON_CARD, \
                f"{path.name}:{node.lineno} imports {name} at module level"


def test_source_scan_reaches_every_kernel_module():
    """The scan above covers the modules of every kernel and int8 path, the
    serving (its mesh follower too), training and mesh entry points, the
    dry run, the kernel build and its AOT cache; the import check imports
    them too."""
    scanned = {str(p.relative_to(PACKAGE)) for p in PACKAGE.rglob("*.py")}
    for module in ("ops/attention.py", "ops/conv_igemm.py", "ops/conv_int8.py",
                   "ops/linear_int8.py", "models/mmdit.py", "pipeline.py", "serve.py",
                   "io/checkpoint.py", "training/flow_matching.py", "training/trainer.py",
                   "parallel/comm.py", "parallel/cp.py", "parallel/launch.py",
                   "parallel/mesh.py", "parallel/tp.py", "parallel/dryrun.py",
                   "utils/cuda_build.py", "utils/aot.py"):
        assert module in scanned, module
    for module in ("deepv_tpu_torch.serve", "deepv_tpu_torch.training.trainer",
                   "deepv_tpu_torch.parallel.launch", "deepv_tpu_torch.parallel.dryrun",
                   "deepv_tpu_torch.utils.aot"):
        assert module in port_modules(), module


def test_mesh_entry_points_import_without_jax():
    """What a spawned rank of the dry run or of mesh serving imports, alone
    in a fresh interpreter: the dry run's rank function and the serving
    follower pull in no JAX and no deepv_tpu."""
    code = (
        "import json, sys\n"
        f"sys.path.insert(0, {str(ROOT)!r})\n"
        "from deepv_tpu_torch.parallel.dryrun import dryrun_rank, run_dryrun\n"
        "from deepv_tpu_torch.serve import SessionServer, follow\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'deepv_tpu', 'optax', 'orbax'))\n"
        "print(json.dumps(bad))\n")
    proc = subprocess.run([sys.executable, "-I", "-c", code], capture_output=True, text=True,
                          timeout=300, cwd=str(ROOT))
    assert proc.returncode == 0, proc.stderr
    assert json.loads(proc.stdout.strip().splitlines()[-1]) == []


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
