"""The harness finds a cell's configuration, traffic mix and metric
readers by name: a new one is files and entries only. And
``BENCHMARK.json`` keeps to the contract's shapes."""

import json
import os
import re
import shutil
import subprocess
import sys

import pytest

from portbench import spec
from portbench.tests import tiny

ROOT = tiny.ROOT
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def test_added_files_are_found_by_name(tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(os.path.join(ROOT, "portbench"), root / "portbench",
                    ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    b = bench()
    cfg = json.load(open(root / "portbench" / "configs" / "deepverse1.1-exact.json"))
    cfg["name"] = "deepverse1.1-adaptive"
    cfg["serving"]["flow_cache"] = "adaptive:0.5"
    (root / "portbench" / "configs" / "deepverse1.1-adaptive.json").write_text(json.dumps(cfg))
    (root / "portbench" / "traffic" / "rollout-long.json").write_text(json.dumps(
        {"driver": "rollout", "rounds": [[24, 27]]}))
    (root / "portbench" / "metrics" / "ttff_s.py").write_text(
        "def read(run):\n    return run.deliveries[0][0] if run.deliveries else None\n")
    b["configs"].append({"name": "deepverse1.1-adaptive", "source": b["configs"][0]["source"],
                         "file": "portbench/configs/deepverse1.1-adaptive.json", "reduced": [],
                         "why": "flow caching"})
    b["workloads"].append({"name": "adaptive.rollout-long", "config": "deepverse1.1-adaptive",
                           "traffic": "rollout-long", "chips": 1, "why": "long rollouts"})
    b["per_layer"].append({"name": "ttff_s", "unit": "s", "better": "lower",
                           "source": "host_clock", "layer": "pipeline", "moves": "frames_per_s",
                           "workloads": ["adaptive.rollout-long"]})
    b["end_to_end"][0]["workloads"].append("adaptive.rollout-long")
    (root / "BENCHMARK.json").write_text(json.dumps(b))

    cell = spec.load_cell("adaptive.rollout-long", str(root))
    assert cell.config["serving"]["flow_cache"] == "adaptive:0.5"
    assert cell.mix["rounds"] == [[24, 27]]
    assert [m["name"] for m in cell.per_layer] == ["ttff_s"]
    assert "frames_per_s" in [m["name"] for m in cell.end_to_end]
    reader = spec.reader("ttff_s", str(root / "portbench"))
    assert reader.read(type("R", (), {"deliveries": [(1.25, 1)]})) == 1.25
    assert spec.driver(cell.mix).__name__ == "portbench.drivers.rollout"
    with pytest.raises(KeyError):
        spec.load_cell("no.such", str(root))


def test_every_metric_has_a_reader_and_every_cell_its_files():
    b = bench()
    for m in b["end_to_end"] + b["per_layer"]:
        assert callable(spec.reader(m["name"]).read), m["name"]
    for w in b["workloads"]:
        cell = spec.load_cell(w["name"], ROOT)
        assert cell.config["name"] == w["config"]
        assert spec.driver(cell.mix).CHECKED


def test_benchmark_json_shapes():
    b = bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                      "per_layer"}
    assert b["paths"] == ["portbench"] and 1 <= b["run_seconds"] <= 51
    names = set()
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("portbench/") and os.path.isfile(os.path.join(ROOT, c["file"]))
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] == 1
        assert len(w["why"]) <= 200
    e2e = {m["name"] for m in b["end_to_end"]}
    assert "setup_s" in e2e
    for m in b["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in b["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["moves"] in e2e
        for cell in m.get("workloads", []):
            moved = next(x for x in b["end_to_end"] if x["name"] == m["moves"])
            assert cell in moved.get("workloads", [cell])
    for item in b["configs"] + b["workloads"] + b["end_to_end"] + b["per_layer"]:
        assert NAME.match(item["name"]) and item["name"] not in names
        names.add(item["name"])
        if "unit" in item:
            assert UNIT.match(item["unit"])
    assert len(json.dumps(b)) < 64 * 1024


def test_no_card_no_result():
    """Without a card (as here) the run exits non-zero and prints no result."""
    proc = subprocess.run([sys.executable, os.path.join(ROOT, "portbench", "run.py"),
                           "--workload", "exact.rollout", "--seed", "3", "--seconds", "1"],
                          capture_output=True, text=True, cwd=ROOT, timeout=300)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""


def test_every_seed_sends_the_same_rollout_sizes_in_order():
    from portbench import loadgen
    mix = spec.load_cell("exact.rollout", ROOT).mix
    draws = [list(zip(range(7), loadgen.rollouts(mix, seed, 8, 8))) for seed in (3, 2 ** 31 + 5)]
    sizes = [[r["chunks"] for _, r in d] for d in draws]
    assert sizes[0] == sizes[1] == [1] * 7
    assert draws[0][0][1]["actions"] != draws[1][0][1]["actions"]
    rounds = {"rounds": [[12, 15], [4, 7], [8, 11]]}
    assert [r["chunks"] for _, r in zip(range(4), loadgen.rollouts(rounds, 1, 8, 8))] == [3, 1, 2, 3]
    with pytest.raises(ValueError):
        next(loadgen.rollouts({"rounds": [[8, 12]]}, 1, 8, 8))    # 2 and 3 chunks in one range


@pytest.mark.parametrize("warm_steps,traced", [(9, (1, 3)), (0, (6, 8)), (8, (2, 4)),
                                               (11, (3, 5)), (12, (2, 4))])
def test_a_served_trace_holds_a_chunk_boundary(warm_steps, traced):
    """The session driver profiles the window's steps around the first step
    that ends a chunk (the 8th step of a session, then every 4th), with one
    step on either side, whatever the mix's warm-up."""
    from portbench import loadgen
    first, last = loadgen.boundary_steps(warm_steps, 8, 4)
    assert (first, last) == traced
    ends = [warm_steps + k + 1 for k in range(first, last + 1)]
    assert [s >= 8 and (s - 8) % 4 == 0 for s in ends] == [False, True, False]


def test_warm_up_rollout_has_the_chunks_asked_for():
    from portbench import loadgen
    assert [loadgen.chunks_of(loadgen.actions_for(c)) for c in (1, 2, 3)] == [1, 2, 3]
    assert loadgen.chunks_of(loadgen.actions_for(2) + 1) == 3
