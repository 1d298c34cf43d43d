"""Each traffic driver end to end at the tiny size on the CPU, through the
code the card runs (``run.execute``): the result line's keys, the metrics
read by name, and a ``correct`` that holds for a sound program and fails
for a broken one.

Faults planted in the timed path, each of which must read as not correct:
a unit whose Euler steps return their state unchanged; half of the
classifier-free-guidance batch left out of each forward, the mean of the
rest in its place; a decoded frame altered where it is produced; at a
served boundary, another history frame retrieved than the rule's. (No
cell spans chips, so no exchange between chips can be left out.)
"""

import json
import time

import pytest
import torch

from portbench import run as prun
from portbench import spec
from portbench.tests import tiny

#: seconds of a tiny window: long enough for a chunk boundary and its samples
SECONDS = {"rollout": 14.0, "serve": 14.0}
SEED = 2 ** 31 + 977


@pytest.fixture(autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def execute(name, traced=False, seed=SEED, cell=None):
    cell = cell or tiny.cell(name)
    return prun.execute(cell, seed, SECONDS[cell.traffic_name], traced, torch.device("cpu"),
                        time.perf_counter(), log=lambda s: None)


@pytest.mark.parametrize("name,config", [("exact.rollout", None),
                                         ("exact.rollout", "deepverse1.1-fast"),
                                         ("exact.serve", None)])
def test_driver_end_to_end(name, config, monkeypatch):
    if config == "deepverse1.1-fast":
        # the int8 conv at the tiny heights, in the program and the reference
        import deepv_tpu_torch.ops.conv_int8 as k3
        monkeypatch.setattr(k3, "MIN_H", 32)
    cell = tiny.cell(name, config)
    cell.config["numerics"]["int8_min_h"] = 32
    result, checks = execute(name, cell=cell)
    assert list(result)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(result)[-1] == "checks"
    assert result["correct"], checks
    assert result["failed"] == 0 and result["attempted"] >= 1
    names = {m["name"]: m["unit"] for m in cell.end_to_end}
    # peak_gib reads the card's allocator and is absent on the CPU
    assert set(result["metrics"]) == set(names) - {"peak_gib"}
    for k, v in result["metrics"].items():
        assert v["unit"] == names[k] and v["value"] > 0
    assert all(c["value"] is not None and c["value"] <= c["limit"] for c in checks.values())
    assert set(spec.driver(cell.mix).CHECKED) <= set(checks)
    json.dumps(result)


def test_traced_rollout_reads_its_spans():
    result, _ = execute("exact.rollout", traced=True)
    assert result["correct"]
    m = result["metrics"]
    # the device trace's metrics need the card; the spans and counts do not
    assert {"denoise_unit_s", "decode_ms_per_frame", "mfu"} <= set(m)
    assert 0 < m["mfu"]["value"] < 100


def _fault_unchanged_state(monkeypatch):
    import deepv_tpu_torch.pipeline as pl
    monkeypatch.setattr(pl, "euler_step", lambda sample, velocity, dsigma: sample)


def _fault_half_batch(monkeypatch):
    import deepv_tpu_torch.pipeline as pl
    orig = pl.mmdit_forward

    def half(model, clips, text, mask, pooled, t, history=None, history_mask=None, **kw):
        b = clips[-1].shape[0]
        k = (b + 1) // 2
        cut = lambda x: None if x is None else x[:k]
        v = orig(model, [c[:k] for c in clips], text[:k], mask[:k], pooled[:k], t[:k],
                 history=cut(history), history_mask=cut(history_mask), **kw)
        return torch.cat([v] + [v.mean(dim=0, keepdim=True)] * (b - k))

    monkeypatch.setattr(pl, "mmdit_forward", half)


def _fault_altered_frame(monkeypatch):
    import deepv_tpu_torch.pipeline as pl
    orig = pl._dec_window

    def altered(*args, **kw):
        y, cache = orig(*args, **kw)
        y = y.clone()
        y[:, :, -1] += 0.25
        return y, cache

    monkeypatch.setattr(pl, "_dec_window", altered)


@pytest.mark.parametrize("name", ["exact.rollout", "exact.serve"])
@pytest.mark.parametrize("fault", [_fault_unchanged_state, _fault_half_batch,
                                   _fault_altered_frame])
def test_a_broken_timed_path_is_not_correct(name, fault, monkeypatch):
    fault(monkeypatch)
    result, checks = execute(name)
    assert not result["correct"], checks


def test_a_wrong_history_frame_is_not_correct(monkeypatch):
    """The retrieval takes the frame that turns most, of the five nearest,
    where the rule takes the one that turns least: the served cell's
    boundaries read it."""
    import deepv_tpu_torch.pipeline as pl
    orig = pl.InferencePipeline._retrieve_history

    def turned(self, *args):
        with monkeypatch.context() as m:
            m.setattr(torch, "argmin", torch.argmax)
            return orig(self, *args)

    monkeypatch.setattr(pl.InferencePipeline, "_retrieve_history", turned)
    result, checks = execute("exact.serve")
    assert not result["correct"]
    assert checks["history_index"]["value"] == 1.0, checks
