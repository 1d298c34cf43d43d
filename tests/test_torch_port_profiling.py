"""The port's ``utils/profiling.py`` against deepv_tpu's, on the CPU.

Every public name of ``deepv_tpu/utils/profiling.py`` has a counterpart:
``PhaseTimer`` (``phase`` with ``sync_value``, ``add``, ``stats``,
``report``), ``force_completion`` and, for ``tpu_trace``,
``device_trace``. The timers are fed the same recorded seconds, so their
statistics and reports must be equal, keys and rounding included.
"""

import json

import pytest
import torch

import deepv_tpu.utils.profiling as jax_profiling

from deepv_tpu_torch.utils import profiling

torch.set_num_threads(1)

#: seconds as a phase timer records them: (phase, seconds) in call order,
#: with values whose sums and means round at the 4th place
RECORDED = [("denoise_unit", 0.123456789), ("vae_decode", 1.00005), ("denoise_unit", 2.5e-5),
            ("prime", 0.33333333), ("denoise_unit", 7.000049999), ("vae_decode", 0.0)]


def test_public_names_have_counterparts():
    ported = {"tpu_trace": "device_trace"}
    for name in ("PhaseTimer", "force_completion", "tpu_trace"):
        assert hasattr(jax_profiling, name)
        assert callable(getattr(profiling, ported.get(name, name))), name
    for method in ("phase", "add", "stats", "report"):
        assert callable(getattr(jax_profiling.PhaseTimer, method))
        assert callable(getattr(profiling.PhaseTimer, method)), method


def test_add_stats_and_report_match_deepv_tpu():
    ref, got = jax_profiling.PhaseTimer(sync=False), profiling.PhaseTimer()
    for name, seconds in RECORDED:
        ref.add(name, seconds)
        got.add(name, seconds)
    assert got.stats() == ref.stats()
    assert list(got.stats()) == list(ref.stats()) == ["denoise_unit", "vae_decode", "prime"]
    assert got.stats()["denoise_unit"] == {"total_s": 7.1235, "count": 3, "mean_s": 2.3745}
    assert got.report() == ref.report()
    assert json.loads(got.report()) == got.stats()


def test_phase_waits_for_its_sync_value(monkeypatch):
    """``phase(name, sync_value=...)`` synchronises the devices of the value's
    tensors (nested in dicts, lists and tuples, other leaves skipped) once
    each before the clock stops, and counts one call."""
    synced = []
    monkeypatch.setattr(profiling, "synchronize", lambda device: synced.append(str(device)))
    timer = profiling.PhaseTimer()
    a, b = torch.ones(3), torch.zeros(2, dtype=torch.float64)
    with timer.phase("vae_decode", sync_value={"rgb": a, "rest": [b, (None, 4, "x")]}):
        torch.mm(torch.ones(4, 4), torch.ones(4, 4))
    assert synced == ["cpu"]
    stats = timer.stats()["vae_decode"]
    assert stats["count"] == 1 and stats["total_s"] >= 0.0
    with timer.phase("vae_decode"):
        pass
    assert synced == ["cpu"] and timer.stats()["vae_decode"]["count"] == 2


def test_nested_phases_count_in_their_parent():
    timer = profiling.PhaseTimer()
    with timer.phase("outer"):
        with timer.phase("inner"):
            torch.ones(8).sum()
        timer.add("inner", 0.5)
    stats = timer.stats()
    assert stats["inner"]["count"] == 2 and stats["outer"]["count"] == 1
    assert stats["inner"]["total_s"] >= 0.5


def test_force_completion_on_cpu_tensors():
    out = {"pred_img": torch.randn(1, 3, 2, 4, 4), "trans3d": [torch.eye(4)], "index": [3],
           "none": None}
    assert profiling.force_completion(out) is None
    assert profiling.force_completion(torch.ones(2)) is None
    assert profiling.force_completion("no tensors") is None


def test_device_trace_on_the_cpu_writes_a_chrome_trace(tmp_path):
    logdir = tmp_path / "trace"
    with profiling.device_trace(str(logdir), device="cpu") as where:
        assert where == str(logdir)
        torch.mm(torch.ones(64, 64), torch.ones(64, 64))
    with open(logdir / profiling.TRACE_FILE) as f:
        trace = json.load(f)
    names = {e.get("name") for e in trace["traceEvents"]}
    assert "aten::mm" in names


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the refusal without a card")
def test_device_trace_on_a_card_needs_one(tmp_path):
    with pytest.raises(RuntimeError, match="no CUDA device"):
        with profiling.device_trace(str(tmp_path)):
            pass
