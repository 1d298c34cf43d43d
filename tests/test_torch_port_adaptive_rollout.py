"""Adaptive flow caching (``flow_cache="adaptive:0.5"``) against deepv_tpu:
a 2-chunk f64 tiny rollout with the configuration, parameters and replayed
draws of tests/test_torch_port_pipeline.py (64x64, 11 actions). Each step
after a stage's first runs its forward only when the latent's relative L1
drift since the last forward reaches 0.5, so the outputs agree only if
both packages take the same decisions. Tolerance: the f64 rollout's
``ATOL = 1e-6``.
"""

import pytest
import torch

from test_torch_port_fast_rollout import check_rollout, rollout_pair

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def adaptive():
    return rollout_pair(flow_cache="adaptive:0.5")


def test_adaptive_rollout_matches_deepv_tpu(adaptive):
    ref, ref_index, out, noise, _, _ = adaptive
    check_rollout(ref, ref_index, out, noise)


def test_adaptive_rollout_skips_some_forwards(adaptive):
    """Every stage's first step runs; tau = 0.5 skips some later ones but
    not all of them, so the rollout exercises both branches."""
    _, _, _, _, pipe, _ = adaptive
    log = pipe.recompute_log
    assert len(log) == 12 * 3 and all(ran[0] == 1 for ran in log)
    later = [r for ran in log for r in ran[1:]]
    assert 0 < sum(later) < len(later)
