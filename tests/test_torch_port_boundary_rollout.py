"""The chunk-boundary fast modes against deepv_tpu: ``reuse_decoder_cache``
with ``carry_latents``, in a 2-chunk f64 tiny rollout, with the streaming
decode and with the end-of-chunk decode.

The configuration, parameters and replayed draws are those of
tests/test_torch_port_pipeline.py (64x64, 11 actions). The second chunk
continues the first chunk's decoder caches (no priming, no overlap
re-decode) and conditions on the first chunk's own rgb latents; only the
disparity is re-encoded, so the port must ask for exactly one posterior
draw of batch 1 there (the replay checks every shape). Tolerance: the f64
rollout's ``ATOL = 1e-6``.
"""

import pytest
import torch

from test_torch_port_fast_rollout import check_rollout, rollout_pair

torch.set_num_threads(1)


@pytest.fixture(scope="module", params=[True, False], ids=["stream", "end_of_chunk"])
def boundary(request):
    return rollout_pair(stream_decode=request.param, reuse_decoder_cache=True,
                        carry_latents=True)


def test_boundary_rollout_matches_deepv_tpu(boundary):
    ref, ref_index, out, noise, _, _ = boundary
    check_rollout(ref, ref_index, out, noise)


def test_boundary_rollout_skips_priming(boundary):
    """Cache reuse turns the boundary's priming off; every forward ran."""
    _, _, _, _, pipe, _ = boundary
    assert pipe._prime_need is None
    assert pipe.timer.stats().get("prime") is None
    assert set(pipe.recompute_log) == {(1, 1, 1, 1, 1)}
