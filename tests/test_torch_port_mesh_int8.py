"""The int8 paths over a mesh: the W8A8 linears under tensor parallelism and
the ``--fast`` rollout on 2 gloo ranks on the CPU.

One ``parallel/launch.spawn`` of 2 processes (``torch_port_mesh_worker.
int8_rank``, torch and the port only) runs:

  (a) ``linear_int8`` column-split (each rank's output channels) and
      row-split (each rank's input features: the group's maximum for the
      weight scale and for each token's scale, the int32 products summed
      over the ranks, the bias added once), against the whole layer, in f32
      and f64: bit for bit, since maxima and integer sums are exact;
  (b) the TP int8 MMDiT forward (``quantize_mmdit`` on each rank's share)
      against the single-device int8 forward on the same inputs, f32 and
      f64: bit for bit, with the same ``int_mm`` calls per rank;
  (c) a one-chunk ``--fast`` rollout on the mesh (flow caching "skip_odd",
      ``denoise_int8``, ``VAEConfig(conv_impl="int8")``) in float64 at
      64x64, replaying deepv_tpu's draws, against deepv_tpu's single-device
      rollout with the same options. Under context parallelism every VAE
      conv takes the library conv in both packages
      (``deepv_tpu/ops/causal_conv.py:125-129``), so deepv_tpu's mesh
      computes what its single-device rollout does at this size (64
      pixels, under ``MIN_H``); the port's ranks lower ``MIN_H`` to 64 and
      still never reach the int8 conv. deepv_tpu's denoise stages run op
      by op, as in tests/test_torch_port_fast_rollout.py: jitted, XLA's
      fused rounding of the f64 activations flips int8 values (measured
      here: 70% of the pixels off by up to 1.9e-3); its VAE, which
      quantises nothing at this size, stays jitted. Tolerance: that file's
      ATOL, 1e-6 (the f64 rollout's). The row-split reductions are int32
      sums and f32 maxima.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax

import deepv_tpu.pipeline as jax_pipeline
from deepv_tpu.actions import action_vocabulary, prepare_motion_prompts
from deepv_tpu.config import VAEConfig
from deepv_tpu.io.text_embeds import random_text_embeds

from deepv_tpu_torch.config import MMDiTConfig as TMMDiTConfig, VAEConfig as TVAEConfig
from deepv_tpu_torch.io.weights import random_mmdit_params, random_params
from deepv_tpu_torch.parallel.launch import spawn

import torch_port_mesh_worker as worker
from test_torch_port_fast_rollout import KEYS, op_by_op
from test_torch_port_parallel import forward_inputs
from test_torch_port_pipeline import ATOL, MCFG, _batch, _run_reference

torch.set_num_threads(1)

RANKS = 2
#: one chunk: 7 actions, 8 units, 57 frames
PROMPT = "(FN)(FN)(SR)(SL)(FN)(FN)(FN)"
FAST = dict(flow_cache="skip_odd", denoise_int8=True)
#: deepv_tpu's programs run op by op: the denoise, where the quantisers are
EAGER = ("_denoise_stage",)


def one_chunk_batch():
    b = _batch()
    return dict(b, prompt=np.array(prepare_motion_prompts("action", PROMPT)))


@pytest.fixture(scope="module")
def runs():
    params = random_params(TMMDiTConfig(**MCFG), TVAEConfig.tiny(), dtype=torch.float64,
                           seed=0, device="cpu")
    params = {k: jax.tree.map(lambda a: a.numpy(), v) for k, v in params.items()}
    embeds = random_text_embeds(0, action_vocabulary(), joint_dim=24, pooled_dim=16)
    patches = [(jax_pipeline, name, op_by_op(getattr(jax_pipeline, name))) for name in EAGER]
    with jax.enable_x64():
        ref, draws, ref_index = _run_reference(
            params, embeds, dataclasses.replace(VAEConfig.tiny(), conv_impl="int8"),
            one_chunk_batch(), patches, **FAST)
    tree = jax.tree.map(lambda a: a.numpy(), random_mmdit_params(
        TMMDiTConfig(**MCFG), dtype=torch.float64, seed=4, device="cpu"))
    ranks = spawn(worker.int8_rank, RANKS,
                  (MCFG, tree, forward_inputs(np.random.default_rng(6)), params, embeds,
                   one_chunk_batch(), draws), backend="gloo")
    return ref, ref_index, ranks


def test_ranks_import_no_jax(runs):
    _, _, ranks = runs
    assert [r["rank"] for r in ranks] == list(range(RANKS))
    assert all(r["forbidden_modules"] == [] for r in ranks)


@pytest.mark.parametrize("dtype", ["torch.float32", "torch.float64"])
@pytest.mark.parametrize("split", ["column", "row"])
def test_split_linear_int8_is_bit_equal(runs, dtype, split):
    for r in runs[2]:
        assert r["linear"][dtype][split], (r["rank"], dtype, split)
        assert r["linear"][dtype]["dtype"] == dtype


@pytest.mark.parametrize("dtype", ["torch.float32", "torch.float64"])
def test_tp_int8_forward_is_bit_equal(runs, dtype):
    for r in runs[2]:
        f = r[f"forward {dtype}"]
        assert f["equal"], (r["rank"], f["max_abs"])
        # 21 quantised linears a forward (12 in the first block, 9 in the last)
        assert f["int_mm"] == (21, 21)


@pytest.mark.parametrize("key", KEYS)
def test_mesh_fast_rollout_matches_deepv_tpu(runs, key):
    ref, _, ranks = runs
    got = ranks[0]["fast"][key].numpy()
    assert got.shape == ref[key].shape
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, ref[key], rtol=0, atol=ATOL)
    assert torch.equal(ranks[1]["fast"][key], ranks[0]["fast"][key])


def test_mesh_fast_rollout_paths(runs):
    """One chunk: 57 frames, no history; skip_odd ran steps 0, 2, 4 of each
    stage (8 units x 3 stages x 3 forwards), each forward's 21 quantised
    linears through int_mm on each rank, as on one device; the int8 conv
    never; the reductions: f64 sums (the CP group norms), f32 maxima and
    int32 sums (the row-split int8 linears); every draw consumed."""
    ref, ref_index, ranks = runs
    for r in ranks:
        out = r["fast"]
        assert tuple(out["pred_img"].shape) == (1, 3, 57, 64, 64)
        assert out["history_index"] == ref_index == []
        assert set(r["fast_recompute"]) == {(1, 0, 1, 0, 1)}
        forwards = sum(map(sum, r["fast_recompute"]))
        assert forwards == 8 * 3 * 3
        assert r["fast_int_mm"] == forwards * 21
        assert r["fast_conv_int8"] == 0
        assert r["fast_reductions"] == [("torch.float32", "max"), ("torch.float64", "sum"),
                                        ("torch.int32", "sum")]
        assert all(n == 0 for n in r["fast_draws_left"].values()), r["fast_draws_left"]
