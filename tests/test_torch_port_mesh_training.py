"""Training over a mesh: the port's tensor-parallel gradients (fault F9) and
its DP x TP pyramid step on 4 gloo ranks on the CPU, in float64.

One ``parallel/launch.spawn`` of 4 processes (``torch_port_mesh_worker.
training_rank``, torch and the port only) on a (dp 2, tp 2) mesh runs:

  (a) F9: the gradient of ``sum(v**2)`` through the TP MMDiT (the PYR
      config of tests/test_torch_port_training.py, 2 of its 4 heads a rank)
      on tests/test_torch_port_parallel.py's packed inputs, against the
      single-device port's. Every leaf, sharded or replicated, within atol
      1e-10: both are the same f64 function summed in other orders. Before
      the repair the row-split sums were invisible to autograd and nothing
      summed the split inputs' or the head-dim norm scales' cotangents: on
      these inputs 35 of the 41 replicated leaves were wrong. The inference
      forward's reductions keep their count and bytes;
  (b) the DP x TP pyramid step at deepv_tpu's dry-run config
      (``deepv_tpu/parallel/dryrun.py``; stage 1, unit 3, a global batch of 4 rows, each dp rank 2) against
      deepv_tpu's step on its own (2, 2) mesh: its shardings
      (``shard_mmdit_params``, the batch over ``dp``), its jitted
      ``mmdit_forward`` under ``jax.value_and_grad``, its key's draws fed
      to the port's noise source through ``BatchSliceNoise``, then its
      jitted optax AdamW update. The pyramid loss around the forward runs op
      by op, as tests/test_torch_port_training.py runs it: jitted whole, XLA
      fuses the f32 timestep into one rounding (ROADMAP F1). Tolerances are
      that file's: loss and gradients atol 1e-8, parameters and AdamW
      moments after the step atol 1e-10; the ranks of each dp line end the
      step with the same bits;
  (c) one TP-only ``Trainer`` step (no mesh argument: after F9 the model's
      own forward makes the gradients whole) against the single-device
      ``Trainer``, parameters atol 1e-10;
  (d) F10: that step through ``Trainer.train(ckpt_every=1)`` on all four
      ranks into one ``ckpt_dir``. The checkpoint holds one whole tree, bit
      for bit the gather of the ranks' live parameters and AdamW moments,
      within (c)'s 1e-10 of the single-device ``Trainer``'s checkpoint after
      the same step; it restores bit for bit into a single-device trainer,
      into fresh tp-2 trainers and into a tp-4 one over all four ranks.
      Before the repair every rank wrote its own shard to the same
      ``state.pt.tmp``, and a rank died in ``os.replace``.

``run_dryrun(4, device="cpu")`` spawns its own 4 ranks and returns a
finite loss; on a machine without 4 cards the default (NCCL) refuses,
naming the count.
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax
from jax.sharding import NamedSharding, PartitionSpec as P

from deepv_tpu.config import MMDiTConfig, PipelineConfig
from deepv_tpu.models.scheduler import FlowMatchSchedule
from deepv_tpu.parallel.mesh import make_mesh as jax_make_mesh
from deepv_tpu.parallel.tp import shard_mmdit_params as jax_shard
from deepv_tpu.training import flow_matching as jax_fm

from deepv_tpu_torch.config import MMDiTConfig as TMMDiTConfig
from deepv_tpu_torch.io.weights import flatten_tree, params_from_numpy, random_mmdit_params
from deepv_tpu_torch.models.mmdit import MMDiT
from deepv_tpu_torch.parallel import dryrun
from deepv_tpu_torch.parallel.launch import spawn
from deepv_tpu_torch.parallel.mesh import Mesh
from deepv_tpu_torch.parallel.tp import mmdit_param_spec, shard_mmdit_params
from deepv_tpu_torch.pipeline import TorchNoise
from deepv_tpu_torch.training.trainer import Trainer

import torch_port_mesh_worker as worker
from test_torch_port_parallel import forward_inputs
from test_torch_port_training import (GRAD_ATOL, LR, PARAM_ATOL, PYR, WD, batch_np,
                                      correctly_rounded, pyramid_draws)

torch.set_num_threads(1)

RANKS = 4
#: F9: every leaf of the TP gradient against the single-device one
F9_ATOL = 1e-10
#: deepv_tpu/parallel/dryrun.py's tiny config at tp 2 (caption dim = inner
#: dim; the port's dry run takes head dim 64, its kernel's, instead of 8)
DP_CFG = dict(sample_size=16, patch_size=2, in_channels=8, num_layers=2, attention_head_dim=8,
              num_attention_heads=4, caption_projection_dim=32, pooled_projection_dim=16,
              pos_embed_max_size=32, joint_attention_dim=32)
STAGE, UNIT = 1, 3


def tree_np(cfg_kwargs, seed):
    t = random_mmdit_params(TMMDiTConfig(**cfg_kwargs), dtype=torch.float64, seed=seed,
                            device="cpu")
    return jax.tree.map(lambda a: a.numpy(), t)


def rank_view(rank):
    """Rank ``rank``'s view of the (2, 2) mesh without a process group (what
    ``shard_mmdit_params`` reads)."""
    return Mesh(("dp", "tp"), (2, 2), rank, torch.device("cpu"), {})


def deepv_tpu_step(tree, batch):
    """deepv_tpu's DP x TP step on its (2, 2) mesh: loss, gradients, params
    and AdamW moments after the update (numpy, flattened), and its draws."""
    cfg, pcfg = MMDiTConfig(**DP_CFG), PipelineConfig()
    sched = FlowMatchSchedule(pcfg.scheduler)
    key = jax.random.PRNGKey(4)
    with jax.enable_x64(), pytest.MonkeyPatch.context() as mp:
        for name in ("exp", "cos", "sin"):
            mp.setattr(jnp, name, correctly_rounded(getattr(jnp, name)))
        mp.setattr(jax_fm, "mmdit_forward", jax.jit(jax_fm.mmdit_forward, static_argnums=0))
        jax.clear_caches()
        mesh = jax_make_mesh((2, 2), ("dp", "tp"), devices=jax.devices("cpu")[:RANKS])
        params = jax_shard(jax.tree.map(jnp.asarray, tree), mesh, "tp")
        jb = {k: jax.device_put(jnp.asarray(v), NamedSharding(mesh, P("dp")))
              for k, v in batch.items()}
        opt = optax.adamw(LR, weight_decay=WD)
        with mesh:
            loss, grads = jax.value_and_grad(lambda p: jax_fm.pyramid_flow_matching_loss(
                cfg, pcfg, sched, p, jb, key, STAGE, UNIT))(params)
            state = opt.init(params)
            updates, state = jax.jit(opt.update)(grads, state, params)
            params = optax.apply_updates(params, updates)
        flat = lambda t: flatten_tree(jax.tree.map(lambda a: np.asarray(a, np.float64), t))
        out = dict(loss=float(loss), grads=flat(grads), params=flat(params),
                   mu=flat(state[0].mu), nu=flat(state[0].nu),
                   draws=pyramid_draws(key, batch["latents"].shape, STAGE))
    jax.clear_caches()
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    ckpt_dir = str(tmp_path_factory.mktemp("tp_ckpt"))
    pyr_tree, dp_tree = tree_np(PYR, 1), tree_np(DP_CFG, 2)
    forward = forward_inputs(np.random.default_rng(5))
    # the Trainer's batch: 2 rows of 8 latent frames
    forward["trainer_batch"] = batch_np(6, 2, 14, 8, 8, 24, 16)
    dp_batch = batch_np(3, 4, 8, 8, 8, 32, 16)
    ref = deepv_tpu_step(dp_tree, dp_batch)
    draws = {k: [v] for k, v in ref["draws"].items()}
    ranks = spawn(worker.training_rank, RANKS,
                  (PYR, pyr_tree, forward, DP_CFG, dp_tree, dp_batch, draws, LR, WD, ckpt_dir),
                  backend="gloo")
    return dict(pyr_tree=pyr_tree, forward=forward, ref=ref, ranks=ranks, ckpt_dir=ckpt_dir)


@pytest.fixture(scope="module")
def single_trainer(runs, tmp_path_factory):
    """The single-device ``Trainer`` of (c): one step with ``ckpt_every=1``.
    Returns (trainer, loss, its checkpoint's path)."""
    cfg = TMMDiTConfig(**PYR)
    ckpt_dir = str(tmp_path_factory.mktemp("single_ckpt"))
    trainer = Trainer(cfg, params_from_numpy(MMDiT(cfg), runs["pyr_tree"]), learning_rate=LR,
                      weight_decay=WD, sample_seed=3, device="cpu", ckpt_dir=ckpt_dir)
    batch = {k: torch.from_numpy(v) for k, v in runs["forward"]["trainer_batch"].items()}
    loss = float(trainer.train([batch], TorchNoise(11, "cpu"), ckpt_every=1, log_every=0)[0])
    return trainer, loss, os.path.join(ckpt_dir, "step_00000001")


def whole(ranks, key, name, leaf):
    """Leaf ``name`` of the tp ranks of dp line 0 put back together along its
    split (the leaf of rank 0 where it is replicated)."""
    spec = mmdit_param_spec(name, leaf)
    line = [r for r in ranks if r["dp"] == 0]
    if not spec:
        return line[0][key][name]
    return np.concatenate([r[key][name] for r in line], axis=spec.index("tp"))


def single_device_grads(tree, forward):
    model = params_from_numpy(MMDiT(TMMDiTConfig(**PYR)), tree).requires_grad_(True)
    v = worker._forward(model, forward)
    (v ** 2).sum().backward()
    return worker._grads(model)


def test_ranks_import_no_jax(runs):
    assert [r["rank"] for r in runs["ranks"]] == list(range(RANKS))
    assert all(r["forbidden_modules"] == [] for r in runs["ranks"])


def test_f9_tp_gradients_equal_the_single_device_ones(runs):
    """Fault F9's regression test: every gradient leaf of the TP MMDiT (2
    ranks) equals the single-device one."""
    ref = single_device_grads(runs["pyr_tree"], runs["forward"])
    wrong = []
    for name, g in ref.items():
        got = whole(runs["ranks"], "f9_grads", name, g)
        assert got.shape == g.shape, name
        if not np.allclose(got, g, rtol=0, atol=F9_ATOL):
            wrong.append((name, float(np.abs(got - g).max())))
    assert not wrong, f"{len(wrong)} of {len(ref)} leaves differ: {wrong[:8]}"
    # both tp ranks hold the replicated leaves' gradients with the same bits
    for r0, r1 in ((0, 1), (2, 3)):
        a, b = runs["ranks"][r0]["f9_grads"], runs["ranks"][r1]["f9_grads"]
        for name, g in ref.items():
            if not mmdit_param_spec(name, g):
                assert np.array_equal(a[name], b[name]), name


def test_f9_inference_reductions_unchanged(runs):
    """The forward reduces once per row-split linear (4 per joint block, 2 in
    the context-pre-only last one), in f64, with and without autograd; the
    backward adds one reduction per split input and per head-dim norm scale
    (4 + 4 in a full block, 4 + 3 in the last one: its ``ctx`` feeds no
    feed-forward). Under inference mode the forward's bits do not change."""
    f = runs["forward"]
    b, lv = f["clips"][0].shape[0], sum(c.shape[2] * 16 for c in f["clips"])
    lc = f["text"].shape[1] + f["history"].shape[2] * 4   # history at half resolution
    d = TMMDiTConfig(**PYR).inner_dim
    rows = [lv, lc, lv, lc, lv, lv]           # block 0: 4 reductions, the last block 2
    want = {"all_reduce": (len(rows), sum(b * n * d * 8 for n in rows))}
    for r in runs["ranks"]:
        (fwd_counts, fwd_bytes), (all_counts, _) = r["f9_counts"]
        inf_counts, inf_bytes = r["f9_inference"]
        for counts, nbytes in ((fwd_counts, fwd_bytes), (inf_counts, inf_bytes)):
            assert (counts["all_reduce"], nbytes["all_reduce"]) == want["all_reduce"]
            assert counts["all_gather"] == 0
        assert all_counts["all_reduce"] - fwd_counts["all_reduce"] == 8 + 7
        assert r["f9_forward_equal"]


def test_dp_tp_step_matches_deepv_tpu(runs):
    ref, ranks = runs["ref"], runs["ranks"]
    for r in ranks:
        assert r["dp_draws_left"] == 0
        np.testing.assert_allclose(r["dp_loss"], ref["loss"], rtol=0, atol=GRAD_ATOL)
        want = {k: flatten_tree(shard_mmdit_params(ref[k], rank_view(r["rank"])))
                for k in ("grads", "params", "mu", "nu")}
        for key, atol in (("grads", GRAD_ATOL), ("params", PARAM_ATOL), ("mu", PARAM_ATOL),
                          ("nu", PARAM_ATOL)):
            got = r[f"dp_{key}"]
            assert set(got) == set(want[key])
            for name, w in want[key].items():
                np.testing.assert_allclose(got[name], w, rtol=0, atol=atol,
                                           err_msg=f"rank {r['rank']} {key} {name}")


def test_dp_replicas_are_bit_equal(runs):
    ranks = runs["ranks"]
    for tp in (0, 1):
        a, b = (r for r in ranks if r["tp"] == tp)
        assert a["dp_loss"] == b["dp_loss"]
        for key in ("dp_grads", "dp_params", "dp_mu", "dp_nu"):
            for name, x in a[key].items():
                assert np.array_equal(x, b[key][name]), (tp, key, name)


def test_tp_trainer_step_matches_single_device(runs, single_trainer):
    trainer, loss, _ = single_trainer
    ref = worker._params(trainer.model)
    for r in runs["ranks"]:
        np.testing.assert_allclose(r["trainer_loss"], loss, rtol=0, atol=GRAD_ATOL)
    for name, w in ref.items():
        got = whole(runs["ranks"], "trainer_params", name, w)
        np.testing.assert_allclose(got, w, rtol=0, atol=PARAM_ATOL, err_msg=name)


def checkpoint_parts(runs):
    """Every rank's F10 results; fails with the first rank's error."""
    parts = [r["ckpt"] for r in runs["ranks"]]
    errors = [(r["rank"], p["error"]) for r, p in zip(runs["ranks"], parts) if "error" in p]
    assert not errors, f"the TP checkpoint failed on {len(errors)} ranks: {errors}"
    return parts


def load_tree(path):
    """A checkpoint's state tree as numpy, with the trainer state's keys."""
    from deepv_tpu_torch.io.checkpoint import STATE_FILE
    tree = torch.load(os.path.join(path, STATE_FILE), map_location="cpu", weights_only=True)
    opt = tree["opt_state"]
    return {"params": {k: v.numpy() for k, v in tree["params"].items()},
            "mu": {k: v.numpy() for k, v in opt["mu"].items()},
            "nu": {k: v.numpy() for k, v in opt["nu"].items()},
            "count": float(opt["count"])}


def same_bits(a, b):
    a, b = np.ascontiguousarray(a), np.ascontiguousarray(b)
    return a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a.view(np.uint8),
                                                                        b.view(np.uint8))


def assert_slices_of(tree, state, view, what):
    """``state`` (a trainer's numpy state) holds, bit for bit, ``view``'s
    slice of the whole checkpoint ``tree``."""
    for key in ("params", "mu", "nu"):
        want = flatten_tree(shard_mmdit_params(tree[key], view))
        assert set(state[key]) == set(want), (what, key)
        for name, w in want.items():
            assert same_bits(state[key][name], w), f"{what}: {key} {name}"
    assert state["count"] == [tree["count"]] * len(state["params"]), (what, state["count"])
    assert state["step"] == 1, (what, state["step"])


def test_f10_tp_trainer_checkpoints_one_whole_tree(runs, single_trainer):
    """Fault F10's regression test: ``train(ckpt_every=1)`` completes on the
    four ranks (two dp lines of tp 2) into one ``ckpt_dir``, and the
    checkpoint is one whole tree, bit for bit the gather of the ranks' live
    state, with the single-device format's metadata."""
    from deepv_tpu_torch.io.checkpoint import load_metadata
    parts = checkpoint_parts(runs)
    path = parts[0]["path"]
    assert all(p["path"] == path for p in parts)
    assert sorted(os.listdir(runs["ckpt_dir"])) == ["step_00000001", "step_00000001.meta.json"]
    assert os.listdir(path) == ["state.pt"]
    meta, single_meta = load_metadata(path), load_metadata(single_trainer[2])
    for key in ("step", "objective", "sample_seed"):
        assert meta[key] == single_meta[key], key
    tree, ranks = load_tree(path), runs["ranks"]
    shapes = {k: v.shape for k, v in worker._params(single_trainer[0].model).items()}
    for key in ("params", "mu", "nu"):
        assert {k: v.shape for k, v in tree[key].items()} == shapes, key
        for name, leaf in tree[key].items():
            spec = mmdit_param_spec(name, leaf)
            for dp in (0, 1):
                line = [p["live"][key][name] for r, p in zip(ranks, parts) if r["dp"] == dp]
                got = np.concatenate(line, axis=spec.index("tp")) if spec else line[0]
                assert same_bits(got, leaf), f"dp line {dp}: {key} {name}"
    assert all(p["live"]["count"] == [tree["count"]] * len(shapes) for p in parts)


def test_f10_tp_checkpoint_matches_the_single_device_one(runs, single_trainer):
    """The TP checkpoint against the single-device ``Trainer``'s after the
    same step: every leaf within (c)'s PARAM_ATOL, the count equal."""
    checkpoint_parts(runs)
    tree, ref = load_tree(runs["ranks"][0]["ckpt"]["path"]), load_tree(single_trainer[2])
    assert tree["count"] == ref["count"] == 1.0
    for key in ("params", "mu", "nu"):
        assert set(tree[key]) == set(ref[key]), key
        for name, w in ref[key].items():
            np.testing.assert_allclose(tree[key][name], w, rtol=0, atol=PARAM_ATOL,
                                       err_msg=f"{key} {name}")


def test_f10_tp_checkpoint_restores_on_one_device_and_on_tp2(runs, tmp_path):
    """The TP checkpoint restores bit for bit into a fresh single-device
    ``Trainer`` and into fresh tp-2 trainers on every rank."""
    parts = checkpoint_parts(runs)
    path = parts[0]["path"]
    tree = load_tree(path)
    cfg = TMMDiTConfig(**PYR)
    trainer = Trainer(cfg, params_from_numpy(MMDiT(cfg), runs["pyr_tree"]), learning_rate=LR,
                      weight_decay=WD, sample_seed=3, device="cpu")
    trainer.restore(path)
    state = worker._trainer_state(trainer)
    for key in ("params", "mu", "nu"):
        for name, w in tree[key].items():
            assert same_bits(state[key][name], w), f"one device: {key} {name}"
    assert state["count"] == [tree["count"]] * len(tree["params"]) and state["step"] == 1
    for r, p in zip(runs["ranks"], parts):
        assert_slices_of(tree, p["tp2"], rank_view(r["rank"]), f"tp 2, rank {r['rank']}")


def test_f10_tp_checkpoint_restores_on_tp4(runs):
    """The tp-2 checkpoint restores into a tp-4 model over all four ranks
    (one of PYR's 4 heads a rank): each rank's slices are
    ``shard_mmdit_params`` of the whole tree, bit for bit."""
    parts = checkpoint_parts(runs)
    tree = load_tree(parts[0]["path"])
    for r, p in zip(runs["ranks"], parts):
        view = Mesh(("tp",), (RANKS,), r["rank"], torch.device("cpu"), {})
        assert_slices_of(tree, p["tp4"], view, f"tp 4, rank {r['rank']}")


def test_run_dryrun_on_cpu_ranks():
    loss = dryrun.run_dryrun(RANKS, verbose=False, device="cpu")
    assert np.isfinite(loss) and loss > 0


def test_run_dryrun_refuses_without_the_cards(monkeypatch):
    """deepv_tpu's dryrun raises rather than clamp (tests/test_dryrun_entry.py);
    so does the port's, naming the cards it found."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="needs 4 CUDA cards.*this machine has 0"):
        dryrun.run_dryrun(RANKS)
