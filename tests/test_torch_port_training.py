"""The port's training against deepv_tpu's, in float64 on the CPU.

deepv_tpu's flow-matching losses, gradients and optax AdamW updates on
tests/test_training.py's configs (``MMDiTConfig.tiny()`` for the single-clip
objective, ``PYR_CFG`` with ``PipelineConfig()`` for the pyramid one) under
``jax.enable_x64()``, parameters from deepv_tpu's init carried over by
``params_from_numpy``, batches from a numpy seed, and deepv_tpu's own
random draws (its keys split as its losses split them) handed to the port's
noise source. All JAX work runs once, in the module fixture.

Tolerances:
  * pyramid loss and every gradient leaf, atol 1e-8: both evaluate the same
    f64 formulas (test_torch_port_mmdit.py holds the forward at 1e-8). The
    losses cast the velocity to f32 before the square, so the gradients
    carry an f32 cotangent; both frameworks form it by the same
    elementwise rule, so it does not move them apart;
  * the single-clip loss, rtol 1e-6: it is a float32 mean in both (its
    target is cast to f32), summed in other orders;
  * parameters and moments after AdamW steps, atol 1e-10: updates of size
    ~lr = 3e-3 by the same arithmetic in another order;
  * the sampled curriculum and checkpoint resume: equal.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from deepv_tpu.config import MMDiTConfig, PipelineConfig
from deepv_tpu.models.mmdit import init_mmdit_params
from deepv_tpu.models.scheduler import FlowMatchSchedule
from deepv_tpu.training import flow_matching as jax_fm
from deepv_tpu.training.flow_matching import flow_matching_loss, pyramid_flow_matching_loss
from deepv_tpu.training.trainer import Trainer as JaxTrainer

from deepv_tpu_torch.config import MMDiTConfig as TMMDiTConfig
from deepv_tpu_torch.config import PipelineConfig as TPipelineConfig
from deepv_tpu_torch.io.checkpoint import restore_pytree
from deepv_tpu_torch.io.weights import flatten_tree, params_from_numpy, set_adamw_state
from deepv_tpu_torch.models.mmdit import MMDiT
from deepv_tpu_torch.models.scheduler import FlowMatchSchedule as TFlowMatchSchedule
from deepv_tpu_torch.pipeline import TorchNoise
from deepv_tpu_torch.training import flow_matching as port_fm
from deepv_tpu_torch.training.trainer import Trainer

torch.set_num_threads(1)

# tests/test_training.py:63-67
PYR = dict(sample_size=16, patch_size=2, in_channels=14, num_layers=2,
           attention_head_dim=8, num_attention_heads=4, caption_projection_dim=32,
           pooled_projection_dim=16, pos_embed_max_size=32, joint_attention_dim=24)
PYR_UNITS = ((0, 1), (1, 4), (2, 7))
LR, WD = 3e-3, 0.01
GRAD_ATOL, PARAM_ATOL, F32_LOSS_RTOL = 1e-8, 1e-10, 1e-6
N_STEPS = 3


def correctly_rounded(fn):
    """``fn`` evaluated for float32 inputs in f64 and rounded to f32, as the
    port evaluates the timestep embedding's exp/cos/sin (as in
    test_torch_port_mmdit.py)."""
    def wrapped(x, *args, **kwargs):
        if getattr(x, "dtype", None) == jnp.float32:
            return fn(jnp.asarray(x).astype(jnp.float64), *args, **kwargs).astype(jnp.float32)
        return fn(x, *args, **kwargs)
    return wrapped


def f64_tree(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float64), tree)


def batch_np(seed, b, c, t, hw, joint, pooled):
    rng = np.random.default_rng(seed)
    return {"latents": rng.standard_normal((b, c, t, hw, hw)),
            "text_embeds": rng.standard_normal((b, 7, joint)),
            "text_mask": np.ones((b, 7), np.int32),
            "pooled": rng.standard_normal((b, pooled))}


def single_draws(key, shape):
    """deepv_tpu's draws in flow_matching_loss (its key split)."""
    k_noise, k_sigma = jax.random.split(key)
    return {"noise": np.asarray(jax.random.normal(k_noise, shape, jnp.float64)),
            "sigma": np.asarray(jax.random.uniform(k_sigma, (shape[0],), jnp.float32,
                                                   1e-4, 1.0 - 1e-4))}


def pyramid_draws(key, lat_shape, stage, n_stages=3):
    """deepv_tpu's draws in pyramid_flow_matching_loss (its key split; the
    Gaussians in the default float, z and the ratio in f32)."""
    b, c, _, h, w = lat_shape
    k_end, k_prev, k_block, k_ratio = jax.random.split(key, 4)
    at = lambda s: (b, c, 1, h // 2 ** (n_stages - 1 - s), w // 2 ** (n_stages - 1 - s))
    x1 = at(stage)
    d = {"end": np.asarray(jax.random.normal(k_end, x1)),
         "prev": np.asarray(jax.random.normal(k_prev, x1 if stage == 0 else at(stage - 1))),
         "ratio": np.asarray(jax.random.uniform(k_ratio, (b,), jnp.float32, 0.0, 1.0))}
    if stage > 0:
        d["block"] = np.asarray(jax.random.normal(
            k_block, (b, c, 1, x1[3] // 2, x1[4] // 2, 4), dtype=jnp.float32))
    return d


class FedNoise:
    """A noise source handing out given draws by kind, in order, each once;
    a draw must come in the dtype the port asks for."""

    def __init__(self, *steps):
        self.queues = {}
        for d in steps:
            for kind, x in d.items():
                self.queues.setdefault(kind, []).append(x)

    def _take(self, kind, shape, dtype):
        x = torch.from_numpy(np.array(self.queues[kind].pop(0)))
        assert tuple(x.shape) == tuple(shape) and x.dtype == dtype, (kind, x.shape, x.dtype,
                                                                      shape, dtype)
        return x

    def normal(self, kind, shape, dtype):
        return self._take(kind, shape, dtype)

    def uniform(self, kind, shape, low, high, dtype=torch.float32):
        return self._take(kind, shape, dtype)

    def empty(self):
        return not any(self.queues.values())


@pytest.fixture(scope="module")
def ref():
    """Every deepv_tpu result the tests compare with, in f64."""
    jax.clear_caches()   # no program traced without this module's f32 patch
    tiny, pyr, pcfg = MMDiTConfig.tiny(), MMDiTConfig(**PYR), PipelineConfig()
    sched = FlowMatchSchedule(pcfg.scheduler)
    out = {"single_batch": batch_np(1, 2, tiny.in_channels, 2, 8, 24, 16),
           "pyr_batch": batch_np(2, 2, 14, 8, 8, 24, 16)}
    with jax.enable_x64(), pytest.MonkeyPatch.context() as mp:
        for name in ("exp", "cos", "sin"):
            mp.setattr(jnp, name, correctly_rounded(getattr(jnp, name)))
        tree_s = f64_tree(init_mmdit_params(jax.random.PRNGKey(0), tiny))
        tree_p = f64_tree(init_mmdit_params(jax.random.PRNGKey(1), pyr))
        out.update(tree_s=tree_s, tree_p=tree_p)
        bs = {k: jnp.asarray(v) for k, v in out["single_batch"].items()}
        bp = {k: jnp.asarray(v) for k, v in out["pyr_batch"].items()}

        # single clip: AdamW steps from the init; step 0's loss and gradients
        vg = jax.jit(jax.value_and_grad(lambda p, b, k: flow_matching_loss(tiny, p, b, k)))
        opt = optax.adamw(LR, weight_decay=WD)

        @jax.jit
        def update(g, st, p):
            u, st = opt.update(g, st, p)
            return optax.apply_updates(p, u), st

        params, st = jax.tree.map(jnp.asarray, tree_s), None
        st = opt.init(params)
        steps = []
        for i in range(N_STEPS):
            key = jax.random.PRNGKey(100 + i)
            loss, grads = vg(params, bs, key)
            params, st = update(grads, st, params)
            steps.append(dict(draws=single_draws(key, bs["latents"].shape), loss=float(loss),
                              grads=f64_tree(grads), params=f64_tree(params),
                              count=int(st[0].count), mu=f64_tree(st[0].mu),
                              nu=f64_tree(st[0].nu)))
        out["single_steps"] = steps

        # pyramid: loss and gradients at three (stage, unit), the loss op by op
        # around a jitted model forward: jitted whole, XLA fuses the f32
        # timestep ratio * t_max + (1 - ratio) * t_min into one rounding
        # (ROADMAP F1), which moves the f32 embedding by an ulp of ~1000
        mp.setattr(jax_fm, "mmdit_forward", jax.jit(jax_fm.mmdit_forward, static_argnums=0))
        pj = jax.tree.map(jnp.asarray, tree_p)
        pyr_out = {}
        for stage, unit in PYR_UNITS:
            key = jax.random.PRNGKey(200 + stage)
            loss, grads = jax.value_and_grad(
                lambda p: pyramid_flow_matching_loss(pyr, pcfg, sched, p, bp, key, stage,
                                                     unit))(pj)
            pyr_out[(stage, unit)] = dict(draws=pyramid_draws(key, bp["latents"].shape, stage),
                                          loss=float(loss), grads=f64_tree(grads))
        out["pyramid"] = pyr_out
    return out


def port_model(tree, cfg):
    return params_from_numpy(MMDiT(cfg), tree).requires_grad_(True)


def torch_batch(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


def check_grads(model, grads_ref):
    """Every leaf's gradient; None (a leaf no gradient reached) as zeros."""
    flat = flatten_tree(grads_ref)
    named = dict(model.named_parameters())
    assert set(flat) == set(named)
    for name, p in named.items():
        got = torch.zeros_like(p) if p.grad is None else p.grad
        np.testing.assert_allclose(got.numpy(), flat[name], rtol=0, atol=GRAD_ATOL,
                                   err_msg=name)


def check_params(model, params_ref, atol=PARAM_ATOL):
    flat = flatten_tree(params_ref)
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), flat[name], rtol=0, atol=atol,
                                   err_msg=name)


def test_single_clip_loss_and_grads(ref):
    """(a) flow_matching_loss and the gradient of every leaf."""
    step = ref["single_steps"][0]
    model = port_model(ref["tree_s"], TMMDiTConfig.tiny())
    noise = FedNoise(step["draws"])
    loss = port_fm.flow_matching_loss(model, torch_batch(ref["single_batch"]), noise)
    assert noise.empty() and loss.dtype == torch.float32
    loss.backward()
    np.testing.assert_allclose(loss.item(), step["loss"], rtol=F32_LOSS_RTOL)
    check_grads(model, step["grads"])


@pytest.mark.parametrize("stage,unit", PYR_UNITS)
def test_pyramid_loss_and_grads(ref, stage, unit):
    """(b) pyramid_flow_matching_loss and every gradient leaf at (stage, unit)."""
    r = ref["pyramid"][(stage, unit)]
    model = port_model(ref["tree_p"], TMMDiTConfig(**PYR))
    noise = FedNoise(r["draws"])
    pcfg = TPipelineConfig()
    loss = port_fm.pyramid_flow_matching_loss(model, pcfg, TFlowMatchSchedule(pcfg.scheduler),
                                              torch_batch(ref["pyr_batch"]), noise, stage, unit)
    assert noise.empty() and loss.dtype == torch.float64
    loss.backward()
    np.testing.assert_allclose(loss.item(), r["loss"], rtol=0, atol=GRAD_ATOL)
    check_grads(model, r["grads"])


def test_adamw_steps_match_optax(ref):
    """(c) three Trainer steps against optax.adamw on the same draws; the
    unused pos_embed.proj_history gets a zero gradient and is still decayed
    and its moments advanced, as optax does."""
    steps = ref["single_steps"]
    trainer = Trainer(TMMDiTConfig.tiny(), port_model(ref["tree_s"], TMMDiTConfig.tiny()),
                      learning_rate=LR, weight_decay=WD, objective="single_clip", device="cpu")
    batch = torch_batch(ref["single_batch"])
    unused = "pos_embed.proj_history.weight"
    before = dict(trainer.model.named_parameters())[unused].detach().clone()
    for i, step in enumerate(steps):
        losses = trainer.train([batch], FedNoise(step["draws"]), log_every=0)
        np.testing.assert_allclose(losses[0].item(), step["loss"], rtol=F32_LOSS_RTOL)
        check_params(trainer.model, step["params"])
    after = dict(trainer.model.named_parameters())[unused].detach()
    np.testing.assert_allclose(after.numpy(), before.numpy() * (1 - LR * WD) ** N_STEPS,
                               rtol=1e-12)
    assert not np.array_equal(after.numpy(), before.numpy())
    assert float(np.abs(flatten_tree(steps[-1]["grads"])[unused]).max()) == 0.0


def test_optax_state_carried_across(ref):
    """(d) deepv_tpu's params and optax state after 2 steps carried into the
    port (set_adamw_state), then one more step on each side."""
    s2, s3 = ref["single_steps"][1], ref["single_steps"][2]
    trainer = Trainer(TMMDiTConfig.tiny(), port_model(s2["params"], TMMDiTConfig.tiny()),
                      learning_rate=LR, weight_decay=WD, objective="single_clip", device="cpu")
    set_adamw_state(trainer.optimizer, trainer.model, s2["count"], s2["mu"], s2["nu"])
    trainer.train([torch_batch(ref["single_batch"])], FedNoise(s3["draws"]), log_every=0)
    check_params(trainer.model, s3["params"])
    mu, nu = flatten_tree(s3["mu"]), flatten_tree(s3["nu"])
    for name, p in trainer.model.named_parameters():
        st = trainer.optimizer.state[p]
        assert st["step"].item() == s3["count"] == 3
        np.testing.assert_allclose(st["exp_avg"].numpy(), mu[name], rtol=0, atol=PARAM_ATOL)
        np.testing.assert_allclose(st["exp_avg_sq"].numpy(), nu[name], rtol=0, atol=1e-14)


def test_sample_stage_unit_matches(ref):
    """(e) the host-side (stage, unit_index) draw for 30 steps, and the
    one-unit refusal with deepv_tpu's message."""
    jt = JaxTrainer(MMDiTConfig(**PYR), ref["tree_p"], learning_rate=1e-3, sample_seed=5)
    pt = Trainer(TMMDiTConfig(**PYR), port_model(ref["tree_p"], TMMDiTConfig(**PYR)),
                 learning_rate=1e-3, sample_seed=5, device="cpu")
    batch = ref["pyr_batch"]
    seen = set()
    for s in range(30):
        jt.step = pt.step = s
        draw = pt._sample_stage_unit(batch)
        assert draw == jt._sample_stage_unit(batch)
        seen.add(draw)
    assert len(seen) > 3
    one = {"latents": batch["latents"][:, :, :1]}
    with pytest.raises(ValueError) as jerr:
        jt._sample_stage_unit(one)
    with pytest.raises(ValueError, match="2 latent units") as perr:
        pt._sample_stage_unit(one)
    assert str(perr.value) == str(jerr.value)


def test_checkpoint_resume(ref, tmp_path):
    """(f) save after 2 pyramid steps, restore into a fresh trainer: equal bit
    for bit, and its next step equal bit for bit to the uninterrupted run's.
    A checkpoint of the other objective, or of another shape, raises and
    leaves the trainer untouched."""
    cfg = TMMDiTConfig(**PYR)
    batch = torch_batch(ref["pyr_batch"])
    a = Trainer(cfg, port_model(ref["tree_p"], cfg), learning_rate=LR, weight_decay=WD,
                ckpt_dir=str(tmp_path), sample_seed=3, device="cpu")
    for i in range(2):
        a.train([batch], TorchNoise(10 + i, "cpu"), log_every=0)
    path = a.save()
    assert path.endswith("step_00000002")
    snap = {k: v.detach().clone() for k, v in a.model.named_parameters()}
    snap_mu = [a.optimizer.state[p]["exp_avg"].clone() for p in a.model.parameters()]
    a.train([batch], TorchNoise(12, "cpu"), log_every=0)

    b = Trainer(cfg, port_model(ref["tree_p"], cfg),
                learning_rate=LR, weight_decay=WD, sample_seed=0, device="cpu")
    for p in b.model.parameters():      # a different starting point
        torch.nn.init.normal_(p.data)
    b.restore(path)
    assert (b.step, b.sample_seed) == (2, 3)
    for (name, p), mu in zip(b.model.named_parameters(), snap_mu):
        assert torch.equal(p, snap[name]), name
        assert torch.equal(b.optimizer.state[p]["exp_avg"], mu), name
        assert b.optimizer.state[p]["step"].item() == 2
    b.train([batch], TorchNoise(12, "cpu"), log_every=0)
    for (name, pa), pb in zip(a.model.named_parameters(), b.model.parameters()):
        assert torch.equal(pa, pb), name
        assert torch.equal(a.optimizer.state[pa]["exp_avg_sq"], b.optimizer.state[pb]["exp_avg_sq"])

    c = Trainer(cfg, port_model(ref["tree_p"], cfg), learning_rate=LR, objective="single_clip",
                device="cpu")
    before = {k: v.detach().clone() for k, v in c.model.named_parameters()}
    with pytest.raises(ValueError, match="objective"):
        c.restore(path)
    small = Trainer(TMMDiTConfig.tiny(), port_model(ref["tree_s"], TMMDiTConfig.tiny()),
                    device="cpu")
    small_before = {k: v.detach().clone() for k, v in small.model.named_parameters()}
    with pytest.raises(ValueError, match="template"):
        small.restore(path)      # pyramid objective, 14 input channels against 6
    for t, ref_params in ((c, before), (small, small_before)):
        assert t.step == 0
        for name, p in t.model.named_parameters():
            assert torch.equal(p, ref_params[name]), name
    with pytest.raises(KeyError, match="no entry"):
        restore_pytree(path, {"params": {"not_a_leaf": torch.zeros(1)}})


def test_trainer_pyramid_objective_reduces_loss(ref):
    """(g) the counterpart of test_training.py's loss-reduction run: the
    default pyramid objective, 2-unit clips, 36 steps at lr 3e-3."""
    cfg = TMMDiTConfig(**PYR)
    model = params_from_numpy(MMDiT(cfg), jax.tree.map(lambda a: np.asarray(a, np.float32),
                                                       ref["tree_p"]))
    trainer = Trainer(cfg, model, learning_rate=3e-3, device="cpu")
    assert trainer.objective == "pyramid"
    b = {k: v[:, :, :2] if k == "latents" else v for k, v in ref["pyr_batch"].items()}
    batch = {k: torch.from_numpy(v.astype(np.float32) if v.dtype == np.float64 else v)
             for k, v in b.items()}
    losses = [float(l) for l in trainer.train([batch] * 36, TorchNoise(1, "cpu"), log_every=0)]
    first, last = np.mean(losses[:6]), np.mean(losses[-6:])
    assert last < first * 0.8, (first, last)
