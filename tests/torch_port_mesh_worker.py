"""Rank functions of the port's multi-process CPU tests (gloo, one process
per rank, started by ``deepv_tpu_torch.parallel.launch.spawn``).

This module imports torch and the port only, so a spawned rank imports
neither JAX nor deepv_tpu; each rank returns the modules of those it holds
(``forbidden_modules``), which the tests check is none. The tests compute
their references in the parent process.
"""

from __future__ import annotations

import os
import sys

import numpy as np
import torch

from deepv_tpu_torch.config import MMDiTConfig, PipelineConfig, VAEConfig
from deepv_tpu_torch.io.weights import params_from_numpy
from deepv_tpu_torch.models.mmdit import Int8Linear, MMDiT, mmdit_forward, quantize_mmdit
from deepv_tpu_torch.models.scheduler import FlowMatchSchedule
from deepv_tpu_torch.models.vae import VAE
from deepv_tpu_torch.ops import causal_conv, conv_int8, linear_int8
from deepv_tpu_torch.parallel import comm, cp
from deepv_tpu_torch.parallel.mesh import Mesh, make_mesh
from deepv_tpu_torch.parallel.tp import shard_mmdit_params
from deepv_tpu_torch.pipeline import InferencePipeline, TorchNoise
from deepv_tpu_torch.training.flow_matching import BatchSliceNoise, make_pyramid_train_step
from deepv_tpu_torch.training.trainer import Trainer


def forbidden_modules():
    return sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "deepv_tpu"))


def cpu_mesh(axis_sizes, axis_names):
    n = int(np.prod(axis_sizes))
    return make_mesh(axis_sizes, axis_names, devices=["cpu"] * n, backend="gloo")


def _np(tree):
    """A returned cache tree with numpy leaves."""
    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_np(v) for v in tree]
    return None if tree is None else tree.numpy()


def _error(fn):
    """(type name, message) of what ``fn()`` raises, or None."""
    try:
        fn()
    except Exception as e:   # the tests compare the type and text
        return type(e).__name__, str(e)
    return None


def parallel_rank(mcfg_kwargs: dict, mmdit_tree, forward: dict, vae_tree, vae_inputs: dict):
    """Every mesh function of the port on this rank, in float64: the TP
    forward, the seven ``parallel/cp.py`` functions (``tcp_vae_encode`` on a
    2-rank axis of a 2 x 2 mesh), ``cp_dec_window`` over two carried windows
    (pixels and this rank's caches), and the refusals. Returns numpy."""
    torch.set_num_threads(1)
    mesh = cpu_mesh((4,), ("tp",))
    mcfg, vcfg = MMDiTConfig(**mcfg_kwargs), VAEConfig.tiny()
    out = {"rank": mesh.rank}

    model = params_from_numpy(MMDiT(mcfg, tp_group=mesh.group("tp")),
                              shard_mmdit_params(mmdit_tree, mesh))
    comm.reset_counts()
    t = lambda a: torch.from_numpy(a)
    out["tp_forward"] = mmdit_forward(
        model, [t(c) for c in forward["clips"]], t(forward["text"]), t(forward["mask"]),
        t(forward["pooled"]), t(forward["timestep"]), history=t(forward["history"]),
        history_mask=t(forward["history_mask"]),
        frame_times=[t(x) for x in forward["frame_times"]],
        frame_valid=[t(x) for x in forward["frame_valid"]], split_last_attn=True).numpy()
    out["tp_reductions"] = comm.counts["all_reduce"]

    vae = params_from_numpy(VAE(vcfg), vae_tree)
    x = {k: t(v) for k, v in vae_inputs.items()}
    out["cp_vae_encode"] = cp.cp_vae_encode(vcfg, vae, x["encode"], mesh, "tp").numpy()
    out["cp_vae_decode"] = cp.cp_vae_decode(vcfg, vae, x["decode"], mesh, "tp").numpy()
    out["cp_vae_encode_chunked"] = cp.cp_vae_encode_chunked(
        vcfg, vae, x["encode_chunked"], mesh, "tp", window_size=8).numpy()
    out["cp_vae_decode_chunked"] = cp.cp_vae_decode_chunked(
        vcfg, vae, x["decode_chunked"], mesh, "tp", window_size=2).numpy()
    out["tcp_vae_decode"] = cp.tcp_vae_decode(vcfg, vae, x["tcp_decode"], mesh, "tp").numpy()
    y0, cache = cp.cp_dec_window(vcfg, vae.decoder, x["window0"], None, "init", mesh)
    y1, cache = cp.cp_dec_window(vcfg, vae.decoder, x["window1"], cache, "cont", mesh)
    out["cp_dec_window"] = (y0.numpy(), y1.numpy(), _np(cache))

    mesh2 = cpu_mesh((2, 2), ("dp", "tp"))
    out["mesh2"] = (mesh2.index("dp"), mesh2.index("tp"),
                    comm.all_reduce(torch.tensor([float(mesh.rank)]), mesh2.group("tp")).item(),
                    comm.all_reduce(torch.tensor([float(mesh.rank)]), mesh2.group("dp")).item())
    out["tcp_vae_encode"] = cp.tcp_vae_encode(vcfg, vae, x["tcp_encode"], mesh2, "tp").numpy()

    bad = {k: t(v) for k, v in vae_inputs.items() if k.startswith("bad_")}
    out["refusals"] = {
        "cp_vae_encode": _error(lambda: cp.cp_vae_encode(vcfg, vae, bad["bad_pixels"], mesh, "tp")),
        "cp_vae_decode": _error(lambda: cp.cp_vae_decode(vcfg, vae, bad["bad_latents"], mesh,
                                                         "tp")),
        "cp_vae_encode_chunked": _error(lambda: cp.cp_vae_encode_chunked(
            vcfg, vae, bad["bad_pixels"], mesh, "tp", window_size=8)),
        "cp_vae_decode_chunked": _error(lambda: cp.cp_vae_decode_chunked(
            vcfg, vae, bad["bad_latents"], mesh, "tp")),
        "cp_dec_window": _error(lambda: cp.cp_dec_window(vcfg, vae.decoder, bad["bad_latents"],
                                                         None, "init", mesh)),
        "tcp_vae_decode": _error(lambda: cp.tcp_vae_decode(vcfg, vae, bad["bad_frames"], mesh,
                                                           "tp")),
        "tcp_vae_encode": _error(lambda: cp.tcp_vae_encode(vcfg, vae, x["tcp_encode"], mesh,
                                                           "tp")),
        "make_mesh size": _error(lambda: cpu_mesh((3,), ("tp",))),
        "make_mesh backend": _error(lambda: make_mesh((4,), ("tp",), devices=["cpu"] * 4)),
        "make_mesh cards": _error(lambda: make_mesh((4,), ("tp",), backend="gloo")),
    }
    out["forbidden_modules"] = forbidden_modules()
    return out


class ReplayNoise:
    """A noise source replaying recorded draws in order per kind."""

    def __init__(self, draws):
        self.queues = {k: list(v) for k, v in draws.items()}

    def normal(self, kind, shape, dtype):
        a = self.queues[kind].pop(0)
        assert a.shape == tuple(shape), (kind, a.shape, shape)
        return torch.from_numpy(a).to(dtype)


def rollout_rank(mcfg_kwargs: dict, params, embeds, batch, draws):
    """A float64 tiny rollout on a 2-rank mesh with the recorded draws, then
    an adaptive-caching rollout (tau 0.5, the port's own noise) on the same
    mesh, then the recorded draws' rollout decoded at the end of the chunk
    as one batch-2 call (``decode_batched``). Returns the outputs, the
    adaptive run's recompute decisions and the batched decode's batches."""
    torch.set_num_threads(1)
    mesh = cpu_mesh((2,), ("tp",))
    mcfg, vcfg = MMDiTConfig(**mcfg_kwargs), VAEConfig.tiny()
    out = {"rank": mesh.rank}
    pipe = InferencePipeline(PipelineConfig(), mcfg, vcfg, params, embeds, dtype=torch.float64,
                             device="cpu", mesh=mesh)
    noise = ReplayNoise(draws)
    out["exact"] = pipe.generate(batch, seed=9, noise=noise)
    out["draws_left"] = {k: len(q) for k, q in noise.queues.items()}
    pipe = InferencePipeline(PipelineConfig(), mcfg, vcfg, params, embeds, dtype=torch.float64,
                             device="cpu", mesh=mesh, flow_cache="adaptive:0.5")
    out["adaptive"] = pipe.generate(batch, seed=9, noise=TorchNoise(9, "cpu"))
    out["adaptive_decisions"] = list(pipe.recompute_log)
    # rgb and disparity decoded as one batch-2 context-parallel call
    pipe = InferencePipeline(PipelineConfig(), mcfg, vcfg, params, embeds, dtype=torch.float64,
                             device="cpu", mesh=mesh, stream_decode=False, decode_batched=True)
    import deepv_tpu_torch.pipeline as pipeline_module
    decode, batches = pipeline_module.cp_vae_decode_chunked, []

    def decode_spy(cfg, p, z, *args, **kwargs):
        batches.append(z.shape[0])
        return decode(cfg, p, z, *args, **kwargs)

    pipeline_module.cp_vae_decode_chunked = decode_spy
    try:
        noise = ReplayNoise(draws)
        out["batched"] = pipe.generate(batch, seed=9, noise=noise)
    finally:
        pipeline_module.cp_vae_decode_chunked = decode
    out["batched_decode_batches"] = batches
    out["batched_draws_left"] = {k: len(q) for k, q in noise.queues.items()}
    out["forbidden_modules"] = forbidden_modules()
    return out


class FedDraws:
    """A noise source handing out given draws (numpy, by kind, in order);
    a draw must have the shape and dtype the port asks for."""

    def __init__(self, draws):
        self.queues = {k: list(v) for k, v in draws.items()}

    def _take(self, kind, shape, dtype):
        x = torch.from_numpy(np.array(self.queues[kind].pop(0)))
        assert tuple(x.shape) == tuple(shape) and x.dtype == dtype, (kind, x.shape, shape)
        return x

    def normal(self, kind, shape, dtype):
        return self._take(kind, shape, dtype)

    def uniform(self, kind, shape, low, high, dtype=torch.float32):
        return self._take(kind, shape, dtype)


def _forward(model, f):
    """``mmdit_forward`` on tests/test_torch_port_parallel.py's packed inputs."""
    t = torch.from_numpy
    return mmdit_forward(
        model, [t(c) for c in f["clips"]], t(f["text"]), t(f["mask"]), t(f["pooled"]),
        t(f["timestep"]), history=t(f["history"]), history_mask=t(f["history_mask"]),
        frame_times=[t(x) for x in f["frame_times"]],
        frame_valid=[t(x) for x in f["frame_valid"]], split_last_attn=True)


def _grads(model):
    """Every leaf's gradient (zeros where none arrived), as numpy."""
    return {n: (torch.zeros_like(p) if p.grad is None else p.grad).numpy().copy()
            for n, p in model.named_parameters()}


def _params(model):
    return {n: p.detach().numpy().copy() for n, p in model.named_parameters()}


def _trainer_state(trainer):
    """A trainer's parameters, AdamW moments, count and step, as numpy."""
    opt = [trainer.optimizer.state[p] for p in trainer.model.parameters()]
    names = [name for name, _ in trainer.model.named_parameters()]
    return {"params": _params(trainer.model),
            "mu": {k: s["exp_avg"].numpy().copy() for k, s in zip(names, opt)},
            "nu": {k: s["exp_avg_sq"].numpy().copy() for k, s in zip(names, opt)},
            "count": [float(s["step"]) for s in opt], "step": trainer.step}


def _checkpoint_part(pyr, pyr_tree, mesh, batch, lr, wd, ckpt_dir):
    """Fault F10: a TP-only ``Trainer`` step with ``ckpt_every=1`` into the
    ``ckpt_dir`` every rank shares; its checkpoint restored into a fresh tp-2
    trainer and into a tp-4 one over all four ranks (PYR's 4 heads, one a
    rank). Both fresh trainers start from the initial weights."""
    tp = mesh.group("tp")

    def trainer(model, ckpt=None):
        return Trainer(pyr, model, learning_rate=lr, weight_decay=wd, sample_seed=3,
                       device="cpu", ckpt_dir=ckpt)

    stepped = trainer(params_from_numpy(MMDiT(pyr, tp_group=tp),
                                        shard_mmdit_params(pyr_tree, mesh)), ckpt_dir)
    loss = float(stepped.train([batch], TorchNoise(11, "cpu"), ckpt_every=1, log_every=0)[0])
    path = os.path.join(ckpt_dir, f"step_{stepped.step:08d}")
    out = {"loss": loss, "path": path, "live": _trainer_state(stepped)}
    fresh = trainer(params_from_numpy(MMDiT(pyr, tp_group=tp),
                                      shard_mmdit_params(pyr_tree, mesh)))
    fresh.restore(path)
    out["tp2"] = _trainer_state(fresh)
    world = torch.distributed.group.WORLD
    line = Mesh(("tp",), (4,), mesh.rank, torch.device("cpu"), {"tp": world})
    tp4 = trainer(params_from_numpy(MMDiT(pyr, tp_group=world), shard_mmdit_params(pyr_tree, line)))
    tp4.restore(path)
    out["tp4"] = _trainer_state(tp4)
    return out


def training_rank(pyr_kwargs: dict, pyr_tree, forward: dict, dp_kwargs: dict, dp_tree,
                  dp_batch: dict, dp_draws: dict, lr: float, wd: float, ckpt_dir: str):
    """On a (dp 2, tp 2) mesh of 4 ranks, in float64: (a) the gradient of
    sum(v**2) through the TP MMDiT on its tp group, and the forward's
    reductions with and without autograd; (b) the DP x TP pyramid step
    (stage 1, unit 3) on this rank's dp slice of the batch and of the given
    draws; (c) a TP-only ``Trainer`` step on the whole batch (each dp line
    alone); (d) ``_checkpoint_part`` into ``ckpt_dir``, its error (type,
    message) kept instead of raised. Returns numpy."""
    import deepv_tpu_torch.parallel.dryrun  # noqa: F401  (what a dryrun rank imports)

    torch.set_num_threads(1)
    mesh = cpu_mesh((2, 2), ("dp", "tp"))
    tp = mesh.group("tp")
    out = {"rank": mesh.rank, "dp": mesh.index("dp"), "tp": mesh.index("tp")}

    pyr = MMDiTConfig(**pyr_kwargs)
    model = params_from_numpy(MMDiT(pyr, tp_group=tp),
                              shard_mmdit_params(pyr_tree, mesh)).requires_grad_(True)
    comm.reset_counts()
    v = _forward(model, forward)
    fwd = dict(comm.counts), dict(comm.nbytes)
    (v ** 2).sum().backward()
    out["f9_grads"] = _grads(model)
    out["f9_counts"] = (fwd, (dict(comm.counts), dict(comm.nbytes)))
    with torch.inference_mode():
        comm.reset_counts()
        again = _forward(model, forward)
        out["f9_inference"] = (dict(comm.counts), dict(comm.nbytes))
    out["f9_forward_equal"] = bool(torch.equal(again, v.detach()))

    model = params_from_numpy(MMDiT(MMDiTConfig(**dp_kwargs), tp_group=tp),
                              shard_mmdit_params(dp_tree, mesh)).requires_grad_(True)
    optimizer = torch.optim.AdamW(model.parameters(), lr=lr, betas=(0.9, 0.999), eps=1e-8,
                                  weight_decay=wd)
    pcfg = PipelineConfig()
    step = make_pyramid_train_step(model, pcfg, FlowMatchSchedule(pcfg.scheduler), optimizer,
                                   mesh=mesh)
    i, n = mesh.index("dp"), mesh.shape["dp"]
    b = dp_batch["latents"].shape[0] // n
    batch = {k: torch.from_numpy(v[i * b:(i + 1) * b]) for k, v in dp_batch.items()}
    draws = FedDraws(dp_draws)
    out["dp_loss"] = float(step(batch, BatchSliceNoise(draws, i, n), 1, 3))
    out["dp_draws_left"] = sum(map(len, draws.queues.values()))
    out["dp_grads"], out["dp_params"] = _grads(model), _params(model)
    state = [optimizer.state[p] for p in model.parameters()]
    names = [name for name, _ in model.named_parameters()]
    out["dp_mu"] = {k: s["exp_avg"].numpy().copy() for k, s in zip(names, state)}
    out["dp_nu"] = {k: s["exp_avg_sq"].numpy().copy() for k, s in zip(names, state)}

    model = params_from_numpy(MMDiT(pyr, tp_group=tp), shard_mmdit_params(pyr_tree, mesh))
    trainer = Trainer(pyr, model, learning_rate=lr, weight_decay=wd, sample_seed=3,
                      device="cpu")
    batch = {k: torch.from_numpy(v) for k, v in forward["trainer_batch"].items()}
    out["trainer_loss"] = float(trainer.train([batch], TorchNoise(11, "cpu"), log_every=0)[0])
    out["trainer_params"] = _params(trainer.model)
    try:
        out["ckpt"] = _checkpoint_part(pyr, pyr_tree, mesh, batch, lr, wd, ckpt_dir)
    except Exception as e:   # the tests report it
        out["ckpt"] = {"error": (type(e).__name__, str(e))}
    out["forbidden_modules"] = forbidden_modules()
    return out


def _linear(w: torch.Tensor, b: torch.Tensor) -> torch.nn.Linear:
    lin = torch.nn.Linear(w.shape[1], w.shape[0], dtype=w.dtype)
    with torch.no_grad():
        lin.weight.copy_(w)
        lin.bias.copy_(b)
    return lin


def int8_rank(mcfg_kwargs: dict, tree, forward: dict, params, embeds, batch, draws):
    """On 2 ranks: (a) the W8A8 linear column- and row-split against the
    whole one, f32 and f64; (b) the TP int8 MMDiT forward against the
    single-device int8 forward; (c) a one-chunk float64 ``--fast`` rollout
    on the mesh (skip_odd, the W8A8 linears, ``conv_impl="int8"`` with
    ``MIN_H`` at 64 so that a single-device run would take the int8 conv at
    this size) with the recorded draws, counting ``int_mm`` calls, the
    dispatches to the int8 conv and the dtypes of the reductions."""
    torch.set_num_threads(1)
    mesh = cpu_mesh((2,), ("tp",))
    g, r = mesh.group("tp"), mesh.index("tp")
    out = {"rank": mesh.rank, "linear": {}}
    rng = np.random.default_rng(3)
    for dtype in (torch.float32, torch.float64):
        x = torch.from_numpy(rng.standard_normal((2, 33, 24))).to(dtype)
        x[0, 5] = 0.0                                  # a token whose scale clamps
        w = torch.from_numpy(rng.standard_normal((40, 24))).to(dtype)
        b = torch.from_numpy(rng.standard_normal(40)).to(dtype)
        whole = linear_int8.linear_int8(x, Int8Linear(_linear(w, b)))
        col = linear_int8.linear_int8(x, Int8Linear(_linear(w[r * 20:(r + 1) * 20],
                                                            b[r * 20:(r + 1) * 20])))
        row = linear_int8.linear_int8(x[..., r * 12:(r + 1) * 12],
                                      Int8Linear(_linear(w[:, r * 12:(r + 1) * 12], b), g), g)
        out["linear"][str(dtype)] = dict(
            column=bool(torch.equal(col, whole[..., r * 20:(r + 1) * 20])),
            row=bool(torch.equal(row, whole)), dtype=str(row.dtype))

    cfg = MMDiTConfig(**mcfg_kwargs)
    for dtype in (torch.float32, torch.float64):
        f = dict(forward, clips=[c.astype(cast_np(dtype)) for c in forward["clips"]],
                 text=forward["text"].astype(cast_np(dtype)),
                 pooled=forward["pooled"].astype(cast_np(dtype)),
                 history=forward["history"].astype(cast_np(dtype)))
        tp_tree = jax_free_map(tree, cast_np(dtype))
        model = quantize_mmdit(params_from_numpy(MMDiT(cfg, tp_group=g),
                                                 shard_mmdit_params(tp_tree, mesh)))
        single = quantize_mmdit(params_from_numpy(MMDiT(cfg), tp_tree))
        with torch.inference_mode():
            linear_int8.calls = 0
            v_mesh = _forward(model, f)
            mesh_calls = linear_int8.calls
            linear_int8.calls = 0
            v_single = _forward(single, f)
        out[f"forward {dtype}"] = dict(equal=bool(torch.equal(v_mesh, v_single)),
                                       max_abs=float((v_mesh - v_single).abs().max()),
                                       int_mm=(mesh_calls, linear_int8.calls))

    routed, reduced = [0], []
    orig_conv, orig_reduce, orig_min_h = causal_conv.conv3d_int8, comm.all_reduce, conv_int8.MIN_H

    def conv_spy(*a, **k):
        routed[0] += 1
        return orig_conv(*a, **k)

    def reduce_spy(x, group, op="sum"):
        reduced.append((str(x.dtype), op))
        return orig_reduce(x, group, op)

    vcfg = VAEConfig(**{**VAEConfig.tiny().__dict__, "conv_impl": "int8"})
    pipe = InferencePipeline(PipelineConfig(), cfg, vcfg, params, embeds, dtype=torch.float64,
                             device="cpu", mesh=mesh, flow_cache="skip_odd", denoise_int8=True)
    noise = ReplayNoise(draws)
    causal_conv.conv3d_int8, comm.all_reduce, conv_int8.MIN_H = conv_spy, reduce_spy, 64
    linear_int8.calls = 0
    try:
        out["fast"] = pipe.generate(batch, seed=9, noise=noise)
    finally:
        causal_conv.conv3d_int8, comm.all_reduce, conv_int8.MIN_H = (orig_conv, orig_reduce,
                                                                      orig_min_h)
    out["fast_int_mm"] = linear_int8.calls
    out["fast_recompute"] = list(pipe.recompute_log)
    out["fast_conv_int8"] = routed[0]
    out["fast_reductions"] = sorted(set(reduced))
    out["fast_draws_left"] = {k: len(q) for k, q in noise.queues.items()}
    out["forbidden_modules"] = forbidden_modules()
    return out


def cast_np(dtype):
    return np.float64 if dtype == torch.float64 else np.float32


def jax_free_map(tree, np_dtype):
    """``tree`` with every leaf cast to ``np_dtype``."""
    if isinstance(tree, dict):
        return {k: jax_free_map(v, np_dtype) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [jax_free_map(v, np_dtype) for v in tree]
    return np.asarray(tree).astype(np_dtype)


def _http(port: int, method: str, path: str, obj=None):
    """(status, json body) of one request to the server on 127.0.0.1."""
    import http.client
    import json
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
    body = None if obj is None else json.dumps(obj)
    conn.request(method, path, body=body, headers={"Content-Type": "application/json"})
    resp = conn.getresponse()
    out = resp.status, json.loads(resp.read() or b"{}")
    conn.close()
    return out


def serve_rank(mcfg_kwargs: dict, params, embeds, img, draws, actions, batch32, seed32):
    """On 2 ranks: (a) a float64 ``InteractiveSession`` on the mesh through
    ``actions`` with the recorded draws; (b) in float32, the mesh
    ``generate()`` of ``batch32``, then ``SessionServer`` on rank 0 with
    ``follow`` on rank 1: a prewarm at 64x64, a session of those units at
    ``seed32``, /metrics, /close, a session whose step fails and one that
    then runs, a session evicted by the TTL, and ``stop()``. Returns numpy;
    rank 1 returns what ``follow`` ran."""
    from deepv_tpu_torch.serve import InteractiveSession, SessionServer, _b64_np, _np_b64, follow

    torch.set_num_threads(1)
    mesh = cpu_mesh((2,), ("tp",))
    mcfg, vcfg = MMDiTConfig(**mcfg_kwargs), VAEConfig.tiny()
    out = {"rank": mesh.rank}
    pipe = InferencePipeline(PipelineConfig(), mcfg, vcfg, params, embeds, dtype=torch.float64,
                             device="cpu", mesh=mesh)
    sess = InteractiveSession(pipe)
    sess.start(img, seed=9, noise=ReplayNoise(draws))
    out["session"] = [{k: (v.numpy() if isinstance(v, torch.Tensor) else v)
                       for k, v in sess.step(a).items()} for a in actions]
    out["session_draws_left"] = {k: len(q) for k, q in sess.noise.queues.items()}
    del sess, pipe

    params32 = jax_free_map(params, np.float32)
    pipe = InferencePipeline(PipelineConfig(), mcfg, vcfg, params32, embeds,
                             dtype=torch.float32, device="cpu", mesh=mesh)
    gen = pipe.generate(batch32, seed=seed32)
    out["generate"] = gen["pred_img"].numpy()
    if mesh.rank != 0:
        out["followed"] = follow(pipe)
        out["forbidden_modules"] = forbidden_modules()
        return out

    server = SessionServer(pipe, port=0)
    server.prewarm(height=64, width=64, log=lambda *a: None)
    port = server.start()
    try:
        calls = out["calls"] = []

        def call(method, path, obj=None):
            status, body = _http(port, method, path, obj)
            calls.append((path, status))
            return status, body

        image = _np_b64(batch32["img"])
        _, body = call("POST", "/session", {"image": image, "seed": seed32})
        sid = body["session_id"]
        served = []
        for a in actions:
            status, body = call("POST", "/step", {"session_id": sid, "action": a})
            assert status == 200, body
            served.append(_b64_np(body["rgb"]))
        out["served"] = np.concatenate(served, axis=2)
        out["metrics"] = call("GET", "/metrics")[1]
        call("POST", "/close", {"session_id": sid})
        _, body = call("POST", "/session", {"image": image, "seed": 1})
        sid = body["session_id"]
        out["failed_step"] = call("POST", "/step", {"session_id": sid, "action": "no such action"})
        out["next_step"] = call("POST", "/step", {"session_id": sid, "action": actions[0]})[0]
        call("POST", "/close", {"session_id": sid})
        _, body = call("POST", "/session", {"image": image, "seed": 2})
        server.session_ttl_s = 0.0
        out["evicted_metrics"] = call("GET", "/metrics")[1]
        out["evicted_sid"] = body["session_id"]
    finally:
        server.stop()
    out["forbidden_modules"] = forbidden_modules()
    return out
