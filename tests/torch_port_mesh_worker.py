"""Rank functions of the port's multi-process CPU tests (gloo, one process
per rank, started by ``deepv_tpu_torch.parallel.launch.spawn``).

This module imports torch and the port only, so a spawned rank imports
neither JAX nor deepv_tpu; each rank returns the modules of those it holds
(``forbidden_modules``), which the tests check is none. The tests compute
their references in the parent process.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from deepv_tpu_torch.config import MMDiTConfig, PipelineConfig, VAEConfig
from deepv_tpu_torch.io.weights import params_from_numpy
from deepv_tpu_torch.models.mmdit import MMDiT, mmdit_forward
from deepv_tpu_torch.models.vae import VAE
from deepv_tpu_torch.parallel import comm, cp
from deepv_tpu_torch.parallel.mesh import make_mesh
from deepv_tpu_torch.parallel.tp import shard_mmdit_params
from deepv_tpu_torch.pipeline import InferencePipeline, TorchNoise


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
    mesh. Returns both outputs and the adaptive run's recompute decisions."""
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
    out["forbidden_modules"] = forbidden_modules()
    return out
