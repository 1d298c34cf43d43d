"""Multi-card dry run: one DP x TP training step, the context-parallel VAE
and a mesh inference chunk, on ``n`` ranks at tiny shapes.

Counterpart of ``deepv_tpu/parallel/dryrun.py``, with its four parts in its
order and at its tiny shapes, but for the attention head dim: 64, the one
the port's attention kernel is built for (deepv_tpu's tiny configs use 8),
so that the same run goes through the kernel on a card:

  1. a (dp, tp) mesh, dp = 2 when n is even and tp = n // dp, and one
     pyramid training step at ``stage=1, unit_index=3`` on it: the MMDiT
     tensor-parallel over ``tp`` (``parallel/tp.shard_mmdit_params``), the
     batch split over ``dp``, the gradients averaged over ``dp``
     (``training/flow_matching``);
  2. a spatially context-parallel VAE encode over all n ranks
     (``parallel/cp.cp_vae_encode``);
  3. a temporally context-parallel decode (``tcp_vae_decode``);
  4. one chunk of ``InferencePipeline(mesh=...)``: the TP denoise and the
     CP encodes and decodes.

deepv_tpu runs them as one program over n devices; here ``run_dryrun``
spawns n ranks (``parallel/launch.spawn``), one process each. By default
they run over NCCL, one rank per card, and a machine with fewer cards than
n raises, naming its count: the mesh is never made smaller.
``device="cpu"`` runs gloo ranks on the CPU; ``shared_card=True`` runs gloo
ranks that share ``cuda:0``, the only way one card holds a mesh.

    python -m deepv_tpu_torch.parallel.dryrun 4 [--device cpu] [--shared_card]
"""

from __future__ import annotations

import argparse
import math
from typing import Optional

import torch

from ..ops.attention import HEAD_DIM


def _mesh_devices(n: int, device: str, shared_card: bool):
    """(devices, backend) of an n-rank mesh for ``make_mesh``."""
    if device == "cpu":
        return ["cpu"] * n, "gloo"
    if shared_card:
        return ["cuda:0"] * n, "gloo"
    return None, "nccl"


def run_dryrun(n_devices: int, verbose: bool = True, device: Optional[str] = None,
               shared_card: bool = False) -> float:
    """The four parts (module docstring) on ``n_devices`` ranks. Returns the
    training step's loss, the mean over the global batch, after checking it
    and every other output finite."""
    n = int(n_devices)
    device = "cuda" if device is None else str(torch.device(device).type)
    if device == "cuda" and not shared_card:
        cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if cards < n:
            raise RuntimeError(f"dryrun needs {n} CUDA cards, one rank each over NCCL; this "
                               f"machine has {cards} (device='cpu' runs gloo ranks on the CPU)")
    elif device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("dryrun with shared_card=True needs a CUDA card; this machine has 0")
    from .launch import spawn
    _, backend = _mesh_devices(n, device, shared_card)
    return spawn(dryrun_rank, n, (n, verbose, device, shared_card), backend=backend)[0]


def dryrun_rank(n: int, verbose: bool, device: str, shared_card: bool) -> float:
    """One rank of ``run_dryrun``, inside an initialised process group of
    ``n`` ranks (``run_dryrun`` spawns one)."""
    from ..config import MMDiTConfig, PipelineConfig, VAEConfig
    from ..io.weights import params_from_numpy, random_mmdit_params, random_params
    from ..models.mmdit import MMDiT
    from ..models.scheduler import FlowMatchSchedule
    from ..models.vae import VAE
    from ..pipeline import TorchNoise
    from ..training.flow_matching import BatchSliceNoise, make_pyramid_train_step
    from .cp import cp_vae_encode, tcp_vae_decode
    from .mesh import make_mesh
    from .tp import shard_mmdit_params

    devices, backend = _mesh_devices(n, device, shared_card)
    dp = 2 if n % 2 == 0 and n >= 2 else 1
    tp = n // dp
    mesh = make_mesh((dp, tp), ("dp", "tp"), devices=devices, backend=backend)
    dev = mesh.device
    f32 = torch.float32

    # tiny config whose dims divide tp (heads and ff widths shard cleanly);
    # the caption dim equals inner_dim for the context stream
    cfg = MMDiTConfig(sample_size=16, patch_size=2, in_channels=8, num_layers=2,
                      attention_head_dim=HEAD_DIM, num_attention_heads=2 * tp,
                      caption_projection_dim=16 * tp, pooled_projection_dim=16,
                      pos_embed_max_size=32, joint_attention_dim=32)
    cfg = MMDiTConfig(**{**cfg.__dict__, "caption_projection_dim": cfg.inner_dim})
    tree = random_mmdit_params(cfg, f32, seed=0, device=dev)
    model = params_from_numpy(MMDiT(cfg, tp_group=mesh.group("tp")),
                              shard_mmdit_params(tree, mesh, "tp"), dev).requires_grad_(True)
    del tree

    # the pyramid objective's packed multi-clip layout under DP x TP: the
    # global batch of 2 * dp rows, this rank's dp slice of it and of the draws
    b = 2 * dp
    g = torch.Generator(device=dev)
    g.manual_seed(1)
    draw = lambda *shape: torch.randn(shape, generator=g, device=dev)
    batch = {"latents": draw(b, cfg.in_channels, 8, 8, 8),
             "text_embeds": draw(b, 7, cfg.joint_attention_dim),
             "text_mask": torch.ones((b, 7), dtype=torch.int32, device=dev),
             "pooled": draw(b, cfg.pooled_projection_dim)}
    i = mesh.index("dp")
    batch = {k: v[i * 2:(i + 1) * 2] for k, v in batch.items()}
    pcfg = PipelineConfig()
    # optax.adamw(1e-4)'s defaults
    optimizer = torch.optim.AdamW(model.parameters(), lr=1e-4, betas=(0.9, 0.999), eps=1e-8,
                                  weight_decay=1e-4)
    step = make_pyramid_train_step(model, pcfg, FlowMatchSchedule(pcfg.scheduler), optimizer,
                                   mesh=mesh)
    loss = float(step(batch, BatchSliceNoise(TorchNoise(4, dev), i, dp), stage=1, unit_index=3))
    if not math.isfinite(loss):
        raise AssertionError(f"dryrun loss not finite: {loss}")
    del model, optimizer, step, batch

    # context-parallel VAE over all n ranks: spatial CP encode, temporal CP decode
    vcfg = VAEConfig.tiny()
    vae = params_from_numpy(VAE(vcfg), random_params(MMDiTConfig.tiny(), vcfg, dtype=f32,
                                                     seed=5, device=dev)["vae"], dev)
    cp_mesh = make_mesh((n,), ("cp",), devices=devices, backend=backend)
    with torch.inference_mode():
        x = torch.randn((1, 3, 9, n * vcfg.downsample_scale, 32), generator=g, device=dev)
        moments = cp_vae_encode(vcfg, vae, x, cp_mesh)
        tcp_mesh = make_mesh((n,), ("tp",), devices=devices, backend=backend)
        z = torch.randn((1, vcfg.encoder_out_channels, 1 + 2 * n, 8, 4), generator=g, device=dev)
        pixels = tcp_vae_decode(vcfg, vae, z, tcp_mesh)
    if not (bool(torch.isfinite(moments).all()) and bool(torch.isfinite(pixels).all())):
        raise AssertionError("dryrun: the context-parallel VAE gave non-finite values")

    frames = _run_mesh_inference(tcp_mesh, n)
    if verbose and mesh.rank == 0:
        print(f"[dryrun] mesh ({dp}, {tp}) axes ('dp', 'tp') loss={loss:.4f}; "
              f"cp mesh ({n},) vae encode ok; temporal-cp decode of {z.shape[2]} latent frames "
              f"ok; mesh inference rollout ({n}-way TP denoise + CP VAE) generated {frames} "
              "frames ok", flush=True)
    return loss


def _run_mesh_inference(mesh, n: int) -> int:
    """One tiny-config chunk through ``InferencePipeline(mesh=...)``."""
    import numpy as np

    from ..config import MMDiTConfig, PipelineConfig, VAEConfig
    from ..io.text_embeds import random_text_embeds
    from ..io.weights import random_params
    from ..pipeline import InferencePipeline

    # latent H must divide both the pyramid's 4x downsample * patch 2 and the
    # n CP shards; pixel H = 8 * latent H then satisfies the encoder's
    # n * downsample_scale divisibility
    lat_h = 8 * n // math.gcd(8, n)
    size = 8 * lat_h
    vcfg = VAEConfig.tiny()
    mcfg = MMDiTConfig(sample_size=16, patch_size=2, in_channels=14, num_layers=2,
                       attention_head_dim=HEAD_DIM, num_attention_heads=4,
                       caption_projection_dim=4 * HEAD_DIM, pooled_projection_dim=16,
                       pos_embed_max_size=32, joint_attention_dim=24)
    # a short chunk (4 latent units)
    pcfg = PipelineConfig(max_temporal_length=4, num_input_unit=2, num_input_image=9)
    params = random_params(mcfg, vcfg, dtype=torch.float32, seed=8, device=mesh.device)
    move = "Move forward. The perspective hasn't changed."
    embeds = random_text_embeds(0, ["empty", move], joint_dim=mcfg.joint_attention_dim,
                                pooled_dim=mcfg.pooled_projection_dim)
    pipe = InferencePipeline(pcfg, mcfg, vcfg, params, embeds, dtype=torch.float32,
                             device=mesh.device, mesh=mesh)
    img = np.random.default_rng(10).uniform(-1.0, 1.0, (1, 3, size, size)).astype(np.float32)
    with torch.inference_mode():
        out = pipe.generate({"img": img, "prompt": np.array(["empty"] + [move] * 3),
                             "prompt_type": "action"}, seed=0)
    if not bool(torch.isfinite(out["pred_img"]).all()):
        raise AssertionError("dryrun: the mesh rollout gave non-finite frames")
    return int(out["pred_img"].shape[2])


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("n_devices", type=int)
    p.add_argument("--device", default=None, help="torch device type (default: cuda)")
    p.add_argument("--shared_card", action="store_true",
                   help="gloo ranks sharing cuda:0 instead of one NCCL rank per card")
    args = p.parse_args()
    print(run_dryrun(args.n_devices, device=args.device, shared_card=args.shared_card))


if __name__ == "__main__":
    main()
