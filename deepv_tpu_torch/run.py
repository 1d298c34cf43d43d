"""CLI entry point of the port, with deepv_tpu's run.py flags.

    python -m deepv_tpu_torch.run --input_image img.png --model_path ./ckpts \\
        --prompt_type text --prompt 'A red car drives down the road.'

Runs on the CUDA card. ``--model_path`` names a DeepVerse snapshot
(``transformer/``, ``causal_video_vae/`` and, for text prompts,
``text_encoder{,_2,_3}/`` with ``tokenizer{,_2,_3}/``); a text prompt needs
the ``transformers`` package to tokenise. ``--random_weights``, or a path
that is not a directory, builds seeded random weights instead
(``DEEPV_TINY=1`` selects the small smoke-run architecture).
``--fast`` is the quality-gated fast preset (flow caching "skip_odd", the
W8A8 denoise linears and the int8 VAE conv); ``--flow_cache`` overrides its
flow-cache choice and ``--carry_latents`` adds the boundary carry mode.
``--add_ply`` also writes every 8th frame as a PLY point cloud
(``io/ply.save_ply``, on the pipeline's device).

``--tp_shards N`` runs the rollout on N ranks, one process each
(``parallel/launch.spawn``): over NCCL on ``cuda:0`` .. ``cuda:N-1`` (the
machine needs N cards), or over gloo with ``--device cpu``. The MMDiT is
tensor-parallel and the VAE context-parallel over them
(``InferencePipeline(mesh=...)``); rank 0 writes the outputs. ``--fast``,
``--flow_cache`` and ``--carry_latents`` compose with it: the W8A8 linears
run on each rank's share (the row-split ones summing int32 products over
the ranks), and the VAE's convs under context parallelism run ``F.conv3d``.

``--aot_cache DIR`` keeps the compiled kernel libraries in DIR across
processes (``utils/aot.py``): the first run builds them there with
``nvcc``, later runs load them and need no CUDA toolkit. DIR must be a
directory only trusted users can write (loading a library runs its code);
one owned by another user or writable by group or others is refused.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import time
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from .actions import action_vocabulary, prepare_motion_prompts
from .config import MMDiTConfig, PipelineConfig, VAEConfig, create_model_config
from .io.text_embeds import load_text_embeds, random_text_embeds
from .parallel.launch import spawn
from .parallel.mesh import make_mesh
from .pipeline import InferencePipeline
from .utils import aot

VIDEO_LENGTH = 57
VIDEO_HEIGHT = 384
VIDEO_WIDTH = 512


def prepare_input_image(image_path: str, height: int, width: int) -> np.ndarray:
    """Center-crop to the target aspect ratio then resize. Returns
    [1, 3, H, W] float32 in [-1, 1]."""
    from PIL import Image
    first = Image.open(image_path).convert("RGB")
    ow, oh = first.size
    target_ratio = width / height
    if ow / oh > target_ratio:
        nw = int(oh * target_ratio)
        left, top, right, bottom = (ow - nw) // 2, 0, (ow - nw) // 2 + nw, oh
    else:
        nh = int(ow / target_ratio)
        left, top, right, bottom = 0, (oh - nh) // 2, ow, (oh - nh) // 2 + nh
    first = first.crop((left, top, right, bottom)).resize((width, height))
    arr = np.asarray(first, np.float32) / 255.0
    arr = (arr - 0.5) / 0.5
    return arr.transpose(2, 0, 1)[None]


def tiny_configs():
    """The ``DEEPV_TINY=1`` smoke-run architecture (deepv_tpu's)."""
    mcfg = MMDiTConfig(num_layers=2, num_attention_heads=4, attention_head_dim=64,
                       caption_projection_dim=256, joint_attention_dim=128,
                       pooled_projection_dim=64)
    vcfg = VAEConfig(encoder_block_out_channels=(32, 32, 64, 64),
                     decoder_block_out_channels=(32, 32, 64, 64),
                     encoder_layers_per_block=(1, 1, 1, 1),
                     decoder_layers_per_block=(1, 1, 1, 1),
                     encoder_norm_num_groups=8, decoder_norm_num_groups=8)
    return MMDiTConfig(**{**mcfg.__dict__, "caption_projection_dim": mcfg.inner_dim}), vcfg


def load_pipeline(model_path: str, model_cfg: PipelineConfig,
                  random_weights: bool = False, dtype=torch.bfloat16,
                  height: int = VIDEO_HEIGHT, width: int = VIDEO_WIDTH,
                  tp_shards: int = 1, fast: bool = False,
                  flow_cache: Optional[str] = None, carry_latents: bool = False,
                  device=None, seed: int = 0) -> InferencePipeline:
    """The pipeline on ``device`` (default "cuda"; raises when no GPU is
    present, pass "cpu" explicitly to run on the CPU). Weights come from the
    snapshot at ``model_path`` (``io/weights.load_checkpoint``), with its text
    encoders where it has them; ``random_weights``, or a ``model_path`` that
    is not a directory, draws seeded random ones instead. The action
    embeddings come from ``model_cfg.text_embeds_path`` where that file
    exists, else from the snapshot's encoders, else random ones. ``fast``:
    flow_cache="skip_odd", denoise_int8 and ``VAEConfig(conv_impl="int8")``;
    ``flow_cache`` (when given) overrides the preset's choice.

    ``tp_shards > 1`` is called by every rank of an initialised
    torch.distributed process group of that size (``main`` spawns them): a
    mesh over NCCL, one rank per card, or on the CPU over gloo. Every rank
    draws the same random weights from ``seed``, or loads the snapshot."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' to run on the CPU")
    mesh = None
    if tp_shards > 1:
        if not (dist.is_available() and dist.is_initialized()):
            raise RuntimeError(f"tp_shards={tp_shards} runs inside a torch.distributed process "
                               f"group of {tp_shards} ranks (run.main spawns them); none is "
                               "initialised")
        cpu = device.type == "cpu"
        mesh = make_mesh((tp_shards,), ("tp",), devices=["cpu"] * tp_shards if cpu else None,
                         backend="gloo" if cpu else "nccl")
        device = mesh.device
    from .io import weights

    text_encoder = embeds = None
    if random_weights or not os.path.isdir(model_path):
        if os.environ.get("DEEPV_TINY") == "1":
            mcfg, vcfg = tiny_configs()
        else:
            mcfg, vcfg = MMDiTConfig(), VAEConfig()
        params = weights.random_params(mcfg, vcfg, dtype=dtype, seed=seed, device=device)
    else:
        mcfg, vcfg, params = weights.load_checkpoint(model_path, dtype=dtype, device=device)
        text_encoder = weights.load_text_encoders(model_path, dtype=dtype, device=device)
        embeds_path = model_cfg.text_embeds_path
        if embeds_path and os.path.exists(embeds_path):
            embeds = load_text_embeds(embeds_path)
        elif text_encoder is not None:
            # the closed action vocabulary, made again from the snapshot's own
            # encoders (the reference's cache asset is missing upstream)
            from .io.build_embeds import build_action_embeds
            embeds = build_action_embeds(text_encoder)
    if embeds is None:
        embeds = random_text_embeds(0, action_vocabulary(), joint_dim=mcfg.joint_attention_dim,
                                    pooled_dim=mcfg.pooled_projection_dim)
    if flow_cache is None:
        flow_cache = "skip_odd" if fast else "none"
    if fast:
        vcfg = dataclasses.replace(vcfg, conv_impl="int8")
    return InferencePipeline(model_cfg, mcfg, vcfg, params, embeds, dtype=dtype,
                             text_encoder=text_encoder, device=device, flow_cache=flow_cache,
                             denoise_int8=fast, carry_latents=carry_latents, mesh=mesh)


def main(input_image: str, model_path: str, prompt_type: str = "text",
         prompt: str = "", seed: int = 666, no_need_depth: bool = False,
         add_controler: bool = False, add_depth: bool = False,
         add_ply: bool = False, random_weights: bool = False,
         output_path: str = "output/generated_video.mp4",
         height: int = VIDEO_HEIGHT, width: int = VIDEO_WIDTH,
         tp_shards: int = 1, icon_assets: Optional[str] = None, fast: bool = False,
         flow_cache: Optional[str] = None, carry_latents: bool = False,
         aot_cache: Optional[str] = None, device: Optional[str] = None):
    """Roll out one image and write the video (and, with ``add_ply``, PLY
    files). ``tp_shards > 1`` outside a process group spawns that many ranks
    (NCCL on ``cuda:0..N-1``, or gloo with ``device="cpu"``), each running
    this function inside the group, with every other option (``fast``,
    ``flow_cache``, ``carry_latents``) as on one device; rank 0 writes the
    outputs. ``aot_cache`` configures the kernel library cache
    (``utils/aot.configure``) before anything is loaded, on every rank.
    Returns the path written (None on the other ranks)."""
    args = dict(locals())
    if aot_cache:
        aot.configure(aot_cache)
    if tp_shards > 1 and not (dist.is_available() and dist.is_initialized()):
        cpu = device is not None and torch.device(device).type == "cpu"
        if not cpu:
            cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
            if cards < tp_shards:
                raise RuntimeError(f"--tp_shards {tp_shards} runs one rank per card over NCCL "
                                   f"and needs {tp_shards} cards; this machine has {cards}")
        return spawn(_rank_main, tp_shards, (args,), backend="gloo" if cpu else "nccl")[0]
    from .io.video import save_video

    model_cfg = create_model_config(model_path, no_need_depth=no_need_depth,
                                    use_motion_prompt=(prompt_type == "action"))
    pipeline = load_pipeline(model_path, model_cfg, random_weights=random_weights,
                             height=height, width=width, tp_shards=tp_shards, fast=fast,
                             flow_cache=flow_cache, carry_latents=carry_latents,
                             device=device)
    batch = {"img": prepare_input_image(input_image, height, width),
             "prompt": np.array(prepare_motion_prompts(prompt_type, prompt)),
             "prompt_type": prompt_type}

    st = time.time()
    output = pipeline.generate(batch, seed=seed)
    if pipeline.mesh is not None and pipeline.mesh.rank != 0:
        return None
    n_frames = output["pred_img"].shape[2]
    elapsed = time.time() - st
    print(f"[info] generated {n_frames} frames in {elapsed:.1f}s "
          f"({n_frames / elapsed:.2f} fps)")
    output = {k: (v.float().cpu().numpy() if isinstance(v, torch.Tensor) else v)
              for k, v in output.items()}
    written = save_video(output, output_path, fps=20,
                         add_controler=(add_controler and prompt_type == "action"),
                         add_depth=(add_depth and not no_need_depth),
                         icon_assets=icon_assets)
    if add_ply and not no_need_depth:
        from .io.ply import save_ply
        save_ply(output, output_path.replace(".mp4", ".ply"), device=pipeline.device)
    print(f"[info] save result at {written}")
    return written


def _rank_main(args: dict):
    """One rank of ``main``'s ``tp_shards`` run, inside the process group."""
    return main(**args)


def cli():
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--input_image", required=True)
    p.add_argument("--model_path", required=True)
    p.add_argument("--prompt_type", default="text", choices=["text", "action"])
    p.add_argument("--prompt", default="")
    p.add_argument("--seed", type=int, default=666)
    p.add_argument("--no_need_depth", action="store_true")
    p.add_argument("--add_controler", action="store_true")
    p.add_argument("--add_depth", action="store_true")
    p.add_argument("--add_ply", action="store_true",
                   help="also write every 8th frame as a PLY point cloud "
                        "(<output_path without .mp4>_frame<i>.ply)")
    p.add_argument("--random_weights", action="store_true",
                   help="random-initialise the full model with a seeded torch "
                        "generator instead of loading the snapshot at --model_path")
    p.add_argument("--output_path", default="output/generated_video.mp4")
    p.add_argument("--height", type=int, default=VIDEO_HEIGHT)
    p.add_argument("--width", type=int, default=VIDEO_WIDTH)
    p.add_argument("--tp_shards", type=int, default=1,
                   help="ranks of a tensor-parallel denoise and context-parallel VAE: one "
                        "per card over NCCL, or gloo ranks with --device cpu")
    p.add_argument("--icon_assets", default=None,
                   help="directory with the controller icon PNGs")
    p.add_argument("--fast", action="store_true",
                   help="quality-gated fast preset: flow caching (skip_odd) + int8 VAE "
                        "conv + int8 MMDiT linears")
    p.add_argument("--carry_latents", action="store_true",
                   help="quality-gated boundary fast mode: carry generated rgb latents "
                        "across chunk boundaries instead of re-encoding the carry pixels")
    p.add_argument("--flow_cache", default=None,
                   help="flow-caching mode: none | skip_odd | adaptive[:tau] (overrides "
                        "the --fast preset's choice)")
    p.add_argument("--aot_cache", default=None, metavar="DIR",
                   help="keep the compiled kernel libraries under DIR across processes "
                        "(utils/aot.py): later runs load them instead of running nvcc; DIR "
                        "must be writable by trusted users only")
    p.add_argument("--device", default=None, help="torch device (default: cuda)")
    args = p.parse_args()
    main(**vars(args))


if __name__ == "__main__":
    cli()
