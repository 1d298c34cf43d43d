"""CLI entry point of the port, with deepv_tpu's run.py flags.

    python -m deepv_tpu_torch.run --input_image img.png --model_path ./ckpts \\
        --random_weights --prompt_type action --prompt '(FN)(FN)(SR)'

Runs on the CUDA card. Only random weights are ported (``--random_weights``;
``DEEPV_TINY=1`` selects the small smoke-run architecture); flags of paths
not ported yet raise NotImplementedError naming their ROADMAP item.
``--fast`` is the quality-gated fast preset (flow caching "skip_odd", the
W8A8 denoise linears and the int8 VAE conv); ``--flow_cache`` overrides its
flow-cache choice and ``--carry_latents`` adds the boundary carry mode.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import time
from typing import Optional

import numpy as np
import torch

from .actions import action_vocabulary, prepare_motion_prompts
from .config import MMDiTConfig, PipelineConfig, VAEConfig, create_model_config
from .io.text_embeds import random_text_embeds
from .pipeline import InferencePipeline

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
    """Random-weight pipeline on ``device`` (default "cuda"; raises when no
    GPU is present, pass "cpu" explicitly to run on the CPU). ``fast``:
    flow_cache="skip_odd", denoise_int8 and ``VAEConfig(conv_impl="int8")``;
    ``flow_cache`` (when given) overrides the preset's choice."""
    if tp_shards != 1:
        raise NotImplementedError("tp_shards: not ported yet (ROADMAP M17 parallelism)")
    if not random_weights:
        raise NotImplementedError("checkpoint loading: not ported yet (ROADMAP M15 text "
                                  "encoders + checkpoint loader); pass random_weights=True")
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' to run on the CPU")
    from .io.weights import random_params

    if os.environ.get("DEEPV_TINY") == "1":
        mcfg, vcfg = tiny_configs()
    else:
        mcfg, vcfg = MMDiTConfig(), VAEConfig()
    params = random_params(mcfg, vcfg, dtype=dtype, seed=seed, device=device)
    embeds = random_text_embeds(0, action_vocabulary(), joint_dim=mcfg.joint_attention_dim,
                                pooled_dim=mcfg.pooled_projection_dim)
    if flow_cache is None:
        flow_cache = "skip_odd" if fast else "none"
    if fast:
        vcfg = dataclasses.replace(vcfg, conv_impl="int8")
    return InferencePipeline(model_cfg, mcfg, vcfg, params, embeds, dtype=dtype,
                             device=device, flow_cache=flow_cache, denoise_int8=fast,
                             carry_latents=carry_latents)


def main(input_image: str, model_path: str, prompt_type: str = "text",
         prompt: str = "", seed: int = 666, no_need_depth: bool = False,
         add_controler: bool = False, add_depth: bool = False,
         add_ply: bool = False, random_weights: bool = False,
         output_path: str = "output/generated_video.mp4",
         height: int = VIDEO_HEIGHT, width: int = VIDEO_WIDTH,
         tp_shards: int = 1, icon_assets: Optional[str] = None, fast: bool = False,
         flow_cache: Optional[str] = None, carry_latents: bool = False,
         aot_cache: Optional[str] = None, device: Optional[str] = None):
    if add_ply:
        raise NotImplementedError("add_ply: PLY export is not ported yet (ROADMAP M19 utilities)")
    if aot_cache:
        raise NotImplementedError("aot_cache: not ported yet (ROADMAP M19 utilities)")
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
    print(f"[info] save result at {written}")
    return written


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
                   help="not ported yet (raises)")
    p.add_argument("--random_weights", action="store_true",
                   help="random-initialise the full model with a seeded torch "
                        "generator (the only weights ported so far)")
    p.add_argument("--output_path", default="output/generated_video.mp4")
    p.add_argument("--height", type=int, default=VIDEO_HEIGHT)
    p.add_argument("--width", type=int, default=VIDEO_WIDTH)
    p.add_argument("--tp_shards", type=int, default=1, help="only 1 is ported")
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
    p.add_argument("--aot_cache", default=None, metavar="DIR", help="not ported yet (raises)")
    p.add_argument("--device", default=None, help="torch device (default: cuda)")
    args = p.parse_args()
    main(**vars(args))


if __name__ == "__main__":
    cli()
