"""The system under test, built from a configuration file: the port's
``InferencePipeline`` with the configuration's widths, options and the
run's weights and action embeddings. The only module of the benchmark,
with the drivers and the recorder, that imports the program."""

from __future__ import annotations

import dataclasses
import gc
import os
import time
from typing import Dict

import torch

from .inputs import action_embeds, sub_seed
from .reference.params import make_params, split_tree

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def cache_dirs(root: str) -> Dict[str, str]:
    """The build and kernel caches of the program, fixed directories inside
    the checkout (``portbench/.cache``), so that only a checkout's first
    run compiles."""
    base = os.path.join(root, "portbench", ".cache")
    return {"aot": os.path.join(base, "aot"),
            "TORCH_EXTENSIONS_DIR": os.path.join(base, "torch_extensions"),
            "TRITON_CACHE_DIR": os.path.join(base, "triton")}


def configure_caches(root: str) -> None:
    """Point every cache of the program into the checkout; before the
    program loads a kernel."""
    dirs = cache_dirs(root)
    for key in ("TORCH_EXTENSIONS_DIR", "TRITON_CACHE_DIR"):
        os.environ[key] = dirs[key]
    # libraries that would load JAX by themselves must not
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    from deepv_tpu_torch.utils import aot
    aot.configure(dirs["aot"])


def weights_seed(seed: int) -> int:
    return sub_seed(seed, "weights")


def build(config: Dict, seed: int, device):
    """(pipeline, action embeddings) for ``config`` with the run's weights
    and embeddings. The caller's copy of the weights is dropped once the
    pipeline holds them, as a deployment's loader drops its own."""
    from deepv_tpu_torch.config import MMDiTConfig, PipelineConfig, SchedulerConfig, VAEConfig
    from deepv_tpu_torch.pipeline import InferencePipeline

    serving = config["serving"]
    dtype = DTYPES[serving["dtype"]]
    mcfg = MMDiTConfig(**config["transformer"])
    vcfg = VAEConfig(**{k: tuple(v) if isinstance(v, list) else v
                        for k, v in config["vae"].items()})
    pfields = dict(config["pipeline"])
    sched = SchedulerConfig(**{k: tuple(v) if isinstance(v, list) else v
                               for k, v in pfields.pop("scheduler").items()})
    pfields = {k: tuple(v) if isinstance(v, list) else v for k, v in pfields.items()
               if k in {f.name for f in dataclasses.fields(PipelineConfig)}}
    pcfg = PipelineConfig(**pfields, scheduler=sched)
    embeds = action_embeds(seed, serving["text_len"], mcfg.joint_attention_dim,
                           mcfg.pooled_projection_dim)
    params = make_params(config, weights_seed(seed), dtype, device)
    tree = {"mmdit": split_tree(params, "mmdit"), "vae": split_tree(params, "vae")}
    del params
    pipe = InferencePipeline(pcfg, mcfg, vcfg, tree, embeds, dtype=dtype, device=device,
                             flow_cache=serving["flow_cache"],
                             denoise_int8=serving["denoise_int8"],
                             encode_window=serving["encode_window"],
                             decode_window=serving["decode_window"])
    del tree
    return pipe, embeds


#: the garbage collector inside the window: [collections, seconds, start of
#: the one in progress]
_GC = [0, 0.0, 0.0]


def _gc_clock(phase: str, info: dict) -> None:
    if phase == "start":
        _GC[2] = time.perf_counter()
    else:
        _GC[0] += 1
        _GC[1] += time.perf_counter() - _GC[2]


def settle() -> None:
    """Before the window: collect set-up's garbage and move what set-up
    left alive (the weights' Python objects, the program's modules) out of
    the collector's reach, so that a full collection inside the window
    walks only the window's own objects; then time the collector."""
    gc.collect()
    gc.freeze()
    _GC[:2] = [0, 0.0]
    gc.callbacks.append(_gc_clock)


def unsettle() -> tuple:
    """After the window: stop timing the collector and hand set-up's
    objects back to it. Returns the window's (collections, seconds)."""
    gc.callbacks.remove(_gc_clock)
    gc.unfreeze()
    return _GC[0], _GC[1]


def synchronize(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)

