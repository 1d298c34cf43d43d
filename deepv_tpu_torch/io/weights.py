"""Checkpoints and parameter trees -> the port's modules, and random weights.

deepv_tpu keeps parameters as a nested dict/list tree whose paths are the
diffusers module names (after its ``io/weights.py`` re-keying) and whose
leaves keep torch layouts. The port's ``MMDiT`` and ``VAE`` modules use the
same dotted names, so loading a tree is a flatten plus
``load_state_dict(strict=True)``.

A DeepVerse snapshot is a diffusers-style directory: ``transformer/`` and
``causal_video_vae/`` (``config.json`` and ``*.safetensors``), and for text
prompts ``text_encoder{,_2,_3}/`` and ``tokenizer{,_2,_3}/``.
``load_checkpoint`` and ``load_text_encoders`` read it into deepv_tpu's
trees (``io/safetensors.py`` reads the files), re-keyed by deepv_tpu's rules.
"""

from __future__ import annotations

import json
import math
import os
import re
from typing import Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from ..config import MMDiTConfig, VAEConfig
from ..models.mmdit import sincos_2d
from . import safetensors


def flatten_tree(tree, prefix: str = "") -> Dict[str, object]:
    """Dotted-key view of a nested dict/list tree; ``None`` slots (absent
    list entries of a converted checkpoint) are skipped."""
    out: Dict[str, object] = {}
    if tree is None:
        return out
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = ((str(i), v) for i, v in enumerate(tree))
    else:
        return {prefix[:-1]: tree}
    for k, v in items:
        out.update(flatten_tree(v, f"{prefix}{k}."))
    return out


def params_from_numpy(module: nn.Module, tree, device=None) -> nn.Module:
    """Load a deepv_tpu-style tree (numpy arrays, or tensors) into
    ``module`` with ``strict=True``; the module's parameters become the
    tree's values, in their dtype, on ``device`` (default: where they are).
    Returns the module, frozen for inference."""
    state = {}
    for k, v in flatten_tree(tree).items():
        t = v if isinstance(v, torch.Tensor) else torch.from_numpy(np.array(v))
        state[k] = t.to(device) if device is not None else t
    module.load_state_dict(state, strict=True, assign=True)
    return module.requires_grad_(False)


def set_adamw_state(optimizer: torch.optim.Optimizer, model: nn.Module, count,
                    mu=None, nu=None) -> None:
    """Give ``optimizer`` (a ``torch.optim.AdamW`` over ``model``'s
    parameters) the state of optax's adam: ``count`` (the step count) and
    the first and second moment trees ``mu`` and ``nu``, keyed like the
    parameters (deepv_tpu's ``ScaleByAdamState``; numpy arrays or tensors).
    Each moment takes its parameter's device and dtype. ``mu``/``nu`` None
    give zeros, as ``optax.adam(...).init`` does."""
    named = dict(model.named_parameters())
    moments = []
    for tree in (mu, nu):
        flat = None if tree is None else flatten_tree(tree)
        if flat is not None and set(flat) != set(named):
            raise KeyError(f"moment tree keys differ from the parameters': missing "
                           f"{sorted(set(named) - set(flat))[:3]}, extra "
                           f"{sorted(set(flat) - set(named))[:3]}")
        moments.append(flat)
    for name, p in named.items():
        state = {"step": torch.tensor(float(np.asarray(count)), dtype=torch.float32)}
        for key, flat in zip(("exp_avg", "exp_avg_sq"), moments):
            if flat is None:
                state[key] = torch.zeros_like(p, memory_format=torch.preserve_format)
                continue
            v = flat[name]
            t = v if isinstance(v, torch.Tensor) else torch.from_numpy(np.array(v))
            if tuple(t.shape) != tuple(p.shape):
                raise ValueError(f"{key} of {name}: {tuple(t.shape)}, parameter "
                                 f"{tuple(p.shape)}")
            state[key] = t.to(device=p.device, dtype=p.dtype, copy=True)
        optimizer.state[p] = state


def adamw_state_tree(optimizer: torch.optim.Optimizer, model: nn.Module) -> dict:
    """``optimizer``'s state in optax's layout: ``{"count": step, "mu": {name:
    exp_avg}, "nu": {name: exp_avg_sq}}`` keyed like ``model``'s
    parameters. The moments are the optimizer's own tensors; ``count`` is a
    copy of the first parameter's step."""
    named = dict(model.named_parameters())
    states = {name: optimizer.state[p] for name, p in named.items()}
    first = next(iter(states.values()))
    return {"count": first["step"].clone(),
            "mu": {name: st["exp_avg"] for name, st in states.items()},
            "nu": {name: st["exp_avg_sq"] for name, st in states.items()}}


# ---------------------------------------------------------------------------
# random weights (the distributions of deepv_tpu's init, drawn with torch)
# ---------------------------------------------------------------------------

class _Init:
    """Draws leaves on ``device`` from one ``torch.Generator``; each draw is
    made in float32 and cast to ``dtype``."""

    def __init__(self, seed: int, dtype, device):
        self.device = torch.device(device)
        self.dtype = dtype
        self.g = torch.Generator(device=self.device)
        self.g.manual_seed(seed)

    def _rand(self, shape):
        return torch.rand(shape, generator=self.g, device=self.device, dtype=torch.float32)

    def zeros(self, n):
        return torch.zeros(n, dtype=self.dtype, device=self.device)

    def ones(self, n):
        return torch.ones(n, dtype=self.dtype, device=self.device)

    def linear(self, n_in: int, n_out: int) -> dict:
        """Xavier-uniform weight [out, in], zero bias."""
        bound = math.sqrt(6.0 / (n_in + n_out))
        w = (self._rand((n_out, n_in)) * 2.0 - 1.0) * bound
        return {"weight": w.to(self.dtype), "bias": self.zeros(n_out)}

    def conv3d(self, c_in: int, c_out: int, k: int) -> dict:
        """0.02 * normal truncated to +-2 std, zero bias."""
        lo, hi = (0.5 * (1.0 + math.erf(x / math.sqrt(2.0))) for x in (-2.0, 2.0))
        u = self._rand((c_out, c_in, k, k, k)) * (hi - lo) + lo
        w = (torch.erfinv(2.0 * u - 1.0) * math.sqrt(2.0)).clamp_(-2.0, 2.0) * 0.02
        return {"weight": w.to(self.dtype), "bias": self.zeros(c_out)}

    def patch(self, c_in: int, dim: int, p: int) -> dict:
        """Patch projection [D, c, p, p]: normal / sqrt(c*p*p), zero bias."""
        w = torch.randn((dim, c_in, p, p), generator=self.g, device=self.device,
                        dtype=torch.float32) / math.sqrt(c_in * p * p)
        return {"weight": w.to(self.dtype), "bias": self.zeros(dim)}

    def norm(self, n: int) -> dict:
        return {"weight": self.ones(n), "bias": self.zeros(n)}


def _mmdit_tree(cfg: MMDiTConfig, init: _Init) -> dict:
    D, hd = cfg.inner_dim, cfg.attention_head_dim
    pos = sincos_2d(D, cfg.pos_embed_max_size, base_size=cfg.sample_size // cfg.patch_size)
    blocks = []
    for i in range(cfg.num_layers):
        last = i == cfg.num_layers - 1
        attn = {name: init.linear(D, D) for name in
                ("to_q", "to_k", "to_v", "add_q_proj", "add_k_proj", "add_v_proj")}
        attn.update({name: {"weight": init.ones(hd)} for name in
                     ("norm_q", "norm_k", "norm_add_q", "norm_add_k")})
        attn["to_out"] = init.linear(D, D)
        if not last:
            attn["to_add_out"] = init.linear(D, D)
        block = {"norm1": {"linear": init.linear(D, 6 * D)},
                 "norm1_context": {"linear": init.linear(D, 2 * D if last else 6 * D)},
                 "attn": attn,
                 "ff": {"proj": init.linear(D, 4 * D), "out": init.linear(4 * D, D)}}
        if not last:
            block["ff_context"] = {"proj": init.linear(D, 4 * D), "out": init.linear(4 * D, D)}
        blocks.append(block)
    return {
        "pos_embed": {
            "proj": init.patch(cfg.in_channels, D, cfg.patch_size),
            "proj_history": init.patch(cfg.in_channels, D, cfg.patch_size),
            "pos_embed": torch.as_tensor(pos[None], dtype=init.dtype, device=init.device),
        },
        "time_text_embed": {
            "timestep_embedder": {"linear_1": init.linear(256, D), "linear_2": init.linear(D, D)},
            "text_embedder": {"linear_1": init.linear(cfg.pooled_projection_dim, D),
                              "linear_2": init.linear(D, D)},
        },
        "context_embedder": init.linear(cfg.joint_attention_dim, cfg.caption_projection_dim),
        "transformer_blocks": blocks,
        "norm_out": {"linear": init.linear(D, 2 * D)},
        "proj_out": init.linear(D, cfg.patch_size ** 2 * cfg.out_channels),
    }


def _resnet(init: _Init, c_in: int, c_out: int) -> dict:
    p = {"norm1": init.norm(c_in), "conv1": init.conv3d(c_in, c_out, 3),
         "norm2": init.norm(c_out), "conv2": init.conv3d(c_out, c_out, 3)}
    if c_in != c_out:
        p["conv_shortcut"] = init.conv3d(c_in, c_out, 1)
    return p


def _midblock(init: _Init, ch: int) -> dict:
    attn = {"group_norm": init.norm(ch)}
    attn.update({name: init.linear(ch, ch) for name in ("to_q", "to_k", "to_v", "to_out")})
    return {"resnets": [_resnet(init, ch, ch), _resnet(init, ch, ch)], "attentions": [attn]}


def _vae_tree(cfg: VAEConfig, init: _Init) -> dict:
    z = cfg.encoder_out_channels
    ech = cfg.encoder_block_out_channels
    enc = {"conv_in": init.conv3d(cfg.encoder_in_channels, ech[0], 3)}
    blocks, c_prev = [], ech[0]
    for i, c in enumerate(ech):
        b = {"resnets": [_resnet(init, c_prev if j == 0 else c, c)
                         for j in range(cfg.encoder_layers_per_block[i])]}
        if cfg.encoder_spatial_down_sample[i]:
            b["downsampler"] = init.conv3d(c, c, 3)
        if cfg.encoder_temporal_down_sample[i]:
            b["temporal_downsampler"] = init.conv3d(c, c, 3)
        blocks.append(b)
        c_prev = c
    enc.update({"down_blocks": blocks, "mid_block": _midblock(init, ech[-1]),
                "conv_norm_out": init.norm(ech[-1]),
                "conv_out": init.conv3d(ech[-1], 2 * z, 3),
                "quant_conv": init.conv3d(2 * z, 2 * z, 1)})

    dch = cfg.decoder_block_out_channels
    rev = list(reversed(dch))
    dec = {"post_quant_conv": init.conv3d(z, cfg.decoder_in_channels, 1),
           "conv_in": init.conv3d(cfg.decoder_in_channels, dch[-1], 3),
           "mid_block": _midblock(init, dch[-1])}
    blocks, c_prev = [], rev[0]
    for i, c in enumerate(rev):
        b = {"resnets": [_resnet(init, c_prev if j == 0 else c, c)
                         for j in range(cfg.decoder_layers_per_block[i])]}
        if cfg.decoder_spatial_up_sample[i]:
            b["upsampler"] = init.conv3d(c, 4 * c, 3)
        if cfg.decoder_temporal_up_sample[i]:
            b["temporal_upsampler"] = init.conv3d(c, 2 * c, 3)
        blocks.append(b)
        c_prev = c
    dec.update({"up_blocks": blocks, "conv_norm_out": init.norm(dch[0]),
                "conv_out": init.conv3d(dch[0], cfg.decoder_out_channels, 3)})
    return {"encoder": enc, "decoder": dec}


def random_mmdit_params(mcfg: MMDiTConfig, dtype=torch.bfloat16, seed: int = 0,
                        device="cuda") -> dict:
    """The MMDiT part of ``random_params``: the same tree, without drawing
    the VAE's."""
    return _mmdit_tree(mcfg, _Init(seed, dtype, device))


def random_params(mcfg: MMDiTConfig, vcfg: VAEConfig, dtype=torch.bfloat16,
                  seed: int = 0, device="cuda") -> dict:
    """Full random parameter tree ``{"mmdit": ..., "vae": ...}`` drawn on
    ``device`` from a seeded ``torch.Generator``, with deepv_tpu's init
    distributions: xavier-uniform linears, 0.02 truncated-normal conv3d,
    scaled-normal patch projections, ones/zeros norms. (Constant fills are
    avoided: they make the decoded disparity constant and the rollout NaN
    from its second chunk on.) The values differ from deepv_tpu's: JAX's and
    torch's generators give different numbers for one seed."""
    return {"mmdit": random_mmdit_params(mcfg, dtype, seed, device),
            "vae": _vae_tree(vcfg, _Init(seed + 1, dtype, device))}


# ---------------------------------------------------------------------------
# checkpoints: diffusers / transformers safetensors -> deepv_tpu's trees
# ---------------------------------------------------------------------------

def _set(tree: dict, dotted: str, value) -> None:
    """Assign into a nested dict/list tree by a dotted path with int indices
    (absent list slots become None)."""
    parts = [int(p) if p.isdigit() else p for p in dotted.split(".")]
    node = tree
    for i, p in enumerate(parts[:-1]):
        nxt_is_int = isinstance(parts[i + 1], int)
        if isinstance(p, int):
            while len(node) <= p:
                node.append([] if nxt_is_int else {})
            node = node[p]
        else:
            if p not in node:
                node[p] = [] if nxt_is_int else {}
            node = node[p]
    last = parts[-1]
    if isinstance(last, int):
        while len(node) <= last:
            node.append(None)
    node[last] = value


#: checkpoint key -> tree path rewrites of the MMDiT (deepv_tpu's rules)
_MMDIT_RULES = [
    (re.compile(r"\.net\.0\.proj\."), ".proj."),      # FeedForward GELU proj
    (re.compile(r"\.net\.2\."), ".out."),              # FeedForward out linear
    (re.compile(r"\.to_out\.0\."), ".to_out."),        # attention out (drop dropout idx)
]

#: the same for the causal VAE
_VAE_RULES = [
    (re.compile(r"\.conv\.(weight|bias)$"), r".\1"),               # CausalConv3d wrapper
    # re/down/up-samplers wrap their conv as an attribute named ``conv``
    (re.compile(r"\.downsamplers\.0\.conv\."), ".downsampler."),
    (re.compile(r"\.temporal_downsamplers\.0\.conv\."), ".temporal_downsampler."),
    (re.compile(r"\.upsamplers\.0\.conv\."), ".upsampler."),
    (re.compile(r"\.temporal_upsamplers\.0\.conv\."), ".temporal_upsampler."),
    (re.compile(r"\.to_out\.0\."), ".to_out."),
]


def _rewrite(key: str, rules) -> str:
    for pat, repl in rules:
        key = pat.sub(repl, key)
    return key


def _leaf(v: torch.Tensor, dtype, device) -> torch.Tensor:
    """One checkpoint tensor moved to ``device`` (once; None keeps it where
    it is) and cast to ``dtype`` there."""
    return (v if device is None else v.to(device)).to(dtype)


def convert_mmdit_state(state: Dict[str, torch.Tensor], dtype=torch.bfloat16,
                        device=None) -> dict:
    """A diffusers transformer state -> deepv_tpu's MMDiT tree, every leaf
    cast to ``dtype``; the ``pos_embed.pos_embed`` table is then cast back to
    float32 (deepv_tpu keeps an f32 copy: the file's values rounded to
    ``dtype``)."""
    tree: dict = {}
    for k, v in state.items():
        _set(tree, _rewrite(k, _MMDIT_RULES), _leaf(v, dtype, device))
    if isinstance(tree.get("pos_embed"), dict) and "pos_embed" in tree["pos_embed"]:
        tree["pos_embed"]["pos_embed"] = tree["pos_embed"]["pos_embed"].to(torch.float32)
    return tree


def convert_vae_state(state: Dict[str, torch.Tensor], dtype=torch.bfloat16,
                      device=None) -> dict:
    """A diffusers causal-VAE state -> deepv_tpu's VAE tree: the quant convs,
    which the checkpoint keeps beside the encoder and decoder, nest as
    ``encoder.quant_conv`` and ``decoder.post_quant_conv``."""
    tree: dict = {}
    for k, v in state.items():
        k2 = _rewrite(k, _VAE_RULES)
        if k2.startswith("quant_conv."):
            k2 = "encoder." + k2
        elif k2.startswith("post_quant_conv."):
            k2 = "decoder." + k2
        _set(tree, k2, _leaf(v, dtype, device))
    return tree


def load_checkpoint(model_path: str, dtype=torch.bfloat16, device=None
                    ) -> Tuple[MMDiTConfig, VAEConfig, dict]:
    """A DeepVerse snapshot's ``transformer/`` and ``causal_video_vae/`` ->
    (MMDiTConfig, VAEConfig, {"mmdit": tree, "vae": tree}). The configs come
    from each ``config.json``, or are the defaults where it is absent; each
    leaf is read into a CPU tensor and moved to ``device`` once (None: it
    stays on the CPU)."""
    tdir = os.path.join(model_path, "transformer")
    vdir = os.path.join(model_path, "causal_video_vae")
    tjson, vjson = os.path.join(tdir, "config.json"), os.path.join(vdir, "config.json")
    mcfg = MMDiTConfig.from_json(tjson) if os.path.exists(tjson) else MMDiTConfig()
    vcfg = VAEConfig.from_json(vjson) if os.path.exists(vjson) else VAEConfig()
    params = {
        "mmdit": convert_mmdit_state(safetensors.load_dir(tdir), dtype, device),
        "vae": convert_vae_state(safetensors.load_dir(vdir), dtype, device),
    }
    return mcfg, vcfg, params


def convert_text_embeds_pt(pt_path: str, npz_path: str) -> None:
    """Convert the reference's torch text-embedding cache
    (``assets/text_embeds_len77.pt``: prompt -> field -> tensor) to the
    port's npz format (``io/text_embeds.load_text_embeds``)."""
    from .text_embeds import save_text_embeds

    raw = torch.load(pt_path, map_location="cpu")
    cache = {prompt: {field: t.float().numpy() for field, t in fields.items()}
             for prompt, fields in raw.items()}
    save_text_embeds(npz_path, cache)


# --- text encoder towers (CLIP-L / CLIP-G / T5) ------------------------------

#: tower name -> its snapshot directory (and ``tokenizer{,_2,_3}`` beside)
TEXT_TOWER_DIRS = {"clip_l": "text_encoder", "clip_g": "text_encoder_2", "t5": "text_encoder_3"}


def convert_text_tower_state(state: Dict[str, torch.Tensor], dtype=torch.bfloat16,
                             device=None) -> dict:
    """HF ``CLIPTextModelWithProjection`` / ``T5EncoderModel`` state -> tree.
    The keys are already the tree's paths (``models/text_encoders.py``);
    keys the towers never read (T5's tied ``encoder.embed_tokens.weight``)
    are kept."""
    tree: dict = {}
    for k, v in state.items():
        _set(tree, k, _leaf(v, dtype, device))
    return tree


def load_text_towers(model_path: str, dtype=torch.bfloat16, device="cuda"):
    """The three towers of a snapshot's ``text_encoder{,_2,_3}/`` on
    ``device``: ``(params, configs)``, keyed "clip_l", "clip_g", "t5". Each
    config comes from the tower's ``config.json``: ``num_attention_heads``,
    ``hidden_act`` (default quick_gelu) and ``eos_token_id`` (default 2) for
    a CLIP, ``num_heads`` and ``feed_forward_proj`` (gated unless it says
    otherwise) for T5."""
    params, configs = {}, {}
    for name, sub in TEXT_TOWER_DIRS.items():
        d = os.path.join(model_path, sub)
        with open(os.path.join(d, "config.json")) as f:
            raw = json.load(f)
        params[name] = convert_text_tower_state(safetensors.load_dir(d), dtype, device)
        if name == "t5":
            configs[name] = {
                "num_heads": raw["num_heads"],
                "gated_act": "gated" in raw.get("feed_forward_proj", "gated-gelu"),
            }
        else:
            configs[name] = {
                "num_heads": raw["num_attention_heads"],
                "act": raw.get("hidden_act", "quick_gelu"),
                "eos_token_id": raw.get("eos_token_id", 2),
            }
    return params, configs


def load_text_encoders(model_path: str, dtype=torch.bfloat16, device="cuda"):
    """An ``SD3TextEncoder`` on ``device`` from a snapshot's towers and
    tokenizers, or None when any of ``text_encoder{,_2,_3}/`` is absent.
    Tokenising needs the ``transformers`` package (ImportError without
    it)."""
    from ..models.text_encoders import SD3TextEncoder

    if not all(os.path.isdir(os.path.join(model_path, d)) for d in TEXT_TOWER_DIRS.values()):
        return None
    params, configs = load_text_towers(model_path, dtype, device)
    return SD3TextEncoder(model_path, params, configs, dtype=dtype, device=device)
