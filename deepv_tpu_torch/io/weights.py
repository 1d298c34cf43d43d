"""Parameter trees -> the port's modules, and random weights on the card.

deepv_tpu keeps parameters as a nested dict/list tree whose paths are the
diffusers module names (after its ``io/weights.py`` re-keying) and whose
leaves keep torch layouts. The port's ``MMDiT`` and ``VAE`` modules use the
same dotted names, so loading a tree is a flatten plus
``load_state_dict(strict=True)``.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import numpy as np
import torch
from torch import nn

from ..config import MMDiTConfig, VAEConfig
from ..models.mmdit import sincos_2d


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


def random_params(mcfg: MMDiTConfig, vcfg: VAEConfig, dtype=torch.bfloat16,
                  seed: int = 0, device="cuda") -> dict:
    """Full random parameter tree ``{"mmdit": ..., "vae": ...}`` drawn on
    ``device`` from a seeded ``torch.Generator``, with deepv_tpu's init
    distributions: xavier-uniform linears, 0.02 truncated-normal conv3d,
    scaled-normal patch projections, ones/zeros norms. (Constant fills are
    avoided: they make the decoded disparity constant and the rollout NaN
    from its second chunk on.) The values differ from deepv_tpu's: JAX's and
    torch's generators give different numbers for one seed."""
    return {"mmdit": _mmdit_tree(mcfg, _Init(seed, dtype, device)),
            "vae": _vae_tree(vcfg, _Init(seed + 1, dtype, device))}


def load_checkpoint(model_path: str, dtype=torch.bfloat16):
    """Not ported yet: the safetensors checkpoint loader."""
    raise NotImplementedError(
        "load_checkpoint: the checkpoint loader is not ported yet "
        "(ROADMAP M15, text encoders + checkpoint loader); use random weights")
