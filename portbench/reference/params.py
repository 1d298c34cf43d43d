"""DeepVerse 1.1's parameter tree and its seeded random weights.

The leaves are named as the published checkpoint's modules (diffusers
names, with the feed-forward and output projections re-keyed as the JAX
package's trees are: ``ff.proj``, ``ff.out``, ``attn.to_out``, the VAE's
samplers by role), keyed ``"mmdit.<path>"`` and ``"vae.<path>"``.

``make_params`` draws every leaf on the device from one seeded
``torch.Generator``, a call per group of leaves of one shape and kind
rather than one per leaf: xavier-uniform linears, 0.02 normal convs
truncated at two deviations, patch projections normal over the fan-in,
ones and zeros for norms and biases, and the SD3 sincos table. The same
seed gives the same bits, so the program under test and the reference
get the same weights from it.
"""

from __future__ import annotations

import math
from collections import OrderedDict
from typing import Dict, List, Tuple

import torch

#: per-block linears that the W8A8 path quantises
BLOCK_ATTN = ("to_q", "to_k", "to_v", "to_out", "add_q_proj", "add_k_proj", "add_v_proj",
              "to_add_out")
BLOCK_FF = ("ff", "ff_context")


def mmdit_leaves(t: Dict) -> List[Tuple[str, tuple, tuple]]:
    """(name, shape, init) of every MMDiT leaf; ``t`` is the transformer's
    configuration."""
    d = t["num_attention_heads"] * t["attention_head_dim"]
    hd, p, c = t["attention_head_dim"], t["patch_size"], t["in_channels"]
    out: List[Tuple[str, tuple, tuple]] = []

    def linear(name, n_in, n_out):
        out.append((f"{name}.weight", (n_out, n_in), ("xavier", n_in, n_out)))
        out.append((f"{name}.bias", (n_out,), ("zeros",)))

    for proj in ("proj", "proj_history"):
        out.append((f"pos_embed.{proj}.weight", (d, c, p, p), ("patch", c * p * p)))
        out.append((f"pos_embed.{proj}.bias", (d,), ("zeros",)))
    m = t["pos_embed_max_size"]
    out.append(("pos_embed.pos_embed", (1, m * m, d), ("sincos",)))
    linear("time_text_embed.timestep_embedder.linear_1", 256, d)
    linear("time_text_embed.timestep_embedder.linear_2", d, d)
    linear("time_text_embed.text_embedder.linear_1", t["pooled_projection_dim"], d)
    linear("time_text_embed.text_embedder.linear_2", d, d)
    linear("context_embedder", t["joint_attention_dim"], t["caption_projection_dim"])
    for i in range(t["num_layers"]):
        last = i == t["num_layers"] - 1
        b = f"transformer_blocks.{i}"
        linear(f"{b}.norm1.linear", d, 6 * d)
        linear(f"{b}.norm1_context.linear", d, 2 * d if last else 6 * d)
        for name in ("to_q", "to_k", "to_v", "add_q_proj", "add_k_proj", "add_v_proj"):
            linear(f"{b}.attn.{name}", d, d)
        for name in ("norm_q", "norm_k", "norm_add_q", "norm_add_k"):
            out.append((f"{b}.attn.{name}.weight", (hd,), ("ones",)))
        linear(f"{b}.attn.to_out", d, d)
        if not last:
            linear(f"{b}.attn.to_add_out", d, d)
        for ff in ("ff",) if last else ("ff", "ff_context"):
            linear(f"{b}.{ff}.proj", d, 4 * d)
            linear(f"{b}.{ff}.out", 4 * d, d)
    linear("norm_out.linear", d, 2 * d)
    linear("proj_out", d, p * p * c)
    return out


def vae_leaves(v: Dict) -> List[Tuple[str, tuple, tuple]]:
    """(name, shape, init) of every leaf of the causal VAE; ``v`` is its
    configuration."""
    out: List[Tuple[str, tuple, tuple]] = []

    def conv(name, ci, co, k):
        out.append((f"{name}.weight", (co, ci, k, k, k), ("trunc",)))
        out.append((f"{name}.bias", (co,), ("zeros",)))

    def norm(name, c):
        out.append((f"{name}.weight", (c,), ("ones",)))
        out.append((f"{name}.bias", (c,), ("zeros",)))

    def resnet(name, ci, co):
        norm(f"{name}.norm1", ci)
        conv(f"{name}.conv1", ci, co, 3)
        norm(f"{name}.norm2", co)
        conv(f"{name}.conv2", co, co, 3)
        if ci != co:
            conv(f"{name}.conv_shortcut", ci, co, 1)

    def midblock(name, c):
        resnet(f"{name}.resnets.0", c, c)
        resnet(f"{name}.resnets.1", c, c)
        a = f"{name}.attentions.0"
        norm(f"{a}.group_norm", c)
        for lin in ("to_q", "to_k", "to_v", "to_out"):
            out.append((f"{a}.{lin}.weight", (c, c), ("xavier", c, c)))
            out.append((f"{a}.{lin}.bias", (c,), ("zeros",)))

    z = v["encoder_out_channels"]
    ech = v["encoder_block_out_channels"]
    conv("encoder.conv_in", v["encoder_in_channels"], ech[0], 3)
    c_prev = ech[0]
    for i, c in enumerate(ech):
        for j in range(v["encoder_layers_per_block"][i]):
            resnet(f"encoder.down_blocks.{i}.resnets.{j}", c_prev if j == 0 else c, c)
        if v["encoder_spatial_down_sample"][i]:
            conv(f"encoder.down_blocks.{i}.downsampler", c, c, 3)
        if v["encoder_temporal_down_sample"][i]:
            conv(f"encoder.down_blocks.{i}.temporal_downsampler", c, c, 3)
        c_prev = c
    midblock("encoder.mid_block", ech[-1])
    norm("encoder.conv_norm_out", ech[-1])
    conv("encoder.conv_out", ech[-1], 2 * z, 3)
    conv("encoder.quant_conv", 2 * z, 2 * z, 1)

    dch = list(v["decoder_block_out_channels"])
    rev = list(reversed(dch))
    conv("decoder.post_quant_conv", z, v["decoder_in_channels"], 1)
    conv("decoder.conv_in", v["decoder_in_channels"], dch[-1], 3)
    midblock("decoder.mid_block", dch[-1])
    c_prev = rev[0]
    for i, c in enumerate(rev):
        for j in range(v["decoder_layers_per_block"][i]):
            resnet(f"decoder.up_blocks.{i}.resnets.{j}", c_prev if j == 0 else c, c)
        if v["decoder_spatial_up_sample"][i]:
            conv(f"decoder.up_blocks.{i}.upsampler", c, 4 * c, 3)
        if v["decoder_temporal_up_sample"][i]:
            conv(f"decoder.up_blocks.{i}.temporal_upsampler", c, 2 * c, 3)
        c_prev = c
    norm("decoder.conv_norm_out", dch[0])
    conv("decoder.conv_out", dch[0], v["decoder_out_channels"], 3)
    return out


def is_block_linear(name: str) -> bool:
    """Whether ``name`` (an MMDiT leaf, without the ``mmdit.`` prefix) is
    one of the per-block linears the W8A8 path quantises."""
    parts = name.split(".")
    if len(parts) < 4 or parts[0] != "transformer_blocks":
        return False
    return ((parts[2] == "attn" and parts[3] in BLOCK_ATTN)
            or (parts[2] in BLOCK_FF and parts[3] in ("proj", "out")))


def sincos_2d(embed_dim: int, grid_size: int, base_size: int, device) -> torch.Tensor:
    """SD3's 2-D sincos table ``[grid * grid, embed_dim]`` in float64: the
    grid in float32, the products and transcendentals in float64."""
    grid = torch.arange(grid_size, dtype=torch.float32, device=device) / (grid_size / base_size)
    gw, gh = torch.meshgrid(grid, grid, indexing="xy")

    def one_d(dim, pos):
        omega = torch.arange(dim // 2, dtype=torch.float64, device=device) / (dim / 2.0)
        omega = 1.0 / 10000 ** omega
        out = pos.reshape(-1).to(torch.float64)[:, None] * omega[None]
        return torch.cat([torch.sin(out), torch.cos(out)], dim=1)

    return torch.cat([one_d(embed_dim // 2, gw), one_d(embed_dim // 2, gh)], dim=1)


#: at most this many float32 values are drawn in one call
_DRAW_CHUNK = 1 << 29


def _draw(g, shape, kind, device) -> torch.Tensor:
    """One group's float32 draw of ``shape`` (the group's leaves stacked)."""
    n = math.prod(shape)
    flat = torch.empty(n, dtype=torch.float32, device=device)
    for lo in range(0, n, _DRAW_CHUNK):
        part = flat[lo:lo + _DRAW_CHUNK]
        if kind == "patch":
            part.normal_(generator=g)
        else:
            part.uniform_(generator=g)
    return flat.reshape(shape)


def make_params(cfg: Dict, seed: int, dtype=torch.bfloat16, device="cuda") -> Dict[str, torch.Tensor]:
    """Every leaf of the configuration's model, ``{"mmdit.<path>": tensor,
    "vae.<path>": tensor}``, in ``dtype`` on ``device``. The draws are made
    per group of leaves with one shape and one initialisation (and, for the
    MMDiT's linears, one role: the W8A8 path frees the per-block ones, so
    they share no storage with the rest); a leaf is a view of its group."""
    device = torch.device(device)
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % (1 << 64))
    leaves = ([("mmdit." + n, s, i) for n, s, i in mmdit_leaves(cfg["transformer"])]
              + [("vae." + n, s, i) for n, s, i in vae_leaves(cfg["vae"])])
    groups: "OrderedDict[tuple, List[str]]" = OrderedDict()
    shapes, inits = {}, {}
    for name, shape, init in leaves:
        shapes[name], inits[name] = shape, init
        if init[0] in ("xavier", "trunc", "patch"):
            role = is_block_linear(name[len("mmdit."):]) if name.startswith("mmdit.") else False
            groups.setdefault((init, shape, role), []).append(name)
    out: Dict[str, torch.Tensor] = {}
    lo, hi = (0.5 * (1.0 + math.erf(x / math.sqrt(2.0))) for x in (-2.0, 2.0))
    for (init, shape, _), names in groups.items():
        u = _draw(g, (len(names),) + tuple(shape), init[0], device)
        if init[0] == "xavier":
            bound = math.sqrt(6.0 / (init[1] + init[2]))
            w = u.mul_(2.0 * bound).sub_(bound)
        elif init[0] == "trunc":
            w = torch.erfinv(u.mul_(hi - lo).add_(lo).mul_(2.0).sub_(1.0))
            w = w.mul_(math.sqrt(2.0)).clamp_(-2.0, 2.0).mul_(0.02)
        else:
            w = u.div_(math.sqrt(init[1]))
        w = w.to(dtype)
        for k, name in enumerate(names):
            out[name] = w[k]
        del u
    t = cfg["transformer"]
    for name, shape, init in leaves:
        if init[0] == "zeros":
            out[name] = torch.zeros(shape, dtype=dtype, device=device)
        elif init[0] == "ones":
            out[name] = torch.ones(shape, dtype=dtype, device=device)
        elif init[0] == "sincos":
            d = t["num_attention_heads"] * t["attention_head_dim"]
            table = sincos_2d(d, t["pos_embed_max_size"], t["sample_size"] // t["patch_size"],
                              device)
            # kept in float32, as a snapshot's table is loaded: its values
            # rounded to the served type
            out[name] = table.to(dtype).to(torch.float32).reshape(shape)
    return {name: out[name] for name, _, _ in leaves}


def split_tree(params: Dict[str, torch.Tensor], prefix: str) -> Dict[str, torch.Tensor]:
    """The leaves under ``prefix`` ("mmdit" or "vae"), keyed without it."""
    k = len(prefix) + 1
    return {name[k:]: v for name, v in params.items() if name.startswith(prefix + ".")}
