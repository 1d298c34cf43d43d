"""A tiny configuration of the benchmark's cells for the CPU tests: the
published structure with every width cut down, float32, 64x64, and the
matching cells."""

import copy
import json
import os

from portbench import spec

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

TRANSFORMER = dict(sample_size=16, patch_size=2, in_channels=14, num_layers=2,
                   attention_head_dim=8, num_attention_heads=4, caption_projection_dim=32,
                   pooled_projection_dim=16, pos_embed_max_size=32, joint_attention_dim=24)
VAE = dict(encoder_out_channels=4, encoder_layers_per_block=[1, 1, 1, 1],
           encoder_block_out_channels=[8, 8, 16, 16], encoder_norm_num_groups=4,
           decoder_in_channels=4, decoder_layers_per_block=[1, 1, 1, 1],
           decoder_block_out_channels=[8, 8, 16, 16], decoder_norm_num_groups=4,
           sample_size=32)
#: the limits of the tiny float32 cells, float32 against float32: the
#: exact arithmetic's rounding, and the W8A8 path's, where an input on a
#: rounding boundary of the int8 grid lands on either side
LIMIT = {"fp32": 1e-3, "w8a8": 2e-2}


def config(name: str = "deepverse1.1-exact") -> dict:
    with open(os.path.join(ROOT, "portbench", "configs", name + ".json")) as f:
        cfg = json.load(f)
    cfg["transformer"].update(TRANSFORMER)
    cfg["vae"].update(VAE)
    cfg["serving"].update(dtype="float32", height=64, width=64)
    lim = LIMIT[cfg["numerics"]["reference"]]
    cfg["limits"] = {k: (0 if k == "flow_flags" else lim) for k in cfg["limits"]}
    return cfg


def cell(name: str, config_name: str = None) -> spec.Cell:
    """The cell ``name`` of BENCHMARK.json at the tiny size, with the
    configuration ``config_name`` in place of its own where given."""
    real = spec.load_cell(name, ROOT)
    config_name = config_name or real.config_name
    return spec.Cell(name=name, chips=1, config=config(config_name),
                     config_name=config_name, traffic_name=real.traffic_name,
                     mix=copy.deepcopy(real.mix), end_to_end=real.end_to_end,
                     per_layer=real.per_layer)
