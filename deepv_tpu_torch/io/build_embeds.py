"""Build the precomputed action-vocabulary text-embedding cache.

The reference ships ``assets/text_embeds_len77.pt``, which is missing from
the public snapshot. The action vocabulary is closed (28 sentences,
``actions.action_vocabulary``), so the cache can be made again from the
checkpoint's own text encoders; this does that with the port's towers.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from ..actions import action_vocabulary


def build_action_embeds(text_encoder) -> Dict:
    """``text_encoder``: an ``SD3TextEncoder`` (models/text_encoders.py), or
    any callable with its contract. Returns sentence -> {"prompt_embeds"
    f32, "prompt_attention_mask" int32, "pooled_prompt_embeds" f32} numpy
    arrays."""
    cache = {}
    for sentence in action_vocabulary():
        seq, mask, pooled = text_encoder(sentence)
        cache[sentence] = {
            "prompt_embeds": seq.float().cpu().numpy(),
            "prompt_attention_mask": mask.cpu().numpy().astype(np.int32),
            "pooled_prompt_embeds": pooled.float().cpu().numpy(),
        }
    return cache
