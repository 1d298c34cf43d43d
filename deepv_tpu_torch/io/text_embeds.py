"""Precomputed text-embedding cache (ref assets/text_embeds_len77.pt).

The action vocabulary is closed (28 motion sentences, see actions.py), so the
reference ships a dict of precomputed SD3 triple-encoder outputs keyed by
sentence and uses 'empty' as the negative prompt (ref pipeline.py:199,
598-607). We store the converted cache as .npz; ``random_text_embeds``
synthesises a structurally identical cache for tests and benchmarks.

A copy of deepv_tpu's ``io/text_embeds.py``: the numpy-seeded
``random_text_embeds`` gives the same embeddings in both packages.
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np


def random_text_embeds(seed: int, prompts: Sequence[str], joint_dim: int = 4096,
                       pooled_dim: int = 2048, seq_len: int = 77) -> Dict:
    rng = np.random.default_rng(seed)
    cache = {}
    for p in prompts:
        n_tok = max(2, min(seq_len, 2 + len(p) // 6))
        mask = np.zeros((1, seq_len), np.int32)
        mask[:, :n_tok] = 1
        cache[p] = {
            "prompt_embeds": rng.standard_normal((1, seq_len, joint_dim)).astype(np.float32),
            "prompt_attention_mask": mask,
            "pooled_prompt_embeds": rng.standard_normal((1, pooled_dim)).astype(np.float32),
        }
    if "empty" not in cache:
        cache["empty"] = {
            "prompt_embeds": rng.standard_normal((1, seq_len, joint_dim)).astype(np.float32),
            "prompt_attention_mask": np.concatenate(
                [np.ones((1, 2), np.int32), np.zeros((1, seq_len - 2), np.int32)], axis=1),
            "pooled_prompt_embeds": rng.standard_normal((1, pooled_dim)).astype(np.float32),
        }
    return cache


def save_text_embeds(path: str, cache: Dict) -> None:
    """Flatten the cache into one npz (keys are sentence||field)."""
    flat = {}
    for prompt, fields in cache.items():
        for field, arr in fields.items():
            flat[prompt + "\x1f" + field] = np.asarray(arr)
    np.savez_compressed(path, **flat)


def load_text_embeds(path: str) -> Dict:
    flat = np.load(path, allow_pickle=False)
    cache: Dict = {}
    for key in flat.files:
        prompt, field = key.split("\x1f", 1)
        cache.setdefault(prompt, {})[field] = flat[key]
    return cache
