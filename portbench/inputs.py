"""The inputs a run hands to the program and to the reference, made from
the run's seed: derived seeds, the action embeddings, conditioning images
and action strings.

The action embeddings stand in for the SD3 encoders' outputs over the
closed action vocabulary (the published snapshot's cache of them is
missing): one float32 normal draw a sentence, ``[1, L, joint]`` with a
mask over its first ``max(2, min(L, 2 + len(sentence) // 6))`` tokens,
and a pooled ``[1, pooled]``; the negative prompt ``"empty"`` keeps two
tokens.
"""

from __future__ import annotations

import hashlib
from typing import Dict, List

import numpy as np

#: translation and rotation codes of the game-pad grammar and the sentences
#: each stands for
TRANSLATIONS = {"S": "Stay where you are.", "L": "Move to the left.",
                "rL": "Move to the rear left.", "B": "Move backward.",
                "rR": "Move to the rear right.", "R": "Move to the right.",
                "fR": "Move to the front right.", "F": "Move forward.",
                "fL": "Move to the front left."}
ROTATIONS = {"N": "The perspective hasn't changed.",
             "L": "Rotate the perspective counterclockwise.",
             "R": "Rotate the perspective clockwise."}
#: the negative prompt of classifier-free guidance, and a first chunk's
#: first unit's prompt
NEGATIVE = "empty"
#: every action a step or a rollout unit can take: "(FN)", "(fRL)", ...
ACTIONS = [f"({t}{r})" for t in TRANSLATIONS for r in ROTATIONS]


def sentence(action: str) -> str:
    """The motion sentence of one action "(<translation><rotation>)"."""
    code = action.strip("()")
    return TRANSLATIONS[code[:-1]] + " " + ROTATIONS[code[-1]]


def vocabulary() -> List[str]:
    """'empty' and every action's sentence."""
    return [NEGATIVE] + [sentence(a) for a in ACTIONS]


def sub_seed(seed: int, tag: str) -> int:
    """A 63-bit seed derived from the run's seed and a purpose."""
    digest = hashlib.sha256(f"{int(seed)}:{tag}".encode()).digest()
    return int.from_bytes(digest[:8], "little") >> 1


def text_tokens(prompt: str, seq_len: int) -> int:
    """Valid tokens of a sentence's mask."""
    return 2 if prompt == NEGATIVE else max(2, min(seq_len, 2 + len(prompt) // 6))


def action_embeds(seed: int, seq_len: int, joint_dim: int, pooled_dim: int) -> Dict:
    """The embedding cache {sentence: {"prompt_embeds", "prompt_attention_mask",
    "pooled_prompt_embeds"}} of the whole vocabulary."""
    rng = np.random.default_rng(sub_seed(seed, "embeds"))
    cache = {}
    for p in vocabulary():
        mask = np.zeros((1, seq_len), np.int32)
        mask[:, :text_tokens(p, seq_len)] = 1
        cache[p] = {
            "prompt_embeds": rng.standard_normal((1, seq_len, joint_dim)).astype(np.float32),
            "prompt_attention_mask": mask,
            "pooled_prompt_embeds": rng.standard_normal((1, pooled_dim)).astype(np.float32),
        }
    return cache


def image(rng: np.random.Generator, height: int, width: int) -> np.ndarray:
    """A conditioning image [1, 3, H, W] in [-1, 1], uniform per pixel, at
    float16 values (what the serving wire carries)."""
    x = rng.uniform(-1.0, 1.0, (1, 3, height, width)).astype(np.float16)
    return x.astype(np.float32)


def action_string(rng: np.random.Generator, n: int) -> str:
    """``n`` actions drawn uniformly from the vocabulary."""
    return "".join(ACTIONS[i] for i in rng.integers(0, len(ACTIONS), n))
