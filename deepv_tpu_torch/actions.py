"""Game-pad action grammar -> per-unit motion sentences.

Capability parity with ref run.py:267-290: an action string like
``(FN)(fRL)(SR)`` is one parenthesised group per generated latent unit, each
group being an optional lowercase translation modifier + uppercase
translation code, followed by a rotation code. The vocabulary is closed
(9 translations x 3 rotations + 'empty'), which is why precomputed text
embeddings cover the whole action space.

A copy of deepv_tpu's ``actions.py`` (the port imports nothing of the JAX
package).
"""

from __future__ import annotations

import re
from typing import List

ACTION_PATTERN = r"^\((?:[a-z][A-Z]{2}|[A-Z]{2})(?:\)\((?:[a-z][A-Z]{2}|[A-Z]{2}))*\)$"

TRANS_PROMPTS = {
    "S": "Stay where you are.",
    "L": "Move to the left.",
    "rL": "Move to the rear left.",
    "B": "Move backward.",
    "rR": "Move to the rear right.",
    "R": "Move to the right.",
    "fR": "Move to the front right.",
    "F": "Move forward.",
    "fL": "Move to the front left.",
}

ROT_PROMPTS = {
    "N": "The perspective hasn't changed.",
    "L": "Rotate the perspective counterclockwise.",
    "R": "Rotate the perspective clockwise.",
}


def parse_action_prompt(prompt: str) -> List[str]:
    """Parse an action string into motion sentences, 'empty' first
    (the first latent unit is the conditioning frame, ref run.py:271)."""
    if not re.fullmatch(ACTION_PATTERN, prompt):
        raise ValueError(f"input action prompt is not valid: {prompt!r}")
    matches = re.findall(r"\((.*?)\)", prompt)
    motion_prompts = ["empty"]
    for m in matches:
        trans, rot = m[:-1], m[-1:]
        if trans not in TRANS_PROMPTS:
            raise ValueError(f"unknown translation code {trans!r} in {m!r}")
        if rot not in ROT_PROMPTS:
            raise ValueError(f"unknown rotation code {rot!r} in {m!r}")
        motion_prompts.append(TRANS_PROMPTS[trans] + " " + ROT_PROMPTS[rot])
    return motion_prompts


def action_vocabulary() -> List[str]:
    """All 28 sentences the action pathway can produce (incl. 'empty')."""
    vocab = ["empty"]
    for tp in TRANS_PROMPTS.values():
        for rp in ROT_PROMPTS.values():
            vocab.append(tp + " " + rp)
    return vocab


def prepare_motion_prompts(prompt_type: str, prompt: str, repeat_text: int = 10) -> List[str]:
    """Motion-prompt list for a generation request (ref run.py:267-293)."""
    if prompt_type == "action":
        return parse_action_prompt(prompt)
    return [prompt] * repeat_text
