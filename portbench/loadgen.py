"""The one generator of the benchmark's traffic: the requests of a mix
(``traffic/<name>.json``), drawn from the run's seed.

A ``rollout`` mix runs whole rollouts back to back. Its ``rounds`` lists
ranges of action counts; each round takes one rollout from every range,
in the listed order, with an action count drawn from the seed inside the
range. A rollout's chunks, units and frames follow from the range alone,
so every seed sends the same work in the same order, with its own images
and actions; a window shorter than a round then holds the same work on
every seed.
A ``session`` mix is one player: a conditioning image, then one action a
step.
"""

from __future__ import annotations

from typing import Dict, Iterator

import numpy as np

from .inputs import ACTIONS, action_string, image, sub_seed


def chunks_of(n_actions: int, units: int = 8, carried: int = 4) -> int:
    """Chunks of a rollout of ``n_actions`` actions: its prompt list
    ('empty' first) padded with its last entry until ``units`` entries and
    then whole chunks of ``units - carried`` more."""
    n = n_actions + 1
    while (n - units) % (units - carried) or n < units:
        n += 1
    return (n - units) // (units - carried) + 1


def actions_for(chunks: int, units: int = 8, carried: int = 4) -> int:
    """The most actions a rollout of ``chunks`` chunks takes."""
    return units - 1 + (units - carried) * (chunks - 1)


def rollouts(mix: Dict, seed: int, height: int, width: int, units: int = 8,
             carried: int = 4) -> Iterator[Dict]:
    """{"image", "actions", "chunks"} of each rollout, round after round."""
    rng = np.random.default_rng(sub_seed(seed, "traffic"))
    ranges = [tuple(r) for r in mix["rounds"]]
    for r in ranges:
        if len({chunks_of(n, units, carried) for n in r}) != 1:
            raise ValueError(f"the range {r} spans rollouts of different chunk counts")
    while True:
        for lo, hi in ranges:
            n = int(rng.integers(lo, hi + 1))
            yield {"image": image(rng, height, width), "actions": action_string(rng, n),
                   "chunks": chunks_of(n, units, carried)}


def boundary_steps(warm_steps: int, units: int = 8, carried: int = 4):
    """(first, last) step of a session's window around its first chunk
    boundary: the step before the one that ends a chunk, that step, and
    the step after it. Set-up has taken ``warm_steps`` steps; the first
    chunk ends with step ``units`` and every later one ``units - carried``
    steps on."""
    k = 1
    while (warm_steps + k + 1 - units) % (units - carried) or warm_steps + k + 1 < units:
        k += 1
    return k - 1, k + 1


def session(seed: int, height: int, width: int):
    """(conditioning image, iterator of actions) of one player."""
    rng = np.random.default_rng(sub_seed(seed, "traffic"))
    img = image(rng, height, width)

    def actions():
        while True:
            yield ACTIONS[int(rng.integers(0, len(ACTIONS)))]

    return img, actions()
