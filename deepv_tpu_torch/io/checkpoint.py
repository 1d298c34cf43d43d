"""Checkpoint save and restore of parameter and training state.

Counterpart of ``deepv_tpu/io/checkpoint.py`` in the port's own format:
deepv_tpu writes orbax checkpoints, and the port has no orbax. A step is a
directory holding one ``torch.save`` file of the state tree (nested dicts
and lists of tensors and plain numbers); the metadata goes to the same
``path + ".meta.json"`` sidecar as deepv_tpu's. ``restore_pytree`` loads
with ``weights_only=True`` (no arbitrary unpickling), memory-mapped, and
copies each leaf into its template leaf, on that leaf's device and dtype;
a template that holds one rank's slice of each split leaf (a
tensor-parallel model, ``parallel/tp.restore_split``) takes its slice of
the whole leaf, so every checkpoint is in the single-device layout.
"""

from __future__ import annotations

import json
import os
from typing import Any, Callable, Optional

import torch

#: the state file inside a step directory
STATE_FILE = "state.pt"


def save_pytree(path: str, tree: Any, metadata: Optional[dict] = None) -> None:
    """Save a state tree to the directory ``path``; overwrites an existing
    step (the file is written beside it and renamed over it)."""
    path = os.path.abspath(path)
    os.makedirs(path, exist_ok=True)
    tmp = os.path.join(path, STATE_FILE + ".tmp")
    torch.save(tree, tmp)
    os.replace(tmp, os.path.join(path, STATE_FILE))
    if metadata:
        with open(path + ".meta.json", "w") as f:
            json.dump(metadata, f)


def _restore(saved, tmpl, where: str, copy: bool, split: Optional[Callable]):
    """Walk ``saved`` along the template ``tmpl``: check its structure and
    shapes, and with ``copy`` copy each tensor leaf (or the template's slice
    of it, per ``split``) into the template's."""
    if isinstance(tmpl, dict):
        if not isinstance(saved, dict):
            raise ValueError(f"checkpoint entry {where or '<root>'} is not a mapping")
        out = {}
        for k, t in tmpl.items():
            if k not in saved:
                raise KeyError(f"checkpoint has no entry {where}{k}")
            out[k] = _restore(saved[k], t, f"{where}{k}.", copy, split)
        return out
    if isinstance(tmpl, (list, tuple)):
        if not isinstance(saved, (list, tuple)) or len(saved) != len(tmpl):
            raise ValueError(f"checkpoint entry {where[:-1]} does not match the template's "
                             f"{len(tmpl)} entries")
        return type(tmpl)(_restore(s, t, f"{where}{i}.", copy, split)
                          for i, (s, t) in enumerate(zip(saved, tmpl)))
    if isinstance(tmpl, torch.Tensor):
        part = split(where[:-1], tmpl) if split is not None else None
        want = list(tmpl.shape)
        if part is not None:
            dim, index, n = part
            want[dim] *= n
        if not isinstance(saved, torch.Tensor) or list(saved.shape) != want:
            got = tuple(saved.shape) if isinstance(saved, torch.Tensor) else type(saved).__name__
            raise ValueError(f"checkpoint entry {where[:-1]}: {got}, template "
                             f"{tuple(want)}")
        if copy:
            if part is not None:
                saved = saved.narrow(dim, index * tmpl.shape[dim], tmpl.shape[dim])
            with torch.no_grad():
                tmpl.copy_(saved)
        return tmpl
    return saved


def restore_pytree(path: str, template: Any, split: Optional[Callable] = None) -> Any:
    """Restore a state tree into ``template``, a live tree of the same
    structure: each saved leaf is copied into the template's tensor, so it
    takes that tensor's device and dtype and no second copy of the state is
    made on the device. ``split(name, leaf)``, where given, says which slice
    of the saved leaf at dotted path ``name`` the template leaf holds: (the
    split dimension, the slice's index, the number of slices), or None for
    the whole leaf. The whole checkpoint is checked first (a missing key
    raises KeyError, a shape mismatch ValueError), so a bad one changes
    nothing. Returns the template's structure, plain numbers as saved."""
    state = torch.load(os.path.join(os.path.abspath(path), STATE_FILE), map_location="cpu",
                       weights_only=True, mmap=True)
    _restore(state, template, "", False, split)
    return _restore(state, template, "", True, split)


def load_metadata(path: str) -> dict:
    meta_path = os.path.abspath(path) + ".meta.json"
    if os.path.exists(meta_path):
        with open(meta_path) as f:
            return json.load(f)
    return {}
