"""Checkpoint save and restore of parameter and training state.

Counterpart of ``deepv_tpu/io/checkpoint.py`` in the port's own format:
deepv_tpu writes orbax checkpoints, and the port has no orbax. A step is a
directory holding one ``torch.save`` file of the state tree (nested dicts
and lists of tensors and plain numbers); the metadata goes to the same
``path + ".meta.json"`` sidecar as deepv_tpu's. ``restore_pytree`` loads
with ``weights_only=True`` (no arbitrary unpickling), memory-mapped, and
copies each leaf into its template leaf, on that leaf's device and dtype.
"""

from __future__ import annotations

import json
import os
from typing import Any, Optional

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


def _restore(saved, tmpl, where: str, copy: bool):
    """Walk ``saved`` along the template ``tmpl``: check its structure and
    shapes, and with ``copy`` copy each tensor leaf into the template's."""
    if isinstance(tmpl, dict):
        if not isinstance(saved, dict):
            raise ValueError(f"checkpoint entry {where or '<root>'} is not a mapping")
        out = {}
        for k, t in tmpl.items():
            if k not in saved:
                raise KeyError(f"checkpoint has no entry {where}{k}")
            out[k] = _restore(saved[k], t, f"{where}{k}.", copy)
        return out
    if isinstance(tmpl, (list, tuple)):
        if not isinstance(saved, (list, tuple)) or len(saved) != len(tmpl):
            raise ValueError(f"checkpoint entry {where[:-1]} does not match the template's "
                             f"{len(tmpl)} entries")
        return type(tmpl)(_restore(s, t, f"{where}{i}.", copy)
                          for i, (s, t) in enumerate(zip(saved, tmpl)))
    if isinstance(tmpl, torch.Tensor):
        if not isinstance(saved, torch.Tensor) or tuple(saved.shape) != tuple(tmpl.shape):
            got = tuple(saved.shape) if isinstance(saved, torch.Tensor) else type(saved).__name__
            raise ValueError(f"checkpoint entry {where[:-1]}: {got}, template "
                             f"{tuple(tmpl.shape)}")
        if copy:
            with torch.no_grad():
                tmpl.copy_(saved)
        return tmpl
    return saved


def restore_pytree(path: str, template: Any) -> Any:
    """Restore a state tree into ``template``, a live tree of the same
    structure: each saved leaf is copied into the template's tensor, so it
    takes that tensor's device and dtype and no second copy of the state is
    made on the device. The whole checkpoint is checked first (a missing key
    raises KeyError, a shape mismatch ValueError), so a bad one changes
    nothing. Returns the template's structure, plain numbers as saved."""
    state = torch.load(os.path.join(os.path.abspath(path), STATE_FILE), map_location="cpu",
                       weights_only=True, mmap=True)
    _restore(state, template, "", copy=False)
    return _restore(state, template, "", copy=True)


def load_metadata(path: str) -> dict:
    meta_path = os.path.abspath(path) + ".meta.json"
    if os.path.exists(meta_path):
        with open(meta_path) as f:
            return json.load(f)
    return {}
