"""Tensor parallelism of the MMDiT: the Megatron splits of its parameters.

Counterpart of ``deepv_tpu/parallel/tp.py``, with the same table:

  - column-split (the output features, so each rank holds whole heads, the
    heads contiguous per rank): ``to_q``, ``to_k``, ``to_v``,
    ``add_{q,k,v}_proj``, ``ff.proj``, ``ff_context.proj``, weight and bias;
  - row-split (the input features): the weights of ``to_out``,
    ``to_add_out``, ``ff.out`` and ``ff_context.out``; their biases stay
    whole and are added once, after the partial products are summed
    (``models/mmdit._row_linear``);
  - replicated: everything else (AdaLN, norms, embedders, ``proj_out``).

deepv_tpu expresses the split as ``PartitionSpec``s and lets GSPMD insert
the reductions; here ``mmdit_param_spec`` gives the same spec as a plain
tuple, and ``shard_mmdit_params`` cuts this rank's slice out of a full tree.
``gather_mmdit_params`` is its inverse over the tp group, and
``restore_split`` tells ``io/checkpoint.restore_pytree`` which slice of a
whole checkpoint's leaf a rank holds: a tensor-parallel ``Trainer`` writes
and reads the single-device format, as orbax does for deepv_tpu's sharded
arrays.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from . import comm

_COL = ("to_q", "to_k", "to_v", "add_q_proj", "add_k_proj", "add_v_proj")
_ROW = ("to_out", "to_add_out")


def mmdit_param_spec(name: str, leaf, tp_axis: str = "tp") -> Tuple[Optional[str], ...]:
    """The split of the parameter at dotted path ``name`` (``leaf`` is its
    array): ``(tp_axis, None)`` column-split, ``(None, tp_axis)`` row-split,
    ``(tp_axis,)`` a split bias, ``()`` replicated; deepv_tpu's
    ``PartitionSpec`` as a tuple."""
    keys = name.split(".")
    parent = keys[-2] if len(keys) >= 2 else ""
    ff = "ff" in keys or "ff_context" in keys
    if leaf.ndim >= 2 and keys[-1] == "weight":
        if parent in _COL or (parent == "proj" and ff):
            return (tp_axis, None)
        if parent in _ROW or (parent == "out" and ff):
            return (None, tp_axis)
    if keys[-1] == "bias" and len(keys) >= 2:
        if parent in _COL or (parent == "proj" and ff):
            return (tp_axis,)
    return ()


def _split_dim(spec) -> Optional[int]:
    """The dimension a spec splits, None when it is replicated."""
    return next((i for i, a in enumerate(spec) if a is not None), None)


def _shard(leaf, spec, index: int, n: int):
    """``leaf``'s slice ``index`` of ``n`` along its split dimension, as a
    contiguous copy (so the full leaf can be freed); the leaf itself when
    it is replicated."""
    dim = _split_dim(spec)
    if dim is None:
        return leaf
    if leaf.shape[dim] % n:
        raise ValueError(f"dimension {dim} of a {tuple(leaf.shape)} parameter does not split "
                         f"into {n} shards")
    step = leaf.shape[dim] // n
    if isinstance(leaf, torch.Tensor):
        return leaf.narrow(dim, index * step, step).clone(memory_format=torch.contiguous_format)
    return np.take(np.asarray(leaf), np.arange(index * step, (index + 1) * step), axis=dim)


def shard_mmdit_params(tree, mesh, tp_axis: str = "tp"):
    """This rank's slice of a full MMDiT parameter tree (deepv_tpu's layout,
    numpy or tensor leaves): each split leaf cut into ``mesh.shape[tp_axis]``
    equal parts along its split dimension, part ``mesh.index(tp_axis)``;
    the replicated leaves as they are. A ``models/mmdit.MMDiT`` built with
    the axis's group loads the result."""
    n, index = mesh.shape[tp_axis], mesh.index(tp_axis)

    def walk(node, prefix):
        if isinstance(node, dict):
            return {k: walk(v, f"{prefix}{k}.") for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [walk(v, f"{prefix}{i}.") for i, v in enumerate(node)]
        return _shard(node, mmdit_param_spec(prefix[:-1], node, tp_axis), index, n)

    return walk(tree, "")


def gather_mmdit_params(tree, group, keep: bool = True, tp_axis: str = "tp"):
    """The inverse of ``shard_mmdit_params``: the whole tree from each rank's
    slice of it. Every rank of ``group`` calls it with its own slice (tensor
    leaves, keyed like the parameters at any depth, so a tree of AdamW
    moments or a whole ``Trainer`` state gathers too); each split leaf is
    all-gathered over the group along its split dimension, in rank order,
    one leaf at a time, and copied to the CPU; a replicated leaf is copied
    as it is. The rank's own tensors are not changed. With ``keep=False``
    the rank takes part in every gather and returns None. Sharding the
    result again over the same group gives each rank its leaves bit for
    bit."""

    def walk(node, prefix):
        if isinstance(node, dict):
            return {k: walk(v, f"{prefix}{k}.") for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [walk(v, f"{prefix}{i}.") for i, v in enumerate(node)]
        dim = _split_dim(mmdit_param_spec(prefix[:-1], node, tp_axis))
        leaf = node.detach() if dim is None else comm.all_gather(node.detach(), dim, group)
        return leaf.to("cpu", copy=True) if keep else None

    out = walk(tree, "")
    return out if keep else None


def restore_split(group, tp_axis: str = "tp") -> Callable:
    """``split(name, leaf)`` for ``io/checkpoint.restore_pytree``: where
    this rank of ``group`` holds a slice of the whole leaf at dotted path
    ``name``, (its split dimension, this rank's index, the group's size);
    None where it holds the leaf whole."""
    n, index = dist.get_world_size(group), dist.get_rank(group)

    def split(name, leaf):
        dim = _split_dim(mmdit_param_spec(name, leaf, tp_axis))
        return None if dim is None else (dim, index, n)

    return split
