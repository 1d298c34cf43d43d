"""The port's tensor-parallel split of the MMDiT (``parallel/tp.py``) against
deepv_tpu's.

On every leaf of a tiny MMDiT tree (``MMDiTConfig.tiny()``, the structure of
deepv_tpu's init) the port's ``mmdit_param_spec`` equals deepv_tpu's
``PartitionSpec`` as a tuple, and the shards that ``shard_mmdit_params``
cuts for the ranks of a 1-, 2- and 4-rank axis, put back together along
each leaf's split dimension, equal the tree bit for bit, for numpy and for
tensor leaves. ``shard_mmdit_params`` reads only the axis size and this
rank's index, so each rank's ``Mesh`` is built here without a process group.
"""

import numpy as np
import pytest
import torch

import jax
from deepv_tpu.parallel.tp import mmdit_param_spec as jax_spec

from deepv_tpu_torch.config import MMDiTConfig
from deepv_tpu_torch.io.weights import flatten_tree, random_mmdit_params
from deepv_tpu_torch.parallel.mesh import Mesh
from deepv_tpu_torch.parallel.tp import mmdit_param_spec, shard_mmdit_params

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def tree():
    t = random_mmdit_params(MMDiTConfig.tiny(), dtype=torch.float32, seed=0, device="cpu")
    return jax.tree.map(lambda a: a.numpy(), t)


def rank_mesh(n, index):
    return Mesh(("tp",), (n,), index, torch.device("cpu"), {})


def test_split_table_matches_deepv_tpu(tree):
    ref = {".".join(str(getattr(k, "key", getattr(k, "idx", None))) for k in path):
           tuple(jax_spec(path, leaf))
           for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}
    flat = flatten_tree(tree)
    assert set(ref) == set(flat)
    kinds = {}
    for name, leaf in flat.items():
        got = mmdit_param_spec(name, leaf)
        assert got == ref[name], (name, got, ref[name])
        kinds[got] = kinds.get(got, 0) + 1
    # every kind of split occurs: column weights and biases, row weights,
    # replicated leaves
    assert set(kinds) == {("tp", None), ("tp",), (None, "tp"), ()}, kinds


@pytest.mark.parametrize("n", [1, 2, 4])
@pytest.mark.parametrize("leaves", ["numpy", "tensor"])
def test_shards_put_back_together_equal_the_tree(tree, n, leaves):
    if leaves == "tensor":
        tree = jax.tree.map(torch.from_numpy, tree)
    flat = flatten_tree(tree)
    shards = [flatten_tree(shard_mmdit_params(tree, rank_mesh(n, r))) for r in range(n)]
    cat = (lambda parts, d: torch.cat(parts, dim=d)) if leaves == "tensor" else (
        lambda parts, d: np.concatenate(parts, axis=d))
    for name, leaf in flat.items():
        spec = mmdit_param_spec(name, leaf)
        if not spec:
            assert all(s[name] is leaf for s in shards), name
            continue
        dim = spec.index("tp")
        assert all(s[name].shape[dim] == leaf.shape[dim] // n for s in shards), name
        whole = cat([s[name] for s in shards], dim)
        assert np.array_equal(np.asarray(whole), np.asarray(leaf)), name


def test_shard_refuses_an_uneven_split(tree):
    with pytest.raises(ValueError, match="does not split into 3 shards"):
        shard_mmdit_params(tree, rank_mesh(3, 0))
