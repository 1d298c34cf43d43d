"""Training loop with checkpoint and resume over the flow-matching objectives.

Counterpart of ``deepv_tpu/training/trainer.py``: the default
``objective="pyramid"`` trains the model the sampler runs
(``flow_matching.pyramid_flow_matching_loss``); each step draws
``(stage, unit_index)`` on the host from ``np.random.default_rng([sample_seed,
step])``, so a restored trainer replays the same curriculum.
``objective="single_clip"`` keeps the generic velocity-regression step.

The optimiser is ``torch.optim.AdamW`` with optax ``adamw``'s defaults
(betas (0.9, 0.999), eps 1e-8, decoupled decay scaled by the learning rate:
the same arithmetic as optax's update). Its state is created at
construction, zeros and step 0 as ``optimizer.init`` makes it, so a fresh
trainer is a restore template. Checkpoints are the port's own format
(``io/checkpoint.py``), restored in place.

A tensor-parallel model (``MMDiT(cfg, tp_group=...)``) checkpoints one
whole tree in the single-device format, as deepv_tpu's orbax checkpoint
holds each sharded array whole: ``save`` gathers the split parameters and
their AdamW moments over the tp group, and global rank 0 alone writes
them, so every rank of the process group calls ``save`` (``train`` does,
on every rank) and waits until the file is in place. ``restore`` reads a
whole tree into each rank's slices. Either trainer restores either
checkpoint, at any tp size that splits the heads.
"""

from __future__ import annotations

import os
import time
from typing import Callable, Dict, Iterable, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from ..config import MMDiTConfig, PipelineConfig
from ..io.checkpoint import load_metadata, restore_pytree, save_pytree
from ..io.weights import adamw_state_tree, set_adamw_state
from ..models.mmdit import MMDiT
from ..models.scheduler import FlowMatchSchedule
from ..parallel import comm
from ..parallel.tp import gather_mmdit_params, restore_split
from .flow_matching import make_pyramid_train_step, make_train_step


class Trainer:
    def __init__(self, mcfg: MMDiTConfig, model: MMDiT, learning_rate: float = 1e-4,
                 weight_decay: float = 0.01, ckpt_dir: Optional[str] = None,
                 objective: str = "pyramid", pcfg: Optional[PipelineConfig] = None,
                 sample_seed: int = 0, device=None):
        if objective not in ("pyramid", "single_clip"):
            raise ValueError(f"objective {objective!r}: expected 'pyramid' or 'single_clip'")
        self.device = torch.device("cuda" if device is None else device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("Trainer: no CUDA device; pass device='cpu' to train on the CPU")
        self.mcfg = mcfg
        # io/weights.params_from_numpy returns the model frozen for inference
        self.model = model.to(self.device).requires_grad_(True)
        self.optimizer = torch.optim.AdamW(self.model.parameters(), lr=learning_rate,
                                           betas=(0.9, 0.999), eps=1e-8,
                                           weight_decay=weight_decay)
        set_adamw_state(self.optimizer, self.model, 0)
        self.objective = objective
        self.sample_seed = sample_seed
        if objective == "pyramid":
            self.pcfg = pcfg or PipelineConfig()
            schedule = FlowMatchSchedule(self.pcfg.scheduler)
            self.step_fn = make_pyramid_train_step(self.model, self.pcfg, schedule,
                                                   self.optimizer)
        else:
            self.pcfg = pcfg
            self.step_fn = make_train_step(self.model, self.optimizer)
        self.ckpt_dir = ckpt_dir
        self.step = 0

    def _sample_stage_unit(self, batch: Dict):
        """Host-side (stage, unit_index) draw for this step's batch, seeded by
        (sample_seed, step); unit_index ranges over the units the batch's
        clip supports (unit 0 is the conditioning context)."""
        fpu = self.pcfg.frame_per_unit
        n_units = batch["latents"].shape[2] // fpu
        if n_units < 2:
            raise ValueError(
                f"pyramid objective needs clips of >= 2 latent units "
                f"({2 * fpu} frames at frame_per_unit={fpu}): unit 0 is the "
                f"conditioning context, the denoised unit is drawn from "
                f"units >= 1 — got latents with {batch['latents'].shape[2]} "
                f"frames ({n_units} unit)")
        rng = np.random.default_rng([self.sample_seed, self.step])
        stage = int(rng.integers(0, len(self.pcfg.stages)))
        unit_index = int(rng.integers(1, n_units))
        return stage, unit_index

    def train(self, batches: Iterable[Dict], noise, ckpt_every: int = 0, log_every: int = 10,
              log_fn: Callable[[str], None] = print) -> List[torch.Tensor]:
        """One step per batch, its random draws from ``noise`` (e.g.
        ``pipeline.TorchNoise(seed, device)``). Returns the losses."""
        losses = []
        for batch in batches:
            if self.objective == "pyramid":
                stage, unit_index = self._sample_stage_unit(batch)
                loss = self.step_fn(batch, noise, stage, unit_index)
            else:
                loss = self.step_fn(batch, noise)
            self.step += 1
            losses.append(loss)
            if log_every and self.step % log_every == 0:
                log_fn(f"[train] step {self.step} loss {float(loss):.4f}")
            if ckpt_every and self.ckpt_dir and self.step % ckpt_every == 0:
                self.save()
        return losses

    def state_tree(self) -> Dict:
        """The live training state: ``{"params": {name: parameter},
        "opt_state": {"count", "mu", "nu"}}`` (no copies but ``count``)."""
        return {"params": dict(self.model.named_parameters()),
                "opt_state": adamw_state_tree(self.optimizer, self.model)}

    def save(self, path: Optional[str] = None) -> str:
        """Write the training state to ``path`` (default: the step's
        directory under ``ckpt_dir``). On a tensor-parallel model every rank
        of the process group must call it: the whole tree is gathered onto
        global rank 0's CPU, which writes it, and the call returns on every
        rank once the file is in place (or raises on every rank if rank 0
        could not write it)."""
        path = path or os.path.join(self.ckpt_dir, f"step_{self.step:08d}")
        tree = self.state_tree()
        tree["params"] = {k: v.detach() for k, v in tree["params"].items()}
        metadata = {"step": self.step, "time": time.time(), "objective": self.objective,
                    "sample_seed": self.sample_seed}
        group = self.model.tp_group
        if group is None:
            save_pytree(path, tree, metadata=metadata)
            return path
        writer = dist.get_rank() == 0
        # only the writer's tp group gathers: another dp line's tree is the same
        if 0 in dist.get_process_group_ranks(group):
            tree = gather_mmdit_params(tree, group, keep=writer)
        error = None
        if writer:
            try:
                save_pytree(path, tree, metadata=metadata)
            except Exception as e:   # raised below, after the other ranks know
                error = e
        del tree
        failed = comm.all_reduce(torch.tensor([float(error is not None)], device=self.device),
                                 dist.group.WORLD, op="max")
        if error is not None:
            raise error
        if failed.item():
            raise RuntimeError(f"global rank 0 could not write the checkpoint {path}")
        return path

    def restore(self, path: str) -> None:
        # validate metadata BEFORE restoring any state: a mismatched
        # checkpoint must leave the trainer untouched, not half-restored
        meta = load_metadata(path)
        saved_obj = meta.get("objective")
        if saved_obj is not None and saved_obj != self.objective:
            raise ValueError(
                f"checkpoint {path} was trained with objective={saved_obj!r}; "
                f"this trainer is configured objective={self.objective!r} — "
                "restoring would silently continue with the wrong loss")
        group = self.model.tp_group
        tree = self.state_tree()
        state = restore_pytree(path, tree,
                               split=None if group is None else restore_split(group))
        count = state["opt_state"]["count"]
        for st in self.optimizer.state.values():
            st["step"].copy_(count)
        self.step = int(meta.get("step", self.step))
        # the (stage, unit) curriculum is derived from (sample_seed, step)
        self.sample_seed = int(meta.get("sample_seed", self.sample_seed))
