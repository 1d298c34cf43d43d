"""Flow-matching training for the MMDiT: plain and pyramid-aware objectives.

Counterpart of ``deepv_tpu/training/flow_matching.py``, with the same
formulas:

  - ``flow_matching_loss``: velocity regression v = noise - data on a
    single clip at x_sigma = sigma * noise + (1 - sigma) * data;
  - ``pyramid_flow_matching_loss``: the state the sampler visits at one
    (stage, unit_index): the packed past-condition layout of inference
    (``pipeline.padded_conditions``) plus the noisy current unit on the
    segment x(r) = r * x_start + (1 - r) * x_end between the stage's
    renoised start point and its data endpoint corrupted to the stage's end
    sigma, with v_target = x_start - x_end and the stage's global timestep
    range.

Every random draw goes through one noise source (``pipeline.TorchNoise`` by
default, a seeded ``torch.Generator`` on the device), named after
deepv_tpu's keys: "noise" and "sigma" (single clip); "end", "prev", "block"
(the iid z behind the block noise) and "ratio" (pyramid). A Gaussian draw
is made in ``promote_types(latents.dtype, float32)`` (deepv_tpu's default
float), z and the uniform draws in float32, as deepv_tpu draws them.

A train step is a plain function: the loss, ``backward()``, every
parameter given a gradient (zeros where none arrived: ``jax.value_and_grad``
gives an unused leaf a zero gradient and optax's AdamW still decays it and
advances its moments, while ``torch.optim.AdamW`` skips a parameter whose
``.grad`` is None), then ``optimizer.step()``.

Over a mesh (``mesh`` with a ``dp`` axis, one process per rank; deepv_tpu's
step sharded DP x TP by GSPMD, ``deepv_tpu/parallel/dryrun.py``): the model
is this rank's tensor-parallel share (``MMDiT(cfg, tp_group=...)`` on
``parallel/tp.shard_mmdit_params``, whose forward sums the split products
and gradients over ``tp``), and each rank takes its ``dp`` slice of the
batch and of the random draws (``BatchSliceNoise``). The step averages the
gradients over the ``dp`` group, the sum divided by its size, before
AdamW, and returns the global mean loss: with equal slices, the mean over
the global batch that deepv_tpu's step computes. AdamW then makes the same
update on every rank of a ``dp`` line, which end the step with the same bits.
"""

from __future__ import annotations

from typing import Callable, Dict

import torch
import torch.distributed as dist
from torch import nn

from ..config import PipelineConfig
from ..models.mmdit import MMDiT, mmdit_forward
from ..models.scheduler import FlowMatchSchedule
from ..ops.block_noise import block_noise_from_z, block_noise_shape
from ..ops.resample import up2x_nearest
from ..parallel import comm
from ..pipeline import _pyramid_list, padded_conditions


class BatchSliceNoise:
    """The draws of the global batch, of which this data-parallel rank
    takes its slice: each draw is made at the global batch (``count`` times
    the rank's, along dim 0) from ``noise`` and rows ``index * b`` to
    ``(index + 1) * b`` are returned, so the ranks of a ``dp`` axis together
    use the draws of one single-device step."""

    def __init__(self, noise, index: int, count: int):
        self.noise, self.index, self.count = noise, index, count

    def _slice(self, x: torch.Tensor, b: int) -> torch.Tensor:
        return x[self.index * b:(self.index + 1) * b]

    def normal(self, kind: str, shape, dtype) -> torch.Tensor:
        shape = tuple(shape)
        return self._slice(self.noise.normal(kind, (shape[0] * self.count,) + shape[1:], dtype),
                           shape[0])

    def uniform(self, kind: str, shape, low: float, high: float,
                dtype=torch.float32) -> torch.Tensor:
        shape = tuple(shape)
        return self._slice(self.noise.uniform(kind, (shape[0] * self.count,) + shape[1:], low,
                                              high, dtype), shape[0])


def flow_matching_loss(model: MMDiT, batch: Dict, noise) -> torch.Tensor:
    """MSE between predicted and true velocity on x_sigma = s*x0 + (1-s)*x1,
    in float32."""
    x1 = batch["latents"]                       # clean latents [b, C, t, h, w]
    b = x1.shape[0]
    x0 = noise.normal("noise", x1.shape, x1.dtype)
    sigma = noise.uniform("sigma", (b,), 1e-4, 1.0 - 1e-4)
    s = sigma.reshape(b, 1, 1, 1, 1).to(x1.dtype)
    xs = s * x0 + (1 - s) * x1
    v_target = (x0 - x1).to(torch.float32)
    v = mmdit_forward(model, [xs], batch["text_embeds"], batch["text_mask"], batch["pooled"],
                      timestep=sigma * 1000.0)
    return torch.mean(torch.square(v.to(torch.float32) - v_target))


def pyramid_flow_matching_loss(model: MMDiT, pcfg: PipelineConfig,
                               schedule: FlowMatchSchedule, batch: Dict, noise,
                               stage: int, unit_index: int,
                               firstframe_mask: bool = True) -> torch.Tensor:
    """Pyramid-flow velocity loss at one (stage, unit_index).

    batch["latents"]: clean packed latents [b, C, T, H, W] at full latent
    resolution with T >= (unit_index + 1) * frame_per_unit frames; the
    past-condition clips are teacher-forced from the clean frames through
    the layout inference runs."""
    lat = batch["latents"]
    fpu = pcfg.frame_per_unit
    n_stages = len(pcfg.stages)
    if not 0 <= stage < n_stages:
        raise ValueError(f"stage {stage} outside [0, {n_stages})")
    ctx_frames = unit_index * fpu
    cur = lat[:, :, ctx_frames:ctx_frames + fpu]
    b = lat.shape[0]
    dev = lat.device
    ft = torch.promote_types(lat.dtype, torch.float32)

    clean = _pyramid_list(lat[:, :, :ctx_frames], n_stages - 1)
    conditions, times, valid = padded_conditions(
        pcfg, clean, unit_index, firstframe_mask, num_rows=1)[stage]

    cur_pyr = _pyramid_list(cur, n_stages - 1)
    f32 = lambda x: torch.tensor(x, dtype=torch.float32, device=dev)
    sigma_end = f32(schedule.end_sigmas[stage])
    x1 = cur_pyr[stage].to(torch.float32)
    x_end = (1 - sigma_end) * x1 + sigma_end * noise.normal("end", x1.shape, ft)
    if stage == 0:
        x_start = noise.normal("prev", x1.shape, ft)
    else:
        sigma_prev_end = f32(schedule.ori_start_sigmas[stage])
        x1_prev = cur_pyr[stage - 1].to(torch.float32)
        x_end_prev = ((1 - sigma_prev_end) * x1_prev
                      + sigma_prev_end * noise.normal("prev", x1_prev.shape, ft))
        alpha, beta = schedule.renoise_coeffs(stage)
        z = noise.normal("block", block_noise_shape(x1.shape), torch.float32)
        x_start = (alpha * up2x_nearest(x_end_prev)
                   + beta * block_noise_from_z(z, pcfg.scheduler.gamma))

    ratio = noise.uniform("ratio", (b,), 0.0, 1.0)
    r = ratio.reshape(b, 1, 1, 1, 1)
    x = r * x_start + (1 - r) * x_end
    v_target = x_start - x_end

    tbl = schedule.timesteps_per_stage[stage]
    t_max, t_min = float(tbl[0]), float(tbl[-1])
    timestep = ratio * t_max + (1 - ratio) * t_min

    clips = list(conditions) + [x.to(lat.dtype)]
    v = mmdit_forward(model, clips, batch["text_embeds"], batch["text_mask"], batch["pooled"],
                      timestep=timestep, frame_times=list(times), frame_valid=list(valid))
    return torch.mean(torch.square(v.to(torch.float32) - v_target))


def optimizer_step(model: nn.Module, optimizer: torch.optim.Optimizer,
                   loss_fn: Callable[[], torch.Tensor], dp_group=None) -> torch.Tensor:
    """One step: the loss, its gradients, zeros for every parameter no
    gradient reached, the optimizer's update. Returns the loss, detached.
    With ``dp_group`` the gradients and the loss are averaged over its ranks
    first (the sum divided by the group's size)."""
    optimizer.zero_grad(set_to_none=True)
    loss = loss_fn()
    loss.backward()
    for p in model.parameters():
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    loss = loss.detach()
    if dp_group is not None:
        n = dist.get_world_size(dp_group)
        for p in model.parameters():
            p.grad = comm.all_reduce(p.grad, dp_group).div_(n)
        loss = comm.all_reduce(loss.clone(), dp_group) / n
    optimizer.step()
    return loss


def _dp_group(mesh, dp_axis: str):
    """The ``dp`` axis's group of ``mesh``, or None (no mesh)."""
    if mesh is None:
        return None
    if dp_axis not in mesh.axis_names:
        raise ValueError(f"mesh has axes {mesh.axis_names}, expected {dp_axis!r}")
    return mesh.group(dp_axis)


def make_train_step(model: MMDiT, optimizer: torch.optim.Optimizer, mesh=None,
                    dp_axis: str = "dp"):
    """Returns (batch, noise) -> loss, a single-clip step that updates
    ``model`` and ``optimizer`` in place. With ``mesh`` the caller passes this
    rank's ``dp`` slice of the batch and of the draws (module docstring)."""
    dp_group = _dp_group(mesh, dp_axis)

    def train_step(batch: Dict, noise) -> torch.Tensor:
        return optimizer_step(model, optimizer, lambda: flow_matching_loss(model, batch, noise),
                              dp_group)

    return train_step


def make_pyramid_train_step(model: MMDiT, pcfg: PipelineConfig, schedule: FlowMatchSchedule,
                            optimizer: torch.optim.Optimizer, mesh=None, dp_axis: str = "dp"):
    """Returns (batch, noise, stage, unit_index) -> loss, a pyramid step that
    updates ``model`` and ``optimizer`` in place. With ``mesh`` the caller
    passes this rank's ``dp`` slice of the batch and of the draws."""
    dp_group = _dp_group(mesh, dp_axis)

    def train_step(batch: Dict, noise, stage: int, unit_index: int) -> torch.Tensor:
        return optimizer_step(model, optimizer, lambda: pyramid_flow_matching_loss(
            model, pcfg, schedule, batch, noise, stage, unit_index), dp_group)

    return train_step
