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
"""

from __future__ import annotations

from typing import Callable, Dict

import torch
from torch import nn

from ..config import PipelineConfig
from ..models.mmdit import MMDiT, mmdit_forward
from ..models.scheduler import FlowMatchSchedule
from ..ops.block_noise import block_noise_from_z, block_noise_shape
from ..ops.resample import up2x_nearest
from ..pipeline import _pyramid_list, padded_conditions


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
                   loss_fn: Callable[[], torch.Tensor]) -> torch.Tensor:
    """One step: the loss, its gradients, zeros for every parameter no
    gradient reached, the optimizer's update. Returns the loss, detached."""
    optimizer.zero_grad(set_to_none=True)
    loss = loss_fn()
    loss.backward()
    for p in model.parameters():
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    optimizer.step()
    return loss.detach()


def make_train_step(model: MMDiT, optimizer: torch.optim.Optimizer):
    """Returns (batch, noise) -> loss, a single-clip step that updates
    ``model`` and ``optimizer`` in place."""

    def train_step(batch: Dict, noise) -> torch.Tensor:
        return optimizer_step(model, optimizer, lambda: flow_matching_loss(model, batch, noise))

    return train_step


def make_pyramid_train_step(model: MMDiT, pcfg: PipelineConfig, schedule: FlowMatchSchedule,
                            optimizer: torch.optim.Optimizer):
    """Returns (batch, noise, stage, unit_index) -> loss, a pyramid step that
    updates ``model`` and ``optimizer`` in place."""

    def train_step(batch: Dict, noise, stage: int, unit_index: int) -> torch.Tensor:
        return optimizer_step(model, optimizer, lambda: pyramid_flow_matching_loss(
            model, pcfg, schedule, batch, noise, stage, unit_index))

    return train_step
