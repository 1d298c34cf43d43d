"""Pyramid flow-matching Euler schedule.

Counterpart of ``deepv_tpu/models/scheduler.py``: the schedule tables are
numpy, computed once from the config; the Euler update runs in float32 and
casts back to the velocity's dtype. The model predicts v = noise - data and
sampling integrates sigma from 1 to 0.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import numpy as np
import torch

from ..config import SchedulerConfig
from ..ops.basic import fma_f32


def _global_sigmas(num_train_timesteps: int, shift: float) -> np.ndarray:
    """Global sigma table with the SD3 shift transform."""
    t = np.linspace(1, num_train_timesteps, num_train_timesteps, dtype=np.float32)[::-1].copy()
    s = t / num_train_timesteps
    return shift * s / (1 + (shift - 1) * s)


@dataclasses.dataclass(frozen=True)
class StageSchedule:
    """Immutable per-stage inference schedule."""

    timesteps: np.ndarray   # [n] timestep values fed to the DiT embedding
    sigmas: np.ndarray      # [n+1] sigma ladder for the Euler update


class FlowMatchSchedule:
    """All schedule tables for pyramid flow matching; pure and immutable."""

    def __init__(self, config: SchedulerConfig = SchedulerConfig()):
        self.config = config
        N = config.num_train_timesteps
        sigmas = _global_sigmas(N, config.shift)
        timesteps = sigmas * N

        stages = config.stages
        stage_range = config.stage_range
        gamma = config.gamma

        self.ori_start_sigmas = {}
        self.start_sigmas = {}
        self.end_sigmas = {}
        stage_distance = []
        for i_s in range(stages):
            start_idx = max(int(stage_range[i_s] * N), 0)
            end_idx = min(int(stage_range[i_s + 1] * N), N)
            start_sigma = float(sigmas[start_idx])
            end_sigma = float(sigmas[end_idx]) if end_idx < N else 0.0
            self.ori_start_sigmas[i_s] = start_sigma
            if i_s != 0:
                # gamma-corrected jump point
                ori = 1 - start_sigma
                corrected = (1 / (math.sqrt(1 + 1 / gamma) * (1 - ori) + ori)) * ori
                start_sigma = 1 - corrected
            stage_distance.append(start_sigma - end_sigma)
            self.start_sigmas[i_s] = start_sigma
            self.end_sigmas[i_s] = end_sigma

        tot = sum(stage_distance)
        self.timestep_ratios = {}
        for i_s in range(stages):
            start_ratio = 0.0 if i_s == 0 else sum(stage_distance[:i_s]) / tot
            end_ratio = 1.0 if i_s == stages - 1 else sum(stage_distance[: i_s + 1]) / tot
            self.timestep_ratios[i_s] = (start_ratio, end_ratio)

        self.timesteps_per_stage = {}
        self.sigmas_per_stage = {}
        for i_s in range(stages):
            r0, r1 = self.timestep_ratios[i_s]
            t_max = timesteps[int(r0 * N)]
            t_min = timesteps[min(int(r1 * N), N - 1)]
            self.timesteps_per_stage[i_s] = np.linspace(t_max, t_min, N + 1)[:-1]
            self.sigmas_per_stage[i_s] = np.linspace(1.0, 0.0, N + 1)[:-1]

        self.sigma_min = float(sigmas[-1])
        self.sigma_max = float(sigmas[0])

    def stage_schedule(self, num_inference_steps: int, stage_index: int) -> StageSchedule:
        """Per-stage inference schedule: ``timesteps`` [n] and ``sigmas``
        [n+1] with the trailing 0 appended, both float32."""
        tbl = self.timesteps_per_stage[stage_index]
        timesteps = np.linspace(float(tbl[0]), float(tbl[-1]), num_inference_steps)
        stbl = self.sigmas_per_stage[stage_index]
        ratios = np.linspace(float(stbl[0]), float(stbl[-1]), num_inference_steps)
        sigmas = np.concatenate([ratios, [0.0]])
        return StageSchedule(timesteps=timesteps.astype(np.float32), sigmas=sigmas.astype(np.float32))

    def renoise_coeffs(self, stage_index: int) -> Tuple[float, float]:
        """(alpha, beta) for inter-stage renoising ``alpha*x + beta*noise``."""
        assert stage_index > 0
        gamma = self.config.gamma
        ori_sigma = 1 - self.ori_start_sigmas[stage_index]
        alpha = 1 / (math.sqrt(1 + 1 / gamma) * (1 - ori_sigma) + ori_sigma)
        beta = alpha * (1 - ori_sigma) / math.sqrt(gamma)
        return alpha, beta


def euler_step(sample: torch.Tensor, velocity: torch.Tensor, dsigma) -> torch.Tensor:
    """One flow-matching Euler step ``sample + dsigma * velocity`` as one
    f32 fused multiply-add, cast to the velocity's dtype."""
    dsigma = torch.as_tensor(dsigma, dtype=torch.float32, device=velocity.device)
    return fma_f32(dsigma, velocity, sample).to(velocity.dtype)
