"""Correlated 2x2 block noise for inter-stage renoising.

Counterpart of ``deepv_tpu/ops/block_noise.py``: every 2x2 spatial block is
drawn from N(0, (1+gamma) I - gamma J) as ``z @ L^T`` with ``L`` the Cholesky
factor of that covariance and ``z`` iid standard normal. ``z`` is passed in,
so a caller (or a test) decides where it comes from.
"""

from __future__ import annotations

import numpy as np
import torch


def block_cholesky(gamma: float) -> np.ndarray:
    """Cholesky factor of the 2x2-block covariance (host, float64)."""
    cov = (1.0 + gamma) * np.eye(4) - gamma * np.ones((4, 4))
    return np.linalg.cholesky(cov)


def block_noise_shape(shape):
    """Shape of the iid draw ``z`` behind block noise of ``shape``
    ``[b, c, t, h, w]``."""
    b, c, t, h, w = shape
    return (b, c, t, h // 2, w // 2, 4)


def block_noise_from_z(z: torch.Tensor, gamma: float,
                       dtype=torch.float32) -> torch.Tensor:
    """Correlated noise ``[b, c, t, h, w]`` from iid ``z``
    ``[b, c, t, h/2, w/2, 4]``, transformed in float32.

    Each block is ``z @ L^T`` summed pairwise, ``(p0 + p1) + (p2 + p3)``,
    every product and sum rounded to f32: a fixed order (the one XLA's CPU
    dot takes) rather than whatever a matmul library picks, so the f64
    rollout parity test can hold the port to the JAX package exactly."""
    b, c, t, h2, w2, _ = z.shape
    Lt = torch.as_tensor(block_cholesky(gamma).T, dtype=torch.float32, device=z.device)
    prods = z.to(torch.float32)[..., :, None] * Lt          # [..., k, j]
    blocks = (prods[..., 0, :] + prods[..., 1, :]) + (prods[..., 2, :] + prods[..., 3, :])
    blocks = blocks.reshape(b, c, t, h2, w2, 2, 2)
    noise = blocks.permute(0, 1, 2, 3, 5, 4, 6).reshape(b, c, t, 2 * h2, 2 * w2)
    return noise.to(dtype)
