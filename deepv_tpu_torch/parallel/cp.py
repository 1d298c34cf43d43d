"""Context parallelism of the causal video VAE: the image height (spatial CP)
or time (temporal CP) split over the ranks of one mesh axis.

Counterpart of ``deepv_tpu/parallel/cp.py``, with its seven functions,
names, arguments and divisibility errors. deepv_tpu runs each as one
``shard_map`` over a global array; here every rank calls the function with
the whole input, computes its own slice through the VAE's ``cp_group`` /
``tp_group`` paths (``ops/causal_conv.py``: halo rows or frames from the
neighbours, ``models/vae.py``: group-norm statistics summed over the group,
the mid block's attention on gathered rows), and the slices are gathered,
so every rank returns the whole output, as deepv_tpu's global array.

**Spatial CP** (``cp_vae_*``, ``cp_dec_window``): requires pixel H
divisible by n_shards * 8, latent H by n_shards. Temporal chunking composes
with it: each rank carries the caches of its own rows, and a conv's cache
holds the halo-extended frames, so a carried cache already has the
neighbours' rows. ``cp_dec_window``'s cache is this rank's: pass it back
to the same rank's next call.

**Temporal CP** (``tcp_vae_*``): the first frame is a 1-frame init window
that every rank computes; the rest is split into equal runs of frames, and
each conv's temporal context is the previous rank's last two input frames,
rank 0 taking the init window's cache. Every run is at least 2 frames at
every temporal level: encoder 1 + n*k pixel frames with k >= 16 and
k % 8 == 0, decoder 1 + n*k latent frames with k >= 2.
"""

from __future__ import annotations

from typing import Callable

import torch

from ..config import VAEConfig
from ..models.vae import _dec_window, _enc_window, _split_windows, decoder_apply, encoder_apply
from . import comm


def _encoder(params):
    return getattr(params, "encoder", params)


def _decoder(params):
    return getattr(params, "decoder", params)


def _rows(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """This rank's slice of x's height (dim 3)."""
    h = x.shape[3] // mesh.shape[axis]
    return x.narrow(3, mesh.index(axis) * h, h)


def _check_pixel_h(cfg: VAEConfig, x: torch.Tensor, n: int) -> None:
    if x.shape[3] % (n * cfg.downsample_scale):
        raise ValueError(f"pixel H {x.shape[3]} must divide n_shards*{cfg.downsample_scale}")


def _check_latent_h(z: torch.Tensor, n: int) -> None:
    if z.shape[3] % n:
        raise ValueError(f"latent H {z.shape[3]} must divide n_shards")


def cp_vae_encode(cfg: VAEConfig, params, x: torch.Tensor, mesh, axis: str = "cp"
                  ) -> torch.Tensor:
    """Full (non-chunked) encode sharded over H. x: [b, 3, t, H, W]."""
    _check_pixel_h(cfg, x, mesh.shape[axis])
    group = mesh.group(axis)
    m, _ = encoder_apply(cfg, _encoder(params), _rows(x, mesh, axis), mode="full",
                         cp_group=group)
    return comm.all_gather(m, 3, group)


def cp_vae_decode(cfg: VAEConfig, params, z: torch.Tensor, mesh, axis: str = "cp"
                  ) -> torch.Tensor:
    """Full (non-chunked) decode sharded over latent H. z: [b, zc, t, h, w]."""
    _check_latent_h(z, mesh.shape[axis])
    group = mesh.group(axis)
    y, _ = decoder_apply(cfg, _decoder(params), _rows(z, mesh, axis), mode="full",
                         cp_group=group)
    return comm.all_gather(y, 3, group)


def _chunk_windows(cfg: VAEConfig, p, x: torch.Tensor, sizes, group,
                   window: Callable) -> torch.Tensor:
    """An init window, then cont windows of ``sizes`` frames, the caches
    carried; this rank's rows."""
    outs, cache, fid = [], None, 0
    for i, s in enumerate(sizes):
        out, cache = window(cfg, p, x[:, :, fid:fid + s], cache, "init" if i == 0 else "cont",
                            cp_group=group)
        outs.append(out)
        fid += s
    return torch.cat(outs, dim=2)


def cp_dec_window(cfg: VAEConfig, p, z: torch.Tensor, cache, mode: str, mesh,
                  axis: str = "tp"):
    """One decode window under spatial CP: ``models.vae._dec_window`` with
    the height split. Returns ``(pixels, new_cache)``: the whole window's
    pixels and this rank's caches (its rows, halo-extended), which the
    next window on this rank continues from."""
    _check_latent_h(z, mesh.shape[axis])
    group = mesh.group(axis)
    y, cache = _dec_window(cfg, _decoder(p), _rows(z, mesh, axis), cache, mode,
                           cp_group=group)
    return comm.all_gather(y, 3, group), cache


def cp_vae_encode_chunked(cfg: VAEConfig, params, x: torch.Tensor, mesh, axis: str = "cp",
                          window_size: int = 16) -> torch.Tensor:
    """Temporal-chunked encode sharded over H: each rank carries the conv
    caches of its rows."""
    _check_pixel_h(cfg, x, mesh.shape[axis])
    group = mesh.group(axis)
    m = _chunk_windows(cfg, _encoder(params), _rows(x, mesh, axis),
                       _split_windows(x.shape[2], window_size), group, _enc_window)
    return comm.all_gather(m, 3, group)


def cp_vae_decode_chunked(cfg: VAEConfig, params, z: torch.Tensor, mesh, axis: str = "cp",
                          window_size: int = 2) -> torch.Tensor:
    """Temporal-chunked decode sharded over latent H with carried caches."""
    _check_latent_h(z, mesh.shape[axis])
    group = mesh.group(axis)
    y = _chunk_windows(cfg, _decoder(params), _rows(z, mesh, axis),
                       _split_windows(z.shape[2], window_size), group, _dec_window)
    return comm.all_gather(y, 3, group)


def _frames(x: torch.Tensor, mesh, axis: str, k: int) -> torch.Tensor:
    """This rank's run of k frames after the first."""
    return x[:, :, 1 + mesh.index(axis) * k: 1 + (mesh.index(axis) + 1) * k]


def tcp_vae_encode(cfg: VAEConfig, params, x: torch.Tensor, mesh, axis: str = "tp"
                   ) -> torch.Tensor:
    """Encode sharded over TIME. x: [b, 3, 1 + n*k, H, W], k % 8 == 0, k >= 16."""
    pe, n = _encoder(params), mesh.shape[axis]
    k = (x.shape[2] - 1) // n
    if not (x.shape[2] == 1 + n * k and k >= 16 and k % 8 == 0):
        raise ValueError(f"temporal CP encode needs t = 1 + n*k with k>=16, k%8==0; "
                         f"got t={x.shape[2]}, n={n}")
    group = mesh.group(axis)
    m0, cache0 = _enc_window(cfg, pe, x[:, :, :1], None, "init")
    m, _ = encoder_apply(cfg, pe, _frames(x, mesh, axis, k), cache0, "cont", tp_group=group)
    return torch.cat([m0, comm.all_gather(m, 2, group)], dim=2)


def tcp_vae_decode(cfg: VAEConfig, params, z: torch.Tensor, mesh, axis: str = "tp"
                   ) -> torch.Tensor:
    """Decode sharded over TIME. z: [b, zc, 1 + n*k, h, w], k >= 2."""
    pd, n = _decoder(params), mesh.shape[axis]
    k = (z.shape[2] - 1) // n
    if not (z.shape[2] == 1 + n * k and k >= 2):
        raise ValueError(f"temporal CP decode needs t = 1 + n*k with k>=2; got t={z.shape[2]}, "
                         f"n={n}")
    group = mesh.group(axis)
    y0, cache0 = _dec_window(cfg, pd, z[:, :, :1], None, "init")
    y, _ = decoder_apply(cfg, pd, _frames(z, mesh, axis, k), cache0, "cont", tp_group=group)
    return torch.cat([y0, comm.all_gather(y, 2, group)], dim=2)
