"""Raymap <-> camera-matrix codec.

Counterpart of ``deepv_tpu/raymap.py``: a camera (4x4 intrinsics
``trans2d`` and 4x4 camera-to-world ``trans3d``) is encoded as a 6-channel
raymap (3 ray-direction and 3 ray-origin channels) at latent resolution, and
a generated raymap is decoded back into poses and intrinsics from the ray
geometry.
"""

from __future__ import annotations

import torch

from .ops.resample import avg_pool2d


def raymap_from_camera(trans2d: torch.Tensor, trans3d: torch.Tensor,
                       depth_shape, vae_downsample: int = 1) -> torch.Tensor:
    """trans2d/trans3d [t, 4, 4]; depth_shape (H, W) in pixels. Returns
    [t, 6, H/ds, W/ds]."""
    H, W = depth_shape
    t = trans2d.shape[0]
    dt, dev = trans2d.dtype, trans2d.device
    fu = trans2d[:, 0, 0][:, None, None]
    fv = trans2d[:, 1, 1][:, None, None]
    cu = trans2d[:, 0, 2][:, None, None]
    cv = trans2d[:, 1, 2][:, None, None]
    u = torch.arange(W, dtype=dt, device=dev)[None, None, :]
    v = torch.arange(H, dtype=dt, device=dev)[None, :, None]
    x_cam = (u - cu) / fu
    y_cam = (v - cv) / fv
    ones = torch.ones((t, H, W), dtype=dt, device=dev)
    ray = torch.stack([x_cam * ones, y_cam * ones, ones, ones], dim=1)   # [t, 4, H, W]

    # rotate (translation zeroed) after average-pooling to latent resolution
    ray = avg_pool2d(ray, vae_downsample)
    rot = trans3d.clone()
    rot[:, :3, 3] = 0.0
    th, tw = ray.shape[-2:]
    ray_world = torch.einsum("tij,tjhw->tihw", rot, ray)[:, :3]
    ray_world = ray_world / torch.linalg.vector_norm(ray_world, dim=1, keepdim=True)
    ray_o = trans3d[:, :3, 3][:, :, None, None].expand(t, 3, th, tw)
    return torch.cat([ray_world, ray_o], dim=1)


def raymap_from_camera_batch(trans2d: torch.Tensor, trans3d: torch.Tensor,
                             depth_shape, vae_downsample: int = 1) -> torch.Tensor:
    """Batched encode: [b, t, 4, 4] -> [b, t, 6, h, w]."""
    return torch.stack([raymap_from_camera(t2, t3, depth_shape, vae_downsample)
                        for t2, t3 in zip(trans2d, trans3d)])


def raymap_to_camera(raymap: torch.Tensor, trans3d_scale_factor: float = 1.0,
                     append_first_reference: bool = False,
                     from_relative_to_absolute: bool = False,
                     vae_downsample: int = 8):
    """Decode a raymap [b, 6, t, h, w] into (camera_pose, intrinsic), both
    [b, t', 4, 4] in float32; ``t' = t+1`` with ``append_first_reference``."""
    raymap = raymap.to(torch.float32)
    b, _, t, h, w = raymap.shape
    dev = raymap.device

    # normalise ray directions by their projection onto the mean ray
    ref_ray = raymap[:, :3].mean(dim=(-1, -2))[..., None, None]
    ref_ray = ref_ray / torch.linalg.vector_norm(ref_ray, dim=1, keepdim=True)
    projection = (raymap[:, :3] * ref_ray).sum(dim=1, keepdim=True)
    ray_d = raymap[:, :3] / projection

    ray_o = torch.movedim(raymap[:, 3:], 1, -1) / trans3d_scale_factor   # [b, t, h, w, 3]
    ray_d = torch.movedim(ray_d, 1, -1)
    ray_o = torch.sign(ray_o) * ray_o.abs().square()                     # undo sqrt encoding

    location = ray_o.reshape(b, t, -1, 3).mean(dim=-2)
    image_location = (ray_o + ray_d).reshape(b, t, -1, 3).mean(dim=-2)
    focal = torch.linalg.vector_norm(image_location - location, dim=-1)
    z_dir = image_location - location

    # FoV from the left/right and top/bottom mean rays
    w_left = ray_d[:, :, :, :1, :].reshape(b, t, -1, 3).mean(dim=-2)
    w_right = ray_d[:, :, :, -1:, :].reshape(b, t, -1, 3).mean(dim=-2)
    wvec = w_right - w_left
    w_real = torch.linalg.vector_norm(torch.linalg.cross(wvec, z_dir), dim=-1) / (w - 1) * w

    h_up = ray_d[:, :, :1, :, :].reshape(b, t, -1, 3).mean(dim=-2)
    h_down = ray_d[:, :, -1:, :, :].reshape(b, t, -1, 3).mean(dim=-2)
    hvec = h_up - h_down
    h_real = torch.linalg.vector_norm(torch.linalg.cross(hvec, z_dir), dim=-1) / (h - 1) * h

    x_dir = w_right - w_left
    y_dir = torch.linalg.cross(z_dir, x_dir)
    x_dir = torch.linalg.cross(y_dir, z_dir)
    x_dir = x_dir / torch.linalg.vector_norm(x_dir, dim=-1, keepdim=True)
    y_dir = y_dir / torch.linalg.vector_norm(y_dir, dim=-1, keepdim=True)
    z_dirn = z_dir / torch.linalg.vector_norm(z_dir, dim=-1, keepdim=True)

    camera_pose = torch.zeros((b, t, 4, 4), dtype=torch.float32, device=dev)
    camera_pose[:, :, :3, 0] = x_dir
    camera_pose[:, :, :3, 1] = y_dir
    camera_pose[:, :, :3, 2] = z_dirn
    camera_pose[:, :, :3, 3] = location
    camera_pose[:, :, 3, 3] = 1.0

    intri_rescale = (w / w_real + h / h_real) / 2 * vae_downsample
    intrinsic = torch.zeros((b, t, 4, 4), dtype=torch.float32, device=dev)
    intrinsic[:, :, 0, 0] = focal * intri_rescale
    intrinsic[:, :, 1, 1] = focal * intri_rescale
    intrinsic[:, :, 0, 2] = w / 2 * vae_downsample
    intrinsic[:, :, 1, 2] = h / 2 * vae_downsample
    intrinsic[:, :, 2, 2] = 1.0
    intrinsic[:, :, 3, 3] = 1.0

    if append_first_reference:
        eye = torch.eye(4, dtype=torch.float32, device=dev).expand(b, 1, 4, 4)
        camera_pose = torch.cat([eye, camera_pose], dim=1)
        intrinsic = torch.cat([intrinsic[:, :1], intrinsic], dim=1)

    if from_relative_to_absolute:
        poses = [camera_pose[:, 0]]
        for i in range(1, camera_pose.shape[1]):
            poses.append(poses[-1] @ camera_pose[:, i])
        camera_pose = torch.stack(poses, dim=1)

    return camera_pose, intrinsic
