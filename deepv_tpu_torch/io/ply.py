"""Point-cloud export: one PLY file per ``frame_stride``-th frame.

Counterpart of ``deepv_tpu/io/ply.py``. The per-pixel work, the depth-edge
mask (a 3x3 max-pool of the depth and of its negation) and the
back-projection of depth to world points, runs as plain torch ops on the
pipeline's device; the host interpolates the cameras (a slerp per pair of
generated poses) and writes ASCII PLY (x y z as float, r g b as uchar).
"""

from __future__ import annotations

import contextlib
from typing import Dict, List

import numpy as np
import torch
import torch.nn.functional as F


def depth_edge(depth: torch.Tensor, atol: float = 0.1, kernel_size: int = 3) -> torch.Tensor:
    """Edge mask of a depth map [H, W]: max-pool(d) + max-pool(-d) > atol
    over ``kernel_size`` windows. Each pool starts from the dtype's lowest
    finite value, which also pads the border: a window of -inf pools to
    that value, not to -inf, so inf depth (disparity 0) is an edge
    everywhere, not NaN."""
    pad = kernel_size // 2
    lowest = torch.finfo(depth.dtype).min

    def pool(d):
        d = F.pad(d[None, None], (pad, pad, pad, pad), value=lowest)
        return F.max_pool2d(d, kernel_size, stride=1)[0, 0].clamp_min(lowest)

    return (pool(depth) + pool(-depth)) > atol


@contextlib.contextmanager
def _ieee_f32_matmul():
    """float32 products in full precision (no TF32) inside the block."""
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved


def backproject(depth: torch.Tensor, intrinsics: torch.Tensor,
                camera_pose: torch.Tensor) -> torch.Tensor:
    """depth [H, W] + K [>=3, >=3] + c2w [4, 4] -> world points [H, W, 3],
    in depth's dtype on its device."""
    H, W = depth.shape
    fu, fv = intrinsics[0, 0], intrinsics[1, 1]
    cu, cv = intrinsics[0, 2], intrinsics[1, 2]
    u = torch.arange(W, dtype=depth.dtype, device=depth.device)[None, :]
    v = torch.arange(H, dtype=depth.dtype, device=depth.device)[:, None]
    x = (u - cu) * depth / fu
    y = (v - cv) * depth / fv
    pts_cam = torch.stack([x, y, depth], dim=-1)
    R = camera_pose[:3, :3]
    t = camera_pose[:3, 3]
    with _ieee_f32_matmul():
        return torch.einsum("ik,hwk->hwi", R, pts_cam) + t


def interpolate_cameras(c2w_list: np.ndarray, k_list: np.ndarray, k: int = 9):
    """Per-pair slerp rotation + lerp translation/intrinsics (ref run.py:110-141)."""
    from scipy.spatial.transform import Rotation, Slerp

    out_c2w: List[np.ndarray] = []
    out_k: List[np.ndarray] = []
    for i in range(len(c2w_list) - 1):
        c2w_a, c2w_b = c2w_list[i], c2w_list[i + 1]
        k_a, k_b = k_list[i], k_list[i + 1]
        slerp = Slerp([0, 1], Rotation.from_matrix([c2w_a[:3, :3], c2w_b[:3, :3]]))
        times = np.linspace(0, 1, k)
        rots = slerp(times)
        for j in range(k):
            if i > 0 and j == 0:
                continue
            a = times[j]
            c2w = np.eye(4)
            c2w[:3, :3] = rots[j].as_matrix()
            c2w[:3, 3] = (1 - a) * c2w_a[:3, 3] + a * c2w_b[:3, 3]
            out_c2w.append(c2w)
            out_k.append((1 - a) * k_a + a * k_b)
    return out_c2w, out_k


def write_ply(path: str, points: np.ndarray, colors: np.ndarray) -> None:
    """Minimal ASCII PLY writer (x y z + uchar rgb), matching the reference's
    output schema (ref run.py:175-182)."""
    n = points.shape[0]
    header = (
        "ply\nformat ascii 1.0\n"
        f"element vertex {n}\n"
        "property float x\nproperty float y\nproperty float z\n"
        "property uchar red\nproperty uchar green\nproperty uchar blue\n"
        "end_header\n"
    )
    body = np.concatenate([points.astype(np.float32),
                           colors.astype(np.int32)], axis=1)
    with open(path, "w") as f:
        f.write(header)
        # %.9g round-trips float32 exactly; world coordinates after pose
        # chaining carry meaningful digits past 6
        np.savetxt(f, body, fmt="%.9g %.9g %.9g %d %d %d")


def save_ply_file(points: np.ndarray, mask, image: np.ndarray, output_file: str,
                  downsample: int = 10, far_clip: float = 20.0,
                  rng: np.random.Generator | None = None) -> int:
    """Filter + downsample + write one frame's point cloud (ref run.py:143-183).
    Returns the number of points written."""
    h, w, _ = points.shape
    image = image[:h, :w]
    if mask is not None:
        pts = points[mask].reshape(-1, 3)
        cols = image[mask].reshape(-1, 3)
    else:
        pts = points.reshape(-1, 3)
        cols = image.reshape(-1, 3)

    finite = ~(np.isnan(pts).any(-1) | np.isinf(pts).any(-1))
    pts, cols = pts[finite], cols[finite]
    near = ~(pts > far_clip).any(-1)
    pts, cols = pts[near], cols[near]

    rng = rng or np.random.default_rng()
    choose = rng.permutation(pts.shape[0])[: pts.shape[0] // downsample]
    pts, cols = pts[choose], cols[choose]
    write_ply(output_file, pts, cols)
    print(f"[info] save ply at {output_file}, have {len(pts)} points.")
    return len(pts)


def _host_f32(a) -> np.ndarray:
    """An output array (a tensor on any device, or numpy) as float32 numpy."""
    if isinstance(a, torch.Tensor):
        return a.detach().to("cpu", torch.float32).numpy()
    return np.asarray(a, np.float32)


def save_ply(output: Dict, output_path: str, frame_stride: int = 8,
             downsample: int = 10, device=None) -> List[str]:
    """Export every ``frame_stride``-th frame of a rollout's output as a PLY
    point cloud (ref run.py:350-372), as ``output_path`` with ``.ply``
    replaced by ``_frame{i}.ply``. The edge masks and back-projection run
    on ``device`` (default "cuda"; raises when no GPU is present, pass
    "cpu" explicitly to run on the CPU). Returns the paths written."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' to run on the CPU")
    video = _host_f32(output["pred_img"])[0].transpose(1, 2, 3, 0)
    frames = (np.clip((video + 1) / 2, 0, 1) * 255).astype(np.uint8)

    disparity = _host_f32(output["pred_disparity"])[0].mean(axis=0)
    with np.errstate(divide="ignore"):
        depth = 1.0 / disparity    # ref run.py:359 (no epsilon)

    trans3d = _host_f32(output["trans3d"])[0]
    trans2d = _host_f32(output["trans2d"])[0]
    c2w_list, k_list = interpolate_cameras(trans3d, trans2d)

    written = []
    for i, (frame, d, c2w, K) in enumerate(zip(frames, depth, c2w_list, k_list)):
        if i % frame_stride != 0:
            continue
        dt = torch.from_numpy(d).to(device)
        mask = (dt < torch.inf).cpu().numpy()
        edge = depth_edge(dt, atol=0.1).cpu().numpy()
        conf = (~edge) | mask                      # ref run.py:369
        conf = conf | (d > 0.0)                    # ref run.py:370-371 valid_mask
        pts = backproject(dt, torch.as_tensor(K, dtype=torch.float32, device=device),
                          torch.as_tensor(c2w, dtype=torch.float32, device=device))
        path = output_path.replace(".ply", f"_frame{i}.ply")
        save_ply_file(pts.cpu().numpy(), conf, frame, path, downsample=downsample)
        written.append(path)
    return written
