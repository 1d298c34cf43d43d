"""The port's PLY export against deepv_tpu's ``io/ply.py``, on the CPU.

``depth_edge`` must equal deepv_tpu's mask exactly (max-pools and one f32
add), also where depth is inf (disparity 0) or negative; ``backproject`` is
f32 arithmetic whose product sums may round in another order, so it is held
at rtol 1e-6; the host code (``interpolate_cameras``, ``write_ply``,
``save_ply_file`` with a seeded ``rng``) is a copy and must match exactly,
files byte for byte. ``save_ply`` draws an unseeded permutation in both
packages, so its files are compared as sorted point sets at
``downsample=1``: colours exact, coordinates at rtol 1e-6.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from deepv_tpu.io import ply as jax_ply

from deepv_tpu_torch.io import ply as port_ply

torch.set_num_threads(1)

RTOL = 1e-6


def depth_cases():
    rng = np.random.default_rng(0)
    step = np.ones((12, 16), np.float32)
    step[:, 7:] = 3.0
    disparity = rng.uniform(0.05, 1.0, (12, 16)).astype(np.float32)
    disparity[:4, :5] = 0.0                   # an inf block touching the border
    disparity[6, 8] = 0.0                     # an isolated inf
    with np.errstate(divide="ignore"):
        inf = 1.0 / disparity
    negative = rng.uniform(-2.0, 2.0, (12, 16)).astype(np.float32)
    return {"step": step, "inf": inf, "negative": negative}


@pytest.mark.parametrize("name", ["step", "inf", "negative"])
def test_depth_edge_matches_deepv_tpu(name):
    d = depth_cases()[name]
    ref = np.asarray(jax_ply.depth_edge(jnp.asarray(d), atol=0.1))
    got = port_ply.depth_edge(torch.from_numpy(d), atol=0.1).numpy()
    np.testing.assert_array_equal(got, ref)
    if name == "step":
        assert got[:, 6:8].all() and not got[:, :5].any() and not got[:, 9:].any()


def random_camera(rng):
    q, _ = np.linalg.qr(rng.standard_normal((3, 3)))
    c2w = np.eye(4)
    c2w[:3, :3] = q * np.sign(np.linalg.det(q))
    c2w[:3, 3] = rng.standard_normal(3)
    k = np.eye(4)
    k[0, 0], k[1, 1], k[0, 2], k[1, 2] = 20.0, 22.0, 8.0, 6.0
    return c2w, k


def test_backproject_matches_deepv_tpu():
    rng = np.random.default_rng(1)
    d = rng.uniform(0.5, 10.0, (12, 16)).astype(np.float32)
    c2w, k = random_camera(rng)
    ref = np.asarray(jax_ply.backproject(jnp.asarray(d), jnp.asarray(k, jnp.float32),
                                         jnp.asarray(c2w, jnp.float32)))
    got = port_ply.backproject(torch.from_numpy(d), torch.tensor(k, dtype=torch.float32),
                               torch.tensor(c2w, dtype=torch.float32))
    assert got.dtype == torch.float32 and tuple(got.shape) == ref.shape == (12, 16, 3)
    np.testing.assert_allclose(got.numpy(), ref, rtol=RTOL, atol=0)


def camera_path(n=4, seed=2):
    rng = np.random.default_rng(seed)
    cams = [random_camera(rng) for _ in range(n)]
    c2w = np.stack([c for c, _ in cams]).astype(np.float32)
    k = np.stack([k for _, k in cams]).astype(np.float32)
    k[:, 0, 0] += np.arange(n, dtype=np.float32)
    return c2w, k


def test_interpolate_cameras_equal():
    c2w, k = camera_path()
    ref = jax_ply.interpolate_cameras(c2w, k)
    got = port_ply.interpolate_cameras(c2w, k)
    assert len(got[0]) == len(ref[0]) == 9 + 2 * 8
    for a, b in zip(got, ref):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)


def points_and_colors(n, seed=3):
    rng = np.random.default_rng(seed)
    pts = rng.standard_normal((n, 3)).astype(np.float32) * 7
    cols = rng.integers(0, 256, (n, 3)).astype(np.uint8)
    return pts, cols


def test_write_ply_files_equal(tmp_path):
    pts, cols = points_and_colors(50)
    jax_ply.write_ply(str(tmp_path / "ref.ply"), pts, cols)
    port_ply.write_ply(str(tmp_path / "port.ply"), pts, cols)
    assert (tmp_path / "port.ply").read_bytes() == (tmp_path / "ref.ply").read_bytes()


def test_save_ply_file_with_a_seeded_rng_equal(tmp_path):
    rng = np.random.default_rng(4)
    pts = (rng.standard_normal((10, 12, 3)) * 15).astype(np.float32)
    pts[0, 0, 1] = np.nan
    pts[1, 2, 0] = np.inf
    image = rng.integers(0, 256, (10, 12, 3)).astype(np.uint8)
    mask = rng.uniform(size=(10, 12)) > 0.2
    n_ref = jax_ply.save_ply_file(pts, mask, image, str(tmp_path / "ref.ply"),
                                  rng=np.random.default_rng(5))
    n = port_ply.save_ply_file(pts, mask, image, str(tmp_path / "port.ply"),
                               rng=np.random.default_rng(5))
    assert n == n_ref > 0
    assert (tmp_path / "port.ply").read_bytes() == (tmp_path / "ref.ply").read_bytes()


def read_ply(path):
    """(points [n, 3] float32, colours [n, 3] int) of an ASCII PLY file,
    rows sorted by x, then y, then z."""
    with open(path) as f:
        lines = f.read().splitlines()
    start = lines.index("end_header") + 1
    n = int(next(l for l in lines if l.startswith("element vertex")).split()[-1])
    body = np.array([l.split() for l in lines[start:]], dtype=np.float64).reshape(-1, 6)
    assert body.shape[0] == n
    order = np.lexsort((body[:, 2], body[:, 1], body[:, 0]))
    body = body[order]
    return body[:, :3].astype(np.float32), body[:, 3:].astype(np.int64)


def rollout_output(t=89, h=12, w=16, seed=6):
    """A rollout-shaped output: frames in [-1, 1], a disparity with zeros,
    12 generated poses and intrinsics."""
    rng = np.random.default_rng(seed)
    img = rng.uniform(-1.1, 1.1, (1, 3, t, h, w)).astype(np.float32)
    disp = rng.uniform(0.04, 1.0, (1, 3, t, h, w)).astype(np.float32)
    disp[:, :, :, :3, :4] = 0.0
    c2w, k = camera_path(12, seed)
    return {"pred_img": img, "pred_disparity": disp, "trans3d": c2w[None], "trans2d": k[None]}


def test_save_ply_matches_deepv_tpu(tmp_path):
    output = rollout_output()
    ref = jax_ply.save_ply(output, str(tmp_path / "ref.ply"), downsample=1)
    got = port_ply.save_ply({k: torch.from_numpy(v) for k, v in output.items()},
                            str(tmp_path / "port.ply"), downsample=1, device="cpu")
    assert [p.replace("port", "ref") for p in got] == ref
    assert got == [str(tmp_path / f"port_frame{i}.ply") for i in range(0, 89, 8)]
    for a, b in zip(got, ref):
        pts, cols = read_ply(a)
        ref_pts, ref_cols = read_ply(b)
        assert len(pts) == len(ref_pts) > 0
        np.testing.assert_array_equal(cols, ref_cols)
        np.testing.assert_allclose(pts, ref_pts, rtol=RTOL, atol=0)


def test_save_ply_runs_on_the_card_by_default(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_ply.save_ply(rollout_output(t=9), str(tmp_path / "x.ply"))
