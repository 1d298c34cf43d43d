"""The port's mesh functions on 4 gloo ranks on the CPU against deepv_tpu's
on a 4-device virtual CPU mesh, in float64.

One ``parallel/launch.spawn`` of 4 processes (``torch_port_mesh_worker.
parallel_rank``, torch and the port only) runs, on every rank: the
tensor-parallel MMDiT forward (a tiny model of 4 heads, one a rank, on a
packed layout with history, frame times and padding frames), the seven
functions of ``parallel/cp.py`` on ``VAEConfig.tiny()`` at
tests/test_parallel.py's shapes (``cp_dec_window`` over two carried
windows; ``tcp_vae_encode`` on a 2-rank axis of a 2 x 2 mesh, as deepv_tpu's
test runs it on 2 devices), and the refusals. With 4 ranks the interior
ranks take halos from both neighbours. The references run in this process:
deepv_tpu's ``mmdit_forward`` on ``shard_mmdit_params`` and deepv_tpu's
``parallel/cp.py`` functions, on the same float64 parameters and inputs.

Tolerance: atol 1e-9, on values up to ~1.3 (the encoders' moments up to
~0.03). Both sides are float64 and compute the same function; they differ
only in summation order (the row-split partial products and the
group-norm statistics summed over the ranks, XLA's and PyTorch's reduction
orders): at most 6e-15 here. Every rank returns the same bits.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from deepv_tpu.config import MMDiTConfig, VAEConfig
from deepv_tpu.models.mmdit import mmdit_forward
from deepv_tpu.parallel import cp as jax_cp
from deepv_tpu.parallel.mesh import make_mesh
from deepv_tpu.parallel.tp import shard_mmdit_params

from deepv_tpu_torch.config import MMDiTConfig as TMMDiTConfig, VAEConfig as TVAEConfig
from deepv_tpu_torch.io.weights import flatten_tree, random_mmdit_params, random_params
from deepv_tpu_torch.models.mmdit import MMDiT, mmdit_forward as port_forward
from deepv_tpu_torch.io.weights import params_from_numpy
from deepv_tpu_torch.parallel.launch import spawn

import torch_port_mesh_worker as worker
from test_torch_port_mmdit import correctly_rounded

torch.set_num_threads(1)

RANKS = 4
ATOL = 1e-9
MCFG = dict(sample_size=16, patch_size=2, in_channels=14, num_layers=2,
            attention_head_dim=8, num_attention_heads=4, caption_projection_dim=32,
            pooled_projection_dim=16, pos_embed_max_size=32, joint_attention_dim=24)
CP_FUNCTIONS = ("cp_vae_encode", "cp_vae_decode", "cp_vae_encode_chunked",
                "cp_vae_decode_chunked", "tcp_vae_decode", "tcp_vae_encode")


def forward_inputs(rng):
    """A packed denoise call: an old clip of 3 frames (the first one padding),
    the current unit, 2 CFG rows with a masked text tail and a history
    frame for the second row."""
    return dict(
        clips=[rng.standard_normal((2, 14, 3, 8, 8)), rng.standard_normal((2, 14, 1, 8, 8))],
        text=rng.standard_normal((2, 7, 24)), mask=np.array([[1] * 5 + [0] * 2] * 2, np.int32),
        pooled=rng.standard_normal((2, 16)), timestep=np.array([500.0, 700.0], np.float32),
        history=rng.standard_normal((2, 14, 1, 8, 8)),
        history_mask=np.array([[0] * 4, [1] * 4], np.int32),
        frame_times=[np.array([-1.0, 0.0, 1.0], np.float32), np.array([2.0], np.float32)],
        frame_valid=[np.array([0, 1, 1], np.int32), np.array([1], np.int32)])


def vae_inputs(rng):
    zc = 4      # VAEConfig.tiny().encoder_out_channels
    return dict(
        encode=rng.standard_normal((1, 3, 9, 64, 32)),
        decode=rng.standard_normal((1, zc, 2, 8, 4)),
        encode_chunked=rng.standard_normal((1, 3, 17, 64, 32)),
        decode_chunked=rng.standard_normal((1, zc, 5, 8, 4)),
        tcp_decode=rng.standard_normal((1, zc, 9, 8, 4)),
        tcp_encode=rng.standard_normal((1, 3, 33, 32, 32)),
        window0=rng.standard_normal((1, zc, 1, 8, 4)),
        window1=rng.standard_normal((1, zc, 2, 8, 4)),
        bad_pixels=np.zeros((1, 3, 9, 40, 32)),
        bad_latents=np.zeros((1, zc, 2, 6, 4)),
        bad_frames=np.zeros((1, zc, 8, 8, 4)))


def _jax_forward(params, f, mesh=None):
    j = jnp.asarray
    return mmdit_forward(MMDiTConfig(**MCFG), params, [j(c) for c in f["clips"]], j(f["text"]),
                         j(f["mask"]), j(f["pooled"]), j(f["timestep"]), history=j(f["history"]),
                         history_mask=j(f["history_mask"]),
                         frame_times=[j(x) for x in f["frame_times"]],
                         frame_valid=[j(x) for x in f["frame_valid"]], mesh=mesh)


def references(mmdit, vae, f, x):
    """deepv_tpu's results on a 4-device (and, for tcp_vae_encode, a
    2-device) virtual CPU mesh, each function jitted (its shard_map run
    eagerly dispatches op by op, ~20x slower here). The forward's f32
    exp/cos/sin are evaluated in f64 and rounded, as the port evaluates them
    (test_torch_port_mmdit.py)."""
    out = {}
    cfg = VAEConfig.tiny()
    jax.clear_caches()   # no program traced without the f32 pin below is reused
    with jax.enable_x64():
        mesh = make_mesh((RANKS,), ("tp",))
        params = jax.tree.map(jnp.asarray, mmdit)
        sharded = shard_mmdit_params(params, mesh, "tp")
        with mesh, pytest.MonkeyPatch.context() as mp:
            for name in ("exp", "cos", "sin"):
                mp.setattr(jnp, name, correctly_rounded(getattr(jnp, name)))
            out["tp_forward"] = np.asarray(jax.jit(
                lambda p: _jax_forward(p, f, mesh))(sharded))
        jax.clear_caches()
        pv = jax.tree.map(jnp.asarray, vae)
        j = {k: jnp.asarray(v) for k, v in x.items()}
        for name, fn, arg in (
                ("cp_vae_encode", lambda p, a: jax_cp.cp_vae_encode(cfg, p, a, mesh, "tp"),
                 "encode"),
                ("cp_vae_decode", lambda p, a: jax_cp.cp_vae_decode(cfg, p, a, mesh, "tp"),
                 "decode"),
                ("cp_vae_encode_chunked", lambda p, a: jax_cp.cp_vae_encode_chunked(
                    cfg, p, a, mesh, "tp", window_size=8), "encode_chunked"),
                ("cp_vae_decode_chunked", lambda p, a: jax_cp.cp_vae_decode_chunked(
                    cfg, p, a, mesh, "tp", window_size=2), "decode_chunked"),
                ("tcp_vae_decode", lambda p, a: jax_cp.tcp_vae_decode(cfg, p, a, mesh, "tp"),
                 "tcp_decode"),
                ("tcp_vae_encode", lambda p, a: jax_cp.tcp_vae_encode(
                    cfg, p, a, make_mesh((2,), ("tp",)), "tp"), "tcp_encode")):
            out[name] = jax.jit(fn)(pv, j[arg])
        y0, cache = jax_cp.cp_dec_window(cfg, pv["decoder"], j["window0"], None,
                                         "init", mesh, "tp")
        y1, cache = jax_cp.cp_dec_window(cfg, pv["decoder"], j["window1"], cache,
                                         "cont", mesh, "tp")
        out["cp_dec_window"] = (np.asarray(y0), np.asarray(y1),
                                jax.tree.map(np.asarray, cache))
        refusals = {}
        for name, call in (
                ("cp_vae_encode", lambda: jax_cp.cp_vae_encode(VAEConfig.tiny(), pv,
                                                               j["bad_pixels"], mesh, "tp")),
                ("cp_vae_decode", lambda: jax_cp.cp_vae_decode(VAEConfig.tiny(), pv,
                                                               j["bad_latents"], mesh, "tp")),
                ("cp_vae_encode_chunked", lambda: jax_cp.cp_vae_encode_chunked(
                    cfg, pv, j["bad_pixels"], mesh, "tp", window_size=8)),
                ("cp_vae_decode_chunked", lambda: jax_cp.cp_vae_decode_chunked(
                    cfg, pv, j["bad_latents"], mesh, "tp")),
                ("tcp_vae_decode", lambda: jax_cp.tcp_vae_decode(VAEConfig.tiny(), pv,
                                                                 j["bad_frames"], mesh, "tp")),
                ("tcp_vae_encode", lambda: jax_cp.tcp_vae_encode(VAEConfig.tiny(), pv,
                                                                 j["tcp_encode"], mesh, "tp"))):
            with pytest.raises(AssertionError) as e:
                call()
            refusals[name] = str(e.value)
        out["refusals"] = refusals
    return {k: (np.asarray(v) if k in CP_FUNCTIONS else v) for k, v in out.items()}


@pytest.fixture(scope="module")
def runs():
    rng = np.random.default_rng(0)
    mmdit = jax.tree.map(lambda a: a.numpy(), random_mmdit_params(
        TMMDiTConfig(**MCFG), dtype=torch.float64, seed=0, device="cpu"))
    vae = jax.tree.map(lambda a: a.numpy(), random_params(
        TMMDiTConfig(**MCFG), TVAEConfig.tiny(), dtype=torch.float64, seed=0, device="cpu")["vae"])
    f, x = forward_inputs(rng), vae_inputs(rng)
    ranks = spawn(worker.parallel_rank, RANKS, (MCFG, mmdit, f, vae, x), backend="gloo")
    t = torch.from_numpy
    single = port_forward(params_from_numpy(MMDiT(TMMDiTConfig(**MCFG)), mmdit),
                          [t(c) for c in f["clips"]], t(f["text"]), t(f["mask"]), t(f["pooled"]),
                          t(f["timestep"]), history=t(f["history"]),
                          history_mask=t(f["history_mask"]),
                          frame_times=[t(a) for a in f["frame_times"]],
                          frame_valid=[t(a) for a in f["frame_valid"]]).numpy()
    return ranks, references(mmdit, vae, f, x), single


def test_ranks_import_no_jax_and_return_the_same_bits(runs):
    ranks, _, _ = runs
    assert [r["rank"] for r in ranks] == list(range(RANKS))
    for r in ranks:
        assert r["forbidden_modules"] == []
        for key in ("tp_forward",) + CP_FUNCTIONS:
            assert np.array_equal(r[key], ranks[0][key]), (r["rank"], key)
        assert all(np.array_equal(a, b) for a, b in zip(r["cp_dec_window"][:2],
                                                       ranks[0]["cp_dec_window"][:2]))


def test_tp_forward_matches_deepv_tpu(runs):
    """Rank shares of 1 head each; 2 blocks, the last context-pre-only: 6
    row-split reductions. Also equal to the port's single-device forward."""
    ranks, ref, single = runs
    got = ranks[0]["tp_forward"]
    assert got.shape == ref["tp_forward"].shape == (2, 14, 1, 8, 8)
    np.testing.assert_allclose(got, ref["tp_forward"], rtol=0, atol=ATOL)
    np.testing.assert_allclose(got, single, rtol=0, atol=ATOL)
    assert ranks[0]["tp_reductions"] == 4 + 2


@pytest.mark.parametrize("name", CP_FUNCTIONS)
def test_cp_function_matches_deepv_tpu(runs, name):
    ranks, ref, _ = runs
    got = ranks[0][name]
    assert got.shape == ref[name].shape
    np.testing.assert_allclose(got, ref[name], rtol=0, atol=ATOL)


def test_cp_dec_window_carries_matching_caches(runs):
    """Two carried windows (init, cont): the pixels, and each rank's
    halo-extended caches, which put together along H are deepv_tpu's
    global cache."""
    ranks, ref, _ = runs
    for got, want in zip(ranks[0]["cp_dec_window"][:2], ref["cp_dec_window"][:2]):
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    caches = [flatten_tree(r["cp_dec_window"][2]) for r in ranks]
    want = flatten_tree(ref["cp_dec_window"][2])
    assert set(caches[0]) == set(want) and want
    for key, leaf in want.items():
        got = np.concatenate([c[key] for c in caches], axis=3)
        assert got.shape == leaf.shape, key
        np.testing.assert_allclose(got, leaf, rtol=0, atol=ATOL, err_msg=key)


def test_two_axis_mesh_groups(runs):
    """make_mesh((2, 2), ("dp", "tp")): ranks in row-major order; each
    axis's group sums over the ranks that differ only along it."""
    ranks, _, _ = runs
    for r in ranks:
        dp, tp = divmod(r["rank"], 2)
        assert r["mesh2"] == (dp, tp, float(2 * dp + 2 * dp + 1), float(tp + tp + 2))


def test_divisibility_errors_match_deepv_tpu(runs):
    """The six functions deepv_tpu checks raise ValueError with deepv_tpu's
    message (deepv_tpu asserts); cp_dec_window, which deepv_tpu leaves to
    shard_map, raises the latent-H error too; make_mesh refuses a world of
    another size, a backend other than the group's and more ranks than
    cards."""
    ranks, ref, _ = runs
    got = ranks[0]["refusals"]
    for name, message in ref["refusals"].items():
        assert got[name] == ("ValueError", message), (name, got[name], message)
    assert got["cp_dec_window"] == ("ValueError", ref["refusals"]["cp_vae_decode"])
    assert got["make_mesh size"][0] == "ValueError" and "needs 3 ranks" in got["make_mesh size"][1]
    assert got["make_mesh backend"][0] == "ValueError" and "'gloo'" in got["make_mesh backend"][1]
    assert got["make_mesh cards"][0] == "RuntimeError" and "CUDA cards" in got["make_mesh cards"][1]
