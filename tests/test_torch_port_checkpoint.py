"""The port's checkpoint loader (M15a) against deepv_tpu's.

The port reads safetensors files itself (``io/safetensors.py``): its reader
is held to ``safetensors.safe_open`` on every dtype it names, BF16 included
(``framework="pt"``: deepv_tpu's numpy reader refuses BF16), and on a
sharded directory. A tiny diffusers-style snapshot is written with
tests/snapshot_utils.py from deepv_tpu's ``init_*_params`` (the MMDiT as
F32, the VAE as F16, both of which deepv_tpu reads) and loaded by both
packages: every leaf equal bit for bit at f32 and at bf16 (``pos_embed`` as
f32 of the bf16 values in both), the MMDiT forward and the VAE encode and
decode of the loaded f64 trees at the atol of the port's MMDiT (1e-8) and
VAE (1e-9) parity tests, and ``run.load_pipeline`` on the snapshot.

A loaded tree keeps the positional table in f32 while the model runs in
f64, so both packages crop and interpolate it in f32. The forward test pins
the timestep embedding's f32 exp/cos/sin as tests/test_torch_port_mmdit.py
does.
"""

import json
import struct

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from safetensors import safe_open
from safetensors.torch import save_file as torch_save_file

from deepv_tpu.config import MMDiTConfig, PipelineConfig, VAEConfig
from deepv_tpu.io import weights as jax_weights
from deepv_tpu.io.text_embeds import load_text_embeds as jax_load_text_embeds
from deepv_tpu.models import vae as jax_vae
from deepv_tpu.models.mmdit import init_mmdit_params, mmdit_forward as jax_forward
from deepv_tpu.models.vae import init_vae_params
from deepv_tpu.pipeline import _pyramid_list as jax_pyramid, padded_conditions as jax_padded

from deepv_tpu_torch import run
from deepv_tpu_torch.actions import action_vocabulary
from deepv_tpu_torch.config import (MMDiTConfig as TMMDiTConfig,
                                    PipelineConfig as TPipelineConfig,
                                    VAEConfig as TVAEConfig, create_model_config)
from deepv_tpu_torch.io import safetensors as port_st
from deepv_tpu_torch.io import weights as port_weights
from deepv_tpu_torch.io.text_embeds import load_text_embeds
from deepv_tpu_torch.io.weights import flatten_tree, params_from_numpy, random_params
from deepv_tpu_torch.models import vae as port_vae
from deepv_tpu_torch.models.mmdit import MMDiT, mmdit_forward as port_forward
from deepv_tpu_torch.pipeline import _pyramid_list as port_pyramid, padded_conditions as port_padded

from snapshot_utils import flatten_with_names, write_transformer_dir, write_vae_dir

torch.set_num_threads(1)

MCFG = dict(sample_size=16, patch_size=2, in_channels=14, num_layers=2,
            attention_head_dim=8, num_attention_heads=4, caption_projection_dim=32,
            pooled_projection_dim=16, pos_embed_max_size=32, joint_attention_dim=24)
#: tests/test_torch_port_mmdit.py's and tests/test_torch_port_vae.py's f64 tolerances
MMDIT_ATOL, VAE_ATOL = 1e-8, 1e-9


# ---------------------------------------------------------------------------
# the reader
# ---------------------------------------------------------------------------

def _tensors(dtype, seed):
    g = torch.Generator().manual_seed(seed)
    base = {"a.weight": torch.randn(3, 5, generator=g) * 100, "b": torch.randn(7, generator=g),
            "scalar": torch.tensor(1.5), "empty": torch.zeros(0, 4)}
    return {k: v.to(dtype) for k, v in base.items()}


def _safe_open_all(path):
    with safe_open(str(path), framework="pt") as f:
        return {k: f.get_tensor(k) for k in f.keys()}


def _assert_same(got, want):
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        assert tuple(got[k].shape) == tuple(want[k].shape), k
        assert torch.equal(got[k], want[k]), k


@pytest.mark.parametrize("dtype", [torch.float32, torch.float16, torch.bfloat16, torch.int64,
                                   torch.float64, torch.int32, torch.int16, torch.int8,
                                   torch.uint8, torch.bool],
                         ids=lambda d: str(d).split(".")[-1])
def test_reader_matches_safe_open(tmp_path, dtype):
    tensors = _tensors(dtype, seed=0)
    path = tmp_path / "t.safetensors"
    torch_save_file(tensors, str(path), metadata={"format": "pt"})
    got = port_st.load_file(str(path))
    _assert_same(got, _safe_open_all(path))
    _assert_same(got, tensors)


def test_reader_merges_a_sharded_directory(tmp_path):
    """Every shard, sorted, keys merged; the index JSON is not read."""
    shards = {"model-00002-of-00002.safetensors": _tensors(torch.bfloat16, 1),
              "model-00001-of-00002.safetensors": {"c.weight": torch.randn(4, 4)}}
    for name, tensors in shards.items():
        torch_save_file(tensors, str(tmp_path / name))
    (tmp_path / "model.safetensors.index.json").write_text(json.dumps({"weight_map": {}}))
    want = {}
    for name in sorted(shards):
        want.update(_safe_open_all(tmp_path / name))
    got = port_st.load_dir(str(tmp_path))
    _assert_same(got, want)
    assert len(got) == 5


def test_reader_refuses_what_it_cannot_read(tmp_path):
    with pytest.raises(FileNotFoundError):
        port_st.load_dir(str(tmp_path))
    header = json.dumps({"x": {"dtype": "F32", "shape": [2], "data_offsets": [0, 8]}}).encode()
    short = tmp_path / "short.safetensors"
    short.write_bytes(struct.pack("<Q", len(header) + 100) + header + bytes(8))
    with pytest.raises(ValueError, match="runs past the file"):
        port_st.load_file(str(short))
    cut = tmp_path / "cut.safetensors"
    cut.write_bytes(struct.pack("<Q", len(header)) + header + bytes(4))
    with pytest.raises(ValueError, match="runs past the file"):
        port_st.load_file(str(cut))
    fp8 = tmp_path / "fp8.safetensors"
    torch_save_file({"x": torch.zeros(2, dtype=torch.float8_e4m3fn)}, str(fp8))
    with pytest.raises(ValueError, match="F8_E4M3"):
        port_st.load_file(str(fp8))


# ---------------------------------------------------------------------------
# a tiny snapshot, loaded by both packages
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def snapshot(tmp_path_factory):
    """transformer/ (F32) and causal_video_vae/ (F16) from deepv_tpu's init
    (jitted: its eager init takes ~30 s here); returns the root and the
    written values, flattened by tree path."""
    root = tmp_path_factory.mktemp("ckpt")
    mcfg, vcfg = MMDiTConfig(**MCFG), VAEConfig.tiny()
    mp = jax.jit(init_mmdit_params, static_argnums=(1, 2))(jax.random.PRNGKey(0), mcfg,
                                                            jnp.float32)
    vp = jax.jit(init_vae_params, static_argnums=(1, 2))(jax.random.PRNGKey(1), vcfg,
                                                          jnp.float32)
    vp = jax.tree.map(lambda a: a.astype(jnp.float16), vp)
    write_transformer_dir(root, mcfg, mp)
    write_vae_dir(root, vcfg, vp)
    written = [{k: np.asarray(v) for k, v in flatten_with_names(tree).items()} for tree in (mp, vp)]
    return (str(root), *written)


def _bits(a):
    """A leaf as a float64 numpy array (bf16 through f32: exact) with its
    dtype's name."""
    if isinstance(a, torch.Tensor):
        return a.float().double().numpy() if a.dtype == torch.bfloat16 else \
            a.double().numpy(), str(a.dtype).split(".")[-1]
    return np.asarray(a, np.float64), str(a.dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_loaded_leaves_equal_reference(snapshot, dtype):
    root, mp, vp = snapshot
    ref_m, ref_v, ref = jax_weights.load_checkpoint(root, dtype=getattr(jnp, dtype))
    mcfg, vcfg, params = port_weights.load_checkpoint(root, dtype=getattr(torch, dtype))
    assert mcfg == TMMDiTConfig(**MCFG) and ref_m == MMDiTConfig(**MCFG)
    assert vcfg == TVAEConfig.tiny() and ref_v == VAEConfig.tiny()
    for part, written in (("mmdit", mp), ("vae", vp)):
        got, want = flatten_tree(params[part]), flatten_with_names(ref[part])
        assert set(got) == set(want) == set(written), sorted(set(got) ^ set(want))[:4]
        for k in want:
            (g, gd), (w, wd) = _bits(got[k]), _bits(want[k])
            assert gd == wd, (k, gd, wd)
            np.testing.assert_array_equal(g, w, err_msg=k)
            if dtype == "float32":          # f32 and f16 files: exact in f32
                np.testing.assert_array_equal(g, np.asarray(written[k], np.float64), err_msg=k)
    # the table is f32 of the file's values rounded to ``dtype``
    pos = params["mmdit"]["pos_embed"]["pos_embed"]
    assert pos.dtype == torch.float32
    assert torch.equal(pos, torch.from_numpy(mp["pos_embed.pos_embed"].copy())
                       .to(getattr(torch, dtype)).float())


def _forward_inputs(rows, stage, seed):
    rng = np.random.default_rng(seed)
    gen = rng.standard_normal((1, 14, 5, 8, 8))
    lat = rng.standard_normal((1, 14, 1) + (8 // 2 ** (2 - stage),) * 2)
    text = rng.standard_normal((rows, 77, 24))
    mask = np.zeros((rows, 77), np.int32)
    mask[0, :2] = 1
    mask[1:, :11] = 1
    pooled = rng.standard_normal((rows, 16))
    t = np.full((rows,), 700.0, np.float32)
    hist = rng.standard_normal((3, 14, 1, 8, 8)) if rows == 3 else None
    return gen, lat, text, mask, pooled, t, hist


def correctly_rounded(fn):
    """``fn`` evaluated for float32 inputs in f64 and rounded to f32, as the
    port evaluates the timestep embedding's exp/cos/sin (the
    tests/test_torch_port_mmdit.py pin)."""
    def wrapped(x, *args, **kwargs):
        if getattr(x, "dtype", None) == jnp.float32:
            return fn(jnp.asarray(x).astype(jnp.float64), *args, **kwargs).astype(jnp.float32)
        return fn(x, *args, **kwargs)
    return wrapped


@pytest.fixture(scope="module")
def f64_trees(snapshot):
    """Both packages' loads of the snapshot at float64 (``pos_embed`` f32)."""
    root = snapshot[0]
    with jax.enable_x64():
        _, _, ref = jax_weights.load_checkpoint(root, dtype=jnp.float64)
        ref = jax.tree.map(np.asarray, ref)
    _, _, params = port_weights.load_checkpoint(root, dtype=torch.float64)
    return ref, params


@pytest.mark.parametrize("rows, stage", [(2, 0), (3, 2)])
def test_mmdit_forward_of_the_loaded_tree(f64_trees, rows, stage):
    """One forward over the rollout's packed layout (3 rows: with history)
    from each package's loaded tree; the f32 positional table is cropped and
    interpolated in f32 by both."""
    ref_tree, params = f64_trees
    model = params_from_numpy(MMDiT(TMMDiTConfig(**MCFG)), params["mmdit"])
    assert model.pos_embed.pos_embed.dtype == torch.float32
    gen, lat, text, mask, pooled, t, hist = _forward_inputs(rows, stage, seed=10 * rows + stage)
    unit, fm = (3, True) if rows == 2 else (5, False)
    hmask = np.array([[0] * 4, [0] * 4, [1] * 4], np.int32) if rows == 3 else None
    jax.clear_caches()   # no program traced without the pins may be reused
    with jax.enable_x64(), pytest.MonkeyPatch.context() as mp:
        for name in ("exp", "cos", "sin"):
            mp.setattr(jnp, name, correctly_rounded(getattr(jnp, name)))
        clips, times, valid = jax_padded(PipelineConfig(), jax_pyramid(jnp.asarray(gen), 2),
                                         unit, fm, rows)[stage]
        fwd = jax.jit(jax_forward, static_argnums=0)
        ref = np.asarray(fwd(
            MMDiTConfig(**MCFG), jax.tree.map(jnp.asarray, ref_tree["mmdit"]),
            list(clips) + [jnp.asarray(np.concatenate([lat] * rows))],
            jnp.asarray(text), jnp.asarray(mask), jnp.asarray(pooled), jnp.asarray(t),
            history=None if hist is None else jnp.asarray(hist),
            history_mask=None if hmask is None else jnp.asarray(hmask),
            frame_times=list(times), frame_valid=list(valid)))
    jax.clear_caches()
    clips, times, valid = port_padded(TPipelineConfig(), port_pyramid(torch.from_numpy(gen), 2),
                                      unit, fm, rows)[stage]
    out = port_forward(model, list(clips) + [torch.from_numpy(np.concatenate([lat] * rows))],
                       torch.from_numpy(text), torch.from_numpy(mask), torch.from_numpy(pooled),
                       torch.from_numpy(t),
                       history=None if hist is None else torch.from_numpy(hist),
                       history_mask=None if hmask is None else torch.from_numpy(hmask),
                       frame_times=list(times), frame_valid=list(valid), split_last_attn=True)
    assert tuple(out.shape) == ref.shape == (rows, 14, 1) + lat.shape[-2:]
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=MMDIT_ATOL)


def test_vae_encode_and_decode_of_the_loaded_tree(f64_trees):
    ref_tree, params = f64_trees
    vae = params_from_numpy(port_vae.VAE(TVAEConfig.tiny()), params["vae"])
    x = np.random.default_rng(0).uniform(-1, 1, (1, 3, 9, 32, 32))
    z = np.random.default_rng(1).standard_normal((1, 4, 2, 4, 4))
    with jax.enable_x64():
        p = jax.tree.map(jnp.asarray, ref_tree["vae"])
        ref_enc = np.asarray(jax_vae.vae_encode(VAEConfig.tiny(), p, jnp.asarray(x)))
        ref_dec = np.asarray(jax_vae.vae_decode(VAEConfig.tiny(), p, jnp.asarray(z)))
    enc = port_vae.vae_encode(TVAEConfig.tiny(), vae, torch.from_numpy(x)).numpy()
    dec = port_vae.vae_decode(TVAEConfig.tiny(), vae, torch.from_numpy(z)).numpy()
    assert enc.shape == ref_enc.shape == (1, 8, 2, 4, 4)
    assert dec.shape == ref_dec.shape == (1, 3, 9, 32, 32)
    np.testing.assert_allclose(enc, ref_enc, rtol=0, atol=VAE_ATOL)
    np.testing.assert_allclose(dec, ref_dec, rtol=0, atol=VAE_ATOL)


def test_load_pipeline_from_the_snapshot(snapshot):
    """``run.load_pipeline`` without random weights: the modules hold the
    snapshot's values in ``dtype`` (``pos_embed`` f32), the configs are the
    snapshot's, and with no text directories nor cache file the action
    embeddings are random_text_embeds(0)."""
    root, mp, vp = snapshot
    pipe = run.load_pipeline(root, create_model_config(root), dtype=torch.float32, device="cpu")
    assert pipe.mcfg == TMMDiTConfig(**MCFG) and pipe.vcfg == TVAEConfig.tiny()
    assert pipe.text_encoder is None
    assert set(pipe.text_embeds) == set(action_vocabulary())
    for module, written in ((pipe.mmdit, mp), (pipe.vae, vp)):
        state = module.state_dict()
        assert set(state) == set(written)
        for k, v in state.items():
            assert v.dtype == (torch.float32), k
            np.testing.assert_array_equal(v.numpy(), np.asarray(written[k], np.float32),
                                          err_msg=k)
    pipe = run.load_pipeline(root, create_model_config(root), device="cpu")   # bf16
    assert pipe.mmdit.pos_embed.pos_embed.dtype == torch.float32
    assert pipe.mmdit.proj_out.weight.dtype == torch.bfloat16


def test_load_pipeline_reads_the_embedding_cache_file(snapshot, tmp_path):
    """``model_cfg.text_embeds_path``, where it exists, gives the action
    embeddings (an npz, ``io/text_embeds.save_text_embeds``)."""
    from deepv_tpu_torch.io.text_embeds import random_text_embeds, save_text_embeds

    root = snapshot[0]
    cache = random_text_embeds(5, action_vocabulary(), joint_dim=24, pooled_dim=16)
    path = tmp_path / "embeds.npz"
    save_text_embeds(str(path), cache)
    cfg = create_model_config(root, text_embeds_path=str(path))
    pipe = run.load_pipeline(root, cfg, dtype=torch.float32, device="cpu")
    for prompt, fields in cache.items():
        for field, arr in fields.items():
            np.testing.assert_array_equal(pipe.text_embeds[prompt][field], arr)


def test_load_pipeline_without_a_directory_draws_random_weights(tmp_path, monkeypatch):
    """deepv_tpu's rule (run.py:101): a ``model_path`` that is not a
    directory gives random weights, as ``random_weights=True`` does."""
    monkeypatch.setenv("DEEPV_TINY", "1")
    absent = str(tmp_path / "no_such_dir")
    pipe = run.load_pipeline(absent, create_model_config(absent), device="cpu")
    mcfg, vcfg = run.tiny_configs()
    assert pipe.mcfg == mcfg and pipe.vcfg == vcfg and pipe.text_encoder is None
    want = flatten_tree(random_params(mcfg, vcfg, dtype=torch.bfloat16, seed=0,
                                      device="cpu")["mmdit"])
    state = pipe.mmdit.state_dict()
    assert set(state) == set(want)
    for k, v in want.items():
        assert torch.equal(state[k], v), k


def test_convert_text_embeds_pt_matches_reference(tmp_path):
    """The reference's .pt cache (prompt -> field -> bf16 tensor) to the npz
    format, by both packages."""
    g = torch.Generator().manual_seed(3)
    raw = {s: {"prompt_embeds": torch.randn(1, 77, 24, generator=g).to(torch.bfloat16),
               "prompt_attention_mask": torch.ones(1, 77, dtype=torch.int64),
               "pooled_prompt_embeds": torch.randn(1, 16, generator=g).to(torch.bfloat16)}
           for s in action_vocabulary()[:3]}
    pt = tmp_path / "text_embeds_len77.pt"
    torch.save(raw, str(pt))
    port_weights.convert_text_embeds_pt(str(pt), str(tmp_path / "port.npz"))
    jax_weights.convert_text_embeds_pt(str(pt), str(tmp_path / "ref.npz"))
    got = load_text_embeds(str(tmp_path / "port.npz"))
    want = jax_load_text_embeds(str(tmp_path / "ref.npz"))
    assert set(got) == set(want) == set(raw)
    for prompt in want:
        for field in want[prompt]:
            assert got[prompt][field].dtype == want[prompt][field].dtype == np.float32
            np.testing.assert_array_equal(got[prompt][field], want[prompt][field])
