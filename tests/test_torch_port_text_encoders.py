"""The port's SD3 text encoders (M15b) against deepv_tpu's.

A tiny snapshot from tests/snapshot_utils.py ``write_text_snapshot``: two
character-level CLIP tokenizers, a word-level T5-fast tokenizer and three
tiny HF towers saved as safetensors with their config.json. Both packages
load it (``load_text_encoders``) and run the same towers on the same ids.

Tolerances. The towers in f32 are compared at atol 2e-5 / rtol 1e-4, the
bound deepv_tpu's own tests hold its towers to against HF torch
(tests/test_text_encoders.py, tests/test_text_e2e.py): both packages form
the same f32 products, norms and softmaxes, whose summation orders and
exp/rsqrt differ by ulps over 2 layers. Token ids, masks and bucket ids
are integers and must be equal. The text-prompt rollout is held at
tests/test_torch_port_pipeline.py's ATOL 1e-6 in f64 with that file's
injected draws and pinned rounding orders; its towers run with f64
parameters in both packages. Their attention products still round to f32
in both, as deepv_tpu's ``preferred_element_type`` does, and two f32 steps
are pinned as that file pins its call sites: deepv_tpu's concrete f32
softmax (CLIP's) runs through ``torch.softmax`` and its T5 layer norm
(f32 by design) through the port's, since their exp and rsqrt differ by
ulps, which the random-weight rollout amplified to 1.9e-6 without the pins.
"""

import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deepv_tpu.io import weights as jax_weights
from deepv_tpu.io.build_embeds import build_action_embeds as jax_build_action_embeds
from deepv_tpu.io.text_embeds import random_text_embeds
from deepv_tpu.models import text_encoders as jax_te

from deepv_tpu_torch.actions import action_vocabulary, prepare_motion_prompts
from deepv_tpu_torch.config import (MMDiTConfig as TMMDiTConfig,
                                    PipelineConfig as TPipelineConfig, VAEConfig as TVAEConfig)
from deepv_tpu_torch.io import weights as port_weights
from deepv_tpu_torch.io.build_embeds import build_action_embeds
from deepv_tpu_torch.io.weights import random_params
from deepv_tpu_torch.models import text_encoders as port_te
from deepv_tpu_torch.pipeline import InferencePipeline as TorchPipeline

from snapshot_utils import CLIP_PROJ, T5_D, write_text_snapshot
from test_torch_port_pipeline import ATOL, MCFG, ReplayNoise, _run_reference, via_port

torch.set_num_threads(1)

ATOL_F32, RTOL_F32 = 2e-5, 1e-4
#: the largest id of write_clip_tokenizer's vocabulary: <|endoftext|>
CLIP_EOT = 191
PROMPTS = ("Move forward. The perspective hasn't changed.",
           "A red car drives down the road.",
           # past 77 tokens for every tokenizer: truncated
           " ".join(["A red car drives down the road."] * 12))


@pytest.fixture(scope="module")
def snapshot(tmp_path_factory):
    root = tmp_path_factory.mktemp("text_ckpt")
    towers = write_text_snapshot(root)
    return str(root), towers


@pytest.fixture(scope="module")
def encoders(snapshot):
    """Both packages' facades on the snapshot, towers in f32."""
    root = snapshot[0]
    ref = jax_weights.load_text_encoders(root, dtype=jnp.float32)
    port = port_weights.load_text_encoders(root, dtype=torch.float32, device="cpu")
    assert ref is not None and port is not None
    return ref, port


def _close(got, want, err_msg=""):
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64),
                               rtol=RTOL_F32, atol=ATOL_F32, err_msg=err_msg)


def test_relative_bucket_equals_reference():
    for q, k, buckets, dist in ((77, 77, 32, 128), (5, 300, 32, 128), (40, 40, 16, 20)):
        rel = np.arange(k)[None, :] - np.arange(q)[:, None]
        got = port_te._t5_relative_bucket(rel, buckets, dist)
        want = jax_te._t5_relative_bucket(rel, buckets, dist)
        assert got.dtype == want.dtype and np.array_equal(got, want)


def test_towers_load_as_the_reference_loads_them(snapshot, encoders):
    """Every leaf of the three trees equal (f32), T5's unread tied
    ``encoder.embed_tokens.weight`` kept, and the configs equal."""
    ref, port = encoders
    assert port.configs == ref.configs
    assert port.configs["clip_l"] == {"num_heads": 4, "act": "quick_gelu", "eos_token_id": 2}
    assert port.configs["t5"] == {"num_heads": 4, "gated_act": True}
    for name in ("clip_l", "clip_g", "t5"):
        got = port_weights.flatten_tree(port.params[name])
        want = port_weights.flatten_tree(jax.tree.map(np.asarray, ref.params[name]))
        assert set(got) == set(want), name
        for k, v in want.items():
            assert got[k].dtype == torch.float32
            np.testing.assert_array_equal(got[k].numpy(), v, err_msg=f"{name}.{k}")
    assert "encoder.embed_tokens.weight" in port_weights.flatten_tree(port.params["t5"])


def _clip_ids():
    """Two rows of BOS, characters, then EOT repeated as the pad (SD3's first
    tokenizer pads with its EOS id)."""
    ids = np.full((2, 77), CLIP_EOT, np.int64)
    ids[:, 0] = 0
    ids[0, 1:6] = [5, 17, 40, 3, 99]
    ids[1, 1:30] = np.arange(1, 30) * 6
    return ids


@pytest.mark.parametrize("act", ["quick_gelu", "gelu"])
@pytest.mark.parametrize("eos_token_id", [2, CLIP_EOT])
def test_clip_encode_matches_reference(encoders, act, eos_token_id):
    """eos_token_id 2 pools at argmax(ids), another value at the first id
    equal to it; with the pad equal to EOS both must pick the first EOT
    (position 6 and 30 here)."""
    ref, port = encoders
    ids = _clip_ids()
    want = jax_te.clip_encode(ref.params["clip_l"], jnp.asarray(ids), num_heads=4, act=act,
                              eos_token_id=eos_token_id)
    got = port_te.clip_encode(port.params["clip_l"], torch.from_numpy(ids), num_heads=4, act=act,
                              eos_token_id=eos_token_id)
    assert tuple(got.shape) == want.shape == (2, CLIP_PROJ)
    _close(got.numpy(), want)
    # the pooled row is the first EOT's: the same ids cut just after it pool the same
    short = port_te.clip_encode(port.params["clip_l"], torch.from_numpy(ids[:1, :7]),
                                num_heads=4, act=act, eos_token_id=eos_token_id)
    np.testing.assert_allclose(short.numpy(), got[:1].numpy(), rtol=0, atol=1e-6)


@pytest.fixture(scope="module")
def relu_t5():
    """A tiny T5 encoder with the ungated relu feed-forward (``wi``)."""
    from transformers import T5Config, T5EncoderModel

    cfg = T5Config(vocab_size=40, d_model=16, d_kv=4, d_ff=24, num_layers=2, num_heads=4,
                   feed_forward_proj="relu")
    torch.manual_seed(5)
    state = {k: v.detach().numpy() for k, v in T5EncoderModel(cfg).eval().state_dict().items()}
    ref_tree = jax_weights.convert_text_tower_state(state, dtype=jnp.float32)
    port_tree = port_weights.convert_text_tower_state(
        {k: torch.from_numpy(v) for k, v in state.items()}, dtype=torch.float32)
    return ref_tree, port_tree


@pytest.mark.parametrize("gated", [True, False])
def test_t5_encode_matches_reference(encoders, relu_t5, gated):
    """Gated (the snapshot's gated-gelu tower) and not gated (relu), two
    rows with a pad mask of different lengths."""
    ref, port = encoders
    ref_tree, port_tree = (ref.params["t5"], port.params["t5"]) if gated else relu_t5
    vocab = 30 if gated else 40
    rng = np.random.default_rng(4)
    ids = rng.integers(3, vocab, (2, 77))
    mask = np.zeros((2, 77), np.int64)
    mask[0, :9], mask[1, :40] = 1, 1
    ids[mask == 0] = 0
    want = jax_te.t5_encode(ref_tree, jnp.asarray(ids), jnp.asarray(mask), num_heads=4,
                            gated_act=gated)
    got = port_te.t5_encode(port_tree, torch.from_numpy(ids), torch.from_numpy(mask),
                            num_heads=4, gated_act=gated)
    assert tuple(got.shape) == want.shape == (2, 77, T5_D if gated else 16)
    _close(got.numpy(), want)


def test_load_text_encoders_needs_all_three_towers(snapshot, tmp_path):
    import shutil

    assert jax_weights.load_text_encoders(str(tmp_path)) is None
    assert port_weights.load_text_encoders(str(tmp_path), device="cpu") is None
    shutil.copytree(snapshot[0], tmp_path / "two", ignore=shutil.ignore_patterns("text_encoder_3"))
    assert jax_weights.load_text_encoders(str(tmp_path / "two")) is None
    assert port_weights.load_text_encoders(str(tmp_path / "two"), device="cpu") is None


@pytest.mark.parametrize("prompt", PROMPTS, ids=["move", "car", "truncated"])
def test_facade_matches_reference(encoders, prompt):
    """``(prompt_embeds, mask, pooled)`` of the two facades: the same ids
    and mask (the long prompt is truncated to 77 by every tokenizer), the
    embeddings within the f32 tolerance."""
    ref, port = encoders
    seq, mask, pooled = port(prompt)
    rseq, rmask, rpooled = ref(prompt)
    assert tuple(seq.shape) == rseq.shape == (1, 77, T5_D)
    assert tuple(pooled.shape) == rpooled.shape == (1, 2 * CLIP_PROJ)
    assert seq.dtype == pooled.dtype == torch.float32
    np.testing.assert_array_equal(mask.numpy(), np.asarray(rmask))
    ids = port.tokenize(prompt)
    if prompt is PROMPTS[2]:
        assert mask.numpy().all() and ids[0][0, -1] == CLIP_EOT and ids[2][0, -1] == 1
    else:
        assert not mask.numpy().all()
    _close(seq.numpy(), rseq, "prompt_embeds")
    _close(pooled.numpy(), rpooled, "pooled_prompt_embeds")


def test_facade_without_transformers_raises(snapshot, monkeypatch):
    """Nothing falls back: without ``transformers`` the facade cannot be
    built."""
    monkeypatch.setitem(sys.modules, "transformers", None)
    with pytest.raises(ImportError, match="transformers"):
        port_weights.load_text_encoders(snapshot[0], device="cpu")


def test_build_action_embeds_matches_reference(encoders):
    ref, port = encoders
    got, want = build_action_embeds(port), jax_build_action_embeds(ref)
    assert list(got) == list(want) == action_vocabulary()
    for sentence, fields in want.items():
        for field, arr in fields.items():
            assert got[sentence][field].dtype == arr.dtype, field
            assert got[sentence][field].shape == arr.shape, field
        np.testing.assert_array_equal(got[sentence]["prompt_attention_mask"],
                                      fields["prompt_attention_mask"])
        _close(got[sentence]["prompt_embeds"], fields["prompt_embeds"], sentence)
        _close(got[sentence]["pooled_prompt_embeds"], fields["pooled_prompt_embeds"], sentence)


def softmax_via_torch(jnp_softmax):
    """jax.nn.softmax whose concrete float32 calls run through torch.softmax,
    as the port's CLIP attention evaluates its f32 softmax (the two
    exps differ by ulps)."""
    def wrapped(x, axis=-1, **kwargs):
        if x.dtype == jnp.float32 and not isinstance(x, jax.core.Tracer) and not kwargs:
            return jnp.asarray(torch.softmax(torch.from_numpy(np.array(x)), dim=axis).numpy())
        return jnp_softmax(x, axis=axis, **kwargs)
    return wrapped


class CountingEncoder:
    """A facade that counts its calls per prompt."""

    def __init__(self, encoder):
        self.encoder, self.calls = encoder, {}

    def __call__(self, prompt):
        self.calls[prompt] = self.calls.get(prompt, 0) + 1
        return self.encoder(prompt)


def test_text_prompt_rollout_matches_reference(snapshot):
    """A 2-chunk ``prompt_type="text"`` rollout at 64x64 in f64: the prompt
    comes from each package's live encoder (f64 towers), the negative
    'empty' from the cache. The port's encoder runs once for the prompt (the
    memo), and the frames equal deepv_tpu's within ATOL."""
    root = snapshot[0]
    params = random_params(TMMDiTConfig(**MCFG), TVAEConfig.tiny(), dtype=torch.float64,
                           seed=0, device="cpu")
    params = {k: jax.tree.map(lambda a: a.numpy(), v) for k, v in params.items()}
    embeds = random_text_embeds(0, action_vocabulary(), joint_dim=T5_D, pooled_dim=2 * CLIP_PROJ)
    img = np.random.default_rng(7).uniform(-1.0, 1.0, (1, 3, 64, 64))
    batch = {"img": img, "prompt": np.array(prepare_motion_prompts("text", PROMPTS[1])),
             "prompt_type": "text"}
    with jax.enable_x64():
        ref_encoder = jax_weights.load_text_encoders(root, dtype=jnp.float64)
        pins = ((jax.nn, "softmax", softmax_via_torch(jax.nn.softmax)),
                (jax_te, "t5_layer_norm", via_port(port_te.t5_layer_norm)))
        ref, draws, ref_index = _run_reference(params, embeds, batch=batch, patches=pins,
                                               text_encoder=ref_encoder)
    encoder = CountingEncoder(port_weights.load_text_encoders(root, dtype=torch.float64,
                                                              device="cpu"))
    pipe = TorchPipeline(TPipelineConfig(), TMMDiTConfig(**MCFG), TVAEConfig.tiny(), params,
                         embeds, dtype=torch.float64, text_encoder=encoder, device="cpu")
    noise = ReplayNoise(draws)
    out = pipe.generate(batch, seed=9, noise=noise)
    assert encoder.calls == {PROMPTS[1]: 1}
    assert all(not q for q in noise.queues.values())
    assert tuple(out["pred_img"].shape) == ref["pred_img"].shape == (1, 3, 89, 64, 64)
    assert out["history_index"] == ref_index
    for key in ("pred_img", "pred_disparity", "trans3d", "trans2d"):
        got = out[key].numpy()
        assert np.isfinite(got).all(), key
        np.testing.assert_allclose(got, ref[key], rtol=0, atol=ATOL, err_msg=key)
