"""SD3's triple text encoder: CLIP-L + CLIP-G (pooled) and T5 (sequence).

deepv_tpu's ``models/text_encoders.py`` in PyTorch. Two CLIP text towers
give projected pooled embeddings (concatenated to 2048 wide) and a T5
encoder gives 77-token sequence embeddings with an attention mask, the
contract of the reference's ``SD3TextEncoderWithMask``. The towers are
functions on the converted HF-keyed trees (``io/weights.load_text_towers``),
as deepv_tpu keeps them, so keys they never read (T5's tied
``encoder.embed_tokens.weight``) may stay in the tree. Tokenising uses HF's
tokenizers on the host, and needs the ``transformers`` package, which is
imported only when an ``SD3TextEncoder`` is built.

Products that deepv_tpu takes with ``preferred_element_type=float32`` (the
attention logits and P.V) are formed here in at-least-f32 and rounded to
f32, which is what XLA does: a product of two bf16 values is exact in f32.
Live encoding is needed only for ``prompt_type="text"``; the action
vocabulary is served from the precomputed cache.
"""

from __future__ import annotations

import math
import os
from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.basic import compute_dtype, layer_norm


def _dense(x: torch.Tensor, p: dict) -> torch.Tensor:
    """y = x @ W^T + b on a tree node ``{"weight", "bias"?}`` (torch layout)."""
    y = F.linear(x, p["weight"].to(x.dtype))
    if p.get("bias") is not None:
        y = y + p["bias"].to(y.dtype)
    return y


def _einsum_f32(eq: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``jnp.einsum(eq, a, b, preferred_element_type=float32)``: formed in
    at-least-f32, rounded to f32."""
    ct = compute_dtype(a.dtype)
    return torch.einsum(eq, a.to(ct), b.to(ct)).to(torch.float32)


# ---------------------------------------------------------------------------
# CLIP text tower (HF CLIPTextModelWithProjection semantics)
# ---------------------------------------------------------------------------

def _quick_gelu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(1.702 * x)


_ACTS = {"quick_gelu": _quick_gelu, "gelu": F.gelu}


def clip_attention(p: dict, x: torch.Tensor, num_heads: int,
                   bias: torch.Tensor) -> torch.Tensor:
    b, s, d = x.shape
    hd = d // num_heads
    q = _dense(x, p["q_proj"]).reshape(b, s, num_heads, hd)
    k = _dense(x, p["k_proj"]).reshape(b, s, num_heads, hd)
    v = _dense(x, p["v_proj"]).reshape(b, s, num_heads, hd)
    logits = _einsum_f32("bqhd,bkhd->bhqk", q, k) / math.sqrt(hd)
    w = torch.softmax(logits + bias, dim=-1).to(v.dtype)
    out = _einsum_f32("bhqk,bkhd->bqhd", w, v).to(v.dtype)
    return _dense(out.reshape(b, s, d), p["out_proj"])


def clip_encode(params: dict, input_ids: torch.Tensor, *, num_heads: int,
                act: str = "quick_gelu", eos_token_id: int = 2) -> torch.Tensor:
    """input_ids [b, s] -> projected pooled embedding [b, proj_dim].

    HF semantics: causal mask, final layer norm, pool at the first EOS
    token, then ``text_projection`` (no bias)."""
    tm = params["text_model"]
    b, s = input_ids.shape
    x = tm["embeddings"]["token_embedding"]["weight"][input_ids]
    x = x + tm["embeddings"]["position_embedding"]["weight"][None, :s]

    pos = torch.arange(s, device=x.device)
    causal = torch.where(pos[:, None] >= pos[None, :], 0.0, -math.inf).to(torch.float32)[None, None]

    act_fn = _ACTS[act]
    for layer in tm["encoder"]["layers"]:
        h = layer_norm(x, 1e-5, layer["layer_norm1"]["weight"], layer["layer_norm1"]["bias"])
        x = x + clip_attention(layer["self_attn"], h, num_heads, causal)
        h = layer_norm(x, 1e-5, layer["layer_norm2"]["weight"], layer["layer_norm2"]["bias"])
        h = _dense(act_fn(_dense(h, layer["mlp"]["fc1"])), layer["mlp"]["fc2"])
        x = x + h

    x = layer_norm(x, 1e-5, tm["final_layer_norm"]["weight"], tm["final_layer_norm"]["bias"])
    # HF keeps a legacy path for eos_token_id == 2 (SD3's CLIP configs):
    # argmax over the raw ids, whose first maximum is the first EOT because
    # CLIP's EOT (49407) is the largest id (torch.argmax returns the first)
    if eos_token_id == 2:
        eos_pos = torch.argmax(input_ids, dim=1)
    else:
        eos_pos = torch.argmax((input_ids == eos_token_id).to(torch.int32), dim=1)
    pooled = x[torch.arange(b, device=x.device), eos_pos]
    return _dense(pooled, {"weight": params["text_projection"]["weight"]})


# ---------------------------------------------------------------------------
# T5 encoder (HF T5EncoderModel semantics)
# ---------------------------------------------------------------------------

def t5_layer_norm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """T5 RMS layer norm (no mean subtraction, no bias) in float32, as
    deepv_tpu computes it (an f64 input too); the weight multiplies after the
    cast back, in the activation dtype."""
    xf = x.to(torch.float32)
    var = xf.square().mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(x.dtype) * weight.to(x.dtype)


def _t5_relative_bucket(rel: np.ndarray, num_buckets: int = 32,
                        max_distance: int = 128) -> np.ndarray:
    """Bidirectional relative position bucketing (HF T5 semantics), in numpy
    so the bucket ids are deepv_tpu's integers."""
    ret = np.zeros_like(rel)
    n = num_buckets // 2
    ret += (rel > 0).astype(np.int64) * n
    rel = np.abs(rel)
    max_exact = n // 2
    is_small = rel < max_exact
    large = max_exact + (
        np.log(np.maximum(rel, 1) / max_exact) / np.log(max_distance / max_exact) * (n - max_exact)
    ).astype(np.int64)
    large = np.minimum(large, n - 1)
    ret += np.where(is_small, rel, large)
    return ret


def t5_position_bias(rel_emb: torch.Tensor, q_len: int, k_len: int,
                     num_buckets: int = 32, max_distance: int = 128) -> torch.Tensor:
    """[1, heads, q, k] additive bias from the layer-0 relative embedding."""
    ctx = np.arange(q_len)[:, None]
    mem = np.arange(k_len)[None, :]
    buckets = _t5_relative_bucket(mem - ctx, num_buckets, max_distance)
    bias = rel_emb[torch.as_tensor(buckets, device=rel_emb.device)]      # [q, k, heads]
    return bias.permute(2, 0, 1)[None]


def t5_attention(p: dict, x: torch.Tensor, bias: torch.Tensor, num_heads: int) -> torch.Tensor:
    b, s, d = x.shape
    inner = p["q"]["weight"].shape[0]
    hd = inner // num_heads
    q = _dense(x, p["q"]).reshape(b, s, num_heads, hd)
    k = _dense(x, p["k"]).reshape(b, s, num_heads, hd)
    v = _dense(x, p["v"]).reshape(b, s, num_heads, hd)
    logits = _einsum_f32("bqhd,bkhd->bhqk", q, k)          # T5 does not scale by sqrt(hd)
    w = torch.softmax(logits + bias, dim=-1).to(v.dtype)
    out = _einsum_f32("bhqk,bkhd->bqhd", w, v).to(v.dtype)
    return _dense(out.reshape(b, s, inner), p["o"])


def t5_encode(params: dict, input_ids: torch.Tensor, attention_mask: torch.Tensor,
              *, num_heads: int, gated_act: bool = True) -> torch.Tensor:
    """input_ids [b, s] -> sequence embeddings [b, s, d] (T5EncoderModel).
    One relative-bias table, block 0's, serves every layer; padded keys get
    -inf."""
    x = params["shared"]["weight"][input_ids]
    b, s, d = x.shape

    block0 = params["encoder"]["block"][0]
    rel_emb = block0["layer"][0]["SelfAttention"]["relative_attention_bias"]["weight"]
    bias = t5_position_bias(rel_emb, s, s)
    pad = torch.where(attention_mask[:, None, None, :] > 0, 0.0, -math.inf).to(torch.float32)
    bias = bias + pad

    for block in params["encoder"]["block"]:
        att = block["layer"][0]
        h = t5_layer_norm(x, att["layer_norm"]["weight"])
        x = x + t5_attention(att["SelfAttention"], h, bias, num_heads)
        ff = block["layer"][1]
        h = t5_layer_norm(x, ff["layer_norm"]["weight"])
        dd = ff["DenseReluDense"]
        if gated_act:
            gate = F.gelu(_dense(h, dd["wi_0"]), approximate="tanh")
            h = _dense(gate * _dense(h, dd["wi_1"]), dd["wo"])
        else:
            h = _dense(F.relu(_dense(h, dd["wi"])), dd["wo"])
        x = x + h

    return t5_layer_norm(x, params["encoder"]["final_layer_norm"]["weight"])


# ---------------------------------------------------------------------------
# the SD3 triple-encoder facade
# ---------------------------------------------------------------------------

class SD3TextEncoder:
    """Tokenise on the host with HF tokenizers, encode the ids with the
    towers on ``device``; ``encoder(prompt)`` returns (prompt_embeds [1, 77,
    4096], prompt_attention_mask [1, 77], pooled_prompt_embeds [1, 2048]),
    the embeddings in ``dtype``. ``params``/``configs`` are keyed "clip_l",
    "clip_g", "t5" (``io/weights.load_text_towers``); deepv_tpu's parameters
    in its order, then ``device``."""

    def __init__(self, model_path: str, params: Dict, configs: Dict,
                 dtype=torch.bfloat16, max_length: int = 77, device="cuda"):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("device='cuda' but no CUDA device is available; "
                               "pass device='cpu' to run on the CPU")
        self.params = params
        self.configs = configs
        self.dtype = dtype
        self.max_length = max_length
        self.load_tokenizers(model_path)

    def load_tokenizers(self, model_path: str) -> None:
        """``tokenizer``, ``tokenizer_2`` (CLIP) and ``tokenizer_3`` (T5-fast)
        from the snapshot."""
        try:
            from transformers import CLIPTokenizer, T5TokenizerFast
        except ImportError as e:
            raise ImportError("SD3TextEncoder tokenises with HF tokenizers: the "
                              "`transformers` package is not installed") from e
        self.tokenizer = CLIPTokenizer.from_pretrained(os.path.join(model_path, "tokenizer"))
        self.tokenizer_2 = CLIPTokenizer.from_pretrained(os.path.join(model_path, "tokenizer_2"))
        self.tokenizer_3 = T5TokenizerFast.from_pretrained(os.path.join(model_path, "tokenizer_3"))

    def tokenize(self, prompt: str):
        """Host step: (CLIP-L ids, CLIP-G ids, T5 ids, T5 mask), each an
        int64 numpy array [1, max_length], padded and truncated."""
        kw = dict(padding="max_length", max_length=self.max_length, truncation=True,
                  return_tensors="np")
        ids_l = self.tokenizer([prompt], **kw).input_ids
        ids_g = self.tokenizer_2([prompt], **kw).input_ids
        tok = self.tokenizer_3([prompt], add_special_tokens=True, **kw)
        return ids_l, ids_g, tok.input_ids, tok.attention_mask

    def encode(self, ids_l, ids_g, ids_t5, mask):
        """Device step: the towers on the ids (numpy or tensors)."""
        as_ids = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.int64, device=self.device)
        pooled = torch.cat([self._clip_pool("clip_l", as_ids(ids_l)),
                            self._clip_pool("clip_g", as_ids(ids_g))], dim=-1)
        mask = as_ids(mask)
        cfg = self.configs["t5"]
        seq = t5_encode(self.params["t5"], as_ids(ids_t5), mask, num_heads=cfg["num_heads"],
                        gated_act=cfg.get("gated_act", True))
        return seq.to(self.dtype), mask, pooled.to(self.dtype)

    def _clip_pool(self, which: str, ids: torch.Tensor) -> torch.Tensor:
        cfg = self.configs[which]
        return clip_encode(self.params[which], ids, num_heads=cfg["num_heads"],
                           act=cfg.get("act", "quick_gelu"),
                           eos_token_id=cfg.get("eos_token_id", 2))

    def __call__(self, prompt: str):
        return self.encode(*self.tokenize(prompt))
