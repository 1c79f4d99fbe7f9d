"""T5 / T5-v1.1 / ByT5 text encoder, its HF weight loader and the ByT5
byte tokenizer (port of custom_diffusion360_tpu/models/t5.py; the sgm
FrozenT5Embedder and FrozenByT5Embedder wrap HF ``T5EncoderModel``).

* RMS norm with f32 statistics (HF T5LayerNorm);
* unscaled attention (T5 folds 1 / sqrt(d_kv) into its init) with one
  relative-position bias, block 0's, shared by every layer, as HF;
* gated-GELU (tanh form) feed-forward for v1.1 / ByT5, ReLU for the
  original T5.

The (L, L) table of relative-position buckets truncates
``log(n / 8) / log(16) * 8`` to an int, which is exactly 2, 4 and 6 at
n = 16, 32 and 64: a ``logf`` one ulp off would move a bucket. So the
table is built once per length on the host, in float32 as the JAX package
builds it, and copied to the tensor's device; the card never evaluates the
logarithm. The attention and the feed-forward are plain PyTorch products
(plain einsums in JAX, no Pallas kernel); the scores and the softmax are
f32.
"""
from __future__ import annotations

import dataclasses
import functools
import math

import numpy as np
import torch
import torch.nn.functional as F

from .. import resolve_device
from .nn import Init, torch_dtype


@dataclasses.dataclass(frozen=True)
class T5Config:
    vocab_size: int = 32128
    d_model: int = 512
    d_kv: int = 64
    d_ff: int = 1024
    num_layers: int = 8
    num_heads: int = 6
    relative_attention_num_buckets: int = 32
    relative_attention_max_distance: int = 128
    gated_ff: bool = True  # v1.1 / ByT5 "gated-gelu"; False: the original T5's ReLU
    layer_norm_eps: float = 1e-6


# the JAX package's constant (google/byt5-base, byte vocabulary of 384 =
# 256 bytes + 3 specials + 125 sentinels); its 12 layers are the JAX
# package's choice, the ByT5 paper's base model has 18 encoder layers
BYT5_BASE = T5Config(vocab_size=384, d_model=1536, d_kv=64, d_ff=3968, num_layers=12,
                     num_heads=12)


def init_t5_params(cfg: T5Config = T5Config(), seed: int = 0, device="cuda",
                   dtype=torch.float32):
    """Seeded random parameters with the JAX tree's structure and HF's
    init scales: embeddings std 1; q std (d_model d_kv)^-1/2, k and v
    d_model^-1/2, o (h d_kv)^-1/2; ff wi d_model^-1/2, wo d_ff^-1/2. The
    draws differ from JAX's."""
    init = Init(seed, resolve_device(device), torch_dtype(dtype))
    inner = cfg.num_heads * cfg.d_kv
    p = {
        "shared": init.normal((cfg.vocab_size, cfg.d_model), 1.0),
        "rel_bias": init.normal((cfg.relative_attention_num_buckets, cfg.num_heads),
                                (inner * cfg.num_layers) ** -0.5),
        "final_norm": init.ones((cfg.d_model,)),
        "blocks": [],
    }
    for _ in range(cfg.num_layers):
        blk = {
            "attn_norm": init.ones((cfg.d_model,)),
            "q": init.normal((cfg.d_model, inner), (cfg.d_model * cfg.d_kv) ** -0.5),
            "k": init.normal((cfg.d_model, inner), cfg.d_model ** -0.5),
            "v": init.normal((cfg.d_model, inner), cfg.d_model ** -0.5),
            "o": init.normal((inner, cfg.d_model), inner ** -0.5),
            "ff_norm": init.ones((cfg.d_model,)),
            "wo": init.normal((cfg.d_ff, cfg.d_model), cfg.d_ff ** -0.5),
        }
        for name in ("wi_0", "wi_1") if cfg.gated_ff else ("wi",):
            blk[name] = init.normal((cfg.d_model, cfg.d_ff), cfg.d_model ** -0.5)
        p["blocks"].append(blk)
    return p


def _rms_norm(w, x, eps):
    xf = x.float()
    var = (xf * xf).mean(-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(x.dtype) * w.to(x.dtype)


def relative_position_bucket(rel, num_buckets: int, max_distance: int):
    """HF T5Attention._relative_position_bucket (bidirectional) of the int
    tensor ``rel`` (key position minus query position), in float32 as the
    JAX package computes it, on ``rel``'s device."""
    nb = num_buckets // 2
    ret = (rel > 0).long() * nb
    n = rel.abs()
    max_exact = nb // 2
    val_large = max_exact + (
        torch.log(n.float() / max_exact + 1e-20)
        / math.log(max_distance / max_exact) * (nb - max_exact)
    ).long()
    return ret + torch.where(n < max_exact, n, val_large.clamp_max(nb - 1))


@functools.lru_cache(maxsize=16)
def relative_position_buckets(seq_len: int, num_buckets: int, max_distance: int):
    """The (L, L) int64 bucket table, built on the host (CPU) and cached per
    length: callers copy it to their device and never write it."""
    pos = torch.arange(seq_len)
    return relative_position_bucket(pos[None, :] - pos[:, None], num_buckets, max_distance)


def position_bias(params, seq_len: int, cfg: T5Config, device):
    """(1, H, L, L) f32 bias: the host-built bucket table on ``device``,
    gathered from ``rel_bias``."""
    bucket = relative_position_buckets(seq_len, cfg.relative_attention_num_buckets,
                                       cfg.relative_attention_max_distance).to(device)
    bias = params["rel_bias"].float()[bucket.reshape(-1)]
    return bias.reshape(seq_len, seq_len, -1).permute(2, 0, 1)[None]


def t5_encode(params, tokens, cfg: T5Config = T5Config(), mask=None, dtype=None):
    """tokens: (B, L) int -> last hidden state (B, L, d_model), HF
    T5EncoderModel at eval. ``mask`` ((B, L), 1 = keep; a tensor or numpy) is
    optional: the reference embedders pass none. Computes in ``dtype`` (default: the
    embedding's)."""
    table = params["shared"]
    dtype = table.dtype if dtype is None else torch_dtype(dtype)
    b, L = tokens.shape
    h = table[tokens.to(table.device).long().reshape(-1)].reshape(b, L, -1).to(dtype)
    bias = position_bias(params, L, cfg, h.device)
    if mask is not None:
        neg = torch.finfo(torch.float32).min
        keep = torch.as_tensor(mask, device=h.device).bool()[:, None, None, :]
        bias = bias + torch.where(keep, 0.0, neg)

    nh, dk = cfg.num_heads, cfg.d_kv
    for blk in params["blocks"]:
        x = _rms_norm(blk["attn_norm"], h, cfg.layer_norm_eps)
        q = (x @ blk["q"].to(dtype)).reshape(b, L, nh, dk)
        k = (x @ blk["k"].to(dtype)).reshape(b, L, nh, dk)
        v = (x @ blk["v"].to(dtype)).reshape(b, L, nh, dk)
        scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) + bias
        w = torch.softmax(scores, dim=-1).to(dtype)
        a = torch.einsum("bhqk,bkhd->bqhd", w, v).reshape(b, L, nh * dk)
        h = h + a @ blk["o"].to(dtype)

        x = _rms_norm(blk["ff_norm"], h, cfg.layer_norm_eps)
        if cfg.gated_ff:
            x = F.gelu(x @ blk["wi_0"].to(dtype), approximate="tanh") * (x @ blk["wi_1"].to(dtype))
        else:
            x = F.relu(x @ blk["wi"].to(dtype))
        h = h + x @ blk["wo"].to(dtype)
    return _rms_norm(params["final_norm"], h, cfg.layer_norm_eps)


def load_t5_torch(state_dict, cfg: T5Config = T5Config(), device="cuda",
                  dtype=torch.float32):
    """HF ``T5EncoderModel.state_dict()`` (tensors or numpy) -> parameters
    on ``device``; linear weights transpose to (in, out)."""
    device = resolve_device(device)
    dtype = torch_dtype(dtype)

    def arr(name, transpose=False):
        v = state_dict[name]
        v = v.detach().cpu() if hasattr(v, "detach") else torch.from_numpy(np.asarray(v))
        v = v.float()
        return (v.t() if transpose else v).contiguous().to(device, dtype)

    p = {
        "shared": arr("shared.weight"),
        "rel_bias": arr("encoder.block.0.layer.0.SelfAttention.relative_attention_bias.weight"),
        "final_norm": arr("encoder.final_layer_norm.weight"),
        "blocks": [],
    }
    for i in range(cfg.num_layers):
        pre = f"encoder.block.{i}.layer"
        blk = {
            "attn_norm": arr(f"{pre}.0.layer_norm.weight"),
            "q": arr(f"{pre}.0.SelfAttention.q.weight", True),
            "k": arr(f"{pre}.0.SelfAttention.k.weight", True),
            "v": arr(f"{pre}.0.SelfAttention.v.weight", True),
            "o": arr(f"{pre}.0.SelfAttention.o.weight", True),
            "ff_norm": arr(f"{pre}.1.layer_norm.weight"),
        }
        for name in ("wi_0", "wi_1") if cfg.gated_ff else ("wi",):
            blk[name] = arr(f"{pre}.1.DenseReluDense.{name}.weight", True)
        blk["wo"] = arr(f"{pre}.1.DenseReluDense.wo.weight", True)
        p["blocks"].append(blk)
    return p


def byt5_tokenize(texts, max_length: int = 77):
    """UTF-8 byte tokenizer: id = byte + 3 (0 pad, 1 eos, 2 unk), truncated
    to max_length - 1, eos appended, padded with 0 (HF ByT5Tokenizer with
    padding="max_length", truncation=True). Returns (ids, mask), int32
    numpy (B, max_length). The sentencepiece T5 tokenizer needs its
    ``.model`` file: give ``t5_encode`` token ids for that variant."""
    if isinstance(texts, str):
        texts = [texts]
    ids = np.zeros((len(texts), max_length), np.int32)
    mask = np.zeros((len(texts), max_length), np.int32)
    for r, text in enumerate(texts):
        row = [b + 3 for b in text.encode("utf-8")[: max_length - 1]] + [1]
        ids[r, : len(row)] = row
        mask[r, : len(row)] = 1
    return ids, mask
