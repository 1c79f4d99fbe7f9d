"""The port's T5 / ByT5 encoder (models/t5.py) against the JAX package, on
the CPU in float32: ``t5_encode`` gated and ReLU, with and without a mask,
at 77 tokens (every bucket kind); the relative-position bucket table at
L = 77, 512 and 1024 equal to JAX's; ``load_t5_torch`` on a synthetic
HF-named state dict equal to JAX's loader carried by ``from_jax_params``;
``byt5_tokenize`` ids and masks equal; ``init_t5_params``' structure and
``BYT5_BASE``. (tests/test_t5.py holds the JAX encoder to HF
``T5EncoderModel``.)

Tolerance: max-abs error within 1e-5 of max|want|; loaders, buckets and
tokens exactly.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from custom_diffusion360_tpu.models import t5 as jt5
from custom_diffusion360_torch.models import t5 as tt5
from tests.test_torch_common import max_err, random_params, t, to_torch
from tests.test_torch_common import torch_threads  # noqa: F401  (fixture)

pytestmark = pytest.mark.usefixtures("torch_threads")

TINY = dict(vocab_size=99, d_model=32, d_kv=8, d_ff=64, num_layers=3, num_heads=4)


def _rel(got, want):
    want = np.asarray(want, np.float32)
    return max_err(got.detach().numpy(), want) / max(float(np.abs(want).max()), 1e-12)


def _tokens(seed, b, L, vocab):
    return np.random.default_rng(seed).integers(0, vocab, (b, L)).astype(np.int32)


@pytest.mark.parametrize("gated", [True, False])
@pytest.mark.parametrize("masked", [False, True])
def test_t5_encode_matches_jax(gated, masked):
    kw = dict(TINY, gated_ff=gated)
    jcfg, tcfg = jt5.T5Config(**kw), tt5.T5Config(**kw)
    p = random_params(lambda k: jt5.init_t5_params(k, jcfg), seed=1)
    tokens = _tokens(2, 2, 77, 99)
    mask = None
    if masked:
        mask = np.ones((2, 77), np.int32)
        mask[0, 40:] = 0
        mask[1, 70:] = 0
    want = jt5.t5_encode(p, jnp.asarray(tokens), jcfg,
                         mask=None if mask is None else jnp.asarray(mask))
    got = tt5.t5_encode(to_torch(p), t(tokens), tcfg, mask=mask)
    assert tuple(got.shape) == want.shape == (2, 77, 32)
    assert _rel(got, want) < 1e-5


@pytest.mark.parametrize("seq_len", [77, 512, 1024])
@pytest.mark.parametrize("buckets,max_distance", [(32, 128), (8, 16)])
def test_bucket_table_matches_jax(seq_len, buckets, max_distance):
    pos = jnp.arange(seq_len)
    want = jt5._relative_position_bucket(pos[None, :] - pos[:, None], buckets, max_distance)
    got = tt5.relative_position_buckets(seq_len, buckets, max_distance)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # past the max distance every bucket but "after, at distance 0" is used
    if seq_len >= max_distance:
        assert set(np.unique(got.numpy())) == set(range(buckets)) - {buckets // 2}


def test_position_bias_is_the_host_table_gathered():
    cfg = tt5.T5Config(**TINY)
    p = {"rel_bias": torch.randn(cfg.relative_attention_num_buckets, cfg.num_heads)}
    bias = tt5.position_bias(p, 77, cfg, "cpu")
    table = tt5.relative_position_buckets(77, 32, 128)
    assert tuple(bias.shape) == (1, 4, 77, 77)
    torch.testing.assert_close(bias[0].permute(1, 2, 0), p["rel_bias"][table], rtol=0, atol=0)


def _hf_state_dict(cfg, gated, seed=3):
    """A synthetic HF T5EncoderModel state dict ((out, in) linear weights)."""
    rng = np.random.default_rng(seed)
    inner = cfg.num_heads * cfg.d_kv

    def w(*shape):
        return torch.from_numpy(rng.normal(size=shape).astype(np.float32))

    sd = {"shared.weight": w(cfg.vocab_size, cfg.d_model),
          "encoder.embed_tokens.weight": w(cfg.vocab_size, cfg.d_model),
          "encoder.final_layer_norm.weight": w(cfg.d_model),
          "encoder.block.0.layer.0.SelfAttention.relative_attention_bias.weight":
              w(cfg.relative_attention_num_buckets, cfg.num_heads)}
    for i in range(cfg.num_layers):
        pre = f"encoder.block.{i}.layer"
        sd.update({f"{pre}.0.layer_norm.weight": w(cfg.d_model),
                   f"{pre}.0.SelfAttention.q.weight": w(inner, cfg.d_model),
                   f"{pre}.0.SelfAttention.k.weight": w(inner, cfg.d_model),
                   f"{pre}.0.SelfAttention.v.weight": w(inner, cfg.d_model),
                   f"{pre}.0.SelfAttention.o.weight": w(cfg.d_model, inner),
                   f"{pre}.1.layer_norm.weight": w(cfg.d_model),
                   f"{pre}.1.DenseReluDense.wo.weight": w(cfg.d_model, cfg.d_ff)})
        for name in ("wi_0", "wi_1") if gated else ("wi",):
            sd[f"{pre}.1.DenseReluDense.{name}.weight"] = w(cfg.d_ff, cfg.d_model)
    return sd


@pytest.mark.parametrize("gated", [True, False])
def test_load_t5_torch_matches_jax(gated):
    kw = dict(TINY, gated_ff=gated)
    sd = _hf_state_dict(tt5.T5Config(**kw), gated)
    want = to_torch(jax.tree.map(np.asarray, jt5.load_t5_torch(sd, jt5.T5Config(**kw))))
    got = tt5.load_t5_torch(sd, tt5.T5Config(**kw), device="cpu")
    want_leaves, want_tree = jax.tree.flatten(want)
    got_leaves, got_tree = jax.tree.flatten(got)
    assert got_tree == want_tree
    for a, b in zip(got_leaves, want_leaves):
        assert torch.equal(a, b)
    # numpy state dicts load the same
    np_sd = {k: v.numpy() for k, v in sd.items()}
    for a, b in zip(jax.tree.leaves(tt5.load_t5_torch(np_sd, tt5.T5Config(**kw), "cpu")),
                    got_leaves):
        assert torch.equal(a, b)


def test_byt5_tokenize_matches_jax():
    texts = ["a photo of a car", "", "héllo wörld ✓ 日本", "x" * 200]
    for max_length in (77, 16):
        want_ids, want_mask = jt5.byt5_tokenize(texts, max_length)
        got_ids, got_mask = tt5.byt5_tokenize(texts, max_length)
        assert got_ids.dtype == want_ids.dtype == np.int32
        np.testing.assert_array_equal(got_ids, want_ids)
        np.testing.assert_array_equal(got_mask, want_mask)
    ids, mask = tt5.byt5_tokenize("ab")
    assert ids.shape == (1, 77) and list(ids[0, :3]) == [ord("a") + 3, ord("b") + 3, 1]
    assert mask.sum() == 3


def test_init_t5_params_structure_and_byt5_constant():
    for gated in (True, False):
        kw = dict(TINY, gated_ff=gated)
        got = jax.tree.map(np.asarray, tt5.init_t5_params(tt5.T5Config(**kw), device="cpu"))
        want = jax.eval_shape(lambda k: jt5.init_t5_params(k, jt5.T5Config(**kw)),
                              jax.random.PRNGKey(0))
        assert jax.tree.structure(got) == jax.tree.structure(want)
        assert [a.shape for a in jax.tree.leaves(got)] == [b.shape for b in jax.tree.leaves(want)]
    assert dataclasses.asdict(tt5.BYT5_BASE) == dataclasses.asdict(jt5.BYT5_BASE)
    assert dataclasses.asdict(tt5.T5Config()) == dataclasses.asdict(jt5.T5Config())
