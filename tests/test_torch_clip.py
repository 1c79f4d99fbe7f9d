"""Text towers and the SDXL conditioner of the port vs the JAX package, on
the CPU in float32: CLIP-L-style (quick_gelu, ``final``) and bigG-style
(gelu, ``penultimate`` + ``pooled``) towers at tiny widths, with V* ids
(>= vocab_size) reading ``modifier_rows``, and ``apply_conditioner(ref=True)``
with the target rows first. Tolerance 2e-5 relative to max|ref| (f32 on
both sides); the V* rows' gradient 1e-5 of its max|g|.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from custom_diffusion360_tpu.models import clip as jclip
from custom_diffusion360_tpu.models import conditioner as jcond
from custom_diffusion360_torch.models import clip as tclip
from custom_diffusion360_torch.models import conditioner as tcond
from tests.test_torch_common import max_err, random_params, t, to_torch
from tests.test_torch_common import torch_threads  # noqa: F401  (fixture)

pytestmark = pytest.mark.usefixtures("torch_threads")

VOCAB, T = 64, 16
L_CFG = dict(vocab_size=VOCAB, width=48, layers=1, heads=4, context_length=T)
G_CFG = dict(vocab_size=VOCAB, width=64, layers=3, heads=4, context_length=T, act="gelu",
             text_projection=True)
TOL = 2e-5


def tokens(m, seed):
    """Ids below the vocab with the V* id (= vocab_size) at position 2, the
    highest real id (the eot) at 5, zero padding after."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(1, VOCAB - 1, size=(m, T)).astype(np.int32)
    toks[:, 2] = VOCAB
    toks[:, 5] = VOCAB - 1
    toks[:, 6:] = 0
    return toks


def _rel(got, want):
    return max_err(got, want) / max(float(np.abs(np.asarray(want)).max()), 1e-12)


@pytest.mark.parametrize("cfg", [L_CFG, G_CFG], ids=["clip_l", "bigg"])
def test_clip_text_matches_jax(cfg):
    jcfg, tcfg = jclip.ClipTextConfig(**cfg), tclip.ClipTextConfig(**cfg)
    params = random_params(lambda k: jclip.init_clip_text_params(k, jcfg), seed=1)
    toks = tokens(3, 0)
    want = jclip.clip_text_apply(jax.tree.map(jnp.asarray, params), jnp.asarray(toks), jcfg)
    got = tclip.clip_text_apply(to_torch(params), t(toks), tcfg)
    for name in ("last", "penultimate", "final", "pooled"):
        if want[name] is None:
            assert got[name] is None
            continue
        assert got[name].shape == want[name].shape
        assert _rel(got[name], want[name]) < TOL, name


def test_modifier_rows_gradient_matches_jax():
    """The V* rows are the conditioner's only trainable leaf: their gradient
    through bigG's penultimate state and pooled output."""
    jcfg, tcfg = jclip.ClipTextConfig(**G_CFG), tclip.ClipTextConfig(**G_CFG)
    params = random_params(lambda k: jclip.init_clip_text_params(k, jcfg), seed=2)
    toks = tokens(2, 1)

    def jloss(rows):
        p = dict(jax.tree.map(jnp.asarray, params), modifier_rows=rows)
        out = jclip.clip_text_apply(p, jnp.asarray(toks), jcfg)
        return jnp.sum(out["penultimate"] ** 2) + jnp.sum(out["pooled"])

    want = jax.grad(jloss)(jnp.asarray(params["modifier_rows"]))
    p = to_torch(params)
    p["modifier_rows"].requires_grad_(True)
    out = tclip.clip_text_apply(p, t(toks), tcfg)
    (out["penultimate"].square().sum() + out["pooled"].sum()).backward()
    g = np.asarray(want)
    assert float(np.abs(g).max()) > 0
    assert max_err(p["modifier_rows"].grad, g) <= 1e-5 * float(np.abs(g).max())
    assert p["token_embedding"].grad is None


def test_init_modifier_rows_copies_a_token_row():
    p = {"token_embedding": torch.arange(12.0).reshape(6, 2), "modifier_rows": torch.zeros(1, 2)}
    got = tclip.init_modifier_rows(p, (4,))
    assert torch.equal(got["modifier_rows"], p["token_embedding"][4:5])
    got["modifier_rows"] += 1  # a copy, not a view of the table
    assert float(p["token_embedding"][4, 0]) == 8.0


def test_apply_conditioner_ref_rows_match_jax():
    jcfg = jcond.ConditionerConfig(clip_l=jclip.ClipTextConfig(**L_CFG),
                                   open_clip=jclip.ClipTextConfig(**G_CFG), size_outdim=4)
    tcfg = tcond.ConditionerConfig(clip_l=tclip.ClipTextConfig(**L_CFG),
                                   open_clip=tclip.ClipTextConfig(**G_CFG), size_outdim=4)
    params = random_params(lambda k: jcond.init_conditioner_params(k, jcfg), seed=3)
    b, n = 2, 3
    rng = np.random.default_rng(4)
    batch = {
        "tokens_clip": tokens(b, 5), "tokens_open": tokens(b, 6),
        "tokens_clip_ref": tokens(b * n, 7), "tokens_open_ref": tokens(b * n, 8),
    }
    for key, m in (("", b), ("_ref", b * n)):
        batch["original_size" + key] = rng.integers(256, 1024, size=(m, 2)).astype(np.float32)
        batch["crop_coords" + key] = rng.integers(0, 64, size=(m, 2)).astype(np.float32)
        batch["target_size" + key] = np.full((m, 2), 512.0, np.float32)
    want = jcond.apply_conditioner(jax.tree.map(jnp.asarray, params),
                                   {k: jnp.asarray(v) for k, v in batch.items()}, jcfg, ref=True)
    got = tcond.apply_conditioner(to_torch(params), {k: t(v) for k, v in batch.items()}, tcfg,
                                  ref=True)
    assert got["crossattn"].shape == (b * (1 + n), T, L_CFG["width"] + G_CFG["width"])
    assert got["vector"].shape == (b * (1 + n), G_CFG["width"] + 3 * 2 * 4)
    for name in ("crossattn", "vector"):
        assert _rel(got[name], want[name]) < TOL, name
    # the target rows come first: they equal the conditioner without refs
    alone = tcond.apply_conditioner(to_torch(params), {k: t(v) for k, v in batch.items()},
                                    tcfg, ref=False)
    assert max_err(got["crossattn"][:b], alone["crossattn"]) == 0.0
