"""The port's general conditioner (models/general_conditioner.py) against the
JAX package's, on the CPU in float32: the SDXL stack (CLIP-L, OpenCLIP
bigG with its pooled output, three size embedders; target and reference
rows) against JAX's general conditioner and against the port's specialized
``apply_conditioner``, with the reference rows forced out, and the (c, uc)
pair; routing by rank to "vector" / "crossattn" / "concat"; the
per-embedder UCG masks replayed from JAX's key splits as the draws
``ucg/<name>``, also for a tuple-returning embedder; ``force_zero``;
``possibly_apply_legacy_ucg`` drawing the same numpy numbers as JAX; the
split at the target's row count where the halves differ; the spec checks.

Tolerance: max-abs error within 1e-5 of max|want|; routing, masks and the
legacy substitution exactly.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from custom_diffusion360_tpu.models import clip as jclip
from custom_diffusion360_tpu.models import conditioner as jcond
from custom_diffusion360_tpu.models import general_conditioner as jgc
from custom_diffusion360_torch.draws import Draws
from custom_diffusion360_torch.models import clip as tclip
from custom_diffusion360_torch.models import conditioner as tcond
from custom_diffusion360_torch.models import general_conditioner as tgc
from tests.test_torch_common import max_err, random_params, t, to_torch
from tests.test_torch_common import torch_threads  # noqa: F401  (fixture)

pytestmark = pytest.mark.usefixtures("torch_threads")

# tests/test_general_conditioner.py's tiny towers
TINY_L = dict(vocab_size=64, width=32, layers=2, heads=4, context_length=8)
TINY_G = dict(vocab_size=64, width=48, layers=2, heads=4, context_length=8, act="gelu",
              text_projection=True)
SIZE_OUTDIM = 16


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


def _rel(got, want):
    want = _np(want)
    return max_err(_np(got), want) / max(float(np.abs(want).max()), 1e-12)


def _sdxl_specs(pkg):
    """The SDXL stack as general-conditioner specs, in either package."""
    clip, cond, gc = (jclip, jcond, jgc) if pkg == "jax" else (tclip, tcond, tgc)
    cfg_l, cfg_g = clip.ClipTextConfig(**TINY_L), clip.ClipTextConfig(**TINY_G)

    def clip_l(p, tokens):
        return clip.clip_text_apply(p, tokens, cfg_l)["final"]

    def open_clip(p, tokens):
        out = clip.clip_text_apply(p, tokens, cfg_g)
        return out["penultimate"], out["pooled"]

    def size(_, x):
        return cond.embed_size_tuple(x, SIZE_OUTDIM)

    return [gc.EmbedderSpec("clip_l", clip_l, input_keys=("tokens_clip", "tokens_clip_ref")),
            gc.EmbedderSpec("open_clip", open_clip,
                            input_keys=("tokens_open", "tokens_open_ref"))] + [
        gc.EmbedderSpec(name, size, input_keys=(key, key + "_ref"))
        for name, key in (("size_orig", "original_size"), ("size_crop", "crop_coords"),
                          ("size_tgt", "target_size"))]


def _batch(b=2, n=3):
    rng = np.random.default_rng(0)
    batch = {}
    for key in ("tokens_clip", "tokens_open"):
        batch[key] = rng.integers(0, 60, (b, 8)).astype(np.int32)
        batch[key + "_ref"] = rng.integers(0, 60, (b * n, 8)).astype(np.int32)
    for key in ("original_size", "crop_coords", "target_size"):
        batch[key] = rng.uniform(256, 1024, (b, 2)).astype(np.float32)
        batch[key + "_ref"] = rng.uniform(256, 1024, (b * n, 2)).astype(np.float32)
    return batch


@pytest.fixture(scope="module")
def stack():
    jcfg = jcond.ConditionerConfig(clip_l=jclip.ClipTextConfig(**TINY_L),
                                   open_clip=jclip.ClipTextConfig(**TINY_G),
                                   size_outdim=SIZE_OUTDIM)
    p = random_params(lambda k: jcond.init_conditioner_params(k, jcfg), seed=1)
    tcfg = tcond.ConditionerConfig(clip_l=tclip.ClipTextConfig(**TINY_L),
                                   open_clip=tclip.ClipTextConfig(**TINY_G),
                                   size_outdim=SIZE_OUTDIM)
    batch = _batch()
    return (p, jcfg, {k: jnp.asarray(v) for k, v in batch.items()},
            to_torch(p), tcfg, {k: t(v) for k, v in batch.items()})


def _agree(got, *wants):
    for want in wants:
        assert set(got) == set(want)
        for k in want:
            assert tuple(got[k].shape) == tuple(want[k].shape) and _rel(got[k], want[k]) < 1e-5, k


@pytest.mark.parametrize("force_ref_zero", [False, True])
def test_sdxl_stack_matches_jax_and_the_specialized_conditioner(stack, force_ref_zero):
    p, jcfg, jbatch, tp, tcfg, tbatch = stack
    want_general = jgc.general_conditioner_apply(p, _sdxl_specs("jax"), jbatch,
                                                 force_ref_zero_embeddings=force_ref_zero)
    want_special = tcond.apply_conditioner(tp, tbatch, tcfg, ref=not force_ref_zero)
    got = tgc.general_conditioner_apply(tp, _sdxl_specs("torch"), tbatch,
                                        force_ref_zero_embeddings=force_ref_zero)
    rows = 2 if force_ref_zero else 8
    assert tuple(got["crossattn"].shape) == (rows, 8, 32 + 48)
    assert tuple(got["vector"].shape) == (rows, 48 + 3 * 2 * SIZE_OUTDIM)
    _agree(got, want_general, want_special)


def test_uc_pair_matches_jax_and_the_specialized_conditioner(stack):
    p, _, jbatch, tp, tcfg, tbatch = stack
    zero = ["tokens_clip", "tokens_open"]
    want_c, want_uc = jgc.general_get_unconditional_conditioning(
        p, _sdxl_specs("jax"), jbatch, force_uc_zero_embeddings=zero,
        force_ref_zero_embeddings=True)
    spec_c, spec_uc = tcond.get_unconditional_conditioning(tp, tbatch, cfg=tcfg, ref=False)
    got_c, got_uc = tgc.general_get_unconditional_conditioning(
        tp, _sdxl_specs("torch"), tbatch, force_uc_zero_embeddings=zero,
        force_ref_zero_embeddings=True)
    _agree(got_c, want_c, spec_c)
    _agree(got_uc, want_uc, spec_uc)
    assert float(got_uc["crossattn"].abs().max()) == 0.0


@pytest.mark.parametrize("concat_rank", [4, 5])
def test_routing_by_rank(concat_rank):
    specs = {pkg: [gc.EmbedderSpec("img", lambda _, x: x, input_key="lowres"),
                   gc.EmbedderSpec("vec", lambda _, x: x, input_key="cls"),
                   gc.EmbedderSpec("seq", lambda _, x: (x, x[:, 0]), input_key="tokens")]
             for pkg, gc in (("jax", jgc), ("torch", tgc))}
    rng = np.random.default_rng(1)
    lowres = (2, 4, 4, 3) if concat_rank == 4 else (2, 1, 4, 4, 3)
    batch = {"lowres": rng.normal(size=lowres), "cls": rng.normal(size=(2, 8)),
             "tokens": rng.normal(size=(2, 5, 6))}
    batch = {k: v.astype(np.float32) for k, v in batch.items()}
    want = jgc.general_conditioner_apply({}, specs["jax"],
                                         {k: jnp.asarray(v) for k, v in batch.items()})
    got = tgc.general_conditioner_apply({}, specs["torch"], {k: t(v) for k, v in batch.items()})
    assert tuple(got["vector"].shape) == (2, 8 + 6)
    assert tuple(got["crossattn"].shape) == (2, 5, 6) and tuple(got["concat"].shape) == lowres
    _agree(got, want)


def test_routing_concat():
    rng = np.random.default_rng(2)
    x4 = rng.normal(size=(2, 4, 4, 3)).astype(np.float32)
    for gc, arr in ((jgc, jnp.asarray), (tgc, t)):
        specs = [gc.EmbedderSpec("a", lambda _, x: x, input_key="lowres"),
                 gc.EmbedderSpec("b", lambda _, x: 2 * x, input_key="lowres")]
        out = gc.general_conditioner_apply({}, specs, {"lowres": arr(x4)})
        assert tuple(out["concat"].shape) == (2, 4, 4, 6)
        np.testing.assert_array_equal(_np(out["concat"])[..., 3:], 2 * x4)


def test_ucg_masks_replay_jax_keys():
    """One uniform draw a spec, ucg/<name>: JAX's split(key, n_specs)[i]
    bernoulli, shared by a tuple-returning embedder's outputs."""
    x = np.ones((16, 4), np.float32)
    seq = np.ones((16, 3, 5), np.float32)
    specs = {pkg: [gc.EmbedderSpec("a", lambda _, v: v, input_key="v", ucg_rate=0.5),
                   gc.EmbedderSpec("b", lambda _, v: (v, v[:, 0]), input_key="s", ucg_rate=0.3),
                   gc.EmbedderSpec("c", lambda _, v: v, input_key="v")]
             for pkg, gc in (("jax", jgc), ("torch", tgc))}
    key = jax.random.PRNGKey(0)
    want = jgc.general_conditioner_apply({}, specs["jax"], {"v": jnp.asarray(x),
                                                            "s": jnp.asarray(seq)}, key=key)
    keys = jax.random.split(key, 3)
    given = {f"ucg/{name}": t(jax.random.uniform(k, (16,), jnp.float32))
             for name, k in zip("ab", keys[:2])}
    got = tgc.general_conditioner_apply({}, specs["torch"], {"v": t(x), "s": t(seq)},
                                        draws=Draws(given=given))
    for k in want:
        np.testing.assert_array_equal(_np(got[k]), np.asarray(want[k]))
    rows = _np(got["vector"])[:, :4]
    assert (rows == 0).all(-1).any() and (rows == 1).all(-1).any()
    with pytest.raises(ValueError, match="ucg"):
        tgc.general_conditioner_apply({}, specs["torch"], {"v": t(x), "s": t(seq)})


def test_force_zero_embeddings():
    """An embedder whose (first) input key is forced to zero gives zeros;
    the others are untouched."""
    x = np.arange(12, dtype=np.float32).reshape(4, 3)
    for gc, arr in ((jgc, jnp.asarray), (tgc, t)):
        specs = [gc.EmbedderSpec("e", lambda _, v: v, input_keys=("v", "v_ref")),
                 gc.EmbedderSpec("f", lambda _, v: v, input_keys=("w", "w_ref"))]
        batch = {"v": arr(x), "v_ref": arr(x), "w": arr(x), "w_ref": arr(2 * x)}
        out = _np(gc.general_conditioner_apply({}, specs, batch,
                                               force_zero_embeddings=["v"])["vector"])
        assert out.shape == (8, 6) and (out[:, :3] == 0).all()
        np.testing.assert_array_equal(out[:, 3:], np.concatenate([x, 2 * x]))


def test_paired_split_at_the_target_rows():
    """Target 2 rows, reference 6: split at 2, not halved."""
    specs = {pkg: [gc.EmbedderSpec("e", lambda _, v: v, input_keys=("a", "a_ref")),
                   gc.EmbedderSpec("f", lambda _, v: -v, input_keys=("a", "a_ref"))]
             for pkg, gc in (("jax", jgc), ("torch", tgc))}
    rng = np.random.default_rng(3)
    a, a_ref = rng.normal(size=(2, 3)).astype(np.float32), rng.normal(size=(6, 3)).astype(
        np.float32)
    want = jgc.general_conditioner_apply({}, specs["jax"], {"a": jnp.asarray(a),
                                                            "a_ref": jnp.asarray(a_ref)})
    got = tgc.general_conditioner_apply({}, specs["torch"], {"a": t(a), "a_ref": t(a_ref)})
    np.testing.assert_array_equal(_np(got["vector"]), np.asarray(want["vector"]))
    np.testing.assert_array_equal(_np(got["vector"])[:2, :3], a)
    np.testing.assert_array_equal(_np(got["vector"])[2:, 3:], -a_ref)


@pytest.mark.parametrize("rate", [0.0, 0.4, 1.0])
def test_legacy_ucg_val_draws_as_jax(rate):
    batch = {"txt": [f"prompt {i}" for i in range(12)]}
    want = jgc.possibly_apply_legacy_ucg(
        jgc.EmbedderSpec("e", lambda _, v: v, input_key="txt", ucg_rate=rate,
                         legacy_ucg_val=""), batch, np.random.default_rng(5))
    got = tgc.possibly_apply_legacy_ucg(
        tgc.EmbedderSpec("e", lambda _, v: v, input_key="txt", ucg_rate=rate,
                         legacy_ucg_val=""), batch, np.random.default_rng(5))
    assert got == want and batch["txt"][0] == "prompt 0"
    spec = tgc.EmbedderSpec("e", lambda _, v: v, input_key="txt", ucg_rate=rate)
    assert tgc.possibly_apply_legacy_ucg(spec, batch, np.random.default_rng(5)) is batch


def test_spec_validation():
    with pytest.raises(ValueError):
        tgc.EmbedderSpec("bad", lambda _, x: x)
    with pytest.raises(ValueError):
        tgc.EmbedderSpec("bad", lambda _, x: x, input_key="a", input_keys=("a", "b"))
    assert tgc.OUTPUT_DIM2KEYS == jgc.OUTPUT_DIM2KEYS
    spec = tgc.EmbedderSpec("ok", lambda _, x: x, input_key="a", ucg_rate=0.2)
    assert dataclasses.replace(spec, ucg_rate=0.0).ucg_rate == 0.0
