"""The evaluation slice of the port against the JAX package, CPU, float32:
the antialiased resize (ops/image_resize.py) against ``jax.image.resize``,
the CLIP vision tower and its torch loaders, the CLIP image preprocess,
the FID InceptionV3 and its pytorch_fid loader, the FID statistics, and the
CLIP-T / CLIP-I scores.

Inputs are seeded numpy arrays; towers are small (width 160 with two heads
of 80, the ViT-H/14 head dimension) except Inception, whose widths are
fixed, run by JAX once per module (a module fixture) at 75 x 75, the
smallest input it takes, and once through its resize to 299 x 299.
Parameters come from synthetic torch-named state dicts, read by both
packages' loaders.

Tolerances: the resize 1e-5 absolute (float32 products of the same
weights, in another order); the vision tower and the CLIP scores 1e-5 of
max|ref| (as the text towers, tests/test_torch_clip.py); Inception 1e-4 of
max|ref| (94 convolutions and batch norms in float32); FID 1e-9 relative
(both float64 numpy); loaders exact.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from custom_diffusion360_tpu.eval.clip_score import clip_image_similarity as j_clip_i
from custom_diffusion360_tpu.eval.clip_score import clip_score as j_clip_t
from custom_diffusion360_tpu.eval import fid as jfid
from custom_diffusion360_tpu.eval import inception as jinc
from custom_diffusion360_tpu.models import clip as jclip
from custom_diffusion360_tpu.models import embedders as jemb
from custom_diffusion360_torch.eval.clip_score import clip_image_similarity as t_clip_i
from custom_diffusion360_torch.eval.clip_score import clip_score as t_clip_t
from custom_diffusion360_torch.eval.clip_score import clip_text_embed
from custom_diffusion360_torch.eval import fid as tfid
from custom_diffusion360_torch.eval import inception as tinc
from custom_diffusion360_torch.models import clip as tclip
from custom_diffusion360_torch.models import embedders as temb
from custom_diffusion360_torch.ops.image_resize import resize_images
from tests.test_torch_common import max_err, random_params, to_torch
from tests.test_torch_common import torch_threads  # noqa: F401  (fixture)

pytestmark = pytest.mark.usefixtures("torch_threads")

VISION = dict(image_size=28, patch_size=14, width=160, layers=2, heads=2, embed_dim=32)
TEXT = dict(vocab_size=600, width=32, layers=2, heads=4, context_length=77, act="gelu",
            text_projection=True, num_modifier_tokens=0)


def _rel(got, want, tol):
    return max_err(got, want) <= tol * float(np.abs(np.asarray(want)).max())


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], path + (k,))
    else:
        yield path, np.asarray(tree)


def _same_tree(got, want):
    got, want = dict(_leaves(got)), dict(_leaves(want))
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].shape == want[k].shape and np.array_equal(got[k], want[k]), k


# ---------------------------------------------------------------------------
# synthetic torch-named checkpoints (shared with test_torch_evaluate_cli.py)
# ---------------------------------------------------------------------------


def inception_state_dict(seed=0):
    """pytorch_fid InceptionV3 names, random weights, non-trivial batch
    norms (running variance in [0.5, 1.5])."""
    rng = np.random.default_rng(seed)
    sd = {}

    def conv(prefix, cin, cout, kh, kw):
        sd[prefix + ".conv.weight"] = (rng.normal(size=(cout, cin, kh, kw))
                                       / np.sqrt(cin * kh * kw)).astype(np.float32)
        sd[prefix + ".bn.weight"] = (1 + 0.1 * rng.normal(size=cout)).astype(np.float32)
        sd[prefix + ".bn.bias"] = (0.1 * rng.normal(size=cout)).astype(np.float32)
        sd[prefix + ".bn.running_mean"] = (0.1 * rng.normal(size=cout)).astype(np.float32)
        sd[prefix + ".bn.running_var"] = rng.uniform(0.5, 1.5, size=cout).astype(np.float32)

    for name, cin, cout, (kh, kw), _, _ in jinc._STEM:
        conv(name, cin, cout, kh, kw)
    for bname, kind, spec in jinc.BLOCKS:
        for branch, convs in spec.items():
            for tname, (cin, cout, (kh, kw), _, _) in zip(jinc._TORCH_NAMES[kind][branch], convs):
                conv(f"{bname}.{tname}", cin, cout, kh, kw)
    return {k: torch.from_numpy(v) for k, v in sd.items()}


def open_clip_state_dict(vision, text=None, seed=0, naming="open_clip"):
    """open_clip ViT names (``visual.*``, the packed ``in_proj``) and, with
    ``text``, the text tower's names at the root; or HuggingFace
    CLIPVisionModelWithProjection names (``naming="hf"``)."""
    rng = np.random.default_rng(seed)
    sd = {}

    def put(name, *shape, scale=None):
        x = rng.normal(size=shape).astype(np.float32)
        sd[name] = x * (scale if scale is not None else shape[-1] ** -0.5)

    def norm(prefix, d):
        sd[prefix + ".weight"] = (1 + 0.1 * rng.normal(size=d)).astype(np.float32)
        sd[prefix + ".bias"] = (0.1 * rng.normal(size=d)).astype(np.float32)

    def lin(prefix, din, dout):
        put(prefix + ".weight", dout, din)
        put(prefix + ".bias", dout, scale=0.1)

    v = vision
    d, p, n_tok = v.width, v.patch_size, v.grid ** 2 + 1
    if naming == "open_clip":
        put("visual.conv1.weight", d, 3, p, p, scale=0.02)
        put("visual.class_embedding", d)
        put("visual.positional_embedding", n_tok, d)
        norm("visual.ln_pre", d)
        norm("visual.ln_post", d)
        put("visual.proj", d, v.embed_dim)
        for i in range(v.layers):
            pre = f"visual.transformer.resblocks.{i}"
            norm(pre + ".ln_1", d)
            norm(pre + ".ln_2", d)
            put(pre + ".attn.in_proj_weight", 3 * d, d)
            put(pre + ".attn.in_proj_bias", 3 * d, scale=0.1)
            lin(pre + ".attn.out_proj", d, d)
            lin(pre + ".mlp.c_fc", d, 4 * d)
            lin(pre + ".mlp.c_proj", 4 * d, d)
    else:
        emb = "vision_model.embeddings."
        put(emb + "patch_embedding.weight", d, 3, p, p, scale=0.02)
        put(emb + "class_embedding", d)
        put(emb + "position_embedding.weight", n_tok, d)
        norm("vision_model.pre_layrnorm", d)
        norm("vision_model.post_layernorm", d)
        put("visual_projection.weight", v.embed_dim, d)
        for i in range(v.layers):
            pre = f"vision_model.encoder.layers.{i}"
            norm(pre + ".layer_norm1", d)
            norm(pre + ".layer_norm2", d)
            for name in ("q_proj", "k_proj", "v_proj", "out_proj"):
                lin(f"{pre}.self_attn.{name}", d, d)
            lin(pre + ".mlp.fc1", d, 4 * d)
            lin(pre + ".mlp.fc2", 4 * d, d)
    if text is not None:
        t = text
        put("token_embedding.weight", t.vocab_size, t.width, scale=0.02)
        put("positional_embedding", t.context_length, t.width, scale=0.01)
        norm("ln_final", t.width)
        put("text_projection", t.width, t.width)
        for i in range(t.layers):
            pre = f"transformer.resblocks.{i}"
            norm(pre + ".ln_1", t.width)
            norm(pre + ".ln_2", t.width)
            put(pre + ".attn.in_proj_weight", 3 * t.width, t.width)
            put(pre + ".attn.in_proj_bias", 3 * t.width, scale=0.1)
            lin(pre + ".attn.out_proj", t.width, t.width)
            lin(pre + ".mlp.c_fc", t.width, 4 * t.width)
            lin(pre + ".mlp.c_proj", 4 * t.width, t.width)
    return {k: torch.from_numpy(v) for k, v in sd.items()}


# ---------------------------------------------------------------------------
# resize
# ---------------------------------------------------------------------------

RESIZES = [((13, 17), (29, 8)), ((13, 17), (13, 17)), ((13, 17), (5, 40)), ((32, 32), (299, 299)),
           ((64, 48), (24, 224))]


@pytest.mark.parametrize("method", ["linear", "cubic"])
@pytest.mark.parametrize("src,dst", RESIZES, ids=[f"{a}->{b}" for a, b in RESIZES])
def test_resize_matches_jax_image_resize(method, src, dst):
    """Up, down, identity, one axis each way, non-square."""
    x = np.random.default_rng(sum(src + dst)).uniform(-1, 1, (2,) + src + (3,)).astype(np.float32)
    want = jax.image.resize(jnp.asarray(x), (2,) + dst + (3,), method=method, antialias=True)
    got = resize_images(torch.from_numpy(x), dst, method)
    assert got.shape == want.shape and max_err(got, want) <= 1e-5


def test_resize_does_not_call_interpolate(monkeypatch):
    def refuse(*a, **kw):
        raise AssertionError("F.interpolate called")

    monkeypatch.setattr(torch.nn.functional, "interpolate", refuse)
    resize_images(torch.zeros((1, 9, 9, 3)), 4, "cubic")


# ---------------------------------------------------------------------------
# CLIP vision tower
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def vision():
    jcfg, tcfg = jclip.ClipVisionConfig(**VISION), tclip.ClipVisionConfig(**VISION)
    params = random_params(lambda k: jclip.init_clip_vision_params(k, jcfg), seed=3)
    images = np.random.default_rng(4).normal(size=(3, 28, 28, 3)).astype(np.float32)
    return jcfg, tcfg, params, images


def test_clip_vision_apply_matches_jax(vision):
    """Pooled and token outputs on carried-across parameters; the patch
    embedding arrives in HWIO (io.from_jax leaves it) and is read so."""
    jcfg, tcfg, params, images = vision
    tp = to_torch(params)
    assert tuple(tp["patch_embed"].shape) == (14, 14, 3, 160)
    want_pool, want_tok = jax.jit(lambda p, x: jclip.clip_vision_apply(
        p, x, jcfg, output_tokens=True))(params, jnp.asarray(images))
    got_pool, got_tok = tclip.clip_vision_apply(tp, torch.from_numpy(images), tcfg,
                                                output_tokens=True)
    assert got_tok.shape == want_tok.shape == (3, 4, 160)
    assert _rel(got_pool, want_pool, 1e-5) and _rel(got_tok, want_tok, 1e-5)
    assert torch.equal(tclip.clip_vision_apply(tp, torch.from_numpy(images), tcfg), got_pool)


@pytest.mark.parametrize("naming", ["open_clip", "hf"])
def test_load_clip_vision_torch_matches_jax_loader(naming):
    """Leaf for leaf against from_jax_params(JAX loader) on a synthetic
    state dict of each naming (the fused in_proj split into q, k, v)."""
    cfg = tclip.ClipVisionConfig(**VISION)
    sd = open_clip_state_dict(cfg, naming=naming, seed=5)
    got = tclip.load_clip_vision_torch(sd, cfg, naming=naming)
    want = to_torch(jclip.load_clip_vision_torch(sd, jclip.ClipVisionConfig(**VISION),
                                                 naming=naming))
    _same_tree(got, want)
    with pytest.raises(ValueError, match="naming"):
        tclip.load_clip_vision_torch(sd, cfg, naming="timm")


def test_clip_image_preprocess_matches_jax():
    x = np.random.default_rng(6).uniform(-1, 1, (2, 40, 30, 3)).astype(np.float32)
    want = jemb.clip_image_preprocess(jnp.asarray(x), 28)
    got = temb.clip_image_preprocess(torch.from_numpy(x), 28)
    assert got.shape == want.shape and max_err(got, want) <= 1e-5


# ---------------------------------------------------------------------------
# Inception
# ---------------------------------------------------------------------------

INCEPTION_CASES = {  # name: (input shape, resize_input, normalize_input)
    "75-plain": ((2, 75, 75, 3), False, False),
    "75-normalized": ((2, 75, 75, 3), False, True),
    "20x24-resized-normalized": ((2, 20, 24, 3), True, True),
}


@pytest.fixture(scope="module")
def inception():
    """The synthetic checkpoint through both loaders, and JAX's features for
    every case (eager, once per module)."""
    sd = inception_state_dict()
    jp = jinc.load_inception_torch(sd)
    rng = np.random.default_rng(7)
    cases = {}
    for name, (shape, resize, normalize) in INCEPTION_CASES.items():
        x = rng.uniform(0, 1, shape).astype(np.float32)
        want = np.asarray(jinc.inception_pool3_features(jp, jnp.asarray(x), resize_input=resize,
                                                        normalize_input=normalize))
        cases[name] = (x, want)
    return sd, jp, cases


@pytest.mark.parametrize("case", sorted(INCEPTION_CASES))
def test_inception_pool3_features_match_jax(inception, case):
    sd, _, cases = inception
    x, want = cases[case]
    _, resize, normalize = INCEPTION_CASES[case]
    got = tinc.inception_pool3_features(tinc.load_inception_torch(sd), torch.from_numpy(x),
                                        resize_input=resize, normalize_input=normalize)
    assert got.shape == want.shape == (2, 2048)
    assert _rel(got, want, 1e-4), case


def test_load_inception_torch_matches_jax_loader(inception):
    sd, jp, _ = inception
    _same_tree(tinc.load_inception_torch(sd), to_torch(jp))


def test_init_inception_params_has_the_jax_structure():
    """The seeded init's tree: the JAX initializer's keys and (OIHW)
    shapes, identity batch norms."""
    got = tinc.init_inception_params(0, "cpu")
    want = jax.eval_shape(jinc.init_inception_params, jax.random.PRNGKey(0))
    got_l = dict(_leaves(got))
    want_l = {k: v.shape for k, v in _leaves(jax.tree.map(lambda s: np.zeros(s.shape), want))}
    assert sorted(got_l) == sorted(want_l)
    for k, shape in want_l.items():
        kh_kw_io = (shape[3], shape[2], shape[0], shape[1]) if len(shape) == 4 else shape
        assert got_l[k].shape == kh_kw_io, k
    assert np.all(got_l[("Mixed_5b", "branch1x1", "bn_var")] == 1.0)


# ---------------------------------------------------------------------------
# FID and CLIP scores
# ---------------------------------------------------------------------------


def test_fid_matches_jax():
    """Streaming statistics over two batches and the eigh-based distance,
    float64 on both sides, within 1e-9 relative."""
    rng = np.random.default_rng(8)
    a, b = rng.normal(size=(20, 16)), rng.normal(0.3, 1.2, size=(14, 16))
    ts = tfid.FeatureStats().update(a[:7]).update(a[7:])
    js = jfid.FeatureStats().update(a[:7]).update(a[7:])
    tb, jb = tfid.FeatureStats().update(b), jfid.FeatureStats().update(b)
    np.testing.assert_allclose(ts.mean, js.mean, rtol=1e-12)
    np.testing.assert_allclose(ts.cov, js.cov, rtol=1e-12, atol=1e-15)
    want = jfid.fid_from_stats(js, jb)
    assert abs(tfid.fid_from_stats(ts, tb) - want) <= 1e-9 * abs(want)
    assert abs(tfid.frechet_distance(ts.mean, ts.cov, ts.mean, ts.cov)) < 1e-9


def test_fid_needs_two_samples():
    with pytest.raises(ValueError, match="at least 2 samples"):
        _ = tfid.FeatureStats().update(np.zeros((1, 4))).cov
    with pytest.raises(ValueError, match=r"\(N, D\)"):
        tfid.FeatureStats().update(np.zeros(4))


def test_clip_scores_match_jax(vision):
    """CLIP-T and CLIP-I per sample, images in [-1, 1] at 20 x 24 (the
    preprocess resizes to 28 x 28)."""
    jcfg, tcfg, params, _ = vision
    jtcfg, ttcfg = jclip.ClipTextConfig(**TEXT), tclip.ClipTextConfig(**TEXT)
    tparams = random_params(lambda k: jclip.init_clip_text_params(k, jtcfg), seed=9)
    rng = np.random.default_rng(10)
    imgs_a = rng.uniform(-1, 1, (3, 20, 24, 3)).astype(np.float32)
    imgs_b = rng.uniform(-1, 1, (3, 20, 24, 3)).astype(np.float32)
    tokens = np.concatenate([np.full((3, 1), 513), rng.integers(1, 500, (3, 6)),
                             np.full((3, 1), 514), np.zeros((3, 69), int)], axis=1)
    want_t = j_clip_t(params, tparams, jnp.asarray(imgs_a), jnp.asarray(tokens),
                                    jcfg, jtcfg)
    want_i = j_clip_i(params, jnp.asarray(imgs_a), jnp.asarray(imgs_b),
                                               jcfg)
    vp, tp = to_torch(params), to_torch(tparams)
    got_t = t_clip_t(vp, tp, torch.from_numpy(imgs_a), torch.from_numpy(tokens),
                                   tcfg, ttcfg)
    got_i = t_clip_i(vp, torch.from_numpy(imgs_a),
                                              torch.from_numpy(imgs_b), tcfg)
    assert got_t.shape == got_i.shape == (3,)
    assert max_err(got_t, want_t) <= 1e-5 and max_err(got_i, want_i) <= 1e-5
    same = t_clip_i(vp, torch.from_numpy(imgs_a),
                                             torch.from_numpy(imgs_a), tcfg)
    assert float((same - 1).abs().max()) <= 1e-5
    no_proj = dataclasses.replace(ttcfg, text_projection=False)
    with pytest.raises(ValueError, match="text_projection"):
        clip_text_embed({k: v for k, v in tp.items() if k != "text_projection"},
                                    torch.from_numpy(tokens), no_proj)
