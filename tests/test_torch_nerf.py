"""FeatureNeRF pose block of the port vs the JAX package, and the port's
split encoding vs its unsplit form (forward, bf16, and the training path's
gradients). f32 both sides unless named; tolerance 1e-4 relative to the
output scale (the encoding chains a few hundred f32 ops through sin/cos of
up to 2^7 pi)."""
import dataclasses
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from custom_diffusion360_tpu.geometry.cameras import Cameras as JCams
from custom_diffusion360_tpu.models import nerf as jnerf
from custom_diffusion360_torch.geometry.cameras import Cameras
from custom_diffusion360_torch.models import nerf as tnerf
from custom_diffusion360_torch.ops.image_resize import resize_weights
from tests.test_cameras import random_cameras
from tests.test_torch_common import max_err, random_params, t, to_torch
from tests.test_torch_common import torch_threads  # noqa: F401  (fixture)

pytestmark = pytest.mark.usefixtures("torch_threads")

B, NREF, DIM = 2, 3, 24
KEYS = ("features", "sigma", "dists", "rgb", "sigma_uniform", "dists_uniform")


def _cfg(chunk, mod=jnerf):
    return mod.NerfConfig(dim=DIM, num_samples=6, num_freqs=4, chunk_size=chunk)


@pytest.fixture(scope="module")
def setup():
    params = random_params(lambda k: jnerf.init_nerf_params(k, _cfg(0)), seed=1)
    jc = random_cameras(B * (1 + NREF), seed=7).reshape(B, 1 + NREF)
    tc = Cameras(*(t(np.asarray(f)) for f in jc))
    rng = np.random.default_rng(2)
    tokens = {res: rng.normal(size=(NREF + 1, res * res, DIM)).astype(np.float32)
              for res in (4, 8)}
    return params, to_torch(params), jc, tc, tokens


def _check(got, want, tol=1e-4):
    for key in KEYS:
        if want[key] is None:
            assert got[key] is None, key
            continue
        scale = max(1.0, float(np.abs(np.asarray(want[key])).max()))
        assert got[key].shape == want[key].shape, key
        assert max_err(got[key], want[key]) < tol * scale, key


@pytest.mark.parametrize("chunk", [0, 16])
@pytest.mark.parametrize("prev_res", [None, 8, 4, 16])  # none, same, up-, downsampled
def test_nerfsd_apply_matches_jax(setup, chunk, prev_res):
    jp, tp, jc, tc, tokens = setup
    res = 8
    buf = tokens[res]
    jx = jnerf.CompactRefTokens(jnp.asarray(buf[-1]), jnp.asarray(buf[:-1]), 1, 2)
    tx = tnerf.CompactRefTokens(t(buf[-1]), t(buf[:-1]), 1, 2)
    prev = None
    if prev_res is not None:
        rng = np.random.default_rng(prev_res)
        prev = rng.uniform(0, 1, size=(B, prev_res**2, 6, 1)).astype(np.float32)
    want = jnerf.nerfsd_apply(
        jp, jc, jx, None, _cfg(chunk), None, False,
        prev_weights=None if prev is None else jnp.asarray(prev),
        imp_sample_next_step=True,
    )
    got = tnerf.nerfsd_apply(tp, tc, tx, _cfg(chunk, tnerf),
                             prev_weights=None if prev is None else t(prev),
                             imp_sample_next_step=True)
    _check(got, want)


def test_dense_tokens_and_chunking_invariance(setup):
    """The JAX block on dense (B, N, hw, C) tokens equals the port on the
    compact form, chunked and unchunked, and chunking changes nothing."""
    jp, tp, jc, tc, tokens = setup
    buf = tokens[8]
    compact = tnerf.CompactRefTokens(t(buf[-1]), t(buf[:-1]), 1, 2)
    dense = jnp.asarray(np.stack([np.broadcast_to(buf[-1], buf[:-1].shape), buf[:-1]]))
    want = jnerf.nerfsd_apply(jp, jc, dense, None, _cfg(0), None, False,
                              imp_sample_next_step=True)
    a = tnerf.nerfsd_apply(tp, tc, compact, _cfg(0, tnerf), imp_sample_next_step=True)
    b = tnerf.nerfsd_apply(tp, tc, compact, _cfg(8, tnerf), imp_sample_next_step=True)
    _check(a, want)
    _check(b, want)
    for key in KEYS:
        assert max_err(a[key], b[key]) < 1e-5, key


def _encoding_case(average, masked, nref=NREF, res=8):
    """Params, cameras, reference tokens, mask and one ray march for the
    encoding tests, each as the JAX (``j``) and the port (``t``) side take
    them."""
    kw = dict(dim=DIM, num_samples=6, num_freqs=4, chunk_size=0, average=average)
    jcfg, tcfg = jnerf.NerfConfig(**kw), tnerf.NerfConfig(**kw)
    params = random_params(lambda k: jnerf.init_nerf_params(k, jcfg), seed=3)
    jc = random_cameras(B * (1 + nref), seed=8).reshape(B, 1 + nref)
    rng = np.random.default_rng(9)
    xref = rng.normal(size=(B, nref, res * res, DIM)).astype(np.float32)
    mask = (rng.uniform(size=(B, nref, 16, 16)) > 0.3).astype(np.float32) if masked else None
    march = jnerf.raymarch(jc, res, jcfg, None, False)
    return SimpleNamespace(
        jcfg=jcfg, tcfg=tcfg, jp=jax.tree.map(jnp.asarray, params), tp=to_torch(params),
        jc=jc, tc=Cameras(*(t(np.asarray(f)) for f in jc)), xref=xref, mask=mask,
        jmask=None if mask is None else jnp.asarray(mask),
        tmask=None if mask is None else t(mask), march=march,
        pts=t(np.asarray(march["ray_points"])), rays=t(np.asarray(march["rays"])))


def _split_form(e, tp, cfg):
    """The port's split encoding of case ``e`` with params ``tp``."""
    proj = tnerf.project_ref_maps(tp, t(e.xref), cfg, mask_ref=e.tmask)
    geo_ray, logit_ray = tnerf.ray_shared_terms(tp, e.tc, e.rays, cfg)
    return tnerf.nerf_encoding_split(tp, e.tc, proj, geo_ray, logit_ray, e.pts, cfg)


@pytest.mark.parametrize("average", [False, True])
@pytest.mark.parametrize("masked", [False, True])
def test_nerf_encoding_apply_matches_jax_and_the_split_form(average, masked):
    """The unsplit encoding against JAX's (1e-4 of max|want|), and the
    port's split form, which pools the views before l2, against the unsplit
    form on the same inputs and against JAX's split form, which pools after
    it (rtol 2e-4, atol 2e-5, the tolerance of tests/test_nerf_split.py in
    the JAX package)."""
    e = _encoding_case(average, masked)
    out_j, attn_j = jnerf.nerf_encoding_apply(e.jp, e.jc, jnp.asarray(e.xref),
                                              e.march["ray_points"], e.march["rays"],
                                              e.jmask, e.jcfg)
    out_t, attn_t = tnerf.nerf_encoding_apply(e.tp, e.tc, t(e.xref), e.pts, e.rays,
                                              e.tmask, e.tcfg)
    assert out_t.shape == out_j.shape == (B, 64, 6, DIM + 4)
    assert max_err(out_t, out_j) < 1e-4 * max(1.0, float(np.abs(np.asarray(out_j)).max()))
    assert (attn_t is None) == (attn_j is None) == average
    if not average:
        assert max_err(attn_t, attn_j) < 1e-5

    out_s, attn_s = _split_form(e, e.tp, e.tcfg)
    np.testing.assert_allclose(out_t.numpy(), out_s.numpy(), rtol=2e-4, atol=2e-5)
    if not average:
        np.testing.assert_allclose(attn_t.numpy(), attn_s.numpy(), rtol=2e-4, atol=2e-5)

    jproj = jnerf.project_ref_maps(e.jp, jnp.asarray(e.xref), e.jmask, e.jcfg)
    jgeo, jlogit = jnerf.ray_shared_terms(e.jp, e.jc, e.march["rays"], e.jcfg)
    out_js, attn_js = jnerf.nerf_encoding_split(e.jp, e.jc, jproj, jgeo, jlogit,
                                                e.march["ray_points"], e.jcfg)
    np.testing.assert_allclose(out_s.numpy(), np.asarray(out_js), rtol=2e-4, atol=2e-5)
    if not average:
        np.testing.assert_allclose(attn_s.numpy(), np.asarray(attn_js), rtol=2e-4, atol=2e-5)


@pytest.mark.parametrize("average", [False, True])
@pytest.mark.parametrize("masked", [False, True])
def test_the_bf16_split_form_is_close_to_the_f32_form(average, masked):
    """The split form in bf16 (the sampling render's dtype: l2 on the pooled
    activation rounded to bf16) against itself in f32, within 2e-2 of
    max|f32| (it reads 0.6-0.8e-2; tests/test_nerf_split.py holds the JAX
    package's bf16 path to rtol 0.1, atol 0.05)."""
    e = _encoding_case(average, masked)
    cfg16 = dataclasses.replace(e.tcfg, compute_dtype="bfloat16")
    out32, attn32 = _split_form(e, e.tp, e.tcfg)
    out16, attn16 = _split_form(e, e.tp, cfg16)
    assert out16.dtype == torch.float32 and out16.shape == out32.shape
    assert max_err(out16, out32) < 2e-2 * max(1.0, float(out32.abs().max()))
    if not average:
        assert max_err(attn16, attn32) < 2e-2


@pytest.mark.parametrize("average", [False, True])
def test_split_form_gradients_match_the_unsplit_form(average):
    """One f32 render's autograd, the training path: the split form's
    gradients on every pose-block leaf (l1, l2, nviews, decoder) equal the
    unsplit per-view form's within 1e-4 of the largest gradient of the
    leaf's layer (the view softmax ignores a shift of every view's logit,
    so the nviews bias's own gradient is zero but for rounding)."""
    e = _encoding_case(average, masked=True)
    rng = np.random.default_rng(11)
    w_out = t(rng.normal(size=(B, 64, 6, DIM + 4)).astype(np.float32))
    w_attn = t(rng.normal(size=(B, NREF, 64, 6, 1)).astype(np.float32))

    def grads(form):
        tp = jax.tree.map(lambda x: x.clone().requires_grad_(), e.tp)
        out, attn = form(tp)
        loss = (out * w_out).sum() + (0.0 if attn is None else (attn * w_attn).sum())
        leaves, treedef = jax.tree.flatten(tp)
        return treedef.unflatten(torch.autograd.grad(loss, leaves))

    got = grads(lambda tp: _split_form(e, tp, e.tcfg))
    want = grads(lambda tp: tnerf.nerf_encoding_apply(tp, e.tc, t(e.xref), e.pts, e.rays,
                                                      e.tmask, e.tcfg))
    want = {jax.tree_util.keystr(k): w for k, w in jax.tree_util.tree_flatten_with_path(want)[0]}
    got = {jax.tree_util.keystr(k): g for k, g in jax.tree_util.tree_flatten_with_path(got)[0]}
    layers = {"['decoder']", "['plane_coefs']['l1']", "['plane_coefs']['l2']"}
    if not average:
        layers.add("['nviews']")
    assert got.keys() == want.keys() and {n.rsplit("[", 1)[0] for n in want} == layers
    for name, w in want.items():
        layer = name.rsplit("[", 1)[0]
        scale = max(float(v.abs().max()) for n, v in want.items() if n.startswith(layer))
        assert scale > 0, name
        assert max_err(got[name], w) <= 1e-4 * scale, name


class _MatmulRows(TorchDispatchMode):
    """Rows of every C x C product run under it: a product with a C x C
    right operand (l2 forward and its input gradient) counts its left
    operand's rows, one with a C x C result and another inner size (l2's
    weight gradient) counts its inner size."""

    def __init__(self, c):
        super().__init__()
        self.c, self.rows = c, []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
            a, b = args[-2], args[-1]
            if tuple(b.shape) == (self.c, self.c):
                self.rows.append(a.shape[0])
            elif tuple(out.shape) == (self.c, self.c) and a.shape[1] != self.c:
                self.rows.append(a.shape[1])
        return out


@pytest.mark.parametrize("average", [False, True])
def test_the_feature_pass_runs_l2_on_the_pooled_rows(average):
    """At N = 4 views, the split form's l2 passes (forward, input and
    weight gradients) take B hw S rows each, a quarter of what the unsplit
    per-view form's take: a later edit that puts l2 back ahead of the pool
    fails here. The reference maps' C x C projection (project_ref_maps) is
    made outside the count."""
    nref = 4
    e = _encoding_case(average, masked=False, nref=nref)
    rows = B * 64 * 6

    def counted(form):
        tp = jax.tree.map(lambda x: x.clone().requires_grad_(), e.tp)
        with torch.no_grad():
            proj = tnerf.project_ref_maps(tp, t(e.xref), e.tcfg)
            geo_ray, logit_ray = tnerf.ray_shared_terms(tp, e.tc, e.rays, e.tcfg)
        mode = _MatmulRows(DIM)
        with mode:
            out, _ = form(tp, proj, geo_ray, logit_ray)
            out.square().sum().backward()
        return mode.rows

    split = counted(lambda tp, proj, g, lg: tnerf.nerf_encoding_split(
        tp, e.tc, proj, g, lg, e.pts, e.tcfg))
    per_view = counted(lambda tp, proj, g, lg: tnerf.nerf_encoding_apply(
        tp, e.tc, t(e.xref), e.pts, e.rays, None, e.tcfg))
    assert split == [rows] * 3
    assert per_view == [nref * rows] * 3


def test_project_ref_maps_pads_channels(setup):
    _, tp, _, _, tokens = setup
    buf = tokens[4]
    proj = tnerf.project_ref_maps(
        tp, tnerf.CompactRefTokens(t(buf[-1]), t(buf[:-1]), 1, 2), _cfg(0, tnerf))
    assert proj.shape == (2, NREF, 16, 32)  # C + 1 = 25 -> 32
    assert proj.is_contiguous()
    assert float(proj[..., DIM + 1:].abs().max()) == 0.0


@pytest.mark.parametrize("chunk,rows,hw", [
    (512, 2, 4096), (4096, 2, 4096), (4096, 4, 4096), (4096, 3, 4096),
    (4096, 8, 1024), (512, 6, 256), (300, 2, 1024), (0, 2, 64), (1000, 1, 96),
])
def test_effective_chunk_matches_jax(chunk, rows, hw):
    assert tnerf.effective_chunk(chunk, rows, 2, hw) == jnerf.effective_chunk(chunk, rows, 2, hw)


@pytest.mark.parametrize("src,dst", [(4, 8), (8, 4), (16, 8), (8, 8), (6, 4)])
def test_resize_weights_match_jax_image_resize(src, dst):
    rng = np.random.default_rng(src * dst)
    img = rng.uniform(size=(2, src, src, 5)).astype(np.float32)
    want = jax.image.resize(jnp.asarray(img), (2, dst, dst, 5), method="bilinear", antialias=True)
    w = resize_weights(src, dst, "linear")
    got = np.einsum("bhws,hH,wW->bHWs", img, w.numpy(), w.numpy())
    assert max_err(got, want) < 1e-5
