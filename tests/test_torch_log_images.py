"""The live-reference sample, ``Engine.log_images`` and
``Engine.samplemulti`` of the port vs the JAX package, on the CPU in
float32, at TINY sizes with JAX's own draws handed to the port.

- Live references: ``Engine.sample`` with ``input_ref`` (per-copy reference
  latents), ``sigmas_ref`` (non-zero, so the denoiser's c_in scaling and
  index quantization of the reference stream run) and the conditioner's
  reference rows after the target rows, under x2 with a per-row
  ``mask_ref`` and under x3; and the dense route, delta buffers with a
  ``mask_ref``, under x3. 3 steps, 1e-5 relative to the output scale.
- ``log_images``: 8 steps on the training slice's TINY engine and batch
  (tests/test_torch_train.py), the draws of JAX's key splits replayed,
  against the jitted JAX call (as the JAX training CLI makes it); every key
  within 1e-4 of its max|JAX| (at least 1).
- ``samplemulti``: 2 views, 3 steps, 1e-5 relative.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from custom_diffusion360_tpu.diffusion import scheduled_cfg_img_text_ref as JGuider3
from custom_diffusion360_tpu.diffusion import vanilla_cfg_img_ref as JGuider2
from custom_diffusion360_tpu.engine import Engine as JEngine
from custom_diffusion360_tpu.geometry.cameras import Cameras as JCams
from custom_diffusion360_torch.diffusion.guiders import (
    scheduled_cfg_img_text_ref,
    vanilla_cfg_img_ref,
)
from custom_diffusion360_torch.draws import Draws
from custom_diffusion360_torch.engine import Engine
from custom_diffusion360_torch.geometry.cameras import Cameras
from tests.test_cameras import random_cameras
from tests.test_torch_common import max_err, random_params, t, to_torch
from tests.test_torch_engine_samplers import B, LAT, NREF, STEPS, _cfgs
from tests.test_torch_engine_samplers import setup  # noqa: F401  (module fixture)
from tests.test_torch_train import _batch
from tests.test_torch_train import _cfgs as train_cfgs
from tests.test_torch_common import torch_threads  # noqa: F401  (fixture)

pytestmark = pytest.mark.usefixtures("torch_threads")

GUIDERS = {2: (JGuider2(scale=5.0), vanilla_cfg_img_ref(scale=5.0)),
           3: (JGuider3(scale=6.0, scale_im=2.5), scheduled_cfg_img_text_ref(scale=6.0,
                                                                             scale_im=2.5))}


def _rel(got, want, tol=1e-5):
    return max_err(got, want) < tol * max(1.0, float(np.abs(np.asarray(want)).max()))


def _tree_t(tree):
    return {k: t(v) for k, v in tree.items()}


@pytest.fixture(scope="module")
def live():
    """Conditioning with reference rows, per-copy reference latents and
    sigmas, masks and cameras for x2 and x3."""
    rng = np.random.default_rng(41)
    n_rows = B + B * NREF
    cond = {"crossattn": rng.normal(size=(n_rows, 16, 64)).astype(np.float32),
            "vector": rng.normal(size=(n_rows, 32)).astype(np.float32)}
    uc = {k: rng.normal(size=v.shape).astype(np.float32) for k, v in cond.items()}
    out = {"cond": cond, "uc": uc}
    for k in GUIDERS:
        one = random_cameras(1 + NREF, seed=42 + k)
        out[k] = dict(
            cams=[np.broadcast_to(np.asarray(f)[None], (k * B,) + np.asarray(f).shape).copy()
                  for f in one],
            input_ref=rng.normal(size=(k * B, NREF, LAT, LAT, 4)).astype(np.float32),
            sigmas_ref=rng.uniform(0.2, 4.0, size=(k * B,)).astype(np.float32),
            mask_ref=(rng.uniform(size=(k * B, NREF, LAT, LAT, 1)) > 0.3).astype(np.float32))
    return out


CASES = {"live-x2-mask": (2, True, True), "live-x3": (3, True, False),
         "delta-x3-mask-dense": (3, False, True)}


@pytest.mark.parametrize("case", sorted(CASES))
def test_reference_sample_matches_jax(setup, live, case):  # noqa: F811
    copies, use_live, use_mask = CASES[case]
    params, refs, _, cond_d, uc_d, noise = setup
    lv = live[copies]
    cond, uc = (live["cond"], live["uc"]) if use_live else (cond_d, uc_d)
    jcfg, tcfg = _cfgs()
    jkw = dict(cams=JCams(*(jnp.asarray(c) for c in lv["cams"])))
    tkw = dict(cams=Cameras(*(t(c) for c in lv["cams"])))
    if use_live:
        jkw.update(input_ref=jnp.asarray(lv["input_ref"]), sigmas_ref=jnp.asarray(lv["sigmas_ref"]))
        tkw.update(input_ref=t(lv["input_ref"]), sigmas_ref=t(lv["sigmas_ref"]))
    else:
        jkw.update(references=jax.tree.map(jnp.asarray, refs), choices=np.array([1, 0]))
        tkw.update(references={a: {d: t(v) for d, v in dd.items()} for a, dd in refs.items()},
                   choices=[1, 0])
    if use_mask:
        jkw["mask_ref"] = jnp.asarray(lv["mask_ref"])
        tkw["mask_ref"] = t(lv["mask_ref"])
    want = np.asarray(JEngine(jcfg).sample(
        jax.tree.map(jnp.asarray, params), jax.tree.map(jnp.asarray, cond),
        jax.tree.map(jnp.asarray, uc), GUIDERS[copies][0], jax.random.PRNGKey(0),
        shape=noise.shape, num_steps=STEPS, noise=jnp.asarray(noise), **jkw))
    got = Engine(tcfg, device="cpu").sample(
        to_torch(params), _tree_t(cond), _tree_t(uc), GUIDERS[copies][1], noise=t(noise),
        num_steps=STEPS, **tkw)
    assert float(np.abs(want - noise * np.sqrt(1 + 14.6**2)).max()) > 1.0  # it moved
    assert _rel(got, want), (case, max_err(got, want))


def test_mask_ref_takes_the_dense_route(setup, live, monkeypatch):  # noqa: F811
    """A mask_ref expands the delta buffers densely; without one they stay
    compact."""
    import custom_diffusion360_torch.models.nerf as tnerf

    kinds = []
    orig = tnerf.project_ref_maps
    monkeypatch.setattr(tnerf, "project_ref_maps", lambda p, xref, *a, **kw: kinds.append(
        type(xref).__name__) or orig(p, xref, *a, **kw))
    params, refs, cams, cond, uc, noise = setup
    _, tcfg = _cfgs()
    eng = Engine(tcfg, device="cpu")
    common = dict(noise=t(noise), cams=Cameras(*(t(c) for c in live[2]["cams"])),
                  references={a: {d: t(v) for d, v in dd.items()} for a, dd in refs.items()},
                  choices=[0, 1], num_steps=1)
    eng.sample(to_torch(params), _tree_t(cond), _tree_t(uc), GUIDERS[2][1], **common)
    assert kinds and set(kinds) == {"CompactRefTokens"}
    kinds.clear()
    eng.sample(to_torch(params), _tree_t(cond), _tree_t(uc), GUIDERS[2][1],
               mask_ref=t(live[2]["mask_ref"]), **common)
    assert kinds and set(kinds) == {"Tensor"}


# ---------------------------------------------------------------------------
# log_images
# ---------------------------------------------------------------------------


def log_images_draws(key, b, n, lat):
    """The draws of JAX Engine.log_images's key splits: k_enc for both
    posterior samples, k_sample -> (k_noise, k_samp) for the sample; the
    diagnostic noise comes from split(k_sample)[0], which is k_noise."""
    k_enc, k_sample = jax.random.split(key)
    k_noise, _ = jax.random.split(k_sample)
    z = (b, lat, lat, 4)
    draws = {"vae_eps": jax.random.normal(k_enc, z),
             "vae_eps_ref": jax.random.normal(k_enc, (b * n, lat, lat, 4)),
             "noise": jax.random.normal(k_noise, z),
             "diag_noise": jax.random.normal(k_noise, z)}
    return {k: t(np.asarray(v)) for k, v in draws.items()}


def test_log_images_matches_jax():
    from tests.test_torch_train import B as TB, N as TN, RES

    jcfg, tcfg = train_cfgs()
    jeng = JEngine(jcfg)
    params = random_params(jeng.init_params, seed=51)
    jbatch, tbatch = _batch()
    key = jax.random.PRNGKey(52)
    # jitted, as the JAX training CLI runs it (op by op it takes 4x longer)
    want = jax.jit(lambda p, b, k: jeng.log_images(p, b, k, num_steps=8))(
        jax.tree.map(jnp.asarray, params), jbatch, key)
    got = Engine(tcfg, device="cpu").log_images(
        to_torch(params), tbatch, Draws(given=log_images_draws(key, TB, TN, RES // 8)),
        num_steps=8)
    assert set(got) == set(want)
    assert {"inputs", "reconstructions", "samples", "predicted_rgb_0", "fg_mask_0"} <= set(got)
    for k, w in want.items():
        w = np.asarray(w, np.float32)
        g = got[k]
        assert tuple(g.shape) == w.shape and g.dtype == torch.float32, k
        assert max_err(g, w) <= 1e-4 * max(1.0, float(np.abs(w).max())), (k, max_err(g, w))
    assert float(got["samples"].std()) > 0.01
    recon = Engine(tcfg, device="cpu").log_images(
        to_torch(params), tbatch, Draws(given=log_images_draws(key, TB, TN, RES // 8)),
        sample=False)
    assert set(recon) == {"inputs", "reconstructions"}
    assert max_err(recon["reconstructions"], want["reconstructions"]) <= 1e-4 * max(
        1.0, float(np.abs(np.asarray(want["reconstructions"])).max()))


# ---------------------------------------------------------------------------
# samplemulti
# ---------------------------------------------------------------------------


def test_samplemulti_matches_jax(setup):  # noqa: F811
    params, refs, _, cond, uc, _ = setup
    window, stride, n_views = LAT, 6, 2
    rng = np.random.default_rng(61)
    conds = [cond, {k: v + 0.3 * rng.normal(size=v.shape).astype(np.float32)
                    for k, v in cond.items()}]
    cams_list = []
    for j in range(n_views):
        one = random_cameras(1 + NREF, seed=62 + j)
        cams_list.append([np.broadcast_to(np.asarray(f)[None], (2 * B,) + np.asarray(f).shape)
                          .copy() for f in one])
    key = jax.random.PRNGKey(63)
    shape = (B, LAT, stride * (n_views + 1), 4)
    jcfg, tcfg = _cfgs()
    want = np.asarray(JEngine(jcfg).samplemulti(
        jax.tree.map(jnp.asarray, params), [jax.tree.map(jnp.asarray, c) for c in conds],
        jax.tree.map(jnp.asarray, uc), GUIDERS[2][0], key, shape=shape,
        cams_list=[JCams(*(jnp.asarray(f) for f in c)) for c in cams_list],
        references=jax.tree.map(jnp.asarray, refs), choices=np.arange(NREF),
        num_steps=STEPS, window=window, stride=stride))
    steps = []
    got = Engine(tcfg, device="cpu").samplemulti(
        to_torch(params), [_tree_t(c) for c in conds], _tree_t(uc), GUIDERS[2][1],
        noise=t(np.asarray(jax.random.normal(key, shape))),
        cams_list=[Cameras(*(t(f) for f in c)) for c in cams_list],
        references={a: {d: t(v) for d, v in dd.items()} for a, dd in refs.items()},
        choices=np.arange(NREF), num_steps=STEPS, window=window, stride=stride,
        callback=steps.append)
    assert steps == list(range(STEPS)) and got.shape == shape
    assert float(np.abs(want).max()) > 1.0
    assert _rel(got, want), max_err(got, want)
