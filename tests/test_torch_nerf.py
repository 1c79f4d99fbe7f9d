"""FeatureNeRF pose block (eval path) of the port vs the JAX package.
f32 both sides; tolerance 1e-4 relative to the output scale (the encoding
chains a few hundred f32 ops through sin/cos of up to 2^7 pi)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from custom_diffusion360_tpu.geometry.cameras import Cameras as JCams
from custom_diffusion360_tpu.models import nerf as jnerf
from custom_diffusion360_torch.geometry.cameras import Cameras
from custom_diffusion360_torch.models import nerf as tnerf
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
    w = tnerf._resize_weights(src, dst, "cpu")
    got = np.einsum("bhws,hH,wW->bHWs", img, w.numpy(), w.numpy())
    assert max_err(got, want) < 1e-5
