"""Geometry and render ops of the port vs the JAX package (f32 both sides)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from custom_diffusion360_tpu.geometry import cameras as jcam
from custom_diffusion360_tpu.geometry import rays as jrays
from custom_diffusion360_tpu.ops.sample_pdf import sample_pdf as j_sample_pdf
from custom_diffusion360_tpu.ops.volume_render import volume_render as j_volume_render
from custom_diffusion360_torch.geometry import cameras as tcam
from custom_diffusion360_torch.geometry import rays as trays
from custom_diffusion360_torch.ops.sample_pdf import sample_pdf
from custom_diffusion360_torch.ops.volume_render import volume_render
from tests.test_cameras import random_cameras
from tests.test_torch_common import max_err, t
from tests.test_torch_common import torch_threads  # noqa: F401  (fixture)

pytestmark = pytest.mark.usefixtures("torch_threads")

TOL = 2e-5


def _cams(n, seed):
    jc = random_cameras(n, seed=seed)
    return jc, tcam.Cameras(*(t(np.asarray(f)) for f in jc))


def test_world_view_ndc_and_unproject():
    jc, tc = _cams(4, 1)
    rng = np.random.default_rng(0)
    pts = rng.normal(size=(4, 50, 3)).astype(np.float32)
    # a point behind each camera (negative depth: the sign-preserving clamp)
    behind = np.tile(np.array([[[0.1, 0.2, -1.0]]], np.float32), (4, 1, 1))
    pts[:, :1] = np.asarray(jcam.view_to_world(jc, jnp.asarray(behind)))
    assert max_err(tcam.world_to_view(tc, t(pts)), jcam.world_to_view(jc, jnp.asarray(pts))) < TOL
    got = tcam.transform_points_ndc(tc, t(pts)).numpy()
    want = np.asarray(jcam.transform_points_ndc(jc, jnp.asarray(pts)))
    assert np.abs(got - want).max() < 1e-4 * max(1.0, np.abs(want).max())
    xyd = rng.normal(size=(4, 20, 3)).astype(np.float32)
    xyd[..., 2] = np.abs(xyd[..., 2]) + 0.5
    assert max_err(tcam.unproject_ndc_points(tc, t(xyd)),
                   jcam.unproject_ndc_points(jc, jnp.asarray(xyd))) < 1e-4


@pytest.mark.parametrize("res", [4, 8])
def test_patch_rays_and_frames(res):
    jc, tc = _cams(6, 2)
    jc2, tc2 = jc.reshape(2, 3), tc.reshape(2, 3)
    want, _ = jrays.get_patch_rays(jc2, res)
    got, _ = trays.get_patch_rays(tc2, res)
    assert got.shape == (2, 3, res * res, 6)
    assert max_err(got, want) < TOL
    assert max_err(trays.rays_to_view_space(tc2, got[:, 0]),
                   jrays.rays_to_view_space(jc2, want[:, 0])) < 1e-4
    assert max_err(trays.rays_to_target_space(tc2, got[:, 1:]),
                   jrays.rays_to_target_space(jc2, want[:, 1:])) < 1e-4
    assert max_err(trays.plucker_parameterization(got),
                   jrays.plucker_parameterization(want)) < 1e-4


def test_points_to_view_space():
    jc, tc = _cams(6, 4)
    jc, tc = jc.reshape(2, 3), tc.reshape(2, 3)
    pts = np.random.default_rng(4).normal(size=(2, 5, 4, 3)).astype(np.float32)
    got = trays.points_to_view_space(tc, t(pts))
    want = jrays.points_to_view_space(jc, jnp.asarray(pts))
    assert got.shape == (2, 3, 5, 4, 3)
    assert max_err(got, want) < TOL * max(1.0, float(np.abs(np.asarray(want)).max()))


def test_positional_encoding_order():
    x = np.random.default_rng(3).normal(size=(5, 7, 3)).astype(np.float32)
    for nf in (2, 16):
        assert max_err(trays.positional_encoding(t(x), nf),
                       jrays.positional_encoding(jnp.asarray(x), nf)) < 1e-4


def test_sample_pdf_matches_jax():
    rng = np.random.default_rng(4)
    s = 24
    bins = np.sort(rng.uniform(0, 4, size=(3, 10, s + 1)).astype(np.float32), -1)
    weights = rng.uniform(0, 1, size=(3, 10, s)).astype(np.float32)
    weights[0, 0] = 0.0  # all-zero row: eps handling
    weights[0, 1, :12] = 0.0
    u = np.broadcast_to(np.arange(s, dtype=np.float32) / s, (3, 10, s)).copy()
    u[1] = rng.uniform(0, 1, size=(10, s))
    u[2, 0] = 0.0  # 'left' searchsorted at the first edge
    assert max_err(sample_pdf(t(bins), t(weights), t(u)),
                   j_sample_pdf(jnp.asarray(bins), jnp.asarray(weights), jnp.asarray(u))) < 1e-5


def test_volume_render_matches_jax():
    rng = np.random.default_rng(5)
    feats = rng.normal(size=(2, 9, 6, 5)).astype(np.float32)
    dens = np.exp(rng.normal(size=(2, 9, 6, 1))).astype(np.float32)
    dens[0, 0, 3] = np.inf  # inf density -> nan_to_num path
    dists = rng.uniform(0.05, 0.3, size=(2, 9, 6, 1)).astype(np.float32)
    rgb = rng.uniform(size=(2, 9, 6, 3)).astype(np.float32)
    want = j_volume_render(jnp.asarray(feats), jnp.asarray(dens), jnp.asarray(dists),
                           rgb=jnp.asarray(rgb), densities_uniform=jnp.asarray(dens),
                           dists_uniform=jnp.asarray(dists))
    got = volume_render(t(feats), t(dens), t(dists), rgb=t(rgb),
                        densities_uniform=t(dens), dists_uniform=t(dists))
    for key in ("feats", "fg_mask", "weights", "weights_uniform", "rgb"):
        assert max_err(got[key], want[key]) < 1e-5, key
    assert torch.isfinite(got["weights"]).all()
