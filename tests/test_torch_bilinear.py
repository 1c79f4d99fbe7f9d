"""Bilinear sampling port vs the JAX package: bilinear_sample_pallas in
interpret mode (as tests/test_ops.py runs it) and grid_sample_2d, plus
torch's own F.grid_sample. f32 on both sides: tolerance 1e-5."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import custom_diffusion360_tpu.ops.onehot_sample as ohs
from custom_diffusion360_tpu.ops.grid_sample import grid_sample_2d as j_grid_sample
from custom_diffusion360_torch.ops.grid_sample import grid_sample_2d
from custom_diffusion360_torch.ops.onehot_sample import bilinear_sample
from tests.test_torch_common import max_err, t

TOL = 1e-5


@pytest.fixture(autouse=True)
def interpret_mode(monkeypatch):
    monkeypatch.setattr(ohs, "_INTERPRET", True)


def _case(seed, m, h, w, c, p):
    """Maps and a grid in the FeatureNeRF range: uniform in [-1.2, 1.2]
    (beyond +-1 reads zeros), with points exactly on +-1 and on the clip."""
    rng = np.random.default_rng(seed)
    feats = rng.normal(size=(m, h, w, c)).astype(np.float32)
    grid = rng.uniform(-1.2, 1.2, size=(m, p, 2)).astype(np.float32)
    edge = np.array([[1.0, 1.0], [-1.0, -1.0], [1.0, -1.0], [-1.0, 0.3],
                     [1.2, 0.0], [-1.2, -1.2], [0.999999, -0.999999]], np.float32)
    grid[:, : len(edge)] = edge
    return feats, grid


@pytest.mark.parametrize("c", [16, 7, 641])  # aligned, odd, the ds2 C + 1
def test_matches_pallas_kernel(c):
    feats, grid = _case(c, 3, 8, 8, c, 40)
    want = ohs.bilinear_sample_pallas(jnp.asarray(feats), jnp.asarray(grid), True, 128)
    got = bilinear_sample(t(feats), t(grid))
    assert got.shape == (3, 40, c)
    assert max_err(got, want) < TOL


@pytest.mark.parametrize("shape", [(2, 5, 7, 9, 33), (4, 16, 16, 24, 100)])
def test_matches_jax_grid_sample_and_torch(shape):
    m, h, w, c, p = shape
    feats, grid = _case(p, m, h, w, c, p)
    want = j_grid_sample(jnp.asarray(feats), jnp.asarray(grid))
    got = bilinear_sample(t(feats), t(grid))
    assert max_err(got, want) < TOL
    ref = F.grid_sample(t(feats).permute(0, 3, 1, 2), t(grid)[:, :, None],
                        mode="bilinear", padding_mode="zeros", align_corners=True)
    assert max_err(got, ref[..., 0].permute(0, 2, 1)) < TOL


def test_leading_batch_dims():
    feats, grid = _case(3, 6, 4, 4, 5, 11)
    got = grid_sample_2d(t(feats).reshape(2, 3, 4, 4, 5), t(grid).reshape(2, 3, 11, 2))
    want = j_grid_sample(jnp.asarray(feats).reshape(2, 3, 4, 4, 5),
                         jnp.asarray(grid).reshape(2, 3, 11, 2))
    assert got.shape == (2, 3, 11, 5)
    assert max_err(got, want) < TOL


def test_cpu_dispatch_is_plain_and_uncounted():
    feats, grid = _case(4, 2, 4, 4, 8, 10)
    before = bilinear_sample.launches
    got = bilinear_sample(t(feats), t(grid))
    assert bilinear_sample.launches == before
    assert not bilinear_sample.launches_by_shape
    assert max_err(got, grid_sample_2d(t(feats), t(grid))) == 0.0
