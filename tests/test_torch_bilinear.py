"""Bilinear sampling port vs the JAX package: bilinear_sample_pallas in
interpret mode (as tests/test_ops.py runs it) and grid_sample_2d, plus
torch's own F.grid_sample. f32 on both sides: tolerance 1e-5."""
import jax
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
from tests.test_torch_common import torch_threads  # noqa: F401  (fixture)

pytestmark = pytest.mark.usefixtures("torch_threads")

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
    before = sum(bilinear_sample.launches_by_shape.values())
    got = bilinear_sample(t(feats), t(grid))
    assert sum(bilinear_sample.launches_by_shape.values()) == before
    assert not bilinear_sample.launches_by_shape
    assert max_err(got, grid_sample_2d(t(feats), t(grid))) == 0.0


# ---------------------------------------------------------------------------
# gradients: W^T g with respect to the maps against the VJP of
# bilinear_sample_pallas (interpret mode); the grid's gradient is zero
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("c", [16, 7])
def test_feats_gradient_matches_pallas_vjp(c):
    feats, grid = _case(c + 100, 3, 8, 8, c, 40)
    g = np.random.default_rng(c).normal(size=(3, 40, c)).astype(np.float32)
    _, vjp = jax.vjp(lambda f, q: ohs.bilinear_sample_pallas(f, q, True, 128),
                     jnp.asarray(feats), jnp.asarray(grid))
    want_f, want_g = vjp(jnp.asarray(g))
    f = t(feats).requires_grad_(True)
    q = t(grid).requires_grad_(True)
    bilinear_sample(f, q).backward(t(g))
    assert max_err(f.grad, want_f) < TOL
    assert float(q.grad.abs().max()) == 0.0 and float(np.abs(np.asarray(want_g)).max()) == 0.0


def test_backward_plain_matches_grid_sample_autograd():
    """bilinear_sample_bwd on the CPU (the kernel's plain version) equals the
    maps' gradient of F.grid_sample."""
    from custom_diffusion360_torch.ops.onehot_sample import bilinear_sample_bwd

    feats, grid = _case(9, 2, 6, 5, 11, 30)
    g = t(np.random.default_rng(9).normal(size=(2, 30, 11)).astype(np.float32))
    f = t(feats).requires_grad_(True)
    ref = F.grid_sample(f.permute(0, 3, 1, 2), t(grid)[:, :, None], mode="bilinear",
                        padding_mode="zeros", align_corners=True)
    ref[..., 0].permute(0, 2, 1).backward(g)
    before = sum(bilinear_sample_bwd.launches_by_shape.values())
    got = bilinear_sample_bwd(g, t(grid), feats.shape, torch.float32)
    assert sum(bilinear_sample_bwd.launches_by_shape.values()) == before
    assert max_err(got, f.grad) < TOL


def test_gradient_reaches_the_maps_through_the_nerf_reader():
    """A loss through the FeatureNeRF's padded-map read gives the maps (and
    what made them) a nonzero gradient."""
    feats, grid = _case(10, 2, 8, 8, 8, 64)
    src = t(feats[..., :6]).requires_grad_(True)
    maps = torch.cat([src * 2.0, torch.zeros(2, 8, 8, 2)], dim=-1)
    bilinear_sample(maps, t(grid))[..., :6].square().sum().backward()
    assert src.grad is not None and float(src.grad.abs().max()) > 0


# ---------------------------------------------------------------------------
# the backward kernel's decomposition (csrc/bilinear_sample_bwd.cu): channel
# slices, pixel bands and point splits, in plain f32, against the JAX VJP
# ---------------------------------------------------------------------------


def _jax_vjp(feats_shape, grid, g):
    feats = jnp.zeros(feats_shape, jnp.float32)
    d_fm, _ = ohs._pallas_vjp_bwd(True, 128, (feats, jnp.asarray(grid)), jnp.asarray(g))
    return np.asarray(d_fm)


def _split_case(kind, seed, m, h, w, c, p):
    rng = np.random.default_rng(seed)
    g = rng.normal(size=(m, p, c)).astype(np.float32)
    if kind == "uniform":
        grid = _case(seed, m, h, w, 1, p)[1]
    elif kind == "top rows":  # every corner in rows 0-1: lower bands get nothing
        grid = np.stack([rng.uniform(-1, 1, (m, p)),
                         np.full((m, p), -1.0) + rng.uniform(0, 1.0 / (h - 1), (m, p))], -1)
    elif kind == "outside":  # both corners of both axes off the map
        grid = rng.uniform(1.0 + 2.0 / (w - 1) + 1e-3, 3.0, (m, p, 2))
        grid[:, ::2] *= -1
    else:  # "one pixel": every point on pixel (h // 2, w // 2) or its 2 x 2 corners
        centre = np.array([(w // 2) / (w - 1), (h // 2) / (h - 1)]) * 2 - 1
        grid = centre + rng.uniform(0, 0.5, (m, p, 2)) * np.array([2 / (w - 1), 2 / (h - 1)])
    return g, grid.astype(np.float32)


@pytest.mark.parametrize("kind,shape,band_pix,splits", [
    ("uniform", (2, 8, 8, 16, 300), 64, 1),
    ("uniform", (2, 8, 8, 16, 300), 64, 2),
    ("uniform", (2, 8, 8, 16, 300), 64, 3),
    ("uniform", (1, 6, 5, 7, 130), 30, 3),  # 2 tiles in 3 splits: the last gets no point
    ("uniform", (2, 5, 7, 7, 200), 12, 2),  # C = 7: one ragged slice; ragged last band
    ("uniform", (1, 4, 4, 641, 140), 16, 2),  # C = 641: 21 slices, the last of 1 channel
    ("top rows", (2, 8, 8, 16, 200), 16, 2),  # bands 1-3 (rows 2-7) no point reaches
    ("one pixel", (2, 8, 8, 9, 400), 16, 3),  # every point on the same 2 x 2 pixels
])
def test_split_plain_matches_jax_vjp(kind, shape, band_pix, splits):
    from custom_diffusion360_torch.ops.onehot_sample import bilinear_sample_bwd_split_plain

    m, h, w, c, p = shape
    g, grid = _split_case(kind, sum(shape) + splits, m, h, w, c, p)
    want = _jax_vjp((m, h, w, c), grid, g)
    got = bilinear_sample_bwd_split_plain(t(g), t(grid), (m, h, w, c), band_pix, splits)
    assert got.shape == (m, h, w, c)
    assert max_err(got, want) <= TOL * float(np.abs(want).max())
    if kind == "top rows":
        assert float(got[:, 2:].abs().max()) == 0.0 and float(np.abs(want[:, 2:]).max()) == 0.0


@pytest.mark.parametrize("splits", [1, 3])
def test_split_plain_all_points_outside_is_zero(splits):
    from custom_diffusion360_torch.ops.onehot_sample import bilinear_sample_bwd_split_plain

    g, grid = _split_case("outside", 3, 2, 8, 8, 7, 300)
    assert float(np.abs(_jax_vjp((2, 8, 8, 7), grid, g)).max()) == 0.0
    got = bilinear_sample_bwd_split_plain(t(g), t(grid), (2, 8, 8, 7), 16, splits)
    assert float(got.abs().max()) == 0.0


def test_backward_plan_on_132_sms():
    """Bands and point splits the kernel launches with on an H100."""
    from custom_diffusion360_torch.ops.onehot_sample import bwd_plan

    # the training shapes: under one wave (164 blocks two a SM, 84 one a
    # SM), 3 splits give 2 waves of a third of the points each
    assert bwd_plan(4, 16, 16, 1288, 6144, 4, 132) == (256, 3)
    assert bwd_plan(4, 32, 32, 648, 12288, 4, 132) == (1024, 3)
    # 64^2: 4 bands of 1024 pixels, 336 blocks already fill the card
    assert bwd_plan(4, 64, 64, 648, 12288, 4, 132) == (1024, 1)
    # 40^2: two equal bands of 800 pixels
    assert bwd_plan(4, 40, 40, 648, 12288, 4, 132)[0] == 800
    # never more splits than point tiles, never below 1
    assert bwd_plan(1, 8, 8, 7, 200, 4, 132) == (64, 2)
    assert bwd_plan(1, 8, 8, 7, 0, 4, 132) == (64, 1)
    assert bwd_plan(1, 8, 8, 7, 10**6, 4, 132) == (64, 4)
    # a card with few SMs: the blocks fill it, no split
    assert bwd_plan(4, 32, 32, 648, 12288, 4, 16) == (1024, 1)


def test_backward_layout_matches_the_kernel_source():
    """The Python plan sizes blocks with the kernel's own constants."""
    import re
    from pathlib import Path

    import custom_diffusion360_torch.ops.onehot_sample as tos

    src = (Path(tos.__file__).parent.parent / "csrc" / "bilinear_sample_bwd.cu").read_text()
    consts = {k: int(v) for k, v in re.findall(r"constexpr int (\w+) = (\d+);", src)}
    assert (consts["CS"], consts["TP"], consts["STAGES"], consts["MAX_PIX"]) == (
        tos.BWD_CS, tos.BWD_TP, tos.BWD_STAGES, tos.BWD_MAX_PIX)
    # the largest block (f32, a full band) fits the 227 KB a block may use
    assert tos.bwd_smem_bytes(tos.BWD_MAX_PIX, 4) <= 232448
    assert tos.bwd_smem_bytes(256, 4) == 128 + 4 * 128 * (128 + 32) + 256 * 128
