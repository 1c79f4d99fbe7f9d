"""The 3x3 VAE conv of the port (ops/conv3x3.py) vs the JAX package's
implicit-GEMM Pallas kernel in interpret mode (as tests/test_ops.py runs
it), its gradient, its shape gate and the CD360_VAE_CONV=pallas decode. On
the CPU the port's wrapper runs its plain f32 version; tolerance 1e-4
absolute (f32 on both sides, different summation order, outputs O(1)) for
the conv and the decode, 1e-3 relative to the gradients' scale. The CUDA
side's TMA map arguments and tap coordinates are held to hand-worked values,
and its wrapper runs on meta tensors against a stand-in for the built
library."""
import contextlib
from collections import Counter

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import custom_diffusion360_tpu.models.vae as jvae
import custom_diffusion360_torch.models.vae as tvae
from custom_diffusion360_tpu.ops import conv3x3 as jconv
from custom_diffusion360_torch.ops import conv3x3 as tconv
from tests.test_torch_common import max_err, random_params, t, to_torch
from tests.test_torch_common import torch_threads  # noqa: F401  (fixture)

pytestmark = pytest.mark.usefixtures("torch_threads")

TOL = 1e-4


@pytest.fixture(autouse=True)
def interpret_mode(monkeypatch):
    monkeypatch.setattr(jconv, "_INTERPRET", True)


def _io(seed, b, h, w, c, n):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, h, w, c)).astype(np.float32)
    wt = (rng.normal(size=(3, 3, c, n)) * 0.05).astype(np.float32)  # HWIO
    return x, wt


def _oihw(w_hwio):
    return t(np.ascontiguousarray(w_hwio.transpose(3, 2, 0, 1)))


@pytest.mark.parametrize("shape", [(1, 32, 32, 128, 128), (1, 32, 64, 256, 128)],
                         ids=["c128-n128", "c256-n128"])
def test_conv3x3_matches_pallas(shape):
    x, w = _io(0, *shape)
    assert jconv.conv3x3_supported(jnp.asarray(x), jnp.asarray(w))
    want = jconv.conv3x3_gemm(jnp.asarray(x), jnp.asarray(w))
    got = tconv.conv3x3_gemm(t(x), _oihw(w))
    assert got.shape == want.shape
    assert max_err(got, want) < TOL
    # the bias is added after the conv, as the JAX _conv3
    bias = np.linspace(-1, 1, shape[-1]).astype(np.float32)
    got_b = tconv.conv3x3_gemm(t(x), _oihw(w), t(bias))
    assert max_err(got_b, np.asarray(want) + bias) < TOL


def test_conv3x3_gradients_match_jax():
    x, w = _io(1, 1, 32, 32, 128, 128)
    gx, gw = jax.grad(lambda x, w: jnp.sum(jconv.conv3x3_gemm(x, w) ** 2),
                      argnums=(0, 1))(jnp.asarray(x), jnp.asarray(w))
    xt = t(x).requires_grad_(True)
    wt = _oihw(w).requires_grad_(True)
    bias = torch.zeros(128, requires_grad=True)
    (tconv.conv3x3_gemm(xt, wt, bias) ** 2).sum().backward()
    gx, gw = np.asarray(gx), np.asarray(gw).transpose(3, 2, 0, 1)
    assert max_err(xt.grad, gx) < 1e-3 * np.abs(gx).max()
    assert max_err(wt.grad, gw) < 1e-3 * np.abs(gw).max()
    # d/db sum(y^2) = 2 sum_pixels y
    y = jconv.conv3x3_gemm(jnp.asarray(x), jnp.asarray(w))
    gb = 2 * np.asarray(y).sum((0, 1, 2))
    assert max_err(bias.grad, gb) < 1e-3 * np.abs(gb).max()


@pytest.mark.parametrize("shape,dtype", [
    ((1, 32, 32, 128), "float32"), ((2, 64, 32, 256), "bfloat16"),
    ((1, 16, 32, 128), "float32"),   # H not a multiple of 32
    ((1, 32, 48, 128), "float32"),   # W not a multiple of 32
    ((1, 32, 32, 64), "float32"),    # C not a multiple of 128
    ((1, 32, 32, 4), "float32"),     # conv_in of the decoder
    ((1, 32, 32, 128), "float16"),
])
@pytest.mark.parametrize("n", [128, 3, 256])
def test_gate_matches_jax(shape, dtype, n):
    c = shape[-1]
    jx = jnp.zeros(shape, dtype)
    jw = jnp.zeros((3, 3, c, n), jnp.float32)
    tx = torch.zeros(shape, dtype=getattr(torch, dtype))
    tw = torch.zeros((n, c, 3, 3))
    assert tconv.conv3x3_supported(tx, tw) == jconv.conv3x3_supported(jx, jw)


def test_vae_pallas_decode_matches_jax(monkeypatch):
    """VAEConfig(ch=128, ch_mult=(1, 1), num_res_blocks=1): every res-block
    conv and the upsample conv pass the gate, conv_in/conv_out do not."""
    cfg_kw = dict(ch=128, ch_mult=(1, 1), num_res_blocks=1)
    params = random_params(lambda k: jvae.init_vae_params(k, jvae.VAEConfig(**cfg_kw)), seed=5)
    z = (np.random.default_rng(6).normal(size=(1, 32, 32, 4)) * 0.3).astype(np.float32)
    monkeypatch.setenv("CD360_VAE_CONV", "pallas")
    want = jvae.decode_first_stage(jax.tree.map(jnp.asarray, params), jnp.asarray(z),
                                   jvae.VAEConfig(**cfg_kw))
    calls = []
    orig = tconv.conv3x3_gemm
    monkeypatch.setattr(tconv, "conv3x3_gemm", lambda *a: calls.append(a[0].shape) or orig(*a))
    got = tvae.decode_first_stage(to_torch(params), t(z), tvae.VAEConfig(**cfg_kw))
    # decoder: mid 2 res blocks + 2 levels x 2 res blocks (2 convs each), one upsample
    assert len(calls) == 13
    assert max_err(got, want) < TOL * max(1.0, float(np.abs(np.asarray(want)).max()))
    monkeypatch.setenv("CD360_VAE_CONV", "xla")
    calls.clear()
    got_xla = tvae.decode_first_stage(to_torch(params), t(z), tvae.VAEConfig(**cfg_kw))
    assert not calls and max_err(got_xla, want) < TOL * max(
        1.0, float(np.abs(np.asarray(want)).max()))


def test_weight_relayout_is_made_once_per_parameter():
    w = torch.randn(128, 128, 3, 3)
    a = tconv.relaid_weight(w, torch.float32)
    assert tconv.relaid_weight(w, torch.float32) is a
    assert a.shape == (128, 3, 3, 128) and torch.equal(a, w.permute(0, 2, 3, 1))
    w.mul_(2.0)  # modified in place: made again
    b = tconv.relaid_weight(w, torch.float32)
    assert b is not a and torch.equal(b, w.permute(0, 2, 3, 1))
    key = id(w)
    del w, a, b
    assert key not in tconv._RELAID


def test_weight_relayout_of_inference_tensors():
    """Weights made under inference_mode (the CLI's) have no version
    counter; the copy is still made once."""
    with torch.inference_mode():
        w = torch.randn(128, 128, 3, 3)
        a = tconv.relaid_weight(w, torch.bfloat16)
        assert tconv.relaid_weight(w, torch.bfloat16) is a
        assert a.dtype == torch.bfloat16 and a.shape == (128, 3, 3, 128)


# hand-worked: x (1, 128, 128, 512) -> 512 channels, the decoder's bottleneck
# convs (256 output channels a tile), and x (1, 1024, 1024, 256) -> 128, its
# last level's first conv (128 a tile). Dims innermost first, in elements;
# strides in bytes of the outer dims; boxes of 64 channels x 16 x 8 pixels
# (x), 64 x BN (weight, K-major (N, 9C)) and 64 channels x 16 x 4 pixels
# (out: one consumer warpgroup's 64 rows).
_MAPS = {
    (1, 128, 128, 512, 512): (
        (512, 128, 128, 1), (1024, 131072, 16777216), (64, 16, 8, 1),
        (4608, 512), (9216,), (64, 256),
        (512, 128, 128, 1), (1024, 131072, 16777216), (64, 16, 4, 1)),
    (1, 1024, 1024, 256, 128): (
        (256, 1024, 1024, 1), (512, 524288, 536870912), (64, 16, 8, 1),
        (2304, 128), (4608,), (64, 128),
        (128, 1024, 1024, 1), (256, 262144, 268435456), (64, 16, 4, 1)),
}


@pytest.mark.parametrize("shape", sorted(_MAPS), ids=["128sq-512-512", "1024sq-256-128"])
def test_conv3x3_map_args_match_hand_worked_values(shape):
    assert tconv.conv3x3_map_args(*shape) == _MAPS[shape]


@pytest.mark.parametrize("tap,chunk,c,b,y0,x0,n0,want", [
    # top-left tile, first tap: the box starts one pixel above and left of
    # the image (TMA zero-fills that row and column)
    (0, 1, 512, 0, 0, 0, 256, ((64, -1, -1, 0), (64, 256))),
    # the centre tap reads the tile itself; weight column 4 C + c0
    (4, 3, 512, 0, 64, 32, 0, ((192, 32, 64, 0), (2240, 0))),
    # bottom-right tile of a 128^2 image, last tap and chunk: one past the end
    (8, 7, 512, 0, 120, 112, 256, ((448, 113, 121, 0), (4544, 256))),
    # second image, right-middle tap of 256 input channels
    (5, 2, 256, 1, 8, 16, 128, ((128, 17, 8, 1), (1408, 128))),
])
def test_conv3x3_tap_box_coordinates(tap, chunk, c, b, y0, x0, n0, want):
    assert tconv.tap_box_coords(tap, chunk, c, b, y0, x0, n0) == want


@pytest.mark.parametrize("shape", [(1, 12, 32, 128, 128), (1, 32, 24, 128, 128),
                                   (1, 32, 32, 96, 128), (1, 32, 32, 128, 64),
                                   (0, 32, 32, 128, 128)],
                         ids=["h12", "w24", "c96", "n64", "b0"])
def test_conv3x3_map_args_refuse_what_the_kernel_cannot_take(shape):
    with pytest.raises(ValueError, match="conv3x3 kernel tiles"):
        tconv.conv3x3_map_args(*shape)


@pytest.fixture
def stand_in_kernel(monkeypatch):
    """``conv3x3_fwd``'s CUDA side on meta tensors, against a stand-in entry
    point that records its arguments; the counters are put back after."""
    calls = []
    monkeypatch.setattr(tconv._build, "load",
                        lambda name: lambda *args: calls.append((name, args)) or 0)
    monkeypatch.setattr(tconv._build, "on_device", lambda index: contextlib.nullcontext())
    monkeypatch.setattr(tconv._build, "current_stream", lambda index: 7)
    monkeypatch.setattr(tconv, "_kernel", None)
    monkeypatch.setattr(tconv.conv3x3_fwd, "launches", 0)
    monkeypatch.setattr(tconv.conv3x3_fwd, "launches_by_shape", Counter())
    return calls


@pytest.mark.parametrize("shape", sorted(_MAPS), ids=["128sq-512-512", "1024sq-256-128"])
def test_conv3x3_wrapper_passes_the_maps(stand_in_kernel, shape):
    b, h, w, c, n = shape
    x = torch.empty((b, h, w, c), dtype=torch.bfloat16, device="meta")
    wt = torch.empty((n, c, 3, 3), dtype=torch.bfloat16, device="meta")
    bias = torch.empty((n,), dtype=torch.float32, device="meta")
    out = tconv.conv3x3_fwd(x, wt, bias)
    assert out.shape == (b, h, w, n) and out.dtype == torch.bfloat16
    ((name, args),) = stand_in_kernel
    assert name == "conv3x3" and args[-1] == 7
    assert list(args[4]) == [v for part in _MAPS[shape] for v in part]
    assert tconv.conv3x3_fwd.launches_by_shape == Counter({shape: 1})


def test_conv3x3_wrapper_refuses_before_launching(stand_in_kernel):
    x = torch.empty((1, 32, 32, 128), dtype=torch.bfloat16, device="meta")
    with pytest.raises(ValueError, match="does not take"):
        tconv.conv3x3_fwd(x, torch.empty((128, 64, 3, 3), device="meta"))
    with pytest.raises(ValueError, match="bias of shape"):
        tconv.conv3x3_fwd(x, torch.empty((128, 128, 3, 3), device="meta"),
                          torch.empty((64,), device="meta"))
    assert not stand_in_kernel
