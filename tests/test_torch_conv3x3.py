"""The 3x3 VAE conv of the port (ops/conv3x3.py) vs the JAX package's
implicit-GEMM Pallas kernel in interpret mode (as tests/test_ops.py runs
it), its gradient, its shape gate and the CD360_VAE_CONV=pallas decode. On
the CPU the port's wrapper runs its plain f32 version; tolerance 1e-4
absolute (f32 on both sides, different summation order, outputs O(1)) for
the conv and the decode, 1e-3 relative to the gradients' scale."""
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
