"""Attention port vs the JAX package: the Pallas kernels in interpret mode
(as tests/test_block_attention.py runs them) and the XLA reference of the
long-KV flash row. On the CPU the port's kernel wrapper runs its plain f32
version; tolerance 2e-5 (f32 on both sides, different summation order)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import custom_diffusion360_tpu.ops.block_attention as ba
from custom_diffusion360_tpu.ops import attention as jat
from custom_diffusion360_torch.ops import attention as tat
from custom_diffusion360_torch.ops import block_attention as tba
from tests.test_torch_common import max_err, t

TOL = 2e-5


@pytest.fixture(autouse=True)
def interpret_mode(monkeypatch):
    monkeypatch.setattr(ba, "_INTERPRET", True)


def _qkv(rng, b, h, n, m, d):
    q = rng.normal(size=(b, h, n, d)).astype(np.float32)
    k = rng.normal(size=(b, h, m, d)).astype(np.float32)
    v = rng.normal(size=(b, h, m, d)).astype(np.float32)
    return q, k, v


@pytest.mark.parametrize("n,m,d,kv_len,block_q", [
    (256, 256, 64, None, 128),   # UNet head dim
    (200, 256, 64, None, 128),   # n not a multiple of the q tile
    (128, 77, 64, 77, 128),      # kv_len masking (padded keys)
    (160, 256, 512, 200, 128),   # VAE head dim, masked
])
def test_block_attention_matches_pallas(n, m, d, kv_len, block_q):
    rng = np.random.default_rng(n + d)
    q, k, v = _qkv(rng, 1, 2, n, m, d)
    scale = d**-0.5
    want = ba.block_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              scale, kv_len, block_q)
    got = tba.block_attention(t(q), t(k), t(v), scale, kv_len)
    assert got.shape == (1, 2, n, d)
    assert max_err(got, want) < TOL


def test_qkv_fused_matches_pallas():
    rng = np.random.default_rng(1)
    q, k, v = _qkv(rng, 2, 3, 256, 256, 64)
    packed = np.stack([q, k, v], axis=1)  # (b, 3, h, n, d)
    want = ba.block_attention_qkv_fused(jnp.asarray(packed), 0.125, 128)
    got = tba.block_attention_qkv_fused(t(packed), 0.125)
    assert max_err(got, want) < TOL


def test_qkv_projection_layout_matches_jax():
    """dot_product_attention_qkv from the (b, n, 3*h*d) projection, through
    the kernel wrapper (a strided (b, 3, h, n, d) view)."""
    rng = np.random.default_rng(2)
    b, h, n, d = 2, 4, 192, 64
    qkv = rng.normal(size=(b, n, 3 * h * d)).astype(np.float32)
    want = jat.dot_product_attention_qkv(jnp.asarray(qkv), h)
    got = tat.dot_product_attention_qkv(t(qkv), h)
    assert got.shape == (b, n, h * d)
    assert max_err(got, want) < TOL


def test_long_kv_flash_row_matches_xla():
    """The VAE bottleneck's long-KV single-head attention (the TPU's
    library flash kernel), at a CPU-sized length."""
    rng = np.random.default_rng(3)
    q = rng.normal(size=(1, 1024, 1, 512)).astype(np.float32)
    k = rng.normal(size=(1, 1024, 1, 512)).astype(np.float32)
    v = rng.normal(size=(1, 1024, 1, 512)).astype(np.float32)
    want = jat._xla_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), 512**-0.5)
    got = tat.dot_product_attention(t(q), t(k), t(v))
    assert max_err(got, want) < TOL


def test_padded_kv_matches_jax():
    rng = np.random.default_rng(4)
    q = rng.normal(size=(2, 40, 2, 16)).astype(np.float32)
    k = rng.normal(size=(2, 128, 2, 16)).astype(np.float32)
    v = rng.normal(size=(2, 128, 2, 16)).astype(np.float32)
    want = jat.attention_padded_kv(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), 77)
    got = tat.attention_padded_kv(t(q), t(k), t(v), 77)
    assert max_err(got, want) < TOL


def test_auto_dispatch_on_cpu_is_plain_and_uncounted():
    rng = np.random.default_rng(5)
    q = t(rng.normal(size=(1, 300, 2, 64)).astype(np.float32))
    before = tba.attention_fwd.launches
    tat.dot_product_attention(q, q, q)
    tat.dot_product_attention_qkv(q.reshape(1, 300, 128).repeat(1, 1, 3), 2)
    assert tba.attention_fwd.launches == before
    assert not tba.attention_fwd.launches_by_shape


def test_kernel_wrapper_rejects_what_it_cannot_take():
    """The CUDA-side checks run before any launch: validate them on meta
    tensors (no device needed)."""
    with pytest.raises(TypeError, match="bfloat16"):
        tba._check_operand(torch.empty((1, 2, 8, 64), device="meta"), "q")
    with pytest.raises(ValueError, match="stride"):
        tba._check_operand(
            torch.empty((1, 2, 8, 70), dtype=torch.bfloat16, device="meta")[..., :64], "q"
        )
