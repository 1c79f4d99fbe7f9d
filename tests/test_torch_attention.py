"""Attention port vs the JAX package: the Pallas kernels in interpret mode
(as tests/test_block_attention.py runs them) and the XLA reference of the
long-KV flash row. On the CPU the port's kernel wrapper runs its plain f32
version; tolerance 2e-5 (f32 on both sides, different summation order)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import custom_diffusion360_tpu.ops.block_attention as ba
from custom_diffusion360_tpu.ops import attention as jat
from custom_diffusion360_torch.ops import attention as tat
from custom_diffusion360_torch.ops import block_attention as tba
from tests.test_torch_common import max_err, t
from tests.test_torch_common import torch_threads  # noqa: F401  (fixture)

pytestmark = pytest.mark.usefixtures("torch_threads")

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
    before = sum(tba.attention_fwd.launches_by_shape.values())
    tat.dot_product_attention(q, q, q)
    tat.dot_product_attention_qkv(q.reshape(1, 300, 128).repeat(1, 1, 3), 2)
    assert sum(tba.attention_fwd.launches_by_shape.values()) == before
    assert not tba.attention_fwd.launches_by_shape


def test_kernel_wrapper_rejects_what_it_cannot_take():
    """The CUDA-side checks run before any launch (``tma_map_args``, for
    both kernels): validate them on meta tensors at d = 512 (no device
    needed)."""
    ok = torch.empty((1, 2, 8, 512), dtype=torch.bfloat16, device="meta")
    with pytest.raises(TypeError, match="bfloat16"):
        tba.tma_map_args(torch.empty((1, 2, 8, 512), device="meta"), ok, ok, ok)
    with pytest.raises(ValueError, match="stride"):
        tba.tma_map_args(
            torch.empty((1, 2, 8, 516), dtype=torch.bfloat16, device="meta")[..., :512], ok, ok, ok
        )


# ---------------------------------------------------------------------------
# the TMA map arguments of csrc/attention_sm90.cu (d = 64), from the strides
# of each layout the paths launch, against values worked out by hand
# ---------------------------------------------------------------------------


def _bf16(*shape):
    return torch.zeros(shape, dtype=torch.bfloat16)


def _out(b, n, h):
    return _bf16(b, n, h, 64).transpose(1, 2)  # what the wrapper allocates


def _packed(b, n, h):
    q5 = _bf16(b, n, 3 * h * 64).view(b, n, 3, h, 64).permute(0, 2, 3, 1, 4)
    return q5[:, 0], q5[:, 1], q5[:, 2], _out(b, n, h)


def _bnhd_views(b, n, m, h):
    q, k, v = _bf16(b, n, h, 64), _bf16(b, m, h, 64), _bf16(b, m, h, 64)
    return q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), _out(b, n, h)


def _bhnd(b, n, m, h):
    return _bf16(b, h, n, 64), _bf16(b, h, m, 64), _bf16(b, h, m, 64), _out(b, n, h)


@pytest.mark.parametrize("operands,offsets,strides,layout", [
    # (b, n, 3, h, d) = (2, 5, 3, 3, 64): a token row is 3 * 3 * 64 * 2 = 1152
    # bytes; k and v start 3 heads (384 bytes) and 6 heads (768) after q
    (_packed(2, 5, 3), [0, 384, 768, 0],
     [1152, 128, 5760] * 3 + [384, 128, 1920], "packed"),
    # (b, n, h, d) storage: q (2, 5, 3), k/v (2, 7, 3)
    (_bnhd_views(2, 5, 7, 3), [0] * 4,
     [384, 128, 1920] + [384, 128, 2688] * 2 + [384, 128, 1920], "bnhd"),
    # contiguous (b, h, n, d): q (2, 3, 5), k/v (2, 3, 7)
    (_bhnd(2, 5, 7, 3), [0] * 4,
     [128, 640, 1920] + [128, 896, 2688] * 2 + [384, 128, 1920], "bhnd"),
    # b = h = 1: the unit dims get the operand's span (5 rows = 640 bytes)
    (_bhnd(1, 5, 5, 1), [0] * 4, [128, 640, 640] * 4, "bhnd"),
])
def test_tma_map_args_match_hand_worked_strides(operands, offsets, strides, layout):
    assert tba.tma_map_args(*operands) == (tuple(offsets), tuple(strides))
    assert tba.layout_of(operands[0]) == layout


@pytest.mark.parametrize("bad,exc,match", [
    (torch.zeros((1, 2, 8, 64)), TypeError, "bfloat16"),                    # f32
    (_bf16(1, 2, 8, 32), ValueError, "d = 64"),                              # head dim
    (_bf16(1, 2, 8, 70)[..., :64], ValueError, "multiple of 16 bytes"),      # 140-byte rows
    (_bf16(1, 2, 8, 72)[..., 4:68], ValueError, "16-byte aligned"),          # 8-byte offset
    (_bf16(1, 2, 64, 64).transpose(2, 3), ValueError, "unit head-dim"),
])
def test_tma_map_args_raise_on_what_tma_cannot_take(bad, exc, match):
    ok = _bf16(1, 2, 8, 64)
    with pytest.raises(exc, match=match):
        tba.tma_map_args(bad, ok, ok, ok)


def test_tma_map_args_keeps_no_operand():
    """The map arguments are computed per launch and hold no reference to
    the operands (a cache keyed by tensors would keep every attention
    operand of a run alive)."""
    import gc
    import weakref

    q = _bf16(1, 2, 8, 64)
    ref = weakref.ref(q)
    tba.tma_map_args(q, q, q, q)
    del q
    gc.collect()
    assert ref() is None


def _out512(b, n, h):
    return _bf16(b, n, h, 512).transpose(1, 2)


@pytest.mark.parametrize("operands,strides,layout", [
    # contiguous (b, h, n, d), d = 512 (1024-byte rows): q (2, 3, 5), k/v
    # (2, 3, 7); out a (b, h, n, d) view of (2, 5, 3, 512) storage
    ((_bf16(2, 3, 5, 512), _bf16(2, 3, 7, 512), _bf16(2, 3, 7, 512), _out512(2, 5, 3)),
     [1024, 5120, 15360] + [1024, 7168, 21504] * 2 + [3072, 1024, 15360], "bhnd"),
    # (b, n, h, d) storage: q (2, 5, 3), k/v (2, 7, 3)
    (tuple(x.transpose(1, 2) for x in (_bf16(2, 5, 3, 512), _bf16(2, 7, 3, 512),
                                       _bf16(2, 7, 3, 512))) + (_out512(2, 5, 3),),
     [3072, 1024, 15360] + [3072, 1024, 21504] * 2 + [3072, 1024, 15360], "bnhd"),
    # the training encoder's (1, 1, 4096, 512): the unit dims get the span,
    # 4096 rows of 1024 bytes
    ((_bf16(1, 1, 4096, 512),) * 3 + (_out512(1, 4096, 1),), [1024, 4194304, 4194304] * 4,
     "bhnd"),
])
def test_tma_map_args_at_d512_match_hand_worked_strides(operands, strides, layout):
    assert tba.tma_map_args(*operands) == ((0, 0, 0, 0), tuple(strides))
    assert tba.layout_of(operands[0]) == layout


@pytest.mark.parametrize("bad,exc,match", [
    (torch.zeros((1, 2, 8, 512)), TypeError, "bfloat16"),                     # f32
    (_bf16(1, 2, 8, 64), ValueError, "d = 64 and d = 512 alike"),             # mixed head dims
    (_bf16(1, 2, 8, 516)[..., :512], ValueError, "multiple of 16 bytes"),     # 1032-byte rows
    (_bf16(1, 2, 8, 520)[..., 4:516], ValueError, "16-byte aligned"),         # 8-byte offset
    (_bf16(1, 2, 512, 512).transpose(2, 3), ValueError, "unit head-dim"),
])
def test_tma_map_args_at_d512_raise_on_what_tma_cannot_take(bad, exc, match):
    ok = _bf16(1, 2, 8, 512)
    with pytest.raises(exc, match=match):
        tba.tma_map_args(ok, bad, ok, ok)


@pytest.mark.parametrize("bh,n,m,num_sms,want", [
    (1, 4096, 4096, 132, 2),     # the training encoder: 64 query tiles -> 128 blocks
    (4, 4096, 4096, 132, 1),     # its reference views: 256 blocks already
    (1, 16384, 16384, 132, 1),   # the 1024^2 decoder's mid-block
    (1, 64, 64, 132, 2),         # never more splits than 32-key tiles
])
def test_split_count_keeps_the_grid_within_one_wave(bh, n, m, num_sms, want):
    assert tba.split_count(bh, n, m, num_sms) == want


# ---------------------------------------------------------------------------
# the d = 512 kernel's key splits and merge, in plain f32
# (attention_splitkv_plain), against the JAX Pallas kernel in interpret mode
# and the XLA reference; tolerance TOL (f32 on both sides)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n,m,kv_len,splits", [
    (160, 256, None, 1),
    (160, 256, None, 2),
    (100, 200, None, 3),   # ragged n and m: key runs of 96, 96 and 8
    (160, 256, 100, 2),    # kv_len inside split 0: split 1 has no live key
    (128, 256, 60, 3),     # splits 1 and 2 have no live key
])
def test_splitkv_plain_matches_jax_at_d512(n, m, kv_len, splits):
    rng = np.random.default_rng(n + m + splits)
    q, k, v = _qkv(rng, 1, 2, n, m, 512)
    scale = 512**-0.5
    got = tba.attention_splitkv_plain(t(q), t(k), t(v), scale, kv_len, splits)
    assert got.shape == (1, 2, n, 512) and bool(torch.isfinite(got).all())
    want = ba.block_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), scale, kv_len, 128)
    assert max_err(got, want) < TOL
    if kv_len is None:
        xla = jat._xla_attention(*(jnp.asarray(x.transpose(0, 2, 1, 3)) for x in (q, k, v)), scale)
        assert max_err(got, np.asarray(xla).transpose(0, 2, 1, 3)) < TOL


def test_library_hash_covers_local_headers(tmp_path, monkeypatch):
    """An edited local header rebuilds the library that includes it."""
    from custom_diffusion360_torch.ops import _build

    (tmp_path / "k.cu").write_text('#include "k.cuh"\n#include <cuda_runtime.h>\n')
    (tmp_path / "k.cuh").write_text("// v1\n")
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    first = _build.library_path("k")
    assert _build._sources(tmp_path / "k.cu") == [tmp_path / "k.cu", tmp_path / "k.cuh"]
    (tmp_path / "k.cuh").write_text("// v2\n")
    assert _build.library_path("k") != first


# ---------------------------------------------------------------------------
# gradients: the port's autograd (plain f32 recompute, as the JAX custom
# VJP) against the JAX package's custom-VJP gradients; 1e-5 of max|g|
# ---------------------------------------------------------------------------

GRAD_TOL = 1e-5


def _assert_grads(got, want):
    for a, b in zip(got, want):
        b = np.asarray(b)
        assert max_err(a, b) <= GRAD_TOL * float(np.abs(b).max())


@pytest.mark.parametrize("n,m,d,kv_len", [(256, 256, 64, None), (128, 200, 64, 150)])
def test_block_attention_gradients_match_jax(n, m, d, kv_len):
    rng = np.random.default_rng(n + m)
    q, k, v = _qkv(rng, 1, 2, n, m, d)
    g = rng.normal(size=(1, 2, n, d)).astype(np.float32)
    scale = d**-0.5
    _, vjp = jax.vjp(lambda a, b, c: ba.block_attention(a, b, c, scale, kv_len, 128),
                     jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = vjp(jnp.asarray(g))
    leaves = [t(a).requires_grad_(True) for a in (q, k, v)]
    tba.block_attention(*leaves, scale, kv_len).backward(t(g))
    _assert_grads([leaf.grad for leaf in leaves], want)


def test_qkv_fused_gradient_is_stacked_dq_dk_dv_as_jax():
    rng = np.random.default_rng(7)
    q, k, v = _qkv(rng, 1, 2, 256, 256, 64)
    packed = np.stack([q, k, v], axis=1)
    g = rng.normal(size=(1, 2, 256, 64)).astype(np.float32)
    _, vjp = jax.vjp(lambda x: ba.block_attention_qkv_fused(x, 0.125, 128), jnp.asarray(packed))
    (want,) = vjp(jnp.asarray(g))
    leaf = t(packed).requires_grad_(True)
    tba.block_attention_qkv_fused(leaf, 0.125).backward(t(g))
    assert leaf.grad.shape == packed.shape
    _assert_grads([leaf.grad], [want])


def test_gradient_reaches_the_inputs_through_the_dispatch():
    """A loss through dot_product_attention[_qkv] on the kernel route
    (> KERNEL_MIN_KV keys) gives every input a nonzero gradient."""
    rng = np.random.default_rng(8)
    x = t(rng.normal(size=(1, 160, 2, 64)).astype(np.float32)).requires_grad_(True)
    qkv = t(rng.normal(size=(1, 160, 3 * 128)).astype(np.float32)).requires_grad_(True)
    (tat.dot_product_attention(x * 1.0, x * 0.5, x * 2.0).square().sum()
     + tat.dot_product_attention_qkv(qkv, 2).square().sum()).backward()
    for leaf in (x, qkv):
        assert leaf.grad is not None and float(leaf.grad.abs().max()) > 0


# ---------------------------------------------------------------------------
# the (b, n, h, d) kernel (JAX block_attention_bnhd, interpret mode) and its
# CD360_ATTN_BNHD=1 route
# ---------------------------------------------------------------------------


def _bnhd(rng, b, n, m, h, d):
    return tuple(rng.normal(size=s).astype(np.float32)
                 for s in ((b, n, h, d), (b, m, h, d), (b, m, h, d)))


@pytest.mark.parametrize("n,m,kv_len", [(256, 256, None), (200, 128, 77)])
def test_bnhd_matches_pallas(n, m, kv_len):
    rng = np.random.default_rng(n + m)
    q, k, v = _bnhd(rng, 2, n, m, 3, 64)
    want = ba.block_attention_bnhd(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), 0.125,
                                   kv_len, 128)
    got = tba.block_attention_bnhd(t(q), t(k), t(v), 0.125, kv_len)
    assert got.shape == (2, n, 3, 64)
    assert max_err(got, want) < TOL


@pytest.mark.parametrize("kv_len", [None, 77])
def test_bnhd_gradients_match_jax(kv_len):
    rng = np.random.default_rng(9 if kv_len is None else kv_len)
    q, k, v = _bnhd(rng, 1, 128, 128, 2, 64)
    g = rng.normal(size=q.shape).astype(np.float32)
    _, vjp = jax.vjp(lambda a, b, c: ba.block_attention_bnhd(a, b, c, 0.125, kv_len, 128),
                     jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = vjp(jnp.asarray(g))
    leaves = [t(a).requires_grad_(True) for a in (q, k, v)]
    tba.block_attention_bnhd(*leaves, 0.125, kv_len).backward(t(g))
    _assert_grads([leaf.grad for leaf in leaves], want)


@pytest.mark.parametrize("d,m,kernel", [(64, 160, True), (512, 160, True), (32, 160, False),
                                         (96, 160, False), (64, 128, False)])
def test_dispatch_takes_the_kernel_only_where_jax_takes_pallas(monkeypatch, d, m, kernel):
    """More than KERNEL_MIN_KV keys and d % 64 == 0 (JAX ops/attention.py
    _block_ok): the kernel wrapper; else (a 32-channel autoencoder
    bottleneck, short KV) the plain path, which equals it."""
    rng = np.random.default_rng(11)
    q, k, v = (t(rng.normal(size=(1, s, 1, d)).astype(np.float32)) for s in (150, m, m))
    calls = []
    orig = tba.block_attention
    monkeypatch.setattr(tat, "block_attention", lambda *a: calls.append(1) or orig(*a))
    got = tat.dot_product_attention(q, k, v)
    assert bool(calls) == kernel
    want = jat.dot_product_attention(*(jnp.asarray(x.numpy()) for x in (q, k, v)))
    assert max_err(got, want) < TOL
    calls.clear()
    qkv = t(rng.normal(size=(1, m, 3 * d)).astype(np.float32))
    monkeypatch.setattr(tat, "block_attention_qkv_fused",
                        lambda *a: calls.append(1) or tba.block_attention_qkv_fused(*a))
    tat.dot_product_attention_qkv(qkv, 1)
    assert bool(calls) == kernel


def test_bnhd_switch_routes_long_kv_at_call_time(monkeypatch):
    """CD360_ATTN_BNHD=1, read at each call, sends > KERNEL_MIN_KV keys to
    block_attention_bnhd (same result); short KV stays plain."""
    rng = np.random.default_rng(10)
    q, k, v = (t(a) for a in _bnhd(rng, 1, 160, 160, 2, 64))
    calls = []
    orig = tba.block_attention_bnhd
    monkeypatch.setattr(tat, "block_attention_bnhd",
                        lambda *a: calls.append(a[0].shape) or orig(*a))
    monkeypatch.setenv("CD360_ATTN_BNHD", "1")
    got = tat.dot_product_attention(q, k, v)
    tat.dot_product_attention(q, k[:, :77], v[:, :77])
    assert calls == [(1, 160, 2, 64)]
    monkeypatch.delenv("CD360_ATTN_BNHD")
    want = tat.dot_product_attention(q, k, v)
    assert len(calls) == 1 and max_err(got, want) < TOL
    assert not tba.attention_bnhd_fwd.launches_by_shape  # the CPU runs the plain version
