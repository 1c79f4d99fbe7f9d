"""LayerNorm and GroupNorm(+SiLU) of the port vs the JAX package, on the CPU
in float32: the wrappers' plain versions (forward and gradients) against
``ops/norms.layer_norm_fused`` / ``group_norm_fused`` with their Pallas
kernels in interpret mode (C % 128 == 0) or their XLA path (odd C), the
models' ``nn.layer_norm`` / ``group_norm[_silu]`` against ``models/nn``, and
``trunc_exp``'s clipped gradient. The CUDA wrappers' checks and launch
arguments run on meta tensors against a stand-in for the built library.

Tolerances: 2e-5 absolute on unit-scale outputs (f32 on both sides,
different summation order); gradients 1e-5 of max|g|.
"""
import contextlib
from collections import Counter

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import custom_diffusion360_tpu.ops.norms as jnorms
from custom_diffusion360_tpu.models import nn as jnn
from custom_diffusion360_torch.models import nn as tnn
from custom_diffusion360_torch.ops import norms as tnorms
from tests.test_torch_common import max_err, t
from tests.test_torch_common import torch_threads  # noqa: F401  (fixture)

pytestmark = pytest.mark.usefixtures("torch_threads")

TOL = 2e-5
GRAD_TOL = 1e-5  # of max|g|


@pytest.fixture(autouse=True)
def interpret_mode(monkeypatch):
    monkeypatch.setattr(jnorms, "_INTERPRET", True)


def _affine(rng, c):
    return (1.0 + 0.1 * rng.normal(size=(c,))).astype(np.float32), \
        (0.1 * rng.normal(size=(c,))).astype(np.float32)


def _grads_torch(fn, x, scale, bias, g):
    leaves = [t(a).requires_grad_(True) for a in (x, scale, bias)]
    y = fn(*leaves)
    y.backward(t(g))
    return y.detach(), [leaf.grad for leaf in leaves]


def _grads_jax(fn, x, scale, bias, g):
    y, vjp = jax.vjp(fn, jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias))
    return y, vjp(jnp.asarray(g))


def _assert_grads(got, want):
    for a, b in zip(got, want):
        b = np.asarray(b)
        assert max_err(a, b) <= GRAD_TOL * max(float(np.abs(b).max()), 1e-6)


@pytest.mark.parametrize("shape", [(4, 9, 256), (3, 40), (2, 5, 72)])  # kernel, odd C
def test_layer_norm_matches_jax_fused(shape):
    rng = np.random.default_rng(shape[-1])
    x = (rng.normal(size=shape) * 2 + 0.5).astype(np.float32)
    scale, bias = _affine(rng, shape[-1])
    g = rng.normal(size=shape).astype(np.float32)
    y_t, grads_t = _grads_torch(lambda a, s, b: tnorms.layer_norm_fused(a, s, b, 1e-5),
                                x, scale, bias, g)
    y_j, grads_j = _grads_jax(lambda a, s, b: jnorms.layer_norm_fused(a, s, b, 1e-5),
                              x, scale, bias, g)
    assert max_err(y_t, y_j) < TOL
    assert max_err(tnorms._ln_plain(t(x), t(scale), t(bias), 1e-5),
                   jnorms._ln_xla(jnp.asarray(x), scale, bias, 1e-5)) < TOL
    _assert_grads(grads_t, grads_j)


@pytest.mark.parametrize("act", [None, "silu"])
@pytest.mark.parametrize("shape,groups", [
    ((2, 8, 8, 256), 32),   # the Pallas kernel (C % 128 == 0, rows % 8 == 0)
    ((3, 5, 7, 96), 32),    # odd spatial extent: the XLA path
    ((2, 6, 40), 8),        # odd C, another group count
])
def test_group_norm_matches_jax_fused(shape, groups, act):
    rng = np.random.default_rng(shape[-1] + groups)
    x = (rng.normal(size=shape) * 3 - 1.0).astype(np.float32)
    scale, bias = _affine(rng, shape[-1])
    g = rng.normal(size=shape).astype(np.float32)
    y_t, grads_t = _grads_torch(
        lambda a, s, b: tnorms.group_norm_fused(a, s, b, groups, 1e-6, act), x, scale, bias, g)
    y_j, grads_j = _grads_jax(
        lambda a, s, b: jnorms.group_norm_fused(a, s, b, groups, 1e-6, act), x, scale, bias, g)
    assert y_t.shape == shape
    assert max_err(y_t, y_j) < TOL
    _assert_grads(grads_t, grads_j)


def test_norm_wrappers_on_cpu_are_plain_and_uncounted():
    rng = np.random.default_rng(0)
    x = t(rng.normal(size=(2, 16, 64)).astype(np.float32))
    s, b = (t(a) for a in _affine(rng, 64))
    before = (tnorms.layer_norm_fused.launches, tnorms.group_norm_fused.launches)
    assert max_err(tnorms.layer_norm_fused(x, s, b), tnorms._ln_plain(x, s, b, 1e-5)) == 0.0
    assert max_err(tnorms.group_norm_fused(x, s, b, 32, 1e-6, "silu"),
                   tnorms._gn_plain(x, s, b, 32, 1e-6, "silu")) == 0.0
    assert (tnorms.layer_norm_fused.launches, tnorms.group_norm_fused.launches) == before
    assert not tnorms.layer_norm_fused.launches_by_shape
    assert not tnorms.group_norm_fused.launches_by_shape


def test_norm_kernel_checks_reject_what_they_cannot_take():
    """The CUDA-side checks run before any launch: validate them on meta
    tensors (no device needed)."""
    with pytest.raises(ValueError, match="divisible by 8"):
        tnorms._check_input(torch.empty((4, 12), device="meta"), "layer_norm")
    with pytest.raises(TypeError, match="bf16 or f32"):
        tnorms._check_input(torch.empty((4, 16), dtype=torch.float16, device="meta"),
                            "layer_norm")
    with pytest.raises(ValueError, match="contiguous"):
        tnorms._check_input(torch.empty((16, 4), device="meta").t(), "group_norm")


@pytest.mark.parametrize("mode", ["grad", "no_grad", "inference_mode"])
def test_layer_norm_grad_modes_agree_and_skip_autograd(mode):
    """The same output with grad enabled, under no_grad and under
    inference_mode; the last two build no graph (the wrapper skips its
    autograd Function), and with grad enabled the gradient is still the
    closed form of JAX ``_ln_bwd``."""
    rng = np.random.default_rng(11)
    x = (rng.normal(size=(3, 7, 64)) * 2 + 0.5).astype(np.float32)
    scale, bias = _affine(rng, 64)
    g = rng.normal(size=x.shape).astype(np.float32)
    want, grads_j = _grads_jax(lambda a, s, b: jnorms.layer_norm_fused(a, s, b, 1e-5),
                               x, scale, bias, g)
    if mode == "grad":
        got, grads_t = _grads_torch(lambda a, s, b: tnorms.layer_norm_fused(a, s, b, 1e-5),
                                    x, scale, bias, g)
        _assert_grads(grads_t, grads_j)
    else:
        leaves = [t(a).requires_grad_(True) for a in (x, scale, bias)]
        ctx = torch.no_grad() if mode == "no_grad" else torch.inference_mode()
        with ctx:
            got = tnorms.layer_norm_fused(*leaves, 1e-5)
        assert got.grad_fn is None and not got.requires_grad
    assert max_err(got, want) < TOL


def test_layer_norm_without_grad_inputs_builds_no_graph():
    x, s, b = (torch.ones(4, 16), torch.ones(16), torch.zeros(16))
    assert tnorms.layer_norm_fused(x, s, b).grad_fn is None
    assert tnorms.layer_norm_fused(x, s.requires_grad_(True), b).grad_fn is not None


@pytest.mark.parametrize("mode", ["grad", "no_grad", "inference_mode"])
def test_group_norm_grad_modes_agree_and_skip_autograd(mode):
    """As the LayerNorm test: the same output in all three modes, no graph
    under no_grad and inference_mode, and with grad enabled the gradients of
    JAX ``group_norm_fused`` (the VJP of its plain version)."""
    rng = np.random.default_rng(12)
    x = (rng.normal(size=(2, 8, 8, 256)) * 3 - 1.0).astype(np.float32)
    scale, bias = _affine(rng, 256)
    g = rng.normal(size=x.shape).astype(np.float32)
    want, grads_j = _grads_jax(
        lambda a, s, b: jnorms.group_norm_fused(a, s, b, 32, 1e-6, "silu"), x, scale, bias, g)
    if mode == "grad":
        got, grads_t = _grads_torch(
            lambda a, s, b: tnorms.group_norm_fused(a, s, b, 32, 1e-6, "silu"), x, scale, bias, g)
        _assert_grads(grads_t, grads_j)
    else:
        leaves = [t(a).requires_grad_(True) for a in (x, scale, bias)]
        ctx = torch.no_grad() if mode == "no_grad" else torch.inference_mode()
        with ctx:
            got = tnorms.group_norm_fused(*leaves, 32, 1e-6, "silu")
        assert got.grad_fn is None and not got.requires_grad
    assert max_err(got, want) < TOL


def test_group_norm_without_grad_inputs_builds_no_graph():
    x, s, b = (torch.ones(2, 4, 64), torch.ones(64), torch.zeros(64))
    assert tnorms.group_norm_fused(x, s, b, 32).grad_fn is None
    assert tnorms.group_norm_fused(x, s, b.requires_grad_(True), 32).grad_fn is not None


@pytest.fixture
def stand_in_kernels(monkeypatch):
    """The norm wrappers' CUDA side on meta tensors: ``_build.load`` returns
    a stand-in entry point that records its arguments and reports success;
    the launch counters start empty and are put back afterwards."""
    calls = []

    def load(name):
        return lambda *args: calls.append((name, args)) or 0

    monkeypatch.setattr(tnorms._build, "load", load)
    monkeypatch.setattr(tnorms._build, "on_device", lambda index: contextlib.nullcontext())
    monkeypatch.setattr(tnorms._build, "current_stream", lambda index: 7)
    for name in ("_ln_kernel", "_gn_kernel"):
        monkeypatch.setattr(tnorms, name, None)
    for fn in (tnorms.layer_norm_fused, tnorms.group_norm_fused):
        monkeypatch.setattr(fn, "launches", 0)
        monkeypatch.setattr(fn, "launches_by_shape", Counter())
    return calls


@pytest.mark.parametrize("norm", ["layer_norm", "group_norm"])
@pytest.mark.parametrize("scale,bias,match", [
    (((64,), "f32"), ((64,), "f32"), None),             # accepted
    (((64,), "bf16"), ((64,), "bf16"), None),           # bf16 parameters, as they are
    (((64,), "f16"), ((64,), "f16"), "both bf16 or both f32"),
    (((64,), "f32"), ((64,), "bf16"), "both bf16 or both f32"),  # mixed
    (((63,), "f32"), ((63,), "f32"), "shape"),
    (((2, 32), "f32"), ((64,), "f32"), "shape"),
    (("strided", "f32"), ((64,), "f32"), "contiguous"),
])
def test_layer_norm_param_checks(stand_in_kernels, scale, bias, match, norm):
    """What both norm kernels read scale and bias as: (C,) contiguous,
    16-byte aligned, both bf16 or both f32. Through the wrappers on meta
    tensors: a refused pair raises before any launch, an accepted one
    reaches the entry point with its dtype code (0 bf16, 1 f32) and no
    copy."""
    dt = {"f32": torch.float32, "bf16": torch.bfloat16, "f16": torch.float16}

    def make(spec):
        shape, dtype = spec
        if shape == "strided":
            return torch.empty((128,), dtype=dt[dtype], device="meta")[::2]
        return torch.empty(shape, dtype=dt[dtype], device="meta")

    x = torch.empty((4, 64), dtype=torch.bfloat16, device="meta")
    s, b = make(scale), make(bias)
    run = {"layer_norm": lambda: tnorms.layer_norm_fused(x, s, b),
           "group_norm": lambda: tnorms.group_norm_fused(x, s, b, 32)}[norm]
    if match is None:
        run()
        ((name, args),) = stand_in_kernels
        assert name == norm and args[1:3] == (s.data_ptr(), b.data_ptr())
        assert args[-2] == {"f32": 1, "bf16": 0}[scale[1]] and args[-1] == 7
    else:
        with pytest.raises((TypeError, ValueError), match=match):
            run()
        assert not stand_in_kernels


@pytest.mark.parametrize("shape,groups,act,chunks", [
    ((1, 1024, 1024, 128), 32, "silu", 132),  # the VAE at 1024^2: one chunk per SM
    ((1, 128, 128, 128), 32, "silu", 64),     # 256-row chunks (64 rows in parallel x 4)
    ((3, 1024, 1280), 32, None, 43),          # the x3 UNet batch: 24-row chunks
    ((2, 5, 40), 8, "silu", 1),               # fewer rows than one pass
    ((1, 4096, 512), 256, None, 16),          # 132 * 32 partials at most
])
def test_group_norm_wrapper_launch_arguments(stand_in_kernels, shape, groups, act, chunks):
    """One launch of the entry point a call with (x, scale, bias, y,
    partial, N, HW, C, G, chunks, eps, act, dtype, param dtype, stream),
    chunks from ``gn_chunks`` (hand-worked here), and the launch counted by
    shape."""
    x = torch.empty(shape, dtype=torch.bfloat16, device="meta")
    c = shape[-1]
    s, b = (torch.empty((c,), dtype=torch.float32, device="meta") for _ in range(2))
    y = tnorms.group_norm_fused(x, s, b, groups, 1e-6, act)
    assert y.shape == x.shape and y.dtype == x.dtype
    ((name, args),) = stand_in_kernels
    hw = x.numel() // (shape[0] * c)
    assert name == "group_norm" and tnorms.gn_chunks(shape[0], hw, c, 2, groups) == chunks
    assert args[5:] == (shape[0], hw, c, groups, chunks, 1e-6, int(act == "silu"), 0, 1, 7)
    assert tnorms.group_norm_fused.launches == 1
    assert tnorms.group_norm_fused.launches_by_shape == Counter(
        {(shape[0], hw, c, groups, act or "none", "bf16"): 1})


@pytest.mark.parametrize("c,groups,act,match", [
    (64, 3, None, "groups dividing"), (512, 512, None, "at most 256 groups"),
    (16384, 32, None, "at most 16 KB"), (64, 32, "gelu", "act"),
])
def test_group_norm_wrapper_refuses_what_the_kernel_cannot_take(stand_in_kernels, c, groups,
                                                                act, match):
    x = torch.empty((2, 4, c), dtype=torch.bfloat16, device="meta")
    s, b = (torch.empty((c,), dtype=torch.bfloat16, device="meta") for _ in range(2))
    with pytest.raises(ValueError, match=match):
        tnorms.group_norm_fused(x, s, b, groups, 1e-6, act)
    assert not stand_in_kernels


@pytest.mark.parametrize("fn", ["layer_norm", "group_norm", "group_norm_silu"])
def test_model_norms_on_cpu_match_jax_nn(fn):
    rng = np.random.default_rng(len(fn))
    x = (rng.normal(size=(2, 6, 6, 64)) * 2 + 1).astype(np.float32)
    scale, bias = _affine(rng, 64)
    p_t = {"scale": t(scale), "bias": t(bias)}
    p_j = {"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)}
    got = getattr(tnn, fn)(p_t, t(x))
    want = getattr(jnn, fn)(p_j, jnp.asarray(x))
    assert max_err(got, want) < TOL


def test_trunc_exp_gradient_is_clipped_as_jax():
    x = np.array([-40.0, -15.5, -3.0, 0.0, 2.5, 15.0, 16.0, 30.0], np.float32)
    xt = t(x).requires_grad_(True)
    y = tnn.trunc_exp(xt)
    y.sum().backward()
    want_y = jnn.trunc_exp(jnp.asarray(x))
    want_g = jax.grad(lambda a: jnn.trunc_exp(a).sum())(jnp.asarray(x))
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(want_y), rtol=1e-6)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(want_g), rtol=1e-6)
    assert float(xt.grad[-1]) == pytest.approx(float(np.exp(np.float32(15.0))), rel=1e-6)
