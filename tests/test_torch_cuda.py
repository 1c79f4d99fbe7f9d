"""The port's CUDA kernels against their plain versions, on a CUDA card.

Marked ``cuda``: skipped without a card. The file imports neither JAX nor
the JAX package, so it runs where JAX is not installed:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

Attention at d = 64 runs ``csrc/attention_sm90.cu`` (wgmma, TMA), at
d = 512 ``csrc/attention512_sm90.cu`` (wgmma, TMA, keys split across blocks
and merged by a second launch when the grid is under one wave).

Tolerances: attention, bf16 kernel (bf16 P in P.V and bf16 output) vs the
f32 plain version on the same bf16 inputs, 1e-2 of max|ref| (one bf16
rounding of the largest output is at most 2**-8 of it); bilinear, one bf16
rounding of the output, 1e-2 relative to max|ref|. LayerNorm and
GroupNorm(+SiLU), with bf16 or f32 scale and bias read as they are: f32
input 1e-5 of max|ref| (f32 statistics in another summation order), bf16
input 1e-2 of max|ref| (one bf16 rounding of the output). Bilinear
backward (``csrc/bilinear_sample_bwd.cu``: shared-memory ownership, no
atomics, the same bits from run to run): f32 sums in another order than the
plain version, 1e-5 of max|ref| in f32, 1e-2 for a bf16 cotangent and
result. conv3x3: bf16
operands, f32 accumulation in another order than the f32 plain version, one
bf16 rounding of the output (bias added before it): 1e-2 of max|ref|. The
conv runs ``csrc/conv3x3.cu`` (wgmma, TMA), GroupNorm ``csrc/group_norm.cu``
in two launches. The training CLI's pieces: a train step with
accumulation, clipping and a schedule, bf16 through the kernels vs f32 on
the CPU, within 5e-2 of the largest parameter change; the EMA shadow and
``collate``'s copy to the card exactly.
"""
import pytest
import torch

from custom_diffusion360_torch.ops.block_attention import (
    attention_bnhd_fwd,
    attention_fwd,
    attention_plain,
    block_attention,
    block_attention_bnhd,
    block_attention_qkv_fused,
    split_count,
    splits_launched,
)
from custom_diffusion360_torch.ops.conv3x3 import (
    conv3x3_fwd,
    conv3x3_gemm,
    conv3x3_plain,
    conv3x3_supported,
    relaid_weight,
)
from custom_diffusion360_torch.ops.grid_sample import grid_sample_2d
from custom_diffusion360_torch.ops.norms import (
    _gn_plain,
    _ln_plain,
    group_norm_fused,
    layer_norm_fused,
)
from custom_diffusion360_torch.ops.onehot_sample import (
    bilinear_sample,
    bilinear_sample_bwd,
    bilinear_sample_bwd_plain,
    bwd_plans_launched,
)

pytestmark = pytest.mark.cuda
ATTN_TOL = 1e-2  # of max|ref|


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.Generator(device="cuda").manual_seed(0)


def _randn(gen, *shape, dtype=torch.bfloat16):
    return torch.randn(shape, generator=gen, device="cuda").to(dtype)


def launched(wrapper):
    """The launches an op wrapper has counted, over all its shapes."""
    return sum(wrapper.launches_by_shape.values())


# d = 64 (csrc/attention_sm90.cu): every (n, m) of these lengths, with all
# keys and with a kv_len that ends inside a 128-key tile; ragged q tiles
# (200), m below one tile (64), and the UNet's 1024 / 4096
_SM90_LENGTHS = (64, 200, 256, 1024, 4096)
_ATTN_CASES = [
    (2, 3, 256, 256, 64, None), (2, 3, 200, 333, 64, None), (2, 3, 130, 256, 64, 77),
    (2, 3, 100, 300, 512, None), (2, 3, 64, 96, 512, 50),
    # d = 512 at the training encoder's shapes: b = 1 splits the keys in two
    # (128 blocks), b = 4 does not; kv_len 1500 leaves the second split
    # (keys 2048-4095) without a live key
    (1, 1, 4096, 4096, 512, None), (4, 1, 4096, 4096, 512, None),
    (1, 1, 4096, 4096, 512, 1500), (1, 1, 1000, 2000, 512, 1999),
    (3, 20, 1024, 1024, 64, None), (3, 20, 1024, 1024, 64, 777),  # b * h = 60
] + [(2, 3, n, m, 64, kv) for n in _SM90_LENGTHS for m in _SM90_LENGTHS
     for kv in (None, max(1, 3 * m // 4 - 5))]


@pytest.mark.parametrize("b,h,n,m,d,kv_len", _ATTN_CASES)
def test_attention_kernel_matches_plain(gen, b, h, n, m, d, kv_len):
    q, k, v = _randn(gen, b, h, n, d), _randn(gen, b, h, m, d), _randn(gen, b, h, m, d)
    before = launched(attention_fwd)
    got = block_attention(q, k, v, d**-0.5, kv_len)
    torch.cuda.synchronize()
    assert launched(attention_fwd) == before + 1
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    assert splits_launched[(b, h, n, m, d)] == (split_count(b * h, n, m, sms) if d == 512 else 1)
    ref = attention_plain(q.float(), k.float(), v.float(), d**-0.5, kv_len)
    assert got.shape == (b, h, n, d)
    assert float((got.float() - ref).abs().max()) < ATTN_TOL * float(ref.abs().max())


@pytest.mark.parametrize("b,n,h", [(2, 320, 4), (3, 1024, 20), (2, 4096, 10)])
def test_attention_kernel_reads_packed_qkv_in_place(gen, b, n, h):
    d = 64
    qkv = _randn(gen, b, n, 3 * h * d)
    q5 = qkv.view(b, n, 3, h, d).permute(0, 2, 3, 1, 4)
    got = block_attention_qkv_fused(q5, d**-0.5)
    ref = attention_plain(*(q5[:, i].float() for i in range(3)), d**-0.5)
    assert float((got.float() - ref).abs().max()) < ATTN_TOL * float(ref.abs().max())


def test_attention_kernel_raises_on_what_it_cannot_take(gen):
    q = _randn(gen, 1, 2, 64, 32)
    with pytest.raises(ValueError, match="built for d"):
        block_attention(q, q, q, 0.2)
    with pytest.raises(TypeError, match="bfloat16"):
        q64 = _randn(gen, 1, 2, 64, 64, dtype=torch.float32)
        block_attention(q64, q64, q64, 0.1)


@pytest.mark.parametrize("c,dtype", [(648, torch.bfloat16), (641, torch.bfloat16),
                                     (7, torch.float32), (64, torch.float32)])
def test_bilinear_kernel_matches_plain(gen, c, dtype):
    feats = _randn(gen, 4, 16, 16, c, dtype=dtype)
    grid = torch.rand((4, 1000, 2), generator=gen, device="cuda") * 2.4 - 1.2
    grid[:, :4] = torch.tensor([[1.0, 1.0], [-1.0, -1.0], [1.2, 0.0], [1.0, -1.0]],
                               device="cuda")
    before = launched(bilinear_sample)
    got = bilinear_sample(feats, grid)
    torch.cuda.synchronize()
    assert launched(bilinear_sample) == before + 1
    ref = grid_sample_2d(feats.float(), grid)
    tol = 1e-2 * max(1.0, float(ref.abs().max())) if dtype == torch.bfloat16 else 1e-5
    assert float((got.float() - ref).abs().max()) < tol


def _norm_tol(dtype):
    return 1e-5 if dtype == torch.float32 else 1e-2


@pytest.mark.parametrize("param_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows,c", [(1000, 640), (77, 1280), (5, 8), (3000, 768), (10, 5120),
                                    (333, 40), (13, 640), (3001, 1280), (77, 2048)])
def test_layer_norm_kernel_matches_plain(gen, rows, c, dtype, param_dtype):
    """Rows in registers up to C = 2048, the three-pass loop above; row
    counts that are not multiples of the block's 8 rows."""
    x = (_randn(gen, rows, c, dtype=torch.float32) * 3 + 1).to(dtype)
    s = (_randn(gen, c, dtype=torch.float32) * 0.1 + 1).to(param_dtype)
    b = _randn(gen, c, dtype=param_dtype)
    before = launched(layer_norm_fused)
    got = layer_norm_fused(x, s, b)
    torch.cuda.synchronize()
    assert launched(layer_norm_fused) == before + 1 and got.dtype == dtype
    ref = _ln_plain(x.float(), s, b, 1e-5)
    assert float((got.float() - ref).abs().max()) < _norm_tol(dtype) * float(ref.abs().max())


def test_layer_norm_kernel_skips_autograd_without_grad(gen):
    x = _randn(gen, 64, 640)
    s, b = _randn(gen, 640), _randn(gen, 640)
    want = layer_norm_fused(x, s, b)
    with torch.inference_mode():
        got = layer_norm_fused(x, s, b)
    torch.cuda.synchronize()
    assert got.grad_fn is None and torch.equal(got, want)
    with pytest.raises(TypeError, match="both bf16 or both f32"):
        layer_norm_fused(x, s, b.float())


@pytest.mark.parametrize("param_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("act", [None, "silu"])
@pytest.mark.parametrize("n,hw,c,groups", [
    (2, 4096, 320, 32), (1, 64 * 64, 1920, 32), (3, 7 * 5, 64, 32), (1, 512 * 512, 128, 32),
    (4, 100, 48, 8), (3, 1024, 1280, 32), (1, 3, 2560, 32), (2, 1000, 96, 3),
    (1, 4096, 512, 256),
])
def test_group_norm_kernel_matches_plain(gen, n, hw, c, groups, act, dtype, param_dtype):
    """bf16 and f32 scale and bias read as they are; one counted launch a
    call; row counts that leave a short last chunk, fewer rows than one
    pass, groups that straddle the 16-byte vectors, 256 groups (16 chunks:
    the partials' cap)."""
    # a large offset: the shifted statistics must not lose the variance
    x = (_randn(gen, n, hw, c, dtype=torch.float32) * 0.5 + 20.0).to(dtype)
    s = (_randn(gen, c, dtype=torch.float32) * 0.1 + 1).to(param_dtype)
    b = _randn(gen, c, dtype=param_dtype)
    before = launched(group_norm_fused)
    got = group_norm_fused(x, s, b, groups, 1e-6, act)
    torch.cuda.synchronize()
    assert launched(group_norm_fused) == before + 1 and got.dtype == dtype
    ref = _gn_plain(x.float(), s, b, groups, 1e-6, act)
    assert float((got.float() - ref).abs().max()) < _norm_tol(dtype) * float(ref.abs().max())


def test_group_norm_kernel_makes_two_launches_and_no_copies(gen):
    """A call on the card allocates the output and one scratch tensor and
    launches two kernels: no f32 copies of the bf16 scale and bias."""
    x = _randn(gen, 2, 1024, 1280)
    s, b = _randn(gen, 1280), _randn(gen, 1280)
    with torch.inference_mode():
        group_norm_fused(x, s, b, 32, 1e-6, "silu")  # loaded, warmed up
        torch.cuda.synchronize()
        allocs = torch.cuda.memory_stats()["allocation.all.allocated"]
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            y = group_norm_fused(x, s, b, 32, 1e-6, "silu")
            torch.cuda.synchronize()
        assert torch.cuda.memory_stats()["allocation.all.allocated"] - allocs == 2
    assert y.grad_fn is None
    kernels = [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    assert len(kernels) == 2, kernels
    assert any("gn_stats_kernel" in k for k in kernels), kernels
    assert any("gn_apply_kernel" in k for k in kernels), kernels


def test_norm_kernels_take_bf16_scale_and_bias(gen):
    """The models on the card pass bf16 scale and bias: both kernels read
    them as they are, and a wrong pair is refused before any launch."""
    x = _randn(gen, 4, 256, 640)
    s = (_randn(gen, 640, dtype=torch.float32) * 0.1 + 1).to(torch.bfloat16)
    b = _randn(gen, 640)
    for got, ref in ((layer_norm_fused(x, s, b), _ln_plain(x.float(), s, b, 1e-5)),
                     (group_norm_fused(x, s, b, 32, 1e-6, "silu"),
                      _gn_plain(x.float(), s, b, 32, 1e-6, "silu"))):
        torch.cuda.synchronize()
        assert float((got.float() - ref).abs().max()) < 1e-2 * float(ref.abs().max())
    with pytest.raises(TypeError, match="both bf16 or both f32"):
        group_norm_fused(x, s, b.float(), 32)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m,side,c,p", [(4, 32, 648, 12288), (4, 16, 1288, 6144), (2, 8, 7, 500)])
def test_bilinear_backward_kernel_matches_plain(gen, m, side, c, p, dtype):
    g = _randn(gen, m, p, c, dtype=dtype)
    grid = torch.rand((m, p, 2), generator=gen, device="cuda") * 2.4 - 1.2
    grid[:, :4] = torch.tensor([[1.0, 1.0], [-1.0, -1.0], [1.2, 0.0], [1.0, -1.0]],
                               device="cuda")
    before = launched(bilinear_sample_bwd)
    got = bilinear_sample_bwd(g, grid, (m, side, side, c), dtype)
    torch.cuda.synchronize()
    assert launched(bilinear_sample_bwd) == before + 1 and got.dtype == dtype
    ref = bilinear_sample_bwd_plain(g.float(), grid, (m, side, side, c), torch.float32)
    tol = 1e-5 if dtype == torch.float32 else 1e-2
    assert float((got.float() - ref).abs().max()) < tol * float(ref.abs().max())


def _bwd_check(g, grid, shape, dtype):
    """One launch of the backward kernel against the f32 plain version."""
    before = launched(bilinear_sample_bwd)
    got = bilinear_sample_bwd(g, grid, shape, dtype)
    torch.cuda.synchronize()
    assert launched(bilinear_sample_bwd) == before + 1 and got.dtype == dtype
    ref = bilinear_sample_bwd_plain(g.float(), grid, shape, torch.float32)
    tol = 1e-5 if dtype == torch.float32 else 1e-2
    assert float((got.float() - ref).abs().max()) <= tol * float(ref.abs().max())
    return got


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m,side,c,p", [(4, 16, 1288, 6144), (4, 32, 648, 12288), (1, 8, 7, 500)])
def test_bilinear_backward_clustered(gen, m, side, c, p, dtype):
    """Every point of map 0 within 3 x 3 pixels: nine consumer warps of each
    block take all of them, each keeping its pixel's running sum in a
    register; the other maps get nothing."""
    g = _randn(gen, m, p, c, dtype=dtype)
    grid = torch.full((m, p, 2), 5.0, device="cuda")
    grid[0] = (torch.rand((p, 2), generator=gen, device="cuda") * 2 + side // 2 - 1) / (
        side - 1) * 2 - 1
    _bwd_check(g, grid, (m, side, side, c), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m,c,p", [(4, 648, 12288), (1, 40, 3000)])
def test_bilinear_backward_64x64_bands(gen, m, c, p, dtype):
    """A 64^2 map is 4 bands of 1024 pixels, each walking every point."""
    g = _randn(gen, m, p, c, dtype=dtype)
    grid = torch.rand((m, p, 2), generator=gen, device="cuda") * 2.4 - 1.2
    _bwd_check(g, grid, (m, 64, 64, c), dtype)
    assert bwd_plans_launched[(m, 64, 64, c, p, "f32" if dtype == torch.float32 else "bf16")][
        0] == 1024


@pytest.mark.parametrize("c", [648, 7])
def test_bilinear_backward_all_outside_is_zero(gen, c):
    g = _randn(gen, 4, 2000, c, dtype=torch.float32)
    # |x|, |y| >= 1.2: both corners of both axes lie outside the 16^2 map
    grid = torch.rand((4, 2000, 2), generator=gen, device="cuda") * 2 + 1.2
    grid[:, ::2] *= -1
    got = bilinear_sample_bwd(g, grid, (4, 16, 16, c), torch.float32)
    torch.cuda.synchronize()
    assert float(got.abs().max()) == 0.0


@pytest.mark.parametrize("m,side,c,p", [(4, 16, 1288, 6144), (4, 32, 648, 12288), (2, 8, 7, 500)])
def test_bilinear_backward_is_bitwise_reproducible(gen, m, side, c, p):
    """Two launches on the same inputs agree bit for bit (split or not)."""
    g = _randn(gen, m, p, c, dtype=torch.float32)
    grid = torch.rand((m, p, 2), generator=gen, device="cuda") * 2.4 - 1.2
    grid[:, : p // 2] = grid[:, : p // 2] * 0.05  # collisions on the middle pixels
    a = bilinear_sample_bwd(g, grid, (m, side, side, c), torch.float32)
    b = bilinear_sample_bwd(g, grid, (m, side, side, c), torch.float32)
    torch.cuda.synchronize()
    assert torch.equal(a.view(torch.int32), b.view(torch.int32))


@pytest.mark.parametrize("g_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("m,side,c,p", [(4, 16, 1288, 6144), (1, 64, 64, 100)])
def test_bilinear_backward_writes_bf16_itself(gen, m, side, c, p, g_dtype):
    """A bf16 result comes from the kernel's own flush (and the merge when
    the points split): the wrapper launches nothing else, no zero fill and
    no cast."""
    from torch.profiler import ProfilerActivity, profile

    g = _randn(gen, m, p, c, dtype=g_dtype)
    grid = torch.rand((m, p, 2), generator=gen, device="cuda") * 2.4 - 1.2
    _bwd_check(g, grid, (m, side, side, c), torch.bfloat16)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        bilinear_sample_bwd(g, grid, (m, side, side, c), torch.bfloat16)
        torch.cuda.synchronize()
    names = [e.key for e in prof.key_averages() if e.device_type.name == "CUDA"]
    splits = bwd_plans_launched[(m, side, side, c, p, "f32" if g_dtype == torch.float32
                                 else "bf16")][1]
    assert len(names) == (2 if splits > 1 else 1), names
    assert any("bilinear_bwd_kernel" in n for n in names)
    assert splits == 1 or any("bilinear_bwd_merge_kernel" in n for n in names)


def test_gradients_reach_inputs_through_the_kernels(gen):
    """A loss through each kernel wrapper on the card gives every input a
    nonzero gradient, and the backward kernel of the bilinear sampling runs."""
    q = _randn(gen, 1, 2, 256, 64).requires_grad_(True)
    qkv = _randn(gen, 1, 3, 2, 256, 64).requires_grad_(True)
    feats = _randn(gen, 2, 8, 8, 16, dtype=torch.float32).requires_grad_(True)
    grid = (torch.rand((2, 100, 2), generator=gen, device="cuda") * 2 - 1).requires_grad_(True)
    x = _randn(gen, 2, 64, 64).requires_grad_(True)
    s = torch.ones(64, device="cuda", requires_grad=True)
    b = torch.zeros(64, device="cuda", requires_grad=True)
    before = launched(bilinear_sample_bwd)
    loss = (block_attention(q, q * 0.5, q * 2.0, 0.125).float().square().sum()
            + block_attention_qkv_fused(qkv, 0.125).float().square().sum()
            + bilinear_sample(feats, grid).square().sum()
            + layer_norm_fused(x, s, b).float().pow(3).sum()
            + group_norm_fused(x, s, b, 32, 1e-6, "silu").float().pow(3).sum())
    loss.backward()
    torch.cuda.synchronize()
    assert launched(bilinear_sample_bwd) == before + 1
    for leaf in (q, qkv, feats, x, s, b):
        assert leaf.grad is not None and float(leaf.grad.float().abs().max()) > 0
    assert float(grid.grad.abs().max()) == 0.0


@pytest.mark.parametrize("n,m,h,kv_len", [(256, 256, 3, None), (200, 333, 2, 150),
                                          (1024, 1024, 1, None), (1024, 1024, 20, None),
                                          (4096, 4096, 10, None), (64, 200, 5, 130)])
def test_bnhd_kernel_matches_plain(gen, n, m, h, kv_len):
    d = 512 if h == 1 else 64
    q, k, v = _randn(gen, 2, n, h, d), _randn(gen, 2, m, h, d), _randn(gen, 2, m, h, d)
    before, before_attn = launched(attention_bnhd_fwd), launched(attention_fwd)
    got = block_attention_bnhd(q, k, v, d**-0.5, kv_len)
    torch.cuda.synchronize()
    assert launched(attention_bnhd_fwd) == before + 1 and launched(attention_fwd) == before_attn
    assert got.shape == (2, n, h, d) and got.is_contiguous()
    ref = attention_plain(q.float().transpose(1, 2), k.float().transpose(1, 2),
                          v.float().transpose(1, 2), d**-0.5, kv_len).transpose(1, 2)
    assert float((got.float() - ref).abs().max()) <= ATTN_TOL * float(ref.abs().max())


@pytest.mark.parametrize("b,h,n,kv_len", [(2, 2, 1024, None), (1, 3, 700, 500), (1, 1, 4096, 1500)])
def test_attention512_reads_bnhd_views(gen, b, h, n, kv_len):
    """d = 512 on (b, n, h, d) storage: the TMA maps step heads 1024 bytes
    apart inside a token row; the split path (ceil(n / 64) * b * h < SMs)
    and a split with no live key included, no NaN."""
    d = 512
    q, k, v = (_randn(gen, b, n, h, d) for _ in range(3))
    got = block_attention_bnhd(q, k, v, d**-0.5, kv_len)
    torch.cuda.synchronize()
    ref = attention_plain(q.float().transpose(1, 2), k.float().transpose(1, 2),
                          v.float().transpose(1, 2), d**-0.5, kv_len).transpose(1, 2)
    assert bool(torch.isfinite(got).all())
    assert float((got.float() - ref).abs().max()) <= ATTN_TOL * float(ref.abs().max())


CONV_TOL = 1e-2  # of max|ref|


@pytest.mark.parametrize("b,h,w,c,n,bias", [
    (1, 32, 32, 128, 128, False), (2, 64, 32, 512, 256, True), (1, 32, 64, 256, 128, True),
    (1, 64, 64, 128, 384, True),
    (1, 128, 128, 512, 512, True),    # the decoder's bottleneck convs
    (1, 1024, 1024, 128, 128, True),  # its last level
    (3, 32, 32, 256, 256, True),      # every tile on a border, three images
])
def test_conv3x3_kernel_matches_plain(gen, b, h, w, c, n, bias):
    """Tiles of 16 x 8 pixels whose taps reach past every border (TMA's zero
    fill), 128- and 256-channel output tiles, several images a launch."""
    x = _randn(gen, b, h, w, c)
    wt = (_randn(gen, n, c, 3, 3, dtype=torch.float32) * (9 * c) ** -0.5).to(torch.bfloat16)
    bb = _randn(gen, n) if bias else None
    before = launched(conv3x3_fwd)
    got = conv3x3_gemm(x, wt, bb)
    torch.cuda.synchronize()
    assert launched(conv3x3_fwd) == before + 1 and got.shape == (b, h, w, n)
    ref = conv3x3_plain(x.float(), wt.float())
    if bias:
        ref = ref + bb.float()
    err = (got.float() - ref).abs()
    assert float(err.max()) <= CONV_TOL * float(ref.abs().max())
    # the border rows and columns (zero padding in the kernel's halo)
    for edge in (err[:, 0], err[:, -1], err[:, :, 0], err[:, :, -1]):
        assert float(edge.max()) <= CONV_TOL * float(ref.abs().max())
    # and per image (a tile's halo must not reach into the next image)
    for i in range(b):
        assert float(err[i].max()) <= CONV_TOL * float(ref[i].abs().max())


def test_conv3x3_weight_relayout_is_reused_across_calls(gen):
    x = _randn(gen, 1, 32, 32, 128)
    wt = _randn(gen, 128, 128, 3, 3) * 0.03
    first = relaid_weight(wt, torch.bfloat16)
    a = conv3x3_gemm(x, wt)
    assert relaid_weight(wt, torch.bfloat16) is first
    b = conv3x3_gemm(x, wt)
    torch.cuda.synchronize()
    assert torch.equal(a, b)


def test_conv3x3_gate_refuses_f32_on_the_card(gen):
    x = torch.zeros((1, 32, 32, 128), device="cuda")
    wt = torch.zeros((128, 128, 3, 3), device="cuda")
    assert not conv3x3_supported(x, wt)
    assert conv3x3_supported(x.to(torch.bfloat16), wt)
    assert conv3x3_supported(x.cpu(), wt.cpu())  # the plain version takes f32
    with pytest.raises(ValueError, match="conv3x3 kernel does not take"):
        conv3x3_gemm(x, wt)


# ---------------------------------------------------------------------------
# the training CLI's pieces on the card
# ---------------------------------------------------------------------------


def _smoke_training(device, dtype, calls, train_cfg):
    """``calls`` train steps of the sampling CLI's SMOKE_CFG on the training
    CLI's synthetic --smoke batches (64^2, 1 + 2 views), weights made on the
    CPU in f32 from one seed -> (trainable leaves before, after each call)."""
    import dataclasses

    from custom_diffusion360_torch.cli import sample as cli_sample
    from custom_diffusion360_torch.cli import train as cli_train
    from custom_diffusion360_torch.draws import Draws
    from custom_diffusion360_torch.engine import Engine
    from custom_diffusion360_torch.train.trainer import Trainer, tree_map

    cfg = dataclasses.replace(cli_sample.SMOKE_CFG, compute_dtype=str(dtype)[6:])
    params = Engine(cfg, device="cpu").init_params(seed=1, dtype=torch.float32)
    params = tree_map(lambda x: x.to(device, dtype) if x.is_floating_point() else x.to(device),
                      params)
    args = cli_train.build_parser().parse_args(
        ["--max_steps", str(calls), "--img_size", "64", "--num_images", "3"])
    tok, _ = cli_sample.make_tokenizers(None, context_length=16)
    batches = cli_train._synthetic_batches(args, cfg, tok, tok, torch.device(device))
    trainer = Trainer(Engine(cfg, device=device), train_cfg)
    state = trainer.init_state(params)
    history = [[leaf.detach().float().cpu().clone() for leaf in trainer.trainable(state)]]
    for i, batch in enumerate(batches):
        state, metrics = trainer.train_step(state, batch, Draws(
            cli_train.step_generator(0, i, "cpu"), given=None))
        assert all(bool(torch.isfinite(v)) for v in metrics.values())
        history.append([leaf.detach().float().cpu().clone() for leaf in trainer.trainable(state)])
    return history


def test_train_step_with_accumulation_clipping_and_schedule(gen):
    """Two calls with accumulate_grad_batches=2, a gradient-norm limit and a
    warm-up schedule: bf16 through the kernels on the card vs f32 plain on
    the CPU. The first call moves nothing; after the update the change of
    the trainable leaves agrees within 5e-2 of its largest entry (eps = 1
    keeps AdamW's update smooth in the gradient)."""
    from custom_diffusion360_torch.train.lr_schedule import lambda_warmup_cosine
    from custom_diffusion360_torch.train.trainer import TrainConfig

    cfg = TrainConfig(lr=0.1, eps=1.0, accumulate_grad_batches=2, max_grad_norm=0.05,
                      lr_schedule=lambda_warmup_cosine(1, 0.1, 1.0, 0.5, 10))
    ref = _smoke_training("cpu", torch.float32, 2, cfg)
    got = _smoke_training("cuda", torch.bfloat16, 2, cfg)
    for h in (ref, got):
        assert all(torch.equal(a, b) for a, b in zip(h[0], h[1]))
    moved_ref = torch.cat([(a - b).ravel() for a, b in zip(ref[2], ref[0])])
    moved_got = torch.cat([(a - b).ravel() for a, b in zip(got[2], got[0])])
    scale = float(moved_ref.abs().max())
    assert scale > 0
    assert float((moved_got - moved_ref).abs().max()) <= 5e-2 * scale


def test_ema_shadow_does_not_alias_the_leaves_on_the_card(gen):
    from custom_diffusion360_torch.train.ema import ema_init, ema_update

    w = torch.randn((64, 32), generator=gen, device="cuda").requires_grad_(True)
    params = {"w": w, "frozen": torch.zeros(4, device="cuda")}
    ema = ema_init(params, {"w": True, "frozen": False})
    before = ema.shadow["w"].clone()
    opt = torch.optim.AdamW([w], lr=0.1)
    w.grad = torch.ones_like(w)
    opt.step()  # in place
    assert torch.equal(ema.shadow["w"], before) and not torch.equal(w.detach(), before)
    ema = ema_update(ema, params, 0.5)
    d = min(0.5, 2.0 / 11.0)
    torch.testing.assert_close(ema.shadow["w"], before - (1 - d) * (before - w.detach()))


def test_collate_puts_the_batch_on_the_card(gen):
    import numpy as np

    from custom_diffusion360_torch.data.co3d import collate
    from custom_diffusion360_torch.geometry.cameras import Cameras

    rng = np.random.default_rng(0)

    def item():
        return {
            "image": rng.normal(size=(64, 64, 3)).astype(np.float32),
            "image_ref": rng.normal(size=(2, 64, 64, 3)).astype(np.float32),
            "mask": np.ones((8, 8, 1), np.float32), "mask_ref": np.ones((2, 8, 8, 1), np.float32),
            "opacity": np.ones((8, 8, 1), np.float32), "drop_im": np.float32(1.0),
            "cams": Cameras.create(np.tile(np.eye(3, dtype=np.float32), (3, 1, 1)),
                                   rng.normal(size=(3, 3)), 2.0, 0.0, xp=np),
            "original_size": np.array([64.0, 64.0], np.float32),
            "target_size": np.array([64.0, 64.0], np.float32),
            "crop_coords": np.zeros(2, np.float32),
            "original_size_ref": np.full((2, 2), 64.0, np.float32),
            "target_size_ref": np.full((2, 2), 64.0, np.float32),
            "crop_coords_ref": np.zeros((2, 2), np.float32),
            "txt": "photo of a <new1> car", "txt_ref": ["photo of a <new1> car"] * 2,
        }

    items = [item(), item()]
    on_cpu = collate(items)
    on_card = collate(items, device="cuda")
    torch.cuda.synchronize()
    for k, v in on_cpu.items():
        if k in ("txt", "txt_ref"):
            assert on_card[k] == v
        elif k == "cams":
            for a, b in zip(on_card[k], v):
                assert a.is_cuda and torch.equal(a.cpu(), b)
        else:
            assert on_card[k].is_cuda and torch.equal(on_card[k].cpu(), v), k


# ---------------------------------------------------------------------------
# the autoencoder trainer on the card
# ---------------------------------------------------------------------------


def test_ae_train_step_in_bf16_launches_the_kernels(gen, monkeypatch):
    """One AEEngine.train_step on bf16 64^2 images with LPIPS on, the VAE at
    ch 128, mult (1, 4) under CD360_VAE_CONV=pallas: every log value is
    finite, both sides move, and the step launched the GroupNorm kernel,
    the d = 512 attention kernel (the 32^2 bottleneck) and the conv3x3
    kernel."""
    from custom_diffusion360_torch.draws import Draws
    from custom_diffusion360_torch.models.vae import VAEConfig
    from custom_diffusion360_torch.train.ae_engine import AEEngine, AEEngineConfig, init_ae_engine
    from custom_diffusion360_torch.train.trainer import tree_leaves

    monkeypatch.setenv("CD360_VAE_CONV", "pallas")
    cfg = AEEngineConfig(vae=VAEConfig(ch=128, ch_mult=(1, 4), num_res_blocks=1), disc_ndf=8,
                         lr=1e-3)
    eng = AEEngine(cfg)
    state = eng.init_state(init_ae_engine(cfg, seed=0))
    before = {side: [leaf.detach().clone() for leaf in tree_leaves(state.params[side])]
              for side in ("ae", "disc")}
    counters = (group_norm_fused, attention_fwd, conv3x3_fwd)
    launches = [launched(c) for c in counters]
    x = (torch.rand((2, 64, 64, 3), generator=gen, device="cuda") * 2 - 1).to(torch.bfloat16)
    state, logs = eng.train_step(state, x, Draws(torch.Generator(device="cuda").manual_seed(1)))
    torch.cuda.synchronize()
    assert all(bool(torch.isfinite(v)) for v in logs.values()), logs
    for side, old in before.items():
        moved = sum(float((leaf.detach() - o).abs().sum())
                    for leaf, o in zip(tree_leaves(state.params[side]), old))
        assert moved > 0, side
    assert all(launched(c) > n for c, n in zip(counters, launches))
    assert any(shape[4] == 512 for shape in attention_fwd.launches_by_shape)


# ---------------------------------------------------------------------------
# the auxiliary models (T5, embedders, general conditioner, EncoderUNet,
# extra blocks) on the card
# ---------------------------------------------------------------------------


def test_t5_position_bias_on_the_card_equals_the_cpu(gen):
    """The bucket table is built on the host and copied: the card's bias is
    the CPU's bit for bit."""
    from custom_diffusion360_torch.models.t5 import T5Config, position_bias

    cfg = T5Config(num_heads=4)
    rel_bias = torch.randn((32, 4), generator=torch.Generator().manual_seed(0))
    for seq_len in (77, 512, 1024):
        host = position_bias({"rel_bias": rel_bias}, seq_len, cfg, "cpu")
        card = position_bias({"rel_bias": rel_bias.cuda()}, seq_len, cfg, "cuda")
        assert card.is_cuda and torch.equal(card.cpu(), host)


def _ddpm_up_norm_shapes(ch, ch_mult, num_res_blocks, resolution):
    """(HW, C) of every GroupNorm of the DDPM model's up path: the ResBlock
    norms on [h | skip] and on their output."""
    in_mult = (1,) + tuple(ch_mult)
    block_in = ch * ch_mult[-1]
    res = resolution // 2 ** (len(ch_mult) - 1)
    shapes = set()
    for i in reversed(range(len(ch_mult))):
        block_out = skip_in = ch * ch_mult[i]
        for j in range(num_res_blocks + 1):
            if j == num_res_blocks:
                skip_in = ch * in_mult[i]
            shapes |= {(res * res, block_in + skip_in), (res * res, block_out)}
            block_in = block_out
        if i:
            res *= 2
    return sorted(shapes)


def test_group_norm_at_the_ddpm_up_path_shapes(gen):
    """The LSUN-256 DDPM model's up-path norms (up to 1024 concatenated
    channels) and the EncoderUNet spatial_v2 head's 2048-channel norm, bf16
    with SiLU and f32 without, against the plain version."""
    shapes = _ddpm_up_norm_shapes(128, (1, 1, 2, 2, 4, 4), 2, 256)
    assert max(c for _, c in shapes) == 1024
    cases = [(2, hw, c, "silu", torch.bfloat16) for hw, c in shapes]
    cases += [(8, 1, 2048, None, torch.bfloat16), (8, 1, 2048, None, torch.float32)]
    for n, hw, c, act, dtype in cases:
        x = (torch.randn((n, hw, c), generator=gen, device="cuda") * 0.5 + 2.0).to(dtype)
        scale = (torch.randn((c,), generator=gen, device="cuda") * 0.1 + 1.0).to(dtype)
        bias = torch.randn((c,), generator=gen, device="cuda").to(dtype)
        got = group_norm_fused(x, scale, bias, 32, 1e-5, act)
        ref = _gn_plain(x.float(), scale, bias, 32, 1e-5, act)
        tol = (1e-2 if dtype == torch.bfloat16 else 1e-5) * float(ref.abs().max())
        assert float((got.float() - ref).abs().max()) <= tol, (n, hw, c, act, dtype)


def test_auxiliary_models_on_the_card_match_the_cpu(gen):
    """chip_smoke's [small-aux] check: the five modules at the CPU tests'
    tiny sizes, bf16 through the kernels on the card against f32 on the CPU,
    within 5e-2 of max(1, max|ref|), the GroupNorm, LayerNorm and attention
    kernels launched, and the T5 bias on the card equal to the CPU's."""
    import chip_smoke

    chip_smoke.run_small_aux_check(torch)
