"""The port's CUDA kernels against their plain versions, on a CUDA card.

Marked ``cuda``: skipped without a card. The file imports neither JAX nor
the JAX package, so it runs where JAX is not installed:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

Tolerances: attention, bf16 kernel (bf16 P in P.V and bf16 output) vs the
f32 plain version on the same bf16 inputs, 1e-2 of max|ref| (one bf16
rounding of the largest output is at most 2**-8 of it); bilinear, one bf16
rounding of the output, 1e-2 relative to max|ref|.
"""
import pytest
import torch

from custom_diffusion360_torch.ops.block_attention import (
    attention_fwd,
    attention_plain,
    block_attention,
    block_attention_qkv_fused,
)
from custom_diffusion360_torch.ops.grid_sample import grid_sample_2d
from custom_diffusion360_torch.ops.onehot_sample import bilinear_sample

pytestmark = pytest.mark.cuda
ATTN_TOL = 1e-2  # of max|ref|


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.Generator(device="cuda").manual_seed(0)


def _randn(gen, *shape, dtype=torch.bfloat16):
    return torch.randn(shape, generator=gen, device="cuda").to(dtype)


@pytest.mark.parametrize("n,m,d,kv_len", [
    (256, 256, 64, None), (200, 333, 64, None), (130, 256, 64, 77),
    (100, 300, 512, None), (64, 96, 512, 50),
])
def test_attention_kernel_matches_plain(gen, n, m, d, kv_len):
    q, k, v = _randn(gen, 2, 3, n, d), _randn(gen, 2, 3, m, d), _randn(gen, 2, 3, m, d)
    before = attention_fwd.launches
    got = block_attention(q, k, v, d**-0.5, kv_len)
    torch.cuda.synchronize()
    assert attention_fwd.launches == before + 1
    ref = attention_plain(q.float(), k.float(), v.float(), d**-0.5, kv_len)
    assert got.shape == (2, 3, n, d)
    assert float((got.float() - ref).abs().max()) < ATTN_TOL * float(ref.abs().max())


def test_attention_kernel_reads_packed_qkv_in_place(gen):
    b, n, h, d = 2, 320, 4, 64
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
    before = bilinear_sample.launches
    got = bilinear_sample(feats, grid)
    torch.cuda.synchronize()
    assert bilinear_sample.launches == before + 1
    ref = grid_sample_2d(feats.float(), grid)
    tol = 1e-2 * max(1.0, float(ref.abs().max())) if dtype == torch.bfloat16 else 1e-5
    assert float((got.float() - ref).abs().max()) < tol
