"""The roofline work of each counted launch and the model-operation count,
against hand counts at one small shape each."""
from __future__ import annotations

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from harness import models, peaks, work


def test_bound_takes_the_larger_of_bytes_and_operations():
    assert peaks.bound_s(3.35e12, 0.0) == pytest.approx(1.0)
    assert peaks.bound_s(0.0, 989e12) == pytest.approx(1.0)
    assert peaks.bound_s(3.35e12, 67e12, peaks.F32_FLOPS) == pytest.approx(1.0)


def test_attention_work():
    # (b, h, n, m, d) = (1, 2, 128, 256, 64), bf16: QK^T and PV, 2 * 2 * n * m * d a head
    flops = 4 * 1 * 2 * 128 * 256 * 64
    nbytes = 2 * (2 * 1 * 2 * 128 * 64 + 2 * 1 * 2 * 256 * 64)
    want = max(nbytes / 3.35e12, flops / 989e12)
    assert work.attention(1, 2, 128, 256, 64, 256, "bnhd") == pytest.approx(want)
    assert work.attention_bnhd(1, 128, 2, 256, 64, 256) == pytest.approx(want)
    # only the live keys count
    assert work.attention(1, 2, 128, 256, 64, 100) < want


def test_bilinear_work():
    # 4 maps of 16 x 16 x 648 channels (641 needed), 6144 points, f32
    nbytes = 4 * 16 * 16 * 641 * 4 + 4 * 6144 * 2 * 4 + 4 * 6144 * 641 * 4
    flops = 8 * 4 * 6144 * 641
    assert work.bilinear(4, 16, 16, 648, 6144, "f32") == pytest.approx(
        max(nbytes / 3.35e12, flops / 67e12))


def test_norm_and_conv_work():
    numel = 4 * 1024 * 512
    assert work.group_norm(4, 1024, 512, 32, "silu", "bf16") == pytest.approx(
        max((2 * numel * 2 + 2 * 512 * 2) / 3.35e12, 14 * numel / 67e12))
    assert work.layer_norm(2048, 1280, "bf16", "bf16") == pytest.approx(
        max((2 * 2048 * 1280 * 2 + 2 * 1280 * 2) / 3.35e12, 8 * 2048 * 1280 / 67e12))
    flops = 2 * 2 * 64 * 64 * 256 * 9 * 128
    nbytes = 2 * (2 * 64 * 64 * 128 + 9 * 128 * 256 + 2 * 64 * 64 * 256)
    assert work.conv3x3(2, 64, 64, 128, 256) == pytest.approx(
        max(nbytes / 3.35e12, flops / 989e12))


def test_model_operations_of_the_reference_layers():
    models.package(models.REFERENCE)
    from cd360ref.models import nn
    from cd360ref.ops.attention import dot_product_attention

    meta = torch.device("meta")
    with FlopCounterMode(display=False) as fc:
        nn.linear({"w": torch.empty(320, 1280, device=meta)}, torch.empty(2, 77, 320, device=meta))
    assert fc.get_total_flops() == 2 * 2 * 77 * 320 * 1280
    with FlopCounterMode(display=False) as fc:
        nn.conv2d({"w": torch.empty(64, 32, 3, 3, device=meta)},
                  torch.empty(1, 16, 16, 32, device=meta))
    assert fc.get_total_flops() == 2 * 16 * 16 * 64 * 32 * 9
    q = torch.empty(2, 128, 4, 64, device=meta)
    with FlopCounterMode(display=False) as fc:
        dot_product_attention(q, q, q)
    assert fc.get_total_flops() == 4 * 2 * 4 * 128 * 128 * 64
