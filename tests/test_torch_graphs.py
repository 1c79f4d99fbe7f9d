"""The cached UNet evaluation's CUDA-graph path (``models/unet_graphs.py``)
on the CPU: when it engages, that the CPU runs the network as it is and
counts nothing, and the q/k/v fusion into kept buffers. The graphs
themselves are held to the eager network on the card
(``tests/test_torch_cuda_graphs.py``)."""
import pytest
import torch

from custom_diffusion360_torch.engine import Engine, EngineConfig
from custom_diffusion360_torch.models import nerf, unet_graphs
from custom_diffusion360_torch.models.transformer import fuse_attention_params
from custom_diffusion360_torch.models.unet import (
    UNetConfig,
    _iter_attn,
    _row_blocks,
    init_unet_params,
)
from custom_diffusion360_torch.parallel import tp
from tests.test_torch_common import TINY_UNET
from tests.test_torch_common import torch_threads  # noqa: F401  (fixture)

pytestmark = pytest.mark.usefixtures("torch_threads")

CUDA = torch.device("cuda")  # a device object only: nothing here runs on a card
CACHES = {0: {0: torch.zeros(1)}}


@pytest.mark.parametrize("case", ["cpu", "grad", "render step", "cfg group", "tensor parallel",
                                  "view sharded"])
def test_the_graphs_engage_only_in_the_cached_phase_on_the_card(case):
    group = object()
    with torch.set_grad_enabled(case == "grad"):
        if case != "grad":
            assert unet_graphs.engages(CUDA, CACHES)
        if case == "cpu":
            assert not unet_graphs.engages("cpu", CACHES)
        elif case == "grad":
            assert not unet_graphs.engages(CUDA, CACHES)
        elif case == "render step":
            assert not unet_graphs.engages(CUDA, None)
        elif case == "cfg group":
            assert not unet_graphs.engages(CUDA, CACHES, group=group)
        elif case == "tensor parallel":
            with tp.tensor_parallel(group):
                assert not unet_graphs.engages(CUDA, CACHES)
            assert unet_graphs.engages(CUDA, CACHES)
        else:
            with nerf.view_sharded(group):
                assert not unet_graphs.engages(CUDA, CACHES)
            assert unet_graphs.engages(CUDA, CACHES)


def _tiny_inputs(seed=0):
    gen = torch.Generator().manual_seed(seed)
    cfg = UNetConfig(**TINY_UNET)
    cond = {"crossattn": torch.randn((1, 16, cfg.context_dim), generator=gen),
            "vector": torch.randn((1, cfg.adm_in_channels), generator=gen)}
    return cfg, cond, torch.randn((1, 8, 8, 4), generator=gen)


def test_the_cpu_runs_the_cached_network_as_built_and_counts_nothing():
    cfg, cond, x = _tiny_inputs()
    eng = Engine(EngineConfig(unet=cfg), device="cpu")
    params = {"unet": init_unet_params(cfg, 0, "cpu")}
    fused = eng.graphs.fuse(params["unet"])
    built = []

    def build(caches, kv):
        built.append((caches, kv))
        return eng.network_fn({"unet": fused}, None, nerf_caches=caches, ctx_kv=kv)

    before = dict(unet_graphs.evaluations)
    network = eng.graphs.network(build, fused, {}, None)
    t = torch.tensor([500.0])
    with torch.inference_mode():
        got, aux = network(x, t, cond)
        want, _ = network.eager(x, t, cond)
    assert built == [({}, None)]
    assert torch.equal(got, want) and not aux["rendered"]
    assert dict(unet_graphs.evaluations) == before
    assert eng.graphs._graphs == {}


@pytest.mark.parametrize("lora", [False, True])
def test_fusion_writes_into_the_kept_buffers(lora):
    cfg = UNetConfig(**dict(TINY_UNET, add_lora=lora))
    params = init_unet_params(cfg, 0, "cpu")
    blocks = next(_iter_attn(params, cfg))[0]["blocks"]
    if lora:  # nonzero adapters, so that the merge moves the weights
        gen = torch.Generator().manual_seed(3)
        for blk in blocks:
            for a in ("attn1", "attn2"):
                for leaf in blk[a]["lora"].values():
                    leaf["w"].copy_(torch.randn(leaf["w"].shape, generator=gen) * 0.1)
    buffers = {}
    fuse_attention_params(params, buffers)
    first = fuse_attention_params(params)  # fresh leaves, not the kept buffers
    kept = {k: v.data_ptr() for k, v in buffers.items()}
    assert kept and all(("to_qkv" in k or "to_kv" in k or "to_out" in k) for k in kept)
    assert any("to_out" in k for k in kept) == lora

    blocks[0]["attn1"]["to_k"]["w"].add_(1.0)
    blocks[0]["attn2"]["to_v"]["w"].mul_(2.0)
    again = fuse_attention_params(params, buffers)
    assert {k: v.data_ptr() for k, v in buffers.items()} == kept
    fresh = fuse_attention_params(params)

    def leaves(tree):
        if isinstance(tree, dict):
            return [x for v in tree.values() for x in leaves(v)]
        if isinstance(tree, list):
            return [x for v in tree for x in leaves(v)]
        return [tree]

    moved = 0
    for a, b, c in zip(leaves(again), leaves(fresh), leaves(first)):
        assert torch.equal(a, b)
        moved += not torch.equal(b, c)
    assert moved == 2  # the two fused leaves of the changed block
    fused = next(_iter_attn(again, cfg))[0]["blocks"][0]
    assert fused["attn1"]["to_qkv"]["w"].data_ptr() in kept.values()

    other = init_unet_params(UNetConfig(**dict(TINY_UNET, model_channels=64)), 0, "cpu")
    fuse_attention_params(other, buffers)  # other widths: new buffers in their place
    assert {k: v.data_ptr() for k, v in buffers.items()} != kept


def test_row_blocks_match_index_select():
    t = torch.arange(24.0).reshape(6, 4)
    for blocks in ([0, 1], [0, 0, 1], [1, 0, 2]):
        rows = torch.cat([torch.arange(i * 2, (i + 1) * 2) for i in blocks])
        assert torch.equal(_row_blocks(t, blocks, 2), t.index_select(0, rows))
