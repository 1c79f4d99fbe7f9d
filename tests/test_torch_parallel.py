"""The port's parallel/ package (torch.distributed) on the CPU: the rank
helpers and batch and draw splits in one process, the tensor-parallel
routing against the JAX package's, and, on two gloo ranks spawned as
processes (tests/torch_parallel_worker.py, each with its own timeout),
tensor-parallel sampling held to the golden ``sample3_latent_tp`` and the
tensor-parallel training loss held to the replicated one.

Tolerances: the routing equal, leaf by leaf; the TP sample within 1e-5 of
the golden's max|ref| (as the golden ``sample3_latent``,
tests/test_torch_goldens.py); the TP loss terms within JAX
tests/test_tp.py's rtol 1e-3 / atol 2e-4, and each trainable gradient
within 1e-3 of its max|ref|, floored at 1e-3 of the largest leaf gradient
(the all-reduced products change the order of the float32 sums only).
"""
import jax
import numpy as np
import pytest
import torch

from custom_diffusion360_tpu.engine import Engine as JEngine
from custom_diffusion360_tpu.parallel import tp_param_specs as j_specs
from custom_diffusion360_torch.draws import Draws
from custom_diffusion360_torch.engine import Engine
from custom_diffusion360_torch.parallel import (
    is_main_process,
    rank,
    shard_batch,
    shard_params_tp,
    tp_param_specs,
    world_size,
)
from custom_diffusion360_torch.parallel.tp import is_split, tensor_parallel
from custom_diffusion360_torch.train.trainer import Trainer
from tests.test_torch_common import max_err, random_params, t, to_torch
from tests.test_torch_common import torch_threads  # noqa: F401  (fixture)
from tests.test_torch_goldens import REPO, sample3_inputs, tiny_engine_params
from tests.test_torch_train import _batch, _cfgs, replay_draws
from tests.torch_parallel_worker import run_ranks

pytestmark = pytest.mark.usefixtures("torch_threads")


def test_rank_helpers_without_a_process_group():
    assert (rank(), world_size(), is_main_process()) == (0, 1, True)
    x = torch.arange(6.0).reshape(3, 2)
    batch = {"a": x, "s": torch.tensor(2.0), "none": None}
    out = shard_batch(batch)
    assert out["a"] is not None and torch.equal(out["a"], x) and out["s"] == 2.0
    assert out["none"] is None


def test_sharded_draws_are_the_global_draws_rows():
    """A rank's row draws are its rows of the global batch's draws from the
    same generator, and the shared draws (the coin) are the same on every
    rank."""
    def draws(shard):
        d = Draws(torch.Generator().manual_seed(7), shard=shard)
        return (d.normal("noise", (1, 2, 3), "cpu"), d.uniform("coin", (), "cpu"),
                d.child("nerf").uniform("strat", (1, 4, 5), "cpu"),
                d.normal("vae_eps_ref", (2, 3), "cpu"))

    g = torch.Generator().manual_seed(7)
    want_noise = torch.randn((3, 2, 3), generator=g)
    want_coin = torch.rand((), generator=g)
    want_strat = torch.rand((3, 4, 5), generator=g)
    want_eps = torch.randn((6, 3), generator=g)
    for r in range(3):
        noise, coin, strat, eps = draws((r, 3))
        assert torch.equal(noise, want_noise[r:r + 1]) and torch.equal(coin, want_coin)
        assert torch.equal(strat, want_strat[r:r + 1])
        assert torch.equal(eps, want_eps[2 * r:2 * r + 2])
    # a world of one draws what one process draws
    assert all(torch.equal(a, b) for a, b in zip(draws((0, 1)), draws(None)))


def _spec_leaves(tree):
    """The specs (tuples) of a spec tree, in leaf order."""
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _spec_leaves(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _spec_leaves(v)
    else:
        yield tree


@pytest.mark.parametrize("n_model", [2, 4, 63])
def test_tp_param_specs_match_jax(n_model):
    """Leaf by leaf the JAX routing (parallel/tp.py:55-77) on the same
    tree: column-parallel q/k/v and the ff proj, row-parallel to_out and the
    ff out, everything else and every dimension n_model does not divide
    replicated (at 63 nothing splits)."""
    _, params = tiny_engine_params()
    want = [tuple(s) for s in jax.tree.leaves(
        j_specs(params, n_model), is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))]
    got = list(_spec_leaves(tp_param_specs(to_torch(params), n_model)))
    assert got == want
    split = {s for s in got if s}
    assert split == (set() if n_model == 63 else {(None, "model"), ("model", None), ("model",)})


def test_shard_params_tp_cuts_packed_weights_part_by_part():
    """A fused to_qkv is cut as [q_r | k_r | v_r], a to_kv as [k_r | v_r],
    the GEGLU proj as [a_r | gate_r]; to_out by rows, its bias whole."""
    w = torch.arange(4 * 12, dtype=torch.float32).reshape(4, 12)
    tree = {"blk": {"attn1": {"to_qkv": {"w": w}, "to_out": {"w": w.T.clone(),
                                                             "b": torch.ones(4)}},
                    "attn2": {"to_kv": {"w": w[:, :8]}},
                    "ff": {"proj": {"w": w[:, :8], "b": torch.arange(8.0)}}}}
    local = shard_params_tp(tree, 2, 1)["blk"]
    cols = lambda x, idx: x[:, idx]  # noqa: E731
    assert torch.equal(local["attn1"]["to_qkv"]["w"], cols(w, [2, 3, 6, 7, 10, 11]))
    assert torch.equal(local["attn1"]["to_out"]["w"], w.T[6:])
    assert torch.equal(local["attn1"]["to_out"]["b"], torch.ones(4))
    assert torch.equal(local["attn2"]["to_kv"]["w"], cols(w, [2, 3, 6, 7]))
    assert torch.equal(local["ff"]["proj"]["w"], cols(w, [2, 3, 6, 7]))
    assert torch.equal(local["ff"]["proj"]["b"], torch.tensor([2.0, 3.0, 6.0, 7.0]))


def test_tp_slices_outside_tensor_parallel_raise():
    assert not is_split(64, 64)
    with pytest.raises(RuntimeError, match="tensor_parallel"):
        is_split(32, 64)
    with pytest.raises(NotImplementedError, match="LoRA"):
        shard_params_tp({"attn1": {"to_q": {"w": torch.zeros(4, 4)},
                                   "lora": {"q_up": {"w": torch.zeros(2, 4)}}}}, 2, 0)
    with tensor_parallel(None):
        assert not is_split(64, 64)


def test_tp_sampling_matches_golden(tmp_path):
    """The golden 3-step sample (tools/goldens_lib.py) on a model group of
    two ranks, each on its local heads, equals ``sample3_latent_tp``."""
    golden = np.load(f"{REPO}/tests/goldens/goldens.npz")["sample3_latent_tp"]
    out = run_ranks("tp_sample", tmp_path, sample3_inputs())
    assert [o["q_cols"] for o in out] == [64, 64]  # half of to_q's 128 columns each
    scale = float(np.abs(golden).max())
    for o in out:
        assert max_err(o["z"], golden) <= 1e-5 * scale
    assert torch.equal(out[0]["z"], out[1]["z"])


def test_tp_loss_and_gradients_match_replicated(tmp_path):
    """Engine.training_loss on two ranks' tensor-parallel slices (the world
    of two as the model group) against the replicated loss in one process,
    with the draws of tests/test_torch_train.py; the pose leaves' gradients
    through the row-parallel reduce and the column-parallel copy agree
    too."""
    _, tcfg = _cfgs()
    params = to_torch(random_params(JEngine(_cfgs()[0]).init_params, seed=3))
    _, batch = _batch()
    draws = {k: t(np.asarray(v)) for k, v in replay_draws(jax.random.PRNGKey(1)).items()}
    eng = Engine(tcfg, device="cpu")
    tr = Trainer(eng)
    state = tr.init_state(params)
    loss, metrics = eng.training_loss(state.params, batch, 1,
                                      Draws(torch.Generator().manual_seed(0), draws))
    loss.backward()
    grads = [leaf.grad for leaf in tr.trainable(state)]
    # a leaf whose exact gradient is 0 (the per-view logit bias under the
    # softmax over views) carries rounding noise only
    floor = 1e-3 * max(float(g.abs().max()) for g in grads)
    out = run_ranks("tp_loss", tmp_path, dict(engine_cfg=tcfg, params=params, batch=batch,
                                              draws=draws))
    for o in out:
        assert o["model_size"] == 2
        assert set(o["metrics"]) == set(metrics)
        for k, v in metrics.items():
            np.testing.assert_allclose(o["metrics"][k], float(v.detach()), rtol=1e-3, atol=2e-4)
        for g, got in zip(grads, o["grads"]):
            assert max_err(got, g) <= 1e-3 * max(float(g.abs().max()), floor)
