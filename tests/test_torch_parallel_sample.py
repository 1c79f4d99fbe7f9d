"""Latency sharding of ``Engine.sample`` over the CFG rows
(``cfg_group``, the JAX package's ``cfg_sharding``) on two gloo ranks
spawned as processes (tests/torch_parallel_worker.py, with timeouts), CPU,
float32: each rank runs the UNet on its half of the num_copies x B guider
rows, and one all-gather before the guider combine gives both the same
latent; and ``cli.sample --latency_shard`` under torchrun's environment.

Tolerances: 1e-5 of max(1, max|ref|), against the unsharded port and
against the JAX package's unsharded ``Engine.sample`` on the same injected
noise, as tests/test_torch_engine.py. JAX
tests/test_parallel_sampling.py::test_cfg_sharded_single_image_latency_mode
holds 2e-4 absolute, but on a freshly initialized UNet, whose zero output
conv leaves no network rounding in the latent; with the random weights
here the latents reach about 60, and the float32 rounding of one-row
against two-row products reaches 2.9e-4 absolute (5e-6 of the scale)
after 3 steps.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from custom_diffusion360_tpu.engine import Engine as JEngine
from custom_diffusion360_tpu.geometry.cameras import Cameras as JCams
from custom_diffusion360_torch.engine import Engine
from custom_diffusion360_torch.geometry.cameras import Cameras
from tests.test_cameras import random_cameras
from tests.test_torch_common import max_err, t, to_torch
from tests.test_torch_common import torch_threads  # noqa: F401  (fixture)
from tests.test_torch_engine_samplers import GUIDERS, LAT, NREF, STEPS, _cfgs
from tests.test_torch_engine_samplers import setup  # noqa: F401  (module fixture)
from tests.torch_parallel_worker import run_ranks

pytestmark = pytest.mark.usefixtures("torch_threads")


def _tiled_cams(copies, b, seed):
    """b target poses (with the shared reference cameras), the b-row block
    tiled over the guider copies."""
    rows = [[np.asarray(f) for f in random_cameras(1 + NREF, seed=seed + i)] for i in range(b)]
    block = [np.stack([r[j] for r in rows]) for j in range(5)]
    return Cameras(*(t(np.concatenate([f] * copies)) for f in block))


def _inputs(setup, copies, b=1, live=False, mask=False):  # noqa: F811
    params, refs, _, cond, uc, noise = setup
    rng = np.random.default_rng(50 + copies + b)
    kw = {}
    if b != 1 or live:
        rows = b + (b * NREF if live else 0)
        cond = {"crossattn": rng.normal(size=(rows, 16, 64)).astype(np.float32),
                "vector": rng.normal(size=(rows, 32)).astype(np.float32)}
        uc = {k: rng.normal(size=v.shape).astype(np.float32) for k, v in cond.items()}
        noise = rng.normal(size=(b, LAT, LAT, 4)).astype(np.float32)
    if live:
        kw = dict(input_ref=t(rng.normal(size=(copies * b, NREF, LAT, LAT, 4))
                              .astype(np.float32)),
                  sigmas_ref=t(rng.uniform(0.2, 4.0, size=(copies * b,)).astype(np.float32)))
    if mask:
        kw["mask_ref"] = t((rng.uniform(size=(copies * b, NREF, LAT, LAT, 1)) > 0.3)
                           .astype(np.float32))
    return dict(engine_cfg=_cfgs()[1], params=to_torch(params),
                cond={k: t(v) for k, v in cond.items()}, uc={k: t(v) for k, v in uc.items()},
                guider=GUIDERS[copies][1], noise=t(noise), cams=_tiled_cams(copies, b, 60),
                references=None if live else {a: {d: t(v) for d, v in dd.items()}
                                              for a, dd in refs.items()},
                choices=None if live else np.arange(NREF), steps=STEPS, kwargs=kw)


def _unsharded(inp):
    eng = Engine(inp["engine_cfg"], device="cpu")
    return eng.sample(inp["params"], inp["cond"], inp["uc"], inp["guider"], noise=inp["noise"],
                      cams=inp["cams"], references=inp["references"], choices=inp["choices"],
                      num_steps=inp["steps"], shared_target_cams=True, **inp["kwargs"])


def test_cfg_sharded_sample_matches_unsharded_and_jax(setup, tmp_path):  # noqa: F811
    """One image under the x2 guider, its uc and c rows on the two ranks."""
    inp = _inputs(setup, 2)
    out = run_ranks("cfg_sample", tmp_path, inp)
    want = _unsharded(inp)
    params, refs, _, cond, uc, noise = setup
    z_j = np.asarray(JEngine(_cfgs()[0]).sample(
        jax.tree.map(jnp.asarray, params), jax.tree.map(jnp.asarray, cond),
        jax.tree.map(jnp.asarray, uc), GUIDERS[2][0], jax.random.PRNGKey(0),
        shape=noise.shape, cams=JCams(*(jnp.asarray(f.numpy()) for f in inp["cams"])),
        references=jax.tree.map(jnp.asarray, refs), choices=np.arange(NREF),
        num_steps=STEPS, noise=jnp.asarray(noise)))
    assert float(np.abs(z_j - noise * np.sqrt(1 + 14.6**2)).max()) > 1.0  # it moved
    for z in out:
        assert z.shape == want.shape
        assert max_err(z, want) <= 1e-5 * max(1.0, float(want.abs().max()))
        assert max_err(z, z_j) <= 1e-5 * max(1.0, float(np.abs(z_j).max()))
    assert torch.equal(out[0], out[1])


CASES = {"x3-batch2": dict(copies=3, b=2), "live-x2": dict(copies=2, live=True),
         "live-x2-mask": dict(copies=2, live=True, mask=True)}


@pytest.mark.parametrize("case", sorted(CASES))
def test_cfg_sharded_sample_matches_unsharded(setup, tmp_path, case):  # noqa: F811
    """x3 over two images (three rows a rank; the unsharded run takes both
    dedupes, the sharded neither), and live reference latents (each rank's
    reference rows of the conditioning), with and without per-row masks."""
    inp = _inputs(setup, **CASES[case])
    out = run_ranks("cfg_sample", tmp_path, inp)
    want = _unsharded(inp)
    for z in out:
        assert z.shape == want.shape
        assert max_err(z, want) <= 1e-5 * max(1.0, float(want.abs().max())), case
    assert torch.equal(out[0], out[1])


def test_sample_cli_latency_shard_on_two_ranks(tmp_path, monkeypatch):
    """cli.sample --latency_shard --scale_im 0 under torchrun's environment
    on two ranks: each takes one of the x2 guider's rows, both get the
    one-process image, and rank 0 alone writes the PNG."""
    from custom_diffusion360_torch.cli import sample as cli

    argv = ["--smoke", "--device", "cpu", "--dtype", "float32", "--num_steps", "2",
            "--num_images", "1", "--resolution", "64", "--scale_im", "0"]
    out = run_ranks("sample_cli", tmp_path, {"argv": argv})
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    (want,) = cli.main(argv + ["--output_dir", str(tmp_path / "one")])
    for o in out:
        assert max_err(o["images"], want["images"]) <= 1.0  # of 255
    assert len(out[0]["paths"]) == 1 and out[1]["paths"] == []
    assert not (tmp_path / "out_dir1").exists()
