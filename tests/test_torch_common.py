"""Shared fixtures of the PyTorch-port parity tests, and the port's rules:
it imports neither JAX nor the JAX package, and its entry points never fall
back to the CPU.

Parity tests feed the same numpy inputs and parameters to a JAX function
and to its port (``device="cpu"``, float32) and bound the max-abs
difference. Parameters come from the JAX initializer's *structure*
(``jax.eval_shape``) filled with seeded numpy draws, so no leaf is zero:
the zero-initialized out layers would otherwise make the UNet's eps
identically 0, and a zero output matches anything.
"""
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from custom_diffusion360_torch.io.from_jax import from_jax_params

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / "custom_diffusion360_torch"

# tiny configs (tests/test_io.py TINY_UNET / TINY_VAE), with a ray chunk
# smaller than the token grid so the chunked encode runs
TINY_UNET = dict(
    model_channels=32, channel_mult=(1, 2), transformer_depth=(1, 2),
    attention_resolutions=(2,), context_dim=64, adm_in_channels=32,
    num_head_channels=16, image_cross_blocks=(0, 1), poscontrol_interval=1,
    num_samples=4, num_freqs=2, nerf_chunk_size=8,
)
TINY_VAE = dict(ch=16, ch_mult=(1, 2), num_res_blocks=1)


@pytest.fixture(scope="module")
def torch_threads():
    """One intra-op thread for a module's torch work, restored after it.
    Tier-1 runs six pytest workers on the machine's cores, and torch's
    default of one thread a core in every worker oversubscribes them: each
    small op then waits for threads that are not scheduled (one 1 s CLI
    test took 175 s inside the suite)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def random_params(init_fn, seed=0):
    """numpy params with the structure of ``init_fn(key)``: weights
    N(0, 1/fan_in), biases N(0, 0.1^2), norm scales 1 + N(0, 0.1^2)."""
    shapes = jax.eval_shape(init_fn, jax.random.PRNGKey(0))
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        name = str(getattr(path[-1], "key", ""))
        shape = leaf.shape
        x = rng.normal(size=shape).astype(np.float32)
        if name == "scale":
            return 1.0 + 0.1 * x
        if name == "w" and len(shape) >= 2:
            fan_in = int(np.prod(shape[:-1]))
            return x / np.sqrt(fan_in)
        return 0.1 * x

    return jax.tree_util.tree_map_with_path(fill, shapes)


def to_torch(tree):
    return from_jax_params(tree, device="cpu")


def t(x):
    """numpy -> CPU tensor."""
    return torch.from_numpy(np.array(x, copy=True))


def max_err(a, b):
    return float(np.abs(np.asarray(a, np.float32) - np.asarray(b, np.float32)).max())


# ---------------------------------------------------------------------------
# rules
# ---------------------------------------------------------------------------


def test_port_imports_no_jax():
    """Importing every port module leaves jax and the JAX package out of
    sys.modules (fresh interpreter)."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import custom_diffusion360_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "       or m.startswith('custom_diffusion360_tpu')]\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, "-c", code], cwd=str(REPO), env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


def test_port_sources_name_no_jax():
    for path in list(PORT.rglob("*.py")) + list(PORT.rglob("*.cu")):
        for line in path.read_text().splitlines():
            code = line.split("#", 1)[0].strip()
            if code.startswith(("import ", "from ")):
                assert "jax" not in code and "custom_diffusion360_tpu" not in code, (
                    f"{path.name}: {line}"
                )


@pytest.mark.parametrize("entry", ["engine", "unet", "vae", "from_jax", "ae_engine",
                                   "init_ae_engine", "compute_fid", "load_discriminator",
                                   "t5", "load_t5", "encoder_unet", "ddpm", "class_uc"])
def test_entry_points_default_to_cuda_and_raise_without_it(entry):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is usable")
    from custom_diffusion360_torch.cli.evaluate import compute_fid
    from custom_diffusion360_torch.engine import Engine
    from custom_diffusion360_torch.models.discriminator import load_discriminator_torch
    from custom_diffusion360_torch.models.embedders import class_embedder_uc
    from custom_diffusion360_torch.models.encoder_unet import init_encoder_unet_params
    from custom_diffusion360_torch.models.extra_blocks import init_ddpm_model_params
    from custom_diffusion360_torch.models.t5 import T5Config, init_t5_params, load_t5_torch
    from custom_diffusion360_torch.models.unet import UNetConfig, init_unet_params
    from custom_diffusion360_torch.models.vae import VAEConfig, init_vae_params
    from custom_diffusion360_torch.train.ae_engine import AEEngine, init_ae_engine

    images = np.zeros((1, 8, 8, 3), np.float32)
    calls = {
        "engine": lambda: Engine(),
        "unet": lambda: init_unet_params(UNetConfig(**TINY_UNET)),
        "vae": lambda: init_vae_params(VAEConfig(**TINY_VAE)),
        "from_jax": lambda: from_jax_params({"w": np.zeros((2, 2), np.float32)}),
        "ae_engine": lambda: AEEngine(),
        "init_ae_engine": lambda: init_ae_engine(),
        "compute_fid": lambda: compute_fid({}, images, images),
        "load_discriminator": lambda: load_discriminator_torch({}),
        "t5": lambda: init_t5_params(T5Config(num_layers=1)),
        "load_t5": lambda: load_t5_torch({}),
        "encoder_unet": lambda: init_encoder_unet_params(),
        "ddpm": lambda: init_ddpm_model_params(),
        "class_uc": lambda: class_embedder_uc(10, 2),
    }
    with pytest.raises(RuntimeError, match="cuda"):
        calls[entry]()


def test_chip_smoke_fails_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: chip_smoke.py would run")
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=str(REPO),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_from_jax_transposes_conv_kernels():
    tree = {"conv": {"w": np.arange(2 * 3 * 4 * 5, dtype=np.float32).reshape(2, 3, 4, 5),
                     "b": np.ones(5, np.float32)},
            "lin": [{"w": np.ones((4, 6), np.float32)}]}
    got = to_torch(tree)
    assert got["conv"]["w"].shape == (5, 4, 2, 3)
    np.testing.assert_array_equal(got["conv"]["w"].numpy(),
                                  tree["conv"]["w"].transpose(3, 2, 0, 1))
    assert got["lin"][0]["w"].shape == (4, 6)
