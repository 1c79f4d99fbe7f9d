"""The two packages a cell runs: the port (the system under test) and the
plain reference (``refmodel/cd360ref``, f32, no kernels). Both have the
same module layout, so one configuration file builds either side."""
from __future__ import annotations

import importlib
import sys
from pathlib import Path
from types import SimpleNamespace

PORT = "custom_diffusion360_torch"
REFERENCE = "cd360ref"
_MODULES = ("engine", "draws", "geometry.cameras", "diffusion.guiders", "models.unet",
            "models.vae", "models.clip", "models.conditioner", "models.transformer",
            "train.trainer", "train.ae_engine")


def package(name: str) -> SimpleNamespace:
    """The modules of ``name`` a cell uses, as attributes (``engine``,
    ``cameras``, ``guiders``, ``unet``, ...)."""
    if name == REFERENCE:
        ref_dir = str(Path(__file__).resolve().parents[1] / "refmodel")
        if ref_dir not in sys.path:
            sys.path.insert(0, ref_dir)
    mods = {m.split(".")[-1]: importlib.import_module(f"{name}.{m}") for m in _MODULES}
    return SimpleNamespace(name=name, **mods)


def _tuples(d: dict) -> dict:
    return {k: tuple(v) if isinstance(v, list) else v for k, v in d.items()}


def vae_config(pkg, model: dict):
    return pkg.vae.VAEConfig(**_tuples(model["vae"]))


def engine_config(pkg, model: dict, dtype: str, unet_run: dict = None, **engine_kw):
    """EngineConfig of a configuration file's ``unet`` / ``vae`` /
    ``conditioner`` widths in ``dtype``, with the run settings ``unet_run``
    (the NeRF's chunk and dtype) on the UNet."""
    cond = model["conditioner"]
    clip = pkg.clip.ClipTextConfig
    return pkg.engine.EngineConfig(
        unet=pkg.unet.UNetConfig(**_tuples(model["unet"]), **(unet_run or {})),
        vae=vae_config(pkg, model),
        conditioner=pkg.conditioner.ConditionerConfig(
            clip_l=clip(**cond["clip_l"]), open_clip=clip(**cond["open_clip"]),
            size_outdim=cond["size_outdim"]),
        compute_dtype=dtype, **engine_kw)


def engine_init(pkg, cfg, dtype):
    """A call of ``pkg``'s initializers of the {unet, vae, conditioner}
    tree (``weights.make`` records its layout and draws its values)."""
    return lambda: {"unet": pkg.unet.init_unet_params(cfg.unet, 0, "cpu", dtype),
                    "vae": pkg.vae.init_vae_params(cfg.vae, 0, "cpu", dtype),
                    "conditioner": pkg.conditioner.init_conditioner_params(
                        cfg.conditioner, 0, "cpu", dtype)}


def ae_config(pkg, model: dict):
    return pkg.ae_engine.AEEngineConfig(vae=vae_config(pkg, model), **model["trainer"])


def cameras(pkg, rot, trans, device):
    """Cameras of ``pkg`` from the benchmark's rotations (N, 3, 3) and
    translations (N, 3), focal length 2 and principal point 0 (NDC), as the
    sampling CLI's ring cameras."""
    return pkg.cameras.Cameras.create(rot, trans, 2.0, 0.0, device=device)
