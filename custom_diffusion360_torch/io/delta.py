"""Where the FeatureNeRF pose blocks sit in the UNet (port of
``iter_pose_blocks`` from custom_diffusion360_tpu/io/delta.py; loading and
saving delta checkpoints comes with the checkpoint loaders)."""
from __future__ import annotations

from typing import Iterator, Tuple

from ..models.unet import UNetConfig, build_unet_spec


def iter_pose_blocks(cfg: UNetConfig) -> Iterator[Tuple[str, Tuple, int, int]]:
    """Yields (torch_prefix, tree_path, attn_id, depth) for every FeatureNeRF
    block. tree_path indexes params["unet"]: (section, i, j), or
    ("middle_block", j)."""
    inb, mid, outb, _ = build_unet_spec(cfg)

    def emit(section, i, j, spec):
        if spec[0] != "attn":
            return
        _, ch, depth, attn_id = spec
        tcfg = cfg.transformer_config(ch, depth, attn_id)
        for d in range(depth):
            if tcfg.block_has_nerf(d):
                if section == "middle_block":
                    prefix = f"model.diffusion_model.middle_block.{j}.transformer_blocks.{d}"
                    path = ("middle_block", j)
                else:
                    prefix = f"model.diffusion_model.{section}.{i}.{j}.transformer_blocks.{d}"
                    path = (section, i, j)
                yield prefix, path, attn_id, d

    for i, block in enumerate(inb):
        for j, spec in enumerate(block):
            yield from emit("input_blocks", i, j, spec)
    for j, spec in enumerate(mid):
        yield from emit("middle_block", None, j, spec)
    for i, block in enumerate(outb):
        for j, spec in enumerate(block):
            yield from emit("output_blocks", i, j, spec)

