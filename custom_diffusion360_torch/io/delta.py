"""Delta checkpoints, the distribution format of a customized model (port
of custom_diffusion360_tpu/io/delta.py).

In memory a delta is the reference's flat ``delta_state_dict``: torch keys
for the pose weights (``...pose_emb_layers.weight``, ``...pose_featurenerf.
model.*``), per-block ``...references`` buffers, and one ``"embed"`` entry
holding ``[clip_l_rows (M, 768), open_clip_rows (M, 1280)]``. Values are
numpy arrays (``.npz``) or CPU tensors (the reference's torch ``.ckpt``,
whose bf16 leaves numpy cannot hold). ``extract_delta`` builds one from
trained params and captured reference buffers, as numpy float32 arrays
(numpy has no bfloat16, so buffers computed in bf16 are written as
float32).
"""
from __future__ import annotations

import pickle
from typing import Dict, Iterator, Tuple

import numpy as np
import torch

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



def _get_block(unet_params, path, d):
    if path[0] == "middle_block":
        st = unet_params["middle_block"][path[1]]
    else:
        st = unet_params[path[0]][path[1]][path[2]]
    return st["blocks"][d]


_POSE_LEAVES = [
    # (torch suffix, tree keys, transpose)
    (".pose_emb_layers.weight", ("pose_emb_layers", "w"), True),
    (".pose_featurenerf.model.plane_coefs.0.weight", ("pose_featurenerf", "plane_coefs", "l1", "w"), True),
    (".pose_featurenerf.model.plane_coefs.0.bias", ("pose_featurenerf", "plane_coefs", "l1", "b"), False),
    (".pose_featurenerf.model.plane_coefs.2.weight", ("pose_featurenerf", "plane_coefs", "l2", "w"), True),
    (".pose_featurenerf.model.plane_coefs.2.bias", ("pose_featurenerf", "plane_coefs", "l2", "b"), False),
    (".pose_featurenerf.model.decoder.weight", ("pose_featurenerf", "decoder", "w"), True),
    (".pose_featurenerf.model.nviews.weight", ("pose_featurenerf", "nviews", "w"), True),
    (".pose_featurenerf.model.nviews.bias", ("pose_featurenerf", "nviews", "b"), False),
]


def _tree_get(d, keys):
    for k in keys:
        if not isinstance(d, dict) or k not in d:
            return None
        d = d[k]
    return d


def _f32_numpy(v):
    return v.detach().float().cpu().numpy()


def extract_delta(params: dict, references: dict = None,
                  cfg: UNetConfig = UNetConfig()) -> Dict[str, np.ndarray]:
    """The reference-format delta_state_dict of ``params`` (the inverse of
    ``apply_delta_state_dict``): each pose block's leaves as float32 torch
    (out, in) arrays, its ``references`` buffer (N + 1, hw, C) when
    ``references`` {attn_id: {d: buffer}} holds one, and ``"embed"``, the
    two V* modifier-row arrays."""
    out: Dict[str, np.ndarray] = {}
    for prefix, path, attn_id, d in iter_pose_blocks(cfg):
        blk = _get_block(params["unet"], path, d)
        for suffix, keys, transpose in _POSE_LEAVES:
            v = _tree_get(blk, keys)
            if v is None:
                continue
            v = _f32_numpy(v)
            out[prefix + suffix] = np.ascontiguousarray(v.T) if transpose else v
        if references and d in references.get(attn_id, {}):
            out[prefix + ".references"] = _f32_numpy(references[attn_id][d])
    if "conditioner" in params:
        cond = params["conditioner"]
        out["embed"] = [_f32_numpy(cond["clip_l"]["modifier_rows"]),
                        _f32_numpy(cond["open_clip"]["modifier_rows"])]
    return out


def _tree_set(d, keys, value):
    for k in keys[:-1]:
        d = d.setdefault(k, {})
    d[keys[-1]] = value


def _tensor(v, device):
    t = v if isinstance(v, torch.Tensor) else torch.from_numpy(np.array(v, copy=True))
    return t.to(device)


def apply_delta_state_dict(params: dict, sd_delta: Dict, cfg: UNetConfig = UNetConfig()):
    """Merge a reference-format delta_state_dict into {unet, conditioner}
    params (the pose-block dicts are updated in place) -> (params,
    references). Torch (out, in) linears become (in, out); leaves keep the
    delta's dtype and go to the device of the UNet's ``time_embed``.

    references: {attn_id: {d: (Nref + 1, hw, C)}} token-grid feature
    buffers, the last row the zero-image feature."""
    device = params["unet"]["time_embed"]["l1"]["w"].device
    references: dict = {}
    for prefix, path, attn_id, d in iter_pose_blocks(cfg):
        blk = _get_block(params["unet"], path, d)
        for suffix, keys, transpose in _POSE_LEAVES:
            tk = prefix + suffix
            if tk in sd_delta:
                v = _tensor(sd_delta[tk], device)
                _tree_set(blk, keys, v.t().contiguous() if transpose else v)
        rk = prefix + ".references"
        if rk in sd_delta:
            references.setdefault(attn_id, {})[d] = _tensor(sd_delta[rk], device)
    if "embed" in sd_delta and "conditioner" in params:
        rows_l, rows_g = sd_delta["embed"]
        cond = params["conditioner"]
        cond["clip_l"]["modifier_rows"] = _tensor(rows_l, cond["clip_l"]["token_embedding"].device)
        cond["open_clip"]["modifier_rows"] = _tensor(
            rows_g, cond["open_clip"]["token_embedding"].device)
    return params, references


def save_delta_npz(path: str, sd_delta: Dict) -> None:
    flat = {}
    for k, v in sd_delta.items():
        if k == "embed":
            flat["embed.0"], flat["embed.1"] = np.asarray(v[0]), np.asarray(v[1])
        else:
            flat[k] = np.asarray(v)
    np.savez(path, **flat)


def load_delta_npz(path: str) -> Dict[str, np.ndarray]:
    with np.load(path) as f:
        data = dict(f)
    if "embed.0" in data:
        data["embed"] = [data.pop("embed.0"), data.pop("embed.1")]
    return data


def load_delta_torch(path: str) -> Dict[str, torch.Tensor]:
    """The reference's ``.ckpt`` with a ``"delta_state_dict"`` entry ->
    {key: CPU tensor}, ``"embed"`` a list of two.

    Reads with ``torch.load(weights_only=True)``, which unpickles tensors
    and containers only. A checkpoint that pickled other objects beside the
    delta (the reference's training loop may) is refused by that reader and
    then read with ``weights_only=False``, which can run code stored in the
    file: load only checkpoints from a source you trust."""
    try:
        obj = torch.load(path, map_location="cpu", weights_only=True)
    except pickle.UnpicklingError:
        obj = torch.load(path, map_location="cpu", weights_only=False)
    sd = obj["delta_state_dict"]
    out = {}
    for k, v in sd.items():
        if k == "embed":
            out["embed"] = [x.detach().cpu() for x in v]
        else:
            out[k] = v.detach().cpu()
    return out
