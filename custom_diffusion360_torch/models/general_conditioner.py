"""Config-driven conditioner: any list of embedders, routed by output rank
(port of custom_diffusion360_tpu/models/general_conditioner.py; sgm
GeneralConditioner). The SDXL stack keeps its specialized form in
models/conditioner.py; this is the general machine for other embedder
combinations (T5, class labels, image embedders, low-scale latents:
models/embedders.py).

* each embedder output goes to "vector" / "crossattn" / "concat" by rank
  (OUTPUT_DIM2KEYS) and concatenates on the last (channel) axis;
* ``input_keys`` pairs ("txt", "txt_ref") embed the target and reference
  values and give [target rows, reference rows] along the batch;
  ``force_ref_zero_embeddings`` embeds the target key only;
* an embedder's ucg_rate zeroes rows where its uniform draw
  ``ucg/<name>`` (rows,) is not below 1 - ucg_rate (``draws.Draws``; the
  JAX package's bernoulli of one key per embedder), one mask for all of
  that embedder's outputs; ``legacy_ucg_val`` substitution is the
  host-side ``possibly_apply_legacy_ucg``, with a numpy Generator as in
  JAX, so both packages draw the same numbers;
* ``general_get_unconditional_conditioning`` turns ucg off for both
  passes.

As in the JAX package, paired outputs are split at the target's row count,
not halved with ``chunk(2)`` as the reference does (the same where the two
halves have equal rows).

Stable Video Diffusion's stack (``svd.yaml``; no JAX counterpart) is
``video_conditioner_specs``: the ViT-H/14 image embedding of the clean
conditioning frame -> crossattn, the sinusoidal ``fps_id``,
``motion_bucket_id`` and ``cond_aug`` -> vector, the VAE mode of the
noised frame -> concat. ``video_conditioning`` runs it as
``scripts/sampling/simple_video_sample.py`` does for one clip.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional, Sequence, Tuple

import torch

from . import embedders
from .clip import ClipVisionConfig, init_clip_vision_params
from .conditioner import embed_size_tuple
from .vae import VAEConfig, init_vae_params

OUTPUT_DIM2KEYS = {2: "vector", 3: "crossattn", 4: "concat", 5: "concat"}


@dataclasses.dataclass(frozen=True)
class EmbedderSpec:
    """One conditioner entry. ``embed(params_slot, value)`` returns a tensor
    or a tuple of tensors, each routed by its own rank."""

    name: str
    embed: Callable[[Any, Any], Any]
    input_key: Optional[str] = None
    input_keys: Optional[Tuple[str, str]] = None
    ucg_rate: float = 0.0
    legacy_ucg_val: Any = None

    def __post_init__(self):
        if (self.input_key is None) == (self.input_keys is None):
            raise ValueError(f"embedder {self.name}: need exactly one of input_key / input_keys")


def possibly_apply_legacy_ucg(spec: EmbedderSpec, batch: dict, rng) -> dict:
    """batch[input_key][i] replaced by legacy_ucg_val with probability
    ucg_rate, one ``rng.choice`` a row (``rng``: numpy.random.Generator).
    Returns a shallow copy."""
    if spec.legacy_ucg_val is None:
        return batch
    vals = list(batch[spec.input_key])
    for i in range(len(vals)):
        if rng.choice(2, p=[1 - spec.ucg_rate, spec.ucg_rate]):
            vals[i] = spec.legacy_ucg_val
    return dict(batch, **{spec.input_key: vals})


def _route(output, emb, spec, tgt_rows, zero, keep, force_ref_zero):
    out_key = OUTPUT_DIM2KEYS[emb.dim()]
    if keep is not None:
        emb = emb * keep.reshape((-1,) + (1,) * (emb.dim() - 1)).to(emb.dtype)
    if zero:
        emb = torch.zeros_like(emb)
    if spec.input_keys is not None and not force_ref_zero:
        pairs = ((out_key, emb[:tgt_rows]), (out_key + "_ref", emb[tgt_rows:]))
    else:
        pairs = ((out_key, emb),)
    for k, v in pairs:
        output[k] = v if k not in output else torch.cat([output[k], v], dim=-1)


def general_conditioner_apply(params: dict, specs: Sequence[EmbedderSpec], batch: dict,
                              draws=None, force_zero_embeddings: Sequence[str] = (),
                              force_ref_zero_embeddings: bool = False):
    """-> dict with "vector" / "crossattn" / "concat" as present; paired-key
    embedders contribute [target rows | reference rows] along the batch.
    ``draws`` supplies ``ucg/<name>`` for every embedder with a ucg_rate
    and no legacy value."""
    output: dict = {}
    for spec in specs:
        slot = params.get(spec.name)
        tgt_rows = None
        if spec.input_key is not None:
            emb_out = spec.embed(slot, batch[spec.input_key])
        elif force_ref_zero_embeddings:
            emb_out = spec.embed(slot, batch[spec.input_keys[0]])
        else:
            outs = [spec.embed(slot, batch[k]) for k in spec.input_keys]
            if isinstance(outs[0], (tuple, list)):
                tgt_rows = outs[0][0].shape[0]
                emb_out = [torch.cat([o[i] for o in outs], dim=0) for i in range(len(outs[0]))]
            else:
                tgt_rows = outs[0].shape[0]
                emb_out = torch.cat(outs, dim=0)
        if not isinstance(emb_out, (tuple, list)):
            emb_out = [emb_out]
        keep = None
        if spec.ucg_rate > 0.0 and spec.legacy_ucg_val is None:
            if draws is None:
                raise ValueError(f"embedder {spec.name}: ucg_rate needs draws "
                                 f"('ucg/{spec.name}')")
            rows = emb_out[0].shape[0]
            keep = draws.uniform(f"ucg/{spec.name}", (rows,), emb_out[0].device) < (
                1.0 - spec.ucg_rate)
        first_key = spec.input_key if spec.input_key is not None else spec.input_keys[0]
        zero = first_key in set(force_zero_embeddings)
        for emb in emb_out:
            _route(output, emb, spec, tgt_rows, zero, keep, force_ref_zero_embeddings)

    for out_key in ("vector", "crossattn", "concat"):  # the reference rows after the target's
        rk = out_key + "_ref"
        if rk in output:
            output[out_key] = torch.cat([output[out_key], output.pop(rk)], dim=0)
    return output


def general_get_unconditional_conditioning(params, specs: Sequence[EmbedderSpec], batch_c: dict,
                                           batch_uc: Optional[dict] = None,
                                           force_uc_zero_embeddings: Sequence[str] = (),
                                           force_ref_zero_embeddings: bool = False):
    """(c, uc) with ucg off for both passes; uc on ``batch_uc`` (or
    ``batch_c``) with ``force_uc_zero_embeddings`` zeroed."""
    no_ucg = [dataclasses.replace(s, ucg_rate=0.0) for s in specs]
    c = general_conditioner_apply(params, no_ucg, batch_c,
                                  force_ref_zero_embeddings=force_ref_zero_embeddings)
    uc = general_conditioner_apply(params, no_ucg, batch_c if batch_uc is None else batch_uc,
                                   force_zero_embeddings=force_uc_zero_embeddings,
                                   force_ref_zero_embeddings=force_ref_zero_embeddings)
    return c, uc


# ---------------------------------------------------------------------------
# Stable Video Diffusion img2vid (svd.yaml's conditioner_config)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class VideoConditionerConfig:
    vision: ClipVisionConfig = ClipVisionConfig()  # ViT-H/14, 1024-d pooled
    vae: VAEConfig = VAEConfig(scale_factor=0.18215)
    outdim: int = 256  # each ConcatTimestepEmbedderND's width


# the entries the unconditional pass zeroes (simple_video_sample.py)
VIDEO_UC_ZERO = ("cond_frames", "cond_frames_without_noise")


def video_conditioner_specs(cfg: VideoConditionerConfig):
    """The embedders of svd.yaml in order; the params slots are
    "cond_frames_without_noise" (the vision tower) and "cond_frames" (the
    VAE)."""

    def timestep(key):  # ConcatTimestepEmbedderND of one value a row
        return EmbedderSpec(key, lambda p, v: embed_size_tuple(v[:, None], cfg.outdim),
                            input_key=key)

    return [
        EmbedderSpec("cond_frames_without_noise",
                     lambda p, v: embedders.open_clip_image_prediction_embedder(
                         p, v, cfg.vision),
                     input_key="cond_frames_without_noise"),
        timestep("fps_id"),
        timestep("motion_bucket_id"),
        EmbedderSpec("cond_frames",
                     lambda p, v: embedders.video_prediction_embedder_with_encoder(
                         p, v, cfg.vae),
                     input_key="cond_frames"),
        timestep("cond_aug"),
    ]


def init_video_conditioner_params(cfg: VideoConditionerConfig = VideoConditionerConfig(),
                                  seed: int = 0, device="cuda", dtype=torch.float32):
    vae = init_vae_params(cfg.vae, seed + 1, device, dtype)
    return {"cond_frames_without_noise": init_clip_vision_params(cfg.vision, seed, device, dtype),
            "cond_frames": {"encoder": vae["encoder"], "quant_conv": vae["quant_conv"]}}


def video_batch(image, cond_noise, frames: int, fps_id: int, motion_bucket_id: int,
                cond_aug: float):
    """The conditioner's batch for one clip of ``frames`` frames:
    image (1, H, W, 3) in [-1, 1], ``cond_noise`` standard normal draws of
    its shape (the noised frame is image + cond_aug * cond_noise), the
    three scalars one row a frame."""

    def per_frame(v):
        return torch.full((frames,), float(v), device=image.device)

    return {"cond_frames_without_noise": image, "cond_frames": image + cond_aug * cond_noise,
            "fps_id": per_frame(fps_id), "motion_bucket_id": per_frame(motion_bucket_id),
            "cond_aug": per_frame(cond_aug)}


def video_conditioning(params, cfg: VideoConditionerConfig, batch: dict, frames: int):
    """(c, uc) of a ``video_batch``: uc with crossattn and concat zeroed,
    and both repeated to one row a frame."""
    c, uc = general_get_unconditional_conditioning(
        params, video_conditioner_specs(cfg), batch, force_uc_zero_embeddings=VIDEO_UC_ZERO)
    for d in (c, uc):
        for k in ("crossattn", "concat"):
            d[k] = d[k].repeat_interleave(frames, dim=0)
    return c, uc
