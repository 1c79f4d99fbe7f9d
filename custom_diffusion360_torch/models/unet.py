"""SDXL UNet with FeatureNeRF pose blocks (port of
custom_diffusion360_tpu/models/unet.py).

The network is a static spec built from the config, walked by init and
apply over a dict of tensors, as in the JAX package. NHWC activations. The
pose blocks render from precomputed reference tokens (``ref_features``),
read the render cache (``nerf_caches``), or, in training, render from the
live reference stream: the reference latents (``input_ref``) run the same
frozen weights in lockstep under ``torch.no_grad`` with their own timestep
embedding (the JAX package's stop-gradient ``_Stream.both``). Under the x3
guider the cached steps run the layers before the first attention on the
unique CFG copies only (``prefix_dedupe``). Under a profiler each layer
runs inside a span named by its kind (``LAYER_SPANS``).

Under a ``VideoUNetConfig`` the spec is Stable Video Diffusion's VideoUNet
(sgm ``video_model.py``): the batch holds clips of ``num_video_frames`` frames,
each res block is a VideoResBlock (the spatial block, then a res block
over the frames with (k, 1, 1) convolutions and GroupNorm over the whole
clip, blended with it) and each transformer a SpatialVideoTransformer
(models/transformer.py). There are no pose blocks. The temporal halves run
inside the spans ``cd360.unet.time_res`` and ``cd360.unet.time_attn``.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from .. import resolve_device
from ..utils.trace import span
from .nerf import NerfConfig
from .nn import (
    Init,
    conv2d,
    conv2d_init,
    conv_time,
    conv_time_init,
    group_norm_init,
    group_norm_silu,
    linear,
    linear_init,
    silu,
    timestep_embedding,
    torch_dtype,
    upsample_nearest_2x,
)
from .transformer import (
    TransformerConfig,
    blend,
    context_kv,
    init_spatial_transformer,
    init_spatial_video_transformer,
    mix_alpha,
    spatial_transformer_apply,
    spatial_video_transformer_apply,
)

# svd.yaml's VideoUNet: each blend's mix_factor starts at merge_factor; the
# temporal convolutions are (VIDEO_KERNEL, 1, 1)
MERGE_FACTOR = 0.5
VIDEO_KERNEL = 3

# the span of each kind of layer of the spec (utils/trace.py)
LAYER_SPANS = {kind: f"cd360.unet.{kind}" for kind in ("conv_in", "res", "down", "up", "attn")}
LAYER_SPANS.update(vres=LAYER_SPANS["res"], vattn=LAYER_SPANS["attn"])


@dataclasses.dataclass(frozen=True)
class UNetConfig:
    in_channels: int = 4
    model_channels: int = 320
    out_channels: int = 4
    num_res_blocks: int = 2
    attention_resolutions: Tuple[int, ...] = (4, 2)
    channel_mult: Tuple[int, ...] = (1, 2, 4)
    transformer_depth: Tuple[int, ...] = (1, 2, 10)
    context_dim: int = 2048
    adm_in_channels: int = 2816
    num_head_channels: int = 64
    image_cross_blocks: Tuple[int, ...] = (0, 2, 4, 6, 8, 10)
    rgb_predict: bool = True
    far: float = 2.0
    num_samples: int = 24
    near_plane: float = 0.0
    average: bool = False
    num_freqs: int = 16
    use_prev_weights_imp_sample: bool = True
    poscontrol_interval: int = 4
    stratified: bool = True
    imp_sampling_percent: float = 0.9
    add_lora: bool = False
    nerf_chunk_size: int = 512
    nerf_dtype: str = "float32"

    def nerf_config(self, dim: int) -> NerfConfig:
        return NerfConfig(
            dim=dim, num_samples=self.num_samples, far_plane=self.far,
            near_plane=self.near_plane, num_freqs=self.num_freqs,
            rgb_predict=self.rgb_predict, average=self.average,
            stratified=self.stratified, imp_sampling_percent=self.imp_sampling_percent,
            chunk_size=self.nerf_chunk_size, compute_dtype=self.nerf_dtype,
        )

    def transformer_config(self, ch: int, depth: int, attn_id: int) -> TransformerConfig:
        return TransformerConfig(
            dim=ch, depth=depth, n_heads=ch // self.num_head_channels,
            d_head=self.num_head_channels, context_dim=self.context_dim,
            image_cross=attn_id in self.image_cross_blocks,
            poscontrol_interval=self.poscontrol_interval,
            use_prev_weights_imp_sample=self.use_prev_weights_imp_sample,
            rgb_predict=self.rgb_predict, add_lora=self.add_lora,
            nerf=self.nerf_config(ch),
        )


@dataclasses.dataclass(frozen=True)
class VideoUNetConfig(UNetConfig):
    """Stable Video Diffusion's VideoUNet: the same widths and spec walk
    with the video layer kinds; no pose blocks."""

    image_cross_blocks: Tuple[int, ...] = ()


def build_unet_spec(cfg: UNetConfig):
    """(input_blocks, middle_block, output_blocks, num_transformers); each
    block a list of layer specs ("conv_in", in, out), ("res", in, out),
    ("attn", ch, depth, attn_id), ("down", ch), ("up", ch); a video network
    has ("vres", in, out) and ("vattn", ch, depth, attn_id) in their place."""
    res, attn = ("vres", "vattn") if isinstance(cfg, VideoUNetConfig) else ("res", "attn")
    input_blocks = [[("conv_in", cfg.in_channels, cfg.model_channels)]]
    input_chans = [cfg.model_channels]
    ch = cfg.model_channels
    ds = 1
    attn_id = 0
    for level, mult in enumerate(cfg.channel_mult):
        for _ in range(cfg.num_res_blocks):
            layers = [(res, ch, mult * cfg.model_channels)]
            ch = mult * cfg.model_channels
            if ds in cfg.attention_resolutions:
                layers.append((attn, ch, cfg.transformer_depth[level], attn_id))
                attn_id += 1
            input_blocks.append(layers)
            input_chans.append(ch)
        if level != len(cfg.channel_mult) - 1:
            input_blocks.append([("down", ch)])
            input_chans.append(ch)
            ds *= 2

    middle_block = [(res, ch, ch),
                    (attn, ch, cfg.transformer_depth[-1], attn_id),
                    (res, ch, ch)]
    attn_id += 1

    output_blocks = []
    for level, mult in list(enumerate(cfg.channel_mult))[::-1]:
        for i in range(cfg.num_res_blocks + 1):
            ich = input_chans.pop()
            layers = [(res, ch + ich, cfg.model_channels * mult)]
            ch = cfg.model_channels * mult
            if ds in cfg.attention_resolutions:
                layers.append((attn, ch, cfg.transformer_depth[level], attn_id))
                attn_id += 1
            if level and i == cfg.num_res_blocks:
                layers.append(("up", ch))
                ds //= 2
            output_blocks.append(layers)
    return input_blocks, middle_block, output_blocks, attn_id


def attn_block_meta(cfg: UNetConfig):
    """{attn_id: (ds, channels, depth)} for every spatial transformer."""
    inb, mid, outb, _ = build_unet_spec(cfg)
    meta = {}
    ds = 1
    for block in inb:
        for spec in block:
            if spec[0] == "attn":
                meta[spec[3]] = (ds, spec[1], spec[2])
            elif spec[0] == "down":
                ds *= 2
    meta[mid[1][3]] = (ds, mid[1][1], mid[1][2])
    for block in outb:
        for spec in block:
            if spec[0] == "attn":
                meta[spec[3]] = (ds, spec[1], spec[2])
            elif spec[0] == "up":
                ds //= 2
    return meta


# ---------------------------------------------------------------------------
# init / layers
# ---------------------------------------------------------------------------


def _init_resblock(init: Init, in_ch, out_ch, emb_dim):
    p = {
        "norm_in": group_norm_init(init, in_ch),
        "conv_in": conv2d_init(init, in_ch, out_ch, 3),
        "emb": linear_init(init, emb_dim, out_ch),
        "norm_out": group_norm_init(init, out_ch),
        "conv_out": conv2d_init(init, out_ch, out_ch, 3, zero=True),
    }
    if in_ch != out_ch:
        p["skip"] = conv2d_init(init, in_ch, out_ch, 1)
    return p


def _resblock_apply(p, x, emb):
    # ResBlock GroupNorms use eps 1e-5 (GroupNorm32), unlike the 1e-6 of the
    # transformer/VAE norms
    h = conv2d(p["conv_in"], group_norm_silu(p["norm_in"], x, eps=1e-5))
    h = h + linear(p["emb"], silu(emb))[:, None, None, :].to(h.dtype)
    h = conv2d(p["conv_out"], group_norm_silu(p["norm_out"], h, eps=1e-5))
    skip = conv2d(p["skip"], x) if "skip" in p else x
    return skip + h


def _init_video_resblock(init: Init, in_ch, out_ch, emb_dim):
    """VideoResBlock: the spatial res block, its ``time_stack`` (a res block
    over the frames, identity skip) and the blend's ``mix_factor``."""
    k = VIDEO_KERNEL
    p = _init_resblock(init, in_ch, out_ch, emb_dim)
    p["time_stack"] = {
        "norm_in": group_norm_init(init, out_ch),
        "conv_in": conv_time_init(init, out_ch, out_ch, k),
        "emb": linear_init(init, emb_dim, out_ch),
        "norm_out": group_norm_init(init, out_ch),
        "conv_out": conv_time_init(init, out_ch, out_ch, k, zero=True),
    }
    p["mix_factor"] = init.full((1,), MERGE_FACTOR)
    return p


def _video_resblock_apply(p, x, emb, frames: int, image_only):
    """x: (B * T, H, W, Cin) frames of B clips; emb: (B * T, E). The
    spatial block, then (span ``cd360.unet.time_res``) GroupNorm32 over the
    clip, SiLU, the (k, 1, 1) convolution, each frame's emb projection,
    again, plus the spatial output, blended with the spatial output."""
    h = _resblock_apply(p, x, emb)
    with span("cd360.unet.time_res"):
        ts = p["time_stack"]
        bt, hh, ww, c = h.shape
        clip = (bt // frames, frames * hh * ww, c)
        z = group_norm_silu(ts["norm_in"], h.reshape(clip), eps=1e-5).reshape(h.shape)
        z = conv_time(ts["conv_in"], z, frames)
        z = z + linear(ts["emb"], silu(emb))[:, None, None, :].to(z.dtype)
        z = group_norm_silu(ts["norm_out"], z.reshape(clip), eps=1e-5).reshape(h.shape)
        z = h + conv_time(ts["conv_out"], z, frames)
        return blend(mix_alpha(p["mix_factor"], image_only), h, z)


def _init_layer(init: Init, spec, cfg: UNetConfig, emb_dim):
    kind = spec[0]
    if kind == "conv_in":
        return conv2d_init(init, spec[1], spec[2], 3)
    if kind == "res":
        return _init_resblock(init, spec[1], spec[2], emb_dim)
    if kind == "vres":
        return _init_video_resblock(init, spec[1], spec[2], emb_dim)
    if kind == "attn":
        _, ch, depth, attn_id = spec
        return init_spatial_transformer(init, ch, cfg.transformer_config(ch, depth, attn_id))
    if kind == "vattn":
        _, ch, depth, attn_id = spec
        return init_spatial_video_transformer(init, ch, cfg.transformer_config(ch, depth, attn_id),
                                              MERGE_FACTOR)
    if kind in ("down", "up"):
        return conv2d_init(init, spec[1], spec[1], 3)
    raise ValueError(kind)


def init_unet_params(cfg: UNetConfig, seed: int = 0, device="cuda",
                     dtype=torch.float32):
    """Seeded random parameters with the JAX initializer's structure and
    distributions (kaiming-uniform; zero-init out layers, identity
    pose_emb_layers). The draws differ from JAX's."""
    init = Init(seed, resolve_device(device), torch_dtype(dtype))
    inb, mid, outb, _ = build_unet_spec(cfg)
    emb_dim = cfg.model_channels * 4
    params = {
        "time_embed": {"l1": linear_init(init, cfg.model_channels, emb_dim),
                       "l2": linear_init(init, emb_dim, emb_dim)},
        "label_emb": {"l1": linear_init(init, cfg.adm_in_channels, emb_dim),
                      "l2": linear_init(init, emb_dim, emb_dim)},
        "out_norm": group_norm_init(init, cfg.model_channels),
        "out_conv": conv2d_init(init, cfg.model_channels, cfg.out_channels, 3, zero=True),
    }
    params["input_blocks"] = [[_init_layer(init, s, cfg, emb_dim) for s in blk] for blk in inb]
    params["middle_block"] = [_init_layer(init, s, cfg, emb_dim) for s in mid]
    params["output_blocks"] = [[_init_layer(init, s, cfg, emb_dim) for s in blk] for blk in outb]
    return params


def _mlp2(p, x):
    return linear(p["l2"], silu(linear(p["l1"], x)))


def _iter_attn(params, cfg: UNetConfig):
    """(layer params, spec) of every spatial transformer, in network order."""
    inb, mid, outb, _ = build_unet_spec(cfg)
    for lp_block, spec_block in zip(params["input_blocks"], inb):
        for lp, spec in zip(lp_block, spec_block):
            if spec[0] == "attn":
                yield lp, spec
    for lp, spec in zip(params["middle_block"], mid):
        if spec[0] == "attn":
            yield lp, spec
    for lp_block, spec_block in zip(params["output_blocks"], outb):
        for lp, spec in zip(lp_block, spec_block):
            if spec[0] == "attn":
                yield lp, spec


def precompute_context_kv(params, cfg: UNetConfig, context):
    """{attn_id: [per-depth (k, v)]} text cross-attention K/V for a fixed
    (CFG-batched, compute-dtype) context (B, M, context_dim)."""
    return {spec[3]: [context_kv(blk["attn2"], context) for blk in lp["blocks"]]
            for lp, spec in _iter_attn(params, cfg)}


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------


def _row_blocks(t, blocks, bb: int):
    """The blocks of bb rows of t numbered ``blocks``, in that order, in one
    copy (no index tensor, so nothing crosses from the host: the cached
    steps run inside a CUDA graph, ``models/unet_graphs.py``)."""
    return torch.cat([t[i * bb:(i + 1) * bb] for i in blocks])


def unet_apply(params, cfg: UNetConfig, x, timesteps, context, y, *, cams=None,
               nerf_caches=None, ref_features=None, ctx_kv=None,
               compute_dtype=torch.float32, input_ref=None, sigmas_ref=None,
               mask_ref=None, draws=None, prefix_dedupe=None, num_video_frames=None,
               image_only_indicator=None):
    """Denoising forward. x: (B, H, W, Cin) NHWC (already c_in-scaled);
    timesteps: (B,) c_noise; context: (B', 77, context_dim) and y
    (B', adm_in) with the B target rows first, then the B * Nref reference
    rows (sample-major). ref_features: {attn_id: {depth: tokens}} for the
    render; nerf_caches: {attn_id: {depth: rendered}} replacing it; ctx_kv:
    precomputed text K/V. Training: input_ref (B, Nref, H, W, Cin)
    reference latents, run without gradient at timesteps ``sigmas_ref``
    (B,) (zeros when None); mask_ref (B, Nref, Hm, Wm); draws: the
    renders' draws, per pose block under ``nerf/<attn_id>/<depth>/``.
    prefix_dedupe: a per-copy group tuple such as (0, 0, 1) declaring that
    the CFG copies of one group carry identical x and emb rows (the guider's
    ``prefix_copy_groups``): conv_in and the layers before the first
    ``attn`` then run on one copy per group, and the stream and the skip
    tensors expand back at that layer (after the input blocks if they have
    no attention). Ignored when the reference stream runs.
    Video network: num_video_frames T, the batch holding B / T clips of T
    frames each, clip-major, as are context and y; image_only_indicator
    (B / T, T), nonzero on frames whose blends keep the spatial branch
    alone (None: none).
    Returns (eps in x.dtype, aux) with aux = dict(fg_mask_list,
    alphas_list, rgb_list, rendered, ref_tokens), ref_tokens {attn_id: {d:
    (B, Nref, hw, C)}} the reference stream's tokens at the pose blocks."""
    compute_dtype = torch_dtype(compute_dtype)
    b = x.shape[0]
    emb = _mlp2(params["time_embed"], timestep_embedding(timesteps, cfg.model_channels))
    if y is not None:
        emb = emb + _mlp2(params["label_emb"], y[:b])

    hr = embr = contextr = None
    if input_ref is not None:
        n = input_ref.shape[1]
        contextr = context[b:].to(compute_dtype)
        with torch.no_grad():
            tr = sigmas_ref if sigmas_ref is not None else torch.zeros_like(timesteps)
            embr = _mlp2(params["time_embed"], timestep_embedding(tr, cfg.model_channels))
            embr = embr[:, None].expand(b, n, embr.shape[-1]).reshape(b * n, -1)
            if y is not None:
                embr = embr + _mlp2(params["label_emb"], y[b:].reshape(b * n, -1))
        hr = input_ref.reshape((b * n,) + tuple(input_ref.shape[2:])).to(compute_dtype)
    context = context[:b].to(compute_dtype)
    nerf_draws = None if draws is None else draws.child("nerf")

    inb_spec, mid_spec, outb_spec, _ = build_unet_spec(cfg)
    frames = image_only = None
    if isinstance(cfg, VideoUNetConfig):
        frames = int(num_video_frames)
        image_only = (torch.zeros((b,), dtype=torch.bool, device=x.device)
                      if image_only_indicator is None
                      else image_only_indicator.reshape(b).to(x.device).bool())
    h = x.to(compute_dtype)
    fg_mask_list, alphas_list, rgb_list, rendered, ref_tokens = [], [], [], {}, {}

    expand_blocks = None
    emb_full = emb
    if prefix_dedupe is not None and input_ref is None:
        groups = tuple(prefix_dedupe)
        ncopies = len(groups)
        if b % ncopies == 0 and len(set(groups)) < ncopies:
            bb = b // ncopies
            first = {}
            for ci, g in enumerate(groups):
                first.setdefault(g, ci)
            order = sorted(first)
            uniq_blocks = [first[g] for g in order]
            pos = {g: i for i, g in enumerate(order)}
            expand_blocks = [pos[g] for g in groups]
            h = _row_blocks(h, uniq_blocks, bb)
            emb = _row_blocks(emb, uniq_blocks, bb)

    def both(fn, h, hr):
        """fn on the target stream, and without gradient on the reference
        stream."""
        h = fn(h, emb)
        if hr is not None:
            with torch.no_grad():
                hr = fn(hr, embr)
        return h, hr

    def apply_layer(lp, spec, h, hr):
        with span(LAYER_SPANS[spec[0]]):
            return layer(lp, spec, h, hr)

    def layer(lp, spec, h, hr):
        kind = spec[0]
        if kind == "conv_in":
            return both(lambda t, _: conv2d(lp, t), h, hr)
        if kind == "res":
            return both(lambda t, e: _resblock_apply(lp, t, e), h, hr)
        if kind == "vres":
            return _video_resblock_apply(lp, h, emb, frames, image_only), hr
        if kind == "vattn":
            _, ch, depth, attn_id = spec
            return spatial_video_transformer_apply(
                lp, h, context, cfg.transformer_config(ch, depth, attn_id), frames,
                image_only), hr
        if kind == "down":
            return both(lambda t, _: conv2d(lp, t, stride=2, padding=((1, 1), (1, 1))), h, hr)
        if kind == "up":
            return both(lambda t, _: conv2d(lp, upsample_nearest_2x(t)), h, hr)
        if kind == "attn":
            _, ch, depth, attn_id = spec
            h, hr, aux = spatial_transformer_apply(
                lp, h, context, cfg.transformer_config(ch, depth, attn_id),
                cams=cams,
                nerf_cache=None if nerf_caches is None else nerf_caches.get(attn_id),
                ref_features=None if ref_features is None else ref_features.get(attn_id),
                ctx_kv=None if ctx_kv is None else ctx_kv.get(attn_id),
                xr=hr, context_ref=contextr, mask_ref=mask_ref,
                draws=None if nerf_draws is None else nerf_draws.child(str(attn_id)),
            )
            fg_mask_list.extend(aux["fg_masks"])
            alphas_list.extend(aux["alphas"])
            rgb_list.extend(aux["rgbs"])
            if aux["rendered"]:
                rendered[attn_id] = aux["rendered"]
            if aux["ref_tokens"]:
                ref_tokens[attn_id] = aux["ref_tokens"]
            return h, hr
        raise ValueError(kind)

    hs, hrs = [], []
    for lp_block, spec_block in zip(params["input_blocks"], inb_spec):
        for lp, spec in zip(lp_block, spec_block):
            if expand_blocks is not None and spec[0] == "attn":
                h = _row_blocks(h, expand_blocks, bb)
                hs = [_row_blocks(t, expand_blocks, bb) for t in hs]
                emb, expand_blocks = emb_full, None
            h, hr = apply_layer(lp, spec, h, hr)
        hs.append(h)
        hrs.append(hr)
    if expand_blocks is not None:  # no attention in the input blocks
        h = _row_blocks(h, expand_blocks, bb)
        hs = [_row_blocks(t, expand_blocks, bb) for t in hs]
        emb, expand_blocks = emb_full, None
    for lp, spec in zip(params["middle_block"], mid_spec):
        h, hr = apply_layer(lp, spec, h, hr)
    for lp_block, spec_block in zip(params["output_blocks"], outb_spec):
        h = torch.cat([h, hs.pop()], dim=-1)
        skip_r = hrs.pop()
        if hr is not None:
            hr = torch.cat([hr, skip_r], dim=-1)
        for lp, spec in zip(lp_block, spec_block):
            h, hr = apply_layer(lp, spec, h, hr)
    del hr

    out = conv2d(params["out_conv"], group_norm_silu(params["out_norm"], h, eps=1e-5))
    aux = dict(fg_mask_list=fg_mask_list, alphas_list=alphas_list,
               rgb_list=rgb_list, rendered=rendered, ref_tokens=ref_tokens)
    return out.to(x.dtype), aux


def no_time_unet_apply(params, cfg: UNetConfig, x, timesteps, context, y, **kwargs):
    """``unet_apply`` with the timestep conditioning zeroed (the reference's
    NoTimeUNetModel)."""
    return unet_apply(params, cfg, x, torch.zeros_like(timesteps), context, y, **kwargs)
