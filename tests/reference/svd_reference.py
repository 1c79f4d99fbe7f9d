"""A plain PyTorch reference of Stable Video Diffusion image-to-video.

Written from the published modules of Stability AI's ``generative-models``
(sgm) at the settings of ``configs/inference/svd_image_decoder.yaml``:
``sgm/modules/diffusionmodules/video_model.py`` (VideoUNet, VideoResBlock),
``sgm/modules/video_attention.py`` (SpatialVideoTransformer,
VideoTransformerBlock), ``sgm/modules/diffusionmodules/openaimodel.py`` and
``util.py`` (ResBlock, AlphaBlender, timestep_embedding),
``sgm/modules/attention.py`` (CrossAttention, FeedForward,
BasicTransformerBlock, SpatialTransformer), ``sgm/modules/diffusionmodules/
model.py`` (the autoencoder's Encoder and Decoder), ``sgm/modules/encoders/
modules.py`` (GeneralConditioner, FrozenOpenCLIPImageEmbedder,
FrozenOpenCLIPImagePredictionEmbedder, ConcatTimestepEmbedderND,
VideoPredictionEmbedderWithEncoder), open_clip's VisionTransformer (ViT-H/14),
``denoiser.py`` / ``denoiser_scaling.py`` (Denoiser, VScalingWithEDMNoise),
``discretizer.py`` (EDMDiscretization), ``sampling.py`` (EulerEDMSampler),
``guiders.py`` (LinearPredictionGuider), and the sampling script
``scripts/sampling/simple_video_sample.py`` (the batch, the unconditional
zeroing, the repeat over frames, the decode a chunk of frames at a time).

Float32 in the source's layouts: images and latents NCHW, a clip's
activations NCTHW in the temporal res blocks. The modules carry the
published attribute names, so ``SVDReference().state_dict()`` has the keys
of an ``svd_image_decoder.safetensors`` checkpoint. Nothing here imports
the package it is held against.

Departures from the source, none of which changes a number in float32:
- Attention is softmax(q k^T / sqrt(d)) v written out, over blocks of
  queries (``attention``) so that 9216 tokens fit a card; the source calls
  xformers or ``scaled_dot_product_attention``.
- The dropout layers are left out (rate 0 at inference), and so are the
  conditioner autoencoder's decoder and loss, which sampling never runs.
- The MLPs fed a sinusoidal embedding (time_embed, label_emb,
  time_pos_embed) take it in their weights' dtype, the VideoUNet takes its
  input and context in its weights' dtype and returns its output in the
  input's, and GroupNorm32 casts its weights to float32 as it does the
  input: so the same modules also run with bfloat16 weights and a float32
  sampler (where the source relies on autocast).
- kornia's antialiased resize is written out (``kornia_resize``).
- The EDM schedule, the guider's scales and the Euler loop are taken as
  the source computes them (float32), with churn 0 as the script runs it.
"""
from __future__ import annotations

import math
from collections import OrderedDict

import torch
import torch.nn as nn
import torch.nn.functional as F

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

# published widths (svd.yaml / svd_image_decoder.yaml; open_clip ViT-H-14)
UNET = dict(in_channels=8, model_channels=320, out_channels=4, num_res_blocks=2,
            attention_resolutions=(4, 2, 1), channel_mult=(1, 2, 4, 4), num_head_channels=64,
            transformer_depth=1, context_dim=1024, adm_in_channels=768, merge_factor=0.5,
            video_kernel_size=(3, 1, 1))
VAE = dict(ch=128, ch_mult=(1, 2, 4, 4), num_res_blocks=2, z_channels=4, in_channels=3, out_ch=3)
VISION = dict(image_size=224, patch_size=14, width=1280, layers=32, heads=16, mlp_ratio=4,
              output_dim=1024)
CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)
UC_ZERO = ("cond_frames", "cond_frames_without_noise")

BLOCK_ELEMENTS = 1 << 28  # attention logits computed at once


def attention(q, k, v):
    """q (B, H, N, D), k and v (B, H, M, D) -> (B, H, N, D), in blocks of
    queries of at most BLOCK_ELEMENTS logits."""
    b, h, n, d = q.shape
    rows = max(1, BLOCK_ELEMENTS // (b * h * k.shape[2]))
    kt = k.transpose(-1, -2)
    out = [torch.matmul(torch.softmax(torch.matmul(q[:, :, i:i + rows], kt) * d ** -0.5, -1), v)
           for i in range(0, n, rows)]
    return torch.cat(out, dim=2)


def timestep_embedding(timesteps, dim, max_period=10000):
    half = dim // 2
    freqs = torch.exp(-math.log(max_period) * torch.arange(0, half, dtype=torch.float32) / half
                      ).to(device=timesteps.device)
    args = timesteps[:, None].float() * freqs[None]
    emb = torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
    if dim % 2:
        emb = torch.cat([emb, torch.zeros_like(emb[:, :1])], dim=-1)
    return emb


def _mlp_input(seq, x):
    return x.to(seq[0].weight.dtype)


# ---------------------------------------------------------------------------
# the UNet's blocks (openaimodel.py, util.py, video_model.py)
# ---------------------------------------------------------------------------


class GroupNorm32(nn.GroupNorm):
    def forward(self, x):
        return F.group_norm(x.float(), self.num_groups, self.weight.float(), self.bias.float(),
                            self.eps).type(x.dtype)


def normalization(channels):
    return GroupNorm32(32, channels)


class ResBlock(nn.Module):
    def __init__(self, channels, emb_channels, out_channels=None, dims=2, kernel_size=3,
                 exchange_temb_dims=False):
        super().__init__()
        out = out_channels or channels
        self.exchange_temb_dims = exchange_temb_dims
        if isinstance(kernel_size, (tuple, list)):
            padding = [k // 2 for k in kernel_size]
        else:
            padding = kernel_size // 2
        conv = nn.Conv2d if dims == 2 else nn.Conv3d
        self.in_layers = nn.Sequential(normalization(channels), nn.SiLU(),
                                       conv(channels, out, kernel_size, padding=padding))
        self.emb_layers = nn.Sequential(nn.SiLU(), nn.Linear(emb_channels, out))
        self.out_layers = nn.Sequential(normalization(out), nn.SiLU(), nn.Identity(),
                                        conv(out, out, kernel_size, padding=padding))
        self.skip_connection = nn.Identity() if out == channels else conv(channels, out, 1)

    def forward(self, x, emb):
        h = self.in_layers(x)
        emb_out = self.emb_layers(emb).type(h.dtype)
        while len(emb_out.shape) < len(h.shape):
            emb_out = emb_out[..., None]
        if self.exchange_temb_dims:  # b t c ... -> b c t ...
            emb_out = emb_out.transpose(1, 2)
        h = self.out_layers(h + emb_out)
        return self.skip_connection(x) + h


class AlphaBlender(nn.Module):
    """merge_strategy "learned_with_images"."""

    def __init__(self, alpha, per_frame_rows):
        super().__init__()
        self.per_frame_rows = per_frame_rows  # "b t -> (b t) 1 1", else "b t -> b 1 t 1 1"
        self.mix_factor = nn.Parameter(torch.tensor([float(alpha)]))

    def forward(self, x_spatial, x_temporal, image_only_indicator):
        alpha = torch.where(image_only_indicator.bool(),
                            torch.ones(1, 1, device=image_only_indicator.device),
                            torch.sigmoid(self.mix_factor)[..., None])
        b, t = alpha.shape
        alpha = alpha.reshape(b * t, 1, 1) if self.per_frame_rows else alpha.reshape(b, 1, t, 1, 1)
        return (alpha.to(x_spatial.dtype) * x_spatial
                + (1.0 - alpha).to(x_spatial.dtype) * x_temporal)


class VideoResBlock(ResBlock):
    def __init__(self, channels, emb_channels, out_channels=None, video_kernel_size=3,
                 merge_factor=0.5):
        super().__init__(channels, emb_channels, out_channels)
        out = out_channels or channels
        self.time_stack = ResBlock(out, emb_channels, out, dims=3, kernel_size=video_kernel_size,
                                   exchange_temb_dims=True)
        self.time_mixer = AlphaBlender(merge_factor, per_frame_rows=False)

    def forward(self, x, emb, num_video_frames, image_only_indicator):
        x = super().forward(x, emb)
        bt, c, h, w = x.shape
        t = num_video_frames
        x_mix = x.reshape(bt // t, t, c, h, w).transpose(1, 2)  # (b t) c h w -> b c t h w
        x = self.time_stack(x_mix, emb.reshape(bt // t, t, -1))
        x = self.time_mixer(x_mix, x, image_only_indicator)
        return x.transpose(1, 2).reshape(bt, c, h, w)


class Downsample(nn.Module):
    def __init__(self, channels):
        super().__init__()
        self.op = nn.Conv2d(channels, channels, 3, stride=2, padding=1)

    def forward(self, x):
        return self.op(x)


class Upsample(nn.Module):
    def __init__(self, channels):
        super().__init__()
        self.conv = nn.Conv2d(channels, channels, 3, padding=1)

    def forward(self, x):
        return self.conv(F.interpolate(x, scale_factor=2, mode="nearest"))


# ---------------------------------------------------------------------------
# transformers (attention.py, video_attention.py)
# ---------------------------------------------------------------------------


class CrossAttention(nn.Module):
    def __init__(self, query_dim, context_dim=None, heads=8, dim_head=64):
        super().__init__()
        inner = heads * dim_head
        context_dim = context_dim or query_dim
        self.heads = heads
        self.to_q = nn.Linear(query_dim, inner, bias=False)
        self.to_k = nn.Linear(context_dim, inner, bias=False)
        self.to_v = nn.Linear(context_dim, inner, bias=False)
        self.to_out = nn.Sequential(nn.Linear(inner, query_dim))

    def forward(self, x, context=None):
        context = x if context is None else context
        q, k, v = self.to_q(x), self.to_k(context), self.to_v(context)
        b, n, _ = q.shape
        q, k, v = (t.reshape(b, t.shape[1], self.heads, -1).transpose(1, 2) for t in (q, k, v))
        return self.to_out(attention(q, k, v).transpose(1, 2).reshape(b, n, -1))


class GEGLU(nn.Module):
    def __init__(self, dim_in, dim_out):
        super().__init__()
        self.proj = nn.Linear(dim_in, dim_out * 2)

    def forward(self, x):
        x, gate = self.proj(x).chunk(2, dim=-1)
        return x * F.gelu(gate)


class FeedForward(nn.Module):
    def __init__(self, dim, dim_out=None, mult=4):
        super().__init__()
        inner = int(dim * mult)
        self.net = nn.Sequential(GEGLU(dim, inner), nn.Identity(), nn.Linear(inner, dim_out or dim))

    def forward(self, x):
        return self.net(x)


class BasicTransformerBlock(nn.Module):
    def __init__(self, dim, n_heads, d_head, context_dim):
        super().__init__()
        self.attn1 = CrossAttention(dim, heads=n_heads, dim_head=d_head)
        self.ff = FeedForward(dim)
        self.attn2 = CrossAttention(dim, context_dim=context_dim, heads=n_heads, dim_head=d_head)
        self.norm1 = nn.LayerNorm(dim)
        self.norm2 = nn.LayerNorm(dim)
        self.norm3 = nn.LayerNorm(dim)

    def forward(self, x, context):
        x = self.attn1(self.norm1(x)) + x
        x = self.attn2(self.norm2(x), context=context) + x
        return self.ff(self.norm3(x)) + x


class VideoTransformerBlock(nn.Module):
    """ff_in (extra_ff_mix_layer), self-attention over the frames,
    cross-attention to the time context, feed-forward."""

    def __init__(self, dim, n_heads, d_head, context_dim):
        super().__init__()
        self.norm_in = nn.LayerNorm(dim)
        self.ff_in = FeedForward(dim, dim_out=dim)
        self.attn1 = CrossAttention(dim, heads=n_heads, dim_head=d_head)
        self.ff = FeedForward(dim, dim_out=dim)
        self.norm2 = nn.LayerNorm(dim)
        self.attn2 = CrossAttention(dim, context_dim=context_dim, heads=n_heads, dim_head=d_head)
        self.norm1 = nn.LayerNorm(dim)
        self.norm3 = nn.LayerNorm(dim)

    def forward(self, x, context, timesteps):
        bt, s, c = x.shape
        b = bt // timesteps
        x = x.reshape(b, timesteps, s, c).transpose(1, 2).reshape(b * s, timesteps, c)
        x = self.ff_in(self.norm_in(x)) + x
        x = self.attn1(self.norm1(x)) + x
        x = self.attn2(self.norm2(x), context=context) + x
        x = self.ff(self.norm3(x)) + x
        return x.reshape(b, s, timesteps, c).transpose(1, 2).reshape(bt, s, c)


class SpatialTransformer(nn.Module):
    """use_linear, depth blocks on one context."""

    def __init__(self, in_channels, n_heads, d_head, depth, context_dim):
        super().__init__()
        inner = n_heads * d_head
        self.in_channels = in_channels
        self.norm = nn.GroupNorm(32, in_channels, eps=1e-6)
        self.proj_in = nn.Linear(in_channels, inner)
        self.transformer_blocks = nn.ModuleList(
            [BasicTransformerBlock(inner, n_heads, d_head, context_dim) for _ in range(depth)])
        self.proj_out = nn.Linear(inner, in_channels)  # zero_module in the source


class SpatialVideoTransformer(SpatialTransformer):
    """use_spatial_context: the time context is each clip's first frame's
    context; merge_strategy "learned_with_images"."""

    def __init__(self, in_channels, n_heads, d_head, depth, context_dim, merge_factor):
        super().__init__(in_channels, n_heads, d_head, depth, context_dim)
        inner = n_heads * d_head
        self.time_stack = nn.ModuleList(
            [VideoTransformerBlock(inner, n_heads, d_head, context_dim) for _ in range(depth)])
        ted = in_channels * 4
        self.time_pos_embed = nn.Sequential(nn.Linear(in_channels, ted), nn.SiLU(),
                                            nn.Linear(ted, in_channels))
        self.time_mixer = AlphaBlender(merge_factor, per_frame_rows=True)

    def forward(self, x, context, timesteps, image_only_indicator):
        bt, c, h, w = x.shape
        x_in = x
        time_context = context[::timesteps].repeat_interleave(h * w, dim=0)  # b ... -> (b n) ...
        x = self.norm(x).reshape(bt, c, h * w).transpose(1, 2)
        x = self.proj_in(x)
        frames = torch.arange(timesteps, device=x.device).repeat(bt // timesteps)
        t_emb = timestep_embedding(frames, self.in_channels, max_period=10000)
        emb = self.time_pos_embed(_mlp_input(self.time_pos_embed, t_emb))[:, None, :]
        for block, mix_block in zip(self.transformer_blocks, self.time_stack):
            x = block(x, context=context)
            x_mix = mix_block(x + emb, context=time_context, timesteps=timesteps)
            x = self.time_mixer(x, x_mix, image_only_indicator)
        x = self.proj_out(x).transpose(1, 2).reshape(bt, c, h, w)
        return x + x_in


class TimestepEmbedSequential(nn.Sequential):
    def forward(self, x, emb, context, num_video_frames, image_only_indicator):
        for layer in self:
            if isinstance(layer, VideoResBlock):
                x = layer(x, emb, num_video_frames, image_only_indicator)
            elif isinstance(layer, SpatialVideoTransformer):
                x = layer(x, context, num_video_frames, image_only_indicator)
            else:
                x = layer(x)
        return x


class VideoUNet(nn.Module):
    def __init__(self, in_channels, model_channels, out_channels, num_res_blocks,
                 attention_resolutions, channel_mult, num_head_channels, transformer_depth,
                 context_dim, adm_in_channels, merge_factor, video_kernel_size):
        super().__init__()
        if isinstance(transformer_depth, int):
            transformer_depth = [transformer_depth] * len(channel_mult)
        self.model_channels = model_channels
        ted = model_channels * 4
        self.time_embed = nn.Sequential(nn.Linear(model_channels, ted), nn.SiLU(),
                                        nn.Linear(ted, ted))
        self.label_emb = nn.Sequential(nn.Sequential(nn.Linear(adm_in_channels, ted), nn.SiLU(),
                                                     nn.Linear(ted, ted)))

        def res(ch, out):
            return VideoResBlock(ch, ted, out, video_kernel_size, merge_factor)

        def attn(ch, depth):
            return SpatialVideoTransformer(ch, ch // num_head_channels, num_head_channels, depth,
                                           context_dim, merge_factor)

        self.input_blocks = nn.ModuleList(
            [TimestepEmbedSequential(nn.Conv2d(in_channels, model_channels, 3, padding=1))])
        chans, ch, ds = [model_channels], model_channels, 1
        for level, mult in enumerate(channel_mult):
            for _ in range(num_res_blocks):
                layers = [res(ch, mult * model_channels)]
                ch = mult * model_channels
                if ds in attention_resolutions:
                    layers.append(attn(ch, transformer_depth[level]))
                self.input_blocks.append(TimestepEmbedSequential(*layers))
                chans.append(ch)
            if level != len(channel_mult) - 1:
                self.input_blocks.append(TimestepEmbedSequential(Downsample(ch)))
                chans.append(ch)
                ds *= 2
        self.middle_block = TimestepEmbedSequential(res(ch, ch), attn(ch, transformer_depth[-1]),
                                                    res(ch, ch))
        self.output_blocks = nn.ModuleList([])
        for level, mult in list(enumerate(channel_mult))[::-1]:
            for i in range(num_res_blocks + 1):
                layers = [res(ch + chans.pop(), model_channels * mult)]
                ch = model_channels * mult
                if ds in attention_resolutions:
                    layers.append(attn(ch, transformer_depth[level]))
                if level and i == num_res_blocks:
                    layers.append(Upsample(ch))
                    ds //= 2
                self.output_blocks.append(TimestepEmbedSequential(*layers))
        self.out = nn.Sequential(normalization(ch), nn.SiLU(),
                                 nn.Conv2d(model_channels, out_channels, 3, padding=1))

    def forward(self, x, timesteps, context, y, num_video_frames, image_only_indicator):
        dtype = self.out[2].weight.dtype
        t_emb = timestep_embedding(timesteps, self.model_channels)
        emb = self.time_embed(_mlp_input(self.time_embed, t_emb))
        emb = emb + self.label_emb(_mlp_input(self.label_emb[0], y))
        args = (emb, context.to(dtype), num_video_frames, image_only_indicator)
        h, hs = x.to(dtype), []
        for module in self.input_blocks:
            h = module(h, *args)
            hs.append(h)
        h = self.middle_block(h, *args)
        for module in self.output_blocks:
            h = module(torch.cat([h, hs.pop()], dim=1), *args)
        return self.out(h).to(x.dtype)


class OpenAIWrapper(nn.Module):
    def __init__(self, diffusion_model):
        super().__init__()
        self.diffusion_model = diffusion_model

    def forward(self, x, t, c, num_video_frames, image_only_indicator):
        x = torch.cat((x, c["concat"].type_as(x)), dim=1)
        return self.diffusion_model(x, t, c["crossattn"], c["vector"], num_video_frames,
                                    image_only_indicator)


# ---------------------------------------------------------------------------
# the autoencoder (diffusionmodules/model.py; AutoencoderKL)
# ---------------------------------------------------------------------------


def Normalize(channels):
    return nn.GroupNorm(32, channels, eps=1e-6, affine=True)


class ResnetBlock(nn.Module):
    def __init__(self, in_channels, out_channels):
        super().__init__()
        self.norm1 = Normalize(in_channels)
        self.conv1 = nn.Conv2d(in_channels, out_channels, 3, padding=1)
        self.norm2 = Normalize(out_channels)
        self.conv2 = nn.Conv2d(out_channels, out_channels, 3, padding=1)
        if in_channels != out_channels:
            self.nin_shortcut = nn.Conv2d(in_channels, out_channels, 1)

    def forward(self, x):
        h = self.conv1(F.silu(self.norm1(x)))
        h = self.conv2(F.silu(self.norm2(h)))
        if hasattr(self, "nin_shortcut"):
            x = self.nin_shortcut(x)
        return x + h


class AttnBlock(nn.Module):
    def __init__(self, channels):
        super().__init__()
        self.norm = Normalize(channels)
        self.q = nn.Conv2d(channels, channels, 1)
        self.k = nn.Conv2d(channels, channels, 1)
        self.v = nn.Conv2d(channels, channels, 1)
        self.proj_out = nn.Conv2d(channels, channels, 1)

    def forward(self, x):
        h_ = self.norm(x)
        b, c, h, w = x.shape
        q, k, v = (t(h_).reshape(b, 1, c, h * w).transpose(2, 3) for t in (self.q, self.k, self.v))
        h_ = attention(q, k, v).transpose(2, 3).reshape(b, c, h, w)
        return x + self.proj_out(h_)


class _Level(nn.Module):
    pass


class Encoder(nn.Module):
    def __init__(self, ch, ch_mult, num_res_blocks, z_channels, in_channels, **_):
        super().__init__()
        self.conv_in = nn.Conv2d(in_channels, ch, 3, padding=1)
        in_mult = (1,) + tuple(ch_mult)
        self.down = nn.ModuleList()
        for i, mult in enumerate(ch_mult):
            level = _Level()
            block_in = ch * in_mult[i]
            level.block = nn.ModuleList()
            for _ in range(num_res_blocks):
                level.block.append(ResnetBlock(block_in, ch * mult))
                block_in = ch * mult
            if i != len(ch_mult) - 1:
                level.downsample = _Level()
                level.downsample.conv = nn.Conv2d(block_in, block_in, 3, stride=2, padding=0)
            self.down.append(level)
        self.mid = _Level()
        self.mid.block_1 = ResnetBlock(block_in, block_in)
        self.mid.attn_1 = AttnBlock(block_in)
        self.mid.block_2 = ResnetBlock(block_in, block_in)
        self.norm_out = Normalize(block_in)
        self.conv_out = nn.Conv2d(block_in, 2 * z_channels, 3, padding=1)  # double_z

    def forward(self, x):
        h = self.conv_in(x)
        for i, level in enumerate(self.down):
            for blk in level.block:
                h = blk(h)
            if i != len(self.down) - 1:
                h = level.downsample.conv(F.pad(h, (0, 1, 0, 1), mode="constant", value=0))
        h = self.mid.block_2(self.mid.attn_1(self.mid.block_1(h)))
        return self.conv_out(F.silu(self.norm_out(h)))


class Decoder(nn.Module):
    def __init__(self, ch, ch_mult, num_res_blocks, z_channels, out_ch, **_):
        super().__init__()
        block_in = ch * ch_mult[-1]
        self.conv_in = nn.Conv2d(z_channels, block_in, 3, padding=1)
        self.mid = _Level()
        self.mid.block_1 = ResnetBlock(block_in, block_in)
        self.mid.attn_1 = AttnBlock(block_in)
        self.mid.block_2 = ResnetBlock(block_in, block_in)
        up = []
        for i in reversed(range(len(ch_mult))):
            level = _Level()
            level.block = nn.ModuleList()
            for _ in range(num_res_blocks + 1):
                level.block.append(ResnetBlock(block_in, ch * ch_mult[i]))
                block_in = ch * ch_mult[i]
            if i != 0:
                level.upsample = Upsample(block_in)
            up.insert(0, level)
        self.up = nn.ModuleList(up)
        self.norm_out = Normalize(block_in)
        self.conv_out = nn.Conv2d(block_in, out_ch, 3, padding=1)

    def forward(self, z):
        h = self.conv_in(z)
        h = self.mid.block_2(self.mid.attn_1(self.mid.block_1(h)))
        for i in reversed(range(len(self.up))):
            for blk in self.up[i].block:
                h = blk(h)
            if i != 0:
                h = self.up[i].upsample(h)
        return self.conv_out(F.silu(self.norm_out(h)))


class AutoencoderKL(nn.Module):
    def __init__(self, decoder=True, **cfg):
        super().__init__()
        z = cfg["z_channels"]
        self.encoder = Encoder(**cfg)
        self.quant_conv = nn.Conv2d(2 * z, 2 * z, 1)
        if decoder:
            self.decoder = Decoder(**cfg)
            self.post_quant_conv = nn.Conv2d(z, z, 1)

    def encode_mode(self, x):
        """The posterior's mode (AutoencoderKLModeOnly's encode)."""
        return self.quant_conv(self.encoder(x)).chunk(2, dim=1)[0]

    def decode(self, z):
        return self.decoder(self.post_quant_conv(z))


# ---------------------------------------------------------------------------
# the conditioner (encoders/modules.py; open_clip's VisionTransformer)
# ---------------------------------------------------------------------------


def _gaussian(k, sigma, device):
    x = torch.arange(k, dtype=torch.float32, device=device) - k // 2
    g = torch.exp(-x.pow(2.0) / (2 * sigma ** 2))
    return g / g.sum()


def kornia_resize(x, size):
    """kornia.geometry.resize(x, size, interpolation="bicubic",
    align_corners=True, antialias=True) of NCHW x."""
    h, w = x.shape[-2:]
    if (h, w) == tuple(size):
        return x
    factors = (h / size[0], w / size[1])
    if max(factors) > 1:
        sigmas = (max((factors[0] - 1.0) / 2.0, 0.001), max((factors[1] - 1.0) / 2.0, 0.001))
        ks = [int(max(2.0 * 2 * s, 3)) for s in sigmas]
        ks = [k + 1 if k % 2 == 0 else k for k in ks]
        c = x.shape[1]
        kx = _gaussian(ks[1], sigmas[1], x.device)[None, None, None, :].expand(c, 1, 1, -1)
        ky = _gaussian(ks[0], sigmas[0], x.device)[None, None, :, None].expand(c, 1, -1, 1)
        x = F.conv2d(F.pad(x, (ks[1] // 2, ks[1] // 2, 0, 0), mode="reflect"), kx, groups=c)
        x = F.conv2d(F.pad(x, (0, 0, ks[0] // 2, ks[0] // 2), mode="reflect"), ky, groups=c)
    return F.interpolate(x, size=tuple(size), mode="bicubic", align_corners=True)


class LayerNorm(nn.LayerNorm):
    def forward(self, x):
        return F.layer_norm(x, self.normalized_shape, self.weight, self.bias, self.eps).to(x.dtype)


class MultiheadAttention(nn.Module):
    """nn.MultiheadAttention's parameters (packed in_proj), self-attention."""

    def __init__(self, width, heads):
        super().__init__()
        self.heads = heads
        self.in_proj_weight = nn.Parameter(torch.empty(3 * width, width))
        self.in_proj_bias = nn.Parameter(torch.empty(3 * width))
        self.out_proj = nn.Linear(width, width)

    def forward(self, x):
        b, n, d = x.shape
        q, k, v = F.linear(x, self.in_proj_weight, self.in_proj_bias).chunk(3, dim=-1)
        q, k, v = (t.reshape(b, n, self.heads, -1).transpose(1, 2) for t in (q, k, v))
        return self.out_proj(attention(q, k, v).transpose(1, 2).reshape(b, n, d))


class ResidualAttentionBlock(nn.Module):
    def __init__(self, width, heads, mlp_ratio):
        super().__init__()
        self.ln_1 = LayerNorm(width)
        self.attn = MultiheadAttention(width, heads)
        self.ln_2 = LayerNorm(width)
        self.mlp = nn.Sequential(OrderedDict([("c_fc", nn.Linear(width, width * mlp_ratio)),
                                              ("gelu", nn.GELU()),
                                              ("c_proj", nn.Linear(width * mlp_ratio, width))]))

    def forward(self, x):
        x = x + self.attn(self.ln_1(x))
        return x + self.mlp(self.ln_2(x))


class VisionTransformer(nn.Module):
    def __init__(self, image_size, patch_size, width, layers, heads, mlp_ratio, output_dim):
        super().__init__()
        grid = image_size // patch_size
        self.conv1 = nn.Conv2d(3, width, patch_size, stride=patch_size, bias=False)
        self.class_embedding = nn.Parameter(torch.empty(width))
        self.positional_embedding = nn.Parameter(torch.empty(grid * grid + 1, width))
        self.ln_pre = LayerNorm(width)
        self.transformer = _Level()
        self.transformer.resblocks = nn.ModuleList(
            [ResidualAttentionBlock(width, heads, mlp_ratio) for _ in range(layers)])
        self.ln_post = LayerNorm(width)
        self.proj = nn.Parameter(torch.empty(width, output_dim))

    def forward(self, x):
        x = self.conv1(x)
        x = x.reshape(x.shape[0], x.shape[1], -1).permute(0, 2, 1)
        cls = self.class_embedding.to(x.dtype).expand(x.shape[0], 1, -1)
        x = torch.cat([cls, x], dim=1) + self.positional_embedding.to(x.dtype)
        x = self.ln_pre(x)
        for blk in self.transformer.resblocks:
            x = blk(x)
        return self.ln_post(x[:, 0]) @ self.proj


class FrozenOpenCLIPImageEmbedder(nn.Module):
    def __init__(self, vision):
        super().__init__()
        self.model = _Level()
        self.model.visual = VisionTransformer(**vision)
        self.image_size = vision["image_size"]

    def forward(self, image):
        x = kornia_resize(image, (self.image_size, self.image_size))
        x = (x + 1.0) / 2.0
        mean = torch.tensor(CLIP_MEAN, device=x.device)[:, None, None]
        std = torch.tensor(CLIP_STD, device=x.device)[:, None, None]
        x = (x - mean) / std
        return self.model.visual(x.to(self.model.visual.proj.dtype)).to(image.dtype)


class FrozenOpenCLIPImagePredictionEmbedder(nn.Module):
    def __init__(self, vision, n_cond_frames=1, n_copies=1):
        super().__init__()
        self.n_cond_frames, self.n_copies = n_cond_frames, n_copies
        self.open_clip = FrozenOpenCLIPImageEmbedder(vision)

    def forward(self, vid):
        vid = self.open_clip(vid)
        vid = vid.reshape(-1, self.n_cond_frames, vid.shape[-1])
        return vid.repeat_interleave(self.n_copies, dim=0)


class ConcatTimestepEmbedderND(nn.Module):
    def __init__(self, outdim):
        super().__init__()
        self.outdim = outdim

    def forward(self, x):
        if x.ndim == 1:
            x = x[:, None]
        b, dims = x.shape
        emb = timestep_embedding(x.reshape(-1), self.outdim)
        return emb.reshape(b, dims * self.outdim)


class VideoPredictionEmbedderWithEncoder(nn.Module):
    """is_ae, scale_factor 1 (svd.yaml sets none), no sigma sampler."""

    def __init__(self, vae, n_cond_frames=1, n_copies=1):
        super().__init__()
        self.n_cond_frames, self.n_copies = n_cond_frames, n_copies
        self.encoder = AutoencoderKL(decoder=False, **vae)

    def forward(self, vid):
        vid = self.encoder.encode_mode(vid.to(self.encoder.quant_conv.weight.dtype))
        bt, c, h, w = vid.shape
        vid = vid.reshape(bt // self.n_cond_frames, self.n_cond_frames * c, h, w)
        return vid.repeat_interleave(self.n_copies, dim=0)


class GeneralConditioner(nn.Module):
    OUTPUT_DIM2KEYS = {2: "vector", 3: "crossattn", 4: "concat", 5: "concat"}
    KEY2CATDIM = {"vector": 1, "crossattn": 2, "concat": 1}
    INPUT_KEYS = ("cond_frames_without_noise", "fps_id", "motion_bucket_id", "cond_frames",
                  "cond_aug")

    def __init__(self, vision, vae, outdim=256):
        super().__init__()
        self.embedders = nn.ModuleList([
            FrozenOpenCLIPImagePredictionEmbedder(vision), ConcatTimestepEmbedderND(outdim),
            ConcatTimestepEmbedderND(outdim), VideoPredictionEmbedderWithEncoder(vae),
            ConcatTimestepEmbedderND(outdim)])

    def forward(self, batch, force_zero_embeddings=()):
        output = {}
        for key, embedder in zip(self.INPUT_KEYS, self.embedders):
            emb = embedder(batch[key])
            out_key = self.OUTPUT_DIM2KEYS[emb.dim()]
            if key in force_zero_embeddings:
                emb = torch.zeros_like(emb)
            if out_key in output:
                output[out_key] = torch.cat((output[out_key], emb), self.KEY2CATDIM[out_key])
            else:
                output[out_key] = emb
        return output

    def get_unconditional_conditioning(self, batch_c, batch_uc=None, force_uc_zero_embeddings=()):
        c = self(batch_c)
        uc = self(batch_c if batch_uc is None else batch_uc, force_uc_zero_embeddings)
        return c, uc


# ---------------------------------------------------------------------------
# denoising and sampling
# ---------------------------------------------------------------------------


def v_scaling_with_edm_noise(sigma):
    c_skip = 1.0 / (sigma ** 2 + 1.0)
    c_out = -sigma / (sigma ** 2 + 1.0) ** 0.5
    c_in = 1.0 / (sigma ** 2 + 1.0) ** 0.5
    c_noise = 0.25 * sigma.log()
    return c_skip, c_out, c_in, c_noise


def append_dims(x, ndim):
    return x[(...,) + (None,) * (ndim - x.ndim)]


def edm_sigmas(n, sigma_min=0.002, sigma_max=700.0, rho=7.0, device="cpu"):
    ramp = torch.linspace(0, 1, n, device=device)
    min_inv_rho = sigma_min ** (1 / rho)
    max_inv_rho = sigma_max ** (1 / rho)
    sigmas = (max_inv_rho + ramp * (min_inv_rho - max_inv_rho)) ** rho
    return torch.cat([sigmas, sigmas.new_zeros([1])])


class LinearPredictionGuider:
    def __init__(self, max_scale, num_frames, min_scale=1.0):
        self.num_frames = num_frames
        self.scale = torch.linspace(min_scale, max_scale, num_frames).unsqueeze(0)

    def __call__(self, x, sigma):
        x_u, x_c = x.chunk(2)
        t = self.num_frames
        x_u = x_u.reshape((-1, t) + tuple(x_u.shape[1:]))
        x_c = x_c.reshape((-1, t) + tuple(x_c.shape[1:]))
        scale = append_dims(self.scale.repeat(x_u.shape[0], 1), x_u.ndim).to(x_u.device)
        out = x_u + scale * (x_c - x_u)
        return out.reshape((-1,) + tuple(out.shape[2:]))

    def prepare_inputs(self, x, s, c, uc):
        c_out = {k: torch.cat((uc[k], c[k]), 0) for k in c}
        return torch.cat([x] * 2), torch.cat([s] * 2), c_out


class SVDReference(nn.Module):
    """The DiffusionEngine of svd_image_decoder.yaml: ``model`` (the
    VideoUNet in its OpenAIWrapper), ``conditioner``, ``first_stage_model``;
    ``scale_factor`` 0.18215."""

    def __init__(self, unet=UNET, vae=VAE, vision=VISION, outdim=256, scale_factor=0.18215):
        super().__init__()
        self.model = OpenAIWrapper(VideoUNet(**unet))
        self.conditioner = GeneralConditioner(vision, vae, outdim)
        self.first_stage_model = AutoencoderKL(**vae)
        self.scale_factor = scale_factor

    def denoiser(self, x, sigma, c, num_video_frames, image_only_indicator):
        """Denoiser with VScalingWithEDMNoise (no quantization)."""
        sigma_shape = sigma.shape
        sigma = append_dims(sigma, x.ndim)
        c_skip, c_out, c_in, c_noise = v_scaling_with_edm_noise(sigma)
        out = self.model(x * c_in, c_noise.reshape(sigma_shape), c, num_video_frames,
                         image_only_indicator)
        return out * c_out + x * c_skip

    def guided_denoise(self, guider, x, sigma, c, uc, num_video_frames):
        """The sampler's denoise: both guider copies in one batch, combined."""
        xb, sb, cb = guider.prepare_inputs(x, sigma, c, uc)
        indicator = torch.zeros(2 * x.shape[0] // num_video_frames, num_video_frames,
                                device=x.device)
        return guider(self.denoiser(xb, sb, cb, num_video_frames, indicator), sigma)

    def sample(self, c, uc, noise, num_steps, guider, num_video_frames, sigma_max=700.0,
               callback=None):
        """EulerEDMSampler over EDMDiscretization(sigma_max), churn 0.
        ``callback(i, x, sigma, denoised)`` sees each step's input."""
        sigmas = edm_sigmas(num_steps, sigma_max=sigma_max, device=noise.device)
        x = noise * torch.sqrt(1.0 + sigmas[0] ** 2.0)
        s_in = x.new_ones([x.shape[0]])
        for i in range(num_steps):
            sigma_hat = s_in * sigmas[i]
            denoised = self.guided_denoise(guider, x, sigma_hat, c, uc, num_video_frames)
            if callback is not None:
                callback(i, x, sigma_hat, denoised)
            d = (x - denoised) / append_dims(sigma_hat, x.ndim)
            x = x + append_dims(s_in * sigmas[i + 1] - sigma_hat, x.ndim) * d
        return x

    def decode_first_stage(self, z, decoding_t=14):
        z = z / self.scale_factor
        return torch.cat([self.first_stage_model.decode(z[i:i + decoding_t])
                          for i in range(0, z.shape[0], decoding_t)])


def video_batch(image, cond_noise, num_frames, fps_id, motion_bucket_id, cond_aug):
    """simple_video_sample.py's batch for one clip: image (1, 3, H, W) in
    [-1, 1] and the standard normal draws of its conditioning noise."""
    n = num_frames
    return {"cond_frames_without_noise": image, "cond_frames": image + cond_aug * cond_noise,
            "fps_id": torch.tensor([fps_id], device=image.device).repeat(n),
            "motion_bucket_id": torch.tensor([motion_bucket_id], device=image.device).repeat(n),
            "cond_aug": torch.tensor([cond_aug], device=image.device).repeat(n)}


def conditioning(ref: SVDReference, batch, num_frames):
    """(c, uc) as the sampling script makes them: uc with crossattn and
    concat zeroed, both repeated over the frames."""
    c, uc = ref.conditioner.get_unconditional_conditioning(
        batch, batch_uc=batch, force_uc_zero_embeddings=UC_ZERO)
    for k in ("crossattn", "concat"):
        uc[k] = uc[k].repeat_interleave(num_frames, dim=0)
        c[k] = c[k].repeat_interleave(num_frames, dim=0)
    return c, uc
