"""Classifier-free-guidance guiders (port of custom_diffusion360_tpu/
diffusion/guiders.py): ``prepare(x, sigma, c, uc)`` batches the copies and
``combine(denoised, sigma)`` mixes them. For the ImgRef guiders each of
"crossattn"/"vector" holds the B target rows first, then reference rows."""
from __future__ import annotations

import dataclasses

import torch

_COND_KEYS = ("vector", "crossattn", "concat")


@dataclasses.dataclass(frozen=True)
class identity_guider:
    def prepare(self, x, s, c, uc):
        return x, s, c

    def combine(self, x, sigma):
        return x

    @property
    def num_copies(self):
        return 1


@dataclasses.dataclass(frozen=True)
class vanilla_cfg:
    """[uc | c] doubling."""

    scale: float = 7.5

    def prepare(self, x, s, c, uc):
        c_out = {k: torch.cat([uc[k], c[k]]) if k in _COND_KEYS else c[k] for k in c}
        return torch.cat([x, x]), torch.cat([s, s]), c_out

    def combine(self, x, sigma):
        x_u, x_c = x.chunk(2)
        return x_u + self.scale * (x_c - x_u)

    @property
    def num_copies(self):
        return 2


@dataclasses.dataclass(frozen=True)
class vanilla_cfg_img_ref:
    """Target/ref-aware CFG doubling: [uc_tgt, c_tgt, uc_ref, c_ref]."""

    scale: float = 7.5

    def prepare(self, x, s, c, uc):
        b = x.shape[0]
        c_out = {}
        for k in c:
            if k in _COND_KEYS:
                c_out[k] = torch.cat([uc[k][:b], c[k][:b], uc[k][b:], c[k][b:]])
            else:
                c_out[k] = c[k]
        return torch.cat([x, x]), torch.cat([s, s]), c_out

    def combine(self, x, sigma):
        x_u, x_c = x.chunk(2)
        return x_u + self.scale * (x_c - x_u)

    @property
    def num_copies(self):
        return 2


@dataclasses.dataclass(frozen=True)
class scheduled_cfg_img_text_ref:
    """InstructPix2Pix-style image + text guidance,
    x_u + scale (x_c - x_ic) + scale_im (x_ic - x_u); batch layout
    [uc1, uc1, c1 | uc2, c2, c2] (uc1/c1 the target rows, uc2/c2 the rest)."""

    scale: float = 7.5
    scale_im: float = 3.5

    def prepare(self, x, s, c, uc):
        b = x.shape[0]
        c_out = {}
        for k in c:
            if k in _COND_KEYS:
                uc1, uc2 = uc[k][:b], uc[k][b:]
                c1, c2 = c[k][:b], c[k][b:]
                c_out[k] = torch.cat([uc1, uc1, c1, uc2, c2, c2])
            else:
                c_out[k] = c[k]
        return torch.cat([x, x, x]), torch.cat([s, s, s]), c_out

    def combine(self, x, sigma):
        x_u, x_ic, x_c = x.chunk(3)
        return x_u + self.scale * (x_c - x_ic) + self.scale_im * (x_ic - x_u)

    @property
    def num_copies(self):
        return 3

    @property
    def prefix_copy_groups(self):
        """Copies 0 and 1 are identical up to the first pose block by
        construction (``prepare`` gives both the ``uc`` rows and the same x
        and sigma), so the UNet may run that prefix on the two unique
        copies and expand (models/unet.py ``prefix_dedupe``)."""
        return (0, 0, 1)


@dataclasses.dataclass(frozen=True)
class linear_prediction_guider:
    """[uc | c] doubling with a per-frame scale ramped linearly from
    ``min_scale`` to ``max_scale`` over ``num_frames`` (video-style); the
    batch holds B // num_frames clips of num_frames frames each."""

    max_scale: float
    num_frames: int
    min_scale: float = 1.0

    def prepare(self, x, s, c, uc):
        c_out = {k: torch.cat([uc[k], c[k]]) if k in _COND_KEYS else c[k] for k in c}
        return torch.cat([x, x]), torch.cat([s, s]), c_out

    def combine(self, x, sigma):
        x_u, x_c = x.chunk(2)
        t = self.num_frames
        scale = torch.linspace(self.min_scale, self.max_scale, t, dtype=torch.float32,
                               device=x.device).repeat(x_u.shape[0] // t)
        scale = scale.reshape((-1,) + (1,) * (x_u.dim() - 1)).to(x_u.dtype)
        return x_u + scale * (x_c - x_u)

    @property
    def num_copies(self):
        return 2
