"""Classifier-free-guidance guiders (port of custom_diffusion360_tpu/
diffusion/guiders.py): ``prepare(x, sigma, c, uc)`` batches the copies and
``combine(denoised, sigma)`` mixes them. For the ImgRef guiders each of
"crossattn"/"vector" holds the B target rows first, then reference rows.
The x3 ``scheduled_cfg_img_text_ref`` is not ported yet."""
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
