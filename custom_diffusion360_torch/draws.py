"""The random draws of one training step.

The JAX package splits PRNG keys; torch cannot reproduce those streams. So
every draw of the training path has a name, and a ``Draws`` object either
takes it from ``given`` (a dict of tensors: a test hands both packages the
same numbers) or draws it from a ``torch.Generator``. Names used:

  engine:  vae_eps, vae_eps_ref              standard normal, latent shapes
           (vae_eps also the autoencoder trainer's posterior)
  regularizers: gumbel                       standard Gumbel, the logits' shape
           remap_idx                         ints in [0, len(used)), index shape
  loss:    sigma_idx, sigma_ref_idx          int grid indices, (B,)
           noise, noise_ref, noise_ref2      standard normal
  NeRF, under the prefix ``nerf/<attn_id>/<depth>/``:
           ray_x, ray_y (res + 1,)           patch-ray jitter
           strat (B, hw, S + 1)              stratified-length jitter
           imp (B, hw, S)                    importance-sampling jitter
           coin ()                           stratified-vs-importance coin

Under data parallelism (``shard=(rank, world)``) each rank draws the
batch-row draws (``ROW_DRAWS``) at the global batch's size from the same
seeded generator and keeps its own rows, so N ranks of b rows take the
draws that one process takes for the N * b rows concatenated in rank
order; the shared draws (ray_x, ray_y, coin) are the same on every rank.
"""
from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

# draws whose leading axis runs over the batch rows (B, or B * N sample-major)
ROW_DRAWS = frozenset({"vae_eps", "vae_eps_ref", "sigma_idx", "sigma_ref_idx", "noise",
                       "noise_ref", "noise_ref2", "strat", "imp", "diag_noise"})


class Draws:
    def __init__(self, gen: Optional[torch.Generator] = None, given: Optional[dict] = None,
                 prefix: str = "", shard: Optional[Tuple[int, int]] = None):
        self.gen = gen
        self.given = {} if given is None else given
        self.prefix = prefix
        self.shard = shard

    def child(self, name: str) -> "Draws":
        """The same source under ``<prefix><name>/``."""
        return Draws(self.gen, self.given, f"{self.prefix}{name}/", self.shard)

    def take(self, name: str, shape, device, make: Callable):
        """The given tensor ``name`` (checked against ``shape``), else
        ``make(shape, gen, gen_device)`` moved to ``device``."""
        key = self.prefix + name
        if key in self.given:
            got = torch.as_tensor(self.given[key])
            if tuple(got.shape) != tuple(shape):
                raise ValueError(f"draw {key!r} has shape {tuple(got.shape)}, "
                                 f"expected {tuple(shape)}")
            return got.to(device)
        if self.gen is None:
            raise ValueError(f"draw {key!r} was not given and there is no generator")
        if self.shard is not None and name in ROW_DRAWS:
            r, n = self.shard
            rows = shape[0]
            full = make((rows * n,) + tuple(shape[1:]), self.gen, self.gen.device)
            return full[r * rows:(r + 1) * rows].to(device)
        return make(tuple(shape), self.gen, self.gen.device).to(device)

    def uniform(self, name, shape, device):
        return self.take(name, shape, device,
                         lambda s, g, d: torch.rand(s, generator=g, device=d))

    def normal(self, name, shape, device):
        return self.take(name, shape, device,
                         lambda s, g, d: torch.randn(s, generator=g, device=d))
