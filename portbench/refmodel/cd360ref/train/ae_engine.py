"""Adversarial autoencoder trainer (port of custom_diffusion360_tpu/train/
ae_engine.py): the two-optimizer step of the reference's AutoencodingEngine
with the taming ``LPIPSWithDiscriminator`` loss.

``AEEngine.train_step`` runs both optimizer sub-steps on one batch, as
Lightning sweeps optimizer_idx 0 and 1: first the autoencoder (encoder,
decoder, quant convs and the loss-owned ``logvar``) against the
reconstruction NLL (pixel L1 + LPIPS over the learnable logvar), the KL and
the adaptive-weight generator loss, with the discriminator frozen; then the
PatchGAN discriminator against the hinge or vanilla d-loss on the real
images and the detached reconstructions. ``disc_start`` gates both GAN
terms on the step count. Each side has its own ``torch.optim.Adam`` (the AE
at ``lr_g_factor * lr``, the discriminator at ``lr``: optax.adam's eps and
bias correction). Parameters are float32 masters cast to the input's dtype
at each use, as in the JAX package; the losses are taken in float32.

The adaptive weight is the ratio of the NLL's and the generator loss's
gradient norms at the decoder's last kernel (``decoder.conv_out.w``). JAX
takes it from a second decode and two vjp pullbacks; here it is two
``torch.autograd.grad`` calls on the step's own graph: the same value
without the second decode, detached as under JAX's stop_gradient.

The posterior's standard-normal draws are the draw "vae_eps" of a
``draws.Draws`` (the latent's shape).
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from .. import resolve_device
from ..models.discriminator import (
    discriminator_apply,
    hinge_d_loss,
    init_discriminator_params,
    vanilla_d_loss,
)
from ..models.lpips import init_lpips_params, lpips_apply
from ..models.nn import Init
from ..models.regularizers import diagonal_gaussian_regularizer
from ..models.vae import VAEConfig, init_vae_params, vae_decode, vae_encode
from .trainer import tree_leaves, tree_map


@dataclasses.dataclass(frozen=True)
class AEEngineConfig:
    """AutoencodingEngine's knobs and the taming loss's; the AE optimizer
    runs at ``lr_g_factor * lr``, the discriminator's at ``lr``."""

    vae: VAEConfig = VAEConfig()
    lr: float = 4.5e-6
    lr_g_factor: float = 1.0
    kl_weight: float = 1e-6
    pixel_weight: float = 1.0
    perceptual_weight: float = 1.0
    disc_weight: float = 0.5
    disc_factor: float = 1.0
    disc_start: int = 0
    disc_loss: str = "hinge"  # or "vanilla"
    disc_n_layers: int = 3
    disc_ndf: int = 64
    use_actnorm: bool = False
    logvar_init: float = 0.0
    # LPIPS needs 3-channel inputs; off for toy channel counts
    use_lpips: bool = True


def init_ae_engine(cfg: AEEngineConfig = AEEngineConfig(), seed: int = 0, device="cuda"):
    """Seeded random f32 parameters {"ae", "disc", "lpips"}: the VAE with the
    scalar ``logvar``, the PatchGAN, and the LPIPS weights (None without
    LPIPS)."""
    dev = resolve_device(device)
    ae = dict(init_vae_params(cfg.vae, seed, dev))
    ae["logvar"] = torch.full((), float(cfg.logvar_init), device=dev)
    disc = init_discriminator_params(Init(seed + 1, dev), input_nc=cfg.vae.out_ch,
                                     ndf=cfg.disc_ndf, n_layers=cfg.disc_n_layers,
                                     use_actnorm=cfg.use_actnorm)
    lpips = init_lpips_params(Init(seed + 2, dev)) if cfg.use_lpips else None
    return {"ae": ae, "disc": disc, "lpips": lpips}


def ae_forward(ae_params, x, draws, cfg: AEEngineConfig):
    """Encode, sample the KL posterior with the draw "vae_eps", decode ->
    (z, xrec, {"kl_loss"})."""
    z, reg_log = diagonal_gaussian_regularizer(vae_encode(ae_params, x, cfg.vae), draws)
    return z, vae_decode(ae_params, z, cfg.vae), reg_log


def _rec_nll(ae_params, lpips_params, x, xrec, cfg: AEEngineConfig):
    """(mean NLL, mean reconstruction loss): pixel L1 + LPIPS, scaled by the
    learnable logvar (rec / exp(logvar) + logvar), in f32."""
    rec = cfg.pixel_weight * (x.float() - xrec.float()).abs()
    if cfg.use_lpips and cfg.perceptual_weight > 0 and lpips_params is not None:
        p = lpips_apply(lpips_params, xrec, x)
        rec = rec + cfg.perceptual_weight * p.reshape(-1, 1, 1, 1)
    logvar = ae_params["logvar"]
    nll = rec / torch.exp(logvar) + logvar
    return nll.mean(), rec.mean()


def _adaptive_weight(nll, g_loss, w_last, cfg: AEEngineConfig):
    """Taming's ``calculate_adaptive_weight``: ||dnll/dw_last|| /
    (||dg/dw_last|| + 1e-4), clipped to [0, 1e4], times disc_weight,
    detached. The graph is kept for the step's own backward."""
    (g_nll,) = torch.autograd.grad(nll, w_last, retain_graph=True)
    (g_g,) = torch.autograd.grad(g_loss, w_last, retain_graph=True)
    d_weight = torch.linalg.vector_norm(g_nll) / (torch.linalg.vector_norm(g_g) + 1e-4)
    return (d_weight.clamp(0.0, 1e4) * cfg.disc_weight).detach()


def _disc_factor(step: int, cfg: AEEngineConfig) -> float:
    return cfg.disc_factor if step >= cfg.disc_start else 0.0


def ae_loss(ae_params, disc_params, lpips_params, x, draws, step: int, cfg: AEEngineConfig):
    """The autoencoder's loss (optimizer_idx 0): NLL + kl_weight * KL +
    d_weight * disc_factor * generator loss -> (loss, (xrec, logs))."""
    _, xrec, reg_log = ae_forward(ae_params, x, draws, cfg)
    nll, rec = _rec_nll(ae_params, lpips_params, x, xrec, cfg)
    kl = reg_log["kl_loss"]
    logits_fake = discriminator_apply(disc_params, xrec, n_layers=cfg.disc_n_layers,
                                      use_actnorm=cfg.use_actnorm)
    g_loss = -logits_fake.float().mean()
    d_weight = _adaptive_weight(nll, g_loss, ae_params["decoder"]["conv_out"]["w"], cfg)
    loss = nll + cfg.kl_weight * kl + d_weight * _disc_factor(step, cfg) * g_loss
    logs = {"train/total_loss": loss, "train/rec_loss": rec, "train/nll_loss": nll,
            "train/kl_loss": kl, "train/g_loss": g_loss, "train/d_weight": d_weight,
            "train/logvar": ae_params["logvar"].detach().clone()}  # before the update
    return loss, (xrec, logs)


def disc_loss(disc_params, x, xrec, step: int, cfg: AEEngineConfig):
    """The discriminator's loss (optimizer_idx 1) on the real images and the
    detached reconstructions, each through its own call (BatchNorm takes
    each batch's statistics) -> (d, logs)."""
    logits_real = discriminator_apply(disc_params, x, n_layers=cfg.disc_n_layers,
                                      use_actnorm=cfg.use_actnorm).float()
    logits_fake = discriminator_apply(disc_params, xrec.detach(), n_layers=cfg.disc_n_layers,
                                      use_actnorm=cfg.use_actnorm).float()
    fn = hinge_d_loss if cfg.disc_loss == "hinge" else vanilla_d_loss
    d = _disc_factor(step, cfg) * fn(logits_real, logits_fake)
    return d, {"train/disc_loss": d, "train/logits_real": logits_real.mean(),
               "train/logits_fake": logits_fake.mean()}


@dataclasses.dataclass
class AEEngineState:
    """params {"ae", "disc", "lpips"} (AE and discriminator leaves f32,
    requiring grad; updated in place); the two optimizers; step, the count
    of train_step calls."""

    params: Any
    opt_ae: torch.optim.Optimizer
    opt_disc: torch.optim.Optimizer
    step: int


def _grads_into(loss, leaves):
    """Set each leaf's .grad to d loss / d leaf (zeros where it does not
    reach the leaf)."""
    grads = torch.autograd.grad(loss, leaves, allow_unused=True, materialize_grads=True)
    for leaf, g in zip(leaves, grads):
        leaf.grad = g


class AEEngine:
    """The two-optimizer trainer on one device."""

    def __init__(self, cfg: AEEngineConfig = AEEngineConfig(), device="cuda"):
        self.cfg = cfg
        self.device = resolve_device(device)

    def init_state(self, params) -> AEEngineState:
        """State around ``params`` (from ``init_ae_engine``, the loaders or
        ``io.from_jax``): the AE and discriminator leaves become f32 copies
        on the device that require grad; LPIPS stays frozen."""
        def trainable(leaf):
            return leaf.detach().to(self.device, torch.float32).clone().requires_grad_(True)

        ae = tree_map(trainable, params["ae"])
        disc = tree_map(trainable, params["disc"])
        lpips = params.get("lpips")
        if lpips is not None:
            lpips = tree_map(lambda t: t.detach().to(self.device), lpips)
        cfg = self.cfg
        return AEEngineState(
            params={"ae": ae, "disc": disc, "lpips": lpips},
            opt_ae=torch.optim.Adam(list(tree_leaves(ae)), lr=cfg.lr_g_factor * cfg.lr),
            opt_disc=torch.optim.Adam(list(tree_leaves(disc)), lr=cfg.lr),
            step=0,
        )

    def train_step(self, state: AEEngineState, x, draws):
        """Both optimizer sub-steps on the images x (B, H, W, 3) in [-1, 1],
        computed in x.dtype; the parameters are updated in place. Returns
        (the next state, logs as detached tensors)."""
        cfg = self.cfg
        params = state.params
        x = x.to(self.device)
        ae_leaves = list(tree_leaves(params["ae"]))
        loss, (xrec, logs) = ae_loss(params["ae"], params["disc"], params["lpips"], x, draws,
                                     state.step, cfg)
        _grads_into(loss, ae_leaves)
        state.opt_ae.step()
        state.opt_ae.zero_grad(set_to_none=True)

        d, logs_d = disc_loss(params["disc"], x, xrec, state.step, cfg)
        _grads_into(d, list(tree_leaves(params["disc"])))
        state.opt_disc.step()
        state.opt_disc.zero_grad(set_to_none=True)
        logs.update(logs_d)
        return (dataclasses.replace(state, step=state.step + 1),
                {k: v.detach() for k, v in logs.items()})

    def validation_step(self, state: AEEngineState, x, draws, postfix=""):
        """Both losses on x, no update; keys ``val{postfix}/...``."""
        cfg = self.cfg
        params = state.params
        x = x.to(self.device)
        with torch.enable_grad():  # the adaptive weight takes two gradients
            _, (xrec, logs) = ae_loss(params["ae"], params["disc"], params["lpips"], x, draws,
                                      state.step, cfg)
        with torch.no_grad():
            _, logs_d = disc_loss(params["disc"], x, xrec, state.step, cfg)
        return {k.replace("train/", f"val{postfix}/"): v.detach()
                for k, v in {**logs, **logs_d}.items()}
