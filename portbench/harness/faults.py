"""Faults planted in the program under the timed path: a step that leaves
its state unchanged, half of the batch left out (the means over the
rest), an answer altered where it is produced. The benchmark's tests see
``correct`` come out false under each; ``calibrate.py --fault`` reads
what each gives at a cell's own size.

Each fault takes ``setattr(obj, name, value)`` (pytest's
``monkeypatch.setattr``, or a ``Patches``) and patches the port."""
from __future__ import annotations


class Patches:
    """``setattr`` that remembers, and ``undo``."""

    def __init__(self):
        self.saved = []

    def setattr(self, obj, name, value):
        self.saved.append((obj, name, getattr(obj, name)))
        setattr(obj, name, value)

    def undo(self):
        while self.saved:
            obj, name, value = self.saved.pop()
            setattr(obj, name, value)


def unchanged_step(setattr):
    """The sampler's first step after the render returns its latent
    unchanged (a step near sigma 0 moves the latent by less than bf16
    rounding does)."""
    import custom_diffusion360_torch.engine as engine

    orig = engine.euler_edm_sample
    setattr(engine, "euler_edm_sample",
            lambda denoise, x, sigmas, cfg, **kw: orig(denoise, x, sigmas[1:], cfg, **kw))


def altered_image(setattr):
    from custom_diffusion360_torch.engine import Engine

    orig = Engine.decode_first_stage
    setattr(Engine, "decode_first_stage", lambda self, params, z: orig(self, params, z) * 0.9)


def altered_latent(setattr):
    from custom_diffusion360_torch.engine import Engine

    orig = Engine.sample
    setattr(Engine, "sample", lambda self, *a, **k: orig(self, *a, **k) * 1.05)


def frozen_trainer(setattr):
    """Every training step leaves the trainable leaves as they were (lr 0)."""
    from custom_diffusion360_torch.train.trainer import Trainer

    orig = Trainer.train_step

    def step(self, state, batch, draws):
        for group in state.optimizer.param_groups:
            group["base_lr"] = 0.0
        return orig(self, state, batch, draws)

    setattr(Trainer, "train_step", step)


def altered_loss(setattr):
    from custom_diffusion360_torch.train.trainer import Trainer

    orig = Trainer.train_step

    def step(self, state, batch, draws):
        state, metrics = orig(self, state, batch, draws)
        return state, dict(metrics, loss=metrics["loss"] * 1.5)

    setattr(Trainer, "train_step", step)


def frozen_ae(setattr):
    """Every autoencoder step leaves both sides' leaves as they were."""
    from custom_diffusion360_torch.train.ae_engine import AEEngine

    orig = AEEngine.train_step

    def step(self, state, x, draws):
        for opt in (state.opt_ae, state.opt_disc):
            for group in opt.param_groups:
                group["lr"] = 0.0
        return orig(self, state, x, draws)

    setattr(AEEngine, "train_step", step)


def half_batch(setattr):
    """Half of the images left out of the losses, the means taken over the
    rest: the reconstruction loss (L1 + LPIPS) and the discriminator's loss
    see the first half of the batch; every shape stays as it was."""
    import custom_diffusion360_torch.train.ae_engine as ae_engine

    rec_nll, d_loss = ae_engine._rec_nll, ae_engine.disc_loss

    def half(t):
        return t[: len(t) // 2]

    setattr(ae_engine, "_rec_nll",
            lambda ae, lpips, x, xrec, cfg: rec_nll(ae, lpips, half(x), half(xrec), cfg))
    setattr(ae_engine, "disc_loss",
            lambda disc, x, xrec, step, cfg: d_loss(disc, half(x), half(xrec), step, cfg))


def altered_logs(setattr):
    """The reconstruction loss reported 5 % high."""
    from custom_diffusion360_torch.train.ae_engine import AEEngine

    orig = AEEngine.train_step

    def step(self, state, x, draws):
        state, logs = orig(self, state, x, draws)
        return state, dict(logs, **{"train/rec_loss": logs["train/rec_loss"] * 1.05})

    setattr(AEEngine, "train_step", step)


BY_KIND = {
    "sample": (unchanged_step, altered_image, altered_latent),
    "train": (frozen_trainer, altered_loss),
    "ae_train": (frozen_ae, half_batch, altered_logs),
}
