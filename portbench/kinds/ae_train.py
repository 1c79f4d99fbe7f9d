"""Autoencoder training traffic (``"kind": "ae_train"``): one job's closed
loop of ``AEEngine.train_step`` calls (both optimizer sub-steps: the
autoencoder against L1 + LPIPS, KL and the adaptive-weight generator
loss, then the PatchGAN against the hinge loss) on ``batch`` images of
``resolution``^2 in bfloat16, every log value read on the host each step.
``batches`` distinct seeded batches are made in set-up and cycled; each
step's posterior draw comes from a generator seeded by (seed, step).

Set-up builds the state once and runs the first three steps through the
same call on batches 0, 1, 2 (the warm-up); the window goes on with that
same state. After the window, one more step runs through the same call
on the warm state (the late step), from a snapshot of every trainable
leaf and of both optimizers' moments. The check: the f32 reference
(``cd360ref``) from the same weights, on the same images (as f32) and the
same draws, follows the three set-up steps and replays the late step from
the snapshot. Compared: each step's reconstruction and discriminator
losses, the late step's too (``loss``, relative gap); the decoder by
itself on the first step's latent (``decode``); every leaf's change over
the three steps (``change``, the worst leaf's gap of norms against the
reference's norm of that leaf or of the median leaf); and the
discriminator's stage by itself (``disc_stage_diff``): its first gradient
as Adam got it against the reference's on the same images and on the
reconstruction that the step made, the worst leaf's norm of the
difference, which sees a loss taken over part of the batch (BatchNorm's
statistics and the means move). Also read, not compared: the same as a
gap of norms (``disc_stage``), the reconstructions (``recon``), both
sides' first gradients (``grad_ae``, ``grad_disc``; ``*_diff``: norms of
differences), every leaf's update as the norm of the difference of the
updates (``update``, ``late_update``) and the discriminator's mean logit
on the real images (``disc_real``)."""
from __future__ import annotations

import contextlib
import copy
import statistics

import torch

from harness import compare, inputs, models, precision, training, weights

# the forward's losses: the reconstruction (L1 + LPIPS) and the discriminator's
# hinge loss; the total loss also carries the adaptive weight, a ratio of
# two gradient norms (``d_weight``, compared apart)
LOSSES = ("train/rec_loss", "train/disc_loss")


@contextlib.contextmanager
def recording_decodes(ae_engine_module, out: list):
    """Within: each (latent, reconstruction) the step decodes is noted in
    ``out``."""
    orig = ae_engine_module.vae_decode

    def decode(params, z, *args, **kwargs):
        y = orig(params, z, *args, **kwargs)
        out.append((z.detach().clone(), y.detach().clone()))
        return y

    ae_engine_module.vae_decode = decode
    try:
        yield
    finally:
        ae_engine_module.vae_decode = orig


def rel_gap(got: dict, want: dict, key: str) -> float:
    return abs(got[key] - want[key]) / abs(want[key])


def worst(gaps: dict, names: list, top: int = 3) -> list:
    """The ``top`` leaves of largest gap: [name, gap]."""
    return [[names[i], gaps[i]] for i in sorted(gaps, key=lambda i: -gaps[i])[:top]]


def _init_fn(ref, cfg):
    return lambda: ref.ae_engine.init_ae_engine(cfg, 0, "cpu")


class Job:
    metric, scale, trace_units = "ae_step_ms", 1e3, 2

    def __init__(self, cell):
        self.cell = cell
        mix, model, dev = cell.traffic, cell.config, cell.device
        self.mix, self.dev = mix, dev
        self.port = models.package(models.PORT)
        self.ref = models.package(models.REFERENCE)
        self.cfg = models.ae_config(self.port, model)
        self.ref_cfg = models.ae_config(self.ref, model)
        self.dtype = getattr(torch, model["dtype"])
        self.params = weights.make(_init_fn(self.ref, self.ref_cfg), cell.seed, dev,
                                   torch.float32)
        self.images = [inputs.ae_images(cell.seed, k, mix, dev, self.dtype)
                       for k in range(mix["batches"])]
        self.eng = self.port.ae_engine.AEEngine(self.cfg, device=dev)
        self.state = self.eng.init_state(self.params)
        self.step = 0
        self.draws, self.logs = [], []
        sides = self._sides(self.state)
        self.names = {side: [f"{side}/{name}" for name in weights.paths(self.state.params[side])]
                      for side in sides}
        self.before = [leaf.detach().clone() for leaf in sides["ae"] + sides["disc"]]
        self.recons = []
        for _ in range(training.STEPS):
            record = {}
            with recording_decodes(self.port.ae_engine, self.recons):
                self.logs.append(self._step(record))
            self.draws.append(record)
            if self.step == 1:
                self.grads = {side: training.first_moments(
                    [self.state.opt_ae, self.state.opt_disc], leaves, 0.9)
                    for side, leaves in sides.items()}
        self.after = [leaf.detach().clone() for leaf in sides["ae"] + sides["disc"]]
        self.late = None

    def _sides(self, state):
        leaves = self.port.trainer.tree_leaves
        return {side: list(leaves(state.params[side])) for side in ("ae", "disc")}

    def unit(self, i):
        """One step on the next batch; every log value is read on the host."""
        self._step()

    def _step(self, record=None) -> dict:
        gen = inputs.torch_gen(self.cell.seed, 11, self.step, device=self.dev)
        draws = (self.port.draws.Draws(gen) if record is None
                 else training.recording_draws(self.port.draws.Draws, gen, record))
        self.state, logs = self.eng.train_step(
            self.state, self.images[self.step % len(self.images)], draws)
        self.step += 1
        return dict(zip(logs, torch.stack([v.float() for v in logs.values()]).tolist()))

    def _late_step(self):
        """One more step on the warm state, from a snapshot of it that the
        reference replays: every trainable leaf, both optimizers' state
        dicts (as a user checkpoints them) and the step's draws."""
        if self.late is None:
            sides = self._sides(self.state)
            leaves = sides["ae"] + sides["disc"]
            late = {"k": self.step, "before": [leaf.detach().clone() for leaf in leaves],
                    "opt": [copy.deepcopy(opt.state_dict())
                            for opt in (self.state.opt_ae, self.state.opt_disc)],
                    "state_step": self.state.step, "draws": {}}
            late["logs"] = self._step(late["draws"])
            late["after"] = [leaf.detach().clone() for leaf in leaves]
            self.late = late
        return self.late

    def spans(self):
        return {}

    def _program_steps(self):
        late = self._late_step()
        return self.logs, self.grads, self.after, self.recons, late["logs"], late["after"]

    def check(self):
        values = self.compare(*self._program_steps())
        return compare.limits_checks(values, self.cell.workload["limits"])

    def _reference_steps(self, fp8=False):
        R = self.ref
        eng = R.ae_engine.AEEngine(self.ref_cfg, device=self.dev)
        state = eng.init_state(weights.to_float(self.params))
        sides = {side: list(R.trainer.tree_leaves(state.params[side])) for side in ("ae", "disc")}
        logs, grads, recons = [], None, []
        for k in range(training.STEPS):
            x = self.images[k % len(self.images)]
            x = x if fp8 else x.float()  # the control computes in the images' dtype
            with (precision.Fp8Products() if fp8 else contextlib.nullcontext(),
                  recording_decodes(R.ae_engine, recons)):
                state, out = eng.train_step(state, x, R.draws.Draws(given=self.draws[k]))
            logs.append({key: float(v) for key, v in out.items()})
            if k == 0:
                grads = {side: training.first_moments([state.opt_ae, state.opt_disc], leaves,
                                                      0.9) for side, leaves in sides.items()}
        return logs, grads, [leaf.detach().clone() for leaf in sides["ae"] + sides["disc"]], recons

    def _reference_late(self, fp8=False):
        """The late step replayed from the program's snapshot: the leaves,
        both optimizers' moments and step counts, and the step's draws."""
        R, late = self.ref, self.late
        eng = R.ae_engine.AEEngine(self.ref_cfg, device=self.dev)
        state = eng.init_state(weights.to_float(self.params))
        leaves = [leaf for side in ("ae", "disc") for leaf in R.trainer.tree_leaves(state.params[side])]
        with torch.no_grad():
            for leaf, value in zip(leaves, late["before"]):
                leaf.copy_(value)
        for opt, saved in zip((state.opt_ae, state.opt_disc), late["opt"]):
            # the moments and step counts only: lr, betas and eps stay the reference's own
            opt.load_state_dict({"state": saved["state"],
                                 "param_groups": opt.state_dict()["param_groups"]})
        state.step = late["state_step"]
        x = self.images[late["k"] % len(self.images)]
        with precision.Fp8Products() if fp8 else contextlib.nullcontext():
            _, out = eng.train_step(state, x if fp8 else x.float(), R.draws.Draws(given=late["draws"]))
        return {key: float(v) for key, v in out.items()}, [leaf.detach().clone() for leaf in leaves]

    def readings(self):
        """The program's numbers on the first steps (run in set-up)."""
        return self.compare(*self._program_steps())

    @torch.no_grad()
    def _decode_gap(self, first):
        """The decoder by itself: the reference's f32 decode, with the first
        step's weights, of the latent the step decoded, against the
        reconstruction it made."""
        z, y = first
        ae = weights.to_float(self.params)["ae"]
        want = self.ref.vae.vae_decode(ae, z.float(), self.ref_cfg.vae)
        return compare.rel(y.float(), want)

    def _disc_stage(self, first, disc_grads) -> dict:
        """The discriminator's stage by itself: the reference's f32 gradient
        of the first step's discriminator loss at the first weights, on the
        step's images and the reconstruction that the step decoded, against
        each discriminator leaf's first gradient as its Adam got it.
        Leaves whose reference gradient is nought to rounding (the conv
        biases under BatchNorm) are left out by the rule of ``training``."""
        R = self.ref
        disc = R.trainer.tree_map(lambda t: t.detach().float().clone().requires_grad_(True),
                                  weights.to_float(self.params)["disc"])
        leaves = list(R.trainer.tree_leaves(disc))
        d, _ = R.ae_engine.disc_loss(disc, self.images[0].float(), first[1].float(), 0,
                                     self.ref_cfg)
        want = torch.autograd.grad(d, leaves, allow_unused=True, materialize_grads=True)
        wn, gn = compare.norms(want), compare.norms(disc_grads)
        keep = training.quiet_leaves(wn)
        diff = compare.diff_gaps(disc_grads, want, wn, keep)
        return {"disc_stage": compare.worst_leaf_gap(gn, wn, keep),
                "disc_stage_median": compare.median_leaf_gap(gn, wn, keep),
                "disc_stage_diff": max(diff.values()),
                "disc_stage_diff_median": statistics.median(diff.values())}

    def free_program(self):
        for name in ("state", "eng"):
            self.__dict__.pop(name, None)
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()

    def compare(self, logs, grads, after, recons, late_logs, late_after):
        self.free_program()
        r_logs, r_grads, r_after, r_recons = self._reference_steps()
        r_late_logs, r_late_after = self._reference_late()
        gr = {side: compare.norms(g) for side, g in r_grads.items()}
        keep = training.quiet_leaves(gr["ae"]) + training.quiet_leaves(gr["disc"])
        gp = {side: compare.norms(g) for side, g in grads.items()}
        stage = self._disc_stage(recons[0], grads["disc"])
        g_diff = {side: compare.diff_gaps(grads[side], r_grads[side], gr[side])
                  for side in grads}
        del r_grads
        dp = training.changes(self.before, after)
        dr = training.changes(self.before, r_after)
        update = compare.diff_gaps(after, r_after, dr, keep)
        late_dr = training.changes(self.late["before"], r_late_after)
        late_update = compare.diff_gaps(late_after, r_late_after, late_dr, keep)
        names = self.names["ae"] + self.names["disc"]
        logs, r_logs = logs + [late_logs], r_logs + [r_late_logs]
        shown = LOSSES + ("train/d_weight",)
        self.diagnostics = {
            "grad_ae": training.worst_leaves(gp["ae"], gr["ae"], self.names["ae"]),
            "grad_disc": training.worst_leaves(gp["disc"], gr["disc"], self.names["disc"]),
            "change": training.worst_leaves(dp, dr, names, keep),
            "update": worst(update, names),
            "late_update": worst(late_update, names),
            "left_out": sum(not k for k in keep),
            "logs": [[{k: got[k] for k in shown}, {k: want[k] for k in shown}]
                     for got, want in zip(logs, r_logs)]}
        return {
            "loss": max(rel_gap(got, want, k) for got, want in zip(logs, r_logs) for k in LOSSES),
            "late_loss": max(rel_gap(logs[-1], r_logs[-1], k) for k in LOSSES),
            "recon": max(compare.rel(got[1].float(), want[1]) for got, want in zip(recons, r_recons)),
            "decode": self._decode_gap(recons[0]),
            "disc_real": max(rel_gap(got, want, "train/logits_real")
                             for got, want in zip(logs, r_logs)),
            "d_weight": max(rel_gap(got, want, "train/d_weight") for got, want in zip(logs, r_logs)),
            "total_loss": max(rel_gap(got, want, "train/total_loss")
                              for got, want in zip(logs, r_logs)),
            "grad_ae": compare.worst_leaf_gap(gp["ae"], gr["ae"]),
            "grad_ae_median": compare.median_leaf_gap(gp["ae"], gr["ae"]),
            "grad_ae_diff": max(g_diff["ae"].values()),
            "grad_ae_diff_median": statistics.median(g_diff["ae"].values()),
            "grad_disc": compare.worst_leaf_gap(gp["disc"], gr["disc"]),
            "grad_disc_median": compare.median_leaf_gap(gp["disc"], gr["disc"]),
            "grad_disc_diff": max(g_diff["disc"].values()),
            "grad_disc_diff_median": statistics.median(g_diff["disc"].values()),
            "change": compare.worst_leaf_gap(dp, dr, keep),
            "change_median": compare.median_leaf_gap(dp, dr, keep),
            "update": max(update.values()),
            "update_median": statistics.median(update.values()),
            "late_update": max(late_update.values()),
            "late_update_median": statistics.median(late_update.values()),
            **stage,
        }

    def control(self):
        """The control's readings: the reference in the program's dtype (the
        images') with every product's operands in float8 e4m3, in the
        program's place."""
        self.free_program()
        return self.compare(*self._reference_steps(fp8=True), *self._reference_late(fp8=True))

    def model_flops(self):
        """Operations of one step, counted on the reference over meta tensors:
        both sub-steps' forwards and backwards (the adaptive weight's two
        gradients at the decoder's last kernel included)."""
        from torch.utils.flop_counter import FlopCounterMode

        R, meta = self.ref, torch.device("meta")
        tree, _ = weights.meta_tree(_init_fn(R, self.ref_cfg), torch.float32)
        eng = R.ae_engine.AEEngine(self.ref_cfg, device=meta)
        state = eng.init_state(tree)
        x = torch.empty(tuple(self.images[0].shape), device=meta)
        draws = R.draws.Draws(given={k: v.to(meta) for k, v in self.draws[0].items()})
        with FlopCounterMode(display=False) as fc:
            eng.train_step(state, x, draws)
        return fc.get_total_flops()
