"""Training traffic (``"kind": "train"``): one fine-tuning job's closed loop
of ``Trainer.train_step`` calls through ``Engine.training_loss``, at batch
1 with a target and ``views`` reference images, the trainable set of
``trainkeys`` under AdamW, the loss read on the host each step as a user
logs it. ``items`` distinct seeded items in the form of the training
batch are made in set-up and cycled; each step's random draws (noise,
sigmas, the NeRF's ray jitter) come from a generator seeded by (seed,
step).

Set-up builds the trainer state once and runs the first three steps
through the same call on items 0, 1, 2 (the warm-up); the window goes on
with that same state. The check: the f32 reference (``cd360ref``) from the
same weights, on the same items and the same draws (recorded as the
program took them), follows those three steps: each step's loss
(``loss``, relative gap), the first gradient of every trainable leaf as
the optimizer got it (``grad``), and every leaf's change over the three
steps (``change``), both as the worst leaf's gap of norms against the
reference's norm of that leaf or of the median leaf."""
from __future__ import annotations

import contextlib

import torch

from harness import compare, inputs, models, precision, training, weights


class Job:
    metric, scale, trace_units = "train_step_ms", 1e3, 2

    def __init__(self, cell):
        self.cell = cell
        mix, model, dev = cell.traffic, cell.config, cell.device
        self.mix, self.dev = mix, dev
        self.port = models.package(models.PORT)
        self.ref = models.package(models.REFERENCE)
        run = {"nerf_dtype": mix["nerf_dtype"], "nerf_chunk_size": mix["nerf_chunk"]}
        self.cfg = models.engine_config(self.port, model, model["dtype"], run)
        self.ref_cfg = models.engine_config(self.ref, model, "float32",
                                            dict(run, nerf_dtype="float32"))
        self.dtype = self.cfg.dtype
        vocab = self.cfg.conditioner.clip_l.vocab_size
        context = self.cfg.conditioner.clip_l.context_length
        self.params = weights.make(models.engine_init(self.ref, self.ref_cfg, self.dtype), cell.seed, dev,
                                   self.dtype)
        self.items = [inputs.train_item(cell.seed, k, mix, vocab, dev, context)
                      for k in range(mix["items"])]
        self.eng = self.port.engine.Engine(self.cfg, device=dev)
        self.trainer = self.port.trainer.Trainer(
            self.eng, self.port.trainer.TrainConfig(**mix["optimizer"]))
        self.state = self.trainer.init_state(self.params)
        self.step = 0
        self.draws, self.losses = [], []
        leaves = self.trainer.trainable(self.state)
        self.names = [name for name, lab in zip(
            weights.paths(self.state.params), self.port.trainer.tree_leaves(self.trainer.labels))
            if lab != "frozen"]
        self.before = [leaf.detach().clone() for leaf in leaves]
        for _ in range(training.STEPS):
            self.unit(self.step)
            if self.step == 1:
                self.grads = training.first_moments([self.state.optimizer], leaves,
                                                    mix["optimizer"].get("b1", 0.9))
        self.after = [leaf.detach().clone() for leaf in leaves]

    def batch(self, pkg, k):
        item = dict(self.items[k % len(self.items)])
        item["cams"] = models.cameras(pkg, item.pop("rot"), item.pop("trans"), self.dev)
        return item

    def unit(self, i):
        """One step on the next item; the loss is read on the host."""
        record = {} if self.step < training.STEPS else None
        gen = inputs.torch_gen(self.cell.seed, 10, self.step, device=self.dev)
        draws = (self.port.draws.Draws(gen) if record is None
                 else training.recording_draws(self.port.draws.Draws, gen, record))
        self.state, metrics = self.trainer.train_step(self.state, self.batch(self.port, self.step),
                                                      draws)
        loss = float(metrics["loss"])
        if record is not None:
            self.draws.append(record)
            self.losses.append(loss)
        self.step += 1

    def spans(self):
        return {}

    def _program_steps(self):
        return self.losses, self.grads, self.after

    def check(self):
        values = self.compare(*self._program_steps())
        return compare.limits_checks(values, self.cell.workload["limits"])

    def _reference_steps(self, fp8=False):
        """(losses, first gradients, leaves after the steps) of the reference
        on the program's items and draws; with ``fp8`` the control: the
        reference in the program's dtypes with every product's operands in
        float8 e4m3."""
        R = self.ref
        cfg, params = self.ref_cfg, weights.to_float(self.params)
        if fp8:
            cfg = models.engine_config(self.ref, self.cell.config, self.cell.config["dtype"],
                                       {"nerf_dtype": self.mix["nerf_dtype"],
                                        "nerf_chunk_size": self.mix["nerf_chunk"]})
            params = self.params
        reng = R.engine.Engine(cfg, device=self.dev)
        trainer = R.trainer.Trainer(reng, R.trainer.TrainConfig(**self.mix["optimizer"]))
        state = trainer.init_state(params)
        leaves = trainer.trainable(state)
        losses, grads = [], None
        for k in range(training.STEPS):
            draws = R.draws.Draws(given=self.draws[k])
            with precision.Fp8Products() if fp8 else contextlib.nullcontext():
                state, metrics = trainer.train_step(state, self.batch(R, k), draws)
            losses.append(float(metrics["loss"]))
            if k == 0:
                grads = training.first_moments([state.optimizer], leaves,
                                               self.mix["optimizer"].get("b1", 0.9))
        return losses, grads, [leaf.detach().clone() for leaf in leaves]

    def readings(self):
        """The program's numbers on the first steps (run in set-up)."""
        return self.compare(*self._program_steps())

    def free_program(self):
        for name in ("state", "trainer", "eng"):
            self.__dict__.pop(name, None)
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()

    def compare(self, losses, grads, after):
        self.free_program()
        r_losses, r_grads, r_after = self._reference_steps()
        gr = compare.norms(r_grads)
        del r_grads
        keep = training.quiet_leaves(gr)
        gp = compare.norms(grads)
        dp = training.changes(self.before, after)
        dr = training.changes(self.before, r_after)
        self.diagnostics = {"grad": training.worst_leaves(gp, gr, self.names),
                            "change": training.worst_leaves(dp, dr, self.names, keep),
                            "left_out": sum(not k for k in keep)}
        return {
            "loss": max(abs(a - b) / abs(b) for a, b in zip(losses, r_losses)),
            "grad": compare.worst_leaf_gap(gp, gr),
            "grad_median": compare.median_leaf_gap(gp, gr),
            "change": compare.worst_leaf_gap(dp, dr, keep),
            "change_median": compare.median_leaf_gap(dp, dr, keep),
        }

    def control(self):
        """The control's readings: the reference in the program's dtypes
        with every product's operands in float8 e4m3, in the program's
        place."""
        self.free_program()
        return self.compare(*self._reference_steps(fp8=True))

    def model_flops(self):
        """Operations of one step, counted on the reference over meta tensors:
        the training loss's forward and the backward to the trainable set."""
        from torch.utils.flop_counter import FlopCounterMode

        R, meta = self.ref, torch.device("meta")
        tree, _ = weights.meta_tree(models.engine_init(R, self.ref_cfg, torch.float32), torch.float32)
        labels = R.trainer.label_params(tree, self.mix["optimizer"].get("trainkeys", "pose"))
        tree = R.trainer.tree_map(
            lambda lab, t: t.requires_grad_(True) if lab != "frozen" else t, labels, tree)
        reng = R.engine.Engine(self.ref_cfg, device=meta)
        batch = {k: v.to(meta) if torch.is_tensor(v) else v for k, v in self.batch(R, 0).items()}
        batch["cams"] = type(batch["cams"])(*(f.to(meta) for f in batch["cams"]))
        draws = _MetaDraws(R.draws.Draws)()
        with FlopCounterMode(display=False) as fc:
            loss, _ = reng.training_loss(tree, batch, 0, draws)
            loss.backward()
        return fc.get_total_flops()


def _MetaDraws(draws_cls):
    class MetaDraws(draws_cls):
        """Draws of a count over meta tensors: each made on the meta device
        (shapes only), but the scalar ones (the NeRF's coin between
        stratified and importance sampling, which a branch reads) are 0.5 on
        the host: importance sampling, whose work is the same."""

        def child(self, name):
            return MetaDraws(prefix=f"{self.prefix}{name}/")

        def take(self, name, shape, device, make):
            if tuple(shape) == ():
                return torch.tensor(0.5)
            return make(tuple(shape), None, torch.device("meta"))

    return MetaDraws
