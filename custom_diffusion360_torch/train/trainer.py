"""Optimizer and training step (port of custom_diffusion360_tpu/train/
trainer.py).

Every parameter leaf gets a label (``label_params``):

  'train'   pose_emb_layers / pose_featurenerf leaves and the V* modifier
            rows (AdamW at lr);
  'lowlr'   with trainkeys='poseattn' the attn1/attn2 of pose blocks, with
            'all' every other UNet leaf (AdamW at multiplier * lr);
  'frozen'  everything else: no gradient, no optimizer state.

``Trainer.init_state`` makes the trainable leaves float32 tensors that
require grad (the frozen leaves keep their dtype and never require grad)
and builds one ``torch.optim.AdamW`` with a group per trainable label.
AdamW's decoupled decay matches optax.adamw; a trainable leaf that got no
gradient gets a zero one, so it decays as optax would decay it.

The options follow the JAX optimizer chain (``make_optimizer``):

* ``max_grad_norm``: optax.clip_by_global_norm inside each label's chain,
  so the norm is taken over the 'train' leaves and, apart, over the
  'lowlr' leaves; a group over the limit is scaled by limit / norm;
* ``accumulate_grad_batches`` = k: optax.MultiSteps. Every call adds its
  gradient to a running mean; every k-th call clips that mean, applies one
  AdamW update (weight decay included) and clears it. The parameters do
  not move in between. ``TrainState.step`` counts calls;
* ``lr_schedule``: each group's lr is base x schedule(n) for its n-th
  applied update (n from 0), set at the start of the call that applies it.

Data parallelism (``Trainer(data_group=...)``, a process group, e.g.
``torch.distributed.group.WORLD``): right after the backward the trainable
gradients are replaced by their mean over the group's ranks, one flat
all-reduce per optimizer group, before ``grad_norm``, the MultiSteps mean
and the clipping, which all see the global gradient as in the JAX package:
the gradient of the global batch's mean loss when every rank has the same
number of rows (the fg / bg / rgb terms are divided by the mean of the
ranks' counts of items that kept their references, ``Engine.training_loss
(data_group=)``). The loss terms in the metrics are averaged over the ranks
too. Every rank must call ``train_step`` the same number of times.

Under a profiler a step runs inside the span ``cd360.train.step``, its
phases inside ``cd360.train.forward`` (the loss), ``cd360.train.backward``
and ``cd360.train.update`` (the all-reduce, norms, accumulation, clipping
and ``optimizer.step()``).

On a CUDA card without data parallelism or accumulation
(``train_graphs.engages``) the AdamW is built capturable, each group's lr a
0-d tensor on the card, and the steps after the first replay CUDA graphs of
the whole step (``train/train_graphs.py``, ``Trainer.graphs``).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple, Optional

import torch

from ..utils.trace import span, spanned
from .train_graphs import TrainGraphs, engages


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    lr: float = 1e-4
    multiplier: float = 0.05  # low-lr group factor
    trainkeys: str = "pose"  # pose | poseattn | all
    weight_decay: float = 0.01
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    accumulate_grad_batches: int = 1
    max_grad_norm: Optional[float] = None
    # lr multiplier as a function of the applied-update count
    # (train/lr_schedule.py); None: constant lr
    lr_schedule: Optional[Callable[[int], float]] = None


def tree_map(fn, *trees):
    """fn over the leaves of nested dicts / lists with one structure."""
    t0 = trees[0]
    if isinstance(t0, dict):
        return {k: tree_map(fn, *(t[k] for t in trees)) for k in t0}
    if isinstance(t0, (list, tuple)):
        return [tree_map(fn, *xs) for xs in zip(*trees)]
    return fn(*trees)


def tree_leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from tree_leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from tree_leaves(v)
    else:
        yield tree


def _label_tree(node, trainkeys: str, label: str):
    if isinstance(node, dict):
        has_pose = "pose_emb_layers" in node
        out = {}
        for k, v in node.items():
            if k in ("pose_emb_layers", "pose_featurenerf"):
                out[k] = tree_map(lambda _: "train", v)
            elif k == "modifier_rows":
                out[k] = "train"
            elif has_pose and k in ("attn1", "attn2") and trainkeys == "poseattn":
                out[k] = tree_map(lambda _: "lowlr", v)
            else:
                out[k] = _label_tree(v, trainkeys, label)
        return out
    if isinstance(node, (list, tuple)):
        return [_label_tree(v, trainkeys, label) for v in node]
    return label


def label_params(params: dict, trainkeys: str = "pose"):
    """Label tree ('train' / 'lowlr' / 'frozen') of the full {unet, vae,
    conditioner} params."""
    if trainkeys not in ("pose", "poseattn", "all"):
        raise ValueError(f"trainkeys={trainkeys!r}")
    default = "lowlr" if trainkeys == "all" else "frozen"
    return {top: _label_tree(sub, trainkeys, default if top == "unet" else "frozen")
            for top, sub in params.items()}


def trainable_mask(params: dict, trainkeys: str = "pose"):
    return tree_map(lambda lab: lab != "frozen", label_params(params, trainkeys))


class TrainState(NamedTuple):
    """params: the tree (trainable leaves f32, requiring grad); step: the
    count of train_step calls; accum: {"mini_step", "applied", "grads"}, the
    calls since the last update, the updates applied, and the running mean
    of the gradients under accumulation (grads None until the first call)."""

    params: Any
    optimizer: torch.optim.Optimizer
    step: int
    accum: dict


class Trainer:
    """One optimizer step around an Engine's training loss."""

    def __init__(self, engine, cfg: TrainConfig = TrainConfig(), data_group=None):
        self.engine = engine
        self.cfg = cfg
        self.data_group = data_group
        self.labels = None
        self.graphs = TrainGraphs()

    def init_state(self, params) -> TrainState:
        cfg = self.cfg
        self.labels = label_params(params, cfg.trainkeys)

        def prepare(lab, leaf):
            if lab == "frozen":
                return leaf.detach()
            return leaf.detach().float().clone().requires_grad_(True)

        params = tree_map(prepare, self.labels, params)
        groups = {"train": [], "lowlr": []}
        for lab, leaf in zip(tree_leaves(self.labels), tree_leaves(params)):
            if lab != "frozen":
                groups[lab].append(leaf)
        lrs = {"train": cfg.lr, "lowlr": cfg.lr * cfg.multiplier}
        dev = self.engine.device
        capturable = engages(dev, self.data_group, cfg.accumulate_grad_batches)

        def lr(value):  # a capturable AdamW reads a tensor lr, which a replay sees change
            return torch.tensor(value, dtype=torch.float32, device=dev) if capturable else value

        opt = torch.optim.AdamW(
            [{"params": ps, "lr": lr(lrs[lab]), "base_lr": lrs[lab], "label": lab}
             for lab, ps in groups.items() if ps],
            betas=(cfg.b1, cfg.b2), eps=cfg.eps, weight_decay=cfg.weight_decay,
            capturable=capturable,
        )
        return TrainState(params, opt, 0, {"mini_step": 0, "applied": 0, "grads": None})

    def trainable(self, state: TrainState):
        return [leaf for lab, leaf in zip(tree_leaves(self.labels), tree_leaves(state.params))
                if lab != "frozen"]

    @spanned("cd360.train.step")
    def train_step(self, state: TrainState, batch, draws):
        """Forward, backward and, on an update call, one AdamW update of the
        trainable leaves (in place). Returns (the next state, metrics): the
        loss terms and ``grad_norm``, the global L2 norm of this call's
        trainable gradients, as detached tensors. On the card it runs
        through ``self.graphs``."""
        self._set_lrs(state)
        if self.engine.device.type != "cuda":
            return self._step(state, batch, draws)
        return self.graphs.step(self, state, batch, draws)

    def _set_lrs(self, state: TrainState):
        """Each group's lr for the update that this call may apply: written
        into its tensor where it has one on its parameters' device."""
        sched = self.cfg.lr_schedule
        for group in state.optimizer.param_groups:
            value = group["base_lr"] * (
                1.0 if sched is None else float(sched(state.accum["applied"])))
            lr, dev = group["lr"], group["params"][0].device
            if isinstance(lr, torch.Tensor) and lr.device == dev:
                lr.fill_(value)
            elif group.get("capturable"):  # e.g. a tensor restored onto the host
                group["lr"] = torch.tensor(value, dtype=torch.float32, device=dev)
                self.graphs.clear()
            else:
                group["lr"] = value

    def _step(self, state: TrainState, batch, draws):
        opt = state.optimizer
        opt.zero_grad(set_to_none=True)
        with span("cd360.train.forward"):
            loss, metrics = self.engine.training_loss(state.params, batch, state.step, draws,
                                                      data_group=self.data_group)
        with span("cd360.train.backward"):
            loss.backward()
        with span("cd360.train.update"):
            return self._update(state, metrics)

    def _update(self, state: TrainState, metrics):
        """After the backward: the gradients' mean over ``data_group``,
        ``grad_norm``, the accumulation, the clipping and the AdamW update."""
        cfg = self.cfg
        opt = state.optimizer
        leaves = self.trainable(state)
        for leaf in leaves:
            if leaf.grad is None:
                leaf.grad = torch.zeros_like(leaf)
        metrics = {k: v.detach() for k, v in metrics.items()}
        if self.data_group is not None:
            from ..parallel.mesh import all_reduce_mean

            for group in opt.param_groups:
                all_reduce_mean([p.grad for p in group["params"]], self.data_group)
            names = sorted(metrics)
            mean = all_reduce_mean([torch.stack([metrics[k].float() for k in names])],
                                   self.data_group)[0]
            metrics = dict(zip(names, mean.unbind()))
        grad_norm = _global_norm([leaf.grad for leaf in leaves])
        metrics["grad_norm"] = grad_norm
        accum = dict(state.accum)
        k = cfg.accumulate_grad_batches
        if k > 1:
            m = accum["mini_step"]
            if accum["grads"] is None:
                accum["grads"] = [torch.zeros_like(leaf) for leaf in leaves]
            for acc, leaf in zip(accum["grads"], leaves):  # running mean, as MultiSteps
                acc.add_((leaf.grad - acc) / (m + 1))
            if m + 1 < k:
                opt.zero_grad(set_to_none=True)
                accum["mini_step"] = m + 1
                return state._replace(step=state.step + 1, accum=accum), metrics
            for acc, leaf in zip(accum["grads"], leaves):
                leaf.grad.copy_(acc)
                acc.zero_()
        if cfg.max_grad_norm is not None:
            for group in opt.param_groups:  # one global norm per label
                grads = [p.grad for p in group["params"]]
                norm = _global_norm(grads)
                scale = torch.where(norm < cfg.max_grad_norm, torch.ones_like(norm),
                                    cfg.max_grad_norm / norm)
                for g in grads:
                    g.mul_(scale.to(g.dtype))
        opt.step()
        accum.update(mini_step=0, applied=accum["applied"] + 1)
        return state._replace(step=state.step + 1, accum=accum), metrics


def _global_norm(tensors):
    return torch.linalg.vector_norm(
        torch.stack([torch.linalg.vector_norm(t.float()) for t in tensors]))
