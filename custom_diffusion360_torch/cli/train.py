"""Training CLI (port of custom_diffusion360_tpu/cli/train.py): build the
engine, the CO3D data and the trainer, run the fine-tuning loop (the pose
blocks' leaves and the V* token rows), log step metrics, checkpoint, and at
the end capture the reference features and export the delta checkpoint,
the cameras file and the config, which the port's cli/sample.py reads.

    python -m custom_diffusion360_torch.cli.train \\
        --data_root data/co3d --category car --base_ckpt sd_xl_base_1.0.safetensors \\
        --output_dir runs/car0 --max_steps 1610 --batch_size 4 \\
        --override compute_dtype=bfloat16

Runs on the CUDA card unless ``--device cpu``. ``--smoke`` trains the
sampling CLI's tiny ``SMOKE_CFG`` on synthetic batches (no dataset or
weights needed). Without ``--base_ckpt`` the weights are random from
``--seed``. Each step's draws come from a generator seeded by (seed, step),
so a resumed run continues as the uninterrupted one would.

``--sample_every N`` writes preview grids (``Engine.log_images``: inputs,
reconstructions, an 8-step live-reference sample, the FeatureNeRF's
predicted RGB and foreground masks, and the prompts as ``conditioning``) to
``images/<name>_<step:06d>.png`` at every step that is a multiple of N,
and with ``--log_steps_increase`` also at the powers of two up to N.

``--multihost`` trains data-parallel, one process per card: started by
``torchrun --nproc_per_node N -m custom_diffusion360_torch.cli.train
--multihost ...`` (the rendezvous from torchrun's environment), or by hand
with ``--coordinator host:port --num_processes N --process_id i`` in each
process. NCCL on the card, gloo with ``--device cpu``. Every rank loads its
own rows (loader seed ``--seed`` + rank, the smoke batches from rank), the
trainer all-reduces the gradient mean, the capture splits its views over
the ranks when their count divides them, and rank 0 alone writes
metrics.csv, wandb, the profile, checkpoints, deltas, preview grids and the
cameras. ``--scale_lr`` scales by accumulate x ranks x batch. The process
group stays up when ``main`` returns (an in-process caller destroys it).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import signal
import time

import numpy as np
import torch

from .. import resolve_device
from ..draws import Draws


def build_parser():
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--data_root", default="data/co3d")
    p.add_argument("--category", default="car")
    p.add_argument("--single_id", type=int, default=0)
    p.add_argument("--base_ckpt", default=None)
    p.add_argument("--output_dir", default="runs/run0")
    p.add_argument("--name", default="")
    p.add_argument("--max_steps", type=int, default=1610)
    p.add_argument("--batch_size", type=int, default=1, help="per-rank batch")
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--scale_lr", action="store_true",
                   help="scale lr by accumulate * ranks * batch")
    p.add_argument("--trainkeys", default="pose", choices=["pose", "poseattn", "all"])
    p.add_argument("--img_size", type=int, default=512)
    p.add_argument("--num_images", type=int, default=5)
    p.add_argument("--accumulate", type=int, default=1)
    p.add_argument("--ckpt_every", type=int, default=1600,
                   help="write delta_step<N>.npz every N steps")
    p.add_argument("--log_every", type=int, default=10)
    p.add_argument("--seed", type=int, default=23)
    p.add_argument("--vocab_dir", default=None)
    p.add_argument("--modifier_token", default="<new1>")
    p.add_argument("--reg_dir", default=None)
    p.add_argument("--config", default=None, help="EngineConfig YAML overrides")
    p.add_argument("--override", action="append", default=[],
                   help="config dotlist override, repeatable")
    p.add_argument("--use_ema", action="store_true")
    p.add_argument("--ema_decay", type=float, default=0.9999)
    p.add_argument("--resume", action="store_true",
                   help="resume from the latest checkpoint in output_dir/checkpoints")
    p.add_argument("--full_ckpt_every", type=int, default=0,
                   help="full training-state checkpoint interval (0 = final only)")
    p.add_argument("--sample_every", type=int, default=0,
                   help="write input/recon/sample image grids every N steps")
    p.add_argument("--log_steps_increase", action="store_true",
                   help="also write grids at the power-of-two steps up to --sample_every")
    p.add_argument("--val_every", type=int, default=0,
                   help="log a validation loss every N steps")
    p.add_argument("--multihost", action="store_true",
                   help="data-parallel run, one process per card (torch.distributed)")
    p.add_argument("--coordinator", default=None,
                   help="host:port of rank 0 for --multihost (default: torchrun's env)")
    p.add_argument("--num_processes", type=int, default=None)
    p.add_argument("--process_id", type=int, default=None)
    p.add_argument("--profile_steps", type=int, default=0,
                   help="torch.profiler chrome trace of steps [10, 10+N) under profile/, "
                        "with the port's cd360.* spans (utils/trace.py) beside its ops")
    p.add_argument("--wandb", default=None,
                   help="wandb project name: mirror step metrics to wandb")
    p.add_argument("--smoke", action="store_true")
    p.add_argument("--smoke_steps", type=int, default=2)
    p.add_argument("--device", default="cuda")
    return p


def log_images_now(step: int, sample_every: int, increase: bool) -> bool:
    """The preview schedule: steps > 0 that are multiples of
    ``sample_every``, plus, with ``increase``, the powers of two up to it."""
    if not sample_every or not step:
        return False
    return step % sample_every == 0 or (increase and step <= sample_every
                                        and step & (step - 1) == 0)


def step_generator(seed: int, step: int, device, stream: int = 0) -> torch.Generator:
    """The generator of one step's draws: seeded by (seed, stream, step)."""
    s = int(np.random.SeedSequence([seed, stream, step]).generate_state(1, np.uint64)[0])
    return torch.Generator(device=device).manual_seed(s & (2**63 - 1))


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None):
    """Run the CLI. Returns a summary: {"output_dir", "steps": [{"step",
    "step_s", "data_s"}], "grids": [{"step", "seconds", "paths"}] (the
    preview grids and the wall time of their log_images call),
    "capture_s", "delta", "cameras", "trainable" (the final trainable leaves,
    before an EMA swap)}."""
    args = build_parser().parse_args(argv)
    group = None
    rendezvous = (args.coordinator, args.num_processes, args.process_id)
    if not args.multihost and any(x is not None for x in rendezvous):
        raise ValueError("--coordinator, --num_processes and --process_id need --multihost")
    if args.multihost and args.coordinator is None and "WORLD_SIZE" not in os.environ:
        raise ValueError("--multihost needs --coordinator host:port --num_processes N "
                         "--process_id i, or torchrun's environment")
    if args.multihost:
        import torch.distributed as dist

        from ..parallel import init_distributed

        device = init_distributed(args.coordinator, args.num_processes, args.process_id,
                                  device=args.device)
        group = dist.group.WORLD
    else:
        device = resolve_device(args.device)
    from ..parallel import (all_reduce_mean, barrier, is_main_process, rank, replicate,
                            world_size)

    me, ranks = rank(group), world_size(group)
    is_main = is_main_process()

    from ..engine import Engine, EngineConfig
    from ..train.checkpoint import latest_checkpoint, restore_train_state, save_train_state
    from ..train.ema import ema_init, ema_swap, ema_update
    from ..train.logging import MetricsLogger, render_text_image, save_image_grid
    from ..train.trainer import TrainConfig, Trainer, tree_map
    from ..utils.config import apply_overrides, config_to_dict, load_config
    from .sample import SMOKE_CFG, make_tokenizers

    os.makedirs(args.output_dir, exist_ok=True)
    cfg = EngineConfig()
    if args.smoke:
        cfg = SMOKE_CFG
        args.max_steps = args.smoke_steps
        args.img_size = 64
        args.num_images = 3
        args.ckpt_every = max(args.ckpt_every, 10**6)
    if args.config:
        cfg = load_config(cfg, args.config)
    cfg = apply_overrides(cfg, args.override)
    eng = Engine(cfg, device=device)

    lr = args.lr
    if args.scale_lr:
        lr = lr * args.accumulate * ranks * args.batch_size
    trainer = Trainer(eng, TrainConfig(lr=lr, trainkeys=args.trainkeys,
                                       accumulate_grad_batches=args.accumulate),
                      data_group=group)

    if args.base_ckpt:
        from ..io.torch_convert import load_sdxl_checkpoint
        from ..models.clip import init_modifier_rows

        params = load_sdxl_checkpoint(args.base_ckpt, cfg.unet, cfg.vae, cfg.conditioner.clip_l,
                                      cfg.conditioner.open_clip)
        # the V* rows start from token 42170's embedding
        for tower in ("clip_l", "open_clip"):
            params["conditioner"][tower] = init_modifier_rows(params["conditioner"][tower])
        params = tree_map(lambda x: x.to(device, cfg.dtype) if x.is_floating_point()
                          else x.to(device), params)
    else:
        params = eng.init_params(seed=args.seed)

    # ---- data ----
    tok_clip, tok_open = make_tokenizers(args.vocab_dir,
                                         context_length=cfg.conditioner.clip_l.context_length)
    capture_data = None
    if args.smoke:
        train_iter = iter(_synthetic_batches(args, cfg, tok_clip, tok_open, device))
    else:
        from ..data.co3d import Co3dConfig, Co3dDataset, DataLoader

        dcfg = Co3dConfig(root=args.data_root, category=args.category,
                          single_id=args.single_id, img_size=args.img_size,
                          num_images=args.num_images, modifier_token=args.modifier_token,
                          addreg=args.reg_dir is not None, reg_dir=args.reg_dir)
        ds = Co3dDataset(dcfg)
        # this rank's rows (the DDP per-rank split)
        loader = DataLoader(ds, args.batch_size, tok_clip, tok_open, seed=args.seed + me,
                            device=device)
        capture_data = (ds, dcfg)
        train_iter = _cycle(loader)

    state = trainer.init_state(params)
    del params
    if is_main:
        with open(os.path.join(args.output_dir, "config.json"), "w") as f:
            json.dump(config_to_dict(cfg), f, indent=2, default=str)

    ckpt_dir = os.path.join(args.output_dir, "checkpoints")
    mask = tree_map(lambda lab: lab != "frozen", trainer.labels)
    ema = ema_init(state.params, mask) if args.use_ema else None
    if args.resume:
        latest = latest_checkpoint(ckpt_dir)
        if latest:
            state, ema = restore_train_state(latest, state, ema)
            print(f"resumed from {latest} at step {state.step}", flush=True)
    if group is not None:  # rank 0's values everywhere; raises if any rank's differed
        replicate(state.params, group)

    def save_state():
        # rank 0 writes; every rank waits for it, so a resume finds the file
        if is_main:
            save_train_state(ckpt_dir, state, ema=ema)
        if group is not None:
            barrier(group)

    # SIGUSR1 writes a checkpoint, SIGUSR2 enters the debugger (the
    # reference's melk and divein handlers); the previous handlers come
    # back when main returns
    def melk(*_):
        if group is not None:  # the ranks' barrier cannot run from a signal handler
            print("SIGUSR1 ignored under --multihost", flush=True)
            return
        print("SIGUSR1: writing checkpoint", flush=True)
        save_train_state(ckpt_dir, state, ema=ema)

    def divein(*_):
        import pdb

        pdb.set_trace()

    old_handlers = {}
    for sig, fn in ((signal.SIGUSR1, melk), (signal.SIGUSR2, divein)):
        try:
            old_handlers[sig] = signal.signal(sig, fn)
        except (ValueError, OSError):  # not the main thread
            pass

    val_iter = None
    if args.val_every:
        if args.smoke:
            val_iter = _cycle(_synthetic_batches(args, cfg, tok_clip, tok_open, device))
        else:
            val_iter = _cycle(DataLoader(ds, args.batch_size, tok_clip, tok_open,
                                         seed=args.seed + 10_000 + me, device=device))

    meter = MetricsLogger(args.output_dir, ranks * args.batch_size,
                          wandb_project=args.wandb if is_main else None, run_name=args.name)
    shard = None if group is None else (me, ranks)
    profile_dir = os.path.join(args.output_dir, "profile")
    prof = None
    steps, grids = [], []
    t_start = time.time()
    try:
        for step in range(state.step, args.max_steps):
            if args.profile_steps and step == 10 and is_main:
                prof = torch.profiler.profile(activities=_profiler_activities(device))
                prof.start()
            t0 = time.perf_counter()
            batch = next(train_iter)
            data_s = time.perf_counter() - t0
            txts = batch.pop("txt", None)
            batch.pop("txt_ref", None)
            meter.tic()
            state, metrics = trainer.train_step(
                state, batch, Draws(step_generator(args.seed, step, device), shard=shard))
            _sync(device)  # the meter times the whole step
            step_s = meter.toc()
            steps.append({"step": step, "step_s": step_s, "data_s": data_s})
            if prof is not None and step == 10 + args.profile_steps - 1:
                prof.stop()
                os.makedirs(profile_dir, exist_ok=True)
                prof.export_chrome_trace(os.path.join(profile_dir, "trace.json"))
                prof = None
                print(f"profiler trace written to {profile_dir}", flush=True)
            if ema is not None:
                ema = ema_update(ema, state.params, args.ema_decay)
            if is_main and (step % args.log_every == 0 or step == args.max_steps - 1):
                row = meter.log(step, dict(metrics, step_ms=step_s * 1e3,
                                           data_ms=data_s * 1e3))
                print(f"step {step}: loss={row.get('loss_total', 0):.4f} " + " ".join(
                    f"{k}={v:.4f}" for k, v in row.items() if k not in ("loss_total", "step")),
                    flush=True)
            if args.val_every and step and step % args.val_every == 0:
                vbatch = next(val_iter)
                vbatch.pop("txt", None)
                vbatch.pop("txt_ref", None)
                with torch.no_grad():
                    _, vmetrics = eng.training_loss(
                        state.params, vbatch, state.step,
                        Draws(step_generator(args.seed, step, device, stream=1), shard=shard),
                        data_group=group)
                if group is not None:  # the global batch's mean
                    names = sorted(vmetrics)
                    mean = all_reduce_mean([torch.stack([vmetrics[k].float() for k in names])],
                                           group)[0]
                    vmetrics = dict(zip(names, mean.unbind()))
                if is_main:
                    row = meter.log(step, {f"val_{k}": v for k, v in vmetrics.items()})
                    print(f"step {step}: val_loss={row.get('val_loss_total', 0):.4f}",
                          flush=True)
            if args.ckpt_every and step and step % args.ckpt_every == 0 and is_main:
                _save_delta(args, state.params, None, cfg, tag=f"step{step}")
            if args.full_ckpt_every and step and step % args.full_ckpt_every == 0:
                save_state()
            if is_main and log_images_now(step, args.sample_every, args.log_steps_increase):
                t0 = time.perf_counter()
                images = eng.log_images(state.params, batch, Draws(
                    step_generator(args.seed, step, device, stream=3)), num_steps=8)
                images = {k: v.cpu().numpy() for k, v in images.items()}
                log_s = time.perf_counter() - t0
                if txts:
                    images["conditioning"] = render_text_image(txts)
                paths = []
                for name, imgs in images.items():
                    paths.append(save_image_grid(
                        os.path.join(args.output_dir, "images", f"{name}_{step:06d}.png"), imgs))
                    meter.log_images(step, name, paths[-1])
                grids.append({"step": step, "seconds": log_s, "paths": paths})
                print(f"step {step}: {len(paths)} image grids in {log_s:.2f}s", flush=True)
    except KeyboardInterrupt:
        if group is None:  # under --multihost the peers may be gone: a barrier would hang
            print("interrupted: writing last checkpoint", flush=True)
            save_train_state(ckpt_dir, state, ema=ema)
        raise
    finally:
        if prof is not None:  # the run ended inside the traced steps
            prof.stop()
        for sig, fn in old_handlers.items():
            signal.signal(sig, fn)
        for it in (train_iter, val_iter):
            if hasattr(it, "close"):
                it.close()  # stops a loader's worker thread
        meter.close()

    save_state()
    trainable = [leaf.detach() for leaf in trainer.trainable(state)]
    params = state.params if ema is None else ema_swap(state.params, ema)
    print(f"training done in {time.time() - t_start:.0f}s", flush=True)

    # ---- capture + delta export ----
    references, capture_s = None, None
    if capture_data is not None:
        t0 = time.perf_counter()
        references = _run_capture(args, eng, params, capture_data, tok_clip, tok_open, device,
                                  group=group, write=is_main)
        _sync(device)
        capture_s = time.perf_counter() - t0
    delta = None
    if is_main:
        delta = _save_delta(args, params, references, cfg, tag="last")
        print(f"delta checkpoint written to {args.output_dir}", flush=True)
    return {"output_dir": args.output_dir, "steps": steps, "grids": grids,
            "capture_s": capture_s,
            "delta": delta,
            "cameras": None if capture_data is None else
            os.path.join(args.output_dir, "cameras.npz"),
            "trainable": trainable}


def _profiler_activities(device):
    acts = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return acts


def _cycle(batches):
    while True:
        yield from batches


def _save_delta(args, params, references, cfg, tag):
    from ..io.delta import extract_delta, save_delta_npz

    path = os.path.join(args.output_dir, f"delta_{tag}.npz")
    save_delta_npz(path, extract_delta(params, references, cfg.unet))
    return path


@torch.no_grad()
def _run_capture(args, eng, params, capture_data, tok_clip, tok_open, device, group=None,
                 write=True):
    """Forward the onlyref set (every valid frame once, plus the zero
    image) through the reference stream, collect each pose block's buffer,
    and (``write``) write cameras.npz. Under ``group`` the views split over
    its ranks when their count divides them; else every rank runs all."""
    from ..data.co3d import Co3dDataset
    from ..geometry.cameras import stack_cameras
    from ..io.cameras_io import save_cameras_npz
    from ..models.conditioner import apply_conditioner
    from ..parallel import world_size
    from ..train.capture import capture_references

    ds, dcfg = capture_data
    cap_ds = Co3dDataset(dataclasses.replace(dcfg, num_images=2, repeat=1, addlen=True,
                                             onlyref=True, drop_ratio=0.0, drop_txt=0.0))
    rng = np.random.default_rng(0)
    imgs, cams = [], []
    n_items = len(cap_ds) - 1
    for i in range(n_items):
        it = cap_ds.__getitem__(i, rng=rng, validation=True)
        imgs.append(it["image_ref"][0])
        cams.append(it["cams"][1])  # the captured frame's camera
    images_ref = torch.from_numpy(np.stack(imgs))

    it0 = cap_ds.__getitem__(0, rng=rng, validation=True)
    cam_batch = stack_cameras([it0["cams"][0]] + cams + [cams[-1]]).reshape(1, n_items + 2)
    prompt = it0["txt"]
    n_rows = 1 + n_items + 1
    size = torch.full((n_rows, 2), float(args.img_size), device=device)
    cond = apply_conditioner(params["conditioner"], {
        "tokens_clip": torch.from_numpy(tok_clip([prompt] * n_rows)).to(device),
        "tokens_open": torch.from_numpy(tok_open([prompt] * n_rows)).to(device),
        "original_size": size, "crop_coords": torch.zeros_like(size), "target_size": size,
    }, eng.cfg.conditioner, ref=False)
    view_group = None
    if group is not None and (n_items + 1) % world_size(group) == 0:
        view_group = group
    references = capture_references(
        eng, params, images_ref, cam_batch.tensors(device), cond,
        Draws(step_generator(args.seed, args.max_steps, device, stream=2)),
        view_group=view_group)
    if write:
        train_cams = stack_cameras(cams).tensors()
        save_cameras_npz(os.path.join(args.output_dir, "cameras.npz"), train=train_cams,
                         val=train_cams)
    return references


def _synthetic_batches(args, cfg, tok_clip, tok_open, device):
    """Random batches in the CO3D batch contract (--smoke), as the JAX
    CLI's: this rank's rows, from a generator seeded by the rank."""
    from ..geometry.cameras import Cameras
    from ..parallel import rank

    rng = np.random.default_rng(rank())
    b, n, s = args.batch_size, args.num_images - 1, args.img_size
    prompt = f"photo of a {args.modifier_token} {args.category}"
    vocab_l, vocab_g = cfg.conditioner.clip_l.vocab_size, cfg.conditioner.open_clip.vocab_size

    def tensor(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(device)

    out = []
    for _ in range(args.max_steps):
        th = rng.uniform(0, 2 * np.pi, (b * (1 + n),))
        R = np.stack([np.array([[np.cos(t), 0, np.sin(t)], [0, 1, 0],
                                [-np.sin(t), 0, np.cos(t)]], np.float32) for t in th])
        cams = Cameras.create(R, np.tile(np.array([0, 0, 2.7], np.float32), (b * (1 + n), 1)),
                              2.0, 0.0, device=device).reshape(b, 1 + n)
        ones = lambda *shape: torch.ones(shape, device=device)  # noqa: E731
        batch = {
            "image": tensor(rng.normal(size=(b, s, s, 3)).astype(np.float32) * 0.3),
            "image_ref": tensor(rng.normal(size=(b, n, s, s, 3)).astype(np.float32) * 0.3),
            "mask": ones(b, s // 8, s // 8, 1), "mask_ref": ones(b, n, s // 8, s // 8, 1),
            "opacity": ones(b, s // 8, s // 8, 1), "drop_im": ones(b), "cams": cams,
            "tokens_clip": tensor(tok_clip([prompt] * b) % vocab_l),
            "tokens_open": tensor(tok_open([prompt] * b) % vocab_g),
            "tokens_clip_ref": tensor(tok_clip([prompt] * (b * n)) % vocab_l),
            "tokens_open_ref": tensor(tok_open([prompt] * (b * n)) % vocab_g),
        }
        for suffix, m in (("", b), ("_ref", b * n)):
            batch["original_size" + suffix] = torch.full((m, 2), float(s), device=device)
            batch["crop_coords" + suffix] = torch.zeros((m, 2), device=device)
            batch["target_size" + suffix] = torch.full((m, 2), float(s), device=device)
        out.append(batch)
    return out


if __name__ == "__main__":
    main()
