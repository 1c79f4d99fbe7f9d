"""Pose-conditioned sampling CLI (port of custom_diffusion360_tpu/cli/
sample.py): load the base SDXL checkpoint, a delta checkpoint and cameras,
pick evenly spaced reference views, tokenize the prompts and run the
conditioner, then sample each target pose (optionally a camera sweep) with
50 steps of the chosen sampler (Euler-EDM by default) under the x3
image+text guider (``--scale_im`` > 0, the default) or the x2 one, decode
and save PNGs.

    python -m custom_diffusion360_torch.cli.sample \\
        --base_ckpt sd_xl_base_1.0.safetensors --delta_ckpt delta.npz \\
        --cameras cameras.npz --prompt "photo of a <new1> car" \\
        --vocab_dir tokenizer_files/ --output_dir out/

Runs on the CUDA card unless ``--device cpu``. Without ``--base_ckpt`` the
weights are random from ``--seed``; without ``--cameras`` two rings of 20
training and 7 validation cameras stand in; without ``--vocab_dir`` a
synthetic tokenizer of a few words does. ``--smoke`` runs a tiny
configuration; ``--config`` (a YAML file) and ``--override key.path=value``
change the EngineConfig after it, in that order (``--override
discretization_name=edm`` or ``sampler.s_churn=...`` reach the sampler).
``--sampler`` picks one of the six samplers. The initial noise is drawn per
job, so the deterministic samplers give the same image at any ``--batch``;
the ancestral ones (and churn) draw their per-step noise per batch of jobs
from ``--seed``, so a run repeats exactly for a fixed ``--batch``, as in the
JAX CLI.

``--latency_shard`` splits the guider's CFG rows of each batch over the
cards (``Engine.sample(cfg_group=)``): ``torchrun --nproc_per_node N -m
custom_diffusion360_torch.cli.sample --latency_shard ...``. The group is the
first G ranks, G the largest count up to the world size that divides the
num_copies x batch rows; ranks past G stay idle, and rank 0 alone writes
the PNGs. In a world of one, or without a process group (no torchrun
environment), the flag changes nothing.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import struct
import time
import zlib

import numpy as np
import torch

from .. import resolve_device
from ..data.tokenizer import ClipTokenizer, make_test_tokenizer
from ..diffusion.guiders import scheduled_cfg_img_text_ref, vanilla_cfg_img_ref
from ..diffusion.sampling import SAMPLERS
from ..draws import Draws
from ..engine import Engine, EngineConfig
from ..geometry.cameras import (
    Cameras,
    interpolate_camera_focal,
    interpolate_camera_translation,
    stack_cameras,
)
from ..io.cameras_io import load_cameras_npz
from ..io.delta import apply_delta_state_dict, load_delta_npz, load_delta_torch
from ..models.clip import ClipTextConfig
from ..models.conditioner import ConditionerConfig, get_unconditional_conditioning
from ..models.unet import UNetConfig
from ..models.vae import VAEConfig
from ..parallel import is_main_process, rank, world_size
from ..train.trainer import tree_map
from ..utils.config import load_config

# --smoke: the JAX tests' TINY_CFG (tests/test_engine.py) with 64-channel
# heads, the head dim the attention kernel is built for
SMOKE_CFG = EngineConfig(
    unet=UNetConfig(
        model_channels=64, channel_mult=(1, 2), transformer_depth=(1, 1),
        attention_resolutions=(2,), context_dim=96, adm_in_channels=72,
        num_head_channels=64, image_cross_blocks=(0,), num_samples=4, num_freqs=4,
    ),
    vae=VAEConfig(ch=16, ch_mult=(1, 2, 4, 4), num_res_blocks=1),
    conditioner=ConditionerConfig(
        clip_l=ClipTextConfig(vocab_size=64, width=48, layers=1, heads=4, context_length=16),
        open_clip=ClipTextConfig(vocab_size=64, width=48, layers=2, heads=4, context_length=16,
                                 act="gelu", text_projection=True),
        size_outdim=4,
    ),
)


def build_parser():
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--base_ckpt", default=None, help=".safetensors (or .ckpt) SDXL base")
    p.add_argument("--delta_ckpt", default=None, help="delta .npz or reference .ckpt")
    p.add_argument("--cameras", default=None, help="cameras .npz (train/val splits)")
    p.add_argument("--prompt", default="photo of a <new1> car")
    p.add_argument("--negative_prompt", default="")
    p.add_argument("--scale", type=float, default=7.5)
    p.add_argument("--scale_im", type=float, default=3.5,
                   help=">0 selects the x3 image+text guider, 0 the x2 one")
    p.add_argument("--num_steps", type=int, default=50)
    p.add_argument("--sampler", default="euler_edm", choices=list(SAMPLERS),
                   help="euler_edm and heun_edm (with churn under --override "
                        "sampler.s_churn=...), the two ancestral samplers, dpmpp2m, lms")
    p.add_argument("--num_ref", type=int, default=8)
    p.add_argument("--batch", type=int, default=1, help="target poses sampled together")
    p.add_argument("--num_images", type=int, default=4, help="target poses to sample")
    p.add_argument("--resolution", type=int, default=512)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--output_dir", default="outputs")
    p.add_argument("--vocab_dir", default=None,
                   help="dir with vocab.json+merges.txt (HF) and/or bpe_simple_vocab_16e6.txt.gz")
    p.add_argument("--dtype", default="bfloat16")
    p.add_argument("--nerf_chunk", type=int, default=4096,
                   help="FeatureNeRF ray-chunk size (4096: one chunk at the SDXL token grids)")
    p.add_argument("--translate", choices=["x", "y", "z", "focal"], default=None,
                   help="sweep each target pose: view-space offsets along x/y/z, or focal "
                        "scales 1 + s, for s in arange(interp_start, interp_end, interp_step)")
    p.add_argument("--interp_start", type=float, default=-0.3)
    p.add_argument("--interp_end", type=float, default=0.3)
    p.add_argument("--interp_step", type=float, default=0.1)
    p.add_argument("--smoke", action="store_true", help="tiny random configuration")
    p.add_argument("--config", default=None, help="EngineConfig YAML overrides")
    p.add_argument("--override", action="append", default=[],
                   help="config dotlist override, repeatable")
    p.add_argument("--latency_shard", action="store_true",
                   help="split the guider's CFG rows over the cards of a torchrun world")
    p.add_argument("--device", default="cuda")
    return p


def make_tokenizers(vocab_dir, context_length: int = 77):
    """(CLIP-L tokenizer, OpenCLIP tokenizer), both with the <new1> token."""
    if vocab_dir is None:
        tok = make_test_tokenizer(["photo", "of", "a", "car", "chair", "teddybear"],
                                  additional_special_tokens=("<new1>",),
                                  context_length=context_length)
        return tok, tok
    hf_vocab = os.path.join(vocab_dir, "vocab.json")
    hf_merges = os.path.join(vocab_dir, "merges.txt")
    oc_merges = os.path.join(vocab_dir, "bpe_simple_vocab_16e6.txt.gz")
    if os.path.exists(hf_vocab):
        tok_clip = ClipTokenizer.from_hf_files(hf_vocab, hf_merges,
                                               additional_special_tokens=("<new1>",),
                                               context_length=context_length)
    else:
        tok_clip = ClipTokenizer.from_merges(oc_merges, additional_special_tokens=("<new1>",),
                                             pad_style="hf", context_length=context_length)
    tok_open = (ClipTokenizer.from_merges(oc_merges, additional_special_tokens=("<new1>",),
                                          context_length=context_length)
                if os.path.exists(oc_merges) else tok_clip)
    return tok_clip, tok_open


def ring_cameras(n, z=2.7):
    """n cameras on a circle around the origin, looking at it."""
    th = np.linspace(0, 2 * np.pi, n, endpoint=False)
    R = np.stack([np.array([[np.cos(t), 0, np.sin(t)], [0, 1, 0], [-np.sin(t), 0, np.cos(t)]],
                           np.float32) for t in th])
    T = np.tile(np.array([0, 0, z], np.float32), (n, 1))
    return Cameras.create(R, T, 2.0, 0.0)


def write_png(path, img):
    """(H, W, 3) uint8 -> an 8-bit RGB PNG (zlib + struct; no PIL)."""
    h, w, _ = img.shape
    raw = b"".join(b"\x00" + img[i].tobytes() for i in range(h))  # filter 0 per row

    def chunk(tag, data):
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
                + chunk(b"IDAT", zlib.compress(raw, 6)) + chunk(b"IEND", b""))


def chunk_generator(seed: int, start: int) -> torch.Generator:
    """The CPU generator of the per-step noise of the batch of jobs that
    starts at job ``start``: seeded by (seed, start)."""
    s = int(np.random.SeedSequence([seed, 1, start]).generate_state(1, np.uint64)[0])
    return torch.Generator().manual_seed(s & (2**63 - 1))


def job_noise(seed, job, latent):
    """The initial latent draws of one job, (latent, latent, 4) f32, from a
    generator seeded by (seed, job): an image does not depend on --batch."""
    return np.random.default_rng([seed, job]).standard_normal((latent, latent, 4), np.float32)


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _latency_group(latency_shard: bool, rows: int):
    """(cfg_group, whether this rank is in it) for --latency_shard over
    ``rows`` guider rows: without the flag, a process group or a second
    rank, (None, True); else the group of the first G ranks, G the largest
    count up to the world size that divides ``rows``. Every rank calls
    ``new_group``, as it must."""
    import torch.distributed as dist

    if not latency_shard or world_size() == 1:
        return None, True
    g = min(world_size(), rows)
    while rows % g:
        g -= 1
    group = dist.group.WORLD if g == world_size() else dist.new_group(list(range(g)))
    return (group, True) if rank() < g else (None, False)


@torch.inference_mode()
def main(argv=None, *, callback=None):
    """Run the CLI. ``callback(i)``, when given, runs after sampler step i
    of every image (Engine.sample). Returns one record per batch of target
    poses: {"paths", "images" (uint8 (b, H, W, 3)), "sample_s", "decode_s",
    "seconds"}."""
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    if args.latency_shard and "WORLD_SIZE" in os.environ:
        from ..parallel import init_distributed

        device = init_distributed(device=args.device)
    cfg = EngineConfig(compute_dtype=args.dtype,
                       unet=UNetConfig(nerf_dtype=args.dtype, nerf_chunk_size=args.nerf_chunk))
    if args.smoke:
        cfg = dataclasses.replace(
            SMOKE_CFG, compute_dtype=args.dtype,
            unet=dataclasses.replace(SMOKE_CFG.unet, nerf_dtype=args.dtype))
    cfg = load_config(cfg, args.config, args.override)
    dtype = cfg.dtype
    eng = Engine(cfg, device=device)

    # ---- params ----
    if args.base_ckpt:
        from ..io.torch_convert import load_sdxl_checkpoint

        params = load_sdxl_checkpoint(args.base_ckpt, cfg.unet, cfg.vae, cfg.conditioner.clip_l,
                                      cfg.conditioner.open_clip)
        params = tree_map(lambda x: x.to(device, dtype) if x.is_floating_point()
                          else x.to(device), params)
    else:
        params = eng.init_params(seed=args.seed)
    references = None
    if args.delta_ckpt:
        delta = (load_delta_npz(args.delta_ckpt) if args.delta_ckpt.endswith(".npz")
                 else load_delta_torch(args.delta_ckpt))
        params, references = apply_delta_state_dict(params, delta, cfg.unet)
        del delta
    # every floating leaf in the compute dtype (the kernels take one dtype)
    params = tree_map(lambda x: x.to(dtype) if x.is_floating_point() else x, params)

    # ---- cameras ----
    if args.cameras:
        splits = load_cameras_npz(args.cameras)
        cams_train, cams_val = splits["train"], splits["val"]
    else:
        cams_train, cams_val = ring_cameras(20), ring_cameras(7)
    n_train = cams_train.batch_shape[0]
    num_ref = min(args.num_ref, n_train)
    max_diff = n_train / num_ref
    choices = [int(x) for x in np.linspace(0, n_train - max_diff, num_ref)]
    ref_cams = cams_train[np.asarray(choices)]

    # ---- conditioning ----
    tok_clip, tok_open = make_tokenizers(args.vocab_dir,
                                         context_length=cfg.conditioner.clip_l.context_length)
    b = max(1, args.batch)

    def cond_batch(prompt):
        return {
            "tokens_clip": torch.from_numpy(tok_clip([prompt] * b)).to(device),
            "tokens_open": torch.from_numpy(tok_open([prompt] * b)).to(device),
            "original_size": torch.full((b, 2), float(args.resolution), device=device),
            "crop_coords": torch.zeros((b, 2), device=device),
            "target_size": torch.full((b, 2), float(args.resolution), device=device),
        }

    c, uc = get_unconditional_conditioning(
        params["conditioner"], cond_batch(args.prompt), cond_batch(args.negative_prompt),
        cfg.conditioner, force_uc_zero_txt=bool(args.prompt), ref=False)
    c = {k: v.to(dtype) for k, v in c.items()}
    uc = {k: v.to(dtype) for k, v in uc.items()}
    guider = (scheduled_cfg_img_text_ref(scale=args.scale, scale_im=args.scale_im)
              if args.scale_im > 0 else vanilla_cfg_img_ref(scale=args.scale))

    # ---- target poses ----
    rng = np.random.default_rng(args.seed)
    n_val = cams_val.batch_shape[0]
    pose_ids = rng.choice(n_val, min(args.num_images, n_val), replace=False)
    latent = args.resolution // 8
    cfg_group, in_group = _latency_group(args.latency_shard, guider.num_copies * b)
    writer = is_main_process()
    if writer:
        os.makedirs(args.output_dir, exist_ok=True)

    # (pose, sweep step) jobs, sampled --batch at a time; each row carries
    # its own target camera, the reference cameras and features are shared
    jobs = []
    for count, pid in enumerate(pose_ids):
        target = cams_val[int(pid)]
        targets = [target]
        if args.translate:
            steps = np.arange(args.interp_start, args.interp_end, args.interp_step)
            if args.translate == "focal":
                swept = interpolate_camera_focal(target, 1.0 + steps)
            else:
                offsets = np.zeros((len(steps), 3), np.float32)
                offsets[:, {"x": 0, "y": 1, "z": 2}[args.translate]] = steps
                swept = interpolate_camera_translation(target, offsets)
            targets = [swept[j] for j in range(len(steps))]
        for j, tgt in enumerate(targets):
            jobs.append((count, j, tgt))

    records = []
    if not in_group:
        print("--latency_shard: this rank is outside the CFG group, idle", flush=True)
        jobs = []
    for start in range(0, len(jobs), b):
        chunk = jobs[start: start + b]
        real = len(chunk)
        job_idx = list(range(start, start + real))
        while len(chunk) < b:  # pad the ragged tail; the extras are not saved
            chunk.append(chunk[-1])
            job_idx.append(job_idx[-1])
        # cams rows: [target_i | refs] per image, the b-row block tiled over
        # the guider's copies (which shared_target_cams=True declares)
        rows = stack_cameras([stack_cameras([tgt] + [ref_cams[i] for i in range(num_ref)])
                              for _, _, tgt in chunk])
        cams = Cameras(*(torch.cat([f] * guider.num_copies) for f in rows)).to(device)
        noise = torch.from_numpy(np.stack([job_noise(args.seed, i, latent) for i in job_idx]))
        _sync(device)
        t0 = time.perf_counter()
        z = eng.sample(params, c, uc, guider, noise=noise, cams=cams, references=references,
                       choices=choices if references else None, num_steps=args.num_steps,
                       sampler=args.sampler, draws=Draws(chunk_generator(args.seed, start)),
                       callback=callback, shared_target_cams=True,
                       cfg_group=cfg_group)
        _sync(device)
        t1 = time.perf_counter()
        img = eng.decode_first_stage(params, z.to(dtype))
        img = ((img.float() + 1) * 127.5).clamp(0, 255).to(torch.uint8).cpu().numpy()
        t2 = time.perf_counter()
        dt = t2 - t0
        paths = []
        for r in range(real if writer else 0):
            count, j, _ = chunk[r]
            out_path = os.path.join(args.output_dir, f"sample_{count:02d}_{j:02d}.png")
            write_png(out_path, img[r])
            paths.append(out_path)
            print(f"saved {out_path} ({dt / real:.1f}s/img)", flush=True)
        records.append(dict(paths=paths, images=img[:real], sample_s=t1 - t0,
                            decode_s=t2 - t1, seconds=dt))
    return records


if __name__ == "__main__":
    main()
