#!/usr/bin/env python
"""Smoke test of the PyTorch/CUDA port (custom_diffusion360_torch) on one GPU.

    python3 chip_smoke.py    # needs one CUDA card

Phases:
  1. build every kernel under custom_diffusion360_torch/csrc with nvcc
     (one process per source, all started together);
  2. hold each kernel against its plain PyTorch version at the main-path
     shapes (max-abs error vs a stated tolerance) and time kernel, plain
     version and the one-call PyTorch yardstick (SDPA / F.grid_sample),
     beside the least time the card could take (bound);
  3. the main path: full-width SDXL, 12 FeatureNeRF pose blocks, 1024^2,
     batch 1, CFG x2 (vanilla_cfg_img_ref, scale 7.5), 8 reference views,
     50 Euler-EDM steps with the render cached after step 0, then
     decode_first_stage. After a warm-up run, launch counters (per kernel
     and per shape) are zeroed just before the timed run and read just
     after; every kernel must have launched, and every shape launched must
     be one that phase 2 checked; a short run then traces two cached steps
     with torch.profiler (device time by kernel group, idle share);
  4. a small configuration sampled twice: on the card through the kernels
     and on the CPU through the plain versions; the two latents must agree.

Prints the card's name and power limit first, the phase-2 checks of shapes
the main path does not launch, a ``{"kernels": [...]}`` line (one row per
main-path shape, with its launches in the timed run) and, last,
``{"ok": true, "device": {...}}``. Any failed phase exits non-zero without
the last line. Weights are random, made from a seed.
"""
from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time

H100_BF16_FLOPS = 989e12  # dense tensor-core peak, H100 SXM data sheet
H100_BYTES_PER_S = 3.35e12  # HBM3 bandwidth, H100 SXM data sheet
REPO = os.path.dirname(os.path.abspath(__file__))


def log(msg):
    print(msg, flush=True)


def gpu_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if out.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, budget_ms=300.0, max_iters=50):
    """Mean device time of ``fn()`` in ms over enough launches to fill
    ``budget_ms``, after one warm-up call, timed with CUDA events."""
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    torch.cuda.synchronize()
    one = max(start.elapsed_time(end), 1e-3)
    iters = int(min(max_iters, max(3, math.ceil(budget_ms / one))))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound(nbytes, flops):
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    t_ops = flops / H100_BF16_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

ATTN_CASES = [
    # (label, b, h, n, m, d, kv_len, packed qkv, TPU kernel replaced)
    ("ds2 self-attn qkv-packed", 2, 10, 4096, 4096, 64, None, True,
     "custom_diffusion360_tpu/ops/block_attention.py:275"),
    ("ds4 self-attn qkv-packed", 2, 20, 1024, 1024, 64, None, True,
     "custom_diffusion360_tpu/ops/block_attention.py:275"),
    ("512^2 ds2 self-attn", 2, 20, 256, 256, 64, None, False,
     "custom_diffusion360_tpu/ops/block_attention.py:123"),
    ("kv_len-masked", 2, 20, 1024, 384, 64, 300, False,
     "custom_diffusion360_tpu/ops/block_attention.py:123"),
    ("VAE mid-block d512", 1, 1, 16384, 16384, 512, None, False,
     "custom_diffusion360_tpu/ops/attention.py:149"),
]
# bf16 kernel (bf16 P in P.V, bf16 output) vs the f32 plain version on the
# same bf16 inputs: one bf16 rounding of the largest output is at most 2**-8
# of max|ref|, the bf16 P adds about 2**-9 of an output
ATTN_TOL = 1e-2  # of max|ref|

BILINEAR_CASES = [
    # (label, M, side, C launched, C needed, P): the FeatureNeRF reader needs
    # C + 1 = 641/1281 channels, padded to 648/1288 on the main path; the
    # bound counts the needed channels only
    ("ds2 pose block", 16, 64, 648, 641, 98304),
    ("ds4 pose block", 16, 32, 1288, 1281, 24576),
    ("ds2 unpadded odd C", 16, 64, 641, 641, 98304),
]
BILINEAR_TOL = 1e-2  # relative to max|ref|: one bf16 rounding of the output


def check_attention(torch, results):
    import torch.nn.functional as F

    from custom_diffusion360_torch.ops.block_attention import (
        attention_fwd,
        attention_plain,
        block_attention,
        block_attention_qkv_fused,
    )

    gen = torch.Generator(device="cuda").manual_seed(0)
    for label, b, h, n, m, d, kv_len, packed, replaces in ATTN_CASES:
        scale = d**-0.5
        if packed:
            qkv = torch.randn((b, n, 3 * h * d), generator=gen, device="cuda",
                              dtype=torch.bfloat16)
            q5 = qkv.view(b, n, 3, h, d).permute(0, 2, 3, 1, 4)
            q, k, v = q5[:, 0], q5[:, 1], q5[:, 2]
            run = lambda: block_attention_qkv_fused(q5, scale)  # noqa: E731
        else:
            q = torch.randn((b, h, n, d), generator=gen, device="cuda", dtype=torch.bfloat16)
            k = torch.randn((b, h, m, d), generator=gen, device="cuda", dtype=torch.bfloat16)
            v = torch.randn((b, h, m, d), generator=gen, device="cuda", dtype=torch.bfloat16)
            run = lambda: block_attention(q, k, v, scale, kv_len)  # noqa: E731
        got = run()
        torch.cuda.synchronize()
        ref = attention_plain(q.float(), k.float(), v.float(), scale, kv_len)
        err = float((got.float() - ref).abs().max())
        ref_max, ref_rms = float(ref.abs().max()), float(ref.square().mean().sqrt())
        tol = ATTN_TOL * ref_max
        ok = math.isfinite(err) and err <= tol
        del ref
        ms = time_ms(run)
        plain_ms = time_ms(lambda: attention_plain(q, k, v, scale, kv_len), max_iters=5)
        mask = None
        if kv_len is not None:
            mask = (torch.arange(m, device="cuda") < kv_len).expand(n, m)
        lib_ms = time_ms(lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask, scale=scale))
        keys = m if kv_len is None else kv_len
        nbytes = 2 * (b * h * n * d * 2 + b * h * keys * d * 2)
        bms, by = bound(nbytes, 4.0 * b * h * n * keys * d)
        results.append(dict(
            name=f"attention_fwd [{label} b{b} h{h} n{n} m{m} d{d}"
                 + (f" kv_len{kv_len}" if kv_len else "") + "]",
            route="cuda", source="custom_diffusion360_torch/csrc/attention.cu",
            replaces=replaces, max_abs_err=err, tol=tol, ref_rms=ref_rms, ms=ms,
            plain_ms=plain_ms, bound_ms=bms, bound_by=by, library_ms=lib_ms,
            ok=ok, _key=("attention", (b, h, n, m, d, keys)),
        ))
        log(f"[kernels] attention {label}: err {err:.3e} (tol {tol:.3e} = {ATTN_TOL} "
            f"x max|ref| {ref_max:.4f}; ref rms {ref_rms:.4f}) "
            f"kernel {ms:.3f} ms plain {plain_ms:.3f} ms sdpa {lib_ms:.3f} ms "
            f"bound {bms:.4f} ms ({by}) {'OK' if ok else 'FAIL'}")


def check_bilinear(torch, results):
    import torch.nn.functional as F

    from custom_diffusion360_torch.ops.grid_sample import grid_sample_2d
    from custom_diffusion360_torch.ops.onehot_sample import bilinear_sample

    gen = torch.Generator(device="cuda").manual_seed(1)
    for label, mm, side, c, c_need, p in BILINEAR_CASES:
        feats = torch.randn((mm, side, side, c), generator=gen, device="cuda",
                            dtype=torch.bfloat16)
        # the FeatureNeRF grid range: clipped to +-1.2, with exact +-1 points
        grid = (torch.rand((mm, p, 2), generator=gen, device="cuda") * 2.4 - 1.2)
        grid[:, :64] = torch.tensor([1.0, -1.0], device="cuda")
        got = bilinear_sample(feats, grid)
        torch.cuda.synchronize()
        ref = grid_sample_2d(feats.float(), grid)
        scale_ref = max(1.0, float(ref.abs().max()))
        err = float((got.float() - ref).abs().max())
        ok = math.isfinite(err) and err <= BILINEAR_TOL * scale_ref
        ms = time_ms(lambda: bilinear_sample(feats, grid))
        plain_ms = time_ms(lambda: grid_sample_2d(feats, grid), max_iters=5)
        nchw = feats.permute(0, 3, 1, 2)
        g4 = grid[:, :, None, :].to(feats.dtype)  # grid_sample wants one dtype
        lib_ms = time_ms(lambda: F.grid_sample(nchw, g4, mode="bilinear",
                                               padding_mode="zeros", align_corners=True))
        nbytes = mm * side * side * c_need * 2 + grid.numel() * 4 + mm * p * c_need * 2
        bms, by = bound(nbytes, 8.0 * mm * p * c_need)
        results.append(dict(
            name=f"bilinear_sample [{label} M{mm} {side}x{side} C{c} (needed {c_need}) P{p}]",
            route="cuda", source="custom_diffusion360_torch/csrc/bilinear_sample.cu",
            replaces="custom_diffusion360_tpu/ops/onehot_sample.py:263",
            max_abs_err=err, tol=BILINEAR_TOL * scale_ref, ms=ms,
            plain_ms=plain_ms, bound_ms=bms, bound_by=by, library_ms=lib_ms,
            ok=ok, _key=("bilinear", (mm, side, side, c, p)),
        ))
        log(f"[kernels] bilinear {label}: err {err:.3e} (tol {BILINEAR_TOL * scale_ref:.3e}) "
            f"kernel {ms:.3f} ms plain {plain_ms:.3f} ms grid_sample {lib_ms:.3f} ms "
            f"bound {bms:.4f} ms ({by}) {'OK' if ok else 'FAIL'}")
        del feats, grid, got, ref
        torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phase 3: the main path at full width
# ---------------------------------------------------------------------------

N_REF, LATENT, STEPS = 8, 128, 50


def perturb_zero_leaves(torch, tree, seed, std=0.02):
    """Fill the zero-initialized leaves (out convs, proj_out, NeRF decoder)
    with N(0, std^2) so the random UNet's eps is not identically 0."""
    gen = None

    def walk(node):
        nonlocal gen
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        if isinstance(node, list):
            return [walk(v) for v in node]
        if node.is_floating_point() and not bool(node.any()):
            if gen is None:
                gen = torch.Generator(device=node.device).manual_seed(seed)
            return (torch.randn(node.shape, generator=gen, device=node.device) * std).to(node.dtype)
        return node

    return walk(tree)


def make_cameras(torch, n, copies, device, seed=1):
    """One target + n reference cameras on a circle (as bench.py), tiled
    over the guider's CFG copies: batch (copies, 1 + n)."""
    import numpy as np

    from custom_diffusion360_torch.geometry.cameras import Cameras

    r = np.random.default_rng(seed)
    rot = np.zeros((n + 1, 3, 3), np.float32)
    for i, th in enumerate(r.uniform(0, 2 * np.pi, n + 1)):
        c, s = np.cos(th), np.sin(th)
        rot[i] = [[c, 0, s], [0, 1, 0], [-s, 0, c]]
    trans = np.tile(np.array([0, 0, 2.7], np.float32), (n + 1, 1))
    cams = Cameras.create(rot, trans, focal_length=2.0, principal_point=0.0, device=device)
    return Cameras(*(f[None].expand((copies,) + tuple(f.shape)).contiguous() for f in cams))


def make_references(torch, unet_cfg, n_ref, latent, device, seed=0):
    """Delta-checkpoint-style reference buffers {attn_id: {d: (n_ref + 1,
    hw, C)}} (last row the zero-image feature), N(0, 0.05^2) f32."""
    from custom_diffusion360_torch.io.delta import iter_pose_blocks
    from custom_diffusion360_torch.models.unet import attn_block_meta

    gen = torch.Generator(device=device).manual_seed(seed)
    meta = attn_block_meta(unet_cfg)
    refs = {}
    for _, _, attn_id, d in iter_pose_blocks(unet_cfg):
        ds, ch, _ = meta[attn_id]
        refs.setdefault(attn_id, {})[d] = torch.randn(
            (n_ref + 1, (latent // ds) ** 2, ch), generator=gen, device=device) * 0.05
    return refs


def make_cond(torch, unet_cfg, b, device, dtype, seed):
    gen = torch.Generator(device=device).manual_seed(seed)

    def draw(*shape):
        return torch.randn(shape, generator=gen, device=device).to(dtype)

    return {"crossattn": draw(b, 77, unet_cfg.context_dim),
            "vector": draw(b, unet_cfg.adm_in_channels)}


def run_main_path(torch, counters):
    """Full-width SDXL + 12 pose blocks, 1024^2, batch 1, CFG x2, 8 views,
    50 Euler-EDM steps (render at step 0, cached after), then the VAE
    decode. Run twice, the second run counted and timed, then traced."""
    from custom_diffusion360_torch.diffusion.guiders import vanilla_cfg_img_ref
    from custom_diffusion360_torch.engine import Engine, EngineConfig
    from custom_diffusion360_torch.models.unet import UNetConfig

    cfg = EngineConfig(
        # cli/sample.py's inference settings: bf16 everywhere, ray chunk 4096
        # (one chunk at these token grids)
        unet=UNetConfig(nerf_dtype="bfloat16", nerf_chunk_size=4096),
        compute_dtype="bfloat16", num_sample_steps=STEPS,
    )
    t0 = time.time()
    eng = Engine(cfg, device="cuda")
    params = perturb_zero_leaves(torch, eng.init_params(seed=0), seed=5)
    n_params = sum(p.numel() for p in _leaves(params["unet"]))
    guider = vanilla_cfg_img_ref(scale=7.5)
    cams = make_cameras(torch, N_REF, guider.num_copies, "cuda")
    refs = make_references(torch, cfg.unet, N_REF, LATENT, "cuda")
    cond = make_cond(torch, cfg.unet, 1, "cuda", torch.bfloat16, seed=2)
    uc = make_cond(torch, cfg.unet, 1, "cuda", torch.bfloat16, seed=3)
    noise = torch.randn((1, LATENT, LATENT, 4),
                        generator=torch.Generator(device="cuda").manual_seed(4), device="cuda")
    torch.cuda.synchronize()
    log(f"[main] params: UNet {n_params / 1e9:.3f} B bf16, setup {time.time() - t0:.1f} s")

    def run(prof=None, num_steps=None):
        marks = []

        def cb(i):
            torch.cuda.synchronize()
            marks.append(time.perf_counter())
            if prof is not None and i + 1 in TRACE_STEPS:
                (prof.start if i + 1 == TRACE_STEPS[0] else prof.stop)()

        torch.cuda.synchronize()
        start = time.perf_counter()
        z = eng.sample(params, cond, uc, guider, noise=noise, cams=cams, references=refs,
                       choices=list(range(N_REF)), num_steps=num_steps, callback=cb)
        t_dec = time.perf_counter()
        img = eng.decode_first_stage(params, z.to(torch.bfloat16))
        torch.cuda.synchronize()
        end = time.perf_counter()
        steps = [b - a for a, b in zip([start] + marks[:-1], marks)]
        return z, img, steps, end - t_dec, end - start

    run()  # warm-up: library handles, cuDNN plans, allocator
    for c in counters.values():
        c.launches = 0
        c.launches_by_shape.clear()
    torch.cuda.reset_peak_memory_stats()
    z, img, steps, t_decode, t_total = run()
    launches = {k: c.launches for k, c in counters.items()}
    by_shape = {(k, shape): n for k, c in counters.items()
                for shape, n in c.launches_by_shape.items()}
    peak = torch.cuda.max_memory_allocated()

    imgf = img.float()
    ok = (tuple(img.shape) == (1, 8 * LATENT, 8 * LATENT, 3)
          and bool(torch.isfinite(imgf).all()) and float(imgf.std()) > 1e-3
          and bool(torch.isfinite(z).all()))
    cached = steps[1:]
    log(f"[main] steps {len(steps)}: render step {steps[0] * 1e3:.1f} ms, cached step "
        f"mean {sum(cached) / len(cached) * 1e3:.1f} ms (min {min(cached) * 1e3:.1f}, "
        f"max {max(cached) * 1e3:.1f}), decode {t_decode * 1e3:.1f} ms, "
        f"sample+decode {t_total:.2f} s")
    log(f"[main] peak memory allocated {peak / 2**30:.2f} GiB; launches {json.dumps(launches)}")
    for (k, shape), n in sorted(by_shape.items()):
        log(f"[main] launches {k} {shape}: {n}")
    log(f"[main] image {tuple(img.shape)} mean {float(imgf.mean()):.4f} std "
        f"{float(imgf.std()):.4f} latent std {float(z.std()):.4f} {'OK' if ok else 'FAIL'}")
    print(json.dumps({"main_path": {
        "render_step_ms": steps[0] * 1e3, "cached_step_ms": sum(cached) / len(cached) * 1e3,
        "decode_ms": t_decode * 1e3, "sample_decode_s": t_total,
        "peak_gib": peak / 2**30, "launches": launches}}), flush=True)
    if not ok:
        raise RuntimeError("main path output is not a finite, non-constant 1024^2 image")
    # a short run with two cached steps traced, after the timed run: the
    # profiler slows the host's launches for the rest of the process
    prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                              torch.profiler.ProfilerActivity.CUDA])
    run(prof, num_steps=TRACE_STEPS[1])
    report_trace(torch, prof, sum(cached) / len(cached) * 1e3)
    del params, eng
    torch.cuda.empty_cache()
    return launches, by_shape


TRACE_STEPS = (2, 4)  # sampler steps [2, 4) of a 4-step run, both cached
KERNEL_GROUPS = (  # device kernels by name, first match wins
    ("attention kernel", ("attn_fwd_kernel",)),
    ("bilinear kernel", ("bilinear_kernel",)),
    ("convolution", ("fprop", "conv", "implicit", "cudnn", "dgrad", "wgrad")),
    ("matmul f32 (no tensor cores)", ("gemm_f32f32", "sgemm")),
    ("matmul bf16", ("gemm", "gemv", "nvjet", "xmma", "cutlass", "cublas")),
    ("norm/softmax/reduce", ("norm", "softmax", "reduce")),
    ("copy/cast/cat/layout", ("copy", "cat", "memcpy", "memset", "transpose",
                              "nchwtonhwc", "nhwctonchw")),
)


def report_trace(torch, prof, step_ms):
    """Device time per traced cached step, by kernel group, and the device's
    busy share of ``step_ms``, the cached step's wall time without the
    profiler."""
    from torch.autograd import DeviceType

    n = TRACE_STEPS[1] - TRACE_STEPS[0]
    groups, kernels = {}, []
    for evt in prof.key_averages():
        if evt.device_type != DeviceType.CUDA:
            continue
        ms = getattr(evt, "self_device_time_total", 0) / 1e3 / n
        name = evt.key.lower()
        group = next((g for g, keys in KERNEL_GROUPS if any(k in name for k in keys)),
                     "elementwise/other")
        groups[group] = groups.get(group, 0.0) + ms
        kernels.append((ms, evt.count // n, evt.key))
    busy = sum(groups.values())
    if busy == 0.0:
        log("[trace] the profiler recorded no device time: breakdown not measured")
        return
    log(f"[trace] cached step: device busy {busy:.2f} ms of {step_ms:.2f} ms wall "
        f"(idle share {1 - busy / step_ms:.3f}); "
        f"{sum(c for _, c, _ in kernels)} kernel launches per step")
    for group, ms in sorted(groups.items(), key=lambda kv: -kv[1]):
        log(f"[trace]   {group:28s} {ms:8.2f} ms/step {ms / busy:6.1%}")
    for ms, count, name in sorted(kernels, reverse=True)[:12]:
        log(f"[trace]   top {ms:8.2f} ms/step x{count:<4d} {name[:110]}")


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


# ---------------------------------------------------------------------------
# phase 4: kernels vs plain versions through a whole small sample
# ---------------------------------------------------------------------------

SMALL_UNET = dict(
    model_channels=64, channel_mult=(1, 2), transformer_depth=(1, 2),
    attention_resolutions=(2,), context_dim=64, adm_in_channels=32,
    num_head_channels=64, image_cross_blocks=(0, 1), poscontrol_interval=1,
    num_samples=8, num_freqs=4, nerf_chunk_size=0,
)
SMALL_VAE = dict(ch=16, ch_mult=(1, 2, 4, 4), num_res_blocks=1)  # bottleneck d = 64
SMALL_TOL = 5e-2  # relative to max|ref|: bf16 kernels + bf16 UNet vs f32 plain


def run_small_check(torch):
    """A 3-step, 2-view sample + decode at latent 32 (256 tokens per pose
    block, so self-attention reaches the kernel): bf16 through the kernels
    on the card vs f32 through the plain versions on the CPU."""
    from custom_diffusion360_torch.diffusion.guiders import vanilla_cfg_img_ref
    from custom_diffusion360_torch.engine import Engine, EngineConfig
    from custom_diffusion360_torch.models.unet import UNetConfig
    from custom_diffusion360_torch.models.vae import VAEConfig

    n_ref, latent = 2, 32
    base = EngineConfig(unet=UNetConfig(**SMALL_UNET), vae=VAEConfig(**SMALL_VAE))
    params = Engine(base, device="cpu").init_params(seed=0, dtype=torch.float32)
    params = perturb_zero_leaves(torch, params, seed=5)
    refs = make_references(torch, base.unet, n_ref, latent, "cpu")
    cond = make_cond(torch, base.unet, 1, "cpu", torch.float32, seed=2)
    uc = make_cond(torch, base.unet, 1, "cpu", torch.float32, seed=3)
    noise = torch.randn((1, latent, latent, 4), generator=torch.Generator().manual_seed(4))
    guider = vanilla_cfg_img_ref(scale=7.5)
    outs = {}
    for device, dtype in (("cpu", torch.float32), ("cuda", torch.bfloat16)):
        cfg = EngineConfig(unet=UNetConfig(**SMALL_UNET, nerf_dtype=str(dtype)[6:]),
                           vae=VAEConfig(**SMALL_VAE), compute_dtype=str(dtype)[6:])
        eng = Engine(cfg, device=device)
        p = _map(params, lambda x: x.to(device, dtype))
        z = eng.sample(
            p, {k: v.to(device, dtype) for k, v in cond.items()},
            {k: v.to(device, dtype) for k, v in uc.items()}, guider, noise=noise,
            cams=make_cameras(torch, n_ref, guider.num_copies, device),
            references=_map(refs, lambda x: x.to(device)), choices=list(range(n_ref)),
            num_steps=3,
        )
        img = eng.decode_first_stage(p, z.to(dtype))
        outs[device] = (z.float().cpu(), img.float().cpu())
    errs = []
    for i, what in enumerate(("latent", "image")):
        ref, got = outs["cpu"][i], outs["cuda"][i]
        err = float((got - ref).abs().max())
        tol = SMALL_TOL * max(1.0, float(ref.abs().max()))
        errs.append(err <= tol)
        log(f"[small] {what} {tuple(ref.shape)}: max-abs err cuda-bf16 vs cpu-f32 "
            f"{err:.4e} (tol {tol:.4e}, max|ref| {float(ref.abs().max()):.3f}) "
            f"{'OK' if err <= tol else 'FAIL'}")
    if not all(errs):
        raise RuntimeError("small-config sample on the card disagrees with the CPU")


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map(v, fn) for v in tree]
    return fn(tree)


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    from custom_diffusion360_torch.ops import _build
    from custom_diffusion360_torch.ops.block_attention import attention_fwd
    from custom_diffusion360_torch.ops.onehot_sample import bilinear_sample

    log(gpu_line())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"[setup] torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()} "
        f"matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}")

    t0 = time.time()
    times = _build.build()
    log(f"[build] {json.dumps({k: round(v, 2) for k, v in times.items()})} "
        f"wall {time.time() - t0:.1f} s")
    for name, text in _build.BUILD_LOGS.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line or "error" in line:
                log(f"[build] {name}: {line.strip()}")

    results = []
    check_attention(torch, results)
    check_bilinear(torch, results)
    failed = [r["name"] for r in results if not r["ok"]]

    if failed:
        print(f"chip_smoke: kernels disagree with their plain versions: {failed}",
              file=sys.stderr)
        return 1

    counters = {"attention": attention_fwd, "bilinear": bilinear_sample}
    launches, by_shape = run_main_path(torch, counters)
    run_small_check(torch)
    missing = [k for k, n in launches.items() if n == 0]
    if missing:
        print(f"chip_smoke: main path never launched {missing}", file=sys.stderr)
        return 1
    unchecked = sorted(set(by_shape) - {r["_key"] for r in results})
    if unchecked:
        print(f"chip_smoke: main path launched shapes with no kernel check {unchecked}",
              file=sys.stderr)
        return 1
    for r in results:
        r["launches"] = by_shape.get(r.pop("_key"), 0)
        r.pop("ok")
    # shapes the 1024^2 main path does not launch (512^2, kv_len masking, the
    # unpadded scalar path) are checked and timed all the same
    print(json.dumps({"off_path_kernel_checks": [r for r in results if not r["launches"]]}),
          flush=True)
    print(json.dumps({"kernels": [r for r in results if r["launches"]]}), flush=True)
    log(gpu_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
