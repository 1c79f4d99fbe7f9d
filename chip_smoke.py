#!/usr/bin/env python
"""Smoke test of the PyTorch/CUDA port (custom_diffusion360_torch) on one GPU.

    python3 chip_smoke.py    # needs one CUDA card

Phases:
  1. build every kernel under custom_diffusion360_torch/csrc with nvcc
     (one process per source, all started together); print ptxas's
     registers, shared memory and spills (every ptxas line of the wgmma +
     TMA kernels), and count the wgmma (HGMMA) and TMA (UTMALDG)
     instructions in the SASS (cuobjdump) of the d = 64 and d = 512
     attention kernels and of the 3x3 conv, which must both be there in
     each, and which must not spill registers; the bilinear backward's
     SASS must hold no global atomic or reduction (RED, ATOMG);
  2. hold each kernel against its plain PyTorch version (max-abs error vs a
     stated tolerance) and time kernel, plain version and the one-call
     PyTorch yardstick (SDPA, F.grid_sample and its backward, F.layer_norm,
     F.group_norm + F.silu), beside the least time the card could take
     (bound): fixed attention and bilinear cases first, then every other
     (kernel, shape) that the main paths below launched, attention in the
     layout it was launched in (packed to_qkv view, (b, n, h, d) views or
     contiguous (b, h, n, d): the sm90 kernel's TMA maps follow the
     strides); the bilinear backward also on clustered points, and two of
     its launches must agree bit for bit. Every row also carries
     ``device_ms``: the time per launch
     on the device alone, from a CUDA-graph replay of GRAPH_CALLS calls (no
     host time between launches), and the same for the library call
     (``library_device_ms``);
  3. the sampling path: full-width SDXL, 12 FeatureNeRF pose blocks, 1024^2,
     batch 1, CFG x2 (vanilla_cfg_img_ref, scale 7.5), 8 reference views,
     50 Euler-EDM steps with the render cached after step 0, then
     decode_first_stage. After a warm-up run, launch counters (per kernel
     and per shape) are zeroed just before the timed run and read just
     after; a short run then traces two cached steps with torch.profiler
     (device time by kernel group, idle share);
  4. the training path: Trainer.train_step -> Engine.training_loss at the
     same width with both text towers (CLIP-L, OpenCLIP bigG, one V* row
     each) and the VAE encoder, 512^2, batch 1, 1 target + 4 reference
     views, trainkeys "pose", AdamW; one warm-up step, then TRAIN_STEPS
     timed steps with the counters zeroed just before and read just after,
     then one traced step;
  5. the sampling CLI as users run it (custom_diffusion360_torch.cli.sample
     main(), in-process): full-width SDXL with random weights, a delta .npz
     of reference buffers at the real shapes and a 20/7-view ring cameras
     .npz written by the port's own savers, 1024^2, batch 1, one image,
     the x3 image+text guider (scale 7.5, scale_im 3.5) with both dedupes,
     50 steps, 8 reference views, CD360_VAE_CONV=pallas (the VAE's 3x3 convs
     through the conv3x3 kernel) and CD360_ATTN_BNHD=1 (long-KV attention
     through the (b, n, h, d) route). A 2-step warm-up, the timed run with
     the counters zeroed just before and read just after, then a 4-step run
     with two cached steps traced;
  5b. the training CLI as users run it (custom_diffusion360_torch.cli.train
     main(), in process) on a synthetic CO3D tree (40 frames of 820 x 760,
     masks, bboxes, ring cameras, annotations): full-width SDXL in bf16,
     random weights from --seed 23, 512^2, 1 + 4 views, 4 steps, EMA, a
     step delta, a full checkpoint and a validation loss at step 2, then
     --sample_every 2 --log_steps_increase preview grids at steps 1 and 2
     (Engine.log_images: an 8-step x2 live-reference sample, the decodes
     and the FeatureNeRF diagnostics; every grid must be written), then
     the capture of the 20 valid frames and the delta export; then the
     sampling CLI on that delta and cameras at 512^2 (the capture's token
     grids), x3, 4 steps, both switches. Counters zeroed just before the
     training call and read after the sample (path "train_cli");
  5c. every other sampler through the sampling CLI at the phase-5 settings
     (1024^2, x3, 8 views, both switches, the same delta), 8 steps each:
     heun_edm, euler_ancestral, dpmpp2s_ancestral, dpmpp2m, lms, and
     euler_edm on the EDM schedule (--override discretization_name=edm),
     each with its network evaluations, image latency and median cached
     step; then Engine.samplemulti, 2 views of a 512^2 window, 4 steps,
     decoded. Counters zeroed before the first run and read after
     samplemulti (path "samplers");
  5d. parallelism (custom_diffusion360_torch.parallel) in a one-rank NCCL
     world: the training CLI at the [train-cli] configuration for 2 steps,
     plain and under --multihost (the group comes up there), losses within
     1e-3 relative; the sampling CLI at the [cli] configuration for 4
     steps, plain and with --latency_shard, images within 1 of 255;
     Engine.sample at the [main] configuration for 4 steps on
     tensor-parallel slices (the world as the model group) and with the
     CFG rows over the world (cfg_group), latents within 1e-3 of
     max|plain|; and Engine.sample at that configuration on a 1 x 1 (cfg,
     view) grid from new_groups_2d with cfg_group and view_group both set
     (the view-sharded render), its latent within 1e-3 of max|plain| and
     its render step's time beside the plain one's. Counters zeroed before
     the first run and read after the last (path "parallel"); the group is
     destroyed after it;
  5e. the evaluation CLI as users run it (custom_diffusion360_torch.cli.
     evaluate main(), in process) at full width with random weights from
     seeds: pytorch_fid-named InceptionV3 and open_clip ViT-H/14 (vision and
     text tower) checkpoints, a synthetic BPE merges file and 32 + 32 512^2
     PNGs written to a temp dir; FID (299^2), CLIP-T and CLIP-I (224^2) at
     batch 8, then the generated set against itself: FID 0 within 1e-3,
     CLIP-I 1 within 1e-4. Prints each checkpoint's load time, images/s
     through Inception and the vision tower, the Frechet distance's host
     time and the scores. Counters zeroed before and read after (path
     "evaluate");
  5f. the autoencoder trainer (custom_diffusion360_torch.train.ae_engine,
     AEEngine.train_step) at full width: the SDXL VAE trained with the KL
     posterior, LPIPS on the full VGG16 and the PatchGAN (ndf 64, 3 layers)
     read from seeded checkpoints at their torch layouts, hinge loss from
     step 0, 4 bf16 images of 256^2, CD360_VAE_CONV=pallas: one warm-up
     step, TRAIN_STEPS timed steps with the counters zeroed just before and
     read just after (path "ae_train"), one traced step; the step median and
     spread, every log value of the last step (finite), both sides' update
     norms (nonzero), peak memory;
  5g. the rest of the sgm model surface (custom_diffusion360_torch.models.
     t5, embedders, general_conditioner, encoder_unet, extra_blocks) at
     published widths, bf16, random weights from seeds: T5-v1.1 XXL on
     2 x 77 tokens (beside the time to read its 9.5 GB of weights once),
     clip_t5_encode (CLIP-L + T5-v1.1 XL), ByT5 through byt5_tokenize, the
     general conditioner on the SDXL stack (target + 8 reference rows, held
     to apply_conditioner within 1e-2 of max|ref|), open_clip_embedder2
     (bigG, penultimate, pooled), open_clip_image_embedder (ViT-H/14, UCG
     0.1, batch 8), guided-diffusion's 256^2 classifier (EncoderUNet,
     attention pool, batch 8), the DDPM LSUN-256 model (batch 4; vanilla
     and linear attention), the single-layer block at width 1280 over 1024
     tokens (self and a 77 x 2048 context), the SDXL VAE through
     low_scale_encode -> low_scale_decode (CD360_VAE_CONV=pallas) and
     gaussian_encoder (batch 2, 512^2): each model's median of 5 calls after
     a warm-up, peak memory and launches per call. Counters zeroed before
     the first model and read after the last (path "aux");
  6. small configurations run twice, on the card through the kernels (bf16)
     and on the CPU through the plain versions (f32): a 3-step sample +
     decode, whose latent and image must agree, a 3-step x3 CLI sample
     (--smoke, both switches on), whose images must agree, one training
     step, whose loss and trainable gradients must agree, a capture of
     reference features, whose buffers must agree, a 3-step sample with
     each of the six samplers, an 8-step log_images, whose every image must
     agree, and a 3-step samplemulti; then the evaluation's towers in
     float32 (Inception with cuDNN's TF32 off; small CLIP vision and text
     towers): pool3 features, the image embedding, CLIP-T and CLIP-I within
     1e-3 of max|ref|; one AEEngine.train_step at the ae1 golden's
     configuration with LPIPS on, whose logs and gradients must agree, and
     nerf_encoding_apply (the bilinear kernel), whose output must agree;
     last, the five auxiliary modules at the CPU tests' tiny sizes (bf16 on
     the card vs f32 on the CPU, within 5e-2 of max(1, max|ref|)), and the
     T5 position bias on the card equal to the CPU's bit for bit.

``ms`` is a call's time with the host in it (events around many calls in
a row), as the main paths pay it; ``device_ms`` is the kernel's own.

Every kernel must launch on a main path (the bilinear backward on the
training paths, conv3x3 and the bnhd route on the CLI paths, LayerNorm on
the evaluation path; GroupNorm, the d = 512 attention and conv3x3 on the
autoencoder trainer's; GroupNorm, LayerNorm, the attention and conv3x3 on
the auxiliary models'), and every shape
a main path launched must have passed phase 2. Prints the card's name and
power limit first, a JSON line per main path, per kernel source and path
the sums over the timed run's launches of device time, library device time
and bound (``[sums]``, ``{"kernel_sums": ...}``), the phase-2 rows of
shapes no main path launched, a
``{"kernels": [...]}`` line (one row per launched shape, with its launches
in the timed runs), the card line again and, last, ``{"ok": true,
"device": {...}}``. Any failed phase exits non-zero without the last line.
Weights are random, made from a seed.
"""
from __future__ import annotations

import json
import math
import os
import re
import statistics
import subprocess
import sys
import time

H100_BF16_FLOPS = 989e12  # dense tensor-core peak, H100 SXM data sheet
H100_F32_FLOPS = 67e12  # float32 outside the tensor cores, H100 SXM data sheet
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


GRAPH_CALLS = 20  # calls captured in one CUDA graph for device_ms


def graph_ms(fn, calls=GRAPH_CALLS, replays=5, stream=None):
    """Mean device time of ``fn()`` in ms, from replays of a CUDA graph that
    captured ``calls`` calls of it: the host's per-call cost is out of the
    timing. ``fn`` is called once first (outside the capture) so that any
    one-time set-up has happened. ``stream``: the capture stream (a
    backward runs on its forward's stream, so its forward ran there)."""
    import torch

    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / (replays * calls)
    del graph
    return ms


def bound(nbytes, flops, peak=H100_BF16_FLOPS):
    """(least ms, "bytes" or "operations"): bytes at the HBM rate vs
    operations at ``peak`` FLOP/s."""
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    t_ops = flops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# the wgmma + TMA kernels: every ptxas line of their builds is printed, and
# their SASS must hold HGMMA and UTMALDG
WGMMA_KERNELS = ("attention_sm90", "attention512_sm90", "conv3x3")
SM90_OPCODES = ("HGMMA", "UTMALDG", "UTMASTG", "SYNCS", "MUFU.EX2")
# the bilinear backward owns its sums in shared memory: its SASS must hold
# no global atomic or reduction (RED, ATOMG), and it loads g by TMA
ATOMIC_OPCODES = ("RED", "ATOMG", "UTMALDG")


def sass_counts(name, opcodes):
    """Instructions of each opcode in the SASS of ``csrc/<name>.cu``'s
    built library, from ``cuobjdump -sass`` (beside nvcc)."""
    from custom_diffusion360_torch.ops import _build

    cuobjdump = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", str(_build.library_path(name))],
                          capture_output=True, text=True, timeout=120, check=True).stdout
    lines = sass.splitlines()
    # an opcode as a whole word: RED.E.ADD counts as RED, REDUX does not
    return {op: sum(bool(re.search(rf"\b{re.escape(op)}\b", line)) for line in lines)
            for op in opcodes}


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

ATTN_CASES = [
    # (label, b, h, n, m, d, kv_len, layout of the operands, TPU kernel
    # replaced); layouts as ops/block_attention.layout_of names them
    ("ds2 self-attn qkv-packed", 2, 10, 4096, 4096, 64, None, "packed",
     "custom_diffusion360_tpu/ops/block_attention.py:275"),
    ("ds4 self-attn qkv-packed", 2, 20, 1024, 1024, 64, None, "packed",
     "custom_diffusion360_tpu/ops/block_attention.py:275"),
    ("512^2 ds2 self-attn", 2, 20, 256, 256, 64, None, "bhnd",
     "custom_diffusion360_tpu/ops/block_attention.py:123"),
    ("kv_len-masked", 2, 20, 1024, 384, 64, 300, "bnhd",
     "custom_diffusion360_tpu/ops/block_attention.py:123"),
    ("VAE mid-block d512", 1, 1, 16384, 16384, 512, None, "bhnd",
     "custom_diffusion360_tpu/ops/attention.py:149"),
    # d = 512 at the training encoder's shapes: b = 1 splits the keys in two
    # on 132 SMs (ops/block_attention.split_count), b = 4 does not
    ("train VAE encoder d512", 1, 1, 4096, 4096, 512, None, "bhnd",
     "custom_diffusion360_tpu/ops/block_attention.py:123"),
    ("train VAE encoder refs d512", 4, 1, 4096, 4096, 512, None, "bhnd",
     "custom_diffusion360_tpu/ops/block_attention.py:123"),
    # kv_len inside the first split: the second has no live key (weight 0)
    ("kv_len-masked d512, split 2 empty", 1, 1, 4096, 4096, 512, 1500, "bhnd",
     "custom_diffusion360_tpu/ops/block_attention.py:123"),
    # (b, n, h, d) views with two heads: 1024-byte head steps inside a row
    ("d512 bnhd h2", 2, 2, 1024, 1024, 512, None, "bnhd",
     "custom_diffusion360_tpu/ops/block_attention.py:218"),
]
ATTN_SOURCES = {64: "custom_diffusion360_torch/csrc/attention_sm90.cu",
                512: "custom_diffusion360_torch/csrc/attention512_sm90.cu"}
# bf16 kernel (bf16 P in P.V, bf16 output) vs the f32 plain version on the
# same bf16 inputs: one bf16 rounding of the largest output is at most 2**-8
# of max|ref|, the bf16 P adds about 2**-9 of an output
ATTN_TOL = 1e-2  # of max|ref|

BILINEAR_CASES = [
    # (label, M, side, C launched, C needed, P, maps dtype): the FeatureNeRF
    # reader needs C + 1 = 641/1281 channels, padded to 648/1288 on the main
    # paths; the bound counts the needed channels only
    ("ds2 pose block", 16, 64, 648, 641, 98304, "bf16"),
    ("ds4 pose block", 16, 32, 1288, 1281, 24576, "bf16"),
    ("ds2 unpadded odd C", 16, 64, 641, 641, 98304, "bf16"),
    # a rank's share of a 4-way view split of the x2 render (2 rows x 2 of
    # the 8 views), which a one-rank world cannot launch
    ("ds2 pose block, 4-way view split", 4, 64, 648, 641, 98304, "bf16"),
    ("ds4 pose block, 4-way view split", 4, 32, 1288, 1281, 24576, "bf16"),
]
BILINEAR_TOL = 1e-2  # relative to max|ref|: one bf16 rounding of the output
# f32 kernels vs their f32 plain versions: the same sums in another order
# (the bilinear backward's order is fixed: per pixel in point order, then
# the point splits in order)
F32_TOL = 1e-5  # relative to max|ref|
NORM_TOL_BF16 = 1e-2  # relative to max|ref|: one bf16 rounding of the output
DT = {}  # torch dtype <-> "bf16" / "f32", filled in main()


def needed_channels(c):
    """The FeatureNeRF maps carry dim + 1 channels padded to a multiple of 8
    (models/nerf.project_ref_maps); the bound counts the dim + 1."""
    return {648: 641, 1288: 1281}.get(c, c)


def budget_ms(elements):
    """Timing budget: enough launches for a steady mean at the big shapes,
    few at the many small norm shapes so phase 2 stays short."""
    return 150.0 if elements > 1 << 22 else 60.0


def attention_operands(torch, gen, b, h, n, m, d, layout):
    """q (b, h, n, d) and k, v (b, h, m, d) bf16 N(0, 1) in ``layout``:
    "packed" (views of one (b, n, 3*h*d) to_qkv output; n == m), "bnhd"
    (views of (b, n, h, d) storage) or "bhnd" (contiguous). Returns (q, k,
    v, q5): q5 the packed (b, 3, h, n, d) view, else None."""
    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda", dtype=torch.bfloat16)

    if layout == "packed":
        q5 = randn(b, n, 3 * h * d).view(b, n, 3, h, d).permute(0, 2, 3, 1, 4)
        return q5[:, 0], q5[:, 1], q5[:, 2], q5
    if layout == "bnhd":
        return (randn(b, n, h, d).transpose(1, 2), randn(b, m, h, d).transpose(1, 2),
                randn(b, m, h, d).transpose(1, 2), None)
    if layout == "bhnd":
        return randn(b, h, n, d), randn(b, h, m, d), randn(b, h, m, d), None
    raise ValueError(f"no phase-2 operands for attention layout {layout!r}")


def check_attention(torch, results, cases=ATTN_CASES):
    import torch.nn.functional as F

    from custom_diffusion360_torch.ops.block_attention import (
        attention_plain,
        block_attention,
        block_attention_qkv_fused,
        layout_of,
        splits_launched,
    )

    gen = torch.Generator(device="cuda").manual_seed(0)
    for label, b, h, n, m, d, kv_len, layout, replaces in cases:
        scale = d**-0.5
        q, k, v, q5 = attention_operands(torch, gen, b, h, n, m, d, layout)
        assert layout_of(q) == layout, (layout_of(q), layout)
        if q5 is not None:
            run = lambda: block_attention_qkv_fused(q5, scale)  # noqa: E731
        else:
            run = lambda: block_attention(q, k, v, scale, kv_len)  # noqa: E731
        splits_launched.clear()
        got = run()
        torch.cuda.synchronize()
        splits = splits_launched[(b, h, n, m, d)]  # as the launch ran it
        ref = attention_plain(q.float(), k.float(), v.float(), scale, kv_len)
        err = float((got.float() - ref).abs().max())
        ref_max, ref_rms = float(ref.abs().max()), float(ref.square().mean().sqrt())
        tol = ATTN_TOL * ref_max
        ok = math.isfinite(err) and err <= tol
        del ref
        ms = time_ms(run, budget_ms=budget_ms(n * m * b * h))
        dev_ms = graph_ms(run)
        plain_ms = time_ms(lambda: attention_plain(q, k, v, scale, kv_len), max_iters=5)
        mask = None
        if kv_len is not None:
            mask = (torch.arange(m, device="cuda") < kv_len).expand(n, m)
        sdpa = lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask, scale=scale)  # noqa: E731
        lib_ms, lib_dev_ms = time_ms(sdpa), graph_ms(sdpa)
        keys = m if kv_len is None else kv_len
        nbytes = 2 * (b * h * n * d * 2 + b * h * keys * d * 2)
        bms, by = bound(nbytes, 4.0 * b * h * n * keys * d)
        results.append(dict(
            name=f"attention_fwd [{label} b{b} h{h} n{n} m{m} d{d}"
                 + (f" kv_len{kv_len}" if kv_len else "") + f" {layout}]",
            route="cuda", source=ATTN_SOURCES[d], replaces=replaces, layout=layout,
            max_abs_err=err, tol=tol, ref_rms=ref_rms, ms=ms, device_ms=dev_ms,
            plain_ms=plain_ms, bound_ms=bms, bound_by=by, library_ms=lib_ms,
            library_device_ms=lib_dev_ms, device_ms_from="CUDA-graph replay",
            splits=splits,
            ok=ok, _key=("attention", (b, h, n, m, d, keys, layout)),
        ))
        log(f"[kernels] attention {label} ({layout}, {splits} key split(s)): err {err:.3e} (tol {tol:.3e} = {ATTN_TOL} "
            f"x max|ref| {ref_max:.4f}; ref rms {ref_rms:.4f}) "
            f"kernel {ms:.4f} ms (device {dev_ms:.4f}) plain {plain_ms:.3f} ms sdpa "
            f"{lib_ms:.4f} ms (device {lib_dev_ms:.4f}) bound {bms:.4f} ms ({by}; "
            f"{bms / dev_ms:.1%} of it on the device) {'OK' if ok else 'FAIL'}")


def check_bilinear(torch, results, cases=BILINEAR_CASES):
    import torch.nn.functional as F

    from custom_diffusion360_torch.ops.grid_sample import grid_sample_2d
    from custom_diffusion360_torch.ops.onehot_sample import bilinear_sample

    gen = torch.Generator(device="cuda").manual_seed(1)
    for label, mm, side, c, c_need, p, dt in cases:
        dtype = DT[dt]
        feats = torch.randn((mm, side, side, c), generator=gen, device="cuda").to(dtype)
        # the FeatureNeRF grid range: clipped to +-1.2, with exact +-1 points
        grid = (torch.rand((mm, p, 2), generator=gen, device="cuda") * 2.4 - 1.2)
        grid[:, :64] = torch.tensor([1.0, -1.0], device="cuda")
        got = bilinear_sample(feats, grid)
        torch.cuda.synchronize()
        ref = grid_sample_2d(feats.float(), grid)
        scale_ref = max(1.0, float(ref.abs().max()))
        err = float((got.float() - ref).abs().max())
        tol = (BILINEAR_TOL if dtype == torch.bfloat16 else F32_TOL) * scale_ref
        ok = math.isfinite(err) and err <= tol
        run = lambda: bilinear_sample(feats, grid)  # noqa: E731
        ms, dev_ms = time_ms(run), graph_ms(run)
        plain_ms = time_ms(lambda: grid_sample_2d(feats, grid), max_iters=5)
        nchw = feats.permute(0, 3, 1, 2)
        g4 = grid[:, :, None, :].to(feats.dtype)  # grid_sample wants one dtype
        lib = lambda: F.grid_sample(nchw, g4, mode="bilinear",  # noqa: E731
                                    padding_mode="zeros", align_corners=True)
        lib_ms, lib_dev_ms = time_ms(lib), graph_ms(lib)
        isz = feats.element_size()
        nbytes = mm * side * side * c_need * isz + grid.numel() * 4 + mm * p * c_need * isz
        bms, by = bound(nbytes, 8.0 * mm * p * c_need, H100_F32_FLOPS)
        results.append(dict(
            name=f"bilinear_sample [{label} M{mm} {side}x{side} C{c} (needed {c_need}) P{p} "
                 f"{dt}]",
            route="cuda", source="custom_diffusion360_torch/csrc/bilinear_sample.cu",
            replaces="custom_diffusion360_tpu/ops/onehot_sample.py:263",
            max_abs_err=err, tol=tol, ms=ms, device_ms=dev_ms,
            plain_ms=plain_ms, bound_ms=bms, bound_by=by, library_ms=lib_ms,
            library_device_ms=lib_dev_ms, device_ms_from="CUDA-graph replay",
            ok=ok, _key=("bilinear", (mm, side, side, c, p, dt)),
        ))
        log(f"[kernels] bilinear {label}: err {err:.3e} (tol {tol:.3e}) "
            f"kernel {ms:.4f} ms (device {dev_ms:.4f}) plain {plain_ms:.3f} ms grid_sample "
            f"{lib_ms:.4f} ms (device {lib_dev_ms:.4f}) bound {bms:.4f} ms ({by}; "
            f"{bms / dev_ms:.1%} of it on the device) {'OK' if ok else 'FAIL'}")
        del feats, grid, got, ref
        torch.cuda.empty_cache()


def _norm_params(torch, gen, c, dtype):
    """Scale and bias in ``dtype``, as the models on the card pass them (both
    norm kernels read them as they are)."""
    scale = torch.randn((c,), generator=gen, device="cuda") * 0.1 + 1.0
    return scale.to(dtype), torch.randn((c,), generator=gen, device="cuda").to(dtype)


def _norm_tol(torch, dtype):
    return NORM_TOL_BF16 if dtype == torch.bfloat16 else F32_TOL


def check_layer_norm(torch, results, shapes):
    """LayerNorm kernel vs ``_ln_plain`` at (rows, C, x dtype, parameter
    dtype); yardstick F.layer_norm. Inputs N(1, 3^2): an offset the
    statistics must survive. Timed as the sampling paths call it, under
    inference mode (no autograd Function)."""
    import torch.nn.functional as F

    from custom_diffusion360_torch.ops.norms import _ln_plain, layer_norm_fused

    gen = torch.Generator(device="cuda").manual_seed(2)
    for rows, c, dt, pdt in shapes:
        dtype = DT[dt]
        x = (torch.randn((rows, c), generator=gen, device="cuda") * 3.0 + 1.0).to(dtype)
        s, b = _norm_params(torch, gen, c, DT[pdt])
        got = layer_norm_fused(x, s, b, 1e-5)
        torch.cuda.synchronize()
        ref = _ln_plain(x.float(), s, b, 1e-5)
        err, tol = float((got.float() - ref).abs().max()), _norm_tol(torch, dtype) * float(
            ref.abs().max())
        budget = budget_ms(rows * c)
        run = lambda: layer_norm_fused(x, s, b, 1e-5)  # noqa: E731
        s_lib, b_lib = s.to(dtype), b.to(dtype)  # F.layer_norm's parameters in x's dtype
        lib = lambda: F.layer_norm(x, (c,), s_lib, b_lib, 1e-5)  # noqa: E731
        with torch.inference_mode():
            ms, dev_ms = time_ms(run, budget_ms=budget), graph_ms(run)
            plain_ms = time_ms(lambda: _ln_plain(x, s, b, 1e-5), budget_ms=budget, max_iters=5)
            lib_ms, lib_dev_ms = time_ms(lib, budget_ms=budget), graph_ms(lib)
        bms, by = bound(2 * x.numel() * x.element_size() + 2 * c * s.element_size(), 8.0 * x.numel(),
                        H100_F32_FLOPS)
        _row(results, f"layer_norm_fused [rows{rows} C{c} {dt} params {pdt}]",
             "custom_diffusion360_torch/csrc/layer_norm.cu",
             "custom_diffusion360_tpu/ops/norms.py:64", err, tol, ms, plain_ms, bms, by, lib_ms,
             ("layer_norm", (rows, c, dt, pdt)), "F.layer_norm", dev_ms, lib_dev_ms)


def check_group_norm(torch, results, shapes):
    """GroupNorm(+SiLU) kernel vs ``_gn_plain`` at (N, HW, C, G, act,
    dtype); yardstick F.group_norm (+ F.silu) on the channels-last view.
    Inputs N(20, 0.5^2): a one-pass E[x^2] - E[x]^2 would lose the variance.
    Timed as the sampling paths call it, under inference mode (no autograd
    Function)."""
    import torch.nn.functional as F

    from custom_diffusion360_torch.ops.norms import _gn_plain, group_norm_fused

    gen = torch.Generator(device="cuda").manual_seed(3)
    for n, hw, c, g, act, dt in shapes:
        dtype, act = DT[dt], (None if act == "none" else act)
        x = (torch.randn((n, hw, c), generator=gen, device="cuda") * 0.5 + 20.0).to(dtype)
        s, b = _norm_params(torch, gen, c, dtype)
        got = group_norm_fused(x, s, b, g, 1e-6, act)
        torch.cuda.synchronize()
        ref = _gn_plain(x.float(), s, b, g, 1e-6, act)
        err, tol = float((got.float() - ref).abs().max()), _norm_tol(torch, dtype) * float(
            ref.abs().max())
        del got, ref
        budget = budget_ms(x.numel())
        run = lambda: group_norm_fused(x, s, b, g, 1e-6, act)  # noqa: E731
        xv = x.permute(0, 2, 1)  # (N, C, HW) view
        lib = (lambda: F.silu(F.group_norm(xv, g, s, b, 1e-6))) if act else (
            lambda: F.group_norm(xv, g, s, b, 1e-6))
        with torch.inference_mode():
            ms, dev_ms = time_ms(run, budget_ms=budget), graph_ms(run)
            plain_ms = time_ms(lambda: _gn_plain(x, s, b, g, 1e-6, act), budget_ms=budget,
                               max_iters=5)
            lib_ms, lib_dev_ms = time_ms(lib, budget_ms=budget), graph_ms(lib)
        bms, by = bound(2 * x.numel() * x.element_size() + 2 * c * s.element_size(),
                        (14.0 if act else 10.0) * x.numel(), H100_F32_FLOPS)
        _row(results, f"group_norm_fused [N{n} HW{hw} C{c} G{g} act {act or 'none'} {dt}]",
             "custom_diffusion360_torch/csrc/group_norm.cu",
             "custom_diffusion360_tpu/ops/norms.py:209", err, tol, ms, plain_ms, bms, by, lib_ms,
             ("group_norm", (n, hw, c, g, act or "none", dt)),
             "F.group_norm" + (" + F.silu" if act else ""), dev_ms, lib_dev_ms)
        del x
        torch.cuda.empty_cache()


def bwd_grid(torch, gen, mm, p, side, layout):
    """Points of the backward cases: "uniform" in [-1.2, 1.2] with the first
    64 on the corner (1, -1); "clustered", every point of each map within
    3 x 3 pixels around its middle pixel, as projected ray samples crowd a
    few pixels of a reference view (nine consumer warps of each block take
    every point, each point's corners in four of them)."""
    if layout == "uniform":
        grid = torch.rand((mm, p, 2), generator=gen, device="cuda") * 2.4 - 1.2
        grid[:, :64] = torch.tensor([1.0, -1.0], device="cuda")
        return grid
    pix = torch.rand((mm, p, 2), generator=gen, device="cuda") * 2 + (side // 2 - 1)
    return pix / (side - 1) * 2 - 1


def check_bilinear_bwd(torch, results, shapes):
    """W^T g kernel vs ``bilinear_sample_bwd_plain`` (autograd of the plain
    sampling) at (M, H, W, C, P, dtype), on uniform and on clustered points;
    two launches on the same inputs must agree bit for bit. Yardstick the
    backward of F.grid_sample with respect to its input (graph built once,
    outside the timing). The times cover the wrapper's launches: the kernel
    and, when the points split (``bwd_plans_launched``), the merge."""
    import torch.nn.functional as F

    from custom_diffusion360_torch.ops.onehot_sample import (
        bilinear_sample_bwd,
        bilinear_sample_bwd_plain,
        bwd_plans_launched,
    )

    gen = torch.Generator(device="cuda").manual_seed(4)
    for (mm, h, w, c, p, dt), layout in [(s, lay) for s in shapes
                                         for lay in ("uniform", "clustered")]:
        dtype = DT[dt]
        g = torch.randn((mm, p, c), generator=gen, device="cuda").to(dtype)
        grid = bwd_grid(torch, gen, mm, p, h, layout)
        fshape = (mm, h, w, c)
        got = bilinear_sample_bwd(g, grid, fshape, dtype)
        again = bilinear_sample_bwd(g, grid, fshape, dtype)
        torch.cuda.synchronize()
        bits = torch.int16 if dtype == torch.bfloat16 else torch.int32
        same = bool(torch.equal(got.view(bits), again.view(bits)))
        ref = bilinear_sample_bwd_plain(g.float(), grid, fshape, torch.float32)
        tol = (NORM_TOL_BF16 if dtype == torch.bfloat16 else F32_TOL) * float(ref.abs().max())
        err = float((got.float() - ref).abs().max())
        if not same:
            err = math.inf  # a launch that differs from the last one fails the row
        del got, again, ref
        run = lambda: bilinear_sample_bwd(g, grid, fshape, dtype)  # noqa: E731
        ms, dev_ms = time_ms(run), graph_ms(run)
        plain_ms = time_ms(lambda: bilinear_sample_bwd_plain(g, grid, fshape, dtype),
                           max_iters=5)
        feats = torch.zeros((mm, c, h, w), device="cuda", dtype=dtype)
        g4 = g.permute(0, 2, 1)[:, :, None, :]  # (M, C, 1, P), the grid_sample output's
        grid4 = grid[:, None].to(dtype)
        # the backward of F.grid_sample with respect to its input, as one op
        lib = lambda: torch.ops.aten.grid_sampler_2d_backward(  # noqa: E731
            g4, feats, grid4, 0, 0, True, [True, False])
        lib_ms, lib_dev_ms = time_ms(lib), graph_ms(lib)
        c_need, isz = needed_channels(c), g.element_size()
        nbytes = mm * p * c_need * isz + grid.numel() * 4 + mm * h * w * c_need * isz
        bms, by = bound(nbytes, 8.0 * mm * p * c_need, H100_F32_FLOPS)
        band_pix, splits = bwd_plans_launched[(mm, h, w, c, p, dt)]
        key = ("bilinear_bwd" if layout == "uniform" else "bilinear_bwd_clustered",
               (mm, h, w, c, p, dt))
        _row(results, f"bilinear_sample_bwd [M{mm} {h}x{w} C{c} (needed {c_need}) P{p} {dt} "
             f"{layout}; bands of {band_pix} px, {splits} split(s)]",
             "custom_diffusion360_torch/csrc/bilinear_sample_bwd.cu",
             "custom_diffusion360_tpu/ops/onehot_sample.py:224", err, tol, ms, plain_ms, bms,
             by, lib_ms, key, "grid_sample backward", dev_ms, lib_dev_ms)
        results[-1]["bitwise_repeat"] = same
        log(f"[kernels] bilinear_sample_bwd {layout}: two launches bitwise equal: {same}")
        del g, grid, feats, g4, grid4
        torch.cuda.empty_cache()


CONV_TOL = 1e-2  # of max|ref|: bf16 operands, f32 sums in another order, one bf16 rounding


def check_conv3x3(torch, results, shapes):
    """conv3x3 kernel (with its fused bias) vs ``conv3x3_plain`` + bias in
    f32 at (B, H, W, C, N); yardstick cuDNN's F.conv2d on the same bf16
    channels-last operands. Weights N(0, 1/(9C)): outputs O(1)."""
    import torch.nn.functional as F

    from custom_diffusion360_torch.ops.conv3x3 import conv3x3_fwd, conv3x3_plain

    gen = torch.Generator(device="cuda").manual_seed(6)
    for b, h, w, c, n in shapes:
        x = torch.randn((b, h, w, c), generator=gen, device="cuda").to(torch.bfloat16)
        wt = (torch.randn((n, c, 3, 3), generator=gen, device="cuda") * (9 * c) ** -0.5).to(
            torch.bfloat16)
        bias = (torch.randn((n,), generator=gen, device="cuda") * 0.1).to(torch.bfloat16)
        got = conv3x3_fwd(x, wt, bias)
        torch.cuda.synchronize()
        ref = conv3x3_plain(x.float(), wt.float()) + bias.float()
        err, tol = float((got.float() - ref).abs().max()), CONV_TOL * float(ref.abs().max())
        del got, ref
        run = lambda: conv3x3_fwd(x, wt, bias)  # noqa: E731
        ms, dev_ms = time_ms(run), graph_ms(run)
        plain_ms = time_ms(lambda: conv3x3_plain(x, wt) + bias, max_iters=5)
        xn = x.permute(0, 3, 1, 2)  # NCHW view of NHWC storage: channels-last
        wn = wt.contiguous(memory_format=torch.channels_last)
        lib = lambda: F.conv2d(xn, wn, bias, padding=1)  # noqa: E731
        lib_ms, lib_dev_ms = time_ms(lib), graph_ms(lib)
        nbytes = 2 * (x.numel() + wt.numel() + n + b * h * w * n)
        bms, by = bound(nbytes, 2.0 * b * h * w * n * 9 * c)
        _row(results, f"conv3x3 [B{b} {h}x{w} C{c} N{n} bias bf16]",
             "custom_diffusion360_torch/csrc/conv3x3.cu",
             "custom_diffusion360_tpu/ops/conv3x3.py:119", err, tol, ms, plain_ms, bms, by,
             lib_ms, ("conv3x3", (b, h, w, c, n)), "cuDNN F.conv2d", dev_ms, lib_dev_ms)
        del x, wt, bias
        torch.cuda.empty_cache()


def check_bnhd(torch, results, shapes):
    """The attention kernel on (b, n, h, d) operands (``attention_bnhd_fwd``)
    vs ``attention_plain`` on the transposed views, at (b, n, h, m, d,
    kv_len); yardstick SDPA on the same views."""
    import torch.nn.functional as F

    from custom_diffusion360_torch.ops.block_attention import attention_bnhd_fwd, attention_plain

    gen = torch.Generator(device="cuda").manual_seed(7)
    for b, n, h, m, d, kv in shapes:
        kv_len = None if kv == m else kv
        scale = d**-0.5
        q = torch.randn((b, n, h, d), generator=gen, device="cuda", dtype=torch.bfloat16)
        k = torch.randn((b, m, h, d), generator=gen, device="cuda", dtype=torch.bfloat16)
        v = torch.randn((b, m, h, d), generator=gen, device="cuda", dtype=torch.bfloat16)
        qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
        got = attention_bnhd_fwd(q, k, v, scale, kv_len)
        torch.cuda.synchronize()
        ref = attention_plain(qt.float(), kt.float(), vt.float(), scale, kv_len).transpose(1, 2)
        err, tol = float((got.float() - ref).abs().max()), ATTN_TOL * float(ref.abs().max())
        del got, ref
        run = lambda: attention_bnhd_fwd(q, k, v, scale, kv_len)  # noqa: E731
        ms, dev_ms = time_ms(run, budget_ms=budget_ms(n * m * b * h)), graph_ms(run)
        plain_ms = time_ms(lambda: attention_plain(qt, kt, vt, scale, kv_len), max_iters=5)
        mask = None if kv_len is None else (torch.arange(m, device="cuda") < kv_len).expand(n, m)
        sdpa = lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask,  # noqa: E731
                                                      scale=scale)
        lib_ms, lib_dev_ms = time_ms(sdpa), graph_ms(sdpa)
        nbytes = 2 * (b * h * n * d * 2 + b * h * kv * d * 2)
        bms, by = bound(nbytes, 4.0 * b * h * n * kv * d)
        _row(results, f"attention_bnhd_fwd [b{b} n{n} h{h} m{m} d{d}"
             + (f" kv_len{kv_len}" if kv_len else "") + " bnhd]", ATTN_SOURCES[d],
             "custom_diffusion360_tpu/ops/block_attention.py:218", err, tol, ms, plain_ms, bms,
             by, lib_ms, ("bnhd", (b, n, h, m, d, kv)), "SDPA", dev_ms, lib_dev_ms)
        del q, k, v, qt, kt, vt
        torch.cuda.empty_cache()


def _row(results, name, source, replaces, err, tol, ms, plain_ms, bms, by, lib_ms, key,
         lib_name, dev_ms=None, lib_dev_ms=None):
    """One phase-2 row; ``dev_ms`` / ``lib_dev_ms``: the CUDA-graph replay
    times of the kernel and the library call, where measured."""
    ok = math.isfinite(err) and err <= tol
    row = dict(name=name, route="cuda", source=source, replaces=replaces,
               max_abs_err=err, tol=tol, ms=ms, plain_ms=plain_ms, bound_ms=bms,
               bound_by=by, library_ms=lib_ms, ok=ok, _key=key)
    device = ""
    if dev_ms is not None:
        row.update(device_ms=dev_ms, library_device_ms=lib_dev_ms,
                   device_ms_from="CUDA-graph replay")
        device = (f" device {dev_ms:.4f} ms ({bms / dev_ms:.1%} of the bound) vs "
                  f"{lib_dev_ms:.4f} ms;")
    results.append(row)
    log(f"[kernels] {name}: err {err:.3e} (tol {tol:.3e}) kernel {ms:.4f} ms plain "
        f"{plain_ms:.4f} ms {lib_name} {lib_ms:.4f} ms;{device} bound {bms:.4f} ms ({by}) "
        f"{'OK' if ok else 'FAIL'}")


def kernel_sums(results):
    """Per kernel source and main path: the launches of the timed run and,
    over them, the sums of the kernel's device time (a wrapper call's
    launches together: the bilinear backward's merge launch, the d = 512
    attention's, GroupNorm's two), the library call's
    device time, the bound, and launches x (device time - bound), the
    ROADMAP's ranking of what is left (ms)."""
    sums = {}
    for r in results:
        src = r["source"].rsplit("/", 1)[-1]
        for path, n in r["launches_by_path"].items():
            if not n:
                continue
            s = sums.setdefault(src, {}).setdefault(path, dict(
                launches=0, device_ms=0.0, library_device_ms=0.0, bound_ms=0.0))
            s["launches"] += n
            s["device_ms"] += n * r["device_ms"]
            s["library_device_ms"] += n * r["library_device_ms"]
            s["bound_ms"] += n * r["bound_ms"]
    for src, per_path in sorted(sums.items()):
        for path, s in sorted(per_path.items()):
            s["excess_ms"] = s["device_ms"] - s["bound_ms"]
            log(f"[sums] {src} on {path}: {s['launches']} launches, device {s['device_ms']:.3f} "
                f"ms (library {s['library_device_ms']:.3f} ms, bound {s['bound_ms']:.3f} ms; "
                f"launches x (device - bound) {s['excess_ms']:.3f} ms)")
    return sums


def check_launched(torch, results, launched):
    """Phase 2 for every launched (kernel, shape) that no row of ``results``
    covers yet: the shapes the main paths gave each kernel."""
    done = {r["_key"] for r in results}
    todo = {}
    for kernel, shape in sorted(set(launched) - done, key=str):
        todo.setdefault(kernel, []).append(shape)
    t0 = time.time()
    attn = [("main path", b, h, n, m, d, None if kv == m else kv, layout,
             "custom_diffusion360_tpu/ops/" + ("attention.py:149" if d == 512 and m > 4096
                                              else "block_attention.py:275" if layout == "packed"
                                              else "block_attention.py:123"))
            for b, h, n, m, d, kv, layout in todo.pop("attention", [])]
    check_attention(torch, results, attn)
    check_bilinear(torch, results, [("main path", mm, h, c, needed_channels(c), p, dt)
                                    for mm, h, w, c, p, dt in todo.pop("bilinear", [])])
    check_bilinear_bwd(torch, results, todo.pop("bilinear_bwd", []))
    check_layer_norm(torch, results, todo.pop("layer_norm", []))
    check_group_norm(torch, results, todo.pop("group_norm", []))
    check_conv3x3(torch, results, todo.pop("conv3x3", []))
    check_bnhd(torch, results, todo.pop("bnhd", []))
    if todo:
        raise RuntimeError(f"no phase-2 check for kernels {sorted(todo)}")
    log(f"[kernels] launched shapes checked in {time.time() - t0:.1f} s")


ATTN_BWD_GRAPH_CALLS = 5  # the plain recompute holds (b, h, n, m) f32 scores a call


def time_attention_backward(torch, shapes):
    """The attention backward runs as the plain f32 recompute
    (ops/block_attention.attention_bwd_plain); time it at the shapes that
    take a gradient on the training path, beside SDPA's backward: host in
    (events around calls in a row) and on the device alone (CUDA-graph
    replay of ATTN_BWD_GRAPH_CALLS calls)."""
    import torch.nn.functional as F

    from custom_diffusion360_torch.ops.block_attention import attention_bwd_plain

    gen = torch.Generator(device="cuda").manual_seed(5)
    rows = []
    for b, h, n, m, d in shapes:
        q, k, v, g = (torch.randn((b, h, x, d), generator=gen, device="cuda",
                                  dtype=torch.bfloat16) for x in (n, m, m, n))
        plain = lambda: attention_bwd_plain(q, k, v, g, d**-0.5)  # noqa: E731
        plain_ms = time_ms(plain, max_iters=10)
        plain_dev_ms = graph_ms(plain, calls=ATTN_BWD_GRAPH_CALLS)
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):  # the backward's kernels run where its forward did
            qs, ks, vs = (t.clone().requires_grad_(True) for t in (q, k, v))
            out = F.scaled_dot_product_attention(qs, ks, vs, scale=d**-0.5)
        torch.cuda.synchronize()
        lib = lambda: torch.autograd.grad(out, (qs, ks, vs), g,  # noqa: E731
                                          retain_graph=True)
        lib_ms = time_ms(lib)
        lib_dev_ms = graph_ms(lib, calls=ATTN_BWD_GRAPH_CALLS, stream=side)
        rows.append(dict(shape=[b, h, n, m, d], plain_ms=plain_ms, sdpa_bwd_ms=lib_ms,
                         plain_device_ms=plain_dev_ms, sdpa_bwd_device_ms=lib_dev_ms))
        log(f"[attn-bwd] (b{b} h{h} n{n} m{m} d{d}): plain f32 recompute {plain_ms:.4f} ms, "
            f"SDPA backward {lib_ms:.4f} ms; device alone (CUDA-graph replay): plain "
            f"{plain_dev_ms:.4f} ms, SDPA backward {lib_dev_ms:.4f} ms "
            f"({plain_dev_ms / lib_dev_ms:.2f}x)")
        del q, k, v, g, qs, ks, vs, out
        torch.cuda.empty_cache()
    print(json.dumps({"attention_backward_plain": rows}), flush=True)


# ---------------------------------------------------------------------------
# phase 3: the sampling path at full width
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
    report_trace(torch, prof, sum(cached) / len(cached) * 1e3, TRACE_STEPS[1] - TRACE_STEPS[0],
                 "cached step")
    del params, eng
    torch.cuda.empty_cache()
    return launches, by_shape, t_decode * 1e3


TRACE_STEPS = (2, 4)  # sampler steps [2, 4) of a 4-step run, both cached
KERNEL_GROUPS = (  # device kernels by name, first match wins
    ("attention d64 kernel (sm90)", ("attn_sm90_kernel",)),
    ("attention d512 kernel", ("attn512_kernel", "attn512_merge_kernel")),
    ("conv3x3 kernel", ("conv3x3_kernel",)),
    ("bilinear bwd kernel", ("bilinear_bwd_kernel", "bilinear_bwd_merge_kernel")),
    ("bilinear kernel", ("bilinear_kernel",)),
    ("layer_norm kernel", ("layer_norm_kernel",)),
    ("group_norm kernel", ("gn_stats_kernel", "gn_apply_kernel")),
    ("convolution", ("fprop", "conv", "implicit", "cudnn", "dgrad", "wgrad")),
    ("matmul f32 (no tensor cores)", ("gemm_f32f32", "sgemm")),
    ("matmul bf16", ("gemm", "gemv", "nvjet", "xmma", "cutlass", "cublas")),
    ("norm/softmax/reduce", ("norm", "softmax", "reduce")),
    ("copy/cast/cat/layout", ("copy", "cat", "memcpy", "memset", "transpose",
                              "nchwtonhwc", "nhwctonchw")),
)


def report_trace(torch, prof, step_ms, n, what):
    """Device time per traced step (``n`` steps in the trace), by kernel
    group, and the device's busy share of ``step_ms``, the step's wall time
    without the profiler."""
    from torch.autograd import DeviceType

    groups, kernels, annotated = {}, [], 0.0
    for evt in prof.key_averages():
        if evt.device_type != DeviceType.CUDA:
            continue
        ms = getattr(evt, "self_device_time_total", 0) / 1e3 / n
        if getattr(evt, "is_user_annotation", False):
            # a record_function range on the device's timeline (the
            # optimizers' "Optimizer.step#..."): its kernels count already
            annotated += ms
            continue
        name = evt.key.lower()
        group = next((g for g, keys in KERNEL_GROUPS if any(k in name for k in keys)),
                     "elementwise/other")
        groups[group] = groups.get(group, 0.0) + ms
        kernels.append((ms, evt.count // n, evt.key))
    busy = sum(groups.values())
    if busy == 0.0:
        log("[trace] the profiler recorded no device time: breakdown not measured")
        return
    log(f"[trace] {what}: device busy {busy:.2f} ms of {step_ms:.2f} ms wall "
        f"(idle share {1 - busy / step_ms:.3f}); "
        f"{sum(c for _, c, _ in kernels)} kernel launches per step; annotated ranges "
        f"{annotated:.2f} ms not counted again")
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
# phase 4: the training path at full width
# ---------------------------------------------------------------------------

TRAIN_RES, TRAIN_REFS, TRAIN_STEPS = 512, 4, 6
BOS, EOT = 49406, 49407  # CLIP's start and end ids


def clip_tokens(torch, rows, vocab, device, ids=(BOS, 320, None, EOT), length=77):
    """(rows, length) int32 ids: ``ids`` (None: the V* id, = vocab) then 0."""
    toks = torch.zeros((rows, length), dtype=torch.int32)
    toks[:, :len(ids)] = torch.tensor([vocab if i is None else i for i in ids])
    return toks.to(device)


def make_train_batch(torch, cfg, b, n, res, device, seed=0, ids=(BOS, 320, None, EOT)):
    """A synthetic training batch as bench.py --train builds it (images
    N(0, 0.3^2), full masks, size tuples at ``res``), with a disc-shaped
    opacity so the fg and bg terms are both live, and token ``ids`` (None:
    the V* id, = vocab_size, the first modifier row) before the padding."""
    import numpy as np

    gen = torch.Generator(device=device).manual_seed(seed)

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=device) * 0.3

    def tokens(m):
        clip_l = cfg.conditioner.clip_l
        return clip_tokens(torch, m, clip_l.vocab_size, device, ids, clip_l.context_length)

    yy, xx = np.mgrid[:res, :res]
    disc = ((yy - res / 2) ** 2 + (xx - res / 2) ** 2 < (0.35 * res) ** 2).astype(np.float32)
    lat = res // 8

    def full(*shape, value=1.0):
        return torch.full(shape, float(value), device=device)

    batch = {
        "image": rnd(b, res, res, 3), "image_ref": rnd(b, n, res, res, 3),
        "mask": full(b, lat, lat, 1), "mask_ref": full(b, n, lat, lat, 1),
        "opacity": torch.from_numpy(disc)[None, :, :, None].expand(b, res, res, 1)
        .contiguous().to(device),
        "drop_im": full(b), "cams": make_cameras(torch, n, b, device),
        "tokens_clip": tokens(b), "tokens_open": tokens(b),
        "tokens_clip_ref": tokens(b * n), "tokens_open_ref": tokens(b * n),
    }
    for suffix, m in (("", b), ("_ref", b * n)):
        batch["original_size" + suffix] = full(m, 2, value=res)
        batch["crop_coords" + suffix] = full(m, 2, value=0.0)
        batch["target_size" + suffix] = full(m, 2, value=res)
    return batch


def run_train_path(torch, counters):
    """Full-width SDXL + 12 pose blocks + both text towers + the VAE
    encoder, 512^2, batch 1, 1 + 4 views: one warm-up train step, then
    TRAIN_STEPS timed steps (counted), then one traced step."""
    from custom_diffusion360_torch.draws import Draws
    from custom_diffusion360_torch.engine import Engine, EngineConfig
    from custom_diffusion360_torch.models.unet import UNetConfig
    from custom_diffusion360_torch.train.trainer import TrainConfig, Trainer

    # bench.py --train's workload: bf16 weights and activations, the NeRF's
    # f32 island at ray chunk 512 (the UNetConfig defaults)
    cfg = EngineConfig(unet=UNetConfig(), compute_dtype="bfloat16")
    t0 = time.time()
    eng = Engine(cfg, device="cuda")
    params = perturb_zero_leaves(torch, eng.init_params(seed=10), seed=11)
    trainer = Trainer(eng, TrainConfig())
    state = trainer.init_state(params)
    del params
    n_train = sum(p.numel() for p in trainer.trainable(state))
    batch = make_train_batch(torch, cfg, 1, TRAIN_REFS, TRAIN_RES, "cuda")
    torch.cuda.synchronize()
    log(f"[train] trainable {n_train / 1e6:.2f} M f32 params (trainkeys pose), "
        f"setup {time.time() - t0:.1f} s")

    def step(i):
        nonlocal state
        torch.cuda.synchronize()
        start = time.perf_counter()
        state, metrics = trainer.train_step(
            state, batch, Draws(torch.Generator(device="cuda").manual_seed(100 + i)))
        loss, gnorm = float(metrics["loss"]), float(metrics["grad_norm"])  # synchronizes
        torch.cuda.synchronize()
        return time.perf_counter() - start, loss, gnorm, metrics

    t_warm = step(0)[0]
    for c in counters.values():
        c.launches = 0
        c.launches_by_shape.clear()
    torch.cuda.reset_peak_memory_stats()
    runs = [step(1 + i) for i in range(TRAIN_STEPS)]
    launches = {k: c.launches for k, c in counters.items()}
    by_shape = {(k, shape): n for k, c in counters.items()
                for shape, n in c.launches_by_shape.items()}
    peak = torch.cuda.max_memory_allocated()
    times = sorted(r[0] * 1e3 for r in runs)
    med = statistics.median(times)
    losses, gnorms = [r[1] for r in runs], [r[2] for r in runs]
    ok = all(math.isfinite(x) for x in losses + gnorms) and min(gnorms) > 0.0
    log(f"[train] warm-up step {t_warm * 1e3:.1f} ms; {TRAIN_STEPS} timed steps: median "
        f"{med:.1f} ms (min {times[0]:.1f}, max {times[-1]:.1f}); peak memory allocated "
        f"{peak / 2**30:.2f} GiB")
    for i, (t, loss, gnorm, metrics) in enumerate(runs):
        log(f"[train] step {i + 1}: {t * 1e3:.1f} ms loss {loss:.6f} grad_norm {gnorm:.6f} "
            + " ".join(f"{k} {float(v):.5f}" for k, v in sorted(metrics.items())
                       if k not in ("loss", "grad_norm")))
    log(f"[train] launches in the timed steps {json.dumps(launches)}")
    for (k, shape), n in sorted(by_shape.items(), key=str):
        log(f"[train] launches {k} {shape}: {n} ({n / TRAIN_STEPS:g} per step)")
    print(json.dumps({"train_path": {
        "step_ms_median": med, "step_ms_min": times[0], "step_ms_max": times[-1],
        "step_ms": [r[0] * 1e3 for r in runs], "warmup_ms": t_warm * 1e3,
        "peak_gib": peak / 2**30, "loss": losses, "grad_norm": gnorms,
        "launches": launches}}), flush=True)
    if not ok:
        raise RuntimeError(f"training step: loss {losses} / grad_norm {gnorms} not finite "
                           "and positive")
    prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                              torch.profiler.ProfilerActivity.CUDA])
    with prof:
        step(1 + TRAIN_STEPS)
    report_trace(torch, prof, med, 1, "train step")
    grads = sorted({shape[:5] for k, shape in by_shape if k == "attention"
                    and shape[0] == 1 and shape[4] == 64})
    del state, trainer, eng, batch
    torch.cuda.empty_cache()
    return launches, by_shape, grads


# ---------------------------------------------------------------------------
# phase 5: the sampling CLI at full width
# ---------------------------------------------------------------------------

CLI_SWITCHES = {"CD360_VAE_CONV": "pallas", "CD360_ATTN_BNHD": "1"}
N_TRAIN_CAMS, N_VAL_CAMS = 20, 7


def patch_init_params(torch, on_cpu):
    """Wrap ``Engine.init_params`` so the random weights' zero-initialized
    leaves are perturbed (``on_cpu``: made on the CPU in f32 first, so the
    card and the CPU get the same weights); returns the original, which the
    caller puts back."""
    from custom_diffusion360_torch.engine import Engine

    orig = Engine.init_params

    def init_params(eng, seed=0, dtype=None):
        dtype = eng.cfg.dtype if dtype is None else dtype
        if on_cpu:
            params = orig(Engine(eng.cfg, device="cpu"), seed, torch.float32)
            params = perturb_zero_leaves(torch, params, seed + 100)
            return _map(params, lambda x: x.to(eng.device, dtype))
        return perturb_zero_leaves(torch, orig(eng, seed, dtype), seed + 100)

    Engine.init_params = init_params
    return orig


class cli_setup:
    """Context for in-process runs of cli.sample.main: the env switches set
    (and restored after), ``Engine.init_params`` wrapped so the random
    weights' zero-initialized leaves are perturbed (``on_cpu``: made on the
    CPU in f32 first, so the card and the CPU get the same weights), and a
    temporary directory holding a delta .npz (reference buffers for every
    pose block at ``latent``, one row per training camera plus the zero
    row, stored in f16, and V* rows) and a ring cameras .npz, both written
    by the port's own savers."""

    def __init__(self, torch, unet_cfg, latent, clip_widths, on_cpu):
        self.torch, self.unet_cfg, self.latent = torch, unet_cfg, latent
        self.clip_widths, self.on_cpu = clip_widths, on_cpu

    def __enter__(self):
        import tempfile

        from custom_diffusion360_torch.cli.sample import ring_cameras
        from custom_diffusion360_torch.io.cameras_io import save_cameras_npz
        from custom_diffusion360_torch.io.delta import iter_pose_blocks, save_delta_npz
        from custom_diffusion360_torch.models.unet import attn_block_meta

        torch = self.torch
        self.saved_env = {k: os.environ.get(k) for k in CLI_SWITCHES}
        os.environ.update(CLI_SWITCHES)
        self.orig_init = patch_init_params(torch, self.on_cpu)
        self.tmp = tempfile.TemporaryDirectory()
        d = self.tmp.name
        # drawn on the device when there is one (0.8 GiB of buffers at full width)
        dev = "cpu" if self.on_cpu else "cuda"
        gen = torch.Generator(device=dev).manual_seed(0)
        meta = attn_block_meta(self.unet_cfg)
        delta = {}
        for prefix, _, attn_id, _ in iter_pose_blocks(self.unet_cfg):
            ds, ch, _ = meta[attn_id]
            shape = (N_TRAIN_CAMS + 1, (self.latent // ds) ** 2, ch)
            delta[prefix + ".references"] = (torch.randn(shape, generator=gen, device=dev)
                                             * 0.05).half().cpu().numpy()
        delta["embed"] = [(torch.randn((1, w), generator=gen, device=dev) * 0.02).cpu().numpy()
                          for w in self.clip_widths]
        self.delta, self.cameras = os.path.join(d, "delta.npz"), os.path.join(d, "cameras.npz")
        save_delta_npz(self.delta, delta)
        save_cameras_npz(self.cameras, train=ring_cameras(N_TRAIN_CAMS),
                         val=ring_cameras(N_VAL_CAMS))
        self.out = os.path.join(d, "out")
        self.delta_bytes = os.path.getsize(self.delta)
        return self

    def __exit__(self, *exc):
        from custom_diffusion360_torch.engine import Engine

        Engine.init_params = self.orig_init
        for k, v in self.saved_env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        self.tmp.cleanup()
        return False

    def argv(self, *extra):
        return ["--delta_ckpt", self.delta, "--cameras", self.cameras, "--output_dir", self.out,
                *extra]


def run_cli_path(torch, counters, main_decode_ms):
    """python -m custom_diffusion360_torch.cli.sample at full width, in
    process: 1024^2, batch 1, one image, x3 guider, 50 steps, 8 reference
    views, both kernel switches on. A 2-step warm-up, the timed run
    (counted), then a 4-step run with cached steps 2-3 traced."""
    from custom_diffusion360_torch.cli import sample as cli
    from custom_diffusion360_torch.models.unet import UNetConfig

    res = 8 * LATENT
    base = ["--resolution", str(res), "--num_images", "1", "--batch", "1", "--seed", "0",
            "--device", "cuda", "--dtype", "bfloat16"]
    t0 = time.time()
    with cli_setup(torch, UNetConfig(), LATENT, (768, 1280), on_cpu=False) as setup:
        log(f"[cli] delta .npz {setup.delta_bytes / 2**20:.1f} MiB and cameras .npz written in "
            f"{time.time() - t0:.1f} s; switches {json.dumps(CLI_SWITCHES)}")
        t0 = time.time()
        cli.main(setup.argv(*base, "--num_steps", "2"))  # warm-up
        torch.cuda.synchronize()
        log(f"[cli] warm-up (load, init, 2 steps, decode) {time.time() - t0:.1f} s")
        marks = []

        def cb(i):
            torch.cuda.synchronize()
            marks.append(time.perf_counter())

        for c in counters.values():
            c.launches = 0
            c.launches_by_shape.clear()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        (rec,) = cli.main(setup.argv(*base, "--num_steps", str(STEPS)), callback=cb)
        t_all = time.perf_counter() - t0
        launches = {k: c.launches for k, c in counters.items()}
        by_shape = {(k, shape): n for k, c in counters.items()
                    for shape, n in c.launches_by_shape.items()}
        peak = torch.cuda.max_memory_allocated()
        img = rec["images"][0]
        cached = sorted((b - a) * 1e3 for a, b in zip(marks, marks[1:]))
        render_ms = (rec["sample_s"] - (marks[-1] - marks[0])) * 1e3
        med = statistics.median(cached)
        ok = (img.shape == (res, res, 3) and float(img.std()) > 1.0 and len(marks) == STEPS
              and os.path.exists(rec["paths"][0]))
        log(f"[cli] x3 guider, {len(marks)} steps: render step {render_ms:.1f} ms; cached x3 step "
            f"median {med:.1f} ms (min {cached[0]:.1f}, max {cached[-1]:.1f}); decode with the "
            f"conv3x3 kernel {rec['decode_s'] * 1e3:.1f} ms (cuDNN decode of [main] "
            f"{main_decode_ms:.1f} ms); image latency (sample + decode) {rec['seconds']:.2f} s; "
            f"main() {t_all:.2f} s with loading and init; peak memory allocated "
            f"{peak / 2**30:.2f} GiB")
        log(f"[cli] launches {json.dumps(launches)}")
        for (k, shape), n in sorted(by_shape.items(), key=str):
            log(f"[cli] launches {k} {shape}: {n}")
        log(f"[cli] image {img.shape} uint8 mean {float(img.mean()):.2f} std "
            f"{float(img.std()):.2f} {'OK' if ok else 'FAIL'}")
        print(json.dumps({"cli_path": {
            "render_step_ms": render_ms, "cached_step_ms_median": med,
            "cached_step_ms_min": cached[0], "cached_step_ms_max": cached[-1],
            "decode_ms": rec["decode_s"] * 1e3, "main_decode_cudnn_ms": main_decode_ms,
            "image_latency_s": rec["seconds"], "peak_gib": peak / 2**30,
            "launches": launches}}), flush=True)
        if not ok:
            raise RuntimeError("CLI path: no finite, non-constant 1024^2 image")
        prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                  torch.profiler.ProfilerActivity.CUDA])

        def trace_cb(i):
            torch.cuda.synchronize()
            if i + 1 in TRACE_STEPS:
                (prof.start if i + 1 == TRACE_STEPS[0] else prof.stop)()

        cli.main(setup.argv(*base, "--num_steps", str(TRACE_STEPS[1])), callback=trace_cb)
        report_trace(torch, prof, med, TRACE_STEPS[1] - TRACE_STEPS[0], "cached x3 step")
    torch.cuda.empty_cache()
    return launches, by_shape


# ---------------------------------------------------------------------------
# phase 5b: the training CLI at full width, feeding the sampling CLI
# ---------------------------------------------------------------------------

CO3D_FRAMES, CO3D_W, CO3D_H = 40, 820, 760  # a few hundred pixels past 512 each way
TRAIN_CLI_STEPS, TRAIN_CLI_SEED = 4, 23


def write_co3d_tree(root, n_frames=CO3D_FRAMES, width=CO3D_W, height=CO3D_H, seed=0):
    """A CO3Dv2-shaped tree (the layout tests/test_data.py writes) under
    ``root``: one sequence car/seq0 of ``n_frames`` JPEG frames of width x
    height (an ellipse on a gradient, with noise), PNG masks of the
    ellipse, its bbox per mask, ring cameras looking at the origin,
    set_lists_fewview_dev.json and the .jgz annotations."""
    import gzip

    import numpy as np
    from PIL import Image

    cat, seq = os.path.join(root, "car"), "seq0"
    for sub in ("set_lists", f"{seq}/images", f"{seq}/masks"):
        os.makedirs(os.path.join(cat, sub), exist_ok=True)
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[:height, :width].astype(np.float32)
    frames, set_list, bboxes = [], [], {}
    for i in range(n_frames):
        th = 2 * np.pi * i / n_frames
        cx, cy = width / 2 + 60 * np.cos(th), height / 2 + 40 * np.sin(th)
        ax, ay = 0.3 * width, 0.33 * height
        inside = ((xx - cx) / ax) ** 2 + ((yy - cy) / ay) ** 2 < 1.0
        base = np.stack([xx / width, yy / height, 0.5 + 0.5 * np.cos(th + xx / 97.0)], -1)
        img = np.where(inside[..., None], 1.0 - 0.7 * base, 0.3 * base) * 255.0
        img = np.clip(img + rng.normal(0, 8, img.shape), 0, 255).astype(np.uint8)
        img_rel = f"car/{seq}/images/frame{i:06d}.jpg"
        mask_rel = f"car/{seq}/masks/frame{i:06d}.png"
        Image.fromarray(img).save(os.path.join(root, img_rel), quality=90)
        Image.fromarray(inside.astype(np.uint8) * 255).save(os.path.join(root, mask_rel))
        bboxes[mask_rel] = [float(cx - ax), float(cy - ay), float(cx + ax), float(cy + ay)]
        c, s_ = np.cos(th), np.sin(th)
        frames.append({"sequence_name": seq, "frame_number": i, "viewpoint": {
            "R": [[c, 0.0, s_], [0.0, 1.0, 0.0], [-s_, 0.0, c]], "T": [0.0, 0.0, 3.0],
            "focal_length": [2.0, 2.0], "principal_point": [0.0, 0.0]}})
        set_list.append([seq, i, img_rel])
    with open(os.path.join(cat, "set_lists", "set_lists_fewview_dev.json"), "w") as f:
        json.dump({"train": set_list}, f)
    for name, data in (("sequence_annotations.jgz",
                        [{"sequence_name": seq, "viewpoint_quality_score": 0.9}]),
                       ("frame_annotations.jgz", frames), ("car_bbox.jgz", bboxes)):
        with gzip.open(os.path.join(cat, name), "wt") as f:
            json.dump(data, f)
    return root


def run_train_cli_path(torch, counters):
    """python -m custom_diffusion360_torch.cli.train at full width, in
    process, on a synthetic CO3D tree: SDXL (EngineConfig() with bf16
    compute, as [train]), random weights from --seed 23, 512^2, 1 + 4
    views, batch 1, 4 steps, EMA, a step delta and a full checkpoint at
    step 2, a validation loss, then capture of the 20 valid frames and the
    delta export; then cli.sample.main on that delta and cameras at 512^2,
    x3, 8 reference views, 4 steps, with both kernel switches. The sample
    takes the capture's resolution: a delta's reference buffers are token
    grids of the captured images, and a pose block renders at its
    references' grid (as in the JAX package, models/nerf.py:766), so a
    delta captured at 512^2 cannot drive a 1024^2 sample. The counters are
    zeroed just before the training call and read after the sample."""
    import csv
    import tempfile

    import numpy as np

    from custom_diffusion360_torch.cli import sample as cli_sample
    from custom_diffusion360_torch.cli import train as cli_train
    from custom_diffusion360_torch.engine import Engine
    from custom_diffusion360_torch.io.delta import iter_pose_blocks
    from custom_diffusion360_torch.models.unet import UNetConfig

    orig_init = patch_init_params(torch, on_cpu=False)
    saved_env = {k: os.environ.get(k) for k in CLI_SWITCHES}
    try:
        with tempfile.TemporaryDirectory() as d:
            t0 = time.time()
            root = write_co3d_tree(os.path.join(d, "co3d"))
            log(f"[train-cli] CO3D tree of {CO3D_FRAMES} {CO3D_W}x{CO3D_H} frames written in "
                f"{time.time() - t0:.1f} s")
            out = os.path.join(d, "run")
            argv = ["--data_root", root, "--category", "car", "--output_dir", out,
                    "--seed", str(TRAIN_CLI_SEED), "--img_size", "512", "--num_images", "5",
                    "--batch_size", "1", "--max_steps", str(TRAIN_CLI_STEPS), "--log_every",
                    "1", "--ckpt_every", "2", "--full_ckpt_every", "2", "--val_every", "2",
                    "--use_ema", "--device", "cuda", "--override", "compute_dtype=bfloat16",
                    "--sample_every", "2", "--log_steps_increase"]
            for c in counters.values():
                c.launches = 0
                c.launches_by_shape.clear()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            summary = cli_train.main(argv)
            torch.cuda.synchronize()
            train_s = time.perf_counter() - t0
            peak_train = torch.cuda.max_memory_allocated()
            train_launches = {k: c.launches for k, c in counters.items()}
            with open(os.path.join(out, "metrics.csv"), newline="") as f:
                rows = list(csv.DictReader(f))
            steps = [r for r in rows if r.get("loss")]
            vals = [r for r in rows if r.get("val_loss")]
            for r in steps:
                log(f"[train-cli] step {r['step']}: {float(r['step_ms']):.1f} ms, loss "
                    f"{float(r['loss']):.6f}, grad_norm {float(r['grad_norm']):.6f}, loader wait "
                    f"{float(r['data_ms']):.2f} ms")
            for r in vals:
                log(f"[train-cli] step {r['step']}: val_loss {float(r['val_loss']):.6f}")
            step_ms = [s["step_s"] * 1e3 for s in summary["steps"]]
            data_ms = [s["data_s"] * 1e3 for s in summary["steps"]]
            share = sum(data_ms) / (sum(data_ms) + sum(step_ms))
            ipm = float(steps[-1]["images_per_min"])
            delta_path = os.path.join(out, "delta_last.npz")
            with np.load(delta_path) as z:
                delta = {k: z[k] for k in z.files}
            mib = os.path.getsize(delta_path) / 2**20
            prefixes = [p for p, _, _, _ in iter_pose_blocks(UNetConfig())]
            refs = [delta.get(p + ".references") for p in prefixes]
            have_refs = all(r is not None and r.shape[0] == CO3D_FRAMES // 2 + 1 for r in refs)
            refs_finite = have_refs and all(bool(np.isfinite(r).all()) for r in refs)
            files = [os.path.join(out, "delta_step2.npz"),
                     os.path.join(out, "checkpoints", "step_00000004")]
            log(f"[train-cli] main() {train_s:.1f} s; step median {statistics.median(step_ms):.1f} "
                f"ms (min {min(step_ms):.1f}, max {max(step_ms):.1f}); images/min {ipm:.2f}; "
                f"loader share of a step {100 * share:.2f} %; capture {summary['capture_s']:.2f} s "
                f"({CO3D_FRAMES // 2} views + the zero image); delta {mib:.1f} MiB, "
                f"{len(delta)} keys, {len(prefixes)} pose blocks with references "
                f"{'OK' if have_refs else 'MISSING'}; peak memory allocated "
                f"{peak_train / 2**30:.2f} GiB")
            log(f"[train-cli] launches in the training CLI {json.dumps(train_launches)}")
            grid_problems = check_preview_grids(summary["grids"], len(prefixes))

            os.environ.update(CLI_SWITCHES)
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            (rec,) = cli_sample.main([
                "--delta_ckpt", delta_path, "--cameras", os.path.join(out, "cameras.npz"),
                "--output_dir", os.path.join(d, "samples"), "--seed", str(TRAIN_CLI_SEED),
                "--resolution", "512", "--num_images", "1", "--batch", "1", "--num_steps",
                "4", "--device", "cuda", "--dtype", "bfloat16"])
            sample_s = time.perf_counter() - t0
            peak_sample = torch.cuda.max_memory_allocated()
            launches = {k: c.launches for k, c in counters.items()}
            by_shape = {(k, shape): n for k, c in counters.items()
                        for shape, n in c.launches_by_shape.items()}
            img = rec["images"][0]
            log(f"[train-cli] launches (training CLI + sampling CLI) {json.dumps(launches)}")
            for (k, shape), n in sorted(by_shape.items(), key=str):
                log(f"[train-cli] launches {k} {shape}: {n}")
            log(f"[train-cli] sample on the trained delta, 512^2 x3, 4 steps: main() "
                f"{sample_s:.1f} s, image latency {rec['seconds']:.2f} s, image {img.shape} "
                f"uint8 mean {float(img.mean()):.2f} std {float(img.std()):.2f}; peak memory "
                f"allocated {peak_sample / 2**30:.2f} GiB")
            losses = [float(r["loss"]) for r in steps] + [float(r["val_loss"]) for r in vals]
            gnorms = [float(r["grad_norm"]) for r in steps]
            print(json.dumps({"train_cli_path": {
                "main_s": train_s, "step_ms": step_ms, "step_ms_median": statistics.median(step_ms),
                "data_ms": data_ms, "loader_share": share, "images_per_min": ipm,
                "loss": [float(r["loss"]) for r in steps], "grad_norm": gnorms,
                "val_loss": [float(r["val_loss"]) for r in vals],
                "capture_s": summary["capture_s"], "delta_mib": mib, "delta_keys": len(delta),
                "peak_gib": peak_train / 2**30, "sample_s": sample_s,
                "sample_image_latency_s": rec["seconds"], "sample_peak_gib": peak_sample / 2**30,
                "image_mean": float(img.mean()), "image_std": float(img.std()),
                "log_images_s": {g["step"]: g["seconds"] for g in summary["grids"]},
                "launches": launches}}), flush=True)
            problems = list(grid_problems)
            if len(steps) != TRAIN_CLI_STEPS or not vals:
                problems.append(f"{len(steps)} step rows and {len(vals)} validation rows")
            if not all(math.isfinite(x) for x in losses + gnorms):
                problems.append(f"loss or grad_norm not finite: {losses} {gnorms}")
            if not have_refs or "embed.0" not in delta or "embed.1" not in delta:
                problems.append("the delta lacks a pose block's references or the embed rows")
            elif not refs_finite:
                problems.append("a captured buffer is not finite")
            problems += [f"{p} is missing" for p in files if not os.path.exists(p)]
            if img.shape != (512, 512, 3) or float(img.std()) <= 1.0:
                problems.append("no finite, non-constant 512^2 sample")
            if problems:
                raise RuntimeError("training CLI path: " + "; ".join(problems))
    finally:
        Engine.init_params = orig_init
        for k, v in saved_env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    torch.cuda.empty_cache()
    return launches, by_shape


PREVIEW_STEPS = (1, 2)  # --sample_every 2 --log_steps_increase over 4 steps


def check_preview_grids(grids, n_pose_blocks):
    """Log each preview step's log_images wall time and PNGs; return the
    problems: a step missing from PREVIEW_STEPS, a missing or unreadable
    grid, a constant sample."""
    import numpy as np
    from PIL import Image

    names = {"inputs", "reconstructions", "samples", "conditioning"}
    names |= {f"{k}_{i}" for k in ("predicted_rgb", "fg_mask") for i in range(n_pose_blocks)}
    problems = []
    if [g["step"] for g in grids] != list(PREVIEW_STEPS):
        problems.append(f"preview grids at steps {[g['step'] for g in grids]}, expected "
                        f"{list(PREVIEW_STEPS)}")
    for g in grids:
        written = {os.path.basename(p).rsplit("_", 1)[0]: p for p in g["paths"]
                   if os.path.exists(p)}
        sizes = sorted({Image.open(p).size for p in written.values()})
        log(f"[train-cli] step {g['step']}: log_images {g['seconds'] * 1e3:.1f} ms (8-step x2 "
            f"live-reference sample, two decodes, the diagnostic forward; "
            f"{g['seconds'] * 1e3 / max(len(written), 1):.1f} ms a grid), {len(written)} PNGs "
            f"written, sizes {sizes}")
        missing = sorted(names - set(written))
        if missing:
            problems.append(f"step {g['step']}: grids missing {missing}")
        elif float(np.asarray(Image.open(written["samples"])).std()) <= 1.0:
            problems.append(f"step {g['step']}: the preview sample is constant")
    return problems


# ---------------------------------------------------------------------------
# phase 5c: every sampler through the sampling CLI at full width, samplemulti
# ---------------------------------------------------------------------------

SAMPLER_STEPS = 8
SAMPLER_RUNS = (  # (label, --sampler, extra flags)
    ("heun_edm", "heun_edm", ()),
    ("euler_ancestral", "euler_ancestral", ()),
    ("dpmpp2s_ancestral", "dpmpp2s_ancestral", ()),
    ("dpmpp2m", "dpmpp2m", ()),
    ("lms", "lms", ()),
    ("euler_edm, EDM schedule", "euler_edm", ("--override", "discretization_name=edm")),
)
MULTI_LATENT, MULTI_STRIDE, MULTI_VIEWS, MULTI_STEPS = 64, 48, 2, 4


def run_samplers_path(torch, counters):
    """cli.sample.main in process at the [cli] phase's settings (1024^2,
    batch 1, one image, x3, 8 views, both switches, the same delta) for
    each SAMPLER_RUNS entry at SAMPLER_STEPS steps; then Engine.samplemulti,
    MULTI_VIEWS views of a 512^2 window, MULTI_STEPS steps, x2, decoded.
    Network evaluations are counted by wrapping Denoiser.__call__. The
    counters are zeroed just before the first run and read after
    samplemulti."""
    import numpy as np

    from custom_diffusion360_torch.cli import sample as cli
    from custom_diffusion360_torch.diffusion.denoiser import Denoiser
    from custom_diffusion360_torch.models.unet import UNetConfig

    res = 8 * LATENT
    base = ["--resolution", str(res), "--num_images", "1", "--batch", "1", "--seed", "0",
            "--device", "cuda", "--dtype", "bfloat16", "--num_steps", str(SAMPLER_STEPS)]
    evals = [0]
    orig_call = Denoiser.__call__

    def counting_call(self, *a, **kw):
        evals[0] += 1
        return orig_call(self, *a, **kw)

    Denoiser.__call__ = counting_call
    runs, problems = {}, []
    try:
        with cli_setup(torch, UNetConfig(), LATENT, (768, 1280), on_cpu=False) as setup:
            for c in counters.values():
                c.launches = 0
                c.launches_by_shape.clear()
            torch.cuda.reset_peak_memory_stats()
            for label, name, extra in SAMPLER_RUNS:
                marks = []

                def cb(i):
                    torch.cuda.synchronize()
                    marks.append(time.perf_counter())

                evals[0] = 0
                t0 = time.perf_counter()
                (rec,) = cli.main(setup.argv(*base, "--sampler", name, *extra), callback=cb)
                main_s = time.perf_counter() - t0
                steps = sorted((b - a) * 1e3 for a, b in zip(marks, marks[1:]))
                img = rec["images"][0]
                ok = (img.shape == (res, res, 3) and float(img.std()) > 1.0
                      and bool(np.isfinite(img).all()) and len(marks) == SAMPLER_STEPS)
                runs[label] = dict(
                    evaluations=evals[0], image_latency_s=rec["seconds"],
                    sample_s=rec["sample_s"], decode_ms=rec["decode_s"] * 1e3,
                    cached_step_ms_median=statistics.median(steps), cached_step_ms_min=steps[0],
                    cached_step_ms_max=steps[-1], main_s=main_s,
                    image_mean=float(img.mean()), image_std=float(img.std()))
                log(f"[samplers] {label}, {SAMPLER_STEPS} steps: {evals[0]} network evaluations; "
                    f"image latency {rec['seconds']:.2f} s (sample {rec['sample_s']:.2f} s, decode "
                    f"{rec['decode_s'] * 1e3:.1f} ms); median cached step "
                    f"{statistics.median(steps):.1f} ms (min {steps[0]:.1f}, max {steps[-1]:.1f}); "
                    f"main() {main_s:.1f} s; image mean {float(img.mean()):.2f} std "
                    f"{float(img.std()):.2f} {'OK' if ok else 'FAIL'}")
                if not ok:
                    problems.append(f"{label}: no finite, non-constant {res}^2 image")
        Denoiser.__call__ = orig_call
        multi = run_samplemulti(torch)
        if not multi.pop("ok"):
            problems.append("samplemulti: no finite, non-constant image")
    finally:
        Denoiser.__call__ = orig_call
    launches = {k: c.launches for k, c in counters.items()}
    by_shape = {(k, shape): n for k, c in counters.items()
                for shape, n in c.launches_by_shape.items()}
    peak = torch.cuda.max_memory_allocated()
    log(f"[samplers] peak memory allocated {peak / 2**30:.2f} GiB; launches {json.dumps(launches)}")
    for (k, shape), n in sorted(by_shape.items(), key=str):
        log(f"[samplers] launches {k} {shape}: {n}")
    print(json.dumps({"samplers_path": {"runs": runs, "samplemulti": multi,
                                        "peak_gib": peak / 2**30, "launches": launches}}),
          flush=True)
    if problems:
        raise RuntimeError("samplers path: " + "; ".join(problems))
    torch.cuda.empty_cache()
    return launches, by_shape


def run_samplemulti(torch):
    """Engine.samplemulti at full width: MULTI_VIEWS views, each a
    MULTI_LATENT window (512^2) under its own cameras and conditioning,
    windows every MULTI_STRIDE latent columns, x2 guider, 8 reference views
    of buffers at the window's token grids, MULTI_STEPS steps (each renders),
    then the decode of the wide latent."""
    from custom_diffusion360_torch.diffusion.guiders import vanilla_cfg_img_ref
    from custom_diffusion360_torch.engine import Engine, EngineConfig
    from custom_diffusion360_torch.models.unet import UNetConfig

    cfg = EngineConfig(unet=UNetConfig(nerf_dtype="bfloat16", nerf_chunk_size=4096),
                       compute_dtype="bfloat16")
    eng = Engine(cfg, device="cuda")
    params = perturb_zero_leaves(torch, eng.init_params(seed=0), seed=5)
    guider = vanilla_cfg_img_ref(scale=7.5)
    refs = make_references(torch, cfg.unet, N_REF, MULTI_LATENT, "cuda", seed=6)
    conds = [make_cond(torch, cfg.unet, 1, "cuda", torch.bfloat16, seed=20 + j)
             for j in range(MULTI_VIEWS)]
    uc = make_cond(torch, cfg.unet, 1, "cuda", torch.bfloat16, seed=30)
    cams_list = [make_cameras(torch, N_REF, guider.num_copies, "cuda", seed=40 + j)
                 for j in range(MULTI_VIEWS)]
    width = MULTI_STRIDE * (MULTI_VIEWS + 1)
    noise = torch.randn((1, MULTI_LATENT, width, 4),
                        generator=torch.Generator(device="cuda").manual_seed(7), device="cuda")
    marks = []

    def cb(i):
        torch.cuda.synchronize()
        marks.append(time.perf_counter())

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    z = eng.samplemulti(params, conds, uc, guider, noise=noise, cams_list=cams_list,
                        references=refs, choices=list(range(N_REF)), num_steps=MULTI_STEPS,
                        window=MULTI_LATENT, stride=MULTI_STRIDE, callback=cb)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    img = eng.decode_first_stage(params, z.to(torch.bfloat16)).float()
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    steps = [(b - a) * 1e3 for a, b in zip([t0] + marks[:-1], marks)]
    ok = (tuple(img.shape) == (1, 8 * MULTI_LATENT, 8 * width, 3)
          and bool(torch.isfinite(img).all()) and float(img.std()) > 1e-3
          and len(marks) == MULTI_STEPS)
    log(f"[samplers] samplemulti: {MULTI_VIEWS} views of {8 * MULTI_LATENT}^2, stride "
        f"{8 * MULTI_STRIDE} px, {MULTI_STEPS} steps x2: sample {(t1 - t0):.2f} s (steps "
        f"{', '.join(f'{m:.1f}' for m in steps)} ms), decode of {tuple(img.shape)} "
        f"{(t2 - t1) * 1e3:.1f} ms; image mean {float(img.mean()):.4f} std "
        f"{float(img.std()):.4f} {'OK' if ok else 'FAIL'}")
    out = dict(sample_s=t1 - t0, step_ms=steps, decode_ms=(t2 - t1) * 1e3,
               image_shape=list(img.shape), ok=ok)
    del params, eng, z, img
    return out


# ---------------------------------------------------------------------------
# phase 5d: parallelism in a one-rank NCCL world
# ---------------------------------------------------------------------------

PARALLEL_TRAIN_STEPS, PARALLEL_SAMPLE_STEPS = 2, 4
PARALLEL_LOSS_RTOL = 1e-3  # losses of the --multihost run against the plain run
# the tensor-parallel and cfg_group latents in a world of one against the
# plain one, as a share of max|plain| (both are the plain arithmetic there)
PARALLEL_LATENT_RTOL = 1e-3


def free_port():
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def parallel_engine_cfg():
    """[main]'s configuration: full-width SDXL, bf16, ray chunk 4096."""
    from custom_diffusion360_torch.engine import EngineConfig
    from custom_diffusion360_torch.models.unet import UNetConfig

    return EngineConfig(unet=UNetConfig(nerf_dtype="bfloat16", nerf_chunk_size=4096),
                        compute_dtype="bfloat16")


def time_grad_allreduce(torch, leaves, dev, calls=10):
    """The trainer's gradient all-reduce (parallel.all_reduce_mean over the
    trainable leaves, one flat bucket) on copies of ``leaves``, in the
    world that is up: the median of ``calls`` timed calls after two
    warm-ups (CUDA events on the card)."""
    from custom_diffusion360_torch.parallel import all_reduce_mean

    grads = [leaf.detach().clone() for leaf in leaves]
    times = []
    for i in range(calls + 2):
        if dev == "cuda":
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            all_reduce_mean(grads)
            end.record()
            torch.cuda.synchronize()
            ms = start.elapsed_time(end)
        else:
            t0 = time.perf_counter()
            all_reduce_mean(grads)
            ms = (time.perf_counter() - t0) * 1e3
        if i >= 2:
            times.append(ms)
    values = sum(g.numel() for g in grads)
    nbytes = sum(g.numel() * g.element_size() for g in grads)
    return {"values": values, "bytes": nbytes, "ms": statistics.median(times), "calls": calls,
            "ring4_bytes_per_rank": 2 * 3 / 4 * nbytes}


def run_parallel_path(torch, counters, dev="cuda"):
    """custom_diffusion360_torch.parallel on the card, in a one-rank NCCL
    world (MASTER_ADDR, MASTER_PORT, RANK=0, WORLD_SIZE=1 set here):
    1. cli.train.main at the [train-cli] configuration (the synthetic CO3D
       tree, 512^2, 1 + 4 views, --seed 23) for PARALLEL_TRAIN_STEPS steps,
       plain and then under --multihost --coordinator localhost:<port>
       --num_processes 1 --process_id 0 (the group comes up there: NCCL,
       the gradient all-reduce, the replicate check, the view-sharded
       capture's all-gather, the rank-0 gates); the losses must agree within
       PARALLEL_LOSS_RTOL; each run's step times are printed, and the
       gradient all-reduce of the trainable leaves is timed on its own;
    2. cli.sample.main at the [cli] configuration (1024^2, x3, 8 views, both
       switches) for PARALLEL_SAMPLE_STEPS steps, plain and with
       --latency_shard; the images must agree within 1 of 255;
    3. Engine.sample at the [main] configuration for PARALLEL_SAMPLE_STEPS
       steps: plain, on tensor-parallel slices with the world as the model
       group (every to_out and ff out through an all-reduce), with the
       CFG rows over the world (cfg_group, the latency path's all-gather),
       and on a 1 x 1 (cfg, view) grid from new_groups_2d with cfg_group and
       view_group both set (the view-sharded render: the pose blocks' view
       softmax, pool and density through all-reduces); each latent within
       PARALLEL_LATENT_RTOL of max|plain|, and the render step's time (to
       the sampler's first callback) of the view-grouped run beside the
       plain one's.
    The counters are zeroed just before step 1 and read after step 3; the
    process group is destroyed at the end. Returns (launches, by_shape)."""
    import csv
    import tempfile

    import numpy as np
    import torch.distributed as dist

    from custom_diffusion360_torch.cli import sample as cli_sample
    from custom_diffusion360_torch.cli import train as cli_train
    from custom_diffusion360_torch.diffusion.guiders import vanilla_cfg_img_ref
    from custom_diffusion360_torch.engine import Engine
    from custom_diffusion360_torch.models.unet import UNetConfig
    from custom_diffusion360_torch.parallel import (
        barrier,
        new_groups_2d,
        shard_params_tp,
        tensor_parallel,
    )

    def sync():
        if dev == "cuda":
            torch.cuda.synchronize()

    env = {"MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(free_port()), "RANK": "0",
           "WORLD_SIZE": "1", "LOCAL_RANK": "0"}
    saved_env = {k: os.environ.get(k) for k in list(env) + list(CLI_SWITCHES)}
    os.environ.update(env)
    t_phase = time.time()
    problems = []
    report = {}
    for c in counters.values():
        c.launches = 0
        c.launches_by_shape.clear()
    orig_init = patch_init_params(torch, on_cpu=False)
    try:
        with tempfile.TemporaryDirectory() as d:
            root = write_co3d_tree(os.path.join(d, "co3d"))
            base = ["--data_root", root, "--category", "car", "--seed", str(TRAIN_CLI_SEED),
                    "--img_size", "512", "--num_images", "5", "--batch_size", "1",
                    "--max_steps", str(PARALLEL_TRAIN_STEPS), "--log_every", "1",
                    "--device", dev, "--override", "compute_dtype=bfloat16"]
            runs = {}
            for tag, extra in (("plain", []), ("multihost", [
                    "--multihost", "--coordinator", f"localhost:{free_port()}",
                    "--num_processes", "1", "--process_id", "0"])):
                out = os.path.join(d, tag)
                t0 = time.perf_counter()
                summary = cli_train.main(base + ["--output_dir", out] + extra)
                sync()
                main_s = time.perf_counter() - t0
                with open(os.path.join(out, "metrics.csv"), newline="") as f:
                    rows = [r for r in csv.DictReader(f) if r.get("loss")]
                if tag == "multihost":
                    runs["allreduce"] = time_grad_allreduce(torch, summary["trainable"], dev)
                runs[tag] = {"loss": [float(r["loss"]) for r in rows],
                             "loss_total": [float(r["loss_total"]) for r in rows],
                             "grad_norm": [float(r["grad_norm"]) for r in rows],
                             "step_ms": [s["step_s"] * 1e3 for s in summary["steps"]],
                             "capture_s": summary["capture_s"], "main_s": main_s}
                log(f"[parallel] train CLI {tag}: steps "
                    f"{', '.join(f'{m:.1f}' for m in runs[tag]['step_ms'])} ms; loss "
                    f"{runs[tag]['loss']}, grad_norm {runs[tag]['grad_norm']}; capture "
                    f"{summary['capture_s']:.2f} s; main() {main_s:.1f} s")
            ar = runs["allreduce"]
            log(f"[parallel] gradient all-reduce of the {ar['values'] / 1e6:.2f} M trainable "
                f"values ({ar['bytes'] / 1e6:.1f} MB f32), one rank: {ar['ms']:.3f} ms a call "
                f"(median of {ar['calls']}, CUDA events), "
                f"{100 * ar['ms'] / statistics.median(runs['plain']['step_ms']):.3f} % of the "
                f"plain run's median step; a 4-rank ring would move 2 (N - 1) / N x "
                f"{ar['bytes'] / 1e6:.1f} MB = {ar['ring4_bytes_per_rank'] / 1e6:.1f} MB a rank "
                f"a step (reckoned, not measured)")
            backend = dist.get_backend() if dist.is_initialized() else None
            world = dist.get_world_size() if dist.is_initialized() else 0
            log(f"[parallel] process group: backend {backend}, world size {world}")
            if world != 1 or backend != ("nccl" if dev == "cuda" else "gloo"):
                problems.append(f"--multihost left no one-rank group ({backend}, {world})")
            plain, multi = runs["plain"], runs["multihost"]
            for key in ("loss", "loss_total", "grad_norm"):
                a, b = plain[key], multi[key]
                if len(a) != PARALLEL_TRAIN_STEPS or len(b) != len(a) or any(
                        not math.isfinite(x) or abs(x - y) > PARALLEL_LOSS_RTOL * abs(x)
                        for x, y in zip(a, b)):
                    problems.append(f"--multihost {key} {b} against the plain run's {a}")
            report["train_cli"] = runs

        with cli_setup(torch, UNetConfig(), LATENT, (768, 1280), on_cpu=False) as setup:
            argv = setup.argv("--resolution", str(8 * LATENT), "--num_images", "1", "--batch",
                              "1", "--seed", "0", "--device", dev, "--dtype", "bfloat16",
                              "--num_steps", str(PARALLEL_SAMPLE_STEPS))
            recs = {}
            for tag, extra in (("plain", []), ("latency_shard", ["--latency_shard"])):
                (recs[tag],) = cli_sample.main(argv + extra)
                log(f"[parallel] sample CLI {tag}: image latency {recs[tag]['seconds']:.2f} s")
            a = recs["plain"]["images"].astype(np.int16)
            b = recs["latency_shard"]["images"].astype(np.int16)
            diff = int(np.abs(a - b).max()) if a.shape == b.shape else None
            log(f"[parallel] sample CLI --latency_shard vs plain: image {b.shape}, max "
                f"difference {diff} of 255 (limit 1)")
            if diff is None or diff > 1 or float(a.std()) <= 1.0:
                problems.append(f"--latency_shard image differs from the plain one by {diff}")
            report["latency_shard"] = {"max_diff_255": diff,
                                       "seconds": {k: r["seconds"] for k, r in recs.items()}}

        cfg = parallel_engine_cfg()
        eng = Engine(cfg, device=dev)
        params = perturb_zero_leaves(torch, eng.init_params(seed=0), seed=5)
        guider = vanilla_cfg_img_ref(scale=7.5)
        kw = dict(noise=torch.randn((1, LATENT, LATENT, 4), generator=torch.Generator(
                      device=dev).manual_seed(4), device=dev),
                  cams=make_cameras(torch, N_REF, guider.num_copies, dev),
                  references=make_references(torch, cfg.unet, N_REF, LATENT, dev),
                  choices=list(range(N_REF)), num_steps=PARALLEL_SAMPLE_STEPS)
        cond = make_cond(torch, cfg.unet, 1, dev, torch.bfloat16, seed=2)
        uc = make_cond(torch, cfg.unet, 1, dev, torch.bfloat16, seed=3)
        group = dist.group.WORLD

        def timed(fn):
            sync()
            t0 = time.perf_counter()
            z = fn()
            sync()
            return z, time.perf_counter() - t0

        def rendered(fn):
            """fn(callback) -> (z, seconds, seconds to the render step's end:
            the sampler's callback after step 0)"""
            marks = []

            def cb(i):
                if i == 0:
                    sync()
                    marks.append(time.perf_counter())

            sync()
            t0 = time.perf_counter()
            z, total = timed(lambda: fn(cb))
            return z, total, marks[0] - t0

        ref, ref_s, ref_render = rendered(
            lambda cb: eng.sample(params, cond, uc, guider, callback=cb, **kw))
        local = shard_params_tp(params, dist.get_world_size(group), dist.get_rank(group))
        with tensor_parallel(group):
            z_tp, tp_s = timed(lambda: eng.sample(local, cond, uc, guider, **kw))
        del local
        z_cfg, cfg_s = timed(lambda: eng.sample(params, cond, uc, guider, cfg_group=group, **kw))
        cfg_g, view_g = new_groups_2d(1, 1)
        barrier(cfg_g)  # a new group's communicator comes up at its first collective
        barrier(view_g)
        z_view, view_s, view_render = rendered(lambda cb: eng.sample(
            params, cond, uc, guider, cfg_group=cfg_g, view_group=view_g, callback=cb, **kw))
        scale = float(ref.abs().max())
        errs = {}
        for tag, z in (("tp", z_tp), ("cfg_group", z_cfg), ("view_group", z_view)):
            errs[tag] = float((z - ref).abs().max())
            ok = bool(torch.isfinite(z).all()) and errs[tag] <= PARALLEL_LATENT_RTOL * scale
            if not ok:
                problems.append(f"{tag} latent differs from the plain one by {errs[tag]} "
                                f"(max|plain| {scale})")
        log(f"[parallel] Engine.sample [main] config, {PARALLEL_SAMPLE_STEPS} steps: plain "
            f"{ref_s:.2f} s, tensor-parallel (model group of 1) {tp_s:.2f} s, max difference "
            f"{errs['tp']:.4g}; cfg_group {cfg_s:.2f} s, max difference {errs['cfg_group']:.4g}; "
            f"cfg_group + view_group (1 x 1 grid) {view_s:.2f} s, max difference "
            f"{errs['view_group']:.4g} (max|plain| {scale:.4g}, limit {PARALLEL_LATENT_RTOL:g} "
            f"of it)")
        log(f"[parallel] render step (step 0, to its callback): plain {1e3 * ref_render:.1f} ms, "
            f"view_group {1e3 * view_render:.1f} ms")
        report["engine"] = {"plain_s": ref_s, "tp_s": tp_s, "cfg_group_s": cfg_s,
                            "view_group_s": view_s, "tp_max_err": errs["tp"],
                            "cfg_group_max_err": errs["cfg_group"],
                            "view_group_max_err": errs["view_group"], "scale": scale,
                            "render_ms": {"plain": 1e3 * ref_render,
                                          "view_group": 1e3 * view_render}}
        del params, eng
    finally:
        from custom_diffusion360_torch.engine import Engine as _Engine

        _Engine.init_params = orig_init
        for k, v in saved_env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        if dist.is_initialized():
            dist.destroy_process_group()
    launches = {k: c.launches for k, c in counters.items()}
    by_shape = {(k, shape): n for k, c in counters.items()
                for shape, n in c.launches_by_shape.items()}
    report["launches"] = launches
    report["wall_s"] = time.time() - t_phase
    log(f"[parallel] launches {json.dumps(launches)}; phase wall {report['wall_s']:.1f} s")
    print(json.dumps({"parallel_path": report}), flush=True)
    if problems:
        raise RuntimeError("parallel path: " + "; ".join(problems))
    if dev == "cuda":
        torch.cuda.empty_cache()
    return launches, by_shape


# ---------------------------------------------------------------------------
# phase 5e: the evaluation CLI at full width
# ---------------------------------------------------------------------------

EVAL_IMAGES, EVAL_SIZE, EVAL_BATCH = 32, 512, 8
EVAL_PROMPT = "photo of a <new1> car"
# a synthetic BPE merges file (no vocabulary file in the repo): enough
# merges to spell the prompt's words
EVAL_MERGES = ["p h", "o t", "ph ot", "ph ot o</w>", "o f</w>", "c a", "ca r</w>", "a </w>"]
EVAL_SELF_FID_TOL = 1e-3  # FID of a set against itself, absolute
EVAL_SELF_CLIP_I_TOL = 1e-4  # CLIP-I of a set against itself, from 1


def write_eval_files(torch, d, dev):
    """Under ``d``: pytorch_fid InceptionV3 names (``inception.pth``), open_clip
    ViT-H/14 names, ``visual.*`` and the text tower at the root, in one
    file (``open_clip_vit_h14.pth``), random weights drawn on ``dev`` from
    seeds; the merges file under the CLI's name (``vocab/``); and
    EVAL_IMAGES "generated" and EVAL_IMAGES "real" EVAL_SIZE^2 PNGs of
    seeded noise (the real ones darker). Returns the paths by name."""
    import gzip

    import numpy as np

    from custom_diffusion360_torch.cli.evaluate import VIT_H14_TEXT
    from custom_diffusion360_torch.cli.sample import write_png
    from custom_diffusion360_torch.eval.inception import _STEM, _TORCH_NAMES, BLOCKS
    from custom_diffusion360_torch.models.clip import ClipVisionConfig

    gen = torch.Generator(device=dev).manual_seed(31)

    def randn(*shape, std):
        return (torch.randn(shape, generator=gen, device=dev) * std).cpu()

    inc = {}

    def conv(prefix, cin, cout, kh, kw):
        # He scaling: the features keep their size through the ReLUs
        inc[prefix + ".conv.weight"] = randn(cout, cin, kh, kw,
                                             std=(2.0 / (cin * kh * kw)) ** 0.5)
        inc[prefix + ".bn.weight"] = 1.0 + randn(cout, std=0.1)
        inc[prefix + ".bn.bias"] = randn(cout, std=0.1)
        inc[prefix + ".bn.running_mean"] = randn(cout, std=0.1)
        inc[prefix + ".bn.running_var"] = 1.0 + randn(cout, std=0.1).abs()

    for name, cin, cout, (kh, kw), _, _ in _STEM:
        conv(name, cin, cout, kh, kw)
    for bname, kind, spec in BLOCKS:
        for branch, convs in spec.items():
            for tname, (cin, cout, (kh, kw), _, _) in zip(_TORCH_NAMES[kind][branch], convs):
                conv(f"{bname}.{tname}", cin, cout, kh, kw)

    clip = {}

    def put(name, *shape, std=None):
        clip[name] = randn(*shape, std=std if std is not None else shape[-1] ** -0.5)

    def norm(prefix, width):
        clip[prefix + ".weight"] = 1.0 + randn(width, std=0.1)
        clip[prefix + ".bias"] = randn(width, std=0.1)

    def blocks(prefix, width, layers):
        for i in range(layers):
            pre = f"{prefix}transformer.resblocks.{i}"
            norm(pre + ".ln_1", width)
            norm(pre + ".ln_2", width)
            put(pre + ".attn.in_proj_weight", 3 * width, width)
            put(pre + ".attn.in_proj_bias", 3 * width, std=0.02)
            put(pre + ".attn.out_proj.weight", width, width)
            put(pre + ".attn.out_proj.bias", width, std=0.02)
            put(pre + ".mlp.c_fc.weight", 4 * width, width)
            put(pre + ".mlp.c_fc.bias", 4 * width, std=0.02)
            put(pre + ".mlp.c_proj.weight", width, 4 * width)
            put(pre + ".mlp.c_proj.bias", width, std=0.02)

    v, t = ClipVisionConfig(), VIT_H14_TEXT
    put("visual.conv1.weight", v.width, 3, v.patch_size, v.patch_size, std=0.02)
    put("visual.class_embedding", v.width)
    put("visual.positional_embedding", v.grid ** 2 + 1, v.width)
    norm("visual.ln_pre", v.width)
    norm("visual.ln_post", v.width)
    put("visual.proj", v.width, v.embed_dim)
    blocks("visual.", v.width, v.layers)
    put("token_embedding.weight", t.vocab_size, t.width, std=0.02)
    put("positional_embedding", t.context_length, t.width, std=0.01)
    norm("ln_final", t.width)
    put("text_projection", t.width, t.width)
    blocks("", t.width, t.layers)

    paths = {"inception": os.path.join(d, "inception.pth"),
             "clip": os.path.join(d, "open_clip_vit_h14.pth"), "vocab": os.path.join(d, "vocab"),
             "generated": os.path.join(d, "generated"), "real": os.path.join(d, "real")}
    torch.save(inc, paths["inception"])
    torch.save(clip, paths["clip"])
    os.makedirs(paths["vocab"])
    with gzip.open(os.path.join(paths["vocab"], "bpe_simple_vocab_16e6.txt.gz"), "wt") as f:
        f.write("\n".join(["#version: synthetic"] + EVAL_MERGES) + "\n")
    rng = np.random.default_rng(32)
    for name, lo, hi in (("generated", 64, 256), ("real", 0, 192)):
        os.makedirs(paths[name])
        for i in range(EVAL_IMAGES):
            img = rng.integers(lo, hi, (EVAL_SIZE, EVAL_SIZE, 3)).astype(np.uint8)
            write_png(os.path.join(paths[name], f"{i:03d}.png"), img)
    paths["sizes_mb"] = {k: os.path.getsize(paths[k]) / 1e6 for k in ("inception", "clip")}
    return paths


def run_evaluate_path(torch, counters, dev="cuda"):
    """custom_diffusion360_torch.cli.evaluate.main in process at full width
    with random weights (write_eval_files): InceptionV3 at 299^2, the
    ViT-H/14 vision tower at 224^2 and the open_clip ViT-H/14 text tower,
    --batch EVAL_BATCH, all three metrics (FID, CLIP-T, CLIP-I) on 32
    generated against 32 real 512^2 PNGs; then again with the generated
    set as the real one: its FID must be 0 within EVAL_SELF_FID_TOL and its
    CLIP-I 1 within EVAL_SELF_CLIP_I_TOL. Prints each checkpoint's load
    time (read, convert, to the card), images/s through Inception (with its
    resize) and through the vision tower, the host time of the Frechet
    distance, and the scores. Counters zeroed just before the first run and
    read after the second (path "evaluate")."""
    import copy
    import importlib
    import tempfile

    from custom_diffusion360_torch.cli import evaluate as cli_eval

    # the module (eval/__init__.py exports its function clip_score by that name)
    clip_mod = importlib.import_module("custom_diffusion360_torch.eval.clip_score")

    def sync():
        if dev == "cuda":
            torch.cuda.synchronize()

    t_phase = time.time()
    stats = {"read_s": [], "convert_s": {}, "to_card_s": [], "fid_host_s": [],
             "inception": [], "vision": []}  # per call (images, s)

    def timed(fn, record):
        def call(*a, **kw):
            sync()
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            sync()
            record(a, time.perf_counter() - t0)
            return out
        return call

    def images(key):
        def record(a, sec):
            stats[key].append((a[1].shape[0], sec))
        return record

    patches = {
        (cli_eval, "load_torch_state_dict"): lambda a, sec: stats["read_s"].append(
            (os.path.basename(a[0]), sec)),
        (cli_eval, "load_inception_torch"): lambda a, sec: stats["convert_s"].update(
            inception=sec),
        (cli_eval, "load_clip_vision_torch"): lambda a, sec: stats["convert_s"].update(
            clip_vision=sec),
        (cli_eval, "convert_open_clip_state_dict"): lambda a, sec: stats["convert_s"].update(
            clip_text=sec),
        (cli_eval, "_to"): lambda a, sec: stats["to_card_s"].append(sec),
        (cli_eval, "fid_from_stats"): lambda a, sec: stats["fid_host_s"].append(sec),
        (cli_eval, "inception_pool3_features"): images("inception"),
        (clip_mod, "clip_vision_apply"): images("vision"),
    }
    saved = {key: getattr(*key) for key in patches}
    for c in counters.values():
        c.launches = 0
        c.launches_by_shape.clear()
    try:
        for (mod, name), record in patches.items():
            setattr(mod, name, timed(saved[(mod, name)], record))
        with tempfile.TemporaryDirectory() as d:
            t0 = time.time()
            paths = write_eval_files(torch, d, dev)
            log(f"[evaluate] wrote {EVAL_IMAGES} + {EVAL_IMAGES} {EVAL_SIZE}^2 PNGs, inception "
                f"{paths['sizes_mb']['inception']:.1f} MB, open_clip ViT-H/14 "
                f"{paths['sizes_mb']['clip']:.1f} MB in {time.time() - t0:.1f} s")
            common = ["--inception_ckpt", paths["inception"], "--clip_vision_ckpt",
                      paths["clip"], "--batch", str(EVAL_BATCH), "--device", dev]
            t0 = time.perf_counter()
            scores = cli_eval.main(["--generated", paths["generated"], "--real", paths["real"],
                                    "--prompt", EVAL_PROMPT, "--clip_text_ckpt", paths["clip"],
                                    "--vocab_dir", paths["vocab"],
                                    "--output", os.path.join(d, "metrics.json")] + common)
            main_s = time.perf_counter() - t0
            with open(os.path.join(d, "metrics.json")) as f:
                written = json.load(f)
            run1 = copy.deepcopy(stats)
            self_scores = cli_eval.main(["--generated", paths["generated"], "--real",
                                         paths["generated"]] + common)
    finally:
        for (mod, name), fn in saved.items():
            setattr(mod, name, fn)
    launches = {k: c.launches for k, c in counters.items()}
    by_shape = {(k, shape): n for k, c in counters.items()
                for shape, n in c.launches_by_shape.items()}
    rates = {}
    for key in ("inception", "vision"):
        calls = run1[key]
        n, sec = sum(c[0] for c in calls), sum(c[1] for c in calls)
        # warm: the median call of both runs after each run's first
        warm = statistics.median(c[1] for c in calls[1:] + stats[key][len(calls) + 1:])
        rates[key] = {"images": n, "s": sec, "images_per_s": n / sec, "first_call_s": calls[0][1],
                      "warm_call_s": warm, "warm_images_per_s": EVAL_BATCH / warm}
    inc_n, vis_n = rates["inception"]["images"], rates["vision"]["images"]
    report = {"scores": scores, "self_scores": self_scores, "main_s": main_s,
              "read_s": run1["read_s"], "convert_s": run1["convert_s"],
              "to_card_s": run1["to_card_s"], "fid_host_s": run1["fid_host_s"],
              "rates": rates, "launches": launches, "wall_s": time.time() - t_phase}
    for name, sec in run1["read_s"]:
        log(f"[evaluate] torch.load {name}: {sec:.2f} s")
    log(f"[evaluate] convert {json.dumps({k: round(v, 3) for k, v in run1['convert_s'].items()})}"
        f" s; to the card {', '.join(f'{x:.3f}' for x in run1['to_card_s'])} s")
    for key, what in (("inception", "Inception (resize to 299^2 + pool3)"),
                      ("vision", "ViT-H/14 vision tower (224^2, 257 tokens)")):
        r = rates[key]
        log(f"[evaluate] {what}, batch {EVAL_BATCH}: first run {r['images']} images in "
            f"{r['s']:.3f} s, {r['images_per_s']:.1f} images/s (its first call "
            f"{1e3 * r['first_call_s']:.1f} ms); warm call (median) {1e3 * r['warm_call_s']:.2f} "
            f"ms, {r['warm_images_per_s']:.1f} images/s")
    log(f"[evaluate] Frechet distance (2048-d, host numpy float64): "
        f"{', '.join(f'{x:.3f}' for x in run1['fid_host_s'])} s; main() {main_s:.1f} s")
    log(f"[evaluate] scores {json.dumps(scores)}; the generated set against itself "
        f"{json.dumps(self_scores)} (FID limit {EVAL_SELF_FID_TOL:g}, CLIP-I limit 1 +- "
        f"{EVAL_SELF_CLIP_I_TOL:g})")
    log(f"[evaluate] launches {json.dumps(launches)}; phase wall {report['wall_s']:.1f} s")
    print(json.dumps({"evaluate_path": report}), flush=True)
    problems = []
    if sorted(scores) != ["clip_i", "clip_t", "fid"] or written != scores or not all(
            math.isfinite(x) for x in scores.values()):
        problems.append(f"scores {scores} (written {written})")
    if not abs(self_scores.get("fid", math.inf)) <= EVAL_SELF_FID_TOL:
        problems.append(f"FID of a set against itself {self_scores.get('fid')}")
    if not abs(self_scores.get("clip_i", math.inf) - 1.0) <= EVAL_SELF_CLIP_I_TOL:
        problems.append(f"CLIP-I of a set against itself {self_scores.get('clip_i')}")
    if inc_n != 2 * EVAL_IMAGES or vis_n != 3 * EVAL_IMAGES:  # the first run's
        problems.append(f"{inc_n} images through Inception, {vis_n} through the vision tower")
    if problems:
        raise RuntimeError("evaluate path: " + "; ".join(problems))
    if dev == "cuda":
        torch.cuda.empty_cache()
    return launches, by_shape


# ---------------------------------------------------------------------------
# phase 5f: the autoencoder trainer at full width
# ---------------------------------------------------------------------------

AE_RES, AE_BATCH = 256, 4


def write_ae_weights(torch, d, ndf, n_layers, seed=0):
    """Synthetic torch checkpoints at their real layouts, from a seed, in
    ``d``: a torchvision vgg16 ``features`` state dict (He-scaled 3x3
    kernels), taming's LPIPS heads ``lin{k}.model.1.weight`` (1, C, 1, 1),
    and an NLayerDiscriminator ``main.{i}`` state dict with BatchNorm
    (weights_init's N(0, 0.02) convs and N(1, 0.02) scales, running
    statistics). Returns the three paths."""
    from custom_diffusion360_torch.models.lpips import CHNS, VGG_SLICES

    gen = torch.Generator().manual_seed(seed)
    vgg, heads, disc = {}, {}, {}
    cin = 3
    for slice_ids, c in zip(VGG_SLICES, CHNS):
        for idx in slice_ids:
            vgg[f"features.{idx}.weight"] = (torch.randn((c, cin, 3, 3), generator=gen)
                                             * (2.0 / (9 * cin)) ** 0.5)
            vgg[f"features.{idx}.bias"] = torch.zeros(c)
            cin = c
    for k, c in enumerate(CHNS):
        heads[f"lin{k}.model.1.weight"] = torch.rand((1, c, 1, 1), generator=gen) * 0.1
    chans = [ndf * min(2 ** n, 8) for n in range(n_layers + 1)]
    disc["main.0.weight"] = torch.randn((chans[0], 3, 4, 4), generator=gen) * 0.02
    disc["main.0.bias"] = torch.zeros(chans[0])
    for k in range(n_layers):
        c = chans[k + 1]
        disc[f"main.{2 + 3 * k}.weight"] = torch.randn((c, chans[k], 4, 4), generator=gen) * 0.02
        disc[f"main.{3 + 3 * k}.weight"] = 1.0 + torch.randn((c,), generator=gen) * 0.02
        disc[f"main.{3 + 3 * k}.bias"] = torch.zeros(c)
        disc[f"main.{3 + 3 * k}.running_mean"] = torch.zeros(c)
        disc[f"main.{3 + 3 * k}.running_var"] = torch.ones(c)
        disc[f"main.{3 + 3 * k}.num_batches_tracked"] = torch.zeros((), dtype=torch.long)
    disc[f"main.{2 + 3 * n_layers}.weight"] = (torch.randn((1, chans[-1], 4, 4), generator=gen)
                                               * 0.02)
    disc[f"main.{2 + 3 * n_layers}.bias"] = torch.zeros(1)
    paths = tuple(os.path.join(d, name) for name in ("vgg.pth", "vgg16.pth", "disc.pth"))
    for sd, path in zip((heads, vgg, disc), paths):
        torch.save(sd, path)
    return paths


def run_ae_train_path(torch, counters):
    """AEEngine.train_step at full width: the SDXL VAE (VAEConfig(): ch 128,
    mult (1, 2, 4, 4), 2 res blocks, z 4) with the KL posterior, LPIPS on
    the full VGG16 and the PatchGAN (ndf 64, 3 layers) from checkpoints at
    their torch layouts (write_ae_weights, read by load_lpips_torch and
    load_discriminator_torch), AEEngineConfig's defaults (hinge, disc_start
    0: both GAN terms from the first step), AE_BATCH bf16 images of
    AE_RES^2, CD360_VAE_CONV=pallas. One warm-up step, TRAIN_STEPS timed
    steps with the counters zeroed just before and read just after, one
    traced step. Fails unless every log value is finite and both sides
    moved."""
    import tempfile

    from custom_diffusion360_torch.draws import Draws
    from custom_diffusion360_torch.models.discriminator import load_discriminator_torch
    from custom_diffusion360_torch.models.lpips import load_lpips_torch
    from custom_diffusion360_torch.train.ae_engine import AEEngine, AEEngineConfig, init_ae_engine
    from custom_diffusion360_torch.train.trainer import tree_leaves

    cfg = AEEngineConfig()
    saved = os.environ.get("CD360_VAE_CONV")
    os.environ["CD360_VAE_CONV"] = "pallas"
    try:
        t0 = time.time()
        with tempfile.TemporaryDirectory() as d:
            lp, vgg, disc = write_ae_weights(torch, d, cfg.disc_ndf, cfg.disc_n_layers, seed=31)
            t_write = time.time() - t0
            params = init_ae_engine(cfg, seed=30, device="cuda")
            params["lpips"] = load_lpips_torch(lp, vgg, device="cuda")
            params["disc"] = load_discriminator_torch(
                torch.load(disc, map_location="cpu", weights_only=True), cfg.disc_n_layers,
                cfg.use_actnorm, device="cuda")
        eng = AEEngine(cfg, device="cuda")
        state = eng.init_state(params)
        del params
        sizes = {side: sum(p.numel() for p in tree_leaves(state.params[side]))
                 for side in ("ae", "disc", "lpips")}
        gen = torch.Generator(device="cuda").manual_seed(32)
        x = (torch.rand((AE_BATCH, AE_RES, AE_RES, 3), generator=gen, device="cuda") * 2.0
             - 1.0).to(torch.bfloat16)
        torch.cuda.synchronize()
        log(f"[ae-train] parameters {json.dumps({k: v / 1e6 for k, v in sizes.items()})} M "
            f"(f32); weights written {t_write:.1f} s, setup {time.time() - t0:.1f} s; "
            f"{AE_BATCH} x {AE_RES}^2 bf16 images, CD360_VAE_CONV=pallas")

        def step(i):
            nonlocal state
            torch.cuda.synchronize()
            start = time.perf_counter()
            state, logs = eng.train_step(
                state, x, Draws(torch.Generator(device="cuda").manual_seed(200 + i)))
            logs = {k: float(v) for k, v in logs.items()}  # synchronizes
            torch.cuda.synchronize()
            return time.perf_counter() - start, logs

        t_warm = step(0)[0]
        before = {side: [leaf.detach().clone() for leaf in tree_leaves(state.params[side])]
                  for side in ("ae", "disc")}
        for c in counters.values():
            c.launches = 0
            c.launches_by_shape.clear()
        torch.cuda.reset_peak_memory_stats()
        runs = [step(1 + i) for i in range(TRAIN_STEPS)]
        launches = {k: c.launches for k, c in counters.items()}
        by_shape = {(k, shape): n for k, c in counters.items()
                    for shape, n in c.launches_by_shape.items()}
        peak = torch.cuda.max_memory_allocated()
        norms = {side: float(torch.sqrt(sum(((leaf.detach() - old) ** 2).sum() for leaf, old in
                                            zip(tree_leaves(state.params[side]), olds))))
                 for side, olds in before.items()}
        del before
        times = sorted(r[0] * 1e3 for r in runs)
        med = statistics.median(times)
        last = runs[-1][1]
        ok = all(math.isfinite(v) for _, logs in runs for v in logs.values()) and min(
            norms.values()) > 0.0
        log(f"[ae-train] warm-up step {t_warm * 1e3:.1f} ms; {TRAIN_STEPS} timed steps: median "
            f"{med:.1f} ms (min {times[0]:.1f}, max {times[-1]:.1f}); peak memory allocated "
            f"{peak / 2**30:.2f} GiB; update norms over the timed steps: AE "
            f"{norms['ae']:.6e}, discriminator {norms['disc']:.6e}")
        log("[ae-train] last step's logs: " + " ".join(f"{k} {v:.6g}"
                                                       for k, v in sorted(last.items())))
        log(f"[ae-train] launches in the timed steps {json.dumps(launches)}")
        for (k, shape), n in sorted(by_shape.items(), key=str):
            log(f"[ae-train] launches {k} {shape}: {n} ({n / TRAIN_STEPS:g} per step)")
        print(json.dumps({"ae_train_path": {
            "step_ms_median": med, "step_ms_min": times[0], "step_ms_max": times[-1],
            "step_ms": [r[0] * 1e3 for r in runs], "warmup_ms": t_warm * 1e3,
            "peak_gib": peak / 2**30, "update_norm": norms, "last_logs": last,
            "launches": launches}}), flush=True)
        if not ok:
            raise RuntimeError(f"autoencoder step: logs {last} / update norms {norms} not "
                               "finite and nonzero")
        prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                  torch.profiler.ProfilerActivity.CUDA])
        with prof:
            step(1 + TRAIN_STEPS)
        report_trace(torch, prof, med, 1, "ae train step")
        del state, eng, x
        torch.cuda.empty_cache()
        log(f"[ae-train] phase wall {time.time() - t0:.1f} s")
    finally:
        if saved is None:
            os.environ.pop("CD360_VAE_CONV", None)
        else:
            os.environ["CD360_VAE_CONV"] = saved
    return launches, by_shape


# ---------------------------------------------------------------------------
# phase 5g: the rest of the sgm model surface at published widths
# ---------------------------------------------------------------------------

AUX_CALLS = 5  # timed calls of each model after one warm-up
AUX_COND_TOL = 1e-2  # general vs specialized conditioner on the card, of max|ref|
# T5-v1.1 XXL (sgm FrozenT5Embedder's google/t5-v1_1-xxl) and XL
# (FrozenCLIPT5Encoder's google/t5-v1_1-xl)
T5_XXL = dict(vocab_size=32128, d_model=4096, d_kv=64, d_ff=10240, num_layers=24, num_heads=64)
T5_XL = dict(vocab_size=32128, d_model=2048, d_kv=64, d_ff=5120, num_layers=24, num_heads=32)
# guided-diffusion's 256^2 classifier (its resblock up/down and scale-shift
# norm, which the JAX package lacks, are cut); attention at ds 8, 16, 32
CLASSIFIER_256 = dict(image_size=256, in_channels=3, model_channels=128, out_channels=1000,
                      num_res_blocks=2, attention_resolutions=(8, 16, 32),
                      channel_mult=(1, 1, 2, 2, 4, 4), num_head_channels=64, pool="attention")
# Ho et al. 2020, LSUN 256^2
DDPM_LSUN_256 = dict(ch=128, out_ch=3, ch_mult=(1, 1, 2, 2, 4, 4), num_res_blocks=2,
                     attn_resolutions=(16,), in_channels=3, resolution=256)


def _n_params(tree):
    return sum(leaf.numel() for leaf in _leaves(tree))


def sdxl_embedder_specs(ccfg):
    """The SDXL conditioner stack (models/conditioner.py) as general
    conditioner specs: CLIP-L final, bigG penultimate and pooled, the three
    size embeddings; each on the target and the reference keys."""
    from custom_diffusion360_torch.models.clip import clip_text_apply
    from custom_diffusion360_torch.models.conditioner import embed_size_tuple
    from custom_diffusion360_torch.models.general_conditioner import EmbedderSpec

    def open_clip(p, tokens):
        out = clip_text_apply(p, tokens, ccfg.open_clip)
        return out["penultimate"], out["pooled"]

    return [EmbedderSpec("clip_l", lambda p, t: clip_text_apply(p, t, ccfg.clip_l)["final"],
                         input_keys=("tokens_clip", "tokens_clip_ref")),
            EmbedderSpec("open_clip", open_clip, input_keys=("tokens_open", "tokens_open_ref"))] + [
        EmbedderSpec(key, lambda _, x: embed_size_tuple(x, ccfg.size_outdim),
                     input_keys=(key, key + "_ref"))
        for key in ("original_size", "crop_coords", "target_size")]


def run_aux_path(torch, counters):
    """Every auxiliary model of the sgm surface once at its published width,
    bf16, random weights from seeds: T5-v1.1 XXL (2 x 77 tokens, beside the
    time to read its weights once), clip_t5_encode (CLIP-L + T5-v1.1 XL),
    ByT5 through byt5_tokenize, the general conditioner on the SDXL stack
    (target + 8 reference rows, held to the specialized apply_conditioner
    within AUX_COND_TOL of max|ref|), open_clip_embedder2 (bigG,
    penultimate, pooled), open_clip_image_embedder (ViT-H/14, 224^2, UCG
    0.1, batch 8), the guided-diffusion 256^2 classifier (batch 8), the
    DDPM LSUN-256 model (batch 4, vanilla and linear attention), the
    single-layer block at SDXL's 1280 width (1024 tokens; self-attention
    and a 77 x 2048 context), and the SDXL VAE through low_scale_encode ->
    low_scale_decode (CD360_VAE_CONV=pallas, the decode in bf16) and
    gaussian_encoder (batch 2, 512^2). Each model: one warm-up call, then
    the median of AUX_CALLS calls (host clock, synchronized), peak memory
    and kernel launches per call; every output finite. Counters zeroed just
    before the first model and read after the last (path "aux")."""
    from custom_diffusion360_torch.draws import Draws
    from custom_diffusion360_torch.models.clip import (
        CLIP_L_CONFIG,
        OPEN_CLIP_BIGG_CONFIG,
        ClipVisionConfig,
        init_clip_text_params,
        init_clip_vision_params,
    )
    from custom_diffusion360_torch.models.conditioner import (
        ConditionerConfig,
        apply_conditioner,
        init_conditioner_params,
    )
    from custom_diffusion360_torch.models.embedders import (
        LowScaleConfig,
        clip_t5_encode,
        gaussian_encoder,
        low_scale_decode,
        low_scale_encode,
        open_clip_embedder2,
        open_clip_image_embedder,
    )
    from custom_diffusion360_torch.models.encoder_unet import (
        EncoderUNetConfig,
        encoder_unet_apply,
        init_encoder_unet_params,
    )
    from custom_diffusion360_torch.models.extra_blocks import (
        DDPMModelConfig,
        ddpm_model_apply,
        init_ddpm_model_params,
        init_single_layer_block,
        single_layer_block_apply,
    )
    from custom_diffusion360_torch.models.general_conditioner import general_conditioner_apply
    from custom_diffusion360_torch.models.nn import Init
    from custom_diffusion360_torch.models.t5 import (
        BYT5_BASE,
        T5Config,
        byt5_tokenize,
        init_t5_params,
        t5_encode,
    )
    from custom_diffusion360_torch.models.vae import VAEConfig, init_vae_params

    bf16 = torch.bfloat16
    gen = torch.Generator(device="cuda").manual_seed(70)
    report = {}
    t_phase = time.time()
    for c in counters.values():
        c.launches = 0
        c.launches_by_shape.clear()

    def run(name, fn, params):
        """Warm-up, AUX_CALLS timed calls; logs and keeps the numbers."""
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = {k: c.launches for k, c in counters.items()}
        with torch.inference_mode():
            out = fn()
            torch.cuda.synchronize()
            times = []
            for _ in range(AUX_CALLS):
                start = time.perf_counter()
                out = fn()
                torch.cuda.synchronize()
                times.append((time.perf_counter() - start) * 1e3)
        outs = (list(out.values()) if isinstance(out, dict)
                else out if isinstance(out, (tuple, list)) else [out])
        outs = [o for o in outs if isinstance(o, torch.Tensor)]
        finite = all(bool(torch.isfinite(o.float()).all()) for o in outs)
        per_call = {k: (c.launches - before[k]) / (AUX_CALLS + 1) for k, c in counters.items()
                    if c.launches > before[k]}
        rec = {"ms_median": statistics.median(times), "ms_min": min(times),
               "ms_max": max(times), "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
               "params_m": params / 1e6, "launches_per_call": per_call,
               "shapes": [tuple(o.shape) for o in outs], "finite": finite}
        report[name] = rec
        log(f"[aux] {name}: {params / 1e6:.1f} M parameters; median {rec['ms_median']:.3f} ms "
            f"(min {rec['ms_min']:.3f}, max {rec['ms_max']:.3f}) over {AUX_CALLS} calls; peak "
            f"{rec['peak_gib']:.2f} GiB; launches per call {json.dumps(per_call)}; outputs "
            f"{rec['shapes']} {'finite' if finite else 'NOT FINITE'}")
        if not finite:
            raise RuntimeError(f"[aux] {name}: output not finite")
        return out

    # T5-v1.1 XXL: the weights are read once a call; the bound is that read
    cfg = T5Config(**T5_XXL)
    params = init_t5_params(cfg, seed=71, device="cuda", dtype=bf16)
    n = _n_params(params)
    tokens = torch.randint(0, cfg.vocab_size, (2, 77), generator=gen, device="cuda")
    run("t5_xxl_encode", lambda: t5_encode(params, tokens, cfg), n)
    report["t5_xxl_encode"]["weight_read_bound_ms"] = 2 * n / H100_BYTES_PER_S * 1e3
    log(f"[aux] t5_xxl_encode: reading its {2 * n / 1e9:.2f} GB of bf16 weights once takes "
        f">= {report['t5_xxl_encode']['weight_read_bound_ms']:.3f} ms at 3.35 TB/s")
    del params
    torch.cuda.empty_cache()

    clip_l = init_clip_text_params(CLIP_L_CONFIG, seed=72, device="cuda", dtype=bf16)
    t5_xl = init_t5_params(T5Config(**T5_XL), seed=73, device="cuda", dtype=bf16)
    clip_ids = clip_tokens(torch, 2, CLIP_L_CONFIG.vocab_size, "cuda")
    run("clip_t5_encode", lambda: clip_t5_encode(clip_l, t5_xl, clip_ids, tokens, CLIP_L_CONFIG,
                                                 T5Config(**T5_XL)),
        _n_params(clip_l) + _n_params(t5_xl))
    del clip_l, t5_xl

    byt5 = init_t5_params(BYT5_BASE, seed=74, device="cuda", dtype=bf16)
    ids, _ = byt5_tokenize(["a photo of a <new1> car on a beach at dusk",
                            "a <new1> car seen from behind, studio light"], 77)
    ids = torch.from_numpy(ids).to("cuda")
    run("byt5_encode", lambda: t5_encode(byt5, ids, BYT5_BASE), _n_params(byt5))
    del byt5
    torch.cuda.empty_cache()

    # the SDXL stack through the general conditioner, held to the specialized one
    ccfg = ConditionerConfig()
    cond = init_conditioner_params(ccfg, seed=75, device="cuda", dtype=bf16)
    specs = sdxl_embedder_specs(ccfg)
    batch = {}
    for suffix, rows in (("", 1), ("_ref", 8)):
        batch["tokens_clip" + suffix] = clip_tokens(torch, rows, ccfg.clip_l.vocab_size, "cuda")
        batch["tokens_open" + suffix] = clip_tokens(torch, rows, ccfg.open_clip.vocab_size,
                                                    "cuda")
        for key in ("original_size", "crop_coords", "target_size"):
            batch[key + suffix] = torch.full((rows, 2), 0.0 if key == "crop_coords" else 1024.0,
                                             device="cuda")
    got = run("general_conditioner_sdxl", lambda: general_conditioner_apply(cond, specs, batch),
              _n_params(cond))
    with torch.inference_mode():
        want = apply_conditioner(cond, batch, ccfg)
    errs = {}
    for key in ("crossattn", "vector"):
        if tuple(got[key].shape) != tuple(want[key].shape):
            raise RuntimeError(f"[aux] general conditioner {key} shape {tuple(got[key].shape)} "
                               f"vs specialized {tuple(want[key].shape)}")
        errs[key] = (float((got[key].float() - want[key].float()).abs().max()),
                     AUX_COND_TOL * float(want[key].float().abs().max()))
    log("[aux] general vs specialized conditioner on the card (1 + 8 rows): "
        + ", ".join(f"{k} max-abs {e:.3e} (tol {tol:.3e})" for k, (e, tol) in errs.items()))
    report["general_conditioner_sdxl"]["vs_specialized"] = errs
    if any(e > tol for e, tol in errs.values()):
        raise RuntimeError("[aux] the general conditioner disagrees with apply_conditioner")
    del got, want
    open_ids = clip_tokens(torch, 2, OPEN_CLIP_BIGG_CONFIG.vocab_size, "cuda")
    run("open_clip_embedder2_bigG", lambda: open_clip_embedder2(
        cond["open_clip"], open_ids, OPEN_CLIP_BIGG_CONFIG, layer="penultimate", legacy=False,
        return_pooled=True), _n_params(cond["open_clip"]))
    del cond
    torch.cuda.empty_cache()

    vcfg = ClipVisionConfig()
    vit = init_clip_vision_params(vcfg, seed=76, device="cuda", dtype=bf16)
    images = (torch.rand((8, 224, 224, 3), generator=gen, device="cuda") * 2 - 1).to(bf16)
    ucg_gen = torch.Generator(device="cuda").manual_seed(77)
    run("open_clip_image_embedder_vit_h14", lambda: open_clip_image_embedder(
        vit, images, vcfg, draws=Draws(ucg_gen), ucg_rate=0.1), _n_params(vit))
    del vit, images

    ecfg = EncoderUNetConfig(**CLASSIFIER_256)
    clf = init_encoder_unet_params(ecfg, seed=78, device="cuda", dtype=bf16)
    clf = perturb_zero_leaves(torch, clf, seed=79)
    x = torch.randn((8, 256, 256, 3), generator=gen, device="cuda").to(bf16)
    steps = torch.randint(0, 1000, (8,), generator=gen, device="cuda").float()
    run("encoder_unet_classifier_256", lambda: encoder_unet_apply(clf, x, steps, ecfg),
        _n_params(clf))
    del clf, x

    x = torch.randn((4, 256, 256, 3), generator=gen, device="cuda").to(bf16)
    steps = torch.randint(0, 1000, (4,), generator=gen, device="cuda").float()
    for attn_type in ("vanilla", "linear"):
        dcfg = DDPMModelConfig(**DDPM_LSUN_256, attn_type=attn_type)
        ddpm = init_ddpm_model_params(dcfg, seed=80, device="cuda", dtype=bf16)
        run(f"ddpm_lsun256_{attn_type}", lambda: ddpm_model_apply(ddpm, x, steps, cfg=dcfg),
            _n_params(ddpm))
        del ddpm
    del x
    torch.cuda.empty_cache()

    init = Init(81, "cuda", bf16)
    blk_self = init_single_layer_block(init, 1280, 20, 64)
    blk_ctx = init_single_layer_block(init, 1280, 20, 64, context_dim=2048)
    x = torch.randn((2, 1024, 1280), generator=gen, device="cuda").to(bf16)
    ctx = torch.randn((2, 77, 2048), generator=gen, device="cuda").to(bf16)
    run("single_layer_block_self", lambda: single_layer_block_apply(blk_self, x, n_heads=20),
        _n_params(blk_self))
    run("single_layer_block_context", lambda: single_layer_block_apply(
        blk_ctx, x, ctx, n_heads=20), _n_params(blk_ctx))
    del blk_self, blk_ctx, x, ctx

    vae_cfg, lcfg = VAEConfig(), LowScaleConfig()
    vae = init_vae_params(vae_cfg, seed=82, device="cuda", dtype=bf16)
    x = (torch.rand((2, 512, 512, 3), generator=gen, device="cuda") * 2 - 1).to(bf16)
    draw_gen = torch.Generator(device="cuda").manual_seed(83)
    z, _ = run("low_scale_encode_sdxl_vae", lambda: low_scale_encode(
        vae, x, Draws(draw_gen), lcfg, vae_cfg), _n_params(vae["encoder"]))
    saved = os.environ.get("CD360_VAE_CONV")
    os.environ["CD360_VAE_CONV"] = "pallas"
    try:
        zb = z.to(bf16)  # the decoder in bf16, where the conv3x3 kernel takes it
        run("low_scale_decode_sdxl_vae", lambda: low_scale_decode(vae, zb, lcfg, vae_cfg),
            _n_params(vae["decoder"]))
    finally:
        if saved is None:
            os.environ.pop("CD360_VAE_CONV", None)
        else:
            os.environ["CD360_VAE_CONV"] = saved
    run("gaussian_encoder_sdxl_vae", lambda: gaussian_encoder(vae, x, Draws(draw_gen),
                                                              vae_cfg=vae_cfg)[1],
        _n_params(vae["encoder"]))
    del vae, x, z, zb
    torch.cuda.empty_cache()

    launches = {k: c.launches for k, c in counters.items()}
    by_shape = {(k, shape): n for k, c in counters.items()
                for shape, n in c.launches_by_shape.items()}
    report["wall_s"] = time.time() - t_phase
    print(json.dumps({"aux_path": report}), flush=True)
    log(f"[aux] launches {json.dumps(launches)}; phase wall {report['wall_s']:.1f} s")
    return launches, by_shape


# ---------------------------------------------------------------------------
# phase 6: kernels vs plain versions through small samples and a train step
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
    base = EngineConfig(unet=UNetConfig(**SMALL_UNET), vae=VAEConfig(**SMALL_VAE),
                        conditioner=small_conditioner())
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
                           vae=VAEConfig(**SMALL_VAE), conditioner=base.conditioner,
                           compute_dtype=str(dtype)[6:])
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


def run_small_cli_check(torch):
    """cli.sample.main --smoke (x3 guider, both switches on, the VAE's
    bottleneck attention through the bnhd route), 3 steps at 256^2 (latent
    32), 4 reference views: bf16 through the kernels on the card vs f32
    through the plain versions on the CPU, from the same weights (made on
    the CPU) and the same per-job noise; the uint8 images must agree within
    SMALL_TOL of the 255 range."""
    import numpy as np

    from custom_diffusion360_torch.cli import sample as cli

    widths = (cli.SMOKE_CFG.conditioner.clip_l.width, cli.SMOKE_CFG.conditioner.open_clip.width)
    imgs, bnhd = {}, {}
    from custom_diffusion360_torch.ops.block_attention import attention_bnhd_fwd

    with cli_setup(torch, cli.SMOKE_CFG.unet, 32, widths, on_cpu=True) as setup:
        for device, dtype in (("cpu", "float32"), ("cuda", "bfloat16")):
            before = attention_bnhd_fwd.launches
            (rec,) = cli.main(setup.argv("--smoke", "--device", device, "--dtype", dtype,
                                         "--num_steps", "3", "--num_images", "1",
                                         "--resolution", "256", "--num_ref", "4"))
            imgs[device] = rec["images"].astype(np.float32)
            bnhd[device] = attention_bnhd_fwd.launches - before
    err = float(np.abs(imgs["cuda"] - imgs["cpu"]).max())
    tol = SMALL_TOL * 255.0
    ok = err <= tol and bnhd["cuda"] > 0 and float(imgs["cpu"].std()) > 1.0
    log(f"[small-cli] x3 --smoke image {imgs['cpu'].shape}: max-abs err cuda-bf16 vs cpu-f32 "
        f"{err:.1f} of 255 (tol {tol:.2f}); mean abs err "
        f"{float(np.abs(imgs['cuda'] - imgs['cpu']).mean()):.3f}; bnhd launches on the card "
        f"{bnhd['cuda']} {'OK' if ok else 'FAIL'}")
    if not ok:
        raise RuntimeError("small x3 CLI sample on the card disagrees with the CPU")


SMALL_TRAIN_UNET = dict(SMALL_UNET, context_dim=64, adm_in_channels=32 + 6 * 8,
                        nerf_chunk_size=128)
SMALL_CLIP = dict(vocab_size=64, width=32, layers=1, heads=2, context_length=16)
SMALL_OPEN = dict(SMALL_CLIP, layers=2, act="gelu", text_projection=True)


def small_conditioner():
    """Text towers of width 32 (context 64 = SMALL_TRAIN_UNET's), one V* row
    each, size embeddings of 8 per number."""
    from custom_diffusion360_torch.models.clip import ClipTextConfig
    from custom_diffusion360_torch.models.conditioner import ConditionerConfig

    return ConditionerConfig(clip_l=ClipTextConfig(**SMALL_CLIP),
                             open_clip=ClipTextConfig(**SMALL_OPEN), size_outdim=8)


def run_small_train_check(torch):
    """One training step at image 256^2 (latent 32), 1 + 2 views, small
    UNet, VAE and text towers: bf16 through the kernels on the card vs f32
    through the plain versions on the CPU, from the same weights (rounded to
    bf16 for both) and the same draws. The loss and every trainable leaf's
    gradient must agree within SMALL_TOL of max|ref| (the loss's, and the
    largest reference gradient of all trainable leaves)."""
    from custom_diffusion360_torch.draws import Draws
    from custom_diffusion360_torch.engine import Engine, EngineConfig
    from custom_diffusion360_torch.models.unet import UNetConfig
    from custom_diffusion360_torch.models.vae import VAEConfig
    from custom_diffusion360_torch.train.trainer import TrainConfig, Trainer, tree_leaves

    cond_cfg = small_conditioner()
    base = EngineConfig(unet=UNetConfig(**SMALL_TRAIN_UNET), vae=VAEConfig(**SMALL_VAE),
                        conditioner=cond_cfg)
    params = Engine(base, device="cpu").init_params(seed=20, dtype=torch.float32)
    params = _map(perturb_zero_leaves(torch, params, seed=21),
                  lambda x: x.to(torch.bfloat16) if x.is_floating_point() else x)
    batch = make_train_batch(torch, base, 1, 2, 256, "cpu", seed=22,
                             ids=(1, 5, None, SMALL_CLIP["vocab_size"] - 1))
    outs = {}
    for device, dtype in (("cpu", torch.float32), ("cuda", torch.bfloat16)):
        cfg = EngineConfig(unet=UNetConfig(**SMALL_TRAIN_UNET), vae=VAEConfig(**SMALL_VAE),
                           conditioner=cond_cfg, compute_dtype=str(dtype)[6:])
        trainer = Trainer(Engine(cfg, device=device), TrainConfig())
        state = trainer.init_state(
            _map(params, lambda x: x.to(device, dtype) if x.is_floating_point() else x.to(device)))
        b = {k: v.to(device) for k, v in batch.items()}
        state, metrics = trainer.train_step(state, b, Draws(torch.Generator().manual_seed(23)))
        grads = [leaf.grad.float().cpu() for lab, leaf in zip(tree_leaves(trainer.labels),
                                                               tree_leaves(state.params))
                 if lab != "frozen"]
        outs[device] = ({k: float(v) for k, v in metrics.items()}, grads)
    (m_ref, g_ref), (m_got, g_got) = outs["cpu"], outs["cuda"]
    loss_err = abs(m_got["loss"] - m_ref["loss"])
    loss_tol = SMALL_TOL * abs(m_ref["loss"])
    g_scale = max(float(g.abs().max()) for g in g_ref)
    g_err = max(float((a - b).abs().max()) for a, b in zip(g_got, g_ref))
    ok = loss_err <= loss_tol and g_err <= SMALL_TOL * g_scale and g_scale > 0
    log(f"[small-train] loss cuda-bf16 {m_got['loss']:.6f} vs cpu-f32 {m_ref['loss']:.6f} "
        f"(err {loss_err:.3e}, tol {loss_tol:.3e}); grad_norm {m_got['grad_norm']:.6f} vs "
        f"{m_ref['grad_norm']:.6f}; {len(g_ref)} trainable leaves, max-abs gradient err "
        f"{g_err:.3e} (tol {SMALL_TOL * g_scale:.3e} = {SMALL_TOL} x max|ref| {g_scale:.3e}) "
        f"{'OK' if ok else 'FAIL'}")
    if not ok:
        raise RuntimeError("small-config training step on the card disagrees with the CPU")


def run_small_capture_check(torch):
    """capture_references on a small config (SMALL_UNET and SMALL_VAE, 3
    images at 256^2 plus the zero image) with the same given draws: bf16
    through the kernels on the card vs f32 through the plain versions on
    the CPU, from the same weights. Every pose block's buffer must agree
    within SMALL_TOL of its max|ref|."""
    from custom_diffusion360_torch.draws import Draws
    from custom_diffusion360_torch.engine import Engine, EngineConfig
    from custom_diffusion360_torch.models.unet import UNetConfig
    from custom_diffusion360_torch.models.vae import VAEConfig
    from custom_diffusion360_torch.train.capture import capture_references

    n, res = 3, 256
    lat = res // 8
    base = EngineConfig(unet=UNetConfig(**SMALL_UNET), vae=VAEConfig(**SMALL_VAE),
                        conditioner=small_conditioner())
    params = Engine(base, device="cpu").init_params(seed=30, dtype=torch.float32)
    params = perturb_zero_leaves(torch, params, seed=31)
    gen = torch.Generator().manual_seed(32)
    imgs = torch.rand((n, res, res, 3), generator=gen) * 2 - 1
    z = (1, n + 1, lat, lat, 4)
    given = {"vae_eps": torch.randn(z[1:], generator=gen),
             "sigma_ref_idx": torch.randint(0, 50, (1,), generator=gen),
             "noise_ref": torch.randn(z, generator=gen), "noise_ref2": torch.randn(z, generator=gen)}
    cond = make_cond(torch, base.unet, n + 2, "cpu", torch.float32, seed=33)
    cams = make_cameras(torch, n + 1, 1, "cpu", seed=34)
    outs = {}
    for device, dtype in (("cpu", torch.float32), ("cuda", torch.bfloat16)):
        cfg = EngineConfig(unet=UNetConfig(**SMALL_UNET, nerf_dtype=str(dtype)[6:]),
                           vae=VAEConfig(**SMALL_VAE), conditioner=base.conditioner,
                           compute_dtype=str(dtype)[6:])
        refs = capture_references(
            Engine(cfg, device=device), _map(params, lambda x: x.to(device, dtype)),
            imgs.to(device), cams.to(device), {k: v.to(device, dtype) for k, v in cond.items()},
            Draws(given={k: v.to(device) for k, v in given.items()}))
        outs[device] = {(a, d): buf.float().cpu() for a, per in refs.items()
                        for d, buf in per.items()}
    errs = []
    for key, ref in sorted(outs["cpu"].items()):
        got = outs["cuda"][key]
        err = float((got - ref).abs().max())
        tol = SMALL_TOL * float(ref.abs().max())
        errs.append(err <= tol and got.shape == ref.shape)
        log(f"[small-capture] block {key} {tuple(ref.shape)}: max-abs err cuda-bf16 vs cpu-f32 "
            f"{err:.4e} (tol {tol:.4e}) {'OK' if errs[-1] else 'FAIL'}")
    if not errs or not all(errs):
        raise RuntimeError("small-config capture on the card disagrees with the CPU")


def _small_engines(torch, unet, conditioner=None, seed=0):
    """(CPU f32 engine, card bf16 engine, f32 params made on the CPU with the
    zero leaves perturbed) for a small config: the kernels' plain versions
    on the CPU, the kernels on the card."""
    from custom_diffusion360_torch.engine import Engine, EngineConfig
    from custom_diffusion360_torch.models.unet import UNetConfig
    from custom_diffusion360_torch.models.vae import VAEConfig

    conditioner = conditioner or small_conditioner()
    engines = {}
    for device, dtype in (("cpu", "float32"), ("cuda", "bfloat16")):
        cfg = EngineConfig(unet=UNetConfig(**unet, nerf_dtype=dtype), vae=VAEConfig(**SMALL_VAE),
                           conditioner=conditioner, compute_dtype=dtype)
        engines[device] = Engine(cfg, device=device)
    params = engines["cpu"].init_params(seed=seed, dtype=torch.float32)
    return engines, perturb_zero_leaves(torch, params, seed=seed + 1)


def _compare(torch, tag, what, ref, got):
    """Log and return whether ``got`` (card) is within SMALL_TOL of
    max|ref| (CPU) of ``ref``."""
    ref, got = ref.float().cpu(), got.float().cpu()
    err = float((got - ref).abs().max())
    tol = SMALL_TOL * max(1.0, float(ref.abs().max()))
    ok = got.shape == ref.shape and err <= tol
    log(f"[{tag}] {what} {tuple(ref.shape)}: max-abs err cuda-bf16 vs cpu-f32 {err:.4e} (tol "
        f"{tol:.4e}, max|ref| {float(ref.abs().max()):.3f}) {'OK' if ok else 'FAIL'}")
    return ok


def run_small_sampler_check(torch):
    """Every sampler through a 3-step x3 Engine.sample on the small config
    (latent 32, 2 views, delta buffers, render cached), with the same
    per-step noise on both sides: bf16 kernels on the card vs f32 plain on
    the CPU; the latents must agree within SMALL_TOL of max|ref|."""
    from custom_diffusion360_torch.diffusion.guiders import scheduled_cfg_img_text_ref
    from custom_diffusion360_torch.diffusion.sampling import SAMPLERS
    from custom_diffusion360_torch.draws import Draws

    n_ref, latent, steps = 2, 32, 3
    engines, params = _small_engines(torch, SMALL_UNET, seed=80)
    unet = engines["cpu"].cfg.unet
    refs = make_references(torch, unet, n_ref, latent, "cpu", seed=81)
    cond = make_cond(torch, unet, 1, "cpu", torch.float32, seed=82)
    uc = make_cond(torch, unet, 1, "cpu", torch.float32, seed=83)
    gen = torch.Generator().manual_seed(84)
    noise = torch.randn((1, latent, latent, 4), generator=gen)
    step_noise = torch.randn((steps, 1, latent, latent, 4), generator=gen)
    guider = scheduled_cfg_img_text_ref(scale=7.5, scale_im=3.5)
    outs = {}
    for device, eng in engines.items():
        dtype = eng.cfg.dtype
        p = _map(params, lambda x: x.to(device, dtype))
        for name in SAMPLERS:
            outs[(device, name)] = eng.sample(
                p, {k: v.to(device, dtype) for k, v in cond.items()},
                {k: v.to(device, dtype) for k, v in uc.items()}, guider, noise=noise,
                cams=make_cameras(torch, n_ref, guider.num_copies, device),
                references=_map(refs, lambda x: x.to(device)), choices=list(range(n_ref)),
                num_steps=steps, sampler=name, shared_target_cams=True,
                draws=Draws(given={"step_noise": step_noise.to(device)}))
    ok = [_compare(torch, "small-samplers", f"{name} latent", outs[("cpu", name)],
                   outs[("cuda", name)]) for name in SAMPLERS]
    if not all(ok):
        raise RuntimeError("small-config samplers on the card disagree with the CPU")


def run_small_log_images_check(torch):
    """Engine.log_images (8 steps, x2 live-reference sample, the diagnostic
    forward) on the small training config, image 256^2, 1 + 2 views, the
    same draws on both sides: every image must agree within SMALL_TOL of
    its max|ref| (at least 1)."""
    from custom_diffusion360_torch.draws import Draws

    engines, params = _small_engines(torch, SMALL_TRAIN_UNET, seed=90)
    batch = make_train_batch(torch, engines["cpu"].cfg, 1, 2, 256, "cpu", seed=91,
                             ids=(1, 5, None, SMALL_CLIP["vocab_size"] - 1))
    gen = torch.Generator().manual_seed(92)
    lat = (1, 32, 32, 4)
    given = {"vae_eps": torch.randn(lat, generator=gen),
             "vae_eps_ref": torch.randn((2,) + lat[1:], generator=gen),
             "noise": torch.randn(lat, generator=gen), "diag_noise": torch.randn(lat, generator=gen)}
    outs = {}
    for device, eng in engines.items():
        dtype = eng.cfg.dtype
        outs[device] = eng.log_images(
            _map(params, lambda x: x.to(device, dtype) if x.is_floating_point() else x.to(device)),
            {k: v.to(device) for k, v in batch.items()},
            Draws(given={k: v.to(device) for k, v in given.items()}), num_steps=8)
    ok = sorted(outs["cpu"]) == sorted(outs["cuda"]) and len(outs["cpu"]) > 3
    ok = all([_compare(torch, "small-log-images", k, outs["cpu"][k], outs["cuda"][k])
              for k in sorted(outs["cpu"])]) and ok
    if not ok:
        raise RuntimeError("small-config log_images on the card disagrees with the CPU")


def run_small_multi_check(torch):
    """Engine.samplemulti on the small config: 2 views of a latent-32
    window, stride 24, 3 steps, x2, the same wide noise on both sides; the
    latents must agree within SMALL_TOL of max|ref|."""
    from custom_diffusion360_torch.diffusion.guiders import vanilla_cfg_img_ref

    n_ref, latent, stride, views = 2, 32, 24, 2
    engines, params = _small_engines(torch, SMALL_UNET, seed=100)
    unet = engines["cpu"].cfg.unet
    refs = make_references(torch, unet, n_ref, latent, "cpu", seed=101)
    conds = [make_cond(torch, unet, 1, "cpu", torch.float32, seed=102 + j) for j in range(views)]
    uc = make_cond(torch, unet, 1, "cpu", torch.float32, seed=104)
    noise = torch.randn((1, latent, stride * (views + 1), 4),
                        generator=torch.Generator().manual_seed(105))
    guider = vanilla_cfg_img_ref(scale=7.5)
    outs = {}
    for device, eng in engines.items():
        dtype = eng.cfg.dtype
        outs[device] = eng.samplemulti(
            _map(params, lambda x: x.to(device, dtype)),
            [{k: v.to(device, dtype) for k, v in c.items()} for c in conds],
            {k: v.to(device, dtype) for k, v in uc.items()}, guider, noise=noise,
            cams_list=[make_cameras(torch, n_ref, 2, device, seed=106 + j) for j in range(views)],
            references=_map(refs, lambda x: x.to(device)), choices=list(range(n_ref)),
            num_steps=3, window=latent, stride=stride)
    if not _compare(torch, "small-multi", "samplemulti latent", outs["cpu"], outs["cuda"]):
        raise RuntimeError("small-config samplemulti on the card disagrees with the CPU")


EVAL_SMALL_TOL = 1e-3  # of max|ref|: float32 on both sides, sums in other orders


def run_small_eval_check(torch):
    """The evaluation's towers at small sizes, float32, on the card through
    the kernels (cuDNN with TF32 off for Inception, the LayerNorm kernel for
    the CLIP towers) against the CPU through the plain versions, from the
    same weights made on the CPU: Inception's pool3 features of two 64 x 48
    images through the resize to 299^2 (its seeded kernels scaled by
    sqrt(2)), and a CLIP vision tower (28^2, patch
    14, width 160: two heads of 80, two layers) with a text tower (width 32,
    two layers, 77 tokens): the pooled image embedding, CLIP-T and CLIP-I.
    Each within EVAL_SMALL_TOL of max|ref|."""
    from custom_diffusion360_torch.eval.clip_score import clip_image_similarity, clip_score
    from custom_diffusion360_torch.eval.inception import (
        inception_pool3_features,
        init_inception_params,
    )
    from custom_diffusion360_torch.models.clip import (
        ClipTextConfig,
        ClipVisionConfig,
        clip_vision_apply,
        init_clip_text_params,
        init_clip_vision_params,
    )
    from custom_diffusion360_torch.models.embedders import clip_image_preprocess
    from custom_diffusion360_torch.ops.norms import layer_norm_fused

    gen = torch.Generator().manual_seed(40)
    imgs = torch.rand((2, 64, 48, 3), generator=gen)
    a, b = torch.rand((2, 3, 40, 40, 3), generator=gen) * 2.0 - 1.0
    tokens = torch.randint(1, 590, (3, 77), generator=gen)
    vcfg = ClipVisionConfig(image_size=28, patch_size=14, width=160, layers=2, heads=2,
                            embed_dim=32)
    tcfg = ClipTextConfig(vocab_size=600, width=32, layers=2, heads=4, context_length=77,
                          act="gelu", text_projection=True, num_modifier_tokens=0)
    inception = init_inception_params(0, "cpu")
    for bc in [v for v in inception.values() if "w" in v] + [
            c for v in inception.values() if "w" not in v for c in v.values()]:
        bc["w"] *= 2.0 ** 0.5  # He scaling: the activations keep their size through ReLUs
    params = {"inception": inception,
              "vision": init_clip_vision_params(vcfg, 1, "cpu"),
              "text": init_clip_text_params(tcfg, 2, "cpu")}
    outs = {}
    before = layer_norm_fused.launches
    for dev in ("cpu", "cuda"):
        p = _map(params, lambda x: x.to(dev))
        with torch.inference_mode():
            outs[dev] = {
                "inception pool3": inception_pool3_features(p["inception"], imgs.to(dev),
                                                            normalize_input=True),
                "vision pooled": clip_vision_apply(
                    p["vision"], clip_image_preprocess(a.to(dev), vcfg.image_size), vcfg),
                "CLIP-T": clip_score(p["vision"], p["text"], a.to(dev), tokens.to(dev), vcfg,
                                     tcfg),
                "CLIP-I": clip_image_similarity(p["vision"], a.to(dev), b.to(dev), vcfg),
            }
    ok = layer_norm_fused.launches > before
    for what, ref in outs["cpu"].items():
        got = outs["cuda"][what].float().cpu()
        err = float((got - ref).abs().max())
        tol = EVAL_SMALL_TOL * float(ref.abs().max())
        ok &= got.shape == ref.shape and err <= tol
        log(f"[small-eval] {what} {tuple(ref.shape)}: max-abs err cuda-f32 vs cpu-f32 "
            f"{err:.4e} (tol {tol:.4e}, max|ref| {float(ref.abs().max()):.4f}) "
            f"{'OK' if err <= tol else 'FAIL'}")
    log(f"[small-eval] LayerNorm kernel launches on the card: {layer_norm_fused.launches - before}")
    if not ok:
        raise RuntimeError("small evaluation towers on the card disagree with the CPU")


# the ae1 golden's configuration (tools/goldens_lib.py), LPIPS on
SMALL_AE_VAE = dict(ch=32, ch_mult=(1,), num_res_blocks=1, z_channels=4)


def run_small_ae_check(torch):
    """One AEEngine.train_step at the ae1 golden's configuration (VAE ch 32,
    mult (1,), 1 res block; PatchGAN ndf 8) with LPIPS on (full VGG16
    widths), 2 images of 32^2, and nerf_encoding_apply at the tiny UNet's
    pose-block shapes (dim 64, 8^2 token grid, 2 views, 4 samples, 2
    frequencies): bf16 images through the kernels on the card (GroupNorm;
    the bilinear kernel in f32 for the encoding) against f32 on the CPU
    through the plain versions, from the same weights and draws. Every log
    value within SMALL_TOL of max(1, |ref|); each side's gradients within
    SMALL_TOL of its largest reference gradient, or within twice the error
    of the plain versions' own bf16 run on the CPU where that is larger
    (the PatchGAN's gradients in bf16 are 13 % off f32 on the CPU alone: it
    has no kernel, and its BatchNorm takes statistics over 2 x 3 x 3
    positions); the encoding within SMALL_TOL of max|ref|."""
    from custom_diffusion360_torch.draws import Draws
    from custom_diffusion360_torch.geometry.rays import get_patch_rays, ray_points_from_rays
    from custom_diffusion360_torch.models.nerf import (
        NerfConfig,
        init_nerf_params,
        nerf_encoding_apply,
    )
    from custom_diffusion360_torch.models.nn import Init
    from custom_diffusion360_torch.models.vae import VAEConfig
    from custom_diffusion360_torch.ops.norms import group_norm_fused
    from custom_diffusion360_torch.ops.onehot_sample import bilinear_sample
    from custom_diffusion360_torch.train.ae_engine import AEEngine, AEEngineConfig, init_ae_engine
    from custom_diffusion360_torch.train.trainer import tree_leaves

    cfg = AEEngineConfig(vae=VAEConfig(**SMALL_AE_VAE), disc_ndf=8, lr=1e-3)
    params = perturb_zero_leaves(torch, init_ae_engine(cfg, seed=50, device="cpu"), seed=51)
    gen = torch.Generator().manual_seed(52)
    x = torch.rand((2, 32, 32, 3), generator=gen) * 2.0 - 1.0
    eps = torch.randn((2, 32, 32, 4), generator=gen)
    outs = {}
    gn_before = group_norm_fused.launches
    for dev, dtype in (("cpu", torch.float32), ("cpu", torch.bfloat16),
                       ("cuda", torch.bfloat16)):
        eng = AEEngine(cfg, device=dev)
        state = eng.init_state(_map(params, lambda t: t.to(dev)))
        state, logs = eng.train_step(state, x.to(dev, dtype), Draws(given={"vae_eps": eps}))
        grads = {side: [opt.state[leaf]["exp_avg"].float().cpu() / 0.1
                        for leaf in tree_leaves(state.params[side])]
                 for side, opt in (("ae", state.opt_ae), ("disc", state.opt_disc))}
        outs[dev, dtype] = ({k: float(v) for k, v in logs.items()}, grads)
    ok = group_norm_fused.launches > gn_before
    (l_ref, g_ref), (_, g_plain) = outs["cpu", torch.float32], outs["cpu", torch.bfloat16]
    l_got, g_got = outs["cuda", torch.bfloat16]
    for k in sorted(l_ref):
        err, tol = abs(l_got[k] - l_ref[k]), SMALL_TOL * max(1.0, abs(l_ref[k]))
        ok &= err <= tol
        log(f"[small-ae] {k}: cuda-bf16 {l_got[k]:.6g} vs cpu-f32 {l_ref[k]:.6g} (err "
            f"{err:.3e}, tol {tol:.3e}) {'OK' if err <= tol else 'FAIL'}")
    for side in ("ae", "disc"):
        scale = max(float(g.abs().max()) for g in g_ref[side])
        err = max(float((a - b).abs().max()) for a, b in zip(g_got[side], g_ref[side]))
        plain = max(float((a - b).abs().max()) for a, b in zip(g_plain[side], g_ref[side]))
        tol = max(SMALL_TOL * scale, 2.0 * plain)
        ok &= scale > 0 and err <= tol
        log(f"[small-ae] {side} gradients ({len(g_ref[side])} leaves): max-abs err cuda-bf16 vs "
            f"cpu-f32 {err:.3e}, cpu-bf16 vs cpu-f32 {plain:.3e} (tol {tol:.3e}: {SMALL_TOL} x "
            f"max|ref| {scale:.3e} or twice the CPU's bf16 error) "
            f"{'OK' if err <= tol else 'FAIL'}")

    ncfg = NerfConfig(dim=64, num_samples=4, num_freqs=2, chunk_size=0)
    nparams = perturb_zero_leaves(torch, init_nerf_params(Init(53, "cpu"), ncfg), seed=54)
    cams = make_cameras(torch, 2, 1, "cpu")
    rays, _ = get_patch_rays(cams, 8)
    lengths = torch.linspace(0.5, 3.5, 4).expand(1, 64, 4)
    pts = ray_points_from_rays(rays[:, 0], lengths)
    xref = torch.randn((1, 2, 64, 64), generator=gen)
    bl_before = bilinear_sample.launches
    enc = {dev: nerf_encoding_apply(_map(nparams, lambda t: t.to(dev)), cams.to(dev),
                                    xref.to(dev), pts.to(dev), rays.to(dev), None, ncfg)
           for dev in ("cpu", "cuda")}
    ok &= bilinear_sample.launches > bl_before
    ok &= _compare(torch, "small-ae", "nerf_encoding_apply out", enc["cpu"][0], enc["cuda"][0])
    ok &= _compare(torch, "small-ae", "nerf_encoding_apply attn", enc["cpu"][1], enc["cuda"][1])
    log(f"[small-ae] kernel launches on the card: group_norm "
        f"{group_norm_fused.launches - gn_before}, bilinear {bilinear_sample.launches - bl_before}")
    if not ok:
        raise RuntimeError("small autoencoder step or NeRF encoding on the card disagrees with "
                           "the CPU")


# the CPU tests' tiny sizes (tests/test_torch_{t5,embedders,general_conditioner,
# encoder_unet,extra_blocks}.py); the single-layer block at 2 heads of 64
# over 256 tokens, so its self-attention takes the attention kernel
SMALL_AUX_T5 = dict(vocab_size=99, d_model=32, d_kv=8, d_ff=64, num_layers=3, num_heads=4)
SMALL_AUX_TEXT = dict(vocab_size=64, width=32, layers=3, heads=4, context_length=16,
                      text_projection=True)
SMALL_AUX_VISION = dict(image_size=16, patch_size=8, width=32, layers=2, heads=4, embed_dim=12,
                        act="quick_gelu")
SMALL_AUX_VAE = dict(ch=16, ch_mult=(1, 2), num_res_blocks=1)
SMALL_AUX_COND = (dict(vocab_size=64, width=32, layers=2, heads=4, context_length=8),
                  dict(vocab_size=64, width=48, layers=2, heads=4, context_length=8, act="gelu",
                       text_projection=True))
SMALL_AUX_UNET = dict(image_size=8, in_channels=3, model_channels=32, out_channels=5,
                      num_res_blocks=1, attention_resolutions=(2,), channel_mult=(1, 2),
                      num_heads=2, num_head_channels=16)
SMALL_AUX_DDPM = dict(ch=32, out_ch=3, ch_mult=(1, 2), num_res_blocks=1, attn_resolutions=(8,),
                      in_channels=3, resolution=16)


def run_small_aux_check(torch, dev="cuda"):
    """The five auxiliary modules at the CPU tests' tiny sizes, from weights
    and inputs made on the CPU, run on the card in bf16 (weights and
    activations; the kernels) and on the CPU in f32 (plain versions), the
    same draws given to both: T5 (gated, 77 tokens), the class embedder,
    open_clip_embedder2, open_clip_image_embedder (UCG 0.5), the spatial
    rescaler with its mapper, low_scale_encode / low_scale_decode and
    gaussian_encoder on a tiny VAE, the general conditioner on a tiny SDXL
    stack (target + reference rows), the EncoderUNet with each pool, the
    DDPM model with each attention, the single-layer block (self and
    context), SpatialSelfAttention, linear attention and the transposed
    upsample. Each output within SMALL_TOL of max(1, max|ref|); the GroupNorm,
    LayerNorm and attention kernels must have launched. The T5 position
    bias made on the card (the host-built bucket table moved there) must
    equal the CPU's bit for bit, at 77 and 512 tokens; the bucket formula
    evaluated on the card itself is logged beside it."""
    from custom_diffusion360_torch.draws import Draws
    from custom_diffusion360_torch.models import clip, conditioner, embedders, encoder_unet, t5
    from custom_diffusion360_torch.models import extra_blocks as eb
    from custom_diffusion360_torch.models import general_conditioner as gc
    from custom_diffusion360_torch.models.nn import Init
    from custom_diffusion360_torch.models.vae import VAEConfig, init_vae_params
    from custom_diffusion360_torch.ops.block_attention import attention_fwd
    from custom_diffusion360_torch.ops.norms import group_norm_fused, layer_norm_fused

    counters = (group_norm_fused, layer_norm_fused, attention_fwd)
    before = [c.launches for c in counters]
    ok = True

    # T5's buckets: the bias the card uses, and the formula evaluated there
    t5_cfg = t5.T5Config(**SMALL_AUX_T5)
    rel_bias = {"rel_bias": torch.randn((32, 4), generator=torch.Generator().manual_seed(90))}
    for seq_len in (77, 512):
        host = t5.position_bias(rel_bias, seq_len, t5_cfg, "cpu")
        card = t5.position_bias({"rel_bias": rel_bias["rel_bias"].to(dev)}, seq_len, t5_cfg, dev)
        same = torch.equal(card.cpu(), host)
        pos = torch.arange(seq_len, device=dev)
        on_card = t5.relative_position_bucket(pos[None, :] - pos[:, None], 32, 128).cpu()
        differ = int((on_card != t5.relative_position_buckets(seq_len, 32, 128)).sum())
        ok &= same
        verdict = "equals" if same else "DIFFERS from"
        log(f"[small-aux] T5 position bias at L = {seq_len}: the card's {verdict} the CPU's bit "
            f"for bit; the bucket formula evaluated on the card differs from the host table at "
            f"{differ} of {seq_len * seq_len} entries")

    init = Init(91, "cpu")
    tcfg = clip.ClipTextConfig(**SMALL_AUX_TEXT)
    vcfg = clip.ClipVisionConfig(**SMALL_AUX_VISION)
    vae_cfg = VAEConfig(**SMALL_AUX_VAE)
    ccfg = conditioner.ConditionerConfig(clip_l=clip.ClipTextConfig(**SMALL_AUX_COND[0]),
                                         open_clip=clip.ClipTextConfig(**SMALL_AUX_COND[1]),
                                         size_outdim=16)
    ucfgs = {pool: encoder_unet.EncoderUNetConfig(**SMALL_AUX_UNET, pool=pool,
                                                  use_new_attention_order=pool == "attention")
             for pool in ("adaptive", "attention", "spatial", "spatial_v2")}
    dcfgs = {a: eb.DDPMModelConfig(**SMALL_AUX_DDPM, attn_type=a)
             for a in ("vanilla", "linear", "none")}
    params = {
        "t5": t5.init_t5_params(t5_cfg, seed=92, device="cpu"),
        "cls": embedders.class_embedder_init(init, 8, 10),
        "text": clip.init_clip_text_params(tcfg, seed=93, device="cpu"),
        "vision": clip.init_clip_vision_params(vcfg, seed=94, device="cpu"),
        "mapper": embedders.spatial_rescaler_init(init, 5, 8, kernel_size=3, bias=True),
        "vae": init_vae_params(vae_cfg, seed=95, device="cpu"),
        "cond": conditioner.init_conditioner_params(ccfg, seed=96, device="cpu"),
        "unet": {pool: encoder_unet.init_encoder_unet_params(c, seed=97, device="cpu")
                 for pool, c in ucfgs.items()},
        "ddpm": {a: eb.init_ddpm_model_params(c, seed=98, device="cpu")
                 for a, c in dcfgs.items()},
        "slb": eb.init_single_layer_block(init, 128, 2, 64),
        "slb_ctx": eb.init_single_layer_block(init, 128, 2, 64, context_dim=48),
        "ssa": eb.init_spatial_self_attention(init, 64),
        "lin": eb.init_linear_attention(init, 32, heads=4, dim_head=8),
        "up": eb.init_transposed_upsample(init, 16, 24),
    }
    params = perturb_zero_leaves(torch, params, seed=99, std=0.1)
    gen = torch.Generator().manual_seed(100)

    def rnd(*shape):
        return torch.randn(shape, generator=gen)

    ints = lambda hi, *shape: torch.randint(0, hi, shape, generator=gen)  # noqa: E731
    inputs = {
        "t5_tokens": ints(99, 2, 77), "cls": ints(10, 3), "text_tokens": ints(60, 2, 16),
        "images": torch.rand((3, 20, 20, 3), generator=gen) * 2 - 1,
        "ucg": torch.tensor([0.2, 0.7, 0.4]), "feat": rnd(2, 8, 8, 5),
        "vae_x": torch.rand((2, 16, 16, 3), generator=gen) * 2 - 1,
        "vae_eps": rnd(2, 8, 8, 4), "noise_level": torch.tensor([3, 41]),
        "noise": rnd(2, 8, 8, 4), "unet_x": rnd(2, 8, 8, 3), "ddpm_x": rnd(2, 16, 16, 3),
        "steps": torch.tensor([3.0, 500.0]), "slb_x": rnd(2, 256, 128), "slb_ctx": rnd(2, 7, 48),
        "ssa_x": rnd(2, 8, 8, 64), "lin_x": rnd(2, 8, 8, 32), "up_x": rnd(2, 5, 7, 16),
    }
    batch = {}
    for suffix, rows in (("", 2), ("_ref", 6)):
        for key in ("tokens_clip", "tokens_open"):
            batch[key + suffix] = ints(60, rows, 8)
        for key in ("original_size", "crop_coords", "target_size"):
            batch[key + suffix] = torch.rand((rows, 2), generator=gen) * 768 + 256
    lcfg = embedders.LowScaleConfig(output_size=12, max_noise_level=50)

    def outputs(device, dtype):
        p = _map(params, lambda x: x.to(device, dtype))
        x = {k: (v.to(device, dtype) if v.is_floating_point() and k not in (
            "ucg", "steps", "vae_eps", "noise") else v.to(device)) for k, v in inputs.items()}
        b = {k: v.to(device) for k, v in batch.items()}
        out = {"t5": t5.t5_encode(p["t5"], x["t5_tokens"], t5_cfg),
               "class_embedder": embedders.class_embedder_apply(p["cls"], x["cls"])}
        z, pooled = embedders.open_clip_embedder2(p["text"], x["text_tokens"], tcfg,
                                                  layer="penultimate", legacy=False,
                                                  return_pooled=True)
        out.update({"open_clip_embedder2": z, "open_clip_embedder2 pooled": pooled})
        out["open_clip_image_embedder"] = embedders.open_clip_image_embedder(
            p["vision"], x["images"], vcfg, draws=Draws(given={"ucg": x["ucg"]}), ucg_rate=0.5)
        out["spatial_rescaler"] = embedders.spatial_rescaler(x["feat"], method="bilinear",
                                                             params=p["mapper"])
        draws = Draws(given={k: x[k] for k in ("vae_eps", "noise_level", "noise")})
        z, _ = embedders.low_scale_encode(p["vae"], x["vae_x"], draws, lcfg, vae_cfg)
        out["low_scale_encode"] = z
        out["low_scale_decode"] = embedders.low_scale_decode(p["vae"], z.to(dtype), lcfg, vae_cfg)
        out["gaussian_encoder"] = embedders.gaussian_encoder(p["vae"], x["vae_x"], draws,
                                                             vae_cfg=vae_cfg)[1]
        cond = gc.general_conditioner_apply(p["cond"], sdxl_embedder_specs(ccfg), b)
        out.update({f"general_conditioner {k}": v for k, v in cond.items()})
        for pool, c in ucfgs.items():
            out[f"encoder_unet {pool}"] = encoder_unet.encoder_unet_apply(
                p["unet"][pool], x["unet_x"], x["steps"], c)
        for a, c in dcfgs.items():
            out[f"ddpm {a}"] = eb.ddpm_model_apply(p["ddpm"][a], x["ddpm_x"], x["steps"], cfg=c)
        out["single_layer_block self"] = eb.single_layer_block_apply(p["slb"], x["slb_x"],
                                                                     n_heads=2)
        out["single_layer_block context"] = eb.single_layer_block_apply(
            p["slb_ctx"], x["slb_x"], x["slb_ctx"], n_heads=2)
        out["spatial_self_attention"] = eb.spatial_self_attention_apply(p["ssa"], x["ssa_x"])
        out["linear_attention"] = eb.linear_attention_apply(p["lin"], x["lin_x"], heads=4)
        out["transposed_upsample"] = eb.transposed_upsample_apply(p["up"], x["up_x"])
        return out

    with torch.inference_mode():
        ref = outputs("cpu", torch.float32)
        got = outputs(dev, torch.bfloat16)
    for name in ref:
        ok &= _compare(torch, "small-aux", name, ref[name], got[name])
    launched = {c.__name__: c.launches - n for c, n in zip(counters, before)}
    log(f"[small-aux] kernel launches on the card: {json.dumps(launched)}")
    ok &= all(launched.values())
    if not ok:
        raise RuntimeError("small auxiliary models on the card disagree with the CPU, or a "
                           "kernel did not launch")


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
    from custom_diffusion360_torch.ops.block_attention import attention_bnhd_fwd, attention_fwd
    from custom_diffusion360_torch.ops.conv3x3 import conv3x3_fwd
    from custom_diffusion360_torch.ops.norms import group_norm_fused, layer_norm_fused
    from custom_diffusion360_torch.ops.onehot_sample import bilinear_sample, bilinear_sample_bwd

    t_start = time.time()
    log(gpu_line())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    DT.update({"bf16": torch.bfloat16, "f32": torch.float32})
    log(f"[setup] torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()} "
        f"matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}")

    t0 = time.time()
    times = _build.build()
    log(f"[build] {json.dumps({k: round(v, 2) for k, v in times.items()})} "
        f"wall {time.time() - t0:.1f} s")
    for name in _build.KERNELS:
        for line in _build.build_log(name).splitlines():
            if ("registers" in line or "spill" in line or "error" in line
                    or (name in WGMMA_KERNELS and ("ptxas" in line or "arning" in line))):
                log(f"[build] {name}: {line.strip()}")
    for name in WGMMA_KERNELS:
        counts = sass_counts(name, SM90_OPCODES)
        log(f"[build] {name} SASS (cuobjdump -sass): "
            + ", ".join(f"{op} {n}" for op, n in counts.items()))
        if not counts["HGMMA"] or not counts["UTMALDG"]:
            print(f"chip_smoke: {name} has no wgmma (HGMMA) or no TMA load (UTMALDG) in its "
                  "SASS", file=sys.stderr)
            return 1
        spills = [line.strip() for line in _build.build_log(name).splitlines()
                  if re.search(r"[1-9]\d* bytes spill (stores|loads)", line)]
        if spills:
            print(f"chip_smoke: {name} spills registers: {spills}", file=sys.stderr)
            return 1

    counts = sass_counts("bilinear_sample_bwd", ATOMIC_OPCODES)
    log("[build] bilinear_sample_bwd SASS (cuobjdump -sass): "
        + ", ".join(f"{op} {n}" for op, n in counts.items()))
    if counts["RED"] or counts["ATOMG"] or not counts["UTMALDG"]:
        print("chip_smoke: bilinear_sample_bwd has a global atomic or reduction (RED, ATOMG) "
              "or no TMA load (UTMALDG) in its SASS", file=sys.stderr)
        return 1

    results = []
    check_attention(torch, results)
    check_bilinear(torch, results)
    failed = [r["name"] for r in results if not r["ok"]]
    if failed:
        print(f"chip_smoke: kernels disagree with their plain versions: {failed}",
              file=sys.stderr)
        return 1

    counters = {"attention": attention_fwd, "bilinear": bilinear_sample,
                "bilinear_bwd": bilinear_sample_bwd, "layer_norm": layer_norm_fused,
                "group_norm": group_norm_fused, "conv3x3": conv3x3_fwd,
                "bnhd": attention_bnhd_fwd}
    launches, by_shape, main_decode_ms = run_main_path(torch, counters)
    paths = {"sample": (launches, by_shape)}
    launches, by_shape, grad_shapes = run_train_path(torch, counters)
    paths["train"] = (launches, by_shape)
    paths["cli"] = run_cli_path(torch, counters, main_decode_ms)
    paths["samplers"] = run_samplers_path(torch, counters)
    paths["train_cli"] = run_train_cli_path(torch, counters)
    paths["parallel"] = run_parallel_path(torch, counters)
    paths["evaluate"] = run_evaluate_path(torch, counters)
    paths["ae_train"] = run_ae_train_path(torch, counters)
    paths["aux"] = run_aux_path(torch, counters)
    check_launched(torch, results, {key for _, shapes in paths.values() for key in shapes})
    time_attention_backward(torch, grad_shapes)
    run_small_check(torch)
    run_small_cli_check(torch)
    run_small_train_check(torch)
    run_small_capture_check(torch)
    run_small_sampler_check(torch)
    run_small_log_images_check(torch)
    run_small_multi_check(torch)
    run_small_eval_check(torch)
    run_small_ae_check(torch)
    run_small_aux_check(torch)

    failed = [r["name"] for r in results if not r["ok"]]
    if failed:
        print(f"chip_smoke: kernels disagree with their plain versions: {failed}",
              file=sys.stderr)
        return 1
    # the sampling paths are inference: no backward kernel; conv3x3 and the
    # bnhd route run only under the CLI phase's switches
    switched = {"conv3x3", "bnhd"}
    expected = {"sample": set(counters) - {"bilinear_bwd"} - switched,
                "train": set(counters) - switched, "cli": set(counters) - {"bilinear_bwd"},
                "samplers": set(counters) - {"bilinear_bwd"},
                "train_cli": set(counters) - switched, "parallel": set(counters),
                "evaluate": {"layer_norm"}, "ae_train": {"group_norm", "attention", "conv3x3"},
                "aux": {"group_norm", "layer_norm", "attention", "conv3x3"}}
    for path, (launches, _) in paths.items():
        missing = sorted(k for k in expected[path] if launches[k] == 0)
        if missing:
            print(f"chip_smoke: the {path} path never launched {missing}", file=sys.stderr)
            return 1
    for r in results:
        key = r.pop("_key")
        per_path = {path: shapes.get(key, 0) for path, (_, shapes) in paths.items()}
        r["launches"] = sum(per_path.values())
        r["launches_by_path"] = per_path
        r.pop("ok")
    print(json.dumps({"kernel_sums": kernel_sums(results)}), flush=True)
    # shapes no main path launches (512^2 sampling, kv_len masking, the
    # unpadded scalar path) are checked and timed all the same
    print(json.dumps({"off_path_kernel_checks": [r for r in results if not r["launches"]]}),
          flush=True)
    print(json.dumps({"kernels": [r for r in results if r["launches"]]}), flush=True)
    log(f"[done] wall {time.time() - t_start:.1f} s")
    log(gpu_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
