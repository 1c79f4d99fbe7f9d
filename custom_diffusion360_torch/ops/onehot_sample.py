"""Bilinear sampling of reference feature maps, the FeatureNeRF inner loop
(port of custom_diffusion360_tpu/ops/onehot_sample.py).

The TPU package wrote this as a one-hot matmul (``bilinear_sample_matmul``)
and as a Pallas kernel (``bilinear_sample_pallas``, whose VJP is W^T g). On
Hopper the natural form is a 4-corner gather, ``csrc/bilinear_sample.cu``,
and its transpose, a 4-corner scatter-add into accumulators that each block
owns in shared memory, ``csrc/bilinear_sample_bwd.cu`` (no atomics: the
result is the same bit for bit from run to run).
``bilinear_sample`` is an autograd Function over the two: the gradient
with respect to the maps is W^T g, the grid's is zero (the FeatureNeRF
caller stops it, as the reference detaches the projected points). Plain
versions: ops/grid_sample.grid_sample_2d and its autograd.

Both CUDA calls take an ``out=`` buffer to write into, and hand the call to
``capture_split`` while one is set: the piecewise CUDA-graph capture of the
training step (``train/train_graphs.py``) ends a graph there, so that every
bilinear launch stays eager, inside its span and counted, between the
replayed segments.
"""
from __future__ import annotations

from collections import Counter

import torch

from ..utils.trace import span
from . import _build
from .grid_sample import grid_sample_2d

_DTYPES = {torch.bfloat16: 0, torch.float32: 1}
_DTYPE_NAMES = {torch.bfloat16: "bf16", torch.float32: "f32"}


def _check(feats_shape, grid, device):
    m = feats_shape[0]
    if grid.dim() != 3 or grid.shape[0] != m or grid.shape[-1] != 2:
        raise ValueError(f"grid {tuple(grid.shape)} does not match maps {tuple(feats_shape)}")
    if grid.device != device:
        raise ValueError("bilinear kernel needs grid and maps on one device")


def _vec(c, t):
    return int((c * t.element_size()) % 16 == 0 and t.data_ptr() % 16 == 0)


def _sample_forward(feats, grid, out=None):
    """The forward launch: CUDA tensors launch the kernel inside the span
    ``cd360.op.bilinear`` (into ``out`` when given), CPU tensors run
    ``grid_sample_2d``. While ``capture_split`` is set, a CUDA call goes to
    it instead."""
    if feats.device.type == "cpu":
        return grid_sample_2d(feats, grid)
    if capture_split is not None:
        return capture_split(_sample_forward, feats, grid)
    m, h, w, c = feats.shape
    _check(feats.shape, grid, feats.device)
    if feats.dtype not in _DTYPES:
        raise TypeError(f"bilinear kernel takes bf16 or f32 maps, got {feats.dtype}")
    if not feats.is_contiguous():
        raise ValueError("bilinear kernel needs contiguous maps")
    with span("cd360.op.bilinear"):
        grid = grid.to(torch.float32).contiguous()
        p = grid.shape[1]
        if out is None:
            out = torch.empty((m, p, c), dtype=feats.dtype, device=feats.device)
        fn = _build.load("bilinear_sample")
        with torch.cuda.device(feats.device):
            stream = torch.cuda.current_stream(feats.device).cuda_stream
            rc = fn(feats.data_ptr(), grid.data_ptr(), out.data_ptr(), m, h, w, c,
                    p, _DTYPES[feats.dtype], _vec(c, feats), stream)
    _build.check(rc, "bilinear_sample")
    bilinear_sample.launches_by_shape[(m, h, w, c, p, _DTYPE_NAMES[feats.dtype])] += 1
    return out


def bilinear_sample_bwd_plain(g, grid, feats_shape, dtype):
    """W^T g through the autograd of ``grid_sample_2d`` (linear in the maps,
    so zero maps serve as the point of linearisation)."""
    with torch.enable_grad():
        f = torch.zeros(feats_shape, dtype=dtype, device=g.device, requires_grad=True)
        (d,) = torch.autograd.grad(grid_sample_2d(f, grid.detach()), f, g)
    return d


# csrc/bilinear_sample_bwd.cu's decomposition: 32-channel slices, bands of at
# most 1024 pixels (a 128 KB f32 accumulator in shared memory), points in
# tiles of 128, a ring of 4 tiles
BWD_CS, BWD_TP, BWD_STAGES, BWD_MAX_PIX = 32, 128, 4, 1024
BWD_MAX_SPLITS = 4
_SM_SHARED = 233472  # shared memory an H100 SM gives its blocks, bytes
_BLOCK_RESERVED = 1024  # shared memory the card keeps per resident block


def bwd_smem_bytes(band_pix: int, itemsize: int) -> int:
    """Dynamic shared memory of one block of the kernel (its ``Layout``):
    barriers, the rings of g tiles and of corners, the band's f32
    accumulator."""
    return 128 + BWD_STAGES * BWD_TP * (BWD_CS * itemsize + 32) + band_pix * BWD_CS * 4


def bwd_plan(m: int, h: int, w: int, c: int, p: int, itemsize: int, num_sms: int):
    """(pixels per band, point splits) of the backward kernel for maps (m, h,
    w, c), p points and a cotangent of ``itemsize`` bytes on ``num_sms`` SMs.
    Bands: as few as keep each under 1024 pixels, of equal size. Splits:
    1 when the blocks fill the slots, the blocks the card holds at once (two
    a SM at most, as the kernel's launch bounds promise, fewer when shared
    memory runs out); under that, the s in [1, BWD_MAX_SPLITS] (and at most
    the point tiles) that gives the fewest waves per split, ceil(blocks * s
    / slots) / s, the smallest s on a tie. At the training shapes: 16^2
    C1288 P6144 (164 blocks of 112 KB, two a SM) and 32^2 C648 P12288 (84
    blocks of 208 KB, one a SM) both take 3; a 64^2 C648 map (4 bands, 336
    blocks) takes 1."""
    bands = max(1, -(-(h * w) // BWD_MAX_PIX))
    band_pix = max(1, -(-(h * w) // bands))
    blocks = m * bands * -(-c // BWD_CS)
    per_sm = min(2, _SM_SHARED // (bwd_smem_bytes(band_pix, itemsize) + _BLOCK_RESERVED))
    slots = max(1, num_sms * per_sm)
    tiles = -(-p // BWD_TP)
    best = 1
    for s in range(2, min(BWD_MAX_SPLITS, tiles) + 1 if blocks < slots else 1):
        if -(-blocks * s // slots) * best < -(-blocks * best // slots) * s:
            best = s
    return band_pix, best


def bilinear_sample_bwd_split_plain(g, grid, feats_shape, band_pix: int, splits: int):
    """W^T g in f32 as the backward kernel decomposes it: points in splits of
    ceil(ceil(P / 128) / splits) tiles of 128; within a split, for each
    32-channel slice and each band of ``band_pix`` pixels, every corner that
    lands in the band added to its pixel in point order (corners outside the
    map get nothing); the splits' partials then summed in split order. For
    tests: no path calls it. g (M, P, C), grid (M, P, 2) -> (M, H, W, C)."""
    m, h, w, c = feats_shape
    p = grid.shape[1]
    gf, q = g.float(), grid.float()
    ix = (q[..., 0] + 1.0) * 0.5 * (w - 1)
    iy = (q[..., 1] + 1.0) * 0.5 * (h - 1)
    fx, fy = torch.floor(ix), torch.floor(iy)
    tx, ty = ix - fx, iy - fy
    x0, y0 = fx.clamp(-2, w).long(), fy.clamp(-2, h).long()
    # (M, P, 4) corners in the kernel's order, point-major
    xs = torch.stack([x0, x0 + 1, x0, x0 + 1], -1)
    ys = torch.stack([y0, y0, y0 + 1, y0 + 1], -1)
    wts = torch.stack([(1 - tx) * (1 - ty), tx * (1 - ty), (1 - tx) * ty, tx * ty], -1)
    pix = torch.where((xs >= 0) & (xs < w) & (ys >= 0) & (ys < h), ys * w + xs, -1)
    chunk = BWD_TP * -(-(-(-p // BWD_TP)) // splits)
    parts = []
    for s in range(splits):
        run = slice(s * chunk, min(p, (s + 1) * chunk))
        part = torch.empty((m, h * w, c), dtype=torch.float32, device=g.device)
        for mi in range(m):
            k, wt, rows = pix[mi, run].reshape(-1), wts[mi, run].reshape(-1), gf[mi, run]
            for q0 in range(0, h * w, band_pix):
                n = min(band_pix, h * w - q0)
                mine = (k >= q0) & (k < q0 + n)  # corners this band owns, in point order
                for c0 in range(0, c, BWD_CS):
                    src = wt[:, None] * rows[:, c0:c0 + BWD_CS].repeat_interleave(4, 0)
                    acc = torch.zeros((n, src.shape[1]), dtype=torch.float32, device=g.device)
                    acc.index_add_(0, k[mine] - q0, src[mine])
                    part[mi, q0:q0 + n, c0:c0 + BWD_CS] = acc
        parts.append(part)
    out = parts[0]
    for part in parts[1:]:
        out = out + part
    return out.reshape(m, h, w, c)


def bilinear_sample_bwd(g, grid, feats_shape, dtype, out=None):
    """dFeats = W^T g for the cotangent g (M, P, C) of ``bilinear_sample`` at
    ``grid`` (M, P, 2) -> (M, H, W, C) in ``dtype`` (written into ``out``
    when given; while ``capture_split`` is set, a CUDA call goes to it
    instead). CUDA tensors launch
    ``csrc/bilinear_sample_bwd.cu``: each block owns its part of the output
    in shared memory, no atomics, the same bits from run to run; the kernel
    writes ``dtype`` itself (no zero fill, no cast), and when ``bwd_plan``
    splits the points, an f32 workspace and a merge launch sum the splits in
    order; all inside the span ``cd360.op.bilinear_bwd`` (on autograd's
    device thread when autograd calls it). CPU tensors run
    ``bilinear_sample_bwd_plain``. Launches are counted by shape (M, H, W,
    C, P, dtype) in ``bilinear_sample_bwd.launches_by_shape``; the last plan
    at each shape is in ``bwd_plans_launched``."""
    if g.device.type == "cpu":
        return bilinear_sample_bwd_plain(g, grid, feats_shape, dtype)
    if capture_split is not None:
        return capture_split(bilinear_sample_bwd, g, grid, feats_shape, dtype)
    m, h, w, c = feats_shape
    _check(feats_shape, grid, g.device)
    if g.dtype not in _DTYPES or dtype not in _DTYPES:
        raise TypeError(f"bilinear backward kernel takes bf16 or f32, got {g.dtype} -> {dtype}")
    if tuple(g.shape) != (m, grid.shape[1], c):
        raise ValueError(f"cotangent {tuple(g.shape)} does not match maps {tuple(feats_shape)}")
    with span("cd360.op.bilinear_bwd"):
        g = g.contiguous()
        grid = grid.to(torch.float32).contiguous()
        if grid.data_ptr() % 8:  # the kernel reads (x, y) pairs as float2
            grid = grid.clone()
        p = grid.shape[1]
        band_pix, splits = bwd_plan(m, h, w, c, p, g.element_size(),
                                    _build.num_sms(g.get_device()))
        out = bwd_launch(g, grid, feats_shape, dtype, band_pix, splits, out)
    bilinear_sample_bwd.launches_by_shape[(m, h, w, c, p, _DTYPE_NAMES[g.dtype])] += 1
    bwd_plans_launched[(m, h, w, c, p, _DTYPE_NAMES[g.dtype])] = (band_pix, splits)
    return out


# (pixels per band, point splits) of the last backward launch at each shape
bwd_plans_launched = {}

# while a piecewise CUDA-graph capture of the training step runs
# (train/train_graphs.py): called as capture_split(wrapper, *args) in place
# of a CUDA call of ``_sample_forward`` or ``bilinear_sample_bwd``
capture_split = None


def bwd_launch(g, grid, feats_shape, dtype, band_pix: int, splits: int, out=None):
    """Launch ``csrc/bilinear_sample_bwd.cu`` with the given bands and
    splits on contiguous CUDA g and f32 grid (``bilinear_sample_bwd``
    checks and plans; a timing script may pick its own plan), into ``out``
    when given. Counts nothing."""
    m, h, w, c = feats_shape
    index = g.get_device()
    if out is None:
        out = torch.empty((m, h, w, c), dtype=dtype, device=g.device)
    ws = None
    if splits > 1:
        ws = torch.empty((splits, m, h, w, c), dtype=torch.float32, device=g.device)
    fn = _build.load("bilinear_sample_bwd")
    with _build.on_device(index):
        rc = fn(g.data_ptr(), grid.data_ptr(), out.data_ptr(),
                None if ws is None else ws.data_ptr(), m, h, w, c, grid.shape[1],
                _DTYPES[g.dtype], _DTYPES[dtype], _vec(c, g), band_pix, splits,
                _build.current_stream(index))
    _build.check(rc, "bilinear_sample_bwd")
    return out


class _BilinearSample(torch.autograd.Function):
    @staticmethod
    def forward(ctx, feats, grid):
        ctx.save_for_backward(grid)
        ctx.feats = (tuple(feats.shape), feats.dtype)
        return _sample_forward(feats, grid)

    @staticmethod
    def backward(ctx, g):
        (grid,) = ctx.saved_tensors
        d_feats = None
        if ctx.needs_input_grad[0]:
            d_feats = bilinear_sample_bwd(g, grid, *ctx.feats)
        d_grid = torch.zeros_like(grid) if ctx.needs_input_grad[1] else None
        return d_feats, d_grid


def bilinear_sample(feats, grid):
    """feats: (M, H, W, C) contiguous bf16 or f32; grid: (M, P, 2) in
    [-1, 1] (cast to contiguous f32 on the card). Returns (M, P, C) in
    feats.dtype with f32 accumulation, align_corners=True, zero padding.
    Differentiable in feats (W^T g); the grid gets a zero gradient.

    CUDA tensors launch the kernel; CPU tensors run ``grid_sample_2d``.
    Channel rows take 16-byte vector loads when C * itemsize is a multiple
    of 16, and scalar loads otherwise: the FeatureNeRF caller pads its odd
    C + 1 channel maps to a multiple of 8 (models/nerf.project_ref_maps), so
    the main path takes the vector path. Launches are counted by shape (M,
    H, W, C, P, dtype) in ``bilinear_sample.launches_by_shape``.
    """
    return _BilinearSample.apply(feats, grid)


bilinear_sample.launches_by_shape = Counter()
bilinear_sample_bwd.launches_by_shape = Counter()
