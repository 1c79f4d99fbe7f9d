"""The inputs of every cell, made from the run's seed. A request or a
step ``i`` of seed ``s`` draws from a generator seeded by (s, i), so the
same seed gives the same inputs whatever ran before. Every seed gives the
same sizes: token ids, poses, noise and images change, shapes do not."""
from __future__ import annotations

import numpy as np
import torch

BOS, EOT = 49406, 49407  # CLIP's start and end ids
CONTEXT = 77


def _entropy(seed, stream):
    return [x % (1 << 64) for x in (seed, *stream)]


def rng(seed: int, *stream) -> np.random.Generator:
    """A numpy generator of (seed, *stream); negative stream ids are the
    warm-up's and the spans' requests."""
    return np.random.default_rng(_entropy(seed, stream))


def torch_gen(seed: int, *stream, device="cpu") -> torch.Generator:
    s = int(np.random.SeedSequence(_entropy(seed, stream)).generate_state(1, np.uint64)[0])
    return torch.Generator(device=device).manual_seed(s & ((1 << 63) - 1))


def prompt_ids(r: np.random.Generator, vocab: int, lengths, context: int = CONTEXT) -> np.ndarray:
    """(context,) int32 CLIP ids of a prompt of n in [lengths] tokens: BOS,
    n - 2 ids drawn from the vocabulary with the V* id (= ``vocab``, the
    first modifier row) at a drawn position, EOT, then padding 0."""
    n = min(int(r.integers(lengths[0], lengths[1] + 1)), context)
    words = r.integers(1, min(BOS, vocab), size=n - 2)
    words[int(r.integers(0, n - 2))] = vocab
    ids = np.zeros(context, np.int32)
    ids[:n] = np.concatenate([[BOS], words, [EOT]])
    return ids


def empty_prompt_ids(context: int = CONTEXT) -> np.ndarray:
    ids = np.zeros(context, np.int32)
    ids[:2] = (BOS, EOT)
    return ids


def ring(thetas, radius: float = 2.7):
    """Rotations (N, 3, 3) and translations (N, 3) of cameras on a circle
    around the origin, looking at it (the sampling CLI's ring cameras)."""
    th = np.asarray(thetas, np.float64)
    rot = np.zeros((len(th), 3, 3), np.float32)
    rot[:, 0, 0], rot[:, 0, 2] = np.cos(th), np.sin(th)
    rot[:, 1, 1] = 1.0
    rot[:, 2, 0], rot[:, 2, 2] = -np.sin(th), np.cos(th)
    trans = np.tile(np.array([0, 0, radius], np.float32), (len(th), 1))
    return rot, trans


def reference_buffers(ref_unet_mod, unet_cfg, n_views: int, latent: int, seed: int, device):
    """Delta-checkpoint reference buffers {attn_id: {depth: (n_views + 1,
    hw, C)}} (the last row the zero-image feature) for every pose block,
    N(0, 0.05^2) f32, one draw a block."""
    gen = torch_gen(seed, 7, device=device)
    meta = ref_unet_mod.attn_block_meta(unet_cfg)
    out = {}
    for attn_id, (ds, ch, depth) in sorted(meta.items()):
        tcfg = unet_cfg.transformer_config(ch, depth, attn_id)
        for d in range(depth):
            if tcfg.block_has_nerf(d):
                out.setdefault(attn_id, {})[d] = torch.randn(
                    (n_views + 1, (latent // ds) ** 2, ch), generator=gen, device=device) * 0.05
    return out


def sample_request(seed: int, i: int, traffic: dict, vocab: int, device, context: int = CONTEXT):
    """Request ``i``: its prompt's ids (1, 77), the empty negative prompt's,
    its target pose on the ring (drawn angle) and its initial noise (1, h,
    w, 4) f32."""
    r = rng(seed, 1, i)
    latent = traffic["resolution"] // 8
    rot, trans = ring([r.uniform(0.0, 2 * np.pi)], traffic["radius"])
    noise = torch.randn((1, latent, latent, 4), generator=torch_gen(seed, 2, i, device=device),
                        device=device)
    return {"ids": torch.from_numpy(prompt_ids(r, vocab, traffic["prompt_tokens"], context))[None],
            "neg_ids": torch.from_numpy(empty_prompt_ids(context))[None],
            "rot": rot, "trans": trans, "noise": noise}


def size_rows(rows: int, res: int, device) -> dict:
    """The SDXL size conditioning of ``rows`` rows at ``res``^2, uncropped."""
    return {"original_size": torch.full((rows, 2), float(res), device=device),
            "crop_coords": torch.zeros((rows, 2), device=device),
            "target_size": torch.full((rows, 2), float(res), device=device)}


def train_item(seed: int, k: int, traffic: dict, vocab: int, device,
               context: int = CONTEXT) -> dict:
    """Training item ``k`` in the form of the training batch (batch 1): a
    target and ``views`` reference images N(0, 0.3^2) at ``resolution``^2,
    full masks, a disc-shaped opacity (so the foreground and background
    terms are both live), ring cameras at drawn angles, and a prompt with
    the V* id for the target and each reference row. Raw arrays: each side
    wraps the cameras in its own type."""
    r = rng(seed, 3, k)
    res, n = traffic["resolution"], traffic["views"]
    lat = res // 8
    gen = torch_gen(seed, 4, k, device=device)

    def image(*shape):
        return torch.randn(shape, generator=gen, device=device) * 0.3

    yy, xx = np.mgrid[:res, :res]
    disc = ((yy - res / 2) ** 2 + (xx - res / 2) ** 2 < (0.35 * res) ** 2).astype(np.float32)
    ids = torch.from_numpy(np.stack([prompt_ids(r, vocab, traffic["prompt_tokens"], context)
                                     for _ in range(1 + n)])).to(device)
    rot, trans = ring(r.uniform(0.0, 2 * np.pi, size=1 + n), traffic["radius"])
    item = {
        "image": image(1, res, res, 3), "image_ref": image(1, n, res, res, 3),
        "mask": torch.ones((1, lat, lat, 1), device=device),
        "mask_ref": torch.ones((1, n, lat, lat, 1), device=device),
        "opacity": torch.from_numpy(disc)[None, :, :, None].to(device),
        "drop_im": torch.ones((1,), device=device),
        "tokens_clip": ids[:1], "tokens_open": ids[:1],
        "tokens_clip_ref": ids[1:], "tokens_open_ref": ids[1:],
        "rot": rot[None], "trans": trans[None],
    }
    item.update(size_rows(1, res, device))
    item.update({k + "_ref": v for k, v in size_rows(n, res, device).items()})
    return item


def ae_images(seed: int, k: int, traffic: dict, device, dtype) -> torch.Tensor:
    """Batch ``k`` of the autoencoder's images: (batch, res, res, 3) drawn
    uniform in [-1, 1], in ``dtype``."""
    b, res = traffic["batch"], traffic["resolution"]
    x = torch.rand((b, res, res, 3), generator=torch_gen(seed, 5, k, device=device),
                   device=device) * 2.0 - 1.0
    return x.to(dtype)
