"""Evaluation CLI: FID and CLIP scores of sampled images (port of
custom_diffusion360_tpu/cli/evaluate.py).

The paper's metric protocol: FID of the generated images against the real
views, CLIP-T (each image against the prompt) and CLIP-I (each image
against a real view).

    python -m custom_diffusion360_torch.cli.evaluate \\
        --generated out/samples --real data/car0_views \\
        --prompt "photo of a <new1> car" \\
        --inception_ckpt pt_inception-2015-12-05.pth \\
        --clip_vision_ckpt open_clip_vit_h14.pth --vocab_dir tok/

The metrics follow from what is given:
  * --real + --inception_ckpt -> FID (pytorch_fid's InceptionV3 names)
  * --prompt + --clip_vision_ckpt + --vocab_dir -> CLIP-T (the open_clip
    ViT-H/14 text tower, read from --clip_text_ckpt or else from the vision
    file, without its ``visual.*`` keys; bpe_simple_vocab_16e6.txt.gz in
    --vocab_dir)
  * --real + --clip_vision_ckpt -> CLIP-I (``visual.*`` open_clip names,
    or HuggingFace ones with --clip_arch hf)

Runs on the CUDA card unless ``--device cpu``. ``--smoke`` scores random
images with tiny towers made from seeds (no weights needed). Prints the
metrics as one JSON line and writes them to ``--output`` if given.
"""
from __future__ import annotations

import argparse
import json
import os
import re

import numpy as np
import torch

from .. import resolve_device
from ..data.tokenizer import ClipTokenizer
from ..eval.clip_score import clip_image_similarity, clip_score
from ..eval.fid import FeatureStats, fid_from_stats
from ..eval.inception import inception_pool3_features, init_inception_params, load_inception_torch
from ..io.torch_convert import convert_open_clip_state_dict, load_torch_state_dict
from ..models.clip import (
    ClipTextConfig,
    ClipVisionConfig,
    init_clip_text_params,
    init_clip_vision_params,
    load_clip_vision_torch,
)
from ..train.trainer import tree_map

# the ViT-H/14 text tower of open_clip (CLIP-T): width 1024, 24 layers, no
# V* row (a vanilla CLIP has none; the prompt's <newN> is stripped)
VIT_H14_TEXT = ClipTextConfig(width=1024, layers=24, heads=16, act="gelu",
                              text_projection=True, num_modifier_tokens=0)


def build_parser():
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--generated", default=None, help="dir of generated PNG/JPG images")
    p.add_argument("--real", default=None,
                   help="dir of real concept images (FID / CLIP-I reference)")
    p.add_argument("--prompt", default=None, help="prompt for CLIP-T")
    p.add_argument("--inception_ckpt", default=None,
                   help="pytorch_fid pt_inception .pth (torch state dict)")
    p.add_argument("--clip_vision_ckpt", default=None,
                   help="open_clip checkpoint with visual.* keys")
    p.add_argument("--clip_arch", default="open_clip", choices=["open_clip", "hf"],
                   help="naming inside --clip_vision_ckpt")
    p.add_argument("--clip_text_ckpt", default=None,
                   help="open_clip checkpoint with text-tower keys for CLIP-T (may be the same "
                        "file as the vision ckpt)")
    p.add_argument("--vocab_dir", default=None,
                   help="dir with bpe_simple_vocab_16e6.txt.gz (see cli.sample)")
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--output", default=None, help="write metrics JSON here")
    p.add_argument("--smoke", action="store_true")
    p.add_argument("--device", default="cuda")
    return p


def _list_images(d):
    exts = (".png", ".jpg", ".jpeg", ".webp")
    return sorted(os.path.join(d, f) for f in os.listdir(d) if f.lower().endswith(exts))


def _load_images(paths, size=None):
    """-> (N, H, W, 3) float32 in [0, 1]; ``size``: a bicubic PIL resize to
    size x size first."""
    from PIL import Image

    imgs = []
    for p in paths:
        im = Image.open(p).convert("RGB")
        if size is not None:
            im = im.resize((size, size), Image.BICUBIC)
        imgs.append(np.asarray(im, np.float32) / 255.0)
    return np.stack(imgs)


def _batched(fn, images, batch):
    """fn over runs of ``batch`` images, concatenated on the host."""
    return np.concatenate([fn(images[i:i + batch]).cpu().numpy()
                           for i in range(0, len(images), batch)])


def compute_fid(inception_params, gen, real, batch=8, device="cuda"):
    """FID of two (N, H, W, 3) [0, 1] image sets, the features taken on
    ``device`` (where ``inception_params`` live)."""
    device = resolve_device(device)

    def feats(imgs):
        # pytorch_fid's protocol: [0, 1] inputs, mapped to the [-1, 1] range
        # that the published pt_inception weights expect
        return inception_pool3_features(inception_params, torch.from_numpy(imgs).to(device),
                                        resize_input=True, normalize_input=True)

    s_gen = FeatureStats().update(_batched(feats, gen, batch))
    s_real = FeatureStats().update(_batched(feats, real, batch))
    return fid_from_stats(s_gen, s_real)


def _to(tree, device):
    return tree_map(lambda t: t.to(device), tree)


@torch.inference_mode()
def main(argv=None):
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    metrics = {}

    if args.smoke:
        gen_t = torch.Generator().manual_seed(0)
        gen = torch.rand((4, 32, 32, 3), generator=gen_t).numpy()
        real = torch.rand((4, 32, 32, 3), generator=gen_t).numpy()
        metrics["fid"] = compute_fid(init_inception_params(0, device), gen, real, args.batch,
                                     device)
        vcfg = ClipVisionConfig(image_size=16, patch_size=8, width=32, layers=2, heads=4,
                                embed_dim=32)
        tcfg = ClipTextConfig(vocab_size=64, width=32, layers=2, heads=4, context_length=8,
                              text_projection=True)
        vp = init_clip_vision_params(vcfg, 1, device)
        tp = init_clip_text_params(tcfg, 2, device)
        tokens = torch.randint(0, 60, (4, 8), generator=gen_t).to(device)
        g = torch.from_numpy(gen * 2 - 1).to(device)
        metrics["clip_t"] = float(clip_score(vp, tp, g, tokens, vcfg, tcfg).mean())
        metrics["clip_i"] = float(clip_image_similarity(
            vp, g, torch.from_numpy(real * 2 - 1).to(device), vcfg).mean())
    else:
        if not args.generated:
            raise SystemExit("--generated is required (or --smoke)")
        gen = _load_images(_list_images(args.generated))
        real = (_load_images(_list_images(args.real), size=gen.shape[1])
                if args.real else None)

        if args.inception_ckpt and real is not None:
            inc = _to(load_inception_torch(load_torch_state_dict(args.inception_ckpt)), device)
            metrics["fid"] = compute_fid(inc, gen, real, args.batch, device)
            del inc

        if args.clip_vision_ckpt:
            sd = load_torch_state_dict(args.clip_vision_ckpt)
            vcfg = ClipVisionConfig()  # ViT-H/14
            vp = _to(load_clip_vision_torch(sd, vcfg, naming=args.clip_arch), device)
            g = torch.from_numpy(gen * 2 - 1)
            if args.prompt:
                if args.vocab_dir is None:
                    raise SystemExit("CLIP-T against real weights needs --vocab_dir "
                                     "(the bpe vocab files)")
                tsd = sd
                if args.clip_text_ckpt and args.clip_text_ckpt != args.clip_vision_ckpt:
                    tsd = load_torch_state_dict(args.clip_text_ckpt)
                tsd = {k: v for k, v in tsd.items() if not k.startswith("visual.")}
                tp = _to(convert_open_clip_state_dict(tsd, VIT_H14_TEXT, prefix=""), device)
                del tsd
                # a vanilla CLIP has no row for the V* token: strip it from the
                # prompt (the customization papers' protocol) and tokenize
                # without the special token, so no id passes the vocabulary
                # or takes the eot argmax
                prompt = re.sub(r"\s*<new\d+>\s*", " ", args.prompt).strip()
                tok = ClipTokenizer.from_merges(
                    os.path.join(args.vocab_dir, "bpe_simple_vocab_16e6.txt.gz"))
                tokens = torch.from_numpy(np.asarray(tok([prompt] * len(gen)))).to(device)
                metrics["clip_t"] = float(np.mean(np.concatenate([
                    clip_score(vp, tp, g[i:i + args.batch].to(device),
                               tokens[i:i + args.batch], vcfg, VIT_H14_TEXT).cpu().numpy()
                    for i in range(0, len(gen), args.batch)])))
                del tp
            if real is not None:
                r = torch.from_numpy(real * 2 - 1)
                n = min(len(gen), len(real))
                metrics["clip_i"] = float(np.mean(np.concatenate([
                    clip_image_similarity(vp, g[i:min(i + args.batch, n)].to(device),
                                          r[i:min(i + args.batch, n)].to(device),
                                          vcfg).cpu().numpy()
                    for i in range(0, n, args.batch)])))

    print(json.dumps(metrics))
    if args.output:
        with open(args.output, "w") as f:
            json.dump(metrics, f)
    return metrics


if __name__ == "__main__":
    main()
