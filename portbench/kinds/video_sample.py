"""Video sampling traffic (``"kind": "video_sample"``): one user's closed
loop of Stable Video Diffusion image-to-video requests, one clip at a time,
each as ``scripts/sampling/simple_video_sample.py`` runs it: the general
conditioner's video stack on the request's own conditioning image (the
ViT-H/14 embedding of the clean image, the VAE mode of the image noised by
``cond_aug``, the sinusoidal ``fps_id`` / ``motion_bucket_id`` /
``cond_aug``; the unconditional pass with crossattn and concat zeroed),
``Engine.sample`` of ``frames`` frames from the request's own noise under
``linear_prediction_guider`` (both copies in one batch of 2 x frames),
``Engine.decode_first_stage`` of all frames in one call, and the clip as
uint8 on the host. The unit is a clip; ``image_s`` is its time over its
frames.

Weights: the plain reference's modules (``refmodel/svdref``) on the meta
device give every leaf's name and shape in the published checkpoint's
layout; the leaves are drawn on the card from the seed (``harness/
weights.materialize``) in the served dtype, and the program gets them
through its own checkpoint converter (``io/torch_convert.py::
convert_svd_state_dict``). The conditioner's autoencoder is the first
stage's (one VAE under both prefixes).

The check: after the window, a request drawn from the seed among those
finished, against the f32 reference on the same weights, image, noise and
draws: the conditioner's outputs (``cond``); the guided prediction
c_skip x - D(x) (-c_out times the guided network output) at drawn steps,
the reference's recomputed from the program's own latent at that step
(``step``; the direction x - D(x) would read x alone at sigma 700); the final latent of the reference's own
trajectory (``latent``); the reference's decode of the program's final
latent against the program's clip (``image``); each a relative L2 gap.
Two controls: the reference in the program's dtype with every product's
operands in float8 e4m3 in the program's place (``control``), and the
program with every blend's alpha forced to 1, which drops the temporal
layers (``alpha_one``).

A port without the video network (no ``VideoUNetConfig``) fails at once."""
from __future__ import annotations

import importlib
import sys
from pathlib import Path

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from harness import compare, inputs, precision, weights

PORT = "custom_diffusion360_torch"
ZERO_INIT = ("model.diffusion_model.out.2.", ".out_layers.3.", ".proj_out.")


def _port():
    """The port's modules this kind drives; exits at once where the port
    has no video network."""
    mods = {n: importlib.import_module(f"{PORT}.{m}") for n, m in (
        ("engine", "engine"), ("unet", "models.unet"), ("cond", "models.general_conditioner"),
        ("convert", "io.torch_convert"), ("clip", "models.clip"), ("vae", "models.vae"),
        ("guiders", "diffusion.guiders"), ("denoiser", "diffusion.denoiser"))}
    if not (hasattr(mods["unet"], "VideoUNetConfig")
            and hasattr(mods["cond"], "video_conditioning")
            and hasattr(mods["convert"], "convert_svd_state_dict")):
        raise SystemExit(f"portbench: {PORT} has no video network (VideoUNetConfig, "
                         "general_conditioner.video_conditioning, convert_svd_state_dict): "
                         "this cell cannot run")
    return type("Port", (), mods)


def _reference():
    ref_dir = str(Path(__file__).resolve().parents[1] / "refmodel")
    if ref_dir not in sys.path:
        sys.path.insert(0, ref_dir)
    return importlib.import_module("svdref.svd_reference")


def _tuples(d: dict) -> dict:
    return {k: tuple(v) if isinstance(v, list) else v for k, v in d.items()}


def _kind(name, param, module, merge_factor):
    """A leaf's initializer in ``weights``' form: PyTorch's defaults
    (kaiming-uniform weight and bias of a linear or convolution, ones and
    zeros of a norm, xavier-uniform packed q/k/v), every leaf the source
    zero-initialises drawn from N(0, 0.02^2) instead, the blends'
    ``mix_factor`` at its published start, the tower's embeddings N(0,
    width^-1)."""
    if name.endswith("mix_factor"):
        return ("const", float(merge_factor), 0.0, False)
    if isinstance(module, (nn.GroupNorm, nn.LayerNorm)):
        if name.endswith("weight"):
            return ("const", 1.0, 0.0, False)
        return ("normal", 0.02, 0.0, False)
    if any(z in name for z in ZERO_INIT):
        return ("normal", 0.02, 0.0, False)
    if isinstance(module, (nn.Linear, nn.Conv2d, nn.Conv3d)):
        fan_in = module.weight[0].numel()
        return ("uniform", fan_in ** -0.5, 0.0, False)
    if name.endswith("in_proj_weight"):
        return ("uniform", (6.0 / (param.shape[0] + param.shape[1])) ** 0.5, 0.0, False)
    if name.endswith("in_proj_bias"):
        return ("normal", 0.02, 0.0, False)
    return ("normal", param.shape[-1] ** -0.5, 0.0, False)


class Recorder:
    """The guider, passed through; notes each step's (latent, sigma,
    guided denoised latent) as ``prepare`` and ``combine`` see them."""

    def __init__(self, guider):
        self._guider = guider
        self.steps = []
        self._last = None

    def __getattr__(self, name):
        return getattr(self._guider, name)

    def prepare(self, x, s, c, uc):
        self._last = (x, s)
        return self._guider.prepare(x, s, c, uc)

    def combine(self, denoised, sigma):
        out = self._guider.combine(denoised, sigma)
        self.steps.append((self._last[0], self._last[1], out))
        return out


def _nchw(t):
    return t.permute(0, 3, 1, 2)


def _nhwc(t):
    return t.permute(0, 2, 3, 1)


def _uint8(img):
    return ((img.float() + 1) * 127.5).clamp(0, 255).to(torch.uint8).cpu()


class Job:
    metric, trace_units = "image_s", 1

    def __init__(self, cell):
        self.P = P = _port()
        self.R = R = _reference()
        self.cell, self.dev = cell, cell.device
        model, mix = cell.config, cell.traffic
        self.mix, self.frames = mix, int(mix["frames"])
        self.scale = 1.0 / self.frames
        self.down = 2 ** (len(model["vae"]["ch_mult"]) - 1)  # image side over latent side
        if (mix["sigma_min"], mix["rho"]) != (0.002, 7.0):
            raise ValueError("the port's EDM schedule takes sigma_max alone "
                             "(sigma_min 0.002, rho 7)")
        u, v, c = model["unet"], model["vae"], model["conditioner"]
        self.dtype = {"bfloat16": torch.bfloat16, "float32": torch.float32}[model["dtype"]]
        self.ref_cfg = dict(
            unet=dict(in_channels=u["in_channels"], model_channels=u["model_channels"],
                      out_channels=u["out_channels"], num_res_blocks=u["num_res_blocks"],
                      attention_resolutions=tuple(u["attention_resolutions"]),
                      channel_mult=tuple(u["channel_mult"]),
                      num_head_channels=u["num_head_channels"],
                      transformer_depth=u["transformer_depth"], context_dim=u["context_dim"],
                      adm_in_channels=u["adm_in_channels"], merge_factor=u["merge_factor"],
                      video_kernel_size=tuple(u["video_kernel_size"])),
            vae=dict(ch=v["ch"], ch_mult=tuple(v["ch_mult"]), num_res_blocks=v["num_res_blocks"],
                     z_channels=v["z_channels"], in_channels=v["in_channels"], out_ch=v["out_ch"]),
            vision={**c["vision"], "output_dim": c["vision"]["embed_dim"]},
            outdim=c["outdim"], scale_factor=v["scale_factor"])
        self.ref_cfg["vision"].pop("embed_dim")
        depth = u["transformer_depth"]
        depth = (depth,) * len(u["channel_mult"]) if isinstance(depth, int) else tuple(depth)
        unet_cfg = P.unet.VideoUNetConfig(
            in_channels=u["in_channels"], model_channels=u["model_channels"],
            out_channels=u["out_channels"], num_res_blocks=u["num_res_blocks"],
            attention_resolutions=tuple(u["attention_resolutions"]),
            channel_mult=tuple(u["channel_mult"]), transformer_depth=depth,
            context_dim=u["context_dim"], adm_in_channels=u["adm_in_channels"],
            num_head_channels=u["num_head_channels"])
        vae_cfg = P.vae.VAEConfig(**_tuples({k: v[k] for k in (
            "ch", "ch_mult", "num_res_blocks", "in_channels", "out_ch", "z_channels", "double_z",
            "scale_factor")}))
        self.cond_cfg = P.cond.VideoConditionerConfig(
            vision=P.clip.ClipVisionConfig(**c["vision"]), vae=vae_cfg, outdim=c["outdim"])
        self.cfg = P.engine.EngineConfig(
            unet=unet_cfg, vae=vae_cfg, conditioner=self.cond_cfg,
            denoiser=P.denoiser.DenoiserConfig(scaling=model["denoiser"]["scaling"],
                                               discrete=False),
            discretization_name="edm", sigma_max=float(mix["sigma_max"]),
            num_sample_steps=mix["steps"], compute_dtype=model["dtype"])
        self.sd = self.make_weights(cell.seed)
        self.params = P.convert.convert_svd_state_dict(self.sd, unet_cfg, vae_cfg,
                                                       self.cond_cfg.vision)
        self.eng = P.engine.Engine(self.cfg, device=self.dev)
        self.guider = P.guiders.linear_prediction_guider(
            max_scale=mix["max_scale"], num_frames=self.frames, min_scale=mix["min_scale"])
        self.records = {}
        self.unit(-1)  # warm-up: every shape of a request

    # ---- weights -------------------------------------------------------------

    def meta_reference(self):
        with torch.device("meta"):
            return self.R.SVDReference(**self.ref_cfg)

    def make_weights(self, seed):
        """{checkpoint key: leaf} in the served dtype, drawn on the card; the
        conditioner's autoencoder aliases the first stage's leaves."""
        ref = self.meta_reference()
        owner = {f"{m}.{n}" if m else n: mod for m, mod in ref.named_modules()
                 for n, _ in mod.named_parameters(recurse=False)}
        merge = self.ref_cfg["unet"]["merge_factor"]
        tree, kinds = {}, {}
        for name, p in ref.named_parameters():
            if name.startswith("conditioner.embedders.3."):
                continue
            t = torch.empty(p.shape, device="meta", dtype=self.dtype)
            tree[name], kinds[id(t)] = t, (t, _kind(name, p, owner[name], merge))
        sd = weights.materialize(tree, kinds, seed, self.dev, self.dtype)
        enc = "conditioner.embedders.3.encoder."
        for name, _ in ref.named_parameters():
            if name.startswith(enc):
                sd[name] = sd["first_stage_model." + name[len(enc):]]
        return sd

    def reference_model(self, dtype=torch.float32):
        ref = self.meta_reference()
        ref.load_state_dict({k: v.to(dtype) for k, v in self.sd.items()}, assign=True)
        return ref.eval()

    # ---- one request ---------------------------------------------------------

    def request(self, i):
        """Request ``i``: its conditioning image (1, H, W, 3) in [-1, 1]
        (smooth coloured structure, stripes and grain, all drawn from (seed,
        i)), the draws of its conditioning noise, its initial noise (frames,
        h, w, 4)."""
        mix, dev = self.mix, self.dev
        h, w = mix["height"], mix["width"]
        gen = inputs.torch_gen(self.cell.seed, 11, i, device=dev)
        r = inputs.rng(self.cell.seed, 12, i)
        base = torch.rand((1, 3, max(h // 64, 2), max(w // 64, 2)), generator=gen, device=dev)
        img = F.interpolate(base * 2 - 1, size=(h, w), mode="bicubic", align_corners=False)
        yy = torch.linspace(0, 1, h, device=dev)[:, None]
        xx = torch.linspace(0, 1, w, device=dev)[None, :]
        fy, fx, phase = r.uniform(2, 12), r.uniform(2, 12), r.uniform(0, 2 * np.pi)
        img = img + 0.3 * torch.sin(2 * np.pi * (fy * yy + fx * xx) + phase)
        img = img + 0.05 * torch.randn((1, 3, h, w), generator=gen, device=dev)
        image = _nhwc(img.clamp(-1, 1))
        cond_noise = torch.randn(image.shape, generator=gen, device=dev)
        noise = torch.randn((self.frames, h // self.down, w // self.down, 4), generator=gen,
                            device=dev)
        return image, cond_noise, noise

    def _conditioning(self, P, req):
        mix = self.mix
        batch = P.cond.video_batch(req[0], req[1], self.frames, mix["fps_id"],
                                   mix["motion_bucket_id"], mix["cond_aug"])
        c, uc = P.cond.video_conditioning(self.params["conditioner"], self.cond_cfg, batch,
                                          self.frames)
        return ({k: v.to(self.dtype) for k, v in c.items()},
                {k: v.to(self.dtype) for k, v in uc.items()})

    @torch.inference_mode()
    def _request(self, i, guider):
        """Request ``i`` through the program -> (c, uc, z, uint8 clip)."""
        P = self.P
        req = self.request(i)
        c, uc = self._conditioning(P, req)
        z = self.eng.sample(self.params, c, uc, guider, noise=req[2], num_steps=self.mix["steps"],
                            num_frames=self.frames)
        img = _uint8(self.eng.decode_first_stage(self.params, z.to(self.dtype)))
        return c, uc, z, img

    def unit(self, i):
        rec = Recorder(self.guider)
        c, uc, z, img = self._request(i, rec)
        if i >= 0:
            self.records[i] = {"c": c, "uc": uc, "z": z, "img": img, "steps": rec.steps}

    def spans(self):
        """No synchronised clip: every metric of this cell reads the device
        trace or the untraced window."""
        return {}

    # ---- the check -----------------------------------------------------------

    def picks(self, n_done):
        r = inputs.rng(self.cell.seed, 8)
        k = min(self.mix["check_requests"], n_done)
        return sorted(int(i) for i in r.choice(n_done, k, replace=False))

    def check(self):
        recs = {i: self.records[i] for i in self.picks(len(self.records))}
        self.records = {}
        self.free_program()
        values = self.compare(recs)
        return compare.limits_checks(values, self.cell.workload["limits"])

    def readings(self):
        """The program's numbers on requests 0 .. check_requests - 1."""
        for i in range(self.mix["check_requests"]):
            self.unit(i)
        recs, self.records = self.records, {}
        self.free_program()
        return self.compare(recs)

    def alpha_one(self):
        """The program with every blend's alpha forced to 1 (mix_factor
        1e4, sigmoid 1 in any float type): the temporal layers dropped."""
        saved = []

        def walk(node):
            if isinstance(node, dict):
                for k, v in node.items():
                    if k == "mix_factor":
                        saved.append((node, v))
                        node[k] = torch.full_like(v, 1e4)
                    else:
                        walk(v)
            elif isinstance(node, list):
                for v in node:
                    walk(v)

        walk(self.params["unet"])
        try:
            for i in range(self.mix["check_requests"]):
                self.unit(i)
        finally:
            for node, v in saved:
                node["mix_factor"] = v
        recs, self.records = self.records, {}
        self.free_program()
        return self.compare(recs)

    def control(self):
        """The reference in the program's dtype with every product's
        operands in float8 e4m3, in the program's place."""
        self.free_program()
        ref = self.reference_model(self.dtype)
        out = {}
        for i in range(self.mix["check_requests"]):
            with precision.Fp8Products(), torch.inference_mode():
                c, uc, z, steps = self._ref_request(ref, i)
                img = _uint8(_nhwc(ref.decode_first_stage(z.to(self.dtype),
                                                          self.mix["decoding_t"])))
            c, uc = ({k: _nhwc(v) if v.dim() == 4 else v for k, v in d.items()} for d in (c, uc))
            out[i] = {"c": c, "uc": uc, "z": _nhwc(z), "img": img,
                      "steps": [(_nhwc(x), s, _nhwc(d)) for x, s, d in steps]}
        del ref
        return self.compare(out)

    def free_program(self):
        self.__dict__.pop("eng", None)
        self.__dict__.pop("params", None)
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()

    def _ref_request(self, ref, i):
        """The reference's conditioning and its own float32 trajectory for
        request i: (c, uc, final latent NCHW, [(x, sigma, guided denoised)]
        NCHW)."""
        image, cond_noise, noise = self.request(i)
        mix = self.mix
        batch = self.R.video_batch(_nchw(image), _nchw(cond_noise), self.frames, mix["fps_id"],
                                   mix["motion_bucket_id"], mix["cond_aug"])
        c, uc = self.R.conditioning(ref, batch, self.frames)
        steps = []
        z = ref.sample(c, uc, _nchw(noise), self.mix["steps"], self.ref_guider(),
                       self.frames, sigma_max=self.mix["sigma_max"],
                       callback=lambda i, x, s, d: steps.append((x, s, d)))
        return c, uc, z, steps

    def ref_guider(self):
        return self.R.LinearPredictionGuider(self.mix["max_scale"], self.frames,
                                             self.mix["min_scale"])

    @torch.inference_mode()
    def compare(self, recs):
        ref = self.reference_model()
        guider = self.ref_guider()
        vals = {"cond": [], "step": [], "latent": [], "image": []}
        for i, rec in recs.items():
            c, uc, z, _ = self._ref_request(ref, i)
            gaps = []
            for got, want in ((rec["c"], c), (rec["uc"], uc)):
                for k, w in want.items():
                    g = got[k].float()
                    gaps.append(compare.rel(_nchw(g) if g.dim() == 4 else g, w))
            vals["cond"].append(max(gaps))
            vals["latent"].append(compare.rel(_nchw(rec["z"].float()), z))
            drawn = inputs.rng(self.cell.seed, 9, i).choice(
                len(rec["steps"]), self.mix["check_steps"], replace=False)
            step_gaps = {}
            for s in sorted(drawn):
                x, sigma, got = rec["steps"][s]
                x, sigma = _nchw(x.float()), sigma.float()
                want = ref.guided_denoise(guider, x, sigma, c, uc, self.frames)
                skip = self.R.append_dims(self.R.v_scaling_with_edm_noise(sigma)[0], x.dim()) * x
                step_gaps[int(s)] = compare.rel(skip - _nchw(got.float()), skip - want)
            self.diagnostics = {"step_gaps": step_gaps}
            vals["step"].append(max(step_gaps.values()))
            img = _uint8(_nhwc(ref.decode_first_stage(_nchw(rec["z"].float()),
                                                      self.mix["decoding_t"])))
            vals["image"].append(compare.rel(rec["img"].float() - 127.5, img.float() - 127.5))
        del ref
        return {k: max(v) for k, v in vals.items()}

    # ---- model operations ------------------------------------------------------

    def model_flops(self):
        """Operations of one clip, counted on the reference over meta
        tensors: the conditioner (both passes), every sampler step's UNet
        over both guider copies, and the decode."""
        from torch.utils.flop_counter import FlopCounterMode

        ref, mix, meta = self.meta_reference(), self.mix, torch.device("meta")
        t, h, w = self.frames, mix["height"], mix["width"]
        image = torch.empty((1, 3, h, w), device=meta)
        batch = self.R.video_batch(image, image, t, mix["fps_id"], mix["motion_bucket_id"],
                                   mix["cond_aug"])

        def count(fn):
            with FlopCounterMode(display=False) as fc:
                fn()
            return fc.get_total_flops()

        cond = count(lambda: self.R.conditioning(ref, batch, t))
        c, uc = self.R.conditioning(ref, batch, t)
        x = torch.empty((t, 4, h // self.down, w // self.down), device=meta)
        sigma = torch.empty((t,), device=meta)
        step = count(lambda: ref.guided_denoise(self.ref_guider(), x, sigma, c, uc, t))
        decode = count(lambda: ref.decode_first_stage(x, mix["decoding_t"]))
        return cond + mix["steps"] * step + decode
