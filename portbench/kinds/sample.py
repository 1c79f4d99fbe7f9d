"""Sampling traffic (``"kind": "sample"``): one user's closed loop of image
requests at batch 1, each as the sampling CLI runs a job: the conditioner
on the request's own prompt ids (and the empty negative prompt, text
zeroed), ``Engine.sample`` with the guider of the mix from the request's
own noise and target pose on a ring, the pose blocks' reference features
from delta-checkpoint buffers of ``train_views`` ring views of which
``views`` are chosen as the CLI chooses them, then
``Engine.decode_first_stage`` and the image as uint8 on the host. No
synchronisation between steps.

The check: after the window, requests drawn from the seed among those
finished, each against the f32 reference (``cd360ref``) on the same ids,
noise, cameras, buffers and weights: the conditioner's outputs
(``cond``), the render step's direction x - D(x) (D the guided denoised
latent) from the same start (``render``), the direction of drawn cached
steps, the reference's recomputed from the program's own latent at that
step (``cached``), the final latent of the reference's own 50-step trajectory
(``latent``) and the reference's decode of the program's final latent
against the program's image (``image``), each a relative L2 gap."""
from __future__ import annotations

import contextlib
import time

import numpy as np
import torch

from harness import compare, inputs, models, precision, weights
from harness.cell import sync


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


def _guider(pkg, mix):
    if mix["guider"] == "scheduled_cfg_img_text_ref":
        return pkg.guiders.scheduled_cfg_img_text_ref(scale=mix["scale"], scale_im=mix["scale_im"])
    return pkg.guiders.vanilla_cfg_img_ref(scale=mix["scale"])


class Job:
    metric, scale, trace_units = "image_s", 1.0, 1

    def __init__(self, cell):
        self.cell = cell
        mix, model, dev = cell.traffic, cell.config, cell.device
        self.mix, self.dev = mix, dev
        self.port = models.package(models.PORT)
        self.ref = models.package(models.REFERENCE)
        common = dict(num_sample_steps=mix["steps"], sampler_name=mix["sampler"])
        self.cfg = models.engine_config(
            self.port, model, model["dtype"],
            {"nerf_dtype": model["dtype"], "nerf_chunk_size": mix["nerf_chunk"]}, **common)
        self.ref_cfg = models.engine_config(
            self.ref, model, "float32",
            {"nerf_dtype": "float32", "nerf_chunk_size": mix["nerf_chunk"]}, **common)
        # the control: the reference in the program's dtypes (its products in e4m3)
        self.control_cfg = models.engine_config(
            self.ref, model, model["dtype"],
            {"nerf_dtype": model["dtype"], "nerf_chunk_size": mix["nerf_chunk"]}, **common)
        self.dtype = self.cfg.dtype
        self.vocab = self.cfg.conditioner.clip_l.vocab_size
        self.context = self.cfg.conditioner.clip_l.context_length
        self.params = weights.make(models.engine_init(self.ref, self.ref_cfg, self.dtype), cell.seed, dev,
                                   self.dtype)
        latent = mix["resolution"] // 8
        self.refs = inputs.reference_buffers(self.ref.unet, self.ref_cfg.unet, mix["train_views"],
                                             latent, cell.seed, dev)
        n_train, n_ref = mix["train_views"], mix["views"]
        # the CLI's choice of reference views: evenly spaced over the training ring
        self.choices = [int(x) for x in np.linspace(0, n_train - n_train / n_ref, n_ref)]
        self.ref_rot, self.ref_trans = inputs.ring(
            np.linspace(0, 2 * np.pi, n_train, endpoint=False)[self.choices], mix["radius"])
        self.eng = self.port.engine.Engine(self.cfg, device=dev)
        self.guider = _guider(self.port, mix)
        self.records = {}
        self.unit(-1)  # warm-up: every shape of a request

    # ---- one request -------------------------------------------------------

    def _cams(self, pkg, req, copies):
        rot = np.concatenate([req["rot"], self.ref_rot])[None].repeat(copies, 0)
        trans = np.concatenate([req["trans"], self.ref_trans])[None].repeat(copies, 0)
        return models.cameras(pkg, rot, trans, self.dev)

    def _batches(self, req):
        sizes = inputs.size_rows(1, self.mix["resolution"], self.dev)
        ids, neg = req["ids"].to(self.dev), req["neg_ids"].to(self.dev)
        return ({"tokens_clip": ids, "tokens_open": ids, **sizes},
                {"tokens_clip": neg, "tokens_open": neg, **sizes})

    def _request(self, i, guider, marks=None):
        """Request ``i`` through the program -> (c, uc, z, uint8 image).
        ``marks``: a list that gets synchronised host times at the start,
        after the conditioner and after each sampler step."""
        P, mix = self.port, self.mix
        req = inputs.sample_request(self.cell.seed, i, mix, self.vocab, self.dev, self.context)
        batch, neg = self._batches(req)
        callback = None
        if marks is not None:
            def callback(step=None):
                sync(self.dev)
                marks.append(time.perf_counter())

            callback()
        c, uc = P.conditioner.get_unconditional_conditioning(
            self.params["conditioner"], batch, neg, self.cfg.conditioner,
            force_uc_zero_txt=True, ref=False)
        c = {k: v.to(self.dtype) for k, v in c.items()}
        uc = {k: v.to(self.dtype) for k, v in uc.items()}
        if callback is not None:
            callback()
        z = self.eng.sample(
            self.params, c, uc, guider, noise=req["noise"],
            cams=self._cams(P, req, guider.num_copies), references=self.refs,
            choices=self.choices, num_steps=mix["steps"], sampler=mix["sampler"],
            draws=P.draws.Draws(inputs.torch_gen(self.cell.seed, 6, i)), callback=callback,
            shared_target_cams=True)
        img = self.eng.decode_first_stage(self.params, z.to(self.dtype))
        img = ((img.float() + 1) * 127.5).clamp(0, 255).to(torch.uint8).cpu().numpy()
        return c, uc, z, img

    def unit(self, i):
        rec = Recorder(self.guider)
        c, uc, z, img = self._request(i, rec)
        if i >= 0:
            self.records[i] = {"c": c, "uc": uc, "z": z, "img": img, "steps": rec.steps}

    def spans(self):
        """One more request, synchronised at the conditioner's end and after
        each sampler step: {span: ms}."""
        marks = []
        self._request(-2, self.guider, marks)
        done = time.perf_counter()
        start, cond, steps = marks[0], marks[1], marks[2:]
        return {"conditioner_ms": (cond - start) * 1e3,
                "render_step_ms": (steps[0] - cond) * 1e3,
                "cached_step_ms": (steps[-1] - steps[0]) / (len(steps) - 1) * 1e3,
                "decode_ms": (done - steps[-1]) * 1e3}

    # ---- the check ---------------------------------------------------------

    def picks(self, n_done):
        """The window's requests the check compares, drawn from the seed."""
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

    def control(self):
        """The control's numbers on the same requests: the reference in the
        program's dtypes with every product's operands in float8 e4m3, in
        the program's place."""
        self.free_program()
        return self.compare(self.control_records(range(self.mix["check_requests"])))

    def free_program(self):
        self.__dict__.pop("eng", None)
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()

    def _ref_request(self, i, reng, pf, guider, fp8=False):
        """The reference's conditioning and its own trajectory for request
        i: (req, cams, c, uc, z, steps)."""
        R = self.ref
        req = inputs.sample_request(self.cell.seed, i, self.mix, self.vocab, self.dev, self.context)
        batch, neg = self._batches(req)
        with precision.Fp8Products() if fp8 else contextlib.nullcontext():
            c, uc = R.conditioner.get_unconditional_conditioning(
                pf["conditioner"], batch, neg, self.ref_cfg.conditioner,
                force_uc_zero_txt=True, ref=False)
            cams = self._cams(R, req, guider.num_copies)
            rec = Recorder(guider)
            z = reng.sample(pf, c, uc, rec, noise=req["noise"], cams=cams, references=self.refs,
                            choices=self.choices, num_steps=self.mix["steps"],
                            sampler=self.mix["sampler"], shared_target_cams=True)
        return req, cams, c, uc, z, rec.steps

    def reference(self):
        R = self.ref
        return (R.engine.Engine(self.ref_cfg, device=self.dev), weights.to_float(self.params),
                _guider(R, self.mix))

    def control_records(self, picks):
        """The control in the program's place: the reference in the
        program's dtypes with every product's operands in float8 e4m3, on
        the requests ``picks``."""
        R = self.ref
        reng = R.engine.Engine(self.control_cfg, device=self.dev)
        guider = _guider(R, self.mix)
        out = {}
        for i in picks:
            _, _, c, uc, z, steps = self._ref_request(i, reng, self.params, guider, fp8=True)
            with precision.Fp8Products(), torch.inference_mode():
                img = reng.decode_first_stage(self.params, z.to(self.dtype))
            img = ((img.float() + 1) * 127.5).clamp(0, 255).to(torch.uint8).cpu().numpy()
            out[i] = {"c": c, "uc": uc, "z": z, "img": img, "steps": steps}
        return out

    @torch.inference_mode()
    def compare(self, recs):
        reng, pf, guider = self.reference()
        vals = {"cond": [], "render": [], "cached": [], "latent": [], "image": []}
        for i, rec in recs.items():
            req, cams, c, uc, z, steps = self._ref_request(i, reng, pf, guider)
            vals["cond"].append(max(compare.rel(got[k].float(), want[k]) for got, want in
                                    ((rec["c"], c), (rec["uc"], uc)) for k in want))
            x0 = steps[0][0]
            vals["render"].append(compare.rel(x0 - rec["steps"][0][2], x0 - steps[0][2]))
            vals["latent"].append(compare.rel(rec["z"], z))
            denoise = _cached_denoiser(self, reng, pf, guider, c, uc, cams, steps[0][0],
                                       steps[0][1])
            r = inputs.rng(self.cell.seed, 9, i)
            drawn = r.choice(np.arange(1, len(rec["steps"])), self.mix["check_steps"],
                             replace=False)
            vals["cached"].append(max(_step_gap(rec["steps"][s], denoise) for s in drawn))
            img = reng.decode_first_stage(pf, rec["z"].float())
            img = ((img.float() + 1) * 127.5).clamp(0, 255).to(torch.uint8).cpu()
            vals["image"].append(compare.rel(torch.from_numpy(rec["img"]).float() - 127.5,
                                             img.float() - 127.5))
        return {k: max(v) for k, v in vals.items()}

    # ---- model operations ----------------------------------------------------

    def model_flops(self):
        """Operations of one request, counted on the reference over meta
        tensors: the conditioner (prompt and negative prompt), the render
        step, each cached step (two runs of 2 and 3 steps give it) and the
        decode."""
        from torch.utils.flop_counter import FlopCounterMode

        R, mix, meta = self.ref, self.mix, torch.device("meta")
        tree, _ = weights.meta_tree(models.engine_init(R, self.ref_cfg, torch.float32), torch.float32)
        reng = R.engine.Engine(self.ref_cfg, device=meta)
        guider = _guider(R, mix)
        req = inputs.sample_request(self.cell.seed, 0, mix, self.vocab, "cpu", self.context)
        refs = {a: {d: t.to(meta) for d, t in per.items()} for a, per in self.refs.items()}
        sizes = inputs.size_rows(1, mix["resolution"], meta)
        ids = req["ids"].to(meta)
        batch = {"tokens_clip": ids, "tokens_open": ids, **sizes}

        def count(fn):
            with FlopCounterMode(display=False) as fc:
                fn()
            return fc.get_total_flops()

        cond = count(lambda: R.conditioner.get_unconditional_conditioning(
            tree["conditioner"], batch, batch, self.ref_cfg.conditioner, ref=False))
        c = R.conditioner.apply_conditioner(tree["conditioner"], batch, self.ref_cfg.conditioner,
                                            ref=False)
        cams = self._cams(R, req, guider.num_copies)
        cams = type(cams)(*(f.to(meta) for f in cams))

        def sample(n):
            return reng.sample(tree, c, c, guider, noise=req["noise"].to(meta), cams=cams,
                               references=refs, choices=self.choices, num_steps=n,
                               sampler=mix["sampler"], shared_target_cams=True)

        two, three = count(lambda: sample(2)), count(lambda: sample(3))
        z = torch.empty((1, mix["resolution"] // 8, mix["resolution"] // 8, 4), device=meta)
        decode = count(lambda: reng.decode_first_stage(tree, z))
        return cond + two + (mix["steps"] - 2) * (three - two) + decode


def _step_gap(step, denoise) -> float:
    """The relative gap of a step's direction x - D(x): the program's guided
    denoised latent against the reference's at the program's own latent."""
    x, sigma, got = step
    x = x.float()
    return compare.rel(x - got, x - denoise(x, sigma))


@torch.inference_mode()
def _cached_denoiser(job, reng, pf, guider, c, uc, cams, x0, s0):
    """The reference's guided denoiser of the cached steps: the render at
    (x0, s0) once, then the network on the rendered features with the text
    K/V hoisted, as ``Engine.sample`` runs its steps after the first."""
    R = job.ref
    fused = dict(pf, unet=R.transformer.fuse_attention_params(pf["unet"]))
    ref_features = reng.build_ref_features(job.refs, job.choices, x0.shape[0], guider.num_copies)
    network = reng.network_fn(fused, cams, None, ref_features=ref_features)
    xb, sb, cb = guider.prepare(x0, s0, c, uc)
    _, aux = reng.denoiser(network, xb, sb, cb)
    _, _, cb0 = guider.prepare(x0, torch.zeros_like(s0), c, uc)
    ctx_kv = R.unet.precompute_context_kv(fused["unet"], job.ref_cfg.unet, cb0["crossattn"])
    cached = reng.network_fn(fused, cams, None, nerf_caches=aux["rendered"], ctx_kv=ctx_kv)

    def denoise(x, sigma):
        xb, sb, cb = guider.prepare(x, sigma, c, uc)
        d, _ = reng.denoiser(cached, xb, sb, cb)
        return guider.combine(d, sigma)

    return denoise
