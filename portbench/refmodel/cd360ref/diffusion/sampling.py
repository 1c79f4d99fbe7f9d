"""Diffusion samplers (port of custom_diffusion360_tpu/diffusion/
sampling.py): plain Python loops over the (sigma, next sigma) pairs of a
descending float32 schedule, with the per-step scalars kept in float32 as
the JAX scan computes them.

Every sampler takes ``denoise_fn(x, sigma_vec) -> denoised`` (the guider
lives inside that closure) and shares the signature
``(denoise_fn, x, sigmas, cfg, *, noise, scale_init, callback)``:
``noise`` is the per-step standard normal draws, a (n_steps, *x.shape)
tensor whose row i is step i's (churn for Euler and Heun, the ancestral
noise for the two ancestral samplers, which require it); ``scale_init``
applies x *= sqrt(1 + sigma_0^2) first; ``callback(i)`` runs after step i.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence

import numpy as np
import torch


def _append_dims(x, ndim):
    return x.reshape(tuple(x.shape) + (1,) * (ndim - x.dim()))


def to_d(x, sigma, denoised):
    """(x - denoised) / sigma."""
    return (x - denoised) / _append_dims(sigma, x.dim())


def get_ancestral_step(sigma_from, sigma_to, eta=1.0):
    """(sigma_down, sigma_up) of an ancestral step."""
    if not eta:
        return sigma_to, torch.zeros_like(sigma_to)
    sigma_up = torch.minimum(
        sigma_to,
        eta * torch.sqrt(sigma_to**2 * (sigma_from**2 - sigma_to**2) / sigma_from**2))
    sigma_down = torch.sqrt(sigma_to**2 - sigma_up**2)
    return sigma_down, sigma_up


@dataclasses.dataclass(frozen=True)
class SamplerConfig:
    num_steps: int = 50
    s_churn: float = 0.0
    s_tmin: float = 0.0
    s_tmax: float = float("inf")
    s_noise: float = 1.0
    eta: float = 1.0  # ancestral samplers
    order: int = 4  # LMS


def _gammas(sigmas, cfg: SamplerConfig):
    """Per-step churn gamma, (n_steps,) float32."""
    n = sigmas.shape[0]
    g = min(cfg.s_churn / max(n - 1, 1), 2**0.5 - 1)
    in_range = (sigmas >= cfg.s_tmin) & (sigmas <= cfg.s_tmax)
    return torch.where(in_range, torch.full_like(sigmas, g), torch.zeros_like(sigmas))[:-1]


def _sigma_vec(sigma, batch, device):
    return torch.full((batch,), float(sigma), dtype=torch.float32, device=device)


def _prep(x, sigmas, scale_init):
    if scale_init:
        x = x * torch.sqrt(1.0 + sigmas[0] ** 2)
    return x


def _scalars(sigmas):
    """The schedule as a CPU float32 tensor (its entries are the loops'
    0-d scalars, which broadcast onto tensors on any device)."""
    return torch.as_tensor(sigmas, dtype=torch.float32).cpu()


def _need_noise(noise, name):
    if noise is None:
        raise ValueError(f"{name} draws noise every step: pass noise (n_steps, *x.shape)")
    return noise


def euler_edm_sample(denoise_fn: Callable, x, sigmas, cfg: SamplerConfig = SamplerConfig(), *,
                     noise=None, scale_init: bool = True, callback=None):
    """EulerEDMSampler. Churn noise is added only when ``cfg.s_churn`` > 0
    and ``noise`` is given (the JAX sampler adds it only with a key); the
    churned sigma_hat applies either way."""
    sigmas = _scalars(sigmas)
    x = _prep(x, sigmas, scale_init)
    b = x.shape[0]
    gammas = _gammas(sigmas, cfg)
    use_churn = cfg.s_churn > 0.0 and noise is not None
    for i in range(sigmas.shape[0] - 1):
        sigma, next_sigma = sigmas[i], sigmas[i + 1]
        sigma_hat = sigma * (gammas[i] + 1.0)
        if use_churn:
            eps = noise[i].to(x.device, x.dtype) * cfg.s_noise
            x = x + eps * torch.sqrt(torch.clamp(sigma_hat**2 - sigma**2, min=0.0))
        sv = _sigma_vec(sigma_hat, b, x.device)
        x = x + (next_sigma - sigma_hat) * to_d(x, sv, denoise_fn(x, sv))
        if callback is not None:
            callback(i)
    return x


def heun_edm_sample(denoise_fn, x, sigmas, cfg: SamplerConfig = SamplerConfig(), *,
                    noise=None, scale_init: bool = True, callback=None):
    """HeunEDMSampler: Euler, then the 2nd-order correction unless the next
    sigma is ~0 (the last step)."""
    sigmas = _scalars(sigmas)
    x = _prep(x, sigmas, scale_init)
    b = x.shape[0]
    gammas = _gammas(sigmas, cfg)
    use_churn = cfg.s_churn > 0.0 and noise is not None
    for i in range(sigmas.shape[0] - 1):
        sigma, next_sigma = sigmas[i], sigmas[i + 1]
        sigma_hat = sigma * (gammas[i] + 1.0)
        if use_churn:
            eps = noise[i].to(x.device, x.dtype) * cfg.s_noise
            x = x + eps * torch.sqrt(torch.clamp(sigma_hat**2 - sigma**2, min=0.0))
        sv = _sigma_vec(sigma_hat, b, x.device)
        d = to_d(x, sv, denoise_fn(x, sv))
        dt = next_sigma - sigma_hat
        euler = x + dt * d
        if float(next_sigma) > 1e-14:
            sv2 = _sigma_vec(next_sigma, b, x.device)
            d2 = to_d(euler, sv2, denoise_fn(euler, sv2))
            x = x + dt * 0.5 * (d + d2)
        else:
            x = euler
        if callback is not None:
            callback(i)
    return x


def euler_ancestral_sample(denoise_fn, x, sigmas, cfg: SamplerConfig = SamplerConfig(), *,
                           noise=None, scale_init: bool = True, callback=None):
    """EulerAncestralSampler: an Euler step to sigma_down, then noise of
    scale sigma_up (none on the step to sigma 0)."""
    noise = _need_noise(noise, "euler_ancestral_sample")
    sigmas = _scalars(sigmas)
    x = _prep(x, sigmas, scale_init)
    b = x.shape[0]
    for i in range(sigmas.shape[0] - 1):
        sigma, next_sigma = sigmas[i], sigmas[i + 1]
        sigma_down, sigma_up = get_ancestral_step(sigma, next_sigma, cfg.eta)
        sv = _sigma_vec(sigma, b, x.device)
        x = x + (sigma_down - sigma) * to_d(x, sv, denoise_fn(x, sv))
        if float(next_sigma) > 0.0:
            x = x + noise[i].to(x.device, x.dtype) * cfg.s_noise * sigma_up
        if callback is not None:
            callback(i)
    return x


def dpmpp2s_ancestral_sample(denoise_fn, x, sigmas, cfg: SamplerConfig = SamplerConfig(), *,
                             noise=None, scale_init: bool = True, callback=None):
    """DPMPP2SAncestralSampler: a DPM-Solver++(2S) step to sigma_down (an
    Euler step when sigma_down is ~0), then ancestral noise."""
    noise = _need_noise(noise, "dpmpp2s_ancestral_sample")
    sigmas = _scalars(sigmas)
    x = _prep(x, sigmas, scale_init)
    b = x.shape[0]
    for i in range(sigmas.shape[0] - 1):
        sigma, next_sigma = sigmas[i], sigmas[i + 1]
        sigma_down, sigma_up = get_ancestral_step(sigma, next_sigma, cfg.eta)
        sv = _sigma_vec(sigma, b, x.device)
        denoised = denoise_fn(x, sv)
        if float(sigma_down) > 1e-14:
            t, t_next = -torch.log(sigma), -torch.log(sigma_down)
            h = t_next - t
            s = t + 0.5 * h
            mult1 = torch.exp(-s) / torch.exp(-t)
            mult2 = torch.expm1(-0.5 * h)
            mult3 = torch.exp(-t_next) / torch.exp(-t)
            mult4 = torch.expm1(-h)
            x2 = mult1 * x - mult2 * denoised
            denoised2 = denoise_fn(x2, _sigma_vec(torch.exp(-s), b, x.device))
            x_new = mult3 * x - mult4 * denoised2
        else:
            x_new = x + (sigma_down - sigma) * to_d(x, sv, denoised)
        if float(next_sigma) > 0.0:
            x_new = x_new + noise[i].to(x.device, x.dtype) * cfg.s_noise * sigma_up
        x = x_new
        if callback is not None:
            callback(i)
    return x


def dpmpp2m_sample(denoise_fn, x, sigmas, cfg: SamplerConfig = SamplerConfig(), *,
                   noise=None, scale_init: bool = True, callback=None):
    """DPMPP2MSampler: multistep, carrying the previous step's denoised; the
    first and the last step (to sigma ~0) take the first-order update."""
    sigmas = _scalars(sigmas)
    x = _prep(x, sigmas, scale_init)
    b = x.shape[0]
    old_denoised = None
    for i in range(sigmas.shape[0] - 1):
        sigma, next_sigma = sigmas[i], sigmas[i + 1]
        denoised = denoise_fn(x, _sigma_vec(sigma, b, x.device))
        t, t_next = -torch.log(sigma), -torch.log(next_sigma)
        h = t_next - t
        mult1 = torch.exp(-t_next) / torch.exp(-t)
        mult2 = torch.expm1(-h)
        if i == 0 or float(next_sigma) < 1e-14:
            x = mult1 * x - mult2 * denoised
        else:
            r = (t - (-torch.log(sigmas[i - 1]))) / h
            denoised_d = (1 + 1 / (2 * r)) * denoised - (1 / (2 * r)) * old_denoised
            x = mult1 * x - mult2 * denoised_d
        old_denoised = denoised
        if callback is not None:
            callback(i)
    return x


def _lms_coeffs(sigmas: np.ndarray, order: int) -> np.ndarray:
    """Adams-Bashforth coefficients on the sigma grid, (n_steps, order):
    each Lagrange basis polynomial integrated exactly over [t_i, t_i+1]."""
    t = np.asarray(sigmas, np.float64)
    n = len(t) - 1
    coeffs = np.zeros((n, order), np.float64)
    for i in range(n):
        cur_order = min(i + 1, order)
        for j in range(cur_order):
            num = np.poly1d([1.0])
            denom = 1.0
            for k in range(cur_order):
                if k == j:
                    continue
                num *= np.poly1d([1.0, -t[i - k]])
                denom *= t[i - j] - t[i - k]
            integ = num.integ()
            coeffs[i, j] = (integ(t[i + 1]) - integ(t[i])) / denom
    return coeffs


def linear_multistep_sample(denoise_fn, x, sigmas, cfg: SamplerConfig = SamplerConfig(), *,
                            noise=None, scale_init: bool = True, callback=None):
    """LinearMultistepSampler of order ``cfg.order``: x += sum_j c_ij d_(i-j)
    over the last ``order`` derivatives."""
    sigmas = _scalars(sigmas)
    x = _prep(x, sigmas, scale_init)
    b = x.shape[0]
    coeffs = torch.from_numpy(_lms_coeffs(sigmas.numpy(), cfg.order).astype(np.float32))
    ds = []  # most recent first
    for i in range(sigmas.shape[0] - 1):
        sv = _sigma_vec(sigmas[i], b, x.device)
        ds = [to_d(x, sv, denoise_fn(x, sv))] + ds[: cfg.order - 1]
        upd = coeffs[i, 0] * ds[0]
        for j in range(1, len(ds)):
            upd = upd + coeffs[i, j] * ds[j]
        x = x + upd
        if callback is not None:
            callback(i)
    return x


def multidiffusion_sample(denoise_fns: Sequence[Callable], noise, sigmas,
                          cfg: SamplerConfig = SamplerConfig(), *, window: int = 64,
                          stride: int = 48, callback=None):
    """EDMMultidiffusionSampler: panorama-style windowed Euler. ``noise`` is
    the wide initial latent's standard normal draws (B, H, stride *
    (len(denoise_fns) + 1), C), NHWC; windows of ``window`` columns every
    ``stride`` tile the width, ``denoise_fns[j]`` (view j's cond and pose)
    denoises window j each step, and the windows' Euler updates are
    averaged where they overlap (columns no window covers become 0, as in
    the JAX sampler)."""
    n_views = len(denoise_fns)
    b, _, width, _ = noise.shape
    if width != stride * (n_views + 1):
        raise ValueError(f"noise width {width} != stride * (views + 1) = "
                         f"{stride * (n_views + 1)}")
    views = [(i * stride, i * stride + window) for i in range((width - window) // stride + 1)]
    sigmas = _scalars(sigmas)
    x = noise.float() * torch.sqrt(1.0 + sigmas[0] ** 2)
    gammas = _gammas(sigmas, cfg)
    for i in range(sigmas.shape[0] - 1):
        sigma_hat = sigmas[i] * (gammas[i] + 1.0)
        sv = _sigma_vec(sigma_hat, b, x.device)
        value = torch.zeros_like(x)
        count = torch.zeros_like(x)
        for j, (ws, we) in enumerate(views):
            xv = x[:, :, ws:we, :]
            d = to_d(xv, sv, denoise_fns[min(j, n_views - 1)](xv, sv))
            value[:, :, ws:we, :] += xv + (sigmas[i + 1] - sigma_hat) * d
            count[:, :, ws:we, :] += 1.0
        x = torch.where(count > 0, value / torch.clamp(count, min=1.0), value)
        if callback is not None:
            callback(i)
    return x


# The single-pose samplers by name (EngineConfig.sampler_name, the CLIs'
# --sampler).
SAMPLERS = {
    "euler_edm": euler_edm_sample,
    "heun_edm": heun_edm_sample,
    "euler_ancestral": euler_ancestral_sample,
    "dpmpp2s_ancestral": dpmpp2s_ancestral_sample,
    "dpmpp2m": dpmpp2m_sample,
    "lms": linear_multistep_sample,
}


def needs_step_noise(name: str, cfg: SamplerConfig = SamplerConfig()) -> bool:
    """Whether sampler ``name`` consumes per-step noise under ``cfg``."""
    return name in ("euler_ancestral", "dpmpp2s_ancestral") or (
        name in ("euler_edm", "heun_edm") and cfg.s_churn > 0.0)


def step_noise(draws, name: str, cfg: SamplerConfig, n_steps: int, shape, device
               ) -> Optional[torch.Tensor]:
    """The draw "step_noise" (n_steps, *shape) from ``draws`` when sampler
    ``name`` consumes it, else None."""
    if not needs_step_noise(name, cfg):
        return None
    if draws is None:
        raise ValueError(f"sampler {name!r} draws noise every step: pass draws")
    return draws.normal("step_noise", (n_steps,) + tuple(shape), device)
