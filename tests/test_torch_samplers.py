"""The port's samplers, sigma schedules, scalings, weightings, denoiser
settings and linear_prediction_guider against the JAX package, on the CPU
in float32.

The samplers run on a closed-form ``denoise_fn`` (a nonlinear function of x
and sigma, identical on both sides) with the per-step noise that the JAX
sampler draws (``jax.random.split(key, n)``, ``normal(k_i, x.shape)``)
handed to the port as a tensor. The JAX samplers run op by op
(``jax.disable_jit()``), each operation rounded once as in the port: under
jit, XLA contracts ``sigma_hat**2 - sigma**2`` into a fused multiply-add,
so on a step without churn (sigma_hat == sigma) the churn term becomes the
square root of a rounding residual, about 5e-3 at sigma 24 instead of 0
(ROADMAP.md Queue 3; the jitted JAX Euler with churn on the EDM schedule
is 2.2e-4 from a float64 evaluation of the same steps, the port 5e-7).
Tolerances: samplers within 1e-6 of the
output's max|JAX| (at least 1); schedules equal; scalings and weightings
within 1e-7 relative; the denoiser within 1e-6 relative; the guider within
1e-6 of its output scale (jnp.linspace and torch.linspace may round a
ramp's entry one ulp apart).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from custom_diffusion360_tpu.diffusion import discretization as jdisc
from custom_diffusion360_tpu.diffusion import guiders as jguiders
from custom_diffusion360_tpu.diffusion import sampling as jsamp
from custom_diffusion360_tpu.diffusion import scaling as jscal
from custom_diffusion360_tpu.diffusion import sigma_sampling as jsig
from custom_diffusion360_tpu.diffusion.denoiser import Denoiser as JDenoiser
from custom_diffusion360_tpu.diffusion.denoiser import DenoiserConfig as JDenoiserConfig
from custom_diffusion360_torch.diffusion import discretization as tdisc
from custom_diffusion360_torch.diffusion import guiders as tguiders
from custom_diffusion360_torch.diffusion import sampling as tsamp
from custom_diffusion360_torch.diffusion import scaling as tscal
from custom_diffusion360_torch.diffusion import sigma_sampling as tsig
from custom_diffusion360_torch.diffusion.denoiser import Denoiser, DenoiserConfig
from custom_diffusion360_torch.draws import Draws
from tests.test_torch_common import max_err, t
from tests.test_torch_common import torch_threads  # noqa: F401  (fixture)

pytestmark = pytest.mark.usefixtures("torch_threads")

SHAPE = (2, 4, 4, 3)


def _rel(got, want, tol):
    return max_err(got, want) <= tol * max(1.0, float(np.abs(np.asarray(want)).max()))


def _denoise_pair(a=0.3, w=0.7):
    """The same closed-form x0 prediction for both packages, rational in x
    and sigma: only correctly rounded operations, so both sides round
    alike."""
    def f(x, s):
        s = s.reshape(-1, 1, 1, 1)
        return x / (1.0 + s * s) + a * x / (1.0 + w * x * x) * (s / (1.0 + s))

    return f, f


def jax_step_noise(key, n, shape):
    """The per-step draws of a JAX sampler's ``jax.random.split(key, n)``."""
    return np.stack([np.asarray(jax.random.normal(k, shape)) for k in jax.random.split(key, n)])


SAMPLER_CASES = {
    "euler_edm": jsamp.SamplerConfig(),
    "euler_edm_churn": jsamp.SamplerConfig(s_churn=2.5, s_tmin=0.5, s_tmax=8.0, s_noise=1.003),
    "heun_edm": jsamp.SamplerConfig(),
    "heun_edm_churn": jsamp.SamplerConfig(s_churn=1.0, s_noise=0.9),
    "euler_ancestral": jsamp.SamplerConfig(eta=0.8),
    "dpmpp2s_ancestral": jsamp.SamplerConfig(),
    "dpmpp2m": jsamp.SamplerConfig(),
    "lms": jsamp.SamplerConfig(),
    "lms_order2": jsamp.SamplerConfig(order=2),
}


@pytest.mark.parametrize("schedule", ["legacy_ddpm", "edm"])
@pytest.mark.parametrize("case", sorted(SAMPLER_CASES))
def test_sampler_matches_jax(case, schedule):
    name = case.replace("_churn", "").replace("_order2", "")
    jcfg = SAMPLER_CASES[case]
    tcfg = tsamp.SamplerConfig(**{f: getattr(jcfg, f) for f in jcfg.__dataclass_fields__})
    n = 6
    sig_j = jdisc.make_sigmas(schedule, n)
    sig_t = tdisc.make_sigmas(schedule, n)
    x0 = np.random.default_rng(1).normal(size=SHAPE).astype(np.float32)
    key = jax.random.PRNGKey(3)
    jfn, tfn = _denoise_pair()
    with jax.disable_jit():
        want = jsamp.SAMPLERS[name](jfn, jnp.asarray(x0), sig_j, jcfg, key=key)
    noise = t(jax_step_noise(key, n, SHAPE))
    steps = []
    got = tsamp.SAMPLERS[name](tfn, t(x0), sig_t, tcfg, noise=noise, callback=steps.append)
    assert steps == list(range(n))
    assert np.isfinite(np.asarray(want)).all()
    assert float(np.abs(np.asarray(want) - x0 * float(sig_j[0])).max()) > 0.1  # it moved
    assert _rel(got, want, 1e-6), (case, schedule, max_err(got, want))


def test_ancestral_samplers_need_noise_and_others_do_not():
    _, tfn = _denoise_pair()
    sig = tdisc.make_sigmas("legacy_ddpm", 3)
    for name in ("euler_ancestral", "dpmpp2s_ancestral"):
        with pytest.raises(ValueError, match="noise"):
            tsamp.SAMPLERS[name](tfn, torch.zeros(SHAPE), sig)
    assert sorted(tsamp.SAMPLERS) == sorted(jsamp.SAMPLERS)
    churn = tsamp.SamplerConfig(s_churn=1.0)
    assert [tsamp.needs_step_noise(k) for k in sorted(tsamp.SAMPLERS)] == [
        False, True, True, False, False, False]  # dpmpp2m, dpmpp2s, euler_anc, euler, heun, lms
    assert tsamp.needs_step_noise("euler_edm", churn) and tsamp.needs_step_noise("heun_edm", churn)
    assert tsamp.step_noise(None, "lms", churn, 3, SHAPE, "cpu") is None
    with pytest.raises(ValueError, match="draws"):
        tsamp.step_noise(None, "euler_edm", churn, 3, SHAPE, "cpu")
    got = tsamp.step_noise(Draws(torch.Generator().manual_seed(0)), "euler_ancestral",
                           tsamp.SamplerConfig(), 3, SHAPE, "cpu")
    assert got.shape == (3,) + SHAPE


def test_euler_churn_skips_the_noise_without_draws_like_jax_without_a_key():
    jcfg = SAMPLER_CASES["euler_edm_churn"]
    tcfg = tsamp.SamplerConfig(s_churn=jcfg.s_churn, s_tmin=jcfg.s_tmin, s_tmax=jcfg.s_tmax,
                               s_noise=jcfg.s_noise)
    x0 = np.random.default_rng(2).normal(size=SHAPE).astype(np.float32)
    jfn, tfn = _denoise_pair()
    with jax.disable_jit():
        want = jsamp.euler_edm_sample(jfn, jnp.asarray(x0), jdisc.make_sigmas("edm", 5), jcfg)
    got = tsamp.euler_edm_sample(tfn, t(x0), tdisc.make_sigmas("edm", 5), tcfg)
    assert _rel(got, want, 1e-6)
    gam_j = jsamp._gammas(jdisc.make_sigmas("edm", 5), jcfg)
    gam_t = tsamp._gammas(tdisc.make_sigmas("edm", 5), tcfg)
    np.testing.assert_array_equal(gam_t.numpy(), np.asarray(gam_j))
    assert 0 < float(gam_t.max()) and float(gam_t.min()) == 0.0  # some steps out of range


def test_lms_coeffs_match_jax():
    for order in (1, 3, 4):
        sig = np.asarray(jdisc.make_sigmas("legacy_ddpm", 7))
        np.testing.assert_array_equal(tsamp._lms_coeffs(sig, order), jsamp._lms_coeffs(sig, order))


def test_multidiffusion_matches_jax():
    n_views, window, stride, n = 2, 8, 6, 4
    shape = (1, 4, stride * (n_views + 1), 3)
    key = jax.random.PRNGKey(5)
    cfg_j = jsamp.SamplerConfig(s_churn=1.0)
    sig_j, sig_t = jdisc.make_sigmas("legacy_ddpm", n), tdisc.make_sigmas("legacy_ddpm", n)
    pairs = [_denoise_pair(0.3, 0.7), _denoise_pair(-0.2, 1.3)]
    with jax.disable_jit():
        want = jsamp.multidiffusion_sample([p[0] for p in pairs], shape, sig_j, cfg_j, key=key,
                                           window=window, stride=stride)
    noise = t(np.asarray(jax.random.normal(key, shape)))
    got = tsamp.multidiffusion_sample([p[1] for p in pairs], noise, sig_t,
                                      tsamp.SamplerConfig(s_churn=1.0), window=window,
                                      stride=stride)
    assert got.shape == shape
    assert float(np.abs(np.asarray(want)).max()) > 0.1
    assert _rel(got, want, 1e-6)
    with pytest.raises(ValueError, match="width"):
        tsamp.multidiffusion_sample([p[1] for p in pairs], noise[:, :, 1:], sig_t)


# ---------------------------------------------------------------------------
# schedules, scalings, weightings, sigma sampling
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["legacy_ddpm", "LegacyDDPMDiscretization", "edm",
                                  "EDMDiscretization"])
def test_make_sigmas_match_jax_exactly(kind):
    for n in (1, 3, 8, 50):
        for kw in ({}, {"append_zero": False}, {"flip": True}):
            want = np.asarray(jdisc.make_sigmas(kind, n, **kw))
            got = tdisc.make_sigmas(kind, n, **kw)
            assert got.dtype == torch.float32
            np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(tdisc.edm_sigmas(10, sigma_min=0.01, sigma_max=20.0, rho=5.0)
                                  .numpy(),
                                  np.asarray(jdisc.edm_sigmas(10, sigma_min=0.01, sigma_max=20.0,
                                                              rho=5.0)))
    with pytest.raises(ValueError, match="unknown discretization"):
        tdisc.make_sigmas("cosine", 4)


SIGMAS = np.array([0.002, 0.03, 0.5, 1.0, 2.7, 14.6, 80.0], np.float32)


@pytest.mark.parametrize("kind", ["eps", "edm", "v", "EpsScaling", "EDMScaling", "VScaling"])
def test_scalings_match_jax(kind):
    want = jscal.get_scaling(kind)(jnp.asarray(SIGMAS))
    got = tscal.get_scaling(kind)(t(SIGMAS))
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert np.all(np.abs(g.numpy() - w) <= 1e-7 * np.maximum(np.abs(w), 1e-30))


@pytest.mark.parametrize("kind", ["unit", "edm", "v", "eps", "UnitWeighting", "EDMWeighting",
                                  "VWeighting", "EpsWeighting"])
def test_weightings_match_jax(kind):
    w = np.asarray(jscal.get_weighting(kind)(jnp.asarray(SIGMAS)))
    g = tscal.get_weighting(kind)(t(SIGMAS)).numpy()
    assert np.all(np.abs(g - w) <= 1e-7 * np.abs(w))


def test_sample_sigmas_edm_matches_jax():
    key = jax.random.PRNGKey(9)
    want = np.asarray(jsig.sample_sigmas_edm(key, 5))
    z = np.asarray(jax.random.normal(key, (5,)))
    got = tsig.sample_sigmas_edm(Draws(given={"sigma": t(z)}), "sigma", 5, "cpu")
    assert np.all(np.abs(got.numpy() - want) <= 1e-6 * want)


# ---------------------------------------------------------------------------
# denoiser and guider
# ---------------------------------------------------------------------------


def _networks():
    """A closed-form network(x, c_noise, cond, input_ref, sigmas_ref) for
    both packages, depending on every input."""
    def j(x, c, cond, input_ref=None, sigmas_ref=None):
        out = jnp.tanh(x) * (1.0 + 0.01 * c.reshape(-1, 1, 1, 1)) + cond["vector"][:, :1, None, None]
        if input_ref is not None:
            out = out + input_ref.mean(1) * (0.5 + 0.001 * sigmas_ref.reshape(-1, 1, 1, 1))
        return out, {"c": c}

    def p(x, c, cond, input_ref=None, sigmas_ref=None):
        out = torch.tanh(x) * (1.0 + 0.01 * c.reshape(-1, 1, 1, 1)) + cond["vector"][:, :1, None, None]
        if input_ref is not None:
            out = out + input_ref.mean(1) * (0.5 + 0.001 * sigmas_ref.reshape(-1, 1, 1, 1))
        return out, {"c": c}

    return j, p


DENOISERS = {
    "eps_discrete": dict(),
    "edm_continuous": dict(scaling="edm", weighting="edm", discrete=False),
    "v_discrete": dict(scaling="v", weighting="v"),
    "v_unquantized_c_noise": dict(scaling="v", weighting="unit", quantize_c_noise=False),
    "eps_grid_500": dict(num_idx=500),
}


@pytest.mark.parametrize("name", sorted(DENOISERS))
def test_denoiser_settings_match_jax(name):
    kw = DENOISERS[name]
    jd, td = JDenoiser(JDenoiserConfig(**kw)), Denoiser(DenoiserConfig(**kw))
    rng = np.random.default_rng(4)
    x = rng.normal(size=SHAPE).astype(np.float32)
    sig = np.array([0.7, 6.3], np.float32)
    ref = rng.normal(size=(2, 3) + SHAPE[1:]).astype(np.float32)
    sref = np.array([0.0, 2.2], np.float32)
    cond = {"vector": rng.normal(size=(2, 5)).astype(np.float32)}
    jn, tn = _networks()
    for with_ref in (False, True):
        extra_j = dict(input_ref=jnp.asarray(ref), sigmas_ref=jnp.asarray(sref)) if with_ref else {}
        extra_t = dict(input_ref=t(ref), sigmas_ref=t(sref)) if with_ref else {}
        want, aux_j = jd(jn, jnp.asarray(x), jnp.asarray(sig), jax.tree.map(jnp.asarray, cond),
                         **extra_j)
        got, aux_t = td(tn, t(x), t(sig), {k: t(v) for k, v in cond.items()}, **extra_t)
        assert _rel(got, want, 1e-6), (name, with_ref)
        np.testing.assert_allclose(aux_t["c"].numpy(), np.asarray(aux_j["c"]), rtol=1e-6)
    w_j = np.asarray(jd.w(jnp.asarray(sig)))
    assert np.all(np.abs(td.w(t(sig)).numpy() - w_j) <= 1e-7 * np.abs(w_j))


@pytest.mark.parametrize("frames,b", [(1, 2), (3, 1), (2, 3)])
def test_linear_prediction_guider_matches_jax(frames, b):
    rng = np.random.default_rng(frames)
    n = frames * b
    x = rng.normal(size=(n, 4, 4, 4)).astype(np.float32)
    s = rng.uniform(1, 10, size=(n,)).astype(np.float32)
    c = {"crossattn": rng.normal(size=(n, 5, 8)).astype(np.float32),
         "vector": rng.normal(size=(n, 6)).astype(np.float32), "other": np.float32(2.0)}
    uc = {k: rng.normal(size=np.shape(v)).astype(np.float32) for k, v in c.items()}
    jg = jguiders.linear_prediction_guider(max_scale=7.5, num_frames=frames, min_scale=1.5)
    tg = tguiders.linear_prediction_guider(max_scale=7.5, num_frames=frames, min_scale=1.5)
    jx, js, jc = jg.prepare(jnp.asarray(x), jnp.asarray(s), jax.tree.map(jnp.asarray, c),
                            jax.tree.map(jnp.asarray, uc))
    tx, ts, tc = tg.prepare(t(x), t(s), {k: t(v) for k, v in c.items()},
                            {k: t(v) for k, v in uc.items()})
    assert max_err(tx, jx) == 0 and max_err(ts, js) == 0
    for k in c:
        assert max_err(tc[k], jc[k]) == 0, k
    d = rng.normal(size=(2 * n, 4, 4, 4)).astype(np.float32)
    assert _rel(tg.combine(t(d), t(s)), jg.combine(jnp.asarray(d), jnp.asarray(s)), 1e-6)
    assert tg.num_copies == jg.num_copies == 2
