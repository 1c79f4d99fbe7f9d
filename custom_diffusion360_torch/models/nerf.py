"""FeatureNeRF pose blocks (port of custom_diffusion360_tpu/models/nerf.py):
ray-march the target camera, sample the reference-view feature maps at the
projected ray points, predict density and features with small MLPs; the
caller volume-renders.

The renders run the split/commuted encoding (``nerf_encoding_split``; see
the JAX module for the algebra of its first four rewrites). A fifth is the
port's own: everything after the SiLU is linear and the view weights sum to
one, so the feature pass pools the views before the C x C ``l2`` product
instead of after it, and ``l2`` runs on a 1/N share of the rows.
``nerf_encoding_apply`` is the unsplit form it is held to, which samples
the reference maps themselves (through the bilinear kernel on CUDA). The
reference tokens are either delta-buffer ``CompactRefTokens`` (sampling) or
dense (B, N, hw, C) tokens from the live reference stream (training), which
take a per-row ``mask_ref``. Inside ``view_sharded(group)`` the render is
split over the reference views (``Engine.sample(view_group=)``, the JAX
package's ``ref_sharding``): each rank holds its own views' tokens and
cameras, and every reduction over the view axis (the view softmax, the
attention-weighted pool and density, the ``average`` means) ends in an
all-reduce over the group. Training adds the stochastic branches
(stratified patch rays and lengths, the importance jitter and the
stratified-vs-importance coin), each draw named in a ``draws.Draws``, and
rematerializes each ray chunk on backward (torch.utils.checkpoint, as
``jax.checkpoint`` in the JAX scan).
"""
from __future__ import annotations

import contextlib
import dataclasses
import math

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..geometry.cameras import Cameras, transform_points_ndc
from ..geometry.rays import (
    get_patch_rays,
    pe_freqs,
    plucker_parameterization,
    points_to_view_space,
    positional_encoding,
    ray_points_from_rays,
    rays_to_target_space,
    rays_to_view_space,
)
from ..ops.image_resize import resize_images
from ..ops.onehot_sample import bilinear_sample
from ..ops.sample_pdf import sample_pdf
from ..utils.trace import span
from .nn import Init, linear, linear_init, nearest_resize_tokens, silu, torch_dtype

# the process group of the view-sharded render running inside
# ``view_sharded``: set and restored by that context manager alone, so the
# UNet's layers need no group argument (as parallel/tp.py's model group)
_VIEW_GROUP = None

# the sampled map channels [l1 plane rows | nviews row] are padded to this
# multiple so each channel row is 16-byte aligned for the bilinear kernel's
# vector loads (C + 1 is odd at every SDXL width)
CHANNEL_ALIGN = 8


@dataclasses.dataclass(frozen=True)
class NerfConfig:
    dim: int
    num_samples: int = 24
    far_plane: float = 2.0
    near_plane: float = 0.0
    num_freqs: int = 16
    rgb_predict: bool = True
    average: bool = False
    stratified: bool = True
    imp_sampling_percent: float = 0.9
    chunk_size: int = 512
    chunk_rows_ref: int = 2
    compute_dtype: str = "float32"

    @property
    def cdtype(self):
        return torch_dtype(self.compute_dtype)

    @property
    def total_far(self) -> float:
        # reference quirk: the Raymarcher spans [near, near + (near + far)]
        return self.near_plane + (self.near_plane + self.far_plane)

    @property
    def geom_feat_dim(self) -> int:
        return self.num_freqs * 3 * 4 + 6


def init_nerf_params(init: Init, cfg: NerfConfig):
    in_dim = cfg.dim + cfg.geom_feat_dim
    p = {
        "plane_coefs": {
            "l1": linear_init(init, in_dim, cfg.dim),
            "l2": linear_init(init, cfg.dim, cfg.dim),
        },
        "decoder": linear_init(
            init, cfg.dim, 1 + (3 if cfg.rgb_predict else 0), bias=False, zero=True
        ),
    }
    if not cfg.average:
        p["nviews"] = linear_init(init, in_dim, 1)
    return p


# ---------------------------------------------------------------------------
# ray marcher
# ---------------------------------------------------------------------------


def _length_edges(cfg: NerfConfig, device):
    return torch.linspace(cfg.near_plane, cfg.total_far, cfg.num_samples + 1,
                          dtype=torch.float32, device=device)


def _stratified_lengths(cfg: NerfConfig, batch, num_rays, device, draws):
    """(lengths, dists) (B, hw, S): bin centers jittered by the (B, hw,
    S + 1) uniforms ``strat``."""
    edges = _length_edges(cfg, device)
    center = (edges[1:] + edges[:-1]) / 2.0
    upper = torch.cat([center, edges[-1:]])
    lower = torch.cat([edges[:1], center])
    t = draws.uniform("strat", (batch, num_rays, cfg.num_samples + 1), device)
    jittered = lower + (upper - lower) * t
    return (jittered[..., :-1] + jittered[..., 1:]) / 2.0, jittered[..., 1:] - jittered[..., :-1]


def _uniform_lengths(cfg: NerfConfig, batch, num_rays, device):
    edges = _length_edges(cfg, device)
    centers = (edges[1:] + edges[:-1]) / 2.0
    dists = edges[1:] - edges[:-1]
    shape = (batch, num_rays, cfg.num_samples)
    return centers.expand(shape), dists.expand(shape)


def _importance_lengths(cfg: NerfConfig, prev_weights, num_rays, draws=None):
    """Inverse-CDF depths from the previous block's uniform render weights
    prev_weights (B, hw_prev, S, 1); resized (antialiased bilinear) when the
    previous block ran at another resolution. With ``draws`` the quantiles
    are jittered inside their 1/S bins by the (B, hw, S) uniforms ``imp``."""
    s = cfg.num_samples
    cdf = prev_weights[..., 0] + 0.01
    b, hw_prev = cdf.shape[:2]
    if hw_prev != num_rays:
        src, dst = math.isqrt(hw_prev), math.isqrt(num_rays)
        cdf = resize_images(cdf.reshape(b, src, src, s), dst, "linear").reshape(b, num_rays, s)

    cdf_sum = cdf.sum(-1, keepdim=True)
    padding = F.relu(1e-5 - cdf_sum)
    cdf = cdf + padding / s
    pdf = cdf / (cdf_sum + padding)

    edges = _length_edges(cfg, cdf.device).expand(b, num_rays, s + 1)
    u = (torch.arange(s, dtype=torch.float32, device=cdf.device) * (1.0 / s)).expand(b, num_rays, s)
    if draws is not None:
        u = u + draws.uniform("imp", (b, num_rays, s), cdf.device) * (1.0 / s)
    depths = sample_pdf(edges, pdf, u)
    dists = torch.cat(
        [depths[..., 1:] - depths[..., :-1], edges[..., -1:] - depths[..., -1:]], dim=-1
    )
    return depths, dists


def raymarch(cams: Cameras, resolution: int, cfg: NerfConfig, prev_weights=None,
             imp_sample_next_step: bool = False, draws=None):
    """Target rays and sample points. cams: (B, N+1), camera 0 the target.
    ``draws`` (training) draws the coin that takes stratified lengths
    instead of importance ones with probability 1 - imp_sampling_percent,
    and with cfg.stratified also jitters the patch rays and the lengths.
    With a previous block's weights both length sets are computed and the
    coin selects between them on the device, so the draws are taken in one
    order whatever the coin: ray_x, ray_y, coin, strat, imp.
    Returns dict(rays (B, N+1, hw, 6), ray_points (B, hw, S, 3), dists
    (B, hw, S), ray_points_uniform, dists_uniform (or None)), all without
    gradient."""
    jitter = draws if cfg.stratified else None
    rays, _ = get_patch_rays(cams, resolution, draws=jitter)
    b = rays.shape[0]
    num_rays = resolution * resolution
    dev = rays.device

    def stratified():
        if jitter is None:
            return _uniform_lengths(cfg, b, num_rays, dev)
        return _stratified_lengths(cfg, b, num_rays, dev, jitter)

    if prev_weights is None or cfg.imp_sampling_percent <= 0:
        lengths, dists = stratified()
    elif draws is not None:
        # both length sets, selected on the device by the coin (as the JAX
        # package's jnp.where): no host read, and the draws' order is fixed
        take_strat = draws.uniform("coin", (), dev) < 1.0 - cfg.imp_sampling_percent
        strat_lengths, strat_dists = stratified()
        imp_lengths, imp_dists = _importance_lengths(cfg, prev_weights, num_rays, jitter)
        lengths = torch.where(take_strat, strat_lengths, imp_lengths)
        dists = torch.where(take_strat, strat_dists, imp_dists)
    else:
        lengths, dists = _importance_lengths(cfg, prev_weights, num_rays, jitter)
    target_rays = rays[:, 0]
    ray_points = ray_points_from_rays(target_rays, lengths)
    ray_points_uniform = dists_uniform = None
    if imp_sample_next_step:
        lengths_u, dists_uniform = _uniform_lengths(cfg, b, num_rays, dev)
        ray_points_uniform = ray_points_from_rays(target_rays, lengths_u)
    return dict(rays=rays.detach(), ray_points=ray_points.detach(), dists=dists.detach(),
                ray_points_uniform=ray_points_uniform, dists_uniform=dists_uniform)


# ---------------------------------------------------------------------------
# encoding
# ---------------------------------------------------------------------------


class CompactRefTokens:
    """Delta-buffer reference tokens in compact form: one zero-image plane
    ``zero`` (hw, C) and the chosen views ``chosen`` (n, hw, C); the
    (batch x CFG copies) expansion is deferred to ``project_ref_maps``, so
    only the projected maps are ever expanded. Expanded row layout:
    [zero rows x batch | chosen rows x batch x (copies - 1)].

    ``shared_cams``: the caller's declaration that every CFG copy carries
    the same target camera rows (``Engine.sample(shared_target_cams=)``),
    which licenses the x3 render dedupe (transformer._reference_attn).
    ``rows`` (lo, hi): only the expanded rows lo..hi-1 (a rank's share of
    the CFG rows under ``Engine.sample(cfg_group=)``). ``views`` (lo, hi):
    only the chosen views lo..hi-1 (a rank's share of the views under
    ``Engine.sample(view_group=)``); the zero plane is broadcast over the
    local count, and ``shape`` reports it."""

    def __init__(self, zero, chosen, batch: int, copies: int, shared_cams: bool = False,
                 rows=None, views=None):
        self.views = None if views is None else (int(views[0]), int(views[1]))
        self.zero = zero
        self.chosen = chosen if views is None else chosen[self.views[0]:self.views[1]]
        self.batch = int(batch)
        self.copies = int(copies)
        self.shared_cams = bool(shared_cams)
        self.rows = None if rows is None else (int(rows[0]), int(rows[1]))

    @property
    def shape(self):
        n = self.batch * self.copies if self.rows is None else self.rows[1] - self.rows[0]
        return (n, self.chosen.shape[0]) + tuple(self.chosen.shape[1:])

    def expand_rows(self, zero_rows, chosen_rows):
        b, k = self.batch, self.copies
        if k == 1:
            out = chosen_rows[None].expand((b,) + tuple(chosen_rows.shape))
        else:
            z = zero_rows[None].expand((b,) + tuple(zero_rows.shape))
            s = chosen_rows[None].expand(((k - 1) * b,) + tuple(chosen_rows.shape))
            out = torch.cat([z, s], dim=0)
        return out if self.rows is None else out[self.rows[0]:self.rows[1]]


@contextlib.contextmanager
def view_sharded(group):
    """Split the renders inside over the reference views: this rank holds
    its own views' tokens and cameras (target first), and every reduction
    over the view axis all-reduces over ``group``. Every rank of the group
    must run the same renders, in the same order, with the same ray
    chunks. The reductions are not differentiable: a render inside with
    autograd on raises."""
    global _VIEW_GROUP
    prev, _VIEW_GROUP = _VIEW_GROUP, group
    try:
        yield
    finally:
        _VIEW_GROUP = prev


def view_group():
    """The active view group; None outside ``view_sharded``."""
    return _VIEW_GROUP


def _view_reduce(x, op="sum"):
    """``x`` reduced over the view group in place (sum or max); the
    identity outside ``view_sharded``."""
    if _VIEW_GROUP is None:
        return x
    if torch.is_grad_enabled():
        raise RuntimeError("the view-sharded render's all-reduce is not differentiable; "
                           "render under torch.no_grad or torch.inference_mode")
    dist.all_reduce(x, op=dist.ReduceOp.MAX if op == "max" else dist.ReduceOp.SUM,
                    group=_VIEW_GROUP)
    return x


def _view_softmax(logits):
    """Softmax over the view axis 1 of f32 ``logits`` (B, N, hw, S), the
    views split over the view group: the global max, then the global sum
    of the exponentials."""
    if _VIEW_GROUP is None:
        return torch.softmax(logits, dim=1)
    e = torch.exp(logits - _view_reduce(logits.amax(1, keepdim=True), "max"))
    return e / _view_reduce(e.sum(1, keepdim=True))


def _view_mean(x):
    """Mean over the view axis 1 in f32, over every rank's views."""
    if _VIEW_GROUP is None:
        return x.float().mean(1)
    return _view_reduce(x.float().sum(1)) / (x.shape[1] * dist.get_world_size(_VIEW_GROUP))


def apply_ref_mask(xref, mask_ref):
    """Zero the padded regions of dense reference tokens xref (B, N, hw, C)
    by mask_ref (B, N, Hm, Wm), nearest-resized to the token grid."""
    if mask_ref is None:
        return xref
    b, n, hw, _ = xref.shape
    m = mask_ref.reshape(b, n, -1, 1).to(xref.dtype)
    m = nearest_resize_tokens(m, math.isqrt(m.shape[2]), math.isqrt(hw))
    return xref * m


def nerf_encoding_apply(params, cams: Cameras, xref, ray_points, rays, mask_ref,
                        cfg: NerfConfig):
    """Per-point features and density logits, the unsplit form. cams (B, N+1)
    with camera 0 the target; xref (B, N, hw_full, C) reference features on
    a res^2 token grid; ray_points (B, hw, S, 3) target ray points in world
    space (hw may be a chunk of the grid); rays (B, N+1, hw, 6); mask_ref
    (B, N, Hm, Wm) or None. Returns (out (B, hw, S, C + 1 [+3]) f32, attn
    (B, N, hw, S, 1) or None under ``average``)."""
    xref = apply_ref_mask(xref.float(), mask_ref)
    b, n, hw_full, c = xref.shape
    hw, s = ray_points.shape[1], ray_points.shape[-2]
    res = math.isqrt(hw_full)
    nf = cfg.num_freqs

    # project the target ray points into every reference camera; the
    # reference flips the sign, clips and detaches (nerfsd_pytorch3d.py:89-95)
    ndc = transform_points_ndc(cams, ray_points.reshape(b, 1, hw * s, 3))
    grid = torch.nan_to_num(-ndc[:, 1:, :, :2].detach()).clamp(-1.2, 1.2)
    plane = bilinear_sample(xref.reshape(b * n, res, res, c).contiguous(),
                            grid.reshape(b * n, hw * s, 2)).reshape(b, n, hw, s, c)

    pts_view = points_to_view_space(cams, ray_points)  # (B, N+1, hw, S, 3)
    pe_pts_view = positional_encoding(pts_view, nf)
    rays_view = rays_to_view_space(cams, rays[:, 0])[:, 1:]  # (B, N, hw, 6)
    cam_inview = rays_view[:, :, :, None, :].expand(b, n, hw, s, 6)
    pe_cam_inview = positional_encoding(plucker_parameterization(cam_inview), nf // 2)
    mlp_in = torch.cat([plane, pe_pts_view[:, 1:], pts_view[:, 1:], pe_cam_inview,
                        cam_inview[..., 3:]], dim=-1)
    h = linear(params["plane_coefs"]["l2"], silu(linear(params["plane_coefs"]["l1"], mlp_in)))

    if cfg.average:
        pooled, attn = h.mean(1), None
    else:
        # per-view softmax pooling (nerfsd_pytorch3d.py:138-155)
        cam_target = rays_to_target_space(cams, rays[:, 1:])[..., :3]
        cam_target = cam_target[:, :, :, None, :].expand(b, n, hw, s, 3)
        attn_in = torch.cat([
            plane, pe_pts_view[:, :1].expand(b, n, hw, s, pe_pts_view.shape[-1]),
            pts_view[:, :1].expand(b, n, hw, s, 3), cam_target,
            positional_encoding(cam_target, nf)], dim=-1)
        attn = torch.softmax(linear(params["nviews"], attn_in), dim=1)
        pooled = (h * attn).sum(1)
    return torch.cat([pooled, linear(params["decoder"], pooled)], dim=-1), attn


def _l1_row_splits(cfg: NerfConfig):
    """l1 rows by mlp_in segment: [plane (C), pe_pts_view (6nf), pts_view (3),
    pe_cam_inview (6nf), cam_inview_dir (3)]."""
    c, pe = cfg.dim, cfg.num_freqs * 6
    return c, c + pe + 3, c + 2 * pe + 6


def _nviews_row_splits(cfg: NerfConfig):
    """attn_in rows: [plane (C), pe_pts_target (6nf), pts_target (3),
    cam_target (3), pe_cam_target (6nf)]."""
    c, pe = cfg.dim, cfg.num_freqs * 6
    return c, c + pe + 3, c + pe + 6 + pe


def project_ref_maps(params, xref, cfg: NerfConfig, mask_ref=None):
    """Per-block projection of the reference maps by the plane-feature rows
    of l1 and nviews. xref: CompactRefTokens, or dense (B, N, HW, C) tokens
    (masked by ``mask_ref`` first). Returns (B, N, HW, Cp) = [l1-projected
    (C) | nviews-projected (1) | zeros], Cp the C + 1 channels (C without
    nviews) rounded up to CHANNEL_ALIGN; readers slice the first C + 1."""
    cdt = cfg.cdtype
    c = cfg.dim
    width = c + (0 if cfg.average else 1)
    pad = -width % CHANNEL_ALIGN

    def proj(x):
        parts = [x @ params["plane_coefs"]["l1"]["w"][:c].to(cdt)]
        if not cfg.average:
            parts.append(x @ params["nviews"]["w"][:c].to(cdt))
        if pad:
            parts.append(x.new_zeros(tuple(x.shape[:-1]) + (pad,)))
        return torch.cat(parts, dim=-1)

    if not isinstance(xref, CompactRefTokens):
        return proj(apply_ref_mask(xref.float(), mask_ref).to(cdt))
    if mask_ref is not None:
        raise ValueError("mask_ref needs dense reference tokens")
    n = xref.chosen.shape[0]
    g_chosen = proj(xref.chosen.float().to(cdt))
    g_zero = proj(xref.zero.float().to(cdt))
    zero_rows = g_zero[None].expand((n,) + tuple(g_zero.shape))
    return xref.expand_rows(zero_rows, g_chosen).contiguous()


def ray_shared_terms(params, cams: Cameras, rays, cfg: NerfConfig):
    """Sample-axis-invariant contractions, once per ray. rays: (B, N+1, hw, 6).
    Returns (geo_ray (B, N, hw, C), logit_ray (B, N, hw, 1) or None)."""
    cdt = cfg.cdtype
    nf = cfg.num_freqs
    _, s1, _ = _l1_row_splits(cfg)
    rays_view = rays_to_view_space(cams, rays[:, 0])[:, 1:]
    ray_feat = torch.cat(
        [positional_encoding(plucker_parameterization(rays_view), nf // 2),
         rays_view[..., 3:]], dim=-1,
    ).to(cdt)
    l1 = params["plane_coefs"]["l1"]
    geo_ray = ray_feat @ l1["w"][s1:].to(cdt)
    if "b" in l1:
        geo_ray = geo_ray + l1["b"].to(cdt)
    logit_ray = None
    if not cfg.average:
        _, v1, _ = _nviews_row_splits(cfg)
        ct = rays_to_target_space(cams, rays[:, 1:])[..., :3]
        att_ray = torch.cat([ct, positional_encoding(ct, nf)], dim=-1).to(cdt)
        nv = params["nviews"]
        logit_ray = att_ray @ nv["w"][v1:].to(cdt)
        if "b" in nv:
            logit_ray = logit_ray + nv["b"].to(cdt)
    return geo_ray, logit_ray


def nerf_encoding_split(params, cams: Cameras, proj, geo_ray, logit_ray,
                        ray_points, cfg: NerfConfig, sigma_only: bool = False):
    """Per-point features + density. proj from project_ref_maps; geo_ray /
    logit_ray from ray_shared_terms sliced to this hw chunk; ray_points
    (B, hw, S, 3). Returns (out (B, hw, S, C+1[+3]) f32, attn (B, N, hw, S, 1))
    or (sigma (B, hw, S, 1) f32, attn) when sigma_only."""
    cdt = cfg.cdtype
    c = cfg.dim
    nf = cfg.num_freqs
    b, n = proj.shape[:2]
    hw, s = ray_points.shape[1], ray_points.shape[2]
    res = math.isqrt(proj.shape[2])
    _, s1, _ = _l1_row_splits(cfg)

    # project the target ray points into every reference camera; the
    # reference flips the sign and clips (nerfsd_pytorch3d.py:89-95)
    ndc = transform_points_ndc(cams, ray_points.reshape(b, 1, hw * s, 3))
    grid = torch.nan_to_num(-ndc[:, 1:, :, :2]).clamp(-1.2, 1.2)
    fm = proj.reshape((b * n, res, res) + tuple(proj.shape[3:]))
    sampled = bilinear_sample(fm, grid.reshape(b * n, hw * s, 2)).reshape(b, n, hw, s, -1)

    # view-space points in coordinate-planes layout (B, N+1, 3, P)
    p_pts = hw * s
    pts_t = ray_points.reshape(b, p_pts, 3).transpose(1, 2)
    R, T = cams.R, cams.T
    pv = torch.stack(
        [
            pts_t[:, None, 0] * R[..., 0, e][..., None]
            + pts_t[:, None, 1] * R[..., 1, e][..., None]
            + pts_t[:, None, 2] * R[..., 2, e][..., None]
            + T[..., e][..., None]
            for e in range(3)
        ],
        dim=2,
    )
    # PE planes: all sines freq-major, then all cosines
    freqs = pe_freqs(nf, pv.dtype, pv.device)
    scaled = pv[:, :, None, :, :] * freqs[None, None, :, None, None]
    sin = torch.sin(scaled).reshape(b, n + 1, nf * 3, p_pts)
    cos = torch.cos(scaled).reshape(b, n + 1, nf * 3, p_pts)
    pe = torch.cat([sin, cos], dim=2)  # (B, N+1, 6nf, P)

    feat = torch.cat([pe[:, 1:], pv[:, 1:]], dim=2).to(cdt)  # (B, N, F, P)
    l1w = params["plane_coefs"]["l1"]["w"]
    h_geo = (feat.transpose(-1, -2) @ l1w[c:s1].to(cdt)).reshape(b, n, hw, s, c)
    h_pre = sampled[..., :c].to(cdt) + h_geo + geo_ray[..., None, :]
    del h_geo
    h_act = silu(h_pre)
    del h_pre

    attn = None
    if not cfg.average:
        _, v1, _ = _nviews_row_splits(cfg)
        vw = params["nviews"]["w"]
        tgt = torch.cat([pe[:, 0], pv[:, 0]], dim=1).to(cdt)  # (B, F, P)
        logit_pts = (tgt.transpose(1, 2) @ vw[c:v1, 0].to(cdt)).reshape(b, 1, hw, s)
        logits = (sampled[..., c].to(cdt) + logit_pts + logit_ray[..., :1]).float()
        attn = _view_softmax(logits)  # (B, N, hw, S) f32
    del sampled

    attn_out = None if attn is None else attn[..., None]
    if sigma_only:
        # rewrite 4 (the JAX module's): l2, the pool and the decoder's sigma
        # column collapse to one C -> 1 contraction
        l2 = params["plane_coefs"]["l2"]
        wd = params["decoder"]["w"]
        w2d = (l2["w"] @ wd)[:, -1]
        h_sig = h_act @ w2d.to(cdt)  # (B, N, hw, S)
        if attn is None:
            sigma = _view_mean(h_sig)
        else:
            sigma = _view_reduce((h_sig * attn.to(cdt)).sum(1, dtype=torch.float32))
        if "b" in l2:
            sigma = sigma + (l2["b"] @ wd)[-1]
        return sigma[..., None], attn_out

    # rewrite 5: pool the views before l2, as rewrite 4 does for sigma:
    # sum_n attn_n (h_act_n W2 + b2) = (sum_n attn_n h_act_n) W2 + b2, since
    # the softmax's weights sum to 1 (and the mean's), so l2 runs once on
    # B hw S rows instead of B N hw S, and adds its bias once
    if attn is None:
        pooled_act = _view_mean(h_act)
    else:
        pooled_act = _view_reduce((h_act * attn[..., None].to(cdt)).sum(1, dtype=torch.float32))
    del h_act
    pooled = linear(params["plane_coefs"]["l2"], pooled_act.to(cdt)).float()
    out = linear(params["decoder"], pooled)  # f32 (density feeds trunc_exp)
    return torch.cat([pooled, out], dim=-1), attn_out


def effective_chunk(chunk: int, rows: int, chunk_rows_ref: int, hw: int) -> int:
    """Batch-scaled ray-chunk size, rounded down to a power of two; more rows
    than chunk_rows_ref scale it down quadratically (floor 128)."""
    if not chunk:
        return 0
    if chunk_rows_ref and rows > chunk_rows_ref:
        chunk = max(128, chunk * chunk_rows_ref**2 // rows**2)
    chunk = 1 << (chunk.bit_length() - 1)
    while hw % chunk:
        chunk //= 2
    return chunk


def nerfsd_apply(params, cams: Cameras, xref, cfg: NerfConfig, prev_weights=None,
                 imp_sample_next_step: bool = False, mask_ref=None, draws=None):
    """Ray-march + encode. xref: CompactRefTokens or dense (B, N, hw, C)
    tokens; mask_ref (B, N, Hm, Wm) masks dense tokens; draws: the
    training draws (raymarch). Returns dict(features, sigma, dists, rgb,
    sigma_uniform, dists_uniform), per-point shapes (B, hw, S, *), f32.
    Rays stream through the encoding in chunks of effective_chunk rays;
    with autograd on, each chunk is recomputed on backward instead of
    keeping its activations. The uniform-grid density pass runs without
    gradient."""
    resolution = math.isqrt(xref.shape[2])
    march = raymarch(cams, resolution, cfg, prev_weights=prev_weights,
                     imp_sample_next_step=imp_sample_next_step, draws=draws)
    proj = project_ref_maps(params, xref, cfg, mask_ref)
    geo_ray, logit_ray = ray_shared_terms(params, cams, march["rays"], cfg)

    def run(points, gr, lr, sigma_only):
        with span("cd360.nerf"):  # the f32 island; under checkpoint, its recompute too
            return nerf_encoding_split(params, cams, proj, gr, lr, points, cfg,
                                       sigma_only=sigma_only)[0].float()

    def encode(points, sigma_only=False):
        hw = points.shape[1]
        chunk = effective_chunk(cfg.chunk_size, points.shape[0], cfg.chunk_rows_ref, hw)
        if not chunk or hw <= chunk:
            return run(points, geo_ray, logit_ray, sigma_only)
        outs = []
        for start in range(0, hw, chunk):
            sl = slice(start, start + chunk)
            args = (points[:, sl], geo_ray[:, :, sl],
                    None if logit_ray is None else logit_ray[:, :, sl], sigma_only)
            if torch.is_grad_enabled():
                # no RNG state to keep: the encoding draws nothing (its draws
                # are taken by raymarch, outside the chunks), and stashing the
                # CUDA generator's state could not be captured in a CUDA graph
                outs.append(checkpoint(run, *args, use_reentrant=False,
                                       preserve_rng_state=False))
            else:
                outs.append(run(*args))
        return torch.cat(outs, dim=1)

    out = encode(march["ray_points"])
    sigma = out[..., -1:]
    features = out[..., :-1]
    rgb = None
    if cfg.rgb_predict:
        rgb = features[..., -3:]
        features = features[..., :-3]
    sigma_uniform = dists_uniform = None
    if imp_sample_next_step:
        with torch.no_grad():
            sigma_uniform = encode(march["ray_points_uniform"], sigma_only=True)
        dists_uniform = march["dists_uniform"][..., None]
    return dict(features=features, sigma=sigma, dists=march["dists"][..., None],
                rgb=rgb, sigma_uniform=sigma_uniform, dists_uniform=dists_uniform)
