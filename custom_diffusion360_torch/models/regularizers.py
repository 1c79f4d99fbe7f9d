"""Autoencoder latent regularizers (port of custom_diffusion360_tpu/models/
regularizers.py): KL (diagonal Gaussian), identity, and the
vector-quantization family, as functions over dicts of tensors.

As in the JAX package: activations are channels-last ``(..., C)``; the EMA
quantizer's codebook statistics are state that ``ema_vq_apply`` returns
anew. Randomness enters as named draws (``draws.Draws``), so a test can
hand both packages the same numbers: "vae_eps" (the posterior's standard
normal, the mean's shape), "gumbel" (standard Gumbel noise, the logits'
shape) and "remap_idx" (uniform ints in [0, len(used)), the remapped index
shape).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .nn import Init, conv2d, conv2d_init, linear, linear_init
from .vae import diagonal_gaussian_sample

# ---------------------------------------------------------------------------
# non-quantizing regularizers
# ---------------------------------------------------------------------------


def diagonal_gaussian_regularizer(z, draws=None, sample=True):
    """z: (..., 2C) moments -> (z_out (..., C), {"kl_loss"}): the posterior
    sample with the draw "vae_eps" (the mean when ``sample`` is False) and
    the KL against N(0, I), summed per sample in f32 and averaged over the
    batch; logvar clamped to [-30, 20]."""
    mean, logvar = z.chunk(2, dim=-1)
    if sample:
        if draws is None:
            raise ValueError("sampling the posterior requires draws")
        z_out = diagonal_gaussian_sample(z, draws.normal("vae_eps", tuple(mean.shape), z.device))
    else:
        z_out = mean
    logvar = logvar.clamp(-30.0, 20.0)
    kl = 0.5 * (mean.float() ** 2 + torch.exp(logvar).float() - 1.0 - logvar.float())
    return z_out, {"kl_loss": kl.reshape(z.shape[0], -1).sum(-1).mean()}


def identity_regularizer(z):
    return z, {}


def measure_perplexity(indices, num_centroids: int):
    """(perplexity, clusters in use) of codebook assignments."""
    counts = torch.bincount(indices.reshape(-1), minlength=num_centroids)
    avg_probs = counts.float() / indices.numel()
    perplexity = torch.exp(-(avg_probs * torch.log(avg_probs + 1e-10)).sum())
    return perplexity, (avg_probs > 0).sum()


# ---------------------------------------------------------------------------
# index remapping for restricted codebooks
# ---------------------------------------------------------------------------


def remap_to_used(indices, used, unknown_index="random", draws=None):
    """Raw codebook ids -> positions in ``used``. Ids not in ``used`` map to
    ``unknown_index``: an int, or "random" for the draw "remap_idx"."""
    match = indices[..., None] == used
    new = match.int().argmax(-1)
    unknown = ~match.any(-1)
    if unknown_index == "random":
        if draws is None:
            raise ValueError('unknown_index="random" requires draws')
        n = used.shape[0]
        rand = draws.take("remap_idx", tuple(new.shape), new.device,
                          lambda s, g, d: torch.randint(0, n, s, generator=g, device=d))
        return torch.where(unknown, rand.to(new.dtype), new)
    return torch.where(unknown, torch.full_like(new, int(unknown_index)), new)


def unmap_to_all(indices, used):
    """Inverse of remap_to_used; out-of-range entries collapse to used[0]."""
    indices = torch.where(indices >= used.shape[0], torch.zeros_like(indices), indices)
    return used[indices.long()]


# ---------------------------------------------------------------------------
# VectorQuantizer
# ---------------------------------------------------------------------------


def vq_init(init: Init, n_e: int, e_dim: int):
    """Uniform(-1/n_e, 1/n_e) codebook."""
    return {"embedding": init.uniform((n_e, e_dim), 1.0 / n_e)}


def _nearest_code(z_flat, emb):
    """argmin_j ||z - e_j||^2 by the expanded form."""
    d = (z_flat ** 2).sum(1, keepdim=True) + (emb ** 2).sum(1) - 2.0 * (z_flat @ emb.t())
    return d.argmin(1)


def vq_apply(params, z, beta=0.25, used=None, unknown_index="random", draws=None,
             sane_index_shape=False, log_perplexity=False):
    """z: (..., e_dim) -> (z_q, loss_dict): the straight-through estimator
    and the commitment loss beta ||sg[z_q] - z||^2 + ||z_q - sg[z]||^2 in
    f32. loss_dict: "loss/vq", "min_encoding_indices", and with
    ``log_perplexity`` "perplexity" and "cluster_usage"."""
    emb = params["embedding"]
    z_flat = z.reshape(-1, emb.shape[1]).float()
    idx = _nearest_code(z_flat, emb)
    z_q = emb[idx].reshape(z.shape).to(z.dtype)

    loss_dict = {}
    if log_perplexity:
        perplexity, cluster_use = measure_perplexity(idx, emb.shape[0])
        loss_dict.update({"perplexity": perplexity, "cluster_usage": cluster_use})
    zf, zqf = z.float(), z_q.float()
    loss_dict["loss/vq"] = (beta * ((zqf.detach() - zf) ** 2).mean()
                            + ((zqf - zf.detach()) ** 2).mean())
    z_q = z + (z_q - z).detach()

    if used is not None:
        idx = remap_to_used(idx.reshape(z.shape[0], -1), used, unknown_index,
                            draws).reshape(-1)
    if sane_index_shape:
        idx = idx.reshape(z.shape[:-1])
    loss_dict["min_encoding_indices"] = idx
    return z_q, loss_dict


def vq_codebook_entry(params, indices, shape=None, used=None):
    """Codebook rows of ``indices``, reshaped to the channels-last ``shape``
    when given."""
    if used is not None:
        indices = unmap_to_all(indices, used)
    z_q = params["embedding"][indices.reshape(-1).long()]
    return z_q if shape is None else z_q.reshape(shape)


# ---------------------------------------------------------------------------
# GumbelQuantizer
# ---------------------------------------------------------------------------


def gumbel_vq_init(init: Init, num_hiddens: int, embedding_dim: int, n_embed: int):
    """1x1 conv projection to logits and a N(0, 1) codebook."""
    return {"proj": conv2d_init(init, num_hiddens, n_embed, kernel=1),
            "embedding": init.normal((n_embed, embedding_dim), 1.0)}


def _gumbel(shape, gen, device):
    u = torch.rand(shape, generator=gen, device=device).clamp_min(torch.finfo(torch.float32).tiny)
    return -torch.log(-torch.log(u))


def gumbel_vq_apply(params, z, draws=None, temp=1.0, hard=True, kl_weight=5e-4,
                    return_logits=False):
    """z: NHWC -> (z_q (N, H, W, e_dim), out_dict): Gumbel-softmax
    quantization with the draw "gumbel", straight-through one-hot when
    ``hard``; out_dict "loss/vq" (the KL to uniform times kl_weight),
    "indices", and "logits" when asked."""
    if draws is None:
        raise ValueError("gumbel sampling requires draws")
    logits = conv2d(params["proj"], z)
    noise = draws.take("gumbel", tuple(logits.shape), logits.device, _gumbel).float()
    y_soft = torch.softmax((logits.float() + noise) / temp, dim=-1)
    idx = y_soft.argmax(-1)
    if hard:
        y_hard = F.one_hot(idx, logits.shape[-1]).to(y_soft.dtype)
        one_hot = y_hard + y_soft - y_soft.detach()
    else:
        one_hot = y_soft
    z_q = one_hot @ params["embedding"]

    qy = torch.softmax(logits.float(), dim=-1)
    n_embed = logits.shape[-1]
    diff = kl_weight * (qy * torch.log(qy * n_embed + 1e-10)).sum(-1).mean()
    out = {"loss/vq": diff, "indices": idx}
    if return_logits:
        out["logits"] = logits
    return z_q.to(z.dtype), out


def gumbel_vq_codebook_entry(params, indices):
    """indices (...,) -> (..., e_dim)."""
    return params["embedding"][indices.long()]


# ---------------------------------------------------------------------------
# EMAVectorQuantizer
# ---------------------------------------------------------------------------


def ema_vq_init(init: Init, n_embed: int, embedding_dim: int):
    """Codebook and its EMA statistics as state."""
    weight = init.normal((n_embed, embedding_dim), 1.0)
    return {"weight": weight, "cluster_size": init.zeros((n_embed,)), "embed_avg": weight}


def ema_vq_apply(state, z, beta, decay=0.99, eps=1e-5, update=True):
    """z: (..., e_dim) -> (z_q, out_dict, new_state). The codebook tracks
    an exponential moving average of the assigned vectors (cluster-size EMA
    and a Laplace-smoothed mean); ``update=False`` returns ``state`` as it
    is."""
    weight = state["weight"]
    z_flat = z.reshape(-1, weight.shape[1]).float()
    idx = _nearest_code(z_flat, weight)
    z_q = weight[idx].reshape(z.shape).to(z.dtype)
    encodings = F.one_hot(idx, weight.shape[0]).float()
    avg_probs = encodings.mean(0)
    perplexity = torch.exp(-(avg_probs * torch.log(avg_probs + 1e-10)).sum())

    if update:
        cluster_size = state["cluster_size"] * decay + encodings.sum(0) * (1.0 - decay)
        embed_avg = state["embed_avg"] * decay + (encodings.t() @ z_flat) * (1.0 - decay)
        n = cluster_size.sum()
        smoothed = (cluster_size + eps) / (n + weight.shape[0] * eps) * n
        new_state = {"cluster_size": cluster_size, "embed_avg": embed_avg,
                     "weight": embed_avg / smoothed[:, None]}
    else:
        new_state = state

    loss = beta * ((z_q.float().detach() - z.float()) ** 2).mean()
    z_q = z + (z_q - z).detach()
    out = {"loss/vq": loss, "encodings": encodings, "encoding_indices": idx,
           "perplexity": perplexity}
    return z_q, out, new_state


# ---------------------------------------------------------------------------
# VectorQuantizerWithInputProjection
# ---------------------------------------------------------------------------


def vq_proj_init(init: Init, input_dim: int, n_codes: int, codebook_dim: int,
                 output_dim=None):
    p = {"vq": vq_init(init, n_codes, codebook_dim),
         "proj_in": linear_init(init, input_dim, codebook_dim)}
    if output_dim is not None:
        p["proj_out"] = linear_init(init, codebook_dim, output_dim)
    return p


def vq_proj_apply(params, z, beta=1.0, **kwargs):
    """z: (..., input_dim) -> (z_q (..., out_dim), loss_dict)."""
    z_q, loss_dict = vq_apply(params["vq"], linear(params["proj_in"], z), beta=beta, **kwargs)
    if "proj_out" in params:
        z_q = linear(params["proj_out"], z_q)
    return z_q, loss_dict
