"""Frechet Inception Distance statistics and distance computation (port
of custom_diffusion360_tpu/eval/fid.py: the same numpy code, on the host, in
float64).

FID(x, y) = |mu_x - mu_y|^2 + tr(Sx + Sy - 2 (Sx Sy)^{1/2}) over
InceptionV3 pool3 features (Heusel et al. 2017; the reference wraps
pytorch_fid's extractor, sgm/modules/encoders/modules.py:233-250, and ships
no FID computation of its own).

The matrix square root uses a symmetrized eigendecomposition: with
A = Sx^{1/2} Sy Sx^{1/2} (symmetric PSD), tr((Sx Sy)^{1/2}) = tr(A^{1/2}),
avoiding scipy.linalg.sqrtm's complex drift on near-singular products.
Feature statistics accumulate in a streaming (sum, outer-product sum)
form so arbitrarily many batches fold in O(d^2) memory.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class FeatureStats:
    """Streaming mean/covariance accumulator for (N, D) feature batches."""

    n: int = 0
    s1: np.ndarray | None = None  # (D,) sum
    s2: np.ndarray | None = None  # (D, D) sum of outer products

    def update(self, feats):
        feats = np.asarray(feats, np.float64)
        if feats.ndim != 2:
            raise ValueError(f"features must be (N, D), got shape {feats.shape}")
        if self.s1 is None:
            self.s1 = np.zeros(feats.shape[1])
            self.s2 = np.zeros((feats.shape[1], feats.shape[1]))
        self.n += feats.shape[0]
        self.s1 += feats.sum(0)
        self.s2 += feats.T @ feats
        return self

    @property
    def mean(self):
        return self.s1 / self.n

    @property
    def cov(self):
        """Unbiased covariance (ddof=1, matching np.cov / pytorch_fid)."""
        if self.n < 2:
            raise ValueError(
                f"covariance needs at least 2 samples, got {self.n}"
            )
        mu = self.mean
        return (self.s2 - self.n * np.outer(mu, mu)) / (self.n - 1)


def _sqrtm_psd(a):
    """Symmetric PSD matrix square root via eigendecomposition (negative
    eigenvalues from roundoff clip to zero; no diagonal loading, which
    would bias the trace by ~d*sqrt(eps) at d=2048)."""
    vals, vecs = np.linalg.eigh(a)
    return (vecs * np.sqrt(np.clip(vals, 0.0, None))) @ vecs.T


def frechet_distance(mu1, cov1, mu2, cov2):
    """FID between two Gaussians, numerically robust for rank-deficient
    covariances (small sample counts)."""
    mu1 = np.asarray(mu1, np.float64)
    mu2 = np.asarray(mu2, np.float64)
    cov1 = np.asarray(cov1, np.float64)
    cov2 = np.asarray(cov2, np.float64)
    diff = mu1 - mu2
    s1h = _sqrtm_psd(cov1)
    inner = _sqrtm_psd(s1h @ cov2 @ s1h)
    return float(
        diff @ diff + np.trace(cov1) + np.trace(cov2) - 2.0 * np.trace(inner)
    )


def fid_from_stats(stats1: FeatureStats, stats2: FeatureStats):
    return frechet_distance(stats1.mean, stats1.cov, stats2.mean, stats2.cov)
