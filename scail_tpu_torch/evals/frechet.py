"""Frechet distance math shared by FVD and FID (the port's own copy of
scail_tpu/evals/frechet.py, numpy and scipy; reference: eval/fvd/videogpt/
fvd.py, eval/eval_fid.py -- EDM-style stats).

d^2 = |mu1 - mu2|^2 + Tr(C1 + C2 - 2 sqrt(C1 C2))
"""

from __future__ import annotations

import numpy as np


def feature_stats(features: np.ndarray):
    """features: (N, D) -> (mu, cov).  N == 1 yields the zero covariance
    (np.cov's ddof NaN would poison the distance; with cov = 0 the
    Frechet distance degrades gracefully to |mu1 - mu2|^2, which is what
    single-clip smoke runs report)."""
    feats = np.asarray(features, np.float64)
    mu = feats.mean(axis=0)
    if feats.shape[0] < 2:
        cov = np.zeros((feats.shape[1], feats.shape[1]))
    else:
        cov = np.cov(feats, rowvar=False)
    return mu, cov


def _sqrtm(x):
    """scipy.linalg.sqrtm across versions: disp is deprecated (1.18
    removes it) and the (sqrtm, errest) tuple return goes with it."""
    from scipy import linalg

    try:
        out = linalg.sqrtm(x, disp=False)
    except TypeError:  # pragma: no cover - post-removal scipy
        out = linalg.sqrtm(x)
    return out[0] if isinstance(out, tuple) else out


def frechet_distance(mu1, cov1, mu2, cov2, eps: float = 1e-6) -> float:
    mu1, mu2 = np.atleast_1d(mu1), np.atleast_1d(mu2)
    cov1, cov2 = np.atleast_2d(cov1), np.atleast_2d(cov2)
    diff = mu1 - mu2
    covmean = _sqrtm(cov1.dot(cov2))
    if not np.isfinite(covmean).all():
        offset = np.eye(cov1.shape[0]) * eps
        covmean = _sqrtm((cov1 + offset).dot(cov2 + offset))
    if np.iscomplexobj(covmean):
        covmean = covmean.real
    return float(diff.dot(diff) + np.trace(cov1) + np.trace(cov2)
                 - 2.0 * np.trace(covmean))


def frechet_from_features(feats1: np.ndarray, feats2: np.ndarray) -> float:
    mu1, c1 = feature_stats(feats1)
    mu2, c2 = feature_stats(feats2)
    return frechet_distance(mu1, c1, mu2, c2)
