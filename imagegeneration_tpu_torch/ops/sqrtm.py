"""Matrix square root for FID: Newton–Schulz on the card, the exact
low-rank cross term and scipy on the host.

The counterpart of imagegeneration_tpu/ops/sqrtm.py. The reference takes
`scipy.linalg.sqrtm(cov_fake @ cov_real)` on the host
(sndcgan/generator_evaluation.py:49). Three ways to get the FID cross term
tr(sqrtm(cov_a @ cov_b)):

- `trace_sqrtm_product_lowrank`: exact, from the feature matrices, as the
  nuclear norm of the small (n x m) cross matrix; float64 numpy SVD, as in
  the JAX package (the default of the FID evaluator);
- `trace_sqrtm_product(..., "newton_schulz")`: the coupled Newton–Schulz
  iteration, float32 `torch.matmul` on the given device with TF32 off
  (`platform.configure_numerics`), as the JAX package runs it in plain
  `jnp` matmuls outside any Pallas kernel. Only for well-conditioned
  full-rank inputs;
- `trace_sqrtm_product(..., "scipy")`: the reference's host path with
  `covmean.real` (generator_evaluation.py:51-52). scipy is imported there.

The product of two PSD matrices is similar to a PSD matrix, so its spectrum
is non-negative and the normalised iteration converges.
"""

from __future__ import annotations

import numpy as np
import torch

from imagegeneration_tpu_torch.core import platform


def sqrtm_newton_schulz(a: torch.Tensor, num_iters: int = 30) -> torch.Tensor:
    """Square root of a (near-)PSD matrix by the coupled Newton–Schulz
    iteration, in float32 on `a`'s device."""
    a = a.float()
    n = a.shape[0]
    norm = torch.sqrt(torch.sum(a * a)).clamp_min(1e-30)
    y = a / norm
    z = torch.eye(n, dtype=torch.float32, device=a.device)
    eye3 = 3.0 * z
    for _ in range(num_iters):
        t = 0.5 * (eye3 - z @ y)
        y, z = y @ t, t @ z
    return y * torch.sqrt(norm)


def trace_sqrtm_product(
    cov_a: np.ndarray, cov_b: np.ndarray, method: str = "newton_schulz",
    device: torch.device | None = None,
) -> float:
    """tr(sqrtm(cov_a @ cov_b)) from full covariances. newton_schulz runs on
    `device` (None: the CUDA card, which must exist)."""
    if method == "scipy":
        from scipy.linalg import sqrtm

        covmean = sqrtm(np.dot(cov_a, cov_b))
        if np.iscomplexobj(covmean):
            covmean = covmean.real
        return float(np.trace(covmean))
    if method != "newton_schulz":
        raise ValueError(f"unknown sqrtm method {method!r}")
    device = platform.require_cuda() if device is None else device
    platform.configure_numerics()
    a = torch.as_tensor(np.asarray(cov_a, np.float32), device=device)
    b = torch.as_tensor(np.asarray(cov_b, np.float32), device=device)
    return float(torch.trace(sqrtm_newton_schulz(a @ b)))


def trace_sqrtm_product_lowrank(feats_a: np.ndarray, feats_b: np.ndarray) -> float:
    """Exact tr(sqrtm(cov_a @ cov_b)) from the feature matrices.

    With X = centred(feats_a) / sqrt(n - 1) (n x d) and Y likewise (m x d),
    cov_a @ cov_b = X^T X Y^T Y, whose nonzero spectrum is that of
    M M^T for M = X Y^T (n x m): the trace of its square root is the sum
    of M's singular values. Exact at any rank, and O(n m d) instead of
    O(d^3)."""
    a = np.asarray(feats_a, np.float64)
    b = np.asarray(feats_b, np.float64)
    x = (a - a.mean(axis=0)) / np.sqrt(max(a.shape[0] - 1, 1))
    y = (b - b.mean(axis=0)) / np.sqrt(max(b.shape[0] - 1, 1))
    return float(np.linalg.svd(x @ y.T, compute_uv=False).sum())
