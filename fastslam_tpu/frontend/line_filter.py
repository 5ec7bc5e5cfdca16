"""Scan smoothing — the reference's ``LineFilter`` rebuilt as a convolution.

The reference applies ``scipy.ndimage.gaussian_filter1d(sigma=0.1)``
independently to the x and y columns of the scan
(``fast_slam_2/algorithms/line_filter.py:12-21``).  Amusingly, with scipy's
radius formula ``int(truncate * sigma + 0.5)`` a sigma of 0.1 gives radius 0 —
the reference's filter is the identity.  We reproduce that formula exactly (so
default config is bit-identical) but implement the general case as a reflect-
padded 1-D correlation, which XLA fuses into neighbouring ops.
"""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp
import numpy as np

from fastslam_tpu.config import FastSLAMConfig


def _gaussian_kernel(sigma: float, truncate: float) -> np.ndarray:
    radius = int(truncate * sigma + 0.5)  # scipy's formula
    if radius <= 0:
        return np.ones((1,), np.float32)
    x = np.arange(-radius, radius + 1, dtype=np.float64)
    k = np.exp(-0.5 * (x / sigma) ** 2)
    return (k / k.sum()).astype(np.float32)


def line_filter(points: jnp.ndarray, config: FastSLAMConfig) -> jnp.ndarray:
    """Smooth ``[N, 2]`` scan points along the beam axis (reflect boundary)."""
    kernel = _gaussian_kernel(config.line_filter_sigma, config.line_filter_truncate)
    if kernel.shape[0] == 1:
        return points
    r = kernel.shape[0] // 2
    # reflect padding as scipy mode='reflect' ((d c b a | a b c d | d c b a))
    top = points[:r][::-1]
    bot = points[-r:][::-1]
    padded = jnp.concatenate([top, points, bot], axis=0)          # [N+2r, 2]
    k = jnp.asarray(kernel)
    # correlate each column: output[i] = sum_j padded[i+j] * k[j]
    n = points.shape[0]
    idx = jnp.arange(n)[:, None] + jnp.arange(kernel.shape[0])[None, :]
    gathered = padded[idx]                                        # [N, K, 2]
    # full float32 precision: a GPU would otherwise run the contraction as
    # TF32 and round metre-scale coordinates to mm
    return jnp.einsum("nkc,k->nc", gathered, k,
                      precision=jax.lax.Precision.HIGHEST)
