"""Array-native Hough line/corner detection.

The reference rasterizes the scan into a dynamically-sized uint8 image and
calls ``cv2.HoughLines`` (``fast_slam_2/algorithms/hough_transformation.py:
14-41``), then intersects detected lines pairwise with a 45-degree angle gate
(``:76-119``) and maps the hits back to metric space (``:122-145``).  An
OpenCV image pipeline cannot be jitted; here the same behaviour is dense
array math with static shapes:

  1. points are scaled/offset into the same pixel space the reference uses
     (scale 100, padding 20, offset from the data minimum — ``:55-66``);
  2. the radius-2 disc rasterization (``:68-71``) becomes a static 13-offset
     expansion, deduplicated per pixel with a sort (so overlapping points vote
     once, like pixels in a binary image);
  3. the (theta, rho) vote accumulator is a scatter-add over a static
     ``[T, RHO_BINS]`` grid; line extraction is threshold + 4-neighbour
     local-max + top-K, matching cv2's accumulator semantics (threshold 80,
     1-px rho, 1-degree theta — ``:24``);
  4. pairwise intersections keep the reference's angle gate, determinant gate
     and in-image bound checks (``:90-117``);
  5. conversion back to metric space inverts the scale/offset (``:122-145``).

Everything is masked fixed-capacity: ``max_hough_lines`` lines and
``max_hough_lines^2`` candidate intersections.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from fastslam_tpu.config import FastSLAMConfig


class HoughLines(NamedTuple):
    rho: jax.Array    # [K] pixel-space rho
    theta: jax.Array  # [K] radians
    valid: jax.Array  # [K] bool


def _disc_offsets(radius: int) -> np.ndarray:
    """Static pixel offsets of a filled disc (cv2.circle thickness=-1 analog)."""
    r = int(radius)
    offs = [
        (dx, dy)
        for dx in range(-r, r + 1)
        for dy in range(-r, r + 1)
        if dx * dx + dy * dy <= r * r
    ]
    return np.asarray(offs, np.int32)


def rasterize_offsets(points: jax.Array, valid: jax.Array,
                      config: FastSLAMConfig):
    """Compute the pixel-space coordinates and image extent.

    Matches ``__create_hough_transformation_image`` (:44-73): offsets bring
    the scaled minimum to +padding; width/height are data-dependent *values*
    (static shapes).

    Returns (px [N] int32, py [N] int32, offset_x, offset_y, width, height).
    """
    big = jnp.float32(1e9)
    sx = points[:, 0] * config.hough_scale
    sy = points[:, 1] * config.hough_scale
    min_x = jnp.min(jnp.where(valid, sx, big)).astype(jnp.int32)
    min_y = jnp.min(jnp.where(valid, sy, big)).astype(jnp.int32)
    max_x = jnp.max(jnp.where(valid, sx, -big)).astype(jnp.int32)
    max_y = jnp.max(jnp.where(valid, sy, -big)).astype(jnp.int32)
    pad = config.hough_padding
    offset_x = jnp.where(min_x < 0, -min_x, 0) + pad
    offset_y = jnp.where(min_y < 0, -min_y, 0) + pad
    width = max_x + offset_x + pad
    height = max_y + offset_y + pad
    px = sx.astype(jnp.int32) + offset_x
    py = sy.astype(jnp.int32) + offset_y
    return px, py, offset_x, offset_y, width, height


def hough_lines(points: jax.Array, valid: jax.Array,
                config: FastSLAMConfig) -> Tuple[HoughLines, jax.Array, jax.Array, jax.Array, jax.Array]:
    """Detect up to ``max_hough_lines`` lines in the scan.

    Args:
      points: ``[N, 2]`` metric scan points; valid: ``[N]`` bool.

    Returns (lines, offset_x, offset_y, width, height) — the offsets/extent
    are needed to map intersections back to metric space.
    """
    n = points.shape[0]
    t_bins = config.hough_num_thetas
    r_bins = config.hough_rho_bins
    r_half = r_bins // 2

    px, py, off_x, off_y, width, height = rasterize_offsets(points, valid, config)

    # --- disc expansion + per-pixel dedup -------------------------------
    offs = _disc_offsets(config.hough_point_radius)      # [D, 2]
    d = offs.shape[0]
    ex = (px[:, None] + offs[None, :, 0]).reshape(-1)    # [N*D]
    ey = (py[:, None] + offs[None, :, 1]).reshape(-1)
    evalid = jnp.repeat(valid, d)
    # unique pixel ids (int32: coords are >= 0 and < 2^15 after offsetting);
    # invalid entries get the max sentinel so they sort to the end
    sentinel = jnp.int32(2**31 - 1)
    exc = jnp.clip(ex, 0, 32767)
    eyc = jnp.clip(ey, 0, 32767)
    pid = jnp.where(evalid, eyc * 32768 + exc, sentinel)
    order = jnp.argsort(pid)
    pid_s = pid[order]
    ex_s = ex[order]
    ey_s = ey[order]
    first = jnp.concatenate([jnp.array([True]), pid_s[1:] != pid_s[:-1]])
    weight = (first & (pid_s < sentinel)).astype(jnp.float32)  # 1 per unique pixel

    # --- vote ------------------------------------------------------------
    thetas = jnp.arange(t_bins, dtype=jnp.float32) * (jnp.pi / t_bins)
    cos_t = jnp.cos(thetas)
    sin_t = jnp.sin(thetas)
    # rho = x cos(theta) + y sin(theta)  (cv2 convention, image origin)
    rho = ex_s[:, None].astype(jnp.float32) * cos_t[None, :] + \
          ey_s[:, None].astype(jnp.float32) * sin_t[None, :]      # [N*D, T]
    rho_idx = jnp.round(rho).astype(jnp.int32) + r_half
    # static accumulator extent: |rho| < r_bins/2 px (~20.5 m at scale 100
    # with the default 4096 bins).  Points beyond it simply don't vote —
    # clipping them into the boundary bins would alias far geometry into
    # phantom lines.  Scans larger than the extent need a bigger
    # config.hough_rho_bins (or a smaller hough_scale).
    in_extent = (rho_idx >= 0) & (rho_idx < r_bins)
    rho_idx = jnp.clip(rho_idx, 0, r_bins - 1)
    w = weight[:, None] * in_extent.astype(jnp.float32)       # [N*D, T]
    if r_bins % 64 == 0:
        # histogram as a matmul: the vote scatter-add (~420k updates per
        # scan) becomes a batched matmul by factoring the rho one-hot into
        # hi/lo 64-way one-hots:
        #   acc[t, 64*h + l] = sum_p w[p,t] * [hi==h] * [lo==l]
        # i.e. per theta a [64, N*D] @ [N*D, 64] product.  EXACT integer
        # counts: the one-hot entries and the dedup/extent weights are
        # all 0/1 (exactly representable in bf16), products are 0/1, and
        # the product accumulates in f32 (exact integers far beyond the
        # maximum possible count N*D).  Bit-identical to the scatter
        # branch below, which it replaces when r_bins is a multiple of 64;
        # which of the two is faster on the GPU is not measured.
        hi = rho_idx >> 6
        lo = rho_idx & 63
        i64 = jnp.arange(64, dtype=jnp.int32)
        ohh = ((hi[..., None] == i64).astype(jnp.bfloat16)
               * w[..., None].astype(jnp.bfloat16))           # [N*D, T, 64]
        ohl = (lo[..., None] == i64).astype(jnp.bfloat16)
        acc = jnp.einsum("pth,ptl->thl", ohh, ohl,
                         preferred_element_type=jnp.float32)
        acc = acc.reshape(t_bins, r_bins)
    else:
        t_idx = jnp.broadcast_to(
            jnp.arange(t_bins, dtype=jnp.int32)[None, :], rho_idx.shape)
        flat = (t_idx * r_bins + rho_idx).reshape(-1)
        acc = jnp.zeros((t_bins * r_bins,), jnp.float32).at[flat].add(
            w.reshape(-1))
        acc = acc.reshape(t_bins, r_bins)

    # --- threshold + 4-neighbour local max + top-K ----------------------
    thr = jnp.float32(config.hough_threshold)
    up = jnp.pad(acc, ((1, 0), (0, 0)))[:-1]
    down = jnp.pad(acc, ((0, 1), (0, 0)))[1:]
    left = jnp.pad(acc, ((0, 0), (1, 0)))[:, :-1]
    right = jnp.pad(acc, ((0, 0), (0, 1)))[:, 1:]
    is_line = (acc >= thr) & (acc > left) & (acc >= right) & (acc > up) & (acc >= down)
    score = jnp.where(is_line, acc, -1.0)
    k = config.max_hough_lines
    # hierarchical top-k: per-theta-row top-k (k candidates per row)
    # followed by a stable re-sort instead of a flat top_k over the
    # T*RHO_BINS accumulator; EXACT by construction — the global top-k is always contained
    # in the per-row top-ks, and a stable argsort on -score over the
    # row-major candidate list reproduces lax.top_k's deterministic
    # (value desc, index asc) tie order: candidate order is (row asc,
    # in-row index asc), which IS flat-index order for equal scores.
    row_vals, row_idx = jax.lax.top_k(score, min(k, r_bins))   # [T, k]
    cand_idx = (row_idx
                + jnp.arange(t_bins, dtype=jnp.int32)[:, None] * r_bins)
    cv = row_vals.reshape(-1)
    ci = cand_idx.reshape(-1)
    order = jnp.argsort(-cv, stable=True)[:k]
    top_score = cv[order]
    top_idx = ci[order]
    line_valid = top_score > 0
    t_i = top_idx // r_bins
    r_i = top_idx % r_bins

    rho_f = (r_i - r_half).astype(jnp.float32)
    theta_f = t_i.astype(jnp.float32) * (jnp.pi / t_bins)
    lines = HoughLines(rho=rho_f, theta=theta_f, valid=line_valid)

    if config.hough_refine and not config.parity_mode:
        # total-least-squares refit: Hough detects (coarse 1 px / 1 degree
        # bins — hough_transformation.py:24), the scan points estimate.  For
        # each detected line, weight the un-rasterized pixel-space points
        # within a distance band of it and refit (rho, theta) by weighted
        # PCA: the line runs through the inlier centroid along the principal
        # eigenvector.  (Parabolic accumulator interpolation was tried and
        # measurably HURT: vote counts near a peak reflect point-to-bin
        # aliasing, not a smooth surface.)
        pxf = points[:, 0] * config.hough_scale + off_x.astype(jnp.float32)
        pyf = points[:, 1] * config.hough_scale + off_y.astype(jnp.float32)
        lines = refine_lines_tls(
            lines, pxf, pyf, valid, band_px=config.hough_refine_band_px
        )

    return lines, off_x, off_y, width, height


def refine_lines_tls(lines: HoughLines, pxf: jax.Array, pyf: jax.Array,
                     valid: jax.Array, band_px: float = 3.0) -> HoughLines:
    """Weighted total-least-squares refit of each line over its inliers.

    Args: ``pxf/pyf`` ``[N]`` float pixel coordinates, ``valid`` ``[N]``.
    A line keeps its Hough estimate when fewer than 3 points fall inside the
    band (degenerate fit).
    """
    nx = jnp.cos(lines.theta)[:, None]           # [K, 1]
    ny = jnp.sin(lines.theta)[:, None]
    d = jnp.abs(pxf[None, :] * nx + pyf[None, :] * ny - lines.rho[:, None])
    w = ((d < band_px) & valid[None, :]).astype(jnp.float32)   # [K, N]
    wsum = jnp.sum(w, axis=1)
    ws = jnp.maximum(wsum, 1e-9)

    cx = jnp.sum(w * pxf[None, :], axis=1) / ws
    cy = jnp.sum(w * pyf[None, :], axis=1) / ws
    dx = pxf[None, :] - cx[:, None]
    dy = pyf[None, :] - cy[:, None]
    sxx = jnp.sum(w * dx * dx, axis=1)
    sxy = jnp.sum(w * dx * dy, axis=1)
    syy = jnp.sum(w * dy * dy, axis=1)

    # principal direction phi of the 2x2 scatter; the line's NORMAL is
    # phi + pi/2, folded into [0, pi) with rho's sign following
    phi = 0.5 * jnp.arctan2(2.0 * sxy, sxx - syy)
    theta_n = phi + jnp.pi / 2.0
    nrx = jnp.cos(theta_n)
    nry = jnp.sin(theta_n)
    rho_n = cx * nrx + cy * nry
    flip = theta_n >= jnp.pi
    theta_n = jnp.where(flip, theta_n - jnp.pi, theta_n)
    rho_n = jnp.where(flip, -rho_n, rho_n)
    neg = theta_n < 0
    theta_n = jnp.where(neg, theta_n + jnp.pi, theta_n)
    rho_n = jnp.where(neg, -rho_n, rho_n)

    ok = (wsum >= 3.0) & lines.valid
    return HoughLines(
        rho=jnp.where(ok, rho_n, lines.rho),
        theta=jnp.where(ok, theta_n, lines.theta),
        valid=lines.valid,
    )


class Intersections(NamedTuple):
    xy: jax.Array     # [K*K, 2] metric-space intersection points
    valid: jax.Array  # [K*K] bool


def line_intersections(lines: HoughLines, off_x, off_y, width, height,
                       config: FastSLAMConfig) -> Intersections:
    """Pairwise line intersections with the reference's gates (:90-117),
    mapped back to metric space (:122-145)."""
    k = lines.rho.shape[0]
    rho1 = lines.rho[:, None]
    rho2 = lines.rho[None, :]
    th1 = lines.theta[:, None]
    th2 = lines.theta[None, :]

    dtheta = jnp.abs(th1 - th2)
    dtheta = jnp.minimum(dtheta, jnp.pi - dtheta)
    angle_ok = dtheta >= config.min_line_angle_rad

    a1, b1 = jnp.cos(th1), jnp.sin(th1)
    a2, b2 = jnp.cos(th2), jnp.sin(th2)
    det = a1 * b2 - a2 * b1
    det_ok = jnp.abs(det) > 1e-10
    det_safe = jnp.where(det_ok, det, 1.0)
    x = (b2 * rho1 - b1 * rho2) / det_safe
    y = (a1 * rho2 - a2 * rho1) / det_safe

    iu = jax.lax.broadcasted_iota(jnp.int32, (k, k), 0)
    ju = jax.lax.broadcasted_iota(jnp.int32, (k, k), 1)
    pair_ok = (iu < ju) & lines.valid[:, None] & lines.valid[None, :]
    in_img = (x >= 0) & (x < width) & (y >= 0) & (y < height)
    ok = pair_ok & angle_ok & det_ok & in_img

    # back to metric space (:122-145)
    mx = (x - off_x) / config.hough_scale
    my = (y - off_y) / config.hough_scale
    xy = jnp.stack([mx.reshape(-1), my.reshape(-1)], axis=-1)
    return Intersections(xy=xy, valid=ok.reshape(-1))
