"""Front-end tests: line filter vs scipy, clustering vs sklearn DBSCAN,
Hough corner detection on synthetic geometry."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from fastslam_tpu.config import FastSLAMConfig
from fastslam_tpu.frontend.clustering import (
    connected_component_clusters,
    dbscan_clusters,
)
from fastslam_tpu.frontend.line_filter import line_filter
from fastslam_tpu.frontend.pipeline import extract_corners, scan_to_measurements

CFG = FastSLAMConfig()


# --------------------------------------------------------------- line filter

def test_line_filter_default_sigma_is_identity():
    # scipy radius formula: int(4.0 * 0.1 + 0.5) == 0 -> identity
    pts = jnp.asarray(np.random.default_rng(0).normal(size=(180, 2)), jnp.float32)
    out = line_filter(pts, CFG)
    np.testing.assert_array_equal(np.asarray(out), np.asarray(pts))


def test_line_filter_matches_scipy_for_real_sigma():
    from scipy import ndimage

    rng = np.random.default_rng(1)
    pts = rng.normal(size=(64, 2)).astype(np.float32)
    cfg = CFG.replace(line_filter_sigma=1.5)
    out = np.asarray(line_filter(jnp.asarray(pts), cfg))
    want = np.stack(
        [ndimage.gaussian_filter1d(pts[:, i], sigma=1.5) for i in range(2)], axis=-1
    )
    np.testing.assert_allclose(out, want, atol=1e-4)


# ---------------------------------------------------------------- clustering

def _sk_dbscan_centroids(points, eps, min_samples):
    from sklearn.cluster import DBSCAN

    db = DBSCAN(eps=eps, min_samples=min_samples).fit(points)
    cents = []
    for lbl in sorted(set(db.labels_)):
        if lbl == -1:
            continue
        cents.append(points[db.labels_ == lbl].mean(axis=0))
    return sorted(map(tuple, np.round(cents, 5).tolist()))


def test_connected_components_match_sklearn_min_samples_1():
    rng = np.random.default_rng(2)
    pts = np.concatenate([
        rng.normal([0, 0], 0.1, (10, 2)),
        rng.normal([3, 3], 0.1, (7, 2)),
        rng.normal([-2, 4], 0.1, (5, 2)),
    ]).astype(np.float32)
    valid = np.ones(len(pts), bool)
    cl = connected_component_clusters(jnp.asarray(pts), jnp.asarray(valid), eps=0.5)
    got = np.asarray(cl.centroid)[np.asarray(cl.is_rep)]
    got = sorted(map(tuple, np.round(got, 5).tolist()))
    want = _sk_dbscan_centroids(pts, 0.5, 1)
    np.testing.assert_allclose(got, want, atol=1e-4)


def test_dbscan_with_core_points_matches_sklearn():
    rng = np.random.default_rng(3)
    dense = rng.normal([0, 0], 0.15, (20, 2))
    sparse = rng.normal([5, 5], 0.15, (3, 2))   # below min_samples -> noise
    outlier = np.array([[10.0, -10.0]])
    pts = np.concatenate([dense, sparse, outlier]).astype(np.float32)
    valid = np.ones(len(pts), bool)
    min_samples = 5
    cl = dbscan_clusters(jnp.asarray(pts), jnp.asarray(valid), eps=0.5,
                         min_samples=min_samples)
    got = np.asarray(cl.centroid)[np.asarray(cl.is_rep)]
    got = sorted(map(tuple, np.round(got, 4).tolist()))
    want = _sk_dbscan_centroids(pts, 0.5, min_samples)
    assert len(got) == len(want)
    np.testing.assert_allclose(got, want, atol=1e-3)


def test_clustering_respects_validity_mask():
    pts = np.zeros((8, 2), np.float32)
    pts[4:] = 100.0  # far cluster, but masked out
    valid = np.array([True] * 4 + [False] * 4)
    cl = connected_component_clusters(jnp.asarray(pts), jnp.asarray(valid), eps=0.5)
    reps = np.asarray(cl.is_rep)
    assert reps.sum() == 1 and reps[:4].sum() == 1


# ------------------------------------------------------------------- corners

def _square_room_scan(n=180, half=2.0, cx=0.3, cy=-0.2):
    """Raycast a square room from an interior point -> 4 detectable corners."""
    angles = np.radians(np.arange(n) - n // 2)
    dirs = np.stack([np.cos(angles), np.sin(angles)], -1)
    dists = np.full(n, np.inf)
    for wx, sign in ((0, 1), (0, -1), (1, 1), (1, -1)):
        denom = dirs[:, wx]
        target = sign * half - (cx if wx == 0 else cy)
        t = np.where(np.abs(denom) > 1e-9, target / denom, np.inf)
        t = np.where(t > 0, t, np.inf)
        other = (cy if wx == 0 else cx) + t * dirs[:, 1 - wx]
        t = np.where(np.abs(other) <= half + 1e-9, t, np.inf)
        dists = np.minimum(dists, t)
    pts = dirs * dists[:, None]
    return pts.astype(np.float32), np.isfinite(dists)


def test_extract_corners_finds_square_room_corners():
    # the laser spans a half circle (beam i at radians(i-90), robot.py:50),
    # so only the two forward corners of the room are visible
    pts, valid = _square_room_scan()
    corners, cvalid = extract_corners(jnp.asarray(pts), jnp.asarray(valid), CFG)
    got = np.asarray(corners)[np.asarray(cvalid)]
    want = np.array([[2 - 0.3, -2 + 0.2], [2 - 0.3, 2 + 0.2]])
    assert got.shape[0] == 2, f"expected the 2 visible corners, got {got}"
    for g in got:
        d = np.linalg.norm(want - g, axis=1).min()
        assert d < 0.15, f"spurious corner {g}, nearest true corner {d:.3f} away"


def test_scan_to_measurements_round_trip():
    pts, valid = _square_room_scan()
    ms = scan_to_measurements(jnp.asarray(pts), jnp.asarray(valid), CFG)
    rb = np.asarray(ms.range_bearing)[np.asarray(ms.valid)]
    assert rb.shape[0] == 2
    want = np.array([[2 - 0.3, -2 + 0.2], [2 - 0.3, 2 + 0.2]])
    for dist, bearing in rb:
        xy = np.array([dist * np.cos(bearing), dist * np.sin(bearing)])
        assert np.linalg.norm(want - xy, axis=1).min() < 0.15


def test_extract_corners_empty_scan_is_safe():
    pts = np.zeros((180, 2), np.float32)
    valid = np.zeros(180, bool)
    corners, cvalid = extract_corners(jnp.asarray(pts), jnp.asarray(valid), CFG)
    assert not np.asarray(cvalid).any()


def _float_scatter_adds(jaxpr):
    """Float scatter-adds in a jaxpr, nested ones too."""
    out = []
    for eqn in jaxpr.eqns:
        if (eqn.primitive.name == "scatter-add"
                and jnp.issubdtype(eqn.outvars[0].aval.dtype, jnp.floating)):
            out.append(eqn)
        for sub in jax.core.jaxprs_in_params(eqn.params):
            out += _float_scatter_adds(sub)
    return out


def test_frontend_has_no_float_scatter_add():
    """A GPU adds a scatter-add's colliding updates with atomics in no fixed
    order, so a float one makes the measurements (and every tick after)
    differ from run to run in their last bits.  The default frontend has
    none (the Hough votes go through an exact one-hot product, the cluster
    centroids through masked row sums)."""
    pts, valid = _square_room_scan()
    jaxpr = jax.make_jaxpr(lambda p, v: scan_to_measurements(p, v, CFG))(
        jnp.asarray(pts), jnp.asarray(valid))
    assert not _float_scatter_adds(jaxpr.jaxpr)
