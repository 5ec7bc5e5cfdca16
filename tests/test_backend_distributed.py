"""Distributed Schur-complement backend on the 8-device virtual CPU mesh:
must agree with the single-device optimizer."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
from jax.sharding import Mesh

from fastslam_tpu.backend.builder import build_pose_graph
from fastslam_tpu.backend.distributed import (
    make_sharded_gn_step,
    optimize_sharded,
    shard_pose_graph,
)
from fastslam_tpu.backend.pose_graph import gauss_newton_step, total_error

from test_backend import simulate_world


@pytest.fixture(scope="module")
def mesh():
    devs = np.asarray(jax.devices())
    assert len(devs) == 8
    return Mesh(devs, ("map",))


def make_graph(seed=2, k=12, drift=0.4, max_landmarks=16, max_factors=512):
    noisy, obs, gt, _ = simulate_world(k=k, drift=drift, seed=seed)
    return build_pose_graph(noisy, obs, max_landmarks=max_landmarks,
                            max_factors=max_factors), gt


def test_shard_pose_graph_preserves_factors():
    g, _ = make_graph()
    g8, dropped = shard_pose_graph(g, 8)
    assert dropped == 0
    # same multiset of valid factors
    def factor_set(graph):
        v = np.asarray(graph.obs_valid)
        return sorted(zip(
            np.asarray(graph.obs_kf)[v].tolist(),
            np.asarray(graph.obs_lm)[v].tolist(),
            np.round(np.asarray(graph.obs_rb)[v], 5)[:, 0].tolist(),
        ))
    assert factor_set(g8) == factor_set(g)
    # each factor now lives in the bucket of its landmark's shard
    per_shard_f = g8.obs_kf.shape[0] // 8
    per_shard_l = g8.landmarks.shape[0] // 8
    v = np.asarray(g8.obs_valid)
    lm = np.asarray(g8.obs_lm)
    for i in np.where(v)[0]:
        assert lm[i] // per_shard_l == i // per_shard_f


@pytest.mark.parametrize("sparse", [True, False])
def test_sharded_gn_step_matches_single_device(mesh, sparse):
    """Both the dense [K, L] Schur assembly and the factor-pair SPARSE
    reduction (the 1M-landmark path) must reproduce the single-device
    gauss_newton_step."""
    from fastslam_tpu.backend.distributed import build_schur_pairs

    g, _ = make_graph()
    damp = jnp.float32(1e-4)
    p_want, l_want = gauss_newton_step(g.poses, g.landmarks, g, damp)

    g8, _ = shard_pose_graph(g, 8)
    step = make_sharded_gn_step(mesh, sparse=sparse)
    if sparse:
        # the sparse step takes COLUMN vectors (pose_graph.
        # _obs_geometry_cols layout note)
        pair_a, pair_b, pair_valid = build_schur_pairs(g8, 8)
        rb = np.asarray(g8.obs_rb, np.float32)
        wi = np.asarray(g8.obs_info, np.float32)
        lm = np.asarray(g8.landmarks, np.float32)
        p_got, lx, ly = step(
            jnp.asarray(np.asarray(g8.poses, np.float32)),
            jnp.asarray(lm[:, 0].copy()), jnp.asarray(lm[:, 1].copy()),
            jnp.asarray(g8.odo_rel), jnp.asarray(g8.odo_info),
            jnp.asarray(g8.odo_valid),
            jnp.asarray(np.asarray(g8.obs_kf, np.int32)),
            jnp.asarray(np.asarray(g8.obs_lm, np.int32)),
            jnp.asarray(rb[:, 0].copy()), jnp.asarray(rb[:, 1].copy()),
            jnp.asarray(wi[:, 0].copy()), jnp.asarray(wi[:, 1].copy()),
            jnp.asarray(np.asarray(g8.obs_valid)),
            jnp.asarray(g8.prior_info),
            damp, pair_a, pair_b, pair_valid)
        l_got = np.stack([np.asarray(lx), np.asarray(ly)], axis=-1)
    else:
        p_got, l_got = step(g8, damp)

    np.testing.assert_allclose(np.asarray(p_got), np.asarray(p_want),
                               rtol=1e-4, atol=1e-4)
    # landmark arrays are permuted by sharding; compare as sorted multisets
    lw = np.sort(np.round(np.asarray(l_want), 4).view("f4").reshape(-1, 2), axis=0)
    lg = np.sort(np.round(np.asarray(l_got), 4).reshape(-1, 2), axis=0)
    np.testing.assert_allclose(lg, lw, atol=1e-3)


def test_optimize_sharded_recovers_trajectory(mesh):
    g, gt = make_graph(seed=5, k=16, drift=0.5)
    noisy = np.asarray(g.poses)
    before = np.linalg.norm(noisy[:, :2] - gt[:, :2], axis=1).mean()
    poses, landmarks, err = optimize_sharded(g, mesh, num_iters=12)
    after = np.linalg.norm(np.asarray(poses)[:, :2] - gt[:, :2], axis=1).mean()
    assert np.isfinite(err)
    assert after < before * 0.6, f"{before:.4f} -> {after:.4f}"
