"""Distributed pose-graph optimization: Schur complement over a map-axis mesh.

BASELINE.json config #5: 1M landmarks in blocks + pose-graph backend via
distributed Schur complement.  The structure (see backend.pose_graph):

* landmark slots and their observation factors shard over the mesh's map
  axis — ``landmark_system`` is embarrassingly shard-local (per-landmark 2x2
  Hll inverses, per-shard Hpl blocks);
* the reduced pose system is tiny ([3K, 3K] for K keyframes), so each
  shard's partial ``(hpp_diag, bp_obs, cross, rs_corr)`` is ``psum``-ed over
  the map axis and the solve happens replicated;
* back-substitution of landmark updates is again shard-local.

Factor-to-shard placement: the builder emits factors sorted by landmark
index; ``shard_pose_graph`` re-buckets them so each factor lives on the shard
owning its landmark (obs_lm becomes a local slot index).
"""

from __future__ import annotations

from functools import partial
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from jax import shard_map

from fastslam_tpu.backend.pose_graph import (
    PoseGraph,
    backsubstitute_landmarks,
    landmark_system,
    pose_system,
    wrap_angle,
)


def shard_pose_graph(g: PoseGraph, num_shards: int) -> Tuple[PoseGraph, int]:
    """Re-bucket landmarks/factors so shard s owns landmark slots
    [s*L/n, (s+1)*L/n) and exactly the factors that observe them.

    Returns ``(graph, dropped)``: a PoseGraph whose landmark/factor arrays
    are permutations with per-shard-local factor capacity (obs_lm stays a
    GLOBAL slot index; the shard-local conversion happens inside the
    shard_map body), and the number of valid factors that did NOT fit their
    owning shard's static capacity (``F/num_shards``).  ``dropped > 0``
    weakens the optimization — it also triggers a warning; rebalance
    landmark slots or raise ``max_factors`` to avoid it.
    """
    l = g.landmarks.shape[0]
    f = g.obs_kf.shape[0]
    assert l % num_shards == 0, "landmark capacity must divide the mesh"
    per_shard_l = l // num_shards
    per_shard_f = f // num_shards

    obs_lm = np.asarray(g.obs_lm)
    obs_valid = np.asarray(g.obs_valid)
    shard_of = obs_lm // per_shard_l

    # bucket factors by owning shard; overflow drops (capacity is static).
    # vectorized: stable-sort valid factors by shard, then clamp each
    # shard's run to its capacity
    pad_slot = int(np.argmin(obs_valid)) if not obs_valid.all() else 0
    order = np.full(f, pad_slot, np.int64)
    new_valid = np.zeros(f, bool)
    valid_idx = np.flatnonzero(obs_valid)
    by_shard = valid_idx[np.argsort(shard_of[valid_idx], kind="stable")]
    shard_sizes = np.bincount(shard_of[valid_idx], minlength=num_shards)
    starts = np.concatenate([[0], np.cumsum(shard_sizes)[:-1]])
    taken = np.minimum(shard_sizes, per_shard_f)
    dropped = int(np.sum(shard_sizes - taken))
    for s in range(num_shards):
        n = int(taken[s])
        dst = s * per_shard_f
        order[dst: dst + n] = by_shard[int(starts[s]): int(starts[s]) + n]
        new_valid[dst: dst + n] = True

    if dropped:
        import warnings

        warnings.warn(
            f"shard_pose_graph: {dropped} valid factors overflowed their "
            f"owning shard's capacity ({per_shard_f}/shard) and were "
            "DROPPED — the optimization is weakened; rebalance landmark "
            "slots or raise max_factors",
            stacklevel=2,
        )

    # HOST (numpy) arrays on purpose: the jitted step takes 1-D column
    # slices of these (pose_graph._obs_geometry_cols layout note); keeping
    # the permuted graph host-side costs nothing on any mesh.
    return g._replace(
        obs_kf=np.asarray(g.obs_kf)[order],
        obs_lm=obs_lm[order],
        obs_rb=np.asarray(g.obs_rb)[order],
        obs_info=np.asarray(g.obs_info)[order],
        obs_valid=new_valid,
    ), dropped


def build_schur_pairs(g: PoseGraph, num_shards: int):
    """Ordered same-landmark factor-pair lists for the SPARSE Schur path
    (:func:`~fastslam_tpu.backend.pose_graph.landmark_system_sparse`).

    For every landmark with c observing factors the cross term needs all
    c^2 ordered factor pairs.  Host-side numpy over the ALREADY-SHARDED
    graph (factor slot s*F/n..(s+1)*F/n belongs to shard s): per shard,
    sort its valid factors by landmark id, enumerate pairs within each
    equal-landmark run, pad every shard to the common capacity with masked
    (0, 0) pairs.

    Returns ``(pair_a, pair_b, pair_valid)`` as ``[n_shards * cap]`` arrays
    of SHARD-LOCAL factor slot indices, ready to shard on the map axis.
    """
    f = g.obs_kf.shape[0]
    per_shard_f = f // num_shards
    obs_lm = np.asarray(g.obs_lm)
    obs_valid = np.asarray(g.obs_valid)

    per_shard = []
    for s in range(num_shards):
        lo = s * per_shard_f
        valid = np.flatnonzero(obs_valid[lo: lo + per_shard_f])
        if valid.size == 0:
            per_shard.append((np.zeros(0, np.int32), np.zeros(0, np.int32)))
            continue
        lm = obs_lm[lo + valid]
        order = np.argsort(lm, kind="stable")
        sorted_idx = valid[order].astype(np.int32)
        lm_sorted = lm[order]
        _, counts = np.unique(lm_sorted, return_counts=True)
        starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
        c2 = counts * counts
        total = int(c2.sum())
        pair_starts = np.concatenate([[0], np.cumsum(c2)[:-1]])
        base = np.repeat(starts, c2)
        q = np.arange(total) - np.repeat(pair_starts, c2)
        c_rep = np.repeat(counts, c2)
        pa = sorted_idx[base + q // c_rep]
        pb = sorted_idx[base + q % c_rep]
        per_shard.append((pa, pb))

    cap = max(8, max((len(pa) for pa, _ in per_shard), default=8))
    cap = -(-cap // 8) * 8
    pair_a = np.zeros((num_shards, cap), np.int32)
    pair_b = np.zeros((num_shards, cap), np.int32)
    pair_valid = np.zeros((num_shards, cap), bool)
    for s, (pa, pb) in enumerate(per_shard):
        pair_a[s, : len(pa)] = pa
        pair_b[s, : len(pb)] = pb
        pair_valid[s, : len(pa)] = True
    return (jnp.asarray(pair_a.reshape(-1)),
            jnp.asarray(pair_b.reshape(-1)),
            jnp.asarray(pair_valid.reshape(-1)))


def make_sharded_gn_step(mesh: Mesh, map_axis: str = "map",
                         sparse: bool = True):
    """Compile one distributed damped-GN step.

    Sharding: poses replicated; landmarks + observation factors on the map
    axis.  Collective cost per iteration: one psum of
    [K,3,3]+[K,3]+[K,K,3,3]+[K,3] — independent of landmark count.

    ``sparse=True`` (default) uses the factor-pair Schur reduction —
    O(F + K^2) memory, required at 1M landmarks where the dense [K, L]
    assembly alone exceeds host/device memory; the step then takes the
    ``(pair_a, pair_b, pair_valid)`` arrays from :func:`build_schur_pairs`.
    ``sparse=False`` keeps the dense einsum path (fine for small maps).
    """
    from fastslam_tpu.backend.pose_graph import (
        backsubstitute_landmarks_sparse, landmark_system_sparse,
    )

    def sparse_body(poses, lx, ly, odo_rel, odo_info, odo_valid,
                    obs_kf, obs_lm, rb0, rb1, w0, w1, obs_valid,
                    prior_info, damping, pair_a, pair_b, pair_valid):
        """Column-vector layout throughout (pose_graph._obs_geometry_cols
        layout note): one [F]/[L] vector per component."""
        k = poses.shape[0]
        shard = jax.lax.axis_index(map_axis)
        l_local = lx.shape[0]
        local_lm = obs_lm - shard * l_local

        hpp_diag, bp_obs, cross, rs_corr, hll_inv_c, bl_c, hpl_c = (
            landmark_system_sparse(poses, lx, ly, damping,
                                   obs_kf, local_lm, rb0, rb1, w0, w1,
                                   obs_valid, pair_a, pair_b, pair_valid)
        )
        hpp_diag, bp_obs, cross, rs_corr = jax.lax.psum(
            (hpp_diag, bp_obs, cross, rs_corr), map_axis
        )

        g_odo = PoseGraph(
            poses=poses, landmarks=jnp.zeros((1, 2)),
            lm_valid=jnp.ones(1, bool),
            odo_rel=odo_rel, odo_info=odo_info, odo_valid=odo_valid,
            obs_kf=obs_kf[:1], obs_lm=local_lm[:1],
            obs_rb=jnp.zeros((1, 2)), obs_info=jnp.zeros((1, 2)),
            obs_valid=jnp.zeros(1, bool), prior_info=prior_info,
        )
        big_h, bp = pose_system(poses, g_odo, damping)
        big_h = big_h.at[jnp.arange(k), jnp.arange(k)].add(hpp_diag) - cross
        rs = (bp + bp_obs - rs_corr).reshape(3 * k)
        s_mat = big_h.transpose(0, 2, 1, 3).reshape(3 * k, 3 * k)

        dp = jax.scipy.linalg.solve(s_mat, rs, assume_a="pos").reshape(k, 3)
        dlx, dly = backsubstitute_landmarks_sparse(
            dp, hll_inv_c, bl_c, hpl_c, obs_kf, local_lm, l_local)

        new_poses = poses + dp
        new_poses = new_poses.at[:, 2].set(wrap_angle(new_poses[:, 2]))
        return new_poses, lx + dlx, ly + dly

    def dense_body(poses, landmarks, odo_rel, odo_info, odo_valid,
                   obs_kf, obs_lm, obs_rb, obs_info, obs_valid,
                   prior_info, damping):
        k = poses.shape[0]
        shard = jax.lax.axis_index(map_axis)
        l_local = landmarks.shape[0]
        # global -> local landmark slot ids
        local_lm = obs_lm - shard * l_local

        g_local = PoseGraph(
            poses=poses, landmarks=landmarks,
            lm_valid=jnp.ones(l_local, bool),
            odo_rel=odo_rel, odo_info=odo_info, odo_valid=odo_valid,
            obs_kf=obs_kf, obs_lm=local_lm, obs_rb=obs_rb,
            obs_info=obs_info, obs_valid=obs_valid,
            prior_info=prior_info,
        )

        hpp_diag, bp_obs, cross, rs_corr, hll_inv, bl, hpl_dense = (
            landmark_system(poses, landmarks, g_local, damping)
        )
        hpp_diag, bp_obs, cross, rs_corr = jax.lax.psum(
            (hpp_diag, bp_obs, cross, rs_corr), map_axis
        )

        big_h, bp = pose_system(poses, g_local, damping)
        big_h = big_h.at[jnp.arange(k), jnp.arange(k)].add(hpp_diag) - cross
        rs = (bp + bp_obs - rs_corr).reshape(3 * k)
        s_mat = big_h.transpose(0, 2, 1, 3).reshape(3 * k, 3 * k)

        dp = jax.scipy.linalg.solve(s_mat, rs, assume_a="pos").reshape(k, 3)
        dl = backsubstitute_landmarks(dp, hll_inv, bl, hpl_dense)

        new_poses = poses + dp
        new_poses = new_poses.at[:, 2].set(wrap_angle(new_poses[:, 2]))
        return new_poses, landmarks + dl

    mspec = P(map_axis)
    r = P()
    if sparse:
        body = shard_map(
            sparse_body, mesh=mesh,
            in_specs=(r, mspec, mspec, r, r, r,
                      mspec, mspec, mspec, mspec, mspec, mspec, mspec,
                      r, r, mspec, mspec, mspec),
            out_specs=(r, mspec, mspec),
            check_vma=False,
        )

        @jax.jit
        def step(poses, lx, ly, odo_rel, odo_info, odo_valid,
                 obs_kf, obs_lm, rb0, rb1, w0, w1, obs_valid,
                 prior_info, damping, pair_a, pair_b, pair_valid):
            return body(poses, lx, ly, odo_rel, odo_info, odo_valid,
                        obs_kf, obs_lm, rb0, rb1, w0, w1, obs_valid,
                        prior_info, damping, pair_a, pair_b, pair_valid)
    else:
        body = shard_map(
            dense_body, mesh=mesh,
            in_specs=(r, mspec, r, r, r, mspec, mspec, mspec, mspec, mspec,
                      r, r),
            out_specs=(r, mspec),
            check_vma=False,
        )

        @jax.jit
        def step(g: PoseGraph, damping):
            return body(
                g.poses, g.landmarks, g.odo_rel, g.odo_info, g.odo_valid,
                g.obs_kf, g.obs_lm, jnp.asarray(g.obs_rb),
                jnp.asarray(g.obs_info), g.obs_valid,
                g.prior_info, damping,
            )

    return step


def total_error_host(poses, lx, ly, g: PoseGraph) -> float:
    """Host-side (NumPy) total_error over column arrays — keeps the error
    evaluation off the device, where a padded [F, 2] round-trip would cost
    GBs at 1M landmarks (pose_graph._obs_geometry_cols layout note).
    Same math as :func:`pose_graph.total_error`."""
    poses = np.asarray(poses, np.float64)
    lx = np.asarray(lx, np.float64)
    ly = np.asarray(ly, np.float64)
    wrap = lambda a: (a + np.pi) % (2.0 * np.pi) - np.pi
    pa, pb = poses[:-1], poses[1:]
    c, s = np.cos(pa[:, 2]), np.sin(pa[:, 2])
    dx, dy = pb[:, 0] - pa[:, 0], pb[:, 1] - pa[:, 1]
    odo_rel = np.asarray(g.odo_rel)
    r_odo = np.stack([
        c * dx + s * dy - odo_rel[:, 0],
        -s * dx + c * dy - odo_rel[:, 1],
        wrap(wrap(pb[:, 2] - pa[:, 2]) - odo_rel[:, 2]),
    ], axis=-1)
    w_odo = np.where(np.asarray(g.odo_valid)[:, None],
                     np.asarray(g.odo_info), 0.0)
    obs_kf = np.asarray(g.obs_kf)
    obs_lm = np.asarray(g.obs_lm)
    rb = np.asarray(g.obs_rb, np.float64)
    ddx = lx[obs_lm] - poses[obs_kf, 0]
    ddy = ly[obs_lm] - poses[obs_kf, 1]
    q = np.maximum(ddx * ddx + ddy * ddy, 1e-12)
    r0 = rb[:, 0] - np.sqrt(q)
    r1 = wrap(rb[:, 1] - (np.arctan2(ddy, ddx) - poses[obs_kf, 2]))
    w = np.where(np.asarray(g.obs_valid)[:, None],
                 np.asarray(g.obs_info, np.float64), 0.0)
    return float((r_odo * r_odo * w_odo).sum()
                 + (w[:, 0] * r0 * r0 + w[:, 1] * r1 * r1).sum())


def optimize_sharded(g: PoseGraph, mesh: Mesh, num_iters: int = 10,
                     damping: float = 1e-6, map_axis: str = "map",
                     sparse: bool = True):
    """LM loop over the distributed GN step (host-side accept/reject).

    ``sparse=True`` (default) runs the factor-pair Schur reduction — the
    O(F + K^2)-memory path that handles 1M-landmark graphs; ``sparse=False``
    keeps the dense [K, L] assembly (small maps only).  The sparse path
    moves data to the device exclusively as 1-D column vectors (see
    pose_graph._obs_geometry_cols) and evaluates the LM accept/reject
    error on the host."""
    from fastslam_tpu.backend.pose_graph import total_error

    num_shards = mesh.shape[map_axis]
    g, _dropped = shard_pose_graph(g, num_shards)
    step = make_sharded_gn_step(mesh, map_axis, sparse=sparse)

    lam = damping
    if sparse:
        pair_a, pair_b, pair_valid = build_schur_pairs(g, num_shards)
        rb = np.asarray(g.obs_rb, np.float32)
        wi = np.asarray(g.obs_info, np.float32)
        cols = dict(
            odo_rel=jnp.asarray(g.odo_rel), odo_info=jnp.asarray(g.odo_info),
            odo_valid=jnp.asarray(g.odo_valid),
            obs_kf=jnp.asarray(np.asarray(g.obs_kf, np.int32)),
            obs_lm=jnp.asarray(np.asarray(g.obs_lm, np.int32)),
            rb0=jnp.asarray(rb[:, 0].copy()),
            rb1=jnp.asarray(rb[:, 1].copy()),
            w0=jnp.asarray(wi[:, 0].copy()),
            w1=jnp.asarray(wi[:, 1].copy()),
            obs_valid=jnp.asarray(np.asarray(g.obs_valid)),
            prior_info=jnp.asarray(g.prior_info),
        )
        lm = np.asarray(g.landmarks, np.float32)
        poses = jnp.asarray(np.asarray(g.poses, np.float32))
        lx = jnp.asarray(lm[:, 0].copy())
        ly = jnp.asarray(lm[:, 1].copy())
        err = total_error_host(poses, lx, ly, g)
        for _ in range(num_iters):
            new_p, new_lx, new_ly = step(
                poses, lx, ly, damping=jnp.float32(lam),
                pair_a=pair_a, pair_b=pair_b, pair_valid=pair_valid,
                **cols)
            new_err = total_error_host(new_p, new_lx, new_ly, g)
            if np.isfinite(new_err) and new_err < err:
                poses, lx, ly, err, lam = (new_p, new_lx, new_ly, new_err,
                                           lam * 0.5)
            else:
                lam *= 10.0
        # host-side assembly of the [L, 2] result from the two columns
        landmarks = np.stack([np.asarray(lx), np.asarray(ly)], axis=-1)
        return poses, landmarks, err

    err = float(total_error(g.poses, g.landmarks, g))
    poses, landmarks = g.poses, g.landmarks
    for _ in range(num_iters):
        new_p, new_l = step(g._replace(poses=poses, landmarks=landmarks),
                            jnp.float32(lam))
        new_err = float(total_error(new_p, new_l, g))
        if new_err < err:
            poses, landmarks, err, lam = new_p, new_l, new_err, lam * 0.5
        else:
            lam *= 10.0
    return poses, landmarks, err
