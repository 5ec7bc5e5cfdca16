"""Multi-session map merge: align and fuse landmark maps across runs.

The reference is strictly single-session — `LandmarkUtils.known_landmarks`
(``landmark_utils.py:18``) lives for one process and is never persisted or
combined.  A production SLAM service accumulates maps across sessions
(missions, robots, days); this module provides the greenfield counterpart:

1. :func:`align_landmark_maps` — estimate the SE(2) transform taking session
   B's landmark map into session A's frame with a correspondence-gated
   (trimmed) ICP, robust to partial overlap: correspondences beyond the gate
   get zero weight each iteration, so B-only landmarks cannot bias the fit.
2. :func:`merge_landmark_maps` — fuse the aligned maps: B landmarks within
   the merge gate of an A landmark average into it (scatter-mean), the rest
   append into A's free capacity slots.
3. :func:`merge_sessions` — the end-to-end convenience: align, merge, and
   carry session B's trajectory into the merged frame.

Everything is masked fixed-capacity array math (jit-safe, shards trivially on
the map axis); alignment reuses the ICP machinery from
``fastslam_tpu.proposal.icp``.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp

from fastslam_tpu.proposal.icp import (
    best_fit_angle, nearest_neighbors, rotate_points, rotation_matrix,
)


class MapAlignment(NamedTuple):
    rotation: jax.Array       # [2, 2] R taking B-frame points to A-frame
    translation: jax.Array    # [2]
    mean_residual: jax.Array  # mean gated NN distance at convergence
    num_matched: jax.Array    # landmarks of B that found a gated match in A


class MergedMap(NamedTuple):
    landmarks: jax.Array      # [cap, 2] fused map (A's capacity)
    valid: jax.Array          # [cap] bool
    matched_b: jax.Array      # [Lb] bool - B landmarks fused into an A landmark
    appended_b: jax.Array     # [Lb] bool - B landmarks appended as new
    dropped_b: jax.Array      # [Lb] bool - unmatched B landmarks lost to capacity


def transform_points(points: jax.Array, rotation: jax.Array,
                     translation: jax.Array) -> jax.Array:
    """Apply an SE(2) transform to ``[N, 2]`` points.

    Elementwise rotation, not ``points @ R.T`` — a reduced-precision matmul
    would quantize metric coordinates (proposal/icp.py numerics note)."""
    theta = jnp.arctan2(rotation[1, 0], rotation[0, 0])
    return rotate_points(points, theta) + translation


def transform_poses(poses: jax.Array, rotation: jax.Array,
                    translation: jax.Array) -> jax.Array:
    """Apply an SE(2) transform to ``[N, 3]`` (x, y, yaw) poses."""
    theta = jnp.arctan2(rotation[1, 0], rotation[0, 0])
    xy = rotate_points(poses[:, :2], theta) + translation
    yaw = (poses[:, 2] + theta + jnp.pi) % (2.0 * jnp.pi) - jnp.pi
    return jnp.concatenate([xy, yaw[:, None]], axis=1)


def align_landmark_maps(
    lm_b: jax.Array,
    valid_b: jax.Array,
    lm_a: jax.Array,
    valid_a: jax.Array,
    *,
    gate: float = 1.5,
    final_gate: float = 0.3,
    num_iters: int = 50,
    tolerance: float = 1e-6,
) -> MapAlignment:
    """Gated (trimmed) ICP aligning map B onto map A.

    Unlike scan ICP (dense 180-beam clouds, full overlap), landmark maps are
    sparse and overlap only partially, so every iteration down-weights
    correspondences beyond the gate to zero — a B-only landmark whose nearest
    A landmark is across the building contributes nothing.  The gate anneals
    geometrically from ``gate`` (loose: capture the offset) to ``final_gate``
    (tight: spurious within-``gate`` matches between non-shared landmarks
    drop out of the refinement).  Assumes the sessions share an approximate
    global frame (same start area / dock); for arbitrary initial offsets seed
    via ``transform_points`` first.
    """
    sw_base = valid_b.astype(lm_b.dtype)

    def cond(carry):
        it, _, _, _, prev_err, err, converged = carry
        return (it < num_iters) & (~converged)

    def body(carry):
        it, src, theta_total, trans_total, prev_err, _, _ = carry
        # anneal slowly: capture phase (several iterations near the full
        # gate) must outlast ICP's convergence on the gross offset
        g = jnp.maximum(final_gate, gate * 0.93 ** it.astype(lm_b.dtype))
        dist, idx = nearest_neighbors(src, lm_a, valid_a)
        w = sw_base * (dist < g)
        matched = lm_a[idx]
        theta, trans = best_fit_angle(src, matched, w)
        src = rotate_points(src, theta) + trans
        trans_total = rotate_points(trans_total, theta) + trans
        theta_total = theta_total + theta
        err = jnp.sum(dist * w) / jnp.maximum(jnp.sum(w), 1e-12)
        # don't declare convergence while the gate is still annealing
        converged = (jnp.abs(prev_err - err) < tolerance) & (
            g <= final_gate * 1.01
        )
        return it + 1, src, theta_total, trans_total, err, err, converged

    init = (
        jnp.int32(0),
        lm_b,
        jnp.zeros((), lm_b.dtype),
        jnp.zeros((2,), lm_b.dtype),
        jnp.asarray(jnp.inf, lm_b.dtype),
        jnp.asarray(jnp.inf, lm_b.dtype),
        jnp.asarray(False),
    )
    _, src, theta_total, trans_total, _, err, _ = jax.lax.while_loop(
        cond, body, init
    )
    dist, _ = nearest_neighbors(src, lm_a, valid_a)
    n_matched = jnp.sum((dist < final_gate) & valid_b)
    return MapAlignment(rotation=rotation_matrix(theta_total),
                        translation=trans_total,
                        mean_residual=err, num_matched=n_matched)


def merge_landmark_maps(
    lm_a: jax.Array,
    valid_a: jax.Array,
    lm_b: jax.Array,
    valid_b: jax.Array,
    *,
    gate: float = 0.5,
    weight_a: float = 1.0,
) -> MergedMap:
    """Fuse an ALIGNED map B into map A (masked, jit-safe).

    B landmarks within ``gate`` of their nearest valid A landmark scatter-
    average into it (``weight_a`` is A's prior weight — e.g. its session
    count, so repeated merges converge instead of oscillating); the rest
    append into A's free slots, oldest-capacity-first, and report as dropped
    once capacity is exhausted.

    NOTE: the output slot order is NOT stable relative to ``lm_a`` — A's
    valid landmarks are compacted to the front (so free slots are contiguous
    for the appends) before B is scattered in.  Callers holding slot indices
    into A must re-associate by position; ``matched_b``/``appended_b``/
    ``dropped_b`` index rows of ``lm_b``, which IS stable.
    """
    cap = lm_a.shape[0]
    dist, idx = nearest_neighbors(lm_b, lm_a, valid_a)
    matched = valid_b & (dist < gate)

    # scatter-mean matched B landmarks into their A slot
    ones = matched.astype(lm_a.dtype)
    counts = jnp.zeros((cap,), lm_a.dtype).at[idx].add(ones)
    sums = jnp.zeros_like(lm_a).at[idx].add(lm_b * ones[:, None])
    denom = (weight_a + counts)[:, None]
    fused = (lm_a * weight_a + sums) / jnp.maximum(denom, 1e-12)
    new_a = jnp.where((counts > 0)[:, None], fused, lm_a)

    # append unmatched B landmarks at the free slots after A's valid ones
    n_a = jnp.sum(valid_a)
    to_append = valid_b & ~matched
    order = jnp.cumsum(to_append.astype(jnp.int32)) - 1     # rank among appends
    slot = n_a + order
    # non-appends scatter out of bounds and are dropped (no slot aliasing)
    slot_safe = jnp.where(to_append & (slot < cap), slot, cap)
    in_cap = to_append & (slot < cap)
    # compact A first so free slots are contiguous at the tail
    a_order = jnp.argsort(~valid_a, stable=True)
    new_a = new_a[a_order]
    valid_sorted = valid_a[a_order]
    new_a = new_a.at[slot_safe].set(lm_b, mode="drop")
    new_valid = valid_sorted | (
        jnp.zeros((cap,), bool).at[slot_safe].set(True, mode="drop")
    )
    return MergedMap(
        landmarks=new_a,
        valid=new_valid,
        matched_b=matched,
        appended_b=in_cap,
        dropped_b=to_append & ~in_cap,
    )


def merge_sessions(
    lm_a: jax.Array,
    valid_a: jax.Array,
    lm_b: jax.Array,
    valid_b: jax.Array,
    poses_b: jax.Array | None = None,
    *,
    align_gate: float = 1.5,
    merge_gate: float = 0.5,
    weight_a: float = 1.0,
    num_iters: int = 50,
) -> Tuple[MapAlignment, MergedMap, jax.Array | None]:
    """Align session B's map onto session A's and fuse them.

    Returns ``(alignment, merged_map, poses_b_in_a_frame)``; the last is
    ``None`` when ``poses_b`` is not given.
    """
    alignment = align_landmark_maps(
        lm_b, valid_b, lm_a, valid_a, gate=align_gate, num_iters=num_iters
    )
    lm_b_aligned = transform_points(lm_b, alignment.rotation,
                                    alignment.translation)
    merged = merge_landmark_maps(
        lm_a, valid_a, lm_b_aligned, valid_b,
        gate=merge_gate, weight_a=weight_a,
    )
    poses_out = None
    if poses_b is not None:
        poses_out = transform_poses(poses_b, alignment.rotation,
                                    alignment.translation)
    return alignment, merged, poses_out


def refine_merged_sessions(
    kf_a,
    measurements_a,
    kf_b_aligned,
    measurements_b,
    *,
    num_iters: int = 25,
    reassociate_rounds: int = 2,
    association_gate: float = 0.8,
    max_landmarks: int = 256,
    max_factors: int = 4096,
    consensus: bool = True,
    consensus_sigma_xy: float = 0.05,
    consensus_sigma_theta: float = 0.001,
):
    """Joint pose-graph refinement of two merged sessions.

    The map-level merge above aligns B onto A with one rigid SE(2) transform
    — it cannot correct the sessions' own accumulated drift.  This builds ONE
    pose graph over both trajectories: all keyframes of A then B (B already
    in A's frame via the alignment), per-session odometry chains (the
    odometry factor across the session boundary is invalidated —
    ``build_pose_graph(session_boundaries=...)``), and a shared landmark set
    associated in the common frame, so co-observed landmarks become the
    cross-session loop-closure constraints that bend each trajectory, not
    just shift it.

    Args:
      kf_a / kf_b_aligned: ``[Ka, 3]`` / ``[Kb, 3]`` keyframe poses, common frame.
      measurements_a / measurements_b: per-keyframe ``[m, 2]`` (range, bearing).
      consensus: run boundary-aware co-visibility consensus alignment
        (``backend.alignment.consensus_align`` with
        ``session_boundaries=(Ka,)``) and associate at the drift-corrected
        poses — under heavy per-session drift the fixed gate at the input
        poses splits exactly the cross-session landmark pairs that carry
        the loop closures.  The graph still starts from the honest input
        poses (``association_poses`` semantics).

    Returns ``(kf_a_refined, kf_b_refined, info)``.
    """
    import numpy as np

    from fastslam_tpu.backend.builder import (
        build_pose_graph,
        reassociate_pose_graph,
    )
    from fastslam_tpu.backend.pose_graph import optimize

    kf_a = np.asarray(kf_a, np.float64)
    kf_b = np.asarray(kf_b_aligned, np.float64)
    ka = len(kf_a)
    kf = np.concatenate([kf_a, kf_b], axis=0)
    ms = list(measurements_a) + list(measurements_b)

    assoc_kf = None
    if consensus:
        from fastslam_tpu.backend.alignment import consensus_align

        assoc_kf, _ainfo = consensus_align(
            kf, ms, sigma_xy=consensus_sigma_xy,
            sigma_theta=consensus_sigma_theta,
            session_boundaries=(ka,),
        )

    graph = build_pose_graph(
        kf, ms, session_boundaries=(ka,),
        association_poses=assoc_kf,
        association_gate=association_gate,
        max_landmarks=max_landmarks, max_factors=max_factors,
    )
    poses, landmarks, err, _ = optimize(graph, num_iters=num_iters)

    rounds_used = 0
    per_factor = lambda e, g: float(e) / max(
        int(np.asarray(g.obs_valid).sum()), 1
    )
    for _ in range(reassociate_rounds):
        g2 = reassociate_pose_graph(
            graph, np.asarray(poses), association_gate=association_gate
        )
        p2, l2, e2, _ = optimize(g2, num_iters=num_iters)
        if per_factor(e2, g2) < per_factor(err, graph):
            graph, poses, landmarks, err = g2, p2, l2, e2
            rounds_used += 1
        else:
            break

    poses = np.asarray(poses)
    info = {
        "final_error": float(err),
        "num_landmarks": int(np.asarray(graph.lm_valid).sum()),
        "num_factors": int(np.asarray(graph.obs_valid).sum()),
        "reassociation_rounds": rounds_used,
    }
    return poses[:ka], poses[ka:], info
