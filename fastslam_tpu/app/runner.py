"""The control loop — ``jde_robots_main.py:18-59`` re-cast over a Driver.

Each tick: read scan -> odometry from commanded velocities
(``robot.py:122-151`` semantics incl. the 0.6 velocity fudge and the
rotation-XOR-translation split) -> front-end corner extraction (jitted) ->
one ``fastslam_step`` (jitted) -> dead-reckoning warmup gate
(``jde_robots_main.py:16,41-49``) -> per-tick evaluation against ground truth
(``evaluation_utils.py``, offsets subtracted as at :46-55).

The loop is host-side Python (it owns the simulator/log boundary); all the
math is inside the two jitted functions.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

import jax
import jax.numpy as jnp
import numpy as np

from fastslam_tpu.config import FastSLAMConfig
from fastslam_tpu.core import kernels
from fastslam_tpu.core.state import (
    FilterState,
    Measurements,
    from_planes,
    init_planes_state,
    init_state,
    to_planes,
)
from fastslam_tpu.drivers.base import Driver
from fastslam_tpu.eval.metrics import TickEvaluation, evaluate_tick, trajectory_metrics
from fastslam_tpu.frontend.pipeline import scan_to_measurements


@dataclass
class RunHistory:
    est_poses: List[np.ndarray] = field(default_factory=list)
    gt_poses: List[np.ndarray] = field(default_factory=list)
    evaluations: List[TickEvaluation] = field(default_factory=list)
    num_measurements: List[int] = field(default_factory=list)
    # final (xy, theta) adaptive proposal floors, when the run adapts them
    # (the floors the LAST tick's type read — floors are per tick type)
    final_floors: tuple | None = None
    # ((fxy, fth) for rotation ticks, (fxy, fth) for translation ticks) at
    # end of run — slip on one component opens only that TYPE's floors
    final_floors_by_type: tuple | None = None
    # full per-tick floor trajectories (batched replay only) — observability
    floor_traj: tuple | None = None

    def metrics(self, skip: int = 0) -> dict:
        return trajectory_metrics(
            np.asarray(self.gt_poses[skip:]), np.asarray(self.est_poses[skip:])
        )


class SLAMRunner:
    """Owns the jitted step functions and the dead-reckoned robot pose."""

    def __init__(self, config: FastSLAMConfig, rng: int = 0):
        self.config = config
        self.uses_planes = config.use_pallas
        if self.uses_planes:
            # the fused kernel's [L, P] layout carried between ticks — no
            # per-step layout conversion around the kernel
            self.state = init_planes_state(config, rng)
        else:
            self.state = init_state(config, rng)
        self.robot = np.zeros(3)  # dead-reckoned pose during warmup
        self.iteration = 0
        self._prev_timestamp: Optional[float] = None

        self._frontend = jax.jit(
            lambda pts, valid: scan_to_measurements(pts, valid, config)
        )
        if config.track_corners:
            from fastslam_tpu.frontend.pipeline import (
                extract_corners, measurements_from_corners,
            )
            from fastslam_tpu.frontend.tracking import (
                init_tracks, stable_corners, update_tracks,
            )

            self._tracks = init_tracks(config.track_capacity)

            def tracked_frontend(tracks, pts, valid, rot, trans):
                corners, cvalid = extract_corners(pts, valid, config)
                tracks = update_tracks(
                    tracks, corners, cvalid, rot, trans,
                    gate=config.track_gate, ema=config.track_ema,
                    max_misses=config.track_max_misses,
                )
                pos, ids, ok = stable_corners(
                    tracks, min_hits=config.track_min_hits
                )
                return tracks, measurements_from_corners(pos, ok, config)

            self._tracked_frontend = jax.jit(tracked_frontend)
        self._adaptive_floors = bool(config.adaptive_proposal_floors)
        if self._adaptive_floors and not (
            config.use_icp_proposal and config.proposal_mode == "fastslam2"
        ):
            raise ValueError(
                "adaptive_proposal_floors estimates the odometry error from "
                "the ICP-vs-command residual and feeds it to the fastslam2 "
                "proposal: requires use_icp_proposal=True and "
                "proposal_mode='fastslam2'"
            )
        # host-side state of the online odometry-error estimator
        # (proposal/adaptive.py — shared with the batched replay path)
        self._floor_xy = config.proposal_xy_floor
        self._floor_th = config.proposal_theta_floor
        self._blend_xy = 0.0
        self._blend_th = 0.0
        self._bias_th = 0.0
        self._lat_gate = 1.0
        self._dial = 0.0 if self._adaptive_floors else 1.0
        self._prev_cmd = (0.0, 0.0)
        self._prev_se2 = (0.0, 0.0, 0.0)
        if self._adaptive_floors:
            from fastslam_tpu.proposal.adaptive import OnlineFloorEstimator

            self._floor_est = OnlineFloorEstimator(config)
        if self.uses_planes and self._adaptive_floors:
            self._step = jax.jit(
                lambda st, rot, trans, ms, fxy, fth, g:
                kernels.fastslam_step_planes(
                    st, rot, trans, ms, config, proposal_floors=(fxy, fth),
                    evidence_scale=g,
                ),
                donate_argnums=0,
            )
        elif self.uses_planes:
            self._step = jax.jit(
                lambda st, rot, trans, ms: kernels.fastslam_step_planes(
                    st, rot, trans, ms, config
                ),
                donate_argnums=0,
            )
        elif self._adaptive_floors:
            # floors + mode dial ride as TRACED scalars so per-tick
            # adaptation does not trigger recompilation
            self._step = jax.jit(
                lambda st, rot, trans, ms, fxy, fth, g: kernels.fastslam_step(
                    st, rot, trans, ms, config, proposal_floors=(fxy, fth),
                    evidence_scale=g,
                )
            )
        else:
            self._step = jax.jit(
                lambda st, rot, trans, ms: kernels.fastslam_step(st, rot, trans, ms, config)
            )
        self._to_blocks = jax.jit(from_planes) if self.uses_planes else None
        if config.use_icp_proposal:
            from fastslam_tpu.proposal.icp import icp_point_to_line

            self._icp = jax.jit(
                lambda s, t, sv, tv: icp_point_to_line(s, t, sv, tv, config)
            )
            self._prev_scan = None
        # production mode: ONE dispatch per online tick (ICP proposal +
        # frontend + tracking + filter step fused under a single jit), so
        # the host waits on one round trip per tick, not three.  Parity
        # mode keeps the split path: its bit-compatibility with the NumPy
        # oracle is certified per-jit, and fusing changes XLA's fusion
        # choices (float-tolerance, not bit-exact).
        self._fused = None
        self._prev_scan_dev = None
        self._prev2_scan_dev = None
        if not config.parity_mode and config.fuse_online_tick:
            self._fused = self._build_fused_tick()

    # ------------------------------------------------------------ odometry
    def odometry(self, v: float, w: float, timestamp: float) -> tuple:
        """Control-command odometry (``robot.py:122-151``): mutually exclusive
        rotation/translation with the 0.6 simulator fudge on translation."""
        if self._prev_timestamp is None:
            dt = 0.0
        else:
            dt = timestamp - self._prev_timestamp
        self._prev_timestamp = timestamp
        if v != 0:
            return 0.0, v * dt * self.config.velocity_fudge
        return w * dt, 0.0

    # ---------------------------------------------------------- ICP proposal
    def icp_refine(self, points: np.ndarray, valid: np.ndarray,
                   rotation: float, translation: float, v: float):
        """FastSLAM 2.0 motion proposal: refine the command odometry with an
        ICP scan-match between the previous and current scans.

        The match is WARM-STARTED with the command odometry: the previous
        scan is first transformed by the predicted motion, ICP estimates only
        the small residual, and the composite transform is converted back to
        (rotation, translation) odometry under the reference's convention
        (robot.py:90-120: translating ticks take |t|, rotating ticks the
        angle).  Without the warm start, large per-tick rotations alias along
        walls and ICP under-estimates turns by ~15%, which integrates into
        trajectory divergence.  With fixed blending, ``icp_blend``
        interpolates command vs match; with ``adaptive_proposal_floors``
        the shared :class:`~fastslam_tpu.proposal.adaptive.
        OnlineFloorEstimator` drives a translation-only MMSE blend and the
        proposal floors (same estimator as the batched replay and the
        fused tick).
        """
        import jax.numpy as jnp

        cur = (np.asarray(points, np.float32), np.asarray(valid))
        prev = self._prev_scan
        prev2 = getattr(self, "_prev2_scan", None)
        self._prev2_scan = prev
        self._prev_scan = cur
        if prev is None:
            self._prev_cmd = (float(rotation), float(translation))
            if self._adaptive_floors:
                # first tick: no residuals yet, but the step still reads
                # this tick's type floors/dial from the estimator's prior —
                # identical to the fused path's unconditional pre-dispatch
                # read
                k = int(v != 0)
                fxy, fth, a_xy, a_th, dial, d0 = self._floor_est.read(k)
                self._floor_xy, self._floor_th = fxy, fth
                self._blend_xy = a_xy
                self._blend_th = a_th
                self._bias_th = d0["b_th"]
                self._dial = dial
            return rotation, translation

        def match(src, src_valid, warm_ang, warm_t):
            """Warm-started composite SE(2) match src -> cur (elementwise
            rotations — proposal/icp.py numerics note)."""
            ca, sa = np.cos(warm_ang), np.sin(warm_ang)
            pre = np.stack([ca * src[:, 0] - sa * src[:, 1],
                            sa * src[:, 0] + ca * src[:, 1]], -1) + warm_t
            res = self._icp(
                jnp.asarray(pre, jnp.float32), jnp.asarray(cur[0]),
                jnp.asarray(src_valid), jnp.asarray(cur[1]),
            )
            th = float(res.theta)
            ct, st = np.cos(th), np.sin(th)
            t = np.array([ct * warm_t[0] - st * warm_t[1],
                          st * warm_t[0] + ct * warm_t[1]]) \
                + np.asarray(res.translation)
            return warm_ang + th, t

        ang, t_comp = match(prev[0], prev[1], -rotation,
                            np.array([-translation, 0.0], np.float32))
        if v != 0:
            # SIGNED along-track estimate: a perfect match gives
            # t_comp = (-trans, 0), so -t_comp[0] recovers trans WITH its
            # sign.  The reference-parity |t| norm (robot.py:90-120,
            # icp_odometry) re-signs a negative (slip-corrupted) command
            # positive when the matcher tracks it — measured injecting
            # 2x-command errors on slip seed 3 (round-5 forensics).
            icp_rot, icp_trans = 0.0, float(-t_comp[0])
        else:
            icp_rot, icp_trans = float(-ang), 0.0

        if self._adaptive_floors:
            from fastslam_tpu.proposal import adaptive

            k = int(v != 0)
            sr, al, la = adaptive.se2_residuals(
                np.array([ang], np.float32),
                np.array([t_comp], np.float32),
                np.array([0.0, rotation], np.float32),
                np.array([0.0, translation], np.float32),
            )
            kw = dict(sr_th=float(sr[1]), sr_al=float(al[1]),
                      lat=float(la[1]))
            if prev2 is not None:
                rot_prev, trans_prev = self._prev_cmd
                cp, sp = np.cos(-rotation), np.sin(-rotation)
                warm2_t = np.array([
                    cp * -trans_prev, sp * -trans_prev], np.float32) \
                    + np.array([-translation, 0.0], np.float32)
                dir_ang, dir_t = match(prev2[0], prev2[1],
                                       -(rot_prev + rotation), warm2_t)
                pa, pt = self._prev_se2[0], self._prev_se2[1:]
                d_ang, d_t2 = adaptive.consistency_discrepancy(
                    np.array([pa, ang], np.float32),
                    np.array([pt, t_comp], np.float32),
                    np.array([dir_ang], np.float32),
                    np.array([dir_t], np.float32),
                )
                kw.update(d_ang=float(d_ang[0]), d_t2=float(d_t2[0]))
            self._prev_se2 = (ang, float(t_comp[0]), float(t_comp[1]))
            self._prev_cmd = (float(rotation), float(translation))
            # read floors/blend/dial for THIS tick BEFORE pushing its
            # residual — same semantics as the fused one-dispatch path
            # (residuals through t-1, this tick's OWN type k), so the two
            # production paths cannot drift apart; also causal for the
            # blend (the residual measures the very match being blended)
            fxy, fth, a_xy, a_th, dial, diag = self._floor_est.read(k)
            a_t = a_xy
            # rotation blend is gated (engages only under sustained
            # rotation slip) and uses the DEBIASED match — adaptive.py
            a_r = a_th
            if a_r and v == 0:
                icp_rot -= diag["b_th"]
            # per-tick match-failure gate: the lateral residual is pure
            # matcher error — a failed (aliased) match must fall back to
            # the command for this tick (config.blend_match_gate)
            if abs(float(t_comp[1])) > diag["lat_gate"]:
                a_t = a_r = 0.0
            self._floor_est.push(k, **kw)
            self._floor_xy, self._floor_th = fxy, fth
            self._blend_xy = a_xy
            self._blend_th = a_th
            self._bias_th = diag["b_th"]
            self._dial = dial
        else:
            self._prev_cmd = (float(rotation), float(translation))
            a_r = a_t = self.config.icp_blend
        return (
            (1.0 - a_r) * rotation + a_r * icp_rot,
            (1.0 - a_t) * translation + a_t * icp_trans,
        )

    # --------------------------------------------------------- fused tick
    def _build_fused_tick(self):
        """One jitted function for the WHOLE tick: (optional) warm-started
        ICP odometry refinement (+ the two-step consistency match for the
        host-side adaptive-floor estimator), (optional) corner tracking,
        scan->measurement frontend, and the filter step.

        The split loop issues 2-3 dispatches per tick (frontend, ICP, step);
        this issues exactly one.  The in-jit ICP epilogue mirrors
        :meth:`icp_refine` (jnp float32 instead of host float64 —
        float-tolerance equivalent).
        Adaptive floors and the translation blend arrive as TRACED scalars
        computed by the host :class:`~fastslam_tpu.proposal.adaptive.
        OnlineFloorEstimator` from the previous ticks' residuals (one-tick
        coefficient lag; the residuals themselves are current).

        Returns ``(state, tracks_or_None, out[14])`` with
        ``out = [est_x, est_y, est_yaw, rot_used, trans_used, n_meas,
        floor_xy, floor_th, ang, t_x, t_y, dir_ang, dir_tx, dir_ty]`` so
        the host reads ONE small array per tick (the last six feed the
        estimator: single-step SE(2) match and direct two-step match).
        """
        config = self.config
        use_icp = config.use_icp_proposal
        track = config.track_corners
        floors_on = self._adaptive_floors
        step_fn = (kernels.fastslam_step_planes if self.uses_planes
                   else kernels.fastslam_step)
        if use_icp:
            from fastslam_tpu.proposal.icp import (
                icp_point_to_line, rotate_points,
            )
        if track:
            from fastslam_tpu.frontend.pipeline import (
                extract_corners, measurements_from_corners,
            )
            from fastslam_tpu.frontend.tracking import (
                stable_corners, update_tracks,
            )

        def fused(state, tracks, pts, valid, prev_pts, prev_valid,
                  prev2_pts, prev2_valid, rotation, translation,
                  rot_prev, trans_prev, v_active, has_prev, fxy, fth, a_xy,
                  a_th, b_th, lat_gate, dial):
            rotation = jnp.float32(rotation)
            translation = jnp.float32(translation)
            ang = jnp.float32(0.0)
            t_comp = jnp.zeros(2, jnp.float32)
            dir_ang = jnp.float32(0.0)
            dir_t = jnp.zeros(2, jnp.float32)
            if use_icp:
                # warm start with the command odometry (see icp_refine);
                # rotations applied elementwise, composed by angle addition —
                # a `pts @ R.T` matmul may run at reduced precision (TF32 on
                # the GPU) and quantize ~10 m coordinates to cm (proposal/
                # icp.py numerics note)
                pre = (rotate_points(prev_pts, -rotation)
                       - jnp.stack([translation, jnp.float32(0.0)]))
                res = icp_point_to_line(pre, pts, prev_valid, valid, config)
                # composite prev->cur: angle res.theta + (-rotation);
                # t = R(res.theta) [-translation, 0] + res.translation
                ang = res.theta - rotation
                t_comp = (rotate_points(
                    jnp.stack([-translation, jnp.float32(0.0)]), res.theta)
                    + res.translation)
                # SIGNED along-track estimate (-t_comp[0]): the |t| norm
                # re-signs a negative slip-corrupted command positive
                # (split-path icp_refine rationale)
                icp_trans = jnp.where(v_active, -t_comp[0], 0.0)
                # rotation-tick match, DEBIASED by the estimator's running
                # bias estimate (only consumed when the gated rotation
                # blend a_th is nonzero — adaptive.py)
                icp_rot = jnp.where(v_active, 0.0, -ang - jnp.float32(b_th))
                if floors_on:
                    # direct two-step match scan(t-2)->scan(t) for the
                    # online matcher-noise calibration (the host estimator
                    # compares it with the composition of the single-step
                    # matches — proposal/adaptive.py)
                    warm2_ang = -(rot_prev + rotation)
                    warm2_t = (rotate_points(
                        jnp.stack([-trans_prev, jnp.float32(0.0)]),
                        -rotation)
                        + jnp.stack([-translation, jnp.float32(0.0)]))
                    pre2 = rotate_points(prev2_pts, warm2_ang) + warm2_t
                    res2 = icp_point_to_line(pre2, pts, prev2_valid, valid,
                                             config)
                    dir_ang = warm2_ang + res2.theta
                    dir_t = (rotate_points(warm2_t, res2.theta)
                             + res2.translation)
                    # MMSE blends from the host estimator; the rotation
                    # blend is gated (nonzero only under sustained
                    # rotation slip — adaptive.py rationale).  Per-tick
                    # match-failure gate: the lateral residual is pure
                    # matcher error, so a tick far outside the running
                    # lateral scale is a failed match — fall back to the
                    # command for this tick (config.blend_match_gate)
                    match_ok = (jnp.abs(t_comp[1])
                                < jnp.float32(lat_gate)).astype(jnp.float32)
                    a_r = jnp.float32(a_th) * match_ok
                    a_t = jnp.float32(a_xy) * match_ok
                else:
                    a_r = a_t = jnp.float32(config.icp_blend)
                rotation = jnp.where(
                    has_prev, (1 - a_r) * rotation + a_r * icp_rot, rotation
                )
                translation = jnp.where(
                    has_prev, (1 - a_t) * translation + a_t * icp_trans,
                    translation,
                )
            if track:
                corners, cvalid = extract_corners(pts, valid, config)
                tracks = update_tracks(
                    tracks, corners, cvalid, rotation, translation,
                    gate=config.track_gate, ema=config.track_ema,
                    max_misses=config.track_max_misses,
                )
                pos, _ids, ok = stable_corners(
                    tracks, min_hits=config.track_min_hits
                )
                ms = measurements_from_corners(pos, ok, config)
            else:
                ms = scan_to_measurements(pts, valid, config)
            if floors_on:
                state, est = step_fn(state, rotation, translation, ms,
                                     config, proposal_floors=(fxy, fth),
                                     evidence_scale=dial)
            else:
                state, est = step_fn(state, rotation, translation, ms, config)
            n_meas = jnp.sum(ms.valid).astype(jnp.float32)
            out = jnp.concatenate([
                est,
                jnp.stack([rotation, translation, n_meas,
                           jnp.float32(fxy), jnp.float32(fth),
                           ang, t_comp[0], t_comp[1],
                           dir_ang, dir_t[0], dir_t[1]]),
            ])
            return state, tracks, out

        return jax.jit(fused, donate_argnums=(0,))

    def tick_fused(self, points: np.ndarray, valid: np.ndarray,
                   rotation: float, translation: float, v: float) -> np.ndarray:
        """Production one-dispatch tick: ICP refine + frontend + step fused.

        Semantics match ``icp_refine(...)`` followed by ``tick(...)`` (to
        float32 tolerance); the warmup dead-reckoning gate uses the refined
        odometry exactly as the split path does.
        """
        pts = jnp.asarray(points, jnp.float32)
        vld = jnp.asarray(valid)
        has_prev = has_prev2 = False
        prev_pts = prev_valid = prev2_pts = prev2_valid = None
        if self.config.use_icp_proposal:
            prev = self._prev_scan_dev
            prev2 = self._prev2_scan_dev
            self._prev2_scan_dev = prev
            self._prev_scan_dev = (pts, vld)
            has_prev = prev is not None
            has_prev2 = prev2 is not None
            prev_pts, prev_valid = prev if has_prev else (pts, vld)
            prev2_pts, prev2_valid = prev2 if has_prev2 else (pts, vld)
        tracks = self._tracks if self.config.track_corners else None
        rot_prev, trans_prev = self._prev_cmd
        self._prev_cmd = (float(rotation), float(translation))
        k = int(v != 0)
        if self._adaptive_floors:
            # floors/blend/dial for THIS tick: residuals through tick t-1
            # (the unavoidable one-tick data lag of the fused dispatch) but
            # read at tick t's OWN type — with the previous combined
            # update, every type transition traced the OTHER type's floors
            # (e.g. entering each turn at the translation type's fully
            # annealed theta floor — advisor round 3)
            fxy, fth, a_xy, a_th, dial, diag = self._floor_est.read(k)
            self._floor_xy, self._floor_th = fxy, fth
            self._blend_xy = a_xy
            self._blend_th = a_th
            self._bias_th = diag["b_th"]
            self._lat_gate = diag["lat_gate"]
            self._dial = dial
        self.state, tracks, out = self._fused(
            self.state, tracks, pts, vld, prev_pts, prev_valid,
            prev2_pts, prev2_valid,
            np.float32(rotation), np.float32(translation),
            np.float32(rot_prev), np.float32(trans_prev),
            bool(v != 0), bool(has_prev),
            np.float32(self._floor_xy), np.float32(self._floor_th),
            np.float32(self._blend_xy), np.float32(self._blend_th),
            np.float32(self._bias_th), np.float32(self._lat_gate),
            np.float32(self._dial),
        )
        if self.config.track_corners:
            self._tracks = tracks
        out = np.asarray(out)
        self._last_num_measurements = int(out[5])
        if self._adaptive_floors:
            # feed the estimator this tick's residuals; the NEXT tick reads
            # floors/blend/dial at its own type before dispatch
            from fastslam_tpu.proposal import adaptive
            ang, tx, ty = float(out[8]), float(out[9]), float(out[10])
            kw = {}
            if has_prev:
                sr, al, la = adaptive.se2_residuals(
                    np.array([ang], np.float32),
                    np.array([[tx, ty]], np.float32),
                    np.array([0.0, rotation], np.float32),
                    np.array([0.0, translation], np.float32),
                )
                kw.update(sr_th=float(sr[1]), sr_al=float(al[1]),
                          lat=float(la[1]))
            if has_prev2:
                pa, ptx, pty = self._prev_se2
                d_ang, d_t2 = adaptive.consistency_discrepancy(
                    np.array([pa, ang], np.float32),
                    np.array([[ptx, pty], [tx, ty]], np.float32),
                    np.array([out[11]], np.float32),
                    np.array([[out[12], out[13]]], np.float32),
                )
                kw.update(d_ang=float(d_ang[0]), d_t2=float(d_t2[0]))
            self._prev_se2 = (ang, tx, ty)
            self._floor_est.push(k, **kw)

        if self.iteration < self.config.warmup_iterations:
            rot_u, trans_u = float(out[3]), float(out[4])
            self.robot[2] = (
                self.robot[2] + rot_u + np.pi
            ) % (2 * np.pi) - np.pi
            self.robot[0] += trans_u * np.cos(self.robot[2])
            self.robot[1] += trans_u * np.sin(self.robot[2])
            self.iteration += 1
        else:
            self.robot = out[:3].astype(float).copy()
        return self.robot.copy()

    # ------------------------------------------------------------- one tick
    def tick(self, points: np.ndarray, valid: np.ndarray, rotation: float,
             translation: float) -> np.ndarray:
        """Run perception + filter for one tick; returns the pose estimate
        the application should adopt (respecting the warmup gate)."""
        if self.config.track_corners:
            self._tracks, ms = self._tracked_frontend(
                self._tracks, jnp.asarray(points, jnp.float32),
                jnp.asarray(valid), jnp.float32(rotation),
                jnp.float32(translation),
            )
        else:
            ms = self._frontend(
                jnp.asarray(points, jnp.float32), jnp.asarray(valid)
            )
        if self._adaptive_floors:
            self.state, est = self._step(
                self.state, jnp.float32(rotation), jnp.float32(translation),
                ms, jnp.float32(self._floor_xy), jnp.float32(self._floor_th),
                jnp.float32(self._dial),
            )
        else:
            self.state, est = self._step(
                self.state, jnp.float32(rotation), jnp.float32(translation), ms
            )
        est = np.asarray(est)

        if self.iteration < self.config.warmup_iterations:
            # dead-reckon (jde_robots_main.py:41-49)
            self.robot[2] = (self.robot[2] + rotation + np.pi) % (2 * np.pi) - np.pi
            self.robot[0] += translation * np.cos(self.robot[2])
            self.robot[1] += translation * np.sin(self.robot[2])
            self.iteration += 1
        else:
            self.robot = est.astype(float).copy()
        self._last_num_measurements = int(np.asarray(ms.valid).sum())
        return self.robot.copy()

    def state_blocks(self) -> FilterState:
        """The filter state in the [P, L, k] block layout, for consumers
        (health monitor, viz clustering, checkpoint).  A no-op for the blocks
        engine; a jitted layout conversion for the planes engine."""
        if self.uses_planes:
            return self._to_blocks(self.state)
        return self.state

    def set_state_blocks(self, state: FilterState) -> None:
        """Install a block-layout state (e.g. after health recovery)."""
        self.state = (to_planes(state, self.config) if self.uses_planes
                      else state)


def run_driver(
    driver: Driver,
    config: FastSLAMConfig,
    max_ticks: int = 10_000,
    rng: int = 0,
    *,
    serialize_path: Optional[str] = None,
    serialize_every: int = 1,
    metrics_path: Optional[str] = None,
    checkpoint_path: Optional[str] = None,
    checkpoint_every: int = 200,
    health: bool = False,
    odometry_noise: tuple = (0.0, 0.0),
    odometry_noise_seed: int = 123,
) -> RunHistory:
    """Drive the full loop against any :class:`Driver` until it is exhausted.

    Optional production hooks (all off by default, zero overhead when unused):
    viewer-JSON snapshots every ``serialize_every`` ticks (the reference's
    Serializer flow, jde_robots_main.py:59), JSONL metrics, periodic
    checkpoints, and health monitoring with automatic recovery.
    """
    runner = SLAMRunner(config, rng)
    history = RunHistory()

    # optional wheel-slip-style corruption of the odometry the filter sees
    # (rotation std, translation std); ground truth is unaffected
    odo_rng = np.random.default_rng(odometry_noise_seed)

    monitor = None
    if health:
        from fastslam_tpu.utils.health import HealthMonitor

        monitor = HealthMonitor(config)
    metrics = None
    if metrics_path:
        from fastslam_tpu.utils.logging_utils import MetricsLog

        metrics = MetricsLog(metrics_path)

    # ground-truth frame alignment: the filter's world frame is the robot's
    # start pose, so ground truth maps through the full SE(2) inverse of the
    # start pose.  (The reference only subtracts offsets —
    # evaluation_utils.py:46-55 — correct only for zero start yaw.)
    p0 = driver.get_pose()
    off = np.array([p0.x, p0.y, p0.yaw])
    c0, s0 = np.cos(-off[2]), np.sin(-off[2])

    running = True
    ticks = 0
    prev_cmd = (0.0, 0.0)
    while running and ticks < max_ticks:
        scan = driver.get_laser()
        points, valid = scan.to_points()

        if hasattr(driver, "commanded_velocity"):
            cur_cmd = driver.commanded_velocity()
        else:  # live policy (robot.py:61-88)
            bumper = driver.get_bumper()
            if bumper.state == 1:
                cur_cmd = (
                    0.0,
                    config.angular_velocity if bumper.bumper == 0
                    else -config.angular_velocity,
                )
            else:
                cur_cmd = (config.linear_velocity, 0.0)
            driver.set_velocity(*cur_cmd)

        # the scan at tick t reflects motion driven by tick t-1's commands, so
        # odometry over (t-1, t] must use the PREVIOUS commands.  (The
        # reference pairs the current commands with the past laser dt —
        # jde_robots_main.py:25-31 — an off-by-one that is harmless under
        # steady commands but 100% wrong during alternating bumper ticks.)
        v, w = prev_cmd
        prev_cmd = cur_cmd
        rotation, translation = runner.odometry(v, w, scan.timestamp)
        if odometry_noise != (0.0, 0.0):
            if rotation != 0.0:
                rotation += odo_rng.normal(0.0, odometry_noise[0])
            if translation != 0.0:
                translation += odo_rng.normal(0.0, odometry_noise[1])
        if runner._fused is not None:
            est = runner.tick_fused(points, valid, rotation, translation, v)
        else:
            if config.use_icp_proposal:
                rotation, translation = runner.icp_refine(
                    points, valid, rotation, translation, v
                )
            est = runner.tick(points, valid, rotation, translation)

        gp = driver.get_pose()
        dx, dy = gp.x - off[0], gp.y - off[1]
        gt = np.array([c0 * dx - s0 * dy, s0 * dx + c0 * dy,
                       (gp.yaw - off[2] + np.pi) % (2 * np.pi) - np.pi])
        history.est_poses.append(est)
        history.gt_poses.append(gt)
        ev = evaluate_tick(gt, est)
        history.evaluations.append(ev)
        history.num_measurements.append(runner._last_num_measurements)

        if monitor is not None:
            rep = monitor.check(runner.state_blocks(), est)
            if not rep.ok:
                if metrics:
                    metrics.write("health", tick=ticks, issues=rep.issues)
                if "nan_or_inf_state" in rep.issues:
                    runner.set_state_blocks(monitor.recover(
                        runner.state_blocks(), est,
                        checkpoint_path=checkpoint_path,
                    ))
        if metrics:
            metrics.write(
                "tick", tick=ticks, distance=ev.distance,
                num_measurements=runner._last_num_measurements,
            )
        if serialize_path and ticks % serialize_every == 0:
            from fastslam_tpu.frontend.global_map import cluster_known_landmarks
            from fastslam_tpu.io.serializer import serialize_tick

            cents, ok = cluster_known_landmarks(runner.state_blocks(), config)
            mask = np.asarray(ok)
            serialize_tick(
                est, gt, np.asarray(runner.state.poses),
                [tuple(map(float, c)) for c in np.asarray(cents)[mask]],
                ev.to_dict(), path=serialize_path,
            )
        if checkpoint_path and ticks and ticks % checkpoint_every == 0:
            from fastslam_tpu.io.checkpoint import save_checkpoint

            save_checkpoint(checkpoint_path, runner.state_blocks(),
                            iteration=ticks, robot_pose=runner.robot)

        running = driver.step()
        ticks += 1

    if metrics:
        metrics.close()
    if runner._adaptive_floors:
        history.final_floors = (runner._floor_xy, runner._floor_th)
        r0 = runner._floor_est.read(0)
        r1 = runner._floor_est.read(1)
        history.final_floors_by_type = ((r0[0], r0[1]), (r1[0], r1[1]))
    return history


def replay_inputs(log, config: FastSLAMConfig,
                  odometry_noise: tuple = (0.0, 0.0),
                  odometry_noise_seed: int = 123):
    """A recorded log as batched filter inputs, paired exactly as the online
    loop (:func:`run_driver`) pairs them.

    Returns ``(pts [T, B, 2], valid [T, B], rotations [T], translations
    [T], v_active [T])``: robot-frame scan points (LaserScan.to_points over
    all ticks), and command odometry over (t-1, t] from tick t-1's
    commands, with the optional wheel-slip corruption (one draw per ACTIVE
    component tick, same noise stream as :func:`run_driver`).
    """
    t_total = len(log)
    values = np.asarray(log.scans, np.float32)               # [T, B]
    n = values.shape[1]
    angles = np.radians(np.arange(n) - n // 2).astype(np.float32)
    valid = (values >= log.min_range) & (values <= log.max_range)
    pts = np.stack([values * np.cos(angles), values * np.sin(angles)],
                   axis=-1)
    pts[~valid] = 0.0

    rots = np.zeros(t_total, np.float32)
    trans = np.zeros(t_total, np.float32)
    v_active = np.zeros(t_total, bool)
    prev_ts = None
    prev_cmd = (0.0, 0.0)
    for t in range(t_total):
        v, w = prev_cmd
        prev_cmd = (float(log.cmd_v[t]), float(log.cmd_w[t]))
        ts = float(log.timestamps[t])
        dt = 0.0 if prev_ts is None else ts - prev_ts
        prev_ts = ts
        v_active[t] = v != 0
        if v != 0:
            trans[t] = v * dt * config.velocity_fudge
        else:
            rots[t] = w * dt

    if odometry_noise != (0.0, 0.0):
        odo_rng = np.random.default_rng(odometry_noise_seed)
        for t in range(t_total):
            if rots[t] != 0.0:
                rots[t] += odo_rng.normal(0.0, odometry_noise[0])
            if trans[t] != 0.0:
                trans[t] += odo_rng.normal(0.0, odometry_noise[1])
    return pts, valid, rots, trans, v_active


def replay_chunked(
    log,
    config: FastSLAMConfig,
    chunk_size: int = 8,
    rng: int = 0,
    *,
    odometry_noise: tuple = (0.0, 0.0),
    odometry_noise_seed: int = 123,
) -> RunHistory:
    """Offline batch replay through the multi-tick chunked planes engine.

    The online loop (:func:`run_driver`) must step tick-by-tick because each
    tick's commands depend on the last estimate; a recorded log has no such
    dependency, so the whole replay can run at the chunked engine's
    throughput: the frontend maps over every scan in ONE device dispatch
    (``lax.map``), then the filter consumes ``chunk_size`` ticks per fused
    kernel launch with each particle tile's landmark planes on chip
    (:func:`~fastslam_tpu.core.kernels.fastslam_steps_planes_chunked`);
    normalization/Neff/resampling run at chunk boundaries.  Leftover ticks
    (``T mod chunk_size``) go through the per-tick planes step.

    Odometry pairing, the dead-reckoning warmup gate, and ground-truth frame
    alignment match :func:`run_driver` exactly.  Production mode only.

    ``use_icp_proposal`` / ``adaptive_proposal_floors`` run fully batched
    (round-3 change; they previously required the per-tick loop): the ICP
    warm start uses the COMMAND odometry, never the filter estimate, so all
    T-1 consecutive-scan matches run in one ``lax.map`` dispatch; the
    adaptive-floor EMA is a host recurrence over the resulting residuals,
    and the per-tick floor vectors feed the chunked fs2 kernel as [C] prior
    rows.  Semantics match the online loop's fused tick to float tolerance.
    """
    import jax

    from fastslam_tpu.core.state import init_planes_state

    if config.parity_mode or not config.use_pallas:
        raise ValueError(
            "replay_chunked needs the planes engine in production mode "
            "(use_pallas=True, parity_mode=False)"
        )
    t_total = len(log)
    c = chunk_size
    pts, valid, rots, trans, v_active = replay_inputs(
        log, config, odometry_noise, odometry_noise_seed)

    # ---- frontend over all ticks in one dispatch ----
    frontend = lambda pv: scan_to_measurements(pv[0], pv[1], config)
    ms_all = jax.jit(
        lambda p, v: jax.lax.map(frontend, (p, v))
    )(jnp.asarray(pts), jnp.asarray(valid))    # Measurements [T, M, ...]

    # ---- batched ICP odometry refinement + adaptive floors ----
    # The online loop's ICP warm start uses the COMMAND odometry, not the
    # filter estimate (Runner.icp_refine), so a recorded log can run every
    # consecutive-scan match in ONE lax.map dispatch; the floors EMA is a
    # cheap host recurrence over the resulting residuals — the adaptive
    # stack needs no per-tick host loop after all.  Per-tick floor vectors
    # then feed the chunked fs2 kernel ([C] prior rows per invocation).
    floors_xy = floors_th = dial_sched = None
    if config.use_icp_proposal:
        from fastslam_tpu.proposal import adaptive
        from fastslam_tpu.proposal.icp import icp_point_to_line, rotate_points

        def match(prev_p, cur_p, prev_v, cur_v, warm_ang, warm_t):
            """ICP prev->cur warm-started with the SE(2) prediction
            (warm_ang, warm_t); returns the composite SE(2) (angle, t).

            Rotations are applied elementwise and composed by angle
            addition, NOT matmuls — a reduced-precision matmul quantizes
            ~10 m coordinates to cm (proposal/icp.py numerics note)."""
            pre = rotate_points(prev_p, warm_ang) + warm_t
            res = icp_point_to_line(pre, cur_p, prev_v, cur_v, config)
            return (warm_ang + res.theta,
                    rotate_points(warm_t, res.theta) + res.translation)

        def one_icp(inp):
            prev_p, cur_p, prev_v, cur_v, rot, tr, va = inp
            # warm start with the command odometry (Runner.icp_refine)
            ang, t_comp = match(
                prev_p, cur_p, prev_v, cur_v, -rot,
                jnp.stack([-tr, jnp.float32(0.0)]),
            )
            # SIGNED along-track estimate (Runner.icp_refine rationale)
            icp_tr = jnp.where(va, -t_comp[0], 0.0)
            icp_rot = jnp.where(va, 0.0, -ang)
            return icp_rot, icp_tr, ang, t_comp

        def two_step(inp):
            """Direct ICP scan(t-2) -> scan(t), command warm start.

            Used ONLY to calibrate the scan-matcher's own noise online:
            the discrepancy between this direct match and the composition
            of the two single-step matches is odometry-free (the true
            motion cancels), so its second moment estimates the ICP error
            that the adaptive floors must NOT mistake for odometry error."""
            p2, cur_p, v2, cur_v, rot1, tr1, rot2, tr2 = inp
            warm_ang = -(rot1 + rot2)
            warm_t = (rotate_points(jnp.stack([-tr1, jnp.float32(0.0)]),
                                    -rot2)
                      + jnp.stack([-tr2, jnp.float32(0.0)]))
            return match(p2, cur_p, v2, cur_v, warm_ang, warm_t)

        pts_j = jnp.asarray(pts)
        val_j = jnp.asarray(valid)
        icp_rots, icp_trs, angs, tvecs = jax.jit(
            lambda xs: jax.lax.map(one_icp, xs)
        )((
            pts_j[:-1], pts_j[1:], val_j[:-1], val_j[1:],
            jnp.asarray(rots[1:]), jnp.asarray(trans[1:]),
            jnp.asarray(v_active[1:]),
        ))
        icp_rots = np.concatenate([[0.0], np.asarray(icp_rots)])
        icp_trs = np.concatenate([[0.0], np.asarray(icp_trs)])

        d_ang = d_t2 = None
        if config.adaptive_proposal_floors and t_total >= 3:
            dir_ang, dir_t = jax.jit(
                lambda xs: jax.lax.map(two_step, xs)
            )((
                pts_j[:-2], pts_j[2:], val_j[:-2], val_j[2:],
                jnp.asarray(rots[1:-1]), jnp.asarray(trans[1:-1]),
                jnp.asarray(rots[2:]), jnp.asarray(trans[2:]),
            ))
            d_ang, d_t2 = adaptive.consistency_discrepancy(
                angs, tvecs, dir_ang, dir_t)

        if config.adaptive_proposal_floors:
            # floors, MMSE blends, and match-bias estimates from the SE(2)
            # residuals and the two-step scan-matcher-noise calibration —
            # the estimator lives in proposal/adaptive.py (unit-tested)
            sr_th, sr_al, lat = adaptive.se2_residuals(
                angs, tvecs, rots, trans)
            sched = adaptive.floor_schedule(
                sr_th, sr_al, lat, d_ang, d_t2, v_active, config)
            floors_xy, floors_th = sched.floors_xy, sched.floors_th
            dial_sched = sched.dial
            a_r, a_t = sched.blend_th, sched.blend_xy
            # translation ICP is unbiased (measured) — no debias.  The
            # rotation blend is gated (nonzero only under sustained
            # rotation slip) and consumes the DEBIASED match: subtract
            # the estimator's running rotation-bias estimate on rotation
            # ticks (adaptive.py rationale; same semantics as both
            # online paths)
            icp_rots = np.where(v_active, icp_rots,
                                icp_rots - sched.bias_th).astype(np.float32)
            # per-tick match-failure gate: |lateral residual| is pure
            # matcher error — zero this tick's blends on a failed match
            # (config.blend_match_gate; same semantics as both online
            # paths)
            bad = np.abs(lat) > sched.lat_gate
            a_r = np.where(bad, 0.0, a_r).astype(np.float32)
            a_t = np.where(bad, 0.0, a_t).astype(np.float32)
        else:
            a_r = a_t = np.full(t_total, config.icp_blend, np.float32)
        blend = np.arange(t_total) > 0  # tick 0 has no previous scan
        rots = np.where(blend, (1 - a_r) * rots + a_r * icp_rots,
                        rots).astype(np.float32)
        trans = np.where(blend, (1 - a_t) * trans + a_t * icp_trs,
                         trans).astype(np.float32)

    # ---- filter: scan over whole chunks, per-tick tail ----
    state = init_planes_state(config, rng)
    n_chunks = t_total // c

    rb = np.asarray(ms_all.range_bearing)
    mv = np.asarray(ms_all.valid)

    est = np.zeros((t_total, 3), np.float32)
    adaptive = floors_xy is not None
    if n_chunks:
        if adaptive:
            # per-tick [C] floor + mode-dial rows feed the fs2 prior for
            # each tick of the chunk (fs2_prior_scalars broadcasts [C])
            def chunk_body(s, inp):
                r, tr, z, zv, fxy, fth, g = inp
                s, e = kernels.fastslam_steps_planes_chunked(
                    s, r, tr, Measurements(z, zv), config,
                    proposal_floors=(fxy, fth), evidence_scale=g,
                )
                return s, e
        else:
            def chunk_body(s, inp):
                r, tr, z, zv = inp
                s, e = kernels.fastslam_steps_planes_chunked(
                    s, r, tr, Measurements(z, zv), config
                )
                return s, e

        run_chunks = jax.jit(
            lambda s, *xs: jax.lax.scan(chunk_body, s, xs),
            donate_argnums=0,
        )
        m = c * n_chunks
        xs = [
            jnp.asarray(rots[:m].reshape(n_chunks, c)),
            jnp.asarray(trans[:m].reshape(n_chunks, c)),
            jnp.asarray(rb[:m].reshape(n_chunks, c, *rb.shape[1:])),
            jnp.asarray(mv[:m].reshape(n_chunks, c, *mv.shape[1:])),
        ]
        if adaptive:
            xs += [jnp.asarray(floors_xy[:m].reshape(n_chunks, c)),
                   jnp.asarray(floors_th[:m].reshape(n_chunks, c)),
                   jnp.asarray(dial_sched[:m].reshape(n_chunks, c))]
        state, est_c = run_chunks(state, *xs)
        est[:m] = np.asarray(est_c).reshape(m, 3)

    if t_total % c:
        if adaptive:
            tick_step = jax.jit(
                lambda s, r, tr, z, zv, fxy, fth, g:
                kernels.fastslam_step_planes(
                    s, r, tr, Measurements(z, zv), config,
                    proposal_floors=(fxy, fth), evidence_scale=g,
                ),
                donate_argnums=0,
            )
        else:
            tick_step = jax.jit(
                lambda s, r, tr, z, zv: kernels.fastslam_step_planes(
                    s, r, tr, Measurements(z, zv), config
                ),
                donate_argnums=0,
            )
        for t in range(c * n_chunks, t_total):
            extra = ((jnp.float32(floors_xy[t]), jnp.float32(floors_th[t]),
                      jnp.float32(dial_sched[t]))
                     if adaptive else ())
            state, e = tick_step(
                state, jnp.float32(rots[t]), jnp.float32(trans[t]),
                jnp.asarray(rb[t]), jnp.asarray(mv[t]), *extra,
            )
            est[t] = np.asarray(e)

    # ---- warmup gate: dead-reckon exactly as the online loop ----
    robot = np.zeros(3)
    for t in range(min(config.warmup_iterations, t_total)):
        robot[2] = (robot[2] + rots[t] + np.pi) % (2 * np.pi) - np.pi
        robot[0] += trans[t] * np.cos(robot[2])
        robot[1] += trans[t] * np.sin(robot[2])
        est[t] = robot

    # ---- ground truth in the filter's start frame ----
    gts = np.asarray(log.gt_poses, np.float64)
    off = gts[0]
    c0, s0 = np.cos(-off[2]), np.sin(-off[2])
    dx, dy = gts[:, 0] - off[0], gts[:, 1] - off[1]
    gt = np.stack(
        [c0 * dx - s0 * dy, s0 * dx + c0 * dy,
         (gts[:, 2] - off[2] + np.pi) % (2 * np.pi) - np.pi], axis=-1,
    )

    history = RunHistory()
    history.est_poses = [e for e in est]
    history.gt_poses = [g for g in gt]
    history.num_measurements = [int(x) for x in mv.sum(axis=1)]
    if floors_xy is not None:
        history.final_floors = (float(floors_xy[-1]), float(floors_th[-1]))
        history.floor_traj = (floors_xy.copy(), floors_th.copy())
    for e, g in zip(est, gt):
        history.evaluations.append(evaluate_tick(g, e))
    return history
