"""The fused production online tick (ONE jitted dispatch per tick:
ICP proposal + frontend + tracking + filter step — app/runner.py).

The split path dispatches frontend / ICP / step separately; the fused path
waits on one host round trip per tick and is what production online runs
use.  These tests pin (a) agreement with the split path and (b) the full
ICP + fastslam2 + adaptive-floors stack running fused end to end.
"""

import numpy as np
import pytest

from fastslam_tpu.app.runner import SLAMRunner, run_driver
from fastslam_tpu.config import FastSLAMConfig
from fastslam_tpu.drivers.replay import ReplayDriver, record_log
from fastslam_tpu.drivers.sim_world import SimWorld


def _drive(runner_fused, runner_split, log, n):
    """Feed both runners the same scans/odometry; return per-tick poses."""
    drv = ReplayDriver(log)
    fused, split = [], []
    prev_cmd = (0.0, 0.0)
    for _ in range(n):
        scan = drv.get_laser()
        pts, valid = scan.to_points()
        v, w = prev_cmd
        prev_cmd = drv.commanded_velocity()
        rot_f, tr_f = runner_fused.odometry(v, w, scan.timestamp)
        # second runner keeps its own timestamp state; same inputs
        rot_s, tr_s = runner_split.odometry(v, w, scan.timestamp)
        assert (rot_f, tr_f) == (rot_s, tr_s)
        fused.append(runner_fused.tick_fused(pts, valid, rot_f, tr_f, v))
        if runner_split.config.use_icp_proposal:
            rot_s, tr_s = runner_split.icp_refine(pts, valid, rot_s, tr_s, v)
        split.append(runner_split.tick(pts, valid, rot_s, tr_s))
        if not drv.step():
            break
    return np.asarray(fused), np.asarray(split)


def test_fused_tick_matches_split_motion_mode():
    """Fused frontend+step vs the two-dispatch path: same math, one jit.
    Differences are XLA-fusion float noise only — poses must agree tightly
    over a short clean drive (no compounding through resample flips)."""
    log = record_log(SimWorld(seed=5), num_ticks=60)
    cfg = FastSLAMConfig(
        num_particles=128, max_landmarks=32, warmup_iterations=20,
        parity_mode=False, use_pallas=True, pallas_interpret=True,
    )
    r_fused = SLAMRunner(cfg, rng=0)
    assert r_fused._fused is not None
    r_split = SLAMRunner(cfg.replace(fuse_online_tick=False), rng=0)
    assert r_split._fused is None
    fused, split = _drive(r_fused, r_split, log, 60)
    np.testing.assert_allclose(fused, split, atol=1e-3)
    assert r_fused._last_num_measurements == r_split._last_num_measurements


@pytest.mark.slow
def test_fused_tick_matches_split_icp_floors():
    """The full production stack (ICP warm-started proposal, adaptive floors,
    fastslam2 sampling) fused into one dispatch vs the split path.  The
    in-jit ICP epilogue runs float32 where the host path ran float64, so the
    refined odometry matches to float tolerance; with identical RNG streams
    the trajectories stay close over a short drive."""
    log = record_log(SimWorld(seed=7), num_ticks=50)
    cfg = FastSLAMConfig(
        num_particles=128, max_landmarks=32, warmup_iterations=20,
        parity_mode=False, use_pallas=True, pallas_interpret=True,
        use_icp_proposal=True, icp_blend=0.0, proposal_mode="fastslam2",
        adaptive_proposal_floors=True,
    )
    r_fused = SLAMRunner(cfg, rng=0)
    r_split = SLAMRunner(cfg.replace(fuse_online_tick=False), rng=0)
    fused, split = _drive(r_fused, r_split, log, 50)
    np.testing.assert_allclose(fused, split, atol=5e-3)
    # adaptive floors track each other (same residual stream, float32 EMA)
    np.testing.assert_allclose(
        [r_fused._floor_xy, r_fused._floor_th],
        [r_split._floor_xy, r_split._floor_th], rtol=0.05, atol=1e-4,
    )


def test_run_driver_uses_fused_path_e2e():
    """run_driver on a production config goes through tick_fused and holds
    the accuracy bar; parity mode keeps the split path."""
    log = record_log(SimWorld(seed=3), num_ticks=200)
    cfg = FastSLAMConfig(
        num_particles=128, max_landmarks=32, warmup_iterations=100,
        parity_mode=False, use_pallas=True, pallas_interpret=True,
        use_icp_proposal=True, icp_blend=0.0, proposal_mode="fastslam2",
        adaptive_proposal_floors=True,
    )
    hist = run_driver(ReplayDriver(log), cfg, rng=0)
    assert len(hist.est_poses) == 200
    m = hist.metrics(skip=100)
    assert np.isfinite(m["ate_rmse_m"])
    assert m["ate_rmse_m"] < 0.15, m
    assert hist.final_floors is not None
    # clean sim: the adaptive floors anneal at/below the default
    assert hist.final_floors[0] <= cfg.proposal_xy_floor + 1e-6

    # parity mode: the fused builder is never constructed
    r = SLAMRunner(cfg.replace(
        parity_mode=True, use_pallas=False, proposal_mode="motion",
        use_icp_proposal=False, adaptive_proposal_floors=False,
    ))
    assert r._fused is None
