"""Simulator, replay, and end-to-end SLAM-on-replay tests (SURVEY.md §4:
the fake-backend + replay fixtures the reference never had)."""

import numpy as np
import pytest

from fastslam_tpu.config import FastSLAMConfig
from fastslam_tpu.drivers.replay import LaserLog, ReplayDriver, record_log
from fastslam_tpu.drivers.sim_world import SimWorld
from fastslam_tpu.app.runner import run_driver
from fastslam_tpu.eval.metrics import ate_rmse, evaluate_tick


def test_sim_laser_geometry():
    from fastslam_tpu.drivers.sim_world import rectangle

    w = SimWorld(segments=rectangle(-5.0, -4.0, 5.0, 4.0))  # empty room
    scan = w.get_laser()
    pts, valid = scan.to_points()
    assert valid.sum() > 100
    # beam 90 points straight ahead (+x): wall at x=5
    assert scan.values[90] == pytest.approx(5.0, abs=1e-6)
    # beam 0 points at -90deg (-y): wall at y=-4
    assert scan.values[0] == pytest.approx(4.0, abs=1e-6)


def test_sim_bumper_and_motion():
    w = SimWorld(x=4.8, y=0.5, yaw=0.0)  # 0.2m from the +x wall at 5.0
    assert w.get_bumper().state == 1
    w2 = SimWorld(x=0.0, y=0.0, yaw=0.0)
    assert w2.get_bumper().state == 0
    w2.set_velocity(1.0, 0.0)
    w2.step()
    # 40% velocity absorption (robot.py:144 compensation)
    assert w2.x == pytest.approx(1.0 * 0.6 * w2.dt, abs=1e-9)


def test_record_and_replay_round_trip(tmp_path):
    world = SimWorld(seed=1)
    log = record_log(world, num_ticks=50)
    path = str(tmp_path / "log.npz")
    log.save(path)
    loaded = LaserLog.load(path)
    np.testing.assert_array_equal(loaded.scans, log.scans)
    np.testing.assert_array_equal(loaded.gt_poses, log.gt_poses)

    drv = ReplayDriver(loaded)
    n = 1
    while drv.step():
        n += 1
    assert n == 50


def test_evaluate_tick_formulas():
    ev = evaluate_tick((1.0, 2.0, np.pi / 2), (0.5, 2.0, 0.0))
    assert ev.x_deviation == pytest.approx(50.0)
    assert ev.y_deviation == pytest.approx(0.0)
    assert ev.angular_deviation == pytest.approx(50.0)
    assert ev.distance == pytest.approx(0.5)
    assert ev.average_deviation == pytest.approx(100.0 / 3)


@pytest.mark.slow
def test_e2e_slam_on_replay_log():
    """Full pipeline on a short synthetic log: dead-reckoning warmup tracks
    odometry; the filter produces finite estimates and a sane map."""
    world = SimWorld(seed=2)
    log = record_log(world, num_ticks=120)
    cfg = FastSLAMConfig(
        num_particles=64,
        max_landmarks=32,
        warmup_iterations=60,
    )
    hist = run_driver(ReplayDriver(log), cfg, rng=0)
    assert len(hist.est_poses) == 120
    est = np.asarray(hist.est_poses)
    gt = np.asarray(hist.gt_poses)
    assert np.isfinite(est).all()
    # during warmup the estimate is pure dead reckoning == noiseless odometry
    # integration of the same commands; in this noise-free sim it must track
    # ground truth closely
    warm_ate = ate_rmse(gt[:60, :2], est[:60, :2])
    assert warm_ate < 0.3, f"warmup dead-reckoning ATE {warm_ate}"
    # over the whole run the estimate should stay in the room
    full_ate = ate_rmse(gt[:, :2], est[:, :2])
    assert full_ate < 1.5, f"full-run ATE {full_ate}"


@pytest.mark.slow
def test_run_driver_production_hooks(tmp_path):
    """serialize/metrics/checkpoint/health hooks all active in one run."""
    import json

    from fastslam_tpu.drivers.replay import record_log, ReplayDriver
    from fastslam_tpu.io.serializer import deserialize_tick

    log = record_log(SimWorld(seed=9), num_ticks=60)
    cfg = FastSLAMConfig(num_particles=32, max_landmarks=16, warmup_iterations=30)
    shared = str(tmp_path / "fast_slam.json")
    metrics = str(tmp_path / "metrics.jsonl")
    ckpt = str(tmp_path / "ck.npz")

    hist = run_driver(
        ReplayDriver(log), cfg, rng=0,
        serialize_path=shared, serialize_every=10,
        metrics_path=metrics, checkpoint_path=ckpt, checkpoint_every=25,
        health=True,
    )
    assert len(hist.est_poses) == 60

    snap = deserialize_tick(shared)
    assert snap is not None and len(snap["particles"]) == 32

    recs = [json.loads(l) for l in open(metrics)]
    assert sum(1 for r in recs if r["kind"] == "tick") == 60

    from fastslam_tpu.io.checkpoint import load_checkpoint
    st, meta = load_checkpoint(ckpt)
    assert meta["iteration"] in (25, 50)
    assert st.poses.shape == (32, 3)


def test_runner_planes_engine_matches_blocks():
    """The kernel on the planes state (layout carried between ticks) must
    produce the same trajectory as the XLA path on the blocks state:
    identical RNG stream and arithmetic, another layout and compiler."""
    from fastslam_tpu.app.runner import run_driver
    from fastslam_tpu.config import FastSLAMConfig
    from fastslam_tpu.drivers.replay import ReplayDriver, record_log
    from fastslam_tpu.drivers.sim_world import SimWorld

    log = record_log(SimWorld(seed=11), num_ticks=60)
    base = FastSLAMConfig(
        num_particles=128, max_landmarks=16, warmup_iterations=10,
        use_pallas=True, pallas_interpret=True,
    )
    h_blocks = run_driver(
        ReplayDriver(log), base.replace(use_pallas=False), rng=0
    )
    h_planes = run_driver(
        ReplayDriver(log), base, rng=0
    )
    np.testing.assert_allclose(
        np.asarray(h_planes.est_poses), np.asarray(h_blocks.est_poses),
        rtol=1e-5, atol=1e-5,
    )


def test_runner_with_corner_tracking():
    """track_corners=True end to end: the ego-compensated identity tracker
    sits between corner detection and the filter; ATE stays bounded."""
    from fastslam_tpu.app.runner import run_driver
    from fastslam_tpu.config import FastSLAMConfig
    from fastslam_tpu.drivers.replay import ReplayDriver, record_log
    from fastslam_tpu.drivers.sim_world import SimWorld

    log = record_log(SimWorld(seed=3), num_ticks=200)
    cfg = FastSLAMConfig(
        num_particles=64, max_landmarks=32, warmup_iterations=100,
        parity_mode=False, track_corners=True,
    )
    hist = run_driver(ReplayDriver(log), cfg, rng=0)
    m = hist.metrics()
    assert np.isfinite(m["ate_rmse_m"])
    assert m["ate_rmse_m"] < 0.15, m


@pytest.mark.slow
def test_replay_chunked_matches_per_tick_accuracy():
    """The offline chunked replay (C ticks per fused kernel, resampling at
    chunk boundaries) must hold the per-tick production path's accuracy on
    the standard drive: chunk=8 measured ~8% relative ATE cost (0.0187 vs
    0.0172 m), far inside the production bar."""
    from fastslam_tpu.app.runner import replay_chunked, run_driver
    from fastslam_tpu.drivers.replay import ReplayDriver, record_log
    from fastslam_tpu.drivers.sim_world import SimWorld

    log = record_log(SimWorld(seed=3), num_ticks=230)
    cfg = FastSLAMConfig(
        num_particles=128, max_landmarks=32, warmup_iterations=150,
        parity_mode=False, use_pallas=True, pallas_interpret=True,
    )
    h_tick = run_driver(ReplayDriver(log), cfg, rng=0)
    h_chunk = replay_chunked(log, cfg, chunk_size=8, rng=0)  # 230 = 28*8 + 6

    ate_tick = h_tick.metrics()["ate_rmse_m"]
    ate_chunk = h_chunk.metrics()["ate_rmse_m"]
    assert ate_chunk < 0.1, ate_chunk
    assert ate_chunk < ate_tick * 2.0 + 0.01, (ate_tick, ate_chunk)
    # same tick count, finite estimates, warmup dead-reckoning applied
    assert len(h_chunk.est_poses) == len(log)
    est = np.asarray(h_chunk.est_poses)
    assert np.isfinite(est).all()
    np.testing.assert_allclose(
        np.asarray(h_tick.est_poses)[:150], est[:150], atol=1e-5
    )

    # parity mode must refuse the chunked replay
    import pytest

    with pytest.raises(ValueError, match="planes engine in production"):
        replay_chunked(log, cfg.replace(parity_mode=True), chunk_size=8)


def test_replay_chunked_fs2_tracks():
    """The chunked engine with the fused FastSLAM 2.0 proposal: measurement-
    informed sampling + evidence weighting inside the multi-tick kernel.
    Accuracy bar: must track the drive (fs2 at the default real-robot floors
    is looser than motion-mode on CLEAN sim odometry — see EVAL.md — so the
    bar is the fs2 per-tick figure, not the motion-mode one)."""
    from fastslam_tpu.app.runner import replay_chunked
    from fastslam_tpu.drivers.replay import record_log
    from fastslam_tpu.drivers.sim_world import SimWorld

    log = record_log(SimWorld(seed=3), num_ticks=230)
    cfg = FastSLAMConfig(
        num_particles=128, max_landmarks=32, warmup_iterations=150,
        parity_mode=False, proposal_mode="fastslam2",
        use_pallas=True, pallas_interpret=True,
    )
    h = replay_chunked(log, cfg, chunk_size=4, rng=0)
    est = np.asarray(h.est_poses)
    assert np.isfinite(est).all()
    assert h.metrics(skip=150)["ate_rmse_m"] < 0.25


def test_replay_chunked_runs_the_adaptive_stack():
    """fs2 + batched-ICP + adaptive floors on the CHUNKED engine (round-3:
    the ICP warm start is command-odometry-only, so all matches batch into
    one dispatch and per-tick floor vectors feed the fs2 prior as [C] rows).
    Must track the drive at the per-tick adaptive path's accuracy class."""
    from fastslam_tpu.app.runner import replay_chunked
    from fastslam_tpu.drivers.replay import record_log
    from fastslam_tpu.drivers.sim_world import SimWorld

    log = record_log(SimWorld(seed=3), num_ticks=230)
    cfg = FastSLAMConfig(
        num_particles=128, max_landmarks=32, warmup_iterations=150,
        parity_mode=False, proposal_mode="fastslam2",
        use_icp_proposal=True, icp_blend=0.0, adaptive_proposal_floors=True,
        use_pallas=True, pallas_interpret=True,
    )
    h = replay_chunked(log, cfg, chunk_size=8, rng=0)
    est = np.asarray(h.est_poses)
    assert np.isfinite(est).all()
    # clean sim: residual-only floors anneal below the defaults, so the
    # adaptive run must BEAT the fixed-floor fs2 run above
    assert h.metrics(skip=150)["ate_rmse_m"] < 0.15
