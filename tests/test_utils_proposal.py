"""Aux subsystems (profiling, health, logging) + the ICP motion proposal."""

import json

import numpy as np
import jax.numpy as jnp
import pytest

from fastslam_tpu.config import FastSLAMConfig
from fastslam_tpu.core.state import init_state


# ------------------------------------------------------------- profiling

def test_phase_timer_accumulates():
    import time

    from fastslam_tpu.utils.profiling import PhaseTimer

    pt = PhaseTimer()
    for _ in range(3):
        with pt.phase("work"):
            time.sleep(0.01)
    s = pt.summary()
    assert s["work"]["count"] == 3
    assert s["work"]["total_s"] >= 0.03
    assert "work" in pt.report()


# ---------------------------------------------------------------- health

def test_health_detects_nan_and_recovers():
    from fastslam_tpu.utils.health import HealthMonitor

    cfg = FastSLAMConfig(num_particles=16, max_landmarks=4)
    mon = HealthMonitor(cfg)
    st = init_state(cfg)
    ok = mon.check(st, np.zeros(3))
    assert ok.ok

    bad = st._replace(log_weights=st.log_weights.at[0].set(jnp.nan))
    rep = mon.check(bad, np.zeros(3))
    assert not rep.ok and "nan_or_inf_state" in rep.issues

    st2 = mon.recover(bad, np.array([1.0, 2.0, 0.1]))
    assert np.isfinite(np.asarray(st2.log_weights)).all()
    np.testing.assert_allclose(np.asarray(st2.poses[0]), [1.0, 2.0, 0.1], atol=1e-6)


def test_health_detects_degeneracy_and_jump():
    from fastslam_tpu.utils.health import HealthMonitor

    cfg = FastSLAMConfig(num_particles=16, max_landmarks=4)
    mon = HealthMonitor(cfg, degenerate_ticks_limit=3, max_step_jump_m=0.5)
    st = init_state(cfg)
    lw = np.full(16, -80.0, np.float32)
    lw[0] = 0.0  # all mass on one particle
    bad = st._replace(log_weights=jnp.asarray(lw))
    reports = [mon.check(bad, np.zeros(3)) for _ in range(3)]
    assert "weight_degeneracy" in reports[-1].issues

    mon2 = HealthMonitor(cfg, max_step_jump_m=0.5)
    mon2.check(st, np.zeros(3))
    rep = mon2.check(st, np.array([3.0, 0.0, 0.0]))
    assert "estimate_jump" in rep.issues


def test_health_recover_from_checkpoint(tmp_path):
    from fastslam_tpu.io.checkpoint import save_checkpoint
    from fastslam_tpu.utils.health import HealthMonitor

    cfg = FastSLAMConfig(num_particles=8, max_landmarks=4)
    good = init_state(cfg, rng=1)._replace(lm_count=jnp.full((8,), 2, jnp.int32))
    path = str(tmp_path / "ck.npz")
    save_checkpoint(path, good)

    mon = HealthMonitor(cfg)
    bad = good._replace(log_weights=good.log_weights.at[0].set(jnp.inf))
    st = mon.recover(bad, np.zeros(3), checkpoint_path=path)
    np.testing.assert_array_equal(np.asarray(st.lm_count), np.full(8, 2))


# ---------------------------------------------------------------- logging

def test_metrics_log_jsonl(tmp_path):
    from fastslam_tpu.utils.logging_utils import MetricsLog, get_logger

    path = str(tmp_path / "metrics.jsonl")
    ml = MetricsLog(path)
    ml.write("tick", ate=0.1, neff=12.0)
    ml.write("resample", tick=5)
    ml.close()
    lines = [json.loads(l) for l in open(path)]
    assert lines[0]["kind"] == "tick" and lines[0]["ate"] == 0.1
    assert lines[1]["kind"] == "resample"

    log = get_logger("test-fastslam")
    log.info("hello")  # no crash, single handler
    assert len(log.handlers) == 1


# ----------------------------------------------------------- ICP proposal

@pytest.mark.slow
def test_icp_proposal_corrects_biased_odometry():
    """With a wrong velocity fudge the command odometry is biased; the ICP
    scan-match proposal must recover most of the lost accuracy."""
    from fastslam_tpu.app.runner import run_driver
    from fastslam_tpu.drivers.replay import ReplayDriver, record_log
    from fastslam_tpu.drivers.sim_world import SimWorld
    from fastslam_tpu.eval.metrics import ate_rmse

    log = record_log(SimWorld(seed=7), num_ticks=100)

    def run(**kw):
        cfg = FastSLAMConfig(
            num_particles=32, max_landmarks=16, warmup_iterations=1000,
            velocity_fudge=0.75,  # wrong: sim uses 0.6 -> 25% odometry bias
            **kw,
        )
        hist = run_driver(ReplayDriver(log), cfg, rng=0)
        est = np.asarray(hist.est_poses)
        gt = np.asarray(hist.gt_poses)
        return ate_rmse(gt[:, :2], est[:, :2])

    ate_cmd = run()
    ate_icp = run(use_icp_proposal=True, icp_blend=1.0)
    assert ate_icp < ate_cmd * 0.6, f"cmd {ate_cmd:.3f} vs icp {ate_icp:.3f}"


def test_compile_cache_dir_rule(monkeypatch):
    """JAX_COMPILATION_CACHE_DIR when set, else a fixed .jax_cache/ at the
    checkout root — never a directory under the user's home."""
    import os

    from fastslam_tpu.utils.compile_cache import compile_cache_dir

    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "/somewhere/cache")
    assert compile_cache_dir() == "/somewhere/cache"
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert compile_cache_dir() == os.path.join(root, ".jax_cache")
    assert not compile_cache_dir().startswith(os.path.expanduser("~") + "/.")
