"""FastSLAM 2.0 measurement-informed proposal (production mode)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from fastslam_tpu.config import FastSLAMConfig
from fastslam_tpu.core import kernels
from fastslam_tpu.core.state import init_state, pad_measurements


def seeded_state(cfg, true_pose=(1.0, 0.5, 0.3), landmarks=((4.0, 2.0), (-1.0, 3.0))):
    """All particles at true_pose with known landmarks in their maps."""
    st = init_state(cfg, rng=0)
    p = cfg.num_particles
    poses = np.tile(np.asarray(true_pose, np.float32), (p, 1))
    mean = np.zeros((p, cfg.max_landmarks, 2), np.float32)
    cov = np.zeros((p, cfg.max_landmarks, 4), np.float32)
    for j, lm in enumerate(landmarks):
        mean[:, j] = lm
        cov[:, j] = (2e-4, 0, 0, 2e-4)  # well-localized landmarks
    count = np.full(p, len(landmarks), np.int32)
    return st._replace(
        poses=jnp.asarray(poses), lm_mean=jnp.asarray(mean),
        lm_cov=jnp.asarray(cov), lm_count=jnp.asarray(count),
    )


def measurements_from(pose, landmarks, cfg):
    x, y, yaw = pose
    ms = []
    for lx, ly in landmarks:
        dx, dy = lx - x, ly - y
        r = np.hypot(dx, dy)
        b = (np.arctan2(dy, dx) - yaw + np.pi) % (2 * np.pi) - np.pi
        ms.append((r, b))
    return pad_measurements(cfg, np.asarray(ms))


def test_proposal_concentrates_particles():
    """With informative measurements the proposal's pose spread must be far
    tighter than the motion model's, and centred near the true pose."""
    cfg = FastSLAMConfig(
        num_particles=256, max_landmarks=4, max_measurements=4,
        parity_mode=False, proposal_mode="fastslam2",
        translation_noise=0.05,  # deliberately sloppy odometry
    )
    landmarks = ((4.0, 2.0), (-1.0, 3.0))
    true_prev = (1.0, 0.5, 0.0)
    st = seeded_state(cfg, true_prev, landmarks)
    # robot actually moved 0.30 m; odometry claims 0.25 m
    true_pose = (1.30, 0.5, 0.0)
    ms = measurements_from(true_pose, landmarks, cfg)

    noise = jax.random.normal(jax.random.key(1), (cfg.num_particles, 3))
    new_state, pose_pred = kernels.fastslam2_propose(
        st, jnp.float32(0.0), jnp.float32(0.25), ms, noise, cfg
    )
    sampled = np.asarray(new_state.poses)
    err = np.linalg.norm(sampled[:, :2] - np.asarray(true_pose[:2]), axis=1)

    # motion-only baseline for comparison
    rot_noise = np.zeros(cfg.num_particles, np.float32)
    trans_noise = 0.05 * np.asarray(
        jax.random.normal(jax.random.key(2), (cfg.num_particles,))
    )
    motion_poses = np.asarray(kernels.propagate_particles(
        st.poses, jnp.float32(0.0), jnp.float32(0.25),
        jnp.asarray(rot_noise), jnp.asarray(trans_noise),
    ))
    err_motion = np.linalg.norm(motion_poses[:, :2] - np.asarray(true_pose[:2]), axis=1)

    assert err.mean() < 0.5 * err_motion.mean(), (
        f"proposal err {err.mean():.4f} vs motion err {err_motion.mean():.4f}"
    )
    assert err.mean() < 0.05


def test_proposal_without_matches_falls_back_to_motion_prior():
    """No associated landmarks -> the proposal is just the motion prior."""
    cfg = FastSLAMConfig(
        num_particles=64, max_landmarks=4, max_measurements=4,
        parity_mode=False, proposal_mode="fastslam2",
    )
    st = seeded_state(cfg, landmarks=())  # empty maps
    ms = pad_measurements(cfg, np.zeros((0, 2)))
    noise = jax.random.normal(jax.random.key(3), (cfg.num_particles, 3))
    new_state, pose_pred = kernels.fastslam2_propose(
        st, jnp.float32(0.0), jnp.float32(0.3), ms, noise, cfg
    )
    # weights unchanged, poses near the predicted mean with motion spread
    np.testing.assert_allclose(
        np.asarray(new_state.log_weights), np.asarray(st.log_weights)
    )
    d = np.asarray(new_state.poses[:, 0]) - np.asarray(pose_pred[:, 0])
    assert 0.001 < d.std() < 0.02  # ~ translation_noise + floor


def test_full_step_fastslam2_runs_and_is_finite():
    cfg = FastSLAMConfig(
        num_particles=64, max_landmarks=16, max_measurements=4,
        parity_mode=False, proposal_mode="fastslam2",
    )
    st = init_state(cfg, rng=4)
    ms = pad_measurements(cfg, [(2.0, 0.3), (3.5, -0.7)])
    step = jax.jit(lambda s, r, t, m: kernels.fastslam_step(s, r, t, m, cfg))
    for _ in range(6):
        st, pose = step(st, jnp.float32(0.0), jnp.float32(0.4), ms)
    assert np.isfinite(np.asarray(pose)).all()
    assert np.isfinite(np.asarray(st.log_weights)).all()
    assert int(st.lm_count.max()) >= 1


@pytest.mark.slow
def test_fastslam2_tracks_with_tiny_particle_count_and_noisy_odometry():
    """End-to-end stability: at 4 particles with real zero-mean wheel-slip
    noise the FastSLAM 2.0 proposal must keep tracking (the decisive
    mechanism check — 2x tighter posterior sampling — is the unit test
    above; measured e2e means on this regime were fs2 0.138 vs motion
    0.151, a modest edge that is too seed-noisy to assert per-run)."""
    from fastslam_tpu.app.runner import run_driver
    from fastslam_tpu.drivers.replay import ReplayDriver, record_log
    from fastslam_tpu.drivers.sim_world import SimWorld
    from fastslam_tpu.eval.metrics import ate_rmse

    log = record_log(SimWorld(seed=21), num_ticks=220)

    def run(mode, seed):
        cfg = FastSLAMConfig(
            num_particles=4, max_landmarks=24, warmup_iterations=40,
            parity_mode=False, proposal_mode=mode,
            translation_noise=0.02,
        )
        hist = run_driver(
            ReplayDriver(log), cfg, rng=seed,
            odometry_noise=(0.02, 0.02), odometry_noise_seed=seed + 100,
        )
        est = np.asarray(hist.est_poses)
        gt = np.asarray(hist.gt_poses)
        return ate_rmse(gt[40:, :2], est[40:, :2])

    ates_fs2 = [run("fastslam2", s) for s in range(3)]
    assert np.mean(ates_fs2) < 0.25, f"fs2 diverged: {ates_fs2}"


@pytest.mark.slow
def test_adaptive_floors_track_the_real_odometry_error():
    """The floors must TUNE THEMSELVES to the regime: with clean odometry the
    ICP-vs-command residual is tiny and the floors anneal tight (well below
    the 0.01 default); under wheel slip the residual reflects the slip and
    the floors open toward its scale.  (With fixed floors either regime needs
    hand-tuning — config.py's 'TUNE TO THE REAL ODOMETRY ERROR' note.)"""
    from fastslam_tpu.app.runner import run_driver
    from fastslam_tpu.drivers.replay import ReplayDriver, record_log
    from fastslam_tpu.drivers.sim_world import SimWorld
    from fastslam_tpu.eval.metrics import ate_rmse

    log = record_log(SimWorld(seed=21), num_ticks=200)
    cfg = FastSLAMConfig(
        num_particles=32, max_landmarks=24, warmup_iterations=40,
        parity_mode=False, proposal_mode="fastslam2",
        use_icp_proposal=True, icp_blend=0.5,
        adaptive_proposal_floors=True,
    )

    clean = run_driver(ReplayDriver(log), cfg, rng=0)
    slip = run_driver(ReplayDriver(log), cfg, rng=0,
                      odometry_noise=(0.02, 0.02), odometry_noise_seed=7)

    fxy_clean, fth_clean = clean.final_floors
    fxy_slip, fth_slip = slip.final_floors
    # clean: annealed below the hand-tuned default
    assert fxy_clean < 0.01, fxy_clean
    # slip: opened well above clean.  Floors are PER TICK TYPE (slip hits
    # only the active component: rotation slip shows on rotation ticks,
    # where theta uncertainty actually exists) — so the theta comparison
    # uses the rotation-type read, not whichever type the run happened to
    # end on
    assert fxy_slip > 3 * fxy_clean, (fxy_clean, fxy_slip)
    (fxy0_c, fth0_c), _ = clean.final_floors_by_type
    (fxy0_s, fth0_s), _ = slip.final_floors_by_type
    assert fth0_s > 3 * fth0_c, (fth0_c, fth0_s)
    assert fxy_slip > 0.002, fxy_slip

    # both regimes keep tracking without per-regime hand-tuning
    for h in (clean, slip):
        est, gt = np.asarray(h.est_poses), np.asarray(h.gt_poses)
        assert ate_rmse(gt[40:, :2], est[40:, :2]) < 0.25


def test_adaptive_floors_require_icp_and_fs2():
    from fastslam_tpu.app.runner import SLAMRunner

    cfg = FastSLAMConfig(
        num_particles=8, parity_mode=False, adaptive_proposal_floors=True
    )
    with pytest.raises(ValueError, match="adaptive_proposal_floors"):
        SLAMRunner(cfg)


# ---------------------------------------------------------------------------
# fused in-kernel proposal (planes / chunked Pallas engines)
# ---------------------------------------------------------------------------

def _seeded_pair(n=128, l=16, m=4):
    """(blocks state, planes state) with identical populated maps."""
    from fastslam_tpu.core.state import to_planes

    cfg_b = FastSLAMConfig(
        num_particles=n, max_landmarks=l, max_measurements=m,
        parity_mode=False, proposal_mode="fastslam2",
    )
    cfg_p = cfg_b.replace(use_pallas=True, pallas_interpret=True)
    st = init_state(cfg_b, rng=0)
    seed_cfg = cfg_b.replace(proposal_mode="motion")
    ms = pad_measurements(cfg_b, [(2.0, 0.3), (3.0, -1.0), (1.5, 2.0)])
    st, _ = kernels.fastslam_step(st, jnp.float32(0.0), jnp.float32(0.3),
                                  ms, seed_cfg)
    st, _ = kernels.fastslam_step(st, jnp.float32(0.1), jnp.float32(0.0),
                                  ms, seed_cfg)
    return cfg_b, cfg_p, st, to_planes(st, cfg_p)


def test_planes_fs2_step_matches_blocks_path():
    """The fused proposal+EKF kernel must reproduce the XLA fs2 path
    (fastslam2_propose + scan EKF) to float tolerance — same RNG stream,
    same math; the only differences are the two compilers' rounding (~1e-7)
    and summation order."""
    from fastslam_tpu.core.state import from_planes

    cfg_b, cfg_p, st_b, st_p = _seeded_pair()
    ms = pad_measurements(cfg_b, [(2.1, 0.25), (2.9, -1.05)])

    nb, est_b = kernels.fastslam_step(
        st_b, jnp.float32(0.0), jnp.float32(0.3), ms, cfg_b
    )
    np_, est_p = kernels.fastslam_step_planes(
        st_p, jnp.float32(0.0), jnp.float32(0.3), ms, cfg_p
    )
    npb = from_planes(np_)
    np.testing.assert_allclose(np.asarray(nb.poses), np.asarray(npb.poses),
                               atol=2e-5)
    np.testing.assert_allclose(np.asarray(nb.log_weights),
                               np.asarray(npb.log_weights), atol=1e-4)
    np.testing.assert_allclose(np.asarray(nb.lm_mean),
                               np.asarray(npb.lm_mean), atol=2e-5)
    np.testing.assert_allclose(np.asarray(nb.lm_cov),
                               np.asarray(npb.lm_cov), atol=1e-6)
    np.testing.assert_array_equal(np.asarray(nb.lm_count),
                                  np.asarray(npb.lm_count))
    np.testing.assert_allclose(np.asarray(est_b), np.asarray(est_p), atol=2e-5)


def test_planes_fs2_respects_proposal_floors():
    """Traced floor overrides must reach the fused kernel: wider floors ->
    visibly wider pose spread (the adaptive-floors contract)."""
    cfg_b, cfg_p, _, st_p = _seeded_pair()
    ms = pad_measurements(cfg_b, np.zeros((0, 2)))  # no measurements

    tight, _ = kernels.fastslam_step_planes(
        st_p, jnp.float32(0.0), jnp.float32(0.3), ms, cfg_p,
        proposal_floors=(jnp.float32(1e-3), jnp.float32(1e-3)),
    )
    wide, _ = kernels.fastslam_step_planes(
        st_p, jnp.float32(0.0), jnp.float32(0.3), ms, cfg_p,
        proposal_floors=(jnp.float32(0.05), jnp.float32(0.05)),
    )
    assert float(jnp.std(wide.poses[:, 1])) > 5 * float(jnp.std(tight.poses[:, 1]))


def test_evidence_scale_zero_is_the_pure_motion_prior():
    """The mode dial at g=0 must make the fs2 proposal EXACTLY the motion
    prior sample: bit-identical to proposing with an empty landmark map
    (no associations -> Lambda = prior, eta = 0), same noise stream."""
    cfg_b, _, st_b, _ = _seeded_pair()
    ms = pad_measurements(cfg_b, [(2.1, 0.25), (2.9, -1.05)])
    noise = jax.random.normal(jax.random.PRNGKey(7),
                              (cfg_b.num_particles, 3))

    zeroed, _ = kernels.fastslam2_propose(
        st_b, jnp.float32(0.0), jnp.float32(0.3), ms, noise, cfg_b,
        evidence_scale=jnp.float32(0.0),
    )
    st_empty = st_b._replace(lm_count=jnp.zeros_like(st_b.lm_count))
    prior_only, _ = kernels.fastslam2_propose(
        st_empty, jnp.float32(0.0), jnp.float32(0.3), ms, noise, cfg_b,
    )
    np.testing.assert_array_equal(np.asarray(zeroed.poses),
                                  np.asarray(prior_only.poses))


def test_evidence_scale_interpolates_and_one_is_default():
    cfg_b, _, st_b, _ = _seeded_pair()
    ms = pad_measurements(cfg_b, [(2.1, 0.25), (2.9, -1.05)])
    noise = jax.random.normal(jax.random.PRNGKey(7),
                              (cfg_b.num_particles, 3))

    run = lambda g: kernels.fastslam2_propose(
        st_b, jnp.float32(0.0), jnp.float32(0.3), ms, noise, cfg_b,
        evidence_scale=g,
    )[0].poses
    full = run(None)
    np.testing.assert_array_equal(np.asarray(run(jnp.float32(1.0))),
                                  np.asarray(full))
    half = np.asarray(run(jnp.float32(0.5)))
    zero = np.asarray(run(jnp.float32(0.0)))
    assert np.isfinite(half).all()
    assert not np.array_equal(half, zero)
    assert not np.array_equal(half, np.asarray(full))
    # the g=0.5 sample mean sits between the endpoints' means
    for d in range(2):
        lohi = sorted([zero[:, d].mean(), np.asarray(full)[:, d].mean()])
        assert lohi[0] - 1e-4 <= half[:, d].mean() <= lohi[1] + 1e-4


def test_planes_fs2_evidence_scale_matches_blocks_path():
    """The traced dial must reach the fused kernel and match the XLA path
    at an intermediate value (same tolerance as the g=1 parity test)."""
    from fastslam_tpu.core.state import from_planes

    cfg_b, cfg_p, st_b, st_p = _seeded_pair()
    ms = pad_measurements(cfg_b, [(2.1, 0.25), (2.9, -1.05)])
    g = jnp.float32(0.37)

    nb, est_b = kernels.fastslam_step(
        st_b, jnp.float32(0.0), jnp.float32(0.3), ms, cfg_b,
        evidence_scale=g,
    )
    np_, est_p = kernels.fastslam_step_planes(
        st_p, jnp.float32(0.0), jnp.float32(0.3), ms, cfg_p,
        evidence_scale=g,
    )
    npb = from_planes(np_)
    np.testing.assert_allclose(np.asarray(nb.poses), np.asarray(npb.poses),
                               atol=2e-5)
    np.testing.assert_allclose(np.asarray(est_b), np.asarray(est_p),
                               atol=2e-5)


def test_chunked_fs2_unroll_is_bit_exact():
    """The fs2 chunked kernel's particle tile (the GPU's scheduling lever:
    particles per program) must be a pure scheduling change — bit-identical
    trajectories and maps for every tile size."""
    from fastslam_tpu.core import pallas_kernels

    cfg_b, cfg_p, _, st_p = _seeded_pair()
    c, p = 4, cfg_p.num_particles
    ms = pad_measurements(cfg_b, [(2.0, 0.3), (3.0, -1.0)])
    rng = np.random.default_rng(3)
    rows = tuple(jnp.asarray(rng.normal(size=(c, p)), jnp.float32)
                 for _ in range(3))
    scalars = jnp.asarray(
        [[0.0, 0.3, 1e-4, 1e-4, 1e-4, 1.0], [0.1, 0.0, 1e-4, 1e-4, 1e-4, 0.5],
         [0.0, 0.25, 1e-4, 1e-4, 1e-4, 1.0], [-0.05, 0.0, 1e-4, 1e-4, 1e-4,
                                               0.0]], jnp.float32)

    def run(block):
        return pallas_kernels.filter_ticks(
            st_p.poses, st_p.log_weights,
            (st_p.lm_mx, st_p.lm_my, st_p.lm_ca, st_p.lm_cb, None,
             st_p.lm_cd), st_p.lm_count,
            jnp.tile(ms.range_bearing[None], (c, 1, 1)),
            jnp.tile(ms.valid[None], (c, 1)), rows, scalars, cfg_p,
            interpret=True, block=block)

    base = jax.tree.leaves(run(16))
    for block in (32, 64):
        for got, want in zip(jax.tree.leaves(run(block)), base):
            np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def test_chunked_fs2_runs_and_is_finite():
    from fastslam_tpu.core.state import Measurements

    cfg_b, cfg_p, _, st_p = _seeded_pair()
    c = 4
    rots = jnp.array([0.0, 0.1, 0.0, -0.05], jnp.float32)
    trans = jnp.array([0.3, 0.0, 0.25, 0.0], jnp.float32)
    ms = pad_measurements(cfg_b, [(2.0, 0.3), (3.0, -1.0)])
    rb = jnp.tile(ms.range_bearing[None], (c, 1, 1))
    mv = jnp.tile(ms.valid[None], (c, 1))

    new_state, est = kernels.fastslam_steps_planes_chunked(
        st_p, rots, trans, Measurements(rb, mv), cfg_p
    )
    assert est.shape == (c, 3)
    assert np.isfinite(np.asarray(est)).all()
    assert np.isfinite(np.asarray(new_state.log_weights)).all()
    assert np.isfinite(np.asarray(new_state.lm_mx)).all()
    # translation ticks actually advance x
    e = np.asarray(est)
    assert e[2, 0] > e[0, 0] + 0.1


def test_planes_runner_supports_fs2_and_adaptive_floors():
    """SLAMRunner on the planes engine with proposal_mode='fastslam2' and
    adaptive floors constructs and ticks (the floors ride as traced scalars
    into the fused kernel)."""
    from fastslam_tpu.app.runner import SLAMRunner

    cfg = FastSLAMConfig(
        num_particles=128, max_landmarks=16, max_measurements=8,
        parity_mode=False, proposal_mode="fastslam2",
        use_pallas=True, pallas_interpret=True,
        use_icp_proposal=True, icp_blend=0.0, adaptive_proposal_floors=True,
        warmup_iterations=0,
    )
    runner = SLAMRunner(cfg)
    assert runner.uses_planes
    pts = np.zeros((cfg.num_beams, 2), np.float32)
    pts[:4] = [[2.0, 0.5], [2.0, 0.6], [2.0, 0.7], [2.0, 0.8]]
    valid = np.zeros(cfg.num_beams, bool)
    valid[:4] = True
    est = runner.tick(pts, valid, 0.0, 0.3)
    assert np.isfinite(est).all()
