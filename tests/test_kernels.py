"""Core kernels vs the NumPy oracle (reference equations, SURVEY.md §3.3)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from fastslam_tpu.config import FastSLAMConfig
from fastslam_tpu.core import kernels
from fastslam_tpu.core.state import FilterState, Measurements, init_state, pad_measurements

from oracle import numpy_oracle as oracle


CFG = FastSLAMConfig(num_particles=8, max_landmarks=8, max_measurements=4)


def oracle_to_arrays(particles, cfg):
    p = len(particles)
    l = cfg.max_landmarks
    poses = np.array([[q.x, q.y, q.yaw] for q in particles], np.float32)
    logw = np.log([q.weight for q in particles]).astype(np.float32)
    mean = np.zeros((p, l, 2), np.float32)
    cov = np.zeros((p, l, 4), np.float32)
    count = np.zeros((p,), np.int32)
    for i, q in enumerate(particles):
        for j, lm in enumerate(q.landmarks):
            mean[i, j] = (lm.x, lm.y)
            cov[i, j] = lm.cov.reshape(-1)
        count[i] = len(q.landmarks)
    return poses, logw, mean, cov, count


def state_from_oracle(particles, cfg, rng=0):
    poses, logw, mean, cov, count = oracle_to_arrays(particles, cfg)
    return FilterState(
        poses=jnp.asarray(poses),
        log_weights=jnp.asarray(logw),
        lm_mean=jnp.asarray(mean),
        lm_cov=jnp.asarray(cov),
        lm_count=jnp.asarray(count),
        rng=jax.random.key(rng),
    )


def random_particles(rng, n, n_landmarks=3, spread=4.0):
    parts = oracle.make_particles(n)
    for p in parts:
        p.x, p.y = rng.normal(0, 1, 2)
        p.yaw = rng.uniform(-np.pi, np.pi)
        p.weight = rng.uniform(0.5, 2.0)
        for _ in range(n_landmarks):
            c = np.eye(2) * rng.uniform(0.05, 0.2)
            p.landmarks.append(
                oracle.OracleLandmark(*rng.normal(0, spread, 2), cov=c)
            )
    total = sum(p.weight for p in parts)
    for p in parts:
        p.weight /= total
    return parts


def test_wrap_angle():
    angles = np.linspace(-10, 10, 101)
    got = np.asarray(kernels.wrap_angle(jnp.asarray(angles)))
    want = np.array([oracle.wrap(a) for a in angles])
    np.testing.assert_allclose(got, want, atol=1e-6)


@pytest.mark.parametrize("rotation,translation", [(0.3, 0.0), (0.0, 0.5), (0.0, 0.0)])
def test_propagate_matches_oracle(rotation, translation):
    rng = np.random.default_rng(0)
    parts = random_particles(rng, 8)
    rot_noise = rng.normal(0, 0.001, 8)
    trans_noise = rng.normal(0, 0.0055, 8)

    st = state_from_oracle(parts, CFG)
    got = np.asarray(
        kernels.propagate_particles(
            st.poses, rotation, translation,
            jnp.asarray(rot_noise, jnp.float32), jnp.asarray(trans_noise, jnp.float32),
        )
    )
    for i, p in enumerate(parts):
        oracle.move_particle(p, rotation, translation, rot_noise[i], trans_noise[i])
    want = np.array([[p.x, p.y, p.yaw] for p in parts])
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_update_one_measurement_matches_oracle():
    rng = np.random.default_rng(1)
    parts = random_particles(rng, 8, n_landmarks=4)
    st = state_from_oracle(parts, CFG)
    dist, bearing = 2.0, 0.4

    logw, mean, cov, count = kernels.update_particles_one(
        st.poses, st.log_weights, st.lm_mean, st.lm_cov, st.lm_count,
        jnp.asarray([dist, bearing], jnp.float32), jnp.asarray(True), CFG,
    )
    for p in parts:
        oracle.update_particle(p, dist, bearing)

    _, want_logw, want_mean, want_cov, want_count = oracle_to_arrays(parts, CFG)
    np.testing.assert_array_equal(np.asarray(count), want_count)
    np.testing.assert_allclose(np.asarray(mean), want_mean, atol=2e-4)
    np.testing.assert_allclose(np.asarray(cov), want_cov, atol=2e-4)
    np.testing.assert_allclose(np.asarray(logw), want_logw, rtol=2e-3, atol=1e-4)


def test_update_appends_when_no_match():
    parts = oracle.make_particles(4)  # no landmarks at all
    st = state_from_oracle(parts, CFG)
    dist, bearing = 3.0, -0.7

    logw, mean, cov, count = kernels.update_particles_one(
        st.poses, st.log_weights, st.lm_mean, st.lm_cov, st.lm_count,
        jnp.asarray([dist, bearing], jnp.float32), jnp.asarray(True), CFG,
    )
    for p in parts:
        oracle.update_particle(p, dist, bearing)

    _, want_logw, want_mean, want_cov, want_count = oracle_to_arrays(parts, CFG)
    np.testing.assert_array_equal(np.asarray(count), want_count)
    np.testing.assert_allclose(np.asarray(mean), want_mean, atol=1e-5)
    np.testing.assert_allclose(np.asarray(logw), want_logw, atol=1e-6)


def test_capacity_overflow_drops_append():
    cfg = CFG.replace(max_landmarks=2)
    rng = np.random.default_rng(2)
    parts = random_particles(rng, 4, n_landmarks=2, spread=50.0)
    st = state_from_oracle(parts, cfg)
    # far-away observation: no match, append would be slot 2 -> dropped
    logw, mean, cov, count = kernels.update_particles_one(
        st.poses, st.log_weights, st.lm_mean, st.lm_cov, st.lm_count,
        jnp.asarray([200.0, 0.0], jnp.float32), jnp.asarray(True), cfg,
    )
    np.testing.assert_array_equal(np.asarray(count), np.full(4, 2))


def test_invalid_measurement_is_noop():
    rng = np.random.default_rng(3)
    parts = random_particles(rng, 8)
    st = state_from_oracle(parts, CFG)
    logw, mean, cov, count = kernels.update_particles_one(
        st.poses, st.log_weights, st.lm_mean, st.lm_cov, st.lm_count,
        jnp.asarray([2.0, 0.4], jnp.float32), jnp.asarray(False), CFG,
    )
    np.testing.assert_array_equal(np.asarray(count), np.asarray(st.lm_count))
    np.testing.assert_allclose(np.asarray(mean), np.asarray(st.lm_mean))
    np.testing.assert_allclose(np.asarray(logw), np.asarray(st.log_weights))


def test_normalize_weights_parity_quirks():
    # collapse -> uniform (fast_slam_2.py:168-170)
    logw = jnp.log(jnp.asarray([1e-9, 1e-8, 1e-7, 1e-9], jnp.float32))
    out = np.exp(np.asarray(kernels.normalize_log_weights(logw, CFG)))
    np.testing.assert_allclose(out, np.full(4, 0.25), rtol=1e-5)

    # tiny weights skipped during normalization (:173)
    w = np.array([0.5, 0.5, 1e-6, 0.25], np.float32)
    parts = oracle.make_particles(4)
    for p, wi in zip(parts, w):
        p.weight = float(wi)
    oracle.normalize_weights(parts)
    want = np.array([p.weight for p in parts])
    got = np.exp(
        np.asarray(kernels.normalize_log_weights(jnp.log(jnp.asarray(w)), CFG))
    )
    np.testing.assert_allclose(got, want, rtol=5e-5)  # f32 exp/log round-trip


def test_effective_particles_matches_oracle():
    for w in ([0.25, 0.25, 0.25, 0.25], [0.97, 0.01, 0.01, 0.01], [1e-6] * 4):
        parts = oracle.make_particles(4)
        for p, wi in zip(parts, w):
            p.weight = float(wi)
        want = oracle.effective_particles(parts)
        got = float(
            kernels.effective_particles(jnp.log(jnp.asarray(w, jnp.float32)), CFG)
        )
        assert got == pytest.approx(want, rel=1e-5)


@pytest.mark.parametrize("seed", range(5))
def test_systematic_resample_matches_oracle(seed):
    rng = np.random.default_rng(seed)
    n = 16
    w = rng.dirichlet(np.ones(n)).astype(np.float64)
    u0 = rng.uniform(0, 1 / n)
    parts = oracle.make_particles(n)
    for p, wi in zip(parts, w):
        p.weight = float(wi)
    want = oracle.systematic_resample(parts, u0)
    got = np.asarray(
        kernels.systematic_resample_indices(jnp.asarray(w, jnp.float64), u0)
    )
    np.testing.assert_array_equal(got, np.asarray(want))


@pytest.mark.parametrize("seed", range(4))
def test_systematic_resample_matches_searchsorted(seed):
    """The search-free staircase form (kernels.systematic_resample_indices)
    must return BIT-IDENTICAL
    indices to the reference cumsum+searchsorted formulation, including
    float-tie and degenerate-weight cases."""
    import jax.numpy as jnp

    rng = np.random.default_rng(seed)
    for n in (8, 100, 1024, 4096):
        cases = [rng.dirichlet(np.full(n, 0.5))]
        # degenerate: one particle holds ~all mass
        w = np.full(n, 1e-12)
        w[rng.integers(n)] = 1.0
        cases.append(w / w.sum())
        # many zero-weight particles (cumsum ties)
        w = np.zeros(n)
        w[rng.integers(0, n, max(2, n // 8))] = rng.uniform(
            0.5, 1.0, max(2, n // 8))
        cases.append(w / w.sum())
        # undersum (weights not normalized; trailing positions clip)
        cases.append(cases[0] * 0.97)
        # exact grid ties: cum values landing exactly on positions
        w = np.full(n, 1.0 / n)
        cases.append(w)
        for w in cases:
            w32 = jnp.asarray(w, jnp.float32)
            for u0 in (0.0, 1e-7, 0.3 / n, (n - 1) / (n * n)):
                u = jnp.float32(u0)
                got = np.asarray(
                    kernels.systematic_resample_indices(w32, u))
                cum = jnp.cumsum(w32)
                pos = u + jnp.arange(n, dtype=jnp.float32) / n
                want = np.asarray(jnp.clip(
                    jnp.searchsorted(cum, pos, side="left"), 0, n - 1))
                np.testing.assert_array_equal(got, want)


def test_full_iterate_matches_oracle():
    """End-to-end parity: several iterations with identical injected noise."""
    rng = np.random.default_rng(7)
    n = 8
    cfg = FastSLAMConfig(num_particles=n, max_landmarks=16, max_measurements=4)
    parts = oracle.make_particles(n)
    st = init_state(cfg)

    ticks = [
        (0.0, 0.4, [(2.0, 0.3), (3.5, -1.0)]),
        (0.2, 0.0, [(2.1, 0.25)]),
        (0.0, 0.4, [(1.8, 0.35), (3.3, -1.05), (5.0, 2.0)]),
        (0.0, 0.4, []),
        (-0.15, 0.0, [(1.9, 0.3)]),
    ]
    for rotation, translation, ms in ticks:
        rot_noise = rng.normal(0, 0.001, n).astype(np.float32)
        trans_noise = rng.normal(0, 0.0055, n).astype(np.float32)
        u0 = float(rng.uniform(0, 1 / n))

        want_pose = oracle.iterate(
            parts, rotation, translation, ms, rot_noise, trans_noise, u0
        )

        # JAX path with the same injected noise
        poses = kernels.propagate_particles(
            st.poses, rotation, translation,
            jnp.asarray(rot_noise), jnp.asarray(trans_noise),
        )
        st = st._replace(poses=poses)
        st = kernels.update_particles(st, pad_measurements(cfg, np.array(ms).reshape(-1, 2)), cfg)
        st = st._replace(log_weights=kernels.normalize_log_weights(st.log_weights, cfg))
        neff = kernels.effective_particles(st.log_weights, cfg)
        if float(neff) < n / 2:
            idx = kernels.systematic_resample_indices(jnp.exp(st.log_weights), u0)
            st = kernels.resample_state(st, idx, cfg)
        got_pose = np.asarray(kernels.estimate_pose(st))

        np.testing.assert_allclose(got_pose, np.asarray(want_pose), atol=1e-4)

    # final structural parity
    _, want_logw, want_mean, _, want_count = oracle_to_arrays(parts, cfg)
    np.testing.assert_array_equal(np.asarray(st.lm_count), want_count)
    np.testing.assert_allclose(np.asarray(st.lm_mean), want_mean, atol=1e-3)


def test_fastslam_step_jits_and_runs():
    cfg = FastSLAMConfig(num_particles=32, max_landmarks=8, max_measurements=4)
    st = init_state(cfg, rng=42)
    ms = pad_measurements(cfg, [(2.0, 0.3), (3.0, -0.5)])
    step = jax.jit(kernels.fastslam_step, static_argnames="config")
    st2, pose = step(st, jnp.float32(0.0), jnp.float32(0.4), ms, cfg)
    assert st2.poses.shape == (32, 3)
    assert pose.shape == (3,)
    # NOTE: with the parity-mode frame-mismatch quirk (SURVEY.md §7.0 #1) the
    # second measurement can associate with the first landmark, so the count
    # may be 1 or 2 depending on geometry.
    assert int(st2.lm_count[0]) >= 1
    # run a few more ticks; state stays finite
    for _ in range(5):
        st2, pose = step(st2, jnp.float32(0.0), jnp.float32(0.4), ms, cfg)
    assert np.isfinite(np.asarray(pose)).all()
    assert np.isfinite(np.asarray(st2.log_weights)).all()


def test_parity_planes_requires_lane_tile_multiple():
    """The parity contract fixes N (normalization denominator, Neff, the
    resample threshold).  The kernel masks the tail of its last particle
    tile instead of padding P, so the planes engine keeps N at every count
    and parity runs on it at any P."""
    from fastslam_tpu.core.pallas_kernels import particle_block
    from fastslam_tpu.core.state import init_planes_state

    cfg = FastSLAMConfig(num_particles=100, parity_mode=True, use_pallas=True)
    assert 100 % particle_block(100)          # not a tile multiple
    assert init_planes_state(cfg).num_particles == 100
