"""The fused filter kernel vs the XLA reference paths (interpret mode on CPU).

The kernel itself compiles only for an NVIDIA GPU; here it runs in Pallas
interpret mode, and its Triton lowering (the step before GPU code
generation) is built without a GPU.  ``chip_smoke.py`` compares it with the
XLA path on the card at full width.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from fastslam_tpu.config import FastSLAMConfig
from fastslam_tpu.core import kernels
from fastslam_tpu.core.pallas_kernels import filter_ticks, particle_block
from fastslam_tpu.core.state import (
    Measurements, from_planes, init_state, pad_measurements, to_planes,
)


def build_state(cfg, seed=0, fill=3):
    """A state with partially filled landmark maps and non-uniform weights."""
    rng = np.random.default_rng(seed)
    st = init_state(cfg, rng=seed)
    p, l = cfg.num_particles, cfg.max_landmarks
    poses = rng.normal(0, 1, (p, 3)).astype(np.float32)
    mean = rng.normal(0, 4, (p, l, 2)).astype(np.float32)
    cov = np.zeros((p, l, 4), np.float32)
    cov[..., 0] = rng.uniform(0.05, 0.2, (p, l))
    cov[..., 3] = rng.uniform(0.05, 0.2, (p, l))
    count = rng.integers(0, fill + 1, p).astype(np.int32)
    logw = rng.normal(-3, 0.5, p).astype(np.float32)
    return st._replace(
        poses=jnp.asarray(poses), log_weights=jnp.asarray(logw),
        lm_mean=jnp.asarray(mean), lm_cov=jnp.asarray(cov),
        lm_count=jnp.asarray(count),
    )


def kernel_update(st, ms, cfg):
    """The kernel's measurement update on a blocks state (planes round trip,
    zero motion): the counterpart of ``kernels.update_particles``."""
    ps = to_planes(st, cfg)
    p = cfg.num_particles
    zero = jnp.zeros((1, p), jnp.float32)
    traj, planes, count = filter_ticks(
        ps.poses, ps.log_weights,
        (ps.lm_mx, ps.lm_my, ps.lm_ca, ps.lm_cb, ps.lm_cc, ps.lm_cd),
        ps.lm_count, ms.range_bearing[None], ms.valid[None], (zero, zero),
        None, cfg, interpret=True,
    )
    mx, my, ca, cb, cc, cd = planes
    out = from_planes(ps._replace(
        log_weights=traj[3][0], lm_mx=mx, lm_my=my, lm_ca=ca, lm_cb=cb,
        lm_cc=cc, lm_cd=cd, lm_count=count,
    ))
    return out


def assert_states_close(got, want, tol=1e-5):
    np.testing.assert_array_equal(np.asarray(got.lm_count),
                                  np.asarray(want.lm_count))
    for name in ("log_weights", "lm_mean", "lm_cov"):
        np.testing.assert_allclose(np.asarray(getattr(got, name)),
                                   np.asarray(getattr(want, name)),
                                   rtol=tol, atol=tol, err_msg=name)


@pytest.mark.parametrize("parity", [True, False])
def test_fused_update_matches_scan_path(parity):
    cfg = FastSLAMConfig(
        num_particles=32, max_landmarks=8, max_measurements=4, parity_mode=parity
    )
    st = build_state(cfg, seed=1)
    ms = pad_measurements(cfg, [(2.0, 0.3), (3.5, -0.7), (1.0, 2.5)])
    assert_states_close(kernel_update(st, ms, cfg),
                        kernels.update_particles(st, ms, cfg))


def test_fused_update_appends_and_capacity():
    cfg = FastSLAMConfig(num_particles=8, max_landmarks=2, max_measurements=4)
    st = init_state(cfg, rng=0)  # empty maps
    # far-apart measurements -> two appends, then capacity drop
    ms = pad_measurements(cfg, [(2.0, 0.0), (8.0, 2.8), (5.0, -2.0)])
    got = kernel_update(st, ms, cfg)
    want = kernels.update_particles(st, ms, cfg)
    assert_states_close(got, want)
    np.testing.assert_array_equal(np.asarray(got.lm_count), np.full(8, 2))


def test_fused_update_via_config_flag():
    """use_pallas selects the planes engine, whose step matches the blocks
    step (same RNG stream, same arithmetic, another layout)."""
    cfg_scan = FastSLAMConfig(num_particles=16, max_landmarks=8,
                              max_measurements=4)
    cfg_pl = cfg_scan.replace(use_pallas=True, pallas_interpret=True)
    st = build_state(cfg_scan, seed=2)
    ms = pad_measurements(cfg_scan, [(2.5, 0.1), (4.0, -1.2)])
    want, _ = kernels.fastslam_step(st, jnp.float32(0.0), jnp.float32(0.4),
                                    ms, cfg_scan)
    got, _ = kernels.fastslam_step_planes(
        to_planes(st, cfg_pl), jnp.float32(0.0), jnp.float32(0.4), ms, cfg_pl)
    assert_states_close(from_planes(got), want)


@pytest.mark.parametrize("parity", [True, False])
def test_planes_step_matches_block_step(parity):
    """fastslam_step_planes == fastslam_step — same RNG stream, same
    arithmetic, only the carried layout differs."""
    cfg = FastSLAMConfig(
        num_particles=128, max_landmarks=8, max_measurements=4,
        parity_mode=parity, use_pallas=True, pallas_interpret=True,
    )
    st = build_state(cfg, seed=4)
    ms = pad_measurements(cfg, [(2.0, 0.3), (3.5, -0.7), (1.0, 2.5)])

    want_st, want_pose = kernels.fastslam_step(
        st, jnp.float32(0.0), jnp.float32(0.4), ms, cfg
    )
    got_ps, got_pose = kernels.fastslam_step_planes(
        to_planes(st, cfg), jnp.float32(0.0), jnp.float32(0.4), ms, cfg
    )
    got_st = from_planes(got_ps)

    np.testing.assert_allclose(np.asarray(got_pose), np.asarray(want_pose),
                               rtol=1e-6, atol=1e-6)
    assert_states_close(got_st, want_st)
    np.testing.assert_allclose(np.asarray(got_st.poses),
                               np.asarray(want_st.poses), rtol=1e-6, atol=1e-6)


def test_planes_round_trip_pads_to_lane_tile():
    """Blocks <-> planes is exact at a particle count that is not a multiple
    of the kernel's tile: the kernel masks the last tile, so the planes
    state keeps P as it is (no padded particles)."""
    cfg = FastSLAMConfig(num_particles=100, max_landmarks=8, max_measurements=4)
    assert particle_block(100) == 32 and 100 % particle_block(100)
    st = build_state(cfg, seed=5)
    ps = to_planes(st)
    assert ps.num_particles == 100 and ps.lm_mx.shape == (8, 100)
    back = from_planes(ps)
    for name in ("poses", "log_weights", "lm_mean", "lm_cov", "lm_count"):
        np.testing.assert_array_equal(np.asarray(getattr(back, name)),
                                      np.asarray(getattr(st, name)))


@pytest.mark.parametrize("p,l", [(100, 32), (100, 48), (37, 48)])
def test_kernel_tail_and_odd_landmarks_match_scan(p, l):
    """P not a multiple of the tile and L not a power of two: the masked
    tail particles and the slot rows above L must not leak into the result
    (appends stop exactly at capacity L)."""
    cfg = FastSLAMConfig(num_particles=p, max_landmarks=l, max_measurements=8,
                         parity_mode=False)
    st = build_state(cfg, seed=p + l, fill=l - 2)
    ms = pad_measurements(cfg, [(2.0 + 0.7 * i, -2.5 + 0.6 * i)
                                for i in range(8)])
    got = kernel_update(st, ms, cfg)
    assert_states_close(got, kernels.update_particles(st, ms, cfg))
    assert int(np.asarray(got.lm_count).max()) <= l


def test_particle_block_rule():
    assert particle_block(100_000) == 32
    assert particle_block(8) == 16        # smallest tile
    assert particle_block(100, block=64) == 64
    assert particle_block(20, block=64) == 32


def test_kernel_refuses_cpu_without_interpret():
    cfg = FastSLAMConfig(num_particles=16, max_landmarks=8,
                         max_measurements=4, parity_mode=False)
    st = build_state(cfg)
    ms = pad_measurements(cfg, [(2.0, 0.3)])
    ps = to_planes(st, cfg)
    zero = jnp.zeros((1, 16), jnp.float32)
    with pytest.raises(RuntimeError, match="needs an NVIDIA GPU"):
        filter_ticks(ps.poses, ps.log_weights,
                     (ps.lm_mx, ps.lm_my, ps.lm_ca, ps.lm_cb, None, ps.lm_cd),
                     ps.lm_count, ms.range_bearing[None], ms.valid[None],
                     (zero, zero), None, cfg)
    # a step on the planes engine refuses too, rather than running elsewhere
    with pytest.raises(RuntimeError, match="needs an NVIDIA GPU"):
        kernels.fastslam_step_planes(
            ps, jnp.float32(0.0), jnp.float32(0.4), ms,
            cfg.replace(use_pallas=True))


@pytest.mark.parametrize("proposal,c", [("motion", 1), ("motion", 16),
                                        ("fastslam2", 1), ("fastslam2", 16)])
def test_kernel_lowers_through_triton(proposal, c):
    """Each kernel variant the engines launch builds as Triton IR (the
    lowering that precedes GPU code generation), so a primitive the Triton
    route cannot lower fails here rather than on the card."""
    from jax._src.pallas.triton import lowering

    cfg = FastSLAMConfig(num_particles=100, max_landmarks=64,
                         max_measurements=16, parity_mode=False,
                         proposal_mode=proposal)
    ps = to_planes(build_state(cfg), cfg)
    rows = tuple(jnp.zeros((c, 100), jnp.float32)
                 for _ in range(3 if proposal == "fastslam2" else 2))
    scalars = (jnp.ones((c, 6), jnp.float32) if proposal == "fastslam2"
               else None)
    z = jnp.ones((c, 16, 2), jnp.float32)
    zv = jnp.ones((c, 16), bool)
    jaxpr = jax.make_jaxpr(
        lambda *a: filter_ticks(*a, config=cfg, interpret=True))(
        ps.poses, ps.log_weights,
        (ps.lm_mx, ps.lm_my, ps.lm_ca, ps.lm_cb, None, ps.lm_cd),
        ps.lm_count, z, zv, rows, scalars)
    [eqn] = [e for e in jaxpr.eqns if e.primitive.name == "pallas_call"]
    assert eqn.params["backend"] == "triton"
    result = lowering.lower_jaxpr_to_triton_module(
        eqn.params["jaxpr"], eqn.params["grid_mapping"], platform="cuda")
    assert result.module.operation.verify()


# ---------------------------------------------------------------------------
# multi-tick (chunked) kernel
# ---------------------------------------------------------------------------

def _sequential_reference(st, noisy_rot, noisy_trans, z, z_valid, cfg):
    """Per-tick XLA composition the chunked kernel must match: explicit
    propagation (reference rotation-XOR-translation order) followed by the
    scan measurement update, tick after tick."""
    est = []
    for k in range(z.shape[0]):
        yaw = kernels.wrap_angle(st.poses[:, 2] + noisy_rot[k])
        x = st.poses[:, 0] + noisy_trans[k] * jnp.cos(yaw)
        y = st.poses[:, 1] + noisy_trans[k] * jnp.sin(yaw)
        st = st._replace(poses=jnp.stack([x, y, yaw], axis=-1))
        st = kernels.update_particles(st, Measurements(z[k], z_valid[k]), cfg)
        est.append((x, y, yaw, st.log_weights))
    return est, st


@pytest.mark.parametrize("c", [1, 4])
def test_chunked_kernel_matches_sequential(c):
    """C ticks inside one kernel == C XLA ticks with the same noise draws
    (production mode; appends, EKF updates, and invalid measurements all
    crossing tick boundaries)."""
    cfg = FastSLAMConfig(
        num_particles=128, max_landmarks=8, max_measurements=4,
        parity_mode=False, use_pallas=True, pallas_interpret=True,
    )
    st = build_state(cfg, seed=11, fill=2)
    ps = to_planes(st, cfg)
    rng = np.random.default_rng(12)

    # per-tick measurements: mix of updates, appends, and padded slots
    z = rng.uniform(0.5, 6.0, (c, 4, 2)).astype(np.float32)
    z[..., 1] = rng.uniform(-3.0, 3.0, (c, 4))
    z_valid = np.zeros((c, 4), bool)
    for k in range(c):
        z_valid[k, : rng.integers(0, 5)] = True  # packed-first masks
    # rotation-XOR-translation ticks
    rotating = rng.random(c) < 0.5
    noisy_rot = np.where(
        rotating[:, None], rng.normal(0.3, 0.01, (c, 128)), 0.0
    ).astype(np.float32)
    noisy_trans = np.where(
        rotating[:, None], 0.0, rng.normal(0.4, 0.01, (c, 128))
    ).astype(np.float32)

    (tx, ty, tyaw, tlogw), planes, cnt = filter_ticks(
        ps.poses, ps.log_weights,
        (ps.lm_mx, ps.lm_my, ps.lm_ca, ps.lm_cb, ps.lm_cc, ps.lm_cd),
        ps.lm_count, jnp.asarray(z), jnp.asarray(z_valid),
        (jnp.asarray(noisy_rot), jnp.asarray(noisy_trans)), None, cfg,
        interpret=True,
    )
    est, final = _sequential_reference(
        st, jnp.asarray(noisy_rot), jnp.asarray(noisy_trans),
        jnp.asarray(z), jnp.asarray(z_valid), cfg,
    )
    for k, (x, y, yaw, logw) in enumerate(est):
        for got, want in ((tx, x), (ty, y), (tyaw, yaw)):
            np.testing.assert_allclose(np.asarray(got[k]), np.asarray(want),
                                       rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(np.asarray(tlogw[k]), np.asarray(logw),
                                   rtol=1e-4, atol=1e-4)
    # production streams no cc plane (cc == cb invariant)
    assert planes[4] is None
    mx, my, ca, cb, _, cd = planes
    got = from_planes(ps._replace(lm_mx=mx, lm_my=my, lm_ca=ca, lm_cb=cb,
                                  lm_cd=cd, lm_count=cnt))
    np.testing.assert_array_equal(np.asarray(got.lm_count),
                                  np.asarray(final.lm_count))
    np.testing.assert_allclose(np.asarray(got.lm_mean),
                               np.asarray(final.lm_mean), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(np.asarray(got.lm_cov),
                               np.asarray(final.lm_cov), rtol=1e-4, atol=1e-4)


def test_chunked_step_runs_and_estimates():
    """fastslam_steps_planes_chunked: full chunked step (propagate noise,
    kernel, chunk-boundary normalize/Neff/resample, per-tick estimates)."""
    from fastslam_tpu.core.state import init_planes_state

    cfg = FastSLAMConfig(
        num_particles=128, max_landmarks=8, max_measurements=4,
        parity_mode=False, use_pallas=True, pallas_interpret=True,
    )
    state = init_planes_state(cfg, rng=0)
    c = 6
    rots = jnp.zeros(c, jnp.float32)
    trans = jnp.full(c, 0.4, jnp.float32)
    # geometrically consistent observations of two FIXED world landmarks
    # from the commanded path (x = 0.4 * tick), so ticks 2.. re-associate
    lms = np.asarray([[3.0, 1.0], [1.5, -2.0]])
    rb = np.zeros((c, 4, 2), np.float32)
    for k in range(c):
        rx = 0.4 * (k + 1)
        d = lms - np.asarray([rx, 0.0])
        rb[k, :2, 0] = np.hypot(d[:, 0], d[:, 1])
        rb[k, :2, 1] = np.arctan2(d[:, 1], d[:, 0])
    rb = jnp.asarray(rb)
    valid = jnp.tile(jnp.asarray([True, True, False, False]), (c, 1))

    state2, est = kernels.fastslam_steps_planes_chunked(
        state, rots, trans, Measurements(rb, valid), cfg
    )
    assert est.shape == (c, 3)
    assert np.isfinite(np.asarray(est)).all()
    assert np.isfinite(np.asarray(state2.log_weights)).all()
    # weights normalized at the chunk boundary
    np.testing.assert_allclose(
        np.exp(np.asarray(state2.log_weights)).sum(), 1.0, rtol=1e-4
    )
    # two static landmarks observed every tick -> two slots per particle
    np.testing.assert_array_equal(np.asarray(state2.lm_count),
                                  np.full(128, 2, np.int32))
    # parity mode must refuse chunked execution
    with pytest.raises(NotImplementedError):
        kernels.fastslam_steps_planes_chunked(
            state, rots, trans, Measurements(rb, valid),
            cfg.replace(parity_mode=True),
        )
