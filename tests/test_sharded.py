"""Sharded-step tests on the 8-device virtual CPU mesh (conftest sets
xla_force_host_platform_device_count=8): the multi-chip path must compile,
keep state sharded on the particle axis, and agree with the single-device
result given identical RNG."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from fastslam_tpu.config import FastSLAMConfig
from fastslam_tpu.core import kernels
from fastslam_tpu.core.state import init_state, pad_measurements
from fastslam_tpu.parallel.mesh import make_mesh, shard_state, state_sharding
from fastslam_tpu.parallel.sharded import make_sharded_step

CFG = FastSLAMConfig(num_particles=64, max_landmarks=16, max_measurements=4)


@pytest.fixture(scope="module")
def mesh():
    assert len(jax.devices()) == 8, "conftest should provide 8 virtual devices"
    return make_mesh(CFG)


def test_state_shards_on_particle_axis(mesh):
    st = shard_state(init_state(CFG, rng=0), mesh, CFG)
    shard_shapes = [s.data.shape for s in st.poses.addressable_shards]
    assert all(shape == (8, 3) for shape in shard_shapes)
    assert len(shard_shapes) == 8


def test_sharded_step_runs_and_stays_sharded(mesh):
    step = make_sharded_step(CFG, mesh)
    st = shard_state(init_state(CFG, rng=0), mesh, CFG)
    ms = pad_measurements(CFG, [(2.0, 0.3), (3.5, -0.7)])
    st2, pose = step(st, jnp.float32(0.0), jnp.float32(0.4), ms)
    assert pose.shape == (3,)
    assert np.isfinite(np.asarray(pose)).all()
    # still sharded over 8 devices after the step
    assert len(st2.lm_mean.addressable_shards) == 8
    assert int(st2.lm_count.max()) >= 1


def test_sharded_matches_single_device():
    """Same seed, same inputs: sharded and unsharded execution agree."""
    ms = pad_measurements(CFG, [(2.0, 0.3), (3.5, -0.7)])

    mesh1 = make_mesh(CFG, devices=jax.devices()[:1])
    mesh8 = make_mesh(CFG)

    st1 = shard_state(init_state(CFG, rng=7), mesh1, CFG)
    st8 = shard_state(init_state(CFG, rng=7), mesh8, CFG)
    step1 = make_sharded_step(CFG, mesh1)
    step8 = make_sharded_step(CFG, mesh8)

    for _ in range(3):
        st1, pose1 = step1(st1, jnp.float32(0.0), jnp.float32(0.4), ms)
        st8, pose8 = step8(st8, jnp.float32(0.0), jnp.float32(0.4), ms)

    np.testing.assert_allclose(np.asarray(pose1), np.asarray(pose8), atol=1e-5)
    np.testing.assert_allclose(
        np.asarray(st1.log_weights), np.asarray(st8.log_weights), atol=1e-5
    )
    np.testing.assert_allclose(
        np.asarray(st1.lm_mean), np.asarray(st8.lm_mean), atol=1e-5
    )


def test_resampling_gathers_across_shards(mesh):
    """Force a resample where all weight lives on shard 0 — every shard's
    particles must become copies of shard-0 particles (cross-shard gather)."""
    st = init_state(CFG, rng=1)
    lw = np.full(CFG.num_particles, -60.0, np.float32)
    lw[:4] = np.log(0.25)  # all mass on 4 particles of shard 0
    poses = np.zeros((CFG.num_particles, 3), np.float32)
    poses[:, 0] = np.arange(CFG.num_particles)  # identify ancestors by x
    st = st._replace(
        log_weights=jnp.asarray(lw), poses=jnp.asarray(poses)
    )
    st = shard_state(st, mesh, CFG)

    idx = kernels.systematic_resample_indices(jnp.exp(st.log_weights), jnp.float32(0.001))
    out = kernels.resample_state(st, idx, CFG)
    xs = np.asarray(out.poses[:, 0])
    assert set(xs.astype(int)) <= {0, 1, 2, 3}


def test_2d_mesh_particles_by_map():
    """2-D mesh: particles x map — landmark slots shard over the map axis;
    the filter step still matches the single-device result."""
    cfg = FastSLAMConfig(num_particles=16, max_landmarks=16, max_measurements=4)
    mesh2d = make_mesh(cfg, map_parallelism=2)  # 4 x 2 over 8 devices
    assert mesh2d.shape == {"particles": 4, "map": 2}

    ms = pad_measurements(cfg, [(2.0, 0.3), (3.5, -0.7)])
    mesh1 = make_mesh(cfg, devices=jax.devices()[:1])

    st1 = shard_state(init_state(cfg, rng=3), mesh1, cfg)
    st2 = shard_state(init_state(cfg, rng=3), mesh2d, cfg)
    step1 = make_sharded_step(cfg, mesh1)
    step2 = make_sharded_step(cfg, mesh2d)

    for _ in range(2):
        st1, pose1 = step1(st1, jnp.float32(0.0), jnp.float32(0.4), ms)
        st2, pose2 = step2(st2, jnp.float32(0.0), jnp.float32(0.4), ms)

    np.testing.assert_allclose(np.asarray(pose1), np.asarray(pose2), atol=1e-5)
    np.testing.assert_allclose(np.asarray(st1.lm_mean), np.asarray(st2.lm_mean),
                               atol=1e-5)
    np.testing.assert_array_equal(np.asarray(st1.lm_count), np.asarray(st2.lm_count))


def test_multihost_utils_single_process():
    from fastslam_tpu.parallel.multihost import (
        initialize_distributed,
        local_shard,
        replicated_to_host,
    )

    info = initialize_distributed()  # single process: no-op
    assert info["num_processes"] == 1 and info["global_devices"] == 8

    mesh = make_mesh(CFG)
    st = shard_state(init_state(CFG, rng=0), mesh, CFG)
    poses = local_shard(st.poses)
    assert poses.shape == (CFG.num_particles, 3)
    rng_host = replicated_to_host(st.log_weights)
    assert rng_host.shape == (CFG.num_particles,)


def test_sharded_pallas_step_matches_scan(mesh):
    """The kernel under sharding (shard_map around the fused kernel,
    interpret mode on CPU) must match the GSPMD scan path from the same
    seed: same RNG stream, same arithmetic, another layout."""
    from fastslam_tpu.core.state import from_planes, to_planes
    from fastslam_tpu.parallel.mesh import shard_planes_state
    from fastslam_tpu.parallel.sharded import make_sharded_planes_step

    cfg_scan = FastSLAMConfig(num_particles=64, max_landmarks=16, max_measurements=4)
    cfg_pl = cfg_scan.replace(use_pallas=True, pallas_interpret=True)
    ms = pad_measurements(cfg_scan, [(2.0, 0.3), (3.5, -0.7)])

    st_a = shard_state(init_state(cfg_scan, rng=5), mesh, cfg_scan)
    st_b = shard_planes_state(to_planes(init_state(cfg_pl, rng=5), cfg_pl),
                              mesh, cfg_pl)
    step_a = make_sharded_step(cfg_scan, mesh)
    step_b = make_sharded_planes_step(cfg_pl, mesh)

    for _ in range(2):
        st_a, pose_a = step_a(st_a, jnp.float32(0.0), jnp.float32(0.4), ms)
        st_b, pose_b = step_b(st_b, jnp.float32(0.0), jnp.float32(0.4), ms)

    blocks_b = from_planes(jax.device_get(st_b))
    np.testing.assert_allclose(np.asarray(pose_a), np.asarray(pose_b), atol=1e-5)
    np.testing.assert_allclose(np.asarray(st_a.lm_mean),
                               np.asarray(blocks_b.lm_mean), atol=1e-5)
    np.testing.assert_array_equal(np.asarray(st_a.lm_count),
                                  np.asarray(blocks_b.lm_count))
    assert len(st_b.lm_mx.addressable_shards) == 8


def test_sharded_planes_step_matches_unsharded_planes(mesh):
    """The planes-native sharded step (shard_map around the fused kernel,
    zero layout conversions) must agree with the single-device planes step
    and stay sharded on the particle (minor) axis."""
    from fastslam_tpu.core.state import from_planes, to_planes
    from fastslam_tpu.parallel.mesh import shard_planes_state
    from fastslam_tpu.parallel.sharded import make_sharded_planes_step

    cfg = FastSLAMConfig(
        num_particles=128, max_landmarks=16, max_measurements=4,
        use_pallas=True, pallas_interpret=True,
    )
    ms = pad_measurements(cfg, [(2.0, 0.3), (3.5, -0.7)])

    ps_ref = to_planes(init_state(cfg, rng=9))
    ps_sh = shard_planes_state(to_planes(init_state(cfg, rng=9)), mesh, cfg)
    step = make_sharded_planes_step(cfg, mesh)

    for _ in range(3):
        ps_ref, pose_ref = kernels.fastslam_step_planes(
            ps_ref, jnp.float32(0.0), jnp.float32(0.4), ms, cfg
        )
        ps_sh, pose_sh = step(ps_sh, jnp.float32(0.0), jnp.float32(0.4), ms)

    np.testing.assert_allclose(np.asarray(pose_sh), np.asarray(pose_ref),
                               atol=1e-5)
    a = from_planes(jax.device_get(ps_sh))
    b = from_planes(ps_ref)
    np.testing.assert_allclose(np.asarray(a.lm_mean), np.asarray(b.lm_mean),
                               atol=1e-5)
    np.testing.assert_array_equal(np.asarray(a.lm_count), np.asarray(b.lm_count))
    # planes sharded along the particle axis across all 8 devices
    assert len(ps_sh.lm_mx.addressable_shards) == 8
    assert ps_sh.lm_mx.addressable_shards[0].data.shape == (16, 16)


def test_sharded_chunked_matches_single_device():
    """Multi-tick chunked planes step: sharded and single-device execution
    agree (same RNG stream; the multi-tick kernel runs per-shard via
    shard_map, chunk-boundary collectives under GSPMD)."""
    from fastslam_tpu.core.state import Measurements, init_planes_state
    from fastslam_tpu.parallel.mesh import shard_planes_state
    from fastslam_tpu.parallel.sharded import make_sharded_planes_chunked_step

    cfg = FastSLAMConfig(
        num_particles=128, max_landmarks=8, max_measurements=4,
        parity_mode=False, use_pallas=True, pallas_interpret=True,
    )
    c = 4
    rots = jnp.zeros(c, jnp.float32)
    trans = jnp.full(c, 0.4, jnp.float32)
    lms = np.asarray([[3.0, 1.0], [1.5, -2.0]])
    rb = np.zeros((c, 4, 2), np.float32)
    for k in range(c):
        d = lms - np.asarray([0.4 * (k + 1), 0.0])
        rb[k, :2, 0] = np.hypot(d[:, 0], d[:, 1])
        rb[k, :2, 1] = np.arctan2(d[:, 1], d[:, 0])
    ms = Measurements(jnp.asarray(rb),
                      jnp.tile(jnp.asarray([True, True, False, False]), (c, 1)))

    mesh1 = make_mesh(cfg, devices=jax.devices()[:1])
    mesh8 = make_mesh(cfg)
    st1 = shard_planes_state(init_planes_state(cfg, rng=7), mesh1, cfg)
    st8 = shard_planes_state(init_planes_state(cfg, rng=7), mesh8, cfg)
    step1 = make_sharded_planes_chunked_step(cfg, mesh1, c)
    step8 = make_sharded_planes_chunked_step(cfg, mesh8, c)

    for _ in range(2):
        st1, est1 = step1(st1, rots, trans, ms)
        st8, est8 = step8(st8, rots, trans, ms)

    assert est1.shape == (c, 3)
    np.testing.assert_allclose(np.asarray(est1), np.asarray(est8), atol=1e-5)
    np.testing.assert_allclose(
        np.asarray(st1.log_weights), np.asarray(st8.log_weights), atol=1e-5
    )
    np.testing.assert_allclose(np.asarray(st1.lm_mx), np.asarray(st8.lm_mx),
                               atol=1e-5)
    np.testing.assert_array_equal(np.asarray(st1.lm_count),
                                  np.asarray(st8.lm_count))


def test_sharded_fs2_planes_matches_single_device():
    """Fused FastSLAM 2.0 planes step (proposal + evidence + EKF in one
    kernel): sharded and single-device execution agree — the kernel is
    fully particle-parallel and the noise draw happens under GSPMD, so the
    8-device run is numerically identical to 1 device."""
    from fastslam_tpu.core.state import Measurements, init_planes_state
    from fastslam_tpu.parallel.mesh import shard_planes_state
    from fastslam_tpu.parallel.sharded import (
        make_sharded_planes_chunked_step, make_sharded_planes_step,
    )

    cfg = FastSLAMConfig(
        num_particles=128, max_landmarks=8, max_measurements=4,
        parity_mode=False, proposal_mode="fastslam2",
        use_pallas=True, pallas_interpret=True,
    )
    ms = pad_measurements(cfg, [(3.0, 0.4), (2.0, -1.0)])

    mesh1 = make_mesh(cfg, devices=jax.devices()[:1])
    mesh8 = make_mesh(cfg)
    st1 = shard_planes_state(init_planes_state(cfg, rng=7), mesh1, cfg)
    st8 = shard_planes_state(init_planes_state(cfg, rng=7), mesh8, cfg)
    step1 = make_sharded_planes_step(cfg, mesh1)
    step8 = make_sharded_planes_step(cfg, mesh8)

    for _ in range(3):
        st1, est1 = step1(st1, jnp.float32(0.0), jnp.float32(0.4), ms)
        st8, est8 = step8(st8, jnp.float32(0.0), jnp.float32(0.4), ms)
    np.testing.assert_allclose(np.asarray(est1), np.asarray(est8), atol=1e-5)
    np.testing.assert_allclose(
        np.asarray(st1.poses), np.asarray(st8.poses), atol=1e-5
    )
    np.testing.assert_allclose(np.asarray(st1.lm_mx), np.asarray(st8.lm_mx),
                               atol=1e-5)
    np.testing.assert_array_equal(np.asarray(st1.lm_count),
                                  np.asarray(st8.lm_count))

    # chunked fs2 variant
    c = 4
    rots = jnp.zeros(c, jnp.float32)
    trans = jnp.full(c, 0.4, jnp.float32)
    msc = Measurements(jnp.tile(ms.range_bearing[None], (c, 1, 1)),
                       jnp.tile(ms.valid[None], (c, 1)))
    stc1 = shard_planes_state(init_planes_state(cfg, rng=9), mesh1, cfg)
    stc8 = shard_planes_state(init_planes_state(cfg, rng=9), mesh8, cfg)
    cstep1 = make_sharded_planes_chunked_step(cfg, mesh1, c)
    cstep8 = make_sharded_planes_chunked_step(cfg, mesh8, c)
    stc1, estc1 = cstep1(stc1, rots, trans, msc)
    stc8, estc8 = cstep8(stc8, rots, trans, msc)
    np.testing.assert_allclose(np.asarray(estc1), np.asarray(estc8), atol=1e-5)
    np.testing.assert_allclose(np.asarray(stc1.lm_mx), np.asarray(stc8.lm_mx),
                               atol=1e-5)

    # chunked fs2 with the ADAPTIVE inputs (per-tick floors + mode dial)
    # traced in as replicated rows — the flagship replay config on the mesh
    floors_xy = jnp.array([0.004, 0.002, 0.001, 0.0008], jnp.float32)
    floors_th = jnp.array([0.003, 0.001, 0.0008, 0.0006], jnp.float32)
    dial = jnp.array([1.0, 0.6, 0.2, 0.0], jnp.float32)
    sta1 = shard_planes_state(init_planes_state(cfg, rng=11), mesh1, cfg)
    sta8 = shard_planes_state(init_planes_state(cfg, rng=11), mesh8, cfg)
    astep1 = make_sharded_planes_chunked_step(cfg, mesh1, c, adaptive=True)
    astep8 = make_sharded_planes_chunked_step(cfg, mesh8, c, adaptive=True)
    sta1, esta1 = astep1(sta1, rots, trans, msc, floors_xy, floors_th, dial)
    sta8, esta8 = astep8(sta8, rots, trans, msc, floors_xy, floors_th, dial)
    np.testing.assert_allclose(np.asarray(esta1), np.asarray(esta8),
                               atol=1e-5)
    np.testing.assert_allclose(np.asarray(sta1.lm_mx),
                               np.asarray(sta8.lm_mx), atol=1e-5)
    # the single-device chunked kernel with the same floors/dial agrees
    from fastslam_tpu.core import kernels as _k
    stk = init_planes_state(cfg, rng=11)
    stk, estk = _k.fastslam_steps_planes_chunked(
        stk, rots, trans, msc, cfg,
        proposal_floors=(floors_xy, floors_th), evidence_scale=dial,
    )
    np.testing.assert_allclose(np.asarray(estk), np.asarray(esta8),
                               atol=1e-5)
