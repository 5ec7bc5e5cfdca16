"""Halo-exchange distributed resampling vs the single-device resampler —
bit-identical for the same u0, on both the halo path (healthy weights) and
the full-gather fallback (collapsed weights)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from fastslam_tpu.config import FastSLAMConfig
from fastslam_tpu.core import kernels
from fastslam_tpu.core.state import init_state, pad_measurements
from fastslam_tpu.parallel.mesh import make_mesh, shard_state
from fastslam_tpu.parallel.resample import halo_systematic_resample
from fastslam_tpu.parallel.sharded import make_sharded_step

CFG = FastSLAMConfig(num_particles=64, max_landmarks=8, max_measurements=4)


@pytest.fixture(scope="module")
def mesh():
    return make_mesh(CFG)


def make_state(weight_profile: str, seed=0):
    rng = np.random.default_rng(seed)
    st = init_state(CFG, rng=seed)
    poses = rng.normal(0, 1, (CFG.num_particles, 3)).astype(np.float32)
    mean = rng.normal(0, 3, (CFG.num_particles, CFG.max_landmarks, 2)).astype(np.float32)
    count = rng.integers(0, 4, CFG.num_particles).astype(np.int32)
    if weight_profile == "healthy":
        w = rng.uniform(0.8, 1.2, CFG.num_particles)
    elif weight_profile == "collapsed":
        w = np.full(CFG.num_particles, 1e-9)
        w[-3:] = 1.0  # all mass on the last shard
    w = (w / w.sum()).astype(np.float32)
    return st._replace(
        poses=jnp.asarray(poses),
        log_weights=jnp.log(jnp.asarray(w)),
        lm_mean=jnp.asarray(mean),
        lm_count=jnp.asarray(count),
    )


@pytest.mark.parametrize("profile", ["healthy", "collapsed"])
def test_halo_resample_matches_single_device(mesh, profile):
    st = make_state(profile)
    u0 = jnp.float32(0.007)

    idx = kernels.systematic_resample_indices(jnp.exp(st.log_weights), u0)
    want = kernels.resample_state(st, idx, CFG)

    st_sharded = shard_state(st, mesh, CFG)
    got = halo_systematic_resample(st_sharded, u0, mesh, CFG)

    np.testing.assert_allclose(np.asarray(got.poses), np.asarray(want.poses),
                               atol=1e-6)
    np.testing.assert_allclose(np.asarray(got.log_weights),
                               np.asarray(want.log_weights), atol=1e-6)
    np.testing.assert_allclose(np.asarray(got.lm_mean), np.asarray(want.lm_mean),
                               atol=1e-6)
    np.testing.assert_array_equal(np.asarray(got.lm_count),
                                  np.asarray(want.lm_count))
    # state remains sharded
    assert len(got.poses.addressable_shards) == 8


def test_sharded_step_with_distributed_resample(mesh):
    """Full sharded step with the halo resampler gives the same trajectory
    as the plain GSPMD step."""
    cfg_a = CFG
    cfg_b = CFG.replace(distributed_resample=True)
    ms = pad_measurements(CFG, [(2.0, 0.3), (3.5, -0.7)])

    st_a = shard_state(init_state(cfg_a, rng=9), mesh, cfg_a)
    st_b = shard_state(init_state(cfg_b, rng=9), mesh, cfg_b)
    step_a = make_sharded_step(cfg_a, mesh)
    step_b = make_sharded_step(cfg_b, mesh)

    for _ in range(4):
        st_a, pose_a = step_a(st_a, jnp.float32(0.0), jnp.float32(0.4), ms)
        st_b, pose_b = step_b(st_b, jnp.float32(0.0), jnp.float32(0.4), ms)

    np.testing.assert_allclose(np.asarray(pose_a), np.asarray(pose_b), atol=1e-5)
    np.testing.assert_allclose(np.asarray(st_a.lm_mean), np.asarray(st_b.lm_mean),
                               atol=1e-5)
