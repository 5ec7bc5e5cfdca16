"""Sharded filter step: the full FastSLAM iteration over a device mesh.

Strategy (idiomatic XLA/GSPMD, per the scaling-book recipe):

* state arrays carry a NamedSharding on the particle axis
  (:func:`fastslam_tpu.parallel.mesh.state_sharding`);
* the step function is ``jax.jit``-ed with matching in/out shardings plus
  ``lax.with_sharding_constraint`` pins inside, and XLA inserts the
  collectives: the weight-sum and Neff reductions become ``all-reduce``,
  the resampling ancestor gather becomes a cross-shard ``all-gather`` /
  ``collective-permute`` of particle blocks (landmark means + covariances
  travel with their particle, replacing the reference's deepcopy at
  ``fast_slam_2.py:196``), and the argmax pose estimate becomes a global
  ``all-reduce(max)``.

The planes steps run the fused kernel per shard under ``shard_map`` (it is
particle-parallel) and keep weights, Neff and resampling under GSPMD.  The
mesh is 1-D over particles.  The same compiled program runs on 1 device
(collectives no-op) or several; the tests exercise it on 8 virtual CPU
devices.
"""

from __future__ import annotations

from functools import partial
from typing import Tuple

import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from fastslam_tpu.config import FastSLAMConfig
from fastslam_tpu.core import kernels
from fastslam_tpu.core.state import FilterState, Measurements
from fastslam_tpu.parallel.mesh import planes_state_sharding, state_sharding


def _constrained_step(
    state: FilterState,
    rotation: jax.Array,
    translation: jax.Array,
    measurements: Measurements,
    config: FastSLAMConfig,
    mesh: Mesh,
) -> Tuple[FilterState, jax.Array]:
    """fastslam_step with explicit sharding pins on the carried state."""
    shardings = state_sharding(mesh, config)

    def pin(s: FilterState) -> FilterState:
        return jax.tree.map(jax.lax.with_sharding_constraint, s, shardings)

    state = pin(state)
    if not config.distributed_resample:
        new_state, pose = kernels.fastslam_step(
            state, rotation, translation, measurements, config
        )
        return pin(new_state), pose

    # decomposed step: propagate -> measurement update -> weights (GSPMD
    # collectives) -> halo-exchange resample -> estimate.  RNG stream
    # identical to kernels.fastslam_step.
    rng, k_rot, k_trans, k_u = jax.random.split(state.rng, 4)
    p = state.num_particles
    dt = state.poses.dtype
    rot_noise = config.rotation_noise * jax.random.normal(k_rot, (p,), dtype=dt)
    trans_noise = config.translation_noise * jax.random.normal(
        k_trans, (p,), dtype=dt
    )
    poses = kernels.propagate_particles(
        state.poses, rotation, translation, rot_noise, trans_noise
    )
    state = pin(state._replace(poses=poses, rng=rng))
    state = pin(kernels.update_particles(state, measurements, config))

    log_w = kernels.normalize_log_weights(state.log_weights, config)
    state = state._replace(log_weights=log_w)
    neff = kernels.effective_particles(log_w, config)
    u0 = jax.random.uniform(k_u, (), dtype=dt, maxval=1.0 / p)

    from fastslam_tpu.parallel.resample import halo_systematic_resample

    def do_resample(s):
        return halo_systematic_resample(s, u0, mesh, config)

    state = jax.lax.cond(
        neff < config.resample_threshold_frac * p, do_resample,
        lambda s: s, state,
    )
    return pin(state), kernels.estimate_pose(state)


def make_sharded_planes_step(config: FastSLAMConfig, mesh: Mesh):
    """Compile the planes-native filter step for a 1-D particle mesh.

    Same semantics as :func:`make_sharded_step` but the landmark state stays
    in the Pallas kernel's [L, P] layout between steps (no transposes)."""
    shardings = planes_state_sharding(mesh, config)
    repl = NamedSharding(mesh, P())
    ms_sharding = Measurements(range_bearing=repl, valid=repl)
    return jax.jit(
        partial(kernels.fastslam_step_planes, config=config, mesh=mesh),
        in_shardings=(shardings, repl, repl, ms_sharding),
        out_shardings=(shardings, repl),
        donate_argnums=0,
    )


def make_sharded_planes_chunked_step(config: FastSLAMConfig, mesh: Mesh,
                                     chunk_size: int,
                                     adaptive: bool = False):
    """Compile the multi-tick chunked planes step for a 1-D particle mesh.

    Returns ``step(state, rotations [C], translations [C], measurements
    [C, M, ...])`` -> ``(state, per-tick pose estimates [C, 3])``.

    With ``adaptive=True`` (fs2 only) the step takes three extra
    REPLICATED per-tick rows — ``floors_xy [C], floors_th [C], dial [C]``
    — the adaptive-estimator outputs the single-device chunked path traces
    in (kernels.fastslam_steps_planes_chunked ``proposal_floors`` /
    ``evidence_scale``), so the flagship fs2+adaptive replay runs
    identically on the mesh."""
    if config.parity_mode:
        raise ValueError("chunked execution is production-mode only")
    shardings = planes_state_sharding(mesh, config)
    repl = NamedSharding(mesh, P())
    ms_sharding = Measurements(range_bearing=repl, valid=repl)
    if adaptive:
        if config.proposal_mode != "fastslam2":
            raise ValueError("adaptive floors/dial are fs2-proposal inputs")

        def step(state, rotations, translations, measurements,
                 floors_xy, floors_th, dial):
            return kernels.fastslam_steps_planes_chunked(
                state, rotations, translations, measurements, config,
                proposal_floors=(floors_xy, floors_th),
                evidence_scale=dial, mesh=mesh,
            )

        return jax.jit(
            step,
            in_shardings=(shardings, repl, repl, ms_sharding,
                          repl, repl, repl),
            out_shardings=(shardings, repl),
            donate_argnums=0,
        )
    return jax.jit(
        partial(kernels.fastslam_steps_planes_chunked, config=config,
                mesh=mesh),
        in_shardings=(shardings, repl, repl, ms_sharding),
        out_shardings=(shardings, repl),
        donate_argnums=0,
    )


def make_sharded_step(config: FastSLAMConfig, mesh: Mesh):
    """Compile the full filter step for the mesh.

    Returns ``step(state, rotation, translation, measurements)`` with state
    sharded over ``config.particle_axis`` and the pose estimate replicated.
    """
    shardings = state_sharding(mesh, config)
    repl = NamedSharding(mesh, P())
    ms_sharding = Measurements(range_bearing=repl, valid=repl)
    return jax.jit(
        partial(_constrained_step, config=config, mesh=mesh),
        in_shardings=(shardings, repl, repl, ms_sharding),
        out_shardings=(shardings, repl),
    )
