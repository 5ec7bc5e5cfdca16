"""Device mesh helpers for particle-axis data parallelism.

The reference's only parallelism is a GIL-bound thread pool over 20 particles
(``fast_slam_2.py:42-53``, SURVEY.md §2.2).  Here particles are a sharded
array axis over a ``jax.sharding.Mesh``: every per-particle kernel shards
trivially, and the global reductions the reference does serially (weight
normalization ``:161-175``, Neff ``:212-223``, argmax pose ``:201-210``,
resampling ``:177-199``) compile to XLA collectives (NCCL on GPUs) via GSPMD —
we annotate shardings and let the compiler insert psum/all-gather where
needed (the scaling-book recipe).
"""

from __future__ import annotations

from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from fastslam_tpu.config import FastSLAMConfig
from fastslam_tpu.core.state import FilterState, PlanesState


def make_mesh(config: FastSLAMConfig, devices: Optional[Sequence] = None,
              map_parallelism: int = 1) -> Mesh:
    """1-D (or 2-D with a map axis) mesh over the given devices."""
    devices = list(devices if devices is not None else jax.devices())
    n = len(devices)
    if map_parallelism > 1:
        assert n % map_parallelism == 0
        shape = (n // map_parallelism, map_parallelism)
        return Mesh(
            np.asarray(devices).reshape(shape),
            (config.particle_axis, config.map_axis),
        )
    return Mesh(np.asarray(devices), (config.particle_axis,))


def state_sharding(mesh: Mesh, config: FastSLAMConfig) -> FilterState:
    """A FilterState-shaped pytree of NamedShardings.

    Every array shards on its leading particle axis; when the mesh also has a
    map axis (2-D mesh), the landmark-slot dimension of ``lm_mean``/``lm_cov``
    shards over it as well — association then reduces over a sharded L axis
    and XLA inserts the cross-shard min/any collectives.  RNG key replicated.
    """
    pax = config.particle_axis
    max_ = config.map_axis if config.map_axis in mesh.axis_names else None
    s = lambda *spec: NamedSharding(mesh, P(*spec))
    return FilterState(
        poses=s(pax, None),
        log_weights=s(pax),
        lm_mean=s(pax, max_, None),
        lm_cov=s(pax, max_, None),
        lm_count=s(pax),
        rng=s(),
    )


def shard_state(state: FilterState, mesh: Mesh, config: FastSLAMConfig) -> FilterState:
    """Place an existing state onto the mesh with the canonical sharding."""
    sh = state_sharding(mesh, config)
    return jax.tree.map(jax.device_put, state, sh)


def planes_state_sharding(mesh: Mesh, config: FastSLAMConfig) -> PlanesState:
    """A PlanesState-shaped pytree of NamedShardings.

    Landmark planes are ``[L, P]`` — particles on the LAST axis — so they
    shard on axis 1; per-particle arrays shard on axis 0.  The planes step
    keeps every particle's full landmark block local (the fused kernel keeps
    all L slots of its particles on chip), so the mesh must be 1-D over the
    particle axis.
    """
    pax = config.particle_axis
    if config.map_axis in mesh.axis_names and mesh.shape[config.map_axis] > 1:
        raise ValueError("planes sharding requires a 1-D particle-axis mesh")
    s = lambda *spec: NamedSharding(mesh, P(*spec))
    plane = s(None, pax)
    return PlanesState(
        poses=s(pax, None),
        log_weights=s(pax),
        lm_mx=plane, lm_my=plane, lm_ca=plane,
        lm_cb=plane,
        # production planes states carry no cc plane (see PlanesState)
        lm_cc=plane if config.parity_mode else None,
        lm_cd=plane,
        lm_count=s(pax),
        rng=s(),
    )


def shard_planes_state(state: PlanesState, mesh: Mesh,
                       config: FastSLAMConfig) -> PlanesState:
    """Place an existing planes state onto the mesh.

    A production config drops the redundant ``lm_cc`` plane if the state
    still carries one (``cc == cb`` on that path — see PlanesState)."""
    sh = planes_state_sharding(mesh, config)
    if sh.lm_cc is None and state.lm_cc is not None:
        state = state._replace(lm_cc=None)
    return jax.tree.map(jax.device_put, state, sh)
