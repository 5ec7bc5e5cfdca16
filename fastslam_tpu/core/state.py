"""Structure-of-arrays filter state.

The reference keeps an array-of-structures particle list — ``Particle`` objects
each holding a Python list of ``Landmark`` objects with per-landmark 2x2
numpy covariances (``fast_slam_2/models/particle.py:6-20``,
``models/landmark.py:13``).  That representation cannot scale and cannot be
jitted.  Here the whole filter is one pytree of fixed-shape device arrays:

  poses        [P, 3]        particle (x, y, yaw)
  log_weights  [P]           log importance weights
  lm_mean      [P, L, 2]     landmark means (world frame)
  lm_cov       [P, L, 4]     2x2 covariances flattened row-major (a, b, c, d)
  lm_count     [P]           number of valid landmark slots per particle
  rng          PRNG key

Ragged per-particle landmark lists become a fixed capacity ``L`` with a
validity count; "append a landmark" (reference ``fast_slam_2.py:108-111``)
becomes a masked write at slot ``lm_count`` and an increment.

Sharding: ``poses/log_weights/lm_mean/lm_cov/lm_count`` all shard on the
leading particle axis (mesh axis ``config.particle_axis``); the RNG key is
replicated.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from fastslam_tpu.config import FastSLAMConfig


class FilterState(NamedTuple):
    """The complete FastSLAM filter state as a pytree of device arrays."""

    poses: jax.Array        # [P, 3] float
    log_weights: jax.Array  # [P] float
    lm_mean: jax.Array      # [P, L, 2] float
    lm_cov: jax.Array       # [P, L, 4] float, row-major 2x2
    lm_count: jax.Array     # [P] int32
    rng: jax.Array          # PRNG key

    @property
    def num_particles(self) -> int:
        return self.poses.shape[0]

    @property
    def max_landmarks(self) -> int:
        return self.lm_mean.shape[1]

    @property
    def weights(self) -> jax.Array:
        """Linear-space weights [P]."""
        return jnp.exp(self.log_weights)

    def lm_valid_mask(self) -> jax.Array:
        """[P, L] bool — True where a landmark slot is occupied."""
        slots = jax.lax.broadcasted_iota(jnp.int32, self.lm_mean.shape[:2], 1)
        return slots < self.lm_count[:, None]


def init_state(config: FastSLAMConfig, rng: jax.Array | int = 0) -> FilterState:
    """Fresh filter state: all particles at the origin with uniform weights.

    Mirrors reference initialization (``fast_slam_2.py:25-31``: particles at
    (0,0,0), weight 1/N from ``particle.py:19``, empty landmark lists).
    """
    if isinstance(rng, int):
        rng = jax.random.key(rng)
    p = config.num_particles
    l = config.max_landmarks
    dt = jnp.dtype(config.dtype)
    return FilterState(
        poses=jnp.zeros((p, 3), dtype=dt),
        log_weights=jnp.full((p,), -jnp.log(p).astype(dt), dtype=dt),
        lm_mean=jnp.zeros((p, l, 2), dtype=dt),
        lm_cov=jnp.zeros((p, l, 4), dtype=dt),
        lm_count=jnp.zeros((p,), dtype=jnp.int32),
        rng=rng,
    )


class PlanesState(NamedTuple):
    """Filter state in the fused kernel's *planes* layout.

    The fused filter kernel (``core/pallas_kernels.py``) wants each landmark
    component as an ``[L, P]`` plane — particles on the minor axis, so a
    particle tile's loads are contiguous — and per-particle scalars as
    ``[P]`` rows.  :class:`FilterState` stores ``[P, L, k]`` blocks; keeping
    the state natively in planes between steps avoids a layout conversion
    around every kernel launch.  The remaining per-``[P]`` ops (weights,
    Neff, resampling gather, pose estimate) are layout-indifferent.

    ``lm_cc`` is ``None`` on the PRODUCTION path (``parity_mode=False``): the
    production EKF symmetrizes every covariance write and appends set
    ``b = c = 0``, so ``cc == cb`` is invariant and the plane is dropped from
    the state entirely — one less [L, P] plane streamed per kernel call,
    gathered per resample, and checkpointed.  Parity mode keeps the
    reference's asymmetric ``(I-KH)S`` covariance (fast_slam_2.py:146), so
    there ``lm_cc`` is a real plane.  Consumers use
    ``lm_cc if lm_cc is not None else lm_cb``.
    """

    poses: jax.Array        # [P, 3] float
    log_weights: jax.Array  # [P] float
    lm_mx: jax.Array        # [L, P] landmark mean x
    lm_my: jax.Array        # [L, P] landmark mean y
    lm_ca: jax.Array        # [L, P] cov a (row-major 2x2: a b / c d)
    lm_cb: jax.Array        # [L, P]
    lm_cc: jax.Array | None  # [L, P] (None when symmetric: production mode)
    lm_cd: jax.Array        # [L, P]
    lm_count: jax.Array     # [P] int32
    rng: jax.Array          # PRNG key

    @property
    def num_particles(self) -> int:
        return self.poses.shape[0]

    @property
    def max_landmarks(self) -> int:
        return self.lm_mx.shape[0]


def to_planes(state: FilterState,
              config: FastSLAMConfig | None = None) -> PlanesState:
    """[P, L, k] blocks -> [L, P] planes.

    With a production ``config`` (``parity_mode=False``) the redundant
    ``lm_cc`` plane is dropped (``None`` — see :class:`PlanesState`); the
    block state's symmetrized covariance guarantees ``cov[..., 2] ==
    cov[..., 1]``.  Without a config (or in parity mode) all six planes are
    kept.
    """
    sym = config is not None and not config.parity_mode
    return PlanesState(
        poses=state.poses,
        log_weights=state.log_weights,
        lm_mx=state.lm_mean[:, :, 0].T,
        lm_my=state.lm_mean[:, :, 1].T,
        lm_ca=state.lm_cov[:, :, 0].T,
        lm_cb=state.lm_cov[:, :, 1].T,
        lm_cc=None if sym else state.lm_cov[:, :, 2].T,
        lm_cd=state.lm_cov[:, :, 3].T,
        lm_count=state.lm_count,
        rng=state.rng,
    )


def from_planes(state: PlanesState) -> FilterState:
    """[L, P] planes -> [P, L, k] blocks."""
    cc = state.lm_cc if state.lm_cc is not None else state.lm_cb
    return FilterState(
        poses=state.poses,
        log_weights=state.log_weights,
        lm_mean=jnp.stack([state.lm_mx.T, state.lm_my.T], axis=-1),
        lm_cov=jnp.stack(
            [state.lm_ca.T, state.lm_cb.T, cc.T, state.lm_cd.T], axis=-1,
        ),
        lm_count=state.lm_count,
        rng=state.rng,
    )


def init_planes_state(config: FastSLAMConfig, rng: jax.Array | int = 0) -> PlanesState:
    """Fresh planes-layout state."""
    if isinstance(rng, int):
        rng = jax.random.key(rng)
    p = config.num_particles
    l = config.max_landmarks
    dt = jnp.dtype(config.dtype)
    # distinct buffers (a shared zeros array would alias, breaking
    # donation: the same buffer cannot be donated six times)
    plane = lambda: jnp.zeros((l, p), dtype=dt)
    return PlanesState(
        poses=jnp.zeros((p, 3), dtype=dt),
        log_weights=jnp.full((p,), -jnp.log(p).astype(dt), dtype=dt),
        lm_mx=plane(), lm_my=plane(), lm_ca=plane(),
        lm_cb=plane(),
        # production keeps cc == cb — no cc plane (see PlanesState)
        lm_cc=plane() if config.parity_mode else None,
        lm_cd=plane(),
        lm_count=jnp.zeros((p,), dtype=jnp.int32),
        rng=rng,
    )


class Measurements(NamedTuple):
    """A padded batch of range/bearing measurements for one tick.

    The reference passes a Python ``list[Measurement]`` of (distance, yaw)
    pairs (``models/measurement.py:4-16``); here it is a fixed-capacity array
    plus a validity mask so the shape is static under jit.
    """

    range_bearing: jax.Array  # [M, 2] float: (distance, bearing)
    valid: jax.Array          # [M] bool

    @property
    def capacity(self) -> int:
        return self.range_bearing.shape[0]


def pad_measurements(
    config: FastSLAMConfig, range_bearing, dtype=jnp.float32
) -> Measurements:
    """Pack a host-side list/array of (distance, bearing) into a padded batch."""
    import numpy as np

    arr = np.asarray(range_bearing, dtype=dtype).reshape(-1, 2)
    m = config.max_measurements
    n = min(arr.shape[0], m)
    out = np.zeros((m, 2), dtype=dtype)
    out[:n] = arr[:n]
    valid = np.zeros((m,), dtype=bool)
    valid[:n] = True
    return Measurements(jnp.asarray(out), jnp.asarray(valid))
