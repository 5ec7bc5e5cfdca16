"""Distributed systematic resampling with bounded communication.

The GSPMD path resamples by a global gather, which XLA lowers to an
all-gather of every particle block — O(P x block) traffic regardless of how
far particles actually migrate (SURVEY.md §7.3 hard part 3).  This module
exploits the structure of systematic (low-variance) resampling:

* ancestor indices are **non-decreasing** — each destination shard's
  ancestors form a contiguous window of the global particle array;
* with healthy (near-uniform post-normalization) weights that window lies
  within the shard's own block ± a small overhang.

So: all-gather the *weights only* (4 bytes/particle), compute this shard's
global ancestor indices, exchange one-block halos with the left/right
neighbours via ``ppermute`` (3x block traffic, independent of shard count),
and gather locally when the window fits — falling back to the full gather on
degenerate ticks (weight mass collapsed onto a far shard).  The fallback
decision is a scalar ``lax.cond``; results are bit-identical to the
single-device resampler for the same ``u0``.
"""

from __future__ import annotations

from functools import partial
from typing import Tuple

import jax
import jax.numpy as jnp
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

from fastslam_tpu.config import FastSLAMConfig
from fastslam_tpu.core.state import FilterState


def shard_ancestor_window(logw, u0, *, axis: str, num_shards: int):
    """The halo resampler's ancestor-window math: all-gather the
    weights (4 B/particle), compute this shard's GLOBAL systematic ancestor
    indices, and decide — with a psum so every shard agrees — whether every
    shard's window fits in [own block ± one neighbor block].

    Returns ``(idx, safe_local, use_halo)``:
      idx        [P_local] global ancestor indices (for the fallback gather)
      safe_local [P_local] indices into the ``[3*P_local]`` halo window
                 (left | own | right), clipped
      use_halo   scalar bool, identical on every shard
    """
    p_local = logw.shape[0]
    p_global = p_local * num_shards
    shard = jax.lax.axis_index(axis)
    my_start = shard * p_local

    w_local = jnp.exp(logw)
    w_all = jax.lax.all_gather(w_local, axis, tiled=True)       # [P]
    cum = jnp.cumsum(w_all)
    # search-free systematic indices over the global grid, sliced to this
    # shard's output positions [my_start, my_start + p_local) — the SAME
    # staircase helper as the single-device resampler, so the bit-match
    # invariant between the distributed and single-device paths holds by
    # construction (kernels.grid_staircase_indices)
    from fastslam_tpu.core.kernels import grid_staircase_indices

    idx_all = grid_staircase_indices(cum, u0, p_global)          # [P]
    idx = jax.lax.dynamic_slice(idx_all, (my_start,), (p_local,))

    local_idx = idx - (my_start - p_local)
    # Ring wrap-around is safe at the edges: global idx is always in
    # [0, P), so shard 0 can never index into its (wrapped) left halo and
    # the last shard can never index into its (wrapped) right halo.
    my_in_window = jnp.all((local_idx >= 0) & (local_idx < 3 * p_local))
    # the fallback branch contains a collective (all_gather), so EVERY
    # shard must take the same branch — make the predicate global
    use_halo = jax.lax.psum((~my_in_window).astype(jnp.int32), axis) == 0
    safe_local = jnp.clip(local_idx, 0, 3 * p_local - 1)
    return idx, safe_local, use_halo


def _resample_body(poses, logw, lm_mean, lm_cov, lm_count, u0,
                   *, axis: str, num_shards: int, parity: bool):
    p_local = poses.shape[0]
    p_global = p_local * num_shards

    idx, safe_local, use_halo = shard_ancestor_window(
        logw, u0, axis=axis, num_shards=num_shards
    )

    block = (poses, logw, lm_mean, lm_cov, lm_count)

    # one-block halos from the ring neighbours (wrap-around is harmless: the
    # in-window test below rejects wrapped indices).  ppermute pairs are
    # (source, dest): the left halo of shard i is shard i-1's block.
    left = jax.tree.map(
        lambda x: jax.lax.ppermute(
            x, axis, [((i - 1) % num_shards, i) for i in range(num_shards)]
        ),
        block,
    )
    right = jax.tree.map(
        lambda x: jax.lax.ppermute(
            x, axis, [((i + 1) % num_shards, i) for i in range(num_shards)]
        ),
        block,
    )
    window = jax.tree.map(
        lambda a, b, c: jnp.concatenate([a, b, c], axis=0), left, block, right
    )                                                            # [3*P_local, ...]

    def from_halo(_):
        return jax.tree.map(lambda x: jnp.take(x, safe_local, axis=0), window)

    def from_full(_):
        full = jax.tree.map(
            lambda x: jax.lax.all_gather(x, axis, tiled=True), block
        )
        return jax.tree.map(lambda x: jnp.take(x, idx, axis=0), full)

    new_poses, new_logw, new_mean, new_cov, new_count = jax.lax.cond(
        use_halo, from_halo, from_full, None
    )
    if not parity:
        new_logw = jnp.full((p_local,), -jnp.log(p_global), dtype=logw.dtype)
    return new_poses, new_logw, new_mean, new_cov, new_count


def halo_systematic_resample(
    state: FilterState, u0: jax.Array, mesh: Mesh, config: FastSLAMConfig
) -> FilterState:
    """Resample the sharded state; drop-in for
    ``resample_state(state, systematic_resample_indices(...), config)``."""
    axis = config.particle_axis
    num_shards = mesh.shape[axis]
    pspec = P(axis)

    body = shard_map(
        partial(_resample_body, axis=axis, num_shards=num_shards,
                parity=config.parity_mode),
        mesh=mesh,
        in_specs=(P(axis, None), pspec, P(axis, None, None),
                  P(axis, None, None), pspec, P()),
        out_specs=(P(axis, None), pspec, P(axis, None, None),
                   P(axis, None, None), pspec),
        check_vma=False,
    )
    poses, logw, mean, cov, count = body(
        state.poses, state.log_weights, state.lm_mean, state.lm_cov,
        state.lm_count, u0,
    )
    return state._replace(
        poses=poses, log_weights=logw, lm_mean=mean, lm_cov=cov, lm_count=count
    )
