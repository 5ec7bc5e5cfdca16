"""Array-native density clustering (DBSCAN-equivalent) with static shapes.

The reference uses ``sklearn.cluster.DBSCAN`` twice
(``fast_slam_2/utils/geometry_utils.py:26-62``):

* intersections: ``eps=0.5, min_samples=1`` (``landmark_utils.py:56-60``) —
  with ``min_samples=1`` DBSCAN degenerates to connected components of the
  eps-neighbourhood graph;
* viz landmark merge: ``eps=0.5, min_samples=0.7*avg`` (``:131-139``) — full
  DBSCAN with core points, border points, and noise.

Both are rebuilt here as dense adjacency matrices + iterated min-label
propagation (a classic parallel connected-components scheme: every node
repeatedly adopts the smallest label in its neighbourhood; converges in
O(log N) doubling steps because we propagate labels-of-labels too).  The
output is a per-point cluster *representative* index plus masked centroids,
all at static shape — no dynamic cluster count anywhere.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp


class Clusters(NamedTuple):
    centroid: jax.Array  # [N, 2]  centroid of the cluster containing point i
    is_rep: jax.Array    # [N] bool  True on exactly one member per cluster
    label: jax.Array     # [N] int32 root index of the cluster (min member idx)


def _propagate_min_labels(adj: jax.Array, valid: jax.Array, iters: int) -> jax.Array:
    """Min-label propagation over a boolean adjacency matrix ``[N, N]``.

    Doubling trick: after taking the min over neighbours we also take
    ``labels[labels]`` (pointer jumping), so convergence needs ~log2(N) iters.
    """
    n = adj.shape[0]
    idx = jnp.arange(n, dtype=jnp.int32)
    labels = jnp.where(valid, idx, jnp.int32(n))

    def body(_, labels):
        neigh = jnp.where(adj, labels[None, :], jnp.int32(n))
        labels = jnp.minimum(labels, jnp.min(neigh, axis=1))
        labels = jnp.where(valid, jnp.minimum(labels, labels[labels]), jnp.int32(n))
        return labels

    return jax.lax.fori_loop(0, iters, body, labels)


def connected_component_clusters(
    points: jax.Array, valid: jax.Array, eps: float, iters: int = 16
) -> Clusters:
    """DBSCAN with ``min_samples=1`` == connected components of the eps-graph.

    Args:
      points: ``[N, 2]``; valid: ``[N]`` bool; eps: neighbourhood radius.
    """
    n = points.shape[0]
    diff = points[:, None, :] - points[None, :, :]
    d2 = jnp.sum(diff * diff, axis=-1)
    adj = (d2 <= eps * eps) & valid[:, None] & valid[None, :]
    labels = _propagate_min_labels(adj, valid, iters)
    return _centroids(points, valid, labels)


def dbscan_clusters(
    points: jax.Array, valid: jax.Array, eps: float, min_samples: jax.Array,
    iters: int = 16,
) -> Clusters:
    """Full DBSCAN (core/border/noise) with a *traced* ``min_samples``.

    Matches sklearn semantics: a point is core if its eps-ball (including
    itself) holds >= min_samples points; clusters are connected components of
    core points; non-core points join an arbitrary neighbouring core cluster
    (we pick the smallest label); everything else is noise (invalid).
    """
    n = points.shape[0]
    diff = points[:, None, :] - points[None, :, :]
    d2 = jnp.sum(diff * diff, axis=-1)
    adj = (d2 <= eps * eps) & valid[:, None] & valid[None, :]
    degree = jnp.sum(adj, axis=1)  # includes self (d2 diag == 0)
    core = valid & (degree >= min_samples)

    core_adj = adj & core[:, None] & core[None, :]
    labels = _propagate_min_labels(core_adj, core, iters)

    # border points adopt the min core label among neighbours
    neigh_core_labels = jnp.where(adj & core[None, :], labels[None, :], jnp.int32(n))
    border_label = jnp.min(neigh_core_labels, axis=1)
    labels = jnp.where(core, labels, border_label)
    clustered = labels < n
    return _centroids(points, clustered, labels)


def _centroids(points: jax.Array, valid: jax.Array, labels: jax.Array) -> Clusters:
    n = points.shape[0]
    idx = jnp.arange(n, dtype=jnp.int32)
    safe = jnp.where(valid, labels, n - 1)
    # member[c, i]: point i is in the cluster rooted at c.  Masked row sums,
    # not a scatter-add: a GPU scatter-add adds colliding updates with
    # atomics in no fixed order, so the centroids (and every measurement
    # downstream) would change in their last bits from run to run.
    member = valid[None, :] & (safe[None, :] == idx[:, None])      # [N, N]
    total = lambda v: jnp.sum(jnp.where(member, v[None, :], 0.0), axis=1)
    denom = jnp.maximum(jnp.sum(member, axis=1), 1).astype(points.dtype)
    cx = (total(points[:, 0]) / denom)[safe]
    cy = (total(points[:, 1]) / denom)[safe]
    is_rep = valid & (labels == idx)
    return Clusters(
        centroid=jnp.stack([cx, cy], axis=-1),
        is_rep=is_rep,
        label=jnp.where(valid, labels, jnp.int32(n)),
    )
