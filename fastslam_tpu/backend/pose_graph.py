"""Pose-graph / bundle-adjustment backend over keyframes.

Fully greenfield — the reference has no backend (SURVEY.md §7.3 #6); the
filter's trajectory drifts and is never re-optimized.  The north star
(BASELINE.json config #5) asks for a keyframe + landmark-block backend with
distributed Schur-complement reduction.  Design:

Variables
  poses      [K, 3]   keyframe (x, y, theta)
  landmarks  [L, 2]   world-frame landmark positions (masked capacity)

Factors (all masked fixed-capacity)
  prior on pose 0                         anchors the gauge
  odometry   [K-1]    relative SE(2) between consecutive keyframes
  observation [F]     (range, bearing) from keyframe k to landmark j

Solver: damped Gauss-Newton (Levenberg-Marquardt) on the normal equations
with **landmark elimination via the Schur complement** — the structure that
makes this scale to 1M landmarks:

  [Hpp  Hpl] [dp]   [bp]
  [Hpl' Hll] [dl] = [bl]

Hll is block-diagonal 2x2 per landmark (closed-form inverse, embarrassingly
parallel), so

  S  = Hpp - Hpl Hll^-1 Hpl'          (reduced pose system, 3K x 3K dense)
  rs = bp  - Hpl Hll^-1 bl
  dp = solve(S, rs);   dl = Hll^-1 (bl - Hpl' dp)

Distribution: landmarks (and their observation factors) shard over the map
axis.  Each shard computes its partial S and rs contribution — a [3K, 3K]
psum — poses are solved replicated (K is small: keyframes, not scans), and
back-substitution is local per shard.  ``schur_normal_equations`` is written
as pure segment-sum/scatter math so the same code runs single-device or under
shard_map (see ``parallel`` wrapper below).
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import functools

import jax
import jax.numpy as jnp

# float32 contractions at full precision: a GPU would otherwise run them as
# TF32 (~3 decimal digits), which the Schur solve cannot afford
_einsum = functools.partial(jnp.einsum, precision=jax.lax.Precision.HIGHEST)


def wrap_angle(a):
    return (a + jnp.pi) % (2.0 * jnp.pi) - jnp.pi


class PoseGraph(NamedTuple):
    """Problem data; all capacities static, masked."""

    poses: jax.Array        # [K, 3] initial keyframe poses
    landmarks: jax.Array    # [L, 2] initial landmark estimates
    lm_valid: jax.Array     # [L] bool

    odo_rel: jax.Array      # [K-1, 3] relative (dx, dy, dtheta) in frame of k
    odo_info: jax.Array     # [K-1, 3] diagonal information (1/sigma^2)
    odo_valid: jax.Array    # [K-1] bool

    obs_kf: jax.Array       # [F] int32 keyframe index
    obs_lm: jax.Array       # [F] int32 landmark index
    obs_rb: jax.Array       # [F, 2] (range, bearing)
    obs_info: jax.Array     # [F, 2] diagonal information
    obs_valid: jax.Array    # [F] bool

    prior_info: jax.Array   # [3] information anchoring pose 0


# ---------------------------------------------------------------------------
# residuals + analytic Jacobians
# ---------------------------------------------------------------------------

def _odo_residuals(poses, g: PoseGraph):
    """Relative-pose residuals r_k = T_k^{-1} T_{k+1} (-) z_k, [K-1, 3]."""
    pa = poses[:-1]
    pb = poses[1:]
    c = jnp.cos(pa[:, 2])
    s = jnp.sin(pa[:, 2])
    dx = pb[:, 0] - pa[:, 0]
    dy = pb[:, 1] - pa[:, 1]
    # into frame of pose a
    rx = c * dx + s * dy
    ry = -s * dx + c * dy
    rt = wrap_angle(pb[:, 2] - pa[:, 2])
    r = jnp.stack(
        [rx - g.odo_rel[:, 0], ry - g.odo_rel[:, 1], wrap_angle(rt - g.odo_rel[:, 2])],
        axis=-1,
    )
    return r, (c, s, dx, dy)


def _obs_residuals(poses, landmarks, g: PoseGraph):
    """Range/bearing residuals [F, 2] and geometry terms."""
    pk = poses[g.obs_kf]                     # [F, 3]
    lw = landmarks[g.obs_lm]                 # [F, 2]
    dx = lw[:, 0] - pk[:, 0]
    dy = lw[:, 1] - pk[:, 1]
    q = jnp.maximum(dx * dx + dy * dy, 1e-12)
    r = jnp.sqrt(q)
    pred_r = r
    pred_b = jnp.arctan2(dy, dx) - pk[:, 2]
    res = jnp.stack(
        [g.obs_rb[:, 0] - pred_r, wrap_angle(g.obs_rb[:, 1] - pred_b)], axis=-1
    )
    return res, (dx, dy, q, r)


# ---------------------------------------------------------------------------
# normal equations with Schur elimination
# ---------------------------------------------------------------------------

def pose_system(poses, g: PoseGraph, damping: jax.Array):
    """Pose-only normal-equation part: odometry + prior + damping.

    Returns (big_h [K, K, 3, 3], bp [K, 3]).  Replicated under sharding —
    keyframes are few; landmarks are many.
    """
    k = poses.shape[0]

    # ---- odometry factors: block-tridiagonal Hpp, rhs ----
    r_odo, (c, s, dx, dy) = _odo_residuals(poses, g)
    w_odo = jnp.where(g.odo_valid[:, None], g.odo_info, 0.0)      # [K-1, 3]

    # Jacobian of r wrt pose a: [[-c, -s, -s*dx + c*dy], [s, -c, -c*dx - s*dy],
    # [0, 0, -1]]; wrt pose b: [[c, s, 0], [-s, c, 0], [0, 0, 1]]
    zeros = jnp.zeros_like(c)
    ones = jnp.ones_like(c)
    ja = jnp.stack([
        jnp.stack([-c, -s, -s * dx + c * dy], -1),
        jnp.stack([s, -c, -c * dx - s * dy], -1),
        jnp.stack([zeros, zeros, -ones], -1),
    ], axis=1)                                                    # [K-1, 3, 3]
    jb = jnp.stack([
        jnp.stack([c, s, zeros], -1),
        jnp.stack([-s, c, zeros], -1),
        jnp.stack([zeros, zeros, ones], -1),
    ], axis=1)

    wja = ja * w_odo[:, :, None]     # W J_a  (diag weight)
    wjb = jb * w_odo[:, :, None]

    haa = _einsum("fij,fik->fjk", ja, wja)       # [K-1, 3, 3]
    hbb = _einsum("fij,fik->fjk", jb, wjb)
    hab = _einsum("fij,fik->fjk", ja, wjb)
    ba = -_einsum("fij,fi->fj", wja, r_odo)      # [K-1, 3]
    bb = -_einsum("fij,fi->fj", wjb, r_odo)

    big_h = jnp.zeros((k, k, 3, 3))
    idx = jnp.arange(k - 1)
    big_h = big_h.at[idx, idx].add(haa)
    big_h = big_h.at[idx + 1, idx + 1].add(hbb)
    big_h = big_h.at[idx, idx + 1].add(hab)
    big_h = big_h.at[idx + 1, idx].add(jnp.swapaxes(hab, 1, 2))
    bp = jnp.zeros((k, 3)).at[idx].add(ba).at[idx + 1].add(bb)

    # ---- prior on pose 0 (anchors gauge; residual is zero at linearization,
    # only the information enters) ----
    big_h = big_h.at[0, 0].add(jnp.diag(g.prior_info))

    # LM damping on the pose blocks
    big_h = big_h.at[jnp.arange(k), jnp.arange(k)].add(
        damping * jnp.eye(3)[None, :, :]
    )
    return big_h, bp


def landmark_system(poses, landmarks, g: PoseGraph, damping: jax.Array):
    """Landmark/observation normal-equation part + Schur reduction terms.

    Everything here depends only on the landmark slots and their observation
    factors, so under shard_map with landmarks (and their factors) on the map
    axis this whole function is shard-local; the returned ``(hpp_diag,
    bp_obs, cross, rs_corr)`` are partial sums to be ``psum``-ed, while
    ``(hll_inv, bl, hpl_dense)`` stay local for back-substitution.
    """
    k = poses.shape[0]
    l = landmarks.shape[0]

    r_obs, (odx, ody, q, rr) = _obs_residuals(poses, landmarks, g)
    w_obs = jnp.where(g.obs_valid[:, None], g.obs_info, 0.0)      # [F, 2]

    # d(range)/d(lx, ly) = (dx/r, dy/r); d(bearing)/d(lx, ly) = (-dy/q, dx/q)
    jl = jnp.stack([
        jnp.stack([odx / rr, ody / rr], -1),
        jnp.stack([-ody / q, odx / q], -1),
    ], axis=1)                                                    # [F, 2, 2]
    # wrt pose (x, y, theta): range: (-dx/r, -dy/r, 0); bearing: (dy/q, -dx/q, -1)
    fzeros = jnp.zeros_like(rr)
    jp = jnp.stack([
        jnp.stack([-odx / rr, -ody / rr, fzeros], -1),
        jnp.stack([ody / q, -odx / q, -jnp.ones_like(rr)], -1),
    ], axis=1)                                                    # [F, 2, 3]

    wjl = jl * w_obs[:, :, None]
    wjp = jp * w_obs[:, :, None]

    # jl/jp are d(pred)/dx, and r = z - pred, so the GN system is
    # (J~' W J~) d = +J~' W r (minimize ||r - J~ d||^2) — note the + sign,
    # unlike the odometry factors above where r is defined as pred - z.
    hpp_f = _einsum("fip,fiq->fpq", jp, wjp)     # [F, 3, 3]
    hll_f = _einsum("fia,fib->fab", jl, wjl)     # [F, 2, 2]
    hpl_f = _einsum("fip,fia->fpa", wjp, jl)     # [F, 3, 2]
    bp_f = _einsum("fip,fi->fp", wjp, r_obs)     # [F, 3]
    bl_f = _einsum("fia,fi->fa", wjl, r_obs)     # [F, 2]

    hpp_diag = jnp.zeros((k, 3, 3)).at[g.obs_kf].add(hpp_f)
    bp_obs = jnp.zeros((k, 3)).at[g.obs_kf].add(bp_f)

    hll = jnp.zeros((l, 2, 2)).at[g.obs_lm].add(hll_f)
    bl = jnp.zeros((l, 2)).at[g.obs_lm].add(bl_f)
    hll = hll + damping * jnp.eye(2)[None, :, :]

    # closed-form 2x2 inverse of Hll (invalid/unobserved -> zero influence)
    a = hll[:, 0, 0]
    b = hll[:, 0, 1]
    c2 = hll[:, 1, 0]
    d = hll[:, 1, 1]
    det = a * d - b * c2
    observed = det > 1e-12
    inv_det = jnp.where(observed, 1.0 / jnp.where(observed, det, 1.0), 0.0)
    hll_inv = jnp.stack([
        jnp.stack([d, -b], -1), jnp.stack([-c2, a], -1)
    ], axis=1) * inv_det[:, None, None]

    # ---- Schur reduction: S = Hpp - Hpl Hll^-1 Hpl' ; rs = bp - Hpl Hll^-1 bl
    # Hpl is assembled blockwise as [K, L, 3, 2] (keyframes x landmark slots);
    # the einsum over the landmark axis contracts each 2x2-inverted block
    # (float32 at 'highest' precision: _einsum).  Under shard_map with
    # landmarks on the map axis, `cross` and the rs correction become
    # per-shard partials followed by a psum — see optimize_sharded.  NOTE: the dense [K, L] assembly is O(K*L) memory —
    # fine for per-session smoothing (K~100, L~1k) but fatal at 1M landmarks
    # with hundreds of keyframes; the large-scale path is
    # :func:`landmark_system_sparse` (O(F) memory, exact same math).
    hpl_dense = jnp.zeros((k, l, 3, 2)).at[g.obs_kf, g.obs_lm].add(hpl_f)
    ghl_dense = _einsum("klpa,lab->klpb", hpl_dense, hll_inv)  # [K, L, 3, 2]
    cross = _einsum("klpb,mlqb->kmpq", ghl_dense, hpl_dense)   # [K, K, 3, 3]
    rs_corr = _einsum("klpb,lb->kp", ghl_dense, bl)            # [K, 3]
    return hpp_diag, bp_obs, cross, rs_corr, hll_inv, bl, hpl_dense


def _obs_geometry_cols(poses, lx, ly, obs_kf, obs_lm, rb0, rb1):
    """Per-factor residuals + geometry as COLUMN VECTORS ([F] each).

    Layout note: every per-factor quantity is a separate 1-D ``[F]``
    column, never a ``[F, 2]`` / ``[F, 3, 2]`` array with tiny trailing
    dims, so each is one contiguous vector in device memory — the same
    struct-of-planes design as the filter kernel
    (core/pallas_kernels.py)."""
    px = poses[:, 0][obs_kf]
    py = poses[:, 1][obs_kf]
    pt = poses[:, 2][obs_kf]
    dx = lx[obs_lm] - px
    dy = ly[obs_lm] - py
    q = jnp.maximum(dx * dx + dy * dy, 1e-12)
    rr = jnp.sqrt(q)
    r0 = rb0 - rr                                     # range residual
    r1 = wrap_angle(rb1 - (jnp.arctan2(dy, dx) - pt))  # bearing residual
    return r0, r1, dx, dy, q, rr


def landmark_system_sparse(poses, lx, ly, damping,
                           obs_kf, obs_lm, rb0, rb1, w0, w1, obs_valid,
                           pair_a, pair_b, pair_valid):
    """Factor-sparse Schur reduction — identical math to
    :func:`landmark_system` with the dense ``[K, L, 3, 2]`` assembly
    replaced by per-factor scatters, so memory is O(F + K^2) instead of
    O(K*L).  This is what makes 1M-landmark graphs optimizable: at K=1024,
    L=2^21 the dense intermediates alone are >100 GB.

    All per-factor/per-landmark state is carried as COLUMN VECTORS
    (``lx``/``ly`` landmark coordinates, ``rb0``/``rb1`` range/bearing,
    ``w0``/``w1`` information) — see :func:`_obs_geometry_cols`.

    ``cross[k, m] = sum_l (sum_{f1 in l, kf=k} Hpl_f1) Hll_l^-1
    (sum_{f2 in l, kf=m} Hpl_f2)^T`` expands into a sum over ORDERED pairs
    of factors observing the same landmark; ``(pair_a, pair_b,
    pair_valid)`` enumerate exactly those pairs (including f1 == f2), with
    capacity padding masked out by ``pair_valid``.  Pair count is
    sum_l c_l^2 ~ (obs/landmark) * F — see
    ``distributed.build_schur_pairs``.

    Returns ``(hpp_diag [K,3,3], bp_obs [K,3], cross [K,K,3,3],
    rs_corr [K,3], hll_inv_c (ia, ib, id) [L] each, bl_c (bl0, bl1),
    hpl_c (6 x [F] — components (p, a), p-major))``; the last three feed
    :func:`backsubstitute_landmarks_sparse`.
    """
    k = poses.shape[0]
    l = lx.shape[0]

    r0, r1, dx, dy, q, rr = _obs_geometry_cols(poses, lx, ly, obs_kf,
                                               obs_lm, rb0, rb1)
    v = obs_valid.astype(r0.dtype)
    wr = v * w0
    wb = v * w1

    # landmark Jacobian rows: range (l00, l01), bearing (l10, l11)
    l00 = dx / rr
    l01 = dy / rr
    l10 = -dy / q
    l11 = dx / q
    # pose Jacobian rows: range (-l00, -l01, 0), bearing (-l10, -l11, -1)

    # Hpp_f[p][q] = wr p0p p0q + wb p1p p1q  (symmetric; p02 = 0, p12 = -1)
    h00 = wr * l00 * l00 + wb * l10 * l10
    h01 = wr * l00 * l01 + wb * l10 * l11
    h02 = wb * l10                   # (-l10)(-1) wb
    h11 = wr * l01 * l01 + wb * l11 * l11
    h12 = wb * l11
    h22 = wb                         # (-1)^2 wb
    hpp_diag = _assemble_sym3(k, obs_kf, h00, h01, h02, h11, h12, h22)

    # bp_f[p] = wr p0p r0 + wb p1p r1
    wr0 = wr * r0
    wb1 = wb * r1
    bp0 = -(wr0 * l00 + wb1 * l10)
    bp1 = -(wr0 * l01 + wb1 * l11)
    bp2 = -wb1
    bp_obs = jnp.stack([
        jnp.zeros(k).at[obs_kf].add(bp0),
        jnp.zeros(k).at[obs_kf].add(bp1),
        jnp.zeros(k).at[obs_kf].add(bp2),
    ], axis=-1)

    # Hll_f (symmetric 2x2) and bl_f, scattered per landmark slot
    ha = jnp.zeros(l).at[obs_lm].add(wr * l00 * l00 + wb * l10 * l10) \
        + damping
    hb = jnp.zeros(l).at[obs_lm].add(wr * l00 * l01 + wb * l10 * l11)
    hd = jnp.zeros(l).at[obs_lm].add(wr * l01 * l01 + wb * l11 * l11) \
        + damping
    bl0 = jnp.zeros(l).at[obs_lm].add(wr0 * l00 + wb1 * l10)
    bl1 = jnp.zeros(l).at[obs_lm].add(wr0 * l01 + wb1 * l11)

    det = ha * hd - hb * hb
    observed = det > 1e-12
    inv_det = jnp.where(observed, 1.0 / jnp.where(observed, det, 1.0), 0.0)
    ia = hd * inv_det
    ib = -hb * inv_det
    id_ = ha * inv_det

    # Hpl_f components (p, a): hpl[p][a] = wr p0p l0a + wb p1p l1a
    hpl00 = -(wr * l00 * l00 + wb * l10 * l10)
    hpl01 = -(wr * l00 * l01 + wb * l10 * l11)
    hpl10 = hpl01                      # wr l01 l00 + wb l11 l10, negated
    hpl11 = -(wr * l01 * l01 + wb * l11 * l11)
    hpl20 = -wb * l10
    hpl21 = -wb * l11

    # per-factor Hpl Hll^-1 (hll_inv per landmark; multiplication linear,
    # so summing ghl_f per landmark == multiplying the summed Hpl)
    ia_f = ia[obs_lm]
    ib_f = ib[obs_lm]
    id_f = id_[obs_lm]
    ghl00 = hpl00 * ia_f + hpl01 * ib_f
    ghl01 = hpl00 * ib_f + hpl01 * id_f
    ghl10 = hpl10 * ia_f + hpl11 * ib_f
    ghl11 = hpl10 * ib_f + hpl11 * id_f
    ghl20 = hpl20 * ia_f + hpl21 * ib_f
    ghl21 = hpl20 * ib_f + hpl21 * id_f

    # cross via the ordered factor-pair list: 9 [K, K] plane scatters
    pv = pair_valid.astype(r0.dtype)
    kfa = obs_kf[pair_a]
    kfb = obs_kf[pair_b]
    ghl = ((ghl00, ghl01), (ghl10, ghl11), (ghl20, ghl21))
    hpl = ((hpl00, hpl01), (hpl10, hpl11), (hpl20, hpl21))
    planes = []
    for p in range(3):
        gp0 = ghl[p][0][pair_a]
        gp1 = ghl[p][1][pair_a]
        for qq in range(3):
            pc = pv * (gp0 * hpl[qq][0][pair_b] + gp1 * hpl[qq][1][pair_b])
            planes.append(jnp.zeros((k, k)).at[kfa, kfb].add(pc))
    cross = jnp.stack(planes, axis=-1).reshape(k, k, 3, 3)

    # rs correction is per-factor (no pairs): sum_f onehot(kf) ghl_f bl[lm]
    bl0_f = bl0[obs_lm]
    bl1_f = bl1[obs_lm]
    rs_corr = jnp.stack([
        jnp.zeros(k).at[obs_kf].add(ghl00 * bl0_f + ghl01 * bl1_f),
        jnp.zeros(k).at[obs_kf].add(ghl10 * bl0_f + ghl11 * bl1_f),
        jnp.zeros(k).at[obs_kf].add(ghl20 * bl0_f + ghl21 * bl1_f),
    ], axis=-1)
    return (hpp_diag, bp_obs, cross, rs_corr, (ia, ib, id_), (bl0, bl1),
            (hpl00, hpl01, hpl10, hpl11, hpl20, hpl21))


def _assemble_sym3(k, idx, h00, h01, h02, h11, h12, h22):
    """Scatter six symmetric-3x3 component columns into [K, 3, 3]."""
    s = lambda v: jnp.zeros(k).at[idx].add(v)
    a00, a01, a02 = s(h00), s(h01), s(h02)
    a11, a12, a22 = s(h11), s(h12), s(h22)
    return jnp.stack([
        jnp.stack([a00, a01, a02], -1),
        jnp.stack([a01, a11, a12], -1),
        jnp.stack([a02, a12, a22], -1),
    ], axis=1)


def backsubstitute_landmarks_sparse(dp, hll_inv_c, bl_c, hpl_c,
                                    obs_kf, obs_lm, l):
    """dl = Hll^-1 (bl - Hpl' dp) with the Hpl' dp contraction as a
    per-factor segment sum — no dense [K, L] assembly.  Column-vector
    layout throughout (see :func:`_obs_geometry_cols`); returns
    ``(dlx [L], dly [L])``."""
    ia, ib, id_ = hll_inv_c
    bl0, bl1 = bl_c
    hpl00, hpl01, hpl10, hpl11, hpl20, hpl21 = hpl_c
    dp0 = dp[:, 0][obs_kf]
    dp1 = dp[:, 1][obs_kf]
    dp2 = dp[:, 2][obs_kf]
    t0 = hpl00 * dp0 + hpl10 * dp1 + hpl20 * dp2
    t1 = hpl01 * dp0 + hpl11 * dp1 + hpl21 * dp2
    u0 = bl0 - jnp.zeros(l).at[obs_lm].add(t0)
    u1 = bl1 - jnp.zeros(l).at[obs_lm].add(t1)
    return ia * u0 + ib * u1, ib * u0 + id_ * u1


def schur_normal_equations(poses, landmarks, g: PoseGraph, damping: jax.Array):
    """Full reduced pose system: pose part + landmark part combined.

    Returns (S [3K, 3K], rs [3K], hll_inv [L, 2, 2], bl [L, 2],
    hpl_dense [K, L, 3, 2]).
    """
    k = poses.shape[0]
    n = 3 * k
    big_h, bp = pose_system(poses, g, damping)
    hpp_diag, bp_obs, cross, rs_corr, hll_inv, bl, hpl_dense = landmark_system(
        poses, landmarks, g, damping
    )
    big_h = big_h.at[jnp.arange(k), jnp.arange(k)].add(hpp_diag) - cross
    rs = bp + bp_obs - rs_corr
    s_mat = big_h.transpose(0, 2, 1, 3).reshape(n, n)
    return s_mat, rs.reshape(n), hll_inv, bl, hpl_dense


def backsubstitute_landmarks(dp, hll_inv, bl, hpl_dense):
    """dl = Hll^-1 (bl - Hpl' dp) — shard-local under map-axis sharding."""
    hplT_dp = _einsum("klpb,kp->lb", hpl_dense, dp)
    return _einsum("lab,lb->la", hll_inv, bl - hplT_dp)


def gauss_newton_step(poses, landmarks, g: PoseGraph, damping) -> Tuple[jax.Array, jax.Array]:
    """One damped GN step; returns updated (poses, landmarks)."""
    k = poses.shape[0]
    s_mat, rs, hll_inv, bl, hpl_dense = schur_normal_equations(
        poses, landmarks, g, damping
    )
    dp = jax.scipy.linalg.solve(s_mat, rs, assume_a="pos").reshape(k, 3)
    dl = backsubstitute_landmarks(dp, hll_inv, bl, hpl_dense)

    new_poses = poses + dp
    new_poses = new_poses.at[:, 2].set(wrap_angle(new_poses[:, 2]))
    new_landmarks = landmarks + dl
    return new_poses, new_landmarks


def total_error(poses, landmarks, g: PoseGraph) -> jax.Array:
    r_odo, _ = _odo_residuals(poses, g)
    r_obs, _ = _obs_residuals(poses, landmarks, g)
    w_odo = jnp.where(g.odo_valid[:, None], g.odo_info, 0.0)
    w_obs = jnp.where(g.obs_valid[:, None], g.obs_info, 0.0)
    return jnp.sum(r_odo * r_odo * w_odo) + jnp.sum(r_obs * r_obs * w_obs)


def optimize(g: PoseGraph, num_iters: int = 10, damping: float = 1e-6):
    """Levenberg-Marquardt loop (fixed iteration count, jittable).

    Accept/reject with adaptive damping: lambda /= 2 on improvement,
    lambda *= 10 on regression (step rejected).
    """

    def body(carry, _):
        poses, landmarks, lam, err = carry
        new_p, new_l = gauss_newton_step(poses, landmarks, g, lam)
        new_err = total_error(new_p, new_l, g)
        # NaN-safe accept/reject: a failed Cholesky at low damping yields a
        # NaN step, which must count as a rejection (raise lambda, keep the
        # current iterate) — `minimum(err, nan)` would poison the error
        # forever and freeze the whole loop at the input
        improved = new_err < err
        poses = jnp.where(improved, new_p, poses)
        landmarks = jnp.where(improved, new_l, landmarks)
        lam = jnp.where(improved, lam * 0.5, lam * 10.0)
        err = jnp.where(improved, new_err, err)
        return (poses, landmarks, lam, err), err

    err0 = total_error(g.poses, g.landmarks, g)
    (poses, landmarks, _, err), hist = jax.lax.scan(
        body, (g.poses, g.landmarks, jnp.asarray(damping), err0), None,
        length=num_iters,
    )
    return poses, landmarks, err, hist
