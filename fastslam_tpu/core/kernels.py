"""Core FastSLAM kernels, vectorized over the particle axis.

Every kernel here is a pure function over fixed-shape arrays, designed so the
whole filter step jits into one XLA program:

* the reference's per-particle thread fan-out (``fast_slam_2.py:42-53``)
  becomes plain vectorization over the leading ``[P]`` axis;
* the per-landmark Python scan with first-match association
  (``landmark_utils.py:92-117``) becomes a masked ``[P, L]`` distance matrix
  and an ``argmax``-of-boolean (argmax returns the *first* True, exactly
  reproducing first-match semantics);
* the 2x2 EKF with ``np.linalg.inv`` (``fast_slam_2.py:116-159``) becomes a
  closed-form symmetric 2x2 solve — no LAPACK, elementwise math that the
  fused kernel (``core/pallas_kernels.py``) shares;
* data-dependent branches (append-vs-update ``fast_slam_2.py:105-114``,
  resample-if-degenerate ``:62``) become ``where`` masks and ``lax.cond``;
* raw-probability weights (``:159``) are carried in log space.

``parity_mode`` (config) reproduces the reference's quirks exactly
(SURVEY.md §7.0): robot-frame association, weight-floor normalization,
first-match association, (I-KH)Σ covariance update, argmax-weight pose
estimate, and resampling that keeps the copied weights.  Production mode uses
the textbook-correct variants (world-frame association via the predicted
measurement, best-match gating, Joseph-form covariance, log-sum-exp
normalization, uniform weights after resampling).

Noise is passed in explicitly (``rot_noise``/``trans_noise``/``u0``) so the
kernels are deterministic and oracle-testable; ``fastslam_step`` draws it from
the state's PRNG key.
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp

from fastslam_tpu.config import FastSLAMConfig
from fastslam_tpu.core.state import FilterState, Measurements, PlanesState

import math

_TWO_PI = 2.0 * math.pi
_LOG_TWO_PI = math.log(2.0 * math.pi)


def wrap_angle(theta: jax.Array) -> jax.Array:
    """Wrap angles to [-pi, pi) — reference idiom ``(a + pi) % 2pi - pi``
    (``fast_slam_2.py:84-85,125``)."""
    return (theta + jnp.pi) % _TWO_PI - jnp.pi


# ---------------------------------------------------------------------------
# motion model
# ---------------------------------------------------------------------------

def propagate_particles(
    poses: jax.Array,
    rotation: jax.Array,
    translation: jax.Array,
    rot_noise: jax.Array,
    trans_noise: jax.Array,
) -> jax.Array:
    """Sample the motion model for all particles at once.

    Reference semantics (``fast_slam_2.py:69-87``): motion is *either* pure
    rotation or pure translation per tick, selected by ``rotation != 0``;
    Gaussian noise is applied only to the active component; yaw is wrapped,
    then the translation is applied along the *new* heading.

    Args:
      poses: ``[P, 3]`` particle poses.
      rotation/translation: scalar odometry for this tick.
      rot_noise/trans_noise: ``[P]`` standard-normal draws *pre-scaled* by the
        respective noise std-devs.
    """
    rotating = rotation != 0.0
    noisy_rot = jnp.where(rotating, rotation + rot_noise, 0.0)
    noisy_trans = jnp.where(rotating, 0.0, translation + trans_noise)
    yaw = wrap_angle(poses[:, 2] + noisy_rot)
    x = poses[:, 0] + noisy_trans * jnp.cos(yaw)
    y = poses[:, 1] + noisy_trans * jnp.sin(yaw)
    return jnp.stack([x, y, yaw], axis=-1)


# ---------------------------------------------------------------------------
# association + landmark EKF (one measurement, all particles)
# ---------------------------------------------------------------------------

def _associate(mx, my, a, b, c, d, valid, qx, qy, config: FastSLAMConfig,
               axis: int):
    """Mahalanobis association on landmark COMPONENT arrays.

    Slots lie along ``axis`` of ``mx``/``my``/``a..d``/``valid``; the query
    ``(qx, qy)`` broadcasts against them.  Shared by the XLA path
    (``[P, L]`` blocks, ``axis=1``) and the fused kernel (``[L, T]`` planes,
    ``axis=0``), so both run the same arithmetic in the same order.

    Returns ``(idx, has_match)`` with the slot axis kept as size 1.
    """
    dx = mx - qx
    dy = my - qy
    # closed-form 2x2 inverse (a, b, c, d) -> (d, -b, -c, a) / det
    det = a * d - b * c
    eps = 1e-12
    safe = jnp.where(jnp.abs(det) > eps, det, jnp.sign(det) * eps + eps)
    inv_det = 1.0 / safe
    ia, ib, ic, id_ = d * inv_det, -b * inv_det, -c * inv_det, a * inv_det
    d2 = dx * (ia * dx + ib * dy) + dy * (ic * dx + id_ * dy)
    dist = jnp.sqrt(jnp.maximum(d2, 0.0))
    usable = valid & (det > 0.0)
    dist = jnp.where(usable, dist, jnp.inf)
    hit = (usable & (dist < config.max_landmark_distance)).astype(jnp.int32)
    has_match = jnp.max(hit, axis=axis, keepdims=True) > 0
    if config.parity_mode:
        idx = jnp.argmax(hit, axis=axis, keepdims=True)   # first hit
    else:
        idx = jnp.argmin(dist, axis=axis, keepdims=True)  # best hit
    return idx.astype(jnp.int32), has_match


def associate(
    lm_mean: jax.Array,
    lm_cov: jax.Array,
    lm_valid: jax.Array,
    query: jax.Array,
    config: FastSLAMConfig,
) -> Tuple[jax.Array, jax.Array]:
    """Mahalanobis data association over all landmark slots.

    Replaces the reference's serial first-match-under-gate scan
    (``landmark_utils.py:92-117``): the Mahalanobis distance from ``query`` to
    every slot is computed densely as a ``[P, L]`` matrix; in parity mode the
    *first* slot under the gate wins (``argmax`` over the hit mask returns the
    first True), in production mode the *closest* slot wins.

    Args:
      lm_mean: ``[P, L, 2]``; lm_cov: ``[P, L, 4]``; lm_valid: ``[P, L]`` bool.
      query: ``[P, 2]`` the point to associate (robot-frame observation in
        parity mode — reference quirk ``fast_slam_2.py:100-104`` — or the
        world-frame observation in production mode).

    Returns:
      ``(idx [P] int32, has_match [P] bool)``.
    """
    idx, has_match = _associate(
        lm_mean[..., 0], lm_mean[..., 1], lm_cov[..., 0], lm_cov[..., 1],
        lm_cov[..., 2], lm_cov[..., 3], lm_valid,
        query[:, 0:1], query[:, 1:2], config, axis=1,
    )
    return idx[:, 0], has_match[:, 0]


def _landmark_ekf(mu_x, mu_y, a, b, c, d, px, py, yaw, dist_z, bearing_z,
                  config: FastSLAMConfig):
    """2x2 landmark EKF for one (distance, bearing) measurement, elementwise
    over any shape (``[P]`` in the XLA path, ``[1, T]`` rows in the kernel).

    Reference ``fast_slam_2.py:116-159``: H = [[dx/r, dy/r], [-dy/q, dx/q]],
    S = H Sigma H^T + R, K = Sigma H^T S^-1, (I - K H) Sigma (production mode
    symmetrizes), and the Gaussian log-likelihood of the innovation.

    Returns ``(new_mu_x, new_mu_y, new_a, new_b, new_c, new_d, log_lik)``.
    """
    dx = mu_x - px
    dy = mu_y - py
    q = jnp.maximum(dx * dx + dy * dy, 1e-12)
    r = jnp.sqrt(q)
    nu_r = dist_z - r
    nu_b = wrap_angle(bearing_z - (jnp.arctan2(dy, dx) - yaw))

    h00 = dx / r
    h01 = dy / r
    h10 = -dy / q
    h11 = dx / q

    # S = H Sigma H^T + R; rows of H Sigma: u = (h00*a + h01*c, h00*b + h01*d),
    # v = (h10*a + h11*c, h10*b + h11*d)
    u0 = h00 * a + h01 * c
    u1 = h00 * b + h01 * d
    v0 = h10 * a + h11 * c
    v1 = h10 * b + h11 * d
    rn = config.measurement_noise
    s00 = u0 * h00 + u1 * h01 + rn
    s01 = u0 * h10 + u1 * h11
    s10 = v0 * h00 + v1 * h01
    s11 = v0 * h10 + v1 * h11 + rn

    s_det = s00 * s11 - s01 * s10
    s_det_safe = jnp.maximum(jnp.abs(s_det), 1e-18) * jnp.sign(s_det + 1e-30)
    i00, i01 = s11 / s_det_safe, -s01 / s_det_safe
    i10, i11 = -s10 / s_det_safe, s00 / s_det_safe

    # K = Sigma H^T S^-1; Sigma H^T columns m = (a*h00 + b*h01, c*h00 + d*h01),
    # n = (a*h10 + b*h11, c*h10 + d*h11)
    m0 = a * h00 + b * h01
    m1 = c * h00 + d * h01
    n0 = a * h10 + b * h11
    n1 = c * h10 + d * h11
    k00 = m0 * i00 + n0 * i10
    k01 = m0 * i01 + n0 * i11
    k10 = m1 * i00 + n1 * i10
    k11 = m1 * i01 + n1 * i11

    new_mu_x = mu_x + k00 * nu_r + k01 * nu_b
    new_mu_y = mu_y + k10 * nu_r + k11 * nu_b

    # (I - K H) Sigma  (reference :146).  Production mode symmetrizes.
    g00 = 1.0 - (k00 * h00 + k01 * h10)
    g01 = -(k00 * h01 + k01 * h11)
    g10 = -(k10 * h00 + k11 * h10)
    g11 = 1.0 - (k10 * h01 + k11 * h11)
    new_a = g00 * a + g01 * c
    new_b = g00 * b + g01 * d
    new_c = g10 * a + g11 * c
    new_d = g10 * b + g11 * d
    if not config.parity_mode:
        off = 0.5 * (new_b + new_c)
        new_b = off
        new_c = off

    # Gaussian log-likelihood of the innovation under S (:156-159)
    maha = i00 * nu_r * nu_r + (i01 + i10) * nu_r * nu_b + i11 * nu_b * nu_b
    log_lik = -0.5 * (maha + jnp.log(jnp.maximum(s_det, 1e-30))) - _LOG_TWO_PI
    return new_mu_x, new_mu_y, new_a, new_b, new_c, new_d, log_lik


def update_particles_one(
    poses: jax.Array,
    log_weights: jax.Array,
    lm_mean: jax.Array,
    lm_cov: jax.Array,
    lm_count: jax.Array,
    z: jax.Array,
    z_valid: jax.Array,
    config: FastSLAMConfig,
    update_weights: bool = True,
):
    """Process ONE (distance, bearing) measurement against every particle.

    Fuses the reference's per-particle thread task ``__update_particle``
    (``fast_slam_2.py:89-159``) into dense array ops:

      * observation point for association (robot frame in parity mode — the
        reference compares a robot-frame point against world-frame landmarks,
        SURVEY.md §7.0 quirk 1);
      * association (see :func:`associate`);
      * miss -> append a world-frame landmark with cov ``0.1*I`` at the next
        free slot (``:108-111``, ``landmark.py:13``), dropped if at capacity;
      * hit -> 2x2 landmark EKF (``:116-153``) and a log-likelihood weight
        update (``:156-159``).

    Returns updated ``(log_weights, lm_mean, lm_cov, lm_count)``.
    """
    p, l = lm_mean.shape[0], lm_mean.shape[1]
    dist_z, bearing_z = z[0], z[1]
    px, py, yaw = poses[:, 0], poses[:, 1], poses[:, 2]

    slots = jax.lax.broadcasted_iota(jnp.int32, (p, l), 1)
    lm_valid = slots < lm_count[:, None]

    # World-frame observed landmark (used for appends, and for association in
    # production mode).
    wx = px + dist_z * jnp.cos(yaw + bearing_z)
    wy = py + dist_z * jnp.sin(yaw + bearing_z)
    world_obs = jnp.stack([wx, wy], axis=-1)                    # [P, 2]

    if config.parity_mode:
        # Reference quirk: the association query is the robot-frame point
        # (d cos(b), d sin(b)) — identical for every particle.
        rx = dist_z * jnp.cos(bearing_z)
        ry = dist_z * jnp.sin(bearing_z)
        query = jnp.broadcast_to(jnp.stack([rx, ry]), (p, 2))
    else:
        query = world_obs

    idx, has_match = associate(lm_mean, lm_cov, lm_valid, query, config)

    take = lambda arr: jnp.take_along_axis(
        arr, idx[:, None, *([None] * (arr.ndim - 2))], axis=1
    ).squeeze(1)
    mu = take(lm_mean)                                          # [P, 2]
    sig = take(lm_cov)                                          # [P, 4]
    new_mu0, new_mu1, new_a, new_b, new_c, new_d, log_lik = _landmark_ekf(
        mu[:, 0], mu[:, 1], sig[:, 0], sig[:, 1], sig[:, 2], sig[:, 3],
        px, py, yaw, dist_z, bearing_z, config,
    )

    # ---------------- merge hit / miss / invalid paths ----------------
    can_append = lm_count < l
    do_update = z_valid & has_match
    do_append = z_valid & (~has_match) & can_append

    upd_onehot = (slots == idx[:, None]) & do_update[:, None]       # [P, L]
    app_onehot = (slots == lm_count[:, None]) & do_append[:, None]  # [P, L]

    new_mean_pl = jnp.stack([new_mu0, new_mu1], axis=-1)            # [P, 2]
    new_cov_pl = jnp.stack([new_a, new_b, new_c, new_d], axis=-1)   # [P, 4]
    app_cov = jnp.array(
        [config.default_landmark_cov, 0.0, 0.0, config.default_landmark_cov],
        dtype=lm_cov.dtype,
    )

    lm_mean = jnp.where(upd_onehot[..., None], new_mean_pl[:, None, :], lm_mean)
    lm_mean = jnp.where(app_onehot[..., None], world_obs[:, None, :], lm_mean)
    lm_cov = jnp.where(upd_onehot[..., None], new_cov_pl[:, None, :], lm_cov)
    lm_cov = jnp.where(app_onehot[..., None], app_cov[None, None, :], lm_cov)
    lm_count = lm_count + do_append.astype(jnp.int32)
    if update_weights:
        # FastSLAM 1.0 weighting; the fastslam2 proposal path weights by the
        # measurement evidence instead (fastslam2_propose) and skips this
        log_weights = jnp.where(do_update, log_weights + log_lik, log_weights)

    return log_weights, lm_mean, lm_cov, lm_count


def update_particles(state: FilterState, measurements: Measurements,
                     config: FastSLAMConfig,
                     update_weights: bool = True) -> FilterState:
    """Scan the per-measurement update over the padded measurement batch.

    The reference processes measurements strictly serially (``fast_slam_2.py:48``)
    — measurement k may associate against a landmark appended by measurement
    k-1 — so this is a ``lax.scan`` with the map arrays as carry.  This is the
    plain XLA path; the planes engine (:func:`fastslam_step_planes`) runs the
    same arithmetic as one fused kernel.
    """
    def step(carry, zs):
        log_w, mean, cov, count = carry
        z, valid = zs
        log_w, mean, cov, count = update_particles_one(
            state.poses, log_w, mean, cov, count, z, valid, config,
            update_weights=update_weights,
        )
        return (log_w, mean, cov, count), None

    (log_w, mean, cov, count), _ = jax.lax.scan(
        step,
        (state.log_weights, state.lm_mean, state.lm_cov, state.lm_count),
        (measurements.range_bearing, measurements.valid),
    )
    return state._replace(log_weights=log_w, lm_mean=mean, lm_cov=cov, lm_count=count)


# ---------------------------------------------------------------------------
# FastSLAM 2.0 measurement-informed proposal
# ---------------------------------------------------------------------------

def _inv3x3_sym(m):
    """Closed-form inverse of symmetric 3x3s given as a dict of 6 entries
    (a00, a01, a02, a11, a12, a22), each [...]-shaped."""
    a, b, c = m["a00"], m["a01"], m["a02"]
    d, e, f = m["a11"], m["a12"], m["a22"]
    co00 = d * f - e * e
    co01 = c * e - b * f
    co02 = b * e - c * d
    det = a * co00 + b * co01 + c * co02
    det = jnp.where(jnp.abs(det) > 1e-18, det, 1e-18)
    inv_det = 1.0 / det
    return {
        "a00": co00 * inv_det,
        "a01": co01 * inv_det,
        "a02": co02 * inv_det,
        "a11": (a * f - c * c) * inv_det,
        "a12": (b * c - a * e) * inv_det,
        "a22": (a * d - b * b) * inv_det,
    }


def _chol3x3_sym(m, jitter=1e-9):
    """Cholesky factor (lower) of symmetric 3x3s in the 6-entry layout.
    Returns (l00, l10, l11, l20, l21, l22)."""
    a, b, c = m["a00"] + jitter, m["a01"], m["a02"]
    d, e, f = m["a11"] + jitter, m["a12"], m["a22"] + jitter
    l00 = jnp.sqrt(jnp.maximum(a, 1e-18))
    l10 = b / l00
    l20 = c / l00
    l11 = jnp.sqrt(jnp.maximum(d - l10 * l10, 1e-18))
    l21 = (e - l20 * l10) / l11
    l22 = jnp.sqrt(jnp.maximum(f - l20 * l20 - l21 * l21, 1e-18))
    return l00, l10, l11, l20, l21, l22


def _proposal_prior(yaw_pred, s_t2, s_r2, fxy):
    """Motion-prior covariance of the fs2 proposal and its information form.

    P = R diag(s_t2, fxy) R' on xy (translation noise along the heading,
    the squared floor across it), ``s_r2`` on theta, independent.
    Returns ``((p00, p01, p11), lam)`` with ``lam`` the 6-entry dict."""
    cy = jnp.cos(yaw_pred)
    sy = jnp.sin(yaw_pred)
    p00 = cy * cy * s_t2 + sy * sy * fxy
    p01 = cy * sy * (s_t2 - fxy)
    p11 = sy * sy * s_t2 + cy * cy * fxy
    det_p = p00 * p11 - p01 * p01
    i_p = 1.0 / jnp.maximum(det_p, 1e-18)
    lam = {
        "a00": p11 * i_p,
        "a01": -p01 * i_p,
        "a02": jnp.zeros_like(p00),
        "a11": p00 * i_p,
        "a12": jnp.zeros_like(p00),
        "a22": 1.0 / s_r2 * jnp.ones_like(p00),
    }
    return (p00, p01, p11), lam


def _proposal_step(carry, mu_x, mu_y, a, b, c, d, use, px, py, yaw_pred,
                   dist_z, bearing_z, prior, s_r2, scale,
                   config: FastSLAMConfig):
    """One measurement's contribution to the fs2 pose posterior, given the
    landmark it associates with at the PREDICTED pose (elementwise; shared
    by :func:`fastslam2_propose` and the fused kernel).

    ``carry = (lam, eta0, eta1, eta2, log_w_add)``; ``use`` marks valid,
    associated measurements; ``scale`` is the proposal mode dial (``None``
    = 1).  Returns the updated carry."""
    lam, eta0, eta1, eta2, log_w_add = carry
    p00, p01, p11 = prior
    dt = px.dtype

    dx = mu_x - px
    dy = mu_y - py
    q = jnp.maximum(dx * dx + dy * dy, 1e-12)
    r = jnp.sqrt(q)
    nu_r = dist_z - r
    nu_b = wrap_angle(bearing_z - (jnp.arctan2(dy, dx) - yaw_pred))

    # landmark-side innovation covariance S~ = Hm Sig Hm' + R
    h00 = dx / r
    h01 = dy / r
    h10 = -dy / q
    h11 = dx / q
    u0 = h00 * a + h01 * c
    u1 = h00 * b + h01 * d
    v0 = h10 * a + h11 * c
    v1 = h10 * b + h11 * d
    rn = config.measurement_noise
    s00 = u0 * h00 + u1 * h01 + rn
    s01 = u0 * h10 + u1 * h11
    s11 = v0 * h10 + v1 * h11 + rn
    s_det = jnp.maximum(s00 * s11 - s01 * s01, 1e-18)
    si = 1.0 / s_det
    i00, i01, i11 = s11 * si, -s01 * si, s00 * si

    # chi^2 innovation gate (99% for 2 dof): a measurement whose
    # innovation is implausible under S~ is a likely mis-association —
    # feeding it to the proposal would *pull* the pose toward a wrong
    # consistency instead of merely down-weighting the particle
    maha_gate = (i00 * nu_r * nu_r + 2.0 * i01 * nu_r * nu_b
                 + i11 * nu_b * nu_b)
    use = use & (maha_gate < 9.21)

    # pose Jacobian Hx = [[-dx/r, -dy/r, 0], [dy/q, -dx/q, -1]]
    g00, g01, g02 = -h00, -h01, jnp.zeros_like(h00)
    g10, g11_, g12 = -h10, -h11, -jnp.ones_like(h00)

    # Hx' S~^-1 Hx (symmetric 3x3) and Hx' S~^-1 nu
    t00 = i00 * g00 + i01 * g10
    t01 = i00 * g01 + i01 * g11_
    t02 = i00 * g02 + i01 * g12
    t10 = i01 * g00 + i11 * g10
    t11 = i01 * g01 + i11 * g11_
    t12 = i01 * g02 + i11 * g12

    d00 = g00 * t00 + g10 * t10
    d01 = g00 * t01 + g10 * t11
    d02 = g00 * t02 + g10 * t12
    d11 = g01 * t01 + g11_ * t11
    d12 = g01 * t02 + g11_ * t12
    d22 = g02 * t02 + g12 * t12

    e0 = t00 * nu_r + t10 * nu_b
    e1 = t01 * nu_r + t11 * nu_b
    e2 = t02 * nu_r + t12 * nu_b

    usef = use.astype(dt)
    # mode dial: scale the proposal information only — never the weight
    luse = usef if scale is None else usef * scale
    lam = {
        "a00": lam["a00"] + luse * d00,
        "a01": lam["a01"] + luse * d01,
        "a02": lam["a02"] + luse * d02,
        "a11": lam["a11"] + luse * d11,
        "a12": lam["a12"] + luse * d12,
        "a22": lam["a22"] + luse * d22,
    }
    eta0 = eta0 + luse * e0
    eta1 = eta1 + luse * e1
    eta2 = eta2 + luse * e2

    # evidence weight: N(nu; 0, S~ + Hx P0 Hx')  — prior-inflated
    # innovation covariance (project the motion prior through Hx)
    # Hx P0 Hx' with P0 = [[p00,p01,0],[p01,p11,0],[0,0,s_r2]]
    q00 = g00 * (p00 * g00 + p01 * g01) + g01 * (p01 * g00 + p11 * g01)
    q01 = g00 * (p00 * g10 + p01 * g11_) + g01 * (p01 * g10 + p11 * g11_)
    q11 = (g10 * (p00 * g10 + p01 * g11_) + g11_ * (p01 * g10 + p11 * g11_)
           + s_r2 * g12 * g12)
    z00 = s00 + q00
    z01 = s01 + q01
    z11 = s11 + q11
    z_det = jnp.maximum(z00 * z11 - z01 * z01, 1e-30)
    zi = 1.0 / z_det
    maha = (z11 * nu_r * nu_r - 2.0 * z01 * nu_r * nu_b + z00 * nu_b * nu_b) * zi
    log_ev = -0.5 * (maha + jnp.log(z_det)) - _LOG_TWO_PI
    log_w_add = log_w_add + jnp.where(use, log_ev, 0.0)
    return lam, eta0, eta1, eta2, log_w_add


def _sample_pose(lam, eta0, eta1, eta2, px, py, yaw_pred, n0, n1, n2):
    """Sigma = Lambda^-1, mu = pred + Sigma eta, pose = mu + chol(Sigma) n."""
    sigma = _inv3x3_sym(lam)
    mu0 = px + sigma["a00"] * eta0 + sigma["a01"] * eta1 + sigma["a02"] * eta2
    mu1 = py + sigma["a01"] * eta0 + sigma["a11"] * eta1 + sigma["a12"] * eta2
    mu2 = (yaw_pred + sigma["a02"] * eta0 + sigma["a12"] * eta1
           + sigma["a22"] * eta2)
    l00, l10, l11, l20, l21, l22 = _chol3x3_sym(sigma)
    new_x = mu0 + l00 * n0
    new_y = mu1 + l10 * n0 + l11 * n1
    new_yaw = wrap_angle(mu2 + l20 * n0 + l21 * n1 + l22 * n2)
    return new_x, new_y, new_yaw


def fastslam2_propose(
    state: FilterState,
    rotation: jax.Array,
    translation: jax.Array,
    measurements: Measurements,
    noise: jax.Array,
    config: FastSLAMConfig,
    xy_floor: jax.Array | None = None,
    theta_floor: jax.Array | None = None,
    evidence_scale: jax.Array | None = None,
) -> Tuple[FilterState, jax.Array]:
    """Sample particle poses from the measurement-informed posterior.

    True FastSLAM 2.0 (Montemerlo et al.): instead of sampling from the
    motion model alone (the reference's behavior, ``fast_slam_2.py:77-87``),
    each particle's new pose is drawn from
    ``p(x_t | x_{t-1}, u_t, z_t) ~ N(mu, Sigma)`` with

      Lambda = P_motion^-1 + sum_m Hx' S~^-1 Hx      (information form)
      eta    = sum_m Hx' S~^-1 nu_m
      Sigma  = Lambda^-1,  mu = x_pred + Sigma eta

    where ``S~`` is the landmark-side innovation covariance and ``Hx`` the
    pose Jacobian of the (range, bearing) model, accumulated over every
    measurement that associates to an existing landmark at the predicted
    pose.  The importance weight comes from exactly one place
    (``config.fs2_evidence_weights``): either the measurement evidence
    ``N(nu; 0, S~ + Hx P_motion Hx')`` applied here (textbook fs2), or —
    the measured-better production default — the landmark EKF pass's
    likelihood at the SAMPLED pose (``update_weights=True`` downstream,
    no evidence here).

    Args:
      noise: ``[P, 3]`` standard-normal draws for the pose sample.
      xy_floor/theta_floor: optional TRACED overrides of the config floors —
        the adaptive-floor path feeds the online ICP-vs-command residual
        estimate here without recompiling (config floors are static).
      evidence_scale: optional TRACED proposal MODE DIAL in [0, 1]: scales
        every measurement's Lambda/eta contribution, so the sampled
        proposal interpolates continuously between the pure motion prior
        (0 — the reference's behavior, optimal when commands are
        near-exact) and the fully measurement-informed fs2 posterior (1 —
        wins when odometry lies, e.g. wheel slip).  The adaptive estimator
        drives it from the estimated command error
        (proposal/adaptive.OnlineFloorEstimator).  Weights are NOT scaled.

    Returns ``(state with new poses and updated log-weights, pose_pred)``.
    """
    rot_eff, trans_eff, s_t2, s_r2, fxy = fs2_prior_scalars(
        rotation, translation, config, (xy_floor, theta_floor),
    )
    # mean motion (no sampling noise — uncertainty moves into the proposal)
    yaw_pred = wrap_angle(state.poses[:, 2] + rot_eff)
    px = state.poses[:, 0] + trans_eff * jnp.cos(yaw_pred)
    py = state.poses[:, 1] + trans_eff * jnp.sin(yaw_pred)
    prior, lam = _proposal_prior(yaw_pred, s_t2, s_r2, fxy)
    zero = jnp.zeros_like(px)

    lm_valid = state.lm_valid_mask()

    def accumulate(carry, zs):
        z, valid = zs
        dist_z, bearing_z = z[0], z[1]
        # associate against the world-frame observation from the PREDICTED pose
        wx = px + dist_z * jnp.cos(yaw_pred + bearing_z)
        wy = py + dist_z * jnp.sin(yaw_pred + bearing_z)
        idx, has_match = associate(
            state.lm_mean, state.lm_cov, lm_valid,
            jnp.stack([wx, wy], axis=-1), config,
        )
        take = lambda arr: jnp.take_along_axis(
            arr, idx[:, None, None], axis=1)[:, 0]
        mu = take(state.lm_mean)                       # [P, 2]
        sig = take(state.lm_cov)                       # [P, 4]
        carry = _proposal_step(
            carry, mu[:, 0], mu[:, 1], sig[:, 0], sig[:, 1], sig[:, 2],
            sig[:, 3], valid & has_match, px, py, yaw_pred, dist_z,
            bearing_z, prior, s_r2, evidence_scale, config,
        )
        return carry, None

    (lam, eta0, eta1, eta2, log_w_add), _ = jax.lax.scan(
        accumulate, (lam, zero, zero, zero, zero),
        (measurements.range_bearing, measurements.valid),
    )
    new_x, new_y, new_yaw = _sample_pose(
        lam, eta0, eta1, eta2, px, py, yaw_pred,
        noise[:, 0], noise[:, 1], noise[:, 2],
    )
    poses = jnp.stack([new_x, new_y, new_yaw], axis=-1)
    # weight source (config.fs2_evidence_weights): evidence here XOR the
    # landmark-EKF likelihood pass (fastslam_step sets update_weights
    # accordingly) — never both
    if config.fs2_evidence_weights:
        log_weights = state.log_weights + log_w_add
    else:
        log_weights = state.log_weights
    return (
        state._replace(poses=poses, log_weights=log_weights),
        jnp.stack([px, py, yaw_pred], axis=-1),
    )


# ---------------------------------------------------------------------------
# weights / Neff / resampling / pose estimate
# ---------------------------------------------------------------------------

def normalize_log_weights(log_weights: jax.Array, config: FastSLAMConfig) -> jax.Array:
    """Normalize weights.

    Parity mode reproduces ``fast_slam_2.py:161-175`` exactly: work in linear
    space; if the total is below 1e-5 reset to uniform; otherwise divide —
    EXCEPT weights individually below 1e-5, which are kept unnormalized (the
    reference's ``:173`` oddity).  Production mode is a plain log-sum-exp.
    """
    n = log_weights.shape[0]
    if not config.parity_mode:
        return log_weights - jax.scipy.special.logsumexp(log_weights)
    w = jnp.exp(log_weights)
    total = jnp.sum(w)
    uniform = jnp.full_like(w, 1.0 / n)
    scaled = jnp.where(w < config.weight_floor, w, w / total)
    w = jnp.where(total < config.weight_floor, uniform, scaled)
    return jnp.log(jnp.maximum(w, 1e-300))


def effective_particles(log_weights: jax.Array, config: FastSLAMConfig) -> jax.Array:
    """Neff = 1 / sum(w^2), with the reference's short-circuit: if
    sum(w^2) < 1/N report N (``fast_slam_2.py:212-223``)."""
    n = log_weights.shape[0]
    w = jnp.exp(log_weights)
    s = jnp.sum(w * w)
    return jnp.where(s < 1.0 / n, jnp.asarray(n, w.dtype), 1.0 / jnp.maximum(s, 1e-300))


def systematic_resample_indices(weights: jax.Array, u0: jax.Array) -> jax.Array:
    """Low-variance (systematic) resampling, search-free.

    Replaces the reference's serial while-loop (``fast_slam_2.py:177-199``):
    with positions ``u_m = u0 + m/N`` the selected ancestor is the first index
    whose cumulative weight reaches ``u_m``, clipped at N-1 (the reference
    clamps the same way at ``:192``).

    The positions are an ARITHMETIC GRID, so the search has a closed form
    instead of a ``jnp.searchsorted`` of N positions (log2(N) rounds of
    gathers): the number of grid points strictly below ``cum_j`` is
    ``S_j ~= ceil((cum_j - u0) * N)`` (two elementwise correction steps
    reproduce float32 ``searchsorted`` comparisons exactly), and the
    ancestor map is the staircase inverse of the sorted ``S`` — one masked
    scatter + one prefix-max (bit-identical indices, pinned by
    tests/test_kernels.py against ``jnp.searchsorted``).

    Args:
      weights: ``[P]`` linear weights (need not be perfectly normalized).
      u0: scalar uniform draw in [0, 1/N).
    """
    cum = jnp.cumsum(weights)
    return grid_staircase_indices(cum, u0, weights.shape[0])


def grid_staircase_indices(cum: jax.Array, u0: jax.Array,
                           n: int) -> jax.Array:
    """``clip(searchsorted(cum, u0 + arange(n)/n, 'left'), 0, n-1)``
    without the search (see :func:`systematic_resample_indices`); shared
    with the distributed halo/ring resamplers so every path stays
    bit-identical."""
    dt = cum.dtype

    # S_j = #{m : u0 + m/n <= cum_j} (NON-strict, matching side="left":
    # the selected ancestor is the first j with cum_j >= u_m) — closed-form
    # grid count with float correction against the EXACT grid values
    # searchsorted compares (u0 + m/n evaluated in the same dtype)
    grid = lambda m: u0 + m.astype(dt) / n
    s = jnp.ceil((cum - u0) * n).astype(jnp.int32)
    s = jnp.clip(s, 0, n)
    for _ in range(2):
        s = jnp.where((s > 0) & (grid(s - 1) > cum), s - 1, s)
    for _ in range(2):
        s = jnp.where((s < n) & (grid(s) <= cum), s + 1, s)

    # ancestor A[m] = min{j : S_j >= m + 1}: each positive-count j owns the
    # output run [S_{j-1}, S_j) — scatter j at its run start, prefix-max
    # forward-fills the runs.  Starts of positive-count runs are strictly
    # increasing, so there are no scatter collisions; zero-count particles
    # are masked to a dummy slot.  Trailing positions beyond cum[-1]
    # (weight undersum) take ancestor n-1, matching searchsorted's clip.
    s_prev = jnp.concatenate([jnp.zeros(1, jnp.int32), s[:-1]])
    j = jnp.arange(n, dtype=jnp.int32)
    start = jnp.where(s > s_prev, s_prev, n)          # dummy slot n = drop
    b = jnp.full(n + 1, -1, jnp.int32).at[start].max(j)
    tail = jnp.where(s[n - 1] < n, s[n - 1], n)
    b = b.at[tail].max(n - 1)
    idx = jax.lax.associative_scan(jnp.maximum, b[:n])
    return jnp.clip(idx, 0, n - 1)


def resample_state(state: FilterState, idx: jax.Array,
                   config: FastSLAMConfig) -> FilterState:
    """Gather the whole SoA state by ancestor index.

    The reference deepcopies particle objects including their full landmark
    maps (``fast_slam_2.py:196``) — here that is a single gather per array.
    In parity mode the copied weights are kept (the reference does NOT reset
    to uniform after resampling); production mode resets to uniform.
    """
    n = state.num_particles
    if config.parity_mode:
        new_log_w = jnp.take(state.log_weights, idx, axis=0)
    else:
        new_log_w = jnp.full((n,), -jnp.log(n), dtype=state.log_weights.dtype)
    return state._replace(
        poses=jnp.take(state.poses, idx, axis=0),
        log_weights=new_log_w,
        lm_mean=jnp.take(state.lm_mean, idx, axis=0),
        lm_cov=jnp.take(state.lm_cov, idx, axis=0),
        lm_count=jnp.take(state.lm_count, idx, axis=0),
    )


def estimate_pose(state: FilterState) -> jax.Array:
    """Pose estimate = pose of the max-weight particle (``fast_slam_2.py:201-210``
    — the docstring there says mean, the code takes the argmax)."""
    best = jnp.argmax(state.log_weights)
    return state.poses[best]


# ---------------------------------------------------------------------------
# full step
# ---------------------------------------------------------------------------

def fastslam_step(
    state: FilterState,
    rotation: jax.Array,
    translation: jax.Array,
    measurements: Measurements,
    config: FastSLAMConfig,
    proposal_floors: Tuple[jax.Array, jax.Array] | None = None,
    evidence_scale: jax.Array | None = None,
) -> Tuple[FilterState, jax.Array]:
    """One full filter iteration == reference ``FastSLAM2.iterate``
    (``fast_slam_2.py:33-67``): propagate, per-measurement EKF updates,
    normalize, Neff, conditional systematic resampling, pose estimate.

    ``proposal_floors`` optionally overrides the fastslam2 proposal's
    (xy, theta) floors with traced values (adaptive-floor path);
    ``evidence_scale`` is the traced proposal mode dial (see
    :func:`fastslam2_propose`).

    Returns ``(new_state, estimated_pose [3])``.
    """
    rng, k_rot, k_trans, k_u = jax.random.split(state.rng, 4)
    p = state.num_particles
    dt = state.poses.dtype

    if config.proposal_mode == "fastslam2" and not config.parity_mode:
        # measurement-informed proposal (true FastSLAM 2.0); weights carry the
        # measurement evidence, so the landmark EKF pass skips weighting
        noise = jax.random.normal(k_rot, (p, 3), dtype=dt)
        state = state._replace(rng=rng)
        fxy, fth = proposal_floors if proposal_floors is not None else (None, None)
        state, _ = fastslam2_propose(
            state, rotation, translation, measurements, noise, config,
            xy_floor=fxy, theta_floor=fth, evidence_scale=evidence_scale,
        )
        state = update_particles(
            state, measurements, config,
            update_weights=not config.fs2_evidence_weights,
        )
    else:
        rot_noise = config.rotation_noise * jax.random.normal(k_rot, (p,), dtype=dt)
        trans_noise = config.translation_noise * jax.random.normal(
            k_trans, (p,), dtype=dt
        )
        poses = propagate_particles(
            state.poses, rotation, translation, rot_noise, trans_noise
        )
        state = state._replace(poses=poses, rng=rng)
        state = update_particles(state, measurements, config)

    log_w = normalize_log_weights(state.log_weights, config)
    state = state._replace(log_weights=log_w)

    neff = effective_particles(log_w, config)
    u0 = jax.random.uniform(k_u, (), dtype=dt, maxval=1.0 / p)

    def do_resample(s):
        idx = systematic_resample_indices(jnp.exp(s.log_weights), u0)
        return resample_state(s, idx, config)

    state = jax.lax.cond(
        neff < config.resample_threshold_frac * p, do_resample, lambda s: s, state
    )
    return state, estimate_pose(state)


# ---------------------------------------------------------------------------
# planes-native steps (fused kernel, [L, P] layout carried between steps)
# ---------------------------------------------------------------------------

def resample_planes_state(state: PlanesState, idx: jax.Array,
                          config: FastSLAMConfig) -> PlanesState:
    """Ancestor gather in the planes layout: landmark planes gather along the
    particle (minor) axis, per-particle arrays along axis 0."""
    n = state.num_particles
    if config.parity_mode:
        new_log_w = jnp.take(state.log_weights, idx, axis=0)
    else:
        new_log_w = jnp.full((n,), -jnp.log(n), dtype=state.log_weights.dtype)
    g = lambda plane: jnp.take(plane, idx, axis=1)
    return state._replace(
        poses=jnp.take(state.poses, idx, axis=0),
        log_weights=new_log_w,
        lm_mx=g(state.lm_mx), lm_my=g(state.lm_my),
        lm_ca=g(state.lm_ca), lm_cb=g(state.lm_cb),
        # no cc plane on the production path (cc == cb; see PlanesState)
        lm_cc=None if state.lm_cc is None else g(state.lm_cc),
        lm_cd=g(state.lm_cd),
        lm_count=jnp.take(state.lm_count, idx, axis=0),
    )


def fs2_prior_scalars(
    rotation: jax.Array,
    translation: jax.Array,
    config: FastSLAMConfig,
    proposal_floors: Tuple[jax.Array, jax.Array] | None = None,
):
    """Traced scalars of the fastslam2 motion prior for one tick (or ``[C]``
    vectors for a chunk): squared floors and the rotation-XOR-translation
    variance structure of :func:`fastslam2_propose`'s prior block.

    Returns ``(rot_eff, trans_eff, s_t2, s_r2, fxy)``.
    """
    fxy_f, fth_f = (proposal_floors if proposal_floors is not None
                    else (None, None))
    fxy = (config.proposal_xy_floor if fxy_f is None else fxy_f) ** 2
    fth = (config.proposal_theta_floor if fth_f is None else fth_f) ** 2
    rotating = rotation != 0.0
    rot_eff = jnp.where(rotating, rotation, 0.0)
    trans_eff = jnp.where(rotating, 0.0, translation)
    s_t2 = jnp.where(rotating, 0.0, config.translation_noise ** 2) + fxy
    s_r2 = jnp.where(rotating, config.rotation_noise ** 2, 0.0) + fth
    return rot_eff, trans_eff, s_t2, s_r2, fxy


def _pin_planes(state: PlanesState, config: FastSLAMConfig, mesh):
    if mesh is None:
        return state
    from fastslam_tpu.parallel.mesh import planes_state_sharding

    shardings = planes_state_sharding(mesh, config)
    return jax.tree.map(jax.lax.with_sharding_constraint, state, shardings)


def _planes_ticks(state: PlanesState, rotations, translations,
                  measurements: Measurements, config: FastSLAMConfig,
                  k_rot, k_trans, proposal_floors=None, evidence_scale=None,
                  mesh=None, tile=None):
    """C ticks of sampling + measurement update through the fused kernel.

    ``rotations``/``translations`` are ``[C]``; measurements ``[C, M, ...]``.
    Motion proposal: per-tick, per-particle noisy increments with the
    reference's rotation-XOR-translation structure (same draws as
    :func:`fastslam_step` at C=1).  FastSLAM 2.0 proposal: standard-normal
    pose-sample draws plus the per-tick prior scalars; the kernel predicts,
    accumulates the proposal, samples, then runs the EKF.

    With a ``mesh`` the kernel runs per shard under ``shard_map`` (it is
    particle-parallel: no collectives inside a chunk).  ``tile`` is an
    optional ``(particles per program, warps)`` for the kernel, a
    scheduling choice that leaves results unchanged (tuning sweeps).

    Returns ``((tx, ty, tyaw, tlogw) [C, P] per-tick rows, planes, count)``.
    """
    from fastslam_tpu.core.pallas_kernels import NUM_WARPS, filter_ticks

    p = state.num_particles
    c = rotations.shape[0]
    dt = state.poses.dtype
    if config.proposal_mode == "fastslam2" and not config.parity_mode:
        # (C, P, 3) then transposed: at C=1 the same draws as fastslam_step
        noise = jax.random.normal(k_rot, (c, p, 3), dtype=dt)
        rot_eff, trans_eff, s_t2, s_r2, fxy = fs2_prior_scalars(
            rotations, translations, config, proposal_floors
        )
        dial = (jnp.ones((c,), dt) if evidence_scale is None
                else jnp.broadcast_to(jnp.asarray(evidence_scale, dt), (c,)))
        tick_rows = (noise[:, :, 0], noise[:, :, 1], noise[:, :, 2])
        tick_scalars = jnp.stack(
            [rot_eff, trans_eff, s_t2, s_r2,
             jnp.broadcast_to(jnp.asarray(fxy, dt), (c,)), dial], axis=1,
        ).astype(dt)
    else:
        # reference motion structure (fast_slam_2.py:77-82): per tick, EITHER
        # rotation with rotation noise OR translation with translation noise
        rot_noise = config.rotation_noise * jax.random.normal(
            k_rot, (c, p), dtype=dt)
        trans_noise = config.translation_noise * jax.random.normal(
            k_trans, (c, p), dtype=dt)
        rotating = (rotations != 0.0)[:, None]
        tick_rows = (
            jnp.where(rotating, rotations[:, None] + rot_noise, 0.0),
            jnp.where(rotating, 0.0, translations[:, None] + trans_noise),
        )
        tick_scalars = None

    planes = (state.lm_mx, state.lm_my, state.lm_ca, state.lm_cb,
              state.lm_cc, state.lm_cd)

    block, warps = tile or (None, NUM_WARPS)

    def run(poses, logw, planes, count, rows, rb, valid, scalars):
        return filter_ticks(poses, logw, planes, count, rb, valid, rows,
                            scalars, config,
                            interpret=config.pallas_interpret,
                            block=block, num_warps=warps)

    args = (state.poses, state.log_weights, planes, state.lm_count,
            tick_rows, measurements.range_bearing, measurements.valid,
            tick_scalars)
    if mesh is None:
        return run(*args)

    from jax import shard_map
    from jax.sharding import PartitionSpec as P

    pax = config.particle_axis
    plane = P(None, pax)
    planes_spec = tuple(None if x is None else plane for x in planes)
    rows_spec = (plane,) * len(tick_rows)
    return shard_map(
        run, mesh=mesh,
        in_specs=(P(pax, None), P(pax), planes_spec, P(pax), rows_spec,
                  P(), P(), None if tick_scalars is None else P()),
        out_specs=((plane,) * 4, planes_spec, P(pax)),
        check_vma=False,
    )(*args)


def _with_ticks_result(state: PlanesState, traj, planes, count, rng,
                       tick: int) -> PlanesState:
    tx, ty, tyaw, tlogw = traj
    mx, my, ca, cb, cc, cd = planes
    return state._replace(
        poses=jnp.stack([tx[tick], ty[tick], tyaw[tick]], axis=-1),
        log_weights=tlogw[tick], lm_mx=mx, lm_my=my, lm_ca=ca, lm_cb=cb,
        lm_cc=cc, lm_cd=cd, lm_count=count, rng=rng,
    )


def _normalize_and_resample(state: PlanesState, u0, config, mesh):
    p = state.num_particles
    log_w = normalize_log_weights(state.log_weights, config)
    state = state._replace(log_weights=log_w)
    neff = effective_particles(log_w, config)

    def do_resample(s):
        idx = systematic_resample_indices(jnp.exp(s.log_weights), u0)
        return resample_planes_state(s, idx, config)

    state = jax.lax.cond(
        neff < config.resample_threshold_frac * p, do_resample,
        lambda s: s, state,
    )
    return _pin_planes(state, config, mesh)


def fastslam_step_planes(
    state: PlanesState,
    rotation: jax.Array,
    translation: jax.Array,
    measurements: Measurements,
    config: FastSLAMConfig,
    proposal_floors: Tuple[jax.Array, jax.Array] | None = None,
    evidence_scale: jax.Array | None = None,
    mesh=None,
    tile: Tuple[int, int] | None = None,
) -> Tuple[PlanesState, jax.Array]:
    """One full filter iteration on the planes-layout state.

    Same math and RNG stream as :func:`fastslam_step`; the sampling and the
    measurement update run as one fused kernel launch
    (:func:`~fastslam_tpu.core.pallas_kernels.filter_ticks`, C=1) that keeps
    each particle tile's landmark planes on chip across all M measurements.
    ``mesh`` (a 1-D particle mesh) runs the kernel per shard and pins the
    state's sharding; weights, Neff and resampling stay under GSPMD.
    ``tile`` overrides the kernel's ``(particles per program, warps)``.
    """
    rng, k_rot, k_trans, k_u = jax.random.split(state.rng, 4)
    state = _pin_planes(state, config, mesh)
    traj, planes, count = _planes_ticks(
        state, jnp.reshape(rotation, (1,)), jnp.reshape(translation, (1,)),
        Measurements(measurements.range_bearing[None],
                     measurements.valid[None]),
        config, k_rot, k_trans, proposal_floors,
        None if evidence_scale is None else jnp.reshape(evidence_scale, (1,)),
        mesh=mesh, tile=tile,
    )
    state = _with_ticks_result(state, traj, planes, count, rng, 0)
    u0 = jax.random.uniform(k_u, (), dtype=state.poses.dtype,
                            maxval=1.0 / state.num_particles)
    state = _normalize_and_resample(state, u0, config, mesh)
    best = jnp.argmax(state.log_weights)
    return state, state.poses[best]


def fastslam_steps_planes_chunked(
    state: PlanesState,
    rotations: jax.Array,     # [C] per-tick odometry
    translations: jax.Array,  # [C]
    measurements: Measurements,  # range_bearing [C, M, 2], valid [C, M]
    config: FastSLAMConfig,
    proposal_floors: Tuple[jax.Array, jax.Array] | None = None,
    evidence_scale: jax.Array | None = None,  # [C] per-tick mode dial
    mesh=None,
    tile: Tuple[int, int] | None = None,
) -> Tuple[PlanesState, jax.Array]:
    """C filter ticks in ONE fused kernel launch (production mode only).

    The landmark planes stay on chip across the whole chunk, so their
    read/write — the per-tick fixed cost of :func:`fastslam_step_planes` —
    is paid once per chunk.  Semantics vs the per-tick step:

    * Sampling and the measurement update are the same math (the kernel
      runs the same tick body C times).
    * Weight normalization, Neff, and systematic resampling run at CHUNK
      boundaries only — within a chunk log-weights accumulate unnormalized
      (numerically stable in log space; normalization only shifts all
      particles equally).  A mid-chunk Neff collapse is therefore acted on
      up to C-1 ticks late; choose C accordingly (the eval suite's chunked
      rows track the accuracy cost).
    * Per-tick pose estimates come from the per-tick argmax of the
      accumulated log-weights (normalization-invariant), BEFORE the
      chunk-boundary resample — identical to the per-tick estimate except on
      the exact tick a resample would have fired.

    The RNG stream differs from the per-tick step (one split per chunk, not
    per tick).  Parity mode must use :func:`fastslam_step_planes`.

    Returns ``(new_state, per-tick estimated poses [C, 3])``.
    """
    if config.parity_mode:
        raise NotImplementedError(
            "chunked execution is a production-mode feature; parity mode "
            "resamples per tick (fast_slam_2.py:62) — use fastslam_step_planes"
        )
    rng, k_rot, k_trans, k_u = jax.random.split(state.rng, 4)
    c = rotations.shape[0]
    state = _pin_planes(state, config, mesh)
    traj, planes, count = _planes_ticks(
        state, rotations, translations, measurements, config, k_rot, k_trans,
        proposal_floors, evidence_scale, mesh=mesh, tile=tile,
    )
    tx, ty, tyaw, tlogw = traj
    # per-tick pose estimates: argmax of the (unnormalized) per-tick weights
    best = jnp.argmax(tlogw, axis=1)                            # [C]
    ticks = jnp.arange(c)
    est = jnp.stack(
        [tx[ticks, best], ty[ticks, best], tyaw[ticks, best]], axis=-1
    )
    state = _with_ticks_result(state, traj, planes, count, rng, c - 1)
    u0 = jax.random.uniform(k_u, (), dtype=state.poses.dtype,
                            maxval=1.0 / state.num_particles)
    return _normalize_and_resample(state, u0, config, mesh), est
