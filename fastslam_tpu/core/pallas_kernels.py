"""The fused filter tick: one Pallas kernel for NVIDIA GPUs (Triton route).

The XLA path (``kernels.update_particles``) is a ``lax.scan`` over the M
measurements of a tick, and every step reads and writes the whole
``[P, L]`` landmark map.  Here one program owns a tile of ``T`` particles and
keeps that tile's landmark planes (``[L, T]`` per component, particles on the
minor axis so loads coalesce) on chip for C whole ticks:

  per tick: sample the pose (motion model, or the FastSLAM 2.0 proposal —
  predict, accumulate the measurement-informed posterior, Cholesky-sample),
  then the serial measurement loop — association, 2x2 EKF, weight, append.

The planes move between device memory and the chip once per launch instead
of once per measurement.  The arithmetic is the XLA path's own: the kernel
calls the same helpers from ``core/kernels.py`` on ``[1, T]`` rows and
``[L, T]`` planes.  Programs are independent (one particle tile each), so the
grid runs in any order.  Random draws come from ``jax.random`` outside.
"""

from __future__ import annotations

import functools
from types import MappingProxyType
from typing import Tuple

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from fastslam_tpu.config import FastSLAMConfig
from fastslam_tpu.core import kernels as K

# particles per program, per proposal, and warps per program: the fastest
# of T in {16, 32, 64} x warps in {2, 4, 8} on the H100 at P=100k, L=64,
# M=16 (PERF.md; scripts/time_filter_step.py --sweep).  Callers that
# sweep them pass ``filter_ticks(block=, num_warps=)``.
BLOCK = MappingProxyType({"motion": 32, "fastslam2": 16})
NUM_WARPS = 2


def _pow2(n: int) -> int:
    return 1 << max(n - 1, 0).bit_length()


def particle_block(num_particles: int, block: int = BLOCK["motion"]) -> int:
    """Particles per program: ``block``, or the next power of two above a
    smaller particle count (Triton block shapes are powers of two; the
    kernel masks the tail of the last tile, so P needs no padding)."""
    return min(block, max(16, _pow2(num_particles)))


def _gather(onehot, plane):
    """The matched slot's value per particle (exact: one nonzero term)."""
    return jnp.sum(jnp.where(onehot, plane, 0.0), axis=0, keepdims=True)


def _measurement(planes, cnt, logw, pose, z, slot, n_lm, config,
                 weight_update):
    """One measurement through association + EKF + append on a tile —
    :func:`kernels.update_particles_one` in the planes layout.  Production
    carries five planes (cc == cb, the EKF symmetrizes), parity six."""
    sym = len(planes) == 5
    if sym:
        mx, my, ca, cb, cd = planes
        cc = cb
    else:
        mx, my, ca, cb, cc, cd = planes
    px, py, yaw = pose
    dist_z, bearing_z, z_ok = z
    wx = px + dist_z * jnp.cos(yaw + bearing_z)
    wy = py + dist_z * jnp.sin(yaw + bearing_z)
    if config.parity_mode:
        # reference quirk: robot-frame association query
        qx, qy = dist_z * jnp.cos(bearing_z), dist_z * jnp.sin(bearing_z)
    else:
        qx, qy = wx, wy
    idx, has_match = K._associate(mx, my, ca, cb, cc, cd, slot < cnt, qx, qy,
                                  config, axis=0)
    onehot = slot == idx
    new_mx, new_my, new_a, new_b, new_c, new_d, log_lik = K._landmark_ekf(
        _gather(onehot, mx), _gather(onehot, my), _gather(onehot, ca),
        _gather(onehot, cb), _gather(onehot, cc), _gather(onehot, cd),
        px, py, yaw, dist_z, bearing_z, config,
    )
    do_update = z_ok & has_match
    do_append = z_ok & (~has_match) & (cnt < n_lm)
    # one write per plane: per particle at most one of update/append fires
    tgt = (onehot & do_update) | ((slot == cnt) & do_append)
    put = lambda plane, upd, app: jnp.where(
        tgt, jnp.where(do_update, upd, app), plane)
    cov0 = config.default_landmark_cov
    mx = put(mx, new_mx, wx)
    my = put(my, new_my, wy)
    ca = put(ca, new_a, cov0)
    cb = put(cb, new_b, 0.0)
    cd = put(cd, new_d, cov0)
    cnt = cnt + do_append.astype(jnp.int32)
    if weight_update:
        logw = jnp.where(do_update, logw + log_lik, logw)
    if sym:
        return (mx, my, ca, cb, cd), cnt, logw
    return (mx, my, ca, cb, put(cc, new_c, 0.0), cd), cnt, logw


def _filter_kernel(*refs, n_ticks, n_meas, n_lm, n_particles, block, fs2,
                   n_planes, config):
    it = iter(refs)
    z_ref, zv_ref, mlast_ref = next(it), next(it), next(it)
    scal_ref = next(it) if fs2 else None
    x_ref, y_ref, yaw_ref, logw_ref, cnt_ref = (next(it) for _ in range(5))
    row_refs = [next(it) for _ in range(3 if fs2 else 2)]
    plane_in = [next(it) for _ in range(n_planes)]
    traj_out = [next(it) for _ in range(4)]
    plane_out = [next(it) for _ in range(n_planes)]
    cnt_out = next(it)

    lm_block = plane_in[0].shape[0]
    col = (pl.program_id(0) * block
           + jax.lax.broadcasted_iota(jnp.int32, (1, block), 1))
    colmask = col < n_particles                               # [1, T]
    slot = jax.lax.broadcasted_iota(jnp.int32, (lm_block, block), 0)
    planemask = colmask & (slot < n_lm)                       # [Lb, T]

    load_row = lambda ref: plgpu.load(ref, mask=colmask, other=0.0)
    tick_row = lambda ref, k: plgpu.load(ref.at[pl.ds(k, 1), :],
                                         mask=colmask, other=0.0)
    planes = tuple(plgpu.load(r, mask=planemask, other=0.0) for r in plane_in)
    pose = (load_row(x_ref), load_row(y_ref), load_row(yaw_ref))
    logw = load_row(logw_ref)
    cnt = plgpu.load(cnt_ref, mask=colmask, other=0)

    def measurement_loop(k, planes, cnt, logw, pose, weight_update):
        def body(m, carry):
            planes, cnt, logw = carry
            zi = k * n_meas + m
            z = (z_ref[zi, 0], z_ref[zi, 1], zv_ref[zi] > 0)
            return _measurement(planes, cnt, logw, pose, z, slot, n_lm,
                                config, weight_update)

        return jax.lax.fori_loop(0, mlast_ref[k], body, (planes, cnt, logw))

    def tick(k, carry):
        planes, cnt, logw, (x, y, yaw) = carry
        if fs2:
            rot, trans = scal_ref[k, 0], scal_ref[k, 1]
            s_t2, s_r2, fxy, dial = (scal_ref[k, 2], scal_ref[k, 3],
                                     scal_ref[k, 4], scal_ref[k, 5])
            yaw_p = K.wrap_angle(yaw + rot)
            px = x + trans * jnp.cos(yaw_p)
            py = y + trans * jnp.sin(yaw_p)
            prior, lam = K._proposal_prior(yaw_p, s_t2, s_r2, fxy)
            mx, my, ca, cb, cd = planes   # fs2 is production: cc == cb
            cc = cb

            def accumulate(m, acc):
                zi = k * n_meas + m
                dist_z, bearing_z = z_ref[zi, 0], z_ref[zi, 1]
                wx = px + dist_z * jnp.cos(yaw_p + bearing_z)
                wy = py + dist_z * jnp.sin(yaw_p + bearing_z)
                idx, has_match = K._associate(mx, my, ca, cb, cc, cd,
                                              slot < cnt, wx, wy, config,
                                              axis=0)
                onehot = slot == idx
                return K._proposal_step(
                    acc, _gather(onehot, mx), _gather(onehot, my),
                    _gather(onehot, ca), _gather(onehot, cb),
                    _gather(onehot, cc), _gather(onehot, cd),
                    (zv_ref[zi] > 0) & has_match, px, py, yaw_p, dist_z,
                    bearing_z, prior, s_r2, dial, config,
                )

            zero = jnp.zeros_like(px)
            lam, e0, e1, e2, log_ev = jax.lax.fori_loop(
                0, mlast_ref[k], accumulate, (lam, zero, zero, zero, zero))
            if config.fs2_evidence_weights:
                logw = logw + log_ev
            pose = K._sample_pose(lam, e0, e1, e2, px, py, yaw_p,
                                  *(tick_row(r, k) for r in row_refs))
            weight_update = not config.fs2_evidence_weights
        else:
            nrot, ntrans = (tick_row(r, k) for r in row_refs)
            yaw = K.wrap_angle(yaw + nrot)
            pose = (x + ntrans * jnp.cos(yaw), y + ntrans * jnp.sin(yaw), yaw)
            weight_update = True
        planes, cnt, logw = measurement_loop(k, planes, cnt, logw, pose,
                                             weight_update)
        for ref, val in zip(traj_out, (*pose, logw)):
            plgpu.store(ref.at[pl.ds(k, 1), :], val, mask=colmask)
        return planes, cnt, logw, pose

    planes, cnt, logw, _ = jax.lax.fori_loop(
        0, n_ticks, tick, (planes, cnt, logw, pose))
    for ref, val in zip(plane_out, planes):
        plgpu.store(ref, val, mask=planemask)
    plgpu.store(cnt_out, cnt, mask=colmask)


def filter_ticks(
    poses: jax.Array,          # [P, 3]
    log_weights: jax.Array,    # [P]
    planes: Tuple,             # (mx, my, ca, cb, cc | None, cd), each [L, P]
    lm_count: jax.Array,       # [P] int32
    z: jax.Array,              # [C, M, 2] (distance, bearing)
    z_valid: jax.Array,        # [C, M] bool
    tick_rows: Tuple,          # per-tick [C, P] rows, see below
    tick_scalars,              # [C, 6] (fs2) or None (motion)
    config: FastSLAMConfig,
    *,
    interpret: bool = False,
    block: int | None = None,
    num_warps: int = NUM_WARPS,
):
    """C filter ticks (sampling + measurement update) in one kernel launch.

    Motion proposal (``tick_scalars is None``): ``tick_rows = (noisy_rot,
    noisy_trans)``, the per-particle increments with the reference's
    rotation-XOR-translation structure already applied.  FastSLAM 2.0
    (production only): ``tick_rows`` are the three standard-normal
    pose-sample draws and ``tick_scalars`` the per-tick
    ``(rot_eff, trans_eff, s_t2, s_r2, fxy, dial)`` of
    :func:`kernels.fs2_prior_scalars` plus the mode dial.

    Production mode carries no ``cc`` plane (``planes[4] is None``: the
    symmetrized EKF keeps cc == cb); parity mode carries all six.  P and L
    need not be powers of two: the kernel masks the particle tail and the
    slot rows above L.  The particle tile (``block``, default
    ``BLOCK[proposal]``) and ``num_warps`` are pure scheduling choices:
    results are bit-identical at any tile.  ``interpret=True`` runs
    the kernel on the CPU; any other backend than a GPU refuses it.

    Returns ``((tx, ty, tyaw, tlogw) [C, P] per-tick rows, planes, count)``
    with ``planes`` in the input's form.
    """
    if not interpret and jax.default_backend() != "gpu":
        raise RuntimeError(
            "the fused filter kernel needs an NVIDIA GPU (JAX backend "
            f"'{jax.default_backend()}'); pass interpret=True "
            "(config.pallas_interpret) to run it on the CPU")
    fs2 = tick_scalars is not None
    if fs2 and config.parity_mode:
        raise ValueError("the fastslam2 proposal is production-mode only")
    sym = planes[4] is None
    if sym == config.parity_mode:
        raise ValueError("parity mode carries a cc plane; production does not")
    l, p = planes[0].shape
    c, m = z.shape[0], z.shape[1]
    dt = planes[0].dtype
    t = particle_block(p, block or BLOCK["fastslam2" if fs2 else "motion"])
    lb = _pow2(l)
    kept = [x for x in planes if x is not None]

    row = lambda x: x.reshape(1, p)
    full = lambda shape: pl.BlockSpec(shape, lambda i: (0,) * len(shape))
    rowspec = pl.BlockSpec((1, t), lambda i: (0, i))
    tickspec = pl.BlockSpec((c, t), lambda i: (0, i))
    planespec = pl.BlockSpec((lb, t), lambda i: (0, i))

    zf = z.reshape(c * m, 2).astype(dt)
    zv = z_valid.reshape(c * m).astype(jnp.int32)
    # per-tick trip count: last valid measurement + 1 (padding is packed last)
    mlast = jnp.max(jnp.where(z_valid, jnp.arange(1, m + 1, dtype=jnp.int32),
                              0), axis=1).astype(jnp.int32)
    scalars = () if tick_scalars is None else (tick_scalars.astype(dt),)

    in_specs = ([full((c * m, 2)), full((c * m,)), full((c,))]
                + [full((c, 6))] * len(scalars)
                + [rowspec] * 5 + [tickspec] * len(tick_rows)
                + [planespec] * len(kept))
    out_shape = ([jax.ShapeDtypeStruct((c, p), dt)] * 4
                 + [jax.ShapeDtypeStruct((l, p), dt)] * len(kept)
                 + [jax.ShapeDtypeStruct((1, p), jnp.int32)])
    out_specs = [tickspec] * 4 + [planespec] * len(kept) + [rowspec]

    kernel = functools.partial(
        _filter_kernel, n_ticks=c, n_meas=m, n_lm=l, n_particles=p, block=t,
        fs2=fs2, n_planes=len(kept), config=config,
    )
    outs = pl.pallas_call(
        kernel,
        grid=(pl.cdiv(p, t),),
        in_specs=in_specs,
        out_specs=out_specs,
        out_shape=out_shape,
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=num_warps),
        interpret=interpret,
        name="fastslam_filter_ticks",
    )(zf, zv, mlast, *scalars,
      row(poses[:, 0]), row(poses[:, 1]), row(poses[:, 2]), row(log_weights),
      row(lm_count.astype(jnp.int32)),
      *(r.astype(dt) for r in tick_rows), *kept)
    traj = tuple(outs[:4])
    new = list(outs[4:4 + len(kept)])
    if sym:
        new.insert(4, None)
    return traj, tuple(new), outs[-1].reshape(p)
