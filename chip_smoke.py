"""Smoke test of the filter on NVIDIA GPUs, through the normal entry points.

  python chip_smoke.py           # one GPU: every phase below
  python chip_smoke.py --multi   # four GPUs: the sharded paths only

Phases (one GPU), at the flagship width P=100,000 particles, L=64 landmark
slots, M=16 measurements per tick, 180-beam scans:

  1. device     JAX version, device kind, the card's name and power limit
  2. parity     the fused kernel vs the XLA blocks path (float32, 'highest'
                precision) for the motion and FastSLAM 2.0 proposals, one
                tick per launch and 16, on a map built from a simulator log
                and on a full map (every slot taken, 16 valid measurements
                a tick): landmark counts exact, means, covariances, poses
                and log-weights within stated tolerances; and parity mode
                through the kernel vs the NumPy oracle
  3. online     run_driver over a recorded 300-tick log (production mode,
                motion, then fastslam2 with the adaptive stack): finite,
                bounded ATE
  4. chunked    replay_chunked at 16 ticks per launch on the same log
  5. backend    one pose-graph optimize on the GPU vs the same call on the
                host CPU device
  6. memory     compiled memory analysis of the flagship step, peak bytes

``--multi`` compares, on a 1-D particle mesh over four GPUs, the GSPMD step,
the sharded kernel step and both distributed resamplers with one GPU.

Every phase raises on failure; the last line of a passing run is one JSON
object naming the device.  The phases are functions so the tests can run
them at a tiny size on the CPU (``interpret=True``); only :func:`main`
insists on a GPU.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np

import jax
import jax.numpy as jnp

from fastslam_tpu.config import FastSLAMConfig
from fastslam_tpu.core import kernels
from fastslam_tpu.core.pallas_kernels import filter_ticks
from fastslam_tpu.core.state import (
    Measurements, init_state, pad_measurements, to_planes,
)
from fastslam_tpu.utils.compile_cache import enable_compile_cache
from fastslam_tpu.utils.device import nvidia_smi, require_gpu

FLAGSHIP = dict(num_particles=100_000, max_landmarks=64, max_measurements=16)

# Kernel vs XLA tolerances.  Both compute in float32, but they round
# differently: the two compilers contract multiply-adds into FMAs in
# different places and Triton's float32 divide is not XLA's, so each
# measurement's EKF differs by a few ulp and the differences compound over a
# tick's 16 sequential updates (and, chunked, over 16 ticks, where the fs2
# proposal's sampled pose feeds the next association).  Landmark counts and
# therefore every association decision must match exactly; a wrong
# association would move a landmark by metres and a log-weight by hundreds.
# Runs on H100 80GB HBM3 cards (400 W and 700 W limits) measured at most
# 9.5e-7 m (pose), 1.6e-6 m (mean), 2.5e-8 (cov) and 2.9e-4 (log-weight),
# all in fs2 at 16 ticks per launch (the full map: 5M landmark updates);
# the bounds sit 34-105x above that.
TOL = {"pose_m": 1e-4, "mean_m": 1e-4, "cov": 1e-6, "logw": 1e-2}

# ATE bound for the 300-tick seed-3 log.  The same phases at 128 particles
# on the CPU (kernel interpreted) gave 0.017 m (motion) and 0.027 m
# (fastslam2 + adaptive) online, 0.023 / 0.026 m chunked; 0.1 m flags a
# filter that has lost track.
ATE_BOUND_M = 0.1


def log_inputs(config: FastSLAMConfig, num_ticks: int, seed: int = 3):
    """A recorded simulator log and its batched filter inputs (command
    odometry and frontend measurements, paired as the online loop pairs
    them)."""
    from fastslam_tpu.app.runner import replay_inputs
    from fastslam_tpu.drivers.replay import record_log
    from fastslam_tpu.drivers.sim_world import SimWorld
    from fastslam_tpu.frontend.pipeline import scan_to_measurements

    log = record_log(SimWorld(seed=seed), num_ticks=num_ticks)
    pts, valid, rots, trans, _ = replay_inputs(log, config)
    ms = jax.jit(lambda p, v: jax.lax.map(
        lambda pv: scan_to_measurements(pv[0], pv[1], config), (p, v)))(
        jnp.asarray(pts), jnp.asarray(valid))
    return log, jnp.asarray(rots), jnp.asarray(trans), ms


def _xla_ticks(state, rows, scalars, rots, trans, ms, config):
    """The XLA blocks path over C ticks with the kernel's draws: motion =
    propagate + scan update; fs2 = fastslam2_propose + scan update.  No
    normalization between ticks (the kernel accumulates log-weights)."""
    fs2 = scalars is not None

    def tick(st, xs):
        if fs2:
            n0, n1, n2, rot, tr, z, zv = xs
            st, _ = kernels.fastslam2_propose(
                st, rot, tr, Measurements(z, zv),
                jnp.stack([n0, n1, n2], axis=-1), config)
            upd = not config.fs2_evidence_weights
        else:
            nrot, ntr, z, zv = xs
            yaw = kernels.wrap_angle(st.poses[:, 2] + nrot)
            st = st._replace(poses=jnp.stack(
                [st.poses[:, 0] + ntr * jnp.cos(yaw),
                 st.poses[:, 1] + ntr * jnp.sin(yaw), yaw], axis=-1))
            upd = True
        st = kernels.update_particles(st, Measurements(z, zv), config,
                                      update_weights=upd)
        return st, None

    xs = (*rows, rots, trans) if fs2 else rows
    st, _ = jax.lax.scan(tick, state, (*xs, ms.range_bearing, ms.valid))
    return st


def _synthetic_inputs(num_ticks: int, warm_ticks: int, max_measurements: int):
    """Straight-line driving (0.4 m a tick) with the same 16 measurements
    every tick, as ``bench.py`` times it, so the warm-up fills every slot;
    then one step back to the pose of the first tick, so the compared
    ticks retrace the path: each measurement either updates a landmark it
    saw then or, with no match, is dropped at capacity."""
    ms = [(2.0 + 0.3 * i, -2.5 + 0.35 * i) for i in range(16)]
    ms = np.asarray(ms[:max_measurements], np.float32)
    rb = np.zeros((num_ticks, max_measurements, 2), np.float32)
    rb[:, :len(ms)] = ms
    valid = np.zeros((num_ticks, max_measurements), bool)
    valid[:, :len(ms)] = True
    trans = np.full(num_ticks, 0.4, np.float32)
    trans[warm_ticks] -= 0.4 * warm_ticks
    return (jnp.zeros(num_ticks), jnp.asarray(trans),
            Measurements(jnp.asarray(rb), jnp.asarray(valid)))


def kernel_parity(num_particles=100_000, max_landmarks=64,
                  max_measurements=16, chunk=16, warm_ticks=24, seed=3,
                  interpret=False, maps=("log", "full")) -> list[dict]:
    """Phase 2: the fused kernel vs the XLA blocks path from a warm state.

    Two maps, each warmed by ``warm_ticks`` XLA ticks: ``log`` over a
    simulator log (a few landmarks a particle, the measurements a real run
    sees), and ``full`` over synthetic driving with 16 valid measurements a
    tick, which fills every particle's slots (association over all L
    slots and appends dropped at capacity, as in the timed runs).  Then,
    for each proposal and for 1 and ``chunk`` ticks per launch, the kernel
    and the XLA path take the same draws through the next ticks.  Returns
    one row of max deviations per case."""
    cfg = FastSLAMConfig(num_particles=num_particles,
                         max_landmarks=max_landmarks,
                         max_measurements=max_measurements,
                         parity_mode=False, pallas_interpret=interpret)
    step = jax.jit(lambda s, r, t, z, v: kernels.fastslam_step(
        s, r, t, Measurements(z, v), cfg))
    p = num_particles
    key = jax.random.key(seed + 1)
    rows_out = []
    for map_name in maps:
        if map_name == "log":
            _, rots, trans, ms = log_inputs(cfg, warm_ticks + chunk, seed)
        else:
            rots, trans, ms = _synthetic_inputs(warm_ticks + chunk,
                                                warm_ticks, max_measurements)
        st = init_state(cfg, rng=seed)
        with jax.default_matmul_precision("highest"):
            for t in range(warm_ticks):
                st, _ = step(st, rots[t], trans[t], ms.range_bearing[t],
                             ms.valid[t])
        if map_name == "full" and int(jnp.min(st.lm_count)) < max_landmarks:
            raise AssertionError("the full-map warm-up left free slots")
        rows_out += _parity_cases(st, rots, trans, ms, cfg, key, p, chunk,
                                  warm_ticks, map_name, interpret)
    return rows_out


def _parity_cases(st, rots, trans, ms, cfg, key, p, chunk, warm_ticks,
                  map_name, interpret):
    rows_out = []
    for proposal in ("motion", "fastslam2"):
        pcfg = cfg.replace(proposal_mode=proposal)
        for c in (1, chunk):
            sl = slice(warm_ticks, warm_ticks + c)
            r, tr = rots[sl], trans[sl]
            msc = Measurements(ms.range_bearing[sl], ms.valid[sl])
            if proposal == "fastslam2":
                rows = tuple(jax.random.normal(k, (c, p))
                             for k in jax.random.split(key, 3))
                rot_eff, trans_eff, s_t2, s_r2, fxy = kernels.fs2_prior_scalars(
                    r, tr, pcfg)
                scalars = jnp.stack(
                    [rot_eff, trans_eff, s_t2, s_r2,
                     jnp.full((c,), fxy), jnp.ones((c,))], axis=1)
            else:
                k1, k2 = jax.random.split(key)
                rot_n = pcfg.rotation_noise * jax.random.normal(k1, (c, p))
                tr_n = pcfg.translation_noise * jax.random.normal(k2, (c, p))
                rows = (jnp.where(r[:, None] != 0, r[:, None] + rot_n, 0.0),
                        jnp.where(r[:, None] != 0, 0.0, tr[:, None] + tr_n))
                scalars = None
            ps = to_planes(st, pcfg)
            run = jax.jit(lambda ps, rows, scalars, z, zv: filter_ticks(
                ps.poses, ps.log_weights,
                (ps.lm_mx, ps.lm_my, ps.lm_ca, ps.lm_cb, None, ps.lm_cd),
                ps.lm_count, z, zv, rows, scalars, pcfg,
                interpret=interpret))
            (tx, ty, tyaw, tlogw), planes, cnt = run(
                ps, rows, scalars, msc.range_bearing, msc.valid)
            with jax.default_matmul_precision("highest"):
                want = jax.jit(_xla_ticks, static_argnums=6)(
                    st, rows, scalars, r, tr, msc, pcfg)
            mx, my, ca, cb, _, cd = planes
            cnt_w = np.asarray(want.lm_count)
            dev = lambda a, b: float(np.max(np.abs(np.asarray(a)
                                                   - np.asarray(b))))
            wm, wc = want.lm_mean, want.lm_cov
            moved = np.any(np.asarray(wm) != np.asarray(st.lm_mean), axis=-1)
            row = {
                "map": map_name, "proposal": proposal, "ticks_per_launch": c,
                "count_mismatches": int(np.sum(np.asarray(cnt) != cnt_w)),
                "pose_m": max(dev(tx[-1], want.poses[:, 0]),
                              dev(ty[-1], want.poses[:, 1]),
                              dev(tyaw[-1], want.poses[:, 2])),
                "mean_m": max(dev(mx, wm[..., 0].T), dev(my, wm[..., 1].T)),
                "cov": max(dev(ca, wc[..., 0].T), dev(cb, wc[..., 1].T),
                           dev(cd, wc[..., 3].T)),
                "logw": dev(tlogw[-1], want.log_weights),
                "landmarks": int(cnt_w.sum()),
                # (particle, slot) pairs the XLA path updated or appended
                "landmarks_moved": int(moved.sum()),
                "valid_measurements": int(np.asarray(msc.valid).sum()),
            }
            rows_out.append(row)
    return rows_out


def oracle_parity(num_particles=64, interpret=False) -> dict:
    """Phase 2b: parity mode through the kernel vs the NumPy oracle (the
    reference's equations, quirks included) over five ticks with the same
    injected noise; same bounds as tests/test_kernels.py's XLA-path check."""
    from tests.oracle import numpy_oracle as oracle

    n = num_particles
    cfg = FastSLAMConfig(num_particles=n, max_landmarks=16,
                         max_measurements=4, parity_mode=True,
                         pallas_interpret=interpret)
    parts = oracle.make_particles(n)
    ps = to_planes(init_state(cfg), cfg)
    rng = np.random.default_rng(7)
    ticks = [(0.0, 0.4, [(2.0, 0.3), (3.5, -1.0)]),
             (0.2, 0.0, [(2.1, 0.25)]),
             (0.0, 0.4, [(1.8, 0.35), (3.3, -1.05), (5.0, 2.0)]),
             (0.0, 0.4, []),
             (-0.15, 0.0, [(1.9, 0.3)])]
    step = jax.jit(lambda ps, rows, z, zv: filter_ticks(
        ps.poses, ps.log_weights,
        (ps.lm_mx, ps.lm_my, ps.lm_ca, ps.lm_cb, ps.lm_cc, ps.lm_cd),
        ps.lm_count, z, zv, rows, None, cfg, interpret=interpret))
    tail = jax.jit(lambda ps, u0: kernels._normalize_and_resample(
        ps, u0, cfg, None))
    pose_dev = 0.0
    for rotation, translation, ms in ticks:
        rot_noise = rng.normal(0, 0.001, n).astype(np.float32)
        trans_noise = rng.normal(0, 0.0055, n).astype(np.float32)
        u0 = float(rng.uniform(0, 1 / n))
        want = oracle.iterate(parts, rotation, translation, ms, rot_noise,
                              trans_noise, u0)
        rows = (np.where(rotation != 0, rotation + rot_noise, 0.0)[None],
                np.where(rotation != 0, 0.0, translation + trans_noise)[None])
        m = pad_measurements(cfg, np.array(ms).reshape(-1, 2))
        traj, planes, cnt = step(ps, tuple(map(jnp.asarray, rows)),
                                 m.range_bearing[None], m.valid[None])
        ps = kernels._with_ticks_result(ps, traj, planes, cnt, ps.rng, 0)
        ps = tail(ps, jnp.float32(u0))
        got = np.asarray(ps.poses[jnp.argmax(ps.log_weights)])
        pose_dev = max(pose_dev, float(np.max(np.abs(got - np.asarray(want)))))
    want_count = np.array([len(p.landmarks) for p in parts])
    out = {"particles": n, "ticks": len(ticks), "pose_dev_m": pose_dev,
           "count_mismatches": int(np.sum(np.asarray(cnt) != want_count))}
    if out["count_mismatches"] or pose_dev > 1e-4:
        raise AssertionError(f"parity mode vs the NumPy oracle: {out}")
    return out


def check_parity(rows: list[dict]) -> None:
    for row in rows:
        bad = [k for k, tol in TOL.items() if not row[k] <= tol]
        if row["count_mismatches"] or bad:
            raise AssertionError(f"kernel vs XLA parity failed: {row}")


def online_loop(num_particles=100_000, max_landmarks=64, ticks=300,
                interpret=False, chunk=None) -> dict:
    """Phases 3 and 4: the online loop (or, with ``chunk``, chunked replay)
    over a recorded log, motion and then fastslam2 with the adaptive stack
    (ICP odometry residuals driving the proposal floors and mode dial)."""
    from fastslam_tpu.app.runner import replay_chunked, run_driver
    from fastslam_tpu.drivers.replay import ReplayDriver, record_log
    from fastslam_tpu.drivers.sim_world import SimWorld

    log = record_log(SimWorld(seed=3), num_ticks=ticks)
    base = FastSLAMConfig(
        num_particles=num_particles, max_landmarks=max_landmarks,
        max_measurements=16, parity_mode=False, use_pallas=True,
        pallas_interpret=interpret,
    )
    runs = {
        "motion": base,
        "fastslam2_adaptive": base.replace(
            proposal_mode="fastslam2", use_icp_proposal=True, icp_blend=0.0,
            adaptive_proposal_floors=True),
    }
    out = {}
    for name, cfg in runs.items():
        t0 = time.perf_counter()
        if chunk:
            hist = replay_chunked(log, cfg, chunk_size=chunk, rng=0)
        else:
            hist = run_driver(ReplayDriver(log), cfg, rng=0)
        m = hist.metrics()
        out[name] = {
            "ate_rmse_m": m["ate_rmse_m"],
            "max_measurements_per_tick": int(max(hist.num_measurements)),
            "seconds": time.perf_counter() - t0,
        }
        if not (np.isfinite(m["ate_rmse_m"])
                and m["ate_rmse_m"] < ATE_BOUND_M):
            raise AssertionError(f"{name}: ATE {m['ate_rmse_m']} m")
        if out[name]["max_measurements_per_tick"] > 16:
            raise AssertionError(f"{name}: more than 16 measurements a tick")
    return out


def backend_vs_cpu(n_landmarks=3000, keyframes=64, iters=4) -> dict:
    """Phase 5: one pose-graph optimize on the default device vs the same
    call on the host CPU device, both at 'highest' matmul precision."""
    from fastslam_tpu.backend.builder import build_pose_graph
    from fastslam_tpu.backend.pose_graph import optimize
    from scripts.bench_backend_1m import survey_world_chunked

    noisy, obs, _gt, _field = survey_world_chunked(n_landmarks, k=keyframes,
                                                   seed=1)
    graph = build_pose_graph(noisy, obs, max_landmarks=2 * n_landmarks,
                             max_factors=4 * n_landmarks)
    opt = jax.jit(optimize, static_argnums=1)
    results = {}
    with jax.default_matmul_precision("highest"):
        for name, dev in (("default", jax.devices()[0]),
                          ("cpu", jax.devices("cpu")[0])):
            g = jax.device_put(graph, dev)
            poses, _lms, err, _ = opt(g, iters)
            results[name] = (np.asarray(poses), float(err))
    (p_d, e_d), (p_c, e_c) = results["default"], results["cpu"]
    out = {"landmarks": int(np.asarray(graph.lm_valid).sum()),
           "error_device": e_d, "error_cpu": e_c,
           "pose_dev_m": float(np.max(np.abs(p_d[:, :2] - p_c[:, :2])))}
    # float32 on both; only summation order and library kernels differ
    if not (abs(e_d - e_c) <= 1e-3 * abs(e_c) + 1e-3
            and out["pose_dev_m"] < 1e-3):
        raise AssertionError(f"backend device vs CPU: {out}")
    return out


def memory(num_particles=100_000, max_landmarks=64, interpret=False) -> dict:
    """Phase 6: compiled memory of the flagship planes step; peak bytes."""
    from fastslam_tpu.core.state import init_planes_state, pad_measurements

    cfg = FastSLAMConfig(num_particles=num_particles,
                         max_landmarks=max_landmarks, max_measurements=16,
                         parity_mode=False, use_pallas=True,
                         pallas_interpret=interpret)
    st = init_planes_state(cfg, rng=0)
    ms = pad_measurements(cfg, [(2.0 + 0.3 * i, -2.5 + 0.35 * i)
                                for i in range(16)])
    step = jax.jit(lambda s, r, t, m: kernels.fastslam_step_planes(
        s, r, t, m, cfg), donate_argnums=0)
    compiled = step.lower(st, jnp.float32(0.0), jnp.float32(0.4), ms).compile()
    ma = compiled.memory_analysis()
    out = {k: int(getattr(ma, k)) for k in (
        "argument_size_in_bytes", "output_size_in_bytes",
        "temp_size_in_bytes", "generated_code_size_in_bytes")
        if ma is not None and hasattr(ma, k)}
    stats = jax.devices()[0].memory_stats() or {}
    out["peak_bytes_in_use"] = int(stats.get("peak_bytes_in_use", -1))
    return out


def multi_device(num_particles=100_000, max_landmarks=64, ticks=3,
                 devices=None, interpret=False) -> dict:
    """``--multi``: the sharded paths on a 1-D particle mesh vs one device
    at the same seed — the GSPMD step (XLA update), the sharded kernel
    step, the GSPMD resampler and the halo ``ppermute`` resampler.

    The steps run with resampling off, so each particle's update is
    compared alone and must agree exactly (landmark counts) or to float
    rounding (pose).  Resampling is compared on its own: the halo
    resampler takes the single-device cumulative sum and must match it bit
    for bit; the GSPMD resampler sums the weights in another order, so an
    ancestor may move along the grid by the float32 summation bound."""
    from fastslam_tpu.core.state import init_planes_state, pad_measurements
    from fastslam_tpu.parallel.mesh import (
        make_mesh, shard_planes_state, shard_state,
    )
    from fastslam_tpu.parallel.resample import halo_systematic_resample
    from fastslam_tpu.parallel.sharded import (
        make_sharded_planes_step, make_sharded_step,
    )

    devices = devices or jax.devices()[:4]
    cfg = FastSLAMConfig(num_particles=num_particles,
                         max_landmarks=max_landmarks, max_measurements=16,
                         parity_mode=False, pallas_interpret=interpret)
    no_resample = cfg.replace(resample_threshold_frac=0.0)
    mesh, mesh1 = make_mesh(cfg, devices=devices), make_mesh(
        cfg, devices=devices[:1])
    ms = pad_measurements(cfg, [(2.0 + 0.3 * i, -2.5 + 0.35 * i)
                                for i in range(16)])
    out = {}

    def run(step, st):
        for _ in range(ticks):
            st, pose = step(st, jnp.float32(0.0), jnp.float32(0.4), ms)
        return jax.device_get(st), np.asarray(pose)

    # GSPMD step (XLA update), and the sharded kernel step
    for name, make, init, shard, c in (
            ("gspmd_xla", make_sharded_step, init_state, shard_state,
             no_resample),
            ("sharded_kernel", make_sharded_planes_step, init_planes_state,
             shard_planes_state, no_resample.replace(use_pallas=True))):
        one = run(make(c, mesh1), shard(init(c, rng=7), mesh1, c))
        many = run(make(c, mesh), shard(init(c, rng=7), mesh, c))
        out[name] = {
            "pose_dev_m": float(np.max(np.abs(one[1] - many[1]))),
            "count_mismatches": int(np.sum(np.asarray(one[0].lm_count)
                                           != np.asarray(many[0].lm_count))),
            "shards": len(devices),
        }

    # the resamplers vs the single-device systematic resampler, forced
    rng = np.random.default_rng(5)
    st = init_state(cfg, rng=3)
    w = rng.uniform(0.5, 1.5, num_particles)
    st = st._replace(
        poses=jnp.asarray(rng.normal(0, 1, (num_particles, 3)), jnp.float32),
        log_weights=jnp.log(jnp.asarray(w / w.sum(), jnp.float32)))
    u0 = jnp.float32(0.3 / num_particles)
    resample_idx = jax.jit(kernels.systematic_resample_indices)
    idx = resample_idx(jnp.exp(st.log_weights), u0)
    want = kernels.resample_state(st, idx, cfg)
    sharded = shard_state(st, mesh, cfg)
    got = halo_systematic_resample(sharded, u0, mesh, cfg)
    out["halo_resample"] = {
        "pose_dev": float(np.max(np.abs(np.asarray(got.poses)
                                        - np.asarray(want.poses)))),
        "shards": len(got.poses.addressable_shards),
    }
    shift = np.abs(np.asarray(resample_idx(jnp.exp(sharded.log_weights), u0))
                   - np.asarray(idx))
    # float32 summation of N weights that sum to 1 is exact to N * 2**-24
    # in any order; the grid has N points per unit of weight
    bound = int(np.ceil(num_particles ** 2 * 2.0 ** -24))
    out["gspmd_resample"] = {"index_mismatches": int(np.sum(shift > 0)),
                             "max_index_shift": int(shift.max()),
                             "bound": bound}
    for name, row in out.items():
        if row.get("count_mismatches") or row.get("pose_dev_m", 0) > 1e-3 \
                or row.get("pose_dev", 0) != 0 \
                or row.get("max_index_shift", 0) > row.get("bound", 0):
            raise AssertionError(f"{name}: sharded vs one device: {row}")
    return out


def _emit(name: str, value) -> None:
    print(f"{name}: {json.dumps(value)}", flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--multi", action="store_true",
                    help="four GPUs: the sharded paths only")
    args = ap.parse_args(argv)
    count = 4 if args.multi else 1
    device = require_gpu(count)
    enable_compile_cache()
    _emit("jax", jax.__version__)
    _emit("device", device)
    for line in nvidia_smi()[:count]:
        print(f"nvidia-smi: {line}", flush=True)
    if args.multi:
        _emit("multi", multi_device())
    else:
        rows = kernel_parity(**FLAGSHIP)
        for row in rows:
            _emit("parity", {**row, "tolerances": TOL})
        check_parity(rows)
        _emit("oracle", oracle_parity())
        _emit("online", online_loop())
        _emit("chunked_replay", online_loop(chunk=16))
        _emit("backend", backend_vs_cpu())
        _emit("memory", memory())
    print(json.dumps({"ok": True, "device": device}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
