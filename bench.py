"""Headline benchmark: particle updates/s at 100k particles on one GPU.

One "particle update" = one particle x one measurement through association +
landmark-EKF + weighting (the reference's ``__update_particle``,
``fast_slam_2.py:89-159`` — its hot inner kernel, SURVEY.md §3.6).  Three
cells at P=100,000 particles, L=64 landmark slots, M=16 measurements per
tick:

* motion replay: the chunked planes engine (16 ticks per fused kernel
  launch, normalization/Neff/resampling at chunk boundaries), motion-model
  proposal;
* fs2 replay: the same with the FastSLAM 2.0 proposal;
* e2e: the online production tick including the perception frontend, over
  192 recorded simulator scans.

``vs_baseline`` divides by the throughput of the NumPy oracle that
transcribes the reference's exact equations (tests/oracle/numpy_oracle.py),
measured in the same run on the host CPU.

The bench refuses to run without a GPU.  Prints exactly one JSON line, which
names the device and the card's power limit.
"""

import json
import os
import sys
import time

import numpy as np

P, L, M = 100_000, 64, 16


def _timed_best(fn, sync, *, reps: int, budget_s: float) -> float:
    """Best-of-N wall time of ``fn`` (sync'd via ``sync``), stopping early
    when the time budget runs out."""
    best = float("inf")
    t_start = time.perf_counter()
    for rep in range(reps):
        t0 = time.perf_counter()
        sync(fn())
        best = min(best, time.perf_counter() - t0)
        if rep >= 2 and time.perf_counter() - t_start > budget_s:
            break
    return best


def _run_scan(multi, state, xs=None, reps=8, budget_s=60.0):
    """Compile and warm ``multi`` (a jitted lax.scan that donates its
    state), then time repeated calls; returns the best wall time."""
    import jax

    args = () if xs is None else (xs,)
    state, est = multi(state, *args)
    jax.block_until_ready((state, est))
    holder = {"s": state}

    def run():
        s, e = multi(holder["s"], *args)
        holder["s"] = s  # donated input — rebind for the next repetition
        return s, e

    return _timed_best(run, jax.block_until_ready, reps=reps,
                       budget_s=budget_s)


def bench_replay(num_steps: int = 768, chunk: int = 16,
                 proposal: str = "motion"):
    """``num_steps`` filter ticks inside ONE jit via ``lax.scan`` over
    chunks of ``chunk`` ticks, each chunk one fused kernel launch.
    Returns (particle updates/s, seconds per tick)."""
    import jax
    import jax.numpy as jnp

    from fastslam_tpu.config import FastSLAMConfig
    from fastslam_tpu.core.kernels import fastslam_steps_planes_chunked
    from fastslam_tpu.core.state import (
        Measurements, init_planes_state, pad_measurements,
    )

    config = FastSLAMConfig(
        num_particles=P, max_landmarks=L, max_measurements=M,
        parity_mode=False, use_pallas=True, proposal_mode=proposal,
    )
    ms = pad_measurements(config, [(2.0 + 0.3 * i, -2.5 + 0.35 * i)
                                   for i in range(M)])
    n_chunks = num_steps // chunk
    num_steps = n_chunks * chunk
    rots = jnp.zeros(chunk, jnp.float32)
    trans = jnp.full(chunk, 0.4, jnp.float32)
    ms_c = Measurements(jnp.tile(ms.range_bearing[None], (chunk, 1, 1)),
                        jnp.tile(ms.valid[None], (chunk, 1)))

    def body(s, _):
        s, est = fastslam_steps_planes_chunked(s, rots, trans, ms_c, config)
        return s, est[-1]

    multi = jax.jit(
        lambda s: jax.lax.scan(body, s, None, length=n_chunks),
        donate_argnums=0,
    )
    best = _run_scan(multi, init_planes_state(config, rng=0))
    updates = config.num_particles * config.max_measurements * num_steps
    return updates / best, best / num_steps


def bench_e2e(num_steps: int = 192):
    """Online frames/s including the perception frontend: the production
    tick (scan -> line filter -> Hough -> clustering -> measurements ->
    filter step) scanned over ``num_steps`` recorded simulator scans inside
    one jit.  Constant inputs would let XLA hoist the loop-invariant
    frontend out of the scan, so the xs are distinct scans."""
    import jax
    import jax.numpy as jnp

    from fastslam_tpu.config import FastSLAMConfig
    from fastslam_tpu.core import kernels
    from fastslam_tpu.core.state import init_planes_state
    from fastslam_tpu.drivers.replay import record_log
    from fastslam_tpu.drivers.sim_world import SimWorld
    from fastslam_tpu.frontend.pipeline import scan_to_measurements

    config = FastSLAMConfig(
        num_particles=P, max_landmarks=L, max_measurements=M,
        use_pallas=True, parity_mode=False,
    )
    log = record_log(SimWorld(seed=2), num_ticks=num_steps)
    values = np.asarray(log.scans, np.float32)
    nb = values.shape[1]
    angles = np.radians(np.arange(nb) - nb // 2).astype(np.float32)
    valid = (values >= log.min_range) & (values <= log.max_range)
    pts = np.stack([values * np.cos(angles), values * np.sin(angles)],
                   axis=-1)
    pts[~valid] = 0.0
    rots = np.where(np.asarray(log.cmd_v) != 0, 0.0,
                    np.asarray(log.cmd_w) * 0.05).astype(np.float32)
    trs = np.where(np.asarray(log.cmd_v) != 0,
                   np.asarray(log.cmd_v) * 0.05 * config.velocity_fudge,
                   0.0).astype(np.float32)
    xs = (jnp.asarray(pts), jnp.asarray(valid),
          jnp.asarray(rots), jnp.asarray(trs))

    def body(s, inp):
        p, v, rot, tr = inp
        ms = scan_to_measurements(p, v, config)
        return kernels.fastslam_step_planes(s, rot, tr, ms, config)

    multi = jax.jit(lambda s, x: jax.lax.scan(body, s, x), donate_argnums=0)
    best = _run_scan(multi, init_planes_state(config, rng=0), xs, reps=8,
                     budget_s=45.0)
    return num_steps / best


def bench_oracle_baseline(num_ticks: int = 2, num_particles: int = 100):
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), "tests"))
    from oracle import numpy_oracle as oracle

    rng = np.random.default_rng(0)
    parts = oracle.make_particles(num_particles)
    ms = [(2.0 + 0.3 * i, -2.5 + 0.35 * i) for i in range(16)]
    # seed maps once so ticks measure the update path, not first-append
    oracle.iterate(parts, 0.0, 0.4, ms,
                   rng.normal(0, 0.001, num_particles),
                   rng.normal(0, 0.0055, num_particles),
                   0.01)
    t0 = time.perf_counter()
    for _ in range(num_ticks):
        oracle.iterate(parts, 0.0, 0.4, ms,
                       rng.normal(0, 0.001, num_particles),
                       rng.normal(0, 0.0055, num_particles),
                       0.01)
    dt = time.perf_counter() - t0
    updates = num_particles * len(ms) * num_ticks
    return updates / dt


def main():
    from fastslam_tpu.utils.compile_cache import enable_compile_cache
    from fastslam_tpu.utils.device import nvidia_smi, require_gpu

    device = require_gpu()
    enable_compile_cache()
    card = nvidia_smi()[0]
    ups, step_s = bench_replay()
    fs2_ups, fs2_step_s = bench_replay(proposal="fastslam2")
    e2e_fps = bench_e2e()
    base_ups = bench_oracle_baseline()
    print(json.dumps({
        "metric": "particle updates/s at 100k particles",
        "value": round(ups),
        "unit": "updates/s",
        "vs_baseline": round(ups / base_ups, 1),
        "step_seconds": round(step_s, 6),
        # FastSLAM 2.0 proposal mode, same geometry
        "fs2_step_seconds": round(fs2_step_s, 6),
        "fs2_updates_per_s": round(fs2_ups),
        # online loop including the perception frontend
        "e2e_frames_per_s": round(e2e_fps, 1),
        # the reference algorithm (NumPy oracle) on this host's CPU
        "baseline_updates_per_s": round(base_ups),
        "device": device,
        # nvidia-smi name, power.limit
        "card": card,
    }))


if __name__ == "__main__":
    main()
