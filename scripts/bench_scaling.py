"""Weak-scaling benchmark: frames/s efficiency vs device count.

Runs the sharded filter step with a FIXED number of particles per device
(weak scaling) at 1, 2, 4, ... N devices and reports steps/s plus the
efficiency vs the single-device rate — the north star asks for >=80% at 2+
hosts.  On real GPUs run under the default environment; under
`--virtual N` it uses N virtual CPU devices (validates the sharding and
collective structure, not real interconnect bandwidth).

Usage:
  python scripts/bench_scaling.py --per-device 12500 --steps 20
  python scripts/bench_scaling.py --virtual 8 --per-device 2048
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--per-device", type=int, default=12_500)
    ap.add_argument("--landmarks", type=int, default=64)
    ap.add_argument("--measurements", type=int, default=16)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--virtual", type=int, default=0,
                    help="use N virtual CPU devices")
    args = ap.parse_args()

    if args.virtual:
        os.environ["XLA_FLAGS"] = (
            os.environ.get("XLA_FLAGS", "")
            + f" --xla_force_host_platform_device_count={args.virtual}"
        ).strip()

    import jax

    if args.virtual:
        jax.config.update("jax_platforms", "cpu")

    import jax.numpy as jnp

    from fastslam_tpu.config import FastSLAMConfig
    from fastslam_tpu.core.state import init_state, pad_measurements
    from fastslam_tpu.parallel.mesh import make_mesh, shard_state
    from fastslam_tpu.parallel.sharded import make_sharded_step

    all_devices = jax.devices()
    counts = []
    n = 1
    while n <= len(all_devices):
        counts.append(n)
        n *= 2

    results = []
    base_rate = None
    for ndev in counts:
        cfg = FastSLAMConfig(
            num_particles=args.per_device * ndev,
            max_landmarks=args.landmarks,
            max_measurements=args.measurements,
        )
        mesh = make_mesh(cfg, devices=all_devices[:ndev])
        step = make_sharded_step(cfg, mesh)
        state = shard_state(init_state(cfg, rng=0), mesh, cfg)
        ms = pad_measurements(
            cfg, [(2.0 + 0.3 * i, -2.5 + 0.35 * i) for i in range(args.measurements)]
        )
        for _ in range(3):
            state, pose = step(state, jnp.float32(0.0), jnp.float32(0.4), ms)
        jax.block_until_ready(state)
        t0 = time.perf_counter()
        for _ in range(args.steps):
            state, pose = step(state, jnp.float32(0.0), jnp.float32(0.4), ms)
        jax.block_until_ready(state)
        dt = (time.perf_counter() - t0) / args.steps
        rate = 1.0 / dt
        if base_rate is None:
            base_rate = rate
        eff = rate / base_rate
        results.append({
            "devices": ndev,
            "particles": cfg.num_particles,
            "step_ms": round(dt * 1e3, 3),
            "frames_per_s": round(rate, 2),
            "weak_scaling_efficiency": round(eff, 3),
            "updates_per_s": round(cfg.num_particles * args.measurements * rate),
        })
        print(json.dumps(results[-1]))

    print(json.dumps({"scaling": results}))


if __name__ == "__main__":
    main()
