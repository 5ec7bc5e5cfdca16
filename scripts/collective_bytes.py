"""Measure per-step collective traffic of the sharded filter step from HLO.

Compiles the sharded step on a virtual 8-device mesh with the GSPMD
resampler vs the halo-exchange resampler and sums the bytes produced by
every collective op (all-gather / all-reduce / collective-permute /
all-to-all) in the compiled module.  This is the communication STRUCTURE
— exact op set and sizes XLA will issue on real devices for this program
(link bandwidth obviously differs on CPU).

The fused GPU kernel is shard-local, so the collective set is identical
with or without it; this runs the pure-XLA path so it compiles on CPU.  Resample collectives sit inside the Neff conditional — they are
counted (the compiled module contains both branches) and reported
separately as worst-case per-tick bytes.

Usage: python scripts/collective_bytes.py [--devices 8] [--per-device 8192]
Prints one JSON line and appends nothing anywhere.
"""

import argparse
import json
import os
import re
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

DTYPE_BYTES = {"f64": 8, "f32": 4, "bf16": 2, "f16": 2, "s64": 8, "u64": 8,
               "s32": 4, "u32": 4, "s16": 2, "u16": 2, "s8": 1, "u8": 1,
               "pred": 1}

COLLECTIVES = ("all-gather", "all-reduce", "collective-permute", "all-to-all")

_SHAPE_RE = re.compile(r"(f64|f32|bf16|f16|s64|u64|s32|u32|s16|u16|s8|u8|pred)"
                       r"\[([0-9,]*)\]")


def shape_bytes(text: str) -> int:
    """Sum bytes over every dtype[shape] token in an HLO result type
    (handles tuples)."""
    total = 0
    for dt, dims in _SHAPE_RE.findall(text):
        n = 1
        for d in dims.split(","):
            if d:
                n *= int(d)
        total += n * DTYPE_BYTES[dt]
    return total


def collect(hlo: str):
    ops = []
    for line in hlo.splitlines():
        m = re.match(r"\s*(%?[\w.\-]+)\s*=\s*(.+)$", line)
        if not m:
            continue
        rhs = m.group(2)
        for c in COLLECTIVES:
            # match the op invocation, not substrings of metadata
            if re.search(rf"\b{c}(-start)?\(", rhs):
                # result type = everything before the op name
                rtype = rhs.split(c)[0]
                ops.append({"op": c, "bytes": shape_bytes(rtype),
                            "result": rtype.strip()[:60]})
                break
    return ops


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--devices", type=int, default=8)
    ap.add_argument("--per-device", type=int, default=8192)
    ap.add_argument("--landmarks", type=int, default=64)
    ap.add_argument("--measurements", type=int, default=16)
    args = ap.parse_args()

    os.environ["XLA_FLAGS"] = (
        os.environ.get("XLA_FLAGS", "")
        + f" --xla_force_host_platform_device_count={args.devices}"
    ).strip()

    import jax

    jax.config.update("jax_platforms", "cpu")

    import jax.numpy as jnp

    from fastslam_tpu.config import FastSLAMConfig
    from fastslam_tpu.core.state import init_state, pad_measurements
    from fastslam_tpu.parallel.mesh import make_mesh, shard_state
    from fastslam_tpu.parallel.sharded import make_sharded_step

    out = {"devices": args.devices,
           "particles": args.per_device * args.devices,
           "landmarks": args.landmarks}
    for name, dist in (("gspmd_resample", False), ("halo_resample", True)):
        cfg = FastSLAMConfig(
            num_particles=args.per_device * args.devices,
            max_landmarks=args.landmarks,
            max_measurements=args.measurements,
            distributed_resample=dist,
            parity_mode=False,
        )
        mesh = make_mesh(cfg)
        step = make_sharded_step(cfg, mesh)
        state = shard_state(init_state(cfg, rng=0), mesh, cfg)
        ms = pad_measurements(cfg, [(2.0, 0.3), (3.5, -0.7)])
        lowered = jax.jit(step).lower(
            state, jnp.float32(0.0), jnp.float32(0.4), ms
        )
        hlo = lowered.compile().as_text()
        ops = collect(hlo)
        scalar = [o for o in ops if o["bytes"] <= 256]
        bulk = [o for o in ops if o["bytes"] > 256]
        out[name] = {
            "collective_ops": len(ops),
            "scalar_ops": len(scalar),
            "scalar_bytes": sum(o["bytes"] for o in scalar),
            "bulk_ops": [
                {"op": o["op"], "mbytes": round(o["bytes"] / 2**20, 3)}
                for o in bulk
            ],
            "bulk_bytes_total_mb": round(
                sum(o["bytes"] for o in bulk) / 2**20, 3),
        }
    print(json.dumps(out, indent=1))


if __name__ == "__main__":
    main()
