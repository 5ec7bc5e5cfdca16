"""Per-tick time of the filter step on one NVIDIA GPU: XLA vs the kernel.

  python scripts/time_filter_step.py            # the shipped tile settings
  python scripts/time_filter_step.py --sweep    # + every tile x warps pair

At P=100,000 particles, L=64 landmark slots and M=16 valid measurements
every tick, for the motion and FastSLAM 2.0 proposals, each of

  xla    the blocks step (``kernels.fastslam_step``, the ``lax.scan`` update)
  tick   the fused kernel, one tick per launch (``fastslam_step_planes``)
  chunk  the fused kernel, 16 ticks per launch
         (``fastslam_steps_planes_chunked``)

runs ``--ticks`` ticks inside one jitted ``lax.scan`` that ends in
``block_until_ready``; after a compile-and-warm call, three timed calls give
the median.  One JSON line per case; the first line is the card's name and
power limit.
"""

from __future__ import annotations

import argparse
import functools
import json
import os
import statistics
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from fastslam_tpu.config import FastSLAMConfig  # noqa: E402
from fastslam_tpu.core import kernels, pallas_kernels  # noqa: E402
from fastslam_tpu.core.state import (  # noqa: E402
    Measurements, init_planes_state, init_state, pad_measurements,
)
from fastslam_tpu.utils.compile_cache import enable_compile_cache  # noqa: E402
from fastslam_tpu.utils.device import nvidia_smi, require_gpu  # noqa: E402

P, L, M, CHUNK = 100_000, 64, 16, 16


def time_case(proposal: str, mode: str, ticks: int, tile=None) -> dict:
    cfg = FastSLAMConfig(num_particles=P, max_landmarks=L, max_measurements=M,
                         parity_mode=False, proposal_mode=proposal,
                         use_pallas=mode != "xla")
    ms = pad_measurements(cfg, [(2.0 + 0.3 * i, -2.5 + 0.35 * i)
                                for i in range(M)])
    rot, tr = jnp.float32(0.0), jnp.float32(0.4)
    if mode == "chunk":
        ticks = ticks // CHUNK * CHUNK
        n = ticks // CHUNK
        msc = Measurements(jnp.tile(ms.range_bearing[None], (CHUNK, 1, 1)),
                           jnp.tile(ms.valid[None], (CHUNK, 1)))
        rots, trs = jnp.zeros(CHUNK), jnp.full(CHUNK, 0.4)
        body = lambda s, _: (kernels.fastslam_steps_planes_chunked(
            s, rots, trs, msc, cfg, tile=tile)[0], None)
        state = init_planes_state(cfg, rng=0)
    else:
        n = ticks
        step = (kernels.fastslam_step if mode == "xla" else functools.partial(
            kernels.fastslam_step_planes, tile=tile))
        body = lambda s, _: (step(s, rot, tr, ms, cfg)[0], None)
        state = (init_state if mode == "xla" else init_planes_state)(cfg, rng=0)
    run = jax.jit(lambda s: jax.lax.scan(body, s, None, length=n)[0],
                  donate_argnums=0)
    t0 = time.perf_counter()
    state = jax.block_until_ready(run(state))
    compile_s = time.perf_counter() - t0
    reps = []
    for _ in range(3):
        t0 = time.perf_counter()
        state = jax.block_until_ready(run(state))
        reps.append((time.perf_counter() - t0) * 1e3 / ticks)
    return {"proposal": proposal, "mode": mode,
            "ms_per_tick": statistics.median(reps), "reps": reps,
            "compile_and_first_s": compile_s,
            "landmarks": int(jnp.sum(state.lm_count))}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ticks", type=int, default=256)
    ap.add_argument("--sweep", action="store_true",
                    help="also time the kernel at every particle tile in "
                         "{16, 32, 64} x warps in {2, 4, 8}")
    args = ap.parse_args(argv)
    device = require_gpu()
    enable_compile_cache()
    print(json.dumps({"device": device, "card": nvidia_smi()[0]}), flush=True)
    for proposal in ("motion", "fastslam2"):
        print(json.dumps(time_case(proposal, "xla", args.ticks)), flush=True)
        tiles = ([(b, w) for b in (16, 32, 64) for w in (2, 4, 8)]
                 if args.sweep else
                 [(pallas_kernels.BLOCK[proposal], pallas_kernels.NUM_WARPS)])
        for tile in tiles:
            for mode in ("tick", "chunk"):
                row = time_case(proposal, mode, args.ticks, tile)
                print(json.dumps({**row, "block": tile[0], "warps": tile[1]}),
                      flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
