"""Command-line interface.

The reference has no CLI — its entry point is a script pasted into the
JdeRobot web UI (``jde_robots_main.py``, README §"FastSLAM 2.0 module") and a
separately-started viewer process.  Here the whole lifecycle is driven from
one binary:

  python -m fastslam_tpu record  --ticks 500 --out runs/log.npz
  python -m fastslam_tpu run     --log runs/log.npz --particles 1000
  python -m fastslam_tpu sim     --ticks 500 --particles 256
  python -m fastslam_tpu viz     --path workspace/shared/fast_slam.json
"""

from __future__ import annotations

import argparse
import json
import sys


def _add_filter_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("--particles", type=int, default=128)
    p.add_argument("--landmarks", type=int, default=32, help="per-particle capacity")
    p.add_argument("--production", action="store_true",
                   help="production math (log-weights, best-match assoc) "
                        "instead of reference-parity quirks")
    p.add_argument("--pallas", action=argparse.BooleanOptionalAction,
                   default=True,
                   help="fused GPU filter kernel (default; with --cpu it runs "
                        "in Pallas interpret mode); --no-pallas runs the XLA "
                        "scan path")
    p.add_argument("--warmup", type=int, default=150, help="dead-reckoning ticks")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--cpu", action="store_true",
                   help="force the CPU platform (the GPU kernel then runs in "
                        "interpret mode)")


def _make_config(args):
    from fastslam_tpu.config import FastSLAMConfig

    return FastSLAMConfig(
        num_particles=args.particles,
        max_landmarks=args.landmarks,
        parity_mode=not args.production,
        use_pallas=args.pallas,
        pallas_interpret=args.cpu,
        warmup_iterations=args.warmup,
    )


def _force_cpu_if(flag: bool):
    if flag:
        import jax

        jax.config.update("jax_platforms", "cpu")


def cmd_record(args) -> int:
    _force_cpu_if(args.cpu)
    from fastslam_tpu.drivers.replay import record_log
    from fastslam_tpu.drivers.sim_world import SimWorld

    world = SimWorld(seed=args.seed, range_noise_std=args.range_noise)
    log = record_log(world, num_ticks=args.ticks)
    log.save(args.out)
    print(json.dumps({"ticks": len(log), "out": args.out}))
    return 0


def cmd_run(args) -> int:
    _force_cpu_if(args.cpu)
    from fastslam_tpu.app.runner import replay_chunked, run_driver
    from fastslam_tpu.drivers.replay import LaserLog, ReplayDriver

    log = LaserLog.load(args.log)
    cfg = _make_config(args)
    if args.chunk:
        # batch-replay engine: N ticks per fused kernel launch, resampling
        # at chunk boundaries (a small ATE cost — EVAL.md)
        cfg = cfg.replace(parity_mode=False, use_pallas=True)
        hist = replay_chunked(log, cfg, chunk_size=args.chunk, rng=args.seed)
    else:
        hist = run_driver(ReplayDriver(log), cfg, rng=args.seed)
    metrics = hist.metrics(skip=args.skip_ticks)
    if args.plot:
        import matplotlib

        matplotlib.use("Agg")
        from fastslam_tpu.viz.map_plot import plot_trajectory

        fig, _ = plot_trajectory(hist)
        fig.savefig(args.plot, dpi=120)
        metrics["plot"] = args.plot
    print(json.dumps(metrics))
    return 0


def cmd_sim(args) -> int:
    _force_cpu_if(args.cpu)
    from fastslam_tpu.app.runner import run_driver
    from fastslam_tpu.drivers.sim_world import SimWorld

    world = SimWorld(seed=args.seed, range_noise_std=args.range_noise)
    cfg = _make_config(args)
    hist = run_driver(world, cfg, max_ticks=args.ticks, rng=args.seed)
    print(json.dumps(hist.metrics()))
    return 0


def cmd_viz(args) -> int:
    from fastslam_tpu.viz.map_plot import watch

    watch(args.path, interval=args.interval)
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="fastslam_tpu")
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("record", help="record a synthetic-world laser log")
    p.add_argument("--ticks", type=int, default=500)
    p.add_argument("--out", default="runs/log.npz")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--range-noise", type=float, default=0.0)
    p.add_argument("--cpu", action="store_true", help="force CPU platform")
    p.set_defaults(fn=cmd_record)

    p = sub.add_parser("run", help="run SLAM on a replay log, print metrics")
    p.add_argument("--log", required=True)
    p.add_argument("--plot", default=None, help="write trajectory plot PNG")
    p.add_argument("--chunk", type=int, default=0,
                   help="batch replay: ticks per fused kernel launch "
                        "(implies --production; 0 = per-tick online loop)")
    p.add_argument("--skip-ticks", type=int, default=0,
                   help="skip first N ticks in metrics")
    _add_filter_args(p)
    p.set_defaults(fn=cmd_run)

    p = sub.add_parser("sim", help="run SLAM live against the synthetic world")
    p.add_argument("--ticks", type=int, default=500)
    p.add_argument("--range-noise", type=float, default=0.0)
    _add_filter_args(p)
    p.set_defaults(fn=cmd_sim)

    p = sub.add_parser("viz", help="watch the shared JSON snapshot (viewer)")
    p.add_argument("--path", default="workspace/shared/fast_slam.json")
    p.add_argument("--interval", type=float, default=0.5)
    p.set_defaults(fn=cmd_viz)

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
