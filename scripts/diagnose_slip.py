"""Per-tick forensics for the fs2+adaptive wheel-slip rows.

Round-4 verdict (Weak #4): fs2+adaptive slip seed 3 reads ~4x its seed-7/21
siblings (0.122 vs 0.036/0.029 at N=100 CPU; same signature at N=100k on the kernel engine),
while still beating motion-only (0.197).  Reproducible across engines, so
the cause is the estimator/world interaction, not scale.  This script
replays one (seed, slip) cell with the adaptive stack's internals logged
every tick — floors, dial, blend, ICP-vs-command residuals, the TRUE
command error derived from ground truth, and the pose error — and writes
``eval_results/slip_diag_seed<seed>.json`` plus a phase summary to stdout.

The true per-tick command error is computable here because the replay log
carries ground truth: the actual motion over (t-1, t] in the robot frame
vs the (slip-corrupted) commanded odometry the filter received.

Usage:
  python scripts/diagnose_slip.py --seed 3 [--seed 7] [--particles 100]
"""

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np

RESULTS = os.path.join(os.path.dirname(__file__), "..", "eval_results")

SLIP = (0.02, 0.02)


def run_instrumented(seed, particles=100, ticks=300, rng=0,
                     odometry_noise=SLIP, overrides=None,
                     range_noise_std=0.005):
    """run_driver's replay loop with per-tick adaptive internals recorded."""
    from fastslam_tpu.app.runner import SLAMRunner
    from fastslam_tpu.config import FastSLAMConfig
    from fastslam_tpu.drivers.replay import ReplayDriver

    sys.path.insert(0, os.path.dirname(__file__))
    from eval_suite import make_log

    log, gt = make_log(seed, ticks, range_noise_std=range_noise_std)
    config = FastSLAMConfig(
        num_particles=particles, max_landmarks=64, warmup_iterations=150,
        parity_mode=False, proposal_mode="fastslam2", use_icp_proposal=True,
        adaptive_proposal_floors=True, **(overrides or {}),
    )
    driver = ReplayDriver(log)
    runner = SLAMRunner(config, rng)
    odo_rng = np.random.default_rng(123)

    p0 = driver.get_pose()
    off = np.array([p0.x, p0.y, p0.yaw])
    c0, s0 = np.cos(-off[2]), np.sin(-off[2])

    rec = {k: [] for k in (
        "tick", "type", "cmd_rot", "cmd_trans", "true_rot", "true_trans",
        "cmd_err_rot", "cmd_err_trans", "icp_ang", "icp_tx", "icp_ty",
        "sr_th", "sr_al", "lat", "floor_xy", "floor_th", "blend_xy",
        "blend_th", "bias_th", "dial", "est_err", "n_meas")}

    prev_gt = None
    prev_cmd = (0.0, 0.0)
    t = 0
    running = True
    est_poses, gts = [], []
    while running and t < ticks:
        scan = driver.get_laser()
        points, valid = scan.to_points()
        cur_cmd = driver.commanded_velocity()
        v, w = prev_cmd
        prev_cmd = cur_cmd
        rotation, translation = runner.odometry(v, w, scan.timestamp)
        if odometry_noise != (0.0, 0.0):
            if rotation != 0.0:
                rotation += odo_rng.normal(0.0, odometry_noise[0])
            if translation != 0.0:
                translation += odo_rng.normal(0.0, odometry_noise[1])

        if runner._fused is not None:
            est = runner.tick_fused(points, valid, rotation, translation, v)
        else:
            rot_u, trans_u = runner.icp_refine(
                points, valid, rotation, translation, v)
            est = runner.tick(points, valid, rot_u, trans_u)

        gp = driver.get_pose()
        dxy = np.array([gp.x, gp.y]) - off[:2]
        g = np.array([c0 * dxy[0] - s0 * dxy[1],
                      s0 * dxy[0] + c0 * dxy[1],
                      (gp.yaw - off[2] + np.pi) % (2 * np.pi) - np.pi])

        # true motion over (t-1, t] in the reference's rotation-XOR-
        # translation convention (robot frame)
        if prev_gt is not None:
            true_rot = (g[2] - prev_gt[2] + np.pi) % (2 * np.pi) - np.pi
            true_trans = float(np.hypot(*(g[:2] - prev_gt[:2])))
        else:
            true_rot, true_trans = 0.0, 0.0
        prev_gt = g

        k = int(v != 0)
        se2 = getattr(runner, "_prev_se2", (0.0, 0.0, 0.0))
        rec["tick"].append(t)
        rec["type"].append(k)
        rec["cmd_rot"].append(float(rotation))
        rec["cmd_trans"].append(float(translation))
        rec["true_rot"].append(float(true_rot))
        rec["true_trans"].append(float(true_trans))
        rec["cmd_err_rot"].append(float(rotation - true_rot))
        rec["cmd_err_trans"].append(float(translation - true_trans)
                                    if translation != 0.0 else 0.0)
        rec["icp_ang"].append(float(se2[0]))
        rec["icp_tx"].append(float(se2[1]))
        rec["icp_ty"].append(float(se2[2]))
        # signed residuals the estimator saw this tick (match convention of
        # adaptive.se2_residuals)
        rec["sr_th"].append(float(((-se2[0] - rotation) + np.pi)
                                  % (2 * np.pi) - np.pi))
        rec["sr_al"].append(float(-(se2[1] + translation)))
        rec["lat"].append(float(se2[2]))
        rec["floor_xy"].append(float(runner._floor_xy))
        rec["floor_th"].append(float(runner._floor_th))
        rec["blend_xy"].append(float(runner._blend_xy))
        rec["blend_th"].append(float(getattr(runner, "_blend_th", 0.0)))
        rec["bias_th"].append(float(getattr(runner, "_bias_th", 0.0)))
        rec["dial"].append(float(runner._dial))
        err = float(np.hypot(*(np.asarray(est[:2]) - g[:2])))
        rec["est_err"].append(err)
        rec["n_meas"].append(int(runner._last_num_measurements))
        est_poses.append(np.asarray(est, float).copy())
        gts.append(g.copy())

        running = driver.step()
        t += 1

    from fastslam_tpu.eval.metrics import ate_rmse

    est_poses = np.asarray(est_poses)
    gts = np.asarray(gts)
    rec["ate"] = ate_rmse(gts[:, :2], est_poses[:, :2])
    return rec


def summarize(rec, label, window=25):
    """Phase summary: where does the error accumulate, and what were the
    estimator's knobs doing there?"""
    e = np.asarray(rec["est_err"])
    ticks = np.asarray(rec["tick"])
    print(f"\n=== {label}: ATE {rec['ate']:.4f} ===")
    print(f"{'tick':>9} {'err':>7} {'floorXY':>8} {'floorTH':>8} "
          f"{'blend':>6} {'dial':>5} {'|cmdErrT|':>9} {'|cmdErrR|':>9} "
          f"{'|sr_al|':>8} {'rotTicks':>8}")
    for lo in range(0, len(e), window):
        hi = min(lo + window, len(e))
        sl = slice(lo, hi)
        ktype = np.asarray(rec["type"][sl.start:sl.stop])
        print(f"{ticks[lo]:>4}-{ticks[hi-1]:<4} "
              f"{e[sl].mean():7.3f} "
              f"{np.mean(rec['floor_xy'][lo:hi]):8.4f} "
              f"{np.mean(rec['floor_th'][lo:hi]):8.4f} "
              f"{np.mean(rec['blend_xy'][lo:hi]):6.2f} "
              f"{np.mean(rec['dial'][lo:hi]):5.2f} "
              f"{np.mean(np.abs(rec['cmd_err_trans'][lo:hi])):9.4f} "
              f"{np.mean(np.abs(rec['cmd_err_rot'][lo:hi])):9.4f} "
              f"{np.mean(np.abs(rec['sr_al'][lo:hi])):8.4f} "
              f"{int((ktype == 0).sum()):>8}")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--seed", type=int, action="append", default=None)
    ap.add_argument("--particles", type=int, default=100)
    ap.add_argument("--ticks", type=int, default=300)
    ap.add_argument("--clean", action="store_true",
                    help="no slip (baseline internals)")
    ap.add_argument("--range-noise", type=float, default=0.005,
                    help="laser range noise std (the noise-table rows "
                    "use 0.01/0.03)")
    args = ap.parse_args()
    seeds = args.seed or [3, 7]

    import jax

    jax.config.update("jax_platforms", "cpu")

    noise = (0.0, 0.0) if args.clean else SLIP
    os.makedirs(RESULTS, exist_ok=True)
    for seed in seeds:
        rec = run_instrumented(seed, particles=args.particles,
                               ticks=args.ticks, odometry_noise=noise,
                               range_noise_std=args.range_noise)
        tag = "clean" if args.clean else "slip"
        if args.range_noise != 0.005:
            tag += f"_rn{args.range_noise}"
        path = os.path.join(RESULTS, f"slip_diag_seed{seed}_{tag}.json")
        with open(path, "w") as f:
            json.dump({k: (v if np.isscalar(v) else list(map(float, v)))
                       if k != "type" else list(map(int, v))
                       for k, v in rec.items()}, f)
        summarize(rec, f"seed {seed} {tag} N={args.particles}")


if __name__ == "__main__":
    main()
