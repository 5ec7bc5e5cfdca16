"""chip_smoke.py's phases at a tiny size on the CPU, the device checks of
the GPU entry points, and the full-width kernel parity on the card (``gpu``
marker: skips without a GPU)."""

import jax
import numpy as np
import pytest

import chip_smoke


@pytest.mark.parametrize("map_name", ["log", "full"])
def test_kernel_parity_phase_tiny(map_name):
    """Phase 2 at a tiny width, the kernel interpreted: four cases (two
    proposals x 1 and C ticks per launch), every one within tolerance.  The
    full map holds all L landmarks in every particle, and the compared
    ticks still update some of them."""
    rows = chip_smoke.kernel_parity(num_particles=48, max_landmarks=32,
                                    max_measurements=16, chunk=4,
                                    warm_ticks=8, interpret=True,
                                    maps=(map_name,))
    assert [(r["proposal"], r["ticks_per_launch"]) for r in rows] == [
        ("motion", 1), ("motion", 4), ("fastslam2", 1), ("fastslam2", 4)]
    assert all(r["landmarks"] > 0 and r["landmarks_moved"] > 0 for r in rows)
    if map_name == "full":
        assert all(r["landmarks"] == 48 * 32 for r in rows)
        assert all(r["valid_measurements"] == 16 * r["ticks_per_launch"]
                   for r in rows)
    chip_smoke.check_parity(rows)
    bad = dict(rows[0], count_mismatches=1)
    with pytest.raises(AssertionError, match="parity failed"):
        chip_smoke.check_parity([bad])


def test_oracle_parity_phase_tiny():
    """Phase 2b: parity mode through the interpreted kernel vs the NumPy
    oracle — the landmark counts exact, the pose estimate within 1e-4 m."""
    out = chip_smoke.oracle_parity(num_particles=16, interpret=True)
    assert out["count_mismatches"] == 0 and out["ticks"] == 5


@pytest.mark.parametrize("chunk", [None, 16])
def test_online_and_chunked_phases_tiny(chunk):
    out = chip_smoke.online_loop(num_particles=32, max_landmarks=16,
                                 ticks=24, interpret=True, chunk=chunk)
    assert set(out) == {"motion", "fastslam2_adaptive"}
    for row in out.values():
        assert np.isfinite(row["ate_rmse_m"])
        assert row["max_measurements_per_tick"] <= 16


def test_memory_phase_tiny():
    out = chip_smoke.memory(num_particles=32, max_landmarks=16,
                            interpret=True)
    assert out["argument_size_in_bytes"] > 0


def test_backend_phase_tiny():
    out = chip_smoke.backend_vs_cpu(n_landmarks=200, keyframes=16, iters=2)
    assert out["landmarks"] > 0 and out["pose_dev_m"] < 1e-3


def test_multi_phase_on_four_virtual_devices():
    """``--multi`` on four virtual CPU devices: the GSPMD step, the sharded
    kernel step and both resamplers agree with one device."""
    out = chip_smoke.multi_device(num_particles=64, max_landmarks=8,
                                  ticks=2, devices=jax.devices()[:4],
                                  interpret=True)
    assert out["gspmd_xla"]["shards"] == 4
    assert out["sharded_kernel"]["count_mismatches"] == 0
    assert out["halo_resample"]["pose_dev"] == 0.0
    assert out["gspmd_resample"]["max_index_shift"] <= 1


@pytest.mark.parametrize("entry", ["chip_smoke", "bench", "time_filter_step",
                                   "require_gpu"])
def test_gpu_entry_points_refuse_a_cpu(entry):
    """No measurement path falls back to the CPU: each stops with a message
    naming the missing GPU, before printing any result."""
    from fastslam_tpu.utils.device import require_gpu

    if entry == "chip_smoke":
        run = lambda: chip_smoke.main([])
    elif entry == "bench":
        import bench

        run = bench.main
    elif entry == "time_filter_step":
        from scripts import time_filter_step

        run = lambda: time_filter_step.main([])
    else:
        run = require_gpu
    with pytest.raises(SystemExit, match="GPU"):
        run()


@pytest.mark.gpu
def test_kernel_matches_xla_at_full_width_on_gpu(gpu):
    """The compiled kernel vs the XLA path at P=100k, L=64, M=16 (phase 2
    of chip_smoke.py, which runs it on every chip check)."""
    rows = chip_smoke.kernel_parity(**chip_smoke.FLAGSHIP)
    chip_smoke.check_parity(rows)
