"""Configuration for the FastSLAM 2.0 engine.

The reference keeps six module-level constants in ``fast_slam_2/config.py:7-21``
plus a scattering of hard-coded magic numbers (Hough scale/padding/threshold at
``hough_transformation.py:10-11,24``, DBSCAN eps/min-samples at
``landmark_utils.py:58-59,139``, corner gate 0.1 at ``landmark_utils.py:63``,
velocity fudge 0.6 at ``robot.py:144``, warmup 150 at ``jde_robots_main.py:16``,
ICP iteration caps at ``icp.py:16-17``).  Here every knob is promoted to a field
of one frozen dataclass so a config is a hashable static argument to ``jit``.

Unlike the reference, particle count and landmark capacity are first-class and
meant to scale (20 particles there; 100k+ here), so the capacity-style fields
(``max_landmarks``, ``max_measurements``, ``max_hough_lines``...) exist because
XLA requires static shapes: every ragged structure in the reference becomes a
fixed-capacity masked array here.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class FastSLAMConfig:
    """Static configuration; hashable so it can be a ``jax.jit`` static arg."""

    # ---- filter core (reference: fast_slam_2/config.py:7-21) ----
    num_particles: int = 20
    translation_noise: float = 0.0055     # std-dev of translation noise
    rotation_noise: float = 0.001         # std-dev of rotation noise
    measurement_noise: float = 0.001      # R = measurement_noise * I2
    max_landmark_distance: float = 8.0    # Mahalanobis association gate
    default_landmark_cov: float = 0.1     # new landmark cov = 0.1 * I2 (landmark.py:13)

    # ---- static capacities (ragged -> masked fixed shape) ----
    max_landmarks: int = 64               # per-particle landmark slots
    max_measurements: int = 16            # measurements per tick (padded)
    num_beams: int = 180                  # laser beams per scan (robot.py:42)

    # ---- behavior switches ----
    # parity_mode=True reproduces the reference's quirks bit-for-bit
    # (SURVEY.md §7.0): robot-frame association, linear-space weight
    # normalization with the <1e-5 skip, first-match association, argmax-weight
    # pose estimate.  parity_mode=False is the production path: world-frame
    # association on the predicted measurement, log-space weights,
    # best-match (min-distance) association, Joseph-form covariance update.
    parity_mode: bool = True
    resample_threshold_frac: float = 0.5  # resample when Neff < frac * N (fast_slam_2.py:62)
    weight_floor: float = 1e-5            # collapse guard (fast_slam_2.py:168-173)

    # ---- frontend: line filter (line_filter.py:12-21) ----
    line_filter_sigma: float = 0.1
    line_filter_truncate: float = 4.0     # scipy gaussian_filter1d default

    # ---- frontend: Hough corner detector (hough_transformation.py:10-24) ----
    hough_scale: int = 100                # metres -> pixels
    hough_padding: int = 20               # border pixels
    hough_threshold: int = 80             # accumulator votes for a line
    hough_point_radius: int = 2           # rasterized point disc radius
    hough_num_thetas: int = 180           # 1-degree theta bins
    # static accumulator extent: +-hough_rho_bins/2 px = +-20.48 m at the
    # default scale 100.  Points beyond it do NOT vote (frontend/hough.py);
    # raise this (or lower hough_scale) for worlds larger than ~20 m.
    hough_rho_bins: int = 4096
    max_hough_lines: int = 24             # top-K detected lines kept
    # sub-pixel line refinement: weighted total-least-squares refit of each
    # detected line over the scan points within hough_refine_band_px of it
    # (the reference/cv2 quantize to 1 px rho and 1 degree theta —
    # hough_transformation.py:24; Hough detects, the points estimate).
    # Production only — parity mode keeps the reference's quantized lines.
    hough_refine: bool = True
    hough_refine_band_px: float = 3.0
    min_line_angle_deg: float = 45.0      # intersection angle gate (:101)
    max_intersections: int = 64           # K*(K-1)/2 capped
    cluster_eps: float = 0.5              # DBSCAN eps for intersections (:58)
    corner_threshold: float = 0.1         # corner-to-scan-point gate (landmark_utils.py:63)

    # ---- corner identity tracking (frontend/tracking.py; greenfield) ----
    # gate one-frame Hough flickers out of the filter: corners must persist
    # across track_min_hits ego-compensated ticks before they are emitted.
    # Off by default: on clean simulator logs there is no flicker to reject
    # and the min_hits delay slightly hurts ATE — enable for flicker-prone
    # real sensors, or use the track ids as landmark identities downstream.
    track_corners: bool = False
    track_capacity: int = 32
    track_gate: float = 0.4          # match gate, metres
    track_min_hits: int = 2
    track_max_misses: int = 3
    # 1.0 = emit the current detection (track used only for gating/identity);
    # < 1 smooths positions with the odometry-predicted track — only sensible
    # when odometry noise is well below measurement noise
    track_ema: float = 1.0

    # ---- viz landmark clustering (landmark_utils.py:120-144) ----
    viz_cluster_eps: float = 0.5
    viz_min_samples_frac: float = 0.7     # min_samples = frac * avg landmarks/particle

    # ---- ICP proposal (icp.py:16-17) ----
    icp_max_iterations: int = 100
    icp_tolerance: float = 1e-5
    # FastSLAM 2.0 motion proposal: refine the command odometry with an ICP
    # scan match between consecutive scans (the reference ships ICP but keeps
    # it disabled — robot.py:94-95; the north star promotes it).
    use_icp_proposal: bool = False
    # blend factor: odometry = (1-a)*command + a*icp  (1.0 = pure ICP)
    icp_blend: float = 0.5
    # particle proposal: "motion" samples from the motion model alone (the
    # reference's behavior — FastSLAM 1.0, SURVEY.md §7.0 quirk 2);
    # "fastslam2" samples from the measurement-informed posterior
    # p(x_t | x_{t-1}, z_t) via the per-particle landmark EKF linearization
    # (true FastSLAM 2.0; production mode only).
    proposal_mode: str = "motion"
    # floors keeping the motion prior invertible despite the reference's
    # rotation-XOR-translation noise structure.  These also set how much the
    # measurements may correct the pose per tick in directions the reference
    # noise model claims are noiseless (lateral, heading-on-translation-ticks).
    # TUNE TO THE REAL ODOMETRY ERROR: with near-exact odometry (clean sim)
    # tight floors win (0.0003 -> ATE 0.017 on the seed-3 probe); under
    # ~0.02/tick wheel slip the 0.01 default wins (fs2 0.160 vs motion-only
    # 0.221).  Floors far from the true error hurt either way.
    proposal_xy_floor: float = 0.01
    proposal_theta_floor: float = 0.01
    # adaptive floors: estimate the real odometry error ONLINE from the
    # ICP-vs-command residual (requires use_icp_proposal; set icp_blend=0.0
    # to use ICP for the residual ONLY — with clean odometry, blending ICP
    # noise into exact commands costs ATE: 0.049 vs 0.111 at blend 0.5 on
    # the seed-3 verify drive) and feed it to the
    # proposal as the floor, EMA-smoothed and clipped to
    # [proposal_floor_min, proposal_floor_max].  Solves the "tune to the real
    # odometry error" problem above without a priori knowledge: clean
    # odometry anneals the floors tight, wheel slip opens them up.
    adaptive_proposal_floors: bool = False
    proposal_floor_min: float = 5e-4
    proposal_floor_max: float = 0.05
    # trailing median window (ticks, per tick type) for the batched
    # proposal/adaptive.floor_schedule moment estimates
    floor_window: int = 40
    # blend ICP into the command odometry only when the estimated command
    # error exceeds this (m on xy, rad on theta): below it the commands are
    # at worst comparable to scan-match accuracy and blending only hurts
    # (proposal/adaptive.py gate rationale)
    blend_min_sigma: float = 0.008
    # rotation blend gate (rad).  Rotation blending carries an extra cost
    # translation does not: the matcher has a systematic rotation bias
    # (~4.3 mrad/tick measured on the standard drive) larger than its white
    # noise, and the online bias estimate is itself slip-contaminated — so
    # the gate must sit well above the bias scale.  Below it, rotation is
    # never blended (the round-3 contract); above it — sustained rotation
    # slip, where per-tick command error is several times the bias — the
    # debiased match is blended MMSE-style exactly like translation.
    # Measured motivation (round-5 seed-3 slip forensics,
    # eval_results/slip_diag_seed3_slip.json): a 31-rotation-tick turn with
    # 0.113 rad integrated command error and n_meas ~= 1 (too few landmarks
    # to correct from measurements) while the matcher tracked the slip to
    # 3-6 mrad/tick — discarding it held the ATE at 4x the sibling seeds.
    blend_min_sigma_theta: float = 0.008
    # per-tick match-failure gate on the blend, in sigmas of the
    # estimator's LATERAL residual scale.  The lateral ICP-vs-command
    # residual is pure matcher error (the rotation-XOR-translation
    # command has no lateral freedom), so a tick whose lateral residual
    # is far outside the running lateral scale is a failed match —
    # blending it would inject the failure directly into the odometry.
    # Measured motivation (round-5 seed-3 slip forensics): one aliased
    # match right after a turn returned |t| = 0.17 m for a 5 mm commanded
    # tick (lateral residual 0.137 m ~ 70 sigma) and, blended at
    # a_xy = 0.96, whipped the trajectory 0.145 m in one tick — the
    # single largest contributor to that seed's 4x ATE outlier.  Gated
    # ticks fall back to the command for that tick only.
    blend_match_gate: float = 8.0
    # fs2 proposal MODE DIAL (adaptive stack only): trace a scalar g in
    # [0, 1] into the kernel that scales every measurement's Lambda/eta
    # contribution to the proposal, interpolating continuously between the
    # reference's motion-only sampling (0) and the fully
    # measurement-informed fs2 posterior (1).  The estimator ramps g from
    # the DATA-driven estimated command error per component: near-exact
    # commands -> motion-like proposal (conditioning the pose on noisy
    # landmarks only costs accuracy on clean logs), slip -> full fs2.
    # Importance weights are never scaled.
    fs2_mode_dial: bool = True
    # ramp thresholds on the estimator's own output FLOORS (m for xy, rad
    # for theta — same ramp: the scales coincide here): floors at the
    # annealed clean level (~5e-4-1e-3) -> g=0 (motion proposal); floors at
    # the startup/turn-transient prior or slip level (>= ~4e-3) -> g=1
    # (full fs2).  Rationale in adaptive.OnlineFloorEstimator.read.
    fs2_dial_lo_floor: float = 1.5e-3
    fs2_dial_hi_floor: float = 4e-3
    # per-tick-type prior-shrinkage horizon: the floor mixes the config
    # prior with the data moments until the type has this many residual
    # samples.  Small = fast annealing (the median windows react to real
    # slip within ~1-2 samples anyway, and every transient tick at a wide
    # floor costs clean-log accuracy); large = longer protection against a
    # slip regime the type has never sampled.  Measured (3 seeds, N=1000,
    # clean/slip): (8, 0.01-prior) 0.029/0.080 -> (2, 0.002-prior)
    # 0.0198/0.0684 vs motion-only 0.0141/0.1439 — the fast-annealing
    # setting reaches 1.4x motion on clean while keeping the 2.1x slip win
    # (slip-from-tick-0 still detected: one slipped sample moves a 1-2
    # sample median immediately).
    floor_prior_ticks: int = 2
    # the odometry-error sigma the ESTIMATOR assumes before a tick type has
    # samples (the floor's config prior).  Separate from the static-path
    # proposal floors: the static fs2 floor doubles as a standing noise
    # budget (0.01 wins under un-estimated slip), while this prior only
    # covers the first floor_prior_ticks samples per type — wide enough to
    # survive slip-from-tick-0 until the windows see it, tight enough not
    # to burn the clean-log transient.
    floor_prior_sigma_xy: float = 0.002
    floor_prior_sigma_theta: float = 0.002
    # fs2 importance-weight source.  False (default): bootstrap-style
    # landmark likelihood at the SAMPLED pose — measured better in BOTH
    # regimes (clean N=1024: 0.0155 vs 0.0200; slip with the adaptive
    # stack: 0.052 vs 0.062): the theoretically-exact evidence
    # N(nu; 0, S~ + Hx P Hx') is evaluated at the PREDICTED pose with
    # linearized, chi2-gated innovations, and those approximations cost
    # more than the lower-variance weights buy.  NOTE this default is a
    # deliberate, measured approximation, NOT a valid importance weight for
    # the fs2 proposal (the exact weight is likelihood*prior/proposal;
    # likelihood-only is exact only for the bootstrap/motion proposal, so
    # the weighted posterior is biased toward the proposal — it matches
    # the reference's likelihood-only weighting, fast_slam_2.py:158).  If a
    # weight-dependent quantity (Neff, resampling) regresses under fs2,
    # suspect this first.  True restores the textbook evidence weighting.
    fs2_evidence_weights: bool = False

    # ---- motion / app loop ----
    # production online loop: fuse ICP refine + frontend + tracking + filter
    # step into ONE jitted dispatch per tick (one host round trip per tick).
    # Parity mode always runs the split per-jit path (its oracle
    # bit-compatibility is certified per jit).
    fuse_online_tick: bool = True
    velocity_fudge: float = 0.6           # sim reduces commanded v by 40% (robot.py:144)
    warmup_iterations: int = 150          # dead-reckoning warmup (jde_robots_main.py:16)
    linear_velocity: float = 0.3          # drive policy commands (jde_robots_main.py:25)
    angular_velocity: float = 0.5

    # ---- sharding ----
    particle_axis: str = "particles"      # mesh axis particles are sharded over
    map_axis: str = "map"                 # mesh axis for landmark blocks / keyframes
    # halo-exchange distributed resampling (weights-only all-gather + ring
    # neighbour halos; full-gather fallback on degenerate ticks) instead of
    # the GSPMD global gather.  Sharded runs only.
    distributed_resample: bool = False

    # ---- numerics / backend ----
    dtype: str = "float32"
    # run the filter as the fused GPU kernel (core/pallas_kernels.py: C
    # ticks per launch with each particle tile's landmark planes on chip)
    # on the [L, P] planes state; False runs the XLA lax.scan path on the
    # [P, L, k] blocks state.  The arithmetic is shared.
    use_pallas: bool = False
    # run that kernel in Pallas interpret mode (CPU tests, CLI --cpu); off,
    # the kernel refuses any backend but a GPU
    pallas_interpret: bool = False

    @property
    def measurement_cov(self) -> Tuple[Tuple[float, float], Tuple[float, float]]:
        r = self.measurement_noise
        return ((r, 0.0), (0.0, r))

    @property
    def min_line_angle_rad(self) -> float:
        return math.radians(self.min_line_angle_deg)

    def replace(self, **kw) -> "FastSLAMConfig":
        return dataclasses.replace(self, **kw)


DEFAULT_CONFIG = FastSLAMConfig()
