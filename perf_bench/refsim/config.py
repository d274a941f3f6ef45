"""Frozen configuration tree — the framework's single "config DB".

A field-for-field mirror of ``nclt_slam_tpu/config.py``: the JAX package's
``config`` module is only reachable through its package ``__init__``, which
imports JAX, so the port keeps its own copy of the same data.
``tests/test_torch_config.py`` holds every preset equal to the JAX one.

The reference spreads tuned constants over module headers with experiment
provenance in comments (tf_wall_clock_relay_v55.py:35-57,
visual_landmark_matcher.py:54-89, pure_pursuit_path_follower.py:29-65,
send_goals_hybrid.py, nav2_planner_defaults.yaml).  Here they are one pytree
of frozen dataclasses whose defaults are the exp-59/64 campaign values, so a
whole ablation (stock-Nav2-like baseline, RGB-D-only, sensor-noise sweeps) is
just a different config instance fed to the same jitted rollout.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass


def _frozen(cls):
    return dataclass(frozen=True)(cls)


@_frozen
class SimConfig:
    """Physics / timing.  Mirrors run_husky_forest.py:742-743,878-1166."""

    physics_hz: float = 200.0          # PhysX step rate
    nav_decimation: int = 20           # camera/nav tick every 20th step (10 Hz)
    wheel_radius: float = 0.165        # Husky wheel radius [m]
    track_width: float = 0.555         # Husky track width [m]
    v_tau: float = 0.25                # wheel-drive first-order lag [s]
    w_tau: float = 0.15
    max_wheel_speed: float = 12.0      # rad/s clamp on wheel targets
    slip_std: float = 0.01             # per-substep multiplicative slip noise
    max_ticks: int = 12000             # nav ticks cap (20 min @ 10 Hz)


@_frozen
class ImuConfig:
    """Synthetic Phidgets-1042 IMU (run_husky_forest.py:769-860)."""

    gyro_std: float = 0.005            # rad/s white noise
    accel_std: float = 0.02            # m/s^2 white noise
    gyro_bias_std: float = 0.001       # constant per-run bias draw
    accel_bias_std: float = 0.005
    omega_lpf_new: float = 0.4         # omega LPF: 0.4*new + 0.6*prev
    accel_mean_taps: int = 11          # accel 11-tap mean filter
    standstill_window: int = 20        # 100 ms @ 200 Hz position history
    standstill_thresh: float = 0.015   # 15 mm max displacement over window
    gravity: float = 9.81


@_frozen
class CameraConfig:
    """D435i-like RGB-D intrinsics (vio_th160.yaml, landmark recorder)."""

    width: int = 640
    height: int = 480
    fx: float = 320.0
    fy: float = 320.0
    cx: float = 320.0
    cy: float = 240.0
    depth_min: float = 0.5
    depth_max: float = 15.0
    # raycast decimation grid (depth sensor model resolution)
    ray_cols: int = 80
    ray_rows: int = 60
    ray_steps: int = 96                # fixed ray-march steps
    # sample the baked bilinear terrain texture in the ray march instead of
    # the analytic field.  With the gather-free hat-sum road_y the analytic
    # field costs ~7 ms per 15-route render vs ~95 ms for texture gathers
    # (TPU gathers are the bottleneck, not transcendentals) — so the exact
    # analytic field is both faster AND error-free.  Kept as an option for
    # future irregular (non-closed-form) terrains.
    ray_terrain_tex: bool = False
    # base_link -> camera extrinsics (visual_landmark_recorder.py:81-88)
    cam_offset_fwd: float = 0.35
    cam_offset_up: float = 0.18
    # feature observation noise (sensors/features.observe).  px_noise ~1 px
    # is typical ORB localization error; stereo depth error grows
    # quadratically with range (sigma_z = z^2 * disp_err / (fx * baseline);
    # D435i: baseline 50 mm, fx 320 at 640 px, ~0.08 px disparity RMS ->
    # sigma_z/z ~ 0.003 * z, i.e. 0.3 m RMS at 10 m).  Round 1 used flat 1 %
    # which made the VIO unrealistically accurate at range; the quadratic
    # model restores the drift the reference's ORB-SLAM3 exhibits without
    # anchors.
    # 2.0 px starved the anchor RANSAC: with a 3 px inlier gate the core
    # that fits was pinned at ~14 inliers vs the CSV's 31.8 mean (r3
    # calibration); 1.0 px is the honest ORB figure
    px_noise: float = 1.0
    depth_noise_rel_per_m: float = 0.003
    # gross depth outliers (stereo mismatch on repetitive bark/foliage,
    # specular leaves): a D435i in foliage shows a few % of wild depths.
    depth_outlier_frac: float = 0.005
    depth_outlier_lo: float = 0.5      # outlier depth scale range
    depth_outlier_hi: float = 1.6
    # correlated systematic error — what actually produces VIO drift.
    # White pixel/depth noise averages away over ~100 features x a sliding
    # window; real ORB-SLAM3 drift (0.1-0.2 % of distance,
    # routes/README.md:24-40) comes from slowly-varying systematic error:
    # stereo-baseline thermal drift (a depth SCALE bias) and calibration /
    # rolling-shutter pointing error (a pixel OFFSET bias).  Modeled as
    # smooth sine fields of camera position: locally constant (the VIO
    # believes them), varying over tens of meters (error accumulates as a
    # random walk over distance instead of cancelling).
    depth_bias_amp: float = 0.005       # depth scale bias amplitude
    depth_bias_scale_m: float = 30.0   # spatial correlation length
    px_bias_amp: float = 0.25          # pixel offset bias amplitude [px]
    px_bias_scale_m: float = 20.0
    # (amp, scale) set by the r5 teach-band sweep (RESULTS.md r5): the
    # pointing bias integrates along straight diagonals (route 05 paid
    # 2.11 m mean at 0.4 px/40 m — 20x route 13's 0.12, a geometric
    # resonance the reference's flat 0.34-0.65 band rules out) while
    # multi-leg routes cancel it; 0.25 px/20 m lands 05/02/13 at
    # 0.26/0.37/0.04 m mean (max 0.67) inside the reference band's reach
    # rotational motion blur: a 30 ms exposure at |ω| = 0.8 rad/s smears
    # ~1.4° ≈ 8 px across the image — ORB detection collapses and surviving
    # corners localize poorly.  Scales feature dropout and pixel noise with
    # the commanded yaw rate, which makes the stop-turn-go repeat drive
    # (planner corrections, detours, recoveries) measurably harder on the
    # VIO than the smooth teach chase — the reference's repeat-vs-teach
    # drift asymmetry (README.md:24-40 vs :132-151) without touching the
    # teach-phase model.
    blur_drop_per_radps: float = 0.35  # extra dropout fraction per rad/s
    blur_pkeep_floor: float = 0.30     # dropout floor under heavy blur
    px_blur_per_radps: float = 1.0     # pixel-noise multiplier per rad/s
    # repeat-session systematic pointing bias [px] (sensors/features.py):
    # cross-session lighting moves apparent corner positions; applied by
    # the repeat rollout only (teach recorded the reference session), so
    # it raises repeat VIO drift without touching the teach drift band.
    px_bias_session_amp: float = 0.8


@_frozen
class EncoderConfig:
    """Simulated encoder+compass dead-reckoning (v55.py:489-501)."""

    dist_noise: float = 0.005          # 0.5 % distance noise
    compass_noise: float = 0.05        # rad white noise on yaw
    # v55 integrates the UNSIGNED GT displacement along the noisy heading
    # (v55.py:494-498: displacement = hypot(dx, dy), always forward).
    # Reversing therefore integrates FORWARD: every recovery backup or
    # wedge reversal corrupts the dead-reckoning by its full length — the
    # runaway that turns the stock baseline's recovery loops into
    # unbounded localization error ("VIO+encoder accumulates 2-6 m ...
    # recovery behaviors loop endlessly", routes/README.md:179-185).
    # Round 2 "fixed" this with a signed heading projection, which
    # silently bounded anchorless drift at ~2-3 m and erased the stock
    # collapse; False restores reference parity.  True remains available
    # as the physically-correct-encoder ablation.
    signed_disp: bool = False
    # rate-gyro compass drift (rad/s bias random-walk applied to the heading
    # source).  0 = the reference's absolute-compass model (v55.py:662-664:
    # "compass+gyro fusion = GT yaw + noise" — white, not integrated), which
    # bounds encoder-DR error at meters over a route and is what keeps the
    # reference's no-anchor drift in the 1-5 m band.  The r2 default of
    # 0.03 random-walked DR error to ~25 m over a 400 m no-anchor stretch —
    # a failure magnitude the reference stack cannot exhibit.  The drifting
    # model remains the encoder_only() ablation's sensor (where an absolute
    # compass would make pure DR an unrealistically strong baseline).
    compass_drift: float = 0.0


@_frozen
class FusionConfig:
    """v55 relay 4-regime fusion (tf_wall_clock_relay_v55.py)."""

    # anchor thresholds (v55.py:193-199)
    anchor_stale_s: float = 3.0
    anchor_strong_std: float = 0.1
    anchor_ok_std: float = 0.2
    anchor_hysteresis_n: int = 2
    # regime blend weights (v55.py:551-584)
    strong_w_anchor: float = 0.40
    strong_w_slam: float = 0.55
    strong_w_enc: float = 0.05
    ok_w_anchor: float = 0.20
    ok_w_slam: float = 0.75
    ok_w_enc: float = 0.05
    # adaptive no-anchor alpha ladder vs SLAM-encoder disagreement
    noanchor_alpha_steps: tuple = (0.95, 0.70, 0.40, 0.10)
    noanchor_dist_steps: tuple = (2.0, 5.0, 10.0)
    noanchor_anchor_age_s: float = 10.0
    # jump rejection (v55.py:40-41)
    jump_threshold_m: float = 0.5
    yaw_jump_threshold: float = 0.3
    # freeze detection (v55.py:512-526)
    freeze_ticks: int = 60
    freeze_enc_min_disp: float = 0.1
    freeze_slam_max_motion: float = 0.01
    # alignment window (v55.py:256-262)
    align_window: int = 50
    align_max_gt_disp: float = 0.15
    align_max_yaw_std_deg: float = 0.5
    # stack bring-up: max ticks the repeat rollout holds the robot at spawn
    # waiting for the one-time alignment to commit (the reference's launch
    # sequencing — Nav2 goals are only sent after relay+SLAM bring-up,
    # run_repeat_ours.sh).  Commit normally lands ~60 ticks in; the cap
    # only guards a VIO that cannot initialize.
    startup_hold_ticks: int = 300
    # yaw source.  v55 takes yaw from the encoder compass alone (:585) —
    # correct for its absolute-compass sensor, and the parity default now
    # that EncoderConfig.compass_drift defaults to 0.  Set True only with
    # a drifting-compass encoder model (encoder heading bias random-walks,
    # so yaw must come from the aligned SLAM pose while tracking).
    fuse_slam_yaw: bool = False
    # anchor feedback onto the dead-reckoning integrator.  v55's simulated
    # encoder holds an absolute compass, so its DR error stays bounded and
    # anchors only enter the position blend (:559-584) — 0 is strict v55
    # parity and the default.  With a drifting compass the DR error
    # random-walks unbounded and the relay must reset its DR reference
    # toward each accepted anchor (set ~0.5, as encoder_only-style
    # ablations do).
    anchor_enc_feedback: float = 0.0


@_frozen
class LandmarkConfig:
    """Teach recorder + repeat matcher (visual_landmark_{recorder,matcher}.py)."""

    # recorder
    record_min_disp_m: float = 2.0     # new landmark every >= 2 m of camera travel
    # fixed-capacity landmark store.  Must cover the longest teach run:
    # 03_south's out-and-back is ~530 m -> ~265 landmarks at the 2 m
    # trigger; at 256 the recorder silently stopped mid-return-leg and the
    # repeat's return had no anchor candidates at all (reference uses an
    # unbounded python list, recorder.py:290-297; we need a static cap).
    max_landmarks: int = 384
    # Fixed per-landmark feature cap.  192 (= the live-frame cap) rather
    # than a thin sample: the reference stores 500 ORB features per teach
    # snapshot and its successful PnPs average 31.8 inliers
    # (anchor_matches.csv best_n_inliers) — a 96-feature store capped our
    # success inliers at ~14, which kept every published anchor in the
    # weak-covariance band (std 0.2) and starved the v55 'strong' regime.
    feats_per_landmark: int = 256
    ground_v_threshold: float = 180.0  # below-horizon pixel gate (recorder v>180)
    depth_patch_std_max: float = 0.30  # 3x3 depth std gate [m]
    record_min_feats: int = 12         # min gated 3-D points per landmark
                                       # (reference: 30 of 500 ORB feats; we
                                       # observe ~100 model feats per frame)
    # matcher (gates from matcher.py:54-89)
    candidate_radius_m: float = 8.0
    max_candidates: int = 5
    heading_tol_deg: float = 90.0
    min_matches: int = 10
    min_inliers: int = 10
    reproj_max_px: float = 2.0
    ransac_reproj_px: float = 3.0
    ransac_iterations: int = 200
    consistency_m: float = 5.0
    # anchor-drought relaxation of the consistency gate (kept as an
    # ablation knob, default OFF): it was a workaround for a death spiral
    # — nav drift > 5 m rejects every correct anchor forever — that only
    # existed while the matcher's query pose was the fused estimate.  The
    # reference matcher's query pose is /tmp/isaac_pose.txt, which the sim
    # writes as GROUND TRUTH (visual_landmark_matcher.py:266-272,
    # run_husky_forest.py:1081), so its consistency gate is |anchor−GT| ≤
    # 5 m and cannot spiral; with our matcher now gating on GT the same
    # way, the relaxation is unnecessary and would only admit >5 m-wrong
    # anchors the reference rejects.
    consistency_relax_per_s: float = 0.0
    consistency_relax_max_m: float = 0.0
    tick_period: int = 5               # 2 Hz at 10 Hz nav rate
    # covariance model (matcher.py:399-410)
    std_good: float = 0.05
    std_bad: float = 0.2
    inlier_hi: int = 25
    inlier_lo: int = 15
    # --- published-anchor error model (aliased-correspondence bias) ---
    # The reference's anchor_matches.csv logs |anchor − query| for every
    # published anchor: median 1.2 m, p90 3.3 m — an order of magnitude
    # above clean PnP noise.  The query pose is /tmp/isaac_pose.txt, which
    # the sim writes as GROUND TRUTH (run_husky_forest.py:1078-1080 "Write
    # GT pose ..."; the matcher reads it in _read_pose,
    # visual_landmark_matcher.py:266-272) — so the CSV's shift IS the
    # anchor's own error vs GT, with no drift component.  The repo matcher
    # queries with GT the same way (rollout/repeat.py), so the injected
    # bias magnitude must carry the FULL CSV spread: median 1.2 / p90 3.3.
    # Mechanism: in a self-similar forest the RANSAC consensus set itself
    # is biased — descriptor-aliased pairs (bark↔bark, litter↔litter
    # meters apart) reproject inside the 3 px tolerance and drag the
    # solution — so the PUBLISHED pose carries a meter-scale error.
    # TEMPORAL STRUCTURE: the same teach landmarks matched against the
    # same live geometry repeat the same aliased consensus, so the error
    # is persistent per landmark and slowly-varying along the route, NOT
    # i.i.d. per publish.  (An i.i.d. draw at this magnitude jerks the
    # fused pose at 2 Hz, set a ~3.5 m drift floor on the road route and
    # collapsed reach to 10/15 in the r4 campaign — the failure that
    # motivated r4's since-reverted magnitude cut to 0.45/1.10.)  Modeled
    # as a smooth world-position field (sensors/features._bias_field)
    # evaluated at the matched TEACH landmark's position: direction from
    # two phase-shifted fields, lognormal magnitude whose spread combines
    # the field (spatially-correlated, scale anchor_bias_scale_m) with a
    # small per-attempt jitter (anchor_bias_jitter_ln).  Applied BEFORE
    # the 5 m consistency gate; together with the gross tail below the
    # >5 m mass reproduces the CSV's 4.1 % consistency_fail rate.
    # Zero disables (unit tests).
    anchor_bias_median_m: float = 1.2
    anchor_bias_p90_m: float = 3.3
    anchor_bias_scale_m: float = 35.0  # spatial correlation length
    anchor_bias_jitter_ln: float = 0.25  # per-attempt lognormal jitter
    anchor_bias_dir_jitter: float = 0.20  # per-attempt direction jitter [rad]
    # gross-mismatch component: the reference CSV's consistency_fail rate
    # (4.1 % of attempts = ~10 % of PnP-ACCEPTED solves) implies a heavy
    # tail of wrong-association anchors — a candidate landmark matched to
    # a visually-aliased spot meters away composes a pose that passes the
    # inlier/reproj gates but sits 3-40 m off; the 5 m consistency gate is
    # what rejects them.  With prob anchor_gross_p the bias magnitude is
    # log-uniform in [gross_lo, gross_hi]: P(<5 m) ≈ 0.2 of those slip
    # through the gate (the CSV p90 3.3 m shift tail), the rest reproduce
    # the consistency_fail rate: 0.12 x 0.8 ≈ 9.6 % of accepted solves.
    anchor_gross_p: float = 0.12
    anchor_gross_lo_m: float = 3.0
    anchor_gross_hi_m: float = 40.0
    # descriptor observation model.  Real forest ORB descriptors are highly
    # aliased — bark looks like bark, leaf litter like leaf litter — which
    # is why the reference's matcher rejects ~45 % of anchor attempts at
    # the PnP gate and ORB-SLAM3 "runs out of texture" in the deep forest
    # (routes/README.md:68, anchor_matches.csv outcome stats).  Model:
    # every feature's 256-bit descriptor = a texture-class prototype XOR a
    # per-feature unique perturbation of ~desc_unique_bits bits, so
    # unrelated same-class features sit ~2*u*(1-u/256) ≈ 50 bits apart —
    # inside the matcher's 64-bit cap — and become false matches whenever
    # the true feature is occluded/dropped.  desc_classes=0 restores the
    # round-2 globally-unique-random model (no aliasing).
    desc_words: int = 8                # 8 x uint32 = 256-bit descriptors
    desc_noise_bits: float = 14.0      # mean flipped bits per observation
    desc_classes: int = 24             # texture codebook size (0 = unique)
    desc_unique_bits: float = 30.0     # mean bits from class prototype
    # viewpoint-dependent corruption: ORB patches decorrelate continuously
    # with viewpoint change (~fully by 60-70°).  Each feature bit carries a
    # random angular threshold; an observation's flip mask is the set of
    # bits whose threshold lies below the current viewing azimuth's
    # distance from the feature's anchor direction.  Two observations then
    # differ by ~view_bits_per_deg * Δazimuth bits — consecutive VIO
    # frames (sub-degree Δ) pay nothing, while the anchor matcher's
    # candidates (laterally offset, detoured, or drifted poses) pay the
    # ORB viewpoint cliff that produces the reference's 45 % no_pnp_accept
    # outcome rate (anchor_matches.csv).  Saturates at 128 bits ≈ random.
    view_bits_per_deg: float = 2.6     # saturates at 128/rate ≈ 49°
    # teach-vs-repeat session appearance gap: lighting/shadow/season change
    # between the teach recording and the repeat drive decorrelates ORB
    # descriptors ACROSS sessions without touching within-session (VIO)
    # matching — the reason the reference's anchor matcher fails 45 % of
    # PnP attempts on-path while its VIO tracks fine
    # (anchor_matches.csv outcome stats).  Each scene feature gets a fixed
    # random flip mask of ~this many bits applied to every repeat-session
    # observation.
    # Bimodal appearance model (r3 calibration): ALIVE features shift a
    # few bits (published anchors then reach reference-level inlier counts)
    # while a session_dead_frac of landmark views die wholesale
    # (unmatchable in the repeat session).  A single intermediate value
    # (10-12 bits everywhere) cannot reproduce the CSV's bimodal outcomes:
    # it pinned inliers at ~14-20 with either 23 % or 80 % published.
    session_shift_bits: float = 4.0
    session_pkeep_scale: float = 0.85  # repeat-session detector response
    # Appearance DEATH (sun-angle/shadow flips killing a view's ORB
    # responses wholesale) is assigned per ALONG-ROUTE LANDMARK BLOCK with
    # a golden-ratio low-discrepancy sequence (landmarks/matcher.py
    # _block_dead).  History: r3 keyed death on 24 m world cells with an
    # i.i.d. hash — a route crosses only 4-13 cells, so path dead
    # fractions landed anywhere in 0.14-0.95 (the r4 1.2-86 % per-route
    # publish pathology); an r5a rank-1 lattice over the same cells still
    # left path-weighted fractions at 0.12-0.94 (measured: route 03 94 %
    # no_pnp vs route 15 12 %) because a path oversamples whichever cells
    # it runs along.  Blocks of consecutive stored landmarks make the
    # discrepancy bound PER ROUTE by construction (three-distance
    # theorem): any ~20-block route sits within ~1 block of the target
    # fraction, while whole blocks (~dead_block_landmarks x 2 m of route)
    # dying together keeps the attempt-level bimodality and the
    # multi-tens-of-meters anchor droughts the CSV shows.
    session_dead_frac: float = 0.47    # fraction of landmark blocks dead
    dead_block_landmarks: int = 6      # block = 6 landmarks ~ 12 m route
    # cross-session detector overlap: the fraction of teach-session
    # keypoints that are re-detected in the repeat session.  ORB detection
    # is unstable under lighting change — moved shadows promote different
    # corners — so only ~this fraction of a stored landmark's features
    # exist in the live frame at all; the rest of the live features are
    # DIFFERENT physical points (decoys) that alias into false matches and
    # sink the PnP inlier count, the reference's dominant no_pnp_accept
    # mechanism (45 % of attempts, anchor_matches.csv).  1.0 = stable
    # detector (round-2 behavior).
    # (0.55 pushed no_pnp_accept to 77 % vs the CSV's 45 % — same r3 run)
    session_overlap: float = 0.88
    max_obs_features: int = 256        # live-frame feature cap
    # per-tick feature dropout (motion blur, exposure, foliage occlusion).
    # Clutter-scaled: features inside dense tree clusters drop more often
    # (intervening trunks + canopy shadow), which starves the VIO exactly
    # where the reference's ORB starves — deep forest and long diagonals.
    feat_dropout: float = 0.06         # base per-tick dropout probability
    clutter_radius_m: float = 9.0      # neighborhood for the clutter count
    clutter_drop_per_tree: float = 0.001  # extra dropout per nearby collider
    clutter_free_trees: int = 3        # clutter count where penalty starts
    feat_pkeep_min: float = 0.66       # dropout floor (never fully blind)


@_frozen
class MapConfig:
    """Occupancy mapping (teach_run_depth_mapper.py:27-37 + Nav2 costmap)."""

    resolution: float = 0.1
    origin_x: float = -105.0
    origin_y: float = -50.0
    width_m: float = 185.0
    height_m: float = 95.0
    l_free: float = -0.4
    l_occ: float = 1.4
    l_min: float = -5.0
    l_max: float = 5.0
    occ_thresh: float = 0.65
    free_thresh: float = 0.25
    height_lo: float = 0.2             # obstacle band [m] above local ground
    height_hi: float = 2.0
    point_subsample: int = 4
    # inflation layer (nav2_planner_defaults.yaml: 0.7 m, cost_scaling 3.0)
    inflation_radius: float = 0.7
    cost_scaling: float = 3.0
    inscribed_radius: float = 0.4      # robot radius: cost=lethal within this
    obstacle_range: float = 8.0
    # live-update window (cells): the depth integration only touches this
    # crop around the camera (must cover 2*obstacle_range at `resolution`)
    live_window: int = 192
    update_period: int = 5             # costmap refresh every 5 nav ticks (2 Hz)

    @property
    def cols(self) -> int:
        return int(round(self.width_m / self.resolution))

    @property
    def rows(self) -> int:
        return int(round(self.height_m / self.resolution))


@_frozen
class PlannerConfig:
    """Wavefront global planner + dispatcher (send_goals_hybrid.py, NavFn)."""

    window: int = 192                  # local planning crop (cells, 19.2 m)
    sweeps: int = 2                    # Jacobi rounds (x window iterations)
    # the JAX package's backend switch (its Pallas kernel or the XLA loop,
    # bit-equal); the port runs K2 on a card and its plain twin on the CPU
    use_pallas: bool = True
    # two-level planning: a full-map cost-to-goal potential on a coarse
    # static grid seeds the fine window's BORDER, so the window can route
    # toward bypasses longer than itself — the reference's NavFn plans on
    # the whole 1950x900 teach costmap (run_teach.sh:29), and the oracle
    # census measured 5/45 dispatcher-realistic cases where the optimal
    # bypass leaves the 19.2 m window (tests/test_planner_oracle.py).
    # The coarse potential refreshes at the replan cadence; a stale seed
    # (target just changed) falls back to pure window planning.
    # Engagement is an ESCAPE HATCH (dispatcher gates the seed on
    # coarse_escape_fails consecutive window-plan failures): an
    # always-available coarse route suppressed the dispatcher's skip
    # machinery and sent robots on long map-scale detours (coverage
    # 73 -> 53 %, return 8 -> 4/15, r4 measurement) — while a window that
    # keeps failing means the bypass leaves the window, exactly the case
    # where the reference's NavFn (full 1950x900 teach costmap,
    # run_teach.sh:29) routes and ours used to give up.  The oracle census
    # (tests/test_planner_oracle.py) prices the seeded planner 45/45.
    coarse_seed: bool = True
    # consecutive window-plan failures (2 Hz cadence = 3 s) before the
    # coarse seed engages — transient blockage never escapes; the 25-fail
    # skip budget still fires if even the seeded plan cannot route
    coarse_escape_fails: int = 6
    coarse_factor: int = 8             # 0.8 m coarse cells
    coarse_iters: int = 384            # full-map relaxation sweeps
    lethal_cost: float = 99.0
    cost_weight: float = 1.0           # NavFn-like cost->traversal penalty weight
    path_len: int = 256                # fixed extracted-path length
    wp_spacing_m: float = 4.0          # teach WP subsample (send_goals --spacing)
    tolerance_m: float = 3.0           # WP reached tolerance
    # path-commitment window: a good plan is replaced only when the target
    # changes or the committed path is older than this (the reference's 5 s
    # replan loop, send_goals_hybrid :287-345, vs its 2 Hz costmap)
    replan_period: int = 50            # 5 s at 10 Hz
    goal_timeout_ticks: int = 600      # 60 s per WP
    # plan attempts run at the 2 Hz costmap cadence; the reference's
    # skip-after-failures budget is measured against its 0.2 Hz replan
    # loop, so the equivalent count here is ~10x larger (12.5 s of
    # continuous planner failure before a skip)
    max_plan_fails: int = 25
    final_wp_count: int = 5            # last-5 never-skip policy
    proj_cost_thresh: float = 30.0
    proj_max_search_m: float = 3.0
    proj_max_shift_m: float = 1.0
    lookahead_skip_cost: float = 60.0
    detour_radii: tuple = (4.0, 5.0, 6.0, 7.0)
    detour_samples: int = 24
    detour_max_cost: float = 30.0
    max_waypoints: int = 128           # fixed WP-list capacity (508 m @ 4 m)
    # ablation switches (stock-Nav2 baseline disables the hybrid additions)
    enable_detour: bool = True
    enable_projection: bool = True
    enable_known_obstacle_gate: bool = True
    enable_lookahead_skip: bool = True
    # stock FollowWaypoints semantics (exp 74 baseline): one-time client-side
    # WP projection instead of live reprojection, NO per-WP timeout (stock
    # Nav2 has none — the GT-stall watchdog ends the run), no final-WP
    # special policy; plan failure still advances (stop_on_failure: false).
    stock_follow: bool = False
    # NavFn goal tolerance (nav2_stock_params.yaml v3c: 'tolerance: 1.0' —
    # planning FAILS when every cell within 1 m of the goal is lethal;
    # 3.0 returned trivial near-goal plans and wait-looped the BT forever)
    stock_goal_tolerance_m: float = 1.0
    # ticks a planner-failed goal survives before NavigateToPose aborts and
    # waypoint_follower (stop_on_failure=false) moves on: the BT cycles
    # costmap-clear retries + spin/backup/wait recovery rounds first —
    # ~90 s of 'recovery behaviors loop endlessly ... robot barely moves'
    # per blocked WP (routes/README.md:179-185).  With localization drift
    # putting consecutive WPs in static-map inflation, this is the crawl
    # that ends the reference's stock runs at 30-100 m via the tier timeout.
    stock_abort_ticks: int = 900
    # Baseline GT-stall watchdog (_baselines_common/watchdog.py:60-117):
    # exp 74/76 runs are KILLED when ground truth moves < gt_stall_min_m
    # within a gt_stall_window_s wall window (after warmup) — a stock run
    # that wedges in inflation near tick N ends there, it does not get
    # the rest of the tier timeout to crawl free.  Our-stack runs carry
    # no watchdog (run_repeat_ours.sh waits on goal RESULT only).
    gt_stall_abort: bool = False       # on for stock/rgbd baseline configs
    gt_stall_window_ticks: int = 1800  # 180 s @ 10 Hz
    gt_stall_min_m: float = 1.5
    gt_stall_warmup_ticks: int = 2400  # 240 s warmup


@_frozen
class ControlConfig:
    """Pure-pursuit follower (pure_pursuit_path_follower.py:29-65)."""

    lookahead: float = 2.0
    max_vel: float = 0.8
    gain_ang: float = 1.2
    max_ang: float = 0.8
    # proximity limiter ego-tube
    prox_sample_dist: tuple = (0.3, 0.7, 1.1)
    prox_sample_lat: tuple = (-0.15, 0.0, 0.15)
    prox_cost_slow: float = 50.0
    prox_cost_lethal: float = 99.0
    v_slow: float = 0.4
    v_lethal: float = 0.15
    # anti-spin
    spin_w_thresh: float = 0.5
    spin_v_thresh: float = 0.05
    spin_limit_s: float = 5.0
    spin_cooldown_s: float = 3.0
    progress_window_s: float = 5.0
    min_progress_m: float = 0.5
    # wedge recovery
    wedge_window_s: float = 4.0
    wedge_min_disp_m: float = 0.15
    wedge_backup_s: float = 2.5
    wedge_backup_v: float = -0.25
    # ablation switches
    enable_wedge: bool = True
    enable_antispin: bool = True
    enable_prox: bool = True
    # controller selection: False = thesis pure-pursuit stack, True = stock
    # Nav2 RegulatedPurePursuit + BT recoveries (exp 74 baseline)
    use_rpp: bool = False


@_frozen
class RppConfig:
    """Stock Nav2 RegulatedPurePursuitController + recoveries
    (nav2_stock_params.yaml:26-81, behavior_server defaults)."""

    desired_linear_vel: float = 0.8
    lookahead_time: float = 1.5
    min_lookahead: float = 1.5
    max_lookahead: float = 3.5
    min_approach_vel: float = 0.3      # min_approach_linear_velocity
    approach_scaling_dist: float = 1.5
    regulated_min_radius: float = 0.9  # regulated_linear_scaling_min_radius
    regulated_min_speed: float = 0.25
    max_angular_vel: float = 1.0
    # SimpleProgressChecker (yaml:38-44, v3b loosened values)
    required_movement_radius: float = 0.3
    movement_time_allowance: float = 30.0
    # behavior_server recovery suite (BT round-robin)
    spin_duration_s: float = 1.6       # ~90 deg at 1 rad/s
    spin_vel: float = 1.0
    backup_duration_s: float = 3.0
    backup_vel: float = -0.12
    wait_duration_s: float = 5.0


@_frozen
class SupervisorConfig:
    """Turnaround supervisor (turnaround_supervisor.py:37-77)."""

    far_dist: float = 30.0             # must first be >30 m from final point
    near_radius: float = 10.0          # FIRE when back within this radius


@_frozen
class TeachConfig:
    """Teach-pass settings (run_teach.sh, chase controller in sim driver)."""

    chase_lookahead: float = 2.0
    chase_arrive_dist: float = 1.0
    max_speed: float = 0.85            # effective pursuit speed [m/s]
    drift_abort_m: float = 10.0        # vio_drift_monitor gate
    drift_settling_s: float = 60.0
    dense_wp_ds: float = 0.8
    # live VIO + drift monitor during teach (vio_drift_monitor.py:88-129):
    # the reference always runs ORB-SLAM3 alongside the GT relay in teach and
    # aborts online when the Procrustes drift_max exceeds drift_abort_m.
    run_vio: bool = True
    drift_buf_cap: int = 512           # (vio, gt) sample ring (windowed)
    drift_sample_period: int = 2       # sample every 2 nav ticks (5 Hz)
    drift_check_period: int = 100      # Procrustes check every 10 s


@_frozen
class EvalConfig:
    """Metric engine thresholds (compute_metrics.py)."""

    wp_tol_m: float = 3.0
    endpoint_tol_m: float = 10.0
    subsample_m: float = 4.0
    drift_log_period: int = 100        # err= line cadence in relay ticks


@_frozen
class VioConfig:
    """TPU VIO front+back end (capability match for ORB-SLAM3 RGB-D-inertial)."""

    window_kf: int = 16                # sliding window keyframes (8 m of
    #                                    travel at kf_min_disp — local-map
    #                                    scale, matching ORB-SLAM3's
    #                                    covisibility neighborhood)
    kf_min_disp: float = 0.5           # new keyframe every 0.5 m
    gn_iters: int = 8
    lm_damping: float = 1e-3
    huber_px: float = 2.0
    imu_rate_hz: float = 200.0
    preint_cap: int = 64               # IMU samples per keyframe gap (fixed)
    # regime/noise parity with vio_th160.yaml calibration
    noise_acc: float = 0.275
    noise_gyro: float = 0.017
    # ORB-SLAM3 ThDepth=160 x baseline 0.05 m: only points closer than this
    # get a depth (stereo/RGB-D) constraint; farther points are
    # depth-unreliable and are not inserted as map points
    th_depth_m: float = 8.0
    # Sliding-window BA write-back in the repeat loop.  Default OFF on
    # measurement: with the streaming estimator (per-frame GN + running-mean
    # point refinement over every re-observation) the window BA is
    # information-destroying — it re-fits map points to the <= window_kf
    # recorded historical rows and raw VIO drift degrades 0.07 -> 0.36 m
    # over 120 m in every integration variant tried (pose-composed,
    # trust-scaled, obs-count point priors, map-only write-back).
    # ORB-SLAM3 NEEDS local BA because stereo triangulation demands
    # multi-view optimization; the RGB-D streaming design measurably does
    # not.  solve_ba remains the batched flagship kernel (bench BA sweep,
    # tests/test_ba.py) and this flag turns the in-rollout write-back on
    # for ablation studies.
    enable_local_ba: bool = False
    # inertial prior in the motion-only GN: ORB-SLAM3's VI tracking
    # optimizes reprojection PLUS an inertial residual binding the pose to
    # the preintegrated prediction (Optimizer::PoseInertialOptimization*).
    # Without it our per-frame pose floats on whatever features survive,
    # so drift varies wildly with feature density (teach means 0.12-2.11 m
    # across routes vs the reference's tight 0.34-0.65 band).  Stds are
    # the trust in a 0.1 s preintegration window; applied only with IMU.
    # Default OFF on a full-campaign measurement: the synthetic IMU's
    # accel comes from double-differenced GT positions, so collision and
    # wedge events carry contact-spike accelerations; the prior DRAGS the
    # pose along those wild predictions exactly when features are scarce
    # (campaign drift 7.0 -> 8.8, route 05 coverage 81 % -> 12 %).  The
    # plausibility gate + freeze behavior already bound feature-poor
    # frames the way ORB-SLAM3's tracking-lost path does.
    use_inertial_prior: bool = False
    inertial_prior_pos_std: float = 0.05   # m per frame gap
    inertial_prior_rot_std: float = 0.01   # rad per frame gap
    # motion-model plausibility gate: reject a frame's optimized pose when it
    # jumps further than this from the inertial/constant-velocity prediction
    # (ORB-SLAM3 discards such frames as tracking failures rather than
    # publishing them; prevents transient GN divergence during fast yaw)
    max_frame_jump_m: float = 1.0
    # projection-guided matching (ORB-SLAM3 SearchByProjection): a map point
    # only counts as matched when the live feature lies within this pixel
    # radius of the point's projection under the predicted pose — false
    # (descriptor-aliased) matches can then never support a divergent pose
    proj_gate_px: float = 80.0
    # --- world-registration discontinuity model (backend events) ---
    # ORB-SLAM3's reported pose is piecewise-smooth, not smooth: backend
    # events — visual-inertial scale/gravity refinement, IMU re-init after
    # tracking stress, relocalization re-registration — SNAP the world
    # registration of the whole reported trajectory while the map stays
    # internally consistent.  Our streaming tracker has no multi-threaded
    # backend to produce those snaps mechanically, so they are modeled at
    # the emitted-pose interface (the /tmp/slam_pose.txt level the relay
    # consumes): a scale state about the init origin plus a translation
    # offset, both updated on tracking-stress-triggered events.  This is
    # the mechanism behind the reference stock baseline's collapse — live
    # obstacle paint lands at registration-inconsistent offsets, never
    # clears, and walls off the believed corridor, sending the stock stack
    # into endless recovery loops (routes/README.md:179-185,229-242) —
    # while the anchored stack's matcher keeps re-pinning the registration
    # and survives with the reference's ~5 m mean drift (README.md:132-151).
    # Events are stress-gated (NOT a base rate): the reference's teach
    # drift band (0.34-0.65 m mean) shows the same ORB-SLAM3 runs nearly
    # snap-free under the smooth, feature-rich teach chase; discontinuities
    # appear in repeat under rotation-heavy, low-parallax maneuvers —
    # planner-correction spins, recovery behaviors, wedge reversals —
    # which is where ORB-SLAM3's VI estimator actually re-initializes
    # (pure rotation gives no translation parallax, motion blur kills
    # ORB, and the IMU integration window restarts).  Stress = sustained
    # body rotation above snap_stress_rot OR outright tracking failure.
    # The teach chase turns at <= 0.5 rad/s, the repeat
    # follower/recoveries at 0.8-1.0 rad/s — the 0.62 threshold separates
    # them, reproducing the reference's teach-clean / repeat-jumpy
    # asymmetry.  (Match starvation alone was initially a stress trigger
    # too, but our 256-feature observation model dips below any count
    # threshold on dense-forest teach drives where the reference's
    # 3000-feature ORB does not — it pushed teach drift to 2.1 m on route
    # 05 vs the reference band's 0.48; default 0 disables that term.)
    # snap_p_stressed=0 disables the model.
    snap_stress_match_n: int = 0   # frame with fewer matches is "stressed"
    snap_stress_rot: float = 0.62  # rad/s body rotation rate = "stressed"
    snap_stress_min: int = 5       # consecutive stressed frames to arm
    # sustained-starvation arm (ADVICE r4 #4): a tracking collapse that
    # limps below snap_starve_match_n matches for snap_starve_min
    # CONSECUTIVE frames (seconds — much longer than the 5-frame rotation
    # streak) also arms the event model, so a genuine collapse that never
    # relocalizes still produces registration events.  The long streak is
    # what keeps dense-forest teach frames (short dips under any count
    # threshold) from arming — the failure that made r4 zero out the
    # short-streak match term.
    snap_starve_match_n: int = 14
    snap_starve_min: int = 30      # 3 s of continuous starvation at 10 Hz
    snap_p_stressed: float = 0.08  # per-frame event prob while armed
    snap_frac: float = 0.05        # snap std = frac x dist since last event
    snap_cap_m: float = 2.0        # per-event snap std cap [m]
    # event cooldown: a real backend correction (VI scale/gravity refine,
    # IMU re-init, reloc re-registration) redistributes the error
    # ACCUMULATED since the previous one — ORB-SLAM3 does not re-initialize
    # every second.  Requiring snap_min_dist_m of travel between events
    # turns a sustained-stress episode (a wedge spin, a long blur stretch)
    # into ONE registration event on exit instead of an event storm that
    # random-walks the emitted pose tens of meters.
    snap_min_dist_m: float = 3.0
    scale_jump_std: float = 0.012  # scale re-estimate jump std per event
    scale_revert: float = 0.5      # events pull scale error toward 0


@_frozen
class LocalizationMode:
    """Which localization stack drives the repeat pass (ablation axis).

    gt            — perfect localization (debug / speed-of-light baseline)
    encoder       — encoder+compass dead-reckoning only
    slam_encoder  — full v55 fusion: VIO + encoder + visual anchors (ours)
    rgbd_only     — VIO without IMU preintegration (exp 76 baseline)
    """

    use_slam: bool = True
    use_anchors: bool = True
    use_imu: bool = True
    use_gt: bool = False


@_frozen
class Config:
    sim: SimConfig = SimConfig()
    imu: ImuConfig = ImuConfig()
    camera: CameraConfig = CameraConfig()
    encoder: EncoderConfig = EncoderConfig()
    fusion: FusionConfig = FusionConfig()
    landmarks: LandmarkConfig = LandmarkConfig()
    map: MapConfig = MapConfig()
    planner: PlannerConfig = PlannerConfig()
    control: ControlConfig = ControlConfig()
    rpp: RppConfig = RppConfig()
    supervisor: SupervisorConfig = SupervisorConfig()
    teach: TeachConfig = TeachConfig()
    eval: EvalConfig = EvalConfig()
    vio: VioConfig = VioConfig()
    mode: LocalizationMode = LocalizationMode()

    def replace(self, **kw) -> "Config":
        return dataclasses.replace(self, **kw)


DEFAULT = Config()


def ours() -> Config:
    """Full our-stack config (campaign exp 59/64 Pareto point)."""
    return Config()


def gt_localization() -> Config:
    return Config(mode=LocalizationMode(use_slam=False, use_anchors=False,
                                        use_imu=False, use_gt=True))


def encoder_only() -> Config:
    """Pure encoder+compass dead-reckoning ablation (no reference analog).

    Uses the rate-gyro drifting-compass model: with the reference's
    absolute compass, pure DR would be an unrealistically strong baseline
    (bounded heading error ⇒ meters of positional drift over any route)."""
    return Config(mode=LocalizationMode(use_slam=False, use_anchors=False,
                                        use_imu=False, use_gt=False),
                  encoder=EncoderConfig(compass_drift=0.03))


def rgbd_no_imu() -> Config:
    """exp 76 baseline: full pipeline, VIO without the inertial term.

    The matcher stays ON: exp 76's results directory contains
    anchor_matches.csv (76_rgbd_no_imu_ours/results/run_09), i.e. the
    reference's RGB-D ablation removes only ORB-SLAM3's IMU fusion — the
    anchor pipeline still corrects the drifting RGB-D track, which is why
    exp 76 reaches 10/15 where no-matcher stock reaches 2/15."""
    return Config(mode=LocalizationMode(use_slam=True, use_anchors=True,
                                        use_imu=False, use_gt=False))
