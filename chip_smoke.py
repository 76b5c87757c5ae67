#!/usr/bin/env python3
"""Drive the PyTorch port's main path once on one NVIDIA GPU.

Run from the repository root: ``python3 chip_smoke.py``. It needs a CUDA
device and ``nvcc``; without them it exits non-zero before printing any
result. ``python3 chip_smoke.py --landing-ties [lanes]`` instead prints the
landing-tie count that phase 7's cap rests on (``count_landing_ties``), and
``python3 chip_smoke.py --capstones`` runs the six capstones at their
scripts' sizes, each in a process of its own (``capstone_runs``). Phases,
each printing one line of its own numbers; any failure raises and the run
exits non-zero:

  0. environment: card name and power limit, torch / CUDA versions, nvcc;
  1. build ``erpl_monte_carlo_sim_tpu_torch/csrc/flight_summary.cu`` and,
     beside it, ``csrc/threefry.cu`` (jax.random's draws and the AR(1) wind chain);
  2. the kernel against its plain PyTorch version, both on the card, on the
     same dispersed lanes (``SimConfig(max_time=6.0)``): 1024 lanes in
     float32, 256 in float64 with one NaN-wind lane;
  3. the golden flights (nominal liquid and solid motors, no wind, to
     landing) through the kernel against tests/golden/flight_*_nowind.json
     at tests/test_flight.py's bars: the liquid motor in float64 and
     float32, the solid motor in float64;
  4. the main path at the bench size: ``MonteCarloAnalyzer.run_monte_carlo``
     with 262,144 lanes and ``SimConfig(max_time=6.0)``, the flight kernel's
     and the threefry kernels' launch counts from that run, then the flight
     kernel against its plain version at that shape,
     compared (float32 bars) and timed, beside its bound (the least time an
     H100 could take for those flights, ``flight_summary.bound_ms``), the
     share of it the kernel reaches, its registers, spills and warps per SM;
  5. the README quick start: full flights to landing, 16,384 lanes;
  6. the SimConfig opt-ins: for each flag set of ``kernels/measure.py
     FLAG_SETS`` (each opt-in alone, scripts/full_flights.py's set, that set
     with rk2), the kernel against its plain version, both on the card: in
     float32 at the main path's shape (262,144 lanes, ``max_time=6.0``),
     where the kernel is then timed beside its bound; in float64 on 256
     lanes, the kernel then timed at B=65,536; registers and spills of each
     build. The two tiered sets also fly the low-apogee scenes of
     tests/test_descent.py to landing, in both precisions. A lane that the
     speed guard stops a step apart in the two versions, at a speed within
     the bar of the guard, is a tie of the last bits (``guard_ties``): it
     is counted and left out of the comparison;
  7. stabilized full flights: ``run_monte_carlo`` with 262,144 float32
     lanes to landing under scripts/full_flights.py's set, then under
     ``energy_consistent_aero`` alone; walls, outliers (at most 1% with the
     tiered timestep), median steps (the tiered run's at least 2.5 times
     fewer), launches, the kernel's time on the run's own lanes and its
     bound. Under the tiered set the kernel is also held to its plain
     version on the run's first 1024 lanes, flown to landing: in float32 up
     to the landing ties of ``landing_ties`` (lanes that land a step apart
     after thousands of steps of last-bit drift), and the same flights
     widened to float64 on every lane;
  8. the golden-lane certificates of tests/test_mc_distribution_parity.py,
     float64, through the kernel: the 500 calm lanes lane-matched to the
     executed reference, and the 220 forecast lanes, whose pass count in
     parity physics matches the reference's and which all stay valid with
     ``energy_consistent_aero``;
  9. runs larger than one device call, float32, ``SimConfig(max_time=6.0)``:
     (a) ``run_monte_carlo`` with 1,048,576 lanes, 4 slabs of the default
     262,144, whose metrics, masks and stats blocks must be those of 4
     single calls on the slabs' lanes (``fold_in(PRNGKey(seed), k)``), then the same run
     timed stage by stage (sampling, kernel, and the host's readback and
     accumulators, synchronized at each boundary); (b) 8,388,608 lanes, 32
     slabs, streaming past 4,194,304, every lane kept in the prefix: exact
     moments, the sketch's percentiles within 1e-3 of their mass in rank and
     1e-3 sigma in value (``flight_time``, which takes one or two values in
     the window, within 1e-6 of ``np.percentile``), intervals bracketing the
     exact percentiles, sketch exceedances within 1e-3, and the same run
     timed at 1,048,576 lanes a slab (phase 18c splits a longer streaming
     run stage by stage); (c) run (a) killed after
     slab 2 with a checkpoint after every slab, then resumed: run (a)'s
     analysis bit for bit, the checkpoint gone; (d) ``run_to_precision`` on the apogee's mean
     stderr, met after 2 or 3 slabs: ``run_monte_carlo(n_samples=n_used)``'s
     analysis bit for bit but for ``performance`` and ``sequential``. Each
     run counts its kernel launches from 0: one a slab;
 10. lanes flown again with their trajectories recorded, through the
     kernel's recording build, its flight and its derived pass
     (``MonteCarloAnalyzer.resimulate_trajectories``, the launches of both
     counted from 0 before each): (a) 256 lanes spread over phase
     4's run, float32, every summary leaf the run's bit for bit, 64 of the
     trajectories held to the plain recorder on the card at the float32
     bars (``compare_records``), and the same 256 lanes in float64 at rtol
     5e-7; (b) the same for 256 stabilized full flights to landing (phase
     7's set), 64 of them held to the plain recorder in float32 (the
     summaries as phase 7 holds them, ``tied_landings``; the frames up to
     each lane's float32 horizon, ``f32_horizon``, past which the float32
     flight no longer follows the float64 one within the bars; the frame
     epilogue recomputed by the plain ``derived_c`` on every frame to
     landing) and in float64 to landing; each recording's last frame is
     its summary's final state bit for bit; (c) one lane
     from each slab of 9a's 4-slab run, equal to its ``metrics``; (d) in
     float64, the frame-path envelope fed by the kernel against the same
     envelope fed by the plain recorder (counts and histograms exact,
     moments at 1e-9), the in-loop envelope against the frame path, and
     the in-loop reduction alone timed on 2,048 lanes. The recording
     builds are timed in both precisions (``measure.record_case``) beside
     their bound and their latency floor, the records of (a) and (b) in
     both precisions must have the digests of the build before its
     redesign (``RECORD_DIGESTS``), and the derived pass is held to the
     plain ``derived_c`` on (a)'s frames and timed alone;
 11. the user's entry point, in a temporary working directory: (a)
     ``example.main(n_samples=262,144, stabilized=True, device="cuda")``,
     each stage clocked and its launches counted (``StageClock``): the
     report, the 50 per-sim exports and the six figures written (each
     figure over 10 kB; on a host without matplotlib the smoke lets the
     figures' ImportError pass after their data are gathered, prints that
     the PNG gate and the figures' wall were not run, and holds the six
     PNGs again where matplotlib is installed), the report's stats blocks the analysis', each
     export's headline values the run's lane bit for bit, the single flight
     the summary build's on the same inputs, the post-hoc CLIs on the
     exports (quaternion norm drift under 1e-6), the recording build
     launched once for the single flight and once for the exports and not
     again for the two trajectory clouds; (b) the parity example at its
     default 50 lanes, whose CSV-wind single flight diverges as the
     reference's does, run to its end with its artifacts; (c) the golden
     CSV-wind flight on the reference forecast recovered from
     tests/golden/mc_forecast.jsonl, float64: the recording build in an
     11 s window at tests/test_wind_flight_parity.py's bars, and the
     stabilized flight to landing at tests/test_stabilized.py's checks; (d)
     the ``launch_window`` CLI at its default config, 65,536 lanes a
     candidate (each candidate's valid lanes and go printed), and on
     tests/test_launch_window.py's 3 s window, where the mean impact must
     move with the wind's direction.

 12. the sampling variants at the main path's width (262,144 float32 lanes,
     ``max_time=6.0``), each through ``run_monte_carlo`` on the card with its
     K1 launches counted from 0 and its draws timed (the card synchronized
     around each), K1 then timed on the run's own lanes and held to its plain
     version on the first 1024: (a) scrambled Sobol, 8 scrambles and 8
     turbulence modes, its integer points equal to the CPU's for the same
     seeds bit for bit and its normals within 4 ulp, the run's wind speeds
     those points', 8 finite RQMC block means, the apogee's RQMC stderr
     printed beside phase 4's i.i.d. std/sqrt(n); (b) antithetic pairs, every
     scalar channel's second half the mirror of its first as the port forms
     it, bit for bit; (c) ``importance_shift={"motor_thrust": 2.0}``, the
     mean weight within 4 stderr of 1 and the weighted apogee mean within 4
     stderr of phase 4's; (d) a three-member forecast ensemble written as
     CSVs (the recovered reference forecast and copies offset by +-3 m/s in
     u) in 4 slabs of 65,536, the ensemble block a NumPy group-by of the
     run's metrics on its members, one lane of each slab re-simulated to the
     run's metrics bit for bit with its member drawn again; (e) 1,048,576
     Sobol lanes in 4 slabs, ``run_to_precision`` on ``qmc_mean_stderr``
     stopping at the 4th slab with the run's analysis, and the run killed
     after 2 slabs and resumed, bit for bit; the draw of every slab split
     into its stages (``DrawSplit``, the card synchronized around each).
 13. the estimators at the main path's width (float32, liquid motor,
     ``max_time=6.0`` unless stated), every lane through K1, launches counted
     from 0 before each run: (a) control variates on one call of 262,144
     lanes with 8 turbulence modes and 4 wind-speed knots, the moments
     reduced on the card held to the same function over the same lanes in
     float64 on the host (within ``CV_MOMENT_BAR`` of each matrix's scale),
     the adjusted apogee within 4 stderr of the plain mean, the moments'
     and the turbulence scores' ms; (b) the same on 1,048,576 lanes in 4
     slabs, the block equal to the 4 slabs' moments merged on the host, and
     the run killed after 2 slabs and resumed, bit for bit; (c) the two-level
     correction of phase 7's tiered full flights (262,144 lanes, 4,096
     coupled lanes), the fast leg's summaries K1's on those lanes bit for
     bit, the corrected means the means plus the bias, each leg's wall; (d)
     subset simulation (16,384 lanes a level, p0 = 0.125) for the apogee
     above phase 4's 99.9th percentile, within 3 combined CoV of phase 4's
     count, and the 1e-6 quantile over 2 seeds, with K1's ms at 2,048 and
     16,384 lanes and level 0's first 1,024 lanes held to the plain
     version; (e) Sobol' indices on 262,144 lanes a matrix, ``pairs="auto"``,
     100 bootstrap resamples, one launch a matrix, every share in [-0.05,
     1.05], the draw, assembly, kernel and bootstrap walls apart, matrix A's
     first 1,024 lanes held to the plain version; (f) the GPD tail of (a)'s
     run against the count's Wilson interval, the importance-weighted
     exceedance of a tilted run against phase 4's count, the
     ``tail_probability`` CLI with ``--gpd``, ``--shift`` and ``--subset``,
     and the two estimator figures clocked (``StageClock``; not drawn where
     matplotlib is missing, as in phase 11).
 14. mode-compressed wind (``wind_table_modes``; on the card K1 flies each
     lane's expanded table, ``kernels.flight_summary.expanded``): (a) K1
     against the plain modes query on the card, 1,024 float32 and 256
     float64 lanes, K=24 and K=N (at full rank also against the realized
     tables' flights), at K1's bars; (b) ``run_monte_carlo`` with 262,144
     lanes and K=24, its wall, launches, the expansion's ms and bytes, and
     the apogee mean's drift from phase 4's; (c) the two-level correction
     with its fast leg compressed (4,096 coupled lanes); (d) 4 lanes of (b)
     and one of each slab of a 4-slab modes run re-simulated, equal to the
     runs bit for bit; (e) modes under ``wind_table_bf16`` (the scores
     rounded, the table not again) against the plain query;
 15. the differentiable flight (``engine.diff``), float64: (a) the primal
     of 256 dispersed lanes of the window against K1's summaries at rtol
     5e-7; (b) their per-lane d(apogee)/d(thrust_scale) from one reverse
     pass of the graphed segments against central differences of two K1
     flights (``DIFF_EPS``, bar ``DIFF_FD_RTOL``; lanes whose rail or main
     step count differs between the two are left out and counted); (c) the
     graphed segments against eager autograd on the card (64 lanes, 1.5 s):
     metrics bit for bit, gradients at rtol 1e-9; (d) a landed flight's
     d(range) and d(flight_time)/d(thrust_scale) against K1's differences
     by the JAX package's recipe; (e) the walls of ``variance_budget``,
     ``optimize_robust`` (256 lanes, 4 evaluations), ``auto_shift`` with its
     tilted run, and the projection of one ``metric_and_grad`` at the CLIs'
     ``max_time=120``;
 16. multi-rank runs over ``torch.distributed`` (``parallel/``): (a) in this
     process an NCCL group of one rank on the card: ``MonteCarloAnalyzer(
     mesh=...)`` at 262,144 lanes is phase 4's analysis bit for bit (one
     launch, ``cores_used`` 1); ``collective_stats`` of each headline metric
     (float64) against the host statistics (the exact-path intervals bit for
     bit, mean and std within 1e-12), ``collective_footprint``,
     ``collective_tail_reservoir`` (k=4,096) and ``collective_envelope`` (256
     float64 lanes of phase 10a's recording) against their single-device
     counterparts; (b) two spawned ranks on the one card, Gloo over CUDA
     tensors (``parallel.run_ranks``): the single call (2 x 131,072 lanes) is
     phase 4's analysis and a 4-slab run of 1,048,576 lanes phase 9a's, bit
     for bit, on both ranks; ``pod_scale`` at 262,144 lanes prints the same
     JSON on both (but for wall and rate), its apogee extremes the
     single-rank collective's over both ranks' draws; each rank's launches,
     walls, the summaries' gather and each collective timed; the two ranks
     time-share the card, so their walls are no scaling figure; (c) where
     the machine has two cards or more, NCCL over up to 4 of them with (b)'s
     checks; on one card it prints that it did not run, and why;
 17. jax.random's threefry through ``csrc/threefry.cu`` (``kernels/threefry.py``):
     (a) every draw of ``threefry_cases`` (split, fold_in, bits, uniforms
     and normals in float32 and float64, randint, for two seeds; the
     sampler's per-lane wind chain at 262,144 lanes x 100 knots) against the
     plain version on the card and the committed JAX golden
     (``erpl_monte_carlo_sim_tpu_torch/data/threefry_golden.npz``): keys,
     bits, uniforms and randint exact, normals within 2 ulp (float32) and
     2e-13 relative (float64); the main path's three channel draws (normals
     over 4 and 5 parent keys, uniforms over 2, 262,144 lanes each); the
     AR(1) kernel, the wind chain fused with its recursion
     (float32 synthesized and forecast, float64) and the recursion on a given
     driver (float32, float64), at 262,144 lanes bit for bit against their
     plain versions; (b) the fused chain timed beside its bound, its plain
     version and its occupancy, with the recursion on a given driver (beside
     ``torch.einsum`` of the driver with ``ar1_transfer_matrix``) and the
     two launches it replaced; the draw kernel on the same chain beside its
     bound, the largest channel draw, ``torch.randn`` of as many normals; and
     the whole draw of 262,144 lanes (its wall, its kernels, which must be
     fewer than 3 a knot, and the AR(1) kernel's one launch) beside the
     torch generator's 9.2 ms; (c) the f64 analysis of 256 lanes, seed 0
     (the 6 s window) against the committed JAX analysis of that seed
     (``data/analysis_seed0_golden.npz``): valid mask exact, summaries and
     statistics within rtol 1e-6.
 18. the capstones (``erpl_monte_carlo_sim_tpu_torch/capstones``) through
     their ``run``, K1's launches counted from 0 before each: (a)
     ``million_flights``, parity and ``--fast``, at full size (a warm call
     and 2 x 524,288 lanes), the window's step count the one
     ``hundred_million_flights`` reports; the fast build (the one the
     mode-compressed tables fly, built in phase 1) on the first call's
     lanes gives the run's bits, and on its first 1,024 lanes holds to its
     plain version at the float32 bars, timed beside its bound; (b)
     ``full_flights --rk2`` at full size (4 x 262,144 lanes to landing and
     the two-level block of 4,096): at most 1% outliers, 90% of the block
     coupled; (c) ``hundred_million_flights``, parity and ``--fast``, at
     10,000,000 lanes (its width, 262,144 a slab; 39 slabs, the last of
     38,528), each run's streamed mean and std held to a float64 NumPy pass
     over the lanes its streams took, its checkpoint writes clocked and the
     file gone at the end, the parity run split stage by stage
     (``slab_stages``); the fast run killed at the draw after its first
     checkpoint (slab 16) and resumed, equal to the uninterrupted run bit
     for bit (the two-level block's walls aside).
 19. the stacked-vector single-flight engine, ``engine.simulate_summary`` and
     ``simulate_flight`` (the JAX package's single-flight entry points),
     which on CUDA tensors launch K1 and K1-Rec, each call's launches
     counted from 0: (a) the README's Quick start, the nominal liquid
     scene to landing as one unbatched flight, in float64 (held to
     tests/golden/flight_liquid_nowind.json at phase 3's bars) and float32,
     one K1 launch each, the warm wall printed; (b) K2's counterpart: 4,096
     dispersed lanes of a 2 s window, one with a NaN wind table above 2 km,
     through ``simulate_summary`` (one launch of K1's build with the stacked
     engine's speed, the fold build, whose summary it is bit for bit)
     against the stacked plain version on the card on the same lanes (its
     eager step captured once and replayed as a CUDA graph, bit for bit the
     eager loop), the NaN lane's ``max_speed`` 0 in both, float64 at rtol
     5e-7 / atol 1e-6 with every step count exact and float32 at rtol 2e-5
     (lanes that leave the rail or stop a step apart counted, at most
     0.1%), the plain version's ms a main-loop step printed; (c)
     ``simulate_flight`` of one lane over a 6 s window through K1-Rec and
     its derived pass, every valid frame and the summary held to the
     stacked plain recorder on the card in float64; (d) ``descent_dt_scale``
     refused with no launch, and ``integrator="rk2"`` with
     ``wind_table_bf16`` (which the stacked path does not read) flying the
     parity flight bit for bit.
 20. chunked flights (``engine.simulate_batch_chunked``, the analyzer's
     ``chunk_steps``) through K1's carry build, one launch a chunk, each
     run's launches counted from 0: (a) phase 4's run at 262,144 lanes with
     ``chunk_steps=256``, its summaries a one-shot ``simulate_summary`` of
     the same drawn lanes bit for bit (digest lines for both), the carry
     build's outputs on those lanes held to K1's plain version with the
     stacked engine's speed at phase 4's bars, the chunks, the kernel's ms
     a chunk beside the one-shot kernel's, the bound and the wall beside
     phase 4's; (b) phase 5's parity full flights (16,384
     lanes, lane 0 the Quick start's nominal flight, which alone runs past
     8,192 steps) at the default ``chunk_steps=8192``, several chunks, equal
     to one-shot bit for bit, the progress calls printed; (c) phase 19b's
     4,096 lanes and NaN-wind lane in chunks of 64, held to the carry
     build's plain version (the stacked engine's chunk loop) on the card at
     19b's bars, the NaN lane's ``max_speed`` 0 in both.

The kernels JSON gives each flight_summary and recording row the launches
of phase 11's example runs (``example_launches``), and the summary rows
(and the parity recording row) those of phase 12's runs
(``variant_launches``); the summary rows also those of phase 13's runs
(``estimator_launches``), and those of phases 14 and 15
(``modes_launches``, ``diff_launches``), phase 16's per rank
(``parallel_launches``), phase 18's (``capstone_launches``) and phase 19's
(``stacked_launches``, also on the parity recording row and the derived
pass's row). After the
flag sets' rows come the fold build's row (phase 19b: its launches, times,
error against the stacked plain version) and the carry build's (phase 20a's
launches, ms a run and a chunk, bound, error against K1's plain version
and that version's ms at the main path's shape; phase 20c's error and the
stacked plain version's ms at its shape), then the fast
capstones' build's row (phase 18a). A
recording row's ``ms`` is ``flight_record``'s time (the build's launches
and the frames' gather), its ``build_ms`` the
build's launches alone (``measure.record_case``), and its
``latency_floor_ms`` the least time of the flight's serial chain, whose
``share_of_floor`` is of ``build_ms``. After the recording rows comes the
derived pass's row (phase 10's launches, times, bound, registers and
occupancy). Its last two rows are the threefry kernels': the
draw kernel's and the AR(1) kernel's, each with phase 4's launches, phase
17b's times, bound, occupancy, registers and spills, and the whole draw's ms
and launches.

Phases 2, 4, 5 and 6 also print ``digest`` lines: the SHA-256 of the
kernel's outputs with NaN made canonical (``kernels/measure.py digest``). A
change to the kernel that moves no bit leaves every digest as it was.

The line before the last is the kernel report (JSON), the last line the
device record (JSON).
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import os
import shutil
import sys
import time

import numpy as np
import torch

from erpl_monte_carlo_sim_tpu_torch.kernels.measure import (
    FLAG_SETS, ar1_timing, card_line, cuda_ms, device_launches, digest,
    flag_set, head, kernel_ptxas, low_apogee_batch, map_tensors, occupancy, ptxas_usage,
    record_case, record_ptxas, records_digest, sample_batch, sass_listing, sm_clock_mhz, spread,
    step_instructions, time_kernel, warm_ms, widened, with_stall)

ROOT = os.path.dirname(os.path.abspath(__file__))
KERNEL_SOURCE = "erpl_monte_carlo_sim_tpu_torch/csrc/flight_summary.cu"
REPLACES = (
    ("simulate_summary_component",
     "erpl_monte_carlo_sim_tpu/experimental/pallas_component.py:186"),
    ("simulate_summary_pallas",
     "erpl_monte_carlo_sim_tpu/experimental/pallas_kernel.py:217"),
)
# the recording build's derived pass: what the JAX package runs in its place
DERIVED_REPLACES = ("erpl_monte_carlo_sim_tpu/engine/component.py:335 (derived_c, which XLA "
                    "evaluates inside the recorder's loop; no Pallas kernel)")
WINDOW = 6.0
BENCH_LANES = 262_144
FULL_FLIGHT_LANES = 16_384
# phase 6: each flag set's window is compared and timed at the main path's
# shape in float32; float64 is compared on 256 lanes and timed at B=65,536.
# The tiered sets also fly the low-apogee scenes to landing (about 3k
# steps) in both precisions.
FLAG_LANES = {torch.float32: BENCH_LANES, torch.float64: 256}
F64_TIMED_LANES = 65_536
TO_LANDING = ("full_flights", "full_flights+rk2")
# phase 9: 4 slabs at the default lane_slab; 32 slabs, past the (default)
# streaming threshold
LARGE_LANES = 4 * BENCH_LANES
STREAM_LANES = 32 * BENCH_LANES
STREAM_THRESHOLD = 4_194_304
# phase 7: lanes of the tiered run held to the plain version to landing
# (about 5-8k steps; the plain version's step costs about the same for
# any lane count up to some thousands)
SLICE_LANES = 1024
RTOL = {torch.float32: 2e-5, torch.float64: 5e-7}
ATOL = 1e-6
# phase 10: lanes re-simulated; of them, lanes held to the plain recorder
# on the card; lanes of the envelope runs and of its kernel-fed against
# plain-fed check
RESIM_LANES = 256
HELD_LANES = 64
# the digests of phase 10's recordings (``measure.records_digest``: 10a's 256
# lanes in float32 and float64, 10b's 256 lanes in float32 and 64 in
# float64), which a change to the recording build that moves no bit keeps
RECORD_DIGESTS = {"10a f32": "268cc0bf997e0a3c", "10a f64": "7ff32da17f9ac667",
                  "10b f32": "675857a0b26e7a5a", "10b f64": "cab6013e93add0ca"}
ENVELOPE_LANES = 4096
ENVELOPE_HELD = 1024
# phase 12: the sampling variants at the main path's width; the Sobol run's
# options, and the forecast ensemble's slab
SOBOL = {"sampler": "sobol", "sobol_scrambles": 8, "sobol_wind_modes": 8}
ENSEMBLE_SLAB = 65_536
# phase 13: the estimators at the main path's width
CV_OPTIONS = {"control_variates": True, "cv_wind_modes": 8, "cv_wind_speed": 4}
TWO_LEVEL_LANES = 4096
SUBSET = {"n_per_level": 16_384, "p0": 0.125}
QUANTILE_P = 1e-6
SOBOL_BOOT = 100
# the CV moments on the card against their float64 recomputation: each
# matrix within this share of its largest entry (float32 controls)
CV_MOMENT_BAR = 1e-4
# phase 14: turbulence modes of the compressed runs; the slabbed run's slab;
# lanes re-simulated
MODES_K = 24
MODES_SLAB = 65_536
MODES_RESIM = 4
# phase 15: dispersed float64 lanes differentiated (optimize_robust's default
# width); the central difference's step in the thrust scale and its bar,
# stated before the first run: in float64 the differences' truncation and
# rounding are far below it, so a miss is a wrong gradient
DIFF_LANES = 256
DIFF_EPS = 1e-5
DIFF_FD_RTOL = 1e-4
# the graphed segments against eager autograd: lanes and window
GRAPHED_LANES = 64
GRAPHED_WINDOW = 1.5
# the landed flight: propellant (it lands after about 6.4 s), window, and the
# JAX package's recipe (tests/test_sensitivity.py:121-173)
LANDING_PROPELLANT = 1.0
LANDING_WINDOW = 20.0
LANDING_EPS = 5e-5
LANDING_RTOL = 1e-2
# the users' entry points: window and optimize_robust's evaluations
USER_WINDOW = 2.0
ROBUST_EVALS = 4
# phase 16: the tail reservoirs' k; the ranks of the one-card Gloo group; the
# stats' bar against the host's (float64 sums in another order)
PARALLEL_K = 4096
GLOO_RANKS = 2
STATS_RTOL = 1e-12
METRICS = ("apogee_altitude", "range", "flight_time")
# phase 17: jax.random's draws, held to goldens of the JAX package's
# (tests/test_torch_prng.py and tests/test_torch_analyzer.py regenerate them
# from JAX and hold them equal); the wind chain at the main path's width, of
# which the golden keeps a few lanes; the bars: keys, bits, uniforms and
# randint exact, normals within 2 ulp in float32 and 2e-13 relative in
# float64; the card's analysis (the analyzer test's: 256 lanes, float64,
# the 6 s window, seed 0) at the whole-slice bar
DATA = os.path.join(ROOT, "erpl_monte_carlo_sim_tpu_torch", "data")
THREEFRY_GOLDEN = os.path.join(DATA, "threefry_golden.npz")
ANALYSIS_GOLDEN = os.path.join(DATA, "analysis_seed0_golden.npz")
THREEFRY_SEEDS = (0, 2**40 + 7)
CHAIN_LANES = BENCH_LANES
CHAIN_KEPT = (0, 1, 2, 4095, 131_072, BENCH_LANES - 1)
# the threefry build's kernels, by a part of their names
THREEFRY_KERNELS = {"draw": "threefry_kernel", "ar1": "ar1_kernel"}
NORMAL_ULPS = 2
NORMAL_F64_RTOL = 2e-13
ANALYSIS_LANES = 256
ANALYSIS_RTOL = 1e-6
# the torch generator's draw of the main path's lanes, before the threefry
# draws (PERF.md section 5, "Sampling variants")
TORCH_GENERATOR_DRAW_MS = 9.2


def phase(name: str, **numbers) -> None:
    print(f"[{name}] " + " ".join(f"{k}={v}" for k, v in numbers.items()), flush=True)


def leaves(obj, path=""):
    if dataclasses.is_dataclass(obj):
        for f in dataclasses.fields(obj):
            yield from leaves(getattr(obj, f.name), f"{path}.{f.name}")
    else:
        yield path, obj


QUAT_KEYS = ("quat_w", "quat_x", "quat_y", "quat_z")


def compare(ref_out: dict, got_out: dict, dtype) -> float:
    """Every FlightSummary leaf built from the kernel's outputs ``got_out``
    against the one built from the plain version's ``ref_out`` (both
    ``flight_summary`` dicts): floats within ``RTOL[dtype]``/``ATOL``
    (float32 [B,3] leaves, and the range, against each lane's vector norm),
    integers and flags exact. Returns the largest absolute float difference;
    raises on any mismatch, naming every leaf that has one.

    In float32 the rail-exit Euler angles are held through the kernel output
    they are computed from, the launch quaternion (the host applies the same
    ``quaternion_to_euler`` to both sides). A launch is within a few tenths
    of a degree of vertical, where that extraction is ill-conditioned: pitch
    is asin(s) with |s| near 1 and is clamped at |s| >= 1, so one ulp of
    difference in the quaternion can move the angles far beyond the bar."""
    from erpl_monte_carlo_sim_tpu_torch.engine.batch import _summary_pytree

    ref, got = _summary_pytree(ref_out), _summary_pytree(got_out)
    rtol = RTOL[dtype]
    landing_norm = torch.linalg.vector_norm(ref.landing_position, dim=-1)
    worst, bad = 0.0, []
    for (path, a), (_, b) in zip(leaves(ref), leaves(got)):
        if not a.is_floating_point():
            if not torch.equal(a, b):
                lanes = (a != b).nonzero()[:5].flatten().tolist()
                bad.append(f"{path}: lanes {lanes} differ")
            continue
        if dtype == torch.float32 and path == ".rail.rail_exit_euler":
            path += " (as its launch quaternion)"
            a = torch.stack([ref_out[k] for k in QUAT_KEYS], dim=-1)
            b = torch.stack([got_out[k] for k in QUAT_KEYS], dim=-1)
        scale = a.abs()
        if dtype == torch.float32 and a.ndim == 2:
            scale = torch.linalg.vector_norm(a, dim=-1, keepdim=True).expand_as(a)
        elif dtype == torch.float32 and path == ".range":
            scale = landing_norm
        diff = (a - b).abs()
        same_nan = torch.isnan(a) & torch.isnan(b)
        ok = same_nan | (diff <= ATOL + rtol * scale)
        if not bool(ok.all()):
            i = (~ok).nonzero()[0].tolist()
            bad.append(f"{path}: {int((~ok).sum())} values, first at {i} "
                       f"plain={a[tuple(i)].item()!r} kernel={b[tuple(i)].item()!r}")
        finite = ~same_nan
        if bool(finite.any()):
            worst = max(worst, float(diff[finite].max()))
    if bad:
        raise AssertionError(f"kernel != plain ({dtype}, rtol {rtol}):\n  "
                             + "\n  ".join(bad))
    return worst


# the frame's state channels held, in float32, against one scale per vector
STATE_SCALES = (("px", "py", "pz"), ("vx", "vy", "vz"), ("qw", "qx", "qy", "qz"),
                ("ox", "oy", "oz"), ("frac",), ("time",))
EULER_KEYS = ("euler_roll", "euler_pitch", "euler_yaw")
# float32 rounding of an Euler angle's arguments, in both versions together
EULER_ROUNDING = 16 * torch.finfo(torch.float32).eps


def euler_slack(q_ref: torch.Tensor, q_got: torch.Tensor) -> torch.Tensor:
    """How far each Euler angle (roll, pitch, yaw as ``quaternion_to_euler``
    takes them; ``[..., 3]``) of the quaternion ``q_got`` may lie from the
    same angle of ``q_ref`` (``[..., 4]``), given how far the two
    quaternions lie apart: the extraction's own conditioning. With ``d``
    the largest difference of a component, the two arguments of roll's and
    of yaw's atan2 move by at most 10 d (1 + d) together and pitch's sine by
    4 d (1 + d), plus ``EULER_ROUNDING``. The angle of a vector of length r
    (the cosine of the pitch) turns by at most (pi/2) e / r for a move e
    < r, and by up to pi past it (near vertical, roll and yaw are not
    defined); asin moves by at most e / sqrt(1 - s^2), s the largest sine
    within reach, and never by more than (pi / sqrt 2) sqrt(e)."""
    d = (q_got - q_ref).abs().amax(-1)
    w, x, y, z = q_ref.unbind(-1)
    e_vec = 10.0 * d * (1.0 + d) + EULER_ROUNDING
    e_sin = 4.0 * d * (1.0 + d) + EULER_ROUNDING

    def turn(a, b):
        r = torch.hypot(a, b)
        return torch.where(e_vec < r, (math.pi / 2) * e_vec / r, math.pi)

    hi = torch.clamp((2 * (w * y - z * x)).abs() + e_sin, max=1.0)
    pitch = torch.minimum(e_sin / torch.sqrt(1 - hi * hi),
                          (math.pi / math.sqrt(2)) * torch.sqrt(e_sin))
    return torch.stack([turn(2 * (w * x + y * z), 1 - 2 * (x * x + y * y)), pitch,
                        turn(2 * (w * z + x * y), 1 - 2 * (y * y + z * z))], dim=-1)


def record_checks(ref: dict, got: dict, dtype) -> list:
    """The per-value checks of ``compare_records``: ``(channel, ok, diff,
    plain, kernel)``, ``ok`` and ``diff`` shaped as the channel's values
    (``[T, B]``, or ``[k, T, B]`` for a state vector of k components)."""
    rtol, f32 = RTOL[dtype], dtype == torch.float32
    pairs = []
    for keys in STATE_SCALES:
        a = torch.stack([ref[k] for k in keys])
        scale = torch.linalg.vector_norm(a, dim=0, keepdim=True).expand_as(a) if f32 else a
        pairs.append(("/".join(keys), a, torch.stack([got[k] for k in keys]),
                      ATOL + rtol * scale.abs(), False))
    slack = None
    if f32 and EULER_KEYS[0] in ref["derived"]:
        slack = euler_slack(*(torch.stack([r[c] for c in ("qw", "qx", "qy", "qz")], dim=-1)
                              for r in (ref, got)))
    for k, a in ref["derived"].items():
        scale = a
        if f32:
            scale = torch.where(ref["valid"], a.abs(), 0.0).nan_to_num(0.0).amax(0, keepdim=True)
        tol = ATOL + rtol * scale.abs()
        if slack is not None and k in EULER_KEYS:
            tol = tol + slack[..., EULER_KEYS.index(k)]
        pairs.append((k, a, got["derived"][k], tol, k in ("euler_roll", "euler_yaw")))
    checks = []
    for name, a, b, tol, wraps in pairs:
        diff = b - a
        if wraps:
            diff = torch.remainder(diff + math.pi, 2 * math.pi) - math.pi
        diff = diff.abs()
        same_nan = torch.isnan(a) & torch.isnan(b)
        checks.append((name, same_nan | (diff <= tol), torch.where(same_nan, 0.0, diff), a, b))
    return checks


def compare_records(ref: dict, got: dict, dtype, keep=None) -> float:
    """The kernel's recorded frames ``got`` against the plain recorder's
    ``ref`` (``flight_record`` records, ``[T, B]``): ``valid`` exact, the
    rest within ``RTOL[dtype]``/``ATOL``, on the frames where ``keep``
    (``[T, B]``, every frame by default) holds. In float64 every value on
    its own. In float32, as ``compare`` holds vectors: each state vector
    against its norm at the frame, and each derived channel against its
    largest magnitude over the lane's valid frames (a channel that passes
    near zero, as cl or the angle of attack does, carries the absolute
    rounding of its scale); the Euler angles, ill-conditioned near vertical
    (ROADMAP F6), within that bar plus ``euler_slack`` of the two
    quaternions at the frame, roll and yaw modulo 2 pi. Returns the
    largest absolute difference; raises naming every channel that
    differs."""
    if keep is None:
        keep = torch.ones_like(ref["valid"])
    if not torch.equal(ref["valid"][keep], got["valid"][keep]):
        lanes = ((ref["valid"] != got["valid"]) & keep).any(0).nonzero()[:5].flatten().tolist()
        raise AssertionError(f"recorded valid differs on lanes {lanes}")
    worst, bad = 0.0, []
    for name, ok, diff, a, b in record_checks(ref, got, dtype):
        ok = ok | ~keep
        if not bool(ok.all()):
            i = (~ok).nonzero()[0].tolist()
            bad.append(f"{name}: {int((~ok).sum())} values, first at {i} "
                       f"plain={a[tuple(i)].item()!r} kernel={b[tuple(i)].item()!r}")
        held = torch.where(keep, diff, 0.0)
        if held.numel():
            worst = max(worst, float(held.max()))
    if bad:
        raise AssertionError(f"recorded frames: kernel != plain ({dtype}, rtol "
                             f"{RTOL[dtype]}):\n  " + "\n  ".join(bad))
    return worst


def f32_horizon(ref32: dict, ref64: dict) -> torch.Tensor:
    """Each lane's float32 horizon ``[B]``: the first frame at which the
    plain recorder's float32 flight ``ref32`` leaves the float32 bars
    (``compare_records``) of its float64 flight ``ref64`` (the same lanes,
    the inputs widened exactly), or the frame count if it never does.
    Past it the flight in float32 no longer follows the flight within the
    bars, whoever computes it: over a stabilized full flight the attitude
    (and all that depends on it) is ill-conditioned in float32."""
    out = torch.zeros_like(ref64["valid"])
    for _, ok, _, _, _ in record_checks(ref64, ref32, torch.float32):
        out |= ~(ok.all(0) if ok.ndim == 3 else ok)
    out &= ref32["valid"] & ref64["valid"]
    n = out.shape[0]
    return torch.where(out.any(0), out.to(torch.int8).argmax(0), n)


def lanes_off_bars(ref: dict, got: dict, dtype, upto: torch.Tensor) -> int:
    """Lanes on which a recorded value of ``got`` lies outside the bars of
    ``compare_records`` around ``ref`` on some frame before ``upto [B]``."""
    frame = torch.arange(ref["valid"].shape[0], device=upto.device)[:, None]
    off = torch.zeros_like(ref["valid"])
    for _, ok, _, _, _ in record_checks(ref, got, dtype):
        off |= ~(ok.all(0) if ok.ndim == 3 else ok)
    return int((off & (frame < upto[None, :])).any(0).sum())


def derived_of_frames(args, recs: dict, cfg) -> dict:
    """``recs`` with its derived channels recomputed by the plain version
    (``engine.component.derived_c``) from each frame's own state and time:
    the recording build's frame epilogue, evaluated apart from the flight
    that led to the frame. ``args`` are the prepared inputs of ``recs``'
    lanes."""
    from erpl_monte_carlo_sim_tpu_torch.engine.component import derived_c, table_wind_fn
    from erpl_monte_carlo_sim_tpu_torch.kernels import flight_summary as fs

    wind_fn = table_wind_fn(args[1], fs.stored_wind(args[2], cfg))
    derived = {k: torch.empty_like(v) for k, v in recs["derived"].items()}
    n, chunk = recs["time"].shape[0], 1024
    for i in range(0, n, chunk):
        d = derived_c(args[0], cfg, wind_fn, recs["time"][i:i + chunk],
                      tuple(recs[k][i:i + chunk] for k in fs.FRAME_KEYS[1:]))
        for k, v in derived.items():
            v[i:i + chunk] = d[k]
    return {**recs, "derived": derived}


def terminal_is_summary(recs: dict, res: dict, tag: str) -> None:
    """Each lane's last valid frame is its summary's final state and flight
    time, bit for bit (NaN meets NaN): both come from the same registers."""
    stop = stop_frames(recs).long()[None]
    for k, o in (("time", "flight_time"), ("px", "final_px"), ("py", "final_py"),
                 ("pz", "final_pz"), ("vx", "final_vx"), ("vy", "final_vy"),
                 ("vz", "final_vz")):
        a, b = recs[k].gather(0, stop)[0], res[o]
        if not bool(((a == b) | (torch.isnan(a) & torch.isnan(b))).all()):
            raise AssertionError(f"{tag}: the terminal frame's {k} is not the summary's {o}")


def records_of(traj, n: int) -> dict:
    """The first ``n`` lanes of a ``Trajectory`` as ``flight_record``
    records: ``[T, n]`` tensors, the Euler angles split again."""
    def tm(x):
        return x[:n].movedim(0, 1)

    recs = {"time": tm(traj.time), "frac": tm(traj.propellant_fraction),
            "valid": tm(traj.valid)}
    for keys, leaf in ((("px", "py", "pz"), traj.position), (("vx", "vy", "vz"), traj.velocity),
                       (("qw", "qx", "qy", "qz"), traj.quaternion),
                       (("ox", "oy", "oz"), traj.angular_velocity)):
        recs.update({k: tm(leaf[..., i]) for i, k in enumerate(keys)})
    derived = {k: tm(v) for k, v in traj.derived.items() if k != "euler_angles"}
    if "euler_angles" in traj.derived:
        derived.update({k: tm(traj.derived["euler_angles"][..., i])
                        for i, k in enumerate(EULER_KEYS)})
    recs["derived"] = derived
    return recs


def golden_checks(s, golden: dict, dtype, apogee_rel: float, what: str,
                  n_steps: bool = False) -> None:
    """A single flight's ``FlightSummary`` (0-d leaves) against a golden
    flight of tests/golden at tests/test_flight.py's bars: the apogee within
    ``apogee_rel``, the rail exit speed within 1e-4 and its time within one
    rail step, not diverged; in float64 also the apogee time, range and
    flight time, the rail exit's angle of attack and position, and with
    ``n_steps`` the step count within 20. Raises naming the checks that
    fail."""
    apogee = float(s.apogee_altitude)
    checks = {
        "apogee": abs(apogee / golden["apogee_altitude"] - 1) <= apogee_rel,
        "rail_exit_speed": abs(float(s.rail.rail_exit_speed)
                               / golden["rail_exit_speed"] - 1) <= 1e-4,
        "rail_exit_time": abs(float(s.rail.rail_exit_time) - golden["rail_exit_time"]) <= 0.011,
        "not_diverged": not bool(s.diverged),
    }
    if dtype == torch.float64:
        rel = {"apogee_time": 1e-2, "range": 5e-3, "flight_time": 1e-2}
        for k, r in rel.items():
            checks[k] = abs(float(getattr(s, k)) / golden[k] - 1) <= r
        checks["rail_exit_aoa"] = abs(float(s.rail.rail_exit_angle_of_attack)
                                      - golden["rail_exit_aoa"]) <= 1e-6
        pos = s.rail.rail_exit_position.cpu().numpy()
        checks["rail_exit_position"] = bool(np.all(
            np.abs(pos - golden["rail_exit_position"])
            <= 1e-6 + 1e-3 * np.abs(golden["rail_exit_position"])))
        if n_steps:
            checks["n_steps"] = abs(int(s.n_steps) - (golden["n_steps"] - 1)) <= 20
    if not all(checks.values()):
        raise AssertionError(f"{what}: {checks}, apogee {apogee}")


def plain_data(obj):
    """An analysis as nested dicts, lists and NumPy arrays: dataclasses and
    accumulator objects (streams, reservoirs) become dicts of their fields,
    tensors arrays."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu().numpy()
    if dataclasses.is_dataclass(obj):
        return {f.name: plain_data(getattr(obj, f.name)) for f in dataclasses.fields(obj)}
    if isinstance(obj, dict):
        return {k: plain_data(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [plain_data(v) for v in obj]
    if hasattr(obj, "__dict__") and not isinstance(obj, type):
        return plain_data(vars(obj))
    return obj


def same_analysis(a: dict, b: dict, skip=("performance",)) -> None:
    """Two analyses equal bit for bit (NaN meets NaN) in every key but
    ``skip``; raises on the first difference."""
    if a.keys() != b.keys():
        raise AssertionError(f"analysis keys differ: {sorted(a.keys() ^ b.keys())}")
    for k in a:
        if k not in skip:
            np.testing.assert_equal(plain_data(a[k]), plain_data(b[k]), err_msg=k)


def golden_lanes(config: str):
    """The executed-reference Monte Carlo golden ``tests/golden/mc_{config}.jsonl``
    as ``(params, grid, wind, metrics)`` of NumPy arrays, the form
    ``inject_reference_lanes`` takes. ``density_mult`` is 1: the reference's
    density perturbation does not act (tests/test_mc_distribution_parity.py)."""
    with open(os.path.join(ROOT, "tests", "golden", f"mc_{config}.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    if any(r["failed"] for r in recs):
        raise ValueError(f"mc_{config}.jsonl holds failed reference runs")
    params = {k: np.array([r["params"][k] for r in recs])
              for k in ("mass_mult", "motor_thrust_mult", "motor_mdot_mult",
                        "pos_off", "vel_off", "att_off", "omg_off")}
    params["density_mult"] = np.ones(len(recs))
    metrics = {k: np.array([r["metrics"][k] for r in recs]) for k in recs[0]["metrics"]}
    return (params, np.array(recs[0]["wind_grid"]),
            np.array([r["wind_profile"] for r in recs]), metrics)


def threefry_cases() -> list:
    """Phase 17a's draws: ``(name, key, kind, shape, draw keywords)`` with
    ``key`` ``("seed", s)`` for ``PRNGKey(s)`` or ``("turb", s)`` for the
    sampler's turbulence key ``split(PRNGKey(s), 12)[11]``. A chain's golden
    keeps the lanes ``CHAIN_KEPT``."""
    f32, f64 = torch.float32, torch.float64
    cases = []
    for s in THREEFRY_SEEDS:
        key = ("seed", s)
        cases += [
            (f"split_{s}", key, "keys", (12,), {}),
            (f"fold_in_{s}", key, "keys", (), {"offset": 0x2B1A5C0}),
            (f"bits_{s}", key, "bits", (5, 100, 3), {}),
            (f"uniform_f32_{s}", key, "uniform", (5, 100, 3),
             {"dtype": f32, "minval": 0.0, "maxval": 5.0}),
            (f"uniform_f64_{s}", key, "uniform", (5, 100, 3),
             {"dtype": f64, "minval": 0.0, "maxval": 2.0 * math.pi}),
            (f"normal_f32_{s}", key, "normal", (5, 100, 3), {"dtype": f32}),
            (f"normal_f64_{s}", key, "normal", (5, 100, 3), {"dtype": f64}),
            (f"randint_{s}", key, "randint", (1000,), {"minval": 0, "maxval": 3}),
        ]
    turb = ("turb", 0)
    cases += [
        ("chain_synthesized_f32", turb, "normal", (100, 3),
         {"dtype": f32, "lanes": CHAIN_LANES, "sub": 1}),
        ("chain_forecast_f32", turb, "normal", (100, 3), {"dtype": f32, "lanes": CHAIN_LANES}),
        ("chain_synthesized_f64", turb, "normal", (100, 3),
         {"dtype": f64, "lanes": CHAIN_LANES, "sub": 1}),
    ]
    return cases


def threefry_key(spec, device):
    """A phase 17a case's key (``threefry_cases``)."""
    from erpl_monte_carlo_sim_tpu_torch import random

    what, s = spec
    key = random.prng_key(s, device)
    return random.split(key, 12)[11] if what == "turb" else key


def threefry_kept(name: str, out):
    """What the golden keeps of a case's draw: a chain's ``CHAIN_KEPT``
    lanes, everything else whole."""
    return out[list(CHAIN_KEPT)] if name.startswith("chain") else out


def threefry_error(got, want, kind: str, dtype) -> float:
    """A draw against another at phase 17's bars: keys, bits, uniforms and
    randint exact, float32 normals within ``NORMAL_ULPS`` ulp, float64 ones
    within ``NORMAL_F64_RTOL``. Returns the largest difference (ulps in
    float32, relative in float64, 0 where exact); raises past the bar."""
    got = np.asarray(got.cpu() if isinstance(got, torch.Tensor) else got)
    want = np.asarray(want.cpu() if isinstance(want, torch.Tensor) else want)
    if got.shape != want.shape:
        raise AssertionError(f"shape {got.shape}, expected {want.shape}")
    if kind != "normal":
        if not np.array_equal(got.astype(np.int64) if kind != "uniform" else got,
                              want.astype(np.int64) if kind != "uniform" else want):
            raise AssertionError(f"{kind} draws differ")
        return 0.0
    if dtype == torch.float32:
        err = float(np.abs(got.view(np.int32).astype(np.int64)
                           - want.view(np.int32).astype(np.int64)).max())
        bar = NORMAL_ULPS
    else:
        err = float((np.abs(got - want) / np.maximum(np.abs(want), 1e-300)).max())
        bar = NORMAL_F64_RTOL
    if not err <= bar:
        raise AssertionError(f"normals {err} apart (bar {bar})")
    return err


def analysis_arrays(analysis) -> dict:
    """An analysis' lanes and statistics as NumPy arrays (the golden's
    layout): the valid mask, every summary leaf, and the three metrics'
    mean, std, min, max and percentiles. The port's and the JAX package's
    analyses give the same keys."""
    out = {"valid_mask": np.asarray(analysis["valid_mask"])}
    for path, v in leaves(analysis["summary"]):
        out["summary" + path] = np.asarray(v)
    for m in METRICS:
        for s in ("mean", "std", "min", "max", "percentiles"):
            out[f"{m}.{s}"] = np.asarray(analysis[m][s], np.float64)
    return out


def analysis_error(got: dict, want: dict) -> float:
    """``analysis_arrays`` against a golden: the same keys, the valid mask
    and integer leaves exact, floats within ``ANALYSIS_RTOL`` (an absolute
    floor of ``ANALYSIS_RTOL`` times the leaf's largest magnitude). Returns
    the largest relative difference; raises past the bar."""
    if sorted(got) != sorted(want):
        raise AssertionError(f"analysis keys differ: {sorted(set(got) ^ set(want))}")
    worst = 0.0
    for k in want:
        a, b = np.asarray(got[k]), np.asarray(want[k])
        if a.shape != b.shape:
            raise AssertionError(f"{k}: shape {a.shape}, expected {b.shape}")
        if not np.issubdtype(b.dtype, np.floating):
            if not np.array_equal(a, b):
                raise AssertionError(f"{k} differs")
            continue
        scale = float(np.nanmax(np.abs(b))) if b.size and np.isfinite(b).any() else 0.0
        np.testing.assert_allclose(a, b, rtol=ANALYSIS_RTOL, atol=ANALYSIS_RTOL * scale,
                                   equal_nan=True, err_msg=k)
        fin = np.isfinite(b) & (b != 0)
        if fin.any():
            worst = max(worst, float((np.abs(a[fin] - b[fin]) / np.abs(b[fin])).max()))
    return worst


def kernel_and_plain(scene_b, ic_b, cfg):
    """Both versions on the same prepared inputs: ``(plain, kernel)``
    output dicts."""
    from erpl_monte_carlo_sim_tpu_torch.engine.batch import prepare_batch
    from erpl_monte_carlo_sim_tpu_torch.kernels import flight_summary as fs

    scene_nw, grid, wind, ics = prepare_batch(scene_b, ic_b)
    got = fs.flight_summary(scene_nw, grid, wind, ics, cfg)
    ref = fs.flight_summary_reference(scene_nw, grid, wind, ics, cfg)
    torch.cuda.synchronize()
    return ref, got


def plain_on_head(args, got, cfg, n=None):
    """The plain version on the first ``n`` lanes (all by default) of the
    prepared inputs ``args``, whose kernel outputs are ``got``: ``(plain
    out, kernel out on those lanes, plain ms)``."""
    from erpl_monte_carlo_sim_tpu_torch.kernels import flight_summary as fs

    lanes = args[3][0].shape[0]
    n = n or lanes
    part = head(args, lanes, n)
    plain_ms, ref = cuda_ms(lambda: fs.flight_summary_reference(*part, cfg))
    return ref, head(got, lanes, n), plain_ms


def drive(scene_b, ic_b, cfg):
    """One driven run through ``simulate_summary_batch`` (the user's entry
    point; launches counted from 0 just before it), then the kernel's own
    output dict on the same prepared inputs (the same launch again, not
    counted), which must be the driven run's: ``(args, kernel out,
    launches)``."""
    from erpl_monte_carlo_sim_tpu_torch.engine import simulate_summary_batch
    from erpl_monte_carlo_sim_tpu_torch.engine.batch import prepare_batch
    from erpl_monte_carlo_sim_tpu_torch.kernels import flight_summary as fs

    fs.launches = 0
    summary = simulate_summary_batch(scene_b, ic_b, cfg)
    launched = fs.launches
    if launched < 1:
        raise AssertionError("simulate_summary_batch did not launch the kernel")
    args = prepare_batch(scene_b, ic_b)
    got = fs.flight_summary(*args, cfg)
    if not torch.equal(got["apogee_altitude"].nan_to_num(-1.0),
                       summary.apogee_altitude.nan_to_num(-1.0)):
        raise AssertionError("the driven run and the kernel differ")
    return args, got, launched


# the outputs a flight's landing decides
LANDING_KEYS = ("range", "flight_time", "final_px", "final_py", "final_pz", "final_vx",
                "final_vy", "final_vz", "n_steps")


def landing_ties(ref, got, dtype):
    """Lanes on which the two versions disagree, beyond the bars, about the
    landing: its step (``n_steps``), time, position or velocity. In float32
    over thousands of steps the state drifts by some of its last bits, and
    a lane that touches the ground close to a step boundary lands a step
    earlier in one version than in the other."""
    rtol = RTOL[dtype]
    bad = got["n_steps"] != ref["n_steps"]
    bad |= (got["flight_time"] - ref["flight_time"]).abs() > (
        ATOL + rtol * ref["flight_time"].abs())
    for axes in (("final_px", "final_py", "final_pz"), ("final_vx", "final_vy", "final_vz")):
        norm = torch.linalg.vector_norm(torch.stack([ref[k] for k in axes]), dim=0)
        for k in axes:
            bad |= (got[k] - ref[k]).abs() > ATOL + rtol * norm
    return bad


# the rate of landing ties (``landing_ties``) on phase 7's float32 full
# flights: 305 of 16,384 lanes on an H100, the first 8,192 that seed 0 draws
# under jax.random's threefry and the first 8,192 the torch generator drew
# before it (153 and 152; 12 to 29 in a block of 1,024, and three of the
# torch generator's eight blocks past the 20 that the cap of 2% allowed),
# counted by ``python3 chip_smoke.py --landing-ties`` (``count_landing_ties``)
# run from each checkout
LANDING_TIE_RATE = 305 / 16_384


def tie_budget(n: int, alpha: float = 1e-4) -> int:
    """The most landing ties ``n`` lanes may hold: the count that a lane
    rate of ``LANDING_TIE_RATE`` exceeds with probability below ``alpha``
    (binomial)."""
    p, cdf = LANDING_TIE_RATE, 0.0
    for k in range(n + 1):
        cdf += math.comb(n, k) * p ** k * (1 - p) ** (n - k)
        if 1.0 - cdf < alpha:
            return k
    return n


def lanes_of(args, idx):
    """Prepared inputs ``args`` cut to the lanes ``idx``: every per-lane
    leaf indexed, shared ones kept."""
    lanes = args[3][0].shape[0]
    return map_tensors(
        lambda t: t[idx].contiguous() if t.ndim >= 1 and t.shape[0] == lanes else t, args)


def apogee_ties(args, ref, got, ties, cfg):
    """Landing ties (``ties``) whose apogee the two versions put at most a
    coarse step apart, where that is a tie: the plain version recorded in
    float64 on the same inputs (widened exactly), up to just past the later
    of the two, admits both as its apex. A frame is admitted when its
    altitude is within the float32 bar on the apogee's altitude (``ATOL +
    RTOL``) of the highest, so that the bar lets a float32 flight peak
    there. Where that leaves a lane out and ``ascent_q_threshold`` is set,
    the recording is flown again with the threshold moved by the float32
    bar up and down: the last bits of the dynamic pressure decide the step
    on which the coast turns coarse, and so which grid of steps the apex
    falls on; a frame admitted in either flight counts. Any other lane
    whose apogee time moved raises. Returns the tie lanes [B] (bool)."""
    from erpl_monte_carlo_sim_tpu_torch.kernels import flight_summary as fs

    coarse = cfg.dt * cfg.descent_dt_scale
    t_ref, t_got = ref["apogee_time"].double(), got["apogee_time"].double()
    apart = (t_got - t_ref).abs()
    cand = ties & (apart > 0) & (apart <= coarse * (1 + 1e-6))
    if not bool(cand.any()):
        return cand
    idx = torch.nonzero(cand).flatten()
    part = widened(lanes_of(args, idx))
    later = torch.maximum(t_ref, t_got)[idx] + ref["rail_exit_time"].double()[idx]
    rec_cfg = dataclasses.replace(cfg, max_time=min(cfg.max_time, float(later.max()) + 2 * coarse),
                                  record_stride=1, record_derived=False)
    wants = (t_ref[idx], t_got[idx])
    admitted = [torch.zeros_like(cand[idx]) for _ in wants]
    apexes = []
    moves = (0, 1, -1) if cfg.ascent_q_threshold > 0 else (0,)
    for s in moves:
        if s and bool((admitted[0] & admitted[1]).all()):
            break
        _, recs = fs.flight_record_reference(*part, dataclasses.replace(
            rec_cfg, ascent_q_threshold=cfg.ascent_q_threshold * (1 + s * RTOL[torch.float32])))
        # each frame's time since rail exit, the apogee time's axis
        t = torch.where(recs["valid"], recs["time"] - recs["time"][:1], math.inf)
        alt = torch.where(recs["valid"], recs["pz"], -math.inf)
        top = alt.max(0).values
        near = alt >= top - (ATOL + RTOL[torch.float32] * top.abs())
        for j, want in enumerate(wants):
            admitted[j] |= (near & ((t - want[None]).abs() <= 0.5 * cfg.dt)).any(0)
        apexes.append(t.gather(0, alt.argmax(0)[None])[0])
    ok = admitted[0] & admitted[1]
    if not bool(ok.all()):
        raise AssertionError(
            f"apogee times a step apart that are no tie: lanes {idx[~ok].tolist()}, apogee "
            f"times {wants[0][~ok].tolist()} (plain) and {wants[1][~ok].tolist()} (kernel), "
            f"float64 apexes {[a[~ok].tolist() for a in apexes]} (ascent_q_threshold moved "
            f"by {list(moves[:len(apexes)])} times the float32 bar)")
    return cand


def tied_landings(args, ref, got, cfg, what: str):
    """Full flights in float32 (prepared inputs ``args``, output dicts of
    the plain version ``ref`` and the kernel ``got``): every leaf at the
    bars on every lane but the landing ties (``landing_ties``), at most
    ``tie_budget`` of the lanes, whose landing times differ by at most two
    coarse steps and whose other leaves (apogee, maximum speed, rail exit,
    chute, divergence) stay at the bars, but for an apogee time that
    float64 shows to be a tie (``apogee_ties``): the float32 drift that
    moved the landing moved the apex across a step (ROADMAP F8). Returns
    ``(largest absolute difference off the ties, ties [B], the ties'
    landing-time differences, their range differences, the apogee ties)``."""
    ties = landing_ties(ref, got, torch.float32)
    kept = ~ties
    err = compare({k: v[kept] for k, v in ref.items()}, {k: v[kept] for k, v in got.items()},
                  torch.float32)
    coarse = cfg.dt * cfg.descent_dt_scale
    tied_apex = apogee_ties(args, ref, got, ties, cfg)
    tied_ref = {k: (got if k in LANDING_KEYS else ref)[k][ties] for k in ref}
    tied_ref["apogee_time"] = torch.where(tied_apex, got["apogee_time"],
                                          ref["apogee_time"])[ties]
    compare(tied_ref, {k: v[ties] for k, v in got.items()}, torch.float32)
    dt_time = (got["flight_time"] - ref["flight_time"]).abs()[ties]
    d_range = (got["range"] - ref["range"]).abs()[ties]
    if (int(ties.sum()) > tie_budget(ties.numel())
            or bool((dt_time > 2.0 * coarse * (1 + 1e-6)).any())):
        raise AssertionError(f"{what}: {int(ties.sum())} landing ties, landing times "
                             f"{dt_time.tolist()} apart")
    return err, ties, dt_time, d_range, tied_apex


def full_flights_against_plain(args, got, cfg, lanes, n=SLICE_LANES) -> dict:
    """Phase 7's check: the kernel against its plain version on the first
    ``n`` lanes of the run (prepared inputs ``args``, kernel outputs
    ``got``), flown to landing, in float32 as ``tied_landings`` holds them.
    The same flights in float64 (the inputs widened exactly): every leaf at
    the float64 bars on every lane."""
    from erpl_monte_carlo_sim_tpu_torch.kernels import flight_summary as fs

    ref, got_n, plain_ms = plain_on_head(args, got, cfg, n)
    part64 = map_tensors(lambda t: t.double() if t.is_floating_point() else t,
                         head(args, lanes, n))
    got64 = fs.flight_summary(*part64, cfg)
    plain64_ms, ref64 = cuda_ms(lambda: fs.flight_summary_reference(*part64, cfg))
    err, ties, dt_time, d_range, tied_apex = tied_landings(head(args, lanes, n), ref, got_n, cfg,
                                                           "full flights")
    return {"max_abs_err": err, "max_abs_err_lanes": int((~ties).sum()),
            "landing_ties": int(ties.sum()), "apogee_ties": int(tied_apex.sum()),
            "tie_flight_time_diff_max": float(dt_time.max()) if dt_time.numel() else 0.0,
            "tie_range_diff_max": float(d_range.max()) if d_range.numel() else 0.0,
            "plain_ms": plain_ms, "compared_n_steps_max": int(got_n["n_steps"].max()),
            "f64_max_abs_err": compare(ref64, got64, torch.float64), "f64_plain_ms": plain64_ms}


def guard_ties(ref, got, guard, dtype):
    """Lanes that the speed guard stops one step apart in the two versions,
    with a speed within the bar (``RTOL``) of the guard in either: there
    the last bits of the state, which the bars allow to differ, decide on
    which side of the guard a step's speed falls."""
    near = torch.minimum((got["max_speed"] - guard).abs(),
                         (ref["max_speed"] - guard).abs()) <= RTOL[dtype] * guard
    return ((got["n_steps"] - ref["n_steps"]).abs() == 1) & near


def rail_ties(args, ref, got, cfg, dtype):
    """Lanes whose rail exit the two versions put one rail step apart in
    float32 where that is a tie: the plain version flown in float64 on the
    same inputs (widened exactly), with the rail's length moved by the
    float32 bar (``RTOL``) down and up, leaves the rail on the one step and
    on the other. There the last bits of the along-rail distance, which the
    bars let differ, decide the step. Any other lane a step apart raises.
    Returns the tie lanes [B] (bool)."""
    from erpl_monte_carlo_sim_tpu_torch.kernels import flight_summary as fs

    t_ref, t_got = ref["rail_exit_time"].double(), got["rail_exit_time"].double()
    ties = ((t_got - t_ref).abs() - cfg.rail_dt).abs() <= 1e-3 * cfg.rail_dt
    if dtype != torch.float32:
        return torch.zeros_like(ties)
    if not bool(ties.any()):
        return ties
    idx = torch.nonzero(ties).flatten()
    part = widened(lanes_of(args, idx))
    # the rail phase ends well inside 1.5 s
    t64 = [fs.flight_summary_reference(*part, dataclasses.replace(
        cfg, max_time=min(cfg.max_time, 1.5), rail_length=cfg.rail_length * (1 + s * RTOL[dtype])
    ))["rail_exit_time"] for s in (-1, 1)]
    lo, hi = torch.minimum(t_ref[idx], t_got[idx]), torch.maximum(t_ref[idx], t_got[idx])
    tol = 1e-3 * cfg.rail_dt
    if not bool((((t64[0] - lo).abs() <= tol) & ((t64[1] - hi).abs() <= tol)).all()):
        raise AssertionError(f"rail exits a step apart that are no tie: lanes {idx.tolist()}, "
                             f"float64 at the rail's length -+{RTOL[dtype]}: "
                             f"{t64[0].tolist()}, {t64[1].tolist()}")
    return ties


def check_flag_run(name, what, got, nan_lane):
    """What each flag set must show beyond kernel = plain."""
    div = got["diverged"].bool()
    if name == "speed_guard":  # exactly the lanes that reached the guard stopped
        ok = bool(div.any()) and torch.equal(div, got["max_speed"] >= FLAG_SETS[name][0][
            "speed_guard"])
    elif name == "terminate_nonfinite":
        ok = not bool(div.any()) and bool(got["apogee_altitude"][nan_lane].isnan())
    elif name == "stall_limited_moments":
        ok = not bool(div.any()) and bool(
            (got["rail_exit_angle_of_attack"].abs() > math.radians(15.0)).any())
    else:
        ok = not bool(div.any())
    if what == "to landing":
        ok = ok and bool(got["parachute_deployed"].all()) and bool(
            (got["final_pz"] <= 0.5).all())
    if not ok:
        raise AssertionError(f"flag set {name} ({what}): diverged {int(div.sum())}")


def reference_filter(metrics):
    """The reference's physics-outlier bounds (tests/test_mc_distribution_parity.py)."""
    apo, rng, ft = metrics["apogee_altitude"], metrics["range"], metrics["flight_time"]
    return ((apo < 80000.0) & (apo > 100.0) & (rng < 200000.0) & (ft < 600.0)
            & np.isfinite(apo) & np.isfinite(rng) & np.isfinite(ft))


def certificates(dev) -> None:
    """Phase 8: the bars of tests/test_mc_distribution_parity.py's
    test_calm_lane_matched_parity and test_forecast_divergence_rate_parity,
    float64, every flight through the kernel."""
    from erpl_monte_carlo_sim_tpu_torch.engine import (InitialConditions, SimConfig,
                                                       simulate_summary_batch)
    from erpl_monte_carlo_sim_tpu_torch.kernels import flight_summary as fs
    from erpl_monte_carlo_sim_tpu_torch.mc import inject_reference_lanes, outlier_mask
    from erpl_monte_carlo_sim_tpu_torch.models import liquid_motor, nominal_scene, solid_motor

    f64 = torch.float64
    ic = InitialConditions.vertical_launch(dev, f64)

    def fly(config, motor, cfg):
        params, grid, wind, metrics = golden_lanes(config)
        scene_b, ic_b = inject_reference_lanes(nominal_scene(motor(dev, f64)), ic, params,
                                               grid, wind)
        fs.launches = 0
        s = simulate_summary_batch(scene_b, ic_b, cfg)
        if fs.launches < 1:
            raise AssertionError(f"the {config} certificate did not launch the kernel")
        valid = outlier_mask(s)[0].cpu().numpy()
        return s, valid, metrics, fs.launches

    s, _, ref, launched = fly("calm", solid_motor, SimConfig())
    apo = s.apogee_altitude.cpu().numpy()
    sane = np.isfinite(ref["apogee_altitude"]) & (ref["apogee_altitude"] < 80000.0)
    a, r = apo[sane], ref["apogee_altitude"][sane]
    ft, at = s.flight_time.cpu().numpy(), s.apogee_time.cpu().numpy()
    mft = sane & (ref["flight_time"] < 600.0)
    calm = {
        "sane": int(sane.sum()),
        "lane_rel": float(np.max(np.abs(a - r) / np.abs(r))),
        "mean_rel": abs(a.mean() / r.mean() - 1), "std_rel": abs(a.std() / r.std() - 1),
        "pct_rel": max(abs(np.percentile(a, q) / np.percentile(r, q) - 1)
                       for q in (5, 25, 50, 75, 95)),
        "apogee_time_abs": float(np.abs(at[sane] - ref["apogee_time"][sane]).max()),
        "flight_time_mean_rel": abs(ft[mft].mean() / ref["flight_time"][mft].mean() - 1),
    }
    ok = (calm["sane"] >= 450 and calm["lane_rel"] <= 1e-4 and calm["mean_rel"] < 1e-4
          and calm["std_rel"] < 1e-3 and calm["pct_rel"] < 1e-4
          and calm["apogee_time_abs"] < 0.1 and calm["flight_time_mean_rel"] < 5e-3)
    phase("8 calm certificate", lanes=apo.size, launches=launched, passed=ok, **calm)
    if not ok:
        raise AssertionError(f"calm certificate: {calm}")

    s, mine, ref, launched = fly("forecast", liquid_motor, SimConfig())
    refpass = reference_filter(ref)
    both = mine & refpass
    worst = {}
    for ch, leaf, tol in (("apogee_altitude", s.apogee_altitude, 1e-8),
                          ("apogee_time", s.apogee_time, 1e-9),
                          ("flight_time", s.flight_time, 1e-9),
                          ("range", s.range, 1e-7), ("max_speed", s.max_speed, 1e-6),
                          ("rail_exit_speed", s.rail.rail_exit_speed, 1e-9),
                          ("rail_exit_time", s.rail.rail_exit_time, 1e-9)):
        v, w = leaf.cpu().numpy()[both], ref[ch][both]
        worst[ch] = float(np.max(np.abs(v - w) / np.abs(w))) if both.any() else 0.0
        worst[ch + "_ok"] = bool(np.all(np.abs(v - w) <= tol * np.abs(w)))
    s2, valid2, _, launched2 = fly("forecast", liquid_motor,
                                   SimConfig(energy_consistent_aero=True))
    forecast = {"ref_pass": int(refpass.sum()), "parity_pass": int(mine.sum()),
                "overlap": int(both.sum()), "energy_valid": int(valid2.sum()),
                "energy_diverged": int(s2.diverged.sum())}
    ok = (forecast["ref_pass"] < 0.1 * mine.size
          and abs(forecast["parity_pass"] - forecast["ref_pass"]) <= 6
          and forecast["overlap"] >= forecast["ref_pass"] - 3 and forecast["overlap"] >= 5
          and forecast["energy_valid"] == mine.size and forecast["energy_diverged"] == 0
          and all(v for k, v in worst.items() if k.endswith("_ok")))
    phase("8 forecast certificate", lanes=mine.size, launches=launched + launched2,
          passed=ok, **forecast,
          **{k: v for k, v in worst.items() if not k.endswith("_ok")})
    if not ok:
        raise AssertionError(f"forecast certificate: {forecast} {worst}")


def slab_reference(mc, ic, n, slab, seed):
    """What a slabbed run's per-lane arrays must be: one
    ``simulate_summary_batch`` call per slab on
    ``sample_dispersions(fold_in(PRNGKey(seed), k))``, the first ``n`` lanes
    concatenated: ``(metrics, valid, reasons)``."""
    from erpl_monte_carlo_sim_tpu_torch.engine import simulate_summary_batch
    from erpl_monte_carlo_sim_tpu_torch.mc import outlier_mask, sample_dispersions
    from erpl_monte_carlo_sim_tpu_torch import random
    from erpl_monte_carlo_sim_tpu_torch.mc.slab_accumulators import PREFIX_METRICS

    metrics, valid, reasons = {k: [] for k in PREFIX_METRICS}, [], []
    for k in range(-(-n // slab)):
        key = random.fold_in(random.prng_key(seed, mc.device), k)
        scene_b, ic_b, _ = sample_dispersions(key, mc.scene, ic, mc.uncertainty_params, slab,
                                              wind_grid_points=mc.wind_grid_points,
                                              wind_grid_top=mc.wind_grid_top)
        s = simulate_summary_batch(scene_b, ic_b, mc.sim_config)
        v, r = outlier_mask(s, mc.bounds)
        take = min(slab, n - k * slab)
        for key in metrics:
            metrics[key].append(getattr(s, key)[:take].cpu().numpy())
        valid.append(v[:take].cpu().numpy())
        reasons.append(r[:take].cpu().numpy())
    return ({k: np.concatenate(v) for k, v in metrics.items()}, np.concatenate(valid),
            np.concatenate(reasons))


@contextlib.contextmanager
def slab_stages():
    """The slab loop's draw and flight, each slab, with the card
    synchronized before and after: yields the list it fills with ``(stage,
    start, end)`` marks (``time.perf_counter``), and before each draw
    ``("rss", rss_mb(), 0)``."""
    from erpl_monte_carlo_sim_tpu_torch.mc import analyzer as analyzer_mod

    marks = []
    draw, fly = analyzer_mod._draw_slab, analyzer_mod.simulate_summary_batch

    def timed(stage, fn):
        def call(*a, **kw):
            torch.cuda.synchronize()
            if stage == "sampling":
                marks.append(("rss", rss_mb(), 0.0))
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            torch.cuda.synchronize()
            marks.append((stage, t0, time.perf_counter()))
            return out
        return call

    analyzer_mod._draw_slab = timed("sampling", draw)
    analyzer_mod.simulate_summary_batch = timed("kernel", fly)
    try:
        yield marks
    finally:
        analyzer_mod._draw_slab, analyzer_mod.simulate_summary_batch = draw, fly


def stage_split(marks, end: float) -> tuple:
    """``slab_stages``' marks as ``(sampling ms, kernel ms, host ms)`` per
    slab, the host's share being the readback and the accumulators from the
    kernel's end to the next slab's draw (the last slab's runs to ``end``,
    the run's end, so it includes the final statistics)."""
    spans = {stage: [(a, b) for s, a, b in marks if s == stage]
             for stage in ("sampling", "kernel")}
    next_start = [a for a, _ in spans["sampling"][1:]] + [end]
    return ([1e3 * (b - a) for a, b in spans["sampling"]],
            [1e3 * (b - a) for a, b in spans["kernel"]],
            [1e3 * (nxt - b) for (_, b), nxt in zip(spans["kernel"], next_start)])


def staged_run(mc, ic, n, **kw):
    """``run_monte_carlo(n_samples=n, **kw)`` split by ``slab_stages``:
    ``(sampling ms, kernel ms, host ms)`` per slab and the wall."""
    with slab_stages() as marks:
        t0 = time.perf_counter()
        mc.run_monte_carlo(ic, n_samples=n, seed=0, **kw)
        end = time.perf_counter()
    return (*stage_split(marks, end), end - t0)


def large_runs(dev, ic) -> tuple:
    """Phase 9; returns each run's kernel launches and 9a's analysis."""
    import tempfile

    from erpl_monte_carlo_sim_tpu_torch.engine import SimConfig
    from erpl_monte_carlo_sim_tpu_torch.kernels import flight_summary as fs
    from erpl_monte_carlo_sim_tpu_torch.mc import MonteCarloAnalyzer, exceedance_from_analysis
    from erpl_monte_carlo_sim_tpu_torch.mc import analyzer as analyzer_mod
    from erpl_monte_carlo_sim_tpu_torch.mc.analyzer import _host_stats
    from erpl_monte_carlo_sim_tpu_torch.mc.stats import PERCENTILES
    from erpl_monte_carlo_sim_tpu_torch.models import liquid_motor

    cfg = SimConfig(max_time=WINDOW)
    mc = MonteCarloAnalyzer(motor=liquid_motor(dev), sim_config=cfg)
    launches = {}

    def driven(tag, slabs, fn):
        """One run of the main path with the launches counted from 0, which
        must be one a slab it flies. Returns the analysis and the wall."""
        torch.cuda.synchronize()
        fs.launches = 0
        t0 = time.time()
        out = fn()
        wall = time.time() - t0
        launches[tag] = fs.launches
        if fs.launches != slabs:
            raise AssertionError(f"phase {tag}: {fs.launches} launches for {slabs} slabs")
        return out, wall

    # ---- 9a: 4 slabs, the per-lane arrays of 4 single calls
    a, wall = driven("9a", 4, lambda: mc.run_monte_carlo(ic, n_samples=LARGE_LANES, seed=0))
    metrics, valid, reasons = slab_reference(mc, ic, LARGE_LANES, BENCH_LANES, 0)
    for k, v in metrics.items():
        if not np.array_equal(a["metrics"][k], v, equal_nan=True):
            raise AssertionError(f"9a: metrics.{k} differ from the single calls")
    if not (np.array_equal(a["valid_mask"], valid) and np.array_equal(a["reasons"], reasons)):
        raise AssertionError("9a: masks differ from the single calls")
    for k in ("apogee_altitude", "range", "flight_time"):
        np.testing.assert_equal(a[k], _host_stats(metrics[k], valid), err_msg=f"9a {k}")
    phase("9a large run", lanes=LARGE_LANES, slabs=4, launches=launches["9a"],
          wall_s=f"{wall:.3f}", lanes_per_s=f"{LARGE_LANES / wall:.1f}",
          n_valid=a["n_samples"], apogee_mean=a["apogee_altitude"]["mean"],
          single_calls_equal=True)
    sampling, kernel, host, staged_wall = staged_run(mc, ic, LARGE_LANES)
    phase("9a per-slab split", wall_s=f"{staged_wall:.3f}",
          sampling_ms=json.dumps([round(x, 3) for x in sampling]),
          kernel_ms=json.dumps([round(x, 3) for x in kernel]),
          host_ms=json.dumps([round(x, 3) for x in host]))

    # ---- 9b: 32 slabs, streaming; the prefix keeps every lane
    mc_s = MonteCarloAnalyzer(motor=liquid_motor(dev), sim_config=cfg,
                              stats_stream_threshold=STREAM_THRESHOLD,
                              metrics_sample_cap=STREAM_LANES)
    b, wall_b = driven("9b", 32, lambda: mc_s.run_monte_carlo(ic, n_samples=STREAM_LANES,
                                                              seed=0))
    if not b["metrics_is_sample"] or b["valid_mask"].size != STREAM_LANES:
        raise AssertionError("9b: not a streaming run that kept every lane")
    worst = {"mean_rel": 0.0, "std_rel": 0.0, "rank": 0.0, "value_sigma": 0.0,
             "flight_time_rel": 0.0, "exceed": 0.0}
    for k in ("apogee_altitude", "range", "flight_time"):
        blk, stream = b[k], b["streams"][k]
        vals = b["metrics"][k][b["valid_mask"]].astype(np.float64)
        vals = np.sort(vals[np.isfinite(vals)])
        if stream.is_exact or stream.n != vals.size:
            raise AssertionError(f"9b {k}: the stream kept {stream.n} of {vals.size} lanes "
                                 f"(exact={stream.is_exact})")
        sigma = vals.std()
        worst["mean_rel"] = max(worst["mean_rel"], abs(blk["mean"] / vals.mean() - 1))
        worst["std_rel"] = max(worst["std_rel"], abs(blk["std"] / sigma - 1) if sigma else 0.0)
        if blk["min"] != vals[0] or blk["max"] != vals[-1]:
            raise AssertionError(f"9b {k}: min/max differ")
        exact = np.percentile(vals, PERCENTILES)
        for q, est, ex, (lo, hi) in zip(PERCENTILES, blk["percentiles"], exact,
                                        blk["percentile_ci"]):
            if not lo <= ex <= hi:
                raise AssertionError(f"9b {k} p{q}: interval [{lo}, {hi}] misses {ex}")
            if k == "flight_time":
                worst["flight_time_rel"] = max(worst["flight_time_rel"], abs(est / ex - 1))
                continue
            below = np.searchsorted(vals, est, "left") / vals.size
            upto = np.searchsorted(vals, est, "right") / vals.size
            worst["rank"] = max(worst["rank"], max(below - q / 100, q / 100 - upto, 0.0))
            if sigma > 0:
                worst["value_sigma"] = max(worst["value_sigma"], abs(est - ex) / sigma)
        if k != "flight_time":
            ts = np.percentile(vals, (10, 50, 90))
            for row, t in zip(exceedance_from_analysis(b, k, ts), ts):
                if row["method"] != "sketch":
                    raise AssertionError(f"9b {k}: exceedance by {row['method']}")
                worst["exceed"] = max(worst["exceed"], abs(row["probability"]
                                                           - np.mean(vals > t)))
    ok = (worst["mean_rel"] <= 1e-12 and worst["std_rel"] <= 1e-9 and worst["rank"] <= 1e-3
          and worst["value_sigma"] <= 1e-3 and worst["flight_time_rel"] <= 1e-6
          and worst["exceed"] <= 1e-3)
    big_slab = 4 * BENCH_LANES
    _, wall_big = driven("9b 1M slabs", 8, lambda: mc_s.run_monte_carlo(
        ic, n_samples=STREAM_LANES, seed=0, lane_slab=big_slab))
    phase("9b streaming", lanes=STREAM_LANES, slabs=32, launches=launches["9b"],
          wall_s=f"{wall_b:.3f}", lanes_per_s=f"{STREAM_LANES / wall_b:.1f}",
          wall_s_1m_slabs=f"{wall_big:.3f}", lanes_per_s_1m_slabs=f"{STREAM_LANES / wall_big:.1f}",
          launches_1m_slabs=launches["9b 1M slabs"], passed=ok, **worst)
    if not ok:
        raise AssertionError(f"9b: {worst}")
    del b

    # ---- 9c: run (a) killed after slab 2, resumed from its checkpoint
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "run.ckpt.npz")
        draw, calls = analyzer_mod._draw_slab, []

        def dying(*args, **kw):
            if len(calls) == 2:
                raise RuntimeError("simulated crash")
            calls.append(1)
            return draw(*args, **kw)

        analyzer_mod._draw_slab = dying
        try:
            mc.run_monte_carlo(ic, n_samples=LARGE_LANES, seed=0, checkpoint_path=path,
                               checkpoint_every=1)
            raise AssertionError("9c: the run did not stop at its third draw")
        except RuntimeError as e:
            if "simulated crash" not in str(e):
                raise
        finally:
            analyzer_mod._draw_slab = draw
        kept = os.path.exists(path)
        c, wall_c = driven("9c", 2, lambda: mc.run_monte_carlo(
            ic, n_samples=LARGE_LANES, seed=0, checkpoint_path=path, checkpoint_every=1))
        same_analysis(c, a)
        if not kept or os.path.exists(path):
            raise AssertionError(f"9c: checkpoint written {kept}, left after the run "
                                 f"{os.path.exists(path)}")
    phase("9c resume", lanes=LARGE_LANES, launches=launches["9c"], wall_s=f"{wall_c:.3f}",
          equal_to_9a=True)

    # ---- 9d: run_to_precision, met after 2 or 3 slabs
    hist = [row["apogee_altitude"]["stderr"] for row in a["convergence"]]
    target = hist[2]
    stop = next(i for i, x in enumerate(hist) if x <= target) + 1
    if stop not in (2, 3):
        raise AssertionError(f"9d: the stderr history {hist} stops at slab {stop}")
    d, wall_d = driven("9d", stop, lambda: mc.run_to_precision(
        ic, criteria=[{"metric": "apogee_altitude", "mean_stderr": target}],
        max_samples=2 * LARGE_LANES, seed=0))
    seq = d.pop("sequential")
    if seq["n_used"] != stop * BENCH_LANES or not seq["satisfied"]:
        raise AssertionError(f"9d: {seq}")
    same_analysis(d, mc.run_monte_carlo(ic, n_samples=seq["n_used"], seed=0))
    phase("9d run_to_precision", target_stderr_m=target, n_used=seq["n_used"],
          launches=launches["9d"], wall_s=f"{wall_d:.3f}", equal_to_run_monte_carlo=True)
    return launches, a


def resimulated(mc, ids, tag: str, want_launches: int):
    """The main path of phase 10: ``resimulate_trajectories(ids)``, the
    launches counted from 0 just before it and read just after: the
    recording build's flight and its derived pass, ``want_launches`` each.
    Returns ``(summary, trajectory, launches, wall s)``."""
    from erpl_monte_carlo_sim_tpu_torch.kernels import flight_summary as fs

    torch.cuda.synchronize()
    fs.launches = fs.derived_launches = 0
    t0 = time.time()
    s, traj = mc.resimulate_trajectories(ids)
    torch.cuda.synchronize()
    wall, launched = time.time() - t0, fs.launches
    if launched != want_launches or fs.derived_launches != want_launches:
        raise AssertionError(f"phase {tag}: {launched} launches of the recording build and "
                             f"{fs.derived_launches} of its derived pass, {want_launches} "
                             "each expected")
    return s, traj, launched, wall


def same_records(recs: dict, tag: str) -> str:
    """The digest of a recording (``records_digest``), which must be
    ``RECORD_DIGESTS[tag]``, the recording build's before its redesign."""
    got = records_digest(recs)
    if got != RECORD_DIGESTS[tag]:
        raise AssertionError(f"{tag}: the records' digest {got} is not "
                             f"{RECORD_DIGESTS[tag]}")
    return got


def same_summary(summary, run: dict, ids, tag: str) -> None:
    """A re-simulated ``FlightSummary`` equals the run's lanes ``ids`` bit
    for bit (NaN meets NaN): every leaf of a single call's ``summary``, or a
    slabbed run's ``metrics``."""
    from erpl_monte_carlo_sim_tpu_torch.utils.convert import to_numpy

    got = to_numpy(summary)
    if run["summary"] is not None:
        for (path, a), (_, b) in zip(leaves(got), leaves(run["summary"])):
            np.testing.assert_array_equal(a, np.asarray(b)[ids], err_msg=f"{tag} {path}")
    else:
        for k, v in run["metrics"].items():
            np.testing.assert_array_equal(getattr(got, k), v[ids], err_msg=f"{tag} {k}")


def recording_row(case: dict, ms: float, digest_: str) -> dict:
    """A kernels-JSON row of a recording build: ``ms``, the time of
    ``flight_record`` (its launches and the frames' gather), and the bound's
    share of it; from ``measure.record_case`` on the same inputs, ``build_ms`` (the build's launches alone, its flight and its
    derived pass, by CUDA events), the latency floor and its share of
    ``build_ms``, the bound, the flight kernel's registers, spills, threads
    per block and warps per SM; the records' digest."""
    keys = ("lanes", "frames", "channels", "bound_ms", "bound_by", "latency_floor_ms",
            "share_of_floor", "step_instructions", "max_steps", "regs", "spill_bytes",
            "threads_per_block", "warps_per_sm")
    return {**{k: case[k] for k in keys}, "ms": ms, "share_of_bound": case["bound_ms"] / ms,
            "build_ms": case["ms"], "digest": digest_}


def stop_frames(recs) -> torch.Tensor:
    """Each lane's last valid frame ``[B]``."""
    return recs["valid"].sum(0) - 1


ROW_KEYS = ("ms", "build_ms", "bound_ms", "share_of_bound", "latency_floor_ms",
            "share_of_floor", "regs", "spill_bytes", "threads_per_block", "warps_per_sm",
            "frames", "channels", "digest")


def recordings(dev, ic, mc4, run4, record_usage, record_flags) -> dict:
    """Phase 10; returns the kernels-JSON rows of the recording builds and
    of the derived pass."""
    from erpl_monte_carlo_sim_tpu_torch.engine import (InitialConditions, SimConfig,
                                                       simulate_flight_batch)
    from erpl_monte_carlo_sim_tpu_torch.engine.batch import (prepare_batch,
                                                             simulate_envelope_batch,
                                                             trajectory_of)
    from erpl_monte_carlo_sim_tpu_torch.kernels import flight_summary as fs
    from erpl_monte_carlo_sim_tpu_torch.mc import (EnvelopeAccumulator, EnvelopeConfig,
                                                   MonteCarloAnalyzer)
    from erpl_monte_carlo_sim_tpu_torch.models import liquid_motor

    f32, f64 = torch.float32, torch.float64
    rows = {}
    # the step's SASS instructions of each recording build, for its latency floor
    sass = {name: step_instructions(sass_listing(fs.build(flags)[0]))
            for name, flags in record_flags.items()}
    clock = sm_clock_mhz()

    def case(args, cfg, name):
        return record_case(fs, args, cfg, 3, record_usage[name], sass[name], clock)

    # ---- 10a: 256 lanes of phase 4's run, window
    ids = spread(BENCH_LANES, RESIM_LANES)
    s, traj, launched, wall = resimulated(mc4, ids, "10a", 1)
    derived_launched = fs.derived_launches
    same_summary(s, run4, ids, "10a")
    cfg = mc4.sim_config
    args = prepare_batch(*mc4._select_lanes(ids))
    fs.flight_record(*args, cfg)  # warm-up
    ms, (res, recs) = cuda_ms(lambda: fs.flight_record(*args, cfg), reps=3)
    if not torch.equal(recs["pz"], records_of(traj, RESIM_LANES)["pz"]):
        raise AssertionError("10a: the timed recording is not the re-simulated one")
    terminal_is_summary(recs, res, "10a")
    dig = same_records(recs, "10a f32")
    part = head(args, RESIM_LANES, HELD_LANES)
    plain_ms, (ref, ref_recs) = cuda_ms(lambda: fs.flight_record_reference(*part, cfg))
    err = compare(ref, head(res, RESIM_LANES, HELD_LANES), f32)
    frame_err = compare_records(ref_recs, records_of(traj, HELD_LANES), f32)
    # the derived pass against the plain derived_c on the same frames
    n = int(stop_frames(recs).max()) + 1
    stored = map_tensors(lambda t: t[:n], recs)
    derived_plain_ms, plain_derived = cuda_ms(lambda: derived_of_frames(args, stored, cfg))
    derived_err = compare_records(plain_derived, stored, f32)
    del stored, plain_derived
    args64 = widened(args)
    fs.flight_record(*args64, cfg)  # warm-up
    ms64, (got64, recs64) = cuda_ms(lambda: fs.flight_record(*args64, cfg), reps=3)
    dig64 = same_records(recs64, "10a f64")
    plain64_ms, (ref64, ref_recs64) = cuda_ms(lambda: fs.flight_record_reference(*args64, cfg))
    err64 = max(compare(ref64, got64, f64), compare_records(ref_recs64, recs64, f64))
    del res, recs, got64, recs64, ref_recs, ref_recs64, traj
    torch.cuda.empty_cache()
    timed, timed64 = case(args, cfg, "parity"), case(args64, cfg, "parity")
    row = recording_row(timed, ms, dig)
    row.update(launches=launched, plain_ms=plain_ms, max_abs_err=err,
               max_abs_err_lanes=HELD_LANES, frames_max_abs_err=frame_err,
               f64=recording_row(timed64, ms64, dig64))
    row["f64"].update(plain_ms=plain64_ms, max_abs_err=err64)
    rows["window"] = row
    derived = {**timed["derived"], "launches": derived_launched, "plain_ms": derived_plain_ms,
               "max_abs_err": derived_err, "f64": timed64["derived"]}
    phase("10a re-simulated window", lanes=RESIM_LANES, launches=launched,
          derived_launches=derived_launched, wall_s=f"{wall:.3f}", summary_equal_to_run=True,
          held_lanes=HELD_LANES, max_abs_err=err, frames_max_abs_err=frame_err,
          plain_ms=f"{plain_ms:.1f}", f64_lanes=RESIM_LANES, f64_max_abs_err=err64,
          f64_ms=f"{ms64:.3f}", f64_build_ms=f"{timed64['ms']:.3f}",
          f64_plain_ms=f"{plain64_ms:.1f}", f64_latency_floor_ms=timed64["latency_floor_ms"],
          f64_digest=dig64, **{k: row[k] for k in ROW_KEYS})
    del args, args64
    torch.cuda.empty_cache()

    # ---- 10b: 256 stabilized full flights of phase 7's run, to landing
    cfg7 = flag_set("full_flights")[0]
    mc7 = MonteCarloAnalyzer(motor=liquid_motor(dev), sim_config=cfg7)
    run7 = mc7.run_monte_carlo(ic, n_samples=BENCH_LANES, seed=0)
    s, traj, launched, wall = resimulated(mc7, ids, "10b", 1)
    launched_derived = fs.derived_launches
    derived_launched += launched_derived
    same_summary(s, run7, ids, "10b")
    args = prepare_batch(*mc7._select_lanes(ids))
    ms, (res, recs) = cuda_ms(lambda: fs.flight_record(*args, cfg7))
    dig = same_records(recs, "10b f32")
    steps = res["n_steps"]
    if not (bool(res["parachute_deployed"].all()) and bool((res["final_pz"] <= 0.5).all())):
        raise AssertionError("10b: not every lane landed under its chute")
    if not torch.equal(recs["pz"], records_of(traj, RESIM_LANES)["pz"]):
        raise AssertionError("10b: the timed recording is not the re-simulated one")
    terminal_is_summary(recs, res, "10b")
    # float32 to landing, 64 lanes: the summaries as phase 7 holds them; the
    # frames at the bars up to each lane's float32 horizon (and, on a
    # landing tie, before the earlier of the two stop frames, at most 3
    # apart); the frame epilogue at the bars on every frame to landing; and
    # the same lanes in float64 to landing at rtol 5e-7
    part = head(args, RESIM_LANES, HELD_LANES)
    plain_ms, (ref, ref_recs) = cuda_ms(lambda: fs.flight_record_reference(*part, cfg7))
    part64 = widened(part)
    fs.flight_record(*part64, cfg7)  # warm-up
    ms64, (got64, recs64) = cuda_ms(lambda: fs.flight_record(*part64, cfg7))
    dig64 = same_records(recs64, "10b f64")
    plain64_ms, (ref64, ref_recs64) = cuda_ms(lambda: fs.flight_record_reference(*part64, cfg7))
    err64 = max(compare(ref64, got64, f64), compare_records(ref_recs64, recs64, f64))
    got_recs = records_of(traj, HELD_LANES)
    err, ties, dt_time, _, _ = tied_landings(part, ref, head(res, RESIM_LANES, HELD_LANES), cfg7,
                                             "10b")
    stop_ref, stop_got = stop_frames(ref_recs), stop_frames(got_recs)
    apart = (stop_ref - stop_got).abs()
    if bool((apart[~ties] != 0).any()) or int(apart.max()) > 3:
        raise AssertionError(f"10b: stop frames {apart.tolist()} apart, landing ties "
                             f"{ties.nonzero().flatten().tolist()}")
    horizon = f32_horizon(ref_recs, ref_recs64)
    landed = torch.minimum(stop_ref, stop_got)
    # what the horizon leaves out: lanes whose float32 flight leaves its
    # float64 flight's bars before landing, lanes on which the two versions
    # part before landing
    leave_f64 = lanes_off_bars(ref_recs64, ref_recs, f32, landed)
    leave_plain = lanes_off_bars(ref_recs, got_recs, f32, landed)
    upto = torch.where(ties, torch.minimum(horizon, landed), horizon)
    frame = torch.arange(ref_recs["valid"].shape[0], device=dev)[:, None]
    keep = frame < upto[None, :]
    frame_err = compare_records(ref_recs, got_recs, f32, keep=keep)
    held_frames = int((keep & got_recs["valid"]).sum())
    n = int(stop_got.max()) + 1
    got_recs = map_tensors(lambda t: t[:n], got_recs)
    epilogue_err = compare_records(derived_of_frames(part, got_recs, cfg7), got_recs, f32)
    del ref_recs, ref_recs64, got_recs, keep, recs, recs64, traj
    torch.cuda.empty_cache()
    timed, timed64 = case(args, cfg7, "full_flights"), case(part64, cfg7, "full_flights")
    row = recording_row(timed, ms, dig)
    row.update(launches=launched, plain_ms=plain_ms, max_abs_err=err,
               max_abs_err_lanes=HELD_LANES - int(ties.sum()), frames_max_abs_err=frame_err,
               frames_held=held_frames, frames_valid=int((stop_got + 1).sum()),
               f32_horizon_median=float(horizon.double().median()),
               f32_lanes_leaving_f64=leave_f64, lanes_leaving_plain=leave_plain,
               epilogue_max_abs_err=epilogue_err, landing_ties=int(ties.sum()),
               tie_flight_time_diff_max=float(dt_time.max()) if dt_time.numel() else 0.0,
               median_n_steps=float(steps.double().median()), max_n_steps=int(steps.max()),
               f64=recording_row(timed64, ms64, dig64))
    row["f64"].update(plain_ms=plain64_ms, max_abs_err=err64)
    rows["full_flights"] = row
    derived.update(launches=derived_launched, full_flights=timed["derived"],
                   full_flights_f64=timed64["derived"], full_flights_max_abs_err=epilogue_err)
    phase("10b re-simulated full flights", lanes=RESIM_LANES, launches=launched,
          derived_launches=launched_derived, wall_s=f"{wall:.3f}",
          summary_equal_to_run=True, held_lanes=HELD_LANES,
          landing_ties=row["landing_ties"], max_abs_err=err, frames_max_abs_err=frame_err,
          **{k: row[k] for k in ("frames_held", "frames_valid", "f32_horizon_median",
                                 "f32_lanes_leaving_f64", "lanes_leaving_plain",
                                 "epilogue_max_abs_err")},
          plain_ms=f"{plain_ms:.1f}", f64_held_lanes=HELD_LANES, f64_max_abs_err=err64,
          f64_ms=f"{ms64:.3f}", f64_build_ms=f"{timed64['ms']:.3f}",
          f64_plain_ms=f"{plain64_ms:.1f}", f64_latency_floor_ms=timed64["latency_floor_ms"],
          f64_digest=dig64, **{k: row[k] for k in ROW_KEYS + ("median_n_steps", "max_n_steps")})
    phase("10 derived pass", launches=derived_launched, max_abs_err=derived_err,
          plain_ms=f"{derived_plain_ms:.3f}", full_flights_max_abs_err=epilogue_err,
          **{k: derived[k] for k in ("ms", "bound_ms", "bound_by", "share_of_bound", "frames",
                                     "regs", "spill_bytes", "threads_per_block",
                                     "warps_per_sm")},
          full_flights_ms=derived["full_flights"]["ms"],
          full_flights_bound_ms=derived["full_flights"]["bound_ms"],
          f64_ms=derived["f64"]["ms"], full_flights_f64_ms=derived["full_flights_f64"]["ms"])
    rows["derived"] = derived
    del args, res, mc7, run7, part64, got64
    torch.cuda.empty_cache()

    # ---- 10c: one lane of each slab of 9a's run
    mc9 = MonteCarloAnalyzer(motor=liquid_motor(dev), sim_config=SimConfig(max_time=WINDOW))
    run9 = mc9.run_monte_carlo(ic, n_samples=LARGE_LANES, seed=0)
    ids9 = np.array([7, BENCH_LANES + 1234, 2 * BENCH_LANES + 99_999, 4 * BENCH_LANES - 1])
    s, _, launched9, wall = resimulated(mc9, ids9, "10c", 4)
    derived["launches"] += fs.derived_launches
    same_summary(s, run9, ids9, "10c")
    phase("10c re-simulated slabbed", lanes=ids9.tolist(), launches=launched9,
          wall_s=f"{wall:.3f}", metrics_equal_to_run=True)
    del mc9, run9

    # ---- 10d: envelopes, float64
    mce = MonteCarloAnalyzer(motor=liquid_motor(dev, f64), sim_config=SimConfig(max_time=WINDOW))
    mce.run_monte_carlo(InitialConditions.vertical_launch(dev, f64), n_samples=ENVELOPE_LANES,
                        seed=0)
    env = EnvelopeConfig()
    half = ENVELOPE_LANES // 2
    torch.cuda.synchronize()
    fs.launches = 0
    t0 = time.time()
    frm = mce.flight_envelope(n_lanes=ENVELOPE_LANES, chunk=half, env_config=env)
    wall_f, launched_f = time.time() - t0, fs.launches
    t0 = time.time()
    inl = mce.flight_envelope(n_lanes=ENVELOPE_LANES, chunk=half, env_config=env, inline=True)
    wall_i = time.time() - t0
    for ch in env.channels:
        a, b = frm["channels"][ch], inl["channels"][ch]
        if a["n"] != b["n"]:
            raise AssertionError(f"10d {ch}: in-loop counts differ from the frame path's")
        for key, rtol, atol in (("min", 1e-12, 0.0), ("max", 1e-12, 0.0), ("mean", 1e-9, 1e-12),
                                ("std", 1e-6, 1e-9)):
            np.testing.assert_allclose(b[key], a[key], rtol=rtol, atol=atol, equal_nan=True,
                                       err_msg=f"10d in-loop {ch} {key}")
        for q, band in a["percentiles"].items():
            np.testing.assert_allclose(b["percentiles"][q], band, rtol=1e-9, atol=1e-9,
                                       equal_nan=True, err_msg=f"10d in-loop {ch} p{q}")
    # the kernel's frames against the plain recorder's, through one envelope
    cfge = dataclasses.replace(mce.sim_config, record_stride=env.record_stride,
                               record_channels=tuple(c for c in env.channels
                                                     if c not in ("altitude", "speed")))
    sel = mce._select_lanes(np.arange(ENVELOPE_HELD))
    acc_k, acc_p = EnvelopeAccumulator(cfge, env), EnvelopeAccumulator(cfge, env)
    acc_k.add(simulate_flight_batch(*sel, cfge)[1])
    acc_p._edges = acc_k._edges
    acc_p.add(trajectory_of(fs.flight_record_reference(*prepare_batch(*sel), cfge)[1]))
    worst = 0.0
    for ch in env.channels:
        if not (np.array_equal(acc_k._n[ch], acc_p._n[ch])
                and np.array_equal(acc_k._hist[ch], acc_p._hist[ch])
                and acc_k._clipped[ch] == acc_p._clipped[ch]):
            raise AssertionError(f"10d {ch}: kernel-fed counts or histograms differ")
        for a, b in ((acc_k._mean[ch], acc_p._mean[ch]), (acc_k._m2[ch], acc_p._m2[ch])):
            np.testing.assert_allclose(a, b, rtol=1e-9, atol=1e-12, err_msg=f"10d {ch}")
            worst = max(worst, float(np.max(np.abs(a - b) / np.maximum(np.abs(b), 1e-300))))
    # the in-loop reduction alone, on the other half of the lanes, timed
    lo, width = acc_k._edges
    rest = mce._select_lanes(np.arange(half, ENVELOPE_LANES))
    torch.cuda.synchronize()
    t0 = time.time()
    simulate_envelope_batch(*rest, cfge, channels=env.channels, n_bins=acc_k.n_bins,
                            n_buckets=env.n_buckets, bin_dt=env.bin_dt, lo=lo, width=width,
                            hist_every=max(1, env.hist_frame_stride))
    torch.cuda.synchronize()
    in_loop = time.time() - t0
    phase("10d envelopes f64", lanes=ENVELOPE_LANES, chunk=half, frame_launches=launched_f,
          frame_wall_s=f"{wall_f:.3f}", frame_lanes_per_s=f"{ENVELOPE_LANES / wall_f:.1f}",
          inline_wall_s=f"{wall_i:.3f}", in_loop_s=f"{in_loop:.3f}",
          in_loop_lanes_per_s=f"{half / in_loop:.1f}", in_loop_equal_to_frames=True,
          kernel_fed_lanes=ENVELOPE_HELD, plain_fed_moment_rel=worst,
          plain_fed_counts_equal=True)
    rows["window"]["envelope"] = {"frame_lanes_per_s": ENVELOPE_LANES / wall_f,
                                  "in_loop_lanes_per_s": half / in_loop}
    return rows


# ---------------------------------------------------------------- phase 11
EXAMPLE_LANES = 262_144
EXAMPLE_PNGS = ("landing_footprint.png", "monte_carlo_distributions.png",
                "monte_carlo_trajectories.png", "monte_carlo_trajectories_3d.png",
                "single_simulation_results.png", "thrust_twr.png")
EXAMPLE_REPORTS = ("monte_carlo_report.json", "monte_carlo_report.txt")
# the stages of example.main, each timed and its launches counted
STAGES = {"simulate_flight_batch": "single", "save_report": "report",
          "save_simulation_results": "exports", "plot_results": "plots",
          "plot_landing_footprint": "plots", "plot_trajectory_cloud": "clouds",
          "plot_trajectory_cloud_3d": "clouds", "plot_single_simulation": "plots",
          "plot_thrust_twr": "plots"}
LAUNCH_WINDOW_LANES = 65_536


def figures_drawn() -> bool:
    """Whether this host can draw the example's figures (matplotlib is
    installed); where it cannot, the example leaves them out."""
    import importlib.util

    return importlib.util.find_spec("matplotlib") is not None


class StageClock:
    """Wraps the named functions of a module (``stages``: name -> stage; by
    default the stages of ``example.main``) so that each adds its wall and
    its launches of the summary and recording builds to ``rows[stage]``; the
    card is synchronized at each boundary. A module with a
    ``MonteCarloAnalyzer`` has its ``run_monte_carlo`` clocked as stage
    "mc". ``tag`` prefixes the lines it prints."""

    def __init__(self, example_mod, stages=STAGES, tag="11"):
        from erpl_monte_carlo_sim_tpu_torch.kernels import flight_summary as fs

        self.fs, self.mod, self.rows, self.saved = fs, example_mod, {}, {}
        self.not_drawn, self.tag = [], tag
        for name, stage in stages.items():
            self.saved[name] = getattr(example_mod, name)
            setattr(example_mod, name, self.timed(stage, self.saved[name]))
        if not hasattr(example_mod, "MonteCarloAnalyzer"):
            return
        base = example_mod.MonteCarloAnalyzer
        self.saved["MonteCarloAnalyzer"] = base
        clock = self

        class TimedAnalyzer(base):
            def run_monte_carlo(self, *a, **kw):
                return clock.timed("mc", super().run_monte_carlo)(*a, **kw)

        example_mod.MonteCarloAnalyzer = TimedAnalyzer

    def timed(self, stage, fn):
        def run(*a, **kw):
            fs = self.fs
            torch.cuda.synchronize()
            k0, r0, t0 = fs.launches, fs.record_launches, time.time()
            try:
                return fn(*a, **kw)
            except ImportError as e:
                # a host without matplotlib: the figure's data are gathered
                # (the clouds' recordings too) and the figure is not drawn;
                # where matplotlib is installed the error stands
                if stage not in ("plots", "clouds") or figures_drawn():
                    raise
                self.not_drawn.append(fn.__name__)
                print(f"[{self.tag}] {fn.__name__} not drawn: {e}", flush=True)
                return None
            finally:
                torch.cuda.synchronize()
                row = self.rows.setdefault(stage, {"wall_s": 0.0, "k1": 0, "k1_rec": 0})
                row["wall_s"] += time.time() - t0
                row["k1_rec"] += fs.record_launches - r0
                row["k1"] += (fs.launches - k0) - (fs.record_launches - r0)
        return run

    def restore(self):
        for name, fn in self.saved.items():
            setattr(self.mod, name, fn)


def run_example(n: int, stabilized: bool):
    """``example.main`` on the card, the stages clocked, the launches
    counted from 0 just before it: ``(results, analysis, output_dir,
    stages, k1, k1_rec, wall, not_drawn)``, ``not_drawn`` the figures a host
    without matplotlib left out."""
    from erpl_monte_carlo_sim_tpu_torch import example
    from erpl_monte_carlo_sim_tpu_torch.kernels import flight_summary as fs

    clock = StageClock(example)
    try:
        torch.cuda.synchronize()
        fs.launches = fs.record_launches = 0
        t0 = time.time()
        results, analysis, out = example.main(n, stabilized=stabilized, device="cuda")
        torch.cuda.synchronize()
        wall = time.time() - t0
        k1, k1_rec = fs.launches - fs.record_launches, fs.record_launches
    finally:
        clock.restore()
    return results, analysis, out, clock.rows, k1, k1_rec, wall, clock.not_drawn


def same_json(a, b) -> bool:
    """Equal as JSON values (NaN meets NaN)."""
    return json.dumps(a, sort_keys=True) == json.dumps(b, sort_keys=True)


def check_exports(out: str, analysis: dict, tag: str) -> list:
    """Each ``sim_<id>.json`` of ``out``: the run's ``results`` lane ids, and
    its headline values the run's summary for that lane bit for bit (the
    re-simulation contract). Returns the file names."""
    sims = os.path.join(out, "simulation_results")
    ids = [r["simulation_id"] for r in analysis["results"][:50]]
    names = sorted(os.listdir(sims)) if os.path.isdir(sims) else []
    if names != sorted(f"sim_{i}.json" for i in ids):
        raise AssertionError(f"{tag}: exports {names[:5]}... are not the lanes {ids[:5]}...")
    summary = analysis["summary"]
    for i in ids:
        with open(os.path.join(sims, f"sim_{i}.json")) as f:
            sim = json.load(f)
        for k in ("apogee_altitude", "range", "flight_time"):
            want = float(np.asarray(getattr(summary, k))[i])
            if not (sim[k] == want or (math.isnan(sim[k]) and math.isnan(want))):
                raise AssertionError(f"{tag}: sim_{i}.json {k} {sim[k]!r} is not the "
                                     f"run's {want!r}")
    return names


def run_clis(sims: str) -> dict:
    """find_max_apogee and analyze_outlier on the exports, their prints kept
    out of this script's output."""
    import io

    from erpl_monte_carlo_sim_tpu_torch.cli.analyze_outlier import main as analyze
    from erpl_monte_carlo_sim_tpu_torch.cli.find_max_apogee import main as find_max

    with contextlib.redirect_stdout(io.StringIO()):
        sim_id, apo = find_max(sims)
        info = analyze(sims, sim_id) if sim_id is not None else {}
    return {"max_apogee_sim": sim_id, "max_apogee": apo,
            "max_quat_norm_drift": info.get("max_quat_norm_drift")}


def stage_numbers(stages: dict) -> dict:
    """The stages' walls and launches; without matplotlib the ``plots``
    stage drew nothing, so its wall is not a figure's time."""
    out = {f"{k}_{m}": (f"{v:.3f}" if m == "wall_s" else v)
           for k, row in sorted(stages.items()) for m, v in row.items()}
    if not figures_drawn() and "plots_wall_s" in out:
        out["plots_wall_s"] = "not measured (no matplotlib on this host)"
    return out


def example_stabilized(dev) -> dict:
    """11a: the stabilized example at full size."""
    from erpl_monte_carlo_sim_tpu_torch import example
    from erpl_monte_carlo_sim_tpu_torch.engine import (InitialConditions, SimConfig,
                                                       simulate_summary_batch)
    from erpl_monte_carlo_sim_tpu_torch.models import (WindField, liquid_motor,
                                                       load_wind_profile_from_csv,
                                                       nominal_scene)
    from erpl_monte_carlo_sim_tpu_torch.utils.serialize import to_serializable

    results, analysis, out, stages, k1, k1_rec, wall, not_drawn = run_example(EXAMPLE_LANES,
                                                                              True)
    # the files: the report, 50 exports, the six figures where they are drawn
    pngs = EXAMPLE_PNGS if figures_drawn() else ()
    drawn = sorted(n for n in os.listdir(out) if n.endswith(".png"))
    if drawn != sorted(pngs):
        raise AssertionError(f"11a: figures {drawn}, expected {sorted(pngs)}")
    if len(drawn) + len(not_drawn) != len(EXAMPLE_PNGS):
        raise AssertionError(f"11a: figures drawn {drawn}, left out {not_drawn}")
    for name in EXAMPLE_REPORTS + pngs:
        path = os.path.join(out, name)
        size = os.path.getsize(path) if os.path.exists(path) else 0
        if size == 0 or (name.endswith(".png") and size <= 10_000):
            raise AssertionError(f"11a: {name} is missing or too small ({size} bytes)")
    names = check_exports(out, analysis, "11a")
    if len(names) != 50:
        raise AssertionError(f"11a: {len(names)} exports, 50 expected")
    sims = os.path.join(out, "simulation_results")
    export_bytes = sum(os.path.getsize(os.path.join(sims, n)) for n in names)
    if min(os.path.getsize(os.path.join(sims, n)) for n in names) == 0:
        raise AssertionError("11a: an empty export")
    with open(os.path.join(out, "monte_carlo_report.json")) as f:
        report = json.load(f)
    for key, block in (("apogee_altitude_stats", "apogee_altitude"), ("range_stats", "range"),
                       ("flight_time_stats", "flight_time")):
        if not same_json(report[key], to_serializable(analysis[block])):
            raise AssertionError(f"11a: the report's {key} is not the analysis'")
    # the single flight against the summary build on the same B=1 inputs
    alts, wind = load_wind_profile_from_csv(example.SAMPLE_WIND)
    scene = dataclasses.replace(nominal_scene(liquid_motor(dev)),
                                wind=WindField.from_arrays(alts, wind, dev))
    ic = InitialConditions.vertical_launch(dev)
    ic1 = InitialConditions(*(v[None] for v in (ic.position, ic.velocity, ic.attitude,
                                                ic.angular_velocity)))
    s = simulate_summary_batch(scene, ic1, SimConfig(energy_consistent_aero=True))
    for k, v in (("apogee_altitude", s.apogee_altitude), ("apogee_time", s.apogee_time),
                 ("range", s.range), ("flight_time", s.flight_time),
                 ("rail_exit_speed", s.rail.rail_exit_speed)):
        if results[k] != float(v[0]):
            raise AssertionError(f"11a: the single flight's {k} {results[k]!r} is not the "
                                 f"summary build's {float(v[0])!r}")
    # the scene as JSON and back onto the card flies the same flight
    from erpl_monte_carlo_sim_tpu_torch.utils.scene_io import load_scene, save_scene

    save_scene(scene, os.path.join(out, "scene.json"))
    loaded = load_scene(os.path.join(out, "scene.json"), dev)
    if loaded.rocket.dry_mass.device.type != "cuda":
        raise AssertionError("11a: load_scene(path, dev) left the scene off the card")
    s2 = simulate_summary_batch(loaded, ic1, SimConfig(energy_consistent_aero=True))
    if not (torch.equal(s2.apogee_altitude, s.apogee_altitude)
            and torch.equal(s2.range, s.range)):
        raise AssertionError("11a: the scene loaded from JSON flies another flight")
    clis = run_clis(sims)
    if not clis["max_quat_norm_drift"] < 1e-6:
        raise AssertionError(f"11a: quaternion norm drift {clis['max_quat_norm_drift']}")
    # K1 for the run; K1-Rec for the single flight and once for the exports;
    # the clouds re-use the exports' recording (the memo)
    if not (k1 >= 1 and k1_rec == 2 and stages["single"]["k1_rec"] == 1
            and stages["exports"]["k1_rec"] == 1 and stages["mc"]["k1"] >= 1
            and stages["clouds"]["k1"] + stages["clouds"]["k1_rec"] == 0):
        raise AssertionError(f"11a: launches k1={k1} k1_rec={k1_rec} by stage {stages}")
    phase("11a example stabilized", lanes=EXAMPLE_LANES, n_valid=analysis["n_samples"],
          n_outliers=analysis["n_outliers"], k1_launches=k1, k1_rec_launches=k1_rec,
          main_wall_s=f"{wall:.3f}", files=len(names) + 2 + len(drawn),
          figures=len(drawn) if figures_drawn() else
          "not drawn, PNG gate not run (no matplotlib on this host)",
          export_bytes=export_bytes, scene_json_on_card="the same flight bit for bit",
          single_apogee_m=results["apogee_altitude"],
          single_flight_time_s=results["flight_time"],
          apogee_mean=analysis["apogee_altitude"]["mean"], **clis, **stage_numbers(stages))
    return {"k1": k1, "k1_rec": k1_rec}


def example_parity() -> dict:
    """11b: the parity example at its default 50 lanes: the CSV-wind single
    flight diverges, as the reference's does; the run must still write its
    artifacts."""
    results, analysis, out, stages, k1, k1_rec, wall, _ = run_example(50, False)
    pngs = ("monte_carlo_distributions.png", "single_simulation_results.png",
            "thrust_twr.png") if figures_drawn() else ()
    for name in EXAMPLE_REPORTS + pngs:
        if not os.path.exists(os.path.join(out, name)) or \
                os.path.getsize(os.path.join(out, name)) == 0:
            raise AssertionError(f"11b: {name} is missing or empty")
    names = check_exports(out, analysis, "11b")
    if k1 < 1 or k1_rec != 1 + (1 if names else 0):
        raise AssertionError(f"11b: launches k1={k1} k1_rec={k1_rec}")
    n_files = sum(len(f) for _, _, f in os.walk(out))
    phase("11b example parity", lanes=50, n_valid=analysis["n_samples"],
          n_outliers=analysis["n_outliers"], k1_launches=k1, k1_rec_launches=k1_rec,
          files=n_files, main_wall_s=f"{wall:.3f}",
          single_apogee_m=results["apogee_altitude"], single_range_m=results["range"],
          single_flight_time_s=results["flight_time"], **stage_numbers(stages))
    return {"k1": k1, "k1_rec": k1_rec}


def recovered_csv(dev) -> None:
    """11c: the reference forecast recovered from tests/golden/mc_forecast.jsonl,
    float64: the golden CSV-wind flight through the recording build in an
    11 s window (tests/test_wind_flight_parity.py's bars), and the same
    scene stabilized to landing through the summary build
    (tests/test_stabilized.py's checks)."""
    from erpl_monte_carlo_sim_tpu_torch.engine import (InitialConditions, SimConfig,
                                                       simulate_flight_batch,
                                                       simulate_summary_batch)
    from erpl_monte_carlo_sim_tpu_torch.kernels import flight_summary as fs
    from erpl_monte_carlo_sim_tpu_torch.models import (WindField, liquid_motor,
                                                       load_wind_profile_from_csv,
                                                       nominal_scene)

    f64 = torch.float64
    alts, wind = load_wind_profile_from_csv(os.path.join(
        ROOT, "erpl_monte_carlo_sim_tpu_torch", "data", "reference_sample_wind.csv"))
    scene = dataclasses.replace(nominal_scene(liquid_motor(dev, f64)),
                                wind=WindField.from_arrays(alts, wind, dev, f64))
    ic = InitialConditions.vertical_launch(dev, f64)
    ic1 = InitialConditions(*(v[None] for v in (ic.position, ic.velocity, ic.attitude,
                                                ic.angular_velocity)))
    with open(os.path.join(ROOT, "tests", "golden", "flight_liquid_csvwind.json")) as f:
        g = json.load(f)
    fs.launches = fs.record_launches = 0
    s, t = simulate_flight_batch(scene, ic1, SimConfig(max_time=11.0))
    rec_launched = fs.record_launches
    rail = {"speed": float(s.rail.rail_exit_speed[0]),
            "aoa": float(s.rail.rail_exit_angle_of_attack[0]),
            "sideslip": float(s.rail.rail_exit_sideslip[0])}
    ok = {"rail_exit_speed": abs(rail["speed"] / g["rail_exit_speed"] - 1) <= 1e-5,
          "rail_exit_aoa": abs(rail["aoa"] / g["rail_exit_aoa"] - 1) <= 1e-3,
          "rail_exit_sideslip": abs(rail["sideslip"] - g["rail_exit_sideslip"])
          <= max(1e-2 * abs(g["rail_exit_sideslip"]), 1e-6)}
    valid = t.valid[0].cpu().numpy()
    time_ = t.time[0].cpu().numpy()[valid]
    pos = t.position[0].cpu().numpy()[valid]
    speed = t.derived["speed"][0].cpu().numpy()[valid]
    aoa = t.derived["angle_of_attack"][0].cpu().numpy()[valid]
    worst = {"alt": 0.0, "speed": 0.0, "x": 0.0, "y": 0.0, "aoa": 0.0}
    probes = 0
    for p in g["probes"]:
        if p["t"] > 10.5:
            continue
        i = int(np.argmin(np.abs(time_ - p["t"])))
        probes += 1
        got = {"alt": pos[i, 2], "speed": speed[i], "x": pos[i, 0], "y": pos[i, 1],
               "aoa": aoa[i]}
        bars = {"alt": 2e-3 * abs(p["alt"]), "speed": 2e-3 * abs(p["speed"]),
                "x": max(0.05 * abs(p["x"]), 0.5), "y": max(0.05 * abs(p["y"]), 0.5),
                "aoa": 3e-3}
        for k in got:
            err = abs(float(got[k]) - p[k])
            worst[k] = max(worst[k], err / bars[k])
            ok[f"probe {p['t']:.1f} {k}"] = err <= bars[k]
    # stabilized to landing through the summary build, and parity's blow-up
    fs.launches = 0
    bad = simulate_summary_batch(scene, ic1, SimConfig())
    good = simulate_summary_batch(scene, ic1, SimConfig(energy_consistent_aero=True))
    launched = fs.launches
    bad_range = float(bad.range[0])
    ok["parity diverges"] = (not math.isfinite(bad_range)) or bad_range > 1e6
    ok["stabilized flight"] = (float(good.flight_time[0]) > 100.0
                               and float(good.max_speed[0]) < 1500.0
                               and math.isfinite(float(good.range[0]))
                               and float(good.range[0]) < 50_000.0
                               and bool(good.parachute_deployed[0])
                               and not bool(good.diverged[0]))
    if not all(ok.values()) or rec_launched != 1 or launched != 2:
        raise AssertionError(f"11c: {[k for k, v in ok.items() if not v]}, launches "
                             f"{rec_launched} recording, {launched} summary")
    phase("11c recovered reference csv", rail_exit_speed=rail["speed"],
          rail_exit_aoa=rail["aoa"], rail_exit_sideslip=rail["sideslip"], probes=probes,
          worst_share_of_bar=json.dumps({k: round(v, 6) for k, v in worst.items()}),
          k1_rec_launches=rec_launched, k1_launches=launched, parity_range_m=bad_range,
          stabilized_flight_time_s=float(good.flight_time[0]),
          stabilized_range_m=float(good.range[0]),
          stabilized_max_speed=float(good.max_speed[0]))


def sweep_cli(argv):
    """The launch_window CLI's ``main(argv)`` on the card (its default
    device), its printed JSON kept out of this script's output and checked
    against the returned sweep; ``(sweep, wall s, launches)``."""
    import io

    from erpl_monte_carlo_sim_tpu_torch.cli.launch_window import main as launch_window
    from erpl_monte_carlo_sim_tpu_torch.kernels import flight_summary as fs

    torch.cuda.synchronize()
    fs.launches = 0
    t0 = time.time()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        sweep = launch_window(argv)
    wall = time.time() - t0
    if json.loads(buf.getvalue())["go_count"] != sweep["go_count"]:
        raise AssertionError("launch_window printed another sweep than it returned")
    return sweep, wall, fs.launches


def impact_shifts(sweep) -> tuple:
    """The mean impact's x at direction 0 less at 180 degrees, for 8 and 2
    m/s."""
    x = {(r["wind_speed"], r["wind_direction_deg"]): r["landing_footprint"]["mean_m"][0]
         for r in sweep["candidates"]}
    return x[(8.0, 0.0)] - x[(8.0, 180.0)], x[(2.0, 0.0)] - x[(2.0, 180.0)]


def launch_window_on_card() -> None:
    """11d: the launch_window CLI on the card. At its default config
    (``SimConfig()``, parity physics to landing) most lanes diverge (ROADMAP
    F5), so the mean impact is that of the few survivors: printed, not
    held. tests/test_launch_window.py's direction check is held on its own
    3 s window, at the same lanes."""
    args = ["--speeds", "2,8", "--directions", "0,180", "--n", str(LAUNCH_WINDOW_LANES),
            "--range-limit", "3000"]
    sweep, wall, launched = sweep_cli(args)
    shift8, shift2 = impact_shifts(sweep)
    window, wall3, launched3 = sweep_cli(args + ["--max-time", "3.0"])
    w8, w2 = impact_shifts(window)
    if launched != 4 or launched3 != 4 or not (w8 > 0.2 and abs(w2) < w8):
        raise AssertionError(f"11d: launches {launched}, {launched3}; 3 s window impact x "
                             f"shift {w8} at 8 m/s, {w2} at 2 m/s")
    phase("11d launch window", lanes_per_candidate=LAUNCH_WINDOW_LANES, launches=launched,
          wall_s=f"{wall:.3f}", go_count=sweep["go_count"], x_shift_8_m=shift8,
          x_shift_2_m=shift2,
          candidates=json.dumps([{"speed": r["wind_speed"],
                                  "direction": r["wind_direction_deg"],
                                  "n_valid": r["n_valid"], "go": r["go"]}
                                 for r in sweep["candidates"]]))
    phase("11d launch window 3 s", lanes_per_candidate=LAUNCH_WINDOW_LANES,
          launches=launched3, wall_s=f"{wall3:.3f}", x_shift_8_m=w8, x_shift_2_m=w2,
          n_valid=json.dumps([r["n_valid"] for r in window["candidates"]]))


def entry_point(dev) -> dict:
    """Phase 11 in a temporary working directory (the example writes into
    ``outputs/`` under it); returns the example runs' launches."""
    import tempfile

    cwd, tmp = os.getcwd(), tempfile.mkdtemp(prefix="chip_smoke_example_")
    os.chdir(tmp)
    try:
        launches = {"11a stabilized": example_stabilized(dev), "11b parity": example_parity()}
        recovered_csv(dev)
        launch_window_on_card()
    finally:
        os.chdir(cwd)
        shutil.rmtree(tmp, ignore_errors=True)
    return launches


def variant_run(mc, ic, n: int, want_launches: int, **kw):
    """One run of the main path under ``mc``'s sampling options: K1's
    launches counted from 0 just before it and read just after (one a slab),
    each draw through the analyzer's seams timed with the card synchronized
    around it. Returns ``(analysis, draw ms per call, wall s, launches)``."""
    from erpl_monte_carlo_sim_tpu_torch.kernels import flight_summary as fs
    from erpl_monte_carlo_sim_tpu_torch.mc import analyzer as analyzer_mod

    draws = []
    seams = {name: getattr(analyzer_mod, name) for name in ("_draw_single", "_draw_slab")}

    def timed(fn):
        def call(*a, **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **k)
            torch.cuda.synchronize()
            draws.append(1e3 * (time.perf_counter() - t0))
            return out
        return call

    for name, fn in seams.items():
        setattr(analyzer_mod, name, timed(fn))
    try:
        torch.cuda.synchronize()
        fs.launches = 0
        t0 = time.time()
        analysis = mc.run_monte_carlo(ic, n_samples=n, seed=0, **kw)
        wall = time.time() - t0
        launched = fs.launches
    finally:
        for name, fn in seams.items():
            setattr(analyzer_mod, name, fn)
    if launched != want_launches:
        raise AssertionError(f"{launched} launches of the flight kernel, {want_launches} "
                             "expected")
    return analysis, draws, wall, launched


def warm_draw_ms(mc, ic, n: int, slab=None) -> float:
    """The median of 3 warm draws of ``n`` lanes (a slab of a slabbed run
    with ``slab``) through the analyzer's seam under ``mc``'s options, the
    card synchronized around each: the sampling stage without first-call
    costs."""
    from erpl_monte_carlo_sim_tpu_torch.mc import analyzer as analyzer_mod

    times = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if slab is None:
            analyzer_mod._draw_single(mc, ic, n, 0, mc._base_wind())
        else:
            analyzer_mod._draw_slab(mc, ic, 0, slab, 0, mc._base_wind())
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
    return float(np.median(times))


def k1_on_lanes(scene_b, ic_b, cfg) -> dict:
    """K1 on a run's own lanes: timed (CUDA events) beside its bound, and
    held to its plain version on the first ``SLICE_LANES`` lanes at the
    float32 bars (``compare``). These launches are not the run's."""
    from erpl_monte_carlo_sim_tpu_torch.engine.batch import prepare_batch
    from erpl_monte_carlo_sim_tpu_torch.kernels import flight_summary as fs

    args = prepare_batch(scene_b, ic_b)
    t = time_kernel(fs, args, cfg, torch.float32, reps=2)
    got = fs.flight_summary(*args, cfg)
    ref, got_n, plain_ms = plain_on_head(args, got, cfg, n=SLICE_LANES)
    return {"kernel_ms": t["ms"], "bound_ms": t["bound_ms"],
            "share_of_bound": t["share_of_bound"], "held_lanes": SLICE_LANES,
            "max_abs_err": compare(ref, got_n, torch.float32), "plain_ms": plain_ms}


def ulps32(a: torch.Tensor, b: torch.Tensor) -> float:
    """The largest difference of two float32 tensors in ulps of the larger
    magnitude."""
    a, b = a.cpu().numpy(), b.cpu().numpy()
    return float((np.abs(a - b) / np.spacing(np.maximum(np.abs(a), np.abs(b)))).max())


def mirrored_channels(sample, std: dict, params, motor, n: int) -> int:
    """Every scalar channel of an antithetic run against the mirror of its
    first half as the port forms it from the standard draws ``std`` (drawn
    again from the run's seed): an offset's second half is ``0 - d``, a
    multiplier's ``1 + (0 - d)`` (``d`` the first half's ``z * sigma``), a
    uniform's ``2 * centre - v``. Bit for bit; returns the channels held."""
    half = n // 2
    f32 = torch.float32
    dev = std["mass_mult"].device

    def d(key, sigma):
        return std[key][:half] * torch.as_tensor(sigma, dtype=f32, device=dev)

    expect = {}
    for field, key, sigma in (
            ("initial_position_offset", "pos_off", params.initial_position),
            ("initial_velocity_offset", "vel_off", params.initial_velocity),
            ("initial_attitude_offset", "att_off", params.initial_attitude),
            ("initial_angular_velocity_offset", "omg_off", params.initial_angular_velocity)):
        x = d(key, sigma)
        expect[field] = torch.cat([x, 0.0 - x])
    for field, key, sigma in (
            ("mass_multiplier", "mass_mult", params.mass_uncertainty),
            ("thrust_multiplier", "thrust_mult_recorded", params.thrust_uncertainty),
            ("motor_thrust_multiplier", "motor_thrust_mult", motor.thrust_uncertainty),
            ("motor_flow_multiplier", "motor_flow_mult", motor.mass_flow_uncertainty),
            ("density_multiplier", "density_mult", params.atmospheric_density_uncertainty)):
        x = d(key, sigma)
        expect[field] = 1.0 + torch.cat([x, 0.0 - x])
    for field, key, (lo, hi) in (("wind_speed", "wind_speed", params.wind_speed_range),
                                 ("wind_direction", "wind_dir", params.wind_direction_range)):
        v = lo + (hi - lo) * std[key][:half]
        expect[field] = torch.cat([v, 2 * (0.5 * (lo + hi)) - v])
    for field, want in expect.items():
        if not np.array_equal(getattr(sample, field), want.cpu().numpy()):
            raise AssertionError(f"12b: {field} is not the mirror of its first half")
    return len(expect)


def write_ensemble(tmp: str) -> list:
    """Three forecast members as CSVs: the recovered reference forecast and
    two copies of it offset by +3 and -3 m/s in ``u``."""
    from erpl_monte_carlo_sim_tpu_torch.models.wind import load_wind_profile_from_csv

    src = os.path.join(ROOT, "erpl_monte_carlo_sim_tpu_torch", "data",
                       "reference_sample_wind.csv")
    alt, wind = load_wind_profile_from_csv(src)
    paths = []
    for i, du in enumerate((0.0, 3.0, -3.0)):
        path = os.path.join(tmp, f"member_{i}.csv")
        with open(path, "w") as f:
            f.write("altitude,u,v,w\n")
            for h, (u, v, w) in zip(alt, wind):
                f.write(",".join(repr(float(x)) for x in (h, u + du, v, w)) + "\n")
        paths.append(path)
    return paths


def ensemble_groupby(a: dict, k: int) -> None:
    """The ensemble block against a NumPy group-by of the run's metrics on
    its members: counts exact, means to 1e-12 relative."""
    members, valid = a["wind_members"], a["valid_mask"]
    for j, row in enumerate(a["ensemble"]["members"]):
        mine = members == j
        if (row["n_drawn"], row["n_valid"]) != (int(mine.sum()), int((mine & valid).sum())):
            raise AssertionError(f"12d: member {j} counts {row}")
        for metric in ("apogee_altitude", "range", "flight_time"):
            v = a["metrics"][metric].astype(np.float64)
            sel = mine & valid & np.isfinite(v)
            want = v[sel].mean() if sel.any() else float("nan")
            if row[metric]["n"] != int(sel.sum()) or not (
                    abs(row[metric]["mean"] / want - 1) <= 1e-12
                    or math.isnan(want) and math.isnan(row[metric]["mean"])):
                raise AssertionError(f"12d: member {j} {metric} {row[metric]} against "
                                     f"{int(sel.sum())} lanes, mean {want!r}")
    if len(a["ensemble"]["members"]) != k or set(np.unique(members)) != set(range(k)):
        raise AssertionError("12d: not every member was drawn")


class DrawSplit:
    """Times the stages of the Sobol path's draw, call by call, the card
    synchronized around each (``ops.sobol``'s seeds, points and unit map,
    ``dispersions._sobol_channels`` and ``_build_scene``), and the caching
    allocator's reserved bytes before and after the first draw."""

    STAGES = (("ops.sobol", "draw_seeds"), ("ops.sobol", "sobol_points"),
              ("ops.sobol", "_to_unit"), ("mc.dispersions", "_sobol_channels"),
              ("mc.dispersions", "_build_scene"))

    def __enter__(self):
        import importlib

        self.ms = {name: [] for _, name in self.STAGES}
        self.reserved = [torch.cuda.memory_reserved()]
        self.saved = []
        for mod_name, name in self.STAGES:
            mod = importlib.import_module(f"erpl_monte_carlo_sim_tpu_torch.{mod_name}")
            fn = getattr(mod, name)
            self.saved.append((mod, name, fn))
            setattr(mod, name, self.timed(name, fn))
        return self

    def timed(self, name, fn):
        def call(*a, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            torch.cuda.synchronize()
            self.ms[name].append(1e3 * (time.perf_counter() - t0))
            if name == "_build_scene" and len(self.reserved) == 1:
                self.reserved.append(torch.cuda.memory_reserved())
            return out
        return call

    def __exit__(self, *exc):
        for mod, name, fn in self.saved:
            setattr(mod, name, fn)

    def numbers(self) -> dict:
        """The first call's ms of each stage, the later calls' median, and
        the reserved MB before and after the first draw."""
        out = {}
        for name, ms in self.ms.items():
            out[f"{name}_first_ms"] = f"{ms[0]:.3f}" if ms else "none"
            out[f"{name}_later_ms"] = f"{np.median(ms[1:]):.3f}" if len(ms) > 1 else "none"
        out["reserved_mb"] = json.dumps([round(r / 2**20, 1) for r in self.reserved])
        return out


def on_device(obj, dev):
    """A host-side port dataclass (NumPy leaves) as tensors on ``dev``."""
    from erpl_monte_carlo_sim_tpu_torch.utils.tree import tree_map

    return tree_map(lambda x: torch.as_tensor(np.asarray(x), device=dev), obj)


def host64(obj):
    """Every tensor leaf of a port dataclass on the host, floats in float64."""
    from erpl_monte_carlo_sim_tpu_torch.utils.tree import tree_map

    return tree_map(lambda t: t.detach().cpu().double() if t.is_floating_point()
                    else t.detach().cpu(), obj)


def median_ms(fn, reps=3):
    """The median of ``reps`` synchronized host-clock ms of ``fn``, after a
    first call, and its last result."""
    fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
    return float(np.median(times)), out


def counted(fn, *a, **kw):
    """``fn(*a, **kw)`` with K1's launches counted from 0 just before it and
    read just after: ``(result, wall s, launches)``."""
    from erpl_monte_carlo_sim_tpu_torch.kernels import flight_summary as fs

    torch.cuda.synchronize()
    fs.launches = 0
    t0 = time.time()
    out = fn(*a, **kw)
    torch.cuda.synchronize()
    return out, time.time() - t0, fs.launches


def cv_moments_against_float64(mc, ic, a) -> dict:
    """13a's checks: the run's lanes drawn again through its seam, their CV
    moments reduced on the card (timed, and the turbulence scores alone),
    against the same function over the same lanes' controls and targets on
    the host in float64."""
    from erpl_monte_carlo_sim_tpu_torch.mc import MonteCarloAnalyzer, cv
    from erpl_monte_carlo_sim_tpu_torch.mc import analyzer as analyzer_mod
    from erpl_monte_carlo_sim_tpu_torch.models import liquid_motor

    dev = mc.device
    scene_b, _ = mc._last_batch
    _, _, sample = analyzer_mod._draw_single(mc, ic, BENCH_LANES, 0, None)
    summary = on_device(a["summary"], dev)
    valid = torch.as_tensor(a["valid_mask"], device=dev)
    ones = torch.ones(BENCH_LANES, dtype=torch.bool, device=dev)
    ctrl = mc._cv_wind_ctrl(scene_b, sample, None)
    moments_ms, got = median_ms(lambda: cv.cv_slab_moments(
        sample, summary, valid, ones, mc.uncertainty_params, mc.scene.motor, ctrl))
    scores_ms, _ = median_ms(lambda: cv._wind_scores(ctrl, torch.float32))
    mc64 = MonteCarloAnalyzer(motor=liquid_motor("cpu", torch.float64),
                              sim_config=mc.sim_config, **CV_OPTIONS)
    t0 = time.time()
    ref = cv.cv_slab_moments(host64(sample), host64(summary), valid.cpu(), ones.cpu(),
                             mc64.uncertainty_params, mc64.scene.motor,
                             mc64._cv_wind_ctrl(host64(scene_b), host64(sample), None))
    host_s = time.time() - t0
    if not int(got[0]) == int(ref[0]) == BENCH_LANES:
        raise AssertionError(f"13a: {int(got[0])} lanes in the moments, {int(ref[0])} on the "
                             "host")
    worst = max(float(np.abs(x - y).max() / np.abs(y).max())
                for x, y in zip(got[1:], ref[1:]))
    if not worst <= CV_MOMENT_BAR:
        raise AssertionError(f"13a: CV moments {worst} of their scale from float64")
    return {"moments_ms": f"{moments_ms:.3f}", "wind_scores_ms": f"{scores_ms:.3f}",
            "controls": int(got[1].size), "moments_vs_f64": worst, "bar": CV_MOMENT_BAR,
            "f64_host_s": f"{host_s:.2f}"}


def kill_and_resume(mc, ic, n, slab, want_launches, tag):
    """``run_monte_carlo(n, lane_slab=slab)`` killed at its third draw with a
    checkpoint after every slab, then resumed: ``(resumed analysis, wall s,
    launches of the resumed run)``."""
    import tempfile

    from erpl_monte_carlo_sim_tpu_torch.mc import analyzer as analyzer_mod

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "run.ckpt.npz")
        draw_slab, calls = analyzer_mod._draw_slab, []

        def dying(*args, **kw):
            if len(calls) == 2:
                raise RuntimeError("simulated crash")
            calls.append(1)
            return draw_slab(*args, **kw)

        analyzer_mod._draw_slab = dying
        try:
            mc.run_monte_carlo(ic, n_samples=n, seed=0, lane_slab=slab, checkpoint_path=path,
                               checkpoint_every=1)
            raise AssertionError(f"{tag}: the run did not stop at its third draw")
        except RuntimeError as err:
            if "simulated crash" not in str(err):
                raise
        finally:
            analyzer_mod._draw_slab = draw_slab
        r, _, wall, launched = variant_run(mc, ic, n, want_launches, lane_slab=slab,
                                           checkpoint_path=path, checkpoint_every=1)
        if os.path.exists(path):
            raise AssertionError(f"{tag}: the checkpoint outlived the run")
    return r, wall, launched


def estimators(dev, ic, mc4, run4) -> dict:
    """Phase 13; returns each run's K1 launches."""
    import importlib
    import io
    import tempfile
    import types

    from erpl_monte_carlo_sim_tpu_torch import reporting
    from erpl_monte_carlo_sim_tpu_torch.cli import tail_probability as tp_cli
    from erpl_monte_carlo_sim_tpu_torch.engine import SimConfig, simulate_summary_batch
    from erpl_monte_carlo_sim_tpu_torch.engine.batch import prepare_batch
    from erpl_monte_carlo_sim_tpu_torch.kernels import flight_summary as fs
    from erpl_monte_carlo_sim_tpu_torch.mc import (MonteCarloAnalyzer, cv,
                                                   exceedance_from_analysis, normal_dims,
                                                   sample_from_normals, tail_from_analysis,
                                                   two_level)
    from erpl_monte_carlo_sim_tpu_torch.mc import analyzer as analyzer_mod
    from erpl_monte_carlo_sim_tpu_torch.mc.filter import outlier_mask
    from erpl_monte_carlo_sim_tpu_torch.models import liquid_motor

    sobol_mod = importlib.import_module("erpl_monte_carlo_sim_tpu_torch.mc.sobol_indices")
    cfg = SimConfig(max_time=WINDOW)
    f32 = torch.float32
    launches = {}
    metrics = ("apogee_altitude", "range", "flight_time")

    # ---- 13a: control variates on one call
    mc_a = MonteCarloAnalyzer(motor=liquid_motor(dev), sim_config=cfg, **CV_OPTIONS)
    mc_a.run_monte_carlo(ic, n_samples=4096, seed=1)  # first calls: the projector, the means
    a, _, wall, launches["13a"] = variant_run(mc_a, ic, BENCH_LANES, 1)
    block = a["control_variates"]
    ap = block["apogee_altitude"]
    if not (abs(ap["mean"] - ap["plain_mean"]) <= 4 * ap["plain_stderr"]
            and ap["variance_reduction"] >= 1.0):
        raise AssertionError(f"13a: adjusted apogee {ap['mean']} against the plain "
                             f"{ap['plain_mean']} +- {ap['plain_stderr']}")
    checks = cv_moments_against_float64(mc_a, ic, a)
    phase("13a control variates", lanes=BENCH_LANES, launches=launches["13a"],
          wall_s=f"{wall:.3f}", n_valid=a["n_samples"], n_per_control=block["n_per_control"],
          kept_controls=len(block["kept_controls"]), apogee_adjusted=ap["mean"],
          apogee_adjusted_stderr=ap["stderr"], apogee_plain=ap["plain_mean"],
          apogee_plain_stderr=ap["plain_stderr"],
          variance_reduction=json.dumps({m: round(block[m]["variance_reduction"], 3)
                                         for m in metrics}), **checks)

    # ---- 13b: control variates on 4 slabs, merged, killed and resumed
    b, _, wall, launches["13b"] = variant_run(mc_a, ic, LARGE_LANES, 4, lane_slab=BENCH_LANES)
    acc = cv.CVMoments()
    ones = torch.ones(BENCH_LANES, dtype=torch.bool, device=dev)
    for k in range(4):
        sb, ib, smp = analyzer_mod._draw_slab(mc_a, ic, k, BENCH_LANES, 0, None)
        s = simulate_summary_batch(sb, ib, cfg)
        acc.add(cv.cv_slab_moments(smp, s, outlier_mask(s, mc_a.bounds)[0], ones,
                                   mc_a.uncertainty_params, mc_a.scene.motor,
                                   mc_a._cv_wind_ctrl(sb, smp, None)))
        del sb, ib, smp, s
    if cv.finalize_cv(acc, mc_a._cv_names()) != b["control_variates"]:
        raise AssertionError("13b: the run's CV block is not its slabs' moments merged")
    r, wall_r, launches["13b resume"] = kill_and_resume(mc_a, ic, LARGE_LANES, BENCH_LANES, 2,
                                                        "13b")
    same_analysis(r, b)
    bb = b["control_variates"]["apogee_altitude"]
    phase("13b control variates slabbed", lanes=LARGE_LANES, slabs=4,
          launches=launches["13b"], wall_s=f"{wall:.3f}", merged_equal_to_slabs=True,
          apogee_adjusted=bb["mean"], apogee_adjusted_stderr=bb["stderr"],
          variance_reduction=bb["variance_reduction"], resume_launches=launches["13b resume"],
          resume_wall_s=f"{wall_r:.3f}", resume_equal_to_run=True)
    del b, r
    torch.cuda.empty_cache()

    # ---- 13c: two-level correction of phase 7's tiered full flights
    cfg7 = flag_set("full_flights")[0]
    mc_c = MonteCarloAnalyzer(motor=liquid_motor(dev), sim_config=cfg7,
                              two_level_lanes=TWO_LEVEL_LANES)
    legs, real = [], two_level.simulate_summary_batch

    def leg(scene_b, ic_b, c):
        out = real(scene_b, ic_b, c)
        legs.append((scene_b, ic_b, c, out))
        return out

    two_level.simulate_summary_batch = leg
    try:
        c, _, wall, launches["13c"] = variant_run(mc_c, ic, BENCH_LANES, 3)
    finally:
        two_level.simulate_summary_batch = real
    tl = c["two_level"]
    (sb, ib, c_fast, fast), (_, _, c_par, _) = legs
    if c_fast != cfg7 or c_par != two_level.parity_twin(cfg7):
        raise AssertionError(f"13c: legs flew {c_fast} and {c_par}")
    direct = fs.flight_summary(*prepare_batch(sb, ib), cfg7)
    for k in ("n_steps", "diverged", "apogee_altitude", "apogee_time", "range", "flight_time",
              "max_speed"):
        if not np.array_equal(direct[k].cpu().numpy(), getattr(fast, k).cpu().numpy(),
                              equal_nan=True):
            raise AssertionError(f"13c: the fast leg's {k} is not K1's on those lanes")
    bias = {}
    for m in metrics:
        blk = tl[m]
        step = np.spacing(abs(blk["corrected_mean"])) * 2
        if not abs((blk["corrected_mean"] - c[m]["mean"]) - blk["bias"]) <= step:
            raise AssertionError(f"13c: corrected {blk['corrected_mean']} - mean "
                                 f"{c[m]['mean']} is not the bias {blk['bias']}")
        bias[m] = [blk["bias"], blk["bias_stderr"]]
    if not (tl["n_coupled"] >= 2
            and all(math.isfinite(v) for pair in bias.values() for v in pair)):
        raise AssertionError(f"13c: {tl['n_coupled']} coupled lanes of {TWO_LEVEL_LANES}, "
                             f"{tl['mismatched_validity']} flipped, bias {bias}")
    phase("13c two-level", lanes=BENCH_LANES, build=fs.flags_name(flag_set("full_flights")[2]),
          correction_lanes=TWO_LEVEL_LANES, launches=launches["13c"], wall_s=f"{wall:.3f}",
          n_coupled=tl["n_coupled"], mismatched_validity=tl["mismatched_validity"],
          fast_leg_equal_to_k1=True, bias_and_stderr=json.dumps(bias),
          apogee_corrected=tl["apogee_altitude"]["corrected_mean"],
          apogee_corrected_stderr=tl["apogee_altitude"]["corrected_stderr"],
          fast_leg_s=tl["wall_s_legs"]["fast"], parity_leg_s=tl["wall_s_legs"]["parity"],
          block_s=tl["wall_s"])
    del c, legs, sb, ib, fast, direct
    torch.cuda.empty_cache()

    # ---- 13d: subset simulation against phase 4's direct count
    apo = run4["summary"].apogee_altitude[run4["valid_mask"]].astype(np.float64)
    threshold = float(np.percentile(apo, 99.9))
    k_dir = int((apo > threshold).sum())
    p_dir = k_dir / apo.size
    cov_dir = math.sqrt((1 - p_dir) / k_dir)
    res, wall, launched = counted(mc4.subset_tail, ic, "apogee_altitude", threshold,
                                  seed=0, **SUBSET)
    n, n_keep = SUBSET["n_per_level"], round(SUBSET["p0"] * SUBSET["n_per_level"])
    if launched != 1 + (res["n_sims"] - n) // n_keep:
        raise AssertionError(f"13d: {launched} launches for {res['n_sims']} flights")
    launches["13d tail"] = launched
    p_sub = res["probability_given_valid"]
    combined = math.hypot(res["cov"] * p_sub, cov_dir * p_dir)
    if not abs(p_sub - p_dir) <= 3 * combined:
        raise AssertionError(f"13d: subset {p_sub} (cov {res['cov']}) against the count "
                             f"{p_dir} (cov {cov_dir})")
    q, wall_q, launched_q = counted(mc4.subset_quantile, ic, "apogee_altitude", QUANTILE_P,
                                    seed=0, n_runs=2, **SUBSET)
    want = sum(1 + (rr["n_sims"] - n) // n_keep for rr in q["runs"])
    if launched_q != want or not math.isfinite(q["threshold"]):
        raise AssertionError(f"13d: quantile {q['threshold']}, {launched_q} launches")
    launches["13d quantile"] = launched_q
    d = normal_dims(mc4.wind_grid_points)
    u0 = np.random.default_rng(0).standard_normal((n, d))  # level 0 of the tail's run
    k1 = k1_on_lanes(*sample_from_normals(u0, mc4.scene, ic)[:2], cfg)
    small = time_kernel(fs, prepare_batch(*sample_from_normals(u0[:n_keep], mc4.scene, ic)[:2]),
                        cfg, f32, reps=3)
    phase("13d subset", threshold_m=threshold, p_direct=p_dir, cov_direct=cov_dir,
          p_subset=p_sub, cov_subset=res["cov"], z=(p_sub - p_dir) / combined,
          levels=res["n_levels"], flights=res["n_sims"], launches=launched,
          wall_s=f"{wall:.3f}", quantile_p=QUANTILE_P, quantile_runs=2,
          quantile_m=q["threshold"], quantile_ci95_m=json.dumps(q["ci95_threshold"]),
          quantile_levels=[rr["n_levels"] for rr in q["runs"]], quantile_flights=q["n_sims"],
          quantile_launches=launched_q, quantile_wall_s=f"{wall_q:.3f}",
          k1_ms_at_2048=f"{small['ms']:.3f}", k1_bound_ms_at_2048=small["bound_ms"],
          k1_ms_at_16384=f"{k1['kernel_ms']:.3f}", k1_bound_ms_at_16384=k1["bound_ms"],
          level0_held_lanes=k1["held_lanes"], level0_max_abs_err=k1["max_abs_err"],
          plain_ms=f"{k1['plain_ms']:.1f}")

    # ---- 13e: Sobol' indices, every active group, pairs="auto"
    clock = {"draw": 0.0, "assemble": 0.0, "kernel": 0.0, "last_kernel_end": 0.0}
    saved = {name: getattr(sobol_mod, name)
             for name in ("_draw_matrix", "_assemble", "simulate_summary_batch")}

    def timed(name, fn):
        def call(*args, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            clock[{"_draw_matrix": "draw", "_assemble": "assemble"}.get(name, "kernel")] += t1 - t0
            if name == "simulate_summary_batch":
                clock["last_kernel_end"] = t1
            return out
        return call

    for name, fn in saved.items():
        setattr(sobol_mod, name, timed(name, fn))
    try:
        t_start = time.perf_counter()
        ind, wall, launched = counted(sobol_mod.sobol_indices, mc4.scene, ic, cfg, n=BENCH_LANES,
                                      n_boot=SOBOL_BOOT, pairs="auto")
        t_end = time.perf_counter()
    finally:
        for name, fn in saved.items():
            setattr(sobol_mod, name, fn)
    launches["13e"] = launched
    if launched != ind["n_sims"] // BENCH_LANES:
        raise AssertionError(f"13e: {launched} launches for {ind['n_sims']} flights")
    shares = [v for m in metrics for order, key in (("first_order", "S"), ("total_order", "T"))
              for v in (row[key] for row in ind[m][order].values())]
    if not all(-0.05 <= v <= 1.05 for v in shares):
        raise AssertionError(f"13e: a share outside [-0.05, 1.05]: {min(shares)}, {max(shares)}")
    grid = torch.linspace(0.0, mc4.wind_grid_top, mc4.wind_grid_points, dtype=f32, device=dev)
    draws_a = sobol_mod._draw_matrix(0, 0, BENCH_LANES, mc4.wind_grid_points, f32, dev)
    k1 = k1_on_lanes(*sobol_mod._assemble(mc4.scene, ic, mc4.uncertainty_params, draws_a, grid,
                                          None, f32), cfg)
    del draws_a
    top = sorted(ind["groups"], key=lambda g: -ind["apogee_altitude"]["total_order"][g]["T"])
    phase("13e sobol indices", lanes=BENCH_LANES, groups=len(ind["groups"]),
          pairs=json.dumps(ind["pairs"]), launches=launched, n_sims=ind["n_sims"],
          n_valid=ind["n_valid"], n_boot=SOBOL_BOOT, wall_s=f"{wall:.3f}",
          draw_s=f"{clock['draw']:.3f}", assemble_s=f"{clock['assemble']:.3f}",
          kernel_s=f"{clock['kernel']:.3f}",
          bootstrap_s=f"{t_end - clock['last_kernel_end']:.3f}",
          apogee_top_T=json.dumps({g: round(ind["apogee_altitude"]["total_order"][g]["T"], 4)
                                   for g in top[:4]}),
          sum_first_order=json.dumps({m: round(ind[m]["sum_first_order"], 4) for m in metrics}),
          matrix_a_held_lanes=k1["held_lanes"], matrix_a_max_abs_err=k1["max_abs_err"],
          kernel_ms=f"{k1['kernel_ms']:.3f}", plain_ms=f"{k1['plain_ms']:.1f}",
          total_s=f"{t_end - t_start:.3f}")

    # ---- 13f: GPD and importance tails, the CLI, the two figures
    fa = a  # 13a's run
    vals = fa["summary"].apogee_altitude[fa["valid_mask"]]
    t_gpd = float(np.percentile(vals, 99.95))  # past the fit's threshold, inside counting
    gpd = tail_from_analysis(fa, "apogee_altitude", [t_gpd], n_boot=200)
    row = gpd["exceedance"][0]
    wilson = exceedance_from_analysis(fa, "apogee_altitude", [t_gpd])[0]
    if row["method"] != "gpd" or not (row["ci95"][0] <= wilson["ci95"][1]
                                      and wilson["ci95"][0] <= row["ci95"][1]):
        raise AssertionError(f"13f: GPD {row} against the count {wilson}")
    mc_i = MonteCarloAnalyzer(motor=liquid_motor(dev), sim_config=cfg,
                              importance_shift={"motor_thrust": 2.0})
    ia, _, _, launches["13f importance"] = variant_run(mc_i, ic, BENCH_LANES, 1)
    imp = exceedance_from_analysis(ia, "apogee_altitude", [threshold])[0]
    se_dir = math.sqrt(p_dir * (1 - p_dir) / apo.size)
    if imp["method"] != "importance" or not abs(imp["probability"] - p_dir) <= 4 * math.hypot(
            imp["stderr"], se_dir):
        raise AssertionError(f"13f: importance {imp} against the count {p_dir}")
    del ia
    cli = {}
    base = ["--metric", "apogee_altitude", "--threshold", repr(threshold), "--max-time",
            str(WINDOW), "--device", dev.type, "--n", str(BENCH_LANES)]
    for name, extra in (("gpd", ["--gpd"]), ("shift", ["--shift", "motor_thrust=2.0"]),
                        ("subset", ["--subset", "--n-per-level", str(SUBSET["n_per_level"])])):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            out, wall, launched = counted(tp_cli.main, base + extra)
        if json.loads(buf.getvalue()) != json.loads(json.dumps(out)) or not (
                0.0 <= out["probability"] < 1.0):
            raise AssertionError(f"13f: tail_probability {name}: {out}")
        launches[f"13f cli {name}"] = launched
        cli[name] = {"p": out["probability"], "ci95": out.get("ci95"),
                     "launches": launched, "wall_s": round(wall, 3)}
    ns = types.SimpleNamespace(plot_sobol_indices=reporting.plot_sobol_indices,
                               plot_exceedance=reporting.plot_exceedance)
    clock_f = StageClock(ns, stages={"plot_sobol_indices": "plots", "plot_exceedance": "plots"},
                         tag="13f")
    with tempfile.TemporaryDirectory() as tmp:
        paths = [ns.plot_sobol_indices(ind, tmp),
                 ns.plot_exceedance(fa, "apogee_altitude", tmp, gpd=True)]
        drawn = figures_drawn()
        if drawn and not all(p and os.path.getsize(p) > 10_000 for p in paths):
            raise AssertionError(f"13f: figures {paths}")
    phase("13f tails and cli", gpd_threshold_m=t_gpd, gpd_p=row["probability"],
          gpd_ci95=json.dumps(row["ci95"]), gpd_xi=gpd["fit"]["shape_xi"],
          count_p=wilson["probability"], count_ci95=json.dumps(wilson["ci95"]),
          importance_p=imp["probability"], importance_stderr=imp["stderr"],
          importance_n_eff_tail=imp["n_eff_tail"], count_p_phase4=p_dir,
          importance_launches=launches["13f importance"], cli=json.dumps(cli),
          figures_drawn=drawn, figures_not_drawn=clock_f.not_drawn,
          figures_wall_s=f"{clock_f.rows['plots']['wall_s']:.3f}" if drawn else "not measured")
    return launches


def sampling_variants(dev, ic, mc4, run4) -> dict:
    """Phase 12; returns each run's K1 launches (and the recording build's
    of 12d)."""
    import tempfile

    from erpl_monte_carlo_sim_tpu_torch.engine import SimConfig
    from erpl_monte_carlo_sim_tpu_torch.kernels import flight_summary as fs
    from erpl_monte_carlo_sim_tpu_torch.mc import MonteCarloAnalyzer, QmcMeanStderr
    from erpl_monte_carlo_sim_tpu_torch.mc import analyzer as analyzer_mod
    from erpl_monte_carlo_sim_tpu_torch.mc import dispersions
    from erpl_monte_carlo_sim_tpu_torch.models import liquid_motor, load_wind_ensemble_from_csvs
    from erpl_monte_carlo_sim_tpu_torch.ops import sobol
    from erpl_monte_carlo_sim_tpu_torch.random import prng_key, split

    cfg = SimConfig(max_time=WINDOW)
    f32 = torch.float32
    launches = {}

    def analyzer(**kw):
        return MonteCarloAnalyzer(motor=liquid_motor(dev), sim_config=cfg, **kw)

    # the prng run's numbers, for comparison in the same call
    _, prng_draw, prng_wall, _ = variant_run(mc4, ic, BENCH_LANES, 1)
    prng_warm = warm_draw_ms(mc4, ic, BENCH_LANES)
    prng = run4["apogee_altitude"]
    prng_stderr = prng["std"] / math.sqrt(run4["n_samples"])

    # ---- 12a: scrambled Sobol, 8 scrambles, 8 turbulence modes
    mc_a = analyzer(**SOBOL)
    mc_a.run_monte_carlo(ic, n_samples=4096, seed=1)  # the Sobol path's first calls
    a, draw, wall, launches["12a"] = variant_run(mc_a, ic, BENCH_LANES, 1)
    d = 19 + 3 * SOBOL["sobol_wind_modes"]
    # the run's seed: the scramble seeds are drawn under split(PRNGKey(0), 12)[0]
    seeds = sobol.draw_seeds(split(prng_key(0, dev), 12)[0],
                             SOBOL["sobol_scrambles"], d)
    points = sobol.sobol_points(BENCH_LANES, d, seeds)
    t0 = time.time()
    points_cpu = sobol.sobol_points(BENCH_LANES, d, seeds.cpu())
    cpu_s = time.time() - t0
    if not torch.equal(points.cpu(), points_cpu):
        raise AssertionError("12a: the card's Sobol points are not the CPU's")
    u = sobol._to_unit(points, f32)
    normal_ulps = ulps32(sobol.ndtri(u), sobol.ndtri(sobol._to_unit(points_cpu, f32)))
    lo, hi = mc_a.uncertainty_params.wind_speed_range
    if normal_ulps > 4 or not np.array_equal(a["sample"].wind_speed,
                                             (lo + (hi - lo) * u[:, 16]).cpu().numpy()):
        raise AssertionError(f"12a: normals {normal_ulps} ulps from the CPU's, or the run "
                             "did not draw these points")
    q = a["qmc_error"]["apogee_altitude"]
    if len(q["block_means"]) != SOBOL["sobol_scrambles"] or not all(
            math.isfinite(x) for x in q["block_means"] + [q["mean_stderr"]]):
        raise AssertionError(f"12a: qmc_error {q}")
    k1 = k1_on_lanes(*mc_a._last_batch, cfg)
    phase("12a sobol", lanes=BENCH_LANES, scrambles=SOBOL["sobol_scrambles"],
          wind_modes=SOBOL["sobol_wind_modes"], launches=launches["12a"], wall_s=f"{wall:.3f}",
          sampling_ms=f"{draw[0]:.3f}", prng_sampling_ms=f"{prng_draw[0]:.3f}",
          sampling_warm_ms=f"{warm_draw_ms(mc_a, ic, BENCH_LANES):.3f}",
          prng_sampling_warm_ms=f"{prng_warm:.3f}", prng_wall_s=f"{prng_wall:.3f}",
          points_equal_cpu=True, cpu_points_s=f"{cpu_s:.2f}",
          normal_max_ulps=normal_ulps, n_valid=a["n_samples"],
          apogee_mean=a["apogee_altitude"]["mean"], qmc_block_means=len(q["block_means"]),
          apogee_qmc_stderr=q["mean_stderr"], apogee_prng_iid_stderr=prng_stderr, **k1)
    del a, points, points_cpu, u

    # ---- 12b: antithetic pairs
    mc_b = analyzer(antithetic=True)
    b, draw, wall, launches["12b"] = variant_run(mc_b, ic, BENCH_LANES, 1)
    std = dispersions._prng_draws(split(prng_key(0, dev), 12), BENCH_LANES, f32)
    held = mirrored_channels(b["sample"], std, mc_b.uncertainty_params, mc_b.scene.motor,
                             BENCH_LANES)
    k1 = k1_on_lanes(*mc_b._last_batch, cfg)
    phase("12b antithetic", lanes=BENCH_LANES, launches=launches["12b"], wall_s=f"{wall:.3f}",
          sampling_ms=f"{draw[0]:.3f}",
          sampling_warm_ms=f"{warm_draw_ms(mc_b, ic, BENCH_LANES):.3f}",
          channels_mirrored=held, n_valid=b["n_samples"],
          apogee_mean=b["apogee_altitude"]["mean"], **k1)
    del b, std

    # ---- 12c: importance tilt of the motor's thrust
    mc_c = analyzer(importance_shift={"motor_thrust": 2.0})
    c, draw, wall, launches["12c"] = variant_run(mc_c, ic, BENCH_LANES, 1)
    imp = c["importance"]
    w = np.exp(imp["log_weights"])
    w_se = w.std() / math.sqrt(w.size)
    mine = imp["apogee_altitude"]
    apogee_z = (mine["mean"] - prng["mean"]) / math.hypot(mine["stderr"], prng_stderr)
    if not (abs(w.mean() - 1.0) <= 4 * w_se and abs(apogee_z) <= 4):
        raise AssertionError(f"12c: mean weight {w.mean()} (stderr {w_se}), weighted apogee "
                             f"{mine} against the prng run's {prng['mean']} ({apogee_z} sigma)")
    k1 = k1_on_lanes(*mc_c._last_batch, cfg)
    phase("12c importance", lanes=BENCH_LANES, shift="motor_thrust:2.0",
          launches=launches["12c"], wall_s=f"{wall:.3f}", sampling_ms=f"{draw[0]:.3f}",
          sampling_warm_ms=f"{warm_draw_ms(mc_c, ic, BENCH_LANES):.3f}",
          mean_weight=float(w.mean()), weight_stderr=w_se, n_eff=mine["n_eff"],
          apogee_weighted=mine["mean"], apogee_weighted_stderr=mine["stderr"],
          apogee_prng=prng["mean"], apogee_z=apogee_z,
          apogee_tilted=c["apogee_altitude"]["mean"], **k1)
    del c, w

    # ---- 12d: a three-member forecast ensemble, 4 slabs
    with tempfile.TemporaryDirectory() as tmp:
        grid, ens = load_wind_ensemble_from_csvs(write_ensemble(tmp))
    mc_d = analyzer()
    mc_d.base_altitude_profile, mc_d.base_wind_profile = grid, ens
    dd, draw, wall, launches["12d"] = variant_run(mc_d, ic, BENCH_LANES, 4,
                                                  lane_slab=ENSEMBLE_SLAB)
    ensemble_groupby(dd, ens.shape[0])
    # one lane of each slab
    ids = np.arange(4) * ENSEMBLE_SLAB + np.array([11, 4321, 99, ENSEMBLE_SLAB - 1]) % ENSEMBLE_SLAB
    s, _, launches["12d record"], resim_wall = resimulated(mc_d, ids, "12d", 4)
    same_summary(s, dd, ids, "12d")
    members = [int(analyzer_mod._draw_slab(mc_d, ic, g // ENSEMBLE_SLAB, ENSEMBLE_SLAB, 0,
                                           (grid, ens))[2].wind_member[g % ENSEMBLE_SLAB])
               for g in ids]
    if members != dd["wind_members"][ids].tolist():
        raise AssertionError(f"12d: re-drawn members {members}")
    k1 = k1_on_lanes(*analyzer_mod._draw_slab(mc_d, ic, 0, ENSEMBLE_SLAB, 0, (grid, ens))[:2],
                     cfg)
    post = dd["ensemble"]["post_stratified"]["apogee_altitude"]
    phase("12d forecast ensemble", lanes=BENCH_LANES, slabs=4, members=ens.shape[0],
          launches=launches["12d"], wall_s=f"{wall:.3f}",
          sampling_ms=json.dumps([round(x, 3) for x in draw]),
          sampling_warm_ms=f"{warm_draw_ms(mc_d, ic, ENSEMBLE_SLAB, slab=ENSEMBLE_SLAB):.3f}",
          members_drawn=[row["n_drawn"] for row in dd["ensemble"]["members"]],
          members_valid=[row["n_valid"] for row in dd["ensemble"]["members"]],
          apogee_by_member=[float(row["apogee_altitude"]["mean"])
                            for row in dd["ensemble"]["members"]],
          apogee_post_stratified=post["mean"], apogee_post_stratified_stderr=post["stderr"],
          groupby_equal=True, resimulated=ids.tolist(), record_launches=launches["12d record"],
          resim_wall_s=f"{resim_wall:.3f}", members_equal=True, **k1)
    del dd, s

    # ---- 12e: slabbed Sobol: 4 slabs, run_to_precision, kill and resume
    with DrawSplit() as split:
        e, draw, wall, launches["12e"] = variant_run(mc_a, ic, LARGE_LANES, 4,
                                                     lane_slab=BENCH_LANES)
    phase("12e draw split", slabs=4, **split.numbers())
    q = e["qmc_error"]["apogee_altitude"]
    crit = QmcMeanStderr("apogee_altitude", 1.0)
    for k in range(4):
        part = slice(k * BENCH_LANES, (k + 1) * BENCH_LANES)
        crit.update(e["metrics"]["apogee_altitude"][part][e["valid_mask"][part]])
    target = crit.stderr()  # met after the 4th slab, the criterion's minimum
    torch.cuda.synchronize()
    fs.launches = 0
    t0 = time.time()
    p = mc_a.run_to_precision(ic, criteria=[{"metric": "apogee_altitude",
                                             "qmc_mean_stderr": target}],
                              max_samples=2 * LARGE_LANES, seed=0, lane_slab=BENCH_LANES)
    wall_p, launches["12e precision"] = time.time() - t0, fs.launches
    seq = p.pop("sequential")
    if (seq["n_used"], seq["satisfied"], launches["12e precision"]) != (LARGE_LANES, True, 4):
        raise AssertionError(f"12e: run_to_precision {seq}, {fs.launches} launches")
    same_analysis(p, e)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "run.ckpt.npz")
        draw_slab, calls = analyzer_mod._draw_slab, []

        def dying(*args, **kw):
            if len(calls) == 2:
                raise RuntimeError("simulated crash")
            calls.append(1)
            return draw_slab(*args, **kw)

        analyzer_mod._draw_slab = dying
        try:
            mc_a.run_monte_carlo(ic, n_samples=LARGE_LANES, seed=0, lane_slab=BENCH_LANES,
                                 checkpoint_path=path, checkpoint_every=1)
            raise AssertionError("12e: the run did not stop at its third draw")
        except RuntimeError as err:
            if "simulated crash" not in str(err):
                raise
        finally:
            analyzer_mod._draw_slab = draw_slab
        r, _, wall_r, launches["12e resume"] = variant_run(
            mc_a, ic, LARGE_LANES, 2, lane_slab=BENCH_LANES, checkpoint_path=path,
            checkpoint_every=1)
        same_analysis(r, e)
        if os.path.exists(path):
            raise AssertionError("12e: the checkpoint outlived the run")
    phase("12e slabbed sobol", lanes=LARGE_LANES, slabs=4, launches=launches["12e"],
          wall_s=f"{wall:.3f}", sampling_ms=json.dumps([round(x, 3) for x in draw]),
          qmc_block_means=len(q["block_means"]), apogee_qmc_stderr=q["mean_stderr"],
          precision_target=target, precision_n_used=seq["n_used"],
          precision_launches=launches["12e precision"], precision_wall_s=f"{wall_p:.3f}",
          precision_equal_to_run=True, resume_launches=launches["12e resume"],
          resume_wall_s=f"{wall_r:.3f}", resume_equal_to_run=True)
    return launches


# ---------------------------------------------------------------- phase 14
def modes_scene(scene_b, k: int):
    """``scene_b`` with its per-lane tables compressed to ``k`` modes."""
    from erpl_monte_carlo_sim_tpu_torch.models import compress_wind, wind_mode_basis

    q = wind_mode_basis(scene_b.wind_model, scene_b.wind.altitudes.cpu().numpy(), k)
    return dataclasses.replace(scene_b, wind=compress_wind(scene_b.wind, q))


def wind_modes(dev, ic, run4) -> dict:
    """Phase 14: mode-compressed wind. Returns the K1 launches of its runs."""
    from erpl_monte_carlo_sim_tpu_torch.engine import SimConfig
    from erpl_monte_carlo_sim_tpu_torch.engine.batch import prepare_batch
    from erpl_monte_carlo_sim_tpu_torch.kernels import flight_summary as fs
    from erpl_monte_carlo_sim_tpu_torch.mc import MonteCarloAnalyzer
    from erpl_monte_carlo_sim_tpu_torch.models import liquid_motor

    cfg = SimConfig(max_time=WINDOW)
    launches = {}
    # 14a: K1 on the expanded tables against the plain modes query
    for dtype, n in ((torch.float32, 1024), (torch.float64, 256)):
        dt = str(dtype).split(".")[-1]
        scene_b, ic_b = sample_batch(n, dtype)
        knots = scene_b.wind.altitudes.numel()
        for k in (MODES_K, knots):
            t0 = time.time()
            ref, got = kernel_and_plain(modes_scene(scene_b, k), ic_b, cfg)
            extra = {}
            if k == knots:  # full rank: the realized tables' flights too
                extra["full_table_max_abs_err"] = compare(
                    fs.flight_summary(*prepare_batch(scene_b, ic_b), cfg), got, dtype)
            phase(f"14a kernel=modes query {dt} k={k}", lanes=n, max_abs_err=compare(ref, got, dtype),
                  rtol=RTOL[dtype], both_seconds=f"{time.time() - t0:.2f}", **extra)
    # 14b: the main path with wind_table_modes
    mc = MonteCarloAnalyzer(motor=liquid_motor(dev), sim_config=cfg, wind_table_modes=MODES_K)
    mc.run_monte_carlo(ic, n_samples=1024, seed=0)  # warm-up
    a, wall, launches["14b"] = counted(mc.run_monte_carlo, ic, n_samples=BENCH_LANES, seed=0)
    if launches["14b"] != 1 or a["n_samples"] <= 0:
        raise AssertionError(f"modes run: {launches['14b']} launches, {a['n_samples']} valid")
    scene_b, ic_b = mc._last_batch
    modes = mc._last_modes
    expand_ms, (table, _) = cuda_ms(lambda: fs.expanded(modes, cfg), reps=3)
    args = prepare_batch(dataclasses.replace(scene_b, wind=modes), ic_b)
    kernel_ms, _ = cuda_ms(lambda: fs.flight_summary(*args, cfg), reps=2)
    sigma = run4["apogee_altitude"]["std"] / math.sqrt(run4["n_samples"])
    drift = a["apogee_altitude"]["mean"] - run4["apogee_altitude"]["mean"]
    phase("14b modes run", lanes=BENCH_LANES, k=MODES_K, modes=modes.basis.shape[1],
          launches=launches["14b"], wall_s=f"{wall:.3f}", expansion_ms=f"{expand_ms:.3f}",
          kernel_with_expansion_ms=f"{kernel_ms:.3f}",
          table_mb=f"{table.numel() * table.element_size() / 2**20:.1f}",
          scores_mb=f"{modes.scores.numel() * modes.scores.element_size() / 2**20:.1f}",
          apogee_mean=a["apogee_altitude"]["mean"],
          apogee_mean_phase4=run4["apogee_altitude"]["mean"], drift_m=drift,
          drift_in_stderr=drift / sigma, n_valid=a["n_samples"])
    del table, args
    # 14c: the two-level correction, its fast leg compressed
    mc2 = MonteCarloAnalyzer(motor=liquid_motor(dev), sim_config=cfg, wind_table_modes=MODES_K,
                             two_level_lanes=TWO_LEVEL_LANES)
    a2, wall2, launches["14c"] = counted(mc2.run_monte_carlo, ic, n_samples=BENCH_LANES, seed=0)
    blk = a2["two_level"]
    apo = blk["apogee_altitude"]
    if (launches["14c"] != 3 or blk["n_coupled"] < 0.9 * TWO_LEVEL_LANES
            or not math.isfinite(apo["bias"]) or not apo["abs_max_delta"] > 0.0):
        raise AssertionError(f"modes two-level: {launches['14c']} launches, block {blk}")
    phase("14c two-level modes", lanes=BENCH_LANES, coupled=blk["n_coupled"],
          launches=launches["14c"], wall_s=f"{wall2:.3f}", legs_s=json.dumps(blk["wall_s_legs"]),
          apogee_bias_m=apo["bias"], apogee_bias_stderr_m=apo["bias_stderr"],
          apogee_abs_max_delta_m=apo["abs_max_delta"], corrected_mean=apo["corrected_mean"])
    # 14d: re-simulation flies the compressed tables the run flew
    ids = spread(BENCH_LANES, MODES_RESIM)
    s, _, launched, wall_r = resimulated(mc, ids, "14d", 1)
    same_summary(s, a, ids, "14d single call")
    slabbed = MonteCarloAnalyzer(motor=liquid_motor(dev), sim_config=cfg,
                                 wind_table_modes=MODES_K)
    a3, wall3, launches["14d"] = counted(slabbed.run_monte_carlo, ic, n_samples=4 * MODES_SLAB,
                                         lane_slab=MODES_SLAB, seed=0)
    ids3 = np.arange(4) * MODES_SLAB + np.array([5, 17, 29, 41]) % MODES_SLAB
    s3, _, launched3, wall_r3 = resimulated(slabbed, ids3, "14d slabbed", 4)
    same_summary(s3, a3, ids3, "14d slabbed")
    phase("14d re-simulated modes", lanes=ids.tolist(), launches=launched, wall_s=f"{wall_r:.3f}",
          slabbed_lanes=ids3.tolist(), slabbed_run_launches=launches["14d"],
          slabbed_record_launches=launched3, slabbed_wall_s=f"{wall3:.3f}",
          equal_to_run="bit for bit")
    # 14e: wind_table_bf16 rounds the scores, the table is not rounded again
    cfg_bf = SimConfig(max_time=WINDOW, wind_table_bf16=True)
    scene_b, ic_b = sample_batch(1024, torch.float32)
    modes_b = modes_scene(scene_b, MODES_K)
    ref, got = kernel_and_plain(modes_b, ic_b, cfg_bf)
    flown = fs.expanded(modes_b.wind, cfg_bf)[1]
    phase("14e modes bf16", lanes=1024, k=MODES_K, build=fs.flags_name(fs.kernel_flags(flown)),
          max_abs_err=compare(ref, got, torch.float32))
    torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------- phase 15
def with_thrust(scene_b, ts):
    return dataclasses.replace(scene_b, motor=dataclasses.replace(scene_b.motor, thrust_scale=ts))


def timed_grad(fn, scene, ic, cfg, objective, wrt):
    """``fn``'s metrics and the gradient of ``objective(metrics)`` with
    respect to the tensors ``wrt``, each pass timed with the card
    synchronized: ``(metrics, grads, forward s, backward s)``."""
    import erpl_monte_carlo_sim_tpu_torch.engine.diff as diff

    torch.cuda.synchronize()
    diff.capture_seconds = 0.0
    t0 = time.time()
    m = fn(scene, ic, cfg)
    torch.cuda.synchronize()
    t1 = time.time()
    grads = torch.autograd.grad(objective(m), wrt)
    torch.cuda.synchronize()
    return ({k: v.detach() for k, v in m.items()}, grads, t1 - t0 - diff.capture_seconds,
            time.time() - t1, diff.capture_seconds)


def landing_fd(fs, scene, ic1, cfg, eps):
    """Central differences in the thrust scale of the linearly backtracked
    range and flight time, through two float64 K1 flights (the JAX package's
    recipe, tests/test_sensitivity.py:121-173)."""
    from erpl_monte_carlo_sim_tpu_torch.engine import InitialConditions
    from erpl_monte_carlo_sim_tpu_torch.engine.batch import _summary_pytree, prepare_batch

    ic2 = InitialConditions(*(v.expand(2, 3).contiguous() for v in (
        ic1.position, ic1.velocity, ic1.attitude, ic1.angular_velocity)))
    ts = torch.tensor([1.0 - eps, 1.0 + eps], dtype=torch.float64, device=ic1.position.device)
    out = _summary_pytree(fs.flight_summary(*prepare_batch(with_thrust(scene, ts), ic2), cfg))
    pos, vel = out.landing_position.cpu().numpy(), out.final_velocity.cpu().numpy()
    delta = (cfg.ground_altitude - pos[:, 2]) / vel[:, 2]
    land = pos[:, :2] + vel[:, :2] * delta[:, None]
    vals = {"range": np.hypot(land[:, 0], land[:, 1]),
            "flight_time": out.flight_time.cpu().numpy() + delta}
    return {k: float(v[1] - v[0]) / (2 * eps) for k, v in vals.items()}, vals


def differentiable(dev) -> dict:
    """Phase 15: the differentiable flight, float64. Returns the K1
    launches of its runs (15e's tilted run)."""
    import erpl_monte_carlo_sim_tpu_torch.engine.diff as diff
    from erpl_monte_carlo_sim_tpu_torch.cli.sensitivity import variance_budget
    from erpl_monte_carlo_sim_tpu_torch.engine import InitialConditions, SimConfig
    from erpl_monte_carlo_sim_tpu_torch.engine.batch import prepare_batch
    from erpl_monte_carlo_sim_tpu_torch.kernels import flight_summary as fs
    from erpl_monte_carlo_sim_tpu_torch.mc import MonteCarloAnalyzer, auto_shift, optimize_robust
    from erpl_monte_carlo_sim_tpu_torch.models import (RocketParams, WindField, liquid_motor,
                                                       nominal_scene)

    f64 = torch.float64
    cfg = SimConfig(max_time=WINDOW)
    # 15a, 15b: per-lane d(apogee)/d(thrust_scale) of 256 dispersed lanes
    scene_b, ic_b = sample_batch(DIFF_LANES, f64)
    ts0 = scene_b.motor.thrust_scale.detach()
    ts = ts0.clone().requires_grad_(True)
    m, (g,), fwd_s, bwd_s, cap_s = timed_grad(diff.simulate_metrics_diff,
                                              with_thrust(scene_b, ts), ic_b, cfg,
                                              lambda m: m["apogee_altitude"].sum(), [ts])
    k1 = fs.flight_summary(*prepare_batch(scene_b, ic_b), cfg)
    steps = int(k1["n_steps"].max()) + int(torch.round(k1["rail_exit_time"].max() / cfg.rail_dt))
    for k in ("apogee_altitude", "max_speed"):
        err = float(((m[k] - k1[k]).abs() / k1[k].abs()).max())
        if not err <= RTOL[f64]:
            raise AssertionError(f"15a: the primal's {k} is {err:.3g} from K1's")
    phase("15a primal=K1", lanes=DIFF_LANES, rtol=RTOL[f64], apogee_rel_err=float(
        ((m["apogee_altitude"] - k1["apogee_altitude"]).abs() / k1["apogee_altitude"]).max()),
        max_speed_rel_err=float(((m["max_speed"] - k1["max_speed"]).abs()
                                 / k1["max_speed"]).max()))
    hi = fs.flight_summary(*prepare_batch(with_thrust(scene_b, ts0 + DIFF_EPS), ic_b), cfg)
    lo = fs.flight_summary(*prepare_batch(with_thrust(scene_b, ts0 - DIFF_EPS), ic_b), cfg)
    fd = (hi["apogee_altitude"] - lo["apogee_altitude"]) / (2 * DIFF_EPS)
    same = (hi["n_steps"] == lo["n_steps"]) & (hi["rail_exit_time"] == lo["rail_exit_time"])
    rel = ((g - fd).abs() / fd.abs())[same]
    if not bool(torch.isfinite(g).all()) or not float(rel.max()) <= DIFF_FD_RTOL:
        raise AssertionError(f"15b: gradient {float(rel.max()):.3g} from the differences")
    phase("15b gradient=K1 differences", lanes=DIFF_LANES, eps=DIFF_EPS, rtol=DIFF_FD_RTOL,
          compared=int(same.sum()), left_out_step_change=int((~same).sum()),
          max_rel_err=float(rel.max()), median_rel_err=float(rel.median()),
          grad_median=float(g.median()), capture_s=f"{cap_s:.2f}", forward_s=f"{fwd_s:.2f}",
          backward_s=f"{bwd_s:.2f}", steps=steps,
          ms_per_step=f"{1e3 * (fwd_s + bwd_s) / steps:.2f}")
    del m, g, k1, hi, lo
    # 15c: the graphed segments against eager autograd on the card
    scene_c, ic_c = head((scene_b, ic_b), DIFF_LANES, GRAPHED_LANES)
    cfg_c = SimConfig(max_time=GRAPHED_WINDOW)
    out = {}
    for name, fn in (("graphed", diff.simulate_metrics_diff), ("eager", diff.metrics_reference)):
        tc = scene_c.motor.thrust_scale.detach().clone().requires_grad_(True)
        wt = scene_c.wind.wind.detach().clone().requires_grad_(True)
        sc = dataclasses.replace(with_thrust(scene_c, tc),
                                 wind=dataclasses.replace(scene_c.wind, wind=wt))
        out[name] = timed_grad(fn, sc, ic_c, cfg_c, lambda m: (m["apogee_altitude"].sum()
                                                               + m["range"].sum()), [tc, wt])
    (m_g, g_g, fg, bg, cg), (m_e, g_e, fe, be, _) = out["graphed"], out["eager"]
    same_metrics = all(torch.equal(m_g[k], m_e[k]) for k in m_e)
    errs = [float(((a - b).abs() / b.abs().max()).max()) for a, b in zip(g_g, g_e)]
    if not same_metrics or not max(errs) <= 1e-9:
        raise AssertionError(f"15c: graphed != eager (metrics equal {same_metrics}, {errs})")
    phase("15c graphed=eager", lanes=GRAPHED_LANES, max_time=GRAPHED_WINDOW,
          metrics="bit for bit", thrust_grad_rel_err=errs[0], wind_grad_rel_err=errs[1],
          graphed_capture_s=f"{cg:.2f}", graphed_forward_s=f"{fg:.2f}",
          graphed_backward_s=f"{bg:.2f}",
          eager_forward_s=f"{fe:.2f}", eager_backward_s=f"{be:.2f}")
    del out
    # 15d: a landed flight's range and flight time against K1's differences
    pm = LANDING_PROPELLANT
    calm = WindField.zero(dev, f64)
    scene = nominal_scene(liquid_motor(dev, f64, propellant_mass=pm), wind=calm)
    scene = dataclasses.replace(scene, rocket=RocketParams.create(dev, f64, propellant_mass=pm))
    ic = InitialConditions.vertical_launch(dev, f64)
    ic1 = InitialConditions(*(v[None] for v in (ic.position, ic.velocity, ic.attitude,
                                                ic.angular_velocity)))
    cfg_d = SimConfig(max_time=LANDING_WINDOW)
    fd, vals = landing_fd(fs, scene, ic1, cfg_d, LANDING_EPS)
    if not vals["flight_time"].max() < LANDING_WINDOW - 5.0:
        raise AssertionError(f"15d: the flights did not land: {vals['flight_time']}")
    ic2 = InitialConditions(*(v.expand(2, 3).contiguous() for v in (
        ic1.position, ic1.velocity, ic1.attitude, ic1.angular_velocity)))
    t2 = torch.ones(2, dtype=f64, device=dev, requires_grad=True)
    # lane 0 differentiates the range, lane 1 the flight time: one reverse pass
    m, (g,), fwd_s, bwd_s, cap_s = timed_grad(
        diff.simulate_metrics_diff, with_thrust(scene, t2), ic2, cfg_d,
        lambda m: m["range"][0] + m["flight_time"][1], [t2])
    ad = {"range": float(g[0]), "flight_time": float(g[1])}
    rel = {k: abs(ad[k] / fd[k] - 1.0) for k in ad}
    if not all(math.isfinite(v) and v <= LANDING_RTOL for v in rel.values()):
        raise AssertionError(f"15d: gradients {ad} against differences {fd}")
    phase("15d landed flight", propellant_kg=pm, eps=LANDING_EPS, rtol=LANDING_RTOL,
          flight_time_s=float(m["flight_time"][1]), range_m=float(m["range"][0]),
          d_range=ad["range"], fd_range=fd["range"], d_flight_time=ad["flight_time"],
          fd_flight_time=fd["flight_time"], rel_err=json.dumps(rel), capture_s=f"{cap_s:.2f}",
          forward_s=f"{fwd_s:.2f}", backward_s=f"{bwd_s:.2f}")
    # 15e: the walls of the users' entry points
    launches = {}
    cfg_e = SimConfig(max_time=USER_WINDOW)
    nominal = nominal_scene(liquid_motor(dev, f64), wind=calm)
    torch.cuda.synchronize()
    t0 = time.time()
    budget = variance_budget(nominal, ic, cfg_e)
    torch.cuda.synchronize()
    budget_s = time.time() - t0
    t0 = time.time()
    hist = optimize_robust(nominal, ic, cfg_e, wrt="rocket.fin_span", n_lanes=DIFF_LANES,
                           steps=ROBUST_EVALS)
    torch.cuda.synchronize()
    robust_s = time.time() - t0
    if len(hist) != ROBUST_EVALS or not all(math.isfinite(h[1]) for h in hist):
        raise AssertionError(f"15e: optimize_robust history {list(hist)}")
    threshold = 1.05 * budget["apogee_m"]
    t0 = time.time()
    shift, info = auto_shift(nominal, ic, cfg_e, "apogee_altitude", threshold)
    torch.cuda.synchronize()
    shift_s = time.time() - t0
    tilted = MonteCarloAnalyzer(motor=liquid_motor(dev), sim_config=cfg_e, importance_shift=shift)
    a, tilted_s, launches["15e"] = counted(tilted.run_monte_carlo,
                                           InitialConditions.vertical_launch(dev),
                                           n_samples=BENCH_LANES, seed=0)
    # the landed flight's cost per step past its capture (one lane: the step
    # is launch-bound), and the CLIs' default window of 24,000 steps
    ms_step = 1e3 * (fwd_s + bwd_s) / (float(m["flight_time"][1]) / cfg_d.dt)
    phase("15e walls", max_time=USER_WINDOW, variance_budget_s=f"{budget_s:.2f}",
          apogee_sigma_first_order_m=budget["apogee_sigma_first_order_m"],
          optimize_robust_s=f"{robust_s:.2f}", robust_lanes=DIFF_LANES,
          robust_evals=len(hist), robust_best=json.dumps(hist.info["value"]),
          auto_shift_s=f"{shift_s:.2f}", shift=json.dumps(shift), tilted_run_s=f"{tilted_s:.3f}",
          tilted_launches=launches["15e"], tilted_n_valid=a["n_samples"],
          max_time_120_projection_s=f"{cap_s + 24_000 * ms_step / 1e3:.0f}",
          ms_per_step_one_lane=f"{ms_step:.2f}")
    torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------- phase 16
def timed_ms(mesh, fn):
    """``fn()`` with the card and every rank synchronized before it and the
    card after: ``(ms, result)``."""
    import torch.distributed as dist

    torch.cuda.synchronize(mesh.device)
    if mesh.group is not None:
        dist.barrier(group=mesh.group)
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize(mesh.device)
    return 1e3 * (time.perf_counter() - t0), out


def rank_collectives(mesh, summary_np, valid_np) -> tuple:
    """This rank's block of a run's lanes through the summaries' gather and
    each collective, each timed: ``(results, ms)``."""
    from erpl_monte_carlo_sim_tpu_torch.parallel import (collective_footprint_moments,
                                                         collective_stats,
                                                         collective_tail_reservoir, gather_lanes)
    from erpl_monte_carlo_sim_tpu_torch.parallel.mesh import lane_block
    from erpl_monte_carlo_sim_tpu_torch.utils.tree import tree_map

    dev = mesh.device
    block = lane_block(int(valid_np.shape[0]), mesh)
    local = tree_map(lambda x: torch.as_tensor(np.asarray(x)[block]).to(dev), summary_np)
    valid = torch.as_tensor(valid_np[block]).to(dev)
    ms, res = {}, {}
    ms["gather"], full = timed_ms(mesh, lambda: gather_lanes(local, mesh))
    res["gather_equal"] = all(
        np.array_equal(np.asarray(a), b.cpu().numpy(), equal_nan=True)
        for (_, a), (_, b) in zip(leaves(summary_np), leaves(full)))
    for k in METRICS:
        ms[f"stats {k}"], st = timed_ms(mesh, lambda: collective_stats(
            getattr(local, k).double(), valid, mesh))
        res[k] = {n: v.cpu().numpy() for n, v in st.items()}
    landing = local.landing_position.double()
    ms["footprint"], res["footprint"] = timed_ms(
        mesh, lambda: collective_footprint_moments(landing, valid, mesh))
    ms["tail_reservoir"], r = timed_ms(mesh, lambda: collective_tail_reservoir(
        local.apogee_altitude, valid, mesh, k=PARALLEL_K))
    res["tail"] = (r.n, r.hi, r.lo)
    return res, {k: round(v, 3) for k, v in ms.items()}


def check_collectives(res: dict, run: dict, tag: str) -> float:
    """``rank_collectives``' results against the single-device statistics of
    the same run: the exact-path intervals, counts, extremes and tail
    reservoir bit for bit, mean, std, percentiles and the footprint moments
    within ``STATS_RTOL``. Returns the largest relative difference."""
    from erpl_monte_carlo_sim_tpu_torch.mc import MonteCarloAnalyzer, TailReservoir
    from erpl_monte_carlo_sim_tpu_torch.mc.analyzer import _host_stats

    if not res["gather_equal"]:
        raise AssertionError(f"{tag}: the gathered summaries are not the run's")
    valid = run["valid_mask"]
    worst = 0.0

    def rel(a, b, what):
        nonlocal worst
        a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
        err = float(np.max(np.abs(a - b) / np.maximum(np.abs(b), 1e-300)))
        worst = max(worst, err)
        if err > STATS_RTOL:
            raise AssertionError(f"{tag} {what}: {a} against {b} ({err:.3g})")

    for k in METRICS:
        vals = np.asarray(getattr(run["summary"], k), np.float64)
        host, st = _host_stats(vals, valid), res[k]
        if not np.array_equal(st["percentile_ci"], np.asarray(host["percentile_ci"]),
                              equal_nan=True):
            raise AssertionError(f"{tag} {k}: percentile_ci differs from the host's")
        if int(st["n"]) != int((valid & np.isfinite(vals)).sum()):
            raise AssertionError(f"{tag} {k}: count {int(st['n'])}")
        if float(st["min"]) != host["min"] or float(st["max"]) != host["max"]:
            raise AssertionError(f"{tag} {k}: extremes differ")
        for s in ("mean", "std", "percentiles"):
            rel(st[s], host[s], f"{k} {s}")
    landing = torch.as_tensor(np.asarray(run["summary"].landing_position, np.float64))
    ref = MonteCarloAnalyzer._footprint_moments(landing, torch.as_tensor(valid))
    if res["footprint"][0] != ref[0]:
        raise AssertionError(f"{tag}: footprint count {res['footprint'][0]} against {ref[0]}")
    rel(res["footprint"][1:], ref[1:], "footprint moments")
    apo = np.asarray(run["summary"].apogee_altitude)
    reservoir = TailReservoir(PARALLEL_K)
    reservoir.add(apo[valid])
    n, hi, lo = res["tail"]
    if n != reservoir.n or not (np.array_equal(hi, reservoir.hi)
                                and np.array_equal(lo, reservoir.lo)):
        raise AssertionError(f"{tag}: the tail reservoir differs from the host's")
    return worst


def parallel_rank(mesh, lanes: int, large_lanes: int) -> dict:
    """One rank of phases 16b and 16c: the analyzer with the mesh (a warm-up
    call, the single call, the 4-slab run), ``pod_scale``, then the
    collectives on its block of the single call's lanes; launches counted
    from 0 before each run, walls between synchronized ranks."""
    import io

    import torch.distributed as dist

    from erpl_monte_carlo_sim_tpu_torch.engine import InitialConditions, SimConfig
    from erpl_monte_carlo_sim_tpu_torch.kernels import flight_summary as fs
    from erpl_monte_carlo_sim_tpu_torch.mc import MonteCarloAnalyzer
    from erpl_monte_carlo_sim_tpu_torch.models import liquid_motor
    from erpl_monte_carlo_sim_tpu_torch.parallel import pod_scale

    dev = mesh.device
    ic = InitialConditions.vertical_launch(dev)
    mc = MonteCarloAnalyzer(motor=liquid_motor(dev), sim_config=SimConfig(max_time=WINDOW),
                            mesh=mesh, max_lanes_per_call=lanes)
    mc.run_monte_carlo(ic, n_samples=lanes, seed=0)  # warm-up
    walls, launches = {}, {}

    def driven(tag, fn):
        fs.launches = 0
        ms, out = timed_ms(mesh, fn)
        walls[tag], launches[tag] = round(ms / 1e3, 3), fs.launches
        return out

    single = driven("single", lambda: mc.run_monte_carlo(ic, n_samples=lanes, seed=0))
    slabbed = driven("slabbed", lambda: mc.run_monte_carlo(ic, n_samples=large_lanes, seed=0))
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        pod = driven("pod_scale", lambda: pod_scale.main(lanes, slab=lanes, steps_cfg=WINDOW,
                                                         device=dev))
    res, ms = rank_collectives(mesh, single["summary"], single["valid_mask"])
    return {"rank": mesh.rank, "size": mesh.size, "device": str(dev),
            "backend": dist.get_backend(mesh.group), "walls": walls, "launches": launches,
            "single": plain_data(single), "slabbed": plain_data(slabbed), "pod": pod,
            "pod_line": buf.getvalue().strip().splitlines()[-1], "collectives": res,
            "collective_ms": ms}


def pod_extremes(dev, lanes: int, size: int) -> dict:
    """The apogee extremes of ``pod_scale``'s one slab of ``lanes`` lanes over
    ``size`` ranks, from a single rank: every rank's draw flown here and
    their apogees through ``collective_tail_reservoir`` on a mesh of one."""
    from erpl_monte_carlo_sim_tpu_torch.engine import (InitialConditions, SimConfig,
                                                       simulate_summary_batch)
    from erpl_monte_carlo_sim_tpu_torch.models import liquid_motor, nominal_scene
    from erpl_monte_carlo_sim_tpu_torch.parallel import collective_tail_reservoir, make_mesh
    from erpl_monte_carlo_sim_tpu_torch.parallel.pod_scale import rank_lanes

    scene, ic = nominal_scene(liquid_motor(dev)), InitialConditions.vertical_launch(dev)
    apo = torch.cat([simulate_summary_batch(*rank_lanes(scene, ic, 0, 0, r, lanes // size,
                                                        size)[:2],
                                            SimConfig(max_time=WINDOW)).apogee_altitude
                     for r in range(size)])
    r = collective_tail_reservoir(apo, None, make_mesh(dev), k=PARALLEL_K)
    return {"n": r.n, "max": float(r.hi[-1]), "min": float(r.lo[0])}


def check_ranks(results: list, run4: dict, run9a: dict, dev, tag: str) -> dict:
    """Phases 16b/16c on the parent's side: every rank's analyses are phase
    4's and 9a's bit for bit, its collectives the single device's, the
    ranks' ``pod_scale`` lines the same but for wall and rate, with the
    single-rank extremes. Returns the numbers to print."""
    size = len(results)
    for r in results:
        same_analysis(r["single"], run4)
        same_analysis(r["slabbed"], run9a)
        for run in ("single", "slabbed"):
            if r[run]["performance"]["cores_used"] != size:
                raise AssertionError(f"{tag}: cores_used {r[run]['performance']['cores_used']}")
        if r["launches"] != {"single": 1, "slabbed": 4, "pod_scale": 1}:
            raise AssertionError(f"{tag} rank {r['rank']}: launches {r['launches']}")
    worst = max(check_collectives(r["collectives"], run4, f"{tag} rank {r['rank']}")
                for r in results)
    lines = [{k: v for k, v in json.loads(r["pod_line"]).items()
              if k not in ("wall_s", "traj_per_s")} for r in results]
    if any(x != lines[0] for x in lines) or lines[0]["processes"] != size:
        raise AssertionError(f"{tag}: the ranks' pod_scale lines differ: {lines}")
    want = pod_extremes(dev, BENCH_LANES, size)
    if lines[0]["apogee_extremes"] != want:
        raise AssertionError(f"{tag}: pod_scale extremes {lines[0]['apogee_extremes']}, "
                             f"single rank {want}")
    return {"ranks": size, "backend": results[0]["backend"],
            "devices": sorted({r["device"] for r in results}),
            "launches": [r["launches"] for r in results],
            "walls_s": [r["walls"] for r in results],
            "collective_ms": [r["collective_ms"] for r in results],
            "pod_scale": lines[0], "pod_wall_s": [r["pod"]["wall_s"] for r in results],
            "stats_worst_rel": worst}


def multi_rank(dev, ic, run4: dict, run9a: dict, card: str) -> dict:
    """Phase 16; returns the K1 launches of each run, per rank."""
    import torch.distributed as dist

    from erpl_monte_carlo_sim_tpu_torch.engine import SimConfig
    from erpl_monte_carlo_sim_tpu_torch.engine.batch import prepare_batch, trajectory_of
    from erpl_monte_carlo_sim_tpu_torch.kernels import flight_summary as fs
    from erpl_monte_carlo_sim_tpu_torch.mc import (EnvelopeAccumulator, EnvelopeConfig,
                                                   MonteCarloAnalyzer)
    from erpl_monte_carlo_sim_tpu_torch.models import liquid_motor
    from erpl_monte_carlo_sim_tpu_torch.parallel import (collective_envelope,
                                                         collective_footprint,
                                                         init_distributed, make_mesh, run_ranks)
    from erpl_monte_carlo_sim_tpu_torch.parallel.spawn import free_port
    from erpl_monte_carlo_sim_tpu_torch.mc.stats import FootprintAccumulator

    launches = {}
    cfg = SimConfig(max_time=WINDOW)
    torch.cuda.empty_cache()  # the earlier phases' cached blocks, for the ranks' contexts
    # ---- 16a: an NCCL group of one rank, in this process
    t0 = time.time()
    init_distributed(f"127.0.0.1:{free_port()}", 1, 0, device=dev)
    try:
        mesh = make_mesh()
        backend = dist.get_backend()
        if backend != "nccl" or mesh.size != 1:
            raise AssertionError(f"16a: backend {backend}, {mesh.size} ranks")
        mc = MonteCarloAnalyzer(motor=liquid_motor(dev), sim_config=cfg, mesh=mesh)
        fs.launches = 0
        wall, a = timed_ms(mesh, lambda: mc.run_monte_carlo(ic, n_samples=BENCH_LANES, seed=0))
        launches["16a"] = fs.launches
        same_analysis(a, run4)
        if launches["16a"] != 1 or a["performance"]["cores_used"] != 1:
            raise AssertionError(f"16a: {launches['16a']} launches, cores_used "
                                 f"{a['performance']['cores_used']}")
        res, ms = rank_collectives(mesh, a["summary"], a["valid_mask"])
        worst = check_collectives(res, run4, "16a")
        # the footprint block and the envelope against the single device's
        valid = torch.as_tensor(a["valid_mask"], device=dev)
        landing = torch.as_tensor(a["summary"].landing_position, device=dev)
        fp_ms, fp = timed_ms(mesh, lambda: collective_footprint(landing, valid, mesh))
        acc = FootprintAccumulator()
        acc.add(*MonteCarloAnalyzer._footprint_moments(landing, valid))
        np.testing.assert_equal(fp, acc.footprint(), err_msg="16a footprint")
        ids = spread(BENCH_LANES, RESIM_LANES)
        _, recs = fs.flight_record(*widened(prepare_batch(*mc._select_lanes(ids))), cfg)
        traj = trajectory_of(recs)
        env = EnvelopeConfig()
        env_ms, col = timed_ms(mesh, lambda: collective_envelope(traj, mesh, env=env,
                                                                 max_time=cfg.max_time))
        ref_env = EnvelopeAccumulator(cfg, env)
        ref_env.add(traj)
        ref_env = ref_env.result()
        if col["n_lanes"] != ref_env["n_lanes"] or col["time"] != ref_env["time"]:
            raise AssertionError("16a envelope: lanes or bins differ")
        for ch in env.channels:
            x, y = ref_env["channels"][ch], col["channels"][ch]
            if x["n"] != y["n"] or y["clipped_frac"] != 0.0:
                raise AssertionError(f"16a envelope {ch}: counts or clipping")
            np.testing.assert_array_equal(y["min"], x["min"], err_msg=ch)
            np.testing.assert_array_equal(y["max"], x["max"], err_msg=ch)
            np.testing.assert_allclose(y["mean"], x["mean"], rtol=1e-12, equal_nan=True)
            np.testing.assert_allclose(y["std"], x["std"], rtol=1e-9, atol=1e-12, equal_nan=True)
            for q in x["percentiles"]:
                np.testing.assert_allclose(y["percentiles"][q], x["percentiles"][q], rtol=1e-9,
                                           atol=1e-12, equal_nan=True)
    finally:
        dist.destroy_process_group()
    phase("16a nccl one rank", card=repr(card), lanes=BENCH_LANES, launches=launches["16a"],
          wall_s=f"{wall / 1e3:.3f}", cores_used=1, equal_to_phase_4=True,
          stats_worst_rel=worst, collective_ms=json.dumps(ms),
          footprint_ms=f"{fp_ms:.3f}", envelope_ms=f"{env_ms:.3f}",
          envelope_lanes=RESIM_LANES, seconds=f"{time.time() - t0:.1f}")

    # ---- 16b: two ranks on the one card, Gloo over CUDA tensors
    t0 = time.time()
    results = run_ranks(parallel_rank, GLOO_RANKS, BENCH_LANES, LARGE_LANES, backend="gloo",
                        device=f"cuda:{dev.index or 0}", timeout_s=600)
    spawn_s = time.time() - t0
    out = check_ranks(results, run4, run9a, dev, "16b")
    launches["16b"] = out["launches"]
    phase("16b gloo ranks on one card", card=repr(card), spawn_and_runs_s=f"{spawn_s:.1f}",
          seconds=f"{time.time() - t0:.1f}", equal_to_phase_4_and_9a=True,
          **{k: json.dumps(v) for k, v in out.items()})

    # ---- 16c: NCCL across cards, where the machine has them
    count = torch.cuda.device_count()
    if count < 2:
        phase("16c nccl across cards", ran=False,
              reason=f"torch.cuda.device_count() is {count}: NCCL takes one rank a card, "
                     "and the check needs two cards or more")
        return launches
    t0 = time.time()
    world = min(count, 4)
    results = run_ranks(parallel_rank, world, BENCH_LANES, LARGE_LANES, backend="nccl",
                        timeout_s=600)
    out = check_ranks(results, run4, run9a, dev, "16c")
    launches["16c"] = out["launches"]
    phase("16c nccl across cards", card=repr(card), ran=True,
          seconds=f"{time.time() - t0:.1f}", equal_to_phase_4_and_9a=True,
          **{k: json.dumps(v) for k, v in out.items()})
    return launches


def threefry_phase(dev, ic, mc4, main_launches: dict, ptxas: dict) -> list:
    """Phase 17: jax.random's draws through the threefry kernels. (a) Every
    ``threefry_cases`` draw against the plain version on the card and the
    committed JAX golden (the chains at 262,144 lanes x 100 knots, the
    golden's kept lanes); the main path's three channel draws (``normal``
    over 4 keys x (262,144, 3) and 5 keys x (262,144,), ``uniform`` over 2
    keys x (262,144,): several parent keys, each on the grid's y); the
    AR(1) kernel's fused chain (float32
    with ``sub`` 1 and None, float64) and its recursion on a given driver
    (float32, float64) at 262,144 lanes against their plain versions, bit
    for bit. (b) The main path's draw timed: the fused chain beside its
    bound, its plain version, its occupancy, the recursion on a given
    driver beside the one library call that computes it (``torch.einsum``
    with ``ar1_transfer_matrix``), and the draw kernel on the same chain
    (the normals stored, as before the fusion) beside its own bound; the
    largest channel draw (its timed output held to 17a's);
    ``torch.randn`` of as many normals for context; the whole draw of
    262,144 lanes through the analyzer's seam, its kernels (fewer than 3 a
    knot: no per-knot loop) and the AR(1) kernel's one launch, beside the
    torch generator's 9.2 ms. (c) The f64 analysis of 256 lanes, seed 0,
    the 6 s window, held to the committed JAX analysis of the same seed.
    Returns the two kernels' rows of the kernels JSON."""
    from erpl_monte_carlo_sim_tpu_torch import random
    from erpl_monte_carlo_sim_tpu_torch.engine import InitialConditions, SimConfig
    from erpl_monte_carlo_sim_tpu_torch.kernels import threefry as tf
    from erpl_monte_carlo_sim_tpu_torch.mc import MonteCarloAnalyzer
    from erpl_monte_carlo_sim_tpu_torch.mc import analyzer as analyzer_mod
    from erpl_monte_carlo_sim_tpu_torch.models import WindModelParams, liquid_motor
    from erpl_monte_carlo_sim_tpu_torch.models.wind import _ar1_constants

    f32, f64 = torch.float32, torch.float64
    # ---- 17a: every draw against the plain version and the golden
    with np.load(THREEFRY_GOLDEN) as z:
        golden = {k: z[k] for k in z.files}
    worst = {}
    for name, spec, kind, shape, kw in threefry_cases():
        key = threefry_key(spec, dev)
        tf.launches = 0
        got = tf.draw(key, kind, shape, **kw)
        torch.cuda.synchronize()
        if tf.launches != 1:
            raise AssertionError(f"17a {name}: {tf.launches} threefry launches, not 1")
        dtype = kw.get("dtype")
        plain = threefry_error(got, tf.draw_reference(key, kind, shape, **kw), kind, dtype)
        jax_err = threefry_error(threefry_kept(name, got), golden[name], kind, dtype)
        worst[name] = (plain, jax_err)
        phase(f"17a {name}", shape=list(got.shape), plain_err=plain, jax_golden_err=jax_err,
              err_unit="ulp" if dtype == torch.float32 and kind == "normal"
              else "relative" if kind == "normal" else "exact")
        del got
    keys = random.split(random.prng_key(0, dev), 12)
    channels = (("normal", keys[0:4], (BENCH_LANES, 3)),
                ("normal", torch.cat([keys[4:8], keys[10:11]]), (BENCH_LANES,)),
                ("uniform", keys[8:10], (BENCH_LANES,)))
    for kind, parents, shape in channels:  # mc.dispersions._prng_draws' three draws
        tf.launches = 0
        got = tf.draw(parents, kind, shape, dtype=f32)
        torch.cuda.synchronize()
        if tf.launches != 1:
            raise AssertionError(f"17a channel {kind}: {tf.launches} threefry launches, not 1")
        plain = threefry_error(got, tf.draw_reference(parents, kind, shape, dtype=f32), kind, f32)
        phase(f"17a channel {kind} {parents.shape[0]} keys", shape=list(got.shape),
              plain_err=plain, err_unit="ulp" if kind == "normal" else "exact")
        if parents.shape[0] == 4:
            vec = got
        del got
    turb = threefry_key(("turb", 0), dev)
    grid = {d: torch.linspace(0.0, 25_000.0, 100, dtype=d, device=dev) for d in (f32, f64)}
    consts = {d: _ar1_constants(WindModelParams.create(dev, d), grid[d], d) for d in (f32, f64)}
    for dtype, sub in ((f32, 1), (f32, None), (f64, 1)):
        tf.ar1_launches = 0
        got = tf.ar1(*consts[dtype], key=turb, lanes=CHAIN_LANES, sub=sub)
        torch.cuda.synchronize()
        if tf.ar1_launches != 1:
            raise AssertionError(f"17a AR(1) chain: {tf.ar1_launches} launches, not 1")
        want = tf.ar1_reference(*consts[dtype], key=turb, lanes=CHAIN_LANES, sub=sub)
        if not torch.equal(got, want):
            raise AssertionError(f"17a AR(1) chain {dtype} sub={sub}: not the plain version's "
                                 f"bits ({float((got - want).abs().max())} apart)")
        phase(f"17a ar1 chain {str(dtype)[6:]} sub={sub}", shape=list(got.shape),
              bit_equal=True)
        del got, want
    gen = torch.Generator(device=dev).manual_seed(17)
    for dtype in (f32, f64):
        noise = torch.randn(CHAIN_LANES, 100, 3, generator=gen, device=dev, dtype=dtype)
        tf.ar1_launches = 0
        got = tf.ar1(*consts[dtype], noise=noise)
        torch.cuda.synchronize()
        if tf.ar1_launches != 1:
            raise AssertionError(f"17a AR(1) recursion: {tf.ar1_launches} launches, not 1")
        if not torch.equal(got, tf.ar1_recursion(noise, *consts[dtype])):
            raise AssertionError(f"17a AR(1) recursion on a given driver {dtype}: not the "
                                 "plain version's bits")
        phase(f"17a ar1 given noise {str(dtype)[6:]}", shape=list(got.shape), bit_equal=True)
        del got, noise
    torch.cuda.empty_cache()

    # ---- 17b: the main path's draw, timed
    ar1 = ar1_timing(BENCH_LANES)
    got = ar1.pop("out")
    ar1_plain_ms, ref = cuda_ms(lambda: tf.ar1_reference(*consts[f32], key=turb,
                                                         lanes=BENCH_LANES, sub=1))
    if not torch.equal(got, ref):
        raise AssertionError("17b: the fused chain is not its plain version's bits")
    ar1_err = float((got - ref).abs().max())
    del got, ref
    chain = dict(dtype=f32, lanes=BENCH_LANES, sub=1)
    got = tf.draw(turb, "normal", (100, 3), **chain)
    plain_ms, ref = cuda_ms(lambda: tf.draw_reference(turb, "normal", (100, 3), **chain))
    max_abs_err = float((got - ref).abs().max())
    ulps = threefry_error(got, ref, "normal", torch.float32)
    del got, ref
    torch.cuda.empty_cache()
    kernel_ms = ar1["draw_kernel_chain_ms"]
    n_words = BENCH_LANES * 300
    randn_ms, _ = warm_ms(lambda: torch.randn(n_words, device=dev))
    bound, bound_by = tf.bound_ms(n_words, 4, hashes_per_word=1 + 2 / 300,
                                  int_ops_per_word=tf.NORMAL_F32_INT_OPS,
                                  fp_ops_per_word=tf.NORMAL_F32_FP_OPS)
    threads, blocks = tf.occupancy("normal")
    channel_ms, got = warm_ms(lambda: random.normal(keys[0:4], (BENCH_LANES, 3)))
    if not torch.equal(got, vec):
        raise AssertionError("17b: the timed channel draw is not 17a's")
    del got, vec
    channel_bound, _ = tf.bound_ms(4 * BENCH_LANES * 3, 4, int_ops_per_word=tf.NORMAL_F32_INT_OPS,
                                   fp_ops_per_word=tf.NORMAL_F32_FP_OPS)
    draw_ms = warm_draw_ms(mc4, ic, BENCH_LANES)
    tf.launches = tf.ar1_launches = 0
    draw_kernels, _ = device_launches(lambda: analyzer_mod._draw_single(
        mc4, ic, BENCH_LANES, 0, mc4._base_wind()))
    draw_launches, draw_ar1 = tf.launches, tf.ar1_launches
    if draw_ar1 != 1:
        raise AssertionError(f"17b: the draw ran the AR(1) kernel {draw_ar1} times, not once")
    if draw_kernels >= 3 * 100:  # an eager loop over the knots adds 3 or more a knot
        raise AssertionError(f"17b: the draw ran {draw_kernels} kernels, 3 or more a knot: a "
                             "per-knot loop")
    phase("17b draw", lanes=BENCH_LANES, ar1_chain_ms=f"{ar1['ms']:.4f}",
          ar1_chain_plain_ms=f"{ar1_plain_ms:.2f}", ar1_bit_equal=True,
          ar1_bound_ms=f"{ar1['bound_ms']:.4f}", ar1_bound_by=ar1["bound_by"],
          ar1_share_of_bound=f"{ar1['share_of_bound']:.3f}", ar1_warps_per_sm=ar1["warps_per_sm"],
          ar1_given_ms=f"{ar1['given_ms']:.4f}", ar1_given_bound_ms=f"{ar1['given_bound_ms']:.4f}",
          ar1_given_share=f"{ar1['given_share_of_bound']:.3f}",
          ar1_given_library_ms=f"{ar1['given_library_ms']:.4f}",
          ar1_given_library_err=ar1["given_library_err"],
          draw_then_recursion_ms=f"{ar1['draw_then_recursion_ms']:.4f}",
          chain_kernel_ms=f"{kernel_ms:.4f}", chain_plain_ms=f"{plain_ms:.2f}",
          chain_max_abs_err=max_abs_err, chain_max_ulps=ulps, bound_ms=f"{bound:.4f}",
          bound_by=bound_by, share_of_bound=f"{bound / kernel_ms:.3f}",
          warps_per_sm=blocks * threads // 32, channel_draw_ms=f"{channel_ms:.4f}",
          channel_bound_ms=f"{channel_bound:.4f}", torch_randn_ms=f"{randn_ms:.4f}",
          draw_ms=f"{draw_ms:.3f}", torch_generator_draw_ms=TORCH_GENERATOR_DRAW_MS,
          draw_kernels=draw_kernels, draw_launches=draw_launches, draw_ar1_launches=draw_ar1)

    # ---- 17c: the card's analysis is JAX's
    mc = MonteCarloAnalyzer(motor=liquid_motor(dev, torch.float64),
                            sim_config=SimConfig(max_time=WINDOW))
    tf.launches = tf.ar1_launches = 0
    a = mc.run_monte_carlo(InitialConditions.vertical_launch(dev, torch.float64),
                           n_samples=ANALYSIS_LANES, seed=0)
    launched = {"draw": tf.launches, "ar1": tf.ar1_launches}
    if launched["draw"] < 1 or launched["ar1"] < 1:
        raise AssertionError(f"17c: the analysis did not draw through both threefry kernels "
                             f"({launched})")
    with np.load(ANALYSIS_GOLDEN) as z:
        want = {k: z[k] for k in z.files}
    rel = analysis_error(analysis_arrays(a), want)
    phase("17c analysis is JAX's", lanes=ANALYSIS_LANES, dtype="float64", seed=0,
          threefry_launches=launched["draw"], ar1_launches=launched["ar1"],
          n_valid=a["n_samples"], max_rel_err=rel, rtol=ANALYSIS_RTOL)
    source = "erpl_monte_carlo_sim_tpu_torch/csrc/threefry.cu"
    draw_row = {
        "name": "threefry (jax.random draws)", "route": "cuda", "source": source,
        "replaces": "erpl_monte_carlo_sim_tpu/mc/dispersions.py:185 (jax.random's threefry "
                    "under XLA; no Pallas kernel)",
        "launches": main_launches["draw"], "max_abs_err": max_abs_err, "ms": kernel_ms,
        "plain_ms": plain_ms, "bound_ms": bound, "bound_by": bound_by, "library_ms": None,
        "share_of_bound": bound / kernel_ms, "warps_per_sm": blocks * threads // 32,
        "regs": ptxas["draw"]["regs"],
        "spill_bytes": ptxas["draw"]["spill_stores"] + ptxas["draw"]["spill_loads"],
        "channel_draw_ms": channel_ms, "channel_bound_ms": channel_bound,
        "torch_randn_ms": randn_ms, "draw_ms": draw_ms, "draw_kernels": draw_kernels,
        "draw_launches": draw_launches, "golden_errs": worst}
    ar1_row = {
        "name": "threefry AR(1) wind chain", "route": "cuda", "source": source,
        "replaces": "erpl_monte_carlo_sim_tpu/models/wind.py:119 (the AR(1) lax.scan on "
                    "jax.random's normals, vmapped at mc/dispersions.py:443; no Pallas kernel)",
        "launches": main_launches["ar1"], "max_abs_err": ar1_err, "ms": ar1["ms"],
        "plain_ms": ar1_plain_ms, "bound_ms": ar1["bound_ms"], "bound_by": ar1["bound_by"],
        "library_ms": None, "share_of_bound": ar1["share_of_bound"],
        "warps_per_sm": ar1["warps_per_sm"], "regs": ptxas["ar1"]["regs"],
        "spill_bytes": ptxas["ar1"]["spill_stores"] + ptxas["ar1"]["spill_loads"],
        **{k: ar1[k] for k in ("given_ms", "given_bound_ms", "given_bound_by",
                               "given_warps_per_sm", "given_library_ms", "given_library_err",
                               "draw_then_recursion_ms")},
        "draw_ar1_launches": draw_ar1}
    return [draw_row, ar1_row]


# ---------------------------------------------------------------- phase 18
CAPSTONE_LANES = 10_000_000  # 18c: the 100M run's width (262,144 a slab), 39 slabs deep
# the capstones run by ``--capstones``, each at its script's size: (module, flag)
CAPSTONE_RUNS = (("million_flights", None), ("million_flights", "--fast"),
                 ("full_flights", None), ("full_flights", "--rk2"),
                 ("hundred_million_flights", None), ("hundred_million_flights", "--fast"))


def capstone_builds() -> dict:
    """The K1 builds the capstones fly, by what flies them. The fast
    configuration flies mode-compressed tables, where ``wind_table_bf16``
    rounds the scores and is cleared before the launch
    (``kernels.flight_summary.expanded``): its build is rk2 and per-step
    wind. The two-level blocks' parity legs fly the twins' builds."""
    from erpl_monte_carlo_sim_tpu_torch.capstones import full_flights as ff
    from erpl_monte_carlo_sim_tpu_torch.capstones import million_flights as mf
    from erpl_monte_carlo_sim_tpu_torch.kernels import flight_summary as fs
    from erpl_monte_carlo_sim_tpu_torch.mc.two_level import parity_twin

    fast = dataclasses.replace(mf.config(True), wind_table_bf16=False)
    return {"parity": fs.PARITY, "fast": fs.kernel_flags(fast),
            "full_flights": fs.kernel_flags(ff.config(False)),
            "full_flights+rk2": fs.kernel_flags(ff.config(True)),
            "full_flights twin": fs.kernel_flags(parity_twin(ff.config(True)))}


@contextlib.contextmanager
def streamed_lanes():
    """Every lane the slab loop's streams take, as they take it: yields a
    dict of each headline metric's per-slab host arrays of valid lanes."""
    from erpl_monte_carlo_sim_tpu_torch.mc import slab_accumulators as sa

    seen = {k: [] for k in METRICS}
    update = sa.StreamAccumulator.update

    def collecting(self, ctx):
        for k in seen:
            seen[k].append(ctx.slab_metrics[k][ctx.valid_np])
        return update(self, ctx)

    sa.StreamAccumulator.update = collecting
    try:
        yield seen
    finally:
        sa.StreamAccumulator.update = update


@contextlib.contextmanager
def checkpoint_writes():
    """Each slab checkpoint written meanwhile, clocked: yields the list it
    fills with ``(seconds, bytes)``."""
    from erpl_monte_carlo_sim_tpu_torch.mc import slab_checkpoint

    writes = []
    save = slab_checkpoint.save_slab_state

    def timed(path, *a, **kw):
        t0 = time.perf_counter()
        save(path, *a, **kw)
        writes.append((time.perf_counter() - t0, os.path.getsize(path)))

    slab_checkpoint.save_slab_state = timed
    try:
        yield writes
    finally:
        slab_checkpoint.save_slab_state = save


@contextlib.contextmanager
def accumulator_ms():
    """The host's per-slab work by accumulator (``mc/slab_accumulators.py``):
    yields a dict it fills with each accumulator class's total ``update``
    ms (a lazy readback of the slab's lanes counts to the first that asks)."""
    from erpl_monte_carlo_sim_tpu_torch.mc import slab_accumulators as sa

    spent, saved = {}, {}
    for cls in sa.SlabAccumulator.__subclasses__():
        saved[cls] = cls.update

        def timed(self, ctx, _update=cls.update, _name=cls.__name__):
            t0 = time.perf_counter()
            _update(self, ctx)
            spent[_name] = spent.get(_name, 0.0) + 1e3 * (time.perf_counter() - t0)

        cls.update = timed
    try:
        yield spent
    finally:
        for cls, update in saved.items():
            cls.update = update


def rss_mb() -> float:
    """This process's resident memory now, MB (``/proc/self/statm``)."""
    with open("/proc/self/statm") as f:
        return int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE") / 2**20


def streams_against_numpy(a: dict, seen: dict, tag: str) -> dict:
    """A streaming analysis' stats blocks against a float64 NumPy pass over
    the lanes its streams took (9b's bars: mean within 1e-12, std within
    1e-9, min and max exact, the count exact). Returns the largest errors."""
    worst = {"mean_rel": 0.0, "std_rel": 0.0}
    for k in METRICS:
        vals = np.concatenate(seen[k]).astype(np.float64)
        blk, stream = a[k], a["streams"][k]
        if stream.is_exact or stream.n != vals.size or vals.size != a["n_samples"]:
            raise AssertionError(f"{tag} {k}: the stream took {stream.n} lanes, NumPy has "
                                 f"{vals.size}, the run {a['n_samples']} valid "
                                 f"(exact={stream.is_exact})")
        sigma = vals.std()
        worst["mean_rel"] = max(worst["mean_rel"], abs(blk["mean"] / vals.mean() - 1))
        worst["std_rel"] = max(worst["std_rel"], abs(blk["std"] / sigma - 1) if sigma else 0.0)
        if blk["min"] != vals.min() or blk["max"] != vals.max():
            raise AssertionError(f"{tag} {k}: min/max differ from NumPy's")
    if worst["mean_rel"] > 1e-12 or worst["std_rel"] > 1e-9:
        raise AssertionError(f"{tag}: streamed moments off NumPy's: {worst}")
    return worst


def capstones(dev, builds: dict, usage: dict) -> tuple:
    """Phase 18: the capstones (``erpl_monte_carlo_sim_tpu_torch/capstones``)
    through their ``run`` at full width, each with K1's launches counted
    from 0 just before it. Returns those launches and the kernels-JSON row
    of the fast build."""
    import tempfile

    from erpl_monte_carlo_sim_tpu_torch.capstones import full_flights as ff
    from erpl_monte_carlo_sim_tpu_torch.capstones import hundred_million_flights as hm
    from erpl_monte_carlo_sim_tpu_torch.capstones import million_flights as mf
    from erpl_monte_carlo_sim_tpu_torch.engine import InitialConditions
    from erpl_monte_carlo_sim_tpu_torch.engine.batch import prepare_batch
    from erpl_monte_carlo_sim_tpu_torch.kernels import flight_summary as fs
    from erpl_monte_carlo_sim_tpu_torch.mc import analyzer as analyzer_mod
    from erpl_monte_carlo_sim_tpu_torch.models import liquid_motor, nominal_scene, wind_mode_basis

    launches, first_calls = {}, {}
    mb = 2.0 ** -20
    # ---- 18a: million_flights, parity and --fast, full size
    for fast in (False, True):
        tag = f"18a {'fast' if fast else 'parity'}"
        torch.cuda.reset_peak_memory_stats(dev)
        (result, summaries), run_s, launches[tag] = counted(mf.run, fast, dev)
        want = 1 + len(mf.SEEDS)  # the warm call and the timed ones
        if (launches[tag] != want or result["total_flights"] != 2 * mf.HALF
                or not result["finite_frac"] > 0.99 or result["steps"] != hm.STEPS):
            raise AssertionError(f"{tag}: {launches[tag]} launches (want {want}), {result}")
        first_calls[fast] = summaries[0]
        phase(f"{tag} million_flights", launches=launches[tag], run_s=f"{run_s:.3f}",
              device_peak_mb=f"{torch.cuda.max_memory_allocated(dev) * mb:.1f}",
              **{k: result[k] for k in ("total_flights", "steps", "wall_s_incl_sampling",
                                        "traj_per_s", "finite_frac", "apogee_mean_m", "mode")})
        del summaries
    # the fast build on the first call's lanes: the run's bits, and its plain
    # version on the first SLICE_LANES at K1's float32 bars
    cfg = mf.config(True)
    scene = nominal_scene(liquid_motor(dev))
    ic = InitialConditions.vertical_launch(dev)
    basis = wind_mode_basis(scene.wind_model, np.linspace(*mf.MODE_GRID), mf.MODES)
    args = prepare_batch(*mf.batch(mf.SEEDS[0], scene, ic, mf.HALF, basis))
    got = fs.flight_summary(*args, cfg)
    run_out = first_calls[True]
    for k in ("apogee_altitude", "flight_time", "n_steps"):
        if not torch.equal(got[k].nan_to_num(-1.0), getattr(run_out, k).nan_to_num(-1.0)):
            raise AssertionError(f"18a: {k} of the kernel on the call's lanes is not the run's")
    # the kernel alone, on the expanded tables, timed apart from the expansion
    expand_ms, (table, flown) = cuda_ms(lambda: fs.expanded(args[2], cfg), reps=2)
    if fs.kernel_flags(flown) != builds["fast"]:
        raise AssertionError(f"18a: the fast call flies {fs.flags_name(fs.kernel_flags(flown))}")
    kernel_args = (args[0], args[1], table, args[3])
    kernel_ms, _ = cuda_ms(lambda: fs.flight_summary(*kernel_args, flown), reps=2)
    plain_ms, ref = cuda_ms(lambda: fs.flight_summary_reference(
        *head(args, mf.HALF, SLICE_LANES), cfg))
    err = compare(ref, head(got, mf.HALF, SLICE_LANES), torch.float32)
    bound = fs.bound_ms(got, flown, torch.float32, fs.input_bytes(*kernel_args, flown))
    use = usage["fast"]["f32"]
    fast_row = {
        "name": f"flight_summary [capstone fast: {fs.flags_name(builds['fast'])}]",
        "route": "cuda", "source": KERNEL_SOURCE, "replaces": REPLACES[0][1],
        "launches": launches["18a fast"], "max_abs_err": err, "max_abs_err_lanes": SLICE_LANES,
        "ms": kernel_ms, "lanes": mf.HALF, "plain_ms": plain_ms, "plain_lanes": SLICE_LANES,
        "bound_ms": bound.ms, "bound_by": bound.by, "share_of_bound": bound.ms / kernel_ms,
        "library_ms": None, "expansion_ms": expand_ms, "regs": use["regs"],
        "spill_bytes": use["spill_stores"] + use["spill_loads"],
        "build": fs.flags_name(builds["fast"])}
    phase("18a fast build=plain", build=fast_row["build"], lanes=SLICE_LANES, max_abs_err=err,
          rtol=RTOL[torch.float32], run_bits="the run's", kernel_ms=f"{kernel_ms:.3f}",
          kernel_lanes=mf.HALF, expansion_ms=f"{expand_ms:.3f}", plain_ms=f"{plain_ms:.1f}",
          bound_ms=bound.ms, bound_by=bound.by, share_of_bound=bound.ms / kernel_ms)
    del args, kernel_args, table, got, ref, first_calls
    torch.cuda.empty_cache()

    # ---- 18b: full_flights --rk2, full size
    torch.cuda.reset_peak_memory_stats(dev)
    (result, lanes), run_s, launches["18b"] = counted(ff.run, True, dev)
    tl, want = lanes["two_level"], 1 + ff.N_SLABS + 2
    if (launches["18b"] != want or result["total_flights"] != ff.N_SLABS * ff.SLAB
            or result["valid_frac"] < 0.99 or tl["n_coupled"] < 0.9 * ff.TWO_LEVEL_LANES
            or not all(math.isfinite(tl[k]["bias"]) for k in METRICS)):
        raise AssertionError(f"18b: {launches['18b']} launches (want {want}), {result}")
    phase("18b full_flights --rk2", launches=launches["18b"], run_s=f"{run_s:.3f}",
          device_peak_mb=f"{torch.cuda.max_memory_allocated(dev) * mb:.1f}",
          two_level_legs_s=json.dumps(tl["wall_s_legs"]),
          **{k: result[k] for k in ("total_flights", "wall_s_incl_sampling", "full_traj_per_s",
                                    "max_lane_steps", "valid_frac", "apogee_mean_m",
                                    "apogee_std_m", "range_mean_m", "flight_time_mean_s")},
          two_level=json.dumps(result["two_level"]))
    del lanes

    # ---- 18c: hundred_million_flights, parity and --fast, at 10M lanes
    n_slabs = -(-CAPSTONE_LANES // hm.SLAB)
    kw = dict(n_samples=CAPSTONE_LANES)
    # the process's resident memory at these slabs' draws: flat past the
    # prefix's cap (slab 4) and the streams' crossing (slab 16)
    rss_at = (1, 4, 8, 16, 17, 24, 32, n_slabs)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "hundred_million.ckpt.npz")
        runs = {}
        for fast in (False, True):
            tag = f"18c {'fast' if fast else 'parity'}"
            torch.cuda.reset_peak_memory_stats(dev)
            with streamed_lanes() as seen, checkpoint_writes() as writes, \
                    slab_stages() as marks, accumulator_ms() as spent:
                t0 = time.perf_counter()
                (result, a), run_s, launches[tag] = counted(hm.run, fast, dev,
                                                            checkpoint_path=path, **kw)
                end = time.perf_counter()
            want = n_slabs + (2 if fast else 0)  # and the two-level legs
            if launches[tag] != want or result["total_flights"] != CAPSTONE_LANES:
                raise AssertionError(f"{tag}: {launches[tag]} launches (want {want}), {result}")
            if os.path.exists(path) or len(writes) != (n_slabs - 1) // hm.CHECKPOINT_EVERY:
                raise AssertionError(f"{tag}: {len(writes)} checkpoints, left after the run "
                                     f"{os.path.exists(path)}")
            worst = streams_against_numpy(a, seen, tag)
            del seen
            sampling, kernel, host = stage_split(marks, end)
            if fast and (a["two_level"]["n_coupled"] < 0.9 * hm.TWO_LEVEL_LANES or not
                         math.isfinite(a["two_level"]["apogee_altitude"]["corrected_mean"])):
                raise AssertionError(f"{tag}: two-level block {a['two_level']}")
            runs[fast] = a
            phase(f"{tag} hundred_million_flights", lanes=CAPSTONE_LANES, slabs=n_slabs,
                  last_slab=CAPSTONE_LANES - (n_slabs - 1) * hm.SLAB, launches=launches[tag],
                  run_s=f"{run_s:.3f}", staged_wall_s=f"{end - t0:.3f}",
                  device_peak_mb=f"{torch.cuda.max_memory_allocated(dev) * mb:.1f}",
                  **{k: result[k] for k in ("wall_s", "traj_per_s", "valid", "outliers",
                                            "apogee_mean_m", "apogee_std_m", "apogee_p50_m",
                                            "metrics_is_sample")},
                  **worst, checkpoint_s=json.dumps([round(s, 4) for s, _ in writes]),
                  checkpoint_mb=json.dumps([round(b * mb, 2) for _, b in writes]),
                  sampling_ms_sum=f"{sum(sampling):.1f}", kernel_ms_sum=f"{sum(kernel):.1f}",
                  host_ms_sum=f"{sum(host):.1f}", host_ms_median=f"{np.median(host):.2f}",
                  host_ms_max=f"{max(host):.1f}", host_ms_max_slab=int(np.argmax(host)) + 1,
                  host_ms_slabs=json.dumps({k: round(host[k - 1], 1) for k in rss_at}),
                  kernel_ms_median=f"{np.median(kernel):.2f}",
                  sampling_ms_median=f"{np.median(sampling):.2f}",
                  accumulator_ms=json.dumps({k: round(v, 1) for k, v in spent.items()}),
                  rss_mb_slabs=json.dumps({i + 1: round(r) for i, r in enumerate(
                      m for st, m, _ in marks if st == "rss") if i + 1 in rss_at}),
                  two_level=json.dumps(result["two_level"]))
        # the fast run killed at the draw after its first checkpoint, resumed
        draw, calls = analyzer_mod._draw_slab, []

        def dying(*args, **kwargs):
            if len(calls) == hm.CHECKPOINT_EVERY:
                raise RuntimeError("simulated crash")
            calls.append(1)
            return draw(*args, **kwargs)

        analyzer_mod._draw_slab = dying
        try:
            hm.run(True, dev, checkpoint_path=path, **kw)
            raise AssertionError("18c: the run did not stop after its first checkpoint")
        except RuntimeError as e:
            if "simulated crash" not in str(e):
                raise
        finally:
            analyzer_mod._draw_slab = draw
        kept = os.path.exists(path)
        (result, c), run_s, launches["18c resumed"] = counted(hm.run, True, dev,
                                                              checkpoint_path=path, **kw)
        want = n_slabs - hm.CHECKPOINT_EVERY + 2
        if not kept or os.path.exists(path) or launches["18c resumed"] != want:
            raise AssertionError(f"18c resume: checkpoint kept {kept}, left after the run "
                                 f"{os.path.exists(path)}, {launches['18c resumed']} launches "
                                 f"(want {want})")
    same_analysis(c, runs[True], skip=("performance", "two_level"))
    walls = ("wall_s", "wall_s_legs")
    np.testing.assert_equal({k: v for k, v in c["two_level"].items() if k not in walls},
                            {k: v for k, v in runs[True]["two_level"].items() if k not in walls})
    phase("18c resumed", lanes=CAPSTONE_LANES, resumed_at_slab=hm.CHECKPOINT_EVERY,
          launches=launches["18c resumed"], run_s=f"{run_s:.3f}", wall_s=result["wall_s"],
          equal_to_uninterrupted="bit for bit")
    return launches, fast_row


def capstone_child(argv) -> int:
    """``--capstone MODULE [FLAG]``: one capstone at its script's size, its
    checkpoint writes clocked; prints the module's lines, then the writes
    and whether the checkpoint outlived the run."""
    import importlib

    name, flags = argv[0], argv[1:]
    module = importlib.import_module(f"erpl_monte_carlo_sim_tpu_torch.capstones.{name}")
    with checkpoint_writes() as writes:
        module.main(flags)
    left = None
    if name == "hundred_million_flights":
        left = os.path.exists(module.checkpoint_path_of("--fast" in flags))
    phase(f"capstone {' '.join(argv)}", checkpoint_writes=len(writes),
          checkpoint_s=json.dumps([round(s, 4) for s, _ in writes]),
          checkpoint_mb=json.dumps([round(b / 2**20, 2) for _, b in writes]),
          checkpoint_left=left)
    return 0


def capstone_runs() -> int:
    """``--capstones``: every capstone at its script's size, each in a
    process of its own (``--capstone``), after one build of their kernels;
    the card's line before and after."""
    import subprocess

    from erpl_monte_carlo_sim_tpu_torch.kernels import flight_summary as fs
    from erpl_monte_carlo_sim_tpu_torch.kernels import threefry as tf

    card = card_line()
    print(card, flush=True)
    t0 = time.time()
    threefry_build = tf.build(start_only=True)
    fs.build_many(sorted(set(capstone_builds().values())))
    threefry_build()
    phase("capstones build", seconds=f"{time.time() - t0:.1f}")
    failed = []
    for name, flag in CAPSTONE_RUNS:
        cmd = [sys.executable, os.path.join(ROOT, "chip_smoke.py"), "--capstone", name,
               *([flag] if flag else [])]
        t0 = time.time()
        rc = subprocess.run(cmd, cwd=ROOT, timeout=1800).returncode
        phase(f"capstone done {name} {flag or ''}".strip(), rc=rc,
              process_s=f"{time.time() - t0:.1f}")
        if rc:
            failed.append((name, flag))
    print(card, flush=True)
    return 1 if failed else 0


def count_landing_ties(lanes: int) -> dict:
    """``--landing-ties [lanes]``: the rate behind ``LANDING_TIE_RATE``. The
    first ``lanes`` lanes (default 8,192) that the analyzer draws for seed 0
    under phase 7's configuration, flown through the kernel and the plain
    version in float32: the landing ties (``landing_ties``) of each block of
    1,024 lanes and their total. Beside them the digests of phase 6's
    flights to landing (the two tiered flag sets on the low-apogee scenes,
    float32 and float64), whose inputs no sampler draws, so that two
    checkouts' runs show their flights are the same."""
    from erpl_monte_carlo_sim_tpu_torch.engine import InitialConditions
    from erpl_monte_carlo_sim_tpu_torch.engine.batch import prepare_batch
    from erpl_monte_carlo_sim_tpu_torch.kernels import flight_summary as fs
    from erpl_monte_carlo_sim_tpu_torch.mc import MonteCarloAnalyzer
    from erpl_monte_carlo_sim_tpu_torch.mc import analyzer as analyzer_mod
    from erpl_monte_carlo_sim_tpu_torch.models import liquid_motor

    dev = torch.device("cuda")
    cfg, _, flags = flag_set("full_flights")
    fs.build_many([flags, flag_set("full_flights+rk2")[2]])
    mc = MonteCarloAnalyzer(motor=liquid_motor(dev), sim_config=cfg)
    scene_b, ic_b, _ = analyzer_mod._draw_single(mc, InitialConditions.vertical_launch(dev),
                                                 lanes, 0, None)
    args = prepare_batch(scene_b, ic_b)
    got = fs.flight_summary(*args, cfg)
    ref = fs.flight_summary_reference(*args, cfg)
    counts = [int(landing_ties({k: v[b:b + 1024] for k, v in ref.items()},
                               {k: v[b:b + 1024] for k, v in got.items()}, torch.float32).sum())
              for b in range(0, lanes, 1024)]
    landing = {}
    for name in TO_LANDING:
        for dtype in (torch.float32, torch.float64):
            _, out, _ = drive(*low_apogee_batch(dev, dtype), flag_set(name)[0])
            landing[f"{name} {str(dtype).split('.')[-1]}"] = digest(out)
    return {"checkout": ROOT, "card": card_line(), "lanes": lanes, "ties_per_1024": counts,
            "ties": sum(counts), "landing_digests": landing}


# phase 19: the stacked-vector single-flight engine (engine.simulate): the
# Quick start to landing, K1 against the stacked plain version on dispersed
# lanes of a window, and one recorded flight
STACKED_LANES = 4096
STACKED_WINDOW = 2.0
STACKED_FLIGHT_WINDOW = 6.0
# the lane whose wind table is NaN above 2 km (19b, 20c)
STACKED_NAN_LANE = 7
# lanes of a float32 window whose rail exit or step count differs between
# K1 and the stacked engine (a tie of the last bits on the rail), at most
STACKED_TIE_SHARE = 1e-3


def same_summaries(a, b) -> bool:
    """Two ``FlightSummary`` results bit for bit (NaN equal to NaN)."""
    return all(torch.equal(x, y) if not x.is_floating_point()
               else bool(((x == y) | (torch.isnan(x) & torch.isnan(y))).all())
               for (_, x), (_, y) in zip(leaves(a), leaves(b)))


def compare_summaries64(ref, got) -> float:
    """Two float64 ``FlightSummary`` results leaf by leaf at ``RTOL`` /
    ``ATOL``, integers and flags exact; the largest absolute difference.
    Raises naming every leaf that differs."""
    worst, bad = 0.0, []
    for (path, a), (_, b) in zip(leaves(ref), leaves(got)):
        if not a.is_floating_point():
            if not torch.equal(a, b):
                bad.append(path)
            continue
        diff = (a - b).abs()
        same_nan = torch.isnan(a) & torch.isnan(b)
        if not bool((same_nan | (diff <= ATOL + RTOL[torch.float64] * a.abs())).all()):
            bad.append(path)
        if bool((~same_nan).any()):
            worst = max(worst, float(diff[~same_nan].max()))
    if bad:
        raise AssertionError(f"summaries differ at {bad}")
    return worst


def stacked_lanes(dtype):
    """19b's and 20c's lanes: ``STACKED_LANES`` dispersed lanes, lane
    ``STACKED_NAN_LANE`` with a wind table NaN above 2 km."""
    return sample_batch(STACKED_LANES, dtype, nan_lane=STACKED_NAN_LANE)


def held_to_stacked(tag, ref_out, kernel, dtype) -> tuple:
    """A K1 result against the stacked plain version's on the same lanes at
    19b's bars: in float32 the lanes that leave the rail or stop a step
    apart (a tie of the last bits on the rail) are counted, at most
    ``STACKED_TIE_SHARE``, and left out; the NaN-wind lane's ``max_speed``
    is 0 in both. Returns ``(max_abs_err, lanes compared, ties)``."""
    for name, out in (("plain", ref_out), ("kernel", kernel)):
        lane = STACKED_NAN_LANE
        if not (bool(out["diverged"][lane]) and float(out["max_speed"][lane]) == 0.0):
            raise AssertionError(f"{tag}: the NaN-wind lane's {name} max_speed is "
                                 f"{float(out['max_speed'][lane])}, diverged "
                                 f"{int(out['diverged'][lane])} (0 and 1 wanted)")
    ties = torch.zeros_like(kernel["diverged"], dtype=torch.bool)
    if dtype == torch.float32:
        ties = ((ref_out["rail_exit_time"] != kernel["rail_exit_time"])
                | (ref_out["n_steps"] != kernel["n_steps"]))
        if int(ties.sum()) > STACKED_TIE_SHARE * STACKED_LANES:
            raise AssertionError(f"{tag}: {int(ties.sum())} lanes leave the rail or stop a "
                                 "step apart")
    kept = ~ties
    err = compare({k: v[kept] for k, v in ref_out.items()},
                  {k: v[kept] for k, v in kernel.items()}, dtype)
    return err, int(kept.sum()), int(ties.sum())


def stacked_engine(dev, goldens: dict, usage: dict, record_usage: dict) -> tuple:
    """Phase 19: ``engine.simulate_summary`` / ``simulate_flight``, the
    JAX package's single-flight entry points, on the card, where they
    launch K1's fold build (K2's counterpart: K1 with the stacked engine's
    speed) and K1-Rec. Each sub-phase counts its launches from 0 around the
    entry point's call alone; the comparisons' own launches are not
    counted. ``usage``: the fold build's ptxas lines, ``record_usage`` its
    recording build's (``record_ptxas``). Returns those counts and the fold
    builds' rows of the kernels JSON (``f32``, ``f64``: the summary build;
    ``record``: the recording build)."""
    from erpl_monte_carlo_sim_tpu_torch.engine import (InitialConditions, SimConfig,
                                                       simulate_flight, simulate_summary)
    from erpl_monte_carlo_sim_tpu_torch.engine.batch import _summary_pytree, prepare_batch
    from erpl_monte_carlo_sim_tpu_torch.engine.rail import simulate_rail
    from erpl_monte_carlo_sim_tpu_torch.engine.simulate import (simulate_flight_reference,
                                                                simulate_summary_reference)
    from erpl_monte_carlo_sim_tpu_torch.engine.state import initial_state
    from erpl_monte_carlo_sim_tpu_torch.kernels import flight_summary as fs
    from erpl_monte_carlo_sim_tpu_torch.models import liquid_motor, nominal_scene
    from erpl_monte_carlo_sim_tpu_torch.utils.tree import floats_as, tree_map

    counts = {}
    fold_row = {}

    def counted_call(tag, fn, *args):
        torch.cuda.synchronize()
        fs.launches = fs.record_launches = fs.derived_launches = 0
        fs.fold_launches = fs.chunk_launches = 0
        t0 = time.time()
        out = fn(*args)
        torch.cuda.synchronize()
        wall = time.time() - t0
        counts[tag] = {"k1": fs.launches, "k1_rec": fs.record_launches,
                       "derived": fs.derived_launches, "fold": fs.fold_launches,
                       "chunk": fs.chunk_launches}
        return out, wall

    # (a) the Quick start to landing, a single flight (0-d leaves)
    for dtype, apogee_rel in ((torch.float64, 1e-5), (torch.float32, 1e-3)):
        dt = str(dtype).split(".")[-1]
        scene = nominal_scene(liquid_motor(dev, dtype))
        ic = InitialConditions.vertical_launch(dev, dtype)
        simulate_summary(scene, ic, SimConfig())  # warm
        s, wall = counted_call(f"19a {dt}", simulate_summary, scene, ic, SimConfig())
        if (counts[f"19a {dt}"]["k1"] != 1 or counts[f"19a {dt}"]["fold"] != 1
                or s.apogee_altitude.ndim != 0):
            raise AssertionError(f"19a {dt}: launches {counts[f'19a {dt}']} (one of the fold "
                                 f"build wanted), apogee shape {tuple(s.apogee_altitude.shape)}")
        golden_checks(s, goldens["liquid"], dtype, apogee_rel, f"19a quick start {dt}",
                      n_steps=True)
        phase(f"19a quick start {dt}", apogee_m=float(s.apogee_altitude),
              golden_m=goldens["liquid"]["apogee_altitude"], range_m=float(s.range),
              flight_time_s=float(s.flight_time), n_steps=int(s.n_steps),
              launches=counts[f"19a {dt}"]["k1"], warm_wall_s=f"{wall:.4f}")

    # (b) K2's counterpart: K1's fold build through simulate_summary on
    # dispersed lanes of a window, one with a NaN wind table, against the
    # stacked plain version on the card
    cfg = SimConfig(max_time=STACKED_WINDOW)
    fold = fs.PARITY._replace(stacked_speed=True)
    for dtype in (torch.float64, torch.float32):
        dt = str(dtype).split(".")[-1]
        scene_b, ic_b = stacked_lanes(dtype)
        got, _ = counted_call(f"19b {dt}", simulate_summary, scene_b, ic_b, cfg)
        if counts[f"19b {dt}"]["k1"] != 1 or counts[f"19b {dt}"]["fold"] != 1:
            raise AssertionError(f"19b {dt}: launches {counts[f'19b {dt}']} (one of the fold "
                                 "build wanted)")
        args = prepare_batch(scene_b, ic_b)
        k1_ms, kernel = cuda_ms(lambda: fs.flight_summary(*args, cfg, stacked_speed=True),
                                reps=3)
        if not same_summaries(_summary_pytree(kernel), got):
            raise AssertionError(f"19b {dt}: simulate_summary is not the fold build's summary")
        plain_ms, ref = cuda_ms(lambda: simulate_summary_reference(scene_b, ic_b, cfg))
        rail_ms, _ = cuda_ms(lambda: simulate_rail(scene_b, cfg, initial_state(ic_b)))
        err, compared, ties = held_to_stacked(f"19b {dt}", fs.summary_out(ref, ic_b), kernel, dtype)
        steps = int(ref.n_steps.max())
        bound = fs.bound_ms(kernel, cfg, dtype, fs.input_bytes(*args))
        key = "f32" if dtype == torch.float32 else "f64"
        threads, blocks = occupancy(fs, key, args[0], args[1], fold)
        fold_row[key] = {"lanes": STACKED_LANES, "max_abs_err": err, "compared_lanes": compared,
                        "ms": k1_ms, "plain_ms": plain_ms, "bound_ms": bound.ms,
                        "bound_by": bound.by, "share_of_bound": bound.ms / k1_ms,
                        "regs": usage[key]["regs"],
                        "spill_bytes": usage[key]["spill_stores"] + usage[key]["spill_loads"],
                        "warps_per_sm": blocks * threads // 32}
        # the plain ms a main-loop step: the run less its eager rail phase,
        # the step's capture (a warm-up call and the capture) included
        phase(f"19b K1=stacked {dt}", lanes=STACKED_LANES, max_time=STACKED_WINDOW,
              launches=counts[f"19b {dt}"]["k1"], compared_lanes=compared,
              rail_ties=ties, nan_lane_max_speed=float(kernel["max_speed"][STACKED_NAN_LANE]),
              max_abs_err=err, rtol=RTOL[dtype], atol=ATOL,
              n_steps_max=steps, k1_ms=f"{k1_ms:.3f}", plain_ms=f"{plain_ms:.1f}",
              plain_rail_ms=f"{rail_ms:.1f}",
              plain_ms_per_step=f"{(plain_ms - rail_ms) / steps:.3f}")
        del scene_b, ic_b, args, got, kernel, ref

    # (c) one recorded flight through K1-Rec's fold build and its derived
    # pass, against the stacked plain recorder on the card
    cfg = SimConfig(max_time=STACKED_FLIGHT_WINDOW)
    scene = nominal_scene(liquid_motor(dev, torch.float64))
    ic = InitialConditions.vertical_launch(dev, torch.float64)
    (got_s, got_t), _ = counted_call("19c f64", simulate_flight, scene, ic, cfg)
    if counts["19c f64"] != {"k1": 1, "k1_rec": 1, "derived": 1, "fold": 1, "chunk": 0}:
        raise AssertionError(f"19c: launches {counts['19c f64']} (one flight and one "
                             "derived pass wanted)")
    t0 = time.time()
    ref_s, ref_t = simulate_flight_reference(scene, ic, cfg)
    torch.cuda.synchronize()
    plain_s = time.time() - t0
    lane = lambda t: records_of(tree_map(lambda x: x[None], t), 1)  # noqa: E731
    ref_r, got_r = lane(ref_t), lane(got_t)
    if set(ref_r["derived"]) != set(got_r["derived"]) or not torch.equal(ref_r["valid"],
                                                                         got_r["valid"]):
        raise AssertionError("19c: the recordings' derived channels or valid frames differ")
    frame_err = compare_records(ref_r, got_r, torch.float64, keep=ref_r["valid"])
    summary_err = compare_summaries64(ref_s, got_s)
    # the recording fold build on that flight, timed beside its bound
    args = prepare_batch(floats_as(scene, torch.float64), tree_map(lambda x: x[None], ic))
    rec_ms, (res, recs) = cuda_ms(lambda: fs.flight_record(*args, cfg, stacked_speed=True))
    bound = fs.bound_ms(res, cfg, torch.float64, fs.input_bytes(*args), recs)
    threads, blocks = occupancy(fs, "f64", args[0], args[1], fold._replace(record=True))
    rec_use = record_usage["f64"]["flight"]
    fold_row["record"] = {"launches": counts["19c f64"]["k1_rec"], "lanes": 1,
                          "max_abs_err": frame_err, "ms": rec_ms, "plain_ms": 1e3 * plain_s,
                          "bound_ms": bound.ms, "bound_by": bound.by,
                          "share_of_bound": bound.ms / rec_ms, "regs": rec_use["regs"],
                          "spill_bytes": rec_use["spill_stores"] + rec_use["spill_loads"],
                          "warps_per_sm": blocks * threads // 32}
    phase("19c simulate_flight f64", max_time=STACKED_FLIGHT_WINDOW,
          frames=int(got_t.time.shape[0]), valid_frames=int(got_t.valid.sum()),
          launches=json.dumps(counts["19c f64"]), frames_max_abs_err=frame_err,
          summary_max_abs_err=summary_err, plain_recorder_s=f"{plain_s:.2f}",
          record_ms=f"{rec_ms:.3f}")

    # (d) the tiered timestep is refused, on the card too, before any launch;
    # rk2 and the bfloat16 table, which the stacked path does not read, fly
    # the parity build, bit for bit
    fs.launches = 0
    try:
        simulate_summary(scene, ic, SimConfig(descent_dt_scale=4))
    except ValueError as e:
        if "simulate_summary_batch" not in str(e) or fs.launches:
            raise
    else:
        raise AssertionError("19d: descent_dt_scale=4 was not refused")
    refused_launches = fs.launches
    cfg_d = SimConfig(max_time=STACKED_WINDOW)
    parity = simulate_summary(scene, ic, cfg_d)
    ignored = simulate_summary(scene, ic, dataclasses.replace(cfg_d, integrator="rk2",
                                                              wind_table_bf16=True))
    if not all(torch.equal(a, b) for (_, a), (_, b) in zip(leaves(parity), leaves(ignored))):
        raise AssertionError("19d: rk2 / wind_table_bf16 changed the stacked flight")
    phase("19d refusal", descent_dt_scale=4, launches=refused_launches,
          rk2_bf16_ignored=True)
    return counts, fold_row


# phase 20: chunked flights through K1's carry build
CHUNK_STEPS = 256          # 20a: five chunks of the 6 s window
FULL_CHUNK_STEPS = 8192    # 20b: the JAX package's default
HELD_CHUNK_STEPS = 64      # 20c


def with_nominal_lane(batched, nominal):
    """A drawn scene or initial conditions with lane 0 set to the nominal
    ``nominal``'s (every leaf that gained a lane axis; the wind table as the
    nominal wind at the drawn grid's knots): the Quick start's flight, which
    to landing runs past 8,192 steps."""
    from erpl_monte_carlo_sim_tpu_torch.models.wind import WindField, wind_at_altitude
    from erpl_monte_carlo_sim_tpu_torch.utils.tree import is_static

    if isinstance(batched, WindField):
        table = batched.wind.clone()
        table[0] = wind_at_altitude(nominal, batched.altitudes).to(table.dtype)
        return dataclasses.replace(batched, wind=table)
    if dataclasses.is_dataclass(batched):
        return dataclasses.replace(batched, **{
            f.name: with_nominal_lane(getattr(batched, f.name), getattr(nominal, f.name))
            for f in dataclasses.fields(batched) if not is_static(f)})
    if isinstance(batched, torch.Tensor) and batched.ndim > nominal.ndim:
        lanes = batched.clone()
        lanes[0] = nominal
        return lanes
    return batched


def chunked_flights(dev, ic, mc, wall4: float, usage: dict) -> tuple:
    """Phase 20: ``engine.simulate_batch_chunked`` and the analyzer's
    ``chunk_steps``, one launch of K1's carry build (with the stacked
    engine's speed) a chunk, each run's launches counted from 0 around it
    alone. ``mc`` is phase 4's analyzer, ``wall4`` its run's wall,
    ``usage`` the carry build's ptxas lines. Returns the runs' launch
    counts and the carry build's row of the kernels JSON."""
    from erpl_monte_carlo_sim_tpu_torch.engine import (InitialConditions, SimConfig,
                                                       simulate_batch_chunked, simulate_summary)
    from erpl_monte_carlo_sim_tpu_torch.engine.batch import prepare_batch
    from erpl_monte_carlo_sim_tpu_torch.kernels import flight_summary as fs
    from erpl_monte_carlo_sim_tpu_torch.kernels import threefry as tf
    from erpl_monte_carlo_sim_tpu_torch.mc import sample_dispersions
    from erpl_monte_carlo_sim_tpu_torch.models import liquid_motor, nominal_scene
    from erpl_monte_carlo_sim_tpu_torch.ops import prng

    carry = fs.PARITY._replace(stacked_speed=True, carry=True)
    counts = {}

    def counted_run(tag, fn, *args, **kw):
        torch.cuda.synchronize()
        fs.launches = fs.chunk_launches = fs.fold_launches = 0
        tf.launches = tf.ar1_launches = 0
        t0 = time.time()
        out = fn(*args, **kw)
        torch.cuda.synchronize()
        wall = time.time() - t0
        counts[tag] = {"k1": fs.launches, "chunk": fs.chunk_launches,
                       "fold": fs.fold_launches, "threefry": tf.launches, "ar1": tf.ar1_launches}
        if not counts[tag]["k1"] == counts[tag]["chunk"] == counts[tag]["fold"] > 1:
            raise AssertionError(f"{tag}: launches {counts[tag]} (chunks of the carry build, "
                                 "more than one, wanted)")
        return out, wall

    def same(a, b, tag):
        """Two ``FlightSummary`` (or its NumPy copy) results bit for bit."""
        for (path, x), (_, y) in zip(leaves(a), leaves(b)):
            x, y = np.asarray(torch.as_tensor(x).cpu()), np.asarray(torch.as_tensor(y).cpu())
            if not np.array_equal(x, y, equal_nan=x.dtype.kind == "f"):
                raise AssertionError(f"{tag}: {path} is not the one-shot run's")

    # (a) the main path's run, chunked, against one-shot on its own lanes
    cfg = mc.sim_config
    mc.run_monte_carlo(ic, n_samples=BENCH_LANES, seed=0, chunk_steps=CHUNK_STEPS)  # warm-up
    a, wall = counted_run("20a", mc.run_monte_carlo, ic, n_samples=BENCH_LANES, seed=0,
                          chunk_steps=CHUNK_STEPS)
    if counts["20a"]["threefry"] < 1 or counts["20a"]["ar1"] < 1:
        raise AssertionError(f"20a: the run's lanes were not drawn by the threefry kernels "
                             f"({counts['20a']})")
    scene_b, ic_b = sample_dispersions(
        prng.prng_key(0, dev), mc.scene, ic, mc.uncertainty_params, BENCH_LANES,
        wind_grid_points=mc.wind_grid_points, wind_grid_top=mc.wind_grid_top)[:2]
    same(simulate_summary(scene_b, ic_b, cfg), a["summary"], "20a")
    args = prepare_batch(scene_b, ic_b)
    one_ms, one = cuda_ms(lambda: fs.flight_summary(*args, cfg, stacked_speed=True), reps=2)
    chunk_ms, got = cuda_ms(lambda: fs.flight_summary_chunked(*args, cfg, CHUNK_STEPS), reps=2)
    if digest(got) != digest(one):
        raise AssertionError("20a: the carry build's outputs are not the one-shot build's")
    # and against K1's plain version with the stacked engine's speed, on the
    # same lanes at phase 4's bars (phase 4 holds the parity build so)
    main_plain_ms, ref = cuda_ms(lambda: fs.flight_summary_reference(*args, cfg,
                                                                     stacked_speed=True))
    main_err = compare(ref, got, torch.float32)
    del ref
    chunks = counts["20a"]["chunk"]
    bound = fs.bound_ms(got, cfg, torch.float32, fs.input_bytes(*args), chunk_steps=CHUNK_STEPS)
    threads, blocks = occupancy(fs, "f32", args[0], args[1], carry)
    row = {"launches": chunks, "lanes": BENCH_LANES, "chunk_steps": CHUNK_STEPS,
           "ms": chunk_ms, "ms_per_chunk": chunk_ms / chunks, "one_shot_ms": one_ms,
           "main_shape_max_abs_err": main_err, "main_shape_plain_ms": main_plain_ms,
           "bound_ms": bound.ms, "bound_by": bound.by, "share_of_bound": bound.ms / chunk_ms,
           "regs": usage["f32"]["regs"],
           "spill_bytes": usage["f32"]["spill_stores"] + usage["f32"]["spill_loads"],
           "warps_per_sm": blocks * threads // 32,
           "f64_regs": usage["f64"]["regs"],
           "f64_spill_bytes": usage["f64"]["spill_stores"] + usage["f64"]["spill_loads"]}
    phase("20a chunked main path", lanes=BENCH_LANES, chunk_steps=CHUNK_STEPS, chunks=chunks,
          launches=json.dumps(counts["20a"]), wall_s=f"{wall:.3f}", one_shot_wall_s=f"{wall4:.3f}",
          kernel_ms=f"{chunk_ms:.3f}", ms_per_chunk=f"{chunk_ms / chunks:.3f}",
          one_shot_kernel_ms=f"{one_ms:.3f}", bound_ms=bound.ms, bound_by=bound.by,
          max_abs_err=main_err, rtol=RTOL[torch.float32], atol=ATOL,
          plain_ms=f"{main_plain_ms:.1f}",
          n_valid=a["n_samples"], max_steps=int(got["n_steps"].max()))
    phase("20a digest chunked", lanes=BENCH_LANES, sha256=digest(got))
    phase("20a digest one-shot", lanes=BENCH_LANES, sha256=digest(one))
    del a, scene_b, ic_b, args, one, got

    # (b) parity full flights to landing at the default chunk: phase 5's
    # lanes, which diverge or land within 5,100 steps (F5), with the Quick
    # start's nominal flight in lane 0
    cfg_full = SimConfig()
    scene_b, ic_b = sample_batch(FULL_FLIGHT_LANES, torch.float32)
    scene_b = with_nominal_lane(scene_b, nominal_scene(liquid_motor(dev, torch.float32)))
    ic_b = with_nominal_lane(ic_b, InitialConditions.vertical_launch(dev, torch.float32))
    calls = []
    got, wall_full = counted_run("20b", simulate_batch_chunked, scene_b, ic_b, cfg_full,
                                 progress=lambda k, n: calls.append((k, n)))
    same(simulate_summary(scene_b, ic_b, cfg_full), got, "20b")
    steps = int(got.n_steps.max())
    if calls != [(k, fs.max_chunks(cfg_full, FULL_CHUNK_STEPS))
                 for k in range(1, -(-steps // FULL_CHUNK_STEPS) + 1)] or len(calls) < 3:
        raise AssertionError(f"20b: progress calls {calls} for {steps} steps")
    phase("20b chunked full flights", lanes=FULL_FLIGHT_LANES, chunk_steps=FULL_CHUNK_STEPS,
          chunks=len(calls), launches=json.dumps(counts["20b"]), progress=json.dumps(calls),
          wall_s=f"{wall_full:.3f}", max_steps=steps, lane0_steps=int(got.n_steps[0]),
          lane0_apogee_m=float(got.apogee_altitude[0]), diverged=int(got.diverged.sum()))
    del scene_b, ic_b, got

    # (c) the chunked route against its plain version on the card
    cfg = SimConfig(max_time=STACKED_WINDOW)
    for dtype in (torch.float64, torch.float32):
        dt = str(dtype).split(".")[-1]
        args = prepare_batch(*stacked_lanes(dtype))
        k_ms, got = cuda_ms(lambda: fs.flight_summary_chunked(*args, cfg, HELD_CHUNK_STEPS))
        p_ms, ref = cuda_ms(lambda: fs.flight_summary_chunked_reference(*args, cfg,
                                                                        HELD_CHUNK_STEPS))
        err, compared, ties = held_to_stacked(f"20c {dt}", ref, got, dtype)
        phase(f"20c carry=plain {dt}", lanes=STACKED_LANES, chunk_steps=HELD_CHUNK_STEPS,
              compared_lanes=compared, rail_ties=ties, max_abs_err=err, rtol=RTOL[dtype],
              atol=ATOL, nan_lane_max_speed=float(got["max_speed"][STACKED_NAN_LANE]),
              kernel_ms=f"{k_ms:.3f}", plain_ms=f"{p_ms:.1f}")
        if dtype == torch.float32:
            row.update(max_abs_err=err, max_abs_err_lanes=compared, plain_ms=p_ms,
                       plain_lanes=STACKED_LANES, plain_chunk_steps=HELD_CHUNK_STEPS,
                       ms_at_plain_shape=k_ms)
        del args, got, ref
    return counts, row


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    start = time.time()
    # ---------------------------------------------------------------- 0
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 1
    if argv[:1] == ["--landing-ties"]:
        print(json.dumps(count_landing_ties(int(argv[1]) if len(argv) > 1 else 8192)),
              flush=True)
        return 0
    if argv[:1] == ["--capstones"]:
        return capstone_runs()
    if argv[:1] == ["--capstone"]:
        return capstone_child(argv[1:])
    from erpl_monte_carlo_sim_tpu_torch.engine import SimConfig
    from erpl_monte_carlo_sim_tpu_torch.kernels import flight_summary as fs
    from erpl_monte_carlo_sim_tpu_torch.kernels import threefry as tf
    from erpl_monte_carlo_sim_tpu_torch.mc import MonteCarloAnalyzer
    from erpl_monte_carlo_sim_tpu_torch.engine import InitialConditions
    from erpl_monte_carlo_sim_tpu_torch.models import liquid_motor
    from erpl_monte_carlo_sim_tpu_torch.ops import prng

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(card, flush=True)
    phase("0 environment", device=repr(torch.cuda.get_device_name(0)),
          count=torch.cuda.device_count(), torch=torch.__version__,
          cuda=torch.version.cuda, nvcc=shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc",
          python=sys.version.split()[0])
    dev = torch.device("cuda")

    # ---------------------------------------------------------------- 1
    # every build the phases run, all compilers started at once
    builds = {name: flag_set(name)[2] for name in FLAG_SETS}
    # phase 10's recording builds
    record_builds = {"parity": fs.PARITY._replace(record=True),
                     "full_flights": flag_set("full_flights")[2]._replace(record=True)}
    # phase 11's: the stabilized example's single flight and exports record
    # through the energy_consistent_aero build
    example_builds = [builds["energy_consistent_aero"]._replace(record=True)]
    # phase 18's: the fast capstones' build (the others are among the above)
    fast_build = capstone_builds()["fast"]
    # phases 19 and 20: the stacked engine's builds, one-shot (fold), chunked
    # and recording
    stacked_builds = {"fold": fs.PARITY._replace(stacked_speed=True),
                      "carry": fs.PARITY._replace(stacked_speed=True, carry=True),
                      "record fold": fs.PARITY._replace(stacked_speed=True, record=True)}
    t0 = time.time()
    threefry_build = tf.build(verbose=True, start_only=True)  # beside K1's compilers
    logs = fs.build_many([fs.PARITY, *builds.values(), *record_builds.values(),
                          *example_builds, fast_build, *stacked_builds.values()],
                         verbose=True)
    _, threefry_log = threefry_build()
    build_s = time.time() - t0
    usage = ptxas_usage(logs[0][1])
    set_usage = {name: ptxas_usage(log) for name, (_, log) in zip(builds, logs[1:])}
    # the recording builds' two kernels apart: the flight and the derived pass
    record_usage = {name: record_ptxas(log)
                    for name, (_, log) in zip(record_builds, logs[1 + len(builds):])}
    phase("1 build", seconds=f"{build_s:.2f}", libraries=len({lib for lib, _ in logs}) + 1,
          ptxas=json.dumps(usage))
    # every instantiation of each threefry kernel: the largest registers and spills
    threefry_ptxas = kernel_ptxas(threefry_log, THREEFRY_KERNELS)
    phase("1 build threefry", ptxas=json.dumps(threefry_ptxas))
    for name, use in set_usage.items():
        phase(f"1 build {name}", build=fs.flags_name(builds[name]), ptxas=json.dumps(use))
    for (name, use), flags in zip(record_usage.items(), record_builds.values()):
        phase(f"1 build record {name}", build=fs.flags_name(flags), ptxas=json.dumps(use))
    for flags, (_, log) in zip(example_builds, logs[1 + len(builds) + len(record_builds):
                                                    1 + len(builds) + len(record_builds)
                                                    + len(example_builds)]):
        phase("1 build record example", build=fs.flags_name(flags),
              ptxas=json.dumps(record_ptxas(log)))
    capstone_usage = {"fast": ptxas_usage(logs[-1 - len(stacked_builds)][1])}
    phase("1 build capstone fast", build=fs.flags_name(fast_build),
          ptxas=json.dumps(capstone_usage["fast"]))
    stacked_usage = {name: (record_ptxas if "record" in name else ptxas_usage)(log)
                     for name, (_, log) in zip(stacked_builds, logs[-len(stacked_builds):])}
    for name, use in stacked_usage.items():
        phase(f"1 build {name}", build=fs.flags_name(stacked_builds[name]),
              ptxas=json.dumps(use))

    # ---------------------------------------------------------------- 2
    cfg = SimConfig(max_time=WINDOW)
    for dtype, n in ((torch.float32, 1024), (torch.float64, 256)):
        # in float64, one lane with a non-finite wind table above 2 km: it
        # must diverge at the same step in both versions
        scene_b, ic_b = sample_batch(n, dtype,
                                     nan_lane=7 if dtype == torch.float64 else None)
        t0 = time.time()
        ref, got = kernel_and_plain(scene_b, ic_b, cfg)
        secs = time.time() - t0
        err = compare(ref, got, dtype)
        if dtype == torch.float64 and not (bool(got["diverged"][7])
                                           and bool(ref["diverged"][7])):
            raise AssertionError("the NaN-wind lane did not diverge")
        phase(f"2 kernel=plain {str(dtype).split('.')[-1]}", lanes=n,
              max_abs_err=err, rtol=RTOL[dtype], atol=ATOL, both_seconds=f"{secs:.2f}",
              n_steps_max=int(got["n_steps"].max()), diverged=int(got["diverged"].sum()))
        phase(f"2 digest {str(dtype).split('.')[-1]}", lanes=n, sha256=digest(got))

    # ---------------------------------------------------------------- 3
    from erpl_monte_carlo_sim_tpu_torch.engine import simulate_summary_batch
    from erpl_monte_carlo_sim_tpu_torch.models import nominal_scene

    from erpl_monte_carlo_sim_tpu_torch.models import solid_motor
    from erpl_monte_carlo_sim_tpu_torch.utils.tree import tree_map

    goldens = {}
    for motor in ("liquid", "solid"):
        with open(os.path.join(ROOT, "tests", "golden", f"flight_{motor}_nowind.json")) as f:
            goldens[motor] = json.load(f)
    # the bars of tests/test_flight.py: the liquid motor in float64 (apogee
    # 1e-5, and _check_summary's other bars) and in float32 (0.1%), the
    # solid motor in float64 (apogee 5e-4)
    for motor, dtype, apogee_rel in (("liquid", torch.float64, 1e-5),
                                     ("liquid", torch.float32, 1e-3),
                                     ("solid", torch.float64, 5e-4)):
        golden = goldens[motor]
        make = liquid_motor if motor == "liquid" else solid_motor
        scene = nominal_scene(make(dev, dtype))
        ic = InitialConditions.vertical_launch(dev, dtype)
        ic1 = InitialConditions(*(v[None] for v in (ic.position, ic.velocity, ic.attitude,
                                                    ic.angular_velocity)))
        t0 = time.time()
        s = simulate_summary_batch(scene, ic1, SimConfig())
        torch.cuda.synchronize()
        secs = time.time() - t0
        apogee = float(s.apogee_altitude[0])
        golden_checks(tree_map(lambda x: x[0], s), golden, dtype, apogee_rel,
                      f"golden flight ({motor}, {dtype})", n_steps=motor == "liquid")
        tag = "" if motor == "liquid" else f" {motor}"
        extra = {} if dtype == torch.float32 else {
            "range_m": float(s.range[0]), "golden_range_m": golden["range"],
            "flight_time_s": float(s.flight_time[0]),
            "golden_flight_time_s": golden["flight_time"]}
        phase(f"3 golden{tag} {str(dtype).split('.')[-1]}", apogee_m=apogee,
              golden_m=golden["apogee_altitude"],
              rail_exit_speed=float(s.rail.rail_exit_speed[0]),
              rail_exit_time=float(s.rail.rail_exit_time[0]),
              n_steps=int(s.n_steps[0]), seconds=f"{secs:.3f}", **extra)

    # ---------------------------------------------------------------- 4
    ic = InitialConditions.vertical_launch(dev)
    mc = MonteCarloAnalyzer(motor=liquid_motor(dev), sim_config=SimConfig(max_time=WINDOW))
    mc.run_monte_carlo(ic, n_samples=BENCH_LANES, seed=0)  # warm-up
    torch.cuda.synchronize()
    fs.launches = tf.launches = tf.ar1_launches = 0
    t0 = time.time()
    analysis = mc.run_monte_carlo(ic, n_samples=BENCH_LANES, seed=0)
    wall = time.time() - t0
    launches, threefry_launches = fs.launches, {"draw": tf.launches, "ar1": tf.ar1_launches}
    if launches < 1:
        raise AssertionError("the main path did not launch the flight_summary kernel")
    if threefry_launches["draw"] < 1:
        raise AssertionError("the main path did not draw through the threefry kernel")
    if threefry_launches["ar1"] < 1:
        raise AssertionError("the main path's wind did not run the AR(1) kernel")
    stats_ok = all(math.isfinite(analysis[k][s]) for k in ("apogee_altitude", "range",
                                                            "flight_time")
                   for s in ("mean", "std", "min", "max"))
    if analysis["n_samples"] <= 0 or not stats_ok:
        raise AssertionError(f"main path result: n_samples={analysis['n_samples']}, "
                             f"finite stats={stats_ok}")
    steps = int(np.max(analysis["summary"].n_steps))
    phase("4 main path", lanes=BENCH_LANES, launches=launches,
          threefry_launches=threefry_launches["draw"], ar1_launches=threefry_launches["ar1"],
          wall_s=f"{wall:.3f}", trajectories_per_s=f"{BENCH_LANES / wall:.1f}",
          n_valid=analysis["n_samples"], n_outliers=analysis["n_outliers"],
          apogee_mean=analysis["apogee_altitude"]["mean"], max_steps=steps)

    # kernel against plain at the main path's shape, timed (not counted above)
    scene_b, ic_b = sample_batch(BENCH_LANES, torch.float32)
    from erpl_monte_carlo_sim_tpu_torch.engine.batch import prepare_batch

    scene_nw, grid, wind, ics = prepare_batch(scene_b, ic_b)
    fs.flight_summary(scene_nw, grid, wind, ics, cfg)
    kernel_ms, got = cuda_ms(lambda: fs.flight_summary(scene_nw, grid, wind, ics, cfg),
                             reps=3)
    plain_ms, ref = cuda_ms(lambda: fs.flight_summary_reference(scene_nw, grid, wind, ics,
                                                                cfg))
    main_err = compare(ref, got, torch.float32)
    bound = fs.bound_ms(got, cfg, torch.float32, fs.input_bytes(scene_nw, grid, wind, ics))
    threads, blocks = occupancy(fs, "f32", scene_nw, grid)
    f32 = usage["f32"]
    costs = {"bound_ms": bound.ms, "bound_by": bound.by, "lane_steps": bound.lane_steps,
             "share_of_bound": bound.ms / kernel_ms, "regs": f32["regs"],
             "spill_bytes": f32["spill_stores"] + f32["spill_loads"],
             "warps_per_sm": blocks * threads // 32}
    phase("4 kernel vs plain", lanes=BENCH_LANES, max_abs_err=main_err,
          rtol=RTOL[torch.float32], atol=ATOL, kernel_ms=f"{kernel_ms:.3f}",
          plain_ms=f"{plain_ms:.3f}", speedup=f"{plain_ms / kernel_ms:.1f}", **costs)
    phase("4 digest f32", lanes=BENCH_LANES, sha256=digest(got))

    # ---------------------------------------------------------------- 5
    def drawn() -> dict:
        """The threefry kernels' launches since the last call (each later
        phase's draws, printed on its closing line)."""
        n = {"threefry_launches": tf.launches, "ar1_launches": tf.ar1_launches}
        tf.launches = tf.ar1_launches = 0
        return n

    drawn()
    mc_full = MonteCarloAnalyzer(motor=liquid_motor(dev), sim_config=SimConfig())
    torch.cuda.synchronize()
    t0 = time.time()
    full = mc_full.run_monte_carlo(ic, n_samples=FULL_FLIGHT_LANES, seed=0)
    wall_full = time.time() - t0
    if full["n_samples"] <= 0 or not math.isfinite(full["apogee_altitude"]["mean"]):
        raise AssertionError("full-flight run produced no valid lanes")
    phase("5 full flights", lanes=FULL_FLIGHT_LANES, wall_s=f"{wall_full:.3f}",
          n_outliers=full["n_outliers"], apogee_mean=full["apogee_altitude"]["mean"],
          flight_time_mean=full["flight_time"]["mean"],
          max_steps=int(np.max(full["summary"].n_steps)))
    # the kernel's own outputs for full flights, for the digest
    scene_b, ic_b = sample_batch(FULL_FLIGHT_LANES, torch.float32)
    phase("5 digest f32", lanes=FULL_FLIGHT_LANES,
          sha256=digest(fs.flight_summary(*prepare_batch(scene_b, ic_b), SimConfig())))

    # ---------------------------------------------------------------- 6
    def timed_row(name, dt, t):
        use = set_usage[name][dt]
        row = {k: t[k] for k in ("lanes", "ms", "bound_ms", "bound_by", "share_of_bound",
                                 "warps_per_sm", "digest")}
        row.update(regs=use["regs"], spill_bytes=use["spill_stores"] + use["spill_loads"])
        phase(f"6 timed {name} {dt}", **row)
        return row

    rows = {name: {"build": fs.flags_name(flags)} for name, flags in builds.items()}
    for name in FLAG_SETS:
        row = rows[name]
        for dtype in (torch.float32, torch.float64):
            dt = str(dtype).split(".")[-1]
            cfg6, stall, flags = flag_set(name, max_time=WINDOW)
            nan_lane = 7 if name == "terminate_nonfinite" else None
            scene_b, ic_b = sample_batch(FLAG_LANES[dtype], dtype, nan_lane=nan_lane)
            if stall:  # 4x the wind: lanes leave the rail past the stall angle
                scene_b = with_stall(dataclasses.replace(scene_b, wind=dataclasses.replace(
                    scene_b.wind, wind=scene_b.wind.wind * 4.0)))
            cases = [("window", scene_b, ic_b, cfg6)]
            if name in TO_LANDING:
                cases.append(("to landing", *low_apogee_batch(dev, dtype), flag_set(name)[0]))
            for what, sb, ib, c in cases:
                args, got, launched = drive(sb, ib, c)
                check_flag_run(name, what, got, nan_lane)
                ref, got_n, p_ms = plain_on_head(args, got, c)
                ties = torch.zeros_like(got_n["diverged"], dtype=torch.bool)
                if name == "speed_guard":
                    ties = guard_ties(ref, got_n, c.speed_guard, dtype)
                    if int(ties.sum()) > 1e-3 * ties.numel():
                        raise AssertionError(f"speed guard: {int(ties.sum())} lanes stop a "
                                             "step apart")
                on_rail = rail_ties(args, ref, got_n, c, dtype) & ~ties
                if int(on_rail.sum()) > 1e-3 * on_rail.numel():
                    raise AssertionError(f"{name}: {int(on_rail.sum())} rail exits a step "
                                         "apart")
                ties |= on_rail
                kept = ~ties
                err = compare({k: v[kept] for k, v in ref.items()},
                              {k: v[kept] for k, v in got_n.items()}, dtype)
                compared = int(kept.sum())
                del ref
                phase(f"6 kernel=plain {name} {dt} {what}", build=row["build"],
                      lanes=int(got["n_steps"].numel()), compared_lanes=compared,
                      guard_ties=int((ties & ~on_rail).sum()), rail_ties=int(on_rail.sum()),
                      max_time=c.max_time, launches=launched,
                      max_abs_err=err, plain_ms=f"{p_ms:.1f}",
                      n_steps_max=int(got["n_steps"].max()),
                      diverged=int(got["diverged"].sum()))
                phase(f"6 digest {name} {dt} {what}", sha256=digest(got))
                if what == "window" and dtype == torch.float32:
                    # timed on the inputs whose outputs were just compared
                    row.update(launches=launched, max_abs_err=err,
                               max_abs_err_lanes=compared, plain_ms=p_ms,
                               f32=timed_row(name, "f32", time_kernel(
                                   fs, args, c, dtype, reps=2, flags=flags)))
                del args, got, got_n
            del scene_b, ic_b, cases
            torch.cuda.empty_cache()
    # float64 timed at B=65,536
    scene_b, ic_b = sample_batch(F64_TIMED_LANES, torch.float64)
    for name in FLAG_SETS:
        cfg6, stall, flags = flag_set(name, max_time=WINDOW)
        rows[name]["f64"] = timed_row(name, "f64", time_kernel(
            fs, prepare_batch(with_stall(scene_b, stall), ic_b), cfg6, torch.float64, reps=2,
            flags=flags))
    del scene_b, ic_b
    torch.cuda.empty_cache()

    # ---------------------------------------------------------------- 7
    from erpl_monte_carlo_sim_tpu_torch.mc import sample_dispersions

    medians = {}
    for name in ("full_flights", "energy_consistent_aero"):
        cfg7, _, flags = flag_set(name)
        mc7 = MonteCarloAnalyzer(motor=liquid_motor(dev), sim_config=cfg7)
        mc7.run_monte_carlo(ic, n_samples=1024, seed=0)  # warm-up
        torch.cuda.synchronize()
        fs.launches = 0
        t0 = time.time()
        a7 = mc7.run_monte_carlo(ic, n_samples=BENCH_LANES, seed=0)
        wall7 = time.time() - t0
        launched = fs.launches
        if launched < 1:
            raise AssertionError(f"full flights ({name}) did not launch the kernel")
        medians[name] = float(np.median(a7["summary"].n_steps))
        # the run's own lanes, drawn as run_monte_carlo draws them
        args = prepare_batch(*sample_dispersions(
            prng.prng_key(0, dev), mc7.scene, ic, mc7.uncertainty_params, BENCH_LANES,
            wind_grid_points=mc7.wind_grid_points, wind_grid_top=mc7.wind_grid_top)[:2])
        got = fs.flight_summary(*args, cfg7)
        for k in ("n_steps", "apogee_altitude", "flight_time"):
            if not np.array_equal(got[k].cpu().numpy(), getattr(a7["summary"], k),
                                  equal_nan=True):
                raise AssertionError(f"full flights ({name}): {k} is not the run's")
        t = time_kernel(fs, args, cfg7, torch.float32, reps=1, flags=flags)
        stats = {"lanes": BENCH_LANES, "launches": launched, "wall_s": wall7,
                 "n_outliers": a7["n_outliers"], "apogee_mean": a7["apogee_altitude"]["mean"],
                 "median_n_steps": medians[name], "kernel_ms": t["ms"],
                 "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
                 "share_of_bound": t["share_of_bound"]}
        if name == "full_flights":  # the run's first lanes against the plain version
            stats.update(full_flights_against_plain(args, got, cfg7, BENCH_LANES))
        del args, got
        torch.cuda.empty_cache()
        rows[name]["full_flights_f32"] = stats
        phase(f"7 full flights {name}", build=rows[name]["build"], **stats)
    tiered = rows["full_flights"]["full_flights_f32"]
    ratio = medians["energy_consistent_aero"] / medians["full_flights"]
    if tiered["n_outliers"] > 0.01 * BENCH_LANES or not ratio > 2.5:
        raise AssertionError(f"stabilized full flights: {tiered['n_outliers']} outliers "
                             f"(at most 1% allowed), median steps {ratio:.2f}x fewer tiered "
                             "(more than 2.5x required)")
    phase("7 tiered against fine", median_steps_ratio=ratio,
          outlier_share=tiered["n_outliers"] / BENCH_LANES)

    # ---------------------------------------------------------------- 8
    certificates(dev)

    # ---------------------------------------------------------------- 9
    large_launches, run9a = large_runs(dev, ic)
    phase("5-9 draws", **drawn())

    # ---------------------------------------------------------------- 10
    t0 = time.time()
    record_rows = recordings(dev, ic, mc, analysis, record_usage, record_builds)
    derived_row = record_rows.pop("derived")
    phase("10 done", phase_10_s=f"{time.time() - t0:.1f}", script_s=f"{time.time() - start:.1f}",
          **drawn())

    # ---------------------------------------------------------------- 11
    t0 = time.time()
    example_launches = entry_point(dev)
    phase("11 done", phase_11_s=f"{time.time() - t0:.1f}", script_s=f"{time.time() - start:.1f}",
          **drawn())

    # ---------------------------------------------------------------- 12
    t0 = time.time()
    variant_launches = sampling_variants(dev, ic, mc, analysis)
    phase("12 done", phase_12_s=f"{time.time() - t0:.1f}", script_s=f"{time.time() - start:.1f}",
          **drawn())

    # ---------------------------------------------------------------- 13
    t0 = time.time()
    estimator_launches = estimators(dev, ic, mc, analysis)
    phase("13 done", phase_13_s=f"{time.time() - t0:.1f}", script_s=f"{time.time() - start:.1f}",
          **drawn())

    # ---------------------------------------------------------------- 14
    t0 = time.time()
    modes_launches = wind_modes(dev, ic, analysis)
    phase("14 done", phase_14_s=f"{time.time() - t0:.1f}", script_s=f"{time.time() - start:.1f}",
          **drawn())

    # ---------------------------------------------------------------- 15
    t0 = time.time()
    diff_launches = differentiable(dev)
    phase("15 done", phase_15_s=f"{time.time() - t0:.1f}", script_s=f"{time.time() - start:.1f}",
          **drawn())

    # ---------------------------------------------------------------- 16
    t0 = time.time()
    parallel_launches = multi_rank(dev, ic, analysis, run9a, card)
    phase("16 done", phase_16_s=f"{time.time() - t0:.1f}", script_s=f"{time.time() - start:.1f}",
          **drawn())

    # ---------------------------------------------------------------- 17
    t0 = time.time()
    threefry_rows = threefry_phase(dev, ic, mc, threefry_launches, threefry_ptxas)
    phase("17 done", phase_17_s=f"{time.time() - t0:.1f}", script_s=f"{time.time() - start:.1f}")

    # ---------------------------------------------------------------- 18
    t0 = time.time()
    drawn()
    capstone_launches, capstone_row = capstones(dev, capstone_builds(), capstone_usage)
    phase("18 done", phase_18_s=f"{time.time() - t0:.1f}", script_s=f"{time.time() - start:.1f}",
          **drawn())

    # ---------------------------------------------------------------- 19
    t0 = time.time()
    stacked_launches, fold_row = stacked_engine(dev, goldens, stacked_usage["fold"],
                                                stacked_usage["record fold"])
    phase("19 done", phase_19_s=f"{time.time() - t0:.1f}", script_s=f"{time.time() - start:.1f}",
          **drawn())

    # ---------------------------------------------------------------- 20
    t0 = time.time()
    chunked_launches, carry_row = chunked_flights(dev, ic, mc, wall, stacked_usage["carry"])
    phase("20 done", phase_20_s=f"{time.time() - t0:.1f}", script_s=f"{time.time() - start:.1f}",
          **drawn())

    report = {"kernels": [
        {"name": f"flight_summary ({name})", "route": "cuda", "source": KERNEL_SOURCE,
         "replaces": where, "launches": launches, "max_abs_err": main_err,
         "ms": kernel_ms, "plain_ms": plain_ms, "library_ms": None,
         "large_run_launches": large_launches,
         "example_launches": {k: v["k1"] for k, v in example_launches.items()},
         "variant_launches": {k: v for k, v in variant_launches.items() if "record" not in k},
         "estimator_launches": estimator_launches, "modes_launches": modes_launches,
         "diff_launches": diff_launches, "parallel_launches": parallel_launches,
         "capstone_launches": capstone_launches,
         "stacked_launches": {k: v["k1"] for k, v in stacked_launches.items()}, **costs}
        for name, where in REPLACES
    ] + [
        {"name": f"flight_summary [{name}]", "route": "cuda", "source": KERNEL_SOURCE,
         "replaces": REPLACES[0][1], "launches": row["launches"],
         "max_abs_err": row["max_abs_err"], "ms": row["f32"]["ms"],
         "plain_ms": row["plain_ms"], "bound_ms": row["f32"]["bound_ms"],
         "bound_by": row["f32"]["bound_by"], "library_ms": None, **row}
        for name, row in rows.items()
    ] + [
        {"name": "flight_summary [fold parity+stacked_speed]", "route": "cuda",
         "source": KERNEL_SOURCE, "replaces": REPLACES[1][1], "build":
         fs.flags_name(stacked_builds["fold"]),
         "launches": stacked_launches["19b float32"]["fold"],
         "max_abs_err": fold_row["f32"]["max_abs_err"], "ms": fold_row["f32"]["ms"],
         "plain_ms": fold_row["f32"]["plain_ms"], "bound_ms": fold_row["f32"]["bound_ms"],
         "bound_by": fold_row["f32"]["bound_by"], "library_ms": None,
         "stacked_launches": {k: v["fold"] for k, v in stacked_launches.items()},
         "f32": fold_row["f32"], "f64": fold_row["f64"]},
        {"name": "flight_summary [record fold parity+stacked_speed]", "route": "cuda",
         "source": KERNEL_SOURCE, "replaces": REPLACES[1][1], "build":
         fs.flags_name(stacked_builds["record fold"]), "library_ms": None,
         "stacked_launches": {"19c": stacked_launches["19c f64"]["k1_rec"]},
         **fold_row["record"]},
        {"name": "flight_summary [carry parity+stacked_speed]", "route": "cuda",
         "source": KERNEL_SOURCE, "replaces": REPLACES[1][1], "build":
         fs.flags_name(stacked_builds["carry"]), "library_ms": None,
         "chunked_launches": chunked_launches, **carry_row},
    ] + [capstone_row] + [
        {"name": f"flight_summary [record {name}]", "route": "cuda", "source": KERNEL_SOURCE,
         "replaces": REPLACES[0][1], "library_ms": None,
         "example_launches": {k: v["k1_rec"] for k, v in example_launches.items()},
         **({"variant_launches": {"12d": variant_launches["12d record"]}}
            if name == "parity" else {}), **row}
        for name, row in record_rows.items()
    ] + [
        {"name": "flight_summary [record derived pass]", "route": "cuda",
         "source": KERNEL_SOURCE, "replaces": DERIVED_REPLACES, "library_ms": None,
         "stacked_launches": {"19c": stacked_launches["19c f64"]["derived"]},
         **derived_row}
    ] + threefry_rows}
    print(card, flush=True)
    print(json.dumps(report), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
