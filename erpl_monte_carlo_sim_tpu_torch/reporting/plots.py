"""Visualization (``erpl_monte_carlo_sim_tpu/reporting/plots.py``): the
reference's five plot types and the JAX package's additions, with the same
panels, labels, titles, bins and alphas, so the artifacts of the two
packages can be compared by eye.

  1. ``plot_results``            -- 2x2 histograms + range-vs-apogee scatter
  2. ``plot_trajectory_cloud``   -- altitude-vs-time + ground-track cloud
  3. ``plot_trajectory_cloud_3d``-- 3-D trajectory cloud
  4. ``plot_single_simulation``  -- 3x2 flight panel
  5. ``plot_thrust_twr``         -- thrust + thrust-to-weight panels

and ``plot_landing_footprint``, ``plot_exceedance``,
``plot_flight_envelope``, ``plot_launch_window`` and ``plot_convergence``.
Every figure reads NumPy: tensors are converted once, at the top of each
function. The trajectory clouds fly their lanes through
``MonteCarloAnalyzer.resimulate_trajectories``, whose memo serves lanes
that ``save_simulation_results`` has just flown. ``plot_sobol_indices``
draws ``mc.sobol_indices``' decomposition, and ``plot_exceedance(gpd=True)``
overlays ``mc.tail``'s extrapolation. Matplotlib runs in Agg mode; it is
imported when a figure is drawn, after the figure's data are gathered, and a
host without it draws no figure (``_pyplot`` raises ImportError).
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..utils.convert import to_numpy

__all__ = [
    "plot_results",
    "plot_trajectory_cloud",
    "plot_trajectory_cloud_3d",
    "plot_single_simulation",
    "plot_thrust_twr",
    "plot_landing_footprint",
    "plot_exceedance",
    "plot_sobol_indices",
    "plot_flight_envelope",
    "plot_launch_window",
    "plot_convergence",
]


def _pyplot(figure: str):
    """``matplotlib.pyplot`` in Agg mode, imported at a figure's first use
    (after its data are gathered), so that the package, its reports, its
    exports and its CLIs need no plotting library; raises ImportError
    naming ``figure`` where matplotlib is not installed."""
    try:
        import matplotlib
    except ImportError as e:
        raise ImportError(f"{figure} needs matplotlib, which is not installed (the "
                          "reports and exports do not)") from e
    if matplotlib.get_backend().lower() != "agg":
        matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def plot_results(analysis: dict, output_dir: str | None = None,
                 save_plots: bool = True) -> str | None:
    """2x2 distribution figure (`monte_carlo.py:562-633`)."""
    plt = _pyplot("plot_results")
    _, axes = plt.subplots(2, 2, figsize=(12, 10))

    summary = analysis["summary"]
    valid = to_numpy(analysis["valid_mask"])
    if summary is not None:
        apogees = to_numpy(summary.apogee_altitude)[valid]
        ranges = to_numpy(summary.range)[valid]
        times = to_numpy(summary.flight_time)[valid]
    else:
        # Slabbed (auto-slab) runs keep per-lane headline metrics only —
        # the full FlightSummary SoA is never materialized at 10M+ lanes
        # (mc/analyzer._run_slabbed).
        m = analysis["metrics"]
        apogees = np.asarray(m["apogee_altitude"])[valid]
        ranges = np.asarray(m["range"])[valid]
        times = np.asarray(m["flight_time"])[valid]

    axes[0, 0].hist(apogees[np.isfinite(apogees)], bins=50, alpha=0.7,
                    edgecolor="black")
    axes[0, 0].set_xlabel("Apogee Altitude (m)")
    axes[0, 0].set_ylabel("Frequency")
    axes[0, 0].set_title("Apogee Altitude Distribution")
    axes[0, 0].grid(True, alpha=0.3)

    axes[0, 1].hist(ranges[np.isfinite(ranges)], bins=50, alpha=0.7,
                    edgecolor="black")
    axes[0, 1].set_xlabel("Range (m)")
    axes[0, 1].set_ylabel("Frequency")
    axes[0, 1].set_title("Range Distribution")
    axes[0, 1].grid(True, alpha=0.3)

    axes[1, 0].hist(times[np.isfinite(times)], bins=50, alpha=0.7,
                    edgecolor="black")
    axes[1, 0].set_xlabel("Flight Time (s)")
    axes[1, 0].set_ylabel("Frequency")
    axes[1, 0].set_title("Flight Time Distribution")
    axes[1, 0].grid(True, alpha=0.3)

    finite = np.isfinite(apogees) & np.isfinite(ranges)
    axes[1, 1].scatter(apogees[finite], ranges[finite], alpha=0.6, s=10)
    axes[1, 1].set_xlabel("Apogee Altitude (m)")
    axes[1, 1].set_ylabel("Range (m)")
    axes[1, 1].set_title("Range vs Apogee Altitude")
    axes[1, 1].grid(True, alpha=0.3)

    plt.tight_layout()
    if save_plots and output_dir is not None:
        path = os.path.join(output_dir, "monte_carlo_distributions.png")
        plt.savefig(path, dpi=150, bbox_inches="tight")
        plt.close()
        return path
    plt.close()
    return None


def plot_landing_footprint(analysis: dict, output_dir: str | None = None,
                           max_points: int = 20000) -> str | None:
    """Landing-dispersion map (beyond reference — the classic rocketry MC
    deliverable): impact-point scatter, mean impact point, 95%/99%
    dispersion ellipses, and the CEP circle, from
    ``analysis["landing_footprint"]``. Single-call runs scatter the
    materialized per-lane landing positions; slabbed runs (``summary`` is
    None) render the ellipses/CEP from the streamed footprint alone."""
    fp = analysis.get("landing_footprint")
    if not fp or fp.get("n", 0) == 0:
        return None
    plt = _pyplot("plot_landing_footprint")
    from matplotlib.patches import Ellipse

    _, ax = plt.subplots(figsize=(9, 9))

    summary = analysis.get("summary")
    if summary is not None:
        lp = to_numpy(summary.landing_position)
    elif analysis.get("landing_samples") is not None:
        # slabbed runs: the capped per-lane prefix (footprint stats above
        # the scatter still cover EVERY lane via the moment merge)
        lp = np.asarray(analysis["landing_samples"])
    else:
        lp = None
    if lp is not None and lp.shape[0]:
        valid = np.asarray(analysis["valid_mask"])[: lp.shape[0]]
        fin = valid & np.isfinite(lp[:, 0]) & np.isfinite(lp[:, 1])
        pts = lp[fin][:, :2]
        if len(pts) > max_points:
            # evenly strided subsample (lane order is draw order, so a
            # head-truncation would be scramble/antithetic-block biased)
            pts = pts[np.linspace(0, len(pts) - 1, max_points).astype(int)]
        label = (f"impacts ({len(pts)} of {fp['n']} lanes)"
                 if len(pts) < fp["n"] else f"impacts ({fp['n']} lanes)")
        ax.scatter(pts[:, 0], pts[:, 1], alpha=0.4, s=8, label=label)

    mx, my = fp["mean_m"]
    for tag, style in (("ellipse95", "-"), ("ellipse99", "--")):
        e = fp[tag]
        ax.add_patch(Ellipse(
            (mx, my), width=2 * e["semi_major_m"],
            height=2 * e["semi_minor_m"], angle=fp["orientation_deg"],
            fill=False, linestyle=style, linewidth=1.5, color="tab:red",
            label=f"{tag[-2:]}% ellipse",
        ))
    ax.add_patch(plt.Circle(
        (mx, my), fp["cep_m"], fill=False, linewidth=1.5,
        color="tab:orange",
        label=f"CEP {fp['cep_m']:.0f} m ({fp['cep_method']})",
    ))
    ax.plot([mx], [my], marker="+", markersize=12, color="tab:red",
            label="mean impact")
    ax.plot([0], [0], marker="^", markersize=10, color="black",
            label="launch site")
    ax.set_xlabel("Downrange X (m)")
    ax.set_ylabel("Crossrange Y (m)")
    ax.set_title("Landing Dispersion Footprint")
    ax.set_aspect("equal", adjustable="datalim")
    ax.grid(True, alpha=0.3)
    ax.legend(loc="upper right", fontsize=9)
    plt.tight_layout()
    if output_dir is not None:
        path = os.path.join(output_dir, "landing_footprint.png")
        plt.savefig(path, dpi=150, bbox_inches="tight")
        plt.close()
        return path
    plt.close()
    return None


def _cloud_trajectories(analyzer, analysis, max_trajectories):
    """The lane ids and ``(time, position, valid)`` on the host of the
    first ``max_trajectories`` valid lanes, flown again (the memo of
    ``resimulate_trajectories`` serves a repeat of the same lanes)."""
    ids = [r["simulation_id"] for r in analysis["results"][:max_trajectories]]
    if not ids:
        return ids, None
    _, traj = analyzer.resimulate_trajectories(ids)
    return ids, (to_numpy(traj.time), to_numpy(traj.position), to_numpy(traj.valid))


def plot_trajectory_cloud(analyzer, analysis: dict, output_dir: str,
                          max_trajectories: int = 50) -> str | None:
    """Altitude-vs-time + ground-track cloud (`monte_carlo.py:635-677`)."""
    ids, traj = _cloud_trajectories(analyzer, analysis, max_trajectories)
    if traj is None:
        return None
    plt = _pyplot("plot_trajectory_cloud")
    _, (ax1, ax2) = plt.subplots(1, 2, figsize=(15, 6))
    t, pos, valid = traj
    for k in range(len(ids)):
        m = valid[k]
        ax1.plot(t[k][m], pos[k, m, 2], alpha=0.3, linewidth=0.5, color="blue")
        ax2.plot(pos[k, m, 0], pos[k, m, 1], alpha=0.3, linewidth=0.5, color="red")
    ax1.set_xlabel("Time (s)")
    ax1.set_ylabel("Altitude (m)")
    ax1.set_title(f"Trajectory Cloud - Altitude vs Time\n({len(ids)} trajectories)")
    ax1.grid(True, alpha=0.3)
    ax2.set_xlabel("East Position (m)")
    ax2.set_ylabel("North Position (m)")
    ax2.set_title(f"Ground Track Cloud\n({len(ids)} trajectories)")
    ax2.grid(True, alpha=0.3)
    ax2.axis("equal")
    plt.tight_layout()
    path = os.path.join(output_dir, "monte_carlo_trajectories.png")
    plt.savefig(path, dpi=150, bbox_inches="tight")
    plt.close()
    return path


def plot_trajectory_cloud_3d(analyzer, analysis: dict, output_dir: str,
                             max_trajectories: int = 50) -> str | None:
    """3-D trajectory cloud (`monte_carlo.py:679-707`)."""
    ids, traj = _cloud_trajectories(analyzer, analysis, max_trajectories)
    if traj is None:
        return None
    plt = _pyplot("plot_trajectory_cloud_3d")
    fig = plt.figure(figsize=(10, 8))
    ax = fig.add_subplot(111, projection="3d")
    _, pos, valid = traj
    for k in range(len(ids)):
        m = valid[k]
        ax.plot(pos[k, m, 0], pos[k, m, 1], pos[k, m, 2], alpha=0.3, linewidth=0.5)
    ax.set_xlabel("East Position (m)")
    ax.set_ylabel("North Position (m)")
    ax.set_zlabel("Altitude (m)")
    ax.set_title(f"3D Trajectory Cloud ({len(ids)} trajectories)")
    ax.grid(True, alpha=0.3)
    path = os.path.join(output_dir, "monte_carlo_trajectories_3d.png")
    plt.savefig(path, dpi=150, bbox_inches="tight")
    plt.close()
    return path


def plot_single_simulation(results: dict, output_dir: str = "simulation_plots"
                           ) -> str:
    """3x2 single-flight panel (`example.py:75-137`)."""
    os.makedirs(output_dir, exist_ok=True)
    plt = _pyplot("plot_single_simulation")
    _, axes = plt.subplots(3, 2, figsize=(12, 14))

    t = np.asarray(results["time"])
    axes[0, 0].plot(t, results["altitude"])
    axes[0, 0].set_xlabel("Time (s)")
    axes[0, 0].set_ylabel("Altitude (m)")
    axes[0, 0].set_title("Altitude vs Time")
    axes[0, 0].grid(True, alpha=0.3)

    axes[0, 1].plot(t, results["speed"])
    axes[0, 1].set_xlabel("Time (s)")
    axes[0, 1].set_ylabel("Speed (m/s)")
    axes[0, 1].set_title("Speed vs Time")
    axes[0, 1].grid(True, alpha=0.3)

    axes[1, 0].plot(results["position"][0, :], results["position"][2, :])
    axes[1, 0].set_xlabel("Downrange (m)")
    axes[1, 0].set_ylabel("Altitude (m)")
    axes[1, 0].set_title("Trajectory")
    axes[1, 0].grid(True, alpha=0.3)

    eul = np.degrees(np.asarray(results["euler_angles"]))
    for i, name in enumerate(["Roll", "Pitch", "Yaw"]):
        axes[1, 1].plot(t, eul[i, :], label=name)
    axes[1, 1].set_xlabel("Time (s)")
    axes[1, 1].set_ylabel("Angle (degrees)")
    axes[1, 1].set_title("Euler Angles")
    axes[1, 1].legend()
    axes[1, 1].grid(True, alpha=0.3)

    axes[2, 0].plot(t, results["center_of_mass"], label="CG")
    axes[2, 0].plot(t, results["cp_location_dynamic"], "--", color="r", label="CP")
    axes[2, 0].set_xlabel("Time (s)")
    axes[2, 0].set_ylabel("Position along body (m)")
    axes[2, 0].set_title("CP and CG vs Time")
    axes[2, 0].legend()
    axes[2, 0].grid(True, alpha=0.3)

    axes[2, 1].plot(t, np.degrees(np.asarray(results["angle_of_attack"])))
    axes[2, 1].set_xlabel("Time (s)")
    axes[2, 1].set_ylabel("Angle (deg)")
    axes[2, 1].set_title("Angle of Attack vs Time")
    axes[2, 1].grid(True, alpha=0.3)

    plt.tight_layout()
    path = os.path.join(output_dir, "single_simulation_results.png")
    plt.savefig(path, dpi=150, bbox_inches="tight")
    plt.close()
    return path


def plot_thrust_twr(results: dict, output_dir: str) -> str:
    """Thrust + TWR panels (`example.py:139-161`)."""
    from ..models.atmosphere import AtmosphereParams, gravity_at

    atm = AtmosphereParams.create("cpu", torch.float64)
    t = np.asarray(results["time"])
    gravity = to_numpy(gravity_at(atm, torch.as_tensor(np.asarray(results["altitude"],
                                                                  np.float64))))
    twr = np.asarray(results["thrust"]) / (np.asarray(results["mass"]) * gravity)

    plt = _pyplot("plot_thrust_twr")
    _, axes = plt.subplots(2, 1, figsize=(8, 8))
    axes[0].plot(t, results["thrust"])
    axes[0].set_xlabel("Time (s)")
    axes[0].set_ylabel("Thrust (N)")
    axes[0].set_title("Thrust vs Time")
    axes[0].grid(True, alpha=0.3)
    axes[1].plot(t, twr)
    axes[1].set_xlabel("Time (s)")
    axes[1].set_ylabel("TWR")
    axes[1].set_title("Thrust-to-Weight Ratio vs Time")
    axes[1].grid(True, alpha=0.3)
    plt.tight_layout()
    path = os.path.join(output_dir, "thrust_twr.png")
    plt.savefig(path, dpi=150, bbox_inches="tight")
    plt.close()
    return path


def plot_exceedance(analysis: dict, metric: str = "apogee_altitude",
                    output_dir: str | None = None,
                    thresholds=None, n_points: int = 100,
                    gpd: bool = False) -> str | None:
    """Exceedance curve P(metric > t) vs t on a log-probability axis —
    the range-safety readout of ``mc.exceedance_from_analysis`` as a
    figure (beyond reference). Exact layouts get a Wilson 95% CI band;
    importance-sampled runs get a +-2 stderr band; sketch-backed
    streaming runs plot the point curve (rank-bounded, no CI by design).
    ``gpd=True`` overlays the peaks-over-threshold extrapolation
    (``mc.tail``) past the sample maximum — out to 100x below the
    empirical floor — with its bootstrap 95% band (refused on
    importance runs by ``tail_from_analysis``).
    """
    from ..mc.stats import exceedance_from_analysis

    stats = analysis.get(metric)
    if not isinstance(stats, dict) or not np.isfinite(stats.get("min", np.nan)):
        return None
    if thresholds is None:
        lo, hi = stats["min"], stats["max"]
        pad = 0.02 * max(hi - lo, 1e-9)
        thresholds = np.linspace(lo - pad, hi + pad, n_points)
    rows = exceedance_from_analysis(analysis, metric, thresholds)

    t = np.asarray([r["threshold"] for r in rows])
    p = np.asarray([r["probability"] for r in rows])
    tail = _gpd_overlay(analysis, metric, stats) if gpd else None
    plt = _pyplot("plot_exceedance")
    _, ax = plt.subplots(figsize=(9, 6))
    ax.plot(t, p, color="tab:blue", label=f"P({metric} > t)")
    if "ci95" in rows[0]:
        lo_b = np.asarray([r["ci95"][0] for r in rows])
        hi_b = np.asarray([r["ci95"][1] for r in rows])
        ax.fill_between(t, lo_b, hi_b, alpha=0.25, color="tab:blue",
                        label="Wilson 95% CI")
    elif "stderr" in rows[0]:
        se = np.asarray([r["stderr"] for r in rows])
        ax.fill_between(t, np.maximum(p - 2 * se, 0.0),
                        np.minimum(p + 2 * se, 1.0), alpha=0.25,
                        color="tab:blue", label="+-2 stderr")
    gpd_min = np.inf
    if tail is not None:
        tg, gp, ci, xi = tail
        ax.plot(tg, gp, color="tab:red", linestyle="--",
                label=f"GPD extrapolation (xi = {xi:+.2f})")
        ax.fill_between(tg, np.maximum(ci[:, 0], 1e-15), ci[:, 1], color="tab:red",
                        alpha=0.15, label="GPD bootstrap 95%")
        pos_g = gp[gp > 0]
        if pos_g.size:
            gpd_min = float(pos_g.min())
    ax.set_yscale("log")
    # Floor: show every resolved point. Importance-sampled runs estimate
    # probabilities far below 1/n (that is their purpose), so the floor
    # follows the smallest positive estimate, not the lane count.
    pos = p[p > 0]
    if pos.size:
        floor = max(min(float(pos.min()), gpd_min) * 0.3, 1e-12)
    else:
        floor = 0.1 / max(rows[0].get("n", analysis.get("n_samples", 1)), 2)
    ax.set_ylim(max(floor, 1e-12), 1.2)
    ax.set_xlabel(f"{metric.replace('_', ' ')} threshold")
    ax.set_ylabel("exceedance probability")
    ax.set_title(f"Exceedance: {metric.replace('_', ' ')} "
                 f"({rows[0]['method']})")
    ax.grid(True, alpha=0.3, which="both")
    ax.legend()
    plt.tight_layout()
    if output_dir is not None:
        path = os.path.join(output_dir, f"exceedance_{metric}.png")
        plt.savefig(path, dpi=150, bbox_inches="tight")
        plt.close()
        return path
    plt.close()
    return None


def _gpd_overlay(analysis: dict, metric: str, stats: dict):
    """``plot_exceedance``'s GPD curve: ``(thresholds, probabilities, ci95
    [m, 2], xi)`` from the sample maximum's fit out to 100x below the
    empirical floor, or None where the run has too few lanes or no per-lane
    data."""
    from ..mc.tail import tail_from_analysis

    try:
        # n_boot=0: the probe sizes the query grid; the call below bootstraps
        fit = tail_from_analysis(analysis, metric, [float(stats["max"])], n_boot=0)["fit"]
        u, xi = fit["threshold"], fit["shape_xi"]
        sig, pu = fit["scale_sigma"], fit["p_threshold"]
        p_lo = max(0.01 / fit["n_total"], 1e-12)
        if xi < -1e-9:  # a bounded tail: stop just short of its end
            t_end = u + sig / (-xi) * 0.999
        elif xi < 1e-9:
            t_end = u + sig * np.log(pu / p_lo)
        else:
            t_end = u + sig / xi * ((pu / p_lo) ** xi - 1.0)
        tg = np.linspace(u, max(t_end, u + 1e-9), 60)[1:]
        blk = tail_from_analysis(analysis, metric, tg, n_boot=200)
    except (ValueError, KeyError):
        return None
    gp = np.asarray([r["probability"] for r in blk["exceedance"]])
    ci = np.asarray([r.get("ci95", [np.nan, np.nan]) for r in blk["exceedance"]])
    return tg, gp, ci, xi


def plot_sobol_indices(indices: dict, output_dir: str | None = None,
                       metrics=None) -> str | None:
    """Variance-decomposition bars of ``mc.sobol_indices``: one panel per
    metric; per channel group a first-order bar S (the variance it explains
    alone) under a total-order bar T (its interactions included), with the
    bootstrap 95% intervals as error bars where the run carried them. A T
    bar far above its S bar marks a channel whose effect is mostly
    interaction. Runs with ``pairs`` get a row per subset below the groups:
    its pure interaction share. Estimates are drawn as returned, small
    negative excursions included."""
    groups = list(indices["groups"])
    if metrics is None:
        metrics = [m for m in ("apogee_altitude", "range", "flight_time") if m in indices]
    if not groups or not metrics:
        return None
    pairs = [p for p in indices.get("pairs", ())
             if all("second_order" in indices[m] for m in metrics)]
    # one group order for every panel: barh draws bottom-up, so ascending
    # max-T puts the dominant channels on top, the pair rows below them
    order = sorted(groups, key=lambda g: max(indices[m]["total_order"][g]["T"]
                                             for m in metrics))
    pair_order = sorted(pairs, key=lambda p: max(indices[m]["second_order"][p]["interaction"]
                                                 for m in metrics))
    y = np.arange(len(order), dtype=float) + len(pair_order)
    yp = np.arange(len(pair_order), dtype=float)
    h = 0.38
    plt = _pyplot("plot_sobol_indices")
    rows = len(order) + len(pair_order)
    _, axes = plt.subplots(1, len(metrics), figsize=(4.5 * len(metrics), 0.55 * rows + 2.2),
                           sharey=True)
    axes = np.atleast_1d(axes)

    def xerr(vals, ci):
        if any(c[0] is None for c in ci):
            return None  # an n_boot=0 run: no interval
        lo = vals - np.asarray([c[0] for c in ci], np.float64)
        hi = np.asarray([c[1] for c in ci], np.float64) - vals
        # a percentile band can exclude the estimate; error bars are >= 0
        return np.vstack([np.maximum(lo, 0.0), np.maximum(hi, 0.0)])

    for ax, m in zip(axes, metrics):
        blk = indices[m]
        s = np.asarray([blk["first_order"][g]["S"] for g in order])
        t = np.asarray([blk["total_order"][g]["T"] for g in order])
        ax.barh(y + h / 2, t, height=h, color="tab:orange", alpha=0.7,
                xerr=xerr(t, [blk["total_order"][g]["ci95"] for g in order]),
                label="total-order T")
        ax.barh(y - h / 2, s, height=h, color="tab:blue", alpha=0.7,
                xerr=xerr(s, [blk["first_order"][g]["ci95"] for g in order]),
                label="first-order S")
        if pair_order:
            i2 = np.asarray([blk["second_order"][p]["interaction"] for p in pair_order])
            ax.barh(yp, i2, height=2 * h, color="tab:green", alpha=0.7,
                    xerr=xerr(i2, [blk["second_order"][p]["ci95"] for p in pair_order]),
                    label="pair interaction S_ij")
            ax.axhline(len(pair_order) - 0.5, color="gray", linewidth=0.8, linestyle=":")
        ax.axvline(0.0, color="black", linewidth=0.8)
        ax.set_xlabel("variance share")
        ax.set_title(f"{m.replace('_', ' ')}\n(sigma = {blk['variance'] ** 0.5:.4g})")
        ax.grid(True, alpha=0.3, axis="x")
    axes[0].set_yticks(np.concatenate([yp, y]))
    axes[0].set_yticklabels([p.replace("*", " x ").replace("_", " ") for p in pair_order]
                            + [g.replace("_", " ") for g in order])
    axes[0].legend(loc="lower right")
    plt.tight_layout()
    if output_dir is not None:
        path = os.path.join(output_dir, "sobol_indices.png")
        plt.savefig(path, dpi=150, bbox_inches="tight")
        plt.close()
        return path
    plt.close()
    return None


_ENVELOPE_LABELS = {
    "altitude": "Altitude (m)",
    "speed": "Speed (m/s)",
    "mach": "Mach",
    "angle_of_attack": "Angle of attack (rad)",
    "sideslip_angle": "Sideslip (rad)",
    "stability_margin": "Stability margin (cal)",
    "drag": "Drag (N)",
    "thrust": "Thrust (N)",
}


def plot_flight_envelope(envelope: dict, output_dir: str | None = None,
                         channels=None) -> str | None:
    """Population flight-envelope bands vs time-since-rail-exit (beyond
    reference — the figure form of ``MonteCarloAnalyzer.flight_envelope``).

    One panel per channel: median line, interquartile band, 5-95% band,
    and the exact min/max extremes as dotted envelope lines. The x-axis
    ends at the last bin any lane was still flying. The reference's
    trajectory-cloud overlays (`monte_carlo.py:562-707`) show a handful of
    individual lanes; this shows the population.
    """
    if channels is None:
        channels = list(envelope["channels"])
    channels = [c for c in channels if c in envelope["channels"]]
    if not channels:
        return None
    t = np.asarray(envelope["time"], np.float64)
    ncol = 2 if len(channels) > 1 else 1
    nrow = (len(channels) + ncol - 1) // ncol
    plt = _pyplot("plot_flight_envelope")
    fig, axes = plt.subplots(nrow, ncol, figsize=(6.5 * ncol, 2.9 * nrow),
                             sharex=True, squeeze=False)
    last = 0
    for ax, ch in zip(axes.ravel(), channels):
        blk = envelope["channels"][ch]
        n = np.asarray(blk["n"])
        live = n > 0
        if live.any():
            last = max(last, int(np.nonzero(live)[0][-1]))
        p = {q: np.asarray(blk["percentiles"].get(q, [np.nan] * t.size))
             for q in ("5", "25", "50", "75", "95")}
        ax.fill_between(t, p["5"], p["95"], color="tab:blue", alpha=0.18,
                        label="5-95%")
        ax.fill_between(t, p["25"], p["75"], color="tab:blue", alpha=0.35,
                        label="25-75%")
        ax.plot(t, p["50"], color="tab:blue", linewidth=1.4, label="median")
        ax.plot(t, blk["min"], color="gray", linewidth=0.8, linestyle=":",
                label="min/max")
        ax.plot(t, blk["max"], color="gray", linewidth=0.8, linestyle=":")
        ax.set_ylabel(_ENVELOPE_LABELS.get(ch, ch.replace("_", " ")))
        ax.grid(True, alpha=0.3)
    for ax in axes.ravel()[len(channels):]:
        ax.set_visible(False)
    for ax in axes[-1, :]:
        ax.set_xlabel("Time since rail exit (s)")
    if last:
        for ax in axes.ravel()[:len(channels)]:
            ax.set_xlim(0.0, t[min(last + 1, t.size - 1)])
    axes[0, 0].legend(loc="best", fontsize=8)
    fig.suptitle(
        f"Flight envelope — {envelope['n_lanes']} lanes, "
        f"{envelope['bin_dt']:g} s bins"
    )
    plt.tight_layout()
    if output_dir is not None:
        path = os.path.join(output_dir, "flight_envelope.png")
        plt.savefig(path, dpi=150, bbox_inches="tight")
        plt.close()
        return path
    plt.close()
    return None


def plot_launch_window(sweep: dict, output_dir: str | None = None) -> str | None:
    """Go/no-go launch-window map (beyond reference — the figure form of
    ``cli.launch_window``): one heatmap per configured limit, wind
    direction x ground wind speed, cell color = exceedance probability,
    with GO cells (Wilson-95 upper bound within p_limit) marked. Purely
    descriptive sweeps (no limits) fall back to a range-p95 heatmap.
    """
    speeds = list(sweep["speeds"])
    dirs = list(sweep["directions_deg"])
    rows = sweep["candidates"]
    if not rows:
        return None
    panels = [k for k in ("p_range_exceed", "p_apogee_exceed")
              if k in rows[0]]
    titles = {"range_p95": "range p95 (m)"}
    if "p_range_exceed" in panels:
        titles["p_range_exceed"] = \
            f"P(range > {sweep['limits']['range_limit']:g} m)"
    if "p_apogee_exceed" in panels:
        titles["p_apogee_exceed"] = \
            f"P(apogee > {sweep['limits']['apogee_ceiling']:g} m)"
    fallback = not panels
    if fallback:
        panels = ["range_p95"]

    def grid(getter):
        g = np.full((len(speeds), len(dirs)), np.nan)
        for r in rows:
            i = speeds.index(r["wind_speed"])
            j = dirs.index(r["wind_direction_deg"])
            g[i, j] = getter(r)
        return g

    plt = _pyplot("plot_launch_window")
    fig, axes = plt.subplots(1, len(panels),
                             figsize=(1.1 * len(dirs) + 3.5, 
                                      0.8 * len(speeds) + 2.0),
                             squeeze=False)
    p_limit = sweep["limits"]["p_limit"]
    for ax, key in zip(axes[0], panels):
        if fallback:
            g = grid(lambda r: r["range_p95"])
            im = ax.imshow(g, aspect="auto", origin="lower",
                           cmap="viridis")
        else:
            g = grid(lambda r: r[key]["probability"])
            im = ax.imshow(g, aspect="auto", origin="lower",
                           cmap="YlOrRd", vmin=0.0,
                           vmax=max(3 * p_limit, np.nanmax(g), 1e-9))
        fig.colorbar(im, ax=ax, shrink=0.85)
        for r in rows:
            i = speeds.index(r["wind_speed"])
            j = dirs.index(r["wind_direction_deg"])
            if r.get("go") is True:
                ax.plot(j, i, marker="o", markersize=10, fillstyle="none",
                        color="tab:green", markeredgewidth=2)
            elif r.get("go") is False:
                ax.plot(j, i, marker="x", markersize=9, color="black")
        ax.set_xticks(range(len(dirs)))
        ax.set_xticklabels([f"{d:g}" for d in dirs])
        ax.set_yticks(range(len(speeds)))
        ax.set_yticklabels([f"{s:g}" for s in speeds])
        ax.set_xlabel("Wind direction (deg from +x)")
        ax.set_ylabel("Ground wind speed (m/s)")
        ax.set_title(titles[key])
    if not fallback:
        fig.suptitle(
            f"Launch window — GO (circle) iff Wilson-95 upper bound "
            f"<= {p_limit:g}; {sweep['n_per_candidate']} lanes/candidate"
        )
    plt.tight_layout()
    if output_dir is not None:
        path = os.path.join(output_dir, "launch_window.png")
        plt.savefig(path, dpi=150, bbox_inches="tight")
        plt.close()
        return path
    plt.close()
    return None


def plot_convergence(analysis: dict, output_dir: str | None = None) -> str | None:
    """Running-mean convergence diagnostic (beyond reference): per headline
    metric, the running mean with its +-1.96-stderr band vs lanes folded in
    (log x), from the per-slab history ``analysis["convergence"]`` that
    every slabbed run records. The classic "has this Monte Carlo
    converged" picture that a fixed-n run cannot show.
    Single-call runs (no slab boundaries) return None. The band treats
    valid lanes as i.i.d. — under ``sampler="sobol"``/``antithetic`` the
    true error is smaller and the band conservative.
    """
    hist = analysis.get("convergence")
    if not hist or len(hist) < 2:
        return None
    metrics = (("apogee_altitude", "Apogee Altitude (m)"),
               ("range", "Range (m)"),
               ("flight_time", "Flight Time (s)"))
    n = np.asarray([row["n_valid"] for row in hist], np.float64)
    plt = _pyplot("plot_convergence")
    fig, axes = plt.subplots(1, 3, figsize=(16, 5))
    for ax, (key, label) in zip(axes, metrics):
        mean = np.asarray([row[key]["mean"] for row in hist])
        se = np.asarray([row[key]["stderr"] for row in hist])
        ax.plot(n, mean, color="tab:blue", label="running mean")
        ax.fill_between(n, mean - 1.96 * se, mean + 1.96 * se,
                        alpha=0.25, color="tab:blue", label="95% CI")
        ax.axhline(mean[-1], color="tab:gray", linestyle="--",
                   linewidth=1, label="final mean")
        ax.set_xscale("log")
        ax.set_xlabel("valid lanes folded in")
        ax.set_ylabel(label)
        ax.grid(True, alpha=0.3)
        ax.legend(fontsize=8)
    fig.suptitle("Monte Carlo convergence (running mean, per-slab history)")
    plt.tight_layout()
    if output_dir:
        path = os.path.join(output_dir, "convergence.png")
        plt.savefig(path, dpi=150, bbox_inches="tight")
        plt.close()
        return path
    plt.close()
    return None
