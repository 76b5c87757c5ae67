"""First-order metric sensitivities and variance budgets by reverse passes
(``erpl_monte_carlo_sim_tpu/cli/sensitivity.py``).

One reverse pass through the differentiable flight (``engine.diff``) gives a
metric's derivative with respect to every dispersion channel at once;
pairing each with the channel's sigma gives the linearized variance budget

    sigma_metric^2  ~=  sum_i (d metric / d c_i)^2 * sigma_i^2.

Each channel perturbs the scene as ``mc.sample_dispersions`` does (mass
scales dry and propellant mass; the motor's burn time follows; the mass
flow follows the thrust for a solid motor and has its own multiplier for a
liquid one; density multiplies ``density_scale``), so the linearization is
of the map the Monte Carlo samples. ``--sobol`` gives the variance-based
Sobol' indices instead (``mc.sobol_indices``). Runs on the card unless
``--device cpu`` asks for the CPU. Prints one JSON object.

Usage:
  python -m erpl_monte_carlo_sim_tpu_torch.cli.sensitivity [max_time] [--solid] \\
      [--sobol [n_lanes]] [--device cuda]
"""

from __future__ import annotations

import dataclasses
import json
import math
import sys

import torch

from ..engine import InitialConditions, SimConfig
from ..engine.diff import DIFF_METRICS, gradients, simulate_metrics_diff
from ..mc.dispersions import UncertaintyParams

__all__ = ["CHANNELS", "metric_sensitivities", "apogee_sensitivities", "variance_budget", "main"]

# the differentiated channels, in report order: multipliers at 1, offsets at 0
CHANNELS = ("mass_multiplier", "thrust_multiplier", "flow_multiplier", "density_multiplier",
            "pitch_offset", "wind_u_offset")


def _perturbed_scene(scene, ic, c: dict):
    """``(scene, ic)`` with one value per channel applied as
    ``mc.sample_dispersions`` applies its draws. A channel may be a scalar,
    or ``[B]`` (one value a lane), which makes the scene a batch."""
    rocket = dataclasses.replace(scene.rocket,
                                 dry_mass=scene.rocket.dry_mass * c["mass_multiplier"],
                                 propellant_mass=scene.rocket.propellant_mass
                                 * c["mass_multiplier"])
    mdot_mult = (c["thrust_multiplier"] if scene.motor.mdot_follows_thrust
                 else c["flow_multiplier"])
    new_prop = scene.rocket.propellant_mass * c["mass_multiplier"]
    new_mdot = scene.motor.mass_flow_rate * mdot_mult
    motor = dataclasses.replace(scene.motor,
                                thrust_scale=scene.motor.thrust_scale * c["thrust_multiplier"],
                                mass_flow_rate=new_mdot, propellant_mass=new_prop,
                                burn_time=new_prop / new_mdot)
    atmosphere = dataclasses.replace(
        scene.atmosphere, density_scale=scene.atmosphere.density_scale * c["density_multiplier"])
    u = c["wind_u_offset"]
    zero = torch.zeros_like(u)
    # [..., 1, 3]: a scalar offset keeps the table's shape, [B] makes it per lane
    offset = torch.stack([u, zero, zero], dim=-1)[..., None, :]
    wind = dataclasses.replace(scene.wind, wind=scene.wind.wind + offset)
    pitch = c["pitch_offset"]
    att = ic.attitude + torch.stack([torch.zeros_like(pitch), pitch, torch.zeros_like(pitch)],
                                    dim=-1)
    ic2 = dataclasses.replace(ic, attitude=att)
    return dataclasses.replace(scene, rocket=rocket, motor=motor, atmosphere=atmosphere,
                               wind=wind), ic2


def metric_sensitivities(scene, ic, cfg: SimConfig = None, metric: str = "apogee_altitude",
                         **kw) -> tuple:
    """``(metric, {channel: d metric / d channel})`` of a single flight, every
    channel from one reverse pass. ``metric`` is one of ``DIFF_METRICS``;
    ``kw`` go to ``simulate_metrics_diff``."""
    cfg = cfg or SimConfig(max_time=120.0)
    if metric not in DIFF_METRICS:
        raise ValueError(f"metric must be one of {DIFF_METRICS}, got {metric!r}")
    ref = scene.rocket.dry_mass
    c = {k: torch.tensor(1.0 if k.endswith("multiplier") else 0.0, dtype=ref.dtype,
                         device=ref.device, requires_grad=True) for k in CHANNELS}
    with torch.enable_grad():
        s2, ic2 = _perturbed_scene(scene, ic, c)
        value = simulate_metrics_diff(s2, ic2, cfg, **kw)[metric]
        grads = gradients(value, list(c.values()))
    return value.detach(), dict(zip(CHANNELS, grads))


def apogee_sensitivities(scene, ic, cfg: SimConfig = None, **kw) -> tuple:
    """``(apogee, {channel: d apogee / d channel})`` in one reverse pass."""
    return metric_sensitivities(scene, ic, cfg, metric="apogee_altitude", **kw)


def _channel_sigmas(scene, params: UncertaintyParams) -> dict:
    """Each channel's dispersion sigma as the Monte Carlo draws it. The
    wind's u offset is ``S cos(theta)`` of a uniform speed on ``[a, b]`` and a
    uniform direction on ``[d0, d1]`` (width ``W``): ``Var(u) = E[S^2]
    E[cos^2] - (E[S] E[cos])^2`` with ``E[S] = (a + b) / 2``, ``E[S^2] = (a^2
    + ab + b^2) / 3``, ``E[cos] = (sin d1 - sin d0) / W`` and ``E[cos^2] = 1/2
    + (sin 2d1 - sin 2d0) / (4W)``; the full circle gives ``sqrt(E[S^2] /
    2)``."""
    a, b = params.wind_speed_range
    d0, d1 = params.wind_direction_range
    w = max(d1 - d0, 1e-12)
    e_s = 0.5 * (a + b)
    e_s2 = (a * a + a * b + b * b) / 3.0
    e_c = (math.sin(d1) - math.sin(d0)) / w
    e_c2 = 0.5 + (math.sin(2 * d1) - math.sin(2 * d0)) / (4.0 * w)
    return {
        "mass_multiplier": float(params.mass_uncertainty),
        # the motor's own thrust sigma acts (the analyzer's is recorded only)
        "thrust_multiplier": float(scene.motor.thrust_uncertainty),
        "flow_multiplier": (0.0 if scene.motor.mdot_follows_thrust
                            else float(scene.motor.mass_flow_uncertainty)),
        "density_multiplier": float(params.atmospheric_density_uncertainty),
        "pitch_offset": float(params.initial_attitude[1]),
        "wind_u_offset": float(math.sqrt(max(e_s2 * e_c2 - (e_s * e_c) ** 2, 0.0))),
    }


def variance_budget(scene, ic, cfg: SimConfig = None,
                    params: UncertaintyParams = UncertaintyParams(),
                    metric: str = "apogee_altitude", **kw) -> dict:
    """The linearized variance budget of one metric over the channels:
    ``{"metric", "channels": {name: {"gradient", "sigma", contribution}},
    value, first-order sigma}``, under the JAX package's keys (the apogee's
    ``apogee_m``, ``apogee_sigma_contribution_m`` and
    ``apogee_sigma_first_order_m``; ``value``, ``sigma_contribution`` and
    ``sigma_first_order`` for the other metrics). First order only: the
    AR(1) turbulence and the initial-condition offsets other than pitch are
    left out."""
    value, grads = metric_sensitivities(scene, ic, cfg, metric=metric, **kw)
    sigmas = _channel_sigmas(scene, params)
    legacy = metric == "apogee_altitude"
    k_contrib = "apogee_sigma_contribution_m" if legacy else "sigma_contribution"
    channels, total_var = {}, 0.0
    for name in CHANNELS:
        g = float(grads[name])
        s = sigmas[name]
        contrib = abs(g) * s
        total_var += contrib * contrib
        channels[name] = {"gradient": g, "sigma": s, k_contrib: contrib}
    out = {"metric": metric, "channels": channels}
    if legacy:
        out["apogee_m"] = float(value)
        out["apogee_sigma_first_order_m"] = math.sqrt(total_var)
    else:
        out["value"] = float(value)
        out["sigma_first_order"] = math.sqrt(total_var)
    return out


def main(argv=None) -> dict:
    argv = list(sys.argv[1:] if argv is None else argv)
    from ..models import liquid_motor, nominal_scene, solid_motor

    device = "cuda"
    if "--device" in argv:
        i = argv.index("--device")
        device = argv[i + 1]
        del argv[i:i + 2]
    max_time = float(argv[0]) if argv and not argv[0].startswith("-") else 120.0
    motor = solid_motor(device) if "--solid" in argv else liquid_motor(device)
    scene = nominal_scene(motor)
    ic = InitialConditions.vertical_launch(device)
    cfg = SimConfig(max_time=max_time)
    if "--sobol" in argv:
        from ..mc.sobol_indices import sobol_indices

        i = argv.index("--sobol")
        n = (int(argv[i + 1]) if i + 1 < len(argv) and not argv[i + 1].startswith("-")
             else 1024)
        out = sobol_indices(scene, ic, cfg, n=n, n_boot=200)
    else:
        out = {m: variance_budget(scene, ic, cfg, metric=m)
               for m in ("apogee_altitude", "range", "flight_time")}
    print(json.dumps(out, indent=2))
    return out


if __name__ == "__main__":
    main()
