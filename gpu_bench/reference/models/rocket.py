"""Vehicle geometry, mass properties and aerodynamics
(``erpl_monte_carlo_sim_tpu/models/rocket.py``).

Quirks kept from the JAX package: ``Izz`` mirrors ``Iyy``; the pitch moment
``cm`` and ``cyaw`` are not stall-limited unless ``stall_limited_moments``
asks for it; the Barrowman static CP is computed once, in plain Python, when
the parameters are created. ``refresh_derived`` recomputes the derived
geometry in tensors (``barrowman_cp_traced``), so that a design gradient
(``engine.diff``) carries the CP travel.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import torch

from ..ops.interp import interpolate_1d
from ..utils.tree import materialize, static_field

__all__ = ["RocketParams", "MassProperties", "AeroCoefficients", "barrowman_cp",
           "barrowman_cp_traced", "refresh_derived", "mass_properties", "dynamic_cp", "aero_coefficients",
           "stability_margin", "STALL_ANGLE", "MAX_ANGLE"]

_CD_MACH = (0.0, 0.5, 0.8, 1.0, 1.2, 1.5, 2.0, 3.0)
_CD0 = (0.4, 0.42, 0.48, 0.65, 0.52, 0.45, 0.40, 0.38)
_CDA = (1.2, 1.25, 1.3, 1.4, 1.35, 1.25, 1.2, 1.15)
_CP_SHIFT_MACH = (0.0, 0.8, 1.0, 1.2, 2.0, 3.0)
_CP_SHIFT = (0.0, -0.05, -0.1, -0.05, 0.0, 0.0)

STALL_ANGLE = math.radians(15.0)
MAX_ANGLE = math.radians(45.0)


@dataclasses.dataclass(frozen=True)
class RocketParams:
    name: str = static_field("Sounding Rocket")
    length: torch.Tensor = 7.62
    diameter: torch.Tensor = 0.219
    nose_length: torch.Tensor = 0.2
    fin_span: torch.Tensor = 0.2
    fin_root_chord: torch.Tensor = 0.20
    fin_tip_chord: torch.Tensor = 0.1
    fin_count: torch.Tensor = 4.0
    fin_sweep_angle: torch.Tensor = 0.0
    fin_cant_angle: torch.Tensor = 0.0
    dry_mass: torch.Tensor = 113.4
    propellant_mass: torch.Tensor = 63.5
    center_of_mass_dry: torch.Tensor = 5.8
    Ixx_dry: torch.Tensor = 45.0
    Iyy_dry: torch.Tensor = 971.9
    Izz_dry: torch.Tensor = 971.693  # schema parity; Izz := Iyy in the physics
    reference_area: torch.Tensor = math.pi * (0.219 / 2) ** 2
    reference_diameter: torch.Tensor = 0.219
    cd_mach: torch.Tensor = _CD_MACH
    cd0_table: torch.Tensor = _CD0
    cda_table: torch.Tensor = _CDA
    cp_shift_mach: torch.Tensor = _CP_SHIFT_MACH
    cp_shift_table: torch.Tensor = _CP_SHIFT
    cp_location: torch.Tensor = 0.0
    parachute_area: torch.Tensor = 15.0
    parachute_cd: torch.Tensor = 2.0
    parachute_deployment_altitude: torch.Tensor = 500.0
    power_off_drag_factor: torch.Tensor = 1.2
    stall_limited_moments: bool = static_field(False)

    @classmethod
    def create(cls, device, dtype=None, **overrides) -> "RocketParams":
        """Parameters with the derived fields (reference area, Barrowman CP)."""
        params = cls(**overrides)
        d = float(params.diameter)
        params = dataclasses.replace(params, reference_area=math.pi * (d / 2) ** 2,
                                     reference_diameter=d)
        params = dataclasses.replace(params, cp_location=barrowman_cp(params))
        return materialize(params, device, dtype)


def barrowman_cp(p: RocketParams) -> float:
    """Barrowman static center of pressure (host Python): nose CN = 2 at
    0.666 nose lengths, trapezoidal fins at quarter-MAC."""
    cn_nose = 2.0
    x_nose = 0.666 * float(p.nose_length)
    cr = float(p.fin_root_chord)
    ct = float(p.fin_tip_chord)
    s = float(p.fin_span)
    sweep = float(p.fin_sweep_angle)
    n = float(p.fin_count)
    diameter = float(p.diameter)
    ref_area = float(p.reference_area)
    length = float(p.length)

    fin_area = 0.5 * (cr + ct) * s
    lam = ct / cr if cr != 0 else 0.0
    cn_fins = 2.0 * n * (1.0 + diameter / (2.0 * s)) * (fin_area / ref_area)
    mac = (2.0 / 3.0) * cr * (1.0 + lam + lam**2) / (1.0 + lam)
    y_bar = s * (1.0 + 2.0 * lam) / (3.0 * (1.0 + lam))
    x_fins = (length - cr) + y_bar * math.tan(sweep) + 0.25 * mac
    cn_total = cn_nose + cn_fins
    if cn_total > 0:
        return (cn_nose * x_nose + cn_fins * x_fins) / cn_total
    return length / 2.0


def barrowman_cp_traced(p: RocketParams) -> torch.Tensor:
    """``barrowman_cp`` in tensor operations, so that gradients flow through
    the CP. The branches become double-where guards: a zero root chord
    takes taper 0, and a zero fin span takes ``length / 2`` (where the host
    version divides by zero) with a finite gradient."""
    x_nose = 0.666 * p.nose_length
    cr, ct, s = p.fin_root_chord, p.fin_tip_chord, p.fin_span
    n, diameter, ref_area, length = p.fin_count, p.diameter, p.reference_area, p.length
    fin_area = 0.5 * (cr + ct) * s
    cr_ok = cr != 0
    lam = torch.where(cr_ok, ct / torch.where(cr_ok, cr, 1.0), 0.0)
    s_ok = s > 0
    cn_fins = torch.where(
        s_ok, 2.0 * n * (1.0 + diameter / (2.0 * torch.where(s_ok, s, 1.0)))
        * (fin_area / ref_area), 0.0)
    mac = (2.0 / 3.0) * cr * (1.0 + lam + lam**2) / (1.0 + lam)
    y_bar = s * (1.0 + 2.0 * lam) / (3.0 * (1.0 + lam))
    x_fins = (length - cr) + y_bar * torch.tan(p.fin_sweep_angle) + 0.25 * mac
    cn_total = 2.0 + cn_fins
    pos = cn_total > 0
    cp = torch.where(pos, (2.0 * x_nose + cn_fins * x_fins) / torch.where(pos, cn_total, 1.0),
                     length / 2.0)
    return torch.where(s_ok, cp, length / 2.0)


def refresh_derived(p: RocketParams) -> RocketParams:
    """``p`` with the derived geometry (reference area and diameter, the
    Barrowman CP) recomputed from the primary fields in tensors. ``create``
    computes them once on the host; a design write (``engine.diff``,
    ``mc.robust``) refreshes them so that its gradient carries the CP
    travel and the stability margin, not only the lift terms."""
    d = p.diameter
    p = dataclasses.replace(p, reference_area=math.pi * (d / 2.0) ** 2, reference_diameter=d)
    return dataclasses.replace(p, cp_location=barrowman_cp_traced(p))


class MassProperties(NamedTuple):
    mass: torch.Tensor
    center_of_mass: torch.Tensor
    Ixx: torch.Tensor
    Iyy: torch.Tensor
    Izz: torch.Tensor


def mass_properties(p: RocketParams, propellant_fraction) -> MassProperties:
    """Mass, CG and inertia from the propellant fraction: propellant CG 0.5 m
    forward of the dry CG, a 2 m slab propellant column, Izz := Iyy."""
    current_prop = p.propellant_mass * propellant_fraction
    total_mass = p.dry_mass + current_prop
    prop_cg = p.center_of_mass_dry - 0.5
    cg = (p.dry_mass * p.center_of_mass_dry + current_prop * prop_cg) / total_mass
    r = p.diameter / 4.0
    dcg = prop_cg - cg
    prop_ixx = current_prop * (r * r)
    prop_iyy = current_prop * (2.0**2 / 12.0 + dcg * dcg)
    ixx = p.Ixx_dry + prop_ixx
    iyy = p.Iyy_dry + prop_iyy
    return MassProperties(total_mass, cg, ixx, iyy, iyy)


def dynamic_cp(p: RocketParams, mach) -> torch.Tensor:
    """Mach-shifted center of pressure."""
    return p.cp_location + interpolate_1d(mach, p.cp_shift_mach, p.cp_shift_table)


def stability_margin(p: RocketParams, propellant_fraction) -> torch.Tensor:
    """Static margin in calibers, from the static (Mach-0) CP."""
    mp = mass_properties(p, propellant_fraction)
    return (p.cp_location - mp.center_of_mass) / p.reference_diameter


class AeroCoefficients(NamedTuple):
    cd: torch.Tensor
    cl: torch.Tensor
    cm: torch.Tensor
    cp: torch.Tensor
    cn: torch.Tensor
    cy: torch.Tensor
    croll: torch.Tensor
    cpitch: torch.Tensor
    cyaw: torch.Tensor


def aero_coefficients(p: RocketParams, mach, alpha, beta=0.0,
                      center_of_mass=None, power_on=True) -> AeroCoefficients:
    """Coefficient build-up: Cd0/CdA Mach tables with quadratic-alpha drag,
    x power_off_drag_factor when unpowered, finite-wing lift slope with
    compressibility and sweep, 15 -> 45 deg stall taper on cl/cy/cn, moments
    from the dynamic-CP static margin. With ``p.stall_limited_moments`` the
    moments saturate at their stall-onset value and taper with the stall
    factor: ``cm`` on alpha, ``cyaw`` on its own beta factor."""
    like = p.cd_mach
    mach = torch.as_tensor(mach, dtype=like.dtype, device=like.device)
    alpha = torch.as_tensor(alpha, dtype=like.dtype, device=like.device)
    beta = torch.as_tensor(beta, dtype=like.dtype, device=like.device)
    if center_of_mass is None:
        center_of_mass = p.center_of_mass_dry

    cd0 = interpolate_1d(mach, p.cd_mach, p.cd0_table)
    cda = interpolate_1d(mach, p.cd_mach, p.cda_table)
    cd = cd0 + cda * (alpha * alpha)
    cd = torch.where(torch.as_tensor(power_on, device=like.device), cd,
                     cd * p.power_off_drag_factor)

    abs_alpha = torch.abs(alpha)
    stalled = abs_alpha > STALL_ANGLE
    stall_factor = torch.clamp_min(
        1.0 - (abs_alpha - STALL_ANGLE) / (MAX_ANGLE - STALL_ANGLE), 0.0)

    cr = p.fin_root_chord
    ct = p.fin_tip_chord
    s = p.fin_span
    fin_area = 0.5 * (cr + ct) * s
    aspect_ratio = 2.0 * (s * s) / fin_area
    beta_m = torch.sqrt(torch.abs(1.0 - mach * mach))
    cos_sweep = torch.cos(p.fin_sweep_angle)
    k = aspect_ratio * beta_m / torch.clamp_min(cos_sweep, 1e-6)
    denom = 2.0 + torch.sqrt(4.0 + k * k)
    cl_alpha = (2.0 * math.pi * aspect_ratio / denom) * cos_sweep

    cl_linear = cl_alpha * alpha
    cl_stalled = cl_alpha * STALL_ANGLE * stall_factor * torch.sign(alpha)
    cl = torch.where(stalled, cl_stalled, cl_linear)
    cd = torch.where(
        stalled,
        cd * (1.0 + 0.5 * (abs_alpha - STALL_ANGLE) / (MAX_ANGLE - STALL_ANGLE)),
        cd,
    )

    cp_current = dynamic_cp(p, mach)
    sm = cp_current - center_of_mass
    cm = -cl_alpha * sm * alpha
    cy = torch.where(stalled, cl_alpha * beta * stall_factor, cl_alpha * beta)
    cn = torch.where(stalled, cl_stalled, cl_alpha * alpha)
    cyaw = -cl_alpha * sm * beta
    if p.stall_limited_moments:
        cm_sat = -cl_alpha * sm * STALL_ANGLE * stall_factor * torch.sign(alpha)
        cm = torch.where(stalled, cm_sat, cm)
        abs_beta = torch.abs(beta)
        beta_sf = torch.clamp_min(
            1.0 - (abs_beta - STALL_ANGLE) / (MAX_ANGLE - STALL_ANGLE), 0.0)
        cyaw_sat = -cl_alpha * sm * STALL_ANGLE * beta_sf * torch.sign(beta)
        cyaw = torch.where(abs_beta > STALL_ANGLE, cyaw_sat, cyaw)
    zero = torch.zeros_like(cd)
    return AeroCoefficients(cd=cd, cl=cl, cm=cm, cp=cp_current, cn=cn, cy=cy,
                            croll=zero, cpitch=cm, cyaw=cyaw)
