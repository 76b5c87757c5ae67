"""Physical models of the PyTorch port."""

from .atmosphere import AtmosphereParams, AtmosProperties, atmosphere_properties, gravity_at
from .motor import (MotorParams, liquid_motor, mass_flow_rate_at,
                    propellant_remaining, solid_motor, thrust_at)
from .rocket import (AeroCoefficients, MassProperties, RocketParams,
                     aero_coefficients, barrowman_cp, dynamic_cp, mass_properties,
                     stability_margin)
from .scene import Scene, nominal_scene
from .wind import (WindField, WindModelParams, generate_stochastic_profile,
                   perturb_wind_profile, power_law_profile)

__all__ = [
    "AtmosphereParams", "AtmosProperties", "atmosphere_properties", "gravity_at",
    "MotorParams", "liquid_motor", "mass_flow_rate_at", "propellant_remaining",
    "solid_motor", "thrust_at", "AeroCoefficients", "MassProperties",
    "RocketParams", "aero_coefficients", "barrowman_cp", "dynamic_cp",
    "mass_properties", "stability_margin", "Scene", "nominal_scene",
    "WindField", "WindModelParams", "generate_stochastic_profile",
    "perturb_wind_profile", "power_law_profile",
]
