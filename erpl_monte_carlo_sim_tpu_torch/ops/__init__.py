"""Math primitives of the PyTorch port."""

from .frames import GAMMA_AIR, R_AIR
from .interp import interpolate_1d, interpolate_vec, tent_weights
from .math import arcsin, arctan2, safe_sqrt
from .quaternion import euler_to_quaternion, normalize_quaternion, quaternion_to_euler

__all__ = [
    "GAMMA_AIR", "R_AIR", "interpolate_1d", "interpolate_vec", "tent_weights",
    "arcsin", "arctan2", "safe_sqrt", "euler_to_quaternion",
    "normalize_quaternion", "quaternion_to_euler",
]
