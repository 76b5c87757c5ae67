"""Math primitives of the PyTorch port."""

from .frames import (GAMMA_AIR, R_AIR, angle_of_attack, mach_number, sideslip_angle,
                     wind_to_body_matrix)
from .interp import interpolate_1d, interpolate_vec, tent_weights
from .math import arcsin, arctan2, safe_norm, safe_sqrt
from .quaternion import (angular_velocity_to_quaternion_rate, euler_to_quaternion,
                         normalize_quaternion, quaternion_multiply, quaternion_to_euler,
                         quaternion_to_rotation_matrix, rotate_by_matrix, rotate_by_matrix_t)

__all__ = [
    "GAMMA_AIR", "R_AIR", "angle_of_attack", "mach_number", "sideslip_angle",
    "wind_to_body_matrix", "interpolate_1d", "interpolate_vec", "tent_weights",
    "arcsin", "arctan2", "safe_norm", "safe_sqrt", "angular_velocity_to_quaternion_rate",
    "euler_to_quaternion", "normalize_quaternion", "quaternion_multiply",
    "quaternion_to_euler", "quaternion_to_rotation_matrix", "rotate_by_matrix",
    "rotate_by_matrix_t",
]
