"""Flight engine of the PyTorch port."""

from .batch import prepare_batch, simulate_summary_batch
from .component import flight_components
from .config import SimConfig, require_parity_flags
from .rail import RailInfo
from .simulate import FlightSummary
from .state import InitialConditions

__all__ = ["prepare_batch", "simulate_summary_batch", "flight_components",
           "SimConfig", "require_parity_flags", "RailInfo", "FlightSummary",
           "InitialConditions"]
