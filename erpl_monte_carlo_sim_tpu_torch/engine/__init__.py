"""Flight engine of the PyTorch port."""

from .batch import (prepare_batch, simulate_envelope_batch, simulate_flight_batch,
                    simulate_summary_batch)
from .component import (derived_c, flight_components, flight_components_envelope,
                        flight_components_trajectory)
from .config import SimConfig
from .diff import apogee_and_grad, metric_and_grad, simulate_apogee_diff, simulate_metrics_diff
from .rail import RailInfo
from .simulate import FlightSummary, Trajectory
from .state import InitialConditions

__all__ = ["prepare_batch", "simulate_summary_batch", "simulate_flight_batch",
           "simulate_envelope_batch", "flight_components", "flight_components_trajectory",
           "flight_components_envelope", "derived_c", "SimConfig", "RailInfo",
           "FlightSummary", "Trajectory", "InitialConditions", "apogee_and_grad",
           "metric_and_grad", "simulate_apogee_diff", "simulate_metrics_diff"]
