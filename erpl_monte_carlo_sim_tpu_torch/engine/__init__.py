"""Flight engine of the PyTorch port: the rail phase, 6DOF RK4 integration
and masked events, as the stacked-vector single-flight engine
(``simulate_summary``, ``simulate_flight``, ``simulate_batch_chunked``) and
the batched component core (``simulate_summary_batch`` and its kin)."""

from .batch import (prepare_batch, simulate_envelope_batch, simulate_flight_batch,
                    simulate_summary_batch)
from .component import (derived_c, flight_components, flight_components_envelope,
                        flight_components_trajectory)
from .config import SimConfig
from .diff import apogee_and_grad, metric_and_grad, simulate_apogee_diff, simulate_metrics_diff
from .dynamics import rocket_dynamics
from .integrator import EventState, StepCarry, advance, init_carry, rk4_step
from .rail import RailInfo, simulate_rail
from .simulate import (FlightSummary, Trajectory, simulate_batch_chunked, simulate_flight,
                       simulate_summary)
from .state import FlightState, InitialConditions, initial_state

__all__ = ["prepare_batch", "simulate_summary_batch", "simulate_flight_batch",
           "simulate_envelope_batch", "flight_components", "flight_components_trajectory",
           "flight_components_envelope", "derived_c", "SimConfig", "RailInfo",
           "FlightSummary", "Trajectory", "InitialConditions", "apogee_and_grad",
           "metric_and_grad", "simulate_apogee_diff", "simulate_metrics_diff",
           "rocket_dynamics", "EventState", "StepCarry", "advance", "init_carry", "rk4_step",
           "simulate_rail", "simulate_summary", "simulate_flight", "simulate_batch_chunked",
           "FlightState", "initial_state"]
