"""The README's capstone runs on one card, the counterparts of the JAX
package's ``scripts/million_flights.py``, ``scripts/full_flights.py`` and
``scripts/hundred_million_flights.py``, one module each:

- ``million_flights [--fast]``: 1,048,576 dispersed flights of the 6 s
  window in two calls, sampling included;
- ``full_flights [--rk2]``: 1,048,576 stabilized flights to landing in four
  slabs, with the two-level bias correction of the means;
- ``hundred_million_flights [--fast]``: 100,000,000 flights through
  ``MonteCarloAnalyzer.run_monte_carlo``'s slab loop, streaming and
  checkpointed.

Run one with ``python -m erpl_monte_carlo_sim_tpu_torch.capstones.<name>
[flag] [--device cpu]``; it prints the JSON line of its script (values
unrounded; ``device`` names where it ran). Each module's ``run(...)`` takes
the script's constants as keyword arguments, so tests can call it small.
The runs are on the card unless ``device="cpu"`` asks for the CPU; a card
asked for and missing raises. Every wall is read after a readback of the
results, so it covers the device's work.
"""

from __future__ import annotations

import argparse
import json

import torch

__all__ = ["card_or_cpu", "device_name", "parse_args", "print_result"]


def card_or_cpu(device) -> torch.device:
    """``device`` as a ``torch.device``: a CUDA device that exists, or the
    CPU. A card that is asked for and missing raises; nothing falls back."""
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {device} was asked for and no CUDA device is "
                               "available; pass --device cpu (device='cpu') to run on the CPU")
        return device
    if device.type != "cpu":
        raise ValueError(f"the capstones run on cuda or cpu, not {device}")
    return device


def device_name(device: torch.device) -> str:
    """The name of the device a run used: the card's, or ``cpu``."""
    return torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"


def parse_args(prog: str, description: str, flag: str, flag_help: str, argv=None):
    """The capstones' command line: the script's one flag and ``--device``."""
    p = argparse.ArgumentParser(prog=f"python -m erpl_monte_carlo_sim_tpu_torch.capstones.{prog}",
                                description=description)
    p.add_argument(flag, action="store_true", help=flag_help)
    p.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    return p.parse_args(argv)


def print_result(result: dict, device: torch.device) -> None:
    """Print a run's JSON line and, on a card, the device's peak allocated
    memory on a line of its own after it."""
    print(json.dumps(result), flush=True)
    if device.type == "cuda":
        print(f"device peak memory: {torch.cuda.max_memory_allocated(device) / 2**20:.1f} MB "
              "allocated (torch.cuda.max_memory_allocated)", flush=True)
