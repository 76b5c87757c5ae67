"""Post-hoc CLI: scan per-simulation JSON exports for the maximum apogee
(``erpl_monte_carlo_sim_tpu/cli/find_max_apogee.py``): every ``sim_*.json``
in the directory, written by either package.

Usage: python -m erpl_monte_carlo_sim_tpu_torch.cli.find_max_apogee <sim_results_dir>
"""

from __future__ import annotations

import glob
import json
import os
import sys


def main(dir_path: str) -> tuple:
    max_apogee = None
    max_sim = None
    for path in sorted(glob.glob(os.path.join(dir_path, "sim_*.json"))):
        try:
            with open(path) as f:
                data = json.load(f)
            # null / missing / non-numeric apogee (failed export) must not
            # abort the scan this tool exists to make robust
            apo = float(data["apogee_altitude"])
        except Exception:
            continue
        if max_apogee is None or apo > max_apogee:
            max_apogee = apo
            max_sim = data.get(
                "simulation_id",
                int(os.path.basename(path)[4:-5]),
            )
    if max_sim is None:
        print(f"No valid sim_*.json with an apogee in {dir_path}")
        return None, None
    print(f"Max apogee in sim_{max_sim}.json: {max_apogee}")
    return max_sim, max_apogee


if __name__ == "__main__":
    main(sys.argv[1] if len(sys.argv) > 1 else "outputs")
