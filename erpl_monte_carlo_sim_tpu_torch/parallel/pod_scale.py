"""Multi-process Monte Carlo: N dispersed lanes over the ranks of a job
(``scripts/pod_scale.py`` of the JAX package).

One rank a card. Run it under ``torchrun``, one process per card of a node:

  torchrun --nproc-per-node 4 -m erpl_monte_carlo_sim_tpu_torch.parallel.pod_scale 4194304

or one command per process with the JAX script's flags (``--device cpu
--backend gloo`` runs the ranks on the CPU):

  python -m erpl_monte_carlo_sim_tpu_torch.parallel.pod_scale 8192 \\
      --coordinator localhost:9911 --num-processes 2 --process-id 0 &
  python -m erpl_monte_carlo_sim_tpu_torch.parallel.pod_scale 8192 \\
      --coordinator localhost:9911 --num-processes 2 --process-id 1

Lanes go in slabs (bounded device time and memory), slab k under the JAX
script's ``slab_key = fold_in(PRNGKey(seed), k)``. A single rank draws the
whole slab under it; with more ranks each draws its own share under
``fold_in(slab_key, rank)``, as the JAX script's processes do. Each flies it
through
``simulate_summary_batch`` (on a card the flight kernel), and joins the
slab's collective statistics: ``collective_stats`` of the rail-exit speed
and the apogee, ``collective_footprint_moments`` and the device-resident
``collective_tail_carry`` of the apogee, read back once at the end. Every
rank prints the same JSON line, but for its own wall and rate.
"""

from __future__ import annotations

import argparse
import json
import logging
import time
from typing import Optional

import torch

__all__ = ["main", "rank_lanes"]

log = logging.getLogger(__name__)


def rank_lanes(scene, ic, seed: int, k: int, rank: int, n: int, size: int):
    """Rank ``rank``'s ``n`` lanes of slab ``k`` in a run seeded ``seed`` over
    ``size`` ranks: ``(scene_b, ic_b, sample)`` drawn on the scene's device
    under ``slab_key = fold_in(PRNGKey(seed), k)`` for a single rank, under
    ``fold_in(slab_key, rank)`` for more."""
    from ..mc import sample_dispersions
    from .. import random

    key = random.fold_in(random.prng_key(seed), k)
    if size > 1:
        key = random.fold_in(key, rank)
    return sample_dispersions(key, scene, ic, n=n)


def main(total_lanes: int, slab: int = 262_144, steps_cfg: float = 6.0, seed: int = 0,
         coordinator: Optional[str] = None, num_processes: Optional[int] = None,
         process_id: Optional[int] = None, device=None, backend: Optional[str] = None) -> dict:
    """Run ``total_lanes`` lanes of ``SimConfig(max_time=steps_cfg)`` over the
    job's ranks (a single rank without a coordinator or ``torchrun``), print
    the JSON result line and return it."""
    from ..engine import InitialConditions, SimConfig, simulate_summary_batch
    from ..mc.stats import FootprintAccumulator
    from ..models import liquid_motor, nominal_scene
    from .mesh import init_distributed, make_mesh
    from .sharded import (collective_footprint_moments, collective_stats,
                          collective_tail_carry, tail_reservoir_from_carry)

    init_distributed(coordinator, num_processes, process_id, backend=backend, device=device)
    mesh = make_mesh(device)
    size, rank = mesh.size, mesh.rank
    slab = max(size, (slab // size) * size)
    cfg = SimConfig(max_time=steps_cfg)
    scene = nominal_scene(liquid_motor(mesh.device))
    ic = InitialConditions.vertical_launch(mesh.device)

    done_lanes = slab_idx = 0
    s0 = s1 = s2 = 0.0
    fp_acc = FootprintAccumulator()
    tail_carry = None  # the global apogee top/bottom-k, on the device
    t_start = time.time()
    while done_lanes < total_lanes:
        n = min(slab, total_lanes - done_lanes)
        n = max(size, (n // size) * size)
        scene_l, ic_l, _ = rank_lanes(scene, ic, seed, slab_idx, rank, n // size, size)
        summary = simulate_summary_batch(scene_l, ic_l, cfg)
        st = collective_stats(summary.rail.rail_exit_speed, None, mesh)
        apo = collective_stats(summary.apogee_altitude, None, mesh)
        fp_acc.add(*collective_footprint_moments(summary.landing_position, None, mesh))
        _, tail_carry = collective_tail_carry(summary.apogee_altitude, None, mesh, tail_carry)
        k = float(apo["n"])
        mean_k, std_k = float(apo["mean"]), float(apo["std"])
        s0 += k
        s1 += mean_k * k
        s2 += (std_k * std_k + mean_k * mean_k) * k
        done_lanes += n
        slab_idx += 1
        if rank == 0:
            log.info("slab %d: %d/%d lanes (rail-exit mean %.2f m/s across %d ranks)",
                     slab_idx, done_lanes, total_lanes, float(st["mean"]), size)
    if mesh.device.type == "cuda":
        torch.cuda.synchronize(mesh.device)
    wall = time.time() - t_start
    mean = s1 / max(s0, 1)
    tail_acc = tail_reservoir_from_carry(tail_carry, int(s0))  # the one readback of the carry
    result = {
        "lanes": done_lanes,
        "devices": size,
        "processes": size,
        "apogee_extremes": {
            "n": tail_acc.n,
            "max": float(tail_acc.hi[-1]) if tail_acc.hi.size else None,
            "min": float(tail_acc.lo[0]) if tail_acc.lo.size else None,
        },
        "wall_s": round(wall, 1),
        "traj_per_s": round(done_lanes / wall, 1),
        "apogee_mean_at_cutoff": round(mean, 1),
        "apogee_std_at_cutoff": round(max(s2 / max(s0, 1) - mean ** 2, 0.0) ** 0.5, 1),
        "footprint_at_cutoff": fp_acc.footprint(),
    }
    print(json.dumps(result), flush=True)
    return result


def _parse(argv=None):
    p = argparse.ArgumentParser(
        prog="python -m erpl_monte_carlo_sim_tpu_torch.parallel.pod_scale",
        description="N dispersed lanes over the ranks of a torch.distributed job")
    p.add_argument("lanes", nargs="?", type=int, default=1_048_576)
    p.add_argument("--max-time", type=float, default=6.0)
    p.add_argument("--slab", type=int, default=262_144)
    p.add_argument("--coordinator", help="host:port of rank 0's TCP store")
    p.add_argument("--num-processes", type=int)
    p.add_argument("--process-id", type=int)
    p.add_argument("--device", help="default: the card of index LOCAL_RANK (or the rank)")
    p.add_argument("--backend", choices=("nccl", "gloo"),
                   help="default: nccl on a card, gloo on the CPU")
    return p.parse_args(argv)


if __name__ == "__main__":
    import torch.distributed as dist

    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(name)s %(message)s")
    a = _parse()
    try:
        main(a.lanes, slab=a.slab, steps_cfg=a.max_time, coordinator=a.coordinator,
             num_processes=a.num_processes, process_id=a.process_id, device=a.device,
             backend=a.backend)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
