"""Multi-device runs over ``torch.distributed`` (``erpl_monte_carlo_sim_tpu/parallel``):
lane meshes, sharded flights and collective statistics. One rank a device,
each holding a contiguous block of lanes in rank order; see
``parallel.mesh`` and ``parallel.sharded``. The multi-process entry point is
``python -m erpl_monte_carlo_sim_tpu_torch.parallel.pod_scale`` (under
``torchrun``), and ``parallel.spawn.run_ranks`` starts ranks from Python."""

from .mesh import (BATCH_AXIS, LaneMesh, init_distributed, make_global_batch, make_mesh,
                   pad_to_devices, replicate, shard_batch)
from .sharded import (collective_cv_moments, collective_envelope, collective_footprint,
                      collective_footprint_moments, collective_stats, collective_tail_carry,
                      collective_tail_extremes, collective_tail_reservoir, gather_lanes,
                      run_sharded_summaries, tail_reservoir_from_carry)
from .spawn import run_ranks

__all__ = [
    "BATCH_AXIS", "make_mesh", "pad_to_devices", "replicate", "shard_batch",
    "collective_stats", "collective_footprint",
    "collective_footprint_moments", "collective_cv_moments",
    "collective_tail_extremes", "collective_tail_reservoir",
    "collective_tail_carry", "tail_reservoir_from_carry",
    "run_sharded_summaries",
    "collective_envelope",
    "init_distributed",
    "make_global_batch",
    "LaneMesh", "gather_lanes", "run_ranks",
]
