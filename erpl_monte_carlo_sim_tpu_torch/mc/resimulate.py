"""Re-simulation of Monte Carlo lanes by seed, and the flight envelope
(``erpl_monte_carlo_sim_tpu/mc/resimulate.py``).

A Monte Carlo run keeps only summaries; a lane's history is made again on
demand from what the run remembers (``MonteCarloAnalyzer._last_batch``): the
single call's batch, or a slabbed run's recipe, whose slab k is redrawn
through the same seam (``mc.analyzer._draw_slab``, seeded by
``slab_seed(seed, k)``) that the run drew it with. The lanes fly again
through ``engine.batch.simulate_flight_batch``, the engine that measured
them (on a card the kernel's recording build), so their summaries are the
run's. ``flight_envelope`` reduces re-simulated chunks to time-binned
population bands (``mc.envelope``).

Mixed into ``MonteCarloAnalyzer``: ``lane_scenes``,
``resimulate_trajectories`` and ``flight_envelope``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..engine.config import SimConfig
from .dispersions import select_lane

__all__ = ["ResimulationMixin", "CALIBRATION_CAP"]

# lanes of flight_envelope's first, frame-based chunk under inline=True: the
# frames of more lanes need not fit the device (ROADMAP F2b: the JAX package
# does not cap it)
CALIBRATION_CAP = 4096


def _take(tree, base, ids: torch.Tensor):
    """The lanes ``ids`` of a batched parameter dataclass: leaves that
    gained a lane axis against ``base`` are gathered, shared leaves pass
    (``base`` None: every tensor leaf is batched)."""
    if dataclasses.is_dataclass(tree):
        return type(tree)(**{
            f.name: (_take(getattr(tree, f.name),
                           None if base is None else getattr(base, f.name), ids)
                     if isinstance(getattr(tree, f.name), torch.Tensor)
                     or dataclasses.is_dataclass(getattr(tree, f.name))
                     else getattr(tree, f.name))
            for f in dataclasses.fields(tree)})
    if base is None or tree.ndim > base.ndim:
        return tree.index_select(0, ids.to(tree.device))
    return tree


class ResimulationMixin:
    """Trajectory re-creation methods of ``MonteCarloAnalyzer``."""

    def _slabbed(self) -> bool:
        return isinstance(self._last_batch, dict) and self._last_batch.get("slabbed", False)

    def _redraw_slab(self, k: int):
        """Slab ``k`` of the last slabbed run, drawn again: ``(scene_b,
        ic_b)`` of a full slab, so each lane's values are the run's."""
        from . import analyzer as analyzer_mod

        info = self._last_batch
        scene_b, ic_b, _ = analyzer_mod._draw_slab(self, info["ic"], k, info["slab"],
                                                   info["seed"], info["base_wind"])
        return scene_b, ic_b

    def lane_scenes(self, lane_ids) -> list:
        """The single-lane perturbed ``Scene`` of each global lane id, for a
        single-call run and a slabbed one (whose touched slabs are drawn
        again)."""
        if self._last_batch is None:
            raise RuntimeError("run_monte_carlo first")
        ids = np.asarray(lane_ids, dtype=np.int64)
        if self._slabbed():
            slab = self._last_batch["slab"]
            out = {}
            for k in np.unique(ids // slab):
                scene_b, _ = self._redraw_slab(int(k))
                for g in ids[ids // slab == k]:
                    out[int(g)] = select_lane(scene_b, self.scene, int(g % slab))
            return [out[int(g)] for g in ids]
        scene_b, _ = self._last_batch
        return [select_lane(scene_b, self.scene, int(i)) for i in ids]

    def resimulate_trajectories(self, lane_ids, sim_config: Optional[SimConfig] = None):
        """Fly the lanes ``lane_ids`` of the last run again, recording their
        trajectories, under ``sim_config`` (default: the run's own, so every
        flag the run flew under, the tiered timestep included). Returns
        ``(FlightSummary, Trajectory)`` over ``lane_ids`` in their order.
        Under the run's config the summaries are the run's, bit for bit: the
        same engine (on a card the kernel's recording build) on the same
        lanes. The last call's result is kept for a repeat of it."""
        from ..engine.batch import simulate_flight_batch

        if self._last_batch is None:
            raise RuntimeError("run_monte_carlo first")
        cfg = sim_config or self.sim_config
        memo_key = (tuple(int(i) for i in lane_ids), cfg)
        if self._resim_memo is not None and self._resim_memo[0] == memo_key:
            return self._resim_memo[1]
        if self._slabbed():
            out = self._resimulate_slabbed(lane_ids, cfg)
        else:
            out = simulate_flight_batch(*self._select_lanes(lane_ids), cfg)
        self._resim_memo = (memo_key, out)
        return out

    def _select_lanes(self, lane_ids):
        """The single-call batch cut down to ``lane_ids``: batched leaves
        gathered along the lane axis, shared ones passed."""
        scene_b, ic_b = self._last_batch
        ids = torch.as_tensor(np.asarray(lane_ids, dtype=np.int64))
        return _take(scene_b, self.scene, ids), _take(ic_b, None, ids)

    def _resimulate_slabbed(self, lane_ids, cfg: SimConfig):
        """The lanes of a slabbed run: each touched slab drawn again, its
        lanes flown once, the results put in ``lane_ids`` order."""
        from ..engine.batch import simulate_flight_batch

        ids = np.asarray(lane_ids, dtype=np.int64)
        slab = self._last_batch["slab"]
        parts = []
        where = np.empty(ids.size, dtype=np.int64)
        done = 0
        for k in np.unique(ids // slab):
            scene_b, ic_b = self._redraw_slab(int(k))
            locals_ = np.unique(ids[ids // slab == k] % slab)
            sel = torch.as_tensor(locals_)
            parts.append(simulate_flight_batch(_take(scene_b, self.scene, sel),
                                               _take(ic_b, None, sel), cfg))
            for j, loc in enumerate(locals_):
                where[ids == int(k) * slab + int(loc)] = done + j
            done += locals_.size
        order = torch.as_tensor(where)

        def cat(*xs):
            if isinstance(xs[0], dict):
                return {key: cat(*(x[key] for x in xs)) for key in xs[0]}
            if dataclasses.is_dataclass(xs[0]):
                return type(xs[0])(**{f.name: cat(*(getattr(x, f.name) for x in xs))
                                      for f in dataclasses.fields(xs[0])})
            return torch.cat(xs).index_select(0, order.to(xs[0].device))

        return cat(*(p[0] for p in parts)), cat(*(p[1] for p in parts))

    def flight_envelope(self, lane_ids=None, n_lanes: int = 4096, chunk: int = 1024,
                        env_config=None, sim_config: Optional[SimConfig] = None,
                        analysis: Optional[dict] = None, inline: bool = False) -> dict:
        """Time-binned population bands (count, mean, std, min, max,
        percentiles against the time since rail exit) over re-simulated
        lanes (``mc.envelope``). ``lane_ids=None`` takes the first
        ``n_lanes`` lanes of the run, or with ``analysis`` (the run's
        result) the first ``n_lanes`` that its outlier filter kept.

        The lanes fly again in chunks of ``chunk`` under the run's
        ``SimConfig`` (or ``sim_config``) with the envelope's channels
        recorded and its ``record_stride``; each chunk reduces on its
        device. The first chunk records frames and calibrates the histogram
        edges; with ``inline=True`` (a single-call run only) the later
        chunks reduce inside the flight loop, without frames
        (``simulate_envelope_batch``, eager on a card), and the first chunk
        holds at most ``CALIBRATION_CAP`` lanes."""
        from ..engine.batch import simulate_envelope_batch
        from .envelope import EnvelopeAccumulator, EnvelopeConfig

        if self._last_batch is None:
            raise RuntimeError("run_monte_carlo first")
        env = env_config if env_config is not None else EnvelopeConfig()
        if lane_ids is None:
            if analysis is not None and analysis.get("valid_mask") is not None:
                lane_ids = np.nonzero(np.asarray(analysis["valid_mask"]))[0][:n_lanes]
            else:
                n_run = (int(self._last_batch["n_samples"]) if self._slabbed()
                         else int(self._last_batch[1].position.shape[0]))
                lane_ids = np.arange(min(n_lanes, n_run))
        lane_ids = np.asarray(lane_ids, np.int64)
        if lane_ids.size == 0:
            raise ValueError("flight_envelope needs at least one lane")
        if inline and self._slabbed():
            # the in-loop path cuts the single call's batch; a slabbed run's
            # lanes are drawn again slab by slab: the frame path only
            raise ValueError("inline=True needs a single-call run; slabbed runs use the "
                             "frame-based envelope path")

        cfg = sim_config or self.sim_config
        # record only the binned channels the state does not serve
        cfg = dataclasses.replace(cfg, record_derived=True, record_channels=tuple(
            c for c in env.channels if c not in ("altitude", "speed")))
        if env.record_stride is not None:
            cfg = dataclasses.replace(cfg, record_stride=env.record_stride)
        acc = EnvelopeAccumulator(cfg, env)
        first = min(chunk, CALIBRATION_CAP) if inline else chunk
        starts = [0] + list(range(first, lane_ids.size, chunk))
        for start, end in zip(starts, starts[1:] + [lane_ids.size]):
            ids = lane_ids[start:end]
            if ids.size == 0:
                continue
            if inline and acc._edges is not None:
                lo, width = acc._edges
                _, agg = simulate_envelope_batch(
                    *self._select_lanes(ids), cfg, channels=env.channels,
                    n_bins=acc.n_bins, n_buckets=env.n_buckets, bin_dt=env.bin_dt,
                    lo=lo, width=width, hist_every=max(1, env.hist_frame_stride))
                acc.add_aggregates(agg, len(ids))
            else:
                _, traj = self.resimulate_trajectories(ids, cfg)
                acc.add(traj)
        self._resim_memo = None  # drop the last chunk's trajectories
        return acc.result()
