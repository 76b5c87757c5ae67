"""Monte Carlo layer of the PyTorch port."""

from .analyzer import MonteCarloAnalyzer, slab_seed
from .checkpoint import load_summaries, save_summaries
from .dispersions import (DispersionSample, UncertaintyParams, inject_reference_lanes,
                          sample_dispersions, select_lane)
from .ensemble import EnsembleAccumulator, member_exceedance
from .envelope import (DEFAULT_CHANNELS, EnvelopeAccumulator, EnvelopeConfig, result_block,
                       trajectory_channel)
from .filter import REASON_NAMES, OutlierBounds, decode_reasons, outlier_mask
from .importance import log_weights, weighted_mean
from .sequential import (ExceedanceDecision, ExceedanceHalfwidth, MeanStderr, QmcMeanStderr,
                         QuantileHalfwidth, parse_criterion)
from .stats import (PERCENTILES, StreamingStats, exceedance, exceedance_from_analysis,
                    landing_footprint, masked_stats, order_stat_ranks, percentile_ci)
from .resimulate import ResimulationMixin
from .tail import TailReservoir

__all__ = ["MonteCarloAnalyzer", "slab_seed", "DispersionSample", "UncertaintyParams",
           "sample_dispersions", "inject_reference_lanes", "select_lane", "REASON_NAMES",
           "OutlierBounds", "decode_reasons", "outlier_mask", "PERCENTILES",
           "landing_footprint", "masked_stats", "order_stat_ranks", "percentile_ci",
           "StreamingStats", "exceedance", "exceedance_from_analysis", "TailReservoir",
           "MeanStderr", "QmcMeanStderr", "ExceedanceDecision", "ExceedanceHalfwidth",
           "QuantileHalfwidth", "parse_criterion", "save_summaries", "load_summaries",
           "EnvelopeConfig", "EnvelopeAccumulator", "DEFAULT_CHANNELS", "trajectory_channel",
           "result_block", "ResimulationMixin", "EnsembleAccumulator", "member_exceedance",
           "log_weights", "weighted_mean"]
