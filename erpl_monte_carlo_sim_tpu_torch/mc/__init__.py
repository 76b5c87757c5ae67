"""Monte Carlo layer of the PyTorch port."""

from .analyzer import MonteCarloAnalyzer
from .checkpoint import load_summaries, save_summaries
from .cv import CVMoments, control_names, cv_slab_moments, finalize_cv
from .dispersions import (DispersionSample, UncertaintyParams, inject_reference_lanes,
                          normal_dims, sample_dispersions, sample_from_normals, select_lane)
from .ensemble import EnsembleAccumulator, member_exceedance
from .envelope import (DEFAULT_CHANNELS, EnvelopeAccumulator, EnvelopeConfig, result_block,
                       trajectory_channel)
from .filter import REASON_NAMES, OutlierBounds, decode_reasons, outlier_mask
from .importance import (auto_shift, log_weights, shift_from_gradients, weighted_mean,
                         weighted_tail)
from .sequential import (ExceedanceDecision, ExceedanceHalfwidth, MeanStderr, QmcMeanStderr,
                         QuantileHalfwidth, parse_criterion)
from .stats import (PERCENTILES, StreamingStats, exceedance, exceedance_from_analysis,
                    landing_footprint, masked_stats, order_stat_ranks, percentile_ci)
from .resimulate import ResimulationMixin
from .robust import dispersed_objective_and_grad, optimize_robust
from .sobol_indices import (active_groups, jansen_estimates, pure_interactions,
                            select_interaction_pairs, sobol_indices)
from .subset import pool_subset_quantiles, pool_subset_runs, subset_quantile, subset_simulation
from .tail import TailReservoir, fit_gpd_pwm, gpd_tail, tail_from_analysis
from .two_level import parity_twin, two_level_block

__all__ = ["MonteCarloAnalyzer", "DispersionSample", "UncertaintyParams",
           "sample_dispersions", "inject_reference_lanes", "select_lane", "REASON_NAMES",
           "OutlierBounds", "decode_reasons", "outlier_mask", "PERCENTILES",
           "landing_footprint", "masked_stats", "order_stat_ranks", "percentile_ci",
           "StreamingStats", "exceedance", "exceedance_from_analysis", "TailReservoir",
           "MeanStderr", "QmcMeanStderr", "ExceedanceDecision", "ExceedanceHalfwidth",
           "QuantileHalfwidth", "parse_criterion", "save_summaries", "load_summaries",
           "EnvelopeConfig", "EnvelopeAccumulator", "DEFAULT_CHANNELS", "trajectory_channel",
           "result_block", "ResimulationMixin", "EnsembleAccumulator", "member_exceedance",
           "log_weights", "weighted_mean", "weighted_tail", "shift_from_gradients",
           "auto_shift", "CVMoments", "control_names", "cv_slab_moments", "finalize_cv",
           "normal_dims", "sample_from_normals", "subset_simulation", "subset_quantile",
           "pool_subset_runs", "pool_subset_quantiles", "sobol_indices", "jansen_estimates",
           "active_groups", "select_interaction_pairs", "pure_interactions", "fit_gpd_pwm",
           "gpd_tail", "tail_from_analysis", "parity_twin", "two_level_block",
           "dispersed_objective_and_grad", "optimize_robust"]
