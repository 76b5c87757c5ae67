"""Monte Carlo layer of the PyTorch port."""

from .analyzer import MonteCarloAnalyzer
from .dispersions import DispersionSample, UncertaintyParams, sample_dispersions, select_lane
from .filter import REASON_NAMES, OutlierBounds, decode_reasons, outlier_mask
from .stats import PERCENTILES, landing_footprint, masked_stats, order_stat_ranks, percentile_ci

__all__ = ["MonteCarloAnalyzer", "DispersionSample", "UncertaintyParams",
           "sample_dispersions", "select_lane", "REASON_NAMES", "OutlierBounds",
           "decode_reasons", "outlier_mask", "PERCENTILES", "landing_footprint",
           "masked_stats", "order_stat_ranks", "percentile_ci"]
