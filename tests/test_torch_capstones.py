"""PyTorch port, the capstone runs (``erpl_monte_carlo_sim_tpu_torch/capstones``)
on the CPU against the JAX package, float64, on a 2 s window.

The JAX scripts run when imported, so each JAX recipe is rebuilt here from
the JAX package's own functions, citing the script's lines. Both sides draw
under the same keys (the port's threefry is ``jax.random``'s), so they
agree lane for lane:

- ``million_flights``, parity and ``--fast`` (2 calls of 16 lanes under
  ``PRNGKey(1)``, ``PRNGKey(2)``; ``--fast`` on 24-mode tables): every
  summary leaf of every lane, and the JSON's ``apogee_mean_m``,
  ``finite_frac``, ``steps`` and ``total_flights``;
- ``full_flights --rk2`` (2 slabs of 16 lanes): the lanes, the valid mask,
  the JSON's means, spread and the two-level corrections, with
  ``two_level_block`` at 16 lanes under seed 99 against JAX's
  ``PRNGKey(99)``;
- ``hundred_million_flights --fast`` (40 lanes in slabs of 16, so the last
  slab holds 8; streaming past 16 lanes; 24 modes; a two-level block of 16
  lanes): killed at its second slab's draw with a checkpoint after every
  slab, then resumed, against JAX's analyzer run once.

Bars, no looser than ``test_torch_analyzer.py::test_lanes_match_jax``:
counts, masks, reasons, step counts and the JSON's integers exact; floats
within ``RTOL`` = 1e-6 relative, with an absolute floor of ``RTOL`` times
the largest magnitude of the compared array (``chip_smoke.analysis_error``:
a horizontal component near zero carries the vector's rounding); the
two-level bias and its stderr, each a difference of two legs that agree
with JAX's to about 1e-12 of their size, within 1e-6 relative or 1e-12
absolute, as ``test_torch_two_level.py`` holds them.
"""

import os
from concurrent.futures import ThreadPoolExecutor

import jax
import numpy as np
import pytest
import torch

import erpl_monte_carlo_sim_tpu_torch.mc.analyzer as analyzer_mod
from chip_smoke import analysis_error, leaves
from erpl_monte_carlo_sim_tpu.engine import InitialConditions as JaxIC
from erpl_monte_carlo_sim_tpu.engine import SimConfig as JaxConfig
from erpl_monte_carlo_sim_tpu.engine.batch import simulate_summary_batch as jax_summary
from erpl_monte_carlo_sim_tpu.mc import MonteCarloAnalyzer as JaxAnalyzer
from erpl_monte_carlo_sim_tpu.mc import outlier_mask as jax_outlier_mask
from erpl_monte_carlo_sim_tpu.mc import sample_dispersions as jax_sample
from erpl_monte_carlo_sim_tpu.mc.two_level import two_level_block as jax_two_level
from erpl_monte_carlo_sim_tpu.models import compress_wind as jax_compress
from erpl_monte_carlo_sim_tpu.models import liquid_motor as jax_liquid
from erpl_monte_carlo_sim_tpu.models import nominal_scene as jax_nominal
from erpl_monte_carlo_sim_tpu.models import wind_mode_basis as jax_basis
from erpl_monte_carlo_sim_tpu_torch.capstones import full_flights as ff
from erpl_monte_carlo_sim_tpu_torch.capstones import hundred_million_flights as hm
from erpl_monte_carlo_sim_tpu_torch.capstones import million_flights as mf
from erpl_monte_carlo_sim_tpu_torch.utils.convert import to_numpy

torch.set_num_threads(1)

RTOL = 1e-6
WINDOW = 2.0   # the shortest window past the outlier filter's 100 m apogee floor
LANES = 16
SLABS = 2
TWO_LEVEL = LANES  # the legs' flights are the slabs' shape: JAX compiles them once
STREAM_LANES = 40
METRICS = ("apogee_altitude", "range", "flight_time")
JSCENE, JIC = jax_nominal(jax_liquid()), JaxIC.vertical_launch()
FAST = dict(integrator="rk2", wind_eval_per_step=True, wind_table_bf16=True)


def close(got, want, what: str) -> None:
    """Floats within ``RTOL`` (absolute floor ``RTOL`` times the largest
    magnitude), anything else exact."""
    analysis_error({what: np.asarray(got)}, {what: np.asarray(want)})


def same_summary(got, want) -> None:
    """Every leaf of a port ``FlightSummary`` against JAX's."""
    analysis_error({p: np.asarray(v) for p, v in leaves(to_numpy(got))},
                   {p: np.asarray(v) for p, v in leaves(want)})


def same_bias_block(got: dict, want: dict) -> None:
    """A ``two_level_block`` against JAX's: counts exact, the parity spread
    at ``RTOL``, the bias, its stderr and the largest delta within 1e-6
    relative or 1e-12 absolute."""
    for k in ("n_lanes", "n_coupled", "mismatched_validity", "config_delta"):
        assert got[k] == want[k], k
    assert got["n_coupled"] > 0
    for m in METRICS:
        np.testing.assert_allclose(got[m]["population_sigma"], want[m]["population_sigma"],
                                   rtol=RTOL, err_msg=m)
        for k in ("bias", "bias_stderr", "abs_max_delta"):
            np.testing.assert_allclose(got[m][k], want[m][k], rtol=RTOL, atol=1e-12,
                                       err_msg=f"{m}.{k}")


# ---------------------------------------------------------------- the runs
def jax_million(fast: bool) -> list:
    """scripts/million_flights.py's calls (:24-42 config and basis, :37-42
    ``prep``, :50-56 the timed calls): a ``FlightSummary`` a seed."""
    cfg = JaxConfig(max_time=WINDOW, **(FAST if fast else {}))
    basis = jax_basis(JSCENE.wind_model, np.linspace(0, 25000.0, 100), 24) if fast else None
    refs = []
    for seed in mf.SEEDS:
        sb, ib, _ = jax_sample(jax.random.PRNGKey(seed), JSCENE, JIC, n=LANES)
        if basis is not None:
            sb = sb.replace(wind=jax_compress(sb.wind, basis))
        refs.append(jax_summary(sb, ib, cfg))
    return refs


def jax_full_flights() -> dict:
    """scripts/full_flights.py with ``--rk2`` (:31-37 config, :47-57 the
    slabs, :67 the two-level block): the lanes, the valid mask, the largest
    step count and the block."""
    cfg = JaxConfig(energy_consistent_aero=True, descent_dt_scale=16, ascent_q_threshold=8000.0,
                    integrator="rk2", max_time=WINDOW)
    parts = {k: [] for k in (*METRICS, "valid")}
    steps = 0
    for seed in range(1, SLABS + 1):
        sb, ib, _ = jax_sample(jax.random.PRNGKey(seed), JSCENE, JIC, n=LANES)
        r = jax_summary(sb, ib, cfg)
        m, _ = jax_outlier_mask(r)
        for k in METRICS:
            parts[k].append(np.asarray(getattr(r, k)))
        parts["valid"].append(np.asarray(m))
        steps = max(steps, int(np.asarray(r.n_steps).max()))
    ref = {k: np.concatenate(v) for k, v in parts.items()}
    ref["steps"] = steps
    ref["two_level"] = jax_two_level(JSCENE, JIC, cfg, TWO_LEVEL, jax.random.PRNGKey(99))
    return ref


def jax_hundred_million() -> dict:
    """scripts/hundred_million_flights.py with ``--fast`` (:36-53), small."""
    jmc = JaxAnalyzer(scene=JSCENE, sim_config=JaxConfig(max_time=WINDOW, **FAST),
                      wind_table_modes=24, two_level_lanes=TWO_LEVEL,
                      stats_stream_threshold=LANES, persistent_cache=False)
    return jmc.run_monte_carlo(JIC, n_samples=STREAM_LANES, lane_slab=LANES, seed=7)


def port_hundred_million(path: str) -> tuple:
    """The port's ``--fast`` run killed at the draw of its second slab (a
    checkpoint after every slab), then resumed: ``(result, analysis,
    checkpoint kept after the kill, checkpoint left after the resume)``."""
    kw = dict(n_samples=STREAM_LANES, lane_slab=LANES, max_time=WINDOW,
              two_level_lanes=TWO_LEVEL, stats_stream_threshold=LANES, checkpoint_every=1,
              checkpoint_path=path)
    real, drawn = analyzer_mod._draw_slab, []

    def dying(*a, **k):
        if len(drawn) == 1:
            raise RuntimeError("simulated crash")
        drawn.append(1)
        return real(*a, **k)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(analyzer_mod, "_draw_slab", dying)
        with pytest.raises(RuntimeError, match="simulated crash"):
            hm.run(True, "cpu", **kw)
    kept = os.path.exists(path)
    got, analysis = hm.run(True, "cpu", **kw)
    return got, analysis, kept, os.path.exists(path)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every port run, in this thread, while JAX's recipes run in threads
    beside it (the file's wall is about the port's runs)."""
    with ThreadPoolExecutor(4) as ex:
        refs = {"million parity": ex.submit(jax_million, False),
                "million fast": ex.submit(jax_million, True),
                "full_flights": ex.submit(jax_full_flights),
                "hundred_million": ex.submit(jax_hundred_million)}
        port = {
            f"million {'fast' if fast else 'parity'}": mf.run(
                fast, "cpu", lanes=LANES, warm_seed=None, max_time=WINDOW)
            for fast in (False, True)}
        port["full_flights"] = ff.run(True, "cpu", slab=LANES, n_slabs=SLABS, warm_seed=None,
                                      max_time=WINDOW, two_level_lanes=TWO_LEVEL)
        port["hundred_million"] = port_hundred_million(
            str(tmp_path_factory.mktemp("ckpt") / "hundred_million.ckpt.npz"))
        return port, {k: f.result() for k, f in refs.items()}


@pytest.fixture(params=["parity", "fast"])
def million(request, runs):
    port, refs = runs
    got, summaries = port[f"million {request.param}"]
    return got, summaries, refs[f"million {request.param}"], request.param == "fast"


@pytest.fixture
def full_flights(runs):
    port, refs = runs
    return (*port["full_flights"], refs["full_flights"])


@pytest.fixture
def hundred_million(runs):
    port, refs = runs
    got, analysis, kept, left = port["hundred_million"]
    return got, analysis, refs["hundred_million"], kept, left


def test_million_flights_lanes_match_jax(million):
    _, summaries, refs, _ = million
    assert len(summaries) == len(refs) == 2
    for got, want in zip(summaries, refs):
        same_summary(got, want)


def test_million_flights_json_matches_jax(million):
    got, _, refs, fast = million
    apo = np.concatenate([np.asarray(r.apogee_altitude) for r in refs])
    assert got["total_flights"] == apo.size == 2 * LANES
    assert got["steps"] == max(int(np.asarray(r.n_steps).max()) for r in refs)
    assert got["finite_frac"] == float(np.isfinite(apo).mean()) == 1.0
    close(got["apogee_mean_m"], np.nanmean(apo), "apogee_mean_m")
    assert got["chips"] == 1 and got["device"] == "cpu"
    assert got["wall_s_incl_sampling"] > 0 and "north_star" not in got
    assert got["mode"] == ("rk2 + wind/step + bf16 + modes24" if fast else "parity")


# ---------------------------------------------------------------- full_flights
def test_full_flights_lanes_match_jax(full_flights):
    got, lanes, ref = full_flights
    np.testing.assert_array_equal(lanes["valid"], ref["valid"])
    assert 0 < ref["valid"].sum() < SLABS * LANES  # the filter acts in the window
    for k in METRICS:
        close(lanes[k], ref[k], k)
    assert got["max_lane_steps"] == ref["steps"]
    same_bias_block(lanes["two_level"], ref["two_level"])


def test_full_flights_json_matches_jax(full_flights):
    """The JSON against the script's formulas (scripts/full_flights.py:69-103)
    on JAX's lanes and block."""
    got, _, ref = full_flights
    valid = ref["valid"]
    apo, rng, ft = (ref[k] for k in METRICS)
    assert got["total_flights"] == SLABS * LANES
    assert got["valid_frac"] == float(valid.mean())
    for key, want in (("apogee_mean_m", apo[valid].mean()), ("apogee_std_m", apo[valid].std()),
                      ("range_mean_m", rng[valid].mean()),
                      ("flight_time_mean_s", ft[valid].mean())):
        close(got[key], want, key)
    tl = ref["two_level"]
    n_valid = int(valid.sum())
    for m, values in zip(METRICS, (apo, rng, ft)):
        blk, b = got["two_level"][m], tl[m]
        raw = values[valid].mean()
        close(blk["raw_mean"], raw, f"{m}.raw_mean")
        close(blk["corrected_mean"], raw + b["bias"], f"{m}.corrected_mean")
        close(blk["sampling_stderr"], values[valid].std() / np.sqrt(n_valid),
              f"{m}.sampling_stderr")
        for k in ("bias", "bias_stderr"):
            np.testing.assert_allclose(blk[k], b[k], rtol=RTOL, atol=1e-12, err_msg=f"{m}.{k}")
    assert got["two_level"]["n_coupled"] == tl["n_coupled"]
    assert got["mode"].endswith(" + rk2") and "r1_capstone" not in got


# ---------------------------------------------------------------- hundred_million_flights
def test_hundred_million_resumed_run_matches_jax(hundred_million):
    """Slab k under ``fold_in(PRNGKey(7), k)``, the short last slab, the
    streams across the resume: the resumed run is JAX's analysis."""
    _, a, ref, kept, left = hundred_million
    assert kept and not left  # written before the kill, removed at the end
    assert a["n_total"] == ref["n_total"] == STREAM_LANES
    assert (a["n_samples"], a["n_outliers"]) == (ref["n_samples"], ref["n_outliers"])
    assert 0 < a["n_samples"] < STREAM_LANES
    np.testing.assert_array_equal(a["valid_mask"], ref["valid_mask"])
    np.testing.assert_array_equal(a["reasons"], ref["reasons"])
    assert a["metrics_is_sample"] and ref["metrics_is_sample"]
    for m in METRICS:
        close(a["metrics"][m], ref["metrics"][m], f"metrics.{m}")
        assert not a["streams"][m].is_exact  # past its crossing to the sketch
        for s in ("mean", "std", "min", "max", "percentiles", "percentile_ci"):
            close(np.asarray(a[m][s], np.float64), np.asarray(ref[m][s], np.float64),
                  f"{m}.{s}")
    fp, rfp = a["landing_footprint"], ref["landing_footprint"]
    assert fp.keys() == rfp.keys() and fp["n"] == rfp["n"]
    for k, v in rfp.items():
        if isinstance(v, dict):
            for kk in v:
                close(fp[k][kk], v[kk], f"landing_footprint.{k}.{kk}")
        elif not isinstance(v, str):
            close(np.asarray(fp[k], np.float64), np.asarray(v, np.float64),
                  f"landing_footprint.{k}")


def test_hundred_million_two_level_matches_jax(hundred_million):
    _, a, ref, _, _ = hundred_million
    got, want = a["two_level"], ref["two_level"]
    same_bias_block(got, want)
    assert got["config_delta"] == {"wind_eval_per_step": [True, False],
                                   "wind_table_bf16": [True, False],
                                   "integrator": ["rk2", "rk4"]}
    for m in METRICS:
        for k in ("corrected_mean", "corrected_stderr"):
            close(got[m][k], want[m][k], f"{m}.{k}")


def test_hundred_million_json_is_the_analysis(hundred_million):
    got, a, ref, _, _ = hundred_million
    assert (got["total_flights"], got["valid"], got["outliers"]) == (
        ref["n_total"], ref["n_samples"], ref["n_outliers"])
    close(got["apogee_mean_m"], ref["apogee_altitude"]["mean"], "apogee_mean_m")
    close(got["apogee_std_m"], ref["apogee_altitude"]["std"], "apogee_std_m")
    close(got["apogee_p50_m"], ref["apogee_altitude"]["percentiles"][2], "apogee_p50_m")
    assert got["landing_footprint"] is a["landing_footprint"]
    assert got["two_level"] is a["two_level"] and got["metrics_is_sample"] is True
    assert got["steps"] is None  # a window other than the script's 6 s
    assert got["host_peak_rss_mb"] > 0 and got["chips"] == 1 and got["device"] == "cpu"
    assert got["mode"] == "rk2 + wind/step + bf16 + modes24 + two-level"


# ---------------------------------------------------------------- no card
@pytest.mark.parametrize("module", [mf, ff, hm], ids=lambda m: m.__name__.split(".")[-1])
def test_capstone_raises_without_a_card(module):
    """The card is the default and has no fallback: without one, ``run``
    and the command line raise before any work."""
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        module.run()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        module.main([])
