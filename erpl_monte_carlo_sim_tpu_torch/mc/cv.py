"""Regression control variates over the dispersion channels
(``erpl_monte_carlo_sim_tpu/mc/cv.py``).

Every drawn channel has a known mean under the sampling distribution, so
any function of the standardized draws minus its exact mean is a valid
control: subtracting the fitted response ``beta . z`` from a metric removes
the variance it shares with the inputs and leaves its mean unbiased (up to
the O(d/n) bias of a ``beta`` fitted on the same lanes; ``finalize_cv``
reports ``n_per_control``).

The outlier filter conditions the statistics, and E[z | valid] is not zero,
so adjusting the valid lanes' mean alone would bias it. The estimator is
the ratio form: the numerator mean(metric * 1_valid) and the denominator
mean(1_valid) are both adjusted over all lanes, where E[z] is exactly zero,
and the mean is their ratio, with the delta method's stderr.

Device side: ``cv_slab_moments`` builds the control matrix and the targets
in the lane dtype on the lanes' device, then reduces each slab to centred
moments about the slab's own means in float64 (so no float32 product of a
slab's 262,144 lanes runs in TF32 or loses digits), one readback of O(d^2)
numbers. Invalid and non-finite lanes leave every sum through
``torch.where``, not by a multiplication (NaN times 0 is NaN). The turbulence
mode scores (``_wind_scores``) project in float64 for the same reason.

Host side: ``CVMoments`` merges slabs by Chan's parallel update in float64,
so the result does not depend on the slab count, and ``finalize_cv`` solves
the regression. The stderr assumes i.i.d. lanes: exact for
``sampler="prng"``, not for Sobol (use ``qmc_error``) or antithetic pairs.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..models.wind import ar1_transfer_matrix, power_law_profile
from ..utils.tree import tree_map

__all__ = ["TARGETS", "CVMoments", "control_names", "cv_slab_moments", "finalize_cv",
           "wind_mode_projector", "wind_speed_knots", "wind_speed_control_means",
           "wind_speed_ctrl_leaves"]

# the adjusted targets; landing x/y give the footprint's mean a twin, and
# "valid" is the ratio's denominator
TARGETS = ("apogee_altitude", "range", "flight_time", "landing_x", "landing_y", "valid")


def _uniform_channels(params):
    """The two uniform channels: ``(ws_active, ws_mid, ws_scale,
    dir_active, (E cos, E sin, E cos 2d, E sin 2d))`` over the ranges."""
    lo, hi = float(params.wind_speed_range[0]), float(params.wind_speed_range[1])
    ws_active = hi > lo
    ws_mid = 0.5 * (lo + hi)
    ws_scale = (hi - lo) / math.sqrt(12.0) if ws_active else 1.0
    dlo, dhi = float(params.wind_direction_range[0]), float(params.wind_direction_range[1])
    dir_active = dhi > dlo
    if dir_active:
        w = dhi - dlo
        moments = ((math.sin(dhi) - math.sin(dlo)) / w,
                   (math.cos(dlo) - math.cos(dhi)) / w,
                   (math.sin(2 * dhi) - math.sin(2 * dlo)) / (2 * w),
                   (math.cos(2 * dlo) - math.cos(2 * dhi)) / (2 * w))
    else:
        moments = (0.0, 0.0, 0.0, 0.0)
    return ws_active, ws_mid, ws_scale, dir_active, moments


def control_names(params, motor, wind_modes: int = 0, wind_speed_alts=()) -> list:
    """The control columns' names in ``_controls``' order. ``wind_modes`` is
    the projector's column count (it clamps to the grid), and
    ``wind_speed_alts`` the knot altitudes ``wind_speed_knots`` kept."""
    names = []
    for base, sig in (("pos", params.initial_position), ("vel", params.initial_velocity),
                      ("att", params.initial_attitude),
                      ("omg", params.initial_angular_velocity)):
        for i, s in enumerate(sig):
            if float(s) > 0.0:
                names.append(f"{base}_{'xyz'[i]}")
    names += ["mass", "motor_thrust"]
    if not motor.mdot_follows_thrust:
        names.append("motor_flow")
    names.append("density")
    ws_active, _, _, dir_active, _ = _uniform_channels(params)
    if ws_active:
        names.append("wind_speed")
    if dir_active:
        names += ["cos_dir", "sin_dir"]
    if ws_active and dir_active:
        names += ["wind_x", "wind_y"]
    gaussians = [n for n in names
                 if n.split("_")[0] in ("pos", "vel", "att", "omg", "mass", "motor", "density")]
    names += [f"{n}^2" for n in gaussians]
    if ws_active:
        names.append("wind_speed^2")
    if dir_active:
        names += ["cos_2dir", "sin_2dir"]
    for k in range(wind_modes):
        names += [f"turb_{c}_m{k}" for c in "uvw"]
    for k in range(wind_modes):
        names += [f"turb_{c}_m{k}^2" for c in "uvw"]
    spd = [f"wspd@{a:.0f}m" for a in wind_speed_alts]
    if len(set(spd)) < len(spd):  # adjacent knots rounding to one metre
        spd = [f"wspd@{a:.2f}m" for a in wind_speed_alts]
    if len(set(spd)) < len(spd):
        spd = [f"wspd{i}@{a:.2f}m" for i, a in enumerate(wind_speed_alts)]
    names += spd
    names += [f"{s}^2" for s in spd]
    return names


def wind_mode_projector(wind_model, altitudes, k_modes: int) -> np.ndarray:
    """``[N, K]`` projector ``P = U_K / s_K`` from the SVD of the AR(1)
    transfer matrix (``models.wind.ar1_transfer_matrix``): ``P^T turb`` is
    exactly standard normal and independent across modes and components,
    under any sampler. ``k_modes`` clamps to the grid size."""
    a = ar1_transfer_matrix(wind_model, np.asarray(altitudes, np.float64))
    u, s, _ = np.linalg.svd(a)
    k = min(int(k_modes), len(s))
    return u[:, :k] / s[:k]


def wind_speed_knots(n_grid: int, j: int) -> np.ndarray:
    """``j`` evenly spaced knot indices over an ``n_grid``-knot grid, without
    repeats (so fewer than ``j`` on a tiny grid)."""
    return np.unique(np.round(np.linspace(0, n_grid - 1, int(j))).astype(int))


def _rice_mean(nu, sigma):
    """E|m + t| for t ~ N(0, sigma^2 I_2) around a mean of magnitude ``nu``
    (the Rice mean), through the exponentially scaled Bessel functions."""
    from scipy.special import i0e, i1e

    nu = np.asarray(nu, np.float64)
    if sigma <= 0.0:
        return nu.copy()
    t = nu * nu / (2.0 * sigma * sigma)
    return sigma * math.sqrt(math.pi / 2.0) * ((1.0 + t) * i0e(t / 2.0) + t * i1e(t / 2.0))


def _host_power_law(wind_model, altitudes, speed) -> np.ndarray:
    """``power_law_profile`` evaluated on the host in float64."""
    model = tree_map(lambda t: t.detach().cpu().double() if isinstance(t, torch.Tensor)
                     else t, wind_model)
    return power_law_profile(model, torch.as_tensor(np.asarray(altitudes, np.float64)),
                             speed).numpy()


def wind_speed_control_means(params, wind_model, altitudes, idx, base=None) -> tuple:
    """Exact sampling means of the horizontal wind speed and energy at the
    knots ``idx``: given the uniform speed and direction draws the knot's
    horizontal wind is isotropic Gaussian around the mean profile (Rice mean,
    energy plus ``2 sigma^2``), and the uniforms integrate out by 48-node
    Gauss-Legendre quadrature. Synthesized profiles take the power-law
    shear, forecast runs the base plus the uniform offset. Returns float64
    ``(e_spd[J], e_energy[J], sigma[J])``."""
    alt = np.asarray(altitudes, np.float64)
    idx = np.asarray(idx, int)
    a = ar1_transfer_matrix(wind_model, alt)
    sig = np.sqrt((a * a).sum(axis=1))[idx]
    lo, hi = float(params.wind_speed_range[0]), float(params.wind_speed_range[1])
    dlo, dhi = float(params.wind_direction_range[0]), float(params.wind_direction_range[1])

    def gl(a_, b_, n=48):
        if b_ <= a_:
            return np.array([a_]), np.array([1.0])
        x, w = np.polynomial.legendre.leggauss(n)
        return 0.5 * (b_ - a_) * x + 0.5 * (a_ + b_), w / w.sum()

    ws, wws = gl(lo, hi)
    wd, wwd = gl(dlo, dhi)
    e_spd = np.empty(len(idx))
    e_en = np.empty(len(idx))
    if base is None:
        c = np.asarray(_host_power_law(wind_model, alt[idx], 1.0), np.float64)
        for j in range(len(idx)):
            nu = ws * c[j]
            e_spd[j] = wws @ _rice_mean(nu, sig[j])
            e_en[j] = wws @ (nu * nu) + 2.0 * sig[j] ** 2
    else:
        b = np.asarray(base, np.float64)[idx, :2]
        cosd, sind = np.cos(wd), np.sin(wd)
        for j in range(len(idx)):
            mu = np.sqrt((b[j, 0] + ws[:, None] * cosd[None, :]) ** 2
                         + (b[j, 1] + ws[:, None] * sind[None, :]) ** 2)
            e_spd[j] = wws @ (_rice_mean(mu, sig[j]) @ wwd)
            e_en[j] = wws @ ((mu * mu) @ wwd) + 2.0 * sig[j] ** 2
    return e_spd, e_en, sig


def wind_speed_ctrl_leaves(params, wind_model, altitudes, j, base=None,
                           dtype=torch.float32, device="cpu") -> tuple:
    """The wind-speed entries of the ``wind_ctrl`` dict (``spd_idx``,
    ``spd_mean``, ``spd_en_mean``, ``spd_scale``, ``spd_en_scale``) on
    ``device``, and the knot indices. The scales are deterministic O(std)
    values from the exact moments, floored for near-calm knots: they
    condition the regression and cannot bias the mean."""
    alt = np.asarray(altitudes, np.float64)
    idx = wind_speed_knots(len(alt), j)
    e_spd, e_en, _ = wind_speed_control_means(params, wind_model, alt, idx, base=base)
    std = np.sqrt(np.maximum(e_en - e_spd * e_spd, 1e-6))
    scale = np.maximum(std, 0.05)
    scale_en = np.maximum(2.0 * e_spd * std + 2.0 * std * std, 0.1)

    def t(x):
        return torch.as_tensor(x, dtype=dtype, device=device)

    leaves = {"spd_idx": torch.as_tensor(idx, device=device), "spd_mean": t(e_spd),
              "spd_en_mean": t(e_en), "spd_scale": t(scale), "spd_en_scale": t(scale_en)}
    return leaves, idx


def _wind_speed_controls(wind_ctrl, dtype):
    """``[n, 2J]``: the realized horizontal wind speed and energy at the
    knots less their exact means, over their scales."""
    w = wind_ctrl["wind"].to(dtype)  # [n, N, 3]
    idx = wind_ctrl["spd_idx"]
    u = w[:, idx, 0]
    v = w[:, idx, 1]
    en = u * u + v * v
    spd = torch.sqrt(en)
    return torch.cat([(spd - wind_ctrl["spd_mean"].to(dtype)[None, :])
                      / wind_ctrl["spd_scale"].to(dtype)[None, :],
                      (en - wind_ctrl["spd_en_mean"].to(dtype)[None, :])
                      / wind_ctrl["spd_en_scale"].to(dtype)[None, :]], dim=1)


def _wind_scores(wind_ctrl, dtype):
    """``[n, 3K]`` turbulence-mode scores of the realized wind tables: each
    lane's deterministic mean profile removed (power-law shear, or the
    forecast plus the uniform offset, as ``mc.dispersions._build_scene``
    forms them), the residual projected on the AR(1) principal directions
    (in float64), the vertical over its 0.3. Standard normal columns with a
    zero mean."""
    w = wind_ctrl["wind"].to(dtype)  # [n, N, 3]
    ws = wind_ctrl["ws"].to(dtype)
    wd = wind_ctrl["wd"].to(dtype)
    cosd, sind = torch.cos(wd), torch.sin(wd)
    if wind_ctrl.get("base") is not None:
        base = torch.as_tensor(wind_ctrl["base"], dtype=dtype, device=w.device)
        off = torch.stack([ws * cosd, ws * sind, torch.zeros_like(ws)], dim=-1)
        turb = w - base[None, :, :] - off[:, None, :]
    else:
        alt = wind_ctrl["alt"].to(dtype)
        speed = power_law_profile(wind_ctrl["model"], alt[None, :], ws[:, None])  # [n, N]
        mean_uv = torch.stack([speed * cosd[:, None], speed * sind[:, None]], dim=-1)
        turb = w - torch.cat([mean_uv, torch.zeros_like(mean_uv[..., :1])], dim=-1)
    proj = torch.as_tensor(wind_ctrl["proj"], dtype=torch.float64, device=w.device)
    s = torch.einsum("nic,ik->nkc", turb.to(torch.float64), proj)
    s = s / torch.tensor([1.0, 1.0, 0.3], dtype=torch.float64, device=w.device)
    return s.to(dtype).reshape(s.shape[0], -1)


def _controls(sample, params, motor, wind_ctrl=None):
    """``[n, d]`` controls with exactly zero mean under sampling: Gaussian
    channels standardized, the uniform speed centred to unit variance, the
    direction's first and second harmonics less their means, the wind-offset
    products less ``E[s] E[cos d]``, the Gaussians' squares less 1; zero
    sigmas and the solid motor's flow multiplier never enter (a sigma that
    is zero at run time gives a zero column that ``finalize_cv`` drops);
    then the turbulence scores and their squares, and the wind speed and
    energy at the knots, as ``wind_ctrl`` asks."""
    cols = []
    for arr, sig in ((sample.initial_position_offset, params.initial_position),
                     (sample.initial_velocity_offset, params.initial_velocity),
                     (sample.initial_attitude_offset, params.initial_attitude),
                     (sample.initial_angular_velocity_offset, params.initial_angular_velocity)):
        for i, s in enumerate(sig):
            if float(s) > 0.0:
                cols.append(arr[:, i] / float(s))

    def mult(x, sig):
        return (x - 1.0) / torch.clamp_min(torch.as_tensor(sig, dtype=x.dtype,
                                                           device=x.device), 1e-30)

    def sigma_or_tiny(s):
        return float(s) if float(s) > 0 else 1e-30

    cols.append(mult(sample.mass_multiplier, sigma_or_tiny(params.mass_uncertainty)))
    cols.append(mult(sample.motor_thrust_multiplier, motor.thrust_uncertainty))
    if not motor.mdot_follows_thrust:
        cols.append(mult(sample.motor_flow_multiplier, motor.mass_flow_uncertainty))
    cols.append(mult(sample.density_multiplier,
                     sigma_or_tiny(params.atmospheric_density_uncertainty)))

    ws_active, ws_mid, ws_scale, dir_active, (ec, es, ec2, es2) = _uniform_channels(params)
    n_gauss = len(cols)
    if ws_active:
        ws = (sample.wind_speed - ws_mid) / ws_scale
        cols.append(ws)
    if dir_active:
        cols += [torch.cos(sample.wind_direction) - ec, torch.sin(sample.wind_direction) - es]
    if ws_active and dir_active:
        cols.append(sample.wind_speed * torch.cos(sample.wind_direction) - ws_mid * ec)
        cols.append(sample.wind_speed * torch.sin(sample.wind_direction) - ws_mid * es)
    cols += [cols[i] ** 2 - 1.0 for i in range(n_gauss)]
    if ws_active:
        cols.append(ws ** 2 - 1.0)
    if dir_active:
        cols.append(torch.cos(2.0 * sample.wind_direction) - ec2)
        cols.append(torch.sin(2.0 * sample.wind_direction) - es2)
    z = torch.stack(cols, dim=1)
    if wind_ctrl is not None and wind_ctrl.get("proj") is not None:
        s = _wind_scores(wind_ctrl, z.dtype)
        z = torch.cat([z, s, s ** 2 - 1.0], dim=1)
    if wind_ctrl is not None and wind_ctrl.get("spd_idx") is not None:
        z = torch.cat([z, _wind_speed_controls(wind_ctrl, z.dtype)], dim=1)
    return z


def _targets(summary, valid, dtype):
    """``[n, T]`` targets: the metrics on the jointly finite valid lanes
    (zero elsewhere, by ``torch.where``) and the validity indicator."""
    lp = summary.landing_position
    fin = (valid & torch.isfinite(summary.apogee_altitude) & torch.isfinite(summary.range)
           & torch.isfinite(summary.flight_time) & torch.isfinite(lp[:, 0])
           & torch.isfinite(lp[:, 1]))
    return torch.stack([torch.where(fin, summary.apogee_altitude, 0.0),
                        torch.where(fin, summary.range, 0.0),
                        torch.where(fin, summary.flight_time, 0.0),
                        torch.where(fin, lp[:, 0], 0.0),
                        torch.where(fin, lp[:, 1], 0.0),
                        fin.to(summary.apogee_altitude.dtype)], dim=1).to(dtype)


def cv_slab_moments(sample, summary, valid, include, params, motor, wind_ctrl=None) -> tuple:
    """One slab's centred CV moments on the lanes' device, read back once:
    float64 host arrays ``(n_inc, mean_z[d], mean_t[T], Szz[d,d], Szt[d,T],
    Stt[T,T])``, the S-matrices centred on this slab's own means.
    ``include`` masks the padding lanes of a ragged last slab; excluded
    lanes leave every sum through ``torch.where``."""
    z = _controls(sample, params, motor, wind_ctrl)
    t = _targets(summary, valid, z.dtype)
    inc = include[:, None]
    f64 = torch.float64
    z = torch.where(inc, z.to(f64), 0.0)
    t = torch.where(inc, t.to(f64), 0.0)
    n = include.sum()
    nf = torch.clamp_min(n, 1).to(f64)
    mz = z.sum(dim=0) / nf
    mt = t.sum(dim=0) / nf
    zc = torch.where(inc, z - mz, 0.0)
    tc = torch.where(inc, t - mt, 0.0)
    out = (n, mz, mt, zc.T @ zc, zc.T @ tc, tc.T @ tc)
    return tuple(x.cpu().numpy() for x in out)


class CVMoments:
    """The float64 host merge of slab CV moments (Chan's parallel update,
    generalized to the cross-moment matrices)."""

    def __init__(self):
        self.n = 0
        self.mz = self.mt = None
        self.szz = self.szt = self.stt = None

    def add(self, moments) -> None:
        n, mz, mt, szz, szt, stt = (np.array(m, np.float64) for m in moments)
        n = int(n)
        if n == 0:
            return
        if self.n == 0:
            self.n, self.mz, self.mt = n, mz, mt
            self.szz, self.szt, self.stt = szz, szt, stt
            return
        na, nb = self.n, n
        tot = na + nb
        dz = mz - self.mz
        dt = mt - self.mt
        w = na * nb / tot
        self.szz += szz + np.outer(dz, dz) * w
        self.szt += szt + np.outer(dz, dt) * w
        self.stt += stt + np.outer(dt, dt) * w
        self.mz += dz * nb / tot
        self.mt += dt * nb / tot
        self.n = tot


def _ratio_stats(mu, cov, a, iv, n):
    """Delta-method mean and stderr of target ``a``'s valid-lane mean, the
    ratio of its adjusted mean to the validity's."""
    d = mu[iv]
    if d <= 0.0:
        return float("nan"), float("nan")
    r = mu[a] / d
    var = (cov[a, a] - 2.0 * r * cov[a, iv] + r * r * cov[iv, iv]) / (n * d * d)
    return float(r), float(np.sqrt(max(var, 0.0)))


def finalize_cv(acc: CVMoments, names: list) -> dict:
    """Solve the regression and write the ``control_variates`` block: per
    metric the adjusted valid-lane mean and its stderr, the plain mean and
    stderr from the same moments, the variance-reduction factor and
    ``beta`` per kept control (the metric's response to one sigma of it).
    Constant columns are dropped and a relative ridge conditions the solve;
    with fewer than 4 lanes per control the block holds the plain stats
    (``insufficient_samples``)."""
    if acc.n == 0:
        return {"n": 0, "controls": names}
    n = acc.n
    mu_t = acc.mt
    sigma_tt = acc.stt / n
    out = {"n": n, "controls": list(names)}
    iv = TARGETS.index("valid")
    plain = {name: _ratio_stats(mu_t, sigma_tt, a, iv, n) for a, name in enumerate(TARGETS[:-1])}

    var_z = np.diag(acc.szz) / n
    keep = var_z > 1e-12 * max(var_z.max(), 1e-30)
    d_kept = int(keep.sum())
    out["n_per_control"] = float(n / max(d_kept, 1))
    if d_kept == 0 or n < 4 * d_kept:
        out["insufficient_samples"] = True
        for name, (m, se) in plain.items():
            out[name] = {"mean": m, "stderr": se, "plain_mean": m, "plain_stderr": se,
                         "variance_reduction": 1.0}
        return out

    szz = acc.szz[np.ix_(keep, keep)] / n
    szt = acc.szt[keep] / n
    ridge = 1e-9 * np.trace(szz) / d_kept
    beta = np.linalg.solve(szz + ridge * np.eye(d_kept), szt)  # [d, T]
    # E[z] = 0 exactly: the adjusted means subtract beta . mean(z)
    mu_adj = mu_t - beta.T @ acc.mz[keep]
    resid = sigma_tt - szt.T @ beta
    np.fill_diagonal(resid, np.maximum(np.diag(resid), 0.0))

    kept_names = [nm for nm, k in zip(names, keep) if k]
    out["kept_controls"] = kept_names
    for a, name in enumerate(TARGETS[:-1]):
        mean, se = _ratio_stats(mu_adj, resid, a, iv, n)
        pm, pse = plain[name]
        vr = (pse / se) ** 2 if se > 0 and np.isfinite(se) else float("nan")
        out[name] = {"mean": mean, "stderr": se, "plain_mean": pm, "plain_stderr": pse,
                     "variance_reduction": vr,
                     "beta": {nm: float(b) for nm, b in zip(kept_names, beta[:, a])}}
    return out
