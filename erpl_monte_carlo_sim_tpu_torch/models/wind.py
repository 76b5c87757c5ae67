"""Wind tables and AR(1) turbulence (``erpl_monte_carlo_sim_tpu/models/wind.py``).

A wind field is ``(altitudes[N], wind[..., N, 3])``: a shared ``[N, 3]``
table or one ``[B, N, 3]`` table per Monte Carlo lane on a shared grid. The
profile generators take a threefry key (``random``, ``[..., 2]``: one per
profile) and draw the AR(1) recursion's standard normals under it as the JAX
package does, or take that ``[..., N, 3]`` driver as ``noise`` (the key may
then be None). Any leading batch dimensions broadcast, so a whole Monte
Carlo batch of profiles is one call.

Constants: sigma = 2 m/s decaying exp(-h/2000), correlation exp(-dh/100)
clipped to [0.1, 0.95], innovation sigma*sqrt(max(1-rho^2, 0.01)),
vertical x0.3.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from .. import random
from ..ops.interp import interpolate_vec
from ..utils.tree import default_dtype, materialize

__all__ = ["WindField", "WindModelParams", "WindModes", "wind_at_altitude", "power_law_profile",
           "generate_stochastic_profile", "perturb_wind_profile", "ar1_transfer_matrix",
           "wind_mode_basis", "compress_wind", "expand_modes", "load_wind_profile_from_csv",
           "load_wind_ensemble_from_csvs"]


@dataclasses.dataclass(frozen=True)
class WindField:
    """``altitudes[N]`` ascending, ``wind[N, 3]`` shared or ``[B, N, 3]``."""

    altitudes: torch.Tensor
    wind: torch.Tensor

    @classmethod
    def zero(cls, device, dtype=torch.float32) -> "WindField":
        """No wind: a degenerate 2-point zero table."""
        return cls(altitudes=torch.tensor([0.0, 1.0], dtype=dtype, device=device),
                   wind=torch.zeros((2, 3), dtype=dtype, device=device))

    @classmethod
    def from_arrays(cls, altitudes, wind, device, dtype=None) -> "WindField":
        """A field from host arrays (``load_wind_profile_from_csv``'s), on
        ``device`` in ``dtype`` (``utils.tree.default_dtype``)."""
        dtype = default_dtype(device, dtype)
        return cls(altitudes=torch.as_tensor(np.asarray(altitudes), dtype=dtype, device=device),
                   wind=torch.as_tensor(np.asarray(wind), dtype=dtype, device=device))


@dataclasses.dataclass(frozen=True)
class WindModelParams:
    power_law_exponent: torch.Tensor = 0.14
    turbulence_intensity: torch.Tensor = 2.0  # m/s
    correlation_length: torch.Tensor = 100.0  # m

    @classmethod
    def create(cls, device, dtype=None) -> "WindModelParams":
        return materialize(cls(), device, dtype)


def wind_at_altitude(field: WindField, altitude) -> torch.Tensor:
    """The interpolated ``[..., 3]`` wind of ``field`` at ``altitude``."""
    return interpolate_vec(altitude, field.altitudes, field.wind)


def power_law_profile(p: WindModelParams, altitude, reference_wind_speed,
                      reference_altitude=10.0) -> torch.Tensor:
    return reference_wind_speed * (altitude / reference_altitude) ** p.power_law_exponent


_VERTICAL = (1.0, 1.0, 0.3)


def _ar1_constants(p: WindModelParams, altitudes, dtype):
    """The recursion's constants on ``altitudes``' device: ``rho [N]``,
    ``vert * sigma_0 [3]`` and ``innov_sigma_i * vert [N, 3]``, each rounded
    as the eager loop rounds it (``kernels.threefry.ar1_recursion``)."""
    sigma = p.turbulence_intensity * torch.exp(-altitudes / 2000.0)
    dh = torch.clamp_min(torch.diff(altitudes, prepend=altitudes[:1]), 1e-6)
    rho = torch.clamp(torch.exp(-dh / p.correlation_length), 0.1, 0.95)
    innov_sigma = sigma * torch.sqrt(torch.clamp_min(1.0 - rho * rho, 0.01))
    vert = torch.ones(3, dtype=dtype, device=altitudes.device)
    vert[2:].fill_(_VERTICAL[2])  # filled on the device: no copy from the host
    return rho, vert * sigma[0], innov_sigma[:, None] * vert


def _ar1_scan(p: WindModelParams, key, altitudes, mean_uv, mean_w=None, noise=None,
              lanes=None, sub=None):
    """AR(1) turbulence over the grid ``altitudes[N]`` added to the mean wind.

    ``mean_uv [..., N, 2]``, ``mean_w [..., N]`` (zero when None), ``noise``
    ``[..., N, 3]`` standard normals (``normal(key, (N, 3))`` for each key of
    ``key [..., 2]`` when None). ``lanes`` and ``sub``: ``key`` is the
    parent of a lane chain, lane ``b`` driven by ``normal(split(key,
    lanes)[b], (N, 3))`` (after ``split(., 2)[sub]``), the sampler's
    ``jax.vmap`` over ``split(turb_key, n)``. Returns ``[..., N, 3]``. The
    turbulence is ``kernels.threefry.ar1``'s: the eager loop on the CPU, one
    launch on a card, where a drawn driver never reaches memory."""
    from ..kernels import threefry  # here: the kernel's module pulls in the engine

    dtype, device = mean_uv.dtype, mean_uv.device
    if mean_w is None:
        mean_w = torch.zeros(mean_uv.shape[:-1], dtype=dtype, device=device)
    rho, scale0, scale = _ar1_constants(p, altitudes, dtype)
    if noise is not None:
        noise = torch.as_tensor(noise, dtype=dtype, device=device)
    elif key is not None:
        key = random.as_key(key, device)
    turb = threefry.ar1(rho, scale0, scale, key=key, lanes=lanes, sub=sub, noise=noise)
    mean = torch.cat([mean_uv, mean_w[..., None]], dim=-1)
    return mean + turb


def generate_stochastic_profile(p: WindModelParams, key, altitudes, base_wind_speed,
                                base_wind_direction=None, noise=None) -> torch.Tensor:
    """Power-law shear along ``base_wind_direction`` plus AR(1) turbulence,
    under ``dir_key, turb_key = split(key)`` as the JAX package splits it:
    the direction uniform on [0, 2 pi) under ``dir_key`` when None (in
    float64, ``jax.random.uniform``'s default under x64, then the grid's
    dtype), the turbulence under ``turb_key`` unless ``noise`` is given.
    ``key [..., 2]``, ``base_wind_speed`` and ``base_wind_direction`` may
    carry leading batch dims; returns ``[..., N, 3]``."""
    device = altitudes.device
    if key is None:
        if base_wind_direction is None or noise is None:
            raise ValueError("generate_stochastic_profile draws: it needs a key")
        turb_key = None
    else:
        dir_key, turb_key = random.split(random.as_key(key, device)).unbind(-2)
    if base_wind_direction is None:
        base_wind_direction = random.uniform(dir_key, (), torch.float64, 0.0, 2.0 * math.pi)
    return _stochastic_profile(p, altitudes, base_wind_speed, base_wind_direction,
                               turb_key, noise=noise)


def _stochastic_profile(p: WindModelParams, altitudes, base_wind_speed, base_wind_direction,
                        turb_key=None, noise=None, lanes=None, sub=None) -> torch.Tensor:
    """``generate_stochastic_profile`` with its direction given and its
    turbulence under ``turb_key`` (or ``noise``); ``lanes`` and ``sub``
    make ``turb_key`` the parent of a lane chain (``_ar1_scan``): the
    sampler's route, which on a card never stores the normals."""
    dtype, device = altitudes.dtype, altitudes.device
    speed_in = torch.as_tensor(base_wind_speed, dtype=dtype, device=device)
    direction = torch.as_tensor(base_wind_direction, device=device).to(dtype)
    speed = power_law_profile(p, altitudes, speed_in[..., None])
    mean_uv = torch.stack([speed * torch.cos(direction)[..., None],
                           speed * torch.sin(direction)[..., None]], dim=-1)
    return _ar1_scan(p, turb_key, altitudes, mean_uv, noise=noise, lanes=lanes, sub=sub)


def perturb_wind_profile(p: WindModelParams, key, altitudes, base_profile,
                         noise=None) -> torch.Tensor:
    """AR(1) turbulence under ``key`` (unless ``noise`` is given) around a
    forecast ``base_profile [..., N, 3]``; all three components keep their
    forecast mean."""
    return _perturbed_profile(p, key, altitudes, base_profile, noise=noise)


def _perturbed_profile(p: WindModelParams, key, altitudes, base_profile, noise=None,
                       lanes=None, sub=None) -> torch.Tensor:
    """``perturb_wind_profile``; ``lanes`` and ``sub`` make ``key`` the
    parent of a lane chain (``_ar1_scan``), the sampler's route."""
    base_profile = torch.as_tensor(base_profile, dtype=altitudes.dtype,
                                   device=altitudes.device)
    if noise is not None:
        base_profile = torch.broadcast_to(
            base_profile, torch.as_tensor(noise).shape)
    return _ar1_scan(p, key, altitudes, base_profile[..., :2],
                     mean_w=base_profile[..., 2], noise=noise, lanes=lanes, sub=sub)


def ar1_transfer_matrix(p: WindModelParams, altitudes) -> np.ndarray:
    """The lower-triangular ``[N, N]`` map ``A`` with ``turb_horizontal = A @
    z`` for ``_ar1_scan``'s recursion (host NumPy, float64; the vertical
    component is ``0.3 A``): ``A[i, j] = s_j prod_{m=j+1..i} rho_m`` with
    ``s_0 = sigma_0`` and ``s_j`` the innovation sigma after. Its right
    singular vectors order the turbulence's directions by variance
    (``mc.dispersions``' Sobol wind modes). It mirrors ``_ar1_scan``'s
    constants: the sigma decay, the prepended ``dh``, the clip of ``rho``
    and the innovation floor."""
    alt = np.asarray(altitudes, np.float64)
    ti = float(p.turbulence_intensity)
    cl = float(p.correlation_length)
    sigma = ti * np.exp(-alt / 2000.0)
    dh = np.maximum(np.diff(alt, prepend=alt[:1]), 1e-6)
    rho = np.clip(np.exp(-dh / cl), 0.1, 0.95)
    innov = sigma * np.sqrt(np.maximum(1.0 - rho**2, 0.01))
    s_ = innov.copy()
    s_[0] = sigma[0]
    # prod_{m=j+1..i} rho_m = exp(logp[i] - logp[j]), logp[i] = sum_{1<=m<=i} log rho_m
    logp = np.concatenate([[0.0], np.cumsum(np.log(rho[1:]))])
    ratio = np.exp(logp[:, None] - logp[None, :])
    return np.tril(ratio * s_[None, :])


@dataclasses.dataclass(frozen=True)
class WindModes:
    """Mode-compressed per-lane wind tables: ``altitudes [N]`` (the shared
    grid), ``basis [N, M]`` (shared orthonormal columns, ``wind_mode_basis``)
    and ``scores [B, M, 3]``, each lane's per-component mode scores. A
    lane's table is ``basis @ scores[b]``; it is exact when ``M = N`` and
    otherwise drops the turbulence outside the basis's span.

    The JAX package queries the modes in flight (``sum_m Q_m(h) scores[m,
    c]``, with ``Q_m(h)`` the tent-interpolated basis row), which cuts a
    TPU lane's wind reads from 3N to 3M values. On the card the flight
    kernel reads two knots a component by segment index, so the port
    expands the scores to a table once a call (``expand_modes``) and flies
    that: modes save no bytes there, and the expansion rebuilds the
    ``[B, N, 3]`` table. The CPU's plain version evaluates the JAX
    package's query (``engine.component.modes_wind_fn``)."""

    altitudes: torch.Tensor
    basis: torch.Tensor
    scores: torch.Tensor


def wind_mode_basis(p: WindModelParams, altitudes, k: int, extra_profiles=None) -> np.ndarray:
    """The shared ``[N, M]`` orthonormal basis of ``WindModes`` (host NumPy,
    float64). Columns in order: a constant column (the speed and direction
    offsets), the power-law shear shape, each nonzero component profile of
    ``extra_profiles`` (a forecast ``[N, 3]`` or an ensemble ``[K, N, 3]``),
    then the top ``k`` left singular vectors of ``ar1_transfer_matrix``.
    Modified Gram-Schmidt drops the columns that depend on earlier ones, so
    the mean structure is captured exactly at any ``k`` and a projection is
    a transposed product."""
    alt = np.asarray(altitudes, np.float64)
    n = alt.shape[0]
    k = int(min(max(k, 0), n))
    cols = [np.ones(n)]
    cols.append(np.maximum(alt / 10.0, 0.0) ** float(p.power_law_exponent))
    if extra_profiles is not None:
        prof = np.asarray(extra_profiles, np.float64)
        if prof.ndim == 2:
            prof = prof[None]
        for member in prof:
            for c in range(member.shape[1]):
                col = member[:, c]
                if np.abs(col).max() > 0.0:
                    cols.append(col)
    if k > 0:
        u_svd, _, _ = np.linalg.svd(ar1_transfer_matrix(p, alt))
        cols.extend(u_svd[:, :k].T)
    q_cols = []
    for col in cols:
        v = col.astype(np.float64).copy()
        for q in q_cols:
            v -= (q @ v) * q
        nrm = np.linalg.norm(v)
        if nrm > 1e-10 * max(np.linalg.norm(col), 1.0):
            q_cols.append(v / nrm)
        if len(q_cols) >= n:
            break
    return np.stack(q_cols, axis=1)


def compress_wind(field: WindField, basis) -> WindModes:
    """Project per-lane tables ``[B, N, 3]`` onto ``basis [N, M]``:
    ``scores = einsum('nm,bnc->bmc', Q, wind)``. The product is formed in
    float64 and rounded once to the tables' dtype, so a float32 product on
    a card never runs in TF32. A shared ``[N, 3]`` table is refused: it is
    one broadcast table already."""
    wind = field.wind
    if wind.ndim != 3:
        raise ValueError("compress_wind needs a per-lane [B,N,3] table; shared tables "
                         "are already cheap (broadcast lane axis)")
    q = torch.as_tensor(basis, device=wind.device)
    scores = torch.einsum("nm,bnc->bmc", q.to(torch.float64), wind.to(torch.float64))
    return WindModes(altitudes=field.altitudes, basis=q.to(wind.dtype),
                     scores=scores.to(wind.dtype))


def expand_modes(basis: torch.Tensor, scores: torch.Tensor, dtype=None) -> torch.Tensor:
    """Each lane's table ``[B, N, 3]``: ``table[b, n, c] = sum_m basis[n, m]
    scores[b, m, c]``, in ``dtype`` (default the scores'). The sum is formed
    in float64, one mode at a time in column order with a separate multiply
    and add, and rounded once: every element depends on its own lane alone
    and has the same bits whatever the batch, so a lane flown again expands
    to the table it flew."""
    dtype = scores.dtype if dtype is None else dtype
    q = basis.to(torch.float64)
    s = scores.to(torch.float64)
    table = torch.zeros((s.shape[0], q.shape[0], s.shape[2]), dtype=torch.float64,
                        device=s.device)
    for m in range(q.shape[1]):
        table += q[None, :, m, None] * s[:, None, m, :]
    return table.to(dtype)


def load_wind_profile_from_csv(file_path: str):
    """Load an ``altitude,u,v[,w]`` CSV forecast: host NumPy arrays
    ``(altitudes [N], wind [N, 3])`` for ``WindField.from_arrays`` or the
    analyzer's ``base_altitude_profile`` / ``base_wind_profile`` (a missing
    ``w`` column is zero)."""
    data = np.genfromtxt(file_path, delimiter=",", names=True)
    altitudes = np.atleast_1d(data["altitude"])
    if "w" in data.dtype.names:
        wind = np.vstack([data["u"], data["v"], data["w"]]).T
    else:
        wind = np.vstack([data["u"], data["v"], np.zeros_like(altitudes)]).T
    return altitudes, wind


def load_wind_ensemble_from_csvs(file_paths):
    """A forecast ensemble from one CSV per member (``load_wind_profile_from_csv``'s
    format) on the first member's altitude grid: the other members are
    interpolated onto it per component, clamped at the ends. Returns host
    arrays ``(altitudes [N], wind [K, N, 3])`` for the analyzer's
    ``base_altitude_profile`` / ``base_wind_profile``; each Monte Carlo lane
    then perturbs a uniformly drawn member."""
    paths = list(file_paths)
    if not paths:
        raise ValueError("need at least one ensemble member CSV")
    grid, first = load_wind_profile_from_csv(paths[0])
    members = [first]
    for path in paths[1:]:
        alts, wind = load_wind_profile_from_csv(path)
        members.append(np.stack([np.interp(grid, alts, wind[:, c]) for c in range(3)], axis=1))
    return grid, np.stack(members, axis=0)
