"""``jax.random``'s threefry generator in PyTorch, key for key.

The JAX package draws every dispersion from threefry keys (``PRNGKey(seed)``,
``split``, ``fold_in``, ``bits``, ``uniform``, ``normal``, ``randint``) under
JAX's default ``jax_threefry_partitionable=True``. This module computes the
same functions, so that a seed gives the JAX package's lanes on any device:

* keys are ``[..., 2]`` int64 tensors holding the two uint32 words; every
  function takes a batch of keys and returns one result per key, the key
  dimensions leading (the counterpart of ``jax.vmap`` over keys);
* the 32-bit words live in int64 (torch's uint32 has no shifts or additions
  on every backend) and are masked to 32 bits after every add and shift;
* ``threefry2x32`` is the 20-round Threefry-2x32 hash of ``jax/_src/prng.py``;
  ``split(key, shape)`` hashes the 64-bit iota of ``shape`` as (high, low)
  words; ``fold_in(key, d)`` hashes the pair ``(0, d mod 2**32)``; 32-bit
  bits are the two output words XORed, 64-bit bits the high word shifted
  over the low one;
* ``uniform`` puts random mantissa bits under the exponent of 1.0, subtracts
  one, scales, and clamps below at ``minval``; ``normal`` is ``sqrt(2)
  erf_inv(u)`` of a uniform on ``(nextafter(-1, 0), 1)``.

``erf_inv`` is XLA's: Giles' single-precision polynomial in float32 and his
double-precision one in float64, in Horner form with XLA:CPU's fused
multiply-adds (``_fma``). In float32 its ``w = -log1p(-x^2)`` is XLA:CPU's
own ``log1p`` and ``log`` (Cephes' rational and polynomial, ``_log1p_f32``),
so float32 normals are ``jax.random.normal``'s bit for bit but for a few in a
million, which sit an ulp away. In float64 ``log1p`` is torch's and the
product and sum of each Horner step round on their own: within 2e-13
relative (``tests/test_torch_prng.py`` holds both bars).

This module is a frozen copy of the port's plain version of its threefry
kernel (``kernels/threefry.py``) and imports nothing of the port: ``draw``
computes every draw the sampler makes, on any device. Callers draw through
``reference/random.py`` (``split``, ``fold_in``, ``normal`` and the rest).
"""

from __future__ import annotations

import math

import numpy as np
import torch

__all__ = ["threefry2x32", "prng_key", "as_key", "erf_inv", "draw", "KINDS", "M32"]

M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA


def threefry2x32(k1, k2, x1, x2):
    """The Threefry-2x32 hash (20 rounds) of the count words ``(x1, x2)``
    under the key ``(k1, k2)``: int64 tensors of 32-bit words that
    broadcast together. Returns the two output words."""
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    a = (x1 + ks[0]) & M32
    b = (x2 + ks[1]) & M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            a.add_(b).bitwise_and_(M32)
            high = (b << r).bitwise_and_(M32)
            b.bitwise_right_shift_(32 - r).bitwise_or_(high).bitwise_xor_(a)
        a.add_(ks[(i + 1) % 3]).bitwise_and_(M32)
        b.add_(ks[(i + 2) % 3] + (i + 1)).bitwise_and_(M32)
    return a, b


def _shape(shape) -> tuple:
    return (int(shape),) if isinstance(shape, (int, np.integer)) else tuple(int(s) for s in shape)


def as_key(key, device=None) -> torch.Tensor:
    """A key as a ``[..., 2]`` int64 tensor (from a tensor, a NumPy array of
    uint32 words or a pair of ints)."""
    if isinstance(key, torch.Tensor):
        return key.to(device=device if device is not None else key.device, dtype=torch.int64)
    return torch.as_tensor(np.asarray(key, np.int64), device=device)


def prng_key(seed: int, device=None) -> torch.Tensor:
    """``jax.random.PRNGKey(seed)`` for a 64-bit integer seed: the words
    ``[seed >> 32, seed & 0xFFFFFFFF]`` of the seed modulo 2**64."""
    s = int(seed) % 2 ** 64
    key = torch.full((2,), s & M32, dtype=torch.int64, device=device)
    key[:1].fill_(s >> 32)  # filled on the device: no copy from the host, no wait on a card
    return key


def _map_words(key: torch.Tensor, shape: tuple, fn, trailing=()) -> torch.Tensor:
    """``fn(k1, k2, i)`` over the words ``i`` (int64 counts ``[1, c]``) of
    ``shape`` under every key of ``key [..., 2]`` (words ``[r, 1]``), the
    ``[r, c]`` results (with ``trailing`` dimensions) assembled into
    ``[*key.shape[:-1], *shape, *trailing]``. Evaluated piece by piece, each
    a few rows of keys or a run of one key's words."""
    lead, dev = key.shape[:-1], key.device
    keys = key.reshape(-1, 2)
    n_keys, n_words = keys.shape[0], math.prod(shape)
    # words a piece holds: cache-sized on the CPU, where each of a hash's
    # hundred operations is a pass over the piece; on a card, few launches
    piece = 1 << 16 if dev.type == "cpu" else 1 << 24
    parts = []
    if n_words >= piece:
        for r in range(n_keys):
            k1, k2 = keys[r:r + 1, 0:1], keys[r:r + 1, 1:2]
            parts.append(torch.cat([
                fn(k1, k2, torch.arange(j, min(j + piece, n_words), dtype=torch.int64,
                                        device=dev)[None])
                for j in range(0, n_words, piece)], dim=1))
    else:
        i = torch.arange(n_words, dtype=torch.int64, device=dev)[None]
        rows = max(1, piece // max(n_words, 1))
        parts = [fn(keys[r:r + rows, 0:1], keys[r:r + rows, 1:2], i)
                 for r in range(0, n_keys, rows)]
    if not parts:  # no keys
        parts = [fn(keys[:0, 0:1], keys[:0, 1:2], torch.zeros((1, n_words), dtype=torch.int64,
                                                               device=dev))]
    return torch.cat(parts).reshape(lead + shape + trailing)


def _hash(k1, k2, i):
    return threefry2x32(k1, k2, i >> 32, i & M32)


def _keys(key: torch.Tensor, shape: tuple, offset: int = 0) -> torch.Tensor:
    """``threefry2x32(key, iota_2x32_shape(shape) + offset)``'s two words:
    ``split`` (and ``fold_in`` at one word of ``offset``)."""
    return _map_words(key, shape, lambda k1, k2, i: torch.stack(_hash(k1, k2, i + offset), -1),
                      (2,))


def _bits32(k1, k2, i):
    a, b = _hash(k1, k2, i)
    return a.bitwise_xor_(b)


def _bits(key: torch.Tensor, shape: tuple) -> torch.Tensor:
    """32-bit draws as int64 words below 2**32: the hash words XORed."""
    return _map_words(key, shape, _bits32)


def _unit(k1, k2, i, dtype) -> torch.Tensor:
    """Floats in [0, 1): random mantissa bits under 1.0's exponent, minus
    one (a 32-bit draw in float32, the 64-bit ``high << 32 | low`` in
    float64)."""
    if dtype == torch.float32:
        w = _bits32(k1, k2, i).bitwise_right_shift_(9).bitwise_or_(0x3F800000)
        return w.to(torch.int32).view(torch.float32) - 1.0
    if dtype == torch.float64:
        hi, lo = _hash(k1, k2, i)
        w = hi.bitwise_left_shift_(20).bitwise_or_(lo.bitwise_right_shift_(12))
        return w.bitwise_or_(0x3FF0000000000000).view(torch.float64) - 1.0
    raise TypeError(f"uniform draws float32 or float64, got {dtype}")


def _fma(a: torch.Tensor, b, c) -> torch.Tensor:
    """``a * b + c`` rounded once, as XLA:CPU fuses it. In float32 through
    float64, where the product is exact: the one rounding is then exact
    whenever the float64 sum is, as in every draw this package makes. In
    float64 the product and the sum round on their own: the same result
    where the product is exact and the sum too (``minval = 0``, and the
    normal's ``(nextafter(-1, 0), 1)``)."""
    if a.dtype == torch.float32:
        def wide(x):  # a Python number stays one: no copy to the tensor's device
            return x.to(torch.float64) if isinstance(x, torch.Tensor) else float(x)

        return (a.to(torch.float64) * wide(b) + wide(c)).to(torch.float32)
    return a * b + c


def _scaled(f: torch.Tensor, minval, maxval) -> torch.Tensor:
    lo = torch.tensor(minval, dtype=f.dtype, device=f.device)
    hi = torch.tensor(maxval, dtype=f.dtype, device=f.device)
    return torch.maximum(lo, _fma(f, hi - lo, lo))


def _uniform(key: torch.Tensor, shape: tuple, dtype, minval, maxval) -> torch.Tensor:
    return _map_words(key, shape,
                      lambda k1, k2, i: _scaled(_unit(k1, k2, i, dtype), minval, maxval))


# Giles, "Approximating the erfinv function" (GPU Computing Gems, 2011):
# the single-precision branches (w < 5 and w >= 5) and the double-precision
# branches (w < 6.25, w < 16, w >= 16), highest degree first, as XLA
# evaluates them.
_ERFINV_F32 = (
    (2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06, 0.00021858087,
     -0.00125372503, -0.00417768164, 0.246640727, 1.50140941),
    (-0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844, 0.00573950773,
     -0.0076224613, 0.00943887047, 1.00167406, 2.83297682),
)
_ERFINV_F64 = (
    (-3.6444120640178196996e-21, -1.685059138182016589e-19, 1.2858480715256400167e-18,
     1.115787767802518096e-17, -1.333171662854620906e-16, 2.0972767875968561637e-17,
     6.6376381343583238325e-15, -4.0545662729752068639e-14, -8.1519341976054721522e-14,
     2.6335093153082322977e-12, -1.2975133253453532498e-11, -5.4154120542946279317e-11,
     1.051212273321532285e-09, -4.1126339803469836976e-09, -2.9070369957882005086e-08,
     4.2347877827932403518e-07, -1.3654692000834678645e-06, -1.3882523362786468719e-05,
     0.0001867342080340571352, -0.00074070253416626697512, -0.0060336708714301490533,
     0.24015818242558961693, 1.6536545626831027356),
    (2.2137376921775787049e-09, 9.0756561938885390979e-08, -2.7517406297064545428e-07,
     1.8239629214389227755e-08, 1.5027403968909827627e-06, -4.013867526981545969e-06,
     2.9234449089955446044e-06, 1.2475304481671778723e-05, -4.7318229009055733981e-05,
     6.8284851459573175448e-05, 2.4031110387097893999e-05, -0.0003550375203628474796,
     0.00095328937973738049703, -0.0016882755560235047313, 0.0024914420961078508066,
     -0.0037512085075692412107, 0.005370914553590063617, 1.0052589676941592334,
     3.0838856104922207635),
    (-2.7109920616438573243e-11, -2.5556418169965252055e-10, 1.5076572693500548083e-09,
     -3.7894654401267369937e-09, 7.6157012080783393804e-09, -1.4960026627149240478e-08,
     2.9147953450901080826e-08, -6.7711997758452339498e-08, 2.2900482228026654717e-07,
     -9.9298272942317002539e-07, 4.5260625972231537039e-06, -1.9681778105531670567e-05,
     7.5995277030017761139e-05, -0.00021503011930044477347, -0.00013871931833623122026,
     1.0103004648645343977, 4.8499064014085844221),
)


def _horner(w: torch.Tensor, coeffs, dtype) -> torch.Tensor:
    p = torch.full_like(w, coeffs[0])
    for c in coeffs[1:]:
        p = _fma(p, w, torch.tensor(c, dtype=dtype, device=w.device))
    return p


# XLA:CPU's float32 log: Cephes' logf (range reduction to [sqrt(1/2),
# sqrt(2)), a degree-8 polynomial in three fused chains, ln 2 in two parts).
_LOG_P = (7.0376836292e-2, -1.1514610310e-1, 1.1676998740e-1, -1.2420140846e-1,
          1.4249322787e-1, -1.6668057665e-1, 2.0000714765e-1, -2.4999993993e-1,
          3.3333331174e-1)
_LOG_Q1, _LOG_Q2 = -2.12194440e-4, 0.693359375
# XLA's log1p below |y| < sqrt(2) - 1: Cephes' rational, lowest degree last.
_LOG1P_NUM = (4.5270000862445199635215e-5, 4.9854102823193375972212e-1,
              6.5787325942061044846969e0, 2.9911919328553073277375e1,
              6.0949667980987787057556e1, 5.7112963590585538103336e1,
              2.0039553499201281259648e1)
_LOG1P_DEN = (1.0, 1.5062909083469192043167e1, 8.3047565967967209469434e1,
              2.2176239823732856465394e2, 3.0909872225312059774938e2,
              2.1642788614495947685003e2, 6.0118660497603843919306e1)


def _f32(c: float, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(c, dtype=torch.float32, device=like.device)


def _log_f32(x: torch.Tensor) -> torch.Tensor:
    """XLA:CPU's float32 ``log`` for ``x > 0`` (bit for bit on the inputs
    the tests draw)."""
    xi = torch.clamp_min(x, 1.1754943508222875e-38).view(torch.int32)
    e = 1.0 + ((xi >> 23) - 0x7F).to(torch.float32)
    t = ((xi & ~0x7F800000) | 0x3F000000).view(torch.float32)  # mantissa in [0.5, 1)
    below = t < _f32(0.707106781186547524, t)
    e = e - below.to(torch.float32)
    t = (t - 1.0) + torch.where(below, t, torch.zeros_like(t))
    x2 = t * t
    x3 = x2 * t
    p = [_f32(c, t) for c in _LOG_P]
    y = _fma(_fma(t, p[0], p[1]), t, p[2])
    y1 = _fma(_fma(t, p[3], p[4]), t, p[5])
    y2 = _fma(_fma(t, p[6], p[7]), t, p[8])
    y = _fma(_fma(y, x3, y1), x3, y2)
    y = _fma(y, x3, _f32(_LOG_Q1, t) * e)
    t = _fma(_f32(-0.5, t), x2, t) + y
    return _fma(_f32(_LOG_Q2, t), e, t)


def _log1p_f32(y: torch.Tensor) -> torch.Tensor:
    """XLA:CPU's float32 ``log1p`` for ``y > -1``: Cephes' rational below
    ``|y| < sqrt(2) - 1``, ``log(1 + y)`` above."""
    out = _log_f32(1.0 + y)
    small = y.abs() < _f32(0.41421356237309504880, y)
    ys = y[small]
    y2 = ys * ys
    ratio = _horner(ys, _LOG1P_NUM, torch.float32) / _horner(ys, _LOG1P_DEN, torch.float32)
    out[small] = ys + (_f32(-0.5, ys) * y2 + (ys * y2) * ratio)
    return out


def erf_inv(x: torch.Tensor) -> torch.Tensor:
    """XLA's ``erf_inv`` on float32 or float64 ``x`` in (-1, 1) (``+-inf`` at
    ``+-1``)."""
    dtype = x.dtype
    # the first branch on every input, the rarer ones (|x| above about 0.99)
    # on theirs alone
    if dtype == torch.float32:
        w = -_log1p_f32(-(x * x))
        p = _horner(w - 2.5, _ERFINV_F32[0], dtype)
        tail = w >= 5.0
        # a square root rounded once (torch's float32 sqrt is not, on the CPU)
        sw = torch.sqrt(w[tail].to(torch.float64)).to(dtype)
        p[tail] = _horner(sw - 3.0, _ERFINV_F32[1], dtype)
    elif dtype == torch.float64:
        w = -torch.log1p(-x * x)
        p = _horner(w - 3.125, _ERFINV_F64[0], dtype)
        for lo, hi, shift, coeffs in ((6.25, 16.0, 3.25, _ERFINV_F64[1]),
                                      (16.0, math.inf, 5.0, _ERFINV_F64[2])):
            tail = (w >= lo) & (w < hi)
            p[tail] = _horner(torch.sqrt(w[tail]) - shift, coeffs, dtype)
    else:
        raise TypeError(f"erf_inv takes float32 or float64, got {dtype}")
    return torch.where(x.abs() == 1.0, x * math.inf, p * x)


def _normal(key: torch.Tensor, shape: tuple, dtype) -> torch.Tensor:
    npd = np.float32 if dtype == torch.float32 else np.float64
    lo = float(np.nextafter(npd(-1.0), npd(0.0)))
    sqrt2 = torch.tensor(math.sqrt(2.0), dtype=dtype, device=key.device)
    return _map_words(key, shape, lambda k1, k2, i: sqrt2 * erf_inv(
        _scaled(_unit(k1, k2, i, dtype), lo, 1.0)))


def _randint_span(minval: int, maxval: int) -> tuple[int, int]:
    """``(span, multiplier)`` of ``jax.random.randint``'s int32 fold."""
    if not (-2 ** 31 <= minval and maxval <= 2 ** 31 - 1):
        raise ValueError("randint draws int32: bounds outside int32's range")
    span = (maxval - minval) & M32 if maxval > minval else 1
    return span, ((2 ** 16 % span) ** 2 & M32) % span  # uint32 products wrap


def _randint(key: torch.Tensor, shape: tuple, minval: int, maxval: int) -> torch.Tensor:
    span, multiplier = _randint_span(minval, maxval)
    k = _keys(key, (2,))
    higher, lower = _bits(k[..., 0, :], shape), _bits(k[..., 1, :], shape)
    offset = (((higher % span) * multiplier) & M32) + lower % span
    offset = (offset & M32) % span
    return (minval + offset).to(torch.int32)


KINDS = ("keys", "bits", "uniform", "normal", "randint")


def draw(key: torch.Tensor, kind: str, shape=(), *, dtype=torch.float32, lanes=None,
         sub=None, offset: int = 0, minval=0.0, maxval=1.0) -> torch.Tensor:
    """The threefry kernel's plain version, on any device: ``kind``'s draw
    of ``shape`` under every key of ``key [..., 2]``, each key first
    replaced by ``split(key, lanes)[l]`` for every lane ``l`` when ``lanes``
    is given and then by ``split(., 2)[sub]`` when ``sub`` is; word ``m``
    hashes the count ``m + offset``. Returns ``[*key.shape[:-1], (lanes,),
    *shape]`` (with a last dimension of 2 for ``"keys"``); keys and bits as
    int64 words below 2**32, randint as int32."""
    shape = _shape(shape)
    if lanes is not None:
        key = _keys(key, (int(lanes),))
    if sub is not None:
        key = _keys(key, (2,))[..., int(sub), :]
    if kind == "keys":
        return _keys(key, shape, offset)
    if offset:
        raise ValueError("offset applies to keys")
    if kind == "bits":
        return _bits(key, shape)
    if kind == "uniform":
        return _uniform(key, shape, dtype, minval, maxval)
    if kind == "normal":
        return _normal(key, shape, dtype)
    if kind == "randint":
        return _randint(key, shape, int(minval), int(maxval))
    raise ValueError(f"unknown draw kind {kind!r}; one of {sorted(KINDS)}")
