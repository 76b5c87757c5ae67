"""Wrapper of the threefry CUDA kernels ``csrc/threefry.cu``.

The kernels compute ``jax.random``'s draws (``ops/prng.py``) on the card.
One launch of the draw kernel writes every word of one kind of draw under a
batch of keys, and may first derive each lane's key (``split(key,
lanes)[l]``, then ``split(., 2)[sub]``). One launch of the AR(1) kernel
writes each lane's wind turbulence (``models/wind.py``'s recursion): from
the normals of the lane chain, which it draws itself and never stores, or
from a given driver. They replace no Pallas kernel: the JAX package leaves
its threefry draws and its AR(1) ``lax.scan`` to XLA.

``draw`` and ``ar1`` dispatch on where their tensors lie: on the CPU they
run the plain versions (``draw_reference``, ``ops/prng.py``'s ``draw`` in
int64 arithmetic; ``ar1_reference``, that draw and the eager recursion
``ar1_recursion``); on a CUDA device they launch the kernel, or raise. There
is no fallback from one to the other. The draws callers make
(``erpl_monte_carlo_sim_tpu_torch.random``) all come through ``draw``, the
wind model's turbulence through ``ar1``. The kernels are built at first use
with ``nvcc`` for ``sm_90a`` into ``erpl_monte_carlo_sim_tpu_torch/_build/``
(a hash of the source and flags names the library) and bound with
``ctypes``. ``launches`` counts the draw kernel's launches, ``ar1_launches``
the AR(1) kernel's. ``bound_ms`` is the least time an H100 could take for a
draw, ``ar1_bound_ms`` for the AR(1) kernel's work.
"""

from __future__ import annotations

import ctypes
import hashlib
import math
import os

import torch

from ..ops import prng
from .flight_summary import BUILD_DIR, _nvcc, _run

__all__ = ["draw", "draw_reference", "launch_args", "build", "launches", "SOURCE", "KINDS",
           "bound_ms", "ar1", "ar1_reference", "ar1_recursion", "ar1_args", "ar1_launches",
           "ar1_bound_ms", "occupancy"]

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG, "csrc", "threefry.cu")

# kernel launches so far (the counts a run reads to show the kernels ran)
launches = 0
ar1_launches = 0

KINDS = {"keys": 0, "bits": 1, "uniform": 2, "normal": 3, "randint": 4}
_ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
# -fmad=false: only the fused multiply-adds written out as fmaf/fma fuse, as
# in XLA:CPU's evaluation
_FLAGS = ["-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-fmad=false", "-shared"]
_ENTRY_ARGS = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int,
               ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
               ctypes.c_double, ctypes.c_double, ctypes.c_longlong, ctypes.c_longlong,
               ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p]
_AR1_ARGS = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p,
             ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int, ctypes.c_double,
             ctypes.c_double, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_void_p, ctypes.c_void_p]
_lib = None


def _library(verbose: bool) -> tuple[str, list]:
    with open(SOURCE, "rb") as f:
        src = f.read()
    extra = ["-Xptxas", "-v"] if verbose else []
    key = hashlib.sha256(src + " ".join(_ARCH + _FLAGS + extra).encode()).hexdigest()[:16]
    return os.path.join(BUILD_DIR, f"threefry_{key}.so"), extra


def build(verbose: bool = False, start_only: bool = False):
    """Compile the kernel into its hashed library unless it exists. Returns
    ``(library path, compiler log)``; ``verbose`` adds ``-Xptxas -v``
    (registers, spills). ``start_only`` returns a callable that waits for the
    compiler and gives the same pair, so a caller can build it beside other
    kernels."""
    lib, extra = _library(verbose)
    if os.path.exists(lib):
        return (lambda: (lib, "")) if start_only else (lib, "")
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{lib}.{os.getpid()}.tmp"
    proc = _run([_nvcc(), *_ARCH, *_FLAGS, *extra, SOURCE, "-o", tmp])

    def finish():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed (threefry):\n{out}")
        os.replace(tmp, lib)
        return lib, out

    return finish if start_only else finish()


def _load():
    global _lib
    if _lib is None:
        path, _ = build()
        lib = ctypes.CDLL(path)
        lib.threefry_draw.argtypes = _ENTRY_ARGS
        lib.threefry_draw.restype = ctypes.c_int
        lib.threefry_ar1.argtypes = _AR1_ARGS
        lib.threefry_ar1.restype = ctypes.c_int
        lib.threefry_occupancy.argtypes = [ctypes.c_int, ctypes.POINTER(ctypes.c_int),
                                           ctypes.POINTER(ctypes.c_int)]
        lib.threefry_occupancy.restype = ctypes.c_int
        _lib = lib
    return _lib


def _out_shape(key: torch.Tensor, kind: str, shape: tuple, lanes) -> tuple:
    return (tuple(key.shape[:-1]) + ((lanes,) if lanes is not None else ()) + tuple(shape)
            + ((2,) if kind == "keys" else ()))


# the kernel's plain version (``ops/prng.py``), on any device
draw_reference = prng.draw


def launch_args(key: torch.Tensor, kind: str, shape=(), *, dtype=torch.float32, lanes=None,
                sub=None, offset: int = 0, minval=0.0, maxval=1.0) -> tuple:
    """A draw's output tensor and the C entry's arguments but the stream:
    ``(out, keys, args)``, ``keys`` the int32 copy of the key words that
    ``args`` points at (the caller keeps it alive through the launch).
    Checks what the kernel does not take."""
    if kind not in KINDS:
        raise ValueError(f"unknown draw kind {kind!r}; one of {sorted(KINDS)}")
    if offset and kind != "keys":
        raise ValueError("offset applies to keys")
    if kind in ("uniform", "normal") and dtype not in (torch.float32, torch.float64):
        raise TypeError(f"{kind} draws float32 or float64, got {dtype}")
    shape = prng._shape(shape)
    words = math.prod(shape)
    out_shape = _out_shape(key, kind, shape, lanes)
    keys = _key_words(key)
    out_dtype = {"keys": torch.int32, "bits": torch.int32, "randint": torch.int32}.get(kind, dtype)
    out = torch.empty(out_shape, dtype=out_dtype, device=key.device)
    lo = span = 0.0
    int_span = int_mult = 0
    if kind in ("uniform", "normal"):
        lo, span = prng._uniform_range(kind, dtype, minval, maxval)
    if kind == "randint":
        int_span, int_mult = prng._randint_span(int(minval), int(maxval))
    args = (keys.data_ptr(), keys.shape[0], int(lanes) if lanes is not None else 0,
            int(sub) if sub is not None else -1, words, int(offset) & prng.M32, KINDS[kind],
            int(dtype == torch.float64), lo, span, int_span, int_mult,
            int(minval) if kind == "randint" else 0, out.data_ptr())
    return out, keys, args


def _key_words(key: torch.Tensor) -> torch.Tensor:
    """The int32 copy of a key batch's uint32 words, ``[n_keys, 2]``."""
    keys = key.to(torch.int64).reshape(-1, 2)
    return torch.where(keys >= 2 ** 31, keys - 2 ** 32, keys).to(torch.int32).contiguous()


def words_of(kind: str, out: torch.Tensor) -> torch.Tensor:
    """The kernel's output as the plain version gives it: keys and bits as
    int64 words below 2**32."""
    return out.to(torch.int64) & prng.M32 if kind in ("keys", "bits") else out


def draw(key: torch.Tensor, kind: str, shape=(), *, dtype=torch.float32, lanes=None,
         sub=None, offset: int = 0, minval=0.0, maxval=1.0) -> torch.Tensor:
    """``draw_reference``'s draw: the plain version for a CPU key, the
    kernel for a CUDA key."""
    kw = dict(dtype=dtype, lanes=lanes, sub=sub, offset=offset, minval=minval, maxval=maxval)
    if key.device.type == "cpu":
        return draw_reference(key, kind, shape, **kw)
    if key.device.type != "cuda":
        raise ValueError(f"threefry draws on the CPU or a CUDA device, not {key.device}")
    out, keys, args = launch_args(key, kind, shape, **kw)
    fn = _load().threefry_draw
    with torch.cuda.device(key.device):
        rc = fn(*args, torch.cuda.current_stream(key.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"threefry kernel launch failed ({kind}, CUDA error {rc})")
    global launches
    launches += 1
    return words_of(kind, out)


def ar1_recursion(noise: torch.Tensor, rho: torch.Tensor, scale0: torch.Tensor,
                  scale: torch.Tensor) -> torch.Tensor:
    """The AR(1) recursion over the knots of ``noise [..., N, 3]``, eager:
    ``turb_0 = scale0 * z_0``, ``turb_i = rho_i * turb_{i-1} + scale_i *
    z_i``, each product and the sum rounded apart (``models/wind.py``'s
    loop, ``scale0 = vert * sigma_0``, ``scale_i = innov_sigma_i * vert``).
    The AR(1) kernel's plain version on a given driver."""
    turb = scale0 * noise[..., 0, :]
    rows = [turb]
    for i in range(1, noise.shape[-2]):
        turb = rho[i] * turb + scale[i] * noise[..., i, :]
        rows.append(turb)
    return torch.stack(rows, dim=-2)


def ar1_reference(rho: torch.Tensor, scale0: torch.Tensor, scale: torch.Tensor, *,
                  key=None, lanes=None, sub=None, noise=None) -> torch.Tensor:
    """The AR(1) kernel's plain version, on any device: the recursion
    (``ar1_recursion``) on ``noise``, or on the lane chain's normals
    ``draw_reference(key, "normal", (N, 3), lanes=, sub=)`` in the
    constants' dtype."""
    if noise is None:
        noise = draw_reference(key, "normal", (rho.shape[0], 3), dtype=rho.dtype, lanes=lanes,
                               sub=sub)
    return ar1_recursion(noise, rho, scale0, scale)


def ar1_args(rho: torch.Tensor, scale0: torch.Tensor, scale: torch.Tensor, *, key=None,
             lanes=None, sub=None, noise=None) -> tuple:
    """The AR(1) kernel's output tensor and its C entry's arguments but the
    stream: ``(out, keep, args)``, ``keep`` the tensors ``args`` points at
    (the caller keeps them alive through the launch). Checks what the
    kernel does not take."""
    dtype = rho.dtype
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"the AR(1) recursion runs in float32 or float64, got {dtype}")
    n_knots = rho.shape[0]
    if rho.ndim != 1 or tuple(scale0.shape) != (3,) or tuple(scale.shape) != (n_knots, 3):
        raise ValueError(f"AR(1) constants rho [N], scale0 [3], scale [N, 3]; got "
                         f"{tuple(rho.shape)}, {tuple(scale0.shape)}, {tuple(scale.shape)}")
    if scale0.dtype != dtype or scale.dtype != dtype:
        raise TypeError("the AR(1) constants must share one dtype")
    consts = [x.contiguous() for x in (rho, scale0, scale)]
    if noise is not None:
        if noise.dtype != dtype or tuple(noise.shape[-2:]) != (n_knots, 3):
            raise ValueError(f"AR(1) driver [..., {n_knots}, 3] in {dtype}; got "
                             f"{tuple(noise.shape)} in {noise.dtype}")
        lead = tuple(noise.shape[:-2])
        noise = noise.contiguous()
        keys, lanes_arg, sub_arg, noise_ptr = None, 0, -1, noise.data_ptr()
    else:
        lead = tuple(key.shape[:-1]) + ((int(lanes),) if lanes is not None else ())
        keys = _key_words(key)
        lanes_arg = int(lanes) if lanes is not None else 0
        sub_arg = int(sub) if sub is not None else -1
        noise_ptr = None
    dev = consts[0].device
    if any(x.device != dev for x in consts + [t for t in (noise, keys) if t is not None]):
        raise ValueError("the AR(1) constants, key and driver must lie on one device")
    out = torch.empty(lead + (n_knots, 3), dtype=dtype, device=dev)
    lo, span = prng._uniform_range("normal", dtype, 0.0, 1.0)
    args = (keys.data_ptr() if keys is not None else None, lanes_arg, sub_arg, noise_ptr,
            math.prod(lead), n_knots, int(dtype == torch.float64), lo, span,
            consts[0].data_ptr(), consts[1].data_ptr(), consts[2].data_ptr(), out.data_ptr())
    return out, (consts, keys, noise), args


def ar1(rho: torch.Tensor, scale0: torch.Tensor, scale: torch.Tensor, *, key=None,
        lanes=None, sub=None, noise=None) -> torch.Tensor:
    """Each lane's AR(1) turbulence ``[*lead, N, 3]`` from the constants
    ``rho [N]``, ``scale0 [3]`` and ``scale [N, 3]`` (one dtype, float32 or
    float64): driven by ``noise [*lead, N, 3]`` when given, else by the
    lane chain's normals, ``normal(k', (N, 3))`` for every key ``k'`` that
    ``draw(key, ..., lanes=, sub=)`` derives (``lead = [*key.shape[:-1],
    (lanes,)]``). ``ar1_reference`` on the CPU; the kernel on a CUDA device,
    where the normals never reach memory."""
    if key is None and noise is None:
        raise ValueError("the AR(1) recursion needs a key or a driver (noise)")
    where = rho.device
    if where.type == "cpu":
        return ar1_reference(rho, scale0, scale, key=key, lanes=lanes, sub=sub, noise=noise)
    if where.type != "cuda":
        raise ValueError(f"the AR(1) recursion runs on the CPU or a CUDA device, not {where}")
    out, keep, args = ar1_args(rho, scale0, scale, key=key, lanes=lanes, sub=sub, noise=noise)
    fn = _load().threefry_ar1
    with torch.cuda.device(where):
        rc = fn(*args, torch.cuda.current_stream(where).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"AR(1) kernel launch failed (CUDA error {rc})")
    global ar1_launches
    ar1_launches += 1
    return out


def occupancy(which: str) -> tuple[int, int]:
    """``(threads a block, resident blocks an SM)`` of a float32 kernel,
    asked of the CUDA runtime: ``which`` ``"normal"`` (the draw kernel's
    normals), ``"ar1"`` (the chain) or ``"ar1_noise"`` (the recursion on a
    given driver)."""
    code = {"normal": KINDS["normal"], "ar1": 5, "ar1_noise": 6}[which]
    threads, blocks = ctypes.c_int(), ctypes.c_int()
    rc = _load().threefry_occupancy(code, ctypes.byref(threads), ctypes.byref(blocks))
    if rc != 0:
        raise RuntimeError(f"occupancy query failed (CUDA error {rc})")
    return threads.value, blocks.value


# The bound counts the instructions the sm_90a build needs, read from its
# ``cuobjdump -sass`` (``python3 -m erpl_monte_carlo_sim_tpu_torch.kernels.
# measure --draw --sass FILE`` writes the listing). One threefry-2x32 hash is
# 68 integer instructions: 20 rounds of an add, a rotation (one funnel
# shift) and a XOR; the five injections into the second word, one IADD3
# each (the word, the key word and the count); the injections into the
# first word fused into the next round's add (an IADD3), but for the last;
# the first add to the second count word; the third key word (one LOP3).
HASH_INT_OPS = 20 * 3 + 5 + 1 + 1 + 1
# A float32 normal beyond its hash: the XOR of the hash words and the
# mantissa's shift-or (integer); 45 float instructions on the shorter
# branches (the uniform's scale, XLA's log1p by either branch, erf_inv's
# first branch, the sign and sqrt(2)).
NORMAL_F32_INT_OPS = 2
NORMAL_F32_FP_OPS = 45
# The H100 SXM (NVIDIA's data sheet and the CUDA programming guide's
# throughputs for compute capability 9.0): 3.35 TB/s of memory; 132 SMs at
# 1.98 GHz, each issuing 4 warp instructions (128 lanes) a clock, with 64
# lanes of 32-bit integer add, shift, logic and multiply-add and 128 of
# float32 add, multiply and fused multiply-add (the data sheet's 67 TFLOP/s
# counts a fused multiply-add as two). The integer and float pipes issue
# side by side, so their times bound the draw apart, and the issue rate
# bounds their sum.
H100_BYTES_PER_S = 3.35e12
H100_INT32_OPS_PER_S = 64 * 132 * 1.98e9
H100_FP32_OPS_PER_S = 128 * 132 * 1.98e9
H100_ISSUE_PER_S = 128 * 132 * 1.98e9


def bound_ms(words: int, out_bytes: int, hashes_per_word: float = 1.0,
             int_ops_per_word: int = 0, fp_ops_per_word: int = 0) -> tuple[float, str]:
    """The least time an H100 could take to draw ``words`` words of
    ``out_bytes`` each, ``hashes_per_word`` hashes and the other integer and
    float instructions of each word given: the largest of the bytes written
    over the memory rate, the integer instructions over the INT32 rate, the
    float ones over the FP32 rate, and both together over the issue rate.
    Returns ``(ms, "bytes" or "operations")``."""
    int_ops = words * (hashes_per_word * HASH_INT_OPS + int_ops_per_word)
    fp_ops = words * fp_ops_per_word
    t_bytes = words * out_bytes / H100_BYTES_PER_S
    t_ops = max(int_ops / H100_INT32_OPS_PER_S, fp_ops / H100_FP32_OPS_PER_S,
                (int_ops + fp_ops) / H100_ISSUE_PER_S)
    return (max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations")


# The AR(1) recursion beyond the normal: rho_i * turb, scale_i * z and their
# sum, three float instructions a word (-fmad=false keeps them apart).
AR1_FP_OPS = 3


def ar1_bound_ms(lanes: int, n_knots: int, given: bool = False) -> tuple[float, str]:
    """The least time an H100 could take for the AR(1) kernel's float32 work
    on ``lanes`` lanes of ``n_knots`` knots (``bound_ms``'s rates). The
    chain (the sampler's, ``sub`` given): a hash, the normal's integer and
    float instructions and the recursion's for each of the ``3 N`` words of
    a lane, 2 hashes a lane for its key (``split(turb_key, n)[b]``, then
    ``[sub]``), 4 bytes written a word. With ``given``: the recursion alone,
    4 bytes read and 4 written a word. The constants' ``16 N + 12`` bytes
    and the key's 8 are left out: a ten-thousandth of the rest at 262,144
    lanes."""
    words = lanes * n_knots * 3
    if given:
        return bound_ms(words, 8, hashes_per_word=0.0, fp_ops_per_word=AR1_FP_OPS)
    return bound_ms(words, 4, hashes_per_word=1.0 + 2 / (3 * n_knots),
                    int_ops_per_word=NORMAL_F32_INT_OPS,
                    fp_ops_per_word=NORMAL_F32_FP_OPS + AR1_FP_OPS)
