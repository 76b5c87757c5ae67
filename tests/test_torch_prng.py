"""PyTorch port, ``jax.random``'s threefry (``ops/prng.py``) and the threefry
kernel's own source (``csrc/threefry.cu``) against ``jax.random`` on the CPU.

The plain version: keys (``PRNGKey``, ``split``, ``fold_in``), 32-bit bits,
uniforms and int32 ``randint`` bit for bit, for seeds 0, 1 and 2**40 + 7 and
shapes (), (12,) and (5, 100, 3); normals within 2 ulp in float32 (bit for
bit but for a few in a million) and 2e-13 relative in float64; XLA's
``erf_inv`` itself; the sampler's per-lane wind chain against ``jax.vmap``
over ``split(turb_key, n)``; batched keys against ``jax.vmap``. The golden
file chip_smoke.py holds the card's draws to is regenerated from JAX and must
equal the committed one.

The kernel's source is built with g++ against the CPU shim of
tests/test_torch_kernel_emulated.py (a ``std::thread`` per CUDA thread, one
block at a time; ``-ffp-contract=off`` for the kernel's ``-fmad=false``) and
fed through the wrapper's own argument layout (``kernels.threefry
launch_args``): every kind, both chains, a ragged last block and a block
whose words span many lanes, held to the plain version at the same bars.
The CPU's math library stands in for CUDA's, so this checks the kernel's
logic and order of operations; chip_smoke.py phase 17 checks its bits on
the card. It skips without g++.
"""

import ctypes
import math
import re
import shutil
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import (CHAIN_KEPT, NORMAL_F64_RTOL, NORMAL_ULPS, THREEFRY_GOLDEN,
                        threefry_cases, threefry_error, threefry_key)
from erpl_monte_carlo_sim_tpu_torch.kernels import threefry as tf
from erpl_monte_carlo_sim_tpu_torch import random as prandom
from erpl_monte_carlo_sim_tpu_torch.ops import prng

SEEDS = (0, 1, 2**40 + 7)
SHAPES = ((), (12,), (5, 100, 3))
F32, F64 = torch.float32, torch.float64
JDT = {F32: jnp.float32, F64: jnp.float64}


def words(jkey) -> torch.Tensor:
    """A JAX key (or array of keys) as the port's int64 words."""
    return torch.as_tensor(np.asarray(jkey).astype(np.int64))


def ulps32(a, b) -> int:
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return int(np.abs(a.view(np.int32).astype(np.int64) - b.view(np.int32).astype(np.int64))
               .max(initial=0))


def normal_bar(got, want, dtype):
    if dtype == F32:
        assert ulps32(got, want) <= NORMAL_ULPS
    else:
        want = np.asarray(want)
        rel = np.abs(np.asarray(got) - want) / np.maximum(np.abs(want), 1e-300)
        assert rel.max(initial=0.0) <= NORMAL_F64_RTOL


# ------------------------------------------------------------------ plain version
@pytest.mark.parametrize("seed", SEEDS)
def test_keys_and_fold_in_match_jax(seed):
    key = prng.prng_key(seed)
    assert torch.equal(key, words(jax.random.PRNGKey(seed)))
    for d in (0, 1, 2, 2**31 + 3, 2**32 - 1, 0x2B1A5C0):
        assert torch.equal(prandom.fold_in(key, d), words(jax.random.fold_in(
            jax.random.PRNGKey(seed), d))), d


@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("seed", SEEDS)
def test_split_and_bits_match_jax(seed, shape):
    key, jkey = prng.prng_key(seed), jax.random.PRNGKey(seed)
    assert torch.equal(prandom.split(key, shape), words(jax.random.split(jkey, shape)))
    assert torch.equal(prandom.bits(key, shape),
                       words(jax.random.bits(jkey, shape, jnp.uint32)))


@pytest.mark.parametrize("dtype", [F32, F64], ids=["f32", "f64"])
@pytest.mark.parametrize("seed", SEEDS)
def test_uniform_matches_jax(seed, dtype):
    key, jkey = prng.prng_key(seed), jax.random.PRNGKey(seed)
    for shape in SHAPES:
        for lo, hi in ((0.0, 1.0), (0.0, 5.0), (0.0, 2.0 * math.pi)):
            got = prandom.uniform(key, shape, dtype, lo, hi)
            assert got.dtype == dtype
            np.testing.assert_array_equal(
                got.numpy(), np.asarray(jax.random.uniform(jkey, shape, JDT[dtype], lo, hi)))


@pytest.mark.parametrize("dtype", [F32, F64], ids=["f32", "f64"])
@pytest.mark.parametrize("seed", SEEDS)
def test_normal_within_bars(seed, dtype):
    key, jkey = prng.prng_key(seed), jax.random.PRNGKey(seed)
    for shape in SHAPES + ((200_000,),):
        got = prandom.normal(key, shape, dtype).numpy()
        want = np.asarray(jax.random.normal(jkey, shape, JDT[dtype]))
        normal_bar(got, want, dtype)
        if dtype == F32:  # XLA:CPU's own log1p and polynomial: bit for bit nearly always
            assert (got == want).mean() >= 0.9999


def test_erf_inv_is_xla():
    """XLA's erf_inv over the normal's whole input range: bit for bit in
    float32 (its log1p, logf and Giles' polynomial), within the float64
    bar in float64."""
    jkey = jax.random.PRNGKey(11)
    for dtype in (F32, F64):
        lo = np.nextafter(np.array(-1.0, JDT[dtype]), np.array(0.0, JDT[dtype]))
        x = np.asarray(jax.random.uniform(jkey, (500_000,), JDT[dtype], lo, 1.0))
        got = prng.erf_inv(torch.as_tensor(x.copy())).numpy()
        want = np.asarray(jax.lax.erf_inv(jnp.asarray(x)))
        if dtype == F32:
            assert (got == want).mean() >= 0.99999 and ulps32(got, want) <= 1
        else:
            normal_bar(got, want, dtype)


@pytest.mark.parametrize("seed", SEEDS)
def test_randint_matches_jax(seed):
    key, jkey = prng.prng_key(seed), jax.random.PRNGKey(seed)
    for lo, hi in ((0, 3), (0, 1), (-7, 300_000), (5, 5), (-2**31, 2**31 - 1)):
        got = prandom.randint(key, (1000,), lo, hi)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(
            got.numpy(), np.asarray(jax.random.randint(jkey, (1000,), lo, hi, jnp.int32)))


@pytest.mark.parametrize("sub", [1, None], ids=["synthesized", "forecast"])
def test_lane_chain_is_vmapped_jax(sub):
    """``lane_normal``: lane ``b`` under ``split(turb_key, n)[b]`` (then
    ``split(.)[1]`` for a synthesized profile), as the JAX sampler vmaps
    ``generate_stochastic_profile`` / ``perturb_wind_profile``."""
    turb, jturb = prandom.split(prng.prng_key(0), 12)[11], jax.random.split(
        jax.random.PRNGKey(0), 12)[11]

    def lane(k, dtype):
        return jax.random.normal(jax.random.split(k)[1] if sub else k, (100, 3), dtype)

    for dtype in (F32, F64):
        got = prandom.lane_normal(turb, 64, (100, 3), dtype, sub=sub)
        want = jax.vmap(lambda k: lane(k, JDT[dtype]))(jax.random.split(jturb, 64))
        assert got.shape == (64, 100, 3)
        normal_bar(got.numpy(), want, dtype)


def test_batched_keys_are_vmapped_jax():
    keys, jkeys = prandom.split(prng.prng_key(3), (2, 3)), jax.random.split(
        jax.random.PRNGKey(3), (2, 3))
    vm = jax.vmap(jax.vmap(lambda k: jax.random.normal(k, (7,), jnp.float64)))
    normal_bar(prandom.normal(keys, (7,), F64).numpy(), vm(jkeys), F64)
    np.testing.assert_array_equal(prandom.bits(keys, (4,)).numpy(), np.asarray(
        jax.vmap(jax.vmap(lambda k: jax.random.bits(k, (4,), jnp.uint32)))(jkeys)))
    assert torch.equal(prandom.fold_in(keys, 9), words(
        jax.vmap(jax.vmap(lambda k: jax.random.fold_in(k, 9)))(jkeys)))


# ------------------------------------------------------------------ golden
def jax_key(spec):
    what, s = spec
    key = jax.random.PRNGKey(s)
    return jax.random.split(key, 12)[11] if what == "turb" else key


def jax_draw(key, kind, shape, kw):
    """The JAX package's draw of a ``threefry_cases`` case (a chain's kept
    lanes only)."""
    dtype = JDT.get(kw.get("dtype"), jnp.float32)
    if "lanes" in kw:
        lane_keys = jax.random.split(key, kw["lanes"])[np.asarray(CHAIN_KEPT)]
        if kw.get("sub") is not None:
            lane_keys = jax.vmap(lambda k: jax.random.split(k)[kw["sub"]])(lane_keys)
        return jax.vmap(lambda k: jax.random.normal(k, shape, dtype))(lane_keys)
    if kind == "keys":
        return (jax.random.fold_in(key, kw["offset"]) if "offset" in kw
                else jax.random.split(key, shape))
    if kind == "bits":
        return jax.random.bits(key, shape, jnp.uint32)
    if kind == "uniform":
        return jax.random.uniform(key, shape, dtype, kw["minval"], kw["maxval"])
    if kind == "normal":
        return jax.random.normal(key, shape, dtype)
    return jax.random.randint(key, shape, kw["minval"], kw["maxval"], jnp.int32)


def jax_golden() -> dict:
    return {name: np.asarray(jax_draw(jax_key(spec), kind, shape, kw))
            for name, spec, kind, shape, kw in threefry_cases()}


def test_golden_is_live_jax():
    """The committed golden of chip_smoke.py phase 17a is what JAX draws
    now, and the plain version draws it at the bars."""
    live = jax_golden()
    with np.load(THREEFRY_GOLDEN) as z:
        assert sorted(z.files) == sorted(live)
        for name in live:
            np.testing.assert_array_equal(z[name], live[name], err_msg=name)
    for name, spec, kind, shape, kw in threefry_cases():
        if name.startswith("chain"):  # the kept lanes, not all 262,144
            key = prandom.split(threefry_key_cpu(spec), kw["lanes"])[list(CHAIN_KEPT)]
            if kw.get("sub") is not None:
                key = prandom.split(key)[:, kw["sub"]]
            got = prandom.normal(key, shape, kw["dtype"])
        else:
            got = tf.draw_reference(threefry_key_cpu(spec), kind, shape, **kw)
        threefry_error(got, live[name], kind, kw.get("dtype"))


def threefry_key_cpu(spec):
    return threefry_key(spec, "cpu")


# ------------------------------------------------------------------ the kernel's source
INTRINSICS = r"""
#include <stdint.h>
#include <string.h>
inline int __float_as_int(float f) { int i; memcpy(&i, &f, 4); return i; }
inline float __int_as_float(int i) { float f; memcpy(&f, &i, 4); return f; }
inline float __uint_as_float(unsigned u) { float f; memcpy(&f, &u, 4); return f; }
inline double __longlong_as_double(long long i) { double d; memcpy(&d, &i, 8); return d; }
"""

_ENTRY = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int,
          ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_double,
          ctypes.c_double, ctypes.c_longlong, ctypes.c_longlong, ctypes.c_longlong,
          ctypes.c_void_p, ctypes.c_void_p]


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    """``threefry_draw`` of the kernel's source, built for the CPU."""
    from test_torch_kernel_emulated import SHIM

    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to build the kernel's source for the CPU")
    d = tmp_path_factory.mktemp("emulated_threefry")
    (d / "cuda_runtime.h").write_text(SHIM + INTRINSICS)
    with open(tf.SOURCE) as f:
        src = f.read()
    src, n = re.subn(r"(\w+<[^<>]*>)<<<(.*?)>>>\(", r"emu_launch(EMU_CFG(\2), \1, ", src,
                     flags=re.S)
    assert n == 1
    (d / "kernel.cpp").write_text(src.replace("__shared__", "static"))
    lib = d / "threefry.so"
    p = subprocess.run([gxx, "-std=c++17", "-O1", "-ffp-contract=off", "-fPIC", "-shared",
                        f"-I{d}", str(d / "kernel.cpp"), "-o", str(lib), "-lpthread", "-lm"],
                       capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, f"g++ failed:\n{p.stdout}{p.stderr}"
    fn = ctypes.CDLL(str(lib)).threefry_draw
    fn.argtypes, fn.restype = _ENTRY, ctypes.c_int
    return fn


EMULATED = [  # (kind, shape, keyword arguments); keys of PRNGKey(2**40 + 7)
    ("keys", (12,), {}),
    ("keys", (), {"offset": 0x2B1A5C0}),
    ("bits", (5, 100, 3), {}),
    ("uniform", (300,), {"dtype": F32, "minval": 0.0, "maxval": 5.0}),
    ("uniform", (300,), {"dtype": F64, "minval": 0.0, "maxval": 2.0 * math.pi}),
    ("normal", (700,), {"dtype": F32}),
    ("normal", (700,), {"dtype": F64}),
    ("randint", (333,), {"minval": 0, "maxval": 3}),
    ("normal", (100, 3), {"dtype": F32, "lanes": 9, "sub": 1}),
    ("normal", (100, 3), {"dtype": F64, "lanes": 9}),
    ("normal", (), {"dtype": F32, "lanes": 600, "sub": 0}),  # 256 lanes a block
]


@pytest.mark.parametrize("kind,shape,kw", EMULATED,
                         ids=[f"{k}-{'x'.join(map(str, s)) or 'scalar'}-{i}"
                              for i, (k, s, _) in enumerate(EMULATED)])
def test_emulated_kernel_is_plain(emulated, kind, shape, kw):
    """The kernel's source, through the wrapper's arguments, against the
    plain version on two keys at once (the batch of parent keys)."""
    key = prandom.split(prng.prng_key(2**40 + 7), 2)
    out, keys, args = tf.launch_args(key, kind, shape, **kw)
    assert emulated(*args, None) == 0
    got = tf.words_of(kind, out)
    want = tf.draw_reference(key, kind, shape, **kw)
    assert got.shape == want.shape
    threefry_error(got, want, kind, kw.get("dtype"))


def test_wrapper_refuses_what_the_kernel_does_not_take():
    key = prng.prng_key(0)
    with pytest.raises(ValueError, match="unknown draw kind"):
        tf.launch_args(key, "gamma", (3,))
    with pytest.raises(ValueError, match="offset applies to keys"):
        tf.launch_args(key, "bits", (3,), offset=2)
    with pytest.raises(TypeError, match="float32 or float64"):
        tf.launch_args(key, "normal", (3,), dtype=torch.float16)
    with pytest.raises(ValueError, match="CPU or a CUDA device"):
        tf.draw(key.to("meta"), "bits", (3,))


if __name__ == "__main__" and sys.argv[1:] == ["--write-golden"]:
    # regenerate the golden: python tests/test_torch_prng.py --write-golden
    # (from the repository's root, with JAX_ENABLE_X64=1)
    jax.config.update("jax_enable_x64", True)
    np.savez(THREEFRY_GOLDEN, **jax_golden())
