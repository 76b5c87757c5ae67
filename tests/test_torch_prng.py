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

The kernels' source is built with g++ against the CPU shim of
tests/test_torch_kernel_emulated.py (a ``std::thread`` per CUDA thread, one
block at a time, here over a two-dimensional grid; ``-ffp-contract=off`` for
the kernel's ``-fmad=false``) and fed through the wrappers' own argument
layouts (``kernels.threefry launch_args`` and ``ar1_args``): every kind of
draw, both chains, ragged last blocks, blocks that hold one or many
key-lanes and key-lanes that span many blocks, held to the plain version at the same
bars; the AR(1) kernel's fused chain (float32 and float64, ``sub`` 1 and
None) and its recursion on a given driver bit for bit.
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
struct dim3 {
  unsigned x, y, z;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
struct EmuGrid { dim3 grid; int threads; long long smem; void* stream; };
#define EMU_GRID(...) EmuGrid{__VA_ARGS__}
// the shim's launch over a grid of x and y blocks, one block at a time
template <class F, class... A> void emu_grid_launch(EmuGrid c, F f, A... a) {
  blockDim.x = c.threads;
  gridDim.x = c.grid.x;
  gridDim.y = c.grid.y;
  for (unsigned by = 0; by < c.grid.y; ++by)
    for (unsigned bx = 0; bx < c.grid.x; ++bx) {
      EmuBarrier bar(c.threads);
      emu_bar = &bar;
      std::vector<std::thread> ts;
      for (int t = 0; t < c.threads; ++t)
        ts.emplace_back([&, t, bx, by] {
          threadIdx.x = t;
          blockIdx.x = bx;
          blockIdx.y = by;
          f(a...);
        });
      for (auto& th : ts) th.join();
    }
}
"""

@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    """The kernels' source built for the CPU: its library, whose C entries
    take the arguments of ``threefry_draw`` and ``threefry_ar1``."""
    from test_torch_kernel_emulated import SHIM

    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to build the kernel's source for the CPU")
    d = tmp_path_factory.mktemp("emulated_threefry")
    (d / "cuda_runtime.h").write_text(SHIM + INTRINSICS)
    with open(tf.SOURCE) as f:
        src = f.read()
    src, n = re.subn(r"(\w+<[^<>]*>)<<<(.*?)>>>\(", r"emu_grid_launch(EMU_GRID(\2), \1, ",
                     src, flags=re.S)
    assert n == 2  # the source's launches: the draw kernel's and the AR(1) kernel's
    (d / "kernel.cpp").write_text(src.replace("__shared__", "static"))
    lib = d / "threefry.so"
    p = subprocess.run([gxx, "-std=c++17", "-O1", "-ffp-contract=off", "-fPIC", "-shared",
                        f"-I{d}", str(d / "kernel.cpp"), "-o",
                        str(lib), "-lpthread", "-lm"],
                       capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, f"g++ failed:\n{p.stdout}{p.stderr}"
    lib = ctypes.CDLL(str(lib))
    lib.threefry_draw.argtypes, lib.threefry_draw.restype = tf._ENTRY_ARGS, ctypes.c_int
    lib.threefry_ar1.argtypes, lib.threefry_ar1.restype = tf._AR1_ARGS, ctypes.c_int
    return lib


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
    ("uniform", (5,), {"dtype": F64, "minval": 0.0, "maxval": 5.0, "lanes": 60}),  # 51 a block
    ("randint", (7,), {"minval": -7, "maxval": 300_000, "lanes": 5}),
    ("bits", (1500,), {"lanes": 3}),  # one key-lane a block
    ("bits", (5000,), {}),  # key-lanes longer than a block's words: grid y, the stride loop
]


@pytest.mark.parametrize("kind,shape,kw", EMULATED,
                         ids=[f"{k}-{'x'.join(map(str, s)) or 'scalar'}-{i}"
                              for i, (k, s, _) in enumerate(EMULATED)])
def test_emulated_kernel_is_plain(emulated, kind, shape, kw):
    """The kernel's source, through the wrapper's arguments, against the
    plain version on two keys at once (the batch of parent keys)."""
    key = prandom.split(prng.prng_key(2**40 + 7), 2)
    out, keys, args = tf.launch_args(key, kind, shape, **kw)
    assert emulated.threefry_draw(*args, None) == 0
    got = tf.words_of(kind, out)
    want = tf.draw_reference(key, kind, shape, **kw)
    assert got.shape == want.shape
    threefry_error(got, want, kind, kw.get("dtype"))


def test_emulated_draw_refuses_a_key_lane_beyond_the_grid(emulated):
    """A key-lane of more words than the draw kernel's grid y holds (65,535
    blocks of 2,048 words) is refused before any launch, not drawn short."""
    key = prandom.split(prng.prng_key(0), 2)
    out, keys, args = tf.launch_args(key, "bits", (5000,))
    assert emulated.threefry_draw(*args[:4], 2048 * 65535 + 1, *args[5:], None) == -2
    assert emulated.threefry_draw(*args, None) == 0  # the same draw within the grid


def ar1_constants(n_knots, dtype):
    """The wind model's AR(1) constants on an ``n_knots`` grid to 25 km."""
    from erpl_monte_carlo_sim_tpu_torch.models import WindModelParams
    from erpl_monte_carlo_sim_tpu_torch.models.wind import _ar1_constants

    grid = torch.linspace(0.0, 25_000.0, n_knots, dtype=dtype)
    return _ar1_constants(WindModelParams.create("cpu", dtype), grid, dtype)


AR1_CHAINS = [  # (dtype, lanes, sub, parent keys): ragged last blocks of 32 lanes
    (F32, 40, 1, 1), (F32, 20, None, 2), (F64, 33, 1, 1), (F64, 9, None, 1),
]


@pytest.mark.parametrize("dtype,lanes,sub,parents", AR1_CHAINS,
                         ids=[f"{str(d)[6:]}-{n}-sub{s}-keys{k}" for d, n, s, k in AR1_CHAINS])
def test_emulated_ar1_chain_is_plain(emulated, dtype, lanes, sub, parents):
    """The fused chain (each lane's normals drawn and run through the
    recursion in one launch) against its plain version, the draw and the
    eager loop, over 100 knots: bit for bit in float32. In float64 the CPU's
    ``log1p`` stands in for CUDA's, so the chain is held bit for bit to the
    eager loop on the draw kernel's own normals, and those to the plain
    draw at the float64 bar (on the card, chip_smoke phase 17 holds the
    chain to the plain version bit for bit)."""
    key = prandom.split(prng.prng_key(0), 12)[11]
    if parents > 1:  # a batch of parent keys, each split into the lanes
        key = prandom.split(key, parents)
    rho, scale0, scale = ar1_constants(100, dtype)
    out, _, args = tf.ar1_args(rho, scale0, scale, key=key, lanes=lanes, sub=sub)
    assert emulated.threefry_ar1(*args, None) == 0
    assert out.shape == key.shape[:-1] + (lanes, 100, 3)
    if dtype == F32:
        assert torch.equal(out, tf.ar1_reference(rho, scale0, scale, key=key, lanes=lanes,
                                                 sub=sub))
        return
    draw = dict(dtype=dtype, lanes=lanes, sub=sub)
    z, _, draw_args = tf.launch_args(key, "normal", (100, 3), **draw)
    assert emulated.threefry_draw(*draw_args, None) == 0
    assert torch.equal(out, tf.ar1_recursion(z, rho, scale0, scale))
    threefry_error(z, tf.draw_reference(key, "normal", (100, 3), **draw), "normal", dtype)


@pytest.mark.parametrize("dtype,lanes,knots",
                         [(F32, 40, 100), (F32, 33, 61), (F64, 9, 37), (F32, 3, 1)])
def test_emulated_ar1_given_noise_is_plain(emulated, dtype, lanes, knots):
    """The recursion on a given driver (the Sobol, modes and Sobol'-index
    paths'), read through the staging buffer, against the eager loop bit
    for bit."""
    noise = torch.as_tensor(np.random.default_rng(7).normal(size=(lanes, knots, 3))).to(dtype)
    rho, scale0, scale = ar1_constants(knots, dtype)
    out, _, args = tf.ar1_args(rho, scale0, scale, noise=noise)
    assert emulated.threefry_ar1(*args, None) == 0
    assert torch.equal(out, tf.ar1_recursion(noise, rho, scale0, scale))


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
    rho, scale0, scale = ar1_constants(10, F32)
    with pytest.raises(ValueError, match="a key or a driver"):
        tf.ar1(rho, scale0, scale)
    with pytest.raises(TypeError, match="one dtype"):
        tf.ar1_args(rho, scale0.double(), scale, key=key)
    with pytest.raises(ValueError, match=r"driver \[\.\.\., 10, 3\]"):
        tf.ar1_args(rho, scale0, scale, noise=torch.zeros(2, 9, 3))
    with pytest.raises(ValueError, match="CPU or a CUDA device"):
        tf.ar1(rho.to("meta"), scale0.to("meta"), scale.to("meta"), key=key.to("meta"))


if __name__ == "__main__" and sys.argv[1:] == ["--write-golden"]:
    # regenerate the golden: python tests/test_torch_prng.py --write-golden
    # (from the repository's root, with JAX_ENABLE_X64=1)
    jax.config.update("jax_enable_x64", True)
    np.savez(THREEFRY_GOLDEN, **jax_golden())
