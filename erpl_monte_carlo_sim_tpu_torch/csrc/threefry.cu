// jax.random's threefry draws on the card: keys, bits, uniforms, normals and
// int32 randint under parent keys, with the per-lane key chain of the
// dispersion sampler's wind draw; and that wind draw fused with its AR(1)
// recursion.
//
// It replaces no Pallas kernel. The JAX package draws its Monte Carlo
// dispersions with jax.random (threefry-2x32, jax_threefry_partitionable),
// which XLA runs inside the sampler's jitted program
// (erpl_monte_carlo_sim_tpu/mc/dispersions.py _sample_impl, _build_scene),
// and runs each lane's AR(1) turbulence as a lax.scan vmapped over the lanes
// (erpl_monte_carlo_sim_tpu/models/wind.py _ar1_scan), which XLA fuses. The
// port draws the same lanes from the same seed; this file computes what
// ops/prng.py's plain version and models/wind.py's recursion compute, word
// for word.
//
// Two kernels share the hash and the float conversions.
//
// threefry_kernel (entry threefry_draw): word m under key k hashes the
// 64-bit count (m + offset) as (high, low) words with threefry-2x32 (20
// rounds, the rotations and key schedule of jax/_src/prng.py), and turns the
// two hash words into the output: the words themselves (a split or fold_in
// key), their XOR (32-bit bits), a uniform or normal float, or randint's
// int32. Before that the key may be derived per lane: split(key, lanes)[l]
// and then split(., 2)[sub]. The grid's x dimension walks the key-lanes, so
// no thread divides a 64-bit word index: a block hashes 2048 / words whole
// key-lanes, a thread stepping 256 words at a time and crossing at most one
// key-lane's end a step; below 256 words a key-lane, 256 / words of them,
// one word a thread, each thread finding its key-lane by a float multiply
// that is exact at those sizes; above 2048, one key-lane's 2048-word stretch,
// the grid's y dimension and a stride loop walking the rest. A block derives
// its key-lanes' keys (and randint's two subkeys) once, in parallel, into
// shared memory.
//
// ar1_kernel (entry threefry_ar1): each lane's AR(1) turbulence
//   turb_0 = (vert_c sigma_0) z_0,  turb_i = rho_i turb_{i-1} + (innov_i vert_c) z_i
// in registers, one thread a (lane, component) walking the knots in order,
// with z the lane's standard normals: drawn by the thread itself (word 3i + c
// of normal(key', (N, 3)) under the lane's key key' = split(key, lanes)[b],
// then split(., 2)[sub], as jax.vmap draws the sampler's turbulence), or
// read from a given [n, N, 3] driver. The normals never reach device memory:
// the kernel writes turb [n, N, 3] and nothing else. Each of a lane's three
// threads derives the lane's key itself: 2 hashes beside its 100 (N = 100),
// and no barrier. The constants rho, vert_c sigma_0 and innov_i vert_c come
// from the wrapper in the lane dtype, computed as the eager loop computes
// them, and each product and the sum round apart (-fmad=false), so the
// result is the eager loop's, bit for bit.
//   The output is lane-major, so the threads of a warp, at one knot, hold
// eleven lanes' 12-byte triples 3N values apart: stored as they come, each
// warp store would touch about 11 sectors for 128 bytes. The block (32
// lanes, 96 threads) instead writes kStage knots into shared memory, then
// its warps copy each lane's 3 kStage contiguous values out, a warp a lane
// (150 values in float32: five 128-byte stores). The given-noise mode reads
// its driver the same way in, through the same buffer.
//
// What bounds them: integer operations. A hash compiles to 68 32-bit adds,
// XORs and rotations; a float32 normal adds XLA's log1p and erf_inv
// polynomials (45 float instructions on the shorter branches), and the
// recursion 3, which issue beside them; their 4 bytes of output are a small
// load on memory beside that (kernels/threefry.py bound_ms). What holds the
// AR(1) kernel near 57% of that bound on an H100 is instruction issue: a
// warp's words take both branches of the float32 log1p, about 181 warp
// instructions a word in all (PERF.md).
//
// The float arithmetic is XLA:CPU's, operation for operation, so the card
// gives the JAX package's bits: the build passes -fmad=false, and the fused
// multiply-adds XLA:CPU forms are written out as fmaf/fma. float32 erf_inv is
// Giles' polynomial on w = -log1p(-x^2), with XLA:CPU's log1p (Cephes'
// rational below |y| < sqrt(2) - 1, Cephes' logf of 1 + y above); float64 is
// Giles' double-precision polynomial on CUDA's log1p. Constants are exact
// hex literals of the plain version's float32 roundings.
//
// Why CUDA C++ and not Triton: the kernels are integer hashing with a handful
// of float polynomials and a serial recursion, nothing Triton's block model
// helps with, and they go through the same nvcc build (kernels/threefry.py,
// sm_90a, plain C entries bound with ctypes) and the same compiler check as
// the flight kernel (csrc/flight_summary.cu), while the tests here, which
// have no triton, build this very source with g++ (tests/test_torch_prng.py).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 256;
// words a block of the draw kernel hashes, 8 a thread, where its key-lanes
// are long enough
constexpr long long kBlockWords = 8 * kBlock;
// the draw kernel's largest grid y (CUDA's limit): a key-lane of up to
// kBlockWords times it, about 134M words
constexpr long long kMaxGridY = 65535;

enum Kind { KEYS = 0, BITS = 1, UNIFORM = 2, NORMAL = 3, RANDINT = 4 };

__device__ __forceinline__ uint32_t rotl(uint32_t x, int d) {
  return (x << d) | (x >> (32 - d));
}

template <int R0, int R1, int R2, int R3>
__device__ __forceinline__ void rounds(uint32_t& x0, uint32_t& x1) {
  x0 += x1; x1 = rotl(x1, R0) ^ x0;
  x0 += x1; x1 = rotl(x1, R1) ^ x0;
  x0 += x1; x1 = rotl(x1, R2) ^ x0;
  x0 += x1; x1 = rotl(x1, R3) ^ x0;
}

// threefry2x32 of the count (x0, x1) under the key (k0, k1), whose third
// schedule word is k2 = k0 ^ k1 ^ 0x1BD11BDA, in place.
__device__ __forceinline__ void threefry(uint32_t k0, uint32_t k1, uint32_t k2, uint32_t& x0,
                                         uint32_t& x1) {
  x0 += k0; x1 += k1;
  rounds<13, 15, 26, 6>(x0, x1);
  x0 += k1; x1 += k2 + 1u;
  rounds<17, 29, 16, 24>(x0, x1);
  x0 += k2; x1 += k0 + 2u;
  rounds<13, 15, 26, 6>(x0, x1);
  x0 += k0; x1 += k1 + 3u;
  rounds<17, 29, 16, 24>(x0, x1);
  x0 += k1; x1 += k2 + 4u;
  rounds<13, 15, 26, 6>(x0, x1);
  x0 += k2; x1 += k0 + 5u;
}

__device__ __forceinline__ void threefry(uint32_t k0, uint32_t k1, uint32_t& x0, uint32_t& x1) {
  threefry(k0, k1, k0 ^ k1 ^ 0x1BD11BDAu, x0, x1);
}

// XLA:CPU's float32 log for x > 0 (ops/prng.py _log_f32).
__device__ float log_f32(float x) {
  const int xi = __float_as_int(fmaxf(x, 0x1p-126f));
  float e = 1.0f + static_cast<float>((xi >> 23) - 0x7F);
  float t = __int_as_float((xi & ~0x7F800000) | 0x3F000000);
  const bool below = t < 0x1.6a09e6p-1f;
  e = e - (below ? 1.0f : 0.0f);
  t = (t - 1.0f) + (below ? t : 0.0f);
  const float x2 = t * t;
  const float x3 = x2 * t;
  float y = fmaf(fmaf(t, 0x1.204376p-4f, -0x1.d7a37p-4f), t, 0x1.de4a34p-4f);
  const float y1 = fmaf(fmaf(t, -0x1.fcba9ep-4f, 0x1.23d37ep-3f), t, -0x1.555cap-3f);
  const float y2 = fmaf(fmaf(t, 0x1.999d58p-3f, -0x1.fffff8p-3f), t, 0x1.555554p-2f);
  y = fmaf(fmaf(y, x3, y1), x3, y2);
  y = fmaf(y, x3, -0x1.bd0106p-13f * e);
  t = fmaf(-0.5f, x2, t) + y;
  return fmaf(0x1.63p-1f, e, t);
}

// XLA:CPU's float32 log1p for y > -1 (ops/prng.py _log1p_f32).
__device__ float log1p_f32(float y) {
  if (!(fabsf(y) < 0x1.a8279ap-2f)) return log_f32(1.0f + y);
  float num = 0x1.7bc096p-15f;
  num = fmaf(num, y, 0x1.fe818ap-2f);
  num = fmaf(num, y, 0x1.a509f4p+2f);
  num = fmaf(num, y, 0x1.de9738p+4f);
  num = fmaf(num, y, 0x1.e798ecp+5f);
  num = fmaf(num, y, 0x1.c8e75ap+5f);
  num = fmaf(num, y, 0x1.40a202p+4f);
  float den = 1.0f;
  den = fmaf(den, y, 0x1.e2035ap+3f);
  den = fmaf(den, y, 0x1.4c30b6p+6f);
  den = fmaf(den, y, 0x1.bb865ap+7f);
  den = fmaf(den, y, 0x1.351946p+8f);
  den = fmaf(den, y, 0x1.b0db14p+7f);
  den = fmaf(den, y, 0x1.e0f304p+5f);
  const float y2 = y * y;
  return y + (-0.5f * y2 + (y * y2) * (num / den));
}

__device__ float erf_inv_f32(float x) {
  const float w = -log1p_f32(-(x * x));
  float p;
  if (w < 5.0f) {
    const float v = w - 2.5f;
    p = 0x1.e2cb1p-26f;
    p = fmaf(p, v, 0x1.70966cp-22f);
    p = fmaf(p, v, -0x1.d8e6aep-19f);
    p = fmaf(p, v, -0x1.26b582p-18f);
    p = fmaf(p, v, 0x1.ca65b6p-13f);
    p = fmaf(p, v, -0x1.48a81p-10f);
    p = fmaf(p, v, -0x1.11c9dep-8f);
    p = fmaf(p, v, 0x1.f91ec6p-3f);
    p = fmaf(p, v, 0x1.805c5ep+0f);
  } else {
    const float v = sqrtf(w) - 3.0f;
    p = -0x1.a3e136p-13f;
    p = fmaf(p, v, 0x1.a76ad6p-14f);
    p = fmaf(p, v, 0x1.61b8e4p-10f);
    p = fmaf(p, v, -0x1.e17bcep-9f);
    p = fmaf(p, v, 0x1.7824f6p-8f);
    p = fmaf(p, v, -0x1.f38baep-8f);
    p = fmaf(p, v, 0x1.354afcp-7f);
    p = fmaf(p, v, 0x1.006db6p+0f);
    p = fmaf(p, v, 0x1.6a9efcp+1f);
  }
  return fabsf(x) == 1.0f ? x * __int_as_float(0x7F800000) : p * x;
}

template <int N>
__device__ __forceinline__ double horner(double v, const double (&c)[N]) {
  double p = c[0];
#pragma unroll
  for (int i = 1; i < N; ++i) p = p * v + c[i];
  return p;
}

__device__ double erf_inv_f64(double x) {
  const double a[23] = {
      -3.6444120640178196996e-21, -1.685059138182016589e-19, 1.2858480715256400167e-18,
      1.115787767802518096e-17, -1.333171662854620906e-16, 2.0972767875968561637e-17,
      6.6376381343583238325e-15, -4.0545662729752068639e-14, -8.1519341976054721522e-14,
      2.6335093153082322977e-12, -1.2975133253453532498e-11, -5.4154120542946279317e-11,
      1.051212273321532285e-09, -4.1126339803469836976e-09, -2.9070369957882005086e-08,
      4.2347877827932403518e-07, -1.3654692000834678645e-06, -1.3882523362786468719e-05,
      0.0001867342080340571352, -0.00074070253416626697512, -0.0060336708714301490533,
      0.24015818242558961693, 1.6536545626831027356};
  const double b[19] = {
      2.2137376921775787049e-09, 9.0756561938885390979e-08, -2.7517406297064545428e-07,
      1.8239629214389227755e-08, 1.5027403968909827627e-06, -4.013867526981545969e-06,
      2.9234449089955446044e-06, 1.2475304481671778723e-05, -4.7318229009055733981e-05,
      6.8284851459573175448e-05, 2.4031110387097893999e-05, -0.0003550375203628474796,
      0.00095328937973738049703, -0.0016882755560235047313, 0.0024914420961078508066,
      -0.0037512085075692412107, 0.005370914553590063617, 1.0052589676941592334,
      3.0838856104922207635};
  const double c[17] = {
      -2.7109920616438573243e-11, -2.5556418169965252055e-10, 1.5076572693500548083e-09,
      -3.7894654401267369937e-09, 7.6157012080783393804e-09, -1.4960026627149240478e-08,
      2.9147953450901080826e-08, -6.7711997758452339498e-08, 2.2900482228026654717e-07,
      -9.9298272942317002539e-07, 4.5260625972231537039e-06, -1.9681778105531670567e-05,
      7.5995277030017761139e-05, -0.00021503011930044477347, -0.00013871931833623122026,
      1.0103004648645343977, 4.8499064014085844221};
  const double w = -log1p(-x * x);
  double p;
  if (w < 6.25) {
    p = horner(w - 3.125, a);
  } else if (w < 16.0) {
    p = horner(sqrt(w) - 3.25, b);
  } else {
    p = horner(sqrt(w) - 5.0, c);
  }
  return fabs(x) == 1.0 ? x * __longlong_as_double(0x7FF0000000000000LL) : p * x;
}

// uniform on [lo, hi) from the hash words: mantissa bits under 1.0's exponent,
// minus one, one fused multiply-add (float32; float64 rounds the product and
// the sum apart, as the plain version does), clamped below at lo.
__device__ __forceinline__ float uniform_f32(uint32_t a, uint32_t b, float lo, float span) {
  const float f = __uint_as_float(((a ^ b) >> 9) | 0x3F800000u) - 1.0f;
  return fmaxf(lo, fmaf(f, span, lo));
}

__device__ __forceinline__ double uniform_f64(uint32_t a, uint32_t b, double lo, double span) {
  const unsigned long long w = (static_cast<unsigned long long>(a) << 20) | (b >> 12) |
                               0x3FF0000000000000ULL;
  const double f = __longlong_as_double(static_cast<long long>(w)) - 1.0;
  return fmax(lo, f * span + lo);
}

// The uniform and the normal (sqrt(2) erf_inv of a uniform on (lo, lo +
// span)) of the hash words (a, b) in T, float or double.
template <typename T>
__device__ __forceinline__ T uniform_of(uint32_t a, uint32_t b, double lo, double span) {
  if constexpr (sizeof(T) == 4) {
    return uniform_f32(a, b, static_cast<float>(lo), static_cast<float>(span));
  } else {
    return uniform_f64(a, b, lo, span);
  }
}

template <typename T>
__device__ __forceinline__ T normal_of(uint32_t a, uint32_t b, double lo, double span) {
  if constexpr (sizeof(T) == 4) {
    return 0x1.6a09e6p+0f * erf_inv_f32(uniform_of<float>(a, b, lo, span));
  } else {
    return 0x1.6a09e667f3bcdp+0 * erf_inv_f64(uniform_of<double>(a, b, lo, span));
  }
}

// Key-lane kl's key: keys[kl / lanes], then split(., lanes)[kl % lanes] when
// lanes > 0, then split(., 2)[sub] when sub >= 0. The division runs once a
// key-lane, and only for a batch of parent keys each split into lanes.
__device__ __forceinline__ void lane_key(const uint32_t* keys, long long lanes, int sub,
                                         long long kl, uint32_t& k0, uint32_t& k1) {
  long long k = kl, l = 0;
  if (lanes > 0) {
    k = kl < lanes ? 0 : kl / lanes;
    l = kl - k * lanes;
  }
  k0 = keys[2 * k];
  k1 = keys[2 * k + 1];
  if (lanes > 0) {
    uint32_t x0 = static_cast<uint32_t>(l >> 32), x1 = static_cast<uint32_t>(l);
    threefry(k0, k1, x0, x1);
    k0 = x0; k1 = x1;
  }
  if (sub >= 0) {
    uint32_t x0 = 0u, x1 = static_cast<uint32_t>(sub);
    threefry(k0, k1, x0, x1);
    k0 = x0; k1 = x1;
  }
}

struct Args {
  const uint32_t* keys;  // [n_keys, 2]
  long long n_keys;
  long long lanes;       // > 0: each key becomes split(key, lanes)[l]
  int sub;               // >= 0: then split(., 2)[sub]
  long long words;       // output words per (key, lane)
  long long offset;      // word m hashes the count m + offset
  double lo, span;       // UNIFORM and NORMAL: the range's low end and width
  uint32_t int_span, int_mult;
  int int_min;           // RANDINT
  int per_block;         // whole key-lanes a block (kBlockWords / words), at least 1
  void* out;
};

template <int K, typename T>
__global__ void __launch_bounds__(kBlock) threefry_kernel(Args p) {
  // each of the block's key-lanes' keys; for RANDINT its two subkeys
  __shared__ uint32_t sk[4][kBlock];
  const int t = threadIdx.x;
  const long long n_kl = p.n_keys * (p.lanes > 0 ? p.lanes : 1);
  const long long kl0 = static_cast<long long>(blockIdx.x) * p.per_block;
  if (t < p.per_block && kl0 + t < n_kl) {
    uint32_t k0, k1;
    lane_key(p.keys, p.lanes, p.sub, kl0 + t, k0, k1);
    if (K == RANDINT) {  // split(key): the keys of the high and low draws
      uint32_t h0 = 0u, h1 = 0u, l0 = 0u, l1 = 1u;
      threefry(k0, k1, h0, h1);
      threefry(k0, k1, l0, l1);
      sk[0][t] = h0; sk[1][t] = h1; sk[2][t] = l0; sk[3][t] = l1;
    } else {
      sk[0][t] = k0; sk[1][t] = k1;
    }
  }
  __syncthreads();
  // The thread walks the block's words kBlock * gridDim.y apart, as (j, w):
  // word w of the block's key-lane j. Below kBlock words a key-lane, a
  // thread has one word, its key-lane found by one 32-bit division. From
  // kBlock words on, a step crosses at most one key-lane's end (gridDim.y is
  // 1 while a block holds whole key-lanes; with one key-lane a block, the
  // walk ends at its end).
  int j = 0;
  long long w = static_cast<long long>(blockIdx.y) * kBlock + t;
  if (p.words < kBlock) {
    const uint32_t words = static_cast<uint32_t>(p.words);
    j = static_cast<int>(static_cast<uint32_t>(t) / words);
    w = t - static_cast<long long>(j) * p.words;
  }
  const long long step = static_cast<long long>(kBlock) * gridDim.y;
  const int n_j = n_kl - kl0 < p.per_block ? static_cast<int>(n_kl - kl0) : p.per_block;
  while (j < n_j && w < p.words) {
    const unsigned long long m = static_cast<unsigned long long>(w + p.offset);
    const long long g = (kl0 + j) * p.words + w;
    uint32_t a = static_cast<uint32_t>(m >> 32), b = static_cast<uint32_t>(m);
    threefry(sk[0][j], sk[1][j], a, b);
    if constexpr (K == RANDINT) {
      const uint32_t higher = a ^ b;
      a = static_cast<uint32_t>(m >> 32); b = static_cast<uint32_t>(m);
      threefry(sk[2][j], sk[3][j], a, b);
      const uint32_t lower = a ^ b;
      const uint32_t off = ((higher % p.int_span) * p.int_mult + lower % p.int_span) % p.int_span;
      static_cast<int32_t*>(p.out)[g] = static_cast<int32_t>(static_cast<uint32_t>(p.int_min) + off);
    } else if constexpr (K == KEYS) {
      static_cast<uint32_t*>(p.out)[2 * g] = a;
      static_cast<uint32_t*>(p.out)[2 * g + 1] = b;
    } else if constexpr (K == BITS) {
      static_cast<uint32_t*>(p.out)[g] = a ^ b;
    } else if constexpr (K == UNIFORM) {
      static_cast<T*>(p.out)[g] = uniform_of<T>(a, b, p.lo, p.span);
    } else {
      static_cast<T*>(p.out)[g] = normal_of<T>(a, b, p.lo, p.span);
    }
    w += step;
    if (w >= p.words && p.words >= kBlock) {
      w -= p.words;
      ++j;
    }
  }
}

constexpr int kChainLanes = 32;                 // lanes a block
constexpr int kChainThreads = 3 * kChainLanes;  // one thread a (lane, component)
// knots staged in shared memory between stores: 50 in float32 (a 100-knot
// grid in two stages), 25 in float64, 19,200 bytes a block either way
template <typename T>
constexpr int kStage = sizeof(T) == 4 ? 50 : 25;

struct ChainArgs {
  const uint32_t* keys;  // the chain: [n_keys, 2] parent keys (lanes, sub as in Args)
  long long lanes;
  int sub;
  const void* noise;     // or the given driver [n, N, 3]
  long long n;           // lanes of the output
  int n_knots;
  double lo, span;       // the normal's uniform range
  const void* rho;       // [N]: rho_i
  const void* scale0;    // [3]: vert_c sigma_0
  const void* scale;     // [N, 3]: innov_i vert_c
  void* out;             // [n, N, 3]
};

template <typename T, bool GIVEN>
__global__ void __launch_bounds__(kChainThreads) ar1_kernel(ChainArgs p) {
  constexpr int kStageValues = 3 * kStage<T>;  // a lane's values in a stage
  __shared__ T buf[kChainLanes * kStageValues];
  const int t = threadIdx.x;
  const int l = t / 3, c = t - 3 * l;  // the thread's lane in the block, its component
  const int warp = t >> 5, lane32 = t & 31;
  const long long r0 = static_cast<long long>(blockIdx.x) * kChainLanes;
  const int here = p.n - r0 < kChainLanes ? static_cast<int>(p.n - r0) : kChainLanes;
  const long long row = 3LL * p.n_knots;  // values a lane
  const T* __restrict__ rho = static_cast<const T*>(p.rho);
  const T* __restrict__ scale = static_cast<const T*>(p.scale);
  const T s0 = static_cast<const T*>(p.scale0)[c];
  const T* __restrict__ noise = static_cast<const T*>(p.noise);
  T* __restrict__ out = static_cast<T*>(p.out);
  uint32_t k0 = 0u, k1 = 0u;
  if (!GIVEN) {  // a lane past the end hashes the last lane's key and stores nothing
    lane_key(p.keys, p.lanes, p.sub, r0 + (l < here ? l : here - 1), k0, k1);
  }
  const uint32_t k2 = k0 ^ k1 ^ 0x1BD11BDAu;  // the key schedule's third word, once
  T* const mine = buf + l * kStageValues + c;
  T turb = 0;
  for (int i0 = 0; i0 < p.n_knots; i0 += kStage<T>) {
    const int len = p.n_knots - i0 < kStage<T> ? p.n_knots - i0 : kStage<T>;
    if (GIVEN) {  // this stage's driver in, a warp a lane
      for (int q = warp; q < here; q += kChainThreads / 32) {
        const T* src = noise + (r0 + q) * row + 3LL * i0;
        for (int v = lane32; v < 3 * len; v += 32) buf[q * kStageValues + v] = src[v];
      }
      __syncthreads();
    }
    for (int s = 0; s < len; ++s) {
      const int i = i0 + s;
      // the knot's constants, loaded before the hash, which hides their latency
      const T r = rho[i], sc = scale[3 * i + c];
      T z;
      if (GIVEN) {
        z = mine[3 * s];
      } else {
        uint32_t a = 0u, b = static_cast<uint32_t>(3 * i + c);
        threefry(k0, k1, k2, a, b);
        z = normal_of<T>(a, b, p.lo, p.span);
      }
      const T carried = r * turb;
      const T innov = sc * z;
      turb = i == 0 ? s0 * z : carried + innov;
      mine[3 * s] = turb;
    }
    __syncthreads();
    for (int q = warp; q < here; q += kChainThreads / 32) {  // the stage out, a warp a lane
      T* dst = out + (r0 + q) * row + 3LL * i0;
      for (int v = lane32; v < 3 * len; v += 32) dst[v] = buf[q * kStageValues + v];
    }
    __syncthreads();
  }
}

template <int K, typename T>
int launch(const Args& p, long long n_kl, cudaStream_t stream) {
  const long long bx = (n_kl + p.per_block - 1) / p.per_block;
  // a key-lane longer than a block's words: one a block, its words in y
  const long long by = p.words > kBlockWords ? (p.words + kBlockWords - 1) / kBlockWords : 1;
  if (bx > 0x7FFFFFFFLL || by > kMaxGridY) return -2;
  threefry_kernel<K, T><<<dim3(static_cast<unsigned>(bx), static_cast<unsigned>(by)), kBlock,
                          0, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool GIVEN>
int launch_ar1(const ChainArgs& p, cudaStream_t stream) {
  const long long blocks = (p.n + kChainLanes - 1) / kChainLanes;
  if (blocks > 0x7FFFFFFFLL) return -2;
  ar1_kernel<T, GIVEN><<<dim3(static_cast<unsigned>(blocks)), kChainThreads, 0, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// kind: 0 keys (two uint32 words a word), 1 32-bit bits, 2 uniform, 3 normal,
// 4 int32 randint; f64 picks float64 for kinds 2 and 3. The output holds
// n_keys * max(lanes, 1) * words entries, key-major, then lane, then word.
// Returns the launch's CUDA error (0 on success; -1 an unknown kind, -2 a
// grid too large).
extern "C" int threefry_draw(const void* keys, long long n_keys, long long lanes, int sub,
                             long long words, long long offset, int kind, int f64,
                             double lo, double span, long long int_span, long long int_mult,
                             long long int_min, void* out, void* stream) {
  Args p;
  p.keys = static_cast<const uint32_t*>(keys);
  p.n_keys = n_keys;
  p.lanes = lanes;
  p.sub = sub;
  p.words = words;
  p.offset = offset;
  p.lo = lo;
  p.span = span;
  p.int_span = static_cast<uint32_t>(int_span);
  p.int_mult = static_cast<uint32_t>(int_mult);
  p.int_min = static_cast<int>(int_min);
  const long long per = words < kBlock ? kBlock / (words > 0 ? words : 1) : kBlockWords / words;
  p.per_block = per > 1 ? static_cast<int>(per) : 1;
  p.out = out;
  const long long n_kl = n_keys * (lanes > 0 ? lanes : 1);
  if (n_kl <= 0 || words <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (kind) {
    case KEYS: return launch<KEYS, uint32_t>(p, n_kl, s);
    case BITS: return launch<BITS, uint32_t>(p, n_kl, s);
    case UNIFORM: return f64 ? launch<UNIFORM, double>(p, n_kl, s)
                             : launch<UNIFORM, float>(p, n_kl, s);
    case NORMAL: return f64 ? launch<NORMAL, double>(p, n_kl, s)
                            : launch<NORMAL, float>(p, n_kl, s);
    case RANDINT: return launch<RANDINT, int32_t>(p, n_kl, s);
    default: return -1;
  }
}

// Each of n lanes' AR(1) turbulence over n_knots knots, out [n, n_knots, 3] in
// float64 (f64) or float32, from the constants rho [n_knots], scale0 [3] and
// scale [n_knots, 3] in the same type. The driver: noise [n, n_knots, 3] when
// it is not null; else the normals of the lane chain, lane r under
// keys[r / max(lanes, 1)], then split(., lanes)[r % lanes] when lanes > 0,
// then split(., 2)[sub] when sub >= 0 (n = n_keys * max(lanes, 1)). Returns
// the launch's CUDA error (0 on success; -2 a grid too large).
extern "C" int threefry_ar1(const void* keys, long long lanes, int sub, const void* noise,
                            long long n, long long n_knots, int f64, double lo, double span,
                            const void* rho, const void* scale0, const void* scale, void* out,
                            void* stream) {
  ChainArgs p;
  p.keys = static_cast<const uint32_t*>(keys);
  p.lanes = lanes;
  p.sub = sub;
  p.noise = noise;
  p.n = n;
  p.n_knots = static_cast<int>(n_knots);
  p.lo = lo;
  p.span = span;
  p.rho = rho;
  p.scale0 = scale0;
  p.scale = scale;
  p.out = out;
  if (n <= 0 || n_knots <= 0) return 0;
  if (3 * n_knots > 0x7FFFFFFFLL) return -2;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (noise != nullptr) {
    return f64 ? launch_ar1<double, true>(p, s) : launch_ar1<float, true>(p, s);
  }
  return f64 ? launch_ar1<double, false>(p, s) : launch_ar1<float, false>(p, s);
}

// Threads a block and resident blocks an SM of a kernel, asked of the CUDA
// runtime: which 3 the float32 normal draw (threefry_draw's NORMAL), 5 the
// float32 AR(1) chain, 6 the float32 AR(1) recursion on a given driver.
extern "C" int threefry_occupancy(int which, int* threads, int* blocks) {
  *threads = which >= 5 ? kChainThreads : kBlock;
  switch (which) {
    case NORMAL:
      return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, threefry_kernel<NORMAL, float>,
                                                           kBlock, 0);
    case 5:
      return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, ar1_kernel<float, false>,
                                                           kChainThreads, 0);
    case 6:
      return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, ar1_kernel<float, true>,
                                                           kChainThreads, 0);
    default:
      return -1;
  }
}
