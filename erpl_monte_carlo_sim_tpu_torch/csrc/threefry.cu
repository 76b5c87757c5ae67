// jax.random's threefry draws on the card: keys, bits, uniforms, normals and
// int32 randint under parent keys, with the per-lane key chain of the
// dispersion sampler's wind draw.
//
// It replaces no Pallas kernel. The JAX package draws its Monte Carlo
// dispersions with jax.random (threefry-2x32, jax_threefry_partitionable),
// which XLA runs inside the sampler's jitted program
// (erpl_monte_carlo_sim_tpu/mc/dispersions.py _sample_impl, _build_scene).
// The port draws the same lanes from the same seed; this kernel computes
// what ops/prng.py's plain version computes, word for word.
//
// One thread writes one output word. Word m under key k hashes the 64-bit
// count (m + offset) as (high, low) words with threefry-2x32 (20 rounds, the
// rotations and key schedule of jax/_src/prng.py), and turns the two hash
// words into the output: the words themselves (a split or fold_in key), their
// XOR (32-bit bits), a uniform or normal float, or randint's int32. Before
// that the key may be derived per lane: split(key, lanes)[l] and then
// split(., 2)[sub], the chain jax.vmap gives the wind draw
// (split(turb_key, n)[b], split(.)[1], normal(., (N, 3))). A block first
// derives the few lane keys its 256 words need into shared memory (at most
// 256), so a lane's key costs its two hashes once per block, not once per
// word.
//
// What bounds it: integer operations. A hash compiles to 68 32-bit adds,
// XORs and rotations; a float32 normal adds XLA's log1p and erf_inv
// polynomials (45 float instructions on the shorter branches), which issue
// beside them, and its 4 bytes of output are a small load on memory beside
// that (kernels/threefry.py bound_ms).
//
// The float arithmetic is XLA:CPU's, operation for operation, so the card
// gives the JAX package's bits: the build passes -fmad=false, and the fused
// multiply-adds XLA:CPU forms are written out as fmaf/fma. float32 erf_inv is
// Giles' polynomial on w = -log1p(-x^2), with XLA:CPU's log1p (Cephes'
// rational below |y| < sqrt(2) - 1, Cephes' logf of 1 + y above); float64 is
// Giles' double-precision polynomial on CUDA's log1p. Constants are exact
// hex literals of the plain version's float32 roundings.
//
// Why CUDA C++ and not Triton: the kernel is integer hashing with a handful
// of float polynomials, nothing Triton's block model helps with, and it goes
// through the same nvcc build (kernels/threefry.py, sm_90a, plain C entry
// bound with ctypes) and the same compiler check as the flight kernel
// (csrc/flight_summary.cu), while the tests here, which have no triton, build
// this very source with g++ (tests/test_torch_prng.py).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 256;

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

// threefry2x32 of the count (x0, x1) under the key (k0, k1), in place.
__device__ __forceinline__ void threefry(uint32_t k0, uint32_t k1, uint32_t& x0,
                                         uint32_t& x1) {
  const uint32_t k2 = k0 ^ k1 ^ 0x1BD11BDAu;
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
  void* out;
};

template <int K, typename T>
__global__ void __launch_bounds__(kBlock) threefry_kernel(Args p) {
  __shared__ uint32_t sk0[kBlock], sk1[kBlock];
  const long long per_key = p.lanes > 0 ? p.lanes : 1;
  const long long total = p.n_keys * per_key * p.words;
  const long long g0 = static_cast<long long>(blockIdx.x) * kBlock;
  const long long g = g0 + threadIdx.x;
  const long long kl0 = g0 / p.words;
  const long long g_end = g0 + kBlock < total ? g0 + kBlock : total;
  const int n_kl = static_cast<int>((g_end - 1) / p.words - kl0 + 1);
  if (static_cast<int>(threadIdx.x) < n_kl) {
    const long long kl = kl0 + threadIdx.x;
    const long long k = kl / per_key, l = kl % per_key;
    uint32_t k0 = p.keys[2 * k], k1 = p.keys[2 * k + 1];
    if (p.lanes > 0) {
      uint32_t x0 = static_cast<uint32_t>(l >> 32), x1 = static_cast<uint32_t>(l);
      threefry(k0, k1, x0, x1);
      k0 = x0; k1 = x1;
    }
    if (p.sub >= 0) {
      uint32_t x0 = 0u, x1 = static_cast<uint32_t>(p.sub);
      threefry(k0, k1, x0, x1);
      k0 = x0; k1 = x1;
    }
    sk0[threadIdx.x] = k0;
    sk1[threadIdx.x] = k1;
  }
  __syncthreads();
  if (g >= total) return;
  const long long kl = g / p.words;
  const unsigned long long m = static_cast<unsigned long long>(g - kl * p.words + p.offset);
  uint32_t k0 = sk0[kl - kl0], k1 = sk1[kl - kl0];
  if (K == RANDINT) {  // split(key): the two keys of the high and low draws
    uint32_t h0 = 0u, h1 = 0u, l0 = 0u, l1 = 1u;
    threefry(k0, k1, h0, h1);
    threefry(k0, k1, l0, l1);
    uint32_t a = static_cast<uint32_t>(m >> 32), b = static_cast<uint32_t>(m);
    threefry(h0, h1, a, b);
    const uint32_t higher = a ^ b;
    a = static_cast<uint32_t>(m >> 32); b = static_cast<uint32_t>(m);
    threefry(l0, l1, a, b);
    const uint32_t lower = a ^ b;
    const uint32_t off = ((higher % p.int_span) * p.int_mult + lower % p.int_span) % p.int_span;
    static_cast<int32_t*>(p.out)[g] = static_cast<int32_t>(static_cast<uint32_t>(p.int_min) + off);
    return;
  }
  uint32_t a = static_cast<uint32_t>(m >> 32), b = static_cast<uint32_t>(m);
  threefry(k0, k1, a, b);
  if (K == KEYS) {
    static_cast<uint32_t*>(p.out)[2 * g] = a;
    static_cast<uint32_t*>(p.out)[2 * g + 1] = b;
  } else if (K == BITS) {
    static_cast<uint32_t*>(p.out)[g] = a ^ b;
  } else if (sizeof(T) == 4) {
    const float u = uniform_f32(a, b, static_cast<float>(p.lo), static_cast<float>(p.span));
    static_cast<float*>(p.out)[g] = K == NORMAL ? 0x1.6a09e6p+0f * erf_inv_f32(u) : u;
  } else {
    const double u = uniform_f64(a, b, p.lo, p.span);
    static_cast<double*>(p.out)[g] = K == NORMAL ? 0x1.6a09e667f3bcdp+0 * erf_inv_f64(u) : u;
  }
}

template <int K, typename T>
int launch(const Args& p, long long total, cudaStream_t stream) {
  const long long blocks = (total + kBlock - 1) / kBlock;
  threefry_kernel<K, T><<<static_cast<unsigned>(blocks), kBlock, 0, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// kind: 0 keys (two uint32 words a word), 1 32-bit bits, 2 uniform, 3 normal,
// 4 int32 randint; f64 picks float64 for kinds 2 and 3. The output holds
// n_keys * max(lanes, 1) * words entries, key-major, then lane, then word.
// Returns the launch's CUDA error (0 on success).
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
  p.out = out;
  const long long total = n_keys * (lanes > 0 ? lanes : 1) * words;
  if (total <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (kind) {
    case KEYS: return launch<KEYS, uint32_t>(p, total, s);
    case BITS: return launch<BITS, uint32_t>(p, total, s);
    case UNIFORM: return f64 ? launch<UNIFORM, double>(p, total, s)
                             : launch<UNIFORM, float>(p, total, s);
    case NORMAL: return f64 ? launch<NORMAL, double>(p, total, s)
                            : launch<NORMAL, float>(p, total, s);
    case RANDINT: return launch<RANDINT, int32_t>(p, total, s);
    default: return -1;
  }
}
