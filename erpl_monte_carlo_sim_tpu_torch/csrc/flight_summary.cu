// Whole-flight Monte Carlo summary kernel for Hopper (sm_90a), one thread per lane.
//
// Replaces the two Pallas TPU kernels of the JAX package:
//   * erpl_monte_carlo_sim_tpu/experimental/pallas_component.py
//     (simulate_summary_component, pl.pallas_call at :186), and
//   * erpl_monte_carlo_sim_tpu/experimental/pallas_kernel.py
//     (simulate_summary_pallas, pl.pallas_call at :217).
// Both compute the flight of engine/component.py:flight_components: Euler ->
// quaternion launch attitude, the forward-Euler rail phase, rail-exit
// diagnostics, then RK4 with masked events until the lane is done. This
// kernel writes every output of that function (the 31 keys of its summary
// dict, which cover every FlightSummary leaf of the second kernel).
//
// What bounds it on this card: per-lane register pressure (14 state values,
// the event carry, the lane's parameters and the RK4 stage temporaries) and
// divergent, data-dependent loop lengths (each thread runs to its own
// termination, so a warp runs as long as its longest lane). The memory
// traffic is small: two knots x three components of the lane's wind table
// per wind evaluation, and the shared Mach/thrust tables, which stay cached.
// Design: one thread runs one lane's whole flight in registers; no shared
// memory, no inter-thread communication. The TPU kernels' block-wide
// "while any lane active" loop is gone, and so is their B % tile rule.
//
// Numerics follow the JAX package expression for expression:
//   * max/min/clip propagate NaN (jnp semantics), unlike fmax/fmin;
//   * sign(0) == 0;
//   * table lookups evaluate the JAX tent-basis weights, not a lerp;
//   * a lane whose wind table holds a non-finite value evaluates that
//     component over all knots, so NaN poisons it as it does in JAX;
//   * time is rail_time + step * dt, from the step counter, rounded as
//     engine/component.py step_time rounds it;
//   * every literal is T(...), so the float build does no double math.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#if !defined(FS_F32)
#error "compile with -DFS_F32=1 (float) or -DFS_F32=0 (double)"
#endif

namespace {

#if FS_F32
typedef float T;
#define FS_SUFFIX f32

// ------------------------------------------------------------ math helpers
__device__ __forceinline__ float m_sqrt(float x) { return sqrtf(x); }
__device__ __forceinline__ float m_exp(float x) { return expf(x); }
__device__ __forceinline__ float m_pow(float x, float y) { return powf(x, y); }
__device__ __forceinline__ float m_atan2(float y, float x) { return atan2f(y, x); }
__device__ __forceinline__ float m_abs(float x) { return fabsf(x); }
__device__ __forceinline__ bool m_finite(float x) { return isfinite(x); }

// sin and cos in float. The library's sinf/cosf carry a double-precision
// Payne-Hanek reduction for |x| > 105615, which the float build must not
// contain. Here: Cody-Waite reduction by pi/2 split in three floats, then
// the Cephes minimax polynomials on [-pi/4, pi/4] (<= 1.3 ulp there). The
// kernel's arguments are aero angles in [-pi, pi] and half launch angles.
__device__ __forceinline__ void m_sincos(float x, float& s, float& c) {
  const float j = rintf(x * 0.636619747f);
  float r = fmaf(j, -1.57079637f, x);
  r = fmaf(j, 4.37113883e-08f, r);
  r = fmaf(j, 1.77635684e-15f, r);
  const float z = r * r;
  const float ps = r + r * z * (-1.6666654611e-1f + z * (8.3321608736e-3f + z * -1.9515295891e-4f));
  const float pc = 1.0f - 0.5f * z +
                   z * z * (4.166664568298827e-2f + z * (-1.388731625493765e-3f + z * 2.443315711809948e-5f));
  const int q = static_cast<int>(j) & 3;
  s = q == 0 ? ps : (q == 1 ? pc : (q == 2 ? -ps : -pc));
  c = q == 0 ? pc : (q == 1 ? -ps : (q == 2 ? -pc : ps));
}

// engine/component.py step_time: rail_time + step * dt from the step
// counter, rounded once (fused) in float
__device__ __forceinline__ float step_time(float rail_time, int step, float dt) {
  return fmaf(static_cast<float>(step), dt, rail_time);
}
#else
typedef double T;
#define FS_SUFFIX f64

__device__ __forceinline__ double m_sqrt(double x) { return sqrt(x); }
__device__ __forceinline__ double m_exp(double x) { return exp(x); }
__device__ __forceinline__ double m_pow(double x, double y) { return pow(x, y); }
__device__ __forceinline__ double m_atan2(double y, double x) { return atan2(y, x); }
__device__ __forceinline__ double m_abs(double x) { return fabs(x); }
__device__ __forceinline__ bool m_finite(double x) { return isfinite(x); }
__device__ __forceinline__ void m_sincos(double x, double& s, double& c) {
  s = sin(x);
  c = cos(x);
}

// engine/component.py step_time, rounded per operation in double
__device__ __forceinline__ double step_time(double rail_time, int step, double dt) {
  return rail_time + static_cast<double>(step) * dt;
}
#endif

// jnp.maximum / jnp.minimum / jnp.clip: NaN in, NaN out
__device__ __forceinline__ T nmax(T a, T b) {
  return (a != a || b != b) ? a + b : (a > b ? a : b);
}
__device__ __forceinline__ T nmin(T a, T b) {
  return (a != a || b != b) ? a + b : (a < b ? a : b);
}
__device__ __forceinline__ T nclip(T x, T lo, T hi) { return nmin(nmax(x, lo), hi); }
// jnp.sign: 0 at 0, NaN at NaN
__device__ __forceinline__ T nsign(T x) {
  return x > T(0) ? T(1) : (x < T(0) ? T(-1) : x);
}
// ops.math.safe_sqrt: 0 for x <= 0, sqrt (NaN) otherwise
__device__ __forceinline__ T safe_sqrt(T x) { return !(x <= T(0)) ? m_sqrt(x) : T(0); }

// host-side (double) constants, rounded once to T
constexpr double kStall = 0.2617993877991494;        // radians(15)
constexpr double kStallRange = 0.7853981633974483 - 0.2617993877991494;  // radians(45) - radians(15)
constexpr double kTwoPi = 6.283185307179586;
constexpr double kEarthRadius = 6.371e6;
constexpr double kPsl = 101325.0;

// ------------------------------------------------------------ arguments
// Scalar leaves, each a pointer plus a lane stride (0 shared, 1 per lane).
enum Leaf {
  L_DIAMETER, L_FIN_SPAN, L_FIN_ROOT, L_FIN_TIP, L_FIN_SWEEP, L_DRY_MASS,
  L_PROP_MASS, L_COM_DRY, L_IXX_DRY, L_IYY_DRY, L_REF_AREA, L_REF_DIAM,
  L_CP_LOCATION, L_CHUTE_AREA, L_CHUTE_CD, L_CHUTE_ALT, L_POWER_OFF,
  L_NOZZLE_AREA, L_BURN_TIME, L_MDOT, L_THRUST_SCALE,
  L_P0, L_T0, L_LAPSE, L_GAS_R, L_G0, L_GAMMA, L_H_TROP, L_H_STRAT, L_TS,
  L_DENSITY_SCALE,
  L_PX, L_PY, L_PZ, L_VX, L_VY, L_VZ, L_ROLL, L_PITCH, L_YAW, L_OX, L_OY, L_OZ,
  N_LEAVES
};

struct Leaves {
  const T* p[N_LEAVES];
  int stride[N_LEAVES];
};

struct Tables {
  const T* cd_mach; const T* cd0; const T* cda; int k_cd;
  const T* cp_mach; const T* cp_shift; int k_cp;
  const T* curve_t; const T* curve_f; int k_th;
  const T* grid; const T* wind; int n_wind; long long wind_lane_stride;
};

// SimConfig numbers, in the order of the wrapper's cfg array (the opt-in
// flags are checked by the wrapper)
struct Cfg {
  T dt, half_dt, dt6, rail_dt, max_time, rail_length, pitch_damping, yaw_damping,
    ground_altitude, excessive_altitude, apogee_min_altitude, coast_alt_hi,
    coast_alt_mid, coast_time_hi, coast_time_mid, coast_time_lo;
  int max_steps, max_rail_steps;
};

// outputs: float rows in engine/component.py SUMMARY_KEYS order, then ints
enum OutF {
  O_APOGEE, O_APOGEE_TIME, O_RANGE, O_FLIGHT_TIME,
  O_FPX, O_FPY, O_FPZ, O_FVX, O_FVY, O_FVZ, O_MAX_SPEED,
  O_RAIL_TIME, O_RAIL_SPEED, O_RAIL_AOA, O_RAIL_SLIP,
  O_RPX, O_RPY, O_RPZ, O_RVX, O_RVY, O_RVZ, O_RWU, O_RWV, O_RWW,
  O_QW, O_QX, O_QY, O_QZ, N_OUT_F
};
enum OutI { O_PARA, O_DIV, O_NSTEPS, N_OUT_I };

// Per-lane parameters (constant over the flight) plus lane-constant
// sub-expressions the JAX code recomputes on every call; the values are
// the same expressions, evaluated once.
struct Lane {
  T diameter, fin_root, fin_tip, fin_span, dry_mass, prop_mass, com_dry, ixx_dry, iyy_dry,
    ref_area, ref_diam, cp_location, chute_area, chute_cd, chute_alt, power_off;
  T nozzle_area, burn_time, mdot, thrust_scale;
  T P0, T0, L, R, g0, gamma, h_trop, h_strat, Ts, density_scale;
  T pow_exp, p11, p20, p25, exp_2532;
  T aspect_ratio, cos_sweep;
  const T* wind;
  bool wind_bad[3];
};

// ------------------------------------------------------------ models
// ops/interp.py interpolate_1d: the tent weight of every knot
__device__ T interp_table(T x, const T* xt, const T* yt, int k) {
  T xc = nclip(x, xt[0], xt[k - 1]);
  T acc = T(0);
  for (int j = 0; j < k; ++j) {
    T xj = xt[j];
    T left = j == 0 ? T(1) : nmax(xj - xt[j - 1], T(1e-30));
    T right = j == k - 1 ? T(1) : nmax(xt[j + 1] - xj, T(1e-30));
    T up = (xc - (xj - left)) / left;
    T down = ((xj + right) - xc) / right;
    acc = acc + nclip(nmin(up, down), T(0), T(1)) * yt[j];
  }
  return acc;
}

// tent weight of wind knot j at the clamped altitude xc
__device__ __forceinline__ T wind_weight(const T* g, int n, int j, T xc) {
  T gj = g[j];
  T left = j == 0 ? T(1) : nmax(gj - g[j - 1], T(1e-30));
  T right = j == n - 1 ? T(1) : nmax(g[j + 1] - gj, T(1e-30));
  T up = (xc - (gj - left)) / left;
  T down = ((gj + right) - xc) / right;
  return nclip(nmin(up, down), T(0), T(1));
}

// The lane's wind at altitude alt. Only knots i-1..i+2 around the segment
// [g_i, g_i+1] holding xc can carry weight; a component whose table holds
// a non-finite value is summed over every knot (0 * NaN = NaN, as in JAX).
__device__ void wind_at(const Tables& tb, const Lane& ln, T alt, T out[3]) {
  const T* g = tb.grid;
  const int n = tb.n_wind;
  const T* w = ln.wind;
  T xc = nclip(alt, g[0], g[n - 1]);
  if (xc != xc) {
    out[0] = out[1] = out[2] = xc;
    return;
  }
  int lo = 0, hi = n - 1;
  while (hi - lo > 1) {
    int mid = (lo + hi) >> 1;
    if (g[mid] <= xc) lo = mid; else hi = mid;
  }
  int j0 = lo > 0 ? lo - 1 : 0;
  int j1 = lo + 2 < n - 1 ? lo + 2 : n - 1;
  T a0 = T(0), a1 = T(0), a2 = T(0);
  for (int j = j0; j <= j1; ++j) {
    T wj = wind_weight(g, n, j, xc);
    a0 = a0 + wj * w[3 * j + 0];
    a1 = a1 + wj * w[3 * j + 1];
    a2 = a2 + wj * w[3 * j + 2];
  }
  out[0] = a0; out[1] = a1; out[2] = a2;
  for (int c = 0; c < 3; ++c) {
    if (!ln.wind_bad[c]) continue;
    T acc = T(0);
    for (int j = 0; j < n; ++j) acc = acc + wind_weight(g, n, j, xc) * w[3 * j + c];
    out[c] = acc;
  }
}

struct Atm { T temperature, pressure, density, sound; };

// models/atmosphere.py atmosphere_properties; only the selected regime is
// evaluated (each regime is a pure function of h, so the value is the same)
__device__ Atm atmosphere(const Lane& ln, T h) {
  T temperature, pressure;
  if (h <= ln.h_trop) {
    temperature = ln.T0 - ln.L * h;
    pressure = ln.P0 * m_pow(nmax(temperature, T(1)) / ln.T0, ln.pow_exp);
  } else if (h <= ln.h_strat) {
    temperature = ln.Ts;
    pressure = ln.p11 * m_exp(-ln.g0 * (h - ln.h_trop) / (ln.R * ln.Ts));
  } else if (h <= T(25000)) {
    temperature = nmin(ln.Ts + T(0.001) * (h - ln.h_strat), T(228.65));
    pressure = ln.p20 * m_exp(-ln.g0 * (h - ln.h_strat) / (ln.R * ln.Ts));
  } else if (h <= T(32000)) {
    temperature = nmin(ln.Ts + T(0.001) * (h - ln.h_strat), T(228.65));
    pressure = ln.p25 * m_pow(nmax(temperature, T(1)) / ln.Ts, ln.exp_2532);
  } else {
    temperature = nmax(T(228.65) - T(0.0028) * (h - T(32000)), T(180));
    T scale_height = ln.R * temperature / ln.g0;
    pressure = T(868.02) * m_exp(-(h - T(32000)) / scale_height);
  }
  Atm a;
  a.temperature = temperature;
  a.pressure = pressure;
  a.density = pressure / (ln.R * temperature) * ln.density_scale;
  a.sound = m_sqrt(ln.gamma * ln.R * temperature);
  return a;
}

__device__ __forceinline__ T gravity(const Lane& ln, T h) {
  T r = T(kEarthRadius) / (T(kEarthRadius) + h);
  return ln.g0 * (r * r);
}

struct Mass { T mass, cg, ixx, iyy; };

// models/rocket.py mass_properties (Izz := Iyy)
__device__ __forceinline__ Mass mass_props(const Lane& ln, T frac) {
  T cur = ln.prop_mass * frac;
  T total = ln.dry_mass + cur;
  T prop_cg = ln.com_dry - T(0.5);
  T cg = (ln.dry_mass * ln.com_dry + cur * prop_cg) / total;
  T r = ln.diameter / T(4);
  T dcg = prop_cg - cg;
  Mass m;
  m.mass = total;
  m.cg = cg;
  m.ixx = ln.ixx_dry + cur * (r * r);
  m.iyy = ln.iyy_dry + cur * (T(4.0 / 12.0) + dcg * dcg);
  return m;
}

__device__ __forceinline__ T thrust_at(const Tables& tb, const Lane& ln, T t, T p) {
  if (!((t >= T(0)) && (t <= ln.burn_time))) return T(0);
  T base = interp_table(t, tb.curve_t, tb.curve_f, tb.k_th);
  T correction = ln.nozzle_area * (T(kPsl) - p);
  return ln.thrust_scale * (base + correction);
}

struct Aero { T cd, cl, cy, cpitch, cyaw; };

// models/rocket.py aero_coefficients
__device__ Aero aero(const Tables& tb, const Lane& ln, T mach, T alpha, T beta, T cg,
                     bool power_on) {
  T cd0 = interp_table(mach, tb.cd_mach, tb.cd0, tb.k_cd);
  T cda = interp_table(mach, tb.cd_mach, tb.cda, tb.k_cd);
  T cd = cd0 + cda * (alpha * alpha);
  if (!power_on) cd = cd * ln.power_off;
  T abs_alpha = m_abs(alpha);
  bool stalled = abs_alpha > T(kStall);
  T stall_factor = nmax(T(0), T(1) - (abs_alpha - T(kStall)) / T(kStallRange));
  T beta_m = m_sqrt(m_abs(T(1) - mach * mach));
  T kk = ln.aspect_ratio * beta_m / nmax(ln.cos_sweep, T(1e-6));
  T denom = T(2) + m_sqrt(T(4) + kk * kk);
  T cl_alpha = (T(kTwoPi) * ln.aspect_ratio / denom) * ln.cos_sweep;
  T cl_stalled = cl_alpha * T(kStall) * stall_factor * nsign(alpha);
  Aero a;
  a.cl = stalled ? cl_stalled : cl_alpha * alpha;
  a.cd = stalled ? cd * (T(1) + T(0.5) * (abs_alpha - T(kStall)) / T(kStallRange)) : cd;
  T cp = ln.cp_location + interp_table(mach, tb.cp_mach, tb.cp_shift, tb.k_cp);
  T sm = cp - cg;
  a.cpitch = -cl_alpha * sm * alpha;
  a.cy = stalled ? cl_alpha * beta * stall_factor : cl_alpha * beta;
  a.cyaw = -cl_alpha * sm * beta;
  return a;
}

// engine/component.py quat_normalize_c
__device__ __forceinline__ void quat_normalize(T& qw, T& qx, T& qy, T& qz) {
  T n = m_sqrt(qw * qw + qx * qx + qy * qy + qz * qz);
  bool ok = n > T(1e-12);
  T inv = T(1) / (ok ? n : T(1));
  qw = ok ? qw * inv : T(1);
  qx = ok ? qx * inv : T(0);
  qy = ok ? qy * inv : T(0);
  qz = ok ? qz * inv : T(0);
}

// engine/component.py rotmat_c (normalizes a copy first)
__device__ __forceinline__ void rotmat(T qw, T qx, T qy, T qz, T r[9]) {
  quat_normalize(qw, qx, qy, qz);
  r[0] = T(1) - T(2) * (qy * qy + qz * qz);
  r[1] = T(2) * (qx * qy - qw * qz);
  r[2] = T(2) * (qx * qz + qw * qy);
  r[3] = T(2) * (qx * qy + qw * qz);
  r[4] = T(1) - T(2) * (qx * qx + qz * qz);
  r[5] = T(2) * (qy * qz - qw * qx);
  r[6] = T(2) * (qx * qz - qw * qy);
  r[7] = T(2) * (qy * qz + qw * qx);
  r[8] = T(1) - T(2) * (qx * qx + qy * qy);
}

// engine/component.py _aero_angles (angle of attack, sideslip)
__device__ __forceinline__ void aero_angles(T ub, T vb, T wb, T& alpha, T& beta) {
  bool degen = (m_abs(ub) < T(1e-6)) && (m_abs(wb) < T(1e-6));
  alpha = degen ? T(0) : m_atan2(wb, ub);
  T v_xz = safe_sqrt(ub * ub + wb * wb);
  beta = (v_xz < T(1e-6)) ? T(0) : m_atan2(vb, v_xz);
}

enum { S_PX, S_PY, S_PZ, S_VX, S_VY, S_VZ, S_QW, S_QX, S_QY, S_QZ, S_OX, S_OY, S_OZ, S_FRAC,
       N_STATE };

// engine/component.py dynamics_c; updates the parachute latch in place
__device__ void dynamics(const Tables& tb, const Lane& ln, const Cfg& cfg, T t,
                         const T s[N_STATE], int& para, T d[N_STATE]) {
  T frac = nmax(s[S_FRAC], T(0));
  T qw = s[S_QW], qx = s[S_QX], qy = s[S_QY], qz = s[S_QZ];
  quat_normalize(qw, qx, qy, qz);
  T r[9];
  rotmat(qw, qx, qy, qz, r);
  Mass mp = mass_props(ln, frac);
  T pz = s[S_PZ], vx = s[S_VX], vy = s[S_VY], vz = s[S_VZ];
  T ox = s[S_OX], oy = s[S_OY], oz = s[S_OZ];
  Atm atm = atmosphere(ln, pz);

  T wnd[3];
  wind_at(tb, ln, pz, wnd);
  T rvx = vx - wnd[0], rvy = vy - wnd[1], rvz = vz - wnd[2];
  T ub = r[0] * rvx + r[3] * rvy + r[6] * rvz;
  T vb = r[1] * rvx + r[4] * rvy + r[7] * rvz;
  T wb = r[2] * rvx + r[5] * rvy + r[8] * rvz;
  T rel_sq = rvx * rvx + rvy * rvy + rvz * rvz;
  T mach = safe_sqrt(rel_sq) / atm.sound;
  T alpha, beta;
  aero_angles(ub, vb, wb, alpha, beta);
  T q_dyn = T(0.5) * atm.density * rel_sq;

  bool burning = (frac > T(0)) && (t <= ln.burn_time);
  T thrust = burning ? thrust_at(tb, ln, t, atm.pressure) : T(0);

  bool deploy = (pz <= ln.chute_alt) && (vz < T(0));
  para = para > (int)deploy ? para : (int)deploy;
  bool is_chute = para > 0;

  T body_speed = safe_sqrt(ub * ub + vb * vb + wb * wb);
  T chute_coef = body_speed > T(0)
      ? T(-0.5) * atm.density * body_speed * ln.chute_cd * ln.chute_area : T(0);

  Aero co = aero(tb, ln, mach, alpha, beta, mp.cg, frac > T(0));
  T drag = q_dyn * co.cd * ln.ref_area;
  T lift = q_dyn * co.cl * ln.ref_area;
  T side = q_dyn * co.cy * ln.ref_area;
  T ca, sa, cb, sb;
  m_sincos(alpha, sa, ca);
  m_sincos(beta, sb, cb);
  bool has_q = q_dyn > T(0);
  T afx = has_q ? ca * cb * (-drag) + (-sb) * (-side) + sa * cb * (-lift) : T(0);
  T afy = has_q ? ca * sb * (-drag) + cb * (-side) + sa * sb * (-lift) : T(0);
  T afz = has_q ? -sa * (-drag) + ca * (-lift) : T(0);

  T fx = (is_chute ? chute_coef * ub : afx) + thrust;
  T fy = is_chute ? chute_coef * vb : afy;
  T fz = is_chute ? chute_coef * wb : afz;

  T mscale = q_dyn * ln.ref_area * ln.ref_diam;
  bool no_moment = is_chute || !has_q;
  T mx = T(0);
  T my = (no_moment ? T(0) : mscale * co.cpitch) - cfg.pitch_damping * oy;
  T mz = (no_moment ? T(0) : mscale * co.cyaw) - cfg.yaw_damping * oz;

  T fix = r[0] * fx + r[1] * fy + r[2] * fz;
  T fiy = r[3] * fx + r[4] * fy + r[5] * fz;
  T fiz = r[6] * fx + r[7] * fy + r[8] * fz;
  T g = gravity(ln, pz);
  T inv_m = T(1) / mp.mass;
  d[S_PX] = vx;
  d[S_PY] = vy;
  d[S_PZ] = vz;
  d[S_VX] = fix * inv_m;
  d[S_VY] = fiy * inv_m;
  d[S_VZ] = (fiz - mp.mass * g) * inv_m;
  // Izz := Iyy
  d[S_OX] = (mx - (mp.iyy - mp.iyy) * oy * oz) / mp.ixx;
  d[S_OY] = (my - (mp.ixx - mp.iyy) * oz * ox) / mp.iyy;
  d[S_OZ] = (mz - (mp.iyy - mp.ixx) * ox * oy) / mp.iyy;

  T dw = T(0.5) * (-qx * ox - qy * oy - qz * oz);
  T dx = T(0.5) * (qw * ox + qy * oz - qz * oy);
  T dy = T(0.5) * (qw * oy - qx * oz + qz * ox);
  T dz = T(0.5) * (qw * oz + qx * oy - qy * ox);
  T err = qw * qw + qx * qx + qy * qy + qz * qz - T(1);
  d[S_QW] = dw - T(0.5) * err * qw;
  d[S_QX] = dx - T(0.5) * err * qx;
  d[S_QY] = dy - T(0.5) * err * qy;
  d[S_QZ] = dz - T(0.5) * err * qz;

  // propellant with the 10 ms burnout ramp
  T mdot = ((t >= T(0)) && (t <= ln.burn_time)) ? ln.mdot : T(0);
  T nominal = -mdot / ln.prop_mass;
  bool nz = nominal != T(0);
  T safe = nz ? nominal : T(-1);
  T remaining = nz ? frac / m_abs(safe) : T(INFINITY);
  T dfrac = remaining < T(0.01) ? -frac / T(0.01) : nominal;
  d[S_FRAC] = burning ? dfrac : T(0);
}

__device__ __forceinline__ T leaf(const Leaves& lv, int k, long long lane) {
  return lv.p[k][lane * lv.stride[k]];
}

__global__ void __launch_bounds__(128)
flight_summary_kernel(Leaves lv, Tables tb, Cfg cfg, T* __restrict__ out_f,
                      int32_t* __restrict__ out_i, int n_lanes) {
  const long long lane = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= n_lanes) return;

  Lane ln;
  ln.diameter = leaf(lv, L_DIAMETER, lane);
  ln.fin_span = leaf(lv, L_FIN_SPAN, lane);
  ln.fin_root = leaf(lv, L_FIN_ROOT, lane);
  ln.fin_tip = leaf(lv, L_FIN_TIP, lane);
  T fin_sweep = leaf(lv, L_FIN_SWEEP, lane);
  ln.dry_mass = leaf(lv, L_DRY_MASS, lane);
  ln.prop_mass = leaf(lv, L_PROP_MASS, lane);
  ln.com_dry = leaf(lv, L_COM_DRY, lane);
  ln.ixx_dry = leaf(lv, L_IXX_DRY, lane);
  ln.iyy_dry = leaf(lv, L_IYY_DRY, lane);
  ln.ref_area = leaf(lv, L_REF_AREA, lane);
  ln.ref_diam = leaf(lv, L_REF_DIAM, lane);
  ln.cp_location = leaf(lv, L_CP_LOCATION, lane);
  ln.chute_area = leaf(lv, L_CHUTE_AREA, lane);
  ln.chute_cd = leaf(lv, L_CHUTE_CD, lane);
  ln.chute_alt = leaf(lv, L_CHUTE_ALT, lane);
  ln.power_off = leaf(lv, L_POWER_OFF, lane);
  ln.nozzle_area = leaf(lv, L_NOZZLE_AREA, lane);
  ln.burn_time = leaf(lv, L_BURN_TIME, lane);
  ln.mdot = leaf(lv, L_MDOT, lane);
  ln.thrust_scale = leaf(lv, L_THRUST_SCALE, lane);
  ln.P0 = leaf(lv, L_P0, lane);
  ln.T0 = leaf(lv, L_T0, lane);
  ln.L = leaf(lv, L_LAPSE, lane);
  ln.R = leaf(lv, L_GAS_R, lane);
  ln.g0 = leaf(lv, L_G0, lane);
  ln.gamma = leaf(lv, L_GAMMA, lane);
  ln.h_trop = leaf(lv, L_H_TROP, lane);
  ln.h_strat = leaf(lv, L_H_STRAT, lane);
  ln.Ts = leaf(lv, L_TS, lane);
  ln.density_scale = leaf(lv, L_DENSITY_SCALE, lane);

  // lane-constant parts of atmosphere_properties and aero_coefficients
  ln.pow_exp = ln.g0 / (ln.R * ln.L);
  ln.p11 = ln.P0 * m_pow(ln.Ts / ln.T0, ln.pow_exp);
  ln.p20 = ln.p11 * m_exp(-ln.g0 * (ln.h_strat - ln.h_trop) / (ln.R * ln.Ts));
  ln.p25 = ln.p20 * m_exp(-ln.g0 * T(5000) / (ln.R * ln.Ts));
  ln.exp_2532 = ln.g0 / (ln.R * T(0.0028));
  T fin_area = T(0.5) * (ln.fin_root + ln.fin_tip) * ln.fin_span;
  ln.aspect_ratio = T(2) * (ln.fin_span * ln.fin_span) / fin_area;
  T sin_sweep;
  m_sincos(fin_sweep, sin_sweep, ln.cos_sweep);

  ln.wind = tb.wind + lane * tb.wind_lane_stride;
  bool grid_bad = false;
  for (int j = 0; j < tb.n_wind; ++j) grid_bad |= !m_finite(tb.grid[j]);
  for (int c = 0; c < 3; ++c) {
    bool bad = grid_bad;
    for (int j = 0; j < tb.n_wind; ++j) bad |= !m_finite(ln.wind[3 * j + c]);
    ln.wind_bad[c] = bad;
  }

  // launch attitude: intrinsic-xyz Euler -> quaternion
  T roll = leaf(lv, L_ROLL, lane), pitch = leaf(lv, L_PITCH, lane), yaw = leaf(lv, L_YAW, lane);
  T cr, sr, cp, sp, cy, sy;
  m_sincos(roll / T(2), sr, cr);
  m_sincos(pitch / T(2), sp, cp);
  m_sincos(yaw / T(2), sy, cy);
  T qw = cr * cp * cy + sr * sp * sy;
  T qx = sr * cp * cy - cr * sp * sy;
  T qy = cr * sp * cy + sr * cp * sy;
  T qz = cr * cp * sy - sr * sp * cy;
  T r[9];
  rotmat(qw, qx, qy, qz, r);
  const T dxr = r[0], dyr = r[3], dzr = r[6];

  // ---------------- rail phase: forward Euler along the launch direction
  T rpx = leaf(lv, L_PX, lane), rpy = leaf(lv, L_PY, lane), rpz = leaf(lv, L_PZ, lane);
  T spd = leaf(lv, L_VX, lane) * dxr + leaf(lv, L_VY, lane) * dyr + leaf(lv, L_VZ, lane) * dzr;
  T dist = T(0), frac = T(1);
  int stp = 0;
  const T rdt = cfg.rail_dt;
  while ((dist < cfg.rail_length) && (T(stp) * rdt < ln.burn_time) &&
         (stp < cfg.max_rail_steps)) {
    T t = T(stp) * rdt;
    Mass mp = mass_props(ln, frac);
    Atm atm = atmosphere(ln, rpz);
    T wnd[3];
    wind_at(tb, ln, rpz, wnd);
    T rvx = dxr * spd - wnd[0], rvy = dyr * spd - wnd[1], rvz = dzr * spd - wnd[2];
    T rel_axial = rvx * dxr + rvy * dyr + rvz * dzr;
    T mach = safe_sqrt(rvx * rvx + rvy * rvy + rvz * rvz) / atm.sound;
    T cd0 = interp_table(mach, tb.cd_mach, tb.cd0, tb.k_cd);
    T cda = interp_table(mach, tb.cd_mach, tb.cda, tb.k_cd);
    T cd = cd0 + cda * (T(0) * T(0));  // alpha = 0, power on
    T drag = T(0.5) * atm.density * (rel_axial * rel_axial) * cd * ln.ref_area;
    T thrust = thrust_at(tb, ln, t, atm.pressure);
    T g = gravity(ln, rpz);
    T accel = (thrust - mp.mass * g - drag) / mp.mass;
    T nspd = spd + accel * rdt;
    int nstp = stp + 1;
    rpx = rpx + dxr * nspd * rdt;
    rpy = rpy + dyr * nspd * rdt;
    rpz = rpz + dzr * nspd * rdt;
    dist = dist + nspd * rdt;
    frac = nclip(T(1) - (T(nstp) * rdt) / ln.burn_time, T(0), T(1));
    spd = nspd;
    stp = nstp;
  }
  const T rail_time = T(stp) * rdt;
  const T rvx0 = dxr * spd, rvy0 = dyr * spd, rvz0 = dzr * spd;

  // rail-exit diagnostics
  T wexit[3];
  wind_at(tb, ln, rpz, wexit);
  T rail_aoa, rail_slip;
  {
    T rvx = rvx0 - wexit[0], rvy = rvy0 - wexit[1], rvz = rvz0 - wexit[2];
    T ub = r[0] * rvx + r[3] * rvy + r[6] * rvz;
    T vb = r[1] * rvx + r[4] * rvy + r[7] * rvz;
    T wb = r[2] * rvx + r[5] * rvy + r[8] * rvz;
    aero_angles(ub, vb, wb, rail_aoa, rail_slip);
  }
  const T rail_speed = safe_sqrt(rvx0 * rvx0 + rvy0 * rvy0 + rvz0 * rvz0);

  // ---------------- main loop: RK4 with masked events
  T s[N_STATE] = {rpx, rpy, rpz, rvx0, rvy0, rvz0, qw, qx, qy, qz,
                  leaf(lv, L_OX, lane), leaf(lv, L_OY, lane), leaf(lv, L_OZ, lane), frac};
  int step = 0, para = 0, apod = 0, done = 0, div = 0;
  T apo_t = T(0), max_coast = T(0), max_alt = rpz, t_max = rail_time,
    max_spd = rail_speed, end_t = rail_time;

  while (done == 0 && (step_time(rail_time, step, cfg.dt) < cfg.max_time) &&
         step < cfg.max_steps) {
    const T t = step_time(rail_time, step, cfg.dt);
    T k1[N_STATE], k2[N_STATE], k3[N_STATE], k4[N_STATE], tmp[N_STATE];
    int p = para;
    dynamics(tb, ln, cfg, t, s, p, k1);
#pragma unroll
    for (int i = 0; i < N_STATE; ++i) tmp[i] = s[i] + cfg.half_dt * k1[i];
    dynamics(tb, ln, cfg, t + cfg.half_dt, tmp, p, k2);
#pragma unroll
    for (int i = 0; i < N_STATE; ++i) tmp[i] = s[i] + cfg.half_dt * k2[i];
    dynamics(tb, ln, cfg, t + cfg.half_dt, tmp, p, k3);
#pragma unroll
    for (int i = 0; i < N_STATE; ++i) tmp[i] = s[i] + cfg.dt * k3[i];
    dynamics(tb, ln, cfg, t + cfg.dt, tmp, p, k4);
#pragma unroll
    for (int i = 0; i < N_STATE; ++i)
      s[i] = s[i] + cfg.dt6 * (k1[i] + T(2) * k2[i] + T(2) * k3[i] + k4[i]);
    quat_normalize(s[S_QW], s[S_QX], s[S_QY], s[S_QZ]);
    para = p;

    const int step_new = step + 1;
    const T t_new = step_time(rail_time, step_new, cfg.dt);
    const T alt = s[S_PZ], vzn = s[S_VZ];
    const T speed = safe_sqrt(s[S_VX] * s[S_VX] + s[S_VY] * s[S_VY] + s[S_VZ] * s[S_VZ]);

    if (alt > max_alt) { max_alt = alt; t_max = t_new; }
    max_spd = nmax(max_spd, speed);
    bool detect = (alt > cfg.apogee_min_altitude) && (vzn < T(0)) && (apod == 0);
    if (detect) {
      apod = 1;
      apo_t = t_new;
      max_coast = alt > cfg.coast_alt_hi ? cfg.coast_time_hi
                : (alt > cfg.coast_alt_mid ? cfg.coast_time_mid : cfg.coast_time_lo);
    }
    bool ground = (alt <= cfg.ground_altitude) && (vzn <= T(0));
    bool excessive = alt > cfg.excessive_altitude;
    bool coast_done = (apod > 0) && (alt > cfg.coast_alt_mid) && ((t_new - apo_t) > max_coast);
    bool newly_div = !(m_finite(alt) && m_finite(vzn) && m_finite(speed));
    if (newly_div) div = 1;
    // done was 0 on entry, so end_t takes this step's time
    end_t = t_new;
    if (ground || excessive || coast_done || newly_div) done = 1;
    step = step_new;
  }

  const long long B = n_lanes;
  T* o = out_f + lane;
  o[O_APOGEE * B] = max_alt;
  o[O_APOGEE_TIME * B] = t_max - rail_time;
  o[O_RANGE * B] = safe_sqrt(s[S_PX] * s[S_PX] + s[S_PY] * s[S_PY]);
  o[O_FLIGHT_TIME * B] = end_t - rail_time;
  o[O_FPX * B] = s[S_PX];
  o[O_FPY * B] = s[S_PY];
  o[O_FPZ * B] = s[S_PZ];
  o[O_FVX * B] = s[S_VX];
  o[O_FVY * B] = s[S_VY];
  o[O_FVZ * B] = s[S_VZ];
  o[O_MAX_SPEED * B] = max_spd;
  o[O_RAIL_TIME * B] = rail_time;
  o[O_RAIL_SPEED * B] = rail_speed;
  o[O_RAIL_AOA * B] = rail_aoa;
  o[O_RAIL_SLIP * B] = rail_slip;
  o[O_RPX * B] = rpx;
  o[O_RPY * B] = rpy;
  o[O_RPZ * B] = rpz;
  o[O_RVX * B] = rvx0;
  o[O_RVY * B] = rvy0;
  o[O_RVZ * B] = rvz0;
  o[O_RWU * B] = wexit[0];
  o[O_RWV * B] = wexit[1];
  o[O_RWW * B] = wexit[2];
  o[O_QW * B] = qw;
  o[O_QX * B] = qx;
  o[O_QY * B] = qy;
  o[O_QZ * B] = qz;
  int32_t* oi = out_i + lane;
  oi[O_PARA * B] = para;
  oi[O_DIV * B] = div;
  oi[O_NSTEPS * B] = step;
}

}  // namespace

#define FS_CAT2(a, b) a##b
#define FS_CAT(a, b) FS_CAT2(a, b)

// C entry: flight_summary_f32 (FS_F32=1) / flight_summary_f64 (FS_F32=0). All pointers are device
// pointers except leaf_ptrs, leaf_strides, table_ptrs, table_sizes and cfg,
// which are host arrays. Launches on `stream`, allocates nothing, returns
// cudaGetLastError() after the launch.
extern "C" int FS_CAT(flight_summary_, FS_SUFFIX)(
    const void* const* leaf_ptrs, const int* leaf_strides, int n_leaves,
    const void* const* table_ptrs, const int* table_sizes,
    long long wind_lane_stride, const double* cfg_in, int max_steps,
    int max_rail_steps, void* out_f, void* out_i, int n_lanes, void* stream) {
  if (n_leaves != N_LEAVES) return -1;
  if (n_lanes <= 0) return 0;
  Leaves lv;
  for (int k = 0; k < N_LEAVES; ++k) {
    lv.p[k] = static_cast<const T*>(leaf_ptrs[k]);
    lv.stride[k] = leaf_strides[k];
  }
  Tables tb;
  tb.cd_mach = static_cast<const T*>(table_ptrs[0]);
  tb.cd0 = static_cast<const T*>(table_ptrs[1]);
  tb.cda = static_cast<const T*>(table_ptrs[2]);
  tb.k_cd = table_sizes[0];
  tb.cp_mach = static_cast<const T*>(table_ptrs[3]);
  tb.cp_shift = static_cast<const T*>(table_ptrs[4]);
  tb.k_cp = table_sizes[1];
  tb.curve_t = static_cast<const T*>(table_ptrs[5]);
  tb.curve_f = static_cast<const T*>(table_ptrs[6]);
  tb.k_th = table_sizes[2];
  tb.grid = static_cast<const T*>(table_ptrs[7]);
  tb.wind = static_cast<const T*>(table_ptrs[8]);
  tb.n_wind = table_sizes[3];
  tb.wind_lane_stride = wind_lane_stride;
  Cfg cfg;
  cfg.dt = static_cast<T>(cfg_in[0]);
  cfg.half_dt = static_cast<T>(cfg_in[1]);
  cfg.dt6 = static_cast<T>(cfg_in[2]);
  cfg.rail_dt = static_cast<T>(cfg_in[3]);
  cfg.max_time = static_cast<T>(cfg_in[4]);
  cfg.rail_length = static_cast<T>(cfg_in[5]);
  cfg.pitch_damping = static_cast<T>(cfg_in[6]);
  cfg.yaw_damping = static_cast<T>(cfg_in[7]);
  cfg.ground_altitude = static_cast<T>(cfg_in[8]);
  cfg.excessive_altitude = static_cast<T>(cfg_in[9]);
  cfg.apogee_min_altitude = static_cast<T>(cfg_in[10]);
  cfg.coast_alt_hi = static_cast<T>(cfg_in[11]);
  cfg.coast_alt_mid = static_cast<T>(cfg_in[12]);
  cfg.coast_time_hi = static_cast<T>(cfg_in[13]);
  cfg.coast_time_mid = static_cast<T>(cfg_in[14]);
  cfg.coast_time_lo = static_cast<T>(cfg_in[15]);
  cfg.max_steps = max_steps;
  cfg.max_rail_steps = max_rail_steps;
  const int threads = 128;
  const int blocks = (n_lanes + threads - 1) / threads;
  flight_summary_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      lv, tb, cfg, static_cast<T*>(out_f), static_cast<int32_t*>(out_i), n_lanes);
  return static_cast<int>(cudaGetLastError());
}
