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
// What bounds it: operations. A lane-step (one RK4 step: four dynamics
// evaluations, the stage sums, the events) needs about 1,620 arithmetic
// operations, counted as this kernel evaluates them, and moves no memory
// but the lane's wind values per evaluation (kernels/flight_summary.py
// OPS_PER_STEP, bound_ms). The main path (B = 262,144, float32, 6 s
// window, about 2.9e8 lane-steps) needs at least 6.5 ms at the H100's
// published 67 TFLOP/s, which counts a fused multiply-add as two
// operations; built with -fmad=false, the kernel executes one add or
// multiply per instruction, so its own ceiling is half that rate. Its
// bytes (about 0.4 GB) need 0.1 ms. The kernel reaches a few per cent of
// that bound: its chains of divisions, square roots, pow and atan2 wait on
// latency, which only more warps per SM hide, and every register the lane
// keeps costs warps.
// Design, against that:
//   * table lookups sum the four knots around the query's segment, not
//     every knot, where the wrapper found that exact (window-exact tables,
//     see knot_range); inside a segment each knot's tent weight needs one
//     division, not two (window_weight); cd0 and cda share their weights;
//   * each block stages the shared tables and the wind grid in shared
//     memory once, with every knot's support precomputed; the wind segment
//     starts from a direct index;
//   * the per-lane wind table is lane-minor [N,3,B], so a warp's loads of
//     one knot are contiguous;
//   * the lane's constants live in shared memory ([field][thread]), the RK4
//     stages keep one running sum, and the four stages are one loop around
//     one copy of dynamics (half the instructions of four inlined copies);
//   * __launch_bounds__(128, 4): 128 registers, 16 warps per SM, the
//     fastest point of a sweep over 64-256 threads and 3-8 blocks per SM
//     (PERF.md).
// The TPU kernels' block-wide "while any lane active" loop is gone, and so
// is their B % tile rule.
//
// Numerics follow the JAX package expression for expression, and every
// shortcut above returns the bits the full expression would:
//   * max/min/clip propagate NaN (jnp semantics), unlike fmax/fmin;
//   * sign(0) == 0;
//   * table lookups evaluate the JAX tent-basis weights, not a lerp, and
//     sum from +0 in knot order;
//   * a table that is not window-exact (non-finite, knots not strictly
//     increasing) and a lane whose wind table holds a non-finite value are
//     summed over all knots, so NaN poisons them as it does in JAX;
//   * time is rail_time + step * dt, from the step counter, rounded as
//     engine/component.py step_time rounds it;
//   * built with -fmad=false: no multiply-add contraction;
//   * every literal is T(...), so the float build does no double math.
//
// SimConfig opt-ins (engine/config.py) and RocketParams.stall_limited_moments
// that change the loop's structure are compile-time constants (-DFS_*=0/1,
// chosen by kernels/flight_summary.py kernel_flags), as they are static in
// the JAX package: the midpoint method (two stages), one wind lookup a step,
// energy-consistent aero forces, stall-limited moments, the tiered timestep
// (each lane carries its own time, and its step is coarse in quiet phases)
// with or without the quiet-coast ascent gate, the non-finite stop and the
// speed guard, and a bfloat16 wind table (converted exactly at the load).
// Their numbers (the guard, the coarse step, its half and sixth formed in
// double as JAX forms them, the settle time, the ascent threshold) are Cfg
// fields. With every flag at its default (parity), the code is the kernel's
// code without flags.
//
// The recording build (-DFS_RECORD=1, kernels/flight_summary.py
// flight_record) is the same flight with one epilogue: each lane writes a
// frame of engine/component.py flight_components_trajectory at the rail
// exit, every record_stride steps, and at its termination if that falls
// inside a block of record_stride steps: the time since rail exit and the 14
// state values, lane-minor ([frame][channel][B], so that a warp's stores
// coalesce), and the frame it stopped at. A second kernel of the same build,
// the derived pass (record_derived_kernel, its own note below), then fills
// the derived channels of derived_c that the channel mask asks for, from the
// stored frames, off the lane's serial chain. The wrapper fills the frames
// after the stop frame with it and forms valid (frame <= stop). The flight's
// arithmetic is untouched, so its summary outputs are the summary build's,
// bit for bit; with FS_RECORD=0 every record statement is discarded by if
// constexpr and the kernel's signature is the one without recording.
//
// Every launch of the recording build is a few-lane launch (1 lane for a
// single flight, 50 for the exports, 256 to 4,096 for re-simulation and the
// envelope's frame chunks), which fills a few of the 132 SMs: one lane's
// serial chain sets its time, and warps per SM buy nothing. So the build
// has its own launch shape (32 threads a block, a register budget for one
// block an SM, chosen by a sweep on the card, PERF.md) and holds the lane
// constants in registers, not in the block's shared memory: a read of one
// is then no shared-memory load on the chain.
//
// The carry build (-DFS_CARRY=1, kernels/flight_summary.py
// flight_summary_chunked) flies the same flight in chunks, one launch each:
// the first chunk runs the rail phase and writes the rail-exit outputs;
// every chunk then runs at most `steps` main-loop steps from the carry (the
// loop's variables, lane-minor in global memory), stores it back, sets a
// flag if the lane runs on, and writes the loop's outputs. A lane that
// stopped in an earlier chunk returns before its set-up. The carry is
// loaded before the loop and stored after it, each value at its own
// precision, and the arithmetic is the one-shot build's, so a chunked run
// is that build's run, bit for bit. Its additions are preprocessor
// branches: the other builds compile the text they compiled before. It is
// the JAX package's engine/simulate.py simulate_batch_chunked, whose chunks
// bound a device call's time and give the host a progress call. Summaries
// only: FS_CARRY excludes FS_RECORD.
//
// FS_SAFE_NORM_SPEED=1 forms every speed of the main loop (its running
// maximum, the non-finite stop and the speed guard) as the JAX package's
// stacked engine does (ops/math.py safe_norm: a NaN sum of squares gives 0),
// not as its component core does (safe_sqrt: NaN kept); engine.simulate
// sets it on every build it launches.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#if !defined(FS_F32)
#error "compile with -DFS_F32=1 (float) or -DFS_F32=0 (double)"
#endif
// the flag set, parity by default
#ifndef FS_RK2
#define FS_RK2 0
#endif
#ifndef FS_WIND_PER_STEP
#define FS_WIND_PER_STEP 0
#endif
#ifndef FS_ENERGY_AERO
#define FS_ENERGY_AERO 0
#endif
#ifndef FS_STALL_MOMENTS
#define FS_STALL_MOMENTS 0
#endif
#ifndef FS_TIERED
#define FS_TIERED 0
#endif
#ifndef FS_ASCENT_GATE
#define FS_ASCENT_GATE 0
#endif
#ifndef FS_TERMINATE_NONFINITE
#define FS_TERMINATE_NONFINITE 1
#endif
#ifndef FS_SPEED_GUARD
#define FS_SPEED_GUARD 0
#endif
#ifndef FS_WIND_BF16
#define FS_WIND_BF16 0
#endif
#ifndef FS_RECORD
#define FS_RECORD 0
#endif
#ifndef FS_SAFE_NORM_SPEED
#define FS_SAFE_NORM_SPEED 0
#endif
#ifndef FS_CARRY
#define FS_CARRY 0
#endif
#if FS_RECORD && FS_CARRY
#error "the carry build chunks summaries only: FS_CARRY excludes FS_RECORD"
#endif
#if FS_WIND_BF16
#include <cuda_bf16.h>
#endif

namespace {

// launch bounds: threads per block, and the blocks per SM the register
// budget must allow. The summary builds: 128 and 4 (128 registers a
// thread). The recording build: 32 and 1 (255 registers; the head of this
// file)
constexpr int kThreads = FS_RECORD ? 32 : 128;
constexpr int kMinBlocks = FS_RECORD ? 1 : 4;

constexpr bool kRk2 = FS_RK2;                      // integrator="rk2"
constexpr bool kWindPerStep = FS_WIND_PER_STEP;    // wind_eval_per_step
constexpr bool kEnergyAero = FS_ENERGY_AERO;       // energy_consistent_aero
constexpr bool kStallMoments = FS_STALL_MOMENTS;   // stall_limited_moments
constexpr bool kTiered = FS_TIERED;                // descent_dt_scale > 1
constexpr bool kAscentGate = FS_ASCENT_GATE;       // ascent_q_threshold > 0, tiered
constexpr bool kTerminate = FS_TERMINATE_NONFINITE;
constexpr bool kSpeedGuard = FS_SPEED_GUARD;       // a finite speed_guard
constexpr bool kRecord = FS_RECORD;                // the recording build
static_assert(!kAscentGate || kTiered, "the ascent gate is part of the tiered loop");
static_assert(!kSpeedGuard || kTerminate, "the speed guard stops a lane as diverged");

#if FS_F32
typedef float T;
#define FS_SUFFIX f32

// ------------------------------------------------------------ math helpers
__device__ __forceinline__ float m_sqrt(float x) { return sqrtf(x); }
__device__ __forceinline__ float m_exp(float x) { return expf(x); }
__device__ __forceinline__ float m_pow(float x, float y) { return powf(x, y); }
__device__ __forceinline__ float m_atan2(float y, float x) { return atan2f(y, x); }
__device__ __forceinline__ float m_asin(float x) { return asinf(x); }
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
__device__ __forceinline__ double m_asin(double x) { return asin(x); }
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

// the wind table's element type: T, or bfloat16 (wind_table_bf16), whose
// value converts exactly to float and to double
#if FS_WIND_BF16
typedef __nv_bfloat16 W;
__device__ __forceinline__ T wval(W x) { return static_cast<T>(__bfloat162float(x)); }
#else
typedef T W;
__device__ __forceinline__ T wval(W x) { return x; }
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
constexpr double kHalfPi = 1.5707963267948966;
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

// A shared table's place in the block's shared memory: array a (KnotArray)
// of it is smem()[base + a * k + j], j < k.
struct Knots { int base, k; };
enum KnotArray { A_X, A_LO, A_HI, A_LEFT, A_RIGHT, A_Y0, A_Y1 };

struct Tables {
  const T* cd_mach; const T* cd0; const T* cda;
  const T* cp_mach; const T* cp_shift;
  const T* curve_t; const T* curve_f;
  // the wind table, lane-minor [N,3,B] (lane stride 1, knot-component
  // stride B) or shared [N,3] (lane stride 0, knot-component stride 1)
  const T* grid; const W* wind; long long wind_lane_stride, wind_comp_stride;
  const int* flags;   // [N_FLAGS], from the wrapper
  Knots cd, cp, th, g;  // the Mach (cd0, cda), CP, thrust tables and wind grid
  int lane_base;        // the lane constants' place in shared memory
};

// table flags (kernels/flight_summary.py _table_flags): 1 where the Mach,
// CP or thrust table is window-exact; where the wind grid is non-decreasing
// with finite knot supports; where it is finite
enum Flag { F_CD, F_CP, F_TH, F_GRID_WINDOW, F_GRID_FINITE, N_FLAGS };

// SimConfig numbers, in the order of the wrapper's cfg array
// (kernels/flight_summary.py cfg_values); the flags are the build's
struct Cfg {
  T dt, half_dt, dt6, rail_dt, max_time, rail_length, pitch_damping, yaw_damping,
    ground_altitude, excessive_altitude, apogee_min_altitude, coast_alt_hi,
    coast_alt_mid, coast_time_hi, coast_time_mid, coast_time_lo;
  int max_steps, max_rail_steps;
  // speed_guard; the coarse step dt * descent_dt_scale, its half and sixth;
  // descent_settle_time; ascent_q_threshold
  T speed_guard, dt_big, half_dt_big, dt6_big, settle_time, q_threshold;
};
constexpr int N_CFG = 22;

// outputs: float rows in engine/component.py SUMMARY_KEYS order, then ints
enum OutF {
  O_APOGEE, O_APOGEE_TIME, O_RANGE, O_FLIGHT_TIME,
  O_FPX, O_FPY, O_FPZ, O_FVX, O_FVY, O_FVZ, O_MAX_SPEED,
  O_RAIL_TIME, O_RAIL_SPEED, O_RAIL_AOA, O_RAIL_SLIP,
  O_RPX, O_RPY, O_RPZ, O_RVX, O_RVY, O_RVZ, O_RWU, O_RWV, O_RWW,
  O_QW, O_QX, O_QY, O_QZ, N_OUT_F
};
enum OutI { O_PARA, O_DIV, O_NSTEPS, N_OUT_I };

// The recording build's outputs: frames [n_frames][n_channels][B] (the time
// since rail exit, the state, then the derived channels of `mask`, bit j for
// engine/component.py DERIVED_KEYS[j], in that order) and stop [B], the
// frame each lane stopped at. A frame is written every `stride` steps.
struct Rec {
  T* frames = nullptr;
  int32_t* stop = nullptr;
  int stride = 1, n_channels = 0;
  unsigned mask = 0;
};
enum Derived {
  D_MASS, D_CG, D_IXX, D_IYY, D_IZZ, D_ROLL, D_PITCH, D_YAW, D_THRUST, D_DRAG, D_CD, D_CL,
  D_CM, D_CP, D_MARGIN, D_AOA, D_SIDESLIP, D_SPEED, D_ALTITUDE, D_MACH, N_DERIVED
};

// Per-lane parameters (constant over the flight) plus lane-constant
// sub-expressions the JAX code recomputes on every call; the values are
// the same expressions, evaluated once (setup_lane). In the summary builds
// they live in the block's shared memory, field-major ([field][thread]: a
// warp's reads of one field hit 32 banks), so that the registers are left
// to the state, the stage sum and the event carry; in the recording build,
// whose register budget holds them, in registers.
enum LaneField {
  LF_DIAMETER, LF_DRY_MASS, LF_PROP_MASS, LF_COM_DRY, LF_IXX_DRY, LF_IYY_DRY, LF_REF_AREA,
  LF_REF_DIAM, LF_CP_LOCATION, LF_CHUTE_AREA, LF_CHUTE_CD, LF_CHUTE_ALT, LF_POWER_OFF,
  LF_NOZZLE_AREA, LF_BURN_TIME, LF_MDOT, LF_THRUST_SCALE,
  LF_P0, LF_T0, LF_L, LF_R, LF_G0, LF_GAMMA, LF_H_TROP, LF_H_STRAT, LF_TS, LF_DENSITY_SCALE,
  LF_POW_EXP, LF_P11, LF_P20, LF_P25, LF_EXP_2532, LF_ASPECT_RATIO, LF_COS_SWEEP,
  N_LANE_FIELDS
};

#if FS_RECORD
struct Lane {
  T field[N_LANE_FIELDS];
  const W* wind;
  bool wind_bad[3];
  __device__ __forceinline__ T& operator[](int f) { return field[f]; }
  __device__ __forceinline__ T operator[](int f) const { return field[f]; }
};
#else
struct Lane {
  T* field;  // this thread's column of the block's [N_LANE_FIELDS][kThreads] array
  const W* wind;
  bool wind_bad[3];
  __device__ __forceinline__ T& operator[](int f) const { return field[f * kThreads]; }
};
#endif

// The recording build holds the lane constants in registers: every function
// that reads them is inlined there, so that they never go to the stack. In
// the summary builds this is empty, and their code is as it was.
#if FS_RECORD
#define FS_LANE_INLINE __forceinline__
#else
#define FS_LANE_INLINE
#endif

// ------------------------------------------------------------ shared tables
// Each block copies the shared tables and the wind grid into shared memory
// once, with each knot's tent support: lo = x_j - left_j, hi = x_j +
// right_j, left_j and right_j, the expressions ops/interp.py evaluates on
// every query, evaluated once.
__device__ __forceinline__ T* smem() {
  extern __shared__ T fs_smem[];
  return fs_smem;
}
__shared__ int s_flags[N_FLAGS];
__shared__ T s_grid_inv_h;  // (n - 1) / (g[n-1] - g[0]): the wind segment guess

__device__ __forceinline__ T knot(const Knots& t, int a, int j) {
  return smem()[t.base + a * t.k + j];
}

__device__ void stage_knots(const Knots& t, const T* x, const T* y0, const T* y1) {
  T* sm = smem() + t.base;
  for (int j = threadIdx.x; j < t.k; j += blockDim.x) {
    T xj = x[j];
    T left = j == 0 ? T(1) : nmax(xj - x[j - 1], T(1e-30));
    T right = j == t.k - 1 ? T(1) : nmax(x[j + 1] - xj, T(1e-30));
    sm[A_X * t.k + j] = xj;
    sm[A_LO * t.k + j] = xj - left;
    sm[A_HI * t.k + j] = xj + right;
    sm[A_LEFT * t.k + j] = left;
    sm[A_RIGHT * t.k + j] = right;
    if (y0) sm[A_Y0 * t.k + j] = y0[j];
    if (y1) sm[A_Y1 * t.k + j] = y1[j];
  }
}

// ------------------------------------------------------------ models
// Tent weight of knot j at the clamped query xc (ops/interp.py):
// clip(min((xc - lo) / left, (hi - xc) / right), 0, 1).
__device__ __forceinline__ T tent_weight(const Knots& t, int j, T xc) {
  T up = (xc - knot(t, A_LO, j)) / knot(t, A_LEFT, j);
  T down = (knot(t, A_HI, j) - xc) / knot(t, A_RIGHT, j);
  return nclip(nmin(up, down), T(0), T(1));
}

// tent_weight's value where lo, hi, left and right are finite and left,
// right > 0 (a window-exact table), with a division only where the value
// needs one: a numerator <= 0 makes the weight +0; up >= 1 (its numerator
// >= left) leaves clip(down, 0, 1), and down >= 1 leaves clip(up, 0, 1).
// Inside a segment a knot is one of these, so a window of four costs two
// divisions, not eight. A NaN xc fails every test and takes both.
__device__ __forceinline__ T window_weight(const Knots& t, int j, T xc) {
  const T nu = xc - knot(t, A_LO, j), nd = knot(t, A_HI, j) - xc;
  const T left = knot(t, A_LEFT, j), right = knot(t, A_RIGHT, j);
  if (nu <= T(0) || nd <= T(0)) return T(0);
  if (nu >= left) return nclip(nd / right, T(0), T(1));
  if (nd >= right) return nclip(nu / left, T(0), T(1));
  return nclip(nmin(nu / left, nd / right), T(0), T(1));
}

__device__ __forceinline__ T weight(const Knots& t, int j, T xc, bool window) {
  return window ? window_weight(t, j, xc) : tent_weight(t, j, xc);
}

// The knots that can carry weight at xc: all of them, or, where the
// wrapper found the table window-exact (kernels/flight_summary.py
// _window_exact), the four around the segment [x_i, x_i+1] holding xc,
// i the largest index <= k-2 with x_i <= xc. Every knot outside that
// window has weight +0 there, and a sum that starts at +0 is unchanged by
// +0 terms, so the window sum is the full sum bit for bit. A NaN xc gives
// NaN weights in either range.
__device__ __forceinline__ void knot_range(const Knots& t, T xc, bool window, int& j0,
                                           int& j1) {
  j0 = 0;
  j1 = t.k - 1;
  if (!window) return;
  int i = 0;
  for (int j = 1; j <= t.k - 2; ++j) i += knot(t, A_X, j) <= xc;
  j0 = i > 0 ? i - 1 : 0;
  j1 = i + 2 < t.k - 1 ? i + 2 : t.k - 1;
}

// ops/interp.py interpolate_1d of the table's A_Y0 values
__device__ T interp_table(T x, const Knots& t, bool window) {
  T xc = nclip(x, knot(t, A_X, 0), knot(t, A_X, t.k - 1));
  int j0, j1;
  knot_range(t, xc, window, j0, j1);
  T acc = T(0);
  for (int j = j0; j <= j1; ++j) acc = acc + weight(t, j, xc, window) * knot(t, A_Y0, j);
  return acc;
}

// both value arrays of one knot vector (cd0 and cda on the Mach knots): the
// same weights, each sum in its own order
__device__ void interp_pair(T x, const Knots& t, bool window, T& a0, T& a1) {
  T xc = nclip(x, knot(t, A_X, 0), knot(t, A_X, t.k - 1));
  int j0, j1;
  knot_range(t, xc, window, j0, j1);
  a0 = T(0);
  a1 = T(0);
  for (int j = j0; j <= j1; ++j) {
    T w = weight(t, j, xc, window);
    a0 = a0 + w * knot(t, A_Y0, j);
    a1 = a1 + w * knot(t, A_Y1, j);
  }
}

// The wind segment holding xc (not NaN, g[0] <= xc): the largest lo <= n-2
// with g[lo] <= xc, which is what a binary search finds on a non-decreasing
// grid. There, start from the uniform-grid index and walk to it; on any
// other grid, run that binary search.
__device__ __forceinline__ int wind_segment(const Knots& g, T xc, bool sorted) {
  const int n = g.k;
  int lo = 0;
  if (sorted) {
    const int top = n > 2 ? n - 2 : 0;
    T guess = (xc - knot(g, A_X, 0)) * s_grid_inv_h;
    if (guess > T(0)) lo = guess < T(top) ? static_cast<int>(guess) : top;
    while (lo > 0 && knot(g, A_X, lo) > xc) --lo;
    while (lo < n - 2 && knot(g, A_X, lo + 1) <= xc) ++lo;
  } else {
    int hi = n - 1;
    while (hi - lo > 1) {
      int mid = (lo + hi) >> 1;
      if (knot(g, A_X, mid) <= xc) lo = mid; else hi = mid;
    }
  }
  return lo;
}

// The lane's wind at altitude alt. Only knots i-1..i+2 around the segment
// [g_i, g_i+1] holding xc can carry weight; a component whose table holds
// a non-finite value is summed over every knot (0 * NaN = NaN, as in JAX).
__device__ FS_LANE_INLINE void wind_at(const Tables& tb, const Lane& ln, T alt, T out[3]) {
  const Knots& g = tb.g;
  const int n = g.k;
  const W* w = ln.wind;
  const long long cs = tb.wind_comp_stride;
  T xc = nclip(alt, knot(g, A_X, 0), knot(g, A_X, n - 1));
  if (xc != xc) {
    out[0] = out[1] = out[2] = xc;
    return;
  }
  const bool window = s_flags[F_GRID_WINDOW] != 0;
  const int lo = wind_segment(g, xc, window);
  int j0 = lo > 0 ? lo - 1 : 0;
  int j1 = lo + 2 < n - 1 ? lo + 2 : n - 1;
  T a0 = T(0), a1 = T(0), a2 = T(0);
  for (int j = j0; j <= j1; ++j) {
    T wj = weight(g, j, xc, window);
    const W* wk = w + 3 * j * cs;
    a0 = a0 + wj * wval(wk[0]);
    a1 = a1 + wj * wval(wk[cs]);
    a2 = a2 + wj * wval(wk[2 * cs]);
  }
  out[0] = a0; out[1] = a1; out[2] = a2;
  for (int c = 0; c < 3; ++c) {
    if (!ln.wind_bad[c]) continue;
    T acc = T(0);
    for (int j = 0; j < n; ++j) acc = acc + tent_weight(g, j, xc) * wval(w[(3 * j + c) * cs]);
    out[c] = acc;
  }
}

struct Atm { T temperature, pressure, density, sound; };

// models/atmosphere.py atmosphere_properties; only the selected regime is
// evaluated (each regime is a pure function of h, so the value is the same)
__device__ FS_LANE_INLINE Atm atmosphere(const Lane& ln, T h) {
  T temperature, pressure;
  if (h <= ln[LF_H_TROP]) {
    temperature = ln[LF_T0] - ln[LF_L] * h;
    pressure = ln[LF_P0] * m_pow(nmax(temperature, T(1)) / ln[LF_T0], ln[LF_POW_EXP]);
  } else if (h <= ln[LF_H_STRAT]) {
    temperature = ln[LF_TS];
    pressure = ln[LF_P11] * m_exp(-ln[LF_G0] * (h - ln[LF_H_TROP]) / (ln[LF_R] * ln[LF_TS]));
  } else if (h <= T(25000)) {
    temperature = nmin(ln[LF_TS] + T(0.001) * (h - ln[LF_H_STRAT]), T(228.65));
    pressure = ln[LF_P20] * m_exp(-ln[LF_G0] * (h - ln[LF_H_STRAT]) / (ln[LF_R] * ln[LF_TS]));
  } else if (h <= T(32000)) {
    temperature = nmin(ln[LF_TS] + T(0.001) * (h - ln[LF_H_STRAT]), T(228.65));
    pressure = ln[LF_P25] * m_pow(nmax(temperature, T(1)) / ln[LF_TS], ln[LF_EXP_2532]);
  } else {
    temperature = nmax(T(228.65) - T(0.0028) * (h - T(32000)), T(180));
    T scale_height = ln[LF_R] * temperature / ln[LF_G0];
    pressure = T(868.02) * m_exp(-(h - T(32000)) / scale_height);
  }
  Atm a;
  a.temperature = temperature;
  a.pressure = pressure;
  a.density = pressure / (ln[LF_R] * temperature) * ln[LF_DENSITY_SCALE];
  a.sound = m_sqrt(ln[LF_GAMMA] * ln[LF_R] * temperature);
  return a;
}

__device__ __forceinline__ T gravity(const Lane& ln, T h) {
  T r = T(kEarthRadius) / (T(kEarthRadius) + h);
  return ln[LF_G0] * (r * r);
}

struct Mass { T mass, cg, ixx, iyy; };

// models/rocket.py mass_properties (Izz := Iyy)
__device__ __forceinline__ Mass mass_props(const Lane& ln, T frac) {
  T cur = ln[LF_PROP_MASS] * frac;
  T total = ln[LF_DRY_MASS] + cur;
  T prop_cg = ln[LF_COM_DRY] - T(0.5);
  T cg = (ln[LF_DRY_MASS] * ln[LF_COM_DRY] + cur * prop_cg) / total;
  T r = ln[LF_DIAMETER] / T(4);
  T dcg = prop_cg - cg;
  Mass m;
  m.mass = total;
  m.cg = cg;
  m.ixx = ln[LF_IXX_DRY] + cur * (r * r);
  m.iyy = ln[LF_IYY_DRY] + cur * (T(4.0 / 12.0) + dcg * dcg);
  return m;
}

__device__ __forceinline__ T thrust_at(const Tables& tb, const Lane& ln, T t, T p) {
  if (!((t >= T(0)) && (t <= ln[LF_BURN_TIME]))) return T(0);
  T base = interp_table(t, tb.th, s_flags[F_TH] != 0);
  T correction = ln[LF_NOZZLE_AREA] * (T(kPsl) - p);
  return ln[LF_THRUST_SCALE] * (base + correction);
}

struct Aero { T cd, cl, cy, cpitch, cyaw; };

// models/rocket.py aero_coefficients
__device__ FS_LANE_INLINE Aero aero(const Tables& tb, const Lane& ln, T mach, T alpha, T beta,
                                    T cg, bool power_on) {
  T cd0, cda;
  interp_pair(mach, tb.cd, s_flags[F_CD] != 0, cd0, cda);
  T cd = cd0 + cda * (alpha * alpha);
  if (!power_on) cd = cd * ln[LF_POWER_OFF];
  T abs_alpha = m_abs(alpha);
  bool stalled = abs_alpha > T(kStall);
  T stall_factor = nmax(T(0), T(1) - (abs_alpha - T(kStall)) / T(kStallRange));
  T beta_m = m_sqrt(m_abs(T(1) - mach * mach));
  T kk = ln[LF_ASPECT_RATIO] * beta_m / nmax(ln[LF_COS_SWEEP], T(1e-6));
  T denom = T(2) + m_sqrt(T(4) + kk * kk);
  T cl_alpha = (T(kTwoPi) * ln[LF_ASPECT_RATIO] / denom) * ln[LF_COS_SWEEP];
  T cl_stalled = cl_alpha * T(kStall) * stall_factor * nsign(alpha);
  Aero a;
  a.cl = stalled ? cl_stalled : cl_alpha * alpha;
  a.cd = stalled ? cd * (T(1) + T(0.5) * (abs_alpha - T(kStall)) / T(kStallRange)) : cd;
  T cp = ln[LF_CP_LOCATION] + interp_table(mach, tb.cp, s_flags[F_CP] != 0);
  T sm = cp - cg;
  a.cpitch = -cl_alpha * sm * alpha;
  a.cy = stalled ? cl_alpha * beta * stall_factor : cl_alpha * beta;
  a.cyaw = -cl_alpha * sm * beta;
  if constexpr (kStallMoments) {
    // the moments saturate at their stall-onset value and taper with the
    // stall factor; cyaw on beta's own factor
    if (stalled) a.cpitch = -cl_alpha * sm * T(kStall) * stall_factor * nsign(alpha);
    const T abs_beta = m_abs(beta);
    if (abs_beta > T(kStall)) {
      const T beta_sf = nmax(T(0), T(1) - (abs_beta - T(kStall)) / T(kStallRange));
      a.cyaw = -cl_alpha * sm * T(kStall) * beta_sf * nsign(beta);
    }
  }
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

// engine/component.py dynamics_c; updates the parachute latch in place.
// wstep: the step's wind under wind_eval_per_step, unread otherwise
__device__ FS_LANE_INLINE void dynamics(const Tables& tb, const Lane& ln, const Cfg& cfg, T t,
                                        const T s[N_STATE], int& para, T d[N_STATE],
                                        const T wstep[3]) {
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
  if constexpr (kWindPerStep) {
    wnd[0] = wstep[0]; wnd[1] = wstep[1]; wnd[2] = wstep[2];
  } else {
    wind_at(tb, ln, pz, wnd);
  }
  T rvx = vx - wnd[0], rvy = vy - wnd[1], rvz = vz - wnd[2];
  T ub = r[0] * rvx + r[3] * rvy + r[6] * rvz;
  T vb = r[1] * rvx + r[4] * rvy + r[7] * rvz;
  T wb = r[2] * rvx + r[5] * rvy + r[8] * rvz;
  T rel_sq = rvx * rvx + rvy * rvy + rvz * rvz;
  T mach = safe_sqrt(rel_sq) / atm.sound;
  T alpha, beta;
  aero_angles(ub, vb, wb, alpha, beta);
  T q_dyn = T(0.5) * atm.density * rel_sq;

  bool burning = (frac > T(0)) && (t <= ln[LF_BURN_TIME]);
  T thrust = burning ? thrust_at(tb, ln, t, atm.pressure) : T(0);

  bool deploy = (pz <= ln[LF_CHUTE_ALT]) && (vz < T(0));
  para = para > (int)deploy ? para : (int)deploy;
  bool is_chute = para > 0;

  T body_speed = safe_sqrt(ub * ub + vb * vb + wb * wb);
  T chute_coef = body_speed > T(0)
      ? T(-0.5) * atm.density * body_speed * ln[LF_CHUTE_CD] * ln[LF_CHUTE_AREA] : T(0);

  Aero co = aero(tb, ln, mach, alpha, beta, mp.cg, frac > T(0));
  T drag = q_dyn * co.cd * ln[LF_REF_AREA];
  T lift = q_dyn * co.cl * ln[LF_REF_AREA];
  T side = q_dyn * co.cy * ln[LF_REF_AREA];
  T ca, sa, cb, sb;
  m_sincos(alpha, sa, ca);
  m_sincos(beta, sb, cb);
  bool has_q = q_dyn > T(0);
  T afx, afy, afz;
  if constexpr (kEnergyAero) {
    // drag anti-parallel to the body-frame air velocity; lift and side
    // force projected onto the plane perpendicular to it
    const T inv_bs = T(1) / nmax(body_speed, T(1e-12));
    const T vhx = ub * inv_bs, vhy = vb * inv_bs, vhz = wb * inv_bs;
    const T lsx = has_q ? (-sb) * (-side) + sa * cb * (-lift) : T(0);
    const T lsy = has_q ? cb * (-side) + sa * sb * (-lift) : T(0);
    const T lsz = has_q ? ca * (-lift) : T(0);
    const T along = lsx * vhx + lsy * vhy + lsz * vhz;
    afx = has_q ? -drag * vhx + (lsx - along * vhx) : T(0);
    afy = has_q ? -drag * vhy + (lsy - along * vhy) : T(0);
    afz = has_q ? -drag * vhz + (lsz - along * vhz) : T(0);
  } else {
    afx = has_q ? ca * cb * (-drag) + (-sb) * (-side) + sa * cb * (-lift) : T(0);
    afy = has_q ? ca * sb * (-drag) + cb * (-side) + sa * sb * (-lift) : T(0);
    afz = has_q ? -sa * (-drag) + ca * (-lift) : T(0);
  }

  T fx = (is_chute ? chute_coef * ub : afx) + thrust;
  T fy = is_chute ? chute_coef * vb : afy;
  T fz = is_chute ? chute_coef * wb : afz;

  T mscale = q_dyn * ln[LF_REF_AREA] * ln[LF_REF_DIAM];
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
  T mdot = ((t >= T(0)) && (t <= ln[LF_BURN_TIME])) ? ln[LF_MDOT] : T(0);
  T nominal = -mdot / ln[LF_PROP_MASS];
  bool nz = nominal != T(0);
  T safe = nz ? nominal : T(-1);
  T remaining = nz ? frac / m_abs(safe) : T(INFINITY);
  T dfrac = remaining < T(0.01) ? -frac / T(0.01) : nominal;
  d[S_FRAC] = burning ? dfrac : T(0);
}

// engine/component.py _coarse_lanes: whether a step of the tiered loop is
// coarse. Settled ballistic fall after apogee, clear of the chute-deploy
// altitude by 1.5 coarse steps; canopy descent once the opening has
// settled; with the ascent gate, a quiet coast before apogee (burnt out, no
// chute, clear, dynamic pressure from its own atmosphere lookup under the
// threshold), looked up only where the other terms leave the step fine.
__device__ __forceinline__ bool coarse_step(const Lane& ln, const Cfg& cfg, const T s[N_STATE],
                                            T t, int apod, int para, T apo_t, T dep_t) {
  const T fall = nmax(-s[S_VZ], T(0));
  const bool clear = s[S_PZ] > ln[LF_CHUTE_ALT] + T(1.5) * fall * cfg.dt_big;
  bool coarse = (apod > 0 && para == 0 && (t - apo_t) > cfg.settle_time && clear) ||
                (para > 0 && (t - dep_t) > cfg.settle_time);
  if constexpr (kAscentGate) {
    if (!coarse && t > ln[LF_BURN_TIME] && apod == 0 && para == 0 && clear) {
      const T rho = atmosphere(ln, s[S_PZ]).density;
      coarse = T(0.5) * rho * (s[S_VX] * s[S_VX] + s[S_VY] * s[S_VY] + s[S_VZ] * s[S_VZ]) <
               cfg.q_threshold;
    }
  }
  return coarse;
}

__device__ __forceinline__ T leaf(const Leaves& lv, int k, long long lane) {
  return lv.p[k][lane * lv.stride[k]];
}

// The recording build's epilogue: frame f of the lane, t_off after rail
// exit at state s: the time and the state. The derived channels are the
// derived pass's.
__device__ __forceinline__ void record_state(const Rec& rec, long long B, long long lane, int f,
                                             T t_off, const T s[N_STATE]) {
  T* o = rec.frames + static_cast<long long>(f) * rec.n_channels * B + lane;
  o[0] = t_off;
#pragma unroll
  for (int i = 0; i < N_STATE; ++i) o[(i + 1) * B] = s[i];
}

// The derived channels of a frame, t_off after rail exit at state s, that
// `mask` asks for, stored from o[(1 + N_STATE) * B] on: engine/component.py
// derived_c, expression for expression: the mass properties of the
// unclamped propellant fraction, thrust at t_off gated by the burn only,
// the Euler angles of the quaternion with the +-90 degree pitch clamp.
__device__ __forceinline__ void derived_channels(const Tables& tb, const Lane& ln, unsigned mask,
                                                 T t_off, const T s[N_STATE], T* o, long long B) {
  const T pz = s[S_PZ], vx = s[S_VX], vy = s[S_VY], vz = s[S_VZ];
  const T qw = s[S_QW], qx = s[S_QX], qy = s[S_QY], qz = s[S_QZ], frac = s[S_FRAC];
  const Mass mp = mass_props(ln, frac);
  const Atm atm = atmosphere(ln, pz);
  T wnd[3];
  wind_at(tb, ln, pz, wnd);
  const T rvx = vx - wnd[0], rvy = vy - wnd[1], rvz = vz - wnd[2];
  T r[9];
  rotmat(qw, qx, qy, qz, r);
  const T ub = r[0] * rvx + r[3] * rvy + r[6] * rvz;
  const T vb = r[1] * rvx + r[4] * rvy + r[7] * rvz;
  const T wb = r[2] * rvx + r[5] * rvy + r[8] * rvz;
  const T rel_sq = rvx * rvx + rvy * rvy + rvz * rvz;
  const T mach = safe_sqrt(rel_sq) / atm.sound;
  T aoa, beta;
  aero_angles(ub, vb, wb, aoa, beta);
  const T cp = ln[LF_CP_LOCATION] + interp_table(mach, tb.cp, s_flags[F_CP] != 0);
  const Aero co = aero(tb, ln, mach, aoa, beta, mp.cg, frac > T(0));
  const T q_dyn = T(0.5) * atm.density * rel_sq;
  const T sinp = T(2) * (qw * qy - qz * qx);
  T d[N_DERIVED];
  d[D_MASS] = mp.mass;
  d[D_CG] = mp.cg;
  d[D_IXX] = mp.ixx;
  d[D_IYY] = mp.iyy;
  d[D_IZZ] = mp.iyy;
  d[D_ROLL] = m_atan2(T(2) * (qw * qx + qy * qz), T(1) - T(2) * (qx * qx + qy * qy));
  d[D_PITCH] = m_abs(sinp) >= T(1) ? nsign(sinp) * T(kHalfPi) : m_asin(nclip(sinp, T(-1), T(1)));
  d[D_YAW] = m_atan2(T(2) * (qw * qz + qx * qy), T(1) - T(2) * (qy * qy + qz * qz));
  d[D_THRUST] = thrust_at(tb, ln, t_off, atm.pressure);
  d[D_DRAG] = q_dyn * co.cd * ln[LF_REF_AREA];
  d[D_CD] = co.cd;
  d[D_CL] = co.cl;
  d[D_CM] = co.cpitch;
  d[D_CP] = cp;
  d[D_MARGIN] = (cp - mp.cg) / ln[LF_REF_DIAM];
  d[D_AOA] = aoa;
  d[D_SIDESLIP] = beta;
  d[D_SPEED] = safe_sqrt(vx * vx + vy * vy + vz * vz);
  d[D_ALTITUDE] = pz;
  d[D_MACH] = mach;
  int c = 1 + N_STATE;
#pragma unroll
  for (int j = 0; j < N_DERIVED; ++j)
    if ((mask >> j) & 1u) o[(c++) * B] = d[j];
}

// The lane's constants (LaneField), its wind table and which of the table's
// components hold a non-finite value. The flight and the derived pass both
// set a lane up here, so their constants are the same bits.
__device__ __forceinline__ void setup_lane(const Leaves& lv, const Tables& tb, long long lane,
                                           Lane& ln) {
  ln[LF_DIAMETER] = leaf(lv, L_DIAMETER, lane);
  const T fin_span = leaf(lv, L_FIN_SPAN, lane);
  const T fin_root = leaf(lv, L_FIN_ROOT, lane);
  const T fin_tip = leaf(lv, L_FIN_TIP, lane);
  T fin_sweep = leaf(lv, L_FIN_SWEEP, lane);
  ln[LF_DRY_MASS] = leaf(lv, L_DRY_MASS, lane);
  ln[LF_PROP_MASS] = leaf(lv, L_PROP_MASS, lane);
  ln[LF_COM_DRY] = leaf(lv, L_COM_DRY, lane);
  ln[LF_IXX_DRY] = leaf(lv, L_IXX_DRY, lane);
  ln[LF_IYY_DRY] = leaf(lv, L_IYY_DRY, lane);
  ln[LF_REF_AREA] = leaf(lv, L_REF_AREA, lane);
  ln[LF_REF_DIAM] = leaf(lv, L_REF_DIAM, lane);
  ln[LF_CP_LOCATION] = leaf(lv, L_CP_LOCATION, lane);
  ln[LF_CHUTE_AREA] = leaf(lv, L_CHUTE_AREA, lane);
  ln[LF_CHUTE_CD] = leaf(lv, L_CHUTE_CD, lane);
  ln[LF_CHUTE_ALT] = leaf(lv, L_CHUTE_ALT, lane);
  ln[LF_POWER_OFF] = leaf(lv, L_POWER_OFF, lane);
  ln[LF_NOZZLE_AREA] = leaf(lv, L_NOZZLE_AREA, lane);
  ln[LF_BURN_TIME] = leaf(lv, L_BURN_TIME, lane);
  ln[LF_MDOT] = leaf(lv, L_MDOT, lane);
  ln[LF_THRUST_SCALE] = leaf(lv, L_THRUST_SCALE, lane);
  ln[LF_P0] = leaf(lv, L_P0, lane);
  ln[LF_T0] = leaf(lv, L_T0, lane);
  ln[LF_L] = leaf(lv, L_LAPSE, lane);
  ln[LF_R] = leaf(lv, L_GAS_R, lane);
  ln[LF_G0] = leaf(lv, L_G0, lane);
  ln[LF_GAMMA] = leaf(lv, L_GAMMA, lane);
  ln[LF_H_TROP] = leaf(lv, L_H_TROP, lane);
  ln[LF_H_STRAT] = leaf(lv, L_H_STRAT, lane);
  ln[LF_TS] = leaf(lv, L_TS, lane);
  ln[LF_DENSITY_SCALE] = leaf(lv, L_DENSITY_SCALE, lane);

  // lane-constant parts of atmosphere_properties and aero_coefficients
  ln[LF_POW_EXP] = ln[LF_G0] / (ln[LF_R] * ln[LF_L]);
  ln[LF_P11] = ln[LF_P0] * m_pow(ln[LF_TS] / ln[LF_T0], ln[LF_POW_EXP]);
  ln[LF_P20] = ln[LF_P11] *
               m_exp(-ln[LF_G0] * (ln[LF_H_STRAT] - ln[LF_H_TROP]) / (ln[LF_R] * ln[LF_TS]));
  ln[LF_P25] = ln[LF_P20] * m_exp(-ln[LF_G0] * T(5000) / (ln[LF_R] * ln[LF_TS]));
  ln[LF_EXP_2532] = ln[LF_G0] / (ln[LF_R] * T(0.0028));
  T fin_area = T(0.5) * (fin_root + fin_tip) * fin_span;
  ln[LF_ASPECT_RATIO] = T(2) * (fin_span * fin_span) / fin_area;
  T sin_sweep, cos_sweep;
  m_sincos(fin_sweep, sin_sweep, cos_sweep);
  ln[LF_COS_SWEEP] = cos_sweep;

  ln.wind = tb.wind + lane * tb.wind_lane_stride;
  const bool grid_bad = s_flags[F_GRID_FINITE] == 0;
  for (int c = 0; c < 3; ++c) {
    bool bad = grid_bad;
    for (int j = 0; j < tb.g.k; ++j)
      bad |= !m_finite(wval(ln.wind[(3 * j + c) * tb.wind_comp_stride]));
    ln.wind_bad[c] = bad;
  }
}

// The carry build's chunk (-DFS_CARRY=1, kernels/flight_summary.py
// flight_summary_chunked): the main loop's variables between two launches,
// lane-minor like the outputs, [N_CARRY_F][B] of T and [N_CARRY_I][B] of
// int32; `first` for the first chunk, which runs the rail phase; `steps`,
// the chunk's steps at most; `active`, set to 1 by every lane that takes
// another chunk.
#if FS_CARRY
enum CarryF {
  C_S, C_APO_T = C_S + N_STATE, C_MAX_COAST, C_MAX_ALT, C_T_MAX, C_MAX_SPD, C_END_T, C_T_LANE,
  C_DEP_T, C_RAIL_TIME, N_CARRY_F
};
enum CarryI { C_STEP, C_PARA, C_APOD, C_DONE, C_DIV, N_CARRY_I };
struct Chunk {
  T* f;
  int32_t* i;
  int32_t* active;
  int first, steps;
};
#endif

// the record build's kernel takes the Rec, the carry build's the Chunk; the
// other builds' signature is the one without either
#if FS_RECORD
#define FS_REC_KPARAM , Rec rec
#define FS_REC_PARAM , const Rec& rec
#define FS_REC_ARG , rec
#else
#define FS_REC_KPARAM
#define FS_REC_PARAM
#define FS_REC_ARG
#endif
#if FS_CARRY
#define FS_CHUNK_KPARAM , Chunk ck
#define FS_CHUNK_PARAM , const Chunk& ck
#define FS_CHUNK_ARG , ck
#else
#define FS_CHUNK_KPARAM
#define FS_CHUNK_PARAM
#define FS_CHUNK_ARG
#endif

#if FS_SAFE_NORM_SPEED
// ops.math.safe_norm of a sum of squares: the sqrt where it is > 0, else 0,
// a NaN sum too (safe_sqrt keeps that NaN): the stacked engine's speed
__device__ __forceinline__ T safe_norm_sq(T x) { return x > T(0) ? m_sqrt(x) : T(0); }
#endif

// one lane's whole flight; in the carry build, one chunk of it. The carry
// build's additions are preprocessor branches, so that the text the other
// builds compile is the flight's alone.
__device__ __forceinline__ void fly(const Leaves& lv, const Tables& tb, const Cfg& cfg,
                                    T* __restrict__ out_f, int32_t* __restrict__ out_i,
                                    int n_lanes, long long lane FS_REC_PARAM FS_CHUNK_PARAM) {
#if !FS_RECORD
  constexpr Rec rec{};  // read by no statement: the record code is discarded
#endif
#if FS_CARRY
  // a chunk after the first: a lane that stopped in an earlier chunk has
  // nothing to do (its outputs are written) and returns before its set-up;
  // a running lane skips the rail phase and loads the loop's variables
  const int32_t* ci = ck.i + lane;
  const T* cf = ck.f + lane;
  const long long BC = n_lanes;
  if (ck.first == 0) {
    const int step0 = ci[C_STEP * BC];
    const T t0 = kTiered ? cf[C_T_LANE * BC] : step_time(cf[C_RAIL_TIME * BC], step0, cfg.dt);
    if (!(ci[C_DONE * BC] == 0 && t0 < cfg.max_time && step0 < cfg.max_steps)) return;
  }
#endif

  Lane ln;
#if !FS_RECORD
  ln.field = smem() + tb.lane_base + threadIdx.x;
#endif
  setup_lane(lv, tb, lane, ln);

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
  while (
#if FS_CARRY
         ck.first != 0 &&
#endif
         (dist < cfg.rail_length) && (T(stp) * rdt < ln[LF_BURN_TIME]) &&
         (stp < cfg.max_rail_steps)) {
    T t = T(stp) * rdt;
    Mass mp = mass_props(ln, frac);
    Atm atm = atmosphere(ln, rpz);
    T wnd[3];
    wind_at(tb, ln, rpz, wnd);
    T rvx = dxr * spd - wnd[0], rvy = dyr * spd - wnd[1], rvz = dzr * spd - wnd[2];
    T rel_axial = rvx * dxr + rvy * dyr + rvz * dzr;
    T mach = safe_sqrt(rvx * rvx + rvy * rvy + rvz * rvz) / atm.sound;
    T cd0, cda;
    interp_pair(mach, tb.cd, s_flags[F_CD] != 0, cd0, cda);
    T cd = cd0 + cda * (T(0) * T(0));  // alpha = 0, power on
    T drag = T(0.5) * atm.density * (rel_axial * rel_axial) * cd * ln[LF_REF_AREA];
    T thrust = thrust_at(tb, ln, t, atm.pressure);
    T g = gravity(ln, rpz);
    T accel = (thrust - mp.mass * g - drag) / mp.mass;
    T nspd = spd + accel * rdt;
    int nstp = stp + 1;
    rpx = rpx + dxr * nspd * rdt;
    rpy = rpy + dyr * nspd * rdt;
    rpz = rpz + dzr * nspd * rdt;
    dist = dist + nspd * rdt;
    frac = nclip(T(1) - (T(nstp) * rdt) / ln[LF_BURN_TIME], T(0), T(1));
    spd = nspd;
    stp = nstp;
  }
#if FS_CARRY
  const T rail_time = ck.first != 0 ? T(stp) * rdt : cf[C_RAIL_TIME * BC];
#else
  const T rail_time = T(stp) * rdt;
#endif
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
#if FS_CARRY
  if (ck.first != 0) {
    // the rail-exit outputs, once, in the first chunk, and not kept in
    // registers through the loop
    T* o = out_f + lane;
    o[O_RAIL_TIME * BC] = rail_time;
    o[O_RAIL_SPEED * BC] = rail_speed;
    o[O_RAIL_AOA * BC] = rail_aoa;
    o[O_RAIL_SLIP * BC] = rail_slip;
    o[O_RPX * BC] = rpx;
    o[O_RPY * BC] = rpy;
    o[O_RPZ * BC] = rpz;
    o[O_RVX * BC] = rvx0;
    o[O_RVY * BC] = rvy0;
    o[O_RVZ * BC] = rvz0;
    o[O_RWU * BC] = wexit[0];
    o[O_RWV * BC] = wexit[1];
    o[O_RWW * BC] = wexit[2];
    o[O_QW * BC] = qw;
    o[O_QX * BC] = qx;
    o[O_QY * BC] = qy;
    o[O_QZ * BC] = qz;
  }
#endif

  // ---------------- main loop: RK4 (or rk2) with masked events
  T s[N_STATE] = {rpx, rpy, rpz, rvx0, rvy0, rvz0, qw, qx, qy, qz,
                  leaf(lv, L_OX, lane), leaf(lv, L_OY, lane), leaf(lv, L_OZ, lane), frac};
  int step = 0, para = 0, apod = 0, done = 0, div = 0;
  T apo_t = T(0), max_coast = T(0), max_alt = rpz, t_max = rail_time,
#if FS_SAFE_NORM_SPEED
    // the stacked engine's running maximum starts from safe_norm; the
    // rail-exit speed leaf keeps its NaN (jnp.linalg.norm) there too
    max_spd = safe_norm_sq(rvx0 * rvx0 + rvy0 * rvy0 + rvz0 * rvz0),
#else
    max_spd = rail_speed,
#endif
    end_t = rail_time;
  // the tiered loop's own time and the time the chute latched
  T t_lane = rail_time, dep_t = T(INFINITY);
#if FS_CARRY
  if (ck.first == 0) {
#pragma unroll
    for (int i = 0; i < N_STATE; ++i) s[i] = cf[(C_S + i) * BC];
    step = ci[C_STEP * BC];
    para = ci[C_PARA * BC];
    apod = ci[C_APOD * BC];
    done = ci[C_DONE * BC];
    div = ci[C_DIV * BC];
    apo_t = cf[C_APO_T * BC];
    max_coast = cf[C_MAX_COAST * BC];
    max_alt = cf[C_MAX_ALT * BC];
    t_max = cf[C_T_MAX * BC];
    max_spd = cf[C_MAX_SPD * BC];
    end_t = cf[C_END_T * BC];
    t_lane = cf[C_T_LANE * BC];
    dep_t = cf[C_DEP_T * BC];
  }
  // the chunk ends after ck.steps steps
  const long long chunk_end = static_cast<long long>(step) + ck.steps;
  const int last_step = chunk_end < cfg.max_steps ? static_cast<int>(chunk_end) : cfg.max_steps;
#endif
  T wstep[3];  // wind_eval_per_step: the wind at the step's starting altitude
  constexpr int kStages = kRk2 ? 2 : 4;
  // the recording build: the frame last written, and the steps since
  int frame = 0, since = 0;
  if constexpr (kRecord) {
    record_state(rec, n_lanes, lane, 0,
                 (kTiered ? t_lane : step_time(rail_time, step, cfg.dt)) - rail_time, s);
  }

  while (done == 0 && ((kTiered ? t_lane : step_time(rail_time, step, cfg.dt)) < cfg.max_time) &&
#if FS_CARRY
         step < last_step
#else
         step < cfg.max_steps
#endif
         ) {
    T t, dt = cfg.dt, half = cfg.half_dt, dt6 = cfg.dt6;
    if constexpr (kTiered) {
      t = t_lane;
      if (coarse_step(ln, cfg, s, t, apod, para, apo_t, dep_t)) {
        dt = cfg.dt_big;
        half = cfg.half_dt_big;
        dt6 = cfg.dt6_big;
      }
    } else {
      t = step_time(rail_time, step, cfg.dt);
    }
    if constexpr (kWindPerStep) wind_at(tb, ln, s[S_PZ], wstep);
    // RK4 with one running stage sum: acc = (k1 + 2 k2) + 2 k3, then
    // s + dt/6 (acc + k4), the order and rounding of
    // s + dt/6 (k1 + 2 k2 + 2 k3 + k4). The stages are one loop, so the
    // kernel holds one copy of dynamics, not four. rk2 stops after the
    // second stage and takes s + dt k2.
    T acc[N_STATE], k[N_STATE], tmp[N_STATE];
    int p = para;
#pragma unroll
    for (int i = 0; i < N_STATE; ++i) tmp[i] = s[i];
#pragma unroll 1
    for (int stage = 0; stage < kStages; ++stage) {
      const T ts = stage == 0 ? t : (stage == 3 ? t + dt : t + half);
      dynamics(tb, ln, cfg, ts, tmp, p, k, wstep);
      if (stage == kStages - 1) break;
      const T h = stage == 2 ? dt : half;
#pragma unroll
      for (int i = 0; i < N_STATE; ++i) {
        if constexpr (!kRk2) acc[i] = stage == 0 ? k[i] : acc[i] + T(2) * k[i];
        tmp[i] = s[i] + h * k[i];
      }
    }
#pragma unroll
    for (int i = 0; i < N_STATE; ++i) {
      if constexpr (kRk2) {
        s[i] = s[i] + dt * k[i];
      } else {
        s[i] = s[i] + dt6 * (acc[i] + k[i]);
      }
    }
    quat_normalize(s[S_QW], s[S_QX], s[S_QY], s[S_QZ]);
    const bool latched = p > para;
    para = p;

    const int step_new = step + 1;
    T t_new;
    if constexpr (kTiered) {
      t_new = t + dt;
    } else {
      t_new = step_time(rail_time, step_new, cfg.dt);
    }
    const T alt = s[S_PZ], vzn = s[S_VZ];
    // the speed feeds the running maximum, the non-finite stop and the guard
#if FS_SAFE_NORM_SPEED
    const T speed = safe_norm_sq(s[S_VX] * s[S_VX] + s[S_VY] * s[S_VY] + s[S_VZ] * s[S_VZ]);
#else
    const T speed = safe_sqrt(s[S_VX] * s[S_VX] + s[S_VY] * s[S_VY] + s[S_VZ] * s[S_VZ]);
#endif

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
    bool newly_div = false;
    if constexpr (kTerminate) {
      newly_div = !(m_finite(alt) && m_finite(vzn) && m_finite(speed));
      if constexpr (kSpeedGuard) newly_div = newly_div || !(speed < cfg.speed_guard);
    }
    if (newly_div) div = 1;
    // done was 0 on entry, so end_t takes this step's time
    end_t = t_new;
    if (ground || excessive || coast_done || newly_div) done = 1;
    if constexpr (kTiered) {
      if (latched) dep_t = t_new;
      t_lane = t_new;
    }
    step = step_new;
    if constexpr (kRecord) {
      if (++since == rec.stride) {
        since = 0;
        record_state(rec, n_lanes, lane, ++frame, t_new - rail_time, s);
      }
    }
  }
  if constexpr (kRecord) {
    // a lane that stopped inside a block: its terminal frame ends the block
    if (since > 0) {
      record_state(rec, n_lanes, lane, ++frame,
                   (kTiered ? t_lane : step_time(rail_time, step, cfg.dt)) - rail_time, s);
    }
    rec.stop[lane] = frame;
  }
#if FS_CARRY
  {
    // the carry for the next chunk, and whether this lane takes one
    int32_t* co = ck.i + lane;
    T* fo = ck.f + lane;
#pragma unroll
    for (int i = 0; i < N_STATE; ++i) fo[(C_S + i) * BC] = s[i];
    co[C_STEP * BC] = step;
    co[C_PARA * BC] = para;
    co[C_APOD * BC] = apod;
    co[C_DONE * BC] = done;
    co[C_DIV * BC] = div;
    fo[C_APO_T * BC] = apo_t;
    fo[C_MAX_COAST * BC] = max_coast;
    fo[C_MAX_ALT * BC] = max_alt;
    fo[C_T_MAX * BC] = t_max;
    fo[C_MAX_SPD * BC] = max_spd;
    fo[C_END_T * BC] = end_t;
    fo[C_T_LANE * BC] = t_lane;
    fo[C_DEP_T * BC] = dep_t;
    fo[C_RAIL_TIME * BC] = rail_time;
    if (done == 0 && ((kTiered ? t_lane : step_time(rail_time, step, cfg.dt)) < cfg.max_time) &&
        step < cfg.max_steps)
      *ck.active = 1;
  }
#endif

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
#if !FS_CARRY
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
#endif
  int32_t* oi = out_i + lane;
  oi[O_PARA * B] = para;
  oi[O_DIV * B] = div;
  oi[O_NSTEPS * B] = step;
}

// each block: the shared tables and the wind grid into shared memory, the
// table flags, the wind segment guess's scale
__device__ __forceinline__ void stage_tables(const Tables& tb) {
  stage_knots(tb.cd, tb.cd_mach, tb.cd0, tb.cda);
  stage_knots(tb.cp, tb.cp_mach, tb.cp_shift, nullptr);
  stage_knots(tb.th, tb.curve_t, tb.curve_f, nullptr);
  stage_knots(tb.g, tb.grid, nullptr, nullptr);
  if (threadIdx.x < N_FLAGS) s_flags[threadIdx.x] = tb.flags[threadIdx.x];
  if (threadIdx.x == 0) s_grid_inv_h = T(tb.g.k - 1) / (tb.grid[tb.g.k - 1] - tb.grid[0]);
}

__global__ void __launch_bounds__(kThreads, kMinBlocks)
flight_summary_kernel(Leaves lv, Tables tb, Cfg cfg, T* __restrict__ out_f,
                      int32_t* __restrict__ out_i, int n_lanes FS_REC_KPARAM FS_CHUNK_KPARAM) {
  stage_tables(tb);
  // every thread of the block reaches this barrier: the ragged last block's
  // idle threads skip only the flight
  __syncthreads();
  const long long lane = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (lane < n_lanes) fly(lv, tb, cfg, out_f, out_i, n_lanes, lane FS_REC_ARG FS_CHUNK_ARG);
}

#if FS_RECORD
// ------------------------------------------------------------ derived pass
// The recording build's derived pass, record_derived_kernel: the derived
// channels of every recorded frame up to each lane's stop frame, from the
// frame's stored time and state (derived_channels), written into the
// frames the flight left them in.
//
// It replaces no TPU kernel. It is engine/component.py derived_c, which the
// JAX package's recorder (flight_components_trajectory) evaluates on each
// frame inside XLA's loop. Run as the flight's epilogue, it was close to a
// fifth dynamics evaluation on the lane's serial chain at every recorded
// step; here it runs after the flight, in parallel over (frame, lane), with
// the flight's own functions and lane constants (setup_lane), so each
// channel is the epilogue's value bit for bit.
//
// What bounds it: bytes. A frame reads its 15 stored values and writes its
// derived channels: 140 bytes in float32 with all 20, against about 300
// operations (kernels/flight_summary.py OPS_PER_FRAME), some 2 operations a
// byte, below the H100's 20 (67 TFLOP/s over 3.35 TB/s).
// Design, against that: a warp holds 32 neighbouring lanes of one frame, so
// each load and store of a channel is one coalesced row of the lane-minor
// buffer; a block is kDRows warps over kDRows runs of kDFrames frames of
// the same 32 lanes, so the shared tables are staged once for
// kDRows x kDFrames frames and a lane's set-up (its constants, its wind
// table's finiteness scan) once for kDFrames; a block whose frames all lie
// past its lanes' stop frames returns before it stages anything.
constexpr int kDLanes = 32;
constexpr int kDRows = 4;
constexpr int kDThreads = kDLanes * kDRows;
constexpr int kDFrames = 16;

__global__ void __launch_bounds__(kDThreads)
record_derived_kernel(Leaves lv, Tables tb, Rec rec, int n_lanes, int n_frames,
                      int lane_blocks) {
  const int lb = blockIdx.x % lane_blocks, fb = blockIdx.x / lane_blocks;
  const long long lane = static_cast<long long>(lb) * kDLanes + (threadIdx.x % kDLanes);
  const int f0 = (fb * kDRows + static_cast<int>(threadIdx.x / kDLanes)) * kDFrames;
  const int stop = lane < n_lanes ? rec.stop[lane] : -1;
  int f1 = f0 + kDFrames;
  if (f1 > stop + 1) f1 = stop + 1;
  if (f1 > n_frames) f1 = n_frames;
  // every thread reaches both barriers
  if (!__syncthreads_or(f0 < f1)) return;
  stage_tables(tb);
  __syncthreads();
  if (f0 >= f1) return;
  Lane ln;
  setup_lane(lv, tb, lane, ln);
  const long long B = n_lanes;
  for (int f = f0; f < f1; ++f) {
    T* o = rec.frames + static_cast<long long>(f) * rec.n_channels * B + lane;
    T s[N_STATE];
#pragma unroll
    for (int i = 0; i < N_STATE; ++i) s[i] = o[(i + 1) * B];
    derived_channels(tb, ln, rec.mask, o[0], s, o, B);
  }
}
#endif

// the places of the shared tables and the lane constants in the block's
// shared memory, and its bytes (the recording build keeps no lane constants
// there)
__host__ int layout(Tables& tb, int k_cd, int k_cp, int k_th, int n_wind) {
  tb.cd = Knots{0, k_cd};
  tb.cp = Knots{tb.cd.base + 7 * k_cd, k_cp};
  tb.th = Knots{tb.cp.base + 6 * k_cp, k_th};
  tb.g = Knots{tb.th.base + 6 * k_th, n_wind};
  tb.lane_base = tb.g.base + 5 * n_wind;
  return static_cast<int>((tb.lane_base + (kRecord ? 0 : N_LANE_FIELDS * kThreads)) * sizeof(T));
}

// Leaves and Tables from the C entries' host arrays (their comment below);
// returns the block's shared memory bytes, or -1 for a wrong leaf count
__host__ int read_inputs(const void* const* leaf_ptrs, const int* leaf_strides, int n_leaves,
                         const void* const* table_ptrs, const int* table_sizes,
                         long long wind_lane_stride, int n_lanes, Leaves& lv, Tables& tb) {
  if (n_leaves != N_LEAVES) return -1;
  for (int k = 0; k < N_LEAVES; ++k) {
    lv.p[k] = static_cast<const T*>(leaf_ptrs[k]);
    lv.stride[k] = leaf_strides[k];
  }
  tb.cd_mach = static_cast<const T*>(table_ptrs[0]);
  tb.cd0 = static_cast<const T*>(table_ptrs[1]);
  tb.cda = static_cast<const T*>(table_ptrs[2]);
  tb.cp_mach = static_cast<const T*>(table_ptrs[3]);
  tb.cp_shift = static_cast<const T*>(table_ptrs[4]);
  tb.curve_t = static_cast<const T*>(table_ptrs[5]);
  tb.curve_f = static_cast<const T*>(table_ptrs[6]);
  tb.grid = static_cast<const T*>(table_ptrs[7]);
  tb.wind = static_cast<const W*>(table_ptrs[8]);
  tb.wind_lane_stride = wind_lane_stride;
  tb.wind_comp_stride = wind_lane_stride == 0 ? 1 : n_lanes;
  tb.flags = static_cast<const int*>(table_ptrs[9]);
  return layout(tb, table_sizes[0], table_sizes[1], table_sizes[2], table_sizes[3]);
}

// a kernel's dynamic shared memory above the default 48 KB
template <class K>
__host__ int allow_smem(K kernel, int smem) {
  if (smem <= 48 * 1024) return 0;
  return static_cast<int>(
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem));
}

}  // namespace

#define FS_CAT2(a, b) a##b
#define FS_CAT(a, b) FS_CAT2(a, b)

// C entry: flight_summary_f32 (FS_F32=1) / flight_summary_f64 (FS_F32=0). All pointers are device
// pointers except leaf_ptrs, leaf_strides, table_ptrs, table_sizes and cfg,
// which are host arrays. table_ptrs holds the seven tables (Tables order),
// the wind grid, the wind table (lane-minor [N,3,B] when wind_lane_stride
// is 1, shared [N,3] when it is 0; of W, bfloat16 in a FS_WIND_BF16 build)
// and the int flags; table_sizes the knots of the Mach, CP and thrust
// tables and of the grid; cfg the N_CFG numbers of Cfg. Launches on
// `stream`, allocates nothing, returns cudaGetLastError() after the launch.
// The recording build's entry is flight_record_f32 / _f64, with five more
// arguments: the frames [n_frames][n_channels][B] and stop [B] (device
// pointers), record_stride, n_channels and the derived-channel mask (Rec).
// The carry build's entry is flight_chunk_f32 / _f64, with five more: the
// carry [N_CARRY_F][B] of T and [N_CARRY_I][B] of int32 and the int32 flag
// the lanes that take another chunk set (device pointers), whether this is
// the first chunk, and the chunk's steps at most (Chunk).
#if FS_RECORD
extern "C" int FS_CAT(flight_record_, FS_SUFFIX)(
    const void* const* leaf_ptrs, const int* leaf_strides, int n_leaves,
    const void* const* table_ptrs, const int* table_sizes,
    long long wind_lane_stride, const double* cfg_in, int n_cfg, int max_steps,
    int max_rail_steps, void* out_f, void* out_i, int n_lanes, void* stream, void* frames,
    void* stop, int record_stride, int n_channels, unsigned channel_mask) {
  if (record_stride < 1 || n_channels != 1 + N_STATE + __builtin_popcount(channel_mask) ||
      (channel_mask >> N_DERIVED) != 0)
    return -1;
  Rec rec;
  rec.frames = static_cast<T*>(frames);
  rec.stop = static_cast<int32_t*>(stop);
  rec.stride = record_stride;
  rec.n_channels = n_channels;
  rec.mask = channel_mask;
#elif FS_CARRY
extern "C" int FS_CAT(flight_chunk_, FS_SUFFIX)(
    const void* const* leaf_ptrs, const int* leaf_strides, int n_leaves,
    const void* const* table_ptrs, const int* table_sizes,
    long long wind_lane_stride, const double* cfg_in, int n_cfg, int max_steps,
    int max_rail_steps, void* out_f, void* out_i, int n_lanes, void* stream, void* carry_f,
    void* carry_i, void* active, int first, int chunk_steps) {
  if (chunk_steps < 1) return -1;
  Chunk ck;
  ck.f = static_cast<T*>(carry_f);
  ck.i = static_cast<int32_t*>(carry_i);
  ck.active = static_cast<int32_t*>(active);
  ck.first = first;
  ck.steps = chunk_steps;
#else
extern "C" int FS_CAT(flight_summary_, FS_SUFFIX)(
    const void* const* leaf_ptrs, const int* leaf_strides, int n_leaves,
    const void* const* table_ptrs, const int* table_sizes,
    long long wind_lane_stride, const double* cfg_in, int n_cfg, int max_steps,
    int max_rail_steps, void* out_f, void* out_i, int n_lanes, void* stream) {
#endif
  if (n_leaves != N_LEAVES || n_cfg != N_CFG) return -1;
  if (n_lanes <= 0) return 0;
  Leaves lv;
  Tables tb;
  const int smem = read_inputs(leaf_ptrs, leaf_strides, n_leaves, table_ptrs, table_sizes,
                               wind_lane_stride, n_lanes, lv, tb);
  if (const int e = allow_smem(flight_summary_kernel, smem)) return e;
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
  cfg.speed_guard = static_cast<T>(cfg_in[16]);
  cfg.dt_big = static_cast<T>(cfg_in[17]);
  cfg.half_dt_big = static_cast<T>(cfg_in[18]);
  cfg.dt6_big = static_cast<T>(cfg_in[19]);
  cfg.settle_time = static_cast<T>(cfg_in[20]);
  cfg.q_threshold = static_cast<T>(cfg_in[21]);
  cfg.max_steps = max_steps;
  cfg.max_rail_steps = max_rail_steps;
  const int blocks = (n_lanes + kThreads - 1) / kThreads;
  flight_summary_kernel<<<blocks, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      lv, tb, cfg, static_cast<T*>(out_f), static_cast<int32_t*>(out_i), n_lanes FS_REC_ARG
      FS_CHUNK_ARG);
  return static_cast<int>(cudaGetLastError());
}

// C entry: flight_summary_occupancy_f32 / _f64. The flight kernel's threads
// per block and the blocks of it one SM holds at once, for tables of
// table_sizes knots (as in the launch); returns the CUDA error of the query.
extern "C" int FS_CAT(flight_summary_occupancy_, FS_SUFFIX)(const int* table_sizes,
                                                            int* threads,
                                                            int* blocks_per_sm) {
  Tables tb;
  const int smem = layout(tb, table_sizes[0], table_sizes[1], table_sizes[2], table_sizes[3]);
  *threads = kThreads;
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, flight_summary_kernel, kThreads, smem));
}

#if FS_RECORD
// C entry of the derived pass: flight_record_derived_f32 / _f64, after
// flight_record_* on the same stream. The inputs as flight_record_* takes
// them, then the frames [n_frames][n_channels][B] and stop [B] that it
// wrote (device pointers), n_frames, n_channels and the derived-channel
// mask (not 0). Launches on `stream`, allocates nothing, returns
// cudaGetLastError() after the launch.
extern "C" int FS_CAT(flight_record_derived_, FS_SUFFIX)(
    const void* const* leaf_ptrs, const int* leaf_strides, int n_leaves,
    const void* const* table_ptrs, const int* table_sizes, long long wind_lane_stride,
    int n_lanes, void* stream, void* frames, void* stop, int n_frames, int n_channels,
    unsigned channel_mask) {
  if (channel_mask == 0 || n_channels != 1 + N_STATE + __builtin_popcount(channel_mask) ||
      (channel_mask >> N_DERIVED) != 0 || n_frames < 1)
    return -1;
  if (n_lanes <= 0) return 0;
  Leaves lv;
  Tables tb;
  const int smem = read_inputs(leaf_ptrs, leaf_strides, n_leaves, table_ptrs, table_sizes,
                               wind_lane_stride, n_lanes, lv, tb);
  if (smem < 0) return -1;
  if (const int e = allow_smem(record_derived_kernel, smem)) return e;
  Rec rec;
  rec.frames = static_cast<T*>(frames);
  rec.stop = static_cast<int32_t*>(stop);
  rec.n_channels = n_channels;
  rec.mask = channel_mask;
  const int lane_blocks = (n_lanes + kDLanes - 1) / kDLanes;
  const int frame_blocks = (n_frames + kDRows * kDFrames - 1) / (kDRows * kDFrames);
  const long long blocks = static_cast<long long>(lane_blocks) * frame_blocks;
  if (blocks > 0x7fffffffLL) return -1;
  record_derived_kernel<<<static_cast<unsigned>(blocks), kDThreads, smem,
                          static_cast<cudaStream_t>(stream)>>>(lv, tb, rec, n_lanes, n_frames,
                                                               lane_blocks);
  return static_cast<int>(cudaGetLastError());
}

// C entry: flight_record_derived_occupancy_f32 / _f64, the derived pass's
// threads per block and blocks per SM, as flight_summary_occupancy_*.
extern "C" int FS_CAT(flight_record_derived_occupancy_, FS_SUFFIX)(const int* table_sizes,
                                                                   int* threads,
                                                                   int* blocks_per_sm) {
  Tables tb;
  const int smem = layout(tb, table_sizes[0], table_sizes[1], table_sizes[2], table_sizes[3]);
  *threads = kDThreads;
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, record_derived_kernel, kDThreads, smem));
}
#endif
