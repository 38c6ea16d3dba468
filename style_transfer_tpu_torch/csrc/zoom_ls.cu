// One step of the zoom line search's state machine, for Hopper (sm_90a).
//
// Not the port of a TPU kernel. The JAX runner's `optax.lbfgs` runs its
// zoom line search (optax 0.2.6 `zoom_linesearch`: Nocedal and Wright's
// Algorithms 3.5 and 3.6 with Hager and Zhang's approximate decrease
// criterion) as a `lax.while_loop` inside the compiled chunk
// (style_transfer_tpu/step.py:649, `make_lbfgs_zoom_runner`). The port keeps
// the search's scalars in one float32 vector on the device (`enum Field`,
// in the order of `LS_FIELDS` in ops/cuda/zoom_ls.py) and runs each of up
// to 20 trials per iteration as a replay of a CUDA graph of one trial (the
// host reads only the flag `go` between them: step.py's `_Runner`). This
// kernel takes the trial just run into the state: its decisions,
// then the next trial's step size or the final step, and `go`. One thread,
// one launch per trial, in place of the plain version's scalar ATen
// launches (`ls_step_plain_`: one per `where`, product and comparison).
//
// It must equal the plain version bit for bit (NaN payloads aside), so
// every product, sum and quotient is an explicitly rounded intrinsic in
// the plain version's order (nvcc would contract a * b + c into an FMA),
// min and max are numpy's (NaN if either operand is; the second operand on
// a tie), and the square root of a negative radical is NaN, so that the
// cubic's range test fails as it does there.
//
// What bounds it: its bytes, on paper: it reads 23 floats and writes 21
// and a bool (0.05 ns at 3.35 TB/s), with under a hundred floating-point
// operations. In practice a launch is its whole cost.

#include <cuda_runtime.h>

namespace {

enum Field {
  kValueInit, kSlopeInit,
  kLow, kValueLow, kSlopeLow,
  kHigh, kValueHigh, kSlopeHigh,
  kCubicRef, kValueCubicRef,
  kSafeStepsize, kSafeValue,
  kPrevStepsize, kPrevValue, kPrevSlope,
  kStepsize, kDecreaseError,
  kIntervalFound, kDone, kFailed, kCount,
  kNumFields
};

// optax's defaults, each a double rounded to float32 as numpy rounds them.
constexpr float kSlopeRtol = static_cast<float>(1e-4);
constexpr float kCurvRtol = static_cast<float>(0.9);
constexpr float kApproxDecRtol = static_cast<float>(1e-6);
constexpr float kApproxSlope = static_cast<float>(2 * 1e-4 - 1.0);
constexpr float kStepsizePrecision = static_cast<float>(1e-5);
constexpr float kCubicChk = static_cast<float>(0.2);
constexpr float kQuadChk = static_cast<float>(0.1);

__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float div(float a, float b) { return __fdiv_rn(a, b); }
__device__ __forceinline__ float np_max(float a, float b) {
  return (isnan(a) || a > b) ? a : b;
}
__device__ __forceinline__ float np_min(float a, float b) {
  return (isnan(a) || a < b) ? a : b;
}
__device__ __forceinline__ float nan_to_inf(float x) {
  return isnan(x) ? __int_as_float(0x7f800000) : x;
}

__device__ float decrease_error(float stepsize, float value, float slope,
                                float value_init, float slope_init) {
  float err = sub(sub(value, value_init), mul(mul(kSlopeRtol, stepsize), slope_init));
  const float approx = sub(slope, mul(kApproxSlope, slope_init));
  const float delta = sub(sub(value, value_init), mul(kApproxDecRtol, fabsf(value_init)));
  err = np_max(np_min(np_max(approx, delta), err), 0.0f);
  return nan_to_inf(err);
}

__device__ float curvature_error(float slope, float slope_init) {
  return nan_to_inf(np_max(sub(fabsf(slope), mul(kCurvRtol, fabsf(slope_init))), 0.0f));
}

__device__ float cubicmin(float a, float fa, float fpa, float b, float fb, float c,
                          float fc) {
  const float db = sub(b, a);
  const float dc = sub(c, a);
  const float dbdc = mul(db, dc);
  const float denom = mul(mul(dbdc, dbdc), sub(db, dc));
  const float v0 = sub(sub(fb, fa), mul(fpa, db));
  const float v1 = sub(sub(fc, fa), mul(fpa, dc));
  const float A = div(add(mul(mul(dc, dc), v0), mul(-mul(db, db), v1)), denom);
  const float B = div(add(mul(-mul(mul(dc, dc), dc), v0), mul(mul(mul(db, db), db), v1)),
                      denom);
  const float radical = sub(mul(B, B), mul(mul(3.0f, A), fpa));
  return add(a, div(add(-B, __fsqrt_rn(radical)), mul(3.0f, A)));
}

__device__ float quadmin(float a, float fa, float fpa, float b, float fb) {
  const float db = sub(b, a);
  const float B = div(sub(sub(fb, fa), mul(fpa, db)), mul(db, db));
  return sub(a, div(fpa, mul(2.0f, B)));
}

__global__ void stt_zls_step(float* __restrict__ s, bool* __restrict__ go,
                             const float* __restrict__ value_ptr,
                             const float* __restrict__ slope_ptr, int max_steps) {
  const float value = *value_ptr;
  const float slope = *slope_ptr;
  const float stepsize = s[kStepsize];
  const float count = s[kCount];
  const float low = s[kLow], value_low = s[kValueLow], slope_low = s[kSlopeLow];
  const float high = s[kHigh], value_high = s[kValueHigh], slope_high = s[kSlopeHigh];
  const float dec = decrease_error(stepsize, value, slope, s[kValueInit], s[kSlopeInit]);
  const bool done = np_max(dec, curvature_error(slope, s[kSlopeInit])) <= 0.0f;
  const bool last = add(count, 1.0f) >= static_cast<float>(max_steps);
  const bool searching = s[kIntervalFound] == 0.0f;

  float n_low, n_value_low, n_slope_low, n_high, n_value_high, n_slope_high;
  float cubic_ref, value_cubic_ref;
  bool take_safe, found, failed;
  if (searching) {  // Algorithm 3.5: the trial against the one before
    const bool set_high = dec > 0.0f || (value >= s[kPrevValue] && count > 0.0f);
    const bool set_low = slope >= 0.0f && !set_high;
    if (set_low) {
      n_low = stepsize; n_value_low = value; n_slope_low = slope;
      n_high = s[kPrevStepsize]; n_value_high = s[kPrevValue]; n_slope_high = s[kPrevSlope];
    } else {
      n_low = s[kPrevStepsize]; n_value_low = s[kPrevValue]; n_slope_low = s[kPrevSlope];
      n_high = stepsize; n_value_high = value; n_slope_high = slope;
    }
    cubic_ref = n_low;
    value_cubic_ref = n_value_low;
    take_safe = dec <= 0.0f;
    found = set_high || set_low || done;
    failed = last && !done;
  } else {  // Algorithm 3.6: the trial inside [low, high]
    take_safe = dec <= 0.0f && value < s[kSafeValue];
    const bool to_middle = dec > 0.0f || value >= value_low;
    const bool to_low = mul(slope, sub(high, low)) >= 0.0f && !to_middle;
    // The new reference of the cubic is the end that moves.
    cubic_ref = (to_middle || to_low) ? high : low;
    value_cubic_ref = (to_middle || to_low) ? value_high : value_low;
    if (to_middle) {
      n_high = stepsize; n_value_high = value; n_slope_high = slope;
    } else if (to_low) {
      n_high = low; n_value_high = value_low; n_slope_high = slope_low;
    } else {
      n_high = high; n_value_high = value_high; n_slope_high = slope_high;
    }
    if (to_middle) {
      n_low = low; n_value_low = value_low; n_slope_low = slope_low;
    } else {
      n_low = stepsize; n_value_low = value; n_slope_low = slope;
    }
    const bool too_small = fabsf(sub(high, low)) <= kStepsizePrecision;
    const float safe = take_safe ? stepsize : s[kSafeStepsize];
    found = true;
    failed = (last || (too_small && safe > 0.0f)) && !done;
  }
  const float safe_stepsize = take_safe ? stepsize : s[kSafeStepsize];
  const float safe_value = take_safe ? value : s[kSafeValue];
  const bool stop = done || failed;

  // The next trial: twice the step while searching, else the cubic's or
  // the quadratic's minimum well inside [low, high], else the midpoint.
  const float delta = fabsf(sub(n_high, n_low));
  const float left = np_min(n_high, n_low), right = np_max(n_high, n_low);
  const float cubic = cubicmin(n_low, n_value_low, n_slope_low, n_high, n_value_high,
                               cubic_ref, value_cubic_ref);
  const float quad = quadmin(n_low, n_value_low, n_slope_low, n_high, n_value_high);
  const bool cubic_in = add(left, mul(kCubicChk, delta)) < cubic &&
                        cubic < sub(right, mul(kCubicChk, delta));
  const bool quad_in = add(left, mul(kQuadChk, delta)) < quad &&
                       quad < sub(right, mul(kQuadChk, delta));
  const float middle = cubic_in ? cubic : (quad_in ? quad : mul(add(n_low, n_high), 0.5f));
  const float following = found ? middle : mul(2.0f, stepsize);
  // At the end: the trial's step, or the safe one after a failure.
  const float final_step =
      (failed && (safe_stepsize > 0.0f || isinf(dec))) ? safe_stepsize : stepsize;
  const bool advance = !stop && !found;  // the next trial is the interval search's

  s[kLow] = n_low; s[kValueLow] = n_value_low; s[kSlopeLow] = n_slope_low;
  s[kHigh] = n_high; s[kValueHigh] = n_value_high; s[kSlopeHigh] = n_slope_high;
  s[kCubicRef] = cubic_ref; s[kValueCubicRef] = value_cubic_ref;
  s[kSafeStepsize] = safe_stepsize; s[kSafeValue] = safe_value;
  if (advance) {
    s[kPrevStepsize] = stepsize; s[kPrevValue] = value; s[kPrevSlope] = slope;
  }
  s[kStepsize] = stop ? final_step : following;
  s[kDecreaseError] = dec;
  s[kIntervalFound] = found ? 1.0f : 0.0f;
  s[kDone] = done ? 1.0f : 0.0f;
  s[kFailed] = failed ? 1.0f : 0.0f;
  s[kCount] = add(count, 1.0f);
  *go = !stop;
}

}  // namespace

// state: kNumFields floats, written in place; go: one bool; value, slope:
// one float each (the trial at state[kStepsize]). Returns the launch's
// cudaError_t.
extern "C" int stt_zoom_ls_num_fields() { return kNumFields; }

extern "C" int stt_zoom_ls_step_f32(float* state, bool* go, const float* value,
                                    const float* slope, int max_steps, void* stream_ptr) {
  stt_zls_step<<<1, 1, 0, static_cast<cudaStream_t>(stream_ptr)>>>(state, go, value, slope,
                                                                 max_steps);
  return static_cast<int>(cudaGetLastError());
}
