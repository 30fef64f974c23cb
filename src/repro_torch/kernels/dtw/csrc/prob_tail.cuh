// Score tails of the verdict scorers (score.cu): the warp correlation of
// the point verdict (K2) and the match probabilities of the variance
// verdicts (K5 exact, K6 approx), read from the moments captured at the
// closed alignment endpoint.
//
// Each function is the reference's definition (repro/core/dtw.py:
// _corr_from_moments, _prob_from_moments, _prob_from_moments_approx)
// with the same operations in the same order as its jnp expression and
// as the port's plain PyTorch version (kernels/dtw/score.py), every add,
// multiply, divide and square root correctly rounded (_rn intrinsics, no
// FMA contraction). Only erfcf differs between implementations in the
// last bits, so probabilities agree with the plain version to a
// tolerance, and bitwise at zero variance, where sigma is exactly 0 and
// the probability is the point rule r_hat >= threshold in {0, 1}.
#pragma once

#include <cuda_runtime.h>

namespace dtw {

// _corr_from_moments, with its degenerate-variance conventions.
__device__ __forceinline__ float corr_from_moments(float sy, float syy,
                                                   float sxy, float sx,
                                                   float sxx, float n) {
  const float sx2n = __fdiv_rn(__fmul_rn(sx, sx), n);
  const float sy2n = __fdiv_rn(__fmul_rn(sy, sy), n);
  const float vx = fmaxf(__fsub_rn(sxx, sx2n), 0.f);
  const float vy = fmaxf(__fsub_rn(syy, sy2n), 0.f);
  const float cov = __fsub_rn(sxy, __fdiv_rn(__fmul_rn(sx, sy), n));
  const float denom = __fsqrt_rn(__fmul_rn(vx, vy));
  const float corr = fminf(
      fmaxf(__fdiv_rn(cov, denom > 0.f ? denom : 1.f), -1.f), 1.f);
  const bool degx =
      vx <= __fadd_rn(__fmul_rn(1e-5f, __fadd_rn(sxx, sx2n)), 1e-12f);
  const bool degy =
      vy <= __fadd_rn(__fmul_rn(1e-5f, __fadd_rn(syy, sy2n)), 1e-12f);
  const bool both =
      degx && degy && __fdiv_rn(fabsf(__fsub_rn(sx, sy)), n) < 1e-6f;
  return (degx || degy) ? (both ? 1.f : 0.f) : corr;
}

// What both probability tails share: the point correlation r, the
// variances vx and vy, the covariance, the disattenuated r_hat and the
// delta-method derivatives a = dr/dsx, b = dr/dsxx, c = dr/dsxy.
struct TailCore {
  float r, vx, vy, cov, safe_vx, r_hat, a, b, c;
};

__device__ __forceinline__ TailCore tail_core(float sy, float syy, float sxy,
                                              float sx, float sxx, float sv,
                                              float n) {
  TailCore t;
  t.r = corr_from_moments(sy, syy, sxy, sx, sxx, n);
  t.vx = fmaxf(__fsub_rn(sxx, __fdiv_rn(__fmul_rn(sx, sx), n)), 0.f);
  t.vy = fmaxf(__fsub_rn(syy, __fdiv_rn(__fmul_rn(sy, sy), n)), 0.f);
  t.cov = __fsub_rn(sxy, __fdiv_rn(__fmul_rn(sx, sy), n));
  const float denom = __fsqrt_rn(__fmul_rn(t.vx, t.vy));
  t.safe_vx = t.vx > 0.f ? t.vx : 1.f;
  // disattenuation: E[vx_obs] = vx_true + sv, cov unbiased.
  const float den =
      fminf(fmaxf(__fsub_rn(t.vx, sv), __fmul_rn(t.vx, 0.25f)), t.vx);
  const float g =
      den > 0.f ? __fsqrt_rn(__fdiv_rn(t.vx, den > 0.f ? den : 1.f)) : 1.f;
  t.r_hat = fminf(fmaxf(__fmul_rn(t.r, g), -1.f), 1.f);
  t.c = __fdiv_rn(1.f, denom > 0.f ? denom : 1.f);
  t.a = __fadd_rn(__fdiv_rn(__fmul_rn(-t.c, sy), n),
                  __fdiv_rn(__fmul_rn(t.r, sx), __fmul_rn(n, t.safe_vx)));
  t.b = __fdiv_rn(-t.r, __fmul_rn(2.f, t.safe_vx));
  return t;
}

// a^2 sv + 4ab svx + 4b^2 svxx + 2ac svy + 4bc svxy + c^2 svyy -> P.
__device__ __forceinline__ float tail_prob(const TailCore& t, float sv,
                                           float svx, float svxx, float svy,
                                           float svxy, float svyy,
                                           float threshold) {
  const float a = t.a, b = t.b, c = t.c;
  float var_r = __fmul_rn(__fmul_rn(a, a), sv);
  var_r = __fadd_rn(var_r, __fmul_rn(__fmul_rn(__fmul_rn(4.f, a), b), svx));
  var_r = __fadd_rn(var_r, __fmul_rn(__fmul_rn(__fmul_rn(4.f, b), b), svxx));
  var_r = __fadd_rn(var_r, __fmul_rn(__fmul_rn(__fmul_rn(2.f, a), c), svy));
  var_r = __fadd_rn(var_r, __fmul_rn(__fmul_rn(__fmul_rn(4.f, b), c), svxy));
  var_r = __fadd_rn(var_r, __fmul_rn(__fmul_rn(c, c), svyy));
  const float sigma = __fsqrt_rn(fmaxf(var_r, 0.f));
  const float z = __fdiv_rn(__fsub_rn(t.r_hat, threshold),
                            sigma > 0.f ? sigma : 1.f);
  const float phi =
      __fmul_rn(0.5f, erfcf(__fdiv_rn(-z, __fsqrt_rn(2.f))));
  const float point = t.r_hat >= threshold ? 1.f : 0.f;
  return sigma > 0.f ? phi : point;
}

// _prob_from_moments: the exact tail over the six carried channels.
__device__ __forceinline__ float prob_from_moments(
    float sy, float syy, float sxy, float svy, float svyy, float svxy,
    float sx, float sxx, float sv, float svx, float svxx, float n,
    float threshold) {
  const TailCore t = tail_core(sy, syy, sxy, sx, sxx, sv, n);
  return tail_prob(t, sv, svx, svxx, svy, svxy, svyy, threshold);
}

// _prob_from_moments_approx: svy is carried, svxy and svyy are rebuilt
// from the warp regression line y ~ alpha + beta x and the folds.
__device__ __forceinline__ float prob_from_moments_approx(
    float sy, float syy, float sxy, float svy, float sx, float sxx,
    float sv, float svx, float svxx, float n, float threshold) {
  const TailCore t = tail_core(sy, syy, sxy, sx, sxx, sv, n);
  const float beta = __fdiv_rn(t.cov, t.safe_vx);
  const float alpha = __fdiv_rn(__fsub_rn(sy, __fmul_rn(beta, sx)), n);
  const float sv_safe = sv > 0.f ? sv : 1.f;
  const float resid = __fsub_rn(
      svy, __fadd_rn(__fmul_rn(alpha, sv), __fmul_rn(beta, svx)));
  const float svxy_hat = __fadd_rn(
      __fadd_rn(__fmul_rn(alpha, svx), __fmul_rn(beta, svxx)),
      __fmul_rn(__fdiv_rn(svx, sv_safe), resid));
  const float sige2 = __fdiv_rn(
      fmaxf(__fsub_rn(t.vy, __fdiv_rn(__fmul_rn(t.cov, t.cov), t.safe_vx)),
            0.f),
      n);
  float s = __fmul_rn(__fmul_rn(alpha, alpha), sv);
  s = __fadd_rn(s, __fmul_rn(__fmul_rn(__fmul_rn(2.f, alpha), beta), svx));
  s = __fadd_rn(s, __fmul_rn(__fmul_rn(beta, beta), svxx));
  s = __fadd_rn(s, __fmul_rn(
      __fmul_rn(2.f, __fadd_rn(alpha,
                               __fdiv_rn(__fmul_rn(beta, svx), sv_safe))),
      resid));
  s = __fadd_rn(s, __fmul_rn(sv, sige2));
  const float svyy_hat = fmaxf(s, 0.f);
  return tail_prob(t, sv, svx, svxx, svy, svxy_hat, svyy_hat, threshold);
}

}  // namespace dtw
