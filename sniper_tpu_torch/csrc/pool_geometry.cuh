// Per-axis geometry of the two-pass deformable PSROI pool, shared by the
// forward (fused_pool.cu) and the backward (fused_pool_bwd.cu).
//
// Every value is computed with __f*_rn intrinsics (no FMA contraction), so
// the discrete decisions (in-bounds flags, floor, the tent kinks) equal the
// plain torch versions' bit for bit.

#pragma once

#include <cuda_runtime.h>

namespace sniper_pool {

// The 1-D resize tent of patch cell e: its two-cell support on the map.
struct AxisTent {
  int lo;     // first cell of the two-cell support
  float wa;   // weight at lo
  float wb;   // weight at lo + 1 (0 past the map)
  float v;    // in-bounds flag as 0/1
};

// pos = start + e*step; zero weight outside (-0.5, n-0.5), clamped to
// [0, n-1] inside (fused_pool.py:_resize_tents).
__device__ __forceinline__ AxisTent axis_tent(float start, float step, int e,
                                              int n) {
  const float pos = __fadd_rn(start, __fmul_rn((float)e, step));
  const bool inb = pos > -0.5f && pos < (float)n - 0.5f;
  const float posc = fminf(fmaxf(pos, 0.0f), (float)(n - 1));
  AxisTent t;
  t.lo = (int)floorf(posc);
  t.v = inb ? 1.0f : 0.0f;
  t.wa = inb ? fmaxf(0.0f, __fsub_rn(1.0f, fabsf(__fsub_rn(posc, (float)t.lo))))
             : 0.0f;
  t.wb = (inb && t.lo + 1 < n)
             ? fmaxf(0.0f,
                     __fsub_rn(1.0f, fabsf(__fsub_rn(posc, (float)(t.lo + 1)))))
             : 0.0f;
  return t;
}

// Bin factor f[p, e] for one axis. Pass A (!stencil): 1 iff e is one of the
// bin's S interior cells starting at `first`. Pass B: the tent stack
// sum_k<S max(0, 1 - |(p0 + k) - e|) at window start p0.
__device__ __forceinline__ float bin_factor(bool stencil, float p0, int first,
                                            int S, int e) {
  if (!stencil) return (e >= first && e < first + S) ? 1.0f : 0.0f;
  float w = 0.0f;
  for (int k = 0; k < S; ++k) {
    const float d = __fsub_rn(__fadd_rn(p0, (float)k), (float)e);
    w = __fadd_rn(w, fmaxf(0.0f, __fsub_rn(1.0f, fabsf(d))));
  }
  return w;
}

// d f[p, e] / d p0 of the tent stack, with jnp autodiff's conventions at
// the kinks (fused_pool.py:_tent_stack_pair): abs'(0) = +1, and the tent's
// edge |d| == 1 carries half (jnp.maximum splits ties).
__device__ __forceinline__ float bin_dfactor(float p0, int S, int e) {
  float dw = 0.0f;
  for (int k = 0; k < S; ++k) {
    const float d = __fsub_rn(__fadd_rn(p0, (float)k), (float)e);
    const float ad = fabsf(d);
    const float gate = (ad < 1.0f ? 1.0f : 0.0f) + (ad == 1.0f ? 0.5f : 0.0f);
    dw -= (d >= 0.0f ? 1.0f : -1.0f) * gate;  // exact: multiples of 0.5
  }
  return dw;
}

}  // namespace sniper_pool
