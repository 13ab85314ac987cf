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

// Patch cells [e0, e1] outside which the tent stack at window start p0
// and its derivative are exactly zero: |p0 + k - e| <= 1 for some k < S
// needs floor(p0) - 1 <= e <= floor(p0) + S. p0 is held to [-4, 1e6]
// first (no cell of [0, E) lies in the stack's reach beyond), which also
// maps a NaN start to an empty stack, as the full loop finds it.
__device__ __forceinline__ void tent_cells(float p0, int S, int* e0,
                                           int* e1) {
  const int f0 = (int)floorf(fminf(fmaxf(p0, -4.0f), 1e6f));
  *e0 = f0 - 1;
  *e1 = f0 + S + 1;
}

// The composition of one bin's weights on one axis: visit, in e order, the
// patch cells of [0, E) whose bin factor f (or, with `deriv`, the tent
// stack's derivative df) is nonzero, with the cell's resize tent on the
// map: fn(f, df, tent). Only the cells in reach are visited (the bin's S
// interior cells in pass A, tent_cells in pass B): every other cell's f and
// df are exactly zero, so sums taken in e order equal the full loop's.
template <typename Fn>
__device__ __forceinline__ void for_bin_cells(bool stencil, bool deriv,
                                              float p0, int first, int S,
                                              int E, float start, float step,
                                              int n, Fn fn) {
  int e0 = first, e1 = first + S - 1;
  if (stencil) tent_cells(p0, S, &e0, &e1);
  for (int e = max(e0, 0); e <= min(e1, E - 1); ++e) {
    const float f = bin_factor(stencil, p0, first, S, e);
    const float df = deriv ? bin_dfactor(p0, S, e) : 0.0f;
    if (f == 0.0f && df == 0.0f) continue;
    fn(f, df, axis_tent(start, step, e, n));
  }
}

}  // namespace sniper_pool
