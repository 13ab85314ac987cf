// One pass of the two-pass deformable PSROI pool for Hopper, forward.
//
// Replaces: sniper_tpu/ops/pallas/fused_pool.py:_pool_call (kernel body
// _pool_kernel), both its mode="avg" pass A (undeformed interior bin
// average) and its mode="stencil" pass B (offset-shifted tent-stack pool).
// The offset FC between the passes stays a torch.matmul, as the JAX package
// leaves it to XLA.
//
// What one pass computes, per roi r of image b and bin p (P*P bins):
//   pos_y[e] = ys + e*sh (e < E patch cells), in-bounds iff in (-0.5, H-0.5),
//   wy[e,h]  = in-bounds ? max(0, 1 - |clip(pos_y[e], 0, H-1) - h|) : 0,
//   fy[p,e]  = pass A: 1 iff e is one of bin p's S interior samples;
//              pass B: sum_k<S max(0, 1 - |(py[p] + k) - e|),
//   cy[p,h]  = sum_e fy[p,e] wy[e,h]   (and cx likewise on the x axis),
//   n[p]     = (sum_e fy[p,e] vy[e]) (sum_e fx[p,e] vx[e]),
//   out[r,p,c] = n > 0 ? sum_h cy[p,h] sum_w cx[p,w] feat[b,h,w,c] / max(n,1)
//                      : 0.
// This is the composed-tent form of the JAX kernel, with its drop-from-count
// rule outside (-0.5, n-0.5) and clamping inside.
//
// Bound: bytes (the map read once, [R, P*P, C] written), but what limits a
// simple kernel is the latency of the tap loop: every (bin, row, column)
// tap is a read of the bin's channels, served mostly from L1 and L2 since a
// roi's bins overlap and an image's rois share its map.
//
// Design: one block of eight warps per roi, for all channels, in two
// phases.
// 0. One thread per (bin, axis) composes the bin's weights on that axis,
//    visiting only the patch cells in reach of its tent stack
//    (pool_geometry.cuh:for_bin_cells), into a compact list of (map row or
//    column, weight) pairs in shared memory: at most 2S pairs in pass A and
//    2(S+1) in pass B, so shared memory does not depend on the map (about
//    8.4 KB at P = 7 and 34 KB at P = 14, S = 4). Each pair's weight and
//    the count are summed in e order with __fadd_rn, as the dense row was,
//    so the in-bounds flags and counts n equal the plain version's.
// 1. Warps own bins; a lane owns 16-byte channel vectors (two slots of 4
//    channels: 256 channels a pass of the warp). The tap loop runs over the
//    two lists with no zero tests, kUnroll columns at a time, so each lane
//    keeps kUnroll x 2 independent 16-byte loads in flight; the bin's
//    output is one 16-byte store per lane and slot, 512 contiguous bytes a
//    warp. A bin with n <= 0 reads nothing and writes zeros.
// Only the order of the fp32 tap sums differs from the plain version. A
// channel count that is not a multiple of 4 (or an unaligned pointer) takes
// the same kernel with scalar channels.

#include <cuda_runtime.h>
#include <stdint.h>

#include "pool_geometry.cuh"

namespace {

using sniper_pool::AxisTent;
using sniper_pool::for_bin_cells;

constexpr int kThreads = 256;
constexpr int kSlots = 2;    // channel vectors per lane
constexpr int kUnroll = 2;   // map columns a lane loads at once
constexpr int kMaxSmemPerBlock = 227 * 1024;  // Hopper's opt-in maximum
constexpr int kMaxDevices = 64;

// Pairs of one (bin, axis) list: each patch cell in reach touches at most
// two map cells, and at most S + 1 patch cells have a nonzero factor.
__host__ __device__ __forceinline__ int list_cap(int S) { return 2 * (S + 1); }

// The shared memory of one roi's block; ops/deform.py mirrors it: per
// (bin, axis) list, its cells and weights, its length and its count.
size_t smem_bytes(int P, int S) {
  return (size_t)2 * P * P * (list_cap(S) * 8 + 8);
}

template <int VEC>
__device__ __forceinline__ void load_vec(const float* p, float* f) {
  if constexpr (VEC == 4) {
    const float4 v = __ldg(reinterpret_cast<const float4*>(p));
    f[0] = v.x;
    f[1] = v.y;
    f[2] = v.z;
    f[3] = v.w;
  } else {
    f[0] = __ldg(p);
  }
}

template <int VEC>
__device__ __forceinline__ void store_vec(float* p, const float* f) {
  if constexpr (VEC == 4)
    *reinterpret_cast<float4*>(p) = make_float4(f[0], f[1], f[2], f[3]);
  else
    p[0] = f[0];
}

// One bin, one axis: the composed weights as (map cell, weight) pairs in
// the order the cells are first touched, each weight summed over the patch
// cells in e order; returns the count sum_e f*v.
__device__ float compose_list(bool stencil, float p0, int first, int S,
                              int E, float start, float step, int n,
                              int* __restrict__ cells,
                              float* __restrict__ wts, int* len) {
  float cnt = 0.0f;
  int m = 0;
  const int cap = list_cap(S);
  auto add = [&](int cell, float w) {
    for (int i = 0; i < m; ++i)
      if (cells[i] == cell) {
        wts[i] = __fadd_rn(wts[i], w);
        return;
      }
    if (m < cap) {
      cells[m] = cell;
      wts[m] = w;
      ++m;
    }
  };
  for_bin_cells(stencil, false, p0, first, S, E, start, step, n,
                [&](float f, float, const AxisTent& t) {
                  cnt = __fadd_rn(cnt, __fmul_rn(f, t.v));
                  if (t.wa != 0.0f) add(t.lo, __fmul_rn(f, t.wa));
                  if (t.wb != 0.0f) add(t.lo + 1, __fmul_rn(f, t.wb));
                });
  *len = m;
  return cnt;
}

template <int VEC>
__global__ void __launch_bounds__(kThreads) pool_pass_kernel(
    const float* __restrict__ feat, const float* __restrict__ geom,
    const float* __restrict__ pypx, float* __restrict__ out, int H, int W,
    int C, int rpi, int P, int S, int M, int E, int stencil) {
  extern __shared__ int smem[];
  const int PP = P * P;
  const int cap = list_cap(S);
  int* cells = smem;                                   // [2*PP][cap]
  float* wts = reinterpret_cast<float*>(cells + 2 * PP * cap);  // same
  int* meta = reinterpret_cast<int*>(wts + 2 * PP * cap);  // [2*PP]: n, cnt

  const int r = blockIdx.x;
  const int b = r / rpi;
  const float ys = geom[r * 4 + 0];
  const float xs = geom[r * 4 + 1];
  const float sh = geom[r * 4 + 2];
  const float sw = geom[r * 4 + 3];

  // phase 0: one thread per (bin, axis); list i = 2p is bin p's rows,
  // 2p + 1 its columns
  for (int i = threadIdx.x; i < 2 * PP; i += blockDim.x) {
    const int p = i >> 1;
    const float p0 =
        stencil ? pypx[(size_t)r * 2 * PP + (i & 1) * PP + p] : 0.0f;
    const float cnt =
        (i & 1) ? compose_list(stencil, p0, M + (p % P) * S, S, E, xs, sw, W,
                               cells + i * cap, wts + i * cap, &meta[2 * i])
                : compose_list(stencil, p0, M + (p / P) * S, S, E, ys, sh, H,
                               cells + i * cap, wts + i * cap, &meta[2 * i]);
    meta[2 * i + 1] = __float_as_int(cnt);
  }
  __syncthreads();

  // phase 1: warps own bins, lanes 16-byte channel vectors
  const int lane = threadIdx.x & 31;
  const size_t WC = (size_t)W * C;
  const float* fb = feat + (size_t)b * H * WC;
  for (int p = threadIdx.x >> 5; p < PP; p += blockDim.x >> 5) {
    const int li = 2 * p;  // the bin's row list; li + 1 its column list
    const int ny = meta[2 * li], nx = meta[2 * li + 2];
    const float n = __fmul_rn(__int_as_float(meta[2 * li + 1]),
                              __int_as_float(meta[2 * li + 3]));
    const int* yc = cells + li * cap;
    const int* xc = yc + cap;
    const float* yw = wts + li * cap;
    const float* xw = yw + cap;
    const bool pos = n > 0.0f;
    const float den = fmaxf(n, 1.0f);
    float* ob = out + ((size_t)r * PP + p) * C;
    for (int c0 = 0; c0 < C; c0 += 32 * kSlots * VEC) {
      float acc[kSlots][VEC] = {};
      bool act[kSlots];
#pragma unroll
      for (int k = 0; k < kSlots; ++k) act[k] = c0 + VEC * (lane + 32 * k) < C;
      const float* fl = fb + c0 + VEC * lane;  // this lane's first channel
      for (int i = 0; pos && i < ny; ++i) {
        const float* row = fl + (size_t)yc[i] * WC;
        float racc[kSlots][VEC] = {};
        for (int j = 0; j < nx; j += kUnroll) {
          float f[kUnroll][kSlots][VEC];
#pragma unroll
          for (int u = 0; u < kUnroll; ++u) {
            const float* src = row + (size_t)xc[min(j + u, nx - 1)] * C;
#pragma unroll
            for (int k = 0; k < kSlots; ++k) {
              if (j + u < nx && act[k]) {
                load_vec<VEC>(src + 32 * VEC * k, f[u][k]);
              } else {
#pragma unroll
                for (int q = 0; q < VEC; ++q) f[u][k][q] = 0.0f;
              }
            }
          }
#pragma unroll
          for (int u = 0; u < kUnroll; ++u) {
            const float wxv = j + u < nx ? xw[j + u] : 0.0f;
#pragma unroll
            for (int k = 0; k < kSlots; ++k)
#pragma unroll
              for (int q = 0; q < VEC; ++q) racc[k][q] += wxv * f[u][k][q];
          }
        }
        const float wyv = yw[i];
#pragma unroll
        for (int k = 0; k < kSlots; ++k)
#pragma unroll
          for (int q = 0; q < VEC; ++q) acc[k][q] += wyv * racc[k][q];
      }
#pragma unroll
      for (int k = 0; k < kSlots; ++k) {
        if (!act[k]) continue;
        const int c = c0 + VEC * (lane + 32 * k);
        float o[VEC];
#pragma unroll
        for (int q = 0; q < VEC; ++q) o[q] = pos ? acc[k][q] / den : 0.0f;
        store_vec<VEC>(ob + c, o);
      }
    }
  }
}

template <int VEC>
int launch(const void* feat, const void* geom, const void* pypx, void* out,
           int R, int H, int W, int C, int rpi, int P, int S, int M,
           cudaStream_t st) {
  // Opt in once per device to the most a block may have; the entry point
  // rejects any P and S that need more.
  static bool opted_in[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= kMaxDevices || !opted_in[dev]) {
    err = cudaFuncSetAttribute(pool_pass_kernel<VEC>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kMaxSmemPerBlock);
    if (err != cudaSuccess) return (int)err;
    if (dev < kMaxDevices) opted_in[dev] = true;
  }
  pool_pass_kernel<VEC><<<R, kThreads, smem_bytes(P, S), st>>>(
      (const float*)feat, (const float*)geom, (const float*)pypx,
      (float*)out, H, W, C, rpi, P, S, M, P * S + 2 * M, pypx != nullptr);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int sniper_pool_pass(const void* feat, const void* geom,
                                const void* pypx, void* out, int R, int H,
                                int W, int C, int rpi, int P, int S, int M,
                                int stencil, void* stream) {
  if (smem_bytes(P, S) > (size_t)kMaxSmemPerBlock || (stencil && !pypx))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const void* bins = stencil ? pypx : nullptr;
  const bool aligned = ((uintptr_t)feat | (uintptr_t)out) % 16 == 0;
  if (C % 4 == 0 && aligned)
    return launch<4>(feat, geom, bins, out, R, H, W, C, rpi, P, S, M, st);
  return launch<1>(feat, geom, bins, out, R, H, W, C, rpi, P, S, M, st);
}
