// One transposed pass of the two-pass deformable PSROI pool for Hopper.
//
// Replaces: sniper_tpu/ops/pallas/fused_pool.py:_bwd_call (kernel body
// _pool_bwd_kernel), both its mode="stencil" (transposed pass B: the
// feature gradient and the gradient of the per-bin window starts) and its
// mode="avg" (transposed pass A: the feature gradient only). The clip masks
// and the offset-FC transpose between the two passes stay torch ops, as the
// JAX package leaves them to XLA.
//
// What one pass computes, per roi r of image b and bin p, with cy, cx, n
// and the forward's numerator numer[p,c] as in fused_pool.cu:
//   dnum[p,c]      = n > 0 ? g[r,p,c] / max(n, 1) : 0,
//   dfeat[b,h,w,c] += sum_p cy[p,h] cx[p,w] dnum[p,c]          (both modes),
// and in stencil mode also
//   dcy[p,h] = sum_c dnum[p,c] sum_w cx[p,w] feat[h,w,c],
//   dcx[p,w] = sum_c dnum[p,c] sum_h cy[p,h] feat[h,w,c],
//   dn[p]    = n >= 1 ? -tie * sum_c g[r,p,c] numer[p,c] / max(n,1)^2 : 0,
//              tie = 0.5 at n == 1.0 (jnp.maximum splits ties), else 1,
//   dfy[p,e] = sum_h dcy[p,h] wy[e,h] + dn[p] sx[p] vy[e]  (dfx likewise),
//   dpy[r,p] = sum_e dfy[p,e] d(fy[p,e])/d(py[p]),
// with the tent-stack derivative's kink conventions of
// _tent_stack_pair (pool_geometry.cuh:bin_dfactor). A cell on a tent's
// edge (|d| == 1) has fy = 0 but a derivative of one half, so dcy and dcx
// are summed over the rows and columns of every cell whose derivative is
// nonzero, not only over the forward's support.
//
// Design: one block per roi, threads over the channels (a loop over
// channel tiles when C exceeds the block). A roi's own sums over C (dcy,
// dcx, sum_c g numer) stay inside its block: each warp reduces with
// shuffles and adds its partial sum to shared memory, so d(py, px) needs no
// second pass and no global atomics. The composed weights cy [P*P, H] and
// cx [P*P, W], their gradients and each bin's row and column windows live
// in shared memory (about 26 KB at the training map of 32x32).
//
// dfeat is a sum over every roi of the image. On the TPU the grid visits an
// image's rois in order and accumulates in VMEM; here the blocks run in no
// order, so each (bin, row, column) tap adds into the fp32 [B,H,W,C] buffer
// with a coalesced atomicAdd (RED.ADD.F32). The wrapper zeroes the buffer
// before pass B, and pass A adds into the same buffer.
//
// Bound: the L2 atomics of dfeat (one per tap and channel) and the feature
// reads of the numerator, dcy and dcx (two reads per tap and channel), all
// served mostly from L2. The window geometry uses the forward's __f*_rn
// helpers, so each discrete decision (in-bounds flags, the kinks, the
// n == 1.0 tie) equals the plain torch version's; only the order of the
// sums differs from it.

#include <cuda_runtime.h>
#include <stdint.h>

#include "pool_geometry.cuh"

namespace {

using sniper_pool::AxisTent;
using sniper_pool::axis_tent;
using sniper_pool::bin_dfactor;
using sniper_pool::bin_factor;

constexpr int kMaxThreads = 256;
constexpr int kMaxSmemPerBlock = 227 * 1024;  // Hopper's opt-in maximum
constexpr int kMaxDevices = 64;

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Every thread of the block calls this with its channel's term; lane 0 of
// each warp adds the warp's sum to *dst in shared memory.
__device__ __forceinline__ void block_add(float* dst, float v) {
  v = warp_sum(v);
  if ((threadIdx.x & 31) == 0) atomicAdd(dst, v);
}

// One bin, one axis: scatter the composed weights into row[0..n) as the
// forward does, and return the count sum_e f*v, the forward's support
// window [lo, hi] and the derivative window [dlo, dhi]: the map cells
// touched by the patch cells whose tent-stack derivative is nonzero.
__device__ void compose_axis_bwd(bool stencil, float p0, int first, int S,
                                 int E, float start, float step, int n,
                                 float* __restrict__ row, float* count,
                                 int* win) {
  float cnt = 0.0f;
  int a = n, z = -1, da = n, dz = -1;
  for (int e = 0; e < E; ++e) {
    const float f = bin_factor(stencil, p0, first, S, e);
    const float df = stencil ? bin_dfactor(p0, S, e) : 0.0f;
    if (f == 0.0f && df == 0.0f) continue;
    const AxisTent t = axis_tent(start, step, e, n);
    if (f != 0.0f) {
      cnt = __fadd_rn(cnt, __fmul_rn(f, t.v));
      if (t.wa != 0.0f) {
        row[t.lo] = __fadd_rn(row[t.lo], __fmul_rn(f, t.wa));
        a = min(a, t.lo);
        z = max(z, t.lo);
      }
      if (t.wb != 0.0f) {
        row[t.lo + 1] = __fadd_rn(row[t.lo + 1], __fmul_rn(f, t.wb));
        a = min(a, t.lo + 1);
        z = max(z, t.lo + 1);
      }
    }
    if (df != 0.0f) {
      if (t.wa != 0.0f) {
        da = min(da, t.lo);
        dz = max(dz, t.lo);
      }
      if (t.wb != 0.0f) {
        da = min(da, t.lo + 1);
        dz = max(dz, t.lo + 1);
      }
    }
  }
  *count = cnt;
  win[0] = a;
  win[1] = z;
  win[2] = da;
  win[3] = dz;
}

// d(window start) of one bin on one axis: sum over the cells with a nonzero
// tent-stack derivative of dfy[e] * dfy_dp[e], where dfy[e] = sum_h
// dcy[h] w[e,h] + dn_s * v[e] (dn_s = dn times the other axis' count).
__device__ float window_grad(float p0, int S, int E, float start, float step,
                             int n, const float* __restrict__ dc, float dn_s) {
  float acc = 0.0f;
  for (int e = 0; e < E; ++e) {
    const float df = bin_dfactor(p0, S, e);
    if (df == 0.0f) continue;
    const AxisTent t = axis_tent(start, step, e, n);
    float dfe = __fmul_rn(dc[t.lo], t.wa);
    if (t.lo + 1 < n) dfe = __fadd_rn(dfe, __fmul_rn(dc[t.lo + 1], t.wb));
    dfe = __fadd_rn(dfe, __fmul_rn(dn_s, t.v));
    acc = __fadd_rn(acc, __fmul_rn(dfe, df));
  }
  return acc;
}

__global__ void pool_pass_bwd_kernel(
    const float* __restrict__ feat, const float* __restrict__ geom,
    const float* __restrict__ pypx, const float* __restrict__ g,
    float* __restrict__ dfeat, float* __restrict__ dpp, int H, int W, int C,
    int rpi, int P, int S, int M, int E, int stencil) {
  extern __shared__ float smem[];
  const int PP = P * P;
  float* cy = smem;              // [PP][H]
  float* cx = cy + PP * H;       // [PP][W]
  float* dcy = cx + PP * W;      // [PP][H]
  float* dcx = dcy + PP * H;     // [PP][W]
  float* sy = dcx + PP * W;      // [PP] counts
  float* sx = sy + PP;           // [PP]
  float* gnum = sx + PP;         // [PP] sum_c g * numer
  int* win = (int*)(gnum + PP);  // [PP][8]: y lo, hi, dlo, dhi; x likewise

  const int r = blockIdx.x;
  const int b = r / rpi;
  const float ys = geom[r * 4 + 0];
  const float xs = geom[r * 4 + 1];
  const float sh = geom[r * 4 + 2];
  const float sw = geom[r * 4 + 3];

  for (int i = threadIdx.x; i < PP * 2 * (H + W) + PP; i += blockDim.x) {
    // cy, cx, dcy, dcx, then (after sy and sx) gnum
    const int j = i < PP * 2 * (H + W) ? i : i + 2 * PP;
    smem[j] = 0.0f;
  }
  __syncthreads();
  for (int p = threadIdx.x; p < PP; p += blockDim.x) {
    const float py = stencil ? pypx[(size_t)r * 2 * PP + p] : 0.0f;
    const float px = stencil ? pypx[(size_t)r * 2 * PP + PP + p] : 0.0f;
    compose_axis_bwd(stencil, py, M + (p / P) * S, S, E, ys, sh, H,
                     cy + p * H, &sy[p], win + p * 8);
    compose_axis_bwd(stencil, px, M + (p % P) * S, S, E, xs, sw, W,
                     cx + p * W, &sx[p], win + p * 8 + 4);
  }
  __syncthreads();

  const float* fb = feat + (size_t)b * H * W * C;
  float* db = dfeat + (size_t)b * H * W * C;
  const float* gr = g + (size_t)r * PP * C;
  // every loop bound below is the same for the whole block, so all its
  // threads reach each block_add together
  for (int c0 = 0; c0 < C; c0 += blockDim.x) {
    const int c = c0 + threadIdx.x;
    const bool act = c < C;
    for (int p = 0; p < PP; ++p) {
      const float n = __fmul_rn(sy[p], sx[p]);
      if (!(n > 0.0f)) continue;  // dnum and dn are zero
      const float den = fmaxf(n, 1.0f);
      const float gv = act ? gr[(size_t)p * C + c] : 0.0f;
      const float dn_c = __fdiv_rn(gv, den);
      const float* cyp = cy + p * H;
      const float* cxp = cx + p * W;
      const int* wp = win + p * 8;
      const int ylo = wp[0], yhi = wp[1], xlo = wp[4], xhi = wp[5];

      if (act) {  // dfeat over the forward's support
        for (int h = ylo; h <= yhi; ++h) {
          const float wyv = cyp[h];
          if (wyv == 0.0f) continue;
          const float t = __fmul_rn(wyv, dn_c);
          float* drow = db + (size_t)h * W * C + c;
          for (int w = xlo; w <= xhi; ++w) {
            const float wxv = cxp[w];
            if (wxv == 0.0f) continue;
            atomicAdd(drow + (size_t)w * C, __fmul_rn(wxv, t));
          }
        }
      }
      if (!stencil) continue;

      // rows: the numerator's, and dcy over the derivative window
      const int dylo = wp[2], dyhi = wp[3];
      float numer = 0.0f;
      for (int h = min(ylo, dylo); h <= max(yhi, dyhi); ++h) {
        float big = 0.0f;
        if (act) {
          const float* frow = fb + (size_t)h * W * C + c;
          for (int w = xlo; w <= xhi; ++w) {
            const float wxv = cxp[w];
            if (wxv == 0.0f) continue;
            big = __fadd_rn(big, __fmul_rn(wxv, frow[(size_t)w * C]));
          }
        }
        numer = __fadd_rn(numer, __fmul_rn(cyp[h], big));
        if (h >= dylo && h <= dyhi) block_add(&dcy[p * H + h],
                                              __fmul_rn(dn_c, big));
      }
      // columns: dcx over the derivative window
      const int dxlo = wp[6], dxhi = wp[7];
      for (int w = dxlo; w <= dxhi; ++w) {
        float col = 0.0f;
        if (act) {
          const float* fcol = fb + (size_t)w * C + c;
          for (int h = ylo; h <= yhi; ++h) {
            const float wyv = cyp[h];
            if (wyv == 0.0f) continue;
            col = __fadd_rn(col, __fmul_rn(wyv, fcol[(size_t)h * W * C]));
          }
        }
        block_add(&dcx[p * W + w], __fmul_rn(dn_c, col));
      }
      block_add(&gnum[p], __fmul_rn(gv, numer));
    }
  }
  if (!stencil) return;
  __syncthreads();

  for (int p = threadIdx.x; p < PP; p += blockDim.x) {
    const float n = __fmul_rn(sy[p], sx[p]);
    const float den = fmaxf(n, 1.0f);
    const float tie = n == 1.0f ? 0.5f : 1.0f;
    const float dn = (n > 0.0f && n >= 1.0f)
                         ? __fdiv_rn(__fmul_rn(-tie, gnum[p]),
                                     __fmul_rn(den, den))
                         : 0.0f;
    const float py = pypx[(size_t)r * 2 * PP + p];
    const float px = pypx[(size_t)r * 2 * PP + PP + p];
    dpp[(size_t)r * 2 * PP + p] =
        window_grad(py, S, E, ys, sh, H, dcy + p * H, __fmul_rn(dn, sx[p]));
    dpp[(size_t)r * 2 * PP + PP + p] =
        window_grad(px, S, E, xs, sw, W, dcx + p * W, __fmul_rn(dn, sy[p]));
  }
}

}  // namespace

extern "C" int sniper_pool_pass_bwd(const void* feat, const void* geom,
                                    const void* pypx, const void* g,
                                    void* dfeat, void* dpp, int R, int H,
                                    int W, int C, int rpi, int P, int S,
                                    int M, void* stream) {
  const int PP = P * P;
  const int E = P * S + 2 * M;
  const size_t smem = (size_t)PP * (2 * (H + W) + 3) * sizeof(float) +
                      (size_t)PP * 8 * sizeof(int);
  // Opt in once per device to the most a block may have; the wrapper
  // rejects any map that needs more.
  static bool opted_in[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= kMaxDevices || !opted_in[dev]) {
    err = cudaFuncSetAttribute(pool_pass_bwd_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kMaxSmemPerBlock);
    if (err != cudaSuccess) return (int)err;
    if (dev < kMaxDevices) opted_in[dev] = true;
  }
  const int threads = min(kMaxThreads, (C + 31) / 32 * 32);
  pool_pass_bwd_kernel<<<R, threads, smem, (cudaStream_t)stream>>>(
      (const float*)feat, (const float*)geom, (const float*)pypx,
      (const float*)g, (float*)dfeat, (float*)dpp, H, W, C, rpi, P, S, M, E,
      pypx != nullptr);
  return (int)cudaGetLastError();
}
