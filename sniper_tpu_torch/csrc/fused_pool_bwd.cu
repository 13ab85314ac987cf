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
// Bound: fp32 operations (the tent-weighted sums over each bin's window
// and channels). dfeat is a sum over every roi of the image, so blocks
// cannot own its cells, and the window-start sums reduce over channels per
// (bin, row) and (bin, column).
//
// Design: one block of eight warps per roi, three phases.
// 0. One thread per (bin, axis) composes the bin's weights cy [P*P, H] or
//    cx [P*P, W] into shared memory with the forward's geometry, visiting
//    only the patch cells in reach of the bin's tent stack, with its
//    support and derivative windows, and sets the bin's bit in a mask per
//    map row or column of its support; the block's footprint is the
//    bounding box of the supports.
// 1. (stencil) Warps own bins. A lane keeps its channels' partial sums in
//    registers (16-byte vectors of 4 channels), so each (bin, row) and
//    (bin, column) of dcy and dcx takes one warp reduction and one plain
//    store by the bin's own warp, with no block barrier; the feature reads
//    are coalesced 512-byte lines from L1 and L2.
// 2. dfeat is gathered per footprint cell: a warp owns one cell and its
//    lanes the cell's 4-channel vectors; it walks the bins whose row and
//    column masks both hold the cell, sums cy*cx*g/max(n,1) in registers,
//    and adds each vector's sum to dfeat with one 16-byte atomic
//    (RED.ADD.F32x4): one global atomic per (footprint cell, 4 channels),
//    not per (bin, support cell, channel); the rois of an image meet in L2
//    through them. The wrapper zeroes dfeat before pass B, and pass A adds
//    into it.
// The window geometry uses the forward's __f*_rn helpers, so each discrete
// decision (in-bounds flags, the kinks, the n == 1.0 tie) equals the plain
// torch version's; only the order of the sums differs from it. A channel
// count that is not a multiple of 4 (or an unaligned pointer) takes the
// same kernel with scalar channels.

#include <cuda_runtime.h>
#include <stdint.h>

#include "pool_geometry.cuh"

namespace {

using sniper_pool::AxisTent;
using sniper_pool::axis_tent;
using sniper_pool::bin_dfactor;
using sniper_pool::for_bin_cells;
using sniper_pool::tent_cells;

constexpr int kThreads = 256;
constexpr int kMaxSmemPerBlock = 227 * 1024;  // Hopper's opt-in maximum
constexpr int kMaxDevices = 64;
constexpr int kSlots = 2;  // channel vectors per lane in phase 1

// The shared memory of one roi's block; ops/deform.py mirrors it.
size_t smem_bytes(int H, int W, int P) {
  const size_t PP = (size_t)P * P;
  const size_t words = (PP + 63) / 64;
  return (H + W) * words * 8          // row and column bin masks
         + PP * (2 * (H + W) + 4) * 4  // cy, cx, dcy, dcx, sy, sx, gnum, rden
         + PP * 8 * 4 + 4 * 4;         // windows, footprint
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
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
__device__ __forceinline__ void add_to(float* dst, const float* a) {
  if constexpr (VEC == 4)
    atomicAdd(reinterpret_cast<float4*>(dst),
              make_float4(a[0], a[1], a[2], a[3]));
  else
    atomicAdd(dst, a[0]);
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
  for_bin_cells(stencil, stencil, p0, first, S, E, start, step, n,
                [&](float f, float df, const AxisTent& t) {
                  if (f != 0.0f) {
                    cnt = __fadd_rn(cnt, __fmul_rn(f, t.v));
                    if (t.wa != 0.0f) {
                      row[t.lo] = __fadd_rn(row[t.lo], __fmul_rn(f, t.wa));
                      a = min(a, t.lo);
                      z = max(z, t.lo);
                    }
                    if (t.wb != 0.0f) {
                      row[t.lo + 1] =
                          __fadd_rn(row[t.lo + 1], __fmul_rn(f, t.wb));
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
                });
  *count = cnt;
  win[0] = a;
  win[1] = z;
  win[2] = da;
  win[3] = dz;
}

// Set bin p's bit in the mask of every cell of its support where its
// composed weight is nonzero; widen the footprint box[0..1] to the support.
__device__ void mark_support(const float* __restrict__ row, const int* win,
                             int p, int words,
                             unsigned long long* __restrict__ mask,
                             int* box) {
  if (win[0] > win[1]) return;
  for (int i = win[0]; i <= win[1]; ++i)
    if (row[i] != 0.0f)
      atomicOr(&mask[i * words + (p >> 6)], 1ull << (p & 63));
  atomicMin(&box[0], win[0]);
  atomicMax(&box[1], win[1]);
}

// d(window start) of one bin on one axis: sum over the cells with a nonzero
// tent-stack derivative of dfy[e] * dfy_dp[e], where dfy[e] = sum_h
// dcy[h] w[e,h] + dn_s * v[e] (dn_s = dn times the other axis' count).
__device__ float window_grad(float p0, int S, int E, float start, float step,
                             int n, const float* __restrict__ dc, float dn_s) {
  float acc = 0.0f;
  int e0, e1;
  tent_cells(p0, S, &e0, &e1);
  for (int e = max(e0, 0); e <= min(e1, E - 1); ++e) {
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

// Phase 1 for bin p, run by one warp: dcy[p, rows], dcx[p, columns] and
// gnum[p] = sum_c g numer, over channel tiles of 32 lanes x kSlots x VEC.
template <int VEC>
__device__ void bin_start_sums(const float* __restrict__ fb,
                               const float* __restrict__ gp, float den,
                               const float* __restrict__ cyp,
                               const float* __restrict__ cxp, const int* wp,
                               int W, int C, float* __restrict__ dcyp,
                               float* __restrict__ dcxp, float* gnum) {
  const int lane = threadIdx.x & 31;
  const int ylo = wp[0], yhi = wp[1], dylo = wp[2], dyhi = wp[3];
  const int xlo = wp[4], xhi = wp[5], dxlo = wp[6], dxhi = wp[7];
  const size_t WC = (size_t)W * C;
  for (int c0 = 0; c0 < C; c0 += 32 * kSlots * VEC) {
    float gv[kSlots][VEC], dn[kSlots][VEC], num[kSlots][VEC];
    bool act[kSlots];
#pragma unroll
    for (int k = 0; k < kSlots; ++k) {
      const int c = c0 + VEC * (lane + 32 * k);
      act[k] = c < C;
      if (act[k]) load_vec<VEC>(gp + c, gv[k]);
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        if (!act[k]) gv[k][j] = 0.0f;
        dn[k][j] = __fdiv_rn(gv[k][j], den);
        num[k][j] = 0.0f;
      }
    }
    const float* fl = fb + c0 + VEC * lane;  // this lane's first channel
    // rows: the numerator's, and dcy over the derivative window
    for (int h = min(ylo, dylo); h <= max(yhi, dyhi); ++h) {
      float big[kSlots][VEC] = {};
      for (int w = xlo; w <= xhi; ++w) {
        const float wxv = cxp[w];
        if (wxv == 0.0f) continue;
#pragma unroll
        for (int k = 0; k < kSlots; ++k) {
          if (!act[k]) continue;
          float f[VEC];
          load_vec<VEC>(fl + h * WC + (size_t)w * C + 32 * VEC * k, f);
#pragma unroll
          for (int j = 0; j < VEC; ++j) big[k][j] += wxv * f[j];
        }
      }
      const float cyh = cyp[h];
      float s = 0.0f;
#pragma unroll
      for (int k = 0; k < kSlots; ++k)
#pragma unroll
        for (int j = 0; j < VEC; ++j) {
          num[k][j] += cyh * big[k][j];
          s += dn[k][j] * big[k][j];
        }
      if (h >= dylo && h <= dyhi) {
        s = warp_sum(s);
        if (lane == 0) dcyp[h] += s;
      }
    }
    // columns: dcx over the derivative window
    for (int w = dxlo; w <= dxhi; ++w) {
      float colv[kSlots][VEC] = {};
      for (int h = ylo; h <= yhi; ++h) {
        const float wyv = cyp[h];
        if (wyv == 0.0f) continue;
#pragma unroll
        for (int k = 0; k < kSlots; ++k) {
          if (!act[k]) continue;
          float f[VEC];
          load_vec<VEC>(fl + h * WC + (size_t)w * C + 32 * VEC * k, f);
#pragma unroll
          for (int j = 0; j < VEC; ++j) colv[k][j] += wyv * f[j];
        }
      }
      float s = 0.0f;
#pragma unroll
      for (int k = 0; k < kSlots; ++k)
#pragma unroll
        for (int j = 0; j < VEC; ++j) s += dn[k][j] * colv[k][j];
      s = warp_sum(s);
      if (lane == 0) dcxp[w] += s;
    }
    float s = 0.0f;
#pragma unroll
    for (int k = 0; k < kSlots; ++k)
#pragma unroll
      for (int j = 0; j < VEC; ++j) s += gv[k][j] * num[k][j];
    s = warp_sum(s);
    if (lane == 0) *gnum += s;
  }
}

template <int VEC>
__global__ void __launch_bounds__(kThreads) pool_pass_bwd_kernel(
    const float* __restrict__ feat, const float* __restrict__ geom,
    const float* __restrict__ pypx, const float* __restrict__ g,
    float* __restrict__ dfeat, float* __restrict__ dpp, int H, int W, int C,
    int rpi, int P, int S, int M, int E, int stencil) {
  extern __shared__ unsigned long long smem[];
  const int PP = P * P;
  const int words = (PP + 63) / 64;
  unsigned long long* rowmask = smem;           // [H][words]
  unsigned long long* colmask = smem + H * words;  // [W][words]
  float* cy = (float*)(colmask + W * words);    // [PP][H]
  float* cx = cy + PP * H;                      // [PP][W]
  float* dcy = cx + PP * W;                     // [PP][H]
  float* dcx = dcy + PP * H;                    // [PP][W]
  float* sy = dcx + PP * W;                     // [PP] counts
  float* sx = sy + PP;                          // [PP]
  float* gnum = sx + PP;                        // [PP] sum_c g * numer
  float* rden = gnum + PP;                      // [PP] 1/max(n,1), 0 at n<=0
  int* win = (int*)(rden + PP);   // [PP][8]: y lo, hi, dlo, dhi; x likewise
  int* box = win + PP * 8;        // footprint rows [0..1], columns [2..3]

  const int r = blockIdx.x;
  const int b = r / rpi;
  const float ys = geom[r * 4 + 0];
  const float xs = geom[r * 4 + 1];
  const float sh = geom[r * 4 + 2];
  const float sw = geom[r * 4 + 3];

  // zero the masks and the float arrays (sy, sx and rden are set below)
  const int nzero = (int)(((char*)win - (char*)smem) / 4);
  for (int i = threadIdx.x; i < nzero; i += blockDim.x)
    ((float*)smem)[i] = 0.0f;
  if (threadIdx.x == 0) {
    box[0] = H;
    box[1] = -1;
    box[2] = W;
    box[3] = -1;
  }
  __syncthreads();

  // phase 0: one thread per (bin, axis)
  for (int i = threadIdx.x; i < 2 * PP; i += blockDim.x) {
    const int p = i >> 1;
    const float p0 = stencil ? pypx[(size_t)r * 2 * PP + (i & 1) * PP + p]
                             : 0.0f;
    if (i & 1)
      compose_axis_bwd(stencil, p0, M + (p % P) * S, S, E, xs, sw, W,
                       cx + p * W, &sx[p], win + p * 8 + 4);
    else
      compose_axis_bwd(stencil, p0, M + (p / P) * S, S, E, ys, sh, H,
                       cy + p * H, &sy[p], win + p * 8);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < 2 * PP; i += blockDim.x) {
    const int p = i >> 1;
    const float n = __fmul_rn(sy[p], sx[p]);
    if (!(n > 0.0f)) continue;  // dnum is zero: rden stays 0
    if (i & 1) {
      mark_support(cx + p * W, win + p * 8 + 4, p, words, colmask, box + 2);
    } else {
      rden[p] = __fdiv_rn(1.0f, fmaxf(n, 1.0f));
      mark_support(cy + p * H, win + p * 8, p, words, rowmask, box);
    }
  }
  __syncthreads();

  const float* fb = feat + (size_t)b * H * W * C;
  const float* gr = g + (size_t)r * PP * C;

  // phase 1 (stencil): the window-start sums, one warp per bin
  if (stencil) {
    for (int p = threadIdx.x >> 5; p < PP; p += blockDim.x >> 5) {
      const float n = __fmul_rn(sy[p], sx[p]);
      if (!(n > 0.0f)) continue;  // dnum and dn are zero
      bin_start_sums<VEC>(fb, gr + (size_t)p * C, fmaxf(n, 1.0f), cy + p * H,
                          cx + p * W, win + p * 8, W, C, dcy + p * H,
                          dcx + p * W, &gnum[p]);
    }
  }

  // phase 2: dfeat over the footprint, one warp per cell, the lanes over
  // its 4-channel vectors
  if (box[1] >= box[0] && box[3] >= box[2]) {
    const int lane = threadIdx.x & 31;
    const int nv = C / VEC;
    const int fw = box[3] - box[2] + 1;
    const int cells = (box[1] - box[0] + 1) * fw;
    float* db = dfeat + (size_t)b * H * W * C;
    for (int cell = threadIdx.x >> 5; cell < cells; cell += blockDim.x >> 5) {
      const int h = box[0] + cell / fw;
      const int w = box[2] + cell % fw;
      float* dcell = db + ((size_t)h * W + w) * C;
      for (int v0 = 0; v0 < nv; v0 += 32 * kSlots) {
        float acc[kSlots][VEC] = {};
        bool any = false;  // the same for the whole warp
        for (int k = 0; k < words; ++k) {
          unsigned long long m =
              rowmask[h * words + k] & colmask[w * words + k];
          while (m) {
            const int p = k * 64 + __ffsll((long long)m) - 1;
            m &= m - 1;
            const float wgt = cy[p * H + h] * cx[p * W + w] * rden[p];
            const float* gp = gr + (size_t)p * C;
#pragma unroll
            for (int s = 0; s < kSlots; ++s) {
              const int v = v0 + lane + 32 * s;
              if (v >= nv) continue;
              float gv[VEC];
              load_vec<VEC>(gp + v * VEC, gv);
#pragma unroll
              for (int j = 0; j < VEC; ++j) acc[s][j] += wgt * gv[j];
            }
            any = true;
          }
        }
        if (!any) break;  // no bin reaches this cell
#pragma unroll
        for (int s = 0; s < kSlots; ++s) {
          const int v = v0 + lane + 32 * s;
          if (v < nv) add_to<VEC>(dcell + v * VEC, acc[s]);
        }
      }
    }
  }
  if (!stencil) return;
  __syncthreads();

  for (int i = threadIdx.x; i < 2 * PP; i += blockDim.x) {
    const int p = i >> 1;
    const float n = __fmul_rn(sy[p], sx[p]);
    const float den = fmaxf(n, 1.0f);
    const float tie = n == 1.0f ? 0.5f : 1.0f;
    const float dn = (n > 0.0f && n >= 1.0f)
                         ? __fdiv_rn(__fmul_rn(-tie, gnum[p]),
                                     __fmul_rn(den, den))
                         : 0.0f;
    const size_t at = (size_t)r * 2 * PP + (i & 1) * PP + p;
    dpp[at] = (i & 1) ? window_grad(pypx[at], S, E, xs, sw, W, dcx + p * W,
                                    __fmul_rn(dn, sy[p]))
                      : window_grad(pypx[at], S, E, ys, sh, H, dcy + p * H,
                                    __fmul_rn(dn, sx[p]));
  }
}

template <int VEC>
int launch(const void* feat, const void* geom, const void* pypx,
           const void* g, void* dfeat, void* dpp, int R, int H, int W, int C,
           int rpi, int P, int S, int M, cudaStream_t st) {
  // Opt in once per device to the most a block may have; the wrapper
  // rejects any map that needs more.
  static bool opted_in[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= kMaxDevices || !opted_in[dev]) {
    err = cudaFuncSetAttribute(pool_pass_bwd_kernel<VEC>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kMaxSmemPerBlock);
    if (err != cudaSuccess) return (int)err;
    if (dev < kMaxDevices) opted_in[dev] = true;
  }
  pool_pass_bwd_kernel<VEC><<<R, kThreads, smem_bytes(H, W, P), st>>>(
      (const float*)feat, (const float*)geom, (const float*)pypx,
      (const float*)g, (float*)dfeat, (float*)dpp, H, W, C, rpi, P, S, M,
      P * S + 2 * M, pypx != nullptr);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int sniper_pool_pass_bwd(const void* feat, const void* geom,
                                    const void* pypx, const void* g,
                                    void* dfeat, void* dpp, int R, int H,
                                    int W, int C, int rpi, int P, int S,
                                    int M, void* stream) {
  if (smem_bytes(H, W, P) > (size_t)kMaxSmemPerBlock)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const bool aligned =
      ((uintptr_t)feat | (uintptr_t)g | (uintptr_t)dfeat) % 16 == 0;
  if (C % 4 == 0 && aligned)
    return launch<4>(feat, geom, pypx, g, dfeat, dpp, R, H, W, C, rpi, P, S,
                     M, st);
  return launch<1>(feat, geom, pypx, g, dfeat, dpp, R, H, W, C, rpi, P, S, M,
                   st);
}
