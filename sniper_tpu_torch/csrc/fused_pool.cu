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
// Design: one block per (roi, 128-channel tile), threads over channels with
// fp32 accumulation. The roi's composed weights cy [P*P, H] and cx [P*P, W]
// live in shared memory (49 * (88 + 128) * 4 B = 42 KB at the 1408x2048
// canvas). Each patch cell's tent touches at most two rows (columns), so
// cy/cx are built by scattering, and each bin remembers the row and column
// window that its weights touch: a bin sums over that window only, and skips
// zero rows and columns, instead of contracting the whole map as the TPU's
// dense matmul did.
//
// Bound: feature reads. Every (bin, row, column) tap is one coalesced
// 128-channel read, served mostly from L2 since a roi's bins overlap and an
// image's rois share its map. The geometry (tents, window starts, counts)
// uses __f*_rn intrinsics so its discrete decisions (in-bounds flags, floor)
// match the plain torch version bit for bit; only the order of the sums
// differs from it.

#include <cuda_runtime.h>
#include <stdint.h>

#include "pool_geometry.cuh"

namespace {

using sniper_pool::AxisTent;
using sniper_pool::axis_tent;
using sniper_pool::bin_factor;

constexpr int kThreads = 128;
constexpr int kMaxSmemPerBlock = 227 * 1024;  // Hopper's opt-in maximum
constexpr int kMaxDevices = 64;

// Scatter one bin's composed weights for one axis into row[0..n) and return
// (sum_e f*v, support window).
__device__ void compose_axis(bool stencil, float p0, int first, int S, int E,
                             float start, float step, int n,
                             float* __restrict__ row, float* count, int* lo,
                             int* hi) {
  float cnt = 0.0f;
  int a = n, z = -1;
  for (int e = 0; e < E; ++e) {
    const float f = bin_factor(stencil, p0, first, S, e);
    if (f == 0.0f) continue;
    const AxisTent t = axis_tent(start, step, e, n);
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
  *count = cnt;
  *lo = a;
  *hi = z;
}

__global__ void __launch_bounds__(kThreads)
pool_pass_kernel(const float* __restrict__ feat, const float* __restrict__ geom,
                 const float* __restrict__ pypx, float* __restrict__ out,
                 int H, int W, int C, int rpi, int P, int S, int M, int E,
                 int stencil) {
  extern __shared__ float smem[];
  const int PP = P * P;
  float* cy = smem;                      // [PP][H]
  float* cx = cy + PP * H;               // [PP][W]
  float* nrm = cx + PP * W;              // [PP]
  int* win = (int*)(nrm + PP);           // [PP][4]: ylo, yhi, xlo, xhi

  const int r = blockIdx.x;
  const int b = r / rpi;
  const float ys = geom[r * 4 + 0];
  const float xs = geom[r * 4 + 1];
  const float sh = geom[r * 4 + 2];
  const float sw = geom[r * 4 + 3];

  for (int i = threadIdx.x; i < PP * (H + W); i += blockDim.x) smem[i] = 0.0f;
  __syncthreads();
  for (int p = threadIdx.x; p < PP; p += blockDim.x) {
    const float py = stencil ? pypx[(size_t)r * 2 * PP + p] : 0.0f;
    const float px = stencil ? pypx[(size_t)r * 2 * PP + PP + p] : 0.0f;
    float ny, nx;
    compose_axis(stencil, py, M + (p / P) * S, S, E, ys, sh, H, cy + p * H,
                 &ny, &win[p * 4 + 0], &win[p * 4 + 1]);
    compose_axis(stencil, px, M + (p % P) * S, S, E, xs, sw, W, cx + p * W,
                 &nx, &win[p * 4 + 2], &win[p * 4 + 3]);
    nrm[p] = __fmul_rn(ny, nx);
  }
  __syncthreads();

  const int c = blockIdx.y * blockDim.x + threadIdx.x;
  if (c >= C) return;
  const float* fb = feat + (size_t)b * H * W * C + c;
  float* ob = out + (size_t)r * PP * C + c;
  for (int p = 0; p < PP; ++p) {
    const float* cyp = cy + p * H;
    const float* cxp = cx + p * W;
    const int ylo = win[p * 4 + 0], yhi = win[p * 4 + 1];
    const int xlo = win[p * 4 + 2], xhi = win[p * 4 + 3];
    float acc = 0.0f;
    for (int h = ylo; h <= yhi; ++h) {
      const float wyv = cyp[h];
      if (wyv == 0.0f) continue;
      const float* frow = fb + (size_t)h * W * C;
      float inner = 0.0f;
      for (int w = xlo; w <= xhi; ++w) {
        const float wxv = cxp[w];
        if (wxv == 0.0f) continue;
        inner += wxv * frow[(size_t)w * C];
      }
      acc += wyv * inner;
    }
    const float n = nrm[p];
    ob[(size_t)p * C] = n > 0.0f ? acc / fmaxf(n, 1.0f) : 0.0f;
  }
}

}  // namespace

extern "C" int sniper_pool_pass(const void* feat, const void* geom,
                                const void* pypx, void* out, int R, int H,
                                int W, int C, int rpi, int P, int S, int M,
                                int stencil, void* stream) {
  const int PP = P * P;
  const int E = P * S + 2 * M;
  const size_t smem = (size_t)PP * (H + W + 1) * sizeof(float) +
                      (size_t)PP * 4 * sizeof(int);
  // Opt in once per device to the most a block may have; the wrapper
  // rejects any map that needs more.
  static bool opted_in[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= kMaxDevices || !opted_in[dev]) {
    err = cudaFuncSetAttribute(pool_pass_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kMaxSmemPerBlock);
    if (err != cudaSuccess) return (int)err;
    if (dev < kMaxDevices) opted_in[dev] = true;
  }
  dim3 grid(R, (C + kThreads - 1) / kThreads);
  pool_pass_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const float*)feat, (const float*)geom, (const float*)pypx, (float*)out,
      H, W, C, rpi, P, S, M, E, stencil);
  return (int)cudaGetLastError();
}
