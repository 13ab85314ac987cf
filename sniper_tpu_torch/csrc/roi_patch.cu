// Per-roi bilinear patch extraction for Hopper, forward only.
//
// Replaces: sniper_tpu/ops/pallas/roi_patch.py:extract_patches (kernel body
// _patch_kernel), the extraction step of the einsum two-pass pool
// (sniper_tpu/ops/deform.py:_extract_patch_batched computes the same
// function with two dense tent einsums). The port's mask branch runs it
// before the pass-1 bin average, the offset FC and the stencil product,
// which stay torch ops (ops/deform.py:patch_offset_pool).
//
// What it computes, for roi r of image b = r / rpi, patch cell (t, s) and
// channel c (geom[r] = (ys, xs, sub_h, sub_w), E cells per axis):
//   pos = start + i*step per axis, in fp32 (roi_patch.py:_taps):
//   in-bounds iff -0.5 < pos < n-0.5, else both weights are zero (the
//   drop-from-count rule); posc = clip(pos, 0, n-1); i0 = min(floor(posc),
//   n-2) so the pair (i0, i0+1) stays on the map; w0 = 1 - (posc - i0),
//   w1 = posc - i0;
//   tmp(x) = w0y*feat[b,y0,x,c] + w1y*feat[b,y0+1,x,c]      (row pass)
//   out[r,t,s,c] = w0x*tmp(x0) + w1x*tmp(x0+1)                (column pass)
// blended in fp32 in that order with __f*_rn intrinsics (no FMA
// contraction, so the tap geometry matches the torch arithmetic bit for
// bit), and rounded once to the feature's dtype (fp32 or bf16).
//
// Bound: bytes, and of those the writes. Each output element reads four
// input elements but the rois of an image overlap on one map: at the mask
// pool's shapes (E = 64, C = 256, 1200-1600 rois on maps of 88x128 or
// 52x80) the [R,E,E,C] output is ~200 times the [B,H,W,C] input, so the
// least time is the output's bytes over the memory rate.
//
// Design: one block per (roi, patch row t) with the threads over the
// channels. The row's taps are computed once per block and the E column taps
// once per block into shared memory; every thread then walks the E columns
// for its channels, so each warp's four corner reads and its output write
// are coalesced 128-byte lines. The corner reads are not staged: one image's
// fp32 map is at most 11.5 MB and stays in the 50 MB L2, which serves the
// re-reads of overlapping rois, so the device-memory traffic is the output
// stream. The TPU kernel's [E, W, C] VMEM row scratch is not carried over:
// a block's row pass would touch W columns to use E of them.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

template <typename T>
__device__ __forceinline__ float to_float(T v);
template <>
__device__ __forceinline__ float to_float<float>(float v) { return v; }
template <>
__device__ __forceinline__ float to_float<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

struct Taps {
  int i0;
  float w0;
  float w1;
};

// roi_patch.py:_taps for cell i of an axis of n >= 2 cells.
__device__ __forceinline__ Taps taps(float start, float step, int i, int n) {
  const float pos = __fadd_rn(start, __fmul_rn((float)i, step));
  const bool inb = pos > -0.5f && pos < (float)n - 0.5f;
  const float posc = fminf(fmaxf(pos, 0.0f), (float)(n - 1));
  const float i0f = fminf(floorf(posc), (float)(n - 2));
  const float d = __fsub_rn(posc, i0f);
  Taps t;
  t.i0 = (int)i0f;
  t.w0 = inb ? __fsub_rn(1.0f, d) : 0.0f;
  t.w1 = inb ? d : 0.0f;
  return t;
}

template <typename T>
__global__ void roi_patch_kernel(const T* __restrict__ feat,
                                 const float* __restrict__ geom,
                                 T* __restrict__ out, int H, int W, int C,
                                 int rpi, int r0, int E) {
  extern __shared__ float smem[];
  float* wx0 = smem;                  // [E]
  float* wx1 = wx0 + E;               // [E]
  int* x0 = (int*)(wx1 + E);          // [E]

  const int rl = blockIdx.x;          // roi within the chunk
  const int r = r0 + rl;
  const int t = blockIdx.y;           // patch row
  const int b = r / rpi;
  const float ys = geom[r * 4 + 0];
  const float xs = geom[r * 4 + 1];
  const float sh = geom[r * 4 + 2];
  const float sw = geom[r * 4 + 3];

  for (int s = threadIdx.x; s < E; s += blockDim.x) {
    const Taps tx = taps(xs, sw, s, W);
    x0[s] = tx.i0;
    wx0[s] = tx.w0;
    wx1[s] = tx.w1;
  }
  const Taps ty = taps(ys, sh, t, H);
  __syncthreads();

  T* orow = out + ((int64_t)rl * E + t) * E * C;
  if (ty.w0 == 0.0f && ty.w1 == 0.0f) {  // the row is off the map
    for (int i = threadIdx.x; i < E * C; i += blockDim.x)
      orow[i] = from_float<T>(0.0f);
    return;
  }
  const T* row0 = feat + ((int64_t)b * H + ty.i0) * W * C;
  const T* row1 = row0 + (int64_t)W * C;
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    for (int s = 0; s < E; ++s) {
      const int xa = x0[s] * C + c;
      const float ta = __fadd_rn(__fmul_rn(ty.w0, to_float(row0[xa])),
                                 __fmul_rn(ty.w1, to_float(row1[xa])));
      const float tb = __fadd_rn(__fmul_rn(ty.w0, to_float(row0[xa + C])),
                                 __fmul_rn(ty.w1, to_float(row1[xa + C])));
      orow[(int64_t)s * C + c] = from_float<T>(
          __fadd_rn(__fmul_rn(wx0[s], ta), __fmul_rn(wx1[s], tb)));
    }
  }
}

template <typename T>
int launch(const void* feat, const void* geom, void* out, int H, int W, int C,
           int rpi, int r0, int r1, int E, cudaStream_t st) {
  if (r1 <= r0) return (int)cudaSuccess;
  const int threads = C >= 256 ? 256 : (C >= 128 ? 128 : 64);
  const size_t smem = (size_t)E * 3 * sizeof(float);
  dim3 grid(r1 - r0, E);
  roi_patch_kernel<T><<<grid, threads, smem, st>>>(
      (const T*)feat, (const float*)geom, (T*)out, H, W, C, rpi, r0, E);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Writes rois [r0, r1) into out
// [r1-r0, E, E, C].
extern "C" int sniper_roi_patch(const void* feat, const void* geom, void* out,
                                int dtype, int H, int W, int C, int rpi,
                                int r0, int r1, int E, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0)
    return launch<float>(feat, geom, out, H, W, C, rpi, r0, r1, E, st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(feat, geom, out, H, W, C, rpi, r0, r1, E,
                                 st);
  return (int)cudaErrorInvalidValue;
}
