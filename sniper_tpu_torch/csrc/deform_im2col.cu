// DCNv1 bilinear im2col for Hopper, forward only.
//
// Replaces: sniper_tpu/ops/deform.py:_make_im2col.fwd_impl (XLA gathers;
// reached from deformable_conv, the C5 trunk's deformable 3x3), the
// counterpart of the reference's CUDA DeformableConvolution im2col.
//
// Semantics (the JAX package's, not the reference CUDA op's): for output
// pixel (y, x), tap t = ky*K + kx and deformable group g, the sample point
//   sy = clip((y + (ky*d - half)) + off[b,y,x,g,t,0], 0, H-1)
//   sx = clip((x + (kx*d - half)) + off[b,y,x,g,t,1], 0, W-1)
// is CLAMPED onto the map (not zero-padded), with y0 = min(floor(sy), H-2)
// and x0 = min(floor(sx), W-2) so the 2x2 corner patch stays inside. The
// blend runs in fp32 in the order of fwd_impl,
//   top = v00*(1-lx) + v01*lx, bot = v10*(1-lx) + v11*lx,
//   out = top*(1-ly) + bot*ly,
// with __f*_rn intrinsics (no FMA contraction), and is rounded once to the
// input dtype. Layouts: x [B,H,W,C] NHWC, offsets [B,H,W,G*K*K*2] fp32 with
// (dy, dx) pairs per tap, group-major; col [B,H,W,K*K,C].
//
// Bound: bytes. Each output element reads four input elements, which sit in
// L2/L1 because neighbouring taps and pixels share them, and writes one:
// col is K*K = 9 times the input, so the write stream dominates. One block
// per (pixel, tap) with the threads over the channels, so both the corner
// reads and the col writes are coalesced across a warp; each thread
// recomputes its group's sample geometry (a few flops against 2-byte
// writes).

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

// One block per (pixel, tap); threads stride over the channels, so the
// corner reads and the col writes are coalesced and the index math is one
// 32-bit decomposition per block instead of a 64-bit one per element.
template <typename T>
__global__ void deform_im2col_kernel(const T* __restrict__ x,
                                     const float* __restrict__ off,
                                     T* __restrict__ col, int H, int W,
                                     int C, int G, int K, int dilation) {
  const int KK = K * K;
  const int cg = C / G;
  const int half = (K - 1) / 2 * dilation;
  const int pt = blockIdx.x;  // ((b*H + y)*W + x)*KK + t
  const int t = pt % KK;
  const int pix = pt / KK;
  const int px = pix % W;
  const int py = (pix / W) % H;
  const int b = pix / (W * H);
  const int ky = t / K;
  const int kx = t % K;
  const float* o = off + ((int64_t)pix * G * KK + t) * 2;
  const T* xb = x + (int64_t)b * H * W * C;
  T* out = col + (int64_t)pt * C;

  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    const int g = c / cg;
    const float* og = o + g * KK * 2;
    float sy = __fadd_rn(__fadd_rn((float)py, (float)(ky * dilation - half)),
                         og[0]);
    float sx = __fadd_rn(__fadd_rn((float)px, (float)(kx * dilation - half)),
                         og[1]);
    sy = fminf(fmaxf(sy, 0.0f), (float)(H - 1));
    sx = fminf(fmaxf(sx, 0.0f), (float)(W - 1));
    const int y0 = min((int)floorf(sy), H - 2);
    const int x0 = min((int)floorf(sx), W - 2);
    const float ly = __fsub_rn(sy, (float)y0);
    const float lx = __fsub_rn(sx, (float)x0);

    const T* base = xb + ((int64_t)y0 * W + x0) * C + c;
    const float v00 = to_float(base[0]);
    const float v01 = to_float(base[C]);
    const float v10 = to_float(base[(int64_t)W * C]);
    const float v11 = to_float(base[(int64_t)W * C + C]);
    const float mlx = __fsub_rn(1.0f, lx);
    const float mly = __fsub_rn(1.0f, ly);
    const float top = __fadd_rn(__fmul_rn(v00, mlx), __fmul_rn(v01, lx));
    const float bot = __fadd_rn(__fmul_rn(v10, mlx), __fmul_rn(v11, lx));
    out[c] = from_float<T>(__fadd_rn(__fmul_rn(top, mly), __fmul_rn(bot, ly)));
  }
}

template <typename T>
int launch(const void* x, const void* off, void* col, int B, int H, int W,
           int C, int G, int K, int dilation, cudaStream_t st) {
  const int64_t blocks = (int64_t)B * H * W * K * K;
  if (blocks > 2147483647LL) return (int)cudaErrorInvalidValue;
  const int threads = C >= 256 ? 256 : (C >= 128 ? 128 : 64);
  deform_im2col_kernel<T><<<(unsigned)blocks, threads, 0, st>>>(
      (const T*)x, (const float*)off, (T*)col, H, W, C, G, K, dilation);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.
extern "C" int sniper_deform_im2col(const void* x, const void* offsets,
                                    void* col, int dtype, int B, int H, int W,
                                    int C, int G, int K, int dilation,
                                    void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0)
    return launch<float>(x, offsets, col, B, H, W, C, G, K, dilation, st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, offsets, col, B, H, W, C, G, K, dilation,
                                 st);
  return (int)cudaErrorInvalidValue;
}
