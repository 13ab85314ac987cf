// DCNv1 bilinear im2col for Hopper, backward.
//
// Replaces: sniper_tpu/ops/deform.py:_make_im2col.im2col_bwd (XLA: per tap
// and group, a one-hot tent matmul for the input gradient and the
// forward's corner gathers for the offset gradient), the VJP of the C5
// trunk's deformable 3x3.
//
// Semantics (the JAX package's): with the forward's sample geometry (see
// deform_im2col.cu: the clamped (sy, sx), y0 = min(floor(sy), H-2),
// x0 = min(floor(sx), W-2), ly = sy - y0, lx = sx - x0), for output pixel
// q, tap t and channel c of group g, gq = gcol[q,t,c]:
//   gx[y0+i, x0+j, c] += wy_i * wx_j * gq    (wy_0 = 1-ly, wy_1 = ly, ...),
//   goff[q,g,t,0] = (0 < sy < H-1) * sum_{c in g} gq * dvy,
//   goff[q,g,t,1] = (0 < sx < W-1) * sum_{c in g} gq * dvx,
//   dvy = (v10 - v00)*(1-lx) + (v11 - v01)*lx,
//   dvx = (v01 - v00)*(1-ly) + (v11 - v10)*ly,
// where v are the input's corner values in fp32. A clamped sample gets no
// positional gradient: the mask is strictly inside the border. gx is summed
// in fp32 and rounded once to the input dtype, as im2col_bwd does.
//
// Design: one block per (pixel, tap), threads over the channels, the
// forward's layout, so the gcol reads, the corner reads and the gx updates
// are coalesced across a warp. gx gets its four corners by fp32 atomicAdd
// (RED.ADD.F32) into a zeroed fp32 scratch [B,H,W,C]: a map cell is a
// corner of up to 4 samples of each of the K*K taps of many pixels, and the
// blocks run in no order. The wrapper then rounds the scratch to the input
// dtype with one cast. goff reduces over each group's channels in the
// block: a warp-shuffle sum when a group's channels fill whole warps, then
// one shared-memory add per warp.
//
// Bound: the gx atomics (four per gcol element) and the gcol and corner
// reads (bf16), mostly hits in L2 since neighbouring pixels and taps share
// corners. The geometry uses __f*_rn intrinsics like the forward, so its
// discrete decisions (floor, the clamp, the border mask) equal the plain
// torch version's.

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

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

struct Sample {
  float sy, sx, ly, lx;
  int y0, x0;
};

// The forward's geometry for pixel (py, px), tap (ky, kx), offsets og.
__device__ __forceinline__ Sample sample_at(const float* og, int py, int px,
                                            int ky, int kx, int dilation,
                                            int half, int H, int W) {
  Sample s;
  s.sy = __fadd_rn(__fadd_rn((float)py, (float)(ky * dilation - half)), og[0]);
  s.sx = __fadd_rn(__fadd_rn((float)px, (float)(kx * dilation - half)), og[1]);
  s.sy = fminf(fmaxf(s.sy, 0.0f), (float)(H - 1));
  s.sx = fminf(fmaxf(s.sx, 0.0f), (float)(W - 1));
  s.y0 = min((int)floorf(s.sy), H - 2);
  s.x0 = min((int)floorf(s.sx), W - 2);
  s.ly = __fsub_rn(s.sy, (float)s.y0);
  s.lx = __fsub_rn(s.sx, (float)s.x0);
  return s;
}

template <typename T>
__global__ void deform_im2col_bwd_kernel(
    const T* __restrict__ x, const float* __restrict__ off,
    const T* __restrict__ gcol, float* __restrict__ gx,
    float* __restrict__ goff, int H, int W, int C, int G, int K,
    int dilation) {
  extern __shared__ float red[];  // [G][2]: the group sums of this tap
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
  float* gxb = gx + (int64_t)b * H * W * C;
  const T* gq = gcol + (int64_t)pt * C;
  // a group's channels fill whole warps: reduce in the warp first (the
  // warp's lanes then all lie in one group, and C is a multiple of 32)
  const bool warp_groups = cg % 32 == 0;

  for (int i = threadIdx.x; i < 2 * G; i += blockDim.x) red[i] = 0.0f;
  __syncthreads();
  // the loop bound is the same for the whole block, so whole warps reach
  // the shuffles together
  for (int c0 = 0; c0 < C; c0 += blockDim.x) {
    const int c = c0 + threadIdx.x;
    float gy = 0.0f, gxv = 0.0f;
    int g = 0;
    if (c < C) {
      g = c / cg;
      const Sample s = sample_at(o + g * KK * 2, py, px, ky, kx, dilation,
                                 half, H, W);
      const float gv = to_float(gq[c]);
      const int64_t base = ((int64_t)s.y0 * W + s.x0) * C + c;
      const float mlx = __fsub_rn(1.0f, s.lx);
      const float mly = __fsub_rn(1.0f, s.ly);
      atomicAdd(gxb + base, __fmul_rn(__fmul_rn(mly, mlx), gv));
      atomicAdd(gxb + base + C, __fmul_rn(__fmul_rn(mly, s.lx), gv));
      atomicAdd(gxb + base + (int64_t)W * C,
                __fmul_rn(__fmul_rn(s.ly, mlx), gv));
      atomicAdd(gxb + base + (int64_t)W * C + C,
                __fmul_rn(__fmul_rn(s.ly, s.lx), gv));
      const T* xc = xb + base;
      const float v00 = to_float(xc[0]);
      const float v01 = to_float(xc[C]);
      const float v10 = to_float(xc[(int64_t)W * C]);
      const float v11 = to_float(xc[(int64_t)W * C + C]);
      const float dvy = __fadd_rn(__fmul_rn(__fsub_rn(v10, v00), mlx),
                                  __fmul_rn(__fsub_rn(v11, v01), s.lx));
      const float dvx = __fadd_rn(__fmul_rn(__fsub_rn(v01, v00), mly),
                                  __fmul_rn(__fsub_rn(v11, v10), s.ly));
      gy = __fmul_rn(gv, dvy);
      gxv = __fmul_rn(gv, dvx);
    }
    if (warp_groups) {
      gy = warp_sum(gy);
      gxv = warp_sum(gxv);
      if ((threadIdx.x & 31) == 0 && c < C) {
        atomicAdd(&red[2 * g], gy);
        atomicAdd(&red[2 * g + 1], gxv);
      }
    } else if (c < C) {
      atomicAdd(&red[2 * g], gy);
      atomicAdd(&red[2 * g + 1], gxv);
    }
  }
  __syncthreads();
  for (int g = threadIdx.x; g < G; g += blockDim.x) {
    const Sample s = sample_at(o + g * KK * 2, py, px, ky, kx, dilation, half,
                               H, W);
    const float my = (s.sy > 0.0f && s.sy < (float)(H - 1)) ? 1.0f : 0.0f;
    const float mx = (s.sx > 0.0f && s.sx < (float)(W - 1)) ? 1.0f : 0.0f;
    float* out = goff + ((int64_t)pix * G * KK + g * KK + t) * 2;
    out[0] = __fmul_rn(red[2 * g], my);
    out[1] = __fmul_rn(red[2 * g + 1], mx);
  }
}

template <typename T>
int launch(const void* x, const void* off, const void* gcol, void* gx,
           void* goff, int B, int H, int W, int C, int G, int K, int dilation,
           cudaStream_t st) {
  const int64_t blocks = (int64_t)B * H * W * K * K;
  if (blocks > 2147483647LL) return (int)cudaErrorInvalidValue;
  const int threads = C >= 256 ? 256 : (C >= 128 ? 128 : 64);
  deform_im2col_bwd_kernel<T><<<(unsigned)blocks, threads,
                                2 * G * sizeof(float), st>>>(
      (const T*)x, (const float*)off, (const T*)gcol, (float*)gx,
      (float*)goff, H, W, C, G, K, dilation);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x and gcol); gx is the fp32 scratch.
extern "C" int sniper_deform_im2col_bwd(const void* x, const void* offsets,
                                        const void* gcol, void* gx,
                                        void* goff, int dtype, int B, int H,
                                        int W, int C, int G, int K,
                                        int dilation, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0)
    return launch<float>(x, offsets, gcol, gx, goff, B, H, W, C, G, K,
                         dilation, st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, offsets, gcol, gx, goff, B, H, W, C, G,
                                 K, dilation, st);
  return (int)cudaErrorInvalidValue;
}
