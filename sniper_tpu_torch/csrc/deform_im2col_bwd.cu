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
// Bound: bytes (gcol, 9 times the input, is read once), but what limits a
// simple kernel is the gx scatter: a map cell is a corner of up to 4
// samples of each of the K*K taps of many pixels, and blocks run in no
// order, so the four corner contributions of every gcol element go out as
// fp32 atomics into a zeroed scratch [B,H,W,C] that the wrapper rounds to
// the input dtype with one cast.
//
// Design: the forward's tiling (deform_im2col.cu) turned around. One block
// per tile of kTilePx pixels of one image row, across all taps and groups.
// The block first computes each (pixel, group, tap)'s sample geometry once
// into shared memory (the corner's cell, ly, lx and the two border masks)
// from one coalesced read of the tile's offsets, with the forward's __f*_rn
// order, so the floor, the clamp and the strict-interior mask equal the
// plain version's. A thread then owns one 16-byte vector of gcol (8 bf16 or
// 4 fp32 channels) of one (pixel, tap): one streaming gcol load, four
// 16-byte corner loads of x, and each corner's contribution as 16-byte
// vector atomics (RED.ADD.F32x4), a quarter of the scalar atomics. The L2
// serves atomics per 32-byte sector, so in bf16 (8 channels, 32 bytes of gx
// a lane) the lanes swap halves to make each instruction's pieces
// contiguous: two lanes per sector, which halved the atomics' time. A
// corner whose weight is zero (every corner but one at integer sample
// points, the zero-offset regime of a fresh model) is skipped, which adds
// nothing. goff reduces over a group's lanes by shuffles (a group's 128
// channels are 16 lanes x 8 in bf16) and takes one plain store per (pixel,
// group, tap); when a group's lanes are not a power of two within a warp,
// the lanes add into shared sums instead, stored after one barrier. A group
// narrower than the vector (or a pointer that is not 16-byte aligned) takes
// the same kernel at vector width 1. Not done: summing a tile's gx in
// shared memory before the global atomics; an fp32 atomic add to shared
// memory is a compare-and-swap loop on sm_90, and that version was slower.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTilePx = 8;  // output pixels of one row per block
constexpr int kThreads = 256;
constexpr int kMaxStaticSmem = 48 * 1024;

// One (pixel, group, tap)'s sample: the top-left corner's cell y0*W + x0,
// the blend weights, and bit 0 (0 < sy < H-1) and bit 1 (0 < sx < W-1).
struct Sample {
  int cell;
  float ly;
  float lx;
  int inside;
};

// V channels per load, widened to fp32.
template <typename T, int V>
struct Io;

template <>
struct Io<float, 1> {
  static __device__ __forceinline__ void load(const float* p, float* f) {
    f[0] = __ldg(p);
  }
  static __device__ __forceinline__ void load_stream(const float* p,
                                                     float* f) {
    f[0] = __ldcs(p);
  }
};

template <>
struct Io<float, 4> {
  static __device__ __forceinline__ void unpack(float4 v, float* f) {
    f[0] = v.x;
    f[1] = v.y;
    f[2] = v.z;
    f[3] = v.w;
  }
  static __device__ __forceinline__ void load(const float* p, float* f) {
    unpack(__ldg(reinterpret_cast<const float4*>(p)), f);
  }
  static __device__ __forceinline__ void load_stream(const float* p,
                                                     float* f) {
    unpack(__ldcs(reinterpret_cast<const float4*>(p)), f);
  }
};

template <>
struct Io<__nv_bfloat16, 1> {
  static __device__ __forceinline__ void load(const __nv_bfloat16* p,
                                              float* f) {
    f[0] = __bfloat162float(p[0]);
  }
  static __device__ __forceinline__ void load_stream(const __nv_bfloat16* p,
                                                     float* f) {
    f[0] = __bfloat162float(p[0]);
  }
};

// bf16 as its bit pattern: the upper half of the fp32 with the same value,
// so widening is a shift.
template <>
struct Io<__nv_bfloat16, 8> {
  static __device__ __forceinline__ void unpack(uint4 v, float* f) {
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      f[2 * k] = __uint_as_float(w[k] << 16);
      f[2 * k + 1] = __uint_as_float(w[k] & 0xffff0000u);
    }
  }
  static __device__ __forceinline__ void load(const __nv_bfloat16* p,
                                              float* f) {
    unpack(__ldg(reinterpret_cast<const uint4*>(p)), f);
  }
  static __device__ __forceinline__ void load_stream(const __nv_bfloat16* p,
                                                     float* f) {
    unpack(__ldcs(reinterpret_cast<const uint4*>(p)), f);
  }
};

// gx[cell, c..c+V) += w * g, as one 16-byte atomic (RED.ADD.F32x4) where
// V is 4.
template <int V>
__device__ __forceinline__ void add_corner(float* dst, float w,
                                           const float* g) {
  if constexpr (V == 1)
    atomicAdd(dst, __fmul_rn(w, g[0]));
  else
    atomicAdd(reinterpret_cast<float4*>(dst),
              make_float4(__fmul_rn(w, g[0]), __fmul_rn(w, g[1]),
                          __fmul_rn(w, g[2]), __fmul_rn(w, g[3])));
}

// A sample's gradient g (V channels from gb on) to its four corners,
// skipping a corner whose weight is zero: it would add nothing.
template <int V>
__device__ __forceinline__ void scatter(float* gb, const int64_t* corner,
                                        const Sample& s, const float* g) {
  const float mlx = __fsub_rn(1.0f, s.lx);
  const float mly = __fsub_rn(1.0f, s.ly);
  const float w[4] = {__fmul_rn(mly, mlx), __fmul_rn(mly, s.lx),
                      __fmul_rn(s.ly, mlx), __fmul_rn(s.ly, s.lx)};
#pragma unroll
  for (int q = 0; q < 4; ++q)
    if (w[q] != 0.0f) add_corner<V>(gb + corner[q], w[q], g);
}

// Block (tx, ty): threadIdx.x over a (pixel, tap)'s channel vectors (a
// multiple of 32, so a warp lies in one (pixel, tap) row), threadIdx.y over
// the tile's (pixel, tap) rows. seg: a group's lanes L = C/G/V are a power
// of two <= 32, so goff reduces by shuffles over aligned L-lane segments.
template <typename T, int V>
__global__ void __launch_bounds__(kThreads) deform_im2col_bwd_kernel(
    const T* __restrict__ x, const float* __restrict__ off,
    const T* __restrict__ gcol, float* __restrict__ gx,
    float* __restrict__ goff, int H, int W, int C, int G, int K,
    int dilation, int tiles_per_row, int seg) {
  extern __shared__ Sample samples[];  // [kTilePx][G][K*K], then the sums
  const int KK = K * K;
  const int half = (K - 1) / 2 * dilation;
  const int tile = blockIdx.x % tiles_per_row;
  const int row = blockIdx.x / tiles_per_row;  // b*H + y
  const int py = row % H;
  const int b = row / H;
  const int px0 = tile * kTilePx;
  const int npx = min(kTilePx, W - px0);
  const int64_t pix0 = (int64_t)row * W + px0;
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int nthreads = blockDim.x * blockDim.y;
  const int nsamp = npx * G * KK;
  float* sums = reinterpret_cast<float*>(samples + kTilePx * G * KK);

  // the tile's offsets are one contiguous run of npx*G*KK (dy, dx) pairs
  const float* o = off + pix0 * G * KK * 2;
  for (int e = tid; e < nsamp; e += nthreads) {
    const int t = e % KK;
    const int p = e / (G * KK);
    const int ky = t / K;
    const int kx = t % K;
    float sy = __fadd_rn(__fadd_rn((float)py, (float)(ky * dilation - half)),
                         o[2 * e]);
    float sx = __fadd_rn(
        __fadd_rn((float)(px0 + p), (float)(kx * dilation - half)),
        o[2 * e + 1]);
    sy = fminf(fmaxf(sy, 0.0f), (float)(H - 1));
    sx = fminf(fmaxf(sx, 0.0f), (float)(W - 1));
    const int y0 = min((int)floorf(sy), H - 2);
    const int x0 = min((int)floorf(sx), W - 2);
    const int inside = (sy > 0.0f && sy < (float)(H - 1) ? 1 : 0) |
                       (sx > 0.0f && sx < (float)(W - 1) ? 2 : 0);
    samples[e] = Sample{y0 * W + x0, __fsub_rn(sy, (float)y0),
                        __fsub_rn(sx, (float)x0), inside};
    if (!seg) {
      sums[2 * e] = 0.0f;
      sums[2 * e + 1] = 0.0f;
    }
  }
  __syncthreads();

  const int cg = C / G;
  const int nvec = C / V;
  const int L = cg / V;  // lanes per group
  const int64_t WC = (int64_t)W * C;
  const T* xb = x + (int64_t)b * H * WC;
  float* gxb = gx + (int64_t)b * H * WC;
  const T* gin = gcol + pix0 * KK * C;
  float* gout = goff + pix0 * G * KK * 2;
  const int64_t corner[4] = {0, C, WC, WC + C};
  // a warp's lanes take the same trip counts in both loops
  for (int pt = threadIdx.y; pt < npx * KK; pt += blockDim.y) {
    const int p = pt / KK;
    const int t = pt - p * KK;
    const T* grow = gin + (int64_t)pt * C;
    for (int v0 = 0; v0 < nvec; v0 += blockDim.x) {
      const int v = v0 + threadIdx.x;
      const bool act = v < nvec;
      float dy = 0.0f, dx = 0.0f;
      int si = 0;
      Sample s{0, 0.0f, 0.0f, 0};
      float gv[V] = {};
      if (act) {
        const int c = v * V;
        si = (p * G + c / cg) * KK + t;
        s = samples[si];
        float xv[4][V];
        Io<T, V>::load_stream(grow + c, gv);
        const T* base = xb + (int64_t)s.cell * C + c;
#pragma unroll
        for (int q = 0; q < 4; ++q) Io<T, V>::load(base + corner[q], xv[q]);
        if constexpr (V != 8)
          scatter<V>(gxb + (int64_t)s.cell * C + c, corner, s, gv);
        const float mlx = __fsub_rn(1.0f, s.lx);
        const float mly = __fsub_rn(1.0f, s.ly);
#pragma unroll
        for (int k = 0; k < V; ++k) {
          const float dvy =
              __fadd_rn(__fmul_rn(__fsub_rn(xv[2][k], xv[0][k]), mlx),
                        __fmul_rn(__fsub_rn(xv[3][k], xv[1][k]), s.lx));
          const float dvx =
              __fadd_rn(__fmul_rn(__fsub_rn(xv[1][k], xv[0][k]), mly),
                        __fmul_rn(__fsub_rn(xv[3][k], xv[2][k]), s.ly));
          dy = __fadd_rn(dy, __fmul_rn(gv[k], dvy));
          dx = __fadd_rn(dx, __fmul_rn(gv[k], dvx));
        }
      }
      if constexpr (V == 8) {
        // A lane's 8 channels are 32 bytes of gx. Lane l adds channels
        // 4l..4l+3 of each 512-byte half i of the warp's 256 channels, taken
        // from lane l/2 + 16i, so two lanes fill each 32-byte sector of an
        // atomic instruction: half the L2's atomic requests of 16-byte
        // pieces 32 bytes apart.
        const int lane = threadIdx.x & 31;
        const int wv0 = v0 + (threadIdx.x & ~31);  // the warp's first vector
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int src = (lane >> 1) + 16 * i;
          float h[4];
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            const float lo = __shfl_sync(0xffffffffu, gv[k], src);
            const float hi = __shfl_sync(0xffffffffu, gv[k + 4], src);
            h[k] = (lane & 1) ? hi : lo;
          }
          if (wv0 + src < nvec) {
            const int c = (wv0 + src) * 8 + 4 * (lane & 1);
            const Sample& s2 = samples[(p * G + c / cg) * KK + t];
            scatter<4>(gxb + (int64_t)s2.cell * C + c, corner, s2, h);
          }
        }
      }
      if (seg) {
        for (int m = L >> 1; m > 0; m >>= 1) {
          dy += __shfl_xor_sync(0xffffffffu, dy, m);
          dx += __shfl_xor_sync(0xffffffffu, dx, m);
        }
        if (act && (threadIdx.x & (L - 1)) == 0)
          reinterpret_cast<float2*>(gout)[si] =
              make_float2((s.inside & 1) ? dy : 0.0f,
                          (s.inside & 2) ? dx : 0.0f);
      } else if (act) {
        atomicAdd(&sums[2 * si], dy);
        atomicAdd(&sums[2 * si + 1], dx);
      }
    }
  }
  if (seg) return;
  __syncthreads();
  for (int e = tid; e < nsamp; e += nthreads) {
    const int inside = samples[e].inside;
    gout[2 * e] = (inside & 1) ? sums[2 * e] : 0.0f;
    gout[2 * e + 1] = (inside & 2) ? sums[2 * e + 1] : 0.0f;
  }
}

template <typename T, int V>
int launch_width(const void* x, const void* off, const void* gcol, void* gx,
                 void* goff, int B, int H, int W, int C, int G, int K,
                 int dilation, cudaStream_t st) {
  const int tiles = (W + kTilePx - 1) / kTilePx;
  const int64_t blocks = (int64_t)B * H * tiles;
  const int L = C / G / V;
  const int seg = L <= 32 && (L & (L - 1)) == 0;
  const size_t nsamp = (size_t)kTilePx * G * K * K;
  const size_t smem = nsamp * sizeof(Sample) + (seg ? 0 : nsamp * 8);
  if (blocks > 2147483647LL || smem > kMaxStaticSmem)
    return (int)cudaErrorInvalidValue;
  const int nvec = C / V;
  const int tx = min(kThreads, (nvec + 31) / 32 * 32);
  const dim3 block(tx, kThreads / tx);
  deform_im2col_bwd_kernel<T, V><<<(unsigned)blocks, block, smem, st>>>(
      (const T*)x, (const float*)off, (const T*)gcol, (float*)gx,
      (float*)goff, H, W, C, G, K, dilation, tiles, seg);
  return (int)cudaGetLastError();
}

// 16-byte vectors where every group holds whole vectors and the pointers
// allow them; width 1 otherwise.
template <typename T>
int launch(const void* x, const void* off, const void* gcol, void* gx,
           void* goff, int B, int H, int W, int C, int G, int K, int dilation,
           cudaStream_t st) {
  constexpr int V = 16 / sizeof(T);
  const bool aligned =
      ((uintptr_t)x | (uintptr_t)gcol | (uintptr_t)gx) % 16 == 0;
  if ((C / G) % V == 0 && aligned)
    return launch_width<T, V>(x, off, gcol, gx, goff, B, H, W, C, G, K,
                              dilation, st);
  return launch_width<T, 1>(x, off, gcol, gx, goff, B, H, W, C, G, K,
                            dilation, st);
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
