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
// (dy, dx) pairs per tap, group-major; col group-major over the conv's
// CG = conv_groups groups, [CG, B*H*W, K*K*cg_in] with cg_in = C/CG: channel
// c = g*cg_in + ci of (pixel p, tap t) is element ((g*B*H*W + p)*K*K + t)*cg_in
// + ci, the layout the grouped product multiplies as it is (the deformed
// taps of ResNeXt's C5; sniper_tpu/ops/deform.py:270-278 reorders the col
// so in XLA). With CG = 1 that is [B,H,W,K*K,C].
//
// Bound: bytes, and of those the writes. col is K*K = 9 times the input
// (415 MB in bf16 at the C5 map of the first test scale), while each corner
// read hits L1 or L2, because neighbouring taps and pixels share corners.
//
// Design: one block per tile of kTilePx pixels of one image row, across all
// taps and the deformable groups of its channel slice: all groups where a
// group is narrower than 32 vectors (R101's 128 channels), one group where
// it is 32 or more (ResNeXt-101's 512), the slice being the grid's slowest
// index. X101's C5 map is 46 MB per image in bf16 at the first test scale,
// so the blocks in flight across all channels read corners from more rows
// than L2 holds; within one group's slice they need a quarter (on an
// H100 80GB HBM3: 1.40 -> 0.82 ms). The block first computes each (pixel,
// group, tap)'s sample geometry once into shared memory (the corner's cell
// index and the two blend weights, 16 bytes), reading the tile's offsets
// as one stream.
// Each thread then owns one 16-byte vector of channels (8 bf16 or 4 fp32),
// fixed over the block's (pixel, tap) rows, so its address arithmetic
// (including the division by cg_in) is done once; per row it makes four
// 16-byte corner loads, blends in fp32 in the order above and writes one
// 16-byte streaming store (st.global.cs), so the write stream does not
// evict x from L2. With CG = 1 a warp writes 512 contiguous bytes; with
// ResNeXt's 32-channel conv groups it writes one aligned 64-byte run (two
// full sectors) into each of 8 groups' stretches, so writing group-major
// costs no partial sectors and saves the copy the product would otherwise
// make. A deformable or conv group narrower than the vector (or a pointer
// that is not 16-byte aligned) takes the same kernel at vector width 1.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTilePx = 16;   // output pixels of one row per block
constexpr int kThreads = 256;
constexpr int kMaxStaticSmem = 48 * 1024;

// One (pixel, group, tap)'s sample: the top-left corner's cell y0*W + x0
// and the blend weights.
struct Sample {
  int cell;
  float ly;
  float lx;
  int pad;
};

// V channels per load and store; fp32 blends in fwd_impl's order.
template <typename T, int V>
struct Io;

template <>
struct Io<float, 1> {
  static __device__ __forceinline__ void load(const float* p, float* f) {
    f[0] = __ldg(p);
  }
  static __device__ __forceinline__ void store(float* p, const float* f) {
    __stcs(p, f[0]);
  }
};

template <>
struct Io<float, 4> {
  static __device__ __forceinline__ void load(const float* p, float* f) {
    const float4 v = __ldg(reinterpret_cast<const float4*>(p));
    f[0] = v.x;
    f[1] = v.y;
    f[2] = v.z;
    f[3] = v.w;
  }
  static __device__ __forceinline__ void store(float* p, const float* f) {
    __stcs(reinterpret_cast<float4*>(p), make_float4(f[0], f[1], f[2], f[3]));
  }
};

// bf16 as its bit pattern: the upper half of the fp32 with the same value,
// so widening is a shift and narrowing is __float2bfloat16_rn.
__device__ __forceinline__ uint32_t bf16_bits(float v) {
  return (uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(v));
}

template <>
struct Io<__nv_bfloat16, 1> {
  static __device__ __forceinline__ void load(const __nv_bfloat16* p,
                                              float* f) {
    f[0] = __bfloat162float(p[0]);
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p,
                                               const float* f) {
    p[0] = __float2bfloat16_rn(f[0]);
  }
};

template <>
struct Io<__nv_bfloat16, 8> {
  static __device__ __forceinline__ void load(const __nv_bfloat16* p,
                                              float* f) {
    const uint4 v = __ldg(reinterpret_cast<const uint4*>(p));
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      f[2 * k] = __uint_as_float(w[k] << 16);
      f[2 * k + 1] = __uint_as_float(w[k] & 0xffff0000u);
    }
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p,
                                               const float* f) {
    uint32_t w[4];
#pragma unroll
    for (int k = 0; k < 4; ++k)
      w[k] = bf16_bits(f[2 * k]) | (bf16_bits(f[2 * k + 1]) << 16);
    __stcs(reinterpret_cast<uint4*>(p), make_uint4(w[0], w[1], w[2], w[3]));
  }
};

// Block (tx, ty): threadIdx.x over a (pixel, tap)'s channel vectors of the
// block's slice, threadIdx.y over the tile's (pixel, tap) rows. The grid
// runs over (slice, image row, tile), the slice slowest.
template <typename T, int V>
__global__ void __launch_bounds__(kThreads) deform_im2col_kernel(
    const T* __restrict__ x, const float* __restrict__ off,
    T* __restrict__ col, int H, int W, int C, int G, int K, int dilation,
    int conv_groups, int64_t bhw, int tiles_per_row, int row_tiles,
    int slices) {
  extern __shared__ Sample samples[];  // [kTilePx][G/slices][K*K]
  const int KK = K * K;
  const int half = (K - 1) / 2 * dilation;
  const int slice = blockIdx.x / row_tiles;
  const int rt = blockIdx.x - slice * row_tiles;
  const int tile = rt % tiles_per_row;
  const int row = rt / tiles_per_row;  // b*H + y
  const int py = row % H;
  const int b = row / H;
  const int px0 = tile * kTilePx;
  const int npx = min(kTilePx, W - px0);
  const int64_t pix0 = (int64_t)row * W + px0;
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int nthreads = blockDim.x * blockDim.y;

  // a block sample (p, group g0 + gl, t) at e = (p*Gs + gl)*KK + t is the
  // tile's (p*G + g0 + gl)*KK + t
  const int Gs = G / slices;  // the block's deformable groups
  const int g0 = slice * Gs;
  const int skip = (G - Gs) * KK;
  const float* o = off + (pix0 * G + g0) * KK * 2;
  for (int e = tid; e < npx * Gs * KK; e += nthreads) {
    const int t = e % KK;
    const int p = e / (Gs * KK);
    const int ky = t / K;
    const int kx = t % K;
    const float* oe = o + 2 * (e + p * skip);
    float sy = __fadd_rn(__fadd_rn((float)py, (float)(ky * dilation - half)),
                         oe[0]);
    float sx = __fadd_rn(
        __fadd_rn((float)(px0 + p), (float)(kx * dilation - half)), oe[1]);
    sy = fminf(fmaxf(sy, 0.0f), (float)(H - 1));
    sx = fminf(fmaxf(sx, 0.0f), (float)(W - 1));
    const int y0 = min((int)floorf(sy), H - 2);
    const int x0 = min((int)floorf(sx), W - 2);
    samples[e] = Sample{y0 * W + x0, __fsub_rn(sy, (float)y0),
                        __fsub_rn(sx, (float)x0), 0};
  }
  __syncthreads();

  const int cg = C / G;
  const int cg_in = C / conv_groups;
  const int nvec = Gs * cg / V;
  const int GKK = Gs * KK;
  const int c0 = g0 * cg;
  const int64_t WC = (int64_t)W * C;
  const T* xb = x + (int64_t)b * H * WC;
  // The channel vector's part of the address and its deformable group's
  // samples are fixed per thread: the loop over (pixel, tap) rows is inner.
  for (int v = threadIdx.x; v < nvec; v += blockDim.x) {
    const int c = c0 + v * V;
    const int gc = c / cg_in;
    const T* xc = xb + c;
    const Sample* sg = samples + (v * V / cg) * KK;
    T* dst = col + ((int64_t)gc * bhw + pix0) * KK * cg_in + (c - gc * cg_in);
    for (int pt = threadIdx.y; pt < npx * KK; pt += blockDim.y) {
      const int p = pt / KK;
      const Sample s = sg[p * GKK + (pt - p * KK)];
      const T* base = xc + (int64_t)s.cell * C;
      float v00[V], v01[V], v10[V], v11[V], r[V];
      Io<T, V>::load(base, v00);
      Io<T, V>::load(base + C, v01);
      Io<T, V>::load(base + WC, v10);
      Io<T, V>::load(base + WC + C, v11);
      const float mlx = __fsub_rn(1.0f, s.lx);
      const float mly = __fsub_rn(1.0f, s.ly);
#pragma unroll
      for (int k = 0; k < V; ++k) {
        const float top =
            __fadd_rn(__fmul_rn(v00[k], mlx), __fmul_rn(v01[k], s.lx));
        const float bot =
            __fadd_rn(__fmul_rn(v10[k], mlx), __fmul_rn(v11[k], s.lx));
        r[k] = __fadd_rn(__fmul_rn(top, mly), __fmul_rn(bot, s.ly));
      }
      Io<T, V>::store(dst + (int64_t)pt * cg_in, r);
    }
  }
}

template <typename T, int V>
int launch_width(const void* x, const void* off, void* col, int B, int H,
                 int W, int C, int G, int K, int dilation, int conv_groups,
                 cudaStream_t st) {
  const int tiles = (W + kTilePx - 1) / kTilePx;
  // a deformable group of 32 vectors or more takes its own blocks
  const int slices = C / G / V >= 32 ? G : 1;
  const int64_t blocks = (int64_t)slices * B * H * tiles;
  const size_t smem = (size_t)kTilePx * (G / slices) * K * K * sizeof(Sample);
  if (blocks > 2147483647LL || smem > kMaxStaticSmem)
    return (int)cudaErrorInvalidValue;
  const int nvec = C / slices / V;
  const int tx = min(kThreads, (nvec + 31) / 32 * 32);
  const dim3 block(tx, kThreads / tx);
  deform_im2col_kernel<T, V><<<(unsigned)blocks, block, smem, st>>>(
      (const T*)x, (const float*)off, (T*)col, H, W, C, G, K, dilation,
      conv_groups, (int64_t)B * H * W, tiles, B * H * tiles, slices);
  return (int)cudaGetLastError();
}

// 16-byte vectors where every deformable and conv group holds whole
// vectors and the pointers allow them; width 1 otherwise.
template <typename T>
int launch(const void* x, const void* off, void* col, int B, int H, int W,
           int C, int G, int K, int dilation, int conv_groups,
           cudaStream_t st) {
  constexpr int V = 16 / sizeof(T);
  const bool aligned = ((uintptr_t)x | (uintptr_t)col) % 16 == 0;
  if ((C / G) % V == 0 && (C / conv_groups) % V == 0 && aligned)
    return launch_width<T, V>(x, off, col, B, H, W, C, G, K, dilation,
                              conv_groups, st);
  return launch_width<T, 1>(x, off, col, B, H, W, C, G, K, dilation,
                            conv_groups, st);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. conv_groups divides C.
extern "C" int sniper_deform_im2col(const void* x, const void* offsets,
                                    void* col, int dtype, int B, int H, int W,
                                    int C, int G, int K, int dilation,
                                    int conv_groups, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (conv_groups < 1 || C % conv_groups) return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return launch<float>(x, offsets, col, B, H, W, C, G, K, dilation,
                         conv_groups, st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, offsets, col, B, H, W, C, G, K, dilation,
                                 conv_groups, st);
  return (int)cudaErrorInvalidValue;
}
