// Per-roi bilinear patch extraction for Hopper, forward only.
//
// Replaces: sniper_tpu/ops/pallas/roi_patch.py:extract_patches (kernel body
// _patch_kernel), the extraction step of the einsum two-pass pool
// (sniper_tpu/ops/deform.py:_extract_patch_batched computes the same
// function with two dense tent einsums). The port runs it in the patch
// route of the two-pass pool (ops/deform.py:patch_offset_pool) before the
// pass-1 bin average, the offset FC and the stencil product, which stay
// torch ops.
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
// Bound: bytes, and of those the writes. The [R, E, E, C] output is ~35
// (E 36) to ~110 (E 64) times the [B, H, W, C] map at the main path's
// shapes, so the least time is the output's bytes over the memory rate.
//
// Design: a block owns one roi, one 256-byte channel tile (64 fp32 or 128
// bf16 channels, 16 lanes of 16 bytes) and a band of consecutive patch rows
// t. It stages the raw source rows its taps need in shared memory, each row
// once: the taps step by sub_h < 1 cell for most rois, so neighbouring t
// share the pair (y0, y0+1), and a row that the next t needs again is not
// loaded again. Row slots are assigned in t order (y0 never decreases),
// kRows at a time: a stage covers as many consecutive t as fit and is
// loaded with 16-byte cp.async over the roi's column window [x0[0],
// x0[E-1] + 1]. A window wider than kCols (a large roi) is cut into column
// tiles over s (x0 never decreases either), each staging its own rows. So
// the L2 reads are about the roi's footprint on the map instead of four per
// output element.
// Each thread then blends one 16-byte vector of channels of one s over a
// run of kRun consecutive t from shared memory: the four corners of a row
// pair are read once per run and moving to the next t costs a few adds, so
// the index work leaves the instruction slots to the stores. The output
// leaves by 16-byte streaming stores (st.global.cs), which keep the 1.6-5
// GB write stream from evicting the map (11.5 MB per image in fp32) from
// L2. The grid is (channel tile, row band, roi), tiles fastest, so the
// blocks that write the C channels of one output cell run together and the
// stream reaches memory in whole cells; a launch of the path's 64 rois is
// cut into row bands until it holds about eight blocks per SM.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kLanes = 16;                   // 16-byte vectors per tile
constexpr int kItems = kThreads / kLanes;    // work units at a time
constexpr int kRun = 4;                      // rows t per work unit
constexpr int kRows = 8;                     // source-row slots per stage
constexpr int kCols = 24;                    // source columns per stage
constexpr int kStageBytes = kRows * kCols * kLanes * 16;
constexpr int kMaxSmem = 232448;             // a block's most on sm_90
constexpr int kMaxDevices = 16;

// 16 bytes of T as fp32, and back with one rounding.
template <typename T>
struct Vec;

template <>
struct Vec<float> {
  static constexpr int N = 4;
  static __device__ __forceinline__ void unpack(uint4 v, float* f) {
    f[0] = __uint_as_float(v.x);
    f[1] = __uint_as_float(v.y);
    f[2] = __uint_as_float(v.z);
    f[3] = __uint_as_float(v.w);
  }
  static __device__ __forceinline__ uint4 pack(const float* f) {
    return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]),
                      __float_as_uint(f[2]), __float_as_uint(f[3]));
  }
};

// bf16 as its bit pattern: the upper half of the fp32 with the same value,
// so widening is a shift and narrowing is __float2bfloat16_rn.
__device__ __forceinline__ uint32_t bf16_bits(float v) {
  return (uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(v));
}

template <>
struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
  static __device__ __forceinline__ void unpack(uint4 v, float* f) {
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      f[2 * k] = __uint_as_float(w[k] << 16);
      f[2 * k + 1] = __uint_as_float(w[k] & 0xffff0000u);
    }
  }
  static __device__ __forceinline__ uint4 pack(const float* f) {
    uint32_t w[4];
#pragma unroll
    for (int k = 0; k < 4; ++k)
      w[k] = bf16_bits(f[2 * k]) | (bf16_bits(f[2 * k + 1]) << 16);
    return make_uint4(w[0], w[1], w[2], w[3]);
  }
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::);
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

// Shared memory after the stage: the taps of both axes, then the stage
// plan of the block's band (see plan_stages).
struct Plan {
  float* wy0;   // [E]
  float* wy1;   // [E]
  float* wx0;   // [E]
  float* wx1;   // [E]
  int* y0;      // [E] the row pair's first row, -1 where the row is off
  int* x0;      // [E]
  int* tslot;   // [E] row y0's slot within its stage
  int* rowy;    // [2E] the source row of each slot, stages back to back
  int* st_t;    // [E+1] each stage's first t
  int* st_r;    // [E+1] each stage's first entry of rowy
  int* nstage;  // [1]
};

__host__ __device__ __forceinline__ size_t smem_bytes(int E) {
  return (size_t)kStageBytes + (size_t)4 * E * sizeof(float) +
         ((size_t)7 * E + 3) * sizeof(int);
}

__device__ __forceinline__ Plan carve(unsigned char* base, int E) {
  Plan p;
  p.wy0 = reinterpret_cast<float*>(base + kStageBytes);
  p.wy1 = p.wy0 + E;
  p.wx0 = p.wy1 + E;
  p.wx1 = p.wx0 + E;
  p.y0 = reinterpret_cast<int*>(p.wx1 + E);
  p.x0 = p.y0 + E;
  p.tslot = p.x0 + E;
  p.rowy = p.tslot + E;
  p.st_t = p.rowy + 2 * E;
  p.st_r = p.st_t + E + 1;
  p.nstage = p.st_r + E + 1;
  return p;
}

// One thread: cut the band [ta, tb) into stages of at most kRows source
// rows. Row t needs rows (y0, y0+1); y0 never decreases, so the last two
// slots assigned always hold rows (last-1, last) and a t whose y0 is
// last-1 needs no new slot, one whose y0 is last needs one.
__device__ void plan_stages(const Plan& p, int ta, int tb) {
  int k = 0, n = 0, total = 0, last = -2;
  p.st_t[0] = ta;
  p.st_r[0] = 0;
  for (int t = ta; t < tb; ++t) {
    const int y = p.y0[t];
    if (y < 0) {
      p.tslot[t] = -1;
      continue;
    }
    int need = y > last ? 2 : (y == last ? 1 : 0);
    if (n + need > kRows) {
      ++k;
      p.st_t[k] = t;
      p.st_r[k] = total;
      n = 0;
      need = 2;
    }
    if (need == 2) {
      p.rowy[total++] = y;
      p.rowy[total++] = y + 1;
      p.tslot[t] = n;
    } else if (need == 1) {
      p.rowy[total++] = y + 1;
      p.tslot[t] = n - 1;
    } else {
      p.tslot[t] = n - 2;
    }
    n += need;
    last = y + 1;
  }
  p.st_t[k + 1] = tb;
  p.st_r[k + 1] = total;
  *p.nstage = k + 1;
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 4)
    roi_patch_kernel(const T* __restrict__ feat,
                     const float* __restrict__ geom, T* __restrict__ out,
                     int H, int W, int C, int rpi, int r0, int E, int band) {
  constexpr int V = Vec<T>::N;
  extern __shared__ __align__(16) unsigned char smem[];
  uint4* stage = reinterpret_cast<uint4*>(smem);
  const Plan p = carve(smem, E);

  const int rl = blockIdx.z;  // roi within the chunk
  const int r = r0 + rl;
  const int b = r / rpi;
  const int ta = blockIdx.y * band;
  const int tb = min(E, ta + band);
  const int c_tile = blockIdx.x * kLanes * V;
  const int lane = threadIdx.x % kLanes;
  const int item = threadIdx.x / kLanes;
  const int c = c_tile + lane * V;  // this thread's first channel
  const float ys = geom[r * 4 + 0];
  const float xs = geom[r * 4 + 1];
  const float sh = geom[r * 4 + 2];
  const float sw = geom[r * 4 + 3];

  for (int i = threadIdx.x; i < E; i += kThreads) {
    const Taps tx = taps(xs, sw, i, W);
    p.x0[i] = tx.i0;
    p.wx0[i] = tx.w0;
    p.wx1[i] = tx.w1;
    const Taps ty = taps(ys, sh, i, H);
    p.y0[i] = ty.w0 == 0.0f && ty.w1 == 0.0f ? -1 : ty.i0;
    p.wy0[i] = ty.w0;
    p.wy1[i] = ty.w1;
  }
  __syncthreads();
  if (threadIdx.x == 0) plan_stages(p, ta, tb);
  __syncthreads();

  const T* fimg = feat + (size_t)b * H * W * C;
  T* oroi = out + (size_t)rl * E * E * C;
  const size_t out_row = (size_t)E * C / V;  // one patch row t, in vectors
  const int nstage = *p.nstage;
  for (int sa = 0; sa < E;) {
    // the column tile: the s whose pairs lie within kCols columns of x0[sa]
    const int xa = p.x0[sa];
    int sb = sa + 1;
    while (sb < E && p.x0[sb] + 2 - xa <= kCols) ++sb;
    const int ns = sb - sa;
    const int ncols = p.x0[sb - 1] + 2 - xa;
    for (int k = 0; k < nstage; ++k) {
      const int t_lo = p.st_t[k];
      const int t_hi = p.st_t[k + 1];
      const int r_lo = p.st_r[k];
      const int nrows = p.st_r[k + 1] - r_lo;
      for (int i = threadIdx.x; i < nrows * ncols * kLanes; i += kThreads) {
        const int l = i % kLanes;
        const int j = i / kLanes;
        const int col = j % ncols;
        const int slot = j / ncols;
        const int cc = c_tile + l * V;
        if (cc < C)
          cp_async16(stage + (slot * kCols + col) * kLanes + l,
                     fimg + ((size_t)p.rowy[r_lo + slot] * W + xa + col) * C +
                         cc);
      }
      cp_async_wait_all();
      __syncthreads();
      if (c < C) {
        // work units of (s, a run of kRun consecutive t): a unit loads its
        // four corners again only where its t moves to another row pair
        const int runs = (t_hi - t_lo + kRun - 1) / kRun;
        for (int u = item; u < ns * runs; u += kItems) {
          const int s = sa + u % ns;
          const int t0 = t_lo + (u / ns) * kRun;
          const int t1 = min(t_hi, t0 + kRun);
          const uint4* q = stage + (p.x0[s] - xa) * kLanes + lane;
          const float wx0 = p.wx0[s], wx1 = p.wx1[s];
          uint4* dst = reinterpret_cast<uint4*>(
              oroi + ((size_t)t0 * E + s) * C + c);
          float a0[V], a1[V], b0[V], b1[V];
          int pair = -1;
          for (int t = t0; t < t1; ++t, dst += out_row) {
            const int slot = p.tslot[t];
            if (slot < 0) {  // the row is off the map
              __stcs(dst, make_uint4(0u, 0u, 0u, 0u));
              continue;
            }
            if (slot != pair) {
              pair = slot;
              const uint4* qs = q + slot * kCols * kLanes;
              Vec<T>::unpack(qs[0], a0);                       // (y0, x0)
              Vec<T>::unpack(qs[kLanes], a1);                  // (y0, x0+1)
              Vec<T>::unpack(qs[kCols * kLanes], b0);          // (y0+1, x0)
              Vec<T>::unpack(qs[kCols * kLanes + kLanes], b1);
            }
            const float wy0 = p.wy0[t], wy1 = p.wy1[t];
            float o[V];
#pragma unroll
            for (int v = 0; v < V; ++v) {
              const float ta_ = __fadd_rn(__fmul_rn(wy0, a0[v]),
                                          __fmul_rn(wy1, b0[v]));
              const float tb_ = __fadd_rn(__fmul_rn(wy0, a1[v]),
                                          __fmul_rn(wy1, b1[v]));
              o[v] = __fadd_rn(__fmul_rn(wx0, ta_), __fmul_rn(wx1, tb_));
            }
            __stcs(dst, Vec<T>::pack(o));
          }
        }
      }
      __syncthreads();
    }
    sa = sb;
  }
}

template <typename T>
int launch(const void* feat, const void* geom, void* out, int H, int W, int C,
           int rpi, int r0, int r1, int E, cudaStream_t st) {
  if (r1 <= r0) return (int)cudaSuccess;
  constexpr int V = Vec<T>::N;
  const size_t smem = smem_bytes(E);
  if (C % V || smem > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
  static bool opted_in[kMaxDevices] = {};
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= kMaxDevices || !opted_in[dev]) {
    err = cudaFuncSetAttribute(roi_patch_kernel<T>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kMaxSmem);
    if (err != cudaSuccess) return (int)err;
    if (dev < kMaxDevices) opted_in[dev] = true;
  }
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  // row bands until the grid holds ~8 blocks per SM, none under 8 rows
  const int tiles = (C + kLanes * V - 1) / (kLanes * V);
  const long blocks = (long)(r1 - r0) * tiles;
  const long want = (8L * sms + blocks - 1) / blocks;
  const int most = (E + 7) / 8;
  const int bands = want < 1 ? 1 : (want > most ? most : (int)want);
  const int band = (E + bands - 1) / bands;
  dim3 grid(tiles, (E + band - 1) / band, r1 - r0);
  roi_patch_kernel<T><<<grid, kThreads, smem, st>>>(
      (const T*)feat, (const float*)geom, (T*)out, H, W, C, rpi, r0, E, band);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Writes rois [r0, r1) into out
// [r1-r0, E, E, C]. C must be a whole number of 16-byte vectors (a multiple
// of 4 in fp32, 8 in bf16) and feat and out 16-byte aligned.
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
