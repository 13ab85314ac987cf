// The trunk's unit epilogue for Hopper: a frozen BatchNorm, the ReLU and
// the residual sum between two convs of a unit, in one pass, at inference.
//
// Replaces: no Pallas kernel. The JAX trunk writes these as elementwise
// expressions that XLA fuses on the TPU (sniper_tpu/models/resnet.py:84-106,
// the pre-activation unit; sniper_tpu/models/resnext.py:56,142-154, the
// post-activation unit and its stem). Eager PyTorch runs each as its own
// pass over device memory: nine launches a ResNeXt unit (two BatchNorms
// and ReLUs, the third BatchNorm, the shortcut's fp32 copy, the mixed add,
// the fp32 ReLU, the cast), seven a pre-activation unit.
//
// What it computes, with affine(v) = w * (v - mean) * invstd + bias in fp32
// (a FrozenBatchNorm from its running statistics; invstd = rsqrtf(var +
// eps)), rounded to bfloat16 at the points where the unfused
// chain rounds (relu commutes with the rounding):
//   form 1  act = bf16(relu(affine(bf16(a))))          a bf16, or fp32 (the
//           stem's conv output, rounded to bf16 first)
//   form 2  x = bf16(h + sc); act = bf16(relu(affine(x)))   a pre-activation
//           unit's residual sum fused with the next unit's bn1; x is
//           written only where the next unit's shortcut reads it
//   form 3  out = bf16(relu(bf16(affine(h)) + s))   a ResNeXt unit's tail:
//           s = the bf16 input x (identity), or bf16(affine_sc(sc)) (the
//           projection's BatchNorm); the sum in fp32, rounded once
//
// Bound: bytes. Each element is read once from each input and written once
// to each output; the per-channel statistics are a few KB. The least time is
// the bytes over 3.35 TB/s.
//
// Design: tensors are channels_last, so memory is [N*H*W, C] with channels
// innermost. A thread moves 16 bytes (8 bf16 channels) per input and output
// at a time, in a grid-stride loop whose stride is a whole number of rows of
// C channels: each thread then sees one 8-channel group for its whole life,
// and computes that group's invstd and holds its mean, weight, bias in
// registers once, before the loop. No extra launch precomputes a scale, and
// nothing is cached across calls that a weight load could leave stale. Each
// iteration starts kUnroll independent vector loads per input before it
// computes, so enough bytes are in flight with the occupancy the parameter
// registers leave. Inputs are read with evict-first loads (their last use)
// and outputs leave by streaming stores (st.global.cs). No shared memory.
// The arithmetic is spelled with __f*_rn intrinsics so that only the one
// fused multiply-add of torch's channels-last BatchNorm kernel is fused.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 8;
constexpr int kUnroll = 2;
constexpr int kMaxDevices = 16;

struct Bn {
  const float* mean;
  const float* var;
  const float* weight;
  const float* bias;
  float eps;
};

struct Args {
  const void* a;
  const void* b;
  void* out;
  void* out2;
  Bn bn1;
  Bn bn2;
  long long n;  // 16-byte vectors of 8 channels
  int cv;       // vectors in a row of C channels
};

// one 8-channel group of a FrozenBatchNorm
struct Affine {
  float m[8], w[8], inv[8], b[8];

  __device__ __forceinline__ void load(const Bn& bn, int c) {
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      m[k] = __ldg(bn.mean + c + k);
      w[k] = __ldg(bn.weight + c + k);
      b[k] = __ldg(bn.bias + c + k);
      inv[k] = rsqrtf(__fadd_rn(__ldg(bn.var + c + k), bn.eps));
    }
  }

  __device__ __forceinline__ float operator()(int k, float v) const {
    return __fmaf_rn(__fmul_rn(w[k], __fsub_rn(v, m[k])), inv[k], b[k]);
  }
};

__device__ __forceinline__ float relu(float v) { return v < 0.f ? 0.f : v; }

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ void unpack(uint4 u, float* f) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

__device__ __forceinline__ uint4 pack(const float* f) {
  return make_uint4(pack2(f[0], f[1]), pack2(f[2], f[3]), pack2(f[4], f[5]),
                    pack2(f[6], f[7]));
}

// 8 values of vector v of a bf16 input, or of an fp32 one rounded to bf16
template <bool kF32>
struct Load;

template <>
struct Load<false> {
  uint4 r;
  __device__ __forceinline__ void fetch(const void* p, long long v) {
    r = __ldcs(reinterpret_cast<const uint4*>(p) + v);
  }
  __device__ __forceinline__ void get(float* f) const { unpack(r, f); }
};

template <>
struct Load<true> {
  float4 r0, r1;
  __device__ __forceinline__ void fetch(const void* p, long long v) {
    const float4* q = reinterpret_cast<const float4*>(p) + 2 * v;
    r0 = __ldcs(q);
    r1 = __ldcs(q + 1);
  }
  __device__ __forceinline__ void get(float* f) const {
    const float g[8] = {r0.x, r0.y, r0.z, r0.w, r1.x, r1.y, r1.z, r1.w};
#pragma unroll
    for (int k = 0; k < 8; ++k) f[k] = round_bf16(g[k]);
  }
};

// kForm 1: kF32 = a is fp32. kForm 2: kFlag = write x. kForm 3: kFlag = the
// shortcut has its own BatchNorm (bn2).
template <int kForm, bool kF32, bool kFlag>
__global__ void __launch_bounds__(kThreads)
    bn_unit_epilogue_kernel(Args p) {
  const long long stride = (long long)gridDim.x * kThreads;
  long long v = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (v >= p.n) return;
  // stride % cv == 0 (the launch sees to it): one channel group per thread
  const int c = (int)(v % p.cv) * 8;
  Affine f1, f2;
  f1.load(p.bn1, c);
  if (kForm == 3 && kFlag) f2.load(p.bn2, c);
  uint4* out = reinterpret_cast<uint4*>(p.out);
  uint4* out2 = reinterpret_cast<uint4*>(p.out2);
  for (; v < p.n; v += kUnroll * stride) {
    Load<kF32> la[kUnroll];
    Load<false> lb[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long vu = v + u * stride;
      if (vu < p.n) {
        la[u].fetch(p.a, vu);
        if (kForm != 1) lb[u].fetch(p.b, vu);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long vu = v + u * stride;
      if (vu >= p.n) break;
      float x[8], y[8];
      la[u].get(x);
      if (kForm == 1) {
#pragma unroll
        for (int k = 0; k < 8; ++k) y[k] = relu(f1(k, x[k]));
        __stcs(out + vu, pack(y));
      } else if (kForm == 2) {
        float s[8];
        lb[u].get(s);
#pragma unroll
        for (int k = 0; k < 8; ++k) s[k] = round_bf16(__fadd_rn(x[k], s[k]));
        if (kFlag) __stcs(out + vu, pack(s));
#pragma unroll
        for (int k = 0; k < 8; ++k) y[k] = relu(f1(k, s[k]));
        __stcs(out2 + vu, pack(y));
      } else {
        float s[8];
        lb[u].get(s);
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          const float sc = kFlag ? round_bf16(f2(k, s[k])) : s[k];
          y[k] = relu(__fadd_rn(round_bf16(f1(k, x[k])), sc));
        }
        __stcs(out + vu, pack(y));
      }
    }
  }
}

int gcd(int a, int b) {
  while (b) {
    const int t = a % b;
    a = b;
    b = t;
  }
  return a;
}

template <int kForm, bool kF32, bool kFlag>
int launch(const Args& p, cudaStream_t st) {
  static int sms[kMaxDevices] = {};
  int dev = 0, count = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < kMaxDevices && sms[dev]) {
    count = sms[dev];
  } else {
    err = cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return (int)err;
    if (dev < kMaxDevices) sms[dev] = count;
  }
  long long blocks = (p.n + kThreads - 1) / kThreads;
  if (blocks > (long long)count * kBlocksPerSm)
    blocks = (long long)count * kBlocksPerSm;
  // the grid's threads a whole number of rows, so a thread keeps its group
  const int q = p.cv / gcd(p.cv, kThreads);
  blocks = (blocks + q - 1) / q * q;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  bn_unit_epilogue_kernel<kForm, kF32, kFlag>
      <<<(unsigned)blocks, kThreads, 0, st>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

// form 1: act = out from a (a_f32: fp32, else bf16) and bn1.
// form 2: from a = h and b = sc, x = out (null: not written) and act = out2
//         with bn1.
// form 3: out from a = h with bn1 (the unit's bn3) and b = s, through bn2
//         (the shortcut's BatchNorm) unless bn2's mean is null.
// Every tensor is channels_last with C channels, C a multiple of 8, 16-byte
// aligned; n is the number of 8-channel vectors (elements / 8). The
// statistics and affine parameters are fp32 vectors of C.
extern "C" int sniper_unit_epilogue(
    int form, const void* a, int a_f32, const void* b, void* out, void* out2,
    const void* mean1, const void* var1, const void* w1, const void* b1,
    float eps1, const void* mean2, const void* var2, const void* w2,
    const void* b2, float eps2, long long n, int C, void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  if (C <= 0 || C % 8 || n % (C / 8)) return (int)cudaErrorInvalidValue;
  Args p{a, b, out, out2,
         Bn{(const float*)mean1, (const float*)var1, (const float*)w1,
            (const float*)b1, eps1},
         Bn{(const float*)mean2, (const float*)var2, (const float*)w2,
            (const float*)b2, eps2},
         n, C / 8};
  cudaStream_t st = (cudaStream_t)stream;
  switch (form) {
    case 1:
      return a_f32 ? launch<1, true, false>(p, st)
                   : launch<1, false, false>(p, st);
    case 2:
      return out ? launch<2, false, true>(p, st)
                 : launch<2, false, false>(p, st);
    case 3:
      return mean2 ? launch<3, false, true>(p, st)
                   : launch<3, false, false>(p, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
