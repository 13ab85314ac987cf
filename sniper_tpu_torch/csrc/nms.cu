// Greedy NMS for Hopper, batched over images, with the semantics of
// sniper_tpu/ops/nms.py:nms_jax.
//
// Replaces: sniper_tpu/ops/pallas/nms.py:nms_pallas (kernel body
// _nms_kernel) and the nms_jax loop that the proposal op runs
// (sniper_tpu/ops/proposals.py:_proposal_single).
//
// Input: boxes and scores already sorted by descending score, stable (ties
// keep the lower original index first), plus the sort permutation. The
// Python wrapper sorts; on such input nms_jax's argmax loop is exactly an
// in-order scan that skips suppressed boxes.
//
// Bound: the TPU kernel ran max_out serial argmax/suppress rounds over all
// N boxes. Here the O(N^2) IoU work is spread over the whole card (one
// bitmask word per box and 64-box column block), and only the cheap scan is
// serial: one warp per image, the removed set in shared memory, and one
// bitmask row of global reads per KEPT box (at most max_out of them). The
// scan stops at the first score <= NEG_INF/2 or at max_out keeps.
//
// Exactness: the IoU follows nms_jax's fp32 order,
//   inter / ((area_i + area_j) - inter), +1 widths, IoU 0 where the
//   denominator is <= 0, suppression at IoU >= thresh,
// written with __f*_rn intrinsics so that nvcc cannot contract a
// multiply-add into an FMA and flip a box that sits at the threshold.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBoxesPerWord = 64;

__device__ __forceinline__ float box_area(const float* b) {
  return __fmul_rn(__fadd_rn(__fsub_rn(b[2], b[0]), 1.0f),
                   __fadd_rn(__fsub_rn(b[3], b[1]), 1.0f));
}

__device__ __forceinline__ bool suppresses(const float* a, float area_a,
                                           const float* b, float area_b,
                                           float thresh) {
  const float xx1 = fmaxf(a[0], b[0]);
  const float yy1 = fmaxf(a[1], b[1]);
  const float xx2 = fminf(a[2], b[2]);
  const float yy2 = fminf(a[3], b[3]);
  const float w = fmaxf(0.0f, __fadd_rn(__fsub_rn(xx2, xx1), 1.0f));
  const float h = fmaxf(0.0f, __fadd_rn(__fsub_rn(yy2, yy1), 1.0f));
  const float inter = __fmul_rn(w, h);
  const float denom = __fsub_rn(__fadd_rn(area_a, area_b), inter);
  const float ovr = denom > 0.0f ? __fdiv_rn(inter, denom) : 0.0f;
  return ovr >= thresh;
}

// mask[b][i][cb] bit j: sorted box i suppresses sorted box cb*64+j (j > i).
// Grid (col_blocks, col_blocks, B), 64 threads: thread = row box. Only the
// words with cb >= i/64 are written: the scan reads no others.
__global__ void nms_mask_kernel(const float* __restrict__ boxes, int n,
                                int col_blocks, float thresh,
                                unsigned long long* __restrict__ mask) {
  const int b = blockIdx.z;
  const int row_block = blockIdx.y;
  const int col_block = blockIdx.x;
  const int row = row_block * kBoxesPerWord + threadIdx.x;
  if (col_block < row_block) return;  // no pair with j > i below the diagonal
  unsigned long long* mk = mask + (size_t)b * n * col_blocks;
  __shared__ float cbox[kBoxesPerWord][4];
  __shared__ float carea[kBoxesPerWord];
  const float* bx = boxes + (size_t)b * n * 4;
  const int col_n = min(n - col_block * kBoxesPerWord, kBoxesPerWord);
  if ((int)threadIdx.x < col_n) {
    const float* p = bx + (size_t)(col_block * kBoxesPerWord + threadIdx.x) * 4;
    cbox[threadIdx.x][0] = p[0];
    cbox[threadIdx.x][1] = p[1];
    cbox[threadIdx.x][2] = p[2];
    cbox[threadIdx.x][3] = p[3];
    carea[threadIdx.x] = box_area(p);
  }
  __syncthreads();
  if (row >= n) return;
  float rb[4];
  rb[0] = bx[(size_t)row * 4 + 0];
  rb[1] = bx[(size_t)row * 4 + 1];
  rb[2] = bx[(size_t)row * 4 + 2];
  rb[3] = bx[(size_t)row * 4 + 3];
  const float ra = box_area(rb);
  unsigned long long bits = 0ULL;
  const int start = row_block == col_block ? (int)threadIdx.x + 1 : 0;
  for (int j = start; j < col_n; ++j) {
    if (suppresses(rb, ra, cbox[j], carea[j], thresh)) bits |= 1ULL << j;
  }
  mk[(size_t)row * col_blocks + col_block] = bits;
}

// One warp per image: scan the sorted boxes, keep the unsuppressed ones.
__global__ void nms_scan_kernel(const unsigned long long* __restrict__ mask,
                                const float* __restrict__ scores,
                                const int64_t* __restrict__ order, int n,
                                int col_blocks, int max_out, float live_above,
                                int32_t* __restrict__ keep,
                                uint8_t* __restrict__ valid) {
  extern __shared__ unsigned long long removed[];
  const int b = blockIdx.x;
  const int lane = threadIdx.x;
  for (int k = lane; k < col_blocks; k += 32) removed[k] = 0ULL;
  __syncwarp();
  const unsigned long long* mk = mask + (size_t)b * n * col_blocks;
  const float* sc = scores + (size_t)b * n;
  const int64_t* ord = order + (size_t)b * n;
  int32_t* kp = keep + (size_t)b * max_out;
  uint8_t* vd = valid + (size_t)b * max_out;
  int count = 0;
  for (int i = 0; i < n && count < max_out; ++i) {
    if (!(sc[i] > live_above)) break;  // sorted: the rest are invalid too
    const int w = i / kBoxesPerWord;
    if ((removed[w] >> (i % kBoxesPerWord)) & 1ULL) continue;
    if (lane == 0) {
      kp[count] = (int32_t)ord[i];
      vd[count] = 1;
    }
    ++count;
    const unsigned long long* row = mk + (size_t)i * col_blocks;
    // words k < w lie below the diagonal: unwritten, and never needed
    for (int k = w + lane; k < col_blocks; k += 32) removed[k] |= row[k];
    __syncwarp();
  }
  for (int k = count + lane; k < max_out; k += 32) {
    kp[k] = -1;
    vd[k] = 0;
  }
}

}  // namespace

extern "C" int sniper_nms(const void* boxes_sorted, const void* scores_sorted,
                          const void* order, int batch, int n, int max_out,
                          float thresh, float live_above, void* mask,
                          void* keep, void* valid, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int col_blocks = (n + kBoxesPerWord - 1) / kBoxesPerWord;
  dim3 grid(col_blocks, col_blocks, batch);
  nms_mask_kernel<<<grid, kBoxesPerWord, 0, st>>>(
      (const float*)boxes_sorted, n, col_blocks, thresh,
      (unsigned long long*)mask);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  nms_scan_kernel<<<batch, 32, col_blocks * sizeof(unsigned long long), st>>>(
      (const unsigned long long*)mask, (const float*)scores_sorted,
      (const int64_t*)order, n, col_blocks, max_out, live_above,
      (int32_t*)keep, (uint8_t*)valid);
  return (int)cudaGetLastError();
}

extern "C" const char* sniper_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
