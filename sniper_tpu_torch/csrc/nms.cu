// Greedy NMS for Hopper, batched over images, with the semantics of
// sniper_tpu/ops/nms.py:nms_jax.
//
// Replaces: sniper_tpu/ops/pallas/nms.py:nms_pallas (kernel body
// _nms_kernel) and the nms_jax loop that the proposal op runs
// (sniper_tpu/ops/proposals.py:_proposal_single).
//
// Input: boxes and scores already sorted by descending score, ties in index
// order, entries at or below live_above last, plus the sort permutation or
// NULL for the identity (the proposal op's top-k hands over sorted input, so
// its path sorts nothing here). On such input nms_jax's argmax loop is
// exactly an in-order scan that skips suppressed boxes.
//
// Bound: the O(N^2) IoU tests are spread over the whole card, and the
// greedy scan is serial per image. The work the card must do is ~14 fp32
// ops per (kept box, candidate) pair, a microsecond or two; what the scan
// costs is latency, so its design keeps global loads off its serial chain.
//
// Design.
// - nms_mask_kernel: mask[b][i][w] bit j says sorted box i suppresses box
//   64w+j (j > i). Only the blocks on or above the diagonal are launched:
//   block (g, k), k >= g, takes the 256 rows of row chunk g (a thread per
//   row) against the 256 columns of chunk k, loaded once as 16-byte boxes
//   into shared memory with their areas. It is bound by instruction issue
//   at ~580 G pairs/s on the H100, in the min/max and compares of every
//   pair more than in the division (an exact margin test that skipped
//   almost every division measured only 7-12% faster), so what counts is
//   how many pairs it computes (below). Where the intersection is empty the
//   division is skipped: ovr is then exactly 0 and the test is 0 >= thresh.
//   Rows are padded to a multiple of 8 words (`stride`) so that the scan
//   can load a row's 8 words of a tile as 16-byte vectors.
// - nms_scan_kernel: one block of 256 threads per image walks 512-box tiles.
//   A tile's rows over its own 8 words (the diagonal block, 32 KB) and its
//   scores are loaded into registers one tile ahead and stored to shared
//   memory at the tile's start. Warp 0 then resolves the tile with bit
//   operations only: lane v holds the removed word v of the tile; for each
//   word in order, the live candidates are the word's live bits less its
//   removed bits, and the first live bit is kept, its diagonal word cleared
//   from the candidates and its row's later words ORed into the lanes after
//   it, all from shared memory. The serial chain runs once per KEPT box.
//   The kept rows' words past the tile are then ORed into the removed words
//   by all eight warps (a warp per kept row, lanes over words, coalesced),
//   one round of loads per tile. The scan stops at max_out keeps or after
//   the tile that holds the first score <= live_above.
// - Early stop: on the inference inputs the scan reaches max_out within the
//   first ~1000 boxes, while the whole mask is ~18M pairs per image at
//   N = 6000 and, once the scan was fast, took 80% of the time (the split of
//   scripts/profile_torch_kernel_split.py --nms). So the two kernels go in
//   ranges of row tiles, [0, 1), [1, 4), [4, 16), ...: each range's mask
//   rows, then the scan over its tiles, which saves its state (count, done,
//   removed words) in the scratch after the mask. A later launch of either
//   kernel returns at once for an image whose scan is done, and the mask
//   kernel skips the rows and the columns of the boxes already removed,
//   which are never kept. Where the scan runs deep, as on training's
//   saturated input (~5000 boxes scanned), ~94% of the boxes past the first
//   1024 are removed by then, so the later ranges cost little; the first
//   range is 16% of the pairs at N = 6000.
//
// Exactness: the IoU follows nms_jax's fp32 order,
//   inter / ((area_i + area_j) - inter), +1 widths, IoU 0 where the
//   denominator is <= 0, suppression at IoU >= thresh,
// written with __f*_rn intrinsics so that nvcc cannot contract a
// multiply-add into an FMA and flip a box that sits at the threshold.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef unsigned long long u64;

constexpr int kBoxesPerWord = 64;
constexpr int kMaskTiles = 4;  // 64-box tiles per mask block side
constexpr int kMaskThreads = kMaskTiles * kBoxesPerWord;  // a thread per row
constexpr int kScanWords = 8;  // 64-box words per scan tile
constexpr int kScanBoxes = kScanWords * kBoxesPerWord;
constexpr int kScanThreads = 256;
constexpr int kScanWarps = kScanThreads / 32;
constexpr int kRowsPerThread = kScanBoxes / kScanThreads;
constexpr int kVecsPerThread = kScanBoxes * kScanWords / 2 / kScanThreads;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float box_area(float4 b) {
  return __fmul_rn(__fadd_rn(__fsub_rn(b.z, b.x), 1.0f),
                   __fadd_rn(__fsub_rn(b.w, b.y), 1.0f));
}

// Whether box a suppresses box b: ovr >= thresh, ovr = inter / denom where
// denom > 0, else 0. Where the intersection is empty ovr is 0 (inter is 0,
// or 0 * inf = NaN, whose denominator is NaN), so the division is skipped
// and the answer is empty_hit, 0 >= thresh.
__device__ __forceinline__ bool suppresses(float4 a, float area_a, float4 b,
                                           float area_b, float thresh,
                                           bool empty_hit) {
  const float xx1 = fmaxf(a.x, b.x);
  const float yy1 = fmaxf(a.y, b.y);
  const float xx2 = fminf(a.z, b.z);
  const float yy2 = fminf(a.w, b.w);
  const float w = fmaxf(0.0f, __fadd_rn(__fsub_rn(xx2, xx1), 1.0f));
  const float h = fmaxf(0.0f, __fadd_rn(__fsub_rn(yy2, yy1), 1.0f));
  if (w == 0.0f || h == 0.0f) return empty_hit;
  const float inter = __fmul_rn(w, h);
  const float denom = __fsub_rn(__fadd_rn(area_a, area_b), inter);
  const float ovr = denom > 0.0f ? __fdiv_rn(inter, denom) : 0.0f;
  return ovr >= thresh;
}

// Grid (blocks, B): the blocks (g, k) with k >= g of the row chunks
// g >= g0 of one launch, in row-chunk order. Only the words w >= i/64 of
// row i are written: the scan reads no others. After the first range
// (state given), an image whose scan has finished is skipped, and so are
// the rows and columns of the boxes that earlier keeps removed: such a box
// is never kept, so its row is never read, and its bit in other rows
// changes nothing.
__global__ void __launch_bounds__(kMaskThreads)
nms_mask_kernel(const float4* __restrict__ boxes, int n, int words,
                int stride, int chunks, int g0, float thresh,
                const u64* __restrict__ state, u64* __restrict__ mask) {
  const int b = blockIdx.y;
  const u64* gone = nullptr;  // removed words, where an earlier scan ran
  if (state) {
    const u64* st = state + (size_t)b * (stride + 2);
    if (st[1]) return;
    gone = st + 2;
  }
  int g = g0, k = blockIdx.x;
  while (k >= chunks - g) {
    k -= chunks - g;
    ++g;
  }
  k += g;
  __shared__ float4 cbox[kMaskThreads];
  __shared__ float carea[kMaskThreads];
  const float4* bx = boxes + (size_t)b * n;
  const int col = k * kMaskThreads + threadIdx.x;
  if (col < n) {
    const float4 p = bx[col];
    cbox[threadIdx.x] = p;
    carea[threadIdx.x] = box_area(p);
  }
  __syncthreads();
  const int row = g * kMaskThreads + threadIdx.x;
  if (row >= n) return;
  const int rt = row / kBoxesPerWord;
  if (gone && ((gone[rt] >> (row % kBoxesPerWord)) & 1ULL)) return;
  const float4 rb = bx[row];
  const float ra = box_area(rb);
  const bool empty_hit = 0.0f >= thresh;
  u64* out = mask + ((size_t)b * n + row) * stride;
  const int t_end = min((k + 1) * kMaskTiles, words);
  for (int t = max(k * kMaskTiles, rt); t < t_end; ++t) {
    const float4* cb = cbox + (t - k * kMaskTiles) * kBoxesPerWord;
    const float* ca = carea + (t - k * kMaskTiles) * kBoxesPerWord;
    const int cn = min(n - t * kBoxesPerWord, kBoxesPerWord);
    const int start = t == rt ? row % kBoxesPerWord + 1 : 0;
    u64 bits = 0ULL;
    if (!gone) {
      for (int j = start; j < cn; ++j) {
        if (suppresses(rb, ra, cb[j], ca[j], thresh, empty_hit))
          bits |= 1ULL << j;
      }
    } else {
      // only the columns no keep has removed, few where the scan runs deep
      // (a walk over set bits: a serial chain, 2x slower per pair than the
      // loop above where every column is live)
      u64 cols = ~gone[t];
      if (cn < kBoxesPerWord) cols &= (1ULL << cn) - 1ULL;
      cols &= start < kBoxesPerWord ? ~0ULL << start : 0ULL;
      for (; cols != 0ULL; cols &= cols - 1ULL) {
        const int j = __ffsll((long long)cols) - 1;
        if (suppresses(rb, ra, cb[j], ca[j], thresh, empty_hit))
          bits |= 1ULL << j;
      }
    }
    out[t] = bits;
  }
}

// A tile's rows over the tile's own words as 16-byte vectors (vector v is
// words 2(v%4), 2(v%4)+1 of the tile's row v/4, so a warp's stores to shared
// memory are contiguous), and whether each row is dead (past n, or scored
// at or below live_above): thread tid takes vectors tid + 256 m and rows
// tid + 256 r of the tile.
__device__ __forceinline__ void fetch_tile(
    const u64* __restrict__ mk, const float* __restrict__ sc, int n,
    int stride, int tile, float live_above, ulonglong2 (&vec)[kVecsPerThread],
    bool (&dead)[kRowsPerThread]) {
#pragma unroll
  for (int m = 0; m < kVecsPerThread; ++m) {
    const int v = m * kScanThreads + threadIdx.x;
    const int i = tile * kScanBoxes + v / (kScanWords / 2);
    vec[m] = i < n ? reinterpret_cast<const ulonglong2*>(
                         mk + (size_t)i * stride + tile * kScanWords)
                         [v % (kScanWords / 2)]
                   : make_ulonglong2(0ULL, 0ULL);
  }
#pragma unroll
  for (int r = 0; r < kRowsPerThread; ++r) {
    const int i = tile * kScanBoxes + r * kScanThreads + threadIdx.x;
    dead[r] = i >= n || !(sc[i] > live_above);
  }
}

// One block per image: the greedy scan over the 512-box tiles [t0, t1)
// (source note). state[b] is (count, done, removed words): a launch after
// the first resumes from it and returns at once when done is set; the
// launch that finishes writes keep and valid.
__global__ void __launch_bounds__(kScanThreads)
nms_scan_kernel(const u64* __restrict__ mask, const float* __restrict__ scores,
                const int64_t* __restrict__ order, int n, int words,
                int stride, int max_out, float live_above, int t0, int t1,
                u64* __restrict__ state, int32_t* __restrict__ keep,
                uint8_t* __restrict__ valid) {
  extern __shared__ u64 removed[];  // stride words
  __shared__ __align__(16) u64 diag[kScanBoxes][kScanWords];
  __shared__ int kept_rows[kScanBoxes];
  __shared__ unsigned dead32[kScanBoxes / 32];  // bit: box 32m + lane dead
  __shared__ int s_kept, s_stop, s_count;
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const u64* mk = mask + (size_t)b * n * stride;
  const float* sc = scores + (size_t)b * n;
  int32_t* kp = keep + (size_t)b * max_out;
  uint8_t* vd = valid + (size_t)b * max_out;
  u64* st = state + (size_t)b * (stride + 2);
  if (t0 > 0 && st[1]) return;
  for (int i = tid; i < stride; i += kScanThreads)
    removed[i] = t0 > 0 ? st[2 + i] : 0ULL;

  ulonglong2 vec[kVecsPerThread];
  bool dead[kRowsPerThread];
  fetch_tile(mk, sc, n, stride, t0, live_above, vec, dead);
  const int tiles = (n + kScanBoxes - 1) / kScanBoxes;
  int count = t0 > 0 ? (int)st[0] : 0;  // warp 0's, uniform across its lanes
  if (tid == 0) s_stop = 0;
  for (int t = t0; t < t1; ++t) {
    // the tile's diagonal block and dead bits into shared memory
#pragma unroll
    for (int m = 0; m < kVecsPerThread; ++m)
      reinterpret_cast<ulonglong2*>(diag)[m * kScanThreads + tid] = vec[m];
#pragma unroll
    for (int r = 0; r < kRowsPerThread; ++r) {
      const unsigned bal = __ballot_sync(kFull, dead[r]);
      if (lane == 0) dead32[r * kScanWarps + warp] = bal;
    }
    __syncthreads();  // also publishes the previous tile's removed words
    // the next tile's loads fly while this one resolves
    if (t + 1 < t1)
      fetch_tile(mk, sc, n, stride, t + 1, live_above, vec, dead);

    if (warp == 0) {
      const int base = t * kScanBoxes;
      u64 rem = 0ULL, live = 0ULL;
      if (lane < kScanWords) {
        rem = removed[t * kScanWords + lane];
        live = ~((u64)dead32[2 * lane] | ((u64)dead32[2 * lane + 1] << 32));
      }
      // live is a prefix: cut it at the tile's first dead box, and stop
      // the scan after this tile
      const unsigned cut = __ballot_sync(kFull, lane < kScanWords && ~live);
      int stop = cut != 0 || t + 1 == tiles;
      if (cut) {
        const int w0 = __ffs(cut) - 1;
        if (lane > w0) {
          live = 0ULL;
        } else if (lane == w0) {
          const u64 d = ~live;
          live = (d & (0ULL - d)) - 1ULL;
        }
      }
      int kept = 0;
      for (int w = 0; w < kScanWords && count < max_out; ++w) {
        u64 cand = __shfl_sync(kFull, live & ~rem, w);
        while (cand != 0ULL && count < max_out) {
          const int li = w * kBoxesPerWord + __ffsll((long long)cand) - 1;
          if (lane == 0) {
            kp[count] = base + li;  // a sorted position; mapped at the end
            kept_rows[kept] = base + li;
          }
          ++count;
          ++kept;
          const u64 dw = diag[li][w];
          if (lane > w && lane < kScanWords) rem |= diag[li][lane];
          cand &= ~dw;
          cand &= cand - 1ULL;  // the kept box itself, the lowest bit
        }
      }
      if (lane == 0) {
        s_kept = kept;
        s_stop = stop || count >= max_out;
        s_count = count;
      }
    }
    __syncthreads();
    if (s_stop) break;
    // the kept rows' words past the tile: a warp per kept row, lanes over
    // words
    const int nk = s_kept;
    for (int c = (t + 1) * kScanWords + lane; c < words; c += 32) {
      u64 acc = 0ULL;
#pragma unroll 4
      for (int q = warp; q < nk; q += kScanWarps)
        acc |= mk[(size_t)kept_rows[q] * stride + c];
      if (acc) {
        unsigned* r32 = reinterpret_cast<unsigned*>(removed + c);
        atomicOr(r32, (unsigned)acc);
        atomicOr(r32 + 1, (unsigned)(acc >> 32));
      }
    }
  }
  __syncthreads();
  const int total = s_count;
  if (!s_stop) {  // the mask rows of the next tiles come in the next launch
    for (int i = tid; i < stride; i += kScanThreads) st[2 + i] = removed[i];
    if (tid == 0) {
      st[0] = (u64)total;
      st[1] = 0ULL;
    }
    return;
  }
  if (tid == 0) st[1] = 1ULL;
  for (int k = tid; k < max_out; k += kScanThreads) {
    if (k < total) {
      const int p = kp[k];
      kp[k] = order ? (int32_t)order[(size_t)b * n + p] : p;
      vd[k] = 1;
    } else {
      kp[k] = -1;
      vd[k] = 0;
    }
  }
}

}  // namespace

// order: the sort permutation, or NULL where the input is in its own order.
// scratch: batch * n * stride mask words, stride = ceil(n / 64) rounded up to
// a multiple of 8, then batch * (stride + 2) words of scan state; boxes
// 16-byte aligned. The mask rows and the scan go in ranges of tiles, 1 then
// 4x the tiles before: [0, 1), [1, 4), [4, 16), ...
extern "C" int sniper_nms(const void* boxes_sorted, const void* scores_sorted,
                          const void* order, int batch, int n, int max_out,
                          float thresh, float live_above, void* scratch,
                          void* keep, void* valid, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int words = (n + kBoxesPerWord - 1) / kBoxesPerWord;
  const int stride = (words + kScanWords - 1) / kScanWords * kScanWords;
  const int chunks = (words + kMaskTiles - 1) / kMaskTiles;
  const int tiles = (n + kScanBoxes - 1) / kScanBoxes;
  constexpr int kChunksPerTile = kScanBoxes / kMaskThreads;
  u64* mask = (u64*)scratch;
  u64* state = mask + (size_t)batch * n * stride;
  for (int t0 = 0; t0 < tiles;) {
    const int t1 = min(tiles, t0 == 0 ? 1 : 4 * t0);
    const int g0 = t0 * kChunksPerTile;
    const int g1 = min(t1 * kChunksPerTile, chunks);
    // blocks (g, k >= g) for g in [g0, g1)
    const int blocks = (g1 - g0) * chunks - (g1 * (g1 - 1) - g0 * (g0 - 1)) / 2;
    nms_mask_kernel<<<dim3(blocks, batch), kMaskThreads, 0, st>>>(
        (const float4*)boxes_sorted, n, words, stride, chunks, g0, thresh,
        t0 > 0 ? state : nullptr, mask);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    nms_scan_kernel<<<batch, kScanThreads, stride * sizeof(u64), st>>>(
        mask, (const float*)scores_sorted, (const int64_t*)order, n, words,
        stride, max_out, live_above, t0, t1, state, (int32_t*)keep,
        (uint8_t*)valid);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    t0 = t1;
  }
  return 0;
}

extern "C" const char* sniper_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
