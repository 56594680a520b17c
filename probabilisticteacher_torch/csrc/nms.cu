// Exact greedy NMS over score-sorted boxes, for Hopper (sm_90a): a tiled greedy scan.
//
// Replaces the TPU kernel probabilisticteacher_tpu/ops/nms_pallas.py:54 (`_kernel`,
// launched by `nms`), a sequential scan with one loop iteration per kept box.
// Semantics, which the keep set must reproduce bit for bit:
//   - rows arrive sorted by descending score (stable), as the wrapper leaves them;
//   - a row is kept when no earlier kept row has IoU > t with it (strict >);
//   - IoU is ops/boxes.py::pairwise_iou operation for operation in f32: the
//     max/min overlap, clamp at 0, inter = iw * ih, union = (a_kept + a) - inter,
//     iou = inter > 0 ? inter / (union > 0 ? union : 1) : 0;
//   - invalid rows are never kept and never suppress;
//   - the scan stops once max_keep rows are kept.
// Every IoU operation is an explicitly rounded intrinsic and the file is built
// with -fmad=false: a fused multiply-add in the union would move IoUs that sit
// next to the threshold and change keep sets.
//
// Design: one block of 1024 threads per image, one launch for the batch. The
// sorted rows go in tiles of 64. Shared memory holds the suppression bits (one
// bit per row, 2 KB at 16000 rows; invalid rows and the padding past k start
// set), the tile's boxes and areas, its 64 intra-tile bit rows, and the rows it
// kept with their coordinates. The coordinates of all rows stay in global memory
// (16000 x 20 B = 320 KB would not fit), where L1 and L2 hold them. Per tile:
//   1. every warp loads the tile's 64 rows (two per lane) and takes two of its
//      rows i, passed to the lanes by shuffles: bit j of later[i] is set when
//      j > i and i suppresses j; only rows still open (valid, unsuppressed) count.
//      Barrier.
//   2. thread 0 walks the tile's open rows in order in a register: the lowest
//      open row is kept, appended to the kept list and written to `keep`, and the
//      rows it suppresses leave the open set; it stops at max_keep. Barrier.
//   3. warps take the 32-row words after the tile, one warp per word (so the
//      ballot is ORed in without atomics); each lane loads an open row once and
//      tests it against the tile's kept rows in order, from shared memory,
//      stopping at the first hit. Barrier.
// A tile with no open row costs no barrier; the scan ends at max_keep.
//
// Why it is exact: a row is kept iff it is valid and no earlier kept row has
// IoU > t with it. Step 3 applies every kept row of earlier tiles to it, and
// since suppression is an OR the order of those tests does not change its bit;
// step 2 applies the earlier kept rows of its own tile, in row order.
//
// What bounds it: one SM per image. Barriers and global box loads come to ~3
// per 64-row tile instead of ~2 per kept row (the earlier design, one block-wide
// pass per kept row); the serial part is the walk of step 2, a few shared-memory
// loads per kept row. The IoUs are those the greedy scan needs, about
// kept x later open rows, each ~13 f32 operations and a correctly rounded
// division, on the 128 f32 lanes of the image's one SM: the operation bound
// counts all 132 SMs, and 8, 16 or 48 images use that many. On the H100 an image
// of 12000 rows keeping 2000 (~20.5 M IoUs) takes ~3.0 ms: 33-37 lane-cycles per
// IoU at 1.76-1.98 GHz, about what step 3's loop issues per IoU (22 SASS
// instructions when the boxes do not overlap, 40 when they do, 8 of those the
// division). Spreading an image over a thread-block cluster is the next step.
// ptxas (sm_90a, -O3 -fmad=false): 32 registers, 3088 B of static shared memory
// plus 8 B per 64 rows (1.5 KB at 12000 rows), no spills.
//
// Counting (a non-null `ious`, the instantiation nms_keep_kernel<true>): the kernel
// adds into *ious the IoUs the greedy scan needs, not those it evaluates: each
// valid row up to the row where the scan ends (the max_keep-th kept row, or the
// last row) against every kept row ahead of it, up to and including the first that
// suppresses it. Step 2 counts its tile's own pairs as it walks (each kept row
// against the tile's rows still open after it); step 3 adds each lane's number of
// tests to its row's entry of a per-row table in shared memory (4 B a row), since
// whether a row lies past the scan's end is known only when the scan ends. At the
// end the block sums the table up to that row, in one atomic add. The keep
// decisions are the same code in both instantiations. Counting costs 2.6-2.8% of
// the kernel's time on the RPN's scans and 4.5-4.8% on the class-aware ones (H100),
// so the program counts the scans of a traced step again after the work it times
// (ops/nms_cuda.py count_ious) and never in it.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kTile = 64;
constexpr uint32_t kAll = 0xffffffffu;

__device__ __forceinline__ bool suppresses(const float4 a, const float aa, const float4 b,
                                           const float ab, const float t) {
  const float iw = __fsub_rn(fminf(a.z, b.z), fmaxf(a.x, b.x));
  const float ih = __fsub_rn(fminf(a.w, b.w), fmaxf(a.y, b.y));
  const float inter = __fmul_rn(fmaxf(iw, 0.0f), fmaxf(ih, 0.0f));
  const float uni = __fsub_rn(__fadd_rn(aa, ab), inter);
  const float iou = inter > 0.0f ? __fdiv_rn(inter, uni > 0.0f ? uni : 1.0f) : 0.0f;
  return iou > t;
}

// The IoUs of a tile's walk (step 2) when the scan ends at its row `last`: each kept
// row before `last` against the rows still open after it, up to `last` itself.
__device__ unsigned long long capped_walk(unsigned long long rest,
                                          const unsigned long long* later, const int last) {
  rest &= (2ull << last) - 1;
  unsigned long long n = 0;
  while (rest != 0) {
    const int r = __ffsll((long long)rest) - 1;
    if (r == last) break;
    n += __popcll(rest & ~((2ull << r) - 1));
    rest &= ~later[r] & (rest - 1);
  }
  return n;
}

__device__ __forceinline__ float4 shfl4(const float4 v, const int src) {
  return make_float4(__shfl_sync(kAll, v.x, src), __shfl_sync(kAll, v.y, src),
                     __shfl_sync(kAll, v.z, src), __shfl_sync(kAll, v.w, src));
}

template <bool kCount>
__global__ void __launch_bounds__(kThreads)
nms_keep_kernel(const float4* __restrict__ boxes, const float* __restrict__ area,
                const uint8_t* __restrict__ valid, uint8_t* __restrict__ keep, int k,
                float t, int max_keep, unsigned long long* __restrict__ ious) {
  extern __shared__ uint32_t supp[];  // bit i of word i/32: row i is suppressed
  __shared__ float4 tile_box[kTile];
  __shared__ float tile_area[kTile];
  __shared__ unsigned long long later[kTile];  // bit j of row i: i suppresses j > i
  __shared__ float4 kept_box[kTile];
  __shared__ float kept_area[kTile];
  __shared__ int tile_kept;
  __shared__ int done;
  __shared__ int end_row;                   // counting: the row where the scan ends
  __shared__ unsigned long long block_ious;  // counting: the block's sum
  const size_t base = (size_t)blockIdx.x * k;
  boxes += base;
  area += base;
  valid += base;
  keep += base;
  const int ntiles = (k + kTile - 1) / kTile;
  const int nwords = ntiles * 2;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  uint32_t* tested = supp + nwords;  // counting: per row, its tests in step 3

  // invalid rows and the padding bits past k start suppressed
  for (int wi = warp; wi < nwords; wi += nwarps) {
    const int i = (wi << 5) + lane;
    const uint32_t bits = __ballot_sync(kAll, i >= k || !valid[i]);
    if (lane == 0) supp[wi] = bits;
  }
  for (int i = threadIdx.x; i < k; i += blockDim.x) {
    keep[i] = 0;
    if (kCount) tested[i] = 0;
  }
  if (kCount && threadIdx.x == 0) {
    end_row = k - 1;
    block_ious = 0;
  }
  __syncthreads();

  int total = 0;  // rows kept so far; only thread 0's copy is used
  unsigned long long walked = 0;  // counting: IoUs of the tiles' walks (thread 0)
  for (int tile = 0; tile < ntiles; ++tile) {
    const int row0 = tile * kTile;
    // every thread reads the same words: the last writes were before a barrier
    const unsigned long long open =
        ~((unsigned long long)supp[2 * tile] | ((unsigned long long)supp[2 * tile + 1] << 32));
    if (open == 0) continue;

    // 1. the tile's intra-tile bits
    const bool open_lo = (open >> lane) & 1ull;
    const bool open_hi = (open >> (lane + 32)) & 1ull;
    float4 b_lo = make_float4(0.0f, 0.0f, 0.0f, 0.0f), b_hi = b_lo;
    float a_lo = 0.0f, a_hi = 0.0f;
    if (open_lo) {
      b_lo = boxes[row0 + lane];
      a_lo = area[row0 + lane];
    }
    if (open_hi) {
      b_hi = boxes[row0 + 32 + lane];
      a_hi = area[row0 + 32 + lane];
    }
    if (warp == 0) {
      tile_box[lane] = b_lo;
      tile_area[lane] = a_lo;
      tile_box[lane + 32] = b_hi;
      tile_area[lane + 32] = a_hi;
    }
    for (int r = warp; r < kTile; r += nwarps) {
      if (!((open >> r) & 1ull)) continue;  // uniform across the warp
      const bool upper = r >= 32;
      const float4 bi = shfl4(upper ? b_hi : b_lo, r & 31);
      const float ai = __shfl_sync(kAll, upper ? a_hi : a_lo, r & 31);
      const bool s_lo = open_lo && lane > r && suppresses(bi, ai, b_lo, a_lo, t);
      const bool s_hi = open_hi && lane + 32 > r && suppresses(bi, ai, b_hi, a_hi, t);
      const uint32_t lo = __ballot_sync(kAll, s_lo);
      const uint32_t hi = __ballot_sync(kAll, s_hi);
      if (lane == 0) later[r] = (unsigned long long)lo | ((unsigned long long)hi << 32);
    }
    __syncthreads();

    // 2. resolve the tile in row order
    if (threadIdx.x == 0) {
      unsigned long long rest = open;
      int nk = 0;
      const unsigned long long tile_walk = walked;
      while (rest != 0) {
        const int r = __ffsll((long long)rest) - 1;
        kept_box[nk] = tile_box[r];
        kept_area[nk] = tile_area[r];
        ++nk;
        keep[row0 + r] = 1;
        if (kCount) walked += __popcll(rest & ~((2ull << r) - 1));
        rest &= ~later[r] & (rest - 1);  // drop row r and the rows it suppresses
        if (++total >= max_keep) {
          if (kCount) {  // the scan ends at row r: replace the tile's part of the count
            walked = tile_walk + capped_walk(open, later, r);
            end_row = row0 + r;
          }
          break;
        }
      }
      tile_kept = nk;
      done = total >= max_keep;
    }
    __syncthreads();
    if (done) break;

    // 3. the tile's kept rows suppress later rows
    const int nk = tile_kept;
    for (int wi = 2 * (tile + 1) + warp; wi < nwords; wi += nwarps) {
      const uint32_t word = supp[wi];
      if (word == kAll) continue;  // uniform across the warp
      bool s = false;
      if (!((word >> lane) & 1u)) {
        const int i = (wi << 5) + lane;
        const float4 b = boxes[i];
        const float a = area[i];
        int q = 0;
        for (; q < nk && !s; ++q) s = suppresses(kept_box[q], kept_area[q], b, a, t);
        if (kCount) tested[i] += q;
      }
      const uint32_t ballot = __ballot_sync(kAll, s);
      if (lane == 0 && ballot != 0) supp[wi] = word | ballot;
    }
    __syncthreads();
  }

  if (kCount) {  // the last barrier above ordered every write of `tested` and `end_row`
    unsigned long long mine = threadIdx.x == 0 ? walked : 0;
    for (int i = threadIdx.x; i <= end_row; i += blockDim.x) mine += tested[i];
    for (int off = 16; off > 0; off >>= 1) mine += __shfl_down_sync(kAll, mine, off);
    if (lane == 0 && mine != 0) atomicAdd(&block_ious, mine);
    __syncthreads();
    if (threadIdx.x == 0 && block_ious != 0) atomicAdd(ious, block_ious);
  }
}

template <bool kCount>
int launch(const void* boxes, const void* area, const void* valid, void* keep, int n, int k,
           float thresh, int max_keep, cudaStream_t stream, void* ious) {
  const size_t words = (size_t)((k + kTile - 1) / kTile) * 2;
  const size_t smem = words * sizeof(uint32_t) + (kCount ? (size_t)k * sizeof(uint32_t) : 0);
  if (smem > 40 * 1024) {  // 48 KB less the static arrays
    const cudaError_t e = cudaFuncSetAttribute(
        nms_keep_kernel<kCount>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  nms_keep_kernel<kCount><<<n, kThreads, smem, stream>>>(
      (const float4*)boxes, (const float*)area, (const uint8_t*)valid, (uint8_t*)keep, k,
      thresh, max_keep, (unsigned long long*)ious);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

const char* pt_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

// boxes (N, K, 4) f32 sorted by descending score; area (N, K) f32 of those boxes;
// valid (N, K) uint8; keep (N, K) uint8 out, 1 where the row is kept. One block per
// image on `stream`. `ious`: null, or an int64 on the device that gains the IoUs the
// scan needs. Returns cudaGetLastError() after the launch.
int pt_nms_keep(const void* boxes, const void* area, const void* valid, void* keep, int n,
                int k, float thresh, int max_keep, void* stream, void* ious) {
  if (ious == nullptr)
    return launch<false>(boxes, area, valid, keep, n, k, thresh, max_keep,
                         (cudaStream_t)stream, nullptr);
  return launch<true>(boxes, area, valid, keep, n, k, thresh, max_keep, (cudaStream_t)stream,
                      ious);
}

}  // extern "C"
