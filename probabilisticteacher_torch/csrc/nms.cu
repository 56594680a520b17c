// Exact greedy NMS over score-sorted boxes, for Hopper (sm_90a).
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
// Design: one block per image, so one launch covers the batch. Only the
// suppression bits live in shared memory (one bit per row: 16000 rows = 2 KB);
// the coordinates stay in global memory, where L1/L2 hold them (16000 rows x 5
// f32 = 320 KB would not fit 227 KB of shared memory). Each iteration,
//   1. warp 0 finds the first unsuppressed row at or after the frontier with
//      __ballot_sync/__ffs over the bit words, 32 words (1024 rows) per step;
//   2. every warp takes 32 later rows at a time, compares those not yet
//      suppressed with the kept row, and ORs the ballot of `iou > t` into the
//      row word it owns (no atomics: one warp per word per iteration).
//
// What bounds it: operations, and latency. The work is one IoU (~13 f32
// operations) per (kept row, later row) pair, and each kept row costs two block
// barriers; with only N blocks the card is mostly idle at this batch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;

__device__ __forceinline__ bool suppresses(const float4 a, const float aa, const float4 b,
                                           const float ab, const float t) {
  const float iw = __fsub_rn(fminf(a.z, b.z), fmaxf(a.x, b.x));
  const float ih = __fsub_rn(fminf(a.w, b.w), fmaxf(a.y, b.y));
  const float inter = __fmul_rn(fmaxf(iw, 0.0f), fmaxf(ih, 0.0f));
  const float uni = __fsub_rn(__fadd_rn(aa, ab), inter);
  const float iou = inter > 0.0f ? __fdiv_rn(inter, uni > 0.0f ? uni : 1.0f) : 0.0f;
  return iou > t;
}

__global__ void __launch_bounds__(kThreads)
nms_keep_kernel(const float4* __restrict__ boxes, const float* __restrict__ area,
                const uint8_t* __restrict__ valid, uint8_t* __restrict__ keep, int k,
                float t, int max_keep) {
  extern __shared__ uint32_t supp[];  // bit i of word i/32: row i is suppressed
  __shared__ int next_row;
  const size_t base = (size_t)blockIdx.x * k;
  boxes += base;
  area += base;
  valid += base;
  keep += base;
  const int nwords = (k + 31) >> 5;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;

  // invalid rows (and the padding bits past k) start suppressed
  for (int wi = threadIdx.x; wi < nwords; wi += blockDim.x) {
    uint32_t bits = 0;
    for (int b = 0; b < 32; ++b) {
      const int i = (wi << 5) + b;
      if (i >= k || !valid[i]) bits |= 1u << b;
    }
    supp[wi] = bits;
  }
  for (int i = threadIdx.x; i < k; i += blockDim.x) keep[i] = 0;
  __syncthreads();

  int frontier = 0;  // every thread holds the same frontier and count
  int kept = 0;
  while (frontier < k && kept < max_keep) {
    if (warp == 0) {
      int found = k;
      const int w0 = frontier >> 5;
      for (int wb = w0; wb < nwords; wb += 32) {
        const int wi = wb + lane;
        uint32_t open = 0;
        if (wi < nwords) {
          open = ~supp[wi];
          if (wi == w0) open &= ~0u << (frontier & 31);
        }
        const uint32_t ballot = __ballot_sync(0xffffffffu, open != 0);
        if (ballot != 0) {
          const int src = __ffs(ballot) - 1;
          const uint32_t bits = __shfl_sync(0xffffffffu, open, src);
          found = ((wb + src) << 5) + __ffs(bits) - 1;
          break;
        }
      }
      if (lane == 0) next_row = found;
    }
    __syncthreads();
    const int j = next_row;
    if (j >= k) break;
    if (threadIdx.x == 0) keep[j] = 1;
    if (++kept >= max_keep) break;

    const float4 bj = boxes[j];
    const float aj = area[j];
    for (int wi = ((j + 1) >> 5) + warp; wi < nwords; wi += nwarps) {
      const int i = (wi << 5) + lane;
      const uint32_t word = supp[wi];
      bool s = false;
      if (i > j && i < k && !((word >> lane) & 1u)) s = suppresses(bj, aj, boxes[i], area[i], t);
      const uint32_t ballot = __ballot_sync(0xffffffffu, s);
      if (lane == 0 && ballot != 0) supp[wi] = word | ballot;
    }
    frontier = j + 1;
    __syncthreads();
  }
}

}  // namespace

extern "C" {

const char* pt_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

// boxes (N, K, 4) f32 sorted by descending score; area (N, K) f32 of those boxes;
// valid (N, K) uint8; keep (N, K) uint8 out, 1 where the row is kept. One block per
// image on `stream`. Returns cudaGetLastError() after the launch.
int pt_nms_keep(const void* boxes, const void* area, const void* valid, void* keep, int n,
                int k, float thresh, int max_keep, void* stream) {
  const size_t smem = (size_t)((k + 31) / 32) * sizeof(uint32_t);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        nms_keep_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  nms_keep_kernel<<<n, kThreads, smem, (cudaStream_t)stream>>>(
      (const float4*)boxes, (const float*)area, (const uint8_t*)valid, (uint8_t*)keep, k,
      thresh, max_keep);
  return (int)cudaGetLastError();
}

}  // extern "C"
