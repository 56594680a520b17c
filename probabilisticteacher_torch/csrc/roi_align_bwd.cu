// ROIAlign backward, d features (aligned=True, fixed s x s sampling), for Hopper
// (sm_90a).
//
// Replaces the TPU kernel probabilisticteacher_tpu/ops/roi_align_pallas.py:228
// (`_bwd_kernel`, launched by `_bwd_pallas`), and computes the same function as
// the einsum VJP `_bwd_einsum` (roi_align_pallas.py:168-184):
//   dF[n,h,w,c] = sum_r sum_q sum_x Wy[n,r,q,h] g[n,r,q,x,c] Wx[n,r,x,w].
// Boxes get no gradient. Wy and Wx are the s-sample mean of the 2-tap bilinear
// weights, rounded to the feature dtype, exactly as `_pool_matrices`
// (roi_align_pallas.py:151-158) builds them (`bin_taps`); each of their rows holds
// at most 2s non-zeros.
//
// Owner computes, as the TPU kernel does: `_bwd_kernel` holds the f32 accumulator
// of one image's w-chunk, all rows and channels, in VMEM and streams the image's
// ROIs through it. A block here owns one tile of one image's dF, th x tw map cells
// with every channel, as an f32 accumulator in shared memory (7 x 14 cells x 512
// channels, 196 KB, on the recipe's 38 x 84 x 512 map; the wrapper's `bwd_plan`
// sizes the tiles and `bwd_smem` lays out the shared memory). It walks its image's
// ROIs in order:
//
// - the ROIs come in chunks of 512, a thread each: a ROI whose footprint (the taps
//   of its first and last bins; the bins are monotone) misses the tile is
//   dropped, the others are listed in order (a warp vote, a prefix over warps);
// - the listed ROIs go in batches of up to 32. One thread per (ROI, axis, bin)
//   writes its bin's row of Wy over the tile's rows, or of Wx over its columns,
//   and sets its bit in the masks of the bins with weight in the tile and of the
//   bins x that reach each column (ORs into shared memory); then a barrier;
// - a column of the tile belongs to a group of C/16 lanes (a warp at C = 512),
//   each lane holding 16 channels 4 at a time, so that a warp's loads and shared
//   memory accesses are contiguous and its control flow uniform. For each ROI of
//   the batch, each of its columns in the tile and each bin q with weight in the
//   tile: t = sum_x Wx[x, col] g[q, x] over the bins x that reach the column (the
//   x contraction first, as `_bwd_kernel` does), then acc[row, col] += Wy[q, row] t
//   over the rows of bin q in the tile. A zero g (the padded ROIs of the masked
//   losses) adds nothing. Meanwhile each thread asks L2 for one line of the g
//   that the tile needs of the ROI two ahead;
// - after the last batch the tile is written once, in the feature dtype.
//
// Each accumulator word belongs to one lane, which adds into it in a fixed order:
// no atomic adds, and dF is bitwise reproducible from run to run. No global
// scratch, no memset, no second kernel. The plain version rounds its intermediate
// to the feature dtype and this kernel does not, so the two agree within a
// tolerance, not bit for bit.
//
// What bounds it: at the recipe's student shape (48 x 512 ROIs, 48 x 38x84x512
// bf16) the function reads g (1.23 GB) and writes dF (0.16 GB): bytes, 0.415 ms.
// A bin whose taps reach two tiles is read by both (about a quarter more of g,
// mostly from L2), and each column of a tile reads its bins x again (L1/L2).
// Measured on the card the kernel is bound by neither (PERF.md, PR 5). The tile
// leaves no room for a ring of g in shared memory; two designs with smaller tiles
// and such a ring (cp.async with a barrier per slot group; bulk copies from a
// producer warp with an mbarrier per slot) measured slower (PERF.md, PR 5).
//
// K2_ABLATE (only for timing where the time goes; the result is wrong): 1 loads no
// g (each lane adds a constant), 2 adds nothing into the accumulator.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kMaxS = 4;             // samples per bin and axis
constexpr int kMaxTaps = 2 * kMaxS;  // distinct rows (columns) one bin touches
constexpr int kMaxBins = 32;         // p
constexpr int kThreads = 512;
constexpr int kAhead = 2;            // ROIs whose g is fetched into L2 ahead of use
#ifndef K2_ABLATE
#define K2_ABLATE 0
#endif
constexpr int kMaxSmem = 232448;     // shared memory a block may opt in to

struct BinTaps {
  int idx[kMaxTaps];
  float w[kMaxTaps];
  int count;
};

// four channels of g, read-only through the texture path; returns the OR of their
// bits (0 only if all four are +0)
__device__ __forceinline__ unsigned load4g(const float* p, float (&v)[4]) {
  const uint4 x = __ldg(reinterpret_cast<const uint4*>(p));
  v[0] = __uint_as_float(x.x); v[1] = __uint_as_float(x.y);
  v[2] = __uint_as_float(x.z); v[3] = __uint_as_float(x.w);
  return x.x | x.y | x.z | x.w;
}

__device__ __forceinline__ unsigned load4g(const __nv_bfloat16* p, float (&v)[4]) {
  const uint2 x = __ldg(reinterpret_cast<const uint2*>(p));
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&x);
  const float2 a = __bfloat1622float2(h[0]);
  const float2 b = __bfloat1622float2(h[1]);
  v[0] = a.x; v[1] = a.y; v[2] = b.x; v[3] = b.y;
  return x.x | x.y;
}

__device__ __forceinline__ void store4(float* p, const float4& v) {
  *reinterpret_cast<float4*>(p) = v;
}

__device__ __forceinline__ void store4(__nv_bfloat16* p, const float4& v) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y);
  __nv_bfloat162 hi = __floats2bfloat162_rn(v.z, v.w);
  uint2 o;
  o.x = *reinterpret_cast<uint32_t*>(&lo);
  o.y = *reinterpret_cast<uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(p) = o;
}

__device__ __forceinline__ float round_to(float x, int is_bf16) {
  return is_bf16 ? __bfloat162float(__float2bfloat16_rn(x)) : x;
}

// The bin's distinct taps along one axis: the rules of `_sample_points` and
// `_interp_matrix` (ops/roi_align.py:101-128), then the mean over the s samples.
__device__ void bin_taps(float lo_in, float hi_in, float scale, int q, int p, int s, int size,
                         int is_bf16, BinTaps* out) {
  // every loop runs to its static bound under a guard, so that the lists stay in
  // registers; the arithmetic is the same
  const float lo = __fsub_rn(__fmul_rn(lo_in, scale), 0.5f);
  const float hi = __fsub_rn(__fmul_rn(hi_in, scale), 0.5f);
  const float bin = __fdiv_rn(__fsub_rn(hi, lo), (float)p);
  int i0[kMaxS], i1[kMaxS];
  float w0[kMaxS], w1[kMaxS];
#pragma unroll
  for (int j = 0; j < kMaxS; ++j) {
    if (j >= s) break;
    const float grid_s = __fdiv_rn(__fadd_rn((float)j, 0.5f), (float)s);
    const float off = __fadd_rn((float)q, grid_s);
    const float v = __fadd_rn(lo, __fmul_rn(off, bin));
    const bool oob = (v < -1.0f) || (v > (float)size);
    const float vc = fminf(fmaxf(v, 0.0f), (float)(size - 1));
    int a = (int)floorf(vc);
    a = min(max(a, 0), size - 1);  // memory safety for non-finite boxes
    i0[j] = a;
    i1[j] = min(a + 1, size - 1);
    const float l = __fsub_rn(vc, (float)a);
    w0[j] = oob ? 0.0f : __fsub_rn(1.0f, l);
    w1[j] = oob ? 0.0f : l;
  }
  int count = 0;
#pragma unroll
  for (int j = 0; j < kMaxS; ++j) {
    if (j >= s) break;
#pragma unroll
    for (int t = 0; t < 2; ++t) {
      const int row = t == 0 ? i0[j] : i1[j];
      bool seen = false;
#pragma unroll
      for (int m = 0; m < 2 * j + t; ++m) seen |= m < count && out->idx[m] == row;
      if (seen) continue;
      // Wy[q, row] = mean_j (w0_j [i0_j == row] + w1_j [i1_j == row]), in the dtype
      float sum = 0.0f;
#pragma unroll
      for (int k = 0; k < kMaxS; ++k) {
        if (k >= s) break;
        const float v = __fadd_rn(i0[k] == row ? w0[k] : 0.0f, i1[k] == row ? w1[k] : 0.0f);
        sum = __fadd_rn(sum, v);
      }
      const float wgt = round_to(__fdiv_rn(sum, (float)s), is_bf16);
#pragma unroll
      for (int m = 0; m < 2 * j + t + 1; ++m) {
        if (m == count) {
          out->idx[m] = row;
          out->w[m] = wgt;
        }
      }
      ++count;
    }
  }
  out->count = count;
}

struct Params {
  int n, h, w, c, r, p, s;
  float scale;
  int th, tw, tiles_y, tiles_x, batch;
};

// One ROI's footprint: the rows and columns the taps of its first and last bins
// span. The sample coordinates grow (or, for an inverted box, shrink) with the bin,
// so every bin's taps lie between them.
__device__ void footprint(const float* b, float scale, int p, int s, int h, int w, int is_bf16,
                          int (&fp)[4]) {
#pragma unroll
  for (int axis = 0; axis < 2; ++axis) {            // 0: rows from (y1, y2); 1: columns
    int lo = 1 << 30, hi = -1;
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      BinTaps bt;
      bin_taps(b[axis == 0 ? 1 : 0], b[axis == 0 ? 3 : 2], scale, e == 0 ? 0 : p - 1, p, s,
               axis == 0 ? h : w, is_bf16, &bt);
#pragma unroll
      for (int m = 0; m < kMaxTaps; ++m) {
        if (m < bt.count) {
          lo = min(lo, bt.idx[m]);
          hi = max(hi, bt.idx[m]);
        }
      }
    }
    fp[2 * axis] = lo;
    fp[2 * axis + 1] = hi;
  }
}

template <typename T, int V>
__global__ void __launch_bounds__(kThreads, 1)
roi_align_bwd_kernel(const T* __restrict__ g, const float* __restrict__ boxes,
                     T* __restrict__ out, Params a) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int is_bf16 = sizeof(T) == 2;
  const int p = a.p, c = a.c, th = a.th, tw = a.tw, batch = a.batch;
  const int tile = blockIdx.x % (a.tiles_y * a.tiles_x);
  const int n = blockIdx.x / (a.tiles_y * a.tiles_x);
  const int y0 = (tile / a.tiles_x) * th, x0 = (tile % a.tiles_x) * tw;
  const int y1 = min(y0 + th, a.h) - 1, x1 = min(x0 + tw, a.w) - 1;   // the tile, inclusive
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;

  float* acc = reinterpret_cast<float*>(smem);                   // (th, tw, C) f32
  // the chunk's ROIs that meet the tile: (ROI, first column, last column, -)
  int4* rois = reinterpret_cast<int4*>(acc + (size_t)th * tw * c);  // (kThreads)
  float* wyt = reinterpret_cast<float*>(rois + kThreads);         // (batch, p, th)
  float* wxt = wyt + (size_t)batch * p * th;                     // (batch, p, tw)
  int* qspan = reinterpret_cast<int*>(wxt + (size_t)batch * p * tw);  // (batch, p, 2): tile rows
  unsigned* colmask = reinterpret_cast<unsigned*>(qspan + batch * 2 * p);  // (batch, tw): bins x
  unsigned* qbits = colmask + batch * tw;                        // (batch): bins q in the tile
  unsigned* xbits = qbits + batch;                               // (batch): bins x in the tile
  int* wcount = reinterpret_cast<int*>(xbits + batch);           // (kThreads / 32)
  unsigned smem_size;
  asm("mov.u32 %0, %%dynamic_smem_size;" : "=r"(smem_size));
  if ((size_t)(wcount + kThreads / 32 - reinterpret_cast<int*>(smem)) * 4 > smem_size) {
    __trap();   // the layout does not fit the wrapper's `bwd_smem`
  }

  for (int i = tid; i < th * tw * c / 4; i += kThreads) {
    store4(acc + (size_t)i * 4, make_float4(0.f, 0.f, 0.f, 0.f));
  }

  // a column group's lanes hold V channels each, 4 at a time, lanes * 4 apart, so
  // that a warp's loads and stores of one 4-channel step are contiguous
  const int lanes = c / V;
  const int groups = kThreads / lanes;
  const int gi = tid / lanes, li = tid - gi * lanes;
  const T* gimg = g + (size_t)n * a.r * p * p * c;
  const float* bimg = boxes + (size_t)n * a.r * 4;
  // this thread's 128-byte line of g to ask L2 for ahead of use: (bin q, bin x, line)
  const int lines = (c * (int)sizeof(T) + 127) / 128;
  const int pf_bin = tid / lines, pf_q = pf_bin / p, pf_x = pf_bin - pf_q * p;
  const size_t pf_at = (size_t)pf_bin * c * sizeof(T) + (tid - pf_bin * lines) * 128;

  for (int base = 0; base < a.r; base += kThreads) {
    // the ROIs of this chunk whose footprint meets the tile, in order
    const int roi = base + tid;
    int fp[4] = {1, 0, 1, 0};
    if (roi < a.r) footprint(bimg + (size_t)roi * 4, a.scale, p, a.s, a.h, a.w, is_bf16, fp);
    const bool meets = roi < a.r && fp[0] <= y1 && fp[1] >= y0 && fp[2] <= x1 && fp[3] >= x0;
    const unsigned vote = __ballot_sync(0xffffffffu, meets);
    if (lane == 0) wcount[warp] = __popc(vote);
    __syncthreads();
    int at = 0, total = 0;
    for (int v = 0; v < kThreads / 32; ++v) {
      at += v < warp ? wcount[v] : 0;
      total += wcount[v];
    }
    if (meets) {
      at += __popc(vote & ((1u << lane) - 1));
      rois[at] = make_int4(roi, max(fp[2], x0), min(fp[3], x1), 0);
    }
    __syncthreads();

    for (int b0 = 0; b0 < total; b0 += batch) {
      const int nb = min(batch, total - b0);
      // tables: one thread per (ROI, axis, bin) writes its bin's row of Wy over the
      // tile's rows or Wx over its columns, whether the bin has a weight there, the
      // tile rows it has weights on (Wy), and its bit in the masks of the columns
      // it has weights on (Wx)
      for (int k = tid; k < batch * (tw + 2); k += kThreads) colmask[k] = 0;  // and the bits
      __syncthreads();
      if (tid < nb * 2 * p) {
        const int i = tid / (2 * p), axis = (tid / p) % 2, q = tid % p;
        const float* b = bimg + (size_t)rois[b0 + i].x * 4;
        BinTaps bt;
        bin_taps(b[axis == 0 ? 1 : 0], b[axis == 0 ? 3 : 2], a.scale, q, p, a.s,
                 axis == 0 ? a.h : a.w, is_bf16, &bt);
        const int len = axis == 0 ? th : tw, origin = axis == 0 ? y0 : x0;
        float* row = axis == 0 ? wyt + ((size_t)i * p + q) * th : wxt + ((size_t)i * p + q) * tw;
        for (int k = 0; k < len; ++k) row[k] = 0.0f;
        int lo = 1 << 30, hi = -1;
#pragma unroll
        for (int m = 0; m < kMaxTaps; ++m) {
          if (m < bt.count) {
            const int k = bt.idx[m] - origin;
            if (k >= 0 && k < len && bt.w[m] != 0.0f) {
              row[k] = bt.w[m];
              lo = min(lo, k);
              hi = max(hi, k);
              if (axis == 1) atomicOr(colmask + i * tw + k, 1u << q);
            }
          }
        }
        if (hi >= 0) atomicOr((axis == 0 ? qbits : xbits) + i, 1u << q);
        if (axis == 0) {
          qspan[(i * p + q) * 2] = lo;
          qspan[(i * p + q) * 2 + 1] = hi;
        }
      }
      __syncthreads();

      // compute: group gi owns the tile's columns x0 + gi, x0 + gi + groups, ...
      for (int i = 0; i < nb; ++i) {
        // ask L2 for the bins the tile needs of the ROI kAhead on (of the first
        // kAhead + 1 at the start of a batch), a line a thread (bins past 512 lines
        // are not asked for)
        for (int j = i == 0 ? 0 : i + kAhead; j <= i + kAhead && j < nb; ++j) {
          if (K2_ABLATE != 1 && pf_q < p && (qbits[j] >> pf_q & 1u) &&
              (xbits[j] >> pf_x & 1u)) {
            const char* bins =
                reinterpret_cast<const char*>(gimg + (size_t)rois[b0 + j].x * p * p * c);
            asm volatile("prefetch.global.L2 [%0];" ::"l"(bins + pf_at));
          }
        }
        if (gi >= groups) continue;
        const int4 roi_i = rois[b0 + i];
        const float* wy = wyt + (size_t)i * p * th;
        const float* wx = wxt + (size_t)i * p * tw - x0;
        const int* span = qspan + i * p * 2;
        const unsigned qmask = qbits[i];        // the bins q with a weight in the tile's rows
        const T* gr = gimg + (size_t)roi_i.x * p * p * c + li * 4;
        int col = x0 + gi;
        while (col < roi_i.y) col += groups;
        for (; col <= roi_i.z; col += groups) {
          const unsigned xmask = colmask[i * tw + col - x0];  // the bins x with a weight here
          if (xmask == 0) continue;
          float* cell = acc + (size_t)(col - x0) * c + li * 4;
          for (unsigned qm = qmask; qm; qm &= qm - 1) {
            const int q = __ffs(qm) - 1;
            float t[V];
#pragma unroll
            for (int v = 0; v < V; ++v) t[v] = 0.0f;
            unsigned nz = 0;
            for (unsigned xm = xmask; xm; xm &= xm - 1) {
              const int x = __ffs(xm) - 1;
              const float wgt = wx[x * tw + col];
              const T* src = gr + (size_t)(q * p + x) * c;
#pragma unroll
              for (int k = 0; k < V / 4; ++k) {
                float gv[4];
#if K2_ABLATE == 1
                gv[0] = gv[1] = gv[2] = gv[3] = wgt;
                nz = 1;
                (void)src;
#else
                nz |= load4g(src + k * lanes * 4, gv);
#endif
#pragma unroll
                for (int v = 0; v < 4; ++v) t[4 * k + v] = fmaf(wgt, gv[v], t[4 * k + v]);
              }
            }
            if (nz == 0) continue;
#if K2_ABLATE == 2
            // skip unless the bits of t's sum equal a value of the launch's arguments,
            // which no constant folding can rule out and no run meets: the loads and t
            // stay, the adds go
            float all = 0.0f;
#pragma unroll
            for (int v = 0; v < V; ++v) all += t[v];
            if (__float_as_uint(all) != (unsigned)a.r * 2654435761u) continue;
#endif
            const int lo = span[2 * q], hi = span[2 * q + 1];
            for (int r = lo; r <= hi; ++r) {
              const float wgt = wy[q * th + r];
              if (wgt == 0.0f) continue;
              float* dst = cell + (size_t)r * tw * c;
#pragma unroll
              for (int k = 0; k < V / 4; ++k) {
                float4 o = *reinterpret_cast<float4*>(dst + k * lanes * 4);
                o.x = fmaf(wgt, t[4 * k], o.x);
                o.y = fmaf(wgt, t[4 * k + 1], o.y);
                o.z = fmaf(wgt, t[4 * k + 2], o.z);
                o.w = fmaf(wgt, t[4 * k + 3], o.w);
                store4(dst + k * lanes * 4, o);
              }
            }
          }
        }
      }
      __syncthreads();
    }
  }

  // the tile, once, in the feature dtype
  const int rows = y1 - y0 + 1, cols = x1 - x0 + 1, cgs = c / 4;
  for (int i = tid; i < rows * cols * cgs; i += kThreads) {
    const int cell = i / cgs, ch = (i - cell * cgs) * 4;
    const int ry = cell / cols, rx = cell - ry * cols;
    const float4 v = *reinterpret_cast<const float4*>(acc + ((size_t)ry * tw + rx) * c + ch);
    store4(out + (((size_t)n * a.h + y0 + ry) * a.w + x0 + rx) * c + ch, v);
  }
}

template <typename T, int V>
int launch(const void* g, const void* boxes, void* out, const Params& a, int smem,
           cudaStream_t st) {
  auto* kernel = roi_align_bwd_kernel<T, V>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)(a.n * a.tiles_y * a.tiles_x));
  kernel<<<grid, kThreads, smem, st>>>((const T*)g, (const float*)boxes, (T*)out, a);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

const char* pt_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

// g (N, R, p, p, C) in the feature dtype (0 = f32, 1 = bf16); boxes (N, R, 4) f32
// XYXY in image coordinates; out (N, H, W, C) in the feature dtype, written once,
// whole. The plan (the wrapper's `bwd_plan`): tiles of th x tw map cells with every
// channel, tables for `batch` ROIs at a time (2 * p * batch <= 512), at most 512
// lanes to a column (C / 16, or C / 4 where C is not a multiple of 16), and `smem`
// bytes of shared memory a block as the wrapper's `bwd_smem` lays it out (the kernel
// traps if its layout does not fit). C a multiple of 4, every pointer 16-byte
// aligned (the wrapper checks). Launches on `stream`; returns cudaGetLastError().
int pt_roi_align_bwd(const void* g, const void* boxes, void* out, int n, int h, int w, int c,
                     int r, int p, int s, float scale, int dtype, int th, int tw, int batch,
                     int smem, void* stream) {
  if ((dtype != 0 && dtype != 1) || p < 1 || p > kMaxBins || s > kMaxS || s < 1 || c % 4 ||
      th < 1 || tw < 1 || batch < 1 || 2 * p * batch > kThreads ||
      (c % 16 == 0 ? c / 16 : c / 4) > kThreads || smem < 1 || smem > kMaxSmem) {
    return (int)cudaErrorInvalidValue;
  }
  if (n * h * w == 0 || c == 0) return 0;
  const Params a{n, h, w, c, r, p, s, scale, th, tw, (h + th - 1) / th, (w + tw - 1) / tw, batch};
  cudaStream_t st = (cudaStream_t)stream;
  // 16 channels a lane where C allows, else 4
  if (c % 16 == 0) {
    return dtype == 0 ? launch<float, 16>(g, boxes, out, a, smem, st)
                      : launch<__nv_bfloat16, 16>(g, boxes, out, a, smem, st);
  }
  return dtype == 0 ? launch<float, 4>(g, boxes, out, a, smem, st)
                    : launch<__nv_bfloat16, 4>(g, boxes, out, a, smem, st);
}

}  // extern "C"
