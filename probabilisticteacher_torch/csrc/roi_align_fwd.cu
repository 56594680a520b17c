// ROIAlign forward (aligned=True, fixed s x s sampling) for Hopper (sm_90a).
//
// Replaces the TPU kernel probabilisticteacher_tpu/ops/roi_align_pallas.py:70
// (`_kernel`, launched by `_forward`), which contracts dense interpolation
// matrices on the matrix unit: out[n,r,y,x,c] = sum_h sum_w Wy[n,r,y,h] F[n,h,w,c]
// Wx[n,r,x,w]. The TPU holds the whole map in VMEM and contracts densely. Here
// each row of Wy/Wx has at most 2*s non-zeros out of H or W, and each element of
// F is used a handful of times per ROI (~2-4 FLOP a byte, far below the ~295 the
// tensor cores need), so this kernel does the same separable contraction over
// its non-zero band only, in f32 on the CUDA cores:
//
// - a block per (ROI, slice of 32 channel vectors of 16 bytes), blocks ordered
//   image-major (ROI n*R + r, then its slices), so the ROIs of one image run
//   together and its map (38x84x512 bf16 = 3.3 MB) stays in the 50 MB L2; the
//   map's loads carry an L2::evict_last policy and the output goes out through
//   streaming stores (st.global.cs), so that it passes the L2 by. 224 threads at
//   <= 128 registers let two blocks share an SM, so one block's tables overlap
//   the other's contraction;
// - tables, once per block, in shared memory: the 2*p*s sample taps (row/column
//   indices and weights) with the rules and rounded arithmetic of
//   `_sample_points` and `_interp_matrix` (ops/roi_align.py:27-63): out of bounds
//   when v < -1 or v > size, clip to [0, size-1], i1 = min(i0 + 1, size - 1), and
//   i0 clamped so that non-finite boxes stay inside the map. Explicitly rounded
//   operations (no FMA contraction) keep the sample positions equal to the plain
//   PyTorch version's bit for bit. From them: the ascending list of the ROI's
//   distinct rows that carry weight, each with its summed weight in each bin py
//   (Wy restricted to its band), and each bin px's distinct columns with their
//   summed weights (Wx's band). At (7, 2) a lane holds each of the 28 taps of an
//   axis, rows in warp 0 and columns in warp 1, and warp votes (match, ballot,
//   shuffles) build the lists behind a single barrier;
// - one thread per (bin column px, 16-byte channel vector): the thread walks the
//   distinct rows u once, two at a time (8 loads in flight), forms
//   X[u] = sum_w Wx[px, w] F[u, w, :] over px's <= 2s columns, adds Wy[py, u] X[u]
//   into 7 f32 register accumulators (one per bin py; a row's zero weights are
//   skipped on a test that is uniform across the block), and writes its 7 bins
//   once. A ROI costs 7 x U x <= 4 loads a vector instead of 49 x 16, where U is
//   the number of distinct rows (<= 28, ~8 for a ROI six cells tall).
//
// (p, s) = (7, 2), the recipe's only pooling, is compiled with both fixed: the
// loops unroll and no division runs per row. Any other (p, s) within the
// wrapper's limits (p*s <= 64, s <= 4) runs a runtime-p instantiation of the same
// kernel, whose tables take three barriers and whose threads accumulate the bins
// py in groups of 7.
//
// What bounds it: bytes. At the teacher pass (16 x 2000 ROIs, 38x84x512 bf16) the
// output is 32000*49*512*2 B = 1.6 GB written against 53 MB of map read, 0.495 ms
// at 3.35 TB/s; the tables and the stores alone run at about that bound
// (K1_ABLATE=3). The distinct taps still come from L2/L1 (each map element is
// read by every ROI that covers it), and the contraction's loads and FMAs add
// about as much again (PERF.md §6).
//
// K1_ABLATE (only for timing where the time goes; the result is wrong): 1 loads
// nothing from the map (each tap reads a value made from its address), 2 stores
// nothing (each store is skipped on a test of the bins' bits against a value of
// the launch arguments, which no run meets and no constant folding can rule out),
// 3 contracts nothing (the tables are built and zeros stored).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#ifndef K1_ABLATE
#define K1_ABLATE 0
#endif

namespace {

constexpr int kMaxS = 4;    // samples per bin and axis
constexpr int kMaxPS = 64;  // p * s per axis
constexpr int kChunk = 7;   // bins py a thread accumulates at once
// a block: one ROI's bins and a slice of up to 32 channel vectors of 16 bytes,
// 7 x 32 = 224 threads at p = 7; two blocks to an SM at <= 128 registers
constexpr int kSlice = 32;
constexpr int kThreads = 7 * kSlice;
constexpr int kBlocksPerSm = 2;

// the tables of one ROI, sized for at most MP bins and MPS samples per axis
template <int MP, int MPS, int MC>
struct Tables {
  int tap_row[2][2 * MPS];  // [axis][2k + t]: sample k's taps i0 (t = 0) and i1
  float tap_w[2][2 * MPS];  // their weights, zero when the sample is out of bounds
  int first[2 * MPS];       // y taps: the first tap with weight on its row
  int rows[2 * MPS];        // the distinct rows with weight, ascending
  alignas(16) float wy[2 * MPS][(MP + 3) / 4 * 4];  // each row's summed weight in each bin py
  int cols[MP][MC];         // each bin px's distinct columns with weight
  float wx[MP][MC];         // and their summed weights
  int ncol[MP];
  int nrows;
};

__device__ __forceinline__ uint64_t evict_last_policy() {
  uint64_t pol;
  asm volatile("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;" : "=l"(pol));
  return pol;
}

// 16 bytes of the map, read-only, kept in L2
__device__ __forceinline__ uint4 load_map(const void* p, uint64_t pol) {
#if K1_ABLATE == 1
  const uint64_t a = reinterpret_cast<uint64_t>(p);
  return make_uint4((unsigned)a, (unsigned)(a >> 32), (unsigned)a ^ 0x3f800000u, 0u);
#else
  uint4 x;
  asm("ld.global.nc.L2::cache_hint.v4.u32 {%0, %1, %2, %3}, [%4], %5;"
      : "=r"(x.x), "=r"(x.y), "=r"(x.z), "=r"(x.w)
      : "l"(p), "l"(pol));
  return x;
#endif
}

__device__ __forceinline__ void unpack(const uint4& x, float (&v)[4]) {
  v[0] = __uint_as_float(x.x); v[1] = __uint_as_float(x.y);
  v[2] = __uint_as_float(x.z); v[3] = __uint_as_float(x.w);
}

__device__ __forceinline__ void unpack(const uint4& x, float (&v)[8]) {
  const unsigned u[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    v[2 * q] = __uint_as_float(u[q] << 16);            // bf16 -> f32 is a shift
    v[2 * q + 1] = __uint_as_float(u[q] & 0xffff0000u);
  }
}

__device__ __forceinline__ void store_out(float* p, const float (&v)[4]) {
  __stcs(reinterpret_cast<float4*>(p), make_float4(v[0], v[1], v[2], v[3]));
}

__device__ __forceinline__ void store_out(__nv_bfloat16* p, const float (&v)[8]) {
  uint4 x;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&x);
#pragma unroll
  for (int q = 0; q < 4; ++q) h[q] = __floats2bfloat162_rn(v[2 * q], v[2 * q + 1]);
  __stcs(reinterpret_cast<uint4*>(p), x);
}

// Sample k of one axis of a ROI (b: its box, XYXY; axis 0 rows from y, 1 columns
// from x): its taps i0, i1 and their weights, with the rules and rounded
// arithmetic of the plain version (the weights are zero out of bounds).
__device__ __forceinline__ void sample(const float* b, int axis, int k, int p, int s, int size,
                                       float scale, int& i0, int& i1, float& w0, float& w1) {
  const float lo = __fsub_rn(__fmul_rn(b[axis == 0 ? 1 : 0], scale), 0.5f);
  const float hi = __fsub_rn(__fmul_rn(b[axis == 0 ? 3 : 2], scale), 0.5f);
  const float bin = __fdiv_rn(__fsub_rn(hi, lo), (float)p);
  const float grid_s = __fdiv_rn(__fadd_rn((float)(k % s), 0.5f), (float)s);
  const float off = __fadd_rn((float)(k / s), grid_s);
  const float v = __fadd_rn(lo, __fmul_rn(off, bin));
  const bool oob = (v < -1.0f) || (v > (float)size);
  const float vc = fminf(fmaxf(v, 0.0f), (float)(size - 1));
  i0 = (int)floorf(vc);
  i0 = min(max(i0, 0), size - 1);  // memory safety for non-finite boxes
  i1 = min(i0 + 1, size - 1);
  const float l = __fsub_rn(vc, (float)i0);
  w0 = oob ? 0.0f : __fsub_rn(1.0f, l);
  w1 = oob ? 0.0f : l;
}

// Add NR rows (ascending list entries u .. u + NR - 1) into acc: X = sum over the
// thread's columns of Wx * F[row], then acc[py] += Wy[row, py] * X. All loads go
// out before the first FMA.
template <int VEC, int NR, int MC, int MP, int MPS, typename T>
__device__ __forceinline__ void add_rows(const Tables<MP, MPS, MC>& t, int u, const T* f,
                                         size_t row_elems, const int (&coff)[MC],
                                         const float (&wxr)[MC], int ncol, int q0, int nq,
                                         uint64_t pol, float (&acc)[kChunk][VEC]) {
  uint4 raw[NR][MC];
#pragma unroll
  for (int i = 0; i < NR; ++i) {
    const T* base = f + (size_t)t.rows[u + i] * row_elems;
#pragma unroll
    for (int k = 0; k < MC; ++k) {
      if (k < ncol) raw[i][k] = load_map(base + coff[k], pol);
    }
  }
#pragma unroll
  for (int i = 0; i < NR; ++i) {
    float x[VEC];
#pragma unroll
    for (int q = 0; q < VEC; ++q) x[q] = 0.0f;
#pragma unroll
    for (int k = 0; k < MC; ++k) {
      if (k < ncol) {
        float v[VEC];
        unpack(raw[i][k], v);
#pragma unroll
        for (int q = 0; q < VEC; ++q) x[q] = fmaf(wxr[k], v[q], x[q]);
      }
    }
#pragma unroll
    for (int b = 0; b < kChunk; ++b) {
      const float wgt = b < nq ? t.wy[u + i][q0 + b] : 0.0f;
      if (wgt != 0.0f) {  // the same for every thread of the block
#pragma unroll
        for (int q = 0; q < VEC; ++q) acc[b][q] = fmaf(wgt, x[q], acc[b][q]);
      }
    }
  }
}

// P, S: the pooling fixed at compile time, or 0 for the runtime-p instantiation.
// NR: rows a thread loads at once.
template <typename T, int VEC, int P, int S, int NR>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
roi_align_fwd_kernel(const T* __restrict__ feat, const float* __restrict__ boxes,
                     T* __restrict__ out, int h, int w, int c, int r, int p_arg, int s_arg,
                     float scale, int slices) {
  constexpr int MP = P ? P : kMaxPS;
  constexpr int MS = S ? S : kMaxS;
  constexpr int MPS = P ? P * S : kMaxPS;
  constexpr int MC = 2 * MS;
  __shared__ Tables<MP, MPS, MC> t;
  const int p = P ? P : p_arg;
  const int s = S ? S : s_arg;
  const int ps = p * s;
  const int roi = blockIdx.x / slices;  // n * R + r: image-major
  const int slice = blockIdx.x - roi * slices;
  const int n = roi / r;
  const int tid = threadIdx.x, nt = blockDim.x;

  const float* box = boxes + (size_t)roi * 4;
  constexpr bool kWarpTables = P && 2 * P * S <= 32;
  if constexpr (kWarpTables) {
    // a lane per tap: the rows in warp 0, the columns in warp 1, one barrier
    const int warp = tid >> 5, lane = tid & 31;
    if (warp < 2) {
      const int axis = warp;
      const bool live = lane < 2 * ps;
      const int k = lane >> 1, px = k / s;
      int row = 0;
      float wt = 0.0f;
      if (live) {
        int i0, i1;
        float w0, w1;
        sample(box, axis, k, p, s, axis == 0 ? h : w, scale, i0, i1, w0, w1);
        row = (lane & 1) ? i1 : i0;
        wt = (lane & 1) ? w1 : w0;
        t.tap_w[axis][lane] = wt;
      }
      // taps with weight on one row (columns: of one bin px) match; the others
      // match nothing
      const unsigned long long key =
          wt != 0.0f ? ((unsigned long long)(axis ? px : 0) << 32) | (unsigned)row
                     : (1ull << 63) | lane;
      const unsigned same = __match_any_sync(0xffffffffu, key);
      const bool lead = wt != 0.0f && lane == __ffs(same) - 1;
      const unsigned leads = __ballot_sync(0xffffffffu, lead);
      __syncwarp();
      if (axis == 0) {
        int rank = 0;
#pragma unroll
        for (int m = 0; m < 32; ++m) {
          const int rm = __shfl_sync(0xffffffffu, row, m);
          rank += ((leads >> m) & 1u) && rm < row;
        }
        if (lead) {
          t.rows[rank] = row;
#pragma unroll
          for (int q = 0; q < MP; ++q) t.wy[rank][q] = 0.0f;
          for (unsigned m = same; m; m &= m - 1) {
            const int j = __ffs(m) - 1;
            t.wy[rank][j / (2 * s)] = __fadd_rn(t.wy[rank][j / (2 * s)], t.tap_w[0][j]);
          }
        }
        if (lane == 0) t.nrows = __popc(leads);
      } else {
        const unsigned bin_lanes = ((1u << (2 * s)) - 1) << (2 * s * px);
        if (lead) {
          const int pos = __popc(leads & bin_lanes & ((1u << lane) - 1));
          float sum = 0.0f;
          for (unsigned m = same; m; m &= m - 1) sum = __fadd_rn(sum, t.tap_w[1][__ffs(m) - 1]);
          t.cols[px][pos] = row;
          t.wx[px][pos] = sum;
        }
        if (live && lane == 2 * s * px) t.ncol[px] = __popc(leads & bin_lanes);
      }
    }
    __syncthreads();
  } else {
    // shared-memory tables for any (p, s): 1. the samples: rows from (y1, y2),
    // columns from (x1, x2)
    if (tid == 0) t.nrows = 0;
    for (int i = tid; i < 2 * ps; i += nt) {
      const int axis = i / ps;
      const int k = i - axis * ps;
      int i0, i1;
      float w0, w1;
      sample(box, axis, k, p, s, axis == 0 ? h : w, scale, i0, i1, w0, w1);
      t.tap_row[axis][2 * k] = i0;
      t.tap_row[axis][2 * k + 1] = i1;
      t.tap_w[axis][2 * k] = w0;
      t.tap_w[axis][2 * k + 1] = w1;
    }
    __syncthreads();

    // 2. y: is each tap the first with weight on its row; x: each bin's columns
    for (int i = tid; i < 2 * ps + p; i += nt) {
      if (i < 2 * ps) {
        const int row = t.tap_row[0][i];
        bool first = t.tap_w[0][i] != 0.0f;
#pragma unroll 4
        for (int m = 0; m < i; ++m) first &= !(t.tap_w[0][m] != 0.0f && t.tap_row[0][m] == row);
        t.first[i] = first;
      } else {
        const int px = i - 2 * ps;
        int cnt = 0;
#pragma unroll
        for (int j = 0; j < MC; ++j) {
          if (j >= 2 * s) break;
          const float wt = t.tap_w[1][2 * px * s + j];
          const int col = t.tap_row[1][2 * px * s + j];
          if (wt == 0.0f) continue;
          int m = 0;
          while (m < cnt && t.cols[px][m] != col) ++m;
          if (m == cnt) {
            t.cols[px][m] = col;
            t.wx[px][m] = wt;
            ++cnt;
          } else {
            t.wx[px][m] = __fadd_rn(t.wx[px][m], wt);
          }
        }
        t.ncol[px] = cnt;
      }
    }
    __syncthreads();

    // 3. y: the first taps place their rows in ascending order, with the row's
    // summed weight in each bin
    for (int i = tid; i < 2 * ps; i += nt) {
      if (!t.first[i]) continue;
      const int row = t.tap_row[0][i];
      int rank = 0, total = 0;
#pragma unroll 4
      for (int m = 0; m < 2 * ps; ++m) {
        const int fm = t.first[m];
        total += fm;
        rank += fm & (t.tap_row[0][m] < row);
      }
      t.rows[rank] = row;
      if (rank == 0) t.nrows = total;
      for (int q = 0; q < p; ++q) {
        float sum = 0.0f;
#pragma unroll
        for (int k = 0; k < 2 * MS; ++k) {
          if (k >= 2 * s) break;
          const int j = 2 * q * s + k;
          if (t.tap_row[0][j] == row) sum = __fadd_rn(sum, t.tap_w[0][j]);
        }
        t.wy[rank][q] = sum;
      }
    }
    __syncthreads();
  }

  // 4. the contraction: a thread per (bin px, channel vector of the slice)
  const int cv = c / VEC;
  const int per = (cv + slices - 1) / slices;  // vectors a slice
  const size_t row_elems = (size_t)w * c;
  const T* f = feat + (size_t)n * h * row_elems;
  T* o = out + (size_t)roi * p * p * c;
  const float inv = 1.0f / (float)(s * s);
#if K1_ABLATE == 3
  const int nrows = 0;
#else
  const int nrows = t.nrows;
#endif
  const uint64_t pol = evict_last_policy();

  for (int item = tid; item < p * per; item += nt) {
    const int px = item / per;
    const int vec = slice * per + item - px * per;
    if (vec >= cv) continue;
    const int ch = vec * VEC;
    const int ncol = t.ncol[px];
    int coff[MC];
    float wxr[MC];
#pragma unroll
    for (int k = 0; k < MC; ++k) {
      coff[k] = k < ncol ? t.cols[px][k] * c + ch : 0;
      wxr[k] = k < ncol ? t.wx[px][k] : 0.0f;
    }
    for (int q0 = 0; q0 < p; q0 += kChunk) {
      const int nq = min(kChunk, p - q0);
      float acc[kChunk][VEC];
#pragma unroll
      for (int b = 0; b < kChunk; ++b) {
#pragma unroll
        for (int q = 0; q < VEC; ++q) acc[b][q] = 0.0f;
      }
      int u = 0;
      for (; u + NR <= nrows; u += NR) {
        add_rows<VEC, NR>(t, u, f, row_elems, coff, wxr, ncol, q0, nq, pol, acc);
      }
      for (; u < nrows; ++u) {
        add_rows<VEC, 1>(t, u, f, row_elems, coff, wxr, ncol, q0, nq, pol, acc);
      }
#pragma unroll
      for (int b = 0; b < kChunk; ++b) {
        if (b >= nq) break;
#pragma unroll
        for (int q = 0; q < VEC; ++q) acc[b][q] *= inv;
#if K1_ABLATE == 2
        if (__float_as_uint(acc[b][0]) != (unsigned)r * 2654435761u) continue;
#endif
        store_out(o + ((size_t)(q0 + b) * p + px) * c + ch, acc[b]);
      }
    }
  }
}

template <typename T, int VEC>
int launch(const void* feat, const void* boxes, void* out, int n, int h, int w, int c, int r,
           int p, int s, float scale, cudaStream_t st) {
  const int cv = c / VEC;
  const int slices = (cv + kSlice - 1) / kSlice;
  const int per = (cv + slices - 1) / slices;
  const int items = p * per;
  // at least two warps: the (7, 2) tables take one each
  const int threads = items < kThreads ? ((items + 31) / 32 > 2 ? (items + 31) / 32 * 32 : 64)
                                       : kThreads;
  const dim3 grid((unsigned)(n * r * slices));
  if (p == 7 && s == 2) {
    roi_align_fwd_kernel<T, VEC, 7, 2, 2><<<grid, threads, 0, st>>>(
        (const T*)feat, (const float*)boxes, (T*)out, h, w, c, r, p, s, scale, slices);
  } else {
    roi_align_fwd_kernel<T, VEC, 0, 0, 1><<<grid, threads, 0, st>>>(
        (const T*)feat, (const float*)boxes, (T*)out, h, w, c, r, p, s, scale, slices);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

const char* pt_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

// feat (N, H, W, C) NHWC contiguous, dtype 0 = f32, 1 = bf16; boxes (N, R, 4) f32
// XYXY in image coordinates; out (N, R, p, p, C) in the feature dtype. C must be
// a multiple of 16 bytes' worth of elements and both tensors 16-byte aligned
// (the wrapper checks); p * s <= 64, s <= 4. Returns cudaGetLastError() after
// the launch.
int pt_roi_align_fwd(const void* feat, const void* boxes, void* out, int n, int h, int w,
                     int c, int r, int p, int s, float scale, int dtype, void* stream) {
  if (p < 1 || s < 1 || s > kMaxS || p * s > kMaxPS || h < 1 || w < 1 || c < 1) {
    return (int)cudaErrorInvalidValue;
  }
  if (n * r == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0 && c % 4 == 0) {
    return launch<float, 4>(feat, boxes, out, n, h, w, c, r, p, s, scale, st);
  }
  if (dtype == 1 && c % 8 == 0) {
    return launch<__nv_bfloat16, 8>(feat, boxes, out, n, h, w, c, r, p, s, scale, st);
  }
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
