// ROIAlign backward, d features (aligned=True, fixed s x s sampling), for Hopper
// (sm_90a).
//
// Replaces the TPU kernel probabilisticteacher_tpu/ops/roi_align_pallas.py:228
// (`_bwd_kernel`, launched by `_bwd_pallas`), and computes the same function as
// the einsum VJP `_bwd_einsum` (roi_align_pallas.py:168-184):
//   dF[n,h,w,c] = sum_r sum_q sum_x Wy[n,r,q,h] g[n,r,q,x,c] Wx[n,r,x,w].
// Boxes get no gradient. The TPU kernel contracts dense Wy/Wx blocks on the
// matrix unit; each of their rows holds at most 2*s non-zeros out of H or W, so
// this kernel scatters instead:
//
// - one block per ROI, blocks ordered image-major (block = n*R + r);
// - threads 0..2p-1 first build, per axis and output bin, the <= 2s distinct
//   map rows (columns) the bin touches and their weights: the s-sample mean of
//   the 2-tap bilinear weights, rounded to the feature dtype, exactly as
//   `_pool_matrices` (roi_align_pallas.py:151-158) builds Wy/Wx. The sample
//   coordinates use the explicitly rounded arithmetic of roi_align_fwd.cu, so
//   they equal the plain PyTorch version's bit for bit, and indices are
//   clamped, so no box (off the map, degenerate, non-finite) touches memory
//   outside its image;
// - threads then run over (bin, 4-channel vector) pairs: each reads its 4
//   values of g (already in the feature dtype) and adds Wy*Wx*g into an f32
//   scratch (N, H, W, C) at the <= (2s)^2 taps of the bin, with one vector
//   atomicAdd of 4 floats per tap (scalar atomics on toolkits before 12.1).
//   A zero g vector (the rows of padded ROIs, masked by the losses) adds nothing
//   and is skipped;
// - for bf16 features a second kernel casts the scratch to bf16 once; for f32
//   the scratch is the output.
//
// The atomics make the order of the f32 additions, and so the last bits of dF,
// change from run to run: dF is not bitwise reproducible. The plain version
// rounds its intermediate to the feature dtype, this kernel does not, so the two
// agree within a tolerance, not bit for bit.
//
// What bounds it: at the recipe's student shape (48 x 512 ROIs on 48 x 38x84x512
// bf16) the function reads g (1.23 GB) and writes dF (0.16 GB); the 16 taps x
// (mul + add) per channel and bin are 0.02 TFLOP, so bytes bound it. The f32
// scratch (0.31 GB, zeroed, then read by the cast) is a cost of this design, not
// of the function. About 512 ROIs of one image add into one 38x84 map, so the
// atomics contend in L2: that, not HBM, is what this simple design meets first.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kMaxS = 4;             // samples per bin and axis
constexpr int kMaxTaps = 2 * kMaxS;  // distinct rows (columns) one bin touches
constexpr int kMaxBins = 32;         // p
constexpr int kThreads = 256;

struct BinTaps {
  int idx[kMaxTaps];
  float w[kMaxTaps];
  int count;
};

__device__ __forceinline__ void load4(const float* p, float (&v)[4]) {
  const float4 x = *reinterpret_cast<const float4*>(p);
  v[0] = x.x; v[1] = x.y; v[2] = x.z; v[3] = x.w;
}

__device__ __forceinline__ void load4(const __nv_bfloat16* p, float (&v)[4]) {
  const uint2 x = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&x);
  const float2 a = __bfloat1622float2(h[0]);
  const float2 b = __bfloat1622float2(h[1]);
  v[0] = a.x; v[1] = a.y; v[2] = b.x; v[3] = b.y;
}

__device__ __forceinline__ float round_to(float x, int is_bf16) {
  return is_bf16 ? __bfloat162float(__float2bfloat16_rn(x)) : x;
}

__device__ __forceinline__ void atomic_add4(float* dst, const float (&v)[4]) {
#if (__CUDACC_VER_MAJOR__ > 12) || (__CUDACC_VER_MAJOR__ == 12 && __CUDACC_VER_MINOR__ >= 1)
  atomicAdd(reinterpret_cast<float4*>(dst), make_float4(v[0], v[1], v[2], v[3]));
#else
  atomicAdd(dst, v[0]); atomicAdd(dst + 1, v[1]); atomicAdd(dst + 2, v[2]);
  atomicAdd(dst + 3, v[3]);
#endif
}

// The bin's distinct taps along one axis: the rules of `_sample_points` and
// `_interp_matrix` (ops/roi_align.py:101-128), then the mean over the s samples.
__device__ void bin_taps(float lo_in, float hi_in, float scale, int q, int p, int s, int size,
                         int is_bf16, BinTaps* out) {
  const float lo = __fsub_rn(__fmul_rn(lo_in, scale), 0.5f);
  const float hi = __fsub_rn(__fmul_rn(hi_in, scale), 0.5f);
  const float bin = __fdiv_rn(__fsub_rn(hi, lo), (float)p);
  int i0[kMaxS], i1[kMaxS];
  float w0[kMaxS], w1[kMaxS];
  for (int j = 0; j < s; ++j) {
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
  for (int j = 0; j < s; ++j) {
    for (int t = 0; t < 2; ++t) {
      const int row = t == 0 ? i0[j] : i1[j];
      bool seen = false;
      for (int m = 0; m < count; ++m) seen |= out->idx[m] == row;
      if (seen) continue;
      // Wy[q, row] = mean_j (w0_j [i0_j == row] + w1_j [i1_j == row]), in the dtype
      float sum = 0.0f;
      for (int k = 0; k < s; ++k) {
        const float v = __fadd_rn(i0[k] == row ? w0[k] : 0.0f, i1[k] == row ? w1[k] : 0.0f);
        sum = __fadd_rn(sum, v);
      }
      const float wgt = round_to(__fdiv_rn(sum, (float)s), is_bf16);
      out->idx[count] = row;
      out->w[count] = wgt;
      ++count;
    }
  }
  out->count = count;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
roi_align_bwd_kernel(const T* __restrict__ g, const float* __restrict__ boxes,
                     float* __restrict__ scratch, int h, int w, int c, int r, int p, int s,
                     float scale, int is_bf16) {
  __shared__ BinTaps taps[2][kMaxBins];  // [0] = rows (y), [1] = columns (x)
  const int roi = blockIdx.x;            // n * R + r: image-major
  const int n = roi / r;

  if (threadIdx.x < 2 * p) {
    const int axis = threadIdx.x / p;  // 0: y from (y1, y2); 1: x from (x1, x2)
    const int q = threadIdx.x % p;
    const float* b = boxes + (size_t)roi * 4;
    bin_taps(b[axis == 0 ? 1 : 0], b[axis == 0 ? 3 : 2], scale, q, p, s,
             axis == 0 ? h : w, is_bf16, &taps[axis][q]);
  }
  __syncthreads();

  const int cv = c / 4;
  const T* gr = g + (size_t)roi * p * p * c;
  float* f = scratch + (size_t)n * h * w * c;

  for (int idx = threadIdx.x; idx < p * p * cv; idx += blockDim.x) {
    const int bin = idx / cv;
    const int ch = (idx - bin * cv) * 4;
    float gv[4];
    load4(gr + (size_t)bin * c + ch, gv);
    if (gv[0] == 0.0f && gv[1] == 0.0f && gv[2] == 0.0f && gv[3] == 0.0f) continue;
    const BinTaps& ty = taps[0][bin / p];
    const BinTaps& tx = taps[1][bin % p];
    for (int a = 0; a < ty.count; ++a) {
      if (ty.w[a] == 0.0f) continue;
      float* row = f + (size_t)ty.idx[a] * w * c + ch;
      for (int b = 0; b < tx.count; ++b) {
        const float wt = ty.w[a] * tx.w[b];
        if (wt == 0.0f) continue;
        const float v[4] = {wt * gv[0], wt * gv[1], wt * gv[2], wt * gv[3]};
        atomic_add4(row + (size_t)tx.idx[b] * c, v);
      }
    }
  }
}

__global__ void cast_bf16_kernel(const float* __restrict__ src, __nv_bfloat16* __restrict__ dst,
                                 size_t n4) {
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < n4;
       i += (size_t)gridDim.x * blockDim.x) {
    const float4 x = reinterpret_cast<const float4*>(src)[i];
    __nv_bfloat162 lo = __floats2bfloat162_rn(x.x, x.y);
    __nv_bfloat162 hi = __floats2bfloat162_rn(x.z, x.w);
    uint2 o;
    o.x = *reinterpret_cast<uint32_t*>(&lo);
    o.y = *reinterpret_cast<uint32_t*>(&hi);
    reinterpret_cast<uint2*>(dst)[i] = o;
  }
}

}  // namespace

extern "C" {

const char* pt_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

// g (N, R, p, p, C) in the feature dtype (0 = f32, 1 = bf16); boxes (N, R, 4) f32
// XYXY in image coordinates; scratch (N, H, W, C) f32; out (N, H, W, C) in the
// feature dtype: for f32, out must be the scratch itself. C must be a multiple of
// 4, every pointer 16-byte aligned (the wrapper checks). Zeroes the scratch,
// scatters, and casts, all on `stream`; returns cudaGetLastError().
int pt_roi_align_bwd(const void* g, const void* boxes, void* scratch, void* out, int n, int h,
                     int w, int c, int r, int p, int s, float scale, int dtype, void* stream) {
  if (p > kMaxBins || s > kMaxS || s < 1 || 2 * p > kThreads || c % 4 ||
      (dtype == 0 && out != scratch)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = (cudaStream_t)stream;
  const size_t elems = (size_t)n * h * w * c;
  cudaError_t err = cudaMemsetAsync(scratch, 0, elems * sizeof(float), st);
  if (err != cudaSuccess) return (int)err;
  if (n * r > 0) {
    const dim3 grid((unsigned)(n * r));
    if (dtype == 0) {
      roi_align_bwd_kernel<float><<<grid, kThreads, 0, st>>>(
          (const float*)g, (const float*)boxes, (float*)scratch, h, w, c, r, p, s, scale, 0);
    } else if (dtype == 1) {
      roi_align_bwd_kernel<__nv_bfloat16><<<grid, kThreads, 0, st>>>(
          (const __nv_bfloat16*)g, (const float*)boxes, (float*)scratch, h, w, c, r, p, s,
          scale, 1);
    } else {
      return (int)cudaErrorInvalidValue;
    }
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  if (dtype == 1) {
    const size_t n4 = elems / 4;
    const unsigned blocks = (unsigned)((n4 + kThreads - 1) / kThreads < 8192
                                           ? (n4 + kThreads - 1) / kThreads : 8192);
    if (n4 > 0) {
      cast_bf16_kernel<<<blocks, kThreads, 0, st>>>((const float*)scratch,
                                                    (__nv_bfloat16*)out, n4);
    }
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
