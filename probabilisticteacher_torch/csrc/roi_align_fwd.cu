// ROIAlign forward (aligned=True, fixed s x s sampling) for Hopper (sm_90a).
//
// Replaces the TPU kernel probabilisticteacher_tpu/ops/roi_align_pallas.py:70
// (`_kernel`, launched by `_forward`), which contracts dense interpolation
// matrices on the matrix unit: out[n,r,y,x,c] = sum_h sum_w Wy[n,r,y,h] F[n,h,w,c]
// Wx[n,r,x,w]. Each row of Wy/Wx has at most 2*s non-zeros out of H or W, so the
// dense product does ~30x the arithmetic the 2-tap sampling needs, and one
// image's map (38x84x512 bf16 = 3.3 MB) does not fit a block's 227 KB of shared
// memory. This kernel samples instead:
//
// - one block per ROI, blocks ordered image-major (block = n*R + r), so the ROIs
//   of one image run together and its map stays in the 50 MB L2;
// - the block first computes the ROI's 2*p*s sample taps (row/column indices and
//   weights) into shared memory, with the rules of `_sample_points` and
//   `_interp_matrix` (ops/roi_align.py:101-128): out of bounds when p < -1 or
//   p > size, clip to [0, size-1], i1 = min(i0 + 1, size - 1). The coordinate
//   arithmetic uses explicitly rounded operations (no FMA contraction) so the
//   sample positions equal the plain PyTorch version's bit for bit;
// - threads then run over (bin, 16-byte channel vector) pairs: neighbouring
//   threads read neighbouring 16 bytes of the NHWC map, average the s*s bilinear
//   samples in f32, and write the bin in the feature dtype (bf16 or f32).
//
// What bounds it: bytes. At the teacher pass (8 x 2000 ROIs, 38x84x512 bf16) the
// output is 16000*49*512*2 B = 0.80 GB written against 26 MB of map read, about
// 0.25 ms at 3.35 TB/s. Each output vector gathers 16 taps from L2/L1, so L2
// bandwidth, not HBM, is the first limit this simple design meets.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kMaxSamples = 64;  // p * s per axis
constexpr int kThreads = 256;

struct Tap {
  int i0, i1;
  float w0, w1;  // zero when the sample is out of bounds
};

__device__ __forceinline__ void load16(const float* p, float (&v)[4]) {
  const float4 x = *reinterpret_cast<const float4*>(p);
  v[0] = x.x; v[1] = x.y; v[2] = x.z; v[3] = x.w;
}

__device__ __forceinline__ void load16(const __nv_bfloat16* p, float (&v)[8]) {
  const uint4 x = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&x);
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const float2 f = __bfloat1622float2(h[q]);
    v[2 * q] = f.x;
    v[2 * q + 1] = f.y;
  }
}

__device__ __forceinline__ void store16(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

__device__ __forceinline__ void store16(__nv_bfloat16* p, const float (&v)[8]) {
  uint4 x;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&x);
#pragma unroll
  for (int q = 0; q < 4; ++q) h[q] = __floats2bfloat162_rn(v[2 * q], v[2 * q + 1]);
  *reinterpret_cast<uint4*>(p) = x;
}

template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
roi_align_fwd_kernel(const T* __restrict__ feat, const float* __restrict__ boxes,
                     T* __restrict__ out, int h, int w, int c, int r, int p, int s,
                     float scale) {
  __shared__ Tap taps[2][kMaxSamples];  // [0] = y (rows), [1] = x (columns)
  const int roi = blockIdx.x;           // n * R + r: image-major
  const int n = roi / r;
  const int ps = p * s;

  if (threadIdx.x < 2 * ps) {
    const int axis = threadIdx.x / ps;  // 0: y from (y1, y2); 1: x from (x1, x2)
    const int k = threadIdx.x % ps;
    const float* b = boxes + (size_t)roi * 4;
    const float lo = __fsub_rn(__fmul_rn(b[axis == 0 ? 1 : 0], scale), 0.5f);
    const float hi = __fsub_rn(__fmul_rn(b[axis == 0 ? 3 : 2], scale), 0.5f);
    const float bin = __fdiv_rn(__fsub_rn(hi, lo), (float)p);
    const float grid_s = __fdiv_rn(__fadd_rn((float)(k % s), 0.5f), (float)s);
    const float off = __fadd_rn((float)(k / s), grid_s);
    const float v = __fadd_rn(lo, __fmul_rn(off, bin));
    const int size = axis == 0 ? h : w;
    const bool oob = (v < -1.0f) || (v > (float)size);
    const float vc = fminf(fmaxf(v, 0.0f), (float)(size - 1));
    int i0 = (int)floorf(vc);
    i0 = min(max(i0, 0), size - 1);  // memory safety for non-finite boxes
    const int i1 = min(i0 + 1, size - 1);
    const float l = __fsub_rn(vc, (float)i0);
    const float hw = __fsub_rn(1.0f, l);
    taps[axis][k] = Tap{i0, i1, oob ? 0.0f : hw, oob ? 0.0f : l};
  }
  __syncthreads();

  const int cv = c / VEC;
  const size_t row = (size_t)w * c;
  const T* f = feat + (size_t)n * h * row;
  T* o = out + (size_t)roi * p * p * c;
  const float inv = 1.0f / (float)(s * s);

  for (int idx = threadIdx.x; idx < p * p * cv; idx += blockDim.x) {
    const int bin = idx / cv;
    const int ch = (idx - bin * cv) * VEC;
    const int py = bin / p;
    const int px = bin - py * p;
    float acc[VEC];
#pragma unroll
    for (int q = 0; q < VEC; ++q) acc[q] = 0.0f;
    for (int sy = 0; sy < s; ++sy) {
      const Tap ty = taps[0][py * s + sy];
      const T* r0 = f + ty.i0 * row + ch;
      const T* r1 = f + ty.i1 * row + ch;
      for (int sx = 0; sx < s; ++sx) {
        const Tap tx = taps[1][px * s + sx];
        const float w00 = ty.w0 * tx.w0, w01 = ty.w0 * tx.w1;
        const float w10 = ty.w1 * tx.w0, w11 = ty.w1 * tx.w1;
        float v00[VEC], v01[VEC], v10[VEC], v11[VEC];
        load16(r0 + (size_t)tx.i0 * c, v00);
        load16(r0 + (size_t)tx.i1 * c, v01);
        load16(r1 + (size_t)tx.i0 * c, v10);
        load16(r1 + (size_t)tx.i1 * c, v11);
#pragma unroll
        for (int q = 0; q < VEC; ++q)
          acc[q] += v00[q] * w00 + v01[q] * w01 + v10[q] * w10 + v11[q] * w11;
      }
    }
#pragma unroll
    for (int q = 0; q < VEC; ++q) acc[q] *= inv;
    store16(o + (size_t)bin * c + ch, acc);
  }
}

}  // namespace

extern "C" {

const char* pt_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

// feat (N, H, W, C) NHWC contiguous, dtype 0 = f32, 1 = bf16; boxes (N, R, 4) f32
// XYXY in image coordinates; out (N, R, p, p, C) in the feature dtype. C must be
// a multiple of 16 bytes' worth of elements and both tensors 16-byte aligned
// (the wrapper checks). Returns cudaGetLastError() after the launch.
int pt_roi_align_fwd(const void* feat, const void* boxes, void* out, int n, int h, int w,
                     int c, int r, int p, int s, float scale, int dtype, void* stream) {
  if (p * s > kMaxSamples || 2 * p * s > kThreads) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)(n * r));
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0) {
    roi_align_fwd_kernel<float, 4><<<grid, kThreads, 0, st>>>(
        (const float*)feat, (const float*)boxes, (float*)out, h, w, c, r, p, s, scale);
  } else if (dtype == 1) {
    roi_align_fwd_kernel<__nv_bfloat16, 8><<<grid, kThreads, 0, st>>>(
        (const __nv_bfloat16*)feat, (const float*)boxes, (__nv_bfloat16*)out, h, w, c, r,
        p, s, scale);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
