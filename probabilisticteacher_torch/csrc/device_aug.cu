// Strong photometric augmentation and scale jitter of the train steps, for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package's data/device_aug.py runs these ops as
// XLA-fused array code, with no Pallas kernel. The port's plain PyTorch version
// (probabilisticteacher_torch/data/device_aug.py, kept for CPU tensors) ran every op
// on every image and kept the gated ones with torch.where: about 150 launches per
// strong_augment and 40 per scale_jitter, the four jitter ops computed at each of the
// four order positions. On the card these three kernels do the same work in three
// launches per strong_augment + scale_jitter pair, and nothing waits on the host.
//
// Semantics, which each output reproduces op for op (images NHWC, 3 channels,
// values in 0..255, T = f32 or bf16, "rounded" = rounded to T as one PyTorch
// elementwise op on T rounds its f32 result):
//   - color jitter (gate p .8): brightness, contrast, saturation, hue in the image's
//     own order. blend(a, b, r) = clamp(rnd(rnd(rT a) + rnd((1 - r)T b)), 0, 255)
//     with b = 0 (brightness), the image's mean gray level (contrast), the pixel's
//     gray level (saturation); hue an HSV round trip in f32 on x / 255 (x times
//     f32(1/255), as PyTorch's CUDA division by a scalar computes it), rounded once;
//   - gray level: the dot with the luma weights rounded to T, in f32, rounded;
//     contrast's mean: the gray levels of the whole canvas summed in f32, times
//     f32(N) / f32(N H W) (PyTorch's mean), rounded;
//   - grayscale (p .2); Gaussian blur (p .5): 13 taps exp(-x^2 / (2 sigma^2)) in
//     f32 over their sum, rounded; a horizontal then a vertical pass, each summed in
//     f32 tap by tap with fused multiply-adds (the order of PyTorch's depthwise
//     convolution kernel) and rounded, zero padding at the canvas edge; solarize
//     (p .2): x >= 128 -> rnd(255 - x);
//   - scale jitter: the bilinear resampling of data/device_aug.py::scale_jitter_plain,
//     coordinates in f32, weights and every product and sum rounded, pixel_mean
//     outside the shrunk area.
// A gate that is closed for an image skips its op for that image: the closed op is
// not computed. The file is built with -fmad=false, so that no multiply and add
// that PyTorch rounds apart get fused; the fused multiply-adds above are explicit.
// What may differ from the plain version is the order of the contrast mean's sum
// (and of the luma dot and the taps' sum, if PyTorch orders them otherwise): a
// value next to a rounding boundary of T can then round the other way.
//
// Design:
//   1. aug_gray_sums_kernel: for each image whose jitter gate is open, the gray
//      levels of the image as contrast finds it (the jitter ops before contrast in
//      its order applied to each pixel), summed in f32 per block into kParts
//      partials an image, in a fixed order: no atomics, the same bits every run.
//   2. aug_color_kernel: one block per 32 x 32 output tile. Each block sums its
//      image's partials in a fixed order (every block gets the same mean), applies
//      the jitter ops in the image's order and the grayscale gate to each pixel of
//      the tile and its 6-pixel halo into shared memory, blurs (horizontal pass of
//      the halo rows into shared memory, then the vertical pass) where the blur gate
//      is open, solarizes where its gate is open, and writes the tile. Without blur
//      a block takes only its tile, no halo and no shared memory.
//   3. aug_scale_jitter_kernel: one thread per output pixel, its four taps gathered
//      from the augmented image (L1/L2 serve the overlap).
// The gates, factors, order, sigma and ratios are read on the device from the
// draws' tensors; the pixel mean and the luma weights come as kernel arguments.
//
// What bounds it: bytes. Per strong_augment + scale_jitter pair on N images of
// H x W: the input read once (uint8, 3 B a pixel; the prepass reads it again for
// the images whose jitter gate is open), the augmented image written and read once,
// the jittered image written: at N = 16, 608 x 1344 and bf16, 39 + 78 + 78 + 78 MB,
// 0.08 ms at 3.35 TB/s. The halo's recomputed color ops (1.9x the tile's) and the
// HSV round trip's f32 divisions are far below the card's f32 rate.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRadius = 6;                    // BLUR_TAPS = 13
constexpr int kTaps = 2 * kRadius + 1;
constexpr int kTile = 32;                     // color pass: 32 x 32 output pixels a block
constexpr int kHalo = kTile + 2 * kRadius;    // the tile with its halo: 44 x 44
constexpr int kThreads = 256;
constexpr int kJitterThreads = 128;
constexpr unsigned kAll = 0xffffffffu;

struct Luma {
  float w[3];
};

struct Gates {
  float jitter, gray, blur, solarize;
};

// x rounded to T, as a float
template <typename T>
__device__ __forceinline__ float rnd(float x);
template <>
__device__ __forceinline__ float rnd<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ float rnd<__nv_bfloat16>(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ float to_f(uint8_t v) { return (float)v; }
__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

__device__ __forceinline__ float clamp255(float v) { return fminf(fmaxf(v, 0.0f), 255.0f); }

// torch.remainder(a, 1.0) in f32: fmod, moved into [0, 1)
__device__ __forceinline__ float remainder1(float a) {
  float m = fmodf(a, 1.0f);
  if (m != 0.0f && m < 0.0f) m += 1.0f;
  return m;
}

template <typename T>
__device__ __forceinline__ float gray(const float x[3], const Luma& luma) {
  return rnd<T>(fmaf(x[2], luma.w[2], fmaf(x[1], luma.w[1], x[0] * luma.w[0])));
}

// One image's jitter: the op at each position, and each op's numbers in T
struct Jitter {
  int order[4];      // 0 brightness, 1 contrast, 2 saturation, 3 hue
  int contrast_at;   // contrast's position in order
  float r[3];        // brightness, contrast, saturation factor, rounded to T
  float om[3];       // 1 - factor, in f32 then rounded to T
  float hue;         // hue delta, f32
  float contrast_b;  // rnd((1 - c)T * mean), contrast's second term (color pass only)
};

template <typename T>
__device__ __forceinline__ Jitter load_jitter(int n, const float* factors, const long long* order) {
  Jitter j;
  j.contrast_at = 0;
  for (int t = 0; t < 4; ++t) {
    j.order[t] = (int)order[n * 4 + t];
    if (j.order[t] == 1) j.contrast_at = t;
  }
  for (int o = 0; o < 3; ++o) {
    const float f = factors[n * 4 + o];
    j.r[o] = rnd<T>(f);
    j.om[o] = rnd<T>(1.0f - f);
  }
  j.hue = factors[n * 4 + 3];
  j.contrast_b = 0.0f;
  return j;
}

// data/device_aug.py::adjust_hue on one pixel
template <typename T>
__device__ __forceinline__ void adjust_hue(float x[3], float delta) {
  const float inv255 = 1.0f / 255.0f;
  const float r = x[0] * inv255, g = x[1] * inv255, b = x[2] * inv255;
  const float maxc = fmaxf(fmaxf(r, g), b), minc = fminf(fminf(r, g), b);
  const float deltac = maxc - minc;
  const float s = maxc > 0.0f ? deltac / maxc : 0.0f;
  const float dc = deltac > 0.0f ? deltac : 1.0f;
  const float rc = (maxc - r) / dc, gc = (maxc - g) / dc, bc = (maxc - b) / dc;
  float h = maxc == r ? bc - gc : (maxc == g ? (2.0f + rc) - bc : (4.0f + gc) - rc);
  h = deltac > 0.0f ? remainder1(h * (1.0f / 6.0f)) : 0.0f;
  h = remainder1(h + delta);
  const float h6 = h * 6.0f;
  const float fi = floorf(h6);
  const float f = h6 - fi;
  const int i = (int)fi % 6;   // fi is in [0, 6]
  const float v = maxc;
  const float p = v * (1.0f - s);
  const float q = v * (1.0f - f * s);
  const float t = v * (1.0f - (1.0f - f) * s);
  float o[3];
  switch (i) {
    case 0: o[0] = v; o[1] = t; o[2] = p; break;
    case 1: o[0] = q; o[1] = v; o[2] = p; break;
    case 2: o[0] = p; o[1] = v; o[2] = t; break;
    case 3: o[0] = p; o[1] = q; o[2] = v; break;
    case 4: o[0] = t; o[1] = p; o[2] = v; break;
    default: o[0] = v; o[1] = p; o[2] = q; break;
  }
  for (int c = 0; c < 3; ++c) x[c] = rnd<T>(clamp255(o[c] * 255.0f));
}

// The jitter ops at positions [from, to) of the image's order, on one pixel
template <typename T>
__device__ __forceinline__ void jitter_ops(float x[3], const Jitter& j, int from, int to,
                                           const Luma& luma) {
  for (int t = from; t < to; ++t) {
    switch (j.order[t]) {
      case 0:   // brightness: the second term is (1 - b) * 0
        for (int c = 0; c < 3; ++c) x[c] = clamp255(rnd<T>(j.r[0] * x[c]));
        break;
      case 1:
        for (int c = 0; c < 3; ++c) x[c] = clamp255(rnd<T>(rnd<T>(j.r[1] * x[c]) + j.contrast_b));
        break;
      case 2: {
        const float b = rnd<T>(j.om[2] * gray<T>(x, luma));
        for (int c = 0; c < 3; ++c) x[c] = clamp255(rnd<T>(rnd<T>(j.r[2] * x[c]) + b));
        break;
      }
      default:
        adjust_hue<T>(x, j.hue);
        break;
    }
  }
}

template <typename U>
__device__ __forceinline__ void load_pixel(const U* p, float x[3]) {
  x[0] = to_f(p[0]);
  x[1] = to_f(p[1]);
  x[2] = to_f(p[2]);
}

// 1. Per image with its jitter gate open: kParts partial sums of the gray level of
// the image as contrast finds it. Grid (parts, N).
template <typename U, typename T>
__global__ void __launch_bounds__(kThreads)
    aug_gray_sums_kernel(const U* __restrict__ in, float* __restrict__ parts, int hw,
                         const float* __restrict__ gates, const float* __restrict__ factors,
                         const long long* __restrict__ order, Luma luma, float gate_jitter) {
  const int n = blockIdx.y;
  if (!(gates[n * 4] < gate_jitter)) return;   // block-uniform: no barrier is skipped
  const Jitter j = load_jitter<T>(n, factors, order);
  const long long chunk = ((long long)hw + gridDim.x - 1) / gridDim.x;
  const long long start = (long long)blockIdx.x * chunk;
  const long long end = min(start + chunk, (long long)hw);
  const U* img = in + (long long)n * hw * 3;
  float acc = 0.0f;
  for (long long p = start + threadIdx.x; p < end; p += kThreads) {
    float x[3];
    load_pixel(img + p * 3, x);
    jitter_ops<T>(x, j, 0, j.contrast_at, luma);
    acc += gray<T>(x, luma);
  }
  __shared__ float warp_sums[kThreads / 32];
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_down_sync(kAll, acc, off);
  if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = acc;
  __syncthreads();
  if (threadIdx.x == 0) {
    float total = 0.0f;
    for (int i = 0; i < kThreads / 32; ++i) total += warp_sums[i];
    parts[(long long)n * gridDim.x + blockIdx.x] = total;
  }
}

// 2. Color jitter, grayscale, blur and solarize of one 32 x 32 tile. Grid
// (ceil(W / 32), ceil(H / 32), N).
template <typename U, typename T>
__global__ void __launch_bounds__(kThreads)
    aug_color_kernel(const U* __restrict__ in, T* __restrict__ out, int h, int w,
                     const float* __restrict__ gates, const float* __restrict__ factors,
                     const long long* __restrict__ order, const float* __restrict__ sigma,
                     const float* __restrict__ parts, int n_parts, float mean_factor, Luma luma,
                     Gates gp) {
  __shared__ float s_in[kHalo * kHalo * 3];    // colored tile and halo, 23 KB
  __shared__ float s_h[kHalo * kTile * 3];     // after the horizontal pass, 16.5 KB
  __shared__ float s_taps[kTaps];
  __shared__ float s_contrast_b;
  const int n = blockIdx.z;
  const int tid = threadIdx.x;
  const float* g = gates + n * 4;
  const bool jitter = g[0] < gp.jitter, grayscale = g[1] < gp.gray;
  const bool blur = g[2] < gp.blur, solarize = g[3] < gp.solarize;
  Jitter j = load_jitter<T>(n, factors, order);
  if (jitter && tid < 32) {   // the image's mean gray level, the same sum in every block
    float v = 0.0f;
    for (int i = tid; i < n_parts; i += 32) v += parts[(long long)n * n_parts + i];
    for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kAll, v, off);
    if (tid == 0) s_contrast_b = rnd<T>(j.om[1] * rnd<T>(v * mean_factor));
  }
  if (blur && tid < kTaps) {
    const float s = sigma[n];
    const float x = (float)(tid - kRadius);
    s_taps[tid] = expf(-(x * x) / (2.0f * (s * s)));
  }
  __syncthreads();
  if (jitter) j.contrast_b = s_contrast_b;
  float tap = 0.0f;
  if (blur && tid < kTaps) {
    float sum = 0.0f;
    for (int i = 0; i < kTaps; ++i) sum += s_taps[i];
    tap = rnd<T>(s_taps[tid] / sum);
  }
  __syncthreads();
  if (blur && tid < kTaps) s_taps[tid] = tap;

  const int x0 = blockIdx.x * kTile, y0 = blockIdx.y * kTile;
  const U* img = in + (long long)n * h * w * 3;
  T* dst = out + (long long)n * h * w * 3;
  auto color = [&](int y, int x, float v[3]) {
    load_pixel(img + ((long long)y * w + x) * 3, v);
    if (jitter) jitter_ops<T>(v, j, 0, 4, luma);
    if (grayscale) v[0] = v[1] = v[2] = gray<T>(v, luma);
  };
  auto store = [&](int y, int x, float v[3]) {
    T* o = dst + ((long long)y * w + x) * 3;
    for (int c = 0; c < 3; ++c) {
      float u = v[c];
      if (solarize && u >= 128.0f) u = rnd<T>(255.0f - u);
      o[c] = from_f<T>(u);
    }
  };

  if (!blur) {   // block-uniform
    for (int p = tid; p < kTile * kTile; p += kThreads) {
      const int y = y0 + p / kTile, x = x0 + p % kTile;
      if (y >= h || x >= w) continue;
      float v[3];
      color(y, x, v);
      store(y, x, v);
    }
    return;
  }
  for (int p = tid; p < kHalo * kHalo; p += kThreads) {
    const int y = y0 - kRadius + p / kHalo, x = x0 - kRadius + p % kHalo;
    float v[3] = {0.0f, 0.0f, 0.0f};   // zero padding outside the canvas
    if (y >= 0 && y < h && x >= 0 && x < w) color(y, x, v);
    for (int c = 0; c < 3; ++c) s_in[p * 3 + c] = v[c];
  }
  __syncthreads();
  for (int p = tid; p < kHalo * kTile; p += kThreads) {   // horizontal pass
    const int r = p / kTile, c = p % kTile;
    const float* row = s_in + (r * kHalo + c) * 3;
    for (int ch = 0; ch < 3; ++ch) {
      float acc = 0.0f;
      for (int i = 0; i < kTaps; ++i) acc = fmaf(s_taps[i], row[i * 3 + ch], acc);
      s_h[p * 3 + ch] = rnd<T>(acc);
    }
  }
  __syncthreads();
  for (int p = tid; p < kTile * kTile; p += kThreads) {   // vertical pass
    const int r = p / kTile, c = p % kTile;
    const int y = y0 + r, x = x0 + c;
    if (y >= h || x >= w) continue;
    const float* col = s_h + (r * kTile + c) * 3;
    float v[3];
    for (int ch = 0; ch < 3; ++ch) {
      float acc = 0.0f;
      for (int i = 0; i < kTaps; ++i) acc = fmaf(s_taps[i], col[i * kTile * 3 + ch], acc);
      v[ch] = rnd<T>(acc);
    }
    store(y, x, v);
  }
}

// 3. Scale jitter: each image shrunk by its ratio into the center of its valid
// (h, w), bilinear with half-pixel centers, pixel_mean elsewhere. Grid
// (ceil(W / 128), H, N).
template <typename T>
__global__ void __launch_bounds__(kJitterThreads)
    aug_scale_jitter_kernel(const T* __restrict__ in, T* __restrict__ out, int h, int w,
                            const float* __restrict__ image_hw, const float* __restrict__ ratio,
                            float mean0, float mean1, float mean2) {
  const int x = blockIdx.x * kJitterThreads + threadIdx.x;
  const int y = blockIdx.y, n = blockIdx.z;
  if (x >= w) return;
  const float ih = image_hw[n * 2], iw = image_hw[n * 2 + 1], r = ratio[n];
  const float dh = floorf(ih * r), dw = floorf(iw * r);
  const float y1 = floorf((ih - dh) * 0.5f), x1 = floorf((iw - dw) * 0.5f);
  const float fy = (float)y, fx = (float)x;
  T* o = out + (((long long)n * h + y) * w + x) * 3;
  if (!(fy >= y1 && fy < y1 + dh && fx >= x1 && fx < x1 + dw)) {
    o[0] = from_f<T>(rnd<T>(mean0));
    o[1] = from_f<T>(rnd<T>(mean1));
    o[2] = from_f<T>(rnd<T>(mean2));
    return;
  }
  const float ys = ((fy - y1) + 0.5f) * (ih / fmaxf(dh, 1.0f)) - 0.5f;
  const float xs = ((fx - x1) + 0.5f) * (iw / fmaxf(dw, 1.0f)) - 0.5f;
  const float yf = floorf(ys), xf = floorf(xs);
  const float wy = rnd<T>(ys - yf), wx = rnd<T>(xs - xf);
  const float ay = rnd<T>(1.0f - wy), ax = rnd<T>(1.0f - wx);
  const int ya = min(max((int)yf, 0), h - 1), yb = min(max((int)yf + 1, 0), h - 1);
  const int xa = min(max((int)xf, 0), w - 1), xb = min(max((int)xf + 1, 0), w - 1);
  const T* img = in + (long long)n * h * w * 3;
  const T* p00 = img + ((long long)ya * w + xa) * 3;
  const T* p01 = img + ((long long)ya * w + xb) * 3;
  const T* p10 = img + ((long long)yb * w + xa) * 3;
  const T* p11 = img + ((long long)yb * w + xb) * 3;
  for (int c = 0; c < 3; ++c) {
    const float a = rnd<T>(rnd<T>(to_f(p00[c]) * ay) * ax);
    const float b = rnd<T>(rnd<T>(to_f(p01[c]) * ay) * wx);
    const float d = rnd<T>(rnd<T>(to_f(p10[c]) * wy) * ax);
    const float e = rnd<T>(rnd<T>(to_f(p11[c]) * wy) * wx);
    o[c] = from_f<T>(rnd<T>(rnd<T>(rnd<T>(a + b) + d) + e));
  }
}

template <typename U, typename T>
int launch_gray_sums(const void* in, void* parts, int n, int h, int w, int n_parts,
                     const void* gates, const void* factors, const void* order, Luma luma,
                     float gate_jitter, cudaStream_t stream) {
  aug_gray_sums_kernel<U, T><<<dim3(n_parts, n), kThreads, 0, stream>>>(
      (const U*)in, (float*)parts, h * w, (const float*)gates, (const float*)factors,
      (const long long*)order, luma, gate_jitter);
  return (int)cudaGetLastError();
}

template <typename U, typename T>
int launch_color(const void* in, void* out, int n, int h, int w, const void* gates,
                 const void* factors, const void* order, const void* sigma, const void* parts,
                 int n_parts, float mean_factor, Luma luma, Gates gp, cudaStream_t stream) {
  const dim3 grid((w + kTile - 1) / kTile, (h + kTile - 1) / kTile, n);
  aug_color_kernel<U, T><<<grid, kThreads, 0, stream>>>(
      (const U*)in, (T*)out, h, w, (const float*)gates, (const float*)factors,
      (const long long*)order, (const float*)sigma, (const float*)parts, n_parts, mean_factor,
      luma, gp);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_scale_jitter(const void* in, void* out, int n, int h, int w, const void* image_hw,
                        const void* ratio, float mean0, float mean1, float mean2,
                        cudaStream_t stream) {
  const dim3 grid((w + kJitterThreads - 1) / kJitterThreads, h, n);
  aug_scale_jitter_kernel<T><<<grid, kJitterThreads, 0, stream>>>(
      (const T*)in, (T*)out, h, w, (const float*)image_hw, (const float*)ratio, mean0, mean1,
      mean2);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

const char* pt_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

// in (N, H, W, 3): uint8 when in_u8, else of the compute type (bf16 when bf16, else
// f32); parts (N, n_parts) f32 out; gates, factors (N, 4) f32; order (N, 4) int64.
// Fills the partials of the images whose gates[:, 0] < gate_jitter.
int pt_aug_gray_sums(const void* in, int in_u8, int bf16, void* parts, int n, int h, int w,
                     int n_parts, const void* gates, const void* factors, const void* order,
                     float luma0, float luma1, float luma2, float gate_jitter, void* stream) {
  const Luma luma = {{luma0, luma1, luma2}};
  const cudaStream_t s = (cudaStream_t)stream;
  if (bf16)
    return in_u8 ? launch_gray_sums<uint8_t, __nv_bfloat16>(in, parts, n, h, w, n_parts, gates,
                                                            factors, order, luma, gate_jitter, s)
                 : launch_gray_sums<__nv_bfloat16, __nv_bfloat16>(
                       in, parts, n, h, w, n_parts, gates, factors, order, luma, gate_jitter, s);
  return in_u8 ? launch_gray_sums<uint8_t, float>(in, parts, n, h, w, n_parts, gates, factors,
                                                  order, luma, gate_jitter, s)
               : launch_gray_sums<float, float>(in, parts, n, h, w, n_parts, gates, factors,
                                                order, luma, gate_jitter, s);
}

// in as above; out (N, H, W, 3) of the compute type; sigma (N,) f32; parts as
// pt_aug_gray_sums left them; mean_factor f32(N) / f32(N H W).
int pt_aug_color(const void* in, int in_u8, int bf16, void* out, int n, int h, int w,
                 const void* gates, const void* factors, const void* order, const void* sigma,
                 const void* parts, int n_parts, float mean_factor, float luma0, float luma1,
                 float luma2, float gate_jitter, float gate_gray, float gate_blur,
                 float gate_solarize, void* stream) {
  const Luma luma = {{luma0, luma1, luma2}};
  const Gates gp = {gate_jitter, gate_gray, gate_blur, gate_solarize};
  const cudaStream_t s = (cudaStream_t)stream;
  if (bf16)
    return in_u8 ? launch_color<uint8_t, __nv_bfloat16>(in, out, n, h, w, gates, factors, order,
                                                        sigma, parts, n_parts, mean_factor,
                                                        luma, gp, s)
                 : launch_color<__nv_bfloat16, __nv_bfloat16>(in, out, n, h, w, gates, factors,
                                                              order, sigma, parts, n_parts,
                                                              mean_factor, luma, gp, s);
  return in_u8 ? launch_color<uint8_t, float>(in, out, n, h, w, gates, factors, order, sigma,
                                              parts, n_parts, mean_factor, luma, gp, s)
               : launch_color<float, float>(in, out, n, h, w, gates, factors, order, sigma,
                                            parts, n_parts, mean_factor, luma, gp, s);
}

// in, out (N, H, W, 3) of the compute type; image_hw (N, 2) f32; ratio (N,) f32.
int pt_aug_scale_jitter(const void* in, int bf16, void* out, int n, int h, int w,
                        const void* image_hw, const void* ratio, float mean0, float mean1,
                        float mean2, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  if (bf16)
    return launch_scale_jitter<__nv_bfloat16>(in, out, n, h, w, image_hw, ratio, mean0, mean1,
                                              mean2, s);
  return launch_scale_jitter<float>(in, out, n, h, w, image_hw, ratio, mean0, mean1, mean2, s);
}

}  // extern "C"
