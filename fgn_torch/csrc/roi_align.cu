// RoIAlign forward for Hopper (sm_90a), NHWC feature maps, per-image ROIs.
//
// Replaces the JAX package's Pallas TPU kernel
// ops/roi_align_pallas.py::roi_align_pallas (_kernel_roi_loop / _kernel).
// The TPU kernel writes RoIAlign as two dense contractions per ROI,
// out = Wy @ f @ Wx^T, to put the work on the MXU. The hat weights are
// zero outside two rows per sample point, so at a 30x30 map the dense form
// does about 10x the work of the direct form. Here the function is computed
// directly: 49 bins x 4 sample points x 4 bilinear corners per output
// channel and ROI.
//
// Bound on an H100 (3.35 TB/s): bytes. At the largest call of the episodic
// inference path (b8, R=300, 30x30x1024 bf16 map) the kernel must read the
// 14.7 MB map once and write the 241 MB output once: about 76 us. The
// arithmetic (784 multiply-adds per output channel and ROI, 2 GFLOP) is far
// below the card's rate.
//
// Design: one thread block per (channel tile, ROI, image). The block's first
// 2*O*S threads compute the ROI's sample coordinates, corner indices and
// weights once into shared memory; the weight matrices of the TPU kernel are
// never materialized. Each thread then owns two adjacent channels, so a warp
// reads 32 neighbouring channel pairs of one map position (coalesced, bf16
// pairs as __nv_bfloat162), accumulates in f32 registers and writes each
// output bin once, coalesced, in the map's dtype. The map of one image
// (1.8 MB at 30x30x1024 bf16) stays in the 50 MB L2 across its ROIs, so
// device memory sees it about once. Later work: stage map tiles in shared
// memory and share corners between neighbouring bins to cut L2 traffic.
//
// Numerics follow the reference's gather form (ops/roi_align.py there):
// sample grid i + (s + 0.5) / S, offset 0.5 when aligned, roi sides clamped
// to >= 1 when not aligned, a point with p <= -1 or p >= size counts zero,
// otherwise it is clamped to [0, size-1], floored, and its upper corner is
// min(p0 + 1, size - 1); the sum is divided by S*S. The coordinate math uses
// _rn intrinsics so nvcc cannot contract it into FMAs: the sample points are
// rounded exactly as the reference rounds them. Only the order of summation
// differs.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;  // threads per block; each owns 2 channels
constexpr int kMaxPts = 64;    // max out_size * sampling_ratio per axis

__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}

__device__ __forceinline__ float2 load2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
roi_align_fwd(const T* __restrict__ fmap, const float* __restrict__ rois,
              T* __restrict__ out, int H, int W, int C, int R, int O, int S,
              float scale, int aligned) {
  __shared__ int s_lo[2][kMaxPts];
  __shared__ int s_hi[2][kMaxPts];
  __shared__ float s_wlo[2][kMaxPts];
  __shared__ float s_whi[2][kMaxPts];

  const int b = blockIdx.z;
  const int r = blockIdx.y;
  const int P = O * S;  // sample points per axis

  // Sample geometry: threads [0, P) do the y axis, [P, 2P) the x axis.
  const int t = threadIdx.x;
  if (t < 2 * P) {
    const int axis = t < P ? 0 : 1;  // 0 = y, 1 = x
    const int k = t - axis * P;      // point index = bin * S + sample
    const float* roi = rois + ((size_t)b * R + r) * 4;
    const float offset = aligned ? 0.5f : 0.0f;
    const float lo = __fsub_rn(__fmul_rn(roi[axis == 0 ? 1 : 0], scale), offset);
    const float hi = __fsub_rn(__fmul_rn(roi[axis == 0 ? 3 : 2], scale), offset);
    float len = __fsub_rn(hi, lo);
    if (!aligned) len = fmaxf(len, 1.0f);
    const float bin = __fdiv_rn(len, (float)O);
    const float g = __fadd_rn((float)(k / S),
                              __fdiv_rn(__fadd_rn((float)(k % S), 0.5f), (float)S));
    const float p = __fadd_rn(lo, __fmul_rn(bin, g));
    const int size = axis == 0 ? H : W;
    const bool oob = (p <= -1.0f) || (p >= (float)size);
    const float pc = fminf(fmaxf(p, 0.0f), (float)(size - 1));
    const float p0 = floorf(pc);
    const float l = __fsub_rn(pc, p0);
    const int i0 = (int)p0;
    s_lo[axis][k] = i0;
    s_hi[axis][k] = min(i0 + 1, size - 1);
    s_wlo[axis][k] = oob ? 0.0f : __fsub_rn(1.0f, l);
    s_whi[axis][k] = oob ? 0.0f : l;
  }
  __syncthreads();

  const int c = (blockIdx.x * kThreads + t) * 2;
  if (c >= C) return;
  const T* f = fmap + (size_t)b * H * W * C + c;
  T* o = out + ((size_t)b * R + r) * O * O * C + c;
  const float denom = (float)(S * S);

  for (int i = 0; i < O; ++i) {
    for (int j = 0; j < O; ++j) {
      float a0 = 0.0f, a1 = 0.0f;
      for (int sy = 0; sy < S; ++sy) {
        const int py = i * S + sy;
        const int ys[2] = {s_lo[0][py], s_hi[0][py]};
        const float wys[2] = {s_wlo[0][py], s_whi[0][py]};
        for (int sx = 0; sx < S; ++sx) {
          const int px = j * S + sx;
          const int xs[2] = {s_lo[1][px], s_hi[1][px]};
          const float wxs[2] = {s_wlo[1][px], s_whi[1][px]};
#pragma unroll
          for (int cy = 0; cy < 2; ++cy) {
#pragma unroll
            for (int cx = 0; cx < 2; ++cx) {
              const float w = wys[cy] * wxs[cx];
              const float2 v = load2(f + ((size_t)ys[cy] * W + xs[cx]) * C);
              a0 += w * v.x;
              a1 += w * v.y;
            }
          }
        }
      }
      store2(o + (size_t)(i * O + j) * C, __fdiv_rn(a0, denom),
             __fdiv_rn(a1, denom));
    }
  }
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. Returns the cudaError_t of the launch.
int fgn_roi_align_forward(const void* fmap, const void* rois, void* out, int B,
                          int H, int W, int C, int R, int O, int S,
                          float scale, int aligned, int dtype, void* stream) {
  if (O * S > kMaxPts || B <= 0 || R <= 0 || C <= 0 || (C & 1)) {
    return (int)cudaErrorInvalidValue;
  }
  const dim3 grid((C / 2 + kThreads - 1) / kThreads, R, B);
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    roi_align_fwd<float><<<grid, kThreads, 0, st>>>(
        static_cast<const float*>(fmap), static_cast<const float*>(rois),
        static_cast<float*>(out), H, W, C, R, O, S, scale, aligned);
  } else if (dtype == 1) {
    roi_align_fwd<__nv_bfloat16><<<grid, kThreads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(fmap), static_cast<const float*>(rois),
        static_cast<__nv_bfloat16*>(out), H, W, C, R, O, S, scale, aligned);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

const char* fgn_roi_align_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
