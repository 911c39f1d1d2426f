// RoIAlign forward and backward for Hopper (sm_90a), NHWC feature maps,
// per-image ROIs.
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
//
// Backward (roi_align_bwd): replaces the f_bwd of the TPU kernel's custom
// VJP (ops/roi_align_pallas.py:146-174 there), which computes
// df[b,h,w,c] = sum_r sum_i sum_j Wy[b,r,i,h] g[b,r,i,j,c] Wx[b,r,j,w]
// as two XLA einsums in f32 and casts to the map's dtype. Here every bin's
// gradient is scattered to the corners the forward read, with the same
// sample geometry (point_geometry), by float32 atomicAdd into a zeroed
// (B, H, W, C) buffer, then cast to the map's dtype. The order of the adds
// varies from run to run, so the result is held to a relative tolerance.
// Bound: bytes (read g, write df). At the training step's sampled-ROI call
// (b12, R=128, 30x30x1024 bf16) that is 154 MB of g and 22 MB of df, about
// 53 us; but the kernel issues up to 1.2e9 atomic adds (at most 16 per bin
// and channel, fewer where the corners of a bin's sample points share a row
// or column: bin_lists merges those) onto a 30x30 map, and the atomics
// through L2 are its cost.
// Later work: accumulate each ROI's footprint (or a channel tile of it) in
// shared memory and add it to device memory once.

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

// Sample geometry of one ROI, computed once per block into shared memory:
// for each axis and each sample point k = bin * S + sample, the lower and
// upper bilinear corner and their weights (both 0 for a point outside the
// map). Threads [0, P) do the y axis, [P, 2P) the x axis.
struct Geometry {
  int lo[2][kMaxPts];
  int hi[2][kMaxPts];
  float wlo[2][kMaxPts];
  float whi[2][kMaxPts];
};

__device__ __forceinline__ void point_geometry(Geometry& s, const float* roi,
                                               int H, int W, int O, int S,
                                               float scale, int aligned) {
  const int P = O * S;  // sample points per axis
  const int t = threadIdx.x;
  if (t < 2 * P) {
    const int axis = t < P ? 0 : 1;  // 0 = y, 1 = x
    const int k = t - axis * P;      // point index = bin * S + sample
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
    s.lo[axis][k] = i0;
    s.hi[axis][k] = min(i0 + 1, size - 1);
    s.wlo[axis][k] = oob ? 0.0f : __fsub_rn(1.0f, l);
    s.whi[axis][k] = oob ? 0.0f : l;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
roi_align_fwd(const T* __restrict__ fmap, const float* __restrict__ rois,
              T* __restrict__ out, int H, int W, int C, int R, int O, int S,
              float scale, int aligned) {
  __shared__ Geometry s;

  const int b = blockIdx.z;
  const int r = blockIdx.y;
  point_geometry(s, rois + ((size_t)b * R + r) * 4, H, W, O, S, scale, aligned);
  __syncthreads();

  const int c = (blockIdx.x * kThreads + threadIdx.x) * 2;
  if (c >= C) return;
  const T* f = fmap + (size_t)b * H * W * C + c;
  T* o = out + ((size_t)b * R + r) * O * O * C + c;
  const float denom = (float)(S * S);

  for (int i = 0; i < O; ++i) {
    for (int j = 0; j < O; ++j) {
      float a0 = 0.0f, a1 = 0.0f;
      for (int sy = 0; sy < S; ++sy) {
        const int py = i * S + sy;
        const int ys[2] = {s.lo[0][py], s.hi[0][py]};
        const float wys[2] = {s.wlo[0][py], s.whi[0][py]};
        for (int sx = 0; sx < S; ++sx) {
          const int px = j * S + sx;
          const int xs[2] = {s.lo[1][px], s.hi[1][px]};
          const float wxs[2] = {s.wlo[1][px], s.whi[1][px]};
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

// Per-bin corner lists for the backward: a bin's gradient is separable,
// dout[i, j] * wy_i[h] * wx_j[w], and each axis's weights wy_i are nonzero
// on at most 2*S rows (two corners per sample point). Threads [0, O) merge
// the y axis's points of bin i into (row, weight) pairs, adding the weights
// of corners that fall on the same row and dropping zero weights; threads
// [O, 2O) do the x axis. This cuts the atomics per bin from 4*S*S to
// (distinct rows) x (distinct columns), 9 or fewer for S = 2.
struct BinLists {
  int idx[2][2 * kMaxPts];
  float w[2][2 * kMaxPts];
  int n[2][kMaxPts];
};

__device__ __forceinline__ void bin_lists(BinLists& l, const Geometry& s,
                                          int O, int S) {
  const int t = threadIdx.x;
  if (t < 2 * O) {
    const int axis = t < O ? 0 : 1;
    const int i = t - axis * O;
    int* idx = &l.idx[axis][i * 2 * S];
    float* w = &l.w[axis][i * 2 * S];
    int n = 0;
    for (int k = i * S; k < (i + 1) * S; ++k) {
      for (int corner = 0; corner < 2; ++corner) {
        const float wt = corner ? s.whi[axis][k] : s.wlo[axis][k];
        if (wt == 0.0f) continue;
        const int id = corner ? s.hi[axis][k] : s.lo[axis][k];
        int m = 0;
        while (m < n && idx[m] != id) ++m;
        if (m < n) {
          w[m] += wt;
        } else {
          idx[n] = id;
          w[n] = wt;
          ++n;
        }
      }
    }
    l.n[axis][i] = n;
  }
}

// The backward of roi_align_fwd with respect to the map: every output bin's
// gradient goes back to the corners its sample points read, with the
// forward's weights. One block per (channel tile, ROI, image), as in the
// forward; each thread owns two adjacent channels and scatters into a
// zeroed float32 (B, H, W, C) buffer with atomicAdd, since ROIs overlap and
// blocks of one image run in no order.
template <typename T>
__global__ void __launch_bounds__(kThreads)
roi_align_bwd(const T* __restrict__ dout, const float* __restrict__ rois,
              float* __restrict__ dmap, int H, int W, int C, int R, int O,
              int S, float scale, int aligned) {
  __shared__ Geometry s;
  __shared__ BinLists l;

  const int b = blockIdx.z;
  const int r = blockIdx.y;
  point_geometry(s, rois + ((size_t)b * R + r) * 4, H, W, O, S, scale, aligned);
  __syncthreads();
  bin_lists(l, s, O, S);
  __syncthreads();

  const int c = (blockIdx.x * kThreads + threadIdx.x) * 2;
  if (c >= C) return;
  const T* g = dout + ((size_t)b * R + r) * O * O * C + c;
  float* d = dmap + (size_t)b * H * W * C + c;
  const float inv = __fdiv_rn(1.0f, (float)(S * S));

  for (int i = 0; i < O; ++i) {
    const int ny = l.n[0][i];
    const int* ys = &l.idx[0][i * 2 * S];
    const float* wys = &l.w[0][i * 2 * S];
    for (int j = 0; j < O; ++j) {
      const int nx = l.n[1][j];
      if (ny == 0 || nx == 0) continue;
      const int* xs = &l.idx[1][j * 2 * S];
      const float* wxs = &l.w[1][j * 2 * S];
      const float2 v = load2(g + (size_t)(i * O + j) * C);
      const float g0 = v.x * inv, g1 = v.y * inv;
      for (int a = 0; a < ny; ++a) {
        float* row = d + (size_t)ys[a] * W * C;
        for (int e = 0; e < nx; ++e) {
          const float w = wys[a] * wxs[e];
          float* p = row + (size_t)xs[e] * C;
          atomicAdd(p, w * g0);
          atomicAdd(p + 1, w * g1);
        }
      }
    }
  }
}

// float32 -> bfloat16, two values a thread, grid-stride.
__global__ void cast_f32_bf16(const float* __restrict__ in,
                              __nv_bfloat16* __restrict__ out, size_t pairs) {
  for (size_t k = (size_t)blockIdx.x * blockDim.x + threadIdx.x; k < pairs;
       k += (size_t)gridDim.x * blockDim.x) {
    const float2 v = load2(in + 2 * k);
    store2(out + 2 * k, v.x, v.y);
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

// The map's gradient. dmap32 is a zeroed float32 (B, H, W, C) buffer the
// kernel accumulates into; for dtype 1 (bfloat16) it is then cast into dmap,
// for dtype 0 dmap must be dmap32. Returns the cudaError_t of the launches.
int fgn_roi_align_backward(const void* dout, const void* rois, void* dmap32,
                           void* dmap, int B, int H, int W, int C, int R,
                           int O, int S, float scale, int aligned, int dtype,
                           void* stream) {
  if (O * S > kMaxPts || B <= 0 || R <= 0 || H <= 0 || W <= 0 || C <= 0 ||
      (C & 1) || (dtype == 0 && dmap != dmap32)) {
    return (int)cudaErrorInvalidValue;
  }
  const dim3 grid((C / 2 + kThreads - 1) / kThreads, R, B);
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  float* acc = static_cast<float*>(dmap32);
  if (dtype == 0) {
    roi_align_bwd<float><<<grid, kThreads, 0, st>>>(
        static_cast<const float*>(dout), static_cast<const float*>(rois), acc,
        H, W, C, R, O, S, scale, aligned);
  } else if (dtype == 1) {
    roi_align_bwd<__nv_bfloat16><<<grid, kThreads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(dout),
        static_cast<const float*>(rois), acc, H, W, C, R, O, S, scale,
        aligned);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    const size_t pairs = (size_t)B * H * W * C / 2;
    const size_t want = (pairs + 255) / 256;
    const int blocks = (int)(want < 4096 ? want : 4096);
    cast_f32_bf16<<<blocks, 256, 0, st>>>(
        acc, static_cast<__nv_bfloat16*>(dmap), pairs);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

const char* fgn_roi_align_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
