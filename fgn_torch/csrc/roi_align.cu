// RoIAlign forward and backward for Hopper (sm_90a), NHWC feature maps,
// per-image ROIs.
//
// Replaces the JAX package's Pallas TPU kernel
// ops/roi_align_pallas.py::roi_align_pallas (_kernel_roi_loop / _kernel).
// The TPU kernel writes RoIAlign as two dense contractions per ROI,
// out = Wy @ f @ Wx^T, to put the work on the MXU, with the image's
// (1, H, W, CC) channel slice resident in VMEM across the ROI sweep. The
// hat weights are zero outside two rows per sample point, so at a 30x30 map
// the dense form does about 10x the work of the direct form. Here the
// function is computed directly: 49 bins x 4 sample points x 4 bilinear
// corners per output channel and ROI.
//
// Bound on an H100 (3.35 TB/s): bytes. At the largest call of the episodic
// inference path (b8, R=300, 30x30x1024 bf16 map) the kernel must read the
// 14.7 MB map once and write the 241 MB output once: about 76 us. The
// arithmetic (at most 16 multiply-adds per output element, about 4 GFLOP
// at that call) takes about 60 us at the card's 67 TFLOP/s f32 rate, under
// the byte bound; it is a gather with per-ROI weights, not a product the
// tensor cores could take.
//
// Forward, staged design (roi_align_fwd_staged, the one the model's calls
// take). Read directly from device memory, the corners of every bin and
// channel are gathers through the L2: 16 per bin and channel, 3.85 GB at
// the call above, for a 14.7 MB map. So, as the TPU kernel keeps the slice
// in VMEM, one block per (ROI group, channel tile, image) first copies the
// image's (H, W, Ct) channel slice into shared memory with cp.async, 16
// bytes a thread, and then reads every corner of its ROIs from there.
// Device memory sees the map once per ROI group (a few times in all) and
// the output once, written as 16-byte vectors in the map's dtype. The
// wrapper picks Ct (ops/roi_align_cuda.py::_channel_tile): the largest
// power of two from 8 to 128 that divides C and keeps the slice within
// about half an SM's shared memory, so two blocks fit on an SM; and the
// ROI groups (_rois_per_block), so that the grid fills the SMs about twice.
// A block walks its ROIs kRoiChunk at a time: it builds each bin's merged
// (row, weight) and (column, weight) lists (merge_corner, from the same
// sample_point as the backward, so both read exactly the same corners),
// then each thread computes one (ROI, bin, 16-byte channel vector) at a
// time as the separable sum
//   out[i, j] = sum_x wx_j[x] * (sum_y wy_i[y] * f[y, x]) / (S * S)
// over those lists, in the order of the plain version's two contractions
// (rows first): at most (2S)^2 corners per bin, 9 or fewer when the bin is
// narrower than two pixels. out_size 7 and sampling ratio 2 are
// compiled as constants so that those loops unroll; other values take a
// generic instance of the same kernel.
//
// Forward, direct design (roi_align_fwd): for maps whose slice does not
// fit in shared memory at Ct = 8 (above about 14,000 positions in bf16,
// 7,000 in f32; no map of the model comes near), whose C no tile of 8 to
// 128 channels divides, or whose data is not 16-byte aligned; the wrapper
// decides by those rules, before the launch. One block per (channel
// tile, ROI, image); the ROI's sample geometry in shared memory; each
// thread owns two adjacent channels and reads the 16 corners of every bin
// from device memory (through the L2) as __nv_bfloat162 pairs, accumulates
// in f32 registers and writes each bin once, in the map's dtype.
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
// Staged forward: 7 warps a block; with O = 7 and kRoiChunk ROIs a chunk,
// a chunk's 8 * 49 * V (ROI, bin, vector) items are a whole number of
// passes of the block for V >= 4 vectors per map position.
constexpr int kStagedThreads = 224;
constexpr int kRoiChunk = 8;        // ROIs whose bin lists a block holds
constexpr int kSmemMax = 232448;    // dynamic shared memory a block may use
constexpr int kMaxDevices = 64;

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

// 16 bytes of T (kN channels) as floats, and back with one rounding.
template <typename T>
struct Vec16;

template <>
struct Vec16<float> {
  static constexpr int kN = 4;
  __device__ __forceinline__ static void load(const unsigned char* p, float* v) {
    const float4 x = *reinterpret_cast<const float4*>(p);
    v[0] = x.x;
    v[1] = x.y;
    v[2] = x.z;
    v[3] = x.w;
  }
  __device__ __forceinline__ static void store(float* p, const float* v) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  }
};

template <>
struct Vec16<__nv_bfloat16> {
  static constexpr int kN = 8;
  // a bf16 is the upper half of the f32 of the same value
  __device__ __forceinline__ static void load(const unsigned char* p, float* v) {
    const uint4 x = *reinterpret_cast<const uint4*>(p);
    const unsigned w[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      v[2 * q] = __uint_as_float(w[q] << 16);
      v[2 * q + 1] = __uint_as_float(w[q] & 0xffff0000u);
    }
  }
  __device__ __forceinline__ static void store(__nv_bfloat16* p, const float* v) {
    unsigned w[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const __nv_bfloat162 h = __floats2bfloat162_rn(v[2 * q], v[2 * q + 1]);
      w[q] = (unsigned)__bfloat16_as_ushort(h.x) |
             ((unsigned)__bfloat16_as_ushort(h.y) << 16);
    }
    *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
  }
};

// 16 bytes from device memory to shared memory, asynchronously (sm_80+).
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem)
               : "memory");
}

// Waits for this thread's cp.async copies; a __syncthreads() after it
// makes every thread's copies visible to the block.
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
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

// One sample point of one axis (0 = y, 1 = x) of a ROI, k = bin * S +
// sample: its lower and upper bilinear corner and their weights. The one
// source of sample coordinates for every kernel here.
struct Point {
  int lo, hi;
  float wlo, whi;
};

__device__ __forceinline__ Point sample_point(const float* roi, int axis, int k,
                                              int H, int W, int O, int S,
                                              float scale, int aligned) {
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
  Point q;
  q.lo = i0;
  q.hi = min(i0 + 1, size - 1);
  q.wlo = oob ? 0.0f : __fsub_rn(1.0f, l);
  q.whi = oob ? 0.0f : l;
  return q;
}

__device__ __forceinline__ void point_geometry(Geometry& s, const float* roi,
                                               int H, int W, int O, int S,
                                               float scale, int aligned) {
  const int P = O * S;  // sample points per axis
  const int t = threadIdx.x;
  if (t < 2 * P) {
    const int axis = t < P ? 0 : 1;  // 0 = y, 1 = x
    const int k = t - axis * P;      // point index = bin * S + sample
    const Point q = sample_point(roi, axis, k, H, W, O, S, scale, aligned);
    s.lo[axis][k] = q.lo;
    s.hi[axis][k] = q.hi;
    s.wlo[axis][k] = q.wlo;
    s.whi[axis][k] = q.whi;
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

// Adds the corner (id, wt) to a bin's list of n (index, weight) pairs: a
// zero weight is dropped, an index already listed adds its weight there.
__device__ __forceinline__ void merge_corner(int* idx, float* w, int& n,
                                             int id, float wt) {
  if (wt == 0.0f) return;
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
      merge_corner(idx, w, n, s.lo[axis][k], s.wlo[axis][k]);
      merge_corner(idx, w, n, s.hi[axis][k], s.whi[axis][k]);
    }
    l.n[axis][i] = n;
  }
}

// A bin's list of kL (index, weight) pairs into registers, 16 bytes at a
// time where kL allows (the lists are 16-byte aligned).
template <int kL>
__device__ __forceinline__ void load_list(const int* idx, const float* w,
                                          int* io, float* wo) {
  if constexpr (kL % 4 == 0) {
#pragma unroll
    for (int q = 0; q < kL / 4; ++q) {
      const int4 a = reinterpret_cast<const int4*>(idx)[q];
      const float4 b = reinterpret_cast<const float4*>(w)[q];
      io[4 * q] = a.x, io[4 * q + 1] = a.y, io[4 * q + 2] = a.z, io[4 * q + 3] = a.w;
      wo[4 * q] = b.x, wo[4 * q + 1] = b.y, wo[4 * q + 2] = b.z, wo[4 * q + 3] = b.w;
    }
  } else {
#pragma unroll
    for (int e = 0; e < kL; ++e) io[e] = idx[e], wo[e] = w[e];
  }
}

// sum += w * (the 16-byte vector at p in the staged slice)
template <typename T>
__device__ __forceinline__ void add_corner(const unsigned char* p, float w,
                                           float* sum) {
  constexpr int kN = Vec16<T>::kN;
  float f[kN];
  Vec16<T>::load(p, f);
#pragma unroll
  for (int c = 0; c < kN; ++c) sum[c] = fmaf(w, f[c], sum[c]);
}

// Bytes of the staged kernel's bin lists for one chunk of kRoiChunk ROIs:
// per ROI, axis and bin, up to 2S (index, weight) pairs and their count.
__host__ __device__ constexpr int staged_list_bytes(int O, int S) {
  return kRoiChunk * (2 * O * 2 * S * 8 + 2 * O * 4);
}

// The staged forward (see the note at the top). Grid (ROI groups, C / Ct,
// B); dynamic shared memory: the (H, W, Ct) channel slice, 16 bytes per
// (position, vector), then the bin lists of one chunk. kO, kS > 0 fix
// out_size and the sampling ratio at compile time; 0 takes O_, S_.
template <typename T, int kO, int kS>
__global__ void __launch_bounds__(kStagedThreads)
roi_align_fwd_staged(const T* __restrict__ fmap, const float* __restrict__ rois,
                     T* __restrict__ out, int H, int W, int C, int R, int O_,
                     int S_, float scale, int aligned, int Ct, int vshift,
                     int per_block) {
  constexpr int kN = Vec16<T>::kN;  // channels per 16-byte vector
  const int O = kO > 0 ? kO : O_;
  const int S = kS > 0 ? kS : S_;
  const int L = 2 * S;  // list capacity per ROI, axis and bin
  const int V = 1 << vshift;  // vectors per map position: Ct / kN
  const int HW = H * W;
  const int b = blockIdx.z;
  const int c0 = blockIdx.y * Ct;
  const int r_begin = blockIdx.x * per_block;
  const int r_end = min(R, r_begin + per_block);

  extern __shared__ __align__(16) unsigned char smem[];
  int* lidx = reinterpret_cast<int*>(smem + (size_t)HW * V * 16);
  float* lw = reinterpret_cast<float*>(lidx + kRoiChunk * 2 * O * L);
  int* ln = reinterpret_cast<int*>(lw + kRoiChunk * 2 * O * L);

  // The image's channel slice, read from device memory once for the block.
  const T* src = fmap + (size_t)b * HW * C + c0;
  for (int k = threadIdx.x; k < HW * V; k += kStagedThreads) {
    const int pos = k >> vshift;
    const int v = k & (V - 1);
    cp_async16(smem + (size_t)k * 16, src + (size_t)pos * C + v * kN);
  }

  const float denom = (float)(S * S);
  const int per_roi = O * O;
  for (int r0 = r_begin; r0 < r_end; r0 += kRoiChunk) {
    const int nr = min(kRoiChunk, r_end - r0);
    // Each (ROI, axis, bin) of the chunk: its merged (index, weight) list.
    for (int t = threadIdx.x; t < nr * 2 * O; t += kStagedThreads) {
      const int q = t / (2 * O);
      const int axis = (t - q * 2 * O) / O;
      const int i = t - q * 2 * O - axis * O;
      const float* roi = rois + ((size_t)b * R + r0 + q) * 4;
      int* idx = lidx + t * L;
      float* w = lw + t * L;
      int n = 0;
      for (int k = i * S; k < (i + 1) * S; ++k) {
        const Point p = sample_point(roi, axis, k, H, W, O, S, scale, aligned);
        merge_corner(idx, w, n, p.lo, p.wlo);
        merge_corner(idx, w, n, p.hi, p.whi);
      }
      // as byte offsets into the slice, padded to L pairs with weight 0
      const int stride = (axis == 0 ? W : 1) * V * 16;
      for (int m = 0; m < L; ++m) {
        idx[m] = m < n ? idx[m] * stride : 0;
        if (m >= n) w[m] = 0.0f;
      }
      ln[t] = n;
    }
    cp_async_wait_all();  // the slice has landed (a no-op after the first chunk)
    __syncthreads();

    // Each thread one (ROI, bin, 16-byte vector) at a time; neighbouring
    // threads take neighbouring vectors of a bin, so the stores coalesce.
    for (int it = threadIdx.x; it < (nr * per_roi) << vshift;
         it += kStagedThreads) {
      const int v = it & (V - 1);
      const int u = it >> vshift;
      const int q = u / per_roi;
      const int bin = u - q * per_roi;
      const int i = bin / O;
      const int j = bin - i * O;
      const int ty = (q * 2) * O + i;      // the bin's y list
      const int tx = (q * 2 + 1) * O + j;  // and its x list
      const int nx = ln[tx];
      const unsigned char* vec = smem + v * 16;  // vector v of position 0
      float acc[kN] = {};
      // The plain version's order: each column's sum over the bin's rows
      // first, then the sum over its columns, in increasing index order.
      if constexpr (kS > 0) {
        // Lists padded to 2S entries: all of a column's row loads go out
        // together; columns past nx are skipped. 1 / S^2 is a power of two
        // here, so it is folded into the column weights exactly.
        static_assert((kS & (kS - 1)) == 0, "S must be a power of two");
        constexpr int kL = 2 * kS;
        constexpr float kInv = 1.0f / (kS * kS);
        int yo[kL], xo[kL];
        float yw[kL], xw[kL];
        load_list<kL>(lidx + ty * kL, lw + ty * kL, yo, yw);
        load_list<kL>(lidx + tx * kL, lw + tx * kL, xo, xw);
#pragma unroll
        for (int e = 0; e < kL; ++e) {
          if (e >= nx) break;
          float col[kN] = {};
#pragma unroll
          for (int a = 0; a < kL; ++a) add_corner<T>(vec + yo[a] + xo[e], yw[a], col);
          const float wx = xw[e] * kInv;
#pragma unroll
          for (int c = 0; c < kN; ++c) acc[c] = fmaf(wx, col[c], acc[c]);
        }
      } else {
        const int ny = ln[ty];
        for (int e = 0; e < nx; ++e) {
          float col[kN] = {};
          for (int a = 0; a < ny; ++a) {
            add_corner<T>(vec + lidx[ty * L + a] + lidx[tx * L + e],
                          lw[ty * L + a], col);
          }
          const float wx = lw[tx * L + e];
#pragma unroll
          for (int c = 0; c < kN; ++c) acc[c] = fmaf(wx, col[c], acc[c]);
        }
#pragma unroll
        for (int c = 0; c < kN; ++c) acc[c] = __fdiv_rn(acc[c], denom);
      }
      Vec16<T>::store(out + (((size_t)b * R + r0 + q) * per_roi + bin) * C + c0 +
                          v * kN,
                      acc);
    }
    __syncthreads();  // the next chunk's lists overwrite these
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

}  // extern "C"

namespace {

template <typename T, int kO, int kS>
cudaError_t launch_staged(const void* fmap, const void* rois, void* out, int B,
                          int H, int W, int C, int R, int O, int S, float scale,
                          int aligned, int Ct, int vshift, int per_block,
                          int smem, cudaStream_t st) {
  auto kernel = roi_align_fwd_staged<T, kO, kS>;
  // The kernel's shared-memory limits, set once per device (a host call that
  // would otherwise cost tens of microseconds a launch).
  static bool ready[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (!ready[dev]) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemMax);
    if (err == cudaSuccess) {
      err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
          cudaSharedmemCarveoutMaxShared);
    }
    if (err != cudaSuccess) return err;
    ready[dev] = true;
  }
  const dim3 grid((R + per_block - 1) / per_block, C / Ct, B);
  kernel<<<grid, kStagedThreads, smem, st>>>(
      static_cast<const T*>(fmap), static_cast<const float*>(rois),
      static_cast<T*>(out), H, W, C, R, O, S, scale, aligned, Ct, vshift,
      per_block);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_staged(const void* fmap, const void* rois, void* out,
                            int B, int H, int W, int C, int R, int O, int S,
                            float scale, int aligned, int Ct, int vshift,
                            int per_block, int smem, cudaStream_t st) {
  if (O == 7 && S == 2) {
    return launch_staged<T, 7, 2>(fmap, rois, out, B, H, W, C, R, O, S, scale,
                                  aligned, Ct, vshift, per_block, smem, st);
  }
  return launch_staged<T, 0, 0>(fmap, rois, out, B, H, W, C, R, O, S, scale,
                                aligned, Ct, vshift, per_block, smem, st);
}

}  // namespace

extern "C" {

// The staged forward: Ct channels a block, per_block ROIs a block (a
// multiple of kRoiChunk); the wrapper chooses both. dtype: 0 = float32,
// 1 = bfloat16. fmap and out must be 16-byte aligned and the (H, W, Ct)
// slice with the bin lists must fit in a block's shared memory. Returns the
// cudaError_t of the launch.
int fgn_roi_align_forward_staged(const void* fmap, const void* rois,
                                 void* out, int B, int H, int W, int C, int R,
                                 int O, int S, float scale, int aligned,
                                 int dtype, int Ct, int per_block,
                                 void* stream) {
  const int esize = dtype == 0 ? 4 : 2;
  if (O * S > kMaxPts || O <= 0 || S <= 0 || B <= 0 || B > 65535 || R <= 0 ||
      H <= 0 || W <= 0 || C <= 0 || (dtype != 0 && dtype != 1) || Ct <= 0 ||
      C % Ct || (Ct * esize) % 16 || per_block <= 0 ||
      per_block % kRoiChunk || (reinterpret_cast<uintptr_t>(fmap) & 15) ||
      (reinterpret_cast<uintptr_t>(out) & 15)) {
    return (int)cudaErrorInvalidValue;
  }
  const int V = Ct * esize / 16;
  int vshift = 0;
  while ((1 << vshift) < V) ++vshift;
  const long long smem =
      (long long)H * W * Ct * esize + staged_list_bytes(O, S);
  if ((1 << vshift) != V || smem > kSmemMax) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const cudaError_t err =
      dtype == 0
          ? dispatch_staged<float>(fmap, rois, out, B, H, W, C, R, O, S, scale,
                                   aligned, Ct, vshift, per_block, (int)smem, st)
          : dispatch_staged<__nv_bfloat16>(fmap, rois, out, B, H, W, C, R, O,
                                           S, scale, aligned, Ct, vshift,
                                           per_block, (int)smem, st);
  return (int)err;
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
