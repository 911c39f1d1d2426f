// GroupNorm with its epilogue (K3), on channels_last maps, for Hopper
// (sm_90a).
//
// Replaces no Pallas kernel of the JAX package: on the TPU, XLA fuses flax's
// nn.GroupNorm (fgn_tpu/models/resnet.py) with the casts, the ReLU and the
// residual add around it. On the card, F.group_norm on a channels_last bf16
// map took a cast to f32, a contiguous NCHW copy, a moments kernel, an apply
// kernel, a cast back, and separate ReLU and add kernels, and left the next
// convolution an NCHW tensor to transpose: about 40 bytes of device traffic
// an element. This kernel computes, for x of shape (N, C, H, W) laid out as
// (N, H, W, C) in memory and G groups of Cg = C / G consecutive channels,
//
//   out = act(cast(GN_f32(x) * gamma + beta) [+ residual])
//
// with statistics and affine in f32 (two-pass variance), one rounding to x's
// dtype, the residual added in f32 and rounded again (as a bf16 y + identity
// rounds), and the ReLU on the rounded value. out has x's strides.
//
// Bound on an H100 (3.35 TB/s): bytes. x read once and out written once, 4
// bytes an element in bf16, and the residual read once, 6 with it. The
// arithmetic (about 10 f32 operations an element) is far below the card's
// rate. Both routes move each byte in 16-byte vectors, neighbouring threads
// on neighbouring addresses.
//
// Route "onepass" (gn_onepass): an instance (H * W * C values) fits in a
// quarter of an SM's shared memory (blocks of 256 threads, four an SM) or in
// half of it (512 threads, two an SM): res5's and the relation head's
// 7x7x512 and 7x7x1024 RoI maps (50-100 KB in bf16), thousands of instances
// a call. One block an instance copies it into shared memory with
// cp.async (all copies in flight at once), computes the group means and then
// the sums of squared deviations from them over the resident tile, and
// normalises from shared memory: x is read from device memory once.
//
// Route "split" (gn_stats, then gn_apply): larger maps, the backbone's
// (240x240x32 to 30x30x1024). gn_stats takes a tile of rows x all C (48 KB,
// ops/group_norm_cuda.py::_TILE_BYTES: several blocks share an SM, and the
// grid fills the card even at N = 8) through the same shared-memory
// statistics, and writes each group's (mean, M2) of the tile. gn_apply merges
// an instance's partials (Chan et al.: M2 = sum M2_i + sum n_i (mean_i -
// mean)^2) and normalises its range of rows, read again from device memory:
// the second read is this route's extra cost (a map within the 50 MB L2 may
// hit it).
//
// Statistics of a tile (tile_stats): each thread owns one 16-byte chunk of
// the row (V = 8 bf16 or 4 f32 channels) and the rows r, r + RT, ...; it sums
// each of its channels over its rows, folds the sums into the groups its
// chunk touches, and one warp a group adds those of the threads owning the
// group's chunks, in a fixed order: a launch gives the same bits every time.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 512;  // threads a block, at most (Layout::T)
constexpr int kSmemMax = 232448;    // dynamic shared memory a block may use
constexpr int kMaxDevices = 64;
constexpr int kMaxGrid = 65535;     // instances of the split route (grid.y)

// 16 bytes of T (kN channels) as floats, and back; round() is the one
// rounding to T.
template <typename T>
struct Vec16;

template <>
struct Vec16<float> {
  static constexpr int kN = 4;
  __device__ __forceinline__ static void unpack(const uint4 u, float* v) {
    v[0] = __uint_as_float(u.x);
    v[1] = __uint_as_float(u.y);
    v[2] = __uint_as_float(u.z);
    v[3] = __uint_as_float(u.w);
  }
  __device__ __forceinline__ static uint4 pack(const float* v) {
    return make_uint4(__float_as_uint(v[0]), __float_as_uint(v[1]),
                      __float_as_uint(v[2]), __float_as_uint(v[3]));
  }
  __device__ __forceinline__ static float round(float y) { return y; }
};

template <>
struct Vec16<__nv_bfloat16> {
  static constexpr int kN = 8;
  // a bf16 is the upper half of the f32 of the same value
  __device__ __forceinline__ static void unpack(const uint4 u, float* v) {
    const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      v[2 * q] = __uint_as_float(w[q] << 16);
      v[2 * q + 1] = __uint_as_float(w[q] & 0xffff0000u);
    }
  }
  // v holds bf16 values already (round), so the conversion is exact
  __device__ __forceinline__ static uint4 pack(const float* v) {
    unsigned w[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      w[q] = (__float_as_uint(v[2 * q]) >> 16) |
             (__float_as_uint(v[2 * q + 1]) & 0xffff0000u);
    }
    return make_uint4(w[0], w[1], w[2], w[3]);
  }
  __device__ __forceinline__ static float round(float y) {
    return __bfloat162float(__float2bfloat16_rn(y));
  }
};

// How a block's threads cover a row of C channels (see tile_stats).
struct Layout {
  int T;   // threads a block (the wrapper's choice: 256 or 512)
  int C;   // channels
  int G;   // groups
  int Cg;  // channels a group
  int NC;  // 16-byte chunks a row
  int RT;  // rows a pass of the block covers: T / NC
  int S;   // groups a chunk touches: max(1, V / Cg)
  int Q;   // chunks a group spans: max(1, Cg / V)
  int Cs;  // channels of a chunk in one group: min(Cg, V), a power of two
  int cs_shift;  // log2(Cs)
};

// The layout of C channels in G groups over blocks of `threads`; false
// where the kernel cannot take it (a chunk must hold whole groups or lie
// inside one, and a row must not have more chunks than a block has
// threads).
template <typename T>
bool make_layout(int C, int G, int threads, Layout* L) {
  constexpr int V = Vec16<T>::kN;
  if (G <= 0 || C <= 0 || C % G || C % V || C / V > threads ||
      threads % 32 || threads > kMaxThreads) {
    return false;
  }
  L->T = threads;
  L->C = C;
  L->G = G;
  L->Cg = C / G;
  L->NC = C / V;
  L->RT = threads / L->NC;
  if (L->Cg >= V) {
    if (L->Cg % V) return false;
    L->S = 1;
    L->Q = L->Cg / V;
    L->Cs = V;
  } else {
    if (V % L->Cg) return false;
    L->S = V / L->Cg;
    L->Q = 1;
    L->Cs = L->Cg;
  }
  L->cs_shift = 0;
  while ((1 << L->cs_shift) < L->Cs) ++L->cs_shift;
  return true;
}

// Shared memory of tile_stats' scratch: a slot per (thread, group touched),
// and two floats a group.
int stats_smem(const Layout& L) { return L.T * L.S * 4 + 2 * L.G * 4; }

__device__ __forceinline__ float warp_sum(float s) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
  return s;
}

// 16 bytes from device memory to shared memory, asynchronously (sm_80+).
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Copies n 16-byte chunks from src to the block's shared memory at dst and
// waits for them.
__device__ __forceinline__ void stage(unsigned char* dst,
                                      const unsigned char* src, int n) {
  for (int k = threadIdx.x; k < n; k += blockDim.x) {
    cp_async16(dst + (size_t)k * 16, src + (size_t)k * 16);
  }
  cp_async_wait_all();
  __syncthreads();
}

// Folds a thread's per-channel sums into its slots, one a group its chunk
// touches (channels in increasing order).
template <int V>
__device__ __forceinline__ void fold(const float* acc, const Layout& L,
                                     float* slots, bool active) {
  if (!active) return;
#pragma unroll
  for (int j = 0; j < V; ++j) {
    if (j < L.S) {
      float s = 0.f;
#pragma unroll
      for (int i = 0; i < V; ++i) {
        if ((i >> L.cs_shift) == j) s += acc[i];
      }
      slots[threadIdx.x * L.S + j] = s;
    }
  }
}

// out[g] = (the sum of group g's slots over every row) / cnt: one warp a
// group, its lanes over the (row, chunk) slots in a fixed order.
template <int V>
__device__ __forceinline__ void reduce_groups(const Layout& L,
                                              const float* slots, float cnt,
                                              float* out) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int terms = L.RT * L.Q;
  for (int g = warp; g < L.G; g += L.T >> 5) {
    const int c0 = g * L.Cg;
    const int chunk0 = c0 / V, j = (c0 % V) >> L.cs_shift;
    float s = 0.f;
    for (int k = lane; k < terms; k += 32) {
      const int r = k / L.Q, q = k - r * L.Q;
      s += slots[(r * L.NC + chunk0 + q) * L.S + j];
    }
    s = warp_sum(s);
    if (lane == 0) out[g] = s / cnt;
  }
}

// Each group's mean (gmean) and sum of squared deviations from it (gm2)
// over a tile of `rows` rows resident in shared memory, two passes. Ends
// with both visible to the block.
template <typename T>
__device__ void tile_stats(const unsigned char* tile, int rows,
                           const Layout& L, float* slots, float* gmean,
                           float* gm2) {
  constexpr int V = Vec16<T>::kN;
  const bool active = threadIdx.x < L.RT * L.NC;
  const int ch = threadIdx.x % L.NC, r = threadIdx.x / L.NC;
  float acc[V], v[V], mu[V];
#pragma unroll
  for (int i = 0; i < V; ++i) acc[i] = 0.f;
  if (active) {
    for (int p = r; p < rows; p += L.RT) {
      Vec16<T>::unpack(
          *reinterpret_cast<const uint4*>(tile + ((size_t)p * L.NC + ch) * 16),
          v);
#pragma unroll
      for (int i = 0; i < V; ++i) acc[i] += v[i];
    }
  }
  fold<V>(acc, L, slots, active);
  __syncthreads();
  reduce_groups<V>(L, slots, (float)rows * (float)L.Cg, gmean);
  __syncthreads();
#pragma unroll
  for (int i = 0; i < V; ++i) {
    acc[i] = 0.f;
    mu[i] = active ? gmean[(ch * V + i) / L.Cg] : 0.f;
  }
  if (active) {
    for (int p = r; p < rows; p += L.RT) {
      Vec16<T>::unpack(
          *reinterpret_cast<const uint4*>(tile + ((size_t)p * L.NC + ch) * 16),
          v);
#pragma unroll
      for (int i = 0; i < V; ++i) {
        const float d = v[i] - mu[i];
        acc[i] += d * d;
      }
    }
  }
  fold<V>(acc, L, slots, active);
  __syncthreads();
  reduce_groups<V>(L, slots, 1.f, gm2);
  __syncthreads();
}

// A thread's per-channel scale (rstd * gamma) and shift (beta - mean *
// scale), as the library's apply kernel forms them: y = x * scale + shift.
template <int V>
__device__ __forceinline__ void load_params(const Layout& L, int ch,
                                            const float* gmean,
                                            const float* grstd,
                                            const float* gamma,
                                            const float* beta, float* a,
                                            float* c) {
#pragma unroll
  for (int i = 0; i < V; ++i) {
    const int k = ch * V + i, g = k / L.Cg;
    a[i] = grstd[g] * gamma[k];
    c[i] = fmaf(-gmean[g], a[i], beta[k]);
  }
}

template <typename T, bool kRes>
__device__ __forceinline__ uint4 epilogue(const uint4 xv, const uint4 rv,
                                          const float* a, const float* c,
                                          bool relu) {
  constexpr int V = Vec16<T>::kN;
  float v[V], res[V];
  Vec16<T>::unpack(xv, v);
  if (kRes) Vec16<T>::unpack(rv, res);
#pragma unroll
  for (int i = 0; i < V; ++i) {
    float y = Vec16<T>::round(fmaf(v[i], a[i], c[i]));
    if (kRes) y = Vec16<T>::round(y + res[i]);
    if (relu) y = y < 0.f ? 0.f : y;  // a NaN stays, as in torch.relu
    v[i] = y;
  }
  return Vec16<T>::pack(v);
}

// Normalises rows [p0, p1) of an instance: this thread's chunk ch of rows
// p0 + r, + RT, ..., x read from xs (shared or device memory), the residual
// from rs, out written to os, 64 bytes of loads in flight a thread (4 rows,
// 2 with a residual).
template <typename T, bool kRes>
__device__ __forceinline__ void normalize_rows(
    const unsigned char* xs, const unsigned char* rs, unsigned char* os,
    int p0, int p1, const Layout& L, int ch, int r, const float* a,
    const float* c, bool relu) {
  constexpr int kUnroll = kRes ? 2 : 4;
  for (int p = p0 + r; p < p1; p += kUnroll * L.RT) {
    uint4 xv[kUnroll], rv[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int q = p + u * L.RT;
      if (q < p1) {
        const size_t off = ((size_t)q * L.NC + ch) * 16;
        xv[u] = *reinterpret_cast<const uint4*>(xs + off);
        rv[u] = kRes ? *reinterpret_cast<const uint4*>(rs + off)
                     : make_uint4(0, 0, 0, 0);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int q = p + u * L.RT;
      if (q < p1) {
        const size_t off = ((size_t)q * L.NC + ch) * 16;
        *reinterpret_cast<uint4*>(os + off) =
            epilogue<T, kRes>(xv[u], rv[u], a, c, relu);
      }
    }
  }
}

// One block an instance, resident in shared memory. Grid (N).
template <typename T, bool kRes>
__global__ void __launch_bounds__(kMaxThreads, 2)
    gn_onepass(const T* __restrict__ x, const float* __restrict__ gamma,
               const float* __restrict__ beta, const T* __restrict__ res,
               T* __restrict__ out, int HW, Layout L, float eps, int relu) {
  constexpr int V = Vec16<T>::kN;
  extern __shared__ __align__(16) unsigned char smem[];
  const size_t nvec = (size_t)HW * L.NC;
  unsigned char* tile = smem;
  float* slots = reinterpret_cast<float*>(smem + nvec * 16);
  float* gmean = slots + L.T * L.S;
  float* grstd = gmean + L.G;
  const size_t base = (size_t)blockIdx.x * nvec * 16;  // bytes
  stage(tile, reinterpret_cast<const unsigned char*>(x) + base, (int)nvec);
  tile_stats<T>(tile, HW, L, slots, gmean, grstd);
  const float cnt = (float)HW * (float)L.Cg;
  for (int g = threadIdx.x; g < L.G; g += L.T) {
    grstd[g] = 1.f / sqrtf(grstd[g] / cnt + eps);
  }
  __syncthreads();
  if (threadIdx.x >= L.RT * L.NC) return;
  const int ch = threadIdx.x % L.NC, r = threadIdx.x / L.NC;
  float a[V], c[V];
  load_params<V>(L, ch, gmean, grstd, gamma, beta, a, c);
  normalize_rows<T, kRes>(
      tile, reinterpret_cast<const unsigned char*>(res) + (kRes ? base : 0),
      reinterpret_cast<unsigned char*>(out) + base, 0, HW, L, ch, r, a, c,
      relu);
}

// Each group's (mean, M2) over a tile of tile_rows rows. Grid (tiles, N);
// part is (N, G, tiles, 2).
template <typename T>
__global__ void __launch_bounds__(kMaxThreads, 2)
    gn_stats(const T* __restrict__ x, float* __restrict__ part, int HW,
             Layout L, int tile_rows) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int t = blockIdx.x, n = blockIdx.y, tiles = gridDim.x;
  const int p0 = t * tile_rows, rows = min(tile_rows, HW - p0);
  unsigned char* tile = smem;
  float* slots =
      reinterpret_cast<float*>(smem + (size_t)tile_rows * L.NC * 16);
  float* gmean = slots + L.T * L.S;
  float* gm2 = gmean + L.G;
  stage(tile,
        reinterpret_cast<const unsigned char*>(x) +
            ((size_t)n * HW + p0) * L.NC * 16,
        rows * L.NC);
  tile_stats<T>(tile, rows, L, slots, gmean, gm2);
  for (int g = threadIdx.x; g < L.G; g += L.T) {
    float* dst = part + (((size_t)n * L.G + g) * tiles + t) * 2;
    dst[0] = gmean[g];
    dst[1] = gm2[g];
  }
}

// Merges an instance's partials, then normalises apply_rows rows of it.
// Grid (ceil(HW / apply_rows), N).
template <typename T, bool kRes>
__global__ void __launch_bounds__(kMaxThreads, 2)
    gn_apply(const T* __restrict__ x, const float* __restrict__ part,
             const float* __restrict__ gamma, const float* __restrict__ beta,
             const T* __restrict__ res, T* __restrict__ out, int HW, Layout L,
             float eps, int relu, int tile_rows, int tiles, int apply_rows) {
  constexpr int V = Vec16<T>::kN;
  extern __shared__ float gsm[];  // gmean[G], grstd[G]
  float* gmean = gsm;
  float* grstd = gsm + L.G;
  const int n = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int g = warp; g < L.G; g += L.T >> 5) {
    const float2* pg = reinterpret_cast<const float2*>(part) +
                       ((size_t)n * L.G + g) * tiles;
    float s = 0.f;
    for (int i = lane; i < tiles; i += 32) {
      s += (float)min(tile_rows, HW - i * tile_rows) * pg[i].x;
    }
    const float mean = warp_sum(s) / (float)HW;
    float m2 = 0.f;
    for (int i = lane; i < tiles; i += 32) {
      const float2 st = pg[i];
      const float d = st.x - mean;
      m2 += st.y + (float)min(tile_rows, HW - i * tile_rows) * (float)L.Cg *
                       d * d;
    }
    m2 = warp_sum(m2);
    if (lane == 0) {
      gmean[g] = mean;
      grstd[g] = 1.f / sqrtf(m2 / ((float)HW * (float)L.Cg) + eps);
    }
  }
  __syncthreads();
  if (threadIdx.x >= L.RT * L.NC) return;
  const int ch = threadIdx.x % L.NC, r = threadIdx.x / L.NC;
  float a[V], c[V];
  load_params<V>(L, ch, gmean, grstd, gamma, beta, a, c);
  const size_t base = (size_t)n * HW * L.NC * 16;  // bytes
  const int p0 = blockIdx.x * apply_rows, p1 = min(HW, p0 + apply_rows);
  normalize_rows<T, kRes>(
      reinterpret_cast<const unsigned char*>(x) + base,
      reinterpret_cast<const unsigned char*>(res) + (kRes ? base : 0),
      reinterpret_cast<unsigned char*>(out) + base, p0, p1, L, ch, r, a, c,
      relu);
}

// A kernel's shared-memory limit, set once per device and kernel (a host
// call that would otherwise cost tens of microseconds a launch); ready is
// the kernel's own per-device flags.
template <typename K>
cudaError_t allow_smem(K kernel, bool* ready) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (!ready[dev]) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemMax);
    if (err != cudaSuccess) return err;
    ready[dev] = true;
  }
  return cudaSuccess;
}

template <typename T, bool kRes>
cudaError_t launch_onepass(const void* x, const void* gamma, const void* beta,
                           const void* res, void* out, int N, int HW,
                           const Layout& L, float eps, int relu,
                           cudaStream_t st) {
  const size_t smem = (size_t)HW * L.NC * 16 + stats_smem(L);
  if (smem > (size_t)kSmemMax) return cudaErrorInvalidValue;
  auto kernel = gn_onepass<T, kRes>;
  static bool ready[kMaxDevices] = {};
  const cudaError_t err = allow_smem(kernel, ready);
  if (err != cudaSuccess) return err;
  kernel<<<N, L.T, smem, st>>>(
      static_cast<const T*>(x), static_cast<const float*>(gamma),
      static_cast<const float*>(beta), static_cast<const T*>(res),
      static_cast<T*>(out), HW, L, eps, relu);
  return cudaGetLastError();
}

template <typename T, bool kRes>
cudaError_t launch_split(const void* x, const void* gamma, const void* beta,
                         const void* res, void* out, void* part, int N,
                         int HW, const Layout& L, float eps, int relu,
                         int tile_rows, int apply_rows, cudaStream_t st) {
  if (tile_rows <= 0 || apply_rows <= 0 || N > kMaxGrid) {
    return cudaErrorInvalidValue;
  }
  const size_t smem = (size_t)tile_rows * L.NC * 16 + stats_smem(L);
  if (smem > (size_t)kSmemMax) return cudaErrorInvalidValue;
  const int tiles = (HW + tile_rows - 1) / tile_rows;
  const int blocks = (HW + apply_rows - 1) / apply_rows;
  auto stats = gn_stats<T>;
  static bool ready[kMaxDevices] = {};
  cudaError_t err = allow_smem(stats, ready);
  if (err != cudaSuccess) return err;
  stats<<<dim3(tiles, N), L.T, smem, st>>>(
      static_cast<const T*>(x), static_cast<float*>(part), HW, L, tile_rows);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  gn_apply<T, kRes><<<dim3(blocks, N), L.T, 2 * L.G * sizeof(float), st>>>(
      static_cast<const T*>(x), static_cast<const float*>(part),
      static_cast<const float*>(gamma), static_cast<const float*>(beta),
      static_cast<const T*>(res), static_cast<T*>(out), HW, L, eps, relu,
      tile_rows, tiles, apply_rows);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* x, const void* gamma, const void* beta,
                     const void* res, void* out, void* part, int N, int HW,
                     int C, int G, float eps, int relu, int threads,
                     int tile_rows, int apply_rows, cudaStream_t st) {
  Layout L;
  if (N <= 0 || HW <= 0 || !make_layout<T>(C, G, threads, &L)) {
    return cudaErrorInvalidValue;
  }
  if (part == nullptr) {
    return res ? launch_onepass<T, true>(x, gamma, beta, res, out, N, HW, L,
                                         eps, relu, st)
               : launch_onepass<T, false>(x, gamma, beta, res, out, N, HW, L,
                                          eps, relu, st);
  }
  return res ? launch_split<T, true>(x, gamma, beta, res, out, part, N, HW, L,
                                     eps, relu, tile_rows, apply_rows, st)
             : launch_split<T, false>(x, gamma, beta, res, out, part, N, HW,
                                      L, eps, relu, tile_rows, apply_rows, st);
}

}  // namespace

extern "C" {

// x, res, out: (N, H, W, C) in memory, 16-byte aligned, HW = H * W; gamma,
// beta: (C,) float32; res may be null; blocks of `threads` threads (a
// multiple of 32, at most 512, and at least C / 8 in bf16, C / 4 in f32).
// part null takes the onepass route
// (the instance and the statistics' scratch within kSmemMax); otherwise the
// split route, part (N, G, ceil(HW / tile_rows), 2) float32 scratch, a
// statistics tile of tile_rows rows, apply_rows rows a block of the apply
// kernel. dtype: 0 = float32, 1 = bfloat16. Returns the cudaError_t of the
// launches.
int fgn_group_norm(const void* x, const void* gamma, const void* beta,
                   const void* res, void* out, void* part, int N, int HW,
                   int C, int G, float eps, int relu, int dtype, int threads,
                   int tile_rows, int apply_rows, void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return (int)dispatch<float>(x, gamma, beta, res, out, part, N, HW, C, G,
                                eps, relu, threads, tile_rows, apply_rows, st);
  }
  if (dtype == 1) {
    return (int)dispatch<__nv_bfloat16>(x, gamma, beta, res, out, part, N, HW,
                                        C, G, eps, relu, threads, tile_rows,
                                        apply_rows, st);
  }
  return (int)cudaErrorInvalidValue;
}

const char* fgn_group_norm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
