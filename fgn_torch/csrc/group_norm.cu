// GroupNorm with its epilogue (K3), on channels_last maps, for Hopper
// (sm_90a), and its gradient (K3-bwd, further down).
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
// Training instantiates both routes with kStats: the onepass kernel, and the
// apply kernel's first block of an instance, also write each (instance,
// group)'s f32 (mean, rstd) for K3-bwd. Serving instantiates them without.
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

// One block an instance, resident in shared memory. Grid (N). With kStats
// (training) it also writes each group's (mean, rstd) to stats (N, G, 2).
template <typename T, bool kRes, bool kStats>
__global__ void __launch_bounds__(kMaxThreads, 2)
    gn_onepass(const T* __restrict__ x, const float* __restrict__ gamma,
               const float* __restrict__ beta, const T* __restrict__ res,
               T* __restrict__ out, float* __restrict__ stats, int HW,
               Layout L, float eps, int relu) {
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
    if (kStats) {
      float* s = stats + ((size_t)blockIdx.x * L.G + g) * 2;
      s[0] = gmean[g];
      s[1] = grstd[g];
    }
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
// Grid (ceil(HW / apply_rows), N). With kStats the first block of an
// instance writes its groups' (mean, rstd) to stats (N, G, 2).
template <typename T, bool kRes, bool kStats>
__global__ void __launch_bounds__(kMaxThreads, 2)
    gn_apply(const T* __restrict__ x, const float* __restrict__ part,
             const float* __restrict__ gamma, const float* __restrict__ beta,
             const T* __restrict__ res, T* __restrict__ out,
             float* __restrict__ stats, int HW, Layout L, float eps, int relu,
             int tile_rows, int tiles, int apply_rows) {
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
      if (kStats && blockIdx.x == 0) {
        float* s = stats + ((size_t)n * L.G + g) * 2;
        s[0] = mean;
        s[1] = grstd[g];
      }
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


// ---------------------------------------------------------------------------
// K3-bwd: the gradient of the training forward above (kStats), on the same
// channels_last layout. With y = act(cast(x_hat * gamma + beta) [+ res]),
// x_hat = (x - mean) * rstd of each (instance, group) of M = H * W * Cg
// values, and dy the gradient of y:
//
//   dz     = dy where y > 0, else 0 (with the ReLU; as torch's
//            threshold_backward, a NaN y passes dy), dy without it;
//   dres   = dz, written as is where the residual wants a gradient;
//   dx     = rstd * (gamma * dz - mean(gamma * dz) - x_hat *
//            mean(gamma * dz * x_hat)), the means over the group, f32,
//            rounded once to x's dtype;
//   dgamma = sum dz * x_hat, dbeta = sum dz over instances and rows, f32.
//
// Bound: bytes. x, dy and y read once, dx and dres written once: 10 bytes an
// element in bf16. Every sum runs in a fixed order and no float is added
// atomically, so a launch repeats its bits.
//
// Route "onepass" (gnb_onepass): an instance's x and dy fit in shared memory
// (res5's and the relation head's 7x7 RoI maps, and the supports' smaller
// maps). A block walks the instances blockIdx.x, + gridDim.x, ...: it copies
// x and dy in with cp.async, reads y once from device memory while it forms
// dz (kept in place of dy, and written to dres), sums dz and dz * x_hat per
// channel, then writes dx from shared memory. Its channel sums over its
// instances, in order, are one row of rows (grid, C, 2), which gnb_params
// adds up for dgamma and dbeta.
//
// Route "split" (gnb_sums, gnb_merge, gnb_apply): the backbone's larger maps.
// gnb_sums takes a tile of rows of an instance from device memory (dz
// written to dres) and writes its channel sums to part (N, tiles, C, 2);
// gnb_merge adds an instance's tiles (rows (N, C, 2)) and forms its groups'
// two means; gnb_apply reads x and dz again (dres where it was written, else
// dy and y) and writes dx. The second read is this route's extra cost.
//
// A thread owns one 16-byte chunk of a row and the rows r, r + RT, ..., as in
// the forward (tile_stats); its per-channel sums meet the other rows' in
// shared memory (channel_sums).

// dz of 16 bytes of dy, y: dy where y is not <= 0, else 0 (exact in T).
template <typename T>
__device__ __forceinline__ uint4 relu_grad(const uint4 dv, const uint4 yv) {
  constexpr int V = Vec16<T>::kN;
  float d[V], y[V];
  Vec16<T>::unpack(dv, d);
  Vec16<T>::unpack(yv, y);
#pragma unroll
  for (int i = 0; i < V; ++i) d[i] = y[i] <= 0.f ? 0.f : d[i];
  return Vec16<T>::pack(d);
}

// The mean and rstd of the group of each channel of chunk ch of instance n;
// stats (N, G, 2).
template <int V>
__device__ __forceinline__ void chunk_stats(const Layout& L, int n, int ch,
                                            const float* stats, float* mu,
                                            float* rs) {
#pragma unroll
  for (int i = 0; i < V; ++i) {
    const float* s = stats + ((size_t)n * L.G + (ch * V + i) / L.Cg) * 2;
    mu[i] = s[0];
    rs[i] = s[1];
  }
}

// Rows [p0, p1) of an instance, this thread's chunk ch from row p0 + r on:
// dz from ds (masked by ys where ys is not null, and then written back to zs
// where zs is not null), written to dres where it is not null; az, azx gain
// each channel's dz and dz * x_hat. Two rows of loads in flight.
template <typename T>
__device__ __forceinline__ void grad_sums(
    const unsigned char* xs, const unsigned char* ds, const unsigned char* ys,
    unsigned char* zs, unsigned char* dres, int p0, int p1, const Layout& L,
    int ch, int r, const float* mu, const float* rs, float* az, float* azx) {
  constexpr int V = Vec16<T>::kN;
  constexpr int kUnroll = 2;
  for (int p = p0 + r; p < p1; p += kUnroll * L.RT) {
    uint4 xv[kUnroll], dv[kUnroll], yv[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int q = p + u * L.RT;
      if (q < p1) {
        const size_t off = ((size_t)q * L.NC + ch) * 16;
        xv[u] = *reinterpret_cast<const uint4*>(xs + off);
        dv[u] = *reinterpret_cast<const uint4*>(ds + off);
        if (ys) yv[u] = *reinterpret_cast<const uint4*>(ys + off);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int q = p + u * L.RT;
      if (q < p1) {
        const size_t off = ((size_t)q * L.NC + ch) * 16;
        if (ys) {
          dv[u] = relu_grad<T>(dv[u], yv[u]);
          if (zs) *reinterpret_cast<uint4*>(zs + off) = dv[u];
        }
        if (dres) *reinterpret_cast<uint4*>(dres + off) = dv[u];
        float xf[V], zf[V];
        Vec16<T>::unpack(xv[u], xf);
        Vec16<T>::unpack(dv[u], zf);
#pragma unroll
        for (int i = 0; i < V; ++i) {
          az[i] += zf[i];
          azx[i] = fmaf(zf[i], (xf[i] - mu[i]) * rs[i], azx[i]);
        }
      }
    }
  }
}

// out[c * stride] = the sum of the block's threads' acc for channel c, over
// the RT rows of a pass in order. slots holds RT * C floats.
template <int V>
__device__ __forceinline__ void channel_sums(const float* acc, const Layout& L,
                                             int ch, int r, bool active,
                                             float* slots, float* out,
                                             int stride) {
  if (active) {
    float4* dst = reinterpret_cast<float4*>(slots + (size_t)r * L.C + ch * V);
#pragma unroll
    for (int q = 0; q < V / 4; ++q) {
      dst[q] = make_float4(acc[4 * q], acc[4 * q + 1], acc[4 * q + 2],
                           acc[4 * q + 3]);
    }
  }
  __syncthreads();
  for (int c = threadIdx.x; c < L.C; c += L.T) {
    float s = 0.f;
    for (int k = 0; k < L.RT; ++k) s += slots[(size_t)k * L.C + c];
    out[(size_t)c * stride] = s;
  }
  __syncthreads();
}

// gab[2g], gab[2g + 1] = the means over group g of gamma * dz and gamma * dz
// * x_hat, from the channel sums cz, czx (stride 2 apart): one warp a group,
// its lanes over the group's channels. Ends with gab visible to the block.
__device__ __forceinline__ void group_means(const Layout& L, const float* cz,
                                            const float* czx,
                                            const float* gamma, float M,
                                            float* gab) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int g = warp; g < L.G; g += L.T >> 5) {
    float a = 0.f, b = 0.f;
    for (int k = lane; k < L.Cg; k += 32) {
      const int c = g * L.Cg + k;
      a = fmaf(gamma[c], cz[2 * c], a);
      b = fmaf(gamma[c], czx[2 * c], b);
    }
    a = warp_sum(a);
    b = warp_sum(b);
    if (lane == 0) {
      gab[2 * g] = a / M;
      gab[2 * g + 1] = b / M;
    }
  }
  __syncthreads();
}

// dx of rows [p0, p1), this thread's chunk: dz from zs (masked by ys where
// ys is not null), x from xs; dx = c1 * dz + c2 * x + c3, rounded once.
template <typename T>
__device__ __forceinline__ void grad_x(const unsigned char* xs,
                                       const unsigned char* zs,
                                       const unsigned char* ys,
                                       unsigned char* dxs, int p0, int p1,
                                       const Layout& L, int ch, int r,
                                       const float* c1, const float* c2,
                                       const float* c3) {
  constexpr int V = Vec16<T>::kN;
  constexpr int kUnroll = 2;
  for (int p = p0 + r; p < p1; p += kUnroll * L.RT) {
    uint4 xv[kUnroll], zv[kUnroll], yv[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int q = p + u * L.RT;
      if (q < p1) {
        const size_t off = ((size_t)q * L.NC + ch) * 16;
        xv[u] = *reinterpret_cast<const uint4*>(xs + off);
        zv[u] = *reinterpret_cast<const uint4*>(zs + off);
        if (ys) yv[u] = *reinterpret_cast<const uint4*>(ys + off);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int q = p + u * L.RT;
      if (q < p1) {
        if (ys) zv[u] = relu_grad<T>(zv[u], yv[u]);
        float xf[V], zf[V];
        Vec16<T>::unpack(xv[u], xf);
        Vec16<T>::unpack(zv[u], zf);
#pragma unroll
        for (int i = 0; i < V; ++i) {
          xf[i] = Vec16<T>::round(fmaf(c1[i], zf[i], fmaf(c2[i], xf[i], c3[i])));
        }
        *reinterpret_cast<uint4*>(dxs + ((size_t)q * L.NC + ch) * 16) =
            Vec16<T>::pack(xf);
      }
    }
  }
}

// dx's per-channel coefficients of chunk ch, as the library's backward
// forms them: with a = mean(gamma * dz), b = mean(gamma * dz * x_hat) (gab
// as group_means leaves it), dx = rstd * (gamma * dz - a - x_hat * b) =
// c1 * dz + c2 * x + c3, c1 = rstd * gamma, c2 = -rstd^2 * b, c3 = -c2 *
// mean - rstd * a. mu, rs: the chunk's means and rstds, replaced by c2, c3.
template <int V>
__device__ __forceinline__ void dx_coeffs(const Layout& L, int ch,
                                          const float* gamma, const float* gab,
                                          float* mu, float* rs, float* c1) {
#pragma unroll
  for (int i = 0; i < V; ++i) {
    const int c = ch * V + i, g = c / L.Cg;
    const float c2 = -rs[i] * rs[i] * gab[2 * g + 1];
    c1[i] = rs[i] * gamma[c];
    rs[i] = fmaf(-c2, mu[i], -rs[i] * gab[2 * g]);
    mu[i] = c2;
  }
}

// One block walks instances blockIdx.x, + gridDim.x, ...; x and dz resident
// in shared memory. rows (gridDim.x, C, 2): the block's sum over its
// instances of each channel's (dz, dz * x_hat). dx, dres, y may be null.
template <typename T>
__global__ void __launch_bounds__(kMaxThreads, 1)
    gnb_onepass(const T* __restrict__ x, const T* __restrict__ dy,
                const T* __restrict__ y, const float* __restrict__ gamma,
                const float* __restrict__ stats, T* __restrict__ dx,
                T* __restrict__ dres, float* __restrict__ rows, int N, int HW,
                Layout L) {
  constexpr int V = Vec16<T>::kN;
  extern __shared__ __align__(16) unsigned char smem[];
  const size_t nvec = (size_t)HW * L.NC;
  unsigned char* xt = smem;
  unsigned char* zt = smem + nvec * 16;
  float* slots = reinterpret_cast<float*>(smem + 2 * nvec * 16);
  float* cs = slots + L.T * V;  // (C, 2): a channel's (dz, dz * x_hat)
  float* gab = cs + 2 * L.C;    // (G, 2)
  const bool active = threadIdx.x < L.RT * L.NC;
  const int ch = threadIdx.x % L.NC, r = threadIdx.x / L.NC;
  const float M = (float)HW * (float)L.Cg;
  float* mine = rows + (size_t)blockIdx.x * L.C * 2;
  for (int n = blockIdx.x; n < N; n += gridDim.x) {
    const size_t base = (size_t)n * nvec * 16;  // bytes
    const unsigned char* xb = reinterpret_cast<const unsigned char*>(x) + base;
    const unsigned char* db = reinterpret_cast<const unsigned char*>(dy) + base;
    for (size_t k = threadIdx.x; k < nvec; k += blockDim.x) {
      cp_async16(xt + k * 16, xb + k * 16);
      cp_async16(zt + k * 16, db + k * 16);
    }
    cp_async_wait_all();
    __syncthreads();
    float mu[V], rs[V], az[V], azx[V];
#pragma unroll
    for (int i = 0; i < V; ++i) az[i] = azx[i] = 0.f;
    if (active) {
      chunk_stats<V>(L, n, ch, stats, mu, rs);
      grad_sums<T>(xt, zt,
                   y ? reinterpret_cast<const unsigned char*>(y) + base
                     : nullptr,
                   zt,
                   dres ? reinterpret_cast<unsigned char*>(dres) + base
                        : nullptr,
                   0, HW, L, ch, r, mu, rs, az, azx);
    }
    channel_sums<V>(az, L, ch, r, active, slots, cs, 2);
    channel_sums<V>(azx, L, ch, r, active, slots, cs + 1, 2);
    const bool first = n == (int)blockIdx.x;
    for (int c = threadIdx.x; c < L.C; c += L.T) {
      mine[2 * c] = first ? cs[2 * c] : mine[2 * c] + cs[2 * c];
      mine[2 * c + 1] = first ? cs[2 * c + 1] : mine[2 * c + 1] + cs[2 * c + 1];
    }
    if (dx) {
      group_means(L, cs, cs + 1, gamma, M, gab);
      if (active) {
        float c1[V];
        dx_coeffs<V>(L, ch, gamma, gab, mu, rs, c1);
        grad_x<T>(xt, zt, nullptr,
                  reinterpret_cast<unsigned char*>(dx) + base, 0, HW, L, ch,
                  r, c1, mu, rs);
      }
    }
    __syncthreads();  // the next instance's copies overwrite the tiles
  }
}

// The channel sums of a tile of tile_rows rows. Grid (tiles, N); part
// (N, tiles, C, 2). dres, y may be null.
template <typename T>
__global__ void __launch_bounds__(kMaxThreads, 2)
    gnb_sums(const T* __restrict__ x, const T* __restrict__ dy,
             const T* __restrict__ y, const float* __restrict__ stats,
             T* __restrict__ dres, float* __restrict__ part, int HW, Layout L,
             int tile_rows) {
  constexpr int V = Vec16<T>::kN;
  extern __shared__ float slots[];
  const int t = blockIdx.x, n = blockIdx.y, tiles = gridDim.x;
  const int p0 = t * tile_rows, p1 = min(HW, p0 + tile_rows);
  const bool active = threadIdx.x < L.RT * L.NC;
  const int ch = threadIdx.x % L.NC, r = threadIdx.x / L.NC;
  const size_t base = (size_t)n * HW * L.NC * 16;  // bytes
  float mu[V], rs[V], az[V], azx[V];
#pragma unroll
  for (int i = 0; i < V; ++i) az[i] = azx[i] = 0.f;
  if (active) {
    chunk_stats<V>(L, n, ch, stats, mu, rs);
    grad_sums<T>(
        reinterpret_cast<const unsigned char*>(x) + base,
        reinterpret_cast<const unsigned char*>(dy) + base,
        y ? reinterpret_cast<const unsigned char*>(y) + base : nullptr,
        nullptr, dres ? reinterpret_cast<unsigned char*>(dres) + base : nullptr,
        p0, p1, L, ch, r, mu, rs, az, azx);
  }
  float* out = part + ((size_t)n * tiles + t) * L.C * 2;
  channel_sums<V>(az, L, ch, r, active, slots, out, 2);
  channel_sums<V>(azx, L, ch, r, active, slots, out + 1, 2);
}

// An instance's tiles added in order: rows (N, C, 2), and its groups' means
// gsum (N, G, 2). Grid (N).
__global__ void __launch_bounds__(kMaxThreads, 2)
    gnb_merge(const float* __restrict__ part, const float* __restrict__ gamma,
              float* __restrict__ rows, float* __restrict__ gsum, int tiles,
              Layout L, float M) {
  const int n = blockIdx.x;
  const float* pn = part + (size_t)n * tiles * L.C * 2;
  float* cs = rows + (size_t)n * L.C * 2;
  for (int c = threadIdx.x; c < L.C; c += L.T) {
    float z = 0.f, zx = 0.f;
    for (int t = 0; t < tiles; ++t) {
      const float2 v =
          reinterpret_cast<const float2*>(pn + (size_t)t * L.C * 2)[c];
      z += v.x;
      zx += v.y;
    }
    cs[2 * c] = z;
    cs[2 * c + 1] = zx;
  }
  __syncthreads();
  group_means(L, cs, cs + 1, gamma, M, gsum + (size_t)n * L.G * 2);
}

// dx of a tile of tile_rows rows. Grid (tiles, N). z is dres where it was
// written (y null), else dy and y (null without the ReLU).
template <typename T>
__global__ void __launch_bounds__(kMaxThreads, 2)
    gnb_apply(const T* __restrict__ x, const T* __restrict__ z,
              const T* __restrict__ y, const float* __restrict__ gamma,
              const float* __restrict__ stats, const float* __restrict__ gsum,
              T* __restrict__ dx, int HW, Layout L, int tile_rows) {
  constexpr int V = Vec16<T>::kN;
  if (threadIdx.x >= L.RT * L.NC) return;
  const int n = blockIdx.y;
  const int p0 = blockIdx.x * tile_rows, p1 = min(HW, p0 + tile_rows);
  const int ch = threadIdx.x % L.NC, r = threadIdx.x / L.NC;
  const size_t base = (size_t)n * HW * L.NC * 16;  // bytes
  float mu[V], rs[V], c1[V];
  chunk_stats<V>(L, n, ch, stats, mu, rs);
  dx_coeffs<V>(L, ch, gamma, gsum + (size_t)n * L.G * 2, mu, rs, c1);
  grad_x<T>(reinterpret_cast<const unsigned char*>(x) + base,
            reinterpret_cast<const unsigned char*>(z) + base,
            y ? reinterpret_cast<const unsigned char*>(y) + base : nullptr,
            reinterpret_cast<unsigned char*>(dx) + base, p0, p1, L, ch, r, c1,
            mu, rs);
}

// dbeta[c], dgamma[c] = the sums over R rows of rows[r][c], in order.
__global__ void gnb_params(const float* __restrict__ rows, int R, int C,
                           float* __restrict__ dgamma,
                           float* __restrict__ dbeta) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= C) return;
  float z = 0.f, zx = 0.f;
  for (int k = 0; k < R; ++k) {
    const float2 v = reinterpret_cast<const float2*>(rows + (size_t)k * C * 2)[c];
    z += v.x;
    zx += v.y;
  }
  dbeta[c] = z;
  dgamma[c] = zx;
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

// The forward's arguments (fgn_group_norm's).
struct FwdArgs {
  const void* x;
  const void* gamma;
  const void* beta;
  const void* res;
  void* out;
  void* part;
  void* stats;
  int N, HW;
  float eps;
  int relu, tile_rows, apply_rows;
};

template <typename T, bool kRes, bool kStats>
cudaError_t launch_onepass(const FwdArgs& a, const Layout& L,
                           cudaStream_t st) {
  const size_t smem = (size_t)a.HW * L.NC * 16 + stats_smem(L);
  if (smem > (size_t)kSmemMax) return cudaErrorInvalidValue;
  auto kernel = gn_onepass<T, kRes, kStats>;
  static bool ready[kMaxDevices] = {};
  const cudaError_t err = allow_smem(kernel, ready);
  if (err != cudaSuccess) return err;
  kernel<<<a.N, L.T, smem, st>>>(
      static_cast<const T*>(a.x), static_cast<const float*>(a.gamma),
      static_cast<const float*>(a.beta), static_cast<const T*>(a.res),
      static_cast<T*>(a.out), static_cast<float*>(a.stats), a.HW, L, a.eps,
      a.relu);
  return cudaGetLastError();
}

template <typename T, bool kRes, bool kStats>
cudaError_t launch_split(const FwdArgs& a, const Layout& L, cudaStream_t st) {
  if (a.tile_rows <= 0 || a.apply_rows <= 0 || a.N > kMaxGrid) {
    return cudaErrorInvalidValue;
  }
  const size_t smem = (size_t)a.tile_rows * L.NC * 16 + stats_smem(L);
  if (smem > (size_t)kSmemMax) return cudaErrorInvalidValue;
  const int tiles = (a.HW + a.tile_rows - 1) / a.tile_rows;
  const int blocks = (a.HW + a.apply_rows - 1) / a.apply_rows;
  auto stats = gn_stats<T>;
  static bool ready[kMaxDevices] = {};
  cudaError_t err = allow_smem(stats, ready);
  if (err != cudaSuccess) return err;
  stats<<<dim3(tiles, a.N), L.T, smem, st>>>(
      static_cast<const T*>(a.x), static_cast<float*>(a.part), a.HW, L,
      a.tile_rows);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  gn_apply<T, kRes, kStats>
      <<<dim3(blocks, a.N), L.T, 2 * L.G * sizeof(float), st>>>(
          static_cast<const T*>(a.x), static_cast<const float*>(a.part),
          static_cast<const float*>(a.gamma),
          static_cast<const float*>(a.beta), static_cast<const T*>(a.res),
          static_cast<T*>(a.out), static_cast<float*>(a.stats), a.HW, L,
          a.eps, a.relu, a.tile_rows, tiles, a.apply_rows);
  return cudaGetLastError();
}

template <typename T, bool kRes, bool kStats>
cudaError_t launch_forward(const FwdArgs& a, const Layout& L,
                           cudaStream_t st) {
  return a.part == nullptr ? launch_onepass<T, kRes, kStats>(a, L, st)
                           : launch_split<T, kRes, kStats>(a, L, st);
}

template <typename T>
cudaError_t dispatch(const FwdArgs& a, int C, int G, int threads,
                     cudaStream_t st) {
  Layout L;
  if (a.N <= 0 || a.HW <= 0 || !make_layout<T>(C, G, threads, &L)) {
    return cudaErrorInvalidValue;
  }
  if (a.stats == nullptr) {  // serving
    return a.res ? launch_forward<T, true, false>(a, L, st)
                 : launch_forward<T, false, false>(a, L, st);
  }
  return a.res ? launch_forward<T, true, true>(a, L, st)
               : launch_forward<T, false, true>(a, L, st);
}

// The backward's arguments (fgn_group_norm_backward's).
struct BwdArgs {
  const void* x;
  const void* dy;
  const void* y;
  const float* gamma;
  const float* stats;
  void* dx;
  void* dres;
  float* dgamma;
  float* dbeta;
  float* rows;
  float* gsum;
  float* part;
  int N, HW, grid, tile_rows;
};

template <typename T>
cudaError_t backward(const BwdArgs& a, int C, int G, int threads,
                     cudaStream_t st) {
  constexpr int V = Vec16<T>::kN;
  Layout L;
  if (a.N <= 0 || a.HW <= 0 || !make_layout<T>(C, G, threads, &L)) {
    return cudaErrorInvalidValue;
  }
  const float M = (float)a.HW * (float)L.Cg;
  const T* x = static_cast<const T*>(a.x);
  const T* dy = static_cast<const T*>(a.dy);
  const T* y = static_cast<const T*>(a.y);
  T* dx = static_cast<T*>(a.dx);
  T* dres = static_cast<T*>(a.dres);
  cudaError_t err;
  int R;
  if (a.part == nullptr) {
    const size_t smem = 2 * (size_t)a.HW * L.NC * 16 + L.T * V * 4 +
                        2 * C * 4 + 2 * G * 4;
    if (smem > (size_t)kSmemMax || a.grid <= 0) return cudaErrorInvalidValue;
    R = a.grid < a.N ? a.grid : a.N;
    auto kernel = gnb_onepass<T>;
    static bool ready[kMaxDevices] = {};
    err = allow_smem(kernel, ready);
    if (err != cudaSuccess) return err;
    kernel<<<R, L.T, smem, st>>>(x, dy, y, a.gamma, a.stats, dx, dres, a.rows,
                                 a.N, a.HW, L);
  } else {
    if (a.tile_rows <= 0 || a.N > kMaxGrid) return cudaErrorInvalidValue;
    const int tiles = (a.HW + a.tile_rows - 1) / a.tile_rows;
    gnb_sums<T><<<dim3(tiles, a.N), L.T, L.T * V * 4, st>>>(
        x, dy, y, a.stats, dres, a.part, a.HW, L, a.tile_rows);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    gnb_merge<<<a.N, L.T, 0, st>>>(a.part, a.gamma, a.rows, a.gsum, tiles, L,
                                   M);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    if (dx) {
      gnb_apply<T><<<dim3(tiles, a.N), L.T, 0, st>>>(
          x, dres ? dres : dy, dres ? nullptr : y, a.gamma, a.stats, a.gsum,
          dx, a.HW, L, a.tile_rows);
    }
    R = a.N;
  }
  err = cudaGetLastError();
  if (err != cudaSuccess || a.dgamma == nullptr) return err;
  gnb_params<<<(C + 255) / 256, 256, 0, st>>>(a.rows, R, C, a.dgamma,
                                              a.dbeta);
  return cudaGetLastError();
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
// kernel. stats null serves; otherwise (training) each (instance, group)'s
// float32 (mean, rstd) goes to stats (N, G, 2). dtype: 0 = float32,
// 1 = bfloat16. Returns the cudaError_t of the launches.
int fgn_group_norm(const void* x, const void* gamma, const void* beta,
                   const void* res, void* out, void* part, void* stats, int N,
                   int HW, int C, int G, float eps, int relu, int dtype,
                   int threads, int tile_rows, int apply_rows, void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const FwdArgs a{x, gamma, beta, res, out, part, stats, N, HW, eps, relu,
                  tile_rows, apply_rows};
  if (dtype == 0) return (int)dispatch<float>(a, C, G, threads, st);
  if (dtype == 1) return (int)dispatch<__nv_bfloat16>(a, C, G, threads, st);
  return (int)cudaErrorInvalidValue;
}

// The gradient of fgn_group_norm's training call. x, dy, y, dx, dres:
// (N, H, W, C) in memory, 16-byte aligned; y (the forward's output) null
// where the forward had no ReLU; dx, dres null where no gradient is wanted
// (dres: where the forward's residual wants one); gamma (C,), stats
// (N, G, 2) as the forward wrote it; dgamma, dbeta (C,) float32, both null
// where neither is wanted. part null takes the onepass route: `grid` blocks
// (at most N; 2 * HW * C values and the scratch within kSmemMax), rows
// (grid, C, 2) float32 scratch. Otherwise the split route: tiles of
// tile_rows rows, part (N, ceil(HW / tile_rows), C, 2), rows (N, C, 2) and
// gsum (N, G, 2) float32 scratch. dtype and threads as fgn_group_norm's.
int fgn_group_norm_backward(const void* x, const void* dy, const void* y,
                            const void* gamma, const void* stats, void* dx,
                            void* dres, void* dgamma, void* dbeta, void* rows,
                            void* gsum, void* part, int N, int HW, int C,
                            int G, int dtype, int threads, int grid,
                            int tile_rows, void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if ((dgamma == nullptr) != (dbeta == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  const BwdArgs a{x, dy, y, static_cast<const float*>(gamma),
                  static_cast<const float*>(stats), dx, dres,
                  static_cast<float*>(dgamma), static_cast<float*>(dbeta),
                  static_cast<float*>(rows), static_cast<float*>(gsum),
                  static_cast<float*>(part), N, HW, grid, tile_rows};
  if (dtype == 0) return (int)backward<float>(a, C, G, threads, st);
  if (dtype == 1) return (int)backward<__nv_bfloat16>(a, C, G, threads, st);
  return (int)cudaErrorInvalidValue;
}

const char* fgn_group_norm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
