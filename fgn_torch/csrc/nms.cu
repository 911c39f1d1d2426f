// Greedy-NMS keep mask for Hopper (sm_90a), a batch of images per launch.
//
// Replaces the JAX package's Pallas TPU kernel
// ops/nms_pallas.py::greedy_alive_pallas (_nms_kernel, IoU in _iou_over).
// Input: per image, Mp candidates sorted by descending score (XYXY boxes and
// an alive flag: false for -inf scores and padding). Output: the keep mask of
// sequential greedy NMS, bit-identical to the blocked sweep
// (ops/nms.py::_greedy_alive there) and to the TPU kernel.
//
// What bounds it on an H100. Bytes: 16 B + 1 B in and 1 B out a candidate,
// 0.18 us at 3.35 TB/s for 8 x 4096. Operations: greedy NMS needs, per image
// with A alive and K kept, K(K-1)/2 + (A-K) IoU tests of 12 f32 operations,
// 0.5 us at 67 TFLOP/s at the flagship's RPN call (chip_smoke.py reckons both
// from each call's inputs). Above both sits the chain of greedy decisions:
// whether row i is kept depends on every kept row before it, so the rows are
// decided in order, each decision after the suppression by the rows decided
// before it. The kernel's time is that chain: a step per chunk of 32 rows.
//
// The design (nms_walk), one launch per call:
//
//   * a cluster of G blocks of 1024 threads walks each image (the wrapper
//     picks G, up to 16, from the clusters the card can hold at once). Each
//     block holds the image's boxes and areas in shared memory (the areas
//     computed as the reference computes them), and owns every G-th chunk of
//     32 columns: their removed bits (dead at entry, or suppressed) live in
//     its shared memory;
//   * step t: warp 0 of chunk t's owner decides the chunk. Its candidates are
//     the rows whose bit is clear and that no kept row of chunk t-1
//     suppresses (table T); the greedy order inside the chunk is the fixpoint
//     keep_j = cand_j and no kept i < j suppresses j (table S), a few rounds
//     of __ballot_sync. The keep word goes to a mailbox slot in every block
//     of the cluster (distributed shared memory; bit 32 marks it written),
//     so the blocks pass no cluster-wide barrier per chunk: each waits only
//     for the word it needs;
//   * meanwhile each block applies the kept rows of chunk t-1 to its own
//     still-alive columns of chunks t+1 and later: work items (column chunk,
//     group of 8 kept rows) over its warps, lanes on columns, hits set with
//     atomicOr in shared memory; and chunk t+1's owner builds its tables S
//     and T (warp j tests column j against the rows of chunks t+1 and t);
//   * one __syncthreads per step in each block.
//
// So only kept rows are tested against later columns still alive, plus the
// two 32 x 32 tables a chunk that let chunk t be decided while chunk t-1
// suppresses; chunks after the last alive row are never walked; nothing goes
// through device memory but the boxes, the alive flags and the keep mask.
// Where the boxes and areas do not fit in shared memory the same walk reads
// them from device memory (kStaged = false; the wrapper decides by Mp).
//
// Bit-exactness: nvcc contracts a*b + c into FMA by default, which would
// round union = aarea + barea - iw*ih differently from the reference. The
// IoU is written with __fmul_rn/__fadd_rn/__fsub_rn in the exact operation
// order of the reference (ops/nms_pallas.py:57-61 there), the areas
// max(x2-x1,0)*max(y2-y1,0) likewise (ops/nms_pallas.py:151-153). The walk
// decides fl(inter / union) > thr without dividing (see Thr below); an IoU is
// symmetric bit for bit, so which box is the row does not matter.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kChunk = 32;           // rows one decision covers: a warp
constexpr int kWalkThreads = 1024;
constexpr int kWalkWarps = kWalkThreads / 32;
constexpr int kRowGroup = 8;         // kept rows per suppression work item
constexpr int kGroups = kChunk / kRowGroup;
constexpr int kMaxCluster = 16;
constexpr int kMaxDevices = 64;
// Dynamic shared memory a walk block may use: the SM's 227 KB less 1 KB
// for the static tables (ops/nms_cuda.py::_WALK_SMEM_MAX).
constexpr int kWalkSmemMax = 232448 - 1024;

__device__ __forceinline__ float box_area(float4 b) {
  return __fmul_rn(fmaxf(__fsub_rn(b.z, b.x), 0.0f),
                   fmaxf(__fsub_rn(b.w, b.y), 0.0f));
}

// The threshold test of the walk without the division. fl(inter / uni) >
// thr, with fl the f32 quotient rounded to nearest even, holds exactly when
// the real quotient exceeds the midpoint between thr and the next float up,
// or equals it and rounding to even goes up. uni > 0, so the test is
// inter > uni * mid, where the product of a 24-bit and a 25-bit significand
// is exact in double.
struct Thr {
  double mid;   // (thr + next float up) / 2
  bool tie_up;  // at the midpoint the quotient rounds to the float above
};

__device__ __forceinline__ Thr make_thr(float thr) {
  const float up = nextafterf(thr, __int_as_float(0x7f800000));
  return {0.5 * ((double)thr + (double)up), (__float_as_uint(up) & 1u) == 0u};
}

__device__ __forceinline__ bool iou_over(const Thr& t, float4 a, float aarea,
                                         float4 b, float barea) {
  const float iw = fmaxf(__fsub_rn(fminf(a.z, b.z), fmaxf(a.x, b.x)), 0.0f);
  const float ih = fmaxf(__fsub_rn(fminf(a.w, b.w), fmaxf(a.y, b.y)), 0.0f);
  const float inter = __fmul_rn(iw, ih);
  const float uni = fmaxf(__fsub_rn(__fadd_rn(aarea, barea), inter), 1e-9f);
  const double p = __dmul_rn((double)uni, t.mid);
  const double x = (double)inter;
  return x > p || (x == p && t.tie_up);
}

// The image's candidates: in shared memory (staged) or in device memory.
template <bool kStaged>
struct Cands {
  const float4* box;
  const float* area;  // staged only
  __device__ __forceinline__ float4 get(int i) const {
    return kStaged ? box[i] : __ldg(box + i);
  }
  __device__ __forceinline__ float area_of(int i, float4 b) const {
    return kStaged ? area[i] : box_area(b);
  }
};

// Grid (G, B), clusters of (G, 1, 1): cluster b walks image b. Dynamic
// shared memory (walk_smem_bytes): the boxes and areas when staged, a
// removed-bits word per chunk, and a mailbox slot per chunk into which the
// deciding block writes the chunk's keep word (bit 32 set) in every block.
template <bool kStaged>
__global__ void __launch_bounds__(kWalkThreads)
nms_walk(const float4* __restrict__ boxes, const uint8_t* __restrict__ alive,
         uint8_t* __restrict__ keep, int Mp, float thr_f) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ uint32_t s_S[2][kChunk];  // [u & 1][j]: rows i < j of chunk u
                                       // that suppress its row j
  __shared__ uint32_t s_T[2][kChunk];  // [u & 1][j]: rows of chunk u-1 that
                                       // suppress row j of chunk u
  __shared__ int s_nend;               // chunks up to the last alive row

  cg::cluster_group cluster = cg::this_cluster();
  const int G = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nc = (Mp + kChunk - 1) / kChunk;
  const size_t img = (size_t)blockIdx.y * Mp;
  const Thr thr = make_thr(thr_f);

  unsigned long long* s_mail = reinterpret_cast<unsigned long long*>(smem);
  uint32_t* s_rm = reinterpret_cast<uint32_t*>(smem + (size_t)nc * 8);
  float4* s_box = reinterpret_cast<float4*>(
      smem + (((size_t)nc * 12 + 15) & ~(size_t)15));
  float* s_area = reinterpret_cast<float*>(s_box + Mp);
  volatile uint32_t* v_rm = s_rm;  // read while other warps set bits
  volatile unsigned long long* v_mail = s_mail;

  if (tid == 0) s_nend = 0;
  for (int q = tid; q < nc; q += kWalkThreads) s_mail[q] = 0ull;
  if (kStaged) {
    for (int i = tid; i < Mp; i += kWalkThreads) {
      const float4 v = boxes[img + i];
      s_box[i] = v;
      s_area[i] = box_area(v);
    }
  }
  __syncthreads();
  for (int q = warp; q < nc; q += kWalkWarps) {
    const int row = q * kChunk + lane;
    const uint32_t dead = __ballot_sync(~0u, row >= Mp || alive[img + row] == 0);
    if (lane == 0) {
      s_rm[q] = dead;
      if (dead != ~0u) atomicMax(&s_nend, q + 1);
    }
  }
  __syncthreads();
  const int n_end = s_nend;
  const Cands<kStaged> cands{kStaged ? s_box : boxes + img, s_area};
  for (size_t i = (size_t)n_end * kChunk + (size_t)rank * kWalkThreads + tid;
       i < (size_t)Mp; i += (size_t)G * kWalkThreads) {
    keep[img + i] = 0;  // past the last alive row: nothing to walk
  }

  // Tables S and T of chunk u (its owner; all warps).
  auto tables = [&](int u) {
    const int slot = u & 1;
    const uint32_t rm_u = v_rm[u];  // a snapshot: bits only get set
    const uint32_t rm_p = u > 0 ? v_rm[u - 1] : ~0u;
    const bool live_i = !((rm_u >> lane) & 1u);
    const bool live_p = !((rm_p >> lane) & 1u);
    const int ri = u * kChunk + lane;
    const int pi = ri - kChunk;
    float4 bi = make_float4(0.f, 0.f, 0.f, 0.f), bp = bi;
    float ai = 0.f, ap = 0.f;
    if (live_i) {
      bi = cands.get(ri);
      ai = cands.area_of(ri, bi);
    }
    if (live_p) {
      bp = cands.get(pi);
      ap = cands.area_of(pi, bp);
    }
    for (int j = warp; j < kChunk; j += kWalkWarps) {
      uint32_t s = 0u, t = 0u;
      if (!((rm_u >> j) & 1u)) {  // a removed column is never a candidate
        const int rj = u * kChunk + j;
        const float4 bj = cands.get(rj);
        const float aj = cands.area_of(rj, bj);
        s = __ballot_sync(~0u, lane < j && live_i && iou_over(thr, bi, ai, bj, aj));
        t = __ballot_sync(~0u, live_p && iou_over(thr, bp, ap, bj, aj));
      }
      if (lane == 0) {
        s_S[slot][j] = s;
        s_T[slot][j] = t;
      }
    }
  };

  // Decide chunk t (warp 0 of its owner); kprev: the keep word of chunk t-1.
  // The keep word goes to every block's mailbox.
  auto decide = [&](int t, uint32_t kprev) {
    const int slot = t & 1;
    const uint32_t rm = v_rm[t];  // final: chunk t-2 suppressed it last round
    const bool cand = !((rm >> lane) & 1u) && !(s_T[slot][lane] & kprev);
    const uint32_t sj = s_S[slot][lane];
    uint32_t kept = __ballot_sync(~0u, cand);
    for (;;) {
      const uint32_t next = __ballot_sync(~0u, cand && !(sj & kept));
      if (next == kept) break;
      kept = next;
    }
    const int row = t * kChunk + lane;
    if (row < Mp) keep[img + row] = (uint8_t)((kept >> lane) & 1u);
    const unsigned long long word = (1ull << 32) | kept;
    if (G == 1) {
      if (lane == 0) s_mail[t] = word;
    } else if (lane < G) {
      *cluster.map_shared_rank(&s_mail[t], lane) = word;
    }
  };

  // The kept rows of chunk t-1 (kprev) against the block's chunks >= t+1;
  // first: the block's first chunk from t+1 on.
  auto suppress = [&](int t, uint32_t kprev, int first) {
    if (first >= n_end) return;
    const int items = ((n_end - 1 - first) / G + 1) * kGroups;
    const int row0 = (t - 1) * kChunk;
    for (int item = warp; item < items; item += kWalkWarps) {
      const int g = item % kGroups;
      uint32_t rows = (kprev >> (g * kRowGroup)) & ((1u << kRowGroup) - 1u);
      if (!rows) continue;
      const int q = first + (item / kGroups) * G;
      const uint32_t rm = v_rm[q];
      if (rm == ~0u) continue;
      const bool live = !((rm >> lane) & 1u);
      const int col = q * kChunk + lane;
      float4 bc = make_float4(0.f, 0.f, 0.f, 0.f);
      float ac = 0.f;
      if (live) {
        bc = cands.get(col);
        ac = cands.area_of(col, bc);
      }
      bool hit = false;
      while (rows) {
        const int i = row0 + g * kRowGroup + __ffs(rows) - 1;
        rows &= rows - 1u;
        const float4 br = cands.get(i);
        hit = iou_over(thr, br, cands.area_of(i, br), bc, ac) | hit;
      }
      const uint32_t h = __ballot_sync(~0u, live && hit);
      if (lane == 0 && h) atomicOr(&s_rm[q], h);
    }
  };

  if (rank == 0 && n_end > 0) tables(0);
  if (G > 1) cluster.sync();  // every block runs before any mailbox store
  // owner: t's owner is this block; first: this block's first chunk >= t+1
  int owner_rank = 0;
  int first = 1 + (rank + G - 1) % G;
  for (int t = 0; t < n_end; ++t) {
    if (t > 0 && tid == 0) {
      while (!(v_mail[t - 1] >> 32)) {
      }
    }
    __syncthreads();  // also: this block's work on chunk t-1 is done
    const uint32_t kprev = t > 0 ? (uint32_t)v_mail[t - 1] : 0u;
    if (owner_rank == rank && warp == 0) decide(t, kprev);
    if (t + 1 < n_end && first == t + 1) tables(t + 1);
    if (kprev) suppress(t, kprev, first);
    owner_rank = owner_rank + 1 == G ? 0 : owner_rank + 1;
    if (first == t + 1) first += G;
  }
  // no block leaves while another may still write into its mailbox
  if (G > 1) cluster.sync();
}

size_t walk_smem_bytes(int Mp, bool staged) {
  const size_t nc = ((size_t)Mp + kChunk - 1) / kChunk;
  return ((nc * 12 + 15) & ~(size_t)15) + (staged ? (size_t)Mp * 20 : 0);
}

// The walk's function attributes, set once per device (a host call that
// would otherwise cost microseconds a launch).
template <bool kStaged>
cudaError_t prepare_walk() {
  static bool ready[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (!ready[dev]) {
    err = cudaFuncSetAttribute(nms_walk<kStaged>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kWalkSmemMax);
    if (err == cudaSuccess) {
      err = cudaFuncSetAttribute(
          nms_walk<kStaged>, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    }
    if (err != cudaSuccess) return err;
    ready[dev] = true;
  }
  return cudaSuccess;
}

cudaLaunchConfig_t walk_config(int G, int B, size_t smem, cudaStream_t st,
                               cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(G, B, 1);
  cfg.blockDim = dim3(kWalkThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = G;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

template <bool kStaged>
cudaError_t launch_walk(const void* boxes, const void* alive, void* keep, int B,
                        int Mp, float thr, int G, size_t smem,
                        cudaStream_t st) {
  cudaError_t err = prepare_walk<kStaged>();
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = walk_config(G, B, smem, st, attr);
  err = cudaLaunchKernelEx(&cfg, nms_walk<kStaged>,
                           static_cast<const float4*>(boxes),
                           static_cast<const uint8_t*>(alive),
                           static_cast<uint8_t*>(keep), Mp, thr);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <bool kStaged>
int walk_clusters(int G, size_t smem) {
  cudaError_t err = prepare_walk<kStaged>();
  if (err != cudaSuccess) return -(int)err;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = walk_config(G, 1, smem, 0, attr);
  int n = 0;
  err = cudaOccupancyMaxActiveClusters(&n, nms_walk<kStaged>, &cfg);
  return err == cudaSuccess ? n : -(int)err;
}

}  // namespace

extern "C" {

// boxes (B, Mp, 4) f32, 16-byte aligned; alive (B, Mp) uint8 (bool); keep
// (B, Mp) uint8 (bool). cluster: blocks per image (1-16); staged: 1 to hold
// the boxes in shared memory, 0 to read them from device memory. Returns the
// cudaError_t of the launch.
int fgn_nms_keep(const void* boxes, const void* alive, void* keep, int B,
                 int Mp, float thr, int cluster, int staged, void* stream) {
  if (B <= 0 || B > 65535 || Mp <= 0 || cluster < 1 ||
      cluster > kMaxCluster || (reinterpret_cast<uintptr_t>(boxes) & 15)) {
    return (int)cudaErrorInvalidValue;
  }
  const size_t smem = walk_smem_bytes(Mp, staged != 0);
  if (smem > (size_t)kWalkSmemMax) return (int)cudaErrorInvalidValue;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const cudaError_t err =
      staged ? launch_walk<true>(boxes, alive, keep, B, Mp, thr, cluster,
                                 smem, st)
             : launch_walk<false>(boxes, alive, keep, B, Mp, thr, cluster,
                                  smem, st);
  return (int)err;
}

// The clusters of `cluster` walk blocks (one image each) that the current
// device can run at once, for an image of Mp candidates; a negative
// cudaError_t on failure.
int fgn_nms_walk_clusters(int cluster, int Mp, int staged) {
  if (Mp <= 0 || cluster < 1 || cluster > kMaxCluster) {
    return -(int)cudaErrorInvalidValue;
  }
  const size_t smem = walk_smem_bytes(Mp, staged != 0);
  if (smem > (size_t)kWalkSmemMax) return -(int)cudaErrorInvalidValue;
  return staged ? walk_clusters<true>(cluster, smem)
                : walk_clusters<false>(cluster, smem);
}

const char* fgn_nms_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
