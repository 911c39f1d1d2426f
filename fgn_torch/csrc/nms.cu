// Greedy-NMS keep mask for Hopper (sm_90a), a batch of images per launch.
//
// Replaces the JAX package's Pallas TPU kernel
// ops/nms_pallas.py::greedy_alive_pallas (_nms_kernel, IoU in _iou_over).
// Input: per image, Mp candidates sorted by descending score (XYXY boxes,
// their areas, and an alive flag: false for -inf scores and padding).
// Output: the keep mask of sequential greedy NMS, bit-identical to the
// blocked sweep (ops/nms.py::_greedy_alive there) and to the TPU kernel.
//
// Bound on an H100: neither bytes nor operations but the sequential chain of
// greedy decisions. The bytes are tiny (16 B + 4 B + 1 B in and 1 B out per
// candidate); the pairwise IoUs (Mp^2 / 2 per image, 67 M at b8, Mp=4096)
// take microseconds at the card's f32 rate. The TPU kernel's in-block
// fixpoint loop is replaced by the classic bitmask design, which moves all
// pairwise work into one parallel pass and leaves a short serial walk:
//
//   * nms_mask: grid (column block, row block, image), 64 threads, upper
//     triangle of blocks only. Thread t of block (rb, cb) writes one 64-bit
//     word: bit k is set when IoU(row rb*64+t, column cb*64+k) > thr and the
//     column comes after the row.
//   * nms_reduce: one thread block per image walks the rows in order, 64 at
//     a time. The removed-mask lives in shared memory, one word per column
//     block. For each 64-row chunk one thread decides the chunk's rows from
//     its diagonal words (staged in shared memory), then all threads OR the
//     kept rows' words into the later words of the removed-mask. Rows not
//     alive at entry are never kept, so they never suppress.
//
// Bit-exactness: nvcc contracts a*b + c into FMA by default, which would
// round union = aarea + barea - iw*ih differently from the reference. The
// IoU is written with __fmul_rn/__fadd_rn/__fsub_rn/__fdiv_rn in the exact
// operation order of the reference (ops/nms_pallas.py:57-61 there), and the
// areas max(x2-x1,0)*max(y2-y1,0) come from the caller, computed as the
// reference computes them.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWord = 64;            // columns per mask word
constexpr int kReduceThreads = 256;  // threads of the per-image walk

__device__ __forceinline__ bool iou_over(float thr, float ax1, float ay1,
                                         float ax2, float ay2, float aarea,
                                         float bx1, float by1, float bx2,
                                         float by2, float barea) {
  const float iw = fmaxf(__fsub_rn(fminf(ax2, bx2), fmaxf(ax1, bx1)), 0.0f);
  const float ih = fmaxf(__fsub_rn(fminf(ay2, by2), fmaxf(ay1, by1)), 0.0f);
  const float inter = __fmul_rn(iw, ih);
  const float uni = fmaxf(__fsub_rn(__fadd_rn(aarea, barea), inter), 1e-9f);
  return __fdiv_rn(inter, uni) > thr;
}

__global__ void __launch_bounds__(kWord)
nms_mask(const float4* __restrict__ boxes, const float* __restrict__ areas,
         unsigned long long* __restrict__ mask, int Mp, int nw, float thr) {
  const int cb = blockIdx.x;
  const int rb = blockIdx.y;
  if (cb < rb) return;  // lower triangle: never read by nms_reduce
  const int b = blockIdx.z;
  const int t = threadIdx.x;
  __shared__ float4 s_box[kWord];
  __shared__ float s_area[kWord];

  const size_t img = (size_t)b * Mp;
  const int col0 = cb * kWord;
  const int ncols = min(kWord, Mp - col0);
  if (t < ncols) {
    s_box[t] = boxes[img + col0 + t];
    s_area[t] = areas[img + col0 + t];
  }
  __syncthreads();

  const int row = rb * kWord + t;
  if (row >= Mp) return;
  const float4 a = boxes[img + row];
  const float aarea = areas[img + row];
  unsigned long long bits = 0ull;
  for (int k = (cb == rb) ? t + 1 : 0; k < ncols; ++k) {
    const float4 c = s_box[k];
    if (iou_over(thr, a.x, a.y, a.z, a.w, aarea, c.x, c.y, c.z, c.w,
                 s_area[k])) {
      bits |= 1ull << k;
    }
  }
  mask[(img + row) * nw + cb] = bits;
}

__global__ void __launch_bounds__(kReduceThreads)
nms_reduce(const unsigned long long* __restrict__ mask,
           const uint8_t* __restrict__ alive, uint8_t* __restrict__ keep,
           int Mp, int nw) {
  extern __shared__ unsigned long long s_removed[];  // nw words
  __shared__ unsigned long long s_diag[kWord];
  __shared__ unsigned s_alive[2];
  __shared__ unsigned long long s_keep;

  const int b = blockIdx.x;
  const int t = threadIdx.x;
  const size_t img = (size_t)b * Mp;
  for (int w = t; w < nw; w += blockDim.x) s_removed[w] = 0ull;

  for (int cb = 0; cb < nw; ++cb) {
    const int row0 = cb * kWord;
    const int n = min(kWord, Mp - row0);
    if (t < kWord) {  // warps 0 and 1, fully active
      const bool a = t < n && alive[img + row0 + t] != 0;
      s_diag[t] = t < n ? mask[(img + row0 + t) * nw + cb] : 0ull;
      const unsigned ballot = __ballot_sync(0xffffffffu, a);
      if ((t & 31) == 0) s_alive[t >> 5] = ballot;
    }
    __syncthreads();

    if (t == 0) {  // serial greedy walk over this chunk's rows
      unsigned long long removed = s_removed[cb];
      const unsigned long long alive_bits =
          (unsigned long long)s_alive[0] | ((unsigned long long)s_alive[1] << 32);
      unsigned long long kept = 0ull;
      for (int r = 0; r < n; ++r) {
        const unsigned long long bit = 1ull << r;
        if ((alive_bits & bit) && !(removed & bit)) {
          kept |= bit;
          removed |= s_diag[r];
        }
      }
      s_keep = kept;
    }
    __syncthreads();

    const unsigned long long kept = s_keep;
    if (t < n) keep[img + row0 + t] = (uint8_t)((kept >> t) & 1ull);
    if (kept) {
      for (int w = cb + 1 + t; w < nw; w += blockDim.x) {
        unsigned long long acc = s_removed[w];
        unsigned long long m = kept;
        while (m) {
          const int r = __ffsll((long long)m) - 1;
          m &= m - 1;
          acc |= mask[(img + row0 + r) * nw + w];
        }
        s_removed[w] = acc;
      }
    }
    __syncthreads();
  }
}

}  // namespace

extern "C" {

// boxes (B, Mp, 4) f32, areas (B, Mp) f32, alive (B, Mp) uint8 (bool),
// scratch (B, Mp, ceil(Mp/64)) uint64, keep (B, Mp) uint8 (bool).
// Returns the cudaError_t of the launches.
int fgn_nms_keep(const void* boxes, const void* areas, const void* alive,
                 void* scratch, void* keep, int B, int Mp, float thr,
                 void* stream) {
  if (B <= 0 || Mp <= 0) return (int)cudaErrorInvalidValue;
  const int nw = (Mp + kWord - 1) / kWord;
  const size_t smem = (size_t)nw * sizeof(unsigned long long);
  if (smem > 48 * 1024 || nw > 65535 || B > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  unsigned long long* mask = static_cast<unsigned long long*>(scratch);
  nms_mask<<<dim3(nw, nw, B), kWord, 0, st>>>(
      static_cast<const float4*>(boxes), static_cast<const float*>(areas),
      mask, Mp, nw, thr);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  nms_reduce<<<B, kReduceThreads, smem, st>>>(
      mask, static_cast<const uint8_t*>(alive), static_cast<uint8_t*>(keep),
      Mp, nw);
  return (int)cudaGetLastError();
}

const char* fgn_nms_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
