// Attention with decomposed relative positions (K4), for the ViT backbone's
// window and global blocks, for Hopper (sm_90a).
//
// Replaces no Pallas kernel of the JAX package: that package has no ViT.
// The port's ViTDet backbone (fgn_torch/models/vit.py) ran its attention as
// PyTorch's fused SDPA over a relative-position bias built in device memory:
// two einsums, their broadcast add into a (B, heads, T, T) bf16 tensor (2.1
// GB for one global block over a b4 batch of 1024 px images), and the copies
// of q and of that bias around the call. This kernel computes, for each
// (image or window b, head) and every query i and key j of a T = h x w grid,
//
//   S[i, j] = (q_i . k_j) / sqrt(d) + q_i . Rh[row(i), row(j)]
//                                   + q_i . Rw[col(i), col(j)]
//   out_i   = sum_j softmax_j(S[i, :]) v_j
//
// with q unscaled in the two bias terms (detectron2's add_decomposed_rel_pos)
// and Rh (h, h, d), Rw (w, w, d) the gathered tables. The bias never exists
// in device memory: each block computes its queries' terms
// rel_h[i, r] = q_i . Rh[row(i), r] and rel_w[i, c] = q_i . Rw[col(i), c]
// once, in f32, into shared memory (2 d (h + w) FLOPs a query), and adds
// rel_h[i, row(j)] + rel_w[i, col(j)] to each score tile in registers. Scores,
// the online softmax (base 2) and the P.V sums are f32; q, k, v, the tables
// and the output bf16. d = 64.
//
// Bound on an H100 SXM: tensor-core FLOPs, 989.4 TFLOP/s dense bf16. A query
// does 4 d T FLOPs against its T keys and reads 4 d bytes of q, k, v and out
// per key it meets: at the ViT's shapes (T = 4096, 196, 64) it is far above
// the card's 295 FLOPs a byte. What the design does about it: the FLOPs run
// on the tensor cores (mma.sync m16n8k16, bf16 in, f32 out), each K and V
// tile is loaded once per block of 128 queries (16 KB of keys and values
// feed 2 MFLOP), the tiles come in with cp.async while the previous tile is
// computed (three stages), shared-memory rows are XOR-swizzled so that every
// ldmatrix is free of bank conflicts, and the bias adds no device traffic.
// FlashAttention-2's form (Dao, arXiv:2307.08691): one block a query tile,
// four warps of 32 queries, the key loop inside the block.
//
// Query tiles. A block takes a patch of 16 x 8 grid cells of one (b,
// head): 128 query slots, 16 down each column of the patch (slot = 16 col
// + row). Slots outside the grid are zero queries whose outputs are not
// stored. Each m16 row tile of the tensor-core products is then one grid
// column, so rel_w of a tile is one product (A = the tile's q, B =
// Rw[col]^T); rel_h takes the patch's slots a grid row at a time, two rows
// to a product (ldmatrix gathers the 16 q rows), each row's 8 kept. A patch
// of a 64 x 64 grid reads 24 table slices (8 KB each) from L2, where a run
// of 128 consecutive tokens would need 66. A 14 x 14 window takes two
// patches (8 and 6 columns, 14 of 16 rows), as a run of 128 tokens would.
// The first 16 table rows of each of a warp's six products (the whole
// slice at the windows' and the supports' grids) load at once, under q's
// tile, so that their latencies overlap.
//
// Key tiles: 64 keys of KR x KC grid cells, KC the least of 8, 16, 32, 64
// not below w (64 past it), KR = 64 / KC: 1 x 64 at the global blocks' 64 x
// 64 grid, 4 x 16 at the 14 x 14 windows, 8 x 8 at the supports' 8 x 8
// grids. A thread's 16 keys of a tile then lie at compile-time rows and
// columns of the tile: it adds rel_h from KR values a query and rel_w from
// 8 pairs, read as float2, the same columns in every tile of a column.
// Cells outside the grid (a window's 14 columns in tiles of 16) are zero
// keys that score -inf; the padded window tokens are real keys, as in
// detectron2.
//
// Memory: q, k, v are read through their strides (the qkv projection's
// permuted view: no copy), the output is written as (B, T, heads, d), 16
// bytes a thread, through shared memory. Shared memory: three K/V stages
// (48 KB; q's tile shares the last during the prologue) and the f32 terms,
// 128 x (h + w) floats and a little padding: 113 KB at h = w = 64, two
// blocks an SM.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kD = 64;             // head size
constexpr int kBM = 128;           // query slots a block
constexpr int kBN = 64;            // keys a tile
constexpr int kThreads = 128;      // four warps, 32 query slots each
constexpr int kRowBytes = kD * 2;  // one token's q, k or v in bf16
constexpr int kTileBytes = kBN * kRowBytes;  // one K or V tile: 8 KB
constexpr int kStageBytes = 2 * kTileBytes;  // K and V: 16 KB
constexpr int kStages = 3;         // K/V tiles in flight or in use
constexpr int kPatchRows = 16;     // a block's query patch: 16 x 8 grid cells
constexpr int kPatchCols = kBM / kPatchRows;
constexpr int kSmemMax = 232448;
constexpr int kMaxDevices = 64;
constexpr float kLog2e = 1.4426950408889634f;

struct Args {
  const __nv_bfloat16* q;
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  const __nv_bfloat16* rh;  // (h, h, kD)
  const __nv_bfloat16* rw;  // (w, w, kD)
  __nv_bfloat16* out;       // (B, T, heads, kD)
  long long sqb, sqh, sqt, skb, skh, skt, svb, svh, svt;  // in elements
  int heads, T, h, w, patches_w;
  int hs, ws;  // row strides of rel_h and rel_w in shared memory (floats)
  int wswz;    // rel_w's swizzle mask: 24 where ws is a multiple of 32
  float scale_log2;  // log2(e) / sqrt(d)
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Byte offset of 16-byte chunk `ch` (0-7) of row `row` in a tile of 128-byte
// rows, swizzled so that eight rows at one chunk hit eight bank groups.
__device__ __forceinline__ uint32_t swz(int row, int ch) {
  return static_cast<uint32_t>(row * kRowBytes + ((ch ^ (row & 7)) << 4));
}

// 16 bytes global -> shared; zero-filled where !pred (src is then not read).
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool pred) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(pred ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// c += a . b: m16n8k16, bf16 operands, f32 accumulators.
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float neg_inf() {
  return __int_as_float(0xff800000);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&p);
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Query slot s of a block lies at row s % 16, column s / 16 of its patch.
__device__ __forceinline__ int slot_token(const Args& a, int pr0, int pc0,
                                          int s) {
  const int r = pr0 + (s & 15), c = pc0 + (s >> 4);
  return (r < a.h && c < a.w) ? r * a.w + c : -1;
}

// B fragments of kNT x 8 table rows n0 ... (n < n_rows) of a table slice
// tab (rows of kD), for m16n8k16: bf[nt][ks] holds row n0 + 8 nt + lane / 4,
// columns 16 ks + 2 (lane % 4) + {0, 1, 8, 9}. Rows past n_rows are zero
// and not read.
template <int kNT>
__device__ __forceinline__ void load_rows(uint32_t (&bf)[kNT][4][2],
                                          const __nv_bfloat16* tab, int n_rows,
                                          int n0, int lane) {
#pragma unroll
  for (int nt = 0; nt < kNT; ++nt) {
    const int n = n0 + nt * 8 + (lane >> 2);
    const bool ok = n < n_rows;
    const __nv_bfloat16* row = tab + (size_t)(ok ? n : 0) * kD + 2 * (lane & 3);
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      bf[nt][ks][0] = ok ? ld32(row + ks * 16) : 0u;
      bf[nt][ks][1] = ok ? ld32(row + ks * 16 + 8) : 0u;
    }
  }
}

// One bias term of 16 query slots over those rows: acc[n] = q_m . tab[n]
// (A = af), stored times log2(e) at d0[n ^ x0] for the thread's row m =
// lane / 4 (d0 null: not stored) and at d1[n ^ x1] for row m + 8.
template <int kNT>
__device__ __forceinline__ void rel_rows(const uint32_t (&af)[4][4],
                                         const uint32_t (&bf)[kNT][4][2],
                                         int n_rows, int n0, float* d0, int x0,
                                         float* d1, int x1, int lane) {
  const int kq = 2 * (lane & 3);
#pragma unroll
  for (int nt = 0; nt < kNT; ++nt) {
    const int n = n0 + nt * 8;
    if (n >= n_rows) break;
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int ks = 0; ks < 4; ++ks)
      mma(acc, af[ks], bf[nt][ks][0], bf[nt][ks][1]);
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int c = n + kq + e;
      if (c >= n_rows) continue;
      if (d0) d0[c ^ x0] = acc[e] * kLog2e;
      if (d1) d1[c ^ x1] = acc[2 + e] * kLog2e;
    }
  }
}

// A whole bias term: its first kHead rows from first (loaded ahead), the
// rest loaded here, 48 at a time.
constexpr int kHead = 16;
__device__ __forceinline__ void rel_term(const uint32_t (&af)[4][4],
                                         const uint32_t (&first)[2][4][2],
                                         const __nv_bfloat16* tab, int n_rows,
                                         float* d0, int x0, float* d1, int x1,
                                         int lane) {
  rel_rows<2>(af, first, n_rows, 0, d0, x0, d1, x1, lane);
  for (int n0 = kHead; n0 < n_rows; n0 += 48) {
    uint32_t bf[6][4][2];
    load_rows<6>(bf, tab, n_rows, n0, lane);
    rel_rows<6>(af, bf, n_rows, n0, d0, x0, d1, x1, lane);
  }
}

// Key tiles of kKR x kKC grid cells (kKR * kKC = kBN): the tile's key k
// lies at row k / kKC, column k % kKC of the tile.
template <int kKC>
__global__ void __launch_bounds__(kThreads, 2)
    vit_attention_kernel(const Args a) {
  constexpr int kKR = kBN / kKC;
  extern __shared__ __align__(128) unsigned char smem[];
  // kStages K/V stages; q's tile shares the last during the prologue
  unsigned char* qtile = smem + (kStages - 1) * kStageBytes;
  float* relh = reinterpret_cast<float*>(smem + kStages * kStageBytes);
  float* relw = relh + kBM * a.hs;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int nr = lane >> 2, kq = 2 * (lane & 3);
  const int b = blockIdx.z, head = blockIdx.y;
  const int pr0 = (blockIdx.x / a.patches_w) * kPatchRows;
  const int pc0 = (blockIdx.x % a.patches_w) * kPatchCols;
  const __nv_bfloat16* qb = a.q + b * a.sqb + head * a.sqh;
  const __nv_bfloat16* kb = a.k + b * a.skb + head * a.skh;
  const __nv_bfloat16* vb = a.v + b * a.svb + head * a.svh;
  const int n_ct = (a.w + kKC - 1) / kKC;
  const int n_tiles = ((a.h + kKR - 1) / kKR) * n_ct;

  // key tile jt into its stage (jt % kStages); cells outside the grid are
  // zero keys
  auto load_kv = [&](int jt) {
    const uint32_t ks = smem_u32(smem + (jt % kStages) * kStageBytes);
    const uint32_t vs = ks + kTileBytes;
    const int gr = (jt / n_ct) * kKR, gc = (jt % n_ct) * kKC;
#pragma unroll
    for (int i = tid; i < kBN * 8; i += kThreads) {
      const int k = i >> 3, ch = i & 7;
      const int r = gr + k / kKC, c = gc + k % kKC;
      const bool ok = r < a.h && c < a.w;
      const int j = r * a.w + c;
      cp_async16(ks + swz(k, ch), ok ? kb + j * a.skt + ch * 8 : a.k, ok);
      cp_async16(vs + swz(k, ch), ok ? vb + j * a.svt + ch * 8 : a.v, ok);
    }
  };

  // q's tile (zero rows for slots outside the grid), then the first
  // kStages - 1 K/V tiles, one commit group each
  const uint32_t qs = smem_u32(qtile);
#pragma unroll
  for (int i = tid; i < kBM * 8; i += kThreads) {
    const int s = i >> 3, ch = i & 7, t = slot_token(a, pr0, pc0, s);
    cp_async16(qs + swz(s, ch), t >= 0 ? qb + t * a.sqt + ch * 8 : a.q,
               t >= 0);
  }
  cp_async_commit();
#pragma unroll
  for (int jt = 0; jt < kStages - 1; ++jt) {
    if (jt < n_tiles) load_kv(jt);
    cp_async_commit();
  }
  // The warp's six bias products: rel_w of its two columns (u = mt), rel_h
  // of its four grid rows (u = 2 + 2 gi + hf: row 2 (2 warp + gi) + hf of
  // the patch). Their first kHead table rows (whole slices where the grid
  // is 16 wide or less: the windows, the supports) load now, all at once,
  // under q's tile.
  const int m0 = warp * 32;
  const __nv_bfloat16* tab[6];
  int n_rows[6];
  uint32_t first[6][2][4][2];
#pragma unroll
  for (int u = 0; u < 6; ++u) {
    const bool w_ = u < 2;
    const int g = w_ ? pc0 + 2 * warp + u : pr0 + 4 * warp + (u - 2);
    const bool ok = g < (w_ ? a.w : a.h);
    tab[u] = w_ ? a.rw + (size_t)(ok ? g : 0) * a.w * kD
                : a.rh + (size_t)(ok ? g : 0) * a.h * kD;
    n_rows[u] = ok ? (w_ ? a.w : a.h) : 0;
    load_rows<2>(first[u], tab[u], n_rows[u], 0, lane);
  }

  cp_async_wait<kStages - 1>();
  __syncthreads();  // q's tile is in

  // The warp's q fragments: its m16 tiles are the patch's columns 2 warp
  // and 2 warp + 1 (slots 16 (2 warp + mt) + row), kept in registers for the
  // key loop.
  uint32_t qf[2][4][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int ks = 0; ks < 4; ++ks)
      ldsm_x4(qf[mt][ks],
              qs + swz(m0 + mt * 16 + ((lane >> 3) & 1) * 8 + (lane & 7),
                       ks * 2 + (lane >> 4)));

  // rel_w: one product a column, A = the column's m16 tile, B = Rw[col]^T.
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
    if (!n_rows[mt]) break;
    float* d[2];
    int x[2];
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int sl = m0 + mt * 16 + nr + 8 * hf;
      d[hf] = pr0 + nr + 8 * hf < a.h ? relw + sl * a.ws : nullptr;
      x[hf] = ((sl & 3) << 3) & a.wswz;
    }
    rel_term(qf[mt], first[mt], tab[mt], n_rows[mt], d[0], x[0], d[1], x[1],
             lane);
  }

  // rel_h: the warp's grid rows 4 warp ... 4 warp + 3 of the patch, two at a
  // time: A gathers the 8 slots of each (ldmatrix rows: the patch's columns
  // 0-7 at row 2 g, then at row 2 g + 1), one product a row, kept for its 8.
#pragma unroll
  for (int gi = 0; gi < 2; ++gi) {
    const int rg = 2 * (2 * warp + gi);  // the group's first row in the patch
    if (!n_rows[2 + 2 * gi]) break;
    const int m = ((lane >> 3) & 1) * 8 + (lane & 7);  // this lane's A row
    uint32_t af[4][4];
#pragma unroll
    for (int ks = 0; ks < 4; ++ks)
      ldsm_x4(af[ks], qs + swz((m & 7) * 16 + rg + (m >> 3),
                               ks * 2 + (lane >> 4)));
    // C rows nr (row rg, column nr) and nr + 8 (row rg + 1, column nr)
    const bool col_ok = pc0 + nr < a.w;
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int u = 2 + 2 * gi + hf;
      if (!n_rows[u]) break;
      float* d = col_ok ? relh + (nr * 16 + rg + hf) * a.hs : nullptr;
      rel_term(af, first[u], tab[u], n_rows[u], hf ? nullptr : d, 0,
               hf ? d : nullptr, 0, lane);
    }
  }

  // The key loop. Thread rows: slots m0 + 16 mt + nr + 8 hf.
  float o[2][8][4];
  float mrow[2][2], lrow[2][2];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[mt][nt][e] = 0.f;
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      mrow[mt][hf] = neg_inf();
      lrow[mt][hf] = 0.f;
    }
  }

  for (int jt = 0; jt < n_tiles; ++jt) {
    cp_async_wait<kStages - 2>();
    // tile jt is in; every warp is done with tile jt - 1, whose stage takes
    // tile jt + kStages - 1 (the last stage's first tile waits for the
    // prologue, which read q's tile there)
    __syncthreads();
    if (jt + kStages - 1 < n_tiles) load_kv(jt + kStages - 1);
    cp_async_commit();
    const uint32_t ks_ = smem_u32(smem + (jt % kStages) * kStageBytes);
    const uint32_t vs_ = ks_ + kTileBytes;

    // S = q . k^T
    float s[2][8][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[mt][nt][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t kf[4];
        ldsm_x4(kf, ks_ + swz(np * 16 + (lane >> 4) * 8 + (lane & 7),
                              kk * 2 + ((lane >> 3) & 1)));
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          mma(s[mt][2 * np], qf[mt][kk], kf[0], kf[1]);
          mma(s[mt][2 * np + 1], qf[mt][kk], kf[2], kf[3]);
        }
      }
    }

    // scale, bias, cells outside the grid (base-2 logits): the thread's keys
    // 8 nt + kq + {0, 1} lie at tile row 8 nt / kKC, column (8 nt) % kKC + kq
    // + {0, 1}
    const int gr = (jt / n_ct) * kKR, gc = (jt % n_ct) * kKC;
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int sl = m0 + mt * 16 + nr + hf * 8;
        const float* bh = relh + sl * a.hs + gr;
        const float* bw = relw + sl * a.ws;
        const int x = ((sl & 3) << 3) & a.wswz;
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
          const int kr = nt * 8 / kKC, c = gc + (nt * 8) % kKC + kq;
          const float h_ = bh[kr];
          const float2 w2 = *reinterpret_cast<const float2*>(bw + (c ^ x));
          const bool okr = gr + kr < a.h;
          float& s0 = s[mt][nt][2 * hf];
          float& s1 = s[mt][nt][2 * hf + 1];
          s0 = okr && c < a.w ? fmaf(s0, a.scale_log2, h_ + w2.x) : neg_inf();
          s1 = okr && c + 1 < a.w ? fmaf(s1, a.scale_log2, h_ + w2.y)
                                  : neg_inf();
        }
      }

    // online softmax; P in bf16 as the A operand of P . V
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        float mx = mrow[mt][hf];
#pragma unroll
        for (int nt = 0; nt < 8; ++nt)
          mx = fmaxf(mx, fmaxf(s[mt][nt][2 * hf], s[mt][nt][2 * hf + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float alpha = ex2(mrow[mt][hf] - mx);
        mrow[mt][hf] = mx;
        float sum = 0.f;
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
          const float p0 = ex2(s[mt][nt][2 * hf] - mx);
          const float p1 = ex2(s[mt][nt][2 * hf + 1] - mx);
          s[mt][nt][2 * hf] = p0;
          s[mt][nt][2 * hf + 1] = p1;
          sum += p0 + p1;
          o[mt][nt][2 * hf] *= alpha;
          o[mt][nt][2 * hf + 1] *= alpha;
        }
        lrow[mt][hf] = lrow[mt][hf] * alpha + sum;
      }

#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {  // keys 16 kk ... 16 kk + 15
      uint32_t pf[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        pf[mt][0] = pack_bf16(s[mt][2 * kk][0], s[mt][2 * kk][1]);
        pf[mt][1] = pack_bf16(s[mt][2 * kk][2], s[mt][2 * kk][3]);
        pf[mt][2] = pack_bf16(s[mt][2 * kk + 1][0], s[mt][2 * kk + 1][1]);
        pf[mt][3] = pack_bf16(s[mt][2 * kk + 1][2], s[mt][2 * kk + 1][3]);
      }
#pragma unroll
      for (int dp = 0; dp < 4; ++dp) {
        uint32_t vf[4];
        ldsm_x4_t(vf, vs_ + swz(kk * 16 + ((lane >> 3) & 1) * 8 + (lane & 7),
                                dp * 2 + (lane >> 4)));
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          mma(o[mt][2 * dp], pf[mt], vf[0], vf[1]);
          mma(o[mt][2 * dp + 1], pf[mt], vf[2], vf[3]);
        }
      }
    }
  }

  // out = o / l, through shared memory (the first stage), 16 bytes a thread
  unsigned char* stage0 = smem;
  cp_async_wait<0>();
  __syncthreads();
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      float l = lrow[mt][hf];
      l += __shfl_xor_sync(0xffffffffu, l, 1);
      l += __shfl_xor_sync(0xffffffffu, l, 2);
      const float inv = 1.f / l;
      const int sl = m0 + mt * 16 + nr + hf * 8;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
        *reinterpret_cast<uint32_t*>(stage0 + swz(sl, nt) + 2 * kq) =
            pack_bf16(o[mt][nt][2 * hf] * inv, o[mt][nt][2 * hf + 1] * inv);
    }
  __syncthreads();
#pragma unroll
  for (int i = tid; i < kBM * 8; i += kThreads) {
    const int s = i >> 3, ch = i & 7, t = slot_token(a, pr0, pc0, s);
    if (t < 0) continue;
    __nv_bfloat16* dst =
        a.out + ((size_t)(b * (long long)a.T + t) * a.heads + head) * kD + ch * 8;
    *reinterpret_cast<uint4*>(dst) =
        *reinterpret_cast<const uint4*>(stage0 + swz(s, ch));
  }
}


template <int kKC>
cudaError_t launch(const Args& a, dim3 grid, size_t smem, cudaStream_t st) {
  auto kernel = vit_attention_kernel<kKC>;
  static bool ready[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (!ready[dev]) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemMax);
    if (err != cudaSuccess) return err;
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return err;
    ready[dev] = true;
  }
  kernel<<<grid, kThreads, smem, st>>>(a);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// q, k, v: (B, heads, T, 64) bf16 at the given element strides (the last
// dimension contiguous; 16-byte aligned rows), T = h * w; rh (h, h, 64), rw
// (w, w, 64) bf16, contiguous; out (B, T, heads, 64) bf16, contiguous. kc:
// a key tile's columns (8, 16, 32 or 64; 64 / kc rows). scale: the scores'
// factor (1 / sqrt(64)). Returns the cudaError_t of the launch.
int fgn_vit_attention(const void* q, const void* k, const void* v,
                      const void* rh, const void* rw, void* out, int B,
                      int heads, int h, int w, long long sqb, long long sqh,
                      long long sqt, long long skb, long long skh,
                      long long skt, long long svb, long long svh,
                      long long svt, int kc, float scale, void* stream) {
  if (B <= 0 || heads <= 0 || h <= 0 || w <= 0 || B > 65535 ||
      heads > 65535 ||
      (kc != 8 && kc != 16 && kc != 32 && kc != 64)) {
    return (int)cudaErrorInvalidValue;
  }
  const int kr = kBN / kc;
  Args a;
  a.q = static_cast<const __nv_bfloat16*>(q);
  a.k = static_cast<const __nv_bfloat16*>(k);
  a.v = static_cast<const __nv_bfloat16*>(v);
  a.rh = static_cast<const __nv_bfloat16*>(rh);
  a.rw = static_cast<const __nv_bfloat16*>(rw);
  a.out = static_cast<__nv_bfloat16*>(out);
  a.sqb = sqb; a.sqh = sqh; a.sqt = sqt;
  a.skb = skb; a.skh = skh; a.skt = skt;
  a.svb = svb; a.svh = svh; a.svt = svt;
  a.heads = heads;
  a.T = h * w;
  a.h = h;
  a.w = w;
  a.patches_w = (w + kPatchCols - 1) / kPatchCols;
  // rows cover every key tile's cells; rel_h's odd and rel_w's 8 floats
  // past a multiple of 16 (or swizzled) keep the loop's reads conflict-free
  a.hs = (((h + kr - 1) / kr) * kr) | 1;
  a.ws = ((w + kc - 1) / kc) * kc;
  if (a.ws % 32 == 16) a.ws += 8;
  a.wswz = a.ws % 32 == 0 ? 24 : 0;
  a.scale_log2 = scale * kLog2e;
  const size_t smem = (size_t)kStages * kStageBytes +
                      (size_t)kBM * (a.hs + a.ws) * sizeof(float);
  if (smem > (size_t)kSmemMax) return (int)cudaErrorInvalidValue;
  const dim3 grid(((h + kPatchRows - 1) / kPatchRows) * a.patches_w, heads,
                  B);
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (kc) {
    case 8: err = launch<8>(a, grid, smem, st); break;
    case 16: err = launch<16>(a, grid, smem, st); break;
    case 32: err = launch<32>(a, grid, smem, st); break;
    default: err = launch<64>(a, grid, smem, st); break;
  }
  return (int)err;
}

const char* fgn_vit_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
