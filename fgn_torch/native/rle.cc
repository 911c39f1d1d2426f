// Native hot loops for COCO-style run-length mask coding.
//
// The numpy path in fgn_torch/data/rle.py implements the same format;
// these functions replace its per-run Python loops on the evaluation path
// (thousands of mask encodes per eval pass). A copy of the JAX package's
// native/rle.cc: the same code, so both packages write the same bytes.
//
// Built on first use with the host C++ compiler into fgn_torch/_build/ and
// loaded via ctypes by fgn_torch/native/__init__.py.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

// counts -> COCO compressed-counts chars. Returns bytes written or -1.
long long encode_counts(const std::vector<long long>& counts, char* out,
                        long long out_cap) {
  long long pos = 0;
  const size_t n = counts.size();
  for (size_t i = 0; i < n; ++i) {
    long long xval = counts[i];
    if (i > 2) xval -= counts[i - 2];
    bool more = true;
    while (more) {
      long long c = xval & 0x1f;
      xval >>= 5;
      more = !((xval == 0 && !(c & 0x10)) || (xval == -1 && (c & 0x10)));
      if (more) c |= 0x20;
      if (pos >= out_cap) return -1;
      out[pos++] = static_cast<char>(c + 48);
    }
  }
  return pos;
}

}  // namespace

extern "C" {

// Encode a binary HxW mask (row-major uint8) into the COCO compressed
// counts string. Returns the number of bytes written to `out` (capacity
// `out_cap`), or -1 if the buffer is too small.
long long rle_encode(const uint8_t* mask, long long h, long long w,
                     char* out, long long out_cap) {
  // Column-major scan; runs alternate 0s/1s starting with 0s.
  std::vector<long long> counts;
  counts.reserve(256);
  uint8_t prev = 0;
  long long run = 0;
  for (long long x = 0; x < w; ++x) {
    const uint8_t* col = mask + x;  // stride w within a column walk
    for (long long y = 0; y < h; ++y) {
      uint8_t v = col[y * w] ? 1 : 0;
      if (v == prev) {
        ++run;
      } else {
        counts.push_back(run);
        run = 1;
        prev = v;
      }
    }
  }
  counts.push_back(run);
  return encode_counts(counts, out, out_cap);
}

// Decode a compressed counts string into a binary HxW mask (row-major
// uint8, caller-allocated h*w bytes). Returns 0 on success, -1 if the
// runs do not cover exactly h*w pixels.
long long rle_decode(const char* s, long long slen, long long h, long long w,
                     uint8_t* mask) {
  std::vector<long long> counts;
  counts.reserve(256);
  long long i = 0;
  while (i < slen) {
    long long x = 0;
    int k = 0;
    bool more = true;
    long long c = 0;
    while (more) {
      c = s[i] - 48;
      x |= (c & 0x1f) << (5 * k);
      more = (c & 0x20) != 0;
      ++i;
      ++k;
      if (!more && (c & 0x10)) x |= -1LL << (5 * k);
    }
    if (counts.size() > 2) x += counts[counts.size() - 2];
    counts.push_back(x);
  }

  long long total = 0;
  for (long long cval : counts) total += cval;
  if (total != h * w) return -1;

  std::memset(mask, 0, static_cast<size_t>(h * w));
  long long pos = 0;  // column-major position
  uint8_t val = 0;
  for (long long cval : counts) {
    if (val) {
      for (long long t = 0; t < cval; ++t) {
        long long p = pos + t;
        long long y = p % h;
        long long x = p / h;
        mask[y * w + x] = 1;
      }
    }
    pos += cval;
    val ^= 1;
  }
  return 0;
}

// Fused bilinear mask paste + threshold + RLE encode (evaluation hot
// path; replaces ops/mask_paste.py::paste_masks_np + the numpy RLE
// encode per detection). Semantics match _paste_weights_np exactly:
// image pixel centers at (p + 0.5); continuous mask coordinate
// (c - lo) / max(hi - lo, 1e-6) * msize - 0.5, clamped to
// [0, msize - 1], hat-function (2-tap) weights, zero outside
// [lo, hi]. The full HxW canvas is never materialized — pixels outside
// the box window are synthesized as zero runs directly in the
// column-major RLE stream. All arithmetic in float (numpy float32
// parity). Returns bytes written to `out`, or -1 on overflow.
long long rle_paste_encode(const float* probs, long long msize,
                           float x0, float y0, float x1, float y1,
                           long long H, long long W, float thr,
                           char* out, long long out_cap) {
  long long iy0 = std::max<long long>((long long)std::floor(y0), 0);
  long long iy1 = std::min<long long>((long long)std::ceil(y1) + 1, H);
  long long ix0 = std::max<long long>((long long)std::floor(x0), 0);
  long long ix1 = std::min<long long>((long long)std::ceil(x1) + 1, W);

  std::vector<long long> counts;
  counts.reserve(256);
  if (iy1 <= iy0 || ix1 <= ix0) {
    counts.push_back(H * W);  // all-zero mask
    return encode_counts(counts, out, out_cap);
  }
  const long long wh = iy1 - iy0, ww = ix1 - ix0;

  // Per-axis 2-tap weights (index, w0, w1) for window pixels.
  struct Tap { long long i0, i1; float w0, w1; bool inside; };
  auto make_taps = [msize](float lo, float hi, long long start,
                           long long stop, std::vector<Tap>& taps) {
    float span = std::max(hi - lo, 1e-6f);
    taps.resize(static_cast<size_t>(stop - start));
    for (long long p = start; p < stop; ++p) {
      float c = (float)p + 0.5f;
      Tap& t = taps[static_cast<size_t>(p - start)];
      t.inside = (c >= lo) && (c <= hi);
      float m = (c - lo) / span * (float)msize - 0.5f;
      float mc = std::min(std::max(m, 0.0f), (float)(msize - 1));
      long long i0 = (long long)std::floor(mc);
      if (i0 >= msize - 1) i0 = msize - 2;
      if (i0 < 0) i0 = 0;  // msize == 1 handled below
      long long i1 = std::min(i0 + 1, msize - 1);
      t.i0 = i0;
      t.i1 = i1;
      t.w0 = std::max(1.0f - std::fabs(mc - (float)i0), 0.0f);
      t.w1 = (i1 == i0)
                 ? 0.0f
                 : std::max(1.0f - std::fabs(mc - (float)i1), 0.0f);
    }
  };
  std::vector<Tap> ty, tx;
  make_taps(y0, y1, iy0, iy1, ty);
  make_taps(x0, x1, ix0, ix1, tx);

  // Row-interpolate: tmp[y][j] = wy0 * P[i0][j] + wy1 * P[i1][j].
  std::vector<float> tmp(static_cast<size_t>(wh * msize), 0.0f);
  for (long long y = 0; y < wh; ++y) {
    const Tap& t = ty[static_cast<size_t>(y)];
    if (!t.inside) continue;  // weights all zero -> row stays 0
    const float* r0 = probs + t.i0 * msize;
    const float* r1 = probs + t.i1 * msize;
    float* dst = tmp.data() + y * msize;
    for (long long j = 0; j < msize; ++j)
      dst[j] = t.w0 * r0[j] + t.w1 * r1[j];
  }

  // Column-major RLE over the virtual canvas: zero columns, then per
  // window column zeros/values/zeros, merging runs across columns.
  uint8_t prev = 0;
  long long run = ix0 * H;  // leading all-zero columns
  auto push = [&](uint8_t v, long long len) {
    if (len == 0) return;
    if (v == prev) {
      run += len;
    } else {
      counts.push_back(run);
      run = len;
      prev = v;
    }
  };
  for (long long x = 0; x < ww; ++x) {
    const Tap& t = tx[static_cast<size_t>(x)];
    push(0, iy0);  // rows above the window
    if (!t.inside) {
      push(0, wh);
    } else {
      for (long long y = 0; y < wh; ++y) {
        const float* row = tmp.data() + y * msize;
        float v = t.w0 * row[t.i0] + t.w1 * row[t.i1];
        push(v > thr ? 1 : 0, 1);
      }
    }
    push(0, H - iy1);  // rows below the window
  }
  push(0, (W - ix1) * H);  // trailing all-zero columns
  counts.push_back(run);
  return encode_counts(counts, out, out_cap);
}

// Pairwise mask IoU from decoded masks is done in NumPy (matmul); the
// area of a compressed RLE, however, is a common small call:
long long rle_area(const char* s, long long slen) {
  std::vector<long long> counts;
  long long i = 0;
  while (i < slen) {
    long long x = 0;
    int k = 0;
    bool more = true;
    long long c = 0;
    while (more) {
      c = s[i] - 48;
      x |= (c & 0x1f) << (5 * k);
      more = (c & 0x20) != 0;
      ++i;
      ++k;
      if (!more && (c & 0x10)) x |= -1LL << (5 * k);
    }
    if (counts.size() > 2) x += counts[counts.size() - 2];
    counts.push_back(x);
  }
  long long area = 0;
  for (size_t j = 1; j < counts.size(); j += 2) area += counts[j];
  return area;
}

}  // extern "C"
