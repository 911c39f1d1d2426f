// The optimizer's update of every parameter in one launch (K5), for Hopper
// (sm_90a).
//
// Replaces no Pallas kernel of the JAX package: on the TPU, XLA fuses
// optax's chain (fgn_tpu/train/optim.py: the scaler, the decoupled weight
// decay, the scheduled step) into a few loops over the whole parameter tree.
// The port's plain route (fgn_torch/train/optim.py::FGNOptimizer._scale)
// runs about 12 elementwise kernels a tensor, and the flagship model has 189
// tensors: the host's dispatch of ~2,300 small launches, not the card, set
// the optimizer's time. This kernel applies, to every tensor of a step, in
// float32 and rounding for rounding as the plain route does on the card:
//
//   adagrad: acc = acc + g * g;  u = (acc > 0 ? rsqrt(acc + 1e-7) : 0) * g
//   adam:    mu = 0.1 g + 0.9 mu;  nu = 0.001 (g * g) + 0.999 nu;
//            u = (mu * r1) / (sqrt(nu * r2) + 1e-8)
//   both:    u = u + wd * p;  p = p + step * u
//
// where step = -lr_mult * schedule(count) of the tensor's group and r1, r2
// are the reciprocals of Adam's bias corrections (torch on CUDA divides a
// tensor by a Python number through its reciprocal). Every product and sum
// is an explicit round-to-nearest intrinsic, so nvcc contracts none into an
// FMA; rsqrtf and sqrt are the ones torch's rsqrt and sqrt kernels call. A
// null gradient reads as zero, as the plain route's zeros_like.
//
// Bound on an H100 (3.35 TB/s): bytes. Adagrad reads p, g, acc and writes p,
// acc: 20 bytes a parameter; Adam 28. The arithmetic is a few operations a
// byte.
//
// Design: one launch takes up to kMaxTensors tensors. Its parameter block
// (kernel parameters may hold 32,764 bytes since CUDA 12.1; the launch
// copies them, so nothing is copied from the host to the card and no host
// buffer outlives the call) carries each tensor's pointers, length, step and
// decay, and a table that maps each block to one (tensor, chunk of kChunk
// elements). A block moves its chunk in 16-byte vectors, neighbouring threads
// on neighbouring addresses, and its ragged end (or an unaligned tensor) one
// value a thread. ops/optim_cuda.py::plan cuts the tensors into launches and
// writes the table; the flagship's 189 tensors take one launch.

#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kMaxTensors = 224;  // tensor records a launch
constexpr int kMaxBlocks = 5000;  // blocks a launch
constexpr int kChunk = 16384;     // elements a block
constexpr int kThreads = 256;     // threads a block

// One tensor of a launch (ops/optim_cuda.py::TENSOR, 56 bytes).
struct TensorRec {
  float* p;
  const float* g;  // null: a zero gradient
  float* s0;       // adagrad: acc; adam: mu
  float* s1;       // adam: nu; unused by adagrad
  long long n;     // elements
  float step;      // -lr_mult * schedule(count)
  float wd;        // decoupled weight decay
  float r1, r2;    // adam: 1 / (1 - 0.9^t), 1 / (1 - 0.999^t)
};
static_assert(sizeof(TensorRec) == 56, "ops/optim_cuda.py::TENSOR");

// A launch's parameter block: block b updates chunk block[b] >> 8 of tensor
// block[b] & 0xff.
struct Launch {
  TensorRec t[kMaxTensors];
  unsigned int block[kMaxBlocks];
};
static_assert(sizeof(Launch) <= 32764, "a kernel's parameters");

enum Rule { kAdagrad = 0, kAdam = 1 };

template <int R>
__device__ __forceinline__ void update(float& p, float g, float& s0,
                                       float& s1, float step, float wd,
                                       float r1, float r2) {
  float u;
  if (R == kAdagrad) {
    s0 = __fadd_rn(s0, __fmul_rn(g, g));
    const float inv = s0 > 0.f ? rsqrtf(__fadd_rn(s0, 1e-7f)) : 0.f;
    u = __fmul_rn(inv, g);
  } else {
    s0 = __fadd_rn(__fmul_rn(0.1f, g), __fmul_rn(0.9f, s0));
    s1 = __fadd_rn(__fmul_rn(0.001f, __fmul_rn(g, g)), __fmul_rn(0.999f, s1));
    const float den = __fadd_rn(__fsqrt_rn(__fmul_rn(s1, r2)), 1e-8f);
    u = __fdiv_rn(__fmul_rn(s0, r1), den);
  }
  u = __fadd_rn(u, __fmul_rn(wd, p));
  p = __fadd_rn(p, __fmul_rn(step, u));
}

template <int R>
__device__ __forceinline__ void update4(float4& p, float4 g, float4& s0,
                                        float4& s1, const TensorRec& t) {
  update<R>(p.x, g.x, s0.x, s1.x, t.step, t.wd, t.r1, t.r2);
  update<R>(p.y, g.y, s0.y, s1.y, t.step, t.wd, t.r1, t.r2);
  update<R>(p.z, g.z, s0.z, s1.z, t.step, t.wd, t.r1, t.r2);
  update<R>(p.w, g.w, s0.w, s1.w, t.step, t.wd, t.r1, t.r2);
}

template <int R>
__global__ void __launch_bounds__(kThreads)
    optim_step(const __grid_constant__ Launch L) {
  const unsigned int e = L.block[blockIdx.x];
  const TensorRec& t = L.t[e & 0xffu];
  const long long start = (long long)(e >> 8) * kChunk;
  const int len = (int)min((long long)kChunk, t.n - start);
  float* p = t.p + start;
  const float* g = t.g ? t.g + start : nullptr;
  float* s0 = t.s0 + start;
  float* s1 = R == kAdam ? t.s1 + start : nullptr;
  const uintptr_t any = (uintptr_t)p | (uintptr_t)g | (uintptr_t)s0 |
                        (uintptr_t)s1;
  int head = 0;  // values before the scalar tail
  if (any % 16 == 0) {
    head = len & ~3;
    float4* p4 = reinterpret_cast<float4*>(p);
    const float4* g4 = reinterpret_cast<const float4*>(g);
    float4* a4 = reinterpret_cast<float4*>(s0);
    float4* b4 = reinterpret_cast<float4*>(s1);
    for (int i = threadIdx.x; i < head / 4; i += kThreads) {
      float4 pv = p4[i];
      const float4 gv = g ? __ldg(g4 + i) : make_float4(0.f, 0.f, 0.f, 0.f);
      float4 av = a4[i];
      float4 bv = R == kAdam ? b4[i] : make_float4(0.f, 0.f, 0.f, 0.f);
      update4<R>(pv, gv, av, bv, t);
      p4[i] = pv;
      a4[i] = av;
      if (R == kAdam) b4[i] = bv;
    }
  }
  for (int i = head + threadIdx.x; i < len; i += kThreads) {
    float pv = p[i];
    const float gv = g ? __ldg(g + i) : 0.f;
    float av = s0[i];
    float bv = R == kAdam ? s1[i] : 0.f;
    update<R>(pv, gv, av, bv, t.step, t.wd, t.r1, t.r2);
    p[i] = pv;
    s0[i] = av;
    if (R == kAdam) s1[i] = bv;
  }
}

// The launch's parameter block, filled on the host before each launch: 32 KB
// is kept off the calling thread's stack. The launch copies it, so the next
// call may refill it at once.
thread_local Launch host_launch;

}  // namespace

extern "C" {

// rule: 0 = adagrad, 1 = adam. tensors: n_tensors TensorRec records (at most
// kMaxTensors); blocks: n_blocks entries (at most kMaxBlocks), each
// tensor | chunk << 8, every chunk inside its tensor. Both host memory, read
// before this returns. Returns the cudaError_t of the launch.
int fgn_optim_step(int rule, const void* tensors, int n_tensors,
                   const void* blocks, int n_blocks, void* stream) {
  if (n_tensors < 1 || n_tensors > kMaxTensors || n_blocks < 1 ||
      n_blocks > kMaxBlocks || (rule != kAdagrad && rule != kAdam)) {
    return (int)cudaErrorInvalidValue;
  }
  memcpy(host_launch.t, tensors, sizeof(TensorRec) * n_tensors);
  memcpy(host_launch.block, blocks, sizeof(unsigned int) * n_blocks);
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (rule == kAdagrad) {
    optim_step<kAdagrad><<<n_blocks, kThreads, 0, st>>>(host_launch);
  } else {
    optim_step<kAdam><<<n_blocks, kThreads, 0, st>>>(host_launch);
  }
  return (int)cudaGetLastError();
}

const char* fgn_optim_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
