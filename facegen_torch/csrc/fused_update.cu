// The update tail of a train step for sm_90a: two kernels, each over all
// of one net's leaves in one launch.
//
// Replaces no Pallas kernel. It is the port's counterpart of the loops XLA
// fuses from facegen's tree.maps of the step's update:
//   prep   <- losses.penalty_loss, add_penalty_grads, clamp_grads
//             (facegen/train/losses.py:32-62) and the step's finite check
//             (facegen/train/step.py:319-323, 369-372);
//   update <- gated_update of the optax transformation
//             (facegen/train/optim.py:48-67).
// Before these kernels the port ran each as torch ops leaf by leaf: about
// 30 kernels a leaf for D's iteration and 18 for G's.
//
// prep:   g <- clamp(g + s*sign(p) + l*p, -c, c) in place (c = 0: no clamp);
//         out[0] = sum |p|, out[1] = sum p^2 (the pre-update p, for the
//         penalty in the loss), out[2] = the count of entries of the
//         clamped g that are not finite.
// update: Adam, Adagrad, SGD or SGD with momentum, with optax's formulas in
//         the plain version's order of operations (train/optim.py), where
//         the device bool *gate holds (gate null: always). A closed gate
//         writes nothing: not p, not the state, not Adam's count.
//
// Design.
// - The leaves are a table of segments {p, g, m, v} with prefix offsets,
//   passed by value as a __grid_constant__ kernel parameter: a CUDA graph
//   holds it in the launch, so nothing is copied from the host per step,
//   and the kernel reads it from the constant bank without a local copy.
//   A table of more than kMaxSegments leaves is launched in chunks (the
//   Python wrapper, ops/fused_update.py); the kernel parameter space of
//   4 KB holds 64 segments.
// - The grid covers the leaves' concatenated index space in chunks of
//   kChunk elements, so one block's work is the same whatever the leaf
//   sizes (1 element for a PReLU slope, 1,048,576 for D32b's largest);
//   a block finds its first segment by binary search over the offsets and
//   each thread walks forward from there. Each thread loads its kItems
//   entries before it computes, so a warp keeps kItems coalesced loads of
//   each array in flight.
// - Arithmetic: __fmul_rn / __fadd_rn / __fdiv_rn / __fsqrt_rn keep every
//   product and sum rounded on its own, as the plain version's separate
//   torch ops do; nvcc would otherwise contract them into FMAs.
// - prep's sums are reduced deterministically: each block writes its
//   partial (fp64) to a workspace, and the last block to arrive (an atomic
//   ticket) sums all partials in block order and resets the ticket to 0,
//   so every launch leaves it at zero (as the dW kernel's stream-K
//   counters). Adam's count is bumped the same way: every block reads it
//   before it takes its ticket, and the last block writes count + 1.
//
// What bounds them: bytes. prep moves 12 B an element (p and g read, g
// written), update 28 B for Adam (p, g, m, v read; p, m, v written), 20
// for Adagrad and SGD with momentum, 12 for SGD: 0.0103 + 0.0239 ms for
// D32b's 2,863,239 parameters at 3.35 TB/s.
//
// Requirements, checked by the Python wrapper: fp32 leaves, each leaf's
// p, g, m, v of one shape and one dense layout, fewer than 2^31 elements
// a leaf, at most kMaxSegments leaves a launch, launches on one device
// that do not overlap (they share the workspace and the tickets).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMaxSegments = 64;
constexpr int kThreads = 256;
constexpr int kItems = 8;
constexpr int kChunk = kThreads * kItems;
constexpr int kWarps = kThreads / 32;

// prep's flags
constexpr int kPenalise = 1;    // add s*sign(p) + l*p
constexpr int kClamp = 2;       // clamp to [-c, c]
constexpr int kSums = 4;        // sum |p| and p^2
constexpr int kCount = 8;       // count the entries that are not finite
constexpr int kAccumulate = 16; // add to out (a later chunk of one table)

// update's optimizers
constexpr int kAdam = 0;
constexpr int kAdagrad = 1;
constexpr int kSgd = 2;
constexpr int kSgdMomentum = 3;

struct Table {
  float* p[kMaxSegments];
  float* g[kMaxSegments];
  float* m[kMaxSegments];  // Adam's mu, Adagrad's sum of squares, SGD's trace
  float* v[kMaxSegments];  // Adam's nu
  long long start[kMaxSegments + 1];  // prefix offsets; start[n] = total
  int n;
};

struct Hyper {
  float neg_lr, b1, one_minus_b1, b2, one_minus_b2, eps, momentum;
};

// The segment that holds element i: the largest k with start[k] <= i.
__device__ __forceinline__ int find_segment(const Table& t, long long i) {
  int lo = 0, hi = t.n - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (t.start[mid] <= i) lo = mid; else hi = mid - 1;
  }
  return lo;
}

// This thread's kItems entries of the block's chunk: segment (-1 past the
// end) and offset in it. Entry k is element base + k*kThreads + tid.
__device__ __forceinline__ void locate(const Table& t, int seg[kItems], int off[kItems]) {
  const long long total = t.start[t.n];
  const long long base = static_cast<long long>(blockIdx.x) * kChunk;
  int s = find_segment(t, base);
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const long long i = base + k * kThreads + threadIdx.x;
    seg[k] = -1;
    off[k] = 0;
    if (i < total) {
      while (i >= t.start[s + 1]) ++s;
      seg[k] = s;
      off[k] = static_cast<int>(i - t.start[s]);
    }
  }
}

__device__ __forceinline__ double warp_sum(double x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_down_sync(0xffffffffu, x, o);
  return x;
}

// The block's sums of a[0..2], in a fixed order; valid in thread 0.
__device__ __forceinline__ void block_sum3(double a[3]) {
  __shared__ double red[3][kWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    a[j] = warp_sum(a[j]);
    if (lane == 0) red[j][warp] = a[j];
  }
  __syncthreads();
  if (warp == 0) {
#pragma unroll
    for (int j = 0; j < 3; ++j) a[j] = warp_sum(lane < kWarps ? red[j][lane] : 0.0);
  }
  __syncthreads();  // red is reused by the last block's second sum
}

// torch.clamp's semantics: NaN stays NaN, +-inf go to the bounds.
__device__ __forceinline__ float clamp_nan(float x, float c) {
  return isnan(x) ? x : fminf(fmaxf(x, -c), c);
}

__global__ void __launch_bounds__(kThreads)
fused_prep(const __grid_constant__ Table t, float s, float l, float c, int flags,
           float* __restrict__ out, double* __restrict__ partials,
           unsigned* __restrict__ ticket) {
  int seg[kItems], off[kItems];
  locate(t, seg, off);
  const bool need_p = flags & (kPenalise | kSums);
  const bool writes = flags & (kPenalise | kClamp);
  float pv[kItems], gv[kItems];
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    pv[k] = 0.f;
    gv[k] = 0.f;
    if (seg[k] >= 0) {
      if (need_p) pv[k] = t.p[seg[k]][off[k]];
      gv[k] = t.g[seg[k]][off[k]];
    }
  }
  double acc[3] = {0.0, 0.0, 0.0};
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    if (seg[k] < 0) continue;
    const float p = pv[k];
    float x = gv[k];
    if (flags & kPenalise) {  // (g + s*sign(p)) + l*p, each op rounded
      const float sign = p > 0.f ? 1.f : (p < 0.f ? -1.f : 0.f);
      x = __fadd_rn(__fadd_rn(x, __fmul_rn(s, sign)), __fmul_rn(l, p));
    }
    if (flags & kClamp) x = clamp_nan(x, c);
    if (writes) t.g[seg[k]][off[k]] = x;
    const double pd = static_cast<double>(p);
    acc[0] += fabs(pd);
    acc[1] += pd * pd;
    acc[2] += isfinite(x) ? 0.0 : 1.0;
  }
  if (!(flags & (kSums | kCount))) return;  // uniform over the grid

  block_sum3(acc);
  __shared__ bool last;
  if (threadIdx.x == 0) {
#pragma unroll
    for (int j = 0; j < 3; ++j) partials[3 * blockIdx.x + j] = acc[j];
    __threadfence();  // the partial is visible before the ticket is taken
    last = atomicAdd(ticket, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  // the last block: every partial in block order, whichever block is last
  double tot[3] = {0.0, 0.0, 0.0};
  for (int b = threadIdx.x; b < static_cast<int>(gridDim.x); b += kThreads) {
#pragma unroll
    for (int j = 0; j < 3; ++j) tot[j] += __ldcg(partials + 3 * b + j);
  }
  block_sum3(tot);
  if (threadIdx.x == 0) {
    const bool add = flags & kAccumulate;
#pragma unroll
    for (int j = 0; j < 3; ++j)
      out[j] = static_cast<float>(add ? static_cast<double>(out[j]) + tot[j] : tot[j]);
    *ticket = 0u;  // for the next launch
  }
}

template <int Kind>
__global__ void __launch_bounds__(kThreads)
fused_update(const __grid_constant__ Table t, Hyper h, const unsigned char* __restrict__ gate,
             int* __restrict__ count, unsigned* __restrict__ ticket, int bump) {
  if (gate != nullptr && *gate == 0) return;  // closed: nothing is written
  __shared__ float bc[2];  // Adam's bias corrections 1 - b^(count+1)
  if (Kind == kAdam) {
    if (threadIdx.x == 0) {
      const float c = static_cast<float>(*count + 1);
      bc[0] = 1.f - powf(h.b1, c);
      bc[1] = 1.f - powf(h.b2, c);
    }
    __syncthreads();
  }
  constexpr bool kHasM = Kind != kSgd;
  constexpr bool kHasV = Kind == kAdam;
  int seg[kItems], off[kItems];
  locate(t, seg, off);
  float pv[kItems], gv[kItems], mv[kItems], vv[kItems];
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    pv[k] = gv[k] = mv[k] = vv[k] = 0.f;
    if (seg[k] >= 0) {
      pv[k] = t.p[seg[k]][off[k]];
      gv[k] = t.g[seg[k]][off[k]];
      if (kHasM) mv[k] = t.m[seg[k]][off[k]];
      if (kHasV) vv[k] = t.v[seg[k]][off[k]];
    }
  }
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    if (seg[k] < 0) continue;
    const float g = gv[k];
    float m = mv[k], v = vv[k], u;
    if (Kind == kAdam) {
      // mu = (1-b1) g + b1 mu; nu = (1-b2) g^2 + b2 nu;
      // u = -lr * ((mu / bc1) / (sqrt(nu / bc2) + eps))
      m = __fadd_rn(__fmul_rn(h.one_minus_b1, g), __fmul_rn(h.b1, m));
      v = __fadd_rn(__fmul_rn(h.one_minus_b2, __fmul_rn(g, g)), __fmul_rn(h.b2, v));
      const float den = __fadd_rn(__fsqrt_rn(__fdiv_rn(v, bc[1])), h.eps);
      u = __fmul_rn(h.neg_lr, __fdiv_rn(__fdiv_rn(m, bc[0]), den));
    } else if (Kind == kAdagrad) {
      // s = g^2 + s; u = -lr * (where(s > 0, rsqrt(s + eps), 0) * g)
      m = __fadd_rn(__fmul_rn(g, g), m);
      const float r = m > 0.f ? rsqrtf(__fadd_rn(m, h.eps)) : 0.f;
      u = __fmul_rn(h.neg_lr, __fmul_rn(r, g));
    } else if (Kind == kSgdMomentum) {
      // trace = g + momentum * trace; u = -lr * trace
      m = __fadd_rn(g, __fmul_rn(h.momentum, m));
      u = __fmul_rn(h.neg_lr, m);
    } else {
      u = __fmul_rn(h.neg_lr, g);
    }
    t.p[seg[k]][off[k]] = __fadd_rn(pv[k], u);
    if (kHasM) t.m[seg[k]][off[k]] = m;
    if (kHasV) t.v[seg[k]][off[k]] = v;
  }
  if (Kind == kAdam && bump) {
    __syncthreads();  // every thread of the block is past its read of count
    if (threadIdx.x == 0) {
      __threadfence();
      if (atomicAdd(ticket, 1u) == gridDim.x - 1) {  // every block has read count
        *count += 1;
        *ticket = 0u;
      }
    }
  }
}

// The table of n leaves from the host's arrays; its total element count.
long long make_table(Table& t, int n, const uint64_t* p, const uint64_t* g, const uint64_t* m,
                     const uint64_t* v, const long long* numel) {
  t.n = n;
  t.start[0] = 0;
  for (int k = 0; k < kMaxSegments; ++k) {
    const bool in = k < n;
    t.p[k] = in ? reinterpret_cast<float*>(p[k]) : nullptr;
    t.g[k] = in ? reinterpret_cast<float*>(g[k]) : nullptr;
    t.m[k] = in && m ? reinterpret_cast<float*>(m[k]) : nullptr;
    t.v[k] = in && v ? reinterpret_cast<float*>(v[k]) : nullptr;
    t.start[k + 1] = t.start[k] + (in ? numel[k] : 0);
  }
  return t.start[kMaxSegments];
}

unsigned blocks_for(long long total) {
  return static_cast<unsigned>((total + kChunk - 1) / kChunk);
}

}  // namespace

extern "C" int facegen_fused_max_segments() { return kMaxSegments; }

extern "C" int facegen_fused_chunk() { return kChunk; }

// One launch of prep over n <= kMaxSegments leaves of numel[k] > 0
// elements. out: 3 fp32; partials: 3 fp64 per block
// (ceil(sum numel / chunk) blocks); ticket: one unsigned, 0.
extern "C" int facegen_fused_prep(int n, const uint64_t* p, const uint64_t* g,
                                  const long long* numel, float s, float l, float c, int flags,
                                  float* out, double* partials, unsigned* ticket, void* stream) {
  if (n < 1 || n > kMaxSegments) return static_cast<int>(cudaErrorInvalidValue);
  Table t;
  const long long total = make_table(t, n, p, g, nullptr, nullptr, numel);
  fused_prep<<<blocks_for(total), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      t, s, l, c, flags, out, partials, ticket);
  return static_cast<int>(cudaGetLastError());
}

// One launch of the update of n <= kMaxSegments leaves. kind: 0 Adam,
// 1 Adagrad, 2 SGD, 3 SGD with momentum; m, v may be null where the
// optimizer has no such state. gate: a device bool, or null for always.
// count and ticket: Adam's int32 step count and one unsigned at 0; bump:
// whether this launch advances the count (the last chunk of a table).
extern "C" int facegen_fused_update(int kind, int n, const uint64_t* p, const uint64_t* g,
                                    const uint64_t* m, const uint64_t* v,
                                    const long long* numel, float neg_lr, float b1,
                                    float one_minus_b1, float b2, float one_minus_b2, float eps,
                                    float momentum, const unsigned char* gate, int* count,
                                    unsigned* ticket, int bump, void* stream) {
  if (n < 1 || n > kMaxSegments) return static_cast<int>(cudaErrorInvalidValue);
  Table t;
  const long long total = make_table(t, n, p, g, m, v, numel);
  const Hyper h{neg_lr, b1, one_minus_b1, b2, one_minus_b2, eps, momentum};
  const unsigned blocks = blocks_for(total);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (kind) {
    case kAdam:
      fused_update<kAdam><<<blocks, kThreads, 0, st>>>(t, h, gate, count, ticket, bump);
      break;
    case kAdagrad:
      fused_update<kAdagrad><<<blocks, kThreads, 0, st>>>(t, h, gate, count, ticket, 0);
      break;
    case kSgd:
      fused_update<kSgd><<<blocks, kThreads, 0, st>>>(t, h, gate, count, ticket, 0);
      break;
    case kSgdMomentum:
      fused_update<kSgdMomentum><<<blocks, kThreads, 0, st>>>(t, h, gate, count, ticket, 0);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
