// G's batch norm followed by its PReLU (nn/layers.py: BatchNorm, PReLU),
// for sm_90a: four kernels, templated on bf16 and fp32 activations.
//
// Replaces no Pallas kernel: facegen leaves batch norm and PReLU to XLA,
// which fuses facegen/nn/layers.py's batch_norm and prelu into its own
// loops. Before these kernels the port ran the pair as ATen ops: an fp32
// copy of the activation, a mean and a Welford variance, about eight tiny
// running-statistic ops, rsqrt, three elementwise passes and a cast back,
// then PReLU's own pass; autograd added as many again in fp32 over the
// whole activation. About 130 launches a GAN training step.
//
// The input is NHWC contiguous, viewed as rows x C.
//
// bn_prelu_stats      (train forward) per-channel count, mean and M2
//                     (Welford in fp32) over each block's rows, merged in
//                     shared memory in a fixed tree (Chan's formula); the
//                     last block to finish merges the blocks' partials in
//                     fp64 in a fixed order (the grand mean from sum n_b
//                     mean_b, then M2 = sum M2_b + n_b (mean_b - mean)^2),
//                     writes mean and rstd = rsqrt(var + eps) and moves
//                     the running statistics as
//                     BatchNorm._move_running does:
//                     (1-m) old + m batch, with var scaled by n/(n-1).
// bn_prelu_apply      (train and eval forward) z = (x - mean)(rstd g) + b
//                     in fp32, rounded to the activation type; y =
//                     round(z > 0 ? z : round(a) z). In eval, mean and
//                     rstd come from the running statistics. Each product
//                     and sum is rounded alone, in BatchNorm.forward's
//                     order, so the output is the plain path's bit for bit
//                     where the statistics are the same.
// bn_prelu_bwd_reduce recomputes z from the saved x and statistics, forms
//                     PReLU's dz = round(dy (z > 0 ? 1 : round(a))) and
//                     reduces per channel sum dz and sum dz xhat, and the
//                     slope's sum round(z dy) over z <= 0 (rounded to the
//                     activation type at the end, as autograd's sum of the
//                     bf16 product is); partials summed by the same
//                     fixed-order fixup.
// bn_prelu_bwd_dx     dx = (g rstd / n)(n dz - sum dz - xhat sum dz xhat)
//                     in train mode (the batch's statistics depend on x),
//                     dz rstd g in eval, cast to the activation type.
//
// What bounds them: bytes. Forward reads x and writes y, the backward
// reads x and dy and writes dx; at G32's training shapes that is 75 MB a
// step, about 22 us at 3.35 TB/s, and every activation (2-8 MB in bf16)
// fits in the 50 MB L2, so each second pass (apply after stats, dx after
// the reduction) reads x again from L2. Design for that:
// - 16-byte vector loads along C: a thread owns one group of 8 (bf16) or
//   4 (fp32) channels for its whole life, so its channels' constants sit
//   in registers; a warp reads whole rows.
// - The two reducing kernels take at most kPartialCells / C blocks (and
//   kReduceBlocks) over contiguous row ranges, each thread keeping kUnroll
//   loads in flight, so that the last block's threads hold all partials of
//   their channel in registers after one round of loads.
//   No atomics touch the values: the results are the same on every run
//   and every replay. The last block to take the ticket merges, and
//   leaves the ticket at 0 for the next launch (as fused_update.cu does).
// - The elementwise kernels take a grid that fills the card once
//   (occupancy x SMs) and stride over the rows.
//
// Requirements, checked by the Python wrapper (ops/bn_prelu.py): x, y, dy
// and dx contiguous and 16-byte aligned; C a divisor of kThreads and a
// multiple of the vector width; fp32 per-channel tensors of C entries, a
// slope of one entry; launches on one device that do not overlap (they
// share the partials and the tickets).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr int kUnroll = 4;
constexpr int kReduceBlocks = 128;  // most blocks of a reducing launch: the partials' slots
// most (blocks x channels) of a reducing launch: the last block's thread
// (lane, c) holds its lane's kPer blocks of channel c in registers
constexpr int kPartialCells = 8192;
constexpr int kPer = kPartialCells / kThreads;
constexpr int kMaxDevices = 64;

template <typename T>
struct Act;

template <>
struct Act<float> {
  static constexpr int kVec = 4;
  __device__ static __forceinline__ void to_float(const uint4& u, float v[4]) {
    v[0] = __uint_as_float(u.x);
    v[1] = __uint_as_float(u.y);
    v[2] = __uint_as_float(u.z);
    v[3] = __uint_as_float(u.w);
  }
  __device__ static __forceinline__ uint4 from_float(const float v[4]) {
    return make_uint4(__float_as_uint(v[0]), __float_as_uint(v[1]), __float_as_uint(v[2]),
                      __float_as_uint(v[3]));
  }
  __device__ static __forceinline__ float round(float v) { return v; }
};

template <>
struct Act<__nv_bfloat16> {
  static constexpr int kVec = 8;
  // element 2i is the low half of word i, element 2i+1 the high half
  __device__ static __forceinline__ void to_float(const uint4& u, float v[8]) {
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      v[2 * i] = __uint_as_float(w[i] << 16);
      v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
  __device__ static __forceinline__ uint32_t pack(float lo, float hi) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
    return static_cast<uint32_t>(__bfloat16_as_ushort(h.x)) |
           (static_cast<uint32_t>(__bfloat16_as_ushort(h.y)) << 16);
  }
  __device__ static __forceinline__ uint4 from_float(const float v[8]) {
    return make_uint4(pack(v[0], v[1]), pack(v[2], v[3]), pack(v[4], v[5]), pack(v[6], v[7]));
  }
  __device__ static __forceinline__ float round(float v) {
    return __bfloat162float(__float2bfloat16_rn(v));
  }
};

// One channel's constants of the forward: mean, rstd, rstd * gamma, beta.
// scale is rstd, or the running variance when scale_is_var (eval).
struct Channel {
  float mean, rstd, inv, beta;
};

__device__ __forceinline__ Channel channel(const float* mean, const float* scale, int scale_is_var,
                                           float eps, const float* gamma, const float* beta,
                                           int c) {
  Channel ch;
  ch.mean = mean[c];
  ch.rstd = scale_is_var ? rsqrtf(__fadd_rn(scale[c], eps)) : scale[c];
  ch.inv = __fmul_rn(ch.rstd, gamma[c]);  // torch.rsqrt(var + eps) * weight
  ch.beta = beta[c];
  return ch;
}

// BatchNorm.forward's z, rounded to the activation type: ((x - mean) * inv) + beta
template <typename T>
__device__ __forceinline__ float norm(float x, const Channel& ch) {
  return Act<T>::round(__fadd_rn(__fmul_rn(__fsub_rn(x, ch.mean), ch.inv), ch.beta));
}

// a thread's channel group and row slot in a reducing block: G groups of
// kVec channels to a row, R = kThreads / G rows a pass
template <typename T>
struct Slots {
  int G, R, g, r0;
  __device__ __forceinline__ explicit Slots(int C) {
    G = C / Act<T>::kVec;
    R = kThreads / G;
    g = threadIdx.x % G;
    r0 = threadIdx.x / G;
  }
};

// (n, mean, m2) += (nb, mb, m2b), Chan's parallel formula
template <int V>
__device__ __forceinline__ void chan(float& n, float mean[V], float m2[V], float nb,
                                     const float* mb, const float* m2b) {
  if (nb == 0.f) return;
  const float total = n + nb;
  const float wb = nb / total;
  const float cross = n * wb;
#pragma unroll
  for (int i = 0; i < V; ++i) {
    const float d = mb[i] - mean[i];
    mean[i] += d * wb;
    m2[i] += m2b[i] + d * d * cross;
  }
  n = total;
}

// Take the block's ticket after its partial is written; true in every
// thread of the last block to arrive.
__device__ __forceinline__ bool last_block(unsigned* ticket) {
  __shared__ bool last;
  __threadfence();  // this thread's part of the partial is visible first
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(ticket, 1u) == gridDim.x - 1;
  __syncthreads();
  if (last) __threadfence();
  return last;
}

// The last block's lanes: thread t holds lane t / C of channel t % C. The
// sum of v over the lanes of each channel, in a fixed tree, in every
// thread. sd: kThreads doubles of shared memory.
__device__ __forceinline__ double lanes_total(double v, double* sd, int L, int C) {
  const int t = threadIdx.x, lane = t / C;
  __syncthreads();  // sd is free
  sd[t] = v;
  for (int h = L >> 1; h > 0; h >>= 1) {
    __syncthreads();
    if (lane < h) {
      v += sd[t + h * C];
      sd[t] = v;
    }
  }
  __syncthreads();
  return sd[t % C];
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
bn_prelu_stats(const T* __restrict__ x, long long rows, int C, long long rows_per_block,
               float eps, float momentum, float keep, float unbiased, float* __restrict__ stat,
               float* __restrict__ running_mean, float* __restrict__ running_var,
               float* __restrict__ partials, unsigned* __restrict__ ticket) {
  constexpr int V = Act<T>::kVec;
  const Slots<T> s(C);
  const long long lo = static_cast<long long>(blockIdx.x) * rows_per_block;
  const long long hi = min(rows, lo + rows_per_block);
  float n = 0.f, mean[V], m2[V];
#pragma unroll
  for (int i = 0; i < V; ++i) mean[i] = m2[i] = 0.f;
  for (long long r = lo + s.r0; r < hi; r += static_cast<long long>(s.R) * kUnroll) {
    uint4 raw[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long rr = r + static_cast<long long>(u) * s.R;
      raw[u] = rr < hi ? __ldg(reinterpret_cast<const uint4*>(x + rr * C) + s.g)
                       : make_uint4(0u, 0u, 0u, 0u);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (r + static_cast<long long>(u) * s.R >= hi) break;
      float v[V];
      Act<T>::to_float(raw[u], v);
      n += 1.f;
      const float rn = 1.f / n;
#pragma unroll
      for (int i = 0; i < V; ++i) {
        const float d = v[i] - mean[i];
        mean[i] += d * rn;
        m2[i] += d * (v[i] - mean[i]);
      }
    }
  }

  // the block's R row slots, merged in a fixed tree: slot r0 + h into r0
  __shared__ __align__(16) float sm[2 * kThreads * V];
  __shared__ float sn[kThreads];
  float* smean = sm;
  float* sm2 = sm + kThreads * V;
  const int own = threadIdx.x * V;  // = (r0 * G + g) * V: slot r0, channels g*V..
#pragma unroll
  for (int i = 0; i < V; ++i) {
    smean[own + i] = mean[i];
    sm2[own + i] = m2[i];
  }
  if (s.g == 0) sn[s.r0] = n;
  for (int h = s.R >> 1; h > 0; h >>= 1) {
    __syncthreads();
    if (s.r0 < h) {
      const int other = own + h * s.G * V;
      chan<V>(n, mean, m2, sn[s.r0 + h], smean + other, sm2 + other);
#pragma unroll
      for (int i = 0; i < V; ++i) {
        smean[own + i] = mean[i];
        sm2[own + i] = m2[i];
      }
      if (s.g == 0) sn[s.r0] = n;
    }
  }
  const int P = 2 * C + 1;  // a block's partial: mean[C], m2[C] (its count is its rows)
  if (s.r0 == 0) {
    float* part = partials + static_cast<long long>(blockIdx.x) * P;
#pragma unroll
    for (int i = 0; i < V; ++i) {
      part[s.g * V + i] = mean[i];
      part[C + s.g * V + i] = m2[i];
    }
  }
  if (!last_block(ticket)) return;

  // the last block: thread (lane, c) reads blocks lane, lane + L, ... of
  // channel c; the grand mean from sum n_b mean_b, then M2 = sum M2_b +
  // n_b (mean_b - mean)^2, each summed in fp64 in a fixed order
  const int L = kThreads / C, c = threadIdx.x % C, lane = threadIdx.x / C;
  const int nb = gridDim.x;
  float pm[kPer], pq[kPer];
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int b = lane + k * L;
    pm[k] = b < nb ? __ldcg(partials + static_cast<long long>(b) * P + c) : 0.f;
    pq[k] = b < nb ? __ldcg(partials + static_cast<long long>(b) * P + C + c) : 0.f;
  }
  const auto rows_of = [&](long long b) {
    return static_cast<double>(min(rows, (b + 1) * rows_per_block) - b * rows_per_block);
  };
  double* sd = reinterpret_cast<double*>(sm);
  double v = 0.0;
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int b = lane + k * L;
    if (b < nb) v += rows_of(b) * pm[k];
  }
  const double n_all = static_cast<double>(rows);
  const double grand = lanes_total(v, sd, L, C) / n_all;
  v = 0.0;
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int b = lane + k * L;
    if (b < nb) {
      const double d = pm[k] - grand;
      v += pq[k] + rows_of(b) * d * d;
    }
  }
  const double m2_all = lanes_total(v, sd, L, C);
  if (lane == 0) {
    const float mu = static_cast<float>(grand);
    const float var = static_cast<float>(m2_all / n_all);  // biased, as var(unbiased=False)
    stat[c] = mu;
    stat[C + c] = rsqrtf(__fadd_rn(var, eps));
    running_mean[c] = __fadd_rn(__fmul_rn(keep, running_mean[c]), __fmul_rn(momentum, mu));
    running_var[c] = __fadd_rn(__fmul_rn(keep, running_var[c]),
                               __fmul_rn(momentum, __fmul_rn(var, unbiased)));
    if (c == 0) *ticket = 0u;  // for the next launch
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
bn_prelu_apply(const T* __restrict__ x, T* __restrict__ y, long long vecs, int C,
               const float* __restrict__ mean, const float* __restrict__ scale, int scale_is_var,
               float eps, const float* __restrict__ gamma, const float* __restrict__ beta,
               const float* __restrict__ slope) {
  constexpr int V = Act<T>::kVec;
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;  // a multiple of C / V
  const long long first = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  const int g = static_cast<int>(first % (C / V));
  Channel ch[V];
#pragma unroll
  for (int i = 0; i < V; ++i)
    ch[i] = channel(mean, scale, scale_is_var, eps, gamma, beta, g * V + i);
  const float a = Act<T>::round(*slope);  // PReLU.forward's weight.to(x.dtype)
  const uint4* xv = reinterpret_cast<const uint4*>(x);
  uint4* yv = reinterpret_cast<uint4*>(y);
  for (long long v = first; v < vecs; v += stride * kUnroll) {
    uint4 raw[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long at = v + u * stride;
      raw[u] = at < vecs ? __ldg(xv + at) : make_uint4(0u, 0u, 0u, 0u);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long at = v + u * stride;
      if (at >= vecs) break;
      float f[V];
      Act<T>::to_float(raw[u], f);
#pragma unroll
      for (int i = 0; i < V; ++i) {
        const float z = norm<T>(f[i], ch[i]);
        f[i] = z > 0.f ? z : Act<T>::round(__fmul_rn(a, z));
      }
      yv[at] = Act<T>::from_float(f);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
bn_prelu_bwd_reduce(const T* __restrict__ x, const T* __restrict__ dy, long long rows, int C,
                    long long rows_per_block, const float* __restrict__ mean,
                    const float* __restrict__ scale, int scale_is_var, float eps,
                    const float* __restrict__ gamma, const float* __restrict__ beta,
                    const float* __restrict__ slope, float* __restrict__ dgamma,
                    float* __restrict__ dbeta, float* __restrict__ dslope,
                    float* __restrict__ partials, unsigned* __restrict__ ticket) {
  constexpr int V = Act<T>::kVec;
  const Slots<T> s(C);
  Channel ch[V];
#pragma unroll
  for (int i = 0; i < V; ++i)
    ch[i] = channel(mean, scale, scale_is_var, eps, gamma, beta, s.g * V + i);
  const float a = Act<T>::round(*slope);
  const long long lo = static_cast<long long>(blockIdx.x) * rows_per_block;
  const long long hi = min(rows, lo + rows_per_block);
  float s1[V], s2[V], sa = 0.f;
#pragma unroll
  for (int i = 0; i < V; ++i) s1[i] = s2[i] = 0.f;
  for (long long r = lo + s.r0; r < hi; r += static_cast<long long>(s.R) * kUnroll) {
    uint4 rx[kUnroll], rd[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long rr = r + static_cast<long long>(u) * s.R;
      const bool in = rr < hi;
      const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
      rx[u] = in ? __ldg(reinterpret_cast<const uint4*>(x + rr * C) + s.g) : zero;
      rd[u] = in ? __ldg(reinterpret_cast<const uint4*>(dy + rr * C) + s.g) : zero;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (r + static_cast<long long>(u) * s.R >= hi) break;
      float xf[V], df[V];
      Act<T>::to_float(rx[u], xf);
      Act<T>::to_float(rd[u], df);
#pragma unroll
      for (int i = 0; i < V; ++i) {
        const float z = norm<T>(xf[i], ch[i]);
        const bool pos = z > 0.f;
        const float dz = pos ? df[i] : Act<T>::round(__fmul_rn(a, df[i]));
        if (!pos) sa += Act<T>::round(__fmul_rn(z, df[i]));
        const float xhat = __fmul_rn(__fsub_rn(xf[i], ch[i].mean), ch[i].rstd);
        s1[i] += dz;
        s2[i] += dz * xhat;
      }
    }
  }

  // the block's row slots summed in a fixed tree, the slope over its warps
  __shared__ __align__(16) float sm[2 * kThreads * V];
  __shared__ float swarp[kThreads / 32];
  float* ss1 = sm;
  float* ss2 = sm + kThreads * V;
  const int own = threadIdx.x * V;
#pragma unroll
  for (int i = 0; i < V; ++i) {
    ss1[own + i] = s1[i];
    ss2[own + i] = s2[i];
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) sa += __shfl_down_sync(0xffffffffu, sa, o);
  if ((threadIdx.x & 31) == 0) swarp[threadIdx.x >> 5] = sa;
  for (int h = s.R >> 1; h > 0; h >>= 1) {
    __syncthreads();
    if (s.r0 < h) {
      const int other = own + h * s.G * V;
#pragma unroll
      for (int i = 0; i < V; ++i) {
        s1[i] += ss1[other + i];
        s2[i] += ss2[other + i];
        ss1[own + i] = s1[i];
        ss2[own + i] = s2[i];
      }
    }
  }
  __syncthreads();
  const int P = 2 * C + 1;  // a block's partial: sum dz[C], sum dz xhat[C], the slope's sum
  float* part = partials + static_cast<long long>(blockIdx.x) * P;
  if (s.r0 == 0) {
#pragma unroll
    for (int i = 0; i < V; ++i) {
      part[s.g * V + i] = s1[i];
      part[C + s.g * V + i] = s2[i];
    }
  }
  if (threadIdx.x == 0) {
    float t = 0.f;
    for (int w = 0; w < kThreads / 32; ++w) t += swarp[w];
    part[2 * C] = t;
  }
  if (!last_block(ticket)) return;

  // the last block: thread (lane, c) sums blocks lane, lane + L, ... of
  // channel c in fp64; the lanes in a fixed tree
  const int L = kThreads / C, c = threadIdx.x % C, lane = threadIdx.x / C;
  const int nb = gridDim.x;
  float p1[kPer], p2[kPer];
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int b = lane + k * L;
    p1[k] = b < nb ? __ldcg(partials + static_cast<long long>(b) * P + c) : 0.f;
    p2[k] = b < nb ? __ldcg(partials + static_cast<long long>(b) * P + C + c) : 0.f;
  }
  double t1 = 0.0, t2 = 0.0;
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    t1 += p1[k];
    t2 += p2[k];
  }
  double* sd = reinterpret_cast<double*>(sm);
  t1 = lanes_total(t1, sd, L, C);
  t2 = lanes_total(t2, sd, L, C);
  if (lane == 0) {
    dbeta[c] = static_cast<float>(t1);
    dgamma[c] = static_cast<float>(t2);
  }
  if (threadIdx.x < 32) {  // the slope: lane l sums blocks l, l + 32, ... in order
    double t = 0.0;
    for (int b = threadIdx.x; b < nb; b += 32)
      t += __ldcg(partials + static_cast<long long>(b) * P + 2 * C);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) t += __shfl_down_sync(0xffffffffu, t, o);
    if (threadIdx.x == 0) {
      *dslope = Act<T>::round(static_cast<float>(t));
      *ticket = 0u;  // for the next launch
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
bn_prelu_bwd_dx(const T* __restrict__ x, const T* __restrict__ dy, T* __restrict__ dx,
                long long vecs, int C, float n, const float* __restrict__ mean,
                const float* __restrict__ scale, int scale_is_var, float eps,
                const float* __restrict__ gamma, const float* __restrict__ beta,
                const float* __restrict__ slope, const float* __restrict__ dgamma,
                const float* __restrict__ dbeta, int train) {
  constexpr int V = Act<T>::kVec;
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  const long long first = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  const int g = static_cast<int>(first % (C / V));
  Channel ch[V];
  float k[V], s1[V], s2[V];
#pragma unroll
  for (int i = 0; i < V; ++i) {
    const int c = g * V + i;
    ch[i] = channel(mean, scale, scale_is_var, eps, gamma, beta, c);
    // train: gamma rstd / n; eval: the forward's rstd gamma
    k[i] = train ? __fdiv_rn(__fmul_rn(gamma[c], ch[i].rstd), n) : ch[i].inv;
    s1[i] = dbeta[c];
    s2[i] = dgamma[c];
  }
  const float a = Act<T>::round(*slope);
  const uint4* xv = reinterpret_cast<const uint4*>(x);
  const uint4* dv = reinterpret_cast<const uint4*>(dy);
  uint4* out = reinterpret_cast<uint4*>(dx);
  for (long long v = first; v < vecs; v += stride * kUnroll) {
    uint4 rx[kUnroll], rd[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long at = v + u * stride;
      const bool in = at < vecs;
      rx[u] = in ? __ldg(xv + at) : make_uint4(0u, 0u, 0u, 0u);
      rd[u] = in ? __ldg(dv + at) : make_uint4(0u, 0u, 0u, 0u);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long at = v + u * stride;
      if (at >= vecs) break;
      float xf[V], df[V];
      Act<T>::to_float(rx[u], xf);
      Act<T>::to_float(rd[u], df);
#pragma unroll
      for (int i = 0; i < V; ++i) {
        const float z = norm<T>(xf[i], ch[i]);
        const float dz = z > 0.f ? df[i] : Act<T>::round(__fmul_rn(a, df[i]));
        if (train) {
          const float xhat = __fmul_rn(__fsub_rn(xf[i], ch[i].mean), ch[i].rstd);
          xf[i] = k[i] * (n * dz - s1[i] - xhat * s2[i]);
        } else {
          xf[i] = dz * k[i];
        }
      }
      out[at] = Act<T>::from_float(xf);
    }
  }
}

int sm_count() {
  static int counts[kMaxDevices] = {0};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= kMaxDevices) return 132;
  if (counts[dev] == 0) {
    int n = 0;
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    counts[dev] = n > 0 ? n : 132;
  }
  return counts[dev];
}

// The grid of an elementwise kernel: one full wave of resident blocks, or
// fewer where there are fewer vectors. The blocks a multiprocessor holds
// are asked of the runtime once per kernel and device, as sm_count is.
template <auto kKernel>
unsigned wave_blocks(long long vecs) {
  static int per_sm[kMaxDevices] = {0};
  int dev = 0;
  const bool known = cudaGetDevice(&dev) == cudaSuccess && dev >= 0 && dev < kMaxDevices;
  int blocks = known ? per_sm[dev] : 0;
  if (blocks == 0) {
    if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kKernel, kThreads, 0) !=
            cudaSuccess ||
        blocks < 1)
      blocks = 1;
    if (known) per_sm[dev] = blocks;
  }
  const long long want = (vecs + kThreads - 1) / kThreads;
  const long long wave = static_cast<long long>(blocks) * sm_count();
  return static_cast<unsigned>(want < wave ? want : wave);
}

// A reducing kernel's split of the rows: (blocks, rows a block), at most
// kReduceBlocks blocks and kPartialCells / C, of whole passes of R rows.
void reduce_split(long long rows, int C, int vec, unsigned* blocks, long long* rows_per_block) {
  const long long R = kThreads / (C / vec);
  const long long passes = (rows + R - 1) / R;
  const long long most = kPartialCells / C < kReduceBlocks ? kPartialCells / C : kReduceBlocks;
  const long long nb = passes < most ? passes : most;
  *rows_per_block = ((passes + nb - 1) / nb) * R;
  *blocks = static_cast<unsigned>((rows + *rows_per_block - 1) / *rows_per_block);
}

bool shape_ok(int C, int vec) {
  return C >= vec && C <= kThreads && kThreads % C == 0 && C % vec == 0;
}

template <typename T>
int forward(int train, const void* x, void* y, long long rows, int C, float eps, float momentum,
            float keep, float unbiased, const float* gamma, const float* beta,
            const float* slope, float* running_mean, float* running_var, float* stat,
            float* partials, unsigned* ticket, cudaStream_t st) {
  constexpr int V = Act<T>::kVec;
  if (!shape_ok(C, V) || rows < 1) return static_cast<int>(cudaErrorInvalidValue);
  const T* xt = static_cast<const T*>(x);
  const long long vecs = rows * (C / V);
  const float* mean = running_mean;
  const float* scale = running_var;
  if (train) {
    unsigned blocks;
    long long rpb;
    reduce_split(rows, C, V, &blocks, &rpb);
    bn_prelu_stats<T><<<blocks, kThreads, 0, st>>>(xt, rows, C, rpb, eps, momentum, keep,
                                                   unbiased, stat, running_mean, running_var,
                                                   partials, ticket);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    mean = stat;
    scale = stat + C;
  }
  bn_prelu_apply<T><<<wave_blocks<bn_prelu_apply<T>>(vecs), kThreads, 0, st>>>(
      xt, static_cast<T*>(y), vecs, C, mean, scale, train ? 0 : 1, eps, gamma, beta, slope);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int backward(int train, const void* x, const void* dy, void* dx, long long rows, int C,
             float eps, const float* mean, const float* scale, const float* gamma,
             const float* beta, const float* slope, float* dgamma, float* dbeta, float* dslope,
             float* partials, unsigned* ticket, cudaStream_t st) {
  constexpr int V = Act<T>::kVec;
  if (!shape_ok(C, V) || rows < 1) return static_cast<int>(cudaErrorInvalidValue);
  const T* xt = static_cast<const T*>(x);
  const T* dyt = static_cast<const T*>(dy);
  const int is_var = train ? 0 : 1;
  unsigned blocks;
  long long rpb;
  reduce_split(rows, C, V, &blocks, &rpb);
  bn_prelu_bwd_reduce<T><<<blocks, kThreads, 0, st>>>(xt, dyt, rows, C, rpb, mean, scale, is_var,
                                                      eps, gamma, beta, slope, dgamma, dbeta,
                                                      dslope, partials, ticket);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long vecs = rows * (C / V);
  bn_prelu_bwd_dx<T><<<wave_blocks<bn_prelu_bwd_dx<T>>(vecs), kThreads, 0, st>>>(
      xt, dyt, static_cast<T*>(dx), vecs, C, static_cast<float>(rows), mean, scale, is_var, eps,
      gamma, beta, slope, dgamma, dbeta, train);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The partials' size in floats for C channels, and the widest C.
extern "C" long long facegen_bn_prelu_partials(int C) {
  return static_cast<long long>(kReduceBlocks) * (2 * C + 1);
}

extern "C" int facegen_bn_prelu_max_channels() { return kThreads; }

// The forward of rows x C activations (bf16 if bf16, else fp32). train: two
// launches, the statistics into stat (mean[C], rstd[C]) and the running
// statistics moved, then the apply; eval: one launch on the running
// statistics. partials: facegen_bn_prelu_partials(C) floats; ticket: one
// unsigned at 0.
extern "C" int facegen_bn_prelu_forward(int bf16, int train, const void* x, void* y,
                                        long long rows, int C, float eps, float momentum,
                                        float keep, float unbiased, const float* gamma,
                                        const float* beta, const float* slope,
                                        float* running_mean, float* running_var, float* stat,
                                        float* partials, unsigned* ticket, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return bf16 ? forward<__nv_bfloat16>(train, x, y, rows, C, eps, momentum, keep, unbiased, gamma,
                                       beta, slope, running_mean, running_var, stat, partials,
                                       ticket, st)
              : forward<float>(train, x, y, rows, C, eps, momentum, keep, unbiased, gamma, beta,
                               slope, running_mean, running_var, stat, partials, ticket, st);
}

// The backward: two launches, the reduction (the gradients of gamma, beta
// and the slope) then dx. mean and scale are the forward's: train, the
// batch's mean and rstd; eval, the running mean and variance.
extern "C" int facegen_bn_prelu_backward(int bf16, int train, const void* x, const void* dy,
                                         void* dx, long long rows, int C, float eps,
                                         const float* mean, const float* scale,
                                         const float* gamma, const float* beta,
                                         const float* slope, float* dgamma, float* dbeta,
                                         float* dslope, float* partials, unsigned* ticket,
                                         void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return bf16 ? backward<__nv_bfloat16>(train, x, dy, dx, rows, C, eps, mean, scale, gamma, beta,
                                        slope, dgamma, dbeta, dslope, partials, ticket, st)
              : backward<float>(train, x, dy, dx, rows, C, eps, mean, scale, gamma, beta, slope,
                                dgamma, dbeta, dslope, partials, ticket, st);
}
