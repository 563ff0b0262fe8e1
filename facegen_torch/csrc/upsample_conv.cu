// Fused nearest-upsample(2x) + KxK same-pad conv, forward, for sm_90a.
//
// Replaces the TPU kernel facegen/ops/pallas/upsample_conv.py:
// conv3x3_pallas (+ _conv_kernel) as driven by upsample_conv_pallas.
// Both compute the same function: the upsample + KxK conv collapses
// (K = 3 or 5) into one 3x3 same-pad conv at input resolution with
// 4*Cout output channels, phase block p = 2a+b, followed by a
// depth-to-space interleave (facegen_torch/ops/upsample_conv.py).
//
// Design. An implicit GEMM: rows are the M = N*H*W input pixels,
// columns the 4*Cout collapsed channels, depth K = 9*Cin ordered
// (tap, cin) like the collapsed weight wc (9*Cin, 4*Cout), row-major.
// Each K step covers one tap and a chunk of Cin, so a tile row is one
// contiguous run of NHWC channels. Loads that fall outside the image
// are masked to zero, so no padded copy of x exists. The epilogue adds
// the bias and writes column p*Cout+o of pixel (n, i, j) straight to
// out[n, 2i+a, 2j+b, o]; the (N, H, W, 4*Cout) GEMM result never
// touches device memory, which saves a write and a read of the
// largest tensor of the op (268 MB in bf16 at G's upconv2, N = 1024).
//
// What bounds it. At the sampler's shapes (N = 1024, K = 1152 and
// 2304) the GEMM does ~1000 and ~1500 FLOP per byte of x, wc and out,
// far above the H100's ~295 FLOP/byte ridge: it is compute bound, so
// the bf16 path runs on Hopper's tensor cores through wgmma, in the
// persistent, warp-specialised mainloop of csrc/igemm_sm90.cuh (TMA for
// the weight and for x's whole-row boxes, fp32 accumulators in
// registers). The fp32 path is a SIMT FMA kernel with fp32 accumulate
// (one stage), kept for tight checks.
//
// Requirements, checked by the Python wrapper: NHWC contiguous x,
// Cin and Cout multiples of 8, 16-byte aligned pointers, fewer than
// 2^31 elements per tensor.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "igemm_sm90.cuh"

namespace {

struct Geom {
  int n, h, w, cin, cout;
  int m;   // GEMM rows: n * h * w input pixels
  int nc;  // GEMM columns: 4 * cout
};

// GEMM row m -> input pixel (b, i, j).
__device__ __forceinline__ void pixel_of(int m, const Geom& g, int& b, int& i, int& j) {
  const int hw = g.h * g.w;
  b = m / hw;
  const int r = m - b * hw;
  i = r / g.w;
  j = r - i * g.w;
}

// Element offset of out[b, 2i+a, 2j+c, o] for GEMM column col = p*cout+o,
// p = 2a+c (the depth-to-space interleave).
__device__ __forceinline__ long long out_offset(int b, int i, int j, int col, const Geom& g,
                                                int& o) {
  const int p = col / g.cout;
  o = col - p * g.cout;
  const int a = p >> 1, c = p & 1;
  return (((long long)b * 2 * g.h + 2 * i + a) * (2 * g.w) + (2 * j + c)) * g.cout + o;
}

__device__ __forceinline__ bool inside(int y, int x, const Geom& g) {
  return y >= 0 && y < g.h && x >= 0 && x < g.w;
}

// ---------------------------------------------------------------- bf16
// The implicit GEMM of csrc/igemm_sm90.cuh: rows the N*H*W pixels, columns
// the 4*Cout collapsed channels, K steps of 64 (tap, cin) pairs. A K step
// covers one tap and a 64-channel chunk of it, so an A chunk is 8 NHWC
// channels of one shifted pixel; B is rows (tap, cin0 .. cin0+63) of wc,
// read MN-major in 64-column slabs by TMA (rows past Cin read as zero).
template <int BN>
struct UpconvFwd {
  static constexpr int TRANS_A = 0, TRANS_B = 1;
  static constexpr bool OWN_GATHER = false, STREAM_K = false;
  static constexpr int SLAB_BYTES = 64 * igemm::BK * 2;
  const __nv_bfloat16* a;  // x
  const __nv_bfloat16* bias;
  __nv_bfloat16* out;
  Geom g;
  int m, n, steps, splits;  // the GEMM: rows, columns, K steps, K splits
  int h, w;                 // x's pixel grid
  int chunks;               // K steps per tap: ceil(Cin / 64)
  bool a_tma;               // x's tiles are boxes of whole rows (igemm::row_box)

  // A by TMA: x as (Cin, W, H, N); tap (di, dj) shifts the tile's box,
  // whose pixels past the border read as zero (the same-pad border)
  __device__ __forceinline__ void load_a(const CUtensorMap* map, uint32_t dst, uint32_t bar,
                                         int ks, int m0) const {
    const int tap = ks / chunks;
    int n0, i0;
    igemm::tile_origin(m0, g.h, g.w, n0, i0);
    igemm::tma_load_4d(dst, map, bar, (ks - tap * chunks) * igemm::BK, tap % 3 - 1,
                       i0 + tap / 3 - 1, n0);
  }

  __device__ __forceinline__ int row_base(int row, int& i, int& j) const {
    int b;
    pixel_of(row, g, b, i, j);
    return row * g.cin;
  }
  // step ks: tap (di+1, dj+1), channels (ks % chunks) * 64 + chunk * 8 ...
  __device__ __forceinline__ bool a_step(int ks, int chunk, int& delta, int& di, int& dj) const {
    const int tap = ks / chunks;
    const int c = (ks - tap * chunks) * igemm::BK + chunk * 8;
    di = tap / 3 - 1;
    dj = tap % 3 - 1;
    delta = (di * g.w + dj) * g.cin + c;
    return c < g.cin;
  }

  // The tile's 64-column slabs that start inside wc; a slab past the last
  // column is not loaded (its columns are never stored).
  __device__ __forceinline__ int slabs(int n0) const {
    const int left = (n - n0 + 63) / 64;
    return left < BN / 64 ? left : BN / 64;
  }
  __device__ __forceinline__ uint32_t b_bytes(int n0) const { return slabs(n0) * SLAB_BYTES; }
  __device__ __forceinline__ void load_b(const CUtensorMap* map, uint32_t dst, uint32_t bar,
                                         int ks, int n0) const {
    const int tap = ks / chunks, c0 = (ks - tap * chunks) * igemm::BK;
    const int nb = slabs(n0);
    for (int s = 0; s < nb; ++s)
      igemm::tma_load_3d(dst + s * SLAB_BYTES, map, bar, n0 + 64 * s, c0, tap);
  }

  // the epilogue: bf16 after the bias, out[b, 2i+a, 2j+c, o] for column
  // p*Cout+o of pixel (b, i, j), p = 2a+c
  using Stage = __nv_bfloat16;
  using Stage2 = __nv_bfloat162;
  __device__ __forceinline__ Stage2 stage2(int col, float v0, float v1) const {
    const int o = (g.cout & (g.cout - 1)) == 0 ? col & (g.cout - 1) : col % g.cout;
    return __floats2bfloat162_rn(v0 + __bfloat162float(bias[o]),
                                 v1 + __bfloat162float(bias[o + 1]));
  }
  __device__ __forceinline__ long long row_offset(int row, int) const {
    int b, i, j;
    pixel_of(row, g, b, i, j);
    return (((long long)b * 2 * g.h + 2 * i) * (2 * g.w) + 2 * j) * g.cout;
  }
  __device__ __forceinline__ long long col_offset(int col) const {
    const int p = col / g.cout, o = col - p * g.cout;
    return ((long long)(p >> 1) * (2 * g.w) + (p & 1)) * g.cout + o;
  }
  __device__ __forceinline__ void store8(long long off, const Stage* v) const {
    *reinterpret_cast<uint4*>(out + off) = *reinterpret_cast<const uint4*>(v);
  }
};

template <int BN>
int launch_fwd_bf16(const __nv_bfloat16* x, const __nv_bfloat16* wc, const __nv_bfloat16* bias,
                    __nv_bfloat16* out, const Geom& g, cudaStream_t stream) {
  CUtensorMap a_map = {}, b_map;
  cudaError_t err = igemm::weight_map(&b_map, wc, g.cin, g.nc, igemm::BK);
  int rows, imgs;
  const bool a_tma = igemm::row_box(g.h, g.w, rows, imgs);
  if (err == cudaSuccess && a_tma) {
    const cuuint64_t dims[4] = {(cuuint64_t)g.cin, (cuuint64_t)g.w, (cuuint64_t)g.h,
                                (cuuint64_t)g.n};
    const cuuint32_t box[4] = {64, (cuuint32_t)g.w, (cuuint32_t)rows, (cuuint32_t)imgs};
    err = igemm::dense_map(&a_map, x, 4, dims, box);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  const int chunks = (g.cin + igemm::BK - 1) / igemm::BK;
  const UpconvFwd<BN> p{x, bias, out, g, g.m, g.nc, 9 * chunks, 1, g.h, g.w, chunks, a_tma};
  return static_cast<int>(igemm::launch<BN>(a_map, b_map, p, stream));
}

// ---------------------------------------------------------------- fp32
constexpr int FBM = 64, FBN = 64, FBK = 16, FTHREADS = 256;

__global__ void __launch_bounds__(FTHREADS)
upconv_fwd_f32(const float* __restrict__ x, const float* __restrict__ wc,
               const float* __restrict__ bias, float* __restrict__ out, Geom g) {
  __shared__ __align__(16) float As[FBK][FBM + 4];  // A transposed: [k][row]
  __shared__ __align__(16) float Bs[FBK][FBN + 4];

  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int tiles_n = (g.nc + FBN - 1) / FBN;
  const int m0 = (blockIdx.x / tiles_n) * FBM;
  const int n0 = (blockIdx.x % tiles_n) * FBN;

  const int ar = tid / 4, aq = tid % 4;  // A row, quad of 4 channels
  const bool a_ok = m0 + ar < g.m;
  int a_b, a_i, a_j;
  pixel_of(a_ok ? m0 + ar : 0, g, a_b, a_i, a_j);
  const int bkr = tid / 16, bcol = n0 + (tid % 16) * 4;  // B row, first column
  const bool b_ok = bcol < g.nc;

  float acc[4][4] = {};
  for (int tap = 0; tap < 9; ++tap) {
    const int dy = tap / 3 - 1, dx = tap % 3 - 1;
    for (int c0 = 0; c0 < g.cin; c0 += FBK) {
      const int c = c0 + aq * 4;
      const int yi = a_i + dy, xj = a_j + dx;
      float4 av = make_float4(0.f, 0.f, 0.f, 0.f);
      if (a_ok && c < g.cin && inside(yi, xj, g))
        av = *reinterpret_cast<const float4*>(
            x + (((long long)a_b * g.h + yi) * g.w + xj) * g.cin + c);
      As[aq * 4 + 0][ar] = av.x;
      As[aq * 4 + 1][ar] = av.y;
      As[aq * 4 + 2][ar] = av.z;
      As[aq * 4 + 3][ar] = av.w;
      const int k = c0 + bkr;
      float4 bv = make_float4(0.f, 0.f, 0.f, 0.f);
      if (b_ok && k < g.cin)
        bv = *reinterpret_cast<const float4*>(wc + ((long long)tap * g.cin + k) * g.nc + bcol);
      *reinterpret_cast<float4*>(&Bs[bkr][(tid % 16) * 4]) = bv;
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < FBK; ++kk) {
        const float4 a = *reinterpret_cast<const float4*>(&As[kk][ty * 4]);
        const float4 b = *reinterpret_cast<const float4*>(&Bs[kk][tx * 4]);
        const float ra[4] = {a.x, a.y, a.z, a.w}, rb[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(ra[i], rb[j], acc[i][j]);
      }
      __syncthreads();
    }
  }

  const int col = n0 + tx * 4;  // 4 columns in one phase block: Cout % 8 == 0
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty * 4 + i;
    if (m < g.m && col < g.nc) {
      int b, pi, pj, o;
      pixel_of(m, g, b, pi, pj);
      const long long off = out_offset(b, pi, pj, col, g, o);
      *reinterpret_cast<float4*>(out + off) =
          make_float4(acc[i][0] + bias[o], acc[i][1] + bias[o + 1], acc[i][2] + bias[o + 2],
                      acc[i][3] + bias[o + 3]);
    }
  }
}

Geom make_geom(int n, int h, int w, int cin, int cout) {
  return Geom{n, h, w, cin, cout, n * h * w, 4 * cout};
}

int n_tiles(const Geom& g, int bm, int bn) {
  return ((g.m + bm - 1) / bm) * ((g.nc + bn - 1) / bn);
}

}  // namespace

// Plain C entry points for ctypes. Each launches on `stream` and
// returns cudaGetLastError() (0 = cudaSuccess): a refused launch never
// runs and is reported here, not by a later synchronize.
extern "C" int facegen_upconv_fwd_bf16(const void* x, const void* wc, const void* bias, void* out,
                                       int n, int h, int w, int cin, int cout, void* stream) {
  const Geom g = make_geom(n, h, w, cin, cout);
  const auto* xb = static_cast<const __nv_bfloat16*>(x);
  const auto* wb = static_cast<const __nv_bfloat16*>(wc);
  const auto* bb = static_cast<const __nv_bfloat16*>(bias);
  auto* ob = static_cast<__nv_bfloat16*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  // 128 x 256 tiles where they fill every SM at least once (the sampler's
  // batch), else 128 x 128 tiles, twice as many (the training batches)
  if (n_tiles(g, igemm::BM, 256) >= igemm::sm_count())
    return launch_fwd_bf16<256>(xb, wb, bb, ob, g, st);
  return launch_fwd_bf16<128>(xb, wb, bb, ob, g, st);
}

extern "C" int facegen_upconv_fwd_f32(const void* x, const void* wc, const void* bias, void* out,
                                      int n, int h, int w, int cin, int cout, void* stream) {
  const Geom g = make_geom(n, h, w, cin, cout);
  upconv_fwd_f32<<<n_tiles(g, FBM, FBN), FTHREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(wc), static_cast<const float*>(bias),
      static_cast<float*>(out), g);
  return static_cast<int>(cudaGetLastError());
}
