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
// the bf16 path runs on the tensor cores (WMMA 16x16x16, fp32
// accumulate), fed by a 3-stage cp.async ring of shared-memory tiles.
// On the H100 the ring gained only 1-3 % over a load-sync-compute loop:
// the MMA loop itself (fragment loads from shared memory per MMA, two
// 128-thread blocks per SM at 244 registers) is the limit, which wgmma
// with operands read straight from shared memory, TMA and warp
// specialisation address in later work. The fp32 path is a SIMT FMA
// kernel with fp32 accumulate (one stage), kept for tight checks.
//
// Requirements, checked by the Python wrapper: NHWC contiguous x,
// Cin and Cout multiples of 8, 16-byte aligned pointers, fewer than
// 2^31 elements per tensor.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

namespace {

using namespace nvcuda;

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
// A 64 x 64 warp tile loads 4 + 4 fragments from shared memory per 16
// MMAs (a 32 x 64 one: 2 + 4 per 8); on an H100 at the G shapes it ran
// 15-19 % faster than 32 x 64 tiles with 8 warps, and 128 x 256 or
// 256 x 128 block tiles were slower (PERF.md).
constexpr int BM = 128, BN = 128, BK = 32, SPAD = 8;
constexpr int WARPS_M = 2, WARPS_N = 2;
constexpr int WTM = BM / WARPS_M, WTN = BN / WARPS_N;  // warp tile 64 x 64
constexpr int FM = WTM / 16, FN = WTN / 16;            // 4 x 4 fragments
constexpr int THREADS = 32 * WARPS_M * WARPS_N;        // 128

constexpr int A_CHUNKS = BK / 8;                      // 16-byte chunks per A row
constexpr int A_ROWS_PER_PASS = THREADS / A_CHUNKS;   // 32
constexpr int A_PASSES = BM / A_ROWS_PER_PASS;        // 4
constexpr int B_CHUNKS = BN / 8;                      // 16-byte chunks per B row
constexpr int B_ROWS_PER_PASS = THREADS / B_CHUNKS;   // 8
constexpr int B_PASSES = BK / B_ROWS_PER_PASS;        // 4

constexpr int STAGES = 3;                             // cp.async ring depth
constexpr int A_STAGE = BM * (BK + SPAD);             // bf16 elements per stage
constexpr int B_STAGE = BK * (BN + SPAD);
constexpr int SMEM_BF16 = STAGES * (A_STAGE + B_STAGE) * 2;  // 56832 bytes
static_assert(WARPS_M * WARPS_N * 16 * 16 * 4 <= SMEM_BF16, "epilogue scratch fits");

// 16-byte global -> shared copy that bypasses registers; with pred false
// it writes 16 zero bytes and reads nothing (src-size 0).
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool pred) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(gmem),
               "r"(pred ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// A STAGES-deep ring of (A, B) tiles in shared memory, filled with
// cp.async: while the tensor cores work on tile kt, the copies of tiles
// kt+1 .. kt+STAGES-1 are in flight, which hides global-load latency that
// a load-sync-compute loop exposes at every K step.
__global__ void __launch_bounds__(THREADS)
upconv_fwd_bf16(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ wc,
                const __nv_bfloat16* __restrict__ bias, __nv_bfloat16* __restrict__ out,
                Geom g) {
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* As = reinterpret_cast<__nv_bfloat16*>(smem);  // [STAGES][BM][BK+SPAD]
  __nv_bfloat16* Bs = As + STAGES * A_STAGE;                      // [STAGES][BK][BN+SPAD]

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int wm = warp / WARPS_N, wn = warp % WARPS_N;
  const int tiles_n = (g.nc + BN - 1) / BN;
  const int m0 = (blockIdx.x / tiles_n) * BM;
  const int n0 = (blockIdx.x % tiles_n) * BN;

  // A thread loads the same A rows at every K step: resolve their pixels once.
  const int a_chunk = tid % A_CHUNKS;
  int a_b[A_PASSES], a_i[A_PASSES], a_j[A_PASSES];
  bool a_ok[A_PASSES];
#pragma unroll
  for (int s = 0; s < A_PASSES; ++s) {
    const int m = m0 + tid / A_CHUNKS + s * A_ROWS_PER_PASS;
    a_ok[s] = m < g.m;
    pixel_of(a_ok[s] ? m : 0, g, a_b[s], a_i[s], a_j[s]);
  }
  const int b_chunk = tid % B_CHUNKS;
  const int b_col = n0 + b_chunk * 8;
  const bool b_ok = b_col < g.nc;

  // K steps: 9 taps x ceil(Cin / BK) channel chunks
  const int chunks = (g.cin + BK - 1) / BK;
  const int steps = 9 * chunks;

  auto load_tile = [&](int stage, int kt) {
    const int tap = kt / chunks, c0 = (kt - tap * chunks) * BK;
    const int dy = tap / 3 - 1, dx = tap % 3 - 1;
    __nv_bfloat16* as = As + stage * A_STAGE;
    __nv_bfloat16* bs = Bs + stage * B_STAGE;
#pragma unroll
    for (int s = 0; s < A_PASSES; ++s) {
      const int r = tid / A_CHUNKS + s * A_ROWS_PER_PASS;
      const int c = c0 + a_chunk * 8;
      const int yi = a_i[s] + dy, xj = a_j[s] + dx;
      const bool ok = a_ok[s] && c < g.cin && inside(yi, xj, g);
      const __nv_bfloat16* src =
          ok ? x + (((long long)a_b[s] * g.h + yi) * g.w + xj) * g.cin + c : x;
      cp_async16(as + r * (BK + SPAD) + a_chunk * 8, src, ok);
    }
#pragma unroll
    for (int s = 0; s < B_PASSES; ++s) {
      const int kr = tid / B_CHUNKS + s * B_ROWS_PER_PASS;
      const int k = c0 + kr;
      const bool ok = b_ok && k < g.cin;
      const __nv_bfloat16* src = ok ? wc + ((long long)tap * g.cin + k) * g.nc + b_col : wc;
      cp_async16(bs + kr * (BN + SPAD) + b_chunk * 8, src, ok);
    }
  };

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[FM][FN];
#pragma unroll
  for (int fm = 0; fm < FM; ++fm)
#pragma unroll
    for (int fn = 0; fn < FN; ++fn) wmma::fill_fragment(acc[fm][fn], 0.0f);

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < steps) load_tile(s, s);
    cp_async_commit();
  }
  for (int kt = 0; kt < steps; ++kt) {
    // tile kt has landed once at most STAGES-2 newer groups are pending;
    // the barrier also frees the stage that tile kt-1 was read from
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    const int next = kt + STAGES - 1;
    if (next < steps) load_tile(next % STAGES, next);
    cp_async_commit();  // possibly empty: keeps the group count uniform

    const __nv_bfloat16* as = As + (kt % STAGES) * A_STAGE;
    const __nv_bfloat16* bs = Bs + (kt % STAGES) * B_STAGE;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> af[FM];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> bf[FN];
#pragma unroll
      for (int fm = 0; fm < FM; ++fm)
        wmma::load_matrix_sync(af[fm], as + (wm * WTM + fm * 16) * (BK + SPAD) + kk, BK + SPAD);
#pragma unroll
      for (int fn = 0; fn < FN; ++fn)
        wmma::load_matrix_sync(bf[fn], bs + kk * (BN + SPAD) + wn * WTN + fn * 16, BN + SPAD);
#pragma unroll
      for (int fm = 0; fm < FM; ++fm)
#pragma unroll
        for (int fn = 0; fn < FN; ++fn) wmma::mma_sync(acc[fm][fn], af[fm], bf[fn], acc[fm][fn]);
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is free: its start becomes the epilogue scratch

  // Epilogue: each fragment goes through this warp's 16x16 scratch; a
  // lane then owns 8 consecutive columns of one row, which lie in one
  // phase block (Cout is a multiple of 8) and so are 8 consecutive
  // channels of one output pixel: one 16-byte store.
  float* cs = reinterpret_cast<float*>(smem) + warp * 16 * 16;
  const int er = lane / 2, ec = (lane % 2) * 8;
#pragma unroll
  for (int fm = 0; fm < FM; ++fm) {
#pragma unroll
    for (int fn = 0; fn < FN; ++fn) {
      wmma::store_matrix_sync(cs, acc[fm][fn], 16, wmma::mem_row_major);
      __syncwarp();
      const int m = m0 + wm * WTM + fm * 16 + er;
      const int col = n0 + wn * WTN + fn * 16 + ec;
      if (m < g.m && col < g.nc) {
        int b, i, j, o;
        pixel_of(m, g, b, i, j);
        const long long off = out_offset(b, i, j, col, g, o);
        __align__(16) __nv_bfloat16 v[8];
#pragma unroll
        for (int t = 0; t < 8; ++t)
          v[t] = __float2bfloat16(cs[er * 16 + ec + t] + __bfloat162float(bias[o + t]));
        *reinterpret_cast<uint4*>(out + off) = *reinterpret_cast<const uint4*>(v);
      }
      __syncwarp();
    }
  }
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
  // more than the 48 KB of shared memory a launch gets without asking
  cudaError_t err = cudaFuncSetAttribute(upconv_fwd_bf16,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BF16);
  if (err != cudaSuccess) return static_cast<int>(err);
  upconv_fwd_bf16<<<n_tiles(g, BM, BN), THREADS, SMEM_BF16, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(wc),
      static_cast<const __nv_bfloat16*>(bias), static_cast<__nv_bfloat16*>(out), g);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int facegen_upconv_fwd_f32(const void* x, const void* wc, const void* bias, void* out,
                                      int n, int h, int w, int cin, int cout, void* stream) {
  const Geom g = make_geom(n, h, w, cin, cout);
  upconv_fwd_f32<<<n_tiles(g, FBM, FBN), FTHREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(wc), static_cast<const float*>(bias),
      static_cast<float*>(out), g);
  return static_cast<int>(cudaGetLastError());
}
