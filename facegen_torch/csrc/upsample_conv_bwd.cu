// Fused nearest-upsample(2x) + KxK same-pad conv, backward, for sm_90a:
// the input gradient dx and the collapsed weight gradient dWc.
//
// Replaces the TPU kernels of facegen/ops/pallas/upsample_conv.py:
//   upsample_conv_dx_pallas (conv3x3_pallas on pad(S2D(dy)) with the
//     collapsed weight flipped and transposed), and
//   _dw_kernel + upsample_conv_dw_pallas (nine x_pad^T @ S2D(dy) dots
//     accumulated over batch tiles into (9, Cin, 4*Cout) fp32).
// The forward (csrc/upsample_conv.cu) is the 3x3 phase conv
//   y[n,i,j, p*Cout+o] = sum_{u,v,c} x[n,i+u-1,j+v-1,c] wc[(u*3+v)*Cin+c, p*Cout+o]
// followed by depth-to-space, p = 2a+b landing at (2i+a, 2j+b). With
// S2D(dy)[n,i,j, p*Cout+o] = dy[n,2i+a,2j+b,o], its two gradients are
//   dx[n,i,j,c]  = sum_{u,v,col} S2D(dy)[n,i-u+1,j-v+1,col] wc[(u*3+v)*Cin+c, col]
//   dWc[(u*3+v)*Cin+c, col] = sum_{n,i,j} x[n,i+u-1,j+v-1,c] S2D(dy)[n,i,j,col].
//
// Design. Both are implicit GEMMs. Neither the padded copy nor S2D(dy)
// is ever written: the loads read dy in space-to-depth order (a K chunk
// of 8 columns is 8 channels of one dy pixel, since Cout % 8 == 0) and
// mask the image border to zero.
// - dx: rows are the N*H*W input pixels, columns Cin, K = (tap, phase,
//   cout). The A load for tap (du, dv) reads S2D(dy) at (i-du, j-dv),
//   which is the Pallas kernel's flipped tap, and B is wc read in place:
//   B[col, c] = wc[tap*Cin+c, col], a K-major operand, so no flipped or
//   transposed copy of the weight exists. bf16 runs on the forward's
//   wgmma mainloop (csrc/igemm_sm90.cuh: TMA for wc, cp.async gathers
//   for dy, one persistent block per SM).
// - dW: rows are (tap, cin), columns (phase, cout), K = the N*H*W
//   pixels. A (= x shifted by the tap) and B (= S2D(dy)) are both read
//   pixel-major, as MN-major operands. bf16 runs on the same mainloop
//   (TMA boxes of whole image rows for both where the shape allows,
//   cp.async gathers of both elsewhere).
// - fp32 (both): a 64 x 64 x 16 SIMT tile, kept for tight checks.
//
// What bounds them. At batch 32 the GEMMs are small for 132 SMs: dx of
// upconv1 has 16 output tiles and K = 9216, and dW has 72 output tiles
// (1152 x 1024 and 2304 x 512) with K = 2048 and 8192 pixels. The bf16
// dx splits K into fp32 partials while its tiles leave SMs idle, and a
// second kernel sums them in a fixed order (deterministic, unlike
// atomics). The bf16 dW runs stream-K (csrc/igemm_sm90.cuh): every SM
// takes an equal share of the 72 tiles' K steps, and the last piece of
// a tile to finish sums its pieces in a fixed order, in the same launch;
// its workspace, (72 + 132) slots of 64 KB, stays in L2. The fp32
// kernels split K for about two blocks per SM (facegen_upconv_bwd_splits).
//
// Requirements, checked by the Python wrapper: contiguous NHWC tensors,
// Cin and Cout multiples of 8, 16-byte aligned pointers, fewer than
// 2^31 elements per tensor.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "igemm_sm90.cuh"

namespace {

struct Geom {
  int n, h, w, cin, cout;  // x is (n, h, w, cin); dy is (n, 2h, 2w, cout)
  int m;                   // input pixels n * h * w
  int c4;                  // collapsed columns 4 * cout
};

Geom make_geom(int n, int h, int w, int cin, int cout) {
  return Geom{n, h, w, cin, cout, n * h * w, 4 * cout};
}

__device__ __forceinline__ void pixel_of(int m, const Geom& g, int& b, int& i, int& j) {
  const int hw = g.h * g.w;
  b = m / hw;
  const int r = m - b * hw;
  i = r / g.w;
  j = r - i * g.w;
}

__device__ __forceinline__ bool inside(int y, int x, const Geom& g) {
  return y >= 0 && y < g.h && x >= 0 && x < g.w;
}

// Element offset of S2D(dy)[b, y, x, col] = dy[b, 2y+a, 2x+c, o], col = p*cout+o, p = 2a+c.
__device__ __forceinline__ long long s2d_offset(int b, int y, int x, int col, const Geom& g) {
  const int p = col / g.cout;
  const int o = col - p * g.cout;
  return (((long long)b * 2 * g.h + 2 * y + (p >> 1)) * (2 * g.w) + 2 * x + (p & 1)) * g.cout + o;
}

// K steps of depth `bk`: dx runs 9 taps x the (phase, cout) columns, dW the pixels.
__host__ __device__ __forceinline__ int dx_steps(const Geom& g, int bk) { return 9 * ((g.c4 + bk - 1) / bk); }
__host__ __device__ __forceinline__ int dw_steps(const Geom& g, int bk) { return (g.m + bk - 1) / bk; }

// K steps [begin, end) of split `s` out of `splits`.
__device__ __forceinline__ void split_range(int steps, int splits, int s, int& begin, int& end) {
  begin = (int)((long long)steps * s / splits);
  end = (int)((long long)steps * (s + 1) / splits);
}

// ---------------------------------------------------------------- bf16
// dx on the wgmma mainloop of csrc/igemm_sm90.cuh: rows the N*H*W input
// pixels, columns Cin, K steps of 64 (tap, phase, cout) columns. An A chunk
// is 8 channels of one dy pixel, read in space-to-depth order at (i - du,
// j - dv); B is wc's rows (tap, cin) read K-major by TMA, 64 collapsed
// columns of BN_DX input channels. With one split it writes bf16 dx; with
// more, fp32 partials ws[split][m][c].
constexpr int BN_DX = 128;

struct UpconvDx {
  static constexpr int TRANS_A = 0, TRANS_B = 0;
  static constexpr bool OWN_GATHER = false, STREAM_K = false;
  const __nv_bfloat16* a;  // dy
  __nv_bfloat16* dx;
  float* ws;
  Geom g;
  int m, n, steps, splits;  // the GEMM: rows, columns, K steps, K splits
  int h, w;                 // x's pixel grid (dy's, halved)
  int chunks;               // K steps per tap: ceil(4*Cout / 64)
  bool a_tma;               // tiles are boxes of whole rows, and 64 | 2*Cout

  // A by TMA: dy as (2*Cout [(b, o)], W, 2 [a], H, N), so S2D(dy)'s columns
  // a*2*Cout + (b*Cout + o) of a 64-column step lie in one a; tap (du, dv)
  // shifts the box by (-du, -dv), pixels past the border read as zero
  __device__ __forceinline__ void load_a(const CUtensorMap* map, uint32_t dst, uint32_t bar,
                                         int ks, int m0) const {
    const int tap = ks / chunks;
    const int col = (ks - tap * chunks) * igemm::BK, a = col / (2 * g.cout);
    int n0, i0;
    igemm::tile_origin(m0, g.h, g.w, n0, i0);
    igemm::tma_load_5d(dst, map, bar, col - a * 2 * g.cout, 1 - tap % 3, a, i0 + 1 - tap / 3,
                       n0);
  }

  // dy[b, 2i, 2j, 0], where S2D(dy)[b, i, j, 0] lies
  __device__ __forceinline__ int row_base(int row, int& i, int& j) const {
    int b;
    pixel_of(row, g, b, i, j);
    return ((b * 2 * g.h + 2 * i) * (2 * g.w) + 2 * j) * g.cout;
  }
  // step ks: tap (du, dv) reads S2D(dy) at (i - du, j - dv), columns
  // col = (ks % chunks) * 64 + chunk * 8 ..., col = p*Cout + o = dy's
  // channel o at (2y + p/2, 2x + p%2)
  __device__ __forceinline__ bool a_step(int ks, int chunk, int& delta, int& di, int& dj) const {
    const int tap = ks / chunks;
    const int col = (ks - tap * chunks) * igemm::BK + chunk * 8;
    di = 1 - tap / 3;
    dj = 1 - tap % 3;
    const int p = col / g.cout, o = col - p * g.cout;
    delta = ((2 * di + (p >> 1)) * (2 * g.w) + 2 * dj + (p & 1)) * g.cout + o;
    return col < g.c4;
  }

  __device__ __forceinline__ uint32_t b_bytes(int) const { return BN_DX * igemm::BK * 2; }
  __device__ __forceinline__ void load_b(const CUtensorMap* map, uint32_t dst, uint32_t bar,
                                         int ks, int n0) const {
    const int tap = ks / chunks;
    igemm::tma_load_3d(dst, map, bar, (ks - tap * chunks) * igemm::BK, n0, tap);
  }

  // the epilogue: fp32, then bf16 dx[row, col] (one split) or the fp32
  // partial ws[split][row][col]
  using Stage = float;
  using Stage2 = float2;
  __device__ __forceinline__ Stage2 stage2(int, float v0, float v1) const {
    return make_float2(v0, v1);
  }
  __device__ __forceinline__ long long row_offset(int row, int split) const {
    return ((long long)split * m + row) * g.cin;
  }
  __device__ __forceinline__ long long col_offset(int col) const { return col; }
  __device__ __forceinline__ void store8(long long off, const Stage* v) const {
    const float4 lo = reinterpret_cast<const float4*>(v)[0];
    const float4 hi = reinterpret_cast<const float4*>(v)[1];
    if (splits == 1) {
      __align__(16) __nv_bfloat162 o[4] = {
          __floats2bfloat162_rn(lo.x, lo.y), __floats2bfloat162_rn(lo.z, lo.w),
          __floats2bfloat162_rn(hi.x, hi.y), __floats2bfloat162_rn(hi.z, hi.w)};
      *reinterpret_cast<uint4*>(dx + off) = *reinterpret_cast<const uint4*>(o);
    } else {
      reinterpret_cast<float4*>(ws + off)[0] = lo;
      reinterpret_cast<float4*>(ws + off)[1] = hi;
    }
  }
};

// dW on the same mainloop: rows (tap, cin) of dWc, columns (phase, cout),
// K the N*H*W pixels in steps of 64. Both operands are MN-major: at one
// pixel, a 64-row slab of A is 64 channels of x at the slab's own tap
// (so a 128-row tile may hold two taps), and a 64-column slab of B is 64
// channels of one phase of S2D(dy). fp32 out, by the stream-K schedule
// (per-tile K splits with a second launch that sums them were 1.7x
// slower). 128 x 256 tiles were tried (less L2 traffic a product) and
// were no faster: their stream-K pieces are twice as many a tile, and the
// fixup costs what the loads save.
constexpr int BN_DW = 128;

struct UpconvDw {
  static constexpr int TRANS_A = 1, TRANS_B = 1;
  static constexpr bool OWN_GATHER = true, STREAM_K = true;
  static constexpr int SLAB = 64 * igemm::BK * 2;  // one [64 k][64] slab, 8 KB
  static constexpr int B_SLABS = BN_DW / 64;
  const __nv_bfloat16* x;
  const __nv_bfloat16* dy;
  float* dwc;
  float* ws;
  int* counters;
  Geom g;
  int m, n, steps;          // the GEMM: rows 9*Cin, columns 4*Cout, K steps
  bool a_tma;               // both operands by TMA: Cin, Cout % 64 == 0, 64 pixels whole rows
  int dj, di;               // a K step of 64 pixels in columns and rows: 64 % w, (64 / w) % h

  // A by TMA: the step's 64 pixels of x viewed (Cin, W, H, N) as a box
  // (64, W, rows, imgs), 64 channels from the slab's cin0, shifted by its
  // tap (du, dv): pixels past the border read as zero. A second slab past
  // the last row (9*Cin % 128 == 64) reads tap 9's box, never stored.
  __device__ __forceinline__ void load_a(const CUtensorMap* map, uint32_t dst, uint32_t bar,
                                         int ks, int m0) const {
    const int k0 = ks * igemm::BK, n0 = k0 / (g.h * g.w);
    const int i0 = (k0 - n0 * g.h * g.w) / g.w;
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      const int row = m0 + 64 * s, tap = row / g.cin;
      igemm::tma_load_4d(dst + s * SLAB, map, bar, row - tap * g.cin, tap % 3 - 1,
                         i0 + tap / 3 - 1, n0);
    }
  }
  // B by TMA: S2D(dy)'s columns col .. col+63 are channels o0 .. of phase
  // p = 2a + b; the step's 64 pixels are a box (64, 1, W, 1, 64 / W) of dy
  // viewed (Cout, 2 [b], W, 2 [a], N*H) at (o0, b, 0, a, image row k0 / W)
  __device__ __forceinline__ uint32_t b_bytes(int) const { return B_SLABS * SLAB; }
  __device__ __forceinline__ void load_b(const CUtensorMap* map, uint32_t dst, uint32_t bar,
                                         int ks, int n0) const {
    const int r0 = ks * (igemm::BK / g.w);
#pragma unroll
    for (int s = 0; s < B_SLABS; ++s) {
      const int col = n0 + 64 * s, p = col / g.cout;
      igemm::tma_load_5d(dst + s * SLAB, map, bar, col - p * g.cout, p & 1, 0, p >> 1, r0);
    }
  }

  // Gathers (every other shape): thread t copies chunk t % 8 (8 rows of A,
  // 8 columns of B, in each of their slabs) of K rows t / 8 + 16 q, q < 4,
  // 4 x (2 + B_SLABS) cp.async copies a step, zero past the border, past
  // the last pixel, row or column. The rows' pixels are decoded once per unit and carried
  // 64 pixels on at each step.
  struct Gather {
    int k[4], i[4], j[4];        // K row q's pixel: its index, row and column
    int a_off[2], du[2], dv[2];  // A slab s: x's offset from the pixel's, the tap
    int b_off[B_SLABS];          // B slab s: dy's offset from the pixel's 2x2 block; -1 past 4*Cout
  };
  __device__ __forceinline__ void gather_unit(Gather& st, const igemm::Unit& w, int t) const {
    const int c = t % 8, r0 = t / 8;
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      const int row = w.m0 + 64 * s + 8 * c;
      st.du[s] = 1 << 20;  // a row past the end: outside the grid at every step
      st.dv[s] = 0;
      st.a_off[s] = 0;
      if (row < m) {
        const int tap = row / g.cin;
        st.du[s] = tap / 3 - 1;
        st.dv[s] = tap % 3 - 1;
        st.a_off[s] = (st.du[s] * g.w + st.dv[s]) * g.cin + row - tap * g.cin;
      }
    }
#pragma unroll
    for (int s = 0; s < B_SLABS; ++s) {
      const int col = w.n0 + 64 * s + 8 * c, p = col / g.cout;
      st.b_off[s] = col < n ? ((p >> 1) * 2 * g.w + (p & 1)) * g.cout + col - p * g.cout : -1;
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      st.k[q] = w.k_begin * igemm::BK + r0 + 16 * q;
      const int r = st.k[q] % (g.h * g.w);
      st.i[q] = r / g.w;
      st.j[q] = r - st.i[q] * g.w;
    }
  }
  // S2D(dy)[b, i, j, col] = dy[(4k - 2j) * Cout + b_off] for pixel k = (b, i, j)
  __device__ __forceinline__ void gather_step(Gather& st, uint32_t dst, int t) const {
    const int c = t % 8, r0 = t / 8;
    const uint32_t off = r0 * 128 + ((c ^ (r0 % 8)) * 16);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const uint32_t row = dst + off + q * 16 * 128;
      const bool in = st.k[q] < g.m;
#pragma unroll
      for (int s = 0; s < 2; ++s) {
        const int y = st.i[q] + st.du[s], xx = st.j[q] + st.dv[s];
        const bool ok = in && y >= 0 && y < g.h && xx >= 0 && xx < g.w;
        igemm::cp_async16(row + s * SLAB, x + (ok ? st.k[q] * g.cin + st.a_off[s] : 0), ok);
      }
#pragma unroll
      for (int s = 0; s < B_SLABS; ++s) {
        const bool ok = in && st.b_off[s] >= 0;
        igemm::cp_async16(row + igemm::A_BYTES + s * SLAB,
                          dy + (ok ? (4 * st.k[q] - 2 * st.j[q]) * g.cout + st.b_off[s] : 0), ok);
      }
      st.k[q] += igemm::BK;
      st.j[q] += dj;
      if (st.j[q] >= g.w) {
        st.j[q] -= g.w;
        ++st.i[q];
      }
      st.i[q] += di;
      if (st.i[q] >= g.h) st.i[q] -= g.h;
    }
  }

  // the epilogue: fp32 dWc[row, col]
  using Stage = float;
  using Stage2 = float2;
  __device__ __forceinline__ Stage2 stage2(int, float v0, float v1) const {
    return make_float2(v0, v1);
  }
  __device__ __forceinline__ long long row_offset(int row, int) const { return (long long)row * n; }
  __device__ __forceinline__ long long col_offset(int col) const { return col; }
  __device__ __forceinline__ void store8(long long off, const Stage* v) const {
    reinterpret_cast<float4*>(dwc + off)[0] = reinterpret_cast<const float4*>(v)[0];
    reinterpret_cast<float4*>(dwc + off)[1] = reinterpret_cast<const float4*>(v)[1];
  }
};

// ---------------------------------------------------------------- fp32
// SIMT FMA, 64 x 64 x 16 tiles, 256 threads of 4 x 4, both operands
// stored K-major in shared memory; kept for tight checks.
constexpr int FBM = 64, FBN = 64, FBK = 16, FTHREADS = 256;

__device__ __forceinline__ void f32_mma(const float (&As)[FBK][FBM + 4],
                                                  const float (&Bs)[FBK][FBN + 4],
                                                  float (&acc)[4][4], int tx, int ty) {
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
}

__global__ void __launch_bounds__(FTHREADS)
upconv_dx_f32(const float* __restrict__ dy, const float* __restrict__ wc, float* __restrict__ dx,
              float* __restrict__ ws, Geom g, int splits) {
  __shared__ __align__(16) float As[FBK][FBM + 4];  // [k][pixel]
  __shared__ __align__(16) float Bs[FBK][FBN + 4];  // [k][cin]

  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int tiles_n = (g.cin + FBN - 1) / FBN;
  const int m0 = (blockIdx.x / tiles_n) * FBM;
  const int n0 = (blockIdx.x % tiles_n) * FBN;

  const int ar = tid / 4, q = tid % 4;  // row (pixel or cin) and quad of 4 K columns
  const bool a_ok = m0 + ar < g.m;
  int a_b, a_i, a_j;
  pixel_of(a_ok ? m0 + ar : 0, g, a_b, a_i, a_j);
  const bool b_ok = n0 + ar < g.cin;
  const int chunks = (g.c4 + FBK - 1) / FBK;

  int k_begin, k_end;
  split_range(dx_steps(g, FBK), splits, blockIdx.y, k_begin, k_end);
  float acc[4][4] = {};
  for (int kt = k_begin; kt < k_end; ++kt) {
    const int tap = kt / chunks;
    const int col = (kt - tap * chunks) * FBK + q * 4;
    const int y = a_i - (tap / 3 - 1), xx = a_j - (tap % 3 - 1);
    float4 av = make_float4(0.f, 0.f, 0.f, 0.f);
    if (a_ok && col < g.c4 && inside(y, xx, g))
      av = *reinterpret_cast<const float4*>(dy + s2d_offset(a_b, y, xx, col, g));
    As[q * 4 + 0][ar] = av.x;
    As[q * 4 + 1][ar] = av.y;
    As[q * 4 + 2][ar] = av.z;
    As[q * 4 + 3][ar] = av.w;
    float4 bv = make_float4(0.f, 0.f, 0.f, 0.f);
    if (b_ok && col < g.c4)
      bv = *reinterpret_cast<const float4*>(wc + ((long long)tap * g.cin + n0 + ar) * g.c4 + col);
    Bs[q * 4 + 0][ar] = bv.x;
    Bs[q * 4 + 1][ar] = bv.y;
    Bs[q * 4 + 2][ar] = bv.z;
    Bs[q * 4 + 3][ar] = bv.w;
    __syncthreads();
    f32_mma(As, Bs, acc, tx, ty);
    __syncthreads();
  }

  const int c = n0 + tx * 4;
  float* out = splits == 1 ? dx : ws + (long long)blockIdx.y * g.m * g.cin;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty * 4 + i;
    if (m < g.m && c < g.cin)
      *reinterpret_cast<float4*>(out + (long long)m * g.cin + c) =
          make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
  }
}

__global__ void __launch_bounds__(FTHREADS)
upconv_dw_f32(const float* __restrict__ x, const float* __restrict__ dy, float* __restrict__ dwc,
              float* __restrict__ ws, Geom g, int splits) {
  __shared__ __align__(16) float As[FBK][FBM + 4];  // [pixel][tap, cin]
  __shared__ __align__(16) float Bs[FBK][FBN + 4];  // [pixel][phase, cout]

  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int rows = 9 * g.cin;
  const int tiles_n = (g.c4 + FBN - 1) / FBN;
  const int m0 = (blockIdx.x / tiles_n) * FBM;
  const int n0 = (blockIdx.x % tiles_n) * FBN;

  const int kr = tid / 16, q = tid % 16;  // pixel row of the tile, quad of 4 rows / columns
  const int r = m0 + q * 4;
  const bool r_ok = r < rows;
  const int tap = r_ok ? r / g.cin : 0;
  const int c = r - tap * g.cin;
  const int du = tap / 3 - 1, dv = tap % 3 - 1;
  const int col = n0 + q * 4;
  const bool col_ok = col < g.c4;

  int k_begin, k_end;
  split_range(dw_steps(g, FBK), splits, blockIdx.y, k_begin, k_end);
  float acc[4][4] = {};
  for (int kt = k_begin; kt < k_end; ++kt) {
    const int m = kt * FBK + kr;
    const bool m_ok = m < g.m;
    int b, i, j;
    pixel_of(m_ok ? m : 0, g, b, i, j);
    const int y = i + du, xx = j + dv;
    float4 av = make_float4(0.f, 0.f, 0.f, 0.f);
    if (m_ok && r_ok && inside(y, xx, g))
      av = *reinterpret_cast<const float4*>(x + (((long long)b * g.h + y) * g.w + xx) * g.cin + c);
    *reinterpret_cast<float4*>(&As[kr][q * 4]) = av;
    float4 bv = make_float4(0.f, 0.f, 0.f, 0.f);
    if (m_ok && col_ok) bv = *reinterpret_cast<const float4*>(dy + s2d_offset(b, i, j, col, g));
    *reinterpret_cast<float4*>(&Bs[kr][q * 4]) = bv;
    __syncthreads();
    f32_mma(As, Bs, acc, tx, ty);
    __syncthreads();
  }

  const int cc = n0 + tx * 4;
  float* out = splits == 1 ? dwc : ws + (long long)blockIdx.y * rows * g.c4;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int rr = m0 + ty * 4 + i;
    if (rr < rows && cc < g.c4)
      *reinterpret_cast<float4*>(out + (long long)rr * g.c4 + cc) =
          make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
  }
}

// ---------------------------------------------------------------- split-K reduction
// out[e] = sum over splits of ws[s][e], summed in split order (the same
// result on every run), then stored as T. `total` is a multiple of 4.
__device__ __forceinline__ void store4(float* out, float4 v) { *reinterpret_cast<float4*>(out) = v; }
__device__ __forceinline__ void store4(__nv_bfloat16* out, float4 v) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y), hi = __floats2bfloat162_rn(v.z, v.w);
  reinterpret_cast<__nv_bfloat162*>(out)[0] = lo;
  reinterpret_cast<__nv_bfloat162*>(out)[1] = hi;
}

template <typename T>
__global__ void reduce_splits(const float* __restrict__ ws, T* __restrict__ out, long long total,
                              int splits) {
  const long long n4 = total / 4;
  for (long long e = blockIdx.x * (long long)blockDim.x + threadIdx.x; e < n4;
       e += (long long)gridDim.x * blockDim.x) {
    float4 acc = reinterpret_cast<const float4*>(ws)[e];
    for (int s = 1; s < splits; ++s) {
      const float4 v = reinterpret_cast<const float4*>(ws + s * total)[e];
      acc.x += v.x;
      acc.y += v.y;
      acc.z += v.z;
      acc.w += v.w;
    }
    store4(out + 4 * e, acc);
  }
}

template <typename T>
int launch_reduce(const float* ws, T* out, long long total, int splits, cudaStream_t stream) {
  const int threads = 256;
  const long long blocks = (total / 4 + threads - 1) / threads;
  reduce_splits<T><<<(int)(blocks < 4096 ? blocks : 4096), threads, 0, stream>>>(ws, out, total,
                                                                               splits);
  return static_cast<int>(cudaGetLastError());
}

int n_tiles(int rows, int cols, int bm, int bn) {
  return ((rows + bm - 1) / bm) * ((cols + bn - 1) / bn);
}

// Splits of K that give about two blocks per SM of the H100's 132, with
// at least 8 K steps per split and at most 16 splits.
int choose_splits(int tiles, int steps) {
  const int want = (264 + tiles - 1) / tiles;
  int cap = steps / 8;
  if (cap > 16) cap = 16;
  int s = want < cap ? want : cap;
  return s < 1 ? 1 : s;
}

}  // namespace

// Plain C entry points for ctypes. Each launches on `stream` and returns
// cudaGetLastError() (0 = cudaSuccess) after its last launch. `h`, `w`
// are x's spatial size; dy is (n, 2h, 2w, cout).

// K splits the dx (which = 0) or dW (which = 1) kernel of the given type
// (bf16 = 1, fp32 = 0) takes at this shape; the caller sizes the fp32
// workspace as splits x the output when splits > 1. 0: the bf16 dW, which
// runs stream-K with the buffers facegen_upconv_dw_sizes gives.
extern "C" int facegen_upconv_bwd_splits(int which, int bf16, int n, int h, int w, int cin,
                                         int cout) {
  const Geom g = make_geom(n, h, w, cin, cout);
  if (which == 0 && bf16) {
    // one block per SM: split K only while the tiles leave SMs idle
    const int tiles = n_tiles(g.m, g.cin, igemm::BM, BN_DX), sms = igemm::sm_count();
    const int steps = dx_steps(g, igemm::BK);
    int s = tiles < sms ? sms / tiles : 1;
    if (s > steps / 8) s = steps / 8;
    if (s > 16) s = 16;
    return s < 1 ? 1 : s;
  }
  if (bf16) return 0;
  if (which == 0) return choose_splits(n_tiles(g.m, g.cin, FBM, FBN), dx_steps(g, FBK));
  return choose_splits(n_tiles(9 * g.cin, g.c4, FBM, FBN), dw_steps(g, FBK));
}

// The fp32 workspace (elements) and the counters (ints, zero before the
// first launch; each launch leaves them zero) that the bf16 dW's stream-K
// takes: a 128 x 128 slot for each tile and each block, and a counter for
// each tile and consumer warpgroup.
extern "C" void facegen_upconv_dw_sizes(int n, int h, int w, int cin, int cout, long long* ws,
                                        long long* counters) {
  const Geom g = make_geom(n, h, w, cin, cout);
  const int tiles = n_tiles(9 * cin, g.c4, igemm::BM, BN_DW);
  const long long units = (long long)tiles * dw_steps(g, igemm::BK);
  const int grid = units < igemm::sm_count() ? (int)units : igemm::sm_count();
  *ws = (long long)(tiles + grid) * igemm::BM * BN_DW;
  *counters = (long long)igemm::CONSUMERS * tiles;
}

extern "C" int facegen_upconv_dx_bf16(const void* dy, const void* wc, void* dx, void* ws, int n,
                                      int h, int w, int cin, int cout, int splits, void* stream) {
  const Geom g = make_geom(n, h, w, cin, cout);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  CUtensorMap a_map = {}, b_map;
  cudaError_t err = igemm::weight_map(&b_map, wc, cin, g.c4, BN_DX);
  int rows, imgs;
  const bool a_tma = igemm::row_box(h, w, rows, imgs) && (2 * cout) % igemm::BK == 0;
  if (err == cudaSuccess && a_tma) {
    const cuuint64_t dims[5] = {(cuuint64_t)(2 * cout), (cuuint64_t)w, 2, (cuuint64_t)h,
                                (cuuint64_t)n};
    const cuuint32_t box[5] = {64, (cuuint32_t)w, 1, (cuuint32_t)rows, (cuuint32_t)imgs};
    err = igemm::dense_map(&a_map, dy, 5, dims, box);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  const int chunks = (g.c4 + igemm::BK - 1) / igemm::BK;
  const UpconvDx p{static_cast<const __nv_bfloat16*>(dy), static_cast<__nv_bfloat16*>(dx),
                   static_cast<float*>(ws), g, g.m, cin, 9 * chunks, splits, h, w, chunks, a_tma};
  err = igemm::launch<BN_DX>(a_map, b_map, p, st);
  if (err != cudaSuccess || splits == 1) return static_cast<int>(err);
  return launch_reduce(static_cast<const float*>(ws), static_cast<__nv_bfloat16*>(dx),
                       (long long)g.m * g.cin, splits, st);
}

extern "C" int facegen_upconv_dx_f32(const void* dy, const void* wc, void* dx, void* ws, int n,
                                     int h, int w, int cin, int cout, int splits, void* stream) {
  const Geom g = make_geom(n, h, w, cin, cout);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  upconv_dx_f32<<<dim3(n_tiles(g.m, g.cin, FBM, FBN), splits), FTHREADS, 0, st>>>(
      static_cast<const float*>(dy), static_cast<const float*>(wc), static_cast<float*>(dx),
      static_cast<float*>(ws), g, splits);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return static_cast<int>(err);
  return launch_reduce(static_cast<const float*>(ws), static_cast<float*>(dx),
                       (long long)g.m * g.cin, splits, st);
}

// Both operands by TMA where every tile of them is a box (G16's and G32's
// training shapes: Cin, Cout % 64 == 0, 64 pixels whole image rows), else
// by the gathers. ws and counters: facegen_upconv_dw_sizes.
extern "C" int facegen_upconv_dw_bf16(const void* x, const void* dy, void* dwc, void* ws,
                                      void* counters, int n, int h, int w, int cin, int cout,
                                      void* stream) {
  const Geom g = make_geom(n, h, w, cin, cout);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  CUtensorMap a_map = {}, b_map = {};
  int rows, imgs;
  const bool tma = cin % 64 == 0 && cout % 64 == 0 && igemm::row_box(h, w, rows, imgs, igemm::BK);
  cudaError_t err = cudaSuccess;
  if (tma) {
    const cuuint64_t a_dims[4] = {(cuuint64_t)g.cin, (cuuint64_t)g.w, (cuuint64_t)g.h,
                                  (cuuint64_t)g.n};
    const cuuint32_t a_box[4] = {64, (cuuint32_t)g.w, (cuuint32_t)rows, (cuuint32_t)imgs};
    const cuuint64_t b_dims[5] = {(cuuint64_t)g.cout, 2, (cuuint64_t)g.w, 2,
                                  (cuuint64_t)g.n * g.h};
    const cuuint32_t b_box[5] = {64, 1, (cuuint32_t)g.w, 1, (cuuint32_t)(igemm::BK / g.w)};
    err = igemm::dense_map(&a_map, x, 4, a_dims, a_box);
    if (err == cudaSuccess) err = igemm::dense_map(&b_map, dy, 5, b_dims, b_box);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  const UpconvDw p{static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(dy),
                   static_cast<float*>(dwc), static_cast<float*>(ws), static_cast<int*>(counters),
                   g, 9 * cin, g.c4, dw_steps(g, igemm::BK), tma, igemm::BK % w,
                   (igemm::BK / w) % h};
  return static_cast<int>(igemm::launch<BN_DW>(a_map, b_map, p, st));
}

extern "C" int facegen_upconv_dw_f32(const void* x, const void* dy, void* dwc, void* ws, int n,
                                     int h, int w, int cin, int cout, int splits, void* stream) {
  const Geom g = make_geom(n, h, w, cin, cout);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  upconv_dw_f32<<<dim3(n_tiles(9 * g.cin, g.c4, FBM, FBN), splits), FTHREADS, 0, st>>>(
      static_cast<const float*>(x), static_cast<const float*>(dy), static_cast<float*>(dwc),
      static_cast<float*>(ws), g, splits);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return static_cast<int>(err);
  return launch_reduce(static_cast<const float*>(ws), static_cast<float*>(dwc),
                       (long long)9 * g.cin * g.c4, splits, st);
}
