// Implicit-GEMM mainloop for Hopper (sm_90a) shared by the upsample-conv
// forward (csrc/upsample_conv.cu) and its input and weight gradients
// (csrc/upsample_conv_bwd.cu).
//
// C[m, n] = sum_k A[m, k] B[k, n] in fp32, bf16 operands. For the forward
// and dx, A is an NHWC activation read through shifted taps (zero at the
// image border), so no padded or im2col copy exists, and B is a 2-D tile
// of the collapsed weight wc, viewed 3-D as (4*Cout, Cin, 9 taps). A
// problem type P supplies the gather address of an A chunk, the TMA
// coordinates of the tiles and the epilogue's stores (the layout change
// of each op).
//
// Design. One block per SM walks the work units (output tiles of 128 x BN,
// times the K splits) in a persistent loop. Warpgroups 0 and 1 consume:
// each runs wgmma.mma_async m64nBNk16 on 64 of the tile's rows, operands
// read straight from shared memory, fp32 accumulators in registers.
// Warpgroup 2 produces: it fills a STAGES-deep ring of (A, B) tiles. B
// comes by TMA. A comes by TMA too where a 128-row tile is a box of whole
// image rows (every G16/G32 shape): one box per K step, shifted by the
// tap, whose pixels past the border TMA fills with zeros. Elsewhere (odd
// shapes) A comes by 16-byte cp.async gathers from all 128 producer
// threads, masked to zero at the border and past Cin or 4*Cout, written
// into the same 128-byte swizzle. mbarriers signal full stages (TMA's
// bytes; each gathering thread's copies through cp.async.mbarrier.arrive,
// so no producer thread waits on its own loads) and empty ones, so the
// producer loads the next tile while the consumers run a tile's epilogue:
// from the accumulator registers (whose layout the PTX ISA documents)
// through a padded tile in shared memory, then out in 16-byte stores, a
// row's chunks on neighbouring threads, with the op's layout change
// (depth-to-space for the forward).
//
// What bounds it (H100, PERF.md, tools/ablate_igemm.py): at the
// sampler's batch the products and barriers alone reach ~840 TFLOP/s;
// the loads' shared-memory traffic beside them, and an epilogue that is
// not overlapped, bring the forward to ~600. dW at batch 32 (~210 and
// ~340 TFLOP/s) is bound by its loads (x's per-tap boxes most), then by
// the stream-K fixup and the epilogue, not by the products.
//
// The weight gradient (dW) runs here too, with both operands MN-major
// (TRANS_A = 1) and a stream-K schedule (P::STREAM_K):
// the tiles' K steps, tile by tile, are cut into one even range per
// block, so every SM has the same work whatever the tile count. A block
// whose range covers a whole tile writes it; a piece of a tile goes to
// an fp32 workspace, and the tile's last piece to arrive (a per-tile
// counter) sums all its pieces in piece order and writes the tile: the
// same bits on every run, whoever arrives last (fixup below).
//
// Shared-memory layouts (128-byte swizzle: the 16-byte chunk c of a
// 128-byte row r sits at chunk c ^ (r % 8), on 1024-byte-aligned tiles):
//   A: K-major [128 rows][64 k] (TRANS_A = 0; forward, dx), wgmma
//      descriptor SBO 1024 B; or MN-major (TRANS_A = 1; dW): two slabs
//      [64 k][64 m], one per consumer warpgroup, described like one
//      MN-major B slab.
//   B: K-major [BN rows][64 k] (TRANS_B = 0; dx), or MN-major: BN/64
//      slabs of [64 k][64 n] (TRANS_B = 1; forward, dW), LBO 8 KB between
//      slabs, SBO 1024 B between 8-row groups.

#pragma once

#include <cuda.h>  // CUtensorMap and its enums; the encoder comes from the runtime
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace igemm {

constexpr int BM = 128;                    // tile rows: two consumer warpgroups of 64
constexpr int BK = 64;                     // K step: one 128-byte row of bf16
constexpr int CONSUMERS = 2;               // consumer warpgroups
constexpr int THREADS = 128 * (CONSUMERS + 1);
constexpr int A_BYTES = BM * BK * 2;       // 16 KB
constexpr uint32_t FULL_ARRIVALS = 128 + 1;          // producer threads + the TMA's expect_tx
constexpr uint32_t EMPTY_ARRIVALS = CONSUMERS * 4;   // one per consumer warp
constexpr int PRODUCER_REGS = 56, CONSUMER_REGS = 224;  // 64,512 of 65,536

// Shared memory: the ring of (A, B) stages, 1024-byte aligned; each
// consumer warpgroup's epilogue tile [64][BN + 8] of Stage (the 8-element
// pad spreads its rows over the banks) and the 64 output offsets of its
// rows; the 2 x STAGES mbarriers. STAGES: as many as fit in 227 KB.
template <int BN, class Stage>
struct Cfg {
  static_assert(BN == 128 || BN == 256, "wgmma tile width");
  static constexpr int B_BYTES = BK * BN * 2;
  static constexpr int STAGE_BYTES = A_BYTES + B_BYTES;  // a multiple of 1024
  static constexpr int OUT_LD = BN + 8;                  // epilogue tile row, elements
  static constexpr int OUT_BYTES = 64 * OUT_LD * static_cast<int>(sizeof(Stage));
  static constexpr int EPI_BYTES = CONSUMERS * (OUT_BYTES + 64 * 8);
  static constexpr int STAGES_FIT = (232448 - 1024 - EPI_BYTES - 2 * 8 * 8) / STAGE_BYTES;
  static constexpr int STAGES = STAGES_FIT < 8 ? STAGES_FIT : 8;
  static_assert(STAGES >= 3, "the ring needs three stages");
  static constexpr int SMEM = 1024 + STAGES * STAGE_BYTES + EPI_BYTES + 2 * STAGES * 8;
};

// ---------------------------------------------------------------- PTX helpers
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

// Wait until the phase of the given parity has completed. A wait that
// lasts ~10 s means a lost arrival: trap rather than hang the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      " selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  if (done) return;
  const long long start = clock64();
  do {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    if (!done && clock64() - start > 20000000000LL) __trap();
  } while (!done);
}

// 16-byte global -> shared copy; with ok false it writes 16 zero bytes
// and reads nothing (src-size 0).
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(ok ? 16 : 0) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The mbarrier receives one arrival when all of this thread's earlier
// cp.async copies have landed; it counts among the expected arrivals.
__device__ __forceinline__ void cp_async_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(bar) : "memory");
}

// Orders generic-proxy writes to shared memory that this thread has seen
// (cp.async) before its later async-proxy reads of them (wgmma).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// TMA: a box of a 3-D tensor map into shared memory; the mbarrier counts its bytes.
__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// The same for a 4-D and a 5-D tensor map (A's boxes of whole image rows).
__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}
__device__ __forceinline__ void tma_load_5d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2, int c3, int c4) {
  asm volatile(
      "cp.async.bulk.tensor.5d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6, %7}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3),
      "r"(c4)
      : "memory");
}

// wgmma shared-memory matrix descriptor, 128-byte swizzle (layout type 1).
// Offsets in bytes; the start address must lie in a 1024-byte-aligned tile.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
}

// Barrier `id` (1 or 2) for the 128 threads of one consumer warpgroup.
__device__ __forceinline__ void warpgroup_sync(int id) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(id) : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Ties the accumulators to this point of the program, so the compiler
// neither reads them before wgmma_wait nor writes them after wgmma_fence.
template <int R>
__device__ __forceinline__ void fence_operands(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// D (64 x N, fp32) += A (64 x 16) * B (16 x N); TRANS_A = 1 for an MN-major
// A, TRANS_B = 1 for an MN-major B. scale_d = 0 overwrites D instead.
template <int TRANS_A, int TRANS_B>
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t desc_a, uint64_t desc_b,
                                                 int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, %67, %68;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d), "n"(TRANS_A), "n"(TRANS_B));
}

template <int TRANS_A, int TRANS_B>
__device__ __forceinline__ void wgmma_m64n256k16(float (&d)[128], uint64_t desc_a, uint64_t desc_b,
                                                 int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, %131, %132;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d), "n"(TRANS_A), "n"(TRANS_B));
}


template <int BN, int TRANS_A, int TRANS_B>
__device__ __forceinline__ void wgmma_tile(float (&d)[BN / 2], uint64_t desc_a, uint64_t desc_b) {
  if constexpr (BN == 256) {
    wgmma_m64n256k16<TRANS_A, TRANS_B>(d, desc_a, desc_b, 1);
  } else {
    wgmma_m64n128k16<TRANS_A, TRANS_B>(d, desc_a, desc_b, 1);
  }
}

// ---------------------------------------------------------------- work units
// A block's units, in order: unit_at(first_pos(p), ...), then from w.next.
struct Unit {
  int m0, n0, k_begin, k_end, split;
  int tile;        // output tile (column tiles fastest, so blocks that run together share A rows in L2)
  long long next;  // the block's next position
};

template <int BN, class P>
__host__ __device__ __forceinline__ int n_tiles(const P& p) {
  return ((p.m + BM - 1) / BM) * ((p.n + BN - 1) / BN);
}

// Units to spread over the blocks: tiles x K splits, or (stream-K) every
// tile's K steps.
template <int BN, class P>
__host__ __device__ __forceinline__ long long n_units(const P& p) {
  if constexpr (P::STREAM_K)
    return static_cast<long long>(n_tiles<BN>(p)) * p.steps;
  else
    return static_cast<long long>(n_tiles<BN>(p)) * p.splits;
}

// Stream-K: block b takes tile-steps [b * total / grid, (b+1) * total / grid)
// of the tile-major order; the block whose range holds tile-step g:
template <int BN, class P>
__device__ __forceinline__ int block_of_step(long long g, const P& p) {
  return static_cast<int>(((g + 1) * gridDim.x - 1) / n_units<BN>(p));
}

template <int BN, class P>
__device__ __forceinline__ long long first_pos(const P& p) {
  if constexpr (P::STREAM_K)
    return n_units<BN>(p) * blockIdx.x / gridDim.x;
  else
    return blockIdx.x;
}

// The unit at position pos of this block's walk: unit pos = (tile pos /
// splits, K split pos % splits), the next one a grid further; or
// (stream-K) the piece of tile-step pos's tile from pos to the end of the
// tile or of the block's range. False past the block's last unit.
template <int BN, class P>
__device__ __forceinline__ bool unit_at(long long pos, const P& p, Unit& w) {
  const long long units = n_units<BN>(p);
  int tile;
  if constexpr (P::STREAM_K) {
    const long long hi = units * (blockIdx.x + 1) / gridDim.x;
    if (pos >= hi) return false;
    tile = static_cast<int>(pos / p.steps);
    w.k_begin = static_cast<int>(pos - static_cast<long long>(tile) * p.steps);
    w.k_end = hi - pos < p.steps - w.k_begin ? w.k_begin + static_cast<int>(hi - pos) : p.steps;
    w.split = 0;
    w.next = pos + (w.k_end - w.k_begin);
  } else {
    if (pos >= units) return false;
    const int u = static_cast<int>(pos);
    w.split = u % p.splits;
    tile = u / p.splits;
    w.k_begin = static_cast<int>(static_cast<long long>(p.steps) * w.split / p.splits);
    w.k_end = static_cast<int>(static_cast<long long>(p.steps) * (w.split + 1) / p.splits);
    w.next = pos + gridDim.x;
  }
  const int tiles_n = (p.n + BN - 1) / BN;
  w.tile = tile;
  w.m0 = (tile / tiles_n) * BM;
  w.n0 = (tile % tiles_n) * BN;
  return true;
}

// Stream-K fixup of a piece of a tile (a unit that is not the whole of
// its K range), by one consumer warpgroup for its 64 rows. The piece goes
// to workspace slot (tile + block): slots are unique, since a block's
// range follows the one before it. Each thread stores its accumulators
// in register order (float4 j of thread t at j * 128 + t: whole 512-byte
// lines a warp); after a barrier, thread 0 fences (a release of them all)
// and counts the piece in the tile's counter. The piece that makes the
// count whole is the last: it resets the counter for the next launch,
// then sums the tile's pieces in block order into acc and returns true;
// the others return false and write nothing more. The tile's first
// piece, which finds the count whole already, skips its store.
template <int BN, class P>
__device__ __forceinline__ bool fixup(const P& p, const Unit& w, float (&acc)[BN / 2], int wg,
                                      int t, volatile int* flag) {
  const long long steps = p.steps;
  const int first = block_of_step<BN>(w.tile * steps, p);
  const int last = block_of_step<BN>((w.tile + 1) * steps - 1, p);
  auto slot = [&](int b) {
    return reinterpret_cast<float4*>(p.ws) + (static_cast<long long>(w.tile + b) * CONSUMERS + wg) *
                                                 (64 * BN / 4);
  };
  int* counter = p.counters + w.tile * CONSUMERS + wg;
  bool done = false;
  if (first == static_cast<int>(blockIdx.x)) {
    // the tile's first piece ends its block's range, so it is usually the
    // last to finish: where every other piece has arrived, it neither
    // stores nor counts its own
    if (t == 0) {
      const bool others = *reinterpret_cast<volatile int*>(counter) == last - first;
      if (others) *counter = 0;
      __threadfence();
      *flag = others;
    }
    warpgroup_sync(1 + wg);
    done = *flag;
    warpgroup_sync(1 + wg);
  }
  if (!done) {
    float4* mine = slot(blockIdx.x);
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
      mine[j * 128 + t] = make_float4(acc[4 * j], acc[4 * j + 1], acc[4 * j + 2], acc[4 * j + 3]);
    warpgroup_sync(1 + wg);
    if (t == 0) {
      __threadfence();  // releases the warpgroup's stores, ordered before it by the barrier
      const bool last_in = atomicAdd(counter, 1) == last - first;
      if (last_in) *counter = 0;  // every piece has arrived
      __threadfence();
      *flag = last_in;
    }
    warpgroup_sync(1 + wg);
    done = *flag;
    warpgroup_sync(1 + wg);  // the flag is read before the epilogue reuses its memory
    if (!done) return false;
  }
  // acc = ((piece first + piece first+1) + ...): this block's own piece
  // from its registers where it is the first (the usual last arrival: a
  // tile's first piece ends its block's range), else from its slot
  if (first != static_cast<int>(blockIdx.x)) {
    const float4* part = slot(first);
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const float4 v = __ldcg(part + j * 128 + t);
      acc[4 * j] = v.x;
      acc[4 * j + 1] = v.y;
      acc[4 * j + 2] = v.z;
      acc[4 * j + 3] = v.w;
    }
  }
  for (int b = first + 1; b <= last; ++b) {
    const float4* part = slot(b);
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const float4 v = __ldcg(part + j * 128 + t);
      acc[4 * j] += v.x;
      acc[4 * j + 1] += v.y;
      acc[4 * j + 2] += v.z;
      acc[4 * j + 3] += v.w;
    }
  }
  return true;
}

// ---------------------------------------------------------------- the kernel
// P provides: m, n (GEMM rows and columns), steps (K steps of BK), splits
//   (K splits per tile; not with STREAM_K);
//   TRANS_B (1: B tile is MN-major);
//   a_tma: A comes by TMA, a box of 128 whole-row pixels per step through
//     load_a(map, dst, bar, step, m0) (one thread), its border and its
//     channels past the tensor zero-filled by TMA; else by the gathers:
//   a, h, w: A's tensor and the h x w pixel grid of its rows;
//   int row_base(row, i, j): the row's pixel (i, j) and its offset in a;
//   bool a_step(step, chunk, delta, di, dj): A[row, step*BK + chunk*8 ...]
//     are the 8 bf16 at a + row_base + delta when pixel (i+di, j+dj) lies
//     in the grid, else zero; false where the chunk lies past K;
//   uint32_t b_bytes(n0) and load_b(map, dst, bar, step, n0): the bytes of
//     the B tile at column n0, and its TMA copies (issued by one thread);
//   Stage (bf16 or float) and Stage2: the epilogue tile's element and pair;
//   Stage2 stage2(col, v0, v1): C[row, col..col+1] as staged (bias added);
//   long long row_offset(row, split) and col_offset(col): where column col
//     of a row lands in the output: at their sum;
//   store8(offset, const Stage* v): stores C[row, col..col+7] there;
//   TRANS_A (1: A tile is MN-major);
//   OWN_GATHER: without TMA, P gathers both operands itself, through
//     gather_unit(state, unit, t) once per unit and gather_step(state, dst,
//     t) once per K step in order (thread t's cp.async copies into the
//     stage at dst); else the gathers above fill A and TMA fills B;
//   STREAM_K: the stream-K schedule, whose pieces of tiles go through
//     float* ws ((tiles + grid) x 128 x BN) and int* counters (CONSUMERS
//     per tile, zero before the launch, left zero).
template <int BN, class P>
__global__ void __launch_bounds__(THREADS, 1)
igemm_sm90(const __grid_constant__ CUtensorMap a_map, const __grid_constant__ CUtensorMap b_map,
           const P p) {
  using Stage = typename P::Stage;
  using C = Cfg<BN, Stage>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring_ptr = smem_raw + (1024 - smem_u32(smem_raw) % 1024) % 1024;
  const uint32_t ring = smem_u32(ring_ptr);
  unsigned char* epi = ring_ptr + C::STAGES * C::STAGE_BYTES;
  const uint32_t bars = ring + C::STAGES * C::STAGE_BYTES + C::EPI_BYTES;
  auto full = [&](int s) { return bars + 8 * s; };
  auto empty = [&](int s) { return bars + 8 * (C::STAGES + s); };

  if (threadIdx.x == 0) {
    for (int s = 0; s < C::STAGES; ++s) {
      mbar_init(full(s), p.a_tma ? 1 : FULL_ARRIVALS);
      mbar_init(empty(s), EMPTY_ARRIVALS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128, t = threadIdx.x % 128;
  Unit w;
  if (wg == CONSUMERS) {
    // ------------------------------------------------------------ producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    if (p.a_tma) {  // one thread issues both operands' copies
      if (t == 0) {
        int it = 0;
        for (long long pos = first_pos<BN>(p); unit_at<BN>(pos, p, w); pos = w.next) {
          for (int ks = w.k_begin; ks < w.k_end; ++ks, ++it) {
            const int s = it % C::STAGES;
            mbar_wait(empty(s), ((it / C::STAGES) & 1) ^ 1);  // the first pass finds it free
            const uint32_t a_dst = ring + s * C::STAGE_BYTES;
            mbar_arrive_expect_tx(full(s), A_BYTES + p.b_bytes(w.n0));
            p.load_a(&a_map, a_dst, full(s), ks, w.m0);
            p.load_b(&b_map, a_dst + A_BYTES, full(s), ks, w.n0);
          }
        }
      }
      return;
    }
    if constexpr (P::OWN_GATHER) {  // both operands from P's gathers
      typename P::Gather state;
      int it = 0;
      for (long long pos = first_pos<BN>(p); unit_at<BN>(pos, p, w); pos = w.next) {
        p.gather_unit(state, w, t);
        for (int ks = w.k_begin; ks < w.k_end; ++ks, ++it) {
          const int s = it % C::STAGES;
          mbar_wait(empty(s), ((it / C::STAGES) & 1) ^ 1);  // the first pass finds it free
          if (t == 0) mbar_arrive(full(s));
          p.gather_step(state, ring + s * C::STAGE_BYTES, t);
          cp_async_arrive(full(s));
        }
      }
      cp_async_wait<0>();  // leave no copy in flight behind
    } else {
      // thread t copies chunk t % 8 of rows t / 8 + 16 i, i < 8: rows that
      // share r % 8, so one swizzled chunk offset serves all eight
      const int chunk = t % 8, r0 = t / 8;
      const uint32_t a_off = r0 * 128 + ((chunk ^ (r0 % 8)) * 16);
      int it = 0;  // K steps issued by this block, over all its units
      for (long long pos = first_pos<BN>(p); unit_at<BN>(pos, p, w); pos = w.next) {
        // the rows' pixels, decoded once per unit: A's offset and (i, j);
        // a row past the end gets i = -2^30, outside the grid at every step
        int base[8], pi[8], pj[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const int row = w.m0 + r0 + 16 * i;
          pi[i] = -(1 << 30);
          pj[i] = 0;
          base[i] = row < p.m ? p.row_base(row, pi[i], pj[i]) : 0;
        }
        for (int ks = w.k_begin; ks < w.k_end; ++ks, ++it) {
          const int s = it % C::STAGES;
          mbar_wait(empty(s), ((it / C::STAGES) & 1) ^ 1);  // the first pass finds it free
          const uint32_t a_dst = ring + s * C::STAGE_BYTES;
          if (t == 0) {
            mbar_arrive_expect_tx(full(s), p.b_bytes(w.n0));
            p.load_b(&b_map, a_dst + A_BYTES, full(s), ks, w.n0);
          }
          // this step's shift (di, dj) of the pixel and offset of the chunk
          int delta, di, dj;
          const bool k_ok = p.a_step(ks, chunk, delta, di, dj);
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            const int y = pi[i] + di, x = pj[i] + dj;
            const bool ok = k_ok && y >= 0 && y < p.h && x >= 0 && x < p.w;
            cp_async16(a_dst + a_off + i * 16 * 128, p.a + (ok ? base[i] + delta : 0), ok);
          }
          cp_async_arrive(full(s));
        }
      }
      cp_async_wait<0>();  // leave no copy in flight behind
    }
  } else {
    // ------------------------------------------------------------ consumers
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
    const int warp = t / 32, lane = t % 32;
    float acc[BN / 2];
    int it = 0;
    for (long long pos = first_pos<BN>(p); unit_at<BN>(pos, p, w); pos = w.next) {
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) acc[i] = 0.0f;
      fence_operands(acc);
      for (int ks = w.k_begin; ks < w.k_end; ++ks, ++it) {
        const int s = it % C::STAGES;
        mbar_wait(full(s), (it / C::STAGES) & 1);
        fence_proxy_async();  // the producer's cp.async wrote A in the generic proxy
        const uint32_t a_tile = ring + s * C::STAGE_BYTES + wg * 64 * 128;
        const uint32_t b_tile = ring + s * C::STAGE_BYTES + A_BYTES;
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk) {
          // 16 k = 16 rows further (MN-major) or 32 bytes along each
          // 128-byte row (K-major)
          const uint64_t da = P::TRANS_A ? sw128_desc(a_tile + kk * 16 * 128, BK * 128, 1024)
                                         : sw128_desc(a_tile + kk * 32, 16, 1024);
          const uint64_t db = P::TRANS_B ? sw128_desc(b_tile + kk * 16 * 128, BK * 128, 1024)
                                         : sw128_desc(b_tile + kk * 32, 16, 1024);
          wgmma_tile<BN, P::TRANS_A, P::TRANS_B>(acc, da, db);
        }
        wgmma_commit();
        // keep one step's products in flight; the step before is done
        // reading its stage, which goes back to the producer
        wgmma_wait<1>();
        if (ks > w.k_begin && lane == 0) mbar_arrive(empty((it - 1) % C::STAGES));
      }
      wgmma_wait<0>();
      fence_operands(acc);
      if (w.k_end > w.k_begin && lane == 0) mbar_arrive(empty((it - 1) % C::STAGES));

      unsigned char* mine = epi + wg * (C::OUT_BYTES + 64 * 8);
      Stage* tile = reinterpret_cast<Stage*>(mine);
      long long* roff = reinterpret_cast<long long*>(mine + C::OUT_BYTES);
      if constexpr (P::STREAM_K) {  // a piece of a tile: only the tile's last piece goes on
        if ((w.k_begin > 0 || w.k_end < p.steps) &&
            !fixup<BN>(p, w, acc, wg, t, reinterpret_cast<volatile int*>(roff)))
          continue;
      }

      // Epilogue. Thread (warp, lane) holds rows warp*16 + lane/4 (+8) of
      // its warpgroup's 64, columns 8j + 2*(lane%4) (+1): acc[4j + 2h +
      // {0, 1}] for row half h. They go to the warpgroup's tile in shared
      // memory, then out in 8-column chunks (16 bytes of bf16), a row's
      // chunks on neighbouring threads.
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = warp * 16 + lane / 4 + 8 * h;
#pragma unroll
        for (int j = 0; j < BN / 8; ++j) {
          const int c = 8 * j + 2 * (lane % 4);
          *reinterpret_cast<typename P::Stage2*>(tile + r * C::OUT_LD + c) =
              p.stage2(w.n0 + c, acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
        }
      }
      if (t < 64) {
        const int row = w.m0 + wg * 64 + t;
        roff[t] = row < p.m ? p.row_offset(row, w.split) : -1;
      }
      warpgroup_sync(1 + wg);
      // BN / 8 chunks a row, a divisor of 128: a thread keeps its column
      constexpr int CHUNKS = BN / 8, ROWS = 128 / CHUNKS;
      const int c = (t % CHUNKS) * 8, col = w.n0 + c;
      if (col < p.n) {
        const long long coff = p.col_offset(col);
#pragma unroll 4
        for (int r = t / CHUNKS; r < 64; r += ROWS)
          if (roff[r] >= 0) p.store8(roff[r] + coff, tile + r * C::OUT_LD + c);
      }
      warpgroup_sync(1 + wg);  // the tile is free for the next unit
    }
  }
}

// ---------------------------------------------------------------- host side
inline int sm_count() {
  static int count = 0;
  if (count == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, dev);
    if (count <= 0) count = 132;
  }
  return count;
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline EncodeTiled encoder() {
  static EncodeTiled encode = nullptr;
  if (encode == nullptr) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &found) ==
            cudaSuccess &&
        found == cudaDriverEntryPointSuccess)
      encode = reinterpret_cast<EncodeTiled>(fn);
  }
  return encode;
}

// A bf16 tensor map of `rank` dims (innermost first: sizes dims, the byte
// strides of dims 1.. derived from the sizes, so the tensor is dense)
// with boxes `box` and 128-byte swizzle; elements outside the tensor read
// as zero. cuTensorMapEncodeTiled comes through the runtime's driver
// entry point, so the library needs no -lcuda.
inline cudaError_t dense_map(CUtensorMap* map, const void* ptr, int rank, const cuuint64_t* dims,
                             const cuuint32_t* box) {
  const EncodeTiled encode = encoder();
  if (encode == nullptr) return cudaErrorNotSupported;
  cuuint64_t strides[4];
  cuuint64_t stride = 2;
  for (int d = 0; d + 1 < rank; ++d) strides[d] = stride *= dims[d];
  const cuuint32_t elem[5] = {1, 1, 1, 1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank, const_cast<void*>(ptr),
                            dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// The collapsed weight wc (9*cin, nc) row-major as (nc, cin, 9), boxes of
// (64, box1, 1).
inline cudaError_t weight_map(CUtensorMap* map, const void* wc, int cin, int nc, int box1) {
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(nc), static_cast<cuuint64_t>(cin), 9};
  const cuuint32_t box[3] = {64, static_cast<cuuint32_t>(box1), 1};
  return dense_map(map, wc, 3, dims, box);
}

// How a run of `pixels` pixels (a 128-row tile; dW's 64-pixel K step) of
// an h x w pixel grid is a box of whole rows: rows `rows` of images `imgs`
// (pixels = w * rows * imgs); false where it is not.
inline bool row_box(int h, int w, int& rows, int& imgs, int pixels = BM) {
  if (h * w >= pixels) {
    if (pixels % w || h % (pixels / w)) return false;
    rows = pixels / w;
    imgs = 1;
  } else {
    if (pixels % (h * w)) return false;
    rows = h;
    imgs = pixels / (h * w);
  }
  return true;
}

// Tile m0's first pixel (image n0, row i0) of an h x w grid, where
// row_box holds.
__device__ __forceinline__ void tile_origin(int m0, int h, int w, int& n0, int& i0) {
  n0 = m0 / (h * w);
  i0 = (m0 - n0 * h * w) / w;
}

// Launches one block per SM (fewer if there are fewer units) on `stream`;
// returns cudaGetLastError().
template <int BN, class P>
cudaError_t launch(const CUtensorMap& a_map, const CUtensorMap& b_map, const P& p,
                   cudaStream_t stream) {
  using C = Cfg<BN, typename P::Stage>;
  // more than the 48 KB of shared memory a launch gets without asking,
  // raised once per device (the training path launches ~6 times a step)
  static unsigned long long raised = 0;
  int dev = 0;
  cudaGetDevice(&dev);
  if (!((raised >> dev) & 1)) {
    const cudaError_t err = cudaFuncSetAttribute(
        igemm_sm90<BN, P>, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
    if (err != cudaSuccess) return err;
    raised |= 1ull << dev;
  }
  const long long units = n_units<BN>(p);
  const int grid = units < sm_count() ? static_cast<int>(units) : sm_count();
  igemm_sm90<BN, P><<<grid, THREADS, C::SMEM, stream>>>(a_map, b_map, p);
  return cudaGetLastError();
}

}  // namespace igemm
