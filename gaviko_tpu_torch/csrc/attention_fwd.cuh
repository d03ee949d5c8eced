// Online-softmax attention forward, shared by kernel A (csrc/fused_mhsa.cu,
// the packed-qkv MHSA) and kernel B10 (csrc/flash_attention.cu, plain
// attention on [B, H, N, D]): one kernel template and its host launcher.
//
// Replaces the body the two TPU kernels share,
// gaviko_tpu/ops/flash_attention.py:_fused_mhsa_kernel and
// _attn_whole_kernel / _attn_stream_kernel: a CTA takes one (batch, head)
// plane's query rows and walks the keys in tiles with an online softmax (m
// and l carried across tiles, the output rescaled by exp2(m_old - m_new)),
// so the whole-K dot and the 512-key streaming loop of the TPU kernels are
// two tilings of this one function.
//
// The function and its rounding points: q * q_mult is rounded to the input
// dtype once (A passes scale * log2(e); B10 passes 1 and multiplies the f32
// scores by s_mult = scale * log2(e) instead), scores are f32 and keys >=
// n_keys are -inf, p = exp2(s - m), the row sum l is taken in f32 from the
// unrounded p before dropout, p is rounded to the input dtype for P V, and
// out = o * drop_scale / l is rounded once. Dropout (A only, csrc/common.cuh)
// drops element (query row r, key j) of plane salt = b * heads + h unless
// keep_bit(r, j, salt, seed); no bit is computed at rate 0 (threshold
// INT32_MIN). With lse != nullptr each row's m + log2(l) is written for the
// backward (csrc/fused_mhsa_bwd.cu).
//
// What bounds it on the H100: at the shipped shapes both products are
// compute: 4 * n^2 * D flops a plane against ~4 n D elements of q, k, v and
// o, so S = Q K^T and O = P V must run on the tensor cores and the K and V
// tiles must arrive while they run. At head dim 64 the exponentials come
// next: 64 x 128 of them a tile take the SM's 16 ex2 a clock as long as
// the tile's products take its tensor cores. The design:
//
// - Every operand is a [B, H, rows, D] view (A's are the head views of the
//   packed qkv, read in place) with a rank-4 TMA descriptor, encoded on the
//   host in the C entry point (cuTensorMapEncodeTiled through
//   cudaGetDriverEntryPoint, so no -lcuda) and passed as a __grid_constant__
//   parameter. D is cut into chunks of 128 bytes (64 bf16 or 32 f32
//   columns), the 128-byte swizzle span: a chunk tile is rows x 128 bytes,
//   swizzled, which is what wgmma reads without bank conflicts and what
//   makes the f32 fragment loads below conflict-free. Rows and columns past
//   the view's extent arrive as zeros, so keys >= n_keys cost no mask on
//   load (their scores are set to -inf) and a head dim that is not a
//   multiple of the chunk needs no copy.
// - A CTA is consumer warps (16 query rows each) plus one producer warp.
//   The producer's one thread loads the CTA's Q chunks once, then streams
//   the K chunks and the V chunks of each key tile through a ring of
//   STAGES chunk tiles with full and empty mbarriers, while the consumers
//   compute. A's q * q_mult is applied to Q in shared memory before the
//   first product.
// - bf16: one warpgroup (64 rows) on wgmma. S = Q K^T is
//   wgmma.m64nBKVk16 with Q and K from shared memory (both K-major as
//   stored); O += P V is wgmma.m64n64k16 a V chunk, with P from registers
//   (the accumulator layout of S is the A-fragment layout: row 16 * warp +
//   g (+8), columns 8 j + 2 t (+1), as in mma.sync, so A's dropout
//   coordinates are those of the old tile) and V read as stored, [keys, D],
//   through the transpose bit. 128 keys a tile up to 128 columns, 64 above
//   (the output takes 4 * 32 registers a thread at 256). Each product is
//   waited for before the softmax or the next chunk: the overlap of one
//   tile's P V with the next tile's S (no extra registers) measured slower
//   at 64 and 128 columns, as it cost a CTA an SM. The SM's other CTAs hide
//   the waits instead: three CTAs of the 64-column tile and two of the
//   128-column one fit (registers capped by __launch_bounds__).
// - f32: four warps (two in the general instance) on mma.sync m16n8k8 in
//   TF32, each product as three (hi * hi + hi * lo + lo * hi, hi =
//   tf32(x), lo = tf32(x - hi)), which keeps ~f32 accuracy. The P V product
//   reads P straight from S's accumulator registers: the k positions t and
//   t + 4 of its A fragment are taken to be keys 2 t and 2 t + 1 of each
//   group of 8, and V's B fragment is read for the same keys. Fragments
//   are read from the swizzled chunk tiles with 4-byte loads that hit 32
//   distinct banks a warp.
// - Head dims up to 256 in bf16 (128 in f32, whose P V also holds P's TF32
//   halves) are compile-time instances of one output slice (1 to 4 groups
//   of 64 columns). Wider ones take the general instance, which splits the
//   output over the grid into slices of at most that width; each CTA walks
//   all of D's chunks for S (recomputed once a slice) and accumulates its
//   slice's V chunks; slice 0 writes the lse. Dropout bits depend only on
//   (row, key, plane), so every slice replays the same mask. Where 64
//   rows of Q do not fit beside the ring (f32 above 512 columns), the f32
//   general instance takes 32 query rows a CTA.
// No atomics, and every sum runs in a fixed order, so a rerun is bit-equal.
#pragma once

#include <cuda.h>  // CUtensorMap and its enums (types only: nothing links libcuda)

#include <atomic>
#include <cstdint>

#include "common.cuh"

namespace gaviko {
namespace attn {
// Internal linkage: each kernel library that includes this header keeps its
// own kernels and host state (a function-local static of a template with
// external linkage is one object per process, shared by both libraries).
namespace {

constexpr int ROW_BYTES = 128;    // a chunk tile's row: one swizzle span
constexpr int RING_BYTES = 65536;  // the K / V ring: chunk tiles in flight

// Groups of 64 output columns a CTA accumulates at most: 4 in bf16; 2 in
// f32, whose P V holds P's TF32 halves beside the output (3 and 4 groups
// spill).
template <typename T>
constexpr int max_groups() {
  return is_bf16<T>() ? 4 : 2;
}
constexpr int SMEM_LIMIT = 232448;
constexpr float LOG2E = 1.4426950408889634f;

// ------------------------------------------------------------ PTX ----

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// Until the phase of parity `parity` has completed (a fresh barrier counts
// its phase of parity 1 as completed).
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  }
}

// A box of a rank-4 tensor map (coordinates innermost first) into shared
// memory; completion is counted in bytes on `bar`.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, int c0, int c1,
                                         int c2, int c3, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(c3),
      "r"(smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Pins accumulator registers at this point of the program, so the compiler
// moves no access to them across an asynchronous wgmma's issue or wait.
template <int N>
__device__ __forceinline__ void pin(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}


// wgmma shared-memory descriptor of a 128-byte-swizzled tile (rows of 128
// bytes, groups of 8 rows 1024 bytes apart) starting at p.
__device__ __forceinline__ uint64_t sw128_desc(const void* p, uint32_t lbo) {
  return static_cast<uint64_t>((smem_u32(p) & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) | (static_cast<uint64_t>(1024 >> 4) << 32) |
         (1ull << 62);
}

// d (64 x N, f32) (+)= A (64 x 16) B^T with A and B bf16 in shared memory,
// both K-major (descriptors a, b); scale_d 0 overwrites d.
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t a, uint64_t b,
                                              int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t a, uint64_t b,
                                              int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4],
                                             uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}


// 2^x (ex2.approx: ~2 ulp; 2^-inf = 0).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// TF32 of x (round to nearest, ties away) as its bit pattern.
__device__ __forceinline__ uint32_t tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// x = hi + lo to ~2^-22 relative, both TF32.
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32(x);
  lo = tf32(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float* c, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += a b in 3xTF32: the two small cross terms first, then hi * hi.
__device__ __forceinline__ void mma3(float* c, const uint32_t* ah, const uint32_t* al,
                                     uint32_t bh0, uint32_t bh1, uint32_t bl0, uint32_t bl1) {
  mma_tf32(c, al, bh0, bh1);
  mma_tf32(c, ah, bl0, bl1);
  mma_tf32(c, ah, bh0, bh1);
}

// f32 element (row r, column c) of a 128-byte-swizzled chunk tile.
__device__ __forceinline__ float lds_sw(const char* tile, int r, int c) {
  return *reinterpret_cast<const float*>(tile + r * ROW_BYTES +
                                         ((((c >> 2) ^ (r & 7)) << 4) | ((c & 3) << 2)));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<uint32_t*>(p) = pack_bf16(a, b);
}
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

// --------------------------------------------------------- kernel ----

struct Params {
  int pos[3][3];  // q, k, v: the tensor-map dimension (1..3) of rows, heads, batch
  int n_rows;     // query rows < n_rows are written
  int n_keys;     // keys < n_keys are attended
  int d;          // head dim: output columns < d are written
  int nck;        // chunks of S = Q K^T: D in chunks of 128 bytes
  int slice_chunks, n_slices;  // chunks of an output slice (the last may hold fewer)
  int heads;
  float q_mult, s_mult;
  uint32_t seed;
  int32_t threshold;  // INT32_MIN: no dropout
  float drop_scale;   // 1 / (1 - rate)
  void* o;            // [B, H, n_rows, d] with the element strides below
  long long o_b, o_h, o_n;
  float* lse;  // plane (b, h) at lse + b * lse_b + h * lse_h, or nullptr
  long long lse_b, lse_h;
};

// G groups of 64 output columns a CTA accumulates; GENERAL: D at run time,
// S over all of it and the output in slices (blockIdx.x % n_slices). ROWS
// query rows a CTA: 64, or 32 where 64 rows of Q do not fit (f32 only:
// wgmma takes 64).
template <typename T, int G, bool GENERAL, int R = 64>
struct Fwd {
  static constexpr int ROWS = R;
  static_assert(G >= 1 && G <= max_groups<T>(), "a slice the accumulators hold");
  static constexpr bool kBf16 = is_bf16<T>();
  static constexpr int CW = ROW_BYTES / static_cast<int>(sizeof(T));  // columns a chunk
  static constexpr int NS = G * 64 / CW;          // output chunks a CTA, at most
  static constexpr int CONSUMERS = ROWS / 16;     // consumer warps
  static constexpr int THREADS = 32 * (CONSUMERS + 1);  // and the producer warp
  // Keys a tile: what the accumulators leave room for (f32 holds P's TF32
  // halves beside the output).
  static constexpr int BKV = kBf16 && G <= 2 ? 128 : 64;
  // CTAs an SM must hold, which caps the registers: three of the 1-group
  // bf16 tile, two of the 2- and 3-group ones and of every 64-row f32 one,
  // none of the 4-group and general bf16 ones, which spill under a cap
  // (measured fastest on the H100 at the shapes of chip_smoke.py).
  static constexpr int MIN_BLOCKS =
      kBf16 ? (GENERAL || G == 4 ? 1 : G == 1 ? 3 : 2) : (ROWS == 64 ? 2 : 1);
  static_assert(ROWS == 64 || (!kBf16 && GENERAL), "32-row CTAs: the f32 general instance");
  static constexpr int Q_TILE = ROWS * ROW_BYTES;  // bytes of a Q chunk tile
  static constexpr int KV_TILE = BKV * ROW_BYTES;  // bytes of a K or V chunk tile (a stage)
  static constexpr int STAGES = RING_BYTES / KV_TILE;  // stages of the ring
  static constexpr int SJ = BKV / 8;               // groups of 8 keys in S
  static constexpr int OJ = CW / 8;                // groups of 8 columns in an output chunk

  static size_t smem_bytes(int nck) {
    return 1024 + static_cast<size_t>(nck) * Q_TILE + RING_BYTES +
           (2 * STAGES + 1) * sizeof(uint64_t);
  }

  static __device__ __forceinline__ void load(char* dst, const CUtensorMap* map, const int* pos,
                                              int col, int row, int h, int b, uint64_t* bar) {
    const int c1 = pos[0] == 1 ? row : pos[1] == 1 ? h : b;
    const int c2 = pos[0] == 2 ? row : pos[1] == 2 ? h : b;
    const int c3 = pos[0] == 3 ? row : pos[1] == 3 ? h : b;
    tma_load(dst, map, col, c1, c2, c3, bar);
  }

  static __device__ void run(const CUtensorMap* tq, const CUtensorMap* tk, const CUtensorMap* tv,
                             const Params& p) {
    extern __shared__ char smem_raw[];
    char* smem = reinterpret_cast<char*>((reinterpret_cast<uintptr_t>(smem_raw) + 1023) &
                                         ~static_cast<uintptr_t>(1023));
    const int nck = GENERAL ? p.nck : NS;
    char* qs = smem;                 // nck Q chunk tiles
    char* ring = qs + nck * Q_TILE;  // STAGES K / V chunk tiles
    uint64_t* q_full = reinterpret_cast<uint64_t*>(ring + RING_BYTES);
    uint64_t* full = q_full + 1;
    uint64_t* empty = full + STAGES;
    const int slice = GENERAL ? blockIdx.x % p.n_slices : 0;
    const int q0 = (GENERAL ? blockIdx.x / p.n_slices : blockIdx.x) * ROWS;
    const int h = blockIdx.y, b = blockIdx.z;
    const int c0 = slice * p.slice_chunks;  // the slice's first output chunk
    const int ns = GENERAL ? min(p.slice_chunks, nck - c0) : NS;
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

    if (threadIdx.x == 0) {
      mbar_init(q_full, 1);
      for (int s = 0; s < STAGES; ++s) {
        mbar_init(&full[s], 1);
        mbar_init(&empty[s], CONSUMERS);
      }
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();

    if (warp == CONSUMERS) {  // the producer
      if (lane == 0) {
        mbar_expect_tx(q_full, nck * Q_TILE);
        for (int c = 0; c < nck; ++c)
          load(qs + c * Q_TILE, tq, p.pos[0], c * CW, q0, h, b, q_full);
        uint32_t it = 0;  // ring items issued
        for (int k0 = 0; k0 < p.n_keys; k0 += BKV) {
          for (int i = 0; i < nck + ns; ++i, ++it) {
            const int st = it % STAGES;
            mbar_wait(&empty[st], ((it / STAGES) & 1) ^ 1);
            mbar_expect_tx(&full[st], KV_TILE);
            if (i < nck)
              load(ring + st * KV_TILE, tk, p.pos[1], i * CW, k0, h, b, &full[st]);
            else
              load(ring + st * KV_TILE, tv, p.pos[2], (c0 + i - nck) * CW, k0, h, b, &full[st]);
          }
        }
      }
      return;
    }
    consume(p, qs, ring, q_full, full, empty, nck, ns, c0, slice, q0, h, b);
  }

  // The ring stage of item `it`, once its bytes have landed.
  static __device__ __forceinline__ int wait_full(uint64_t* full, uint32_t it) {
    const int st = it % STAGES;
    mbar_wait(&full[st], (it / STAGES) & 1);
    return st;
  }

  // Hands ring item `it` back to the producer: every consumer warp is done
  // with it.
  static __device__ __forceinline__ void release(uint64_t* empty, uint32_t it, int lane) {
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[it % STAGES]);
  }

  // s += this warp's rows of Q's chunk qt times the key chunk kt^T. bf16:
  // the warpgroup's wgmma, committed (the caller waits); f32: 3xTF32
  // mma.sync.
  static __device__ __forceinline__ void s_chunk(float (&s)[SJ * 4], const char* qt,
                                                 const char* kt, int wr, int g, int t) {
    if constexpr (kBf16) {
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint64_t da = sw128_desc(qt + kk * 32, 16), db = sw128_desc(kt + kk * 32, 16);
        if constexpr (BKV == 128)
          wgmma_ss_n128(s, da, db, 1);
        else
          wgmma_ss_n64(s, da, db, 1);
      }
      wgmma_commit();
    } else {
#pragma unroll
      for (int kk = 0; kk < CW / 8; ++kk) {
        uint32_t ah[4], al[4];
        split(lds_sw(qt, wr + g, kk * 8 + t), ah[0], al[0]);
        split(lds_sw(qt, wr + g + 8, kk * 8 + t), ah[1], al[1]);
        split(lds_sw(qt, wr + g, kk * 8 + t + 4), ah[2], al[2]);
        split(lds_sw(qt, wr + g + 8, kk * 8 + t + 4), ah[3], al[3]);
#pragma unroll
        for (int j = 0; j < SJ; ++j) {
          uint32_t bh0, bl0, bh1, bl1;
          split(lds_sw(kt, 8 * j + g, kk * 8 + t), bh0, bl0);
          split(lds_sw(kt, 8 * j + g, kk * 8 + t + 4), bh1, bl1);
          mma3(&s[4 * j], ah, al, bh0, bh1, bl0, bl1);
        }
      }
    }
  }

  static __device__ void consume(const Params& p, char* qs, const char* ring, uint64_t* q_full,
                                 uint64_t* full, uint64_t* empty, int nck, int ns, int c0,
                                 int slice, int q0, int h, int b) {
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const int g = lane / 4, t = lane % 4;  // fragment row group, thread in group
    const int wr = warp * 16;              // the warp's first row in the CTA
    const int r0 = q0 + wr + g;            // this thread's rows: r0 and r0 + 8

    mbar_wait(q_full, 0);
    if (p.q_mult != 1.0f) {  // q * q_mult rounded to T, in place (the swizzle is moot)
      for (int i = threadIdx.x; i < nck * Q_TILE / 16; i += CONSUMERS * 32) {
        uint4* ptr = reinterpret_cast<uint4*>(qs) + i;
        uint4 x = *ptr;
        if constexpr (kBf16) {
          __nv_bfloat162* e = reinterpret_cast<__nv_bfloat162*>(&x);
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            const float2 f = __bfloat1622float2(e[k]);
            e[k] = __floats2bfloat162_rn(f.x * p.q_mult, f.y * p.q_mult);
          }
        } else {
          float* e = reinterpret_cast<float*>(&x);
#pragma unroll
          for (int k = 0; k < 4; ++k) e[k] *= p.q_mult;
        }
        *ptr = x;
      }
      // Generic-proxy stores, then wgmma's async-proxy reads.
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      asm volatile("bar.sync 1, %0;\n" ::"n"(CONSUMERS * 32) : "memory");
    }

    float o[NS][OJ * 4];
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int i = 0; i < OJ * 4; ++i) o[j][i] = 0.0f;
    float m0 = -INFINITY, m1 = -INFINITY;  // rows r0 and r0 + 8
    float l0 = 0.0f, l1 = 0.0f;            // this thread's share of the row sums
    const bool dropping = p.threshold != INT32_MIN;
    uint32_t it = 0;  // ring items consumed
    float s[SJ * 4];

    for (int k0 = 0; k0 < p.n_keys; k0 += BKV) {
      // S = Q K^T over D's chunks.
#pragma unroll
      for (int i = 0; i < SJ * 4; ++i) s[i] = 0.0f;
      if constexpr (kBf16) {
#pragma unroll
        for (int c = 0; c < nck; ++c, ++it) {
          s_chunk(s, qs + c * Q_TILE, ring + wait_full(full, it) * KV_TILE, wr, g, t);
          wgmma_wait();
          pin(s);
          release(empty, it, lane);
        }
      } else {
#pragma unroll 1
        for (int c = 0; c < nck; ++c, ++it) {  // rolled: unrolled, f32 runs out of registers
          s_chunk(s, qs + c * Q_TILE, ring + wait_full(full, it) * KV_TILE, wr, g, t);
          release(empty, it, lane);
        }
      }

      // Mask the keys past n_keys (in the last tile), row max of the raw
      // scores over the 4 threads of a row (s_mult > 0 commutes with it),
      // rescale what was carried. m is in scaled (log2) units.
      if (k0 + BKV > p.n_keys) {
#pragma unroll
        for (int j = 0; j < SJ; ++j)
#pragma unroll
          for (int i = 0; i < 4; ++i)
            if (k0 + 8 * j + 2 * t + (i % 2) >= p.n_keys) s[4 * j + i] = -INFINITY;
      }
      float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
      for (int j = 0; j < SJ; ++j) {
        mx0 = fmaxf(mx0, fmaxf(s[4 * j], s[4 * j + 1]));
        mx1 = fmaxf(mx1, fmaxf(s[4 * j + 2], s[4 * j + 3]));
      }
#pragma unroll
      for (int off = 1; off < 4; off *= 2) {
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
      }
      const float mn0 = fmaxf(m0, mx0 * p.s_mult), mn1 = fmaxf(m1, mx1 * p.s_mult);
      const float al0 = ex2(m0 - mn0), al1 = ex2(m1 - mn1);  // 0 on the first tile
      m0 = mn0;
      m1 = mn1;
      l0 *= al0;
      l1 *= al1;
#pragma unroll
      for (int j = 0; j < NS; ++j)
#pragma unroll
        for (int n = 0; n < OJ; ++n) {
          o[j][4 * n] *= al0;
          o[j][4 * n + 1] *= al0;
          o[j][4 * n + 2] *= al1;
          o[j][4 * n + 3] *= al1;
        }

      // P = exp2(S s_mult - m), summed, then dropped. bf16: repacked as the
      // A fragments of P V; f32: left in s.
      uint32_t pa[kBf16 ? SJ / 2 : 1][4];
#pragma unroll
      for (int j = 0; j < SJ; ++j) {
        float* e = &s[4 * j];
        e[0] = ex2(fmaf(e[0], p.s_mult, -mn0));
        e[1] = ex2(fmaf(e[1], p.s_mult, -mn0));
        e[2] = ex2(fmaf(e[2], p.s_mult, -mn1));
        e[3] = ex2(fmaf(e[3], p.s_mult, -mn1));
        l0 += e[0] + e[1];
        l1 += e[2] + e[3];
        if (dropping) {
          const uint32_t col = k0 + 8 * j + 2 * t, ra = r0, salt = b * p.heads + h;
          if (!keep_bit(ra, col, salt, p.seed, p.threshold)) e[0] = 0.0f;
          if (!keep_bit(ra, col + 1, salt, p.seed, p.threshold)) e[1] = 0.0f;
          if (!keep_bit(ra + 8, col, salt, p.seed, p.threshold)) e[2] = 0.0f;
          if (!keep_bit(ra + 8, col + 1, salt, p.seed, p.threshold)) e[3] = 0.0f;
        }
        if constexpr (kBf16) {
          pa[j / 2][(j % 2) * 2] = pack_bf16(e[0], e[1]);
          pa[j / 2][(j % 2) * 2 + 1] = pack_bf16(e[2], e[3]);
        }
      }

      // O += P V over the slice's chunks.
#pragma unroll
      for (int j = 0; j < NS; ++j) {
        if (GENERAL && j >= ns) break;
        const char* vt = ring + wait_full(full, it) * KV_TILE;
        ++it;
        if constexpr (kBf16) {
          wgmma_fence();
#pragma unroll
          for (int ks = 0; ks < SJ / 2; ++ks)
            wgmma_rs_n64(o[j], pa[ks], sw128_desc(vt + ks * 16 * ROW_BYTES, 1024));
          wgmma_commit();
          wgmma_wait();
          pin(o[j]);
        } else {
#pragma unroll
          for (int ks = 0; ks < SJ; ++ks) {
            uint32_t ah[4], al[4];
            split(s[4 * ks], ah[0], al[0]);      // (row g, key 8 ks + 2 t)
            split(s[4 * ks + 2], ah[1], al[1]);  // (row g + 8, key 8 ks + 2 t)
            split(s[4 * ks + 1], ah[2], al[2]);  // (row g, key 8 ks + 2 t + 1)
            split(s[4 * ks + 3], ah[3], al[3]);  // (row g + 8, key 8 ks + 2 t + 1)
#pragma unroll
            for (int n = 0; n < OJ; ++n) {
              uint32_t bh0, bl0, bh1, bl1;
              split(lds_sw(vt, 8 * ks + 2 * t, 8 * n + g), bh0, bl0);
              split(lds_sw(vt, 8 * ks + 2 * t + 1, 8 * n + g), bh1, bl1);
              mma3(&o[j][4 * n], ah, al, bh0, bh1, bl0, bl1);
            }
          }
        }
        release(empty, it - 1, lane);
      }
    }

#pragma unroll
    for (int off = 1; off < 4; off *= 2) {
      l0 += __shfl_xor_sync(0xffffffffu, l0, off);
      l1 += __shfl_xor_sync(0xffffffffu, l1, off);
    }
    const float inv0 = p.drop_scale / l0, inv1 = p.drop_scale / l1;
    if (p.lse != nullptr && slice == 0 && t == 0) {
      float* lse = p.lse + b * p.lse_b + h * p.lse_h;
      if (r0 < p.n_rows) lse[r0] = m0 + log2f(l0);
      if (r0 + 8 < p.n_rows) lse[r0 + 8] = m1 + log2f(l1);
    }
    T* out = static_cast<T*>(p.o) + b * p.o_b + h * p.o_h;
#pragma unroll
    for (int j = 0; j < NS; ++j) {
      if (GENERAL && j >= ns) break;
#pragma unroll
      for (int n = 0; n < OJ; ++n) {
        const int col = (c0 + j) * CW + 8 * n + 2 * t;
        if (col >= p.d) continue;
        if (r0 < p.n_rows)
          store2(out + r0 * p.o_n + col, o[j][4 * n] * inv0, o[j][4 * n + 1] * inv0);
        if (r0 + 8 < p.n_rows)
          store2(out + (r0 + 8) * p.o_n + col, o[j][4 * n + 2] * inv1, o[j][4 * n + 3] * inv1);
      }
    }
  }
};

template <typename T, int G, bool GENERAL, int ROWS>
__global__ void __launch_bounds__(Fwd<T, G, GENERAL, ROWS>::THREADS,
                                  Fwd<T, G, GENERAL, ROWS>::MIN_BLOCKS)
    attention_fwd_kernel(const __grid_constant__ CUtensorMap tq,
                         const __grid_constant__ CUtensorMap tk,
                         const __grid_constant__ CUtensorMap tv,
                         const __grid_constant__ Params p) {
  Fwd<T, G, GENERAL, ROWS>::run(&tq, &tk, &tv, p);
}

// ----------------------------------------------------------- host ----

// A [B, H, rows, D] operand: element strides of batch, head and row; unit
// column stride.
struct View {
  const void* ptr;
  long long sb, sh, sn;
  int rows;
};

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// The driver's cuTensorMapEncodeTiled, found once through the runtime.
EncodeTiled encoder() {
  static const EncodeTiled fn = [] {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &f, 12000,
                                                             cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &f, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(f)
               : nullptr;
  }();
  return fn;
}

// The rank-4 tensor map of view x: dimension 0 the D columns (boxes of one
// chunk), then rows, heads and batch ordered by stride (a dimension of
// extent 1 last, at a stride of its own), boxes of box_rows rows. pos gets
// the map dimension of rows, heads and batch. 128-byte swizzle; what lies
// past an extent arrives as zeros.
template <typename T>
cudaError_t encode(CUtensorMap* map, int* pos, const View& x, int B, int H, int D,
                   int box_rows) {
  const EncodeTiled enc = encoder();
  if (enc == nullptr) return cudaErrorNotSupported;
  const long long es = sizeof(T);
  if (reinterpret_cast<uintptr_t>(x.ptr) % 16) return cudaErrorInvalidValue;
  const long long ext[3] = {x.rows, H, B}, st[3] = {x.sn, x.sh, x.sb};
  int order[3] = {0, 1, 2};
  auto before = [&](int a, int b) {
    return (ext[a] == 1) != (ext[b] == 1) ? ext[b] == 1 : st[a] < st[b];
  };
  for (int i = 1; i < 3; ++i)
    for (int j = i; j > 0 && before(order[j], order[j - 1]); --j) {
      const int tmp = order[j];
      order[j] = order[j - 1];
      order[j - 1] = tmp;
    }
  cuuint64_t dims[4] = {static_cast<cuuint64_t>(D)}, strides[3];
  cuuint32_t box[4] = {static_cast<cuuint32_t>(ROW_BYTES / es)}, unit[4] = {1, 1, 1, 1};
  long long reach = (D * es + 15) / 16 * 16;  // bytes a packed dimension would step
  for (int i = 0; i < 3; ++i) {
    const int d = order[i];
    const long long bytes = ext[d] == 1 ? reach : st[d] * es;
    if (bytes <= 0 || bytes % 16 || bytes >= (1LL << 40)) return cudaErrorInvalidValue;
    pos[d] = i + 1;
    dims[i + 1] = static_cast<cuuint64_t>(ext[d]);
    strides[i] = static_cast<cuuint64_t>(bytes);
    box[i + 1] = d == 0 ? static_cast<cuuint32_t>(box_rows) : 1;
    reach = bytes * ext[d];
  }
  const CUtensorMapDataType type =
      es == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
  const CUresult r = enc(map, type, 4, const_cast<void*>(x.ptr), dims, strides, box, unit,
                         CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                         CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <typename T, int G, bool GENERAL, int ROWS = 64>
cudaError_t launch(const View& q, const View& k, const View& v, Params& p, int B, int H,
                   cudaStream_t stream) {
  using F = Fwd<T, G, GENERAL, ROWS>;
  const size_t smem = F::smem_bytes(p.nck);
  if (smem > SMEM_LIMIT) return cudaErrorInvalidValue;
  CUtensorMap tq, tk, tv;
  cudaError_t err = encode<T>(&tq, p.pos[0], q, B, H, p.d, F::ROWS);
  if (err == cudaSuccess) err = encode<T>(&tk, p.pos[1], k, B, H, p.d, F::BKV);
  if (err == cudaSuccess) err = encode<T>(&tv, p.pos[2], v, B, H, p.d, F::BKV);
  // The opt-in to more than 48 KB of shared memory, once a device (it is a
  // host call of its own on every launch otherwise).
  static std::atomic<unsigned long long> opted{0};
  int dev = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  const unsigned long long bit = 1ull << (dev % 64);
  if (err == cudaSuccess && !(opted.load() & bit)) {
    err = cudaFuncSetAttribute(attention_fwd_kernel<T, G, GENERAL, ROWS>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_LIMIT);
    if (err == cudaSuccess) opted |= bit;
  }
  if (err != cudaSuccess) return err;
  const dim3 grid((p.n_rows + F::ROWS - 1) / F::ROWS * p.n_slices, H, B);
  attention_fwd_kernel<T, G, GENERAL, ROWS><<<grid, F::THREADS, smem, stream>>>(tq, tk, tv, p);
  return cudaGetLastError();
}

// out[b, h, r, :] = softmax over keys < n_keys of the scores of query row r
// (as the header says) times v, for every row r < q.rows of q, into o (the
// element strides o_b, o_h, o_n); lse (or nullptr) gets m + log2(l) of each
// row at lse + b * lse_b + h * lse_h + r. The tile runs as plan says (the
// wrapper's ops/flash_attention.py:attention_plan, the one place the plan is
// made): plan[0] groups of 64 output columns a CTA accumulates, plan[1] the
// general instance (D at run time, S over all of it) or a compile-time one
// (one slice of plan[0] * 64 columns), plan[2] chunks of D an output slice,
// plan[3] query rows a CTA. A plan this header has no instance for, or one
// whose slice exceeds its accumulators, returns cudaErrorInvalidValue.
template <typename T>
int forward(const View& q, const View& k, const View& v, T* o, long long o_b, long long o_h,
            long long o_n, float* lse, long long lse_b, long long lse_h, int B, int H, int D,
            int n_keys, const int* plan, float q_mult, float s_mult, uint32_t seed,
            int32_t threshold, float drop_scale, void* stream) {
  constexpr int CW = ROW_BYTES / static_cast<int>(sizeof(T)), MAXG = max_groups<T>();
  const int groups = plan[0], slice_chunks = plan[2], rows = plan[3];
  const bool general = plan[1] != 0;
  Params p{};
  p.nck = general ? (D + CW - 1) / CW : groups * 64 / CW;
  if (B < 1 || H < 1 || D < 1 || q.rows < 1 || n_keys < 1 || n_keys > k.rows ||
      k.rows != v.rows || D % 2 || groups < 1 || groups > MAXG || slice_chunks < 1 ||
      slice_chunks * CW > groups * 64 || (!general && (D > groups * 64 || slice_chunks != p.nck)))
    return static_cast<int>(cudaErrorInvalidValue);
  p.n_rows = q.rows;
  p.n_keys = n_keys;
  p.d = D;
  p.slice_chunks = slice_chunks;
  p.n_slices = (p.nck + slice_chunks - 1) / slice_chunks;
  p.heads = H;
  p.q_mult = q_mult;
  p.s_mult = s_mult;
  p.seed = seed;
  p.threshold = threshold;
  p.drop_scale = drop_scale;
  p.o = o;
  p.o_b = o_b;
  p.o_h = o_h;
  p.o_n = o_n;
  p.lse = lse;
  p.lse_b = lse_b;
  p.lse_h = lse_h;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (general && groups == MAXG && rows == 64) {
    err = launch<T, MAXG, true>(q, k, v, p, B, H, s);
  } else if (general && groups == MAXG && rows == 32) {
    if constexpr (!is_bf16<T>()) err = launch<T, MAXG, true, 32>(q, k, v, p, B, H, s);
  } else if (general || rows != 64) {
  } else if (groups == 1) {
    err = launch<T, 1, false>(q, k, v, p, B, H, s);
  } else if (groups == 2) {
    err = launch<T, 2, false>(q, k, v, p, B, H, s);
  } else if constexpr (MAXG == 4) {
    err = groups == 3 ? launch<T, 3, false>(q, k, v, p, B, H, s)
                      : launch<T, 4, false>(q, k, v, p, B, H, s);
  }
  return static_cast<int>(err);
}

}  // namespace
}  // namespace attn
}  // namespace gaviko
