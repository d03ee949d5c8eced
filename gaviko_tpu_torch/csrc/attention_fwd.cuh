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
// drops element (query row r, key j) of plane salt = b * heads_total +
// head0 + h unless keep_bit(r, j, salt, seed): heads_total and head0 place
// the launch's heads in a wider layer (a tensor-parallel rank's heads
// [head0, head0 + H) of heads_total), and default to H and 0. No bit is
// computed at rate 0 (threshold INT32_MIN). With lse != nullptr each row's m + log2(l) is written for the
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
//   general instance takes 32 query rows a CTA; where no Q fits beside the
//   ring (above 1280 columns), Q's chunks stream through the ring beside K's,
//   once a key tile (the streamed-Q instance, QS), and A's q * q_mult is
//   applied to each in the ring.
// The PTX, the TMA and wgmma helpers and the host's tensor maps are
// csrc/hopper.cuh's, shared with kernel B (csrc/fused_mhsa_bwd.cu).
// No atomics, and every sum runs in a fixed order, so a rerun is bit-equal.
#pragma once

#include "hopper.cuh"

namespace gaviko {
namespace attn {
namespace {  // internal linkage, as hopper.cuh says

// Groups of 64 output columns a CTA accumulates at most: 4 in bf16; 2 in
// f32, whose P V holds P's TF32 halves beside the output (3 and 4 groups
// spill).
template <typename T>
constexpr int max_groups() {
  return is_bf16<T>() ? 4 : 2;
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
  int salt_heads;   // the dropout plane of (b, h) is b * salt_heads + salt0 + h
  uint32_t salt0;
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
// wgmma takes 64). QS: Q's chunks stream through the ring (the general
// instance where they do not fit resident).
template <typename T, int G, bool GENERAL, int R = 64, bool QS = false>
struct Fwd {
  static constexpr int ROWS = R;
  static_assert(!QS || (GENERAL && R == 64), "the streamed-Q instance is general, 64 rows");
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
  static_assert(!QS || Q_TILE == KV_TILE, "a streamed Q chunk takes one ring stage");

  static size_t smem_bytes(int nck) {
    return 1024 + static_cast<size_t>(QS ? 0 : nck) * Q_TILE + RING_BYTES +
           (2 * STAGES + 1) * sizeof(uint64_t);
  }

  static __device__ void run(const CUtensorMap* tq, const CUtensorMap* tk, const CUtensorMap* tv,
                             const Params& p) {
    extern __shared__ char smem_raw[];
    char* smem = reinterpret_cast<char*>((reinterpret_cast<uintptr_t>(smem_raw) + 1023) &
                                         ~static_cast<uintptr_t>(1023));
    const int nck = GENERAL ? p.nck : NS;
    char* qs = smem;                          // nck Q chunk tiles (none if QS)
    char* ring = qs + (QS ? 0 : nck) * Q_TILE;  // STAGES K / V (and Q) chunk tiles
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
        if constexpr (!QS) {
          mbar_expect_tx(q_full, nck * Q_TILE);
          for (int c = 0; c < nck; ++c)
            load_tile(qs + c * Q_TILE, tq, p.pos[0], c * CW, q0, h, b, q_full);
        }
        const int nq = QS ? nck : 0;  // Q chunks a key tile streams: Q_c before K_c
        uint32_t it = 0;              // ring items issued
        for (int k0 = 0; k0 < p.n_keys; k0 += BKV) {
          for (int i = 0; i < nq + nck + ns; ++i, ++it) {
            const int st = it % STAGES;
            mbar_wait(&empty[st], ((it / STAGES) & 1) ^ 1);
            mbar_expect_tx(&full[st], KV_TILE);
            char* dst = ring + st * KV_TILE;
            if (i < 2 * nq && i % 2 == 0)
              load_tile(dst, tq, p.pos[0], i / 2 * CW, q0, h, b, &full[st]);
            else if (i < 2 * nq)
              load_tile(dst, tk, p.pos[1], i / 2 * CW, k0, h, b, &full[st]);
            else if (i < nq + nck)
              load_tile(dst, tk, p.pos[1], i * CW, k0, h, b, &full[st]);
            else
              load_tile(dst, tv, p.pos[2], (c0 + i - nq - nck) * CW, k0, h, b, &full[st]);
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

  static __device__ void consume(const Params& p, char* qs, char* ring, uint64_t* q_full,
                                 uint64_t* full, uint64_t* empty, int nck, int ns, int c0,
                                 int slice, int q0, int h, int b) {
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const int g = lane / 4, t = lane % 4;  // fragment row group, thread in group
    const int wr = warp * 16;              // the warp's first row in the CTA
    const int r0 = q0 + wr + g;            // this thread's rows: r0 and r0 + 8

    if constexpr (!QS) {
      mbar_wait(q_full, 0);
      if (p.q_mult != 1.0f) scale_tiles<T, CONSUMERS * 32>(qs, nck * Q_TILE, p.q_mult);
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
      if constexpr (QS) {
#pragma unroll 1
        for (int c = 0; c < nck; ++c, it += 2) {  // Q_c, then K_c
          char* qt = ring + wait_full(full, it) * KV_TILE;
          if (p.q_mult != 1.0f) scale_tiles<T, CONSUMERS * 32>(qt, Q_TILE, p.q_mult);
          s_product<T, SJ>(s, qt, ring + wait_full(full, it + 1) * KV_TILE, wr, g, t);
          if constexpr (kBf16) {
            wgmma_wait();
            pin(s);
          }
          release(empty, it, lane);
          release(empty, it + 1, lane);
        }
      } else if constexpr (kBf16) {
#pragma unroll
        for (int c = 0; c < nck; ++c, ++it) {
          s_product<T, SJ>(s, qs + c * Q_TILE, ring + wait_full(full, it) * KV_TILE, wr, g, t);
          wgmma_wait();
          pin(s);
          release(empty, it, lane);
        }
      } else {
#pragma unroll 1
        for (int c = 0; c < nck; ++c, ++it) {  // rolled: unrolled, f32 runs out of registers
          s_product<T, SJ>(s, qs + c * Q_TILE, ring + wait_full(full, it) * KV_TILE, wr, g, t);
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
          const uint32_t col = k0 + 8 * j + 2 * t, ra = r0, salt = b * p.salt_heads + p.salt0 + h;
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

template <typename T, int G, bool GENERAL, int ROWS, bool QS>
__global__ void __launch_bounds__(Fwd<T, G, GENERAL, ROWS, QS>::THREADS,
                                  Fwd<T, G, GENERAL, ROWS, QS>::MIN_BLOCKS)
    attention_fwd_kernel(const __grid_constant__ CUtensorMap tq,
                         const __grid_constant__ CUtensorMap tk,
                         const __grid_constant__ CUtensorMap tv,
                         const __grid_constant__ Params p) {
  Fwd<T, G, GENERAL, ROWS, QS>::run(&tq, &tk, &tv, p);
}

template <typename T, int G, bool GENERAL, int ROWS = 64, bool QS = false>
cudaError_t launch(const View& q, const View& k, const View& v, Params& p, int B, int H,
                   cudaStream_t stream) {
  using F = Fwd<T, G, GENERAL, ROWS, QS>;
  const size_t smem = F::smem_bytes(p.nck);
  if (smem > SMEM_LIMIT) return cudaErrorInvalidValue;
  CUtensorMap tq, tk, tv;
  cudaError_t err = encode<T>(&tq, p.pos[0], q, B, H, p.d, F::ROWS);
  if (err == cudaSuccess) err = encode<T>(&tk, p.pos[1], k, B, H, p.d, F::BKV);
  if (err == cudaSuccess) err = encode<T>(&tv, p.pos[2], v, B, H, p.d, F::BKV);
  if (err == cudaSuccess) err = opt_in<attention_fwd_kernel<T, G, GENERAL, ROWS, QS>>();
  if (err != cudaSuccess) return err;
  const dim3 grid((p.n_rows + F::ROWS - 1) / F::ROWS * p.n_slices, H, B);
  attention_fwd_kernel<T, G, GENERAL, ROWS, QS><<<grid, F::THREADS, smem, stream>>>(tq, tk, tv,
                                                                                    p);
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
// plan[3] query rows a CTA, plan[4] Q's chunks streamed through the ring (1,
// the general instance only) or resident (0). A plan this header has no
// instance for, or one whose slice exceeds its accumulators, returns
// cudaErrorInvalidValue.
template <typename T>
int forward(const View& q, const View& k, const View& v, T* o, long long o_b, long long o_h,
            long long o_n, float* lse, long long lse_b, long long lse_h, int B, int H, int D,
            int n_keys, const int* plan, float q_mult, float s_mult, uint32_t seed,
            int32_t threshold, float drop_scale, void* stream, int heads_total = 0,
            int head0 = 0) {
  constexpr int CW = ROW_BYTES / static_cast<int>(sizeof(T)), MAXG = max_groups<T>();
  const int groups = plan[0], slice_chunks = plan[2], rows = plan[3];
  const bool general = plan[1] != 0, q_stream = plan[4] != 0;
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
  p.salt_heads = heads_total > 0 ? heads_total : H;
  p.salt0 = static_cast<uint32_t>(head0);
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
  if (q_stream) {
    if (general && groups == MAXG && rows == 64)
      err = launch<T, MAXG, true, 64, true>(q, k, v, p, B, H, s);
  } else if (general && groups == MAXG && rows == 64) {
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
