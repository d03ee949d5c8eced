// Fused multi-head self-attention backward over the packed qkv projection.
//
// Replaces gaviko_tpu/ops/flash_attention.py:_fused_mhsa_bwd_kernel
// (_mhsa_bwd_core, the backward of fused_mhsa and of mhsa_qkv_proj), with the
// forward's dropout mask replayed from (seed, query row, key, b * heads_total
// + head0 + h) (csrc/fused_mhsa.cu).
//
// From qkv [B, n_pad, 3 * heads * hd], the forward's output O and its
// per-row statistic lse = m + log2(l) (csrc/fused_mhsa.cu, log2 units,
// [B, heads, n_pad] f32) and the cotangent dO, it writes dq, dk and dv into
// the column ranges h*hd, inner + h*hd and 2*inner + h*hd of one packed dqkv
// [B, n_pad, 3 * inner], the layout of qkv itself, so the caller's
// dh = dq Wq + dk Wk + dv Wv is one product with the packed weight and no
// concatenation is ever made. The algebra is the TPU kernel's:
//
//   P  = exp2(S - lse),  S = (scale * log2(e) * q) k^T over keys < n_true
//   f  = keep / (1 - rate)   (1 at rate 0),  delta = rowsum(dO * O)
//   dV = (f P)^T dO,  dP = dO V^T,  dS = P * (f dP - delta)
//   dQ = scale * dS K,  dK = scale * dS^T Q
//
// S is taken in f32 from q and k as stored and scaled by scale * log2(e)
// in registers, as the plain version takes it (the forward rounds q * scale
// * log2(e) to the input dtype first; in bf16 the two P differ by that
// rounding, inside the bf16 budget). Keys >= n_true get dK = dV = 0; every
// query row < n_pad contributes (a pad row with a zero cotangent contributes
// zero and gets dq = 0).
//
// What bounds it on the H100: at GAViKO vit-l16 B4 one call is about
// 10 * 1040 * 1033 * 64 * 16 * 4 = 44 GFLOP of products against about 38 MB
// (bf16) of bytes, so it is bound by compute: the products must run on the
// tensor cores while their operands stream in. The TPU kernel walked the q
// blocks in order and carried dK / dV in scratch; CTAs on the H100 run in no
// order, so this takes two passes with no atomics, each on the forward
// tile's pieces (csrc/hopper.cuh):
//
// - the dq pass: a CTA owns 64 query rows (Q and dO) and walks the key
//   tiles: S = Q K^T, dP = dO V^T, dQ += dS K. It also writes delta for its
//   rows.
// - the dk/dv pass: a CTA owns 64 keys (K and V) and walks the query tiles:
//   S^T = K Q^T, dP^T = V dO^T, dV += (f P)^T dO and dK += dS^T Q. The lse
//   and delta of a walked tile pass through shared memory.
//
// Each pass recomputes S and dP: 7 products where the TPU's one pass does 5.
// A CTA is one consumer warpgroup (four warps, 16 owned rows each) plus one
// producer warp, whose one thread loads the owned rows' chunk tiles once
// and streams the walked chunk tiles (128-byte rows, swizzled, through TMA)
// through a ring of 64 KB with full and empty mbarriers. S and dP are
// products of two K-major tiles; the output products take P or dS from
// registers (S's accumulator layout is the A-fragment layout, as in the
// forward) and read the walked tile MN-major as stored. At head dims up to
// 64 in bf16 (one chunk) the walked tile is held in the ring whole: K (Q)
// serves S and dQ (dK), V (dO) serves dP (and dV), S and dP are issued
// together and P is formed while dP runs. Otherwise each product waits for
// its chunk, and the output product's walked chunks are loaded again after
// S and dP are formed.
//
// - bf16: wgmma (m64n64k16) with both operands in shared memory for S and
//   dP, P / dS from registers for the outputs (the transpose bit reads the
//   walked tile MN-major).
// - f32: 3xTF32 on mma.sync m16n8k8 (hi * hi + hi * lo + lo * hi, as the
//   forward's f32 tile): wgmma's transpose bit serves only 16-bit types, and
//   the output products' B operand is MN-major.
// - The output columns split over the grid into the fewest slices of at
//   most the accumulators a CTA holds (ops/flash_attention.py:mhsa_bwd_plan,
//   the one place the plan is made): the dq pass holds one output (up to
//   256 columns bf16, 128 f32), the dk/dv pass two (up to 128 columns each
//   bf16, 64 f32). Every slice walks all of D's chunks for S and dP
//   (recomputed once a slice); dropout bits depend only on (row, key,
//   plane), so every slice replays the same mask. Where the owned rows'
//   chunks do not fit beside the ring (above 10 chunks: 640 columns bf16,
//   320 f32) they stream through the ring too, once a walked tile.
//
// No atomics, and every sum runs in a fixed order, so a rerun is bit-equal.

#include "hopper.cuh"

namespace gaviko {
namespace attn {
namespace {  // internal linkage, as hopper.cuh says

constexpr int TILE = 64 * ROW_BYTES;        // a chunk tile of 64 rows: one ring stage
constexpr int STAGES = RING_BYTES / TILE;   // stages of the ring
constexpr int STATS_BYTES = 2 * 2 * 64 * 4;  // the dk/dv pass's lse and delta, two buffers

struct BwdParams {
  int pos[4][3];  // q, k, v, dO: the tensor-map dimension (1..3) of rows, heads, batch
  int n_pad;      // query rows (and rows written)
  int n_true;     // keys < n_true are attended
  int d;          // head dim
  int nck;        // chunks of 128 bytes over d
  int slice_chunks, n_slices;  // this pass's output slices (the last may hold fewer)
  int heads, inner;
  int salt_heads;   // the dropout plane of (b, h) is b * salt_heads + salt0 + h
  uint32_t salt0;
  float scale_log2e, scale;
  uint32_t seed;
  int32_t threshold;  // INT32_MIN: no dropout
  float drop_scale;   // 1 / (1 - rate)
  int own_stream;     // the owned rows' chunks stream through the ring
  const float* lse;   // [B, heads, n_pad]
  float* delta;       // [B, heads, n_pad]: written by the dq pass
  const void* out;    // O [B, n_pad, inner]
  const void* dout;   // dO [B, n_pad, inner]
  void* dqkv;         // [B, n_pad, 3 * inner]
};

// The tensor maps, by BwdParams::pos's order.
enum { MQ = 0, MK = 1, MV = 2, MDO = 3 };

// DKDV: the dk/dv pass (else the dq pass); G groups of 64 output columns a
// CTA accumulates for each of its outputs; HOLD: the held tile (bf16, one
// chunk, owned rows resident, one slice).
template <typename T, bool DKDV, int G, bool HOLD = false>
struct Bwd {
  static constexpr bool kBf16 = is_bf16<T>();
  static_assert(!HOLD || (kBf16 && G == 1), "the held tile: bf16, head dims up to 64");
  static_assert(G >= 1 && G <= (kBf16 ? 4 : 2) / (DKDV ? 2 : 1), "a slice the registers hold");
  static constexpr int CW = ROW_BYTES / static_cast<int>(sizeof(T));  // columns a chunk
  static constexpr int NS = G * 64 / CW;  // output chunks a CTA, at most
  static constexpr int OJ = CW / 8;       // groups of 8 columns in an output chunk
  static constexpr int SJ = 8;            // groups of 8 walked rows: 64 a tile
  static constexpr int CONSUMERS = 4;     // consumer warps: 16 owned rows each
  static constexpr int THREADS = 32 * (CONSUMERS + 1);
  // CTAs an SM must hold, which caps the registers: two where a CTA
  // accumulates at most 128 columns in all (bf16) or one group (f32), one
  // above (measured fastest on the H100 at GAViKO B4 and vit-b16 B8; the
  // f32 instances spill a little under the cap).
  static constexpr int MIN_BLOCKS = kBf16 ? (G * (DKDV ? 2 : 1) <= 2 ? 2 : 1) : (G == 1 ? 2 : 1);
  // The owned operands (A of S and dP) and the walked ones (B of S and dP;
  // walked 1 is also B of the dq / dk product).
  static constexpr int OWN1 = DKDV ? MK : MQ, OWN2 = DKDV ? MV : MDO;
  static constexpr int WALK1 = DKDV ? MQ : MK, WALK2 = DKDV ? MDO : MV;

  static size_t smem_bytes(int nck, bool own_stream) {
    return 1024 + (own_stream ? 0 : 2 * static_cast<size_t>(nck) * TILE) + RING_BYTES +
           (2 * STAGES + 1) * sizeof(uint64_t) + STATS_BYTES;
  }

  // The i-th chunk dP walks: the slice's chunks first (the dk/dv pass
  // multiplies them into dV from the same stage), then the others in order.
  static __device__ __forceinline__ int dp_chunk(int i, int c0, int ns) {
    return i < ns ? c0 + i : (i - ns < c0 ? i - ns : i);
  }

  static __device__ void run(const CUtensorMap* const (&maps)[4], const BwdParams& p) {
    extern __shared__ char smem_raw[];
    char* smem = reinterpret_cast<char*>((reinterpret_cast<uintptr_t>(smem_raw) + 1023) &
                                         ~static_cast<uintptr_t>(1023));
    const int nck = p.nck;
    char* own = smem;  // 2 nck owned chunk tiles (none where they stream)
    char* ring = own + (p.own_stream ? 0 : 2 * nck * TILE);
    uint64_t* own_full = reinterpret_cast<uint64_t*>(ring + RING_BYTES);
    uint64_t* full = own_full + 1;
    uint64_t* empty = full + STAGES;
    float* stats = reinterpret_cast<float*>(empty + STAGES);
    const int slice = blockIdx.x % p.n_slices;
    const int o0 = blockIdx.x / p.n_slices * 64;  // the first owned row
    const int h = blockIdx.y, b = blockIdx.z;
    const int c0 = slice * p.slice_chunks;  // the slice's first output chunk
    const int ns = min(p.slice_chunks, nck - c0);
    // Walked rows: the keys (dq pass); every query row, none for a tile of
    // pad keys (dk/dv pass, whose rows then get zeros).
    const int n_walk = DKDV ? (o0 < p.n_true ? p.n_pad : 0) : p.n_true;
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

    if (threadIdx.x == 0) {
      mbar_init(own_full, 1);
      for (int s = 0; s < STAGES; ++s) {
        mbar_init(&full[s], 1);
        mbar_init(&empty[s], CONSUMERS);
      }
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();

    if (warp == CONSUMERS) {
      if (lane == 0) produce(maps, p, own, ring, own_full, full, empty, n_walk, c0, ns, o0, h, b);
      return;
    }
    consume(p, own, ring, own_full, full, empty, stats, n_walk, c0, ns, slice, o0, h, b);
  }

  static __device__ void produce(const CUtensorMap* const (&maps)[4], const BwdParams& p,
                                 char* own, char* ring, uint64_t* own_full, uint64_t* full,
                                 uint64_t* empty, int n_walk, int c0, int ns, int o0, int h,
                                 int b) {
    const int nck = p.nck;
    const bool stream = p.own_stream;
    if (!stream) {
      mbar_expect_tx(own_full, 2 * nck * TILE);
      for (int c = 0; c < nck; ++c) {
        load_tile(own + c * TILE, maps[OWN1], p.pos[OWN1], c * CW, o0, h, b, own_full);
        load_tile(own + (nck + c) * TILE, maps[OWN2], p.pos[OWN2], c * CW, o0, h, b, own_full);
      }
    }
    uint32_t it = 0;  // ring items issued
    auto push = [&](int m, int c, int row) {
      const int st = it % STAGES;
      mbar_wait(&empty[st], ((it / STAGES) & 1) ^ 1);
      mbar_expect_tx(&full[st], TILE);
      load_tile(ring + st * TILE, maps[m], p.pos[m], c * CW, row, h, b, &full[st]);
      ++it;
    };
    for (int w0 = 0; w0 < n_walk; w0 += 64) {
      if constexpr (HOLD) {  // each walked chunk once, held for the whole tile
        push(WALK1, 0, w0);
        push(WALK2, 0, w0);
        continue;
      }
      for (int c = 0; c < nck; ++c) {  // S: (owned 1,) walked 1
        if (stream) push(OWN1, c, o0);
        push(WALK1, c, w0);
      }
      for (int i = 0; i < nck; ++i) {  // dP: (owned 2,) walked 2
        const int c = dp_chunk(i, c0, ns);
        if (stream) push(OWN2, c, o0);
        push(WALK2, c, w0);
      }
      for (int j = 0; j < ns; ++j) push(WALK1, c0 + j, w0);  // the output product's B
    }
  }

  static __device__ __forceinline__ int wait_full(uint64_t* full, uint32_t it) {
    const int st = it % STAGES;
    mbar_wait(&full[st], (it / STAGES) & 1);
    return st;
  }

  static __device__ __forceinline__ void release(uint64_t* empty, uint32_t it, int lane) {
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[it % STAGES]);
  }

  // o (an output chunk of the owned rows) += A B with A the owned rows x the
  // 64 walked rows (bf16: the packed fragments pa; f32: a times the keep
  // factor, fs where bit i of keep is set, else 0) and B chunk tile bt, read
  // MN-major (rows = the walked rows). bf16 commits; the caller waits.
  static __device__ __forceinline__ void out_product(float (&o)[OJ * 4],
                                                     const uint32_t (&pa)[SJ / 2][4],
                                                     const float (&a)[SJ * 4], uint32_t keep,
                                                     float fs, const char* bt, int g, int t) {
    if constexpr (kBf16) {
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < SJ / 2; ++ks)
        wgmma_rs_n64(o, pa[ks], sw128_desc(bt + ks * 16 * ROW_BYTES, 1024));
      wgmma_commit();
    } else {
#pragma unroll
      for (int ks = 0; ks < SJ; ++ks) {
        const int i = 4 * ks;
        auto f = [&](int e) { return (keep >> (i + e)) & 1u ? a[i + e] * fs : 0.0f; };
        uint32_t ah[4], al[4];
        split(f(0), ah[0], al[0]);  // (row g, walked 8 ks + 2 t)
        split(f(2), ah[1], al[1]);  // (row g + 8, walked 8 ks + 2 t)
        split(f(1), ah[2], al[2]);  // (row g, walked 8 ks + 2 t + 1)
        split(f(3), ah[3], al[3]);  // (row g + 8, walked 8 ks + 2 t + 1)
#pragma unroll
        for (int n = 0; n < OJ; ++n) {
          uint32_t bh0, bl0, bh1, bl1;
          split(lds_sw(bt, 8 * ks + 2 * t, 8 * n + g), bh0, bl0);
          split(lds_sw(bt, 8 * ks + 2 * t + 1, 8 * n + g), bh1, bl1);
          mma3(&o[4 * n], ah, al, bh0, bh1, bl0, bl1);
        }
      }
    }
  }

  // pa = the bf16 A fragments of x (f32: nothing).
  static __device__ __forceinline__ void pack(uint32_t (&pa)[SJ / 2][4], const float (&x)[SJ * 4],
                                              uint32_t keep, float fs) {
    if constexpr (kBf16) {
#pragma unroll
      for (int j = 0; j < SJ; ++j) {
        float e[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) e[i] = (keep >> (4 * j + i)) & 1u ? x[4 * j + i] * fs : 0.0f;
        pa[j / 2][(j % 2) * 2] = pack_bf16(e[0], e[1]);
        pa[j / 2][(j % 2) * 2 + 1] = pack_bf16(e[2], e[3]);
      }
    }
  }

  // delta = rowsum(dO * O) of the warp's 16 rows from row0 (lanes over the
  // row's 16-byte vectors, then a warp sum); this thread keeps rows g and
  // g + 8; with `write`, lane 0 stores them for the dk/dv pass.
  static __device__ void row_deltas(const BwdParams& p, long long plane, int b, int h, int row0,
                                    int lane, int g, bool write, float& d0, float& d1) {
    constexpr int VEC = 16 / static_cast<int>(sizeof(T));
    for (int i = 0; i < 16; ++i) {
      const int r = row0 + i;
      float acc = 0.0f;
      if (r < p.n_pad) {
        const long long off = (static_cast<long long>(b) * p.n_pad + r) * p.inner + h * p.d;
        const T* o = static_cast<const T*>(p.out) + off;
        const T* d = static_cast<const T*>(p.dout) + off;
        for (int c = lane * VEC; c < p.d; c += 32 * VEC) {
          const uint4 ov = *reinterpret_cast<const uint4*>(o + c);
          const uint4 dv = *reinterpret_cast<const uint4*>(d + c);
          const T* oe = reinterpret_cast<const T*>(&ov);
          const T* de = reinterpret_cast<const T*>(&dv);
#pragma unroll
          for (int e = 0; e < VEC; ++e) acc = fmaf(to_f32(de[e]), to_f32(oe[e]), acc);
        }
      }
#pragma unroll
      for (int off = 16; off > 0; off /= 2) acc += __shfl_xor_sync(0xffffffffu, acc, off);
      if (i == g) d0 = acc;
      if (i == g + 8) d1 = acc;
      if (write && lane == 0 && r < p.n_pad) p.delta[plane + r] = acc;
    }
  }

  // s = P = exp2(S scale log2(e) - lse) on the attended pairs, 0 elsewhere
  // (dq pass: rows are the owned query rows, columns the walked keys; dk/dv
  // pass: rows the owned keys, columns the walked query rows). Returns the
  // dropout mask's keep bits: bit 4 j + i is element i of group j.
  static __device__ __forceinline__ uint32_t probs(float (&s)[SJ * 4], const BwdParams& p,
                                                   int w0, int r0, int t, float lse0, float lse1,
                                                   const float* lse_w, uint32_t salt) {
    const bool dropping = p.threshold != INT32_MIN;
    uint32_t keep = ~0u;
#pragma unroll
    for (int j = 0; j < SJ; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int wc = 8 * j + 2 * t + (i % 2);  // the walked row within the tile
        const int row = r0 + 8 * (i / 2);
        const int query = DKDV ? w0 + wc : row, key = DKDV ? row : w0 + wc;
        const bool live = key < p.n_true && (!DKDV || query < p.n_pad);
        const float l = DKDV ? lse_w[wc] : i < 2 ? lse0 : lse1;
        s[4 * j + i] = live ? ex2(fmaf(s[4 * j + i], p.scale_log2e, -l)) : 0.0f;
        if (dropping && !keep_bit(query, key, salt, p.seed, p.threshold))
          keep &= ~(1u << (4 * j + i));
      }
    return keep;
  }

  // dp = dS = P (f dP - delta).
  static __device__ __forceinline__ void dsoft(float (&dp)[SJ * 4], const float (&s)[SJ * 4],
                                               uint32_t keep, const BwdParams& p, int t,
                                               float dl0, float dl1, const float* delta_w) {
#pragma unroll
    for (int j = 0; j < SJ; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float f = (keep >> (4 * j + i)) & 1u ? p.drop_scale : 0.0f;
        const float dl = DKDV ? delta_w[8 * j + 2 * t + (i % 2)] : i < 2 ? dl0 : dl1;
        dp[4 * j + i] = s[4 * j + i] * (f * dp[4 * j + i] - dl);
      }
  }

  template <int N>
  static __device__ __forceinline__ void zero(float (&x)[N]) {
#pragma unroll
    for (int i = 0; i < N; ++i) x[i] = 0.0f;
  }

  static __device__ void consume(const BwdParams& p, char* own, char* ring, uint64_t* own_full,
                                 uint64_t* full, uint64_t* empty, float* stats, int n_walk, int c0,
                                 int ns, int slice, int o0, int h, int b) {
    constexpr int N = CONSUMERS * 32;
    const int nck = p.nck;
    const bool stream = p.own_stream;
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const int g = lane / 4, t = lane % 4;  // fragment row group, thread in group
    const int wr = warp * 16;              // the warp's first owned row in the CTA
    const int r0 = o0 + wr + g;            // this thread's owned rows: r0 and r0 + 8
    const uint32_t salt = b * p.salt_heads + p.salt0 + h;
    const long long plane = (static_cast<long long>(b) * p.heads + h) * p.n_pad;

    float lse0 = 0.0f, lse1 = 0.0f, dl0 = 0.0f, dl1 = 0.0f;  // the dq pass's owned rows
    if constexpr (!DKDV) {
      row_deltas(p, plane, b, h, o0 + wr, lane, g, slice == 0, dl0, dl1);
      if (r0 < p.n_pad) lse0 = p.lse[plane + r0];
      if (r0 + 8 < p.n_pad) lse1 = p.lse[plane + r0 + 8];
    }
    if (!stream) mbar_wait(own_full, 0);

    float o[NS][OJ * 4], o2[DKDV ? NS : 1][OJ * 4];  // dQ or dK; dV
#pragma unroll
    for (int j = 0; j < NS; ++j) {
      zero(o[j]);
      zero(o2[DKDV ? j : 0]);
    }
    uint32_t pa[SJ / 2][4], pb[SJ / 2][4];  // f P (dk/dv), dS: A fragments (bf16)
    uint32_t it = 0;  // ring items consumed
    int tile = 0;
    for (int w0 = 0; w0 < n_walk; w0 += 64, ++tile) {
      // The walked query rows' lse and delta (dk/dv pass), in the buffer of
      // this tile's parity: the barrier orders them, and a warp that writes
      // the next tile's buffer has passed this tile's barrier.
      const float* lse_w = stats + (tile % 2) * 128;
      const float* delta_w = lse_w + 64;
      if constexpr (DKDV) {
        const int q = w0 + threadIdx.x % 64;
        const float* src = threadIdx.x < 64 ? p.lse : p.delta;
        stats[(tile % 2) * 128 + threadIdx.x] = q < p.n_pad ? src[plane + q] : 0.0f;
        asm volatile("bar.sync 1, %0;\n" ::"n"(N) : "memory");
      }
      float s[SJ * 4], dp[SJ * 4];
      zero(s);
      zero(dp);

      if constexpr (HOLD) {
        // The held tile (one chunk, owned rows resident, one slice): S and
        // dP issued together, P formed while dP runs, then (dk/dv) dV issued
        // from the held dO chunk while dS is formed, then dQ (dK) from the
        // held K (Q) chunk; the counts of groups in flight are fixed.
        const char* w1 = ring + wait_full(full, it) * TILE;
        s_product<T, SJ>(s, own, w1, wr, g, t);
        const char* w2 = ring + wait_full(full, it + 1) * TILE;
        s_product<T, SJ>(dp, own + TILE, w2, wr, g, t);
        wgmma_wait_n<1>();
        pin(s);
        const uint32_t keep = probs(s, p, w0, r0, t, lse0, lse1, lse_w, salt);
        if constexpr (DKDV) {
          pack(pa, s, keep, p.drop_scale);
          out_product(o2[0], pa, s, keep, p.drop_scale, w2, g, t);
          wgmma_wait_n<1>();
        } else {
          wgmma_wait();
        }
        pin(dp);
        dsoft(dp, s, keep, p, t, dl0, dl1, delta_w);
        auto& pd = DKDV ? pb : pa;  // dk/dv: dV may still read pa
        pack(pd, dp, ~0u, 1.0f);
        out_product(o[0], pd, dp, ~0u, 1.0f, w1, g, t);
        wgmma_wait();
        pin(o[0]);
        pin(o2[0]);
        pin(pa);
        if constexpr (DKDV) pin(pb);
        release(empty, it, lane);
        release(empty, it + 1, lane);
        it += 2;
        continue;
      }

      // S (dk/dv: S^T) over D's chunks.
#pragma unroll 1
      for (int c = 0; c < nck; ++c) {
        const char* at = own + c * TILE;
        if (stream) at = ring + wait_full(full, it++) * TILE;
        const char* bt = ring + wait_full(full, it++) * TILE;
        s_product<T, SJ>(s, at, bt, wr, g, t);
        if constexpr (kBf16) {
          wgmma_wait();
          pin(s);
        }
        if (stream) release(empty, it - 2, lane);
        release(empty, it - 1, lane);
      }
      const uint32_t keep = probs(s, p, w0, r0, t, lse0, lse1, lse_w, salt);
      if constexpr (DKDV) pack(pa, s, keep, p.drop_scale);  // f P, for dV

      // dP (dk/dv: dP^T) over D's chunks; the dk/dv pass multiplies the
      // slice's dO chunks into dV from the same stage.
#pragma unroll 1
      for (int i = 0; i < nck; ++i) {
        const char* at = own + (nck + dp_chunk(i, c0, ns)) * TILE;
        if (stream) at = ring + wait_full(full, it++) * TILE;
        const char* bt = ring + wait_full(full, it++) * TILE;
        s_product<T, SJ>(dp, at, bt, wr, g, t);
        if constexpr (DKDV) {
#pragma unroll
          for (int j = 0; j < NS; ++j)
            if (j == i) out_product(o2[j], pa, s, keep, p.drop_scale, bt, g, t);
        }
        if constexpr (kBf16) {
          wgmma_wait();
          pin(dp);
          if constexpr (DKDV) {
#pragma unroll
            for (int j = 0; j < NS; ++j) pin(o2[j]);
          }
        }
        if (stream) release(empty, it - 2, lane);
        release(empty, it - 1, lane);
      }
      dsoft(dp, s, keep, p, t, dl0, dl1, delta_w);
      pack(pa, dp, ~0u, 1.0f);

      // dQ += dS K (dk/dv: dK += dS^T Q) over the slice's chunks.
#pragma unroll
      for (int j = 0; j < NS; ++j) {
        if (j >= ns) break;
        const char* bt = ring + wait_full(full, it++) * TILE;
        out_product(o[j], pa, dp, ~0u, 1.0f, bt, g, t);
        if constexpr (kBf16) {
          wgmma_wait();
          pin(o[j]);
        }
        release(empty, it - 1, lane);
      }
    }

    // dq (dk, dv) of the owned rows below n_pad, the slice's columns below d.
    const long long rs = 3LL * p.inner;
    T* dst = static_cast<T*>(p.dqkv) + static_cast<long long>(b) * p.n_pad * rs + h * p.d +
             (DKDV ? p.inner : 0);
#pragma unroll
    for (int j = 0; j < NS; ++j) {
      if (j >= ns) break;
#pragma unroll
      for (int n = 0; n < OJ; ++n) {
        const int col = (c0 + j) * CW + 8 * n + 2 * t;
        if (col >= p.d) continue;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int r = r0 + 8 * half;
          if (r >= p.n_pad) continue;
          const int i = 4 * n + 2 * half;
          store2(dst + r * rs + col, o[j][i] * p.scale, o[j][i + 1] * p.scale);
          if constexpr (DKDV) store2(dst + p.inner + r * rs + col, o2[j][i], o2[j][i + 1]);
        }
      }
    }
  }
};

template <typename T, bool DKDV, int G, bool HOLD>
__global__ void __launch_bounds__(Bwd<T, DKDV, G, HOLD>::THREADS,
                                  Bwd<T, DKDV, G, HOLD>::MIN_BLOCKS)
    mhsa_bwd_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                    const __grid_constant__ CUtensorMap tv,
                    const __grid_constant__ CUtensorMap tdo,
                    const __grid_constant__ BwdParams p) {
  const CUtensorMap* const maps[4] = {&tq, &tk, &tv, &tdo};
  Bwd<T, DKDV, G, HOLD>::run(maps, p);
}

template <typename T, bool DKDV, int G, bool HOLD = false>
cudaError_t launch_pass(const CUtensorMap (&m)[4], const BwdParams& p, int B, cudaStream_t s) {
  using K = Bwd<T, DKDV, G, HOLD>;
  const size_t smem = K::smem_bytes(p.nck, p.own_stream != 0);
  if (smem > SMEM_LIMIT) return cudaErrorInvalidValue;
  const cudaError_t err = opt_in<mhsa_bwd_kernel<T, DKDV, G, HOLD>>();
  if (err != cudaSuccess) return err;
  const dim3 grid((p.n_pad + 63) / 64 * p.n_slices, p.heads, B);
  mhsa_bwd_kernel<T, DKDV, G, HOLD><<<grid, K::THREADS, smem, s>>>(m[0], m[1], m[2], m[3], p);
  return cudaGetLastError();
}

// The pass's instance for G groups: 1 to 4 (dq) or 1 to 2 (dk/dv) in bf16,
// 1 to 2 (dq) or 1 (dk/dv) in f32; the held tile where bf16 D is one chunk
// held resident in one slice.
template <typename T, bool DKDV>
cudaError_t pass(int groups, const CUtensorMap (&m)[4], const BwdParams& p, int B,
                 cudaStream_t s) {
  constexpr int MAXG = (is_bf16<T>() ? 4 : 2) / (DKDV ? 2 : 1);
  if constexpr (is_bf16<T>()) {
    if (groups == 1 && p.nck == 1 && !p.own_stream && p.n_slices == 1)
      return launch_pass<T, DKDV, 1, true>(m, p, B, s);
  }
  if (groups == 1) return launch_pass<T, DKDV, 1>(m, p, B, s);
  if constexpr (MAXG >= 2) {
    if (groups == 2) return launch_pass<T, DKDV, 2>(m, p, B, s);
  }
  if constexpr (MAXG == 4) {
    if (groups == 3) return launch_pass<T, DKDV, 3>(m, p, B, s);
    if (groups == 4) return launch_pass<T, DKDV, 4>(m, p, B, s);
  }
  return cudaErrorInvalidValue;
}

// plan: (groups, chunks of a slice) of the dq pass, then of the dk/dv pass,
// then 1 where the owned rows' chunks stream (ops/flash_attention.py:
// mhsa_bwd_plan).
template <typename T>
int backward(const void* qkv, const void* out, const void* dout, const float* lse, float* delta,
             void* dqkv, int B, int n_pad, int heads, int dim_head, int n_true, const int* plan,
             float scale, int seed, int threshold, float drop_scale, int heads_total,
             int head0, void* stream) {
  constexpr int CW = ROW_BYTES / static_cast<int>(sizeof(T));
  if (B < 1 || heads < 1 || dim_head < 1 || dim_head % 8 || n_true < 1 || n_true > n_pad ||
      heads_total < heads || head0 < 0 || head0 > heads_total - heads)
    return static_cast<int>(cudaErrorInvalidValue);
  const int nck = (dim_head + CW - 1) / CW;
  for (int k = 0; k < 4; k += 2)  // each pass: a slice its accumulators hold
    if (plan[k] < 1 || plan[k + 1] < 1 || plan[k + 1] * CW > plan[k] * 64)
      return static_cast<int>(cudaErrorInvalidValue);
  const long long inner = static_cast<long long>(heads) * dim_head, row = 3 * inner;
  const T* base = static_cast<const T*>(qkv);
  const View views[4] = {{base, n_pad * row, dim_head, row, n_pad},
                         {base + inner, n_pad * row, dim_head, row, n_true},
                         {base + 2 * inner, n_pad * row, dim_head, row, n_true},
                         {dout, n_pad * inner, dim_head, inner, n_pad}};
  BwdParams p{};
  CUtensorMap maps[4];
  for (int i = 0; i < 4; ++i) {
    const cudaError_t err = encode<T>(&maps[i], p.pos[i], views[i], B, heads, dim_head, 64);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  p.n_pad = n_pad;
  p.n_true = n_true;
  p.d = dim_head;
  p.nck = nck;
  p.heads = heads;
  p.inner = static_cast<int>(inner);
  p.salt_heads = heads_total;
  p.salt0 = static_cast<uint32_t>(head0);
  p.scale_log2e = scale * LOG2E;
  p.scale = scale;
  p.seed = static_cast<uint32_t>(seed);
  p.threshold = threshold;
  p.drop_scale = drop_scale;
  p.own_stream = plan[4];
  p.lse = lse;
  p.delta = delta;
  p.out = out;
  p.dout = dout;
  p.dqkv = dqkv;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  for (int k = 0; k < 2; ++k) {
    p.slice_chunks = plan[2 * k + 1];
    p.n_slices = (nck + p.slice_chunks - 1) / p.slice_chunks;
    const cudaError_t err = k == 0 ? pass<T, false>(plan[0], maps, p, B, s)
                                   : pass<T, true>(plan[2], maps, p, B, s);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaSuccess);
}

}  // namespace
}  // namespace attn
}  // namespace gaviko

// qkv [B, n_pad, 3 * heads * dim_head], out and dout [B, n_pad, heads *
// dim_head], all contiguous, 16-byte aligned and of one dtype, dim_head a
// multiple of 8; lse and delta (scratch) [B, heads, n_pad] f32 -> dqkv [B,
// n_pad, 3 * heads * dim_head] in qkv's dtype. plan as backward() above
// says. seed, threshold, drop_scale, heads_total and head0 are the
// forward's (threshold INT32_MIN: no dropout).
extern "C" int gaviko_fused_mhsa_bwd_bf16(const void* qkv, const void* out, const void* dout,
                                          const float* lse, float* delta, void* dqkv, int B,
                                          int n_pad, int heads, int dim_head, int n_true,
                                          const int* plan, float scale, int seed, int threshold,
                                          float drop_scale, int heads_total, int head0,
                                          void* stream) {
  return gaviko::attn::backward<__nv_bfloat16>(qkv, out, dout, lse, delta, dqkv, B, n_pad, heads,
                                               dim_head, n_true, plan, scale, seed, threshold,
                                               drop_scale, heads_total, head0, stream);
}

extern "C" int gaviko_fused_mhsa_bwd_f32(const void* qkv, const void* out, const void* dout,
                                         const float* lse, float* delta, void* dqkv, int B,
                                         int n_pad, int heads, int dim_head, int n_true,
                                         const int* plan, float scale, int seed, int threshold,
                                         float drop_scale, int heads_total, int head0,
                                         void* stream) {
  return gaviko::attn::backward<float>(qkv, out, dout, lse, delta, dqkv, B, n_pad, heads,
                                       dim_head, n_true, plan, scale, seed, threshold, drop_scale,
                                       heads_total, head0, stream);
}
