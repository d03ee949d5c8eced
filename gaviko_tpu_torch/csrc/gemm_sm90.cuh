// A Hopper GEMM of the port's own, for the fused MLP's products (kernels
// B6, csrc/fused_mlp.cu, and B7, csrc/fused_mlp_bwd.cu), the LN + linear
// products (B9, csrc/ln_linear.cu, and B12, csrc/ln_linear_bwd.cu), the
// int8 serving GEMMs (B11, csrc/int8_linear.cu) and patchify's product
// (csrc/patchify.cu):
//
//   C[M, N] = A[M, K] B[K, N], every output through an epilogue functor.
//
// A is stored [M][K] (K-major) or [K][M] (AT: MN-major); B is stored [N][K]
// (K-major) or [K][N] (BT: MN-major), row-major with unit column stride, so
// the weight gradients, whose depth is the rows, read both operands as
// stored. A CTA owns a BM x 128 output tile, BM (its rows) a template
// parameter that ops/_blocks.py chooses a launch at a time (64 or 128 in
// bf16 and int8, 128 in f32; see `compiled`): one producer warp, one of whose threads streams the
// operands' k tiles (128 bytes of depth: 64 bf16 or 32 f32 columns) through
// a ring of STAGES stages with full and empty mbarriers (TMA boxes of 128
// bytes x CW rows, 128-byte swizzled: csrc/hopper.cuh's tensor maps of a
// [rows, cols] matrix, B = H = 1), and BM / 64 consumer warpgroups of 64
// rows each, every one of them taking the whole 128 columns:
//
// - bf16: wgmma m64n128k16 with both operands in shared memory; a
//   [K][M] or [K][N] operand is read through the descriptor's transpose
//   bit (64-column atoms 8 KB apart). One group of products stays in flight
//   while the next stage's are issued.
// - f32: 3xTF32 on mma.sync m16n8k8 (hi * hi + hi * lo + lo * hi,
//   csrc/hopper.cuh's split and mma3), each warp 64 rows x 32 columns (each
//   fragment split once for four products): wgmma's TF32 takes only K-major
//   operands, and the weight gradients' are not.
// - int8 (T = int8_t): wgmma m64n128k32 s32.s8.s8, both operands K-major in
//   shared memory (integer wgmma takes no other layout; AT and BT must be
//   false), int32 accumulators, exact in any order. A k tile is 128 codes,
//   four k32 steps whose descriptors advance 32 bytes as bf16's k16 steps
//   do, so the boxes, the swizzle and the ring are bf16's. The sums reach
//   the epilogue converted to f32 (cvt.rn.f32.s32).
//
// The epilogue functor sees the f32 sums of 8 columns (col .. col + 7) of a
// row < M at a time (through shared memory, whatever the products' register
// layout), reads what it needs and writes its outputs itself; where it asks
// (kColsum) the kernel also writes the tile's column sums of what the
// functor left in the 8 values, in a fixed order (each thread's rows, then
// the row groups in order), one row of partials a BM-row tile; where it
// asks (kRowmax) the functor returns a non-negative partial of its row,
// and the kernel takes each row's maximum over the tile across the 16
// lanes that hold it and then into the functor's `rowmax` [M] in device
// memory (atomicMax on the bits: a maximum is the same in any order, so
// reruns are bit-equal); it may ask for per-row inputs staged in shared
// memory too (kRowInput).
// A launch runs up to three problems of one epilogue type (B7's two weight
// gradients and dh, B12's dW and dh), each with its own A layout, in order,
// each problem's tiles rastered so that the CTAs that run together share
// the larger operand's tiles. Every CTA takes its tile's whole depth. No atomics but
// kRowmax's maxima: reruns are bit-equal.
#pragma once

#include "hopper.cuh"

namespace gaviko {
namespace gemm {
namespace {  // internal linkage, as csrc/hopper.cuh says

using attn::ROW_BYTES;

constexpr int BN = 128;  // a tile's columns, at every tile
template <typename T>
__host__ __device__ constexpr int chunk() {  // columns of 128 bytes: the k tile's depth
  return ROW_BYTES / static_cast<int>(sizeof(T));
}

template <typename T>
__host__ __device__ constexpr bool is_s8() {
  return std::is_same<T, int8_t>::value;
}
// The types whose products run on wgmma (bf16, int8); f32 runs mma.sync.
template <typename T>
__host__ __device__ constexpr bool on_wgmma() {
  return is_bf16<T>() || is_s8<T>();
}

// The tiles compiled for T, by their rows BM (ops/_blocks.py's TILES): in
// bf16 and int8 64 (one consumer warpgroup) and 128 (two), each consumer
// thread holding the same 64 accumulators at both (90 registers, no spills:
// ptxas -v on an H100 build); in f32 128 only, since at 64 rows ptxas
// spilled more than at 128 in two of its 3xTF32 epilogues (B7's dg 40 / 44
// bytes against 24 / 8, patchify's 8 / 8 against none). A tile of 256 rows
// (four warpgroups, one CTA an SM) lost to 128 at every shape measured but
// weight-gradient launches of 64,512 rows, which no shipped configuration
// runs, so it is not compiled.
template <typename T, int BM>
__host__ __device__ constexpr bool compiled() {
  return on_wgmma<T>() ? BM == 64 || BM == 128 : BM == 128;
}
template <int BM>
__host__ __device__ constexpr int consumer_warps() {  // four warps a warpgroup of 64 rows
  return BM / 16;
}
template <int BM>
__host__ __device__ constexpr int threads() {  // + the producer warp
  return 32 * (consumer_warps<BM>() + 1);
}
template <int BM>
__host__ __device__ constexpr int stage_bytes() {  // both operands' k tiles
  return (BM + BN) * ROW_BYTES;
}

// bf16 and int8: three stages, so two CTAs share an SM (their registers and
// shared memory allow it, no third) and one's epilogue runs beside the
// other's products; f32 (its 3xTF32 fragments take more registers): four
// stages, one CTA an SM.
template <typename T>
__host__ __device__ constexpr int stages() {
  return on_wgmma<T>() ? 3 : 4;
}
template <typename T>
__host__ __device__ constexpr int min_blocks() {
  return on_wgmma<T>() ? 2 : 1;
}

// Rows of A's TMA box: CW (one box a CW-row slice of the k tile), but at
// most the tile's rows (int8's 128-code k tile at 64 rows).
template <typename T>
__host__ __device__ constexpr int a_box_rows(int bm) {
  return chunk<T>() < bm ? chunk<T>() : bm;
}

// What an epilogue functor asks for beyond kColsum, each off unless it
// declares it: kRowmax (it returns its row's partial maximum), kRowInput
// (row_input(m), a float2 of row m, staged in shared memory for the tile's
// rows before the loop and handed to each call: per-row scalars without a
// device-memory load in the loop).
template <class E, class = void>
struct RowmaxOf {
  static constexpr bool value = false;
};
template <class E>
struct RowmaxOf<E, std::void_t<decltype(E::kRowmax)>> {
  static constexpr bool value = E::kRowmax;
};
template <class E, class = void>
struct RowInputOf {
  static constexpr bool value = false;
};
template <class E>
struct RowInputOf<E, std::void_t<decltype(E::kRowInput)>> {
  static constexpr bool value = E::kRowInput;
};

// The epilogue stages the tile's f32 sums in shared memory over the ring
// (free by then): rows of BN floats padded by 8, so the fragments' 8-byte
// stores of 4 rows meet no bank twice (BM x 136 floats, within every ring).
constexpr int SROW = BN + 8;
template <int BM>
__host__ __device__ constexpr int epi_rows() {  // rows an epilogue pass: 8 or 16
  return consumer_warps<BM>() * 32 / (BN / 8);
}

template <typename T, int BM>
size_t smem_bytes() {
  return 1024 + static_cast<size_t>(stages<T>()) * stage_bytes<BM>() +
         2 * stages<T>() * sizeof(uint64_t) + epi_rows<BM>() * BN * sizeof(float);
}

constexpr int MAX_PROBLEMS = 3;

template <class Epi>
struct Problem {
  int M, N, K;
  int tiles_m, tiles_n;
  int n_fast;            // tile order: n fastest (CTAs that share A's rows run together)
  int at;                // A is stored [K][M] (MN-major)
  Epi epi;
};

template <class Epi>
struct Params {
  CUtensorMap a[MAX_PROBLEMS], b[MAX_PROBLEMS];
  Problem<Epi> prob[MAX_PROBLEMS];
  int ends[MAX_PROBLEMS];  // the running count of the problems' CTAs
};

// d (64 x 128, f32) += A (64 x 16) B (16 x 128), bf16 in shared memory; TA /
// TB read A / B MN-major (the transpose bits).
template <int TA, int TB>
__device__ __forceinline__ void wgmma_m64n128(float (&d)[64], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, %67, %68;\n}\n"
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
      : "l"(a), "l"(b), "r"(1), "n"(TA), "n"(TB));
}

// d (64 x 128, s32) += A (64 x 32) B (32 x 128), int8 in shared memory, both
// K-major (integer wgmma has no transpose).
__device__ __forceinline__ void wgmma_m64n128_s8(int32_t (&d)[64], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63}, "
      "%64, %65, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
        "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]),
        "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
        "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]),
        "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]),
        "+r"(d[54]), "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(a), "l"(b), "r"(1));
}

// An accumulator as f32: an int32 sum rounded once (cvt.rn.f32.s32).
__device__ __forceinline__ float as_f32(float v) { return v; }
__device__ __forceinline__ float as_f32(int32_t v) { return __int2float_rn(v); }

// csrc/hopper.cuh's pin for int32 accumulators.
__device__ __forceinline__ void pin_s32(int32_t (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// BM: the tile's rows; AT: the launch may hold problems whose A is stored
// [K][M] (each problem says whether its own is); BT: B is stored [K][N].
template <typename T, int BM, bool AT, bool BT, class Epi>
struct Gemm {
  static_assert(compiled<T, BM>(), "no such tile for this type");
  static constexpr bool kBf16 = is_bf16<T>();
  static constexpr bool kS8 = is_s8<T>();
  static constexpr bool kWgmma = kBf16 || kS8;  // the accumulators in wgmma's layout
  static constexpr bool kRowmax = RowmaxOf<Epi>::value;
  static constexpr bool kRowInput = RowInputOf<Epi>::value;
  static_assert(!(Epi::kColsum && kRowInput), "the row inputs and the column sums share `red`");
  static_assert(!kS8 || (!AT && !BT), "integer wgmma takes K-major operands only");
  using Acc = typename std::conditional<kS8, int32_t, float>::type;
  static constexpr int CW = chunk<T>();
  static constexpr int BOX_BYTES = CW * ROW_BYTES;  // one TMA box: CW rows of 128 bytes
  static constexpr int A_BOX_ROWS = a_box_rows<T>(BM);
  static constexpr int A_BOX_BYTES = A_BOX_ROWS * ROW_BYTES;
  static constexpr int A_BOXES = BM / A_BOX_ROWS;  // boxes of A's k tile
  static constexpr int B_BOXES = BN / CW;          // boxes of B's
  static constexpr int A_BYTES = BM * ROW_BYTES;   // A's k tile; B's follows it
  static constexpr int STAGES = stages<T>();
  static constexpr int STAGE_BYTES = stage_bytes<BM>();
  static constexpr int CONSUMER_WARPS = consumer_warps<BM>();
  static constexpr int EPI_ROWS = epi_rows<BM>();

  static __device__ void run(const Params<Epi>& p) {
    extern __shared__ char smem_raw[];
    char* ring = reinterpret_cast<char*>((reinterpret_cast<uintptr_t>(smem_raw) + 1023) &
                                         ~static_cast<uintptr_t>(1023));
    static_assert(BM * SROW * sizeof(float) <= STAGES * STAGE_BYTES, "staging in the ring");
    uint64_t* full = reinterpret_cast<uint64_t*>(ring + STAGES * STAGE_BYTES);
    uint64_t* empty = full + STAGES;
    float* red = reinterpret_cast<float*>(empty + STAGES);  // [EPI_ROWS][BN]

    int id = blockIdx.x, q = 0;
    while (q + 1 < MAX_PROBLEMS && id >= p.ends[q]) ++q;
    if (q > 0) id -= p.ends[q - 1];
    // A copy in registers: read through a reference into the parameters, each
    // field would be loaded again after every store of the epilogue.
    const Problem<Epi> pr = q == 0 ? p.prob[0] : q == 1 ? p.prob[1] : p.prob[2];
    const bool at = AT && pr.at;
    const int tm = pr.n_fast ? id / pr.tiles_n : id % pr.tiles_m;
    const int tn = pr.n_fast ? id % pr.tiles_n : id / pr.tiles_m;
    const int m0 = tm * BM, n0 = tn * BN;
    const int nk = (pr.K + CW - 1) / CW;  // k tiles
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

    if (threadIdx.x == 0) {
      for (int s = 0; s < STAGES; ++s) {
        attn::mbar_init(&full[s], 1);
        attn::mbar_init(&empty[s], CONSUMER_WARPS);
      }
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();

    if (warp == CONSUMER_WARPS) {
      if (lane == 0) {
        if (at)
          produce<AT>(&p.a[q], &p.b[q], ring, full, empty, m0, n0, nk);
        else
          produce<false>(&p.a[q], &p.b[q], ring, full, empty, m0, n0, nk);
      }
      return;
    }

    Acc acc[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0;
    const int wg = warp / 4, w = warp % 4;
    if constexpr (kS8) {
      mainloop_s8(acc, ring, full, empty, nk, wg, lane);
    } else if constexpr (kBf16) {
      if (at)
        mainloop_wgmma<AT>(acc, ring, full, empty, nk, wg, lane);
      else
        mainloop_wgmma<false>(acc, ring, full, empty, nk, wg, lane);
    } else {
      if (at)
        mainloop_tf32<AT>(acc, ring, full, empty, nk, wg, w, lane);
      else
        mainloop_tf32<false>(acc, ring, full, empty, nk, wg, w, lane);
    }

    // The epilogue. The fragments' f32 sums go to shared memory; then each
    // thread takes 8 columns of every 16th row and hands them to the
    // functor, which reads its inputs and writes its outputs in 16-byte
    // vectors (whole lines of device memory), in a loop that is not
    // unrolled: the functor's GELU, inlined 64 times, would not fit the
    // instruction cache.
    float* stage = reinterpret_cast<float*>(ring);
    const int g = lane / 4, t = lane % 4;
    const int lr0 = wg * 64 + g, lc0 = 2 * t;  // the thread's first row and column in the tile
    consumers_sync();  // every warpgroup is done with the ring
#pragma unroll
    for (int pp = 0; pp < 32; ++pp)
      *reinterpret_cast<float2*>(stage + (lr0 + row_of(pp, w)) * SROW + lc0 + col_of(cpair(pp), w)) =
          make_float2(as_f32(acc[2 * pp]), as_f32(acc[2 * pp + 1]));
    const int rows = min(BM, pr.M - m0);
    float2* rowin = reinterpret_cast<float2*>(red);  // [BM]: the rows' inputs (kRowInput)
    if constexpr (kRowInput) {
      if (threadIdx.x < rows) rowin[threadIdx.x] = pr.epi.row_input(m0 + threadIdx.x);
    }
    consumers_sync();
    const int cv = threadIdx.x % (BN / 8), rg = threadIdx.x / (BN / 8);
    float cs[8] = {};
    // kRowmax: the two row groups of a warp take as many steps (the odd one
    // past the last row where the even one has a row), so the 16 lanes of
    // each row can take its maximum together.
    const int end = rows + (kRowmax ? (rg & 1) : 0);
#pragma unroll 1
    for (int r = rg; r < end; r += EPI_ROWS) {
      float v[8];
      if constexpr (kRowmax) {
        float m = 0.0f;
        if (r < rows) {
          stage_row(stage, r, cv, v);
          m = apply(pr.epi, m0 + r, n0 + 8 * cv, v, rowin, r);
        }
#pragma unroll
        for (int off = 8; off > 0; off /= 2) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
        if (cv == 0 && r < rows)
          atomicMax(reinterpret_cast<int*>(pr.epi.rowmax) + m0 + r, __float_as_int(m));
      } else {
        stage_row(stage, r, cv, v);
        apply(pr.epi, m0 + r, n0 + 8 * cv, v, rowin, r);
      }
      if constexpr (Epi::kColsum) {
#pragma unroll
        for (int j = 0; j < 8; ++j) cs[j] += v[j];
      }
    }
    if constexpr (Epi::kColsum) {
      // Each thread's sums over its rows, then the EPI_ROWS row groups' in
      // order.
#pragma unroll
      for (int j = 0; j < 8; ++j) red[rg * BN + 8 * cv + j] = cs[j];
      consumers_sync();
      if (threadIdx.x < BN) {
        float s = 0.0f;
#pragma unroll
        for (int k = 0; k < EPI_ROWS; ++k) s += red[k * BN + threadIdx.x];
        pr.epi.colsum[static_cast<long long>(tm) * pr.N + n0 + threadIdx.x] = s;
      }
    }
  }

  // Columns 8 cv .. 8 cv + 7 of tile row r of the staged sums.
  static __device__ __forceinline__ void stage_row(const float* stage, int r, int cv,
                                                   float (&v)[8]) {
    const float4* src = reinterpret_cast<const float4*>(stage + r * SROW + 8 * cv);
    const float4 lo = src[0], hi = src[1];
    v[0] = lo.x, v[1] = lo.y, v[2] = lo.z, v[3] = lo.w;
    v[4] = hi.x, v[5] = hi.y, v[6] = hi.z, v[7] = hi.w;
  }

  // The functor's call on the 8 values v of tile row r (row `row` of C),
  // with that row's staged input where it takes one; its row maximum
  // partial where it gives one (kRowmax), else 0.
  static __device__ __forceinline__ float apply(const Epi& e, int row, int col, float (&v)[8],
                                                const float2* rowin, int r) {
    if constexpr (kRowInput) {
      if constexpr (kRowmax) {
        return e(row, col, v, rowin[r]);
      } else {
        e(row, col, v, rowin[r]);
        return 0.0f;
      }
    } else {
      if constexpr (kRowmax) {
        return e(row, col, v);
      } else {
        e(row, col, v);
        return 0.0f;
      }
    }
  }

  // The accumulators' layout. A thread holds 32 pairs: pair p is acc[2 p],
  // acc[2 p + 1] at row wg * 64 + g + row_of(p, w) and columns 2 t +
  // col_of(cpair(p), w) (+ 1) of the tile. bf16 (wgmma's m64n128 layout):
  // warp w's 16 rows x all 128 columns, p = 2 j + h for column group j and
  // row half h. f32 (the mma.sync tiles): warp w's 32 columns x all 64
  // rows, p = 2 (4 mi + ni) + h for row tile mi and column group ni.
  static __device__ __forceinline__ int row_of(int p, int w) {
    return kWgmma ? 16 * w + 8 * (p % 2) : 16 * (p / 8) + 8 * (p % 2);
  }
  static __device__ __forceinline__ int cpair(int p) {  // the pair's column group
    return kWgmma ? p / 2 : (p / 2) % 4;
  }
  static __device__ __forceinline__ int col_of(int c, int w) { return kWgmma ? 8 * c : 32 * w + 8 * c; }

  // One thread: the nk k tiles of A's rows m0.. and B's columns n0.. into
  // the ring, A_BOXES and B_BOXES boxes, one of each in turn; TA: A is
  // [K][M].
  template <bool TA>
  static __device__ void produce(const CUtensorMap* ma, const CUtensorMap* mb, char* ring,
                                 uint64_t* full, uint64_t* empty, int m0, int n0, int nk) {
    for (int i = 0; i < nk; ++i) {
      const int st = i % STAGES;
      attn::mbar_wait(&empty[st], ((i / STAGES) & 1) ^ 1);
      attn::mbar_expect_tx(&full[st], STAGE_BYTES);
      char* as = ring + st * STAGE_BYTES;
      char* bs = as + A_BYTES;
      const int k0 = i * CW;
#pragma unroll
      for (int j = 0; j < (A_BOXES > B_BOXES ? A_BOXES : B_BOXES); ++j) {
        if (j < A_BOXES) {
          if constexpr (TA)
            attn::tma_load(as + j * A_BOX_BYTES, ma, m0 + j * CW, k0, 0, 0, &full[st]);
          else
            attn::tma_load(as + j * A_BOX_BYTES, ma, k0, m0 + j * A_BOX_ROWS, 0, 0, &full[st]);
        }
        if (j < B_BOXES) {
          if constexpr (BT)
            attn::tma_load(bs + j * BOX_BYTES, mb, n0 + j * CW, k0, 0, 0, &full[st]);
          else
            attn::tma_load(bs + j * BOX_BYTES, mb, k0, n0 + j * CW, 0, 0, &full[st]);
        }
      }
    }
  }

  static __device__ __forceinline__ void consumers_sync() {
    asm volatile("bar.sync 1, %0;\n" ::"n"(CONSUMER_WARPS * 32) : "memory");
  }

  static __device__ __forceinline__ void release(uint64_t* empty, int i, int lane) {
    if (lane == 0) attn::mbar_arrive(&empty[i % STAGES]);
  }

  // bf16: warpgroup wg's 64 rows; one stage's four products in flight while
  // the next stage's are issued.
  template <bool TA>
  static __device__ __forceinline__ void mainloop_wgmma(float (&acc)[64], const char* ring,
                                                        uint64_t* full, uint64_t* empty, int nk,
                                                        int wg, int lane) {
#pragma unroll 1
    for (int i = 0; i < nk; ++i) {
      const int st = i % STAGES;
      attn::mbar_wait(&full[st], (i / STAGES) & 1);
      const char* as = ring + st * STAGE_BYTES;
      const char* bs = as + A_BYTES;
      attn::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        // A: rows wg * 64.. as stored (32 bytes a k16 step), or MN-major
        // atom wg (16 rows of depth a step); B: likewise, its two 64-column
        // atoms BOX_BYTES apart.
        const uint64_t da = TA ? attn::sw128_desc(as + wg * BOX_BYTES + kk * 16 * ROW_BYTES,
                                                  BOX_BYTES)
                               : attn::sw128_desc(as + wg * 64 * ROW_BYTES + kk * 32, 16);
        const uint64_t db = BT ? attn::sw128_desc(bs + kk * 16 * ROW_BYTES, BOX_BYTES)
                               : attn::sw128_desc(bs + kk * 32, 16);
        wgmma_m64n128<TA ? 1 : 0, BT ? 1 : 0>(acc, da, db);
      }
      attn::wgmma_commit();
      if (i > 0) {
        attn::wgmma_wait_n<1>();
        release(empty, i - 1, lane);
      }
    }
    attn::wgmma_wait();
    attn::pin(acc);
    if (nk > 0) release(empty, nk - 1, lane);
  }

  // int8: bf16's loop on the integer wgmma (k32 steps of 32 bytes, both
  // operands K-major).
  static __device__ __forceinline__ void mainloop_s8(int32_t (&acc)[64], const char* ring,
                                                     uint64_t* full, uint64_t* empty, int nk,
                                                     int wg, int lane) {
#pragma unroll 1
    for (int i = 0; i < nk; ++i) {
      const int st = i % STAGES;
      attn::mbar_wait(&full[st], (i / STAGES) & 1);
      const char* as = ring + st * STAGE_BYTES;
      const char* bs = as + A_BYTES;
      attn::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_m64n128_s8(acc, attn::sw128_desc(as + wg * 64 * ROW_BYTES + kk * 32, 16),
                         attn::sw128_desc(bs + kk * 32, 16));
      attn::wgmma_commit();
      if (i > 0) {
        attn::wgmma_wait_n<1>();
        release(empty, i - 1, lane);
      }
    }
    attn::wgmma_wait();
    pin_s32(acc);
    if (nk > 0) release(empty, nk - 1, lane);
  }

  // f32 as 3xTF32: warpgroup wg's 64 rows x warp w's 32 columns, four
  // m16n8k8 tiles each way, acc[4 (4 mi + ni) + i] the accumulator i of
  // row tile mi and column group ni.
  template <bool TA>
  static __device__ __forceinline__ void mainloop_tf32(float (&acc)[64], const char* ring,
                                                       uint64_t* full, uint64_t* empty, int nk,
                                                       int wg, int w, int lane) {
    const int g = lane / 4, t = lane % 4;
    const int r0 = wg * 64, n0 = w * 32;
    // Element (m, k) of A's and (k, n) of B's k tile.
    auto a_at = [&](const char* as, int m, int k) {
      return TA ? attn::lds_sw(as + (m / CW) * BOX_BYTES, k, m % CW) : attn::lds_sw(as, m, k);
    };
    auto b_at = [&](const char* bs, int k, int n) {
      return BT ? attn::lds_sw(bs + (n / CW) * BOX_BYTES, k, n % CW) : attn::lds_sw(bs, n, k);
    };
#pragma unroll 1
    for (int i = 0; i < nk; ++i) {
      const int st = i % STAGES;
      attn::mbar_wait(&full[st], (i / STAGES) & 1);
      const char* as = ring + st * STAGE_BYTES;
      const char* bs = as + A_BYTES;
#pragma unroll
      for (int kk = 0; kk < CW / 8; ++kk) {
        const int k = kk * 8 + t;
        uint32_t bh[4][2], bl[4][2];
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) {
          attn::split(b_at(bs, k, n0 + 8 * ni + g), bh[ni][0], bl[ni][0]);
          attn::split(b_at(bs, k + 4, n0 + 8 * ni + g), bh[ni][1], bl[ni][1]);
        }
#pragma unroll
        for (int mi = 0; mi < 4; ++mi) {
          const int r = r0 + 16 * mi + g;
          uint32_t ah[4], al[4];
          attn::split(a_at(as, r, k), ah[0], al[0]);
          attn::split(a_at(as, r + 8, k), ah[1], al[1]);
          attn::split(a_at(as, r, k + 4), ah[2], al[2]);
          attn::split(a_at(as, r + 8, k + 4), ah[3], al[3]);
#pragma unroll
          for (int ni = 0; ni < 4; ++ni)
            attn::mma3(&acc[4 * (4 * mi + ni)], ah, al, bh[ni][0], bh[ni][1], bl[ni][0],
                       bl[ni][1]);
        }
      }
      __syncwarp();
      release(empty, i, lane);
    }
  }
};

template <typename T, int BM, bool AT, bool BT, class Epi>
__global__ void __launch_bounds__(threads<BM>(), min_blocks<T>())
    gemm_kernel(const __grid_constant__ Params<Epi> p) {
  Gemm<T, BM, AT, BT, Epi>::run(p);
}

// ----------------------------------------------------------- host ----

// The tensor map of a [rows, cols] matrix of T (bf16, f32 or int8;
// row-major, 16-byte aligned rows): boxes of 128 bytes x box_rows rows
// (chunk<T>(), or a_box_rows for an int8 A at 64 rows), 128-byte swizzled,
// what lies past the rows or the columns arriving as zeros. One map serves
// an operand read K-major or MN-major.
template <typename T>
cudaError_t encode_matrix(CUtensorMap* map, const void* ptr, int rows, int cols,
                          int box_rows = chunk<T>()) {
  int pos[3];
  const long long ld = cols;
  const attn::View v{ptr, ld * rows, ld, ld, rows};
  const cudaError_t err = attn::encode<T>(map, pos, v, 1, 1, cols, box_rows);
  if (err != cudaSuccess) return err;
  return pos[0] == 1 ? cudaSuccess : cudaErrorInvalidValue;  // rows are the map's dimension 1
}

// C[M, N] = A[M, K] B[K, N], as ops/gemm_plan.py's GemmProduct and the
// plans built on it (mlp_plan, ln_linear_plan, int8_plan, patchify_plan)
// take it (where N is no multiple of BN, the last column tile's B rows past
// N arrive as zeros and its epilogue functor must skip the columns from N
// on); at: A is stored [K][M]. The launch's tile sets its tile counts.
template <class Epi>
cudaError_t problem(Problem<Epi>* pr, int M, int N, int K, const Epi& epi, bool at = false) {
  if (M < 1 || N < 1 || K < 1) return cudaErrorInvalidValue;
  pr->M = M;
  pr->N = N;
  pr->K = K;
  pr->n_fast = M >= N;
  pr->at = at;
  pr->epi = epi;
  return cudaSuccess;
}

// A launch's output tile, as ops/_blocks.py chose it: bm x bn.
struct Tile {
  int bm, bn;
};

// One launch of the first `count` problems of p (their maps and problems
// set; a problem with A stored [K][M] only where AT), their CTAs in order,
// on tiles of BM x BN.
template <typename T, int BM, bool AT, bool BT, class Epi>
cudaError_t run_tile(Params<Epi>& p, int count, cudaStream_t stream) {
  int blocks = 0;
  for (int i = 0; i < MAX_PROBLEMS; ++i) {
    Problem<Epi>& pr = p.prob[i];
    if (i < count && pr.at && !AT) return cudaErrorInvalidValue;
    if (i < count) {
      pr.tiles_m = (pr.M + BM - 1) / BM;
      pr.tiles_n = (pr.N + BN - 1) / BN;
      blocks += pr.tiles_m * pr.tiles_n;
    }
    p.ends[i] = blocks;
  }
  const cudaError_t err = attn::opt_in<gemm_kernel<T, BM, AT, BT, Epi>>();
  if (err != cudaSuccess) return err;
  gemm_kernel<T, BM, AT, BT, Epi><<<blocks, threads<BM>(), smem_bytes<T, BM>(), stream>>>(p);
  return cudaGetLastError();
}

// The same at `tile`: its compiled instance, or cudaErrorInvalidValue for a
// tile that is not compiled for T.
template <typename T, bool AT, bool BT, class Epi>
cudaError_t run(Params<Epi>& p, int count, Tile tile, cudaStream_t stream) {
  if (count < 1 || count > MAX_PROBLEMS || tile.bn != BN) return cudaErrorInvalidValue;
  switch (tile.bm) {
    case 64:
      if constexpr (compiled<T, 64>()) return run_tile<T, 64, AT, BT>(p, count, stream);
      break;
    case 128:
      return run_tile<T, 128, AT, BT>(p, count, stream);
  }
  return cudaErrorInvalidValue;
}

}  // namespace
}  // namespace gemm
}  // namespace gaviko
