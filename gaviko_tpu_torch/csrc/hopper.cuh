// Hopper building blocks of the attention kernels: kernel A and B10's
// forward tile (csrc/attention_fwd.cuh) and kernel B, the MHSA backward
// (csrc/fused_mhsa_bwd.cu). mbarriers, TMA loads of 128-byte-swizzled chunk
// tiles, wgmma with operands in shared memory or registers and its
// shared-memory descriptors, 3xTF32 on mma.sync m16n8k8 for f32, and the
// host's rank-4 tensor maps (cuTensorMapEncodeTiled, found through the
// runtime, so nothing links libcuda).
//
// A chunk tile is rows x 128 bytes of one [B, H, rows, D] operand (64 bf16
// or 32 f32 columns), swizzled at 128 bytes: K-major for wgmma as stored,
// MN-major through the transpose bit, and conflict-free for the f32
// fragment loads (lds_sw).
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
constexpr int RING_BYTES = 65536;  // a ring of chunk tiles in flight
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
// Until at most N of the committed wgmma groups are pending (they complete
// in order).
template <int N>
__device__ __forceinline__ void wgmma_wait_n() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Pins accumulator registers at this point of the program, so the compiler
// moves no access to them across an asynchronous wgmma's issue or wait.
template <int N>
__device__ __forceinline__ void pin(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
// The same for the packed A fragments an asynchronous wgmma reads from
// registers: they stay live, and unchanged, until its wait.
template <int N>
__device__ __forceinline__ void pin(uint32_t (&a)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(a[i][j])::"memory");
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

// x * mult rounded to T, in place, over `bytes` bytes of chunk tiles at
// `tiles` (the swizzle is moot), by the N consumer threads (threadIdx.x <
// N); the generic-proxy stores are then fenced for wgmma's async-proxy
// reads and the N threads meet at named barrier 1.
template <typename T, int N>
__device__ __forceinline__ void scale_tiles(char* tiles, int bytes, float mult) {
  for (int i = threadIdx.x; i < bytes / 16; i += N) {
    uint4* ptr = reinterpret_cast<uint4*>(tiles) + i;
    uint4 x = *ptr;
    if constexpr (is_bf16<T>()) {
      __nv_bfloat162* e = reinterpret_cast<__nv_bfloat162*>(&x);
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const float2 f = __bfloat1622float2(e[k]);
        e[k] = __floats2bfloat162_rn(f.x * mult, f.y * mult);
      }
    } else {
      float* e = reinterpret_cast<float*>(&x);
#pragma unroll
      for (int k = 0; k < 4; ++k) e[k] *= mult;
    }
    *ptr = x;
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  asm volatile("bar.sync 1, %0;\n" ::"n"(N) : "memory");
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

// The box of chunk tile (col, row) of plane (h, b) of a tensor map whose
// dimensions 1..3 hold rows, heads and batch in the order pos gives (pos[i]
// the map dimension of rows, heads, batch), into dst; completion counted on
// bar.
__device__ __forceinline__ void load_tile(char* dst, const CUtensorMap* map, const int* pos,
                                          int col, int row, int h, int b, uint64_t* bar) {
  const int c1 = pos[0] == 1 ? row : pos[1] == 1 ? h : b;
  const int c2 = pos[0] == 2 ? row : pos[1] == 2 ? h : b;
  const int c3 = pos[0] == 3 ? row : pos[1] == 3 ? h : b;
  tma_load(dst, map, col, c1, c2, c3, bar);
}

// s (a warpgroup's 64 rows, or in f32 this warp's 16 rows wr.., times 8 SJ
// columns, in the accumulator layout: row 16 warp + g (+8), columns 8 j + 2 t
// (+1)) += the rows of chunk tile at times the first 8 SJ rows of chunk tile
// bt, transposed: both tiles K-major as stored. bf16: the warpgroup's wgmma
// (m64n64 or m64n128), committed, which the caller waits for; f32: 3xTF32
// on mma.sync m16n8k8.
template <typename T, int SJ>
__device__ __forceinline__ void s_product(float (&s)[SJ * 4], const char* at, const char* bt,
                                          int wr, int g, int t) {
  static_assert(SJ == 8 || SJ == 16, "64 or 128 columns");
  if constexpr (is_bf16<T>()) {
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint64_t da = sw128_desc(at + kk * 32, 16), db = sw128_desc(bt + kk * 32, 16);
      if constexpr (SJ == 16)
        wgmma_ss_n128(s, da, db, 1);
      else
        wgmma_ss_n64(s, da, db, 1);
    }
    wgmma_commit();
  } else {
#pragma unroll
    for (int kk = 0; kk < ROW_BYTES / 32; ++kk) {
      uint32_t ah[4], al[4];
      split(lds_sw(at, wr + g, kk * 8 + t), ah[0], al[0]);
      split(lds_sw(at, wr + g + 8, kk * 8 + t), ah[1], al[1]);
      split(lds_sw(at, wr + g, kk * 8 + t + 4), ah[2], al[2]);
      split(lds_sw(at, wr + g + 8, kk * 8 + t + 4), ah[3], al[3]);
#pragma unroll
      for (int j = 0; j < SJ; ++j) {
        uint32_t bh0, bl0, bh1, bl1;
        split(lds_sw(bt, 8 * j + g, kk * 8 + t), bh0, bl0);
        split(lds_sw(bt, 8 * j + g, kk * 8 + t + 4), bh1, bl1);
        mma3(&s[4 * j], ah, al, bh0, bh1, bl0, bl1);
      }
    }
  }
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

// Makes a context current on this thread, once a thread: the runtime's
// primary context of its current device. A thread that has made no runtime
// call yet (autograd's backward thread, a fresh Python thread, whose
// PyTorch calls may reach no runtime call) has none, and the tensor-map
// encode below is a driver call that needs one.
cudaError_t bind_context() {
  static thread_local bool bound = false;
  if (bound) return cudaSuccess;
  const cudaError_t err = cudaFree(nullptr);
  bound = err == cudaSuccess;
  return err;
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
  const cudaError_t bound = bind_context();
  if (bound != cudaSuccess) return bound;
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
  const CUtensorMapDataType type = es == 1   ? CU_TENSOR_MAP_DATA_TYPE_UINT8  // int8 codes
                                   : es == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                                             : CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
  const CUresult r = enc(map, type, 4, const_cast<void*>(x.ptr), dims, strides, box, unit,
                         CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                         CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// Opts kernel K in to SMEM_LIMIT bytes of dynamic shared memory, once a
// device (it is a host call of its own on every launch otherwise).
template <auto K>
cudaError_t opt_in() {
  static std::atomic<unsigned long long> opted{0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  const unsigned long long bit = 1ull << (dev % 64);
  if (err == cudaSuccess && !(opted.load() & bit)) {
    err = cudaFuncSetAttribute(K, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_LIMIT);
    if (err == cudaSuccess) opted |= bit;
  }
  return err;
}

}  // namespace
}  // namespace attn
}  // namespace gaviko
