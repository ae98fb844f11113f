// The PTX layer shared by the Hopper (sm_90a) flash-attention kernels,
// flash_attention_sm90.cu (head_dim 64 and 128) and flash_attention_d256.cu
// (head_dim 192 and 256): TMA tile loads into 128-byte-swizzled 64-column
// panels, mbarrier rings, wgmma descriptors and products, setmaxnreg, the
// masks and tile ranges, the delta pre-pass of the backward, and the
// host's tensor maps.  Each source includes it into its own anonymous
// namespace, so each library keeps its own copy.
#pragma once
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

extern __shared__ __align__(1024) unsigned char smem_raw[];

namespace {

using bf16 = __nv_bfloat16;

constexpr int THREADS = 384;        // producer + two consumer warpgroups
constexpr int STAGES = 2;
constexpr int PANEL = 64;           // bf16 columns of a 128-byte panel row
constexpr float LOG2E = 1.4426950408889634f;
constexpr float NEG_INF = -1e30f;   // the float32 route's empty-row max

// ---------------------------------------------------------------------------
// PTX wrappers
// ---------------------------------------------------------------------------
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(smem_u32(bar)) : "memory");
}

// Spins until the barrier's phase `parity` has completed.  A wait of
// about 10 s (2^34 cycles) traps, so a lost load fails the launch instead
// of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  long long start = 0;
  for (;;) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(addr), "r"(parity) : "memory");
    if (done) return;
    if (start == 0) start = clock64();
    else if (clock64() - start > (1ll << 34)) __trap();
  }
}

// rows x 64 bf16 box of a (B, S, heads, D) tensor at (d0, head, row0, b)
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int d0, int head,
                                         int row0, int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)),
         "r"(d0), "r"(head), "r"(row0), "r"(b), "r"(smem_u32(bar))
      : "memory");
}

// `bytes` contiguous bytes (a multiple of 16) from global memory
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n"
      :: "r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// a tile of `rows` rows and D columns as D / 64 panels
template <int D>
__device__ __forceinline__ void tma_tile(bf16* dst, const CUtensorMap* map,
                                         uint64_t* bar, int head, int row0,
                                         int b, int rows) {
#pragma unroll
  for (int p = 0; p < D / PANEL; ++p)
    tma_load(dst + p * rows * PANEL, map, bar, p * PANEL, head, row0, b);
}

template <int MAXREG> __device__ __forceinline__ void regs_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" :: "n"(MAXREG));
}
template <int MAXREG> __device__ __forceinline__ void regs_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(MAXREG));
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// waits for every product in flight, then pins the accumulators so no
// read of them is hoisted above the wait
template <int N>
__device__ __forceinline__ void wgmma_wait(float (&d)[N]) {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

// Shared-memory matrix descriptor, 128-byte swizzle.  K-major: rows of
// 128 bytes, 8-row groups `sbo` = 1,024 bytes apart (`lbo` unused).
// MN-major: 64-element blocks along N `lbo` bytes apart (one panel),
// 8-row groups along K `sbo` = 1,024 bytes apart.
__device__ __forceinline__ uint64_t desc(const void* p, uint32_t lbo,
                                         uint32_t sbo) {
  return (uint64_t)((smem_u32(p) & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}
// K step kk (16 columns) of a K-major tile of `rows` rows, from row r0
__device__ __forceinline__ uint64_t desc_k(const bf16* tile, int rows, int r0,
                                           int kk) {
  return desc(tile + (kk / 4) * rows * PANEL + r0 * PANEL + (kk % 4) * 16,
              16, 1024);
}
// K step kk (16 rows) of an MN-major tile of `rows` rows
__device__ __forceinline__ uint64_t desc_mn(const bf16* tile, int rows,
                                            int kk) {
  return desc(tile + kk * 16 * PANEL, rows * PANEL * 2, 1024);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// The f32 fragment of a 64 x N product becomes the bf16 A operand of the
// next one (K = N): k step kk takes accumulator registers 8 kk .. 8 kk + 7.
template <int N>
__device__ __forceinline__ void to_a_frag(const float (&s)[N],
                                          uint32_t (&a)[N / 2]) {
#pragma unroll
  for (int i = 0; i < N / 2; ++i) a[i] = pack_bf16(s[2 * i], s[2 * i + 1]);
}

// Accumulator element j of a thread: row 16 warp + lane / 4 + 8 half,
// column 8 (j / 4) + 2 (lane % 4) + (j % 2), half = (j / 2) % 2.
__device__ __forceinline__ int frag_col(int j, int lane) {
  return 8 * (j / 4) + 2 * (lane & 3) + (j & 1);
}
__device__ __forceinline__ int frag_half(int j) { return (j >> 1) & 1; }

__device__ __forceinline__ bool attendable(int qp, int kp, int S, int causal,
                                           int window) {
  if (qp >= S || kp >= S) return false;
  if (causal && kp > qp) return false;
  if (window > 0 && kp <= qp - window) return false;
  return true;
}

// A tile of queries [q0, q0 + nq) against keys [k0, k0 + nk) needs the
// mask only on the diagonal, at the window's edge and past S.
__device__ __forceinline__ bool needs_mask(int q0, int nq, int k0, int nk,
                                           int S, int causal, int window) {
  return (k0 + nk > S) || (q0 + nq > S) || (causal && k0 + nk - 1 > q0) ||
         (window > 0 && k0 <= q0 + nq - 1 - window);
}

// Keys [lo, lo + n * tile) a q tile [q0, q0 + rows) visits.
__device__ __forceinline__ int key_tiles(int q0, int rows, int tile, int S,
                                         int causal, int window, int& lo) {
  lo = window > 0 ? max(0, q0 - window + 1) / tile * tile : 0;
  const int hi = causal ? min(S, q0 + rows) : S;
  return (hi - lo + tile - 1) / tile;
}
// Queries [lo, lo + n * tile) that reach a key tile [k0, k0 + rows).
__device__ __forceinline__ int query_tiles(int k0, int rows, int tile, int S,
                                           int causal, int window, int& lo) {
  lo = causal ? k0 / tile * tile : 0;
  const int hi = window > 0 ? min(S, k0 + rows - 1 + window) : S;
  return (hi - lo + tile - 1) / tile;
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// ---------------------------------------------------------------------------
// wgmma: one 64 x N x 16 bf16 product of a warpgroup, f32 accumulate
// ---------------------------------------------------------------------------
// d (64 x 64) {+}= A (desc, K-major) * B (desc, K-major)
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t a, uint64_t b,
                                            int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(accumulate));
}

// d (64 x 128) {+}= A (desc, K-major) * B (desc, K-major)
__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t a, uint64_t b,
                                            int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(accumulate));
}

// d (64 x 64) += A (registers, 4 x bf16x2) * B (desc, MN-major)
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t* a,
                                            uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// d (64 x 128) += A (registers, 4 x bf16x2) * B (desc, MN-major)
__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t* a,
                                            uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Dynamic shared memory, its start rounded up to the 1,024 bytes that the
// 128-byte swizzle repeats over.
__device__ __forceinline__ bf16* smem_base() {
  const uint32_t pad = (1024u - (smem_u32(smem_raw) & 1023u)) & 1023u;
  return reinterpret_cast<bf16*>(smem_raw + pad);
}

// Stores rows r_lo, r_lo + 8 of a 64 x D f32 fragment, times `mul[half]`,
// as bf16 into rows of a (B, S, heads, D) tensor at `base`.
template <int D>
__device__ __forceinline__ void store_rows(bf16* out, const float (&acc)[D / 2],
                                           long long base, long long row_ss,
                                           int r_lo, int S, int lane,
                                           const float (&mul)[2]) {
#pragma unroll
  for (int j = 0; j < D / 2; j += 2) {
    const int hf = frag_half(j), row = r_lo + 8 * hf;
    if (row < S) {
      const uint32_t v = pack_bf16(acc[j] * mul[hf], acc[j + 1] * mul[hf]);
      *reinterpret_cast<uint32_t*>(out + base + row * row_ss +
                                   frag_col(j, lane)) = v;
    }
  }
}


// ---------------------------------------------------------------------------
// backward pre-pass: delta = rowsum(dO * O) and LSE * log2(e) into
// (B, H, Spad) float32, 0 past S; one warp a row
// ---------------------------------------------------------------------------
template <int D>
__global__ void delta_kernel(const bf16* __restrict__ o,
                             const bf16* __restrict__ dout,
                             const float* __restrict__ lse,
                             float* __restrict__ delta,
                             float* __restrict__ lse2, int S, int Spad,
                             int H, long long rows) {
  const long long w = ((long long)blockIdx.x * blockDim.x + threadIdx.x) / 32;
  const int lane = threadIdx.x % 32;
  if (w >= rows) return;
  const int s = (int)(w % Spad);
  const long long bh = w / Spad;
  float sum = 0.f, l2 = 0.f;
  if (s < S) {
    const long long b = bh / H, h = bh % H;
    const long long off = ((b * S + s) * H + h) * D;
#pragma unroll
    for (int d = 2 * lane; d < D; d += 64) {
      const float2 x = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(o + off + d));
      const float2 y = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(dout + off + d));
      sum += x.x * y.x + x.y * y.y;
    }
    sum = warp_sum(sum);
    l2 = lse[bh * S + s] * LOG2E;
  }
  if (lane == 0) {
    delta[w] = sum;
    lse2[w] = l2;
  }
}


// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled through the runtime's driver entry point, so the
// library needs no -lcuda.
cudaError_t encoder(EncodeTiled* fn) {
  static EncodeTiled cached = nullptr;
  if (cached == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess) return err;
    if (found != cudaDriverEntryPointSuccess || p == nullptr)
      return cudaErrorSymbolNotFound;
    cached = reinterpret_cast<EncodeTiled>(p);
  }
  *fn = cached;
  return cudaSuccess;
}

// Tensor map of a contiguous (B, S, heads, D) bf16 tensor whose box is
// 64 columns by `rows` rows of one head, 128-byte swizzle, zeros past S.
// It holds the base pointer, so it is built at every call.
cudaError_t make_map(CUtensorMap* map, const void* ptr, int B, int S,
                     int heads, int D, int rows) {
  EncodeTiled encode;
  const cudaError_t err = encoder(&encode);
  if (err != cudaSuccess) return err;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)heads,
                              (cuuint64_t)S, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)D * 2,
                                 (cuuint64_t)heads * D * 2,
                                 (cuuint64_t)S * heads * D * 2};
  const cuuint32_t box[4] = {(cuuint32_t)PANEL, 1, (cuuint32_t)rows, 1};
  const cuuint32_t step[4] = {1, 1, 1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims,
      strides, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

// (S rounded up to 128) rows of the delta / LSE * log2(e) scratch
int padded(int S) { return (S + 127) / 128 * 128; }

// Runs `body` with `device` current and hands the caller's device back.
template <typename F>
int on_device(int device, F body) {
  int prev = 0;
  cudaError_t err = cudaGetDevice(&prev);
  if (err != cudaSuccess) return (int)err;
  if (prev != device && (err = cudaSetDevice(device)) != cudaSuccess)
    return (int)err;
  err = body();
  if (prev != device) {
    const cudaError_t restored = cudaSetDevice(prev);
    if (err == cudaSuccess) err = restored;
  }
  return (int)err;
}

}  // namespace
