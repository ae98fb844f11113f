// Flash attention in bf16, forward and backward, for Hopper (sm_90a):
// TMA tile loads through mbarrier rings, wgmma products on the tensor
// cores, warp-specialised blocks.  Hand-written CUDA C++ with PTX inline.
//
// Replaces the Pallas TPU kernel `_kernel` launched by
// `flash_attention_pallas` (src/repro/kernels/flash_attention.py:28-69)
// for bf16 with head_dim 64 or 128: GQA self-attention (query head h
// reads kv head h / G) over q (B, S, H, D) and k/v (B, S, KH, D), causal
// and/or sliding-window masked, online softmax in float32, p rounded to
// bf16 after the tile's running max before the PV product, 0 for a row
// with no attendable key, and LSE = m + log(l) (B, H, S) float32 out.
// Its backward replaces XLA's autodiff of `blockwise_attention`
// (src/repro/models/attention.py) in the JAX package.  float32 and other
// head sizes go to flash_attention.cu (CUDA cores, float32 products).
//
// Bound.  At the training shape (B 2, S 4096, 16 / 8 heads, D 128,
// causal) attention does about S / 2 * 4 D operations a query row for
// 4 D bytes of q and o: some 2,000 operations a byte, far above the
// H100's 295, so it is bound by the tensor cores' 989 TFLOP/s (bf16).
// What the design does about it:
//   * every product is a `wgmma` (bf16 in, f32 accumulate): S = Q K^T
//     and dP = dO V^T read both operands from shared memory (K-major);
//     P V, P^T dO, dS^T Q and dS K take P / dS from registers (the f32
//     accumulator fragment of one product is the bf16 A fragment of the
//     next) and B from shared memory as MN-major through the
//     instruction's transpose bit, so nothing is transposed;
//   * tiles arrive by TMA (one thread issues, 128-byte swizzle, zero
//     fill past S) into 2-stage rings guarded by full / empty mbarriers,
//     so loads overlap the products;
//   * a block is one producer warpgroup (registers dropped to 24 with
//     setmaxnreg) and two consumer warpgroups of 64 rows (240 registers)
//     that keep their accumulators in registers for the whole loop;
//   * only diagonal, window-edge and ragged tiles are masked.
// A 128-wide bf16 row is 256 bytes and the 128-byte swizzle takes at
// most 128, so a tile is loaded as 64-column panels (rows x 128 bytes
// each); the descriptors step 32 bytes along K inside a panel (K-major,
// 8-row groups 1,024 bytes apart) and one panel along N (MN-major).
//
// Kernels (all deterministic: no atomics, fixed summation order):
//   fwd:   one block per (128-row q tile, h, b), q tiles in reverse so
//          the long causal rows start first; 128-key K / V stages.
//   delta: delta = rowsum(dO * O) and LSE * log2(e), once, (B, H, Spad).
//   dK/dV: one block per (128-key tile, kv head, b); loops over the G
//          query heads and the 64-row q tiles that reach its keys.
//   dQ:    one block per (128-row q tile, h, b); 64-key K / V stages.
// The backward runs 7 tile products where the bound counts 5 (dQ
// recomputes S and dP); the single-pass form is later work.
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
// forward: one block per (128-row q tile, h, b)
// ---------------------------------------------------------------------------
template <int D>
__global__ void __launch_bounds__(THREADS, 1)
    fwd_kernel(const __grid_constant__ CUtensorMap tq,
               const __grid_constant__ CUtensorMap tk,
               const __grid_constant__ CUtensorMap tv, bf16* __restrict__ o,
               float* __restrict__ lse, int S, int H, int KH, int causal,
               int window, float scale) {
  constexpr int BQ = 128, BK = 128, TILE = BQ * D;
  bf16* q_s = smem_base();
  bf16* kv_s = q_s + TILE;  // stage st: K at kv_s + 2 st TILE, V after it
  uint64_t* q_full = reinterpret_cast<uint64_t*>(kv_s + 2 * STAGES * TILE);
  uint64_t* k_full = q_full + 1;
  uint64_t* v_full = k_full + STAGES;
  uint64_t* empty = v_full + STAGES;

  const int nqt = (S + BQ - 1) / BQ;
  const int q0 = (nqt - 1 - blockIdx.x) * BQ, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / KH);
  int lo;
  const int n = key_tiles(q0, BQ, BK, S, causal, window, lo);

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int i = 0; i < STAGES; ++i) {
      mbar_init(&k_full[i], 1);
      mbar_init(&v_full[i], 1);
      mbar_init(&empty[i], 256);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {  // producer
    regs_dec<24>();
    if (threadIdx.x == 0) {
      mbar_expect_tx(q_full, TILE * 2);
      tma_tile<D>(q_s, &tq, q_full, h, q0, b, BQ);
      for (int it = 0; it < n; ++it) {
        const int st = it % STAGES, k0 = lo + it * BK;
        if (it >= STAGES) mbar_wait(&empty[st], (it / STAGES - 1) & 1);
        bf16* ks = kv_s + 2 * st * TILE;
        mbar_expect_tx(&k_full[st], TILE * 2);
        tma_tile<D>(ks, &tk, &k_full[st], kvh, k0, b, BK);
        mbar_expect_tx(&v_full[st], TILE * 2);
        tma_tile<D>(ks + TILE, &tv, &v_full[st], kvh, k0, b, BK);
      }
    }
  } else {  // consumers: rows qw0 .. qw0 + 63
    regs_inc<240>();
    const int cw = wg - 1, t = threadIdx.x % 128, lane = t % 32;
    const int qw0 = q0 + 64 * cw;
    const int r_lo = qw0 + 16 * (t / 32) + lane / 4;  // and r_lo + 8
    const float sl2 = scale * LOG2E;
    float acc[D / 2];
#pragma unroll
    for (int j = 0; j < D / 2; ++j) acc[j] = 0.f;
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

    mbar_wait(q_full, 0);
    for (int it = 0; it < n; ++it) {
      const int st = it % STAGES, k0 = lo + it * BK;
      const uint32_t par = (it / STAGES) & 1;
      const bf16* ks = kv_s + 2 * st * TILE;
      const bf16* vs = ks + TILE;

      float s[BK / 2];
      mbar_wait(&k_full[st], par);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss(s, desc_k(q_s, BQ, 64 * cw, kk), desc_k(ks, BK, 0, kk),
                 kk > 0);
      wgmma_commit();
      wgmma_wait(s);

      const bool mask = needs_mask(qw0, 64, k0, BK, S, causal, window);
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int j = 0; j < BK / 2; ++j) {
        float x = s[j] * sl2;
        if (mask && !attendable(r_lo + 8 * frag_half(j),
                                k0 + frag_col(j, lane), S, causal, window))
          x = -INFINITY;
        s[j] = x;
        mx[frag_half(j)] = fmaxf(mx[frag_half(j)], x);
      }
      float mu[2], alpha[2];
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const float m_new = fmaxf(m[hf], quad_max(mx[hf]));
        mu[hf] = m_new == -INFINITY ? 0.f : m_new;
        alpha[hf] = exp2f(m[hf] - mu[hf]);
        m[hf] = m_new;
        l[hf] *= alpha[hf];
      }
#pragma unroll
      for (int j = 0; j < BK / 2; ++j) {
        const float p = exp2f(s[j] - mu[frag_half(j)]);
        l[frag_half(j)] += p;
        s[j] = p;
      }
#pragma unroll
      for (int j = 0; j < D / 2; ++j) acc[j] *= alpha[frag_half(j)];
      uint32_t pa[BK / 4];
      to_a_frag(s, pa);

      mbar_wait(&v_full[st], par);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        wgmma_rs(acc, &pa[4 * kk], desc_mn(vs, BK, kk));
      wgmma_commit();
      wgmma_wait(acc);
      mbar_arrive(&empty[st]);
    }

    float inv[2];
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const float lc = fmaxf(quad_sum(l[hf]), 1e-30f);
      inv[hf] = 1.f / lc;
      const int row = r_lo + 8 * hf;
      if (row < S && lane % 4 == 0)
        lse[((long long)b * H + h) * S + row] =
            (m[hf] == -INFINITY ? NEG_INF : m[hf] / LOG2E) + logf(lc);
    }
    store_rows<D>(o, acc, ((long long)b * S * H + h) * D, (long long)H * D,
                  r_lo, S, lane, inv);
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
// backward, dK and dV: one block per (128-key tile, kv head, b)
// ---------------------------------------------------------------------------
template <int D>
__global__ void __launch_bounds__(THREADS, 1)
    dkdv_kernel(const __grid_constant__ CUtensorMap tq,
                const __grid_constant__ CUtensorMap tdo,
                const __grid_constant__ CUtensorMap tk,
                const __grid_constant__ CUtensorMap tv,
                const float* __restrict__ delta,
                const float* __restrict__ lse2, bf16* __restrict__ dk,
                bf16* __restrict__ dv, int S, int Spad, int H, int KH,
                int causal, int window, float scale) {
  constexpr int BK = 128, BQ = 64, KT = BK * D, QT = BQ * D;
  bf16* k_s = smem_base();
  bf16* v_s = k_s + KT;
  bf16* qd_s = v_s + KT;  // stage st: Q at qd_s + 2 st QT, dO after it
  float* stats = reinterpret_cast<float*>(qd_s + 2 * STAGES * QT);
  // stats + 2 st BQ: lse2 of stage st's rows, then their delta
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(stats + 2 * STAGES * BQ);
  uint64_t* full = kv_full + 1;
  uint64_t* empty = full + STAGES;

  const int k0 = blockIdx.x * BK, kvh = blockIdx.y, b = blockIdx.z;
  const int G = H / KH;
  int lo;
  const int nq = query_tiles(k0, BK, BQ, S, causal, window, lo);
  const int n = G * nq;

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int i = 0; i < STAGES; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], 256);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {  // producer
    regs_dec<24>();
    if (threadIdx.x == 0) {
      mbar_expect_tx(kv_full, 2 * KT * 2);
      tma_tile<D>(k_s, &tk, kv_full, kvh, k0, b, BK);
      tma_tile<D>(v_s, &tv, kv_full, kvh, k0, b, BK);
      for (int it = 0; it < n; ++it) {
        const int st = it % STAGES, h = kvh * G + it / nq;
        const int q0 = lo + (it % nq) * BQ;
        if (it >= STAGES) mbar_wait(&empty[st], (it / STAGES - 1) & 1);
        bf16* qs = qd_s + 2 * st * QT;
        float* sts = stats + 2 * st * BQ;
        const long long srow = ((long long)b * H + h) * Spad + q0;
        mbar_expect_tx(&full[st], 2 * QT * 2 + 2 * BQ * 4);
        tma_tile<D>(qs, &tq, &full[st], h, q0, b, BQ);
        tma_tile<D>(qs + QT, &tdo, &full[st], h, q0, b, BQ);
        bulk_load(sts, lse2 + srow, BQ * 4, &full[st]);
        bulk_load(sts + BQ, delta + srow, BQ * 4, &full[st]);
      }
    }
  } else {  // consumers: keys kw0 .. kw0 + 63
    regs_inc<240>();
    const int cw = wg - 1, t = threadIdx.x % 128, lane = t % 32;
    const int kw0 = k0 + 64 * cw;
    const int r_lo = kw0 + 16 * (t / 32) + lane / 4;  // and r_lo + 8
    const float sl2 = scale * LOG2E;
    float dk_acc[D / 2], dv_acc[D / 2];
#pragma unroll
    for (int j = 0; j < D / 2; ++j) dk_acc[j] = dv_acc[j] = 0.f;

    mbar_wait(kv_full, 0);
    for (int it = 0; it < n; ++it) {
      const int st = it % STAGES, q0 = lo + (it % nq) * BQ;
      const bf16* qs = qd_s + 2 * st * QT;
      const bf16* dos = qs + QT;
      const float* l2s = stats + 2 * st * BQ;
      const float* dls = l2s + BQ;

      float s[BQ / 2], dp[BQ / 2];
      mbar_wait(&full[st], (it / STAGES) & 1);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)  // S^T = K Q^T
        wgmma_ss(s, desc_k(k_s, BK, 64 * cw, kk), desc_k(qs, BQ, 0, kk),
                 kk > 0);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)  // dP^T = V dO^T
        wgmma_ss(dp, desc_k(v_s, BK, 64 * cw, kk), desc_k(dos, BQ, 0, kk),
                 kk > 0);
      wgmma_commit();
      wgmma_wait(s);
      wgmma_wait(dp);

      const bool mask = needs_mask(q0, BQ, kw0, 64, S, causal, window);
#pragma unroll
      for (int j = 0; j < BQ / 2; ++j) {
        const int c = frag_col(j, lane);
        float p = exp2f(s[j] * sl2 - l2s[c]);
        if (mask && !attendable(q0 + c, r_lo + 8 * frag_half(j), S, causal,
                                window))
          p = 0.f;
        s[j] = p;
        dp[j] = p * (dp[j] - dls[c]);  // dS^T
      }
      uint32_t pa[BQ / 4], da[BQ / 4];
      to_a_frag(s, pa);
      to_a_frag(dp, da);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk)  // dV += P^T dO
        wgmma_rs(dv_acc, &pa[4 * kk], desc_mn(dos, BQ, kk));
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk)  // dK += dS^T Q
        wgmma_rs(dk_acc, &da[4 * kk], desc_mn(qs, BQ, kk));
      wgmma_commit();
      wgmma_wait(dv_acc);
      wgmma_wait(dk_acc);
      mbar_arrive(&empty[st]);
    }

    const long long base = ((long long)b * S * KH + kvh) * D;
    const float one[2] = {1.f, 1.f}, sc[2] = {scale, scale};
    store_rows<D>(dk, dk_acc, base, (long long)KH * D, r_lo, S, lane, sc);
    store_rows<D>(dv, dv_acc, base, (long long)KH * D, r_lo, S, lane, one);
  }
}

// ---------------------------------------------------------------------------
// backward, dQ: one block per (128-row q tile, h, b)
// ---------------------------------------------------------------------------
template <int D>
__global__ void __launch_bounds__(THREADS, 1)
    dq_kernel(const __grid_constant__ CUtensorMap tq,
              const __grid_constant__ CUtensorMap tdo,
              const __grid_constant__ CUtensorMap tk,
              const __grid_constant__ CUtensorMap tv,
              const float* __restrict__ delta,
              const float* __restrict__ lse2, bf16* __restrict__ dq, int S,
              int Spad, int H, int KH, int causal, int window, float scale) {
  constexpr int BQ = 128, BK = 64, QT = BQ * D, KT = BK * D;
  bf16* q_s = smem_base();
  bf16* do_s = q_s + QT;
  bf16* kv_s = do_s + QT;  // stage st: K at kv_s + 2 st KT, V after it
  uint64_t* q_full = reinterpret_cast<uint64_t*>(kv_s + 2 * STAGES * KT);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + STAGES;

  const int nqt = (S + BQ - 1) / BQ;
  const int q0 = (nqt - 1 - blockIdx.x) * BQ, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / KH);
  int lo;
  const int n = key_tiles(q0, BQ, BK, S, causal, window, lo);

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int i = 0; i < STAGES; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], 256);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {  // producer
    regs_dec<24>();
    if (threadIdx.x == 0) {
      mbar_expect_tx(q_full, 2 * QT * 2);
      tma_tile<D>(q_s, &tq, q_full, h, q0, b, BQ);
      tma_tile<D>(do_s, &tdo, q_full, h, q0, b, BQ);
      for (int it = 0; it < n; ++it) {
        const int st = it % STAGES, k0 = lo + it * BK;
        if (it >= STAGES) mbar_wait(&empty[st], (it / STAGES - 1) & 1);
        bf16* ks = kv_s + 2 * st * KT;
        mbar_expect_tx(&full[st], 2 * KT * 2);
        tma_tile<D>(ks, &tk, &full[st], kvh, k0, b, BK);
        tma_tile<D>(ks + KT, &tv, &full[st], kvh, k0, b, BK);
      }
    }
  } else {  // consumers: rows qw0 .. qw0 + 63
    regs_inc<240>();
    const int cw = wg - 1, t = threadIdx.x % 128, lane = t % 32;
    const int qw0 = q0 + 64 * cw;
    const int r_lo = qw0 + 16 * (t / 32) + lane / 4;  // and r_lo + 8
    const float sl2 = scale * LOG2E;
    const long long srow = ((long long)b * H + h) * Spad;
    const float l2r[2] = {lse2[srow + r_lo], lse2[srow + r_lo + 8]};
    const float dlr[2] = {delta[srow + r_lo], delta[srow + r_lo + 8]};
    float dq_acc[D / 2];
#pragma unroll
    for (int j = 0; j < D / 2; ++j) dq_acc[j] = 0.f;

    mbar_wait(q_full, 0);
    for (int it = 0; it < n; ++it) {
      const int st = it % STAGES, k0 = lo + it * BK;
      const bf16* ks = kv_s + 2 * st * KT;
      const bf16* vs = ks + KT;

      float s[BK / 2], dp[BK / 2];
      mbar_wait(&full[st], (it / STAGES) & 1);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)  // S = Q K^T
        wgmma_ss(s, desc_k(q_s, BQ, 64 * cw, kk), desc_k(ks, BK, 0, kk),
                 kk > 0);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)  // dP = dO V^T
        wgmma_ss(dp, desc_k(do_s, BQ, 64 * cw, kk), desc_k(vs, BK, 0, kk),
                 kk > 0);
      wgmma_commit();
      wgmma_wait(s);
      wgmma_wait(dp);

      const bool mask = needs_mask(qw0, 64, k0, BK, S, causal, window);
#pragma unroll
      for (int j = 0; j < BK / 2; ++j) {
        const int hf = frag_half(j);
        float p = exp2f(s[j] * sl2 - l2r[hf]);
        if (mask && !attendable(r_lo + 8 * hf, k0 + frag_col(j, lane), S,
                                causal, window))
          p = 0.f;
        dp[j] = p * (dp[j] - dlr[hf]);  // dS
      }
      uint32_t da[BK / 4];
      to_a_frag(dp, da);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)  // dQ += dS K
        wgmma_rs(dq_acc, &da[4 * kk], desc_mn(ks, BK, kk));
      wgmma_commit();
      wgmma_wait(dq_acc);
      mbar_arrive(&empty[st]);
    }

    const float sc[2] = {scale, scale};
    store_rows<D>(dq, dq_acc, ((long long)b * S * H + h) * D,
                  (long long)H * D, r_lo, S, lane, sc);
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

// Dynamic shared memory of each kernel in bytes: the bf16 tiles, the
// stats, the barriers and 1,024 bytes to align the start.
constexpr size_t SLACK = 1024 + 64;
template <int D> constexpr size_t fwd_smem() {
  return (size_t)(128 * D + 2 * STAGES * 128 * D) * 2 + SLACK;
}
template <int D> constexpr size_t dkdv_smem() {
  return (size_t)(2 * 128 * D + 2 * STAGES * 64 * D) * 2 +
         2 * STAGES * 64 * 4 + SLACK;
}
template <int D> constexpr size_t dq_smem() {
  return (size_t)(2 * 128 * D + 2 * STAGES * 64 * D) * 2 + SLACK;
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

// (S rounded up to 128) rows of the delta / LSE * log2(e) scratch
int padded(int S) { return (S + 127) / 128 * 128; }

template <int D>
cudaError_t launch_fwd(const void* q, const void* k, const void* v, void* o,
                       void* lse, int B, int S, int H, int KH, int causal,
                       int window, float scale, cudaStream_t stream) {
  CUtensorMap tq, tk, tv;
  cudaError_t err = make_map(&tq, q, B, S, H, D, 128);
  if (err == cudaSuccess) err = make_map(&tk, k, B, S, KH, D, 128);
  if (err == cudaSuccess) err = make_map(&tv, v, B, S, KH, D, 128);
  if (err == cudaSuccess) err = allow_smem(fwd_kernel<D>, fwd_smem<D>());
  if (err != cudaSuccess) return err;
  fwd_kernel<D><<<dim3((S + 127) / 128, H, B), THREADS, fwd_smem<D>(),
                  stream>>>(tq, tk, tv, static_cast<bf16*>(o),
                            static_cast<float*>(lse), S, H, KH, causal,
                            window, scale);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_bwd(const void* q, const void* k, const void* v,
                       const void* o, const void* lse, const void* dout,
                       void* dq, void* dk, void* dv, void* stats, int B,
                       int S, int H, int KH, int causal, int window,
                       float scale, cudaStream_t stream) {
  const int Spad = padded(S);
  const long long rows = (long long)B * H * Spad;
  float* delta = static_cast<float*>(stats);
  float* lse2 = delta + rows;
  CUtensorMap tq64, tdo64, tq128, tdo128, tk64, tv64, tk128, tv128;
  cudaError_t err = make_map(&tq64, q, B, S, H, D, 64);
  if (err == cudaSuccess) err = make_map(&tdo64, dout, B, S, H, D, 64);
  if (err == cudaSuccess) err = make_map(&tq128, q, B, S, H, D, 128);
  if (err == cudaSuccess) err = make_map(&tdo128, dout, B, S, H, D, 128);
  if (err == cudaSuccess) err = make_map(&tk64, k, B, S, KH, D, 64);
  if (err == cudaSuccess) err = make_map(&tv64, v, B, S, KH, D, 64);
  if (err == cudaSuccess) err = make_map(&tk128, k, B, S, KH, D, 128);
  if (err == cudaSuccess) err = make_map(&tv128, v, B, S, KH, D, 128);
  if (err == cudaSuccess) err = allow_smem(dkdv_kernel<D>, dkdv_smem<D>());
  if (err == cudaSuccess) err = allow_smem(dq_kernel<D>, dq_smem<D>());
  if (err != cudaSuccess) return err;

  delta_kernel<D><<<(unsigned)((rows * 32 + 255) / 256), 256, 0, stream>>>(
      static_cast<const bf16*>(o), static_cast<const bf16*>(dout),
      static_cast<const float*>(lse), delta, lse2, S, Spad, H, rows);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  dkdv_kernel<D><<<dim3((S + 127) / 128, KH, B), THREADS, dkdv_smem<D>(),
                   stream>>>(tq64, tdo64, tk128, tv128, delta, lse2,
                             static_cast<bf16*>(dk), static_cast<bf16*>(dv),
                             S, Spad, H, KH, causal, window, scale);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  dq_kernel<D><<<dim3((S + 127) / 128, H, B), THREADS, dq_smem<D>(),
                 stream>>>(tq128, tdo128, tk64, tv64, delta, lse2,
                           static_cast<bf16*>(dq), S, Spad, H, KH, causal,
                           window, scale);
  return cudaGetLastError();
}

bool bad_shape(int B, int S, int H, int KH, int D) {
  return B <= 0 || S <= 0 || KH <= 0 || H % KH != 0 || (D != 64 && D != 128);
}

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

extern "C" {

// Both launch on `stream`, allocate nothing and do not synchronise.
// Every tensor is contiguous bf16: q, o, dout, dq (B, S, H, D); k, v, dk,
// dv (B, S, KH, D); lse (B, H, S) float32; D is 64 or 128.  `stats` is
// float32 scratch of 2 x B x H x (S rounded up to 128) elements.  causal:
// 0 or 1; window: 0 = none.  Return cudaGetLastError() (or the error
// that stopped the launch).
int flash_attention_sm90_fwd_launch(int device, const void* q, const void* k,
                                    const void* v, void* o, void* lse, int B,
                                    int S, int H, int KH, int D, int causal,
                                    int window, float scale, void* stream) {
  if (bad_shape(B, S, H, KH, D)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return on_device(device, [&]() {
    return D == 64 ? launch_fwd<64>(q, k, v, o, lse, B, S, H, KH, causal,
                                    window, scale, s)
                   : launch_fwd<128>(q, k, v, o, lse, B, S, H, KH, causal,
                                     window, scale, s);
  });
}

int flash_attention_sm90_bwd_launch(int device, const void* q, const void* k,
                                    const void* v, const void* o,
                                    const void* lse, const void* dout,
                                    void* dq, void* dk, void* dv, void* stats,
                                    int B, int S, int H, int KH, int D,
                                    int causal, int window, float scale,
                                    void* stream) {
  if (bad_shape(B, S, H, KH, D)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return on_device(device, [&]() {
    return D == 64
               ? launch_bwd<64>(q, k, v, o, lse, dout, dq, dk, dv, stats, B,
                                S, H, KH, causal, window, scale, s)
               : launch_bwd<128>(q, k, v, o, lse, dout, dq, dk, dv, stats, B,
                                 S, H, KH, causal, window, scale, s);
  });
}

const char* flash_attention_sm90_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
