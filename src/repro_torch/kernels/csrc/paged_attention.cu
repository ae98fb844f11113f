// Paged decode attention for Hopper (sm_90a), hand-written CUDA C++.
//
// Replaces the Pallas TPU kernel `_kernel` launched by
// `paged_attention_pallas` in src/repro/kernels/paged_attention.py.  It
// computes what that kernel computes, not its grid: one query token per
// sequence attends over paged K/V pools (N, page, KH, D) through a flat
// (B, MAXP) int32 block table, with GQA groups (query head h reads kv
// head h / G), masking of unmapped (-1) pages, of positions >= length and
// of positions before an optional sliding window, and an online softmax
// with float32 m / l / acc.  A row with no attendable token returns 0.
//
// NDPage's two mechanisms, on this card:
//   * flattened table: one table read per page picks the physical page,
//     no directory walk (radix tables are translated before the launch);
//   * metadata bypass: each block reads its own table row and length
//     from global memory into registers; the TPU's scalar prefetch has
//     no counterpart to stage, and the table never enters the shared
//     memory that holds the K/V pages.
//
// Design.  The TPU grid (B, KH, MAXP) walks pages in order and carries
// m / l / acc in VMEM scratch.  Here one block of 128 threads owns one
// (sequence, kv head) and loops over pages itself, keeping q, acc and
// the page's scores in shared memory.  It visits only the mapped pages
// that can hold attendable tokens, [max(0, len - window) / page,
// ceil(len / page)): the Pallas kernel sweeps all MAXP pages (clamping -1
// to page 0) and masks them, which gives the same result from more bytes.
// K and V pages are staged in shared memory by 16-byte cp.async copies,
// double-buffered: the next mapped page is in flight while the current
// one is computed.  Per page: one warp per token forms the G scores
// (lanes over D, a shuffle reduction); one warp per query head updates
// m and l and rounds the probabilities to the value dtype (as the TPU
// kernel casts before its PV product, so bf16 rounding matches); threads
// over D accumulate P V into acc.
//
// Bound.  Decode attention does 4 * H * D flops per attended token and
// reads 2 * KH * D values per token: far below the card's ratio of
// operations to bytes, so it is bound by HBM bytes (the K and V pages
// read).  What this design leaves on the table: only B * KH blocks run,
// which leaves most of the 132 SMs idle at small batch, and a long row
// is one serial chain of pages (no split-K over pages, flash-decoding
// style); one page is in flight per block (no deeper pipeline or TMA);
// the G query heads of a block use CUDA cores, not tensor cores.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr float NEG_INF = -1e30f;
constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
constexpr int G_CHUNK = 4;  // query heads accumulated in registers at once

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as XLA's convert
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// 16-byte global -> shared copy that does not block the thread
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned dst =
      static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
// wait until at most one committed group is still in flight
__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

// Float words of shared memory before the K/V buffers, rounded up so the
// buffers start on a 16-byte boundary.
__host__ __device__ __forceinline__ int float_words(int G, int D, int page) {
  return (2 * G * D + G * page + 3 * G + 3) & ~3;
}

template <typename T>
__global__ void __launch_bounds__(THREADS) paged_attention_kernel(
    const T* __restrict__ q, const T* __restrict__ kp,
    const T* __restrict__ vp, const int* __restrict__ table,
    const int* __restrict__ lens, T* __restrict__ out, long long q_sb,
    long long q_sh, long long k_sn, long long k_sp, long long k_sh,
    long long v_sn, long long v_sp, long long v_sh, long long t_sb,
    long long o_sb, long long o_sh, int G, int D, int page, int maxp,
    int n_pages, int window, float scale) {
  const int kh = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* q_s = reinterpret_cast<float*>(smem_raw);  // (G, D)
  float* acc_s = q_s + G * D;                       // (G, D)
  float* p_s = acc_s + G * D;                       // (G, page)
  float* m_s = p_s + G * page;                      // (G,)
  float* l_s = m_s + G;                             // (G,)
  float* alpha_s = l_s + G;                         // (G,)
  // two buffers, each K (page, D) then V (page, D)
  T* kv_s = reinterpret_cast<T*>(q_s + float_words(G, D, page));
  const int tile = page * D;

  for (int i = tid; i < G * D; i += THREADS) {
    const int g = i / D, d = i - g * D;
    q_s[i] = to_f32(q[b * q_sb + (long long)(kh * G + g) * q_sh + d]);
    acc_s[i] = 0.f;
  }
  for (int g = tid; g < G; g += THREADS) {
    m_s[g] = NEG_INF;
    l_s[g] = 0.f;
  }

  const int len = lens[b];
  const int lo = window > 0 ? max(0, len - window) : 0;
  const int p_end = min(maxp, (len + page - 1) / page);
  const int* row = table + b * t_sb;
  // next mapped page at or after p (p_end if none); block-uniform
  auto next_mapped = [&](int p) {
    while (p < p_end && row[p] < 0) ++p;
    return p;
  };
  const int vec = 16 / (int)sizeof(T);  // elements per 16-byte copy
  const int chunks = tile / vec;        // per tensor per page
  auto stage = [&](int p, int buf) {
    const int phys = min(row[p], n_pages - 1);  // clamp, as XLA's gather
    const T* kbase = kp + phys * k_sn + kh * k_sh;
    const T* vbase = vp + phys * v_sn + kh * v_sh;
    T* k_dst = kv_s + buf * 2 * tile;
    T* v_dst = k_dst + tile;
    for (int c = tid; c < chunks; c += THREADS) {
      const int e = c * vec, t = e / D, d = e - t * D;
      cp_async16(k_dst + e, kbase + t * k_sp + d);
      cp_async16(v_dst + e, vbase + t * v_sp + d);
    }
  };

  int p = next_mapped(lo / page);
  if (p < p_end) stage(p, 0);
  cp_async_commit();
  __syncthreads();

  for (int buf = 0; p < p_end; buf ^= 1) {
    const int p_next = next_mapped(p + 1);
    if (p_next < p_end) stage(p_next, buf ^ 1);
    cp_async_commit();
    cp_async_wait_one();  // this page's copies have landed
    __syncthreads();

    const T* k_s = kv_s + buf * 2 * tile;
    const T* v_s = k_s + tile;
    const int t_lo = max(lo - p * page, 0);      // attendable tokens of
    const int t_hi = min(len - p * page, page);  // this page: [t_lo, t_hi)

    // scores: one warp per token (warp-uniform validity), lanes over D
    for (int t = warp; t < page; t += WARPS) {
      const bool valid = t >= t_lo && t < t_hi;
      for (int g = 0; g < G; ++g) {
        float s = NEG_INF;
        if (valid) {
          float part = 0.f;
          for (int d = lane; d < D; d += 32)
            part += q_s[g * D + d] * to_f32(k_s[t * D + d]);
          s = warp_sum(part) * scale;
        }
        if (lane == 0) p_s[g * page + t] = s;
      }
    }
    __syncthreads();

    // online softmax: one warp per query head
    for (int g = warp; g < G; g += WARPS) {
      float mx = NEG_INF;
      for (int t = lane; t < page; t += 32) mx = fmaxf(mx, p_s[g * page + t]);
      mx = warp_max(mx);
      const float m_prev = m_s[g];
      const float m_new = fmaxf(m_prev, mx);
      const float alpha = m_prev > NEG_INF / 2 ? expf(m_prev - m_new) : 0.f;
      float sum = 0.f;
      for (int t = lane; t < page; t += 32) {
        const bool valid = t >= t_lo && t < t_hi;
        const float e = valid ? expf(p_s[g * page + t] - m_new) : 0.f;
        sum += e;
        p_s[g * page + t] = to_f32(from_f32<T>(e));
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        m_s[g] = m_new;
        l_s[g] = l_s[g] * alpha + sum;
        alpha_s[g] = alpha;
      }
    }
    __syncthreads();

    // acc = acc * alpha + P V: threads over D, query heads in registers
    for (int d = tid; d < D; d += THREADS) {
      for (int g0 = 0; g0 < G; g0 += G_CHUNK) {
        float part[G_CHUNK];
#pragma unroll
        for (int j = 0; j < G_CHUNK; ++j) part[j] = 0.f;
        for (int t = t_lo; t < t_hi; ++t) {
          const float v = to_f32(v_s[t * D + d]);
#pragma unroll
          for (int j = 0; j < G_CHUNK; ++j)
            if (g0 + j < G) part[j] += p_s[(g0 + j) * page + t] * v;
        }
#pragma unroll
        for (int j = 0; j < G_CHUNK; ++j)
          if (g0 + j < G) {
            float& a = acc_s[(g0 + j) * D + d];
            a = a * alpha_s[g0 + j] + part[j];
          }
      }
    }
    __syncthreads();  // buffer `buf` is free for the copy after next
    p = p_next;
  }

  for (int i = tid; i < G * D; i += THREADS) {
    const int g = i / D, d = i - g * D;
    out[b * o_sb + (long long)(kh * G + g) * o_sh + d] =
        from_f32<T>(acc_s[i] / fmaxf(l_s[g], 1e-30f));
  }
}

template <typename T>
cudaError_t launch(const void* q, const void* kp, const void* vp,
                   const void* table, const void* lens, void* out,
                   long long q_sb, long long q_sh, long long k_sn,
                   long long k_sp, long long k_sh, long long v_sn,
                   long long v_sp, long long v_sh, long long t_sb,
                   long long o_sb, long long o_sh, int B, int KH, int G,
                   int D, int page, int maxp, int n_pages, int window,
                   float scale, cudaStream_t stream) {
  // every 16-byte copy must start on a 16-byte boundary
  const long long vec = 16 / sizeof(T);
  if ((D % vec) || (k_sn % vec) || (k_sp % vec) || (k_sh % vec) ||
      (v_sn % vec) || (v_sp % vec) || (v_sh % vec) ||
      (reinterpret_cast<unsigned long long>(kp) % 16) ||
      (reinterpret_cast<unsigned long long>(vp) % 16))
    return cudaErrorMisalignedAddress;
  // above 48 KB only after opting in; past the card's limit the
  // attribute call fails and the error goes back to the wrapper
  const size_t smem = sizeof(float) * float_words(G, D, page) +
                      4 * sizeof(T) * (size_t)page * D;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        paged_attention_kernel<T>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid(KH, B);
  paged_attention_kernel<T><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kp),
      static_cast<const T*>(vp), static_cast<const int*>(table),
      static_cast<const int*>(lens), static_cast<T*>(out), q_sb, q_sh, k_sn,
      k_sp, k_sh, v_sn, v_sp, v_sh, t_sb, o_sb, o_sh, G, D, page, maxp,
      n_pages, window, scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Launches on `stream`, allocates nothing, does not synchronise.
// dtype: 0 = float32, 1 = bfloat16.  Strides are in elements; the last
// dimension of every tensor is contiguous, and head_dim times the
// element size is a multiple of 16 bytes.  Returns cudaGetLastError().
int paged_attention_launch(
    int device, const void* q, const void* kp, const void* vp,
    const void* table, const void* lens, void* out, long long q_sb,
    long long q_sh, long long k_sn, long long k_sp, long long k_sh,
    long long v_sn, long long v_sp, long long v_sh, long long t_sb,
    long long o_sb, long long o_sh, int B, int H, int KH, int D, int page,
    int maxp, int n_pages, int window, float scale, int dtype,
    void* stream) {
  if (B <= 0 || KH <= 0 || H % KH != 0 || D <= 0 || page <= 0)
    return (int)cudaErrorInvalidValue;
  // launch on q's device and hand the caller's current device back
  int prev = 0;
  cudaError_t err = cudaGetDevice(&prev);
  if (err != cudaSuccess) return (int)err;
  if (prev != device && (err = cudaSetDevice(device)) != cudaSuccess)
    return (int)err;
  const int G = H / KH;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    err = launch<float>(q, kp, vp, table, lens, out, q_sb, q_sh, k_sn, k_sp,
                        k_sh, v_sn, v_sp, v_sh, t_sb, o_sb, o_sh, B, KH, G, D,
                        page, maxp, n_pages, window, scale, s);
  else if (dtype == 1)
    err = launch<__nv_bfloat16>(q, kp, vp, table, lens, out, q_sb, q_sh, k_sn,
                                k_sp, k_sh, v_sn, v_sp, v_sh, t_sb, o_sb, o_sh,
                                B, KH, G, D, page, maxp, n_pages, window, scale,
                                s);
  else
    err = cudaErrorInvalidValue;
  if (prev != device) {
    const cudaError_t restored = cudaSetDevice(prev);
    if (err == cudaSuccess) err = restored;
  }
  return (int)err;
}

const char* paged_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
