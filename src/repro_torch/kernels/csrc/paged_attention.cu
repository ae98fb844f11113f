// Paged decode attention for Hopper (sm_90a), hand-written CUDA C++:
// split-K over pages (flash-decoding), then a combine pass.
//
// Replaces the Pallas TPU kernel `_kernel` launched by
// `paged_attention_pallas` in src/repro/kernels/paged_attention.py.  It
// computes what that kernel computes, not its grid: one query token per
// sequence attends over paged K/V pools (N, page, KH, D) through a flat
// (B, MAXP) int32 block table, with GQA groups (query head h reads kv
// head h / G), masking of unmapped (-1) pages, of positions >= length and
// of positions before an optional sliding window, and a softmax with
// float32 m / l / acc whose probabilities are rounded to the value dtype
// before the PV product.  A row with no attendable token returns 0.
//
// NDPage's two mechanisms, on this card:
//   * flattened table: one table read per page picks the physical page,
//     no directory walk (radix tables are translated before the launch);
//   * metadata bypass: a block reads its chunk's table entries and the
//     row's length from global memory straight into registers, all loads
//     issued together; the TPU's scalar prefetch has no counterpart to
//     stage, and the table never enters the shared memory that holds the
//     K/V pages.
//
// Design.  The TPU grid (B, KH, MAXP) walks pages in order and carries
// m / l / acc in VMEM scratch.  On this card a decode call moves little
// data (about 3 MB at the serving shape) and is bound by latency: one
// block per (sequence, kv head) walking its pages as a chain leaves most
// of the 132 SMs idle and puts a dependent table read and a DRAM round
// trip in front of every page.  So the work is cut along the pages:
//   split pass: grid (n_splits, KH, B).  Block (s, kh, b) owns table slots
//     [s * PPS, (s + 1) * PPS) of row b (PPS = pages_per_split, picked by
//     the host from MAXP and B * KH).  It reads those table entries and
//     the length at once, skips the unmapped slots (ids clamped to the
//     pool, as XLA's gather), issues 16-byte cp.async copies of all its K
//     and V pages together, and then computes the G x tokens scores (a
//     group of 8 lanes per token, 16-byte shared loads), the chunk's max
//     and sum per query head, P rounded to the value dtype against the
//     chunk's max, and P V (threads over D).  It writes float32 partials
//     m, l (G) and acc (G, D).  A chunk that lies past the row's length or
//     before its window writes m = -inf, l = 0 and exits.
//   combine pass: one block per (query head, sequence) merges the row's
//     splits in order: m = max m_i, out = sum e^(m_i - m) acc_i /
//     max(sum e^(m_i - m) l_i, 1e-30), skipping empty splits, so a row
//     with no attendable token gives 0.  With one split the split pass
//     writes the output itself and the combine does not run.
// No atomics: the result is deterministic.
//
// Bound.  Decode attention does 4 * H * D operations per attended token
// and reads 2 * KH * D values per token: far below the card's ratio of
// operations to bytes, so its bound is HBM bytes.  At serving sizes the
// call is still bound by latency (a table read, then the page copies,
// then the partials and the combine's launch); the G query heads of a
// block use CUDA cores (G = 2 for internlm2-1.8b: an m16 MMA would waste
// 7/8 of its rows), and pages are copied by cp.async, not TMA.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr float NEG_INF = -1e30f;
constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
constexpr int LANES_PER_TOKEN = 8;  // a token's scores: 8 lanes over D
constexpr int MAX_PPS = 8;          // pages a split may own
constexpr int G_CHUNK = 4;          // query heads accumulated in registers

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
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::);
}

// Dot product of a 16-byte piece of a K row (vec values of T) with the
// matching float32 query values.
__device__ __forceinline__ float piece_dot(const float* qv, const float4 raw,
                                           float) {
  return qv[0] * raw.x + qv[1] * raw.y + qv[2] * raw.z + qv[3] * raw.w;
}
__device__ __forceinline__ float piece_dot(const float* qv, const float4 raw,
                                           __nv_bfloat16) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    s += qv[2 * i] * f.x + qv[2 * i + 1] * f.y;
  }
  return s;
}

// Float words of shared memory before the K/V pages, rounded up so the
// pages start on a 16-byte boundary: q (G, D), p (G, PPS * page), m, l.
__host__ __device__ __forceinline__ int float_words(int G, int D, int tokens) {
  return (G * D + G * tokens + 2 * G + 3) & ~3;
}

template <typename T>
__global__ void __launch_bounds__(THREADS) paged_split_kernel(
    const T* __restrict__ q, const T* __restrict__ kp,
    const T* __restrict__ vp, const int* __restrict__ table,
    const int* __restrict__ lens, T* __restrict__ out,
    float* __restrict__ part, long long q_sb, long long q_sh, long long k_sn,
    long long k_sp, long long k_sh, long long v_sn, long long v_sp,
    long long v_sh, long long t_sb, long long o_sb, long long o_sh, int G,
    int D, int page, int maxp, int n_pages, int window, int pps, float scale) {
  const int split = blockIdx.x, kh = blockIdx.y, b = blockIdx.z;
  const int n_splits = gridDim.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int s0 = split * pps;  // first table slot of this split

  // metadata into registers: the length and the chunk's table entries,
  // all loads issued before any is used
  const int* row = table + b * t_sb;
  const int len = lens[b];
  int ids[MAX_PPS];
#pragma unroll
  for (int j = 0; j < MAX_PPS; ++j)
    ids[j] = (j < pps && s0 + j < maxp) ? row[s0 + j] : -1;

  // pages of the chunk that can hold attendable tokens: [p0, p1)
  const int lo = window > 0 ? max(0, len - window) : 0;
  const int p0 = max(s0, lo / page);
  const int p1 = min(min(s0 + pps, maxp), (len + page - 1) / page);

  // partials: m (G), l (G), acc (G, D) for each (b, kh, split)
  const long long slot = ((long long)b * gridDim.y + kh) * n_splits + split;
  float* m_out = part + slot * G * (D + 2);
  float* l_out = m_out + G;
  float* acc_out = l_out + G;

  if (p0 >= p1) {  // nothing attendable in this chunk (block-uniform)
    if (n_splits == 1) {
      for (int i = tid; i < G * D; i += THREADS) {
        const int g = i / D, d = i - g * D;
        out[b * o_sb + (long long)(kh * G + g) * o_sh + d] = from_f32<T>(0.f);
      }
    } else {
      for (int g = tid; g < G; g += THREADS) {
        m_out[g] = NEG_INF;
        l_out[g] = 0.f;
      }
    }
    return;
  }

  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int tokens = pps * page;  // slots of the chunk, in tokens
  float* q_s = reinterpret_cast<float*>(smem_raw);  // (G, D)
  float* p_s = q_s + G * D;                         // (G, tokens)
  float* m_s = p_s + G * tokens;                    // (G,)
  float* l_s = m_s + G;                             // (G,)
  // K pages then V pages, each (tokens, D); slot j at j * page * D
  T* k_s = reinterpret_cast<T*>(q_s + float_words(G, D, tokens));
  T* v_s = k_s + (size_t)tokens * D;

  // every K and V page of the chunk in flight at once
  const int vec = 16 / (int)sizeof(T);  // elements per 16-byte copy
  const int per_page = page * D / vec;  // copies per tensor per page
  unsigned mapped = 0;                  // bit j: slot s0 + j is mapped
#pragma unroll
  for (int j = 0; j < MAX_PPS; ++j) {
    const int p = s0 + j;
    if (p < p0 || p >= p1 || ids[j] < 0) continue;
    mapped |= 1u << j;
    const int phys = min(ids[j], n_pages - 1);  // clamp, as XLA's gather
    const T* kbase = kp + phys * k_sn + kh * k_sh;
    const T* vbase = vp + phys * v_sn + kh * v_sh;
    T* k_dst = k_s + (size_t)j * page * D;
    T* v_dst = v_s + (size_t)j * page * D;
    for (int c = tid; c < per_page; c += THREADS) {
      const int e = c * vec, t = e / D, d = e - t * D;
      cp_async16(k_dst + e, kbase + t * k_sp + d);
      cp_async16(v_dst + e, vbase + t * v_sp + d);
    }
  }
  for (int i = tid; i < G * D; i += THREADS) {
    const int g = i / D, d = i - g * D;
    q_s[i] = to_f32(q[b * q_sb + (long long)(kh * G + g) * q_sh + d]);
  }
  cp_async_wait_all();
  __syncthreads();

  // token t of the chunk (position s0 * page + t) is attendable
  auto valid = [&](int t) {
    const int pos = s0 * page + t;
    return ((mapped >> (t / page)) & 1u) && pos >= lo && pos < len;
  };

  // scores: a group of 8 lanes per token, 16-byte pieces of the K row
  const int t_first = (p0 - s0) * page, t_end = (p1 - s0) * page;
  const int sub = lane % LANES_PER_TOKEN;
  const int pieces = D / vec;
  for (int t0 = t_first + warp * (32 / LANES_PER_TOKEN); t0 < t_end;
       t0 += WARPS * (32 / LANES_PER_TOKEN)) {
    const int t = t0 + lane / LANES_PER_TOKEN;
    const bool ok = t < t_end && valid(t);
    for (int g = 0; g < G; ++g) {
      float part_dot = 0.f;
      if (ok)
        for (int c = sub; c < pieces; c += LANES_PER_TOKEN) {
          const float4 raw =
              *reinterpret_cast<const float4*>(k_s + (size_t)t * D + c * vec);
          part_dot += piece_dot(q_s + g * D + c * vec, raw, T());
        }
#pragma unroll
      for (int o = LANES_PER_TOKEN / 2; o > 0; o >>= 1)
        part_dot += __shfl_xor_sync(0xffffffffu, part_dot, o);
      if (sub == 0 && t < t_end)
        p_s[g * tokens + t] = ok ? part_dot * scale : NEG_INF;
    }
  }
  __syncthreads();

  // the chunk's max and sum per query head: one warp per head; P is
  // rounded to the value dtype against the chunk's max
  for (int g = warp; g < G; g += WARPS) {
    float mx = NEG_INF;
    for (int t = t_first + lane; t < t_end; t += 32)
      mx = fmaxf(mx, p_s[g * tokens + t]);
    mx = warp_max(mx);
    float sum = 0.f;
    for (int t = t_first + lane; t < t_end; t += 32) {
      const float e = valid(t) ? expf(p_s[g * tokens + t] - mx) : 0.f;
      sum += e;
      p_s[g * tokens + t] = to_f32(from_f32<T>(e));
    }
    sum = warp_sum(sum);
    if (lane == 0) {
      m_s[g] = mx;
      l_s[g] = sum;
    }
  }
  __syncthreads();

  // P V: threads over D, query heads in registers, the chunk's mapped
  // pages and their attendable tokens only
  for (int d = tid; d < D; d += THREADS) {
    for (int g0 = 0; g0 < G; g0 += G_CHUNK) {
      float acc[G_CHUNK];
#pragma unroll
      for (int j = 0; j < G_CHUNK; ++j) acc[j] = 0.f;
#pragma unroll
      for (int j = 0; j < MAX_PPS; ++j) {
        if (!((mapped >> j) & 1u)) continue;
        const int base = (s0 + j) * page;
        const int t_lo = j * page + max(lo - base, 0);
        const int t_hi = j * page + min(len - base, page);
        for (int t = t_lo; t < t_hi; ++t) {
          const float v = to_f32(v_s[(size_t)t * D + d]);
#pragma unroll
          for (int i = 0; i < G_CHUNK; ++i)
            if (g0 + i < G) acc[i] += p_s[(g0 + i) * tokens + t] * v;
        }
      }
#pragma unroll
      for (int i = 0; i < G_CHUNK; ++i) {
        const int g = g0 + i;
        if (g >= G) break;
        if (n_splits == 1)
          out[b * o_sb + (long long)(kh * G + g) * o_sh + d] =
              from_f32<T>(acc[i] / fmaxf(l_s[g], 1e-30f));
        else
          acc_out[g * D + d] = acc[i];
      }
    }
  }
  if (n_splits > 1)
    for (int g = tid; g < G; g += THREADS) {
      m_out[g] = m_s[g];
      l_out[g] = l_s[g];
    }
}

// One block per (query head, sequence): merge the row's splits in order.
template <typename T>
__global__ void __launch_bounds__(THREADS) paged_combine_kernel(
    const float* __restrict__ part, T* __restrict__ out, long long o_sb,
    long long o_sh, int KH, int G, int D, int n_splits) {
  const int h = blockIdx.x, b = blockIdx.y;
  const int kh = h / G, g = h - kh * G;
  const long long stride = (long long)G * (D + 2);  // floats per split
  const float* base = part + ((long long)b * KH + kh) * n_splits * stride;
  float m = NEG_INF;
  for (int s = 0; s < n_splits; ++s) m = fmaxf(m, base[s * stride + g]);
  for (int d = threadIdx.x; d < D; d += THREADS) {
    float num = 0.f, den = 0.f;
    for (int s = 0; s < n_splits; ++s) {
      const float* p = base + s * stride;
      const float m_i = p[g];
      if (m_i <= NEG_INF / 2) continue;  // empty split: acc not written
      const float w = expf(m_i - m);
      num += w * p[2 * G + g * D + d];
      den += w * p[G + g];
    }
    out[b * o_sb + (long long)h * o_sh + d] = from_f32<T>(num / fmaxf(den,
                                                                      1e-30f));
  }
}

template <typename T>
cudaError_t launch(const void* q, const void* kp, const void* vp,
                   const void* table, const void* lens, void* out,
                   void* part, long long q_sb, long long q_sh, long long k_sn,
                   long long k_sp, long long k_sh, long long v_sn,
                   long long v_sp, long long v_sh, long long t_sb,
                   long long o_sb, long long o_sh, int B, int KH, int G,
                   int D, int page, int maxp, int n_pages, int window,
                   int pps, float scale, cudaStream_t stream) {
  // every 16-byte copy and load must start on a 16-byte boundary
  const long long vec = 16 / sizeof(T);
  if ((D % vec) || (k_sn % vec) || (k_sp % vec) || (k_sh % vec) ||
      (v_sn % vec) || (v_sp % vec) || (v_sh % vec) ||
      (reinterpret_cast<unsigned long long>(kp) % 16) ||
      (reinterpret_cast<unsigned long long>(vp) % 16))
    return cudaErrorMisalignedAddress;
  if (pps < 1 || pps > MAX_PPS) return cudaErrorInvalidValue;
  const int n_splits = (maxp + pps - 1) / pps;
  if (n_splits > 1 && part == nullptr) return cudaErrorInvalidValue;
  // above 48 KB only after opting in; past the card's limit the
  // attribute call fails and the error goes back to the wrapper
  const int tokens = pps * page;
  const size_t smem = sizeof(float) * float_words(G, D, tokens) +
                      2 * sizeof(T) * (size_t)tokens * D;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        paged_split_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return err;
  }
  paged_split_kernel<T><<<dim3(n_splits, KH, B), THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kp),
      static_cast<const T*>(vp), static_cast<const int*>(table),
      static_cast<const int*>(lens), static_cast<T*>(out),
      static_cast<float*>(part), q_sb, q_sh, k_sn, k_sp, k_sh, v_sn, v_sp,
      v_sh, t_sb, o_sb, o_sh, G, D, page, maxp, n_pages, window, pps, scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || n_splits == 1) return err;
  paged_combine_kernel<T><<<dim3(KH * G, B), THREADS, 0, stream>>>(
      static_cast<const float*>(part), static_cast<T*>(out), o_sb, o_sh, KH,
      G, D, n_splits);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Launches on `stream`, allocates nothing, does not synchronise.
// dtype: 0 = float32, 1 = bfloat16.  Strides are in elements; the last
// dimension of every tensor is contiguous, and head_dim times the
// element size is a multiple of 16 bytes.  `part` is float32 scratch of
// B * KH * ceil(maxp / pps) * G * (D + 2) words (unused, and may be null,
// when pps >= maxp).  Returns cudaGetLastError().
int paged_attention_launch(
    int device, const void* q, const void* kp, const void* vp,
    const void* table, const void* lens, void* out, void* part,
    long long q_sb, long long q_sh, long long k_sn, long long k_sp,
    long long k_sh, long long v_sn, long long v_sp, long long v_sh,
    long long t_sb, long long o_sb, long long o_sh, int B, int H, int KH,
    int D, int page, int maxp, int n_pages, int window, int pps, float scale,
    int dtype, void* stream) {
  if (B <= 0 || KH <= 0 || H % KH != 0 || D <= 0 || page <= 0 || maxp <= 0)
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
    err = launch<float>(q, kp, vp, table, lens, out, part, q_sb, q_sh, k_sn,
                        k_sp, k_sh, v_sn, v_sp, v_sh, t_sb, o_sb, o_sh, B, KH,
                        G, D, page, maxp, n_pages, window, pps, scale, s);
  else if (dtype == 1)
    err = launch<__nv_bfloat16>(q, kp, vp, table, lens, out, part, q_sb, q_sh,
                                k_sn, k_sp, k_sh, v_sn, v_sp, v_sh, t_sb, o_sb,
                                o_sh, B, KH, G, D, page, maxp, n_pages, window,
                                pps, scale, s);
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
