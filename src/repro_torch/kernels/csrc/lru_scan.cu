// The translation simulator's LRU hit-extraction scan for Hopper (sm_90a),
// hand-written CUDA C++.
//
// Replaces the per-step body of the JAX simulator's serial scan:
// `_build_model`'s `access` / `per_mc` / `make_step` in
// src/repro/sim/simulator.py (:429-556), run by `jax.lax.scan` in
// `_chunk_runner` (:793, :835).  Not a Pallas kernel, but the simulator's
// whole serial hot loop; the plain version and specification is
// `lru_scan_ref` in src/repro_torch/kernels/ref.py.
//
// What it computes, for each trace step t, lane l (the fused
// simulations x cores axis) and mechanism m, in program order:
//   * the L1-DTLB and L2-TLB lookups on tlb_key: a huge-page mechanism
//     uses (vpn >> 9) | (1 << 26) where the region is not 4K-fragmented;
//     a segment mechanism skips in-segment accesses;
//   * the cache-as-TLB probe after an L2-TLB miss, on machines with one;
//   * four per-level PWC lookups: set = level, tag = line + 1;
//   * per hierarchy level (l1, or l1/l2/l3), five lookups: pte0..pte3,
//     then the data line; a lower level is looked up on a miss above, and
//     bypassing mechanisms skip the PTE lines.
// Each lookup is a set-associative LRU hit plus fill: set = key % sets,
// tag = key / sets + 1; a matching way wins, otherwise the FIRST way of
// least stamp (jnp.argmin); a disabled site neither writes nor hits; the
// stamp written is stamp + slot, and the stamp advances by the step's
// slots on every step, padding steps included.  One packed int32 of hit
// bits per (t, l, m) comes out: bits 0-1 the TLBs, 2-5 the PWC levels,
// 6 + 5h .. 10 + 5h hierarchy level h, then the cache-as-TLB.
//
// Bound.  A chunk moves its inputs, walk lines and packed bits once and
// reads and writes each table once: about 26 MB for a 1,024-step chunk
// of the ndp_machine(8) bucket, 8 us at 3.35 TB/s.  The scan is bound by
// latency, not bytes: each (lane, mechanism) chain is serial, about 27
// dependent lookups a step, each a load of a table row.
//
// Design.  One warp per (lane, mechanism) chain, looping over the chunk's
// steps; 440 chains at the cpu_machine(8) bucket of 11 simulations.
// Lane w of the warp owns way w of every row (and w + 32, ... for a PWC
// wider than 32): it alone loads and stores that way, so a fill is seen
// by the next lookup of the same row without a barrier.  A hit is a
// __ballot_sync on tag equality (the first matching way); a miss takes
// the victim by a warp-shuffle min-reduction over (stamp, way), which
// gives the lowest way on a tie.  Tables stay in global memory, (L, M,
// sets, ways) int32 tags and stamps: a chain touches only its own (18 KB
// on an NDP machine, 342 KB on a CPU machine), so they mostly stay in L1
// and L2.  One launch per chunk; the walk lines come in computed, (T, L,
// M, 4) int32.  The scan reads neither the queue delay nor the clock, so
// a later version may launch once over many chunks.
#include <cuda_runtime.h>

#include <climits>
#include <initializer_list>

namespace {

// table order of the launch arguments (ref.SCAN_TABLES)
enum { T_L1TLB, T_L2TLB, T_PWC, T_L1, T_L2, T_L3, T_CTLB, N_TABLES };

constexpr int MAX_PTE = 4;
constexpr int HUGE_SHIFT = 9;
constexpr int THREADS = 128;
// flag word bits (ref.FLAG_*)
constexpr int FLAG_IDEAL = 1, FLAG_HUGE = 2, FLAG_BYPASS = 4,
              FLAG_SEGMENT = 8, FLAG_CACHE_TLB = 16;
constexpr int FLAG_PWC_SHIFT = 5, FLAG_N_PTE_SHIFT = 12;

struct Params {
  const int* vpn;               // (T, L)
  const int* off;               // (T, L)
  const unsigned char* is4k;    // (T, L)
  const unsigned char* valid;   // (T, L)
  const int* pte;               // (T, L, M, 4)
  const int* flags;             // (L, M)
  int* stamp;                   // (L, M)
  int* packed;                  // (T, L, M)
  int T, L, M;
  int* tags[N_TABLES];          // (L, M, sets, ways), null when absent
  int* lru[N_TABLES];
  int sets[N_TABLES];
  int ways[N_TABLES];
};

// One table of one chain.
struct Table {
  int* tags;
  int* lru;
  int sets;
  int ways;
};

// One LRU lookup + fill of row `set` on behalf of the whole warp.
// `en` is the same on every lane, so is the result.
__device__ __forceinline__ bool lookup(const Table& tb, int set, int tag,
                                       bool en, int stamp, int lane) {
  if (!en) return false;
  int* rt = tb.tags + (size_t)set * tb.ways;
  int* rl = tb.lru + (size_t)set * tb.ways;
  int way = -1;
  long long best = LLONG_MAX;  // (stamp << 32 | way) of the lane's ways
  for (int w0 = 0; w0 < tb.ways; w0 += 32) {
    const int w = w0 + lane;
    const bool in = w < tb.ways;
    // both loads issue before either is used
    const int t = in ? rt[w] : 0;
    const int st = in ? rl[w] : 0;
    const unsigned match = __ballot_sync(0xffffffffu, in && t == tag);
    if (match) {
      way = w0 + __ffs(match) - 1;
      break;
    }
    if (in) {
      const long long key = ((long long)st << 32) | (long long)(unsigned)w;
      best = key < best ? key : best;
    }
  }
  const bool hit = way >= 0;
  if (!hit) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      const long long other = __shfl_xor_sync(0xffffffffu, best, o);
      best = other < best ? other : best;
    }
    way = (int)(best & 0xffffffffLL);
  }
  if ((way & 31) == lane) {
    rt[way] = tag;
    rl[way] = stamp;
  }
  return hit;
}

// A lookup by key: set = key % sets, tag = key / sets + 1 (key >= 0).
__device__ __forceinline__ bool lookup_key(const Table& tb, int key, bool en,
                                           int stamp, int lane) {
  return lookup(tb, key % tb.sets, key / tb.sets + 1, en, stamp, lane);
}

__device__ __forceinline__ Table chain_table(const Params& p, int k,
                                             int chain) {
  Table tb{nullptr, nullptr, p.sets[k], p.ways[k]};
  if (p.tags[k] != nullptr) {
    const size_t off = (size_t)chain * p.sets[k] * p.ways[k];
    tb.tags = p.tags[k] + off;
    tb.lru = p.lru[k] + off;
  }
  return tb;
}

// NH: hierarchy levels (1 on an NDP machine, 3 on a CPU machine);
// CTLB: the machine has a cache-as-TLB.
template <int NH, bool CTLB>
__global__ void __launch_bounds__(THREADS)
    lru_scan_kernel(const Params p) {
  const int lane = threadIdx.x & 31;
  const int chain = (int)((blockIdx.x * blockDim.x + threadIdx.x) >> 5);
  if (chain >= p.L * p.M) return;  // the whole warp leaves together
  const int l = chain / p.M;
  const int m = chain - l * p.M;

  constexpr int N_SLOTS = 2 + MAX_PTE + 5 * NH + (CTLB ? 1 : 0);
  constexpr int CTLB_SLOT = 2 + MAX_PTE + 5 * NH;
  constexpr int CTLB_BIT = 6 + 5 * NH;

  const int flags = p.flags[chain];
  const bool ideal = flags & FLAG_IDEAL, huge = flags & FLAG_HUGE;
  const bool bypass = flags & FLAG_BYPASS, segment = flags & FLAG_SEGMENT;
  const bool cache_tlb = flags & FLAG_CACHE_TLB;
  const int n_pte = (flags >> FLAG_N_PTE_SHIFT) & 7;

  const Table l1tlb = chain_table(p, T_L1TLB, chain);
  const Table l2tlb = chain_table(p, T_L2TLB, chain);
  const Table pwc = chain_table(p, T_PWC, chain);
  const Table ctlb = chain_table(p, T_CTLB, chain);
  Table hier[NH];
#pragma unroll
  for (int h = 0; h < NH; ++h) hier[h] = chain_table(p, T_L1 + h, chain);

  int stamp = p.stamp[chain];
  for (int t = 0; t < p.T; ++t) {
    const size_t i = (size_t)t * p.L + l;
    const bool valid = p.valid[i];
    const bool is4k = p.is4k[i];
    const int vpn = p.vpn[i];
    const int4 pl = *reinterpret_cast<const int4*>(p.pte + (i * p.M + m) * 4);

    const int tlb_key =
        (huge && !is4k) ? ((vpn >> HUGE_SHIFT) | (1 << 26)) : vpn;
    const bool en0 = valid && !ideal && !(segment && !is4k);
    const bool h_l1tlb = lookup_key(l1tlb, tlb_key, en0, stamp, lane);
    const bool en1 = en0 && !h_l1tlb;
    const bool h_l2tlb = lookup_key(l2tlb, tlb_key, en1, stamp + 1, lane);
    bool walk = en1 && !h_l2tlb;
    bool h_ctlb = false;
    if (CTLB) {
      h_ctlb = lookup_key(ctlb, tlb_key, walk && cache_tlb,
                          stamp + CTLB_SLOT, lane);
      walk = walk && !h_ctlb;
    }
    int bits = (int)h_l1tlb | ((int)h_l2tlb << 1);

    const int eff_n = (huge && is4k) ? MAX_PTE : n_pte;
    const int lines[5] = {pl.x, pl.y, pl.z, pl.w, vpn * 64 + p.off[i]};
    bool ens[5];
#pragma unroll
    for (int lvl = 0; lvl < MAX_PTE; ++lvl) {
      const bool on = walk && lvl < eff_n;
      const bool h = lookup(pwc, lvl, lines[lvl] + 1,
                            on && ((flags >> (FLAG_PWC_SHIFT + lvl)) & 1),
                            stamp + 2 + lvl, lane);
      bits |= (int)h << (2 + lvl);
      ens[lvl] = on && !h && !bypass;
    }
    ens[MAX_PTE] = valid;
#pragma unroll
    for (int h = 0; h < NH; ++h) {
#pragma unroll
      for (int s = 0; s < 5; ++s) {
        const bool hit = lookup_key(hier[h], lines[s], ens[s],
                                    stamp + 2 + MAX_PTE + 5 * h + s, lane);
        bits |= (int)hit << (6 + 5 * h + s);
        ens[s] = ens[s] && !hit;
      }
    }
    if (CTLB) bits |= (int)h_ctlb << CTLB_BIT;
    if (lane == 0) p.packed[i * p.M + m] = bits;
    stamp += N_SLOTS;
  }
  if (lane == 0) p.stamp[chain] = stamp;
}

template <int NH, bool CTLB>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  const long long threads = (long long)p.L * p.M * 32;
  const unsigned blocks = (unsigned)((threads + THREADS - 1) / THREADS);
  lru_scan_kernel<NH, CTLB><<<blocks, THREADS, 0, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Launches on `stream`, allocates nothing, does not synchronise.  Every
// tensor is contiguous int32 (is4k and valid: bytes); `tags`, `lru`,
// `sets` and `ways` hold one entry per table in the order l1tlb, l2tlb,
// pwc, l1, l2, l3, ctlb, with null pointers for the tables the machine
// lacks (l2 and l3 come together).  Returns cudaGetLastError().
int lru_scan_launch(int device, const void* vpn, const void* off,
                    const void* is4k, const void* valid, const void* pte,
                    const void* flags, void* stamp, void* packed, int T, int L,
                    int M, void* const* tags, void* const* lru,
                    const int* sets, const int* ways, void* stream) {
  if (T < 0 || L <= 0 || M <= 0) return (int)cudaErrorInvalidValue;
  for (int k : {T_L1TLB, T_L2TLB, T_PWC, T_L1})
    if (tags[k] == nullptr || lru[k] == nullptr)
      return (int)cudaErrorInvalidValue;
  for (int k = 0; k < N_TABLES; ++k)
    if (tags[k] != nullptr && (sets[k] <= 0 || ways[k] <= 0))
      return (int)cudaErrorInvalidValue;
  const bool deep = tags[T_L2] != nullptr;
  if (deep != (tags[T_L3] != nullptr)) return (int)cudaErrorInvalidValue;
  if (T == 0) return (int)cudaSuccess;
  Params p;
  p.vpn = static_cast<const int*>(vpn);
  p.off = static_cast<const int*>(off);
  p.is4k = static_cast<const unsigned char*>(is4k);
  p.valid = static_cast<const unsigned char*>(valid);
  p.pte = static_cast<const int*>(pte);
  p.flags = static_cast<const int*>(flags);
  p.stamp = static_cast<int*>(stamp);
  p.packed = static_cast<int*>(packed);
  p.T = T;
  p.L = L;
  p.M = M;
  for (int k = 0; k < N_TABLES; ++k) {
    p.tags[k] = static_cast<int*>(tags[k]);
    p.lru[k] = static_cast<int*>(lru[k]);
    p.sets[k] = tags[k] != nullptr ? sets[k] : 0;
    p.ways[k] = tags[k] != nullptr ? ways[k] : 0;
  }
  // launch on the tensors' device and hand the caller's current device back
  int prev = 0;
  cudaError_t err = cudaGetDevice(&prev);
  if (err != cudaSuccess) return (int)err;
  if (prev != device && (err = cudaSetDevice(device)) != cudaSuccess)
    return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool ctlb = tags[T_CTLB] != nullptr;
  if (deep)
    err = ctlb ? launch<3, true>(p, s) : launch<3, false>(p, s);
  else
    err = ctlb ? launch<1, true>(p, s) : launch<1, false>(p, s);
  if (prev != device) {
    const cudaError_t restored = cudaSetDevice(prev);
    if (err == cudaSuccess) err = restored;
  }
  return (int)err;
}

const char* lru_scan_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
