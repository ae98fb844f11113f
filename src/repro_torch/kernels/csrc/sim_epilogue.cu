// The translation simulator's timing epilogue for Hopper (sm_90a),
// hand-written CUDA C++.
//
// Replaces the JAX simulator's `epilogue` (src/repro/sim/simulator.py:558,
// inside `_build_model`), which the JAX runner fuses into its jitted chunk;
// the plain version and specification is `sim_epilogue_ref` in
// src/repro_torch/kernels/ref.py.
//
// What it computes.  For each (lane l, mechanism m) it re-derives, from a
// chunk's packed hit bits (the LRU scan's (T, L, M) output, read in that
// orientation), the gates the scan used and each step's timing: the
// per-line hierarchy latency (l1, or l1/l2/l3, then memory plus the queue
// delay and the multi-stack penalty), the walk's per-level latency (a PWC
// hit, memory for a bypassing mechanism, else the hierarchy), a serial or
// parallel (ECH) walk, the cache-as-TLB probe, the L2-TLB latency and the
// huge-page stall, and the step's cycles.  Over the chunk it sums nine
// counters, the cycles and the memory accesses, and adds them into the
// engine's state: counters and clock (B, M, C), mem_accs (B, M).
//
// Float rules.  Each step's terms are float32, in the plain version's
// order of operations; the one product (the multi-stack penalty) is
// __fmul_rn, so it is never contracted into a multiply-add and rounds on
// its own, as the plain version's does.  The chunk's partial sums are
// float64, rounded once to float32 and then added to the state in
// float32.  Counters of events are integers and come out exact.
//
// Bound.  A streaming reduction over T: the packed bits (4 B a (t, l, m)),
// work (4 B), is4k and valid (1 B each a (t, l)) read once, a few hundred
// bytes of per-lane parameters and the state read and written once: about
// 1.8 MB for a 1,024-step chunk of the ndp_machine(8) bucket, 0.6 us at
// 3.35 TB/s.
//
// Design.  One block of 256 threads per (simulation b, mechanism m); its
// threads split the chunk's steps among the C lanes of b (thread j takes
// lane j % C and every (256 / C)-th step from j / C).  A thread keeps its
// counts in int and its cycle sums in double; the block then folds each
// lane's partial sums in a fixed order through shared memory, and thread c
// alone adds lane c's sums into the state, so no atomics are needed.
//
// Banked memory (the BANKED instantiation).  A memory access at one of
// the five sites costs the closed-row latency, less the precharge and
// activate an open-row hit skips (the scan's five row-buffer bits, after
// every other bit), plus its own bank's queue delay: bank = line /
// lines_per_row % banks, the lines being the four PTE lines the scan
// read (pte, (T, L, M) x 4) and the data line vpn * 64 + off.  q is
// (B, M, banks), staged in shared memory a block; the accesses are
// counted per bank, integers, by shared-memory atomics (exact in any
// order), and added into mem_accs (B, M, banks).
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int MAX_PTE = 4;
constexpr int MAX_HIER = 3;
// flag word bits (ref.FLAG_*)
constexpr int FLAG_IDEAL = 1, FLAG_HUGE = 2, FLAG_BYPASS = 4,
              FLAG_SEGMENT = 8, FLAG_CACHE_TLB = 16, FLAG_COLOCATE = 1 << 9,
              FLAG_PARALLEL = 1 << 10;
constexpr int FLAG_N_PTE_SHIFT = 12;
// per-lane parameter columns (ref.EPILOGUE_PARAMS)
enum {
  P_MEM_LAT, P_L1_LAT, P_L2_LAT, P_L3_LAT, P_L2TLB_LAT, P_PWC_LAT, P_PROMO,
  P_ECH_REHASH, P_CTLB_LAT, P_STACK_PEN, P_ROW_SAVE, N_PARAMS
};
constexpr int MAX_BANKS = 64;
// outputs (ref.COUNTERS, then the clock and the memory accesses)
enum {
  O_TRANS, O_WALKS, O_WALK_CYC, O_L1TLB_MISS, O_PTE_ACC, O_PTE_L1_HIT,
  O_PTE_MEM, O_DATA_L1_MISS, O_DATA_MEM, O_CLOCK, O_MEM, N_OUT
};

struct Params {
  const int* packed;            // (T, L, M)
  const float* work;            // (T, L)
  const unsigned char* is4k;    // (T, L)
  const unsigned char* valid;   // (T, L)
  const float* q;               // (B, M); banked (B, M, banks)
  const int* flags;             // (L, M)
  const float* params;          // (L, N_PARAMS)
  const int4* pte;              // (T, L, M) x 4, banked only
  const int* vpn;               // (T, L), banked only
  const int* off;               // (T, L), banked only
  float* out[N_OUT];            // (B, M, C) each; O_MEM (B, M[, banks])
  int T, B, C, M, n_hier;
  bool ctlb;
  int banks, lines_per_row;
};

template <bool BANKED>
__global__ void __launch_bounds__(THREADS)
    sim_epilogue_kernel(const Params p) {
  __shared__ double part[N_OUT][THREADS];
  // banked: the block's queue delay and access count of each bank
  __shared__ float q_bank[BANKED ? MAX_BANKS : 1];
  __shared__ int n_bank[BANKED ? MAX_BANKS : 1];
  const int b = blockIdx.x / p.M;
  const int m = blockIdx.x - b * p.M;
  const int tid = threadIdx.x;
  const int per_lane = THREADS / p.C;  // threads a lane
  const int c = tid % p.C;
  const int slice = tid / p.C;
  const int L = p.B * p.C;
  if (BANKED) {
    if (tid < p.banks) {
      q_bank[tid] = p.q[((size_t)b * p.M + m) * p.banks + tid];
      n_bank[tid] = 0;
    }
    __syncthreads();
  }

  int n_walks = 0, n_l1tlb_miss = 0, n_pte_acc = 0, n_pte_l1_hit = 0;
  int n_pte_mem = 0, n_data_l1_miss = 0, n_data_mem = 0;
  double s_trans = 0.0, s_walk_cyc = 0.0, s_cyc = 0.0;
  if (slice < per_lane) {
    const int l = b * p.C + c;
    const int flags = p.flags[l * p.M + m];
    const bool ideal = flags & FLAG_IDEAL, huge = flags & FLAG_HUGE;
    const bool bypass = flags & FLAG_BYPASS, segment = flags & FLAG_SEGMENT;
    const bool cache_tlb = flags & FLAG_CACHE_TLB;
    const bool parallel = flags & FLAG_PARALLEL;
    const int n_pte = (flags >> FLAG_N_PTE_SHIFT) & 7;
    const float* dp = p.params + (size_t)l * N_PARAMS;
    const float hier_lat[MAX_HIER] = {dp[P_L1_LAT], dp[P_L2_LAT],
                                      dp[P_L3_LAT]};
    const float pen =
        __fmul_rn(dp[P_STACK_PEN], (flags & FLAG_COLOCATE) ? 0.1f : 1.0f);
    const float mem_cost0 =
        BANKED ? 0.0f : (dp[P_MEM_LAT] + p.q[b * p.M + m]) + pen;
    const int ctlb_bit = 6 + 5 * p.n_hier;
    const int bank_bit = ctlb_bit + (p.ctlb ? 1 : 0);

    for (int t = slice; t < p.T; t += per_lane) {
      const size_t i = (size_t)t * L + l;
      const int bits = __ldg(p.packed + i * p.M + m);
      const bool valid = __ldg(p.valid + i) != 0;
      const bool is4k = __ldg(p.is4k + i) != 0;
      const float work = __ldg(p.work + i);
      auto bit = [bits](int k) { return ((bits >> k) & 1) != 0; };

      // each site's memory cost: banked, its bank's queue delay and the
      // row-buffer discount
      float mem_cost[5];
      int bank[5];
      if (BANKED) {
        const int4 pl = __ldg(p.pte + i * p.M + m);
        const int lines[5] = {pl.x, pl.y, pl.z, pl.w,
                              __ldg(p.vpn + i) * 64 + __ldg(p.off + i)};
#pragma unroll
        for (int s = 0; s < 5; ++s) {
          bank[s] = (int)(((unsigned)lines[s] / (unsigned)p.lines_per_row) %
                          (unsigned)p.banks);
          const float save = bit(bank_bit + s) ? dp[P_ROW_SAVE] : 0.0f;
          mem_cost[s] = ((dp[P_MEM_LAT] - save) + q_bank[bank[s]]) + pen;
        }
      } else {
#pragma unroll
        for (int s = 0; s < 5; ++s) mem_cost[s] = mem_cost0;
      }

      const bool h_l1tlb = bit(0), h_l2tlb = bit(1);
      const bool en0 = valid && !ideal && !(segment && !is4k);
      bool walk = en0 && !h_l1tlb && !h_l2tlb;
      bool ctlb_probe = false;
      if (p.ctlb) {
        ctlb_probe = walk && cache_tlb;
        walk = walk && !bit(ctlb_bit);
      }
      const int eff_n = (huge && is4k) ? MAX_PTE : n_pte;

      // hierarchy latency per line (pte0..3, data)
      float lat[5];
      bool reached[5], went_mem[5];
#pragma unroll
      for (int s = 0; s < 5; ++s) {
        lat[s] = 0.0f;
        reached[s] = went_mem[s] = true;
      }
#pragma unroll
      for (int h = 0; h < MAX_HIER; ++h) {
        if (h >= p.n_hier) break;
#pragma unroll
        for (int s = 0; s < 5; ++s) {
          const bool hb = bit(6 + 5 * h + s);
          lat[s] = lat[s] + (reached[s] ? hier_lat[h] : 0.0f);
          went_mem[s] = went_mem[s] && !hb;
          reached[s] = reached[s] && !hb;
        }
      }
#pragma unroll
      for (int s = 0; s < 5; ++s)
        lat[s] = lat[s] + (reached[s] ? mem_cost[s] : 0.0f);

      // per-PTE-level walk latency
      float pte_lat[MAX_PTE];
      float lat_max = 0.0f, lat_sum = 0.0f;
#pragma unroll
      for (int lvl = 0; lvl < MAX_PTE; ++lvl) {
        const bool pwc_hit = bit(2 + lvl);
        const bool pte_en = walk && lvl < eff_n;
        const bool need_mem = pte_en && !pwc_hit;
        float v = bypass ? mem_cost[lvl] : lat[lvl];
        v = pwc_hit ? dp[P_PWC_LAT] : v;
        pte_lat[lvl] = pte_en ? v : 0.0f;
        lat_max = lvl == 0 ? pte_lat[0] : fmaxf(lat_max, pte_lat[lvl]);
        lat_sum = lvl == 0 ? pte_lat[0] : lat_sum + pte_lat[lvl];
        const bool pte_mem = need_mem && (bypass || went_mem[lvl]);
        n_pte_acc += need_mem;
        n_pte_l1_hit += bit(6 + lvl);
        n_pte_mem += pte_mem;
        if (BANKED && pte_mem) atomicAdd(&n_bank[bank[lvl]], 1);
      }
      const float walk_cyc =
          parallel ? (lat_max + 2.0f) + dp[P_ECH_REHASH] : lat_sum;

      float trans = walk ? walk_cyc : 0.0f;
      if (p.ctlb) trans = trans + (ctlb_probe ? dp[P_CTLB_LAT] : 0.0f);
      trans = (en0 && !h_l1tlb) ? dp[P_L2TLB_LAT] + trans : 0.0f;
      trans = trans + ((huge && valid) ? dp[P_PROMO] : 0.0f);

      const float dlat = valid ? lat[MAX_PTE] : 0.0f;
      const float step_cyc =
          valid ? ((work + 1.0f) + trans) + (dlat - dp[P_L1_LAT]) : 0.0f;

      s_trans += (double)trans;
      n_walks += walk;
      s_walk_cyc += (double)(walk ? walk_cyc : 0.0f);
      n_l1tlb_miss += en0 && !h_l1tlb;
      n_data_l1_miss += valid && !bit(6 + MAX_PTE);
      const bool data_mem = valid && went_mem[MAX_PTE];
      n_data_mem += data_mem;
      if (BANKED && data_mem) atomicAdd(&n_bank[bank[MAX_PTE]], 1);
      s_cyc += (double)step_cyc;
    }
  }
  part[O_TRANS][tid] = s_trans;
  part[O_WALKS][tid] = n_walks;
  part[O_WALK_CYC][tid] = s_walk_cyc;
  part[O_L1TLB_MISS][tid] = n_l1tlb_miss;
  part[O_PTE_ACC][tid] = n_pte_acc;
  part[O_PTE_L1_HIT][tid] = n_pte_l1_hit;
  part[O_PTE_MEM][tid] = n_pte_mem;
  part[O_DATA_L1_MISS][tid] = n_data_l1_miss;
  part[O_DATA_MEM][tid] = n_data_mem;
  part[O_CLOCK][tid] = s_cyc;
  part[O_MEM][tid] = n_pte_mem + n_data_mem;
  __syncthreads();

  // lane c's sums, folded in slice order by thread c; the memory accesses
  // of the lanes of b folded by thread 0 after
  __shared__ double lane_mem[THREADS];
  if (tid < p.C) {
    const size_t o = ((size_t)b * p.M + m) * p.C + tid;
    for (int k = 0; k < N_OUT; ++k) {
      double sum = 0.0;
      for (int j = 0; j < per_lane; ++j) sum += part[k][j * p.C + tid];
      if (k == O_MEM)
        lane_mem[tid] = sum;
      else
        p.out[k][o] += (float)sum;
    }
  }
  __syncthreads();
  if (BANKED) {
    if (tid < p.banks)
      p.out[O_MEM][((size_t)b * p.M + m) * p.banks + tid] +=
          (float)n_bank[tid];
  } else if (tid == 0) {
    double sum = 0.0;
    for (int j = 0; j < p.C; ++j) sum += lane_mem[j];
    p.out[O_MEM][b * p.M + m] += (float)sum;
  }
}

}  // namespace

extern "C" {

// Launches on `stream`, allocates nothing, does not synchronise.  Every
// tensor is contiguous (is4k and valid: bytes); `out` holds the nine
// counters (ref.COUNTERS order) and the clock, each (B, M, C) float32,
// then mem_accs (B, M) float32, all added to in place.  C is at most 256;
// n_hier is 1 or 3.  `banks` is 0 for a bounded memory, and `pte`, `vpn`
// and `off` null; for a banked one 1 <= banks <= 64, q and mem_accs are
// (B, M, banks), `pte` is the (T, L, M, 4) int32 walk lines (16-byte
// aligned), `vpn` and `off` (T, L) int32, rows `lines_per_row` >= 1
// lines.  Returns cudaGetLastError().
int sim_epilogue_launch(int device, const void* packed, const void* work,
                        const void* is4k, const void* valid, const void* q,
                        const void* flags, const void* params,
                        const void* pte, const void* vpn, const void* off,
                        void* const* out, int T, int B, int C, int M,
                        int n_hier, int ctlb, int banks, int lines_per_row,
                        void* stream) {
  if (T < 0 || B <= 0 || C <= 0 || C > THREADS || M <= 0)
    return (int)cudaErrorInvalidValue;
  if (n_hier != 1 && n_hier != MAX_HIER) return (int)cudaErrorInvalidValue;
  const bool banked = banks != 0;
  if (banked && (banks < 0 || banks > MAX_BANKS || lines_per_row < 1 ||
                 pte == nullptr || vpn == nullptr || off == nullptr))
    return (int)cudaErrorInvalidValue;
  if (!banked && (pte != nullptr || vpn != nullptr || off != nullptr))
    return (int)cudaErrorInvalidValue;
  for (int k = 0; k < N_OUT; ++k)
    if (out[k] == nullptr) return (int)cudaErrorInvalidValue;
  if (T == 0) return (int)cudaSuccess;
  Params p;
  p.packed = static_cast<const int*>(packed);
  p.work = static_cast<const float*>(work);
  p.is4k = static_cast<const unsigned char*>(is4k);
  p.valid = static_cast<const unsigned char*>(valid);
  p.q = static_cast<const float*>(q);
  p.flags = static_cast<const int*>(flags);
  p.params = static_cast<const float*>(params);
  p.pte = static_cast<const int4*>(pte);
  p.vpn = static_cast<const int*>(vpn);
  p.off = static_cast<const int*>(off);
  p.banks = banks;
  p.lines_per_row = lines_per_row;
  for (int k = 0; k < N_OUT; ++k) p.out[k] = static_cast<float*>(out[k]);
  p.T = T;
  p.B = B;
  p.C = C;
  p.M = M;
  p.n_hier = n_hier;
  p.ctlb = ctlb != 0;
  int prev = 0;
  cudaError_t err = cudaGetDevice(&prev);
  if (err != cudaSuccess) return (int)err;
  if (prev != device && (err = cudaSetDevice(device)) != cudaSuccess)
    return (int)err;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (banked)
    sim_epilogue_kernel<true><<<(unsigned)(B * M), THREADS, 0, s>>>(p);
  else
    sim_epilogue_kernel<false><<<(unsigned)(B * M), THREADS, 0, s>>>(p);
  err = cudaGetLastError();
  if (prev != device) {
    const cudaError_t restored = cudaSetDevice(prev);
    if (err == cudaSuccess) err = restored;
  }
  return (int)err;
}

const char* sim_epilogue_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
