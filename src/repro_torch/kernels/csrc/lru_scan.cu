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
// 6 + 5h .. 10 + 5h hierarchy level h, then the cache-as-TLB, then, on a
// banked memory, five row-buffer hits (pte0..pte3, data).
//
// Banked memory.  Each (lane, mechanism) chain also carries one open-row
// id per DRAM bank (-1: closed).  A site reaches memory when it is a PTE
// site that walks, is within the walk's depth, missed its PWC level and
// bypasses the caches, or when it missed every hierarchy level; the five
// sites then touch their bank in program order: bank = line /
// lines_per_row % banks, row = line / (lines_per_row * banks), the hit is
// open row == row, and the bank keeps the row open.  Lane k of the warp
// holds bank k's row (and bank k + 32's) in a register for the chunk.
// The rows change only at the end of a step, so each site's bank, row
// and open row (one shuffle from its bank's lane) are read at the start
// of the step, beside the table lookups; at the end a site sees the row
// an earlier site of the step opened in its bank, else the one read,
// and the bank's lane takes the last row opened in it.  Line ids are
// non-negative (the engine takes vpns below 2^25), where the truncating
// division here equals the epilogue's floor division.
//
// Lookups a step: 11 on an NDP machine (2 TLB + 4 PWC + 5 l1) and 21 on a
// CPU machine (2 + 4 + 15), plus the cache-as-TLB probe where there is one.
//
// Bound.  A chunk moves its inputs, walk lines and packed bits once and
// reads and writes each table once: about 26 MB for a 1,024-step chunk
// of the ndp_machine(8) bucket, 8 us at 3.35 TB/s.  The scan is bound by
// latency, not bytes: each (lane, mechanism) chain is serial, a step's
// lookups one after another, each a read of a table row, warp votes and
// a write, some fifty dependent instructions.
//
// Design.  One warp per (lane, mechanism) chain, looping over the chunk's
// steps, a chain a block.  Lane w of the warp owns way w and way w + 32
// of every row (tables up to 64 ways): it alone reads and writes them
// during the steps, so a fill is seen by the next lookup of the same row
// without a barrier.  The tables stay in global memory, reached through
// L1 (staging a chain's tables in shared memory for the chunk measured
// the same: the chain of dependent instructions sets the pace, not where
// the rows live).
//   * A cheap lookup.  The hit is a __ballot_sync on tag equality; the
//     victim is __reduce_min_sync over the lane's least stamp, a ballot of
//     the lanes that hold it and __ffs: the first way of least stamp (a
//     lane's way w before w + 32).  Sites whose rows no other site of the
//     step can share (the two TLBs, the four PWC levels) resolve without
//     a branch, hit and victim side by side, so their votes interleave;
//     the rest (cache-as-TLB, hierarchy) are skipped by a branch where
//     disabled and take the victim only on a miss.
//   * Reads issued ahead.  Lane j of the warp loads step base + j's
//     inputs 32 steps ahead, and each step takes them from that lane by
//     shuffles (an input loaded one step ahead into registers is copied
//     at the end of the step, which then waits for the load).  A step's
//     TLB, cache-as-TLB and four PWC rows are distinct rows (three
//     tables, one PWC row a level), so all are read before the first of
//     their lookups resolves.  The hierarchy lookups stay strictly
//     serial: the five lines may share a set.
//   * Keys split without a divide: set and tag by a 64-bit multiply with
//     a magic number per table (computed on the host), exact for keys
//     below 2^31.
// One launch per chunk; the walk lines come in computed, (T, L, M, 4)
// int32.  The scan reads neither the queue delay nor the clock, so a
// later version may launch once over many chunks.
#include <cuda_runtime.h>

#include <initializer_list>

namespace {

// table order of the launch arguments (ref.SCAN_TABLES)
enum { T_L1TLB, T_L2TLB, T_PWC, T_L1, T_L2, T_L3, T_CTLB, N_TABLES };

constexpr int MAX_PTE = 4;
constexpr int HUGE_SHIFT = 9;
constexpr int MAX_WAYS = 64;                // two ways a lane
constexpr unsigned FULL = 0xffffffffu;
constexpr unsigned NO_STAMP = 0xffffffffu;  // above every stamp: no way
// flag word bits (ref.FLAG_*)
constexpr int FLAG_IDEAL = 1, FLAG_HUGE = 2, FLAG_BYPASS = 4,
              FLAG_SEGMENT = 8, FLAG_CACHE_TLB = 16;
constexpr int FLAG_PWC_SHIFT = 5, FLAG_N_PTE_SHIFT = 12;

struct Params {
  const int* vpn;               // (T, L)
  const int* off;               // (T, L)
  const unsigned char* is4k;    // (T, L)
  const unsigned char* valid;   // (T, L)
  const int4* pte;              // (T, L, M) x 4
  const int* flags;             // (L, M)
  int* stamp;                   // (L, M)
  int* packed;                  // (T, L, M)
  int T, L, M;
  int* tags[N_TABLES];          // (L, M, sets, ways), null when absent
  int* lru[N_TABLES];
  int sets[N_TABLES];
  int ways[N_TABLES];
  unsigned long long magic[N_TABLES];  // key / sets = key * magic >> shift
  int shift[N_TABLES];
  int* bank_row;                // (L, M, banks), banked memory only
  int banks, lines_per_row;
  unsigned long long row_magic, bank_magic;  // / lines_per_row, / banks
  int row_shift, bank_shift;
};

// magic and shift that divide a key 0 <= key < 2^31 by d with a multiply:
// magic = floor(2^shift / d) + 1, shift = 31 + ceil(log2 d) (the error is
// below 2^31 / 2^shift <= 1 / d, so the quotient is exact)
void divisor(int d, unsigned long long& magic, int& shift) {
  int log2 = 0;
  while ((1LL << log2) < d) ++log2;
  shift = 31 + log2;
  magic = (1ULL << shift) / (unsigned long long)d + 1;
}

__device__ __forceinline__ int quotient(int key, unsigned long long magic,
                                        int shift) {
  return (int)(((unsigned long long)(unsigned)key * magic) >> shift);
}

// One table of one chain.
struct Table {
  int* tags;
  int* lru;
  int sets;
  int ways;
  unsigned long long magic;     // key / sets = key * magic >> shift
  int shift;
};

// The lane's two ways of one row: tags and stamps, NO_STAMP and tag 0
// (no tag is 0) where the way does not exist or the row was not read.
struct Row {
  int t0, t1;
  unsigned s0, s1;
};

// set and tag of key (0 <= key < 2^31): the multiply-high is exact there
// because magic = floor(2^shift / sets) + 1 with shift = 31 + ceil(log2
// sets) (error below 2^31 / 2^shift <= 1 / sets)
__device__ __forceinline__ void split(const Table& tb, int key, int& set,
                                      int& tag) {
  const int q = quotient(key, tb.magic, tb.shift);
  set = key - q * tb.sets;
  tag = q + 1;
}

// Read the lane's ways of row `set` where `en` (uniform across the warp).
__device__ __forceinline__ Row fetch(const Table& tb, int set, bool en,
                                     int lane) {
  Row r{0, 0, NO_STAMP, NO_STAMP};
  if (en) {
    const int* rt = tb.tags + set * tb.ways;
    const int* rl = tb.lru + set * tb.ways;
    if (lane < tb.ways) {
      r.t0 = rt[lane];
      r.s0 = (unsigned)rl[lane];
    }
    if (lane + 32 < tb.ways) {
      r.t1 = rt[lane + 32];
      r.s1 = (unsigned)rl[lane + 32];
    }
  }
  return r;
}

// The LRU hit plus fill of `row` (read by fetch), called only where the
// site is enabled (uniform across the warp, so is the result).  A hit
// needs one vote; a miss adds the stamp reduction and a second vote.
__device__ __forceinline__ bool resolve(const Table& tb, int set, int tag,
                                        const Row& r, int stamp, int lane) {
  const bool wide = tb.ways > 32;
  const unsigned m0 = __ballot_sync(FULL, r.t0 == tag);
  const unsigned m1 = wide ? __ballot_sync(FULL, r.t1 == tag) : 0u;
  int way;
  if (m0 | m1) {
    way = m0 ? __ffs(m0) - 1 : __ffs(m1) + 31;
  } else {
    const unsigned least = __reduce_min_sync(FULL, min(r.s0, r.s1));
    const unsigned v0 = __ballot_sync(FULL, r.s0 == least);
    way = v0 ? __ffs(v0) - 1
             : __ffs(__ballot_sync(FULL, r.s1 == least)) + 31;
  }
  if ((way & 31) == lane) {
    const int i = set * tb.ways + way;
    tb.tags[i] = tag;
    tb.lru[i] = stamp;
  }
  return (m0 | m1) != 0;
}

// The LRU hit plus fill of a site whose row no other site of the step
// shares: no branch, the votes run whether or not the site is enabled,
// the write only where it is, so the compiler may interleave such sites.
__device__ __forceinline__ bool resolve_flat(const Table& tb, int set,
                                             int tag, const Row& r, bool en,
                                             int stamp, int lane) {
  const unsigned m0 = __ballot_sync(FULL, r.t0 == tag);
  const unsigned m1 = __ballot_sync(FULL, r.t1 == tag);
  const unsigned least = __reduce_min_sync(FULL, min(r.s0, r.s1));
  const unsigned v0 = __ballot_sync(FULL, r.s0 == least);
  const unsigned v1 = __ballot_sync(FULL, r.s1 == least);
  const unsigned pick = m0 ? m0 : m1 ? m1 : v0 ? v0 : v1;
  const int way = __ffs(pick) - 1 + ((!m0 && (m1 || !v0)) ? 32 : 0);
  if (en && (way & 31) == lane) {
    const int i = set * tb.ways + way;
    tb.tags[i] = tag;
    tb.lru[i] = stamp;
  }
  return en && (m0 | m1);
}

// Chain `chain`'s rows of table k.
__device__ __forceinline__ Table chain_table(const Params& p, int k,
                                             int chain) {
  Table tb{nullptr, nullptr, p.sets[k], p.ways[k], p.magic[k], p.shift[k]};
  if (p.tags[k] == nullptr) return tb;
  const size_t n = (size_t)p.sets[k] * p.ways[k];
  tb.tags = p.tags[k] + chain * n;
  tb.lru = p.lru[k] + chain * n;
  return tb;
}

// One step's inputs for lane l, mechanism m.
struct Input {
  int vpn, off;
  bool is4k, valid;
  int4 pte;
};

// The inputs of 32 steps, lane j holding step base + j (zeros past T).
struct Batch {
  int vpn, off, bits;           // bits: is4k | valid << 1
  int4 pte;
};

__device__ __forceinline__ Batch load_batch(const Params& p, int base, int l,
                                            int m, int lane) {
  Batch b{0, 0, 0, make_int4(0, 0, 0, 0)};
  const int t = base + lane;
  if (t < p.T) {
    const size_t i = (size_t)t * p.L + l;
    b.vpn = __ldg(p.vpn + i);
    b.off = __ldg(p.off + i);
    b.bits = (__ldg(p.is4k + i) != 0) | ((__ldg(p.valid + i) != 0) << 1);
    b.pte = __ldg(p.pte + i * p.M + m);
  }
  return b;
}

// Step base + j's inputs, from the lane that holds them.
__device__ __forceinline__ Input step_input(const Batch& b, int j) {
  const int bits = __shfl_sync(FULL, b.bits, j);
  return Input{__shfl_sync(FULL, b.vpn, j), __shfl_sync(FULL, b.off, j),
               (bits & 1) != 0, (bits & 2) != 0,
               make_int4(__shfl_sync(FULL, b.pte.x, j),
                         __shfl_sync(FULL, b.pte.y, j),
                         __shfl_sync(FULL, b.pte.z, j),
                         __shfl_sync(FULL, b.pte.w, j))};
}

// NH: hierarchy levels (1 on an NDP machine, 3 on a CPU machine);
// CTLB: the machine has a cache-as-TLB; BANKED: its memory is banked.
template <int NH, bool CTLB, bool BANKED>
__global__ void __launch_bounds__(32) lru_scan_kernel(const Params p) {
  const int lane = threadIdx.x;
  const int chain = blockIdx.x;
  const int l = chain / p.M;
  const int m = chain - l * p.M;

  constexpr int N_SLOTS = 2 + MAX_PTE + 5 * NH + (CTLB ? 1 : 0);
  constexpr int CTLB_SLOT = 2 + MAX_PTE + 5 * NH;
  constexpr int CTLB_BIT = 6 + 5 * NH;
  constexpr int BANK_BIT = CTLB_BIT + (CTLB ? 1 : 0);

  const int flags = p.flags[chain];
  const bool ideal = flags & FLAG_IDEAL, huge = flags & FLAG_HUGE;
  const bool bypass = flags & FLAG_BYPASS, segment = flags & FLAG_SEGMENT;
  const bool cache_tlb = flags & FLAG_CACHE_TLB;
  const int n_pte = (flags >> FLAG_N_PTE_SHIFT) & 7;

  Table tabs[N_TABLES];
#pragma unroll
  for (int k = 0; k < N_TABLES; ++k) tabs[k] = chain_table(p, k, chain);
  const Table& l1tlb = tabs[T_L1TLB];
  const Table& l2tlb = tabs[T_L2TLB];
  const Table& pwc = tabs[T_PWC];
  const Table& ctlb = tabs[T_CTLB];

  int stamp = p.stamp[chain];
  // banked: lane k holds the open rows of banks k and k + 32
  int* const bank_row = BANKED ? p.bank_row + (size_t)chain * p.banks
                               : nullptr;
  int row0 = -1, row1 = -1;
  if (BANKED) {
    if (lane < p.banks) row0 = bank_row[lane];
    if (lane + 32 < p.banks) row1 = bank_row[lane + 32];
  }
  // the inputs of the next 32 steps are loaded while the current 32 run
  Batch cur = load_batch(p, 0, l, m, lane);
  Batch nxt = load_batch(p, 32, l, m, lane);
  for (int t = 0; t < p.T; ++t) {
    const int j = t & 31;
    if (j == 0 && t > 0) {
      cur = nxt;
      nxt = load_batch(p, t + 32, l, m, lane);
    }
    const Input in = step_input(cur, j);

    const int tlb_key =
        (huge && !in.is4k) ? ((in.vpn >> HUGE_SHIFT) | (1 << 26)) : in.vpn;
    const bool en0 = in.valid && !ideal && !(segment && !in.is4k);
    const int eff_n = (huge && in.is4k) ? MAX_PTE : n_pte;
    const int lines[5] = {in.pte.x, in.pte.y, in.pte.z, in.pte.w,
                          in.vpn * 64 + in.off};
    bool pwc_ok[MAX_PTE];
#pragma unroll
    for (int lvl = 0; lvl < MAX_PTE; ++lvl)
      pwc_ok[lvl] = lvl < eff_n && ((flags >> (FLAG_PWC_SHIFT + lvl)) & 1);
    // banked: each site's bank and row, and its bank's open row as the
    // step found it (the rows change only at the end of the step), read
    // now, off the chain of lookups
    int bk[5], rw[5], open[5];
    if (BANKED) {
#pragma unroll
      for (int s = 0; s < 5; ++s) {
        const int q = quotient(lines[s], p.row_magic, p.row_shift);
        rw[s] = quotient(q, p.bank_magic, p.bank_shift);
        bk[s] = q - rw[s] * p.banks;
        open[s] = __shfl_sync(FULL, bk[s] < 32 ? row0 : row1, bk[s] & 31);
      }
    }

    // the rows of the TLBs, the cache-as-TLB and the four PWC levels:
    // distinct rows, all read before the first of their lookups resolves
    int set1, tag1, set2, tag2, setc = 0, tagc = 0;
    split(l1tlb, tlb_key, set1, tag1);
    split(l2tlb, tlb_key, set2, tag2);
    if (CTLB) split(ctlb, tlb_key, setc, tagc);
    const Row r1 = fetch(l1tlb, set1, en0, lane);
    const Row r2 = fetch(l2tlb, set2, en0, lane);
    const Row rc = CTLB ? fetch(ctlb, setc, en0 && cache_tlb, lane) : Row{};
    Row rp[MAX_PTE];
#pragma unroll
    for (int lvl = 0; lvl < MAX_PTE; ++lvl)
      rp[lvl] = fetch(pwc, lvl, en0 && pwc_ok[lvl], lane);

    // the two TLBs are distinct rows, and so are the four PWC levels:
    // their votes run side by side, the enables decide only the writes;
    // a chain that does not walk, or has no PWC level on, skips the PWC
    const bool h_l1tlb =
        resolve_flat(l1tlb, set1, tag1, r1, en0, stamp, lane);
    const bool h_l2tlb = resolve_flat(l2tlb, set2, tag2, r2,
                                      en0 && !h_l1tlb, stamp + 1, lane);
    const bool en1 = en0 && !h_l1tlb;
    bool walk = en1 && !h_l2tlb;
    bool h_ctlb = false;
    if (CTLB) {
      h_ctlb = walk && cache_tlb &&
               resolve(ctlb, setc, tagc, rc, stamp + CTLB_SLOT, lane);
      walk = walk && !h_ctlb;
    }
    int bits = (int)h_l1tlb | ((int)h_l2tlb << 1);

    bool ens[5] = {false, false, false, false, in.valid};
    bool hp[MAX_PTE] = {false, false, false, false};
    if (walk) {
      if ((flags >> FLAG_PWC_SHIFT) & ((1 << eff_n) - 1)) {
#pragma unroll
        for (int lvl = 0; lvl < MAX_PTE; ++lvl) {
          hp[lvl] = resolve_flat(pwc, lvl, lines[lvl] + 1, rp[lvl],
                                 pwc_ok[lvl], stamp + 2 + lvl, lane);
          bits |= (int)hp[lvl] << (2 + lvl);
        }
      }
#pragma unroll
      for (int lvl = 0; lvl < MAX_PTE; ++lvl)
        ens[lvl] = lvl < eff_n && !hp[lvl] && !bypass;
    }
#pragma unroll
    for (int h = 0; h < NH; ++h) {
      const Table& tb = tabs[T_L1 + h];
#pragma unroll
      for (int s = 0; s < 5; ++s) {
        if (!ens[s]) continue;  // uniform: a disabled site reads nothing
        int set, tag;
        split(tb, lines[s], set, tag);
        const Row r = fetch(tb, set, true, lane);
        const bool hit =
            resolve(tb, set, tag, r, stamp + 2 + MAX_PTE + 5 * h + s, lane);
        bits |= (int)hit << (6 + 5 * h + s);
        ens[s] = !hit;
      }
    }
    if (CTLB) bits |= (int)h_ctlb << CTLB_BIT;
    if (BANKED) {
      // the sites that reached memory touch their banks in program order:
      // a site sees the row an earlier site of the step left open in its
      // bank, else the row the step found; the bank's lane keeps the last
      bool mem_en[5];
#pragma unroll
      for (int s = 0; s < 5; ++s) {
        mem_en[s] = ens[s] ||
                    (s < MAX_PTE && walk && s < eff_n && !hp[s] && bypass);
        int cur = open[s];
#pragma unroll
        for (int e = 0; e < s; ++e)
          cur = (mem_en[e] && bk[e] == bk[s]) ? rw[e] : cur;
        bits |= (int)(mem_en[s] && cur == rw[s]) << (BANK_BIT + s);
      }
#pragma unroll
      for (int s = 0; s < 5; ++s) {
        if (mem_en[s] && lane == (bk[s] & 31)) {
          if (bk[s] < 32)
            row0 = rw[s];
          else
            row1 = rw[s];
        }
      }
    }
    if (lane == 0) p.packed[((size_t)t * p.L + l) * p.M + m] = bits;
    stamp += N_SLOTS;
  }
  if (lane == 0) p.stamp[chain] = stamp;
  if (BANKED) {
    if (lane < p.banks) bank_row[lane] = row0;
    if (lane + 32 < p.banks) bank_row[lane + 32] = row1;
  }
}

template <int NH, bool CTLB, bool BANKED>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  lru_scan_kernel<NH, CTLB, BANKED>
      <<<(unsigned)(p.L * p.M), 32, 0, stream>>>(p);
  return cudaGetLastError();
}

template <int NH, bool CTLB>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  return p.bank_row != nullptr ? launch<NH, CTLB, true>(p, stream)
                               : launch<NH, CTLB, false>(p, stream);
}

}  // namespace

extern "C" {

// Launches on `stream`, allocates nothing, does not synchronise.  Every
// tensor is contiguous int32 (is4k and valid: bytes; pte 16-byte
// aligned); `tags`, `lru`, `sets` and `ways` hold one entry per table in
// the order l1tlb, l2tlb, pwc, l1, l2, l3, ctlb, with null pointers for
// the tables the machine lacks (l2 and l3 come together); no table has
// more than 64 ways.  `bank_row` is null for a bounded memory; for a
// banked one it is (L, M, banks) int32, 1 <= banks <= 64, with rows of
// `lines_per_row` >= 1 lines.  Returns cudaGetLastError().
int lru_scan_launch(int device, const void* vpn, const void* off,
                    const void* is4k, const void* valid, const void* pte,
                    const void* flags, void* stamp, void* packed, int T, int L,
                    int M, void* const* tags, void* const* lru,
                    const int* sets, const int* ways, void* bank_row,
                    int banks, int lines_per_row, void* stream) {
  if (T < 0 || L <= 0 || M <= 0) return (int)cudaErrorInvalidValue;
  for (int k : {T_L1TLB, T_L2TLB, T_PWC, T_L1})
    if (tags[k] == nullptr || lru[k] == nullptr)
      return (int)cudaErrorInvalidValue;
  for (int k = 0; k < N_TABLES; ++k) {
    if (tags[k] == nullptr) continue;
    if (sets[k] <= 0 || ways[k] <= 0 || ways[k] > MAX_WAYS)
      return (int)cudaErrorInvalidValue;
  }
  const bool deep = tags[T_L2] != nullptr;
  if (deep != (tags[T_L3] != nullptr)) return (int)cudaErrorInvalidValue;
  if (bank_row != nullptr &&
      (banks < 1 || banks > 64 || lines_per_row < 1))
    return (int)cudaErrorInvalidValue;
  if (T == 0) return (int)cudaSuccess;
  Params p;
  p.vpn = static_cast<const int*>(vpn);
  p.off = static_cast<const int*>(off);
  p.is4k = static_cast<const unsigned char*>(is4k);
  p.valid = static_cast<const unsigned char*>(valid);
  p.pte = static_cast<const int4*>(pte);
  p.flags = static_cast<const int*>(flags);
  p.stamp = static_cast<int*>(stamp);
  p.packed = static_cast<int*>(packed);
  p.T = T;
  p.L = L;
  p.M = M;
  for (int k = 0; k < N_TABLES; ++k) {
    p.tags[k] = static_cast<int*>(tags[k]);
    p.lru[k] = static_cast<int*>(lru[k]);
    p.sets[k] = tags[k] != nullptr ? sets[k] : 1;
    p.ways[k] = tags[k] != nullptr ? ways[k] : 0;
    divisor(p.sets[k], p.magic[k], p.shift[k]);
  }
  p.bank_row = static_cast<int*>(bank_row);
  p.banks = bank_row != nullptr ? banks : 1;
  p.lines_per_row = bank_row != nullptr ? lines_per_row : 1;
  divisor(p.lines_per_row, p.row_magic, p.row_shift);
  divisor(p.banks, p.bank_magic, p.bank_shift);
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
