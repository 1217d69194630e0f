// One round of the conflict loop, without zone work, as seven kernels for
// NVIDIA Hopper (sm_90a).
//
// They replace the body of the JAX package's conflict loop: the
// lax.while_loop body of assign_parallel in
// kubernetesnetawarescheduler_tpu/core/assign.py, which has no Pallas
// kernel (XLA fuses it on the TPU).  The port's plain version is
// core/assign.py:_round_body(t, cfg, zone_work=False), which the CPU runs
// and which a CUDA batch with zone work replays as a CUDA graph of
// PyTorch kernels.  A round is two passes (A, then the second-chance pass
// B), each three steps, then the continue test:
//
//   round_colmax_kernel   per alive pod over the node-major core [n, p]:
//                         (choice, best, second best), the first maximum
//                         and the best value on any other row.  Pass B
//                         reads the rows pass A patched as NEG_INF (a
//                         per-row flag, not a masked copy) and takes the
//                         pods' maximum over those rows (va_new) in the
//                         same read.
//   round_resolve_kernel  one block: sort the proposals by choice * p +
//                         rank (unique keys, a counting sort in shared
//                         memory), the segmented capacity prefix, the
//                         re-priced balance, the pairwise group/anti test
//                         (a segmented OR of the int32 mask words: OR is
//                         exact in any order, so no bit planes), the
//                         prefix-ok walk and the winners; then
//                         assignment, used, group_bits, resident_anti and
//                         gz_counts for the winners.
//   round_patch_kernel    one block per winner node row: the core of that
//                         row recomputed against the new state, in place.
//   round_cont_kernel     whether a pod still unassigned has a feasible
//                         row, once some pod was placed.
//
// What bounds them on an H100: the core plane is the only large operand
// (f32 [5,120, 256] = 5.2 MB at the saturation cell's shape).  A round
// reads it three times (two argmax passes, the continue test) and writes
// the winners' rows, ≈15.7 MB, 4.7 us at 3.35 TB/s; the rest touches p
// proposals and at most p node rows.  The resolve step is one block of p
// threads and a few dozen barriers, latency rather than bytes; it is
// what keeps the round above its byte bound.  The argmax merges its
// blocks with two 64-bit atomicMax per pod (score bits high, inverted
// row low: the largest key is the first maximum, and the largest key of
// the losers of each exchange is the best value on any other row), so
// it is one launch with no merge pass.
//
// Exactness.  The round equals the PyTorch body decision for decision,
// as the CPU tests hold the PyTorch body to the JAX package:
// - The capacity prefix sums f32 in the odd/even order of
//   jax.lax.associative_scan (_assoc_cumsum0), as an up-sweep of pair
//   sums and a down-sweep in shared memory, not as a running sum; the
//   segment base is a running max of the same values, as _cummax0 is.
// - Every elementwise step rounds where PyTorch's does: rawT - w_bal * bal
//   and (used + csum) / cap_eps are separate operations there, so the
//   kernels use __fmul_rn, __fadd_rn, __fsub_rn and __fdiv_rn, which
//   the compiler may not contract into FMAs (NVCC_FLAGS stay as the score
//   kernels need them); division is IEEE, no fast-math.
// - second_best - 1e-6 and va_new - 1e-6 subtract the f32 of 1e-6, as
//   the scalar operation does.
// - Keys map -0.0 to +0.0, so a tie between the two goes to the lower
//   row, as torch's == does.
// - used: each node's winners are summed in pod-index order from zero,
//   then added to the node's row.  PyTorch sums through a one-hot cuBLAS
//   product; with one or two winners a node the bits are the same, with
//   more they may differ by an ulp (the parity bar allows 1e-6).
//
// Pass B reads used after pass A's update where PyTorch reads it from
// before: the two differ only on pass A's rows, which no pass-B proposal
// can choose (they read NEG_INF).  Each entry point launches on the
// caller's stream, allocates nothing and returns the first CUDA error.
// Scratch the caller keeps between rounds: keys and va are zero before a
// pass and the resolve step zeroes them again; skip is zero before a
// round and pass B's resolve clears pass A's rows.

#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>

namespace {

constexpr float kNegInf = -1e30f;
constexpr float kNegHalf = kNegInf * 0.5f;
constexpr float kSlack = 1e-6f;
constexpr int kMaxPods = 1024;
constexpr int kMaxRes = 4;
constexpr int kMaxWords = 8;
constexpr int kMaxLevels = 12;  // odd/even levels of 1,024 proposals
constexpr int kMaxDevices = 64;

// Argmax and continue-test tiles: 256 pods (8 a lane) x 32 node rows
// (4 a warp), so a warp reads 128-byte runs of a row.
constexpr int kColThreads = 256;
constexpr int kColWarps = kColThreads / 32;
constexpr int kColsPerLane = 8;
constexpr int kTileCols = 32 * kColsPerLane;
constexpr int kTileRows = 32;
constexpr int kRowsPerWarp = kTileRows / kColWarps;
constexpr int kPatchThreads = 256;

static_assert(kTileCols == kColThreads, "one merged column a thread");

struct RoundIn {
  const float* raw;       // [n, p] static raw score, node-major
  const uint8_t* ok;      // [n, p] static mask
  const int* rank;        // [p] priority rank
  const float* cap;       // [n, r]
  const float* cap_eps;   // [n, r] cap clamped to eps
  const int* node_zone;   // [n]
  const float* req;       // [p, r]
  const int* affinity;    // [p, w]
  const int* anti;        // [p, w]
  const int* group_bit;   // [p, w]
  const uint8_t* valid;   // [p]
  float w_bal, eps;
  int n, p, r, w, z;
};

struct RoundCarry {
  float* core;         // [n, p]
  float* used;         // [n, r]
  int* groups;         // [n, w]
  int* resident_anti;  // [n, w]
  int* gz;             // [32 w, z]
  int* assignment;     // [p], -1 = unassigned
};

struct RoundScratch {
  unsigned long long* keys;  // [p, 2] top-two keys of a pass
  unsigned int* va;          // [p] ordered max over pass A's rows
  uint8_t* skip;             // [n] rows pass A patched
  int* rows;                 // [2, p] winner node rows of each pass
  int* counts;               // [3] their counts, then progress
  uint8_t* cont;             // [1] the continue flag
};

// Float bits in an order unsigned comparison keeps; -0.0 maps as +0.0.
__device__ __forceinline__ unsigned int ordered(float f) {
  const unsigned int b = __float_as_uint(__fadd_rn(f, 0.0f));
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

__device__ __forceinline__ float unordered(unsigned int u) {
  return __uint_as_float((u & 0x80000000u) ? (u & 0x7fffffffu) : ~u);
}

// Keep the two largest of a set of distinct keys (0 = none).
__device__ __forceinline__ void push(unsigned long long& a,
                                     unsigned long long& b,
                                     unsigned long long k) {
  if (k > a) {
    b = a;
    a = k;
  } else if (k > b) {
    b = k;
  }
}

__device__ __forceinline__ bool alive(const int* assignment,
                                      const uint8_t* valid, int col) {
  return assignment[col] == -1 && valid[col] != 0;
}

// (choice, best, second) of every alive pod: per tile the two largest
// keys (ordered score << 32 | ~row) of each column, then per column two
// atomicMax into keys[col] and keys[col] + 1.  The first receives the
// largest key; the second every key that was not the largest when it
// met the first, hence the largest of all but the first.  With skip,
// the flagged rows count as NEG_INF and their real values go into va.
__global__ void __launch_bounds__(kColThreads)
round_colmax_kernel(const float* __restrict__ core,
                    const int* __restrict__ assignment,
                    const uint8_t* __restrict__ valid,
                    const uint8_t* __restrict__ skip,
                    unsigned long long* keys, unsigned int* va, int n,
                    int p) {
  __shared__ unsigned long long top[2][kColWarps][kTileCols];
  __shared__ unsigned int top_va[kColWarps][kTileCols];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int col0 = blockIdx.y * kTileCols;
  const int row0 = blockIdx.x * kTileRows;
  bool live[kColsPerLane];
  unsigned long long k1[kColsPerLane], k2[kColsPerLane];
  unsigned int vm[kColsPerLane];
#pragma unroll
  for (int c = 0; c < kColsPerLane; ++c) {
    const int col = col0 + lane + 32 * c;
    live[c] = col < p && alive(assignment, valid, col);
    k1[c] = k2[c] = 0ull;
    vm[c] = 0u;
  }
  float v[kRowsPerWarp][kColsPerLane];
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    const int row = row0 + warp + i * kColWarps;
    const float* src = core + static_cast<size_t>(row) * p + col0 + lane;
#pragma unroll
    for (int c = 0; c < kColsPerLane; ++c)
      v[i][c] = (row < n && col0 + lane + 32 * c < p) ? src[32 * c]
                                                     : kNegInf;
  }
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    const int row = row0 + warp + i * kColWarps;
    if (row >= n) break;
    const bool skipped = skip != nullptr && skip[row] != 0;
    const unsigned long long low = 0xffffffffull - static_cast<unsigned>(row);
#pragma unroll
    for (int c = 0; c < kColsPerLane; ++c) {
      if (!live[c]) continue;
      float x = v[i][c];
      if (skipped) {
        vm[c] = max(vm[c], ordered(x));
        x = kNegInf;
      }
      push(k1[c], k2[c],
           (static_cast<unsigned long long>(ordered(x)) << 32) | low);
    }
  }
#pragma unroll
  for (int c = 0; c < kColsPerLane; ++c) {
    top[0][warp][lane + 32 * c] = k1[c];
    top[1][warp][lane + 32 * c] = k2[c];
    top_va[warp][lane + 32 * c] = vm[c];
  }
  __syncthreads();
  const int col = col0 + threadIdx.x;
  if (col >= p || !alive(assignment, valid, col)) return;
  unsigned long long a = 0ull, b = 0ull;
  unsigned int m = 0u;
  for (int w = 0; w < kColWarps; ++w) {
    push(a, b, top[0][w][threadIdx.x]);
    push(a, b, top[1][w][threadIdx.x]);
    m = max(m, top_va[w][threadIdx.x]);
  }
  if (a == 0ull) return;
  unsigned long long* k = keys + 2 * static_cast<size_t>(col);
  const unsigned long long old = atomicMax(k, a);
  if (old != 0ull) atomicMax(k + 1, old < a ? old : a);
  if (b != 0ull) atomicMax(k + 1, b);
  if (m != 0u) atomicMax(va + col, m);
}

// _assoc_cumsum0 over p values in each resource's [2p] region of buf
// (level 0 holds the values; on return, their inclusive sums): the pair
// sums of each level up, then out[2k+1] = up[k] and out[2k] = up[k-1] +
// x[2k] down, every level in place.
__device__ void assoc_cumsum(float* buf, int p, int nres) {
  int off[kMaxLevels], len[kMaxLevels];
  int levels = 0, o = 0, m = p;
  off[0] = 0;
  len[0] = p;
  while (m >= 2) {
    const int h = m / 2;
    for (int k = threadIdx.x; k < h * nres; k += blockDim.x) {
      const int rr = k / h, j = k - rr * h;
      float* x = buf + rr * 2 * p;
      x[o + m + j] = __fadd_rn(x[o + 2 * j], x[o + 2 * j + 1]);
    }
    __syncthreads();
    o += m;
    m = h;
    ++levels;
    off[levels] = o;
    len[levels] = m;
  }
  for (int l = levels - 1; l >= 0; --l) {
    const int lo = off[l], lm = len[l], up = off[l + 1];
    for (int k = threadIdx.x; k < lm * nres; k += blockDim.x) {
      const int rr = k / lm, j = k - rr * lm;
      float* x = buf + rr * 2 * p;
      if (j & 1)
        x[lo + j] = x[up + (j - 1) / 2];
      else if (j > 0)
        x[lo + j] = __fadd_rn(x[up + j / 2 - 1], x[lo + j]);
    }
    __syncthreads();
  }
}

size_t resolve_smem(int p, int nres, int nwords) {
  // key, choice, second, perm, gid, segment start, winner node (7 p);
  // requests, group and anti words (p r + 2 p w); the prefix sums
  // (2 p r), the segment bases (p r), the scanned words (2 p w).
  return sizeof(int) * static_cast<size_t>(p) *
         (7 + 4 * nres + 4 * nwords);
}

// One pass of the multi-accept prefix and its state updates, in one
// block of at least p threads (thread t: pod t, then sorted position t).
// Every input a pass reads more than once is staged in shared memory
// first, each thread issuing all of its loads before it uses one.
__global__ void __launch_bounds__(kMaxPods)
round_resolve_kernel(RoundIn in, RoundCarry cy, RoundScratch sc,
                     int pass_b) {
  extern __shared__ int sm[];
  const int p = in.p, n = in.n, nr = in.r, nw = in.w;
  int* key = sm;                                        // by pod
  int* chs = key + p;                                   // by pod
  float* secs = reinterpret_cast<float*>(chs + p);      // by pod
  int* perm = reinterpret_cast<int*>(secs + p);         // sorted -> pod
  int* gid = perm + p;                                  // sorted
  int* segst = gid + p;                                 // sorted
  int* wnode = segst + p;                               // by pod
  float* req = reinterpret_cast<float*>(wnode + p);     // [p][r] by pod
  int* gbit = reinterpret_cast<int*>(req + p * nr);     // [p][w] by pod
  int* abit = gbit + p * nw;                            // [p][w] by pod
  float* scan = reinterpret_cast<float*>(abit + p * nw);  // [r][2p]
  float* cmx = scan + 2 * p * nr;                       // [r][p]
  int* orb = reinterpret_cast<int*>(cmx + p * nr);      // [2w][p]
  __shared__ int n_rows, any_win;
  const int t = threadIdx.x;
  const bool on = t < p;
  if (t == 0) {
    n_rows = 0;
    any_win = 0;
  }

  // 0. Each pod's proposal, decoded from the argmax keys (then zeroed
  //    for the next pass), and its requests and mask words.
  float rq[kMaxRes];
  int gw[kMaxWords], aw[kMaxWords];
  if (on) {
    const unsigned long long k1 = sc.keys[2 * t], k2 = sc.keys[2 * t + 1];
    const unsigned int vmx = sc.va[t];
    const int rank = in.rank[t];
#pragma unroll
    for (int rr = 0; rr < kMaxRes; ++rr)
      rq[rr] = rr < nr ? in.req[t * nr + rr] : 0.0f;
#pragma unroll
    for (int k = 0; k < kMaxWords; ++k) {
      gw[k] = k < nw ? in.group_bit[t * nw + k] : 0;
      aw[k] = k < nw ? in.anti[t * nw + k] : 0;
    }
    sc.keys[2 * t] = sc.keys[2 * t + 1] = 0ull;
    sc.va[t] = 0u;
    int c = 0;
    float best = kNegInf, second = kNegInf;
    if (k1 != 0ull) {
      c = static_cast<int>(0xffffffffu - static_cast<unsigned>(k1));
      best = unordered(static_cast<unsigned>(k1 >> 32));
      if (k2 != 0ull) second = unordered(static_cast<unsigned>(k2 >> 32));
    }
    bool feas = best > kNegHalf;
    if (pass_b) {
      const float va = vmx != 0u ? unordered(vmx) : kNegInf;
      feas = feas && best >= __fsub_rn(va, kSlack);
      second = fmaxf(second, va);
    }
    key[t] = (feas ? c : n) * p + rank;
    chs[t] = c;
    secs[t] = second;
#pragma unroll
    for (int rr = 0; rr < kMaxRes; ++rr)
      if (rr < nr) req[t * nr + rr] = rq[rr];
#pragma unroll
    for (int k = 0; k < kMaxWords; ++k)
      if (k < nw) {
        gbit[t * nw + k] = gw[k];
        abit[t * nw + k] = aw[k];
      }
  }
  __syncthreads();

  // 1. Sorted positions: the keys are unique, so each is its count of
  //    smaller keys.
  if (on) {
    const int mine = key[t];
    int pos = 0;
#pragma unroll 16
    for (int j = 0; j < p; ++j) pos += key[j] < mine;
    perm[pos] = t;
  }
  __syncthreads();

  // 2. The sorted view: node (n = no proposal), requests.
  int pod = 0, g = n;
  if (on) {
    pod = perm[t];
    g = key[pod] / p;
    gid[t] = g;
    for (int rr = 0; rr < nr; ++rr)
      scan[rr * 2 * p + t] = req[pod * nr + rr];
  }
  __syncthreads();
  const bool first = on && (t == 0 || gid[t - 1] != g);

  // The node row this position reads, loaded while the scans run.
  const int node = min(g, n - 1);
  float u[kMaxRes], cp[kMaxRes], ce[kMaxRes];
  float raw_sel = 0.0f;
  if (on) {
#pragma unroll
    for (int rr = 0; rr < kMaxRes; ++rr)
      if (rr < nr) {
        u[rr] = cy.used[node * nr + rr];
        cp[rr] = in.cap[node * nr + rr];
        ce[rr] = in.cap_eps[node * nr + rr];
      }
    const int crow = min(max(chs[pod], 0), n - 1);
    raw_sel = in.raw[static_cast<size_t>(crow) * p + pod];
  }

  // 3. The capacity prefix, in lax.associative_scan's order.
  assoc_cumsum(scan, p, nr);

  // 4. Segment bases (csum - req at each segment's first row, a running
  //    max as _cummax0 takes it) and segment starts.
  if (on) {
    for (int rr = 0; rr < nr; ++rr)
      cmx[rr * p + t] =
          first ? __fsub_rn(scan[rr * 2 * p + t], req[pod * nr + rr])
                : __uint_as_float(0xff800000u);  // -inf
    segst[t] = first ? t : -1;
  }
  __syncthreads();
  for (int d = 1; d < p; d <<= 1) {
    float m[kMaxRes];
    int s0 = -1;
    const bool take = on && t >= d;
    if (take) {
#pragma unroll
      for (int rr = 0; rr < kMaxRes; ++rr)
        if (rr < nr) m[rr] = cmx[rr * p + t - d];
      s0 = segst[t - d];
    }
    __syncthreads();
    if (take) {
#pragma unroll
      for (int rr = 0; rr < kMaxRes; ++rr)
        if (rr < nr) cmx[rr * p + t] = fmaxf(cmx[rr * p + t], m[rr]);
      segst[t] = max(segst[t], s0);
    }
    __syncthreads();
  }

  // 5. Cumulative fit, the balance re-priced with everyone queued ahead,
  //    and whether the node stays each member's best.
  bool good = false;
  if (on) {
    bool fits = true;
    float bal = 0.0f;
#pragma unroll
    for (int rr = 0; rr < kMaxRes; ++rr)
      if (rr < nr) {
        const float seg = __fsub_rn(scan[rr * 2 * p + t], cmx[rr * p + t]);
        fits = fits && seg <= __fadd_rn(__fsub_rn(cp[rr], u[rr]), in.eps);
        const float f = __fdiv_rn(__fadd_rn(u[rr], seg), ce[rr]);
        bal = rr == 0 ? f : fmaxf(bal, f);
      }
    const float adj = __fsub_rn(raw_sel, __fmul_rn(in.w_bal, bal));
    good = fits && adj >= __fsub_rn(secs[pod], kSlack);
    for (int k = 0; k < nw; ++k) {
      orb[k * p + t] = gbit[pod * nw + k];
      orb[(nw + k) * p + t] = abit[pod * nw + k];
    }
  }
  __syncthreads();

  // 6. Segmented inclusive OR of the group and anti words.
  for (int d = 1; d < p; d <<= 1) {
    int o[2 * kMaxWords];
    const bool take = on && t - d >= segst[t];
    if (take) {
#pragma unroll
      for (int k = 0; k < 2 * kMaxWords; ++k)
        if (k < 2 * nw) o[k] = orb[k * p + t - d];
    }
    __syncthreads();
    if (take) {
#pragma unroll
      for (int k = 0; k < 2 * kMaxWords; ++k)
        if (k < 2 * nw) orb[k * p + t] |= o[k];
    }
    __syncthreads();
  }
  if (on && !first) {
    for (int k = 0; k < nw; ++k) {
      const int ex_g = orb[k * p + t - 1], ex_a = orb[(nw + k) * p + t - 1];
      if ((ex_a & gbit[pod * nw + k]) != 0 || (ex_g & abit[pod * nw + k]) != 0)
        good = false;
    }
  }

  // 7. The prefix each node accepts: no bad member from its segment's
  //    start up to here (a running max of the bad positions).
  __syncthreads();
  int* last_bad = key;  // by-pod keys are read no more
  if (on) last_bad[t] = good ? -1 : t;
  __syncthreads();
  for (int d = 1; d < p; d <<= 1) {
    const bool take = on && t >= d;
    const int b = take ? last_bad[t - d] : -1;
    __syncthreads();
    if (take) last_bad[t] = max(last_bad[t], b);
    __syncthreads();
  }
  if (on) {
    const bool win = (first || last_bad[t] < segst[t]) && g < n;
    wnode[pod] = win ? g : -1;
    if (win) any_win = 1;
  }
  __syncthreads();

  // 8. State updates.  Pod t: its assignment and zone counts.  The first
  //    member of each node's segment: the node's row, its winners summed
  //    in pod-index order.
  if (on) {
    const int mine = wnode[t];
    if (mine >= 0) {
      cy.assignment[t] = mine;
      const int zone = in.node_zone[mine];
      if (zone >= 0) {
        const int zc = min(zone, in.z - 1);
#pragma unroll
        for (int k = 0; k < kMaxWords; ++k) {
          unsigned int bits = k < nw ? static_cast<unsigned>(gw[k]) : 0u;
          while (bits) {
            const int b = __ffs(bits) - 1;
            bits &= bits - 1;
            atomicAdd(cy.gz + (k * 32 + b) * in.z + zc, 1);
          }
        }
      }
    }
    if (first && g < n) {
      float add[kMaxRes];
      int og[kMaxWords], oa[kMaxWords], rg[kMaxWords], ra[kMaxWords];
#pragma unroll
      for (int k = 0; k < kMaxWords; ++k) {
        rg[k] = k < nw ? cy.groups[g * nw + k] : 0;
        ra[k] = k < nw ? cy.resident_anti[g * nw + k] : 0;
        og[k] = oa[k] = 0;
      }
#pragma unroll
      for (int rr = 0; rr < kMaxRes; ++rr) add[rr] = 0.0f;
      constexpr int kAhead = 8;  // winner tests in flight at once
      for (int j0 = 0; j0 < p; j0 += kAhead) {
        int wn[kAhead];
#pragma unroll
        for (int q = 0; q < kAhead; ++q)
          wn[q] = j0 + q < p ? wnode[j0 + q] : -1;
#pragma unroll
        for (int q = 0; q < kAhead; ++q) {
          if (wn[q] != g) continue;
          const int j = j0 + q;
#pragma unroll
          for (int rr = 0; rr < kMaxRes; ++rr)
            if (rr < nr) add[rr] = __fadd_rn(add[rr], req[j * nr + rr]);
#pragma unroll
          for (int k = 0; k < kMaxWords; ++k)
            if (k < nw) {
              og[k] |= gbit[j * nw + k];
              oa[k] |= abit[j * nw + k];
            }
        }
      }
#pragma unroll
      for (int rr = 0; rr < kMaxRes; ++rr)
        if (rr < nr) cy.used[g * nr + rr] = __fadd_rn(u[rr], add[rr]);
#pragma unroll
      for (int k = 0; k < kMaxWords; ++k)
        if (k < nw) {
          cy.groups[g * nw + k] = rg[k] | og[k];
          cy.resident_anti[g * nw + k] = ra[k] | oa[k];
        }
      sc.rows[pass_b * p + atomicAdd(&n_rows, 1)] = g;
      if (!pass_b) sc.skip[g] = 1;
    }
  }
  if (pass_b)  // pass A's rows are read no more this round
    for (int k = t; k < sc.counts[0]; k += blockDim.x) sc.skip[sc.rows[k]] = 0;
  __syncthreads();
  if (t == 0) {
    sc.counts[pass_b] = n_rows;
    if (!pass_b) {
      sc.counts[2] = any_win;
      *sc.cont = 0;
    } else if (any_win) {
      sc.counts[2] = 1;
    }
  }
}

// The core at each listed node row, recomputed against the current
// state: static mask, capacity fit, affinity, anti-affinity both ways,
// retirement of assigned pods, raw score minus the balance penalty.
__global__ void __launch_bounds__(kPatchThreads)
round_patch_kernel(RoundIn in, RoundCarry cy, const int* rows,
                   const int* count) {
  if (static_cast<int>(blockIdx.x) >= *count) return;
  const int node = rows[blockIdx.x];
  const int p = in.p, nr = in.r, nw = in.w;
  __shared__ float used[kMaxRes], room[kMaxRes], ceps[kMaxRes];
  __shared__ int gw[kMaxWords], aw[kMaxWords];
  if (threadIdx.x < nr) {
    const float u = cy.used[node * nr + threadIdx.x];
    used[threadIdx.x] = u;
    room[threadIdx.x] =
        __fadd_rn(__fsub_rn(in.cap[node * nr + threadIdx.x], u), in.eps);
    ceps[threadIdx.x] = in.cap_eps[node * nr + threadIdx.x];
  }
  if (threadIdx.x < nw) {
    gw[threadIdx.x] = cy.groups[node * nw + threadIdx.x];
    aw[threadIdx.x] = cy.resident_anti[node * nw + threadIdx.x];
  }
  __syncthreads();
  const size_t base = static_cast<size_t>(node) * p;
  for (int q = threadIdx.x; q < p; q += blockDim.x) {
    bool ok = in.ok[base + q] != 0 && cy.assignment[q] == -1;
    float bal = 0.0f;
    for (int rr = 0; rr < nr; ++rr) {
      const float rq = in.req[q * nr + rr];
      ok = ok && rq <= room[rr];
      const float f = __fdiv_rn(__fadd_rn(used[rr], rq), ceps[rr]);
      bal = rr == 0 ? f : fmaxf(bal, f);
    }
    for (int k = 0; k < nw; ++k) {
      const int a = in.affinity[q * nw + k];
      ok = ok && (gw[k] & a) == a && (gw[k] & in.anti[q * nw + k]) == 0 &&
           (aw[k] & in.group_bit[q * nw + k]) == 0;
    }
    cy.core[base + q] =
        ok ? __fsub_rn(in.raw[base + q], __fmul_rn(in.w_bal, bal)) : kNegInf;
  }
}

// cont = a pod was placed this round and an unassigned pod still has a
// feasible row.
__global__ void __launch_bounds__(kColThreads)
round_cont_kernel(const float* __restrict__ core,
                  const int* __restrict__ assignment,
                  const uint8_t* __restrict__ valid,
                  const int* __restrict__ progress, uint8_t* cont, int n,
                  int p) {
  if (*progress == 0) return;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int col0 = blockIdx.y * kTileCols;
  const int row0 = blockIdx.x * kTileRows;
  bool hit[kColsPerLane];
#pragma unroll
  for (int c = 0; c < kColsPerLane; ++c) {
    const int col = col0 + lane + 32 * c;
    hit[c] = false;
    if (col >= p) continue;
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) {
      const int row = row0 + warp + i * kColWarps;
      if (row < n)
        hit[c] |= core[static_cast<size_t>(row) * p + col] > kNegHalf;
    }
  }
  bool found = false;
#pragma unroll
  for (int c = 0; c < kColsPerLane; ++c) {
    const int col = col0 + lane + 32 * c;
    found |= hit[c] && alive(assignment, valid, col);
  }
  if (found) *cont = 1;
}

// The resolve step's shared memory above the default 48 KB is an opt-in
// of the current device's context (up to 220 KB at p = 1,024, r = 4,
// w = 8).  Each device records the largest size it was given, under a
// lock: callers on several threads or devices each see their own.
cudaError_t opt_in_smem(size_t smem) {
  static std::mutex mu;
  static size_t opted[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  std::lock_guard<std::mutex> hold(mu);
  if (smem <= opted[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(round_resolve_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err == cudaSuccess) opted[dev] = smem;
  return err;
}

}  // namespace

// One round on the caller's stream: pass A (argmax, resolve, row patch),
// pass B (the same, pass A's rows skipped), the continue test; seven
// launches, the carry updated in place, *cont written.  p <= 1,024,
// r <= 4 and w <= 8, or cudaErrorInvalidValue.
extern "C" int conflict_round(
    const float* raw, const uint8_t* ok, const int* rank, const float* cap,
    const float* cap_eps, const int* node_zone, const float* req,
    const int* affinity, const int* anti, const int* group_bit,
    const uint8_t* valid, float* core, float* used, int* groups,
    int* resident_anti, int* gz, int* assignment, unsigned long long* keys,
    unsigned int* va, uint8_t* skip, int* rows, int* counts, uint8_t* cont,
    float w_bal, float eps, int n, int p, int nres, int nwords, int z,
    void* stream) {
  if (n <= 0 || p <= 0) return static_cast<int>(cudaGetLastError());
  if (p > kMaxPods || nres > kMaxRes || nwords > kMaxWords || nres <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  RoundIn in{raw, ok, rank, cap, cap_eps, node_zone, req, affinity, anti,
             group_bit, valid, w_bal, eps, n, p, nres, nwords, z};
  RoundCarry cy{core, used, groups, resident_anti, gz, assignment};
  RoundScratch sc{keys, va, skip, rows, counts, cont};
  const size_t smem = resolve_smem(p, nres, nwords);
  if (smem > 48 * 1024) {
    const cudaError_t err = opt_in_smem(smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 tiles((n + kTileRows - 1) / kTileRows,
                   (p + kTileCols - 1) / kTileCols);
  const int threads = (p + 31) / 32 * 32;
  const int patch_blocks = p < n ? p : n;
  cudaError_t err;
  for (int pass = 0; pass < 2; ++pass) {
    round_colmax_kernel<<<tiles, kColThreads, 0, s>>>(
        core, assignment, valid, pass ? skip : nullptr, keys, va, n, p);
    if ((err = cudaGetLastError()) != cudaSuccess)
      return static_cast<int>(err);
    round_resolve_kernel<<<1, threads, smem, s>>>(in, cy, sc, pass);
    if ((err = cudaGetLastError()) != cudaSuccess)
      return static_cast<int>(err);
    round_patch_kernel<<<patch_blocks, kPatchThreads, 0, s>>>(
        in, cy, rows + pass * p, counts + pass);
    if ((err = cudaGetLastError()) != cudaSuccess)
      return static_cast<int>(err);
  }
  round_cont_kernel<<<tiles, kColThreads, 0, s>>>(core, assignment, valid,
                                                  counts + 2, cont, n, p);
  return static_cast<int>(cudaGetLastError());
}
