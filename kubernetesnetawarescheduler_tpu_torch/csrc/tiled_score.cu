// Tiled pod x node score kernels for NVIDIA Hopper (sm_90a).
//
// They replace the three Pallas kernels of the JAX package
// (kubernetesnetawarescheduler_tpu/core/pallas_score.py), which share
// one accumulation, _net_accum:
//
//   static_scores_kernel  (_static_kernel) raw = T·Cᵀ + base +
//                         wsoft·soft and the static mask (validity,
//                         taints, node selectors); the batch-invariant
//                         half of the assign path.
//   masked_scores_kernel  (_kernel) the same accumulation, then the full
//                         masked epilogue: capacity fit, five bit-mask
//                         tests, soft bonus, balance penalty, NEG_INF
//                         where infeasible; the Score/Filter answer.
//   winner_scores_kernel  (_winner_kernel) the masked kernel's scores
//                         (one shared epilogue, masked_score) reduced
//                         per pod to (best, lowest node index) across
//                         node tiles; writes 8 bytes per pod, never the
//                         P x N plane.
//   static_scores_lanes_kernel  the static kernel over a lane axis (the
//                         fleet's tenants, vmapped in JAX): blockIdx.z is
//                         the lane, each lane's slices of the stacked
//                         inputs go through the solo tile body.
//
// C[n, k] = wbw·bw[n, k]·inv_bw − wlat·lat[n, k]·inv_lat is formed per
// tile in shared memory from the raw bw/lat matrices (C never exists in
// device memory), with the diagonal pinned to wbw by GLOBAL row index
// (params[7] is the row offset of output row 0) and invalid peer
// columns zeroed.  With use_bf16 set, T and C are rounded to bf16 and
// the product still accumulates in f32 registers.
//
// What bounds them: T[P, n_k] holds at most max_peers non-zeros per pod
// (192 columns of 5,120 in a 128-pod stream batch), so the function
// needs only T, the bw/lat columns of the peers the batch uses, the
// node and pod planes and the outputs: ≈13 MB at P=128, N=5,120, a
// bytes bound of ≈0.004 ms at 3.35 TB/s (≈10 MB for the winner, which
// writes 8 bytes per pod); the 2·nnz(T)·N FLOPs are nothing.  Walking
// all n_k columns instead reads the full 210 MB of bw/lat.
//
// All three kernels walk the batch's peer columns only:
// - peer_flags_kernel and peer_scan_kernel compact the batch's peer
//   columns on the device: cols = the ascending k with any T[:, k] != 0,
//   count in device memory (never on the host), cols[count:] = -1.
// - peer_traffic_kernel copies T[:, cols[j]] into a peer-major scratch
//   tk[j, :] once per call (bf16-rounded when asked), so no node tile
//   gathers the same scattered T entries again.
// - net_accum_peers walks only those columns, 32 per step: each step
//   copies the 32 rows of tk (16 bytes a thread) and gathers
//   bw[n, cols[j]], lat[n, cols[j]] and validk[cols[j]] (4 bytes a
//   thread) into shared memory with cp.async, two stages deep, so the
//   next step's copies fly while this step's FMAs run.  C is formed
//   from the staged raw values with the _rn operations of the plain
//   version; the diagonal pin and validk use the gathered column
//   cols[j].  Each (p, n) accumulates with fmaf over cols in ascending
//   order, and a skipped column would have added fmaf(0, c, acc) == acc
//   (c finite), so the result has the same bits as the dense walk over
//   every column (cols = arange(n_k), count = n_k, is that dense walk).
// - The scattered bw/lat gathers, one 32-byte sector per element in the
//   row-major [n_out, n_k] layout, are what is left of the cost.  Tiles
//   are 128 pods x 16 nodes, so each column of a node row is gathered
//   once per call (P <= 128), and 320 blocks at P=128, N=5,120 keep
//   about three resident per SM; each thread holds a 4 x 2 register
//   tile.  The output tile is staged in shared memory and stored in the
//   layout asked for: [P, N] in 64-byte pod-row runs, node-major [N, P]
//   in 512-byte node-row runs.
// - The winner runs the same walk and the masked kernel's epilogue on the
//   same tile, then reduces it in registers: the 8 lanes of a pod row
//   each take the best of their 2 nodes, a 3-step xor shuffle the row's
//   best, and one atomicMax per pod row and tile (40,960 at P=128,
//   N=5,120, 320 per pod) folds the tiles.  It stores no output tile;
//   zeroing the keys and unpacking them are two more short launches.
//
// Every ragged edge is masked in the kernels, so the host pads nothing.
// Elementwise arithmetic outside the accumulation uses the _rn
// intrinsics so the compiler cannot contract it into FMAs: the tile
// epilogue then rounds exactly as the plain PyTorch versions do, and
// only the order of the f32 accumulation differs between the two.
//
// Params layout (f32[8]): wbw, wlat, inv_bw, inv_lat, wbal, eps, wsoft,
// row_offset.  Bit masks are int32 words (the u32 bits of the JAX
// package).  Each entry point launches on the caller's stream, allocates
// nothing (scratch comes from the caller), and returns the first CUDA
// error it meets.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;

struct NetIn {
  const float* t;       // [p, n_k]
  const float* bw;      // [n_out, n_k]
  const float* lat;     // [n_out, n_k]
  const float* validk;  // [n_k]
  const float* params;  // [8]
  int p, n_out, n_k, use_bf16;
};

struct NodeIn {
  const float* base;        // [n_out]
  const float* valid;       // [n_out] (1.0 = valid)
  const int* taint;         // [n_out, mw]
  const int* label;         // [n_out, mw]
  const int* groups;        // [n_out, mw]
  const int* resident_anti; // [n_out, mw]   (masked kernel only)
  const float* used;        // [n_out, n_res] (masked kernel only)
  const float* cap;         // [n_out, n_res] (masked kernel only)
};

struct PodIn {
  const float* valid;       // [p] (1.0 = valid)
  const float* req;         // [p, n_res]     (masked kernel only)
  const int* tol;           // [p, mw]
  const int* sel;           // [p, mw]
  const int* affinity;      // [p, mw]        (masked kernel only)
  const int* anti;          // [p, mw]        (masked kernel only)
  const int* group_bit;     // [p, mw]        (masked kernel only)
  const int* soft_sel;      // [p, t_soft, mw]
  const int* soft_grp;      // [p, t_soft, mw]
  const float* soft_sel_w;  // [p, t_soft], zero for empty-bit terms
  const float* soft_grp_w;  // [p, t_soft], zero for empty-bit terms
};

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

// ---------------------------------------------------------------------
// The peer-column walk of the three score kernels.
// ---------------------------------------------------------------------

constexpr int kQThreads = 256;  // threads per block
constexpr int kQP = 128;        // pods per block tile
constexpr int kQN = 16;         // output nodes per block tile
constexpr int kQK = 32;         // peer columns per step
constexpr int kQRP = 4;         // pods per thread
constexpr int kQRN = 2;         // nodes per thread
constexpr int kTN = kQN / kQRN;        // threads across the tile's nodes
constexpr int kTP = kQThreads / kTN;   // threads across the tile's pods
constexpr int kRows = kQThreads / kQK;  // node rows per gather pass
static_assert(kTP * kQRP == kQP, "pod tile");
static_assert(kQN % kRows == 0, "node gather rows");
static_assert(kQP % 4 == 0, "16-byte traffic rows");

struct PeersIn {
  const int* cols;   // [n_k] ascending peer columns, -1 past count
  const int* count;  // [1]
  const float* tk;   // [n_k, p_pad] T[p, cols[j]], peer-major (rows < count)
  int p_pad;         // p rounded up to 4, so each row is 16-byte aligned
};

// One pipeline stage: the step's 32 peer columns.  The traffic rows are
// copied whole (16 bytes a thread); the bw/lat columns are gathered
// 4 bytes a thread, transposed so a warp's 32 columns hit 32 banks.
struct PeerStage {
  alignas(16) float t[kQK][kQP + 4];  // tk[j, p0:p0+128]
  float c[kQK][kQN + 1];    // bw[n, col], then C[n, col] in place
  float lat[kQK][kQN + 1];  // lat[n, col]
  float vk[kQK];            // validk[col]
};

// The output tile, staged for a coalesced store; it reuses the stages.
struct OutTile {
  float v[kQP][kQN + 1];
  uint8_t ok[kQP][kQN + 4];
};

union PeerSmem {
  PeerStage st[2];
  OutTile out;
};

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Every group but the newest has landed (this thread's copies).
__device__ __forceinline__ void cp_async_wait_prev() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// The peer column this thread gathers at step s (its lane is j % 32),
// or -1 past the batch's count.
__device__ __forceinline__ int step_col(const PeersIn& pr, int count,
                                        int s) {
  const int j = s * kQK + threadIdx.x % kQK;
  return j < count ? __ldg(pr.cols + j) : -1;
}

// Issue this thread's copies of step s into `st`: four 16-byte pieces of
// the step's traffic rows, and column `col` (-1: zeros) of bw, lat and
// validk at node rows threadIdx.x / 32 + 8i.
__device__ __forceinline__ void gather_step(const NetIn& in,
                                            const PeersIn& pr, int count,
                                            int s, int p0, int n0, int col,
                                            PeerStage& st) {
#pragma unroll
  for (int i = 0; i < kQK * kQP / 4 / kQThreads; ++i) {
    const int e = threadIdx.x + kQThreads * i;
    const int jj = e / (kQP / 4);
    const int pp = 4 * (e % (kQP / 4));
    const int j = s * kQK + jj;
    if (j < count && p0 + pp < pr.p_pad) {
      cp_async16(&st.t[jj][pp], pr.tk + (size_t)j * pr.p_pad + p0 + pp);
    } else {
#pragma unroll
      for (int q = 0; q < 4; ++q) st.t[jj][pp + q] = 0.f;
    }
  }
  const int jj = threadIdx.x % kQK;
  const int r = threadIdx.x / kQK;
#pragma unroll
  for (int i = 0; i < kQN / kRows; ++i) {
    const int nn = r + kRows * i;
    const int n = n0 + nn;
    if (col >= 0 && n < in.n_out) {
      const size_t off = (size_t)n * in.n_k + col;
      cp_async4(&st.c[jj][nn], in.bw + off);
      cp_async4(&st.lat[jj][nn], in.lat + off);
    } else {
      st.c[jj][nn] = 0.f;
      st.lat[jj][nn] = 0.f;
    }
  }
  if (r == 0) {
    if (col >= 0)
      cp_async4(&st.vk[jj], in.validk + col);
    else
      st.vk[jj] = 0.f;
  }
}

// acc[i][j] = Σ_{k in cols} T[p0 + ty + 32i, k] · C[n0 + tx + 8j, k],
// k ascending; the same bits as the dense walk over every column.
__device__ __forceinline__ void net_accum_peers(const NetIn& in,
                                                const PeersIn& pr, int p0,
                                                int n0, PeerSmem& sm,
                                                float (&acc)[kQRP][kQRN]) {
  const int tid = threadIdx.x;
  const int tx = tid % kTN;
  const int ty = tid / kTN;
  const int jj = tid % kQK;
  const int r = tid / kQK;
  const float wbw = in.params[0];
  const float wlat = in.params[1];
  const float inv_bw = in.params[2];
  const float inv_lat = in.params[3];
  const int row_off = static_cast<int>(in.params[7]);
  const int count = *pr.count;
  const int steps = (count + kQK - 1) / kQK;

#pragma unroll
  for (int i = 0; i < kQRP; ++i)
#pragma unroll
    for (int j = 0; j < kQRN; ++j) acc[i][j] = 0.f;

  int col = steps > 0 ? step_col(pr, count, 0) : -1;
  if (steps > 0) gather_step(in, pr, count, 0, p0, n0, col, sm.st[0]);
  cp_async_commit();
  int col_next = steps > 1 ? step_col(pr, count, 1) : -1;
  for (int s = 0; s < steps; ++s) {
    PeerStage& st = sm.st[s & 1];
    // The stage s + 1 writes was last read in step s - 1, before that
    // step's closing barrier.  An empty group keeps the count uniform.
    if (s + 1 < steps)
      gather_step(in, pr, count, s + 1, p0, n0, col_next,
                  sm.st[(s + 1) & 1]);
    cp_async_commit();
    const int col_after = s + 2 < steps ? step_col(pr, count, s + 2) : -1;
    cp_async_wait_prev();
    __syncthreads();
    // Form C in place, in desirability_plain's operation order (the
    // traffic rows arrive bf16-rounded already when use_bf16 is set).
#pragma unroll
    for (int i = 0; i < kQN / kRows; ++i) {
      const int nn = r + kRows * i;
      const int n = n0 + nn;
      float c = 0.f;
      if (col >= 0 && n < in.n_out) {
        c = __fsub_rn(__fmul_rn(__fmul_rn(wbw, st.c[jj][nn]), inv_bw),
                      __fmul_rn(__fmul_rn(wlat, st.lat[jj][nn]), inv_lat));
        if (row_off + n == col) c = wbw;
        c = __fmul_rn(c, st.vk[jj]);
        if (in.use_bf16) c = bf16_round(c);
      }
      st.c[jj][nn] = c;
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < kQK; ++kk) {
      float a[kQRP], b[kQRN];
#pragma unroll
      for (int i = 0; i < kQRP; ++i) a[i] = st.t[kk][ty + kTP * i];
#pragma unroll
      for (int j = 0; j < kQRN; ++j) b[j] = st.c[kk][tx + kTN * j];
#pragma unroll
      for (int i = 0; i < kQRP; ++i)
#pragma unroll
        for (int j = 0; j < kQRN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
    col = col_next;
    col_next = col_after;
  }
  cp_async_wait_all();
}

// Store the staged output tile: element (p, n) at p * sp + n * sn.  With
// sn == 1 a warp writes two pod rows of 16 consecutive nodes (64 bytes
// each), otherwise 32 consecutive pods of one node row (the node-major
// [N, P] layout).  `ok` may be null.
__device__ __forceinline__ void store_tile(const OutTile& out, float* v,
                                           uint8_t* ok, long long sp,
                                           long long sn, int p0, int n0,
                                           int p, int n_out) {
  for (int e = threadIdx.x; e < kQP * kQN; e += kQThreads) {
    const int pp = sn == 1 ? e / kQN : e % kQP;
    const int nn = sn == 1 ? e % kQN : e / kQP;
    const int pi = p0 + pp, ni = n0 + nn;
    if (pi >= p || ni >= n_out) continue;
    const size_t o = (size_t)pi * sp + (size_t)ni * sn;
    v[o] = out.v[pp][nn];
    if (ok != nullptr) ok[o] = out.ok[pp][nn];
  }
}

// Unscaled soft-affinity bonus of pod p on a node: Σ_t (label terms
// whose bits are all present) + (group terms with any overlap), added
// term by term in the plain version's order.  The word tests accumulate
// bitwise, without branches, so the loads of a term issue together.
__device__ float soft_bonus(const int* label_n, const int* group_n,
                            const PodIn& pd, int p, int mw, int t_soft) {
  float soft = 0.f;
  for (int t = 0; t < t_soft; ++t) {
    int miss = 0, hit = 0;
    const size_t row = ((size_t)p * t_soft + t) * mw;
#pragma unroll 4
    for (int w = 0; w < mw; ++w) {
      const int sb = pd.soft_sel[row + w];
      const int gb = pd.soft_grp[row + w];
      miss |= (label_n[w] & sb) ^ sb;
      hit |= group_n[w] & gb;
    }
    const float a = miss == 0 ? pd.soft_sel_w[(size_t)p * t_soft + t] : 0.f;
    const float b = hit != 0 ? pd.soft_grp_w[(size_t)p * t_soft + t] : 0.f;
    soft = __fadd_rn(soft, __fadd_rn(a, b));
  }
  return soft;
}

// One 128 x 16 tile of the static kernel's function (the body of
// static_scores_kernel and, per lane, of static_scores_lanes_kernel).
__device__ __forceinline__ void static_scores_tile(
    const NetIn& in, const PeersIn& pr, const NodeIn& nd, const PodIn& pd,
    float* raw, uint8_t* ok, long long sp, long long sn, int mw,
    int t_soft) {
  __shared__ PeerSmem sm;
  const int n0 = blockIdx.x * kQN;
  const int p0 = blockIdx.y * kQP;
  float acc[kQRP][kQRN];
  net_accum_peers(in, pr, p0, n0, sm, acc);
  const int tx = threadIdx.x % kTN, ty = threadIdx.x / kTN;
  const float wsoft = in.params[6];
#pragma unroll
  for (int i = 0; i < kQRP; ++i) {
    const int pp = ty + kTP * i;
    const int p = p0 + pp;
    if (p >= in.p) continue;
#pragma unroll
    for (int j = 0; j < kQRN; ++j) {
      const int nn = tx + kTN * j;
      const int n = n0 + nn;
      if (n >= in.n_out) continue;
      const int* taint = nd.taint + (size_t)n * mw;
      const int* label = nd.label + (size_t)n * mw;
      const int* tol = pd.tol + (size_t)p * mw;
      const int* sel = pd.sel + (size_t)p * mw;
      int bad = 0;  // any bit set: a taint not tolerated, a label missing
#pragma unroll 4
      for (int w = 0; w < mw; ++w)
        bad |= (taint[w] & ~tol[w]) | ((label[w] & sel[w]) ^ sel[w]);
      const bool good = nd.valid[n] > 0.5f && pd.valid[p] > 0.5f && bad == 0;
      const float soft = soft_bonus(label, nd.groups + (size_t)n * mw, pd, p,
                                    mw, t_soft);
      sm.out.v[pp][nn] = __fadd_rn(__fadd_rn(acc[i][j], nd.base[n]),
                                   __fmul_rn(wsoft, soft));
      sm.out.ok[pp][nn] = good ? 1 : 0;
    }
  }
  __syncthreads();
  store_tile(sm.out, raw, ok, sp, sn, p0, n0, in.p, in.n_out);
}

__global__ void __launch_bounds__(kQThreads, 3)
static_scores_kernel(NetIn in, PeersIn pr, NodeIn nd, PodIn pd, float* raw,
                     uint8_t* ok, long long sp, long long sn, int mw,
                     int t_soft) {
  static_scores_tile(in, pr, nd, pd, raw, ok, sp, sn, mw, t_soft);
}

// The static kernel over a lane axis (the fleet's tenants): lane
// blockIdx.z reads and writes its own slice of every stacked input and
// output ([K, ...], each lane contiguous), and runs the solo tile body
// on it unchanged, so each lane has the bits of a solo launch on that
// lane's inputs.
__global__ void __launch_bounds__(kQThreads, 3)
static_scores_lanes_kernel(NetIn in, PeersIn pr, NodeIn nd, PodIn pd,
                           float* raw, uint8_t* ok, long long sp,
                           long long sn, int mw, int t_soft) {
  const size_t z = blockIdx.z;
  const size_t p = in.p, n = in.n_out, k = in.n_k;
  NetIn li = in;
  li.t += z * p * k;
  li.bw += z * n * k;
  li.lat += z * n * k;
  li.validk += z * k;
  li.params += z * 8;
  PeersIn lp = pr;
  lp.cols += z * k;
  lp.count += z;
  lp.tk += z * k * pr.p_pad;
  NodeIn ln = nd;
  ln.base += z * n;
  ln.valid += z * n;
  ln.taint += z * n * mw;
  ln.label += z * n * mw;
  ln.groups += z * n * mw;
  PodIn lq = pd;
  lq.valid += z * p;
  lq.tol += z * p * mw;
  lq.sel += z * p * mw;
  lq.soft_sel += z * p * t_soft * mw;
  lq.soft_grp += z * p * t_soft * mw;
  lq.soft_sel_w += z * p * t_soft;
  lq.soft_grp_w += z * p * t_soft;
  static_scores_tile(li, lp, ln, lq, raw + z * p * n, ok + z * p * n, sp,
                     sn, mw, t_soft);
}

// The masked epilogue of one (pod p, node n) pair, shared by the masked
// and the winner kernel so both see the same bits: capacity fit, the
// five bit-mask tests, soft bonus, balance penalty, kNegInf where
// infeasible.  `acc` is the pair's net accumulation.
__device__ __forceinline__ float masked_score(float acc, const NodeIn& nd,
                                              const PodIn& pd,
                                              const float* params, int p,
                                              int n, int n_res, int mw,
                                              int t_soft) {
  const float wbal = params[4];
  const float eps = params[5];
  const float wsoft = params[6];
  bool fit = true;
  float bal = 0.f;
  for (int r = 0; r < n_res; ++r) {
    const float u = nd.used[(size_t)n * n_res + r];
    const float c = nd.cap[(size_t)n * n_res + r];
    const float q = pd.req[(size_t)p * n_res + r];
    fit = fit & (q <= __fadd_rn(__fsub_rn(c, u), eps));
    bal = fmaxf(bal, __fdiv_rn(__fadd_rn(u, q), fmaxf(c, eps)));
  }
  const int* taint = nd.taint + (size_t)n * mw;
  const int* label = nd.label + (size_t)n * mw;
  const int* group = nd.groups + (size_t)n * mw;
  const int* ranti = nd.resident_anti + (size_t)n * mw;
  const int* tol = pd.tol + (size_t)p * mw;
  const int* sel = pd.sel + (size_t)p * mw;
  const int* aff = pd.affinity + (size_t)p * mw;
  const int* anti = pd.anti + (size_t)p * mw;
  const int* gbit = pd.group_bit + (size_t)p * mw;
  // Any bit set fails a test: taint not tolerated, selector label
  // missing, anti-affinity group present, resident anti-affinity hit,
  // affinity group missing.  Bitwise, so the words' loads issue together.
  int bad = 0;
#pragma unroll 4
  for (int w = 0; w < mw; ++w) {
    const int g = group[w];
    bad |= (taint[w] & ~tol[w]) | ((label[w] & sel[w]) ^ sel[w]) |
           (g & anti[w]) | (ranti[w] & gbit[w]) | ((g & aff[w]) ^ aff[w]);
  }
  const bool good =
      nd.valid[n] > 0.5f && pd.valid[p] > 0.5f && fit && bad == 0;
  const float soft = soft_bonus(label, group, pd, p, mw, t_soft);
  const float score =
      __fsub_rn(__fadd_rn(__fadd_rn(acc, nd.base[n]), __fmul_rn(wsoft, soft)),
                __fmul_rn(wbal, bal));
  return good ? score : kNegInf;
}

__global__ void __launch_bounds__(kQThreads, 3)
masked_scores_kernel(NetIn in, PeersIn pr, NodeIn nd, PodIn pd, float* out,
                     int n_res, int mw, int t_soft) {
  __shared__ PeerSmem sm;
  const int n0 = blockIdx.x * kQN;
  const int p0 = blockIdx.y * kQP;
  float acc[kQRP][kQRN];
  net_accum_peers(in, pr, p0, n0, sm, acc);
  const int tx = threadIdx.x % kTN, ty = threadIdx.x / kTN;
#pragma unroll
  for (int i = 0; i < kQRP; ++i) {
    const int pp = ty + kTP * i;
    const int p = p0 + pp;
    if (p >= in.p) continue;
#pragma unroll
    for (int j = 0; j < kQRN; ++j) {
      const int nn = tx + kTN * j;
      const int n = n0 + nn;
      if (n >= in.n_out) continue;
      sm.out.v[pp][nn] = masked_score(acc[i][j], nd, pd, in.params, p, n,
                                      n_res, mw, t_soft);
    }
  }
  __syncthreads();
  store_tile(sm.out, out, nullptr, in.n_out, 1, p0, n0, in.p, in.n_out);
}

// Winner key of one (score, global node) pair: the score's bits mapped
// to an unsigned order (flip all bits of negatives, set the sign bit of
// the rest) in the high half, the inverted node index in the low half.
// The larger key is the higher score, and among equal scores the LOWER
// node index — winner_from_scores's tie-break.  -0.0 becomes +0.0
// first, because the plain version's == treats the two as equal.
__device__ __forceinline__ unsigned long long winner_key(float s, int n) {
  s = (s == 0.f) ? 0.f : s;
  const unsigned u = __float_as_uint(s);
  const unsigned hi = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  return (static_cast<unsigned long long>(hi) << 32) |
         static_cast<unsigned>(~n);
}

// The masked kernel's scores reduced to one key per pod across node
// tiles, so the P x N plane never reaches device memory.  Blocks run in
// no order, so the reduction is an atomicMax on the packed key (max is
// order-free, hence the result is the same on every run).  Within a
// 128 x 16 tile the kTN = 8 threads of a pod row are 8 consecutive
// lanes (tid = ty * kTN + tx); each takes the best of its kQRN nodes, an
// 8-lane xor shuffle finds the tile's best, and lane tx == 0 issues one
// atomic per pod row.  keys must start at 0 (below every real key).
__global__ void __launch_bounds__(kQThreads, 3)
winner_scores_kernel(NetIn in, PeersIn pr, NodeIn nd, PodIn pd,
                     unsigned long long* keys, int n_res, int mw,
                     int t_soft) {
  __shared__ PeerSmem sm;
  const int n0 = blockIdx.x * kQN;
  const int p0 = blockIdx.y * kQP;
  float acc[kQRP][kQRN];
  net_accum_peers(in, pr, p0, n0, sm, acc);
  const int tx = threadIdx.x % kTN, ty = threadIdx.x / kTN;
#pragma unroll
  for (int i = 0; i < kQRP; ++i) {
    const int p = p0 + ty + kTP * i;
    unsigned long long best = 0ull;
    if (p < in.p) {
#pragma unroll
      for (int j = 0; j < kQRN; ++j) {
        const int n = n0 + tx + kTN * j;
        if (n >= in.n_out) continue;
        const float s = masked_score(acc[i][j], nd, pd, in.params, p, n,
                                     n_res, mw, t_soft);
        const unsigned long long key = winner_key(s, n);
        best = key > best ? key : best;
      }
    }
    // Every lane of the warp shuffles (uniform control flow); offsets
    // below kTN keep each exchange inside its pod row's lanes.
#pragma unroll
    for (int off = kTN / 2; off > 0; off >>= 1) {
      const unsigned long long other = __shfl_xor_sync(0xffffffffu, best, off);
      best = other > best ? other : best;
    }
    if (tx == 0 && p < in.p) atomicMax(keys + p, best);
  }
}

// Unpack each pod's key into (best score, node); -1 where the best is
// infeasible (not above kNegInf / 2), as winner_from_scores does.
__global__ void winner_finalize_kernel(const unsigned long long* keys,
                                       float* best, int* node, int p) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= p) return;
  const unsigned long long k = keys[i];
  const unsigned hi = static_cast<unsigned>(k >> 32);
  const unsigned lo = static_cast<unsigned>(k);
  const unsigned u = (hi & 0x80000000u) ? (hi & 0x7fffffffu) : ~hi;
  const float b = __uint_as_float(u);
  best[i] = b;
  node[i] = b > kNegInf * 0.5f ? static_cast<int>(~lo) : -1;
}

dim3 peer_grid_for(int p, int n_out) {
  return dim3((n_out + kQN - 1) / kQN, (p + kQP - 1) / kQP);
}

// tk[j, :] = T[:, cols[j]] for j < count, bf16-rounded when use_bf16 is
// set, zero for p <= q < p_pad (lane blockIdx.y of stacked inputs): the traffic of the batch's peer columns,
// peer-major, so the score kernels copy whole rows instead of gathering
// the same scattered entries once per node tile.  A block takes 32
// columns and transposes them through shared memory in 32-pod pieces;
// blocks past count return at once.
constexpr int kTrafficThreads = 256;
constexpr int kTrafficRows = kTrafficThreads / kQK;

__global__ void __launch_bounds__(kTrafficThreads)
peer_traffic_kernel(const float* t, const int* cols, const int* count,
                    float* tk, int p, int p_pad, int n_k, int use_bf16) {
  __shared__ float tile[kQK][kQK + 1];
  const size_t z = blockIdx.y;  // lane: each lane's slice of t/cols/tk
  t += z * p * n_k;
  cols += z * n_k;
  count += z;
  tk += z * n_k * p_pad;
  const int j0 = blockIdx.x * kQK;
  const int cnt = *count;
  if (j0 >= cnt) return;
  const int lane = threadIdx.x % kQK;
  const int r = threadIdx.x / kQK;
  const int col = j0 + lane < cnt ? cols[j0 + lane] : -1;
  for (int q0 = 0; q0 < p_pad; q0 += kQK) {
#pragma unroll
    for (int i = 0; i < kQK / kTrafficRows; ++i) {
      const int q = q0 + r + kTrafficRows * i;
      float v = 0.f;
      if (col >= 0 && q < p) v = t[(size_t)q * n_k + col];
      if (use_bf16) v = bf16_round(v);
      tile[lane][r + kTrafficRows * i] = v;
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < kQK / kTrafficRows; ++i) {
      const int jr = r + kTrafficRows * i;
      const int q = q0 + lane;
      if (j0 + jr < cnt && q < p_pad)
        tk[(size_t)(j0 + jr) * p_pad + q] = tile[jr][lane];
    }
    __syncthreads();
  }
}

// flags[k] = any_p T[p, k] != 0 (lane blockIdx.y).  A block of 1,024 threads takes 32
// columns; its 32 warps read 32 rows at a time, each warp one 128-byte
// run along k.
constexpr int kFlagThreads = 1024;
constexpr int kFlagCols = 32;
constexpr int kFlagRows = kFlagThreads / kFlagCols;

__global__ void __launch_bounds__(kFlagThreads)
peer_flags_kernel(const float* t, int* flags, int p, int n_k) {
  __shared__ int hit[kFlagRows][kFlagCols + 1];
  t += (size_t)blockIdx.y * p * n_k;  // lane
  flags += (size_t)blockIdx.y * n_k;
  const int c = threadIdx.x % kFlagCols;
  const int g = threadIdx.x / kFlagCols;
  const int k = blockIdx.x * kFlagCols + c;
  int any = 0;
  if (k < n_k) {
#pragma unroll 4
    for (int r = g; r < p; r += kFlagRows)
      any |= t[(size_t)r * n_k + k] != 0.f;
  }
  hit[g][c] = any;
  __syncthreads();
  if (g == 0 && k < n_k) {
    for (int i = 1; i < kFlagRows; ++i) any |= hit[i][c];
    flags[k] = any;
  }
}

// One block per lane: an ascending exclusive scan of the flags.  Each thread
// takes kScanPer consecutive columns (8,192 per pass: one pass up to
// n_k = 8,192), a shuffle scan within each warp and one over the 32 warp
// totals place them.  Writes cols[0:count] = the flagged columns,
// cols[count:] = -1, and count.
constexpr int kScanThreads = 1024;
constexpr int kScanPer = 8;

__global__ void __launch_bounds__(kScanThreads)
peer_scan_kernel(const int* flags, int* cols, int* count, int n_k) {
  __shared__ int warp_off[kScanThreads / 32];
  __shared__ int total;
  flags += (size_t)blockIdx.x * n_k;  // one block per lane
  cols += (size_t)blockIdx.x * n_k;
  count += blockIdx.x;
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  int base = 0;
  for (int c0 = 0; c0 < n_k; c0 += kScanThreads * kScanPer) {
    const int k0 = c0 + threadIdx.x * kScanPer;
    unsigned bits = 0;
#pragma unroll
    for (int i = 0; i < kScanPer; ++i)
      if (k0 + i < n_k && flags[k0 + i] != 0) bits |= 1u << i;
    const int mine = __popc(bits);
    int incl = mine;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int u = __shfl_up_sync(0xffffffffu, incl, o);
      if (lane >= o) incl += u;
    }
    if (lane == 31) warp_off[warp] = incl;
    __syncthreads();
    if (warp == 0) {
      const int v = warp_off[lane];
      int w = v;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int u = __shfl_up_sync(0xffffffffu, w, o);
        if (lane >= o) w += u;
      }
      warp_off[lane] = w - v;
      if (lane == 31) total = w;
    }
    __syncthreads();
    int pos = base + warp_off[warp] + incl - mine;
#pragma unroll
    for (int i = 0; i < kScanPer; ++i)
      if ((bits >> i) & 1u) cols[pos++] = k0 + i;
    base += total;
    __syncthreads();
  }
  for (int j = base + threadIdx.x; j < n_k; j += kScanThreads) cols[j] = -1;
  if (threadIdx.x == 0) *count = base;
}

int pad4(int p) { return (p + 3) / 4 * 4; }

// Fill the caller's scratch tk [n_k, pad4(p)] from T and the peer
// columns (rows past count are left as they are; nothing reads them).
int launch_peer_traffic(const NetIn& in, const PeersIn& pr, float* tk,
                        void* stream, int lanes = 1) {
  if (in.n_k <= 0) return 0;
  peer_traffic_kernel<<<dim3((in.n_k + kQK - 1) / kQK, lanes),
                        kTrafficThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      in.t, pr.cols, pr.count, tk, in.p, pr.p_pad, in.n_k, in.use_bf16);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The batch's peer columns of T [p, n_k]: cols [n_k] (ascending, -1 past
// count) and count [1], through the caller's int scratch flags [n_k].
// Two launches on the caller's stream; nothing reaches the host.
// The same per lane of a stacked T [lanes, p, n_k]: cols [lanes, n_k],
// count [lanes], flags [lanes, n_k].
extern "C" int tiled_peer_columns_lanes(const float* t, int* flags,
                                        int* cols, int* count, int p,
                                        int n_k, int lanes, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_k <= 0)
    return static_cast<int>(
        cudaMemsetAsync(count, 0, sizeof(int) * lanes, s));
  peer_flags_kernel<<<dim3((n_k + kFlagCols - 1) / kFlagCols, lanes),
                      kFlagThreads, 0, s>>>(t, flags, p, n_k);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  peer_scan_kernel<<<lanes, kScanThreads, 0, s>>>(flags, cols, count, n_k);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int tiled_peer_columns(const float* t, int* flags, int* cols,
                                  int* count, int p, int n_k, void* stream) {
  return tiled_peer_columns_lanes(t, flags, cols, count, p, n_k, 1, stream);
}

extern "C" int tiled_static_scores(
    const float* t, const float* bw, const float* lat, const float* validk,
    const float* params, const float* base, const float* node_valid,
    const int* taint, const int* label, const int* groups,
    const float* pod_valid, const int* tol, const int* sel,
    const int* soft_sel, const int* soft_grp, const float* soft_sel_w,
    const float* soft_grp_w, const int* cols, const int* count, float* tk,
    float* raw, uint8_t* ok, long long out_sp, long long out_sn, int p,
    int n_out, int n_k, int mw, int t_soft, int use_bf16, void* stream) {
  if (p <= 0 || n_out <= 0) return static_cast<int>(cudaGetLastError());
  NetIn in{t, bw, lat, validk, params, p, n_out, n_k, use_bf16};
  PeersIn pr{cols, count, tk, pad4(p)};
  const int err = launch_peer_traffic(in, pr, tk, stream);
  if (err != 0) return err;
  NodeIn nd{base, node_valid, taint, label, groups, nullptr, nullptr,
            nullptr};
  PodIn pd{pod_valid, nullptr, tol, sel, nullptr, nullptr, nullptr,
           soft_sel, soft_grp, soft_sel_w, soft_grp_w};
  static_scores_kernel<<<peer_grid_for(p, n_out), kQThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      in, pr, nd, pd, raw, ok, out_sp, out_sn, mw, t_soft);
  return static_cast<int>(cudaGetLastError());
}

// tiled_static_scores over `lanes` stacked lanes: every pointer is the
// start of a [lanes, ...] stack whose lanes are contiguous (cols, count
// and tk per lane too); raw/ok are [lanes, p, n_out] or, with
// out_sp = 1, [lanes, n_out, p].  Two launches: the lanes' traffic
// copies and the lanes' tiles, blockIdx.z the lane.
extern "C" int tiled_static_scores_lanes(
    const float* t, const float* bw, const float* lat, const float* validk,
    const float* params, const float* base, const float* node_valid,
    const int* taint, const int* label, const int* groups,
    const float* pod_valid, const int* tol, const int* sel,
    const int* soft_sel, const int* soft_grp, const float* soft_sel_w,
    const float* soft_grp_w, const int* cols, const int* count, float* tk,
    float* raw, uint8_t* ok, long long out_sp, long long out_sn, int p,
    int n_out, int n_k, int mw, int t_soft, int use_bf16, int lanes,
    void* stream) {
  if (p <= 0 || n_out <= 0 || lanes <= 0)
    return static_cast<int>(cudaGetLastError());
  NetIn in{t, bw, lat, validk, params, p, n_out, n_k, use_bf16};
  PeersIn pr{cols, count, tk, pad4(p)};
  const int err = launch_peer_traffic(in, pr, tk, stream, lanes);
  if (err != 0) return err;
  NodeIn nd{base, node_valid, taint, label, groups, nullptr, nullptr,
            nullptr};
  PodIn pd{pod_valid, nullptr, tol, sel, nullptr, nullptr, nullptr,
           soft_sel, soft_grp, soft_sel_w, soft_grp_w};
  dim3 grid = peer_grid_for(p, n_out);
  grid.z = lanes;
  static_scores_lanes_kernel<<<grid, kQThreads, 0,
                               static_cast<cudaStream_t>(stream)>>>(
      in, pr, nd, pd, raw, ok, out_sp, out_sn, mw, t_soft);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int tiled_masked_scores(
    const float* t, const float* bw, const float* lat, const float* validk,
    const float* params, const float* base, const float* node_valid,
    const int* taint, const int* label, const int* groups,
    const int* resident_anti, const float* used, const float* cap,
    const float* pod_valid, const float* req, const int* tol, const int* sel,
    const int* affinity, const int* anti, const int* group_bit,
    const int* soft_sel, const int* soft_grp, const float* soft_sel_w,
    const float* soft_grp_w, const int* cols, const int* count, float* tk,
    float* out, int p, int n_out, int n_k, int n_res, int mw, int t_soft,
    int use_bf16, void* stream) {
  if (p <= 0 || n_out <= 0) return static_cast<int>(cudaGetLastError());
  NetIn in{t, bw, lat, validk, params, p, n_out, n_k, use_bf16};
  PeersIn pr{cols, count, tk, pad4(p)};
  const int err = launch_peer_traffic(in, pr, tk, stream);
  if (err != 0) return err;
  NodeIn nd{base, node_valid, taint, label, groups, resident_anti, used,
            cap};
  PodIn pd{pod_valid, req, tol, sel, affinity, anti, group_bit,
           soft_sel, soft_grp, soft_sel_w, soft_grp_w};
  masked_scores_kernel<<<peer_grid_for(p, n_out), kQThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      in, pr, nd, pd, out, n_res, mw, t_soft);
  return static_cast<int>(cudaGetLastError());
}

// Same inputs as tiled_masked_scores; writes best f32[p] and node i32[p]
// through the caller's u64 scratch `keys` [p].  Four launches on the
// caller's stream: zero the keys, the traffic copy, the winner kernel,
// the unpack.
extern "C" int tiled_winner_scores(
    const float* t, const float* bw, const float* lat, const float* validk,
    const float* params, const float* base, const float* node_valid,
    const int* taint, const int* label, const int* groups,
    const int* resident_anti, const float* used, const float* cap,
    const float* pod_valid, const float* req, const int* tol, const int* sel,
    const int* affinity, const int* anti, const int* group_bit,
    const int* soft_sel, const int* soft_grp, const float* soft_sel_w,
    const float* soft_grp_w, const int* cols, const int* count, float* tk,
    unsigned long long* keys, float* best, int* node, int p, int n_out,
    int n_k, int n_res, int mw, int t_soft, int use_bf16, void* stream) {
  if (p <= 0 || n_out <= 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(keys, 0, sizeof(*keys) * p, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  NetIn in{t, bw, lat, validk, params, p, n_out, n_k, use_bf16};
  PeersIn pr{cols, count, tk, pad4(p)};
  const int terr = launch_peer_traffic(in, pr, tk, stream);
  if (terr != 0) return terr;
  NodeIn nd{base, node_valid, taint, label, groups, resident_anti, used,
            cap};
  PodIn pd{pod_valid, req, tol, sel, affinity, anti, group_bit,
           soft_sel, soft_grp, soft_sel_w, soft_grp_w};
  winner_scores_kernel<<<peer_grid_for(p, n_out), kQThreads, 0, s>>>(
      in, pr, nd, pd, keys, n_res, mw, t_soft);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  winner_finalize_kernel<<<(p + 255) / 256, 256, 0, s>>>(keys, best, node, p);
  return static_cast<int>(cudaGetLastError());
}
