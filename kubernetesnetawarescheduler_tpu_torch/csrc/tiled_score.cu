// Tiled pod x node score kernels for NVIDIA Hopper (sm_90a).
//
// Three kernels share one net-accumulation routine, so the fused and
// unfused scores are the same arithmetic:
//
//   static_scores_kernel  raw = T·Cᵀ + base + wsoft·soft and the static
//                         mask (validity, taints, node selectors); the
//                         batch-invariant half of the assign path.
//   masked_scores_kernel  the same accumulation, then the full masked
//                         epilogue: capacity fit, five bit-mask tests,
//                         soft bonus, balance penalty, NEG_INF where
//                         infeasible; the Score/Filter answer.
//   winner_scores_kernel  the masked kernel's scores (one shared
//                         epilogue, masked_score) reduced per pod to
//                         (best, lowest node index) across node tiles;
//                         writes 8 bytes per pod, never the P x N plane.
//
// C[n, k] = wbw·bw[n, k]·inv_bw − wlat·lat[n, k]·inv_lat is formed per
// tile in shared memory from the raw bw/lat matrices (C never exists in
// device memory), with the diagonal pinned to wbw by GLOBAL row index
// (params[7] is the row offset of output row 0) and invalid peer
// columns zeroed.  With use_bf16 set, T and C are rounded to bf16 and
// the product still accumulates in f32 registers.
//
// Design (simple and right first): a 2-D grid of 64-pod x 64-node output
// tiles, 256 threads per block, each thread owning a 4 x 4 register
// tile (pods ty + 16i, nodes tx + 16j).  The block walks the peer axis
// in steps of 32, staging its slice of T and C in shared memory.  Every
// ragged edge is masked in the kernel, so the host pads nothing.  The
// epilogue writes each output once.  Elementwise arithmetic outside the
// accumulation uses the _rn intrinsics so the compiler cannot contract
// it into FMAs: the tile epilogue then rounds exactly as the plain
// PyTorch versions do, and only the order of the f32 accumulation
// differs between the two.
//
// Params layout (f32[8]): wbw, wlat, inv_bw, inv_lat, wbal, eps, wsoft,
// row_offset.  Bit masks are int32 words (the u32 bits of the JAX
// package).  Each entry point launches on the caller's stream, allocates
// nothing (the winner's u64 key scratch comes from the caller), and
// returns the first CUDA error it meets.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBP = 64;   // pods per block tile
constexpr int kBN = 64;   // output nodes per block tile
constexpr int kBK = 32;   // peer-axis step
constexpr int kThreads = 256;
constexpr int kRP = kBP / 16;  // pods per thread
constexpr int kRN = kBN / 16;  // nodes per thread
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

// acc[i][j] = Σ_k T[p0 + ty + 16i, k] · C[n0 + tx + 16j, k].
__device__ __forceinline__ void net_accum(const NetIn& in, int p0, int n0,
                                          float (&acc)[kRP][kRN]) {
  __shared__ float ts[kBK][kBP + 1];
  __shared__ float cs[kBK][kBN + 1];
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const float wbw = in.params[0];
  const float wlat = in.params[1];
  const float inv_bw = in.params[2];
  const float inv_lat = in.params[3];
  const int row_off = static_cast<int>(in.params[7]);

#pragma unroll
  for (int i = 0; i < kRP; ++i)
#pragma unroll
    for (int j = 0; j < kRN; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < in.n_k; k0 += kBK) {
    // Neighbouring threads take neighbouring k: coalesced row reads,
    // and the +1 padding keeps the transposed shared stores free of
    // bank conflicts.
    for (int e = tid; e < kBP * kBK; e += kThreads) {
      const int pp = e / kBK, kk = e % kBK;
      const int p = p0 + pp, k = k0 + kk;
      float v = 0.f;
      if (p < in.p && k < in.n_k) v = in.t[(size_t)p * in.n_k + k];
      if (in.use_bf16) v = bf16_round(v);
      ts[kk][pp] = v;
    }
    for (int e = tid; e < kBN * kBK; e += kThreads) {
      const int nn = e / kBK, kk = e % kBK;
      const int n = n0 + nn, k = k0 + kk;
      float c = 0.f;
      if (n < in.n_out && k < in.n_k) {
        const size_t off = (size_t)n * in.n_k + k;
        c = __fsub_rn(__fmul_rn(__fmul_rn(wbw, in.bw[off]), inv_bw),
                      __fmul_rn(__fmul_rn(wlat, in.lat[off]), inv_lat));
        if (row_off + n == k) c = wbw;
        c = __fmul_rn(c, in.validk[k]);
        if (in.use_bf16) c = bf16_round(c);
      }
      cs[kk][nn] = c;
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < kBK; ++kk) {
      float a[kRP], b[kRN];
#pragma unroll
      for (int i = 0; i < kRP; ++i) a[i] = ts[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < kRN; ++j) b[j] = cs[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < kRP; ++i)
#pragma unroll
        for (int j = 0; j < kRN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
}

// Unscaled soft-affinity bonus of pod p on a node: Σ_t (label terms
// whose bits are all present) + (group terms with any overlap), added
// term by term in the plain version's order.
__device__ float soft_bonus(const int* label_n, const int* group_n,
                            const PodIn& pd, int p, int mw, int t_soft) {
  float soft = 0.f;
  for (int t = 0; t < t_soft; ++t) {
    bool sel_match = true, grp_hit = false;
    const size_t row = ((size_t)p * t_soft + t) * mw;
    for (int w = 0; w < mw; ++w) {
      const int sb = pd.soft_sel[row + w];
      const int gb = pd.soft_grp[row + w];
      sel_match = sel_match && ((label_n[w] & sb) == sb);
      grp_hit = grp_hit || ((group_n[w] & gb) != 0);
    }
    const float a = sel_match ? pd.soft_sel_w[(size_t)p * t_soft + t] : 0.f;
    const float b = grp_hit ? pd.soft_grp_w[(size_t)p * t_soft + t] : 0.f;
    soft = __fadd_rn(soft, __fadd_rn(a, b));
  }
  return soft;
}

__global__ void __launch_bounds__(kThreads)
static_scores_kernel(NetIn in, NodeIn nd, PodIn pd, float* raw,
                     uint8_t* ok, long long sp, long long sn, int mw,
                     int t_soft) {
  const int n0 = blockIdx.x * kBN;
  const int p0 = blockIdx.y * kBP;
  float acc[kRP][kRN];
  net_accum(in, p0, n0, acc);
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const float wsoft = in.params[6];
#pragma unroll
  for (int i = 0; i < kRP; ++i) {
    const int p = p0 + ty + 16 * i;
    if (p >= in.p) continue;
#pragma unroll
    for (int j = 0; j < kRN; ++j) {
      const int n = n0 + tx + 16 * j;
      if (n >= in.n_out) continue;
      bool good = nd.valid[n] > 0.5f && pd.valid[p] > 0.5f;
      const int* taint = nd.taint + (size_t)n * mw;
      const int* label = nd.label + (size_t)n * mw;
      const int* tol = pd.tol + (size_t)p * mw;
      const int* sel = pd.sel + (size_t)p * mw;
      for (int w = 0; w < mw; ++w) {
        good = good && ((taint[w] & ~tol[w]) == 0);
        good = good && ((label[w] & sel[w]) == sel[w]);
      }
      const float soft = soft_bonus(label, nd.groups + (size_t)n * mw, pd, p,
                                    mw, t_soft);
      const size_t o = (size_t)p * sp + (size_t)n * sn;
      raw[o] = __fadd_rn(__fadd_rn(acc[i][j], nd.base[n]),
                         __fmul_rn(wsoft, soft));
      ok[o] = good ? 1 : 0;
    }
  }
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
  bool good = nd.valid[n] > 0.5f && pd.valid[p] > 0.5f;
  float bal = 0.f;
  for (int r = 0; r < n_res; ++r) {
    const float u = nd.used[(size_t)n * n_res + r];
    const float c = nd.cap[(size_t)n * n_res + r];
    const float q = pd.req[(size_t)p * n_res + r];
    good = good && (q <= __fadd_rn(__fsub_rn(c, u), eps));
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
  for (int w = 0; w < mw; ++w) {
    good = good && ((taint[w] & ~tol[w]) == 0);
    good = good && ((label[w] & sel[w]) == sel[w]);
    good = good && ((group[w] & anti[w]) == 0);
    good = good && ((ranti[w] & gbit[w]) == 0);
    good = good && ((group[w] & aff[w]) == aff[w]);
  }
  const float soft = soft_bonus(label, group, pd, p, mw, t_soft);
  const float score =
      __fsub_rn(__fadd_rn(__fadd_rn(acc, nd.base[n]), __fmul_rn(wsoft, soft)),
                __fmul_rn(wbal, bal));
  return good ? score : kNegInf;
}

__global__ void __launch_bounds__(kThreads)
masked_scores_kernel(NetIn in, NodeIn nd, PodIn pd, float* out, int n_res,
                     int mw, int t_soft) {
  const int n0 = blockIdx.x * kBN;
  const int p0 = blockIdx.y * kBP;
  float acc[kRP][kRN];
  net_accum(in, p0, n0, acc);
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll
  for (int i = 0; i < kRP; ++i) {
    const int p = p0 + ty + 16 * i;
    if (p >= in.p) continue;
#pragma unroll
    for (int j = 0; j < kRN; ++j) {
      const int n = n0 + tx + 16 * j;
      if (n >= in.n_out) continue;
      out[(size_t)p * in.n_out + n] = masked_score(
          acc[i][j], nd, pd, in.params, p, n, n_res, mw, t_soft);
    }
  }
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
// 64 x 64 tile the 16 threads of a pod row form a half-warp (tid =
// ty * 16 + tx); each takes the best of its 4 nodes, a 16-lane xor
// shuffle finds the tile's best, and lane tx == 0 issues one atomic per
// pod row.  keys must start at 0 (below every real key).
__global__ void __launch_bounds__(kThreads)
winner_scores_kernel(NetIn in, NodeIn nd, PodIn pd, unsigned long long* keys,
                     int n_res, int mw, int t_soft) {
  const int n0 = blockIdx.x * kBN;
  const int p0 = blockIdx.y * kBP;
  float acc[kRP][kRN];
  net_accum(in, p0, n0, acc);
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll
  for (int i = 0; i < kRP; ++i) {
    const int p = p0 + ty + 16 * i;
    unsigned long long best = 0ull;
    if (p < in.p) {
#pragma unroll
      for (int j = 0; j < kRN; ++j) {
        const int n = n0 + tx + 16 * j;
        if (n >= in.n_out) continue;
        const float s = masked_score(acc[i][j], nd, pd, in.params, p, n,
                                     n_res, mw, t_soft);
        const unsigned long long key = winner_key(s, n);
        best = key > best ? key : best;
      }
    }
    // Every lane of the warp shuffles (uniform control flow); offsets
    // below 16 keep each exchange inside its half-warp.
#pragma unroll
    for (int off = 8; off > 0; off >>= 1) {
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

dim3 grid_for(int p, int n_out) {
  return dim3((n_out + kBN - 1) / kBN, (p + kBP - 1) / kBP);
}

}  // namespace

extern "C" int tiled_static_scores(
    const float* t, const float* bw, const float* lat, const float* validk,
    const float* params, const float* base, const float* node_valid,
    const int* taint, const int* label, const int* groups,
    const float* pod_valid, const int* tol, const int* sel,
    const int* soft_sel, const int* soft_grp, const float* soft_sel_w,
    const float* soft_grp_w, float* raw, uint8_t* ok, long long out_sp,
    long long out_sn, int p, int n_out, int n_k, int mw, int t_soft,
    int use_bf16, void* stream) {
  if (p <= 0 || n_out <= 0) return static_cast<int>(cudaGetLastError());
  NetIn in{t, bw, lat, validk, params, p, n_out, n_k, use_bf16};
  NodeIn nd{base, node_valid, taint, label, groups, nullptr, nullptr,
            nullptr};
  PodIn pd{pod_valid, nullptr, tol, sel, nullptr, nullptr, nullptr,
           soft_sel, soft_grp, soft_sel_w, soft_grp_w};
  static_scores_kernel<<<grid_for(p, n_out), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      in, nd, pd, raw, ok, out_sp, out_sn, mw, t_soft);
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
    const float* soft_grp_w, float* out, int p, int n_out, int n_k,
    int n_res, int mw, int t_soft, int use_bf16, void* stream) {
  if (p <= 0 || n_out <= 0) return static_cast<int>(cudaGetLastError());
  NetIn in{t, bw, lat, validk, params, p, n_out, n_k, use_bf16};
  NodeIn nd{base, node_valid, taint, label, groups, resident_anti, used,
            cap};
  PodIn pd{pod_valid, req, tol, sel, affinity, anti, group_bit,
           soft_sel, soft_grp, soft_sel_w, soft_grp_w};
  masked_scores_kernel<<<grid_for(p, n_out), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      in, nd, pd, out, n_res, mw, t_soft);
  return static_cast<int>(cudaGetLastError());
}

// Same inputs as tiled_masked_scores; writes best f32[p] and node i32[p]
// through the caller's u64 scratch `keys` [p].  Three launches on the
// caller's stream: zero the keys, the winner kernel, the unpack.
extern "C" int tiled_winner_scores(
    const float* t, const float* bw, const float* lat, const float* validk,
    const float* params, const float* base, const float* node_valid,
    const int* taint, const int* label, const int* groups,
    const int* resident_anti, const float* used, const float* cap,
    const float* pod_valid, const float* req, const int* tol, const int* sel,
    const int* affinity, const int* anti, const int* group_bit,
    const int* soft_sel, const int* soft_grp, const float* soft_sel_w,
    const float* soft_grp_w, unsigned long long* keys, float* best,
    int* node, int p, int n_out, int n_k, int n_res, int mw, int t_soft,
    int use_bf16, void* stream) {
  if (p <= 0 || n_out <= 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(keys, 0, sizeof(*keys) * p, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  NetIn in{t, bw, lat, validk, params, p, n_out, n_k, use_bf16};
  NodeIn nd{base, node_valid, taint, label, groups, resident_anti, used,
            cap};
  PodIn pd{pod_valid, req, tol, sel, affinity, anti, group_bit,
           soft_sel, soft_grp, soft_sel_w, soft_grp_w};
  winner_scores_kernel<<<grid_for(p, n_out), kThreads, 0, s>>>(
      in, nd, pd, keys, n_res, mw, t_soft);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  winner_finalize_kernel<<<(p + 255) / 256, 256, 0, s>>>(keys, best, node, p);
  return static_cast<int>(cudaGetLastError());
}
