// Fused temperature -> top-k -> top-p -> Gumbel-max sampler for Hopper
// (sm_90a), plain C interface.
//
// Replaces: kubeflow_tpu/ops/sampling.py:_fused_sample_kernel (Pallas
// body :77, pallas_call :177, wrapper fused_sample :141). It computes
// what the reference computes: x = logits / temperature (a true
// division); top-k keeps every value >= the k-th largest (all ties at the
// k-th value; top_k <= 0 keeps all); top-p, over the k-kept values, keeps
// every value >= the smallest kept value whose strictly-above mass is
// below p * z (top_p >= 1 is a strict no-op); then one Gumbel-max draw
// over the kept support with first-index tie-break. A greedy row
// (temperature <= 0) takes the first-index argmax of the raw logits. The
// Gumbel noise is an input, as in the reference. Thresholds live on the
// ordered key of f32 (_ordered_bits :63: int order == float order, +0 and
// -0 distinct), flipped to unsigned order here.
//
// What bounds it on H100: HBM bytes, one read of the logits row and of
// the noise row (2 x 4 x V bytes per sampled row) -- a few microseconds
// at most. What it is held to in practice is latency: the reference
// finds each threshold with a 32-step binary search, each step a sweep
// of the row and a reduction, and the first port ran those ~70 serial
// block-wide passes on one SM per row.
//
// Design, and what it does about that:
// - One thread-block cluster of kCluster = 8 CTAs (the portable size) per
//   row, launched with cudaLaunchKernelEx and the cluster-dimension
//   attribute: B = 8 rows fill 64 SMs, and a prefill sample (B = 1) 8.
//   Each CTA stages its 1/8 slice of the scaled row in its own shared
//   memory once (16 KB at V = 32,000, 64 KB at Llama-3's 128,256), reads
//   the noise once in the last pass, and runs every pass on chip.
// - Radix select in place of the binary searches: each threshold is
//   found by four passes over 8-bit digits of the key, from the top.
//   Top-k: a 256-bin count histogram of the values matching the prefix
//   found so far; walk the bins from the top to the one where the count
//   reaches k. Top-p: count and mass histograms of the kept values; walk
//   to the LOWEST non-empty bin d with A + sum_{d' > d} mass[d'] < p * z
//   (A: the mass already above the prefix). Bins are chosen by count, so
//   a kept value whose exp underflows to 0 is still a value. z is the
//   first top-p pass's total, and the max m comes from one cluster-wide
//   max; exp(x - m) is recomputed in each pass, not stored. So a row
//   takes 4 + 1 + 4 passes and one final draw, ~11 cluster barriers,
//   in place of ~70 block-wide ones.
// - Merges through distributed shared memory: each CTA's histogram is
//   read by every peer through cluster.map_shared_rank after a
//   cluster.sync(), summed in CTA-rank order; every CTA takes the same
//   decision, so none has to be told it. Histograms are double-buffered,
//   so one cluster.sync() a pass suffices.
// - Deterministic sums: the mass of a value is exp(x - m) in fixed point
//   (2^s, s = min(47, 62 - bits(V)), so a row's total fits 64 bits);
//   integer sums are exact in any order, so a row samples the same token
//   on every run.
// - Histograms inside a CTA: each warp adds to its own histogram with
//   32-bit shared atomics (a count, and the mass in three 16-bit limbs),
//   and the warps' histograms fold into the CTA's 64-bit one after the
//   sweep (and every kFoldEvery iterations, so no limb sum overflows).
//   Grouping a warp's lanes by bin first (__match_any_sync +
//   __reduce_add_sync, one atomic a group) cost more on the H100 than
//   the atomics it saved: 0.0509 ms against 0.0360 at B = 8, V = 32,000
//   and 0.1357 against 0.0638 at V = 128,256 (scripts/
//   port_sampler_sweep.py; PERF.md).
// - Greedy rows skip both searches, a row whose top_k keeps everything
//   skips the k passes, and a row with top_p >= 1 the p passes.
// - A row past 8 x the opt-in shared memory left beside the warps'
//   histograms (over ~315,000 values; Qwen2's 152,064 still fits) keeps
//   its slices in a (B, V) f32 workspace in device memory that the
//   wrapper allocates: one template parameter of the one kernel
//   (kGlobalRow), the same passes through L2.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kCluster = 8;  // CTAs per row (the portable cluster size)
constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kBins = 256;  // one 8-bit digit
constexpr float kNegInf = -1e30f;
constexpr unsigned kFull = 0xffffffffu;
// the warps' histograms, ahead of the row slice in dynamic shared memory:
// per warp, kBins counts and kBins of each of three 16-bit mass limbs
constexpr int kWarpHistBytes = 4 * kWarps * kBins * 4;
// sweep iterations between folds: a warp adds at most 32 * kFoldEvery
// limbs of < 2^16 to one bin before its sums move to 64 bits
constexpr int kFoldEvery = 1024;
typedef unsigned long long u64;

// f32 -> unsigned key whose order is the float order (no NaNs): the
// reference's ordered int (_ordered_bits) with its sign bit flipped.
__device__ __forceinline__ unsigned ukey(float x) {
  const int b = __float_as_int(x);
  return static_cast<unsigned>(b < 0 ? (b ^ 0x7FFFFFFF) : b) ^ 0x80000000u;
}

// Shared state of a CTA's descent, written by warp 0 between barriers.
struct Descent {
  unsigned prefix;  // the key bits found so far
  u64 above;        // top-k: values above the prefix; top-p: their mass
  double target;    // top-p: p * z
  int none;         // top-p: no kept value qualifies (p <= 0)
};

struct Smem {
  unsigned cnt[2][kBins];  // double-buffered histograms (peers read them)
  u64 mass[2][kBins];
  unsigned mcnt[kBins];    // the cluster-wide merge of one pass
  u64 mmass[kBins];
  float red_f[kWarps];
  int red_i[kWarps];
  Descent st;
  float pub_max;  // read by peers: this CTA's max
  float pub_best; // and its best score with the first index of it
  int pub_idx;
};

__device__ __forceinline__ float block_max(float v, Smem& sm) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(kFull, v, o));
  if ((threadIdx.x & 31) == 0) sm.red_f[threadIdx.x >> 5] = v;
  __syncthreads();
  float r = sm.red_f[0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) r = fmaxf(r, sm.red_f[w]);
  __syncthreads();  // red_f is reused by the next reduction
  return r;
}

__device__ __forceinline__ int block_min(int v, Smem& sm) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = min(v, __shfl_xor_sync(kFull, v, o));
  if ((threadIdx.x & 31) == 0) sm.red_i[threadIdx.x >> 5] = v;
  __syncthreads();
  int r = sm.red_i[0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) r = min(r, sm.red_i[w]);
  __syncthreads();
  return r;
}

// Add the warps' histograms into this CTA's (cnt, mass) and clear them.
// Threads 0..kBins-1, one bin each; the warps in order.
template <bool kMass>
__device__ __forceinline__ void fold_warps(unsigned* whist, unsigned* cnt,
                                           u64* mass) {
  const int t = threadIdx.x;
  if (t >= kBins) return;
  unsigned c = 0;
  u64 w = 0;
#pragma unroll 4
  for (int q = 0; q < kWarps; ++q) {
    unsigned* h = whist + q * kBins + t;
    c += h[0];
    h[0] = 0;
    if (kMass) {
      unsigned* l = h + kWarps * kBins;
      w += l[0] + (static_cast<u64>(l[kWarps * kBins]) << 16) +
           (static_cast<u64>(l[2 * kWarps * kBins]) << 32);
      l[0] = l[kWarps * kBins] = l[2 * kWarps * kBins] = 0;
    }
  }
  cnt[t] += c;
  if (kMass) mass[t] += w;
}

// Sum of x over the lanes above this one (lanes > lane).
template <typename T>
__device__ __forceinline__ T lanes_above(T x) {
  const int lane = threadIdx.x & 31;
  T incl = x;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const T y = __shfl_down_sync(kFull, incl, o);
    if (lane + o < 32) incl += y;
  }
  return incl - x;
}

// One radix pass at digit `level` (0 = the top 8 bits): histogram this
// CTA's slice, merge the cluster's histograms in rank order, and move the
// descent one digit down. kMass: top-p (count and mass of the kept values,
// key >= ukth); else top-k (counts of every value). Every thread of every
// CTA of the cluster calls it.
template <bool kMass>
__device__ void radix_pass(cg::cluster_group& cluster, Smem& sm,
                           unsigned* whist, const float* row, int n,
                           int level, int& pass,
                           unsigned ukth, float m, float fx_scale,
                           unsigned k_eff, float p) {
  const int tid = threadIdx.x, lane = tid & 31;
  const int buf = pass & 1;
  const int shift = 24 - 8 * level;
  const unsigned hmask = level == 0 ? 0u : (kFull << (32 - 8 * level));
  const unsigned prefix = sm.st.prefix;
  unsigned* cnt = sm.cnt[buf];
  u64* mass = sm.mass[buf];
  // this warp's histogram: counts, then the mass in three 16-bit limbs
  unsigned* wc = whist + (tid >> 5) * kBins;
  unsigned* wl = wc + kWarps * kBins;

  for (int i0 = 0, it = 1; i0 < n; i0 += kThreads, ++it) {
    const int i = i0 + tid;
    if (i < n) {
      const float x = row[i];
      const unsigned u = ukey(x);
      if (u >= ukth && ((u ^ prefix) & hmask) == 0) {
        const unsigned bin = (u >> shift) & (kBins - 1);
        atomicAdd(&wc[bin], 1u);
        if (kMass) {  // e < 2^47
          const u64 e = __float2ull_rz(expf(x - m) * fx_scale);
          atomicAdd(&wl[bin], static_cast<unsigned>(e & 0xFFFFu));
          atomicAdd(&wl[kWarps * kBins + bin],
                    static_cast<unsigned>((e >> 16) & 0xFFFFu));
          atomicAdd(&wl[2 * kWarps * kBins + bin],
                    static_cast<unsigned>(e >> 32));
        }
      }
    }
    if (it % kFoldEvery == 0) {  // keep each limb's sum below 2^32
      __syncthreads();
      fold_warps<kMass>(whist, cnt, mass);
      __syncthreads();
    }
  }
  __syncthreads();
  fold_warps<kMass>(whist, cnt, mass);
  cluster.sync();  // every histogram is whole; the other buffer is free
  for (int t = tid; t < kBins; t += kThreads) {
    sm.cnt[buf ^ 1][t] = 0;
    sm.mass[buf ^ 1][t] = 0;
  }
  if (tid < kBins) {
    unsigned c = 0;
    u64 w = 0;
    for (int r = 0; r < kCluster; ++r) {  // rank order
      c += cluster.map_shared_rank(cnt, r)[tid];
      if (kMass) w += cluster.map_shared_rank(mass, r)[tid];
    }
    sm.mcnt[tid] = c;
    sm.mmass[tid] = w;
  }
  __syncthreads();
  if (tid < 32) {  // warp 0 decides; lane owns bins 8 lane .. 8 lane + 7
    unsigned c[8];
    unsigned csum = 0;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      c[j] = sm.mcnt[lane * 8 + j];
      csum += c[j];
    }
    if (!kMass) {
      // the highest bin d with above + count(bins >= d) >= k
      u64 run = sm.st.above + lanes_above(csum);
      int found = -1;
      u64 excl = 0;
#pragma unroll
      for (int j = 7; j >= 0; --j) {
        const u64 before = run;
        run += c[j];
        if (found < 0 && run >= k_eff) {
          found = lane * 8 + j;
          excl = before;
        }
      }
      const int d = __reduce_max_sync(kFull, found);
      if (d == found && d >= 0) {
        sm.st.prefix = prefix | (static_cast<unsigned>(d) << shift);
        sm.st.above = excl;
      }
    } else {
      u64 w[8];
      u64 wsum = 0;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        w[j] = sm.mmass[lane * 8 + j];
        wsum += w[j];
      }
      const u64 up = lanes_above(wsum);
      double target = sm.st.target;
      if (level == 0) {  // z: the mass of every kept value
        const u64 z = __shfl_sync(kFull, up + wsum, 0);
        target = static_cast<double>(p) * static_cast<double>(z);
      }
      // the lowest non-empty bin d with above + mass(bins > d) < p z
      u64 run = sm.st.above + up;
      int found = kBins;
      u64 excl = 0;
#pragma unroll
      for (int j = 7; j >= 0; --j) {
        if (c[j] > 0 && static_cast<double>(run) < target) {
          found = lane * 8 + j;
          excl = run;
        }
        run += w[j];
      }
      const int d = __reduce_min_sync(kFull, found);
      if (lane == 0) {
        sm.st.target = target;
        if (d == kBins) sm.st.none = 1;  // only at level 0 (p z <= 0)
      }
      if (d == found && d < kBins) {
        sm.st.prefix = prefix | (static_cast<unsigned>(d) << shift);
        sm.st.above = excl;
      }
    }
  }
  __syncthreads();
  ++pass;
}

// kGlobalRow: the scaled slices live in ws (B rows of V floats) instead
// of shared memory. grid (B, kCluster), clusters of (1, kCluster, 1).
template <bool kGlobalRow>
__global__ void __launch_bounds__(kThreads, 1) fused_sample_kernel(
    const float* __restrict__ logits, const float* __restrict__ noise,
    const float* __restrict__ temperature, const int* __restrict__ top_k,
    const float* __restrict__ top_p, int* __restrict__ out, float* ws,
    int V) {
  // the warps' histograms, then this CTA's slice of the scaled row
  extern __shared__ __align__(16) unsigned char dyn[];
  unsigned* whist = reinterpret_cast<unsigned*>(dyn);
  float* row_s = reinterpret_cast<float*>(dyn + kWarpHistBytes);
  __shared__ Smem sm;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int b = blockIdx.x, tid = threadIdx.x;
  const int chunk = (V + kCluster - 1) / kCluster;
  const int lo = rank * chunk;
  const int n = max(0, min(chunk, V - lo));
  float* row = kGlobalRow ? ws + (size_t)b * V + lo : row_s;
  const float* lrow = logits + (size_t)b * V + lo;
  const float temp = temperature[b];
  const bool greedy = temp <= 0.f;
  const float div = greedy ? 1.f : temp;

  float mx = -INFINITY;
  for (int i = tid; i < n; i += kThreads) {
    const float x = lrow[i] / div;
    row[i] = x;
    mx = fmaxf(mx, x);
  }
  for (int t = tid; t < kBins; t += kThreads) {
    sm.cnt[0][t] = 0;
    sm.mass[0][t] = 0;
  }
  for (int t = tid; t < kWarpHistBytes / 4; t += kThreads) whist[t] = 0;
  if (tid == 0) sm.st = Descent{0u, 0ull, 0.0, 0};
  __syncthreads();

  unsigned keep = 0;  // keep values whose key >= keep
  if (!greedy) {
    int pass = 0;
    const int k = top_k[b];
    const int k_eff = k <= 0 ? V : min(k, V);
    if (k_eff < V) {
      for (int level = 0; level < 4; ++level)
        radix_pass<false>(cluster, sm, whist, row, n, level, pass, 0u,
                          0.f, 0.f, static_cast<unsigned>(k_eff), 0.f);
      keep = sm.st.prefix;  // the k-th largest value's key
    }
    const float p = top_p[b];
    if (p < 1.f) {
      mx = block_max(mx, sm);  // the row's max is always k-kept
      if (tid == 0) {
        sm.pub_max = mx;
        sm.st = Descent{0u, 0ull, 0.0, 0};
      }
      cluster.sync();
      float m = -INFINITY;
      for (int r = 0; r < kCluster; ++r)
        m = fmaxf(m, *cluster.map_shared_rank(&sm.pub_max, r));
      const int bits = 32 - __clz(V);
      const float fx_scale = __int_as_float((127 + min(47, 62 - bits)) << 23);
      for (int level = 0; level < 4; ++level)
        radix_pass<true>(cluster, sm, whist, row, n, level, pass, keep,
                         m, fx_scale, 0u, p);
      // no qualifying value (p <= 0): keep nothing, as the reference's
      // INT_MAX threshold does
      keep = sm.st.none ? kFull : max(keep, sm.st.prefix);
    }
  }

  // -- Gumbel-max over the kept support (the one read of the noise); a
  // greedy row's score is its raw logit
  const float* nrow = noise + (size_t)b * V + lo;
  float best = -INFINITY;
  for (int i = tid; i < n; i += kThreads) {
    const float x = row[i];
    const float s = greedy ? x : (ukey(x) >= keep ? x + nrow[i] : kNegInf);
    row[i] = s;
    best = fmaxf(best, s);
  }
  best = block_max(best, sm);
  int first = 0x7FFFFFFF;
  for (int i = tid; i < n; i += kThreads)
    if (row[i] >= best) first = min(first, lo + i);
  first = block_min(first, sm);
  if (tid == 0) {
    sm.pub_best = best;
    sm.pub_idx = first;
  }
  cluster.sync();
  if (rank == 0 && tid == 0) {
    float g = -INFINITY;
    for (int r = 0; r < kCluster; ++r)
      g = fmaxf(g, *cluster.map_shared_rank(&sm.pub_best, r));
    int idx = V;
    for (int r = 0; r < kCluster; ++r)  // slices in rank order
      if (*cluster.map_shared_rank(&sm.pub_best, r) >= g) {
        idx = *cluster.map_shared_rank(&sm.pub_idx, r);
        break;
      }
    out[b] = idx;
  }
  cluster.sync();  // no CTA leaves while a peer reads its shared memory
}

cudaLaunchConfig_t launch_config(int B, size_t smem, cudaStream_t stream,
                                 cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(B, kCluster, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = 1;
  attr->val.clusterDim.y = kCluster;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

}  // namespace

// Once per device, before the first launch there: raises the kernel's
// dynamic shared-memory limit on the current device to the most a block
// may opt in to beside its static shared memory (the warps' histograms
// and, for the on-chip variant, the row slice), checks that a cluster of
// either variant can be resident (cudaOccupancyMaxActiveClusters) and
// that no error is pending, and returns the largest vocabulary whose
// slices fit shared memory. 0: no cluster of this kernel fits the device;
// a negative return is -cudaError.
extern "C" int kftpu_fused_sample_init() {
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(
        &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  cudaFuncAttributes attrs = {};
  if (err == cudaSuccess)
    err = cudaFuncGetAttributes(&attrs, fused_sample_kernel<false>);
  const int smem = (optin - static_cast<int>(attrs.sharedSizeBytes)) & ~15;
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(fused_sample_kernel<false>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(fused_sample_kernel<true>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kWarpHistBytes);
  int shared_clusters = 0, global_clusters = 0;
  cudaLaunchAttribute attr;
  if (err == cudaSuccess) {
    const cudaLaunchConfig_t cfg = launch_config(1, smem, 0, &attr);
    err = cudaOccupancyMaxActiveClusters(&shared_clusters,
                                         fused_sample_kernel<false>, &cfg);
  }
  if (err == cudaSuccess) {
    const cudaLaunchConfig_t cfg = launch_config(1, kWarpHistBytes, 0, &attr);
    err = cudaOccupancyMaxActiveClusters(&global_clusters,
                                         fused_sample_kernel<true>, &cfg);
  }
  if (err == cudaSuccess) err = cudaGetLastError();
  if (err != cudaSuccess) return -static_cast<int>(err);
  if (shared_clusters < 1 || global_clusters < 1) return 0;
  return kCluster *
         ((smem - kWarpHistBytes) / static_cast<int>(sizeof(float)));
}

// ws: null to keep the scaled row in shared memory (V at most what
// kftpu_fused_sample_init returned), else a (B, V) f32 workspace that
// holds it. Returns the launch's error, else cudaGetLastError() after it
// (0 = cudaSuccess).
extern "C" int kftpu_fused_sample(const void* logits, const void* noise,
                                  const void* temperature, const void* top_k,
                                  const void* top_p, void* out, void* ws,
                                  int B, int V, void* stream) {
  if (B == 0) return 0;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(logits);
  const float* n = static_cast<const float*>(noise);
  const float* t = static_cast<const float*>(temperature);
  const int* k = static_cast<const int*>(top_k);
  const float* p = static_cast<const float*>(top_p);
  int* o = static_cast<int*>(out);
  const size_t chunk = (static_cast<size_t>(V) + kCluster - 1) / kCluster;
  cudaLaunchAttribute attr;
  cudaError_t err;
  if (ws == nullptr) {
    const cudaLaunchConfig_t cfg =
        launch_config(B, kWarpHistBytes + chunk * sizeof(float), s, &attr);
    err = cudaLaunchKernelEx(&cfg, fused_sample_kernel<false>, l, n, t, k, p,
                             o, static_cast<float*>(nullptr), V);
  } else {
    const cudaLaunchConfig_t cfg = launch_config(B, kWarpHistBytes, s, &attr);
    err = cudaLaunchKernelEx(&cfg, fused_sample_kernel<true>, l, n, t, k, p,
                             o, static_cast<float*>(ws), V);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
