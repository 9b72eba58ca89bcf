// Fused temperature -> top-k -> top-p -> Gumbel-max sampler for Hopper
// (sm_90a), plain C interface.
//
// Replaces: kubeflow_tpu/ops/sampling.py:_fused_sample_kernel (Pallas
// body :77, pallas_call :177, wrapper fused_sample :141). Exact filters
// without a sort: the k-th largest value and the nucleus threshold are
// each found by a 32-step binary search over the ordered-int encoding
// of f32 (_ordered_bits :63, overflow-safe _mid :71), then one
// Gumbel-max draw over the kept support with first-index tie-break.
// top_p >= 1 is a strict no-op, top_k <= 0 means no k filter, and a
// greedy row (temperature <= 0) takes the argmax of the raw logits.
// The Gumbel noise is an input, as in the reference.
//
// What bounds it on H100: HBM bytes, one read of the logits row and of
// the noise row (2 x 4 x V bytes per sampled row; the noise is not read
// for a greedy row). The 64 search passes are block-wide count/sum
// reductions of a few flops per element: ~1 flop per byte of the row
// per pass, all of it on data already on chip.
//
// Design, and what it does about that bound:
// - One block of 1024 threads per row. At V = 32000 the scaled row is
//   128 KB of f32: it fits the 227 KB a block may take, but logits and
//   noise together do not. So the kernel STAGES THE SCALED ROW IN
//   SHARED MEMORY once, runs every search pass out of shared memory,
//   and reads the noise once, in the final pass, straight from HBM.
//   Device memory sees each input exactly once.
// - exp(scaled - m) is recomputed in each top-p pass instead of being
//   stored: a second 128 KB row would not fit beside the first, and
//   expf on data in shared memory is cheaper than a trip to L2.
// - Reductions: warp shuffles, then every thread folds the 32 warp
//   partials in the same order, so all threads see the same value and
//   every branch on it is block-uniform. Sums run in a fixed order, so
//   a row samples the same token on every run.
// - Greedy rows skip both searches (their result never reads them),
//   and so do rows whose filter is off (k_eff == V, or p >= 1).
// - The row must fit shared memory: V <= 57,000 or so; the wrapper
//   refuses larger vocabularies (a multi-pass variant over L2 is later
//   work, ROADMAP Queue B).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr float kNegInf = -1e30f;
constexpr int kIntMin = -2147483647 - 1;
constexpr int kIntMax = 2147483647;

// f32 -> int32 with int order == float order (no NaNs)
__device__ __forceinline__ int ordered_bits(float x) {
  const int b = __float_as_int(x);
  return b < 0 ? (b ^ 0x7FFFFFFF) : b;
}

// overflow-safe midpoint over the full int32 range
__device__ __forceinline__ int mid_of(int lo, int hi) {
  return (lo >> 1) + (hi >> 1) + (lo & hi & 1);
}

struct SumF {
  __device__ float operator()(float a, float b) const { return a + b; }
};
struct MaxF {
  __device__ float operator()(float a, float b) const { return fmaxf(a, b); }
};
struct SumI {
  __device__ int operator()(int a, int b) const { return a + b; }
};
struct MinI {
  __device__ int operator()(int a, int b) const { return min(a, b); }
};

// Block-wide reduction; every thread returns the same value.
template <typename V, typename Op>
__device__ __forceinline__ V block_reduce(V v, V* scratch, Op op) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = op(v, __shfl_xor_sync(0xffffffffu, v, o));
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  V r = scratch[0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) r = op(r, scratch[w]);
  __syncthreads();  // scratch is reused by the next reduction
  return r;
}

__global__ void __launch_bounds__(kThreads) fused_sample_kernel(
    const float* __restrict__ logits, const float* __restrict__ noise,
    const float* __restrict__ temperature, const int* __restrict__ top_k,
    const float* __restrict__ top_p, int* __restrict__ out, int V) {
  extern __shared__ float row[];  // the scaled row, V floats
  __shared__ float fscratch[kWarps];
  __shared__ int iscratch[kWarps];
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const float* lrow = logits + (size_t)b * V;
  const float temp = temperature[b];
  const bool greedy = temp <= 0.f;
  const float div = greedy ? 1.f : temp;

  float mx = kNegInf;
  for (int i = tid; i < V; i += kThreads) {
    const float x = lrow[i] / div;
    row[i] = x;
    mx = fmaxf(mx, x);
  }
  __syncthreads();

  if (greedy) {
    // scaled == raw logits here; first index of the maximum
    const float m = block_reduce(mx, fscratch, MaxF());
    int first = V;
    for (int i = tid; i < V; i += kThreads)
      if (row[i] >= m) first = min(first, i);
    first = block_reduce(first, iscratch, MinI());
    if (tid == 0) out[b] = first;
    return;
  }

  // -- top-k: largest t with count(ordered >= t) >= k_eff -------------
  const int k = top_k[b];
  const int k_eff = k <= 0 ? V : min(k, V);
  int kth = kIntMin;  // k_eff == V keeps every element
  if (k_eff < V) {
    int lo = kIntMin, hi = kIntMax;
    for (int it = 0; it < 32; ++it) {
      const int mid = mid_of(lo, hi);
      int cnt = 0;
      for (int i = tid; i < V; i += kThreads)
        cnt += ordered_bits(row[i]) >= mid;
      cnt = block_reduce(cnt, iscratch, SumI());
      if (cnt >= k_eff) lo = mid; else hi = mid;
    }
    kth = lo;
  }

  // -- top-p over the k-filtered renormalised distribution ------------
  const float p = top_p[b];
  int p_thresh = kIntMin;  // p >= 1: the k mask alone
  if (p < 1.f) {
    float m = kNegInf;
    for (int i = tid; i < V; i += kThreads)
      if (ordered_bits(row[i]) >= kth) m = fmaxf(m, row[i]);
    m = block_reduce(m, fscratch, MaxF());
    float z = 0.f;
    for (int i = tid; i < V; i += kThreads)
      if (ordered_bits(row[i]) >= kth) z += expf(row[i] - m);
    z = block_reduce(z, fscratch, SumF());
    const float target = p * z;
    // Q(t) = "mass strictly above t < p*z" is monotone; hi converges
    // to the smallest int with Q
    int lo = kIntMin, hi = kIntMax;
    for (int it = 0; it < 32; ++it) {
      const int mid = mid_of(lo, hi);
      float mass = 0.f;
      for (int i = tid; i < V; i += kThreads) {
        const int o = ordered_bits(row[i]);
        if (o >= kth && o > mid) mass += expf(row[i] - m);
      }
      mass = block_reduce(mass, fscratch, SumF());
      if (mass < target) hi = mid; else lo = mid;
    }
    int t = kIntMax;
    for (int i = tid; i < V; i += kThreads) {
      const int o = ordered_bits(row[i]);
      if (o >= kth && o >= hi) t = min(t, o);
    }
    p_thresh = block_reduce(t, iscratch, MinI());
  }
  const int keep_from = max(kth, p_thresh);

  // -- Gumbel-max over the kept support (the one read of the noise) ----
  const float* nrow = noise + (size_t)b * V;
  float best = kNegInf;
  for (int i = tid; i < V; i += kThreads) {
    const float s = ordered_bits(row[i]) >= keep_from ? row[i] + nrow[i]
                                                      : kNegInf;
    row[i] = s;
    best = fmaxf(best, s);
  }
  best = block_reduce(best, fscratch, MaxF());
  int first = V;
  for (int i = tid; i < V; i += kThreads)
    if (row[i] >= best) first = min(first, i);
  first = block_reduce(first, iscratch, MinI());
  if (tid == 0) out[b] = first;
}

}  // namespace

// Once per device, before the first launch there: raises the kernel's
// dynamic shared-memory limit on the current device to the most a block
// may opt in to, and returns the largest vocabulary whose row fits it.
// A negative return is -cudaError.
extern "C" int kftpu_fused_sample_init() {
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(
        &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  // static scratch: two kWarps-wide arrays
  const int smem = optin - 2 * kWarps * 4;
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(fused_sample_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
  if (err != cudaSuccess) return -static_cast<int>(err);
  return smem / (int)sizeof(float);
}

// Returns cudaGetLastError() after the launch (0 = cudaSuccess).
extern "C" int kftpu_fused_sample(const void* logits, const void* noise,
                                  const void* temperature, const void* top_k,
                                  const void* top_p, void* out, int B, int V,
                                  void* stream) {
  if (B == 0) return 0;
  const size_t smem = (size_t)V * sizeof(float);
  fused_sample_kernel<<<B, kThreads, smem,
                        reinterpret_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(logits), static_cast<const float*>(noise),
      static_cast<const float*>(temperature),
      static_cast<const int*>(top_k), static_cast<const float*>(top_p),
      static_cast<int*>(out), V);
  return static_cast<int>(cudaGetLastError());
}
