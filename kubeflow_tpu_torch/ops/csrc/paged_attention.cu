// Paged decode attention for Hopper (sm_90a), plain C interface.
//
// Replaces: kubeflow_tpu/ops/paged_attention.py:_paged_decode_kernel
// (Pallas body :69, pallas_call :259, wrapper paged_decode_attention
// :185). One query token per row attends over K/V read straight through
// the row's page table: keys with kv_pos <= pos[b] attend, the scale is
// applied after the dot, scores and the softmax run in f32, GQA is
// handled per q-head group (no gqa_repeat), causally dead and sentinel
// pages are never read, and an all-sentinel row writes zeros (l clamped
// to 1e-30, as the Pallas emit does).
//
// What bounds it on H100: HBM bytes. Per step a row reads each live key's
// K and V row once (Dh values per KV head) and does 4*Dh flops per key
// and q head: at Dh = 64 that is ~1 flop per byte, far below the card's
// ~295 flop/byte ridge, so the floor is live K/V bytes over 3.35 TB/s.
// Reaching it takes many loads in flight on every SM.
//
// Design, and what it does about that bound:
// - The TPU kernel walks (row, page) on a sequential grid and carries
//   m/l/acc in VMEM scratch from one grid step to the next. Hopper blocks
//   run in no order, so the page walk is split instead (split-KV, as in
//   flash decoding): grid (B, KH, n_splits), each block takes `pps`
//   consecutive logical pages of one row and one KV head and writes a
//   partial (m, l, acc) for its `group` q heads; a second small kernel
//   folds the splits of each (row, q head). The wrapper sizes a split at
//   about 128 keys (scripts/port_paged_sweep.py): at B = 8, KH = 16 and
//   2048 tokens that is 2048 blocks instead of 128, so every SM has
//   loads in flight, and a short row still spreads over several blocks.
// - Splits past the causal frontier exit at once, and sentinel pages and
//   keys past pos are never loaded: the bytes read are the live keys'.
// - Loads: each key is read by Dh*sizeof(T)/16 neighbouring lanes with
//   one 16-byte load each (a bf16 Dh = 64 row is 128 contiguous bytes, 8
//   lanes), so a warp reads whole rows; the token stride is KH*Dh. The
//   q slice each lane needs stays in registers. Each lane issues the
//   loads of kUnroll keys before it uses any, and the split's page ids
//   are staged in shared memory first, so no load waits on another.
// - Scores for the split are staged in shared memory (group x pps*ps
//   f32); the softmax of a split is exact over the split, and the fold
//   rescales the splits by exp(m_split - m). The P.V sums run in
//   registers per lane, then across lanes by shuffles and across warps
//   in shared memory.
// - Probabilities are rounded to the K/V dtype before the P.V product,
//   as the reference's p.astype(v.dtype) does; l sums the unrounded f32
//   values, as the reference does.
// - Not yet: TMA/cp.async staging, tensor-core dots, a persistent grid.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 4;  // keys in flight per lane
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// 16-byte vector load of N elements, widened to f32.
template <typename T>
struct Vec;
template <>
struct Vec<float> {
  static constexpr int N = 4;
  __device__ __forceinline__ static void load(const float* p, float* o) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    o[0] = v.x; o[1] = v.y; o[2] = v.z; o[3] = v.w;
  }
};
template <>
struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ __forceinline__ static void load(const __nv_bfloat16* p,
                                              float* o) {
    const uint4 v = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      o[2 * i] = f.x;
      o[2 * i + 1] = f.y;
    }
  }
};

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

__device__ __forceinline__ int live_pages(int pos, int ps, int n_log) {
  return pos >= 0 ? min(n_log, pos / ps + 1) : 0;
}

// One (row, KV head, split). G is a compile-time bound on the q-head
// group (1, 2, 4 or 8); `group` <= G is the real one.
// Dynamic shared memory: s (group x cap), red (kWarps x group x Dh),
// m and l (group each) in f32, then the split's page ids (pps ints);
// cap = pps * ps.
// Workspace: ws_acc[((b*KH + kh)*n_splits + sp)*group + g][Dh] and
// ws_ml[...][2] = (m, l) of that split.
template <typename T, int G>
__global__ void __launch_bounds__(kThreads) paged_split_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, const int* __restrict__ pages,
    const int* __restrict__ positions, float* __restrict__ ws_acc,
    float* __restrict__ ws_ml, int QH, int KH, int Dh, int P, int ps,
    int n_log, int pps, int n_splits, float scale) {
  constexpr int VN = Vec<T>::N;
  extern __shared__ float smem[];
  const int b = blockIdx.x;
  const int kh = blockIdx.y;
  const int sp = blockIdx.z;
  const int pos = positions[b];
  const int page0 = sp * pps;
  const int n_live = live_pages(pos, ps, n_log);
  if (page0 >= n_live) return;  // past the causal frontier: block-uniform
  const int group = QH / KH;
  const int cap = pps * ps;
  const int split_tokens = min(pps, n_live - page0) * ps;
  const int lpt = Dh / VN;          // lanes per key row (power of two)
  const int tpb = kThreads / lpt;   // keys per block per pass
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int sub = tid & (lpt - 1);  // this lane's Dh slice
  const int slot = tid / lpt;       // this lane's key within a pass
  float* s_s = smem;
  float* red = s_s + group * cap;
  float* m_s = red + kWarps * group * Dh;
  float* l_s = m_s + group;
  int* pg_s = reinterpret_cast<int*>(l_s + group);  // the split's pages

  const int* prow = pages + (size_t)b * n_log;
  for (int i = tid; i < split_tokens / ps; i += kThreads)
    pg_s[i] = prow[page0 + i];

  float qr[G][VN];
  const size_t q_off = ((size_t)b * QH + (size_t)kh * group) * Dh + sub * VN;
#pragma unroll
  for (int g = 0; g < G; ++g) {
    if (g < group) {
      Vec<T>::load(q + q_off + (size_t)g * Dh, qr[g]);
    } else {
#pragma unroll
      for (int i = 0; i < VN; ++i) qr[g][i] = 0.f;
    }
  }
  __syncthreads();

  const size_t tok_stride = (size_t)KH * Dh;
  const size_t head_off = (size_t)kh * Dh + sub * VN;
  const int pos0 = page0 * ps;  // kv position of the split's first key
  // Row offset of key t of the split, or -1 where it does not attend
  // (past the split, on a sentinel page, or past pos).
  auto row_of = [&](int t) -> long long {
    if (t >= split_tokens || pos0 + t > pos) return -1;
    const int page = pg_s[t / ps];
    if (page < 0 || page >= P) return -1;
    return (long long)(((size_t)page * ps + t % ps) * tok_stride + head_off);
  };

  // -- scores: s = (q . k) * scale, -inf for keys that do not attend -----
  // kUnroll keys per lane per pass, all loads issued before any use
  for (int base = 0; base < split_tokens; base += kUnroll * tpb) {
    float kf[kUnroll][VN];
    long long row[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      row[u] = row_of(base + u * tpb + slot);
      if (row[u] >= 0) Vec<T>::load(k + row[u], kf[u]);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int t = base + u * tpb + slot;
      float part[G];
#pragma unroll
      for (int g = 0; g < G; ++g) {
        part[g] = 0.f;
        if (row[u] >= 0) {
#pragma unroll
          for (int i = 0; i < VN; ++i) part[g] += qr[g][i] * kf[u][i];
        }
      }
      // every lane of the warp runs the same passes, so the shuffles
      // see the whole warp
      for (int o = lpt >> 1; o > 0; o >>= 1) {
#pragma unroll
        for (int g = 0; g < G; ++g)
          part[g] += __shfl_xor_sync(kFull, part[g], o);
      }
      if (sub == 0 && t < split_tokens) {
#pragma unroll
        for (int g = 0; g < G; ++g) {
          if (g < group)
            s_s[g * cap + t] = row[u] >= 0 ? part[g] * scale : -INFINITY;
        }
      }
    }
  }
  __syncthreads();

  // -- softmax of the split, one warp per q head of the group -----------
  for (int g = warp; g < group; g += kWarps) {
    float* sg = s_s + g * cap;
    float mx = -INFINITY;
    for (int t = lane; t < split_tokens; t += 32) mx = fmaxf(mx, sg[t]);
    mx = warp_max(mx);
    const bool any = mx != -INFINITY;  // false: every page was a sentinel
    float sum = 0.f;
    for (int t = lane; t < split_tokens; t += 32) {
      const float p = any ? expf(sg[t] - mx) : 0.f;  // exp(-inf) = 0
      sum += p;
      sg[t] = to_f32(from_f32<T>(p));  // p.astype(v.dtype)
    }
    sum = warp_sum(sum);
    if (lane == 0) {
      m_s[g] = any ? mx : kNegInf;
      l_s[g] = sum;
    }
  }
  __syncthreads();

  // -- acc = p @ V over the split's live keys ---------------------------
  float acc[G][VN];
#pragma unroll
  for (int g = 0; g < G; ++g) {
#pragma unroll
    for (int i = 0; i < VN; ++i) acc[g][i] = 0.f;
  }
  for (int base = 0; base < split_tokens; base += kUnroll * tpb) {
    float vf[kUnroll][VN];
    long long row[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      row[u] = row_of(base + u * tpb + slot);
      if (row[u] >= 0) Vec<T>::load(v + row[u], vf[u]);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (row[u] < 0) continue;
      const int t = base + u * tpb + slot;
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const float p = g < group ? s_s[g * cap + t] : 0.f;
#pragma unroll
        for (int i = 0; i < VN; ++i) acc[g][i] += p * vf[u][i];
      }
    }
  }
  // lanes holding the same Dh slice: fold across the warp's keys
  for (int o = 16; o >= lpt; o >>= 1) {
#pragma unroll
    for (int g = 0; g < G; ++g) {
#pragma unroll
      for (int i = 0; i < VN; ++i)
        acc[g][i] += __shfl_xor_sync(kFull, acc[g][i], o);
    }
  }
  if (lane < lpt) {
#pragma unroll
    for (int g = 0; g < G; ++g) {
      if (g < group) {
#pragma unroll
        for (int i = 0; i < VN; ++i)
          red[(warp * group + g) * Dh + sub * VN + i] = acc[g][i];
      }
    }
  }
  __syncthreads();
  const size_t ws = (((size_t)b * KH + kh) * n_splits + sp) * group;
  for (int i = tid; i < group * Dh; i += kThreads) {
    float a = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) a += red[w * group * Dh + i];
    ws_acc[ws * Dh + i] = a;
  }
  if (tid < group) {
    ws_ml[(ws + tid) * 2] = m_s[tid];
    ws_ml[(ws + tid) * 2 + 1] = l_s[tid];
  }
}

// Fold the live splits of one (row, q head): grid (B, QH), Dh threads.
template <typename T>
__global__ void paged_combine_kernel(const float* __restrict__ ws_acc,
                                     const float* __restrict__ ws_ml,
                                     const int* __restrict__ positions,
                                     T* __restrict__ out, int QH, int KH,
                                     int Dh, int ps, int n_log, int pps,
                                     int n_splits) {
  const int b = blockIdx.x;
  const int h = blockIdx.y;
  const int group = QH / KH;
  const int kh = h / group;
  const int g = h - kh * group;
  const int n_sp = (live_pages(positions[b], ps, n_log) + pps - 1) / pps;
  const size_t base = ((size_t)b * KH + kh) * n_splits;
  float m = kNegInf;
  for (int s = 0; s < n_sp; ++s)
    m = fmaxf(m, ws_ml[((base + s) * group + g) * 2]);
  float l = 0.f;
  for (int s = 0; s < n_sp; ++s) {
    const size_t i = ((base + s) * group + g) * 2;
    l += ws_ml[i + 1] * expf(ws_ml[i] - m);
  }
  for (int d = threadIdx.x; d < Dh; d += blockDim.x) {
    float a = 0.f;
    for (int s = 0; s < n_sp; ++s) {
      const size_t i = (base + s) * group + g;
      a += ws_acc[i * Dh + d] * expf(ws_ml[i * 2] - m);
    }
    out[((size_t)b * QH + h) * Dh + d] = from_f32<T>(a / fmaxf(l, 1e-30f));
  }
}

template <typename T, int G>
void launch_split(dim3 grid, size_t smem, cudaStream_t s, const void* q,
                  const void* k, const void* v, const void* pages,
                  const void* positions, void* ws_acc, void* ws_ml, int QH,
                  int KH, int Dh, int P, int ps, int n_log, int pps,
                  int n_splits, float scale) {
  paged_split_kernel<T, G><<<grid, kThreads, smem, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int*>(pages),
      static_cast<const int*>(positions), static_cast<float*>(ws_acc),
      static_cast<float*>(ws_ml), QH, KH, Dh, P, ps, n_log, pps, n_splits,
      scale);
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* pages,
           const void* positions, void* out, void* ws_acc, void* ws_ml,
           int B, int QH, int KH, int Dh, int P, int ps, int n_log, int pps,
           float scale, cudaStream_t s, size_t smem) {
  const int group = QH / KH;
  const int n_splits = (n_log + pps - 1) / pps;
  const dim3 grid(B, KH, n_splits);
  if (group <= 1)
    launch_split<T, 1>(grid, smem, s, q, k, v, pages, positions, ws_acc,
                       ws_ml, QH, KH, Dh, P, ps, n_log, pps, n_splits, scale);
  else if (group <= 2)
    launch_split<T, 2>(grid, smem, s, q, k, v, pages, positions, ws_acc,
                       ws_ml, QH, KH, Dh, P, ps, n_log, pps, n_splits, scale);
  else if (group <= 4)
    launch_split<T, 4>(grid, smem, s, q, k, v, pages, positions, ws_acc,
                       ws_ml, QH, KH, Dh, P, ps, n_log, pps, n_splits, scale);
  else if (group <= 8)
    launch_split<T, 8>(grid, smem, s, q, k, v, pages, positions, ws_acc,
                       ws_ml, QH, KH, Dh, P, ps, n_log, pps, n_splits, scale);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  paged_combine_kernel<T><<<dim3(B, QH), Dh, 0, s>>>(
      static_cast<const float*>(ws_acc), static_cast<const float*>(ws_ml),
      static_cast<const int*>(positions), static_cast<T*>(out), QH, KH, Dh,
      ps, n_log, pps, n_splits);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Dynamic shared memory of one split block.
extern "C" size_t kftpu_paged_decode_smem_bytes(int group, int Dh, int ps,
                                                int pps) {
  return (size_t)(group * pps * ps + kWarps * group * Dh + 2 * group) *
             sizeof(float) +
         (size_t)pps * sizeof(int);
}

// Largest q-head group the kernel takes.
extern "C" int kftpu_paged_decode_max_group() { return 8; }

// ws_acc: B*KH*n_splits*group*Dh f32, ws_ml: B*KH*n_splits*group*2 f32,
// n_splits = ceil(n_log / pps). Returns cudaGetLastError() after the
// launches (0 = cudaSuccess).
extern "C" int kftpu_paged_decode_attention(
    const void* q, const void* k, const void* v, const void* pages,
    const void* positions, void* out, void* ws_acc, void* ws_ml, int B,
    int QH, int KH, int Dh, int P, int ps, int n_log, int pps, float scale,
    int is_bf16, void* stream) {
  if (B == 0) return 0;
  const size_t smem = kftpu_paged_decode_smem_bytes(QH / KH, Dh, ps, pps);
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch<__nv_bfloat16>(q, k, v, pages, positions, out, ws_acc,
                                 ws_ml, B, QH, KH, Dh, P, ps, n_log, pps,
                                 scale, s, smem);
  return launch<float>(q, k, v, pages, positions, out, ws_acc, ws_ml, B, QH,
                       KH, Dh, P, ps, n_log, pps, scale, s, smem);
}
