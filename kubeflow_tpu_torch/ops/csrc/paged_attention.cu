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
// Reaching it takes many loads in flight on every SM, and, at the short
// rows of a serving batch (a few hundred keys), few dependent steps
// between the launch and the last byte.
//
// Design, and what it does about that bound:
// - The TPU kernel walks (row, page) on a sequential grid and carries
//   m/l/acc in VMEM scratch from one grid step to the next. Hopper blocks
//   run in no order, so the page walk is split (split-KV, as in flash
//   decoding): grid (B, KH, n_splits), each block takes `pps` consecutive
//   logical pages of one row and one KV head (the wrapper sizes a split
//   at about _SPLIT_TOKENS keys, scripts/port_paged_sweep.py). Splits
//   past the causal frontier exit at once.
// - One pass over HBM: the block stages its split's page ids in shared
//   memory, then issues cp.async copies (16 bytes each) of the K AND V
//   rows of its keys up to pos into a 2-stage ring (8 KB of K and 8 KB
//   of V a stage: 64 keys at bf16, Dh = 64), both stages before it waits
//   on either, so a split of 128 such keys (32 KB) is in flight at once;
//   a longer split streams through the ring, each stage refilled as soon
//   as it is consumed. Keys on sentinel pages are never staged.
// - Scores, the softmax and P.V run from shared memory with no block-wide
//   step between them: each key row is read by Dh*sizeof(T)/16
//   neighbouring lanes (a lane group), 16 bytes each (conflict-free: a
//   warp reads whole contiguous rows); the q slice each lane needs stays
//   in registers, the dot is finished by shuffles within the group, and
//   each group keeps its own online softmax (m, l and its slice of acc)
//   over the kKeys keys it takes from each stage. At the end the groups
//   are folded within the warp by shuffles and across warps in shared
//   memory; a row's only split writes out directly.
// - Probabilities are rounded to the K/V dtype before the P.V product
//   (at the running max, as the Pallas kernel rounds at its per-page
//   running max); l sums the unrounded f32 values, as the reference does.
// - The fold is fused: each split writes its partial (m, l, acc) to a
//   workspace, fences, and draws a ticket from a per-(row, KV head)
//   counter. The block that draws the last live ticket folds the live
//   splits in split order (so the result does not depend on which block
//   finished last: repeat calls are bit-identical), writes out, and resets
//   the counter to 0 for the next call. One launch a call.
// - Any GQA group and head dim (up to 256): a group past 8 q heads is
//   taken in blocks of at most 8 on the grid's y axis (the reference's
//   head_block), each with its own workspace rows and counter, re-reading
//   the KV head's pages. A key row's lanes are rounded up to a power of
//   two, the idle ones masked (Dh = 96 at bf16: 12 chunks on 16 lanes),
//   and at f32 past 128 each lane takes two 16-byte slices of a row, with
//   half the keys a stage, so the ring stays within 32 KB. The serving
//   shape (group 1, Dh 64) takes one block of one head and one slice.
// - Not yet: TMA staging, tensor-core dots for large GQA groups, a
//   persistent grid.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
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

// 16-byte vector load of N elements (global or shared), widened to f32.
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

__device__ __forceinline__ int live_pages(int pos, int ps, int n_log) {
  return pos >= 0 ? min(n_log, pos / ps + 1) : 0;
}

// 16 bytes global -> shared, around the L1.
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   static_cast<unsigned>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N committed groups of this thread are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

constexpr int kKeys = 4;
// q heads a block takes at most (the reference's head_block); a larger
// GQA group is split over blocks of the grid's y axis
constexpr int kMaxGroup = 8;

// A key row's 16-byte chunks, the 16-byte slices each lane takes (two
// where a row has more than 32 chunks: Dh = 256 at f32), and the lanes
// that read one key row (a lane group): the chunks over the slices,
// rounded up to a power of two; the lanes past the row idle.
__host__ __device__ __forceinline__ int row_chunks(int Dh, int el) {
  return Dh * el / 16;
}
__host__ __device__ __forceinline__ int row_slices(int Dh, int el) {
  return row_chunks(Dh, el) > 32 ? 2 : 1;
}
__host__ __device__ __forceinline__ int row_lanes(int Dh, int el) {
  const int ns = row_slices(Dh, el);
  const int need = (row_chunks(Dh, el) + ns - 1) / ns;
  int lanes = 1;
  while (lanes < need) lanes <<= 1;
  return lanes;
}

// Keys a ring stage holds: kKeys / slices for each lane group, so a stage
// of K (or of V) is 8 KB where a row fills its lanes (16 * 128 * 4 bytes).
__host__ __device__ __forceinline__ int stage_rows(int Dh, int el) {
  return kKeys / row_slices(Dh, el) * (kThreads / row_lanes(Dh, el));
}

// Dynamic shared memory of one block: the 2-stage K and V ring, which
// once drained holds the cross-warp partials (kWarps x heads x (Dh + 2)
// f32), then the split's page ids (pps ints).
__host__ __device__ __forceinline__ size_t ring_bytes(int group, int Dh,
                                                      int el) {
  const int heads = group < kMaxGroup ? group : kMaxGroup;
  const size_t ring = (size_t)4 * stage_rows(Dh, el) * Dh * el;
  const size_t red = (size_t)kWarps * heads * (Dh + 2) * sizeof(float);
  return ring > red ? ring : red;
}
__host__ __device__ __forceinline__ size_t smem_bytes(int group, int Dh,
                                                      int el, int pps) {
  return ring_bytes(group, Dh, el) + (size_t)pps * sizeof(int);
}

// One (row, KV head, head block, split). The q-head group of a KV head is
// taken in blocks of at most kMaxGroup heads (n_hb of them, grid y =
// KH * n_hb); each re-reads the KV head's pages. G is a compile-time
// bound on a block's heads (1, 2, 4 or 8), NS the 16-byte slices a lane
// takes of a key row, kMasked whether some lanes of a key row idle (Dh =
// 96 at bf16; without them the serving shape runs no edge checks). Each
// lane group (the lpt lanes that read one key row) keeps its own online
// softmax (m, l and its slices of acc per q head) over the keys it
// takes, kKeys / NS a stage; the lane groups are folded at the end,
// within the warp by shuffles and across warps in shared memory.
// Workspace, per unit u = (b*KH + kh)*n_hb + hb:
// ws_acc[(u*n_splits + sp)*HB + g][Dh] and ws_ml[...][2] = (m, l) of that
// split, HB = min(group, kMaxGroup); counters[u] counts the splits of the
// unit that have written theirs, 0 between calls.
template <typename T, int G, int NS, bool kMasked>
__global__ void __launch_bounds__(kThreads) paged_decode_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, const int* __restrict__ pages,
    const int* __restrict__ positions, T* __restrict__ out,
    float* __restrict__ ws_acc, float* __restrict__ ws_ml,
    unsigned* __restrict__ counters, int QH, int KH, int Dh, int P, int ps,
    int n_log, int pps, int n_splits, int n_hb, int lpt, float scale) {
  constexpr int VN = Vec<T>::N;
  constexpr int KK = kKeys / NS;    // keys a lane group takes a stage
  constexpr int SV = NS * VN;       // values a lane holds of a row
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ int is_last;
  const int b = blockIdx.x;
  const int kh = blockIdx.y / n_hb;
  const int hb = blockIdx.y - kh * n_hb;
  const int sp = blockIdx.z;
  const int group = QH / KH;
  const int HB = min(group, kMaxGroup);    // heads a block (ws stride)
  const int gb = min(HB, group - hb * kMaxGroup);  // this block's heads
  const int chunks = Dh / VN;       // 16-byte chunks of a key row
  const int tpb = kThreads / lpt;   // lane groups a block
  const int rows = KK * tpb;        // keys a ring stage
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int sub = tid & (lpt - 1);  // this lane's chunks: sub + j * lpt
  const int slot = tid / lpt;       // this lane's group
  T* ks = reinterpret_cast<T*>(smem_raw);
  T* vs = ks + 2 * rows * Dh;
  int* pg_s = reinterpret_cast<int*>(
      smem_raw + ring_bytes(group, Dh, (int)sizeof(T)));
  // the drained ring: per warp and q head, acc (Dh), then m and l
  float* red = reinterpret_cast<float*>(smem_raw);

  // the split's page ids, the row's position and the q slices, loaded
  // together
  const int page0 = sp * pps;
  const int* prow = pages + (size_t)b * n_log;
  for (int i = tid; i < pps && page0 + i < n_log; i += kThreads)
    pg_s[i] = prow[page0 + i];
  const int pos = positions[b];
  const size_t head0 = (size_t)b * QH + (size_t)kh * group + hb * kMaxGroup;
  float qr[G][SV];
#pragma unroll
  for (int g = 0; g < G; ++g)
#pragma unroll
    for (int j = 0; j < NS; ++j) {
      const int c = sub + j * lpt;
      if (g < gb && (!kMasked || c < chunks)) {
        Vec<T>::load(q + (head0 + g) * Dh + c * VN, qr[g] + j * VN);
      } else {
#pragma unroll
        for (int i = 0; i < VN; ++i) qr[g][j * VN + i] = 0.f;
      }
    }
  const int n_live = live_pages(pos, ps, n_log);
  const int n_sp = (n_live + pps - 1) / pps;  // live splits of the row
  T* ob = out + head0 * Dh;
  if (sp >= n_sp) {  // past the causal frontier: block-uniform
    if (n_sp == 0 && sp == 0) {  // no live page at all: zeros
      for (int i = tid; i < gb * Dh; i += kThreads) ob[i] = from_f32<T>(0.f);
    }
    return;
  }
  __syncthreads();  // pg_s

  const int pos0 = page0 * ps;  // kv position of the split's first key
  // keys of the split up to pos (those past it are never staged)
  const int n_tok = min(min(pps, n_live - page0) * ps, pos + 1 - pos0);
  const int n_st = (n_tok + rows - 1) / rows;
  const size_t tok_stride = (size_t)KH * Dh;
  // a key's page, or -1 where it is past the split's keys or unmapped
  auto page_of = [&](int t) {
    if (t >= n_tok) return -1;
    const int page = pg_s[t / ps];
    return page >= 0 && page < P ? page : -1;
  };

  // start the copies of stage st's K and V rows (16 bytes each; the rows
  // of unmapped pages are not staged)
  auto stage_copy = [&](int st) {
    T* kd = ks + (st & 1) * rows * Dh;
    T* vd = vs + (st & 1) * rows * Dh;
    const int t0 = st * rows;
    for (int e = tid; e < rows * chunks; e += kThreads) {
      const int r = e / chunks, c = e - r * chunks, t = t0 + r;
      const int page = page_of(t);
      if (page >= 0) {
        const size_t off = ((size_t)page * ps + t % ps) * tok_stride +
                           (size_t)kh * Dh + c * VN;
        cp_async16(kd + r * Dh + c * VN, k + off);
        cp_async16(vd + r * Dh + c * VN, v + off);
      }
    }
    cp_async_commit();
  };
  stage_copy(0);
  if (n_st > 1) stage_copy(1);

  // this lane's slices of a key row from shared memory; zeros on the
  // lanes past the row
  auto row_load = [&](const T* rowp, float* dst) {
#pragma unroll
    for (int j = 0; j < NS; ++j) {
      const int c = sub + j * lpt;
      if (!kMasked || c < chunks) {
        Vec<T>::load(rowp + c * VN, dst + j * VN);
      } else {
#pragma unroll
        for (int i = 0; i < VN; ++i) dst[j * VN + i] = 0.f;
      }
    }
  };

  float m[G], l[G], acc[G][SV];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    m[g] = kNegInf;
    l[g] = 0.f;
#pragma unroll
    for (int i = 0; i < SV; ++i) acc[g][i] = 0.f;
  }
  for (int st = 0; st < n_st; ++st) {
    if (st + 1 < n_st) {
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const T* kt = ks + (st & 1) * rows * Dh;
    const T* vt = vs + (st & 1) * rows * Dh;

    // this lane group's keys r = slot + u * tpb of the stage: scores
    // s = (q . k) * scale, -inf where the key does not attend
    bool live[KK];
    float x[KK][SV], s[KK][G];
#pragma unroll
    for (int u = 0; u < KK; ++u) {
      const int r = slot + u * tpb;
      live[u] = page_of(st * rows + r) >= 0;
      if (live[u]) row_load(kt + r * Dh, x[u]);
#pragma unroll
      for (int g = 0; g < G; ++g) {
        s[u][g] = 0.f;
        if (live[u]) {
#pragma unroll
          for (int i = 0; i < SV; ++i) s[u][g] += qr[g][i] * x[u][i];
        }
      }
    }
    // the dot over the group's lanes; every lane of a warp runs this
    for (int o = lpt >> 1; o > 0; o >>= 1) {
#pragma unroll
      for (int u = 0; u < KK; ++u)
#pragma unroll
        for (int g = 0; g < G; ++g)
          s[u][g] += __shfl_xor_sync(kFull, s[u][g], o);
    }
#pragma unroll
    for (int u = 0; u < KK; ++u) {
      const int r = slot + u * tpb;
      if (live[u]) row_load(vt + r * Dh, x[u]);
    }

    // online softmax step over these keys; P rounded to the K/V dtype
    // before P.V, l sums the unrounded values
#pragma unroll
    for (int g = 0; g < G; ++g) {
      float mx = m[g];
#pragma unroll
      for (int u = 0; u < KK; ++u) {
        s[u][g] = live[u] ? s[u][g] * scale : -INFINITY;
        mx = fmaxf(mx, s[u][g]);
      }
      const float alpha = expf(m[g] - mx);  // m starts finite: no nan
      m[g] = mx;
      l[g] *= alpha;
#pragma unroll
      for (int i = 0; i < SV; ++i) acc[g][i] *= alpha;
#pragma unroll
      for (int u = 0; u < KK; ++u) {
        const float p = expf(s[u][g] - mx);  // exp(-inf) = 0
        l[g] += p;
        const float pr = to_f32(from_f32<T>(p));  // p.astype(v.dtype)
        if (live[u]) {
#pragma unroll
          for (int i = 0; i < SV; ++i) acc[g][i] += pr * x[u][i];
        }
      }
    }
    __syncthreads();  // stage st & 1 is free
    if (st + 2 < n_st) stage_copy(st + 2);
  }

  // fold the lane groups: within the warp (lanes of the same slice), then
  // across warps in shared memory, always in the same order
  for (int o = lpt; o < 32; o <<= 1) {
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const float mb = __shfl_xor_sync(kFull, m[g], o);
      const float lb = __shfl_xor_sync(kFull, l[g], o);
      const float mm = fmaxf(m[g], mb);
      const float wa = expf(m[g] - mm), wb = expf(mb - mm);
      l[g] = l[g] * wa + lb * wb;
      m[g] = mm;
#pragma unroll
      for (int i = 0; i < SV; ++i) {
        const float ab = __shfl_xor_sync(kFull, acc[g][i], o);
        acc[g][i] = acc[g][i] * wa + ab * wb;
      }
    }
  }
  const int stride = gb * (Dh + 2);  // floats a warp
  if (lane < lpt) {
#pragma unroll
    for (int g = 0; g < G; ++g) {
      if (g < gb) {
        float* rg = red + warp * stride + g * (Dh + 2);
#pragma unroll
        for (int j = 0; j < NS; ++j) {
          const int c = sub + j * lpt;
          if (!kMasked || c < chunks) {
#pragma unroll
            for (int i = 0; i < VN; ++i) rg[c * VN + i] = acc[g][j * VN + i];
          }
        }
        if (sub == 0) {
          rg[Dh] = m[g];
          rg[Dh + 1] = l[g];
        }
      }
    }
  }
  __syncthreads();
  const size_t unit = ((size_t)b * KH + kh) * n_hb + hb;
  const size_t ws = (unit * n_splits + sp) * HB;
  for (int i = tid; i < gb * Dh; i += kThreads) {
    const int g = i / Dh, d = i - g * Dh;
    float mm = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w)
      mm = fmaxf(mm, red[w * stride + g * (Dh + 2) + Dh]);
    float a = 0.f, ls = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float* rg = red + w * stride + g * (Dh + 2);
      const float wt = expf(rg[Dh] - mm);
      a += rg[d] * wt;
      ls += rg[Dh + 1] * wt;
    }
    if (n_sp == 1) {  // the row's only split: nothing to fold
      ob[i] = from_f32<T>(a / fmaxf(ls, 1e-30f));
    } else {
      ws_acc[ws * Dh + i] = a;
      if (d == 0) {
        ws_ml[(ws + g) * 2] = mm;
        ws_ml[(ws + g) * 2 + 1] = ls;
      }
    }
  }
  if (n_sp == 1) return;

  // -- the fold: the last live split of the unit to finish ---------------
  __threadfence();  // this thread's partials reach L2 before the ticket
  __syncthreads();
  if (tid == 0)
    is_last = atomicAdd(counters + unit, 1u) == (unsigned)(n_sp - 1);
  __syncthreads();
  if (!is_last) return;
  __threadfence();
  const size_t base = unit * n_splits;
  for (int i = tid; i < gb * Dh; i += kThreads) {
    const int g = i / Dh, d = i - g * Dh;
    float mm = kNegInf;
    for (int s = 0; s < n_sp; ++s)
      mm = fmaxf(mm, __ldcg(ws_ml + ((base + s) * HB + g) * 2));
    float ls = 0.f, a = 0.f;
    for (int s = 0; s < n_sp; ++s) {  // in split order
      const size_t j = (base + s) * HB + g;
      const float wt = expf(__ldcg(ws_ml + j * 2) - mm);
      ls += __ldcg(ws_ml + j * 2 + 1) * wt;
      a += __ldcg(ws_acc + j * Dh + d) * wt;
    }
    ob[i] = from_f32<T>(a / fmaxf(ls, 1e-30f));
  }
  if (tid == 0) counters[unit] = 0u;  // ready for the next call
}

template <typename T, int G, int NS, bool kMasked>
int launch_group(dim3 grid, size_t smem, cudaStream_t s, const void* q,
                 const void* k, const void* v, const void* pages,
                 const void* positions, void* out, void* ws_acc, void* ws_ml,
                 void* counters, int QH, int KH, int Dh, int P, int ps,
                 int n_log, int pps, int n_splits, int n_hb, int lpt,
                 float scale) {
  paged_decode_kernel<T, G, NS, kMasked><<<grid, kThreads, smem, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int*>(pages),
      static_cast<const int*>(positions), static_cast<T*>(out),
      static_cast<float*>(ws_acc), static_cast<float*>(ws_ml),
      static_cast<unsigned*>(counters), QH, KH, Dh, P, ps, n_log, pps,
      n_splits, n_hb, lpt, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int NS, bool kMasked>
int launch(const void* q, const void* k, const void* v, const void* pages,
           const void* positions, void* out, void* ws_acc, void* ws_ml,
           void* counters, int B, int QH, int KH, int Dh, int P, int ps,
           int n_log, int pps, float scale, cudaStream_t s) {
  const int lpt = row_lanes(Dh, (int)sizeof(T));
  const int group = QH / KH;
  const int n_hb = (group + kMaxGroup - 1) / kMaxGroup;
  const int heads = group < kMaxGroup ? group : kMaxGroup;
  const int n_splits = (n_log + pps - 1) / pps;
  const dim3 grid(B, KH * n_hb, n_splits);
  const size_t smem = smem_bytes(group, Dh, (int)sizeof(T), pps);
#define KFTPU_PAGED_GROUP(G)                                              \
  return launch_group<T, G, NS, kMasked>(                                 \
      grid, smem, s, q, k, v, pages, positions, out, ws_acc, ws_ml,       \
      counters, QH, KH, Dh, P, ps, n_log, pps, n_splits, n_hb, lpt, scale)
  if (heads <= 1) KFTPU_PAGED_GROUP(1);
  if (heads <= 2) KFTPU_PAGED_GROUP(2);
  if (heads <= 4) KFTPU_PAGED_GROUP(4);
  KFTPU_PAGED_GROUP(8);
#undef KFTPU_PAGED_GROUP
}

}  // namespace

// Dynamic shared memory of one block.
extern "C" size_t kftpu_paged_decode_smem_bytes(int group, int Dh, int el,
                                                int pps) {
  return smem_bytes(group, Dh, el, pps);
}

// Any q-head group (in blocks of kMaxGroup heads); Dh a multiple of 16
// bytes of the dtype, at most 256 (32 lanes x 2 slices of 16 bytes at
// f32, 32 lanes x 1 at bf16). ws_acc: B*KH*n_hb*n_splits*HB*Dh f32, ws_ml:
// B*KH*n_hb*n_splits*HB*2 f32, with n_hb = ceil(group / 8), HB =
// min(group, 8), n_splits = ceil(n_log / pps); counters: B*KH*n_hb
// uint32, zero on entry and left zero on exit. Returns cudaGetLastError()
// after the launch (0 = cudaSuccess).
extern "C" int kftpu_paged_decode_attention(
    const void* q, const void* k, const void* v, const void* pages,
    const void* positions, void* out, void* ws_acc, void* ws_ml,
    void* counters, int B, int QH, int KH, int Dh, int P, int ps, int n_log,
    int pps, float scale, int is_bf16, void* stream) {
  if (B == 0) return 0;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const int el = is_bf16 ? 2 : 4;
  if (Dh % (16 / el) || row_chunks(Dh, el) > 64)
    return static_cast<int>(cudaErrorInvalidValue);
  const int ns = row_slices(Dh, el);
  const bool masked = row_chunks(Dh, el) != ns * row_lanes(Dh, el);
#define KFTPU_PAGED_LAUNCH(T, NS, MASKED)                                  \
  return launch<T, NS, MASKED>(q, k, v, pages, positions, out, ws_acc,    \
                               ws_ml, counters, B, QH, KH, Dh, P, ps,     \
                               n_log, pps, scale, s)
  if (is_bf16) {
    if (ns != 1) return static_cast<int>(cudaErrorInvalidValue);
    if (masked) KFTPU_PAGED_LAUNCH(__nv_bfloat16, 1, true);
    KFTPU_PAGED_LAUNCH(__nv_bfloat16, 1, false);
  }
  if (ns == 2) {
    if (masked) KFTPU_PAGED_LAUNCH(float, 2, true);
    KFTPU_PAGED_LAUNCH(float, 2, false);
  }
  if (masked) KFTPU_PAGED_LAUNCH(float, 1, true);
  KFTPU_PAGED_LAUNCH(float, 1, false);
#undef KFTPU_PAGED_LAUNCH
}
