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
// Two routes, chosen from dtype, Dh and the GQA group alone:
// paged_decode_tma_kernel (bf16, Dh = 64, a group of at most 8 q heads:
// the serving LMs) and paged_decode_kernel (f32, other head dims, larger
// groups). Neither falls back to the other.
//
// paged_decode_tma_kernel, what it does about that bound:
// - Work sized to the live pages, with no host sync: a persistent grid
//   (the blocks the SMs hold: two an SM at groups of 1-2, else one)
//   walks a list of units (row, kv head, range of the row's mapped live
//   pages) that each block computes from positions and the page table.
//   Rows of at most kWholeKeys keys that busy the card as they are, or
//   rows none of which passes 1.5x a block's share, are one unit each
//   and write out directly; other rows are cut into ranges of
//   split_tokens keys (the tile table's knob), or of a block's share of
//   the page loads where that is more, folded in split order by the
//   range that finishes last. The units, heaviest first, are dealt to the
//   blocks in rounds, every other round from the last block back. At the
//   serving shape (B 8, 16 kv heads, 4-6 pages of 64) that is 128 units
//   and no fold; a dead or sentinel page issues no load.
// - TMA page loads from a producer warp: one 3-D box of K and one of V
//   (64 values x up to 64 rows, 128-byte swizzle) a page piece, into a
//   4-stage ring (16 KB a stage) guarded by full/empty mbarriers: the
//   loads cost the consumers no instructions and run on across unit
//   boundaries. The maps are prefetched while the list is built, and the
//   page table is kept in shared memory where it fits, so the first box
//   waits for one memory trip after the list.
// - Eight consumer warps read the swizzled rows: 8 lanes a key row (16
//   bytes each), the dot in f32 finished by shuffles, each lane group's
//   online softmax over its keys (2 of a stage's 64), folded at the
//   unit's end. At a group of 8 or fewer the dots are ~1 flop a byte, so
//   the FMA units keep up.
// - Not yet: tensor-core dots for groups past 8 q heads (they take
//   paged_decode_kernel, a block of 8 a kv head re-reading its pages).
//
// paged_decode_kernel, the design before it, kept for the other shapes:
// - The TPU kernel walks (row, page) on a sequential grid and carries
//   m/l/acc in VMEM scratch from one grid step to the next. Hopper blocks
//   run in no order, so the page walk is split (split-KV, as in flash
//   decoding): grid (B, KH, n_splits), each block takes `pps` consecutive
//   logical pages of one row and one KV head (split_tokens keys, from the
//   tile table; scripts/port_paged_sweep.py). Splits past the causal
//   frontier exit at once.
// - One pass over HBM: the block stages its split's page ids in shared
//   memory, then issues cp.async copies (16 bytes each) of the K AND V
//   rows of its keys up to pos into a 2-stage ring (8 KB of K and 8 KB
//   of V a stage: 64 keys at bf16, Dh = 64), both stages before it waits
//   on either; a longer split streams through the ring, each stage
//   refilled as soon as it is consumed. Keys on sentinel pages are never
//   staged.
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
//   half the keys a stage, so the ring stays within 32 KB.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <string.h>

#include "hopper.cuh"

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
    int n_log, int pps, int n_splits, int n_hb, int lpt, float scale,
    long long tok_stride) {
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
                 float scale, long long tok_stride) {
  paged_decode_kernel<T, G, NS, kMasked><<<grid, kThreads, smem, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int*>(pages),
      static_cast<const int*>(positions), static_cast<T*>(out),
      static_cast<float*>(ws_acc), static_cast<float*>(ws_ml),
      static_cast<unsigned*>(counters), QH, KH, Dh, P, ps, n_log, pps,
      n_splits, n_hb, lpt, scale, tok_stride);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int NS, bool kMasked>
int launch(const void* q, const void* k, const void* v, const void* pages,
           const void* positions, void* out, void* ws_acc, void* ws_ml,
           void* counters, int B, int QH, int KH, int Dh, int P, int ps,
           int n_log, int pps, float scale, long long tok_stride,
           cudaStream_t s) {
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
      counters, QH, KH, Dh, P, ps, n_log, pps, n_splits, n_hb, lpt, scale, \
      tok_stride)
  if (heads <= 1) KFTPU_PAGED_GROUP(1);
  if (heads <= 2) KFTPU_PAGED_GROUP(2);
  if (heads <= 4) KFTPU_PAGED_GROUP(4);
  KFTPU_PAGED_GROUP(8);
#undef KFTPU_PAGED_GROUP
}

// ---------------------------------------------------------------------------
// bf16, Dh = 64, a GQA group of at most 8: paged_decode_tma_kernel
// ---------------------------------------------------------------------------

namespace tma {

constexpr int kDh = hopper::kSw;             // a key row: 128 bytes
constexpr int kConsumerWarps = 8;
constexpr int kConsumers = 32 * kConsumerWarps;
constexpr int kThreads = kConsumers + 32;    // and the producer warp
constexpr int kStages = 4;
constexpr int kRows = 64;                    // key rows a stage holds
constexpr int kTile = kRows * kDh * 2;       // K (or V) of a stage, bytes
constexpr int kLanes = kDh * 2 / 16;         // lanes a key row, 16 B each
constexpr int kSlots = kConsumers / kLanes;  // lane groups
constexpr int kKK = kRows / kSlots;          // keys a lane group a stage
constexpr int kMaxRows = 1024;               // batch rows the list holds
// page ids kept in shared memory for the producer, where B * n_log fits
constexpr int kPageCache = 2048;
// rows of at most this many keys are one unit each (no fold) where they
// are enough units to busy 3/4 of the SMs
constexpr int kWholeKeys = 512;
constexpr int kRedStride = kDh + 2;          // acc, m, l of a warp's head
constexpr int kConsumerBar = 1;              // named barrier, consumers
// whole, span, full chunks, remainder chunks, the fold's ticket
constexpr int kMisc = 5;

constexpr size_t kRingBytes = (size_t)kStages * 2 * kTile;
constexpr size_t kRedBytes =
    (size_t)kConsumerWarps * kMaxGroup * kRedStride * sizeof(float);
constexpr size_t kMetaBytes = (size_t)kStages * sizeof(int4);
constexpr size_t kBarBytes = (size_t)kStages * 2 * 8;
constexpr size_t kListBytes =
    (size_t)(5 * kMaxRows + 1 + kMisc + kPageCache) * 4;
// 1024: the slack to the ring's 1024-byte boundary (the swizzle period)
constexpr size_t kSmem =
    1024 + kRingBytes + kRedBytes + kMetaBytes + kBarBytes + kListBytes;
static_assert(kKK * kSlots == kRows, "a stage's keys split evenly");
// two blocks an SM (a block's own 1 KB reserved each) where the
// registers allow it: G <= 2
static_assert(2 * (kSmem + 1024) <= 233472, "two blocks an SM");

__device__ __forceinline__ int warp_sum(int x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(kFull, x, o);
  return x;
}
__device__ __forceinline__ int warp_max(int x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = max(x, __shfl_xor_sync(kFull, x, o));
  return x;
}
__device__ __forceinline__ int warp_inclusive_scan(int x) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(kFull, x, o);
    if (lane >= o) x += y;
  }
  return x;
}

}  // namespace tma

bool tma_route(int group, int Dh, int el) {
  return el == 2 && Dh == tma::kDh && group <= kMaxGroup;
}

// Persistent blocks walk a work list of units: (row b, kv head kh, split
// sp), each a range of the row's mapped live pages (below its causal
// frontier, with an id inside the pool; in page-table order). Every
// block computes the list from positions and the page table, so the
// host reads neither:
// - n_b, row b's mapped live pages. `whole`: every row is one unit, when
//   no row passes kWholeKeys keys and the rows x kv heads busy 3/4 of
//   the `sms` SMs, or the longest row is within 1.5x a block's share of
//   all the page loads; otherwise a row is cut into chunks of `span`
//   pages and a remainder: pps (the tile table's split_tokens), or a
//   block's share of the loads where that is larger (each unit ends in a
//   fold step: fewer, longer units a block);
// - chunk order, heaviest first: the full chunks by (row, split), then
//   the remainders (with `whole`, the rows) by size, most first, ties by
//   row; unit u is chunk u / KH at kv head u % KH; round r deals units
//   r * gridDim.x .. to the blocks, odd rounds from the last block back.
// The producer warp reads each unit's page ids; its lane 0 issues, for
// each piece of at most kRows rows of each page up to the position, one
// TMA box of K and one of V into a stage of the ring, with the piece's
// first key, its live rows and whether it ends the unit (meta). The maps
// span the pool as (Dh, KH, P * ps) with the pool's token stride, so a
// slice of the pool's kv heads is read in place. The consumer warps read
// the swizzled rows in lane groups of 8 lanes (16 bytes each), each group
// keeping its online softmax over the keys it takes, as
// paged_decode_kernel's groups do, folded at the unit's end. A row's only
// unit writes out; a split row's units write partials, and the last to
// finish folds them in split order and resets the row's counter.
template <int G>
__global__ void __launch_bounds__(tma::kThreads, G <= 2 ? 2 : 1)
    paged_decode_tma_kernel(
    const __grid_constant__ CUtensorMap map_k,
    const __grid_constant__ CUtensorMap map_v,
    const __nv_bfloat16* __restrict__ q, const int* __restrict__ pages,
    const int* __restrict__ positions, __nv_bfloat16* __restrict__ out,
    float* __restrict__ ws_acc, float* __restrict__ ws_ml,
    unsigned* __restrict__ counters, int B, int QH, int KH, int P, int ps,
    int n_log, int pps, int n_splits, int sms, float scale) {
  using namespace tma;
  using bf16 = __nv_bfloat16;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t ring = hopper::ring_base(smem_raw);
  unsigned char* gring = smem_raw + (ring - hopper::smem_u32(smem_raw));
  float* red = reinterpret_cast<float*>(gring + kRingBytes);
  int4* meta = reinterpret_cast<int4*>(gring + kRingBytes + kRedBytes);
  const uint32_t bars = ring + kRingBytes + kRedBytes + kMetaBytes;
  int* s_pos = reinterpret_cast<int*>(gring + kRingBytes + kRedBytes +
                                      kMetaBytes + kBarBytes);
  int* s_n = s_pos + kMaxRows;      // mapped live pages of each row
  int* s_F = s_n + kMaxRows;        // full chunks before each row (B + 1)
  int* s_rem = s_F + kMaxRows + 1;  // rows by remainder, most first
  int* s_r = s_rem + kMaxRows;      // each row's remainder chunk
  int* s_misc = s_r + kMaxRows;
  int* s_pg = s_misc + kMisc;       // the page table, where it fits
  const bool cached = (long long)B * n_log <= kPageCache;
  auto full = [&](int s) { return bars + 8 * s; };
  auto empty = [&](int s) { return bars + 8 * (kStages + s); };

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int group = QH / KH;
  if (tid == kConsumers) {  // the producer's maps, read during the list
    hopper::prefetch_tensormap(&map_k);
    hopper::prefetch_tensormap(&map_v);
  }
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      hopper::mbar_init(full(s), 1);
      hopper::mbar_init(empty(s), kConsumerWarps);
    }
    hopper::mbar_fence_init();
  }

  // -- the work list --------------------------------------------------------
  // each row's position and mapped live pages, a warp a row (the first 32
  // page ids are read beside the position)
  for (int b = warp; b < B; b += tma::kThreads / 32) {
    const int* prow = pages + (size_t)b * n_log;
    const int pos = positions[b];
    int page = lane < n_log ? prow[lane] : -1;
    const int nl = live_pages(pos, ps, n_log);
    int cnt = 0;
    for (int j0 = 0; j0 < nl; j0 += 32) {
      if (j0 > 0) page = j0 + lane < nl ? prow[j0 + lane] : -1;
      if (cached && j0 + lane < nl) s_pg[b * n_log + j0 + lane] = page;
      cnt += __popc(__ballot_sync(
          kFull, j0 + lane < nl && page >= 0 && page < P));
    }
    if (lane == 0) {
      s_pos[b] = pos;
      s_n[b] = cnt;
    }
  }
  __syncthreads();
  if (warp == 0) {
    int total = 0, longest = 0, rows = 0;
    for (int b0 = 0; b0 < B; b0 += 32) {
      const int n = b0 + lane < B ? s_n[b0 + lane] : 0;
      total += warp_sum(n);
      longest = max(longest, warp_max(n));
      rows += __popc(__ballot_sync(kFull, n > 0));
    }
    const long long loads = (long long)total * KH;  // page loads, all
    const int whole =
        (longest * ps <= kWholeKeys && 4 * rows * KH >= 3 * sms) ||
        2LL * longest * gridDim.x <= 3LL * loads;
    // a split: pps pages, or a block's share of the loads where larger
    const int span = max(pps, (int)((loads + gridDim.x - 1) / gridDim.x));
    int carry = 0, n_rem = 0;
    for (int b0 = 0; b0 < B; b0 += 32) {
      const int b = b0 + lane;
      const int n = b < B ? s_n[b] : 0;
      const int f = whole ? 0 : n / span;
      const int r = n - f * span;  // the remainder chunk's pages
      const int incl = warp_inclusive_scan(f);
      if (b < B) {
        s_F[b] = carry + incl - f;
        s_r[b] = r;
      }
      carry += __shfl_sync(kFull, incl, 31);
      n_rem += __popc(__ballot_sync(kFull, r > 0));
      if (B <= 32) {  // the remainders' order, in registers
        int rank = 0;
        for (int o = 0; o < 32; ++o) {
          const int ro = __shfl_sync(kFull, r, o);
          rank += ro > r || (ro == r && o < lane);
        }
        if (r > 0) s_rem[rank] = b;
      }
    }
    if (lane == 0) {
      s_F[B] = carry;
      s_misc[0] = whole;
      s_misc[1] = span;
      s_misc[2] = carry;
      s_misc[3] = n_rem;
    }
  }
  __syncthreads();
  const int whole = s_misc[0], span = s_misc[1], n_full = s_misc[2];
  const int n_units = (n_full + s_misc[3]) * KH;
  if (B > 32) {  // the remainders' order, by the block
    for (int b = tid; b < B; b += tma::kThreads) {
      const int r = s_r[b];
      if (r > 0) {
        int rank = 0;
        for (int o = 0; o < B; ++o) {
          const int ro = s_r[o];
          rank += ro > r || (ro == r && o < b);
        }
        s_rem[rank] = b;
      }
    }
    __syncthreads();
  }
  // unit u: row b, kv head kh, split sp of the row's nsp; its mapped live
  // pages [i0, i1) in the row's order
  auto decode = [&](int u, int& b, int& kh, int& sp, int& i0, int& i1,
                    int& nsp) {
    const int c = u / KH;
    kh = u - c * KH;
    if (c < n_full) {  // the last row with s_F[b] <= c
      int lo = 0, hi = B - 1;
      while (lo < hi) {
        const int mid = (lo + hi + 1) >> 1;
        if (s_F[mid] <= c) {
          lo = mid;
        } else {
          hi = mid - 1;
        }
      }
      b = lo;
      sp = c - s_F[b];
      i0 = sp * span;
      i1 = i0 + span;
    } else {
      b = s_rem[c - n_full];
      sp = whole ? 0 : s_n[b] / span;
      i0 = sp * span;
      i1 = s_n[b];
    }
    nsp = whole ? 1 : (s_n[b] + span - 1) / span;
  };

  // this block's unit of each round: the units, heaviest first, dealt
  // to the blocks in turn, every other round from the last block back
  // (the blocks with the heaviest units of one round take the lightest
  // of the next)
  auto deal = [&](int round) {
    const int x = round & 1 ? gridDim.x - 1 - blockIdx.x : blockIdx.x;
    return round * (int)gridDim.x + x;
  };
  const int bx = ps < kRows ? ps : kRows;  // rows a box (and a stage)
  if (warp == kConsumerWarps) {
    // ---- producer ----
    int it = 0;
    for (int round = 0; round * (int)gridDim.x < n_units; ++round) {
      const int u = deal(round);
      if (u >= n_units) continue;
      int b, kh, sp, i0, i1, nsp;
      decode(u, b, kh, sp, i0, i1, nsp);
      const int pos = s_pos[b];
      const int nl = live_pages(pos, ps, n_log);
      const int* prow = cached ? s_pg + b * n_log : pages + (size_t)b * n_log;
      int seen = 0;  // mapped pages before this chunk of ids
      for (int j0 = 0; j0 < nl && seen < i1; j0 += 32) {
        const int page = j0 + lane < nl ? prow[j0 + lane] : -1;
        const bool mapped = page >= 0 && page < P;
        const unsigned m = __ballot_sync(kFull, mapped);
        const int idx = seen + __popc(m & ((1u << lane) - 1u));
        unsigned sel =
            __ballot_sync(kFull, mapped && idx >= i0 && idx < i1);
        while (sel) {  // warp-uniform
          const int src = __ffs(sel) - 1;
          sel &= sel - 1;
          const int pg = __shfl_sync(kFull, page, src);
          const bool last_page = __shfl_sync(kFull, idx, src) == i1 - 1;
          const int key_page = (j0 + src) * ps;
          for (int t = 0; t < ps && key_page + t <= pos; t += bx) {
            const int key0 = key_page + t;
            if (lane == 0) {
              const int s = it % kStages;
              hopper::mbar_wait(empty(s), ((it / kStages) & 1) ^ 1);
              meta[s] = make_int4(
                  key0, min(min(bx, ps - t), pos + 1 - key0),
                  last_page && (t + bx >= ps || key0 + bx > pos), 0);
              hopper::mbar_expect_tx(full(s), 2u * bx * kDh * 2);
              const uint32_t dst = ring + s * 2 * kTile;
              hopper::tma_load_3d(dst, &map_k, full(s), 0, kh, pg * ps + t);
              hopper::tma_load_3d(dst + kTile, &map_v, full(s), 0, kh,
                                  pg * ps + t);
            }
            ++it;
          }
        }
        seen += __popc(m);
      }
    }
    return;
  }

  // ---- consumers ----
  const int sub = lane & (kLanes - 1);  // this lane's chunk of a row
  const int slot = tid / kLanes;        // this lane's group
  // rows with no mapped live page: zeros
  for (int b = blockIdx.x; b < B; b += gridDim.x)
    if (s_n[b] == 0)
      for (int i = tid; i < QH * kDh; i += kConsumers)
        out[(size_t)b * QH * kDh + i] = from_f32<bf16>(0.f);
  int it = 0;
  for (int round = 0; round * (int)gridDim.x < n_units; ++round) {
    const int u = deal(round);
    if (u >= n_units) continue;
    int b, kh, sp, i0, i1, nsp;
    decode(u, b, kh, sp, i0, i1, nsp);
    const size_t head0 = (size_t)b * QH + (size_t)kh * group;
    // this lane's chunk of each q head, kept as bf16 pairs (q is bf16:
    // nothing is lost, and a group of 8 fits the registers)
    uint32_t qp[G][4];
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const uint4 v = g < group ? *reinterpret_cast<const uint4*>(
                                      q + (head0 + g) * kDh + sub * 8)
                                : make_uint4(0u, 0u, 0u, 0u);
      qp[g][0] = v.x;
      qp[g][1] = v.y;
      qp[g][2] = v.z;
      qp[g][3] = v.w;
    }
    float m[G], l[G], acc[G][8];
#pragma unroll
    for (int g = 0; g < G; ++g) {
      m[g] = kNegInf;
      l[g] = 0.f;
#pragma unroll
      for (int i = 0; i < 8; ++i) acc[g][i] = 0.f;
    }
    bool last = false;
    while (!last) {
      const int s = it % kStages;
      hopper::mbar_wait(full(s), (it / kStages) & 1);
      const int4 mt = meta[s];
      const unsigned char* kt = gring + s * 2 * kTile;
      const unsigned char* vt = kt + kTile;
      last = mt.z != 0;
      ++it;
      // this lane group's keys r = slot + k * kSlots, one at a time
#pragma unroll
      for (int k = 0; k < kKK; ++k) {
        const int r = slot + k * kSlots;
        const bool live = r < mt.y;
        float x[8], sc[G];
        if (live)
          Vec<bf16>::load(
              reinterpret_cast<const bf16*>(kt + hopper::sw128(r, sub)), x);
#pragma unroll
        for (int g = 0; g < G; ++g) {
          sc[g] = 0.f;
          if (live) {
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              sc[g] += __uint_as_float(qp[g][j] << 16) * x[2 * j];
              sc[g] += __uint_as_float(qp[g][j] & 0xffff0000u) * x[2 * j + 1];
            }
          }
        }
#pragma unroll
        for (int o = kLanes >> 1; o > 0; o >>= 1)
#pragma unroll
          for (int g = 0; g < G; ++g)
            sc[g] += __shfl_xor_sync(kFull, sc[g], o);
        if (live)
          Vec<bf16>::load(
              reinterpret_cast<const bf16*>(vt + hopper::sw128(r, sub)), x);
        if (k == kKK - 1) {
          __syncwarp();  // the stage is read: release it
          if (lane == 0) hopper::mbar_arrive(empty(s));
        }
        if (!live) continue;
        // online softmax step; P rounded to bf16 before P.V at the
        // running max, l sums the unrounded values
#pragma unroll
        for (int g = 0; g < G; ++g) {
          const float sg = sc[g] * scale;
          const float mx = fmaxf(m[g], sg);
          const float alpha = expf(m[g] - mx);  // m starts finite: no nan
          const float p = expf(sg - mx);
          m[g] = mx;
          l[g] = l[g] * alpha + p;
          const float pr = to_f32(from_f32<bf16>(p));
#pragma unroll
          for (int i = 0; i < 8; ++i)
            acc[g][i] = acc[g][i] * alpha + pr * x[i];
        }
      }
    }

    // fold the lane groups: within the warp (the lanes of one chunk),
    // then across the consumer warps in shared memory, in one order
#pragma unroll
    for (int o = kLanes; o < 32; o <<= 1) {
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const float mb = __shfl_xor_sync(kFull, m[g], o);
        const float lb = __shfl_xor_sync(kFull, l[g], o);
        const float mm = fmaxf(m[g], mb);
        const float wa = expf(m[g] - mm), wb = expf(mb - mm);
        l[g] = l[g] * wa + lb * wb;
        m[g] = mm;
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const float ab = __shfl_xor_sync(kFull, acc[g][i], o);
          acc[g][i] = acc[g][i] * wa + ab * wb;
        }
      }
    }
    hopper::bar_sync(kConsumerBar, kConsumers);  // the last unit's reads
    if (lane < kLanes) {
#pragma unroll
      for (int g = 0; g < G; ++g) {
        if (g < group) {
          float* rg = red + (warp * group + g) * kRedStride;
#pragma unroll
          for (int i = 0; i < 8; ++i) rg[sub * 8 + i] = acc[g][i];
          if (sub == 0) {
            rg[kDh] = m[g];
            rg[kDh + 1] = l[g];
          }
        }
      }
    }
    hopper::bar_sync(kConsumerBar, kConsumers);
    const size_t ub = (size_t)b * KH + kh;  // (row, kv head)
    const size_t ws = (ub * n_splits + sp) * group;
    bf16* ob = out + head0 * kDh;
    for (int i = tid; i < group * kDh; i += kConsumers) {
      const int g = i / kDh, d = i - g * kDh;
      float mm = kNegInf;
#pragma unroll
      for (int w = 0; w < kConsumerWarps; ++w)
        mm = fmaxf(mm, red[(w * group + g) * kRedStride + kDh]);
      float a = 0.f, ls = 0.f;
#pragma unroll
      for (int w = 0; w < kConsumerWarps; ++w) {
        const float* rg = red + (w * group + g) * kRedStride;
        const float wt = expf(rg[kDh] - mm);
        a += rg[d] * wt;
        ls += rg[kDh + 1] * wt;
      }
      if (nsp == 1) {
        ob[i] = from_f32<bf16>(a / fmaxf(ls, 1e-30f));
      } else {
        ws_acc[ws * kDh + i] = a;
        if (d == 0) {
          ws_ml[(ws + g) * 2] = mm;
          ws_ml[(ws + g) * 2 + 1] = ls;
        }
      }
    }
    if (nsp == 1) continue;

    // -- the fold: the last split of (row, kv head) to finish ---------------
    __threadfence();  // this thread's partials reach L2 before the ticket
    hopper::bar_sync(kConsumerBar, kConsumers);
    if (tid == 0)
      s_misc[4] = atomicAdd(counters + ub, 1u) == (unsigned)(nsp - 1);
    hopper::bar_sync(kConsumerBar, kConsumers);
    if (!s_misc[4]) continue;
    __threadfence();
    const size_t base = ub * n_splits;
    for (int i = tid; i < group * kDh; i += kConsumers) {
      const int g = i / kDh, d = i - g * kDh;
      float mm = kNegInf;
      for (int s = 0; s < nsp; ++s)
        mm = fmaxf(mm, __ldcg(ws_ml + ((base + s) * group + g) * 2));
      float ls = 0.f, a = 0.f;
      for (int s = 0; s < nsp; ++s) {  // in split order
        const size_t j = (base + s) * group + g;
        const float wt = expf(__ldcg(ws_ml + j * 2) - mm);
        ls += __ldcg(ws_ml + j * 2 + 1) * wt;
        a += __ldcg(ws_acc + j * kDh + d) * wt;
      }
      ob[i] = from_f32<bf16>(a / fmaxf(ls, 1e-30f));
    }
    if (tid == 0) counters[ub] = 0u;  // ready for the next call
  }
}

// The grid: the blocks resident on `sms` SMs (two an SM where G <= 2),
// at most one a unit there can be.
template <int G>
int launch_tma(const CUtensorMap& mk, const CUtensorMap& mv, const void* q,
               const void* pages, const void* positions, void* out,
               void* ws_acc, void* ws_ml, void* counters, int B, int QH,
               int KH, int P, int ps, int n_log, int pps, int sms,
               float scale, cudaStream_t s) {
  cudaError_t err = cudaFuncSetAttribute(  // the opt-in
      paged_decode_tma_kernel<G>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)tma::kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  static int per_sm = 0;  // blocks an SM holds, asked once
  if (per_sm == 0) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, paged_decode_tma_kernel<G>, tma::kThreads, tma::kSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  }
  const int n_splits = (n_log + pps - 1) / pps;
  const long long units = (long long)B * KH * n_splits;
  const int grid = (int)(units < (long long)sms * per_sm ? units
                                                         : sms * per_sm);
  paged_decode_tma_kernel<G><<<grid, tma::kThreads, tma::kSmem, s>>>(
      mk, mv, static_cast<const __nv_bfloat16*>(q),
      static_cast<const int*>(pages), static_cast<const int*>(positions),
      static_cast<__nv_bfloat16*>(out), static_cast<float*>(ws_acc),
      static_cast<float*>(ws_ml), static_cast<unsigned*>(counters), B, QH,
      KH, P, ps, n_log, pps, n_splits, sms, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Dynamic shared memory of one block of the route that runs at (group,
// Dh, el): the TMA kernel's fixed layout (past 48 KB: the launch opts in),
// else paged_decode_kernel's at pps pages a split.
extern "C" size_t kftpu_paged_decode_smem_bytes(int group, int Dh, int el,
                                                int pps) {
  if (tma_route(group, Dh, el)) return tma::kSmem;
  return smem_bytes(group, Dh, el, pps);
}

// The TMA route's two tensor maps, K then V (2 x sizeof(CUtensorMap) =
// 256 bytes at `maps`): a pool (P, ps, KH, 64) bf16, or a slice of its kv
// heads, as (64, KH, P * ps) with heads 128 bytes apart and key rows
// tok_stride elements apart; boxes of 64 x 1 x min(ps, 64), no L2
// promotion (on an H100, 1.5-4% faster than 256 bytes at the chip
// smoke's phase-2 and phase-23 rows, scripts/port_paged_sweep.py).
// Returns 0, or cudaErrorInvalidValue where a map cannot be encoded.
extern "C" int kftpu_paged_tma_maps(void* maps, const void* k, const void* v,
                                    int P, int ps, int KH,
                                    long long tok_stride) {
  const cuuint64_t dims[3] = {(cuuint64_t)tma::kDh, (cuuint64_t)KH,
                              (cuuint64_t)P * (cuuint64_t)ps};
  const cuuint64_t strides[2] = {(cuuint64_t)tma::kDh * 2,
                                 (cuuint64_t)tok_stride * 2};
  const cuuint32_t box[3] = {(cuuint32_t)tma::kDh, 1,
                             (cuuint32_t)(ps < tma::kRows ? ps : tma::kRows)};
  CUtensorMap m[2];
  const CUtensorMapL2promotion none = CU_TENSOR_MAP_L2_PROMOTION_NONE;
  if (!hopper::encode_bf16(&m[0], k, 3, dims, strides, box, none) ||
      !hopper::encode_bf16(&m[1], v, 3, dims, strides, box, none))
    return static_cast<int>(cudaErrorInvalidValue);
  memcpy(maps, m, sizeof m);
  return 0;
}

// bf16, Dh = 64, QH / KH <= 8: paged_decode_tma_kernel on the blocks
// `sms` SMs hold (at most B * KH * ceil(n_log / pps)), with the maps of
// kftpu_paged_tma_maps; B at most 1024. The workspace and counters are
// kftpu_paged_decode_attention's. Returns cudaGetLastError() after the
// launch (0 = cudaSuccess).
extern "C" int kftpu_paged_decode_tma(
    const void* maps, const void* q, const void* pages,
    const void* positions, void* out, void* ws_acc, void* ws_ml,
    void* counters, int B, int QH, int KH, int P, int ps, int n_log,
    int pps, int sms, float scale, void* stream) {
  if (B == 0) return 0;
  const int group = QH / KH;
  if (B > tma::kMaxRows || group > kMaxGroup || sms < 1 || pps < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap m[2];
  memcpy(m, maps, sizeof m);
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
#define KFTPU_PAGED_TMA(G)                                                 \
  return launch_tma<G>(m[0], m[1], q, pages, positions, out, ws_acc, ws_ml, \
                       counters, B, QH, KH, P, ps, n_log, pps, sms, scale, \
                       s)
  if (group <= 1) KFTPU_PAGED_TMA(1);
  if (group <= 2) KFTPU_PAGED_TMA(2);
  if (group <= 4) KFTPU_PAGED_TMA(4);
  KFTPU_PAGED_TMA(8);
#undef KFTPU_PAGED_TMA
}


// paged_decode_kernel: every shape but the TMA route's (bf16, Dh = 64,
// a group of at most 8 q heads), which it refuses. Any q-head group (in
// blocks of kMaxGroup heads); Dh a multiple of 16 bytes of the dtype, at
// most 256 (32 lanes x 2 slices of 16 bytes at
// f32, 32 lanes x 1 at bf16). ws_acc: B*KH*n_hb*n_splits*HB*Dh f32, ws_ml:
// B*KH*n_hb*n_splits*HB*2 f32, with n_hb = ceil(group / 8), HB =
// min(group, 8), n_splits = ceil(n_log / pps); counters: B*KH*n_hb
// uint32, zero on entry and left zero on exit. tok_stride: elements from
// one key row of the pool to the next (KH * Dh for a whole pool; a slice
// of a pool's kv heads keeps its pool's, and k/v point at its first head).
// Returns cudaGetLastError() after the launch (0 = cudaSuccess).
extern "C" int kftpu_paged_decode_attention(
    const void* q, const void* k, const void* v, const void* pages,
    const void* positions, void* out, void* ws_acc, void* ws_ml,
    void* counters, int B, int QH, int KH, int Dh, int P, int ps, int n_log,
    int pps, float scale, int is_bf16, long long tok_stride, void* stream) {
  if (B == 0) return 0;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const int el = is_bf16 ? 2 : 4;
  if (Dh % (16 / el) || row_chunks(Dh, el) > 64 ||
      tma_route(QH / KH, Dh, el))
    return static_cast<int>(cudaErrorInvalidValue);
  const int ns = row_slices(Dh, el);
  const bool masked = row_chunks(Dh, el) != ns * row_lanes(Dh, el);
#define KFTPU_PAGED_LAUNCH(T, NS, MASKED)                                  \
  return launch<T, NS, MASKED>(q, k, v, pages, positions, out, ws_acc,    \
                               ws_ml, counters, B, QH, KH, Dh, P, ps,     \
                               n_log, pps, scale, tok_stride, s)
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
