// Flash attention for Hopper (sm_90a): forward, dQ and dK/dV kernels,
// plain C interface.
//
// Replaces: kubeflow_tpu/ops/attention.py
// - flash_fwd_kernel      <- _flash_fwd_kernel (Pallas body :188,
//                            pallas_call :345, wrapper _flash_fwd :306);
// - flash_bwd_dq_kernel   <- _flash_bwd_dq_kernel (:369, call :530);
// - flash_bwd_dkv_kernel  <- _flash_bwd_dkv_kernel (:422, call :560).
// They compute what the Pallas kernels compute: scores from q pre-scaled
// in f32, the finite NEG_INF = -1e30 for masked scores (a row whose keys
// are all masked averages V uniformly, with no inf - inf), an online
// softmax whose l is clamped at 1e-30 and whose lse = m + log(l) is
// saved; the forward rounds P to the V dtype before P.V; the backward
// recomputes P = exp(s - lse), keeps dS = P * (dO.V^T - delta) in f32,
// scales dQ at the end and takes dK from the pre-scaled q.
//
// What bounds them on H100: operations. Per (q row, key) pair the forward
// does 4*D flops, dQ 6*D and dK/dV 8*D, against 2-4 bytes read per D
// values of a whole tile that is reused 64 times: at S = 8192 the
// intensity is thousands of flops per byte, far above the card's ~295
// flop/byte ridge. The floor is the causal flops over the tensor-core
// rate; these kernels run on the f32 FMA units (67 TFLOP/s), so their
// own ceiling is that rate.
//
// Design, and what it does about that bound:
// - Pallas carries acc/m/l across a SEQUENTIAL kv grid axis; Hopper
//   blocks run in no order. So the forward and dQ use one block per
//   (q tile, batch*head) that loops over the kv tiles inside the block,
//   and dK/dV one block per (kv tile, batch*head) that loops over the q
//   tiles from the first live one. Each output is owned by one block:
//   no atomics, deterministic sums.
// - Causal loop limits are the reference's _last_live_kv (:152) and
//   _first_live_q (:160); the per-position masks are its
//   _causal_block_mask and _pad_mask (:167, :177). All three kernels use
//   the same expressions, so the backward's P is the forward's. A batch
//   row with kv_len == 0 has every key masked: its loops cover every
//   tile, so it averages over all S keys, as reference_attention does.
// - Tiles of 64 x 64: the block's 256 threads each own a 4 x 4 score
//   micro-tile (rows ty*4+r, keys tx+16c) and a 4 x D/16 slice of the
//   output, so every shared-memory value a thread loads feeds 4 FMAs.
//   Tiles are staged in shared memory as f32 rows padded to D+1 floats,
//   so reading one column across 16 lanes hits 16 banks.
// - The causal forward and dQ grids put batch*head on x and walk q tiles
//   from the last (most kv tiles) to the first, so the longest blocks
//   start first and the short ones fill the tail.
// - Inputs are read through their (B, S, H, D) strides (no head-fusing
//   transpose); the ragged edge is masked, so any S works: keys past S
//   are zero in shared memory and get P = 0, q rows past S are never
//   stored and give P = 0 in dK/dV.
// - Not yet: tensor-core dots (wgmma / mma.sync), TMA or cp.async
//   staging, in-kernel GQA.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kBQ = 64;         // q rows per tile
constexpr int kBK = 64;         // keys per tile (BLOCK_K of the plain forward)
constexpr int kThreads = 256;   // 16 x 16: ty = tid / 16, tx = tid % 16
constexpr int kPT = kBK + 1;    // padded row of a score tile
constexpr unsigned kFull = 0xffffffffu;

static_assert(kBQ == 64 && kBK == 64, "the 4 x 4 micro-tiles assume 64");

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

// Element strides of a (B, S, H, D) tensor; the head dim is contiguous.
struct Layout {
  long long b, s, h;
};

__device__ __forceinline__ long long row_base(const Layout& L, int b, int h) {
  return (long long)b * L.b + (long long)h * L.h;
}

// The reference's loop limits (attention.py :152 and :160).
__device__ __forceinline__ int last_live_kv(int i) {
  return (i * kBQ + kBQ - 1) / kBK;
}
__device__ __forceinline__ int first_live_q(int j) { return (j * kBK) / kBQ; }

// The reference's masks (attention.py :167 and :177): NEG_INF, not -inf.
__device__ __forceinline__ float mask_score(float s, int qpos, int kpos,
                                            int limit, int causal) {
  if (causal && kpos > qpos) s = kNegInf;
  if (kpos >= limit) s = kNegInf;
  return s;
}

// Max and sum over the 16 lanes (tx) that share one row.
__device__ __forceinline__ float row_max(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(kFull, x, o));
  return x;
}
__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(kFull, x, o);
  return x;
}

// Stage n_rows rows of a (B, S, H, D) tensor, from sequence position s0,
// as f32 * mul into dst (row stride ld); rows past S are zero.
template <typename T, int D>
__device__ __forceinline__ void stage(float* dst, int ld, const T* base,
                                      long long s_stride, int s0, int S,
                                      int n_rows, float mul) {
  for (int e = threadIdx.x; e < n_rows * D; e += kThreads) {
    const int r = e / D, d = e % D, s = s0 + r;
    dst[r * ld + d] =
        s < S ? to_f32(base[(long long)s * s_stride + d]) * mul : 0.f;
  }
}

// ---------------------------------------------------------------------------
// Forward: out = softmax(q k^T * scale) v, lse per row.
// grid (B*H, n_q); shared: q (kBQ x D+1), k (kBK x D+1), v (kBK x D),
// p (kBQ x kBK+1), all f32.
// ---------------------------------------------------------------------------

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const int* __restrict__ kv_len,
                     T* __restrict__ out, float* __restrict__ lse, Layout lq,
                     Layout lk, Layout lv, int H, int S, float scale,
                     int causal) {
  constexpr int LD = D + 1;
  constexpr int C = D / 16;  // output columns per thread
  extern __shared__ float smem[];
  float* qs = smem;
  float* ks = qs + kBQ * LD;
  float* vs = ks + kBK * LD;
  float* ps = vs + kBK * D;

  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int n_q = gridDim.y;
  const int i = causal ? n_q - 1 - (int)blockIdx.y : (int)blockIdx.y;
  const int q0 = i * kBQ;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int limit = kv_len ? kv_len[b] : S;
  const int n_kv = (S + kBK - 1) / kBK;
  const int j_end =
      (causal && limit > 0) ? min(n_kv, last_live_kv(i) + 1) : n_kv;

  const T* kb = k + row_base(lk, b, h);
  const T* vb = v + row_base(lv, b, h);
  stage<T, D>(qs, LD, q + row_base(lq, b, h), lq.s, q0, S, kBQ, scale);

  float m[4], l[4], acc[4][C];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int c = 0; c < C; ++c) acc[r][c] = 0.f;
  }

  for (int j = 0; j < j_end; ++j) {
    const int k0 = j * kBK;
    __syncthreads();  // the last tile's readers are done
    stage<T, D>(ks, LD, kb, lk.s, k0, S, kBK, 1.f);
    stage<T, D>(vs, D, vb, lv.s, k0, S, kBK, 1.f);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[r][c] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float a[4], bk[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) a[r] = qs[(ty * 4 + r) * LD + d];
#pragma unroll
      for (int c = 0; c < 4; ++c) bk[c] = ks[(tx + 16 * c) * LD + d];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) s[r][c] = fmaf(a[r], bk[c], s[r][c]);
    }

#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int qpos = q0 + ty * 4 + r;
      float mx = -INFINITY;  // only keys that exist (kpos < S) count
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int kpos = k0 + tx + 16 * c;
        s[r][c] = mask_score(s[r][c], qpos, kpos, limit, causal);
        if (kpos < S) mx = fmaxf(mx, s[r][c]);
      }
      const float m_new = fmaxf(m[r], row_max(mx));
      const float alpha = expf(m[r] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int kpos = k0 + tx + 16 * c;
        const float p = kpos < S ? expf(s[r][c] - m_new) : 0.f;
        sum += p;
        // P rounded to the V dtype before P.V; l sums the f32 values
        ps[(ty * 4 + r) * kPT + tx + 16 * c] = to_f32(from_f32<T>(p));
      }
      l[r] = l[r] * alpha + row_sum(sum);
      m[r] = m_new;
#pragma unroll
      for (int c = 0; c < C; ++c) acc[r][c] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < kBK; ++kk) {
      float pr[4], vv[C];
#pragma unroll
      for (int r = 0; r < 4; ++r) pr[r] = ps[(ty * 4 + r) * kPT + kk];
#pragma unroll
      for (int c = 0; c < C; ++c) vv[c] = vs[kk * D + tx + 16 * c];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < C; ++c) acc[r][c] = fmaf(pr[r], vv[c], acc[r][c]);
    }
  }

  const long long o_row = (long long)H * D;  // out is (B, S, H, D) dense
  T* ob = out + ((long long)b * S * H + h) * D;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int qpos = q0 + ty * 4 + r;
    if (qpos >= S) continue;
    const float lc = fmaxf(l[r], 1e-30f);
#pragma unroll
    for (int c = 0; c < C; ++c)
      ob[qpos * o_row + tx + 16 * c] = from_f32<T>(acc[r][c] / lc);
    if (tx == 0) lse[(long long)bh * S + qpos] = m[r] + logf(lc);
  }
}

// ---------------------------------------------------------------------------
// dQ: dq = scale * sum_j dS_j k_j, dS = P * (dO v^T - delta).
// grid (B*H, n_q); shared: q, dO, k, v (each 64 x D+1), dS (kBQ x kBK+1).
// ---------------------------------------------------------------------------

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const T* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta,
                        const int* __restrict__ kv_len, T* __restrict__ dq,
                        Layout lq, Layout lk, Layout lv, Layout lo, int H,
                        int S, float scale, int causal) {
  constexpr int LD = D + 1;
  constexpr int C = D / 16;
  extern __shared__ float smem[];
  float* qs = smem;
  float* dos = qs + kBQ * LD;
  float* ks = dos + kBQ * LD;
  float* vs = ks + kBK * LD;
  float* dss = vs + kBK * LD;

  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int n_q = gridDim.y;
  const int i = causal ? n_q - 1 - (int)blockIdx.y : (int)blockIdx.y;
  const int q0 = i * kBQ;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int limit = kv_len ? kv_len[b] : S;
  const int n_kv = (S + kBK - 1) / kBK;
  const int j_end =
      (causal && limit > 0) ? min(n_kv, last_live_kv(i) + 1) : n_kv;

  const T* kb = k + row_base(lk, b, h);
  const T* vb = v + row_base(lv, b, h);
  stage<T, D>(qs, LD, q + row_base(lq, b, h), lq.s, q0, S, kBQ, scale);
  stage<T, D>(dos, LD, dout + row_base(lo, b, h), lo.s, q0, S, kBQ, 1.f);
  float lse_r[4], delta_r[4], acc[4][C];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int qpos = q0 + ty * 4 + r;
    const bool in = qpos < S;
    lse_r[r] = in ? lse[(long long)bh * S + qpos] : 0.f;
    delta_r[r] = in ? delta[(long long)bh * S + qpos] : 0.f;
#pragma unroll
    for (int c = 0; c < C; ++c) acc[r][c] = 0.f;
  }

  for (int j = 0; j < j_end; ++j) {
    const int k0 = j * kBK;
    __syncthreads();
    stage<T, D>(ks, LD, kb, lk.s, k0, S, kBK, 1.f);
    stage<T, D>(vs, LD, vb, lv.s, k0, S, kBK, 1.f);
    __syncthreads();

    float s[4][4], dp[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[r][c] = dp[r][c] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float a[4], g[4], bk[4], bv[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        a[r] = qs[(ty * 4 + r) * LD + d];
        g[r] = dos[(ty * 4 + r) * LD + d];
      }
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        bk[c] = ks[(tx + 16 * c) * LD + d];
        bv[c] = vs[(tx + 16 * c) * LD + d];
      }
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          s[r][c] = fmaf(a[r], bk[c], s[r][c]);
          dp[r][c] = fmaf(g[r], bv[c], dp[r][c]);
        }
    }

#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int qpos = q0 + ty * 4 + r;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int kpos = k0 + tx + 16 * c;
        const float sc = mask_score(s[r][c], qpos, kpos, limit, causal);
        const float p = kpos < S ? expf(sc - lse_r[r]) : 0.f;
        dss[(ty * 4 + r) * kPT + tx + 16 * c] = p * (dp[r][c] - delta_r[r]);
      }
    }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < kBK; ++kk) {
      float dsr[4], kv[C];
#pragma unroll
      for (int r = 0; r < 4; ++r) dsr[r] = dss[(ty * 4 + r) * kPT + kk];
#pragma unroll
      for (int c = 0; c < C; ++c) kv[c] = ks[kk * LD + tx + 16 * c];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < C; ++c) acc[r][c] = fmaf(dsr[r], kv[c], acc[r][c]);
    }
  }

  const long long o_row = (long long)H * D;
  T* gb = dq + ((long long)b * S * H + h) * D;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int qpos = q0 + ty * 4 + r;
    if (qpos >= S) continue;
#pragma unroll
    for (int c = 0; c < C; ++c)
      gb[qpos * o_row + tx + 16 * c] = from_f32<T>(acc[r][c] * scale);
  }
}

// ---------------------------------------------------------------------------
// dK/dV: dv = sum_i P_i^T dO_i, dk = sum_i dS_i^T (q_i * scale).
// grid (B*H, n_kv); this block owns kv tile j and walks the q tiles.
// Shared: k, v, q, dO (each 64 x D+1), P^T and dS^T (kBK x kBQ+1),
// lse and delta of the q tile.
// ---------------------------------------------------------------------------

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, const T* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         const int* __restrict__ kv_len, T* __restrict__ dk,
                         T* __restrict__ dv, Layout lq, Layout lk, Layout lv,
                         Layout lo, int H, int S, float scale, int causal) {
  constexpr int LD = D + 1;
  constexpr int C = D / 16;
  constexpr int kPQ = kBQ + 1;
  extern __shared__ float smem[];
  float* ks = smem;
  float* vs = ks + kBK * LD;
  float* qs = vs + kBK * LD;
  float* dos = qs + kBQ * LD;
  float* pt = dos + kBQ * LD;
  float* dst = pt + kBK * kPQ;
  float* lse_s = dst + kBK * kPQ;
  float* delta_s = lse_s + kBQ;

  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int j = blockIdx.y;
  const int k0 = j * kBK;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int limit = kv_len ? kv_len[b] : S;
  const int n_q = (S + kBQ - 1) / kBQ;
  const int i_start = (causal && limit > 0) ? first_live_q(j) : 0;

  const T* qb = q + row_base(lq, b, h);
  const T* gb = dout + row_base(lo, b, h);
  stage<T, D>(ks, LD, k + row_base(lk, b, h), lk.s, k0, S, kBK, 1.f);
  stage<T, D>(vs, LD, v + row_base(lv, b, h), lv.s, k0, S, kBK, 1.f);
  float dk_acc[4][C], dv_acc[4][C];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < C; ++c) dk_acc[r][c] = dv_acc[r][c] = 0.f;

  for (int i = i_start; i < n_q; ++i) {
    const int q0 = i * kBQ;
    __syncthreads();
    stage<T, D>(qs, LD, qb, lq.s, q0, S, kBQ, scale);
    stage<T, D>(dos, LD, gb, lo.s, q0, S, kBQ, 1.f);
    for (int e = threadIdx.x; e < kBQ; e += kThreads) {
      const int qpos = q0 + e;
      lse_s[e] = qpos < S ? lse[(long long)bh * S + qpos] : 0.f;
      delta_s[e] = qpos < S ? delta[(long long)bh * S + qpos] : 0.f;
    }
    __syncthreads();

    // transposed tiles: rows are this block's keys, columns the q rows
    float s[4][4], dp[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[r][c] = dp[r][c] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float a[4], bv[4], bq[4], bg[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        a[r] = ks[(ty * 4 + r) * LD + d];
        bv[r] = vs[(ty * 4 + r) * LD + d];
      }
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        bq[c] = qs[(tx + 16 * c) * LD + d];
        bg[c] = dos[(tx + 16 * c) * LD + d];
      }
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          s[r][c] = fmaf(a[r], bq[c], s[r][c]);
          dp[r][c] = fmaf(bv[r], bg[c], dp[r][c]);
        }
    }

#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int kpos = k0 + ty * 4 + r;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int qcol = tx + 16 * c, qpos = q0 + qcol;
        const float sc = mask_score(s[r][c], qpos, kpos, limit, causal);
        const float p = qpos < S ? expf(sc - lse_s[qcol]) : 0.f;
        pt[(ty * 4 + r) * kPQ + qcol] = p;
        dst[(ty * 4 + r) * kPQ + qcol] = p * (dp[r][c] - delta_s[qcol]);
      }
    }
    __syncthreads();

#pragma unroll 4
    for (int qq = 0; qq < kBQ; ++qq) {
      float pr[4], dr[4], g[C], qv[C];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        pr[r] = pt[(ty * 4 + r) * kPQ + qq];
        dr[r] = dst[(ty * 4 + r) * kPQ + qq];
      }
#pragma unroll
      for (int c = 0; c < C; ++c) {
        g[c] = dos[qq * LD + tx + 16 * c];
        qv[c] = qs[qq * LD + tx + 16 * c];
      }
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < C; ++c) {
          dv_acc[r][c] = fmaf(pr[r], g[c], dv_acc[r][c]);
          dk_acc[r][c] = fmaf(dr[r], qv[c], dk_acc[r][c]);
        }
    }
  }

  const long long o_row = (long long)H * D;
  const long long base = ((long long)b * S * H + h) * D;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int kpos = k0 + ty * 4 + r;
    if (kpos >= S) continue;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      dk[base + kpos * o_row + tx + 16 * c] = from_f32<T>(dk_acc[r][c]);
      dv[base + kpos * o_row + tx + 16 * c] = from_f32<T>(dv_acc[r][c]);
    }
  }
}

// Shared memory of each kernel, in bytes.
size_t fwd_smem(int D) {
  return (size_t)((kBQ + kBK) * (D + 1) + kBK * D + kBQ * kPT) * 4;
}
size_t dq_smem(int D) {
  return (size_t)(2 * (kBQ + kBK) * (D + 1) + kBQ * kPT) * 4;
}
size_t dkv_smem(int D) {
  return (size_t)(2 * (kBQ + kBK) * (D + 1) + 2 * kBK * (kBQ + 1) +
                  2 * kBQ) * 4;
}

Layout layout(const long long* st) { return Layout{st[0], st[1], st[2]}; }

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

template <typename T, int D>
int launch_fwd(const void* q, const void* k, const void* v,
               const void* kv_len, void* out, void* lse,
               const long long* strides, int B, int H, int S, float scale,
               int causal, cudaStream_t stream) {
  const size_t smem = fwd_smem(D);
  cudaError_t err = allow_smem(flash_fwd_kernel<T, D>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(B * H, (S + kBQ - 1) / kBQ);
  flash_fwd_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int*>(kv_len),
      static_cast<T*>(out), static_cast<float*>(lse), layout(strides),
      layout(strides + 3), layout(strides + 6), H, S, scale, causal);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int D>
int launch_dq(const void* q, const void* k, const void* v, const void* dout,
              const void* lse, const void* delta, const void* kv_len,
              void* dq, const long long* strides, int B, int H, int S,
              float scale, int causal, cudaStream_t stream) {
  const size_t smem = dq_smem(D);
  cudaError_t err = allow_smem(flash_bwd_dq_kernel<T, D>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(B * H, (S + kBQ - 1) / kBQ);
  flash_bwd_dq_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<const int*>(kv_len), static_cast<T*>(dq), layout(strides),
      layout(strides + 3), layout(strides + 6), layout(strides + 9), H, S,
      scale, causal);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int D>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout,
               const void* lse, const void* delta, const void* kv_len,
               void* dk, void* dv, const long long* strides, int B, int H,
               int S, float scale, int causal, cudaStream_t stream) {
  const size_t smem = dkv_smem(D);
  cudaError_t err = allow_smem(flash_bwd_dkv_kernel<T, D>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(B * H, (S + kBK - 1) / kBK);
  flash_bwd_dkv_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<const int*>(kv_len), static_cast<T*>(dk),
      static_cast<T*>(dv), layout(strides), layout(strides + 3),
      layout(strides + 6), layout(strides + 9), H, S, scale, causal);
  return static_cast<int>(cudaGetLastError());
}

// One dispatch over (dtype, head dim) for the three entry points.
#define KFTPU_FLASH_DISPATCH(FN, ...)                                  \
  do {                                                                 \
    if (is_bf16 && D == 64) return FN<__nv_bfloat16, 64>(__VA_ARGS__); \
    if (is_bf16 && D == 128)                                           \
      return FN<__nv_bfloat16, 128>(__VA_ARGS__);                      \
    if (!is_bf16 && D == 64) return FN<float, 64>(__VA_ARGS__);        \
    if (!is_bf16 && D == 128) return FN<float, 128>(__VA_ARGS__);      \
    return static_cast<int>(cudaErrorInvalidValue);                    \
  } while (0)

}  // namespace

// strides: 3 element strides (b, s, h) each of q, k, v; out is a dense
// (B, S, H, D) tensor in q's dtype, lse a dense (B, H, S) f32 tensor;
// kv_len is (B,) int32 or null. Returns cudaGetLastError() after the
// launch (0 = cudaSuccess).
extern "C" int kftpu_flash_fwd(const void* q, const void* k, const void* v,
                               const void* kv_len, void* out, void* lse,
                               const long long* strides, int B, int H, int S,
                               int D, float scale, int causal, int is_bf16,
                               void* stream) {
  if (B == 0 || S == 0) return 0;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  KFTPU_FLASH_DISPATCH(launch_fwd, q, k, v, kv_len, out, lse, strides, B, H,
                       S, scale, causal, s);
}

// strides: (b, s, h) of q, k, v and dO; lse and delta are dense (B, H, S)
// f32; dq is a dense (B, S, H, D) tensor in q's dtype.
extern "C" int kftpu_flash_bwd_dq(const void* q, const void* k, const void* v,
                                  const void* dout, const void* lse,
                                  const void* delta, const void* kv_len,
                                  void* dq, const long long* strides, int B,
                                  int H, int S, int D, float scale,
                                  int causal, int is_bf16, void* stream) {
  if (B == 0 || S == 0) return 0;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  KFTPU_FLASH_DISPATCH(launch_dq, q, k, v, dout, lse, delta, kv_len, dq,
                       strides, B, H, S, scale, causal, s);
}

// As kftpu_flash_bwd_dq; dk and dv are dense (B, S, H, D) tensors.
extern "C" int kftpu_flash_bwd_dkv(const void* q, const void* k,
                                   const void* v, const void* dout,
                                   const void* lse, const void* delta,
                                   const void* kv_len, void* dk, void* dv,
                                   const long long* strides, int B, int H,
                                   int S, int D, float scale, int causal,
                                   int is_bf16, void* stream) {
  if (B == 0 || S == 0) return 0;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  KFTPU_FLASH_DISPATCH(launch_dkv, q, k, v, dout, lse, delta, kv_len, dk, dv,
                       strides, B, H, S, scale, causal, s);
}
