// Fused BN-apply + ReLU + 1x1 conv (a GEMM over pixels) for Hopper
// (sm_90a): the forward and dW kernels, plain C interface.
//
// Replaces: kubeflow_tpu/ops/bnconv.py
// - bnconv_fwd_{mma,fma}_kernel <- _fwd_kernel (Pallas body :79,
//   pallas_call :153): out = relu(x * a + b) @ w;
// - bnconv_dw_{mma,fma}_kernel + bnconv_fold_kernel <- _dw_kernel (:100,
//   pallas_call :199): dW = relu(x * a + b)^T @ dz.
// x is (M, K) rows of pixels with the channels contiguous, a and b are
// (K,) f32, w is (K, N), dz is (M, N). Both kernels compute y the
// reference's way in an A-operand prologue: y = max(x*a + b, 0) in f32
// with the product and the sum rounded separately (__fmul_rn/__fadd_rn:
// a contracted fma would round once where the reference rounds twice),
// rounded to bf16 when the activation dtype is bf16, then to x's dtype;
// products accumulate in f32. The forward writes x's dtype; dW is summed
// in f32 and written in w's dtype by the fold.
//
// What bounds them on H100: bytes. Every site of ResNet-50 does M*K*N =
// 1.3e10 multiply-adds over 66-514 MB of x and out (or x and dz): ~26
// GFLOP is 0.027 ms on the bf16 tensor cores, the bytes 0.02-0.15 ms.
//
// Design, and what it does about that bound:
// - bf16 runs on the tensor cores (mma.sync m16n8k16, f32 accumulate),
//   so the arithmetic stays well below the memory time. The y tile is
//   written to shared memory as bf16 after the prologue and read with
//   ldmatrix, exactly as a plain bf16 GEMM reads its A tile; x and out
//   (or x and dz) cross device memory once per block tile. f32 inputs
//   run on the FMA units (64 x 64 tiles, a 4 x 4 micro-tile a thread),
//   keeping f32 parity with the plain version.
// - Block tiles are 128 x 128 (bf16) with a 32-deep contraction step;
//   8 warps each own 64 x 32 of the tile. The forward grid walks the N
//   tiles of one M tile together, so the x tile is read from device
//   memory once and from L2 for the other N tiles.
// - The Pallas dW kernel carries its sum across a sequential M grid axis.
//   Hopper blocks run in no order, and one block per (K tile, N tile)
//   would leave 2 blocks for 802,816 rows at ResNet-50's first stage. So
//   M is split across blocks, each writing an f32 partial tile to a
//   workspace, and a fold kernel sums the partials in a fixed order and
//   casts (deterministic, no atomics; the split-and-fold of
//   paged_attention.cu).
// - Any M, K and N: rows and channels past the edge are zero in shared
//   memory (y is set to 0 there, not relu(b)); 16-byte loads where K or N
//   is a multiple of 8 and the pointers are aligned, scalar loads
//   otherwise. The TPU's 128-lane block floor does not apply.
// - Not yet: cp.async/TMA staging with a multi-stage ring, wgmma.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kThreads = 256;

// tensor-core path (bf16): block tile kR x kC, contraction step kKC
constexpr int kR = 128;
constexpr int kC = 128;
constexpr int kKC = 32;
constexpr int kLdRow = kKC + 8;   // a [row][kc] tile (forward A)
constexpr int kLdWide = kC + 8;   // a [kc][128] tile (B; dW's A)

// FMA path (f32): block tile kFR x kFC, contraction step kFK
constexpr int kFR = 64;
constexpr int kFC = 64;
constexpr int kFK = 16;

static_assert(kR == kC, "the dW A tile reuses the B tile's row stride");

__device__ __forceinline__ void put(float* p, float v) { *p = v; }
__device__ __forceinline__ void put(bf16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// y = max(x*a + b, 0), rounded through bf16 when round_act is set.
__device__ __forceinline__ float bn_relu(float v, float a, float b,
                                         int round_act) {
  float t = __fadd_rn(__fmul_rn(v, a), b);
  t = t < 0.f ? 0.f : t;
  if (round_act) t = __bfloat162float(__float2bfloat16_rn(t));
  return t;
}

// ---------------------------------------------------------------------------
// Tensor-core helpers
// ---------------------------------------------------------------------------

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm_x4_t(unsigned (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Eight consecutive bf16 of a row-major (rows, cols) matrix from (row,
// col); zero past either edge. vec: cols % 8 == 0 and 16-byte aligned.
__device__ __forceinline__ uint4 load8(const bf16* src, long long row,
                                       long long rows, int cols, int col,
                                       bool vec) {
  if (vec && row < rows && col + 8 <= cols)
    return *reinterpret_cast<const uint4*>(src + row * cols + col);
  uint4 out;
  bf16* o = reinterpret_cast<bf16*>(&out);
#pragma unroll
  for (int i = 0; i < 8; ++i)
    o[i] = (row < rows && col + i < cols) ? src[row * cols + col + i]
                                          : __float2bfloat16_rn(0.f);
  return out;
}

// Eight consecutive y = bn_relu(x) of row `row` from channel `col`, as
// bf16; zero past either edge.
__device__ __forceinline__ uint4 load8_y(const bf16* x, const float* a,
                                         const float* b, long long row,
                                         long long rows, int K, int col,
                                         bool vec, int round_act) {
  uint4 out;
  bf16* o = reinterpret_cast<bf16*>(&out);
  if (vec && row < rows && col + 8 <= K) {
    uint4 raw = *reinterpret_cast<const uint4*>(x + row * K + col);
    const bf16* xv = reinterpret_cast<const bf16*>(&raw);
    const float4 a0 = *reinterpret_cast<const float4*>(a + col);
    const float4 a1 = *reinterpret_cast<const float4*>(a + col + 4);
    const float4 b0 = *reinterpret_cast<const float4*>(b + col);
    const float4 b1 = *reinterpret_cast<const float4*>(b + col + 4);
    const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
    const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
    for (int i = 0; i < 8; ++i)
      o[i] = __float2bfloat16_rn(
          bn_relu(__bfloat162float(xv[i]), av[i], bv[i], round_act));
    return out;
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    float t = 0.f;
    if (row < rows && col + i < K)
      t = bn_relu(__bfloat162float(x[row * K + col + i]), a[col + i],
                  b[col + i], round_act);
    o[i] = __float2bfloat16_rn(t);
  }
  return out;
}

// One kKC-deep step of the block's product from shared memory. Warp w
// owns rows wr..wr+63 and columns wc..wc+31 of the kR x kC tile.
// sB is [kc][kLdWide]. A is sA[row][kLdRow] (forward), or, with kTransA,
// sA[kc][kLdWide] holding A transposed (dW: A = y^T, stored as y).
template <bool kTransA>
__device__ __forceinline__ void mma_step(float (&acc)[4][4][4],
                                         const bf16* sA, const bf16* sB,
                                         int wr, int wc, int lane) {
#pragma unroll
  for (int kk = 0; kk < kKC; kk += 16) {
    unsigned af[4][4];
#pragma unroll
    for (int mi = 0; mi < 4; ++mi) {
      const int r0 = wr + mi * 16;
      if (kTransA)
        // matrix j = lane / 8: contraction rows +8 for j >= 2, A rows +8
        // for odd j (a0a1, a2a3, a4a5, a6a7 of the fragment)
        ldsm_x4_t(af[mi], sA + (kk + (lane & 7) + ((lane >> 4) << 3)) *
                                   kLdWide +
                              r0 + ((lane >> 3) & 1) * 8);
      else
        ldsm_x4(af[mi], sA + (r0 + (lane & 15)) * kLdRow + kk +
                            (lane >> 4) * 8);
    }
    unsigned bfr[4][2];
#pragma unroll
    for (int nj = 0; nj < 2; ++nj) {
      unsigned r[4];
      ldsm_x4_t(r, sB + (kk + (lane & 15)) * kLdWide + wc + nj * 16 +
                       (lane >> 4) * 8);
      bfr[2 * nj][0] = r[0];
      bfr[2 * nj][1] = r[1];
      bfr[2 * nj + 1][0] = r[2];
      bfr[2 * nj + 1][1] = r[3];
    }
#pragma unroll
    for (int mi = 0; mi < 4; ++mi)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
        mma_bf16(acc[mi][ni], af[mi], bfr[ni][0], bfr[ni][1]);
  }
}

// Store a pair (v0, v1) at (row, col) and (row, col + 1) of a row-major
// (rows, N) matrix, within its edges.
__device__ __forceinline__ void store2(bf16* dst, long long row,
                                       long long rows, int N, int col,
                                       float v0, float v1) {
  if (row >= rows || col >= N) return;
  bf16* p = dst + row * N + col;
  if ((N & 1) == 0) {   // col is even, so p is 4-byte aligned
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(v0, v1);
  } else {
    p[0] = __float2bfloat16_rn(v0);
    if (col + 1 < N) p[1] = __float2bfloat16_rn(v1);
  }
}

__device__ __forceinline__ void store2(float* dst, long long row,
                                       long long rows, int N, int col,
                                       float v0, float v1) {
  if (row >= rows || col >= N) return;
  float* p = dst + row * N + col;
  if ((N & 1) == 0) {
    *reinterpret_cast<float2*>(p) = make_float2(v0, v1);
  } else {
    p[0] = v0;
    if (col + 1 < N) p[1] = v1;
  }
}

// ---------------------------------------------------------------------------
// Forward, bf16: out (M, N) = relu(x*a + b) (M, K) @ w (K, N).
// grid: one block per (M tile, N tile), N tiles of one M tile adjacent.
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(kThreads)
    bnconv_fwd_mma_kernel(const bf16* __restrict__ x,
                          const float* __restrict__ a,
                          const float* __restrict__ b,
                          const bf16* __restrict__ w, bf16* __restrict__ out,
                          int M, int K, int N, int round_act, int vec) {
  __shared__ __align__(16) bf16 sA[kR * kLdRow];
  __shared__ __align__(16) bf16 sB[kKC * kLdWide];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wr = (warp >> 2) * 64, wc = (warp & 3) * 32;
  const int tiles_n = (N + kC - 1) / kC;
  const long long m0 = (long long)(blockIdx.x / tiles_n) * kR;
  const int n0 = (blockIdx.x % tiles_n) * kC;
  const bool vec_x = vec & 1, vec_w = vec & 2;

  float acc[4][4][4];
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.f;

  for (int k0 = 0; k0 < K; k0 += kKC) {
    __syncthreads();
    // y tile: kR rows x kKC channels, 8 channels a thread-step
    for (int e = threadIdx.x; e < kR * kKC / 8; e += kThreads) {
      const int r = e / (kKC / 8), c = (e % (kKC / 8)) * 8;
      *reinterpret_cast<uint4*>(sA + r * kLdRow + c) =
          load8_y(x, a, b, m0 + r, M, K, k0 + c, vec_x, round_act);
    }
    // w tile: kKC rows x kC columns
    for (int e = threadIdx.x; e < kKC * kC / 8; e += kThreads) {
      const int r = e / (kC / 8), c = (e % (kC / 8)) * 8;
      *reinterpret_cast<uint4*>(sB + r * kLdWide + c) =
          load8(w, k0 + r, K, N, n0 + c, vec_w);
    }
    __syncthreads();
    mma_step<false>(acc, sA, sB, wr, wc, lane);
  }

#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
      const long long row = m0 + wr + mi * 16 + (lane >> 2);
      const int col = n0 + wc + ni * 8 + (lane & 3) * 2;
      store2(out, row, M, N, col, acc[mi][ni][0], acc[mi][ni][1]);
      store2(out, row + 8, M, N, col, acc[mi][ni][2], acc[mi][ni][3]);
    }
}

// ---------------------------------------------------------------------------
// dW, bf16: partial dW (K, N) of rows [split*chunk, (split+1)*chunk) into
// ws[split] (f32). grid: splits x (K tiles x N tiles), the tiles of one
// split adjacent so they share its rows of x and dz through L2.
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(kThreads)
    bnconv_dw_mma_kernel(const bf16* __restrict__ x,
                         const float* __restrict__ a,
                         const float* __restrict__ b,
                         const bf16* __restrict__ dz, float* __restrict__ ws,
                         int M, int K, int N, int chunk, int round_act,
                         int vec) {
  __shared__ __align__(16) bf16 sA[kKC * kLdWide];   // y rows: [m][k]
  __shared__ __align__(16) bf16 sB[kKC * kLdWide];   // dz rows: [m][n]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wr = (warp >> 2) * 64, wc = (warp & 3) * 32;
  const int tiles_n = (N + kC - 1) / kC;
  const int tiles = ((K + kR - 1) / kR) * tiles_n;
  const int tile = blockIdx.x % tiles, split = blockIdx.x / tiles;
  const int k0 = (tile / tiles_n) * kR, n0 = (tile % tiles_n) * kC;
  const long long ms = (long long)split * chunk;
  const long long me = ms + chunk < M ? ms + chunk : M;
  const bool vec_x = vec & 1, vec_z = vec & 2;

  float acc[4][4][4];
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.f;

  for (long long m0 = ms; m0 < me; m0 += kKC) {
    __syncthreads();
    for (int e = threadIdx.x; e < kKC * kR / 8; e += kThreads) {
      const int r = e / (kR / 8), c = (e % (kR / 8)) * 8;
      *reinterpret_cast<uint4*>(sA + r * kLdWide + c) =
          load8_y(x, a, b, m0 + r, me, K, k0 + c, vec_x, round_act);
    }
    for (int e = threadIdx.x; e < kKC * kC / 8; e += kThreads) {
      const int r = e / (kC / 8), c = (e % (kC / 8)) * 8;
      *reinterpret_cast<uint4*>(sB + r * kLdWide + c) =
          load8(dz, m0 + r, me, N, n0 + c, vec_z);
    }
    __syncthreads();
    mma_step<true>(acc, sA, sB, wr, wc, lane);
  }

  float* part = ws + (long long)split * K * N;
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
      const long long row = k0 + wr + mi * 16 + (lane >> 2);
      const int col = n0 + wc + ni * 8 + (lane & 3) * 2;
      store2(part, row, K, N, col, acc[mi][ni][0], acc[mi][ni][1]);
      store2(part, row + 8, K, N, col, acc[mi][ni][2], acc[mi][ni][3]);
    }
}

// ---------------------------------------------------------------------------
// FMA path (f32): 64 x 64 tiles, 16-deep steps; thread (ty, tx) owns
// rows ty + 16 i and columns tx + 16 j of the tile.
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(kThreads)
    bnconv_fwd_fma_kernel(const float* __restrict__ x,
                          const float* __restrict__ a,
                          const float* __restrict__ b,
                          const float* __restrict__ w,
                          float* __restrict__ out, int M, int K, int N,
                          int round_act) {
  __shared__ float sA[kFK][kFR + 1];   // y transposed: [k][m]
  __shared__ float sB[kFK][kFC];       // w: [k][n]
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int tiles_n = (N + kFC - 1) / kFC;
  const long long m0 = (long long)(blockIdx.x / tiles_n) * kFR;
  const int n0 = (blockIdx.x % tiles_n) * kFC;
  float acc[4][4] = {};

  for (int k0 = 0; k0 < K; k0 += kFK) {
    __syncthreads();
    for (int e = tid; e < kFR * kFK; e += kThreads) {
      const int r = e / kFK, c = e % kFK;
      const long long m = m0 + r;
      const int k = k0 + c;
      sA[c][r] = (m < M && k < K) ? bn_relu(x[m * K + k], a[k], b[k],
                                              round_act)
                                    : 0.f;
    }
    for (int e = tid; e < kFK * kFC; e += kThreads) {
      const int r = e / kFC, c = e % kFC;
      const int k = k0 + r, n = n0 + c;
      sB[r][c] = (k < K && n < N) ? w[(long long)k * N + n] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kc = 0; kc < kFK; ++kc) {
      float av[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) av[i] = sA[kc][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) bv[j] = sB[kc][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const long long m = m0 + ty + 16 * i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx + 16 * j;
      if (n < N) out[m * N + n] = acc[i][j];
    }
  }
}

__global__ void __launch_bounds__(kThreads)
    bnconv_dw_fma_kernel(const float* __restrict__ x,
                         const float* __restrict__ a,
                         const float* __restrict__ b,
                         const float* __restrict__ dz,
                         float* __restrict__ ws, int M, int K, int N,
                         int chunk, int round_act) {
  __shared__ float sA[kFK][kFR];   // y rows: [m][k]
  __shared__ float sB[kFK][kFC];   // dz rows: [m][n]
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int tiles_n = (N + kFC - 1) / kFC;
  const int tiles = ((K + kFR - 1) / kFR) * tiles_n;
  const int tile = blockIdx.x % tiles, split = blockIdx.x / tiles;
  const int k0 = (tile / tiles_n) * kFR, n0 = (tile % tiles_n) * kFC;
  const long long ms = (long long)split * chunk;
  const long long me = ms + chunk < M ? ms + chunk : M;
  float acc[4][4] = {};

  for (long long m0 = ms; m0 < me; m0 += kFK) {
    __syncthreads();
    for (int e = tid; e < kFK * kFR; e += kThreads) {
      const int r = e / kFR, c = e % kFR;
      const long long m = m0 + r;
      const int k = k0 + c;
      sA[r][c] = (m < me && k < K) ? bn_relu(x[m * K + k], a[k], b[k],
                                               round_act)
                                     : 0.f;
    }
    for (int e = tid; e < kFK * kFC; e += kThreads) {
      const int r = e / kFC, c = e % kFC;
      const long long m = m0 + r;
      const int n = n0 + c;
      sB[r][c] = (m < me && n < N) ? dz[m * N + n] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int mc = 0; mc < kFK; ++mc) {
      float av[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) av[i] = sA[mc][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) bv[j] = sB[mc][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
  }
  float* part = ws + (long long)split * K * N;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int k = k0 + ty + 16 * i;
    if (k >= K) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx + 16 * j;
      if (n < N) part[(long long)k * N + n] = acc[i][j];
    }
  }
}

// ---------------------------------------------------------------------------
// Fold: out[i] = sum over splits of ws[s][i], in split order, cast to the
// output dtype.
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(kThreads)
    bnconv_fold_kernel(const float* __restrict__ ws, int splits,
                       long long count, T* __restrict__ out) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       i < count; i += (long long)gridDim.x * blockDim.x) {
    float s = 0.f;
    for (int p = 0; p < splits; ++p) s += ws[p * count + i];
    put(out + i, s);
  }
}

long long cdiv(long long a, long long b) { return (a + b - 1) / b; }

}  // namespace

extern "C" {

// The dW kernels' block tile edge and contraction step, for the caller's
// choice of splits (a chunk is a multiple of the step).
int kftpu_bnconv_geometry(int is_bf16, int* tile, int* step) {
  *tile = is_bf16 ? kR : kFR;
  *step = is_bf16 ? kKC : kFK;
  return 0;
}

// out (M, N) in x's dtype. vec: bit 0 when K % 8 == 0 and x, a, b are
// 16-byte aligned; bit 1 when N % 8 == 0 and w is.
int kftpu_bnconv_fwd(const void* x, const float* a, const float* b,
                     const void* w, void* out, int M, int K, int N,
                     int is_bf16, int round_act, int vec, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    const long long blocks = cdiv(M, kR) * cdiv(N, kC);
    bnconv_fwd_mma_kernel<<<(unsigned)blocks, kThreads, 0, s>>>(
        static_cast<const bf16*>(x), a, b, static_cast<const bf16*>(w),
        static_cast<bf16*>(out), M, K, N, round_act, vec);
  } else {
    const long long blocks = cdiv(M, kFR) * cdiv(N, kFC);
    bnconv_fwd_fma_kernel<<<(unsigned)blocks, kThreads, 0, s>>>(
        static_cast<const float*>(x), a, b, static_cast<const float*>(w),
        static_cast<float*>(out), M, K, N, round_act);
  }
  return static_cast<int>(cudaGetLastError());
}

// dW (K, N) in f32 or bf16 (out_bf16) via the workspace ws (splits, K, N)
// f32; rows [s*chunk, (s+1)*chunk) go to split s. vec as for the forward,
// bit 1 for dz.
int kftpu_bnconv_dw(const void* x, const float* a, const float* b,
                    const void* dz, float* ws, void* out, int M, int K,
                    int N, int splits, int chunk, int is_bf16, int out_bf16,
                    int round_act, int vec, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    const long long blocks = cdiv(K, kR) * cdiv(N, kC) * splits;
    bnconv_dw_mma_kernel<<<(unsigned)blocks, kThreads, 0, s>>>(
        static_cast<const bf16*>(x), a, b, static_cast<const bf16*>(dz), ws,
        M, K, N, chunk, round_act, vec);
  } else {
    const long long blocks = cdiv(K, kFR) * cdiv(N, kFC) * splits;
    bnconv_dw_fma_kernel<<<(unsigned)blocks, kThreads, 0, s>>>(
        static_cast<const float*>(x), a, b, static_cast<const float*>(dz),
        ws, M, K, N, chunk, round_act);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long count = (long long)K * N;
  long long blocks = cdiv(count, kThreads);
  if (blocks > 4096) blocks = 4096;
  if (out_bf16)
    bnconv_fold_kernel<bf16><<<(unsigned)blocks, kThreads, 0, s>>>(
        ws, splits, count, static_cast<bf16*>(out));
  else
    bnconv_fold_kernel<float><<<(unsigned)blocks, kThreads, 0, s>>>(
        ws, splits, count, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
