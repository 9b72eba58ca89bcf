// Fused BN-apply + ReLU + 1x1 conv (a GEMM over pixels) for Hopper
// (sm_90a): the forward and dW kernels, plain C interface.
//
// Replaces: kubeflow_tpu/ops/bnconv.py
// - bnconv_fwd_wgmma_kernel (bf16), bnconv_fwd_fma_kernel (f32)
//     <- _fwd_kernel (Pallas body :79, pallas_call :153):
//        out = relu(x * a + b) @ w;
// - bnconv_dw_wgmma_kernel (bf16), bnconv_dw_fma_kernel (f32), then
//   bnconv_fold_kernel <- _dw_kernel (:100, pallas_call :199):
//        dW = relu(x * a + b)^T @ dz.
// x is (M, K) rows of pixels with the channels contiguous, a and b are
// (K,) f32, w is (K, N), dz is (M, N). Both kernels compute y the
// reference's way in an A-operand prologue: y = max(x*a + b, 0) in f32
// with the product and the sum rounded separately (__fmul_rn/__fadd_rn:
// a contracted fma would round once where the reference rounds twice),
// rounded to bf16 when the activation dtype is bf16, then to x's dtype;
// products accumulate in f32. The forward writes x's dtype; dW is summed
// in f32 and written in w's dtype by the fold, in split order: repeat
// calls are bit-identical.
//
// What bounds them on H100. Every ResNet-50 site does M*K*N = 1.3e10
// multiply-adds: 26.3 GFLOP, 0.0266 ms on the bf16 tensor cores. Sites
// 0-2 ((802816, 64, 256), (200704, 128, 512), (50176, 256, 1024)) are
// bound by bytes: x and out (or x and dz) are 514, 257 and 129 MB, 0.153,
// 0.077 and 0.039 ms at 3.35 TB/s; at site 0 the 411 MB the forward
// writes are most of it. Site 3 ((12544, 512, 2048)) moves 64 MB
// (0.019 ms) and is bound by operations.
//
// bf16 design (both kernels), and what it does about those bounds:
// - Warp-specialised blocks of three warpgroups: one producer warp
//   feeds a 4-stage shared-memory ring by TMA (cp.async.bulk.tensor,
//   128-byte swizzle, completion on an mbarrier per stage: a full/empty
//   pair guards each stage), so device memory always has the next
//   stages in flight while two consumer warpgroups compute. The
//   producer gives its registers to the consumers (setmaxnreg).
// - The consumers run wgmma.mma_async (m64n128k16, f32 accumulate). The
//   A operand is y, made in registers: the raw x tile is read from the
//   swizzled stage with ldmatrix (transposed for dW, where A = y^T), the
//   BN affine, ReLU and rounding are applied per channel, and the packed
//   bf16 registers are wgmma's register A operand, so y never reaches
//   shared or device memory. B (w for the forward, dz for dW) is read
//   from the stage by descriptor, N-major through the transpose bit, as
//   TMA left it: no transposed copy of w or dz is made.
// - Forward: a persistent grid of one block per SM walks the 128 x 128
//   output tiles M-major (the N tiles of one row of x are neighbours, so
//   x is read from device memory once and w, at most 2 MB, stays in L2);
//   the producer runs ahead across tiles, so one tile's epilogue overlaps
//   the next tiles' loads. Each consumer warpgroup writes its 64 x 128
//   tile to shared memory and one thread stores it by TMA; the warpgroup
//   goes on to the next tile while the stores drain (at site 0 the
//   output is 80% of the bytes).
// - dW: a 64-channel x 256-column tile (each consumer warpgroup takes
//   128 columns), so the K = 64 sites compute no zero rows. The Pallas
//   kernel carries its sum over a sequential M grid axis; here M is split
//   across the blocks (one wave on the card), each writing an f32 partial
//   tile, and the fold sums the partials in a fixed order (no atomics).
//   Each 64-row stage's products go to fresh accumulators that the FMA
//   units add to the running f32 sums: the tensor cores truncate where
//   they add into an accumulator, and a chain over a split's thousands
//   of rows would carry that bias (the repair the flash kernels use).
// - TMA needs rows on 16 bytes: the wrapper zero-pads K (and N) to a
//   multiple of 8 where they are not, and a and b to whole 64-channel
//   stages, so channels past K give y = 0. Rows and columns past the
//   edges are zero-filled by TMA and never stored.
// - Measured on an H100 SXM at 700 W (scripts/port_bnconv_sweep.py):
//   storing the forward's tile with 16-byte stores from the consumers
//   cost 11-14% a step against the TMA stores; making the next stage's
//   y while this stage's wgmma runs (two A register sets) moved neither
//   kernel by more than 3%, so the simpler loop stays. At 128 x 128
//   tiles every site moves 411 MB of operands from L2 into the SMs
//   (M*K*N*2*(1/128 + 1/128) bytes), which is what holds sites 1-3 at
//   2-3x their bound; a wider tile is the next lever.
// f32 inputs run on the FMA units (64 x 64 tiles, a 4 x 4 micro-tile a
// thread), keeping f32 parity with the plain version.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using namespace hopper;

typedef __nv_bfloat16 bf16;

constexpr int kThreads = 256;  // FMA kernels and the fold

// wgmma kernels: two consumer warpgroups and one producer warpgroup
constexpr int kWG = 128;
constexpr int kTCThreads = 3 * kWG;
constexpr int kStages = 4;
constexpr int kFwdBM = 128, kFwdBN = 128;   // forward output tile
constexpr int kDwBK = 64, kDwBN = 256;      // dW output tile (K x N)
constexpr int kDwStep = 64;                 // dW rows of x a stage
constexpr int kFwdStage = kFwdBM * 128 + 2 * kBox;   // x tile + 2 w boxes
constexpr int kDwStage = kBox + 4 * kBox;            // x box + 4 dz boxes
// forward: the ring, then each consumer warpgroup's output staging (two
// 64 x 64 boxes), then the barriers
constexpr int kFwdSmem = kStages * kFwdStage + 2 * 2 * kBox +
                         2 * kStages * 8 + 1024;
constexpr int kDwSmem = kStages * kDwStage + 2 * kStages * 8 + 1024;

// FMA path (f32): block tile kFR x kFC, contraction step kFK
constexpr int kFR = 64;
constexpr int kFC = 64;
constexpr int kFK = 16;

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

// Two packed bf16 x values (low, high) through the prologue, packed again.
__device__ __forceinline__ uint32_t bn_relu2(uint32_t v, float a0, float b0,
                                             float a1, float b1) {
  const float2 f = __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&v));
  __nv_bfloat162 r = __floats2bfloat162_rn(bn_relu(f.x, a0, b0, 0),
                                           bn_relu(f.y, a1, b1, 0));
  return *reinterpret_cast<uint32_t*>(&r);
}

// wgmma descriptor of an N-major (transposed) bf16 B operand in 128-byte
// swizzled 64 x 64 boxes: 8-row groups of K 1024 bytes apart (SBO), the
// next 64 columns one box further on (LBO).
__device__ __forceinline__ uint64_t desc_b(uint32_t addr) {
  return wgmma_desc(addr, kBox, 1024);
}

// ---------------------------------------------------------------------------
// Forward, bf16: out (M, N) = relu(x*a + b) (M, K) @ w (K, N).
// Persistent: block i takes output tiles i, i + grid, ... (M-major).
// Threads 0-255 are the consumer warpgroups (rows 0-63 and 64-127 of a
// tile), 256-383 the producer warpgroup (one thread issues the copies).
// Stage s: x tile (128 rows x 64 channels), then two w boxes (64 channels
// x 64 columns each). A consumer warpgroup writes its 64 x 128 result to
// its staging (two 64 x 64 boxes, swizzled as TMA reads them) and one
// thread stores them by TMA; the warpgroup goes on to the next tile while
// the stores drain, and waits for them only before it writes the staging
// again.
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(kTCThreads, 1)
    bnconv_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap map_x,
                            const __grid_constant__ CUtensorMap map_w,
                            const __grid_constant__ CUtensorMap map_out,
                            const float* __restrict__ a,
                            const float* __restrict__ b, int M, int K,
                            int N) {
  extern __shared__ unsigned char smem[];
  const uint32_t ring = ring_base(smem);
  const uint32_t staging = ring + kStages * kFwdStage;
  const uint32_t bars = staging + 2 * 2 * kBox;
  unsigned char* gen = smem + (ring - smem_u32(smem));  // generic view
  const int tiles_n = (N + kFwdBN - 1) / kFwdBN;
  const int tiles = ((M + kFwdBM - 1) / kFwdBM) * tiles_n;
  const int n_k = (K + kSw - 1) / kSw;
  auto full = [&](int s) { return bars + 8 * s; };
  auto empty = [&](int s) { return bars + 8 * (kStages + s); };

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 8);  // one arrival per consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= 2 * kWG) {
    // ---- producer ----
    producer_regs();
    if (threadIdx.x == 2 * kWG) {
      int it = 0;
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const int m0 = (tile / tiles_n) * kFwdBM;
        const int n0 = (tile % tiles_n) * kFwdBN;
        const int nbox = min(2, (N - n0 + kSw - 1) / kSw);
        for (int kc = 0; kc < n_k; ++kc, ++it) {
          const int s = it % kStages;
          mbar_wait(empty(s), ((it / kStages) & 1) ^ 1);
          mbar_expect_tx(full(s), kFwdBM * 128 + nbox * kBox);
          const uint32_t st = ring + s * kFwdStage;
          tma_load(st, &map_x, full(s), kc * kSw, m0);
          for (int j = 0; j < nbox; ++j)
            tma_load(st + kFwdBM * 128 + j * kBox, &map_w, full(s),
                     n0 + j * kSw, kc * kSw);
        }
      }
    }
  } else {
    // ---- consumers ----
    consumer_regs();
    const int wg = threadIdx.x / kWG, tw = threadIdx.x % kWG;
    const int warp = tw / 32, lane = tw % 32, g = lane >> 2, t = lane & 3;
    const int row = wg * 64 + warp * 16 + (lane & 15);  // ldmatrix row
    const uint32_t st_wg = staging + wg * 2 * kBox;
    unsigned char* st_gen = gen + (st_wg - ring);
    int it = 0;
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      const int m0 = (tile / tiles_n) * kFwdBM;
      const int n0 = (tile % tiles_n) * kFwdBN;
      float acc[64];
#pragma unroll
      for (int i = 0; i < 64; ++i) acc[i] = 0.f;
      for (int kc = 0; kc < n_k; ++kc, ++it) {
        const int s = it % kStages;
        // this thread's channels of the stage: 16j + 2t (+1) and +8 (+9)
        float2 av[4][2], bv[4][2];
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int c = kc * kSw + 16 * j + 2 * t + 8 * h;
            av[j][h] = __ldg(reinterpret_cast<const float2*>(a + c));
            bv[j][h] = __ldg(reinterpret_cast<const float2*>(b + c));
          }
        mbar_wait(full(s), (it / kStages) & 1);
        const uint32_t st = ring + s * kFwdStage;
        uint32_t af[4][4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          ldsm_x4(af[j], st + sw128(row, 2 * j + (lane >> 4)));
          // registers 0, 1: channels 16j + 2t (+1); 2, 3: + 8
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const int h = r >> 1;
            af[j][r] = bn_relu2(af[j][r], av[j][h].x, bv[j][h].x,
                                av[j][h].y, bv[j][h].y);
          }
        }
        fence_regs(acc);
        wgmma_fence();
#pragma unroll
        for (int j = 0; j < 4; ++j)
          wgmma_m64n128_rs(acc, af[j],
                        desc_b(st + kFwdBM * 128 + j * 16 * 128),
                        kc > 0 || j > 0);
        wgmma_commit();
        wgmma_wait0();
        fence_regs(acc);
        __syncwarp();
        if (lane == 0) mbar_arrive(empty(s));
      }

      // epilogue: bf16 into the staging (column j of the fragment is
      // chunk j % 8 of box j / 8), then TMA stores
      if (tw == 0) bulk_wait_read();  // the last tile's stores have read it
      bar_sync(1 + wg, kWG);
#pragma unroll
      for (int j = 0; j < 16; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = warp * 16 + g + 8 * h;
          *reinterpret_cast<__nv_bfloat162*>(
              st_gen + (j >> 3) * kBox + sw128(r, j & 7) + 4 * t) =
              __floats2bfloat162_rn(acc[4 * j + 2 * h],
                                    acc[4 * j + 2 * h + 1]);
        }
      fence_async_smem();
      bar_sync(1 + wg, kWG);
      if (tw == 0 && m0 + wg * 64 < M) {
        for (int box = 0; box < 2 && n0 + box * kSw < N; ++box)
          tma_store(&map_out, st_wg + box * kBox, n0 + box * kSw,
                    m0 + wg * 64);
        bulk_commit();
      }
    }
    if (tw == 0) bulk_wait();
  }
}

// ---------------------------------------------------------------------------
// dW, bf16: the partial dW (K, N) of rows [split*chunk, (split+1)*chunk)
// into ws[split] (f32). grid: splits x (K tiles x N tiles), the tiles of
// one split adjacent so they share its rows of x and dz through L2.
// Consumer warpgroup wg owns columns 128wg..128wg+127 of the 64 x 256
// tile; A = y^T (the tile's 64 channels x 16 rows a step) from the x box
// by ldmatrix.trans, B = dz (16 rows x 128 columns) from its two boxes.
// Stage s: x box (64 rows x 64 channels), then four dz boxes (64 rows x
// 64 columns each).
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(kTCThreads, 1)
    bnconv_dw_wgmma_kernel(const __grid_constant__ CUtensorMap map_x,
                           const __grid_constant__ CUtensorMap map_dz,
                           const float* __restrict__ a,
                           const float* __restrict__ b,
                           float* __restrict__ ws, int M, int K, int N,
                           int chunk) {
  extern __shared__ unsigned char smem[];
  const uint32_t ring = ring_base(smem);
  const uint32_t bars = ring + kStages * kDwStage;
  const int tiles_n = (N + kDwBN - 1) / kDwBN;
  const int tiles = ((K + kDwBK - 1) / kDwBK) * tiles_n;
  const int tile = blockIdx.x % tiles, split = blockIdx.x / tiles;
  const int k0 = (tile / tiles_n) * kDwBK, n0 = (tile % tiles_n) * kDwBN;
  const long long ms = (long long)split * chunk;
  const long long me = ms + chunk < M ? ms + chunk : M;
  const int n_st = (int)((me - ms + kDwStep - 1) / kDwStep);
  auto full = [&](int s) { return bars + 8 * s; };
  auto empty = [&](int s) { return bars + 8 * (kStages + s); };

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 8);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= 2 * kWG) {
    // ---- producer ----
    producer_regs();
    if (threadIdx.x == 2 * kWG) {
      const int nbox = min(4, (N - n0 + kSw - 1) / kSw);
      for (int it = 0; it < n_st; ++it) {
        const int s = it % kStages;
        const int m = (int)(ms + (long long)it * kDwStep);
        mbar_wait(empty(s), ((it / kStages) & 1) ^ 1);
        mbar_expect_tx(full(s), kBox + nbox * kBox);
        const uint32_t st = ring + s * kDwStage;
        tma_load(st, &map_x, full(s), k0, m);
        for (int j = 0; j < nbox; ++j)
          tma_load(st + kBox + j * kBox, &map_dz, full(s), n0 + j * kSw, m);
      }
    }
  } else {
    // ---- consumers ----
    consumer_regs();
    const int wg = threadIdx.x / kWG, tw = threadIdx.x % kWG;
    const int warp = tw / 32, lane = tw % 32, g = lane >> 2, t = lane & 3;
    // this thread's two channels (rows g and g + 8 of the warp's 16)
    const int ch = k0 + warp * 16 + g;
    const float a0 = a[ch], b0 = b[ch], a1 = a[ch + 8], b1 = b[ch + 8];
    // ldmatrix.trans: rows of x (the contraction) and the channel chunk
    const int xr = ((lane >> 4) << 3) + (lane & 7);
    const int xc = 2 * warp + ((lane >> 3) & 1);
    float sum[64], fresh[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) sum[i] = fresh[i] = 0.f;
    for (int it = 0; it < n_st; ++it) {
      const int s = it % kStages;
      mbar_wait(full(s), (it / kStages) & 1);
      const uint32_t st = ring + s * kDwStage;
      uint32_t af[4][4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        ldsm_x4_t(af[j], st + sw128(16 * j + xr, xc));
        // registers 0, 2: channel ch; 1, 3: channel ch + 8
        af[j][0] = bn_relu2(af[j][0], a0, b0, a0, b0);
        af[j][1] = bn_relu2(af[j][1], a1, b1, a1, b1);
        af[j][2] = bn_relu2(af[j][2], a0, b0, a0, b0);
        af[j][3] = bn_relu2(af[j][3], a1, b1, a1, b1);
      }
      fence_regs(fresh);
      wgmma_fence();
#pragma unroll
      for (int j = 0; j < 4; ++j)
        wgmma_m64n128_rs(fresh, af[j],
                      desc_b(st + kBox + 2 * wg * kBox + j * 16 * 128),
                      j > 0);
      wgmma_commit();
      wgmma_wait0();
      fence_regs(fresh);
      __syncwarp();
      if (lane == 0) mbar_arrive(empty(s));
#pragma unroll
      for (int i = 0; i < 64; ++i) sum[i] += fresh[i];
    }

    float* part = ws + (long long)split * K * N;
#pragma unroll
    for (int j = 0; j < 16; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int k = ch + 8 * h;
        const int n = n0 + wg * 128 + 8 * j + 2 * t;
        if (k < K && n < N)
          *reinterpret_cast<float2*>(part + (long long)k * N + n) =
              make_float2(sum[4 * j + 2 * h], sum[4 * j + 2 * h + 1]);
      }
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

// A row-major (rows, cols) bf16 matrix as TMA boxes of box_rows rows x 64
// columns with the 128-byte swizzle (cols % 8 == 0, ptr on 16 bytes);
// past its edges a box reads zeros.
bool tensor_map(CUtensorMap* map, const void* ptr, long long rows, int cols,
                int box_rows) {
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * 2};
  const cuuint32_t box[2] = {(cuuint32_t)kSw, (cuuint32_t)box_rows};
  return encode_bf16(map, ptr, 2, dims, strides, box);
}

}  // namespace

extern "C" {

// The dW kernels' block tile (channels x columns) and rows a step, for
// the caller's choice of splits (a chunk is a multiple of the step).
int kftpu_bnconv_geometry(int is_bf16, int* tile_k, int* tile_n, int* step) {
  *tile_k = is_bf16 ? kDwBK : kFR;
  *tile_n = is_bf16 ? kDwBN : kFC;
  *step = is_bf16 ? kDwStep : kFK;
  return 0;
}

// out (M, N) in x's dtype. bf16: K % 8 == 0 and N % 8 == 0, x and w on
// 16 bytes, a and b hold ceil(K / 64) * 64 values (zeros past K).
int kftpu_bnconv_fwd(const void* x, const float* a, const float* b,
                     const void* w, void* out, int M, int K, int N,
                     int is_bf16, int round_act, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    CUtensorMap mx, mw, mo;
    if (K % 8 || N % 8 || !tensor_map(&mx, x, M, K, kFwdBM) ||
        !tensor_map(&mw, w, K, N, kSw) || !tensor_map(&mo, out, M, N, 64))
      return static_cast<int>(cudaErrorInvalidValue);
    const cudaError_t err = cudaFuncSetAttribute(
        bnconv_fwd_wgmma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kFwdSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
    const long long tiles = cdiv(M, kFwdBM) * cdiv(N, kFwdBN);
    const int sms = sm_count();
    bnconv_fwd_wgmma_kernel<<<(unsigned)(tiles < sms ? tiles : sms),
                              kTCThreads, kFwdSmem, s>>>(
        mx, mw, mo, a, b, M, K, N);
  } else {
    const long long blocks = cdiv(M, kFR) * cdiv(N, kFC);
    bnconv_fwd_fma_kernel<<<(unsigned)blocks, kThreads, 0, s>>>(
        static_cast<const float*>(x), a, b, static_cast<const float*>(w),
        static_cast<float*>(out), M, K, N, round_act);
  }
  return static_cast<int>(cudaGetLastError());
}

// dW (K, N) in f32 or bf16 (out_bf16) via the workspace ws (splits, K, N)
// f32; rows [s*chunk, (s+1)*chunk) go to split s, chunk a multiple of the
// step. bf16: K % 8 == 0 and N % 8 == 0, x and dz on 16 bytes, a and b
// as for the forward.
int kftpu_bnconv_dw(const void* x, const float* a, const float* b,
                    const void* dz, float* ws, void* out, int M, int K,
                    int N, int splits, int chunk, int is_bf16, int out_bf16,
                    int round_act, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    CUtensorMap mx, mdz;
    if (K % 8 || N % 8 || chunk % kDwStep ||
        !tensor_map(&mx, x, M, K, kDwStep) ||
        !tensor_map(&mdz, dz, M, N, kDwStep))
      return static_cast<int>(cudaErrorInvalidValue);
    const cudaError_t err = cudaFuncSetAttribute(
        bnconv_dw_wgmma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kDwSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
    const long long blocks = cdiv(K, kDwBK) * cdiv(N, kDwBN) * splits;
    bnconv_dw_wgmma_kernel<<<(unsigned)blocks, kTCThreads, kDwSmem, s>>>(
        mx, mdz, a, b, ws, M, K, N, chunk);
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
