// Flash attention for Hopper (sm_90a): forward, dQ and dK/dV kernels,
// plain C interface.
//
// Replaces: kubeflow_tpu/ops/attention.py
// - flash_fwd_wgmma_kernel (bf16, D = 64), flash_fwd_mma_kernel (bf16,
//   D = 128), flash_fwd_kernel (f32)
//     <- _flash_fwd_kernel (Pallas body :188, pallas_call :345, wrapper
//        _flash_fwd :306);
// - flash_bwd_wgmma_kernel (bf16, D = 64: dQ, dK and dV in one pass, with
//   flash_bwd_dq_out_kernel, dQ's pass out of its f32 workspace)
//     <- _flash_bwd_dq_kernel (:369, call :530, wrapper _flash_bwd :482)
//        and _flash_bwd_dkv_kernel (:422, call :560);
// - flash_bwd_dq_mma_kernel (bf16, D = 128), flash_bwd_dq_kernel (f32)
//     <- _flash_bwd_dq_kernel;
// - flash_bwd_dkv_mma_kernel (bf16, D = 128), flash_bwd_dkv_kernel (f32)
//     <- _flash_bwd_dkv_kernel.
// They compute what the Pallas kernels compute: f32 scores, the finite
// NEG_INF = -1e30 for masked scores (a row whose keys are all masked
// averages V uniformly, with no inf - inf), an online softmax whose l is
// clamped at 1e-30 and whose lse = m + log(l) is saved; the forward
// rounds P to the V dtype before P.V; the backward recomputes
// P = exp(s - lse), keeps P and dS = P * (dO.V^T - delta) in f32 for
// dV = P^T.dO and dK = dS^T.q, and scales dQ and dK once. The FMA
// kernels score from q pre-scaled in f32, (q * scale).k; the tensor-core
// kernels (mma.sync and wgmma) scale the f32 product of the bf16 inputs, (q.k) * scale. For D = 64 the
// scale 0.125 is a power of two and the two are the same number; for
// D = 128 they differ at the f32 ulp.
//
// What bounds them on H100: operations. Per live (q row, key) pair the
// forward does 4*D flops, dQ 6*D and dK/dV 8*D (dQ, dK and dV together
// 10*D: the fused pass makes S, dP, P and dS once), against 2-4 bytes read per
// D values of a whole tile that is reused 64 times: at S = 8192 the
// intensity is thousands of flops per byte, far above the card's ~295
// flop/byte ridge. The floor is the causal flops over the bf16
// tensor-core rate (989 TFLOP/s).
//
// Design common to all the kernels:
// - Pallas carries acc/m/l across a SEQUENTIAL kv grid axis; Hopper
//   blocks run in no order. So the forward and dQ use one block per
//   (batch*head, q tile) that loops over the kv tiles inside the block,
//   and dK/dV one block per (batch*head, kv tile) that loops over the q
//   tiles from the first live one, the heaviest tiles launched first.
//   Each output is owned by one block (no atomics, deterministic sums),
//   but for the fused backward's dQ: its partials are added across
//   blocks in a fixed order (below), so a repeat call is bit-identical
//   too.
// - Causal loop limits are the reference's _last_live_kv (:152) and
//   _first_live_q (:160); the per-position masks are its
//   _causal_block_mask and _pad_mask (:167, :177). All kernels use the
//   same expressions, so the backward's P is the forward's. A batch row
//   with kv_len == 0 has every key masked: its loops cover every tile, so
//   it averages over all S keys, as reference_attention does.
// - Tiles of 64 q rows by 64 keys (kBK, and the wgmma forward's kFwdStep,
//   is BLOCK_K of the plain forward). The causal forward and dQ grids put
//   batch*head on x and walk q tiles from the last (most kv tiles) to the
//   first. The wgmma kernels walk a work list from the wrapper
//   (ops/flash_attention.py:wgmma_work, one head's) on persistent grids
//   whose blocks take the items head by head from a counter: the
//   forward's items are 192 (or 64) q rows streaming 64-key stages,
//   heaviest first; the backward's blocks own 128 keys (kWgTile)
//   streaming 64 q rows a stage (kWgStep) in descending kv tile.
// - Inputs are read through their (B, S, H, D) strides (no head-fusing
//   transpose); the ragged edge is masked, so any S works: keys past S
//   are zero in shared memory and get P = 0, q rows past S are never
//   stored and give P = 0 in dK/dV.
//
// bf16 at D = 64 (the LM, BERT, ViT and MoE LM paths, and any D < 64,
// padded to it): wgmma over a TMA ring fed by a producer warp, the shape
// of bnconv.cu, with the helpers of hopper.cuh: consumer warpgroups of
// 64 owned rows each and a producer warpgroup whose first warp keeps the
// ring's stages in flight (cp.async.bulk.tensor, 128-byte swizzle, a
// full/empty mbarrier pair a stage) and hands its registers to the
// consumers (setmaxnreg). q, k, v and dO are read through 4-D tensor maps
// over (D, S, H, B) with the caller's strides (views of a fused
// projection included; the wrapper refuses what a map cannot encode);
// TMA's zero fill stands in for rows past S.
// - Forward (flash_fwd_wgmma_kernel<D, NC>): an item is 64 NC q rows of
//   one head with Q resident (one box of the item's rows, two buffers, so
//   the next item's Q loads under this one); K and V ride the ring, 64
//   keys a stage (kFwdStep: BLOCK_K of the plain forward, so P is rounded
//   at the same running max), the stage count running on from item to
//   item, so the next item's first stages load under this one's last.
//   NC = 3 (192 rows, one block an SM, consumers at 160 registers) is the
//   rule; NC = 1 (64 rows, two blocks an SM, 232) is the tile table's
//   choice where the 192-row grid's last round would leave SMs idle
//   (ops/autotune.py:forward_rounds). The grid is persistent: as many
//   blocks as the card holds, block b's first item is item b and the rest
//   come from a counter, taken when its producer is free, head by head,
//   so the blocks in flight read a few heads' K and V from L2 and the
//   heavy and light items of each head are shared out as they free up.
//   The ring: a full and an empty mbarrier a stage (K and V together; the
//   empty one counts each consumer warp's release after its P.V lands;
//   K and V on barriers of their own, K's slot freed once S has landed,
//   read 5% slower at the LM shape: the stage waits the timeline shows,
//   ~190 ns a stage for the outer warpgroups, follow the middle one's
//   pace and not the ring's refills),
//   a full and an empty one a Q buffer, and each Q buffer's item as the
//   producer decoded it (kFwdSlot), so no consumer reads the work list
//   or kv_len from global memory.
//   Inside a warpgroup the stages overlap: S_{j+1} = Q.K_{j+1}^T and
//   P_j.V_j go out together, the softmax of S_{j+1} runs on the SFU and
//   FMA units while P_j.V_j is in flight (wgmma_wait<1>), and P_{j+1} is
//   rounded into P's registers once P_j.V_j has landed. S is wgmma
//   m64n64k16 with both operands K-major in shared memory (descriptors
//   made once: a slot's and a k-step's offsets add to the address
//   field), into fresh fragments (its first k-step only writes them, so
//   they are no input of the next S and hold P in f32 between stages);
//   the softmax runs in place on them: the row max over the raw products
//   (scale > 0), each exponent one FFMA, 2^(s * c - m * c) with c = scale
//   * log2(e), the masks only on edge stages (causal diagonal, kv_len,
//   keys past S to -inf; a masked product is kMaskRaw, so a row with no
//   live key averages V uniformly, as NEG_INF makes the reference's). P,
//   rounded to bf16, is the register A operand of P.V with V read
//   MN-major from the stage through the transpose bit. P.V goes to fresh
//   fragments and the FMA units add it as O = O * alpha + P.V (see Long
//   sums). The epilogue scales by 1 / max(l, 1e-30), writes O in bf16
//   into one of the warpgroup's two staging boxes, which one thread
//   stores by TMA once a named barrier has seen all four warps' writes
//   and the other box's last store read, and stores lse = m + logf(l)
//   from registers (held to 1e-5 absolute: logf, not the SFU's lg2). It
//   took ~0.6 us an item as bf16 pairs stored from registers; one box
//   behind a second barrier (its last store read before anyone writes)
//   held the warps in step and read 1% slower at the LM shape, 7% faster
//   at BERT's (PERF.md §6). No branch sits between a wgmma's
//   issue and the
//   wait that retires it, so ptxas sees which group each wait retires
//   (with a conditional S inside the loop it serialized every wgmma,
//   C7514).
//   Items hand off: where a warpgroup's last stage is its item's (the
//   ring's next stage is the next item's first) and the next item has
//   stages for it, the next item's first S goes out with this item's last
//   P.V and its softmax runs under it, then the epilogue; the next item's
//   steady loop starts with its P made. A warpgroup whose last stage comes
//   earlier (a causal item's lower rows, whose next stage is up to NC - 1
//   stages on) drains: its last P.V goes out at once and its epilogue runs
//   while the ring fills (handing off there too held the lowest
//   warpgroup's slot until the next item's first stage, which a 3-stage
//   ring never loads: tests/test_torch_flash_fwd_schedule.py's block
//   model). Each warpgroup decides alone: the probe "has the next Q
//   landed" was tried, read by each warp at its own moment, and hung the
//   block (the warps of a warpgroup must issue the same wgmma); with one
//   thread's answer read after a named barrier it ran, but slower at the
//   short shapes. Block b's first item is item b, and a grid of one round
//   is told "none left" with no atomic: no global atomic stands before a
//   block's first loads.
//   Every exponent goes through the SFU's ex2. One or two 8-key groups of
//   a stage's exponents through a polynomial 2^x on the FMA units (a
//   Cody-Waite split and a degree-5 minimax polynomial) read 6% and 11%
//   slower at the LM shape on an H100 (PERF.md §6, its coefficients
//   there): ~11 instructions for one MUFU issue cost more than the SFU
//   time they free, as the stage is not SFU-bound alone but issue- and
//   latency-bound with the three warpgroups' softmaxes in phase.
//   Bound: operations, 4*D flops a live pair, 2 GEMMs' worth a tile; at
//   D = 64 the pair's one exponential on the SFU (16 a clock an SM) costs
//   about as much as its 256 flops on the tensor cores. Registers: O
//   (32), P.V's fresh fragments (32), P (16) and S (32) a thread at the
//   peak, so three warpgroups fit 160; a 128-key stage (S 64, P 32) would
//   not, and two warpgroups of it at 240 registers read slower (PERF.md
//   §6 row 3).
// - The backward is one kernel for dQ, dK and dV (flash_bwd_wgmma_kernel).
//   Two passes (one owning keys for dK/dV, one owning q rows for dQ) each
//   made S, dP, P = exp(S - lse) and dS again: the exponentials twice and
//   4 of a pair's 10 GEMMs' worth twice. One pass makes them once.
//   Kept from the dK/dV pass: a block owns 128 keys with K and V resident
//   in shared memory; Q and dO of each 64-row q tile ride the ring, and
//   the producer warp writes the tile's lse and delta beside them; each
//   consumer warpgroup owns 64 keys. S^T = K.Q^T and dP^T = V.dO^T are
//   wgmma m64n64k16 with both operands K-major in shared memory, two
//   groups. P^T and dS^T are made in f32 registers, split into hi + lo
//   bf16 and packed as wgmma's register A operand for dV += P^T.dO, then
//   dK += dS^T.Q: B is the stage's dO or Q read MN-major through the
//   descriptor's transpose bit, with no transposed copy.
//   P^T = exp(S^T scale - lse) is one FFMA an exponent on the SFU's
//   ex2: ex2(s c - lse log2 e) with c = scale log2 e, the producer having
//   stored lse log2 e beside delta (lse itself is the forward's); edge
//   tiles (causal diagonal, kv_len, S) take one branch a tile, not one a
//   value, and give a masked key the reference's NEG_INF score.
//   Added, dQ: each warpgroup writes its dS^T (hi and lo, one stmatrix of
//   four 8 x 8 matrices a k-step, conflict-free in the 128-byte swizzle)
//   to shared memory in the layout of a TMA K box
//   (rows are keys; two buffers by q tile), and the tile's owner runs
//   dQ_tile = dS.K over the block's 128 keys with both operands in
//   shared memory: A is dS^T and B the resident K, each read MN-major
//   through its transpose bit (wgmma m64n64k16, 16 of them: 128 keys in
//   hi and lo), into fresh fragments, one f32 sum in a fixed order with no
//   add across warpgroups. That is 8 GEMMs' worth of tensor-core work a
//   tile (S^T, dP^T, dV and dK as before, dQ's hi + lo) for the
//   algorithm's 5. The owner of the block's q tile tq (counted over its
//   walk) is warpgroup tq & 1, and so is dS^T buffer tq & 1: each
//   warpgroup issues 24 products a tile and dQ's 16 on every other one,
//   32 on average. The owner waits for the other's half (an mbarrier a
//   buffer, ds_full); the other waits only before it writes a buffer
//   whose last dQ has not landed (ds_free), two tiles back; no barrier
//   joins the two warpgroups on every tile. (PR 22's design, all dQ on
//   one warpgroup, 40 products against 24, with turns and three f32
//   operations an exponent, read 2.70 ms at the LM, this one 2.34-2.38:
//   PERF.md, PR 24. Split by output columns, both warpgroups meet at a
//   barrier on every tile: PR 22 times it and the other splits tried.)
//   The partial (64 x 64 f32, 16 KB as two 32-column boxes of 128-byte
//   rows in the 128-byte swizzle, so the owner's float2 stores take the
//   two wavefronts a warp's 256 bytes need) goes to a dense (B, S, H, D)
//   f32 workspace by TMA (two boxes through an f32 tensor map, rows past
//   S not written), issued by an adder warp of the producer warpgroup
//   (kDqBufs of them, one a buffer, so that many adds are in flight): a
//   tensor store for a q tile's first add, a tensor reduce-add (.add,
//   f32, rounding to nearest) for the others, so the workspace needs no
//   zeroing. After the last add, flash_bwd_dq_out_kernel scales the
//   workspace and rounds it to bf16.
//   The order of dQ's adds: with ascending q walks that start at
//   _first_live_q, kv tile j reaches a q tile later than every kv tile
//   above it, so the adds into each q tile land in descending kv tile.
//   A counter per (head, q tile) in global memory (counters, zeroed by
//   the wrapper) holds the adds landed; the adder of kv tile j waits
//   until it equals the number of live kv tiles above j (bwd_turn),
//   adds, waits for its copies to complete and releases one more
//   (red.release after fence.proxy.async); kv tile 0, the last adder of
//   every q tile, neither waits for its copies nor releases. Where a
//   wait can occur and why it ends: only in the adders, and only on kv
//   tiles above their own of the same head. The grid is persistent (one
//   block an SM; each takes items from counters[0], so items start in
//   list order), and the list
//   is ordered head by head and, within a head, in descending kv tile:
//   every kv tile a block waits on took its item earlier, so it is
//   running or done, and its adds wait only on kv tiles above it. (The
//   list's heaviest-first order of the two passes would put kv tile 0
//   first: it would wait on items not yet taken, which ends only while
//   every kv tile of a head can run at once.) At the causal LM shape the
//   lower kv tiles start no earlier and walk more tiles before each q
//   tile, so by tile order alone an adder would never wait. On an H100
//   (PERF.md, PR 24; scripts/port_flash_bwd_timeline.py) the blocks hold
//   5 heads at once (6 at most): ~10-12 MB of the 67 MB workspace is live,
//   inside the 50 MB L2, so L2 is not why adds wait; most of the
//   adders' waiting is the turn check itself (acquire loads of the
//   counter, ~0.6 us an add in the instrumented copy), and the consumers
//   stall on the adders' buffers ~0.04 us a ~2.5 us tile.
//   Registers (232 a consumer thread): dK and dV (64) stay; at a tile's
//   peak P^T in f32 (for dS), its hi + lo operand, dV's fresh fragments
//   and dS^T's operand (128); the owner's dQ (32) goes out once dV's are
//   added, and the next tile's S^T and dP^T (64) once dK's are (the
//   other warpgroup's beside dK's: 192). Holding them longer, under this
//   tile's dS or P, needs 32-64 more: those schedules spilled dK and dV
//   (32-956 bytes) or, with groups pending across the loop's back edge,
//   had every wgmma serialized (C7514), and read 2.42-4.93 ms at the LM.
//   The timeline shows the little they could hide: a warpgroup waits
//   ~0.04 us a tile for all of its own products together, and spends
//   ~2.0 us of a ~2.3 us tile issuing (the rest: the other's dS^T half,
//   ~0.2 us, stages and buffers).
// - Each tile issues the next one's S^T and dP^T (two wgmma groups) at
//   its end: the owner once dK is added, under its hand-off of dQ; the
//   other before it adds dK, under that add. P is made on the SFU once
//   they have landed; dV goes out while dS is made and is added while dK
//   runs, and (the owner) dK's fragments are added while dQ runs. Every
//   group lands within its tile, and the branches around wgmma are
//   warp-uniform to ptxas (indices, loop bounds and the owner's flag
//   from a shuffle): otherwise ptxas serializes every wgmma
//   (its C7515/C7518 notes), 1.2x slower. The warpgroups take no turns
//   at issuing (named barriers a tile read 2.51 ms against 2.35-2.37
//   without, on the chain before the next tile's S^T and dP^T moved to
//   this tile's end). A warpgroup whose rows see none of a causal tile (the
//   backward's first q tile for a block's upper keys, the forward's last
//   stages for an item's lower rows) skips its products (the backward's
//   still writes a zero dS^T, and issues the dQ it owns).
// - The consumers are bound by the instructions they issue, not by the
//   tensor cores (~1.1 us of a tile's products at 1.83 GHz) or shared
//   memory (~270 KB a tile at 128 B a clock, ~1.15 us). So the tile
//   spends few of them (scripts/port_flash_bwd_timeline.py's SASS
//   census, PERF.md §6): every wgmma descriptor is an add to one address
//   field (kmajor_desc, mnmajor_desc: no descriptor register lives
//   across the loop), dS^T goes out by stmatrix, and the hi + lo split
//   turns hi back to f32 by a shift and a mask: a thread's steady tile
//   loop holds 769 static instructions where it held 1022, and the LM
//   backward reads 8.6% faster on an H100. Every dQ on one warpgroup
//   (the other then runs up to two tiles ahead, its element-wise work
//   under the owner's products, the warpgroups out of phase) read 4%
//   slower at the LM and 2% faster at BERT than this alternation: the
//   owner's chain, every tile's dQ and its hand-off, is then the tile's
//   time.
// - The backward's P is exp(s - lse) where the forward's was
//   exp(s - m) / l over running maxima (and the backward sums S^T in its
//   own order), so it is the forward's to a few f32 ulp, not bit for bit;
//   the limits of chip_smoke.py phase 2 hold each output to its plain
//   version.
//
// bf16 at D = 128, all three passes: the tensor cores (mma.sync
// m16n8k16, f32 accumulate), 4 warps a block.
// - Staging: tiles are copied as bf16 by cp.async.cg (16 bytes a copy;
//   the zero-fill form for rows past S) into a 2-stage ring, so tile
//   j + 1 loads while tile j computes. Rows are padded to D + 8 elements:
//   the 8 rows of an ldmatrix phase start 16 bytes apart in the banks, so
//   the reads are free of conflicts. Rows must start on 16 bytes; the
//   wrappers (ops/flash_attention.py) refuse inputs whose base pointer or
//   (b, s, h) strides break that.
// - Forward (D = 128): each warp owns 16 q rows; Q is loaded into
//   registers once (ldmatrix). S = Q.K^T reads K non-transposed (the
//   "col" B operand);
//   the masks (causal diagonal, ragged edge, kv_len) run only on the tiles
//   that need them; the online softmax runs on the accumulator fragments,
//   row max and sum over the 4 lanes that share a row (shfl_xor). P is
//   rounded to bf16 in registers and those registers are the A operand of
//   P.V, with V read by ldmatrix.trans.
// - dK/dV (D = 128): each warp owns 16 keys; K and V fragments are
//   re-read from shared memory, since holding them as well as the dK and
//   dV accumulators would spill. Q, dO, lse and
//   delta of each q tile ride the ring. S^T = K.Q^T and dP^T = V.dO^T run
//   on the tensor cores from exact bf16 inputs, 16 q columns at a time;
//   P^T = exp(S^T * scale - lse) and dS^T = P^T * (dP^T - delta) stay in
//   f32 registers. The reference keeps both in f32, and rounding either to
//   bf16 is a fault (chip_smoke.py:flash_faults reads ~2e-3 against the
//   4e-4 limit). So each is split into hi = bf16(x) and lo = bf16(x - hi),
//   and both go through the mma into one f32 accumulator: ~16 mantissa
//   bits. That is 6 GEMMs' worth of tensor-core work a tile instead of 4;
//   the bound stays the algorithm's 8*D flops a pair.
// - dQ (D = 128), the forward's mirror: each warp owns 16 q rows, Q and
//   dO fragments re-read from shared memory, lse and delta of its rows g
//   and g + 8 in registers; K and V ride the ring. S = Q.K^T (summed in
//   the forward's order: the forward's S bit for bit) and dP = dO.V^T
//   read K and V non-transposed;
//   P = exp(S * scale - lse) and dS = P * (dP - delta) stay in f32
//   registers, and dS, split into hi + lo, is the A operand of dS.K with K
//   read by ldmatrix.trans: 4 GEMMs' worth a tile for the algorithm's
//   6*D flops a pair.
// - Long sums (all the tensor-core kernels): the tensor cores truncate
//   where an mma adds into its accumulator, and over S = 8192 that bias
//   moved dV by 4.1e-4 of its norm, past the 4e-4 limit. So the products
//   of one kv tile (forward, dQ), of 16 q rows (mma dK/dV) or of one
//   64-row q tile (wgmma dK/dV) go to fresh fragments, and the FMA units
//   add those to the running f32 sums, rounding to nearest (the
//   forward's as O = O * alpha + P.V, 64 output columns at a time); the
//   fused backward's dQ partials of 128 keys are added in f32 in L2 by
//   the bulk reduce.
// f32 (all three passes): the FMA kernels (the f32 units, 67 TFLOP/s):
// 256 threads, each owning a 4 x 4 score micro-tile (rows ty*4+r, keys
// tx+16c) and a 4 x D/16 slice of the output; tiles staged synchronously
// in shared memory as f32 rows padded to D + 1 floats.
// Head dims: the kernels are built for D = 64, 128 and 256. The wrapper
// (ops/flash_attention.py:pad_head_dim) zero-pads any other D <= 256 to
// the next of them, and any D > 256 to a multiple of 64, and slices the
// results back: zero columns add nothing to q.k^T or to
// delta = rowsum(dO.O), and the padded output and gradient columns come out
// zero. The copies cost memory traffic (the LM path runs D = 64 and takes
// none). At D = 256 bf16 runs the FMA kernels as well: the mma kernels' dK
// and dV accumulators alone would take 256 registers a thread. There the
// FMA dQ and dK/dV kernels share one shared-memory buffer between two tiles
// (see each kernel), since their four f32 tiles pass the 227 KB limit.
// Past 256, f32 and bf16 run the *_wide_kernel FMA kernels, which sum the
// scores over 64-wide slices of D and give each block one slice of up to
// 256 output columns (grid z), recomputing the scores for it: no upper
// limit on D, at D / 256 times the score work (see the wide kernels).
// Not yet: D = 128 on wgmma (forward and backward); in-kernel GQA (the
// wrapper takes K and V already repeated).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include <algorithm>
#include <stdint.h>
#include <type_traits>

#include "hopper.cuh"

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kBQ = 64;         // q rows per tile
constexpr int kBK = 64;         // keys per tile (BLOCK_K of the plain forward)
constexpr int kThreads = 256;   // 16 x 16: ty = tid / 16, tx = tid % 16
constexpr int kPT = kBK + 1;    // padded row of a score tile
constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarpsTC = 4;             // tensor-core kernels: warps a block
constexpr int kThreadsTC = 32 * kWarpsTC;

static_assert(kBQ == 64 && kBK == 64, "the 4 x 4 micro-tiles assume 64");
static_assert(kBQ == 16 * kWarpsTC && kBK == 16 * kWarpsTC,
              "each warp of a tensor-core kernel owns 16 rows");

// The bf16 backward at D = 64 (the wgmma kernel for dQ, dK and dV): two
// consumer warpgroups and one producer warpgroup; a block owns kWgTile
// keys, 64 to each consumer warpgroup, and streams q rows kWgStep a stage
// through a kWgStages-deep ring. (kWG is every wgmma kernel's warpgroup;
// the forward's geometry is FwdGeom's.)
constexpr int kWG = 128;
constexpr int kWgThreads = 3 * kWG;
constexpr int kWgTile = 128;
constexpr int kWgStep = 64;
constexpr int kWgStages = 4;
// a stage's lse (times log2 e), then delta
constexpr int kStatStride = 2 * kWgStep;
static_assert(kWgTile == 2 * 64 && kWgStep == hopper::kSw,
              "a consumer warpgroup owns one 64-row box; a stage streams "
              "one box a tensor");

typedef __nv_bfloat16 bf16;

// The FMA kernels' element conversions (f32 inputs, and bf16 at D = 256).
__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }
template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ bf16 from_f32<bf16>(float x) {
  return __float2bfloat16_rn(x);
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
// Tensor-core helpers (ldmatrix / mma as in bnconv.cu; cp.async staging)
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

// c = a.b (a fresh accumulator: C is zero).
__device__ __forceinline__ void mma_bf16_new(float (&c)[4],
                                             const unsigned (&a)[4],
                                             unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%10,%10,%10,%10};\n"
      : "=f"(c[0]), "=f"(c[1]), "=f"(c[2]), "=f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1),
        "f"(0.f));
}

// 16 bytes global -> shared; with valid == false the 16 bytes are zeros
// (src-size 0: nothing is read from src).
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 4 : 0)
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

__device__ __forceinline__ unsigned bf16x2_bits(__nv_bfloat162 v) {
  return *reinterpret_cast<unsigned*>(&v);
}

// Two f32 as one bf16x2 register: a in the low half (the lower column of
// an mma fragment), b in the high half.
__device__ __forceinline__ unsigned pack_bf16(float a, float b) {
  return bf16x2_bits(__floats2bfloat162_rn(a, b));
}

// a ~ hi + lo with hi = bf16(a), lo = bf16(a - hi) (a - hi is exact in
// f32): about 16 mantissa bits in two bf16 operands. hi's halves go back
// to f32 by a shift and a mask of its bits (a bf16 is an f32's upper
// half): six instructions a pair, where __bfloat1622float2 took eight.
__device__ __forceinline__ void split_bf16(float a, float b, unsigned& hi,
                                           unsigned& lo) {
  hi = pack_bf16(a, b);
  lo = pack_bf16(a - __uint_as_float(hi << 16),
                 b - __uint_as_float(hi & 0xffff0000u));
}

constexpr float kLog2e = 1.4426950408889634f;
// the reference's NEG_INF score in the exponent's base-2 domain
constexpr float kNegInfLog2e = kNegInf * kLog2e;

// exp2 on the SFU (0 for -inf and for the large negative arguments of
// masked keys).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// Max and sum over the 4 lanes of a quad (one row of an mma fragment).
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(kFull, x, 1));
  return fmaxf(x, __shfl_xor_sync(kFull, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(kFull, x, 1);
  return x + __shfl_xor_sync(kFull, x, 2);
}

// Start the copy of ROWS rows of a (B, S, H, D) bf16 tensor, from sequence
// position s0, into dst (row stride D + 8 elements); rows past S are
// zero-filled and read nothing (their source is clamped to row 0).
template <int D, int ROWS>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* base,
                                          long long s_stride, int s0,
                                          int S) {
  constexpr int kChunks = D / 8;  // 16-byte copies a row
  static_assert(ROWS * kChunks % kThreadsTC == 0, "whole rounds of copies");
#pragma unroll
  for (int it = 0; it < ROWS * kChunks / kThreadsTC; ++it) {
    const int e = threadIdx.x + it * kThreadsTC;
    const int r = e / kChunks, c = e % kChunks, s = s0 + r;
    const bool ok = s < S;
    cp_async16(dst + r * (D + 8) + c * 8,
               base + (ok ? (long long)s * s_stride : 0) + c * 8, ok);
  }
}

// Start the copy of kBQ f32 values of a dense (B, H, S) row (lse: threads
// 0..63; delta: threads 64..127) from position s0; zeros past S.
static_assert(kThreadsTC == 2 * kBQ, "one thread a stat");
__device__ __forceinline__ void load_stats(float* lse_dst, float* delta_dst,
                                           const float* lse_row,
                                           const float* delta_row, int s0,
                                           int S) {
  const int e = threadIdx.x % kBQ, s = s0 + e;
  const bool ok = s < S;
  if (threadIdx.x < kBQ)
    cp_async4(lse_dst + e, lse_row + (ok ? s : 0), ok);
  else
    cp_async4(delta_dst + e, delta_row + (ok ? s : 0), ok);
}

// ---------------------------------------------------------------------------
// Forward on the FMA units (f32 inputs, and bf16 at D = 256):
// out = softmax(q k^T * scale) v, lse per row. grid (B*H, n_q); shared:
// q (kBQ x D+1), k (kBK x D+1), v (kBK x D), p (kBQ x kBK+1), all f32.
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
// dQ on the FMA units (f32 inputs, bf16 at D = 256; bf16 at D <= 128 runs
// flash_bwd_dq_mma_kernel): dq = scale * sum_j dS_j k_j,
// dS = P * (dO v^T - delta). grid (B*H, n_q); shared: q, dO, k, v (each
// 64 x D+1), dS (kBQ x kBK+1). At D = 256 the four tiles pass the 227 KB
// a block may take, so k and v share one buffer: dP = dO.v^T runs first,
// then k replaces v for S = q.k^T and dS.k (each sum in the same order).
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
  constexpr bool kShare = D > 128;
  extern __shared__ float smem[];
  float* qs = smem;
  float* dos = qs + kBQ * LD;
  float* ks = dos + kBQ * LD;
  float* vs = kShare ? ks : ks + kBK * LD;
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
    if (!kShare) stage<T, D>(ks, LD, kb, lk.s, k0, S, kBK, 1.f);
    stage<T, D>(vs, LD, vb, lv.s, k0, S, kBK, 1.f);
    __syncthreads();

    float s[4][4], dp[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[r][c] = dp[r][c] = 0.f;
    if constexpr (kShare) {
#pragma unroll 4
      for (int d = 0; d < D; ++d) {
        float g[4], bv[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) g[r] = dos[(ty * 4 + r) * LD + d];
#pragma unroll
        for (int c = 0; c < 4; ++c) bv[c] = vs[(tx + 16 * c) * LD + d];
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < 4; ++c) dp[r][c] = fmaf(g[r], bv[c], dp[r][c]);
      }
      __syncthreads();  // v is read: k takes its place
      stage<T, D>(ks, LD, kb, lk.s, k0, S, kBK, 1.f);
      __syncthreads();
#pragma unroll 4
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
    } else {
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
// dK/dV on the FMA units (f32 inputs, bf16 at D = 256; bf16 at D <= 128
// runs flash_bwd_dkv_mma_kernel): dv = sum_i P_i^T dO_i,
// dk = sum_i dS_i^T (q_i * scale). grid (B*H, n_kv); this block owns kv
// tile j and walks the q tiles. Shared: k, v, q, dO (each 64 x D+1), P^T
// and dS^T (kBK x kBQ+1), lse and delta of the q tile. At D = 256 q and
// dO share one buffer: dO for dP^T = v.dO^T, then q for S^T and dK, then
// dO again for dV (each sum in the same order).
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
  constexpr bool kShare = D > 128;
  extern __shared__ float smem[];
  float* ks = smem;
  float* vs = ks + kBK * LD;
  float* qs = vs + kBK * LD;
  float* dos = kShare ? qs : qs + kBQ * LD;
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
    if (!kShare) stage<T, D>(qs, LD, qb, lq.s, q0, S, kBQ, scale);
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
    if constexpr (kShare) {
#pragma unroll 4
      for (int d = 0; d < D; ++d) {
        float bv[4], bg[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) bv[r] = vs[(ty * 4 + r) * LD + d];
#pragma unroll
        for (int c = 0; c < 4; ++c) bg[c] = dos[(tx + 16 * c) * LD + d];
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < 4; ++c) dp[r][c] = fmaf(bv[r], bg[c], dp[r][c]);
      }
      __syncthreads();  // dO is read: q takes its place
      stage<T, D>(qs, LD, qb, lq.s, q0, S, kBQ, scale);
      __syncthreads();
#pragma unroll 4
      for (int d = 0; d < D; ++d) {
        float a[4], bq[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) a[r] = ks[(ty * 4 + r) * LD + d];
#pragma unroll
        for (int c = 0; c < 4; ++c) bq[c] = qs[(tx + 16 * c) * LD + d];
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < 4; ++c) s[r][c] = fmaf(a[r], bq[c], s[r][c]);
      }
    } else {
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

    if constexpr (kShare) {
#pragma unroll 4
      for (int qq = 0; qq < kBQ; ++qq) {
        float dr[4], qv[C];
#pragma unroll
        for (int r = 0; r < 4; ++r) dr[r] = dst[(ty * 4 + r) * kPQ + qq];
#pragma unroll
        for (int c = 0; c < C; ++c) qv[c] = qs[qq * LD + tx + 16 * c];
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < C; ++c)
            dk_acc[r][c] = fmaf(dr[r], qv[c], dk_acc[r][c]);
      }
      __syncthreads();  // q is read: dO again
      stage<T, D>(dos, LD, gb, lo.s, q0, S, kBQ, 1.f);
      __syncthreads();
#pragma unroll 4
      for (int qq = 0; qq < kBQ; ++qq) {
        float pr[4], g[C];
#pragma unroll
        for (int r = 0; r < 4; ++r) pr[r] = pt[(ty * 4 + r) * kPQ + qq];
#pragma unroll
        for (int c = 0; c < C; ++c) g[c] = dos[qq * LD + tx + 16 * c];
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < C; ++c)
            dv_acc[r][c] = fmaf(pr[r], g[c], dv_acc[r][c]);
      }
    } else {
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

// ---------------------------------------------------------------------------
// Head dims past 256 (any multiple of 64; the wrapper pads D to one) on the
// FMA units, f32 and bf16 alike. A 64-row tile of such a head does not fit
// beside its peers (fwd_smem at D = 512 would be ~410 KB), so:
// - the score products S = q.k^T (and dP = dO.v^T) are summed over 64-wide
//   slices of D staged in turn (kDC columns; the same order d = 0..D-1 as
//   the kernels above, so S is theirs);
// - each block owns one slice of up to kSlice output columns, chosen by
//   grid z, and recomputes the scores for it: O[:, c] = softmax(S).V[:, c],
//   dQ[:, c] = scale * sum dS.K[:, c], dK[:, c] = sum dS^T.(q * scale)[:, c],
//   dV[:, c] = sum P^T.dO[:, c]. delta comes in summed over the full D.
// The recomputation costs D / kSlice times the score work, the price of
// having no upper limit on D.
// ---------------------------------------------------------------------------

constexpr int kDC = 64;      // D columns per score-sum slice
constexpr int kSlice = 256;  // output columns per block
constexpr int kLDC = kDC + 1;

// Stage n_rows rows of columns [c0, c0 + width) (width <= kSlice) of a
// (B, S, H, D) tensor as f32 * mul into dst (row stride ld); rows past S
// are zero.
template <typename T>
__device__ __forceinline__ void stage_cols(float* dst, int ld, const T* base,
                                           long long s_stride, int s0, int S,
                                           int n_rows, int c0, int width,
                                           float mul) {
  for (int e = threadIdx.x; e < n_rows * kSlice; e += kThreads) {
    const int r = e / kSlice, d = e % kSlice, s = s0 + r;
    if (d < width)
      dst[r * ld + d] =
          s < S ? to_f32(base[(long long)s * s_stride + c0 + d]) * mul : 0.f;
  }
}

// s[r][c] += sum over one kDC slice of a[row r] * b[row c] (4 x 4 micro-tile
// of rows ty*4+r against rows tx+16c).
__device__ __forceinline__ void slice_products(const float* as,
                                               const float* bs, int tx,
                                               int ty, float (&s)[4][4]) {
#pragma unroll 8
  for (int d = 0; d < kDC; ++d) {
    float a[4], bk[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) a[r] = as[(ty * 4 + r) * kLDC + d];
#pragma unroll
    for (int c = 0; c < 4; ++c) bk[c] = bs[(tx + 16 * c) * kLDC + d];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[r][c] = fmaf(a[r], bk[c], s[r][c]);
  }
}

// acc[r][c] += sum over 64 rows kk of w[row ty*4+r][kk] * x[kk][tx + 16c]
// (w: ld kPT; x: ld kSlice + 1).
__device__ __forceinline__ void tile_times_slice(
    const float* w, const float* x, int tx, int ty,
    float (&acc)[4][kSlice / 16]) {
#pragma unroll 4
  for (int kk = 0; kk < 64; ++kk) {
    float wr[4], xv[kSlice / 16];
#pragma unroll
    for (int r = 0; r < 4; ++r) wr[r] = w[(ty * 4 + r) * kPT + kk];
#pragma unroll
    for (int c = 0; c < kSlice / 16; ++c)
      xv[c] = x[kk * (kSlice + 1) + tx + 16 * c];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < kSlice / 16; ++c)
        acc[r][c] = fmaf(wr[r], xv[c], acc[r][c]);
  }
}

// Forward, D > 256. grid (B*H, n_q, ceil(D / kSlice)); shared: q and k
// slices (64 x kLDC each), the v columns (kBK x kSlice+1), p (kBQ x kPT).
template <typename T>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_wide_kernel(const T* __restrict__ q, const T* __restrict__ k,
                          const T* __restrict__ v,
                          const int* __restrict__ kv_len, T* __restrict__ out,
                          float* __restrict__ lse, Layout lq, Layout lk,
                          Layout lv, int H, int S, int D, float scale,
                          int causal) {
  constexpr int C = kSlice / 16;
  extern __shared__ float smem[];
  float* qs = smem;
  float* ks = qs + kBQ * kLDC;
  float* vs = ks + kBK * kLDC;
  float* ps = vs + kBK * (kSlice + 1);

  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int n_q = gridDim.y;
  const int i = causal ? n_q - 1 - (int)blockIdx.y : (int)blockIdx.y;
  const int q0 = i * kBQ;
  const int c0 = blockIdx.z * kSlice, W = min(kSlice, D - c0);
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int limit = kv_len ? kv_len[b] : S;
  const int n_kv = (S + kBK - 1) / kBK;
  const int j_end =
      (causal && limit > 0) ? min(n_kv, last_live_kv(i) + 1) : n_kv;

  const T* qb = q + row_base(lq, b, h);
  const T* kb = k + row_base(lk, b, h);
  const T* vb = v + row_base(lv, b, h);

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
    float s[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[r][c] = 0.f;
    for (int d0 = 0; d0 < D; d0 += kDC) {
      __syncthreads();  // the last slice's (and tile's) readers are done
      stage<T, kDC>(qs, kLDC, qb + d0, lq.s, q0, S, kBQ, scale);
      stage<T, kDC>(ks, kLDC, kb + d0, lk.s, k0, S, kBK, 1.f);
      __syncthreads();
      slice_products(qs, ks, tx, ty, s);
    }
    stage_cols<T>(vs, kSlice + 1, vb, lv.s, k0, S, kBK, c0, W, 1.f);

#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int qpos = q0 + ty * 4 + r;
      float mx = -INFINITY;
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
        ps[(ty * 4 + r) * kPT + tx + 16 * c] = to_f32(from_f32<T>(p));
      }
      l[r] = l[r] * alpha + row_sum(sum);
      m[r] = m_new;
#pragma unroll
      for (int c = 0; c < C; ++c) acc[r][c] *= alpha;
    }
    __syncthreads();
    tile_times_slice(ps, vs, tx, ty, acc);
  }

  const long long o_row = (long long)H * D;
  T* ob = out + ((long long)b * S * H + h) * D + c0;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int qpos = q0 + ty * 4 + r;
    if (qpos >= S) continue;
    const float lc = fmaxf(l[r], 1e-30f);
#pragma unroll
    for (int c = 0; c < C; ++c)
      if (tx + 16 * c < W)
        ob[qpos * o_row + tx + 16 * c] = from_f32<T>(acc[r][c] / lc);
    if (tx == 0 && blockIdx.z == 0)
      lse[(long long)bh * S + qpos] = m[r] + logf(lc);
  }
}

// dQ, D > 256. grid (B*H, n_q, ceil(D / kSlice)); shared: q, dO, k, v
// slices (64 x kLDC each), the k columns (kBK x kSlice+1), dS (kBQ x kPT).
template <typename T>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dq_wide_kernel(const T* __restrict__ q, const T* __restrict__ k,
                             const T* __restrict__ v,
                             const T* __restrict__ dout,
                             const float* __restrict__ lse,
                             const float* __restrict__ delta,
                             const int* __restrict__ kv_len,
                             T* __restrict__ dq, Layout lq, Layout lk,
                             Layout lv, Layout lo, int H, int S, int D,
                             float scale, int causal) {
  constexpr int C = kSlice / 16;
  extern __shared__ float smem[];
  float* qs = smem;
  float* dos = qs + kBQ * kLDC;
  float* ks = dos + kBQ * kLDC;
  float* vs = ks + kBK * kLDC;
  float* kcols = vs + kBK * kLDC;
  float* dss = kcols + kBK * (kSlice + 1);

  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int n_q = gridDim.y;
  const int i = causal ? n_q - 1 - (int)blockIdx.y : (int)blockIdx.y;
  const int q0 = i * kBQ;
  const int c0 = blockIdx.z * kSlice, W = min(kSlice, D - c0);
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int limit = kv_len ? kv_len[b] : S;
  const int n_kv = (S + kBK - 1) / kBK;
  const int j_end =
      (causal && limit > 0) ? min(n_kv, last_live_kv(i) + 1) : n_kv;

  const T* qb = q + row_base(lq, b, h);
  const T* gb = dout + row_base(lo, b, h);
  const T* kb = k + row_base(lk, b, h);
  const T* vb = v + row_base(lv, b, h);
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
    float s[4][4], dp[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[r][c] = dp[r][c] = 0.f;
    for (int d0 = 0; d0 < D; d0 += kDC) {
      __syncthreads();
      stage<T, kDC>(qs, kLDC, qb + d0, lq.s, q0, S, kBQ, scale);
      stage<T, kDC>(dos, kLDC, gb + d0, lo.s, q0, S, kBQ, 1.f);
      stage<T, kDC>(ks, kLDC, kb + d0, lk.s, k0, S, kBK, 1.f);
      stage<T, kDC>(vs, kLDC, vb + d0, lv.s, k0, S, kBK, 1.f);
      __syncthreads();
      slice_products(qs, ks, tx, ty, s);
      slice_products(dos, vs, tx, ty, dp);
    }
    stage_cols<T>(kcols, kSlice + 1, kb, lk.s, k0, S, kBK, c0, W, 1.f);

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
    tile_times_slice(dss, kcols, tx, ty, acc);
  }

  const long long o_row = (long long)H * D;
  T* ob = dq + ((long long)b * S * H + h) * D + c0;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int qpos = q0 + ty * 4 + r;
    if (qpos >= S) continue;
#pragma unroll
    for (int c = 0; c < C; ++c)
      if (tx + 16 * c < W)
        ob[qpos * o_row + tx + 16 * c] = from_f32<T>(acc[r][c] * scale);
  }
}

// dK/dV, D > 256. grid (B*H, n_kv, ceil(D / kSlice)); this block owns kv
// tile j and output columns [c0, c0 + W), and walks the q tiles. Shared:
// k, v, q, dO slices (64 x kLDC each), one buffer of kBQ x kSlice+1 for
// the q columns (for dK) and then the dO columns (for dV), P^T and dS^T
// (kBK x kBQ+1), lse and delta of the q tile.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dkv_wide_kernel(const T* __restrict__ q,
                              const T* __restrict__ k,
                              const T* __restrict__ v,
                              const T* __restrict__ dout,
                              const float* __restrict__ lse,
                              const float* __restrict__ delta,
                              const int* __restrict__ kv_len,
                              T* __restrict__ dk, T* __restrict__ dv,
                              Layout lq, Layout lk, Layout lv, Layout lo,
                              int H, int S, int D, float scale, int causal) {
  constexpr int C = kSlice / 16;
  constexpr int kPQ = kBQ + 1;
  static_assert(kPQ == kPT, "tile_times_slice reads rows of kPT");
  extern __shared__ float smem[];
  float* ks = smem;
  float* vs = ks + kBK * kLDC;
  float* qs = vs + kBK * kLDC;
  float* dos = qs + kBQ * kLDC;
  float* cols = dos + kBQ * kLDC;
  float* pt = cols + kBQ * (kSlice + 1);
  float* dst = pt + kBK * kPQ;
  float* lse_s = dst + kBK * kPQ;
  float* delta_s = lse_s + kBQ;

  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int j = blockIdx.y;
  const int k0 = j * kBK;
  const int c0 = blockIdx.z * kSlice, W = min(kSlice, D - c0);
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int limit = kv_len ? kv_len[b] : S;
  const int n_q = (S + kBQ - 1) / kBQ;
  const int i_start = (causal && limit > 0) ? first_live_q(j) : 0;

  const T* qb = q + row_base(lq, b, h);
  const T* gb = dout + row_base(lo, b, h);
  const T* kb = k + row_base(lk, b, h);
  const T* vb = v + row_base(lv, b, h);
  float dk_acc[4][C], dv_acc[4][C];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < C; ++c) dk_acc[r][c] = dv_acc[r][c] = 0.f;

  for (int i = i_start; i < n_q; ++i) {
    const int q0 = i * kBQ;
    // transposed tiles: rows are this block's keys, columns the q rows
    float s[4][4], dp[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[r][c] = dp[r][c] = 0.f;
    for (int d0 = 0; d0 < D; d0 += kDC) {
      __syncthreads();
      stage<T, kDC>(ks, kLDC, kb + d0, lk.s, k0, S, kBK, 1.f);
      stage<T, kDC>(vs, kLDC, vb + d0, lv.s, k0, S, kBK, 1.f);
      stage<T, kDC>(qs, kLDC, qb + d0, lq.s, q0, S, kBQ, scale);
      stage<T, kDC>(dos, kLDC, gb + d0, lo.s, q0, S, kBQ, 1.f);
      if (d0 == 0)
        for (int e = threadIdx.x; e < kBQ; e += kThreads) {
          const int qpos = q0 + e;
          lse_s[e] = qpos < S ? lse[(long long)bh * S + qpos] : 0.f;
          delta_s[e] = qpos < S ? delta[(long long)bh * S + qpos] : 0.f;
        }
      __syncthreads();
      slice_products(ks, qs, tx, ty, s);
      slice_products(vs, dos, tx, ty, dp);
    }
    stage_cols<T>(cols, kSlice + 1, qb, lq.s, q0, S, kBQ, c0, W, scale);

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
    tile_times_slice(dst, cols, tx, ty, dk_acc);
    __syncthreads();  // the q columns are read: the dO columns replace them
    stage_cols<T>(cols, kSlice + 1, gb, lo.s, q0, S, kBQ, c0, W, 1.f);
    __syncthreads();
    tile_times_slice(pt, cols, tx, ty, dv_acc);
  }

  const long long o_row = (long long)H * D;
  const long long base = ((long long)b * S * H + h) * D + c0;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int kpos = k0 + ty * 4 + r;
    if (kpos >= S) continue;
#pragma unroll
    for (int c = 0; c < C; ++c)
      if (tx + 16 * c < W) {
        dk[base + kpos * o_row + tx + 16 * c] = from_f32<T>(dk_acc[r][c]);
        dv[base + kpos * o_row + tx + 16 * c] = from_f32<T>(dv_acc[r][c]);
      }
  }
}

// ---------------------------------------------------------------------------
// bf16 forward on mma.sync, D = 128 (D = 64 runs flash_fwd_wgmma_kernel).
// grid (B*H, n_q), kThreadsTC threads; warp w owns q rows 16w..16w+15.
// Shared (bf16, rows of D + 8): q (kBQ), k and v rings (2 x kBK each).
// ---------------------------------------------------------------------------

template <int D>
__global__ void __launch_bounds__(kThreadsTC)
    flash_fwd_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                         const bf16* __restrict__ v,
                         const int* __restrict__ kv_len, bf16* __restrict__ out,
                         float* __restrict__ lse, Layout lq, Layout lk,
                         Layout lv, int H, int S, float scale, int causal) {
  constexpr int LDS = D + 8;
  constexpr int KD = D / 16;    // k-steps of S = Q.K^T
  constexpr int ND = D / 8;     // 8-wide column tiles of the output
  constexpr int NK = kBK / 8;   // 8-wide key tiles of S
  constexpr int kOut = 8;       // output tiles a P.V chunk
  static_assert(ND % kOut == 0, "whole P.V chunks");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* ks = qs + kBQ * LDS;
  bf16* vs = ks + 2 * kBK * LDS;

  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int n_q = gridDim.y;
  const int i = causal ? n_q - 1 - (int)blockIdx.y : (int)blockIdx.y;
  const int q0 = i * kBQ;
  const int lane = threadIdx.x % 32, w0 = (threadIdx.x / 32) * 16;
  const int g = lane >> 2, t = lane & 3;  // fragment row and column pair
  const int limit = kv_len ? kv_len[b] : S;
  const int n_kv = (S + kBK - 1) / kBK;
  const int j_end =
      (causal && limit > 0) ? min(n_kv, last_live_kv(i) + 1) : n_kv;

  const bf16* kb = k + row_base(lk, b, h);
  const bf16* vb = v + row_base(lv, b, h);
  load_tile<D, kBQ>(qs, q + row_base(lq, b, h), lq.s, q0, S);
  load_tile<D, kBK>(ks, kb, lk.s, 0, S);
  load_tile<D, kBK>(vs, vb, lv.s, 0, S);
  cp_async_commit();

  // rows g and g + 8 of the warp's 16: m, l, and the output fragments
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  float o[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
  unsigned qf[KD][4];

  for (int j = 0; j < j_end; ++j) {
    const int stage = j & 1;
    if (j + 1 < j_end) {  // the next tile loads while this one computes
      load_tile<D, kBK>(ks + (stage ^ 1) * kBK * LDS, kb, lk.s,
                        (j + 1) * kBK, S);
      load_tile<D, kBK>(vs + (stage ^ 1) * kBK * LDS, vb, lv.s,
                        (j + 1) * kBK, S);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (j == 0) {
#pragma unroll
      for (int kd = 0; kd < KD; ++kd)
        ldsm_x4(qf[kd], qs + (w0 + (lane & 15)) * LDS + kd * 16 +
                            (lane >> 4) * 8);
    }
    const bf16* kt = ks + stage * kBK * LDS;
    const bf16* vt = vs + stage * kBK * LDS;
    const int k0 = j * kBK;

    // S = Q.K^T: key tiles 2n and 2n + 1 from one ldmatrix.x4 of K rows
    float s[NK][4];
#pragma unroll
    for (int n = 0; n < NK; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
    for (int kd = 0; kd < KD; ++kd) {
#pragma unroll
      for (int n = 0; n < NK / 2; ++n) {
        unsigned r[4];
        ldsm_x4(r, kt + (n * 16 + (lane & 7) + ((lane >> 4) << 3)) * LDS +
                       kd * 16 + ((lane >> 3) & 1) * 8);
        mma_bf16(s[2 * n], qf[kd], r[0], r[1]);
        mma_bf16(s[2 * n + 1], qf[kd], r[2], r[3]);
      }
    }

    // scale, then the masks on the tiles that need them; keys past S do
    // not exist (-inf: out of the max, P = 0)
    const bool edge = (causal && k0 + kBK - 1 > q0) || k0 + kBK > S ||
                      k0 + kBK > limit;
#pragma unroll
    for (int n = 0; n < NK; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[n][e] *= scale;
        if (edge) {
          const int qpos = q0 + w0 + g + (e >> 1) * 8;
          const int kpos = k0 + n * 8 + 2 * t + (e & 1);
          s[n][e] = kpos < S ? mask_score(s[n][e], qpos, kpos, limit, causal)
                             : -INFINITY;
        }
      }

    // online softmax on the fragments; P rounded to bf16 becomes the A
    // operand of P.V (key tiles 2kk, 2kk + 1 are k-step kk)
    float alpha[2], mn[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = -INFINITY;
#pragma unroll
      for (int n = 0; n < NK; ++n)
        mx = fmaxf(mx, fmaxf(s[n][2 * r], s[n][2 * r + 1]));
      mn[r] = fmaxf(m[r], quad_max(mx));
      alpha[r] = expf(m[r] - mn[r]);
    }
    unsigned pf[kBK / 16][4];
#pragma unroll
    for (int n = 0; n < NK; ++n) {
      float p[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) p[e] = expf(s[n][e] - mn[e >> 1]);
      sum[0] += p[0] + p[1];  // l sums the f32 values
      sum[1] += p[2] + p[3];
      pf[n >> 1][(n & 1) * 2] = pack_bf16(p[0], p[1]);
      pf[n >> 1][(n & 1) * 2 + 1] = pack_bf16(p[2], p[3]);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] = l[r] * alpha[r] + quad_sum(sum[r]);
      m[r] = mn[r];
    }

    // O = O * alpha + P.V (V rows are the k dim, read transposed). The
    // tile's P.V goes to fresh fragments, 64 columns at a time, and is
    // added to O in f32: the tensor cores truncate where they add into
    // an accumulator, a bias that would grow over a long kv loop.
#pragma unroll
    for (int c0 = 0; c0 < ND; c0 += kOut) {
      float pv[kOut][4];
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk) {
#pragma unroll
        for (int n = 0; n < kOut / 2; ++n) {
          unsigned r[4];
          ldsm_x4_t(r, vt + (kk * 16 + (lane & 15)) * LDS + (c0 + 2 * n) * 8 +
                           (lane >> 4) * 8);
          if (kk == 0) {
            mma_bf16_new(pv[2 * n], pf[kk], r[0], r[1]);
            mma_bf16_new(pv[2 * n + 1], pf[kk], r[2], r[3]);
          } else {
            mma_bf16(pv[2 * n], pf[kk], r[0], r[1]);
            mma_bf16(pv[2 * n + 1], pf[kk], r[2], r[3]);
          }
        }
      }
#pragma unroll
      for (int n = 0; n < kOut; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          o[c0 + n][e] = fmaf(o[c0 + n][e], alpha[e >> 1], pv[n][e]);
    }
    __syncthreads();  // this stage is free for the load two tiles on
  }

  const long long o_row = (long long)H * D;  // out is (B, S, H, D) dense
  bf16* ob = out + ((long long)b * S * H + h) * D;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qpos = q0 + w0 + g + r * 8;
    if (qpos >= S) continue;
    const float lc = fmaxf(l[r], 1e-30f);
#pragma unroll
    for (int n = 0; n < ND; ++n)
      *reinterpret_cast<__nv_bfloat162*>(ob + qpos * o_row + n * 8 + 2 * t) =
          __floats2bfloat162_rn(o[n][2 * r] / lc, o[n][2 * r + 1] / lc);
    if (t == 0) lse[(long long)bh * S + qpos] = m[r] + logf(lc);
  }
}

// ---------------------------------------------------------------------------
// bf16 dK/dV on mma.sync, D = 128 (D = 64 runs flash_bwd_wgmma_kernel).
// grid (B*H, n_kv), kThreadsTC threads; warp w owns keys 16w..16w+15 of
// kv tile j and walks the q tiles. Shared (bf16, rows of D + 8): k, v
// (kBK each), q and dO rings (2 x kBQ each); f32 lse and delta rings.
// ---------------------------------------------------------------------------

template <int D>
__global__ void __launch_bounds__(kThreadsTC)
    flash_bwd_dkv_mma_kernel(const bf16* __restrict__ q,
                             const bf16* __restrict__ k,
                             const bf16* __restrict__ v,
                             const bf16* __restrict__ dout,
                             const float* __restrict__ lse,
                             const float* __restrict__ delta,
                             const int* __restrict__ kv_len,
                             bf16* __restrict__ dk, bf16* __restrict__ dv,
                             Layout lq, Layout lk, Layout lv, Layout lo, int H,
                             int S, float scale, int causal) {
  constexpr int LDS = D + 8;
  constexpr int KD = D / 16;    // k-steps of S^T = K.Q^T and dP^T = V.dO^T
  constexpr int ND = D / 8;     // 8-wide column tiles of dK and dV
  static_assert(D == 128, "D = 64 runs the wgmma kernel");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* ks = reinterpret_cast<bf16*>(smem_raw);
  bf16* vs = ks + kBK * LDS;
  bf16* qs = vs + kBK * LDS;
  bf16* gs = qs + 2 * kBQ * LDS;
  float* lse_s = reinterpret_cast<float*>(gs + 2 * kBQ * LDS);
  float* delta_s = lse_s + 2 * kBQ;

  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int j = blockIdx.y;
  const int k0 = j * kBK;
  const int lane = threadIdx.x % 32, w0 = (threadIdx.x / 32) * 16;
  const int g = lane >> 2, t = lane & 3;
  const int limit = kv_len ? kv_len[b] : S;
  const int n_q = (S + kBQ - 1) / kBQ;
  const int i_start = (causal && limit > 0) ? first_live_q(j) : 0;

  const bf16* qb = q + row_base(lq, b, h);
  const bf16* gb = dout + row_base(lo, b, h);
  const float* lse_row = lse + (long long)bh * S;
  const float* delta_row = delta + (long long)bh * S;
  load_tile<D, kBK>(ks, k + row_base(lk, b, h), lk.s, k0, S);
  load_tile<D, kBK>(vs, v + row_base(lv, b, h), lv.s, k0, S);
  load_tile<D, kBQ>(qs, qb, lq.s, i_start * kBQ, S);
  load_tile<D, kBQ>(gs, gb, lo.s, i_start * kBQ, S);
  load_stats(lse_s, delta_s, lse_row, delta_row, i_start * kBQ, S);
  cp_async_commit();

  float dka[ND][4], dva[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[n][e] = dva[n][e] = 0.f;

  for (int i = i_start; i < n_q; ++i) {
    const int stage = (i - i_start) & 1;
    if (i + 1 < n_q) {  // the next q tile loads while this one computes
      const int nxt = stage ^ 1, s0 = (i + 1) * kBQ;
      load_tile<D, kBQ>(qs + nxt * kBQ * LDS, qb, lq.s, s0, S);
      load_tile<D, kBQ>(gs + nxt * kBQ * LDS, gb, lo.s, s0, S);
      load_stats(lse_s + nxt * kBQ, delta_s + nxt * kBQ, lse_row,
                 delta_row, s0, S);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* qt = qs + stage * kBQ * LDS;
    const bf16* gt = gs + stage * kBQ * LDS;
    const float* lt = lse_s + stage * kBQ;
    const float* dt = delta_s + stage * kBQ;
    const int q0 = i * kBQ;
    const bool edge = (causal && k0 + kBK - 1 > q0) || q0 + kBQ > S ||
                      k0 + kBK > limit;

    // (not unrolled: unrolled, it keeps every iteration's addresses live
    // and spills)
#pragma unroll 1
    for (int c = 0; c < kBQ / 16; ++c) {  // 16 q columns at a time
      // S^T and dP^T: 16 keys x 16 q, as q tiles 0 and 1 of 8
      float st[2][4], dpt[2][4];
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) st[n][e] = dpt[n][e] = 0.f;
#pragma unroll
      for (int kd = 0; kd < KD; ++kd) {
        unsigned ak[4], av[4], rq[4], rg[4];
        const int off = (w0 + (lane & 15)) * LDS + kd * 16 + (lane >> 4) * 8;
        ldsm_x4(ak, ks + off);
        ldsm_x4(av, vs + off);
        const int boff = (c * 16 + (lane & 7) + ((lane >> 4) << 3)) * LDS +
                         kd * 16 + ((lane >> 3) & 1) * 8;
        ldsm_x4(rq, qt + boff);
        ldsm_x4(rg, gt + boff);
        mma_bf16(st[0], ak, rq[0], rq[1]);
        mma_bf16(st[1], ak, rq[2], rq[3]);
        mma_bf16(dpt[0], av, rg[0], rg[1]);
        mma_bf16(dpt[1], av, rg[2], rg[3]);
      }

      // P^T and dS^T in f32, then each split into hi + lo bf16 A operands
      // (k = these 16 q: q tile n holds registers 2n and 2n + 1)
      unsigned ph[4], pl[4], dh[4], dl[4];
#pragma unroll
      for (int n = 0; n < 2; ++n) {
        const int qc = c * 16 + n * 8 + 2 * t;  // column of e = 0 and 2
        const float2 l2 = *reinterpret_cast<const float2*>(lt + qc);
        const float2 d2 = *reinterpret_cast<const float2*>(dt + qc);
        float p[4], ds[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float lq_e = (e & 1) ? l2.y : l2.x;
          const float dq_e = (e & 1) ? d2.y : d2.x;
          float sc = st[n][e] * scale;
          if (edge) {
            const int qpos = q0 + qc + (e & 1);
            const int kpos = k0 + w0 + g + (e >> 1) * 8;
            sc = mask_score(sc, qpos, kpos, limit, causal);
            p[e] = qpos < S ? expf(sc - lq_e) : 0.f;
          } else {
            p[e] = expf(sc - lq_e);
          }
          ds[e] = p[e] * (dpt[n][e] - dq_e);
        }
        split_bf16(p[0], p[1], ph[2 * n], pl[2 * n]);
        split_bf16(p[2], p[3], ph[2 * n + 1], pl[2 * n + 1]);
        split_bf16(ds[0], ds[1], dh[2 * n], dl[2 * n]);
        split_bf16(ds[2], ds[3], dh[2 * n + 1], dl[2 * n + 1]);
      }

      // dV += P^T.dO and dK += dS^T.q over these 16 q rows (read
      // transposed: q rows are the k dim). hi and lo go to fresh
      // fragments that are added to dV and dK in f32: the tensor cores
      // truncate where they add into an accumulator, a bias that over a
      // long q loop moved dV by ~4e-4 of its norm at S = 8192.
#pragma unroll
      for (int n = 0; n < ND / 2; ++n) {
        unsigned rg[4], rq[4];
        const int boff = (c * 16 + (lane & 15)) * LDS + n * 16 +
                         (lane >> 4) * 8;
        ldsm_x4_t(rg, gt + boff);
        ldsm_x4_t(rq, qt + boff);
        float pv[4][4];
        mma_bf16_new(pv[0], ph, rg[0], rg[1]);
        mma_bf16(pv[0], pl, rg[0], rg[1]);
        mma_bf16_new(pv[1], ph, rg[2], rg[3]);
        mma_bf16(pv[1], pl, rg[2], rg[3]);
        mma_bf16_new(pv[2], dh, rq[0], rq[1]);
        mma_bf16(pv[2], dl, rq[0], rq[1]);
        mma_bf16_new(pv[3], dh, rq[2], rq[3]);
        mma_bf16(pv[3], dl, rq[2], rq[3]);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          dva[2 * n][e] += pv[0][e];
          dva[2 * n + 1][e] += pv[1][e];
          dka[2 * n][e] += pv[2][e];
          dka[2 * n + 1][e] += pv[3][e];
        }
      }
    }
    __syncthreads();  // this stage is free for the load two tiles on
  }

  const long long o_row = (long long)H * D;
  const long long base = ((long long)b * S * H + h) * D;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int kpos = k0 + w0 + g + r * 8;
    if (kpos >= S) continue;
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      const long long at = base + kpos * o_row + n * 8 + 2 * t;
      *reinterpret_cast<__nv_bfloat162*>(dk + at) = __floats2bfloat162_rn(
          dka[n][2 * r] * scale, dka[n][2 * r + 1] * scale);
      *reinterpret_cast<__nv_bfloat162*>(dv + at) =
          __floats2bfloat162_rn(dva[n][2 * r], dva[n][2 * r + 1]);
    }
  }
}

// ---------------------------------------------------------------------------
// bf16 dQ on mma.sync, D = 128 (D = 64 runs flash_bwd_wgmma_kernel).
// grid (B*H, n_q), kThreadsTC threads; warp w owns q rows 16w..16w+15 of
// q tile i and walks the kv tiles. Shared (bf16, rows of D + 8): q and dO
// (kBQ each), k and v rings (2 x kBK each).
// ---------------------------------------------------------------------------

template <int D>
__global__ void __launch_bounds__(kThreadsTC)
    flash_bwd_dq_mma_kernel(const bf16* __restrict__ q,
                            const bf16* __restrict__ k,
                            const bf16* __restrict__ v,
                            const bf16* __restrict__ dout,
                            const float* __restrict__ lse,
                            const float* __restrict__ delta,
                            const int* __restrict__ kv_len,
                            bf16* __restrict__ dq, Layout lq, Layout lk,
                            Layout lv, Layout lo, int H, int S, float scale,
                            int causal) {
  constexpr int LDS = D + 8;
  constexpr int KD = D / 16;    // k-steps of S = Q.K^T and dP = dO.V^T
  constexpr int ND = D / 8;     // 8-wide column tiles of dQ
  constexpr int NK = kBK / 8;   // 8-wide key tiles of S and dP
  constexpr int kOut = 8;                // dQ tiles a dS.K chunk
  static_assert(D == 128, "D = 64 runs the wgmma kernel");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* gs = qs + kBQ * LDS;
  bf16* ks = gs + kBQ * LDS;
  bf16* vs = ks + 2 * kBK * LDS;

  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int n_q = gridDim.y;
  const int i = causal ? n_q - 1 - (int)blockIdx.y : (int)blockIdx.y;
  const int q0 = i * kBQ;
  const int lane = threadIdx.x % 32, w0 = (threadIdx.x / 32) * 16;
  const int g = lane >> 2, t = lane & 3;  // fragment row and column pair
  const int limit = kv_len ? kv_len[b] : S;
  const int n_kv = (S + kBK - 1) / kBK;
  const int j_end =
      (causal && limit > 0) ? min(n_kv, last_live_kv(i) + 1) : n_kv;

  const bf16* kb = k + row_base(lk, b, h);
  const bf16* vb = v + row_base(lv, b, h);
  load_tile<D, kBQ>(qs, q + row_base(lq, b, h), lq.s, q0, S);
  load_tile<D, kBQ>(gs, dout + row_base(lo, b, h), lo.s, q0, S);
  load_tile<D, kBK>(ks, kb, lk.s, 0, S);
  load_tile<D, kBK>(vs, vb, lv.s, 0, S);
  cp_async_commit();

  // lse and delta of rows g and g + 8 (rows past S are never stored)
  float lse_r[2], delta_r[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qpos = q0 + w0 + g + r * 8;
    const bool in = qpos < S;
    lse_r[r] = in ? lse[(long long)bh * S + qpos] : 0.f;
    delta_r[r] = in ? delta[(long long)bh * S + qpos] : 0.f;
  }
  float dqa[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dqa[n][e] = 0.f;

  for (int j = 0; j < j_end; ++j) {
    const int stage = j & 1;
    if (j + 1 < j_end) {  // the next tile loads while this one computes
      load_tile<D, kBK>(ks + (stage ^ 1) * kBK * LDS, kb, lk.s,
                        (j + 1) * kBK, S);
      load_tile<D, kBK>(vs + (stage ^ 1) * kBK * LDS, vb, lv.s,
                        (j + 1) * kBK, S);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* kt = ks + stage * kBK * LDS;
    const bf16* vt = vs + stage * kBK * LDS;
    const int k0 = j * kBK;

    // S = Q.K^T and dP = dO.V^T: key tiles 2n and 2n + 1 from one
    // ldmatrix.x4 of K (V) rows; S sums in the forward's order, so it is
    // the forward's S bit for bit
    float s[NK][4], dp[NK][4];
#pragma unroll
    for (int n = 0; n < NK; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll
    for (int kd = 0; kd < KD; ++kd) {
      unsigned aq[4], ag[4];
      const int off = (w0 + (lane & 15)) * LDS + kd * 16 + (lane >> 4) * 8;
      ldsm_x4(aq, qs + off);
      ldsm_x4(ag, gs + off);
#pragma unroll
      for (int n = 0; n < NK / 2; ++n) {
        unsigned rk[4], rv[4];
        const int boff = (n * 16 + (lane & 7) + ((lane >> 4) << 3)) * LDS +
                         kd * 16 + ((lane >> 3) & 1) * 8;
        ldsm_x4(rk, kt + boff);
        ldsm_x4(rv, vt + boff);
        mma_bf16(s[2 * n], aq, rk[0], rk[1]);
        mma_bf16(s[2 * n + 1], aq, rk[2], rk[3]);
        mma_bf16(dp[2 * n], ag, rv[0], rv[1]);
        mma_bf16(dp[2 * n + 1], ag, rv[2], rv[3]);
      }
    }

    // P = exp(S * scale - lse) and dS = P * (dP - delta) in f32, the masks
    // only on the tiles that need them (keys past S: P = 0); dS split into
    // hi + lo bf16 A operands of dS.K (key tiles 2kk, 2kk + 1 are k-step
    // kk)
    const bool edge = (causal && k0 + kBK - 1 > q0) || k0 + kBK > S ||
                      k0 + kBK > limit;
    unsigned dh[kBK / 16][4], dl[kBK / 16][4];
#pragma unroll
    for (int n = 0; n < NK; ++n) {
      float ds[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        float sc = s[n][e] * scale, p;
        if (edge) {
          const int qpos = q0 + w0 + g + r * 8;
          const int kpos = k0 + n * 8 + 2 * t + (e & 1);
          sc = mask_score(sc, qpos, kpos, limit, causal);
          p = kpos < S ? expf(sc - lse_r[r]) : 0.f;
        } else {
          p = expf(sc - lse_r[r]);
        }
        ds[e] = p * (dp[n][e] - delta_r[r]);
      }
      split_bf16(ds[0], ds[1], dh[n >> 1][(n & 1) * 2],
                 dl[n >> 1][(n & 1) * 2]);
      split_bf16(ds[2], ds[3], dh[n >> 1][(n & 1) * 2 + 1],
                 dl[n >> 1][(n & 1) * 2 + 1]);
    }

    // dQ += dS.K (K rows are the k dim, read transposed). hi and lo go to
    // fresh fragments, 64 columns at a time, that the FMA units add to dQ
    // rounding to nearest: the tensor cores truncate where they add into
    // an accumulator, a bias that would grow over the kv loop.
#pragma unroll
    for (int c0 = 0; c0 < ND; c0 += kOut) {
      float pv[kOut][4];
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk) {
#pragma unroll
        for (int n = 0; n < kOut / 2; ++n) {
          unsigned r[4];
          ldsm_x4_t(r, kt + (kk * 16 + (lane & 15)) * LDS + (c0 + 2 * n) * 8 +
                           (lane >> 4) * 8);
          if (kk == 0) {
            mma_bf16_new(pv[2 * n], dh[kk], r[0], r[1]);
            mma_bf16_new(pv[2 * n + 1], dh[kk], r[2], r[3]);
          } else {
            mma_bf16(pv[2 * n], dh[kk], r[0], r[1]);
            mma_bf16(pv[2 * n + 1], dh[kk], r[2], r[3]);
          }
          mma_bf16(pv[2 * n], dl[kk], r[0], r[1]);
          mma_bf16(pv[2 * n + 1], dl[kk], r[2], r[3]);
        }
      }
#pragma unroll
      for (int n = 0; n < kOut; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) dqa[c0 + n][e] += pv[n][e];
    }
    __syncthreads();  // this stage is free for the load two tiles on
  }

  const long long o_row = (long long)H * D;  // dq is (B, S, H, D) dense
  bf16* ob = dq + ((long long)b * S * H + h) * D;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qpos = q0 + w0 + g + r * 8;
    if (qpos >= S) continue;
#pragma unroll
    for (int n = 0; n < ND; ++n)
      *reinterpret_cast<__nv_bfloat162*>(ob + qpos * o_row + n * 8 + 2 * t) =
          __floats2bfloat162_rn(dqa[n][2 * r] * scale,
                                dqa[n][2 * r + 1] * scale);
  }
}

// ---------------------------------------------------------------------------
// bf16 flash backward in one pass on wgmma (D = 64): dQ, dK and dV.
// A persistent grid: every block takes items from counters[0] in the
// order of the list. Item x is head bh = x / n_work, entry x % n_work of
// `work`: (kv tile, first q tile, end q tile), in descending kv tile (the
// order dQ's adds land in). Threads 0..255 are two consumer warpgroups
// (warpgroup wg owns keys kw = k0 + 64 wg .. kw + 63); of the producer
// warpgroup (256..383) warp 0 takes the items and feeds the ring, warps
// 1..kDqBufs (the adders) add the q tiles' dQ partials into the f32
// workspace (B, S, H, D) through map_ws, adder a the tiles of the block's
// walk whose count is a modulo kDqBufs. Shared memory from a 1024-byte
// boundary (bwd_bytes_to): K (2 boxes) and V (2 boxes) resident; a ring
// of kWgStages stages of (Q box, dO box); two buffers of dS^T (hi and lo
// of each warpgroup's 64 keys: 4 boxes); kDqBufs buffers of a q tile's
// dQ partial (64 x 64 f32 as two boxes of 32 columns, rows of 128 bytes
// in the 128-byte swizzle); each stage's lse and delta; the barriers;
// two item slots.
// ---------------------------------------------------------------------------

// named barrier kDsBar + wg: the owner warpgroup's four warps have
// stored their dS^T half
constexpr int kDsBar = 1;
constexpr int kDqBufs = 3;  // dQ partials in flight to the adders
constexpr int kDqBytes = kWgStep * 64 * 4;  // a q tile's dQ partial, f32
// full, empty (a stage each); res full, empty; item full, empty, dS
// full (the other warpgroup's half in), dS free (the owner's dQ read it)
// (two each); dQ full, empty (a buffer each)
constexpr int kBwdBars = 2 * kWgStages + 2 + 8 + 2 * kDqBufs;
static_assert(kDqBufs <= 3, "the adders are the producer warpgroup's "
                            "warps 1..3");

// Byte offset of part p of the fused backward's shared memory: 0 K and V,
// 1 the ring, 2 dS^T, 3 dQ, 4 stats, 5 barriers, 6 item slots, 7 the end.
__host__ __device__ constexpr uint32_t bwd_bytes_to(int p) {
  return p == 0   ? 0u
         : p == 1 ? 4u * hopper::kBox
         : p == 2 ? (4u + 2u * kWgStages) * hopper::kBox
         : p == 3 ? bwd_bytes_to(2) + 8u * hopper::kBox
         : p == 4 ? bwd_bytes_to(3) + kDqBufs * kDqBytes
         : p == 5 ? bwd_bytes_to(4) + kWgStages * kStatStride * 4u
         : p == 6 ? bwd_bytes_to(5) + kBwdBars * 8u
                  : bwd_bytes_to(6) + 2u * 4u;
}

// One item: its head, its 128 keys from k0, the q tiles [lo, hi) it walks.
struct BwdItem {
  int bh, b, h, j, k0, lo, hi, trim, limit;
};

__device__ __forceinline__ BwdItem bwd_item(int x, const int* work,
                                            int n_work, const int* kv_len,
                                            int H, int S, int causal) {
  BwdItem w;
  w.bh = x / n_work;
  const int* e = work + 3 * (x % n_work);
  w.b = w.bh / H;
  w.h = w.bh % H;
  w.j = e[0];
  w.k0 = e[0] * kWgTile;
  w.limit = kv_len ? kv_len[w.b] : S;
  // a kv_len == 0 row has every key masked and walks every q tile
  w.trim = causal && w.limit > 0;
  w.lo = w.trim ? e[1] : 0;
  w.hi = w.trim ? e[2] : (S + kWgStep - 1) / kWgStep;
  return w;
}

// How many kv tiles add into q tile i before this item's does: the adds
// land in descending kv tile, from the last kv tile live for the q tile
// (the reference's _last_live_kv at 64-row q tiles and 128-key kv tiles
// where the walk is trimmed, else the last kv tile).
__device__ __forceinline__ int bwd_turn(const BwdItem& w, int i, int S) {
  const int n_kv = (S + kWgTile - 1) / kWgTile;
  const int last =
      w.trim ? min(n_kv - 1, (i * kWgStep + kWgStep - 1) / kWgTile)
             : n_kv - 1;
  return last - w.j;
}

__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.b32 %0, [%1];\n"
               : "=r"(v)
               : "l"(p)
               : "memory");
  return v;
}

// After this thread's TMA stores or reduce-adds have completed: order
// their global writes before one more add on *p, which another block
// acquires.
__device__ __forceinline__ void red_release(int* p) {
  asm volatile(
      "fence.proxy.async.global;\n"
      "red.release.gpu.global.add.s32 [%0], 1;\n" ::"l"(p)
      : "memory");
}

// dS^T (hi and lo bf16 A fragments: k-step kk is q columns 16kk..16kk+15)
// of this warp's 16 keys into the warpgroup's two boxes from ds (shared
// window): rows are keys, 128-byte swizzle, as TMA lays out a K box. One
// stmatrix of four 8 x 8 matrices a k-step and box: matrix m of k-step kk
// is rows 8 (m & 1) + 0..7 of the warp's 16 and 16-byte chunk
// 2 kk + (m >> 1), the fragment's register m; lane 8 m + r gives its row
// r's address (ds_offset), and the 8 rows of a matrix land in 8 distinct
// chunks of the swizzle, so no bank is hit twice.
__device__ __forceinline__ uint32_t ds_offset(int warp, int lane, int kk) {
  return hopper::sw128(16 * warp + 8 * ((lane >> 3) & 1) + (lane & 7),
                       2 * kk + (lane >> 4));
}
__device__ __forceinline__ void store_ds(uint32_t ds,
                                         const uint32_t (&dh)[4][4],
                                         const uint32_t (&dl)[4][4],
                                         int warp, int lane) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const uint32_t at = ds + ds_offset(warp, lane, kk);
    hopper::stsm_x4(at, dh[kk][0], dh[kk][1], dh[kk][2], dh[kk][3]);
    hopper::stsm_x4(at + hopper::kBox, dl[kk][0], dl[kk][1], dl[kk][2],
                    dl[kk][3]);
  }
}

// Offsets of a wgmma descriptor's address field (16-byte units): a box,
// a k-step of 16 rows MN-major (2048 bytes) or of 16 columns K-major (32
// bytes). The fused backward keeps one address field (its shared
// memory's base) and makes every descriptor by hopper::wgmma_desc16 on
// it plus these: one add each, where wgmma_desc on a pointer took five
// operations, and no descriptor holds a register across the tile loop
// (made once as 64-bit values, they spilled). K-major operands have
// lbo 16 bytes, MN-major ones one box.
constexpr uint32_t kBox16 = hopper::kBox / 16;
constexpr uint32_t kRows16 = 16 * 128 / 16;
constexpr uint32_t kCols16 = 32 / 16;
__device__ __forceinline__ uint64_t kmajor_desc(uint32_t a16) {
  return hopper::wgmma_desc16(a16, 16, 1024);
}
__device__ __forceinline__ uint64_t mnmajor_desc(uint32_t a16) {
  return hopper::wgmma_desc16(a16, hopper::kBox, 1024);
}

// fq (64 q rows x 64 head columns) = dS.K over the block's 128 keys, hi
// then lo of each 16 keys (one group, a fresh sum): A is the dS^T buffer
// from address field ds (warpgroup kb's hi and lo at boxes 2 kb and
// 2 kb + 1) read MN-major through the transpose bit, B the resident K
// (box kb from address field k), MN-major through the transpose bit too.
__device__ __forceinline__ void dq_product(float (&fq)[32], uint32_t ds,
                                           uint32_t k) {
  using namespace hopper;
  wgmma_fence();
#pragma unroll
  for (int kb = 0; kb < 2; ++kb)
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint64_t bd = mnmajor_desc(k + kb * kBox16 + kk * kRows16);
      const uint32_t a = ds + 2 * kb * kBox16 + kk * kRows16;
      wgmma_m64n64_ss_tt(fq, mnmajor_desc(a), bd, kb + kk > 0);
      wgmma_m64n64_ss_tt(fq, mnmajor_desc(a + kBox16), bd, 1);
    }
  wgmma_commit();
}

template <int D>
__global__ void __launch_bounds__(kWgThreads, 1)
    flash_bwd_wgmma_kernel(const __grid_constant__ CUtensorMap map_q,
                           const __grid_constant__ CUtensorMap map_k,
                           const __grid_constant__ CUtensorMap map_v,
                           const __grid_constant__ CUtensorMap map_g,
                           const __grid_constant__ CUtensorMap map_ws,
                           const float* __restrict__ lse,
                           const float* __restrict__ delta,
                           const int* __restrict__ kv_len,
                           const int* __restrict__ work, int n_work,
                           int n_items, int* __restrict__ counters,
                           bf16* __restrict__ dk,
                           bf16* __restrict__ dv, int H, int S, float scale,
                           int causal) {
  static_assert(D == hopper::kSw, "a head is one 128-byte swizzled row");
  using namespace hopper;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* smem = smem_raw;
  const uint32_t base = ring_base(smem);
  const uint32_t res = base + bwd_bytes_to(0);   // K, then V
  const uint32_t ring = base + bwd_bytes_to(1);  // stage s: Q, dO
  const uint32_t dsb = base + bwd_bytes_to(2);   // buffer x: wg 0, wg 1
  const uint32_t dqb = base + bwd_bytes_to(3);   // buffer x: 64 x 64 f32
  const uint32_t bars = base + bwd_bytes_to(5);
  auto gen = [&](uint32_t a) { return smem + (a - smem_u32(smem)); };
  float* stats_gen = reinterpret_cast<float*>(gen(base + bwd_bytes_to(4)));
  volatile int* slots =
      reinterpret_cast<volatile int*>(gen(base + bwd_bytes_to(6)));
  auto full = [&](int s) { return bars + 8 * s; };
  auto empty = [&](int s) { return bars + 8 * (kWgStages + s); };
  const uint32_t res_full = bars + 16 * kWgStages;
  const uint32_t res_empty = res_full + 8;
  auto item_full = [&](int x) { return res_full + 16 + 8 * x; };
  auto item_empty = [&](int x) { return res_full + 32 + 8 * x; };
  auto ds_full = [&](int x) { return res_full + 48 + 8 * x; };
  auto ds_free = [&](int x) { return res_full + 64 + 8 * x; };
  auto dq_full = [&](int x) { return res_full + 80 + 8 * x; };
  auto dq_empty = [&](int x) { return res_full + 80 + 8 * (kDqBufs + x); };
  const int n_q = (S + kWgStep - 1) / kWgStep;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kWgStages; ++s) {
      mbar_init(full(s), 32);  // the producer warp's lanes, lane 0 with bytes
      mbar_init(empty(s), 8);  // one arrival per consumer warp
    }
    mbar_init(res_full, 1);
    mbar_init(res_empty, 8);
    for (int x = 0; x < 2; ++x) {
      mbar_init(item_full(x), 1);  // the producer's lane 0
      // the consumer warps and the adders
      mbar_init(item_empty(x), 8 + kDqBufs);
      // buffer x is warpgroup x's (its dQ reads it): full takes the other
      // warpgroup's warps, free the owner's
      mbar_init(ds_full(x), 4);
      mbar_init(ds_free(x), 4);
    }
    for (int x = 0; x < kDqBufs; ++x) {
      mbar_init(dq_full(x), 4);   // the owner's warps
      mbar_init(dq_empty(x), 1);  // adder x's lane 0
    }
    mbar_fence_init();
  }
  __syncthreads();

  // the warpgroup's index, warp-uniform in the compiler's view (from a
  // shuffle): a wgmma under a branch ptxas cannot prove uniform is
  // serialized
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / kWG, 0);
  const int lane = threadIdx.x % 32;
  if (wg == 2) {
    producer_regs();
    const int pwarp = (threadIdx.x - 2 * kWG) / 32;
    if (pwarp == 0) {
      // ---- the items, then TMA for the tiles and loads of lse, delta ----
      int it = 0;
      for (int n = 0;; ++n) {
        int x = 0;
        if (lane == 0) {
          mbar_wait(item_empty(n & 1), ((n >> 1) & 1) ^ 1);
          x = atomicAdd(counters, 1);
          if (x >= n_items) x = -1;
          slots[n & 1] = x;
          mbar_arrive(item_full(n & 1));
        }
        x = __shfl_sync(0xffffffffu, x, 0);
        if (x < 0) break;
        const BwdItem w = bwd_item(x, work, n_work, kv_len, H, S, causal);
        // K and V wait for the previous item's last products; the item's
        // first stages go out before them
        const int pre = min(w.hi - w.lo, kWgStages);
        auto load_kv = [&]() {
          mbar_wait(res_empty, (n & 1) ^ 1);
          mbar_expect_tx(res_full, 4 * kBox);
          for (int r = 0; r < 2; ++r) {
            tma_load_4d(res + r * kBox, &map_k, res_full, 0, w.k0 + 64 * r,
                        w.h, w.b);
            tma_load_4d(res + (2 + r) * kBox, &map_v, res_full, 0,
                        w.k0 + 64 * r, w.h, w.b);
          }
        };
        const float* lse_row = lse + (long long)w.bh * S;
        const float* delta_row = delta + (long long)w.bh * S;
        for (int i = w.lo; i < w.hi; ++i, ++it) {
          if (lane == 0 && i == w.lo + pre) load_kv();
          const int s = it % kWgStages, q0 = i * kWgStep;
          mbar_wait(empty(s), ((it / kWgStages) & 1) ^ 1);
          float* st = stats_gen + s * kStatStride;
          for (int r = lane; r < kWgStep; r += 32) {
            const bool in = q0 + r < S;  // rows past S: zeros, P masked
            st[r] = in ? lse_row[q0 + r] * kLog2e : 0.f;
            st[kWgStep + r] = in ? delta_row[q0 + r] : 0.f;
          }
          if (lane == 0) {
            mbar_expect_tx(full(s), 2 * kBox);
            const uint32_t dst = ring + s * 2 * kBox;
            tma_load_4d(dst, &map_q, full(s), 0, q0, w.h, w.b);
            tma_load_4d(dst + kBox, &map_g, full(s), 0, q0, w.h, w.b);
          } else {
            mbar_arrive(full(s));
          }
        }
        if (lane == 0 && w.hi - w.lo <= kWgStages) load_kv();
        __syncwarp();
      }
    } else if (pwarp <= kDqBufs) {
      // ---- the adders: each q tile's dQ partial into the workspace, in
      // descending kv tile (the first add stores, so the workspace needs
      // no zeroing), adder `buf` taking the tiles of dQ buffer buf: up to
      // kDqBufs adds in flight, each waiting for its copy to complete
      // before it hands the turn on. A wait here ends: the kv tiles above
      // this one took their items earlier in the list, so they are
      // running or done, and their own adds wait only on kv tiles above
      // them ----
      const int buf = pwarp - 1;
      int tq = 0;
      for (int n = 0;; ++n) {
        mbar_wait(item_full(n & 1), (n >> 1) & 1);
        const int x = slots[n & 1];
        __syncwarp();
        if (lane == 0) mbar_arrive(item_empty(n & 1));
        if (x < 0) break;
        const BwdItem w = bwd_item(x, work, n_work, kv_len, H, S, causal);
        for (int i = w.lo; i < w.hi; ++i, ++tq) {
          if (tq % kDqBufs != buf) continue;
          mbar_wait(dq_full(buf), (tq / kDqBufs) & 1);
          if (lane == 0) {
            const int q0 = i * kWgStep;
            const int turn = bwd_turn(w, i, S);
            int* count = counters + 1 + (long long)w.bh * n_q + i;
            if (turn > 0) {
              while (ld_acquire(count) != turn) {
              }
              asm volatile("fence.proxy.async.global;\n" ::: "memory");
            }
            const uint32_t src = dqb + buf * kDqBytes;
            for (int c = 0; c < 2; ++c) {  // 32 head columns a box
              if (turn == 0)
                tma_store_4d(&map_ws, src + c * kBox, 32 * c, q0, w.h, w.b);
              else
                tma_reduce_add_4d(&map_ws, src + c * kBox, 32 * c, q0, w.h,
                                  w.b);
            }
            bulk_commit();
            bulk_wait_read();
            mbar_arrive(dq_empty(buf));
            if (w.j > 0) {  // kv tile 0 adds last into every q tile
              bulk_wait();
              red_release(count);
            }
          }
          __syncwarp();
        }
      }
      if (lane == 0) bulk_wait();  // kv tile 0's last adds
    }
  } else {
    // ---- consumers ----
    consumer_regs();
    const int tw = threadIdx.x % kWG;
    const int warp = tw / 32, g = lane >> 2, t = lane & 3;
    const float c = scale * kLog2e;
    auto release = [&](int s) {
      __syncwarp();
      if (lane == 0) mbar_arrive(empty(s));
    };
    auto arrive = [&](uint32_t bar) {
      __syncwarp();
      if (lane == 0) mbar_arrive(bar);
    };
    // q tile tq's dQ, and dS^T buffer tq & 1, are warpgroup tq & 1's (own):
    // the other warpgroup waits until the owner's dQ has read the
    // buffer's last tile (ds_free), stores its half and hands it on
    // (ds_full); the owner stores its own half (its last dQ on the buffer
    // landed within that tile)
    auto put_ds = [&](const uint32_t (&dh)[4][4], const uint32_t (&dl)[4][4],
                      int tq, bool own) {
      const int x = tq & 1;
      if (!own) mbar_wait(ds_free(x), ((tq >> 1) & 1) ^ 1);
      store_ds(dsb + (4 * x + 2 * wg) * kBox, dh, dl, warp, lane);
      fence_async_smem();
      if (!own) arrive(ds_full(x));
    };
    // address fields (16-byte units) of the resident K and V (this
    // warpgroup's boxes from k16 and k16 + 2 boxes), the ring's stage 0
    // (Q, then dO) and dS^T buffer 0
    const uint32_t res16 = res >> 4, k16 = res16 + wg * kBox16;
    const uint32_t ring16 = ring >> 4, ds16 = dsb >> 4;
    // the owner: dQ of q tile tq over the block's 128 keys, once its own
    // four warps' and the other warpgroup's dS^T halves are in
    auto dq_begin = [&](float (&fq)[32], int tq) {
      bar_sync(kDsBar + wg, kWG);
      mbar_wait(ds_full(tq & 1), (tq >> 1) & 1);
      dq_product(fq, ds16 + 4 * (tq & 1) * kBox16, res16);
    };
    // the owner, once dQ has landed: the dS^T buffer is freed and the sum
    // handed to the adder of buffer tq % kDqBufs (column group cg of the
    // fragment: box cg / 4, 16-byte chunk 2 (cg % 4) + t / 2 of its 128-byte
    // row; the 8 rows g of a store land in 8 chunks, so a warp's 256 bytes
    // take the two wavefronts they need)
    auto dq_end = [&](const float (&fq)[32], int tq) {
      arrive(ds_free(tq & 1));
      const int buf = tq % kDqBufs;
      mbar_wait(dq_empty(buf), ((tq / kDqBufs) & 1) ^ 1);
      unsigned char* dst = gen(dqb + buf * kDqBytes);
#pragma unroll
      for (int cg = 0; cg < 8; ++cg)
#pragma unroll
        for (int h8 = 0; h8 < 2; ++h8)
          *reinterpret_cast<float2*>(
              dst + (cg >> 2) * kBox +
              sw128(16 * warp + g + 8 * h8, 2 * (cg & 3) + (t >> 1)) +
              8 * (t & 1)) =
              make_float2(fq[4 * cg + 2 * h8], fq[4 * cg + 2 * h8 + 1]);
      fence_async_smem();
      arrive(dq_full(buf));
    };
    // the owner's dQ on a tile with no products of its own: issued,
    // landed and handed on
    auto dq_alone = [&](int tq) {
      float fq[32];
      dq_begin(fq, tq);
      wgmma_wait<0>();
      fence_regs(fq);
      dq_end(fq, tq);
    };
    int it = 0, tq = 0;
    for (int n = 0;; ++n) {
      mbar_wait(item_full(n & 1), (n >> 1) & 1);
      const int xs = slots[n & 1];
      __syncwarp();
      if (lane == 0) mbar_arrive(item_empty(n & 1));
      const int x = __shfl_sync(0xffffffffu, xs, 0);
      if (x < 0) break;
      const BwdItem w = bwd_item(x, work, n_work, kv_len, H, S, causal);
      const int kw = w.k0 + 64 * wg;
      const bool has_keys = kw < S;
      // the q tiles this warpgroup computes: from its own first live one
      // (causal: _first_live_q), none without keys; the loop bounds are
      // shuffled, so ptxas sees them warp-uniform
      const int i_lo = __shfl_sync(0xffffffffu, w.lo, 0);
      const int i_hi = __shfl_sync(0xffffffffu, w.hi, 0);
      const int live_lo = __shfl_sync(
          0xffffffffu,
          !has_keys ? w.hi : w.trim ? max(w.lo, kw / kWgStep) : w.lo, 0);
      float dka[32], dva[32];
#pragma unroll
      for (int x2 = 0; x2 < 32; ++x2) dka[x2] = dva[x2] = 0.f;
      mbar_wait(res_full, n & 1);
      auto stage_of = [&](int it2) { return it2 % kWgStages; };
      auto wait_stage = [&](int it2) {
        mbar_wait(full(stage_of(it2)), (it2 / kWgStages) & 1);
      };
      auto stats_at = [&](int it2) {
        return stats_gen + stage_of(it2) * kStatStride;
      };
      // (warp-uniform in ptxas's view: a wgmma under a branch it cannot
      // prove uniform is serialized)
      auto owns = [&](int tq2) {
        return __shfl_sync(0xffffffffu, (tq2 & 1) == wg, 0) != 0;
      };
      // a stage's Q box's address field (its dO box is one box on)
      auto stage16 = [&](int it2) {
        return ring16 + stage_of(it2) * (2 * kBox16);
      };

      // S^T = K.Q^T (a = K, b = the stage's Q) or dP^T = V.dO^T (V, dO):
      // 64 keys x 64 q, K-major operands, one group into fresh fragments
      // (the first k-step only writes them, so they are no input of the
      // products)
      auto issue_ss = [&](float (&d)[32], uint32_t a, uint32_t b) {
        wgmma_m64n64_ss_new(d, kmajor_desc(a), kmajor_desc(b));
#pragma unroll
        for (int kd = 1; kd < D / 16; ++kd)
          wgmma_m64n64_ss(d, kmajor_desc(a + kd * kCols16),
                          kmajor_desc(b + kd * kCols16), 1);
        wgmma_commit();
      };
      // fresh = A.B over the tile's 64 q rows, A the hi and lo fragments
      // in registers, B the stage's dO (dV) or Q (dK) read MN-major
      // through the transpose bit: one group into fresh fragments, which
      // the FMA units add to the running sum (the tensor cores truncate
      // where they add into an accumulator)
      auto issue_rs = [&](float (&fresh)[32], const uint32_t (&hi)[4][4],
                          const uint32_t (&lo)[4][4], uint32_t b) {
        wgmma_m64n64_rs_new(fresh, hi[0], mnmajor_desc(b));
        wgmma_m64n64_rs(fresh, lo[0], mnmajor_desc(b), 1);
#pragma unroll
        for (int kk = 1; kk < kWgStep / 16; ++kk) {
          const uint64_t bd = mnmajor_desc(b + kk * kRows16);
          wgmma_m64n64_rs(fresh, hi[kk], bd, 1);
          wgmma_m64n64_rs(fresh, lo[kk], bd, 1);
        }
        wgmma_commit();
      };
      auto add_to = [&](float (&sum)[32], float (&fresh)[32]) {
        fence_regs(fresh);
#pragma unroll
        for (int x2 = 0; x2 < 32; ++x2) sum[x2] += fresh[x2];
      };
      // P^T = exp(S^T scale - lse) in f32, in place on the finished S^T
      // (a wgmma accumulator is a block of registers of its own: P beside
      // S would take another), one FFMA an exponent: ex2(s c - lse
      // log2 e), c = scale log2 e, the stage's lse already times log2 e
      // (the producer's). On edge tiles, masked keys (causal, kv_len,
      // past S) take the reference's NEG_INF score, ex2(NEG_INF log2 e -
      // lse log2 e): 0, or 1 on a row whose keys are all masked (lse =
      // NEG_INF); rows past S get 0. One branch a tile, not one a value.
      auto make_p = [&](float (&sT)[32], const float* st, int q0) {
        const bool edge = (causal && kw + 63 > q0) || q0 + kWgStep > S ||
                          kw + 64 > w.limit;
        if (edge) {
#pragma unroll
          for (int n8 = 0; n8 < 8; ++n8) {
            const int qc = 8 * n8 + 2 * t;
            const float2 l2 = *reinterpret_cast<const float2*>(st + qc);
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const float lq = (e & 1) ? l2.y : l2.x;
              const int qpos = q0 + qc + (e & 1);
              const int kpos = kw + 16 * warp + g + 8 * (e >> 1);
              const bool masked = (causal && kpos > qpos) || kpos >= w.limit;
              float& p = sT[4 * n8 + e];
              p = qpos >= S ? 0.f
                            : ex2(masked ? kNegInfLog2e - lq
                                         : fmaf(p, c, -lq));
            }
          }
        } else {
#pragma unroll
          for (int n8 = 0; n8 < 8; ++n8) {
            const float2 l2 =
                *reinterpret_cast<const float2*>(st + 8 * n8 + 2 * t);
#pragma unroll
            for (int e = 0; e < 4; ++e)
              sT[4 * n8 + e] =
                  ex2(fmaf(sT[4 * n8 + e], c, (e & 1) ? -l2.y : -l2.x));
          }
        }
      };
      // P^T split into hi + lo bf16 A fragments (k-step kk is q columns
      // 16kk..16kk+15: column group n gives registers 2(n & 1) and
      // 2(n & 1) + 1 of k-step n / 2)
      auto split_p = [&](const float (&pT)[32], uint32_t (&ph)[4][4],
                         uint32_t (&pl)[4][4]) {
#pragma unroll
        for (int n8 = 0; n8 < 8; ++n8) {
          const int kk = n8 >> 1, r = (n8 & 1) * 2;
          split_bf16(pT[4 * n8], pT[4 * n8 + 1], ph[kk][r], pl[kk][r]);
          split_bf16(pT[4 * n8 + 2], pT[4 * n8 + 3], ph[kk][r + 1],
                     pl[kk][r + 1]);
        }
      };
      // dS^T = P^T (dP^T - delta) in f32, split as P^T
      auto make_ds = [&](const float (&pT)[32], const float (&dpT)[32],
                         const float* st, uint32_t (&dh)[4][4],
                         uint32_t (&dl)[4][4]) {
#pragma unroll
        for (int n8 = 0; n8 < 8; ++n8) {
          const float2 d2 = *reinterpret_cast<const float2*>(
              st + kWgStep + 8 * n8 + 2 * t);
          const int kk = n8 >> 1, r = (n8 & 1) * 2;
#pragma unroll
          for (int h8 = 0; h8 < 2; ++h8)
            split_bf16(pT[4 * n8 + 2 * h8] * (dpT[4 * n8 + 2 * h8] - d2.x),
                       pT[4 * n8 + 2 * h8 + 1] *
                           (dpT[4 * n8 + 2 * h8 + 1] - d2.y),
                       dh[kk][r + h8], dl[kk][r + h8]);
        }
      };

      int i = i_lo;
      for (; i < live_lo; ++i, ++it, ++tq) {
        // a tile none of whose products are this warpgroup's (its keys
        // all above the tile's rows): a zero dS^T, and the owner's dQ
        wait_stage(it);
        release(stage_of(it));
        const bool own = owns(tq);
        uint32_t zero[4][4];
#pragma unroll
        for (int a2 = 0; a2 < 4; ++a2)
#pragma unroll
          for (int c2 = 0; c2 < 4; ++c2) zero[a2][c2] = 0u;
        put_ds(zero, zero, tq, own);
        if (own) dq_alone(tq);
      }
      // S^T (then P^T in place) and dP^T of the tile, issued by the tile
      // before it (or the head below)
      float sT[32], dpT[32];
      auto issue_sdp = [&](int it2) {
        wait_stage(it2);
        wgmma_fence();
        issue_ss(sT, k16, stage16(it2));
        issue_ss(dpT, k16 + 2 * kBox16, stage16(it2) + kBox16);
      };
      // A live tile, its S^T and dP^T landed. In commit order: dV, with
      // P^T made and split before it; dS^T while dV runs; dK, while dS^T
      // goes to shared memory; dV added while dK runs; the owner's dQ,
      // and dK added while it runs; then (has_next) the next tile's S^T
      // and dP^T, under the owner's hand-off of dQ and the other's add of
      // dK. Every group lands within the tile, and no register of a
      // pending group is read or written.
      auto tile = [&](auto has_next) {
        constexpr bool next = decltype(has_next)::value;
        const uint32_t qa = stage16(it);  // Q; dO one box on
        const bool own = owns(tq);
        float fresh_v[32], fresh_k[32];
        uint32_t ph[4][4], pl[4][4], dh[4][4], dl[4][4];
        make_p(sT, stats_at(it), i * kWgStep);
        split_p(sT, ph, pl);
        wgmma_fence();
        issue_rs(fresh_v, ph, pl, qa + kBox16);
        make_ds(sT, dpT, stats_at(it), dh, dl);
        put_ds(dh, dl, tq, own);
        wgmma_fence();
        issue_rs(fresh_k, dh, dl, qa);
        wgmma_wait<1>();
        add_to(dva, fresh_v);
        if (own) {
          float fq[32];
          dq_begin(fq, tq);
          wgmma_wait<1>();
          add_to(dka, fresh_k);
          release(stage_of(it));
          if constexpr (next) {
            issue_sdp(it + 1);
            wgmma_wait<2>();
          } else {
            wgmma_wait<0>();
          }
          fence_regs(fq);
          dq_end(fq, tq);
        } else {
          if constexpr (next) {
            issue_sdp(it + 1);
            wgmma_wait<2>();
          } else {
            wgmma_wait<0>();
          }
          add_to(dka, fresh_k);
          release(stage_of(it));
        }
        if constexpr (next) {
          wgmma_wait<0>();
          fence_regs(sT);
          fence_regs(dpT);
        }
        ++i, ++it, ++tq;
      };
      if (i < i_hi) {
        issue_sdp(it);
        wgmma_wait<0>();
        fence_regs(sT);
        fence_regs(dpT);
        while (i + 1 < i_hi) tile(std::true_type());
        tile(std::false_type());
      }

      if (has_keys) {
        // dk, dv: dense (B, S, H, D)
        const long long o_row = (long long)H * D;
        const long long ob = ((long long)w.b * S * H + w.h) * D;
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int kpos = kw + 16 * warp + g + 8 * r;
          if (kpos >= S) continue;
#pragma unroll
          for (int c2 = 0; c2 < D / 8; ++c2) {
            const long long at = ob + kpos * o_row + 8 * c2 + 2 * t;
            *reinterpret_cast<__nv_bfloat162*>(dk + at) =
                __floats2bfloat162_rn(dka[4 * c2 + 2 * r] * scale,
                                      dka[4 * c2 + 2 * r + 1] * scale);
            *reinterpret_cast<__nv_bfloat162*>(dv + at) =
                __floats2bfloat162_rn(dva[4 * c2 + 2 * r],
                                      dva[4 * c2 + 2 * r + 1]);
          }
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(res_empty);  // K and V read
    }
  }
}

// dq = bf16(ws * scale), both (B, S, H, D), four values a thread: the
// fused backward's last step, once every q tile's adds have landed. A
// CUDA kernel beside the fused one (a Triton kernel would need its own
// JIT and launch path for one elementwise pass): the workspace is read
// once and dq written once.
__global__ void flash_bwd_dq_out_kernel(const float4* __restrict__ ws,
                                        uint2* __restrict__ dq, long long n4,
                                        float scale) {
  for (long long e = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       e < n4; e += (long long)gridDim.x * blockDim.x) {
    const float4 x = ws[e];
    __nv_bfloat162 lo = __floats2bfloat162_rn(x.x * scale, x.y * scale);
    __nv_bfloat162 hi = __floats2bfloat162_rn(x.z * scale, x.w * scale);
    uint2 packed;
    packed.x = *reinterpret_cast<uint32_t*>(&lo);
    packed.y = *reinterpret_cast<uint32_t*>(&hi);
    dq[e] = packed;
  }
}

// ---------------------------------------------------------------------------
// The wgmma forward: its key stage, blocks an SM, registers, one stage's
// softmax.
// ---------------------------------------------------------------------------

// The forward's key stage (BLOCK_K of the plain forward): 64 keys, one box
// of K and one of V a stage. Its own constant beside the backward's
// kWgStep: a stage of 128 keys (S 64 registers a thread) leaves three
// consumer warpgroups' 160 registers no room beside O, P.V's fresh
// fragments and P (PERF.md §6 row 3 times both).
constexpr int kFwdStep = 64;
constexpr int kFwdGroups = kFwdStep / 8;          // 8-key groups of S
constexpr int kFwdProducerRegs = 24;
static_assert(kFwdStep == hopper::kSw, "S is one wgmma of n = 64 a k-step");
// A masked score's raw product (causal, kv_len): below every real one,
// and finite, so a row whose keys are all masked has max == it and P = 1
// (the reference's NEG_INF row), while one with a live key gets P = 0.
constexpr float kMaskRaw = -3.0e38f;
// A Q buffer's item in shared memory, as the producer decoded it: x, then
// b, h, q0, lo, hi, limit, trim (the consumers read it there, not the work
// list and kv_len from global memory)
constexpr int kFwdSlot = 8;

// The block geometry of NC consumer warpgroups (64 q rows each) and one
// producer warpgroup. NC = 3: one block an SM; 512 threads start with 128
// registers, and setmaxnreg moves 96 of the producer's to the three
// consumers (160 each). NC = 1 (short grids: three times the items): two
// blocks an SM of 256 threads at 128, consumers at 232. Each consumer
// warpgroup overlaps its own products with its softmax, stage to stage
// and item to item (the kernel's note).
template <int NC>
struct FwdGeom {
  static_assert(NC == 1 || NC == 3, "64 or 192 q rows an item");
  static constexpr int kThreads = (NC + 1) * kWG;
  static constexpr int kBlocks = NC == 1 ? 2 : 1;   // blocks an SM
  static constexpr int kStages = 4;                 // ring stages
  static constexpr int kLaunchRegs = (65536 / (kThreads * kBlocks)) & ~7;
  static constexpr int kConsumerRegs = NC == 1 ? 232 : 160;
  static_assert(NC * (kConsumerRegs - kLaunchRegs) <=
                    kLaunchRegs - kFwdProducerRegs,
                "setmaxnreg.inc takes only what its block's producer gave "
                "up");
  // Q (two buffers of NC boxes), the ring (a K box and a V box a stage),
  // O's staging boxes (two a consumer warpgroup), the barriers (full and
  // empty a stage and a Q buffer), the Q buffers' items (kFwdSlot ints
  // each), and the slack to a 1024-byte boundary
  static constexpr size_t kSmem =
      1024 + (size_t)(4 * NC + 2 * kStages) * hopper::kBox +
      (2 * kStages + 4) * 8 + 2 * kFwdSlot * 4;
  static_assert(kBlocks * (kSmem + 1024) <= 233472,
                "the blocks an SM share its 228 KB");
};

// One stage's online softmax on its finished S (raw products q.k), in
// place: S's fragments end holding this stage's P in f32 (fwd_pack
// rounds them into P.V's operand once the stage before has landed). The
// max runs on the raw products (scale > 0, so they order as the scaled
// scores do), and each exponent is one FFMA: exp(s*scale - m*scale) =
// ex2(s*c - m*c), c = scale * log2(e). With kEdge, the masks: this
// thread's keys kcol + 8 n + {0, 1} of rows g and g + 8 (r = 0, 1) are
// live below live[r] (causal, kv_len and S), masked below S (kMaskRaw,
// and the exponent (x - m) * c: 0 for a row with no live key yet, the
// reference's uniform row, and -huge for one with), and do not exist
// past S (-inf: out of the max, P = 0). l sums this thread's f32 values;
// alpha is the factor that rescales O before this stage's P.V.
template <bool kEdge>
__device__ __forceinline__ void fwd_softmax_at(
    float (&acc)[4 * kFwdGroups], float (&m)[2], float (&l)[2],
    float (&alpha)[2], const int (&live)[2], int kcol, int S, float c) {
  // a score as the max and the exponent see it (key offset from kcol)
  auto x = [&](int n, int e) {
    const int kpos = kcol + 8 * n + (e & 1);
    if (!kEdge || kpos < live[e >> 1]) return acc[4 * n + e];
    return kpos < S ? kMaskRaw : -INFINITY;
  };
  float mn[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float mx = -INFINITY;
#pragma unroll
    for (int n = 0; n < kFwdGroups; ++n)
      mx = fmaxf(mx, fmaxf(x(n, 2 * r), x(n, 2 * r + 1)));
    mn[r] = fmaxf(m[r], quad_max(mx));
    alpha[r] = ex2((m[r] - mn[r]) * c);
  }
  const float mc[2] = {mn[0] * c, mn[1] * c};
  float ps[2] = {0.f, 0.f};
#pragma unroll
  for (int n = 0; n < kFwdGroups; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float p = kEdge ? ex2((x(n, e) - mn[e >> 1]) * c)
                            : ex2(fmaf(acc[4 * n + e], c, -mc[e >> 1]));
      ps[e >> 1] += p;
      acc[4 * n + e] = p;
    }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] = l[r] * alpha[r] + ps[r];
    m[r] = mn[r];
  }
}

// A stage's P (fwd_softmax_at's f32 values) rounded to bf16 into the A
// fragments of P.V: key group n is k-step n / 2, registers 2 (n & 1) for
// row g and 2 (n & 1) + 1 for row g + 8.
__device__ __forceinline__ void fwd_pack(const float (&p)[4 * kFwdGroups],
                                         uint32_t (&pf)[kFwdStep / 16][4]) {
#pragma unroll
  for (int n = 0; n < kFwdGroups; ++n) {
    const int kk = n >> 1, r = (n & 1) * 2;
    pf[kk][r] = pack_bf16(p[4 * n], p[4 * n + 1]);
    pf[kk][r + 1] = pack_bf16(p[4 * n + 2], p[4 * n + 3]);
  }
}

// Item x of the forward: work item x % n_work of head bh = x / n_work,
// so the items head by head, each head's heaviest first; the blocks in
// flight share a few heads' K and V in L2. Its q rows from q0, its kv
// stages [lo, hi): the work item's causal range, or every stage (not
// causal, or a kv_len == 0 row, whose keys are all masked). The producer
// decodes each item into its Q buffer's slot (kFwdSlot), where the
// consumers read it.
struct FwdItem {
  int b, h, bh, q0, lo, hi, limit;
  bool trim;
};
__device__ __forceinline__ FwdItem fwd_item(int x, int n_work, int H,
                                            int S, int rows, int causal,
                                            const int* work,
                                            const int* kv_len) {
  FwdItem w;
  const int* e = work + 3 * (x % n_work);
  w.bh = x / n_work;
  w.b = w.bh / H;
  w.h = w.bh % H;
  w.q0 = e[0] * rows;
  w.limit = kv_len ? kv_len[w.b] : S;
  w.trim = causal && w.limit > 0;
  w.lo = w.trim ? e[1] : 0;
  w.hi = w.trim ? e[2] : (S + kFwdStep - 1) / kFwdStep;
  return w;
}

// Item x as one consumer warpgroup sees it (the kernel's view): the
// block's item number n picks Q buffer qb; its rows from qw (has_rows:
// any below S); the ring holds its stages [j_lo, j_hi) from ring index
// it0, and the warpgroup computes [j_lo, live_hi); each row's keys below
// live[r] are unmasked. x == n_items: no more items.
struct FwdView {
  FwdItem w;
  uint64_t qdesc;  // its Q box's K-major descriptor (this warpgroup's)
  int x, qb, qw, j_lo, j_hi, live_hi, it0;
  int live[2];
  bool has_rows;
};

// ---------------------------------------------------------------------------
// bf16 forward on wgmma (D = 64): a persistent grid whose blocks own 64 NC
// q rows an item. The n_items = B H n_work items (fwd_item; the work
// list's items are (q tile, first kv stage, end kv stage), heaviest
// first) are taken in order: block b's first is item b, and each later
// one is gridDim.x plus the count its producer draws (counters[0]), so
// the blocks share the heavy and light items of each head; the last
// block to finish zeroes counters for the next launch on the stream
// (counters[1] counts the finished blocks). Consumer
// warpgroup wg owns q rows qw = q0 + 64 wg .. qw + 63 of an item; m, l
// and the output fragments of its rows g and g + 8 stay in registers.
// Shared memory: Q in two buffers (NC boxes each, one TMA box of 64 NC
// rows), so the producer loads the next item's Q while this one runs; a
// ring of kStages stages of (K, V), kFwdStep rows each (one TMA box of
// kFwdStep rows a tensor), its stages counted on from item to item, so
// the next item's first stages load under this one's last; two staging
// boxes of O a consumer warpgroup; the barriers; the item of each Q
// buffer.
// ---------------------------------------------------------------------------

template <int D, int NC>
__global__ void __launch_bounds__(FwdGeom<NC>::kThreads, FwdGeom<NC>::kBlocks)
    flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap map_q,
                           const __grid_constant__ CUtensorMap map_k,
                           const __grid_constant__ CUtensorMap map_v,
                           const __grid_constant__ CUtensorMap map_o,
                           const int* __restrict__ kv_len,
                           const int* __restrict__ work, int n_work,
                           int n_items, int* __restrict__ counters,
                           float* __restrict__ lse, int H, int S,
                           float scale, int causal) {
  static_assert(D == hopper::kSw, "a head is one 128-byte swizzled row");
  using namespace hopper;
  using G = FwdGeom<NC>;
  constexpr int kStages = G::kStages;
  constexpr int kStageBytes = 2 * kBox;  // K, then V
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* smem = smem_raw;
  const uint32_t res = ring_base(smem);           // Q, two buffers
  const uint32_t ring = res + 2 * NC * kBox;      // stage s: K, V
  const uint32_t ostage = ring + kStages * kStageBytes;  // O, 2 boxes a wg
  const uint32_t bars = ostage + 2 * NC * kBox;
  auto full = [&](int s) { return bars + 8 * s; };
  auto empty = [&](int s) { return bars + 8 * (kStages + s); };
  auto q_full = [&](int qb) { return bars + 8 * (2 * kStages + qb); };
  auto q_empty = [&](int qb) { return bars + 8 * (2 * kStages + 2 + qb); };
  // the item of Q buffer qb at slots[kFwdSlot qb] (n_items: no more)
  volatile int* slots = reinterpret_cast<volatile int*>(
      smem + (bars + 8 * (2 * kStages + 4) - smem_u32(smem)));
  auto item = [&](int x) {
    return fwd_item(x, n_work, H, S, 64 * NC, causal, work, kv_len);
  };

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 4 * NC);  // one arrival per consumer warp
    }
    for (int qb = 0; qb < 2; ++qb) {
      mbar_init(q_full(qb), 1);
      mbar_init(q_empty(qb), 4 * NC);
    }
    mbar_fence_init();
  }
  __syncthreads();

  // the warpgroup's index, warp-uniform in the compiler's view (see the
  // backward)
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / kWG, 0);
  if (wg == NC) {
    // ---- producer ----
    producer_regs<kFwdProducerRegs>();
    if (threadIdx.x == NC * kWG) {
      int it = 0;  // stages loaded, over the block's items
      for (int n = 0;; ++n) {
        const int qb = n & 1;
        mbar_wait(q_empty(qb), ((n >> 1) & 1) ^ 1);
        // the block's first item is its own index (the grid has at most
        // n_items blocks), so its loads start with no atomic's round trip;
        // the others come from the counter, past the grid's first round
        const int x = n == 0 ? (int)blockIdx.x
                      : (int)gridDim.x >= n_items
                          ? n_items  // one round: none left, no atomic
                          : min((int)gridDim.x + atomicAdd(counters, 1),
                                n_items);
        volatile int* slot = slots + kFwdSlot * qb;
        slot[0] = x;
        if (x == n_items) {  // none left: the consumers' signal to stop
          mbar_arrive(q_full(qb));
          break;
        }
        const FwdItem w = item(x);
        slot[1] = w.b;
        slot[2] = w.h;
        slot[3] = w.q0;
        slot[4] = w.lo;
        slot[5] = w.hi;
        slot[6] = w.limit;
        slot[7] = w.trim;
        mbar_expect_tx(q_full(qb), NC * kBox);
        tma_load_4d(res + qb * NC * kBox, &map_q, q_full(qb), 0, w.q0, w.h,
                    w.b);
        for (int j = w.lo; j < w.hi; ++j, ++it) {
          const int s = it % kStages;
          mbar_wait(empty(s), ((it / kStages) & 1) ^ 1);
          mbar_expect_tx(full(s), kStageBytes);
          const uint32_t dst = ring + s * kStageBytes;
          tma_load_4d(dst, &map_k, full(s), 0, j * kFwdStep, w.h, w.b);
          tma_load_4d(dst + kBox, &map_v, full(s), 0,
                      j * kFwdStep, w.h, w.b);
        }
      }
      // every block has taken its last item once all have counted
      // themselves here: the last one zeroes the counters
      __threadfence();
      if (atomicAdd(counters + 1, 1) == (int)gridDim.x - 1) {
        counters[0] = 0;
        counters[1] = 0;
      }
    }
  } else {
    // ---- consumers ----
    consumer_regs<G::kConsumerRegs>();
    const int tw = threadIdx.x % kWG;
    const int warp = tw / 32, lane = tw % 32, g = lane >> 2, t = lane & 3;
    const float c = scale * kLog2e;
    auto release = [&](uint32_t bar) {
      __syncwarp();
      if (lane == 0) mbar_arrive(bar);
    };
    // the block's item n as this warpgroup sees it, its stages from ring
    // index it0 (waits for its Q buffer); the loop bounds and the item are
    // shuffled, so ptxas sees them warp-uniform
    auto view = [&](int n, int it0) {
      FwdView v;
      v.qb = n & 1;
      v.qdesc = wgmma_desc(res + v.qb * NC * kBox + wg * kBox, 16, 1024);
      v.it0 = it0;
      mbar_wait(q_full(v.qb), (n >> 1) & 1);
      volatile int* slot = slots + kFwdSlot * v.qb;
      v.x = __shfl_sync(0xffffffffu, slot[0], 0);
      const bool more = v.x < n_items;
      v.w.b = slot[1];
      v.w.h = slot[2];
      v.w.bh = v.w.b * H + v.w.h;
      v.w.q0 = slot[3];
      v.w.lo = more ? slot[4] : 0;
      v.w.hi = slot[5];
      v.w.limit = slot[6];
      v.w.trim = slot[7] != 0;
      v.qw = v.w.q0 + 64 * wg;
      v.has_rows = more && v.qw < S;
      v.j_lo = __shfl_sync(0xffffffffu, v.w.lo, 0);
      v.j_hi = __shfl_sync(0xffffffffu, more ? v.w.hi : v.w.lo, 0);
      // up to its own last live stage (causal: _last_live_kv), none
      // without rows
      v.live_hi = __shfl_sync(
          0xffffffffu,
          !v.has_rows ? v.w.lo
                      : v.w.trim ? min(v.w.hi, (v.qw + 63) / kFwdStep + 1)
                                 : v.w.hi,
          0);
      // each row's keys below live[r] are unmasked (causal, kv_len, S)
      const int qrow = v.qw + 16 * warp + g;
#pragma unroll
      for (int r = 0; r < 2; ++r)
        v.live[r] = min(S, causal ? min(v.w.limit, qrow + 8 * r + 1)
                                  : v.w.limit);
      return v;
    };
    auto wait_ring = [&](int r) {
      mbar_wait(full(r % kStages), (r / kStages) & 1);
    };
    // the ring's descriptors at slot 0: K K-major, V MN-major (a slot's
    // and a k-step's offsets add to the address field, bytes / 16)
    const uint64_t kdesc0 = wgmma_desc(ring, 16, 1024);
    const uint64_t vdesc0 = wgmma_desc(ring + kBox, kBox, 1024);
    auto slot_desc = [&](uint64_t d0, int r) {
      return d0 + (uint64_t)((r % kStages) * (kStageBytes >> 4));
    };
    // S of the stage at ring index r of item v: 64 q rows x kFwdStep keys,
    // K-major operands, into fresh fragments (sc is no input of the first
    // k-step, so its registers hold the softmax's P between stages); a
    // k-step of 16 moves both 32 bytes along their rows
    float sc[4 * kFwdGroups];
    auto issue_s = [&](const FwdView& v, int r) {
      const uint64_t kd = slot_desc(kdesc0, r);
      wgmma_m64n64_ss_new(sc, v.qdesc, kd);
#pragma unroll
      for (int k = 1; k < D / 16; ++k)
        wgmma_m64n64_ss(sc, v.qdesc + 2 * k, kd + 2 * k, 1);
      wgmma_commit();
    };
    // stage j's softmax on sc, in place, into the running m and l; masks
    // on the stages that need them
    auto softmax = [&](const FwdView& v, float (&m)[2], float (&l)[2],
                       float (&alpha)[2], int j) {
      const int k0 = j * kFwdStep;
      const bool edge = (causal && k0 + kFwdStep - 1 > v.qw) ||
                        k0 + kFwdStep > S || k0 + kFwdStep > v.w.limit;
      if (edge)
        fwd_softmax_at<true>(sc, m, l, alpha, v.live, k0 + 2 * t, S, c);
      else
        fwd_softmax_at<false>(sc, m, l, alpha, v.live, k0 + 2 * t, S, c);
    };
    // P_j.V_j of the stage at ring index r into fresh fragments (V read
    // MN-major through the transpose bit)
    float pv[32];
    uint32_t pf[kFwdStep / 16][4];
    auto issue_pv = [&](int r) {
      const uint64_t vd = slot_desc(vdesc0, r);
      wgmma_m64n64_rs_new(pv, pf[0], vd);
#pragma unroll
      for (int kk = 1; kk < kFwdStep / 16; ++kk)  // 16 rows: 2048 bytes
        wgmma_m64n64_rs(pv, pf[kk], vd + 128 * kk, 1);
      wgmma_commit();
    };
    // rows g and g + 8: the running max of the raw products, this
    // thread's share of the running sum (its quad's shares add up at the
    // end), the output
    float m[2] = {kMaskRaw, kMaskRaw}, l[2] = {0.f, 0.f};
    float o[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) o[i] = 0.f;
    // O = O * alpha_j + P_j.V_j, added by the FMA units (the tensor cores
    // truncate where they add into an accumulator); the stage at ring
    // index r is done
    auto add_pv = [&](const float (&alpha)[2], int r) {
#pragma unroll
      for (int i = 0; i < 32; ++i)
        o[i] = fmaf(o[i], alpha[(i >> 1) & 1], pv[i]);
      release(empty(r % kStages));
    };
    // item v's rows out, then O is zero for the next item: O / l in bf16
    // into one of the warpgroup's two staging boxes (its 64 rows, 128-byte
    // swizzled as a TMA box: row r's 16-byte chunk i at chunk i ^ (r & 7)),
    // which one thread stores by TMA; lse from registers
    int n_out = 0;  // this warpgroup's boxes stored: box n_out & 1 is next
    auto epilogue = [&](const FwdView& v) {
      if (v.has_rows) {
        const uint32_t ot = ostage + (2 * wg + (n_out & 1)) * kBox;
        unsigned char* const obox = smem + (ot - smem_u32(smem));
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int row = 16 * warp + g + 8 * r, qpos = v.qw + row;
          const float lc = fmaxf(quad_sum(l[r]), 1e-30f), inv = 1.f / lc;
#pragma unroll
          for (int i = 0; i < D / 8; ++i)
            *reinterpret_cast<uint32_t*>(obox + row * 128 +
                                         ((i ^ g) << 4) + 4 * t) =
                pack_bf16(o[4 * i + 2 * r] * inv, o[4 * i + 2 * r + 1] * inv);
          // the row max in the scaled domain: NEG_INF for a row whose
          // keys are all masked
          const float ms = m[r] == kMaskRaw ? kNegInf : m[r] * scale;
          if (t == 0 && qpos < S)
            lse[(long long)v.w.bh * S + qpos] = ms + logf(lc);
        }
        // the box's writes visible to TMA, and the other box's last store
        // has read it (so no warp past this barrier overwrites a box a
        // store still reads); then one TMA store of the box (rows past S
        // are not written)
        fence_async_smem();
        if (tw == 0) bulk_wait_read();
        bar_sync(1 + wg, kWG);
        if (tw == 0) {
          tma_store_4d(&map_o, ot, 0, v.qw, v.w.h, v.w.b);
          bulk_commit();
        }
        ++n_out;
      }
#pragma unroll
      for (int i = 0; i < 32; ++i) o[i] = 0.f;
    };

    float alpha[2] = {1.f, 1.f}, alpha_next[2] = {1.f, 1.f};
    // carried: the hand-off made the P of this item's first stage (in pf,
    // with m, l and alpha)
    bool carried = false;
    FwdView cur = view(0, 0);
    for (int n = 0; cur.x < n_items; ++n) {
      auto rix = [&](int j) { return cur.it0 + j - cur.j_lo; };
      const int it_end = rix(cur.j_hi);  // the next item's first stage
      if (cur.j_lo < cur.live_hi) {
        int j = cur.j_lo;
        // the first stage's S and softmax alone, unless the hand-off made
        // them (shuffled: warp-uniform to ptxas, as every branch around a
        // wgmma)
        if (__shfl_sync(0xffffffffu, !carried, 0)) {
          wait_ring(rix(j));
          wgmma_fence();
          issue_s(cur, rix(j));
          wgmma_wait<0>();
          fence_regs(sc);
          softmax(cur, m, l, alpha, j);
          fwd_pack(sc, pf);
        }
        // Stage j with P_j made and stage j + 1 live: S_{j+1} goes out,
        // then P_j.V_j; stage j + 1's softmax runs on the SFU and FMA
        // units while P_j.V_j is in flight (wgmma_wait<1>), and is rounded
        // into P's registers once it has landed. No branch inside, so
        // ptxas sees which group each wait retires.
        for (; j + 1 < cur.live_hi; ++j) {
          wait_ring(rix(j + 1));
          wgmma_fence();
          issue_s(cur, rix(j + 1));
          issue_pv(rix(j));
          wgmma_wait<1>();
          fence_regs(sc);
          softmax(cur, m, l, alpha_next, j + 1);
          wgmma_wait<0>();
          fence_regs(pv);
          add_pv(alpha, rix(j));
          fwd_pack(sc, pf);
          alpha[0] = alpha_next[0];
          alpha[1] = alpha_next[1];
        }
        release(q_empty(cur.qb));  // this item's S are done: Q is free
        // The hand-off, where the ring's next stage is the next item's
        // first (this warpgroup computes the item's last stage) and the
        // next item has stages for this warpgroup: the next item's first S
        // goes out with this item's last P.V, and its softmax runs under
        // it; then the epilogue. A warpgroup whose last stage comes earlier
        // (a causal item's lower rows, whose next stage is up to NC - 1
        // stages on) drains instead: its last P.V goes out at once, and its
        // epilogue runs while the ring fills. Each branch retires its own
        // groups.
        const bool drains = cur.live_hi < cur.j_hi;
        FwdView nxt;
        if (!drains) nxt = view(n + 1, it_end);
        const bool hand_off = __shfl_sync(
            0xffffffffu, !drains && nxt.j_lo < nxt.live_hi, 0);
        float m_next[2] = {kMaskRaw, kMaskRaw}, l_next[2] = {0.f, 0.f};
        if (hand_off) {
          wait_ring(it_end);
          wgmma_fence();
          issue_s(nxt, it_end);
          issue_pv(rix(j));
          wgmma_wait<1>();
          fence_regs(sc);
          softmax(nxt, m_next, l_next, alpha_next, nxt.j_lo);
          wgmma_wait<0>();
          fence_regs(pv);
          add_pv(alpha, rix(j));
        } else {
          wgmma_fence();
          issue_pv(rix(j));
          wgmma_wait<0>();
          fence_regs(pv);
          add_pv(alpha, rix(j));
        }
        for (int s = cur.live_hi; s < cur.j_hi; ++s) {  // none of ours
          wait_ring(rix(s));
          release(empty(rix(s) % kStages));
        }
        if (hand_off) fwd_pack(sc, pf);  // P.V's registers are free
        epilogue(cur);
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          m[r] = m_next[r];
          l[r] = l_next[r];
          alpha[r] = alpha_next[r];
        }
        carried = hand_off;
        cur = drains ? view(n + 1, it_end) : nxt;
      } else {  // none of this item's products are ours, nor its rows
        // (a warpgroup with rows has live stages: a causal item's start at
        // stage 0, the others run to its end)
        release(q_empty(cur.qb));
        for (int s = cur.j_lo; s < cur.j_hi; ++s) {
          wait_ring(rix(s));
          release(empty(rix(s) % kStages));
        }
        carried = false;
        cur = view(n + 1, it_end);
      }
    }
    if (tw == 0) bulk_wait_read();  // the last store has read its box
  }
}

// Shared memory of each kernel, in bytes.
size_t fwd_smem(int D) {
  return (size_t)((kBQ + kBK) * (D + 1) + kBK * D + kBQ * kPT) * 4;
}
size_t dq_smem(int D) {  // k and v share a buffer at D > 128
  return (size_t)((2 * kBQ + (D > 128 ? 1 : 2) * kBK) * (D + 1) +
                  kBQ * kPT) * 4;
}
size_t dkv_smem(int D) {  // q and dO share a buffer at D > 128
  return (size_t)((2 * kBK + (D > 128 ? 1 : 2) * kBQ) * (D + 1) +
                  2 * kBK * (kBQ + 1) + 2 * kBQ) * 4;
}
size_t fwd_mma_smem(int D) {  // q, 2-stage k and v rings
  return (size_t)(kBQ + 4 * kBK) * (D + 8) * sizeof(bf16);
}
size_t dkv_mma_smem(int D) {  // k, v, 2-stage q and dO rings; lse, delta
  return (size_t)(2 * kBK + 4 * kBQ) * (D + 8) * sizeof(bf16) +
         4 * kBQ * sizeof(float);
}
size_t dq_mma_smem(int D) {  // q, dO, 2-stage k and v rings
  return (size_t)(2 * kBQ + 4 * kBK) * (D + 8) * sizeof(bf16);
}

// the fused backward (bwd_bytes_to), and the slack to a 1024-byte boundary
size_t bwd_smem() { return 1024 + bwd_bytes_to(7); }

size_t fwd_wide_smem() {  // q, k slices; v columns; p
  return (size_t)(2 * 64 * kLDC + kBK * (kSlice + 1) + kBQ * kPT) * 4;
}
size_t dq_wide_smem() {  // q, dO, k, v slices; k columns; dS
  return (size_t)(4 * 64 * kLDC + kBK * (kSlice + 1) + kBQ * kPT) * 4;
}
size_t dkv_wide_smem() {  // k, v, q, dO slices; q/dO columns; P^T, dS^T
  return (size_t)(4 * 64 * kLDC + kBQ * (kSlice + 1) + 2 * kBK * (kBQ + 1) +
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
int launch_fwd_mma(const void* q, const void* k, const void* v,
                   const void* kv_len, void* out, void* lse,
                   const long long* strides, int B, int H, int S, float scale,
                   int causal, cudaStream_t stream) {
  static_assert(sizeof(T) == sizeof(bf16), "the mma kernels are bf16");
  const size_t smem = fwd_mma_smem(D);
  cudaError_t err = allow_smem(flash_fwd_mma_kernel<D>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(B * H, (S + kBQ - 1) / kBQ);
  flash_fwd_mma_kernel<D><<<grid, kThreadsTC, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const int*>(kv_len),
      static_cast<bf16*>(out), static_cast<float*>(lse), layout(strides),
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
int launch_dq_mma(const void* q, const void* k, const void* v,
                  const void* dout, const void* lse, const void* delta,
                  const void* kv_len, void* dq, const long long* strides,
                  int B, int H, int S, float scale, int causal,
                  cudaStream_t stream) {
  static_assert(sizeof(T) == sizeof(bf16), "the mma kernels are bf16");
  const size_t smem = dq_mma_smem(D);
  cudaError_t err = allow_smem(flash_bwd_dq_mma_kernel<D>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(B * H, (S + kBQ - 1) / kBQ);
  flash_bwd_dq_mma_kernel<D><<<grid, kThreadsTC, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<const int*>(kv_len), static_cast<bf16*>(dq),
      layout(strides), layout(strides + 3), layout(strides + 6),
      layout(strides + 9), H, S, scale, causal);
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

template <typename T, int D>
int launch_dkv_mma(const void* q, const void* k, const void* v,
                   const void* dout, const void* lse, const void* delta,
                   const void* kv_len, void* dk, void* dv,
                   const long long* strides, int B, int H, int S, float scale,
                   int causal, cudaStream_t stream) {
  static_assert(sizeof(T) == sizeof(bf16), "the mma kernels are bf16");
  const size_t smem = dkv_mma_smem(D);
  cudaError_t err = allow_smem(flash_bwd_dkv_mma_kernel<D>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(B * H, (S + kBK - 1) / kBK);
  flash_bwd_dkv_mma_kernel<D><<<grid, kThreadsTC, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<const int*>(kv_len), static_cast<bf16*>(dk),
      static_cast<bf16*>(dv), layout(strides), layout(strides + 3),
      layout(strides + 6), layout(strides + 9), H, S, scale, causal);
  return static_cast<int>(cudaGetLastError());
}

// q, k, v (and dO) as 4-D TMA maps over (D, S, H, B), the caller's (b,
// s, h) element strides, boxes of 64 head columns x rows[i] rows of one
// head (kWgStep without rows). False where a map cannot be encoded (the
// wrapper refuses those first).
template <int N>
bool tma_maps(CUtensorMap (&maps)[N], const void* const (&ptrs)[N],
              const long long* strides, int B, int H, int S,
              const int* rows = nullptr) {
  for (int i = 0; i < N; ++i) {
    const long long* st = strides + 3 * i;
    const cuuint64_t dims[4] = {(cuuint64_t)hopper::kSw, (cuuint64_t)S,
                                (cuuint64_t)H, (cuuint64_t)B};
    const cuuint64_t bytes[3] = {(cuuint64_t)st[1] * sizeof(bf16),
                                 (cuuint64_t)st[2] * sizeof(bf16),
                                 (cuuint64_t)st[0] * sizeof(bf16)};
    const cuuint32_t box[4] = {(cuuint32_t)hopper::kSw,
                               (cuuint32_t)(rows ? rows[i] : kWgStep), 1, 1};
    if (!hopper::encode_bf16(&maps[i], ptrs[i], 4, dims, bytes, box))
      return false;
  }
  return true;
}

// The forward at NC consumer warpgroups (64 NC q rows an item): Q read
// as one box of an item's rows, K and V as one box a stage each, O
// written as one box of a warpgroup's 64 rows; a
// persistent grid of as many blocks as the card holds at once, at most
// one an item.
template <int NC>
int launch_fwd_wgmma(const void* q, const void* k, const void* v,
                     const void* kv_len, const void* work, int n_work,
                     void* counters, void* out, void* lse,
                     const long long* strides, int B, int H, int S,
                     float scale, int causal, cudaStream_t stream) {
  using G = FwdGeom<NC>;
  CUtensorMap maps[4];
  const void* const ptrs[4] = {q, k, v, out};
  // q, k, v at the caller's strides; out (B, S, H, D) contiguous
  const long long st[12] = {strides[0], strides[1], strides[2],
                            strides[3], strides[4], strides[5],
                            strides[6], strides[7], strides[8],
                            (long long)S * H * 64, (long long)H * 64, 64};
  const int rows[4] = {64 * NC, kFwdStep, kFwdStep, 64};
  if (!tma_maps(maps, ptrs, st, B, H, S, rows))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = allow_smem(flash_fwd_wgmma_kernel<64, NC>, G::kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  // blocks an SM holds at once (asked once a process)
  static const int per_sm = [] {
    int n = 0;
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
               &n, flash_fwd_wgmma_kernel<64, NC>, G::kThreads,
               G::kSmem) == cudaSuccess ? n : 0;
  }();
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  const long long n_items = (long long)B * H * n_work;
  const int grid = (int)std::min<long long>(
      n_items, (long long)per_sm * hopper::sm_count());
  flash_fwd_wgmma_kernel<64, NC><<<grid, G::kThreads, G::kSmem, stream>>>(
      maps[0], maps[1], maps[2], maps[3], static_cast<const int*>(kv_len),
      static_cast<const int*>(work), n_work, (int)n_items,
      static_cast<int*>(counters), static_cast<float*>(lse), H, S, scale,
      causal);
  return static_cast<int>(cudaGetLastError());
}

// The fused backward and then dQ's pass out of the workspace, on one
// stream: a persistent grid of as many blocks as the card holds at once
// (one an SM), at most one an item.
int launch_bwd_wgmma(const void* q, const void* k, const void* v,
                     const void* dout, const void* lse, const void* delta,
                     const void* kv_len, const void* work, int n_work,
                     void* counters, void* ws, void* dq, void* dk, void* dv,
                     const long long* strides, int B, int H, int S,
                     float scale, int causal, cudaStream_t stream) {
  CUtensorMap maps[4], map_ws;
  const void* const ptrs[4] = {q, k, v, dout};
  if (!tma_maps(maps, ptrs, strides, B, H, S))
    return static_cast<int>(cudaErrorInvalidValue);
  {  // the workspace: dense (B, S, H, 64) f32, boxes of 32 columns x 64 rows
    const cuuint64_t dims[4] = {64, (cuuint64_t)S, (cuuint64_t)H,
                                (cuuint64_t)B};
    const cuuint64_t bytes[3] = {(cuuint64_t)H * 64 * 4, 64 * 4,
                                 (cuuint64_t)S * H * 64 * 4};
    const cuuint32_t box[4] = {32, (cuuint32_t)kWgStep, 1, 1};
    if (!hopper::encode_f32(&map_ws, ws, 4, dims, bytes, box))
      return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = bwd_smem();
  cudaError_t err = allow_smem(flash_bwd_wgmma_kernel<64>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, flash_bwd_wgmma_kernel<64>, kWgThreads, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  const long long n_items = (long long)B * H * n_work;
  const long long sms = hopper::sm_count();
  const int grid = (int)std::min<long long>(n_items, per_sm * sms);
  flash_bwd_wgmma_kernel<64><<<grid, kWgThreads, smem, stream>>>(
      maps[0], maps[1], maps[2], maps[3], map_ws,
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<const int*>(kv_len), static_cast<const int*>(work), n_work,
      (int)n_items, static_cast<int*>(counters), static_cast<bf16*>(dk),
      static_cast<bf16*>(dv), H, S, scale, causal);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long n4 = (long long)B * S * H * (64 / 4);
  const int threads = 256;
  const int blocks =
      (int)std::min<long long>((n4 + threads - 1) / threads, sms * 8);
  flash_bwd_dq_out_kernel<<<blocks, threads, 0, stream>>>(
      static_cast<const float4*>(ws), static_cast<uint2*>(dq), n4, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_fwd_wide(const void* q, const void* k, const void* v,
                    const void* kv_len, void* out, void* lse,
                    const long long* strides, int B, int H, int S, int D,
                    float scale, int causal, cudaStream_t stream) {
  const size_t smem = fwd_wide_smem();
  cudaError_t err = allow_smem(flash_fwd_wide_kernel<T>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(B * H, (S + kBQ - 1) / kBQ, (D + kSlice - 1) / kSlice);
  flash_fwd_wide_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int*>(kv_len),
      static_cast<T*>(out), static_cast<float*>(lse), layout(strides),
      layout(strides + 3), layout(strides + 6), H, S, D, scale, causal);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_dq_wide(const void* q, const void* k, const void* v,
                   const void* dout, const void* lse, const void* delta,
                   const void* kv_len, void* dq, const long long* strides,
                   int B, int H, int S, int D, float scale, int causal,
                   cudaStream_t stream) {
  const size_t smem = dq_wide_smem();
  cudaError_t err = allow_smem(flash_bwd_dq_wide_kernel<T>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(B * H, (S + kBQ - 1) / kBQ, (D + kSlice - 1) / kSlice);
  flash_bwd_dq_wide_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<const int*>(kv_len), static_cast<T*>(dq), layout(strides),
      layout(strides + 3), layout(strides + 6), layout(strides + 9), H, S, D,
      scale, causal);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_dkv_wide(const void* q, const void* k, const void* v,
                    const void* dout, const void* lse, const void* delta,
                    const void* kv_len, void* dk, void* dv,
                    const long long* strides, int B, int H, int S, int D,
                    float scale, int causal, cudaStream_t stream) {
  const size_t smem = dkv_wide_smem();
  cudaError_t err = allow_smem(flash_bwd_dkv_wide_kernel<T>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(B * H, (S + kBK - 1) / kBK, (D + kSlice - 1) / kSlice);
  flash_bwd_dkv_wide_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<const int*>(kv_len), static_cast<T*>(dk),
      static_cast<T*>(dv), layout(strides), layout(strides + 3),
      layout(strides + 6), layout(strides + 9), H, S, D, scale, causal);
  return static_cast<int>(cudaGetLastError());
}

// D > 256 (a multiple of kDC): the wide kernels, f32 and bf16.
#define KFTPU_FLASH_WIDE(WIDE, ...)                                      \
  do {                                                                   \
    if (D > 256) {                                                       \
      if (D % kDC) return static_cast<int>(cudaErrorInvalidValue);       \
      return is_bf16 ? WIDE<bf16>(__VA_ARGS__) : WIDE<float>(__VA_ARGS__); \
    }                                                                    \
  } while (0)

// One dispatch over (dtype, head dim) for the three entry points, after
// bf16 at D = 64 has gone to the wgmma kernels: BF16 launches bf16 inputs
// at D = 128 (the mma.sync kernels), FMA f32 inputs, and bf16 ones at
// D = 256, where the mma kernels' fragments would not fit the registers.
#define KFTPU_FLASH_DISPATCH_REST(BF16, FMA, ...)                        \
  do {                                                                   \
    if (is_bf16 && D == 128) return BF16<bf16, 128>(__VA_ARGS__);        \
    if (is_bf16 && D == 256) return FMA<bf16, 256>(__VA_ARGS__);         \
    if (!is_bf16 && D == 64) return FMA<float, 64>(__VA_ARGS__);         \
    if (!is_bf16 && D == 128) return FMA<float, 128>(__VA_ARGS__);       \
    if (!is_bf16 && D == 256) return FMA<float, 256>(__VA_ARGS__);       \
    return static_cast<int>(cudaErrorInvalidValue);                      \
  } while (0)

}  // namespace

// strides: 3 element strides (b, s, h) each of q, k, v; out is a dense
// (B, S, H, D) tensor in q's dtype, lse a dense (B, H, S) f32 tensor;
// kv_len is (B,) int32 or null. bf16 rows must start on 16 bytes (the
// wrapper checks). bf16 at D = 64 runs the wgmma kernel over `work`:
// n_work (tile, first, end) int32 triples, heaviest first, of block_q-row
// q tiles walking block_k-key kv stages: block_q 64 or 192 (the kernel
// at NC = 1 or 3 consumer warpgroups, the tile table's choice), block_k
// the kernel's kFwdStep; the strides must be ones a TMA map encodes (the
// wrapper checks) and scale > 0. `counters` is 2 int32 zeros kept for
// this stream (the kernel leaves them zero). Other dtypes and head dims
// ignore work and counters. Returns cudaGetLastError() after the launch
// (0 = cudaSuccess).
extern "C" int kftpu_flash_fwd(const void* q, const void* k, const void* v,
                               const void* kv_len, void* out, void* lse,
                               const long long* strides, const void* work,
                               int B, int H, int S, int D, int n_work,
                               int block_q, int block_k, float scale,
                               int causal, int is_bf16, void* stream,
                               void* counters) {
  if (B == 0 || S == 0) return 0;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (is_bf16 && D == 64) {
    if (work == nullptr || counters == nullptr || block_k != kFwdStep ||
        !(scale > 0.f))
      return static_cast<int>(cudaErrorInvalidValue);
    if (block_q == 64)
      return launch_fwd_wgmma<1>(q, k, v, kv_len, work, n_work, counters,
                                 out, lse, strides, B, H, S, scale, causal,
                                 s);
    if (block_q == 192)
      return launch_fwd_wgmma<3>(q, k, v, kv_len, work, n_work, counters,
                                 out, lse, strides, B, H, S, scale, causal,
                                 s);
    return static_cast<int>(cudaErrorInvalidValue);
  }
  KFTPU_FLASH_WIDE(launch_fwd_wide, q, k, v, kv_len, out, lse, strides, B, H,
                   S, D, scale, causal, s);
  KFTPU_FLASH_DISPATCH_REST(launch_fwd_mma, launch_fwd, q, k, v, kv_len, out,
                            lse, strides, B, H, S, scale, causal, s);
}

// strides: (b, s, h) of q, k, v and dO; lse and delta are dense (B, H, S)
// f32; dq is a dense (B, S, H, D) tensor in q's dtype. bf16 rows on 16
// bytes. bf16 at D = 64 is kftpu_flash_bwd's (cudaErrorInvalidValue here).
extern "C" int kftpu_flash_bwd_dq(const void* q, const void* k, const void* v,
                                  const void* dout, const void* lse,
                                  const void* delta, const void* kv_len,
                                  void* dq, const long long* strides, int B,
                                  int H, int S, int D, float scale,
                                  int causal, int is_bf16, void* stream) {
  if (B == 0 || S == 0) return 0;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  KFTPU_FLASH_WIDE(launch_dq_wide, q, k, v, dout, lse, delta, kv_len, dq,
                   strides, B, H, S, D, scale, causal, s);
  KFTPU_FLASH_DISPATCH_REST(launch_dq_mma, launch_dq, q, k, v, dout, lse,
                            delta, kv_len, dq, strides, B, H, S, scale,
                            causal, s);
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
  KFTPU_FLASH_WIDE(launch_dkv_wide, q, k, v, dout, lse, delta, kv_len, dk,
                   dv, strides, B, H, S, D, scale, causal, s);
  KFTPU_FLASH_DISPATCH_REST(launch_dkv_mma, launch_dkv, q, k, v, dout, lse,
                            delta, kv_len, dk, dv, strides, B, H, S, scale,
                            causal, s);
}

// dQ, dK and dV in one pass: bf16 at D = 64 only. Arguments as
// kftpu_flash_bwd_dkv, with dq beside dk and dv; the strides must be ones
// a TMA map encodes (the wrapper checks). `work` is the fused kernel's
// list for one head: n_work (kv tile, first q tile, end q tile) int32
// triples in descending kv tile, of block_k-key kv tiles walking
// block_q-row q tiles, which must be the kernel's own (kWgStep,
// kWgTile). `counters` is 1 + B * H * ceil(S / block_q) int32 zeros (the
// item counter, then the adds landed in each (head, q tile)); `ws` a
// dense (B, S, H, D) f32 workspace, written before it is read. Returns
// cudaGetLastError() after the launches (0 = cudaSuccess).
extern "C" int kftpu_flash_bwd(const void* q, const void* k, const void* v,
                               const void* dout, const void* lse,
                               const void* delta, const void* kv_len,
                               void* dq, void* dk, void* dv,
                               const long long* strides, const void* work,
                               void* counters, void* ws, int B, int H, int S,
                               int D, int n_work, int block_q, int block_k,
                               float scale, int causal, int is_bf16,
                               void* stream) {
  if (B == 0 || S == 0) return 0;
  if (!is_bf16 || D != 64 || work == nullptr || counters == nullptr ||
      ws == nullptr || block_q != kWgStep || block_k != kWgTile)
    return static_cast<int>(cudaErrorInvalidValue);
  return launch_bwd_wgmma(q, k, v, dout, lse, delta, kv_len, work, n_work,
                          counters, ws, dq, dk, dv, strides, B, H, S, scale,
                          causal, reinterpret_cast<cudaStream_t>(stream));
}
