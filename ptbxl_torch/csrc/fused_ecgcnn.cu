// K2 and K3: the ECGCNN and FiLM multimodal inference forwards, hand-written
// for Hopper.
//
// Replaces ptbxl_tpu/ops/pallas/fused_ecgcnn.py: _make_kernel (:89), launched
// by _fused_logits_jit (:155) through fused_ecgcnn_logits / _probs (:138/:213)
// (K2), and _make_mm_kernel (:260), launched by _fused_mm_jit (:319) through
// fused_multimodal_logits / _probs (:305/:360) (K3).
// Per record: optional per-lead z-score -> 4 x (SAME pad 7, conv k=15 as 15
// shifted [T,Cin]x[Cin,Cout] products with f32 accumulation, + BN-folded bias,
// ReLU, MaxPool(2) with floor) -> mean over T -> proj -> head = logits.
//
// Bound on the H100: operations.  1.133 GFLOP a record at T=5000 (57.6 +
// 153.6 + 307.2 + 614.4 MFLOP for the four blocks), 580 GFLOP at B=512: 8.65 ms
// at the 67 TFLOP/s of FP32 FMA.  The TPU kernel runs these f32 products on
// its matrix unit in several bf16 passes; the card's counterpart is 3xTF32 on
// the tensor cores.  Each f32 operand is split as a = big + small, big =
// tf32(a), small = tf32(a - big), and a*b is taken as small*big + big*small +
// big*big with f32 sums; the dropped small*small and the rounding of small
// leave about 2^-22 of |a*b|.  Three TF32 products per f32 product at 495
// TFLOP/s take 3.51 ms at B=512 (the blocks 0.18 / 0.48 / 0.95 / 1.91 ms).
// The bytes (the input read once, the logits written; ~1.3 GB of
// intermediates at B=512, ~0.4 ms) are below either.
//
// The TPU kernel keeps a whole record (~2 MB) on chip; an H100 block has at
// most 227 KB of shared memory and one f32 [5000, 12] input alone is 240 KB.
// So the forward is a short sequence of launches on the caller's stream, with
// intermediates in device memory:
//   ptbxl_conv_block_tf32x3 (once per block): an implicit GEMM on Hopper's
//     warpgroup MMA (wgmma.mma_async m64nNk8 .f32.tf32.tf32), K4's design
//     (hybrid_wgmma.cu) carried to 3xTF32.  A tile is BM conv rows x BN
//     output channels of one record.  Its consumer warpgroups stage the
//     tile's f32 input rows with their 14-row halo once in shared memory by
//     cp.async, zero outside [0, T) and for padded channels, so SAME padding
//     pads the *normalized* signal; block 0 z-scores the landed rows in
//     place.  Row m of the GEMM's A at reduction column tap*CinP + c is tile
//     row m + tap at channel c, so each k8 step's A is a window of shifted
//     rows, read by ldmatrix (an 8 x 4 tile of f32 is an 8 x 8 tile of b16,
//     and the fragment ldmatrix gives of it is a warp's part of wgmma's
//     m64k8 TF32 register A), split in registers into big and small, and fed
//     as wgmma's register A: TF32 wgmma takes only K-major operands from
//     shared memory, and register A writes no im2col.  The weights are the B
//     operand, from shared memory: prepare_weights splits them once on the
//     host into big and small planes, [k8 step][plane][Cout/8][K half][8][4]
//     (wgmma's K-major core matrices without swizzle: 128 contiguous bytes,
//     128 between the two K halves, 256 between 8-channel groups), so a slice
//     of BN channels of one step's plane is one contiguous run.  A producer
//     warp moves them by 1-D bulk copies (cp.async.bulk) onto mbarriers: the
//     whole slice once for the CTA's life where it fits (block 0, 61 KB),
//     else through a ring of stages of STEPS k8 steps, as deep as the shared
//     memory left over holds (two to eight).  Each product is three wgmmas,
//     the small terms first (small*big, big*small, big*big), into sums that
//     restart at every stage (scale-d = 0 on its first product) and are added
//     to the running sums in f32: the tensor cores' own sums truncate, so
//     their error would compound over a whole reduction (up to 720 chained
//     products); restarted every stage (at most 64 reduction columns), each
//     block stays within chip_smoke.py's gate (2^-18 of the block's |x| conv
//     |w|).  A stage's products are issued, waited for
//     and its slot released, and the two consumer warpgroups take turns on
//     the tensor cores; the waits at each stage's end are what the deep
//     stages amortise.  CTAs are persistent: each takes tiles grid-stride
//     and, when it takes more than one, fetches the next tile's rows into a
//     second staged tile while it multiplies this one (when shared memory
//     holds two beside a ring of two).  Bias, ReLU and the floor pool happen
//     in the epilogue as a shuffle (the two conv rows of a window sit in
//     lanes 4 apart), and only [T/2, Cout] is written.
//     Tiles (PTBXL_TF32_TILES): a consumer warpgroup keeps its stage sums
//     and running sums in registers, RM x BN / 2 floats a thread each,
//     so at most m64 x n128 a warpgroup; two warpgroups and a producer
//     warpgroup make 384 threads, which get 168 registers each unless the
//     producer hands its own to the consumers (setmaxnreg: 40 and 232).
//     Measured on the H100 (PERF.md §6): an n128 wgmma with register A
//     keeps the tensor cores far busier than n64 or n32 ones, and the stage
//     waits cost less the more k8 steps a stage holds, so blocks 2 and 3 take
//     m128 x n128 tiles of eight-step stages (block 3 in two channel
//     slices), block 1 (Cout 64) m256 x n64, block 0 (Cout 32) m256 x n32;
//     block 0 stays the least efficient (n32, and CinP 16 for 12 leads).  A
//     grid without a tile for every SM takes m64 x n32 tiles of one consumer
//     warpgroup, two CTAs an SM, so a B=1 chunk still spreads over the card
//     (block 3: 80 tiles).
//   ptbxl_tail: one block per record: mean over T, proj, head.
// K3 runs the same backbone launches (the folded backbone is the same
// function with weights in the same layout) and ends in ptbxl_mm_tail: one
// block per record, ~4.6 KB of shared memory at full width: mean over T,
// proj, demographics MLP (fc1, fc2 with ReLU), FiLM (gamma = 1 + tanh,
// z = gamma * z_ecg + beta) and head.  Its ~0.21 MFLOP a record are nothing
// beside the backbone's 1.133 GFLOP, so K3's bound is K2's.
// The same f32 conv block serves K4's f32 deep blocks (hybrid_ecgcnn.py).
//
// With bf16 compute (every operand rounded to bf16, sums in f32: JAX's
// preferred_element_type=f32) K2 and K3 run K4's launches on the tensor cores
// (hybrid_wgmma.cu: the wgmma conv block, then sums_tail or, for K3,
// mm_sums_tail), so this file's tails are f32 only.  The bf16 FMA block below
// (256 threads own TR conv rows x CO channels, stage the input tile and the
// weights 8 channels at a time and keep a 4 x 4 register tile of sums a
// thread) serves only ptbxl_conv_block_valid: on a pre-padded input, the
// "direct" mode of the P3 layer probe (tools/probe_layer_perf.py
// make_pallas_layer, :52).
// Later work: fusing blocks so intermediates stay on chip.
#include "hopper.cuh"

namespace {

constexpr int kK = 15;          // conv taps
constexpr int kPad = kK / 2;    // SAME padding
constexpr int kSmemMax = 232448;  // shared memory a block may ask for

// -- the f32 conv block: 3xTF32 on wgmma -----------------------------------------------

constexpr int kMaxStages = 8;   // weight ring slots, as many as shared memory holds
constexpr int kXSkew = 4;       // floats of padding a staged row (ldmatrix bank spread)

// f32 bits -> TF32 as cvt.rna.tf32.f32 rounds (to nearest, ties away from
// zero), with the 13 low bits zero (fused_ecgcnn.py tf32_round)
__device__ __forceinline__ uint32_t tf32_rna(uint32_t bits) {
  return (bits + 0x1000u) & 0xffffe000u;
}

// a = big + small to 2^-22 |a|; a - big is exact in f32
__device__ __forceinline__ void split_tf32(uint32_t a, uint32_t& big, uint32_t& small) {
  big = tf32_rna(a);
  small = tf32_rna(__float_as_uint(__uint_as_float(a) - __uint_as_float(big)));
}

// One launch's shapes and its shared-memory plan (Tf32Tile::plan)
struct ConvArgs {
  const float* x;      // [B, T, Cin] f32
  const float* stats;  // [B, Cin, 2] (mean, std+eps), or null: no z-score
  const float* w;      // [15*CinP/8, 2, 8*Cout] (tf32x3_weight)
  const float* bias;   // [Cout]
  float* y;            // [B, T/2, Cout]
  int T, Cin, CinP, Cout;
  int row_tiles, n_tiles;
  int stages;    // ring slots (resident: every stage of the slice)
  int resident;  // the slice's weights stay for the CTA's life (Cout == BN)
  int nxs;       // staged input tiles: 2 when a CTA takes more than one tile
  int vec;       // rows land by 16-byte copies (Cin % 4 == 0, x 16-byte aligned)
};

// A tile: WGS consumer warpgroups, each RM m64 tiles of BN channels, and a
// producer warpgroup (one warp of it works); the weights stream STEPS k8 steps
// (8 * STEPS reduction columns) a stage.  With two consumer warpgroups and one
// CTA an SM the producer gives its registers to the consumers (setmaxnreg):
// 384 threads would otherwise get 168 registers each.
template <int BN, int RM, int WGS, int STEPS, int MINB>
struct WgTile {
  static constexpr int kBN = BN;
  static constexpr int kConsumers = WGS * 128;
  static constexpr int kThreads = kConsumers + 128;
  static constexpr bool kShiftRegs = WGS == 2 && MINB == 1;
  static constexpr int kProducerRegs = 40, kConsumerRegs = 232;  // 128 x 40 + 256 x 232 <= 64 K
  static constexpr int kBM = WGS * 64 * RM;                     // conv rows a tile
  static constexpr int kRows = kBM + kK - 1;                    // staged input rows
  static constexpr int kNacc = BN / 2;                          // sums a thread, per m64 tile
  static constexpr uint32_t kPlaneBytes = BN * 32;              // one plane of a k8 step
  static constexpr uint32_t kStageBytes = STEPS * 2 * kPlaneBytes;
  static_assert(BN == 32 || BN == 64 || BN == 128, "wgmma widths");
  static_assert(RM * BN <= 128, "part and running sums: <= 128 floats a thread each");
};

// Tile `tile`'s input rows t0 - 7 + r (r < kRows) into the staged tile xs (row
// stride CinP + kXSkew) by cp.async, zeros outside [0, T); channels >= Cin are
// never written (zeroed once at the start)
template <class S>
__device__ __forceinline__ void issue_rows(const ConvArgs& a, int tile, float* xs, int tid) {
  const int nsl = a.Cout / S::kBN;
  const int rt = (tile / nsl) % a.row_tiles, rec = tile / (nsl * a.row_tiles);
  const float* xr = a.x + (size_t)rec * a.T * a.Cin;
  const int u0 = rt * S::kBM - kPad, xsr = a.CinP + kXSkew;
  if (a.vec) {
    const int c4s = a.Cin / 4;
    for (int i = tid; i < S::kRows * c4s; i += S::kConsumers) {
      const int r = i / c4s, c = (i - r * c4s) * 4, t = u0 + r;
      const bool in = t >= 0 && t < a.T;
      cp_async16_zfill(xs + r * xsr + c, xr + (size_t)(in ? t : 0) * a.Cin + c, in);
    }
  } else {
    for (int i = tid; i < S::kRows * a.Cin; i += S::kConsumers) {
      const int r = i / a.Cin, c = i - r * a.Cin, t = u0 + r;
      const bool in = t >= 0 && t < a.T;
      cp_async4_zfill(xs + r * xsr + c, xr + (size_t)(in ? t : 0) * a.Cin + c, in);
    }
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// y = pool(relu(conv_SAME(z(x), w) + bias)), see ConvArgs.  Persistent: CTA c
// takes tiles c, c + grid, ... (tile = (record, row tile, channel slice), the
// slice fastest); the producer warp streams each tile's weight stages through
// the ring without a break, and the consumers fetch the next tile's rows
// while they multiply this one's (nxs == 2).
template <int BN, int RM, int WGS, int MINB, int STEPS>
__global__ void __launch_bounds__(WgTile<BN, RM, WGS, STEPS, MINB>::kThreads, MINB)
tf32x3_conv_block_kernel(const ConvArgs a) {
  using S = WgTile<BN, RM, WGS, STEPS, MINB>;
  constexpr int kSteps = STEPS;
  extern __shared__ __align__(128) unsigned char smem[];
  const int xsr = a.CinP + kXSkew;
  unsigned char* ring = smem;  // a.stages slots of kStageBytes: [step][plane][BN/8][2][8][4]
  float* xs0 = reinterpret_cast<float*>(smem + (size_t)a.stages * S::kStageBytes);
  uint64_t* full = reinterpret_cast<uint64_t*>(xs0 + (size_t)a.nxs * S::kRows * xsr);
  uint64_t* empty = full + a.stages;
  const int nsl = a.Cout / BN;
  const int n_stage = kK * a.CinP / 8 / kSteps;  // whole stages (the launcher checked)
  const int tid = threadIdx.x;

  if (tid == 0) {
    for (int s = 0; s < a.stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], WGS);  // one arrival a consumer warpgroup
    }
    fence_mbarrier_init();
  }
  const int padc = a.CinP - a.Cin;  // padded channels: zero in every staged tile
  for (int i = tid; i < a.nxs * S::kRows * padc; i += S::kThreads) {
    const int r = i / padc;
    xs0[r * xsr + a.Cin + (i - r * padc)] = 0.f;
  }
  __syncthreads();

  if (tid >= S::kConsumers) {  // the producer warpgroup: its first warp streams the weights
    if constexpr (S::kShiftRegs)
      asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(S::kProducerRegs));
    if (tid >= S::kConsumers + 32) return;
    const int lane = tid & 31;
    int g = 0;  // stages issued so far, over all of this CTA's tiles
    const int last = a.resident ? blockIdx.x + 1 : a.n_tiles;
    for (int tile = blockIdx.x; tile < last; tile += gridDim.x) {
      const float* src = a.w + (size_t)(tile % nsl) * BN * 8;
      for (int s = 0; s < n_stage; ++s, ++g) {
        const int slot = a.resident ? s : g % a.stages;
        if (!a.resident && g >= a.stages) mbar_wait(&empty[slot], ((g / a.stages) - 1) & 1);
        if (lane == 0) mbar_expect_tx(&full[slot], S::kStageBytes);
        __syncwarp();
        if (lane < 2 * kSteps) {  // lane 2j + p: plane p of the stage's step j
          const int j = lane >> 1, p = lane & 1;
          bulk_load(ring + (size_t)slot * S::kStageBytes + (2 * j + p) * S::kPlaneBytes,
                    src + ((size_t)(s * kSteps + j) * 2 + p) * a.Cout * 8, S::kPlaneBytes,
                    &full[slot]);
        }
      }
    }
    return;
  }

  if constexpr (S::kShiftRegs)
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(S::kConsumerRegs));
  const int wg = tid >> 7;
  const int warp = (tid >> 5) & 3, lane = tid & 31;
  const int lrow = lane & 15, lcol = (lane >> 4) * 4;  // ldmatrix: rows 0-15 x columns 0-3 | 4-7
  const int mrow0 = wg * 64 * RM + warp * 16;          // this warp's first row of m64 tile 0
  const int g8 = lane >> 2, q = lane & 3;
  const int half = a.T / 2;  // MaxPool(2) floors odd lengths
  const int cpt = a.CinP / 8;  // k8 steps a tap
  int g = 0;                 // stages consumed so far
  int buf = 0;

  if (blockIdx.x < a.n_tiles) issue_rows<S>(a, blockIdx.x, xs0, tid);
#pragma unroll 1
  for (int tile = blockIdx.x; tile < a.n_tiles; tile += gridDim.x) {
    const int ns = tile % nsl, rt = (tile / nsl) % a.row_tiles, rec = tile / (nsl * a.row_tiles);
    const int t0 = rt * S::kBM;
    float* xs = xs0 + (size_t)buf * S::kRows * xsr;
    if (a.nxs == 1 && tile != blockIdx.x) {
      consumer_sync<S::kConsumers>();  // every consumer is done with the last tile's rows
      issue_rows<S>(a, tile, xs, tid);
    }
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    consumer_sync<S::kConsumers>();  // this tile's rows have landed
    if (a.stats) {  // block 0: z-score the landed rows in place; the padding stays 0
      const float* st = a.stats + (size_t)rec * a.Cin * 2;
      for (int i = tid; i < S::kRows * a.Cin; i += S::kConsumers) {
        const int r = i / a.Cin, c = i - r * a.Cin, t = t0 - kPad + r;
        if (t >= 0 && t < a.T) {
          float* v = xs + r * xsr + c;
          *v = (*v - st[2 * c]) / st[2 * c + 1];
        }
      }
      consumer_sync<S::kConsumers>();
    }
    const int next = tile + gridDim.x;
    if (a.nxs == 2 && next < a.n_tiles)
      issue_rows<S>(a, next, xs0 + (size_t)(buf ^ 1) * S::kRows * xsr, tid);

    // each stage sums into part, which its first product starts from zero, and
    // part is added to acc in f32: the tensor cores' own sums do not round to
    // nearest, so their error compounds when one accumulator is chained over
    // the whole reduction (up to 720 products); restarted each stage, the
    // block stays within chip_smoke.py's per-block gate (2^-18 of the block's
    // |x| conv |w|)
    float acc[RM][S::kNacc], part[RM][S::kNacc];
#pragma unroll
    for (int rm = 0; rm < RM; ++rm)
#pragma unroll
      for (int i = 0; i < S::kNacc; ++i) acc[rm][i] = 0.f;

    const int arow = mrow0 + lrow;
#pragma unroll 1
    for (int s = 0; s < n_stage; ++s, ++g) {
      // the stage's A fragments (k8 step (tap, c0): staged rows m + tap,
      // channels c0..c0+7; an 8-wide slice never straddles taps), split
      uint32_t ab[kSteps][RM][4], as[kSteps][RM][4];
#pragma unroll
      for (int j = 0; j < kSteps; ++j) {
        const int step = s * kSteps + j;
        const int tap = step / cpt, c0 = (step - tap * cpt) * 8;
#pragma unroll
        for (int rm = 0; rm < RM; ++rm) {
          uint32_t f[4];
          ldmatrix_x4(f, xs + (arow + rm * 64 + tap) * xsr + c0 + lcol);
#pragma unroll
          for (int e = 0; e < 4; ++e) split_tf32(f[e], ab[j][rm][e], as[j][rm][e]);
        }
      }
      const int slot = a.resident ? s : g % a.stages;
      mbar_wait(&full[slot], a.resident ? 0 : (g / a.stages) & 1);
      const unsigned char* wb = ring + (size_t)slot * S::kStageBytes;
      wg_fence();
#pragma unroll
      for (int j = 0; j < kSteps; ++j) {
        const uint64_t big = b_desc(wb + 2 * j * S::kPlaneBytes, 128, 256);
        const uint64_t small = big + (S::kPlaneBytes >> 4);
#pragma unroll
        for (int rm = 0; rm < RM; ++rm) {
          if (j == 0) wgmma_tf32<BN, 0>(part[rm], as[j][rm], big);
          else wgmma_tf32<BN, 1>(part[rm], as[j][rm], big);
          wgmma_tf32<BN, 1>(part[rm], ab[j][rm], small);
          wgmma_tf32<BN, 1>(part[rm], ab[j][rm], big);
        }
      }
      wg_commit();
      wg_wait<0>();
#pragma unroll
      for (int rm = 0; rm < RM; ++rm)
#pragma unroll
        for (int i = 0; i < S::kNacc; ++i) pin(part[rm][i]);
#pragma unroll
      for (int j = 0; j < kSteps; ++j)
#pragma unroll
        for (int rm = 0; rm < RM; ++rm)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            pin(ab[j][rm][e]);
            pin(as[j][rm][e]);
          }
      if (!a.resident && (tid & 127) == 0) mbar_arrive(&empty[slot]);
#pragma unroll
      for (int rm = 0; rm < RM; ++rm)
#pragma unroll
        for (int i = 0; i < S::kNacc; ++i) acc[rm][i] += part[rm][i];
    }

    // epilogue: sum i of n8 chunk c is row g8 (i < 2) or g8 + 8, column 8c +
    // 2q + (i & 1); rows g8 and g8 + 1 of a pool window are lanes 4 apart
    const int n0 = ns * BN;
    float* y = a.y + (size_t)rec * half * a.Cout;
#pragma unroll
    for (int rm = 0; rm < RM; ++rm) {
      const int row = t0 + mrow0 + rm * 64 + g8;  // even g8: a pool window starts here
#pragma unroll
      for (int c = 0; c < BN / 8; ++c) {
        float p[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) p[e] = __shfl_xor_sync(0xffffffffu, acc[rm][4 * c + e], 4);
        if ((g8 & 1) == 0) {
          const int col = n0 + 8 * c + 2 * q;
          const float b0 = a.bias[col], b1 = a.bias[col + 1];
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int prow = (row + 8 * h) / 2;
            if (prow < half) {
              float2 o;
              o.x = fmaxf(fmaxf(acc[rm][4 * c + 2 * h] + b0, 0.f), fmaxf(p[2 * h] + b0, 0.f));
              o.y = fmaxf(fmaxf(acc[rm][4 * c + 2 * h + 1] + b1, 0.f),
                          fmaxf(p[2 * h + 1] + b1, 0.f));
              *reinterpret_cast<float2*>(y + (size_t)prow * a.Cout + col) = o;
            }
          }
        }
      }
    }
    if (a.nxs == 2) buf ^= 1;
  }
}

// -- the bf16 conv block: FMA, operands rounded to bf16 ----------------------------

constexpr int kCI = 8;            // input channels staged per step
constexpr int kStride = kCI + 1;  // padded row stride of the input tile (bank spread)
constexpr int kThreads = 256;
constexpr int kRowsPerThread = 4;  // conv rows, i.e. two pool windows
constexpr int kColsPerThread = 4;

// x [B, Tx, Cin] f32, pre-padded: conv row t in [0, T = Tx - 14) reads rows
// t .. t + 14 (VALID); w [K, Cin, Cout]; bias [Cout]; y [B, T/2, Cout].
template <int kCO>
__global__ void __launch_bounds__(kThreads)
conv_block_bf16_kernel(const float* __restrict__ x, const float* __restrict__ w,
                       const float* __restrict__ bias, float* __restrict__ y, int Tx, int T,
                       int Cin, int Cout, int row_tiles) {
  constexpr int kNX = kCO / kColsPerThread;   // threads across channels
  constexpr int kNY = kThreads / kNX;         // threads across rows
  constexpr int kTR = kNY * kRowsPerThread;   // conv rows per block
  constexpr int kInRows = kTR + kK - 1;
  __shared__ float in_s[kInRows * kStride];
  __shared__ float w_s[kK * kCI * kCO];

  const int rec = blockIdx.x / row_tiles;
  const int t0 = (blockIdx.x % row_tiles) * kTR;  // first conv row of the tile
  const int co0 = blockIdx.y * kCO;
  const int tx = threadIdx.x % kNX;
  const int ty = threadIdx.x / kNX;
  const int r0 = ty * kRowsPerThread;
  const float* xr = x + (long)rec * Tx * Cin;

  float acc[kRowsPerThread][kColsPerThread];
#pragma unroll
  for (int r = 0; r < kRowsPerThread; ++r)
#pragma unroll
    for (int j = 0; j < kColsPerThread; ++j) acc[r][j] = 0.f;

  for (int c0 = 0; c0 < Cin; c0 += kCI) {
    for (int idx = threadIdx.x; idx < kInRows * kCI; idx += kThreads) {
      const int row = idx / kCI, ci = idx % kCI;
      const int t = t0 + row, c = c0 + ci;
      const float v = t < Tx && c < Cin ? xr[(long)t * Cin + c] : 0.f;
      in_s[row * kStride + ci] = rnd_bf16(v);
    }
    for (int idx = threadIdx.x; idx < kK * kCI * kCO; idx += kThreads) {
      const int k = idx / (kCI * kCO), rem = idx % (kCI * kCO);
      const int ci = rem / kCO, co = rem % kCO;
      const int c = c0 + ci;
      w_s[idx] = c < Cin ? rnd_bf16(w[((long)k * Cin + c) * Cout + co0 + co]) : 0.f;
    }
    __syncthreads();

#pragma unroll 1
    for (int k = 0; k < kK; ++k) {
#pragma unroll
      for (int ci = 0; ci < kCI; ++ci) {
        float a[kRowsPerThread], b[kColsPerThread];
#pragma unroll
        for (int r = 0; r < kRowsPerThread; ++r) a[r] = in_s[(r0 + r + k) * kStride + ci];
#pragma unroll
        for (int j = 0; j < kColsPerThread; ++j) b[j] = w_s[(k * kCI + ci) * kCO + tx + kNX * j];
#pragma unroll
        for (int r = 0; r < kRowsPerThread; ++r)
#pragma unroll
          for (int j = 0; j < kColsPerThread; ++j) acc[r][j] = fmaf(a[r], b[j], acc[r][j]);
      }
    }
    __syncthreads();
  }

  const int half = T / 2;  // MaxPool(2) floors odd lengths
  float* yr = y + (long)rec * half * Cout;
#pragma unroll
  for (int j = 0; j < kColsPerThread; ++j) {
    const int co = co0 + tx + kNX * j;
    const float bj = bias[co];
#pragma unroll
    for (int p = 0; p < kRowsPerThread / 2; ++p) {
      const int prow = (t0 + r0) / 2 + p;
      if (prow < half) {
        const float v0 = fmaxf(acc[2 * p][j] + bj, 0.f);
        const float v1 = fmaxf(acc[2 * p + 1][j] + bj, 0.f);
        yr[(long)prow * Cout + co] = fmaxf(v0, v1);
      }
    }
  }
}

// h [B, T, C] -> logits [B, L]: g = mean_t h; z = g @ pw + pb; logits = z @ hw + hb.
__global__ void tail_kernel(const float* __restrict__ h, const float* __restrict__ pw,
                            const float* __restrict__ pb, const float* __restrict__ hw,
                            const float* __restrict__ hb, float* __restrict__ logits,
                            int T, int C, int F, int L) {
  extern __shared__ float sm[];
  float* g = sm;      // [C]
  float* z = sm + C;  // [F]
  const float* hr = h + (long)blockIdx.x * T * C;
  const float inv_t = 1.f / (float)T;
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    float s = 0.f;
    for (int t = 0; t < T; ++t) s = fmaf(inv_t, hr[(long)t * C + c], s);  // ones/T matmul
    g[c] = s;
  }
  __syncthreads();
  for (int f = threadIdx.x; f < F; f += blockDim.x) {
    float s = 0.f;
    for (int c = 0; c < C; ++c) s = fmaf(g[c], pw[(long)c * F + f], s);
    z[f] = s + pb[f];
  }
  __syncthreads();
  for (int l = threadIdx.x; l < L; l += blockDim.x) {
    float s = 0.f;
    for (int f = 0; f < F; ++f) s = fmaf(z[f], hw[(long)f * L + l], s);
    logits[(long)blockIdx.x * L + l] = s + hb[l];
  }
}

// K3's tail.  h [B, T, C] -> logits [B, L], all weights (in, out):
// g = mean_t h; z_ecg = g @ pw + pb; h1 = relu(demo @ w1 + b1);
// h2 = relu(h1 @ w2 + b2); film = h2 @ wf + bf; gamma = 1 + tanh(film[:F]);
// z = gamma * z_ecg + film[F:]; logits = z @ hw + hb.
__global__ void mm_tail_kernel(const float* __restrict__ h, const float* __restrict__ pw,
                               const float* __restrict__ pb, const float* __restrict__ w1,
                               const float* __restrict__ b1, const float* __restrict__ w2,
                               const float* __restrict__ b2, const float* __restrict__ wf,
                               const float* __restrict__ bf, const float* __restrict__ hw,
                               const float* __restrict__ hb, const float* __restrict__ demo,
                               float* __restrict__ logits, int T, int C, int F, int D, int H1,
                               int H, int L) {
  extern __shared__ float sm[];
  float* g = sm;           // [C]
  float* z = g + C;        // [F]  z_ecg, then z_cond
  float* d = z + F;        // [D]
  float* h1 = d + D;       // [H1]
  float* h2 = h1 + H1;     // [H]
  float* film = h2 + H;    // [2F]
  const long rec = blockIdx.x;
  const float* hr = h + rec * T * C;
  const float inv_t = 1.f / (float)T;
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    float s = 0.f;
    for (int t = 0; t < T; ++t) s = fmaf(inv_t, hr[(long)t * C + c], s);  // ones/T matmul
    g[c] = s;
  }
  for (int k = threadIdx.x; k < D; k += blockDim.x) d[k] = demo[rec * D + k];
  __syncthreads();
  for (int f = threadIdx.x; f < F; f += blockDim.x) {
    float s = 0.f;
    for (int c = 0; c < C; ++c) s = fmaf(g[c], pw[(long)c * F + f], s);
    z[f] = s + pb[f];
  }
  for (int j = threadIdx.x; j < H1; j += blockDim.x) {
    float s = 0.f;
    for (int k = 0; k < D; ++k) s = fmaf(d[k], w1[(long)k * H1 + j], s);
    h1[j] = fmaxf(s + b1[j], 0.f);
  }
  __syncthreads();
  for (int j = threadIdx.x; j < H; j += blockDim.x) {
    float s = 0.f;
    for (int k = 0; k < H1; ++k) s = fmaf(h1[k], w2[(long)k * H + j], s);
    h2[j] = fmaxf(s + b2[j], 0.f);
  }
  __syncthreads();
  for (int j = threadIdx.x; j < 2 * F; j += blockDim.x) {
    float s = 0.f;
    for (int k = 0; k < H; ++k) s = fmaf(h2[k], wf[(long)k * 2 * F + j], s);
    film[j] = s + bf[j];
  }
  __syncthreads();
  for (int f = threadIdx.x; f < F; f += blockDim.x) {
    const float gamma = 1.f + tanhf(film[f]);
    z[f] = __fadd_rn(__fmul_rn(gamma, z[f]), film[F + f]);  // not fused, as in JAX
  }
  __syncthreads();
  for (int l = threadIdx.x; l < L; l += blockDim.x) {
    float s = 0.f;
    for (int f = 0; f < F; ++f) s = fmaf(z[f], hw[(long)f * L + l], s);
    logits[rec * L + l] = s + hb[l];
  }
}

// A tile's launch plan: two staged tiles when a CTA takes more than one tile,
// else one, and a weight ring as deep as the shared memory left over holds
// (up to kMaxStages), or the whole slice for the CTA's life when Cout == BN
// and it fits.  False when the channels do not divide or no ring of two fits.
template <int BN, int RM, int WGS, int MINB, int STEPS>
struct Tf32Tile {
  using S = WgTile<BN, RM, WGS, STEPS, MINB>;
  // shared memory a CTA may take with MINB CTAs an SM (228 KB an SM, 1 KB of
  // it reserved a CTA, 227 KB at most a CTA)
  static constexpr size_t kBudget = MINB == 1 ? kSmemMax : 233472 / MINB - 1024;
  static int row_tiles(int T) { return (2 * (T / 2) + S::kBM - 1) / S::kBM; }

  static bool plan(ConvArgs& a, int B, int sms, size_t& smem, int& grid) {
    if (a.Cout % BN || (kK * a.CinP / 8) % STEPS) return false;
    const long n = (long)B * row_tiles(a.T) * (a.Cout / BN), cap = (long)sms * MINB;
    if (n > 0x7fffffff) return false;
    const size_t xs = (size_t)S::kRows * (a.CinP + kXSkew) * sizeof(float);
    const int n_stage = kK * a.CinP / 8 / STEPS;
    const size_t slot = S::kStageBytes + 2 * sizeof(uint64_t);  // a stage and its two mbarriers
    for (int nxs = n > cap ? 2 : 1; nxs >= 1; --nxs) {
      if (nxs * xs >= kBudget) continue;
      const size_t avail = kBudget - nxs * xs;
      const bool resident = a.Cout == BN && (size_t)n_stage * slot <= avail;
      const size_t fit = avail / slot;
      const int stages = resident ? n_stage : (int)(fit < (size_t)kMaxStages ? fit : kMaxStages);
      if (stages < 2) continue;
      a.row_tiles = row_tiles(a.T);
      a.n_tiles = (int)n;
      a.stages = stages;
      a.resident = resident;
      a.nxs = nxs;
      smem = nxs * xs + stages * slot;
      grid = (int)(n < cap ? n : cap);
      return true;
    }
    return false;
  }

  static cudaError_t launch(const ConvArgs& a, size_t smem, int grid, cudaStream_t st) {
    auto kern = tf32x3_conv_block_kernel<BN, RM, WGS, MINB, STEPS>;
    cudaError_t err =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    kern<<<grid, S::kThreads, smem, st>>>(a);
    return cudaGetLastError();
  }
};

// The tiles, widest first, one a line: X(BN, RM, consumer warpgroups, CTAs an
// SM, k8 steps a weight stage), from timing every block at B = 1, 16 and 512
// on the H100 (PERF.md §6).  The launcher takes the first row whose
// channels divide Cout, whose stages tile the reduction, whose shared memory
// fits and whose grid gives every SM a tile; else the last that fits (the
// smallest tile, so a B=1 chunk still spreads over the card).
#define PTBXL_TF32_TILES(X) \
  X(128, 1, 2, 1, 8)  /* m128 x n128: blocks 2 and 3 */      \
  X(64,  2, 2, 1, 4)  /* m256 x n64: block 1 */               \
  X(32,  2, 2, 1, 5)  /* m256 x n32: block 0 */               \
  X(32,  1, 1, 2, 3)  /* m64 x n32, one warpgroup: B = 1 */

int conv_block_tf32x3(int device, const void* x, const void* stats, const void* w3, const void* b,
                      void* y, int B, int T, int Cin, int CinP, int Cout, void* stream) {
  cudaError_t err = ptbxl_ensure_device(device);
  if (err != cudaSuccess) return (int)err;
  if (B <= 0 || T < 2 || Cin <= 0 || CinP < Cin || CinP % 8 || Cout <= 0 || Cout % 32)
    return (int)cudaErrorInvalidValue;
  int sms = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  ConvArgs a{};
  a.x = static_cast<const float*>(x);
  a.stats = static_cast<const float*>(stats);
  a.w = static_cast<const float*>(w3);
  a.bias = static_cast<const float*>(b);
  a.y = static_cast<float*>(y);
  a.T = T, a.Cin = Cin, a.CinP = CinP, a.Cout = Cout;
  a.vec = Cin % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  // the first row that fits with a tile for every SM, else the last that fits
  cudaError_t (*fallback)(const ConvArgs&, size_t, int, cudaStream_t) = nullptr;
  ConvArgs fa{};
  size_t fsmem = 0;
  int fgrid = 0;
#define PTBXL_TF32_TRY(BN, RM, WGS, MINB, STEPS)                                  \
  {                                                                               \
    using Tl = Tf32Tile<BN, RM, WGS, MINB, STEPS>;                                \
    ConvArgs c = a;                                                               \
    size_t smem = 0;                                                              \
    int grid = 0;                                                                 \
    if (Tl::plan(c, B, sms, smem, grid)) {                                        \
      if (c.n_tiles >= sms) return (int)Tl::launch(c, smem, grid, st);            \
      fallback = &Tl::launch, fa = c, fsmem = smem, fgrid = grid;                 \
    }                                                                             \
  }
  PTBXL_TF32_TILES(PTBXL_TF32_TRY)
#undef PTBXL_TF32_TRY
  if (!fallback) return (int)cudaErrorInvalidValue;
  return (int)fallback(fa, fsmem, fgrid, st);
}

template <int kCO>
void launch_conv_bf16(const float* x, const float* w, const float* b, float* y, int B, int Tx,
                      int Cin, int Cout, cudaStream_t st) {
  constexpr int kTR = (kThreads / (kCO / kColsPerThread)) * kRowsPerThread;
  const int T = Tx - (kK - 1);
  const int row_tiles = (2 * (T / 2) + kTR - 1) / kTR;
  dim3 grid(B * row_tiles, Cout / kCO);
  conv_block_bf16_kernel<kCO><<<grid, kThreads, 0, st>>>(x, w, b, y, Tx, T, Cin, Cout, row_tiles);
}

}  // namespace

extern "C" {

// One f32 conv block on wgmma (3xTF32), SAME padding.  x [B, T, Cin] f32;
// stats [B, Cin, 2] or null (no z-score on load); w3 [15*CinP/8, 2, 8*Cout]
// from prepare_weights; b [Cout]; y [B, T/2, Cout].  CinP % 8 == 0, CinP >=
// Cin, Cout % 32 == 0, T >= 2; the tile follows the grid (PTBXL_TF32_TILES).
int ptbxl_conv_block_tf32x3(int device, const void* x, const void* stats, const void* w3,
                            const void* b, void* y, int B, int T, int Cin, int CinP, int Cout,
                            void* stream) {
  return conv_block_tf32x3(device, x, stats, w3, b, y, B, T, Cin, CinP, Cout, stream);
}

// One bf16 conv block on a pre-padded input x [B, Tx, Cin]: conv length T =
// Tx - 14 (VALID), no z-score; y [B, T/2, Cout] (the P3 probe's "direct" layer).
int ptbxl_conv_block_valid(int device, const void* x, const void* w, const void* b, void* y,
                           int B, int Tx, int Cin, int Cout, void* stream) {
  cudaError_t err = ptbxl_ensure_device(device);
  if (err != cudaSuccess) return (int)err;
  if (B <= 0 || Tx < kK + 1 || Cin <= 0 || Cout <= 0 || Cout % 32)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* xs = static_cast<const float*>(x);
  const float* ws = static_cast<const float*>(w);
  const float* bs = static_cast<const float*>(b);
  float* ys = static_cast<float*>(y);
  if (Cout % 64 == 0) launch_conv_bf16<64>(xs, ws, bs, ys, B, Tx, Cin, Cout, st);
  else launch_conv_bf16<32>(xs, ws, bs, ys, B, Tx, Cin, Cout, st);
  return (int)cudaGetLastError();
}

// Mean over T + proj + head.  h [B, T, C]; pw [C, F]; hw [F, L]; logits [B, L].
int ptbxl_tail(int device, const void* h, const void* pw, const void* pb, const void* hw,
               const void* hb, void* logits, int B, int T, int C, int F, int L, void* stream) {
  cudaError_t err = ptbxl_ensure_device(device);
  if (err != cudaSuccess) return (int)err;
  if (B <= 0 || T <= 0 || C <= 0 || F <= 0 || L <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t smem = (size_t)(C + F) * sizeof(float);
  const float* hs = static_cast<const float*>(h);
  const float* pws = static_cast<const float*>(pw);
  const float* pbs = static_cast<const float*>(pb);
  const float* hws = static_cast<const float*>(hw);
  const float* hbs = static_cast<const float*>(hb);
  float* out = static_cast<float*>(logits);
  tail_kernel<<<B, 256, smem, st>>>(hs, pws, pbs, hws, hbs, out, T, C, F, L);
  return (int)cudaGetLastError();
}

// K3's tail: mean over T + proj + demographics MLP + FiLM + head.
// h [B, T, C]; pw [C, F]; fc1_w [D, H1]; fc2_w [H1, H]; film_w [H, 2F];
// hw [F, L]; demo [B, D]; logits [B, L].
int ptbxl_mm_tail(int device, const void* h, const void* pw, const void* pb, const void* fc1_w,
                  const void* fc1_b, const void* fc2_w, const void* fc2_b, const void* film_w,
                  const void* film_b, const void* hw, const void* hb, const void* demo,
                  void* logits, int B, int T, int C, int F, int D, int H1, int H, int L,
                  void* stream) {
  cudaError_t err = ptbxl_ensure_device(device);
  if (err != cudaSuccess) return (int)err;
  if (B <= 0 || T <= 0 || C <= 0 || F <= 0 || D <= 0 || H1 <= 0 || H <= 0 || L <= 0)
    return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)(C + 3 * F + D + H1 + H) * sizeof(float);
  if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;  // no attribute asked for
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  float* out = static_cast<float*>(logits);
  mm_tail_kernel<<<B, 256, smem, st>>>(f(h), f(pw), f(pb), f(fc1_w), f(fc1_b), f(fc2_w),
                                       f(fc2_b), f(film_w), f(film_b), f(hw), f(hb), f(demo), out,
                                       T, C, F, D, H1, H, L);
  return (int)cudaGetLastError();
}

}  // extern "C"
