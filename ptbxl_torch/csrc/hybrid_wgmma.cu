// K4, the hybrid engine, in bf16: every conv block of the ECGCNN on Hopper's
// warpgroup MMA (wgmma), and the tail that reads the last block's channel sums.
//
// Replaces ptbxl_tpu/ops/pallas/hybrid_ecgcnn.py: _make_tail_kernel (:63), the
// deep blocks + mean + proj + head of each record, launched by
// hybrid_ecgcnn_logits (:143, pallas_call :214) after the XLA front
// (_xla_front, :44: the z-score and the first `split` blocks).  On the card no
// block is left to a library: the z-score's statistics come from K1
// (zscore_stats), every block is a launch of the kernel below, and the tail is
// one small kernel.  The same launches are K2's bf16 forward
// (ptbxl_tpu/ops/pallas/fused_ecgcnn.py _make_kernel, :89, with compute_dtype
// bf16: the same function), and with mm_sums_tail K3's (_make_mm_kernel, :260).
//
// What it computes: conv k=15 SAME with bf16 operands and f32 sums, + the f32
// bias, ReLU and the floor MaxPool(2), as the JAX blocks do.  Block 0 reads the
// raw f32 record and applies the per-lead z-score (x - mean) / (std + 1e-6)
// while it stages its tile, then rounds to bf16, where JAX rounds the z-scored
// input for its first conv.  A block's output is stored in bf16: the next conv
// reads it rounded to bf16 (JAX keeps f32 between blocks and casts at the next
// conv), so this is the same value in half the bytes.  The last block stores
// no activations: each tile writes the f32 sums over its pooled rows per
// channel, and the tail adds them in tile order, times 1/T, before proj and
// head (bf16 operands, f32 sums, f32 biases).  SAME padding is zeros of the
// normalised signal and of each pooled output: tile rows outside [0, T) are 0.
//
// What bounds it on the H100: operations.  The four blocks are 57.6 + 153.6 +
// 307.2 + 614.4 MFLOP a record (Cin 12 counted, not the padding to 16): 1.133
// GFLOP, 9.38 ms at B=8192 against 989 TFLOP/s of dense bf16.  The bytes are
// below that: the raw input (240 KB a record) is read once, each bf16
// activation (160 KB) written once and read once: 9.8 GB at B=8192, 2.9 ms at
// 3.35 TB/s.
//
// Design.  An implicit GEMM per tile of BM conv rows of one record (BN = Cout
// output channels).  A CTA stages the tile's BM + 14 input rows once, in bf16,
// in shared memory: row m of the im2col at reduction column tap*CinP + c is
// tile row m + tap at channel c, so the A operand of each k16 step is a
// 16-wide window of shifted rows, read by ldmatrix into registers (wgmma's
// register-A form; no im2col is written).  The weights are the B operand, from
// shared memory: prepare_weights lays them out once as the k16 steps of each
// BN slice, each step a 16 x BN tile in wgmma's K-major core-matrix order (no
// swizzle: 8 x 8 cores of 128 contiguous bytes, leading offset 16*BN bytes
// between the two K halves, stride 128 bytes between 8-column groups).  One
// producer warp moves them by 1-D bulk copies (cp.async.bulk) completing on
// mbarriers: once for the CTA's life where they fit (blocks 0 and 1, 15 and
// 60 KB), else through a ring of up to six stages for every tile.  Two
// consumer warpgroups each own RM m64 tiles of the BM rows; a stage's
// fragments load, its products (wgmma.mma_async m64nBNk16, bf16 -> f32) are
// issued and waited for, and its slot is released; the two warpgroups (and
// two CTAs an SM for the small blocks) take turns on the tensor cores.  The
// CTAs are persistent: each takes tiles grid-stride, and fetches the next
// tile's input rows by cp.async (zero-filled outside [0, T)) while it
// multiplies this one's.  Bias, ReLU and the floor pool happen in the
// epilogue: the two conv rows of a window sit in lanes 4 apart.
// The tiles are PTBXL_WG_TILES below, the fastest of the variants that
// ptbxl_torch/tools/tune_wgmma.py times on the H100 at B=8192; each keeps
// <= 128 accumulators a thread.
//
// P3 and P4, one conv layer of the probes, run on the same block.  They
// replace tools/probe_layer_perf.py make_pallas_layer (:52; its "im2col"
// mode: 15 shifted slices, one [t, 15*Cin] x [15*Cin, Cout] product) and
// tools/probe_sublane_conv.py make_layer (:51; the same layer on a
// channel-major input).  They compute K4's layer, conv k=15 with bf16
// operands and f32 sums + bias, ReLU, floor pool, on the same tiles (the
// table's row for their CinP -> Cout), and differ only at the edges, which
// are compile-time policies of the kernel (InPolicy, OutPolicy): the input is
// f32 and already padded in time (VALID: conv row t reads input rows t ..
// t + 14, which hold data, not zeros; rows past the input are 0), and the
// output is the f32 pooled rows.  P3's input is [B, T+14, Cin] (Cin % 4 ==
// 0): its rows land by 16-byte cp.async as block 0's raw rows do and are
// rounded to bf16 into the tile.  P4's is channel-major, [B, CinP, T+14]
// with every channel holding data: a channel row of T+14 floats is 16-byte
// aligned only when 4 | T+14, so its rows land by 4-byte cp.async, each
// channel row of the tile contiguous (reads along time coalesce), and are
// transposed into the tile 8 channels at a time (one 16-byte store a tile
// row, conflict-free at the skewed row stride).  P4's default output is
// [B, Cout, T/2]: the pooled tile is staged channel-major in the bf16 tile's
// buffer, which is free once every consumer is past its products, in as
// many channel parts as it takes to fit, and each part is written along
// time.  The probes' b_tile (records a TPU grid step) has no counterpart.
// Bound at B=2048: bytes for the first two layers, operations for the last
// two (the probes' bound()).
//
// Fusion.  The JAX kernel keeps a record's blocks in VMEM; a CTA here cannot
// hold a record, so a fused tile recomputes the first block's halo rows.
// Blocks 0+1 and blocks 2+3 (block 3's sums) fused so
// (ptbxl_torch/tools/wgmma_fusions.cu) compute bit for bit what the launches
// compute; on the H100 the first is slower and the second leaves K4's forward
// no faster (tools/tune_wgmma.py, PERF.md), so each block is a launch of its
// own.

#include "hopper.cuh"

#include <type_traits>

// The tile of each block the kernel takes, one row a line (hybrid_ecgcnn.py
// reads the rows from this file: the weights' layout depends on BN, and the
// plain version emulates BM = 128 * RM conv rows a tile; tools/tune_wgmma.py
// builds copies with one row changed).  CinP 16 is block 0: f32 input.  P3's
// and P4's layers take the same rows.
//  X(CinP, Cout,  BN, RM, CTAs an SM, k16 steps a stage)
#define PTBXL_WG_TILES(X) \
  X(16,     32,    32, 2,  2,          3)                  \
  X(32,     64,    64, 1,  2,          6)                  \
  X(64,    128,   128, 2,  1,          2)                  \
  X(128,   256,   256, 1,  1,          3)

namespace {

constexpr int kK = 15;           // conv taps
constexpr int kPad = kK / 2;
constexpr int kMaxStages = 6;    // weight ring slots, as many as shared memory holds
constexpr int kConsumers = 256;  // two consumer warpgroups
constexpr int kThreads = kConsumers + 32;  // + one producer warp
constexpr int kSkew = 8;         // bf16 of padding a staged row (ldmatrix bank spread)

// Where a tile's input rows come from.  SAME: conv row t reads rows t - 7 ..
// t + 7, zero outside [0, T).  VALID: the input is padded already, conv row t
// reads rows t .. t + 14 of T + 14.
enum InPolicy : int {
  kInBf16 = 0,   // bf16 [B, T, CinP], SAME (K4's blocks 1-3)
  kInRaw = 1,    // f32 [B, T, Cin], SAME, z-scored from stats or none (K4's block 0)
  kInF32 = 2,    // f32 [B, T+14, Cin], VALID, Cin % 4 == 0 (P3)
  kInF32CM = 3,  // f32 [B, CinP, T+14] channel-major, VALID (P4)
};
// What a tile writes: pool(relu(conv + bias)) of its rows.
enum OutPolicy : int {
  kOutBf16 = 0,   // bf16 [B, T/2, Cout] (K4)
  kOutSums = 1,   // f32 sums over each tile's pooled rows, [B, row_tiles, Cout] (K4's block 3)
  kOutF32 = 2,    // f32 [B, T/2, Cout] (P3; P4 without transpose_out)
  kOutF32CM = 3,  // f32 [B, Cout, T/2] (P4)
};

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x = lo (lower address)
  return *reinterpret_cast<uint32_t*>(&v);
}

// pool(relu(acc + b)) of the two conv rows of a window (a and p), one channel
__device__ __forceinline__ float pool1(float a, float p, float b) {
  return fmaxf(fmaxf(a + b, 0.f), fmaxf(p + b, 0.f));
}
// the same for two channels, packed in bf16
__device__ __forceinline__ uint32_t pool_pair(float a0, float a1, float p0, float p1, float b0,
                                              float b1) {
  return pack_bf16(pool1(a0, p0, b0), pool1(a1, p1, b1));
}

// d[N/2] += A (64 x 16, registers, this warp's 16 rows) * B (16 x N, shared)
template <int N>
__device__ __forceinline__ void wgmma_rs(float* d, const uint32_t* a, uint64_t desc);

template <>
__device__ __forceinline__ void wgmma_rs<32>(float* d, const uint32_t* a, uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<64>(float* d, const uint32_t* a, uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<128>(float* d, const uint32_t* a, uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<256>(float* d, const uint32_t* a, uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

// -- the conv block ---------------------------------------------------------------
template <int CINP_, int BN, int RM, int MINB, int STEPS_, int IN_, int OUT_ = kOutBf16>
struct Tile {
  static constexpr int CINP = CINP_;
  static constexpr int IN = IN_;                          // InPolicy
  static constexpr int OUT = OUT_;                        // OutPolicy
  static constexpr bool F32_IN = IN != kInBf16;           // f32 rows land raw, then go to bf16
  static constexpr bool LAYER = IN == kInF32 || IN == kInF32CM;  // P3's and P4's VALID input
  static constexpr int OFF = LAYER ? 0 : kPad;            // input rows before conv row 0
  static constexpr int BM = 2 * 64 * RM;                  // conv rows a tile
  static constexpr int ROWS = BM + kK - 1;                // staged input rows
  static constexpr int XS = CINP + kSkew;                 // staged row stride (bf16)
  static constexpr int KSTEPS = kK * CINP / 16;           // k16 steps of the reduction
  static constexpr int STEPS = STEPS_;                    // k16 steps a weight stage
  static constexpr int NSTAGE = KSTEPS / STEPS;
  static constexpr int STEP_BYTES = 16 * BN * 2;          // one k16 step of B
  static constexpr int STAGE_BYTES = STEPS * STEP_BYTES;
  static constexpr int NACC = BN / 2;                     // accumulators a thread, per m64
  static constexpr int NXS = F32_IN ? 1 : 2;              // input tiles (bf16: double-buffered)
  static constexpr size_t XS_BYTES = (size_t)ROWS * XS * 2;
  static constexpr size_t RAW_BYTES = F32_IN ? (size_t)ROWS * CINP * 4 : 0;  // f32 landing rows
  static constexpr size_t REST = NXS * XS_BYTES + RAW_BYTES + (size_t)8 * BN * 4 + 2 * 64 * 8;
  // shared memory a CTA may take with MINB CTAs an SM (228 KB an SM, 1 KB of
  // it reserved a CTA, 227 KB at most a CTA)
  static constexpr size_t BUDGET = MINB == 1 ? 232448 : 233472 / MINB - 1024;
  static constexpr size_t AVAIL = BUDGET > REST ? BUDGET - REST : 0;
  // the whole slice's weights stay in shared memory when they fit (loaded once
  // a CTA); else a ring of up to kMaxStages stages streams them for every tile
  static constexpr bool RESIDENT = (size_t)NSTAGE * STAGE_BYTES <= AVAIL;
  static constexpr int STAGES = RESIDENT ? NSTAGE
                                : AVAIL / STAGE_BYTES < kMaxStages
                                    ? (int)(AVAIL / STAGE_BYTES) : kMaxStages;
  static constexpr size_t RING = (size_t)STAGES * STAGE_BYTES;
  static constexpr size_t SMEM = RING + REST;
  // kOutF32CM: the pooled tile [BN][BM/2] f32 is staged in the bf16 tile's
  // buffer, OUT_PARTS channel parts one after another; a channel row is OS
  // floats (16-byte rows, 4 banks apart: the fragments' stores spread)
  static constexpr int OS = BM / 2 + 4;
  static constexpr int OUT_PARTS = (size_t)BN * OS * 4 <= XS_BYTES       ? 1
                                   : (size_t)BN / 2 * OS * 4 <= XS_BYTES ? 2
                                                                         : 4;
  static constexpr bool FITS = REST <= BUDGET && (RESIDENT || STAGES >= 2) && SMEM <= 232448 &&
                               (OUT != kOutF32CM || (size_t)BN / OUT_PARTS * OS * 4 <= XS_BYTES);
  static_assert(STAGES <= 64, "barriers");
  static_assert(KSTEPS % STEPS == 0, "stages must tile the reduction");
  // K4's blocks must fit; a layer's f32 tile that does not (a row of
  // tools/tune_wgmma.py's variants) is refused at launch
  static_assert(FITS || LAYER, "shared memory: a ring of two stages at least");
};

// Raw f32 rows u0 + r (r < rows) of one record into `raw` (row stride CINP,
// channels < Cin) by cp.async; zeros for rows outside [0, T).
template <int CINP>
__device__ __forceinline__ void issue_raw_rows(const float* x_rec, float* raw, int rows, int u0,
                                               int T, int Cin, int tid) {
  const int c4s = Cin / 4;
  for (int i = tid; i < rows * c4s; i += kConsumers) {
    const int r = i / c4s, c = (i % c4s) * 4;
    const int t = u0 + r;
    const bool in = t >= 0 && t < T;
    cp_async16_zfill(raw + r * CINP + c, x_rec + (size_t)(in ? t : 0) * Cin + c, in);
  }
}

// z-score the raw rows u0 + r (r < rows) into a bf16 tile (row stride XS):
// (x - mean) / (std + eps) per lead from the record's stats (none: as is);
// rows outside [0, T) stay 0 (the normalised signal's padding), channels >=
// Cin are 0.
template <int CINP, int XS>
__device__ __forceinline__ void zscore_rows(const float* raw, __nv_bfloat16* xs, int rows, int u0,
                                            int T, int Cin, const float* stats_rec, int tid) {
  constexpr int C4 = CINP / 4;
  static_assert(kConsumers % C4 == 0, "a thread keeps its channels");
  const int c = (tid % C4) * 4;
  float mean[4] = {0.f, 0.f, 0.f, 0.f}, sd[4] = {1.f, 1.f, 1.f, 1.f};
  if (stats_rec && c < Cin) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      mean[e] = stats_rec[(c + e) * 2];
      sd[e] = stats_rec[(c + e) * 2 + 1];
    }
  }
  for (int i = tid; i < rows * C4; i += kConsumers) {
    const int r = i / C4, t = u0 + r;
    float v[4] = {0.f, 0.f, 0.f, 0.f};
    if (t >= 0 && t < T && c < Cin) {
      const float4 qv = *reinterpret_cast<const float4*>(raw + r * CINP + c);
      v[0] = (qv.x - mean[0]) / sd[0];
      v[1] = (qv.y - mean[1]) / sd[1];
      v[2] = (qv.z - mean[2]) / sd[2];
      v[3] = (qv.w - mean[3]) / sd[3];
    }
    uint2 pk;
    pk.x = pack_bf16(v[0], v[1]);
    pk.y = pack_bf16(v[2], v[3]);
    *reinterpret_cast<uint2*>(xs + r * XS + c) = pk;
  }
}

// Channel-major f32 rows u0 + r (r < ROWS) of one record's CINP channel rows,
// each Tx floats long, into `raw` as [CINP][ROWS] by 4-byte cp.async (a
// channel row starts 16-byte aligned only when 4 | Tx); zeros from Tx on.
template <int CINP, int ROWS>
__device__ __forceinline__ void issue_cm_rows(const float* x_rec, float* raw, int u0, int Tx,
                                              int tid) {
  for (int i = tid; i < CINP * ROWS; i += kConsumers) {
    const int c = i / ROWS, t = u0 + i % ROWS;
    const bool in = t < Tx;
    cp_async4_zfill(raw + i, x_rec + (size_t)c * Tx + (in ? t : 0), in);
  }
}

// The landed channel-major rows [CINP][ROWS] into the bf16 tile (row stride
// XS), transposed 8 channels at a time: one 16-byte store a tile row.
template <int CINP, int ROWS, int XS>
__device__ __forceinline__ void cm_rows_to_tile(const float* raw, __nv_bfloat16* xs, int tid) {
  for (int i = tid; i < CINP / 8 * ROWS; i += kConsumers) {
    const int c = i / ROWS * 8, r = i % ROWS;
    const float* v = raw + c * ROWS + r;
    uint4 pk;
    pk.x = pack_bf16(v[0], v[ROWS]);
    pk.y = pack_bf16(v[2 * ROWS], v[3 * ROWS]);
    pk.z = pack_bf16(v[4 * ROWS], v[5 * ROWS]);
    pk.w = pack_bf16(v[6 * ROWS], v[7 * ROWS]);
    *reinterpret_cast<uint4*>(xs + r * XS + c) = pk;
  }
}

// Copy tile `tile`'s input rows t0 - OFF + r (r < ROWS) into shared memory by
// cp.async, zeros outside [0, T): bf16 rows into the staged tile `xs` (row
// stride XS), or f32 rows into `raw` (channels-last: row stride CINP,
// channels < Cin; channel-major: [CINP][ROWS]).  T is the input's rows.
template <class S>
__device__ __forceinline__ void issue_input(const void* xin, int rec, int t0, int T, int Cin,
                                            __nv_bfloat16* xs, float* raw, int tid) {
  constexpr int CINP = S::CINP;
  if constexpr (S::IN == kInF32CM) {
    issue_cm_rows<CINP, S::ROWS>(static_cast<const float*>(xin) + (size_t)rec * CINP * T, raw,
                                 t0, T, tid);
  } else if constexpr (S::F32_IN) {
    issue_raw_rows<CINP>(static_cast<const float*>(xin) + (size_t)rec * T * Cin, raw, S::ROWS,
                         t0 - S::OFF, T, Cin, tid);
  } else {
    const __nv_bfloat16* x = static_cast<const __nv_bfloat16*>(xin) + (size_t)rec * T * CINP;
    constexpr int C8 = CINP / 8;
    for (int i = tid; i < S::ROWS * C8; i += kConsumers) {
      const int r = i / C8, c = (i % C8) * 8;
      const int t = t0 - kPad + r;
      const bool in = t >= 0 && t < T;
      cp_async16_zfill(xs + r * S::XS + c, x + (size_t)(in ? t : 0) * CINP + c, in);
    }
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// One weight stage of a tile: its A fragments by ldmatrix (row m of k16 step
// (tap, k0) is staged row m + tap, channels k0..k0+15), then, once the
// stage's weights have landed, its products, waited for before the fragments'
// registers are reused and the ring slot is released.  (Keeping one stage's
// products in flight while the next one's fragments load measured slower on
// the H100: the two warpgroups already take turns on the tensor cores.)
template <class S, int BN, int RM>
__device__ __forceinline__ void mma_stage(float (&acc)[RM][S::NACC], const __nv_bfloat16* xs,
                                          int arow, int lcol, const unsigned char* ring,
                                          uint64_t* full, uint64_t* empty, int s, int g) {
  constexpr int CPT = S::KSTEPS / 15;  // k16 steps a tap: CinP / 16
  const int slot = S::RESIDENT ? s : g % S::STAGES;
  uint32_t a[S::STEPS][RM][4];
#pragma unroll
  for (int j = 0; j < S::STEPS; ++j) {
    const int step = s * S::STEPS + j;
    const int tap = step / CPT, k0 = (step % CPT) * 16;
#pragma unroll
    for (int rm = 0; rm < RM; ++rm)
      ldmatrix_x4(a[j][rm], xs + (arow + rm * 64 + tap) * S::XS + k0 + lcol);
  }
  mbar_wait(&full[slot], S::RESIDENT ? 0 : (g / S::STAGES) & 1);
  wg_fence();
  const unsigned char* wb = ring + slot * S::STAGE_BYTES;
#pragma unroll
  for (int j = 0; j < S::STEPS; ++j) {
    const uint64_t desc = b_desc(wb + j * S::STEP_BYTES, 16 * BN, 128);
#pragma unroll
    for (int rm = 0; rm < RM; ++rm) wgmma_rs<BN>(acc[rm], a[j][rm], desc);
  }
  wg_commit();
  wg_wait<0>();
#pragma unroll
  for (int rm = 0; rm < RM; ++rm) {
#pragma unroll
    for (int i = 0; i < S::NACC; ++i) pin(acc[rm][i]);
  }
#pragma unroll
  for (int j = 0; j < S::STEPS; ++j)
#pragma unroll
    for (int rm = 0; rm < RM; ++rm)
#pragma unroll
      for (int e = 0; e < 4; ++e) pin(a[j][rm][e]);
  if (!S::RESIDENT && (threadIdx.x & 127) == 0) mbar_arrive(&empty[slot]);
}

// x (InPolicy IN): [B, T, Cin] f32, block 0's raw record (Cin % 4 == 0, stats
// [B, Cin, 2] = (mean, std+eps) or null), or bf16 (Cin == CINP); P3's f32
// [B, T, Cin] or P4's f32 [B, CINP, T], padded in time (T = conv rows + 14).
// w: [Cout/BN, KSTEPS, 16 x BN] bf16 in core order; bias [Cout] f32.  Output
// (OutPolicy OUT): [B, T/2, Cout] bf16 or f32, [B, Cout, T/2] f32, or the f32
// sums over each tile's pooled rows, [B, row_tiles, Cout].  Persistent: CTA c
// takes tiles c, c + grid, ... (tile = (record, row tile, channel slice)); the
// producer streams each tile's weights through the ring without a break, and
// the consumers fetch the next tile's input while they multiply this one's.
template <int CINP, int BN, int RM, int MINB, int STEPS, int IN, int OUT>
__global__ void __launch_bounds__(kThreads, MINB)
wgmma_conv_block_kernel(const void* __restrict__ xin, const float* __restrict__ stats,
                        const __nv_bfloat16* __restrict__ w, const float* __restrict__ bias,
                        void* __restrict__ yout, int T, int Cin, int Cout, int row_tiles,
                        int n_tiles) {
  using S = Tile<CINP, BN, RM, MINB, STEPS, IN, OUT>;
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* ring = smem;                                                // S::STAGES slots
  __nv_bfloat16* xs0 = reinterpret_cast<__nv_bfloat16*>(smem + S::RING);   // NXS tiles
  float* raw = reinterpret_cast<float*>(smem + S::RING + S::NXS * S::XS_BYTES);
  float* red = reinterpret_cast<float*>(smem + S::RING + S::NXS * S::XS_BYTES + S::RAW_BYTES);
  uint64_t* full = reinterpret_cast<uint64_t*>(red + 8 * BN);
  uint64_t* empty = full + S::STAGES;
  const int nsl = Cout / BN;
  const int tid = threadIdx.x;

  if (tid == 0) {
    for (int s = 0; s < S::STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 2);  // one arrival a consumer warpgroup
    }
    fence_mbarrier_init();
  }
  __syncthreads();

  if (tid >= kConsumers) {  // the producer warp: one thread streams the weights
    if (tid == kConsumers) {
      int g = 0;  // stages issued so far, over all of this CTA's tiles
      // resident weights: one slice for all tiles (Cout == BN), loaded once
      const int last = S::RESIDENT ? blockIdx.x + 1 : n_tiles;
      for (int tile = blockIdx.x; tile < last; tile += gridDim.x) {
        const unsigned char* src = reinterpret_cast<const unsigned char*>(w) +
                                   (size_t)(tile % nsl) * S::KSTEPS * S::STEP_BYTES;
        for (int s = 0; s < S::NSTAGE; ++s, ++g) {
          const int slot = g % S::STAGES;
          if (!S::RESIDENT && g >= S::STAGES) mbar_wait(&empty[slot], ((g / S::STAGES) - 1) & 1);
          mbar_expect_tx(&full[slot], S::STAGE_BYTES);
          bulk_load(ring + slot * S::STAGE_BYTES, src + (size_t)s * S::STAGE_BYTES,
                    S::STAGE_BYTES, &full[slot]);
        }
      }
    }
    return;
  }

  const int wg = tid >> 7;
  const int warp = (tid >> 5) & 3, lane = tid & 31;
  const int lrow = lane & 15, lcol = (lane >> 4) * 8;
  const int mrow0 = wg * 64 * RM + warp * 16;  // this warp's first row of m64 tile 0
  const int g8 = lane >> 2, q = lane & 3;
  const int half = (T - 2 * (kPad - S::OFF)) / 2;  // conv rows / 2: MaxPool(2) floors odd lengths
  int g = 0;               // stages consumed so far
  int buf = 0;

  if (blockIdx.x < n_tiles) {
    const int tile = blockIdx.x, rec = tile / (nsl * row_tiles);
    issue_input<S>(xin, rec, ((tile / nsl) % row_tiles) * S::BM, T, Cin, xs0, raw, tid);
  }
#pragma unroll 1
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int ns = tile % nsl, rt = (tile / nsl) % row_tiles, rec = tile / (nsl * row_tiles);
    const int t0 = rt * S::BM;
    __nv_bfloat16* xs = xs0 + buf * (S::ROWS * S::XS);
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    // this tile's input has landed; every consumer is done with the last tile
    consumer_sync<kConsumers>();
    if constexpr (IN == kInF32CM) {
      cm_rows_to_tile<CINP, S::ROWS, S::XS>(raw, xs, tid);
      consumer_sync<kConsumers>();  // the raw rows are free for the next tile
    } else if constexpr (S::F32_IN) {
      zscore_rows<CINP, S::XS>(raw, xs, S::ROWS, t0 - S::OFF, T, Cin,
                               stats ? stats + (size_t)rec * Cin * 2 : nullptr, tid);
      consumer_sync<kConsumers>();  // the raw rows are free for the next tile
    }
    const int next = tile + gridDim.x;
    if (next < n_tiles) {
      issue_input<S>(xin, next / (nsl * row_tiles), ((next / nsl) % row_tiles) * S::BM, T, Cin,
                     xs0 + (buf ^ 1) * (S::ROWS * S::XS), raw, tid);
    }

    float acc[RM][S::NACC];
#pragma unroll
    for (int rm = 0; rm < RM; ++rm)
#pragma unroll
      for (int i = 0; i < S::NACC; ++i) acc[rm][i] = 0.f;

    const int arow = mrow0 + lrow;
#pragma unroll 1
    for (int s = 0; s < S::NSTAGE; ++s, ++g)
      mma_stage<S, BN, RM>(acc, xs, arow, lcol, ring, full, empty, s, g);

    // epilogue: accumulator i of n8 chunk c is row g8 (i < 2) or g8 + 8,
    // column 8c + 2q + (i & 1); rows g8 and g8 + 1 of a window are lanes 4 apart
    const int n0 = ns * BN;
    if constexpr (OUT == kOutBf16 || OUT == kOutF32) {
      using YT = std::conditional_t<OUT == kOutBf16, __nv_bfloat16, float>;
      YT* y = static_cast<YT*>(yout) + (size_t)rec * half * Cout;
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
            const float b0 = bias[col], b1 = bias[col + 1];
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int prow = (row + 8 * h) / 2;
              if (prow < half) {
                if constexpr (OUT == kOutBf16)
                  *reinterpret_cast<uint32_t*>(y + (size_t)prow * Cout + col) =
                      pool_pair(acc[rm][4 * c + 2 * h], acc[rm][4 * c + 2 * h + 1], p[2 * h],
                                p[2 * h + 1], b0, b1);
                else
                  *reinterpret_cast<float2*>(y + (size_t)prow * Cout + col) =
                      make_float2(pool1(acc[rm][4 * c + 2 * h], p[2 * h], b0),
                                  pool1(acc[rm][4 * c + 2 * h + 1], p[2 * h + 1], b1));
              }
            }
          }
        }
      }
    } else if constexpr (OUT == kOutF32CM) {
      // the pooled tile, channel-major in the bf16 tile's buffer (its last
      // reader was this tile's ldmatrix), one channel part at a time, then
      // written along time
      constexpr int PB = BN / S::OUT_PARTS;  // channels a part
      constexpr int PR = S::BM / 2;          // pooled rows a tile
      float* stage = reinterpret_cast<float*>(xs);
      float* y = static_cast<float*>(yout) + ((size_t)rec * Cout + n0) * half;
#pragma unroll
      for (int part = 0; part < S::OUT_PARTS; ++part) {
        // every consumer is past its products, or done with the last part
        consumer_sync<kConsumers>();
#pragma unroll
        for (int rm = 0; rm < RM; ++rm) {
          const int lr = mrow0 + rm * 64 + g8;  // the tile's conv row; even g8: a window
#pragma unroll
          for (int cc = 0; cc < PB / 8; ++cc) {
            const int c = part * (PB / 8) + cc;
            float p[4];
#pragma unroll
            for (int e = 0; e < 4; ++e)
              p[e] = __shfl_xor_sync(0xffffffffu, acc[rm][4 * c + e], 4);
            if ((g8 & 1) == 0) {
              const int col = 8 * cc + 2 * q;  // within the part
              const float b0 = bias[n0 + 8 * c + 2 * q], b1 = bias[n0 + 8 * c + 2 * q + 1];
#pragma unroll
              for (int h = 0; h < 2; ++h) {
                const int pl = (lr + 8 * h) / 2;
                stage[col * S::OS + pl] = pool1(acc[rm][4 * c + 2 * h], p[2 * h], b0);
                stage[(col + 1) * S::OS + pl] = pool1(acc[rm][4 * c + 2 * h + 1], p[2 * h + 1], b1);
              }
            }
          }
        }
        consumer_sync<kConsumers>();
        for (int i = tid; i < PB * PR; i += kConsumers) {
          const int n = i / PR, prow = t0 / 2 + i % PR;
          if (prow < half) y[(size_t)(part * PB + n) * half + prow] = stage[n * S::OS + i % PR];
        }
      }
    } else {
      // per-channel sums over this tile's pooled rows: a thread over its rows,
      // a warp by shuffles, the 8 warps in order through shared memory
      const int cw = tid >> 5;  // consumer warp 0..7
#pragma unroll
      for (int c = 0; c < BN / 8; ++c) {
        float s0 = 0.f, s1 = 0.f;
        const int col = n0 + 8 * c + 2 * q;
        const float b0 = bias[col], b1 = bias[col + 1];
#pragma unroll
        for (int rm = 0; rm < RM; ++rm) {
          const int row = t0 + mrow0 + rm * 64 + g8;
          float p[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) p[e] = __shfl_xor_sync(0xffffffffu, acc[rm][4 * c + e], 4);
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int prow = (row + 8 * h) / 2;
            if ((g8 & 1) == 0 && prow < half) {
              s0 += fmaxf(fmaxf(acc[rm][4 * c + 2 * h] + b0, 0.f), fmaxf(p[2 * h] + b0, 0.f));
              s1 += fmaxf(fmaxf(acc[rm][4 * c + 2 * h + 1] + b1, 0.f),
                          fmaxf(p[2 * h + 1] + b1, 0.f));
            }
          }
        }
#pragma unroll
        for (int m = 4; m < 32; m <<= 1) {
          s0 += __shfl_xor_sync(0xffffffffu, s0, m);
          s1 += __shfl_xor_sync(0xffffffffu, s1, m);
        }
        if (g8 == 0) {
          red[cw * BN + 8 * c + 2 * q] = s0;
          red[cw * BN + 8 * c + 2 * q + 1] = s1;
        }
      }
      consumer_sync<kConsumers>();
      float* y = static_cast<float*>(yout) + ((size_t)rec * row_tiles + rt) * Cout + n0;
      for (int n = tid; n < BN; n += kConsumers) {
        float sum = 0.f;
#pragma unroll
        for (int k = 0; k < 8; ++k) sum += red[k * BN + n];
        y[n] = sum;
      }
    }
    if constexpr (!S::F32_IN) buf ^= 1;
  }
}

// One launch of the block; T is the input's rows (conv rows + 14 for a layer).
template <int CINP, int BN, int RM, int MINB, int STEPS, int IN, int OUT>
cudaError_t launch_block(const void* x, const float* stats, const void* w, const float* b, void* y,
                         int B, int T, int Cin, int Cout, cudaStream_t st) {
  using S = Tile<CINP, BN, RM, MINB, STEPS, IN, OUT>;
  if constexpr (!S::FITS) {
    return cudaErrorInvalidValue;  // a layer's f32 tile too large for shared memory
  } else {
    if (Cout % BN || (S::RESIDENT && Cout != BN)) return cudaErrorInvalidValue;  // one resident slice
    auto kernel = wgmma_conv_block_kernel<CINP, BN, RM, MINB, STEPS, IN, OUT>;
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)S::SMEM);
    if (err != cudaSuccess) return err;
    int device = 0, sms = 0;
    if ((err = cudaGetDevice(&device)) != cudaSuccess) return err;
    if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) != cudaSuccess)
      return err;
    const int conv = T - 2 * (kPad - S::OFF);
    const int row_tiles = (2 * (conv / 2) + S::BM - 1) / S::BM;
    const long n_tiles = (long)B * row_tiles * (Cout / BN);
    if (n_tiles > 0x7fffffff) return cudaErrorInvalidValue;
    const int grid = (int)(n_tiles < (long)sms * MINB ? n_tiles : (long)sms * MINB);
    kernel<<<grid, kThreads, S::SMEM, st>>>(x, stats, static_cast<const __nv_bfloat16*>(w), b, y,
                                            T, Cin, Cout, row_tiles, (int)n_tiles);
    return cudaGetLastError();
  }
}

template <int CINP, int BN, int RM, int MINB, int STEPS, int IN>
cudaError_t launch_mode(int sums, const void* x, const float* stats, const void* w, const float* b,
                        void* y, int B, int T, int Cin, int Cout, cudaStream_t st) {
  if (sums)
    return launch_block<CINP, BN, RM, MINB, STEPS, IN, kOutSums>(x, stats, w, b, y, B, T, Cin,
                                                                  Cout, st);
  return launch_block<CINP, BN, RM, MINB, STEPS, IN, kOutBf16>(x, stats, w, b, y, B, T, Cin,
                                                                Cout, st);
}

// -- the tail: channel sums -> mean -> proj -> head --------------------------------
// part [B, n_tiles, C] -> logits [B, L]: g = sum_tiles (1/T) * part (tile
// order); z = bf16(g) @ bf16(pw) + pb; logits = bf16(z) @ bf16(hw) + hb
__global__ void sums_tail_kernel(const float* __restrict__ part, const float* __restrict__ pw,
                                 const float* __restrict__ pb, const float* __restrict__ hw,
                                 const float* __restrict__ hb, float* __restrict__ logits,
                                 int n_tiles, int T, int C, int F, int L) {
  extern __shared__ float sm[];
  float* g = sm;      // [C]
  float* z = sm + C;  // [F]
  const float* pr = part + (size_t)blockIdx.x * n_tiles * C;
  const float inv_t = 1.f / (float)T;
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    float s = 0.f;
    for (int k = 0; k < n_tiles; ++k) s = fmaf(inv_t, pr[(size_t)k * C + c], s);
    g[c] = rnd_bf16(s);
  }
  __syncthreads();
  for (int f = threadIdx.x; f < F; f += blockDim.x) {
    float s = 0.f;
    for (int c = 0; c < C; ++c) s = fmaf(g[c], rnd_bf16(pw[(size_t)c * F + f]), s);
    z[f] = rnd_bf16(s + pb[f]);
  }
  __syncthreads();
  for (int l = threadIdx.x; l < L; l += blockDim.x) {
    float s = 0.f;
    for (int f = 0; f < F; ++f) s = fmaf(z[f], rnd_bf16(hw[(size_t)f * L + l]), s);
    logits[(size_t)blockIdx.x * L + l] = s + hb[l];
  }
}

// K3's bf16 tail on the same sums.  part [B, n_tiles, C] -> logits [B, L],
// weights (in, out): g = sum_tiles (1/T) * part (tile order); z_ecg =
// bf16(g) @ bf16(pw) + pb, kept in f32; h1 = relu(bf16(demo) @ bf16(w1) +
// b1); h2 = relu(bf16(h1) @ bf16(w2) + b2); film = bf16(h2) @ bf16(wf) + bf;
// gamma = 1 + tanh(film[:F]); z = gamma * z_ecg + film[F:]; logits = bf16(z)
// @ bf16(hw) + hb.  As JAX's _make_mm_kernel in bf16 (_dot1 rounds both
// operands of each product): z_ecg enters FiLM in f32, only z is rounded.
// ~0.2 MFLOP a record, nothing beside the blocks' 1.133 GFLOP.
__global__ void mm_sums_tail_kernel(const float* __restrict__ part, const float* __restrict__ pw,
                                    const float* __restrict__ pb, const float* __restrict__ w1,
                                    const float* __restrict__ b1, const float* __restrict__ w2,
                                    const float* __restrict__ b2, const float* __restrict__ wf,
                                    const float* __restrict__ bf, const float* __restrict__ hw,
                                    const float* __restrict__ hb, const float* __restrict__ demo,
                                    float* __restrict__ logits, int n_tiles, int T, int C, int F,
                                    int D, int H1, int H, int L) {
  extern __shared__ float sm[];
  float* g = sm;         // [C]  product operand
  float* z = g + C;      // [F]  z_ecg in f32, then z as the head's operand
  float* d = z + F;      // [D]  product operand
  float* h1 = d + D;     // [H1] product operand
  float* h2 = h1 + H1;   // [H]  product operand
  float* film = h2 + H;  // [2F] f32
  const size_t rec = blockIdx.x;
  const float* pr = part + rec * n_tiles * C;
  const float inv_t = 1.f / (float)T;
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    float s = 0.f;
    for (int k = 0; k < n_tiles; ++k) s = fmaf(inv_t, pr[(size_t)k * C + c], s);
    g[c] = rnd_bf16(s);
  }
  for (int k = threadIdx.x; k < D; k += blockDim.x) d[k] = rnd_bf16(demo[rec * D + k]);
  __syncthreads();
  for (int f = threadIdx.x; f < F; f += blockDim.x) {
    float s = 0.f;
    for (int c = 0; c < C; ++c) s = fmaf(g[c], rnd_bf16(pw[(size_t)c * F + f]), s);
    z[f] = s + pb[f];
  }
  for (int j = threadIdx.x; j < H1; j += blockDim.x) {
    float s = 0.f;
    for (int k = 0; k < D; ++k) s = fmaf(d[k], rnd_bf16(w1[(size_t)k * H1 + j]), s);
    h1[j] = rnd_bf16(fmaxf(s + b1[j], 0.f));
  }
  __syncthreads();
  for (int j = threadIdx.x; j < H; j += blockDim.x) {
    float s = 0.f;
    for (int k = 0; k < H1; ++k) s = fmaf(h1[k], rnd_bf16(w2[(size_t)k * H + j]), s);
    h2[j] = rnd_bf16(fmaxf(s + b2[j], 0.f));
  }
  __syncthreads();
  for (int j = threadIdx.x; j < 2 * F; j += blockDim.x) {
    float s = 0.f;
    for (int k = 0; k < H; ++k) s = fmaf(h2[k], rnd_bf16(wf[(size_t)k * 2 * F + j]), s);
    film[j] = s + bf[j];
  }
  __syncthreads();
  for (int f = threadIdx.x; f < F; f += blockDim.x) {
    const float gamma = 1.f + tanhf(film[f]);
    z[f] = rnd_bf16(__fadd_rn(__fmul_rn(gamma, z[f]), film[F + f]));  // not fused, as in JAX
  }
  __syncthreads();
  for (int l = threadIdx.x; l < L; l += blockDim.x) {
    float s = 0.f;
    for (int f = 0; f < F; ++f) s = fmaf(z[f], rnd_bf16(hw[(size_t)f * L + l]), s);
    logits[rec * L + l] = s + hb[l];
  }
}

}  // namespace

extern "C" {

// One conv block on wgmma.  x [B, T, Cin]: f32 when in_f32 (block 0's raw
// record: CinP 16, Cin % 4 == 0, stats [B, Cin, 2] or null), else bf16 with
// Cin == CinP; w from prepare_weights ([Cout/BN, 15*CinP/16, 16*BN] bf16); b
// [Cout] f32; y [B, T/2, Cout] bf16, or with sums [B, row_tiles, Cout] f32
// (row_tiles = ceil(2*(T/2) / BM)).  (CinP, Cout) takes its row of
// PTBXL_WG_TILES; any other shape is refused.
int ptbxl_wgmma_conv_block(int device, const void* x, const void* stats, const void* w,
                           const void* b, void* y, int B, int T, int Cin, int CinP, int Cout,
                           int in_f32, int sums, void* stream) {
  cudaError_t err = ptbxl_ensure_device(device);
  if (err != cudaSuccess) return (int)err;
  if (B <= 0 || T < 2 || Cin <= 0 || Cin > CinP) return (int)cudaErrorInvalidValue;
  if (in_f32 != (CinP == 16) || (in_f32 ? Cin % 4 != 0 : (stats != nullptr || Cin != CinP)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* bs = static_cast<const float*>(b);
  const float* ss = static_cast<const float*>(stats);
#define PTBXL_WG_DISPATCH(CINP, COUT, BN, RM, MINB, STEPS)                                 \
  if (CinP == CINP && Cout == COUT)                                                        \
    return (int)launch_mode<CINP, BN, RM, MINB, STEPS, CINP == 16 ? kInRaw : kInBf16>(     \
        sums, x, ss, w, bs, y, B, T, Cin, Cout, st);
  PTBXL_WG_TILES(PTBXL_WG_DISPATCH)
#undef PTBXL_WG_DISPATCH
  return (int)cudaErrorInvalidValue;
}

// One conv layer on wgmma (P3, P4): the input padded in time, Tx = T + 14
// rows, conv row t reading rows t .. t + 14 (VALID).  x f32: [B, Tx, Cin]
// with Cin % 4 == 0 and 16-byte aligned (channel_major 0; P3), or [B, CinP,
// Tx] with Cin == CinP (channel_major 1; P4).  w from wg_weight ([Cout/BN,
// 15*CinP/16, 16*BN] bf16); b [Cout] f32; y f32 [B, T/2, Cout], or with
// transpose_out (channel-major input only) [B, Cout, T/2].  (CinP, Cout)
// takes its row of PTBXL_WG_TILES; any other shape is refused.
int ptbxl_wgmma_conv_layer(int device, const void* x, const void* w, const void* b, void* y, int B,
                           int Tx, int Cin, int CinP, int Cout, int channel_major,
                           int transpose_out, void* stream) {
  cudaError_t err = ptbxl_ensure_device(device);
  if (err != cudaSuccess) return (int)err;
  if (B <= 0 || Tx < kK + 1 || Cin <= 0 || Cin > CinP) return (int)cudaErrorInvalidValue;
  if (channel_major ? Cin != CinP
                    : Cin % 4 != 0 || reinterpret_cast<uintptr_t>(x) % 16 != 0 || transpose_out)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* bs = static_cast<const float*>(b);
#define PTBXL_WG_DISPATCH(CINP, COUT, BN, RM, MINB, STEPS)                                   \
  if (CinP == CINP && Cout == COUT) {                                                        \
    if (!channel_major)                                                                      \
      return (int)launch_block<CINP, BN, RM, MINB, STEPS, kInF32, kOutF32>(                  \
          x, nullptr, w, bs, y, B, Tx, Cin, Cout, st);                                       \
    if (!transpose_out)                                                                      \
      return (int)launch_block<CINP, BN, RM, MINB, STEPS, kInF32CM, kOutF32>(                \
          x, nullptr, w, bs, y, B, Tx, Cin, Cout, st);                                       \
    return (int)launch_block<CINP, BN, RM, MINB, STEPS, kInF32CM, kOutF32CM>(                \
        x, nullptr, w, bs, y, B, Tx, Cin, Cout, st);                                         \
  }
  PTBXL_WG_TILES(PTBXL_WG_DISPATCH)
#undef PTBXL_WG_DISPATCH
  return (int)cudaErrorInvalidValue;
}

// The tail on the last block's channel sums.  part [B, n_tiles, C] f32; T the
// pooled length the mean divides by; pw [C, F]; hw [F, L]; logits [B, L] f32.
int ptbxl_sums_tail(int device, const void* part, const void* pw, const void* pb, const void* hw,
                    const void* hb, void* logits, int B, int n_tiles, int T, int C, int F, int L,
                    void* stream) {
  cudaError_t err = ptbxl_ensure_device(device);
  if (err != cudaSuccess) return (int)err;
  if (B <= 0 || n_tiles <= 0 || T <= 0 || C <= 0 || F <= 0 || L <= 0)
    return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)(C + F) * sizeof(float);
  sums_tail_kernel<<<B, 256, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(part), static_cast<const float*>(pw),
      static_cast<const float*>(pb), static_cast<const float*>(hw),
      static_cast<const float*>(hb), static_cast<float*>(logits), n_tiles, T, C, F, L);
  return (int)cudaGetLastError();
}

// K3's bf16 tail on the last block's channel sums.  part [B, n_tiles, C] f32;
// T the pooled length; pw [C, F]; fc1_w [D, H1]; fc2_w [H1, H]; film_w [H,
// 2F]; hw [F, L]; demo [B, D]; logits [B, L] f32.
int ptbxl_mm_sums_tail(int device, const void* part, const void* pw, const void* pb,
                       const void* fc1_w, const void* fc1_b, const void* fc2_w, const void* fc2_b,
                       const void* film_w, const void* film_b, const void* hw, const void* hb,
                       const void* demo, void* logits, int B, int n_tiles, int T, int C, int F,
                       int D, int H1, int H, int L, void* stream) {
  cudaError_t err = ptbxl_ensure_device(device);
  if (err != cudaSuccess) return (int)err;
  if (B <= 0 || n_tiles <= 0 || T <= 0 || C <= 0 || F <= 0 || D <= 0 || H1 <= 0 || H <= 0 ||
      L <= 0)
    return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)(C + 3 * F + D + H1 + H) * sizeof(float);
  if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;  // no attribute asked for
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  mm_sums_tail_kernel<<<B, 256, smem, static_cast<cudaStream_t>(stream)>>>(
      f(part), f(pw), f(pb), f(fc1_w), f(fc1_b), f(fc2_w), f(fc2_b), f(film_w), f(film_b), f(hw),
      f(hb), f(demo), static_cast<float*>(logits), n_tiles, T, C, F, D, H1, H, L);
  return (int)cudaGetLastError();
}

}  // extern "C"
