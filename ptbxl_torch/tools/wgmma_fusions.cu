// K4's two fusions, measured beside the route's one launch a block by
// ptbxl_torch/tools/tune_wgmma.py; the route takes neither (on the H100 the
// first is slower, the second leaves K4's forward no faster; PERF.md).  Built
// by that tool alone, from this file and the kernel source it includes.
//
// The JAX kernel (ptbxl_tpu/ops/pallas/hybrid_ecgcnn.py:63) keeps a record's
// blocks in VMEM.  An H100 CTA cannot hold a record (227 KB of shared
// memory), so a fused tile recomputes the rows of the first block that the
// second block's tile needs, halo included, and keeps them in shared memory
// in bf16 (the value the next conv reads): blocks 0 and 1 (wgmma_front), and
// blocks 2 and 3 with block 3's per-tile channel sums (wgmma_deep), which the
// sums tail reads as it reads the route's block 3.  Both compute what the two
// launches compute; what they save is one activation's write and read in
// device memory, and what they pay is the first block's halo rows computed
// twice and one CTA an SM.

#include "../csrc/hybrid_wgmma.cu"

namespace {

// -- blocks 0 and 1 in one launch -------------------------------------------------
// A tile is 128 conv rows of block 1 (t0 .. t0 + 127 of one record).  They read
// block 1's input rows t0 - 7 .. t0 + 134, block 0's pooled rows, which come
// from block 0's conv rows 2(t0 - 7) .. 2(t0 - 7) + 283: five m64 tiles of
// block 0 (320 rows; the 28 halo rows each side are computed by both
// neighbouring tiles), three on warpgroup 0 and two on warpgroup 1, from the
// raw rows 2(t0 - 7) - 7 .. (334 rows).  Block 0's pooled rows go to shared
// memory in bf16 (zero outside [0, T/2): block 1's SAME padding); block 1
// reads them there; only block 1's pooled rows reach device memory.  Both
// blocks' weights (15 + 60 KB) stay in shared memory for the CTA's life.
namespace front {
constexpr int kC0 = 32, kC1 = 64, kBM1 = 128;
constexpr int kRows1 = kBM1 + kK - 1;  // block 1's input rows
constexpr int kM0 = 320;               // block 0's conv rows computed
constexpr int kRows0 = kM0 + kK - 1;   // raw rows
using S0 = Tile<16, kC0, 3, 1, 3, true>;   // block 0: row stride 24, 15 k16 steps, 3 a stage
using S1 = Tile<32, kC1, 1, 1, 6, false>;  // block 1: row stride 40, 30 k16 steps, 6 a stage
constexpr size_t kW0 = (size_t)S0::KSTEPS * S0::STEP_BYTES;
constexpr size_t kW1 = (size_t)S1::KSTEPS * S1::STEP_BYTES;
constexpr size_t kRaw = (size_t)kRows0 * 16 * 4;
constexpr size_t kXs0 = (size_t)kRows0 * S0::XS * 2;
constexpr size_t kXs1 = (size_t)kRows1 * S1::XS * 2;
constexpr size_t kSmem = kW0 + kW1 + kRaw + kXs0 + kXs1 + (S0::NSTAGE + S1::NSTAGE) * 8;
static_assert(S0::RESIDENT && S1::RESIDENT && kSmem <= 232448, "front tile");
}  // namespace front

// Block 0 on this warpgroup's RM m64 tiles (local conv rows m_base ..), its
// pooled rows into xs1 (row pl = m / 2 is block 1's input row p0 + pl).
template <int RM>
__device__ __forceinline__ void front_block0(const __nv_bfloat16* xs0, const unsigned char* w0,
                                             uint64_t* full0, const float* __restrict__ b0,
                                             __nv_bfloat16* xs1, int m_base, int p0, int T1) {
  using S = front::S0;
  const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int mrow0 = m_base + warp * 16;
  float acc[RM][S::NACC];
#pragma unroll
  for (int rm = 0; rm < RM; ++rm)
#pragma unroll
    for (int i = 0; i < S::NACC; ++i) acc[rm][i] = 0.f;
#pragma unroll 1
  for (int s = 0; s < S::NSTAGE; ++s)
    mma_stage<S, front::kC0, RM>(acc, xs0, mrow0 + (lane & 15), (lane >> 4) * 8, w0, full0,
                                 nullptr, s, s);
  const int g8 = lane >> 2, q = lane & 3;
#pragma unroll
  for (int rm = 0; rm < RM; ++rm) {
    const int row = mrow0 + rm * 64 + g8;
#pragma unroll
    for (int c = 0; c < front::kC0 / 8; ++c) {
      float p[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) p[e] = __shfl_xor_sync(0xffffffffu, acc[rm][4 * c + e], 4);
      if ((g8 & 1) == 0) {
        const int col = 8 * c + 2 * q;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int pl = (row + 8 * h) / 2;
          if (pl < front::kRows1) {
            const int prow = p0 + pl;
            const uint32_t v = prow >= 0 && prow < T1
                ? pool_pair(acc[rm][4 * c + 2 * h], acc[rm][4 * c + 2 * h + 1], p[2 * h],
                            p[2 * h + 1], b0[col], b0[col + 1])
                : 0u;
            *reinterpret_cast<uint32_t*>(xs1 + pl * front::S1::XS + col) = v;
          }
        }
      }
    }
  }
}

// x [B, T, Cin] raw f32 (Cin % 4 == 0, Cin <= 16), stats [B, Cin, 2] or null;
// w0, w1 from prepare_weights (16 -> 32, 32 -> 64); y [B, (T/2)/2, 64] bf16.
template <int MINB>
__global__ void __launch_bounds__(kThreads, MINB)
wgmma_front_kernel(const float* __restrict__ x, const float* __restrict__ stats,
                   const __nv_bfloat16* __restrict__ w0, const float* __restrict__ b0,
                   const __nv_bfloat16* __restrict__ w1, const float* __restrict__ b1,
                   __nv_bfloat16* __restrict__ y, int T, int Cin, int row_tiles, int n_tiles) {
  using namespace front;
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* w0s = smem;
  unsigned char* w1s = w0s + kW0;
  float* raw = reinterpret_cast<float*>(w1s + kW1);
  __nv_bfloat16* xs0 = reinterpret_cast<__nv_bfloat16*>(w1s + kW1 + kRaw);
  __nv_bfloat16* xs1 = reinterpret_cast<__nv_bfloat16*>(w1s + kW1 + kRaw + kXs0);
  uint64_t* full0 = reinterpret_cast<uint64_t*>(w1s + kW1 + kRaw + kXs0 + kXs1);
  uint64_t* full1 = full0 + S0::NSTAGE;
  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < S0::NSTAGE + S1::NSTAGE; ++s) mbar_init(&full0[s], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid >= kConsumers) {  // the producer: both blocks' weights, once
    if (tid == kConsumers) {
      for (int s = 0; s < S0::NSTAGE; ++s) {
        mbar_expect_tx(&full0[s], S0::STAGE_BYTES);
        bulk_load(w0s + s * S0::STAGE_BYTES, reinterpret_cast<const unsigned char*>(w0) +
                  s * S0::STAGE_BYTES, S0::STAGE_BYTES, &full0[s]);
      }
      for (int s = 0; s < S1::NSTAGE; ++s) {
        mbar_expect_tx(&full1[s], S1::STAGE_BYTES);
        bulk_load(w1s + s * S1::STAGE_BYTES, reinterpret_cast<const unsigned char*>(w1) +
                  s * S1::STAGE_BYTES, S1::STAGE_BYTES, &full1[s]);
      }
    }
    return;
  }

  const int wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
  const int g8 = lane >> 2, q = lane & 3;
  const int T1 = T / 2, half1 = T1 / 2;
  if (blockIdx.x < n_tiles) {
    const int rec = blockIdx.x / row_tiles, t0 = (blockIdx.x % row_tiles) * kBM1;
    issue_raw_rows<16>(x + (size_t)rec * T * Cin, raw, kRows0, 2 * (t0 - kPad) - kPad, T, Cin,
                       tid);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  }
#pragma unroll 1
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int rec = tile / row_tiles, t0 = (tile % row_tiles) * kBM1;
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    consumer_sync();  // the raw rows have landed; every consumer is done with the last tile
    zscore_rows<16, S0::XS>(raw, xs0, kRows0, 2 * (t0 - kPad) - kPad, T, Cin,
                            stats ? stats + (size_t)rec * Cin * 2 : nullptr, tid);
    consumer_sync();
    const int next = tile + gridDim.x;
    if (next < n_tiles) {
      const int nrec = next / row_tiles, nt0 = (next % row_tiles) * kBM1;
      issue_raw_rows<16>(x + (size_t)nrec * T * Cin, raw, kRows0, 2 * (nt0 - kPad) - kPad, T,
                         Cin, tid);
      asm volatile("cp.async.commit_group;\n" ::: "memory");
    }
    if (wg == 0)
      front_block0<3>(xs0, w0s, full0, b0, xs1, 0, t0 - kPad, T1);
    else
      front_block0<2>(xs0, w0s, full0, b0, xs1, 192, t0 - kPad, T1);
    consumer_sync();  // block 1's input tile is complete

    float acc[1][S1::NACC];
#pragma unroll
    for (int i = 0; i < S1::NACC; ++i) acc[0][i] = 0.f;
    const int mrow0 = wg * 64 + warp * 16;
#pragma unroll 1
    for (int s = 0; s < S1::NSTAGE; ++s)
      mma_stage<S1, kC1, 1>(acc, xs1, mrow0 + (lane & 15), (lane >> 4) * 8, w1s, full1, nullptr,
                            s, s);
    __nv_bfloat16* yr = y + (size_t)rec * half1 * kC1;
    const int row = t0 + mrow0 + g8;
#pragma unroll
    for (int c = 0; c < kC1 / 8; ++c) {
      float p[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) p[e] = __shfl_xor_sync(0xffffffffu, acc[0][4 * c + e], 4);
      if ((g8 & 1) == 0) {
        const int col = 8 * c + 2 * q;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int prow = (row + 8 * h) / 2;
          if (prow < half1)
            *reinterpret_cast<uint32_t*>(yr + (size_t)prow * kC1 + col) =
                pool_pair(acc[0][4 * c + 2 * h], acc[0][4 * c + 2 * h + 1], p[2 * h],
                          p[2 * h + 1], b1[col], b1[col + 1]);
        }
      }
    }
  }
}

// -- blocks 2 and 3 in one launch ------------------------------------------------
// A tile is 128 conv rows of block 3 (t0 .. t0 + 127 of one record), the
// route's block-3 tile, so its sums are the route's block 3's.  They read block 3's
// input rows t0 - 7 .. t0 + 134, block 2's pooled rows, which come from block
// 2's conv rows 2(t0 - 7) .. + 283: five m64 tiles (320 rows), three on
// warpgroup 0 and two on warpgroup 1, from block 2's input rows 2(t0 - 7) - 7
// .. (334 rows, bf16, zero outside [0, T2)).  Block 2 runs in two passes of
// 64 output channels (the accumulators of three m64 tiles at N = 128 would
// not fit), each streaming its half of block 2's weights (copied out of the
// 128-channel layout the standalone block reads); then block 3 (N = 256, one
// m64 tile a warpgroup) streams all of its weights.  (Giving each
// warpgroup five tile-passes, three in one pass and two in the other,
// measured slower on the H100.)  One ring of
// 24 KB slots carries both blocks' stages; the next tile's block-2 rows are
// fetched while block 3 runs.
namespace deep {
constexpr int kBM3 = 128;
// the fused launch reads block 2's weights as the table lays them out (BN 128)
// and writes block 3's sums in the table's tiles (BM 128)
#define PTBXL_WG_FITS(CINP, COUT, BN, RM, MINB, STEPS) \
  && (CINP != 64 || BN == 128) && (CINP != 128 || 128 * RM == kBM3)
constexpr bool kTableFits = true PTBXL_WG_TILES(PTBXL_WG_FITS);
#undef PTBXL_WG_FITS
constexpr int kRows3 = kBM3 + kK - 1;  // 142 block-3 input rows
constexpr int kM2 = 320;               // block 2's conv rows computed (284 needed)
constexpr int kRows2 = kM2 + kK - 1;   // 334 block-2 input rows
constexpr int kSlot = 24576;           // a ring slot: three k16 steps of block 3
constexpr int kStages = 5;
template <int CINP, int BN, int STEPS_>
struct Phase {  // what mma_stage reads of a tile, for a ring of kStages kSlot slots
  static constexpr int XS = CINP + kSkew;
  static constexpr int KSTEPS = kK * CINP / 16;
  static constexpr int STEPS = STEPS_;
  static constexpr int NSTAGE = KSTEPS / STEPS;
  static constexpr int STEP_BYTES = 16 * BN * 2;
  static constexpr int STAGE_BYTES = kSlot;  // the slot stride
  static constexpr int LOAD_BYTES = STEPS * STEP_BYTES;
  static constexpr int NACC = BN / 2;
  static constexpr bool RESIDENT = false;
  static constexpr int STAGES = kStages;
  static_assert(KSTEPS % STEPS == 0 && LOAD_BYTES <= kSlot, "stages");
};
using P2 = Phase<64, 64, 3>;    // block 2, a 64-channel pass: 60 k16 steps, 20 stages
using P3 = Phase<128, 256, 3>;  // block 3: 120 k16 steps, 40 stages
constexpr size_t kRing = (size_t)kStages * kSlot;
constexpr size_t kXs2 = (size_t)kRows2 * P2::XS * 2;
constexpr size_t kXs3 = (size_t)kRows3 * P3::XS * 2;
constexpr size_t kRed = (size_t)8 * 256 * 4;
constexpr size_t kSmem = kRing + kXs2 + kXs3 + kRed + 2 * kStages * 8;
static_assert(kSmem <= 232448, "deep tile");
}  // namespace deep

// One pass of block 2 (output channels 64*pass ..) on this warpgroup's RM m64
// tiles (local conv rows m_base ..); pooled rows into xs3 (row pl is block
// 3's input row p0 + pl, zero outside [0, half2)).
template <int RM>
__device__ __forceinline__ void deep_block2(const __nv_bfloat16* xs2, const unsigned char* ring,
                                            uint64_t* full, uint64_t* empty, int& g,
                                            const float* __restrict__ b2, __nv_bfloat16* xs3,
                                            int pass, int m_base, int p0, int half2) {
  using S = deep::P2;
  const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int mrow0 = m_base + warp * 16;
  const int g8 = lane >> 2, q = lane & 3;
  {
    float acc[RM][S::NACC];
#pragma unroll
    for (int rm = 0; rm < RM; ++rm)
#pragma unroll
      for (int i = 0; i < S::NACC; ++i) acc[rm][i] = 0.f;
#pragma unroll 1
    for (int s = 0; s < S::NSTAGE; ++s, ++g)
      mma_stage<S, 64, RM>(acc, xs2, mrow0 + (lane & 15), (lane >> 4) * 8, ring, full, empty, s,
                           g);
#pragma unroll
    for (int rm = 0; rm < RM; ++rm) {
      const int row = mrow0 + rm * 64 + g8;
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        float p[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) p[e] = __shfl_xor_sync(0xffffffffu, acc[rm][4 * c + e], 4);
        if ((g8 & 1) == 0) {
          const int col = pass * 64 + 8 * c + 2 * q;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int pl = (row + 8 * h) / 2;
            if (pl < deep::kRows3) {
              const int prow = p0 + pl;
              const uint32_t v = prow >= 0 && prow < half2
                  ? pool_pair(acc[rm][4 * c + 2 * h], acc[rm][4 * c + 2 * h + 1], p[2 * h],
                              p[2 * h + 1], b2[col], b2[col + 1])
                  : 0u;
              *reinterpret_cast<uint32_t*>(xs3 + pl * deep::P3::XS + col) = v;
            }
          }
        }
      }
    }
  }
}

// Block 2's input rows u0 + r (r < kRows2) of one record into xs2 by cp.async.
__device__ __forceinline__ void issue_block2_rows(const __nv_bfloat16* x2_rec, __nv_bfloat16* xs2,
                                                  int u0, int T2, int tid) {
  for (int i = tid; i < deep::kRows2 * 8; i += kConsumers) {
    const int r = i / 8, c = (i % 8) * 8;
    const int t = u0 + r;
    const bool in = t >= 0 && t < T2;
    cp_async16_zfill(xs2 + r * deep::P2::XS + c, x2_rec + (size_t)(in ? t : 0) * 64 + c, in);
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// x2 [B, T2, 64] bf16 (block 1's output); w2 [1, 60, 16*128], w3 [1, 120,
// 16*256] bf16 (wg_weight); b2 [128], b3 [256] f32; y [B, row_tiles, 256]
// f32: block 3's per-tile sums.
__global__ void __launch_bounds__(kThreads, 1)
wgmma_deep_kernel(const __nv_bfloat16* __restrict__ x2, const __nv_bfloat16* __restrict__ w2,
                  const float* __restrict__ b2, const __nv_bfloat16* __restrict__ w3,
                  const float* __restrict__ b3, float* __restrict__ y, int T2, int row_tiles,
                  int n_tiles) {
  using namespace deep;
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* ring = smem;
  __nv_bfloat16* xs2 = reinterpret_cast<__nv_bfloat16*>(smem + kRing);
  __nv_bfloat16* xs3 = reinterpret_cast<__nv_bfloat16*>(smem + kRing + kXs2);
  float* red = reinterpret_cast<float*>(smem + kRing + kXs2 + kXs3);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kRing + kXs2 + kXs3 + kRed);
  uint64_t* empty = full + kStages;
  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 2);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid >= kConsumers) {  // the producer: each tile's stages, block 2's two passes then block 3
    if (tid == kConsumers) {
      int g = 0;
      auto issue = [&](const unsigned char* src, int bytes) {
        const int slot = g % kStages;
        if (g >= kStages) mbar_wait(&empty[slot], ((g / kStages) - 1) & 1);
        mbar_expect_tx(&full[slot], bytes);
        bulk_load(ring + (size_t)slot * kSlot, src, bytes, &full[slot]);
        ++g;
      };
      // stage s of pass p: its k16 steps' output channels 64p .. 64p + 63, from
      // block 2's 128-channel layout (each step two K halves of 16 column groups
      // of 128 bytes) into the 64-channel layout the pass reads (1 KB halves)
      auto issue_half = [&](const unsigned char* w, int pass, int s) {
        const int slot = g % kStages;
        if (g >= kStages) mbar_wait(&empty[slot], ((g / kStages) - 1) & 1);
        mbar_expect_tx(&full[slot], P2::LOAD_BYTES);
        for (int j = 0; j < P2::STEPS; ++j)
          for (int kh = 0; kh < 2; ++kh)
            bulk_load(ring + (size_t)slot * kSlot + j * P2::STEP_BYTES + kh * 1024,
                      w + (size_t)(s * P2::STEPS + j) * 4096 + kh * 2048 + pass * 1024, 1024,
                      &full[slot]);
        ++g;
      };
      const unsigned char* w2b = reinterpret_cast<const unsigned char*>(w2);
      const unsigned char* w3b = reinterpret_cast<const unsigned char*>(w3);
      for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
        for (int pass = 0; pass < 2; ++pass)
          for (int s = 0; s < P2::NSTAGE; ++s) issue_half(w2b, pass, s);
        for (int s = 0; s < P3::NSTAGE; ++s)
          issue(w3b + (size_t)s * P3::LOAD_BYTES, P3::LOAD_BYTES);
      }
    }
    return;
  }

  const int wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
  const int g8 = lane >> 2, q = lane & 3;
  const int half2 = T2 / 2, half3 = half2 / 2;
  int g = 0;
  if (blockIdx.x < n_tiles) {
    const int rec = blockIdx.x / row_tiles, t0 = (blockIdx.x % row_tiles) * kBM3;
    issue_block2_rows(x2 + (size_t)rec * T2 * 64, xs2, 2 * (t0 - kPad) - kPad, T2, tid);
  }
#pragma unroll 1
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int rec = tile / row_tiles, rt = tile % row_tiles, t0 = rt * kBM3;
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    consumer_sync();  // block 2's rows have landed; every consumer is done with the last tile
#pragma unroll 1
    for (int pass = 0; pass < 2; ++pass) {
      if (wg == 0)
        deep_block2<3>(xs2, ring, full, empty, g, b2, xs3, pass, 0, t0 - kPad, half2);
      else
        deep_block2<2>(xs2, ring, full, empty, g, b2, xs3, pass, 192, t0 - kPad, half2);
    }
    consumer_sync();  // block 3's input tile is complete; block 2's rows are free
    const int next = tile + gridDim.x;
    if (next < n_tiles) {
      const int nrec = next / row_tiles, nt0 = (next % row_tiles) * kBM3;
      issue_block2_rows(x2 + (size_t)nrec * T2 * 64, xs2, 2 * (nt0 - kPad) - kPad, T2, tid);
    }

    float acc[1][P3::NACC];
#pragma unroll
    for (int i = 0; i < P3::NACC; ++i) acc[0][i] = 0.f;
    const int mrow0 = wg * 64 + warp * 16;
#pragma unroll 1
    for (int s = 0; s < P3::NSTAGE; ++s, ++g)
      mma_stage<P3, 256, 1>(acc, xs3, mrow0 + (lane & 15), (lane >> 4) * 8, ring, full, empty, s,
                            g);
    // per-channel sums over this tile's pooled rows, as the route's block 3
    const int cw = tid >> 5;
    const int row = t0 + mrow0 + g8;
#pragma unroll
    for (int c = 0; c < 32; ++c) {
      float s0 = 0.f, s1 = 0.f;
      const int col = 8 * c + 2 * q;
      const float c0 = b3[col], c1 = b3[col + 1];
      float p[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) p[e] = __shfl_xor_sync(0xffffffffu, acc[0][4 * c + e], 4);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int prow = (row + 8 * h) / 2;
        if ((g8 & 1) == 0 && prow < half3) {
          s0 += fmaxf(fmaxf(acc[0][4 * c + 2 * h] + c0, 0.f), fmaxf(p[2 * h] + c0, 0.f));
          s1 += fmaxf(fmaxf(acc[0][4 * c + 2 * h + 1] + c1, 0.f), fmaxf(p[2 * h + 1] + c1, 0.f));
        }
      }
#pragma unroll
      for (int m = 4; m < 32; m <<= 1) {
        s0 += __shfl_xor_sync(0xffffffffu, s0, m);
        s1 += __shfl_xor_sync(0xffffffffu, s1, m);
      }
      if (g8 == 0) {
        red[cw * 256 + col] = s0;
        red[cw * 256 + col + 1] = s1;
      }
    }
    consumer_sync();
    float* yt = y + ((size_t)rec * row_tiles + rt) * 256;
    for (int n = tid; n < 256; n += kConsumers) {
      float sum = 0.f;
#pragma unroll
      for (int k = 0; k < 8; ++k) sum += red[k * 256 + n];
      yt[n] = sum;
    }
  }
}

}  // namespace

extern "C" {

// Blocks 0 and 1 in one launch.  x [B, T, Cin] raw f32 (Cin % 4 == 0, Cin <=
// 16), stats [B, Cin, 2] or null; w0 [1, 15, 16*32], w1 [1, 30, 16*64] bf16
// from prepare_weights; b0 [32], b1 [64] f32; y [B, (T/2)/2, 64] bf16.
int ptbxl_wgmma_front(int device, const void* x, const void* stats, const void* w0, const void* b0,
                      const void* w1, const void* b1, void* y, int B, int T, int Cin,
                      void* stream) {
  cudaError_t err = ensure_device(device);
  if (err != cudaSuccess) return (int)err;
  if (B <= 0 || T < 4 || Cin <= 0 || Cin > 16 || Cin % 4) return (int)cudaErrorInvalidValue;
  auto kernel = wgmma_front_kernel<1>;
  if ((err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)front::kSmem)) != cudaSuccess)
    return (int)err;
  int dev = 0, sms = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return (int)err;
  const int row_tiles = (2 * ((T / 2) / 2) + front::kBM1 - 1) / front::kBM1;
  const long n_tiles = (long)B * row_tiles;
  if (n_tiles > 0x7fffffff) return (int)cudaErrorInvalidValue;
  const int grid = (int)(n_tiles < sms ? n_tiles : sms);
  kernel<<<grid, kThreads, front::kSmem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(stats),
      static_cast<const __nv_bfloat16*>(w0), static_cast<const float*>(b0),
      static_cast<const __nv_bfloat16*>(w1), static_cast<const float*>(b1),
      static_cast<__nv_bfloat16*>(y), T, Cin, row_tiles, (int)n_tiles);
  return (int)cudaGetLastError();
}

// Blocks 2 and 3 in one launch.  x2 [B, T2, 64] bf16; w2 [1, 60, 16*128], w3
// [1, 120, 16*256] bf16 (prepare_weights); b2 [128], b3 [256] f32; y [B,
// row_tiles, 256] f32, row_tiles = ceil(2 * ((T2/2)/2) / 128): block 3's
// per-tile channel sums, as the standalone block 3 writes them.
int ptbxl_wgmma_deep(int device, const void* x2, const void* w2, const void* b2, const void* w3,
                     const void* b3, void* y, int B, int T2, void* stream) {
  cudaError_t err = ensure_device(device);
  if (err != cudaSuccess) return (int)err;
  if (B <= 0 || T2 < 4 || !deep::kTableFits) return (int)cudaErrorInvalidValue;
  if ((err = cudaFuncSetAttribute(wgmma_deep_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)deep::kSmem)) != cudaSuccess)
    return (int)err;
  int dev = 0, sms = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return (int)err;
  const int row_tiles = (2 * ((T2 / 2) / 2) + deep::kBM3 - 1) / deep::kBM3;
  const long n_tiles = (long)B * row_tiles;
  if (n_tiles > 0x7fffffff) return (int)cudaErrorInvalidValue;
  const int grid = (int)(n_tiles < sms ? n_tiles : sms);
  wgmma_deep_kernel<<<grid, kThreads, deep::kSmem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x2), static_cast<const __nv_bfloat16*>(w2),
      static_cast<const float*>(b2), static_cast<const __nv_bfloat16*>(w3),
      static_cast<const float*>(b3), static_cast<float*>(y), T2, row_tiles, (int)n_tiles);
  return (int)cudaGetLastError();
}

}  // extern "C"
