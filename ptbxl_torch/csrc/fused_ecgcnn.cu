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
// TFLOP/s take 3.52 ms at B=512.  The bytes (the input read once, the logits
// written; ~1.3 GB of intermediates at B=512, ~0.4 ms) are below either.
//
// The TPU kernel keeps a whole record (~2 MB) on chip; an H100 block has at
// most 227 KB of shared memory and one f32 [5000, 12] input alone is 240 KB.
// So the forward is a short sequence of launches on the caller's stream, with
// intermediates in device memory:
//   ptbxl_conv_block_tf32x3 (once per block): an implicit GEMM in the
//     shape of K4's (hybrid_ecgcnn.cu).  A block owns BM conv rows x BN
//     output channels of one record.  It stages its f32 input rows with
//     their 14-row halo once in shared memory, zero outside [0, T) and
//     for padded channels, so SAME padding pads the *normalized* signal;
//     block 0 applies the z-score while staging.  Row m of the GEMM's A
//     at reduction column k*CinP + c is tile row m + k at channel c, so
//     each 8-wide reduction slice is a plain tile of shifted rows and no
//     im2col is written.  The weights are split once on the host
//     (fused_ecgcnn.py prepare_weights) into [2, Cout, 15*CinP] (big,
//     small; channels zero-padded to CinP, a multiple of 8) and stream
//     through a ring of cp.async stages (64 reduction columns in a ring
//     of two; 32 in a ring of three for Cout = 32).  Both operands reach
//     registers by ldmatrix: an 8 x 4 tile of f32 is an 8 x 8 tile of
//     b16, and the fragment ldmatrix gives of it is mma.m16n8k8's tf32 A
//     (row-major input) and B (the [Cout, K] weights) fragment, so no
//     transpose is needed.  The input is split in registers after each
//     load; each product is three mma.sync m16n8k8 tf32 -> f32, the
//     small terms first, into accumulators that restart at every stage
//     and are added to the running sums in f32 (the tensor cores' own
//     sums truncate; see the kernel).  Two neighbouring conv rows of an
//     accumulator tile sit in lanes 4 apart, so bias, ReLU and the floor
//     pool are a shuffle in the epilogue and only [T/2, Cout] is
//     written.  Tiles (conv rows x channels, warps): 128 x 128 (8 warps
//     of 32 x 64) for Cout % 128 == 0, 256 x 64 (8 of 64 x 32) for
//     Cout % 64 == 0, 256 x 32 (8 of 32 x 32) otherwise.  At the widest block
//     (CinP = 128) 128 x 128 takes 142 x 132 x 4 B of input and 2 x 2 x
//     128 x 68 x 4 B of weights, 209 KB of the 227 KB a block may have;
//     256 x 128 would not fit.  Shared memory thus allows one such block
//     an SM (8 warps), and the mma.sync issue rate, not the bytes,
//     bounds the block.  A launch whose grid would give fewer than two
//     blocks an SM takes 64 x 64 tiles (4 warps), and below that 32 x 32
//     (2 warps), so a B=1 chunk still fills the card (block 3: 160
//     blocks).
//   ptbxl_tail: one block per record: mean over T, proj, head.
// K3 runs the same backbone launches (the folded backbone is the same
// function with weights in the same layout) and ends in ptbxl_mm_tail: one
// block per record, ~4.6 KB of shared memory at full width: mean over T,
// proj, demographics MLP (fc1, fc2 with ReLU), FiLM (gamma = 1 + tanh,
// z = gamma * z_ecg + beta) and head.  Its ~0.21 MFLOP a record are nothing
// beside the backbone's 1.133 GFLOP, so K3's bound is K2's.
// The same f32 conv block serves K4's f32 deep blocks (hybrid_ecgcnn.py).
//
// With bf16 compute every operand is rounded with __float2bfloat16_rn before
// the multiply and sums stay f32 (JAX's preferred_element_type=f32); the conv
// blocks then run ptbxl_conv_block_bf16, an FMA kernel: 256 threads own TR
// conv rows x CO channels, stage the input tile and the weights 8 channels at
// a time and keep a 4 x 4 register tile of sums a thread.  It also serves,
// through ptbxl_conv_block_valid on a pre-padded input, the "direct" mode of
// the P3 layer probe (tools/probe_layer_perf.py make_pallas_layer, :52).  In
// K3 z_ecg enters the FiLM in f32 and only z_cond is rounded, as the head's
// operand (_dot1, :252).
// Later work: wgmma with TF32 operands fed by TMA (mma.sync does not reach the
// tensor cores' full rate), and fusing blocks so intermediates stay on chip.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kK = 15;          // conv taps
constexpr int kPad = kK / 2;    // SAME padding
constexpr int kSmemMax = 232448;  // shared memory a block may ask for

template <bool kBf16>
__device__ __forceinline__ float rnd(float v) {
  if (kBf16) return __bfloat162float(__float2bfloat16_rn(v));
  return v;
}

// -- the f32 conv block: 3xTF32 on the tensor cores --------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// four 8 x 4 f32 tiles, read as 8 x 8 b16 tiles: lanes 8i..8i+7 give the row
// addresses of tile i, and lane l gets row l/4, column l%4 of tile i in r[i]
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const float* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(dst)), "l"(src));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

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

// d += a (16x8, row) * b (8x8, col): tf32 operands, f32 sums
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// weight stage j (reduction columns [j*KC, j*KC + KC) of output channels
// [n0, n0 + BN), big rows then small rows) into ring slot j % kStages; rows
// KC + 4 floats apart (16-B rows, an odd count of 16-B units: ldmatrix without
// bank conflicts)
template <int BN, int kKC, int kStages, int kThreads>
__device__ __forceinline__ void load_w_stage(float* ws, const float* __restrict__ w3, int j,
                                             int ktot, long plane, int n0) {
  constexpr int kWS = kKC + 4;
  constexpr int kG = kKC / 4;  // 16-B chunks a row
  float* dst = ws + (j % kStages) * (2 * BN * kWS);
  const int r0 = j * kKC;
  for (int i = threadIdx.x; i < 2 * BN * kG; i += kThreads) {
    const int row = i / kG, r = r0 + (i % kG) * 4;  // row = part * BN + n
    if (r < ktot)  // the last stage may be short; its missing columns are never read
      cp_async16(dst + row * kWS + (r - r0),
                 w3 + (row / BN) * plane + (long)(n0 + row % BN) * ktot + r);
  }
}

// x [B, T, Cin] f32; conv row t in [0, 2*(T/2)) reads rows t + k - 7, zero
// outside [0, T); stats [B, Cin, 2] (mean, std+eps) when kZscore; w3 [2, Cout,
// 15*CinP] f32, TF32 big and small parts at column k*CinP + c, zero for
// c >= Cin; bias [Cout]; y [B, T/2, Cout] = pool(relu(conv + bias)).  The
// weights stream kKC reduction columns a stage through a ring of kStages.
template <int kWarpsM, int kWarpsN, int kMT, int kNT, int kKC, int kStages, bool kZscore>
__global__ void __launch_bounds__(kWarpsM * kWarpsN * 32)
tf32x3_conv_block_kernel(const float* __restrict__ x, const float* __restrict__ stats,
                         const float* __restrict__ w3, const float* __restrict__ bias,
                         float* __restrict__ y, int T, int Cin, int CinP, int Cout,
                         int row_tiles) {
  constexpr int kThreads = kWarpsM * kWarpsN * 32;
  constexpr int kBM = kWarpsM * kMT * 16;
  constexpr int kBN = kWarpsN * kNT * 8;
  constexpr int kRows = kBM + kK - 1;
  constexpr int kWS = kKC + 4;
  static_assert(kNT % 2 == 0, "one ldmatrix_x4 loads the B fragments of two n-tiles");
  static_assert(kKC % 8 == 0 && kStages >= 2, "whole k-steps, a ring of at least two");
  extern __shared__ __align__(16) float smem[];
  const int xs_stride = CinP + 4;        // 16-B rows, an odd count of 16-B units
  float* xs = smem;                      // [kRows][xs_stride]
  float* ws = smem + kRows * xs_stride;  // kStages x 2 x [kBN][kWS]

  const int rec = blockIdx.x / row_tiles;
  const int t0 = (blockIdx.x % row_tiles) * kBM;
  const int n0 = blockIdx.y * kBN;
  const int ktot = kK * CinP;
  const int n_stages = (ktot + kKC - 1) / kKC;
  const long plane = (long)Cout * ktot;

  // the first stages' weights fly while the input is staged
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n_stages) load_w_stage<kBN, kKC, kStages, kThreads>(ws, w3, s, ktot, plane, n0);
    cp_async_commit();
  }

  // input tile: rows t0 - 7 .. t0 - 7 + kRows - 1, zero outside [0, T) and
  // for channels >= Cin
  const float* xr = x + (long)rec * T * Cin;
  for (int i = threadIdx.x; i < kRows * CinP; i += kThreads) {
    const int r = i / CinP, c = i % CinP;
    const int t = t0 - kPad + r;
    float v = 0.f;
    if (t >= 0 && t < T && c < Cin) {
      v = xr[(long)t * Cin + c];
      if (kZscore) {
        const float* st = stats + ((long)rec * Cin + c) * 2;
        v = (v - st[0]) / st[1];
      }
    }
    xs[r * xs_stride + c] = v;
  }

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm0 = (warp % kWarpsM) * (kMT * 16);
  const int wn0 = (warp / kWarpsM) * (kNT * 8);
  // ldmatrix rows: A's four tiles are rows 0-7 | 8-15 by columns 0-3 | 4-7
  // (a0..a3); B's are n 0-7 by k 0-3 | 4-7, then n 8-15 likewise (b0, b1 of
  // two n-tiles)
  const int a_row = lane & 15, a_col = (lane >> 4) * 4;
  const int b_row = (lane & 7) + ((lane >> 4) << 3), b_col = ((lane >> 3) & 1) * 4;

  // each stage sums into part, which starts from zero, and part is added to
  // acc in f32: the tensor cores' own sums do not round to nearest, so their
  // error compounds when one accumulator is chained over the whole reduction
  // (up to 720 mma); restarted each stage, the block stays within
  // chip_smoke.py's per-block gate (2^-18 of the block's |x| conv |w|)
  float acc[kMT][kNT][4], part[kMT][kNT][4];
#pragma unroll
  for (int i = 0; i < kMT; ++i)
#pragma unroll
    for (int j = 0; j < kNT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

#pragma unroll 1
  for (int j = 0; j < n_stages; ++j) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // stage j and the input tile are in; slot (j - 1) % kStages is free
    if (j + kStages - 1 < n_stages)
      load_w_stage<kBN, kKC, kStages, kThreads>(ws, w3, j + kStages - 1, ktot, plane, n0);
    cp_async_commit();
    const float* wbig = ws + (j % kStages) * (2 * kBN * kWS);
    const float* wsmall = wbig + kBN * kWS;
#pragma unroll
    for (int i = 0; i < kMT; ++i)
#pragma unroll
      for (int n = 0; n < kNT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) part[i][n][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < kKC / 8; ++ks) {
      const int r = j * kKC + ks * 8;
      if (r >= ktot) break;
      const int tap = r / CinP, c0 = r - tap * CinP;  // an 8-wide slice never straddles taps
      uint32_t bb[kNT][2], bs[kNT][2];
#pragma unroll
      for (int np = 0; np < kNT / 2; ++np) {
        const int off = (wn0 + np * 16 + b_row) * kWS + ks * 8 + b_col;
        uint32_t f[4];
        ldmatrix_x4(f, wbig + off);
        bb[2 * np][0] = f[0], bb[2 * np][1] = f[1];
        bb[2 * np + 1][0] = f[2], bb[2 * np + 1][1] = f[3];
        ldmatrix_x4(f, wsmall + off);
        bs[2 * np][0] = f[0], bs[2 * np][1] = f[1];
        bs[2 * np + 1][0] = f[2], bs[2 * np + 1][1] = f[3];
      }
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt) {
        uint32_t a[4], ab[4], as[4];
        ldmatrix_x4(a, xs + (wm0 + mt * 16 + a_row + tap) * xs_stride + c0 + a_col);
#pragma unroll
        for (int e = 0; e < 4; ++e) split_tf32(a[e], ab[e], as[e]);
#pragma unroll
        for (int nt = 0; nt < kNT; ++nt) {
          mma_tf32(part[mt][nt], as, bb[nt]);
          mma_tf32(part[mt][nt], ab, bs[nt]);
          mma_tf32(part[mt][nt], ab, bb[nt]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < kMT; ++i)
#pragma unroll
      for (int n = 0; n < kNT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][n][e] += part[i][n][e];
  }

  // epilogue: rows g and g + 1 of a 16-row tile are lanes 4 apart
  const int g = lane >> 2, q = lane & 3;
  const int half = T / 2;  // MaxPool(2) floors odd lengths
  float* yr = y + (long)rec * half * Cout;
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt) {
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt) {
      float p[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) p[e] = __shfl_xor_sync(0xffffffffu, acc[mt][nt][e], 4);
      if ((g & 1) == 0) {
        const int col = n0 + wn0 + nt * 8 + q * 2;
        const float b0 = bias[col], b1 = bias[col + 1];
        const int row = t0 + wm0 + mt * 16 + g;  // even: a pool window starts here
#pragma unroll
        for (int h = 0; h < 2; ++h) {  // rows g (c0, c1) and g + 8 (c2, c3)
          const int prow = (row + 8 * h) / 2;
          if (prow < half) {
            float2 o;
            o.x = fmaxf(fmaxf(acc[mt][nt][2 * h] + b0, 0.f), fmaxf(p[2 * h] + b0, 0.f));
            o.y = fmaxf(fmaxf(acc[mt][nt][2 * h + 1] + b1, 0.f), fmaxf(p[2 * h + 1] + b1, 0.f));
            *reinterpret_cast<float2*>(yr + (long)prow * Cout + col) = o;
          }
        }
      }
    }
  }
}

// -- the bf16 conv block: FMA, operands rounded to bf16 ----------------------------

constexpr int kCI = 8;            // input channels staged per step
constexpr int kStride = kCI + 1;  // padded row stride of the input tile (bank spread)
constexpr int kThreads = 256;
constexpr int kRowsPerThread = 4;  // conv rows, i.e. two pool windows
constexpr int kColsPerThread = 4;

// x [B, Tx, Cin] f32; conv row t in [0, T) reads rows t + k - off (zero
// outside [0, Tx)): off = 7, Tx = T is SAME padding, off = 0, Tx = T + 14 a
// pre-padded input; stats [B, Cin, 2] (mean, std+eps) or unused;
// w [K, Cin, Cout] BN-folded; bias [Cout]; y [B, T/2, Cout].
template <int kCO, bool kZscore>
__global__ void __launch_bounds__(kThreads)
conv_block_bf16_kernel(const float* __restrict__ x, const float* __restrict__ stats,
                       const float* __restrict__ w, const float* __restrict__ bias,
                       float* __restrict__ y, int Tx, int T, int off, int Cin, int Cout,
                       int row_tiles) {
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
      const int t = t0 - off + row, c = c0 + ci;
      float v = 0.f;
      if (t >= 0 && t < Tx && c < Cin) {
        v = xr[(long)t * Cin + c];
        if (kZscore) {
          const float* st = stats + ((long)rec * Cin + c) * 2;
          v = (v - st[0]) / st[1];
        }
      }
      in_s[row * kStride + ci] = rnd<true>(v);
    }
    for (int idx = threadIdx.x; idx < kK * kCI * kCO; idx += kThreads) {
      const int k = idx / (kCI * kCO), rem = idx % (kCI * kCO);
      const int ci = rem / kCO, co = rem % kCO;
      const int c = c0 + ci;
      w_s[idx] = c < Cin ? rnd<true>(w[((long)k * Cin + c) * Cout + co0 + co]) : 0.f;
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
template <bool kBf16>
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
    g[c] = rnd<kBf16>(s);
  }
  __syncthreads();
  for (int f = threadIdx.x; f < F; f += blockDim.x) {
    float s = 0.f;
    for (int c = 0; c < C; ++c) s = fmaf(g[c], rnd<kBf16>(pw[(long)c * F + f]), s);
    z[f] = rnd<kBf16>(s + pb[f]);
  }
  __syncthreads();
  for (int l = threadIdx.x; l < L; l += blockDim.x) {
    float s = 0.f;
    for (int f = 0; f < F; ++f) s = fmaf(z[f], rnd<kBf16>(hw[(long)f * L + l]), s);
    logits[(long)blockIdx.x * L + l] = s + hb[l];
  }
}

// K3's tail.  h [B, T, C] -> logits [B, L], all weights (in, out):
// g = mean_t h; z_ecg = g @ pw + pb; h1 = relu(demo @ w1 + b1);
// h2 = relu(h1 @ w2 + b2); film = h2 @ wf + bf; gamma = 1 + tanh(film[:F]);
// z = gamma * z_ecg + film[F:]; logits = z @ hw + hb.
template <bool kBf16>
__global__ void mm_tail_kernel(const float* __restrict__ h, const float* __restrict__ pw,
                               const float* __restrict__ pb, const float* __restrict__ w1,
                               const float* __restrict__ b1, const float* __restrict__ w2,
                               const float* __restrict__ b2, const float* __restrict__ wf,
                               const float* __restrict__ bf, const float* __restrict__ hw,
                               const float* __restrict__ hb, const float* __restrict__ demo,
                               float* __restrict__ logits, int T, int C, int F, int D, int H1,
                               int H, int L) {
  extern __shared__ float sm[];
  float* g = sm;           // [C]  product operand
  float* z = g + C;        // [F]  z_ecg in f32, then z_cond as the head's operand
  float* d = z + F;        // [D]  product operand
  float* h1 = d + D;       // [H1] product operand
  float* h2 = h1 + H1;     // [H]  product operand
  float* film = h2 + H;    // [2F] f32
  const long rec = blockIdx.x;
  const float* hr = h + rec * T * C;
  const float inv_t = 1.f / (float)T;
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    float s = 0.f;
    for (int t = 0; t < T; ++t) s = fmaf(inv_t, hr[(long)t * C + c], s);  // ones/T matmul
    g[c] = rnd<kBf16>(s);
  }
  for (int k = threadIdx.x; k < D; k += blockDim.x) d[k] = rnd<kBf16>(demo[rec * D + k]);
  __syncthreads();
  for (int f = threadIdx.x; f < F; f += blockDim.x) {
    float s = 0.f;
    for (int c = 0; c < C; ++c) s = fmaf(g[c], rnd<kBf16>(pw[(long)c * F + f]), s);
    z[f] = s + pb[f];
  }
  for (int j = threadIdx.x; j < H1; j += blockDim.x) {
    float s = 0.f;
    for (int k = 0; k < D; ++k) s = fmaf(d[k], rnd<kBf16>(w1[(long)k * H1 + j]), s);
    h1[j] = rnd<kBf16>(fmaxf(s + b1[j], 0.f));
  }
  __syncthreads();
  for (int j = threadIdx.x; j < H; j += blockDim.x) {
    float s = 0.f;
    for (int k = 0; k < H1; ++k) s = fmaf(h1[k], rnd<kBf16>(w2[(long)k * H + j]), s);
    h2[j] = rnd<kBf16>(fmaxf(s + b2[j], 0.f));
  }
  __syncthreads();
  for (int j = threadIdx.x; j < 2 * F; j += blockDim.x) {
    float s = 0.f;
    for (int k = 0; k < H; ++k) s = fmaf(h2[k], rnd<kBf16>(wf[(long)k * 2 * F + j]), s);
    film[j] = s + bf[j];
  }
  __syncthreads();
  for (int f = threadIdx.x; f < F; f += blockDim.x) {
    const float gamma = 1.f + tanhf(film[f]);
    z[f] = rnd<kBf16>(__fadd_rn(__fmul_rn(gamma, z[f]), film[F + f]));  // not fused, as in JAX
  }
  __syncthreads();
  for (int l = threadIdx.x; l < L; l += blockDim.x) {
    float s = 0.f;
    for (int f = 0; f < F; ++f) s = fmaf(z[f], rnd<kBf16>(hw[(long)f * L + l]), s);
    logits[rec * L + l] = s + hb[l];
  }
}

// a tile shape of the 3xTF32 conv block: kWarpsM x kWarpsN warps, each of
// kMT x kNT mma tiles (16 x 8), and its weight stages (kKC columns, kStages)
template <int kWarpsM, int kWarpsN, int kMT, int kNT, int kKC, int kStages>
struct Tile {
  static constexpr int kThreads = kWarpsM * kWarpsN * 32;
  static constexpr int kBM = kWarpsM * kMT * 16;
  static constexpr int kBN = kWarpsN * kNT * 8;
  static size_t smem(int CinP) {
    return ((size_t)(kBM + kK - 1) * (CinP + 4) + (size_t)kStages * 2 * kBN * (kKC + 4)) *
           sizeof(float);
  }
  static int row_tiles(int T) { return (2 * (T / 2) + kBM - 1) / kBM; }
  static bool fits(int Cout, int CinP) { return Cout % kBN == 0 && smem(CinP) <= kSmemMax; }
  static long blocks(int B, int T, int Cout) { return (long)B * row_tiles(T) * (Cout / kBN); }

  static cudaError_t launch(const float* x, const float* stats, const float* w3, const float* b,
                            float* y, int B, int T, int Cin, int CinP, int Cout,
                            cudaStream_t st) {
    const size_t bytes = smem(CinP);
    if (!fits(Cout, CinP)) return cudaErrorInvalidValue;
    auto kern = stats
        ? &tf32x3_conv_block_kernel<kWarpsM, kWarpsN, kMT, kNT, kKC, kStages, true>
        : &tf32x3_conv_block_kernel<kWarpsM, kWarpsN, kMT, kNT, kKC, kStages, false>;
    if (bytes > 48 * 1024) {
      cudaError_t err =
          cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
      if (err != cudaSuccess) return err;
    }
    const int rt = row_tiles(T);
    dim3 grid(B * rt, Cout / kBN);
    kern<<<grid, kThreads, bytes, st>>>(x, stats, w3, b, y, T, Cin, CinP, Cout, rt);
    return cudaGetLastError();
  }
};

// The large tiles are the widest that fit one 8-warp block an SM at each
// block's CinP (see the note at the top); the medium and small ones keep a
// small batch's grid full.  chip_smoke.py's k2_blocks phase gates and times
// each block with the tile this launcher picks at B = 1, 16 and 512.
using TileWide = Tile<4, 2, 2, 8, 64, 2>;    // 128 x 128, 8 warps of 32 x 64
using TileMid = Tile<4, 2, 4, 4, 64, 2>;     // 256 x 64, 8 warps of 64 x 32
using TileNarrow = Tile<8, 1, 2, 4, 32, 3>;  // 256 x 32, 8 warps of 32 x 32
using TileMedium = Tile<2, 2, 2, 4, 64, 2>;  // 64 x 64, 4 warps of 32 x 32
using TileSmall = Tile<2, 1, 1, 4, 64, 2>;   // 32 x 32, 2 warps of 16 x 32

// the largest tile whose grid gives every SM at least two blocks (the small
// one when none does)
int conv_block_tf32x3(int device, const void* x, const void* stats, const void* w3, const void* b,
                      void* y, int B, int T, int Cin, int CinP, int Cout, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (B <= 0 || T < 2 || Cin <= 0 || CinP < Cin || CinP % 8 || Cout <= 0 || Cout % 32)
    return (int)cudaErrorInvalidValue;
  int sms = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* xs = static_cast<const float*>(x);
  const float* ss = static_cast<const float*>(stats);
  const float* ws = static_cast<const float*>(w3);
  const float* bs = static_cast<const float*>(b);
  float* ys = static_cast<float*>(y);
  const long enough = 2L * sms;
  if (TileWide::fits(Cout, CinP)) {
    if (TileWide::blocks(B, T, Cout) >= enough)
      return (int)TileWide::launch(xs, ss, ws, bs, ys, B, T, Cin, CinP, Cout, st);
  } else if (TileMid::fits(Cout, CinP)) {
    if (TileMid::blocks(B, T, Cout) >= enough)
      return (int)TileMid::launch(xs, ss, ws, bs, ys, B, T, Cin, CinP, Cout, st);
  } else if (TileNarrow::fits(Cout, CinP)) {
    if (TileNarrow::blocks(B, T, Cout) >= enough)
      return (int)TileNarrow::launch(xs, ss, ws, bs, ys, B, T, Cin, CinP, Cout, st);
  }
  if (TileMedium::fits(Cout, CinP) && TileMedium::blocks(B, T, Cout) >= enough)
    return (int)TileMedium::launch(xs, ss, ws, bs, ys, B, T, Cin, CinP, Cout, st);
  return (int)TileSmall::launch(xs, ss, ws, bs, ys, B, T, Cin, CinP, Cout, st);
}

template <int kCO, bool kZscore>
void launch_conv_bf16(const float* x, const float* stats, const float* w, const float* b,
                      float* y, int B, int Tx, int T, int off, int Cin, int Cout,
                      cudaStream_t st) {
  constexpr int kTR = (kThreads / (kCO / kColsPerThread)) * kRowsPerThread;
  const int conv_rows = 2 * (T / 2);
  const int row_tiles = (conv_rows + kTR - 1) / kTR;
  dim3 grid(B * row_tiles, Cout / kCO);
  conv_block_bf16_kernel<kCO, kZscore><<<grid, kThreads, 0, st>>>(x, stats, w, b, y, Tx, T, off,
                                                                 Cin, Cout, row_tiles);
}

template <int kCO>
void dispatch_conv_bf16(const float* x, const float* stats, const float* w, const float* b,
                        float* y, int B, int Tx, int T, int off, int Cin, int Cout,
                        cudaStream_t st) {
  if (stats) launch_conv_bf16<kCO, true>(x, stats, w, b, y, B, Tx, T, off, Cin, Cout, st);
  else launch_conv_bf16<kCO, false>(x, stats, w, b, y, B, Tx, T, off, Cin, Cout, st);
}

int conv_block_bf16(int device, const void* x, const void* stats, const void* w, const void* b,
                    void* y, int B, int Tx, int T, int off, int Cin, int Cout, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (B <= 0 || T < 2 || Cin <= 0 || Cout <= 0 || Cout % 32) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* xs = static_cast<const float*>(x);
  const float* ss = static_cast<const float*>(stats);
  const float* ws = static_cast<const float*>(w);
  const float* bs = static_cast<const float*>(b);
  float* ys = static_cast<float*>(y);
  if (Cout % 64 == 0) dispatch_conv_bf16<64>(xs, ss, ws, bs, ys, B, Tx, T, off, Cin, Cout, st);
  else dispatch_conv_bf16<32>(xs, ss, ws, bs, ys, B, Tx, T, off, Cin, Cout, st);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// One f32 conv block on the tensor cores (3xTF32), SAME padding.  x [B, T,
// Cin] f32; stats [B, Cin, 2] or null (no z-score on load); w3 [2, Cout,
// 15*CinP] from prepare_weights; b [Cout]; y [B, T/2, Cout].  CinP % 8 == 0,
// CinP >= Cin, Cout % 32 == 0, T >= 2; the tile follows the grid.
int ptbxl_conv_block_tf32x3(int device, const void* x, const void* stats, const void* w3,
                            const void* b, void* y, int B, int T, int Cin, int CinP, int Cout,
                            void* stream) {
  return conv_block_tf32x3(device, x, stats, w3, b, y, B, T, Cin, CinP, Cout, stream);
}

// One conv block with bf16 operands and f32 sums, SAME padding.  stats may be
// null (no z-score on load); w [15, Cin, Cout] f32.  Cout % 32 == 0, T >= 2.
int ptbxl_conv_block_bf16(int device, const void* x, const void* stats, const void* w,
                          const void* b, void* y, int B, int T, int Cin, int Cout,
                          void* stream) {
  return conv_block_bf16(device, x, stats, w, b, y, B, T, T, kPad, Cin, Cout, stream);
}

// One bf16 conv block on a pre-padded input x [B, Tx, Cin]: conv length T =
// Tx - 14 (VALID), no z-score; y [B, T/2, Cout] (the P3 probe's "direct" layer).
int ptbxl_conv_block_valid(int device, const void* x, const void* w, const void* b, void* y,
                           int B, int Tx, int Cin, int Cout, void* stream) {
  return conv_block_bf16(device, x, nullptr, w, b, y, B, Tx, Tx - (kK - 1), 0, Cin, Cout, stream);
}

// Mean over T + proj + head.  h [B, T, C]; pw [C, F]; hw [F, L]; logits [B, L].
int ptbxl_tail(int device, const void* h, const void* pw, const void* pb, const void* hw,
               const void* hb, void* logits, int B, int T, int C, int F, int L, int bf16,
               void* stream) {
  cudaError_t err = cudaSetDevice(device);
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
  if (bf16) tail_kernel<true><<<B, 256, smem, st>>>(hs, pws, pbs, hws, hbs, out, T, C, F, L);
  else tail_kernel<false><<<B, 256, smem, st>>>(hs, pws, pbs, hws, hbs, out, T, C, F, L);
  return (int)cudaGetLastError();
}

// K3's tail: mean over T + proj + demographics MLP + FiLM + head.
// h [B, T, C]; pw [C, F]; fc1_w [D, H1]; fc2_w [H1, H]; film_w [H, 2F];
// hw [F, L]; demo [B, D]; logits [B, L].
int ptbxl_mm_tail(int device, const void* h, const void* pw, const void* pb, const void* fc1_w,
                  const void* fc1_b, const void* fc2_w, const void* fc2_b, const void* film_w,
                  const void* film_b, const void* hw, const void* hb, const void* demo,
                  void* logits, int B, int T, int C, int F, int D, int H1, int H, int L, int bf16,
                  void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (B <= 0 || T <= 0 || C <= 0 || F <= 0 || D <= 0 || H1 <= 0 || H <= 0 || L <= 0)
    return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)(C + 3 * F + D + H1 + H) * sizeof(float);
  if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;  // no attribute asked for
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  float* out = static_cast<float*>(logits);
  if (bf16)
    mm_tail_kernel<true><<<B, 256, smem, st>>>(f(h), f(pw), f(pb), f(fc1_w), f(fc1_b), f(fc2_w),
                                               f(fc2_b), f(film_w), f(film_b), f(hw), f(hb),
                                               f(demo), out, T, C, F, D, H1, H, L);
  else
    mm_tail_kernel<false><<<B, 256, smem, st>>>(f(h), f(pw), f(pb), f(fc1_w), f(fc1_b), f(fc2_w),
                                                f(fc2_b), f(film_w), f(film_b), f(hw), f(hb),
                                                f(demo), out, T, C, F, D, H1, H, L);
  return (int)cudaGetLastError();
}

const char* ptbxl_strerror(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
