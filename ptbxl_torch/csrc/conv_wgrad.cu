// The weight gradient of the train step's f32 conv (stride 1, SAME, k=15),
// hand-written for Hopper:
//
//   dW[co, ci, tap] = sum_{b,t} dy[b, co, t] * x[b, ci, t + tap - 7]
//
// with x zero outside [0, T); x [B, Cin, T] and dy [B, Cout, T] f32, the
// layouts autograd saves and hands back; dW [Cout, Cin, 15] f32.
//
// It replaces no TPU kernel: the JAX package leaves this product to XLA
// (ptbxl_tpu/ops/fast_wgrad.py, a plain lax.dot_general).  It was added
// because cuDNN's deterministic weight gradient (wgrad_alg1_engine), which the
// port's train step is pinned to for repeatable training, took a third of the
// f32 B=64 step on the H100 at 22% of FP32 FMA's rate.
//
// Bound on the H100: operations.  2 Cin Cout 15 T a record: 57.6 + 153.6 +
// 307.2 + 614.4 MFLOP for the ECGCNN's four blocks at T=5000, 72.5 GFLOP a
// B=64 step: 1.08 ms at FP32 FMA's 67 TFLOP/s, 0.44 ms as 3xTF32 on the
// tensor cores (three TF32 products a product at 495 TFLOP/s).  The bytes
// (x and dy read once, 41 MB of dy a block at B=64) are below either.
//
// Arithmetic: f32 as K2's conv block computes it (fused_ecgcnn.cu).  Each
// operand is split as a = big + small (big = tf32(a), small = tf32(a - big)),
// a product taken as small*big + big*small + big*big in the tensor cores' f32
// sums, which restart at every stage (at most 64 reduction columns) and are
// added to running f32 sums: a reduction here is up to 320,000 terms, and the
// tensor cores' own sums truncate.
//
// Design: a GEMM whose reduction runs over (b, t), written so that both of its
// operands stay K-major along t, as they lie in memory.
//   * The 15 taps are split as tap = 12 - 4j + r (j, r in 0..3; tap 15 is
//     computed and dropped).  Rows m = (ci, r) of the A operand read
//     x[ci, t' + r - 7], an arbitrary shift, so A comes from registers
//     (wgmma's register A), four scalar shared loads a k8 step a thread from
//     the staged x rows, split in registers, as K2 forms its shifted A.
//   * Columns n = (j, co) of the B operand read dy[co, t' - 12 + 4j]: shifts
//     by whole 16-byte groups of four t.  dy is staged in shared memory as
//     [t/4][co][t%4] (big and small planes): wgmma's K-major core matrices
//     without swizzle (8 channels x 4 t, 128 bytes; 512 bytes to the next 4 t
//     for a slice of 32 channels), so the 4 x 32 columns (j, co) of one k8
//     step are one uniform run whose groups of 8 lie 128 bytes apart: one
//     m64 n128 k8 wgmma covers all four shifts.  Blocks 0 and 1 (Cout 32, 64)
//     get n128 products too.
//   * A CTA is one warpgroup (128 threads, two CTAs an SM): an m64 x n128
//     tile (16 input channels x 4 r, 32 output channels x 4 j) over a slice
//     of the reduction.  Each K-tile of 64 t' of one record lands raw by
//     cp.async (x rows with their halo, dy rows), double-buffered, one tile
//     ahead; the dy tile is split into its two planes in shared memory
//     (fence.proxy.async: the planes are read by wgmma), then each stage's A
//     fragments are loaded and split and its products issued and waited for.
//   * Deterministic: the reduction of B * ceil((T + 12) / 64) K-tiles is cut
//     into slices fixed by the shape alone (conv_wgrad.py's plan: about 264
//     CTAs, one wave on the H100, whatever card runs it); each CTA writes its
//     tile's sums to its own
//     place in a workspace, and a second kernel adds the slices in a fixed
//     order (eight interleaved partial sums, then those in order) into dW.
//     No float atomics; no allocation or host synchronisation (a CUDA graph
//     captures both launches).
#include "hopper.cuh"

namespace {

// f32 bits -> TF32 as cvt.rna.tf32.f32 rounds (to nearest, ties away from
// zero), with the 13 low bits zero: fused_ecgcnn.cu's split, bit for bit
// (ops/kernels/probes.py tf32_round)
__device__ __forceinline__ uint32_t tf32_rna(uint32_t bits) {
  return (bits + 0x1000u) & 0xffffe000u;
}

// a = big + small to 2^-22 |a|; a - big is exact in f32
__device__ __forceinline__ void split_tf32(uint32_t a, uint32_t& big, uint32_t& small) {
  big = tf32_rna(a);
  small = tf32_rna(__float_as_uint(__uint_as_float(a) - __uint_as_float(big)));
}

constexpr int kK = 15;       // conv taps
constexpr int kBK = 64;       // reduction columns (t') a K-tile
constexpr int kMRows = 64;    // A rows a CTA: 16 input channels x 4 r
constexpr int kCiTile = kMRows / 4;
constexpr int kCoTile = 32;   // output channels a CTA (x 4 j = 128 B columns)
constexpr int kNCols = 4 * kCoTile;
constexpr int kTileSums = kMRows * kNCols;  // a CTA's sums in the workspace
constexpr int kThreads = 128;
constexpr int kSteps = 8;                   // k8 steps a stage: the tensor cores' sums restart
constexpr int kHalo = 12;                   // dy columns before t'0 (j = 0: t' - 12)
constexpr int kNch = kBK / 4 + 3;           // 4-t groups of dy a K-tile
constexpr int kXW = kBK + 4;                // x columns staged: t'0 - 8 .. t'0 + 60
constexpr int kXS = kBK + 8;                // x row stride (floats): 8 mod 32 banks apart
constexpr int kDW = kBK + kHalo;            // dy columns staged: t'0 - 12 ..
constexpr int kDS = kDW;                    // dy row stride (floats): 12 mod 32, float4 rows
constexpr int kPlane = kNch * kCoTile * 4;  // floats a plane
constexpr size_t kSmem =
    (size_t)(2 * kPlane + 2 * kCiTile * kXS + 2 * kCoTile * kDS) * sizeof(float);
static_assert(kDS % 4 == 0 && kXS % 4 == 0, "16-byte rows");

struct WgradArgs {
  const float* x;   // [B, Cin, T]
  const float* dy;  // [B, Cout, T]
  float* ws;        // [slices][mt * nt][64][128]
  int B, T, Cin, Cout;
  int kt;      // K-tiles a record: ceil((T + 12) / 64)
  int nt;      // output-channel tiles: Cout / 32
  int tiles;   // mt * nt
  int slices;  // the reduction's slices
  int vec;     // T % 4 == 0 and both bases 16-byte aligned: rows land by 16-byte copies
};

// K-tile g (record g / kt, t'0 = (g % kt) * 64) of this CTA's channels, raw:
// x[ci0 + i, t'0 - 8 + u] into xr[i][u] and dy[co0 + i, t'0 - 12 + u] into
// dr[i][u], zeros outside [0, T) and for channels >= Cin
__device__ __forceinline__ void issue_tile(const WgradArgs& a, long g, int ci0, int co0,
                                           float* xr, float* dr, int tid) {
  const int b = (int)(g / a.kt), t0 = (int)(g % a.kt) * kBK;
  const float* xb = a.x + (size_t)b * a.Cin * a.T;
  const float* db = a.dy + ((size_t)b * a.Cout + co0) * a.T;
  if (a.vec) {  // t0 - 8 and t0 - 12 are multiples of 4, as T is: a group is all in or all out
    for (int i = tid; i < kCiTile * (kXW / 4); i += kThreads) {
      const int row = i / (kXW / 4), t = t0 - 8 + 4 * (i - row * (kXW / 4));
      const bool in = ci0 + row < a.Cin && t >= 0 && t < a.T;
      cp_async16_zfill(xr + row * kXS + t - (t0 - 8),
                       xb + (in ? (size_t)(ci0 + row) * a.T + t : 0), in);
    }
    for (int i = tid; i < kCoTile * (kDW / 4); i += kThreads) {
      const int row = i / (kDW / 4), t = t0 - kHalo + 4 * (i - row * (kDW / 4));
      const bool in = t >= 0 && t < a.T;
      cp_async16_zfill(dr + row * kDS + t - (t0 - kHalo),
                       db + (in ? (size_t)row * a.T + t : 0), in);
    }
  } else {
    for (int i = tid; i < kCiTile * kXW; i += kThreads) {
      const int row = i / kXW, u = i - row * kXW, t = t0 - 8 + u;
      const bool in = ci0 + row < a.Cin && t >= 0 && t < a.T;
      cp_async4_zfill(xr + row * kXS + u, xb + (in ? (size_t)(ci0 + row) * a.T + t : 0), in);
    }
    for (int i = tid; i < kCoTile * kDW; i += kThreads) {
      const int row = i / kDW, u = i - row * kDW, t = t0 - kHalo + u;
      const bool in = t >= 0 && t < a.T;
      cp_async4_zfill(dr + row * kDS + u, db + (in ? (size_t)row * a.T + t : 0), in);
    }
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// CTA (slice, tile): the m64 x n128 sums of its slice of the reduction, into
// the workspace
__global__ void __launch_bounds__(kThreads, 2) conv_wgrad_kernel(const WgradArgs a) {
  static_assert(kBK % (8 * kSteps) == 0, "whole stages a K-tile");
  extern __shared__ __align__(128) unsigned char smem[];
  float* planes = reinterpret_cast<float*>(smem);  // [big | small][kNch][32 co][4 t]
  float* xr0 = planes + 2 * kPlane;                // [2 buffers][16 ci][kXS]
  float* dr0 = xr0 + 2 * kCiTile * kXS;            // [2 buffers][32 co][kDS]
  const int tid = threadIdx.x;
  const int slice = blockIdx.x / a.tiles, tile = blockIdx.x - slice * a.tiles;
  const int mt = tile / a.nt, ntile = tile - mt * a.nt;
  const int ci0 = mt * kCiTile, co0 = ntile * kCoTile;
  const long total = (long)a.B * a.kt;
  const long g0 = total * slice / a.slices, g1 = total * (slice + 1) / a.slices;

  const int warp = tid >> 5, lane = tid & 31;
  const int g8 = lane >> 2, q = lane & 3;
  // A row m = 16 warp + g8 (+8): ci = m / 4, r = m % 4; element (m, k) of k8
  // step st is xr[ci][8 st + k + r + 1]
  const int xoff = (4 * warp + (g8 >> 2)) * kXS + (g8 & 3) + 1 + q;

  float acc[kNCols / 2], part[kNCols / 2];
#pragma unroll
  for (int i = 0; i < kNCols / 2; ++i) acc[i] = 0.f;

  int buf = 0;
  if (g0 < g1) issue_tile(a, g0, ci0, co0, xr0, dr0, tid);
#pragma unroll 1
  for (long g = g0; g < g1; ++g, buf ^= 1) {
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    __syncthreads();  // tile g landed; every thread is done with tile g - 1's planes and rows
    if (g + 1 < g1)
      issue_tile(a, g + 1, ci0, co0, xr0 + (buf ^ 1) * kCiTile * kXS,
                 dr0 + (buf ^ 1) * kCoTile * kDS, tid);
    // dy's rows -> the two planes, a 16-byte core-matrix row (4 t of one channel) a step
    const float* dr = dr0 + buf * kCoTile * kDS;
    for (int i = tid; i < kNch * kCoTile; i += kThreads) {
      const int co = i & (kCoTile - 1), c = i / kCoTile;
      const float4 v = *reinterpret_cast<const float4*>(dr + co * kDS + 4 * c);
      uint4 hi, lo;
      split_tf32(__float_as_uint(v.x), hi.x, lo.x);
      split_tf32(__float_as_uint(v.y), hi.y, lo.y);
      split_tf32(__float_as_uint(v.z), hi.z, lo.z);
      split_tf32(__float_as_uint(v.w), hi.w, lo.w);
      *reinterpret_cast<uint4*>(planes + (c * kCoTile + co) * 4) = hi;
      *reinterpret_cast<uint4*>(planes + kPlane + (c * kCoTile + co) * 4) = lo;
    }
    fence_proxy_async();  // the planes, written here, are read by wgmma
    __syncthreads();

    const float* xa = xr0 + buf * kCiTile * kXS + xoff;
#pragma unroll 1
    for (int s = 0; s < kBK / (8 * kSteps); ++s) {
      uint32_t ab[kSteps][4], as[kSteps][4];
#pragma unroll
      for (int j = 0; j < kSteps; ++j) {
        const float* p = xa + 8 * (s * kSteps + j);
        const float f[4] = {p[0], p[2 * kXS], p[4], p[2 * kXS + 4]};
#pragma unroll
        for (int e = 0; e < 4; ++e) split_tf32(__float_as_uint(f[e]), ab[j][e], as[j][e]);
      }
      wg_fence();
#pragma unroll
      for (int j = 0; j < kSteps; ++j) {
        // k8 step st: 4-t groups 2 st and 2 st + 1 (512 bytes apart), channel
        // groups of 8 (j, co) 128 bytes apart
        const uint64_t big = b_desc(planes + (s * kSteps + j) * 2 * kCoTile * 4, 512, 128);
        const uint64_t small = big + ((kPlane * sizeof(float)) >> 4);
        if (j == 0) wgmma_tf32<kNCols, 0>(part, as[j], big);
        else wgmma_tf32<kNCols, 1>(part, as[j], big);
        wgmma_tf32<kNCols, 1>(part, ab[j], small);
        wgmma_tf32<kNCols, 1>(part, ab[j], big);
      }
      wg_commit();
      wg_wait<0>();
#pragma unroll
      for (int i = 0; i < kNCols / 2; ++i) pin(part[i]);
#pragma unroll
      for (int j = 0; j < kSteps; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          pin(ab[j][e]);
          pin(as[j][e]);
        }
#pragma unroll
      for (int i = 0; i < kNCols / 2; ++i) acc[i] += part[i];
    }
  }

  // sum i of n8 chunk c is row g8 (i % 4 < 2) or g8 + 8, column 8c + 2q + (i & 1)
  float* w = a.ws + ((size_t)slice * a.tiles + tile) * kTileSums;
#pragma unroll
  for (int c = 0; c < kNCols / 8; ++c)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = 16 * warp + g8 + 8 * h, col = 8 * c + 2 * q;
      *reinterpret_cast<float2*>(w + row * kNCols + col) =
          make_float2(acc[4 * c + 2 * h], acc[4 * c + 2 * h + 1]);
    }
}

// dW from the workspace: a block takes 32 neighbouring sums of every slice,
// its eight warps slices w, w + 8, ... each, then warp 0 adds the eight in
// order; each sum lands at its (co, ci, tap), tap = 12 - 4j + r
constexpr int kRedWarps = 8;

__global__ void __launch_bounds__(32 * kRedWarps) wgrad_reduce_kernel(const WgradArgs a,
                                                                      float* dw) {
  __shared__ float sums[kRedWarps][32];
  const int lane = threadIdx.x & 31, wp = threadIdx.x >> 5;
  const size_t per = (size_t)a.tiles * kTileSums;
  const size_t i = (size_t)blockIdx.x * 32 + lane;
  float s = 0.f;
  for (int k = wp; k < a.slices; k += kRedWarps) s += a.ws[(size_t)k * per + i];
  sums[wp][lane] = s;
  __syncthreads();
  if (wp) return;
  s = sums[0][lane];
#pragma unroll
  for (int k = 1; k < kRedWarps; ++k) s += sums[k][lane];
  const int tile = (int)(i / kTileSums), mn = (int)(i - (size_t)tile * kTileSums);
  const int m = mn / kNCols, n = mn - m * kNCols;
  const int ci = (tile / a.nt) * kCiTile + m / 4, tap = 12 - 4 * (n / kCoTile) + (m & 3);
  const int co = (tile % a.nt) * kCoTile + (n & (kCoTile - 1));
  if (ci < a.Cin && tap < kK) dw[((size_t)co * a.Cin + ci) * kK + tap] = s;
}

cudaError_t launch(const WgradArgs& a, float* dw, cudaStream_t st) {
  cudaError_t err = cudaFuncSetAttribute(conv_wgrad_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmem);
  if (err != cudaSuccess) return err;
  conv_wgrad_kernel<<<a.slices * a.tiles, kThreads, kSmem, st>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  wgrad_reduce_kernel<<<(unsigned)((size_t)a.tiles * kTileSums / 32), 32 * kRedWarps, 0, st>>>(
      a, dw);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dW [Cout, Cin, 15] of the stride-1 SAME conv (k=15, pad 7) from x [B, Cin, T]
// and dy [B, Cout, T], all f32 and contiguous; ws holds slices * ceil(Cin / 16)
// * (Cout / 32) * 8192 floats (ops/kernels/conv_wgrad.py::plan); Cout % 32 == 0;
// slices <= B * ceil((T + 12) / 64).
int ptbxl_conv_wgrad(int device, const void* x, const void* dy, void* ws, void* dw, int B, int T,
                     int Cin, int Cout, int slices, void* stream) {
  cudaError_t err = ptbxl_ensure_device(device);
  if (err != cudaSuccess) return (int)err;
  if (B <= 0 || T <= 0 || Cin <= 0 || Cout <= 0 || Cout % kCoTile || slices <= 0)
    return (int)cudaErrorInvalidValue;
  WgradArgs a{};
  a.x = static_cast<const float*>(x);
  a.dy = static_cast<const float*>(dy);
  a.ws = static_cast<float*>(ws);
  a.B = B, a.T = T, a.Cin = Cin, a.Cout = Cout;
  a.kt = (T + kHalo + kBK - 1) / kBK;
  a.nt = Cout / kCoTile;
  a.tiles = ((Cin + kCiTile - 1) / kCiTile) * a.nt;
  a.slices = slices;
  if ((long)slices > (long)B * a.kt || (long)slices * a.tiles > INT32_MAX)
    return (int)cudaErrorInvalidValue;
  a.vec = T % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
          reinterpret_cast<uintptr_t>(dy) % 16 == 0;
  return (int)launch(a, static_cast<float*>(dw), static_cast<cudaStream_t>(stream));
}

}  // extern "C"
