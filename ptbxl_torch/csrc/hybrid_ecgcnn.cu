// P3's im2col layer: one conv block (conv k=15 with bf16 operands and f32
// sums, + bias, ReLU, floor MaxPool(2)) on tensor cores with mma.sync,
// hand-written for Hopper.  (K4's blocks ran on this kernel until they moved
// to the wgmma block of csrc/hybrid_wgmma.cu; P3 and P4 keep it.)
//
// Replaces tools/probe_layer_perf.py make_pallas_layer (:52) in its "im2col"
// mode: an im2col of 15 shifted slices, [t, 15*Cin], and one [t, 15*Cin] x
// [15*Cin, Cout] product in bf16 with f32 sums.
//
// Bound on the H100: operations for the probe's layers 3 and 4 (307.2 +
// 614.4 MFLOP a record against 989 TFLOP/s of dense bf16), bytes for its
// layers 1 and 2.
//
// Design: an implicit GEMM.  A block of 256 threads (8 warps, 4 along time x 2
// along channels) owns BM = 128 conv rows of one record and BN output
// channels.  It stages its input rows with their 14-row halo once, rounded to
// bf16, in shared memory: row m of the im2col at column k*Cin + c is tile row
// m + k at channel c, so each 16-wide slice of the reduction is a plain
// 16 x 16 tile of shifted rows and ldmatrix reads it directly (no im2col is
// ever written).  The time axis is tiled.  The weights stream through a
// double buffer, one tap ([Cin, BN]) at a time, by cp.async while the
// previous tap's products run.  The products are mma.sync m16n8k16 bf16 ->
// f32 with the sums in registers.  Two neighbouring conv rows of a warp's
// accumulator tile sit in lanes 4 apart, so bias, ReLU and the floor pool are
// a shuffle in the epilogue and only [T/2, Cout] is written, in f32.
// Channels are zero-padded to a multiple of 16 in shared memory and in the
// weights (Cin = 12: 15 * 16 = 240 reduction rows instead of 180), so that no
// 16-wide slice straddles two taps.
//
// P4 (tools/probe_sublane_conv.py make_layer, :51) is the same layer on a
// channel-major input [B, Cpad, T+14] with an output [B, Cout, T/2]: its
// kernel stages the input tile transposed (coalesced reads along time) and
// runs the same tap loop, then stages the pooled tile in shared memory so
// that the [Cout, T/2] stores coalesce along time.  Its first two layers at
// B=2048 are bound by bytes (~0.66 GB in and out each), the last two by
// operations.  The TPU's b_tile (records per grid step in VMEM) has no
// counterpart: the grid is time tiles x records x channel tiles.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kK = 15;        // conv taps
constexpr int kBM = 128;      // conv rows per block
constexpr int kRows = kBM + kK - 1;
constexpr int kThreads = 256;
constexpr int kWarpsM = 4;
constexpr int kWarpsN = 2;
constexpr int kSkew = 8;      // bf16 elements of padding a shared row (bank spread, 16-byte rows)

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, const __nv_bfloat16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* r, const __nv_bfloat16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

// d += a (16x16, row) * b (16x8, col): bf16 operands, f32 sums
__device__ __forceinline__ void mma_bf16(float* d, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(dst)), "l"(src));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x = lo (lower address)
  return *reinterpret_cast<uint32_t*>(&v);
}

template <int BN>
struct TileShape {
  static constexpr int kWN = BN / kWarpsN;  // warp tile: 32 rows x kWN channels
  static constexpr int kMT = kBM / kWarpsM / 16;
  static constexpr int kNT = kWN / 8;
  static constexpr int kWS = BN + kSkew;  // weight tile row stride
};

// one tap's weights [CinP, BN] -> buffer buf of ws, 16-byte cp.async chunks
template <int BN>
__device__ __forceinline__ void load_w_tap(__nv_bfloat16* ws, const __nv_bfloat16* __restrict__ w,
                                           int tap, int buf, int CinP, int Cout, int n0) {
  constexpr int kChunks = BN / 8;
  constexpr int kWS = TileShape<BN>::kWS;
  __nv_bfloat16* dst = ws + buf * CinP * kWS;
  const __nv_bfloat16* src = w + ((long)tap * CinP) * Cout + n0;
  for (int i = threadIdx.x; i < CinP * kChunks; i += kThreads) {
    const int r = i / kChunks, ch = i % kChunks;
    cp_async16(dst + r * kWS + ch * 8, src + (long)r * Cout + ch * 8);
  }
}

// acc += the 15 taps' products of the staged input tile xs [kRows][xs_stride]
// (bf16) and the weights, streamed a tap at a time through the double buffer
// ws; tap 0's load must already be committed.  Ends with a __syncthreads(), so
// the shared memory can be reused.
template <int BN>
__device__ __forceinline__ void conv_taps(
    const __nv_bfloat16* xs, int xs_stride, __nv_bfloat16* ws, const __nv_bfloat16* __restrict__ w,
    int CinP, int Cout, int n0, int wm0, int wn0, int lane,
    float (&acc)[TileShape<BN>::kMT][TileShape<BN>::kNT][4]) {
  constexpr int kMT = TileShape<BN>::kMT;
  constexpr int kNT = TileShape<BN>::kNT;
  constexpr int kWS = TileShape<BN>::kWS;
  const int lrow = lane & 15, lcol = (lane >> 4) * 8;
#pragma unroll 1
  for (int tap = 0; tap < kK; ++tap) {
    if (tap + 1 < kK) {
      load_w_tap<BN>(ws, w, tap + 1, (tap + 1) & 1, CinP, Cout, n0);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const __nv_bfloat16* wb = ws + (tap & 1) * CinP * kWS;
#pragma unroll 1
    for (int k0 = 0; k0 < CinP; k0 += 16) {
      uint32_t a[kMT][4];
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt)
        ldmatrix_x4(a[mt], xs + (wm0 + mt * 16 + lrow + tap) * xs_stride + k0 + lcol);
#pragma unroll
      for (int np = 0; np < kNT / 2; ++np) {
        uint32_t b[4];
        ldmatrix_x4_trans(b, wb + (k0 + lrow) * kWS + wn0 + np * 16 + lcol);
#pragma unroll
        for (int mt = 0; mt < kMT; ++mt) {
          mma_bf16(acc[mt][2 * np], a[mt], b[0], b[1]);
          mma_bf16(acc[mt][2 * np + 1], a[mt], b[2], b[3]);
        }
      }
    }
    __syncthreads();  // this buffer is refilled two taps on
  }
}

// x [B, Tx, Cin] f32 (Cin % 4 == 0); conv row t reads rows t + k - off (zero
// outside [0, Tx)); w [kK, CinP, Cout] bf16, zero for channels >= Cin;
// bias [Cout] f32; y [B, T/2, Cout] f32 = pool(relu(conv + bias)).
template <int BN>
__global__ void __launch_bounds__(kThreads)
tc_conv_block_kernel(const float* __restrict__ x, const __nv_bfloat16* __restrict__ w,
                     const float* __restrict__ bias, float* __restrict__ y, int Tx, int T,
                     int off, int Cin, int CinP, int Cout, int row_tiles) {
  constexpr int kMT = TileShape<BN>::kMT;
  constexpr int kNT = TileShape<BN>::kNT;
  extern __shared__ __align__(16) unsigned char smem[];
  const int xs_stride = CinP + kSkew;
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(smem);  // [kRows][xs_stride]
  __nv_bfloat16* ws = xs + kRows * xs_stride;                   // 2 x [CinP][kWS]

  const int rec = blockIdx.x / row_tiles;
  const int t0 = (blockIdx.x % row_tiles) * kBM;
  const int n0 = blockIdx.y * BN;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm0 = (warp % kWarpsM) * (kBM / kWarpsM);
  const int wn0 = (warp / kWarpsM) * TileShape<BN>::kWN;

  load_w_tap<BN>(ws, w, 0, 0, CinP, Cout, n0);
  cp_async_commit();

  // input tile: rows t0 - off .. t0 - off + kRows - 1, rounded to bf16, zero
  // outside [0, Tx) and for channels >= Cin
  const float* xr = x + (long)rec * Tx * Cin;
  const int c4s = CinP / 4;
  for (int i = threadIdx.x; i < kRows * c4s; i += kThreads) {
    const int r = i / c4s, c = (i % c4s) * 4;
    const int t = t0 - off + r;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (t >= 0 && t < Tx && c < Cin) v = *reinterpret_cast<const float4*>(xr + (long)t * Cin + c);
    uint2 p;
    p.x = pack_bf16(v.x, v.y);
    p.y = pack_bf16(v.z, v.w);
    *reinterpret_cast<uint2*>(xs + r * xs_stride + c) = p;
  }

  float acc[kMT][kNT][4];
#pragma unroll
  for (int i = 0; i < kMT; ++i)
#pragma unroll
    for (int j = 0; j < kNT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  conv_taps<BN>(xs, xs_stride, ws, w, CinP, Cout, n0, wm0, wn0, lane, acc);

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
            o.y = fmaxf(fmaxf(acc[mt][nt][2 * h + 1] + b1, 0.f),
                        fmaxf(p[2 * h + 1] + b1, 0.f));
            *reinterpret_cast<float2*>(yr + (long)prow * Cout + col) = o;
          }
        }
      }
    }
  }
}

// P4: the same conv block on a channel-major input.  x [B, CinP, Tx] f32, already
// padded in time (conv row t reads columns t + k); w [kK, CinP, Cout] bf16;
// bias [Cout] f32; y [B, Cout, T/2] f32 (kOutCF) or [B, T/2, Cout].  The
// input tile is transposed while it is staged (reads coalesce along time), so
// the tap loop is K4's.  With kOutCF the pooled tile is staged in shared
// memory as [BN][kBM/2] and written along time, so the stores coalesce.
template <int BN, bool kOutCF>
__global__ void __launch_bounds__(kThreads)
tc_conv_layer_cf_kernel(const float* __restrict__ x, const __nv_bfloat16* __restrict__ w,
                        const float* __restrict__ bias, float* __restrict__ y, int Tx, int T,
                        int CinP, int Cout, int row_tiles) {
  constexpr int kMT = TileShape<BN>::kMT;
  constexpr int kNT = TileShape<BN>::kNT;
  constexpr int kPR = kBM / 2;  // pooled rows of a block
  constexpr int kOS = kPR + 1;  // staged output row stride (floats)
  extern __shared__ __align__(16) unsigned char smem[];
  const int xs_stride = CinP + kSkew;
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(smem);  // [kRows][xs_stride]
  __nv_bfloat16* ws = xs + kRows * xs_stride;                   // 2 x [CinP][kWS]

  const int rec = blockIdx.x / row_tiles;
  const int t0 = (blockIdx.x % row_tiles) * kBM;
  const int n0 = blockIdx.y * BN;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm0 = (warp % kWarpsM) * (kBM / kWarpsM);
  const int wn0 = (warp / kWarpsM) * TileShape<BN>::kWN;

  load_w_tap<BN>(ws, w, 0, 0, CinP, Cout, n0);
  cp_async_commit();

  // input tile, transposed while staged: xs[r][c] = bf16(x[rec, c, t0 + r]),
  // zero past Tx
  const float* xr = x + (long)rec * CinP * Tx;
  for (int i = threadIdx.x; i < kRows * CinP; i += kThreads) {
    const int c = i / kRows, r = i % kRows;
    const int t = t0 + r;
    const float v = t < Tx ? xr[(long)c * Tx + t] : 0.f;
    xs[r * xs_stride + c] = __float2bfloat16_rn(v);
  }

  float acc[kMT][kNT][4];
#pragma unroll
  for (int i = 0; i < kMT; ++i)
#pragma unroll
    for (int j = 0; j < kNT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  conv_taps<BN>(xs, xs_stride, ws, w, CinP, Cout, n0, wm0, wn0, lane, acc);

  const int g = lane >> 2, q = lane & 3;
  const int half = T / 2;
  float* os = reinterpret_cast<float*>(smem);  // [BN][kOS], after the tap loop's last sync
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt) {
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt) {
      float p[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) p[e] = __shfl_xor_sync(0xffffffffu, acc[mt][nt][e], 4);
      if ((g & 1) == 0) {
        const int col = wn0 + nt * 8 + q * 2;  // within the block's BN channels
        const float b0 = bias[n0 + col], b1 = bias[n0 + col + 1];
        const int lrow = wm0 + mt * 16 + g;  // even
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int pl = (lrow + 8 * h) / 2;
          const float o0 = fmaxf(fmaxf(acc[mt][nt][2 * h] + b0, 0.f), fmaxf(p[2 * h] + b0, 0.f));
          const float o1 =
              fmaxf(fmaxf(acc[mt][nt][2 * h + 1] + b1, 0.f), fmaxf(p[2 * h + 1] + b1, 0.f));
          if (kOutCF) {
            os[col * kOS + pl] = o0;
            os[(col + 1) * kOS + pl] = o1;
          } else if (t0 / 2 + pl < half) {
            float* yr = y + ((long)rec * half + t0 / 2 + pl) * Cout + n0 + col;
            *reinterpret_cast<float2*>(yr) = make_float2(o0, o1);
          }
        }
      }
    }
  }
  if (kOutCF) {
    __syncthreads();
    float* yr = y + ((long)rec * Cout + n0) * half;
    for (int i = threadIdx.x; i < BN * kPR; i += kThreads) {
      const int n = i / kPR, pl = i % kPR;
      const int prow = t0 / 2 + pl;
      if (prow < half) yr[(long)n * half + prow] = os[n * kOS + pl];
    }
  }
}

template <int BN>
cudaError_t launch_tc(const float* x, const __nv_bfloat16* w, const float* b, float* y, int B,
                      int Tx, int T, int off, int Cin, int CinP, int Cout, cudaStream_t st) {
  const size_t smem = (size_t)(kRows * (CinP + kSkew) + 2 * CinP * (BN + kSkew)) * 2;
  if (smem > 232448) return cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(tc_conv_block_kernel<BN>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  const int conv_rows = 2 * (T / 2);
  const int row_tiles = (conv_rows + kBM - 1) / kBM;
  dim3 grid(B * row_tiles, Cout / BN);
  tc_conv_block_kernel<BN><<<grid, kThreads, smem, st>>>(x, w, b, y, Tx, T, off, Cin, CinP, Cout,
                                                         row_tiles);
  return cudaGetLastError();
}

template <int BN, bool kOutCF>
cudaError_t launch_tc_cf(const float* x, const __nv_bfloat16* w, const float* b, float* y, int B,
                         int Tx, int T, int CinP, int Cout, cudaStream_t st) {
  const size_t main_smem = (size_t)(kRows * (CinP + kSkew) + 2 * CinP * (BN + kSkew)) * 2;
  const size_t out_smem = kOutCF ? (size_t)BN * (kBM / 2 + 1) * 4 : 0;
  const size_t smem = main_smem > out_smem ? main_smem : out_smem;
  if (smem > 232448) return cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(tc_conv_layer_cf_kernel<BN, kOutCF>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  const int conv_rows = 2 * (T / 2);
  const int row_tiles = (conv_rows + kBM - 1) / kBM;
  dim3 grid(B * row_tiles, Cout / BN);
  tc_conv_layer_cf_kernel<BN, kOutCF><<<grid, kThreads, smem, st>>>(x, w, b, y, Tx, T, CinP, Cout,
                                                                     row_tiles);
  return cudaGetLastError();
}

template <bool kOutCF>
cudaError_t launch_cf(const float* x, const __nv_bfloat16* w, const float* b, float* y, int B,
                      int Tx, int T, int CinP, int Cout, cudaStream_t st) {
  if (Cout % 128 == 0) return launch_tc_cf<128, kOutCF>(x, w, b, y, B, Tx, T, CinP, Cout, st);
  if (Cout % 64 == 0) return launch_tc_cf<64, kOutCF>(x, w, b, y, B, Tx, T, CinP, Cout, st);
  return launch_tc_cf<32, kOutCF>(x, w, b, y, B, Tx, T, CinP, Cout, st);
}

}  // namespace

extern "C" {

// One conv block on tensor cores.  x [B, Tx, Cin] f32; conv row t in
// [0, 2*(T/2)) reads rows t + k - off (k < 15), zero outside [0, Tx);
// w [15, CinP, Cout] bf16; b [Cout] f32; y [B, T/2, Cout] f32.
// Cin % 4 == 0, CinP % 16 == 0, CinP >= Cin, Cout % 32 == 0, T >= 2.
int ptbxl_tc_conv_block(int device, const void* x, const void* w, const void* b, void* y, int B,
                        int Tx, int T, int off, int Cin, int CinP, int Cout, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (B <= 0 || Tx <= 0 || T < 2 || Cin <= 0 || Cin % 4 || CinP % 16 || CinP < Cin ||
      Cout <= 0 || Cout % 32)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* xs = static_cast<const float*>(x);
  const __nv_bfloat16* ws = static_cast<const __nv_bfloat16*>(w);
  const float* bs = static_cast<const float*>(b);
  float* ys = static_cast<float*>(y);
  if (Cout % 128 == 0) err = launch_tc<128>(xs, ws, bs, ys, B, Tx, T, off, Cin, CinP, Cout, st);
  else if (Cout % 64 == 0) err = launch_tc<64>(xs, ws, bs, ys, B, Tx, T, off, Cin, CinP, Cout, st);
  else err = launch_tc<32>(xs, ws, bs, ys, B, Tx, T, off, Cin, CinP, Cout, st);
  return (int)err;
}

// P4: one conv layer on a channel-major, time-padded input.  x [B, CinP, Tx]
// f32; conv row t in [0, 2*(T/2)), T = Tx - 14, reads columns t + k (k < 15);
// w [15, CinP, Cout] bf16; b [Cout] f32; y [B, Cout, T/2] f32 when
// transpose_out, else [B, T/2, Cout].  CinP % 16 == 0, Cout % 32 == 0, T >= 2.
int ptbxl_conv_layer_cf(int device, const void* x, const void* w, const void* b, void* y, int B,
                        int Tx, int CinP, int Cout, int transpose_out, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int T = Tx - (kK - 1);
  if (B <= 0 || T < 2 || CinP <= 0 || CinP % 16 || Cout <= 0 || Cout % 32)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* xs = static_cast<const float*>(x);
  const __nv_bfloat16* ws = static_cast<const __nv_bfloat16*>(w);
  const float* bs = static_cast<const float*>(b);
  float* ys = static_cast<float*>(y);
  if (transpose_out) return (int)launch_cf<true>(xs, ws, bs, ys, B, Tx, T, CinP, Cout, st);
  return (int)launch_cf<false>(xs, ws, bs, ys, B, Tx, T, CinP, Cout, st);
}

const char* ptbxl_strerror(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
