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
// 153.6 + 307.2 + 614.4 MFLOP for the four blocks) against 67 TFLOP/s of
// non-tensor-core FP32; the bytes (one input read, the logits written) are
// far below that.  The TPU kernel keeps a whole record (~2 MB) on chip; an
// H100 block has at most 227 KB of shared memory and one f32 [5000,12] input
// alone is 240 KB.  So this first design is a short sequence of launches on
// the caller's stream, with intermediates in device memory (about 1.3 GB of
// traffic at B=512, ~0.4 ms, small beside the FP32 work):
//   ptbxl_conv_block (once per block): a block of 256 threads owns TR conv
//     rows x CO output channels of one record.  It stages an input tile with
//     its 7-row halo (zero outside [0, T), so SAME padding pads the
//     *normalized* signal with zeros) and the matching weights in shared
//     memory, CI input channels at a time, and keeps a 4x4 register tile of
//     f32 sums per thread.  Block 0 applies the z-score as it loads.  Two
//     neighbouring rows of the register tile are one pool window, so bias,
//     ReLU and the floor pool happen in registers and only [T//2, Cout] is
//     written; the last conv row of an odd length is never computed.
//   ptbxl_tail: one block per record: mean over T, proj, head.
// K3 runs the same backbone launches (the folded backbone is the same
// function with weights in the same layout) and ends in ptbxl_mm_tail: one
// block per record, ~4.6 KB of shared memory at full width: mean over T,
// proj, demographics MLP (fc1, fc2 with ReLU), FiLM (gamma = 1 + tanh,
// z = gamma * z_ecg + beta) and head.  Its ~0.21 MFLOP a record are nothing
// beside the backbone's 1.133 GFLOP, so K3's bound is K2's.
// With bf16 compute every operand is rounded with __float2bfloat16_rn before
// the multiply and sums stay f32 (JAX's preferred_element_type=f32).  In K3
// z_ecg enters the FiLM in f32 and only z_cond is rounded, as the head's
// operand (_dot1, :252).
// Later work (wgmma, TMA, shared-memory-resident deep blocks) makes it fast.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kK = 15;          // conv taps
constexpr int kPad = kK / 2;    // SAME padding
constexpr int kCI = 8;          // input channels staged per step
constexpr int kStride = kCI + 1;  // padded row stride of the input tile (bank spread)
constexpr int kThreads = 256;
constexpr int kRowsPerThread = 4;  // conv rows, i.e. two pool windows
constexpr int kColsPerThread = 4;

template <bool kBf16>
__device__ __forceinline__ float rnd(float v) {
  if (kBf16) return __bfloat162float(__float2bfloat16_rn(v));
  return v;
}

// x [B, T, Cin] f32; stats [B, Cin, 2] (mean, std+eps) or unused;
// w [K, Cin, Cout] BN-folded; bias [Cout]; y [B, T/2, Cout].
template <int kCO, bool kBf16, bool kZscore>
__global__ void __launch_bounds__(kThreads)
conv_block_kernel(const float* __restrict__ x, const float* __restrict__ stats,
                  const float* __restrict__ w, const float* __restrict__ bias,
                  float* __restrict__ y, int T, int Cin, int Cout, int row_tiles) {
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
  const float* xr = x + (long)rec * T * Cin;

  float acc[kRowsPerThread][kColsPerThread];
#pragma unroll
  for (int r = 0; r < kRowsPerThread; ++r)
#pragma unroll
    for (int j = 0; j < kColsPerThread; ++j) acc[r][j] = 0.f;

  for (int c0 = 0; c0 < Cin; c0 += kCI) {
    for (int idx = threadIdx.x; idx < kInRows * kCI; idx += kThreads) {
      const int row = idx / kCI, ci = idx % kCI;
      const int t = t0 - kPad + row, c = c0 + ci;
      float v = 0.f;
      if (t >= 0 && t < T && c < Cin) {
        v = xr[(long)t * Cin + c];
        if (kZscore) {
          const float* st = stats + ((long)rec * Cin + c) * 2;
          v = (v - st[0]) / st[1];
        }
      }
      in_s[row * kStride + ci] = rnd<kBf16>(v);
    }
    for (int idx = threadIdx.x; idx < kK * kCI * kCO; idx += kThreads) {
      const int k = idx / (kCI * kCO), rem = idx % (kCI * kCO);
      const int ci = rem / kCO, co = rem % kCO;
      const int c = c0 + ci;
      w_s[idx] = c < Cin ? rnd<kBf16>(w[((long)k * Cin + c) * Cout + co0 + co]) : 0.f;
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

template <int kCO, bool kBf16, bool kZscore>
void launch_conv(const float* x, const float* stats, const float* w, const float* b, float* y,
                 int B, int T, int Cin, int Cout, cudaStream_t st) {
  constexpr int kTR = (kThreads / (kCO / kColsPerThread)) * kRowsPerThread;
  const int conv_rows = 2 * (T / 2);
  const int row_tiles = (conv_rows + kTR - 1) / kTR;
  dim3 grid(B * row_tiles, Cout / kCO);
  conv_block_kernel<kCO, kBf16, kZscore><<<grid, kThreads, 0, st>>>(x, stats, w, b, y, T, Cin,
                                                                   Cout, row_tiles);
}

template <int kCO>
void dispatch_conv(const float* x, const float* stats, const float* w, const float* b, float* y,
                   int B, int T, int Cin, int Cout, bool bf16, cudaStream_t st) {
  if (bf16) {
    if (stats) launch_conv<kCO, true, true>(x, stats, w, b, y, B, T, Cin, Cout, st);
    else launch_conv<kCO, true, false>(x, stats, w, b, y, B, T, Cin, Cout, st);
  } else {
    if (stats) launch_conv<kCO, false, true>(x, stats, w, b, y, B, T, Cin, Cout, st);
    else launch_conv<kCO, false, false>(x, stats, w, b, y, B, T, Cin, Cout, st);
  }
}

}  // namespace

extern "C" {

// One conv block.  stats may be null (no z-score on load).  Cout % 32 == 0, T >= 2.
int ptbxl_conv_block(int device, const void* x, const void* stats, const void* w,
                     const void* b, void* y, int B, int T, int Cin, int Cout, int bf16,
                     void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (B <= 0 || T < 2 || Cin <= 0 || Cout <= 0 || Cout % 32) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* xs = static_cast<const float*>(x);
  const float* ss = static_cast<const float*>(stats);
  const float* ws = static_cast<const float*>(w);
  const float* bs = static_cast<const float*>(b);
  float* ys = static_cast<float*>(y);
  if (Cout % 64 == 0) dispatch_conv<64>(xs, ss, ws, bs, ys, B, T, Cin, Cout, bf16 != 0, st);
  else dispatch_conv<32>(xs, ss, ws, bs, ys, B, T, Cin, Cout, bf16 != 0, st);
  return (int)cudaGetLastError();
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
