// K1: per-lead z-score of a channels-last batch, hand-written for Hopper.
//
// Replaces ptbxl_tpu/ops/pallas/zscore.py: zscore_tile (:44), _zscore_kernel
// (:59) and zscore_pallas (:64).  For every (record, lead) over time:
//   mean = sum(x) / T;  var = sum((x - mean)^2) / T  (two passes, f32 moments)
//   out  = (x - mean) / (sqrt(var) + 1e-6)           in the output dtype
// ptbxl_zscore writes the normalized [B, T, C] tensor (f32 or bf16 in and
// out); ptbxl_zscore_stats writes only [B, C, 2] = (mean, std + eps), which
// the fused ECGCNN forward (fused_ecgcnn.cu) applies while it loads block 0.
//
// Bound on the H100: bytes.  The function reads the input once and writes the
// output once (3.35 TB/s); its arithmetic is a few operations per element.
// Design: one block per record.  The leads are interleaved in memory (flat
// index t*C + c), so a block of n = C * floor(512 / C) threads walks the flat
// record with stride n and every thread always sees the same lead (index % C):
// reads stay coalesced and each thread keeps one partial sum.  The C
// per-lead totals are folded in shared memory.  The three passes (sum,
// centred sum, write) re-read the record; a record is 240 KB at f32, more
// than a block's shared memory, so the re-reads go to L2 / HBM.
// The partials and their fold are f64: each thread adds ~T*C/n values in a
// row, and in f32 that loses bits against a tree reduction when a lead's DC
// offset is large beside its std (1.6e-5 on the output at offset ~N(0, 3),
// scale 0.1).  The addends (x, and (x - mean)^2 with x - mean and the square
// in f32) and the moments (total/T, rounded to f32 first) stay the f32
// two-pass form of the reference; the f64 adds cost nothing in a bytes-bound
// kernel.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr float kEps = 1e-6f;
constexpr int kMaxThreads = 512;

__device__ __forceinline__ float load_f(const float* p, long i) { return p[i]; }
__device__ __forceinline__ float load_f(const __nv_bfloat16* p, long i) {
  return __bfloat162float(p[i]);
}
__device__ __forceinline__ void store_f(float* p, long i, float v) { p[i] = v; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, long i, float v) {
  p[i] = __float2bfloat16_rn(v);
}

// Total over the block of each thread's partial for its lead (threadIdx.x % C),
// rounded to f32.  red holds blockDim.x + C doubles.
__device__ float lead_total(double partial, double* red, int C) {
  const int n = blockDim.x;
  red[threadIdx.x] = partial;
  __syncthreads();
  if (threadIdx.x < C) {
    double s = 0.0;
    for (int j = threadIdx.x; j < n; j += C) s += red[j];
    red[n + threadIdx.x] = s;
  }
  __syncthreads();
  const float tot = (float)red[n + threadIdx.x % C];
  __syncthreads();  // red is reused by the next call
  return tot;
}

template <typename Tin, typename Tout, bool kStatsOnly>
__global__ void zscore_kernel(const Tin* __restrict__ x, Tout* __restrict__ out,
                              float* __restrict__ stats, int T, int C) {
  extern __shared__ double red[];
  const long len = (long)T * C;
  const long base = (long)blockIdx.x * len;
  const Tin* xr = x + base;
  const int n = blockDim.x;

  double s = 0.0;
  for (long i = threadIdx.x; i < len; i += n) s += (double)load_f(xr, i);
  const float mean = lead_total(s, red, C) / (float)T;

  double v = 0.0;
  for (long i = threadIdx.x; i < len; i += n) {
    const float d = load_f(xr, i) - mean;
    v += (double)__fmul_rn(d, d);  // the f32 square of the reference, not fused
  }
  const float sd = sqrtf(lead_total(v, red, C) / (float)T) + kEps;

  if (kStatsOnly) {
    if (threadIdx.x < C) {
      float* st = stats + ((long)blockIdx.x * C + threadIdx.x) * 2;
      st[0] = mean;
      st[1] = sd;
    }
    return;
  }
  Tout* o = out + base;
  for (long i = threadIdx.x; i < len; i += n) store_f(o, i, (load_f(xr, i) - mean) / sd);
}

template <typename Tin, typename Tout, bool kStatsOnly>
void launch(const void* x, void* out, void* stats, int B, int T, int C, cudaStream_t st) {
  const int threads = (kMaxThreads / C) * C;
  const size_t smem = (size_t)(threads + C) * sizeof(double);
  zscore_kernel<Tin, Tout, kStatsOnly><<<B, threads, smem, st>>>(
      static_cast<const Tin*>(x), static_cast<Tout*>(out), static_cast<float*>(stats), T, C);
}

}  // namespace

extern "C" {

// x [B, T, C] (f32, or bf16 when in_bf16) -> out [B, T, C] (bf16 when out_bf16).
int ptbxl_zscore(int device, const void* x, void* out, int B, int T, int C, int in_bf16,
                 int out_bf16, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (B <= 0 || T <= 0 || C <= 0 || C > kMaxThreads) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!in_bf16 && !out_bf16) launch<float, float, false>(x, out, nullptr, B, T, C, st);
  else if (!in_bf16) launch<float, __nv_bfloat16, false>(x, out, nullptr, B, T, C, st);
  else if (!out_bf16) launch<__nv_bfloat16, float, false>(x, out, nullptr, B, T, C, st);
  else launch<__nv_bfloat16, __nv_bfloat16, false>(x, out, nullptr, B, T, C, st);
  return (int)cudaGetLastError();
}

// x [B, T, C] -> stats [B, C, 2] f32: (mean, sqrt(var) + 1e-6).
int ptbxl_zscore_stats(int device, const void* x, void* stats, int B, int T, int C, int in_bf16,
                       void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (B <= 0 || T <= 0 || C <= 0 || C > kMaxThreads) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (in_bf16) launch<__nv_bfloat16, float, true>(x, nullptr, stats, B, T, C, st);
  else launch<float, float, true>(x, nullptr, stats, B, T, C, st);
  return (int)cudaGetLastError();
}

const char* ptbxl_strerror(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
