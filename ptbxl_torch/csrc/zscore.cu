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
//
// K5, ptbxl_zscore_wide, replaces zscore_pallas_wide (:107) and
// _zscore_wide_kernel (:82): the same function on a [T*C/W, W] view of each
// record (W % C == 0, so slot l of a row always holds lead l % C).  The TPU
// kernel folds its per-slot sums by lead with a [W, W] 0/1 product; here the
// fold is a segmented sum over slots in shared memory.  The view sets how a
// block walks the record: tpr = W / VE threads cover one W-wide row, VE
// elements each with one 16-byte (or narrower) coalesced load, and
// 512 / tpr rows are read at a time; every thread's VE slots, and so its
// leads, stay fixed, and it keeps one f64 partial a slot.  A block takes
// block_b records in turn (the grid is ceil(B / block_b); the ragged last
// group is masked, so B needs no padding).  Bound: bytes, as K1.  The three
// passes re-read the record from L2 (a bf16 record, 120 KB, would fit in
// shared memory, but one such block an SM leaves too few loads in flight).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

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

// ---- K5 ---------------------------------------------------------------------

// Raw storage of VE elements of type E (the width of one load or store).
template <typename E, int VE>
using Raw = typename std::conditional<
    VE * sizeof(E) == 16, uint4,
    typename std::conditional<
        VE * sizeof(E) == 8, uint2,
        typename std::conditional<VE * sizeof(E) == 4, uint32_t, uint16_t>::type>::type>::type;

template <typename E, int VE>
__device__ __forceinline__ void load_vec(const E* p, float* v) {
  const Raw<E, VE> raw = *reinterpret_cast<const Raw<E, VE>*>(p);
  const E* e = reinterpret_cast<const E*>(&raw);
#pragma unroll
  for (int i = 0; i < VE; ++i) v[i] = load_f(e, i);
}

template <typename E, int VE>
__device__ __forceinline__ void store_vec(E* p, const float* v) {
  Raw<E, VE> raw;
  E* e = reinterpret_cast<E*>(&raw);
#pragma unroll
  for (int i = 0; i < VE; ++i) store_f(e, i, v[i]);
  *reinterpret_cast<Raw<E, VE>*>(p) = raw;
}

// Fold the block's per-slot partials by lead and write each slot's value of
// fn(lead total as f32) to dst[W].  smem: red [nrow * W] doubles, lead [C] floats.
template <int VE, typename Fn>
__device__ __forceinline__ void fold_slots(const double* part, double* red, float* lead, float* dst, int W,
                           int C, int nrow, int rg, int j, Fn fn) {
#pragma unroll
  for (int e = 0; e < VE; ++e) red[rg * W + j * VE + e] = part[e];
  __syncthreads();
  for (int l = threadIdx.x; l < W; l += blockDim.x) {  // over row groups, into row 0
    double s = red[l];
    for (int r = 1; r < nrow; ++r) s += red[r * W + l];
    red[l] = s;
  }
  __syncthreads();
  for (int c = threadIdx.x; c < C; c += blockDim.x) {  // over the slots of lead c
    double s = 0.0;
    for (int l = c; l < W; l += C) s += red[l];
    lead[c] = fn((float)s);
  }
  __syncthreads();
  for (int l = threadIdx.x; l < W; l += blockDim.x) dst[l] = lead[l % C];
  __syncthreads();
}

// x, out [B, R, W] (R = T*C / W); blockDim = nrow * (W / VE).
template <typename Tin, typename Tout, int VE>
__global__ void zscore_wide_kernel(const Tin* __restrict__ x, Tout* __restrict__ out, int B,
                                   int T, int C, int W, int block_b) {
  extern __shared__ double wsm[];
  const int tpr = W / VE;
  const int nrow = blockDim.x / tpr;
  const int rg = threadIdx.x / tpr, j = threadIdx.x % tpr;
  const int R = (int)(((long)T * C) / W);
  double* red = wsm;                                   // [nrow * W]
  float* mean_s = reinterpret_cast<float*>(red + nrow * W);  // [W]: the slot's lead mean
  float* sd_s = mean_s + W;                            // [W]: its std + eps
  float* lead = sd_s + W;                              // [C]
  const float tf = (float)T;
  const int rec_end = min(B, (blockIdx.x + 1) * block_b);
  for (int rec = blockIdx.x * block_b; rec < rec_end; ++rec) {
    const long base = (long)rec * R * W + j * VE;
    const Tin* xr = x + base;
    float v[VE];
    double part[VE];
#pragma unroll
    for (int e = 0; e < VE; ++e) part[e] = 0.0;
    for (int r = rg; r < R; r += nrow) {
      load_vec<Tin, VE>(xr + (long)r * W, v);
#pragma unroll
      for (int e = 0; e < VE; ++e) part[e] += (double)v[e];
    }
    fold_slots<VE>(part, red, lead, mean_s, W, C, nrow, rg, j,
                   [tf](float tot) { return tot / tf; });

    float m[VE];
#pragma unroll
    for (int e = 0; e < VE; ++e) {
      m[e] = mean_s[j * VE + e];
      part[e] = 0.0;
    }
    for (int r = rg; r < R; r += nrow) {
      load_vec<Tin, VE>(xr + (long)r * W, v);
#pragma unroll
      for (int e = 0; e < VE; ++e) {
        const float d = v[e] - m[e];
        part[e] += (double)__fmul_rn(d, d);  // the f32 square of the reference, not fused
      }
    }
    fold_slots<VE>(part, red, lead, sd_s, W, C, nrow, rg, j,
                   [tf](float tot) { return sqrtf(tot / tf) + kEps; });

    float sd[VE];
#pragma unroll
    for (int e = 0; e < VE; ++e) sd[e] = sd_s[j * VE + e];
    Tout* o = out + base;
    for (int r = rg; r < R; r += nrow) {
      load_vec<Tin, VE>(xr + (long)r * W, v);
#pragma unroll
      for (int e = 0; e < VE; ++e) v[e] = (v[e] - m[e]) / sd[e];
      store_vec<Tout, VE>(o + (long)r * W, v);
    }
  }
}

template <typename Tin, typename Tout, int VE>
cudaError_t launch_wide(const void* x, void* out, int B, int T, int C, int W, int block_b,
                        cudaStream_t st) {
  const int tpr = W / VE;
  if (tpr > 1024) return cudaErrorInvalidValue;
  const int nrow = tpr >= 512 ? 1 : 512 / tpr;
  const size_t smem = (size_t)nrow * W * sizeof(double) + (size_t)(2 * W + C) * sizeof(float);
  if (smem > 232448) return cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(zscore_wide_kernel<Tin, Tout, VE>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  const int grid = (B + block_b - 1) / block_b;
  zscore_wide_kernel<Tin, Tout, VE><<<grid, nrow * tpr, smem, st>>>(
      static_cast<const Tin*>(x), static_cast<Tout*>(out), B, T, C, W, block_b);
  return cudaGetLastError();
}

// The widest VE (elements a load) that divides W, keeps a load or store at
// most 16 bytes and matches the pointers' alignment.
template <typename Tin, typename Tout>
cudaError_t dispatch_wide(const void* x, void* out, int B, int T, int C, int W, int block_b,
                          cudaStream_t st) {
  const size_t elt = sizeof(Tin) > sizeof(Tout) ? sizeof(Tin) : sizeof(Tout);
  const uintptr_t addr = reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(out);
  auto ok = [&](int ve) {
    return W % ve == 0 && ve * elt <= 16 && addr % (ve * sizeof(Tin)) == 0 &&
           reinterpret_cast<uintptr_t>(out) % (ve * sizeof(Tout)) == 0;
  };
  if (elt == 2 && ok(8)) return launch_wide<Tin, Tout, 8>(x, out, B, T, C, W, block_b, st);
  if (ok(4)) return launch_wide<Tin, Tout, 4>(x, out, B, T, C, W, block_b, st);
  if (ok(2)) return launch_wide<Tin, Tout, 2>(x, out, B, T, C, W, block_b, st);
  return launch_wide<Tin, Tout, 1>(x, out, B, T, C, W, block_b, st);
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

// K5: x [B, T, C] viewed as [B, T*C/W, W] (W divides T*C, W % C == 0) -> out,
// block_b records a block.
int ptbxl_zscore_wide(int device, const void* x, void* out, int B, int T, int C, int W,
                      int block_b, int in_bf16, int out_bf16, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (B <= 0 || T <= 0 || C <= 0 || W <= 0 || W % C || ((long)T * C) % W || block_b <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!in_bf16 && !out_bf16) err = dispatch_wide<float, float>(x, out, B, T, C, W, block_b, st);
  else if (!in_bf16)
    err = dispatch_wide<float, __nv_bfloat16>(x, out, B, T, C, W, block_b, st);
  else if (!out_bf16)
    err = dispatch_wide<__nv_bfloat16, float>(x, out, B, T, C, W, block_b, st);
  else err = dispatch_wide<__nv_bfloat16, __nv_bfloat16>(x, out, B, T, C, W, block_b, st);
  return (int)err;
}

const char* ptbxl_strerror(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
