// P1 and P2: the capability probes of tools/probe_mosaic.py (_call, :44; probes
// p1-p8) and tools/probe_mosaic2.py (_call, :35; probes p3b, p5b, p5b2, p5c,
// p9), one small kernel per probe, hand-written for Hopper.
//
// On the TPU each probe is one pallas_call with the whole arrays in VMEM and
// asks whether Mosaic lowers an operation (a TN or NT dot, a roll, a strided or
// unaligned slice, a concat, a transpose) and at what cost.  On the card the
// same operations are plain data movement or one small product, so each
// kernel answers the H100's version of the question: what the operation costs
// when it is written directly.  TPU terms map as: lanes -> the contiguous last
// axis, sublanes -> the axis before it, VMEM -> shared memory.  A kernel stages
// its input in shared memory where a block's share fits (a row, a tile, the
// rows a window needs) and writes its result.
//
// Bound on the H100: every probe moves at most ~3 MB, so each is bound by its
// bytes at 3.35 TB/s (about a microsecond) and in practice by the launch
// itself; the dots are 134 MFLOP (0.27 us at 495 TFLOP/s TF32, 2.0 us at
// 67 TFLOP/s FP32, which bounds p9).
//
// Precision: p1 and p2 run on the tensor cores in TF32 (operands rounded by
// cvt.rna.tf32, mma.sync m16n8k8, f32 sums), the card's counterpart of the
// TPU's default product precision; p9 (HIGHEST) runs in full FP32 FMA.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

// -- dots: C[M, N] = sum_k A(m, k) B(k, n), A(m, k) at a[m*sam + k*sak],
// B(k, n) at b[k*sbk + n*sbn] --------------------------------------------------
constexpr int kDM = 64, kDN = 64, kDK = 32, kDThreads = 128;
constexpr int kAS = kDK + 4;  // padded shared row strides (bank spread)
constexpr int kBS = kDN + 8;

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// d += a (16x8, row) * b (8x8, col): tf32 operands, f32 sums
__device__ __forceinline__ void mma_tf32(float* d, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// the [kDM, kDK] slice of A and the [kDK, kDN] slice of B into shared memory,
// the contiguous axis fastest so that the reads coalesce
__device__ __forceinline__ void stage_dot(float* as, float* bs, const float* __restrict__ a,
                                          const float* __restrict__ b, int m0, int n0, int k0,
                                          long sam, long sak, long sbk, long sbn) {
  for (int i = threadIdx.x; i < kDM * kDK; i += kDThreads) {
    int m, k;
    if (sam == 1) { m = i % kDM; k = i / kDM; } else { k = i % kDK; m = i / kDK; }
    as[m * kAS + k] = a[(m0 + m) * sam + (k0 + k) * sak];
  }
  for (int i = threadIdx.x; i < kDK * kDN; i += kDThreads) {
    int k, n;
    if (sbn == 1) { n = i % kDN; k = i / kDN; } else { k = i % kDK; n = i / kDK; }
    bs[k * kBS + n] = b[(k0 + k) * sbk + (n0 + n) * sbn];
  }
}

// p1, p2: a 64 x 64 output tile a block, four warps of 32 x 32, each warp
// 2 x 4 mma tiles of 16 x 8
__global__ void __launch_bounds__(kDThreads)
dot_tf32_kernel(const float* __restrict__ a, const float* __restrict__ b, float* __restrict__ c,
                int N, int K, long sam, long sak, long sbk, long sbn) {
  __shared__ float as[kDM * kAS];
  __shared__ float bs[kDK * kBS];
  const int m0 = blockIdx.x * kDM, n0 = blockIdx.y * kDN;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = (warp % 2) * 32, wn = (warp / 2) * 32;
  const int g = lane >> 2, t = lane & 3;
  float acc[2][4][4] = {};
  for (int k0 = 0; k0 < K; k0 += kDK) {
    __syncthreads();
    stage_dot(as, bs, a, b, m0, n0, k0, sam, sak, sbk, sbn);
    __syncthreads();
#pragma unroll
    for (int ks = 0; ks < kDK; ks += 8) {
      uint32_t af[2][4], bf[4][2];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const float* r0 = as + (wm + mt * 16 + g) * kAS + ks + t;
        af[mt][0] = to_tf32(r0[0]);
        af[mt][1] = to_tf32(r0[8 * kAS]);
        af[mt][2] = to_tf32(r0[4]);
        af[mt][3] = to_tf32(r0[8 * kAS + 4]);
      }
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const float* c0 = bs + (ks + t) * kBS + wn + nt * 8 + g;
        bf[nt][0] = to_tf32(c0[0]);
        bf[nt][1] = to_tf32(c0[4 * kBS]);
      }
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) mma_tf32(acc[mt][nt], af[mt], bf[nt]);
    }
  }
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const int row = m0 + wm + mt * 16 + g, col = n0 + wn + nt * 8 + 2 * t;
      *reinterpret_cast<float2*>(c + (long)row * N + col) = make_float2(acc[mt][nt][0], acc[mt][nt][1]);
      *reinterpret_cast<float2*>(c + (long)(row + 8) * N + col) =
          make_float2(acc[mt][nt][2], acc[mt][nt][3]);
    }
}

// p9: the same product in full FP32 FMA; each thread owns 4 rows x 8 columns
__global__ void __launch_bounds__(kDThreads)
dot_fp32_kernel(const float* __restrict__ a, const float* __restrict__ b, float* __restrict__ c,
                int N, int K, long sam, long sak, long sbk, long sbn) {
  __shared__ float as[kDM * kAS];
  __shared__ float bs[kDK * kBS];
  const int m0 = blockIdx.x * kDM, n0 = blockIdx.y * kDN;
  const int tx = threadIdx.x % 8, ty = threadIdx.x / 8;  // 8 x 16 threads
  float acc[4][8] = {};
  for (int k0 = 0; k0 < K; k0 += kDK) {
    __syncthreads();
    stage_dot(as, bs, a, b, m0, n0, k0, sam, sak, sbk, sbn);
    __syncthreads();
#pragma unroll 8
    for (int k = 0; k < kDK; ++k) {
      float av[4], bv[8];
#pragma unroll
      for (int i = 0; i < 4; ++i) av[i] = as[(ty * 4 + i) * kAS + k];
#pragma unroll
      for (int j = 0; j < 8; ++j) bv[j] = bs[k * kBS + tx * 8 + j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; j += 4)
      *reinterpret_cast<float4*>(c + (long)(m0 + ty * 4 + i) * N + n0 + tx * 8 + j) =
          make_float4(acc[i][j], acc[i][j + 1], acc[i][j + 2], acc[i][j + 3]);
}

// -- p3, p3b: out[c, t] = x[c, (t - sl) mod T] + x[(c - ss) mod C, t]; a block
// a row, row c staged in shared memory ----------------------------------------
__global__ void __launch_bounds__(kThreads)
roll_add_kernel(const float* __restrict__ x, float* __restrict__ out, int C, int T, int sl,
                int ss) {
  extern __shared__ float row[];
  const int c = blockIdx.x;
  const float* xr = x + (long)c * T;
  for (int t = threadIdx.x; t < T; t += kThreads) row[t] = xr[t];
  __syncthreads();
  const float* xs = x + (long)((c - ss + C) % C) * T;
  for (int t = threadIdx.x; t < T; t += kThreads) {
    int src = t - sl;
    if (src < 0) src += T;
    out[(long)c * T + t] = row[src] + xs[t];
  }
}

// -- p4: out[k*C + c, t] = x[c, (t + k) mod T], k < KS; a block a row ------------
__global__ void __launch_bounds__(kThreads)
subblock_kernel(const float* __restrict__ x, float* __restrict__ out, int C, int T, int KS) {
  extern __shared__ float row[];
  const int c = blockIdx.x;
  for (int t = threadIdx.x; t < T; t += kThreads) row[t] = x[(long)c * T + t];
  __syncthreads();
  for (int k = 0; k < KS; ++k) {
    float* o = out + ((long)k * C + c) * T;
    for (int t = threadIdx.x; t < T; t += kThreads) {
      int src = t + k;
      if (src >= T) src -= T;
      o[t] = row[src];
    }
  }
}

// -- p5, p5b2 (strided slices): y = max(x[0::2], x[1::2]) along rows (lane=0,
// x [R, W] -> [R/2, W]) or along columns (lane=1, -> [R, W/2]), two strided
// reads an output ------------------------------------------------------------
__global__ void __launch_bounds__(kThreads)
pool_slices_kernel(const float* __restrict__ x, float* __restrict__ y, int R, int W, int lane) {
  const long n = lane ? (long)R * (W / 2) : (long)(R / 2) * W;
  for (long i = blockIdx.x * (long)kThreads + threadIdx.x; i < n; i += (long)gridDim.x * kThreads) {
    float a, b;
    if (lane) {
      const long r = i / (W / 2), c = i % (W / 2);
      a = x[r * W + 2 * c];
      b = x[r * W + 2 * c + 1];
    } else {
      const long r = i / W, c = i % W;
      a = x[2 * r * W + c];
      b = x[(2 * r + 1) * W + c];
    }
    y[i] = fmaxf(a, b);
  }
}

// -- p5b (pool by reshape [R/2, 2, W]): a block a pooled row, its contiguous
// [2, W] slab staged in shared memory -------------------------------------------
__global__ void __launch_bounds__(kThreads)
pool_rows_reshape_kernel(const float* __restrict__ x, float* __restrict__ y, int W) {
  extern __shared__ float slab[];
  const int r = blockIdx.x;
  const float* xr = x + (long)r * 2 * W;
  for (int i = threadIdx.x; i < 2 * W; i += kThreads) slab[i] = xr[i];
  __syncthreads();
  for (int c = threadIdx.x; c < W; c += kThreads) y[(long)r * W + c] = fmaxf(slab[c], slab[W + c]);
}

// -- p5c (pool by reshape [R, W/2, 2]): each output reads its pair as one float2
__global__ void __launch_bounds__(kThreads)
pool_lanes_reshape_kernel(const float2* __restrict__ x, float* __restrict__ y, long n) {
  for (long i = blockIdx.x * (long)kThreads + threadIdx.x; i < n; i += (long)gridDim.x * kThreads) {
    const float2 v = x[i];
    y[i] = fmaxf(v.x, v.y);
  }
}

// -- p6: out[c, w] = sum_{k < KS} x[c, k + w], w < Wo, in k order; a block a row
__global__ void __launch_bounds__(kThreads)
window_sum_kernel(const float* __restrict__ x, float* __restrict__ out, int T, int Wo, int KS) {
  extern __shared__ float row[];
  const int c = blockIdx.x;
  for (int t = threadIdx.x; t < T; t += kThreads) row[t] = x[(long)c * T + t];
  __syncthreads();
  for (int w = threadIdx.x; w < Wo; w += kThreads) {
    float acc = 0.f;
    for (int k = 0; k < KS; ++k) acc += row[w + k];
    out[(long)c * Wo + w] = acc;
  }
}

// -- p7: out[t, k*C + c] = x[t + k, c] (x [To + KS - 1, C] -> [To, KS*C]); a
// block a tile of kCR output rows, the kCR + KS - 1 input rows it reads staged
constexpr int kCR = 32;
__global__ void __launch_bounds__(kThreads)
concat_kernel(const float* __restrict__ x, float* __restrict__ out, int To, int C, int KS) {
  extern __shared__ float tile[];
  const int t0 = blockIdx.x * kCR;
  const int rows = min(kCR, To - t0) + KS - 1;
  for (int i = threadIdx.x; i < rows * C; i += kThreads) tile[i] = x[(long)t0 * C + i];
  __syncthreads();
  const int wide = KS * C;
  for (int i = threadIdx.x; i < min(kCR, To - t0) * wide; i += kThreads) {
    const int r = i / wide, j = i % wide;
    const int k = j / C, c = j % C;
    out[(long)(t0 + r) * wide + j] = tile[(r + k) * C + c];
  }
}

// -- p8: out = x^T through a 32 x 33 shared tile (x [R, W] -> [W, R]) ---------------
__global__ void __launch_bounds__(kThreads)
transpose_kernel(const float* __restrict__ x, float* __restrict__ out, int R, int W) {
  __shared__ float tile[32][33];
  const int r0 = blockIdx.y * 32, c0 = blockIdx.x * 32;
  const int tx = threadIdx.x % 32, ty = threadIdx.x / 32;  // 32 x 8
  for (int j = ty; j < 32; j += 8)
    if (r0 + j < R && c0 + tx < W) tile[j][tx] = x[(long)(r0 + j) * W + c0 + tx];
  __syncthreads();
  for (int j = ty; j < 32; j += 8)
    if (c0 + j < W && r0 + tx < R) out[(long)(c0 + j) * R + r0 + tx] = tile[tx][j];
}

int grid_for(long n) {
  const long g = (n + kThreads - 1) / kThreads;
  return (int)(g < 4096 ? (g > 0 ? g : 1) : 4096);
}

cudaError_t with_smem(const void* kernel, size_t bytes) {
  if (bytes > 232448) return cudaErrorInvalidValue;
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

}  // namespace

extern "C" {

// p1, p2 (tf32 = 1, tensor cores) and p9 (tf32 = 0, FP32 FMA): c [M, N] =
// A @ B with A(m, k) at a[m*sam + k*sak] and B(k, n) at b[k*sbk + n*sbn].
// M % 64 == 0, N % 64 == 0, K % 32 == 0.
int ptbxl_probe_dot(int device, const void* a, const void* b, void* c, int M, int N, int K,
                    long long sam, long long sak, long long sbk, long long sbn, int tf32,
                    void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (M <= 0 || N <= 0 || K <= 0 || M % kDM || N % kDN || K % kDK) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  dim3 grid(M / kDM, N / kDN);
  const float* as = static_cast<const float*>(a);
  const float* bs = static_cast<const float*>(b);
  float* cs = static_cast<float*>(c);
  if (tf32)
    dot_tf32_kernel<<<grid, kDThreads, 0, st>>>(as, bs, cs, N, K, sam, sak, sbk, sbn);
  else
    dot_fp32_kernel<<<grid, kDThreads, 0, st>>>(as, bs, cs, N, K, sam, sak, sbk, sbn);
  return (int)cudaGetLastError();
}

// p3, p3b: out [C, T] = roll(x, sl, axis=1) + roll(x, ss, axis=0)
int ptbxl_probe_roll_add(int device, const void* x, void* out, int C, int T, int sl, int ss,
                         void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (C <= 0 || T <= 0) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)T * 4;
  if ((err = with_smem((const void*)roll_add_kernel, smem)) != cudaSuccess) return (int)err;
  sl = ((sl % T) + T) % T;
  ss = ((ss % C) + C) % C;
  roll_add_kernel<<<C, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<float*>(out), C, T, sl, ss);
  return (int)cudaGetLastError();
}

// p4: out [KS*C, T], block k = roll(x, -k, axis=1)
int ptbxl_probe_subblock(int device, const void* x, void* out, int C, int T, int KS,
                         void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (C <= 0 || T <= 0 || KS <= 0 || KS > T) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)T * 4;
  if ((err = with_smem((const void*)subblock_kernel, smem)) != cudaSuccess) return (int)err;
  subblock_kernel<<<C, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<float*>(out), C, T, KS);
  return (int)cudaGetLastError();
}

// p5, p5b2: max of stride-2 slices, along rows (lane = 0) or columns (lane = 1)
int ptbxl_probe_pool_slices(int device, const void* x, void* y, int R, int W, int lane,
                            void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (R <= 0 || W <= 0 || (lane ? W % 2 : R % 2)) return (int)cudaErrorInvalidValue;
  const long n = (long)R * W / 2;
  pool_slices_kernel<<<grid_for(n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<float*>(y), R, W, lane);
  return (int)cudaGetLastError();
}

// p5b: max over axis 1 of x.reshape(R/2, 2, W)
int ptbxl_probe_pool_rows_reshape(int device, const void* x, void* y, int R, int W, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (R <= 0 || W <= 0 || R % 2) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)2 * W * 4;
  if ((err = with_smem((const void*)pool_rows_reshape_kernel, smem)) != cudaSuccess) return (int)err;
  pool_rows_reshape_kernel<<<R / 2, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<float*>(y), W);
  return (int)cudaGetLastError();
}

// p5c: max over axis 2 of x.reshape(R, W/2, 2)
int ptbxl_probe_pool_lanes_reshape(int device, const void* x, void* y, int R, int W,
                                   void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (R <= 0 || W <= 0 || W % 2) return (int)cudaErrorInvalidValue;
  const long n = (long)R * W / 2;
  pool_lanes_reshape_kernel<<<grid_for(n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float2*>(x), static_cast<float*>(y), n);
  return (int)cudaGetLastError();
}

// p6: out [C, Wo] = sum_{k < KS} x[:, k : k + Wo]; Wo + KS - 1 <= T
int ptbxl_probe_window_sum(int device, const void* x, void* out, int C, int T, int Wo, int KS,
                           void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (C <= 0 || Wo <= 0 || KS <= 0 || Wo + KS - 1 > T) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)T * 4;
  if ((err = with_smem((const void*)window_sum_kernel, smem)) != cudaSuccess) return (int)err;
  window_sum_kernel<<<C, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<float*>(out), T, Wo, KS);
  return (int)cudaGetLastError();
}

// p7: out [To, KS*C] = concat_k x[k : k + To] along columns; x [To + KS - 1, C]
int ptbxl_probe_concat(int device, const void* x, void* out, int To, int C, int KS, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (To <= 0 || C <= 0 || KS <= 0) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)(kCR + KS - 1) * C * 4;
  if ((err = with_smem((const void*)concat_kernel, smem)) != cudaSuccess) return (int)err;
  concat_kernel<<<(To + kCR - 1) / kCR, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<float*>(out), To, C, KS);
  return (int)cudaGetLastError();
}

// p8: out [W, R] = x^T, x [R, W]
int ptbxl_probe_transpose(int device, const void* x, void* out, int R, int W, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (R <= 0 || W <= 0) return (int)cudaErrorInvalidValue;
  dim3 grid((W + 31) / 32, (R + 31) / 32);
  transpose_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<float*>(out), R, W);
  return (int)cudaGetLastError();
}

const char* ptbxl_strerror(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
