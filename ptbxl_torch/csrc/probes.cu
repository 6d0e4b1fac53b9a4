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
// Bound on the H100: every probe moves at most ~3 MB, about a microsecond of
// bytes at 3.35 TB/s, and a kernel launched back to back in a CUDA graph costs
// about 2 us, so the data-movement probes are bound by the launch.  A call's
// time outside a graph is mostly the host's (tools/probe_dispatch.py: 13-20
// us of host work a launch), so the host path is kept short: every entry
// sets the device only when the caller's differs (ptbxl_ensure_device in
// hopper.cuh), and the Python side binds each entry once and passes the raw
// stream handle (ops/kernels/_build.py, Library).
//
// p1 (TN, tools/probe_mosaic.py:54) and p2 (NT, :71) are [2048, 256] x
// [256, 128] products in TF32: 134 MFLOP, 0.27 us at 495 TFLOP/s, and 3.3 MB,
// 0.98 us at 3.35 TB/s.  What bounds them on the card is each CTA's first
// read of its operands: 64 x 32 output tiles with all of K resident give 128
// CTAs of 96 KB each, 12 MB out of L2 in one round trip a CTA.  So the kernel
// (dot_wgmma_tf32_kernel) fills the card with one CTA an SM, puts every
// operand row in flight before it waits (bulk copies on mbarriers for
// K-major rows, cp.async for MN-major ones), rounds each element once
// (cvt.rna) on its way to wgmma (B through one pass into the core-matrix
// layout, A into register fragments), and runs the 32 k8 steps as two
// commit groups (not K in stages of scalar loads, each stage waiting out its
// own round trips).
// p7 (:153) copies 393,888 bytes (0.12 us) and is bound by its launch: each
// output row is one contiguous window of the input, copied as float4s by one
// warp, 128 CTAs (concat_kernel).  p9 (P2, HIGHEST) runs in full FP32 FMA
// (2.0 us at 67 TFLOP/s).
//
// Precision: p1 and p2 round their operands to TF32 (cvt.rna: nearest, ties
// away from zero) and sum in f32 on the tensor cores, the card's counterpart
// of the TPU's default product precision.
#include "hopper.cuh"

namespace {

constexpr int kThreads = 256;

// -- dots: C[M, N] = sum_k A(m, k) B(k, n), A(m, k) at a[m*sam + k*sak],
// B(k, n) at b[k*sbk + n*sbn] --------------------------------------------------

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// p1, p2: the TF32 dot on wgmma.  A CTA owns a kWM x kWN tile of C (one
// warpgroup, 128 threads) and holds all of its K in shared memory: 128 CTAs,
// one an SM, at the probes' shapes.  Every copy is issued before the first
// wait, B's before A's, by all the CTA's threads: a K-major row (K floats) by
// one 1-D bulk copy completing on an mbarrier (B's rows on one, A's on the
// other); an MN-major operand by 16-byte cp.async (B's in one commit group,
// A's in the next), because its k-rows are 128- and 256-byte pieces and each
// bulk copy holds its issuing thread ~20 cycles however small it is.  The
// landing rows are padded so that the passes below read shared memory
// without bank conflicts: K-major rows at K + 4 floats (A's at padded_k + 4),
// A's k-rows at kWM + 8; B's k-rows need none (a warp reads one k-row at a
// time).  What bounds the kernel is this landing: 96 KB a CTA, 12 MB for the
// card, at the L2's rate (~24 bytes a cycle an SM, by either copy path).
//
// B goes to wgmma from shared memory, and TF32 takes only K-major operands
// there, so one pass rounds each B element once (cvt.rna) and stores it in
// the no-swizzle core-matrix order bc[(k / 4) * 128 + n * 4 + k % 4]: a core
// matrix is 8 n x 16 bytes of k, 512 bytes lie between the two K halves of a
// k8 step (leading offset) and 128 between 8-column groups (stride offset).
// A goes from registers: each thread reads its own fragment elements (rows g
// and g + 8 of its warp's 16, columns t and t + 4 of each k8 step) from the
// landing rows and rounds them on the way, so each A element is read and
// rounded once and A needs no second pass through shared memory.  The k8
// steps go in chunks of kWSteps, one commit group and one wait each (K = 256:
// two chunks).  Nothing but the products stands between a chunk's fence and
// its commit: no branch, no select, no load into a register a product reads
// (ptxas then fences and serialises every wgmma of the kernel).  So K is
// padded with zeros to whole chunks, in A's landing rows and in B's core
// rows, and a chunk's fragments load only after the last chunk's wait.
constexpr int kWM = 64, kWN = 32, kWThreads = 128, kWSteps = 16;
constexpr int kAMStride = kWM + 8;  // A landed M-major: a k-row of 64 floats, padded

// K rounded up to whole chunks: A's landing rows and B's core-order rows
// hold zeros past K
__host__ __device__ __forceinline__ int padded_k(int K) {
  return (K + 8 * kWSteps - 1) / (8 * kWSteps) * (8 * kWSteps);
}

// Dynamic shared bytes: B in core order (padded_k(K) * kWN floats), A's
// landing rows (to padded_k(K)) and B's, two mbarriers.  ops/kernels/probes.py
// (dot_plan) computes the same.
size_t wgmma_dot_smem(int K, bool a_k, bool b_k) {
  const size_t kp = padded_k(K);
  const size_t a = a_k ? (size_t)kWM * (kp + 4) : kp * kAMStride;
  const size_t b = b_k ? (size_t)kWN * (K + 4) : (size_t)K * kWN;
  return 4 * (kp * kWN + a + b) + 16;
}

__device__ __forceinline__ void cp_async16_cg(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(dst)), "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>  // wait until at most N of this thread's cp.async groups are in flight
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// One chunk of kWSteps k8 steps from k0: once the last chunk's products are
// done, this thread's A fragments into af, then the products, one commit
// group.  No select and no branch touches an input of the products (past K
// the landing rows hold zeros, and step j's B descriptor is the chunk's plus
// j * 1 KB): ptxas serialises every wgmma of a kernel where one does.
template <bool kAK>
__device__ __forceinline__ void dot_chunk(float* acc, uint32_t (&af)[kWSteps][4], const float* al,
                                          int as, const float* bc, int k0, int r0, int t) {
  wg_wait<0>();
#pragma unroll
  for (int j = 0; j < kWSteps; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) pin(af[j][e]);
  auto a_at = [&](int r, int k) { return kAK ? al[(size_t)r * as + k] : al[(size_t)k * as + r]; };
#pragma unroll
  for (int j = 0; j < kWSteps; ++j) {
    const int k = k0 + 8 * j + t;
    af[j][0] = to_tf32(a_at(r0, k));
    af[j][1] = to_tf32(a_at(r0 + 8, k));
    af[j][2] = to_tf32(a_at(r0, k + 4));
    af[j][3] = to_tf32(a_at(r0 + 8, k + 4));
  }
  const uint64_t desc = b_desc(bc + (size_t)k0 * kWN, 512, 128);
  wg_fence();
#pragma unroll
  for (int j = 0; j < kWSteps; ++j) wgmma_tf32<32, 1>(acc, af[j], desc + 64 * j);
  wg_commit();
}

// kAK: A(m, k) at a[m*lda + k] (rows along K), else a[k*lda + m]; kBK: B(k, n)
// at b[n*ldb + k], else b[k*ldb + n].
template <bool kAK, bool kBK>
__global__ void __launch_bounds__(kWThreads, 1)
dot_wgmma_tf32_kernel(const float* __restrict__ a, const float* __restrict__ b,
                      float* __restrict__ c, int N, int K, long lda, long ldb) {
  extern __shared__ __align__(1024) unsigned char wsm[];
  const int kp = padded_k(K);
  float* bc = reinterpret_cast<float*>(wsm);  // B rounded, core-matrix order
  float* al = bc + (size_t)kp * kWN;          // A's landing rows
  const int as = kAK ? kp + 4 : kAMStride, arows = kAK ? kWM : kp;
  float* bl = al + (size_t)arows * as;  // B's landing rows
  const int bs = kBK ? K + 4 : kWN, brows = kBK ? kWN : K;
  uint64_t* bars = reinterpret_cast<uint64_t*>(bl + (size_t)brows * bs);  // B's, A's
  const int m0 = blockIdx.x * kWM, n0 = blockIdx.y * kWN;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  if (tid == 0) {
    mbar_init(&bars[0], 1);
    mbar_init(&bars[1], 1);
    fence_mbarrier_init();
    mbar_expect_tx(&bars[0], kBK ? kWN * K * 4 : 0);
    mbar_expect_tx(&bars[1], kAK ? kWM * K * 4 : 0);
  }
  for (int i = K * kWN + tid; i < kp * kWN; i += kWThreads) bc[i] = 0.f;  // zeros past K
  if (kAK) {
    for (int i = tid; i < kWM * (kp - K); i += kWThreads)
      al[(size_t)(i / (kp - K)) * as + K + i % (kp - K)] = 0.f;
  } else {
    for (int i = K * as + tid; i < kp * as; i += kWThreads) al[i] = 0.f;
  }
  __syncthreads();
  // every copy in flight before the first wait: B's, then A's
  if (kBK) {
    for (int r = tid; r < kWN; r += kWThreads)
      bulk_load(bl + (size_t)r * bs, b + (size_t)(n0 + r) * ldb, K * 4, &bars[0]);
  } else {
    for (int p = tid; p < K * (kWN / 4); p += kWThreads) {
      const int r = p / (kWN / 4), q = (p % (kWN / 4)) * 4;
      cp_async16_cg(bl + (size_t)r * bs + q, b + (size_t)r * ldb + n0 + q);
    }
  }
  cp_async_commit();
  if (kAK) {
    for (int r = tid; r < kWM; r += kWThreads)
      bulk_load(al + (size_t)r * as, a + (size_t)(m0 + r) * lda, K * 4, &bars[1]);
  } else {
    for (int p = tid; p < K * (kWM / 4); p += kWThreads) {
      const int r = p / (kWM / 4), q = (p % (kWM / 4)) * 4;
      cp_async16_cg(al + (size_t)r * as + q, a + (size_t)r * lda + m0 + q);
    }
  }
  cp_async_commit();

  // B, as soon as it has landed: lane n stores four consecutive k as 16
  // bytes; a warp takes every fourth k/4 group, four at a time
  mbar_wait(&bars[0], 0);
  cp_async_wait<1>();
  __syncthreads();
  for (int kc0 = warp; kc0 < K / 4; kc0 += 16) {
    float4 v[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int kc = kc0 + 4 * u;
      if (kc < K / 4) {
        if (kBK) {
          v[u] = *reinterpret_cast<const float4*>(bl + (size_t)lane * bs + 4 * kc);
        } else {
          const float* p = bl + (size_t)(4 * kc) * kWN + lane;
          v[u] = make_float4(p[0], p[kWN], p[2 * kWN], p[3 * kWN]);
        }
      }
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int kc = kc0 + 4 * u;
      if (kc < K / 4)
        *reinterpret_cast<uint4*>(bc + kc * 128 + lane * 4) =
            make_uint4(to_tf32(v[u].x), to_tf32(v[u].y), to_tf32(v[u].z), to_tf32(v[u].w));
    }
  }
  fence_proxy_async();
  mbar_wait(&bars[1], 0);
  cp_async_wait<0>();
  __syncthreads();

  const int g = lane >> 2, t = lane & 3, r0 = warp * 16 + g;
  float acc[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) acc[i] = 0.f;
  uint32_t af[kWSteps][4];
  for (int k0 = 0; k0 < K; k0 += 8 * kWSteps) dot_chunk<kAK>(acc, af, al, as, bc, k0, r0, t);
  wg_wait<0>();
#pragma unroll
  for (int i = 0; i < 16; ++i) pin(acc[i]);
#pragma unroll
  for (int j = 0; j < kWSteps; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) pin(af[j][e]);
  // acc[4i + 2h + e] is C(r0 + 8h, 8i + 2t + e) of the tile
#pragma unroll
  for (int i = 0; i < kWN / 8; ++i) {
    float* row = c + (size_t)(m0 + r0) * N + n0 + 8 * i + 2 * t;
    *reinterpret_cast<float2*>(row) = make_float2(acc[4 * i], acc[4 * i + 1]);
    *reinterpret_cast<float2*>(row + (size_t)8 * N) = make_float2(acc[4 * i + 2], acc[4 * i + 3]);
  }
}

template <bool kAK, bool kBK>
cudaError_t launch_wgmma_tf32(dim3 grid, size_t smem, cudaStream_t st, const float* a,
                              const float* b, float* c, int N, int K, long lda, long ldb) {
  cudaError_t err = cudaFuncSetAttribute(dot_wgmma_tf32_kernel<kAK, kBK>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dot_wgmma_tf32_kernel<kAK, kBK><<<grid, kWThreads, smem, st>>>(a, b, c, N, K, lda, ldb);
  return cudaGetLastError();
}

// p9: the same product in full FP32 FMA.  A block owns a 32 x 64 output tile
// (128 blocks for p9's 2048 x 128, one an SM) and two halves of 128 threads,
// each half one half of K and each thread 4 x 4 outputs from two float4 reads
// of shared memory a k; the halves' sums are added at the end (eight warps an
// SM hide the latencies four could not).  A half's K slices of 32 go through
// its own ring of four in shared memory, three in flight while one is used:
// by cp.async where the operand's contiguous axis is the tile's own (A along
// m, B along n: p9's TN form), else through registers.  Each output is the
// sum of two chains of fmaf over k in order.
constexpr int kFM = 32, kFN = 64, kFK = 32, kFStages = 4, kFHalf = 128, kFThreads = 2 * kFHalf;
constexpr int kFSlot = kFK * (kFM + kFN);                        // floats a ring slot
constexpr size_t kFSmem = (size_t)2 * kFStages * kFSlot * sizeof(float);  // 96 KB

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src));
}

// as[k][m] = A(m0 + m, k0 + k), bs[k][n] = B(k0 + k, n0 + n), by the 128
// threads of one half (lt its thread index)
template <bool kAm, bool kBn>
__device__ __forceinline__ void stage_fp32(float* as, float* bs, const float* __restrict__ a,
                                           const float* __restrict__ b, int m0, int n0, int k0,
                                           long sam, long sak, long sbk, long sbn, int lt) {
  if (kAm) {
    for (int i = lt; i < kFK * kFM / 4; i += kFHalf) {
      const int k = i / (kFM / 4), m = (i % (kFM / 4)) * 4;
      cp_async16(as + k * kFM + m, a + (m0 + m) + (long)(k0 + k) * sak);
    }
  } else {
    for (int i = lt; i < kFK * kFM; i += kFHalf) {
      const int m = i / kFK, k = i % kFK;  // k fastest: reads along the contiguous k
      as[k * kFM + m] = a[(long)(m0 + m) * sam + (long)(k0 + k) * sak];
    }
  }
  if (kBn) {
    for (int i = lt; i < kFK * kFN / 4; i += kFHalf) {
      const int k = i / (kFN / 4), n = (i % (kFN / 4)) * 4;
      cp_async16(bs + k * kFN + n, b + (long)(k0 + k) * sbk + (n0 + n));
    }
  } else {
    for (int i = lt; i < kFK * kFN; i += kFHalf) {
      const int n = i / kFK, k = i % kFK;
      bs[k * kFN + n] = b[(long)(k0 + k) * sbk + (long)(n0 + n) * sbn];
    }
  }
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void half_sync(int half) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(1 + half), "n"(kFHalf) : "memory");
}

template <bool kAm, bool kBn>
__global__ void __launch_bounds__(kFThreads)
dot_fp32_kernel(const float* __restrict__ a, const float* __restrict__ b, float* __restrict__ c,
                int N, int K, long sam, long sak, long sbk, long sbn) {
  extern __shared__ __align__(16) float fsm[];
  const int half = threadIdx.x / kFHalf, lt = threadIdx.x % kFHalf;
  float* ring = fsm + half * kFStages * kFSlot;  // slot s: A at s * kFSlot, B after it
  const int m0 = blockIdx.x * kFM, n0 = blockIdx.y * kFN;
  const int tm = (lt / 16) * 4, tn = (lt % 16) * 4;
  const int nk = K / kFK, nk0 = (nk + 1) / 2;
  const int k_lo = half ? nk0 : 0, n = half ? nk - nk0 : nk0;  // this half's K slices
  float acc[4][4] = {};
  for (int s = 0; s < kFStages - 1; ++s) {  // every stage commits a group, empty or not
    float* slot = ring + s * kFSlot;
    if (s < n)
      stage_fp32<kAm, kBn>(slot, slot + kFK * kFM, a, b, m0, n0, (k_lo + s) * kFK, sam, sak, sbk,
                           sbn, lt);
    else
      asm volatile("cp.async.commit_group;\n" ::);
  }
  for (int kt = 0; kt < n; ++kt) {
    const int ahead = kt + kFStages - 1;
    if (ahead < n) {
      float* slot = ring + (ahead % kFStages) * kFSlot;
      stage_fp32<kAm, kBn>(slot, slot + kFK * kFM, a, b, m0, n0, (k_lo + ahead) * kFK, sam, sak,
                           sbk, sbn, lt);
    } else {
      asm volatile("cp.async.commit_group;\n" ::);
    }
    asm volatile("cp.async.wait_group %0;\n" ::"n"(kFStages - 1));
    half_sync(half);
    const float* as = ring + (kt % kFStages) * kFSlot;
    const float* bs = as + kFK * kFM;
#pragma unroll
    for (int k = 0; k < kFK; ++k) {
      const float4 av = *reinterpret_cast<const float4*>(as + k * kFM + tm);
      const float4 bv = *reinterpret_cast<const float4*>(bs + k * kFN + tn);
      const float ar[4] = {av.x, av.y, av.z, av.w}, br[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(ar[i], br[j], acc[i][j]);
    }
    half_sync(half);  // this slot is refilled on the next iteration
  }
  __syncthreads();  // both halves are done with their rings
  float* red = fsm;  // [kFHalf][16]: the second half's sums
  if (half) {
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) red[lt * 16 + i * 4 + j] = acc[i][j];
  }
  __syncthreads();
  if (!half) {
#pragma unroll
    for (int i = 0; i < 4; ++i)
      *reinterpret_cast<float4*>(c + (long)(m0 + tm + i) * N + n0 + tn) =
          make_float4(acc[i][0] + red[lt * 16 + i * 4], acc[i][1] + red[lt * 16 + i * 4 + 1],
                      acc[i][2] + red[lt * 16 + i * 4 + 2], acc[i][3] + red[lt * 16 + i * 4 + 3]);
  }
}

template <bool kAm, bool kBn>
cudaError_t launch_fp32(dim3 grid, cudaStream_t st, const float* a, const float* b, float* c, int N,
                        int K, long sam, long sak, long sbk, long sbn) {
  cudaError_t err = cudaFuncSetAttribute(dot_fp32_kernel<kAm, kBn>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kFSmem);
  if (err != cudaSuccess) return err;
  dot_fp32_kernel<kAm, kBn><<<grid, kFThreads, kFSmem, st>>>(a, b, c, N, K, sam, sak, sbk, sbn);
  return cudaGetLastError();
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

// -- p7: out[t, k*C + c] = x[t + k, c] (x [To + KS - 1, C] -> [To, KS*C]).
// Output row t is the contiguous window x[t*C : (t + KS)*C], so the copy is
// out[t*W + j] = x[t*C + j] (W = KS*C): no index arithmetic beyond the row's
// base.  A warp a row, kCWarps rows a CTA (128 CTAs for the probe's To = 512);
// V is float4 where C % 4 == 0 and both bases are 16-byte aligned (the
// probe's C = 12: 45 float4s a row), else float; cv, wv are C and W in V's.
// x (25 KB for the probe) is read from device memory directly: each row is
// read by KS neighbouring warps, which find it in L1 or L2.
constexpr int kCWarps = 4;
template <typename V>
__global__ void __launch_bounds__(kCWarps * 32)
concat_kernel(const V* __restrict__ x, V* __restrict__ out, int To, int cv, int wv) {
  const int t = blockIdx.x * kCWarps + (threadIdx.x >> 5);
  if (t >= To) return;
  const V* src = x + (size_t)t * cv;
  V* dst = out + (size_t)t * wv;
  for (int j = threadIdx.x & 31; j < wv; j += 32) dst[j] = src[j];
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

// p1, p2 (tf32 = 1, wgmma) and p9 (tf32 = 0, FP32 FMA): c [M, N] = A @ B
// with A(m, k) at a[m*sam + k*sak] and B(k, n) at b[k*sbk + n*sbn].
// tf32: the launch plan of ops/kernels/probes.py (dot_plan): grid_m = M / 64,
// grid_n = N / 32, smem its dynamic shared bytes (<= 232448); K % 8 == 0, each
// operand contiguous along K or along M / N with a row stride % 4 == 0 and a
// 16-byte aligned base.  fp32: M % 64 == 0, N % 64 == 0, K % 32 == 0 (the plan
// arguments are not read).
int ptbxl_probe_dot(int device, const void* a, const void* b, void* c, int M, int N, int K,
                    long long sam, long long sak, long long sbk, long long sbn, int tf32,
                    int grid_m, int grid_n, long long smem, void* stream) {
  cudaError_t err = ptbxl_ensure_device(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* as = static_cast<const float*>(a);
  const float* bs = static_cast<const float*>(b);
  float* cs = static_cast<float*>(c);
  if (tf32) {
    const bool a_k = sak == 1, b_k = sbk == 1;
    const long long lda = a_k ? sam : sak, ldb = b_k ? sbn : sbk;
    if (M <= 0 || N <= 0 || K <= 0 || M % kWM || N % kWN || K % 8 || (!a_k && sam != 1) ||
        (!b_k && sbn != 1) || lda % 4 || ldb % 4 || ((uintptr_t)a | (uintptr_t)b) % 16 ||
        grid_m != M / kWM || grid_n != N / kWN || smem > 232448 ||
        (size_t)smem != wgmma_dot_smem(K, a_k, b_k))
      return (int)cudaErrorInvalidValue;
    auto launch = a_k ? (b_k ? launch_wgmma_tf32<true, true> : launch_wgmma_tf32<true, false>)
                      : (b_k ? launch_wgmma_tf32<false, true> : launch_wgmma_tf32<false, false>);
    return (int)launch(dim3(grid_m, grid_n), smem, st, as, bs, cs, N, K, lda, ldb);
  }
  if (M <= 0 || N <= 0 || K <= 0 || M % 64 || N % 64 || K % 32) return (int)cudaErrorInvalidValue;
  // cp.async needs 16-byte rows: the contiguous axis along the tile, 4-aligned strides
  const bool am = sam == 1 && sak % 4 == 0, bn = sbn == 1 && sbk % 4 == 0;
  const dim3 fgrid(M / kFM, N / kFN);
  if (am && bn) return (int)launch_fp32<true, true>(fgrid, st, as, bs, cs, N, K, sam, sak, sbk, sbn);
  if (am) return (int)launch_fp32<true, false>(fgrid, st, as, bs, cs, N, K, sam, sak, sbk, sbn);
  if (bn) return (int)launch_fp32<false, true>(fgrid, st, as, bs, cs, N, K, sam, sak, sbk, sbn);
  return (int)launch_fp32<false, false>(fgrid, st, as, bs, cs, N, K, sam, sak, sbk, sbn);
}

// p3, p3b: out [C, T] = roll(x, sl, axis=1) + roll(x, ss, axis=0)
int ptbxl_probe_roll_add(int device, const void* x, void* out, int C, int T, int sl, int ss,
                         void* stream) {
  cudaError_t err = ptbxl_ensure_device(device);
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
  cudaError_t err = ptbxl_ensure_device(device);
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
  cudaError_t err = ptbxl_ensure_device(device);
  if (err != cudaSuccess) return (int)err;
  if (R <= 0 || W <= 0 || (lane ? W % 2 : R % 2)) return (int)cudaErrorInvalidValue;
  const long n = (long)R * W / 2;
  pool_slices_kernel<<<grid_for(n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<float*>(y), R, W, lane);
  return (int)cudaGetLastError();
}

// p5b: max over axis 1 of x.reshape(R/2, 2, W)
int ptbxl_probe_pool_rows_reshape(int device, const void* x, void* y, int R, int W, void* stream) {
  cudaError_t err = ptbxl_ensure_device(device);
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
  cudaError_t err = ptbxl_ensure_device(device);
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
  cudaError_t err = ptbxl_ensure_device(device);
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
  cudaError_t err = ptbxl_ensure_device(device);
  if (err != cudaSuccess) return (int)err;
  if (To <= 0 || C <= 0 || KS <= 0) return (int)cudaErrorInvalidValue;
  const int grid = (To + kCWarps - 1) / kCWarps;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (C % 4 == 0 && ((uintptr_t)x | (uintptr_t)out) % 16 == 0)
    concat_kernel<float4><<<grid, kCWarps * 32, 0, st>>>(
        static_cast<const float4*>(x), static_cast<float4*>(out), To, C / 4, KS * C / 4);
  else
    concat_kernel<float><<<grid, kCWarps * 32, 0, st>>>(
        static_cast<const float*>(x), static_cast<float*>(out), To, C, KS * C);
  return (int)cudaGetLastError();
}

// p8: out [W, R] = x^T, x [R, W]
int ptbxl_probe_transpose(int device, const void* x, void* out, int R, int W, void* stream) {
  cudaError_t err = ptbxl_ensure_device(device);
  if (err != cudaSuccess) return (int)err;
  if (R <= 0 || W <= 0) return (int)cudaErrorInvalidValue;
  dim3 grid((W + 31) / 32, (R + 31) / 32);
  transpose_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<float*>(out), R, W);
  return (int)cudaGetLastError();
}

}  // extern "C"
