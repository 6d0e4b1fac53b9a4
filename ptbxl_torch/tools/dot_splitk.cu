// A variant of P1's TF32 dot (p1, p2), measured beside the shipped kernel by
// ptbxl_torch/tools/tune_dot.py; built by that tool alone, from this file and
// the kernel source it includes.
//
// The shipped kernel lands 96 KB of operands in each of 128 CTAs, so what it
// costs is that landing.  Here the four CTAs of a cluster share one 64 x 128
// tile of C and split K between them: rank r multiplies A[:, r*K/4 ..] by the
// matching rows of B (16 + 32 KB at the probes' shapes), so each CTA lands
// half the bytes and A leaves L2 once, not four times.  Each rank then holds
// a 64 x 128 partial sum.  Rank q owns columns 32q .. 32q + 31 of the tile:
// every rank writes that quarter of its partial into rank q's shared memory
// (slot r, distributed shared memory), and rank q adds the four slots in rank
// order and stores its 64 x 32 quarter.  The slots reuse the landing buffers,
// free once the fragments are in registers: a cluster barrier stands between
// the last read of a CTA's landing rows and the first write into them.
//
// Operands land by 16-byte cp.async (a K-major row's share of K is 256 bytes,
// too small for bulk copies), B is rounded into the core-matrix order for
// N = 128 (leading offset 2 KB, stride 128 bytes), A's fragments go from
// registers, and the products are m64n128k8, the rank's eight k8 steps one
// commit group (K = 256 only: a loop that carries 64 accumulators makes ptxas
// serialise the products).
// The rounding (cvt.rna) and the f32 sums are the shipped kernel's; the sum
// over K is four partial sums added in rank order.

#include "../csrc/probes.cu"

namespace {

constexpr int kSM = 64, kSN = 128, kSRanks = 4, kSThreads = 128, kSSteps = 8;
constexpr int kSSlot = 40;  // row stride of an exchange slot (floats): 64 x 32 of a quarter

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}
// two floats into the shared memory of cluster rank `rank`, at p's offset
__device__ __forceinline__ void st_remote2(float* p, uint32_t rank, float x, float y) {
  uint32_t addr;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(addr) : "r"(smem_u32(p)), "r"(rank));
  asm volatile("st.shared::cluster.v2.f32 [%0], {%1, %2};\n" ::"r"(addr), "f"(x), "f"(y) : "memory");
}

// Dynamic shared bytes for a rank's share Kr of K (64): B in core
// order (Kr x 128), A's and B's landing rows (reused by the exchange slots).
size_t splitk_smem(int Kr, bool a_k, bool b_k) {
  const size_t a = a_k ? (size_t)kSM * (Kr + 4) : (size_t)Kr * kAMStride;
  const size_t b = b_k ? (size_t)kSN * (Kr + 4) : (size_t)Kr * kSN;
  const size_t land = a + b > (size_t)kSRanks * kSM * kSSlot ? a + b : (size_t)kSRanks * kSM * kSSlot;
  return 4 * ((size_t)Kr * kSN + land);
}

// grid (4, N / 128, M / 64) in clusters of 4 along x: rank = blockIdx.x
template <bool kAK, bool kBK>
__global__ void __launch_bounds__(kSThreads, 1)
dot_splitk_kernel(const float* __restrict__ a, const float* __restrict__ b, float* __restrict__ c,
                  int N, int K, long lda, long ldb) {
  extern __shared__ __align__(1024) unsigned char ssm[];
  const int Kr = K / kSRanks;
  float* bc = reinterpret_cast<float*>(ssm);  // B rounded, core order for N = 128
  float* al = bc + (size_t)Kr * kSN;
  const int as = kAK ? Kr + 4 : kAMStride;
  float* bl = al + (size_t)(kAK ? kSM : Kr) * as;
  const int bs = kBK ? Kr + 4 : kSN;
  float* slots = al;  // [4][64][kSSlot], after the landing rows are dead
  const int rank = (int)cluster_rank(), k0 = rank * Kr;
  const int n0 = blockIdx.y * kSN, m0 = blockIdx.z * kSM;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  // B's share, then A's, by cp.async
  if (kBK) {
    for (int r = warp; r < kSN; r += 4)
      for (int q = 4 * lane; q < Kr; q += 128)
        cp_async16_cg(bl + (size_t)r * bs + q, b + (size_t)(n0 + r) * ldb + k0 + q);
  } else {
    for (int p = tid; p < Kr * (kSN / 4); p += kSThreads) {
      const int r = p >> 5, q = (p & 31) * 4;
      cp_async16_cg(bl + (size_t)r * bs + q, b + (size_t)(k0 + r) * ldb + n0 + q);
    }
  }
  cp_async_commit();
  if (kAK) {
    for (int r = warp; r < kSM; r += 4)
      for (int q = 4 * lane; q < Kr; q += 128)
        cp_async16_cg(al + (size_t)r * as + q, a + (size_t)(m0 + r) * lda + k0 + q);
  } else {
    for (int p = tid; p < Kr * (kSM / 4); p += kSThreads) {
      const int r = p >> 4, q = (p & 15) * 4;
      cp_async16_cg(al + (size_t)r * as + q, a + (size_t)(k0 + r) * lda + m0 + q);
    }
  }
  cp_async_commit();
  cp_async_wait<1>();
  __syncthreads();
  // B: bc[(k / 4) * 512 + n * 4 + k % 4]
  for (int kc = warp; kc < Kr / 4; kc += 4) {
    float4 v[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int n = lane + 32 * u;
      if (kBK) {
        v[u] = *reinterpret_cast<const float4*>(bl + (size_t)n * bs + 4 * kc);
      } else {
        const float* p = bl + (size_t)(4 * kc) * kSN + n;
        v[u] = make_float4(p[0], p[kSN], p[2 * kSN], p[3 * kSN]);
      }
    }
#pragma unroll
    for (int u = 0; u < 4; ++u)
      *reinterpret_cast<uint4*>(bc + kc * 512 + (lane + 32 * u) * 4) =
          make_uint4(to_tf32(v[u].x), to_tf32(v[u].y), to_tf32(v[u].z), to_tf32(v[u].w));
  }
  fence_proxy_async();
  cp_async_wait<0>();
  __syncthreads();

  const int g = lane >> 2, t = lane & 3, r0 = warp * 16 + g;
  auto a_at = [&](int r, int k) { return kAK ? al[(size_t)r * as + k] : al[(size_t)k * as + r]; };
  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  uint32_t af[kSSteps][4];  // the rank's share of K is one chunk: no loop carries acc
#pragma unroll
  for (int j = 0; j < kSSteps; ++j) {
    const int k = 8 * j + t;
    af[j][0] = to_tf32(a_at(r0, k));
    af[j][1] = to_tf32(a_at(r0 + 8, k));
    af[j][2] = to_tf32(a_at(r0, k + 4));
    af[j][3] = to_tf32(a_at(r0 + 8, k + 4));
  }
  const uint64_t desc = b_desc(bc, 2048, 128);
  wg_fence();
#pragma unroll
  for (int j = 0; j < kSSteps; ++j) wgmma_tf32<128, 1>(acc, af[j], desc + 256 * j);
  wg_commit();
  cluster_arrive();  // this CTA's landing rows are read: peers may write its slots
  wg_wait<0>();
#pragma unroll
  for (int i = 0; i < 64; ++i) pin(acc[i]);
#pragma unroll
  for (int j = 0; j < kSSteps; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) pin(af[j][e]);
  cluster_wait();
  // quarter q of the partial (acc[16q .. 16q + 15]) into rank q's slot `rank`
#pragma unroll
  for (int q = 0; q < kSRanks; ++q)
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float* p = slots + ((size_t)rank * kSM + r0 + 8 * h) * kSSlot + 8 * i + 2 * t;
        st_remote2(p, (uint32_t)q, acc[16 * q + 4 * i + 2 * h], acc[16 * q + 4 * i + 2 * h + 1]);
      }
  cluster_arrive();
  cluster_wait();
  // this rank's quarter: the four slots in rank order
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const size_t off = (size_t)(r0 + 8 * h) * kSSlot + 8 * i + 2 * t;
      float2 s = *reinterpret_cast<const float2*>(slots + off);
#pragma unroll
      for (int r = 1; r < kSRanks; ++r) {
        const float2 v = *reinterpret_cast<const float2*>(slots + (size_t)r * kSM * kSSlot + off);
        s.x += v.x;
        s.y += v.y;
      }
      *reinterpret_cast<float2*>(c + (size_t)(m0 + r0 + 8 * h) * N + n0 + 32 * rank + 8 * i +
                                 2 * t) = s;
    }
}

template <bool kAK, bool kBK>
cudaError_t launch_splitk(int M, int N, int K, size_t smem, cudaStream_t st, const float* a,
                          const float* b, float* c, long lda, long ldb) {
  auto fn = dot_splitk_kernel<kAK, kBK>;
  cudaError_t err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kSRanks;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(kSRanks, N / kSN, M / kSM);
  cfg.blockDim = dim3(kSThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, fn, a, b, c, N, K, lda, ldb);
  const cudaError_t last = cudaGetLastError();
  return err != cudaSuccess ? err : last;
}

}  // namespace

extern "C" {

// The split-K variant of ptbxl_probe_dot's TF32 path: the same arguments but
// the plan; M % 64 == 0, N % 128 == 0, K == 256 (one chunk of k8 steps a
// rank), 16-byte aligned operands.
// *smem_out gets the dynamic shared bytes a CTA.
int ptbxl_probe_dot_splitk(int device, const void* a, const void* b, void* c, int M, int N,
                           int K, long long sam, long long sak, long long sbk, long long sbn,
                           long long* smem_out, void* stream) {
  cudaError_t err = ptbxl_ensure_device(device);
  if (err != cudaSuccess) return (int)err;
  const bool a_k = sak == 1, b_k = sbk == 1;
  const long long lda = a_k ? sam : sak, ldb = b_k ? sbn : sbk;
  if (M <= 0 || N <= 0 || M % kSM || N % kSN || K != kSRanks * 8 * kSSteps ||
      (!a_k && sam != 1) || (!b_k && sbn != 1) || lda % 4 || ldb % 4 ||
      ((uintptr_t)a | (uintptr_t)b) % 16)
    return (int)cudaErrorInvalidValue;
  const size_t smem = splitk_smem(K / kSRanks, a_k, b_k);
  *smem_out = (long long)smem;
  if (smem > 232448) return (int)cudaErrorInvalidValue;
  auto launch = a_k ? (b_k ? launch_splitk<true, true> : launch_splitk<true, false>)
                    : (b_k ? launch_splitk<false, true> : launch_splitk<false, false>);
  return (int)launch(M, N, K, smem, static_cast<cudaStream_t>(stream), static_cast<const float*>(a),
                     static_cast<const float*>(b), static_cast<float*>(c), lda, ldb);
}

// How many clusters of the variant the card holds at once (the probes need 32)
int ptbxl_probe_dot_splitk_clusters(int a_k, int b_k, long long smem, int* clusters) {
  auto fn = a_k ? (b_k ? dot_splitk_kernel<true, true> : dot_splitk_kernel<true, false>)
                : (b_k ? dot_splitk_kernel<false, true> : dot_splitk_kernel<false, false>);
  cudaError_t err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kSRanks;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(kSRanks, 1, 1);
  cfg.blockDim = dim3(kSThreads);
  cfg.dynamicSmemBytes = (size_t)smem;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return (int)cudaOccupancyMaxActiveClusters(clusters, fn, &cfg);
}

}  // extern "C"
