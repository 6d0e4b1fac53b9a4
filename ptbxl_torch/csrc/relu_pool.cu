// K6: the backward of relu -> MaxPool1d(2), hand-written for Hopper.
//
// Replaces ptbxl_tpu/ops/relu_pool.py: _bwd_kernel (:65), launched by
// _pallas_bwd (:94) from the custom VJP _relu_pool_pallas (:144) of
// relu_max_pool2 (:199).  Given the pre-activation h and the cotangent g of
// the pooled output, for every window (2t, 2t+1) of a row:
//   u = relu(h);  y = max(u[2t], u[2t+1]);  cnt = #{u == y}
//   dh[i] = (u[i] == y && h[i] > 0) ? g[t] / cnt : 0      (math in f32)
// so a tie at a positive value splits the cotangent evenly, and the last
// element of an odd row (never pooled) gets 0.  h, g and dh share one dtype,
// f32 or bf16.
//
// Layout: the port's activations are [B, C, T], so a window is two
// neighbouring elements of a row of length T; g is [B, C, T/2].
//
// Bound on the H100: bytes.  The function reads h and g once and writes dh
// once (a few comparisons a window): at B=64, f32, the four ECGCNN blocks
// ([64,32,5000], [64,64,2500], [64,128,1250], [64,256,625]) move ~1.6 MB a
// record each.  Design: elementwise, one thread a window, a grid-stride
// loop over the flat window index, scalar loads (neighbouring threads read
// neighbouring pairs, so a warp's loads stay coalesced).  A float2 load
// would only be aligned when T is even; vectorising, and fusing into the
// BatchNorm backward, is later work.  Nothing is saved from the forward
// but h: the window max is recomputed here, where torch's own max_pool1d
// backward keeps int64 argmax indices (twice the pooled output's f32 bytes).
#include <climits>

#include "hopper.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 16;  // two waves of 8 blocks on each of 132 SMs

__device__ __forceinline__ float load_f(const float* p, long i) { return p[i]; }
__device__ __forceinline__ float load_f(const __nv_bfloat16* p, long i) {
  return __bfloat162float(p[i]);
}
__device__ __forceinline__ void store_f(float* p, long i, float v) { p[i] = v; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, long i, float v) {
  p[i] = __float2bfloat16_rn(v);
}

// relu that keeps NaN, as jnp.maximum(h, 0) and torch.relu do
__device__ __forceinline__ float relu_keep_nan(float v) { return v < 0.f ? 0.f : v; }

// h [rows, T], g [rows, T/2] -> dh [rows, T]; rows = B * C.
template <typename Tv>
__global__ void relu_pool_bwd_kernel(const Tv* __restrict__ h, const Tv* __restrict__ g,
                                     Tv* __restrict__ dh, unsigned rows, unsigned T) {
  const unsigned U = T / 2;          // pooled length (floor)
  const unsigned W = (T + 1) / 2;    // windows a row, the odd tail's lone element included
  const unsigned total = rows * W;   // < 2^31, checked by the C entry
  for (unsigned w = blockIdx.x * blockDim.x + threadIdx.x; w < total;
       w += gridDim.x * blockDim.x) {
    const unsigned r = w / W;
    const unsigned j = w - r * W;
    const long base = (long)r * T + 2L * j;
    if (j == U) {  // odd T: the last element never pools
      store_f(dh, base, 0.f);
      continue;
    }
    const float h0 = load_f(h, base), h1 = load_f(h, base + 1);
    const float u0 = relu_keep_nan(h0), u1 = relu_keep_nan(h1);
    const float y = fmaxf(u0, u1);
    bool e0 = u0 == y, e1 = u1 == y;
    if (u0 != u0 || u1 != u1) e0 = e1 = false;  // a NaN makes the max NaN: nothing equals it
    const float s = load_f(g, (long)r * U + j) / fmaxf((float)(e0 + e1), 1.f);
    store_f(dh, base, (e0 && h0 > 0.f) ? s : 0.f);
    store_f(dh, base + 1, (e1 && h1 > 0.f) ? s : 0.f);
  }
}

template <typename Tv>
void launch(const void* h, const void* g, void* dh, int rows, int T, cudaStream_t st) {
  const long total = (long)rows * ((T + 1) / 2);
  const long want = (total + kThreads - 1) / kThreads;
  const int blocks = (int)(want < kMaxBlocks ? want : kMaxBlocks);
  relu_pool_bwd_kernel<Tv><<<blocks, kThreads, 0, st>>>(
      static_cast<const Tv*>(h), static_cast<const Tv*>(g), static_cast<Tv*>(dh),
      (unsigned)rows, (unsigned)T);
}

}  // namespace

extern "C" {

// h [rows, T], g [rows, T/2] -> dh [rows, T], all bf16 when bf16 else f32;
// rows = B * C of a [B, C, T] activation.
int ptbxl_relu_pool_bwd(int device, const void* h, const void* g, void* dh, int rows, int T,
                        int bf16, void* stream) {
  cudaError_t err = ptbxl_ensure_device(device);
  if (err != cudaSuccess) return (int)err;
  if (rows <= 0 || T <= 0 || (long)rows * ((T + 1) / 2) > INT_MAX)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16) launch<__nv_bfloat16>(h, g, dh, rows, T, st);
  else launch<float>(h, g, dh, rows, T, st);
  return (int)cudaGetLastError();
}

}  // extern "C"
