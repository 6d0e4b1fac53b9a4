// K1 and K5: per-lead z-score of a channels-last batch, hand-written for Hopper.
//
// K1 replaces ptbxl_tpu/ops/pallas/zscore.py: zscore_tile (:44), _zscore_kernel
// (:59) and zscore_pallas (:64).  K5 replaces _zscore_wide_kernel (:82) and
// zscore_pallas_wide (:107).  For every (record, lead) over time:
//   mean = sum(x) / T;  var = sum((x - mean)^2) / T  (two passes, f32 moments)
//   out  = (x - mean) / (sqrt(var) + 1e-6)           in the output dtype
// ptbxl_zscore writes the normalized [B, T, C] tensor (f32 or bf16 in and
// out); ptbxl_zscore_stats writes only [B, C, 2] = (mean, std + eps), which
// the fused ECGCNN forward and K4 apply while they load block 0;
// ptbxl_zscore_wide (K5) is the same function with the TPU kernel's `width`
// and `block_b` (below).
//
// Bound on the H100: bytes.  The function reads the input once and writes the
// output once (3.35 TB/s); its arithmetic is a few operations per element.
// Design: each record is read from device memory exactly once and stays in
// shared memory, split over the k CTAs of one thread-block cluster.  Rank r
// owns the rows [r * piece_rows, (r + 1) * piece_rows) of the flat record
// (T*C elements; a row is C elements for K1, W for K5, so slot l of a piece
// is still lead l % C).  Its thread 0 copies the 16-byte-aligned interior of
// the piece with one 1-D bulk copy (cp.async.bulk, completing on an
// mbarrier); the ragged head and tail (fewer than 16 bytes each: a record
// stride such as 37*12*2 = 888 bytes, a view's offset) are read with
// ordinary loads by as many threads.  In shared memory the piece keeps its
// address modulo 16, so its interior is 16-byte aligned there too.
// The moments are the two-pass f32 form of the reference: f32 addends (x,
// and the f32 square of x - mean, not fused), partials in f64 (so a large DC
// offset beside a small std costs no bits to the summation order), totals
// rounded to f32 before the division by T.  Each pass: every walker thread
// keeps one f64 partial a slot of its 16-byte vector (its slots' leads are
// fixed: a line of the walk is a multiple of C; for K5, of W where W's
// vectors fit in one CTA's threads, which is how `width` sets the row a
// CTA walks), the lanes that share leads are folded by shuffles, the warps
// by warp 0 after one barrier, then the head and tail elements.  Warp 0
// sends the rank's C totals to every rank of the cluster by asynchronous
// remote stores (st.async into distributed shared memory, completing on the
// receiver's mbarrier); each rank adds the k totals of a lead in rank order
// 0..k-1, so every CTA computes the same f32 mean and sd (no seam at piece
// edges), and no cluster barrier stands in a record's path.  The output is
// computed from the resident piece in f32 (IEEE division: div_rn below)
// into shared memory (in place when the dtypes have one size, else a
// staging buffer that keeps the output's address modulo 16) and leaves by
// one bulk store (cp.async.bulk.global.shared::cta) plus ordinary stores of
// its head and tail.  ptbxl_zscore_stats writes [B, C, 2] from rank 0 and
// has no third pass.  A cluster takes `per` records in turn (K5: block_b).
// On the H100 the time a record holds its shared memory, not the bytes, is
// what a CTA spends: small pieces (about 30 KB), one buffer a CTA and 128
// threads keep some six CTAs an SM resident to cover each other's loads,
// folds and exchanges (tools/probe_zscore.py --sweep); a second buffer to
// read the next record early halves the CTAs an SM and measured slower.
//
// The launch plan (k, piece rows, records a cluster, threads, walkers,
// buffer and staging bytes, the largest bulk copy, shared memory) is
// computed in Python (ops/kernels/zscore.py: cluster_plan); the entries check
// it against the shapes, ask cudaOccupancyMaxActiveClusters whether the
// cluster fits, and return an error the wrapper raises on where it does not:
// there is no other kernel to fall back to.
#include <cooperative_groups.h>

#include <mutex>
#include <vector>

#include "hopper.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr float kEps = 1e-6f;
constexpr int kMaxThreads = 256;
constexpr int kMinBlocks = 3;     // CTAs an SM the registers must allow (at most 85 each)
constexpr int kMaxSmem = 232448;  // dynamic shared memory a CTA can have on the H100
constexpr int kMaxCluster = 16;   // above 8: non-portable cluster sizes

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// -- bulk stores ------------------------------------------------------------------
__device__ __forceinline__ void bulk_store(void* dst, const void* src, uint32_t bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(dst),
               "r"(smem_u32(src)), "r"(bytes)
               : "memory");
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
// this thread's bulk stores have read their shared memory
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}
// ... and have written device memory
__device__ __forceinline__ void bulk_wait_all() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// How a piece of n elements of `size` bytes at `addr` is read or written:
// `head` elements before the first 16-byte boundary and `tail` after the
// last by ordinary loads or stores, `bulk` bytes (a multiple of 16) between
// by one bulk copy.  ops/kernels/zscore.py: piece_split is the same.
struct Split {
  int head, bulk, tail;
};
__device__ __forceinline__ Split split(uintptr_t addr, int n, int size) {
  int head = (int)((16 - (addr & 15)) & 15) / size;
  if (head > n) head = n;
  const int rem = n - head;
  const int bulk = (rem * size) & ~15;
  return {head, bulk, rem - bulk / size};
}

// A 16-byte vector of VE = 16 / sizeof(T) elements, as f32.
__device__ __forceinline__ void unpack(const uint4& raw, float* v, float) {
  v[0] = __uint_as_float(raw.x);
  v[1] = __uint_as_float(raw.y);
  v[2] = __uint_as_float(raw.z);
  v[3] = __uint_as_float(raw.w);
}
__device__ __forceinline__ void unpack(const uint4& raw, float* v, __nv_bfloat16) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

// nw 32-bit words of packed output values.
__device__ __forceinline__ void pack(const float* v, uint32_t* w, int nw, float) {
#pragma unroll
  for (int i = 0; i < nw; ++i) w[i] = __float_as_uint(v[i]);
}
__device__ __forceinline__ void pack(const float* v, uint32_t* w, int nw, __nv_bfloat16) {
#pragma unroll
  for (int i = 0; i < nw; ++i) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);  // .x: lower address
    w[i] = *reinterpret_cast<const uint32_t*>(&h);
  }
}
// Store VE output values at p: as 16-byte (or 8-byte) vectors when `vec`
// (p aligned to min(16, VE * sizeof(Tout))), else one element at a time.
template <typename Tout, int VE>
__device__ __forceinline__ void store_group(Tout* p, const float* v, bool vec) {
  constexpr int kWords = VE * (int)sizeof(Tout) / 4;
  if (vec) {
    uint32_t w[kWords];
    pack(v, w, kWords, Tout());
    if constexpr (kWords == 2) {
      *reinterpret_cast<uint2*>(p) = make_uint2(w[0], w[1]);
    } else {
#pragma unroll
      for (int q = 0; q < kWords / 4; ++q)
        reinterpret_cast<uint4*>(p)[q] =
            make_uint4(w[4 * q], w[4 * q + 1], w[4 * q + 2], w[4 * q + 3]);
    }
  } else {
#pragma unroll
    for (int i = 0; i < VE; ++i) p[i] = from_f<Tout>(v[i]);
  }
}

struct Plan {
  int B, T, C;
  int row;         // elements a row: C (K1) or W (K5)
  int piece_rows;  // rows a rank; the last rank takes the rest
  int per;         // records a cluster takes in turn
  int walkers;     // threads that walk the piece (walkers * VE: a multiple of C, of row if it can)
  int lanes;       // min(32, C / gcd(C, VE)): lanes of a warp with distinct slot leads
  int buf_bytes;   // bytes of a piece buffer
  int stage_bytes; // bytes of the output staging buffer; 0: the output is written in place
};

// This CTA's per-lead totals of one pass (f64), each handed to sink(c, total)
// by lane c of warp 0: the walkers' slot partials p (slot i of thread t holds
// lead (hv + t*VE + i) % C) are folded over the lanes that share leads
// (shuffles) into red (nw * lanes * VE doubles); after one barrier, warp 0
// adds each lead's slots over the warps in order, then the head elements
// [0, hv) and tail elements [tail0, n) through addend(e, lead).
template <int VE, typename Addend, typename Sink>
__device__ __forceinline__ void piece_totals(double* p, double* red, int C, int lanes, int hv,
                                             int tail0, int n, Addend addend, Sink sink) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nw = blockDim.x >> 5;
  const int period = lanes;  // lanes t and t + period hold the same leads (when < 32)
#pragma unroll
  for (int off = 16; off >= 1; off >>= 1) {
    const int d = off * period;
    if (d < 32) {
#pragma unroll
      for (int i = 0; i < VE; ++i) {
        const double v = __shfl_down_sync(0xffffffffu, p[i], d);
        if (lane + d < 32) p[i] += v;
      }
    }
  }
  const int span = lanes * VE;
  if (lane < lanes) {
#pragma unroll
    for (int i = 0; i < VE; ++i) red[warp * span + lane * VE + i] = p[i];
  }
  __syncthreads();
  if (warp != 0) return;
  for (int c = lane; c < C; c += 32) {
    double s = 0.0;
    for (int w = 0; w < nw; ++w) {
      int q = (c - (hv + 32 * w * VE)) % C;  // warp w's first slot of lead c
      if (q < 0) q += C;
      for (; q < span; q += C) s += red[w * span + q];
    }
    for (int e = c; e < hv; e += C) s += addend(e, c);
    for (int e = tail0 + (((c - tail0) % C) + C) % C; e < n; e += C) s += addend(e, c);
    sink(c, s);
  }
}

// The exchange of the per-lead totals within the cluster, with no cluster
// barrier a record.  Lane c of warp 0 stores this rank's total of lead c
// into slot [rank][c] of every rank's inbox by asynchronous remote stores
// (st.async) that complete on that rank's inbox mbarrier; each rank's thread
// 0 expects k * C * 8 bytes a record there, and a rank goes on as soon as
// its k totals of every lead are in.  A rank's next store into an inbox
// follows its receipt of the owner's totals of the next pass, which the
// owner sends only after reading that inbox: no slot is overwritten before
// it is read, and no byte completes a phase ahead.
__device__ __forceinline__ uint32_t map_rank(const void* p, int rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(r) : "r"(smem_u32(p)), "r"(rank));
  return r;
}
__device__ __forceinline__ void send_total(double* inbox, uint64_t* bar, int k, int rank, int C,
                                           int c, double v) {
  for (int r = 0; r < k; ++r)
    asm volatile(
        "st.async.shared::cluster.mbarrier::complete_tx::bytes.f64 [%0], %1, [%2];\n" ::"r"(
            map_rank(inbox + rank * C + c, r)),
        "d"(v), "r"(map_rank(bar, r))
        : "memory");
}
// Warp 0: wait for the record's k totals of every lead (thread 0 expects their
// bytes), then fn(c, lead c's total, added in rank order 0..k-1).
template <typename Fn>
__device__ __forceinline__ void receive_totals(const double* inbox, uint64_t* bar, int k, int C,
                                               uint32_t parity, Fn fn) {
  if (threadIdx.x == 0) mbar_expect_tx(bar, (uint32_t)(k * C * sizeof(double)));
  if (threadIdx.x < C && threadIdx.x < 32) {
    mbar_wait(bar, parity);
    for (int c = threadIdx.x; c < C; c += 32) {
      double t = 0.0;
      for (int r = 0; r < k; ++r) t += inbox[r * C + c];
      fn(c, t);
    }
  }
}

// a / b rounded to nearest (IEEE), from y = RN(1/b) (0 where b is out of
// range): q = RN(a*y) is within an ulp of a/b, r = a - b*q is exact (one
// fma), and RN(q + r*y) is then the correctly rounded quotient (Markstein's
// theorem), as long as nothing underflows or overflows.  With |a| and b in
// [2^-60, 2^60] the quotient and r stay normal; elsewhere (a is 0, tiny,
// huge, inf or NaN) the division itself runs.  Three FP32 operations an
// element instead of the division's reciprocal and refinement.
__device__ __forceinline__ float div_rn(float a, float b, float y) {
  const float q = __fmul_rn(a, y);
  const float r = __fmaf_rn(-q, b, a);
  const float q1 = __fmaf_rn(r, y, q);
  const float aa = fabsf(a);
  return (y != 0.f && aa >= 0x1p-60f && aa <= 0x1p60f) ? q1 : __fdiv_rn(a, b);
}
__device__ __forceinline__ float rcp_for_div(float b) {
  return (b >= 0x1p-60f && b <= 0x1p60f) ? __frcp_rn(b) : 0.f;
}

// Lead of slot i of a thread whose slot 0 holds lead lb (< C), i < VE.
__device__ __forceinline__ int lead_of(int lb, int i, int C) {
  int l = lb + i;
  while (l >= C) l -= C;
  return l;
}

__host__ __device__ constexpr int cgcd(int a, int b) { return b ? cgcd(b, a % b) : a; }

// kC: the lead count when it is known at compile time (12, the ECG's leads:
// every lead index below is then a multiply and shift), 0 for any other C.
template <typename Tin, typename Tout, bool kStats, int kC>
__global__ void __launch_bounds__(kMaxThreads, kMinBlocks)
    zscore_cluster_kernel(const Tin* __restrict__ x, Tout* __restrict__ out,
                          float* __restrict__ stats, Plan p) {
  constexpr int VE = 16 / (int)sizeof(Tin);
  constexpr int kLanes = kC ? (kC / cgcd(kC, VE) < 32 ? kC / cgcd(kC, VE) : 32) : 0;
  const int C = kC ? kC : p.C;
  const int lanes = kC ? kLanes : p.lanes;
  extern __shared__ __align__(128) unsigned char smem[];
  cg::cluster_group cl = cg::this_cluster();
  const int k = (int)cl.num_blocks();
  const int rank = (int)cl.block_rank();
  const int tid = threadIdx.x;
  const long L = (long)p.T * C;
  const int nrows = (int)(L / p.row);
  const int r0 = rank * p.piece_rows;
  const long start = (long)r0 * p.row;
  const int n = (min(r0 + p.piece_rows, nrows) - r0) * p.row;  // this rank's elements
  const int rec0 = (blockIdx.x / k) * p.per;
  const int nrec = min(p.per, p.B - rec0);
  const float tf = (float)p.T;

  unsigned char* buf = smem;  // the piece, at its address modulo 16
  unsigned char* stage = buf + p.buf_bytes;
  double* red = reinterpret_cast<double*>(stage + p.stage_bytes);
  double* inbox = red + (blockDim.x >> 5) * lanes * VE;  // [2 passes][k][C]
  uint64_t* bar = reinterpret_cast<uint64_t*>(inbox + 2 * k * C);  // the piece's
  uint64_t* inbar = bar + 1;                                          // the two inboxes'
  float* mean_s = reinterpret_cast<float*>(inbar + 2);
  float* sd_s = mean_s + C;
  float* rc_s = sd_s + C;  // RN(1 / sd) for div_rn

  if (tid == 0) {
    for (int q = 0; q < 3; ++q) mbar_init(&bar[q], 1);  // the piece, then both inboxes
    fence_mbarrier_init();
  }
  __syncthreads();

  // Start reading record rec0 + j: the bulk copy of the piece's interior, and
  // this thread's head or tail element into `pend` (written to shared memory
  // before the record's first pass).
  Tin pend = Tin();
  int pend_e = -1;
  auto read_piece = [&](int j) {
    const Tin* xg = x + (long)(rec0 + j) * L + start;
    const Split s = split(reinterpret_cast<uintptr_t>(xg), n, (int)sizeof(Tin));
    Tin* xs = reinterpret_cast<Tin*>(buf + (reinterpret_cast<uintptr_t>(xg) & 15));
    if (tid == 0) {
      mbar_expect_tx(bar, (uint32_t)s.bulk);
      if (s.bulk) bulk_load(xs + s.head, xg + s.head, (uint32_t)s.bulk, bar);
    }
    pend_e = -1;
    if (tid < s.head + s.tail) {
      pend_e = tid < s.head ? tid : n - s.tail + (tid - s.head);
      pend = xg[pend_e];
    }
  };

  read_piece(0);
  // every rank's inbox mbarriers must exist before the first remote store into
  // them: arrive now, wait just before the first send (long since complete then)
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
  for (int j = 0; j < nrec; ++j) {
    const int rec = rec0 + j;
    const Tin* xg = x + (long)rec * L + start;
    const uintptr_t a = reinterpret_cast<uintptr_t>(xg);
    const Split s = split(a, n, (int)sizeof(Tin));
    Tin* xs = reinterpret_cast<Tin*>(buf + (a & 15));
    if (pend_e >= 0) xs[pend_e] = pend;
    mbar_wait(bar, (uint32_t)(j & 1));
    __syncthreads();
    const int ngroups = s.bulk / 16;  // 16-byte vectors from element s.head
    const int tail0 = n - s.tail;
    const uint4* vs = reinterpret_cast<const uint4*>(xs + s.head);
    const int g0 = tid < p.walkers ? tid : ngroups;  // the last warp's extra lanes walk nothing
    const int lb = (s.head + tid * VE) % C;  // lead of this thread's slot 0

    // pass 1: sums
    double acc[VE];
#pragma unroll
    for (int i = 0; i < VE; ++i) acc[i] = 0.0;
#pragma unroll 2
    for (int g = g0; g < ngroups; g += p.walkers) {
      float v[VE];
      unpack(vs[g], v, Tin());
#pragma unroll
      for (int i = 0; i < VE; ++i) acc[i] += (double)v[i];
    }
    if (j == 0) asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
    piece_totals<VE>(
        acc, red, C, lanes, s.head, tail0, n, [&](int e, int) { return (double)to_f(xs[e]); },
        [&](int c, double t) { send_total(inbox, &inbar[0], k, rank, C, c, t); });
    receive_totals(inbox, &inbar[0], k, C, (uint32_t)(j & 1),
                   [&](int c, double t) { mean_s[c] = (float)t / tf; });
    __syncthreads();

    // pass 2: centred sums of squares
    float m[VE];
#pragma unroll
    for (int i = 0; i < VE; ++i) {
      m[i] = mean_s[lead_of(lb, i, C)];
      acc[i] = 0.0;
    }
#pragma unroll 2
    for (int g = g0; g < ngroups; g += p.walkers) {
      float v[VE];
      unpack(vs[g], v, Tin());
#pragma unroll
      for (int i = 0; i < VE; ++i) {
        const float d = v[i] - m[i];
        acc[i] += (double)__fmul_rn(d, d);  // the f32 square of the reference, not fused
      }
    }
    double* inbox2 = inbox + k * C;
    piece_totals<VE>(
        acc, red, C, lanes, s.head, tail0, n,
        [&](int e, int c) {
          const float d = to_f(xs[e]) - mean_s[c];
          return (double)__fmul_rn(d, d);
        },
        [&](int c, double t) { send_total(inbox2, &inbar[1], k, rank, C, c, t); });
    receive_totals(inbox2, &inbar[1], k, C, (uint32_t)(j & 1), [&](int c, double t) {
      sd_s[c] = sqrtf((float)t / tf) + kEps;
      rc_s[c] = rcp_for_div(sd_s[c]);
    });
    // the staging buffer is free once the last bulk store has read it
    if (p.stage_bytes && tid == 0) bulk_wait_read();
    __syncthreads();

    if constexpr (kStats) {
      if (rank == 0) {
        for (int c = tid; c < C; c += blockDim.x) {
          float* st = stats + ((long)rec * C + c) * 2;
          st[0] = mean_s[c];
          st[1] = sd_s[c];
        }
      }
    } else {
      // pass 3: the output, from the resident piece into shared memory
      Tout* og = out + (long)rec * L + start;
      const uintptr_t oa = reinterpret_cast<uintptr_t>(og);
      Tout* os = p.stage_bytes ? reinterpret_cast<Tout*>(stage + (oa & 15))
                               : reinterpret_cast<Tout*>(xs);
      constexpr int kAlign = VE * (int)sizeof(Tout) < 16 ? VE * (int)sizeof(Tout) : 16;
      const bool vec = (reinterpret_cast<uintptr_t>(os + s.head) % kAlign) == 0;
      float sd[VE], rc[VE];
#pragma unroll
      for (int i = 0; i < VE; ++i) {
        sd[i] = sd_s[lead_of(lb, i, C)];
        rc[i] = rc_s[lead_of(lb, i, C)];
      }
#pragma unroll 2
      for (int g = g0; g < ngroups; g += p.walkers) {
        float v[VE];
        unpack(vs[g], v, Tin());
#pragma unroll
        for (int i = 0; i < VE; ++i) v[i] = div_rn(v[i] - m[i], sd[i], rc[i]);
        store_group<Tout, VE>(os + s.head + g * VE, v, vec);
      }
      if (tid < s.head + s.tail) {
        const int e = tid < s.head ? tid : tail0 + (tid - s.head);
        const int c = e % C;
        const float v = div_rn(to_f(xs[e]) - mean_s[c], sd_s[c], rc_s[c]);
        os[e] = from_f<Tout>(v);
      }
      fence_proxy_async();
      __syncthreads();
      // in place, the interior leaves by a bulk store when the output keeps the
      // input's address modulo 16 (always, unless the input is an offset view)
      if (p.stage_bytes || ((oa ^ a) & 15) == 0) {
        const Split so = split(oa, n, (int)sizeof(Tout));
        if (tid == 0 && so.bulk) bulk_store(og + so.head, os + so.head, (uint32_t)so.bulk);
        if (tid < so.head + so.tail) {
          const int e = tid < so.head ? tid : n - so.tail + (tid - so.head);
          og[e] = os[e];
        }
      } else {
        for (int e = tid; e < n; e += blockDim.x) og[e] = os[e];
      }
      fence_proxy_async();
    }
    if (j + 1 < nrec) {  // the next record, once the last bulk store has read the piece
      if (tid == 0) bulk_wait_read();
      __syncthreads();
      read_piece(j + 1);
    }
  }
  if (tid == 0) bulk_wait_all();
}

// ---- host side ---------------------------------------------------------------

int gcd(int a, int b) { return b ? gcd(b, a % b) : a; }

// The plan's launch figures, as cluster_plan (ops/kernels/zscore.py) computes them.
struct Launch {
  int k, threads, bulk_bytes, smem_bytes;
};

size_t smem_of(const Plan& p, int k, int threads, int ve) {
  return (size_t)p.buf_bytes + p.stage_bytes +
         (size_t)(threads / 32) * p.lanes * ve * sizeof(double) +
         (size_t)2 * k * p.C * sizeof(double) + 3 * sizeof(uint64_t) +
         3 * (size_t)p.C * sizeof(float);
}

// Check a plan against the shapes: every rank holds a piece, the buffers hold
// the largest piece with its alignment pad, the walk's line is a multiple of
// the row, the largest bulk copy and the shared memory are what they must be.
cudaError_t check_plan(const Plan& p, const Launch& l, int in_size, int out_size) {
  const int ve = 16 / in_size;
  const long len = (long)p.T * p.C;
  if (p.B <= 0 || p.T <= 0 || p.C <= 0 || p.row <= 0 || p.row % p.C || len % p.row)
    return cudaErrorInvalidValue;
  const int nrows = (int)(len / p.row);
  if (l.k < 1 || l.k > kMaxCluster || p.piece_rows < 1 || (long)l.k * p.piece_rows < nrows ||
      (long)(l.k - 1) * p.piece_rows >= nrows)
    return cudaErrorInvalidValue;
  const long piece = (long)p.piece_rows * p.row;
  auto padded = [](long bytes) { return (bytes + 16 + 15) / 16 * 16; };
  if (p.per < 1 || p.buf_bytes != padded(piece * in_size) ||
      p.stage_bytes != (out_size == in_size ? 0 : padded(piece * out_size)))
    return cudaErrorInvalidValue;
  if (l.threads < 32 || l.threads > kMaxThreads || l.threads % 32 || p.walkers < 1 ||
      p.walkers > l.threads || ((long)p.walkers * ve) % p.C || l.threads - p.walkers >= 32)
    return cudaErrorInvalidValue;
  const int period = p.C / gcd(p.C, ve);
  if (p.lanes != (period < 32 ? period : 32)) return cudaErrorInvalidValue;
  if (l.bulk_bytes != (int)((piece * in_size) & ~15L)) return cudaErrorInvalidValue;
  const size_t smem = smem_of(p, l.k, l.threads, ve);
  if ((size_t)l.smem_bytes != smem || smem > (size_t)kMaxSmem) return cudaErrorInvalidValue;
  return cudaSuccess;
}

// Kernel attributes, once a (kernel, device): the largest dynamic shared
// memory (a per-plan value would shrink the limit under another plan's
// launch) and non-portable cluster sizes.  Then the occupancy question, once
// a (kernel, device, cluster, threads, shared memory): the answer does not
// change.
struct Fits {
  const void* fn;
  int device, k, threads, smem;
};
std::mutex fits_mu;
std::vector<Fits> fits;

template <typename Kernel>
cudaError_t ensure_fits(Kernel fn, int device, const cudaLaunchConfig_t& cfg, int k) {
  const int threads = (int)cfg.blockDim.x, smem = (int)cfg.dynamicSmemBytes;
  std::lock_guard<std::mutex> lock(fits_mu);
  bool attributes = false;
  for (const Fits& f : fits) {
    if (f.fn != (const void*)fn || f.device != device) continue;
    if (f.k == k && f.threads == threads && f.smem == smem) return cudaSuccess;
    attributes = true;
  }
  cudaError_t err;
  if (!attributes) {
    err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (err != cudaSuccess) return err;
    err = cudaFuncSetAttribute(fn, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
  }
  int clusters = 0;
  err = cudaOccupancyMaxActiveClusters(&clusters, fn, &cfg);
  if (err != cudaSuccess) return err;
  if (clusters < 1) return cudaErrorLaunchOutOfResources;  // the cluster does not fit the card
  fits.push_back({(const void*)fn, device, k, threads, smem});
  return cudaSuccess;
}

template <typename Tin, typename Tout, bool kStats>
cudaError_t launch(int device, const void* x, void* out, void* stats, const Plan& p,
                   const Launch& l, cudaStream_t st) {
  cudaError_t err =
      check_plan(p, l, (int)sizeof(Tin), kStats ? (int)sizeof(Tin) : (int)sizeof(Tout));
  if (err != cudaSuccess) return err;
  auto fn = p.C == 12 ? zscore_cluster_kernel<Tin, Tout, kStats, 12>
                      : zscore_cluster_kernel<Tin, Tout, kStats, 0>;
  const int clusters = (p.B + p.per - 1) / p.per;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)l.k;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(clusters * l.k));
  cfg.blockDim = dim3((unsigned)l.threads);
  cfg.dynamicSmemBytes = (size_t)l.smem_bytes;
  cfg.stream = st;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = ensure_fits(fn, device, cfg, l.k);
  if (err == cudaSuccess)
    err = cudaLaunchKernelEx(&cfg, fn, static_cast<const Tin*>(x), static_cast<Tout*>(out),
                             static_cast<float*>(stats), p);
  // read and clear the runtime's last error, so that a later call does not report this one
  const cudaError_t last = cudaGetLastError();
  return err != cudaSuccess ? err : last;
}

// plan: k, piece_rows, per, threads, walkers, lanes, buf_bytes, stage_bytes,
// bulk_bytes, smem_bytes (ops/kernels/zscore.py: ClusterPlan).
Plan make_plan(int B, int T, int C, int row, const int* q) {
  return {B, T, C, row, q[1], q[2], q[4], q[5], q[6], q[7]};
}
Launch make_launch(const int* q) { return {q[0], q[3], q[8], q[9]}; }

template <bool kStats>
cudaError_t dispatch(int device, const void* x, void* out, const Plan& p, const Launch& l,
                     int in_bf16, int out_bf16, cudaStream_t st) {
  if (kStats) {
    if (in_bf16) return launch<__nv_bfloat16, float, true>(device, x, nullptr, out, p, l, st);
    return launch<float, float, true>(device, x, nullptr, out, p, l, st);
  }
  if (!in_bf16 && !out_bf16) return launch<float, float, false>(device, x, out, nullptr, p, l, st);
  if (!in_bf16) return launch<float, __nv_bfloat16, false>(device, x, out, nullptr, p, l, st);
  if (!out_bf16) return launch<__nv_bfloat16, float, false>(device, x, out, nullptr, p, l, st);
  return launch<__nv_bfloat16, __nv_bfloat16, false>(device, x, out, nullptr, p, l, st);
}

}  // namespace

// Every entry takes the launch plan of ops/kernels/zscore.py: cluster_plan for
// its shapes, as 10 ints (make_plan above), and returns a CUDA error code.
extern "C" {

// x [B, T, C] (f32, or bf16 when in_bf16) -> out [B, T, C] (bf16 when out_bf16).
int ptbxl_zscore(int device, const void* x, void* out, int B, int T, int C, int in_bf16,
                 int out_bf16, const int* plan, void* stream) {
  cudaError_t err = ptbxl_ensure_device(device);
  if (err != cudaSuccess) return (int)err;
  return (int)dispatch<false>(device, x, out, make_plan(B, T, C, C, plan), make_launch(plan),
                              in_bf16, out_bf16, static_cast<cudaStream_t>(stream));
}

// x [B, T, C] -> stats [B, C, 2] f32: (mean, sqrt(var) + 1e-6).
int ptbxl_zscore_stats(int device, const void* x, void* stats, int B, int T, int C, int in_bf16,
                       const int* plan, void* stream) {
  cudaError_t err = ptbxl_ensure_device(device);
  if (err != cudaSuccess) return (int)err;
  return (int)dispatch<true>(device, x, stats, make_plan(B, T, C, C, plan), make_launch(plan),
                             in_bf16, 0, static_cast<cudaStream_t>(stream));
}

// K5: x [B, T, C] with rows of W elements (W divides T*C, W % C == 0) -> out;
// a cluster takes block_b records in turn (the plan's per).
int ptbxl_zscore_wide(int device, const void* x, void* out, int B, int T, int C, int W,
                      int block_b, int in_bf16, int out_bf16, const int* plan, void* stream) {
  cudaError_t err = ptbxl_ensure_device(device);
  if (err != cudaSuccess) return (int)err;
  if (block_b <= 0 || plan[2] != block_b) return (int)cudaErrorInvalidValue;
  return (int)dispatch<false>(device, x, out, make_plan(B, T, C, W, plan), make_launch(plan),
                              in_bf16, out_bf16, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
