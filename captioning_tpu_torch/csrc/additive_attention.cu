// Additive attention of the RNN captioners (sm_90a).
//
// Replaces captioning_tpu/ops/attention.py:_attn_kernel (wrapper
// additive_attention_fused); the Python wrapper, its launch plan and the
// plain twin are in ops/attention.py.
//
// What bounds it on the H100.  At the UpDown beam-5 step (1024 images,
// bw 5, M 36, H 1000, A 512, bf16) the call must move 127 MB (att 73.7 MB,
// p_att 37.7 MB, the queries and the output): 0.038 ms at 3.35 TB/s.  It
// also takes bw*M*A = 94.4 M tanh (18.9 M at bw 1); a tanh of two MUFU
// results (exp and reciprocal) at 16 a clock per SM floors them at ~0.045
// ms, so at bw 5 the tanh costs about what the bytes do, and at bw 1 the
// bytes dominate.
//
// What held the first design back (0.33 ms at bw 5, 11% of the bytes'
// rate): one block per image, all 1024 resident at once and so in
// lockstep, every block scoring and then every block streaming att, with
// nothing overlapping the two; 2-byte loads, a few hundred bytes in flight
// a warp; an accurate tanhf between two bf16 round trips for each of the
// 94 M elements; 36 regions over 8 warps, 5 for some and 4 for others.
//
// This design, two kernels behind one entry point:
//  * the ring kernel (additive_attention_ring), for rows of whole 16-byte
//    multiples on 16-byte boundaries, A a multiple of 8 and H <= 1024 (the
//    captioners that embed their regions first; att2in attends over the
//    raw 2048-wide regions and takes the direct kernel): a persistent grid of two blocks an SM walks over
//    the images.  In each block a producer warp streams the operands into
//    shared memory by bulk async copies (cp.async.bulk, completed on
//    mbarriers): for each image its bw query rows (a 2-deep buffer), then
//    p_att[b] and att[b] in stages of whole regions (8 KB) through a ring of
//    as many stages as two blocks an SM leave room for.  The producer runs
//    the ring's depth ahead across images, so the att stream goes on under
//    the score work and no consumer waits on HBM.  Eight consumer warps:
//    phase 1 scores each p stage in units of (region, A-slice of 256
//    elements) dealt round-robin to the warps across stages (M 36, A 512:
//    72 units, 9 a warp), each lane 8 elements for all bw queries; phase 3
//    gives each thread 4 columns of each att stage and all bw outputs from
//    one read of each element.  It is compiled for each bw (1-8): the
//    queries' arithmetic and shuffle reductions interleave with no branch
//    between them, and each unit stores its sums as partials that phase 2
//    adds in order (no shared-memory float atomics, which are compare-and-
//    swap loops on this card).  Deterministic.
//  * the direct kernel (additive_attention_kernel) for every other shape:
//    the same phases from 16-byte vector loads where rows allow and element
//    loads elsewhere (ragged H or A).
//  * phase 2 (both): softmax over M in float32, times the mask, renormalised
//    by max(sum, 1e-9) (an all-masked row gives 0), one warp per query.
//  * the bf16 tanh is a lookup in an 896-entry shared-memory table of
//    round_bf16(tanhf(x)) over the inputs 2^-5 <= |x| < 4, filled by each
//    block at start and kept in 8 copies (a lane reads copy lane % 8, so a
//    warp's random lookups spread over the banks); |x| is clamped into the
//    table's range by bf16x2 max and min, and below the range the rounded
//    tanh is x itself, at its top 1, and NaN stays NaN: bit-identical to the
//    twin's tanh (chip_smoke.py runs all 65,536 bf16 inputs through the
//    rule, ``additive_attention_tanh``).  float32 keeps tanhf.  bf16 adds
//    and products are packed (bf16x2): the sum or product of two bf16
//    values is exact in float32, so one bf16 rounding of either is the
//    twin's.
// Rounding: in bf16 the add, tanh, the product with w, the weight and its
// product with att are rounded; every sum is float32, as in the twin; the
// two differ in summation order only.
//
// Layouts: att_h [nb*bw, A]; att [nb, M, H]; p_att [nb, M, A]; mask [nb, M]
// float32; w [A]; b [1]; out [nb*bw, H].  att_h, p_att, w and b share the
// element type T, att and out the type TA: (T, TA) is (float32, float32),
// (bfloat16, bfloat16) or (bfloat16, float32), the last for bf16 models
// whose masked BatchNorm hands float32 features to the head (dtype codes
// 0 = float32, 1 = bfloat16).  ops/attention.py:launch_plan mirrors which
// kernel a shape takes, its shared memory and how it cuts the work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int DIRECT_BLOCKS_PER_SM = 2;   // the direct kernel's register budget
constexpr int MAX_BW = 8;
constexpr int VEC = 8;                  // elements a lane loads at a time
constexpr int SLICE_GROUPS = 32;        // 8-element groups of a phase-1 unit
constexpr int ROWS = 4;                 // att rows of loads in flight
constexpr int MAX_SMEM = 232448;
// the ring kernel: a producer warp beside the THREADS consumers, a ring of
// as many STAGE_BYTES stages as RING_BLOCKS_PER_SM blocks an SM leave room
// for (at most RING_MAX_STAGES), after RING_BARS bytes of mbarriers
constexpr int RING_THREADS = THREADS + 32;
constexpr int RING_BLOCKS_PER_SM = 2;
constexpr int RING_MAX_STAGES = 24;
constexpr int STAGE_BYTES = 8192;
constexpr int RING_BARS = 512;
constexpr int RING_MAX_H = 4 * THREADS;
constexpr int SM_SMEM = 233472;          // an SM's shared memory
constexpr int BLOCK_RESERVED = 1024;     // the runtime's share of each block
// the bf16 tanh table: the bits of |x| in [TAB_LO, TAB_HI) = [2^-5, 4)
constexpr uint32_t TAB_LO = 0x3D00u;
constexpr uint32_t TAB_HI = 0x4080u;
constexpr uint32_t TAB_N = TAB_HI - TAB_LO;    // 896
constexpr uint32_t TAB_COPIES = 8;
constexpr uint32_t TAB_BYTES = 2 * TAB_N * TAB_COPIES;   // 14 KB

typedef __nv_bfloat16 bf16;
typedef __nv_bfloat162 bf162;

__device__ __forceinline__ uint32_t bits2(bf162 x) {
  return *reinterpret_cast<uint32_t*>(&x);
}
__device__ __forceinline__ bf162 pair(uint32_t x) {
  return *reinterpret_cast<bf162*>(&x);
}
__device__ __forceinline__ uint32_t word(const uint4& v, int j) {
  return j == 0 ? v.x : j == 1 ? v.y : j == 2 ? v.z : v.w;
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

// ---------------------------------------------------------------- tanh --

// entry i (the bits TAB_LO + i) of copy c at tab[i * TAB_COPIES + c]: a
// lane reads copy lane % TAB_COPIES, so a warp's 32 random lookups spread
// over the banks
__device__ void fill_tanh_table(unsigned short* tab) {
  for (uint32_t i = threadIdx.x; i < TAB_N; i += blockDim.x) {
    const unsigned short t = __bfloat16_as_ushort(__float2bfloat16_rn(tanhf(
        __bfloat162float(__ushort_as_bfloat16((unsigned short)(TAB_LO + i))))));
    for (uint32_t c = 0; c < TAB_COPIES; ++c) tab[i * TAB_COPIES + c] = t;
  }
}

// round_bf16(tanhf(x)) for both halves of the bf16 pair x, from the lane's
// copy tabl of the table: |x| clamped into the table's range (max and min
// of bf16x2, which drop a NaN), one lookup a half, then x itself where |x|
// is below the range or NaN (not >= TAB_LO), the sign of x elsewhere; the
// clamp's top entry, 3.98, already rounds to 1
__device__ __forceinline__ uint32_t tanh2(uint32_t x,
                                          const unsigned short* tabl) {
  const bf162 a = pair(x & 0x7FFF7FFFu);
  const bf162 lo = pair(TAB_LO * 0x10001u);
  const uint32_t c =
      bits2(__hmin2(__hmax2(a, lo), pair((TAB_HI - 1) * 0x10001u)));
  const uint32_t t = tabl[((c & 0xFFFFu) - TAB_LO) * TAB_COPIES] |
                     (uint32_t)tabl[((c >> 16) - TAB_LO) * TAB_COPIES] << 16;
  const uint32_t in = __hge2_mask(a, lo);
  return (in & t) | (x & (~in | 0x80008000u));
}

// ------------------------------------------------------ 8-element rows --

template <typename T> struct Vec;

template <> struct Vec<bf16> {
  uint4 v;
  __device__ __forceinline__ void zero() { v = make_uint4(0, 0, 0, 0); }
  // the first n (>= 8 where vec) elements at p; the rest 0
  __device__ __forceinline__ void load(const bf16* p, int n, bool vec) {
    if (vec) {
      v = __ldg(reinterpret_cast<const uint4*>(p));
      return;
    }
    uint32_t s[VEC];
#pragma unroll
    for (int j = 0; j < VEC; ++j)
      s[j] = j < n ? __bfloat16_as_ushort(p[j]) : 0u;
    v = make_uint4(s[0] | s[1] << 16, s[2] | s[3] << 16, s[4] | s[5] << 16,
                   s[6] | s[7] << 16);
  }
  __device__ __forceinline__ void load_shared(const bf16* p) {
    v = *reinterpret_cast<const uint4*>(p);
  }
};

template <> struct Vec<float> {
  float f[VEC];
  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int j = 0; j < VEC; ++j) f[j] = 0.f;
  }
  __device__ __forceinline__ void load(const float* p, int n, bool vec) {
    if (vec) {
      const float4 x = __ldg(reinterpret_cast<const float4*>(p));
      const float4 y = __ldg(reinterpret_cast<const float4*>(p) + 1);
      f[0] = x.x; f[1] = x.y; f[2] = x.z; f[3] = x.w;
      f[4] = y.x; f[5] = y.y; f[6] = y.z; f[7] = y.w;
      return;
    }
#pragma unroll
    for (int j = 0; j < VEC; ++j) f[j] = j < n ? p[j] : 0.f;
  }
  __device__ __forceinline__ void load_shared(const float* p) {
    const float4 x = reinterpret_cast<const float4*>(p)[0];
    const float4 y = reinterpret_cast<const float4*>(p)[1];
    f[0] = x.x; f[1] = x.y; f[2] = x.z; f[3] = x.w;
    f[4] = y.x; f[5] = y.y; f[6] = y.z; f[7] = y.w;
  }
};

__device__ __forceinline__ void store8(bf16* p, const float* v, int n,
                                       bool vec) {
  if (vec) {
    *reinterpret_cast<uint4*>(p) = make_uint4(
        bits2(__floats2bfloat162_rn(v[0], v[1])),
        bits2(__floats2bfloat162_rn(v[2], v[3])),
        bits2(__floats2bfloat162_rn(v[4], v[5])),
        bits2(__floats2bfloat162_rn(v[6], v[7])));
    return;
  }
#pragma unroll
  for (int j = 0; j < VEC; ++j)
    if (j < n) p[j] = __float2bfloat16_rn(v[j]);
}

__device__ __forceinline__ void store8(float* p, const float* v, int n,
                                       bool vec) {
  if (vec) {
    reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
    reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
    return;
  }
#pragma unroll
  for (int j = 0; j < VEC; ++j)
    if (j < n) p[j] = v[j];
}

// -------------------------------------------------- per-type arithmetic --

template <typename T> struct Ops;

template <> struct Ops<bf16> {
  __device__ static float round(float x) {
    return __bfloat162float(__float2bfloat16_rn(x));
  }
  __device__ static bf16 from_float(float x) { return __float2bfloat16_rn(x); }
  __device__ static float to_float(bf16 x) { return __bfloat162float(x); }
  // a weight as phase 3 reads it: the bf16 pair (w, w) in a float's bits
  __device__ static float encode(float w) {
    return __uint_as_float(bits2(__float2bfloat162_rn(w)));
  }
  // sum_j round(round(tanh(round(p + h))) * w) over the 8 elements
  __device__ static float score(const Vec<bf16>& p, const Vec<bf16>& h,
                                const Vec<bf16>& w,
                                const unsigned short* tabl) {
    float s = 0.f;
#pragma unroll
    for (int j = 0; j < VEC / 2; ++j) {
      const uint32_t x = bits2(__hadd2(pair(word(p.v, j)),
                                       pair(word(h.v, j))));
      const float2 d = __bfloat1622float2(
          __hmul2(pair(tanh2(x, tabl)), pair(word(w.v, j))));
      s += d.x;
      s += d.y;
    }
    return s;
  }
  // acc += round(att * weight), the weight as ``encode`` left it
  __device__ static void accumulate(const Vec<bf16>& a, float wenc,
                                    float* acc) {
    const bf162 w2 = pair(__float_as_uint(wenc));
#pragma unroll
    for (int j = 0; j < VEC / 2; ++j) {
      const float2 d = __bfloat1622float2(__hmul2(pair(word(a.v, j)), w2));
      acc[2 * j] += d.x;
      acc[2 * j + 1] += d.y;
    }
  }
};

template <> struct Ops<float> {
  __device__ static float round(float x) { return x; }
  __device__ static float from_float(float x) { return x; }
  __device__ static float to_float(float x) { return x; }
  __device__ static float encode(float w) { return w; }
  __device__ static float score(const Vec<float>& p, const Vec<float>& h,
                                const Vec<float>& w,
                                const unsigned short*) {
    float s = 0.f;
#pragma unroll
    for (int j = 0; j < VEC; ++j)
      s += __fmul_rn(tanhf(p.f[j] + h.f[j]), w.f[j]);
    return s;
  }
  __device__ static void accumulate(const Vec<float>& a, float w,
                                    float* acc) {
#pragma unroll
    for (int j = 0; j < VEC; ++j) acc[j] += __fmul_rn(a.f[j], w);
  }
};

// 4 columns of a staged att row in shared memory, and their products
__device__ __forceinline__ uint2 load4(const bf16* a) {
  return *reinterpret_cast<const uint2*>(a);
}
__device__ __forceinline__ float4 load4(const float* a) {
  return *reinterpret_cast<const float4*>(a);
}

__device__ __forceinline__ void accumulate4(uint2 v, float wenc, float* acc) {
  const bf162 w2 = pair(__float_as_uint(wenc));
  const float2 d0 = __bfloat1622float2(__hmul2(pair(v.x), w2));
  const float2 d1 = __bfloat1622float2(__hmul2(pair(v.y), w2));
  acc[0] += d0.x;
  acc[1] += d0.y;
  acc[2] += d1.x;
  acc[3] += d1.y;
}

__device__ __forceinline__ void accumulate4(float4 v, float w, float* acc) {
  acc[0] += __fmul_rn(v.x, w);
  acc[1] += __fmul_rn(v.y, w);
  acc[2] += __fmul_rn(v.z, w);
  acc[3] += __fmul_rn(v.w, w);
}

__device__ __forceinline__ void store4(bf16* p, const float* v) {
  *reinterpret_cast<uint2*>(p) =
      make_uint2(bits2(__floats2bfloat162_rn(v[0], v[1])),
                 bits2(__floats2bfloat162_rn(v[2], v[3])));
}

__device__ __forceinline__ void store4(float* p, const float* v) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

// phase 2 for the bw queries of one image: e = score + bias (the score in
// e, or with S > 0 the sum of its S partials in part), a float32
// softmax over M, times the mask, renormalised by max(sum, 1e-9) (an
// all-masked row gives 0); the weight rounded to TA and left as phase 3
// reads it.  One warp per query; a lane only touches its own regions.
template <typename TA>
__device__ __forceinline__ void softmax_rows(float* sh_e, const float* part,
                                             int S,
                                             const float* __restrict__ mk,
                                             float bias, int bw, int M,
                                             int warp, int lane) {
  for (int q = warp; q < bw; q += WARPS) {
    float* e = sh_e + q * M;
    float mx = -INFINITY;
    for (int m = lane; m < M; m += 32) {
      float x = e[m];
      if (S) {         // the region's S partial sums, in order
        x = part[(q * M + m) * S];
        for (int k = 1; k < S; ++k) x += part[(q * M + m) * S + k];
      }
      x += bias;
      e[m] = x;
      mx = fmaxf(mx, x);
    }
    mx = warp_max(mx);
    float sum = 0.f;
    for (int m = lane; m < M; m += 32) {
      const float x = expf(e[m] - mx);
      e[m] = x;
      sum += x;
    }
    sum = warp_sum(sum);
    float kept = 0.f;
    for (int m = lane; m < M; m += 32) {
      const float x = e[m] / sum * mk[m];
      e[m] = x;
      kept += x;
    }
    kept = fmaxf(warp_sum(kept), 1e-9f);
    for (int m = lane; m < M; m += 32)
      e[m] = Ops<TA>::encode(Ops<TA>::round(e[m] / kept));
  }
}

// ------------------------------------------------ mbarriers, bulk copies --

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               ::"r"(smem_u32(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar)) : "memory");
}

// a fault in the ring's protocol traps (a launch error) instead of spinning
// for ever: no legitimate wait lasts more than microseconds
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_u32(bar);
  uint32_t done, spins = 0;
  do {
    if (++spins == (1u << 26)) __trap();
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
  } while (!done);
}

// bytes (a multiple of 16) from global src to shared dst, both 16-byte
// aligned, completing on bar
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// the consumer warps' barrier (the producer warp does not join it)
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(THREADS) : "memory");
}

// one phase-1 unit: a lane's 8 elements p of group g of a region's row
// (zeros past A) scored against every query, reduced over the warp and
// added to that region's scores e[q * M]; bw and the unit are uniform over
// the warp, so every lane takes the same branches and joins every shuffle
template <typename T>
__device__ __forceinline__ void score_unit(const Vec<T>& p, const T* sh_w,
                                           const T* sh_h, int Ap, int g,
                                           int AG, int bw,
                                           const unsigned short* tabl,
                                           float* e, int M, int lane) {
  float s[MAX_BW];
#pragma unroll
  for (int q = 0; q < MAX_BW; ++q) s[q] = 0.f;
  if (g < AG) {
    Vec<T> wv;
    wv.load_shared(sh_w + g * VEC);
#pragma unroll
    for (int q = 0; q < MAX_BW; ++q) {
      if (q < bw) {
        Vec<T> hv;
        hv.load_shared(sh_h + q * Ap + g * VEC);
        s[q] = Ops<T>::score(p, hv, wv, tabl);
      }
    }
  }
#pragma unroll
  for (int q = 0; q < MAX_BW; ++q) {
    if (q < bw) {
      const float t = warp_sum(s[q]);
      if (lane == 0) atomicAdd(e + q * M, t);
    }
  }
}

// acc[q][:] = sum over m of round(att[m, 8g:8g+8] * wt[q, m])
template <typename TA>
__device__ __forceinline__ void weighted_sum(const TA* ar, const float* sh_e,
                                             int g, int M, int H, int bw,
                                             bool vec,
                                             float (&acc)[MAX_BW][VEC]) {
  const int c0 = g * VEC;
#pragma unroll
  for (int q = 0; q < MAX_BW; ++q)
#pragma unroll
    for (int j = 0; j < VEC; ++j) acc[q][j] = 0.f;
  for (int m = 0; m < M; m += ROWS) {
    Vec<TA> a[ROWS];
#pragma unroll
    for (int u = 0; u < ROWS; ++u) {
      if (m + u < M)
        a[u].load(ar + (long)(m + u) * H + c0, H - c0, vec);
      else
        a[u].zero();
    }
#pragma unroll
    for (int u = 0; u < ROWS; ++u) {
      if (m + u < M) {
#pragma unroll
        for (int q = 0; q < MAX_BW; ++q)
          if (q < bw)
            Ops<TA>::accumulate(a[u], sh_e[q * M + m + u], acc[q]);
      }
    }
  }
}

// The direct kernel, for the shapes the ring kernel does not take: a
// persistent grid walking the images, operands loaded by each thread
// (16-byte vectors where rows and pointers allow, else element loads), a
// unit's loads issued a unit ahead, ROWS att rows of loads in flight.
template <typename T, typename TA>
__global__ void __launch_bounds__(THREADS, DIRECT_BLOCKS_PER_SM)
additive_attention_kernel(const T* __restrict__ att_h,
                          const TA* __restrict__ att,
                          const T* __restrict__ p_att,
                          const float* __restrict__ mask,
                          const T* __restrict__ w, const T* __restrict__ bp,
                          TA* __restrict__ out, int nb, int bw, int M, int H,
                          int A, int Ap, int G, int vec_p, int vec_a) {
  extern __shared__ __align__(128) unsigned char smem[];
  T* sh_h = reinterpret_cast<T*>(smem);                  // [bw, Ap] queries
  T* sh_w = sh_h + bw * Ap;                              // [Ap]
  float* sh_e = reinterpret_cast<float*>(sh_w + Ap);     // [bw, M]
  unsigned short* tab = reinterpret_cast<unsigned short*>(sh_e + bw * M);
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const int AG = Ap / VEC;                       // 8-element groups of A
  const int S = (AG + SLICE_GROUPS - 1) / SLICE_GROUPS;
  const int units = M * S;

  if (sizeof(T) == 2) fill_tanh_table(tab);
  for (int i = tid; i < Ap; i += THREADS)
    sh_w[i] = i < A ? w[i] : Ops<T>::from_float(0.f);
  const float bias = Ops<T>::to_float(bp[0]);

  for (long b = blockIdx.x; b < nb; b += gridDim.x) {
    const T* hq = att_h + b * bw * A;
    for (int i = tid; i < bw * Ap; i += THREADS) {
      const int q = i / Ap, a = i - q * Ap;
      sh_h[i] = a < A ? hq[q * A + a] : Ops<T>::from_float(0.f);
    }
    for (int i = tid; i < bw * M; i += THREADS) sh_e[i] = 0.f;
    __syncthreads();

    // 1. scores: unit u is region u / S, groups (u % S) * 32 + lane of A,
    // its loads issued a unit ahead
    const T* pr = p_att + b * M * A;
    Vec<T> pcur, pnext;
    pcur.zero();
    pnext.zero();
    auto load_unit = [&](int u, Vec<T>& p) {
      const int g = (u % S) * SLICE_GROUPS + lane;
      if (g < AG)
        p.load(pr + (long)(u / S) * A + g * VEC, A - g * VEC, vec_p);
      else
        p.zero();
    };
    if (warp < units) load_unit(warp, pcur);
    for (int u = warp; u < units; u += WARPS) {
      if (u + WARPS < units) load_unit(u + WARPS, pnext);
      score_unit<T>(pcur, sh_w, sh_h, Ap, (u % S) * SLICE_GROUPS + lane, AG,
                    bw, tab + lane % TAB_COPIES, sh_e + u / S, M, lane);
      pcur = pnext;
    }
    __syncthreads();

    // 2. softmax, mask, renormalise
    softmax_rows<TA>(sh_e, nullptr, 0, mask + b * M, bias, bw, M, warp,
                     lane);
    __syncthreads();

    // 3. weighted sum: att[b] is read once for all bw queries
    const TA* ar = att + b * M * H;
    TA* orow = out + b * bw * H;
    float acc[MAX_BW][VEC];
    for (int g = tid; g < G; g += THREADS) {
      weighted_sum<TA>(ar, sh_e, g, M, H, bw, vec_a, acc);
#pragma unroll
      for (int q = 0; q < MAX_BW; ++q)
        if (q < bw)
          store8(orow + (long)q * H + g * VEC, acc[q], H - g * VEC, vec_a);
    }
    __syncthreads();   // sh_h and sh_e are the next image's
  }
}

// phase 1 of the ring kernel, one unit: as score_unit, for BW queries known
// at compile time, so that the queries' arithmetic and their shuffle
// reductions interleave (no branch between them); the sums go to the
// unit's partials part[q * qstride] (no atomics: phase 2 adds a region's
// partials in order)
template <typename T, int BW>
__device__ __forceinline__ void score_unit_bw(const Vec<T>& p, const T* sh_w,
                                              const T* hq, int A, int g,
                                              int AG,
                                              const unsigned short* tabl,
                                              float* part, int qstride,
                                              int lane) {
  float s[BW];
#pragma unroll
  for (int q = 0; q < BW; ++q) s[q] = 0.f;
  if (g < AG) {
    Vec<T> wv;
    wv.load_shared(sh_w + g * VEC);
#pragma unroll
    for (int q = 0; q < BW; ++q) {
      Vec<T> hv;
      hv.load_shared(hq + q * A + g * VEC);
      s[q] = Ops<T>::score(p, hv, wv, tabl);
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
#pragma unroll
    for (int q = 0; q < BW; ++q) s[q] += __shfl_xor_sync(0xffffffffu, s[q], o);
  if (lane == 0) {
#pragma unroll
    for (int q = 0; q < BW; ++q) part[q * qstride] = s[q];
  }
}

// The ring kernel, for rows of whole 16-byte multiples (A a multiple of 8,
// H of 16 bytes and at most 4 columns a consumer thread), every tensor on
// a 16-byte boundary, and BW queries an image known at compile time.  Warp
// 8 is the producer: one lane streams, for each of the block's images in
// turn, its BW query rows (into a 2-deep buffer), then p_att[b] and att[b]
// in stages of whole regions (8 KB at most), by bulk async copies into the
// ring, each stage completed on its mbarrier and released by the 8
// consumer warps.  Warps 0-7 consume: phase 1 scores each p stage (units
// dealt round-robin across stages), phase 2 as above, phase 3 gives each
// thread 4 columns of each att stage.  The producer runs up to the ring's
// depth ahead, across images: the att stream goes on under the score work.
template <typename T, typename TA, int BW>
__global__ void __launch_bounds__(RING_THREADS, RING_BLOCKS_PER_SM)
additive_attention_ring(const T* __restrict__ att_h,
                        const TA* __restrict__ att,
                        const T* __restrict__ p_att,
                        const float* __restrict__ mask,
                        const T* __restrict__ w, const T* __restrict__ bp,
                        TA* __restrict__ out, int nb, int M, int H, int A,
                        int rows_p, int rows_a, int stages) {
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);    // [stages]
  uint64_t* empty = full + RING_MAX_STAGES;               // [stages]
  uint64_t* qfull = empty + RING_MAX_STAGES;              // [2]
  uint64_t* qempty = qfull + 2;                           // [2]
  unsigned char* ring = smem + RING_BARS;
  T* sh_h = reinterpret_cast<T*>(ring + stages * STAGE_BYTES);  // [2, BW, A]
  T* sh_w = sh_h + 2 * BW * A;                            // [A]
  const int AG = A / VEC;
  const int S = (AG + SLICE_GROUPS - 1) / SLICE_GROUPS;
  float* sh_e = reinterpret_cast<float*>(sh_w + A);       // [BW, M]
  float* part = sh_e + BW * M;                            // [BW, M, S]
  unsigned short* tab = reinterpret_cast<unsigned short*>(part + BW * M * S);
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const uint32_t prow = sizeof(T) * A, arow = sizeof(TA) * H;

  if (tid == 0) {
    for (int i = 0; i < stages; ++i) {
      mbar_init(full + i, 1);
      mbar_init(empty + i, WARPS);
    }
    for (int i = 0; i < 2; ++i) {
      mbar_init(qfull + i, 1);
      mbar_init(qempty + i, WARPS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if (sizeof(T) == 2) fill_tanh_table(tab);
  for (int i = tid; i < A; i += RING_THREADS) sh_w[i] = w[i];
  const float bias = Ops<T>::to_float(bp[0]);
  __syncthreads();

  if (warp == WARPS) {
    if (lane == 0) {
      uint32_t seq = 0;
      int n = 0;
      // one stage: wait for its last use to be released, then fill it
      auto stage = [&](const void* src, uint32_t bytes) {
        const int st = seq % stages;
        if (seq >= (uint32_t)stages)
          mbar_wait(empty + st, (seq / stages - 1) & 1);
        mbar_expect_tx(full + st, bytes);
        bulk_copy(ring + st * STAGE_BYTES, src, bytes, full + st);
        ++seq;
      };
      for (long b = blockIdx.x; b < nb; b += gridDim.x, ++n) {
        const int qs = n & 1;
        if (n >= 2) mbar_wait(qempty + qs, (n / 2 - 1) & 1);
        mbar_expect_tx(qfull + qs, BW * prow);
        bulk_copy(sh_h + qs * BW * A, att_h + b * BW * A, BW * prow,
                  qfull + qs);
        for (int m0 = 0; m0 < M; m0 += rows_p)
          stage(p_att + (b * M + m0) * A, min(rows_p, M - m0) * prow);
        for (int m0 = 0; m0 < M; m0 += rows_a)
          stage(att + (b * M + m0) * H, min(rows_a, M - m0) * arow);
      }
    }
    return;
  }

  const unsigned short* tabl = tab + lane % TAB_COPIES;
  uint32_t seq = 0;
  int n = 0;
  int turn = 0;         // phase-1 units dealt so far, mod WARPS
  for (long b = blockIdx.x; b < nb; b += gridDim.x, ++n) {
    const int qs = n & 1;
    const T* hq = sh_h + qs * BW * A;
    mbar_wait(qfull + qs, (n / 2) & 1);

    // 1. scores, stage by stage
    for (int m0 = 0; m0 < M; m0 += rows_p, ++seq) {
      const int st = seq % stages;
      mbar_wait(full + st, (seq / stages) & 1);
      const T* pc = reinterpret_cast<const T*>(ring + st * STAGE_BYTES);
      const int units = min(rows_p, M - m0) * S;
      for (int u = (warp - turn + WARPS) % WARPS; u < units; u += WARPS) {
        const int r = u / S, sl = u - r * S;
        const int g = sl * SLICE_GROUPS + lane;
        Vec<T> p;
        if (g < AG)
          p.load_shared(pc + r * A + g * VEC);
        else
          p.zero();
        score_unit_bw<T, BW>(p, sh_w, hq, A, g, AG, tabl,
                             part + (m0 + r) * S + sl, M * S, lane);
      }
      turn = (turn + units) % WARPS;
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + st);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(qempty + qs);
    consumers_sync();

    // 2. softmax, mask, renormalise
    softmax_rows<TA>(sh_e, part, S, mask + b * M, bias, BW, M, warp, lane);
    consumers_sync();

    // 3. weighted sum: thread tid owns columns 4 tid .. 4 tid + 3
    float acc[BW][4];
#pragma unroll
    for (int q = 0; q < BW; ++q)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[q][j] = 0.f;
    const int c0 = 4 * tid;
    for (int m0 = 0; m0 < M; m0 += rows_a, ++seq) {
      const int st = seq % stages;
      mbar_wait(full + st, (seq / stages) & 1);
      const TA* ac = reinterpret_cast<const TA*>(ring + st * STAGE_BYTES);
      const int rows = min(rows_a, M - m0);
      if (c0 < H) {
#pragma unroll 2
        for (int r = 0; r < rows; ++r) {
          const auto v = load4(ac + r * H + c0);
          float wt[BW];
#pragma unroll
          for (int q = 0; q < BW; ++q) wt[q] = sh_e[q * M + m0 + r];
#pragma unroll
          for (int q = 0; q < BW; ++q) accumulate4(v, wt[q], acc[q]);
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + st);
    }
    if (c0 < H) {
#pragma unroll
      for (int q = 0; q < BW; ++q) store4(out + (b * BW + q) * H + c0, acc[q]);
    }
    consumers_sync();   // sh_e is the next image's
  }
}

__global__ void tanh_table_kernel(const unsigned short* __restrict__ x,
                                  unsigned short* __restrict__ y, int n) {
  __shared__ unsigned short tab[TAB_N * TAB_COPIES];
  fill_tanh_table(tab);
  __syncthreads();
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n)
    y[i] = (unsigned short)tanh2(x[i], tab + threadIdx.x % TAB_COPIES);
}

template <typename Kernel>
int grid_for(Kernel kernel, int threads, size_t smem, int nb, int* grid) {
  cudaError_t e = cudaSuccess;
  if (smem > 48 * 1024)
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  int dev = 0, sms = 0, per_sm = 0;
  if (e == cudaSuccess) e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                       threads, smem);
  if (e != cudaSuccess) return (int)e;
  if (per_sm < 1) return (int)cudaErrorInvalidValue;
  *grid = nb < per_sm * sms ? nb : per_sm * sms;
  return 0;
}

template <typename T, typename TA, int BW>
int launch_ring(const void* att_h, const void* att, const void* p_att,
                const void* mask, const void* w, const void* b, void* out,
                int nb, int M, int H, int A, int stages, size_t smem,
                cudaStream_t stream) {
  auto kernel = additive_attention_ring<T, TA, BW>;
  int grid = 0;
  const int rc = grid_for(kernel, RING_THREADS, smem, nb, &grid);
  if (rc) return rc;
  kernel<<<grid, RING_THREADS, smem, stream>>>(
      static_cast<const T*>(att_h), static_cast<const TA*>(att),
      static_cast<const T*>(p_att), static_cast<const float*>(mask),
      static_cast<const T*>(w), static_cast<const T*>(b),
      static_cast<TA*>(out), nb, M, H, A,
      (int)(STAGE_BYTES / (sizeof(T) * A)),
      (int)(STAGE_BYTES / (sizeof(TA) * H)), stages);
  return (int)cudaGetLastError();
}

template <typename T, typename TA>
int launch(const void* att_h, const void* att, const void* p_att,
           const void* mask, const void* w, const void* b, void* out, int nb,
           int bw, int M, int H, int A, cudaStream_t stream) {
  const auto aligned = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  const size_t prow = sizeof(T) * (size_t)A, arow = sizeof(TA) * (size_t)H;
  const size_t S = (A / VEC + SLICE_GROUPS - 1) / SLICE_GROUPS;
  const size_t rest = RING_BARS + sizeof(T) * (size_t)(2 * bw + 1) * A +
                      sizeof(float) * (size_t)bw * M * (1 + S) +
                      (sizeof(T) == 2 ? TAB_BYTES : 0);
  const size_t room = SM_SMEM / RING_BLOCKS_PER_SM - BLOCK_RESERVED;
  int stages = rest < room ? (int)((room - rest) / STAGE_BYTES) : 0;
  stages = stages < 2 ? 2 : stages > RING_MAX_STAGES ? RING_MAX_STAGES : stages;
  const size_t ring_smem = rest + (size_t)stages * STAGE_BYTES;
  if (A % VEC == 0 && A > 0 && arow % 16 == 0 && H > 0 &&
      H <= RING_MAX_H && prow <= STAGE_BYTES && arow <= STAGE_BYTES &&
      ring_smem <= MAX_SMEM && aligned(att_h) && aligned(p_att) &&
      aligned(att) && aligned(out)) {
#define AA_RING(BW)                                                        \
  case BW:                                                                 \
    return launch_ring<T, TA, BW>(att_h, att, p_att, mask, w, b, out, nb, \
                                  M, H, A, stages, ring_smem, stream);
    switch (bw) {
      AA_RING(1) AA_RING(2) AA_RING(3) AA_RING(4)
      AA_RING(5) AA_RING(6) AA_RING(7) AA_RING(8)
    }
#undef AA_RING
  }
  int grid = 0, rc = 0;
  const int Ap = (A + VEC - 1) / VEC * VEC;
  const int G = (H + VEC - 1) / VEC;
  const size_t smem = sizeof(T) * (size_t)(bw + 1) * Ap +
                      sizeof(float) * (size_t)bw * M +
                      (sizeof(T) == 2 ? TAB_BYTES : 0);
  if (smem > MAX_SMEM) return (int)cudaErrorInvalidValue;
  auto kernel = additive_attention_kernel<T, TA>;
  if ((rc = grid_for(kernel, THREADS, smem, nb, &grid))) return rc;
  const int vec_p = A % VEC == 0 && aligned(p_att);
  const int vec_a = H % VEC == 0 && aligned(att) && aligned(out);
  kernel<<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(att_h), static_cast<const TA*>(att),
      static_cast<const T*>(p_att), static_cast<const float*>(mask),
      static_cast<const T*>(w), static_cast<const T*>(b),
      static_cast<TA*>(out), nb, bw, M, H, A, Ap, G, vec_p, vec_a);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int additive_attention(void* att_h, void* att, void* p_att,
                                  void* mask, void* w, void* b, void* out,
                                  int nb, int bw, int M, int H, int A,
                                  int dtype, int att_dtype, void* stream) {
  if (bw < 1 || bw > MAX_BW || nb < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && att_dtype == 0)
    return launch<float, float>(att_h, att, p_att, mask, w, b, out, nb, bw,
                                M, H, A, s);
  if (dtype == 1 && att_dtype == 1)
    return launch<bf16, bf16>(att_h, att, p_att, mask, w, b, out, nb, bw, M,
                              H, A, s);
  if (dtype == 1 && att_dtype == 0)
    return launch<bf16, float>(att_h, att, p_att, mask, w, b, out, nb, bw, M,
                               H, A, s);
  return (int)cudaErrorInvalidValue;
}

// The bf16 tanh rule of the kernel above (the table and its bounds) on n
// bf16 values: y = round_bf16(tanhf(x)) bit for bit, which chip_smoke.py
// checks over all 65,536 inputs.
extern "C" int additive_attention_tanh(void* x, void* y, int n,
                                       void* stream) {
  if (n < 1) return (int)cudaErrorInvalidValue;
  tanh_table_kernel<<<(n + THREADS - 1) / THREADS, THREADS, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const unsigned short*>(x), static_cast<unsigned short*>(y),
      n);
  return (int)cudaGetLastError();
}
