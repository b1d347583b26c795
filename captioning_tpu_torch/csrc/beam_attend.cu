// Fused write + ancestry attend over merged-lane decode caches (sm_90a).
//
// Replaces captioning_tpu/ops/beam_attend.py:_wa_kernel; the Python
// wrapper and the plain twin are in ops/beam_attend.py.
//
// Bound on the H100: bytes.  A step reads, per row and head, the t0 + 1
// entries of K and V its ancestry selects (2 x 128 bytes each at dk 64 in
// bf16) against ~4 FLOP a byte: at N 5120, Tp 24, t0 10, bw 5 the call
// must move ~102 MB, 0.031 ms at 3.35 TB/s.
//
// The previous design (one warp per (row, head), 4 bytes a lane) walked
// the time steps as a serial chain: load anc[r, j], then the K/V load that
// depends on it, a 5-shuffle reduction and the online-softmax update,
// before the next step's address was known: ~256 bytes in flight a warp,
// 0.85 TB/s.
//
// This design is about memory-level parallelism.  Still one warp per
// (row, head) (8 warps a block: with 8 heads a block is one row, whose
// anc row the 8 warps read from one cache line), but:
// - the row's ancestry is loaded once per 32 time steps, one coalesced
//   4-byte load a lane, and handed to the lanes that need it by
//   __shfl_sync;
// - the warp splits into groups of G lanes, each lane holding one VB-byte
//   vector of the head (G = 8 lanes x 16 bytes = a 64-wide bf16 head
//   entry), so a warp pass covers P = 32 / G time steps;
// - all K and V loads of a chunk of P * NB steps (16 at G = 8: every step
//   j <= t0 when t0 < 16, the timed decode step's case) are issued before
//   any is consumed, NB = 4 vectors of each a lane, so that 3 blocks of 8
//   warps fit an SM at 80 registers.  On the H100 at N 5120, Tp 24, t0 10
//   each of these ran slower: K and V of 8 steps a group (125 registers,
//   fewer warps), a K pass then a V pass over 32 steps (two waits on
//   memory), all K of 32 steps first with V beside them up to 16 steps
//   (spills at 80 registers);
// - each score is reduced inside its group (log2 G shuffles), rounded to
//   the element type after the 1/sqrt(dk) scale, and gathered into lane
//   (j - j0) by shuffle;
// - the softmax is online at chunk granularity (one max and one sum over
//   the warp a chunk), in float32;
// - each group accumulates p_j v_j over its own steps; the groups are
//   combined once at the end (log2 P shuffles an element).
// At j == t0 the entry is read from k_new / v_new, which the warp also
// stores at [r, t0]: anc[r, t0] is the row's own slot, so no other row
// reads that entry in the same launch.
//
// Layouts: q, k_new, v_new, ctx [N, D]; k, v [N, Tp, D]; anc [N, Tp] int32
// (null when bw == 1: each row is its own block).  Element type float32 or
// bfloat16 (dtype 0 / 1); the head's bytes dk * size a multiple of the
// vector width VB (16, 8 or 4 bytes, the widest that divides them), the
// tensors VB-aligned.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int WARPS_PER_BLOCK = 8;
constexpr int MAX_LOADS = 4;       // vectors of K and of V a lane holds

template <int VB>
struct Vec {
  uint32_t w[VB / 4];
};

template <int VB>
__device__ __forceinline__ Vec<VB> vload(const void* p) {
  Vec<VB> r;
  if constexpr (VB == 16) {
    const uint4 x = *reinterpret_cast<const uint4*>(p);
    r.w[0] = x.x; r.w[1] = x.y; r.w[2] = x.z; r.w[3] = x.w;
  } else if constexpr (VB == 8) {
    const uint2 x = *reinterpret_cast<const uint2*>(p);
    r.w[0] = x.x; r.w[1] = x.y;
  } else {
    r.w[0] = *reinterpret_cast<const uint32_t*>(p);
  }
  return r;
}

template <int VB>
__device__ __forceinline__ void vstore(void* p, const Vec<VB>& r) {
  if constexpr (VB == 16) {
    *reinterpret_cast<uint4*>(p) = make_uint4(r.w[0], r.w[1], r.w[2], r.w[3]);
  } else if constexpr (VB == 8) {
    *reinterpret_cast<uint2*>(p) = make_uint2(r.w[0], r.w[1]);
  } else {
    *reinterpret_cast<uint32_t*>(p) = r.w[0];
  }
}

// element e of a vector as float, and the vector of VB / sizeof(T) floats
// rounded to T
template <typename T> struct Elem;
template <> struct Elem<float> {
  template <int VB>
  __device__ static float get(const Vec<VB>& r, int e) {
    return __uint_as_float(r.w[e]);
  }
  template <int VB>
  __device__ static Vec<VB> pack(const float* f) {
    Vec<VB> r;
#pragma unroll
    for (int e = 0; e < VB / 4; ++e) r.w[e] = __float_as_uint(f[e]);
    return r;
  }
  __device__ static float round(float x) { return x; }
};
template <> struct Elem<__nv_bfloat16> {
  template <int VB>
  __device__ static float get(const Vec<VB>& r, int e) {
    const uint32_t w = r.w[e / 2];
    return __uint_as_float(e % 2 ? w & 0xffff0000u : w << 16);
  }
  template <int VB>
  __device__ static Vec<VB> pack(const float* f) {
    Vec<VB> r;
#pragma unroll
    for (int e = 0; e < VB / 4; ++e) {
      const __nv_bfloat162 p = __floats2bfloat162_rn(f[2 * e], f[2 * e + 1]);
      r.w[e] = *reinterpret_cast<const uint32_t*>(&p);
    }
    return r;
  }
  __device__ static float round(float x) {
    return __bfloat162float(__float2bfloat16_rn(x));
  }
};

__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// VB-byte vectors, NV of them a lane (the head is nvec = dk * size / VB
// vectors: lane slot s of its group holds vectors s + G * v, v < NV)
template <typename T, int VB, int NV>
__global__ void __launch_bounds__(32 * WARPS_PER_BLOCK, 3)
attend_write_kernel(const T* __restrict__ q, T* __restrict__ k,
                    T* __restrict__ v, const T* __restrict__ k_new,
                    const T* __restrict__ v_new, const int* __restrict__ anc,
                    T* __restrict__ ctx, int N, int Tp, int D, int h, int bw,
                    int t0, int G) {
  constexpr int VE = VB / sizeof(T);           // elements a vector
  constexpr int NB = MAX_LOADS / NV;           // steps a group per chunk
  const int warp = blockIdx.x * WARPS_PER_BLOCK + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (warp >= N * h) return;
  const int r = warp / h;
  const int head = warp % h;
  const int dk = D / h;
  const int P = 32 / G;                        // steps a warp pass
  const int grp = lane / G, slot = lane % G;
  const int CH = min(32, P * NB);              // steps a chunk (divides 32)
  const int blk0 = (r / bw) * bw;
  const long row_d = (long)r * D + head * dk;
  // sqrt(dk) rounded to T, as the twin computes it in the compute dtype
  const float scale = Elem<T>::round(sqrtf((float)dk));

  float qf[NV][VE], acc[NV][VE];
#pragma unroll
  for (int u = 0; u < NV; ++u) {
    const int e = (slot + G * u) * VE;
#pragma unroll
    for (int x = 0; x < VE; ++x) qf[u][x] = acc[u][x] = 0.f;
    if (e < dk) {
      const Vec<VB> qv = vload<VB>(q + row_d + e);
#pragma unroll
      for (int x = 0; x < VE; ++x) qf[u][x] = Elem<T>::get(qv, x);
      if (grp == 0) {
        // the step's entry, at this row's own slot
        const long dst = ((long)r * Tp + t0) * D + head * dk + e;
        vstore<VB>(k + dst, vload<VB>(k_new + row_d + e));
        vstore<VB>(v + dst, vload<VB>(v_new + row_d + e));
      }
    }
  }

  float m = -INFINITY, l = 0.f;
  int a = 0;
  for (int j0 = 0; j0 <= t0; j0 += CH) {
    const int cnt = min(CH, t0 + 1 - j0);      // steps of this chunk
    // the ancestry of 32 steps at a time, lane L holding anc[r, w0 + L]
    // (j < t0 only)
    const int w0 = j0 & ~31;
    if (j0 == w0) {
      a = 0;
      if (bw > 1 && w0 + lane < t0) a = anc[(long)r * Tp + w0 + lane];
    }
    // group grp takes steps j0 + grp + P * i: the source row of each (-1:
    // the new entry, read from k_new / v_new), then every K and V load of
    // the chunk before any is consumed
    int src[NB];
    Vec<VB> kv[NB][NV], vv[NB][NV];
#pragma unroll
    for (int i = 0; i < NB; ++i) {
      const int jl = grp + P * i, j = j0 + jl;
      const int s = __shfl_sync(0xffffffffu, a, (j - w0) & 31);
      // an out-of-range sibling selects nothing (the twin's one-hot mask)
      const bool take = jl < cnt && (j == t0 || (s >= 0 && s < bw));
      src[i] = !take ? -2 : j == t0 ? -1 : blk0 + s;
#pragma unroll
      for (int u = 0; u < NV; ++u) {
        const int e = (slot + G * u) * VE;
#pragma unroll
        for (int x = 0; x < VB / 4; ++x) kv[i][u].w[x] = vv[i][u].w[x] = 0u;
        if (take && e < dk) {
          kv[i][u] = vload<VB>(
              src[i] < 0 ? k_new + row_d + e
                         : k + ((long)src[i] * Tp + j) * D + head * dk + e);
          vv[i][u] = vload<VB>(
              src[i] < 0 ? v_new + row_d + e
                         : v + ((long)src[i] * Tp + j) * D + head * dk + e);
        }
      }
    }
    // scores: group sums, gathered so that lane L holds step j0 + L
    float sc = -INFINITY;
#pragma unroll
    for (int i = 0; i < NB; ++i) {
      if (P * i >= cnt) break;                 // warp-uniform
      float part = 0.f;
#pragma unroll
      for (int u = 0; u < NV; ++u)
#pragma unroll
        for (int x = 0; x < VE; ++x)
          part = fmaf(qf[u][x], Elem<T>::get(kv[i][u], x), part);
      for (int o = 1; o < G; o <<= 1)
        part += __shfl_xor_sync(0xffffffffu, part, o);
      const float s_i =
          src[i] > -2 ? Elem<T>::round(part / scale) : -INFINITY;
      const float y = __shfl_sync(0xffffffffu, s_i, (lane % P) * G);
      if (lane / P == i && lane < cnt) sc = y;
    }
    // online softmax, one update a chunk
    const float mn = fmaxf(m, warp_max(sc));
    const float base = mn == -INFINITY ? 0.f : mn;
    const float p = expf(sc - base);           // 0 where sc = -inf
    const float alpha = expf(m - base);        // 0 on the first update
    l = l * alpha + warp_sum(p);
    m = mn;
#pragma unroll
    for (int u = 0; u < NV; ++u)
#pragma unroll
      for (int x = 0; x < VE; ++x) acc[u][x] *= alpha;
    // each group's weighted sum over its steps
#pragma unroll
    for (int i = 0; i < NB; ++i) {
      if (P * i >= cnt) break;                 // warp-uniform
      const float pj = __shfl_sync(0xffffffffu, p, (grp + P * i) & 31);
      if (src[i] > -2) {
#pragma unroll
        for (int u = 0; u < NV; ++u)
#pragma unroll
          for (int x = 0; x < VE; ++x)
            acc[u][x] = fmaf(pj, Elem<T>::get(vv[i][u], x), acc[u][x]);
      }
    }
  }
  // combine the groups (lanes of one slot), group 0 writes
#pragma unroll
  for (int u = 0; u < NV; ++u)
#pragma unroll
    for (int x = 0; x < VE; ++x)
      for (int o = G; o < 32; o <<= 1)
        acc[u][x] += __shfl_xor_sync(0xffffffffu, acc[u][x], o);
  if (grp == 0) {
    const float inv = 1.f / l;
#pragma unroll
    for (int u = 0; u < NV; ++u) {
      const int e = (slot + G * u) * VE;
      if (e < dk) {
        float o[VE];
#pragma unroll
        for (int x = 0; x < VE; ++x) o[x] = acc[u][x] * inv;
        vstore<VB>(ctx + row_d + e, Elem<T>::template pack<VB>(o));
      }
    }
  }
}

template <typename T, int VB, int NV>
void launch(void* q, void* k, void* v, void* k_new, void* v_new,
            const void* anc, void* ctx, int N, int Tp, int D, int h, int bw,
            int t0, int G, cudaStream_t stream) {
  const int warps = N * h;
  const int blocks = (warps + WARPS_PER_BLOCK - 1) / WARPS_PER_BLOCK;
  attend_write_kernel<T, VB, NV><<<blocks, 32 * WARPS_PER_BLOCK, 0, stream>>>(
      static_cast<const T*>(q), static_cast<T*>(k), static_cast<T*>(v),
      static_cast<const T*>(k_new), static_cast<const T*>(v_new),
      static_cast<const int*>(anc), static_cast<T*>(ctx), N, Tp, D, h, bw,
      t0, G);
}

template <typename T, int VB>
int dispatch_nv(void* q, void* k, void* v, void* k_new, void* v_new,
                const void* anc, void* ctx, int N, int Tp, int D, int h,
                int bw, int t0, cudaStream_t s) {
  const int nvec = (D / h) * (int)sizeof(T) / VB;
  int G = 1;
  while (G < nvec && G < 32) G *= 2;
  if (nvec <= 32)
    launch<T, VB, 1>(q, k, v, k_new, v_new, anc, ctx, N, Tp, D, h, bw, t0, G,
                     s);
  else if (nvec <= 64)
    launch<T, VB, 2>(q, k, v, k_new, v_new, anc, ctx, N, Tp, D, h, bw, t0, G,
                     s);
  else if (nvec <= 128)
    launch<T, VB, 4>(q, k, v, k_new, v_new, anc, ctx, N, Tp, D, h, bw, t0, G,
                     s);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(void* q, void* k, void* v, void* k_new, void* v_new,
             const void* anc, void* ctx, int N, int Tp, int D, int h, int bw,
             int t0, cudaStream_t s) {
  const int bytes = (D / h) * (int)sizeof(T);
  if (bytes % 16 == 0)
    return dispatch_nv<T, 16>(q, k, v, k_new, v_new, anc, ctx, N, Tp, D, h,
                              bw, t0, s);
  if (bytes % 8 == 0)
    return dispatch_nv<T, 8>(q, k, v, k_new, v_new, anc, ctx, N, Tp, D, h,
                             bw, t0, s);
  if (bytes % 4 == 0)
    return dispatch_nv<T, 4>(q, k, v, k_new, v_new, anc, ctx, N, Tp, D, h,
                             bw, t0, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" int attend_write_merged(void* q, void* k, void* v, void* k_new,
                                   void* v_new, void* anc, void* ctx, int N,
                                   int Tp, int D, int h, int bw, int t0,
                                   int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (h < 1 || D % h || t0 < 0 || t0 >= Tp) return (int)cudaErrorInvalidValue;
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(q, k, v, k_new, v_new, anc, ctx, N, Tp, D,
                                   h, bw, t0, s);
  return dispatch<float>(q, k, v, k_new, v_new, anc, ctx, N, Tp, D, h, bw,
                         t0, s);
}
