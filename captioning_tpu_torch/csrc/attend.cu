// Decode-step attend over a strided K/V cache (sm_90a): one kernel behind
// three entry points.
//
// Replaces three TPU kernels; the Python wrappers and the plain twins are
// in ops/beam_attend.py (attend_merged), ops/mha_step.py (mha_step_fused)
// and ops/anc_attend.py (anc_attend):
//   attend_merged  <- captioning_tpu/ops/beam_attend.py:_attend_kernel
//                     (merged [N, T, D] caches, ancestry, no write);
//   mha_step       <- captioning_tpu/ops/mha_step.py:_mha_kernel
//                     (head-major [N, h, T, dk] caches, K/V written at t,
//                     each row attends over its own slot);
//   anc_attend     <- captioning_tpu/ops/anc_attend.py:_kernel
//                     (layer l of a stacked [N, L, h, T, dk] cache read in
//                     place, ancestry, no write).
//
// All three compute one thing: for each row r and head, softmax over the
// cached entries at times j <= t of q . k / sqrt(dk), then the weighted
// sum of v.  They differ in the cache layout, which is only the element
// strides (row, head, time) of an entry; whether the step's entry is
// written first; and whether time j reads the ancestor slot
// blk*bw + anc[r, j] of the row's block of bw rows or the row's own slot.
//
// What bounds it: bytes.  Per (row, head) the kernel reads t + 1 entries of
// dk elements of K and of V and does 4 * dk operations on each, far below
// the card's ~295 operations a byte.  The TPU kernels scored every sibling
// of the block and masked all but the ancestor, reading bw times the
// entries, because a TPU has no row gather; here each row gathers its
// ancestor's entries only.
//
// The first design (a warp per (row, head)) walked the steps as a serial
// chain: load anc[r, j], then the K/V load that depends on it, a 5-shuffle
// reduction and the softmax update, before the next step's address was
// known: 4 bytes a lane in flight, 0.62-0.95 TB/s.  csrc/beam_attend.cu's
// design over these strides (ancestry preloaded, 8-lane groups of 16-byte
// vectors taking 4 steps a pass, every load of a 16-step chunk in flight)
// reached 1.6-1.9 TB/s, but kept a fixed cost of ~0.035 ms at t 0: 40960
// warps at the benches' shape, each with its own ancestry load, warp-wide
// softmax shuffles and a final combine of its groups.  So here a warp
// serves a row and all its heads (more warps a row only where one warp's
// lanes would need more than 4 vectors each):
// - lanes form groups of G, one group a head (G = 4 lanes x 2 vectors of 16
//   bytes = a 64-wide bf16 head, 8 heads a warp: the row's whole 1 KB
//   entry at D 512), so every group takes the same step;
// - the row's ancestry is loaded once per 32 steps, one coalesced 4-byte
//   load a lane, and a step's source row is handed out by one __shfl_sync,
//   uniform over the warp: one anc read a row, not h;
// - all K and V loads of a chunk of NB = 4 / NV steps are issued before
//   any is consumed (4 vectors of each a lane, 4 KB a warp in flight), at 2
//   blocks of 8 warps an SM (96 registers at the benches' width; 3 blocks'
//   80 spilled there and ran 0-3% slower);
// - each score is summed inside its group (log2 G shuffles); the group's
//   lanes keep its head's online softmax alike, in float32, with no
//   warp-wide reduction, and each lane's weighted sum is its own part of
//   the output;
// - mha_step: the steps before t come from the cache; then each lane loads
//   its vectors of k_new / v_new, stores them at [r, head, t] and folds
//   them in from registers (the cache entry is not read back).
// An out-of-range sibling selects nothing, as the twins' one-hot mask does.
//
// Rounding (bf16).  All three keep the softmax, p and the weighted sum in
// float32 and round only the output.  attend_merged rounds each scaled
// score to bf16, as the Pallas body (beam_attend.py:131) and its twin do,
// and divides by sqrt(dk) rounded to bf16, as the twin does (the Pallas
// body multiplies by the float32 1/sqrt(dk)); mha_step and anc_attend keep
// the scores in float32, as their Pallas bodies do.  The Pallas bodies of
// attend_merged and anc_attend round p (anc_attend: the unnormalised
// weights) to bf16 before the PV product (beam_attend.py:146,
// anc_attend.py:124), and all three twins round p; the kernel does not.
// Element type float32 or bfloat16 (dtype 0 / 1); the head width dk even
// and at most 256; the head's bytes a multiple of the vector width VB (16,
// 8 or 4 bytes, the widest that divides them) and the tensors VB-aligned.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int WARPS_PER_BLOCK = 8;
constexpr int MAX_LOADS = 4;       // vectors of K and of V a lane holds
constexpr int MAX_DK = 256;

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

// The cache: entry (row, head, time) starts at base + row * sN + head * sH
// + time * sT and holds dk contiguous elements.
struct Cache {
  long sN, sH, sT;
};

// q, out, k_new, v_new: [N, h * dk].  anc: [N, Tanc] int32, or null (each
// row reads its own slot).  WRITE: k_new / v_new written at time t of the
// row's own slot (mha_step).  ROUND: round the scale and the scaled scores
// to T.  G lanes a head (HPW = 32 / G heads a warp, WR = ceil(h / HPW)
// warps a row), each lane NV VB-byte vectors of its head: slot s of its
// group holds vectors s + G * u, u < NV, of the head's nvec = dk * size /
// VB.
template <typename T, int VB, int NV, bool ROUND, bool WRITE>
__global__ void __launch_bounds__(32 * WARPS_PER_BLOCK, 2)
attend_kernel(const T* __restrict__ q, T* __restrict__ k,
              T* __restrict__ v, const T* __restrict__ k_new,
              const T* __restrict__ v_new, const int* __restrict__ anc,
              T* __restrict__ out, Cache c, int N, int h, int dk, int Tanc,
              int bw, int t, int G) {
  constexpr int VE = VB / sizeof(T);           // elements a vector
  constexpr int NB = MAX_LOADS / NV;           // steps a chunk (divides 32)
  const int warp = blockIdx.x * WARPS_PER_BLOCK + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int HPW = 32 / G;
  const int WR = (h + HPW - 1) / HPW;
  if (warp >= N * WR) return;
  const int r = warp / WR;
  const int head = (warp % WR) * HPW + lane / G;
  const int slot = lane % G;
  const bool live = head < h;
  const int blk0 = (r / bw) * bw;
  const long row_d = (long)r * h * dk + (long)head * dk;
  const long hd = (long)head * c.sH;
  const float scale = ROUND ? Elem<T>::round(sqrtf((float)dk))
                            : sqrtf((float)dk);

  float qf[NV][VE], acc[NV][VE];
#pragma unroll
  for (int u = 0; u < NV; ++u) {
    const int e = (slot + G * u) * VE;
#pragma unroll
    for (int x = 0; x < VE; ++x) qf[u][x] = acc[u][x] = 0.f;
    if (live && e < dk) {
      const Vec<VB> qv = vload<VB>(q + row_d + e);
#pragma unroll
      for (int x = 0; x < VE; ++x) qf[u][x] = Elem<T>::get(qv, x);
    }
  }

  float m = -INFINITY, l = 0.f;
  int a = 0;
  // mha_step: the steps before t from the cache, step t from k_new / v_new
  const int last = WRITE ? t - 1 : t;
  for (int j0 = 0; j0 <= last; j0 += NB) {
    const int cnt = min(NB, last + 1 - j0);    // steps of this chunk
    // the ancestry of 32 steps at a time, lane L holding anc[r, w0 + L]
    const int w0 = j0 & ~31;
    if (anc != nullptr && j0 == w0)
      a = w0 + lane <= t ? anc[(long)r * Tanc + w0 + lane] : 0;
    // step j0 + i's source row (one for the whole warp), then every K and
    // V load of the chunk before any is consumed
    bool take[NB];
    Vec<VB> kv[NB][NV], vv[NB][NV];
#pragma unroll
    for (int i = 0; i < NB; ++i) {
      const int j = j0 + i;
      int src = r;
      take[i] = i < cnt;
      if (anc != nullptr) {
        const int s = __shfl_sync(0xffffffffu, a, (j - w0) & 31);
        // an out-of-range sibling selects nothing (the twins' one-hot mask)
        take[i] = take[i] && s >= 0 && s < bw;
        src = blk0 + s;
      }
      const long at = src * c.sN + hd + (long)j * c.sT;
#pragma unroll
      for (int u = 0; u < NV; ++u) {
        const int e = (slot + G * u) * VE;
#pragma unroll
        for (int x = 0; x < VB / 4; ++x) kv[i][u].w[x] = vv[i][u].w[x] = 0u;
        if (take[i] && live && e < dk) {
          kv[i][u] = vload<VB>(k + at + e);
          vv[i][u] = vload<VB>(v + at + e);
        }
      }
    }
    // each score summed over its head's group; the lanes of a group keep
    // the head's online softmax alike, one update a chunk, in float32
    float sc[NB];
    float mn = m;
#pragma unroll
    for (int i = 0; i < NB; ++i) {
      float part = 0.f;
#pragma unroll
      for (int u = 0; u < NV; ++u)
#pragma unroll
        for (int x = 0; x < VE; ++x)
          part = fmaf(qf[u][x], Elem<T>::get(kv[i][u], x), part);
      for (int o = 1; o < G; o <<= 1)
        part += __shfl_xor_sync(0xffffffffu, part, o);
      sc[i] = take[i] ? (ROUND ? Elem<T>::round(part / scale) : part / scale)
                      : -INFINITY;
      mn = fmaxf(mn, sc[i]);
    }
    const float base = mn == -INFINITY ? 0.f : mn;
    const float alpha = expf(m - base);
    l *= alpha;
#pragma unroll
    for (int u = 0; u < NV; ++u)
#pragma unroll
      for (int x = 0; x < VE; ++x) acc[u][x] *= alpha;
#pragma unroll
    for (int i = 0; i < NB; ++i) {
      const float p = expf(sc[i] - base);
      l += p;
#pragma unroll
      for (int u = 0; u < NV; ++u)
#pragma unroll
        for (int x = 0; x < VE; ++x)
          acc[u][x] = fmaf(p, Elem<T>::get(vv[i][u], x), acc[u][x]);
    }
    m = mn;
  }
  if constexpr (WRITE) {
    // the step's entry: stored at the row's own slot and folded in from
    // registers
    Vec<VB> kn[NV], vn[NV];
    float part = 0.f;
#pragma unroll
    for (int u = 0; u < NV; ++u) {
      const int e = (slot + G * u) * VE;
#pragma unroll
      for (int x = 0; x < VB / 4; ++x) kn[u].w[x] = vn[u].w[x] = 0u;
      if (live && e < dk) {
        kn[u] = vload<VB>(k_new + row_d + e);
        vn[u] = vload<VB>(v_new + row_d + e);
        const long dst = r * c.sN + hd + t * c.sT + e;
        vstore<VB>(k + dst, kn[u]);
        vstore<VB>(v + dst, vn[u]);
      }
#pragma unroll
      for (int x = 0; x < VE; ++x)
        part = fmaf(qf[u][x], Elem<T>::get(kn[u], x), part);
    }
    for (int o = 1; o < G; o <<= 1)
      part += __shfl_xor_sync(0xffffffffu, part, o);
    const float sc = part / scale;
    const float mn = fmaxf(m, sc);
    const float alpha = expf(m - mn), p = expf(sc - mn);
    l = l * alpha + p;
#pragma unroll
    for (int u = 0; u < NV; ++u)
#pragma unroll
      for (int x = 0; x < VE; ++x)
        acc[u][x] = fmaf(p, Elem<T>::get(vn[u], x), acc[u][x] * alpha);
  }
  const float inv = 1.f / l;
#pragma unroll
  for (int u = 0; u < NV; ++u) {
    const int e = (slot + G * u) * VE;
    if (live && e < dk) {
      float o[VE];
#pragma unroll
      for (int x = 0; x < VE; ++x) o[x] = acc[u][x] * inv;
      vstore<VB>(out + row_d + e, Elem<T>::template pack<VB>(o));
    }
  }
}

// The arguments every entry point passes down.
struct Args {
  const void* q;
  void* k;
  void* v;
  const void* k_new;
  const void* v_new;
  const void* anc;
  void* out;
  Cache c;
  int N, h, dk, Tanc, bw, t;
  cudaStream_t stream;
};

template <typename T, int VB, int NV, bool ROUND, bool WRITE>
int launch(const Args& a, int G) {
  const int hpw = 32 / G;
  const int warps = a.N * ((a.h + hpw - 1) / hpw);
  const int blocks = (warps + WARPS_PER_BLOCK - 1) / WARPS_PER_BLOCK;
  attend_kernel<T, VB, NV, ROUND, WRITE>
      <<<blocks, 32 * WARPS_PER_BLOCK, 0, a.stream>>>(
          static_cast<const T*>(a.q), static_cast<T*>(a.k),
          static_cast<T*>(a.v), static_cast<const T*>(a.k_new),
          static_cast<const T*>(a.v_new), static_cast<const int*>(a.anc),
          static_cast<T*>(a.out), a.c, a.N, a.h, a.dk, a.Tanc, a.bw, a.t, G);
  return (int)cudaGetLastError();
}

// G lanes a head: as many heads a warp as fit (G * h <= 32), but no more
// than 4 vectors a lane and no group wider than the head's vectors need
template <typename T, int VB, bool ROUND, bool WRITE>
int dispatch_nv(const Args& a) {
  const int nvec = a.dk * (int)sizeof(T) / VB;
  int G = 32;
  while (G > 1 && G * a.h > 32) G /= 2;
  while (G < 32 && G * 4 < nvec) G *= 2;
  while (G > 1 && G / 2 >= nvec) G /= 2;
  const int nv = (nvec + G - 1) / G;
  if (nv <= 1) return launch<T, VB, 1, ROUND, WRITE>(a, G);
  if (nv <= 2) return launch<T, VB, 2, ROUND, WRITE>(a, G);
  if (nv <= 4) return launch<T, VB, 4, ROUND, WRITE>(a, G);
  return (int)cudaErrorInvalidValue;
}

// VB: the widest of 16, 8 and 4 bytes that divides the head's bytes (an
// even dk keeps a float32 head on 8 bytes at least)
template <typename T, bool ROUND, bool WRITE>
int dispatch_vb(const Args& a) {
  const int bytes = a.dk * (int)sizeof(T);
  if (bytes % 16 == 0) return dispatch_nv<T, 16, ROUND, WRITE>(a);
  if (bytes % 8 == 0) return dispatch_nv<T, 8, ROUND, WRITE>(a);
  if constexpr (sizeof(T) == 2)
    if (bytes % 4 == 0) return dispatch_nv<T, 4, ROUND, WRITE>(a);
  return (int)cudaErrorInvalidValue;
}

template <bool ROUND, bool WRITE>
int dispatch(int dtype, const Args& a) {
  if (a.dk < 2 || a.dk % 2 || a.dk > MAX_DK || a.t < 0)
    return (int)cudaErrorInvalidValue;
  if (dtype == 1) return dispatch_vb<__nv_bfloat16, ROUND, WRITE>(a);
  return dispatch_vb<float, ROUND, WRITE>(a);
}

}  // namespace

// q, ctx [N, D]; k, v [N, T, D]; anc [N, T] int32 or null (bw == 1).
extern "C" int attend_merged(void* q, void* k, void* v, void* anc, void* ctx,
                             int N, int T, int D, int h, int bw, int t0,
                             int dtype, void* stream) {
  if (h < 1 || D % h || t0 >= T) return (int)cudaErrorInvalidValue;
  const int dk = D / h;
  const Args a{q, k, v, nullptr, nullptr, anc, ctx,
               Cache{(long)T * D, dk, D}, N, h, dk, T, bw, t0,
               static_cast<cudaStream_t>(stream)};
  return dispatch<true, false>(dtype, a);
}

// q, k_new, v_new, out [N, h, dk]; k, v [N, h, T, dk], written at t.
extern "C" int mha_step(void* q, void* k_new, void* v_new, void* k, void* v,
                        void* out, int N, int h, int T, int dk, int t,
                        int dtype, void* stream) {
  if (t >= T) return (int)cudaErrorInvalidValue;
  const Args a{q, k, v, k_new, v_new, nullptr, out,
               Cache{(long)h * T * dk, (long)T * dk, dk}, N, h, dk, T, 1, t,
               static_cast<cudaStream_t>(stream)};
  return dispatch<false, true>(dtype, a);
}

// K, V [N, L, h, T, dk], read at layer l; q, out [N, h * dk]; anc [N, T].
extern "C" int anc_attend(void* K, void* V, void* q, void* anc, void* out,
                          int N, int L, int h, int T, int dk, int l, int t,
                          int bw, int dtype, void* stream) {
  if (l < 0 || l >= L || t >= T) return (int)cudaErrorInvalidValue;
  // the layer's base: a multiple of the head's bytes, so VB-aligned
  const long layer = (long)l * h * T * dk * (dtype == 1 ? 2 : 4);
  const Args a{q, static_cast<char*>(K) + layer,
               static_cast<char*>(V) + layer, nullptr, nullptr, anc, out,
               Cache{(long)L * h * T * dk, (long)T * dk, dk}, N, h, dk, T,
               bw, t, static_cast<cudaStream_t>(stream)};
  return dispatch<false, false>(dtype, a);
}
