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
// entries, because a TPU has no row gather; here one warp per (row, head)
// gathers the ancestor's entry only, lane l holding the head elements
// e = 2 * l + 64 * i (i < MAXV: one 128-byte bf16 load per time step for
// a 64-wide head), and folds each entry into an online float32 softmax, so
// nothing but the context (and, for mha_step, the one written entry) is
// stored.
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
// Element type float32 or bfloat16 (dtype 0 / 1).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int MAXV = 4;            // head width up to 2 * 32 * MAXV = 256
constexpr int WARPS_PER_BLOCK = 8;

template <typename T> struct Pair;
template <> struct Pair<float> {
  __device__ static float2 load(const float* p) {
    return *reinterpret_cast<const float2*>(p);
  }
  __device__ static void store(float* p, float2 v) {
    *reinterpret_cast<float2*>(p) = v;
  }
  __device__ static float round(float x) { return x; }
};
template <> struct Pair<__nv_bfloat16> {
  __device__ static float2 load(const __nv_bfloat16* p) {
    return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
  }
  __device__ static void store(__nv_bfloat16* p, float2 v) {
    *reinterpret_cast<__nv_bfloat162*>(p) = __float22bfloat162_rn(v);
  }
  __device__ static float round(float x) {
    return __bfloat162float(__float2bfloat16_rn(x));
  }
};

__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// The cache: entry (row, head, time) starts at base + row * sN + head * sH
// + time * sT and holds dk contiguous elements.
struct Cache {
  long sN, sH, sT;
};

// q, out, k_new, v_new: [N, h * dk].  anc: [N, Tanc] int32, or null (each
// row reads its own slot).  k_new / v_new non-null: written at time t of
// the row's own slot first (mha_step).  ROUND: round the scale and the
// scaled scores to T.
template <typename T, bool ROUND>
__global__ void attend_kernel(const T* __restrict__ q, T* k, T* v,
                              const T* __restrict__ k_new,
                              const T* __restrict__ v_new,
                              const int* __restrict__ anc,
                              T* __restrict__ out, Cache c, int N, int h,
                              int dk, int Tanc, int bw, int t) {
  const int warp = blockIdx.x * WARPS_PER_BLOCK + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (warp >= N * h) return;
  const int r = warp / h;
  const int head = warp % h;
  const int blk0 = (r / bw) * bw;
  const long row_d = (long)r * h * dk + head * dk;
  const bool write = k_new != nullptr;
  const float scale = ROUND ? Pair<T>::round(sqrtf((float)dk))
                            : sqrtf((float)dk);

  float2 qv[MAXV], kn[MAXV], vn[MAXV], acc[MAXV];
#pragma unroll
  for (int i = 0; i < MAXV; ++i) {
    const int e = 2 * lane + 64 * i;
    qv[i] = kn[i] = vn[i] = acc[i] = make_float2(0.f, 0.f);
    if (e < dk) {
      qv[i] = Pair<T>::load(q + row_d + e);
      if (write) {
        kn[i] = Pair<T>::load(k_new + row_d + e);
        vn[i] = Pair<T>::load(v_new + row_d + e);
        // the row's own slot: no other warp reads it (no ancestry here)
        const long dst = r * c.sN + head * c.sH + t * c.sT + e;
        Pair<T>::store(k + dst, kn[i]);
        Pair<T>::store(v + dst, vn[i]);
      }
    }
  }

  float m = -INFINITY, l = 0.f;
  for (int j = 0; j <= t; ++j) {
    float2 kv[MAXV], vv[MAXV];
    bool take = true;
    if (write && j == t) {
#pragma unroll
      for (int i = 0; i < MAXV; ++i) { kv[i] = kn[i]; vv[i] = vn[i]; }
    } else {
      int src_row = r;
      if (anc != nullptr) {
        const int s = anc[(long)r * Tanc + j];
        // an out-of-range sibling selects nothing (the twins' one-hot mask)
        take = s >= 0 && s < bw;
        src_row = blk0 + (take ? s : 0);
      }
      const long src = src_row * c.sN + head * c.sH + j * c.sT;
#pragma unroll
      for (int i = 0; i < MAXV; ++i) {
        const int e = 2 * lane + 64 * i;
        kv[i] = vv[i] = make_float2(0.f, 0.f);
        if (e < dk) {
          kv[i] = Pair<T>::load(k + src + e);
          vv[i] = Pair<T>::load(v + src + e);
        }
      }
    }
    float part = 0.f;
#pragma unroll
    for (int i = 0; i < MAXV; ++i)
      part += qv[i].x * kv[i].x + qv[i].y * kv[i].y;
    const float dot = warp_sum(part);
    if (!take) continue;   // warp-uniform: s depends on (r, j) only
    const float sc = ROUND ? Pair<T>::round(dot / scale) : dot / scale;
    const float mn = fmaxf(m, sc);
    const float a = expf(m - mn);   // 0 on the first entry (m = -inf)
    const float p = expf(sc - mn);
    l = l * a + p;
#pragma unroll
    for (int i = 0; i < MAXV; ++i) {
      acc[i].x = acc[i].x * a + p * vv[i].x;
      acc[i].y = acc[i].y * a + p * vv[i].y;
    }
    m = mn;
  }
  const float inv = 1.f / l;
#pragma unroll
  for (int i = 0; i < MAXV; ++i) {
    const int e = 2 * lane + 64 * i;
    if (e < dk)
      Pair<T>::store(out + row_d + e,
                     make_float2(acc[i].x * inv, acc[i].y * inv));
  }
}

template <typename T, bool ROUND>
int launch(const void* q, void* k, void* v, const void* k_new,
           const void* v_new, const void* anc, void* out, Cache c, int N,
           int h, int dk, int Tanc, int bw, int t, void* stream) {
  const int blocks = (N * h + WARPS_PER_BLOCK - 1) / WARPS_PER_BLOCK;
  attend_kernel<T, ROUND><<<blocks, 32 * WARPS_PER_BLOCK, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(q), static_cast<T*>(k), static_cast<T*>(v),
      static_cast<const T*>(k_new), static_cast<const T*>(v_new),
      static_cast<const int*>(anc), static_cast<T*>(out), c, N, h, dk, Tanc,
      bw, t);
  return (int)cudaGetLastError();
}

template <bool ROUND>
int dispatch(int dtype, const void* q, void* k, void* v, const void* k_new,
             const void* v_new, const void* anc, void* out, Cache c, int N,
             int h, int dk, int Tanc, int bw, int t, void* stream) {
  if (dtype == 1)
    return launch<__nv_bfloat16, ROUND>(q, k, v, k_new, v_new, anc, out, c,
                                        N, h, dk, Tanc, bw, t, stream);
  return launch<float, ROUND>(q, k, v, k_new, v_new, anc, out, c, N, h, dk,
                              Tanc, bw, t, stream);
}

}  // namespace

// q, ctx [N, D]; k, v [N, T, D]; anc [N, T] int32 or null (bw == 1).
extern "C" int attend_merged(void* q, void* k, void* v, void* anc, void* ctx,
                             int N, int T, int D, int h, int bw, int t0,
                             int dtype, void* stream) {
  const int dk = D / h;
  const Cache c{(long)T * D, dk, D};
  return dispatch<true>(dtype, q, k, v, nullptr, nullptr, anc, ctx, c, N, h,
                        dk, T, bw, t0, stream);
}

// q, k_new, v_new, out [N, h, dk]; k, v [N, h, T, dk], written at t.
extern "C" int mha_step(void* q, void* k_new, void* v_new, void* k, void* v,
                        void* out, int N, int h, int T, int dk, int t,
                        int dtype, void* stream) {
  const Cache c{(long)h * T * dk, (long)T * dk, dk};
  return dispatch<false>(dtype, q, k, v, k_new, v_new, nullptr, out, c, N, h,
                         dk, T, 1, t, stream);
}

// K, V [N, L, h, T, dk], read at layer l; q, out [N, h * dk]; anc [N, T].
extern "C" int anc_attend(void* K, void* V, void* q, void* anc, void* out,
                          int N, int L, int h, int T, int dk, int l, int t,
                          int bw, int dtype, void* stream) {
  const long layer = (long)l * h * T * dk;
  const int esize = dtype == 1 ? 2 : 4;
  char* k = static_cast<char*>(K) + layer * esize;
  char* v = static_cast<char*>(V) + layer * esize;
  const Cache c{(long)L * h * T * dk, (long)T * dk, dk};
  return dispatch<false>(dtype, q, k, v, nullptr, nullptr, anc, out, c, N, h,
                         dk, T, bw, t, stream);
}
