// Fused write + ancestry attend over merged-lane decode caches (sm_90a).
//
// Replaces captioning_tpu/ops/beam_attend.py:_wa_kernel; the Python
// wrapper and the plain twin are in ops/beam_attend.py, which also states
// what bounds this kernel (bytes) and the design.
//
// One warp per (row r, head hh).  Lane l holds head elements
// e = 2*l + 64*i (i < MAXV), so a 64-wide head is one 128-byte bf16 load
// per time step for the whole warp.  For j = 0..t0 the warp reads the
// ancestor's entry k[blk*bw + anc[r, j], j, head], scores it against q,
// and folds it into an online float32 softmax over V.  At j == t0 the
// entry comes from k_new/v_new, which this warp also stores at [r, t0].
//
// Layouts: q, k_new, v_new, ctx [N, D]; k, v [N, Tp, D]; anc [N, Tp] int32
// (null when bw == 1: each row is its own block).  Element type float32 or
// bfloat16 (dtype 0 / 1).

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

template <typename T>
__global__ void attend_write_kernel(const T* __restrict__ q,
                                    T* __restrict__ k, T* __restrict__ v,
                                    const T* __restrict__ k_new,
                                    const T* __restrict__ v_new,
                                    const int* __restrict__ anc,
                                    T* __restrict__ ctx, int N, int Tp, int D,
                                    int h, int bw, int t0) {
  const int warp = blockIdx.x * WARPS_PER_BLOCK + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (warp >= N * h) return;
  const int r = warp / h;
  const int head = warp % h;
  const int dk = D / h;
  const int blk0 = (r / bw) * bw;
  const long row_d = (long)r * D + head * dk;
  // sqrt(dk) rounded to T, as the twin computes it in the compute dtype
  const float scale = Pair<T>::round(sqrtf((float)dk));

  float2 qv[MAXV], kn[MAXV], vn[MAXV], acc[MAXV];
#pragma unroll
  for (int i = 0; i < MAXV; ++i) {
    const int e = 2 * lane + 64 * i;
    qv[i] = kn[i] = vn[i] = acc[i] = make_float2(0.f, 0.f);
    if (e < dk) {
      qv[i] = Pair<T>::load(q + row_d + e);
      kn[i] = Pair<T>::load(k_new + row_d + e);
      vn[i] = Pair<T>::load(v_new + row_d + e);
      // the step's entry, at this row's own slot: read by no other warp
      const long dst = ((long)r * Tp + t0) * D + head * dk + e;
      Pair<T>::store(k + dst, kn[i]);
      Pair<T>::store(v + dst, vn[i]);
    }
  }

  float m = -INFINITY, l = 0.f;
  for (int j = 0; j <= t0; ++j) {
    float2 kv[MAXV], vv[MAXV];
    bool take = true;
    if (j == t0) {
#pragma unroll
      for (int i = 0; i < MAXV; ++i) { kv[i] = kn[i]; vv[i] = vn[i]; }
    } else {
      const int s = bw > 1 ? anc[(long)r * Tp + j] : 0;
      // an out-of-range sibling selects nothing (the twin's one-hot mask)
      take = s >= 0 && s < bw;
      const long src = ((long)(blk0 + (take ? s : 0)) * Tp + j) * D +
                       head * dk;
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
    if (!take) continue;   // warp-uniform: s depends on (r, j) only
    const float sc = Pair<T>::round(warp_sum(part) / scale);
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
      Pair<T>::store(ctx + row_d + e,
                     make_float2(acc[i].x * inv, acc[i].y * inv));
  }
}

template <typename T>
void launch(void* q, void* k, void* v, void* k_new, void* v_new,
            const void* anc, void* ctx, int N, int Tp, int D, int h, int bw,
            int t0, cudaStream_t stream) {
  const int warps = N * h;
  const int blocks = (warps + WARPS_PER_BLOCK - 1) / WARPS_PER_BLOCK;
  attend_write_kernel<T><<<blocks, 32 * WARPS_PER_BLOCK, 0, stream>>>(
      static_cast<const T*>(q), static_cast<T*>(k), static_cast<T*>(v),
      static_cast<const T*>(k_new), static_cast<const T*>(v_new),
      static_cast<const int*>(anc), static_cast<T*>(ctx), N, Tp, D, h, bw,
      t0);
}

}  // namespace

extern "C" int attend_write_merged(void* q, void* k, void* v, void* k_new,
                                   void* v_new, void* anc, void* ctx, int N,
                                   int Tp, int D, int h, int bw, int t0,
                                   int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    launch<__nv_bfloat16>(q, k, v, k_new, v_new, anc, ctx, N, Tp, D, h, bw,
                          t0, s);
  else
    launch<float>(q, k, v, k_new, v_new, anc, ctx, N, Tp, D, h, bw, t0, s);
  return (int)cudaGetLastError();
}
