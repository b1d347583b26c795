// Additive attention of the RNN captioners, one block per attention row
// (sm_90a).
//
// Replaces captioning_tpu/ops/attention.py:_attn_kernel; the Python
// wrapper and the plain twin are in ops/attention.py, which also states
// what bounds this kernel (bytes) and the design.
//
// Block b serves the bw query rows b*bw .. b*bw + bw - 1 (bw = 1: greedy
// and the bos step; bw = 5: beam lanes or seq_per_img captions sharing one
// image).  Three phases, with a barrier between them:
//   1. scores: one warp per region m reads p_att[b, m, :] once and scores
//      it against every query, e[q, m] = sum_a tanh(p + h[q]) * w + bias,
//      reduced over A with warp shuffles;
//   2. softmax over M in float32, times the mask, renormalised by
//      max(sum, 1e-9) (an all-masked row gives 0), one warp per query;
//   3. the weighted sum: each thread owns columns of att[b, :, :], reads
//      each element once and accumulates it into all bw outputs.
// In bf16 every elementwise step is rounded where the twin rounds it (the
// add, tanh, the product with w, the weight, the product with att); the
// sums are float32.
//
// Layouts: att_h [nb*bw, A]; att [nb, M, H]; p_att [nb, M, A]; mask
// [nb, M] float32; w [A]; b [1]; out [nb*bw, H].  att_h, p_att, w and b
// share the element type T, att and out the type TA: (T, TA) is (float32,
// float32), (bfloat16, bfloat16) or (bfloat16, float32), the last for bf16
// models whose masked BatchNorm hands float32 features to the head (dtype
// codes 0 = float32, 1 = bfloat16).  Shared memory: (bw*A + A + bw*M)
// floats.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_BW = 8;

template <typename T> struct Elt;
template <> struct Elt<float> {
  __device__ static float load(const float* p) { return *p; }
  __device__ static float round(float x) { return x; }
  __device__ static void store(float* p, float x) { *p = x; }
};
template <> struct Elt<__nv_bfloat16> {
  __device__ static float load(const __nv_bfloat16* p) {
    return __bfloat162float(*p);
  }
  __device__ static float round(float x) {
    return __bfloat162float(__float2bfloat16_rn(x));
  }
  __device__ static void store(__nv_bfloat16* p, float x) {
    *p = __float2bfloat16_rn(x);
  }
};

__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

template <typename T, typename TA>
__global__ void __launch_bounds__(THREADS)
additive_attention_kernel(const T* __restrict__ att_h,
                          const TA* __restrict__ att,
                          const T* __restrict__ p_att,
                          const float* __restrict__ mask,
                          const T* __restrict__ w, const T* __restrict__ b,
                          TA* __restrict__ out, int bw, int M, int H,
                          int A) {
  extern __shared__ float smem[];
  float* sh_h = smem;              // [bw, A] the queries
  float* sh_w = sh_h + bw * A;     // [A]
  float* sh_e = sh_w + A;          // [bw, M] scores, then weights
  const long row = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;

  const T* hq = att_h + row * bw * A;
  for (int i = tid; i < bw * A; i += THREADS) sh_h[i] = Elt<T>::load(hq + i);
  for (int i = tid; i < A; i += THREADS) sh_w[i] = Elt<T>::load(w + i);
  __syncthreads();
  const float bias = Elt<T>::load(b);

  // 1. scores; bw is uniform over the block, so every lane of a warp
  // takes the same branches and joins every shuffle
  const T* pr = p_att + row * M * A;
  for (int m = warp; m < M; m += WARPS) {
    float s[MAX_BW];
#pragma unroll
    for (int q = 0; q < MAX_BW; ++q) s[q] = 0.f;
    for (int a = lane; a < A; a += 32) {
      const float p = Elt<T>::load(pr + (long)m * A + a);
      const float wa = sh_w[a];
#pragma unroll
      for (int q = 0; q < MAX_BW; ++q) {
        if (q < bw) {
          const float d =
              Elt<T>::round(tanhf(Elt<T>::round(p + sh_h[q * A + a])));
          s[q] += Elt<T>::round(d * wa);
        }
      }
    }
#pragma unroll
    for (int q = 0; q < MAX_BW; ++q) {
      if (q < bw) {
        const float t = warp_sum(s[q]);
        if (lane == 0) sh_e[q * M + m] = t + bias;
      }
    }
  }
  __syncthreads();

  // 2. softmax, mask, renormalise; a lane only touches its own regions
  const float* mk = mask + row * M;
  for (int q = warp; q < bw; q += WARPS) {
    float* e = sh_e + q * M;
    float mx = -INFINITY;
    for (int m = lane; m < M; m += 32) mx = fmaxf(mx, e[m]);
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
    for (int m = lane; m < M; m += 32) e[m] = Elt<TA>::round(e[m] / kept);
  }
  __syncthreads();

  // 3. weighted sum: att[b] is read once for all bw queries
  const TA* ar = att + row * M * H;
  TA* orow = out + row * bw * H;
  for (int col = tid; col < H; col += THREADS) {
    float acc[MAX_BW];
#pragma unroll
    for (int q = 0; q < MAX_BW; ++q) acc[q] = 0.f;
    for (int m = 0; m < M; ++m) {
      const float a = Elt<TA>::load(ar + (long)m * H + col);
#pragma unroll
      for (int q = 0; q < MAX_BW; ++q)
        if (q < bw) acc[q] += Elt<TA>::round(a * sh_e[q * M + m]);
    }
#pragma unroll
    for (int q = 0; q < MAX_BW; ++q)
      if (q < bw) Elt<TA>::store(orow + (long)q * H + col, acc[q]);
  }
}

template <typename T, typename TA>
void launch(const void* att_h, const void* att, const void* p_att,
            const void* mask, const void* w, const void* b, void* out,
            int nb, int bw, int M, int H, int A, cudaStream_t stream) {
  const size_t smem = sizeof(float) * ((size_t)bw * A + A + (size_t)bw * M);
  additive_attention_kernel<T, TA><<<nb, THREADS, smem, stream>>>(
      static_cast<const T*>(att_h), static_cast<const TA*>(att),
      static_cast<const T*>(p_att), static_cast<const float*>(mask),
      static_cast<const T*>(w), static_cast<const T*>(b),
      static_cast<TA*>(out), bw, M, H, A);
}

}  // namespace

extern "C" int additive_attention(void* att_h, void* att, void* p_att,
                                  void* mask, void* w, void* b, void* out,
                                  int nb, int bw, int M, int H, int A,
                                  int dtype, int att_dtype, void* stream) {
  if (bw < 1 || bw > MAX_BW) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && att_dtype == 0)
    launch<float, float>(att_h, att, p_att, mask, w, b, out, nb, bw, M, H,
                         A, s);
  else if (dtype == 1 && att_dtype == 1)
    launch<__nv_bfloat16, __nv_bfloat16>(att_h, att, p_att, mask, w, b, out,
                                         nb, bw, M, H, A, s);
  else if (dtype == 1 && att_dtype == 0)
    launch<__nv_bfloat16, float>(att_h, att, p_att, mask, w, b, out, nb, bw,
                                 M, H, A, s);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
