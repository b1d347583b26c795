// The maxout-LSTM gate chain after the cell's two matmuls (sm_90a).
//
// Replaces captioning_tpu/ops/lstm.py:_kernel (wrapper
// maxout_lstm_gates_fused); the Python wrapper and the plain twin are in
// ops/lstm.py.  Per element (r, j) of the [N, H] output, with s [N, 5H]:
//
//   i, f, o = sigmoid(s[r, j]), sigmoid(s[r, H + j]), sigmoid(s[r, 2H + j])
//   g       = max(s[r, 3H + j], s[r, 4H + j])
//   c[r, j] = f * c_prev[r, j] + i * g
//   h[r, j] = o * tanh(c[r, j])
//
// What bounds it on the H100: bytes.  It reads 6 and writes 2 elements per
// output element and does ~40 flops on them; at the StackAtt beam step
// (N = 5120, H = 512, bf16) that is 42 MB per call, 13 us at 3.35 TB/s.
// The design is one pass: a block per (row, column range), a thread per
// output element, neighbouring threads on neighbouring columns, so each of
// the five gate slices and c_prev is read coalesced exactly once and
// nothing but h and c is written.  Measured (H100, 700 W): 26 us at that
// shape (1.6 TB/s; 2-byte loads), 35 us in float32 (2.4 TB/s).
//
// Rounding: every step is rounded to the element type where the twin (the
// JAX cell's jnp chain, op by op in the compute dtype) rounds it: the three
// sigmoids, f * c, i * g, their sum, tanh and o * tanh.  Products and sums
// use __fmul_rn / __fadd_rn so that nvcc does not contract them into an
// FMA the twin does not have, and sigmoid is 1 / (1 + exp(-x)) in float32,
// the formula of PyTorch's own CUDA sigmoid.
//
// Layouts: s [N, 5H], c_prev, h, c [N, H], all contiguous, one element
// type (dtype codes 0 = float32, 1 = bfloat16).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int THREADS = 256;

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

__device__ __forceinline__ float sigmoid(float x) {
  return 1.0f / (1.0f + expf(-x));
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
maxout_lstm_kernel(const T* __restrict__ s, const T* __restrict__ c_prev,
                   T* __restrict__ h_out, T* __restrict__ c_out, int H) {
  using E = Elt<T>;
  // block (r, y) serves row r, columns y*THREADS + tid, y*THREADS + tid +
  // gridDim.y*THREADS, ...: no index division, and a warp reads 32
  // neighbouring columns of each gate slice
  const long r = blockIdx.x;
  const T* sr = s + r * 5 * H;
  const long o = r * H;
  for (int j = blockIdx.y * THREADS + threadIdx.x; j < H;
       j += gridDim.y * THREADS) {
    const float i = E::round(sigmoid(E::load(sr + j)));
    const float f = E::round(sigmoid(E::load(sr + H + j)));
    const float og = E::round(sigmoid(E::load(sr + 2 * H + j)));
    const float g = fmaxf(E::load(sr + 3 * H + j), E::load(sr + 4 * H + j));
    const float fc = E::round(__fmul_rn(f, E::load(c_prev + o + j)));
    const float ig = E::round(__fmul_rn(i, g));
    const float c = E::round(__fadd_rn(fc, ig));
    E::store(c_out + o + j, c);
    E::store(h_out + o + j, __fmul_rn(og, E::round(tanhf(c))));
  }
}

template <typename T>
void launch(const void* s, const void* c_prev, void* h, void* c, int N,
            int H, cudaStream_t stream) {
  // one block row per state row; the column blocks loop over what a cap
  // of 64 leaves (H up to 16384 in one pass)
  const int cols = (H + THREADS - 1) / THREADS;
  const dim3 grid(N, cols < 64 ? cols : 64);
  maxout_lstm_kernel<T><<<grid, THREADS, 0, stream>>>(
      static_cast<const T*>(s), static_cast<const T*>(c_prev),
      static_cast<T*>(h), static_cast<T*>(c), H);
}

}  // namespace

extern "C" int maxout_lstm_gates(void* s, void* c_prev, void* h, void* c,
                                 int N, int H, int dtype, void* stream) {
  if (N < 1 || H < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    launch<float>(s, c_prev, h, c, N, H, st);
  else if (dtype == 1)
    launch<__nv_bfloat16>(s, c_prev, h, c, N, H, st);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
