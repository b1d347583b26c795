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
// (N = 5120, H = 512, bf16) that is 41.9 MB per call, 12.5 us at
// 3.35 TB/s.  Each input element is read once and only h and c are
// written.
//
// Design (Hopper): a thread owns one 16-byte vector of columns of one row
// (8 bf16 or 4 float32 lanes) and reads the matching vector of each of the
// five gate slices and of c_prev, six independent 16-byte loads in flight,
// then writes one vector of h and one of c; neighbouring threads hold
// neighbouring vectors, so a warp reads 512 contiguous bytes of each
// slice.  The six vectors stay in registers as loaded (24 registers at 16
// bytes) and are widened to float32 lane by lane in the math, which keeps
// the kernel at 28-40 registers and the SM full of threads.  The grid is
// sized to what the card holds at once (132 SMs times the resident blocks
// an SM takes), each thread looping over the same number of vectors, so
// many rows share a block and no partial second wave of blocks is left.
// Measured (H100, 700 W, graph replay, N 5120, H 512): 0.0161-0.0164 ms
// in bf16 (bound 0.0125), 0.0310 ms in float32 (bound 0.0250); widening
// on load (64 registers, half the threads) took 0.0193-0.0197 ms, two
// vectors a thread 0.0237 ms, the first cut (a block per row, 2-byte
// loads) 0.0260-0.0263 ms.  Where H is not a multiple of the vector width,
// or a pointer is not 16-byte aligned, the same kernel runs one element a
// thread (the scalar path).
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
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int MAX_DEVICES = 64;

template <typename T> struct Elt;
template <> struct Elt<float> {
  __device__ static float to_float(float x) { return x; }
  __device__ static float from_float(float x) { return x; }
  __device__ static float round(float x) { return x; }
};
template <> struct Elt<__nv_bfloat16> {
  __device__ static float to_float(__nv_bfloat16 x) {
    return __bfloat162float(x);
  }
  __device__ static __nv_bfloat16 from_float(float x) {
    return __float2bfloat16_rn(x);
  }
  __device__ static float round(float x) {
    return __bfloat162float(__float2bfloat16_rn(x));
  }
};

// the unsigned type of a vector of BYTES bytes, for one load or store
template <int BYTES> struct Raw;
template <> struct Raw<16> { using type = uint4; };
template <> struct Raw<4> { using type = unsigned int; };
template <> struct Raw<2> { using type = unsigned short; };

// a vector as loaded, read lane by lane as float32
template <typename T, int V>
struct Vec {
  using R = typename Raw<V * sizeof(T)>::type;
  R raw;
  __device__ __forceinline__ void load(const T* __restrict__ p) {
    raw = __ldg(reinterpret_cast<const R*>(p));
  }
  __device__ __forceinline__ float operator[](int k) const {
    return Elt<T>::to_float(reinterpret_cast<const T*>(&raw)[k]);
  }
};

template <typename T, int V>
__device__ __forceinline__ void store(T* __restrict__ p, const float (&x)[V]) {
  using R = typename Raw<V * sizeof(T)>::type;
  R raw;
  T* e = reinterpret_cast<T*>(&raw);
#pragma unroll
  for (int k = 0; k < V; ++k) e[k] = Elt<T>::from_float(x[k]);
  *reinterpret_cast<R*>(p) = raw;
}

__device__ __forceinline__ float sigmoid(float x) {
  return 1.0f / (1.0f + expf(-x));
}

// V columns a thread (V = 16 / sizeof(T), or 1 on the scalar path); item
// it is vector it % (H / V) of row it / (H / V)
template <typename T, int V>
__global__ void __launch_bounds__(THREADS)
maxout_lstm_kernel(const T* __restrict__ s, const T* __restrict__ c_prev,
                   T* __restrict__ h_out, T* __restrict__ c_out, int H,
                   long items) {
  using E = Elt<T>;
  const int per_row = H / V;
  for (long it = (long)blockIdx.x * THREADS + threadIdx.x; it < items;
       it += (long)gridDim.x * THREADS) {
    const long r = it / per_row;
    const long j = (it - r * per_row) * V;
    const T* sr = s + r * 5 * H + j;
    const long o = r * H + j;
    Vec<T, V> si, sf, so, s3, s4, cp;
    si.load(sr);
    sf.load(sr + H);
    so.load(sr + 2 * H);
    s3.load(sr + 3 * H);
    s4.load(sr + 4 * H);
    cp.load(c_prev + o);
    float hv[V], cv[V];
#pragma unroll
    for (int k = 0; k < V; ++k) {
      const float i = E::round(sigmoid(si[k]));
      const float f = E::round(sigmoid(sf[k]));
      const float og = E::round(sigmoid(so[k]));
      const float g = fmaxf(s3[k], s4[k]);
      const float fc = E::round(__fmul_rn(f, cp[k]));
      const float ig = E::round(__fmul_rn(i, g));
      const float c = E::round(__fadd_rn(fc, ig));
      cv[k] = c;
      hv[k] = __fmul_rn(og, E::round(tanhf(c)));
    }
    store<T, V>(c_out + o, cv);
    store<T, V>(h_out + o, hv);
  }
}

// blocks of THREADS an SM holds at once, per device and kernel
template <typename T, int V>
int resident_blocks(int* sms) {
  static int cached_sms[MAX_DEVICES], cached_blocks[MAX_DEVICES];
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < 0 || dev >= MAX_DEVICES) dev = 0;
  if (!cached_blocks[dev]) {
    int n = 0, b = 0;
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &b, maxout_lstm_kernel<T, V>, THREADS, 0);
    cached_sms[dev] = n > 0 ? n : 1;
    cached_blocks[dev] = b > 0 ? b : 1;
  }
  *sms = cached_sms[dev];
  return cached_blocks[dev];
}

template <typename T, int V>
void launch_v(const void* s, const void* c_prev, void* h, void* c, int N,
              int H, cudaStream_t stream) {
  const long items = (long)N * (H / V);
  int sms = 1;
  const long resident = (long)resident_blocks<T, V>(&sms) * sms;
  // every thread loops over the same number of items: as many passes as
  // the resident blocks need, over as few blocks as that number allows
  const long blocks = (items + THREADS - 1) / THREADS;
  const long passes = (blocks + resident - 1) / resident;
  const long grid = (blocks + passes - 1) / passes;
  maxout_lstm_kernel<T, V><<<(unsigned)grid, THREADS, 0, stream>>>(
      static_cast<const T*>(s), static_cast<const T*>(c_prev),
      static_cast<T*>(h), static_cast<T*>(c), H, items);
}

template <typename T>
void launch(const void* s, const void* c_prev, void* h, void* c, int N,
            int H, cudaStream_t stream) {
  constexpr int VEC = 16 / sizeof(T);
  const uintptr_t addr = reinterpret_cast<uintptr_t>(s) |
                         reinterpret_cast<uintptr_t>(c_prev) |
                         reinterpret_cast<uintptr_t>(h) |
                         reinterpret_cast<uintptr_t>(c);
  if (H % VEC == 0 && addr % 16 == 0)
    launch_v<T, VEC>(s, c_prev, h, c, N, H, stream);
  else
    launch_v<T, 1>(s, c_prev, h, c, N, H, stream);
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
