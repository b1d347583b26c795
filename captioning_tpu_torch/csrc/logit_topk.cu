// Fused vocab epilogue: x.W + b, log-softmax stats and per-row top-k
// (sm_90a).
//
// Replaces captioning_tpu/ops/logit_topk.py:_logit_topk_kernel; the Python
// wrapper and the plain twin are in ops/logit_topk.py, which also states
// what bounds this kernel (FLOPs) and the design.
//
// Pass 1 (logit_topk_split): block (row block, split) owns ROWS = 64 rows of
// x and one contiguous range of whole TV = 128-column vocab tiles.  Per
// tile, the product is accumulated in float32 — with bf16 tensor-core
// fragments (nvcuda::wmma, 16x16x16) for bf16 inputs, with FMA for float32
// inputs — from shared-memory chunks of KC = 32 along D, and staged as a
// [64, 128] float tile in shared memory.  Warp w then folds rows
// 8w..8w+7 of the tile into flash-style running stats (max m, S = sum
// exp(t - m) over the raw logits t, S' = sum exp(t' - m) and
// E' = sum exp(t' - m)(t' - m) over the adjusted logits t' (unk_bias at
// unk_idx), sum t') and inserts the entries that beat the row's k-th best
// into a sorted top-k list in shared memory.  The split's partials go to a
// workspace.
//
// Pass 2 (logit_topk_merge): one thread per row combines the splits' stats
// and merges their top-k lists in split order.
//
// Order is (value desc, index asc) everywhere: tiles and splits are walked
// in ascending index order, so an equal value seen later sorts after the
// entries already held.
//
// Layouts: x [N, D], w [V1, D] (nn.Linear), b [V1], all float32 or bfloat16
// (dtype 0 / 1; bf16 needs D % 8 == 0).  Workspace: wf [splits, N, 5 + k]
// float, wi [splits, N, k] int.  Outputs: vals [N, k] f32, idx [N, k] i32,
// row_sum [N] f32, ent [N] f32.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <mma.h>

namespace {

constexpr int ROWS = 64;
constexpr int TV = 128;
constexpr int KC = 32;
constexpr int THREADS = 256;
constexpr int MAXK = 16;
constexpr int CT_LD = TV + 4;          // float tile row stride
constexpr int AB_LD = KC + 8;          // bf16 chunk row stride
constexpr float NEG = -1e9f;           // running-max start (0 * NEG == 0)

// shared memory: the product's staging area, then the float logit tile
// (same bytes: the tile is written after the last chunk is consumed)
constexpr int CT_BYTES = ROWS * CT_LD * 4;
constexpr int F32_BYTES = (KC * (ROWS + 1) + KC * (TV + 1)) * 4;
constexpr int BF_BYTES = (ROWS + TV) * AB_LD * 2;
constexpr int STAGE_BYTES = CT_BYTES > F32_BYTES ? CT_BYTES : F32_BYTES;
static_assert(STAGE_BYTES >= BF_BYTES, "staging area too small");

__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// (value desc, index asc): true when (v1, i1) ranks before (v0, i0)
__device__ __forceinline__ bool better(float v1, int i1, float v0, int i0) {
  return v1 > v0 || (v1 == v0 && i1 < i0);
}

__device__ __forceinline__ float round_to(float x, const float*) { return x; }
__device__ __forceinline__ float round_to(float x, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16_rn(x));
}
__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// ---- the [ROWS, TV] product tile into ct (float, ld CT_LD) ----

// float32: FMA from float chunks; thread (warp, lane) owns rows
// 8*warp .. 8*warp+7 and columns lane + 32 * j
__device__ void product_tile(const float* __restrict__ x,
                             const float* __restrict__ w, int N, int D,
                             int V1, int row0, int c0, unsigned char* stage) {
  float* xs = reinterpret_cast<float*>(stage);             // [KC][ROWS+1]
  float* ws = xs + KC * (ROWS + 1);                        // [KC][TV+1]
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  float acc[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  for (int k0 = 0; k0 < D; k0 += KC) {
    for (int e = tid; e < ROWS * KC; e += THREADS) {
      const int r = e / KC, d = e % KC, gr = row0 + r, gd = k0 + d;
      xs[d * (ROWS + 1) + r] =
          (gr < N && gd < D) ? x[(long)gr * D + gd] : 0.f;
    }
    for (int e = tid; e < TV * KC; e += THREADS) {
      const int c = e / KC, d = e % KC, gc = c0 + c, gd = k0 + d;
      ws[d * (TV + 1) + c] =
          (gc < V1 && gd < D) ? w[(long)gc * D + gd] : 0.f;
    }
    __syncthreads();
#pragma unroll 4
    for (int d = 0; d < KC; ++d) {
      float a[8], bv[4];
#pragma unroll
      for (int i = 0; i < 8; ++i) a[i] = xs[d * (ROWS + 1) + 8 * warp + i];
#pragma unroll
      for (int j = 0; j < 4; ++j) bv[j] = ws[d * (TV + 1) + lane + 32 * j];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }
  float* ct = reinterpret_cast<float*>(stage);
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      ct[(8 * warp + i) * CT_LD + lane + 32 * j] = acc[i][j];
  __syncthreads();
}

// bf16: tensor-core fragments; warp (wr, wc) owns rows 32*wr .. +32 and
// columns 32*wc .. +32 of the tile (2 x 2 fragments of 16 x 16)
__device__ void product_tile(const __nv_bfloat16* __restrict__ x,
                             const __nv_bfloat16* __restrict__ w, int N,
                             int D, int V1, int row0, int c0,
                             unsigned char* stage) {
  using namespace nvcuda;
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(stage);  // [ROWS][AB_LD]
  __nv_bfloat16* ws = xs + ROWS * AB_LD;                        // [TV][AB_LD]
  const int tid = threadIdx.x, warp = tid / 32;
  const int wr = warp / 4, wc = warp % 4;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);
  const uint4 zero = make_uint4(0, 0, 0, 0);
  for (int k0 = 0; k0 < D; k0 += KC) {
    // 16-byte segments of 8 bf16 along D (D % 8 == 0: a segment is all in
    // or all out of range)
    for (int e = tid; e < ROWS * (KC / 8); e += THREADS) {
      const int r = e / (KC / 8), d = (e % (KC / 8)) * 8;
      const int gr = row0 + r, gd = k0 + d;
      *reinterpret_cast<uint4*>(xs + r * AB_LD + d) =
          (gr < N && gd < D)
              ? *reinterpret_cast<const uint4*>(x + (long)gr * D + gd)
              : zero;
    }
    for (int e = tid; e < TV * (KC / 8); e += THREADS) {
      const int c = e / (KC / 8), d = (e % (KC / 8)) * 8;
      const int gc = c0 + c, gd = k0 + d;
      *reinterpret_cast<uint4*>(ws + c * AB_LD + d) =
          (gc < V1 && gd < D)
              ? *reinterpret_cast<const uint4*>(w + (long)gc * D + gd)
              : zero;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < KC; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major> a[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                     wmma::col_major> bf[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(a[i], xs + (32 * wr + 16 * i) * AB_LD + kk,
                               AB_LD);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(bf[j], ws + (32 * wc + 16 * j) * AB_LD + kk,
                               AB_LD);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j)
          wmma::mma_sync(acc[i][j], a[i], bf[j], acc[i][j]);
    }
    __syncthreads();
  }
  float* ct = reinterpret_cast<float*>(stage);
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(ct + (32 * wr + 16 * i) * CT_LD + 32 * wc +
                                  16 * j,
                              acc[i][j], CT_LD, wmma::mem_row_major);
  __syncthreads();
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
logit_topk_split(const T* __restrict__ x, const T* __restrict__ w,
                 const T* __restrict__ b, float* __restrict__ wf,
                 int* __restrict__ wi, int N, int D, int V1, int k,
                 int unk_idx, int tiles_per_split, float temp,
                 float unk_bias) {
  __shared__ __align__(128) unsigned char stage[STAGE_BYTES];
  __shared__ float topv[ROWS][MAXK];
  __shared__ int topi[ROWS][MAXK];

  const int tid = threadIdx.x;
  const int warp = tid / 32;          // epilogue rows 8*warp .. 8*warp + 7
  const int lane = tid % 32;          // epilogue columns lane + 32 * j
  const int row0 = blockIdx.x * ROWS;
  const int split = blockIdx.y;
  const int cbeg = split * tiles_per_split * TV;
  const int cend = min(V1, cbeg + tiles_per_split * TV);
  const float* ct = reinterpret_cast<const float*>(stage);

  for (int i = tid; i < ROWS * MAXK; i += THREADS) {
    topv[i / MAXK][i % MAXK] = -INFINITY;
    topi[i / MAXK][i % MAXK] = INT_MAX;
  }
  float m[8], s[8], sp[8], ep[8], tsum[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    m[i] = NEG;
    s[i] = sp[i] = ep[i] = tsum[i] = 0.f;
  }
  __syncthreads();

  for (int c0 = cbeg; c0 < cend; c0 += TV) {
    product_tile(x, w, N, D, V1, row0, c0, stage);

    float bias[4];
    bool valid[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = c0 + lane + 32 * j;
      valid[j] = col < V1;
      bias[j] = valid[j] ? to_f(b[col]) : 0.f;
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int row = 8 * warp + i;
      float t[4], tp[4];
      float mt = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = c0 + lane + 32 * j;
        // product rounded to the weight dtype, + bias, rounded again
        t[j] = round_to(round_to(ct[row * CT_LD + lane + 32 * j], x) +
                            bias[j], x) / temp;
        tp[j] = col == unk_idx ? t[j] + unk_bias : t[j];
        if (valid[j]) mt = fmaxf(mt, t[j]);
      }
      mt = warp_max(mt);
      const float mn = fmaxf(m[i], mt);
      const float r = expf(m[i] - mn);
      float es = 0.f, esp = 0.f, eep = 0.f, ts = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (!valid[j]) continue;
        es += expf(t[j] - mn);
        const float etp = expf(tp[j] - mn);
        esp += etp;
        eep += etp * (tp[j] - mn);
        ts += tp[j];
      }
      s[i] = s[i] * r + warp_sum(es);
      // E' couples to S' under the base shift: E'_new = r (E' + (m-mn) S')
      ep[i] = r * (ep[i] + (m[i] - mn) * sp[i]) + warp_sum(eep);
      sp[i] = sp[i] * r + warp_sum(esp);
      tsum[i] += warp_sum(ts);
      m[i] = mn;

      // top-k merge: take the tile's entries that beat the k-th best
      bool taken[4] = {false, false, false, false};
      for (int round = 0; round < k; ++round) {
        const float kth = topv[row][k - 1];
        float bv = -INFINITY;
        int bi = INT_MAX;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int col = c0 + lane + 32 * j;
          if (valid[j] && !taken[j] && tp[j] > kth &&
              better(tp[j], col, bv, bi)) {
            bv = tp[j];
            bi = col;
          }
        }
        for (int o = 16; o > 0; o >>= 1) {
          const float ov = __shfl_xor_sync(0xffffffffu, bv, o);
          const int oi = __shfl_xor_sync(0xffffffffu, bi, o);
          if (better(ov, oi, bv, bi)) {
            bv = ov;
            bi = oi;
          }
        }
        if (bi == INT_MAX) break;          // warp-uniform
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (c0 + lane + 32 * j == bi) taken[j] = true;
        if (lane == 0) {
          // a later index goes after every held entry of equal value
          int p = k - 1;
          while (p > 0 && topv[row][p - 1] < bv) {
            topv[row][p] = topv[row][p - 1];
            topi[row][p] = topi[row][p - 1];
            --p;
          }
          topv[row][p] = bv;
          topi[row][p] = bi;
        }
        __syncwarp();
      }
    }
    __syncthreads();   // the tile's bytes are the next product's staging
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = 8 * warp + i;
    const int gr = row0 + row;
    if (gr >= N) continue;
    const long base = ((long)split * N + gr);
    float* f = wf + base * (5 + k);
    if (lane == 0) {
      f[0] = m[i];
      f[1] = s[i];
      f[2] = sp[i];
      f[3] = ep[i];
      f[4] = tsum[i];
    }
    if (lane < k) {
      f[5 + lane] = topv[row][lane];
      wi[base * k + lane] = topi[row][lane];
    }
  }
}

__global__ void logit_topk_merge(const float* __restrict__ wf,
                                 const int* __restrict__ wi,
                                 float* __restrict__ out_vals,
                                 int* __restrict__ out_idx,
                                 float* __restrict__ out_rowsum,
                                 float* __restrict__ out_ent, int N, int V1,
                                 int k, int splits) {
  const int gr = blockIdx.x * blockDim.x + threadIdx.x;
  if (gr >= N) return;
  float M = NEG;
  for (int sp = 0; sp < splits; ++sp)
    M = fmaxf(M, wf[((long)sp * N + gr) * (5 + k)]);
  float S = 0.f, SP = 0.f, EP = 0.f, TS = 0.f;
  float tv[MAXK], cv[MAXK];
  int ti[MAXK], ci[MAXK];
  for (int q = 0; q < k; ++q) {
    tv[q] = -INFINITY;
    ti[q] = INT_MAX;
  }
  for (int sp = 0; sp < splits; ++sp) {
    const float* f = wf + ((long)sp * N + gr) * (5 + k);
    const int* fi = wi + ((long)sp * N + gr) * k;
    const float r = expf(f[0] - M);
    S += f[1] * r;
    SP += f[2] * r;
    EP += r * (f[3] + (f[0] - M) * f[2]);
    TS += f[4];
    // merge two sorted lists; the held one (lower indices) wins ties
    int a = 0, bb = 0;
    for (int q = 0; q < k; ++q) {
      if (bb >= k || (a < k && !(f[5 + bb] > tv[a]))) {
        cv[q] = tv[a];
        ci[q] = ti[a];
        ++a;
      } else {
        cv[q] = f[5 + bb];
        ci[q] = fi[bb];
        ++bb;
      }
    }
    for (int q = 0; q < k; ++q) {
      tv[q] = cv[q];
      ti[q] = ci[q];
    }
  }
  const float logs = logf(S);
  const float c = M + logs;               // log-softmax constant
  for (int q = 0; q < k; ++q) {
    out_vals[(long)gr * k + q] = tv[q] - c;
    out_idx[(long)gr * k + q] = ti[q];
  }
  out_ent[gr] = -(EP - logs * SP) / S;
  out_rowsum[gr] = TS - (float)V1 * c;
}

template <typename T>
void launch(const void* x, const void* w, const void* b, void* wf, void* wi,
            void* vals, void* idx, void* rowsum, void* ent, int N, int D,
            int V1, int k, int unk_idx, int splits, float temp,
            float unk_bias, cudaStream_t stream) {
  const int tiles = (V1 + TV - 1) / TV;
  const int per = (tiles + splits - 1) / splits;
  dim3 grid((N + ROWS - 1) / ROWS, splits);
  logit_topk_split<T><<<grid, THREADS, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w),
      static_cast<const T*>(b), static_cast<float*>(wf),
      static_cast<int*>(wi), N, D, V1, k, unk_idx, per, temp, unk_bias);
  logit_topk_merge<<<(N + 127) / 128, 128, 0, stream>>>(
      static_cast<const float*>(wf), static_cast<const int*>(wi),
      static_cast<float*>(vals), static_cast<int*>(idx),
      static_cast<float*>(rowsum), static_cast<float*>(ent), N, V1, k,
      splits);
}

}  // namespace

// A split left without a tile (splits > tiles) contributes nothing: its
// partials are m = NEG, zero sums and an empty list.
extern "C" int logit_topk(void* x, void* w, void* b, void* wf, void* wi,
                          void* vals, void* idx, void* rowsum, void* ent,
                          int N, int D, int V1, int k, int unk_idx,
                          int splits, float temp, float unk_bias, int dtype,
                          void* stream) {
  if (k < 1 || k > MAXK || splits < 1) return (int)cudaErrorInvalidValue;
  if (dtype == 1 && D % 8) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    launch<__nv_bfloat16>(x, w, b, wf, wi, vals, idx, rowsum, ent, N, D, V1,
                          k, unk_idx, splits, temp, unk_bias, s);
  else
    launch<float>(x, w, b, wf, wi, vals, idx, rowsum, ent, N, D, V1, k,
                  unk_idx, splits, temp, unk_bias, s);
  return (int)cudaGetLastError();
}
