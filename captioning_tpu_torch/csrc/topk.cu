// Exact top-k over the last dimension of a float32 [B, C] table (sm_90a).
//
// Replaces captioning_tpu/ops/topk.py:_topk_kernel (wrapper topk_lastdim);
// the Python wrapper and the plain twin are in ops/topk.py.  Per row it
// returns the k largest values in descending order and their column
// indices, equal values by ascending index: exactly lax.top_k's order, and
// that of a stable descending sort, -inf entries and all--inf rows
// included.
//
// What bounds it on the H100: bytes.  The plain beam route selects from
// the [B, bdash * V1] candidate table once per step; at B = 1024, bdash 5,
// V1 = 9488 that is 194 MB, 58 us at 3.35 TB/s.  One block reads a row
// once, each thread a strided slice of it with 16-byte loads (a scalar
// head up to 16-byte alignment and a scalar tail make any C and any row
// offset work), and keeps its own top-K in registers, K = k for k <= 8
// and 16 above.  The first design (one list of k rounded up to a power of
// two, tested against each element) was bound by instruction issue, not
// bytes: early in a thread's scan an element beats its list with
// probability ~K / i, so across 32 lanes some lane inserted at nearly
// every element and the warp ran the insertion with it (1.15 TB/s at k 5
// against 2.65 at k 1).  This design makes an insertion rare:
//   1. a block-shared threshold.  The block scans the row's first
//      THREADS * UNROLL 16-byte vectors into the lists, then takes its
//      exact k best out of them in k block-wide rounds (below) into a
//      shared list W, with the next vectors' loads in flight; the k-th of
//      W is the threshold T.  W's k entries all come before (value desc,
//      index asc) any later element that is not above T: each is >= T, and
//      where it equals T its column is lower, since W holds the row's
//      prefix.  So the rest of the row is filtered by x > T (a threshold
//      taken from anything but a prefix would need x >= T, and lets runs
//      of ties through).  On rows of independent values, about k / 4096
//      of the rest lies above the k-th best of the first 4096;
//   2. a cheap insertion.  A thread sees its columns in ascending order,
//      and its list holds only its own columns, so a new element goes
//      behind every equal value already there: the test against entry j
//      is one unordered compare, !(x <= v[j]) (an empty slot, NaN, loses
//      to anything), and the insertion shifts the entries behind it by
//      selects, with no chain of dependent swaps;
//   3. the merge: k rounds of a block-wide (value desc, index asc) best
//      over the lists' heads and W's next entry (warp shuffles, then one
//      warp over the warps' winners and W); the winner is written out and
//      popped from its owner.
// The top k of the row stay in W or the lists: an element that left its
// thread's list, or never entered it, is behind K >= k better ones of that
// thread or below T.  Rows that fit in one group take no threshold.
// On the H100 (700 W, [1024, 47440], graph replay) k 1 reads 2.84 TB/s
// (0.068 ms) and k 5 runs 1.04x that (0.071 ms, the first design 0.167):
// bytes again.  Ascending rows, where every element beats T and inserts,
// are the worst case: 0.078 ms at k 5.  k 16 (0.116 ms) pays for 2 x 16
// block rounds and 74 registers a thread (3 blocks an SM; k 5 takes 55,
// 4 blocks; k 1 32, 8 blocks).
// The comparison (value desc, index asc) is a strict total order on
// (value, index) pairs, so thousands of ties (the NEG-filled lanes of the
// bos step) resolve the same way in every thread and in the merge, and
// -0.0 equals +0.0 as in the sort.  NaN is not ordered (the candidate
// table holds none): the kernel skips it.
//
// Layouts: x [B, C] float32 contiguous; vals [B, k] float32; idx [B, k]
// int64.  k <= 16.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int UNROLL = 4;          // 16-byte loads in flight a thread
constexpr int GROUP = THREADS * UNROLL;
constexpr int MAX_K = 16;
constexpr int NONE = 0x7fffffff;   // the index of an empty slot

__device__ __forceinline__ bool better(float a, int ia, float b, int ib) {
  return a > b || (a == b && ia < ib);
}

// a thread's own top-K, (value desc, index asc); empty slots hold NaN
template <int K>
struct TopList {
  float v[K];
  int ix[K];

  __device__ __forceinline__ void init() {
#pragma unroll
    for (int j = 0; j < K; ++j) {
      v[j] = NAN;
      ix[j] = NONE;
    }
  }

  // (x, c) goes in if it passes the filter (x > thr where STRICT, else
  // x >= thr; NaN never passes) and beats the last entry.  It goes in
  // front of entry j iff !(x <= v[j]): the entries are this thread's
  // earlier (lower) columns, so equal values stay in front.  Every index is
  // static, so the list stays in registers.
  template <bool STRICT>
  __device__ __forceinline__ void offer(float x, int c, float thr) {
    if (!(STRICT ? x > thr : x >= thr) || x <= v[K - 1]) return;
#pragma unroll
    for (int j = K - 1; j > 0; --j) {
      const bool here = !(x <= v[j]);
      const bool above = !(x <= v[j - 1]);
      v[j] = above ? v[j - 1] : (here ? x : v[j]);
      ix[j] = above ? ix[j - 1] : (here ? c : ix[j]);
    }
    if (!(x <= v[0])) {
      v[0] = x;
      ix[0] = c;
    }
  }

  __device__ __forceinline__ void pop() {
#pragma unroll
    for (int j = 0; j < K - 1; ++j) {
      v[j] = v[j + 1];
      ix[j] = ix[j + 1];
    }
    v[K - 1] = NAN;
    ix[K - 1] = NONE;
  }
};

__device__ __forceinline__ void warp_best(float& v, int& ix) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float ov = __shfl_xor_sync(0xffffffffu, v, o);
    const int oi = __shfl_xor_sync(0xffffffffu, ix, o);
    if (better(ov, oi, v, ix)) {
      v = ov;
      ix = oi;
    }
  }
}

struct Shared {
  float wv[MAX_K];   // W: the block's k best of the first group
  int wi[MAX_K];
  float v[WARPS];    // each warp's best head, a round
  int i[WARPS];
  float best_v;      // the round's winner
  int best_i;
};

// One round of the block-wide best over the lists' heads and W[cur] (while
// cur < nw); the owner pops its head.  Every thread returns the winner.
template <int K>
__device__ __forceinline__ void block_best(TopList<K>& top, Shared& sh,
                                           int& cur, int nw, float& wv,
                                           int& wi) {
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  float bv = top.ix[0] == NONE ? -INFINITY : top.v[0];
  int bi = top.ix[0];
  warp_best(bv, bi);
  if (lane == 0) {
    sh.v[warp] = bv;
    sh.i[warp] = bi;
  }
  __syncthreads();
  if (warp == 0) {
    bv = -INFINITY;
    bi = NONE;
    if (lane < WARPS) {
      bv = sh.v[lane];
      bi = sh.i[lane];
    } else if (lane == WARPS && cur < nw) {
      bv = sh.wv[cur];
      bi = sh.wi[cur];
    }
    warp_best(bv, bi);
    if (lane == 0) {
      sh.best_v = bv;
      sh.best_i = bi;
    }
  }
  __syncthreads();
  wv = sh.best_v;
  wi = sh.best_i;
  if (top.ix[0] == wi) top.pop();
  if (cur < nw && sh.wi[cur] == wi) ++cur;
}

// k = 1 fits in 32 registers a thread with no spill, so 8 blocks share an
// SM: 1056 rows in flight, one wave for B = 1024, which short rows need.
// Longer lists take what ptxas gives them (55 registers at k = 5, 4 blocks
// an SM): capped at 32 they spill, and ran slower on the beam table
template <int K>
constexpr int min_blocks() {
  return K == 1 ? 8 : 1;
}

__device__ __forceinline__ void load_group(float4 (&f)[UNROLL],
                                           const float4* __restrict__ xv,
                                           int nvec, int g) {
#pragma unroll
  for (int u = 0; u < UNROLL; ++u) {
    const int q = g * GROUP + u * THREADS + threadIdx.x;
    f[u] = q < nvec ? __ldg(xv + q) : make_float4(NAN, NAN, NAN, NAN);
  }
}

template <bool STRICT, int K>
__device__ __forceinline__ void offer_group(TopList<K>& top,
                                            const float4 (&f)[UNROLL],
                                            int head, int g, float thr) {
#pragma unroll
  for (int u = 0; u < UNROLL; ++u) {
    const int c = head + 4 * (g * GROUP + u * THREADS + threadIdx.x);
    top.template offer<STRICT>(f[u].x, c, thr);
    top.template offer<STRICT>(f[u].y, c + 1, thr);
    top.template offer<STRICT>(f[u].z, c + 2, thr);
    top.template offer<STRICT>(f[u].w, c + 3, thr);
  }
}

template <int K>
__global__ void __launch_bounds__(THREADS, min_blocks<K>())
topk_kernel(const float* __restrict__ x, float* __restrict__ out_v,
            long long* __restrict__ out_i, int C, int k) {
  __shared__ Shared sh;
  const long row = blockIdx.x;
  const int tid = threadIdx.x;
  const float* xr = x + row * (long)C;

  TopList<K> top;
  top.init();
  float thr = -INFINITY;
  float wv;
  int wi, cur = 0, nw = 0;

  // scalar head to 16-byte alignment, float4 body in groups, scalar tail;
  // a thread's columns come in ascending order
  int head = (int)(((16 - ((uintptr_t)xr & 15)) & 15) >> 2);
  head = head < C ? head : C;
  const int nvec = (C - head) >> 2;
  const float4* xv = reinterpret_cast<const float4*>(xr + head);
  const int ngroups = (nvec + GROUP - 1) / GROUP;
  float4 f[UNROLL];
  load_group(f, xv, nvec, 0);
  if (tid < head) top.template offer<false>(__ldg(xr + tid), tid, thr);
  offer_group<false>(top, f, head, 0, thr);
  if (ngroups > 1) {
    load_group(f, xv, nvec, 1);    // in flight under the selection
    // the threshold: the block's exact k best of the prefix so far, moved
    // into W.  Every later column lies above W's, so a later element equal
    // to the k-th of W loses to all k of W: the filter is strict.
    for (int r = 0; r < k; ++r) {
      block_best(top, sh, cur, 0, wv, wi);
      if (tid == 0) {
        sh.wv[r] = wv;
        sh.wi[r] = wi;
      }
    }
    thr = wv;    // the k-th of W
    nw = k;
    offer_group<true>(top, f, head, 1, thr);
    for (int g = 2; g < ngroups; ++g) {
      load_group(f, xv, nvec, g);
      offer_group<true>(top, f, head, g, thr);
    }
  }
  for (int c = head + 4 * nvec + tid; c < C; c += THREADS)
    top.template offer<false>(__ldg(xr + c), c, thr);

  // k rounds of the block-wide best over the heads and W
  for (int r = 0; r < k; ++r) {
    block_best(top, sh, cur, nw, wv, wi);
    if (tid == 0) {
      out_v[row * k + r] = wv;
      out_i[row * k + r] = wi;
    }
  }
}

template <int K>
void launch(const float* x, float* vals, long long* idx, int B, int C, int k,
            cudaStream_t stream) {
  topk_kernel<K><<<B, THREADS, 0, stream>>>(x, vals, idx, C, k);
}

}  // namespace

extern "C" int topk_lastdim(void* x, void* vals, void* idx, int B, int C,
                            int k, void* stream) {
  if (B < 1 || k < 1 || k > MAX_K || k > C)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* xp = static_cast<const float*>(x);
  float* vp = static_cast<float*>(vals);
  long long* ip = static_cast<long long*>(idx);
  switch (k) {
    case 1: launch<1>(xp, vp, ip, B, C, k, s); break;
    case 2: launch<2>(xp, vp, ip, B, C, k, s); break;
    case 3: launch<3>(xp, vp, ip, B, C, k, s); break;
    case 4: launch<4>(xp, vp, ip, B, C, k, s); break;
    case 5: launch<5>(xp, vp, ip, B, C, k, s); break;
    case 6: launch<6>(xp, vp, ip, B, C, k, s); break;
    case 7: launch<7>(xp, vp, ip, B, C, k, s); break;
    case 8: launch<8>(xp, vp, ip, B, C, k, s); break;
    default: launch<16>(xp, vp, ip, B, C, k, s); break;
  }
  return (int)cudaGetLastError();
}
