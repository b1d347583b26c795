// Fused vocab epilogue: x.W + b, log-softmax stats and per-row top-k
// (sm_90a).
//
// Replaces captioning_tpu/ops/logit_topk.py:_logit_topk_kernel; the Python
// wrapper, its launch plan and the plain twin are in ops/logit_topk.py.
//
// Bound on the H100: operations.  At the beam-5 B = 1024 step (N 5120,
// D 512, V1 9488) the product is 49.7 GFLOP against ~15 MB of inputs, so
// 0.050 ms at the 989 TFLOP/s bf16 tensor-core peak.
//
// The previous design ran the bf16 product on nvcuda::wmma 16x16x16
// fragments from synchronous 16-byte copies, two __syncthreads a 32-wide D
// chunk and no second stage, staged the product through shared memory and
// gave each warp 8 rows of five warp reductions a tile: loads, products
// and epilogue ran one after the other, at 3.7% of the peak.
//
// bf16 design (logit_topk_wgmma):
// - Block (row block, split) owns BM = 64 * MH rows of x (MH = 2 for
//   D <= 512, 1 for D <= 1024) and one contiguous range of TN = 64-column
//   vocab tiles.  Its rows of x go into shared memory once, by TMA (one
//   [BM, 64] box per 64-wide D chunk, 128-byte swizzle), for the whole
//   range.
// - W streams by TMA through a ring of STAGES = 12 [64, 64] chunks under
//   mbarriers (full: the producer's expect_tx; empty: one arrival per
//   consumer warp).  One thread of a producer warp keeps the loads in
//   flight.
// - Two consumer warpgroups take the block's tiles in turn (even tiles,
//   odd tiles).  Each runs the tile's product on wgmma.mma_async
//   m64n64k16 (both operands K-major from the swizzled shared tiles,
//   float32 accumulators in registers, MH row halves) and then its
//   epilogue from registers, while the other warpgroup's product runs.
//   Two named barriers make the product phases alternate, so the ring is
//   consumed in the order it was loaded (a parity wait never runs ahead
//   of its barrier's phase).  The tile is 64 wide, not 128, so that the
//   accumulators of both row halves (2 x 32 a thread) and the epilogue fit
//   the 168 registers a thread of a 288-thread block gets without spills
//   (at 128 wide they spilled).
// - Epilogue: in the accumulator layout a row's 64 values sit in one quad
//   of 4 lanes, 16 per lane.  Each thread keeps running stats for its own
//   columns (max m, S = sum exp(t - m), E = sum exp(t - m)(t - m), the sum
//   of t, and the raw logit at unk_idx), rescaled once a tile; the quad
//   combines them (2 shuffles each) once, at the end of the range.  Top-k:
//   each thread keeps its own sorted top-K list per row in registers (K
//   the smallest of 1, 2, 4, 5, 8, 16 not below k); an entry is inserted
//   (K branch-free compare-and-swaps) only if it beats the list's K-th
//   best under (value desc, index asc), so after the first tiles nearly
//   nothing is.  No lane waits on another's insertions; the quad's four
//   lists are merged into the row's top-k once, at the end (k rounds of a
//   2-shuffle argmax).  (A first version shared one list per row in shared
//   memory, the quad's lanes inserting in turn: k = 5 ran several times
//   slower than k = 1.)
// - Rounding as the twin: the product is rounded to bf16, the bias added
//   and rounded again, then divided by temp in float32.  unk_bias is added
//   at unk_idx after the softmax (S' and E' are S and E with the unk
//   column's term swapped, sum t' = sum t + unk_bias).
// - Each warpgroup writes its partials (m, S, S', E', sum t', top-k) to
//   the workspace as one part; logit_topk_merge combines the parts per row
//   with the full (value desc, index asc) comparator, so the merge is exact
//   whatever order the parts come in.
//
// float32 keeps its CUDA-core FMA product (wgmma in float32 would be TF32):
// block (row block, split) of ROWS = 64 rows, the [64, 128] tile staged in
// shared memory, warp w folding rows 8w..8w+7 into the same stats and a
// shared-memory top-k; one part per split.
//
// Layouts: x [N, D], w [V1, D] (nn.Linear), b [V1], all float32 or bfloat16
// (dtype 0 / 1; bf16 needs D % 8 == 0, D <= 1024 and x, w 16-byte aligned,
// b 4-byte aligned).  Workspace: wf [parts, N, 5 + k] float, wi [parts, N,
// k] int, parts = splits (float32) or 2 * splits (bf16).  Outputs: vals
// [N, k] f32, idx [N, k] i32, row_sum [N] f32, ent [N] f32.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int MAXK = 16;
constexpr float NEG = -1e9f;           // running-max start (0 * NEG == 0)

// (value desc, index asc): true when (v1, i1) ranks before (v0, i0)
__device__ __forceinline__ bool better(float v1, int i1, float v0, int i0) {
  return v1 > v0 || (v1 == v0 && i1 < i0);
}

// =========================================================================
// float32: CUDA-core FMA product
// =========================================================================

constexpr int ROWS = 64;
constexpr int TV = 128;
constexpr int KC = 32;
constexpr int THREADS = 256;
constexpr int CT_LD = TV + 4;          // float tile row stride
constexpr int CT_BYTES = ROWS * CT_LD * 4;
constexpr int F32_BYTES = (KC * (ROWS + 1) + KC * (TV + 1)) * 4;
constexpr int STAGE_BYTES = CT_BYTES > F32_BYTES ? CT_BYTES : F32_BYTES;

__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// the [ROWS, TV] product tile into ct (ld CT_LD); thread (warp, lane) owns
// rows 8*warp .. 8*warp+7 and columns lane + 32 * j
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

__global__ void __launch_bounds__(THREADS)
logit_topk_split(const float* __restrict__ x, const float* __restrict__ w,
                 const float* __restrict__ b, float* __restrict__ wf,
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
      bias[j] = valid[j] ? b[col] : 0.f;
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int row = 8 * warp + i;
      float t[4], tp[4];
      float mt = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = c0 + lane + 32 * j;
        t[j] = (ct[row * CT_LD + lane + 32 * j] + bias[j]) / temp;
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

// =========================================================================
// bf16: wgmma product, W streamed by TMA, epilogue from registers
// =========================================================================

constexpr int TN = 64;                  // vocab tile (the wgmma N)
constexpr int KCH = 64;                 // D chunk: one 128-byte swizzled row
constexpr int STAGES = 12;              // W ring depth
constexpr int W_CHUNK = TN * KCH * 2;   // 8 KB
constexpr int X_BYTES = 128 * 1024;     // BM * pad64(D) * 2 at most
constexpr int WG_THREADS = 288;         // 2 consumer warpgroups + producer

// 1024 of alignment slack, x, the ring, the barriers
constexpr int WG_SMEM =
    1024 + X_BYTES + STAGES * W_CHUNK + (1 + 2 * STAGES) * 8;
static_assert(WG_SMEM <= 232448, "shared memory over 227 KB");

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

// a fault in the pipeline's protocol traps (a launch error) instead of
// spinning for ever: no legitimate wait lasts more than microseconds
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

// one [box rows, 64] bf16 box at (col, row) of the map into dst
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         int col, int row, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(col), "r"(row),
      "r"(smem_u32(bar))
      : "memory");
}

// shared-memory matrix descriptor: K-major, 128-byte swizzle, 8-row groups
// 1024 bytes apart (the TMA box layout); the tile base is 1024-aligned and
// a k16 step inside the 128-byte row moves the start by 32 bytes
__device__ __forceinline__ uint64_t desc_sw128(const void* p) {
  return static_cast<uint64_t>((smem_u32(p) & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(1) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) |
         (static_cast<uint64_t>(1) << 62);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int PENDING>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(PENDING)
               : "memory");
}
// named barriers 1 and 2 between the two consumer warpgroups (256 threads)
__device__ __forceinline__ void bar_sync(int id) {
  asm volatile("bar.sync %0, 256;\n" ::"r"(id) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id) {
  asm volatile("bar.arrive %0, 256;\n" ::"r"(id) : "memory");
}
// keep the compiler from moving accumulator accesses across the async MMA
__device__ __forceinline__ void fence_acc(float* d) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d[32] (+)= A[64, 16] . B[64, 16]^T, both from shared memory
__device__ __forceinline__ void wgmma_64(float* d, uint64_t da, uint64_t db,
                                         int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// Per thread and row: running stats over the thread's own columns.
struct RowStats {
  float m, s, e, ts, tu;   // max, sum exp, sum exp * (t - m), sum t, t[unk]
};

// insert (v, col) into the sorted register list l[0..K) (the last entry
// drops out): one compare-and-swap a position, no branch
template <int K>
__device__ __forceinline__ void insert(float* lv, int* li, float v, int col) {
#pragma unroll
  for (int p = 0; p < K; ++p) {
    const bool sw = better(v, col, lv[p], li[p]);
    const float ov = lv[p];
    const int oi = li[p];
    lv[p] = sw ? v : ov;
    li[p] = sw ? col : oi;
    v = sw ? ov : v;
    col = sw ? oi : col;
  }
}

// Fold one tile's accumulators (rows of one half) into the stats and the
// thread's own top-K lists.  Accumulator element r = 4j + 2i + e is row
// row_l0 + 8i of the half, column c0 + 8j + 2 * (lane % 4) + e.
// The logit is divided by temp exactly: rt = RN(1 / temp), q0 = RN(t rt),
// t - q0 temp is exact by FMA, and RN(q0 + (t - q0 temp) rt) = RN(t / temp)
// (Markstein), 3 instructions; at temp 1 it is t.
template <bool RAGGED, int K>
__device__ __forceinline__ void fold_tile(
    float* acc, const __nv_bfloat162* bias, RowStats* st, float (*lv)[K],
    int (*li)[K], int c0, int V1, int unk_idx, float temp, float rt,
    float unk_bias) {
  const int q2 = 2 * (threadIdx.x % 4);
  const bool has_unk = unk_idx >= c0 && unk_idx < c0 + TN;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    RowStats& s = st[i];
    // pass 1: the logits, their max and sum
    float mt = -INFINITY, ts = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float& a = acc[4 * j + 2 * i + e];
        const float bb = e ? __high2float(bias[j]) : __low2float(bias[j]);
        const float t0 = bf16_round(bf16_round(a) + bb);
        const float q0 = t0 * rt;
        float t = fmaf(fmaf(-temp, q0, t0), rt, q0);
        if (RAGGED && c0 + 8 * j + q2 + e >= V1) {
          t = -INFINITY;
        } else {
          mt = fmaxf(mt, t);
          ts += t;
        }
        a = t;
      }
    }
    // pass 2: rescale once, then sum exp and exp * (t - m) over the tile
    const float mn = fmaxf(s.m, mt);
    const float r = __expf(s.m - mn);
    float es = 0.f, ee = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float d = acc[4 * j + 2 * i + e] - mn;
        const float x = __expf(d);
        if (!RAGGED || c0 + 8 * j + q2 + e < V1) {
          es += x;
          ee = fmaf(x, d, ee);
        }
      }
    }
    s.e = r * (s.e + (s.m - mn) * s.s) + ee;
    s.s = s.s * r + es;
    s.ts += ts;
    s.m = mn;
    // the UNK column: remember its raw logit, offer the adjusted one
    if (has_unk) {
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          if (c0 + 8 * j + q2 + e == unk_idx) {
            s.tu = acc[4 * j + 2 * i + e];
            acc[4 * j + 2 * i + e] += unk_bias;
          }
    }
    // pass 3: an entry joins the thread's own top-K only if it beats the
    // list's K-th best; after the first tiles nearly nothing does.  The
    // filter marks a bit per candidate, and each lane then walks only its
    // own bits (a lane inserting does not make the others run the
    // insertion for that slot)
    uint32_t cand = 0;                          // bit 2j + e
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = c0 + 8 * j + q2 + e;
        if ((!RAGGED || col < V1) &&
            better(acc[4 * j + 2 * i + e], col, lv[i][K - 1], li[i][K - 1]))
          cand |= 1u << (2 * j + e);
      }
    while (cand) {
      const int bit = __ffs(cand) - 1;
      cand &= cand - 1;
      float v = 0.f;
#pragma unroll
      for (int x = 0; x < 16; ++x)
        if (bit == x) v = acc[4 * (x / 2) + 2 * i + x % 2];
      const int col = c0 + 8 * (bit / 2) + q2 + bit % 2;
      if (better(v, col, lv[i][K - 1], li[i][K - 1]))
        insert<K>(lv[i], li[i], v, col);
    }
  }
}

template <int MH, int K>
__global__ void __launch_bounds__(WG_THREADS, 1)
logit_topk_wgmma(const __grid_constant__ CUtensorMap tx,
                 const __grid_constant__ CUtensorMap tw,
                 const __nv_bfloat16* __restrict__ b, float* __restrict__ wf,
                 int* __restrict__ wi, int N, int D, int V1, int k,
                 int unk_idx, int tiles_per_split, float temp,
                 float unk_bias) {
  constexpr int BM = 64 * MH;
  constexpr int X_CHUNK = BM * KCH * 2;       // one [BM, 64] box
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  unsigned char* xs = smem;
  unsigned char* ring = smem + X_BYTES;
  uint64_t* x_full = reinterpret_cast<uint64_t*>(ring + STAGES * W_CHUNK);
  uint64_t* full = x_full + 1;
  uint64_t* empty = full + STAGES;

  const int nch = (D + KCH - 1) / KCH;
  const int row0 = blockIdx.x * BM;
  const int tiles = (V1 + TN - 1) / TN;
  const int t_begin = blockIdx.y * tiles_per_split;
  const int ntile = max(0, min(tiles, t_begin + tiles_per_split) - t_begin);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    mbar_init(x_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, 4);          // lane 0 of each consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == 8) {
    // producer warp: one thread loads x once, then the W chunks of every
    // tile in order
    if (lane == 0) {
      mbar_expect_tx(x_full, nch * X_CHUNK);
      for (int c = 0; c < nch; ++c)
        tma_load(xs + c * X_CHUNK, &tx, c * KCH, row0, x_full);
      for (int seq = 0; seq < ntile * nch; ++seq) {
        const int stage = seq % STAGES, use = seq / STAGES;
        mbar_wait(empty + stage, (use & 1) ^ 1);
        mbar_expect_tx(full + stage, W_CHUNK);
        tma_load(ring + stage * W_CHUNK, &tw, (seq % nch) * KCH,
                 (t_begin + seq / nch) * TN, full + stage);
      }
    }
    return;
  }

  // consumers: warpgroup g takes tiles g, g + 2, ...; thread (wq, lane)
  // holds rows 64h + 16wq + lane / 4 + 8i of the block
  const float rt = 1.f / temp;
  const int g = warp / 4, wq = warp % 4, quad = lane % 4;
  const int row_l0 = 16 * wq + lane / 4;
  RowStats st[MH][2];
  float lv[MH][2][K];
  int li[MH][2][K];
#pragma unroll
  for (int h = 0; h < MH; ++h)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      st[h][i] = {NEG, 0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int p = 0; p < K; ++p) {
        lv[h][i][p] = -INFINITY;
        li[h][i][p] = INT_MAX;
      }
    }
  bool holds_unk = false;
  mbar_wait(x_full, 0);

  for (int tt = g; tt < ntile; tt += 2) {
    const int c0 = (t_begin + tt) * TN;
    // this thread's 8 bias pairs (columns c0 + 8j + 2 * quad, + 1)
    __nv_bfloat162 bias[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = c0 + 8 * j + 2 * quad;
      if (col + 1 < V1) {
        bias[j] = *reinterpret_cast<const __nv_bfloat162*>(b + col);
      } else {
        bias[j] = __floats2bfloat162_rn(0.f, 0.f);
        if (col < V1) bias[j].x = b[col];
      }
    }
    float acc[MH][32];
#pragma unroll
    for (int h = 0; h < MH; ++h)
#pragma unroll
      for (int r = 0; r < 32; ++r) acc[h][r] = 0.f;
    // the product phases alternate between the warpgroups (tile tt - 1's
    // owner signals when its products are done), so the ring is consumed
    // in its load order and each epilogue runs beside the other
    // warpgroup's products
    if (tt > 0) bar_sync(1 + g);
    int prev = 0;
    for (int c = 0; c < nch; ++c) {
      const int seq = tt * nch + c, stage = seq % STAGES;
      mbar_wait(full + stage, (seq / STAGES) & 1);
#pragma unroll
      for (int h = 0; h < MH; ++h) fence_acc(acc[h]);
      wg_fence();
      const unsigned char* wtile = ring + stage * W_CHUNK;
#pragma unroll
      for (int kk = 0; kk < KCH / 16; ++kk)
#pragma unroll
        for (int h = 0; h < MH; ++h)
          wgmma_64(acc[h],
                   desc_sw128(xs + c * X_CHUNK + h * 64 * 128 + kk * 32),
                   desc_sw128(wtile + kk * 32), (c | kk) != 0);
      wg_commit();
#pragma unroll
      for (int h = 0; h < MH; ++h) fence_acc(acc[h]);
      if (c > 0) {
        // the previous chunk's products are done: hand its stage back
        wg_wait<1>();
        __syncwarp();
        if (lane == 0) mbar_arrive(empty + prev);
      }
      prev = stage;
    }
    wg_wait<0>();
#pragma unroll
    for (int h = 0; h < MH; ++h) fence_acc(acc[h]);
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + prev);
    if (tt + 1 < ntile) bar_arrive(2 - g);

    if (unk_idx >= c0 && unk_idx < c0 + TN &&
        (unk_idx - c0) % 8 / 2 == quad)
      holds_unk = true;
#pragma unroll
    for (int h = 0; h < MH; ++h) {
      if (c0 + TN > V1)
        fold_tile<true, K>(acc[h], bias, st[h], lv[h], li[h], c0, V1,
                           unk_idx, temp, rt, unk_bias);
      else
        fold_tile<false, K>(acc[h], bias, st[h], lv[h], li[h], c0, V1,
                            unk_idx, temp, rt, unk_bias);
    }
  }

  // once, at the end of the range: the quad's stats combined (2 shuffles
  // each) and its four lists merged into the row's top-k; this
  // warpgroup's part of the workspace
  const int part = 2 * blockIdx.y + g;
#pragma unroll
  for (int h = 0; h < MH; ++h)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const RowStats& s = st[h][i];
      float sp = s.s, ep = s.e, ts = s.ts;
      if (holds_unk) {
        // swap the unk column's term for its adjusted one
        const float d0 = s.tu - s.m, d1 = d0 + unk_bias;
        const float x0 = expf(d0), x1 = expf(d1);
        sp = sp - x0 + x1;
        ep = ep - x0 * d0 + x1 * d1;
        ts += unk_bias;
      }
      float M = s.m;
      M = fmaxf(M, __shfl_xor_sync(0xffffffffu, M, 1));
      M = fmaxf(M, __shfl_xor_sync(0xffffffffu, M, 2));
      const float r = expf(s.m - M);
      float v[4] = {s.s * r, sp * r, r * (ep + (s.m - M) * sp), ts};
#pragma unroll
      for (int f = 0; f < 4; ++f) {
        v[f] += __shfl_xor_sync(0xffffffffu, v[f], 1);
        v[f] += __shfl_xor_sync(0xffffffffu, v[f], 2);
      }
      const int gr = row0 + row_l0 + 64 * h + 8 * i;
      const long base = (long)part * N + gr;
      float* f = wf + base * (5 + k);
      if (quad == 0 && gr < N) {
        f[0] = M;
        f[1] = v[0];
        f[2] = v[1];
        f[3] = v[2];
        f[4] = v[3];
      }
      // k rounds: the best head of the four lists; its owner pops it
      for (int q = 0; q < k; ++q) {
        float bv = lv[h][i][0];
        int bi = li[h][i][0];
#pragma unroll
        for (int o = 1; o <= 2; o <<= 1) {
          const float ov = __shfl_xor_sync(0xffffffffu, bv, o);
          const int oi = __shfl_xor_sync(0xffffffffu, bi, o);
          if (better(ov, oi, bv, bi)) {
            bv = ov;
            bi = oi;
          }
        }
        if (li[h][i][0] == bi) {
#pragma unroll
          for (int p = 0; p + 1 < K; ++p) {
            lv[h][i][p] = lv[h][i][p + 1];
            li[h][i][p] = li[h][i][p + 1];
          }
          lv[h][i][K - 1] = -INFINITY;
          li[h][i][K - 1] = INT_MAX;
        }
        if (quad == 0 && gr < N) {
          f[5 + q] = bv;
          wi[base * k + q] = bi;
        }
      }
    }
}

// one thread per row: combine the parts' stats, merge their top-k lists
__global__ void logit_topk_merge(const float* __restrict__ wf,
                                 const int* __restrict__ wi,
                                 float* __restrict__ out_vals,
                                 int* __restrict__ out_idx,
                                 float* __restrict__ out_rowsum,
                                 float* __restrict__ out_ent, int N, int V1,
                                 int k, int parts) {
  const int gr = blockIdx.x * blockDim.x + threadIdx.x;
  if (gr >= N) return;
  float M = NEG;
  for (int p = 0; p < parts; ++p)
    M = fmaxf(M, wf[((long)p * N + gr) * (5 + k)]);
  float S = 0.f, SP = 0.f, EP = 0.f, TS = 0.f;
  float tv[MAXK], cv[MAXK];
  int ti[MAXK], ci[MAXK];
  for (int q = 0; q < k; ++q) {
    tv[q] = -INFINITY;
    ti[q] = INT_MAX;
  }
  for (int p = 0; p < parts; ++p) {
    const float* f = wf + ((long)p * N + gr) * (5 + k);
    const int* fi = wi + ((long)p * N + gr) * k;
    const float r = expf(f[0] - M);
    S += f[1] * r;
    SP += f[2] * r;
    EP += r * (f[3] + (f[0] - M) * f[2]);
    TS += f[4];
    // merge two sorted lists under (value desc, index asc)
    int a = 0, bb = 0;
    for (int q = 0; q < k; ++q) {
      if (bb < k && (a >= k || better(f[5 + bb], fi[bb], tv[a], ti[a]))) {
        cv[q] = f[5 + bb];
        ci[q] = fi[bb];
        ++bb;
      } else {
        cv[q] = tv[a];
        ci[q] = ti[a];
        ++a;
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

// a [rows, inner] bf16 tensor seen in [box_rows, 64] boxes, 128-byte
// swizzle, zeros outside
bool make_map(CUtensorMap* map, const void* base, int inner, int rows,
              int box_rows) {
  cuuint64_t dims[2] = {(cuuint64_t)inner, (cuuint64_t)rows};
  cuuint64_t strides[1] = {(cuuint64_t)inner * 2};
  cuuint32_t box[2] = {(cuuint32_t)KCH, (cuuint32_t)box_rows};
  cuuint32_t elem[2] = {1, 1};
  return cuTensorMapEncodeTiled(
             map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
             const_cast<void*>(base), dims, strides, box, elem,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int MH, int K>
cudaError_t launch_wgmma(const void* x, const void* w, const void* b,
                         void* wf, void* wi, int N, int D, int V1, int k,
                         int unk_idx, int splits, float temp, float unk_bias,
                         cudaStream_t stream) {
  CUtensorMap tx, tw;
  if (!make_map(&tx, x, D, N, 64 * MH) || !make_map(&tw, w, D, V1, TN))
    return cudaErrorInvalidValue;
  static bool sized = false;
  if (!sized) {
    const cudaError_t e = cudaFuncSetAttribute(
        logit_topk_wgmma<MH, K>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, WG_SMEM);
    if (e != cudaSuccess) return e;
    sized = true;
  }
  const int tiles = (V1 + TN - 1) / TN;
  const int per = (tiles + splits - 1) / splits;
  dim3 grid((N + 64 * MH - 1) / (64 * MH), splits);
  logit_topk_wgmma<MH, K><<<grid, WG_THREADS, WG_SMEM, stream>>>(
      tx, tw, static_cast<const __nv_bfloat16*>(b), static_cast<float*>(wf),
      static_cast<int*>(wi), N, D, V1, k, unk_idx, per, temp, unk_bias);
  return cudaGetLastError();
}

// each thread's list length: the smallest of 1, 2, 4, 5 (the beam width of
// the papers' eval), 8 and 16 not below k
template <int MH>
cudaError_t launch_wgmma_k(const void* x, const void* w, const void* b,
                           void* wf, void* wi, int N, int D, int V1, int k,
                           int unk_idx, int splits, float temp,
                           float unk_bias, cudaStream_t s) {
#define LAUNCH(K)                                                       \
  return launch_wgmma<MH, K>(x, w, b, wf, wi, N, D, V1, k, unk_idx,     \
                             splits, temp, unk_bias, s)
  if (k <= 1) LAUNCH(1);
  if (k <= 2) LAUNCH(2);
  if (k <= 4) LAUNCH(4);
  if (k <= 5) LAUNCH(5);
  if (k <= 8) LAUNCH(8);
  LAUNCH(16);
#undef LAUNCH
}

}  // namespace

// A split left without a tile contributes nothing: its parts are m = NEG,
// zero sums and an empty list.
extern "C" int logit_topk(void* x, void* w, void* b, void* wf, void* wi,
                          void* vals, void* idx, void* rowsum, void* ent,
                          int N, int D, int V1, int k, int unk_idx,
                          int splits, float temp, float unk_bias, int dtype,
                          void* stream) {
  if (k < 1 || k > MAXK || splits < 1 || N < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int parts = splits;
  if (dtype == 1) {
    if (D % 8 || D > 1024) return (int)cudaErrorInvalidValue;
    const cudaError_t e =
        D <= 512 ? launch_wgmma_k<2>(x, w, b, wf, wi, N, D, V1, k,
                                     unk_idx, splits, temp, unk_bias, s)
                 : launch_wgmma_k<1>(x, w, b, wf, wi, N, D, V1, k,
                                     unk_idx, splits, temp, unk_bias, s);
    if (e != cudaSuccess) return (int)e;
    parts = 2 * splits;
  } else {
    const int tiles = (V1 + TV - 1) / TV;
    const int per = (tiles + splits - 1) / splits;
    dim3 grid((N + ROWS - 1) / ROWS, splits);
    logit_topk_split<<<grid, THREADS, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(w),
        static_cast<const float*>(b), static_cast<float*>(wf),
        static_cast<int*>(wi), N, D, V1, k, unk_idx, per, temp, unk_bias);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  logit_topk_merge<<<(N + 127) / 128, 128, 0, s>>>(
      static_cast<const float*>(wf), static_cast<const int*>(wi),
      static_cast<float*>(vals), static_cast<int*>(idx),
      static_cast<float*>(rowsum), static_cast<float*>(ent), N, V1, k,
      parts);
  return (int)cudaGetLastError();
}
