// K2: backward of the fused DeltaLayer + c_conv1 (K1) for Hopper (sm_90a), both
// products on the tensor cores in error-compensated 3xTF32.
//
// For the cotangent g (B, W', J, F) of K1's output, with
// diff = a[b, i, c] - bb[b, S*j + k, c] recomputed (never stored):
//
//   gw[b, i, j, k, c]  = sum_f g[b, i, j, f] * W[k, c, f]
//   da[b, i, c]        =  sum_{j, k} gw * sign(diff)         sign(0) = 0
//   db[b, S*j + k, c]  = -sum_i      gw * sign(diff)
//   dW[k, c, f]        =  sum_{b, i, j} |diff| * g[b, i, j, f]
//
// a, bb: (B, W', C) fp32; W: (S, C, F = 64); J = W' / S. One call computes
// the part of a group of at most 32 right columns j0 <= j < j0 + Jc: da's and
// dW's parts from those columns and db's rows S*j0 .. S*(j0 + Jc) - 1, which
// no other group writes. The wrapper (kernels/delta_conv1.py) runs the groups
// in order and adds da's and dW's parts in that order; it zero-pads C to a
// multiple of 128 and zeroes the rows of db past J*S.
//
// Replaces the JAX package's custom VJP of its Pallas kernel,
// ops/pallas_delta.py::_core_bwd over _bwd_block: a lax.scan over blocks of
// 24 left rows that materializes a (B, 24, J, S, C) difference block per
// step. That scan is not carried over. Both halves are matrix products of
// K1's size whose operand is formed on the fly (P1: gw masked by a recomputed
// sign; P2: |diff| against g), 4*B*W'*J*S*C*F flops in all (67.9 GFLOP at
// B = 16, W' = 360) against some 50 MB of inputs and outputs: operations
// bound it. fp32 products on the tensor cores take three TF32 passes
// (x = hi + lo, hi = tf32(x), lo = tf32(x - hi), rounded to nearest, ties
// away; hi*hi + hi*lo + lo*hi summed in fp32), so the floor is
// 3 * flops / the TF32 dense peak (0.412 ms at B = 16, W' = 360 on an H100
// SXM).
//
// Design. Both products put the 128 channels of a block on the wgmma M axis
// (two consumer warpgroups, 64 channels each), so a thread owns two channels
// c for the whole block: the right rows bb[S*j + k, c] it needs sit in a
// dozen registers, the left rows a[i, c] are a handful of loads per tile, and
// every sum is a sum over the thread's own accumulator registers. Nothing of
// a or bb is staged in shared memory.
// - split_g_kernel (pre-pass, once per call) writes g split into tf32 hi / lo
//   twice: row-major (rows (i, j), K = f contiguous: P1's B operand) and
//   transposed (rows f, the (i, j) rows contiguous: P2's B operand, which TMA
//   cannot produce from g's layout). In both, each left row's J entries are
//   padded to Jp = 8 * JB (a multiple of wgmma's k8 / n8 groups) and the left
//   rows to a multiple of the tile; the padding is zero, so padded rows add
//   nothing to any sum. split_w_kernel splits W.
// - dab_kernel (P1), one block per (tap k, batch element, 128 channels):
//   D[c, m] = sum_f W[k][c, f] * g[m, f] for tiles of 128 padded (i, j)
//   rows m (TI = 16 / JB whole left rows) as wgmma m64n128k8 with both
//   operands in shared memory: W[k] hi / lo arrive once by TMA, the g tiles
//   through a 2-stage TMA ring fed by one producer thread. In the
//   accumulator fragment a thread holds channels c, c + 8 and columns
//   8 nb + 2 t + e: column group nb belongs to left row nb / JB and right
//   rows 8 (nb % JB) + 2 t + e. The epilogue masks each accumulator with
//   sign(a - bb) in registers; da's sum over j is a sum over the thread's
//   registers and two shuffles over t, written per tap to scratch; db's sum
//   over i runs in 4 JB registers over all tiles and is written once: db
//   needs no sum across blocks or threads at all.
// - dw_kernel (P2), same grid: dW[k][c, f] = sum_m |diff|[c, m] * g^T[f, m] as
//   wgmma m64n64k8 with A = |diff|^T formed and split in registers (K1's
//   formation with the roles of rows and K swapped) and B = g^T hi / lo
//   chunks of 32 rows m through an 8-stage TMA ring. The tensor cores' fp32
//   accumulation drops low bits on every wgmma, and this sum runs over all
//   W' * Jp rows: the accumulators are flushed into fp32 sums on the CUDA
//   cores every FLUSH_ROWS left rows. Partials per batch element go to
//   scratch.
// - sum_axis_kernel adds da's S tap parts and dW's B batch parts in order.
//   No atomics anywhere: two runs give the same bits.
// An mbarrier wait that spins past SPIN_LIMIT traps instead of hanging.
// What bounds it now (scripts/k2_probe.py times the parts; PERF.md has the
// numbers): the wgmma themselves. P1 without its epilogue keeps 85% of its
// time; P2 is slower than its wgmma alone and than its fragment formation
// alone, which overlap only in part. Then the pre-pass and the ordered sums
// (a ninth of the time) and the grid's tail: S * B blocks of one per SM are
// 1.8 waves of 132 SMs at B = 16. A second accumulator set for P1 (the next
// tile's wgmma under this tile's epilogue) spilled and doubled P1's time, and
// forming P2's next fragments behind the wgmma in flight gained nothing
// measurable: neither is here.

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int F = 64;              // features: the cotangent's last axis
constexpr int CT = 128;            // channels per block: two m64 tiles
constexpr int MAX_JB = 4;          // Jp / 8 at most: 32 columns a call
constexpr int CONSUMER_WGS = 2;
constexpr int CONSUMERS = 128 * CONSUMER_WGS;
constexpr int THREADS = CONSUMERS + 128;  // + one producer warpgroup
constexpr int TILE_M = 128;        // P1: padded (i, j) rows per tile, the wgmma N
constexpr int P1_STAGES = 2;
constexpr int W_HALF_BYTES = 64 * 32 * 4;       // 64 channels x 32 features: 8 KB
constexpr int W_BYTES = 2 * CONSUMER_WGS * 2 * W_HALF_BYTES;  // hi/lo, warpgroup, f half
constexpr int G_HALF_BYTES = TILE_M * 32 * 4;   // 128 rows x 32 features: 16 KB
constexpr int P1_STAGE_BYTES = 4 * G_HALF_BYTES;  // hi/lo x f half
constexpr int P2_STAGES = 8;
constexpr int KC = 32;             // P2: rows m per ring stage (four k8 steps)
constexpr int GT_TILE_BYTES = F * KC * 4;       // 64 features x 32 rows: 8 KB
constexpr int P2_STAGE_BYTES = 2 * GT_TILE_BYTES;  // hi + lo
constexpr int FLUSH_ROWS = 4;      // P2: left rows between fp32 flushes (multiple of 4)
constexpr long long SPIN_LIMIT = 1ll << 22;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ uint32_t tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

// cvt.rna.tf32.f32 for finite x in two integer ops: half a TF32 ulp added to
// the magnitude, then the 13 low bits cleared. tf32_rna_abs also clears the
// sign: tf32(|x|).
__device__ __forceinline__ uint32_t tf32_rna_bits(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
}
__device__ __forceinline__ uint32_t tf32_rna_abs(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0x7FFFE000u;
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  long long spins = 0;
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (!done && ++spins > SPIN_LIMIT) __trap();
  } while (!done);
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int x, int y) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(x), "r"(y)
      : "memory");
}

// wgmma descriptor of a K-major tile written by TMA with the 128-byte
// swizzle: rows of 128 B, 8-row groups 1024 B apart (SBO); LBO is unused.
__device__ __forceinline__ uint64_t kmajor_sw128_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (1ull << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

// D (64 x 64, fp32) = A (64 x 8, tf32, registers) * B (8 x 64, tf32, shared)
// + (accumulate ? D : 0).
// A fragment of a thread (lane = 4g + t within warp w of the warpgroup):
// a0 (16w + g, t), a1 (16w + g + 8, t), a2 (16w + g, t + 4), a3 (16w + g + 8, t + 4).
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], uint32_t a0, uint32_t a1,
                                             uint32_t a2, uint32_t a3, uint64_t desc_b,
                                             int accumulate) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %37, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32"
      " {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31},"
      " {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(desc_b), "r"(accumulate));
}

#define K2_ACC8(d, i)                                                                 \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]),         \
      "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])

// D (64 x 128, fp32) = A (64 x 8, tf32, shared) * B (8 x 128, tf32, shared)
// + (accumulate ? D : 0). Accumulator n of a thread: row 16w + g + 8 ((n / 2) % 2),
// column 8 (n / 4) + 2 t + n % 2.
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t desc_a,
                                              uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %66, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32"
      " {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63},"
      " %64, %65, p, 1, 1;\n}\n"
      : K2_ACC8(d, 0), K2_ACC8(d, 8), K2_ACC8(d, 16), K2_ACC8(d, 24), K2_ACC8(d, 32),
        K2_ACC8(d, 40), K2_ACC8(d, 48), K2_ACC8(d, 56)
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}

// Keeps the compiler from moving accumulator reads across the wgmma wait.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// x times sign(d), sign(0) = 0.
__device__ __forceinline__ float times_sign(float x, float d) {
  return d > 0.f ? x : (d < 0.f ? -x : 0.f);
}

// 1024-aligned start of the dynamic shared memory (the 128-byte swizzle's
// period).
__device__ __forceinline__ uint8_t* aligned_smem(uint8_t* raw) {
  return raw + ((1024 - (smem_u32(raw) & 1023)) & 1023);
}

// The weight (S, C, F) split: ws[0] = tf32 hi, ws[1] = tf32 lo, each (S*C, F).
__global__ void split_w_kernel(const float* __restrict__ w, float* __restrict__ ws, int n) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= n) return;
  const float x = w[idx];
  const uint32_t hi = tf32_rna(x);
  ws[idx] = __uint_as_float(hi);
  ws[n + idx] = __uint_as_float(tf32_rna(x - __uint_as_float(hi)));
}

// g (B, W', J, F), from its column j0 on (g points at entry j0), split into
// tf32 hi / lo and padded: padded row mp = i * jp + j (j < jp,
// i < m_pad / jp) is g[b, i, j0 + j] for j < j_count, else zero.
//   gs (2, B, m_pad, F): [0] hi, [1] lo, row-major (null: not written);
//   gt (B, 2, F, m_pad): the same transposed (null: not written).
// Grid (m_pad / 32, B), 256 threads.
__global__ void __launch_bounds__(256)
split_g_kernel(const float* __restrict__ g, float* __restrict__ gs, float* __restrict__ gt,
               int width, int j_total, int j_count, int jp, int m_pad) {
  __shared__ float hi_s[32][F + 1], lo_s[32][F + 1];
  const int batch = blockIdx.y, m0 = 32 * blockIdx.x, tid = threadIdx.x;
  const long long part = (long long)gridDim.y * m_pad * F;
  for (int idx = tid; idx < 32 * F; idx += 256) {
    const int ml = idx / F, f = idx % F, mp = m0 + ml, i = mp / jp, j = mp - i * jp;
    const float x = (i < width && j < j_count)
                        ? __ldg(g + (((long long)batch * width + i) * j_total + j) * F + f)
                        : 0.f;
    const float hi = __uint_as_float(tf32_rna(x));
    const float lo = __uint_as_float(tf32_rna(x - hi));
    if (gs != nullptr) {
      const long long o = ((long long)batch * m_pad + mp) * F + f;
      gs[o] = hi;
      gs[part + o] = lo;
    }
    hi_s[ml][f] = hi;
    lo_s[ml][f] = lo;
  }
  if (gt == nullptr) return;
  __syncthreads();
  for (int idx = tid; idx < 32 * F; idx += 256) {
    const int f = idx / 32, ml = idx % 32;
    const long long o = ((long long)batch * 2 * F + f) * m_pad + m0 + ml;
    gt[o] = hi_s[ml][f];
    gt[o + (long long)F * m_pad] = lo_s[ml][f];
  }
}

// P1: da (one tap's part) and db. Grid (S, B, C / CT).
// gmap: gs as 2D (F, 2 * B * m_pad), box (32, TILE_M); wmap: ws as 2D
// (F, 2 * S * C), box (32, 64).
template <int JB>
__global__ void __launch_bounds__(THREADS, 1)
dab_kernel(const __grid_constant__ CUtensorMap gmap, const __grid_constant__ CUtensorMap wmap,
           const float* __restrict__ a, const float* __restrict__ bb,
           float* __restrict__ da_part, float* __restrict__ db, int width, int channels,
           int stride, int j_count, int m_pad, int n_tiles) {
  constexpr int TI = 16 / JB;  // left rows per tile
  extern __shared__ uint8_t smem_raw[];
  // [W: hi/lo][warpgroup][f half] 8 KB each; then [stage][hi/lo][f half]
  // 16 KB each; then full[P1_STAGES], empty[P1_STAGES], wbar.
  uint8_t* base = aligned_smem(smem_raw);
  const uint32_t w_s = smem_u32(base);
  const uint32_t ring = w_s + W_BYTES;
  const uint32_t full = ring + P1_STAGES * P1_STAGE_BYTES;
  const uint32_t empty = full + 8 * P1_STAGES;
  const uint32_t wbar = empty + 8 * P1_STAGES;

  const int tid = threadIdx.x;
  const int k = blockIdx.x, batch = blockIdx.y, c0 = blockIdx.z * CT;

  if (tid == 0) {
    for (int s = 0; s < P1_STAGES; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, CONSUMERS / 32);  // one arrival per consumer warp
    }
    mbar_init(wbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (tid >= CONSUMERS) {
    // Producer warpgroup: one thread loads W[k] once and keeps the g ring full.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;");
    if (tid == CONSUMERS) {
      mbar_expect_tx(wbar, W_BYTES);
      for (int p = 0; p < 2; ++p)
        for (int wg = 0; wg < CONSUMER_WGS; ++wg)
          for (int fh = 0; fh < 2; ++fh)
            tma_load_2d(w_s + ((p * CONSUMER_WGS + wg) * 2 + fh) * W_HALF_BYTES, &wmap, wbar,
                        32 * fh, (p * stride + k) * channels + c0 + 64 * wg);
      const int part_rows = gridDim.y * m_pad;
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % P1_STAGES;
        mbar_wait(empty + 8 * s, ((t / P1_STAGES) & 1) ^ 1);
        mbar_expect_tx(full + 8 * s, P1_STAGE_BYTES);
        const int row = batch * m_pad + t * (TI * JB * 8);
        for (int p = 0; p < 2; ++p)
          for (int fh = 0; fh < 2; ++fh)
            tma_load_2d(ring + s * P1_STAGE_BYTES + (2 * p + fh) * G_HALF_BYTES, &gmap,
                        full + 8 * s, 32 * fh, p * part_rows + row);
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;");
    const int wg = tid / 128, warp = (tid % 128) / 32, lane = tid % 32;
    const int g = lane / 4, tq = lane % 4;
    // this thread's channels: c_lo and c_lo + 8
    const int c_lo = c0 + 64 * wg + 16 * warp + g;
    const float* a_b = a + (long long)batch * width * channels + c_lo;
    const float* b_b = bb + (long long)batch * width * channels + c_lo;

    // right rows j = 8 q + 2 tq + e of this tap, for both channels
    float bv[JB][2][2], db_acc[JB][2][2];
#pragma unroll
    for (int q = 0; q < JB; ++q)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int j = 8 * q + 2 * tq + e;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          bv[q][e][h] =
              j < j_count ? __ldg(b_b + (long long)(stride * j + k) * channels + 8 * h) : 0.f;
          db_acc[q][e][h] = 0.f;
        }
      }

    float a_next[TI][2];
    auto fetch_a = [&](int i0) {
#pragma unroll
      for (int il = 0; il < TI; ++il)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          a_next[il][h] =
              i0 + il < width ? __ldg(a_b + (long long)(i0 + il) * channels + 8 * h) : 0.f;
    };
    fetch_a(0);

    float acc[64];
#pragma unroll
    for (int n = 0; n < 64; ++n) acc[n] = 0.f;

    mbar_wait(wbar, 0);
    for (int t = 0; t < n_tiles; ++t) {
      const int i0 = t * TI;
      float a_cur[TI][2];
#pragma unroll
      for (int il = 0; il < TI; ++il) a_cur[il][0] = a_next[il][0], a_cur[il][1] = a_next[il][1];
      if (t + 1 < n_tiles) fetch_a(i0 + TI);

      const int s = t % P1_STAGES;
      mbar_wait(full + 8 * s, (t / P1_STAGES) & 1);
      const uint32_t g_s = ring + s * P1_STAGE_BYTES;
      wgmma_fence();
#pragma unroll
      for (int st = 0; st < F / 8; ++st) {
        // k8 step st: f half st / 4, 32 bytes further inside its 128-byte rows
        const uint32_t off = 32 * (st % 4);
        const uint64_t w_hi = kmajor_sw128_desc(w_s + (wg * 2 + st / 4) * W_HALF_BYTES + off);
        const uint64_t w_lo = kmajor_sw128_desc(
            w_s + ((CONSUMER_WGS + wg) * 2 + st / 4) * W_HALF_BYTES + off);
        const uint64_t g_hi = kmajor_sw128_desc(g_s + (st / 4) * G_HALF_BYTES + off);
        const uint64_t g_lo = kmajor_sw128_desc(g_s + (2 + st / 4) * G_HALF_BYTES + off);
        wgmma_ss_n128(acc, w_hi, g_hi, st > 0);
        wgmma_ss_n128(acc, w_hi, g_lo, 1);
        wgmma_ss_n128(acc, w_lo, g_hi, 1);
      }
      wgmma_commit();
      wgmma_wait_all();
      if (lane == 0) mbar_arrive(empty + 8 * s);
      fence_regs(acc);

      // Epilogue: accumulator n = 4 nb + 2 h + e is channel c_lo + 8 h, left
      // row nb / JB, right row 8 (nb % JB) + 2 tq + e.
#pragma unroll
      for (int il = 0; il < TI; ++il) {
        float sum[2] = {0.f, 0.f};
#pragma unroll
        for (int q = 0; q < JB; ++q)
#pragma unroll
          for (int e = 0; e < 2; ++e)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const float v = times_sign(acc[4 * (il * JB + q) + 2 * h + e],
                                         a_cur[il][h] - bv[q][e][h]);
              sum[h] += v;
              db_acc[q][e][h] += v;
            }
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float v = sum[h];
          v += __shfl_xor_sync(0xffffffffu, v, 1);
          v += __shfl_xor_sync(0xffffffffu, v, 2);
          if (tq == 0 && i0 + il < width)
            da_part[(((long long)batch * stride + k) * width + i0 + il) * channels + c_lo +
                    8 * h] = v;
        }
      }
    }

#pragma unroll
    for (int q = 0; q < JB; ++q)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int j = 8 * q + 2 * tq + e;
        if (j < j_count) {
#pragma unroll
          for (int h = 0; h < 2; ++h)
            db[((long long)batch * width + (long long)stride * j + k) * channels + c_lo +
               8 * h] = -db_acc[q][e][h];
        }
      }
  }
}

// P2's A fragments of ring chunk cc (of the JB that four left rows make): k8
// step 4 cc + st is left row (4 cc + st) / JB and right rows
// 8 ((4 cc + st) % JB) + t + 4 u; |a - bb| of the thread's two channels, split
// into tf32 hi and lo. a: [left row][channel], bv: [q][u][channel].
template <int JB>
__device__ __forceinline__ void form_chunk(int cc, const float (&a)[4][2],
                                           const float (&bv)[JB][2][2], uint32_t (&hi)[4][4],
                                           uint32_t (&lo)[4][4]) {
#pragma unroll
  for (int st = 0; st < 4; ++st) {
    const int ks = 4 * cc + st, il = ks / JB, q = ks % JB;
#pragma unroll
    for (int u = 0; u < 2; ++u)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float d = a[il][h] - bv[q][u][h];
        hi[st][2 * u + h] = tf32_rna_abs(d);
        lo[st][2 * u + h] = tf32_rna_bits(fabsf(d) - __uint_as_float(hi[st][2 * u + h]));
      }
  }
}

// P2: one batch element's part of dW[k]. Grid (S, B, C / CT).
// gtmap: gt as 2D (m_pad, B * 2 * F), box (KC, F).
template <int JB>
__global__ void __launch_bounds__(THREADS, 1)
dw_kernel(const __grid_constant__ CUtensorMap gtmap, const float* __restrict__ a,
          const float* __restrict__ bb, float* __restrict__ dw_part, int width, int channels,
          int stride, int j_count, int m_pad) {
  extern __shared__ uint8_t smem_raw[];
  // [stage][g^T hi tile | g^T lo tile]; then full[P2_STAGES], empty[P2_STAGES].
  uint8_t* base = aligned_smem(smem_raw);
  const uint32_t ring = smem_u32(base);
  const uint32_t full = ring + P2_STAGES * P2_STAGE_BYTES;
  const uint32_t empty = full + 8 * P2_STAGES;

  const int tid = threadIdx.x;
  const int k = blockIdx.x, batch = blockIdx.y, c0 = blockIdx.z * CT;
  const int n_chunks = m_pad / KC;

  if (tid == 0) {
    for (int s = 0; s < P2_STAGES; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, CONSUMERS / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (tid >= CONSUMERS) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;");
    if (tid == CONSUMERS) {
      for (int q = 0; q < n_chunks; ++q) {
        const int s = q % P2_STAGES;
        mbar_wait(empty + 8 * s, ((q / P2_STAGES) & 1) ^ 1);
        mbar_expect_tx(full + 8 * s, P2_STAGE_BYTES);
        const uint32_t dst = ring + s * P2_STAGE_BYTES;
        tma_load_2d(dst, &gtmap, full + 8 * s, q * KC, batch * 2 * F);
        tma_load_2d(dst + GT_TILE_BYTES, &gtmap, full + 8 * s, q * KC, batch * 2 * F + F);
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;");
    const int wg = tid / 128, warp = (tid % 128) / 32, lane = tid % 32;
    const int g = lane / 4, tq = lane % 4;
    const int c_lo = c0 + 64 * wg + 16 * warp + g;
    const float* a_b = a + (long long)batch * width * channels + c_lo;
    const float* b_b = bb + (long long)batch * width * channels + c_lo;

    // right rows j = 8 q + tq + 4 u of this tap, for both channels; rows past
    // J face zero rows of g^T
    float bv[JB][2][2];
#pragma unroll
    for (int q = 0; q < JB; ++q)
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int j = 8 * q + tq + 4 * u;
#pragma unroll
        for (int h = 0; h < 2; ++h)
          bv[q][u][h] =
              j < j_count ? __ldg(b_b + (long long)(stride * j + k) * channels + 8 * h) : 0.f;
      }

    // Four left rows are 4 JB k8 steps, JB ring chunks.
    float a_next[4][2];
    auto fetch_a = [&](int i0) {
#pragma unroll
      for (int il = 0; il < 4; ++il)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          a_next[il][h] =
              i0 + il < width ? __ldg(a_b + (long long)(i0 + il) * channels + 8 * h) : 0.f;
    };
    fetch_a(0);

    float acc[32], total[32];
#pragma unroll
    for (int n = 0; n < 32; ++n) acc[n] = total[n] = 0.f;

    const int n_rows = m_pad / (8 * JB);  // padded left rows, a multiple of 4
    int chunk = 0, fresh = 1;
    for (int i0 = 0; i0 < n_rows; i0 += 4) {
      float a_cur[4][2];
#pragma unroll
      for (int il = 0; il < 4; ++il) a_cur[il][0] = a_next[il][0], a_cur[il][1] = a_next[il][1];
      if (i0 + 4 < n_rows) fetch_a(i0 + 4);

#pragma unroll
      for (int cc = 0; cc < JB; ++cc, ++chunk) {
        uint32_t hi[4][4], lo[4][4];
        form_chunk<JB>(cc, a_cur, bv, hi, lo);

        const int s = chunk % P2_STAGES;
        mbar_wait(full + 8 * s, (chunk / P2_STAGES) & 1);
        const uint32_t g_hi = ring + s * P2_STAGE_BYTES, g_lo = g_hi + GT_TILE_BYTES;
        wgmma_fence();
#pragma unroll
        for (int st = 0; st < 4; ++st) {
          const uint64_t d_hi = kmajor_sw128_desc(g_hi + 32 * st);
          const uint64_t d_lo = kmajor_sw128_desc(g_lo + 32 * st);
          wgmma_rs_n64(acc, hi[st][0], hi[st][1], hi[st][2], hi[st][3], d_hi,
                       st > 0 ? 1 : 1 - fresh);
          wgmma_rs_n64(acc, hi[st][0], hi[st][1], hi[st][2], hi[st][3], d_lo, 1);
          wgmma_rs_n64(acc, lo[st][0], lo[st][1], lo[st][2], lo[st][3], d_hi, 1);
        }
        wgmma_commit();
        wgmma_wait_all();
        if (lane == 0) mbar_arrive(empty + 8 * s);
        fresh = 0;
      }
      // The accumulators lose low bits on every wgmma: flush them into fp32
      // sums before they have grown (see the note at the top).
      if ((i0 + 4) % FLUSH_ROWS == 0 || i0 + 4 >= n_rows) {
        fence_regs(acc);
#pragma unroll
        for (int n = 0; n < 32; ++n) total[n] += acc[n];
        fresh = 1;
      }
    }

    // accumulator n: channel c_lo + 8 ((n / 2) % 2), feature 8 (n / 4) + 2 tq + n % 2
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float* row = dw_part + (((long long)batch * stride + k) * channels + c_lo + 8 * h) * F +
                   2 * tq;
#pragma unroll
      for (int nb = 0; nb < F / 8; ++nb)
        *reinterpret_cast<float2*>(row + 8 * nb) =
            make_float2(total[4 * nb + 2 * h], total[4 * nb + 2 * h + 1]);
    }
  }
}

// out[o][x] = sum_{s < n_sum} part[o][s][x], s in order; x in float4.
__global__ void sum_axis_kernel(const float4* __restrict__ part, float4* __restrict__ out,
                                int n_sum, long long inner4) {
  const long long x = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (x >= inner4) return;
  const float4* p = part + (long long)blockIdx.y * n_sum * inner4 + x;
  float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int i = 0; i < n_sum; ++i) {
    const float4 v = __ldg(p + (long long)i * inner4);
    s.x += v.x, s.y += v.y, s.z += v.z, s.w += v.w;
  }
  out[(long long)blockIdx.y * inner4 + x] = s;
}

cudaError_t sum_axis(const float* part, float* out, int n_outer, int n_sum, long long inner,
                     cudaStream_t s) {
  const long long inner4 = inner / 4;
  const dim3 grid((unsigned)((inner4 + 255) / 256), n_outer);
  sum_axis_kernel<<<grid, 256, 0, s>>>(reinterpret_cast<const float4*>(part),
                                       reinterpret_cast<float4*>(out), n_sum, inner4);
  return cudaGetLastError();
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled looked up through the runtime, which has libcuda
// loaded already, so the library links no -lcuda.
EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// A 2D fp32 tensor map (cols contiguous) with the 128-byte swizzle and zero
// fill past the edges; box_cols is 32 (128 bytes). Returns 0 or the negated
// CUresult.
int encode_2d(CUtensorMap* map, const float* ptr, long long cols, long long rows,
              int box_cols, int box_rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorSymbolNotFound;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * sizeof(float)};
  const cuuint32_t box[2] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows};
  const cuuint32_t elem_strides[2] = {1, 1};
  const CUresult res =
      encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<float*>(ptr), dims, strides,
             box, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? 0 : -(int)res;
}

constexpr size_t P1_SMEM = 1024 + W_BYTES + P1_STAGES * P1_STAGE_BYTES + 16 * P1_STAGES + 8;
constexpr size_t P2_SMEM = 1024 + P2_STAGES * P2_STAGE_BYTES + 16 * P2_STAGES;

template <int JB>
cudaError_t launch_dab(dim3 grid, cudaStream_t s, const CUtensorMap& gmap,
                       const CUtensorMap& wmap, const float* a, const float* bb,
                       float* da_part, float* db, int width, int channels, int stride,
                       int j_count, int m_pad) {
  cudaError_t err = cudaFuncSetAttribute(
      dab_kernel<JB>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)P1_SMEM);
  if (err != cudaSuccess) return err;
  dab_kernel<JB><<<grid, THREADS, P1_SMEM, s>>>(gmap, wmap, a, bb, da_part, db, width,
                                                channels, stride, j_count, m_pad,
                                                m_pad / (8 * JB) / (16 / JB));
  return cudaGetLastError();
}

template <int JB>
cudaError_t launch_dw(dim3 grid, cudaStream_t s, const CUtensorMap& gtmap, const float* a,
                      const float* bb, float* dw_part, int width, int channels, int stride,
                      int j_count, int m_pad) {
  cudaError_t err = cudaFuncSetAttribute(
      dw_kernel<JB>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)P2_SMEM);
  if (err != cudaSuccess) return err;
  dw_kernel<JB><<<grid, THREADS, P2_SMEM, s>>>(gtmap, a, bb, dw_part, width, channels, stride,
                                               j_count, m_pad);
  return cudaGetLastError();
}

// fn(std::integral_constant<int, JB>) for the run-time jb in 1..MAX_JB.
template <typename Fn>
cudaError_t with_jb(int jb, Fn fn) {
  switch (jb) {
    case 1: return fn(std::integral_constant<int, 1>{});
    case 2: return fn(std::integral_constant<int, 2>{});
    case 3: return fn(std::integral_constant<int, 3>{});
    default: return fn(std::integral_constant<int, 4>{});
  }
}

// Padded (i, j) rows per batch element for `width` left rows and a group of
// `j_count` right columns: each left row's entries padded to Jp = 8 * JB, the
// left rows to a multiple of both product kernels' steps (16 / JB rows a tile
// in P1, 4 in P2). 0 when j_count is outside 1..8 * MAX_JB. The wrapper sizes
// the scratch by the same rule (kernels/delta_conv1.py::backward_padded_rows).
int padded_rows(int width, int j_count) {
  if (width < 1 || j_count < 1) return 0;
  const int jb = (j_count + 7) / 8;
  if (jb > MAX_JB) return 0;
  const int step = jb == 3 ? 20 : 16 / jb;  // lcm(16 / JB, 4)
  return (width + step - 1) / step * step * 8 * jb;
}

}  // namespace

// C entry point, bound from Python with ctypes. All tensors are contiguous
// fp32 on the device of `stream`. `da`/`db` may both be null (no gradient
// for the volumes is asked) and so may `dw`; what is null is not computed.
// The call covers the right columns j0 <= j < j0 + j_count of the J =
// width / stride (at most 32 of them): `da` and `dw` get that group's parts,
// `db` its rows stride * j0 .. stride * (j0 + j_count) - 1; other rows of
// `db` are left as they are.
// Scratch, caller-allocated, with `m_pad` the padded rows the caller sized it
// by, which must equal padded_rows(width, j_count):
// with da/db, `da_part` batch * stride * width * channels floats, `g_split`
// 2 * batch * m_pad * features and `w_split` 2 * stride * channels * features;
// with dw, `dw_part` batch * stride * channels * features and `gt_split`
// batch * 2 * features * m_pad. Returns 0, a cudaError_t
// (cudaErrorInvalidValue when the sizes are outside what the kernels take:
// features != 64, channels not a multiple of 128, a group outside 0..J or of
// more than 32 columns, another m_pad), or the negated CUresult of a failed
// tensor-map encode.
extern "C" int delta_conv1_backward(const float* a, const float* bb, const float* w,
                                    const float* g, float* da, float* db, float* dw,
                                    float* da_part, float* dw_part, float* g_split,
                                    float* gt_split, float* w_split, int m_pad, int batch,
                                    int width, int channels, int stride, int features,
                                    int j0, int j_count, void* stream) {
  if (features != F || channels < CT || channels % CT != 0 || stride < 1 || width < stride ||
      batch < 1 || batch > 65535 || (da == nullptr) != (db == nullptr))
    return (int)cudaErrorInvalidValue;
  const int j_total = width / stride;
  if (j0 < 0 || j_count < 1 || j0 + j_count > j_total) return (int)cudaErrorInvalidValue;
  if (m_pad == 0 || m_pad != padded_rows(width, j_count)) return (int)cudaErrorInvalidValue;
  if (da == nullptr && dw == nullptr) return 0;
  const int jb = (j_count + 7) / 8;
  // the group's right rows start at stride * j0: the kernels see bb and db
  // from there on (their batch stride stays width * channels) and g from its
  // column j0 on
  const long long row0 = (long long)stride * j0 * channels;
  bb += row0;
  if (db != nullptr) db += row0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(stride, batch, channels / CT);
  cudaError_t err;
  int res;

  split_g_kernel<<<dim3(m_pad / 32, batch), 256, 0, s>>>(
      g + (long long)j0 * F, da != nullptr ? g_split : nullptr,
      dw != nullptr ? gt_split : nullptr, width, j_total, j_count, 8 * jb, m_pad);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  if (da != nullptr) {
    const int n_w = stride * channels * F;
    split_w_kernel<<<(n_w + 255) / 256, 256, 0, s>>>(w, w_split, n_w);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    CUtensorMap gmap, wmap;
    if ((res = encode_2d(&gmap, g_split, F, 2ll * batch * m_pad, 32, TILE_M)) != 0) return res;
    if ((res = encode_2d(&wmap, w_split, F, 2ll * stride * channels, 32, 64)) != 0) return res;
    err = with_jb(jb, [&](auto tag) {
      return launch_dab<decltype(tag)::value>(grid, s, gmap, wmap, a, bb, da_part, db, width,
                                              channels, stride, j_count, m_pad);
    });
    if (err != cudaSuccess) return (int)err;
    err = sum_axis(da_part, da, batch, stride, (long long)width * channels, s);
    if (err != cudaSuccess) return (int)err;
  }
  if (dw != nullptr) {
    CUtensorMap gtmap;
    if ((res = encode_2d(&gtmap, gt_split, m_pad, 2ll * batch * F, KC, F)) != 0) return res;
    err = with_jb(jb, [&](auto tag) {
      return launch_dw<decltype(tag)::value>(grid, s, gtmap, a, bb, dw_part, width, channels,
                                             stride, j_count, m_pad);
    });
    if (err != cudaSuccess) return (int)err;
    err = sum_axis(dw_part, dw, 1, batch, (long long)stride * channels * features, s);
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}
