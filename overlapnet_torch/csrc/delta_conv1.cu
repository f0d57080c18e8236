// K1: fused DeltaLayer + c_conv1 forward for Hopper (sm_90a), on the tensor
// cores in error-compensated 3xTF32.
//
//   out[b, i, j, f] = bias[f] + sum_{k < S, c < C} W[k, c, f] * |a[b, i, c] - bb[b, S*j + k, c]|
//
// a, bb: (B, W', C) fp32 leg feature volumes (the batch stride may be 0, so
// one query volume can face a batch of candidates without a copy);
// W: (S, C, F = 64) fp32; out: (B, W', J = W'/S, F) fp32.
//
// Replaces the JAX package's Pallas TPU kernel ops/pallas_delta.py::_fwd_kernel
// (pallas_call at :54 in _delta_conv1_fwd). That kernel keeps the whole
// (S*C, F) weight in VMEM and does one (T*J, S*C) @ (S*C, F) dot per grid
// step. Here it is an implicit GEMM: M = the W'*J (i, j) rows of a pair,
// N = F = 64, K = S*C (1920 at C = 128, S = 15). The A operand
// |a_i - bb_{Sj+k}| is formed in registers and never written to memory.
//
// Bound: 2*W'*J*S*C*F flops per pair (2.12 GFLOP at W' = 360) against about
// 2.6 MB of input and output per pair, so operations bound it. fp32 products
// on the tensor cores need three TF32 passes to keep fp32-level error: each
// operand x is split into hi = tf32(x) and lo = tf32(x - hi) (round to
// nearest, ties away, as cvt.rna; never the hardware's truncation), and
// hi*hi + hi*lo + lo*hi accumulate in fp32. The floor is therefore
// 3 * flops / the TF32 dense peak (495 TFLOP/s on an H100 SXM: 0.412 ms for
// B = 32 pairs at W' = 360).
//
// Design, per block of BM = 256 consecutive (i, j) rows of one pair:
// - two consumer warpgroups of 128 rows each (two m64 tiles) issue
//   wgmma.m64n64k8.f32.tf32.tf32 with A from registers; each thread forms
//   its fragment's differences from a and bb rows staged in shared memory
//   and splits them into hi / lo in registers (two integer ops per rounding);
// - TF32 wgmma takes B K-major only, so a small kernel launched first writes
//   the weight transposed and split as Wt (2F, S*C): rows 0..F-1 hi, F..2F-1
//   lo. Inside every 32-column chunk the columns are permuted so that a
//   thread's fragment columns (t, t + 4) of k8 step s are channels
//   8t + 2s and 8t + 2s + 1: each thread reads 8 contiguous channels of a row
//   with two 16-byte loads for four k8 steps;
// - the weight is the operand every block streams (0.98 MB per block), so
//   one producer thread feeds it by TMA (one 2D tensor map, 128-byte swizzle,
//   64 features x 32 K of hi and of lo per stage) into a 4-stage ring of
//   mbarriers, and setmaxnreg moves registers to the consumers. BM = 256
//   halves the weight traffic of a 128-row tile;
// - the left rows a[i] of the tile are staged once; each warpgroup stages the
//   J right rows bb[S*j + k] of each tap k itself with cp.async (16 B) into a
//   double buffer, from the strides the wrapper passes (this keeps the
//   batch-stride-0 form), behind its own barrier, so the two warpgroups
//   drift apart and one forms fragments while the other's wgmma run;
// - the tensor cores' fp32 accumulation drops low bits on every wgmma (7e-5
//   at outputs of order 4 over the 720 of a pair), so each tap sums in the
//   accumulators and the tap sums are added in fp32 on the CUDA cores;
// - the epilogue adds the bias and stores each accumulator row pair as
//   float2; rows past W'*J (the ragged last tile) are masked. Blocks share
//   no sum: no atomics, the same result on every run.
// What bounds it now: the tensor cores' rate for TF32 wgmma with A from
// registers. With no fragment formation at all the wgmma alone take about
// 55% of the 3xTF32 floor on an H100 SXM, and forming the fragments hides
// behind them (scripts/k1_probe.py measures both; PERF.md has the numbers).
// An mbarrier wait that spins past SPIN_LIMIT traps instead of hanging.

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int F = 64;             // output features: the wgmma N
constexpr int BM = 256;           // output rows ((i, j) pairs) per block
constexpr int KC = 32;            // K chunk: 32 channels of one tap
constexpr int STAGES = 4;         // weight ring depth
constexpr int CONSUMER_WGS = 2;   // consumer warpgroups, 128 rows each
constexpr int CONSUMERS = 128 * CONSUMER_WGS;
constexpr int THREADS = CONSUMERS + 128;  // + one producer warpgroup
constexpr int W_TILE_BYTES = F * KC * 4;  // 8 KB: F rows of 128 B
constexpr int STAGE_BYTES = 2 * W_TILE_BYTES;  // hi + lo
constexpr int ROW_PAD = 4;        // staged-row pad (floats): conflict-free 16 B loads
constexpr long long SPIN_LIMIT = 1ll << 22;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ uint32_t tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

// cvt.rna.tf32.f32 for finite x in two integer ops (the instruction adds a
// range check per value): half a TF32 ulp added to the magnitude, then the
// 13 low bits cleared. tf32_rna_abs also clears the sign: tf32(|x|).
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

// 16-byte global -> shared copy; src_bytes = 0 fills the 16 bytes with zeros.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(dst), "l"(src),
               "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;" ::"n"(CONSUMERS) : "memory");
}
// Named barrier 2 + wg over the 128 threads of consumer warpgroup wg.
__device__ __forceinline__ void warpgroup_sync(int wg) {
  asm volatile("bar.sync %0, 128;" ::"r"(2 + wg) : "memory");
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
__device__ __forceinline__ void wgmma_tf32(float (&d)[32], uint32_t a0, uint32_t a1,
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
__device__ __forceinline__ void fence_regs(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// The weight (S, C, F) as Wt (2F, S*C), K-major: row f holds tf32 hi of
// feature f, row F + f its tf32 lo. Column base + 8s + p of a 32-column chunk
// holds channel base + 8 (p % 4) + 2 s + p / 4 (see the note at the top).
__global__ void split_weight_kernel(const float* __restrict__ w, float* __restrict__ wt,
                                    int k_total) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= F * k_total) return;
  const int f = idx / k_total, col = idx % k_total;
  const int intra = col % KC, s = intra / 8, p = intra % 8;
  const int src = col - intra + 8 * (p % 4) + 2 * s + p / 4;  // k * C + c
  const float x = w[(long long)src * F + f];
  const uint32_t hi = tf32_rna(x);
  wt[(long long)f * k_total + col] = __uint_as_float(hi);
  wt[(long long)(F + f) * k_total + col] = __uint_as_float(tf32_rna(x - __uint_as_float(hi)));
}

__global__ void __launch_bounds__(THREADS, 1)
delta_conv1_kernel(const __grid_constant__ CUtensorMap wmap, const float* __restrict__ a,
                   const float* __restrict__ bb, const float* __restrict__ bias,
                   float* __restrict__ out, int width, int channels, int stride,
                   int j_count, int rows_a, long long a_bstride, long long b_bstride) {
  extern __shared__ uint8_t smem_raw[];
  // [STAGES][Wt hi tile | Wt lo tile], 1024-aligned for the swizzle; then
  // full[STAGES], empty[STAGES] mbarriers; a rows; per consumer warpgroup two
  // buffers of bb rows; the fp32 tap sums.
  uint8_t* base = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const uint32_t ring = smem_u32(base);
  const uint32_t full = ring + STAGES * STAGE_BYTES;
  const uint32_t empty = full + 8 * STAGES;
  const int pitch = channels + ROW_PAD;
  float* a_s = reinterpret_cast<float*>(base + STAGES * STAGE_BYTES + 16 * STAGES);
  float* b_s = a_s + rows_a * pitch;

  const int tid = threadIdx.x;
  const int n_chunks = stride * (channels / KC);

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, CONSUMERS / 32);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (tid >= CONSUMERS) {
    // Producer warpgroup: one thread keeps the weight ring full.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;");
    if (tid == CONSUMERS) {
      for (int q = 0; q < n_chunks; ++q) {
        const int s = q % STAGES;
        mbar_wait(empty + 8 * s, ((q / STAGES) & 1) ^ 1);
        mbar_expect_tx(full + 8 * s, STAGE_BYTES);
        const uint32_t dst = ring + s * STAGE_BYTES;
        tma_load_2d(dst, &wmap, full + 8 * s, q * KC, 0);
        tma_load_2d(dst + W_TILE_BYTES, &wmap, full + 8 * s, q * KC, F);
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;");
    const int batch = blockIdx.y;
    const int m_total = width * j_count;
    const int m0 = blockIdx.x * BM;
    const int i_lo = m0 / j_count;
    const float* a_b = a + batch * a_bstride;
    const float* b_b = bb + batch * b_bstride;
    const int wg = tid / 128, warp = (tid % 128) / 32, lane = tid % 32;
    const int g = lane / 4, tq = lane % 4;

    // This thread's four rows: slot r = 2 t + h is row 16 warp + g + 8 h of
    // the warpgroup's m64 tile t.
    int a_off[4], b_off[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int m = m0 + wg * 128 + (r / 2) * 64 + warp * 16 + (r % 2) * 8 + g;
      const bool ok = m < m_total;
      a_off[r] = ok ? (m / j_count - i_lo) * pitch : 0;
      b_off[r] = ok ? (m % j_count) * pitch : 0;
    }

    const int vecs = channels / 4;  // 16-byte pieces per row
    for (int e = tid; e < rows_a * vecs; e += CONSUMERS) {
      const int r = e / vecs, v = e % vecs, i = i_lo + r;
      cp_async16(smem_u32(a_s + r * pitch + 4 * v),
                 a_b + (long long)(i < width ? i : 0) * channels + 4 * v, i < width ? 16 : 0);
    }
    // Each warpgroup stages its own right rows behind its own barrier, so
    // the two never wait for each other and drift half a chunk apart: one
    // forms fragments while the other's wgmma run.
    float* b_wg = b_s + 2 * wg * j_count * pitch;
    // fp32 sum of the finished taps, [8 float4 of tile 0, 8 of tile 1][thread]
    float4* master = reinterpret_cast<float4*>(b_s + 2 * CONSUMER_WGS * j_count * pitch) + tid;
    auto stage_b = [&](int k) {
      float* dst = b_wg + (k & 1) * j_count * pitch;
      for (int e = tid % 128; e < j_count * vecs; e += 128) {
        const int j = e / vecs, v = e % vecs;
        cp_async16(smem_u32(dst + j * pitch + 4 * v),
                   b_b + (long long)(stride * j + k) * channels + 4 * v, 16);
      }
      asm volatile("cp.async.commit_group;" ::: "memory");
    };
    stage_b(0);
    asm volatile("cp.async.wait_all;" ::: "memory");
    consumers_sync();  // every a row is in

    // Each tap's first wgmma overwrites acc; it starts at zero so that no
    // wgmma operand is ever read uninitialized.
    float acc[2][32];
#pragma unroll
    for (int t = 0; t < 2; ++t)
#pragma unroll
      for (int n = 0; n < 32; ++n) acc[t][n] = 0.f;

    int q = 0;
    for (int k = 0; k < stride; ++k) {
      // tap k's rows have landed and every consumer is done with tap k - 1
      asm volatile("cp.async.wait_all;" ::: "memory");
      warpgroup_sync(wg);
      if (k + 1 < stride) stage_b(k + 1);
      const float* b_k = b_wg + (k & 1) * j_count * pitch;

      for (int c0 = 0; c0 < channels; c0 += KC, ++q) {
        // |a - bb| over channels c0 + 8 tq .. + 7 of the four rows, split
        uint32_t hi[4][8], lo[4][8];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const float* pa = a_s + a_off[r] + c0 + 8 * tq;
          const float* pb = b_k + b_off[r] + c0 + 8 * tq;
          const float4 a0 = *reinterpret_cast<const float4*>(pa);
          const float4 a1 = *reinterpret_cast<const float4*>(pa + 4);
          const float4 b0 = *reinterpret_cast<const float4*>(pb);
          const float4 b1 = *reinterpret_cast<const float4*>(pb + 4);
          const float d[8] = {a0.x - b0.x, a0.y - b0.y, a0.z - b0.z, a0.w - b0.w,
                              a1.x - b1.x, a1.y - b1.y, a1.z - b1.z, a1.w - b1.w};
#pragma unroll
          for (int e = 0; e < 8; ++e) {
            hi[r][e] = tf32_rna_abs(d[e]);
            lo[r][e] = tf32_rna_bits(fabsf(d[e]) - __uint_as_float(hi[r][e]));
          }
        }

        const int s = q % STAGES;
        mbar_wait(full + 8 * s, (q / STAGES) & 1);
        const uint32_t w_hi = ring + s * STAGE_BYTES, w_lo = w_hi + W_TILE_BYTES;
        wgmma_fence();
#pragma unroll
        for (int st = 0; st < KC / 8; ++st) {
          // k8 step st: the B tile advances 32 bytes inside its 128-byte rows
          const uint64_t d_hi = kmajor_sw128_desc(w_hi + 32 * st);
          const uint64_t d_lo = kmajor_sw128_desc(w_lo + 32 * st);
#pragma unroll
          for (int t = 0; t < 2; ++t) {
            const int e = 2 * st;  // fragment columns tq, tq + 4: channels e, e + 1
            wgmma_tf32(acc[t], hi[2 * t][e], hi[2 * t + 1][e], hi[2 * t][e + 1],
                       hi[2 * t + 1][e + 1], d_hi, c0 > 0 || st > 0);
            wgmma_tf32(acc[t], hi[2 * t][e], hi[2 * t + 1][e], hi[2 * t][e + 1],
                       hi[2 * t + 1][e + 1], d_lo, 1);
            wgmma_tf32(acc[t], lo[2 * t][e], lo[2 * t + 1][e], lo[2 * t][e + 1],
                       lo[2 * t + 1][e + 1], d_hi, 1);
          }
        }
        wgmma_commit();
        wgmma_wait_all();
        if (lane == 0) mbar_arrive(empty + 8 * s);
      }
      // Each tap sums in the accumulators (reset by its first wgmma); the
      // tap sums add up here in fp32, kept in shared memory (see the note).
      fence_regs(acc[0]);
      fence_regs(acc[1]);
#pragma unroll
      for (int t = 0; t < 2; ++t)
#pragma unroll
        for (int v = 0; v < 8; ++v) {
          float4 m = make_float4(acc[t][4 * v], acc[t][4 * v + 1], acc[t][4 * v + 2],
                                 acc[t][4 * v + 3]);
          if (k > 0) {
            const float4 prev = master[(8 * t + v) * CONSUMERS];
            m.x += prev.x, m.y += prev.y, m.z += prev.z, m.w += prev.w;
          }
          if (k + 1 < stride) {
            master[(8 * t + v) * CONSUMERS] = m;
          } else {
            acc[t][4 * v] = m.x, acc[t][4 * v + 1] = m.y;
            acc[t][4 * v + 2] = m.z, acc[t][4 * v + 3] = m.w;
          }
        }
    }

    // Epilogue: accumulator n of tile t holds row 16 warp + g + 8 ((n / 2) % 2),
    // column 8 (n / 4) + 2 tq + n % 2.
    float bv[16];
#pragma unroll
    for (int n = 0; n < 16; ++n)
      bv[n] = bias != nullptr ? bias[8 * (n / 2) + 2 * tq + n % 2] : 0.f;
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int t = r / 2, h = r % 2;
      const int m = m0 + wg * 128 + t * 64 + warp * 16 + h * 8 + g;
      if (m < m_total) {
        float* row = out + ((long long)batch * m_total + m) * F + 2 * tq;
#pragma unroll
        for (int nb = 0; nb < F / 8; ++nb)
          *reinterpret_cast<float2*>(row + 8 * nb) =
              make_float2(acc[t][4 * nb + 2 * h] + bv[2 * nb],
                          acc[t][4 * nb + 2 * h + 1] + bv[2 * nb + 1]);
      }
    }
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver the runtime already loaded, so the
// library links no -lcuda.
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

}  // namespace

// C entry point, bound from Python with ctypes. `wt` is caller-allocated
// scratch of 2 * features * stride * channels floats (the split weight).
// Launches the weight split and K1 on `stream` and returns 0, a cudaError_t
// (cudaErrorInvalidValue when the sizes are outside what the kernel takes:
// features != 64, channels not a multiple of 32, width < stride, or more
// shared memory than a block can have), or the negated CUresult of a failed
// tensor-map encode.
extern "C" int delta_conv1_forward(const float* a, const float* bb, const float* w,
                                   const float* bias, float* wt, float* out, int batch,
                                   int width, int channels, int stride, int features,
                                   long long a_bstride, long long b_bstride, void* stream) {
  if (features != F || channels < KC || channels % KC != 0 || stride < 1 || width < stride ||
      batch < 1 || batch > 65535)
    return (int)cudaErrorInvalidValue;
  const int j_count = width / stride;
  const int k_total = stride * channels;
  const int rows_a = (BM - 1) / j_count + 2;
  const size_t smem = 1024 + (size_t)STAGES * STAGE_BYTES + 16 * STAGES +
                      sizeof(float) * (size_t)(rows_a + 2 * CONSUMER_WGS * j_count) *
                          (channels + ROW_PAD) +
                      sizeof(float) * CONSUMERS * 2 * 32;  // the fp32 tap sums
  if (smem > 232448) return (int)cudaErrorInvalidValue;

  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorSymbolNotFound;
  CUtensorMap wmap;
  const cuuint64_t dims[2] = {(cuuint64_t)k_total, (cuuint64_t)(2 * F)};
  const cuuint64_t strides[1] = {(cuuint64_t)k_total * sizeof(float)};
  const cuuint32_t box[2] = {KC, F};
  const cuuint32_t elem_strides[2] = {1, 1};
  const CUresult res = encode(&wmap, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, wt, dims, strides,
                              box, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE,
                              CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                              CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (res != CUDA_SUCCESS) return -(int)res;

  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  split_weight_kernel<<<(F * k_total + 255) / 256, 256, 0, s>>>(w, wt, k_total);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(delta_conv1_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((width * j_count + BM - 1) / BM, batch);
  delta_conv1_kernel<<<grid, THREADS, smem, s>>>(wmap, a, bb, bias, out, width, channels,
                                                 stride, j_count, rows_a, a_bstride,
                                                 b_bstride);
  return (int)cudaGetLastError();
}
