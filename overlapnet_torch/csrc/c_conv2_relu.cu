// K3: c_conv2 with its bias and ReLU for Hopper (sm_90a), on the TF32 tensor
// cores.
//
//   out[b, i', j, g] = relu(bias[g] + sum_{k < S, f < 64} W2[g, f, k] * x[b, S*i' + k, j, f])
//
// x: (B, W', J, F = 64) fp32, K1's output exactly as K1 writes it (channels
// last); W2: (N = 128, F, S, 1) fp32, c_conv2's OIHW weight; out:
// (B, W' // S, J, N) fp32, channels last (models/heads.py hands it on as the
// NCHW view with those strides, which c_conv3 reads without a copy).
//
// Replaces no TPU kernel: the JAX package leaves c_conv2 to XLA (a strided
// convolution in its models/heads.py). Why it was added: in the dense
// loop-closing cell (a traced benchmark window, PERF.md) cuDNN ran c_conv2 as a
// convertTensor pass over K1's output (1.82 us a pair: a read and a write of
// the 2.2 MB a pair at 2.4 TB/s) and a legacy s1688 TF32 fprop (1.71 us a
// pair), then PyTorch's ReLU pass over its output: 3.5 of the heads' 22.7 us
// a pair, against a bound of 0.75 us.
//
// What bounds it: bytes. A pair at W' = 360 reads 2,211,840 bytes of x and
// writes 294,912 of out for 141.6 MFLOP, 56 FLOP a byte against the TF32
// ridge of 148 (495 TFLOP/s over 3.35 TB/s): at B = 256 the bound is
// 641.7 MB at 3.35 TB/s, 0.192 ms, where the operations take 0.073 ms. K3
// takes 0.23-0.24 ms of device time there on an H100 SXM at 700 W, 80-83% of
// that bound (cuDNN's conversion, fprop and ReLU took 1.00-1.02 ms; PERF.md).
//
// The design reads x once, in large pieces, and keeps the tensor cores
// behind the memory:
// - An implicit GEMM: M = the B * (W' // S) * J output rows (b, i', j),
//   N = 128, K = S * 64; row m's K values for tap k are the 64 contiguous
//   floats of x[b, S*i' + k, j], so a K chunk of 32 (half a tap) is one
//   128-byte piece a row.
// - Persistent blocks, min(tiles, SMs) of them, walk tiles of BM = 128
//   consecutive rows, so the grid follows the batch: a one-pair call (576
//   rows) runs 5 blocks, a 256-pair call 132 over 1,152 tiles. A producer
//   warpgroup copies each chunk's 128 row pieces with cp.async (16 bytes a
//   thread and copy, eight threads a row) into a ring of stages, 192 KB in
//   all; one of its threads brings the chunk's weight (16 KB, prepared
//   below) by a bulk copy into the same stage. The stage's mbarrier
//   completes when both have landed, so the producer runs a whole ring ahead
//   of the consumers and into the next tile while they finish this one: one
//   tile's epilogue overlaps the next tile's loads.
// - Two consumer warpgroups of 64 rows form the A fragments of a chunk's
//   four k8 steps from the staged rows with ldmatrix (rows stored with their
//   16-byte pieces XORed by the row, so the loads meet no bank conflict),
//   round them to TF32 to nearest (cvt.rna), and issue one group of
//   wgmma.m64n128k8.f32.tf32.tf32 with B, the weight chunk, read from shared
//   memory in the 128-byte swizzle. The sums are fp32 in the accumulators;
//   the epilogue adds the bias, applies the ReLU and writes each row's 128
//   outputs (512 contiguous bytes).
// - c_conv2_round_weight, launched first in the same call, rounds W2 to TF32
//   to nearest once and lays it out as 2S chunks of (128 rows x 32) in the
//   swizzle, so that a chunk is one contiguous 16 KB bulk copy; the chunks
//   come from L2 (the weight is 480 KB at S = 15).
// - 128-row tiles throughout. 256-row tiles (two m64 tiles a warpgroup, the
//   weight's L2 traffic halved, setmaxnreg to hold 128 accumulators) were
//   5% slower at B = 256 and took 31 us against 19 at B = 1 to 16; they
//   were faster only near B = 32 (40 against 49 us), where 144 tiles leave
//   a second wave of 12 (PERF.md).
// Precision: `split` follows the switch that set c_conv2's precision as a
// cuDNN convolution (torch.backends.cudnn.allow_tf32, on by default). On:
// one TF32 product, both operands rounded to TF32 to nearest, not truncated
// (truncation would bias every 960-term sum the same way). Off: 3xTF32, each
// operand as hi + lo (hi its TF32 rounding, lo the rest's) and the products
// lo hi + hi lo + hi hi, float32 accuracy at three times the tensor-core
// work (0.22 ms at B = 256 against the 0.19 ms byte bound). The sums are
// fp32 either way. Each output
// is summed by one thread in a fixed order whatever the tile or the batch:
// the same bits every run and for every split of a batch. An mbarrier wait
// that spins past SPIN_LIMIT traps instead of hanging.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int F = 64;    // input channels (c_conv1's features)
constexpr int N = 128;   // output channels: the wgmma N
constexpr int KC = 32;   // K chunk: 32 channels of one tap, one 128-byte fp32 row piece
constexpr int B_BYTES = N * KC * 4;  // 16 KB: one weight chunk
constexpr int PRODUCERS = 128;       // one producer warpgroup
constexpr int CONSUMER_WGS = 2;
constexpr int CONSUMERS = 128 * CONSUMER_WGS;
constexpr int THREADS = CONSUMERS + PRODUCERS;
constexpr int RING_BYTES = 196608;   // the stages, 192 KB
constexpr int SMEM_LIMIT = 232448;
constexpr int PREP_THREADS = 256;
constexpr long long SPIN_LIMIT = 1ll << 22;

// SPLIT: 3xTF32 (each operand as a TF32 pair hi + lo, the weight's two
// pieces side by side in a stage).
template <bool SPLIT>
struct Tile {
  static constexpr int BM = 128;  // rows a tile: 64 a consumer warpgroup
  static constexpr int PIECES = SPLIT ? 2 : 1;
  static constexpr int W_BYTES = PIECES * B_BYTES;  // a stage's weight chunk
  static constexpr int A_BYTES = BM * KC * 4;
  static constexpr int STAGE_BYTES = W_BYTES + A_BYTES;  // weight first: 1024-aligned
  static constexpr int STAGES = RING_BYTES / STAGE_BYTES;
  static constexpr int SMEM = 1024 + STAGES * STAGE_BYTES + 16 * STAGES;
  static constexpr int ROWS_PER_PRODUCER = BM * 8 / PRODUCERS;  // 16-byte pieces a thread
};
static_assert(Tile<true>::SMEM <= SMEM_LIMIT && Tile<false>::SMEM <= SMEM_LIMIT,
              "shared memory");

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ uint32_t round_tf32(float x) {
  uint32_t d;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(d) : "f"(x));
  return d;
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

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar) : "memory");
}

// `bytes` contiguous bytes global -> shared, completing on the mbarrier.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
      ::"r"(dst), "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// 16-byte global -> shared copy; src_bytes = 0 fills the 16 bytes with zeros.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(dst), "l"(src),
               "r"(src_bytes)
               : "memory");
}

// An arrival on the mbarrier once this thread's cp.async before it have landed
// (counted in the barrier's arrivals: .noinc).
__device__ __forceinline__ void cp_async_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];" ::"r"(bar) : "memory");
}

// Four 8x8 b16 matrices, i.e. four 8-row x 4 fp32 blocks: lane 4g + t gets
// element (g, t) of each, which is the TF32 A fragment's layout.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

// wgmma descriptor of a K-major tile in the 128-byte swizzle: rows of 128 B,
// 8-row groups 1024 B apart (SBO); LBO is unused.
__device__ __forceinline__ uint64_t kmajor_sw128_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (1ull << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

// D (64 x 128, fp32) = A (64 x 8, tf32, registers) * B (8 x 128, tf32, shared,
// K-major) + (accumulate ? D : 0). A fragment of lane 4g + t of warp w of the
// warpgroup: a0 (16w + g, t), a1 (16w + g + 8, t), a2 (16w + g, t + 4),
// a3 (16w + g + 8, t + 4).
__device__ __forceinline__ void wgmma_tf32(float (&d)[64], const uint32_t (&a)[4],
                                           uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %69, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32"
      " {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63},"
      " {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]),
        "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]),
        "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),
        "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(accumulate));
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}

// Keeps the compiler from moving accumulator reads across the wgmma wait.
__device__ __forceinline__ void fence_regs(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// W2r: 2S chunks c (tap c / 2, channels 32 (c % 2) ..), each of PIECES
// (N rows x 32) fp32 pieces: W2 rounded to TF32 to nearest (hi) and, when
// split, the rest rounded the same way (lo = rna(w - hi)). The 16-byte piece p
// of row n is stored at p ^ (n % 8), the 128-byte swizzle, so one bulk copy of
// a chunk lands it as wgmma reads it.
__global__ void c_conv2_round_weight(const float* __restrict__ w, uint32_t* __restrict__ w2r,
                                     int stride, int split) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;  // element of the hi pieces
  if (idx >= 2 * stride * N * KC) return;
  const int c = idx / (N * KC), n = (idx / KC) % N, pos = idx % KC;
  const int piece = (pos / 4) ^ (n % 8);  // the piece stored at this position
  const int f = (c % 2) * KC + 4 * piece + pos % 4, k = c / 2;
  const float v = w[((long long)n * F + f) * stride + k];
  const uint32_t hi = round_tf32(v);
  uint32_t* dst = w2r + (long long)c * (1 + split) * N * KC + idx % (N * KC);
  dst[0] = hi;
  if (split) dst[N * KC] = round_tf32(v - __uint_as_float(hi));
}

// m_total = B * io * J rows (b, i', j), io = W' // S; x_rows = W' (rows of x a
// batch element, at J * F floats each).
template <bool SPLIT>
__global__ void __launch_bounds__(THREADS, 1)
c_conv2_relu_kernel(const float* __restrict__ x, const uint32_t* __restrict__ w2r,
                    const float* __restrict__ bias, float* __restrict__ out, int m_total,
                    int j_count, int io, int x_rows, int stride, int n_tiles) {
  using T = Tile<SPLIT>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  // [STAGES][weight pieces | BM rows of 128 B], then full[STAGES], empty[STAGES]
  const uint32_t ring = smem_u32(base);
  const uint32_t full = ring + T::STAGES * T::STAGE_BYTES;
  const uint32_t empty = full + 8 * T::STAGES;
  const int tid = threadIdx.x;
  const int chunks = 2 * stride;  // K chunks a tile: two a tap

  if (tid == 0) {
    for (int s = 0; s < T::STAGES; ++s) {
      mbar_init(full + 8 * s, PRODUCERS + 1);  // each producer's cp.async, the weight's tx
      mbar_init(empty + 8 * s, CONSUMERS / 32);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (tid >= CONSUMERS) {
    // Producer warpgroup: piece `piece` of rows r0, r0 + 16, ... of each tile.
    const int p = tid - CONSUMERS;
    const int piece = p % 8, r0 = p / 8;
    // rows r0 + 16 i share r0 % 8, so the piece's swizzled place is the same
    const uint32_t dst0 = T::W_BYTES + r0 * 128 + ((piece ^ (r0 % 8)) << 4);
    const uint32_t tap_floats = (uint32_t)j_count * F;  // from one tap's row to the next
    int q = 0;
    for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
      const int first = tile * T::BM + r0;
      uint32_t off[T::ROWS_PER_PRODUCER];  // floats to row m's piece at tap 0
#pragma unroll
      for (int i = 0; i < T::ROWS_PER_PRODUCER; ++i) {
        const int m = min(first + 16 * i, m_total - 1);  // rows past the end: zeros
        const int bi = m / j_count, j = m - bi * j_count;
        const int b = bi / io, ip = bi - b * io;
        off[i] = ((uint32_t)(b * x_rows + stride * ip) * j_count + j) * F + 4 * piece;
      }
      const int live = m_total - first;  // row r0 + 16 i is live where 16 i < live
      for (int c = 0; c < chunks; ++c, ++q) {
        const int s = q % T::STAGES;
        mbar_wait(empty + 8 * s, ((q / T::STAGES) & 1) ^ 1);
        const uint32_t st = ring + s * T::STAGE_BYTES;
        if (p == 0) {
          mbar_expect_tx(full + 8 * s, T::W_BYTES);
          bulk_load(st, w2r + (long long)c * T::PIECES * N * KC, T::W_BYTES, full + 8 * s);
        }
        const uint32_t delta = (uint32_t)(c / 2) * tap_floats + (c % 2) * KC;
#pragma unroll
        for (int i = 0; i < T::ROWS_PER_PRODUCER; ++i)
          cp_async16(st + dst0 + i * 16 * 128, x + off[i] + delta, 16 * i < live ? 16 : 0);
        cp_async_arrive(full + 8 * s);
      }
    }
    asm volatile("cp.async.wait_all;" ::: "memory");
  } else {
    const int wg = tid / 128, warp = (tid % 128) / 32, lane = tid % 32;
    const int g = lane / 4, tq = lane % 4;
    // ldmatrix: lanes 8v .. 8v + 7 address matrix v, rows 8 (v % 2) + lane % 8
    // of the warp's 16 and piece v / 2 of the k8 step; every row here has
    // row % 8 == lane % 8, the XOR of its pieces.
    const uint32_t a_row =
        T::W_BYTES + (wg * 64 + warp * 16 + lane % 8 + 8 * ((lane / 8) % 2)) * 128;
    const int half = lane / 16, sw = lane % 8;

    // Each tile's first wgmma overwrites acc; it starts at zero so that no
    // wgmma operand is ever read uninitialized.
    float acc[64];
#pragma unroll
    for (int n = 0; n < 64; ++n) acc[n] = 0.f;

    int q = 0;
    for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
      for (int c = 0; c < chunks; ++c, ++q) {
        const int s = q % T::STAGES;
        mbar_wait(full + 8 * s, (q / T::STAGES) & 1);
        const uint32_t st = ring + s * T::STAGE_BYTES;
        // the chunk's four k8 steps: every fragment, then one wgmma group;
        // fr[0] the values rounded to TF32 (hi), fr[1] the rest rounded (lo)
        uint32_t fr[T::PIECES][4][4];
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          uint32_t raw[4];
          ldmatrix_x4(raw, st + a_row + (((2 * kk + half) ^ sw) << 4));
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float v = __uint_as_float(raw[e]);
            fr[0][kk][e] = round_tf32(v);
            if constexpr (SPLIT)
              fr[T::PIECES - 1][kk][e] = round_tf32(v - __uint_as_float(fr[0][kk][e]));
          }
        }
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          // k8 step kk: the B tile advances 32 bytes inside its 128-byte rows
          const uint64_t hi = kmajor_sw128_desc(st + 32 * kk);
          const int keep = c > 0 || kk > 0;
          if constexpr (SPLIT) {  // the small products first
            const uint64_t lo = kmajor_sw128_desc(st + B_BYTES + 32 * kk);
            wgmma_tf32(acc, fr[T::PIECES - 1][kk], hi, keep);
            wgmma_tf32(acc, fr[0][kk], lo, 1);
            wgmma_tf32(acc, fr[0][kk], hi, 1);
          } else {
            wgmma_tf32(acc, fr[0][kk], hi, keep);
          }
        }
        wgmma_commit();
        wgmma_wait0();
        if (lane == 0) mbar_arrive(empty + 8 * s);
      }

      // Epilogue: accumulator n holds row 16 warp + g + 8 ((n / 2) % 2) of the
      // warpgroup's 64, column 8 (n / 4) + 2 tq + n % 2; out = relu(acc + bias).
      fence_regs(acc);
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int m = tile * T::BM + wg * 64 + warp * 16 + g + 8 * hh;
        if (m < m_total) {
          float* row = out + (long long)m * N + 2 * tq;
#pragma unroll
          for (int nb = 0; nb < N / 8; ++nb) {
            const int col = 8 * nb + 2 * tq;
            const float b0 = bias != nullptr ? __ldg(bias + col) : 0.f;
            const float b1 = bias != nullptr ? __ldg(bias + col + 1) : 0.f;
            const float v0 = acc[4 * nb + 2 * hh] + b0;
            const float v1 = acc[4 * nb + 2 * hh + 1] + b1;
            // v < 0 ? 0 : v keeps a NaN, as torch's relu does
            *reinterpret_cast<float2*>(row + 8 * nb) =
                make_float2(v0 < 0.f ? 0.f : v0, v1 < 0.f ? 0.f : v1);
          }
        }
      }
    }
  }
}

bool takes(int batch, int width, int j_count, int stride, int in_channels,
           int out_channels) {
  return in_channels == F && out_channels == N && stride >= 1 && width >= stride &&
         j_count >= 1 && batch >= 1 &&
         // row offsets are 32-bit counts of floats
         (long long)batch * width * j_count * F < (1ll << 31);
}

int sm_count() {
  static const int n = [] {
    int dev = 0, count = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
      return 0;
    return count;
  }();
  return n;
}

template <bool SPLIT>
int launch(const float* x, const uint32_t* w2r, const float* bias, float* out, int m_total,
           int j_count, int io, int width, int stride, cudaStream_t s) {
  using T = Tile<SPLIT>;
  const int n_tiles = (m_total + T::BM - 1) / T::BM;
  const int grid = n_tiles < sm_count() ? n_tiles : sm_count();
  const cudaError_t err = cudaFuncSetAttribute(
      c_conv2_relu_kernel<SPLIT>, cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM);
  if (err != cudaSuccess) return (int)err;
  c_conv2_relu_kernel<SPLIT><<<grid, THREADS, T::SMEM, s>>>(
      x, w2r, bias, out, m_total, j_count, io, width, stride, n_tiles);
  return (int)cudaGetLastError();
}

}  // namespace

// Bytes of the weight scratch c_conv2_relu_forward needs for a kernel height
// S (split: the 3xTF32 form's two pieces).
extern "C" long long c_conv2_relu_weight_bytes(int stride, int split) {
  return stride >= 1 ? 2ll * stride * N * KC * 4 * (split ? 2 : 1) : 0;
}

// C entry point, bound from Python with ctypes. x: (B, W', J, 64) fp32
// contiguous and 16-byte aligned; w: (128, 64, S, 1) fp32 contiguous; bias:
// (128,) fp32 or null; w2r: c_conv2_relu_weight_bytes(S, split) bytes of
// scratch, 16-byte aligned; out: (B, W' // S, J, 128) fp32 contiguous.
// split = 0: one TF32 product, both operands rounded to nearest; split = 1:
// 3xTF32 (hi hi + hi lo + lo hi), float32 accuracy.
// Launches the weight's rounding and K3 on `stream` and returns 0 or a
// cudaError_t (cudaErrorInvalidValue when the sizes are outside what the
// kernel takes: in_channels != 64, out_channels != 128, W' < S, or
// B * W' * J * 64 >= 2^31).
extern "C" int c_conv2_relu_forward(const float* x, const float* w, const float* bias,
                                    void* w2r, float* out, int batch, int width, int j_count,
                                    int stride, int in_channels, int out_channels, int split,
                                    void* stream) {
  if (!takes(batch, width, j_count, stride, in_channels, out_channels))
    return (int)cudaErrorInvalidValue;
  if (sm_count() <= 0) return (int)cudaErrorNoDevice;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  uint32_t* wr = static_cast<uint32_t*>(w2r);
  const int w_elems = 2 * stride * N * KC;
  c_conv2_round_weight<<<(w_elems + PREP_THREADS - 1) / PREP_THREADS, PREP_THREADS, 0, s>>>(
      w, wr, stride, split != 0);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int io = width / stride;
  const int m_total = batch * io * j_count;
  return split ? launch<true>(x, wr, bias, out, m_total, j_count, io, width, stride, s)
               : launch<false>(x, wr, bias, out, m_total, j_count, io, width, stride, s);
}
