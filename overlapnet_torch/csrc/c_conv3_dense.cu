// K4: c_conv3 with its bias and ReLU, and the overlap dense, for Hopper
// (sm_90a), on the TF32 tensor cores.
//
//   overlap[b] = sigmoid(d_bias + sum_{y, x, o} D[y, x, o] *
//                  relu(c3_bias[o] + sum_{dy, dx, i} X[b, y + dy, x + dx, i] * W3[o, i, dy, dx]))
//
// X: (B, H, W, 128) fp32, c_conv2's ReLU'd output exactly as K3 writes it
// (channels last; H = W = J = W' // S in the head); W3: (256, 128, 3, 3)
// fp32, c_conv3's OIHW weight; D: overlap_output's (1, (H-2)(W-2) 256)
// weight read as (H-2, W-2, 256), the NHWC flatten the head has always
// used; overlap: (B, 1) fp32.
//
// Replaces no TPU kernel: the JAX package leaves c_conv3 and the dense to
// XLA (its models/heads.py). Why it was added: in the dense loop-closing
// cell (a traced benchmark window, PERF.md) the head's tail after K3 was
// four passes: cuDNN's TF32 implicit GEMM for c_conv3 (0.76 us a pair),
// cuDNN's bias add and PyTorch's ReLU, each a read and a write of the
// 496 KB a pair of c_conv3's output, and a gemv for the dense that read it
// once more: 1.66 us of the heads' 16.2 us a pair.
//
// What bounds it: operations. c_conv3 is an implicit GEMM, M = B (H-2)(W-2)
// output rows (b, y, x), N = 256, K = 9 taps x 128 channels = 1,152:
// 285.5 MFLOP a pair at J = 24, 0.577 us at the TF32 rate of 495 TFLOP/s,
// against 0.09 us for the 295 KB of X a pair at 3.35 TB/s. Fused, c_conv3's
// output never leaves the registers: the epilogue adds the bias, applies the
// ReLU, multiplies by D and sums each output row into one float a quarter
// of the channels. K4 takes 0.21-0.22 ms of device time at B = 256, J = 24
// on an H100 SXM at 700 W, 67-70% of the 0.148 ms bound (cuDNN's conv, bias
// add, ReLU and gemv took 0.44 ms; PERF.md).
//
// The design:
// - Persistent blocks, min(units, SMs) of them, walk units of BM = 128
//   consecutive output rows: two consumer warpgroups of one m64 tile each,
//   wgmma.m64n128k8.f32.tf32.tf32 with A from registers, two a k8 step for
//   a whole unit's 256 channels (128 fp32 accumulators a thread; setmaxnreg
//   232 / 40 over a 384-thread block). m64n256 gave the same time and bits.
// - A row's K values for tap (dy, dx) and channel quarter q are the 32
//   contiguous floats of X at pixel P + dy W + dx, P the row's own pixel, so
//   for one quarter every tap of a tile reads one contiguous run of pixels:
//   the tile's patch, P(first row) .. P(last row) + 2W + 2, at most
//   patch_rows_for() rows of 128 bytes (240 at J = 24). Three producer warps
//   copy each quarter's patch once with cp.async (rows stored with their
//   16-byte pieces XORed by the row) into one of two patch buffers; the nine
//   taps of that quarter read it at nine shifts, so X comes from L2 about
//   once a tile, not nine times. One patch buffer was 12% slower.
// - The weight streams through a ring of stages fed by bulk copies from one
//   producer thread: 36 chunks a unit (quarter-major, then tap), each the
//   256 x 32 TF32 slice of W3 in the 128-byte swizzle (32 KB), prepared once
//   a call by c_conv3_dense_round_weight. Streaming it from L2 costs no time
//   (a build that skipped the copies took as long).
// - The consumers form each k8 step's A fragments with ldmatrix from the
//   patch at the tap's shift and round them to TF32 to nearest (cvt.rna);
//   a chunk's four k8 steps are one wgmma group, double-buffered: chunk c's
//   group runs while chunk c + 1's fragments form (wait_group 1 against
//   wait_group 0 a chunk: 5-7% faster).
// - What holds it below the bound, measured: the epilogue's reads of D
//   (128 KB a unit from L2, in the same stretch on every SM: 15% of the
//   time; builds without the epilogue took 0.19 ms) and the tensor pipe's
//   own pace with these instructions (a build without fragments, weight
//   copies or epilogue took 0.1875 ms, 79% of the bound).
// - The last, partial wave of tiles goes in channel pieces (two of 128 or
//   four of 64, as many as fit in one wave; m64n64 for a quarter), first in
//   the walk: at B = 256, J = 24 the 968 tiles are 7.33 waves on 132 SMs,
//   and their last 44 as 88 halves end the call half a tile sooner (5%);
//   small batches, whose tiles are fewer than the SMs, spread over more of
//   them (B = 1: 16 quarters, 34.5 -> 22.2 us). Where every unit is a piece,
//   a stage holds a piece's chunk, so the ring holds more chunks ahead.
// - Epilogue: each thread's two rows get bias, ReLU and D over its columns
//   in a fixed order, a quad shuffle sums each quarter, and the float goes
//   to a scratch of 4 B (H-2)(W-2) partials, the same for every kind of
//   unit (m64n128 and m64n64 give each channel the same bits).
//   c_conv3_dense_finish, one block a pair, sums a pair's partials in a
//   fixed order, adds the dense's bias and applies the sigmoid. No
//   atomics: every output is summed in one order whatever the unit or the
//   batch, so two calls give the same bits and a batch's first b pairs the
//   bits of a call on b pairs.
// Precision: `split` follows torch.backends.cudnn.allow_tf32, the switch
// that set c_conv3's precision as a cuDNN convolution (on by default, as the
// configuration states). On: one TF32 product, both operands rounded to
// nearest, not truncated (truncation would bias every 1,152-term sum the
// same way). Off: 3xTF32 (lo hi + hi lo + hi hi), float32 accuracy. The
// sums, the epilogue and the dense are fp32 either way. An mbarrier wait
// that spins past SPIN_LIMIT traps instead of hanging.

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int CI = 128;               // input channels (c_conv2's outputs)
constexpr int CO = 256;               // output channels
constexpr int HALF_N = 128;           // a row's channels go in two halves of 128
constexpr int KC = 32;                // K chunk: 32 channels of one tap, a 128-byte row piece
constexpr int QUARTERS = CI / KC;     // channel quarters
constexpr int TAPS = 9;               // 3 x 3
constexpr int CHUNKS = QUARTERS * TAPS;
constexpr int HALF_BYTES = HALF_N * KC * 4;  // 16 KB: a chunk's TF32 piece of one half
constexpr int CONSUMER_WGS = 2;       // one m64 tile each
constexpr int BM = 64 * CONSUMER_WGS; // rows a tile
constexpr int CONSUMERS = 128 * CONSUMER_WGS;
constexpr int THREADS = CONSUMERS + 128;  // + one producer warpgroup
constexpr int COPIERS = 96;           // producer warps 0-2 copy the patches
constexpr int COPY_ROWS = COPIERS / 8;  // patch rows a pass of the copiers
// Registers a thread: what the launch gives each of THREADS (whole units of
// 8), then setmaxnreg hands the producer's surplus to the consumers.
constexpr int LAUNCH_REGS = 65536 / THREADS / 8 * 8;
constexpr int PRODUCER_REGS = 40;
constexpr int CONSUMER_REGS = (THREADS * LAUNCH_REGS - 128 * PRODUCER_REGS) / CONSUMERS / 8 * 8;
constexpr int MAX_W_STAGES = 16;
constexpr int MAX_A_STAGES = 2;
constexpr int SMEM_LIMIT = 232448;
constexpr int PREP_THREADS = 256;
constexpr long long SPIN_LIMIT = 1ll << 22;
static_assert(CONSUMER_REGS <= 256 && CONSUMER_REGS >= 2 * 64 + 64, "registers");
static_assert(CHUNKS % 2 == 0, "chunks go in pairs, one a fragment buffer");

// The call's shapes and schedule, as the kernel reads them.
struct Geometry {
  int m_total;      // B (H-2)(W-2) output rows
  int rows;         // (H-2)(W-2): a pair's rows
  int wo;           // W - 2: an output row's columns
  int width;        // W
  int pixels;       // H W: a pair's input pixels
  int x_pixels;     // B H W
  int n_tiles;      // tiles of BM rows
  int pieces;       // pieces a split tile's channels go in: 2 or 4 (1: none split)
  int split_units;  // the first units: the pieces of the last split_units / pieces tiles
  int n_units;      // all units
  int patch_rows;   // rows of a patch buffer
  int a_stages;     // patch buffers
  int w_stages;     // weight ring stages
  int w_stage_bytes;  // a stage: a whole chunk, or a piece's where every unit is a piece
};

// A unit of work: a tile's rows with `cols` of its channels from col0 on:
// all 256, or one piece of 128 or 64. Units 0 .. split_units - 1 are the
// pieces of the last split_units / pieces tiles; the rest are whole tiles,
// in order.
struct Unit {
  int tile, col0, cols;
};

__device__ __forceinline__ Unit unit_of(int u, const Geometry& g) {
  if (u >= g.split_units) return {u - g.split_units, 0, CO};
  const int cols = CO / g.pieces;
  return {g.n_tiles - g.split_units / g.pieces + u / g.pieces, u % g.pieces * cols, cols};
}

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

// A fragment of lane 4g + t of warp w of the warpgroup: a0 (16w + g, t),
// a1 (16w + g + 8, t), a2 (16w + g, t + 4), a3 (16w + g + 8, t + 4).
// D (64 x 128, fp32) = A (64 x 8, tf32, registers) * B (8 x 128, tf32, shared,
// K-major) + (accumulate ? D : 0).
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
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]),
        "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(accumulate));
}

// The same with N = 64: a quarter's channels.
__device__ __forceinline__ void wgmma_tf32_n64(float (&d)[32], const uint32_t (&a)[4],
                                               uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %37, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32"
      " {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31},"
      " {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(accumulate));
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// Keeps the compiler from moving accumulator reads across the wgmma wait.
__device__ __forceinline__ void fence_regs(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// The input pixel of output row m (b, y, x): b H W + y W + x.
__device__ __forceinline__ int pixel_of(int m, const Geometry& g) {
  const int b = m / g.rows, r = m - b * g.rows;
  const int y = r / g.wo;
  return b * g.pixels + y * g.width + (r - y * g.wo);
}

// W3r: chunks c = q * TAPS + tap, each of two halves h, each of PIECES
// (128 rows x 32) TF32 pieces: element (n, k) is W3[128 h + n, 32 q + k,
// tap / 3, tap % 3] rounded to nearest (hi) and, when split, the rest
// rounded the same way (lo = rna(w - hi)). The 16-byte piece p of row n is
// stored at p ^ (n % 8), the 128-byte swizzle, so one bulk copy of a chunk
// (or of one half of it) lands it as wgmma reads it. One thread an element
// of W3, in W3's order: the reads coalesce, the writes scatter.
__global__ void c_conv3_dense_round_weight(const float* __restrict__ w,
                                           uint32_t* __restrict__ w3r, int split) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;  // W3[o, i, tap] = w[idx]
  if (idx >= CO * CI * TAPS) return;
  const int tap = idx % TAPS, i = idx / TAPS % CI, o = idx / (TAPS * CI);
  const int n = o % HALF_N, k = i % KC;
  const int ch = (i / KC * TAPS + tap) * 2 + o / HALF_N;  // chunk c = q * TAPS + tap, half h
  const int at = n * KC + (((k / 4) ^ (n % 8)) << 2) + k % 4;
  const float v = w[idx];
  const uint32_t hi = round_tf32(v);
  uint32_t* dst = w3r + (long long)ch * (1 + split) * HALF_N * KC + at;
  dst[0] = hi;
  if (split) dst[HALF_N * KC] = round_tf32(v - __uint_as_float(hi));
}

// SPLIT: 3xTF32 (each operand as a TF32 pair hi + lo, each half's two weight
// pieces side by side in a stage).
template <bool SPLIT>
__global__ void __launch_bounds__(THREADS, 1)
c_conv3_dense_kernel(const float* __restrict__ x, const uint32_t* __restrict__ w3r,
                     const float* __restrict__ bias, const float* __restrict__ dense,
                     float* __restrict__ part, const Geometry g) {
  constexpr int PIECES = SPLIT ? 2 : 1;
  constexpr int SIDE_BYTES = PIECES * HALF_BYTES;  // one half of a chunk
  constexpr int W_BYTES = 2 * SIDE_BYTES;          // a weight stage: both halves
  constexpr int QUARTER_BYTES = HALF_BYTES / 2;    // 64 rows of a half's piece
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  // [w_stages][weight chunk], [a_stages][patch], then the mbarriers
  const uint32_t w_ring = smem_u32(base);
  const uint32_t a_ring = w_ring + g.w_stages * g.w_stage_bytes;
  const uint32_t a_bytes = g.patch_rows * 128;
  const uint32_t w_full = a_ring + g.a_stages * a_bytes;
  const uint32_t w_empty = w_full + 8 * MAX_W_STAGES;
  const uint32_t a_full = w_empty + 8 * MAX_W_STAGES;
  const uint32_t a_empty = a_full + 8 * MAX_A_STAGES;
  const int tid = threadIdx.x;

  if (tid == 0) {
    for (int s = 0; s < g.w_stages; ++s) {
      mbar_init(w_full + 8 * s, 1);                // the weight's tx
      mbar_init(w_empty + 8 * s, CONSUMERS / 32);  // one arrival per consumer warp
    }
    for (int s = 0; s < g.a_stages; ++s) {
      mbar_init(a_full + 8 * s, COPIERS);          // each copier's cp.async
      mbar_init(a_empty + 8 * s, CONSUMERS / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (tid >= CONSUMERS) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(PRODUCER_REGS));
    const int p = tid - CONSUMERS;
    if (p < COPIERS) {
      // The copiers: piece p % 8 of patch rows p / 8, p / 8 + COPY_ROWS, ...
      const int piece = p % 8, r0 = p / 8;
      int s = 0, phase = 0;
      for (int u = blockIdx.x; u < g.n_units; u += gridDim.x) {
        const int m0 = unit_of(u, g).tile * BM;
        const int p0 = pixel_of(m0, g);
        const int span = pixel_of(min(m0 + BM, g.m_total) - 1, g) + 2 * g.width + 3 - p0;
        for (int q = 0; q < QUARTERS; ++q) {
          mbar_wait(a_empty + 8 * s, phase ^ 1);
          const uint32_t st = a_ring + s * a_bytes;
          for (int r = r0; r < span; r += COPY_ROWS) {
            const int px = p0 + r;
            const bool live = px < g.x_pixels;
            cp_async16(st + r * 128 + ((piece ^ (r & 7)) << 4),
                       x + (long long)(live ? px : 0) * CI + q * KC + 4 * piece, live ? 16 : 0);
          }
          cp_async_arrive(a_full + 8 * s);
          if (++s == g.a_stages) s = 0, phase ^= 1;
        }
      }
      asm volatile("cp.async.wait_all;" ::: "memory");
    } else if (p == COPIERS) {
      // The weight stream: a unit's 36 chunks in order, both halves of each,
      // one half, or a quarter's 64 rows of its pieces (hi, then lo).
      int s = 0, phase = 0;
      for (int u = blockIdx.x; u < g.n_units; u += gridDim.x) {
        const Unit un = unit_of(u, g);
        const uint8_t* src = reinterpret_cast<const uint8_t*>(w3r) +
                             un.col0 / HALF_N * SIDE_BYTES + un.col0 % HALF_N * KC * 4;
        for (int c = 0; c < CHUNKS; ++c) {
          mbar_wait(w_empty + 8 * s, phase ^ 1);
          const uint32_t st = w_ring + s * g.w_stage_bytes;
          const uint8_t* chunk_src = src + (long long)c * W_BYTES;
          if (un.cols == CO) {
            mbar_expect_tx(w_full + 8 * s, W_BYTES);
            bulk_load(st, chunk_src, W_BYTES, w_full + 8 * s);
          } else if (un.cols == HALF_N) {
            mbar_expect_tx(w_full + 8 * s, SIDE_BYTES);
            bulk_load(st, chunk_src, SIDE_BYTES, w_full + 8 * s);
          } else {
            mbar_expect_tx(w_full + 8 * s, PIECES * QUARTER_BYTES);
#pragma unroll
            for (int pc = 0; pc < PIECES; ++pc)
              bulk_load(st + pc * QUARTER_BYTES, chunk_src + pc * HALF_BYTES, QUARTER_BYTES,
                        w_full + 8 * s);
          }
          if (++s == g.w_stages) s = 0, phase ^= 1;
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(CONSUMER_REGS));
    const int wg = tid / 128, warp = (tid % 128) / 32, lane = tid % 32;
    const int g8 = lane / 4, tq = lane % 4, half = lane / 16;
    // ldmatrix: lanes 8v .. 8v + 7 address matrix v: row 8 (v % 2) + lane % 8
    // of the warp's 16 and piece v / 2 of the k8 step
    const int lrow = wg * 64 + warp * 16 + lane % 8 + 8 * ((lane / 8) % 2);

    // acc[h]: the unit's channel half h (a whole unit's 128 h .. 128 h + 127;
    // a piece's own channels in acc[0]). Each unit's first wgmma overwrites
    // it; it starts at zero so that no wgmma operand is ever read
    // uninitialized.
    float acc[2][64];
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int n = 0; n < 64; ++n) acc[h][n] = 0.f;

    // Fragments double-buffered by chunk parity: chunk c's wgmma group stays
    // in flight while chunk c + 1's fragments form (wgmma.wait_group 1); a
    // stage is released once the group that read it is done. (A third
    // buffer and wait_group 2 measured a third slower.)
    uint32_t fr[2][PIECES][4][4];
    int ws = 0, w_phase = 0, as = 0, a_phase = 0;
    int done_w = -1, done_a = -1;  // stages read by the group still in flight

    // One unit of COLS channels: its 36 chunks, then the epilogue. A whole
    // unit issues two m64n128 wgmma a k8 step (one a channel half: the same
    // instruction as a half unit's one, so every channel is summed alike), a
    // quarter unit one m64n64.
    auto run_unit = [&](auto cols, int m0, int col0) {
      constexpr int COLS = decltype(cols)::value;
      constexpr int SIDES = COLS == CO ? 2 : 1;
      constexpr int N = COLS == CO ? HALF_N : COLS;  // the wgmma N
      constexpr int LO = N * KC * 4;                 // from a side's hi piece to its lo
      constexpr int SIDE = PIECES * LO;              // from one side to the next
      // this lane's ldmatrix row: its patch row at tap 0 (rows past the end
      // read the last row's, and are not written)
      const int p0 = pixel_of(m0, g);
      const int off = pixel_of(min(m0 + lrow, g.m_total - 1), g) - p0;
      // chunk c = (quarter q, tap): its four k8 steps' fragments, then one
      // wgmma group; fr[P][0] the values rounded to TF32 (hi), fr[P][1] the
      // rest rounded (lo)
      auto chunk = [&](auto parity, int c) {
        constexpr int P = decltype(parity)::value;
        const int q = c / TAPS, tap = c - q * TAPS;
        if (tap == 0) mbar_wait(a_full + 8 * as, a_phase);
        const int prow = off + (tap / 3) * g.width + tap % 3;
        const uint32_t row = a_ring + as * a_bytes + prow * 128;
        const int sw = prow & 7;
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          uint32_t raw[4];
          ldmatrix_x4(raw, row + (((2 * kk + half) ^ sw) << 4));
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float v = __uint_as_float(raw[e]);
            fr[P][0][kk][e] = round_tf32(v);
            if constexpr (SPLIT)
              fr[P][PIECES - 1][kk][e] = round_tf32(v - __uint_as_float(fr[P][0][kk][e]));
          }
        }
        mbar_wait(w_full + 8 * ws, w_phase);
        const uint32_t wst = w_ring + ws * g.w_stage_bytes;
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const int keep = c > 0 || kk > 0;
#pragma unroll
          for (int h = 0; h < SIDES; ++h) {
            // k8 step kk: the B tile advances 32 bytes inside its 128-byte rows
            const uint32_t side = wst + h * SIDE + 32 * kk;
            auto mma = [&](const uint32_t (&a)[4], uint32_t b, int accumulate) {
              if constexpr (N == 64)
                wgmma_tf32_n64(*reinterpret_cast<float (*)[32]>(acc[h]), a,
                               kmajor_sw128_desc(b), accumulate);
              else
                wgmma_tf32(acc[h], a, kmajor_sw128_desc(b), accumulate);
            };
            if constexpr (SPLIT) {  // the small products first
              mma(fr[P][PIECES - 1][kk], side, keep);
              mma(fr[P][0][kk], side + LO, 1);
              mma(fr[P][0][kk], side, 1);
            } else {
              mma(fr[P][0][kk], side, keep);
            }
          }
        }
        wgmma_commit();
        wgmma_wait<1>();  // chunk c - 1's group is done: its stages are free
        if (lane == 0) {
          if (done_w >= 0) mbar_arrive(w_empty + 8 * done_w);
          if (done_a >= 0) mbar_arrive(a_empty + 8 * done_a);
        }
        done_w = ws;
        done_a = -1;
        if (++ws == g.w_stages) ws = 0, w_phase ^= 1;
        if (tap == TAPS - 1) {  // the quarter's patch is read by no later chunk
          done_a = as;
          if (++as == g.a_stages) as = 0, a_phase ^= 1;
        }
      };
      for (int c = 0; c < CHUNKS; c += 2) {
        chunk(std::integral_constant<int, 0>(), c);
        chunk(std::integral_constant<int, 1>(), c + 1);
      }
      wgmma_wait<0>();
      if (lane == 0) {
        mbar_arrive(w_empty + 8 * done_w);
        mbar_arrive(a_empty + 8 * done_a);
      }
      done_w = done_a = -1;

      // Epilogue: acc[h][n] holds row 16 warp + g + 8 ((n / 2) % 2) of the m64
      // tile, channel col0 + 128 h + 8 (n / 4) + 2 tq + n % 2. Each row and
      // quarter of the channels: the sum over its 64 channels of
      // relu(acc + bias) D, this thread's in order, then the quad's four sums
      // (lanes 4g .. 4g + 3) by shuffles; partial 4 m + (the quarter) holds
      // it, whatever the unit.
#pragma unroll
      for (int h = 0; h < SIDES; ++h) {
        fence_regs(acc[h]);
#pragma unroll
        for (int qq = 0; qq < N / 64; ++qq) {
          const int c0 = col0 + h * HALF_N + 64 * qq + 2 * tq;
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            const int m = m0 + wg * 64 + warp * 16 + g8 + 8 * hh;
            float sum = 0.f;
            if (m < g.m_total) {
              const float* d = dense + (long long)(m % g.rows) * CO + c0;
#pragma unroll
              for (int nb = 0; nb < 8; ++nb) {
                const float2 b2 = __ldg(reinterpret_cast<const float2*>(bias + c0 + 8 * nb));
                const float2 d2 = __ldg(reinterpret_cast<const float2*>(d + 8 * nb));
                const float v0 = acc[h][32 * qq + 4 * nb + 2 * hh] + b2.x;
                const float v1 = acc[h][32 * qq + 4 * nb + 2 * hh + 1] + b2.y;
                // v < 0 ? 0 : v keeps a NaN, as torch's relu does
                sum = fmaf(v0 < 0.f ? 0.f : v0, d2.x, sum);
                sum = fmaf(v1 < 0.f ? 0.f : v1, d2.y, sum);
              }
            }
            sum += __shfl_xor_sync(0xffffffffu, sum, 1);
            sum += __shfl_xor_sync(0xffffffffu, sum, 2);
            if (tq == 0 && m < g.m_total) part[4ll * m + (c0 - 2 * tq) / 64] = sum;
          }
        }
      }
    };

    for (int u = blockIdx.x; u < g.n_units; u += gridDim.x) {
      const Unit un = unit_of(u, g);
      if (un.cols == CO)
        run_unit(std::integral_constant<int, CO>(), un.tile * BM, 0);
      else if (un.cols == HALF_N)
        run_unit(std::integral_constant<int, HALF_N>(), un.tile * BM, un.col0);
      else
        run_unit(std::integral_constant<int, HALF_N / 2>(), un.tile * BM, un.col0);
    }
  }
}

// One block of FINISH_THREADS a pair: the sum of its 4 (H-2)(W-2) partials
// (thread t takes t, t + FINISH_THREADS, ... in order, then a fixed shuffle
// tree in each warp and the warps' sums in order), plus the dense's bias,
// through the sigmoid.
constexpr int FINISH_THREADS = 128;

__global__ void __launch_bounds__(FINISH_THREADS)
c_conv3_dense_finish(const float* __restrict__ part, const float* __restrict__ dense_bias,
                     float* __restrict__ out, int per_pair) {
  __shared__ float warp_sums[FINISH_THREADS / 32];
  const float* src = part + (long long)blockIdx.x * per_pair;
  float sum = 0.f;
  for (int i = threadIdx.x; i < per_pair; i += FINISH_THREADS) sum += src[i];
#pragma unroll
  for (int o = 16; o > 0; o /= 2) sum += __shfl_xor_sync(0xffffffffu, sum, o);
  if (threadIdx.x % 32 == 0) warp_sums[threadIdx.x / 32] = sum;
  __syncthreads();
  if (threadIdx.x == 0) {
    float total = 0.f;
#pragma unroll
    for (int w = 0; w < FINISH_THREADS / 32; ++w) total += warp_sums[w];
    out[blockIdx.x] = 1.f / (1.f + expf(-(total + *dense_bias)));
  }
}

bool takes(int batch, int height, int width, int in_channels, int out_channels) {
  return in_channels == CI && out_channels == CO && batch >= 1 && height >= 3 && width >= 3 &&
         // pixel offsets are 32-bit counts of floats
         (long long)batch * height * width * CI < (1ll << 31);
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

// Rows a patch buffer needs: the pixels from a tile's first row's to its last
// row's + 2W + 2. Among a tile's BM - 1 steps from row to row, a step inside
// an output row moves one pixel, one to the next output row three (an extra
// 2) and one to the next pair 2W + 3 (an extra 2W + 2, counted here beside
// the row's 2: a bound), rounded up to whole 8-row swizzle groups.
int patch_rows_for(int height, int width) {
  const int rows = (height - 2) * (width - 2), wo = width - 2;
  const int row_steps = (BM - 1 + wo - 1) / wo, pair_steps = (BM - 1 + rows - 1) / rows;
  const int span = BM - 1 + 2 * row_steps + (2 * width + 2) * pair_steps + 2 * width + 3;
  return (span + 7) / 8 * 8;
}

size_t smem_for(int w_stages, int w_bytes, int a_stages, int a_bytes) {
  return 1024 + (size_t)w_stages * w_bytes + (size_t)a_stages * a_bytes +
         16 * (MAX_W_STAGES + MAX_A_STAGES);
}

template <bool SPLIT>
int launch(const float* x, const uint32_t* w3r, const float* bias, const float* dense,
           float* part, int batch, int height, int width, cudaStream_t s) {
  constexpr int W_BYTES = 2 * (SPLIT ? 2 : 1) * HALF_BYTES;
  // setmaxnreg.inc waits for registers the launch did not give: a build
  // whose kernel has fewer than LAUNCH_REGS a thread is refused
  static const bool regs_ok = [] {
    cudaFuncAttributes attr;
    return cudaFuncGetAttributes(&attr, c_conv3_dense_kernel<SPLIT>) == cudaSuccess &&
           attr.numRegs >= LAUNCH_REGS;
  }();
  if (!regs_ok) return (int)cudaErrorInvalidDeviceFunction;
  const int sms = sm_count();
  Geometry g;
  g.rows = (height - 2) * (width - 2);
  g.m_total = batch * g.rows;
  g.wo = width - 2;
  g.width = width;
  g.pixels = height * width;
  g.x_pixels = batch * g.pixels;
  g.n_tiles = (g.m_total + BM - 1) / BM;
  // The tiles of a last, partial wave go in channel pieces, as many as let
  // the pieces fit in one wave of the SMs (4, else 2, else none): the call
  // takes a quarter or a half tile's time where it would take a tile's. The
  // pieces go first, so that the blocks that take one run out of step with
  // the rest, and not all of them read D in the same stretch.
  const int last = g.n_tiles % sms;
  g.pieces = last == 0 ? 1 : 4 * last <= sms ? 4 : 2 * last <= sms ? 2 : 1;
  g.split_units = g.pieces > 1 ? g.pieces * last : 0;
  g.n_units = g.n_tiles - last + g.split_units + (g.pieces > 1 ? 0 : last);
  g.patch_rows = patch_rows_for(height, width);
  const int a_bytes = g.patch_rows * 128;
  // A stage holds a whole chunk, or, where every unit is a piece (a small
  // batch), one piece's: the ring then holds more chunks ahead, which a
  // piece's short chunks need to cover L2's latency.
  g.w_stage_bytes = g.split_units < g.n_units ? W_BYTES : W_BYTES / g.pieces;
  // two patch buffers and as many weight stages as fit, else one patch buffer
  g.a_stages = MAX_A_STAGES;
  for (;; --g.a_stages) {
    if (g.a_stages == 0) return (int)cudaErrorInvalidValue;
    g.w_stages = MAX_W_STAGES;
    while (g.w_stages > 2 &&
           smem_for(g.w_stages, g.w_stage_bytes, g.a_stages, a_bytes) > SMEM_LIMIT)
      --g.w_stages;
    if (smem_for(g.w_stages, g.w_stage_bytes, g.a_stages, a_bytes) <= SMEM_LIMIT) break;
  }
  const int smem = (int)smem_for(g.w_stages, g.w_stage_bytes, g.a_stages, a_bytes);
  const cudaError_t err = cudaFuncSetAttribute(
      c_conv3_dense_kernel<SPLIT>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const int grid = g.n_units < sms ? g.n_units : sms;
  c_conv3_dense_kernel<SPLIT><<<grid, THREADS, smem, s>>>(x, w3r, bias, dense, part, g);
  return (int)cudaGetLastError();
}

}  // namespace

// Bytes of the scratch c_conv3_dense_forward needs for a batch of B (H, W)
// inputs (split: the 3xTF32 form's two weight pieces): the rounded weight,
// then the B (H-2)(W-2) 4 partials.
extern "C" long long c_conv3_dense_scratch_bytes(int batch, int height, int width, int split) {
  if (batch < 1 || height < 3 || width < 3) return 0;
  return (long long)CO * CI * TAPS * 4 * (split ? 2 : 1) +
         (long long)batch * (height - 2) * (width - 2) * 4 * 4;
}

// C entry point, bound from Python with ctypes. x: (B, H, W, 128) fp32
// contiguous and 16-byte aligned; w: (256, 128, 3, 3) fp32 contiguous; bias:
// (256,) fp32, 8-byte aligned; dense: ((H-2)(W-2) 256) fp32 contiguous,
// 8-byte aligned; dense_bias: (1,) fp32; scratch:
// c_conv3_dense_scratch_bytes(B, H, W, split) bytes, 16-byte aligned; out:
// (B,) fp32.
// split = 0: one TF32 product, both operands rounded to nearest; split = 1:
// 3xTF32 (hi hi + hi lo + lo hi), float32 accuracy.
// Launches the weight's rounding, K4 and the per-pair sums on `stream` and
// returns 0 or a cudaError_t (cudaErrorInvalidValue when the sizes are
// outside what the kernel takes: in_channels != 128, out_channels != 256,
// H or W < 3, B H W 128 >= 2^31, or a patch too large for shared memory).
extern "C" int c_conv3_dense_forward(const float* x, const float* w, const float* bias,
                                     const float* dense, const float* dense_bias, void* scratch,
                                     float* out, int batch, int height, int width,
                                     int in_channels, int out_channels, int split, void* stream) {
  if (!takes(batch, height, width, in_channels, out_channels)) return (int)cudaErrorInvalidValue;
  if (sm_count() <= 0) return (int)cudaErrorNoDevice;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  uint32_t* w3r = static_cast<uint32_t*>(scratch);
  float* part = reinterpret_cast<float*>(w3r + (long long)CO * CI * TAPS * (split ? 2 : 1));
  const int w_elems = CO * CI * TAPS;
  c_conv3_dense_round_weight<<<(w_elems + PREP_THREADS - 1) / PREP_THREADS, PREP_THREADS, 0, s>>>(
      w, w3r, split != 0);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int rc = split ? launch<true>(x, w3r, bias, dense, part, batch, height, width, s)
                       : launch<false>(x, w3r, bias, dense, part, batch, height, width, s);
  if (rc != 0) return rc;
  c_conv3_dense_finish<<<batch, FINISH_THREADS, 0, s>>>(part, dense_bias, out,
                                                       (height - 2) * (width - 2) * 4);
  return (int)cudaGetLastError();
}
