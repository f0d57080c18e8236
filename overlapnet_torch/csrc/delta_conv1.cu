// K1: fused DeltaLayer + c_conv1 forward for Hopper (sm_90a), on the bf16
// tensor cores with exact operands.
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
// N = F = 64, K = S*C (1920 at C = 128, S = 15), with the A operand formed
// in registers and never written to memory.
//
// The arithmetic. |x - y| = x + y - 2 min(x, y) exactly, so
//   out = L_a[i] + L_b[j] + bias - 2 sum_{k,c} W[k,c,f] min(a[i,c], bb[S*j+k,c])
// with L_a[b,i,f] = sum_c a[b,i,c] sum_k W[k,c,f] (shared by every j) and
// L_b[b,j,f] = sum_{k,c} W[k,c,f] bb[b,S*j+k,c] (shared by every i), each
// 1/360 of the product's operations at W' = 360. The legs run in bfloat16
// and hand over bf16 values held in fp32; min(x, y) is one of its arguments,
// so it is a bf16 value too: the product's A operand is exact in one bf16
// piece (|x - y| is not). W is exact as three bf16 pieces W1 + W2 + W3
// (truncation: each piece takes the next 8 bits of the 24-bit significand),
// every partial product is exact in fp32 and the sums are fp32. That is
// three bf16 products (989 TFLOP/s on an H100 SXM) where 3xTF32 took three
// TF32 ones (495): the floor at B = 256, W' = 360 is 1.65 ms.
// The price is cancellation. The rounding is a few fp32 ulps of L and of
// the min term, not of the output: L_a and L_b are summed in fp32 over
// chunks of 32 and the chunks in fp64, the min term in the tensor cores'
// fp32 accumulators (which drop low bits on every wgmma) and the per-tap fp32
// sums. Against the output's norm the error grows with the pair's
// cancellation ratio
//   rho^2 = sum_f (rms_i L_a + rms_j L_b)^2 / sum_f mean_{i,j} (L_a[i] - L_b[j])^2,
// the size of the sums over that of L_a - L_b = sum W (a - bb), which is
// about that of the output sum W |a - bb|. Features that share an offset
// have a large rho: an offset of 10 over a spread of 1 gives rho 13-16 and
// an error of 8e-6 (PERF.md). So a pair takes the exact path only where
// rho <= ROUTE_RATIO = 8, which keeps its error within about 5e-6 of the
// output's norm (3xTF32 was within about 6e-7): not float32 accuracy.
//
// Two paths, chosen on the device with no host sync. The pre-pass sets one
// flag a call: whether every element of a and of bb's used rows is a bf16
// value (low 16 bits zero); and one route a pair: whether its rho is at
// most ROUTE_RATIO.
// - exact (the flag and the pair's route set): rows staged as bf16 copies
//   the pre-pass wrote; the A fragment is min.bf16x2 of packed pairs, one
//   instruction per two elements; three products A W1 + A W2 + A W3; the
//   epilogue adds L.
// - general (any other pair, and every pair of a call with an fp32 input:
//   fp32 legs, test volumes): rows staged in
//   fp32; A = |a - bb| (rounded to fp32, as the plain version) split by
//   truncation into three exact bf16 pieces A1 + A2 + A3 and the six
//   products of order <= 2 (A1W1, A1W2, A2W1, A1W3, A2W2, A3W1): the
//   dropped terms are below 2^-24 of A W, the tensor-core work of 3xTF32,
//   and no cancellation. (The min form on fp32 inputs doubled the fp32
//   training step's gradient gap to the CPU; chip_smoke.py, phase train.)
// `tally`, when given, gains 1 for each call whose every pair took the
// exact path.
//
// Kernels, in stream order, one call:
// - split_weight_kernel: W as Wt (3F, S*C) bf16, K-major for TMA (rows
//   0..F-1 W1, F..2F-1 W2, 2F..3F-1 W3); Wsum (C, F) = sum_k W; the flag
//   set to 1. Inside every 64-column chunk the columns are permuted so that
//   a thread's fragment columns of k16 step s (2t, 2t+1, 2t+8, 2t+9) are
//   channels 16t + 4s .. 16t + 4s + 3: each thread reads 16 contiguous
//   channels of a row for four k16 steps.
// - split_weight_kernel_sides: L_a for each distinct left volume and L_b for
//   each distinct right volume (batch stride 0: once), an fp32 SIMT GEMM
//   whose every output one thread sums in a fixed order, no atomics; the
//   bf16 copies of both volumes; the flag cleared by any block that reads a
//   value that is not bf16, which then stops (the general path reads
//   neither L nor the copies). It reads the volumes once.
// - split_weight_kernel_route: each pair's route from its L_a and L_b, one
//   block a pair, fp64 sums in a fixed order (nothing when the flag is
//   clear).
// - delta_conv1_kernel, per block of BM = 192 consecutive (i, j) rows of one
//   pair: a producer thread feeds the weight pieces by TMA (one 2D tensor
//   map, 128-byte swizzle, 64 K x 3F per stage) into a ring of mbarriers,
//   and ahead of each tap copies the tap's J right rows (bulk copies) into
//   the next of B_BUFS buffers that the whole block reads; setmaxnreg moves
//   registers to three consumer warpgroups of one m64 tile each, which issue
//   wgmma.m64n64k16.f32.bf16.bf16 with A from registers. The path sets the
//   layout: bf16 rows take half the room of fp32 ones, and each path's ring
//   takes as many stages, up to MAX_STAGES, as its layout leaves room for.
//   The left rows a[i] of the block are staged once. Each chunk goes in
//   units (two k16 steps on the exact path, one on the general) whose
//   fragments are double-buffered: a unit's wgmma group stays in flight
//   while the next unit's fragments form (wgmma.wait_group 1). The tensor cores' fp32 accumulation drops low
//   bits on every wgmma, so each tap sums in the accumulators (reset by its
//   first wgmma) and the tap sums add up in fp32 on the CUDA cores, tap 0
//   first, into totals that a thread keeps in registers. Two accumulator
//   sets alternate by tap: tap k+1's first unit goes into the other set
//   before tap k's set is added to the totals, so the tensor pipe never
//   drains at a tap's end and no accumulator in flight is read
//   (wait_group 0 comes once, before the epilogue). The epilogue masks the
//   rows past W'*J (the ragged last tile). Blocks share no sum: no atomics,
//   the same bits every run.
// What bounds it: at B = 256, W' = 360 the product kernel takes about
// 3.0 ms on the exact path against the 1.65 ms floor (PERF.md). A
// consumer thread holds 2 x 32 accumulators and 32 totals in its 160
// registers (setmaxnreg 160 / 32 over a 512-thread block launched at 128),
// and ptxas still spills a little around each tap's add; a fourth consumer
// warpgroup (BM = 256) leaves 112 registers, and ptxas then serializes the
// wgmma (C7512). A warpgroup's own work per unit (its fragments, the ring's
// waits) sets the pace as much as the tensor cores do: fewer rows a
// warpgroup is dearer per row, which is why the right rows are the
// producer's work. A ring of 4 stages is faster than one of 6 or 8, for
// which shared memory has room. Weight multicast over clusters of blocks, persistent
// blocks and flushes every second tap were tried and were slower (PERF.md).
// An mbarrier wait that spins past SPIN_LIMIT traps instead of hanging.

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int F = 64;             // output features: the wgmma N
constexpr int CONSUMER_WGS = 3;   // consumer warpgroups, one m64 tile each
constexpr int BM = 64 * CONSUMER_WGS;  // output rows ((i, j) pairs) per block
constexpr int KC = 64;            // K chunk: 64 channels of one tap, one 128-byte bf16 row
constexpr int PIECES = 3;         // W = W1 + W2 + W3 in bf16
constexpr int MAX_STAGES = 4;     // weight ring depth at most (deeper rings measured slower)
constexpr int B_BUFS = 4;         // buffers of a tap's right rows, shared by the block
constexpr int CONSUMERS = 128 * CONSUMER_WGS;
constexpr int THREADS = CONSUMERS + 128;  // + one producer warpgroup
// Registers a thread: what the launch gives each of THREADS (whole units of
// 8), then setmaxnreg hands the producer's surplus to the consumers.
constexpr int LAUNCH_REGS = 65536 / THREADS / 8 * 8;
constexpr int PRODUCER_REGS = 32;
constexpr int CONSUMER_REGS = (THREADS * LAUNCH_REGS - 128 * PRODUCER_REGS) / CONSUMERS / 8 * 8;
constexpr int PIECE_BYTES = F * KC * 2;   // 8 KB: F rows of 128 B
constexpr int STAGE_BYTES = PIECES * PIECE_BYTES;
constexpr int ROW_PAD = 16;       // staged-row pad (bytes): conflict-free 16 B loads
constexpr int SMEM_LIMIT = 232448;
constexpr long long SPIN_LIMIT = 1ll << 22;
// the pre-pass GEMM: SIDE_ROWS rows x F outputs a block, 4 x 2 a thread
constexpr int SIDE_ROWS = 32, SIDE_K = 32, SIDE_THREADS = 256;
// A pair takes the exact path where its cancellation ratio is at most this
// (see the note at the top); kernels/delta_conv1.py's ROUTE_RATIO mirrors it.
constexpr double ROUTE_RATIO = 8.0;
constexpr int ROUTE_THREADS = 256;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// The high halves of two fp32 bit patterns as one packed bf16 pair (x low).
__device__ __forceinline__ uint32_t pack_hi(uint32_t x, uint32_t y) {
  return __byte_perm(x, y, 0x7632);
}

__device__ __forceinline__ uint32_t bf16x2_min(uint32_t x, uint32_t y) {
  uint32_t d;
  asm("min.bf16x2 %0, %1, %2;" : "=r"(d) : "r"(x), "r"(y));
  return d;
}

// x = p1 + p2 + p3 exactly, each a bf16 value (as fp32 bits, low half zero):
// truncation keeps 8 of the 24 significand bits a piece.
__device__ __forceinline__ void split3(float x, uint32_t& p1, uint32_t& p2, uint32_t& p3) {
  p1 = __float_as_uint(x) & 0xFFFF0000u;
  const float r = x - __uint_as_float(p1);
  p2 = __float_as_uint(r) & 0xFFFF0000u;
  p3 = __float_as_uint(r - __uint_as_float(p2));
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

// A bulk global -> shared copy of `bytes` (a multiple of 16) that completes
// on the mbarrier at bar.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
      ::"r"(dst), "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;" ::"n"(CONSUMERS) : "memory");
}

// wgmma descriptor of a K-major tile written by TMA with the 128-byte
// swizzle: rows of 128 B, 8-row groups 1024 B apart (SBO); LBO is unused.
__device__ __forceinline__ uint64_t kmajor_sw128_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (1ull << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

// D (64 x 64, fp32) = A (64 x 16, bf16, registers) * B (16 x 64, bf16, shared,
// K-major) + (accumulate ? D : 0).
// A fragment of a thread (lane = 4g + t within warp w of the warpgroup), each
// register a packed pair (lower k in the low half):
// a0 (16w + g, 2t..2t+1), a1 (16w + g + 8, 2t..2t+1),
// a2 (16w + g, 2t+8..2t+9), a3 (16w + g + 8, 2t+8..2t+9).
__device__ __forceinline__ void wgmma_bf16(float (&d)[32], uint32_t a0, uint32_t a1,
                                           uint32_t a2, uint32_t a3, uint64_t desc_b,
                                           int accumulate) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %37, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16"
      " {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31},"
      " {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
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
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// Keeps the compiler from moving accumulator reads across the wgmma wait.
__device__ __forceinline__ void fence_regs(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// Wt (3F, S*C) bf16, K-major: row pF + f holds piece p + 1 of feature f.
// Column base + 16s + kk of a 64-column chunk holds channel
// base + 16 ((kk % 8) / 2) + 4s + kk % 2 + 2 (kk / 8) (see the note at the
// top). Also Wsum (C, F) = sum_k W[k], and the call's flag set to 1.
__global__ void split_weight_kernel(const float* __restrict__ w, uint16_t* __restrict__ wt,
                                    float* __restrict__ wsum, int* __restrict__ exact_flag,
                                    int channels, int stride) {
  const int k_total = stride * channels;
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx == 0) *exact_flag = 1;
  if (idx < channels * F) {
    float s = 0.f;
    for (int k = 0; k < stride; ++k) s += w[(long long)k * channels * F + idx];
    wsum[idx] = s;
  }
  if (idx >= F * k_total) return;
  const int f = idx / k_total, col = idx % k_total;
  const int intra = col % KC, st = intra / 16, kk = intra % 16;
  const int src = col - intra + 16 * ((kk % 8) / 2) + 4 * st + kk % 2 + 2 * (kk / 8);
  uint32_t p[PIECES];
  split3(w[(long long)src * F + f], p[0], p[1], p[2]);
#pragma unroll
  for (int i = 0; i < PIECES; ++i)
    wt[(long long)(i * F + f) * k_total + col] = static_cast<uint16_t>(p[i] >> 16);
}

// L_a (rows of a, K = C, weight Wsum) and L_b (rows of bb grouped by j: the
// S*C contiguous values bb[S*j .. S*j + S - 1], weight W as (S*C, F)), one
// block per SIDE_ROWS rows of either, 4 rows x 2 features a thread, the next
// K chunk loaded while this one is summed; the bf16 copies of the rows
// read; the flag cleared where a value is not bf16.
__global__ void __launch_bounds__(SIDE_THREADS)
split_weight_kernel_sides(const float* __restrict__ a, const float* __restrict__ bb,
                          const float* __restrict__ w, const float* __restrict__ wsum,
                          float* __restrict__ la, float* __restrict__ lb,
                          uint16_t* __restrict__ a16, uint16_t* __restrict__ b16,
                          int* __restrict__ exact_flag, int width, int channels, int stride,
                          int j_count, int a_batches, int b_batches, long long a_bstride,
                          long long b_bstride) {
  __shared__ __align__(16) float xs[SIDE_K][SIDE_ROWS + 4];
  __shared__ __align__(16) float ws[SIDE_K][F];
  const int tid = threadIdx.x;
  const int a_rows = a_batches * width;
  const int a_tiles = (a_rows + SIDE_ROWS - 1) / SIDE_ROWS;
  const bool left = blockIdx.x < a_tiles;
  const int rows = left ? a_rows : b_batches * j_count;
  const int row0 = (left ? blockIdx.x : blockIdx.x - a_tiles) * SIDE_ROWS;
  const int k_len = left ? channels : stride * channels;
  const float* wmat = left ? wsum : w;
  float* dst = left ? la : lb;

  // the float4 of the X tile this thread loads: row tid / 8, columns 4 (tid % 8)
  const int xr = tid / 8, xc = 4 * (tid % 8);
  const bool live = row0 + xr < rows;
  long long off = 0;
  if (live) {
    const int r = row0 + xr;
    off = left ? (r / width) * a_bstride + (long long)(r % width) * channels
               : (r / j_count) * b_bstride + (long long)stride * (r % j_count) * channels;
  }
  const float* src = (left ? a : bb) + off + xc;
  uint16_t* copy = (left ? a16 : b16) + off + xc;

  const int tx = tid % 32, ty = tid / 32;  // features 2 tx, 2 tx + 1; rows 4 ty..
  // each K chunk sums in fp32, the chunks in fp64: L_a + L_b - 2 M cancels
  // where a and bb are close, so L carries no more than an ulp or two
  double total[4][2] = {};
  auto load = [&](int k0, float4& x, float4 (&wv)[2]) {
    x = live ? *reinterpret_cast<const float4*>(src + k0) : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int e = tid + h * SIDE_THREADS;  // 512 float4 of the (SIDE_K, F) tile
      wv[h] = *reinterpret_cast<const float4*>(wmat + (long long)(k0 + e / 16) * F + 4 * (e % 16));
    }
  };
  float4 x, wv[2];
  load(0, x, wv);
  for (int k0 = 0; k0 < k_len; k0 += SIDE_K) {
    bool odd = false;
    if (live) {
      const uint32_t bx = __float_as_uint(x.x), by = __float_as_uint(x.y);
      const uint32_t bz = __float_as_uint(x.z), bw = __float_as_uint(x.w);
      odd = ((bx | by | bz | bw) & 0xFFFFu) != 0;
      *reinterpret_cast<uint2*>(copy + k0) = make_uint2(pack_hi(bx, by), pack_hi(bz, bw));
    }
    xs[xc][xr] = x.x, xs[xc + 1][xr] = x.y, xs[xc + 2][xr] = x.z, xs[xc + 3][xr] = x.w;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int e = tid + h * SIDE_THREADS;
      *reinterpret_cast<float4*>(&ws[e / 16][4 * (e % 16)]) = wv[h];
    }
    // A value that is not bf16 sends the call down the general path, which
    // reads neither L nor the copies: the block clears the flag and stops.
    if (__syncthreads_or(odd)) {
      if (tid == 0) *exact_flag = 0;
      return;
    }
    if (k0 + SIDE_K < k_len) load(k0 + SIDE_K, x, wv);
    float acc[4][2] = {};
#pragma unroll 8
    for (int kk = 0; kk < SIDE_K; ++kk) {
      const float4 xv = *reinterpret_cast<const float4*>(&xs[kk][4 * ty]);
      const float2 wf = *reinterpret_cast<const float2*>(&ws[kk][2 * tx]);
      const float xq[4] = {xv.x, xv.y, xv.z, xv.w};
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        acc[r][0] = fmaf(xq[r], wf.x, acc[r][0]);
        acc[r][1] = fmaf(xq[r], wf.y, acc[r][1]);
      }
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) total[r][0] += acc[r][0], total[r][1] += acc[r][1];
    __syncthreads();
  }
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int row = row0 + 4 * ty + r;
    if (row < rows)
      *reinterpret_cast<float2*>(dst + (long long)row * F + 2 * tx) =
          make_float2(static_cast<float>(total[r][0]), static_cast<float>(total[r][1]));
  }
}

// Each pair's route: 1 where its cancellation ratio
//   rho^2 = sum_f (rms_i L_a[i,f] + rms_j L_b[j,f])^2 / sum_f mean_{i,j} (L_a[i,f] - L_b[j,f])^2
// is at most ROUTE_RATIO^2, else 0 (the general path). One block a pair,
// fp64 sums in a fixed order, no atomics. Only calls whose flag is set read
// the routes.
__global__ void __launch_bounds__(ROUTE_THREADS)
split_weight_kernel_route(const float* __restrict__ la, const float* __restrict__ lb,
                          const int* __restrict__ exact_flag, int* __restrict__ route,
                          int width, int j_count, int a_batches, int b_batches) {
  if (*exact_flag == 0) return;
  constexpr int GROUPS = ROUTE_THREADS / F;
  __shared__ double part[4][GROUPS][F];
  __shared__ double terms[2][F];
  const int tid = threadIdx.x, f = tid % F, g = tid / F, pair = blockIdx.x;
  const float* la_p = la + (a_batches == 1 ? 0 : (long long)pair * width * F);
  const float* lb_p = lb + (b_batches == 1 ? 0 : (long long)pair * j_count * F);
  double s[4] = {};  // sum L_a, sum L_a^2, sum L_b, sum L_b^2
  for (int r = g; r < width; r += GROUPS) {
    const double x = la_p[(long long)r * F + f];
    s[0] += x, s[1] += x * x;
  }
  for (int r = g; r < j_count; r += GROUPS) {
    const double y = lb_p[(long long)r * F + f];
    s[2] += y, s[3] += y * y;
  }
#pragma unroll
  for (int q = 0; q < 4; ++q) part[q][g][f] = s[q];
  __syncthreads();
  if (tid < F) {
    double t[4] = {};
#pragma unroll
    for (int q = 0; q < 4; ++q)
      for (int h = 0; h < GROUPS; ++h) t[q] += part[q][h][tid];
    const double ea = t[0] / width, ea2 = t[1] / width;
    const double eb = t[2] / j_count, eb2 = t[3] / j_count;
    const double mag = sqrt(ea2) + sqrt(eb2);
    terms[0][tid] = mag * mag;
    terms[1][tid] = ea2 + eb2 - 2.0 * ea * eb;
  }
  __syncthreads();
  if (tid == 0) {
    double num = 0.0, den = 0.0;
    for (int h = 0; h < F; ++h) num += terms[0][h], den += terms[1][h];
    route[pair] = num <= ROUTE_RATIO * ROUTE_RATIO * den ? 1 : 0;
  }
}

// What a consumer thread of delta_conv1_kernel works with.
struct Consumer {
  uint32_t ring, full, empty;  // the weight ring and its mbarriers
  uint32_t b_full, b_empty;    // the right rows' buffers' mbarriers
  int stages, stride, channels, lane;
  const uint8_t* a_s;   // the block's left rows
  const uint8_t* b_s;   // the B_BUFS buffers of right rows
  int buf_bytes;        // one buffer
  int a_off[2], b_off[2];  // byte offsets of this thread's two rows
};

// Where a consumer is in the weight ring (stage s, its phase) and in the
// right rows' buffers (buffer nb, its phase).
struct Cursor {
  int s, phase, nb, b_phase;
};

__device__ __forceinline__ void release(const Consumer& c, int s) {
  if (c.lane == 0) mbar_arrive(c.empty + 8 * s);
}

// Adds a finished tap's sums to the fp32 totals of the taps before it.
__device__ __forceinline__ void add_tap(float (&total)[32], float (&sums)[32]) {
  fence_regs(sums);
#pragma unroll
  for (int n = 0; n < 32; ++n) total[n] += sums[n];
}

// A unit of a 64-channel chunk: the fragments formed and the wgmma issued
// together, two k16 steps on the exact path, one on the general path.
// WORDS: the packed bf16 pairs of one row a unit. Two fragment buffers: one
// unit's wgmma run while the next unit's fragments form.
template <bool EXACT>
struct Unit {
  static constexpr int STEPS = EXACT ? 2 : 1;
  static constexpr int COUNT = KC / 16 / STEPS;  // units a chunk
  static constexpr int WORDS = EXACT ? 4 : 6;    // (lo, hi) of 2 steps / of 3 pieces
};

// The A fragments of unit u of the chunk at channel c0 of the tap in b_k,
// for this thread's rows g and g + 8 of its warp's 16. Exact: min of the
// bf16 rows, channels c0 + 16 tq + 8u .. + 7: words 2 sl, 2 sl + 1 are the
// low and high k of step 2u + sl. General: |a - bb| of the fp32 rows,
// channels c0 + 16 tq + 4u .. + 3, split in three: words 2P, 2P + 1 the low
// and high k of piece P + 1.
template <bool EXACT>
__device__ __forceinline__ void form_unit(const Consumer& c, const uint8_t* b_k,
                                          uint32_t (&fr)[2][Unit<EXACT>::WORDS], int c0, int u) {
  const int tq = c.lane % 4;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if constexpr (EXACT) {
      const int byte = 2 * (c0 + 16 * tq + 8 * u);
      const uint4 x = *reinterpret_cast<const uint4*>(c.a_s + c.a_off[h] + byte);
      const uint4 y = *reinterpret_cast<const uint4*>(b_k + c.b_off[h] + byte);
      fr[h][0] = bf16x2_min(x.x, y.x), fr[h][1] = bf16x2_min(x.y, y.y);
      fr[h][2] = bf16x2_min(x.z, y.z), fr[h][3] = bf16x2_min(x.w, y.w);
    } else {
      const int byte = 4 * (c0 + 16 * tq + 4 * u);
      const float4 x = *reinterpret_cast<const float4*>(c.a_s + c.a_off[h] + byte);
      const float4 y = *reinterpret_cast<const float4*>(b_k + c.b_off[h] + byte);
      uint32_t p[4][3];
      split3(fabsf(x.x - y.x), p[0][0], p[0][1], p[0][2]);
      split3(fabsf(x.y - y.y), p[1][0], p[1][1], p[1][2]);
      split3(fabsf(x.z - y.z), p[2][0], p[2][1], p[2][2]);
      split3(fabsf(x.w - y.w), p[3][0], p[3][1], p[3][2]);
#pragma unroll
      for (int P = 0; P < 3; ++P) {
        fr[h][2 * P] = pack_hi(p[0][P], p[1][P]);
        fr[h][2 * P + 1] = pack_hi(p[2][P], p[3][P]);
      }
    }
  }
}

// The wgmma of unit u on the stage at w0 into one accumulator set; `first`
// resets it. Exact: A * W1, A * W2, A * W3. General: the six products of
// order <= 2, A1W1, A1W2, A2W1, A1W3, A2W2, A3W1.
template <bool EXACT>
__device__ __forceinline__ void issue_unit(uint32_t (&fr)[2][Unit<EXACT>::WORDS],
                                           float (&acc)[32], uint32_t w0, int u, bool first) {
  if constexpr (EXACT) {
#pragma unroll
    for (int sl = 0; sl < 2; ++sl)
#pragma unroll
      for (int p = 0; p < PIECES; ++p) {
        // k16 step 2u + sl: the B tile advances 32 bytes inside its 128-byte rows
        const uint64_t desc = kmajor_sw128_desc(w0 + p * PIECE_BYTES + 32 * (2 * u + sl));
        wgmma_bf16(acc, fr[0][2 * sl], fr[1][2 * sl], fr[0][2 * sl + 1], fr[1][2 * sl + 1],
                   desc, !first || sl > 0 || p > 0);
      }
  } else {
    constexpr int A_PIECE[6] = {0, 0, 1, 0, 1, 2}, W_PIECE[6] = {0, 1, 0, 2, 1, 0};
#pragma unroll
    for (int n = 0; n < 6; ++n) {
      const uint64_t desc = kmajor_sw128_desc(w0 + W_PIECE[n] * PIECE_BYTES + 32 * u);
      const int P = A_PIECE[n];
      wgmma_bf16(acc, fr[0][2 * P], fr[1][2 * P], fr[0][2 * P + 1], fr[1][2 * P + 1], desc,
                 !first || n > 0);
    }
  }
}

// Tap k through the wgmma into the accumulator set `cur` (its first wgmma
// resets it). Once this tap's first unit is in flight, the set `prev` (the
// tap before, done by then) is added to the totals: the tensor pipe never
// drains at a tap's end, and no accumulator in flight is read.
template <bool EXACT>
__device__ __forceinline__ void run_tap(const Consumer& c, int k, float (&cur)[32],
                                        float (&prev)[32], float (&total)[32],
                                        uint32_t (&fr)[2][2][Unit<EXACT>::WORDS], Cursor& r) {
  using U = Unit<EXACT>;
  mbar_wait(c.b_full + 8 * r.nb, r.b_phase);  // this tap's right rows
  const uint8_t* b_k = c.b_s + r.nb * c.buf_bytes;
  const int n_cc = c.channels / KC;
  for (int cc = 0; cc < n_cc; ++cc) {
    const uint32_t w0 = c.ring + r.s * STAGE_BYTES;
#pragma unroll
    for (int u = 0; u < U::COUNT; ++u) {
      form_unit<EXACT>(c, b_k, fr[u % 2], cc * KC, u);
      if (u == 0) mbar_wait(c.full + 8 * r.s, r.phase);
      wgmma_fence();
      issue_unit<EXACT>(fr[u % 2], cur, w0, u, cc == 0 && u == 0);
      wgmma_commit();
      // the unit before is done: its fragments, and at u = 0 the chunk
      // before and so its stage, and at cc = 0 the tap before, its sums
      // and the right rows its fragments were formed from
      wgmma_wait<1>();
      if (u == 0 && (k > 0 || cc > 0)) release(c, r.s == 0 ? c.stages - 1 : r.s - 1);
      if (u == 0 && cc == 0) {
        if (k > 0 && c.lane == 0) mbar_arrive(c.b_empty + 8 * ((r.nb + B_BUFS - 1) % B_BUFS));
        add_tap(total, prev);
      }
    }
    if (++r.s == c.stages) r.s = 0, r.phase ^= 1;
  }
  if (++r.nb == B_BUFS) r.nb = 0, r.b_phase ^= 1;
}

// The consumers' taps, the sets alternating; the block's sums are left in
// total. The taps add up in order, tap 0 first.
template <bool EXACT>
__device__ __forceinline__ void run_taps(const Consumer& c, float (&total)[32]) {
  using U = Unit<EXACT>;
  asm volatile("cp.async.wait_all;" ::: "memory");
  consumers_sync();  // every a row is in
  // -0 adds as nothing (-0 + x == x, -0 included), so tap 0 adds the set
  // acc[1] holds before any tap and the totals start from it
  float acc[2][32];
#pragma unroll
  for (int n = 0; n < 32; ++n) acc[0][n] = 0.f, acc[1][n] = -0.f, total[n] = -0.f;
  uint32_t fr[2][2][U::WORDS];
  Cursor r = {0, 0, 0, 0};
  for (int k = 0;; k += 2) {
    run_tap<EXACT>(c, k, acc[0], acc[1], total, fr, r);
    if (k + 1 == c.stride) {
      wgmma_wait<0>();
      add_tap(total, acc[0]);
      break;
    }
    run_tap<EXACT>(c, k + 1, acc[1], acc[0], total, fr, r);
    if (k + 2 == c.stride) {
      wgmma_wait<0>();
      add_tap(total, acc[1]);
      break;
    }
  }
}

__global__ void __launch_bounds__(THREADS, 1)
delta_conv1_kernel(const __grid_constant__ CUtensorMap wmap, const float* __restrict__ a,
                   const float* __restrict__ bb, const uint16_t* __restrict__ a16,
                   const uint16_t* __restrict__ b16, const float* __restrict__ la,
                   const float* __restrict__ lb, const int* __restrict__ exact_flag,
                   const int* __restrict__ route, unsigned long long* __restrict__ tally,
                   const float* __restrict__ bias,
                   float* __restrict__ out, int width, int channels, int stride, int j_count,
                   int rows_a, int stages_exact, int stages_general, long long a_bstride,
                   long long b_bstride) {
  extern __shared__ uint8_t smem_raw[];
  // The call's flag and the pair's route pick the path, and the path the
  // layout: the exact path's bf16 rows take half the room of fp32 rows,
  // which buys it more stages of the weight ring.
  const bool call_exact = *exact_flag != 0;
  const bool exact = call_exact && route[blockIdx.y] != 0;
  const int stages = exact ? stages_exact : stages_general;
  const int slot = (exact ? 2 : 4) * channels + ROW_PAD;  // a staged row
  // The exact path stages the pre-pass's bf16 copies, the general one fp32.
  const int row_bytes = slot - ROW_PAD;
  const int buf_bytes = j_count * slot;
  // [stages][W1 | W2 | W3 tiles], 1024-aligned for the swizzle; then
  // full[MAX_STAGES], empty[MAX_STAGES], b_full[B_BUFS], b_empty[B_BUFS]
  // mbarriers; a rows; B_BUFS buffers of the J right rows of a tap.
  uint8_t* base = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const uint32_t ring = smem_u32(base);
  const uint32_t full = ring + stages * STAGE_BYTES;
  const uint32_t empty = full + 8 * MAX_STAGES;
  const uint32_t b_full = empty + 8 * MAX_STAGES;
  const uint32_t b_empty = b_full + 8 * B_BUFS;
  uint8_t* a_s = base + stages * STAGE_BYTES + 16 * (MAX_STAGES + B_BUFS);
  uint8_t* b_s = a_s + rows_a * slot;

  const int tid = threadIdx.x;
  const int batch = blockIdx.y;

  if (tid == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, CONSUMERS / 32);  // one arrival per consumer warp
    }
    for (int nb = 0; nb < B_BUFS; ++nb) {
      mbar_init(b_full + 8 * nb, 1);
      mbar_init(b_empty + 8 * nb, CONSUMERS / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (tid >= CONSUMERS) {
    // Producer warpgroup: one thread keeps the weight ring full and, ahead
    // of each tap's first chunk, copies the tap's J right rows into the
    // next of the B_BUFS buffers.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(PRODUCER_REGS));
    if (tid == CONSUMERS) {
      const uint8_t* b_src =
          exact ? reinterpret_cast<const uint8_t*>(b16 + batch * b_bstride)
                : reinterpret_cast<const uint8_t*>(bb + batch * b_bstride);
      const int n_cc = channels / KC;
      int s = 0, phase = 0, nb = 0, b_phase = 0;
      for (int k = 0; k < stride; ++k) {
        mbar_wait(b_empty + 8 * nb, b_phase ^ 1);
        mbar_expect_tx(b_full + 8 * nb, j_count * row_bytes);
        const uint32_t dst = smem_u32(b_s) + nb * buf_bytes;
        for (int j = 0; j < j_count; ++j)
          bulk_load(dst + j * slot, b_src + (long long)(stride * j + k) * row_bytes, row_bytes,
                    b_full + 8 * nb);
        if (++nb == B_BUFS) nb = 0, b_phase ^= 1;
        for (int cc = 0; cc < n_cc; ++cc) {
          mbar_wait(empty + 8 * s, phase ^ 1);
          mbar_expect_tx(full + 8 * s, STAGE_BYTES);
          tma_load_2d(ring + s * STAGE_BYTES, &wmap, full + 8 * s, (k * n_cc + cc) * KC, 0);
          if (++s == stages) s = 0, phase ^= 1;
        }
      }
      // the call counts as exact when every pair took the exact path
      if (tally != nullptr && call_exact && blockIdx.x == 0 && blockIdx.y == 0) {
        int all = 1;
        for (int p = 0; p < (int)gridDim.y; ++p) all &= route[p];
        if (all) atomicAdd(tally, 1ull);
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(CONSUMER_REGS));
    const int m_total = width * j_count;
    const int m0 = blockIdx.x * BM;
    const int i_lo = m0 / j_count;
    const int wg = tid / 128, warp = (tid % 128) / 32, lane = tid % 32;
    const int g = lane / 4, tq = lane % 4;
    const int pitch = slot;
    const uint8_t* a_src =
        exact ? reinterpret_cast<const uint8_t*>(a16 + batch * a_bstride)
              : reinterpret_cast<const uint8_t*>(a + batch * a_bstride);

    Consumer c;
    c.ring = ring, c.full = full, c.empty = empty, c.b_full = b_full, c.b_empty = b_empty;
    c.stages = stages, c.stride = stride, c.channels = channels, c.lane = lane;
    c.a_s = a_s;
    c.b_s = b_s;
    c.buf_bytes = buf_bytes;
    // This thread's two rows: h = 0, 1 is row 16 warp + g + 8 h of the
    // warpgroup's m64 tile.
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = m0 + wg * 64 + warp * 16 + h * 8 + g;
      const bool ok = m < m_total;
      c.a_off[h] = ok ? (m / j_count - i_lo) * pitch : 0;
      c.b_off[h] = ok ? (m % j_count) * pitch : 0;
    }

    const int vecs = row_bytes / 16;  // 16-byte pieces per row
    for (int e = tid; e < rows_a * vecs; e += CONSUMERS) {
      const int r = e / vecs, v = e % vecs, i = i_lo + r;
      cp_async16(smem_u32(a_s + r * pitch + 16 * v),
                 a_src + (long long)(i < width ? i : 0) * row_bytes + 16 * v,
                 i < width ? 16 : 0);
    }

    float total[32];
    if (exact)
      run_taps<true>(c, total);
    else
      run_taps<false>(c, total);

    // Epilogue: total n holds row 16 warp + g + 8 ((n / 2) % 2), column
    // 8 (n / 4) + 2 tq + n % 2; out = L_a + L_b + bias - 2 total on the
    // exact path, total + bias on the general one.
    const float* la_b = la + (a_bstride ? (long long)batch * width * F : 0) + 2 * tq;
    const float* lb_b = lb + (b_bstride ? (long long)batch * j_count * F : 0) + 2 * tq;
    float bv[16];
#pragma unroll
    for (int n = 0; n < 16; ++n)
      bv[n] = bias != nullptr ? bias[8 * (n / 2) + 2 * tq + n % 2] : 0.f;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = m0 + wg * 64 + warp * 16 + h * 8 + g;
      if (m < m_total) {
        const float* lar = la_b + (long long)(m / j_count) * F;
        const float* lbr = lb_b + (long long)(m % j_count) * F;
        float* row = out + ((long long)batch * m_total + m) * F + 2 * tq;
#pragma unroll
        for (int nb = 0; nb < F / 8; ++nb) {
          const float s0 = total[4 * nb + 2 * h], s1 = total[4 * nb + 2 * h + 1];
          float2 v = make_float2(s0 + bv[2 * nb], s1 + bv[2 * nb + 1]);
          if (exact) {
            const float2 x = *reinterpret_cast<const float2*>(lar + 8 * nb);
            const float2 y = *reinterpret_cast<const float2*>(lbr + 8 * nb);
            v = make_float2((x.x + y.x + bv[2 * nb]) - 2.f * s0,
                            (x.y + y.y + bv[2 * nb + 1]) - 2.f * s1);
          }
          *reinterpret_cast<float2*>(row + 8 * nb) = v;
        }
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

size_t align256(size_t n) { return (n + 255) & ~size_t(255); }

// The scratch of one call, in order: Wt, Wsum, L_a, L_b, the bf16 copies of
// a and bb, the flag, the pairs' routes; each region 256-byte aligned.
// *_batches: 1 for a volume with batch stride 0, else the batch.
struct Scratch {
  size_t wt, wsum, la, lb, a16, b16, flag, route, total;
  Scratch(int batch, int width, int channels, int stride, int a_batches, int b_batches) {
    const size_t k_total = (size_t)stride * channels, j_count = width / stride;
    wt = 0;
    wsum = wt + align256(2 * PIECES * F * k_total);
    la = wsum + align256(4 * (size_t)channels * F);
    lb = la + align256(4 * (size_t)a_batches * width * F);
    a16 = lb + align256(4 * (size_t)b_batches * j_count * F);
    b16 = a16 + align256(2 * (size_t)a_batches * width * channels);
    flag = b16 + align256(2 * (size_t)b_batches * width * channels);
    route = flag + 256;
    total = route + align256(4 * (size_t)batch);
  }
};

bool takes(int batch, int width, int channels, int stride, int features) {
  return features == F && channels >= KC && channels % KC == 0 && stride >= 1 &&
         width >= stride && batch >= 1 && batch <= 65535;
}

}  // namespace

// Bytes of scratch delta_conv1_forward needs for these sizes (0 when the
// kernel does not take them). a_stride0 / b_stride0: the volume has batch
// stride 0 (one volume for the whole batch).
extern "C" long long delta_conv1_scratch_bytes(int batch, int width, int channels, int stride,
                                               int a_stride0, int b_stride0) {
  if (!takes(batch, width, channels, stride, F)) return 0;
  return (long long)Scratch(batch, width, channels, stride, a_stride0 ? 1 : batch,
                            b_stride0 ? 1 : batch)
      .total;
}

// C entry point, bound from Python with ctypes. `scratch` is caller-allocated,
// delta_conv1_scratch_bytes(...) bytes, 256-byte aligned. `tally` (may be
// null) is a device counter that gains 1 when every pair of the call takes
// the exact path.
// Launches the weight split, the pre-pass, the routes and K1 on `stream` and returns 0,
// a cudaError_t (cudaErrorInvalidValue when the sizes are outside what the
// kernel takes: features != 64, channels not a multiple of 64, width <
// stride, or more shared memory than a block can have), or the negated
// CUresult of a failed tensor-map encode. a_bstride / b_bstride: the
// volumes' batch strides in elements, 0 or width * channels.
extern "C" int delta_conv1_forward(const float* a, const float* bb, const float* w,
                                   const float* bias, void* scratch,
                                   unsigned long long* tally, float* out, int batch, int width,
                                   int channels, int stride, int features,
                                   long long a_bstride, long long b_bstride, void* stream) {
  if (!takes(batch, width, channels, stride, features)) return (int)cudaErrorInvalidValue;
  const int j_count = width / stride;
  const int k_total = stride * channels;
  const int rows_a = (BM - 1) / j_count + 2;
  const int a_batches = a_bstride ? batch : 1, b_batches = b_bstride ? batch : 1;
  // each path's layout (bf16 or fp32 rows) with as many weight stages as fit
  auto smem_for = [&](int stages, int elem) {
    return 1024 + (size_t)stages * STAGE_BYTES + 16 * (MAX_STAGES + B_BUFS) +
           (size_t)(rows_a + B_BUFS * j_count) * (elem * channels + ROW_PAD);
  };
  auto stages_for = [&](int elem) {
    int n = MAX_STAGES;
    while (n > 2 && smem_for(n, elem) > SMEM_LIMIT) --n;
    return n;
  };
  const int stages_exact = stages_for(2), stages_general = stages_for(4);
  const size_t smem = smem_for(stages_general, 4) > smem_for(stages_exact, 2)
                          ? smem_for(stages_general, 4)
                          : smem_for(stages_exact, 2);
  if (smem > SMEM_LIMIT) return (int)cudaErrorInvalidValue;
  // setmaxnreg.inc waits for registers the launch did not give: a build
  // whose kernel has fewer than LAUNCH_REGS a thread is refused
  static const bool regs_ok = [] {
    cudaFuncAttributes attr;
    return cudaFuncGetAttributes(&attr, delta_conv1_kernel) == cudaSuccess &&
           attr.numRegs >= LAUNCH_REGS;
  }();
  if (!regs_ok) return (int)cudaErrorInvalidDeviceFunction;

  const Scratch sc(batch, width, channels, stride, a_batches, b_batches);
  uint8_t* base = static_cast<uint8_t*>(scratch);
  uint16_t* wt = reinterpret_cast<uint16_t*>(base + sc.wt);
  float* wsum = reinterpret_cast<float*>(base + sc.wsum);
  float* la = reinterpret_cast<float*>(base + sc.la);
  float* lb = reinterpret_cast<float*>(base + sc.lb);
  uint16_t* a16 = reinterpret_cast<uint16_t*>(base + sc.a16);
  uint16_t* b16 = reinterpret_cast<uint16_t*>(base + sc.b16);
  int* flag = reinterpret_cast<int*>(base + sc.flag);
  int* route = reinterpret_cast<int*>(base + sc.route);

  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorSymbolNotFound;
  CUtensorMap wmap;
  const cuuint64_t dims[2] = {(cuuint64_t)k_total, (cuuint64_t)(PIECES * F)};
  const cuuint64_t strides[1] = {(cuuint64_t)k_total * 2};
  const cuuint32_t box[2] = {KC, PIECES * F};
  const cuuint32_t elem_strides[2] = {1, 1};
  const CUresult res = encode(&wmap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, wt, dims, strides,
                              box, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE,
                              CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                              CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (res != CUDA_SUCCESS) return -(int)res;

  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  split_weight_kernel<<<(F * k_total + 255) / 256, 256, 0, s>>>(w, wt, wsum, flag, channels,
                                                                 stride);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int side_blocks = (a_batches * width + SIDE_ROWS - 1) / SIDE_ROWS +
                          (b_batches * j_count + SIDE_ROWS - 1) / SIDE_ROWS;
  split_weight_kernel_sides<<<side_blocks, SIDE_THREADS, 0, s>>>(
      a, bb, w, wsum, la, lb, a16, b16, flag, width, channels, stride, j_count, a_batches,
      b_batches, a_bstride, b_bstride);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  split_weight_kernel_route<<<batch, ROUTE_THREADS, 0, s>>>(la, lb, flag, route, width, j_count,
                                                             a_batches, b_batches);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(delta_conv1_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((width * j_count + BM - 1) / BM, batch);
  delta_conv1_kernel<<<grid, THREADS, smem, s>>>(wmap, a, bb, a16, b16, la, lb, flag, route,
                                                 tally, bias, out, width, channels, stride,
                                                 j_count, rows_a, stages_exact, stages_general,
                                                 a_bstride, b_bstride);
  return (int)cudaGetLastError();
}
