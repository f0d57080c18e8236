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
// fp32 accumulators (which drop low bits on every wgmma) and per-tap fp32
// flushes. Against the output's norm the error grows with the pair's
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
// - delta_conv1_kernel, per block of BM = 256 consecutive (i, j) rows of one
//   pair: one producer thread feeds the weight pieces by TMA (one 2D tensor
//   map, 128-byte swizzle, 64 K x 3F per stage) into a ring of mbarriers;
//   setmaxnreg moves registers to two consumer warpgroups of 128 rows (two
//   m64 tiles) each, which issue wgmma.m64n64k16.f32.bf16.bf16 with A from
//   registers into one accumulator per tile. The path sets the layout: bf16
//   rows take half the room of fp32 ones, which leaves the exact path more
//   stages of the ring. The left rows a[i] of the tile are staged once; each
//   warpgroup stages the J right rows of each tap itself with cp.async into
//   a double buffer behind its own barrier, so the two drift apart and one
//   forms fragments while the other's wgmma run. Each chunk goes in units
//   (two k16 steps on the exact path, one on the general) whose fragments
//   are double-buffered: a unit's wgmma group stays in flight while the
//   next unit's fragments form (wgmma.wait_group 1). The tensor cores' fp32
//   accumulation drops low bits on every wgmma, so each tap sums in the
//   accumulators and the tap sums add up in fp32 on the CUDA cores. The
//   epilogue masks the rows past W'*J (the ragged last tile). Blocks share
//   no sum: no atomics, the same bits every run.
// What bounds it: at B = 256, W' = 360 the product kernel takes about 3.7 ms
// against the 1.65 ms floor (PERF.md). Without any fragment or wgmma
// (scripts/k1_probe.py, tma_only) the weight ring, the staged rows, the
// per-tap flushes and the epilogue alone take about 2.1 ms, and the wgmma
// add most of their own time on top: per tap the shared memory serves the
// B operand (192 KB a block), the fragments' rows and the flush, about what
// it can in the tensor cores' time. ptxas gives each thread 168 registers,
// which rules out a second accumulator set and m64n192 (192 accumulators
// for two tiles), and the kernel as it is spills a little (32 bytes of
// stack, 52 bytes stored and 100 loaded a thread; its cost is not measured
// apart). Weight multicast over clusters of blocks, persistent blocks and
// flushes every second tap were tried and were slower (PERF.md). An
// mbarrier wait that spins past SPIN_LIMIT traps instead of hanging.

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int F = 64;             // output features: the wgmma N
constexpr int BM = 256;           // output rows ((i, j) pairs) per block
constexpr int KC = 64;            // K chunk: 64 channels of one tap, one 128-byte bf16 row
constexpr int PIECES = 3;         // W = W1 + W2 + W3 in bf16
constexpr int MAX_STAGES = 6;     // weight ring depth at most (what shared memory leaves)
constexpr int CONSUMER_WGS = 2;   // consumer warpgroups, 128 rows each
constexpr int CONSUMERS = 128 * CONSUMER_WGS;
constexpr int THREADS = CONSUMERS + 128;  // + one producer warpgroup
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
  uint32_t ring, full, empty;
  int stages, stride, channels, j_count, lane;
  const uint8_t* a_s;   // the block's left rows
  const uint8_t* b_wg;  // this warpgroup's two buffers of right rows
  int buf_bytes;        // one buffer
  int a_off[4], b_off[4];  // byte offsets of this thread's four rows
  float4* master;       // fp32 sum of the finished taps
};

__device__ __forceinline__ void release(const Consumer& c, int q) {
  if (c.lane == 0) mbar_arrive(c.empty + 8 * (q % c.stages));
}

// Adds the accumulators (one tap's sums) to the fp32 sum of the taps before;
// after the last tap the total is left in acc.
__device__ __forceinline__ void flush_tap(const Consumer& c, float (&acc)[2][32], bool first,
                                          bool last) {
  fence_regs(acc[0]);
  fence_regs(acc[1]);
#pragma unroll
  for (int t = 0; t < 2; ++t)
#pragma unroll
    for (int v = 0; v < 8; ++v) {
      float4 m = make_float4(acc[t][4 * v], acc[t][4 * v + 1], acc[t][4 * v + 2],
                             acc[t][4 * v + 3]);
      if (!first) {
        const float4 prev = c.master[(8 * t + v) * CONSUMERS];
        m.x += prev.x, m.y += prev.y, m.z += prev.z, m.w += prev.w;
      }
      if (!last) {
        c.master[(8 * t + v) * CONSUMERS] = m;
      } else {
        acc[t][4 * v] = m.x, acc[t][4 * v + 1] = m.y;
        acc[t][4 * v + 2] = m.z, acc[t][4 * v + 3] = m.w;
      }
    }
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

// The A fragments of unit u of the chunk at channel c0 of the tap in b_k.
// Exact: min of the bf16 rows, channels c0 + 16 tq + 8u .. + 7: words
// 2 sl, 2 sl + 1 are the low and high k of step 2u + sl. General: |a - bb|
// of the fp32 rows, channels c0 + 16 tq + 4u .. + 3, split in three: words
// 2P, 2P + 1 the low and high k of piece P + 1.
template <bool EXACT>
__device__ __forceinline__ void form_unit(const Consumer& c, const uint8_t* b_k,
                                          uint32_t (&fr)[4][Unit<EXACT>::WORDS], int c0, int u) {
  const int tq = c.lane % 4;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    if constexpr (EXACT) {
      const int byte = 2 * (c0 + 16 * tq + 8 * u);
      const uint4 x = *reinterpret_cast<const uint4*>(c.a_s + c.a_off[r] + byte);
      const uint4 y = *reinterpret_cast<const uint4*>(b_k + c.b_off[r] + byte);
      fr[r][0] = bf16x2_min(x.x, y.x), fr[r][1] = bf16x2_min(x.y, y.y);
      fr[r][2] = bf16x2_min(x.z, y.z), fr[r][3] = bf16x2_min(x.w, y.w);
    } else {
      const int byte = 4 * (c0 + 16 * tq + 4 * u);
      const float4 x = *reinterpret_cast<const float4*>(c.a_s + c.a_off[r] + byte);
      const float4 y = *reinterpret_cast<const float4*>(b_k + c.b_off[r] + byte);
      uint32_t p[4][3];
      split3(fabsf(x.x - y.x), p[0][0], p[0][1], p[0][2]);
      split3(fabsf(x.y - y.y), p[1][0], p[1][1], p[1][2]);
      split3(fabsf(x.z - y.z), p[2][0], p[2][1], p[2][2]);
      split3(fabsf(x.w - y.w), p[3][0], p[3][1], p[3][2]);
#pragma unroll
      for (int P = 0; P < 3; ++P) {
        fr[r][2 * P] = pack_hi(p[0][P], p[1][P]);
        fr[r][2 * P + 1] = pack_hi(p[2][P], p[3][P]);
      }
    }
  }
}

// The wgmma of unit u on the stage at w0, both tiles; `first` resets the
// accumulators. Exact: A * W1, A * W2, A * W3. General: the six products
// of order <= 2, A1W1, A1W2, A2W1, A1W3, A2W2, A3W1.
template <bool EXACT>
__device__ __forceinline__ void issue_unit(uint32_t (&fr)[4][Unit<EXACT>::WORDS],
                                           float (&acc)[2][32], uint32_t w0, int u, bool first) {
  if constexpr (EXACT) {
#pragma unroll
    for (int sl = 0; sl < 2; ++sl)
#pragma unroll
      for (int p = 0; p < PIECES; ++p) {
        // k16 step 2u + sl: the B tile advances 32 bytes inside its 128-byte rows
        const uint64_t desc = kmajor_sw128_desc(w0 + p * PIECE_BYTES + 32 * (2 * u + sl));
#pragma unroll
        for (int t = 0; t < 2; ++t)
          wgmma_bf16(acc[t], fr[2 * t][2 * sl], fr[2 * t + 1][2 * sl], fr[2 * t][2 * sl + 1],
                     fr[2 * t + 1][2 * sl + 1], desc, !first || sl > 0 || p > 0);
      }
  } else {
    constexpr int A_PIECE[6] = {0, 0, 1, 0, 1, 2}, W_PIECE[6] = {0, 1, 0, 2, 1, 0};
#pragma unroll
    for (int n = 0; n < 6; ++n) {
      const uint64_t desc = kmajor_sw128_desc(w0 + W_PIECE[n] * PIECE_BYTES + 32 * u);
      const int P = A_PIECE[n];
#pragma unroll
      for (int t = 0; t < 2; ++t)
        wgmma_bf16(acc[t], fr[2 * t][2 * P], fr[2 * t + 1][2 * P], fr[2 * t][2 * P + 1],
                   fr[2 * t + 1][2 * P + 1], desc, !first || n > 0);
    }
  }
}

// The consumers' taps, each staged, through the wgmma and flushed; the
// block's sums are left in acc.
template <bool EXACT>
__device__ __forceinline__ void run_taps(const Consumer& c, float (&acc)[2][32],
                                         const uint8_t* b_src, int row_bytes) {
  using U = Unit<EXACT>;
  const int tid = threadIdx.x, wg = tid / 128;
  const int vecs = row_bytes / 16;
  auto stage_b = [&](int k) {  // the J rows of tap k
    const uint8_t* dst = c.b_wg + (k & 1) * c.buf_bytes;
    for (int e = tid % 128; e < c.j_count * vecs; e += 128) {
      const int j = e / vecs, v = e % vecs;
      cp_async16(smem_u32(dst + j * (row_bytes + ROW_PAD) + 16 * v),
                 b_src + (long long)(c.stride * j + k) * row_bytes + 16 * v, 16);
    }
    asm volatile("cp.async.commit_group;" ::: "memory");
  };
  stage_b(0);
  asm volatile("cp.async.wait_all;" ::: "memory");
  consumers_sync();  // every a row is in
  const int n_cc = c.channels / KC;
  uint32_t fr[2][4][U::WORDS];
  int q = 0;
  for (int k = 0; k < c.stride; ++k) {
    // this tap's rows have landed and every consumer is done with the last
    asm volatile("cp.async.wait_all;" ::: "memory");
    warpgroup_sync(wg);
    if (k + 1 < c.stride) stage_b(k + 1);
    const uint8_t* b_k = c.b_wg + (k & 1) * c.buf_bytes;
    for (int cc = 0; cc < n_cc; ++cc, ++q) {
      const int s = q % c.stages;
      const uint32_t w0 = c.ring + s * STAGE_BYTES;
#pragma unroll
      for (int u = 0; u < U::COUNT; ++u) {
        form_unit<EXACT>(c, b_k, fr[u % 2], cc * KC, u);
        if (u == 0) mbar_wait(c.full + 8 * s, (q / c.stages) & 1);
        wgmma_fence();
        issue_unit<EXACT>(fr[u % 2], acc, w0, u, cc == 0 && u == 0);
        wgmma_commit();
        // the unit before is done: its fragments, and at u = 0 the chunk
        // before and so its stage
        wgmma_wait<1>();
        if (u == 0 && cc > 0) release(c, q - 1);
      }
    }
    // each tap sums in the accumulators (reset by its first wgmma); the tap
    // sums add up here in fp32, kept in shared memory (see the note)
    wgmma_wait<0>();
    release(c, q - 1);
    flush_tap(c, acc, k == 0, k + 1 == c.stride);
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
  // [stages][W1 | W2 | W3 tiles], 1024-aligned for the swizzle; then
  // full[MAX_STAGES], empty[MAX_STAGES] mbarriers; a rows; per consumer
  // warpgroup two buffers of bb rows; the fp32 tap sums.
  uint8_t* base = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const uint32_t ring = smem_u32(base);
  const uint32_t full = ring + stages * STAGE_BYTES;
  const uint32_t empty = full + 8 * MAX_STAGES;
  uint8_t* a_s = base + stages * STAGE_BYTES + 16 * MAX_STAGES;
  uint8_t* b_s = a_s + rows_a * slot;

  const int tid = threadIdx.x;
  const int n_chunks = stride * (channels / KC);

  if (tid == 0) {
    for (int s = 0; s < stages; ++s) {
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
        const int s = q % stages;
        mbar_wait(empty + 8 * s, ((q / stages) & 1) ^ 1);
        mbar_expect_tx(full + 8 * s, STAGE_BYTES);
        tma_load_2d(ring + s * STAGE_BYTES, &wmap, full + 8 * s, q * KC, 0);
      }
      // the call counts as exact when every pair took the exact path
      if (tally != nullptr && call_exact && blockIdx.x == 0 && blockIdx.y == 0) {
        int all = 1;
        for (int p = 0; p < (int)gridDim.y; ++p) all &= route[p];
        if (all) atomicAdd(tally, 1ull);
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;");
    const int batch = blockIdx.y;
    const int m_total = width * j_count;
    const int m0 = blockIdx.x * BM;
    const int i_lo = m0 / j_count;
    const int wg = tid / 128, warp = (tid % 128) / 32, lane = tid % 32;
    const int g = lane / 4, tq = lane % 4;
    // the exact path stages the pre-pass's bf16 copies, the general one fp32
    const int row_bytes = slot - ROW_PAD, pitch = slot;
    const uint8_t* a_src =
        exact ? reinterpret_cast<const uint8_t*>(a16 + batch * a_bstride)
              : reinterpret_cast<const uint8_t*>(a + batch * a_bstride);
    const uint8_t* b_src =
        exact ? reinterpret_cast<const uint8_t*>(b16 + batch * b_bstride)
              : reinterpret_cast<const uint8_t*>(bb + batch * b_bstride);

    Consumer c;
    c.ring = ring, c.full = full, c.empty = empty;
    c.stages = stages, c.stride = stride, c.channels = channels, c.j_count = j_count;
    c.lane = lane;
    c.a_s = a_s;
    c.buf_bytes = j_count * pitch;
    c.b_wg = b_s + 2 * wg * j_count * slot;
    // fp32 sum of the finished taps, [8 float4 of tile 0, 8 of tile 1][thread]
    c.master = reinterpret_cast<float4*>(b_s + 2 * CONSUMER_WGS * j_count * slot) + tid;
    // This thread's four rows: slot r = 2 t + h is row 16 warp + g + 8 h of
    // the warpgroup's m64 tile t.
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int m = m0 + wg * 128 + (r / 2) * 64 + warp * 16 + (r % 2) * 8 + g;
      const bool ok = m < m_total;
      c.a_off[r] = ok ? (m / j_count - i_lo) * pitch : 0;
      c.b_off[r] = ok ? (m % j_count) * pitch : 0;
    }

    const int vecs = row_bytes / 16;  // 16-byte pieces per row
    for (int e = tid; e < rows_a * vecs; e += CONSUMERS) {
      const int r = e / vecs, v = e % vecs, i = i_lo + r;
      cp_async16(smem_u32(a_s + r * pitch + 16 * v),
                 a_src + (long long)(i < width ? i : 0) * row_bytes + 16 * v,
                 i < width ? 16 : 0);
    }

    // Each tap's first wgmma overwrites acc; it starts at zero so that no
    // wgmma operand is ever read uninitialized.
    float acc[2][32];
#pragma unroll
    for (int t = 0; t < 2; ++t)
#pragma unroll
      for (int n = 0; n < 32; ++n) acc[t][n] = 0.f;
    if (exact)
      run_taps<true>(c, acc, b_src, row_bytes);
    else
      run_taps<false>(c, acc, b_src, row_bytes);

    // Epilogue: accumulator n of tile t holds row 16 warp + g + 8 ((n / 2) % 2),
    // column 8 (n / 4) + 2 tq + n % 2; out = L_a + L_b + bias - 2 acc on the
    // exact path, acc + bias on the general one.
    const float* la_b = la + (a_bstride ? (long long)batch * width * F : 0) + 2 * tq;
    const float* lb_b = lb + (b_bstride ? (long long)batch * j_count * F : 0) + 2 * tq;
    float bv[16];
#pragma unroll
    for (int n = 0; n < 16; ++n)
      bv[n] = bias != nullptr ? bias[8 * (n / 2) + 2 * tq + n % 2] : 0.f;
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int t = r / 2, h = r % 2;
      const int m = m0 + wg * 128 + t * 64 + warp * 16 + h * 8 + g;
      if (m < m_total) {
        const float* lar = la_b + (long long)(m / j_count) * F;
        const float* lbr = lb_b + (long long)(m % j_count) * F;
        float* row = out + ((long long)batch * m_total + m) * F + 2 * tq;
#pragma unroll
        for (int nb = 0; nb < F / 8; ++nb) {
          const float s0 = acc[t][4 * nb + 2 * h], s1 = acc[t][4 * nb + 2 * h + 1];
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
    return 1024 + (size_t)stages * STAGE_BYTES + 16 * MAX_STAGES +
           (size_t)(rows_a + 2 * CONSUMER_WGS * j_count) * (elem * channels + ROW_PAD) +
           sizeof(float) * CONSUMERS * 2 * 32;  // the fp32 tap sums
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
