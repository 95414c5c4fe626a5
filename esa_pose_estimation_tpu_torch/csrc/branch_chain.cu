// Branch chain (k residual BasicBlocks, BN folded in) for Hopper (sm_90a).
//
// Replaces the TPU kernel esa_pose_estimation_tpu/experimental/branch_chain.py
// (branch_chain_pallas, body _kernel).  Plain PyTorch version:
// esa_pose_estimation_tpu_torch/experimental/branch_chain.py
// branch_chain_plain.
//
// Per residual block i, on NHWC x of type T (bf16 or f32), C = 32:
//   h = T(relu(conv3x3(x, w[i,0]) + b[i,0]))           f32 accumulation
//   x = T(relu(conv3x3(h, w[i,1]) + b[i,1] + f32(x)))
// with zero 'SAME' padding of x and of h, and the weights rounded to T, as
// the TPU kernel computes it.
//
// Bound: operations.  At (256, 64, 64, 32), k = 4 the chain is 154.6 GFLOP
// against 134 MB of input and output: 0.156 ms on the bf16 tensor cores.
//
// Both kernels launch once per residual block.  The TPU kernel keeps whole
// images in VMEM; one 64x64x32 bf16 image (256 KB) does not fit in a Hopper
// block's 227 KB, and one launch for the whole chain would need a halo of 2k
// pixels.  x crosses HBM once per residual block (~0.04 ms per block at
// batch 256).
//
// bf16: residual_block_tc, an implicit GEMM on the tensor cores
// (wgmma.mma_async m64n32k16, bf16 operands from shared memory, f32
// accumulators in registers).  Per conv, M = positions, N = 32 output
// channels, K = 9 taps x 32 input channels = 288: 18 wgmma per 64-position
// M tile.
//   * Output tiles are 16 x 32 pixels.  The block stages the x tile with a
//     halo of 2 as 20 rows of kWs = 36 positions, channel-group-major:
//     [4 groups of 8 channels][position][8 channels] bf16, so 8 consecutive
//     positions of one group form one 8 x 16 B core matrix of the
//     no-swizzle layout.
//   * Each conv runs over flattened positions q = row * kWs + col, so tap
//     (dy, dx) of the M tile at q0 reads positions q0 + dy * kWs + dx: every
//     shifted tap is one matrix descriptor at a 16 B offset, with no im2col
//     buffer.  Columns >= the valid width are computed and thrown away; a
//     zero slack after the staged rows keeps their reads inside shared
//     memory.
//   * h is computed over 18 rows x 36 (11 M tiles), zeroed outside the
//     image, biased, rectified and rounded to bf16 into the same layout;
//     the output over 16 x 36 (9 M tiles) takes the bias and the f32
//     residual from the staged x.  20 M tiles for 16 useful: 1.25x the
//     useful products.
//   * Both convs' weights (36 KB bf16) are loaded once per block; the grid
//     is persistent (one block of 4 warpgroups per SM walks the tiles, each
//     warpgroup taking 5 of a tile's 20 M tiles).  One thread stages the
//     next tile's x by TMA (4 boxes, one per channel group, zero-filled
//     outside the image) into the second x buffer while this tile
//     computes; an mbarrier per buffer says when it has landed.
//   What bounds it on an H100 (PERF.md): the wgmma themselves, at up to
//   about 39 cycles per m64n32k16 on the busiest SM (an upper estimate: the
//   time also holds the weight loads and the gaps between launches), over
//   the 24 that its 3 KB of shared-memory operand reads take at 128 B per
//   cycle.  A in registers
//   (ldmatrix, then wgmma with A from registers) was slower, and A starts
//   aligned to 128 B were no faster.  HBM traffic (4 x 134 MB) is a third
//   of the time and overlaps.
// f32: residual_block_f32, FMA on the CUDA cores (tensor cores would round
// the operands to TF32).  It stages 20x20 x tiles channel-major and one
// conv's weights as f32 [tap][cin][cout]; a warp owns 16 output channels
// and 32 consecutive pixels per register slot.

#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int kC = 32;  // channels (the only width supported)

// ---------------------------------------------------------------- f32 (FMA)

constexpr int kTile = 16;      // output tile side
constexpr int kHT = kTile + 2; // h tile side (halo 1)
constexpr int kXT = kTile + 4; // x tile side (halo 2)
constexpr int kThreads = 256;  // 8 warps: 2 cout halves x 4 pixel slots
constexpr int kCoPerWarp = 16;

// Plane stride (floats) of npix pixels, odd so that the 32 channels of one
// pixel sit in 32 banks.
__host__ __device__ constexpr int plane_stride(int npix) { return npix | 1; }

// acc[j][c] += sum_{tap, ci} in[ci][pix_j + tap offset] * w[tap][ci][co0 + c]
// for the PP pixels of this thread.  in_w is the input tile's row width.
template <int PP>
__device__ __forceinline__ void conv_tile(const float* __restrict__ in_s,
                                          int in_stride, int in_w,
                                          const float* __restrict__ w_s,
                                          const int (&base)[PP], int co0,
                                          float (&acc)[PP][kCoPerWarp]) {
#pragma unroll
  for (int j = 0; j < PP; ++j)
#pragma unroll
    for (int c = 0; c < kCoPerWarp; ++c) acc[j][c] = 0.0f;
#pragma unroll 1
  for (int ci = 0; ci < kC; ++ci) {
    const float* plane = in_s + ci * in_stride;
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const int off = (tap / 3) * in_w + (tap % 3);
      float v[PP];
#pragma unroll
      for (int j = 0; j < PP; ++j) v[j] = plane[base[j] + off];
      const float4* wv = reinterpret_cast<const float4*>(
          w_s + (tap * kC + ci) * kC + co0);
#pragma unroll
      for (int q = 0; q < kCoPerWarp / 4; ++q) {
        const float4 w4 = wv[q];
#pragma unroll
        for (int j = 0; j < PP; ++j) {
          acc[j][4 * q + 0] = fmaf(v[j], w4.x, acc[j][4 * q + 0]);
          acc[j][4 * q + 1] = fmaf(v[j], w4.y, acc[j][4 * q + 1]);
          acc[j][4 * q + 2] = fmaf(v[j], w4.z, acc[j][4 * q + 2]);
          acc[j][4 * q + 3] = fmaf(v[j], w4.w, acc[j][4 * q + 3]);
        }
      }
    }
  }
}

__device__ __forceinline__ void load_weights(const float* __restrict__ w,
                                             float* __restrict__ w_s) {
  const float4* src = reinterpret_cast<const float4*>(w);
  float4* dst = reinterpret_cast<float4*>(w_s);
  for (int i = threadIdx.x; i < 9 * kC * kC / 4; i += kThreads) dst[i] = src[i];
}

// One residual block on one 16x16 tile of one image.
// w: (2, 3, 3, C, C) f32 HWIO; b: (2, C) f32.
__global__ void __launch_bounds__(kThreads, 2)
residual_block_f32(const float* __restrict__ x, float* __restrict__ out,
                   const float* __restrict__ w, const float* __restrict__ b,
                   int H, int W) {
  constexpr int kSX = plane_stride(kXT * kXT);
  constexpr int kSH = plane_stride(kHT * kHT);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* w_s = reinterpret_cast<float*>(smem_raw);               // 9*C*C
  float* x_s = w_s + 9 * kC * kC;                                // C*kSX
  float* h_s = x_s + kC * kSX;                                   // C*kSH

  const int tiles_x = (W + kTile - 1) / kTile;
  const int ty0 = (blockIdx.x / tiles_x) * kTile;
  const int tx0 = (blockIdx.x % tiles_x) * kTile;
  const long long img = static_cast<long long>(blockIdx.y) * H * W;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int co0 = (warp & 1) * kCoPerWarp;
  const int slot = warp >> 1;  // 0..3

  load_weights(w, w_s);
  // x tile with halo 2, zero outside the image; consecutive threads read
  // consecutive channels of one pixel (coalesced NHWC reads)
  for (int i = threadIdx.x; i < kXT * kXT * kC; i += kThreads) {
    const int c = i % kC;
    const int p = i / kC;
    const int yy = ty0 - 2 + p / kXT;
    const int xx = tx0 - 2 + p % kXT;
    float v = 0.0f;
    if (yy >= 0 && yy < H && xx >= 0 && xx < W)
      v = x[(img + static_cast<long long>(yy) * W + xx) * kC + c];
    x_s[c * kSX + p] = v;
  }
  __syncthreads();

  // conv 1 over the 18x18 h tile: 324 pixels in 3 slots of 128
  {
    constexpr int PP = 3;
    int base[PP];
    int hp[PP];
#pragma unroll
    for (int j = 0; j < PP; ++j) {
      hp[j] = (slot + 4 * j) * 32 + lane;
      const int p = hp[j] < kHT * kHT ? hp[j] : 0;
      base[j] = (p / kHT) * kXT + p % kHT;
    }
    float acc[PP][kCoPerWarp];
    conv_tile<PP>(x_s, kSX, kXT, w_s, base, co0, acc);
#pragma unroll
    for (int j = 0; j < PP; ++j) {
      if (hp[j] >= kHT * kHT) continue;
      const int yy = ty0 - 1 + hp[j] / kHT;
      const int xx = tx0 - 1 + hp[j] % kHT;
      const bool inside = yy >= 0 && yy < H && xx >= 0 && xx < W;
#pragma unroll
      for (int c = 0; c < kCoPerWarp; ++c) {
        // h is zero outside the image: the second conv pads h with zeros
        h_s[(co0 + c) * kSH + hp[j]] =
            inside ? fmaxf(acc[j][c] + b[co0 + c], 0.0f) : 0.0f;
      }
    }
  }
  __syncthreads();  // h complete, w[0] no longer read
  load_weights(w + 9 * kC * kC, w_s);
  __syncthreads();

  // conv 2 over the 16x16 output tile: 256 pixels in 2 slots of 128
  {
    constexpr int PP = 2;
    int base[PP];
    int op[PP];
#pragma unroll
    for (int j = 0; j < PP; ++j) {
      op[j] = (slot + 4 * j) * 32 + lane;
      base[j] = (op[j] / kTile) * kHT + op[j] % kTile;
    }
    float acc[PP][kCoPerWarp];
    conv_tile<PP>(h_s, kSH, kHT, w_s, base, co0, acc);
#pragma unroll
    for (int j = 0; j < PP; ++j) {
      const int oy = op[j] / kTile;
      const int ox = op[j] % kTile;
      const int yy = ty0 + oy;
      const int xx = tx0 + ox;
      if (yy >= H || xx >= W) continue;
      const int xp = (oy + 2) * kXT + ox + 2;
      float* dst = out + (img + static_cast<long long>(yy) * W + xx) * kC + co0;
#pragma unroll
      for (int c = 0; c < kCoPerWarp; ++c)
        dst[c] = fmaxf(acc[j][c] + b[kC + co0 + c] + x_s[(co0 + c) * kSX + xp],
                       0.0f);
    }
  }
}

// ------------------------------------------------------ bf16 (tensor cores)

constexpr int kTileH = 16;                  // output tile rows
constexpr int kTileW = 32;                  // output tile columns
constexpr int kWs = kTileW + 4;             // staged row width (halo 2 + 2)
constexpr int kXRows = kTileH + 4;          // staged x rows (halo 2 + 2)
constexpr int kM = 64;                      // positions per wgmma (M)
constexpr int kHMTiles = ((kTileH + 2) * kWs + kM - 1) / kM;  // 11
constexpr int kOMTiles = (kTileH * kWs + kM - 1) / kM;        // 9
constexpr int kHPos = kHMTiles * kM;                          // 704
// staged x positions: the rows, then zero slack up to the last read
constexpr int kXPos = (kHPos + 2 * kWs + 2 + 15) / 16 * 16;   // 784
constexpr int kGroups = kC / 8;             // 16 B channel groups
constexpr int kXPlane = kXPos * 16;         // bytes of one group of x
constexpr int kHPlane = kHPos * 16;         // bytes of one group of h
constexpr int kWTap = kGroups * kC * 16;    // bytes of one tap's B operand
constexpr int kWConv = 9 * kWTap;           // bytes of one conv's weights
constexpr int kWGs = 4;                     // warpgroups, all issuing wgmma
constexpr int kTcThreads = 128 * kWGs;
constexpr int kSmemX = 2 * kWConv;          // weights of both convs first
constexpr int kSmemH = kSmemX + 2 * kGroups * kXPlane;   // 2 x buffers
constexpr int kSmemBar = kSmemH + kGroups * kHPlane;     // 2 mbarriers
constexpr int kSmemTc = kSmemBar + 16;                   // 182,288 bytes
static_assert(kOMTiles * kM - 1 + 2 * kWs + 2 < kHPos,
              "conv 2 reads beyond the computed h positions");
static_assert(kHPos - 1 + 2 * kWs + 2 < kXPos,
              "conv 1 reads beyond the staged x positions");
static_assert(kXRows * kWs <= kXPos, "staged rows exceed the x buffer");
static_assert(kSmemTc <= 232448, "over a block's shared memory");

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 B global -> shared copy
__device__ __forceinline__ void cp_async_16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}
// makes this thread's generic-proxy shared writes visible to wgmma reads
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void st_shared_u32(uint32_t addr, uint32_t v) {
  asm volatile("st.shared.u32 [%0], %1;\n" ::"r"(addr), "r"(v) : "memory");
}
__device__ __forceinline__ void st_shared_zero16(uint32_t addr) {
  asm volatile("st.shared.v4.u32 [%0], {%1, %1, %1, %1};\n" ::"r"(addr),
               "r"(0)
               : "memory");
}
__device__ __forceinline__ uint32_t ld_shared_u32(uint32_t addr) {
  uint32_t v;
  asm volatile("ld.shared.u32 %0, [%1];\n" : "=r"(v) : "r"(addr) : "memory");
  return v;
}
__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // round to nearest even
  return *reinterpret_cast<uint32_t*>(&v);
}
__device__ __forceinline__ float2 unpack_bf16x2(uint32_t u) {
  return __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&u));
}

// wgmma matrix descriptor of a no-swizzle ("interleave") K-major operand in
// shared memory: 8 x 16 B core matrices, each 128 contiguous bytes.
//   bits  0-13  start address >> 4
//   bits 16-29  leading byte offset >> 4: between core matrices along K
//   bits 32-45  stride byte offset >> 4: between core matrices along M (N)
//   bits 49-51  base offset 0; bits 62-63 layout 0 = no swizzle
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4)
         | static_cast<uint64_t>((lbo & 0x3FFFF) >> 4) << 16
         | static_cast<uint64_t>((sbo & 0x3FFFF) >> 4) << 32;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// keeps the compiler from moving accumulator reads across the wait
__device__ __forceinline__ void fence_regs(float (&d)[16]) {
#pragma unroll
  for (int i = 0; i < 16; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (+)= A @ B, A 64 x 16 and B 16 x 32 bf16 from shared memory.  Transpose
// bits 0 and 0: both operands K-major (A rows are positions with their 16
// input channels contiguous in two 8-channel core matrices; B rows are
// output channels with their input channels contiguous).
__device__ __forceinline__ void wgmma_m64n32k16(float (&d)[16], uint64_t da,
                                                uint64_t db, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "l"(da), "l"(db), "r"(accumulate));
}

// One conv on one M tile: acc[64 positions from a0][32 couts] =
// sum over taps and input channels.  a0 is the M tile's first position in a
// [group][position][8] buffer whose groups lie kPlane bytes apart; w0 is the
// conv's packed weights [tap][group][cout][8].
template <int kPlane>
__device__ __forceinline__ void conv_mtile(float (&acc)[16], uint32_t a0,
                                           uint32_t w0) {
  const uint64_t da0 = smem_desc(a0, kPlane, 128);
  const uint64_t db0 = smem_desc(w0, kC * 16, 128);
#pragma unroll
  for (int i = 0; i < 16; ++i) acc[i] = 0.0f;
  fence_regs(acc);
  wgmma_fence();
#pragma unroll
  for (int tap = 0; tap < 9; ++tap) {
#pragma unroll
    for (int kh = 0; kh < 2; ++kh) {
      // K step (tap, kh): input channel groups 2 kh and 2 kh + 1
      const uint32_t a_off = ((tap / 3) * kWs + tap % 3) * 16 + 2 * kh * kPlane;
      const uint32_t b_off = tap * kWTap + 2 * kh * kC * 16;
      wgmma_m64n32k16(acc, da0 + (a_off >> 4), db0 + (b_off >> 4),
                      tap + kh > 0);
    }
  }
  wgmma_commit();
  wgmma_wait_all();
  fence_regs(acc);
}

struct TileOrigin {
  int img, ty0, tx0;
};
__device__ __forceinline__ TileOrigin tile_origin(int tile, int per_img,
                                                  int tiles_x) {
  const int t = tile % per_img;
  return {tile / per_img, (t / tiles_x) * kTileH, (t % tiles_x) * kTileW};
}

__device__ __forceinline__ void mbar_init(uint32_t bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bar)
               : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done)
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
}

// TMA of one tile's x with halo 2 into [group][position][8], completing on
// bar.  The tensor map views x as (B, H, W, 4 groups, 8 channels); one box
// of (1, 20, 36, 1, 8) per group lands as 720 consecutive 16 B positions,
// and the hardware fills the box's part outside the image with zeros.
__device__ __forceinline__ void stage_x(const CUtensorMap* tmap, uint32_t xs,
                                        uint32_t bar, TileOrigin o) {
  mbar_expect_tx(bar, kGroups * kXRows * kWs * 16);
#pragma unroll
  for (int g = 0; g < kGroups; ++g)
    asm volatile(
        "cp.async.bulk.tensor.5d.shared::cluster.global.tile"
        ".mbarrier::complete_tx::bytes [%0], [%1, {%2, %3, %4, %5, %6}], "
        "[%7];\n" ::"r"(xs + g * kXPlane),
        "l"(reinterpret_cast<uint64_t>(tmap)), "r"(0), "r"(g),
        "r"(o.tx0 - 2), "r"(o.ty0 - 2), "r"(o.img), "r"(bar)
        : "memory");
}

// One residual block, persistent over the 16 x 32 tiles of the batch.
// tmap: x (see stage_x); wp: both convs' weights, packed
// [conv][tap][group][cout][8] bf16; b: (2, C) f32.  Thread (warpgroup wg,
// warp w, lane l) holds accumulator rows w * 16 + l / 4 (+ 8) and columns
// n * 8 + (l % 4) * 2 (+ 1), n < 4.
__global__ void __launch_bounds__(kTcThreads, 1)
residual_block_tc(const __grid_constant__ CUtensorMap tmap,
                  __nv_bfloat16* __restrict__ out,
                  const __nv_bfloat16* __restrict__ wp,
                  const float* __restrict__ b, int n_img, int H, int W) {
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t s0 = smem_u32(smem);
  const uint32_t hs = s0 + kSmemH;
  const uint32_t bars = s0 + kSmemBar;  // one mbarrier per x buffer
  const int tiles_x = (W + kTileW - 1) / kTileW;
  const int per_img = ((H + kTileH - 1) / kTileH) * tiles_x;
  const int n_tiles = n_img * per_img;
  int tile = blockIdx.x;
  if (tile >= n_tiles) return;

  if (threadIdx.x == 0) {
    mbar_init(bars);
    mbar_init(bars + 8);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    stage_x(&tmap, s0 + kSmemX, bars, tile_origin(tile, per_img, tiles_x));
  }
  for (int i = threadIdx.x; i < 2 * kWConv / 16; i += kTcThreads)
    cp_async_16(s0 + i * 16, wp + i * 8);
  // the slack after the staged rows of both x buffers stays zero
  constexpr int kSlack = kXPos - kXRows * kWs;
  for (int i = threadIdx.x; i < 2 * kGroups * kSlack; i += kTcThreads)
    st_shared_zero16(s0 + kSmemX + (i / kSlack) * kXPlane
                     + (kXRows * kWs + i % kSlack) * 16);
  cp_async_commit();
  cp_async_wait_all();
  fence_proxy_async();
  __syncthreads();  // weights, slack and the barriers' init visible

  // warpgroup wg takes the M tiles g = wg (mod kWGs) of the tile's 20,
  // numbered conv 1 first (g = m), then conv 2 (g = kHMTiles + m)
  const int wg = threadIdx.x >> 7;
  const int m2 = ((wg - kHMTiles) % kWGs + kWGs) % kWGs;
  const int row0 = ((threadIdx.x >> 5) & 3) * 16 + ((threadIdx.x & 31) >> 2);
  const int quad = threadIdx.x & 3;
  float b1[8], b2[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    b1[i] = b[(i >> 1) * 8 + quad * 2 + (i & 1)];
    b2[i] = b[kC + (i >> 1) * 8 + quad * 2 + (i & 1)];
  }

  for (int it = 0; tile < n_tiles; ++it, tile += gridDim.x) {
    const int buf = it & 1;
    const uint32_t xs = s0 + kSmemX + buf * kGroups * kXPlane;
    mbar_wait(bars + 8 * buf, (it >> 1) & 1);  // x[buf] landed
    __syncthreads();  // and every thread is done with x[buf ^ 1] and h
    if (threadIdx.x == 0 && tile + static_cast<int>(gridDim.x) < n_tiles)
      stage_x(&tmap, s0 + kSmemX + (buf ^ 1) * kGroups * kXPlane,
              bars + 8 * (buf ^ 1),
              tile_origin(tile + gridDim.x, per_img, tiles_x));
    const TileOrigin o = tile_origin(tile, per_img, tiles_x);

    // conv 1: h over 18 x 36 positions, biased, rectified, rounded to bf16
#pragma unroll 1
    for (int m = wg; m < kHMTiles; m += kWGs) {
      float acc[16];
      conv_mtile<kXPlane>(acc, xs + m * kM * 16, s0);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int q = m * kM + row0 + 8 * j;
        const int yy = o.ty0 - 1 + q / kWs;
        const int xx = o.tx0 - 1 + q % kWs;
        // h is zero outside the image: the second conv pads h with zeros
        const bool inside = yy >= 0 && yy < H && xx >= 0 && xx < W;
#pragma unroll
        for (int n = 0; n < 4; ++n) {
          const float v0 = fmaxf(acc[4 * n + 2 * j] + b1[2 * n], 0.0f);
          const float v1 = fmaxf(acc[4 * n + 2 * j + 1] + b1[2 * n + 1], 0.0f);
          st_shared_u32(hs + n * kHPlane + q * 16 + quad * 4,
                        inside ? pack_bf16x2(v0, v1) : 0u);
        }
      }
    }
    fence_proxy_async();
    __syncthreads();  // h complete

    // conv 2: the output over 16 x 36 positions, plus bias and residual
#pragma unroll 1
    for (int m = m2; m < kOMTiles; m += kWGs) {
      float acc[16];
      conv_mtile<kHPlane>(acc, hs + m * kM * 16, s0 + kWConv);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int q = m * kM + row0 + 8 * j;
        const int orow = q / kWs;
        const int ocol = q % kWs;
        const int yy = o.ty0 + orow;
        const int xx = o.tx0 + ocol;
        const bool valid = ocol < kTileW && yy < H && xx < W;
        const uint32_t res = xs + ((orow + 2) * kWs + ocol + 2) * 16 + quad * 4;
        uint32_t* dst = reinterpret_cast<uint32_t*>(
            out + ((static_cast<long long>(o.img) * H + yy) * W + xx) * kC
            + quad * 2);
#pragma unroll
        for (int n = 0; n < 4; ++n) {
          const float2 r = unpack_bf16x2(ld_shared_u32(res + n * kXPlane));
          const float v0 = fmaxf(acc[4 * n + 2 * j] + b2[2 * n] + r.x, 0.0f);
          const float v1 =
              fmaxf(acc[4 * n + 2 * j + 1] + b2[2 * n + 1] + r.y, 0.0f);
          if (valid) dst[n * 4] = pack_bf16x2(v0, v1);
        }
      }
    }
  }
}

// The tensor map of stage_x over the bf16 (B, H, W, 32) tensor at x.
CUresult encode_x_map(CUtensorMap* map, const void* x, long long B,
                      long long H, long long W) {
  static PFN_cuTensorMapEncodeTiled_v12000 encode = nullptr;
  if (encode == nullptr) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn,
                                cudaEnableDefault, &found) != cudaSuccess
        || found != cudaDriverEntryPointSuccess)
      return CUDA_ERROR_NOT_FOUND;
    encode = reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(fn);
  }
  // innermost first: 8 channels, 4 groups, W, H, B; strides in bytes
  const cuuint64_t dims[5] = {8, kGroups, static_cast<cuuint64_t>(W),
                              static_cast<cuuint64_t>(H),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[4] = {16, kC * 2, static_cast<cuuint64_t>(W) * kC * 2,
                                 static_cast<cuuint64_t>(H * W) * kC * 2};
  const cuuint32_t box[5] = {8, 1, kWs, kXRows, 1};
  const cuuint32_t elem_strides[5] = {1, 1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 5,
                const_cast<void*>(x), dims, strides, box, elem_strides,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);  // zeros outside
}

constexpr int kErrDevice = -4;   // device index past kMaxDevices
constexpr int kMaxDevices = 64;  // cards of one process with host state

// Host state of one card, kept per device (the runtime's current device,
// which the wrapper sets to the input's card): its SM count, read once,
// and each kernel's shared-memory attribute, which applies to the current
// device only, set once.
struct DeviceState {
  int n_sm;
  bool f32_smem, tc_smem;
};
DeviceState g_devices[kMaxDevices];

// The current device's state, its SM count read at first use.
int device_state(DeviceState** out) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev < 0 || dev >= kMaxDevices) return kErrDevice;
  DeviceState* d = &g_devices[dev];
  if (d->n_sm == 0) {
    err = cudaDeviceGetAttribute(&d->n_sm, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  *out = d;
  return 0;
}

// ping-pong so the last block writes `out`: block i reads src, writes dst
template <typename T>
T* block_dst(long long i, long long k, T* out, T* scratch) {
  return ((k - 1 - i) % 2 == 0) ? out : scratch;
}

}  // namespace

// x, out, scratch: (B, H, W, 32) contiguous f32; w: (k, 2, 3, 3, 32, 32) f32
// HWIO; b: (k, 2, 32) f32.  scratch may be null when k == 1.  Returns
// cudaGetLastError() of the launches (0 on success), or kErrDevice.
extern "C" int branch_chain_f32_launch(const float* x, float* out,
                                       float* scratch, const float* w,
                                       const float* b, long long B,
                                       long long H, long long W, long long k,
                                       void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  constexpr int kSX = plane_stride(kXT * kXT);
  constexpr int kSH = plane_stride(kHT * kHT);
  const size_t smem = (9 * kC * kC + static_cast<size_t>(kC) * (kSX + kSH))
                      * sizeof(float);
  DeviceState* d = nullptr;
  const int state_err = device_state(&d);
  if (state_err != 0) return state_err;
  cudaError_t err;
  if (!d->f32_smem) {
    err = cudaFuncSetAttribute(residual_block_f32,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    d->f32_smem = true;
  }
  const long long tiles = ((H + kTile - 1) / kTile) * ((W + kTile - 1) / kTile);
  const dim3 grid(static_cast<unsigned>(tiles), static_cast<unsigned>(B));
  const float* src = x;
  for (long long i = 0; i < k; ++i) {
    float* dst = block_dst(i, k, out, scratch);
    residual_block_f32<<<grid, kThreads, smem, st>>>(
        src, dst, w + i * 2 * 9 * kC * kC, b + i * 2 * kC,
        static_cast<int>(H), static_cast<int>(W));
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    src = dst;
  }
  return 0;
}

// x, out, scratch: (B, H, W, 32) contiguous bf16, 16-byte aligned;
// wp: (k, 2, 9, 4, 32, 8) bf16, the weights packed by the wrapper
// (pack_weights: wp[i, j, t, g, co, c] = w[i, j, t / 3, t % 3, 8 g + c, co]);
// b: (k, 2, 32) f32.  scratch may be null when k == 1.  Returns
// cudaGetLastError() of the launches (0 on success), kErrDevice, or the
// CUresult of a failed tensor-map encoding plus 10000.
extern "C" int branch_chain_bf16_launch(const void* x, void* out,
                                        void* scratch, const void* wp,
                                        const float* b, long long B,
                                        long long H, long long W,
                                        long long k, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long tiles = B * ((H + kTileH - 1) / kTileH)
                          * ((W + kTileW - 1) / kTileW);
  if (tiles > INT_MAX || H > INT_MAX || W > INT_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  DeviceState* d = nullptr;
  const int state_err = device_state(&d);
  if (state_err != 0) return state_err;
  cudaError_t err;
  if (!d->tc_smem) {
    err = cudaFuncSetAttribute(residual_block_tc,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kSmemTc);
    if (err != cudaSuccess) return static_cast<int>(err);
    d->tc_smem = true;
  }
  const int sms = d->n_sm;
  const unsigned grid =
      static_cast<unsigned>(tiles < sms ? tiles : static_cast<long long>(sms));
  const auto* wq = static_cast<const __nv_bfloat16*>(wp);
  const void* src = x;
  for (long long i = 0; i < k; ++i) {
    __nv_bfloat16* dst = block_dst(i, k, static_cast<__nv_bfloat16*>(out),
                                   static_cast<__nv_bfloat16*>(scratch));
    CUtensorMap map;
    const CUresult r = encode_x_map(&map, src, B, H, W);
    if (r != CUDA_SUCCESS) return 10000 + static_cast<int>(r);
    residual_block_tc<<<grid, kTcThreads, kSmemTc, st>>>(
        map, dst, wq + i * 2 * 9 * kC * kC, b + i * 2 * kC,
        static_cast<int>(B), static_cast<int>(H), static_cast<int>(W));
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    src = dst;
  }
  return 0;
}
