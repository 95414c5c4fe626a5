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
// with zero 'SAME' padding of x and of h, as the TPU kernel computes it.
//
// Bound: operations.  At (256, 64, 64, 32), k = 4 the chain is 154.6 GFLOP
// against 134 MB of input and output; on the bf16 tensor cores that is
// 0.156 ms, on f32 FMA 2.31 ms.  This first kernel uses f32 FMA on the CUDA
// cores (tensor cores are later work).
//
// Tiling.  The TPU kernel keeps whole images in VMEM; one 64x64x32 bf16 image
// (256 KB) does not fit in a Hopper block's 227 KB.  So the kernel runs one
// launch per residual block, each block of threads owning a 16x16 output tile
// of one image: it stages the 20x20 x tile (halo 2) in shared memory, computes
// h on the 18x18 tile (halo 1; zero outside the image), rounds h to T in
// shared memory, then computes the 16x16 output and adds the residual from
// the staged x.  x crosses HBM once per residual block (k times per chain);
// at C = 32 that costs ~0.04 ms per block at batch 256, far below the FMA
// time.  The alternative, one launch for the whole chain with a halo of 2k
// pixels, would recompute 1.5-2x the convolutions on CUDA cores.
//
// Shared memory holds activations channel-major (one plane per channel,
// plane stride padded so the transposing stores from NHWC do not collide on
// banks) and one conv's weights as f32 [tap][cin][cout].  A warp owns 16
// output channels and 32 consecutive pixels per register slot, so the
// weight loads are warp-wide broadcasts (float4) and the activation loads
// are consecutive words.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kC = 32;         // channels (the only width supported)
constexpr int kTile = 16;      // output tile side
constexpr int kHT = kTile + 2; // h tile side (halo 1)
constexpr int kXT = kTile + 4; // x tile side (halo 2)
constexpr int kThreads = 256;  // 8 warps: 2 cout halves x 4 pixel slots
constexpr int kCoPerWarp = 16;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(
    float v) {
  return __float2bfloat16(v);  // round to nearest even, as XLA's convert
}

// Plane stride (elements) of npix pixels such that the stride in 4-byte
// words is odd: the 32 channels of one pixel then sit in 32 banks.
template <typename T> __host__ __device__ constexpr int plane_stride(int npix) {
  return sizeof(T) == 4 ? (npix | 1)                           // odd words
                        : ((npix + 3) / 4) * 4 + 2;            // 2 mod 4 halves
}

// acc[j][c] += sum_{tap, ci} in[ci][pix_j + tap offset] * w[tap][ci][co0 + c]
// for the PP pixels of this thread.  in_w is the input tile's row width.
template <typename T, int PP>
__device__ __forceinline__ void conv_tile(const T* __restrict__ in_s,
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
    const T* plane = in_s + ci * in_stride;
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const int off = (tap / 3) * in_w + (tap % 3);
      float v[PP];
#pragma unroll
      for (int j = 0; j < PP; ++j) v[j] = to_f(plane[base[j] + off]);
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
// w: (2, 3, 3, C, C) f32 HWIO (already rounded to T); b: (2, C) f32.
template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
residual_block_kernel(const T* __restrict__ x, T* __restrict__ out,
                      const float* __restrict__ w,
                      const float* __restrict__ b, int H, int W) {
  constexpr int kSX = plane_stride<T>(kXT * kXT);
  constexpr int kSH = plane_stride<T>(kHT * kHT);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* w_s = reinterpret_cast<float*>(smem_raw);               // 9*C*C
  T* x_s = reinterpret_cast<T*>(w_s + 9 * kC * kC);              // C*kSX
  T* h_s = x_s + kC * kSX;                                       // C*kSH

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
    T v = from_f<T>(0.0f);
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
    conv_tile<T, PP>(x_s, kSX, kXT, w_s, base, co0, acc);
#pragma unroll
    for (int j = 0; j < PP; ++j) {
      if (hp[j] >= kHT * kHT) continue;
      const int yy = ty0 - 1 + hp[j] / kHT;
      const int xx = tx0 - 1 + hp[j] % kHT;
      const bool inside = yy >= 0 && yy < H && xx >= 0 && xx < W;
#pragma unroll
      for (int c = 0; c < kCoPerWarp; ++c) {
        // h is zero outside the image: the second conv pads h with zeros
        const float v = inside ? fmaxf(acc[j][c] + b[co0 + c], 0.0f) : 0.0f;
        h_s[(co0 + c) * kSH + hp[j]] = from_f<T>(v);
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
    conv_tile<T, PP>(h_s, kSH, kHT, w_s, base, co0, acc);
#pragma unroll
    for (int j = 0; j < PP; ++j) {
      const int oy = op[j] / kTile;
      const int ox = op[j] % kTile;
      const int yy = ty0 + oy;
      const int xx = tx0 + ox;
      if (yy >= H || xx >= W) continue;
      const int xp = (oy + 2) * kXT + ox + 2;
      T* dst = out + (img + static_cast<long long>(yy) * W + xx) * kC + co0;
#pragma unroll
      for (int c = 0; c < kCoPerWarp; ++c) {
        const float r = to_f(x_s[(co0 + c) * kSX + xp]);
        dst[c] = from_f<T>(fmaxf(acc[j][c] + b[kC + co0 + c] + r, 0.0f));
      }
    }
  }
}

template <typename T>
int launch_chain(const T* x, T* out, T* scratch, const float* w,
                 const float* b, long long B, long long H, long long W,
                 long long k, cudaStream_t st) {
  constexpr int kSX = plane_stride<T>(kXT * kXT);
  constexpr int kSH = plane_stride<T>(kHT * kHT);
  const size_t smem = 9 * kC * kC * sizeof(float)
                      + static_cast<size_t>(kC) * (kSX + kSH) * sizeof(T);
  cudaError_t err = cudaFuncSetAttribute(
      residual_block_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long tiles = ((H + kTile - 1) / kTile) * ((W + kTile - 1) / kTile);
  const dim3 grid(static_cast<unsigned>(tiles), static_cast<unsigned>(B));
  // ping-pong so the last block writes `out`: block i reads src, writes dst
  const T* src = x;
  for (long long i = 0; i < k; ++i) {
    T* dst = ((k - 1 - i) % 2 == 0) ? out : scratch;
    residual_block_kernel<T><<<grid, kThreads, smem, st>>>(
        src, dst, w + i * 2 * 9 * kC * kC, b + i * 2 * kC,
        static_cast<int>(H), static_cast<int>(W));
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    src = dst;
  }
  return 0;
}

}  // namespace

// x, out, scratch: (B, H, W, 32) contiguous, bf16 (is_bf16 = 1) or f32;
// w: (k, 2, 3, 3, 32, 32) f32 holding values of x's type; b: (k, 2, 32) f32.
// scratch may be null when k == 1.  Returns cudaGetLastError() of the
// launches (0 on success).
extern "C" int branch_chain_launch(const void* x, void* out, void* scratch,
                                   const float* w, const float* b,
                                   long long B, long long H, long long W,
                                   long long k, int is_bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch_chain(static_cast<const __nv_bfloat16*>(x),
                        static_cast<__nv_bfloat16*>(out),
                        static_cast<__nv_bfloat16*>(scratch), w, b, B, H, W,
                        k, st);
  return launch_chain(static_cast<const float*>(x), static_cast<float*>(out),
                      static_cast<float*>(scratch), w, b, B, H, W, k, st);
}
