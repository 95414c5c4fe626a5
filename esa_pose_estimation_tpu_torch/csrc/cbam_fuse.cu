// Fused CBAM gate (+ residual add + ReLU) for Hopper (sm_90a), inference.
//
// Replaces the TPU kernel esa_pose_estimation_tpu/experimental/cbam_fuse.py
// (fused_cbam_pallas, body _kernel).  Plain PyTorch version:
// esa_pose_estimation_tpu_torch/experimental/cbam_fuse.py cbam_plain.
//
// out = x * cg * sg  [then relu(out + residual)], f32 math, bf16 in and out:
//   cg = sigmoid(MLP(avgpool(x)) + MLP(maxpool(x)))      per (image, channel)
//   sg = sigmoid(conv7x7([mean_c(x*cg), max_c(x*cg)]))    per pixel
//
// Bound: bytes (x and residual read, out written, all bf16; a few dozen
// operations per element).  The TPU kernel keeps a whole image in VMEM; a
// Hopper block cannot hold one (128x128x64 f32 is 4 MB), so the work is
// four launches on one stream:
//   1. per (image, spatial chunk): channel sums and maxima -> partials;
//   2. per image: reduce the partials, the C -> C/16 -> C MLP, sigmoid;
//   3. per pixel (one warp): channel mean and max of x*cg;
//   4. per 16x16 tile with a 3-pixel halo in shared memory: the 7x7 conv,
//      sigmoid, x*cg*sg, optional +residual and ReLU, written as bf16.
// x is read three times (passes 1, 3, 4); the partial reductions need no
// float atomics, so the result does not depend on block scheduling.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kChunk = 128;  // pixels per pooling block
constexpr int kTile = 16;    // output tile side of the spatial pass
constexpr int kHalo = kTile + 6;

__device__ __forceinline__ float sigmoidf(float v) {
  return 1.0f / (1.0f + expf(-v));
}

// Pass 1: per (chunk, image) partial channel sums and maxima.
__global__ void __launch_bounds__(kThreads)
pool_partial_kernel(const __nv_bfloat16* __restrict__ x, int HW, int C,
                    int n_chunks, float* __restrict__ psum,
                    float* __restrict__ pmax) {
  const int chunk = blockIdx.x;
  const int b = blockIdx.y;
  const int cpb = C < kThreads ? C : kThreads;  // channels per sweep
  const int slots = kThreads / cpb;             // pixels in flight
  const int slot = threadIdx.x / cpb;
  const int p0 = chunk * kChunk;
  const int p1 = min(p0 + kChunk, HW);
  __shared__ float s_sum[kThreads];
  __shared__ float s_max[kThreads];
  const __nv_bfloat16* xb = x + static_cast<long long>(b) * HW * C;
  for (int c0 = 0; c0 < C; c0 += cpb) {
    const int c = c0 + threadIdx.x % cpb;
    float s = 0.0f;
    float m = -INFINITY;
    if (slot < slots && c < C) {
      for (int p = p0 + slot; p < p1; p += slots) {
        const float v = __bfloat162float(xb[static_cast<long long>(p) * C + c]);
        s += v;
        m = fmaxf(m, v);
      }
    }
    s_sum[threadIdx.x] = s;
    s_max[threadIdx.x] = m;
    __syncthreads();
    if (threadIdx.x < cpb && c < C) {
      for (int j = 1; j < slots; ++j) {
        s += s_sum[j * cpb + threadIdx.x];
        m = fmaxf(m, s_max[j * cpb + threadIdx.x]);
      }
      const long long o = (static_cast<long long>(b) * n_chunks + chunk) * C + c;
      psum[o] = s;
      pmax[o] = m;
    }
    __syncthreads();
  }
}

// Pass 2: per image, reduce partials and run the shared MLP -> cg (B, C).
__global__ void __launch_bounds__(kThreads)
channel_gate_kernel(const float* __restrict__ psum,
                    const float* __restrict__ pmax, int HW, int C, int hid,
                    int n_chunks, const float* __restrict__ fc1,
                    const float* __restrict__ fc2, float* __restrict__ cg) {
  extern __shared__ float smem[];
  float* avg = smem;            // C
  float* mx = avg + C;          // C
  float* h_avg = mx + C;        // hid
  float* h_max = h_avg + hid;   // hid
  const int b = blockIdx.x;
  for (int c = threadIdx.x; c < C; c += kThreads) {
    float s = 0.0f;
    float m = -INFINITY;
    for (int k = 0; k < n_chunks; ++k) {
      const long long o = (static_cast<long long>(b) * n_chunks + k) * C + c;
      s += psum[o];
      m = fmaxf(m, pmax[o]);
    }
    avg[c] = s / static_cast<float>(HW);
    mx[c] = m;
  }
  __syncthreads();
  for (int j = threadIdx.x; j < hid; j += kThreads) {
    float a = 0.0f;
    float m = 0.0f;
    for (int c = 0; c < C; ++c) {
      const float w = fc1[c * hid + j];
      a += avg[c] * w;
      m += mx[c] * w;
    }
    h_avg[j] = fmaxf(a, 0.0f);
    h_max[j] = fmaxf(m, 0.0f);
  }
  __syncthreads();
  for (int c = threadIdx.x; c < C; c += kThreads) {
    float a = 0.0f;
    float m = 0.0f;
    for (int j = 0; j < hid; ++j) {
      const float w = fc2[j * C + c];
      a += h_avg[j] * w;
      m += h_max[j] * w;
    }
    cg[static_cast<long long>(b) * C + c] = sigmoidf(a + m);
  }
}

// Pass 3: per pixel, mean and max over channels of x*cg -> pooled (B*HW, 2).
__global__ void __launch_bounds__(kThreads)
spatial_pool_kernel(const __nv_bfloat16* __restrict__ x,
                    const float* __restrict__ cg, long long n_pix, int HW,
                    int C, float* __restrict__ pooled) {
  const long long pix = static_cast<long long>(blockIdx.x) * (kThreads / 32)
                        + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (pix >= n_pix) return;  // whole warps exit together
  const int b = static_cast<int>(pix / HW);
  const __nv_bfloat16* xp = x + pix * C;
  const float* g = cg + static_cast<long long>(b) * C;
  float s = 0.0f;
  float m = -INFINITY;
  for (int c = lane; c < C; c += 32) {
    const float v = __bfloat162float(xp[c]) * g[c];
    s += v;
    m = fmaxf(m, v);
  }
  for (int off = 16; off > 0; off >>= 1) {
    s += __shfl_down_sync(0xffffffffu, s, off);
    m = fmaxf(m, __shfl_down_sync(0xffffffffu, m, off));
  }
  if (lane == 0) {
    pooled[2 * pix + 0] = s / static_cast<float>(C);
    pooled[2 * pix + 1] = m;
  }
}

// Pass 4: 7x7 conv over the pooled maps (zero padding), sigmoid, and the
// gated output for one 16x16 tile of one image.
__global__ void __launch_bounds__(kThreads)
apply_kernel(const __nv_bfloat16* __restrict__ x,
             const __nv_bfloat16* __restrict__ res,
             const float* __restrict__ cg, const float* __restrict__ pooled,
             const float* __restrict__ spw, int H, int W, int C,
             __nv_bfloat16* __restrict__ out) {
  __shared__ float s_pa[kHalo * kHalo];
  __shared__ float s_pm[kHalo * kHalo];
  __shared__ float s_sg[kTile * kTile];
  __shared__ float s_w[98];
  const int tx0 = blockIdx.x * kTile;
  const int ty0 = blockIdx.y * kTile;
  const int b = blockIdx.z;
  const long long img = static_cast<long long>(b) * H * W;
  if (threadIdx.x < 98) s_w[threadIdx.x] = spw[threadIdx.x];
  for (int i = threadIdx.x; i < kHalo * kHalo; i += kThreads) {
    const int yy = ty0 - 3 + i / kHalo;
    const int xx = tx0 - 3 + i % kHalo;
    float a = 0.0f;
    float m = 0.0f;
    if (yy >= 0 && yy < H && xx >= 0 && xx < W) {
      const long long p = img + static_cast<long long>(yy) * W + xx;
      a = pooled[2 * p + 0];
      m = pooled[2 * p + 1];
    }
    s_pa[i] = a;
    s_pm[i] = m;
  }
  __syncthreads();
  {
    const int ty = threadIdx.x / kTile;
    const int tx = threadIdx.x % kTile;
    float acc = 0.0f;
    for (int ky = 0; ky < 7; ++ky) {
      for (int kx = 0; kx < 7; ++kx) {
        const int i = (ty + ky) * kHalo + tx + kx;
        acc = acc + s_w[(ky * 7 + kx) * 2 + 0] * s_pa[i];
        acc = acc + s_w[(ky * 7 + kx) * 2 + 1] * s_pm[i];
      }
    }
    s_sg[threadIdx.x] = sigmoidf(acc);
  }
  __syncthreads();
  const int tw = min(kTile, W - tx0);
  const int th = min(kTile, H - ty0);
  const float* g = cg + static_cast<long long>(b) * C;
  for (int r = 0; r < th; ++r) {
    // one tile row: tw pixels x C channels, contiguous in NHWC memory
    const long long row0 = (img + static_cast<long long>(ty0 + r) * W + tx0) * C;
    for (int i = threadIdx.x; i < tw * C; i += kThreads) {
      const int px = i / C;
      const int c = i - px * C;
      const long long o = row0 + i;
      float v = __bfloat162float(x[o]) * g[c];
      v = v * s_sg[r * kTile + px];
      if (res != nullptr) v = fmaxf(v + __bfloat162float(res[o]), 0.0f);
      out[o] = __float2bfloat16(v);
    }
  }
}

}  // namespace

extern "C" int cbam_fuse_launch(const void* x, const void* res,
                                const float* fc1, const float* fc2,
                                const float* spw, void* out, float* psum,
                                float* pmax, float* cg, float* pooled,
                                long long B, long long H, long long W,
                                long long C, long long hid, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int hw = static_cast<int>(H * W);
  const int n_chunks = (hw + kChunk - 1) / kChunk;
  const auto* xb = static_cast<const __nv_bfloat16*>(x);
  const auto* rb = static_cast<const __nv_bfloat16*>(res);
  pool_partial_kernel<<<dim3(n_chunks, static_cast<unsigned>(B)), kThreads, 0, st>>>(
      xb, hw, static_cast<int>(C), n_chunks, psum, pmax);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t smem = (2 * C + 2 * hid) * sizeof(float);
  channel_gate_kernel<<<static_cast<unsigned>(B), kThreads, smem, st>>>(
      psum, pmax, hw, static_cast<int>(C), static_cast<int>(hid), n_chunks,
      fc1, fc2, cg);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long n_pix = B * H * W;
  const long long warps_per_block = kThreads / 32;
  spatial_pool_kernel<<<static_cast<unsigned>((n_pix + warps_per_block - 1) / warps_per_block),
                        kThreads, 0, st>>>(xb, cg, n_pix, hw, static_cast<int>(C), pooled);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>((W + kTile - 1) / kTile),
                  static_cast<unsigned>((H + kTile - 1) / kTile),
                  static_cast<unsigned>(B));
  apply_kernel<<<grid, kThreads, 0, st>>>(xb, rb, cg, pooled, spw,
                                          static_cast<int>(H), static_cast<int>(W),
                                          static_cast<int>(C),
                                          static_cast<__nv_bfloat16*>(out));
  return static_cast<int>(cudaGetLastError());
}
