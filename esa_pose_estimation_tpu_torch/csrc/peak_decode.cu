// Peak decode for Hopper (sm_90a): per heatmap, the first-occurrence
// row-major argmax and peak value, then the my_taylor log-derivative
// stencil and its gate.
//
// Replaces the TPU kernel esa_pose_estimation_tpu/ops/pallas/peak_decode.py
// (decode_heatmaps_pallas, body _kernel).  Plain PyTorch version:
// esa_pose_estimation_tpu_torch/ops/peak.py decode_heatmaps.
//
// Bound: bytes (each map value is read once; a few operations each).  One
// block per (image, keypoint) map reads the channels-last (B, H, W, K)
// network output through its strides, so no transpose pass runs first.
// Each thread keeps (max, first index) over its pixels, the block reduces
// the pairs, and thread 0 evaluates the 10-tap stencil and the gate (and,
// when `peaks` is not null, writes the integer peak's row-major index).
//
// Built without fast math on purpose: logf and IEEE division keep the
// signed `off < 1` gate and the last bits of the coordinates equal to the
// plain version's.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ void take_better(float& v, int& i, float ov, int oi) {
  // larger value wins; among equal values the smaller (earlier) index wins
  if (ov > v || (ov == v && oi < i)) {
    v = ov;
    i = oi;
  }
}

__global__ void __launch_bounds__(kThreads)
peak_decode_kernel(const float* __restrict__ hm, int H, int W, int K,
                   long long sb, long long sh, long long sw, long long sk,
                   float* __restrict__ coords, float* __restrict__ maxvals,
                   int* __restrict__ peaks, float eps) {
  const int map = blockIdx.x;
  const int b = map / K;
  const int k = map - b * K;
  const float* base = hm + b * sb + k * sk;
  const int n = H * W;

  float best = -INFINITY;
  int bidx = n;
  for (int i = threadIdx.x; i < n; i += kThreads) {
    const int y = i / W;
    const int x = i - y * W;
    const float v = base[y * sh + x * sw];
    if (v > best || bidx == n) {  // strictly greater: keeps the first index
      best = v;
      bidx = i;
    }
  }
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_down_sync(0xffffffffu, best, off);
    const int oi = __shfl_down_sync(0xffffffffu, bidx, off);
    take_better(best, bidx, ov, oi);
  }
  __shared__ float s_val[kThreads / 32];
  __shared__ int s_idx[kThreads / 32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) {
    s_val[warp] = best;
    s_idx[warp] = bidx;
  }
  __syncthreads();
  if (threadIdx.x != 0) return;
  for (int w = 1; w < kThreads / 32; ++w) take_better(best, bidx, s_val[w], s_idx[w]);

  const int px = bidx % W;
  const int py = bidx / W;
  auto at = [&](int dy, int dx) -> float {
    const int yy = min(max(py + dy, 0), H - 1);
    const int xx = min(max(px + dx, 0), W - 1);
    return logf(fmaxf(base[yy * sh + xx * sw], eps));
  };
  const float c = at(0, 0);
  const float hx = 0.5f * (at(0, 1) - at(0, -1));
  const float hy = 0.5f * (at(1, 0) - at(-1, 0));
  const float hxx = 0.25f * (at(0, 2) - 2.0f * c + at(0, -2));
  const float hyy = 0.25f * (at(2, 0) - 2.0f * c + at(-2, 0));

  const bool interior = px > 1 && px < W - 2 && py > 1 && py < H - 2;
  const bool nonzero = hxx != 0.0f && hyy != 0.0f;
  const float off_x = -hx / (hxx == 0.0f ? 1.0f : hxx);
  const float off_y = -hy / (hyy == 0.0f ? 1.0f : hyy);
  const bool apply = interior && nonzero && off_x < 1.0f && off_y < 1.0f;

  coords[2 * map + 0] = static_cast<float>(px) + (apply ? off_x : 0.0f);
  coords[2 * map + 1] = static_cast<float>(py) + (apply ? off_y : 0.0f);
  maxvals[map] = best;
  if (peaks != nullptr) peaks[map] = bidx;
}

}  // namespace

extern "C" int peak_decode_launch(const float* hm, long long B, long long H,
                                  long long W, long long K, long long sb,
                                  long long sh, long long sw, long long sk,
                                  float* coords, float* maxvals, int* peaks,
                                  float eps, void* stream) {
  const long long maps = B * K;
  peak_decode_kernel<<<static_cast<unsigned>(maps), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      hm, static_cast<int>(H), static_cast<int>(W), static_cast<int>(K), sb,
      sh, sw, sk, coords, maxvals, peaks, eps);
  return static_cast<int>(cudaGetLastError());
}
