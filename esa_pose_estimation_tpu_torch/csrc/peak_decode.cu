// Peak decode for Hopper (sm_90a): per heatmap, the first-occurrence
// row-major argmax and peak value, then the my_taylor log-derivative
// stencil and its gate.
//
// Replaces the TPU kernel esa_pose_estimation_tpu/ops/pallas/peak_decode.py
// (decode_heatmaps_pallas, body _kernel).  Plain PyTorch version:
// esa_pose_estimation_tpu_torch/ops/peak.py decode_heatmaps.
//
// Bound: bytes (each map value is read once; a few operations each).  The
// input is the network's contiguous channels-last (B, H, W, K) f32 output.
// One thread-block cluster per image, of R CTAs: R starts at 1 and doubles
// while the doubled grid has no more CTAs than the card has SMs (at most
// kMaxRanks and H; cli/mfu_experiments --cluster-sweep measured it).  Each CTA
// reads a band of ceil(H/R) rows, which is one contiguous run of
// rows * W * K floats, with 16-byte loads (4-byte loads where W * K is not
// a multiple of 4 or the base is not 16-byte aligned).  The block has T
// threads with T * VEC a multiple of K, so element q of thread t's vector
// always belongs to keypoint (t * VEC + q) % K and moves T * VEC / K pixels
// per sweep: each thread keeps (max, first index) for its VEC elements in
// registers, with no division in the loop.  The block then folds its
// T * VEC pairs per keypoint in shared memory; after a cluster barrier, the
// CTA of rank k % R folds keypoint k's pairs of every rank through
// distributed shared memory, in rank order, and evaluates the 10-tap
// stencil and the gate (and, when `peaks` is not null, writes the integer
// peak's row-major index).  Ties: the larger value wins, and among equal
// values the smaller index (take_better), which is a total order, so the
// fold gives the first occurrence whatever the grouping.
//
// Built without fast math on purpose: logf and IEEE division keep the
// signed `off < 1` gate and the last bits of the coordinates equal to the
// plain version's.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxRanks = 16;      // largest cluster (non-portable above 8)
constexpr int kMaxThreads = 512;   // T is the largest fitting multiple
constexpr int kNone = 0x7fffffff;  // index of an empty pair

constexpr int kErrShape = -1;      // no thread count fits K, or too large
constexpr int kErrCluster = -3;    // no cluster of R such CTAs can be placed
constexpr int kErrDevice = -4;     // device index past kMaxDevices
constexpr int kMaxDevices = 64;    // cards of one process with host state

__device__ __forceinline__ void take_better(float& v, int& i, float ov, int oi) {
  // larger value wins; among equal values the smaller (earlier) index wins
  if (ov > v || (ov == v && oi < i)) {
    v = ov;
    i = oi;
  }
}

template <int VEC>
struct Vec;
template <>
struct Vec<4> {
  using T = float4;
};
template <>
struct Vec<1> {
  using T = float;
};

template <int VEC>
__global__ void __launch_bounds__(kMaxThreads)
peak_decode_kernel(const float* __restrict__ hm, int H, int W, int K, int band,
                   float* __restrict__ coords, float* __restrict__ maxvals,
                   int* __restrict__ peaks, float eps) {
  using V = typename Vec<VEC>::T;
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int n_ranks = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int b = blockIdx.x / n_ranks;
  const int T = blockDim.x;
  const int t = threadIdx.x;
  const int row0 = rank * band;
  const int nrows = max(0, min(band, H - row0));
  const int nvec = nrows * W * K / VEC;
  const int sweep_pix = T * VEC / K;       // pixels one sweep of T vectors covers
  const float* img = hm + static_cast<long long>(b) * H * W * K;

  float best[VEC];
  int bidx[VEC];
  int pix0[VEC];
#pragma unroll
  for (int q = 0; q < VEC; ++q) {
    best[q] = -INFINITY;
    bidx[q] = kNone;
    pix0[q] = row0 * W + (t * VEC + q) / K;
  }
  const V* src = reinterpret_cast<const V*>(img + static_cast<long long>(row0) * W * K);
  for (int i0 = 0; i0 < nvec; i0 += 4 * T) {
    V v[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int i = i0 + u * T + t;
      if (i < nvec) v[u] = __ldg(src + i);
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int i = i0 + u * T + t;
      if (i < nvec) {
        const float* f = reinterpret_cast<const float*>(&v[u]);
        const int dp = (i0 / T + u) * sweep_pix;
#pragma unroll
        for (int q = 0; q < VEC; ++q) {
          // strictly greater keeps the first index; the first pixel is
          // always taken
          if (f[q] > best[q] || bidx[q] == kNone) {
            best[q] = f[q];
            bidx[q] = pix0[q] + dp;
          }
        }
      }
    }
  }

  // fold the block's pairs per keypoint: pair e = t * VEC + q belongs to
  // keypoint e % K
  float* s_val = reinterpret_cast<float*>(smem);
  int* s_idx = reinterpret_cast<int*>(s_val + T * VEC);
  float* s_best = reinterpret_cast<float*>(s_idx + T * VEC);
  int* s_bidx = reinterpret_cast<int*>(s_best + K);
#pragma unroll
  for (int q = 0; q < VEC; ++q) {
    s_val[t * VEC + q] = best[q];
    s_idx[t * VEC + q] = bidx[q];
  }
  __syncthreads();
  for (int k = t; k < K; k += T) {
    float v = -INFINITY;
    int i = kNone;
    for (int e = k; e < T * VEC; e += K) take_better(v, i, s_val[e], s_idx[e]);
    s_best[k] = v;
    s_bidx[k] = i;
  }
  cluster.sync();

  // keypoint k is finished by rank k % R: every rank's pair, in rank order
  for (int k = rank + t * n_ranks; k < K; k += T * n_ranks) {
    float bv = -INFINITY;
    int bi = kNone;
    for (int r = 0; r < n_ranks; ++r) {
      take_better(bv, bi, cluster.map_shared_rank(s_best, r)[k],
                  cluster.map_shared_rank(s_bidx, r)[k]);
    }
    const float* base = img + k;
    const int px = bi % W;
    const int py = bi / W;
    auto at = [&](int dy, int dx) -> float {
      const int yy = min(max(py + dy, 0), H - 1);
      const int xx = min(max(px + dx, 0), W - 1);
      return logf(fmaxf(__ldg(base + (static_cast<long long>(yy) * W + xx) * K), eps));
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

    const long long map = static_cast<long long>(b) * K + k;
    coords[2 * map + 0] = static_cast<float>(px) + (apply ? off_x : 0.0f);
    coords[2 * map + 1] = static_cast<float>(py) + (apply ? off_y : 0.0f);
    maxvals[map] = bv;
    if (peaks != nullptr) peaks[map] = bi;
  }
  cluster.sync();  // no rank leaves while another reads its shared memory
}

int gcd(int a, int b) { return b == 0 ? a : gcd(b, a % b); }

// Threads per CTA: the largest multiple of lcm(32, K / gcd(K, VEC)) up to
// kMaxThreads, so that T * VEC is a multiple of K; 0 if none fits.
int block_threads(int K, int vec) {
  const int m = K / gcd(K, vec);
  const int unit = 32 / gcd(32, m) * m;
  return unit > kMaxThreads ? 0 : kMaxThreads / unit * unit;
}

struct Placed {
  int vec, threads, ranks, keypoints;
  int clusters;
};

// Host state of one card, kept per device (the runtime's current device,
// which the wrapper sets to the maps' card): its SM count, read once; each
// kernel's non-portable cluster attribute, set once; each configuration's
// cluster occupancy, asked once before its first launch there.
struct DeviceState {
  Placed placed[16];
  int n_placed;
  bool nonportable[2];
  int n_sm;
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

struct Config {
  int vec, threads, ranks, band, keypoints, clusters;
};

template <int VEC>
cudaLaunchConfig_t launch_config(const Config& c, cudaLaunchAttribute* attr) {
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = c.ranks;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t lc = {};
  lc.gridDim = dim3(c.ranks);
  lc.blockDim = dim3(c.threads);
  lc.dynamicSmemBytes = (2 * static_cast<size_t>(c.threads) * VEC + 2 * c.keypoints) * 4;
  lc.attrs = attr;
  lc.numAttrs = 1;
  return lc;
}

// Cluster occupancy of a configuration, asked once before its first launch.
template <int VEC>
int place(DeviceState* d, Config* c) {
  for (int i = 0; i < d->n_placed; ++i) {
    const Placed& p = d->placed[i];
    if (p.vec == VEC && p.threads == c->threads && p.ranks == c->ranks
        && p.keypoints == c->keypoints) {
      c->clusters = p.clusters;
      return c->clusters < 1 ? kErrCluster : 0;
    }
  }
  cudaError_t err;
  if (!d->nonportable[VEC == 4]) {
    err = cudaFuncSetAttribute(peak_decode_kernel<VEC>,
                               cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return static_cast<int>(err);
    d->nonportable[VEC == 4] = true;
  }
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t lc = launch_config<VEC>(*c, attr);
  err = cudaOccupancyMaxActiveClusters(&c->clusters, peak_decode_kernel<VEC>, &lc);
  if (err != cudaSuccess) return static_cast<int>(err);
  d->placed[d->n_placed % 16] = Placed{VEC, c->threads, c->ranks, c->keypoints, c->clusters};
  if (d->n_placed < 16) ++d->n_placed;
  return c->clusters < 1 ? kErrCluster : 0;
}

// ranks = 0: R from 1, doubled while B * 2R <= SMs, 2R <= kMaxRanks, 2R <= H.
int configure(bool aligned, long long B, long long H, long long W, long long K,
              int ranks, Config* c) {
  if (B < 1 || H < 1 || W < 1 || K < 1 || ranks < 0 || ranks > kMaxRanks
      || H * W * K >= (1LL << 31)) {
    return kErrShape;
  }
  DeviceState* d = nullptr;
  const int err = device_state(&d);
  if (err != 0) return err;
  const int k = static_cast<int>(K);
  c->keypoints = k;
  c->ranks = ranks;
  if (ranks == 0) {
    c->ranks = 1;
    while (2 * B * c->ranks <= d->n_sm && 2 * c->ranks <= kMaxRanks && 2 * c->ranks <= H) {
      c->ranks *= 2;
    }
  }
  c->band = static_cast<int>((H + c->ranks - 1) / c->ranks);
  c->threads = block_threads(k, 4);
  if (aligned && (W * K) % 4 == 0 && c->threads > 0) {
    c->vec = 4;
    return place<4>(d, c);
  }
  c->vec = 1;
  c->threads = block_threads(k, 1);
  if (c->threads == 0) return kErrShape;
  return place<1>(d, c);
}

template <int VEC>
int launch(const Config& c, const float* hm, long long B, int H, int W, int K,
           float* coords, float* maxvals, int* peaks, float eps,
           cudaStream_t st) {
  if (B * c.ranks >= (1LL << 31)) return kErrShape;
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t lc = launch_config<VEC>(c, attr);
  lc.gridDim = dim3(static_cast<unsigned>(B * c.ranks));
  lc.stream = st;
  const cudaError_t e = cudaLaunchKernelEx(&lc, peak_decode_kernel<VEC>, hm, H, W, K,
                                           c.band, coords, maxvals, peaks, eps);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The launch of (B, H, W, K) maps (at a 16-byte aligned address if
// `aligned`): CTAs per image, threads per CTA, floats per load, and how
// many such clusters the card holds at once.
extern "C" int peak_decode_config(int aligned, long long B, long long H,
                                  long long W, long long K, int ranks,
                                  int* out_ranks, int* out_threads,
                                  int* out_vec, int* out_clusters) {
  Config c;
  const int err = configure(aligned != 0, B, H, W, K, ranks, &c);
  if (err != 0) return err;
  *out_ranks = c.ranks;
  *out_threads = c.threads;
  *out_vec = c.vec;
  *out_clusters = c.clusters;
  return 0;
}

// hm: contiguous (B, H, W, K) f32.  coords (B, K, 2), maxvals (B, K),
// peaks (B, K) int32 or null.  ranks = 0 takes the default cluster size.
extern "C" int peak_decode_launch(const float* hm, long long B, long long H,
                                  long long W, long long K, float* coords,
                                  float* maxvals, int* peaks, float eps,
                                  int ranks, void* stream) {
  Config c;
  const int err = configure(reinterpret_cast<uintptr_t>(hm) % 16 == 0, B, H, W,
                            K, ranks, &c);
  if (err != 0) return err;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int h = static_cast<int>(H), w = static_cast<int>(W), k = static_cast<int>(K);
  return c.vec == 4 ? launch<4>(c, hm, B, h, w, k, coords, maxvals, peaks, eps, st)
                    : launch<1>(c, hm, B, h, w, k, coords, maxvals, peaks, eps, st);
}
