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
// Bound: bytes.  Per site the function must read x (and the residual) and
// write the output once, all bf16; it does a few dozen operations per
// element.  Bytes per image at hrnet_esa's five sites: 64x64x32 256 KB,
// 32x32x64 128 KB, 16x16x128 64 KB, 8x8x256 32 KB (each read as x, read as
// residual, written as out), and the stem skip 128x128x64 2 MB (x read,
// out written; no residual).
//
// Design: one launch per site, one thread-block cluster per image.  The
// TPU kernel holds a whole image in VMEM; a Hopper block holds at most
// 227 KB, so the image is cut into R bands of ceil(H/R) full-width rows,
// one per CTA of the cluster, and the CTAs meet through distributed shared
// memory (DSMEM).  Each CTA:
//   1. loads its band of x into shared memory once, with 16-byte cp.async,
//      and the MLP and conv weights beside it as f32, read in the dtype
//      (f32 or bf16) and layout in which the convs store them;
//   2. takes the per-channel sum and max of each row of its band;
//   3. after a cluster barrier, reads every row's sums and every rank's
//      maxima through DSMEM (all threads at once) and adds the rows in
//      fixed chunks of the image, in order: no float atomics, so the
//      result does not depend on scheduling, and every CTA computes the
//      same gate; then runs the C -> C/16 -> C MLP and the sigmoid;
//   4. writes the per-pixel channel mean and max of x*cg into a
//      zero-bordered window of its rows plus 3 halo rows on each side;
//   5. after a second cluster barrier, copies the halo rows of the pooled
//      maps from the ranks that own them (zeros beyond the image: the
//      'SAME' padding), then signals that it is done reading DSMEM;
//   6. runs the 7x7 conv and the sigmoid, then writes x*cg*sg (+ residual,
//      ReLU) as bf16 with 16-byte stores, x taken from shared memory;
//   7. waits for the cluster before it exits, so no rank's shared memory
//      goes away while another still reads it.
// Device-memory traffic is x once, the residual once and the output once:
// the bound's own byte count.  Loading the band and writing the output run
// at the memory's rate; the steps between them are short and bound by
// latency (barriers, DSMEM reads, reductions), and the card's memory idles
// unless another CTA on the SM is loading or storing meanwhile.  Hence at
// most 42 registers a thread (three CTAs per SM where shared memory allows)
// and R chosen per site by measurement.
//
// Every sum is taken in an order fixed by (H, W, C) alone: a row's in
// step 2, the rows' in step 3 (in chunks of ceil(H / (kThreads / C))
// rows), a pixel's channels in step 4 (whose lanes per pixel follow the
// site rule's R, not the launch's).  So an image's
// output does not depend on R, which follows the batch, nor on the other
// images of its batch: a frame served alone, in a batch or in a shard
// gives the same bits.
//
// R per site (kSiteRanks, mirrored in the Python module as _SITE_RANKS) is
// the fastest at batch 256 (cli/mfu_experiments --cluster-sweep, which
// re-derives the table on another card); a shape not
// in the table takes the smallest power of two whose band fits kBandBytes.
// R then doubles while the doubled grid has no more CTAs than the card has
// SMs, so that a small batch fills the card.  The stem (2 MB per image)
// takes R = 16, 128 KB of x per CTA, a non-portable cluster size
// (cudaFuncAttributeNonPortableClusterSizeAllowed) that the H100 supports:
// 7 such clusters fit the card at once.  It keeps the one-launch form,
// x read once, rather than two launches (channel pools, then the spatial
// pass, which reads x again plus a 3-row halo per band so that several
// CTAs fit an SM): the two-launch form moves 3.75 to 4.5 times the image's
// bytes against 2, so even at the memory's full rate it would gain little
// over the one-launch form's waves of one CTA per SM, and it needs a
// scratch buffer and a second kernel (PERF.md has the numbers).

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxRanks = 16;       // CTAs per cluster, non-portable above 8
constexpr int kBandBytes = 65536;   // x bytes per CTA the default rule aims at

// hrnet_esa's CBAM sites: H, W, C, R (CTAs per image), the fastest R at
// batch 256 on an H100 (cli/mfu_experiments --cluster-sweep)
constexpr int kSiteRanks[5][4] = {
    {64, 64, 32, 5},
    {32, 32, 64, 2},
    {16, 16, 128, 1},
    {8, 8, 256, 1},
    {128, 128, 64, 16},
};

// error codes returned to the wrapper (cudaError_t values are >= 0)
constexpr int kErrShape = -1;     // C not a power of two in [8, 8 * kThreads]
constexpr int kErrSmem = -2;      // the band does not fit a block's shared memory
constexpr int kErrCluster = -3;   // no cluster of R such CTAs can be placed
constexpr int kErrDevice = -4;    // device index past kMaxDevices
constexpr int kErrDtype = -5;     // weight dtype code neither of the two below
constexpr int kMaxDevices = 64;   // cards of one process with host state

// the stored weights' dtype, as the wrapper codes it
constexpr int kWeightF32 = 0;
constexpr int kWeightBf16 = 1;

// Shared-memory layout of one CTA, in bytes from the dynamic base.  One
// region serves in turn the row partials (step 2), the chunk sums (step
// 3), and the pooled-map window with the spatial gate (steps 4 to 7).
struct Layout {
  long long x, red, win, sg, psum, pmax, avg, mx, gate, hav, hmx, w, fc1, fc2,
      bytes;
};

__host__ __device__ inline long long round16(long long n) {
  return (n + 15) & ~15LL;
}

__host__ __device__ inline long long max3(long long a, long long b, long long c) {
  return a > b ? (a > c ? a : c) : (b > c ? b : c);
}

__host__ __device__ inline Layout layout(int ranks, int band, int H, int W, int C,
                                         int hid, int tpr) {
  const int vpp = C / 8;                                    // 16-byte vectors per pixel
  const int kpw = vpp >= 32 ? 1 : 32 / vpp;                 // step 2's k per warp
  const int ng = tpr > kpw ? tpr / kpw : 1;                 // k groups per row
  const long long red = round16(8LL * band * ng * C);       // row partials
  const long long all = round16(4LL * (C > kThreads ? C : kThreads));  // chunk sums
  const long long win = round16(8LL * (band + 6) * (W + 6));  // pooled mean, max
  const long long sg = round16(4LL * band * W);             // spatial gate
  Layout l;
  long long o = 0;
  l.x = o;    o += round16(2LL * band * W * C);             // bf16 band of x
  l.red = o;
  l.win = o;
  l.sg = o + win;
  o += max3(red, all, win + sg);
  l.psum = o; o += round16(4LL * band * C);                 // published row sums
  l.pmax = o; o += round16(4LL * C);                        // and maxima
  l.avg = o;  o += round16(4LL * C);
  l.mx = o;   o += round16(4LL * C);
  l.gate = o; o += round16(4LL * C);                        // channel gate cg
  l.hav = o;  o += round16(4LL * hid);
  l.hmx = o;  o += round16(4LL * hid);
  l.w = o;    o += round16(4LL * 98);                       // 7x7x2 conv
  l.fc1 = o;  o += round16(4LL * C * hid);                  // MLP weights,
  l.fc2 = o;  o += round16(4LL * C * hid);                  // (hid, C) each
  l.bytes = o;
  return l;
}

__device__ __forceinline__ float sigmoidf(float v) {
  return 1.0f / (1.0f + expf(-v));
}

__device__ __forceinline__ void unpack8(const uint4& u, float* f) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 t = __bfloat1622float2(h[i]);
    f[2 * i] = t.x;
    f[2 * i + 1] = t.y;
  }
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

__device__ __forceinline__ uint4 pack8(const float* f) {
  uint4 u;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
  return u;
}

__device__ __forceinline__ void cp_async_16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}

// the two halves of a cluster barrier, split so that work goes on between
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// at most 42 registers a thread, so that three CTAs fit an SM.  The
// weights are the convs' own tensors, in their stored dtype Wt: fc1 the
// (hid, C) rows of ChannelAttention's first 1x1 conv, fc2 the (C, hid)
// rows of its second, spw SpatialAttention's (1, 2, 7, 7) 7x7 conv at
// element strides (sc, sy, sx) over (channel, row, column).  tpr and g
// fix the order of steps 2 and 4 (row_threads and pool_lanes).
template <typename Wt>
__global__ void __launch_bounds__(kThreads, 3)
cbam_cluster_kernel(const __nv_bfloat16* __restrict__ x,
                    const __nv_bfloat16* __restrict__ res,
                    const Wt* __restrict__ fc1,
                    const Wt* __restrict__ fc2,
                    const Wt* __restrict__ spw, int sc, int sy, int sx,
                    __nv_bfloat16* __restrict__ out, int H, int W, int C,
                    int hid, int band, int tpr, int g) {
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int n_ranks = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int b = blockIdx.x / n_ranks;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int vpp = C >> 3;
  const int row0 = rank * band;
  const int nrows = max(0, min(band, H - row0));
  const int npix = nrows * W;
  const int ws = W + 6;                    // window row stride
  const int plane = (band + 6) * ws;       // one pooled map's window

  const Layout l = layout(n_ranks, band, H, W, C, hid, tpr);
  uint4* s_x = reinterpret_cast<uint4*>(smem + l.x);
  float* s_red = reinterpret_cast<float*>(smem + l.red);
  float* s_win = reinterpret_cast<float*>(smem + l.win);
  float* s_sg = reinterpret_cast<float*>(smem + l.sg);
  float* s_psum = reinterpret_cast<float*>(smem + l.psum);
  float* s_pmax = reinterpret_cast<float*>(smem + l.pmax);
  float* s_avg = reinterpret_cast<float*>(smem + l.avg);
  float* s_mx = reinterpret_cast<float*>(smem + l.mx);
  float* s_gate = reinterpret_cast<float*>(smem + l.gate);
  float* s_hav = reinterpret_cast<float*>(smem + l.hav);
  float* s_hmx = reinterpret_cast<float*>(smem + l.hmx);
  float* s_w = reinterpret_cast<float*>(smem + l.w);
  float* s_fc1 = reinterpret_cast<float*>(smem + l.fc1);
  float* s_fc2 = reinterpret_cast<float*>(smem + l.fc2);

  // the band's first element; rows are contiguous in NHWC
  const long long off0 = (static_cast<long long>(b) * H + row0) * W * C;
  const int n16 = npix * vpp;
  const int vshift = __ffs(vpp) - 1;       // vpp is a power of two

  // 1. the band of x into shared memory; the weights beside it
  {
    const uint4* src = reinterpret_cast<const uint4*>(x + off0);
    for (int i = tid; i < n16; i += kThreads) cp_async_16(s_x + i, src + i);
  }
  // s_w[(ky * 7 + kx) * 2 + ch], s_fc1[j * C + c] and s_fc2[j * C + c]:
  // fc1 copied row by row, fc2 transposed, a thread a channel's row of
  // hid, so that the MLP below reads both without bank conflicts
  if (tid < 98) {
    const int k = tid >> 1;
    s_w[tid] = to_f32(spw[(tid & 1) * sc + (k / 7) * sy + (k % 7) * sx]);
  }
  for (int i = tid; i < C * hid; i += kThreads) s_fc1[i] = to_f32(fc1[i]);
  for (int c = tid; c < C; c += kThreads) {
    for (int j = 0; j < hid; ++j) s_fc2[j * C + c] = to_f32(fc2[c * hid + j]);
  }
  cp_async_wait_all();
  __syncthreads();

  // 2. per-channel sum and max of each row of the band, in an order that
  // W and C fix: thread (k, v) of a row takes vector v (channels
  // 8v..8v+7) of the columns k, k + tpr, ...; a butterfly folds the k of
  // a warp, and the warps' groups are added in order after the barrier
  const int kpw = vpp >= 32 ? 1 : 32 / vpp;   // k per warp
  const int kf = min(tpr, kpw);               // k folded by the butterfly
  const int ng = tpr / kf;                    // k groups per row
  float* s_rmax = s_red + band * ng * C;
  {
    const int lpr = tpr * vpp;                // threads per row
    const int v = tid & (vpp - 1);
    const int k = (tid >> vshift) & (tpr - 1);
    for (int base = 0; base < nrows * lpr; base += kThreads) {  // uniform trip count
      const int y = (base + tid) / lpr;
      float s[8], m[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        s[j] = 0.0f;
        m[j] = -INFINITY;
      }
      if (y < nrows) {
        for (int px = k; px < W; px += tpr) {
          float f[8];
          unpack8(s_x[((y * W + px) << vshift) + v], f);
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            s[j] += f[j];
            m[j] = fmaxf(m[j], f[j]);
          }
        }
      }
      for (int o = vpp; o < vpp * kf; o <<= 1) {
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          s[j] += __shfl_xor_sync(0xffffffffu, s[j], o);
          m[j] = fmaxf(m[j], __shfl_xor_sync(0xffffffffu, m[j], o));
        }
      }
      if (y < nrows && (k & (kf - 1)) == 0) {
        const int r = (y * ng + k / kf) * C + v * 8;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          s_red[r + j] = s[j];
          s_rmax[r + j] = m[j];
        }
      }
    }
  }
  __syncthreads();
  for (int i = tid; i < nrows * C; i += kThreads) {  // i = y * C + c
    const int r = (i / C) * ng * C + (i & (C - 1));
    float s = 0.0f;
    float m = -INFINITY;
    for (int q = 0; q < ng; ++q) {
      s += s_red[r + q * C];
      m = fmaxf(m, s_rmax[r + q * C]);
    }
    s_psum[i] = s;
    s_rmax[r] = m;
  }
  __syncthreads();
  for (int c = tid; c < C; c += kThreads) {
    float m = -INFINITY;
    for (int y = 0; y < nrows; ++y) m = fmaxf(m, s_rmax[y * ng * C + c]);
    s_pmax[c] = m;
  }
  cluster.sync();

  // 3. the image's channel sums from every row's, read through DSMEM from
  // the ranks that own them: thread (q, c) adds the rows of chunk q in
  // order, and the chunks are added in order; the chunks are the image's,
  // whatever the band.  The maxima are every rank's.
  float* s_all = s_red;                       // the row partials are done with
  {
    const int parts = C >= kThreads ? 1 : kThreads / C;
    const int chunk = (H + parts - 1) / parts;
    for (int i = tid; i < parts * C; i += kThreads) {  // i = q * C + c
      const int c = i & (C - 1);
      const int y1 = min(H, (i / C + 1) * chunk);
      float s = 0.0f;
#pragma unroll 4
      for (int y = (i / C) * chunk; y < y1; ++y) {
        const int owner = y / band;
        s += cluster.map_shared_rank(s_psum, owner)[(y - owner * band) * C + c];
      }
      s_all[i] = s;
    }
    __syncthreads();
    for (int c = tid; c < C; c += kThreads) {
      float s = 0.0f;
      float m = -INFINITY;
      for (int q = 0; q < parts; ++q) s += s_all[q * C + c];
      for (int r = 0; r < n_ranks; ++r) m = fmaxf(m, cluster.map_shared_rank(s_pmax, r)[c]);
      s_avg[c] = s / static_cast<float>(H * W);
      s_mx[c] = m;
    }
  }
  __syncthreads();
  // the chunk sums are done with: their bytes become the window
  for (int i = tid; i < 2 * plane; i += kThreads) s_win[i] = 0.0f;
  for (int j = warp; j < hid; j += kWarps) {
    float a = 0.0f;
    float m = 0.0f;
    for (int c = lane; c < C; c += 32) {
      const float wv = s_fc1[j * C + c];
      a += s_avg[c] * wv;
      m += s_mx[c] * wv;
    }
    for (int o = 16; o > 0; o >>= 1) {
      a += __shfl_xor_sync(0xffffffffu, a, o);
      m += __shfl_xor_sync(0xffffffffu, m, o);
    }
    if (lane == 0) {
      s_hav[j] = fmaxf(a, 0.0f);
      s_hmx[j] = fmaxf(m, 0.0f);
    }
  }
  __syncthreads();
  for (int c = tid; c < C; c += kThreads) {
    float a = 0.0f;
    float m = 0.0f;
    for (int j = 0; j < hid; ++j) {
      const float wv = s_fc2[j * C + c];
      a += s_hav[j] * wv;
      m += s_hmx[j] * wv;
    }
    s_gate[c] = sigmoidf(a + m);
  }
  __syncthreads();

  // 4. per-pixel channel mean and max of x*cg: g lanes per pixel; lane u
  // takes the vectors v = u (mod g), starting at one that the pixel's
  // place in the image picks, so that neighbouring pixels read different
  // banks
  {
    const int per = kThreads / g;
    const int nv = vpp / g;                // vectors per lane
    const int u = tid & (g - 1);
    const int q = tid / g;
    const float4* gate4 = reinterpret_cast<const float4*>(s_gate);
    for (int base = 0; base < npix; base += per) {  // uniform trip count
      const int p = base + q;
      float s = 0.0f;
      float m = -INFINITY;
      if (p < npix) {
        for (int j = 0; j < nv; ++j) {
          const int v = u + g * ((j + p + row0 * W) & (nv - 1));
          float f[8];
          unpack8(s_x[(p << vshift) + v], f);
          const float4 g0 = gate4[2 * v];
          const float4 g1 = gate4[2 * v + 1];
          const float gv[8] = {g0.x, g0.y, g0.z, g0.w, g1.x, g1.y, g1.z, g1.w};
#pragma unroll
          for (int k = 0; k < 8; ++k) {
            const float val = f[k] * gv[k];
            s += val;
            m = fmaxf(m, val);
          }
        }
      }
      for (int o = g >> 1; o > 0; o >>= 1) {
        s += __shfl_xor_sync(0xffffffffu, s, o);
        m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
      }
      if (p < npix && u == 0) {
        const int ly = p / W;
        const int i = (3 + ly) * ws + 3 + (p - ly * W);
        s_win[i] = s / static_cast<float>(C);
        s_win[plane + i] = m;
      }
    }
  }
  cluster.sync();

  // 5. halo rows (3 above, 3 below) from the ranks that own them; rows
  // beyond the image stay zero
  if (nrows > 0) {
    for (int i = tid; i < 12 * W; i += kThreads) {
      const int px = i % W;
      const int t = i / W;
      const int pl = t & 1;
      const int hr = t >> 1;                         // 0..5
      const int wr = hr < 3 ? hr : nrows + hr;       // window row
      const int y = row0 - 3 + wr;
      if (y >= 0 && y < H) {
        const int owner = y / band;
        const float* src = cluster.map_shared_rank(s_win, owner);
        s_win[pl * plane + wr * ws + 3 + px] =
            src[pl * plane + (3 + y - owner * band) * ws + 3 + px];
      }
    }
  }
  cluster_arrive();  // done reading the other ranks' shared memory
  __syncthreads();

  // 6. 7x7 conv and sigmoid: the spatial gate of each pixel of the band
  for (int p = tid; p < npix; p += kThreads) {
    const int ly = p / W;
    const int px = p - ly * W;
    float acc = 0.0f;
#pragma unroll
    for (int ky = 0; ky < 7; ++ky) {
#pragma unroll
      for (int kx = 0; kx < 7; ++kx) {
        const int i = (ly + ky) * ws + px + kx;
        acc = acc + s_w[(ky * 7 + kx) * 2 + 0] * s_win[i];
        acc = acc + s_w[(ky * 7 + kx) * 2 + 1] * s_win[plane + i];
      }
    }
    s_sg[p] = sigmoidf(acc);
  }
  __syncthreads();

  // 7. out = x*cg*sg [+ residual, ReLU], 16 bytes per thread and step
  {
    const uint4* rsrc = res != nullptr ? reinterpret_cast<const uint4*>(res + off0)
                                       : nullptr;
    uint4* dst = reinterpret_cast<uint4*>(out + off0);
    const float4* gate4 = reinterpret_cast<const float4*>(s_gate);
#pragma unroll 4
    for (int i = tid; i < n16; i += kThreads) {
      const int p = i >> vshift;
      const int v = i & (vpp - 1);
      uint4 rv = make_uint4(0, 0, 0, 0);
      if (rsrc != nullptr) rv = __ldg(rsrc + i);
      float f[8];
      unpack8(s_x[i], f);
      const float4 g0 = gate4[2 * v];
      const float4 g1 = gate4[2 * v + 1];
      const float gv[8] = {g0.x, g0.y, g0.z, g0.w, g1.x, g1.y, g1.z, g1.w};
      const float sg = s_sg[p];
#pragma unroll
      for (int j = 0; j < 8; ++j) f[j] = f[j] * gv[j] * sg;
      if (rsrc != nullptr) {
        float r[8];
        unpack8(rv, r);
#pragma unroll
        for (int j = 0; j < 8; ++j) f[j] = fmaxf(f[j] + r[j], 0.0f);
      }
      dst[i] = pack8(f);
    }
  }
  cluster_wait();
}

// The site rule's CTAs per image: the site table, or the smallest power
// of two whose band fits kBandBytes.
int site_ranks(long long H, long long W, long long C) {
  int r = 0;
  for (const auto& s : kSiteRanks) {
    if (s[0] == H && s[1] == W && s[2] == C) r = s[3];
  }
  if (r == 0) {
    r = 1;
    while (r < kMaxRanks && r < H && (H + r - 1) / r * W * C * 2 > kBandBytes) r *= 2;
  }
  return r;
}

// CTAs per image: the site rule's, then doubled while the doubled grid
// still has no more CTAs than the card has SMs, so that a small batch does
// not leave SMs idle.
int pick_ranks(long long B, long long H, long long W, long long C, int n_sm) {
  int r = site_ranks(H, W, C);
  while (2 * B * r <= n_sm && 2 * r <= kMaxRanks && 2 * r <= H) r *= 2;
  return r;
}

// Step 2's threads per row and vector: about 8 columns each, a power of
// two, a row's threads within the block.
int row_threads(long long W, long long C) {
  int t = 1;
  while (16LL * t <= W && 2LL * t * (C / 8) <= kThreads) t *= 2;
  return t;
}

// Step 4's lanes per pixel: as many as keep all threads busy over a band
// of the site rule's R, which the batch does not change.
int pool_lanes(long long H, long long W, long long C) {
  const long long r = site_ranks(H, W, C);
  const long long npix = (H + r - 1) / r * W;
  int g = 1;
  while (g < C / 8 && g < 32 && npix * g * 2 <= kThreads) g <<= 1;
  return g;
}

// Host state of one card, kept per device (the runtime's current device,
// which the wrapper sets to the maps' card): its attributes are read and
// both kernels' cluster attribute set once; a kernel's shared-memory
// attribute, which applies to the current device only, only grows; each
// (kernel, R, bytes) configuration's cluster occupancy is asked once,
// before its first launch there.
struct Placed {
  int wdtype, ranks;
  long long smem;
  int clusters;
};
struct DeviceState {
  Placed placed[32];
  int n_placed;
  long long smem_attr[2];   // per weight dtype code
  int optin;
  int n_sm;
};
DeviceState g_devices[kMaxDevices];

// the kernel that reads weights of dtype code wdtype
const void* kernel_of(int wdtype) {
  return wdtype == kWeightBf16
             ? reinterpret_cast<const void*>(cbam_cluster_kernel<__nv_bfloat16>)
             : reinterpret_cast<const void*>(cbam_cluster_kernel<float>);
}

// The current device's state, its attributes read at first use.
int device_state(DeviceState** out) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev < 0 || dev >= kMaxDevices) return kErrDevice;
  DeviceState* d = &g_devices[dev];
  if (d->n_sm == 0) {
    err = cudaDeviceGetAttribute(&d->optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err != cudaSuccess) return static_cast<int>(err);
    for (int t = kWeightF32; t <= kWeightBf16; ++t) {
      err = cudaFuncSetAttribute(kernel_of(t),
                                 cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    err = cudaDeviceGetAttribute(&d->n_sm, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  *out = d;
  return 0;
}

struct Config {
  int ranks, band, clusters, tpr, g;
  long long smem;
};

int configure(long long B, long long H, long long W, long long C, long long hid,
              int wdtype, int ranks, Config* cfg) {
  const long long vpp = C / 8;
  if (B < 1 || H < 1 || W < 1 || hid < 0 || C % 8 != 0 || vpp < 1
      || (vpp & (vpp - 1)) != 0 || kThreads % vpp != 0 || H * W >= (1LL << 24)
      || ranks < 0 || ranks > kMaxRanks) {
    return kErrShape;
  }
  if (wdtype != kWeightF32 && wdtype != kWeightBf16) return kErrDtype;
  DeviceState* d = nullptr;
  const int state_err = device_state(&d);
  if (state_err != 0) return state_err;
  cudaError_t err;
  const int r = ranks > 0 ? ranks : pick_ranks(B, H, W, C, d->n_sm);
  const long long band = (H + r - 1) / r;
  if (band * W * C * 2 > d->optin) return kErrSmem;
  const int tpr = row_threads(W, C);
  const long long smem = layout(r, static_cast<int>(band), static_cast<int>(H),
                                static_cast<int>(W), static_cast<int>(C),
                                static_cast<int>(hid), tpr).bytes;
  if (smem > d->optin) return kErrSmem;
  if (smem > d->smem_attr[wdtype]) {
    err = cudaFuncSetAttribute(kernel_of(wdtype),
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    d->smem_attr[wdtype] = smem;
  }
  int clusters = -1;
  for (int i = 0; i < d->n_placed; ++i) {
    const Placed& p = d->placed[i];
    if (p.wdtype == wdtype && p.ranks == r && p.smem == smem) clusters = p.clusters;
  }
  if (clusters < 0) {
    cudaLaunchConfig_t lc = {};
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = r;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    lc.gridDim = dim3(r);
    lc.blockDim = dim3(kThreads);
    lc.dynamicSmemBytes = static_cast<size_t>(smem);
    lc.attrs = attr;
    lc.numAttrs = 1;
    err = cudaOccupancyMaxActiveClusters(&clusters, kernel_of(wdtype), &lc);
    if (err != cudaSuccess) return static_cast<int>(err);
    d->placed[d->n_placed % 32] = Placed{wdtype, r, smem, clusters};
    if (d->n_placed < 32) ++d->n_placed;
  }
  if (clusters < 1) return kErrCluster;
  *cfg = Config{r, static_cast<int>(band), clusters, tpr, pool_lanes(H, W, C), smem};
  return 0;
}

template <typename Wt>
cudaError_t launch(const cudaLaunchConfig_t& lc, const void* x, const void* res,
                   const void* fc1, const void* fc2, const void* spw, long long sc,
                   long long sy, long long sx, void* out, long long H,
                   long long W, long long C, long long hid, const Config& cfg) {
  return cudaLaunchKernelEx(
      &lc, cbam_cluster_kernel<Wt>, static_cast<const __nv_bfloat16*>(x),
      static_cast<const __nv_bfloat16*>(res), static_cast<const Wt*>(fc1),
      static_cast<const Wt*>(fc2), static_cast<const Wt*>(spw),
      static_cast<int>(sc), static_cast<int>(sy), static_cast<int>(sx),
      static_cast<__nv_bfloat16*>(out),
      static_cast<int>(H), static_cast<int>(W), static_cast<int>(C),
      static_cast<int>(hid), cfg.band, cfg.tpr, cfg.g);
}

}  // namespace

// The cluster configuration of a batch of B (H, W, C) maps: CTAs per
// image, shared-memory bytes per CTA, and how many such clusters the card
// holds at once, for weights of dtype code wdtype.  ranks = 0 takes the
// kernel's own choice; any other value exists only for
// cli/mfu_experiments --cluster-sweep.
extern "C" int cbam_fuse_config(long long B, long long H, long long W,
                                long long C, long long hid, int wdtype,
                                int ranks, int* out_ranks,
                                long long* out_smem, int* out_clusters) {
  Config cfg;
  const int err = configure(B, H, W, C, hid, wdtype, ranks, &cfg);
  if (err != 0) return err;
  *out_ranks = cfg.ranks;
  *out_smem = cfg.smem;
  *out_clusters = cfg.clusters;
  return 0;
}

// fc1, fc2, spw: the convs' weights where they are stored, all of dtype
// code wdtype; spw_sc, spw_sy, spw_sx: spw's element strides over
// (channel, row, column).
extern "C" int cbam_fuse_launch(const void* x, const void* res,
                                const void* fc1, const void* fc2,
                                const void* spw, long long spw_sc,
                                long long spw_sy, long long spw_sx,
                                void* out, long long B, long long H,
                                long long W, long long C, long long hid,
                                int wdtype, int ranks, void* stream) {
  Config cfg;
  int err = configure(B, H, W, C, hid, wdtype, ranks, &cfg);
  if (err != 0) return err;
  if (B * cfg.ranks >= (1LL << 31)) return kErrShape;
  cudaLaunchConfig_t lc = {};
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cfg.ranks;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  lc.gridDim = dim3(static_cast<unsigned>(B * cfg.ranks));
  lc.blockDim = dim3(kThreads);
  lc.dynamicSmemBytes = static_cast<size_t>(cfg.smem);
  lc.stream = static_cast<cudaStream_t>(stream);
  lc.attrs = attr;
  lc.numAttrs = 1;
  const cudaError_t e =
      wdtype == kWeightBf16
          ? launch<__nv_bfloat16>(lc, x, res, fc1, fc2, spw, spw_sc, spw_sy, spw_sx,
                                  out, H, W, C, hid, cfg)
          : launch<float>(lc, x, res, fc1, fc2, spw, spw_sc, spw_sy, spw_sx, out, H,
                          W, C, hid, cfg);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}
