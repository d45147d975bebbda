// K4: EEMFlow's whole coarse stage in one launch, hand-written for Hopper
// (sm_90a): one thread-block cluster per (level, sample).
//
// Replaces the TPU kernel eemflow_tpu/ops/pallas/coarse_head.py
// coarse_head (pallas_call at :333; per-level math in _level_flow :208,
// _sample_math :248), which holds every activation in VMEM and runs the
// convs as tap matmuls on the MXU with the grouped convs made dense
// (block-diagonal) and each channel shuffle folded into the next conv's
// weights.
//
// What it computes, per sample and for each of the three pooled levels l
// (grids [h, w], C_l = 16/32/64 channels):
//   corr  = the K selected displacements of the dy-major (2md+1)^2 window,
//           (1/C) * sum_c f1[c, y, x] * f2[c, y+dy, x+dx], zero outside;
//   r     = LeakyReLU(rconv_l(f1))                       (3x3, C_l -> 16)
//   flow_l = decoder_l([corr, r]): conv1 (K+16 -> 100), conv2-4 grouped
//           (100 -> 100, each followed by a channel shuffle), conv5
//           (-> 64), conv6 (-> 32), all LeakyReLU(0.1), conv7 (-> 2) linear;
// then out[b, y, x, :] = out_conv(cat(flow_1, flow_2, flow_3)) (1x1, 6 -> 2).
// Every 3x3 conv pads with zeros.
//
// Bound on this card: at 720x1280 (12x20 grids) a sample is ~0.29 GFLOP
// against ~2.4 MB of weights and 0.2 MB of features, so the stage is bound
// by float32 operations (0.0043 ms at 67 TFLOP/s).  What held the first
// version (one CTA per level) back was not the FMA rate but the SMs: three
// CTAs on 3 of the card's 132 SMs, each walking its level's 0.096 GFLOP
// alone and, inside a forward, pulling its 0.8 MB of weights cold from
// device memory through 16 warps.  The design:
//
//   * one cluster of R CTAs per (level, sample), R = 16 where the card
//     can place such a cluster at this shared memory (a non-portable size,
//     checked with cudaOccupancyMaxActiveClusters) and 8 otherwise, so the
//     stage runs on 3R SMs at B=1;
//   * the ranks split the output channels of every step: the 53 correlation
//     channels, the 16 of the rconv, and each conv's outputs in units of
//     COT channels that never straddle a group (the plan, with its K-split,
//     is made by kernels/coarse_head.py rank_plan).  Each rank computes its
//     slice over all of the level's pixels and stores it into every rank's
//     copy of the next activation buffer through distributed shared memory
//     (cluster.map_shared_rank), starting at its own rank so the ranks'
//     stores spread over the cluster; the grouped convs' channel shuffle is
//     done at that store: conv2-4 write output channel co at sigma^-1(co) =
//     (co % (C/g)) * g + co / (C/g);
//   * a cluster barrier (cluster.sync(): barrier.cluster.arrive.release /
//     wait.acquire) separates the steps: a rank's slice has landed in
//     every copy before any rank reads it, and every rank has read its
//     input before a peer overwrites it; one before the first store (every
//     peer's shared memory exists) and one after the last (no peer writes
//     into a CTA that has gone);
//   * the activations ping-pong between two buffers of [cap][h][w] floats
//     (2 * 100 * 240 * 4 B = 192 KB at 12x20); a grid whose buffers exceed
//     the 227 KB a block may hold uses one device-memory scratch per
//     (sample, level) that the ranks write once and all read;
//   * weights stay in device memory, packed per rank-contiguous unit
//     [cout / COT][cin / groups][9][COT], so a rank's slice of a conv is one
//     contiguous run: at kernel start each rank asks L2 for all of its runs
//     (prefetch.global.L2), so the fetch overlaps the correlation and the
//     rconv instead of stalling every conv on cold lines;
//   * a thread computes PIX=4 neighbouring pixels x COT output channels,
//     reading its weights as float4 broadcasts; where a rank's slice has
//     fewer items than threads, KS neighbouring lanes split the input
//     channels and add their sums with warp shuffles;
//   * conv7 (2 channels) writes the level's flow to a device-memory
//     scratch; the 1x1 fuse is done by rank 0 of the last of a sample's
//     three clusters to finish (a device-memory counter per sample, reset
//     by that CTA).
//
// Arithmetic stays float32 on the FMA units: the lever was SMs and cold
// weights, not the FMA rate.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "tensor_core.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int NLEV = 3;
constexpr int NCONV = 8;           // rconv, conv1 .. conv7
constexpr int NSTAGE = NCONV + 1;  // the correlation, then the convs
constexpr int MAXK = 81;
constexpr int MAXR = 16;
constexpr int PIX = 4;
constexpr int THREADS = 512;

}  // namespace

// Mirrored field for field by the ctypes Structure in kernels/coarse_head.py.
struct CoarseHeadArgs {
  const float* f1[NLEV];  // pooled features of frame 1, element (b, c, y, x)
  const float* f2[NLEV];  // at b*s[0] + c*s[1] + y*s[2] + x*s[3]
  const float* wt[NLEV][NCONV];    // packed [cout / cot][cin / groups][9][cot]
  const float* bias[NLEV][NCONV];  // [cout]
  const float* wout;  // [2][6]
  const float* bout;  // [2]
  float* out;         // [B, h, w, 2]
  float* flows;       // [B, 3, 2, h, w] scratch
  float* act;         // [B * 3][2][cap * h * w] scratch, or null: shared memory
  int* counters;      // [B], zero between launches
  long long s1[NLEV][4];
  long long s2[NLEV][4];
  int B, h, w, K, md, cap, smem_bytes, R;
  int w_smem;  // 0: weights read from device memory; else the bytes of each of two shared-memory weight buffers
  int C[NLEV];
  int cout[NCONV], groups[NCONV], cot[NCONV];
  int ks[NSTAGE];                // lanes that split a conv's input channels
  int bounds[NSTAGE][MAXR + 1];  // rank r computes channels [bounds[s][r], bounds[s][r + 1])
  int idx[MAXK];
};

namespace {

__device__ __forceinline__ float lrelu(float v) { return v > 0.f ? v : 0.1f * v; }

// The rank's output channels [c_begin, c_end) of a 3x3 pad-1 conv of `in`
// (channel c, row y, column x at c*sc + y*sy + x*sx), stored at channel
// out_off + c' of dst in each of `ncopies` ranks' shared memory (or once,
// in device memory, when ncopies is 1), c' = co or sigma^-1(co) when
// shuffle_g > 1.  Item = (COT channels, row, PIX columns); ks lanes share
// an item, each summing every ks-th input channel.
template <int COT>
__device__ void conv_slice(const float* in, int sc, int sy, int sx, int cin_pg, int cout_pg, int cout,
                           const float* __restrict__ wt, const float* __restrict__ bias, int h, int w,
                           bool relu, int shuffle_g, float* dst, int ncopies, int out_off, int c_begin,
                           int c_end, int ks, int unit0) {
  cg::cluster_group cluster = cg::this_cluster();
  const int me = ncopies > 1 ? (int)cluster.block_rank() : 0;
  const int ngx = (w + PIX - 1) / PIX;
  const int items = (c_end - c_begin) / COT * h * ngx;
  const int total = items * ks;
  const int hw = h * w;
  const bool vec = (w % PIX) == 0;
  const int unit_floats = cin_pg * 9 * COT;
  const int cpg_shuffle = shuffle_g > 1 ? cout / shuffle_g : 1;
  // t0 is the same in every thread, so all lanes of a warp run each
  // iteration and reach the shuffles together
  for (int t0 = 0; t0 < total; t0 += blockDim.x) {
    const int t = t0 + threadIdx.x;
    const int it = t / ks, part = t - it * ks;
    const bool valid = it < items;
    float acc[PIX][COT];
#pragma unroll
    for (int p = 0; p < PIX; ++p)
#pragma unroll
      for (int c = 0; c < COT; ++c) acc[p][c] = 0.f;
    int y = 0, x0 = 0, co0 = c_begin;
    if (valid) {
      const int gx = it % ngx;
      const int rest = it / ngx;
      y = rest % h;
      co0 = c_begin + (rest / h) * COT;
      x0 = gx * PIX;
      const float* wu = wt + (long long)(co0 / COT - unit0) * unit_floats;
      const int cbase = (co0 / cout_pg) * cin_pg;
      for (int ci = part; ci < cin_pg; ci += ks) {
        const float* ip = in + (cbase + ci) * sc;
        const float* wp = wu + ci * 9 * COT;
#pragma unroll
        for (int ky = 0; ky < 3; ++ky) {
          const int iy = y + ky - 1;
          if (iy < 0 || iy >= h) continue;
          float v[PIX + 2];
#pragma unroll
          for (int i = 0; i < PIX + 2; ++i) {
            const int xi = x0 - 1 + i;
            v[i] = (xi >= 0 && xi < w) ? ip[iy * sy + xi * sx] : 0.f;
          }
#pragma unroll
          for (int kx = 0; kx < 3; ++kx) {
            const float* wk = wp + (ky * 3 + kx) * COT;
            float wv[COT];
            if constexpr (COT == 4) {
              const float4 q = *reinterpret_cast<const float4*>(wk);
              wv[0] = q.x;
              wv[1] = q.y;
              wv[2] = q.z;
              wv[3] = q.w;
            } else if constexpr (COT == 2) {
              const float2 q = *reinterpret_cast<const float2*>(wk);
              wv[0] = q.x;
              wv[1] = q.y;
            } else {
              wv[0] = *wk;
            }
#pragma unroll
            for (int c = 0; c < COT; ++c)
#pragma unroll
              for (int p = 0; p < PIX; ++p) acc[p][c] = fmaf(v[p + kx], wv[c], acc[p][c]);
          }
        }
      }
    }
    for (int o = 1; o < ks; o <<= 1)
#pragma unroll
      for (int p = 0; p < PIX; ++p)
#pragma unroll
        for (int c = 0; c < COT; ++c) acc[p][c] += __shfl_xor_sync(0xffffffffu, acc[p][c], o);
    if (!valid || part != 0) continue;

    int dstc[COT];
#pragma unroll
    for (int c = 0; c < COT; ++c) {
      const int co = co0 + c;
      const float bv = __ldg(bias + co);
      dstc[c] = shuffle_g > 1 ? (co % cpg_shuffle) * shuffle_g + co / cpg_shuffle : co;
#pragma unroll
      for (int p = 0; p < PIX; ++p) {
        const float s = acc[p][c] + bv;
        acc[p][c] = relu ? lrelu(s) : s;
      }
    }
    for (int i = 0; i < ncopies; ++i) {
      float* base = ncopies > 1 ? cluster.map_shared_rank(dst, (me + i) % ncopies) : dst;
#pragma unroll
      for (int c = 0; c < COT; ++c) {
        float* op = base + (out_off + dstc[c]) * hw + y * w + x0;
        if (vec) {
          *reinterpret_cast<float4*>(op) = make_float4(acc[0][c], acc[1][c], acc[2][c], acc[3][c]);
        } else {
#pragma unroll
          for (int p = 0; p < PIX; ++p)
            if (x0 + p < w) op[p] = acc[p][c];
        }
      }
    }
  }
}

__device__ void conv_any(int cot, const float* in, int sc, int sy, int sx, int cin_pg, int cout_pg,
                         int cout, const float* wt, const float* bias, int h, int w, bool relu,
                         int shuffle_g, float* dst, int ncopies, int out_off, int c_begin, int c_end,
                         int ks, int unit0) {
  if (cot == 4)
    conv_slice<4>(in, sc, sy, sx, cin_pg, cout_pg, cout, wt, bias, h, w, relu, shuffle_g, dst, ncopies,
                  out_off, c_begin, c_end, ks, unit0);
  else if (cot == 2)
    conv_slice<2>(in, sc, sy, sx, cin_pg, cout_pg, cout, wt, bias, h, w, relu, shuffle_g, dst, ncopies,
                  out_off, c_begin, c_end, ks, unit0);
  else
    conv_slice<1>(in, sc, sy, sx, cin_pg, cout_pg, cout, wt, bias, h, w, relu, shuffle_g, dst, ncopies,
                  out_off, c_begin, c_end, ks, unit0);
}

// input channels of conv i of level l
__device__ __forceinline__ int conv_cin(const CoarseHeadArgs& a, int l, int i) {
  return i == 0 ? a.C[l] : i == 1 ? a.K + a.cout[0] : a.cout[i - 1];
}

// this rank's weights of conv i: one contiguous run (its units of
// [cout / cot][cin / groups][9][cot]), and its length in bytes
__device__ __forceinline__ const float* slice(const CoarseHeadArgs& a, int l, int i, int rank, int& bytes) {
  const int cot = a.cot[i], cin_pg = conv_cin(a, l, i) / a.groups[i];
  const int c0 = a.bounds[i + 1][rank];
  bytes = (a.bounds[i + 1][rank + 1] - c0) * cin_pg * 9 * 4;
  return a.wt[l][i] + (long long)(c0 / cot) * cin_pg * 9 * cot;
}

// every thread: its part of the copy of conv i's slice into shared memory
__device__ void stage_slice(const CoarseHeadArgs& a, int l, int i, int rank, float* dst) {
  int bytes;
  const float* src = slice(a, l, i, rank, bytes);
  const uint32_t d = tc::smem_u32(dst);
  if ((reinterpret_cast<uintptr_t>(src) | bytes) % 16 == 0) {
    for (int o = 16 * threadIdx.x; o < bytes; o += 16 * blockDim.x)
      tc::cp_async16(d + o, reinterpret_cast<const char*>(src) + o, 16);
  } else {
    for (int o = 4 * threadIdx.x; o < bytes; o += 4 * blockDim.x)
      tc::cp_async4(d + o, reinterpret_cast<const char*>(src) + o, 4);
  }
  tc::cp_async_commit();
}

__global__ void __launch_bounds__(THREADS, 1) coarse_head_kernel(const __grid_constant__ CoarseHeadArgs a) {
  extern __shared__ __align__(16) float smem[];
  __shared__ int s_last;
  cg::cluster_group cluster = cg::this_cluster();
  const int R = a.R;
  const int rank = (int)cluster.block_rank();
  const int l = blockIdx.x / R, b = blockIdx.y;
  const int h = a.h, w = a.w, hw = h * w;
  const bool in_smem = a.act == nullptr;
  const int ncopies = in_smem ? R : 1;
  float* bufA = in_smem ? smem : a.act + (long long)(b * NLEV + l) * 2 * a.cap * hw;
  float* bufB = bufA + a.cap * hw;

  // ask L2 for this rank's weights of every conv, one contiguous run each;
  // where they fit, the runs are staged into two shared-memory buffers,
  // conv i's in buffer i % 2, the next conv's copied while one runs
  for (int i = 0; i < NCONV; ++i) {
    int bytes;
    const char* p = reinterpret_cast<const char*>(slice(a, l, i, rank, bytes));
    for (int off = 128 * threadIdx.x; off < bytes; off += 128 * blockDim.x) tc::prefetch_l2(p + off);
  }
  float* const wbuf = smem + 2 * a.cap * hw;  // buffer b at wbuf + b * w_smem / 4
  auto wbuf_of = [&](int i) { return wbuf + (i % 2) * (a.w_smem / 4); };
  if (a.w_smem) {
    stage_slice(a, l, 0, rank, wbuf_of(0));
    stage_slice(a, l, 1, rank, wbuf_of(1));
  }
  // conv i's weights and the unit its first one is: in shared memory this
  // rank's slice, in device memory the whole conv
  auto weights = [&](int i) -> const float* { return a.w_smem ? wbuf_of(i) : a.wt[l][i]; };
  auto unit0 = [&](int i) { return a.w_smem ? a.bounds[i + 1][rank] / a.cot[i] : 0; };

  const int C = a.C[l];
  const float* f1 = a.f1[l] + b * a.s1[l][0];
  const float* f2 = a.f2[l] + b * a.s2[l][0];
  const int c1 = (int)a.s1[l][1], y1 = (int)a.s1[l][2], x1 = (int)a.s1[l][3];
  const int c2 = (int)a.s2[l][1], y2s = (int)a.s2[l][2], x2s = (int)a.s2[l][3];

  // the level's frame-1 features, read by the rconv and the correlation,
  // staged in this CTA's B buffer as [C][h][w] (B is not written until
  // conv1, after a cluster barrier); on the device-memory path B is
  // shared by the ranks, so they read the features where they lie
  const float* g1 = f1;
  int gc = c1, gy = y1, gx = x1;
  if (in_smem && C <= a.cap) {
    for (int o = threadIdx.x; o < C * hw; o += blockDim.x) {
      const int c = o / hw, p = o - c * hw;
      bufB[o] = f1[c * c1 + (p / w) * y1 + (p % w) * x1];
    }
    g1 = bufB;
    gc = hw;
    gy = w;
    gx = 1;
  }
  cluster.sync();  // every peer's shared memory exists before the first store into it

  // this rank's correlation channels -> channels [0, K) of A
  {
    const int win = 2 * a.md + 1;
    const float inv_c = 1.0f / (float)C;
    const int j0 = a.bounds[0][rank];
    const int total = (a.bounds[0][rank + 1] - j0) * hw;
    for (int o = threadIdx.x; o < total; o += blockDim.x) {
      const int p = o % hw;
      const int j = j0 + o / hw;
      const int y = p / w, x = p % w;
      const int ch = a.idx[j];
      const int yy = y + ch / win - a.md, xx = x + ch % win - a.md;
      float acc = 0.f;
      if (yy >= 0 && yy < h && xx >= 0 && xx < w) {
        const float* p1 = g1 + y * gy + x * gx;
        const float* p2 = f2 + yy * y2s + xx * x2s;
        // 16 channels' loads in flight, four partial sums
        float part[4] = {0.f, 0.f, 0.f, 0.f};
        int c = 0;
        for (; c + 16 <= C; c += 16) {
          float v2[16];
#pragma unroll
          for (int u = 0; u < 16; ++u) v2[u] = __ldg(p2 + (c + u) * c2);
#pragma unroll
          for (int u = 0; u < 16; ++u) part[u % 4] = fmaf(p1[(c + u) * gc], v2[u], part[u % 4]);
        }
        for (; c < C; ++c) part[0] = fmaf(p1[c * gc], __ldg(p2 + c * c2), part[0]);
        acc = (part[0] + part[1]) + (part[2] + part[3]);
      }
      acc *= inv_c;
      for (int i = 0; i < ncopies; ++i) {
        float* base = ncopies > 1 ? cluster.map_shared_rank(bufA, (rank + i) % ncopies) : bufA;
        base[j * hw + p] = acc;
      }
    }
  }
  if (a.w_smem) {  // the rconv's and conv1's weights have landed
    tc::cp_async_wait<0>();
    __syncthreads();
  }
  // rconv (f1 -> 16) -> channels [K, K + 16) of A
  conv_any(a.cot[0], g1, gc, gy, gx, C, a.cout[0], a.cout[0], weights(0), a.bias[l][0], h, w, true, 0, bufA,
           ncopies, a.K, a.bounds[1][rank], a.bounds[1][rank + 1], a.ks[1], unit0(0));
  cluster.sync();

  // the decoder: conv1 .. conv6, ping-pong A <-> B
  int cin = a.K + a.cout[0];
  float* src = bufA;
  float* dst = bufB;
  for (int i = 1; i < NCONV - 1; ++i) {
    const int g = a.groups[i];
    const int shuffle_g = (i >= 2 && i <= 4) ? g : 0;
    // conv i + 1's weights into the buffer conv i - 1 read
    if (a.w_smem) stage_slice(a, l, i + 1, rank, wbuf_of(i + 1));
    conv_any(a.cot[i], src, hw, w, 1, cin / g, a.cout[i] / g, a.cout[i], weights(i), a.bias[l][i], h, w, true,
             shuffle_g, dst, ncopies, 0, a.bounds[i + 1][rank], a.bounds[i + 1][rank + 1], a.ks[i + 1], unit0(i));
    if (a.w_smem) tc::cp_async_wait<0>();  // this thread's part; the barrier publishes the rest
    cluster.sync();
    cin = a.cout[i];
    float* t = src;
    src = dst;
    dst = t;
  }
  // conv7 -> the level's flow in device memory
  float* flow = a.flows + (long long)(b * NLEV + l) * 2 * hw;
  conv_any(a.cot[NCONV - 1], src, hw, w, 1, cin, a.cout[NCONV - 1], a.cout[NCONV - 1], weights(NCONV - 1),
           a.bias[l][NCONV - 1], h, w, false, 0, flow, 1, 0, a.bounds[NCONV][rank], a.bounds[NCONV][rank + 1],
           a.ks[NCONV], unit0(NCONV - 1));

  // the last cluster barrier: after it no rank touches a peer's shared
  // memory, and the level's flow is written
  __threadfence();
  cluster.sync();
  if (rank != 0) return;

  // rank 0 of the last of the sample's three clusters fuses the flows
  if (threadIdx.x == 0) {
    __threadfence();
    s_last = atomicAdd(a.counters + b, 1) == NLEV - 1;
  }
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  const float* fb = a.flows + (long long)b * NLEV * 2 * hw;
  for (int p = threadIdx.x; p < hw; p += blockDim.x) {
    float f[2 * NLEV];
#pragma unroll
    for (int k = 0; k < 2 * NLEV; ++k) f[k] = __ldcg(fb + k * hw + p);
#pragma unroll
    for (int o = 0; o < 2; ++o) {
      float acc = 0.f;
#pragma unroll
      for (int k = 0; k < 2 * NLEV; ++k) acc = fmaf(f[k], __ldg(a.wout + o * 2 * NLEV + k), acc);
      a.out[((long long)b * hw + p) * 2 + o] = acc + __ldg(a.bout + o);
    }
  }
  if (threadIdx.x == 0) a.counters[b] = 0;
}

// the launch configuration of a grid of B samples, clusters of R
cudaLaunchConfig_t config(int B, int R, int smem, cudaStream_t stream, cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(NLEV * R, B, 1);
  cfg.blockDim = dim3(THREADS, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = R;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// the kernel's attributes for this shared memory and cluster size, then
// how many such clusters the card can hold at once (0: none fits)
cudaError_t prepare(int R, int smem, int* clusters) {
  cudaError_t e = cudaFuncSetAttribute(coarse_head_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  if (R > 8) {
    e = cudaFuncSetAttribute(coarse_head_kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (e != cudaSuccess) return e;
  }
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = config(1, R, smem, 0, &attr);
  return cudaOccupancyMaxActiveClusters(clusters, coarse_head_kernel, &cfg);
}

// what the last launch prepared (prepare() sets attributes of the kernel,
// so a query for another size forgets it)
int last_dev = -1, last_r = 0, last_smem = -1, clusters = 0;

}  // namespace

extern "C" int coarse_head_launch(const CoarseHeadArgs* a, cudaStream_t stream) {
  if (a->K < 0 || a->K > MAXK || a->R < 1 || a->R > MAXR) return (int)cudaErrorInvalidValue;
  if (a->B == 0 || a->h * a->w == 0) return (int)cudaSuccess;
  const int smem = a->act ? 0 : a->smem_bytes;
  // the attributes and the occupancy query, redone when the device, the
  // cluster size or the shared memory differ from the last launch's
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev != last_dev || a->R != last_r || smem != last_smem) {
    last_dev = -1;
    e = prepare(a->R, smem, &clusters);
    if (e != cudaSuccess) return (int)e;
    last_dev = dev;
    last_r = a->R;
    last_smem = smem;
  }
  if (clusters < 1) return (int)cudaErrorInvalidConfiguration;  // no cluster of R fits this shared memory
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = config(a->B, a->R, smem, stream, &attr);
  e = cudaLaunchKernelEx(&cfg, coarse_head_kernel, *a);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// How many clusters of R CTAs with `smem` bytes of dynamic shared memory
// the card holds at once (0 when none fits), in *n; returns the
// cudaError_t of the query.
extern "C" int coarse_head_max_clusters(int R, int smem, int* n) {
  *n = 0;
  if (R < 1 || R > MAXR) return (int)cudaErrorInvalidValue;
  last_dev = -1;
  return (int)prepare(R, smem, n);
}

// threads, registers, local (spill) bytes of the kernel
extern "C" int coarse_head_kernel_info(int* info) {
  cudaFuncAttributes attr;
  const cudaError_t e = cudaFuncGetAttributes(&attr, coarse_head_kernel);
  if (e != cudaSuccess) return (int)e;
  info[0] = THREADS;
  info[1] = attr.numRegs;
  info[2] = (int)attr.localSizeBytes;
  return (int)cudaSuccess;
}

// lets the binding check that its mirror of the struct has the same size
extern "C" int coarse_head_args_size() { return (int)sizeof(CoarseHeadArgs); }
