// K4: EEMFlow's whole coarse stage in one launch, hand-written for Hopper
// (sm_90a).
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
// by float32 operations (0.0043 ms at 67 TFLOP/s).  The design:
//
//   * one CTA per (level, sample): the three levels run side by side and a
//     CTA owns its level's whole chain, so nothing is exchanged between
//     CTAs until the 1x1 fuse;
//   * the activations ping-pong between two buffers of [cap][h][w] floats
//     in shared memory (2 * 100 * 240 * 4 B = 192 KB at 12x20, under the
//     227 KB a block may opt into), with __syncthreads() between convs;
//     larger grids use a device-memory scratch the CTA owns (L2-resident);
//   * the grouped convs stay grouped (20 inputs per output, not the 100 of
//     the dense form the TPU needed), and each channel shuffle is done at
//     the store: conv2-4 write output channel co at sigma^-1(co) =
//     (co % (C/g)) * g + co / (C/g), so the buffer holds the shuffled
//     tensor the next conv reads in order;
//   * a thread computes PIX=4 neighbouring pixels x COT output channels
//     (4 where the group width allows), reading weights as broadcasts;
//   * the 1x1 fuse is done by the last of a sample's three CTAs to finish
//     (a device-memory counter per sample, reset by that CTA), which reads
//     the three 2-channel flows back from a small scratch.
//
// At B=1 the launch uses 3 of the card's 132 SMs: the stage's latency is
// one CTA's walk through one decoder.

#include <cuda_runtime.h>

namespace {

constexpr int NLEV = 3;
constexpr int NCONV = 8;  // rconv, conv1 .. conv7
constexpr int MAXK = 81;
constexpr int PIX = 4;
constexpr int THREADS = 512;

}  // namespace

// Mirrored field for field by the ctypes Structure in kernels/coarse_head.py.
struct CoarseHeadArgs {
  const float* f1[NLEV];  // pooled features of frame 1, element (b, c, y, x)
  const float* f2[NLEV];  // at b*s[0] + c*s[1] + y*s[2] + x*s[3]
  const float* wt[NLEV][NCONV];    // packed [cin / groups][9][cout_pad]
  const float* bias[NLEV][NCONV];  // [cout_pad]
  const float* wout;  // [2][6]
  const float* bout;  // [2]
  float* out;         // [B, h, w, 2]
  float* flows;       // [B, 3, 2, h, w] scratch
  float* act;         // [B * 3][2][cap * h * w] scratch, or null: shared memory
  int* counters;      // [B], zero between launches
  long long s1[NLEV][4];
  long long s2[NLEV][4];
  int B, h, w, K, md, cap, smem_bytes;
  int C[NLEV];
  int cout[NCONV], cout_pad[NCONV], groups[NCONV], cot[NCONV];
  int idx[MAXK];
};

namespace {

__device__ __forceinline__ float lrelu(float v) { return v > 0.f ? v : 0.1f * v; }

// 3x3 pad-1 conv of in (channel c, row y, column x at c*sc + y*sy + x*sx)
// into out[out_off + c'][h][w], c' = co, or sigma^-1(co) when shuffle_g > 1.
template <int COT>
__device__ void conv3x3(const float* in, int sc, int sy, int sx, int cin_pg, int groups,
                        int cout, int cpad, const float* __restrict__ wt,
                        const float* __restrict__ bias, int h, int w, bool relu,
                        int shuffle_g, float* out, int out_off) {
  const int ngx = (w + PIX - 1) / PIX;
  const int cout_pg = cpad / groups;
  const int items = (cpad / COT) * h * ngx;
  const int hw = h * w;
  for (int it = threadIdx.x; it < items; it += blockDim.x) {
    const int gx = it % ngx;
    const int rest = it / ngx;
    const int y = rest % h;
    const int co0 = (rest / h) * COT;
    const int x0 = gx * PIX;
    const int cbase = (co0 / cout_pg) * cin_pg;

    float acc[PIX][COT];
#pragma unroll
    for (int c = 0; c < COT; ++c) {
      const float bv = __ldg(bias + co0 + c);
#pragma unroll
      for (int p = 0; p < PIX; ++p) acc[p][c] = bv;
    }
    for (int ci = 0; ci < cin_pg; ++ci) {
      const float* ip = in + (cbase + ci) * sc;
      const float* wp = wt + ci * 9 * cpad + co0;
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
          const float* wk = wp + (ky * 3 + kx) * cpad;
          float wv[COT];
          if constexpr (COT % 4 == 0) {
#pragma unroll
            for (int q = 0; q < COT / 4; ++q) {
              const float4 t = __ldg(reinterpret_cast<const float4*>(wk) + q);
              wv[4 * q] = t.x;
              wv[4 * q + 1] = t.y;
              wv[4 * q + 2] = t.z;
              wv[4 * q + 3] = t.w;
            }
          } else {
#pragma unroll
            for (int c = 0; c < COT; ++c) wv[c] = __ldg(wk + c);
          }
#pragma unroll
          for (int c = 0; c < COT; ++c)
#pragma unroll
            for (int p = 0; p < PIX; ++p) acc[p][c] = fmaf(v[p + kx], wv[c], acc[p][c]);
        }
      }
    }
    const int cpg_shuffle = shuffle_g > 1 ? cout / shuffle_g : 1;
#pragma unroll
    for (int c = 0; c < COT; ++c) {
      const int co = co0 + c;
      if (co >= cout) break;
      const int dst = shuffle_g > 1 ? (co % cpg_shuffle) * shuffle_g + co / cpg_shuffle : co;
      float* op = out + (out_off + dst) * hw + y * w;
#pragma unroll
      for (int p = 0; p < PIX; ++p) {
        if (x0 + p >= w) break;
        op[x0 + p] = relu ? lrelu(acc[p][c]) : acc[p][c];
      }
    }
  }
}

__device__ void conv_any(int cot, const float* in, int sc, int sy, int sx, int cin_pg,
                         int groups, int cout, int cpad, const float* wt, const float* bias,
                         int h, int w, bool relu, int shuffle_g, float* out, int out_off) {
  if (cot == 4)
    conv3x3<4>(in, sc, sy, sx, cin_pg, groups, cout, cpad, wt, bias, h, w, relu, shuffle_g, out, out_off);
  else if (cot == 2)
    conv3x3<2>(in, sc, sy, sx, cin_pg, groups, cout, cpad, wt, bias, h, w, relu, shuffle_g, out, out_off);
  else
    conv3x3<1>(in, sc, sy, sx, cin_pg, groups, cout, cpad, wt, bias, h, w, relu, shuffle_g, out, out_off);
}

__global__ void __launch_bounds__(THREADS) coarse_head_kernel(const CoarseHeadArgs a) {
  extern __shared__ float smem[];
  __shared__ int s_last;
  const int l = blockIdx.x, b = blockIdx.y;
  const int h = a.h, w = a.w, hw = h * w;
  float* bufA = a.act ? a.act + (long long)(b * NLEV + l) * 2 * a.cap * hw : smem;
  float* bufB = bufA + a.cap * hw;
  const int C = a.C[l];
  const float* f1 = a.f1[l] + b * a.s1[l][0];
  const float* f2 = a.f2[l] + b * a.s2[l][0];
  const int c1 = (int)a.s1[l][1], y1 = (int)a.s1[l][2], x1 = (int)a.s1[l][3];
  const int c2 = (int)a.s2[l][1], y2s = (int)a.s2[l][2], x2s = (int)a.s2[l][3];

  // correlation -> channels [0, K) of A
  {
    const int win = 2 * a.md + 1;
    const float inv_c = 1.0f / (float)C;
    const int total = a.K * hw;
    for (int o = threadIdx.x; o < total; o += blockDim.x) {
      const int p = o % hw;
      const int j = o / hw;
      const int y = p / w, x = p % w;
      const int ch = a.idx[j];
      const int yy = y + ch / win - a.md, xx = x + ch % win - a.md;
      float acc = 0.f;
      if (yy >= 0 && yy < h && xx >= 0 && xx < w) {
        const float* p1 = f1 + y * y1 + x * x1;
        const float* p2 = f2 + yy * y2s + xx * x2s;
        for (int c = 0; c < C; ++c) acc = fmaf(p1[c * c1], p2[c * c2], acc);
      }
      bufA[o] = acc * inv_c;
    }
  }
  // rconv (f1 -> 16) -> channels [K, K + 16) of A
  conv_any(a.cot[0], f1, c1, y1, x1, C, 1, a.cout[0], a.cout_pad[0], a.wt[l][0], a.bias[l][0],
           h, w, true, 0, bufA, a.K);
  __syncthreads();

  // the decoder: conv1 .. conv7, ping-pong A <-> B
  int cin = a.K + a.cout[0];
  float* src = bufA;
  float* dst = bufB;
  for (int i = 1; i < NCONV - 1; ++i) {
    const int g = a.groups[i];
    const int shuffle_g = (i >= 2 && i <= 4) ? g : 0;
    conv_any(a.cot[i], src, hw, w, 1, cin / g, g, a.cout[i], a.cout_pad[i], a.wt[l][i],
             a.bias[l][i], h, w, true, shuffle_g, dst, 0);
    __syncthreads();
    cin = a.cout[i];
    float* t = src;
    src = dst;
    dst = t;
  }
  float* flow = a.flows + (long long)(b * NLEV + l) * 2 * hw;
  conv_any(a.cot[NCONV - 1], src, hw, w, 1, cin, 1, a.cout[NCONV - 1], a.cout_pad[NCONV - 1],
           a.wt[l][NCONV - 1], a.bias[l][NCONV - 1], h, w, false, 0, flow, 0);

  // the last of the sample's three CTAs fuses the flows (1x1 out_conv)
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) s_last = atomicAdd(a.counters + b, 1) == NLEV - 1;
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

}  // namespace

extern "C" int coarse_head_launch(const CoarseHeadArgs* a, cudaStream_t stream) {
  if (a->K < 0 || a->K > MAXK) return (int)cudaErrorInvalidValue;
  if (a->B == 0 || a->h * a->w == 0) return (int)cudaSuccess;
  const int smem = a->act ? 0 : a->smem_bytes;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        coarse_head_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  coarse_head_kernel<<<dim3(NLEV, a->B), THREADS, smem, stream>>>(*a);
  return (int)cudaGetLastError();
}

// lets the binding check that its mirror of the struct has the same size
extern "C" int coarse_head_args_size() { return (int)sizeof(CoarseHeadArgs); }
