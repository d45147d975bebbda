// K5: the RAFT update block without its mask head, hand-written for Hopper
// (sm_90a), as two entry points run once each per refinement iteration.
//
// Replaces the TPU kernels eemflow_tpu/ops/pallas/update_block.py
// motion_encoder_fused (pallas_call at :247) and gru_flowhead_fused (at
// :271), which walk row bands of the 1/8 grid through VMEM with whole
// weight tables resident and recompute a 5- or 6-row halo per band.
//
// What it computes (NHWC through strides; every conv pads its input with
// zeros, "same"):
//   update_block_motion_launch: c = relu(convc2(relu(convc1(corr))))
//     (1x1 324->256, 3x3 ->192), f = relu(convf2(relu(convf1(flow))))
//     (7x7 2->128, 3x3 ->64), motion = [relu(conv([c, f])) (3x3 ->126), flow];
//   update_block_gru_launch: for the 1x5 stage, then the 5x1 stage,
//     z = sigmoid(convz([h, inp, motion])), r = sigmoid(convr(...)),
//     q = tanh(convq([r*h, inp, motion])), h = (1 - z)*h + z*q;
//     then delta = conv2(relu(conv1(h))) (3x3 128->256, 3x3 ->2).
// bf16 mode rounds both operands of every product to bf16 (round to
// nearest even) and accumulates in float32, as the JAX bf16 mode does.
//
// Bound on this card: at ERAFT's 720x1280 grid (padded 736x1280, so 92x160
// at 1/8) one iteration does 78.8 GFLOP against ~68 MB of inputs, outputs
// and weights, so it is bound by float32 operations (1.18 ms at 67 TFLOP/s
// against 0.02 ms at 3.35 TB/s).  The weights (3.6 MB for the motion
// encoder, 7.1 MB for the GRU and flow head in float32) fit the 50 MB L2
// but not the 227 KB of shared memory a block may use, so the TPU design
// (whole weight tables and row bands on chip) does not carry over.  This
// design is the simple one:
//
//   * one templated implicit-GEMM direct convolution, launched once per
//     conv (5 launches for the motion encoder, 6 for the GRU and head):
//     M = pixels, N = output channels, K = taps x input channels;
//   * a CTA computes BM pixels x BN output channels (128 x 64, a thread
//     8 x 4; 64 x 8 for the 2-channel flow-head output), staging BK = 16
//     input channels of one tap and their weights in shared memory per
//     step, the next step's global loads issued into registers before the
//     current step's FMAs;
//   * a read outside the image returns zero, which is the zero padding;
//   * the conv reads its input through up to three base pointers with
//     their own strides, so [h, inp, motion] and [c, f] are never built;
//   * the epilogue adds the bias and either applies ReLU (and writes the
//     flow into motion's last two channels), or none, or the z/r gates
//     (one 256-wide conv: sigmoid, z stored, r*h stored for the q conv),
//     or tanh and the GRU combine (1 - z)*h + z*q;
//   * the intermediates go to scratch in device memory that the wrapper
//     allocates (L2-sized at 92x160).
//
// Left for later work: fusing the convs of a stage, tensor-core
// (mma/wgmma) inner loops with TF32 or bf16 operands, and keeping the
// weights' L2 residency across the loop.
//
// Weights arrive packed [KH*KW*cin][cout_pad] (tap-major, input channel
// inner, cout padded to a multiple of 64 with zeros), already rounded to
// bf16 in bf16 mode.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BK = 16;
constexpr int MAX_SRC = 3;
constexpr int NCONV = 11;

enum Epilogue { EPI_RELU = 0, EPI_LINEAR = 1, EPI_ZR = 2, EPI_GRU = 3 };

}  // namespace

// A tensor seen as (b, y, x, c) with element strides; mirrored by _T4 in
// kernels/update_block.py.
struct T4 {
  float* p;
  long long sb, sy, sx, sc;
};

// Mirrored field for field by the ctypes Structure in kernels/update_block.py.
struct UpdateBlockArgs {
  T4 corr, flow, net, inp;         // inputs
  T4 motion, net_out, delta;       // outputs (motion: out of the first entry, in to the second)
  T4 c1, c2, f1, f2, z, rh, h1, d1;  // scratch
  const float* w[NCONV];           // convc1, convc2, convf1, convf2, conv, zr1, q1, zr2, q2, head1, head2
  const float* b[NCONV];
  int cout_pad[NCONV];
  int B, H, W, corr_c, hidden, context, bf16;
};

namespace {

struct Src {
  T4 t;
  int C;
};

struct ConvDesc {
  Src src[MAX_SRC];
  int nsrc;
  const float* w;
  const float* bias;
  int KH, KW, cin, cout, cout_pad;
  int epi;
  T4 out;
  T4 out2;   // EPI_ZR: r*h
  T4 hsrc;   // EPI_ZR, EPI_GRU: the stage's h
  T4 zbuf;   // EPI_GRU: z
  T4 copy;   // EPI_RELU: channels [cout, cout + ncopy) of out copied from here
  int ncopy;
  int B, H, W, bf16;
};

__device__ __forceinline__ float* at(const T4& t, int b, int y, int x, int c) {
  return t.p + b * t.sb + y * t.sy + x * t.sx + c * t.sc;
}

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

template <int BM, int BN, int TM, int TN>
__global__ void __launch_bounds__((BM / TM) * (BN / TN))
conv_kernel(const ConvDesc d) {
  constexpr int NT = (BM / TM) * (BN / TN);
  constexpr int AE = BM * BK / NT;  // A elements per thread per step
  constexpr int BE = BK * BN / NT;  // B elements per thread per step
  static_assert(BM * BK % NT == 0 && BK * BN % NT == 0 && NT % BK == 0, "tile shape");
  static_assert(TM % 4 == 0 && TN % 2 == 0, "vector reads of the tiles");
  __shared__ __align__(16) float As[BK][BM + 4];
  __shared__ __align__(16) float Bs[BK][BN];
  __shared__ int pb[BM], py[BM], px[BM];

  const int t = threadIdx.x;
  const int M = d.B * d.H * d.W;
  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  for (int i = t; i < BM; i += NT) {
    const int m = m0 + i;
    if (m < M) {
      px[i] = m % d.W;
      py[i] = (m / d.W) % d.H;
      pb[i] = m / (d.W * d.H);
    } else {  // beyond the last pixel: every read falls outside the image
      px[i] = 0;
      py[i] = -(1 << 20);
      pb[i] = 0;
    }
  }

  // the K steps, in order: tap, then source, then BK channels of it
  int steps_per_tap = 0;
  for (int s = 0; s < d.nsrc; ++s) steps_per_tap += (d.src[s].C + BK - 1) / BK;
  const int nsteps = d.KH * d.KW * steps_per_tap;

  const int kk_a = t % BK;  // the A channel this thread loads (NT % BK == 0)
  float ra[AE], rb[BE];

  auto load = [&](int step) {
    const int tap = step / steps_per_tap;
    int r = step - tap * steps_per_tap;
    int s = 0, cbase = 0;
    while (r >= (d.src[s].C + BK - 1) / BK) {
      r -= (d.src[s].C + BK - 1) / BK;
      cbase += d.src[s].C;
      ++s;
    }
    const Src& S = d.src[s];
    const int c0 = r * BK;
    const int dy = tap / d.KW - d.KH / 2;
    const int dx = tap % d.KW - d.KW / 2;
    const int c = c0 + kk_a;
#pragma unroll
    for (int i = 0; i < AE; ++i) {
      const int mm = t / BK + i * (NT / BK);
      const int y = py[mm] + dy;
      const int x = px[mm] + dx;
      float v = 0.f;
      if (c < S.C && y >= 0 && y < d.H && x >= 0 && x < d.W) v = __ldg(at(S.t, pb[mm], y, x, c));
      ra[i] = d.bf16 ? round_bf16(v) : v;
    }
    const long long krow = (long long)tap * d.cin + cbase + c0;
#pragma unroll
    for (int i = 0; i < BE; ++i) {
      const int e = t + i * NT;
      const int kk = e / BN;
      const int nn = e % BN;
      rb[i] = c0 + kk < S.C ? __ldg(d.w + (krow + kk) * d.cout_pad + n0 + nn) : 0.f;
    }
  };

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  const int tx = t % (BN / TN);
  const int ty = t / (BN / TN);
  __syncthreads();  // the pixel tables
  if (nsteps > 0) load(0);
  for (int step = 0; step < nsteps; ++step) {
#pragma unroll
    for (int i = 0; i < AE; ++i) As[kk_a][t / BK + i * (NT / BK)] = ra[i];
#pragma unroll
    for (int i = 0; i < BE; ++i) {
      const int e = t + i * NT;
      Bs[e / BN][e % BN] = rb[i];
    }
    __syncthreads();
    if (step + 1 < nsteps) load(step + 1);
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float a[TM], bv[TN];
      // vector reads: a thread's pixels and channels are adjacent and
      // 8- or 16-byte aligned (rows of BM + 4 and BN floats)
#pragma unroll
      for (int i = 0; i < TM; i += 4) {
        const float4 v = *reinterpret_cast<const float4*>(&As[kk][ty * TM + i]);
        a[i] = v.x;
        a[i + 1] = v.y;
        a[i + 2] = v.z;
        a[i + 3] = v.w;
      }
      if constexpr (TN % 4 == 0) {
#pragma unroll
        for (int j = 0; j < TN; j += 4) {
          const float4 v = *reinterpret_cast<const float4*>(&Bs[kk][tx * TN + j]);
          bv[j] = v.x;
          bv[j + 1] = v.y;
          bv[j + 2] = v.z;
          bv[j + 3] = v.w;
        }
      } else {
#pragma unroll
        for (int j = 0; j < TN; j += 2) {
          const float2 v = *reinterpret_cast<const float2*>(&Bs[kk][tx * TN + j]);
          bv[j] = v.x;
          bv[j + 1] = v.y;
        }
      }
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int mm = ty * TM + i;
    if (m0 + mm >= M) continue;
    const int b = pb[mm], y = py[mm], x = px[mm];
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int n = n0 + tx * TN + j;
      const float v = acc[i][j] + d.bias[n];
      switch (d.epi) {
        case EPI_RELU:
          if (n < d.cout) *at(d.out, b, y, x, n) = fmaxf(v, 0.f);
          else if (n < d.cout + d.ncopy) *at(d.out, b, y, x, n) = *at(d.copy, b, y, x, n - d.cout);
          break;
        case EPI_LINEAR:
          if (n < d.cout) *at(d.out, b, y, x, n) = v;
          break;
        case EPI_ZR: {
          const int half = d.cout / 2;
          const float s = 1.f / (1.f + expf(-v));
          if (n < half) *at(d.out, b, y, x, n) = s;
          else if (n < d.cout) *at(d.out2, b, y, x, n - half) = s * *at(d.hsrc, b, y, x, n - half);
          break;
        }
        case EPI_GRU:
          if (n < d.cout) {
            const float q = tanhf(v);
            const float z = *at(d.zbuf, b, y, x, n);
            const float h = *at(d.hsrc, b, y, x, n);
            *at(d.out, b, y, x, n) = (1.f - z) * h + z * q;
          }
          break;
      }
    }
  }
}

// the N extent a launch covers: the conv's outputs and the copied channels
int n_tiles(const ConvDesc& d, int bn) { return (d.cout + d.ncopy + bn - 1) / bn; }

cudaError_t run(const ConvDesc& d, cudaStream_t stream) {
  const int M = d.B * d.H * d.W;
  if (d.cout + d.ncopy <= 8) {
    dim3 grid((M + 63) / 64, n_tiles(d, 8));
    conv_kernel<64, 8, 4, 2><<<grid, (64 / 4) * (8 / 2), 0, stream>>>(d);
  } else {
    dim3 grid((M + 127) / 128, n_tiles(d, 64));
    conv_kernel<128, 64, 8, 4><<<grid, (128 / 8) * (64 / 4), 0, stream>>>(d);
  }
  return cudaGetLastError();
}

ConvDesc conv(const UpdateBlockArgs* a, int i, int KH, int KW, int cout, int epi, T4 out) {
  ConvDesc d = {};
  d.w = a->w[i];
  d.bias = a->b[i];
  d.cout_pad = a->cout_pad[i];
  d.KH = KH;
  d.KW = KW;
  d.cout = cout;
  d.epi = epi;
  d.out = out;
  d.B = a->B;
  d.H = a->H;
  d.W = a->W;
  d.bf16 = a->bf16;
  return d;
}

void add_src(ConvDesc& d, T4 t, int C) {
  d.src[d.nsrc].t = t;
  d.src[d.nsrc].C = C;
  d.nsrc += 1;
  d.cin += C;
}

}  // namespace

extern "C" int update_block_motion_launch(const UpdateBlockArgs* a, cudaStream_t stream) {
  cudaError_t e;
  ConvDesc d = conv(a, 0, 1, 1, 256, EPI_RELU, a->c1);
  add_src(d, a->corr, a->corr_c);
  if ((e = run(d, stream)) != cudaSuccess) return (int)e;
  d = conv(a, 1, 3, 3, 192, EPI_RELU, a->c2);
  add_src(d, a->c1, 256);
  if ((e = run(d, stream)) != cudaSuccess) return (int)e;
  d = conv(a, 2, 7, 7, 128, EPI_RELU, a->f1);
  add_src(d, a->flow, 2);
  if ((e = run(d, stream)) != cudaSuccess) return (int)e;
  d = conv(a, 3, 3, 3, 64, EPI_RELU, a->f2);
  add_src(d, a->f1, 128);
  if ((e = run(d, stream)) != cudaSuccess) return (int)e;
  d = conv(a, 4, 3, 3, 126, EPI_RELU, a->motion);
  add_src(d, a->c2, 192);
  add_src(d, a->f2, 64);
  d.copy = a->flow;
  d.ncopy = 2;
  return (int)run(d, stream);
}

extern "C" int update_block_gru_launch(const UpdateBlockArgs* a, cudaStream_t stream) {
  cudaError_t e;
  const int hd = a->hidden;
  const T4 h_in[2] = {a->net, a->h1};
  const T4 h_out[2] = {a->h1, a->net_out};
  for (int stage = 0; stage < 2; ++stage) {
    const int KH = stage == 0 ? 1 : 5;
    const int KW = stage == 0 ? 5 : 1;
    ConvDesc d = conv(a, 5 + 2 * stage, KH, KW, 2 * hd, EPI_ZR, a->z);
    add_src(d, h_in[stage], hd);
    add_src(d, a->inp, a->context);
    add_src(d, a->motion, 128);
    d.out2 = a->rh;
    d.hsrc = h_in[stage];
    if ((e = run(d, stream)) != cudaSuccess) return (int)e;
    d = conv(a, 6 + 2 * stage, KH, KW, hd, EPI_GRU, h_out[stage]);
    add_src(d, a->rh, hd);
    add_src(d, a->inp, a->context);
    add_src(d, a->motion, 128);
    d.zbuf = a->z;
    d.hsrc = h_in[stage];
    if ((e = run(d, stream)) != cudaSuccess) return (int)e;
  }
  ConvDesc d = conv(a, 9, 3, 3, 256, EPI_RELU, a->d1);
  add_src(d, a->net_out, hd);
  if ((e = run(d, stream)) != cudaSuccess) return (int)e;
  d = conv(a, 10, 3, 3, 2, EPI_LINEAR, a->delta);
  add_src(d, a->d1, 256);
  return (int)run(d, stream);
}

extern "C" int update_block_args_size() { return (int)sizeof(UpdateBlockArgs); }
