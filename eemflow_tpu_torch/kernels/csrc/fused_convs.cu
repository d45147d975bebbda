// K3: a chain of 3x3 stride-1 pad-1 convs, then an optional average pool,
// hand-written for Hopper (sm_90a): the SIMT version.  EEMFlow's pyramid
// runs on the tensor-core version (fused_convs_tc.cu); this one serves the
// chains that one does not take, concat chains and channel counts that are
// not multiples of 16 (kernels/fused_convs.py chooses by the chain's shape).
//
// Replaces the TPU kernel eemflow_tpu/ops/pallas/fused_convs.py
// fused_convs_pool (pallas_call at :330), which walks row bands of the
// image through VMEM and runs each conv as im2col / tap matmuls on the MXU.
//
// What it computes (NCHW here; the public function is NHWC): for conv i,
//   y_i = bias_i + sum_{ci, ky, kx} w_i[co, ci, ky, kx] * in_i[ci, y+ky-1, x+kx-1]
// with in_i zero outside the image, LeakyReLU(0.1) where relu[i], and the
// next conv's input [y_i, in_i] where concat[i]; then the mean over each
// pool x pool window.  bf16 mode rounds both operands of every product
// to bf16 (round to nearest even) and accumulates in float32.
//
// Bound on this card: at EEMFlow's 720x1280 levels (padded 768x1280) the
// chain does 11.3 GFLOP per pair of frames against ~0.1 GB of input read
// and full output written, so it is bound by float32 operations (0.169 ms
// at 67 TFLOP/s against 0.031 ms at 3.35 TB/s).  The design keeps every
// intermediate on chip and reads each weight from L1 as a broadcast:
//
//   * one CTA per (sample, output tile).  With a pool the tile is one pool
//     window (32x32, 16x16 or 8x8 on EEMFlow's path), so the CTA reduces
//     its pooled cell itself: no atomics in device memory, no zero-fill;
//   * the input tile and an n-pixel halo (n convs) are staged in shared
//     memory, zero outside the image.  Conv j writes its output region,
//     one pixel smaller on each side, to the other of two shared buffers,
//     storing zero where the pixel lies outside the image (the next conv's
//     zero padding); the intermediate convs are thus recomputed on their
//     halo instead of being exchanged between CTAs;
//   * a thread computes PIX=4 neighbouring pixels x COT=8 output channels:
//     per input channel and kernel row it reads 6 activations from shared
//     memory and, per tap, two float4 weight vectors that every thread of
//     the warp shares, for 96 FMAs;
//   * the last conv writes the full output (if asked) straight to device
//     memory and adds its sums into per-channel shared accumulators.
//
// Weights arrive packed [cin][9][cout_pad] (cout padded to COT with
// zeros), already rounded to bf16 in bf16 mode.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int MAX_CONVS = 8;
constexpr int PIX = 4;
constexpr int COT = 8;
constexpr int THREADS = 256;

}  // namespace

// Mirrored field for field by the ctypes Structure in kernels/fused_convs.py.
struct FusedConvsArgs {
  const float* x;  // input, element (b, c, y, x) at b*sb + c*sc + y*sy + x*sx
  float* full;     // [B, Cout, H, W] contiguous, or null
  float* pooled;   // [B, Cout, H/pool, W/pool] contiguous, or null
  const float* w[MAX_CONVS];     // packed [cin][9][cout_pad]
  const float* bias[MAX_CONVS];  // [cout_pad]
  long long sb, sc, sy, sx;
  int B, H, W, pool, TH, TW, n, bf16;
  int buf1_off, pool_off, smem_bytes;
  int cin[MAX_CONVS + 1];  // input channels of conv i; cin[n] = output channels
  int cout[MAX_CONVS];     // channels conv i computes (without the concat carry)
  int cout_pad[MAX_CONVS];
  int relu[MAX_CONVS];
  int concat[MAX_CONVS];
};

namespace {

__device__ __forceinline__ float lrelu(float v) { return v > 0.f ? v : 0.1f * v; }

__device__ __forceinline__ float to_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// Conv j of the chain over a shared-memory region in[cin][ih][iw] whose
// top-left output pixel sits at image position (gy0, gx0).  Intermediate
// convs write out[cout (+cin carry)][ih-2][iw-2] in shared memory; the last
// conv writes the full output and adds into pool_acc.
template <bool BF16>
__device__ void conv_region(const FusedConvsArgs& a, int j, const float* in,
                            int ih, int iw, int gy0, int gx0, bool last,
                            float* out, float* pool_acc, int b) {
  const int cin = a.cin[j], cout = a.cout[j], cpad = a.cout_pad[j];
  const bool relu = a.relu[j] != 0;
  const float* __restrict__ wt = a.w[j];
  const float* __restrict__ bias = a.bias[j];
  const int oh = ih - 2, ow = iw - 2;
  const int ngx = (ow + PIX - 1) / PIX;
  const int items = (cpad / COT) * oh * ngx;
  const int ctot = a.cin[j + 1];
  const long long plane = (long long)a.H * a.W;

  for (int it = threadIdx.x; it < items; it += blockDim.x) {
    const int gx = it % ngx;
    const int rest = it / ngx;
    const int r = rest % oh;
    const int co0 = (rest / oh) * COT;
    const int x0 = gx * PIX;

    float acc[PIX][COT];
#pragma unroll
    for (int c = 0; c < COT; ++c) {
      const float bv = __ldg(bias + co0 + c);
#pragma unroll
      for (int p = 0; p < PIX; ++p) acc[p][c] = bv;
    }
    // the ragged last group of a row reads clamped columns; those pixels
    // are never stored
    int cols[PIX + 2];
#pragma unroll
    for (int i = 0; i < PIX + 2; ++i) cols[i] = min(x0 + i, iw - 1);

    for (int ci = 0; ci < cin; ++ci) {
      const float* ip = in + (ci * ih + r) * iw;
      const float* wp = wt + (long long)ci * 9 * cpad + co0;
#pragma unroll
      for (int ky = 0; ky < 3; ++ky) {
        float v[PIX + 2];
#pragma unroll
        for (int i = 0; i < PIX + 2; ++i) {
          const float t = ip[ky * iw + cols[i]];
          v[i] = BF16 ? to_bf16(t) : t;
        }
#pragma unroll
        for (int kx = 0; kx < 3; ++kx) {
          const float4* wq = reinterpret_cast<const float4*>(wp + (ky * 3 + kx) * cpad);
          float wv[COT];
#pragma unroll
          for (int q = 0; q < COT / 4; ++q) {
            const float4 t = __ldg(wq + q);
            wv[4 * q] = t.x;
            wv[4 * q + 1] = t.y;
            wv[4 * q + 2] = t.z;
            wv[4 * q + 3] = t.w;
          }
#pragma unroll
          for (int c = 0; c < COT; ++c)
#pragma unroll
            for (int p = 0; p < PIX; ++p) acc[p][c] = fmaf(v[p + kx], wv[c], acc[p][c]);
        }
      }
    }

    const int gy = gy0 + r;
    float psum[COT];
#pragma unroll
    for (int c = 0; c < COT; ++c) psum[c] = 0.f;
#pragma unroll
    for (int p = 0; p < PIX; ++p) {
      const int x = x0 + p;
      const int gxp = gx0 + x;
      if (x >= ow) break;
      const bool inside = gy >= 0 && gy < a.H && gxp >= 0 && gxp < a.W;
#pragma unroll
      for (int c = 0; c < COT; ++c) {
        const int co = co0 + c;
        if (co >= cout) break;
        const float val = relu ? lrelu(acc[p][c]) : acc[p][c];
        if (!last) {
          out[(co * oh + r) * ow + x] = inside ? val : 0.f;
        } else if (inside) {
          if (a.full) a.full[((long long)b * ctot + co) * plane + (long long)gy * a.W + gxp] = val;
          psum[c] += val;
        }
      }
    }
    if (last && pool_acc) {
#pragma unroll
      for (int c = 0; c < COT; ++c)
        if (co0 + c < cout) atomicAdd(pool_acc + co0 + c, psum[c]);
    }
  }

  if (a.concat[j]) {
    // the carry: channels [cout, cout + cin) are this conv's input cropped
    // by one pixel, already zero outside the image
    const int n = cin * oh * ow;
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
      const int x = i % ow;
      const int t = i / ow;
      const int r = t % oh;
      const int ci = t / oh;
      const float val = in[(ci * ih + r + 1) * iw + x + 1];
      if (!last) {
        out[((cout + ci) * oh + r) * ow + x] = val;
      } else {
        const int gy = gy0 + r, gxp = gx0 + x;
        if (gy < a.H && gxp < a.W) {
          if (a.full)
            a.full[((long long)b * ctot + cout + ci) * plane + (long long)gy * a.W + gxp] = val;
          if (pool_acc) atomicAdd(pool_acc + cout + ci, val);
        }
      }
    }
  }
}

template <bool BF16>
__global__ void __launch_bounds__(THREADS) fused_convs_kernel(const FusedConvsArgs a) {
  extern __shared__ float smem[];
  const int b = blockIdx.z;
  const int ty = blockIdx.y, tx = blockIdx.x;
  const int n = a.n;
  const int y0 = ty * a.TH, x0 = tx * a.TW;
  float* buf[2] = {smem, smem + a.buf1_off};
  float* pool_acc = a.pool ? smem + a.pool_off : nullptr;
  const int ctot = a.cin[n];

  if (pool_acc)
    for (int c = threadIdx.x; c < ctot; c += blockDim.x) pool_acc[c] = 0.f;

  // stage the input tile and its n-pixel halo, zero outside the image
  int rh = a.TH + 2 * n, rw = a.TW + 2 * n;
  {
    const float* xb = a.x + (long long)b * a.sb;
    const int total = a.cin[0] * rh * rw;
    for (int i = threadIdx.x; i < total; i += blockDim.x) {
      const int col = i % rw;
      const int t = i / rw;
      const int row = t % rh;
      const int c = t / rh;
      const int gy = y0 - n + row, gx = x0 - n + col;
      float v = 0.f;
      if (gy >= 0 && gy < a.H && gx >= 0 && gx < a.W)
        v = xb[c * a.sc + gy * a.sy + gx * a.sx];
      buf[0][i] = v;
    }
  }
  __syncthreads();

  for (int j = 0; j < n; ++j) {
    const bool last = j == n - 1;
    conv_region<BF16>(a, j, buf[j & 1], rh, rw, y0 - n + j + 1, x0 - n + j + 1, last,
                      last ? nullptr : buf[(j + 1) & 1], pool_acc, b);
    __syncthreads();
    rh -= 2;
    rw -= 2;
  }

  if (pool_acc) {
    const int hp = a.H / a.pool, wp = a.W / a.pool;
    const float inv = 1.0f / (float)(a.pool * a.pool);
    for (int c = threadIdx.x; c < ctot; c += blockDim.x)
      a.pooled[(((long long)b * ctot + c) * hp + ty) * wp + tx] = pool_acc[c] * inv;
  }
}

template <bool BF16>
int launch(const FusedConvsArgs& a, cudaStream_t stream) {
  if (a.smem_bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        fused_convs_kernel<BF16>, cudaFuncAttributeMaxDynamicSharedMemorySize, a.smem_bytes);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((a.W + a.TW - 1) / a.TW, (a.H + a.TH - 1) / a.TH, a.B);
  fused_convs_kernel<BF16><<<grid, THREADS, a.smem_bytes, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int fused_convs_launch(const FusedConvsArgs* a, cudaStream_t stream) {
  if (a->n < 1 || a->n > MAX_CONVS) return (int)cudaErrorInvalidValue;
  for (int j = 0; j < a->n; ++j)
    if (a->cout_pad[j] % COT) return (int)cudaErrorInvalidValue;
  if ((long long)a->B * a->H * a->W == 0) return (int)cudaSuccess;
  return a->bf16 ? launch<true>(*a, stream) : launch<false>(*a, stream);
}

// lets the binding check that its mirror of the struct has the same size
extern "C" int fused_convs_args_size() { return (int)sizeof(FusedConvsArgs); }
