// K3 on the tensor cores: a chain of 3x3 stride-1 pad-1 convs, then an
// optional average pool, hand-written for Hopper (sm_90a).  The SIMT
// version in fused_convs.cu keeps the chains this one does not take
// (concat chains, channel counts off its multiples); kernels/fused_convs.py
// chooses by the chain's shape.
//
// Replaces the TPU kernel eemflow_tpu/ops/pallas/fused_convs.py
// fused_convs_pool (pallas_call at :330), which walks row bands of the
// image through VMEM and runs each conv as im2col / tap matmuls on the MXU.
//
// What it computes (NCHW here; the public function is NHWC): for conv i,
//   y_i = bias_i + sum_{ci, ky, kx} w_i[co, ci, ky, kx] * in_i[ci, y+ky-1, x+kx-1]
// with in_i zero outside the image and LeakyReLU(0.1) where relu[i]; then
// the mean over each pool x pool window.  bf16 mode rounds both operands of
// every product to bf16 (nearest even) and sums in float32.
//
// Bound on this card: at EEMFlow's 720x1280 levels (padded 768x1280) the
// six calls of a forward do 11.3 GFLOP against ~0.1 GB of input read and
// full output written.  The first version ran SIMT float32 FMAs (0.169 ms
// at 67 TFLOP/s, and it reached 11.5% of that); on the tensor cores the
// float32 mode needs the three TF32 products of a split (3 x 11.3 GFLOP at
// 495 TFLOP/s = 0.069 ms) and bf16 one product at 989 TFLOP/s (0.011 ms),
// so level 1 (one 16-channel conv, 31.5 MB moved, 0.0094 ms) becomes bound
// by its bytes and levels 2-3 by their products.  The design:
//
//   * one CTA per (sample, output tile); with a pool the tile is whole pool
//     windows (32x32 at level 1, 16x16 at level 2, 8x16 at level 3: two
//     8x8 windows recompute less halo than one), so the CTA reduces its
//     pooled cells itself, with no global atomics;
//   * the input tile and its n-pixel halo (n convs) are staged by 4-byte
//     cp.async (zero-filled outside the image) from any strided view into
//     shared memory as [pixel][channel], channels contiguous at a pixel
//     stride of C + 4 floats, so the 8 rows an ldmatrix reads fall on 8
//     different groups of 4 banks; conv j writes its output region, one
//     pixel smaller on each side, into the other of two such buffers,
//     zero where the pixel lies outside the image (the next conv's
//     padding); intermediates never leave the chip;
//   * each conv is an implicit GEMM over the region in shared memory:
//     M = its pixels, N = its output channels, K = 9 taps x input channels,
//     walked 8 (TF32) or 16 (bf16) channels of one tap at a time; the A
//     fragment of 16 pixels comes by ldmatrix with per-lane row addresses
//     = the pixel shifted by the tap, so there is no im2col copy.  A warp
//     owns up to MT=2 m16 tiles x NT n8 tiles (NT = 2 for 16-channel
//     chains; 4 for 32, and for 64 in bf16; 8 for 64-channel float32
//     chains, so each split A fragment feeds all of them); warps take
//     (m-block, n-group) items, in passes where there are more items than
//     warps: 8 warps, 16 for the bf16 chains of 32 and 64 channels, which
//     need fewer registers (the float32 items hold a partial sum beside
//     each accumulator; at 16 warps they would spill);
//   * float32 mode: split TF32 on mma.sync.m16n8k8 (a = big + small, three
//     products small*big + big*small + big*big), each k8 chunk's three
//     products into a fresh partial sum added to the accumulator in
//     float32: the tensor cores round a running sum toward zero, and K
//     reaches 576 at level 3 (K5's finding, kernels/csrc/update_block.cu);
//     bf16 mode: mma.sync.m16n8k16 on the same float32 activations rounded
//     to bf16 as the fragment is built, K5's permutation of K within k16;
//   * weights in K5's packing (kernels/update_block.py k_order, tf32_split,
//     fragment_order: two TF32 planes or bf16, per 32-value K step and 8
//     output channels in fragment order), streamed through a ring of
//     stages in shared memory by Hopper's bulk copy into an mbarrier, a
//     stage being as many K steps as fit; a stage already in its buffer is
//     not copied again (level 1's whole 20 KB conv is one stage, loaded
//     once per CTA);
//   * the epilogue adds the bias and applies LeakyReLU, stores the last
//     conv's full output (where asked) straight from the fragments: a
//     warp's store covers 8 consecutive pixels of 4 channels, whole 32-byte
//     sectors; and reduces each pool window over the 8 rows of a fragment
//     by warp shuffles, then into per-window sums in shared memory.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "tensor_core.cuh"

using namespace tc;

namespace {

constexpr int MAX_CONVS = 8;
constexpr int MAX_RING = 4;
constexpr int MT = 2;  // m16 tiles of a warp's item, at most
// warps of a CTA: 16 for bf16 chains of 32 or more channels, whose items
// need few registers, else 8 (split TF32 holds a partial sum beside each
// accumulator); CTAs an SM is asked to hold: 2 for the 16-channel chains
template <int NT, bool BF16> struct Cfg {
  static constexpr int WARPS = (BF16 && NT == 4) ? 16 : 8;
  static constexpr int THREADS = WARPS * 32;
  static constexpr int MIN_BLOCKS = NT == 2 ? 2 : 1;
};
// bytes of one packed weight block (kernels/update_block.py fragment_order):
// 8 output channels x 32 K values, two TF32 planes or bf16
template <bool BF16> __host__ __device__ constexpr int block_bytes() { return BF16 ? 8 * 32 * 2 : 8 * 32 * 4 * 2; }

}  // namespace

// Mirrored field for field by the ctypes Structure in kernels/fused_convs.py.
struct FusedConvsTcArgs {
  const float* x;  // input, element (b, c, y, x) at b*sb + c*sc + y*sy + x*sx
  float* full;     // [B, Cout, H, W] contiguous, or null
  float* pooled;   // [B, Cout, H/pool, W/pool] contiguous, or null
  const void* w[MAX_CONVS];      // packed [K steps][Cout / 8][block]
  const float* bias[MAX_CONVS];  // [Cout]
  long long sb, sc, sy, sx;
  int B, H, W, pool, TH, TW, n, nt, bf16;
  int ring, stage_bytes, smem_bytes;
  int buf_off[2], ring_off, bar_off, pool_off;  // bytes into dynamic shared memory
  int cin[MAX_CONVS + 1];  // input channels of conv i; cin[n] = output channels
  int ps[MAX_CONVS];       // pixel stride (floats) of conv i's input buffer
  int relu[MAX_CONVS];
  int steps[MAX_CONVS];   // 32-value K steps of conv i's packed weights
  int spst[MAX_CONVS];    // K steps a ring stage holds
  int mb[MAX_CONVS];      // m16 tiles of an item of conv i
  int passes[MAX_CONVS];  // rounds of items over the warps
};

namespace {

__device__ __forceinline__ float lrelu(float v) { return v > 0.f ? v : 0.1f * v; }

__device__ __forceinline__ int nstages(const FusedConvsTcArgs& a, int j) {
  return (a.steps[j] + a.spst[j] - 1) / a.spst[j];
}

// ring use G -> (conv j, stage s); conv j's uses are its passes x stages
__device__ void decode(const FusedConvsTcArgs& a, int G, int& j, int& s) {
  for (j = 0;; ++j) {
    const int ns = nstages(a, j);
    if (G < ns * a.passes[j]) {
      s = G % ns;
      return;
    }
    G -= ns * a.passes[j];
  }
}

// thread 0: bring the weights of ring use G into buffer G % ring, or only
// complete the buffer's phase when it already holds them
template <bool BF16>
__device__ void issue(const FusedConvsTcArgs& a, int G, uint32_t ring, uint32_t bars) {
  int j, s;
  decode(a, G, j, s);
  const int buf = G % a.ring;
  const uint32_t bar = bars + 8 * buf;
  if (G >= a.ring) {
    int jp, sp;
    decode(a, G - a.ring, jp, sp);
    if (jp == j && sp == s) {
      mbar_arrive(bar);
      return;
    }
  }
  const int step_bytes = a.cin[j + 1] / 8 * block_bytes<BF16>();
  const int first = s * a.spst[j];
  const int count = min(a.spst[j], a.steps[j] - first);
  bulk_copy(ring + buf * a.stage_bytes, static_cast<const unsigned char*>(a.w[j]) + (long long)first * step_bytes,
            count * step_bytes, bar);
}

// One ring stage of conv j for a warp's item of MTC m16 tiles x NT n8
// tiles: the MMAs of K steps [step0, step1) into acc[0, MTC).  A step is 32
// K values (4 TF32 or 2 bf16 chunks), unrolled; the chunk's tap and channel
// advance by additions (a step spans two taps where Cin = 16).  Rows of the
// last item past the region's M read a real pixel and are never stored, so
// every MMA runs unguarded.
template <int MTC, int NT, bool BF16>
__device__ __forceinline__ void mma_stage(float (&acc)[MT][NT][4], uint32_t src, const unsigned char* wst,
                                          int lane, int mt0, int ng, int n8, int ow, int iw, int M, int ps,
                                          int cin, int step0, int step1) {
  // the pixel rows this lane's ldmatrix addresses: lanes 0-7 and 16-23 rows
  // 0-7, lanes 8-15 and 24-31 rows 8-15; lanes 16-31 the second 4 floats
  const int r = (lane & 7) + ((lane >> 3) & 1) * 8;
  uint32_t abase[MTC];
#pragma unroll
  for (int mi = 0; mi < MTC; ++mi) {
    const int m = min((mt0 + mi) * 16 + r, M - 1);
    const int oy = m / ow;
    abase[mi] = src + ((oy * iw + m - oy * ow) * ps + (lane >> 4) * 4) * 4;
  }
  constexpr int KC = BF16 ? 16 : 8;  // K values of one MMA
  constexpr int CPS = 32 / KC;       // chunks a step
  const int kc_end = 9 * cin / KC;
  int tap = step0 * 32 / cin, c0 = step0 * 32 - tap * cin;
  const unsigned char* wlane = wst + ng * NT * CPS * (BF16 ? 256 : 512) + lane * 8;
#pragma unroll 1
  for (int st = step0; st < step1; ++st) {
    const unsigned char* wstep = wlane + (st - step0) * n8 * block_bytes<BF16>();
    float part[MTC][NT][4];
#pragma unroll
    for (int kk = 0; kk < CPS; ++kk) {
      if (st * CPS + kk >= kc_end) break;  // the zero rows that pad K to a whole step
      const uint32_t off = (((tap / 3) * iw + tap % 3) * ps + c0) * 4;
      c0 += KC;
      if (c0 == cin) {
        c0 = 0;
        ++tap;
      }
      if constexpr (!BF16) {
        // split TF32 as K5 runs it: the chunk's three products small*big,
        // big*small, big*big, each a pass over the warp's tiles so that
        // consecutive MMAs never wait on each other, into a partial sum
        // fresh each step, added to acc in float32
        uint32_t big[MTC][4], small[MTC][4];
#pragma unroll
        for (int mi = 0; mi < MTC; ++mi) {
          uint32_t v[4];
          ldsm_x4(abase[mi] + off, v);
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const float x = __uint_as_float(v[q]);
            big[mi][q] = to_tf32(x);
            small[mi][q] = to_tf32(x - __uint_as_float(big[mi][q]));
          }
        }
        // the fragments of the big (plane 0) and small (plane 1) weights
        uint2 wb[NT], ws[NT];
#pragma unroll
        for (int ni = 0; ni < NT; ++ni) {
          const unsigned char* wk = wstep + (ni * CPS + kk) * 512;
          wb[ni] = *reinterpret_cast<const uint2*>(wk);
          ws[ni] = *reinterpret_cast<const uint2*>(wk + 256);
        }
#pragma unroll
        for (int ni = 0; ni < NT; ++ni)
#pragma unroll
          for (int mi = 0; mi < MTC; ++mi) {
            if (kk == 0)
              mma_tf32_zero(part[mi][ni], small[mi], wb[ni].x, wb[ni].y);
            else
              mma_tf32(part[mi][ni], small[mi], wb[ni].x, wb[ni].y);
          }
#pragma unroll
        for (int ni = 0; ni < NT; ++ni)
#pragma unroll
          for (int mi = 0; mi < MTC; ++mi) mma_tf32(part[mi][ni], big[mi], ws[ni].x, ws[ni].y);
#pragma unroll
        for (int ni = 0; ni < NT; ++ni)
#pragma unroll
          for (int mi = 0; mi < MTC; ++mi) mma_tf32(part[mi][ni], big[mi], wb[ni].x, wb[ni].y);
      } else {
        // logical k (2t, 2t+1) is physical (t, t+4), (2t+8, 2t+9) is (8+t,
        // 12+t): the order in which the weights are packed
        uint32_t af[MTC][4];
#pragma unroll
        for (int mi = 0; mi < MTC; ++mi) {
          uint32_t lo[4], hi[4];
          ldsm_x4(abase[mi] + off, lo);
          ldsm_x4(abase[mi] + off + 32, hi);
          af[mi][0] = pack_bf16(lo[0], lo[2]);
          af[mi][1] = pack_bf16(lo[1], lo[3]);
          af[mi][2] = pack_bf16(hi[0], hi[2]);
          af[mi][3] = pack_bf16(hi[1], hi[3]);
        }
#pragma unroll
        for (int ni = 0; ni < NT; ++ni) {
          const uint2 w = *reinterpret_cast<const uint2*>(wstep + (ni * CPS + kk) * 256);
#pragma unroll
          for (int mi = 0; mi < MTC; ++mi) mma_bf16(acc[mi][ni], af[mi], w.x, w.y);
        }
      }
    }
    if constexpr (!BF16) {
#pragma unroll
      for (int mi = 0; mi < MTC; ++mi)
#pragma unroll
        for (int ni = 0; ni < NT; ++ni)
#pragma unroll
          for (int q = 0; q < 4; ++q) acc[mi][ni][q] += part[mi][ni][q];
    }
  }
}

template <int NT, bool BF16>
__global__ void __launch_bounds__(Cfg<NT, BF16>::THREADS, Cfg<NT, BF16>::MIN_BLOCKS)
    fused_convs_tc(const __grid_constant__ FusedConvsTcArgs a) {
  constexpr int NWARPS = Cfg<NT, BF16>::WARPS, THREADS = Cfg<NT, BF16>::THREADS;
  extern __shared__ __align__(128) unsigned char smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int b = blockIdx.z;
  const int y0 = blockIdx.y * a.TH, x0 = blockIdx.x * a.TW;
  const int n = a.n;
  const uint32_t sbase = smem_u32(smem);
  const uint32_t ring = sbase + a.ring_off;
  const uint32_t bars = sbase + a.bar_off;
  float* pool_acc = a.pool ? reinterpret_cast<float*>(smem + a.pool_off) : nullptr;
  const int cout_last = a.cin[n];
  const int wins_x = a.pool ? a.TW / a.pool : 1;
  const int nwin = a.pool ? (a.TH / a.pool) * wins_x : 0;

  int total = 0;  // ring uses of the whole chain
  for (int j = 0; j < n; ++j) total += nstages(a, j) * a.passes[j];

  if (tid == 0) {
    for (int i = 0; i < a.ring; ++i) mbar_init(bars + 8 * i, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  for (int i = tid; i < nwin * cout_last; i += THREADS) pool_acc[i] = 0.f;
  __syncthreads();
  // every buffer of the ring is free: its first uses go now, beside the input
  if (tid == 0)
    for (int g = 0; g < a.ring && g < total; ++g) issue<BF16>(a, g, ring, bars);

  // stage the input tile and its n-pixel halo as [pixel][channel]
  {
    const int rh = a.TH + 2 * n, rw = a.TW + 2 * n, cin = a.cin[0], ps = a.ps[0];
    const uint32_t dst = sbase + a.buf_off[0];
    const float* xb = a.x + (long long)b * a.sb;
    if (a.sc == 1) {  // channels contiguous (an NHWC view): lanes along channels
      for (int pix = warp; pix < rh * rw; pix += NWARPS) {
        const int row = pix / rw, col = pix - row * rw;
        const int gy = y0 - n + row, gx = x0 - n + col;
        const bool ok = gy >= 0 && gy < a.H && gx >= 0 && gx < a.W;
        const float* src = ok ? xb + gy * a.sy + gx * a.sx : xb;
        for (int c = lane; c < cin; c += 32) cp_async4(dst + (pix * ps + c) * 4, ok ? src + c : xb, ok ? 4 : 0);
      }
    } else {  // lanes along the row
      for (int cr = warp; cr < cin * rh; cr += NWARPS) {
        const int c = cr / rh, row = cr - c * rh;
        const int gy = y0 - n + row;
        const bool rok = gy >= 0 && gy < a.H;
        const float* src = rok ? xb + c * a.sc + gy * a.sy : xb;
        for (int col = lane; col < rw; col += 32) {
          const int gx = x0 - n + col;
          const bool ok = rok && gx >= 0 && gx < a.W;
          cp_async4(dst + ((row * rw + col) * ps + c) * 4, ok ? src + gx * a.sx : xb, ok ? 4 : 0);
        }
      }
    }
    cp_async_commit();
    cp_async_wait<0>();
  }

  float acc[MT][NT][4];
  int j = 0, p = 0, s = 0;  // conv, pass and stage of ring use G
  for (int G = 0; G < total; ++G) {
    __syncthreads();  // use G - 1 is done: its buffer is free, its outputs visible
    if (tid == 0 && G > 0 && G + a.ring - 1 < total) issue<BF16>(a, G + a.ring - 1, ring, bars);
    const int buf = G % a.ring;
    mbar_wait(bars + 8 * buf, (G / a.ring) & 1);

    const bool last = j == n - 1;
    const int cin = a.cin[j], cout = a.cin[j + 1];
    const int ext = n - 1 - j;  // conv j's output region: the tile grown by ext pixels
    const int ow = a.TW + 2 * ext, oh = a.TH + 2 * ext;
    const int M = oh * ow, m16 = (M + 15) >> 4;
    const int n8 = cout >> 3, ngroups = (n8 + NT - 1) / NT;
    const int item = p * NWARPS + warp;
    const int mblk = item / ngroups, ng = item - mblk * ngroups;
    const int mt0 = mblk * a.mb[j];
    const int mcount = min(a.mb[j], m16 - mt0);  // <= 0: no item for this warp in this pass
    const int ns = nstages(a, j);
    if (s == 0) {
#pragma unroll
      for (int mi = 0; mi < MT; ++mi)
#pragma unroll
        for (int ni = 0; ni < NT; ++ni)
#pragma unroll
          for (int q = 0; q < 4; ++q) acc[mi][ni][q] = 0.f;
    }
    if (mcount > 0) {
      const int step0 = s * a.spst[j], step1 = min(step0 + a.spst[j], a.steps[j]);
      const uint32_t src = sbase + a.buf_off[j & 1];
      const unsigned char* wst = smem + a.ring_off + buf * a.stage_bytes;
      if (a.mb[j] == 1)  // the same in every warp of a conv
        mma_stage<1, NT, BF16>(acc, src, wst, lane, mt0, ng, n8, ow, ow + 2, M, a.ps[j], cin, step0, step1);
      else
        mma_stage<2, NT, BF16>(acc, src, wst, lane, mt0, ng, n8, ow, ow + 2, M, a.ps[j], cin, step0, step1);
    }

    if (s == ns - 1 && mcount > 0) {
      // the epilogue of this item: lane (g, t) holds pixels g, g + 8 of
      // each m16 tile, channels 2t, 2t + 1 of each n8 tile
      const int g = lane >> 2, t = lane & 3;
      const bool relu = a.relu[j] != 0;
      const float* __restrict__ bias = a.bias[j];
      float* out = reinterpret_cast<float*>(smem + a.buf_off[(j + 1) & 1]);
      const int ps_out = last ? 0 : a.ps[j + 1];
      const long long plane = (long long)a.H * a.W;
#pragma unroll
      for (int mi = 0; mi < MT; ++mi) {
        if (mi >= mcount) continue;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int m = (mt0 + mi) * 16 + g + 8 * half;
          const bool mok = m < M;
          const int oy = m / ow, ox = m - oy * ow;
          const int gy = y0 - ext + oy, gx = x0 - ext + ox;
          const bool inside = mok && gy >= 0 && gy < a.H && gx >= 0 && gx < a.W;
          // the pool window of this pixel (last conv: the region is the tile)
          int win = -1;
          bool same = false;
          if (last && a.pool) {
            if (inside) win = (oy / a.pool) * wins_x + ox / a.pool;
            same = __all_sync(0xffffffffu, win == __shfl_sync(0xffffffffu, win, t));
          }
#pragma unroll
          for (int ni = 0; ni < NT; ++ni) {
            const int jn = ng * NT + ni;
            if (jn >= n8) continue;
            const int col = jn * 8 + 2 * t;
            const float2 bv = __ldg(reinterpret_cast<const float2*>(bias + col));
            float v0 = acc[mi][ni][2 * half] + bv.x, v1 = acc[mi][ni][2 * half + 1] + bv.y;
            if (relu) {
              v0 = lrelu(v0);
              v1 = lrelu(v1);
            }
            if (!last) {
              if (mok)
                *reinterpret_cast<float2*>(out + m * ps_out + col) = inside ? make_float2(v0, v1) : make_float2(0.f, 0.f);
              continue;
            }
            if (inside && a.full) {
              float* f = a.full + ((long long)b * cout + col) * plane + (long long)gy * a.W + gx;
              f[0] = v0;
              f[plane] = v1;
            }
            if (a.pool) {
              float s0 = win >= 0 ? v0 : 0.f, s1 = win >= 0 ? v1 : 0.f;
              if (same) {  // the 8 rows share a window: add them first
#pragma unroll
                for (int o = 4; o < 32; o <<= 1) {
                  s0 += __shfl_xor_sync(0xffffffffu, s0, o);
                  s1 += __shfl_xor_sync(0xffffffffu, s1, o);
                }
                if (g == 0 && win >= 0) {
                  atomicAdd(pool_acc + win * cout + col, s0);
                  atomicAdd(pool_acc + win * cout + col + 1, s1);
                }
              } else if (win >= 0) {
                atomicAdd(pool_acc + win * cout + col, s0);
                atomicAdd(pool_acc + win * cout + col + 1, s1);
              }
            }
          }
        }
      }
    }
    if (++s == ns) {
      s = 0;
      if (++p == a.passes[j]) {
        p = 0;
        ++j;
      }
    }
  }

  if (pool_acc) {
    __syncthreads();
    const int hp = a.H / a.pool, wp = a.W / a.pool;
    const float inv = 1.0f / (float)(a.pool * a.pool);
    for (int i = tid; i < nwin * cout_last; i += THREADS) {
      const int w = i / cout_last, c = i - w * cout_last;
      const int wy = blockIdx.y * (a.TH / a.pool) + w / wins_x, wx = blockIdx.x * wins_x + w % wins_x;
      if (wy < hp && wx < wp) a.pooled[(((long long)b * cout_last + c) * hp + wy) * wp + wx] = pool_acc[i] * inv;
    }
  }
}

template <int NT, bool BF16>
int launch(const FusedConvsTcArgs& a, cudaStream_t stream) {
  const cudaError_t e =
      cudaFuncSetAttribute(fused_convs_tc<NT, BF16>, cudaFuncAttributeMaxDynamicSharedMemorySize, a.smem_bytes);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((a.W + a.TW - 1) / a.TW, (a.H + a.TH - 1) / a.TH, a.B);
  fused_convs_tc<NT, BF16><<<grid, Cfg<NT, BF16>::THREADS, a.smem_bytes, stream>>>(a);
  return (int)cudaGetLastError();
}

// threads, registers, local (spill) bytes, CTAs an SM holds at `smem`
template <int NT, bool BF16>
int info_of(int smem, int* info) {
  cudaFuncAttributes attr;
  cudaError_t e = cudaFuncGetAttributes(&attr, fused_convs_tc<NT, BF16>);
  if (e != cudaSuccess) return (int)e;
  e = cudaFuncSetAttribute(fused_convs_tc<NT, BF16>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  int ctas = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&ctas, fused_convs_tc<NT, BF16>, Cfg<NT, BF16>::THREADS, smem);
  if (e != cudaSuccess) return (int)e;
  info[0] = Cfg<NT, BF16>::THREADS;
  info[1] = attr.numRegs;
  info[2] = (int)attr.localSizeBytes;
  info[3] = ctas;
  return (int)cudaSuccess;
}

}  // namespace

extern "C" int fused_convs_tc_launch(const FusedConvsTcArgs* a, cudaStream_t stream) {
  const int n = a->n;
  if (n < 1 || n > MAX_CONVS || a->ring < 1 || a->ring > MAX_RING || (a->nt != 2 && a->nt != 4 && a->nt != 8) ||
      (a->bf16 && a->nt == 8) ||
      a->stage_bytes % 16 || a->ring_off % 16 || a->bar_off % 8)
    return (int)cudaErrorInvalidValue;
  for (int j = 0; j < n; ++j)
    if (a->cin[j] % 16 || a->ps[j] < a->cin[j] || a->mb[j] < 1 || a->mb[j] > MT || a->spst[j] < 1 ||
        a->passes[j] < 1)
      return (int)cudaErrorInvalidValue;
  if (a->cin[n] % 8 || (a->pool && (a->TH % a->pool || a->TW % a->pool))) return (int)cudaErrorInvalidValue;
  if ((long long)a->B * a->H * a->W == 0) return (int)cudaSuccess;
  if (a->nt == 2) return a->bf16 ? launch<2, true>(*a, stream) : launch<2, false>(*a, stream);
  if (a->nt == 4) return a->bf16 ? launch<4, true>(*a, stream) : launch<4, false>(*a, stream);
  return launch<8, false>(*a, stream);
}

extern "C" int fused_convs_tc_kernel_info(int nt, int bf16, int smem, int* info) {
  if (nt == 2) return bf16 ? info_of<2, true>(smem, info) : info_of<2, false>(smem, info);
  if (nt == 4) return bf16 ? info_of<4, true>(smem, info) : info_of<4, false>(smem, info);
  if (nt == 8 && !bf16) return info_of<8, false>(smem, info);
  return (int)cudaErrorInvalidValue;
}

// lets the binding check that its mirror of the struct has the same size
extern "C" int fused_convs_tc_args_size() { return (int)sizeof(FusedConvsTcArgs); }
