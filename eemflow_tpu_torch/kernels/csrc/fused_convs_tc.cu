// K3 on the tensor cores: a chain of 3x3 stride-1 pad-1 convs, then an
// optional average pool, hand-written for Hopper (sm_90a).  It takes every
// chain of the port: EEMFlow's pyramid, EEMFlow+'s densely connected SGU
// estimator (concat chains) and its grouped, channel-shuffled decoders;
// kernels/fused_convs.py plans the launches and lays out shared memory.
//
// Replaces the TPU kernel eemflow_tpu/ops/pallas/fused_convs.py
// fused_convs_pool (pallas_call at :330), which walks row bands of the
// image through VMEM and runs each conv as im2col / tap matmuls on the MXU.
//
// What it computes (NCHW here; the public function is NHWC): for conv i of
// g_i groups,
//   y_i = bias_i + sum_{ci in co's group, ky, kx} w_i[co, ci, ky, kx] * in_i[ci, y+ky-1, x+kx-1]
// with in_i zero outside the image, LeakyReLU(0.1) where relu[i], the
// output channels shuffled by shuffle[i] groups where that is > 1, and the
// next conv's input [y_i, in_i] where conv i concatenates; then the mean
// over each pool x pool window.  bf16 mode rounds both operands of every
// product to bf16 (nearest even) and sums in float32.
//
// Bound on this card.  EEMFlow's pyramid at 720x1280 (padded 768x1280):
// the six calls of a forward do 11.3 GFLOP against ~0.1 GB of input read
// and full output written; float32 needs the three TF32 products of a
// split (3 x 11.3 GFLOP at 495 TFLOP/s = 0.069 ms), bf16 one product at
// 989 TFLOP/s (0.011 ms), so level 1 (one 16-channel conv, 31.5 MB moved,
// 0.0094 ms) is bound by its bytes and levels 2-3 by their products.
// EEMFlow+'s nine chains of a forward (the SGU at levels 5..2, the
// decoders at 6..2) do 58.2 GFLOP of the function, the grouped convs
// counted as grouped: 3 x 58.2 GFLOP at the TF32 peak is 0.353 ms, bf16
// 0.059 ms; 0.869 ms at the 67 TFLOP/s float32 SIMT peak, the bound of the
// SIMT kernel this one replaced on those chains.  The design:
//
//   * one CTA per (sample, output tile); with a pool the tile is whole pool
//     windows (32x32 at level 1, 16x16 at level 2, 8x16 at level 3: two
//     8x8 windows recompute less halo than one), so the CTA reduces its
//     pooled cells itself, with no global atomics;
//   * the input tile and its n-pixel halo (n convs) are staged by cp.async
//     (16 bytes from an NHWC view whose channels are whole float4s, else 4
//     bytes; zero-filled outside the image and past the real channels)
//     into shared memory as [pixel][channel], channels contiguous at a
//     pixel stride of C + 4 floats, so the 8 rows an ldmatrix reads fall
//     on 8 different groups of 4 banks.  Two such buffers: a conv without
//     concat writes its output region, one pixel smaller on each side,
//     into the other one, zero where the pixel lies outside the image (the
//     next conv's padding); a run of concatenating convs keeps the whole
//     carry in one buffer, its first input at the back and each output
//     stored in front of its input at the same pixel positions, so the
//     concat costs no copy; intermediates never leave the chip.  A chain
//     whose buffers do not fit one launch (EEMFlow+'s SGU and decoders)
//     runs one conv a launch, the carry between launches going through
//     device memory (L2) as NHWC: the halo that several convs in a launch
//     recompute, and the small tiles their buffers leave room for, cost
//     more than the carry (the fewest launches that fit, decoder convs
//     1-3 | 4-7 at 8x8 tiles, took 2.6x as long at level 2: 3.567 against
//     1.395 ms, NVIDIA H100 80GB HBM3, 700.00 W, chip_smoke.py);
//   * the wrapper picks each launch's tile (16x16, 8x16, 8x8) and, for a
//     one-conv launch, a split of its outputs over 2-4 CTAs a tile
//     (nsplit) by the grid: a CTA runs its ring uses one after another, so
//     a grid that does not fill the card's 132 SMs (EEMFlow+'s levels 3-6)
//     takes the plan whose CTAs stream the fewest weights;
//   * each conv is an implicit GEMM over its region in shared memory:
//     M = its pixels, N = its output channels (padded to n8 tiles), K = 9
//     taps x input channels (padded inside each tap to whole chunks of 8
//     (TF32) or 16 (bf16) with zero weights, so a chunk never straddles a
//     tap), walked one chunk of one tap at a time; the A fragment of 16
//     pixels comes by ldmatrix with per-lane row addresses = the pixel
//     shifted by the tap, so there is no im2col copy.  A warp owns up to
//     MT=2 m16 tiles x NTC n8 tiles (NTC per conv, the largest power of
//     two up to the instance's NT that divides a group's tiles); warps take
//     (m-block, n-group) items, in passes where there are more items than
//     warps: 8 warps, 16 for the bf16 instance of NT 4, whose items need
//     fewer registers;
//   * grouped convs stay grouped: an item's n8 tiles lie in one group and
//     walk K over that group's inputs only (the decoders' 96 -> 96 convs
//     of 3 groups do 9 x 32 K values an output, not 9 x 96); a channel
//     shuffle is done where the outputs are stored (K4's
//     shuffle_destination);
//   * float32 mode: split TF32 on mma.sync.m16n8k8 (a = big + small, three
//     products small*big + big*small + big*big), each 32-value K step's
//     products into a fresh partial sum added to the accumulator in
//     float32: the tensor cores round a running sum toward zero, and K
//     reaches 1,656 in the SGU (K5's finding, kernels/csrc/update_block.cu);
//     bf16 mode: mma.sync.m16n8k16 on the same float32 activations rounded
//     to bf16 as the fragment is built, K5's permutation of K within k16
//     (a partial sum a step there moved no bf16 chain's error: the
//     operands' re-rounding between convs sets it);
//   * weights in K5's fragment order (kernels/update_block.py
//     fragment_order: two TF32 planes or bf16, per 32-value K step and 8
//     output channels), streamed through a ring of stages in shared memory
//     by Hopper's bulk copy into an mbarrier, a stage being as many K steps
//     as fit; a stage already in its buffer is not copied again (level 1's
//     whole 20 KB conv is one stage, loaded once per CTA);
//   * the epilogue adds the bias and applies LeakyReLU; the last conv
//     stores its full output (where asked) straight from the fragments (a
//     warp's store covers 8 consecutive pixels of 4 channels, whole 32-byte
//     sectors) and reduces each pool window over the 8 rows of a fragment
//     by warp shuffles, then into per-window sums in shared memory; where
//     the last conv concatenates, the rest of the output is its input,
//     which the CTA copies out of shared memory behind it (and pools).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tensor_core.cuh"

using namespace tc;

namespace {

constexpr int MAX_CONVS = 8;
constexpr int MAX_RING = 4;
constexpr int MT = 2;  // m16 tiles of a warp's item, at most
// warps of a CTA: 16 for the bf16 instance of 4 n8 tiles, whose items need
// few registers, else 8 (split TF32 holds a partial sum beside each
// accumulator); CTAs an SM is asked to hold: 2 for the instance of 2
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
// A region's pixel (y, x) of a buffer is at pixel index org + y * w + x,
// channel c of it at float (org + y * w + x) * ps + ch + c.
struct FusedConvsTcArgs {
  const float* x;  // input, element (b, c, y, x) at b*sb + c*sc + y*sy + x*sx
  float* full;     // output, element (b, c, y, x) at b*fsb + c*fsc + y*fsy + x*fsx, or null
  float* pooled;   // [B, Cout, H/pool, W/pool] contiguous, or null
  const void* w[MAX_CONVS];      // packed [K steps][n8][block]
  const float* bias[MAX_CONVS];  // [n8 * 8], zero past the conv's outputs
  long long sb, sc, sy, sx;
  long long fsb, fsc, fsy, fsx;
  int B, H, W, pool, TH, TW, n, nt, bf16;
  int nsplit;  // CTAs a tile, each computing n8 / nsplit of the last conv's tiles (1: all)
  int ring, stage_bytes, smem_bytes;
  int buf_off[2], ring_off, bar_off, pool_off;  // bytes into dynamic shared memory
  int cin, cout;            // the chain's real input and output channels
  int fout;                 // the last conv's own outputs: channels [0, fout) of the output
  int x_ch, x_cw, x_ps;     // the staged input in buffer 0: channel offset, width (zero past cin), pixel stride
  int copy_out;             // the last conv concatenates: its carry, channels [fout, cout), is copied out
  int cp_buf, cp_ps, cp_w, cp_org, nseg;  // ... from this region (the tile), whose segments
  int cp_vec;  // every segment and fout whole float4s: copied 16 bytes at a time to an NHWC output
  int seg_ch[MAX_CONVS + 1], seg_c[MAX_CONVS + 1];  // start at channel seg_ch and hold seg_c real channels
  // per conv
  int kw[MAX_CONVS];       // K channels a tap (a group's, for a grouped conv)
  int gstride[MAX_CONVS];  // channels from one group's input window to the next (0: dense)
  int n8[MAX_CONVS];       // n8 output tiles
  int n8pg[MAX_CONVS];     // n8 tiles of one group
  int ntc[MAX_CONVS];      // n8 tiles of an item
  int ngrp[MAX_CONVS];     // n-groups (items across N) a CTA computes: n8 / (nsplit for the last conv) / ntc
  int in_buf[MAX_CONVS], in_ps[MAX_CONVS], in_w[MAX_CONVS], in_org[MAX_CONVS], in_ch[MAX_CONVS];
  int out_buf[MAX_CONVS], out_ps[MAX_CONVS], out_w[MAX_CONVS], out_org[MAX_CONVS], out_ch[MAX_CONVS];
  int shuffle[MAX_CONVS];  // groups of the channel shuffle after the conv (1: none)
  int relu[MAX_CONVS];
  int steps[MAX_CONVS];   // 32-value K steps of the packed weights
  int spst[MAX_CONVS];    // K steps a ring stage holds
  int mb[MAX_CONVS];      // m16 tiles of an item
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
// complete the buffer's phase when it already holds them; a split last conv
// brings this CTA's part of each K step
template <bool BF16>
__device__ void issue(const FusedConvsTcArgs& a, int G, uint32_t ring, uint32_t bars, int part) {
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
  const int step_bytes = a.n8[j] * block_bytes<BF16>();
  const int first = s * a.spst[j];
  const int count = min(a.spst[j], a.steps[j] - first);
  const unsigned char* src = static_cast<const unsigned char*>(a.w[j]) + (long long)first * step_bytes;
  const uint32_t dst = ring + buf * a.stage_bytes;
  if (j < a.n - 1 || a.nsplit == 1) {
    bulk_copy(dst, src, count * step_bytes, bar);
    return;
  }
  const int part_bytes = step_bytes / a.nsplit;
  mbar_expect_tx(bar, count * part_bytes);
  for (int i = 0; i < count; ++i)
    bulk_copy_tx(dst + i * part_bytes, src + (long long)i * step_bytes + part * part_bytes, part_bytes, bar);
}

// A warp's item in one ring stage of a conv: where its A rows and weights lie
struct Item {
  uint32_t src;  // shared address of the input buffer
  uint32_t wst;  // shared address of the ring stage
  int mt0, ng, n8;           // first m16 tile, n-group, n8 tiles of the conv
  int ow, iw, org, chb;      // output region width; input buffer row width, origin, first channel
  int M, ps, kw, step0, step1;
};

// One ring stage of a conv for a warp's item of MTC m16 tiles x NTC n8
// tiles: the MMAs of K steps [step0, step1) into acc[0, MTC)[0, NTC).  A
// step is 32 K values (4 TF32 or 2 bf16 chunks), unrolled; the chunk's tap
// and channel advance by additions (a step can span two taps).  Rows of the
// last item past the region's M read a real pixel and are never stored, so
// every MMA runs unguarded.
template <int MTC, int NTC, int NT, bool BF16>
__device__ __forceinline__ void mma_stage(float (&acc)[MT][NT][4], const Item& it, int lane) {
  // the pixel rows this lane's ldmatrix addresses: lanes 0-7 and 16-23 rows
  // 0-7, lanes 8-15 and 24-31 rows 8-15; lanes 16-31 the second 4 floats
  const int r = (lane & 7) + ((lane >> 3) & 1) * 8;
  uint32_t abase[MTC];
#pragma unroll
  for (int mi = 0; mi < MTC; ++mi) {
    const int m = min((it.mt0 + mi) * 16 + r, it.M - 1);
    const int oy = m / it.ow;
    abase[mi] = it.src + ((it.org + oy * it.iw + m - oy * it.ow) * it.ps + it.chb + (lane >> 4) * 4) * 4;
  }
  constexpr int KC = BF16 ? 16 : 8;  // K values of one MMA
  constexpr int CPS = 32 / KC;       // chunks a step
  const int kw = it.kw, kc_end = 9 * kw / KC;
  int tap = it.step0 * 32 / kw, c0 = it.step0 * 32 - tap * kw;
  const uint32_t wlane = it.wst + it.ng * NTC * CPS * (BF16 ? 256 : 512) + lane * 8;
#pragma unroll 1
  for (int st = it.step0; st < it.step1; ++st) {
    const uint32_t wstep = wlane + (st - it.step0) * it.n8 * block_bytes<BF16>();
    float part[MTC][NTC][4];
#pragma unroll
    for (int kk = 0; kk < CPS; ++kk) {
      if (st * CPS + kk >= kc_end) break;  // the zero rows that pad K to a whole step
      const uint32_t off = (((tap / 3) * it.iw + tap % 3) * it.ps + c0) * 4;
      c0 += KC;
      if (c0 == kw) {
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
        uint2 wb[NTC], ws[NTC];
#pragma unroll
        for (int ni = 0; ni < NTC; ++ni) {
          const uint32_t wk = wstep + (ni * CPS + kk) * 512;
          wb[ni] = lds64(wk);
          ws[ni] = lds64(wk + 256);
        }
#pragma unroll
        for (int ni = 0; ni < NTC; ++ni)
#pragma unroll
          for (int mi = 0; mi < MTC; ++mi) {
            if (kk == 0)
              mma_tf32_zero(part[mi][ni], small[mi], wb[ni].x, wb[ni].y);
            else
              mma_tf32(part[mi][ni], small[mi], wb[ni].x, wb[ni].y);
          }
#pragma unroll
        for (int ni = 0; ni < NTC; ++ni)
#pragma unroll
          for (int mi = 0; mi < MTC; ++mi) mma_tf32(part[mi][ni], big[mi], ws[ni].x, ws[ni].y);
#pragma unroll
        for (int ni = 0; ni < NTC; ++ni)
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
        for (int ni = 0; ni < NTC; ++ni) {
          const uint2 w = lds64(wstep + (ni * CPS + kk) * 256);
#pragma unroll
          for (int mi = 0; mi < MTC; ++mi) mma_bf16(acc[mi][ni], af[mi], w.x, w.y);
        }
      }
    }
    if constexpr (!BF16) {
#pragma unroll
      for (int mi = 0; mi < MTC; ++mi)
#pragma unroll
        for (int ni = 0; ni < NTC; ++ni)
#pragma unroll
          for (int q = 0; q < 4; ++q) acc[mi][ni][q] += part[mi][ni][q];
    }
  }
}

// mma_stage at the item's n8 tiles (the same in every warp of a conv); the
// instance of 8 takes only chains whose every conv has items of 8 (the
// planner's tc_nt), and holds no other variant that would raise its
// registers
template <int MTC, int NT, bool BF16>
__device__ __forceinline__ void mma_item(int ntc, float (&acc)[MT][NT][4], const Item& it, int lane) {
  if constexpr (NT == 8) {
    mma_stage<MTC, 8, NT, BF16>(acc, it, lane);
  } else if (ntc == 1) {
    mma_stage<MTC, 1, NT, BF16>(acc, it, lane);
  } else if (ntc == 2) {
    mma_stage<MTC, 2, NT, BF16>(acc, it, lane);
  } else {
    if constexpr (NT == 4) mma_stage<MTC, 4, NT, BF16>(acc, it, lane);
  }
}

// the region channel of the carry's channel c (copy-out)
__device__ __forceinline__ int out_channel(const FusedConvsTcArgs& a, int c) {
  for (int k = 0; k < a.nseg; ++k) {
    if (c < a.seg_c[k]) return a.seg_ch[k] + c;
    c -= a.seg_c[k];
  }
  return 0;
}

template <int NT, bool BF16>
__global__ void __launch_bounds__(Cfg<NT, BF16>::THREADS, Cfg<NT, BF16>::MIN_BLOCKS)
    fused_convs_tc(const __grid_constant__ FusedConvsTcArgs a) {
  constexpr int NWARPS = Cfg<NT, BF16>::WARPS, THREADS = Cfg<NT, BF16>::THREADS;
  extern __shared__ __align__(128) unsigned char smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int b = a.nsplit == 1 ? blockIdx.z : blockIdx.z / a.nsplit, part = blockIdx.z - b * a.nsplit;
  const int y0 = blockIdx.y * a.TH, x0 = blockIdx.x * a.TW;
  const int n = a.n;
  const uint32_t sbase = smem_u32(smem);
  const uint32_t ring = sbase + a.ring_off;
  const uint32_t bars = sbase + a.bar_off;
  float* pool_acc = a.pool ? reinterpret_cast<float*>(smem + a.pool_off) : nullptr;  // [windows][cout]
  const int cout = a.cout, fout = a.fout;
  const int wins_x = a.pool ? a.TW / a.pool : 1;
  const int nwin = a.pool ? (a.TH / a.pool) * wins_x : 0;

  int total = 0;  // ring uses of the whole chain
  for (int j = 0; j < n; ++j) total += nstages(a, j) * a.passes[j];

  if (tid == 0) {
    for (int i = 0; i < a.ring; ++i) mbar_init(bars + 8 * i, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if (pool_acc)
    for (int i = tid; i < nwin * cout; i += THREADS) pool_acc[i] = 0.f;
  __syncthreads();
  // every buffer of the ring is free: its first uses go now, beside the input
  if (tid == 0)
    for (int g = 0; g < a.ring && g < total; ++g) issue<BF16>(a, g, ring, bars, part);

  // stage the input tile and its n-pixel halo as [pixel][channel], channels
  // [cin, x_cw) zero
  {
    const int rh = a.TH + 2 * n, rw = a.TW + 2 * n, cin = a.cin, cw = a.x_cw, ps = a.x_ps;
    const uint32_t dst = sbase + a.buf_off[0] + a.x_ch * 4;
    const float* xb = a.x + (long long)b * a.sb;
    if (a.sc == 1 && !(cin & 3) && !(a.sx & 3) && !(a.sy & 3) && !(a.sb & 3) &&
        !(reinterpret_cast<uintptr_t>(a.x) & 15)) {
      // channels contiguous in whole float4s (an NHWC view): 16-byte copies
      const int q4 = cw >> 2;
      for (int i = tid; i < rh * rw * q4; i += THREADS) {
        const int pix = i / q4, c = (i - pix * q4) * 4;
        const int row = pix / rw, col = pix - row * rw;
        const int gy = y0 - n + row, gx = x0 - n + col;
        const bool ok = c < cin && gy >= 0 && gy < a.H && gx >= 0 && gx < a.W;
        cp_async16(dst + (pix * ps + c) * 4, ok ? xb + gy * a.sy + gx * a.sx + c : xb, ok ? 16 : 0);
      }
    } else if (a.sc == 1) {  // channels contiguous: lanes along channels
      for (int pix = warp; pix < rh * rw; pix += NWARPS) {
        const int row = pix / rw, col = pix - row * rw;
        const int gy = y0 - n + row, gx = x0 - n + col;
        const bool in = gy >= 0 && gy < a.H && gx >= 0 && gx < a.W;
        for (int c = lane; c < cw; c += 32) {
          const bool ok = in && c < cin;
          cp_async4(dst + (pix * ps + c) * 4, ok ? xb + gy * a.sy + gx * a.sx + c : xb, ok ? 4 : 0);
        }
      }
    } else {  // lanes along the row
      for (int cr = warp; cr < cw * rh; cr += NWARPS) {
        const int c = cr / rh, row = cr - c * rh;
        const int gy = y0 - n + row;
        const bool rok = c < cin && gy >= 0 && gy < a.H;
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
    if (tid == 0 && G > 0 && G + a.ring - 1 < total) issue<BF16>(a, G + a.ring - 1, ring, bars, part);
    const int buf = G % a.ring;
    mbar_wait(bars + 8 * buf, (G / a.ring) & 1);

    const bool direct = j == n - 1;  // stores to the output, not to shared memory
    const int ext = n - 1 - j;  // conv j's output region: the tile grown by ext pixels
    const int ow = a.TW + 2 * ext, oh = a.TH + 2 * ext;
    const int M = oh * ow, m16 = (M + 15) >> 4;
    // the n8 tiles this CTA computes: a split last conv's part [p0, p0 + n8c)
    // (no divisions by runtime values here: each costs tens of instructions
    // a ring use)
    const int n8 = a.n8[j], ntc = a.ntc[j], ngroups = a.ngrp[j], n8c = ngroups * ntc;
    const int p0 = direct ? part * n8c : 0;
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
      Item it;
      it.src = sbase + a.buf_off[a.in_buf[j]];
      it.wst = ring + buf * a.stage_bytes;
      it.mt0 = mt0;
      it.ng = ng;
      it.n8 = n8c;
      it.ow = ow;
      it.iw = a.in_w[j];
      it.org = a.in_org[j];
      it.chb = a.in_ch[j];  // a grouped conv: its item's group's inputs
      if (a.gstride[j]) it.chb += ((p0 + ng * ntc) / a.n8pg[j]) * a.gstride[j];
      it.M = M;
      it.ps = a.in_ps[j];
      it.kw = a.kw[j];
      it.step0 = s * a.spst[j];
      it.step1 = min(it.step0 + a.spst[j], a.steps[j]);
      if (a.mb[j] == 1)  // the same in every warp of a conv
        mma_item<1, NT, BF16>(ntc, acc, it, lane);
      else
        mma_item<2, NT, BF16>(ntc, acc, it, lane);
    }

    if (s == ns - 1 && mcount > 0) {
      // the epilogue of this item: lane (g, t) holds pixels g, g + 8 of
      // each m16 tile, channels 2t, 2t + 1 of each n8 tile
      const int g = lane >> 2, t = lane & 3;
      const bool relu = a.relu[j] != 0;
      const float* __restrict__ bias = a.bias[j];
      const int sh = a.shuffle[j], cpg = sh > 1 ? n8 * 8 / sh : 0;
      float* out = reinterpret_cast<float*>(smem + a.buf_off[a.out_buf[j]]) + a.out_ch[j];
      const int out_ps = a.out_ps[j], out_w = a.out_w[j], out_org = a.out_org[j];
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
          if (direct && a.pool) {
            if (inside) win = (oy / a.pool) * wins_x + ox / a.pool;
            same = __all_sync(0xffffffffu, win == __shfl_sync(0xffffffffu, win, t));
          }
#pragma unroll
          for (int ni = 0; ni < NT; ++ni) {
            if (ni >= ntc) continue;
            const int col = (p0 + ng * ntc + ni) * 8 + 2 * t;
            const float2 bv = __ldg(reinterpret_cast<const float2*>(bias + col));
            float v0 = acc[mi][ni][2 * half] + bv.x, v1 = acc[mi][ni][2 * half + 1] + bv.y;
            if (relu) {
              v0 = lrelu(v0);
              v1 = lrelu(v1);
            }
            int c0 = col, c1 = col + 1;  // where the shuffle puts the two channels
            if (sh > 1) {
              c0 = (c0 % cpg) * sh + c0 / cpg;
              c1 = (c1 % cpg) * sh + c1 / cpg;
            }
            if (!direct) {
              if (mok) {
                float* o = out + (out_org + oy * out_w + ox) * out_ps;
                if (!inside) v0 = v1 = 0.f;
                if (sh > 1) {
                  o[c0] = v0;
                  o[c1] = v1;
                } else {
                  *reinterpret_cast<float2*>(o + c0) = make_float2(v0, v1);
                }
              }
              continue;
            }
            if (inside && a.full) {
              float* f = a.full + (long long)b * a.fsb + (long long)gy * a.fsy + (long long)gx * a.fsx;
              if (sh == 1 && c1 < fout) {  // the two channels side by side
                f += c0 * a.fsc;
                f[0] = v0;
                f[a.fsc] = v1;
              } else {
                if (c0 < fout) f[c0 * a.fsc] = v0;
                if (c1 < fout) f[c1 * a.fsc] = v1;
              }
            }
            if (a.pool) {
              float s0 = win >= 0 ? v0 : 0.f, s1 = win >= 0 ? v1 : 0.f;
              if (same) {  // the 8 rows share a window: add them first
#pragma unroll
                for (int o = 4; o < 32; o <<= 1) {
                  s0 += __shfl_xor_sync(0xffffffffu, s0, o);
                  s1 += __shfl_xor_sync(0xffffffffu, s1, o);
                }
              }
              if (win >= 0 && (!same || g == 0)) {
                if (c0 < fout) atomicAdd(pool_acc + win * cout + c0, s0);
                if (c1 < fout) atomicAdd(pool_acc + win * cout + c1, s1);
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

  const int hp = a.pool ? a.H / a.pool : 0, wp = a.pool ? a.W / a.pool : 0;
  if (a.copy_out && part == 0) {
    // the last conv concatenates: the output's channels [fout, cout) are its
    // input, still in shared memory; the tile's pixels go out behind the
    // conv's own, and their pool sums into the window sums
    __syncthreads();
    const float* st = reinterpret_cast<const float*>(smem + a.buf_off[a.cp_buf]);
    const int tp = a.TH * a.TW, carry = cout - fout;
    const bool vec = a.cp_vec && a.fsc == 1 && !(a.fsx & 3) && !(a.fsy & 3) && !(a.fsb & 3) &&
                     !(reinterpret_cast<uintptr_t>(a.full) & 15);
    if (a.full && vec) {  // 4 channels a thread, whole pixels by consecutive threads
      const int q = carry >> 2;
      for (int i = tid; i < q * tp; i += THREADS) {
        const int pix = i / q, c = (i - pix * q) * 4;
        const int yy = pix / a.TW, xx = pix - yy * a.TW;
        if (y0 + yy < a.H && x0 + xx < a.W)
          *reinterpret_cast<float4*>(a.full + (long long)b * a.fsb + fout + c + (long long)(y0 + yy) * a.fsy +
                                     (long long)(x0 + xx) * a.fsx) =
              *reinterpret_cast<const float4*>(st + (a.cp_org + yy * a.cp_w + xx) * a.cp_ps + out_channel(a, c));
      }
    } else if (a.full) {
      for (int i = tid; i < carry * tp; i += THREADS) {
        int c, pix;
        if (a.fsc == 1) {  // channels fastest: whole rows of an NHWC output
          pix = i / carry;
          c = i - pix * carry;
        } else {
          c = i / tp;
          pix = i - c * tp;
        }
        const int yy = pix / a.TW, xx = pix - yy * a.TW;
        if (y0 + yy < a.H && x0 + xx < a.W)
          a.full[(long long)b * a.fsb + (fout + c) * a.fsc + (long long)(y0 + yy) * a.fsy +
                 (long long)(x0 + xx) * a.fsx] = st[(a.cp_org + yy * a.cp_w + xx) * a.cp_ps + out_channel(a, c)];
      }
    }
    for (int i = tid; i < nwin * carry; i += THREADS) {
      const int w = i / carry, c = i - w * carry, rc = out_channel(a, c);
      const int ly = (w / wins_x) * a.pool, lx = (w % wins_x) * a.pool;
      float sum = 0.f;
      for (int dy = 0; dy < a.pool; ++dy)
        for (int dx = 0; dx < a.pool; ++dx) sum += st[(a.cp_org + (ly + dy) * a.cp_w + lx + dx) * a.cp_ps + rc];
      pool_acc[w * cout + fout + c] = sum;
    }
  }
  if (pool_acc) {
    __syncthreads();
    const float inv = 1.0f / (float)(a.pool * a.pool);
    for (int i = tid; i < nwin * cout; i += THREADS) {
      const int w = i / cout, c = i - w * cout;
      const int wy = blockIdx.y * (a.TH / a.pool) + w / wins_x, wx = blockIdx.x * wins_x + w % wins_x;
      if (wy < hp && wx < wp) a.pooled[(((long long)b * cout + c) * hp + wy) * wp + wx] = pool_acc[i] * inv;
    }
  }
}

template <int NT, bool BF16>
int launch(const FusedConvsTcArgs& a, cudaStream_t stream) {
  const cudaError_t e =
      cudaFuncSetAttribute(fused_convs_tc<NT, BF16>, cudaFuncAttributeMaxDynamicSharedMemorySize, a.smem_bytes);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((a.W + a.TW - 1) / a.TW, (a.H + a.TH - 1) / a.TH, a.B * a.nsplit);
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

// the shapes the kernel relies on; false refuses the launch
bool valid(const FusedConvsTcArgs* a) {
  const int n = a->n, kc = a->bf16 ? 16 : 8;
  if (n < 1 || n > MAX_CONVS || a->ring < 1 || a->ring > MAX_RING || (a->nt != 2 && a->nt != 4 && a->nt != 8) ||
      (a->bf16 && a->nt == 8) || a->stage_bytes % 16 || a->ring_off % 16 || a->bar_off % 8 || a->cin < 1 ||
      a->cout < 1 || a->fout < 1 || a->fout > a->cout || (a->fout < a->cout) != (a->copy_out != 0) ||
      a->x_cw % kc || a->x_cw < a->cin || a->x_ch % 4 || a->x_ps % 4 || a->x_ps < a->x_ch + a->x_cw)
    return false;
  if (a->pool && (a->TH % a->pool || a->TW % a->pool)) return false;
  if (a->nsplit < 1 || (a->nsplit > 1 && (a->pool || a->n8[n - 1] % a->nsplit ||
                                          (a->n8[n - 1] / a->nsplit) % a->ntc[n - 1])))
    return false;
  if (a->copy_out && (a->nseg < 1 || a->nseg > MAX_CONVS + 1 || a->cp_ps % 4)) return false;
  for (int j = 0; j < n; ++j) {
    const int ng = a->n8pg[j] > 0 ? a->n8[j] / a->n8pg[j] : 0;
    if (a->ngrp[j] * a->ntc[j] * (j == n - 1 ? a->nsplit : 1) != a->n8[j]) return false;
    if (a->kw[j] < kc || a->kw[j] % kc || a->in_ch[j] % 4 || a->in_ps[j] % 4 || a->n8[j] < 1 || a->n8pg[j] < 1 ||
        a->n8[j] % a->n8pg[j] || a->ntc[j] < 1 || a->ntc[j] > a->nt || a->n8pg[j] % a->ntc[j] ||
        (a->nt == 8 && a->ntc[j] != 8) ||
        (a->ntc[j] & (a->ntc[j] - 1)) || a->in_ps[j] < a->in_ch[j] + (ng - 1) * a->gstride[j] + a->kw[j] ||
        a->steps[j] * 32 < 9 * a->kw[j] || a->mb[j] < 1 || a->mb[j] > MT || a->spst[j] < 1 || a->passes[j] < 1 ||
        a->shuffle[j] < 1 || (a->n8[j] * 8) % a->shuffle[j])
      return false;
    if (j < n - 1 && (a->out_ch[j] % 2 || a->out_ps[j] % 4 || a->out_ps[j] < a->out_ch[j] + a->n8[j] * 8)) return false;
  }
  return true;
}

}  // namespace

extern "C" int fused_convs_tc_launch(const FusedConvsTcArgs* a, cudaStream_t stream) {
  if (!valid(a)) return (int)cudaErrorInvalidValue;
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
