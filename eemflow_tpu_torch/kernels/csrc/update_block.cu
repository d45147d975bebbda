// K5: the RAFT update block without its mask head, hand-written for Hopper
// (sm_90a), as two entry points run once each per refinement iteration.
//
// Replaces the TPU kernels eemflow_tpu/ops/pallas/update_block.py
// motion_encoder_fused (:236, pallas_call at :247) and gru_flowhead_fused
// (:261, at :271), which walk row bands of the 1/8 grid through VMEM with
// whole weight tables resident and recompute a 5- or 6-row halo per band.
//
// What it computes (NHWC; every conv pads its input with zeros, "same"):
//   update_block_motion_launch: c = relu(convc2(relu(convc1(corr))))
//     (1x1 324->256, 3x3 ->192), f = relu(convf2(relu(convf1(flow))))
//     (7x7 2->128, 3x3 ->64), motion = [relu(conv([c, f])) (3x3 ->126), flow];
//   update_block_gru_launch: for the 1x5 stage, then the 5x1 stage,
//     z = sigmoid(convz([h, inp, motion])), r = sigmoid(convr(...)),
//     q = tanh(convq([r*h, inp, motion])), h = (1 - z)*h + z*q;
//     then delta = conv2(relu(conv1(h))) (3x3 128->256, 3x3 ->2).
//
// Bounds on this card: at ERAFT's 720x1280 grid (padded 736x1280, so 92x160
// at 1/8) one iteration does 78.8 GFLOP against ~68 MB of inputs, outputs
// and weights (0.02 ms at 3.35 TB/s), so both modes are bound by
// operations.  float32 mode: the three TF32 products of the split below are
// the least that keeps float32 accuracy on the tensor cores, 3 x 78.8 GFLOP
// at 495 TFLOP/s = 0.478 ms (0.249 at 64x120; float32 outside the tensor
// cores, 67 TFLOP/s, would give 1.176 ms).  bf16 mode: 78.8 GFLOP at 989
// TFLOP/s = 0.080 ms (0.042 at 64x120).
//
// Design (kernel in update_block.cuh; one launch per conv, 5 for the motion
// encoder and 6 for the GRU and flow head, intermediates in scratch the
// wrapper allocates):
//
//   * implicit GEMM: M = B*H*W pixels, N = output channels, K = taps x
//     input channels, walked in steps of BK = 32 K values: one tap, 32
//     channels of one source (a conv reads up to three, so [h, inp, motion]
//     and [c, f] are never built);
//   * operand modes.  float32 (the default): split TF32 on
//     mma.sync.m16n8k8.tf32, x = big + small with big = cvt.rna.tf32(x),
//     small = cvt.rna.tf32(x - big), summing big*big + big*small +
//     small*big in float32.  The weights are split once, when packed (two
//     planes); the activations after ldmatrix brings them out of shared
//     memory.  One TF32 product alone misses K5's 1e-5 tolerance by ~25x;
//     the split keeps ~12x of margin, provided the sums stay short: the
//     tensor cores round a running sum toward zero, which along K ~ 2,000
//     missed the tolerance by 2.5x, so a step's twelve products per output
//     go to a fresh partial sum, added to the accumulator in float32.  bf16: mma.sync.m16n8k16.bf16 with
//     float32 sums; the weights are packed as bf16, the activations stay
//     float32 in shared memory and are rounded to bf16 (nearest even) as
//     the A fragment is built.  Rounding there, not in K5's epilogues,
//     keeps one loader for both modes and needs no bf16 copies of corr,
//     net and inp, which come from outside in float32; it costs two
//     conversions per four A values, against a k16 MMA per 8 columns;
//   * an asynchronous ring of STAGES steps in dynamic shared memory (above
//     48 KB, set once per device by the entry points).  A by cp.async, one
//     16-byte copy per 4 channels of a pixel row, zero-filled (src-size 0)
//     for taps outside the image, channels past a source's end and pixels
//     past M, so there are no bounds-checked loads; convf1's 2-channel flow
//     (K = 98) has a gather of its own, 16 taps of 8 bytes a step, K padded
//     to 128 with zeros.  B, the weights, packed per (step, 8 output
//     channels) in mma fragment order, so that a CTA's B tile of a step is
//     one contiguous run: one cp.async.bulk (Hopper's bulk copy) issued by
//     one thread, completing on the stage's mbarrier, and a warp reads a
//     fragment plane with one conflict-free 8-byte load per lane.  Step
//     s + STAGES - 1 is issued before the MMAs of step s; a step waits for
//     its A group (cp.async.wait_group + __syncthreads) and its mbarrier
//     phase (a wait that never completes traps instead of hanging);
//   * tiles chosen per conv so that a launch fills the 132 SMs (at 92x160
//     M = 14,720 pixels): WIDE 128x128 (8 warps of 32x64, 4 stages) where
//     N is a multiple of 128 and it gives >= 132 CTAs (the N = 256 convs:
//     230 CTAs), else MID 128x64 (4 warps of 32x64, 3 stages; N = 192,
//     128: 345 and 230 CTAs), else NARROW 64x64 (4 warps of 32x32; N = 64:
//     230 CTAs, and N = 128, 256 at 64x120); THIN 64x8 (4 warps of 16x8,
//     6 stages) for the flow head's N = 2, padded to one n8 column tile;
//   * resources (-Xptxas -v, CUDA 12.8, and the occupancy query): float32
//     mode WIDE 206 registers, 204,832 B of dynamic shared memory, 1 CTA an
//     SM; MID 211, 104,472 B, 2; NARROW 125, 76,824 B, 2; THIN 39, 67,632
//     B, 3; bf16 mode WIDE 128, 106,528 B, 2; MID 134, 67,608 B, 3; NARROW
//     72, 39,960 B, 5; THIN 48, 58,416 B, 3; no spills.  chip_smoke.py
//     prints them for the build it runs (update_block_kernel_info and the
//     ptxas lines);
//   * the epilogue adds the bias and applies ReLU (and copies the flow into
//     motion's last two channels), or nothing, or the z/r gates (one
//     256-wide conv: sigmoid, z stored, r*h stored for the q conv), or tanh
//     and the GRU combine (1 - z)*h + z*q, two channels per store.  Gates
//     are computed only for pixels inside the image, so sigma(0) = 1/2
//     never enters a padding.
//
// Inputs are read as pixel-linear NHWC: element (pixel m, channel c) at
// p[m * sx + c].  The wrapper (kernels/update_block.py) copies a tensor that
// is not (an NCHW view, a misaligned pointer) and counts the copy.
//
// Left for later work: loads and MMAs barely overlap here, and even without
// its loads the float32 loop stays well short of the mma.sync rate (a
// barrier per step, the split's conversions, one CTA of 8 warps an SM).  The
// next design is warp-specialised: a producer warp keeping TMA/bulk loads
// in flight, consumer warpgroups on wgmma (the z|r and q convs are 55% of
// the FLOP); then fusing the convs of a GRU stage and bf16 activations for
// the bf16 mode.

#include "update_block.cuh"

using namespace k5;

namespace {

constexpr int NCONV = 11;

}  // namespace

// An NHWC tensor read as pixel-linear: element (pixel m, channel c) at
// p[m * sx + c]; mirrored by _Plane in kernels/update_block.py.
struct Plane {
  float* p;
  long long sx;
};

// Mirrored field for field by the ctypes Structure in kernels/update_block.py.
struct UpdateBlockArgs {
  Plane corr, flow, net, inp;           // inputs
  Plane motion, net_out, delta;         // outputs (motion: out of the first entry, in to the second)
  Plane c1, c2, f1, f2, z, rh, h1, d1;  // scratch
  // convc1, convc2, convf1, convf2, conv, zr1, q1, zr2, q2, head1, head2:
  // packed weights (two TF32 planes as float32, or bf16), bias, padded N
  const void* w[NCONV];
  const float* b[NCONV];
  int n_pad[NCONV];
  int B, H, W, corr_c, hidden, context, bf16;
};

namespace {

ConvDesc conv(const UpdateBlockArgs* a, int i, int KH, int KW, int cout, int epi, Plane out) {
  ConvDesc d = {};
  d.w = a->w[i];
  d.bias = a->b[i];
  d.n8 = a->n_pad[i] / 8;
  d.KH = KH;
  d.KW = KW;
  d.cout = cout;
  d.epi = epi;
  d.out = out.p;
  d.out_sx = (int)out.sx;
  d.M = a->B * a->H * a->W;
  d.H = a->H;
  d.W = a->W;
  return d;
}

void add_src(ConvDesc& d, Plane t, int C) {
  d.src[d.nsrc].p = t.p;
  d.src[d.nsrc].sx = (int)t.sx;
  d.src[d.nsrc].C = C;
  d.nsrc += 1;
}

// the CTA tile of a conv: the widest that still gives every SM a CTA
int choose_tile(int M, int n_pad, int sms) {
  if (n_pad <= 8) return TILE_THIN;
  const int m128 = (M + 127) / 128;
  if (n_pad % 128 == 0 && m128 * (n_pad / 128) >= sms) return TILE_WIDE;
  if (m128 * (n_pad / 64) >= sms) return TILE_MID;
  return TILE_NARROW;
}

cudaError_t run(ConvDesc& d, bool bf16, int sms, cudaStream_t stream) {
  if (d.gather) {
    d.steps_per_tap = 0;
    d.nsteps = (d.KH * d.KW * 2 + BK - 1) / BK;
  } else {
    d.steps_per_tap = 0;
    for (int s = 0; s < d.nsrc; ++s) d.steps_per_tap += (d.src[s].C + BK - 1) / BK;
    d.nsteps = d.KH * d.KW * d.steps_per_tap;
  }
  const int tile = choose_tile(d.M, d.n8 * 8, sms);
  return bf16 ? run_conv_bf16(d, tile, stream) : run_conv_tf32(d, tile, stream);
}

// the kernels' shared memory attributes (once per device) and the SM count
cudaError_t prepare(bool bf16, int* sms) {
  cudaError_t e = bf16 ? prepare_bf16() : prepare_tf32();
  if (e != cudaSuccess) return e;
  int dev = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return e;
  return cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
}

}  // namespace

extern "C" int update_block_motion_launch(const UpdateBlockArgs* a, cudaStream_t stream) {
  const bool bf16 = a->bf16 != 0;
  int sms = 0;
  cudaError_t e = prepare(bf16, &sms);
  if (e != cudaSuccess) return (int)e;
  ConvDesc d = conv(a, 0, 1, 1, 256, EPI_RELU, a->c1);
  add_src(d, a->corr, a->corr_c);
  if ((e = run(d, bf16, sms, stream)) != cudaSuccess) return (int)e;
  d = conv(a, 1, 3, 3, 192, EPI_RELU, a->c2);
  add_src(d, a->c1, 256);
  if ((e = run(d, bf16, sms, stream)) != cudaSuccess) return (int)e;
  d = conv(a, 2, 7, 7, 128, EPI_RELU, a->f1);
  add_src(d, a->flow, 2);
  d.gather = 1;
  if ((e = run(d, bf16, sms, stream)) != cudaSuccess) return (int)e;
  d = conv(a, 3, 3, 3, 64, EPI_RELU, a->f2);
  add_src(d, a->f1, 128);
  if ((e = run(d, bf16, sms, stream)) != cudaSuccess) return (int)e;
  d = conv(a, 4, 3, 3, 126, EPI_RELU, a->motion);
  add_src(d, a->c2, 192);
  add_src(d, a->f2, 64);
  d.copy = a->flow.p;
  d.copy_sx = (int)a->flow.sx;
  d.ncopy = 2;
  return (int)run(d, bf16, sms, stream);
}

extern "C" int update_block_gru_launch(const UpdateBlockArgs* a, cudaStream_t stream) {
  const bool bf16 = a->bf16 != 0;
  int sms = 0;
  cudaError_t e = prepare(bf16, &sms);
  if (e != cudaSuccess) return (int)e;
  const int hd = a->hidden;
  const Plane h_in[2] = {a->net, a->h1};
  const Plane h_out[2] = {a->h1, a->net_out};
  for (int stage = 0; stage < 2; ++stage) {
    const int KH = stage == 0 ? 1 : 5;
    const int KW = stage == 0 ? 5 : 1;
    ConvDesc d = conv(a, 5 + 2 * stage, KH, KW, 2 * hd, EPI_ZR, a->z);
    add_src(d, h_in[stage], hd);
    add_src(d, a->inp, a->context);
    add_src(d, a->motion, 128);
    d.out2 = a->rh.p;
    d.out2_sx = (int)a->rh.sx;
    d.hsrc = h_in[stage].p;
    d.h_sx = (int)h_in[stage].sx;
    if ((e = run(d, bf16, sms, stream)) != cudaSuccess) return (int)e;
    d = conv(a, 6 + 2 * stage, KH, KW, hd, EPI_GRU, h_out[stage]);
    add_src(d, a->rh, hd);
    add_src(d, a->inp, a->context);
    add_src(d, a->motion, 128);
    d.zbuf = a->z.p;
    d.z_sx = (int)a->z.sx;
    d.hsrc = h_in[stage].p;
    d.h_sx = (int)h_in[stage].sx;
    if ((e = run(d, bf16, sms, stream)) != cudaSuccess) return (int)e;
  }
  ConvDesc d = conv(a, 9, 3, 3, 256, EPI_RELU, a->d1);
  add_src(d, a->net_out, hd);
  if ((e = run(d, bf16, sms, stream)) != cudaSuccess) return (int)e;
  d = conv(a, 10, 3, 3, 2, EPI_LINEAR, a->delta);
  add_src(d, a->d1, 256);
  return (int)run(d, bf16, sms, stream);
}

extern "C" int update_block_args_size() { return (int)sizeof(UpdateBlockArgs); }

// info[0..7] of the conv kernel for one tile (TILE_WIDE .. TILE_THIN) and
// mode: BM, BN, threads, ring stages, dynamic shared bytes, registers,
// local (spill) bytes, CTAs an SM holds
extern "C" int update_block_kernel_info(int tile, int bf16, int* info) {
  if (tile < 0 || tile >= NTILES) return (int)cudaErrorInvalidValue;
  int sms = 0;
  cudaError_t e = prepare(bf16 != 0, &sms);  // the occupancy query needs the shared memory attribute
  if (e != cudaSuccess) return (int)e;
  return (int)(bf16 ? kernel_info_bf16(tile, info) : kernel_info_tf32(tile, info));
}
