// K2: windowed local correlation of up to three levels in one launch,
// hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernel eemflow_tpu/ops/pallas/local_corr.py
// local_correlation_pallas (pallas_call in _forward at :78), which DMAs a
// halo'd row band of y into VMEM, pads C to the 128-lane tile and reduces
// each displacement on the vector unit; the JAX forward computes EEMFlow's
// three levels together before one concatenation
// (eemflow_tpu/models/eemflow.py:325-331).  For each level l:
//
//   out_l[b, y, x, j] = (1/C_l) * sum_c X_l[b, y, x, c] * Y_l[b, y + dy_j, x + dx_j, c]
//
// over the displacements idx[j] of the dy-major (2md+1)^2 window, zero
// outside the frame.  X, Y and the output are float32 or all bf16 (the
// training forward's mixed precision): bf16 operands are widened when
// staged, multiplied and summed in float32 and rounded to bf16 once, on the
// store (1/C is a power of two for EEMFlow's C = 16, 32 and 64, so the
// scaling rounds nothing).  Forward only: the backward is the plain
// version's autograd (kernels/local_corr.py LocalCorr, LocalCorrLevels).
//
// Bound on this card: at EEMFlow's shapes (three 12x20 grids with C = 16,
// 32 and 64, K = 53 at 720x1280) a forward is ~2.8 MFLOP and ~0.37 MB,
// far below a microsecond at either the 67 TFLOP/s float32 rate or the
// 3.35 TB/s memory rate: what it costs is launches, host time and the
// copies around them (the earlier design took a launch a level, each after
// copying its two permuted inputs).  So the design does all levels in one
// launch and reads the inputs where they lie:
//
//   * the level table (pointers, element strides of (b, h, w, c) for X, Y
//     and of (b, h, w, k) for the output, the tile plan) is one struct
//     passed by value, so EEMFlow's permuted NCHW views of its pooled
//     features are read through their strides with no copy, and each
//     output is written straight into the layout its consumer wants
//     (channels-first for the decoder's concatenation);
//   * one CTA per (level, sample, tile of rows x cols outputs; the plan,
//     kernels/local_corr.py plan_level, gives a 12x20 level 2 tiles a row):
//     it stages the tile's X and Y's halo (rows + 2md by cols + 2md, zero
//     outside the frame) in shared memory, channels in chunks of at most
//     cc.  The lanes of a warp walk the input's unit-stride dimension and
//     the warps its lines, with the lane's and the line's parts of each
//     address worked out once; an NCHW input is staged channel-planar, an
//     NHWC one position-major at an odd stride, so that neighbouring lanes
//     hit neighbouring banks both when staging and when reading;
//   * each thread owns up to OUT_PER_THREAD outputs, ordered displacement
//     first, then row, then column, so the lanes of a warp read
//     neighbouring positions and write neighbouring x; it reduces over C
//     from shared memory in channel order (fmaf), then multiplies by 1/C as
//     the plain version does.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

constexpr int MAX_LEVELS = 3;
constexpr int MAX_K = 289;  // a full window up to md = 8

// outside the anonymous namespace: the exported launch takes it
struct CorrLevel {
  const void* x;  // float or __nv_bfloat16, as CorrArgs::dtype says
  const void* y;
  void* out;
  long long xs[4], ys[4], os[4];  // element strides: (b, h, w, c) and (b, h, w, k)
  int B, H, W, C;
  int rows, cols, cc;   // output tile and channel chunk
  int cs;               // floats a staged position takes: cc, odd
  int bands, ctiles;    // tiles along h and w
  int first_block;      // this level's first CTA
  float inv_c;
};

struct CorrArgs {
  CorrLevel lv[MAX_LEVELS];
  int nlevels, K, md, blocks, smem_bytes;
  int dtype;  // DTYPE_F32 or DTYPE_BF16, every level's x, y and output
  int idx[MAX_K];
};

constexpr int DTYPE_F32 = 0;
constexpr int DTYPE_BF16 = 1;

namespace {

constexpr int THREADS = 512;
constexpr int OUT_PER_THREAD = 4;
constexpr int UNROLL = 8;          // staging loads a thread has in flight
constexpr int MAX_SMEM = 232448;   // what one block may opt into on sm_90

// Where a staged array keeps position p (row-major over its tile) and
// channel k: channels-innermost inputs (NHWC) position-major at an odd
// stride cs, so the lanes of a warp, which hold neighbouring positions,
// read different banks; other inputs (NCHW) channel-planar, so neighbouring
// columns are neighbouring words both when staged and when read.
struct Layout {
  int ps, ks;  // float offsets of one position and one channel
};

__device__ __forceinline__ Layout layout(bool channels_inner, int cs, int positions) {
  return channels_inner ? Layout{cs, 1} : Layout{1, positions};
}

__device__ __forceinline__ float load(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load(const __nv_bfloat16* p) { return __bfloat162float(__ldg(p)); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

// Element strides of one input, copied out of the parameter space once.
struct Strides {
  long long b, h, w, c;
};

// stage src[b][y0 + r][x0 + c][c0 + k] for r < nr, c < nc, k < cn as
// position r * ld + c of dst, zero outside [0, H) x [0, W): the lanes of a
// warp walk the input's unit-stride dimension (what depends on the lane is
// worked out once), the warps its lines, each thread UNROLL loads at a time;
// a bf16 input is widened to float32 as it is staged
template <typename T>
__device__ __forceinline__ void stage(float* dst, Layout lay, const T* __restrict__ src, Strides st,
                                      int b, int y0, int x0, int nr, int nc, int ld, int c0, int cn, int H,
                                      int W) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nwarps = THREADS / 32;
  const T* base = src + b * st.b + c0 * st.c;
  const bool channels_inner = st.c == 1;
  const int inner = channels_inner ? cn : nc;  // along the unit stride
  const int span = channels_inner ? nc : cn;   // the other dimension within a row
  const int lines = nr * span;
  for (int i = lane; i - lane < inner; i += 32) {
    // the lane's part: channel i (NHWC) or column i (otherwise)
    const int xi = x0 + i;
    const bool lane_ok = i < inner && (channels_inner || (xi >= 0 && xi < W));
    const long long lane_g = channels_inner ? (long long)i : xi * st.w;
    const int lane_s = channels_inner ? i * lay.ks : i * lay.ps;
    int r = warp / span, q = warp % span;  // this warp's first line: row r, column or channel q
    for (int line = warp; line < lines; line += nwarps * UNROLL) {
      float v[UNROLL];
      int so[UNROLL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const int y = y0 + r, xq = x0 + q;
        const bool ok = lane_ok && line + u * nwarps < lines && y >= 0 && y < H &&
                        (!channels_inner || (xq >= 0 && xq < W));
        const long long g = y * st.h + (channels_inner ? xq * st.w : q * st.c);
        so[u] = line + u * nwarps < lines ? r * ld * lay.ps + (channels_inner ? q * lay.ps : q * lay.ks) : -1;
        v[u] = ok ? load(base + g + lane_g) : 0.0f;
        q += nwarps;
        if (q >= span) {
          r += q / span;
          q %= span;
        }
      }
#pragma unroll
      for (int u = 0; u < UNROLL; ++u)
        if (i < inner && so[u] >= 0) dst[so[u] + lane_s] = v[u];
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS) local_corr_levels(const __grid_constant__ CorrArgs a) {
  extern __shared__ float smem[];
  int l = 0;
  while (l + 1 < a.nlevels && (int)blockIdx.x >= a.lv[l + 1].first_block) ++l;
  // this level's fields, out of the parameter space once
  const CorrLevel& L = a.lv[l];
  const T* __restrict__ X = static_cast<const T*>(L.x);
  const T* __restrict__ Y = static_cast<const T*>(L.y);
  T* __restrict__ out = static_cast<T*>(L.out);
  const Strides xst{L.xs[0], L.xs[1], L.xs[2], L.xs[3]};
  const Strides yst{L.ys[0], L.ys[1], L.ys[2], L.ys[3]};
  const Strides ost{L.os[0], L.os[1], L.os[2], L.os[3]};
  const int H = L.H, W = L.W, C = L.C, trows = L.rows, tcols = L.cols, cc = L.cc, cs = L.cs;
  const float inv_c = L.inv_c;
  int rel = blockIdx.x - L.first_block;
  const int ct = rel % L.ctiles;
  rel /= L.ctiles;
  const int band = rel % L.bands;
  const int b = rel / L.bands;
  const int y0 = band * trows, x0 = ct * tcols;
  const int rows = min(trows, H - y0), cols = min(tcols, W - x0);
  const int md = a.md, win = 2 * md + 1, K = a.K;
  const int hc = tcols + 2 * md;  // the halo's row length
  const int xpos = trows * tcols, ypos = (trows + 2 * md) * hc;
  const Layout xl = layout(xst.c == 1, cs, xpos);
  const Layout yl = layout(yst.c == 1, cs, ypos);
  float* xs = smem;
  float* ys = smem + xpos * cs;
  const int npix = rows * cols;
  const int nout = npix * K;

  float acc[OUT_PER_THREAD];
#pragma unroll
  for (int i = 0; i < OUT_PER_THREAD; ++i) acc[i] = 0.0f;
  for (int c0 = 0; c0 < C; c0 += cc) {
    const int cn = min(cc, C - c0);
    __syncthreads();  // the previous chunk has been read
    stage(xs, xl, X, xst, b, y0, x0, rows, cols, tcols, c0, cn, H, W);
    stage(ys, yl, Y, yst, b, y0 - md, x0 - md, rows + 2 * md, cols + 2 * md, hc, c0, cn, H, W);
    __syncthreads();
#pragma unroll
    for (int i = 0; i < OUT_PER_THREAD; ++i) {
      const int o = threadIdx.x + i * THREADS;
      if (o < nout) {
        const int j = o / npix, p = o % npix;
        const int r = p / cols, c = p % cols;
        const int d = a.idx[j];
        const float* xp = xs + (r * tcols + c) * xl.ps;
        const float* yp = ys + ((r + d / win) * hc + c + d % win) * yl.ps;
        float s = acc[i];
#pragma unroll 4
        for (int k = 0; k < cn; ++k) s = fmaf(xp[k * xl.ks], yp[k * yl.ks], s);  // channel order
        acc[i] = s;
      }
    }
  }
#pragma unroll
  for (int i = 0; i < OUT_PER_THREAD; ++i) {
    const int o = threadIdx.x + i * THREADS;
    if (o < nout) {
      const int j = o / npix, p = o % npix;
      const int r = p / cols, c = p % cols;
      store(out + b * ost.b + (y0 + r) * ost.h + (x0 + c) * ost.w + j * ost.c, acc[i] * inv_c);
    }
  }
}

}  // namespace

// lets the binding check that its mirror of the struct has the same size
extern "C" int local_corr_args_size() { return (int)sizeof(CorrArgs); }


namespace {

template <typename T>
int launch(const CorrArgs& a, cudaStream_t stream) {
  static int allowed[64];  // the shared memory each device has opted into, by device
  int dev = 0;
  cudaGetDevice(&dev);
  if (a.smem_bytes > 48 * 1024 && (dev >= 64 || a.smem_bytes > allowed[dev])) {
    const cudaError_t e =
        cudaFuncSetAttribute(local_corr_levels<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, a.smem_bytes);
    if (e != cudaSuccess) return (int)e;
    if (dev < 64) allowed[dev] = a.smem_bytes;
  }
  local_corr_levels<T><<<a.blocks, THREADS, a.smem_bytes, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int local_corr_levels_launch(const CorrArgs* args, cudaStream_t stream) {
  const CorrArgs& a = *args;
  if (a.blocks <= 0) return (int)cudaSuccess;
  if (a.nlevels < 1 || a.nlevels > MAX_LEVELS || a.K < 1 || a.K > MAX_K || a.smem_bytes > MAX_SMEM ||
      (a.dtype != DTYPE_F32 && a.dtype != DTYPE_BF16))
    return (int)cudaErrorInvalidValue;
  for (int l = 0; l < a.nlevels; ++l)
    if (a.lv[l].rows * a.lv[l].cols * a.K > THREADS * OUT_PER_THREAD || a.lv[l].cc < 1 ||
        a.lv[l].cs < a.lv[l].cc || a.lv[l].cs % 2 == 0)
      return (int)cudaErrorInvalidValue;
  return a.dtype == DTYPE_BF16 ? launch<__nv_bfloat16>(a, stream) : launch<float>(a, stream);
}
