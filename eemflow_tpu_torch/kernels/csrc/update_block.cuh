// K5 internals shared by update_block.cu (the entry points and the conv
// sequence) and the two instance files update_block_tf32.cu and
// update_block_bf16.cu, which each compile the conv kernel for one operand
// mode so that nvcc builds the two in parallel.  The design note is at the
// top of update_block.cu.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tensor_core.cuh"

namespace k5 {

constexpr int MAX_SRC = 3;
// K values a step brings in: 32 input channels of one tap, or for the
// 2-channel flow 16 taps of 2 channels
constexpr int BK = 32;
// A tile row stride in floats (144 bytes): the 8 rows an ldmatrix reads
// start on 8 different groups of 4 banks
constexpr int A_LD = BK + 4;

enum Epilogue { EPI_RELU = 0, EPI_LINEAR = 1, EPI_ZR = 2, EPI_GRU = 3 };
enum Tile { TILE_WIDE = 0, TILE_MID = 1, TILE_NARROW = 2, TILE_THIN = 3, NTILES = 4 };

// CTA tile (BM pixels x BN output channels), warps along M and N, ring depth
template <int T> struct TileCfg;
template <> struct TileCfg<TILE_WIDE> { static constexpr int BM = 128, BN = 128, WM = 4, WN = 2, STAGES = 4; };
template <> struct TileCfg<TILE_MID> { static constexpr int BM = 128, BN = 64, WM = 4, WN = 1, STAGES = 3; };
template <> struct TileCfg<TILE_NARROW> { static constexpr int BM = 64, BN = 64, WM = 2, WN = 2, STAGES = 3; };
template <> struct TileCfg<TILE_THIN> { static constexpr int BM = 64, BN = 8, WM = 4, WN = 1, STAGES = 6; };

// bytes of one packed weight block: 8 output channels x BK K values in mma
// fragment order; float32 mode holds the big and the small TF32 plane, each
// k8 step's big plane then its small one, 32 lanes x 8 bytes each
template <bool BF16> __host__ __device__ constexpr int block_bytes() { return BF16 ? 8 * BK * 2 : 8 * BK * 4 * 2; }

template <int T, bool BF16> constexpr int smem_bytes() {
  using C = TileCfg<T>;
  return C::STAGES * (C::BM * A_LD * 4 + C::BN / 8 * block_bytes<BF16>() + 8);  // + an mbarrier a stage
}

// an input read through the fast loader: element (pixel m, channel c) at
// p[m * sx + c], sx a multiple of 4 (of 2 for the flow), p 16-byte aligned
// (8 for the flow)
struct Src {
  const float* p;
  int sx, C;
};

struct ConvDesc {
  Src src[MAX_SRC];
  int nsrc;
  int gather;  // 1: the 2-channel flow, 16 taps a step
  int steps_per_tap, nsteps;
  const void* w;       // [nsteps][n8][block] in fragment order
  const float* bias;   // [n8 * 8]
  int n8;
  int KH, KW, cout, ncopy, epi;
  float* out;
  int out_sx;
  float* out2;  // EPI_ZR: r*h
  int out2_sx;
  const float* hsrc;  // EPI_ZR, EPI_GRU: the stage's h
  int h_sx;
  const float* zbuf;  // EPI_GRU: z
  int z_sx;
  const float* copy;  // EPI_RELU: channels [cout, cout + ncopy) of out copied from here
  int copy_sx;
  int M, H, W;
};

// defined in update_block_tf32.cu and update_block_bf16.cu: the dynamic
// shared memory attributes of the mode's kernels (once per device), one
// conv launch, and a kernel's tile, registers and occupancy
cudaError_t prepare_tf32();
cudaError_t prepare_bf16();
cudaError_t run_conv_tf32(const ConvDesc& d, int tile, cudaStream_t stream);
cudaError_t run_conv_bf16(const ConvDesc& d, int tile, cudaStream_t stream);
cudaError_t kernel_info_tf32(int tile, int* info);
cudaError_t kernel_info_bf16(int tile, int* info);

#ifdef __CUDACC__

using namespace tc;

__device__ __forceinline__ float2 ld2(const float* base, int sx, int m, int c) {
  return *reinterpret_cast<const float2*>(base + (long long)m * sx + c);
}

__device__ __forceinline__ void st2(float* base, int sx, int m, int c, float a, float b) {
  *reinterpret_cast<float2*>(base + (long long)m * sx + c) = make_float2(a, b);
}

__device__ __forceinline__ float sigmoid(float v) { return 1.f / (1.f + expf(-v)); }

// output channels n, n + 1 (n even) of pixel m, before the bias
__device__ __forceinline__ void epilogue(const ConvDesc& d, int m, int n, float v0, float v1) {
  const float2 b = *reinterpret_cast<const float2*>(d.bias + n);
  v0 += b.x;
  v1 += b.y;
  switch (d.epi) {
    case EPI_RELU:
      if (n < d.cout) {
        st2(d.out, d.out_sx, m, n, fmaxf(v0, 0.f), fmaxf(v1, 0.f));
      } else if (n < d.cout + d.ncopy) {
        const float2 c = ld2(d.copy, d.copy_sx, m, n - d.cout);
        st2(d.out, d.out_sx, m, n, c.x, c.y);
      }
      break;
    case EPI_LINEAR:
      if (n < d.cout) st2(d.out, d.out_sx, m, n, v0, v1);
      break;
    case EPI_ZR: {
      const int half = d.cout / 2;
      if (n < half) {
        st2(d.out, d.out_sx, m, n, sigmoid(v0), sigmoid(v1));
      } else if (n < d.cout) {
        const float2 h = ld2(d.hsrc, d.h_sx, m, n - half);
        st2(d.out2, d.out2_sx, m, n - half, sigmoid(v0) * h.x, sigmoid(v1) * h.y);
      }
      break;
    }
    case EPI_GRU:
      if (n < d.cout) {
        const float2 z = ld2(d.zbuf, d.z_sx, m, n);
        const float2 h = ld2(d.hsrc, d.h_sx, m, n);
        st2(d.out, d.out_sx, m, n, (1.f - z.x) * h.x + z.x * tanhf(v0), (1.f - z.y) * h.y + z.y * tanhf(v1));
      }
      break;
  }
}

// One "same" zero-padded conv as an implicit GEMM: M = pixels, N = output
// channels, K = taps x input channels, on the tensor cores.  Each step
// brings BK K values of A (one tap, 32 channels of one source, gathered
// by cp.async with zero fill) and the matching packed weight blocks of B
// (one bulk copy into the stage's mbarrier) into a STAGES-deep ring in
// shared memory; step s + STAGES - 1 is issued before the MMAs of step s.
template <int T, bool BF16>
__global__ void __launch_bounds__(TileCfg<T>::WM * TileCfg<T>::WN * 32) conv_tc(const __grid_constant__ ConvDesc d) {
  using C = TileCfg<T>;
  constexpr int BM = C::BM, BN = C::BN, WN = C::WN, STAGES = C::STAGES;
  constexpr int NTHR = C::WM * WN * 32;
  constexpr int WTM = BM / C::WM, WTN = BN / WN;  // warp tile
  constexpr int MT = WTM / 16, NT = WTN / 8;      // mma tiles of a warp
  constexpr int ROW_STEP = NTHR / 8;              // 8 threads load a row (8 x 16 bytes)
  constexpr int ROWS = BM / ROW_STEP;             // rows a thread loads
  constexpr int A_BYTES = BM * A_LD * 4;
  constexpr int B_BYTES = BN / 8 * block_bytes<BF16>();
  static_assert(WTM % 16 == 0 && WTN % 8 == 0 && BM % ROW_STEP == 0 && B_BYTES % 16 == 0, "tile shape");

  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t sA = smem_u32(smem);
  const uint32_t sB = sA + STAGES * A_BYTES;
  const unsigned char* sBp = smem + STAGES * A_BYTES;
  const uint32_t bars = sB + STAGES * B_BYTES;  // one mbarrier a stage: its B tile landed

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp / WN, wn = warp % WN;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;

  // the pixels whose rows this thread loads: rows r_first + i * ROW_STEP
  const int c8 = tid & 7, r_first = tid >> 3;
  int ry[ROWS], rx[ROWS];
#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    const int m = m0 + r_first + i * ROW_STEP;
    if (m < d.M) {
      rx[i] = m % d.W;
      ry[i] = (m / d.W) % d.H;
    } else {  // past the last pixel: every tap reads outside the image
      rx[i] = 0;
      ry[i] = -(1 << 20);
    }
  }

  auto load = [&](int step, int buf) {
    const uint32_t a = sA + buf * A_BYTES;
    if (!d.gather) {
      const int tap = step / d.steps_per_tap;
      int r = step - tap * d.steps_per_tap;  // the step within the tap: source, then BK channels
      const float* p = d.src[0].p;
      int sx = d.src[0].sx, C = d.src[0].C;
#pragma unroll
      for (int s = 1; s < MAX_SRC; ++s) {
        const int n = (C + BK - 1) / BK;
        if (s < d.nsrc && r >= n) {
          r -= n;
          p = d.src[s].p;
          sx = d.src[s].sx;
          C = d.src[s].C;
        }
      }
      const int c = r * BK + c8 * 4;
      const bool cok = c < C;
      const int dy = tap / d.KW - d.KH / 2, dx = tap % d.KW - d.KW / 2;
      const int shift = dy * d.W + dx;
#pragma unroll
      for (int i = 0; i < ROWS; ++i) {
        const int row = r_first + i * ROW_STEP;
        const int y = ry[i] + dy, x = rx[i] + dx;
        const bool ok = cok && (unsigned)y < (unsigned)d.H && (unsigned)x < (unsigned)d.W;
        const float* g = ok ? p + (long long)(m0 + row + shift) * sx + c : p;
        cp_async16(a + (row * A_LD + c8 * 4) * 4, g, ok ? 16 : 0);
      }
    } else {
      const float* p = d.src[0].p;
      const int sx = d.src[0].sx;
#pragma unroll
      for (int h = 0; h < BK / 16; ++h) {
        const int j = c8 + 8 * h;  // the tap within the step: K values 2j, 2j + 1
        const int tap = step * (BK / 2) + j;
        const bool tok = tap < d.KH * d.KW;
        const int dy = tap / d.KW - d.KH / 2, dx = tap % d.KW - d.KW / 2;
        const int shift = dy * d.W + dx;
#pragma unroll
        for (int i = 0; i < ROWS; ++i) {
          const int row = r_first + i * ROW_STEP;
          const int y = ry[i] + dy, x = rx[i] + dx;
          const bool ok = tok && (unsigned)y < (unsigned)d.H && (unsigned)x < (unsigned)d.W;
          const float* g = ok ? p + (long long)(m0 + row + shift) * sx : p;
          cp_async8(a + (row * A_LD + 2 * j) * 4, g, ok ? 8 : 0);
        }
      }
    }
    // the step's B tile is one contiguous run of the packed weights
    if (tid == 0)
      bulk_copy(sB + buf * B_BYTES,
                static_cast<const unsigned char*>(d.w) + ((long long)step * d.n8 + n0 / 8) * block_bytes<BF16>(),
                B_BYTES, bars + 8 * buf);
  };

  float acc[MT][NT][4];
#pragma unroll
  for (int mi = 0; mi < MT; ++mi)
#pragma unroll
    for (int ni = 0; ni < NT; ++ni)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[mi][ni][q] = 0.f;

  // ldmatrix rows: lanes 0-7 and 16-23 rows 0-7, lanes 8-15 and 24-31 rows
  // 8-15; lanes 16-31 the second 4 floats (a2, a3 of the tf32 fragment)
  uint32_t a_off[MT];
#pragma unroll
  for (int mi = 0; mi < MT; ++mi)
    a_off[mi] = ((wm * WTM + mi * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * A_LD + (lane >> 4) * 4) * 4;

  if (tid == 0) {
    for (int i = 0; i < STAGES; ++i) mbar_init(bars + 8 * i, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int nsteps = d.nsteps;
#pragma unroll
  for (int st = 0; st < STAGES - 1; ++st) {
    if (st < nsteps) load(st, st);
    cp_async_commit();
  }
  for (int step = 0; step < nsteps; ++step) {
    cp_async_wait<STAGES - 2>();  // this thread's A copies of step `step` landed
    __syncthreads();              // everyone's did, and step - 1's buffers are free
    const int next = step + STAGES - 1;
    if (next < nsteps) load(next, next % STAGES);
    cp_async_commit();
    const int buf = step % STAGES;
    mbar_wait(bars + 8 * buf, (step / STAGES) & 1);
    const uint32_t a = sA + buf * A_BYTES;
    const unsigned char* b = sBp + buf * B_BYTES;
    if constexpr (!BF16) {
      // split TF32: x = big + small; small*big, big*small, then big*big,
      // each as one pass over the warp's MT x NT accumulators, so that
      // consecutive MMAs never wait on each other.  The tensor cores round
      // a running sum toward zero, which over a K of ~2,000 biases it by
      // ~1e-4 of its size; so a step's twelve products per output go to a
      // fresh partial sum, added to acc in float32.
      float part[MT][NT][4];
#pragma unroll
      for (int kk = 0; kk < BK / 8; ++kk) {
        uint32_t big[MT][4], small[MT][4];
#pragma unroll
        for (int mi = 0; mi < MT; ++mi) {
          uint32_t r[4];
          ldsm_x4(a + a_off[mi] + kk * 32, r);
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const float x = __uint_as_float(r[q]);
            big[mi][q] = to_tf32(x);
            small[mi][q] = to_tf32(x - __uint_as_float(big[mi][q]));
          }
        }
        // the warp's fragments of the big (plane 0) and small (plane 1)
        // weights, each read once
        uint2 wb[NT], ws[NT];
#pragma unroll
        for (int ni = 0; ni < NT; ++ni) {
          const unsigned char* wk = b + ((((wn * NT + ni) * (BK / 8) + kk) * 2) * 32 + lane) * 8;
          wb[ni] = *reinterpret_cast<const uint2*>(wk);
          ws[ni] = *reinterpret_cast<const uint2*>(wk + 32 * 8);
        }
#pragma unroll
        for (int ni = 0; ni < NT; ++ni)
#pragma unroll
          for (int mi = 0; mi < MT; ++mi) {
            if (kk == 0) {
              mma_tf32_zero(part[mi][ni], small[mi], wb[ni].x, wb[ni].y);
            } else {
              mma_tf32(part[mi][ni], small[mi], wb[ni].x, wb[ni].y);
            }
          }
#pragma unroll
        for (int ni = 0; ni < NT; ++ni)
#pragma unroll
          for (int mi = 0; mi < MT; ++mi) mma_tf32(part[mi][ni], big[mi], ws[ni].x, ws[ni].y);
#pragma unroll
        for (int ni = 0; ni < NT; ++ni)
#pragma unroll
          for (int mi = 0; mi < MT; ++mi) mma_tf32(part[mi][ni], big[mi], wb[ni].x, wb[ni].y);
      }
#pragma unroll
      for (int mi = 0; mi < MT; ++mi)
#pragma unroll
        for (int ni = 0; ni < NT; ++ni)
#pragma unroll
          for (int q = 0; q < 4; ++q) acc[mi][ni][q] += part[mi][ni][q];
    } else {
      // bf16: the A fragment of k16 from two tf32-layout loads; logical k
      // (2t, 2t+1) is physical (t, t+4) and (2t+8, 2t+9) is (8+t, 12+t),
      // the order in which the weights are packed
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        uint32_t af[MT][4];
#pragma unroll
        for (int mi = 0; mi < MT; ++mi) {
          uint32_t lo[4], hi[4];
          ldsm_x4(a + a_off[mi] + kk * 64, lo);
          ldsm_x4(a + a_off[mi] + kk * 64 + 32, hi);
          af[mi][0] = pack_bf16(lo[0], lo[2]);
          af[mi][1] = pack_bf16(lo[1], lo[3]);
          af[mi][2] = pack_bf16(hi[0], hi[2]);
          af[mi][3] = pack_bf16(hi[1], hi[3]);
        }
#pragma unroll
        for (int ni = 0; ni < NT; ++ni) {
          const uint2 w = *reinterpret_cast<const uint2*>(b + (((wn * NT + ni) * (BK / 16) + kk) * 32 + lane) * 8);
#pragma unroll
          for (int mi = 0; mi < MT; ++mi) mma_bf16(acc[mi][ni], af[mi], w.x, w.y);
        }
      }
    }
  }
  cp_async_wait<0>();

  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int mi = 0; mi < MT; ++mi)
#pragma unroll
    for (int ni = 0; ni < NT; ++ni)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int m = m0 + wm * WTM + mi * 16 + g + 8 * half;
        const int n = n0 + (wn * NT + ni) * 8 + 2 * t;
        if (m < d.M) epilogue(d, m, n, acc[mi][ni][2 * half], acc[mi][ni][2 * half + 1]);
      }
}

template <int T, bool BF16>
cudaError_t launch(const ConvDesc& d, cudaStream_t stream) {
  using C = TileCfg<T>;
  const dim3 grid((d.M + C::BM - 1) / C::BM, d.n8 * 8 / C::BN);
  conv_tc<T, BF16><<<grid, C::WM * C::WN * 32, smem_bytes<T, BF16>(), stream>>>(d);
  return cudaGetLastError();
}

template <int T, bool BF16>
cudaError_t set_smem() {
  return cudaFuncSetAttribute(conv_tc<T, BF16>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes<T, BF16>());
}

// BM, BN, threads, stages, dynamic shared bytes, registers, local (spill)
// bytes, CTAs an SM holds
template <int T, bool BF16>
cudaError_t info_of(int* info) {
  using C = TileCfg<T>;
  cudaFuncAttributes attr;
  cudaError_t e = cudaFuncGetAttributes(&attr, conv_tc<T, BF16>);
  if (e != cudaSuccess) return e;
  int ctas = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&ctas, conv_tc<T, BF16>, C::WM * C::WN * 32, smem_bytes<T, BF16>());
  if (e != cudaSuccess) return e;
  const int v[8] = {C::BM, C::BN, C::WM * C::WN * 32, C::STAGES, smem_bytes<T, BF16>(), attr.numRegs,
                    (int)attr.localSizeBytes, ctas};
  for (int i = 0; i < 8; ++i) info[i] = v[i];
  return cudaSuccess;
}

// the definitions of one operand mode's prepare, run_conv and kernel_info
#define K5_DEFINE_MODE(SUFFIX, BF16)                                                  \
  cudaError_t prepare_##SUFFIX() {                                                    \
    static unsigned long long done = 0; /* a bit per device */                        \
    int dev = 0;                                                                      \
    cudaError_t e = cudaGetDevice(&dev);                                              \
    if (e != cudaSuccess) return e;                                                   \
    if (dev < 64 && (done >> dev & 1ull)) return cudaSuccess;                         \
    if ((e = set_smem<TILE_WIDE, BF16>()) != cudaSuccess) return e;                   \
    if ((e = set_smem<TILE_MID, BF16>()) != cudaSuccess) return e;                    \
    if ((e = set_smem<TILE_NARROW, BF16>()) != cudaSuccess) return e;                 \
    if ((e = set_smem<TILE_THIN, BF16>()) != cudaSuccess) return e;                   \
    if (dev < 64) done |= 1ull << dev;                                                \
    return cudaSuccess;                                                               \
  }                                                                                   \
  cudaError_t run_conv_##SUFFIX(const ConvDesc& d, int tile, cudaStream_t stream) {   \
    switch (tile) {                                                                   \
      case TILE_WIDE: return launch<TILE_WIDE, BF16>(d, stream);                      \
      case TILE_MID: return launch<TILE_MID, BF16>(d, stream);                        \
      case TILE_NARROW: return launch<TILE_NARROW, BF16>(d, stream);                  \
      case TILE_THIN: return launch<TILE_THIN, BF16>(d, stream);                      \
    }                                                                                 \
    return cudaErrorInvalidValue;                                                     \
  }                                                                                   \
  cudaError_t kernel_info_##SUFFIX(int tile, int* info) {                             \
    switch (tile) {                                                                   \
      case TILE_WIDE: return info_of<TILE_WIDE, BF16>(info);                          \
      case TILE_MID: return info_of<TILE_MID, BF16>(info);                            \
      case TILE_NARROW: return info_of<TILE_NARROW, BF16>(info);                      \
      case TILE_THIN: return info_of<TILE_THIN, BF16>(info);                          \
    }                                                                                 \
    return cudaErrorInvalidValue;                                                     \
  }

#endif  // __CUDACC__

}  // namespace k5
