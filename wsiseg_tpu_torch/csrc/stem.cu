// Fused ResNet stem for Hopper (sm_90a): u8 RGB → normalize → 7×7/2 conv
// (3→64) → BatchNorm → ReLU. Normalize and BN are folded into the conv
// weights and bias by the Python wrapper (wsiseg_tpu_torch/ops/stem.py).
// One kernel template, two modes:
//
//   pool mode — replaces wsiseg_tpu/ops/pallas_stem.py::_stem2_kernel (entry
//     stem_pool_conv): emits space_to_depth(c1) and the 3×3/2 max-pool of
//     c1 in one pass, native c1 is never written;
//   native mode — replaces wsiseg_tpu/ops/pallas_stem.py::_stem_kernel
//     (entry stem_conv): emits c1 itself, (N, H/2, W/2, 64) NHWC.
//
// Same function as the TPU kernels, natural layout: the input is the padded
// level image (N, H, W, 3) u8 NHWC instead of the TPU's sublane packing;
// pixels outside the image read as the per-channel pad value
// clip(round(255·mean)) (zero after normalization).
//
// Outputs (bf16, f32 accumulation, +bias, ReLU, then rounding):
//   pool mode:
//     c1s2d (N, H/4, W/4, 256), channel (α·2+β)·64 + c  — space_to_depth(c1)
//     pool  (N, H/4, W/4, 64) = max over c1 rows 2P-1..2P+1, cols 2Q-1..2Q+1
//           with out-of-range taps as 0 (exact: c1 is post-ReLU).
//   native mode:
//     c1    (N, H/2, W/2, 64).
//
// What bounds it on an H100 (arithmetic from the shapes, not a
// measurement): at the bench geometry, a 3072×4096 level-2 image, the stem
// does 1536·2048·147·64·2 ≈ 59 GFLOP and reads about 38 MB. Pool mode
// writes 503 MB (c1s2d 403 MB + pool 101 MB), native mode 403 MB. On CUDA
// cores (67 TFLOP/s f32 peak) the FLOPs bound it at roughly 0.9 ms; on
// tensor cores it would be bound by the HBM writes, about 0.15 ms
// (pool) or 0.12 ms (native) at 3.35 TB/s.
//
// What this design does about it: it keeps everything but the outputs on
// chip — the u8 window, the folded weights and (pool mode) the c1 tile sit
// in shared memory, and each output byte is written once. The math is f32
// FMAs on CUDA cores (a K = 147 contraction per c1 position, each thread a
// few-position × 16-channel register tile with the weights broadcast from
// shared memory), so this first version sits on the CUDA-core FLOP bound;
// moving the contraction to tensor cores (mma.sync / wgmma on bf16, exact
// for u8 inputs) is the step to the HBM bound.
//
// The TPU pool kernel carried the pool's top halo row across a sequential
// grid; blocks here run in any order, so in pool mode each block recomputes
// the c1 row above and the c1 column left of its tile (1 + 1/(2·TP) +
// 1/(2·TQ) ≈ 1.16× the conv work at TP=4, TQ=16). Native mode has no halo:
// the c1 tile is CR × CC as a template parameter, with no recompute.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TP = 4;                     // pool rows per block (pool mode)
constexpr int TQ = 16;                    // pool cols per block (pool mode)
constexpr int NATIVE_CR = 8;              // c1 rows per block (native mode)
constexpr int NATIVE_CC = 32;             // c1 cols per block (native mode)
constexpr int K = 147;                    // 7 · 7 · 3 taps
constexpr int COUT = 64;
constexpr int THREADS = 256;
constexpr int CG = 16;                    // channels per thread
constexpr int NGROUPS = COUT / CG;
constexpr int TPG = THREADS / NGROUPS;    // threads per channel group

constexpr int round4(int n) { return (n + 3) / 4 * 4; }
constexpr int W_FLOATS = K * COUT;

// c1 tile of a block: CR × CC positions (pool mode: 2·TP+1 × 2·TQ+1, the
// pool's c1 rows/cols plus the halo row above and column left)
template <int CR, int CC, bool POOL>
struct StemGeom {
  static constexpr int NPOS = CR * CC;            // c1 positions per block
  static constexpr int IR = 2 * CR + 5;           // input window rows
  static constexpr int IC = 2 * CC + 5;           // input window cols
  static constexpr int PPT = (NPOS + TPG - 1) / TPG;  // positions per thread
  static constexpr int IMG_FLOATS = round4(IR * IC * 3);
  static constexpr size_t SMEM_BYTES =
      sizeof(float) * (W_FLOATS + COUT + IMG_FLOATS) +
      (POOL ? sizeof(__nv_bfloat16) * NPOS * COUT : 0);
  static_assert((W_FLOATS + COUT + IMG_FLOATS) % 4 == 0, "16 B alignment");
};

static_assert(THREADS == TP * TQ * NGROUPS, "pool phase: one item/thread");
static_assert(TPG % 32 == 0, "a warp must share one channel group");

union Pack16 {          // 16 bf16 = 32 bytes, stored as two 16-byte words
  uint4 u[2];
  __nv_bfloat16 h[CG];
};

// pool mode: out0 = c1s2d, out1 = pool; native mode: out0 = c1, out1 unused
template <int CR, int CC, bool POOL>
__global__ void __launch_bounds__(THREADS)
stem_kernel(const uint8_t* __restrict__ img,
            const __nv_bfloat16* __restrict__ w_g,
            const float* __restrict__ bias_g, int H, int W,
            int pad0, int pad1, int pad2,
            __nv_bfloat16* __restrict__ out0,
            __nv_bfloat16* __restrict__ out1) {
  using G = StemGeom<CR, CC, POOL>;
  extern __shared__ __align__(16) unsigned char smem[];
  float* w_s = reinterpret_cast<float*>(smem);             // [K][COUT]
  float* b_s = w_s + W_FLOATS;                             // [COUT]
  float* img_s = b_s + COUT;                               // [IR][IC][3]
  __nv_bfloat16* c1_s = reinterpret_cast<__nv_bfloat16*>(
      img_s + G::IMG_FLOATS);                  // [NPOS][COUT], pool mode

  const int n = blockIdx.z;
  const int P0 = blockIdx.y * TP;
  const int Q0 = blockIdx.x * TQ;
  // c1 row/col of the tile's first position
  const int r0 = POOL ? 2 * P0 - 1 : blockIdx.y * CR;
  const int q0 = POOL ? 2 * Q0 - 1 : blockIdx.x * CC;
  const int H2 = H / 2, W2 = W / 2, H4 = H / 4, W4 = W / 4;
  const int tid = threadIdx.x;
  const uint8_t* im = img + (size_t)n * H * W * 3;

  for (int i = tid; i < W_FLOATS; i += THREADS)
    w_s[i] = __bfloat162float(w_g[i]);
  if (tid < COUT) b_s[tid] = bias_g[tid];
  // input window: c1 row r reads image rows 2r-3 .. 2r+3
  const int y0 = 2 * r0 - 3, x0 = 2 * q0 - 3;
  for (int i = tid; i < G::IR * G::IC * 3; i += THREADS) {
    const int ch = i % 3, t = i / 3;
    const int c = t % G::IC, r = t / G::IC;
    const int y = y0 + r, x = x0 + c;
    int v = ch == 0 ? pad0 : (ch == 1 ? pad1 : pad2);
    if (y >= 0 && y < H && x >= 0 && x < W)
      v = im[((size_t)y * W + x) * 3 + ch];
    img_s[i] = (float)v;
  }
  __syncthreads();

  // conv: thread (g, lane) computes channels [16g, 16g+16) of c1 positions
  // lane, lane + TPG, ... of the block's CR × CC tile
  const int g = tid / TPG;
  const int lane = tid % TPG;
  int base[G::PPT];
#pragma unroll
  for (int p = 0; p < G::PPT; ++p) {
    const int pos = min(lane + p * TPG, G::NPOS - 1);
    base[p] = (2 * (pos / CC) * G::IC + 2 * (pos % CC)) * 3;
  }
  float acc[G::PPT][CG];
#pragma unroll
  for (int p = 0; p < G::PPT; ++p)
#pragma unroll
    for (int j = 0; j < CG; ++j) acc[p][j] = 0.f;

  for (int ky = 0; ky < 7; ++ky) {
#pragma unroll
    for (int kx = 0; kx < 7; ++kx) {
#pragma unroll
      for (int ch = 0; ch < 3; ++ch) {
        const int k = (ky * 7 + kx) * 3 + ch;
        const float4* wv =
            reinterpret_cast<const float4*>(w_s + k * COUT + g * CG);
        float wk[CG];
#pragma unroll
        for (int q = 0; q < CG / 4; ++q) {
          const float4 t = wv[q];
          wk[4 * q] = t.x;
          wk[4 * q + 1] = t.y;
          wk[4 * q + 2] = t.z;
          wk[4 * q + 3] = t.w;
        }
        const int off = (ky * G::IC + kx) * 3 + ch;
#pragma unroll
        for (int p = 0; p < G::PPT; ++p) {
          const float a = img_s[base[p] + off];
#pragma unroll
          for (int j = 0; j < CG; ++j) acc[p][j] = fmaf(a, wk[j], acc[p][j]);
        }
      }
    }
  }

  // epilogue: +bias, ReLU, bf16. Native mode writes c1; pool mode puts the
  // c1 tile in shared memory for the pool and writes the block's own
  // 2·TP × 2·TQ c1 rows/cols as s2d
#pragma unroll
  for (int p = 0; p < G::PPT; ++p) {
    const int pos = lane + p * TPG;
    if (pos >= G::NPOS) continue;
    const int r = pos / CC, c = pos % CC;
    const int y = r0 + r, x = q0 + c;
    const bool valid = y >= 0 && y < H2 && x >= 0 && x < W2;
    Pack16 v;
#pragma unroll
    for (int j = 0; j < CG; ++j)
      v.h[j] = __float2bfloat16_rn(
          valid ? fmaxf(acc[p][j] + b_s[g * CG + j], 0.f) : 0.f);
    if (!POOL) {
      if (valid) {
        uint4* out = reinterpret_cast<uint4*>(
            out0 + (((size_t)n * H2 + y) * W2 + x) * COUT + g * CG);
        out[0] = v.u[0];
        out[1] = v.u[1];
      }
      continue;
    }
    uint4* dst = reinterpret_cast<uint4*>(c1_s + pos * COUT + g * CG);
    dst[0] = v.u[0];
    dst[1] = v.u[1];
    if (valid && r >= 1 && c >= 1) {
      const int P = y >> 1, Q = x >> 1;
      const int sub = (y & 1) * 2 + (x & 1);
      uint4* out = reinterpret_cast<uint4*>(
          out0 + (((size_t)n * H4 + P) * W4 + Q) * (4 * COUT) +
          sub * COUT + g * CG);
      out[0] = v.u[0];
      out[1] = v.u[1];
    }
  }
  if (!POOL) return;
  __syncthreads();

  // 3×3/2 max-pool from the shared c1 tile: one (P, Q, 16 channels) item
  // per thread; c1 tile row 2·i + dr holds c1 row 2·(P0+i) - 1 + dr
  {
    const int g2 = tid % NGROUPS, t = tid / NGROUPS;
    const int qj = t % TQ, pi = t / TQ;
    const int P = P0 + pi, Q = Q0 + qj;
    if (P < H4 && Q < W4) {
      float m[CG];
#pragma unroll
      for (int j = 0; j < CG; ++j) m[j] = 0.f;
#pragma unroll
      for (int dr = 0; dr < 3; ++dr)
#pragma unroll
        for (int dc = 0; dc < 3; ++dc) {
          const int pos = (2 * pi + dr) * CC + 2 * qj + dc;
          Pack16 v;
          const uint4* src =
              reinterpret_cast<const uint4*>(c1_s + pos * COUT + g2 * CG);
          v.u[0] = src[0];
          v.u[1] = src[1];
#pragma unroll
          for (int j = 0; j < CG; ++j)
            m[j] = fmaxf(m[j], __bfloat162float(v.h[j]));
        }
      Pack16 o;
#pragma unroll
      for (int j = 0; j < CG; ++j) o.h[j] = __float2bfloat16_rn(m[j]);
      uint4* out = reinterpret_cast<uint4*>(
          out1 + (((size_t)n * H4 + P) * W4 + Q) * COUT + g2 * CG);
      out[0] = o.u[0];
      out[1] = o.u[1];
    }
  }
}

template <int CR, int CC, bool POOL>
int launch_stem(const void* img, const void* w_folded, const void* bias,
                int n, int h, int w, int pad0, int pad1, int pad2,
                void* out0, void* out1, dim3 grid, void* stream) {
  using G = StemGeom<CR, CC, POOL>;
  auto kern = stem_kernel<CR, CC, POOL>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)G::SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  kern<<<grid, THREADS, G::SMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(img),
      static_cast<const __nv_bfloat16*>(w_folded),
      static_cast<const float*>(bias), h, w, pad0, pad1, pad2,
      static_cast<__nv_bfloat16*>(out0), static_cast<__nv_bfloat16*>(out1));
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entries for ctypes. img (n, h, w, 3) u8; w_folded (147, 64)
// bf16, row (ky·7 + kx)·3 + c; bias (64,) f32; outputs allocated by the
// caller. Each launches on `stream`, on the calling thread's current
// device, without synchronising, and returns cudaGetLastError()
// (0 = launched).

// pool mode; h and w multiples of 4
extern "C" int wsiseg_stem_pool_conv(const void* img, const void* w_folded,
                                     const void* bias, int n, int h, int w,
                                     int pad0, int pad1, int pad2,
                                     void* c1s2d, void* pool, void* stream) {
  const dim3 grid((w / 4 + TQ - 1) / TQ, (h / 4 + TP - 1) / TP, n);
  return launch_stem<2 * TP + 1, 2 * TQ + 1, true>(
      img, w_folded, bias, n, h, w, pad0, pad1, pad2, c1s2d, pool, grid,
      stream);
}

// native mode; h and w even; c1 (n, h/2, w/2, 64)
extern "C" int wsiseg_stem_conv(const void* img, const void* w_folded,
                                const void* bias, int n, int h, int w,
                                int pad0, int pad1, int pad2, void* c1,
                                void* stream) {
  const dim3 grid((w / 2 + NATIVE_CC - 1) / NATIVE_CC,
                  (h / 2 + NATIVE_CR - 1) / NATIVE_CR, n);
  return launch_stem<NATIVE_CR, NATIVE_CC, false>(
      img, w_folded, bias, n, h, w, pad0, pad1, pad2, c1, nullptr, grid,
      stream);
}
