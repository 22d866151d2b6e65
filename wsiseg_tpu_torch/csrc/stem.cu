// Fused ResNet stem for Hopper (sm_90a): u8 RGB → normalize → 7×7/2 conv
// (3→64) → BatchNorm → ReLU, emitting space_to_depth(c1) and the 3×3/2
// max-pool of c1 in one pass. Normalize and BN are folded into the conv
// weights and bias by the Python wrapper (wsiseg_tpu_torch/ops/stem.py).
//
// Replaces the TPU kernel wsiseg_tpu/ops/pallas_stem.py::_stem2_kernel
// (entry stem_pool_conv). Same function, natural layout: the input is the
// padded level image (N, H, W, 3) u8 NHWC instead of the TPU's sublane
// packing; pixels outside the image read as the per-channel pad value
// clip(round(255·mean)) (zero after normalization).
//
// Outputs (bf16, f32 accumulation, +bias, ReLU, then rounding):
//   c1s2d (N, H/4, W/4, 256), channel (α·2+β)·64 + c  — space_to_depth(c1)
//   pool  (N, H/4, W/4, 64) = max over c1 rows 2P-1..2P+1, cols 2Q-1..2Q+1
//         with out-of-range taps as 0 (exact: c1 is post-ReLU).
//
// What bounds it on an H100 (arithmetic from the shapes, not a
// measurement): at the bench geometry, a 3072×4096 level-2 image, the stem
// does 1536·2048·147·64·2 ≈ 59 GFLOP and moves about 38 MB in and 503 MB
// out (c1s2d 403 MB + pool 101 MB). On CUDA cores (67 TFLOP/s f32 peak)
// the FLOPs bound it at roughly 1 ms or more; on tensor cores it would be
// bound by the HBM writes, about 0.16 ms at 3.35 TB/s.
//
// What this design does about it: it keeps everything but the outputs on
// chip — the u8 window, the folded weights and the c1 tile sit in shared
// memory, native c1 is never written, and each output byte is written
// once. The math is f32 FMAs on CUDA cores (a K = 147 contraction per c1
// position, each thread a 5-position × 16-channel register tile with the
// weights broadcast from shared memory), so this first version sits on the
// CUDA-core FLOP bound; moving the contraction to tensor cores (mma.sync /
// wgmma on bf16, exact for u8 inputs) is the step to the HBM bound.
//
// The TPU kernel carried the pool's top halo row across a sequential grid;
// blocks here run in any order, so each block recomputes the c1 row above
// and the c1 column left of its tile (1 + 1/(2·TP) + 1/(2·TQ) ≈ 1.16× the
// conv work at TP=4, TQ=16).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TP = 4;                     // pool rows per block
constexpr int TQ = 16;                    // pool cols per block
constexpr int CR = 2 * TP + 1;            // c1 rows per block (+ halo above)
constexpr int CC = 2 * TQ + 1;            // c1 cols per block (+ halo left)
constexpr int NPOS = CR * CC;             // c1 positions per block
constexpr int IR = 2 * CR + 5;            // input window rows
constexpr int IC = 2 * CC + 5;            // input window cols
constexpr int K = 147;                    // 7 · 7 · 3 taps
constexpr int COUT = 64;
constexpr int THREADS = 256;
constexpr int CG = 16;                    // channels per thread
constexpr int NGROUPS = COUT / CG;
constexpr int TPG = THREADS / NGROUPS;    // threads per channel group
constexpr int PPT = (NPOS + TPG - 1) / TPG;  // c1 positions per thread

constexpr int round4(int n) { return (n + 3) / 4 * 4; }
constexpr int W_FLOATS = K * COUT;
constexpr int IMG_FLOATS = round4(IR * IC * 3);
constexpr size_t SMEM_BYTES =
    sizeof(float) * (W_FLOATS + COUT + IMG_FLOATS) +
    sizeof(__nv_bfloat16) * NPOS * COUT;

static_assert(THREADS == TP * TQ * NGROUPS, "pool phase: one item/thread");
static_assert(TPG % 32 == 0, "a warp must share one channel group");
static_assert((W_FLOATS + COUT + IMG_FLOATS) % 4 == 0, "16 B alignment");

union Pack16 {          // 16 bf16 = 32 bytes, stored as two 16-byte words
  uint4 u[2];
  __nv_bfloat16 h[CG];
};

__global__ void __launch_bounds__(THREADS)
stem_pool_kernel(const uint8_t* __restrict__ img,
                 const __nv_bfloat16* __restrict__ w_g,
                 const float* __restrict__ bias_g, int H, int W,
                 int pad0, int pad1, int pad2,
                 __nv_bfloat16* __restrict__ c1s2d,
                 __nv_bfloat16* __restrict__ pool) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* w_s = reinterpret_cast<float*>(smem);             // [K][COUT]
  float* b_s = w_s + W_FLOATS;                             // [COUT]
  float* img_s = b_s + COUT;                               // [IR][IC][3]
  __nv_bfloat16* c1_s =
      reinterpret_cast<__nv_bfloat16*>(img_s + IMG_FLOATS);  // [NPOS][COUT]

  const int n = blockIdx.z;
  const int P0 = blockIdx.y * TP;
  const int Q0 = blockIdx.x * TQ;
  const int H2 = H / 2, W2 = W / 2, H4 = H / 4, W4 = W / 4;
  const int tid = threadIdx.x;
  const uint8_t* im = img + (size_t)n * H * W * 3;

  for (int i = tid; i < W_FLOATS; i += THREADS)
    w_s[i] = __bfloat162float(w_g[i]);
  if (tid < COUT) b_s[tid] = bias_g[tid];
  // input window: image rows 4·P0-5 .. 4·P0+4·TP+1 (c1 row 2·P0-1 reads
  // from image row 2·(2·P0-1)-3), likewise for columns
  const int y0 = 4 * P0 - 5, x0 = 4 * Q0 - 5;
  for (int i = tid; i < IR * IC * 3; i += THREADS) {
    const int ch = i % 3, t = i / 3;
    const int c = t % IC, r = t / IC;
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
  int base[PPT];
#pragma unroll
  for (int p = 0; p < PPT; ++p) {
    const int pos = min(lane + p * TPG, NPOS - 1);
    base[p] = (2 * (pos / CC) * IC + 2 * (pos % CC)) * 3;
  }
  float acc[PPT][CG];
#pragma unroll
  for (int p = 0; p < PPT; ++p)
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
        const int off = (ky * IC + kx) * 3 + ch;
#pragma unroll
        for (int p = 0; p < PPT; ++p) {
          const float a = img_s[base[p] + off];
#pragma unroll
          for (int j = 0; j < CG; ++j) acc[p][j] = fmaf(a, wk[j], acc[p][j]);
        }
      }
    }
  }

  // epilogue: +bias, ReLU, bf16; the c1 tile goes to shared memory for the
  // pool, and the block's own 2·TP × 2·TQ c1 rows/cols go out as s2d
#pragma unroll
  for (int p = 0; p < PPT; ++p) {
    const int pos = lane + p * TPG;
    if (pos >= NPOS) continue;
    const int r = pos / CC, c = pos % CC;
    const int y = 2 * P0 - 1 + r, x = 2 * Q0 - 1 + c;
    const bool valid = y >= 0 && y < H2 && x >= 0 && x < W2;
    Pack16 v;
#pragma unroll
    for (int j = 0; j < CG; ++j)
      v.h[j] = __float2bfloat16_rn(
          valid ? fmaxf(acc[p][j] + b_s[g * CG + j], 0.f) : 0.f);
    uint4* dst = reinterpret_cast<uint4*>(c1_s + pos * COUT + g * CG);
    dst[0] = v.u[0];
    dst[1] = v.u[1];
    if (valid && r >= 1 && c >= 1) {
      const int P = y >> 1, Q = x >> 1;
      const int sub = (y & 1) * 2 + (x & 1);
      uint4* out = reinterpret_cast<uint4*>(
          c1s2d + (((size_t)n * H4 + P) * W4 + Q) * (4 * COUT) +
          sub * COUT + g * CG);
      out[0] = v.u[0];
      out[1] = v.u[1];
    }
  }
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
          pool + (((size_t)n * H4 + P) * W4 + Q) * COUT + g2 * CG);
      out[0] = o.u[0];
      out[1] = o.u[1];
    }
  }
}

}  // namespace

// Plain C entry for ctypes. img (n, h, w, 3) u8; w_folded (147, 64) bf16,
// row (ky·7 + kx)·3 + c; bias (64,) f32; outputs allocated by the caller.
// h and w must be multiples of 4. Launches on `stream`, on the calling
// thread's current device, without synchronising and returns
// cudaGetLastError() (0 = launched).
extern "C" int wsiseg_stem_pool_conv(const void* img, const void* w_folded,
                                     const void* bias, int n, int h, int w,
                                     int pad0, int pad1, int pad2,
                                     void* c1s2d, void* pool, void* stream) {
  cudaError_t err = cudaFuncSetAttribute(stem_pool_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((w / 4 + TQ - 1) / TQ, (h / 4 + TP - 1) / TP, n);
  stem_pool_kernel<<<grid, THREADS, SMEM_BYTES,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(img),
      static_cast<const __nv_bfloat16*>(w_folded),
      static_cast<const float*>(bias), h, w, pad0, pad1, pad2,
      static_cast<__nv_bfloat16*>(c1s2d), static_cast<__nv_bfloat16*>(pool));
  return (int)cudaGetLastError();
}
