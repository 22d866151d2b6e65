// Fused chain of L = 1..3 SAME 3×3/1 convolutions for Hopper (sm_90a):
// per layer y = conv(x, w) + bias, optional ReLU, with the BN scale already
// folded into w by the Python wrapper (wsiseg_tpu_torch/ops/conv9.py).
// Intermediates stay in shared memory as bf16; only the last layer is
// written, in bf16 or f32.
//
// Replaces three TPU kernels, which compute cases of the same function:
//   wsiseg_tpu/ops/conv9.py::_conv9_kernel (entry conv9)        — L = 1
//   wsiseg_tpu/ops/conv9.py::_chain_kernel (entry conv_chain)   — L = 1..3,
//       "full" border mode: between layers, positions outside the true
//       (H, W) image are re-zeroed, so each layer sees per-layer SAME zero
//       padding exactly as an unfused stack of convs does
//   wsiseg_tpu/ops/pallas_conv.py::_head_kernel (entry conv3x3_small) — L =
//       1, f32 output, no ReLU
// The TPU kernels' 128-lane channel padding and their Mosaic mask modes are
// not carried over: channel counts are padded to the MMA tile inside this
// kernel, in shared memory, never in device memory.
//
// Layout: x (N, H, W, Cin) bf16 NHWC; layer weights (Cout, 9, Cin) bf16,
// tap index dy·3 + dx; bias (Cout,) f32; out (N, H, W, Cout_last).
//
// What bounds it on an H100 (arithmetic, not a measurement): the fold
// decoder's layer groups at a 3072×4096 slide do about 2.26 TFLOP in all
// (block2 alone 580 GFLOP at 384×512, 384→256→256) and move well under
// 2 GB, so they are bound by the tensor cores: about 2.3 ms at 989 TFLOP/s
// bf16, against 34 ms or more for f32 FMAs on CUDA cores.
//
// What this design does about it: an implicit GEMM on the tensor cores,
// mma.sync.m16n8k16 bf16 with f32 accumulation (M = output positions,
// N = Cout, K = 9·Cin). A block owns an 8 × 16 output tile and computes each
// layer over the tile plus the halo the later layers need (layer l of L
// covers (8 + 2(L-1-l)) × (16 + 2(L-1-l)) positions). The layer-0 input
// window (8 + 2L) × (16 + 2L) and the weights are streamed through shared
// memory in 32-channel K chunks (block0's Cin = 768 window would not fit
// whole) with cp.async, each chunk serving all nine taps; intermediates
// live in a shared-memory ping-pong buffer, zeroed outside the image, and
// are never written to device memory. Each warp computes a 32-position × 32-channel
// register tile per pass. Row strides are padded by 8 bf16 so that the
// 32-bit fragment loads of a warp hit 32 distinct banks. This first
// version does not overlap loads with math inside a block (no multi-stage
// cp.async / TMA pipeline; a single conv runs two blocks per SM instead)
// and uses mma.sync rather than wgmma, so it sits well below the
// tensor-core bound.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TH = 8;             // output rows per block (last layer)
constexpr int TW = 16;            // output cols per block
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int CK = 32;            // input channels per K chunk
constexpr int CKS = CK + 8;       // shared row stride of a chunk (bf16)
constexpr int NCH = 64;           // output channels per N chunk (at most)
constexpr int MAXL = 3;
constexpr int MAX_SMEM = 232448;  // per block on an H100 (227 KB)

struct Layer {
  const __nv_bfloat16* w;         // (cout, 9, cin)
  const float* bias;              // (cout,)
  int cin, cout, relu;
};

struct Params {
  const __nv_bfloat16* x;         // (n, h, w, layer[0].cin)
  void* out;                      // (n, h, w, layer[L-1].cout)
  int h, w;
  int act_off[2];                 // bf16 offsets of the ping-pong buffers
  Layer layer[MAXL];
};

__host__ __device__ constexpr int pad16(int c) { return (c + 15) / 16 * 16; }

// bytes of shared memory for an L-layer chain with these output channels
__host__ __device__ inline int smem_layout(int L, const int* cout,
                                           int* act_off) {
  const int wbuf = 9 * NCH * CKS;
  const int xin = (TH + 2 * L) * (TW + 2 * L) * CKS;
  int act[2] = {0, 0};
  for (int l = 0; l + 1 < L; ++l) {
    const int rows = TH + 2 * (L - 1 - l), cols = TW + 2 * (L - 1 - l);
    const int sz = rows * cols * (pad16(cout[l]) + 8);
    act[l & 1] = act[l & 1] > sz ? act[l & 1] : sz;
  }
  if (act_off) {
    act_off[0] = wbuf + xin;
    act_off[1] = wbuf + xin + act[0];
  }
  return 2 * (wbuf + xin + act[0] + act[1]);
}

__device__ __forceinline__ uint32_t lds32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ void mma16816(float* c, uint32_t a0, uint32_t a1,
                                         uint32_t a2, uint32_t a3,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// 16-byte asynchronous copy global → shared; zero-fills when !pred (src
// is then not read, but must be a valid address)
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool pred) {
  const unsigned saddr =
      static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int nbytes = pred ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(saddr), "l"(src), "r"(nbytes));
}

// wait for this thread's cp.async copies (a __syncthreads must follow)
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::);
}

// wbuf[(tap·NCH + nl)·CKS + k] = w[n0 + nl][tap][ci0 + k], zero outside
// (cout, cin)
__device__ void load_weights(__nv_bfloat16* wbuf, const Layer& ly, int n0,
                             int nc, int ci0) {
  if (ly.cin % 8 == 0 && aligned16(ly.w)) {
    for (int i = threadIdx.x; i < nc * 9 * (CK / 8); i += THREADS) {
      const int v = i % (CK / 8), t = i / (CK / 8);
      const int tap = t % 9, nl = t / 9;
      const int n = n0 + nl, ci = ci0 + 8 * v;
      const bool ok = n < ly.cout && ci < ly.cin;
      cp_async16(wbuf + (tap * NCH + nl) * CKS + 8 * v,
                 ok ? ly.w + ((size_t)n * 9 + tap) * ly.cin + ci : ly.w, ok);
    }
  } else {
    for (int i = threadIdx.x; i < nc * 9 * CK; i += THREADS) {
      const int k = i % CK, t = i / CK;
      const int tap = t % 9, nl = t / 9;
      const int n = n0 + nl, ci = ci0 + k;
      __nv_bfloat16 val = __float2bfloat16_rn(0.f);
      if (n < ly.cout && ci < ly.cin)
        val = ly.w[((size_t)n * 9 + tap) * ly.cin + ci];
      wbuf[(tap * NCH + nl) * CKS + k] = val;
    }
  }
}

// xin[pos·CKS + k] = x[y0 + pos / XC][x0 + pos % XC][ci0 + k] over an
// XR × XC window, zero outside the image and beyond cin
__device__ void load_window(__nv_bfloat16* xin, const __nv_bfloat16* x,
                            int H, int W, int cin, int y0, int x0, int XR,
                            int XC, int ci0, bool vec) {
  if (vec) {
    for (int i = threadIdx.x; i < XR * XC * (CK / 8); i += THREADS) {
      const int v = i % (CK / 8), pos = i / (CK / 8);
      const int y = y0 + pos / XC, xx = x0 + pos % XC, ci = ci0 + 8 * v;
      const bool ok = y >= 0 && y < H && xx >= 0 && xx < W && ci < cin;
      cp_async16(xin + pos * CKS + 8 * v,
                 ok ? x + ((size_t)y * W + xx) * cin + ci : x, ok);
    }
  } else {
    for (int i = threadIdx.x; i < XR * XC * CK; i += THREADS) {
      const int k = i % CK, pos = i / CK;
      const int y = y0 + pos / XC, xx = x0 + pos % XC, ci = ci0 + k;
      __nv_bfloat16 val = __float2bfloat16_rn(0.f);
      if (y >= 0 && y < H && xx >= 0 && xx < W && ci < cin)
        val = x[((size_t)y * W + xx) * cin + ci];
      xin[pos * CKS + k] = val;
    }
  }
}

// A single conv (L = 1) covers its 8 × 16 tile in one pass and keeps half
// the accumulators, so two blocks fit on an SM; a chain needs a second pass
// for the halo of its inner layers.
template <int L, bool OUT_F32>
__global__ void __launch_bounds__(THREADS, L == 1 ? 2 : 1)
conv_chain_kernel(const Params p) {
  constexpr int MP = L == 1 ? 1 : 2;      // passes over M (≤ 256 rows)
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* smem = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* wbuf = smem;
  __nv_bfloat16* xin = smem + 9 * NCH * CKS;
  constexpr int XR = TH + 2 * L, XC = TW + 2 * L;

  const int b = blockIdx.z;
  const int ty0 = blockIdx.y * TH, tx0 = blockIdx.x * TW;
  const int H = p.h, W = p.w;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int cin0 = p.layer[0].cin;
  const __nv_bfloat16* xb = p.x + (size_t)b * H * W * cin0;
  const bool xvec = cin0 % 8 == 0 && aligned16(p.x);

#pragma unroll
  for (int l = 0; l < L; ++l) {
    const Layer& ly = p.layer[l];
    // this layer's output extent: R × C positions from (ey0, ex0)
    const int R = TH + 2 * (L - 1 - l), C = TW + 2 * (L - 1 - l);
    const int M = R * C, IC = C + 2;
    const int ey0 = ty0 - (L - 1 - l), ex0 = tx0 - (L - 1 - l);
    const __nv_bfloat16* in = l == 0 ? xin : smem + p.act_off[(l + 1) & 1];
    const int in_stride =
        l == 0 ? CKS : pad16(p.layer[l > 0 ? l - 1 : 0].cout) + 8;
    __nv_bfloat16* act_out = smem + p.act_off[l & 1];
    const int cin16 = pad16(ly.cin), cpad = pad16(ly.cout);
    // warp grid: 8 × 1 warps over (M, N) for N chunks of 32, 4 × 2 for 64;
    // each warp a 32 × 32 tile per pass, at most MP passes
    const int nc = cpad <= 32 ? 32 : NCH;
    const int nwm = WARPS / (nc / 32);
    const int rows_pass = nwm * 32;
    const int mg = warp % nwm, ng = warp / nwm;

    int aoff[MP][2][2];           // [pass][m fragment][row g / g+8]
#pragma unroll
    for (int q = 0; q < MP; ++q)
#pragma unroll
      for (int f = 0; f < 2; ++f)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int pc = min(q * rows_pass + mg * 32 + f * 16 + h * 8 + g,
                             M - 1);
          aoff[q][f][h] = ((pc / C) * IC + pc % C) * in_stride;
        }
    bool pass_on[MP];
#pragma unroll
    for (int q = 0; q < MP; ++q) pass_on[q] = q * rows_pass + mg * 32 < M;

    for (int n0 = 0; n0 < cpad; n0 += nc) {
      float acc[MP][2][4][4];
#pragma unroll
      for (int q = 0; q < MP; ++q)
#pragma unroll
        for (int f = 0; f < 2; ++f)
#pragma unroll
          for (int j = 0; j < 4; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[q][f][j][e] = 0.f;

      for (int ci0 = 0; ci0 < cin16; ci0 += CK) {
        __syncthreads();          // previous chunk's readers are done
        load_weights(wbuf, ly, n0, nc, ci0);
        if (l == 0)
          load_window(xin, xb, H, W, cin0, ty0 - L, tx0 - L, XR, XC, ci0,
                      xvec);
        cp_async_wait_all();
        __syncthreads();
        const int ksteps = min(2, (cin16 - ci0) / 16);
        const int kbase = l == 0 ? 0 : ci0;
        for (int tap = 0; tap < 9; ++tap) {
          const int toff = ((tap / 3) * IC + tap % 3) * in_stride + kbase;
          for (int ks = 0; ks < ksteps; ++ks) {
            const int kk = toff + ks * 16 + 2 * t;
            uint32_t bfr[4][2];
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              const __nv_bfloat16* wp =
                  wbuf + (tap * NCH + ng * 32 + j * 8 + g) * CKS + ks * 16 +
                  2 * t;
              bfr[j][0] = lds32(wp);
              bfr[j][1] = lds32(wp + 8);
            }
#pragma unroll
            for (int q = 0; q < MP; ++q) {
              if (!pass_on[q]) continue;
#pragma unroll
              for (int f = 0; f < 2; ++f) {
                const __nv_bfloat16* lo = in + aoff[q][f][0] + kk;
                const __nv_bfloat16* hi = in + aoff[q][f][1] + kk;
                const uint32_t a0 = lds32(lo), a1 = lds32(hi);
                const uint32_t a2 = lds32(lo + 8), a3 = lds32(hi + 8);
#pragma unroll
                for (int j = 0; j < 4; ++j)
                  mma16816(acc[q][f][j], a0, a1, a2, a3, bfr[j][0],
                           bfr[j][1]);
              }
            }
          }
        }
      }

      // epilogue: + bias, ReLU; inner layers → bf16 in shared memory, zero
      // outside the image; the last layer → device memory, in-image only
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = n0 + ng * 32 + j * 8 + 2 * t;     // channels n, n+1
        const float bias0 = n < ly.cout ? ly.bias[n] : 0.f;
        const float bias1 = n + 1 < ly.cout ? ly.bias[n + 1] : 0.f;
#pragma unroll
        for (int q = 0; q < MP; ++q)
#pragma unroll
          for (int f = 0; f < 2; ++f)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int pidx = q * rows_pass + mg * 32 + f * 16 + h * 8 + g;
              if (pidx >= M) continue;
              float v0 = acc[q][f][j][2 * h] + bias0;
              float v1 = acc[q][f][j][2 * h + 1] + bias1;
              if (ly.relu) {
                v0 = fmaxf(v0, 0.f);
                v1 = fmaxf(v1, 0.f);
              }
              const int y = ey0 + pidx / C, xx = ex0 + pidx % C;
              const bool inimg = y >= 0 && y < H && xx >= 0 && xx < W;
              if (l + 1 < L) {
                if (n < cpad)
                  *reinterpret_cast<__nv_bfloat162*>(
                      act_out + pidx * (cpad + 8) + n) =
                      inimg ? __floats2bfloat162_rn(v0, v1)
                            : __floats2bfloat162_rn(0.f, 0.f);
                continue;
              }
              if (!inimg || n >= ly.cout) continue;
              const size_t o = (((size_t)b * H + y) * W + xx) * ly.cout + n;
              const bool pair = n + 1 < ly.cout && ly.cout % 2 == 0;
              if (OUT_F32) {
                float* out = static_cast<float*>(p.out);
                if (pair) {
                  *reinterpret_cast<float2*>(out + o) = make_float2(v0, v1);
                } else {
                  out[o] = v0;
                  if (n + 1 < ly.cout) out[o + 1] = v1;
                }
              } else {
                __nv_bfloat16* out = static_cast<__nv_bfloat16*>(p.out);
                if (pair) {
                  *reinterpret_cast<__nv_bfloat162*>(out + o) =
                      __floats2bfloat162_rn(v0, v1);
                } else {
                  out[o] = __float2bfloat16_rn(v0);
                  if (n + 1 < ly.cout) out[o + 1] = __float2bfloat16_rn(v1);
                }
              }
            }
      }
    }
  }
}

template <int L, bool OUT_F32>
int launch_chain(const Params& p, int n, int smem, cudaStream_t stream) {
  auto kern = conv_chain_kernel<L, OUT_F32>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((p.w + TW - 1) / TW, (p.h + TH - 1) / TH, n);
  kern<<<grid, THREADS, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

// Shared memory (bytes) a block of an nlayers-deep chain with output
// channels c0, c1, c2 needs; the chain launches only if it is at most
// 232448 (227 KB).
extern "C" int wsiseg_conv3x3_smem_bytes(int nlayers, int c0, int c1,
                                         int c2) {
  const int cout[MAXL] = {c0, c1, c2};
  return smem_layout(nlayers, cout, nullptr);
}

// Plain C entry for ctypes. x (n, h, w, cin) bf16; layer l's weights wl
// (cl, 9, c_{l-1}) bf16 with c_{-1} = cin, bias bl (cl,) f32, ReLU where bit
// l of relu_mask is set; layers beyond nlayers are ignored. out (n, h, w,
// c_{nlayers-1}) is f32 when out_f32, else bf16, allocated by the caller.
// Launches on `stream`, on the calling thread's current device, without
// synchronising, and returns a CUDA error code (0 = launched;
// cudaErrorInvalidValue when the chain does not fit in shared memory).
extern "C" int wsiseg_conv3x3_chain(const void* x, int n, int h, int w,
                                    int cin, int nlayers, const void* w0,
                                    const void* b0, int c0, const void* w1,
                                    const void* b1, int c1, const void* w2,
                                    const void* b2, int c2, int relu_mask,
                                    int out_f32, void* out, void* stream) {
  if (nlayers < 1 || nlayers > MAXL) return (int)cudaErrorInvalidValue;
  Params p;
  p.x = static_cast<const __nv_bfloat16*>(x);
  p.out = out;
  p.h = h;
  p.w = w;
  const void* ws[MAXL] = {w0, w1, w2};
  const void* bs[MAXL] = {b0, b1, b2};
  const int cout[MAXL] = {c0, c1, c2};
  for (int l = 0; l < MAXL; ++l) {
    p.layer[l].w = static_cast<const __nv_bfloat16*>(ws[l]);
    p.layer[l].bias = static_cast<const float*>(bs[l]);
    p.layer[l].cin = l == 0 ? cin : cout[l - 1];
    p.layer[l].cout = cout[l];
    p.layer[l].relu = (relu_mask >> l) & 1;
  }
  const int smem = smem_layout(nlayers, cout, p.act_off);
  if (smem > MAX_SMEM) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (nlayers * 2 + (out_f32 ? 1 : 0)) {
    case 2: return launch_chain<1, false>(p, n, smem, s);
    case 3: return launch_chain<1, true>(p, n, smem, s);
    case 4: return launch_chain<2, false>(p, n, smem, s);
    case 5: return launch_chain<2, true>(p, n, smem, s);
    case 6: return launch_chain<3, false>(p, n, smem, s);
    default: return launch_chain<3, true>(p, n, smem, s);
  }
}
