// One SAME 3×3/1 convolution for Hopper (sm_90a) on TMA and wgmma:
// y = act(conv(x, w) + bias), with the BN scale already folded into w by
// the Python wrapper (wsiseg_tpu_torch/ops/conv9.py), f32 accumulation,
// rounded once to bf16 or f32.
//
// Replaces two TPU kernels, which compute cases of the same function:
//   wsiseg_tpu/ops/conv9.py::_conv9_kernel (entry conv9), optional ReLU,
//       bf16 or f32 out — the fold decoder's 11 convs;
//   wsiseg_tpu/ops/pallas_conv.py::_head_kernel (entry conv3x3_small), f32
//       out, no ReLU.
// (The fused chains of wsiseg_tpu/ops/conv9.py::_chain_kernel run
// conv_chain_sm90.cu.)
//
// Layout: x (N, H, W, Cin) bf16 NHWC with Cin % 8 == 0 (TMA needs 16-byte
// strides; the wrapper zero-pads other channel counts); w (Cout, 9, Cin)
// bf16, tap dy·3 + dx; bias (Cout,) f32; out (N, H, W, Cout).
//
// What bounds it on an H100 (arithmetic, not a measurement): the fold
// decoder's layers at a 3072×4096 slide do 2.26 TFLOP; blocks 0-3 (Cin ≥
// 128) are bound by the bf16 tensor cores (1.86 TFLOP, ~1.9 ms at 989
// TFLOP/s), block4 and the head (Cin ≤ 64 at 1536×2048) by HBM bytes
// (~2 GB, ~0.6 ms at 3.35 TB/s).
//
// What this design does about it: an implicit GEMM on wgmma. A block owns
// a tile of output pixels (128 as a 1 × 128 row segment on every fold
// layer, 2 × 64 on narrow images; 256 for Cout = 128, two m64 tiles per
// consumer warpgroup, so that its weight bytes per operation match Cout =
// 256's) and BN output channels; K is 9 taps × Cin in 64-channel chunks.
// Per tap and chunk a TMA box [BN, 1, 64] of w lands in a ring stage, in
// the 128-byte swizzle that the wgmma descriptors name; x comes one of two
// ways, chosen by BN:
//   BN ≥ 128 (tensor-core bound): per tap a box [tr, tc, 64] of x at the
//     tap's shifted origin, in the same stage as the tap's weights;
//   BN ≤ 64 (byte bound, Cin ≤ 64 on the fold route): per chunk one halo
//     window [tr + 2, tc + 2, 64], read by the nine taps through shifted
//     wgmma descriptors — tap (dy, dx) starts (dy·(tc + 2) + dx) 128-byte
//     rows in, base offset 0 (the swizzle follows the address bits;
//     wsiseg_tpu_torch/probes.py, probe 1, which also shows the shifted
//     reads cost the wgmma rate nothing measurable). It moves each input
//     pixel into shared memory about 3 times per chunk instead of 9 (probe
//     2 measures that traffic's floor). With BN ≥ 128 the weights are most
//     of the bytes, and one window would hold the weight ring to fewer
//     stages.
// TMA's zero fill gives the SAME padding, the ragged image edge and the
// channels past Cin. The grid is persistent: as many blocks as fit on the
// SMs walk the tiles, and the ring's counters run on across tiles, so a
// producer thread keeps the ring full on full/empty mbarriers through the
// next tile's loads while two consumer warpgroups issue m64nBNk16 wgmmas,
// one wgmma group in flight behind the next tap, or run the epilogue. With
// 128 accumulators a thread (BN = 256, or BN = 128 with two m64 tiles)
// setmaxnreg moves registers from the producer warpgroup to the
// consumers; BN ≤ 64 fits two blocks per SM. The epilogue adds the bias,
// applies ReLU, rounds and stores in-image pixels and channels < Cout
// straight from the accumulator registers.

#include "sm90.cuh"

namespace {

using namespace sm90;

constexpr int BM = 128;                   // output pixels of one m64 pair
constexpr int BK = 64;                    // channels per chunk (128 B)
constexpr int THREADS = 384;              // WG 0, 1 consume; WG 2 loads
constexpr int MAX_STAGES = 8;

// m64 tiles per consumer warpgroup: BN = 128 takes two (256-pixel tiles),
// which halves its weight traffic per operation to BN = 256's
__host__ __device__ constexpr int m_tiles(int bn) { return bn == 128 ? 2 : 1; }

struct ConvArgs {
  const float* bias;
  void* out;
  int h, w, cout;
  int tc, tiles_x, tiles_y;               // tile tr × tc
  int images;                             // N
  int tiles;                              // N · tiles_y · tiles_x · N tiles
  int kchunks;                            // ceil(Cin / 64)
  int stages;                             // ring stages, one tap each
  int relu;
};

// bytes of the halo window box of a 128-pixel tile, and of its stage (the
// swizzle's period)
__host__ __device__ inline uint32_t window_bytes(int tc) {
  return (uint32_t)(BM / tc + 2) * (tc + 2) * BK * 2;
}

__host__ __device__ inline uint32_t window_alloc(int tc) {
  return (window_bytes(tc) + 1023u) & ~1023u;
}

// tile → its output origin: columns from x0, rows from y0 of image nb,
// channels from n0 (the N tile is the slowest index)
struct Origin {
  int x0, y0, nb, n0;
  __device__ Origin(const ConvArgs& a, int tile, int tr, int bn) {
    const int per_image = a.tiles_x * a.tiles_y;
    const int spatial = tile % (a.images * per_image);
    x0 = spatial % a.tiles_x * a.tc;
    y0 = spatial / a.tiles_x % a.tiles_y * tr;
    nb = spatial / per_image;
    n0 = tile / (a.images * per_image) * bn;
  }
};

template <int BN, bool OUT_F32>
__global__ void __launch_bounds__(THREADS, BN <= 64 ? 2 : 1)
conv9_sm90_kernel(const __grid_constant__ CUtensorMap tm_x,
                  const __grid_constant__ CUtensorMap tm_w,
                  const ConvArgs a) {
  constexpr bool WINDOW = BN <= 64;
  constexpr int MT = m_tiles(BN);
  constexpr bool MANY_REGS = BN * MT >= 256;    // 128 accumulators
  constexpr uint32_t B_BYTES = BN * BK * 2;
  constexpr uint32_t TAP_BYTES = MT * BM * BK * 2;   // a per-tap x box
  // WINDOW: one window stage, then the weight ring; else each stage holds
  // a tap's x box and its weights
  constexpr uint32_t STAGE = WINDOW ? B_BYTES : TAP_BYTES + B_BYTES;
  __shared__ __align__(8) uint64_t full[MAX_STAGES];
  __shared__ __align__(8) uint64_t empty[MAX_STAGES];
  __shared__ __align__(8) uint64_t win_full, win_empty;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  // the 128-byte swizzle repeats every 1024 bytes: every stage starts on it
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t ring = WINDOW ? base + window_alloc(a.tc) : base;
  const int tr = MT * BM / a.tc, wcols = a.tc + 2;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < a.stages; ++s) {
      mbar_init(smem_u32(&full[s]), 1);
      mbar_init(smem_u32(&empty[s]), 256);
    }
    mbar_init(smem_u32(&win_full), 1);
    mbar_init(smem_u32(&win_empty), 256);
    fence_mbar_init();
  }
  __syncthreads();

  // The ring position (s, ph) and the window count g run on across the
  // block's tiles, so loads of the next tile start during this tile's
  // last taps and epilogue.
  if (wg == 2) {
    // producer: one thread issues every TMA copy
    if constexpr (MANY_REGS) reg_dealloc<40>();
    if (threadIdx.x != 256) return;
    prefetch_tmap(&tm_x);
    prefetch_tmap(&tm_w);
    int s = 0, g = 0;
    uint32_t ph = 0;
    for (int tile = blockIdx.x; tile < a.tiles; tile += gridDim.x) {
      const Origin o(a, tile, tr, BN);
      for (int c = 0; c < a.kchunks; ++c, ++g) {
        if (WINDOW) {
          // the window of chunk g, once chunk g - 1's taps are done (the
          // other block on the SM runs meanwhile: a second window stage
          // would cost that block)
          mbar_wait(smem_u32(&win_empty), (g & 1) ^ 1);
          mbar_expect_tx(smem_u32(&win_full), window_bytes(a.tc));
          tma_load_4d(base, &tm_x, smem_u32(&win_full), c * BK, o.x0 - 1,
                      o.y0 - 1, o.nb);
        }
        for (int t = 0; t < 9; ++t) {
          mbar_wait(smem_u32(&empty[s]), ph ^ 1);
          const uint32_t fb = smem_u32(&full[s]), sa = ring + s * STAGE;
          mbar_expect_tx(fb, STAGE);
          if (!WINDOW)
            tma_load_4d(sa, &tm_x, fb, c * BK, o.x0 + t % 3 - 1,
                        o.y0 + t / 3 - 1, o.nb);
          tma_load_3d(sa + (WINDOW ? 0 : TAP_BYTES), &tm_w, fb, c * BK, t,
                      o.n0);
          if (++s == a.stages) {
            s = 0;
            ph ^= 1;
          }
        }
      }
    }
    return;
  }

  // consumers: warpgroup wg computes pixel rows [64 MT wg, 64 MT (wg + 1))
  if constexpr (MANY_REGS) reg_alloc<232>();
  // the 128-byte row of warpgroup wg's first pixel: in a tap box 64·MT
  // rows in; in the window 64 pixels along the strip (tr = 1) or one
  // window row down (tr = 2)
  const int row_wg = !WINDOW || tr == 1 ? 64 * MT * wg : wg * wcols;
  const int lane = threadIdx.x % 32, warp = (threadIdx.x % 128) / 32;
  const bool pair_ok = a.cout % 2 == 0;
  int s = 0, prev = 0, g = 0;
  uint32_t ph = 0;
  bool first = true;
  float acc[MT][BN / 2];
  for (int tile = blockIdx.x; tile < a.tiles; tile += gridDim.x) {
    const Origin o(a, tile, tr, BN);
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) acc[mt][i] = 0.f;
    for (int c = 0; c < a.kchunks; ++c, ++g) {
      if (WINDOW) mbar_wait(smem_u32(&win_full), g & 1);
      for (int t = 0; t < 9; ++t) {
        mbar_wait(smem_u32(&full[s]), ph);
        const uint32_t sa = ring + s * STAGE;
        const uint32_t ad =
            WINDOW ? base + (row_wg + (t / 3) * wcols + t % 3) * 128
                   : sa + row_wg * 128;
        const uint32_t bd = sa + (WINDOW ? 0 : TAP_BYTES);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
          for (int mt = 0; mt < MT; ++mt)
            Wgmma<BN>::mma(acc[mt], sw128_desc(ad + mt * 64 * 128 + kk * 32),
                           sw128_desc(bd + kk * 32));
        wgmma_commit();
        // the previous tap's wgmmas are done: release its stage
        wgmma_wait<1>();
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) fence_acc(acc[mt]);
        if (!first) mbar_arrive(smem_u32(&empty[prev]));
        first = false;
        prev = s;
        if (++s == a.stages) {
          s = 0;
          ph ^= 1;
        }
      }
      if (WINDOW) {
        // the chunk's last taps are done with the window
        wgmma_wait<0>();
        fence_acc(acc[0]);
        mbar_arrive(smem_u32(&win_empty));
      }
    }
    wgmma_wait<0>();
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) fence_acc(acc[mt]);

    // epilogue: + bias, ReLU, round; in-image pixels, channels < Cout
    const int gq = lane / 4, tq = lane % 4;
    size_t pix[MT][2];
    bool in[MT][2];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = (wg * MT + mt) * 64 + warp * 16 + h * 8 + gq;
        const int py = o.y0 + m / a.tc, px = o.x0 + m % a.tc;
        in[mt][h] = py < a.h && px < a.w;
        pix[mt][h] = ((size_t)o.nb * a.h + py) * a.w + px;
      }
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int n = o.n0 + 8 * j + 2 * tq;    // channels n, n + 1
      if (n >= a.cout) continue;
      const bool two = n + 1 < a.cout;
      const float b0 = __ldg(a.bias + n);
      const float b1 = two ? __ldg(a.bias + n + 1) : 0.f;
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          if (!in[mt][h]) continue;
          float v0 = acc[mt][4 * j + 2 * h] + b0;
          float v1 = acc[mt][4 * j + 2 * h + 1] + b1;
          if (a.relu) {
            v0 = fmaxf(v0, 0.f);
            v1 = fmaxf(v1, 0.f);
          }
          const size_t off = pix[mt][h] * a.cout + n;
          if constexpr (OUT_F32) {
            float* out = static_cast<float*>(a.out);
            if (pair_ok) {
              *reinterpret_cast<float2*>(out + off) = make_float2(v0, v1);
            } else {
              out[off] = v0;
              if (two) out[off + 1] = v1;
            }
          } else {
            __nv_bfloat16* out = static_cast<__nv_bfloat16*>(a.out);
            if (pair_ok) {
              *reinterpret_cast<__nv_bfloat162*>(out + off) =
                  __floats2bfloat162_rn(v0, v1);
            } else {
              out[off] = __float2bfloat16_rn(v0);
              if (two) out[off + 1] = __float2bfloat16_rn(v1);
            }
          }
        }
    }
  }
}

template <int BN, bool OUT_F32>
int launch(const CUtensorMap& tm_x, const CUtensorMap& tm_w,
           const ConvArgs& a, int smem, cudaStream_t stream) {
  auto kern = conv9_sm90_kernel<BN, OUT_F32>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  int dev = 0, sms = 0, per_sm = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern,
                                                        THREADS, smem);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const int grid = a.tiles < per_sm * sms ? a.tiles : per_sm * sms;
  kern<<<grid, THREADS, smem, stream>>>(tm_x, tm_w, a);
  return (int)cudaGetLastError();
}

template <bool OUT_F32>
int launch_bn(int bn, const CUtensorMap& tm_x, const CUtensorMap& tm_w,
              const ConvArgs& a, int smem, cudaStream_t s) {
  switch (bn) {
    case 16: return launch<16, OUT_F32>(tm_x, tm_w, a, smem, s);
    case 32: return launch<32, OUT_F32>(tm_x, tm_w, a, smem, s);
    case 64: return launch<64, OUT_F32>(tm_x, tm_w, a, smem, s);
    case 128: return launch<128, OUT_F32>(tm_x, tm_w, a, smem, s);
    case 256: return launch<256, OUT_F32>(tm_x, tm_w, a, smem, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// Plain C entry for ctypes. x (n, h, w, cin) bf16 with cin % 8 == 0 and a
// 16-byte aligned base; wt (cout, 9, cin) bf16, likewise; bias (cout,) f32;
// out (n, h, w, cout), f32 when out_f32 else bf16, allocated by the caller.
// The tile plan (tr × tc pixels with tc ∈ {64, 128} and tr·tc = 128, 256
// for bn = 128; bn ∈ {16, 32, 64, 128, 256}; 2..8 ring stages; smem bytes)
// comes from ops/conv9.plan_conv9. Encodes both tensor
// maps, launches on `stream` on the calling thread's current device
// without synchronising, and returns 0, a CUDA error code, or
// sm90::kErrNoEncoder / sm90::kErrEncode.
extern "C" int wsiseg_conv9_sm90(const void* x, int n, int h, int w, int cin,
                                 const void* wt, const void* bias, int cout,
                                 int relu, int out_f32, void* out, int tr,
                                 int tc, int bn, int stages, int smem,
                                 void* stream) {
  if (cin % 8 != 0 || (tc != 64 && tc != 128) ||
      tr * tc != m_tiles(bn) * BM || stages < 2 || stages > MAX_STAGES)
    return (int)cudaErrorInvalidValue;
  // a halo window per chunk (bn ≤ 64) or a box per tap
  const int halo = bn <= 64 ? 2 : 0;
  CUtensorMap tm_x, tm_w;
  const uint64_t xd[4] = {(uint64_t)cin, (uint64_t)w, (uint64_t)h,
                          (uint64_t)n};
  const uint64_t xs[3] = {(uint64_t)cin * 2, (uint64_t)w * cin * 2,
                          (uint64_t)h * w * cin * 2};
  const uint32_t xb[4] = {(uint32_t)BK, (uint32_t)(tc + halo),
                          (uint32_t)(tr + halo), 1};
  int err = encode_tiled(&tm_x, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, x, xd,
                         xs, xb, CU_TENSOR_MAP_SWIZZLE_128B);
  if (err != 0) return err;
  const uint64_t wd[3] = {(uint64_t)cin, 9, (uint64_t)cout};
  const uint64_t ws[2] = {(uint64_t)cin * 2, (uint64_t)9 * cin * 2};
  const uint32_t wb[3] = {(uint32_t)BK, 1, (uint32_t)bn};
  err = encode_tiled(&tm_w, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, wt, wd, ws,
                     wb, CU_TENSOR_MAP_SWIZZLE_128B);
  if (err != 0) return err;
  ConvArgs a;
  a.bias = static_cast<const float*>(bias);
  a.out = out;
  a.h = h;
  a.w = w;
  a.cout = cout;
  a.tc = tc;
  a.tiles_x = (w + tc - 1) / tc;
  a.tiles_y = (h + tr - 1) / tr;
  a.images = n;
  a.tiles = n * a.tiles_x * a.tiles_y * ((cout + bn - 1) / bn);
  a.kchunks = (cin + BK - 1) / BK;
  a.stages = stages;
  a.relu = relu;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return out_f32 ? launch_bn<true>(bn, tm_x, tm_w, a, smem, s)
                 : launch_bn<false>(bn, tm_x, tm_w, a, smem, s);
}
