// Fused chain of L = 2, 3 SAME 3×3/1 convolutions for Hopper (sm_90a) on
// TMA and wgmma: per layer y = act(conv(x, w) + bias), with the BN scale
// already folded into w by the Python wrapper (wsiseg_tpu_torch/ops/
// conv9.py). Intermediates stay in shared memory as bf16 wgmma operands;
// only the last layer is written, in bf16 or f32.
//
// Replaces wsiseg_tpu/ops/conv9.py::_chain_kernel (entry conv_chain) for
// L = 2, 3 in its "full" border mode: between layers, positions outside
// the true (H, W) image are re-zeroed, so each layer sees per-layer SAME
// zero padding, as an unfused stack of convs does. A single conv runs
// conv3x3_sm90.cu.
//
// Layout: x (N, H, W, C0) bf16 NHWC with C0 % 8 == 0 (TMA's 16-byte
// strides; the wrapper pads other counts); layer weights (Cout, 9, Cin8)
// bf16 with Cin8 = Cin rounded up to 8, tap dy·3 + dx; bias (Cout,) f32;
// out (N, H, W, Cout_last).
//
// What bounds it on an H100 (arithmetic, not a measurement): the fold
// decoder's five groups at a 3072×4096 slide do 2.26 TFLOP (2.29 ms at
// 989 TFLOP/s bf16). Blocks 0-3 (Cmid 128, 256) are bound by the tensor
// cores: keeping their intermediates on chip saves 0.015-0.12 ms a group,
// so what matters there is M per weight tile and little recomputed halo.
// Block4 + head (32→64→64→16 at 1536×2048) is bound by bytes when run
// layer by layer; fused it saves 1.6 GB of intermediate traffic.
//
// What this design does about it: a rolling column strip. Every layer's
// rows are 64 positions at one pitch, so one image row of a strip is one
// m64 wgmma tile, and a tap (dy, dx) of any layer reads the previous
// layer's row dy shifted by dx positions through a shifted descriptor
// (base offset 0: the 128-byte swizzle follows the address bits). Layer
// l's position m is image column x0 - L + l + 1 + m, so a strip yields
// TC = 64 - 2L output columns, and each layer recomputes only its 2-column
// halo (plus the positions past it that no output reads). A block walks a
// tile, a segment of SEG output rows of a strip, in steps of S = 2·MT
// rows: per step each layer computes S rows (layer l lags layer l - 1 by a
// row), each of the two consumer warpgroups MT of them, so every weight
// tile streamed from L2 serves S·64 positions (128 to 384). Intermediates
// live in rings of S + 2 rows, one per inner layer: the epilogue adds the
// bias, applies ReLU, zeroes positions outside the image, rounds to bf16
// and stores each row in 64-channel planes in the 128-byte swizzle the
// next layer's descriptors read; a fence.proxy.async and a barrier across
// both consumer warpgroups publish it. Rows are recomputed only at a
// segment's top and bottom (2(L-1-l) rows for layer l), so the plan
// (ops/conv9.plan_chain) picks SEG to fill the card's waves with the least
// work and reports the computed-over-required factor per group: 1.56
// (block0, a small image), 1.15-1.21 (blocks 1-3) and 1.49 (block4 +
// head, whose 32 input channels fill half of each 64-channel k chunk) at
// 3072×4096 (chip_smoke.py phase 4).
//
// Layer 0's input comes by TMA as one window per 64-channel chunk (S + 2
// rows × 64 positions, zero filled outside the image and past C0). Every
// wgmma is issued, for rows that no output needs too (their results are
// not stored) and for k16 steps past C0: a wgmma under a runtime condition
// makes ptxas serialise every wgmma of the kernel (its note C7520), which
// cost 1.4-1.5x. Weights stream as [min(N, 128), 1, 64] boxes, one or two
// per tap and chunk, through a ring of up to 16 mbarrier stages, filled by
// one producer thread that runs ahead across steps and tiles of the
// persistent grid. The last layer's epilogue is staged through a ring slot
// that no later read needs (XOR-swizzled 16-byte chunks) and written with
// 16-byte stores. With 128 accumulators a thread, setmaxnreg moves
// registers to the consumers. A wait on an mbarrier traps after
// sm90::kWatchdogNs.

#include "sm90.cuh"

namespace {

using namespace sm90;

constexpr int PITCH = 64;                 // positions per strip row (m64)
constexpr int BK = 64;                    // channels per chunk (128 B)
constexpr int PLANE = PITCH * BK * 2;     // one row's 64-channel plane
constexpr int THREADS = 384;              // WG 0, 1 consume; WG 2 loads
constexpr int MAX_STAGES = 16;
constexpr int BOX_N = 128;                // weight box rows at most
constexpr int MAXL = 3;
// a stage or window is released by one lane of each consumer warp, after
// its warp-synchronous wgmma.wait_group has seen the reads complete
constexpr int kConsumerWarps = 8;

struct ChainArgs {
  const float* bias[MAXL];
  int cout[MAXL];
  int cin[MAXL];                          // each layer's Cin (C0, Cout_l-1)
  int relu[MAXL];
  void* out;
  int h, w;
  int tiles_x, tiles_y, images, tiles;
  int seg;                                // output rows per segment
  int stages, nwin;
};

__host__ __device__ constexpr int tc_of(int L) { return PITCH - 2 * L; }

// tile → strip origin x0 (image column of output position 0), segment
// origin y0, its rows, image nb
struct Tile {
  int x0, y0, rows, nb;
  __device__ Tile(const ChainArgs& a, int tile, int L) {
    const int per_image = a.tiles_x * a.tiles_y;
    nb = tile / per_image;
    const int r = tile % per_image;
    x0 = r % a.tiles_x * tc_of(L);
    y0 = r / a.tiles_x * a.seg;
    rows = min(a.seg, a.h - y0);
  }
};

__device__ __forceinline__ int steps_of(int rows, int L, int S) {
  return (rows + 2 * L - 2 + S - 1) / S;
}

template <int L, int NM, int NL, int MT, bool OUT_F32>
__global__ void __launch_bounds__(THREADS, 1)
conv_chain_sm90_kernel(const __grid_constant__ CUtensorMap tm_x,
                       const __grid_constant__ CUtensorMap tm_w0,
                       const __grid_constant__ CUtensorMap tm_w1,
                       const __grid_constant__ CUtensorMap tm_w2,
                       const ChainArgs a) {
  constexpr int S = 2 * MT;               // rows per step, per layer
  constexpr int R = S + 2;                // ring rows per inner layer
  constexpr uint32_t SLOT = NM / BK * PLANE;  // NM % 64 == 0
  constexpr uint32_t WIN = (S + 2) * PLANE;
  // a stage: one tap's weights for up to BOX_N output channels (NL <= NM)
  constexpr int SN = NM < BOX_N ? NM : BOX_N;
  constexpr uint32_t STAGE = SN * BK * 2;
  constexpr bool MANY_REGS = MT * NM >= 256;
  constexpr int OB = OUT_F32 ? 4 : 2;
  __shared__ __align__(8) uint64_t full[MAX_STAGES];
  __shared__ __align__(8) uint64_t empty[MAX_STAGES];
  __shared__ __align__(8) uint64_t win_full[2], win_empty[2];
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  // weight stages, the inner layers' rings, the layer-0 windows; each
  // starts on the swizzle's 1024-byte period
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t ring0 = base + a.stages * STAGE;
  const uint32_t win0 = ring0 + (L - 1) * R * SLOT;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < a.stages; ++s) {
      mbar_init(smem_u32(&full[s]), 1);
      mbar_init(smem_u32(&empty[s]), kConsumerWarps);
    }
    for (int s = 0; s < 2; ++s) {
      mbar_init(smem_u32(&win_full[s]), 1);
      mbar_init(smem_u32(&win_empty[s]), kConsumerWarps);
    }
    fence_mbar_init();
  }
  __syncthreads();

  if (wg == 2) {
    // producer: one thread issues every TMA copy, in the consumers' order
    if constexpr (MANY_REGS) reg_dealloc<40>();
    if (threadIdx.x != 256) return;
    prefetch_tmap(&tm_x);
    prefetch_tmap(&tm_w0);
    prefetch_tmap(&tm_w1);
    if (L == 3) prefetch_tmap(&tm_w2);
    int s = 0, g = 0;
    uint32_t ph = 0;
    for (int tile = blockIdx.x; tile < a.tiles; tile += gridDim.x) {
      const Tile t(a, tile, L);
      const int steps = steps_of(t.rows, L, S);
      for (int j = 0; j < steps; ++j)
        for (int l = 0; l < L; ++l) {
          const CUtensorMap* tw = l == 0 ? &tm_w0 : l == 1 ? &tm_w1 : &tm_w2;
          const int n_l = l + 1 < L ? NM : NL;
          const int bn = n_l < BOX_N ? n_l : BOX_N;
          const uint32_t bytes = bn * BK * 2;
          const int kc = (a.cin[l] + BK - 1) / BK;
          for (int c = 0; c < kc; ++c) {
            if (l == 0) {
              const int ws = g % a.nwin;
              mbar_wait(smem_u32(&win_empty[ws]), ((g / a.nwin) & 1) ^ 1);
              mbar_expect_tx(smem_u32(&win_full[ws]), WIN);
              tma_load_4d(win0 + ws * WIN, &tm_x, smem_u32(&win_full[ws]),
                          c * BK, t.x0 - L, t.y0 - L + j * S, t.nb);
              ++g;
            }
            for (int tap = 0; tap < 9; ++tap)
              for (int n0 = 0; n0 < n_l; n0 += bn) {
                mbar_wait(smem_u32(&empty[s]), ph ^ 1);
                mbar_expect_tx(smem_u32(&full[s]), bytes);
                tma_load_3d(base + s * STAGE, tw, smem_u32(&full[s]), c * BK,
                            tap, n0);
                if (++s == a.stages) {
                  s = 0;
                  ph ^= 1;
                }
              }
          }
        }
    }
    return;
  }

  // consumers: warpgroup wg computes rows wg·MT … wg·MT + MT - 1 of each
  // layer's S rows per step
  if constexpr (MANY_REGS) reg_alloc<232>();
  const int lane = threadIdx.x % 32, warp = (threadIdx.x % 128) / 32;
  const int gq = lane / 4, tq = lane % 4;
  int s = 0, g = 0;
  uint32_t ph = 0;
  float acc[MT][NM / 2];

  for (int tile = blockIdx.x; tile < a.tiles; tile += gridDim.x) {
    const Tile t(a, tile, L);
    const int steps = steps_of(t.rows, L, S);
    for (int j = 0; j < steps; ++j) {
#pragma unroll
      for (int l = 0; l < L; ++l) {
        const bool last = l + 1 == L;
        // rows u of this layer (window-row coordinates: image row y0 - L
        // + u); needed iff in [l + 1, rows + 2L - 1 - l)
        int u[MT];
        bool need[MT];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          u[mt] = 1 + j * S - l + wg * MT + mt;
          need[mt] = u[mt] >= l + 1 && u[mt] < t.rows + 2 * L - 1 - l;
        }
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int i = 0; i < NM / 2; ++i) acc[mt][i] = 0.f;

        const int cin = a.cin[l];
        const int kc = (cin + BK - 1) / BK;
        const uint32_t src_ring = ring0 + (l - 1) * R * SLOT;
        bool first = true;
        int prev = 0;
        for (int c = 0; c < kc; ++c) {
          uint32_t src = 0;
          if (l == 0) {
            const int ws = g % a.nwin;
            mbar_wait(smem_u32(&win_full[ws]), (g / a.nwin) & 1);
            src = win0 + ws * WIN;
          }
          for (int tap = 0; tap < 9; ++tap) {
            const int dy = tap / 3, dx = tap % 3;
            uint32_t ad[MT];
#pragma unroll
            for (int mt = 0; mt < MT; ++mt) {
              // the row u - 1 + dy of the layer below, shifted dx positions
              const int r = u[mt] - 1 + dy;
              ad[mt] = l == 0
                  ? src + ((r - j * S) * PITCH + dx) * 128
                  : src_ring + (r + 4 * R) % R * SLOT + c * PLANE + dx * 128;
            }
            // NM = 256: two stages a tap, each for 128 output channels
#pragma unroll
            for (int ns = 0; ns < NM / SN; ++ns) {
              if (last && ns * SN >= NL) break;
              mbar_wait(smem_u32(&full[s]), ph);
              const uint32_t bd = base + s * STAGE;
              wgmma_fence();
              // every wgmma is issued, unconditionally: one under a runtime
              // condition makes ptxas serialise all of them (C7520)
#pragma unroll
              for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
                for (int mt = 0; mt < MT; ++mt) {
                  const uint64_t da = sw128_desc(ad[mt] + kk * 32);
                  const uint64_t db = sw128_desc(bd + kk * 32);
                  if (last && NL < SN)
                    Wgmma<(NL < SN ? NL : SN)>::mma(
                        *reinterpret_cast<float(*)[(NL < SN ? NL : SN) / 2]>(
                            &acc[mt][0]), da, db);
                  else
                    Wgmma<SN>::mma(*reinterpret_cast<float(*)[SN / 2]>(
                                       &acc[mt][ns * SN / 2]), da, db);
                }
              }
              wgmma_commit();
              // the previous stage's wgmmas are done: release it
              wgmma_wait<1>();
#pragma unroll
              for (int mt = 0; mt < MT; ++mt) fence_acc(acc[mt]);
              if (!first && lane == 0) mbar_arrive(smem_u32(&empty[prev]));
              first = false;
              prev = s;
              if (++s == a.stages) {
                s = 0;
                ph ^= 1;
              }
            }
          }
          if (l == 0) {
            // the chunk's last taps are done with the window
            wgmma_wait<0>();
#pragma unroll
            for (int mt = 0; mt < MT; ++mt) fence_acc(acc[mt]);
            if (lane == 0) mbar_arrive(smem_u32(&win_empty[g % a.nwin]));
            ++g;
          }
        }
        wgmma_wait<0>();
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) fence_acc(acc[mt]);
        if (lane == 0) mbar_arrive(smem_u32(&empty[prev]));

        const float* bias = a.bias[l];
        const int cout = a.cout[l];
        const bool relu = a.relu[l] != 0;
        if (!last) {
          // inner epilogue: + bias, ReLU, zero outside the image, bf16,
          // into this layer's ring in the 128-byte swizzle
          const uint32_t ring = ring0 + l * R * SLOT;
          bool in[MT][2];
          uint32_t rowa[MT][2];
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            const int yy = t.y0 - L + u[mt];
            const uint32_t slot = ring + (u[mt] + 4 * R) % R * SLOT;
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int m = warp * 16 + h * 8 + gq;
              const int xx = t.x0 - L + l + 1 + m;
              in[mt][h] = yy >= 0 && yy < a.h && xx >= 0 && xx < a.w;
              rowa[mt][h] = slot + m * 128;
            }
          }
#pragma unroll
          for (int jn = 0; jn < NM / 8; ++jn) {
            const int n = 8 * jn + 2 * tq;
            const float b0 = n < cout ? __ldg(bias + n) : 0.f;
            const float b1 = n + 1 < cout ? __ldg(bias + n + 1) : 0.f;
            // channel n of plane n / 64: 16-byte chunk (n % 64) / 8, XOR
            // the row's phase (rows m and m + 8 share it)
            const int cc = n % BK;
            const uint32_t off = (n / BK) * PLANE +
                                 (((cc / 8) ^ (gq & 7)) * 16) + (cc % 8) * 2;
#pragma unroll
            for (int mt = 0; mt < MT; ++mt) {
              if (!need[mt]) continue;
#pragma unroll
              for (int h = 0; h < 2; ++h) {
                float v0 = 0.f, v1 = 0.f;
                if (in[mt][h]) {
                  v0 = acc[mt][4 * jn + 2 * h] + b0;
                  v1 = acc[mt][4 * jn + 2 * h + 1] + b1;
                  if (relu) {
                    v0 = fmaxf(v0, 0.f);
                    v1 = fmaxf(v1, 0.f);
                  }
                }
                const __nv_bfloat162 pair = __floats2bfloat162_rn(v0, v1);
                asm volatile("st.shared.b32 [%0], %1;\n"
                             :: "r"(rowa[mt][h] + off),
                                "r"(*reinterpret_cast<const uint32_t*>(&pair))
                             : "memory");
              }
            }
          }
          // generic stores → the async proxy that wgmma reads through,
          // then every row of both warpgroups is in place
          fence_proxy_async();
          bar_sync(1, 256);
          continue;
        }

        // last layer: both warpgroups' wgmmas are done with the ring, so
        // the slots of rows no later step reads can stage the output
        bar_sync(1, 256);
        constexpr int ROWB_FULL = NL * OB;
        constexpr int ROWB = ROWB_FULL < (int)SLOT / 64 ? ROWB_FULL
                                                         : (int)SLOT / 64;
        constexpr int PASSES = ROWB_FULL / ROWB;
        constexpr int CH = ROWB / OB;              // channels per pass
        constexpr int NQ = ROWB / 16;              // 16-byte chunks a row
        const uint32_t stage =
            ring0 + (L - 2) * R * SLOT +
            (j * S - L + 1 + wg * MT + 4 * R) % R * SLOT;
        const bool vec = a.cout[L - 1] * OB % 16 == 0 &&
                         (reinterpret_cast<uintptr_t>(a.out) & 15) == 0;
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          if (!need[mt]) continue;
          const int yy = t.y0 - L + u[mt];
#pragma unroll
          for (int p = 0; p < PASSES; ++p) {
#pragma unroll
            for (int jn = 0; jn < NL / 8; ++jn) {
              if (jn / (CH / 8) != p) continue;
              const int n = 8 * jn + 2 * tq;
              const float b0 = n < cout ? __ldg(bias + n) : 0.f;
              const float b1 = n + 1 < cout ? __ldg(bias + n + 1) : 0.f;
#pragma unroll
              for (int h = 0; h < 2; ++h) {
                const int m = warp * 16 + h * 8 + gq;
                float v0 = acc[mt][4 * jn + 2 * h] + b0;
                float v1 = acc[mt][4 * jn + 2 * h + 1] + b1;
                if (relu) {
                  v0 = fmaxf(v0, 0.f);
                  v1 = fmaxf(v1, 0.f);
                }
                const int off = (n - p * CH) * OB;
                const uint32_t addr = stage + m * ROWB +
                                      (((off / 16) ^ (m % NQ)) * 16) + off % 16;
                if constexpr (OUT_F32) {
                  asm volatile("st.shared.v2.f32 [%0], {%1, %2};\n"
                               :: "r"(addr), "f"(v0), "f"(v1) : "memory");
                } else {
                  const __nv_bfloat162 pair = __floats2bfloat162_rn(v0, v1);
                  asm volatile(
                      "st.shared.b32 [%0], %1;\n"
                      :: "r"(addr),
                         "r"(*reinterpret_cast<const uint32_t*>(&pair))
                      : "memory");
                }
              }
            }
            bar_sync(2 + wg, 128);
            // 16-byte chunks to device memory: in-image pixels of the
            // strip's TC output positions, channels < Cout
            for (int q = threadIdx.x % 128; q < PITCH * NQ; q += 128) {
              const int m = q / NQ, k = q % NQ;
              const int xx = t.x0 + m;
              if (m >= tc_of(L) || xx >= a.w) continue;
              const int n0 = p * CH + k * (16 / OB);
              if (n0 >= cout) continue;
              const uint32_t src = stage + m * ROWB + ((k ^ (m % NQ)) * 16);
              uint32_t v[4];
              asm volatile("ld.shared.v4.b32 {%0, %1, %2, %3}, [%4];\n"
                           : "=r"(v[0]), "=r"(v[1]), "=r"(v[2]), "=r"(v[3])
                           : "r"(src) : "memory");
              unsigned char* dst =
                  static_cast<unsigned char*>(a.out) +
                  ((((size_t)t.nb * a.h + yy) * a.w + xx) * cout + n0) * OB;
              if (vec) {
                *reinterpret_cast<uint4*>(dst) =
                    make_uint4(v[0], v[1], v[2], v[3]);
              } else {
                // a ragged Cout: element by element, channels < Cout
#pragma unroll
                for (int e = 0; e < 16 / OB; ++e) {
                  if (n0 + e >= cout) break;
                  if constexpr (OUT_F32)
                    reinterpret_cast<uint32_t*>(dst)[e] = v[e];
                  else
                    reinterpret_cast<uint16_t*>(dst)[e] =
                        (uint16_t)(v[e / 2] >> (16 * (e % 2)));
                }
              }
            }
            bar_sync(2 + wg, 128);
          }
        }
        // the staging slots are free for the next step's writes
        bar_sync(1, 256);
      }
    }
  }
}

template <int L, int NM, int NL, int MT, bool OUT_F32>
int launch(const CUtensorMap* tm, const ChainArgs& a, int smem,
           cudaStream_t stream) {
  auto kern = conv_chain_sm90_kernel<L, NM, NL, MT, OUT_F32>;
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
  kern<<<grid, THREADS, smem, stream>>>(tm[0], tm[1], tm[2], tm[3], a);
  return (int)cudaGetLastError();
}

// the instantiations ops/conv9.CHAIN_FORMS lists: (L, NM, NL, MT)
#define WSISEG_CHAIN_FORMS(X)                                       \
  X(2, 64, 64, 2) X(2, 128, 128, 2) X(2, 256, 256, 1) X(3, 64, 16, 3) \
  X(3, 128, 128, 1)

int dispatch(int L, int nm, int nl, int mt, bool f32, const CUtensorMap* tm,
             const ChainArgs& a, int smem, cudaStream_t s) {
#define WSISEG_CHAIN_CASE(l_, nm_, nl_, mt_)                                \
  if (L == l_ && nm == nm_ && nl == nl_ && mt == mt_)                      \
    return f32 ? launch<l_, nm_, nl_, mt_, true>(tm, a, smem, s)           \
               : launch<l_, nm_, nl_, mt_, false>(tm, a, smem, s);
  WSISEG_CHAIN_FORMS(WSISEG_CHAIN_CASE)
#undef WSISEG_CHAIN_CASE
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// Plain C entry for ctypes. x (n, h, w, cin) bf16 with cin % 8 == 0 and a
// 16-byte aligned base; layer l's weights wl (cl, 9, kl) bf16 with kl the
// layer's input channels rounded up to 8 (zeros past them), 16-byte
// aligned; bias bl (cl,) f32; ReLU where bit l of relu_mask is set; layers
// past nlayers are ignored. out (n, h, w, c_last), f32 when out_f32 else
// bf16, allocated by the caller. The plan (nm, nl, mt: an instantiation of
// WSISEG_CHAIN_FORMS; seg output rows per tile; 2..16 weight stages; 1..2
// windows; smem bytes) comes from ops/conv9.plan_chain. Encodes the tensor
// maps, launches on `stream` on the calling thread's current device
// without synchronising, and returns 0, a CUDA error code, or
// sm90::kErrNoEncoder / sm90::kErrEncode.
extern "C" int wsiseg_conv_chain_sm90(
    const void* x, int n, int h, int w, int cin, int nlayers, const void* w0,
    const void* b0, int c0, const void* w1, const void* b1, int c1,
    const void* w2, const void* b2, int c2, int relu_mask, int out_f32,
    void* out, int nm, int nl, int mt, int seg, int stages, int nwin,
    int smem, void* stream) {
  if (nlayers < 2 || nlayers > MAXL || cin % 8 != 0 || stages < 2 ||
      stages > MAX_STAGES || nwin < 1 || nwin > 2 || seg < 1)
    return (int)cudaErrorInvalidValue;
  const void* ws[MAXL] = {w0, w1, w2};
  const void* bs[MAXL] = {b0, b1, b2};
  const int cs[MAXL] = {c0, c1, c2};
  ChainArgs a;
  CUtensorMap tm[4];
  const int S = 2 * mt;
  const uint64_t xd[4] = {(uint64_t)cin, (uint64_t)w, (uint64_t)h,
                          (uint64_t)n};
  const uint64_t xs[3] = {(uint64_t)cin * 2, (uint64_t)w * cin * 2,
                          (uint64_t)h * w * cin * 2};
  const uint32_t xb[4] = {(uint32_t)BK, (uint32_t)PITCH, (uint32_t)(S + 2),
                          1};
  int err = encode_tiled(&tm[0], CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, x, xd,
                         xs, xb, CU_TENSOR_MAP_SWIZZLE_128B);
  if (err != 0) return err;
  for (int l = 0; l < MAXL; ++l) {
    const int li = l < nlayers ? l : nlayers - 1;   // unused maps: a copy
    const int k = li == 0 ? cin : (cs[li - 1] + 7) / 8 * 8;
    const int nfull = li + 1 < nlayers ? nm : nl;
    const int nbox = nfull < BOX_N ? nfull : BOX_N;
    const uint64_t wd[3] = {(uint64_t)k, 9, (uint64_t)cs[li]};
    const uint64_t wsd[2] = {(uint64_t)k * 2, (uint64_t)9 * k * 2};
    const uint32_t wb[3] = {(uint32_t)BK, 1, (uint32_t)nbox};
    err = encode_tiled(&tm[1 + l], CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
                       ws[li], wd, wsd, wb, CU_TENSOR_MAP_SWIZZLE_128B);
    if (err != 0) return err;
    a.bias[l] = static_cast<const float*>(bs[li]);
    a.cout[l] = cs[li];
    a.cin[l] = li == 0 ? cin : cs[li - 1];
    a.relu[l] = (relu_mask >> li) & 1;
  }
  a.out = out;
  a.h = h;
  a.w = w;
  a.tiles_x = (w + tc_of(nlayers) - 1) / tc_of(nlayers);
  a.tiles_y = (h + seg - 1) / seg;
  a.images = n;
  a.tiles = n * a.tiles_x * a.tiles_y;
  a.seg = seg;
  a.stages = stages;
  a.nwin = nwin;
  return dispatch(nlayers, nm, nl, mt, out_f32 != 0, tm, a, smem,
                  static_cast<cudaStream_t>(stream));
}
