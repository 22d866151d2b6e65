// Hopper micro-benchmarks of the questions the TPU probes asked about the
// conv9 kernel (scripts/probe_dot.py, probe_mosaic.py, probe_dot2.py,
// probe_dot3.py, probe_dma64.py), asked again on this card for
// conv3x3_sm90.cu. Each probe's output is held against a plain PyTorch
// version by wsiseg_tpu_torch/probes.py, which also times them.
//
// 1. wgmma on shared-memory-resident tiles (probe_dot, probe_mosaic): a
//    1 × 128-pixel strip, K = 9 taps × 128 channels, N = BN, A from
//    (mode 0) nine TMA-staged tap tiles, (1) one 3 × 130 halo window read
//    by nine shifted descriptors with the descriptor's base offset set to
//    the start row's phase, (2) the same with base offset 0, (3) tap 0
//    only: the unshifted 1/9 floor. Every m64nNk16 form the conv uses runs.
// 2. Per-K-step load floor (probe_dot2): the conv kernel's producer and
//    ring of 1, 2 or 4 stages at 1536×2048, 128→64, consumers that only
//    wait and release (one thread sums 8 channels of each stage's first
//    pixel, so the output checks that every box arrived).
// 3. Output-store floor (probe_dot3): (8×1024 px, 64) bf16 blocks of a
//    position pattern into a (1536, 2048, 64) tensor, by 16-byte st.global
//    or by TMA stores of 128-pixel boxes from a two-buffer ring.
// 4. TMA windows at negative and past-the-edge coordinates (probe_dma64):
//    8 × 128-pixel, 64-channel boxes in the 128-byte swizzle from NHWC
//    tensors with C = 32 or 64, un-swizzled into the zero-padded tensor
//    (N, H + 2, W + 2, 64): zero fill for the border and for the channels
//    past C.
//
// 6. The fused stem-pool epilogue's primitives (probe_retile) on wgmma
//    accumulator fragments of the stem's cell form (stem_sm90.cu): a row of
//    cells × 128 values (two 64-value column parities e, o), each 64-cell
//    tile loaded into the m64n128 accumulator layout, copied out through a
//    staged row, and p = max(max(prev·m, e), o) with prev = o of the same
//    cell (shift 0, probe_retile's function) or of the cell before (shift 1,
//    the stem pool's column shift, zero before the row's first cell). The
//    shift by shuffles (4 lanes up inside an 8-row group, the other
//    half-row for row 8, shared memory across warps and from tile to tile)
//    or by staging the tile's whole o half through shared memory.
//    (Probe 5, P1, runs stem_sm90.cu itself in its three assembly forms.)
//
// Bounds (arithmetic): probe 1 by the bf16 tensor cores; probes 2-4 and 6 by
// the bytes each must move (2: the input once, 3: the output, 4 and 6:
// both).

#include "sm90.cuh"

namespace {

using namespace sm90;

constexpr int A_BYTES = 128 * 64 * 2;        // one 128-pixel, 64-ch tile
constexpr int WIN_COLS = 130;                // 128 + 2 halo columns
constexpr int WIN_BYTES = 3 * WIN_COLS * 128;
constexpr int WIN_ALLOC = (WIN_BYTES + 1023) / 1024 * 1024;

__device__ __forceinline__ uint32_t align1024(uint32_t a) {
  return (a + 1023u) & ~1023u;
}

// ---- 1: wgmma on resident tiles ------------------------------------------

template <int BN, int MODE>
__global__ void __launch_bounds__(256, 1)
probe_wgmma_kernel(const __grid_constant__ CUtensorMap tm_win,
                   const __grid_constant__ CUtensorMap tm_tap,
                   const __grid_constant__ CUtensorMap tm_b, int reps,
                   float* out) {
  __shared__ __align__(8) uint64_t bar;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t sb = align1024(smem_u32(smem_raw));     // B: BN × 64
  const uint32_t sa = sb + BN * 128;                     // A region
  const int wg = threadIdx.x / 128;
  if (threadIdx.x == 0) {
    mbar_init(smem_u32(&bar), 1);
    fence_mbar_init();
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    const uint32_t b = smem_u32(&bar);
    mbar_expect_tx(b, BN * 128 + (MODE == 0 ? 9 * A_BYTES : WIN_BYTES));
    tma_load_2d(sb, &tm_b, b, 0, 0);
    if (MODE == 0) {
      for (int tap = 0; tap < 9; ++tap)
        tma_load_3d(sa + tap * A_BYTES, &tm_tap, b, 0, tap % 3, tap / 3);
    } else {
      tma_load_3d(sa, &tm_win, b, 0, 0, 0);
    }
  }
  mbar_wait(smem_u32(&bar), 0);

  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
  constexpr int TAPS = MODE == 3 ? 1 : 9;
  for (int r = 0; r < reps; ++r) {
    // K = 128 channels: the two 64-channel steps reuse the resident tiles
    for (int c = 0; c < 2; ++c) {
#pragma unroll
      for (int tap = 0; tap < TAPS; ++tap) {
        const uint32_t a =
            MODE == 0 ? sa + tap * A_BYTES + wg * (A_BYTES / 2)
                      : sa + ((tap / 3) * WIN_COLS + tap % 3) * 128 +
                            wg * (A_BYTES / 2);
        const uint32_t bo = MODE == 1 ? (a >> 7) & 7 : 0;
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          Wgmma<BN>::mma(acc, sw128_desc(a + kk * 32, bo),
                         sw128_desc(sb + kk * 32));
        wgmma_commit();
        wgmma_wait<1>();
        fence_acc(acc);
      }
    }
  }
  wgmma_wait<0>();
  fence_acc(acc);
  if (blockIdx.x != 0) return;
  const int lane = threadIdx.x % 32, warp = (threadIdx.x % 128) / 32;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int m = wg * 64 + warp * 16 + h * 8 + lane / 4;
        out[m * BN + 8 * j + 2 * (lane % 4) + e] = acc[4 * j + 2 * h + e];
      }
}

template <int BN, int MODE>
int launch_wgmma(const CUtensorMap& tw, const CUtensorMap& tt,
                 const CUtensorMap& tb, int grid, int reps, float* out,
                 cudaStream_t s) {
  const int smem = 1024 + BN * 128 + (MODE == 0 ? 9 * A_BYTES : WIN_ALLOC);
  auto kern = probe_wgmma_kernel<BN, MODE>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  kern<<<grid, 256, smem, s>>>(tw, tt, tb, reps, out);
  return (int)cudaGetLastError();
}

template <int BN>
int launch_wgmma_mode(int mode, const CUtensorMap& tw, const CUtensorMap& tt,
                      const CUtensorMap& tb, int grid, int reps, float* out,
                      cudaStream_t s) {
  switch (mode) {
    case 0: return launch_wgmma<BN, 0>(tw, tt, tb, grid, reps, out, s);
    case 1: return launch_wgmma<BN, 1>(tw, tt, tb, grid, reps, out, s);
    case 2: return launch_wgmma<BN, 2>(tw, tt, tb, grid, reps, out, s);
    case 3: return launch_wgmma<BN, 3>(tw, tt, tb, grid, reps, out, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// ---- 2: per-K-step load floor --------------------------------------------

constexpr int LOAD_BN = 64;
constexpr int LOAD_STAGE = A_BYTES + LOAD_BN * 128;

__global__ void __launch_bounds__(384, 1)
probe_load_kernel(const __grid_constant__ CUtensorMap tm_x,
                  const __grid_constant__ CUtensorMap tm_w, int tiles_x,
                  int tiles_y, int kchunks, int stages, float* out) {
  __shared__ __align__(8) uint64_t full[4];
  __shared__ __align__(8) uint64_t empty[4];
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t base = align1024(smem_u32(smem_raw));
  const int tile = blockIdx.x;
  const int x0 = (tile % tiles_x) * 128, y0 = (tile / tiles_x) % tiles_y;
  const int nb = tile / (tiles_x * tiles_y);
  const int ksteps = 9 * kchunks;
  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(smem_u32(&full[s]), 1);
      mbar_init(smem_u32(&empty[s]), 256);
    }
    fence_mbar_init();
  }
  __syncthreads();
  if (threadIdx.x >= 256) {
    if (threadIdx.x != 256) return;
    int s = 0;
    uint32_t ph = 0;
    for (int ks = 0; ks < ksteps; ++ks) {
      mbar_wait(smem_u32(&empty[s]), ph ^ 1);
      const uint32_t fb = smem_u32(&full[s]);
      mbar_expect_tx(fb, LOAD_STAGE);
      const int tap = ks % 9, c0 = (ks / 9) * 64;
      const uint32_t sa = base + s * LOAD_STAGE;
      tma_load_4d(sa, &tm_x, fb, c0, x0 + tap % 3 - 1, y0 + tap / 3 - 1, nb);
      tma_load_3d(sa + A_BYTES, &tm_w, fb, c0, tap, 0);
      if (++s == stages) {
        s = 0;
        ph ^= 1;
      }
    }
    return;
  }
  float sum = 0.f;
  int s = 0;
  uint32_t ph = 0;
  const unsigned char* smem = smem_raw + (base - smem_u32(smem_raw));
  for (int ks = 0; ks < ksteps; ++ks) {
    mbar_wait(smem_u32(&full[s]), ph);
    if (threadIdx.x == 0) {
      // pixel 0, channels 0-7: row 0 of the swizzle, unpermuted
      const __nv_bfloat16* p =
          reinterpret_cast<const __nv_bfloat16*>(smem + s * LOAD_STAGE);
#pragma unroll
      for (int i = 0; i < 8; ++i) sum += __bfloat162float(p[i]);
    }
    mbar_arrive(smem_u32(&empty[s]));
    if (++s == stages) {
      s = 0;
      ph ^= 1;
    }
  }
  if (threadIdx.x == 0) out[tile] = sum;
}

// ---- 3: output-store floor -----------------------------------------------

__device__ __forceinline__ uint4 pattern8(int y, int x, int w, int c0) {
  const int p = (y * w + x) * 7 + c0;
  uint32_t v[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const __nv_bfloat162 b = __floats2bfloat162_rn(
        (float)((p + 2 * i) & 255), (float)((p + 2 * i + 1) & 255));
    v[i] = *reinterpret_cast<const uint32_t*>(&b);
  }
  return make_uint4(v[0], v[1], v[2], v[3]);
}

// one block of br × wc pixels × 64 channels, 16-byte vector stores
__global__ void __launch_bounds__(256)
probe_store_st_kernel(__nv_bfloat16* out, int w, int br, int wc) {
  const int x0 = blockIdx.x * wc, y0 = blockIdx.y * br;
  for (int v = threadIdx.x; v < br * wc * 8; v += 256) {
    const int px = v / 8, q = v % 8;
    const int y = y0 + px / wc, x = x0 + px % wc;
    *reinterpret_cast<uint4*>(out + ((size_t)y * w + x) * 64 + 8 * q) =
        pattern8(y, x, w, 8 * q);
  }
}

// the same block as TMA stores of 128-pixel boxes from a two-buffer ring
__global__ void __launch_bounds__(128)
probe_store_tma_kernel(const __grid_constant__ CUtensorMap tm_out, int w,
                       int br, int wc) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t base = align1024(smem_u32(smem_raw));
  unsigned char* smem = smem_raw + (base - smem_u32(smem_raw));
  const int x0 = blockIdx.x * wc, y0 = blockIdx.y * br;
  const int per_row = wc / 128;
  for (int i = 0; i < br * per_row; ++i) {
    const int buf = i & 1;
    if (i >= 2) {
      if (threadIdx.x == 0) bulk_wait_read<1>();   // buffer i - 2 is read
      __syncthreads();
    }
    const int y = y0 + i / per_row, xb = x0 + (i % per_row) * 128;
    uint4* dst = reinterpret_cast<uint4*>(smem + buf * A_BYTES);
    for (int v = threadIdx.x; v < 128 * 8; v += 128)
      dst[v] = pattern8(y, xb + v / 8, w, 8 * (v % 8));
    fence_proxy_async();
    __syncthreads();
    if (threadIdx.x == 0) {
      tma_store_3d(&tm_out, base + buf * A_BYTES, 0, xb, y);
      bulk_commit();
    }
  }
  if (threadIdx.x == 0) bulk_wait<0>();
}

// ---- 4: TMA windows with zero fill ---------------------------------------

constexpr int WROWS = 8, WCOLS = 128;

__global__ void __launch_bounds__(256)
probe_window_kernel(const __grid_constant__ CUtensorMap tm_x,
                    __nv_bfloat16* out, int h, int w, int tiles_x,
                    int tiles_y) {
  __shared__ __align__(8) uint64_t bar;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t base = align1024(smem_u32(smem_raw));
  const unsigned char* smem = smem_raw + (base - smem_u32(smem_raw));
  const int tile = blockIdx.x;
  const int X0 = (tile % tiles_x) * WCOLS;
  const int Y0 = ((tile / tiles_x) % tiles_y) * WROWS;
  const int nb = tile / (tiles_x * tiles_y);
  const int H2 = h + 2, W2 = w + 2;
  if (threadIdx.x == 0) {
    mbar_init(smem_u32(&bar), 1);
    fence_mbar_init();
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    mbar_expect_tx(smem_u32(&bar), WROWS * WCOLS * 128);
    tma_load_4d(base, &tm_x, smem_u32(&bar), 0, X0 - 1, Y0 - 1, nb);
  }
  mbar_wait(smem_u32(&bar), 0);
  for (int v = threadIdx.x; v < WROWS * WCOLS * 8; v += 256) {
    const int r = v / 8, q = v % 8;
    const int Y = Y0 + r / WCOLS, X = X0 + r % WCOLS;
    if (Y >= H2 || X >= W2) continue;
    // 128-byte swizzle: 16-byte chunk q of row r sits at chunk q ^ (r % 8)
    const uint4 val =
        *reinterpret_cast<const uint4*>(smem + r * 128 + ((q ^ (r & 7)) * 16));
    *reinterpret_cast<uint4*>(out + (((size_t)nb * H2 + Y) * W2 + X) * 64 +
                              8 * q) = val;
  }
}

// ---- 6: the pool epilogue's primitives ----------------------------------

__device__ __forceinline__ uint32_t bf16x2_max(uint32_t a, uint32_t b) {
  const __nv_bfloat162 r =
      __hmax2(*reinterpret_cast<const __nv_bfloat162*>(&a),
              *reinterpret_cast<const __nv_bfloat162*>(&b));
  return *reinterpret_cast<const uint32_t*>(&r);
}

__device__ __forceinline__ uint32_t bf16x2_mul(uint32_t a, uint32_t b) {
  const __nv_bfloat162 r =
      __hmul2(*reinterpret_cast<const __nv_bfloat162*>(&a),
              *reinterpret_cast<const __nv_bfloat162*>(&b));
  return *reinterpret_cast<const uint32_t*>(&r);
}

__device__ __forceinline__ uint32_t bf16x2_pack(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

constexpr int OST_WORDS = 36;         // a staged o row: 32 pairs + 4 pad

// one block (one warpgroup) per row of `cells` cells, 64-cell tiles in turn
template <bool STAGED>
__global__ void __launch_bounds__(128)
probe_pool_kernel(const __nv_bfloat16* __restrict__ x,
                  const __nv_bfloat16* __restrict__ mask, int cells,
                  int shift, __nv_bfloat16* __restrict__ o,
                  __nv_bfloat16* __restrict__ p) {
  __shared__ __align__(16) unsigned char tile_s[64 * 256];
  __shared__ __align__(16) unsigned char pool_s[64 * 128];
  __shared__ uint32_t xw[4 * 4 * 8];
  __shared__ uint32_t ost[65 * OST_WORDS];   // STAGED: o of cells q0-1 ...
  const int t = threadIdx.x, warp = t / 32, lane = t % 32;
  const int quad = lane % 4, r8 = lane / 4;
  const size_t row = (size_t)blockIdx.x * cells;
  uint32_t carry[8];                  // shuffles: the last tile's cell 63 o
#pragma unroll
  for (int j = 0; j < 8; ++j) carry[j] = 0u;
  if (STAGED && t < OST_WORDS) ost[t] = 0u;
  for (int q0 = 0; q0 < cells; q0 += 64) {
    // the tile, by 16-byte loads, chunk c of cell m at chunk c ^ (m % 8)
    for (int i = t; i < 64 * 16; i += 128) {
      const int m = i / 16, c = i % 16;
      *reinterpret_cast<uint4*>(tile_s + m * 256 + ((c ^ (m & 7)) * 16)) =
          *reinterpret_cast<const uint4*>(x + (row + q0 + m) * 128 + 8 * c);
    }
    __syncthreads();
    // as accumulator fragments: d[4j + 2h + e] = X[16 warp + r8 + 8h][8j +
    // 2 quad + e], in f32
    float d[64];
    float mq[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = 16 * warp + r8 + 8 * h;
      mq[h] = __bfloat162float(mask[q0 + m]);
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const __nv_bfloat162 v = *reinterpret_cast<const __nv_bfloat162*>(
            tile_s + m * 256 + ((j ^ r8) * 16) + quad * 4);
        d[4 * j + 2 * h] = __low2float(v);
        d[4 * j + 2 * h + 1] = __high2float(v);
      }
    }
    __syncthreads();
    // the stem's epilogue: round, stage the row, 16-byte stores
    uint32_t P[16][2];
#pragma unroll
    for (int j = 0; j < 16; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        P[j][h] = bf16x2_pack(d[4 * j + 2 * h], d[4 * j + 2 * h + 1]);
        *reinterpret_cast<uint32_t*>(tile_s + (16 * warp + r8 + 8 * h) * 256 +
                                     ((j ^ r8) * 16) + quad * 4) = P[j][h];
      }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if (STAGED) {
        ost[(16 * warp + r8 + 1) * OST_WORDS + 4 * j + quad] = P[j + 8][0];
        ost[(16 * warp + r8 + 9) * OST_WORDS + 4 * j + quad] = P[j + 8][1];
      } else if (r8 == 7) {
        xw[(warp * 4 + quad) * 8 + j] = P[j + 8][1];
      }
    }
    __syncthreads();
    for (int i = t; i < 64 * 16; i += 128) {
      const int m = i / 16, c = i % 16;
      *reinterpret_cast<uint4*>(o + (row + q0 + m) * 128 + 8 * c) =
          *reinterpret_cast<const uint4*>(tile_s + m * 256 +
                                          ((c ^ (m & 7)) * 16));
    }
    // p = max(max(prev·m, e), o): e, o the parity halves one thread holds
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const uint32_t o0 = P[j + 8][0], o1 = P[j + 8][1];
      uint32_t prev0 = o0, prev1 = o1;
      if (shift) {
        if (STAGED) {
          prev0 = ost[(16 * warp + r8) * OST_WORDS + 4 * j + quad];
          prev1 = ost[(16 * warp + r8 + 8) * OST_WORDS + 4 * j + quad];
        } else {
          const uint32_t up0 = __shfl_up_sync(0xffffffffu, o0, 4);
          const uint32_t up1 = __shfl_up_sync(0xffffffffu, o1, 4);
          const uint32_t r7 = __shfl_sync(0xffffffffu, o0, (lane + 28) & 31);
          const uint32_t xv =
              warp > 0 ? xw[((warp - 1) * 4 + quad) * 8 + j] : carry[j];
          prev0 = r8 == 0 ? xv : up0;
          prev1 = r8 == 0 ? r7 : up1;
        }
      }
      const uint32_t m0 = bf16x2_pack(mq[0], mq[0]);
      const uint32_t m1 = bf16x2_pack(mq[1], mq[1]);
      const uint32_t p0 =
          bf16x2_max(bf16x2_max(bf16x2_mul(prev0, m0), P[j][0]), o0);
      const uint32_t p1 =
          bf16x2_max(bf16x2_max(bf16x2_mul(prev1, m1), P[j][1]), o1);
      *reinterpret_cast<uint32_t*>(pool_s + (16 * warp + r8) * 128 +
                                   ((j ^ r8) * 16) + quad * 4) = p0;
      *reinterpret_cast<uint32_t*>(pool_s + (16 * warp + r8 + 8) * 128 +
                                   ((j ^ r8) * 16) + quad * 4) = p1;
      // warp 0's row 0 takes the last tile's cell 63 at the next tile
      if (!STAGED) carry[j] = xw[(3 * 4 + quad) * 8 + j];
    }
    __syncthreads();
    if (STAGED && t < OST_WORDS) ost[t] = ost[64 * OST_WORDS + t];
    for (int i = t; i < 64 * 8; i += 128) {
      const int m = i / 8, c = i % 8;
      *reinterpret_cast<uint4*>(p + (row + q0 + m) * 64 + 8 * c) =
          *reinterpret_cast<const uint4*>(pool_s + m * 128 +
                                          ((c ^ (m & 7)) * 16));
    }
    __syncthreads();
  }
}

int set_smem(const void* kern, int smem) {
  return (int)cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
}

}  // namespace

// Probe 1. win (3, 130, 64) bf16, b (bn, 64) bf16; out (128, bn) f32 gets
// block 0's accumulator: reps · 2 · Σ_taps A_tap · bᵀ (mode 3: tap 0 only).
// `grid` blocks each run the same work (one per SM for a rate).
extern "C" int wsiseg_probe_wgmma(const void* win, const void* b, int bn,
                                  int mode, int grid, int reps, float* out,
                                  void* stream) {
  CUtensorMap tw, tt, tb;
  const uint64_t wd[3] = {64, WIN_COLS, 3};
  const uint64_t ws[2] = {128, WIN_COLS * 128};
  const uint32_t wbox[3] = {64, WIN_COLS, 3};
  const uint32_t tbox[3] = {64, 128, 1};
  int err = encode_tiled(&tw, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, win, wd,
                         ws, wbox, CU_TENSOR_MAP_SWIZZLE_128B);
  if (err == 0)
    err = encode_tiled(&tt, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, win, wd, ws,
                       tbox, CU_TENSOR_MAP_SWIZZLE_128B);
  const uint64_t bd[2] = {64, (uint64_t)bn};
  const uint64_t bs[1] = {128};
  const uint32_t bbox[2] = {64, (uint32_t)bn};
  if (err == 0)
    err = encode_tiled(&tb, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, b, bd, bs,
                       bbox, CU_TENSOR_MAP_SWIZZLE_128B);
  if (err != 0) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (bn) {
    case 16:
      return launch_wgmma_mode<16>(mode, tw, tt, tb, grid, reps, out, s);
    case 32:
      return launch_wgmma_mode<32>(mode, tw, tt, tb, grid, reps, out, s);
    case 64:
      return launch_wgmma_mode<64>(mode, tw, tt, tb, grid, reps, out, s);
    case 128:
      return launch_wgmma_mode<128>(mode, tw, tt, tb, grid, reps, out, s);
    case 256:
      return launch_wgmma_mode<256>(mode, tw, tt, tb, grid, reps, out, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// Probe 2. x (n, h, w, c) bf16 with c % 8 == 0 and w % 128 == 0, wt (64, 9,
// c) bf16; out (n · h · w / 128,) f32: per 1 × 128 tile, the sum over its
// 9 · ceil(c / 64) K steps of channels 0-7 of the step's first pixel.
extern "C" int wsiseg_probe_load(const void* x, int n, int h, int w, int c,
                                 const void* wt, int stages, float* out,
                                 void* stream) {
  if (stages < 1 || stages > 4 || c % 8 != 0 || w % 128 != 0)
    return (int)cudaErrorInvalidValue;
  CUtensorMap tx, tw;
  const uint64_t xd[4] = {(uint64_t)c, (uint64_t)w, (uint64_t)h, (uint64_t)n};
  const uint64_t xs[3] = {(uint64_t)c * 2, (uint64_t)w * c * 2,
                          (uint64_t)h * w * c * 2};
  const uint32_t xb[4] = {64, 128, 1, 1};
  int err = encode_tiled(&tx, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, x, xd, xs,
                         xb, CU_TENSOR_MAP_SWIZZLE_128B);
  const uint64_t wd[3] = {(uint64_t)c, 9, LOAD_BN};
  const uint64_t ws[2] = {(uint64_t)c * 2, (uint64_t)9 * c * 2};
  const uint32_t wb[3] = {64, 1, LOAD_BN};
  if (err == 0)
    err = encode_tiled(&tw, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, wt, wd, ws,
                       wb, CU_TENSOR_MAP_SWIZZLE_128B);
  if (err != 0) return err;
  const int smem = 1024 + stages * LOAD_STAGE;
  err = set_smem((const void*)probe_load_kernel, smem);
  if (err != 0) return err;
  const int tiles_x = w / 128;
  probe_load_kernel<<<n * h * tiles_x, 384, smem,
                      static_cast<cudaStream_t>(stream)>>>(
      tx, tw, tiles_x, h, (c + 63) / 64, stages, out);
  return (int)cudaGetLastError();
}

// Probe 3. out (h, w, 64) bf16 with h % br == 0, w % wc == 0, wc % 128 ==
// 0: out[y, x, c] = ((y·w + x)·7 + c) mod 256, block by block, by
// st.global (use_tma = 0) or TMA stores (1).
extern "C" int wsiseg_probe_store(void* out, int h, int w, int br, int wc,
                                  int use_tma, void* stream) {
  if (h % br != 0 || w % wc != 0 || wc % 128 != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(w / wc, h / br);
  if (!use_tma) {
    probe_store_st_kernel<<<grid, 256, 0, s>>>(
        static_cast<__nv_bfloat16*>(out), w, br, wc);
    return (int)cudaGetLastError();
  }
  CUtensorMap tm;
  const uint64_t d[3] = {64, (uint64_t)w, (uint64_t)h};
  const uint64_t st[2] = {128, (uint64_t)w * 128};
  const uint32_t box[3] = {64, 128, 1};
  int err = encode_tiled(&tm, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, out, d, st,
                         box, CU_TENSOR_MAP_SWIZZLE_NONE);
  if (err != 0) return err;
  const int smem = 1024 + 2 * A_BYTES;
  err = set_smem((const void*)probe_store_tma_kernel, smem);
  if (err != 0) return err;
  probe_store_tma_kernel<<<grid, 128, smem, s>>>(tm, w, br, wc);
  return (int)cudaGetLastError();
}

// Probe 4. x (n, h, w, c) bf16, c ∈ {8, 16, ..., 64}; out (n, h + 2, w + 2,
// 64) bf16 = x zero-padded by one pixel on each side and to 64 channels,
// read through 8 × 128-pixel TMA boxes at (X0 - 1, Y0 - 1).
extern "C" int wsiseg_probe_window(const void* x, int n, int h, int w, int c,
                                   void* out, void* stream) {
  if (c % 8 != 0 || c > 64) return (int)cudaErrorInvalidValue;
  CUtensorMap tm;
  const uint64_t d[4] = {(uint64_t)c, (uint64_t)w, (uint64_t)h, (uint64_t)n};
  const uint64_t st[3] = {(uint64_t)c * 2, (uint64_t)w * c * 2,
                          (uint64_t)h * w * c * 2};
  const uint32_t box[4] = {64, WCOLS, WROWS, 1};
  int err = encode_tiled(&tm, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, x, d, st,
                         box, CU_TENSOR_MAP_SWIZZLE_128B);
  if (err != 0) return err;
  const int smem = 1024 + WROWS * WCOLS * 128;
  err = set_smem((const void*)probe_window_kernel, smem);
  if (err != 0) return err;
  const int tiles_x = (w + 2 + WCOLS - 1) / WCOLS;
  const int tiles_y = (h + 2 + WROWS - 1) / WROWS;
  probe_window_kernel<<<n * tiles_x * tiles_y, 256, smem,
                        static_cast<cudaStream_t>(stream)>>>(
      tm, static_cast<__nv_bfloat16*>(out), h, w, tiles_x, tiles_y);
  return (int)cudaGetLastError();
}

// Probe 6. x (rows, cells, 128) bf16 with cells % 64 == 0, mask (cells,)
// bf16; o (rows, cells, 128) = x, p (rows, cells, 64) = max(max(prev·mask,
// e), o) with e = x[..., :64], o = x[..., 64:] and prev = o of the same cell
// (shift 0) or of the cell before, zero before the first (shift 1); the
// shift by shuffles (staged = 0) or through shared memory (1).
extern "C" int wsiseg_probe_pool(const void* x, const void* mask, int rows,
                                 int cells, int shift, int staged, void* o,
                                 void* p, void* stream) {
  if (rows < 1 || cells < 64 || cells % 64 != 0 || (shift != 0 && shift != 1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const __nv_bfloat16* xb = static_cast<const __nv_bfloat16*>(x);
  const __nv_bfloat16* mb = static_cast<const __nv_bfloat16*>(mask);
  __nv_bfloat16* ob = static_cast<__nv_bfloat16*>(o);
  __nv_bfloat16* pb = static_cast<__nv_bfloat16*>(p);
  if (staged)
    probe_pool_kernel<true><<<rows, 128, 0, s>>>(xb, mb, cells, shift, ob, pb);
  else
    probe_pool_kernel<false><<<rows, 128, 0, s>>>(xb, mb, cells, shift, ob, pb);
  return (int)cudaGetLastError();
}
