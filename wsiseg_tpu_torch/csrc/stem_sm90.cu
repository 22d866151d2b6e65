// Fused ResNet stem for Hopper (sm_90a) on wgmma: u8 RGB → normalize → 7×7/2
// conv (3→64) → BatchNorm → ReLU, with normalize and BN folded into the
// weights and bias by the Python wrapper (wsiseg_tpu_torch/ops/stem.py).
// One kernel template, two modes:
//
//   pool mode — replaces wsiseg_tpu/ops/pallas_stem.py::_stem2_kernel (entry
//     stem_pool_conv): emits space_to_depth(c1) (N, H/4, W/4, 256) and the
//     3×3/2 max-pool of c1 (N, H/4, W/4, 64); native c1 is never written;
//   native mode — replaces wsiseg_tpu/ops/pallas_stem.py::_stem_kernel
//     (entry stem_conv): emits c1 (N, H/2, W/2, 64).
//
// The same kernel, with its A-operand assembly as a template parameter, is
// the Hopper form of scripts/exp_r6e.py::_stem3_kernel (stem v3, block-wide
// patch assembly); wsiseg_tpu_torch/probes.py (probe 5) runs the three forms.
//
// The cell form (pallas_stem.py's v2 and exp_r6e.py:80-88): the image is read
// as quarter-resolution cells of 4 pixels × RGB (12 u8 values, 4 zero values
// after them). An implicit GEMM per c1 row y:
//   M = 64 cells q of the row, N = 128 = (column parity β, channel co),
//   K = 336 = 21 k-steps of 16 values: kernel row ky, cell shift s (0-2),
//   A[q][ks = 3·ky + s] = cell q + s of input row 2y + ky - 3,
//   B = fold_stem_weights_cells (row 48·ky + 16·s + 3·pixel + channel).
// The accumulator row of cell q is then c1[y, 2q + β, co] at column 64·β +
// co: 256 contiguous output bytes, s2d(c1)[y/2, q, 128·(y%2) : +128] in pool
// mode, c1[y, 2q : 2q + 2, :] in native mode. Pixels outside the image read
// as the per-channel pad value clip(round(255·mean)) (zero after
// normalization).
//
// What bounds it on an H100 (arithmetic, not a measurement): at the bench
// geometry, a 3072×4096 level-2 image, pool mode writes 503 MB (s2d 403 MB,
// pool 101 MB) and reads 38 MB, 0.16 ms at 3.35 TB/s; native mode writes 403
// MB, 0.13 ms. The cell form does 2.29× the stem's useful operations (K =
// 336 for 147 taps): 135 GFLOP, 0.14 ms at 989 TFLOP/s. So it is bound by
// its output bytes, and the epilogue decides its time.
//
// What this design does about it:
//   - the B operand (86 KB, 21 k-steps × 128 × 16 bf16, K-major without
//     swizzle) is loaded once per block and stays resident; each warpgroup of
//     the block owns a unit — a strip of 64 cells over a segment of c1 rows —
//     and walks down it, so a block reloads no weights per tile;
//   - the A operand lives in shared memory as two 8-value planes per cell,
//     16 bytes a cell, read by no-swizzle descriptors (core matrix = 8 cells,
//     128 bytes). Its assembly, u8 → bf16 through registers, is the FORM
//     parameter: PER_ROW builds each c1 row's 21 k-step tiles (P1's "v2");
//     BLOCK writes each input row of the segment once, with its three cell
//     shifts, into a ring of 9 rows (P1's "v3"); BLOCK_SHIFTED writes each
//     row once and reads shift s through a descriptor s cells (16·s bytes)
//     further on. Every form feeds the same operands in the same k-step
//     order, so their outputs are bit-identical. The block forms assemble
//     the next row's two new input rows while the current row's wgmmas run;
//   - the epilogue adds the bias, applies ReLU, rounds to bf16, stages the
//     row in shared memory (16-byte chunks XOR-swizzled by cell, free of
//     bank conflicts) and writes it with coalesced 16-byte stores — not with
//     4-byte stores from the accumulator registers, which stall the tensor
//     cores (conv3x3_sm90.cu's finding). Two or three warpgroups a block
//     overlap one's epilogue with another's wgmmas;
//   - the pool: the row maximum is carried in registers down the segment
//     (bf16 pairs; max commutes with the rounding), the column parity halves
//     co and 64 + co sit in one thread, and the one-cell shift o[q - 1] is a
//     __shfl_up_sync by 4 lanes inside an 8-row group, a shuffle from the
//     other half-row for row 8, and shared memory across warps. The TPU
//     kernel carried the pool's halo row across a sequential grid; here M row
//     0 of a pool strip is the cell left of the strip (63 output cells a
//     strip, 1.6 % more work; masked to zero left of the image) and a
//     segment below the first recomputes the c1 row above it (about 1 % at
//     the bench geometry). Out-of-range taps of the pool read zero, which is
//     exact after ReLU.
// Ragged edges are masked at the stores: a W/4 that is not a multiple of 63
// or 64, and in native mode with W % 4 == 2 the last cell's β = 1 column.
// The launch plan (units, segments, warpgroups a block) is ops/stem.py's
// plan_stem, which the CPU tests reach.

#include "sm90.cuh"

namespace {

using namespace sm90;

constexpr int KSTEPS = 21;                  // (ky, s)
constexpr int BN = 128;                     // (β, co)
constexpr int CELLS = 64;                   // wgmma M
constexpr int SLAB = CELLS + 2;             // cells of one input row
constexpr int RING = 9;                     // input rows kept (block forms)
constexpr int KSTEP_BYTES = 2 * BN * 16;    // one k-step of B: two planes
constexpr int W_BYTES = KSTEPS * KSTEP_BYTES;
constexpr int TILE_BYTES = CELLS * 32;      // one k-step of A: two planes
constexpr int STAGE_BYTES = CELLS * 256;    // one output row
constexpr int XW_BYTES = 4 * 4 * 8 * 4;     // the pool's cross-warp shift
constexpr int MAX_WGS = 3;
constexpr int MAX_DYN_SMEM = 232448 - 512;  // the H100's limit, less static

enum Form { PER_ROW = 0, BLOCK = 1, BLOCK_SHIFTED = 2 };

__host__ __device__ constexpr int slab_bytes(int form) {
  return form == PER_ROW ? KSTEPS * TILE_BYTES
         : form == BLOCK ? RING * 3 * TILE_BYTES
                         : RING * SLAB * 32;
}

__host__ __device__ constexpr int wg_bytes(int form) {
  return slab_bytes(form) + STAGE_BYTES + XW_BYTES;
}

struct StemArgs {
  const uint8_t* img;                       // (n, h, w, 3)
  const uint4* wc;                          // (21, 2, 128, 8) bf16
  const float* bias;                        // (64,)
  __nv_bfloat16* out0;                      // s2d(c1), or c1
  __nv_bfloat16* out1;                      // the pool (pool mode)
  int n, h, w, pad0, pad1, pad2;
  int strips, segs, seg_rows, units;
};

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t max_bf16x2(uint32_t a, uint32_t b) {
  const __nv_bfloat162 r =
      __hmax2(*reinterpret_cast<const __nv_bfloat162*>(&a),
              *reinterpret_cast<const __nv_bfloat162*>(&b));
  return *reinterpret_cast<const uint32_t*>(&r);
}

// Cell c of image row iy — image columns 4c - 3 ... 4c, value 3·pixel +
// channel, pad values outside the image — as bf16 in two 16-byte planes:
// p0 = values 0-7, p1 = values 8-11 and four zeros. u8 values are exact in
// bf16.
__device__ __forceinline__ void load_cell(const StemArgs& a, int nb, int iy,
                                          int c, uint4& p0, uint4& p1) {
  const int x0 = 4 * c - 3;
  const bool row_in = iy >= 0 && iy < a.h;
  const uint8_t* row = a.img + ((size_t)nb * a.h + (row_in ? iy : 0)) *
                                   a.w * 3;
  uint32_t b[3] = {0u, 0u, 0u};             // the 12 bytes, little-endian
  bool done = false;
  if (row_in && x0 >= 0 && x0 + 4 <= a.w) {
    // four aligned words around the cell's 12 bytes, when they lie in the row
    const uintptr_t lo = reinterpret_cast<uintptr_t>(row);
    const uintptr_t p = lo + 3 * x0;
    const uintptr_t pa = p & ~static_cast<uintptr_t>(3);
    if (pa >= lo && pa + 16 <= lo + 3 * (uintptr_t)a.w) {
      const uint32_t* q = reinterpret_cast<const uint32_t*>(pa);
      const uint32_t w0 = __ldg(q), w1 = __ldg(q + 1), w2 = __ldg(q + 2),
                     w3 = __ldg(q + 3);
      const uint32_t sh = static_cast<uint32_t>(p & 3) * 8;
      b[0] = __funnelshift_r(w0, w1, sh);
      b[1] = __funnelshift_r(w1, w2, sh);
      b[2] = __funnelshift_r(w2, w3, sh);
      done = true;
    }
  }
  if (!done) {
#pragma unroll
    for (int v = 0; v < 12; ++v) {
      const int px = v / 3, ch = v % 3, x = x0 + px;
      uint32_t byte = ch == 0 ? a.pad0 : (ch == 1 ? a.pad1 : a.pad2);
      if (row_in && x >= 0 && x < a.w) byte = row[3 * x + ch];
      b[v / 4] |= (byte & 255u) << (8 * (v % 4));
    }
  }
  float f[12];
#pragma unroll
  for (int v = 0; v < 12; ++v) f[v] = (float)((b[v / 4] >> (8 * (v % 4))) & 255u);
  p0 = make_uint4(pack_bf16(f[0], f[1]), pack_bf16(f[2], f[3]),
                  pack_bf16(f[4], f[5]), pack_bf16(f[6], f[7]));
  p1 = make_uint4(pack_bf16(f[8], f[9]), pack_bf16(f[10], f[11]), 0u, 0u);
}

__device__ __forceinline__ void store16(unsigned char* p, const uint4& v) {
  *reinterpret_cast<uint4*>(p) = v;
}

template <int FORM, bool POOL>
__global__ void __launch_bounds__(128 * MAX_WGS, 1)
stem_sm90_kernel(const StemArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float bias_s[64];
  const int tid = threadIdx.x;

  // the resident B operand and the bias, once per block
  uint4* wsm = reinterpret_cast<uint4*>(smem);
  for (int i = tid; i < W_BYTES / 16; i += blockDim.x) wsm[i] = __ldg(a.wc + i);
  if (tid < 64) bias_s[tid] = __ldg(a.bias + tid);
  fence_proxy_async();
  __syncthreads();

  // from here on, each warpgroup runs its own unit, synchronised by its own
  // named barrier
  const int wg = tid / 128, t = tid % 128;
  const int unit = blockIdx.x * (blockDim.x / 128) + wg;
  if (unit >= a.units) return;
  const int bar = 1 + wg;
  unsigned char* slabs = smem + W_BYTES + wg * wg_bytes(FORM);
  unsigned char* stage = slabs + slab_bytes(FORM);
  uint32_t* xw = reinterpret_cast<uint32_t*>(stage + STAGE_BYTES);
  const uint32_t slabs_u = smem_u32(slabs), w_u = smem_u32(smem);

  // the unit, as ops/stem.StemPlan.unit: image nb, M rows = cells c0 ...
  // c0 + 63 (pool: c0 = the cell left of the strip), c1 rows y_first ...
  // y_end - 1, of which rows from y_begin are stored
  constexpr int HALO = POOL ? 1 : 0;
  const int seg = unit % a.segs, su = unit / a.segs;
  const int strip = su % a.strips, nb = su / a.strips;
  const int c0 = strip * (CELLS - HALO) - HALO;
  const int rows = a.h / 2, w2 = a.w / 2, h4 = a.h / 4, w4 = a.w / 4;
  const int y_begin = seg * a.seg_rows;
  const int y_end = min(rows, y_begin + a.seg_rows);
  const int y_first = y_begin - (POOL && y_begin > 0 ? 1 : 0);
  const int cells_out = POOL ? w4 : (w2 + 1) / 2;

  // block forms: input rows pr0 ... pr0 + nr - 1 (padded frame: image row
  // pr - 3) into ring slot pr % RING, cells c0 ... c0 + 65
  auto assemble_rows = [&](int pr0, int nr) {
    for (int i = t; i < nr * SLAB; i += 128) {
      const int pr = pr0 + i / SLAB, j = i % SLAB;
      uint4 p0, p1;
      load_cell(a, nb, pr - 3, c0 + j, p0, p1);
      if (FORM == BLOCK) {
        // shift copy s holds cell c0 + m + s at row m
        unsigned char* base = slabs + (pr % RING) * (3 * TILE_BYTES);
#pragma unroll
        for (int s = 0; s < 3; ++s) {
          const int m = j - s;
          if (m >= 0 && m < CELLS) {
            store16(base + s * TILE_BYTES + m * 16, p0);
            store16(base + s * TILE_BYTES + CELLS * 16 + m * 16, p1);
          }
        }
      } else {
        unsigned char* base = slabs + (pr % RING) * (SLAB * 32);
        store16(base + j * 16, p0);
        store16(base + SLAB * 16 + j * 16, p1);
      }
    }
  };
  // per_row: the 21 k-step tiles of c1 row y
  auto assemble_tile = [&](int y) {
    for (int i = t; i < KSTEPS * CELLS; i += 128) {
      const int ks = i / CELLS, m = i % CELLS;
      uint4 p0, p1;
      load_cell(a, nb, 2 * y + ks / 3 - 3, c0 + m + ks % 3, p0, p1);
      store16(slabs + ks * TILE_BYTES + m * 16, p0);
      store16(slabs + ks * TILE_BYTES + CELLS * 16 + m * 16, p1);
    }
  };
  // A of k-step ks of c1 row y: 8-cell core matrices 128 bytes apart, the
  // two planes LBO apart
  auto a_desc = [&](int y, int ks) -> uint64_t {
    const int slot = (2 * y + ks / 3) % RING, s = ks % 3;
    if (FORM == PER_ROW)
      return nosw_desc(slabs_u + ks * TILE_BYTES, CELLS * 16, 128);
    if (FORM == BLOCK)
      return nosw_desc(slabs_u + (slot * 3 + s) * TILE_BYTES, CELLS * 16,
                       128);
    return nosw_desc(slabs_u + slot * SLAB * 32 + s * 16, SLAB * 16, 128);
  };

  const int warp = t / 32, lane = t % 32, quad = lane % 4, r8 = lane / 4;
  float acc[BN / 2];
  uint32_t carry[16][2];      // pool: running row max of the pool window
#pragma unroll
  for (int j = 0; j < 16; ++j) carry[j][0] = carry[j][1] = 0u;

  if (FORM != PER_ROW) {
    assemble_rows(2 * y_first, 7);
    fence_proxy_async();
    bar_sync(bar, 128);
  }
  for (int y = y_first; y < y_end; ++y) {
    if (FORM == PER_ROW) {
      assemble_tile(y);
      fence_proxy_async();
      bar_sync(bar, 128);
    }
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < KSTEPS; ++ks)
      Wgmma<BN>::mma(acc, a_desc(y, ks),
                     nosw_desc(w_u + ks * KSTEP_BYTES, BN * 16, 128));
    wgmma_commit();
    // the next row's two new input rows, into slots no wgmma of row y reads
    if (FORM != PER_ROW && y + 1 < y_end) {
      assemble_rows(2 * y + 7, 2);
      fence_proxy_async();
    }
    wgmma_wait<0>();
    fence_acc(acc);

    // epilogue: + bias, ReLU, bf16 pairs. Thread (warp, lane) holds
    // D[16·warp + lane/4 + 8h][8j + 2·(lane%4) + e] in acc[4j + 2h + e].
    const bool store_row = y >= y_begin;
    uint32_t P[16][2];
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int n = (8 * j + 2 * quad) & 63;
      const float b0 = bias_s[n], b1 = bias_s[n + 1];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float v0 = acc[4 * j + 2 * h] + b0;
        const float v1 = acc[4 * j + 2 * h + 1] + b1;
        P[j][h] = pack_bf16(v0 > 0.f ? v0 : 0.f, v1 > 0.f ? v1 : 0.f);
      }
    }
    // pool, odd row 2P+1: carry becomes the window's row max R
    if (POOL && (y & 1)) {
#pragma unroll
      for (int j = 0; j < 16; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) carry[j][h] = max_bf16x2(carry[j][h], P[j][h]);
    }
    // stage the row: 16-byte chunk c of cell m at chunk c ^ (m % 8)
#pragma unroll
    for (int j = 0; j < 16; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = 16 * warp + r8 + 8 * h;
        *reinterpret_cast<uint32_t*>(stage + m * 256 + ((j ^ r8) * 16) +
                                     quad * 4) = P[j][h];
      }
    if (POOL && (y & 1) && r8 == 7) {
      // row 16·warp + 15's odd-column half, for the next warp's row 0
#pragma unroll
      for (int j = 0; j < 8; ++j) xw[(warp * 4 + quad) * 8 + j] = carry[j + 8][1];
    }
    bar_sync(bar, 128);
    if (store_row) {
      for (int i = t; i < CELLS * 16; i += 128) {
        const int m = i / 16, c = i % 16, q = c0 + m;
        if (m < HALO || q >= cells_out || (!POOL && c >= 8 && 2 * q + 1 >= w2))
          continue;
        const uint4 v = *reinterpret_cast<const uint4*>(
            stage + m * 256 + ((c ^ (m & 7)) * 16));
        __nv_bfloat16* dst =
            POOL ? a.out0 + (((size_t)nb * h4 + y / 2) * w4 + q) * 256 +
                       128 * (y & 1)
                 : a.out0 + (((size_t)nb * rows + y) * w2 + 2 * q) * 64;
        *reinterpret_cast<uint4*>(dst + 8 * c) = v;
      }
    }
    if (POOL) {
      if (y & 1) {
        if (store_row) {
          // pool[q] = max(E[q], O[q], O[q - 1]) with E, O the parity halves
          // of R; O[q - 1]: 4 lanes up, row 7 for row 8, the previous
          // warp's row 15 for row 0 (warp 0's row 0 is the halo cell,
          // masked to zero left of the image: c1 column -1 is outside)
          const bool mask0 = c0 < 0 && warp == 0 && r8 == 0;
          uint32_t pl[8][2];
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const uint32_t o0 = mask0 ? 0u : carry[j + 8][0];
            const uint32_t o1 = carry[j + 8][1];
            const uint32_t up0 = __shfl_up_sync(0xffffffffu, o0, 4);
            const uint32_t up1 = __shfl_up_sync(0xffffffffu, o1, 4);
            const uint32_t r7 = __shfl_sync(0xffffffffu, o0, (lane + 28) & 31);
            const uint32_t xv = warp > 0 ? xw[((warp - 1) * 4 + quad) * 8 + j] : 0u;
            const uint32_t prev0 = r8 == 0 ? xv : up0;
            const uint32_t prev1 = r8 == 0 ? r7 : up1;
            pl[j][0] = max_bf16x2(max_bf16x2(carry[j][0], o0), prev0);
            pl[j][1] = max_bf16x2(max_bf16x2(carry[j][1], o1), prev1);
          }
          bar_sync(bar, 128);       // the row's copy-out has read the stage
#pragma unroll
          for (int j = 0; j < 8; ++j)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int m = 16 * warp + r8 + 8 * h;
              *reinterpret_cast<uint32_t*>(stage + m * 128 + ((j ^ r8) * 16) +
                                           quad * 4) = pl[j][h];
            }
          bar_sync(bar, 128);
          for (int i = t; i < CELLS * 8; i += 128) {
            const int m = i / 8, c = i % 8, q = c0 + m;
            if (m < HALO || q >= cells_out) continue;
            const uint4 v = *reinterpret_cast<const uint4*>(
                stage + m * 128 + ((c ^ (m & 7)) * 16));
            *reinterpret_cast<uint4*>(
                a.out1 + (((size_t)nb * h4 + y / 2) * w4 + q) * 64 + 8 * c) = v;
          }
        }
#pragma unroll
        for (int j = 0; j < 16; ++j) carry[j][0] = P[j][0], carry[j][1] = P[j][1];
      } else {
#pragma unroll
        for (int j = 0; j < 16; ++j)
#pragma unroll
          for (int h = 0; h < 2; ++h) carry[j][h] = max_bf16x2(carry[j][h], P[j][h]);
      }
    }
    // the stage is read and the next row's input rows are visible
    bar_sync(bar, 128);
  }
}

template <int FORM, bool POOL>
int launch(const StemArgs& a, int wgs, cudaStream_t stream) {
  auto kern = stem_sm90_kernel<FORM, POOL>;
  const int smem = W_BYTES + wgs * wg_bytes(FORM);
  const cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  kern<<<(a.units + wgs - 1) / wgs, 128 * wgs, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry for ctypes. img (n, h, w, 3) u8, h and w even (multiples of
// 4 when pool); w_cells (21, 2, 128, 8) bf16 from ops/stem.prepare_stem_cells;
// bias (64,) f32; pool: out0 = s2d(c1) (n, h/4, w/4, 256) and out1 = the
// pool (n, h/4, w/4, 64), else out0 = c1 (n, h/2, w/2, 64), bf16, allocated
// by the caller. form: 0 per_row, 1 block, 2 block_shifted. The plan
// (strips, segs, seg_rows, wgs) comes from ops/stem.plan_stem. Launches on
// `stream` on the calling thread's current device without synchronising
// and returns 0 or a CUDA error code.
extern "C" int wsiseg_stem_sm90(const void* img, const void* w_cells,
                                const void* bias, int n, int h, int w,
                                int pad0, int pad1, int pad2, void* out0,
                                void* out1, int pool, int form, int strips,
                                int segs, int seg_rows, int wgs,
                                void* stream) {
  const int halo = pool ? 1 : 0;
  const int cells_out = pool ? w / 4 : (w / 2 + 1) / 2;
  if (n < 1 || h < 2 || w < 2 || h % 2 || w % 2 ||
      (pool && (h % 4 || w % 4 || seg_rows % 2 || out1 == nullptr)) ||
      form < 0 || form > 2 || wgs < 1 || wgs > MAX_WGS ||
      W_BYTES + wgs * wg_bytes(form) > MAX_DYN_SMEM || segs < 1 ||
      seg_rows < 1 || segs * seg_rows < h / 2 ||
      strips * (CELLS - halo) < cells_out)
    return (int)cudaErrorInvalidValue;
  StemArgs a;
  a.img = static_cast<const uint8_t*>(img);
  a.wc = static_cast<const uint4*>(w_cells);
  a.bias = static_cast<const float*>(bias);
  a.out0 = static_cast<__nv_bfloat16*>(out0);
  a.out1 = static_cast<__nv_bfloat16*>(out1);
  a.n = n;
  a.h = h;
  a.w = w;
  a.pad0 = pad0;
  a.pad1 = pad1;
  a.pad2 = pad2;
  a.strips = strips;
  a.segs = segs;
  a.seg_rows = seg_rows;
  a.units = n * strips * segs;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (form * 2 + (pool ? 1 : 0)) {
    case 0: return launch<PER_ROW, false>(a, wgs, s);
    case 1: return launch<PER_ROW, true>(a, wgs, s);
    case 2: return launch<BLOCK, false>(a, wgs, s);
    case 3: return launch<BLOCK, true>(a, wgs, s);
    case 4: return launch<BLOCK_SHIFTED, false>(a, wgs, s);
    default: return launch<BLOCK_SHIFTED, true>(a, wgs, s);
  }
}
