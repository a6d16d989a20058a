// Intra/inter wavefront reconstruction for Hopper (sm_90a).
//
// Replaces the TPU kernel of kvazaar_tpu/ops/wavefront_pallas.py:149
// (_make_kernel, launched by wavefront_plane_pallas at :338) in both its
// variants.  For every block of a fixed CU grid, in wavefront step
// order: an intra block builds the 4S+1 reference samples with 8.4.4.2.2
// substitution, applies the luma [1 2 1] filter and predicts the coded
// mode (planar, DC, angular, 8.4.4.2.4-6) with the luma DC/10/26
// boundary fixups; an inter block (P frames, the `inter=True` variant)
// takes its motion-compensated prediction instead.  Then residual,
// forward DCT, flat quantization (rounding 171/512 intra, 85/512
// inter), dequant, inverse DCT and clip.  Outputs are the levels of
// every block (raster block order) and the reconstructed plane; inter
// blocks feed later intra neighbours through that plane like any other.
//
// What bounds it on the card: the dependency chain, not bytes or
// operations.  On paper it is bytes-bound (a few tens of MB per launch
// at 3.35 TB/s is some microseconds), but a 832x480 luma plane at S=16
// is 224 dependent wavefront steps with at most 13 blocks each, so there
// is little work per step, and only one thread block per (frame, plane)
// item is busy: B x planes of 132 SMs.  A P frame is one luma item and
// two chroma items: 3 of 132 SMs.
//
// What this design does about it: nothing yet; correctness first.
// Frames are batched per launch (one thread block per item, the items
// run in parallel on separate SMs) and all slots of a step run
// together inside the block.  The reconstructed output plane in global
// memory is the only wavefront state: neighbour references are read
// straight from it after the __syncthreads() that ends each step (the
// TPU needed edge buffers because a scatter into a whole frame was
// costly there).
//
// Plain C interface (ktt_wavefront_recon); the PyTorch wrapper in
// kvazaar_tpu_torch/ops/wavefront.py allocates the outputs, checks the
// inputs and loads this library with ctypes.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

// H.265 Table 8-4 (index mode - 2) and Table 8-5 (index mode - 11).
__constant__ int kAngle[33] = {
    32, 26, 21, 17, 13, 9, 5, 2, 0, -2, -5, -9, -13, -17, -21, -26, -32,
    -26, -21, -17, -13, -9, -5, -2, 0, 2, 5, 9, 13, 17, 21, 26, 32};
__constant__ int kInvAngle[15] = {
    -4096, -1638, -910, -630, -482, -390, -315, -256,
    -315, -390, -482, -630, -910, -1638, -4096};

// Availability flag bits of the schedule (wavefront_pallas._schedule_np).
constexpr int kFlagL = 1, kFlagA = 2, kFlagAR = 4, kFlagBL = 8,
              kFlagAL = 16;

struct Params {
  const int32_t* orig;    // (nb, h, w) source samples
  const int32_t* modes;   // (bm, nblk) intra mode per block; item i uses
                          // row i % bm (Cb and Cr share the luma modes)
  const int32_t* sched;   // (n_steps, n_slots, 2) [block id, flags];
                          // pad slots carry block id nblk
  const int32_t* dct;     // (S, S) integer DCT matrix
  const uint8_t* inter;   // (bm, nblk) 1 = inter block, shared like
                          // modes; null for the intra variant
  const uint8_t* mc;      // (nb, h, w) MC prediction; null when intra
  uint8_t* rec;           // (nb, h, w) reconstruction = wavefront state
  int16_t* levels;        // (nb, nblk, S, S) quantized levels
  int bm, h, w, blocks_x, nblk, n_steps, n_slots;
  int luma, bitdepth;
  int q_scale, q_bits, q_offset, q_offset_inter, dq_mult, dq_shift;
};

__device__ __forceinline__ int round_shift(int x, int s) {
  return (x + (1 << (s - 1))) >> s;
}

__device__ __forceinline__ int clamp_int(int x, int lo, int hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

// Reference vector region of index i: 0 below-left, 1 left, 2 corner,
// 3 above, 4 above-right (the spec's substitution scan order).
template <int S>
__device__ __forceinline__ int ref_region(int i) {
  return i < S ? 0 : (i < 2 * S ? 1 : (i == 2 * S ? 2 : (i <= 3 * S ? 3
                                                                     : 4)));
}

// Sample i of the reference vector, read from the reconstructed plane:
// ref[i] = p[-1][2S-1-i] (i < 2S), ref[2S] = p[-1][-1],
// ref[2S+1+x] = p[x][-1].
template <int S>
__device__ __forceinline__ int read_ref(const uint8_t* plane, int w,
                                        int x0, int y0, int i) {
  int dx, dy;
  if (i < 2 * S) {
    dx = -1;
    dy = 2 * S - 1 - i;
  } else if (i == 2 * S) {
    dx = -1;
    dy = -1;
  } else {
    dx = i - 2 * S - 1;
    dy = -1;
  }
  return plane[(y0 + dy) * w + (x0 + dx)];
}

// 8.4.4.2.2 substitution at region granularity (availability is whole
// region on a uniform CU grid): an unavailable region takes the last
// sample of the nearest available region before it, or, with none
// before, the first sample of the first available region after it;
// with no region available every sample is mid-grey.
template <int S>
__device__ int build_ref(const uint8_t* plane, int w, int x0, int y0,
                         int flags, int i, int mid) {
  const int bit[5] = {kFlagBL, kFlagL, kFlagAL, kFlagA, kFlagAR};
  const int first[5] = {0, S, 2 * S, 2 * S + 1, 3 * S + 1};
  const int last[5] = {S - 1, 2 * S - 1, 2 * S, 3 * S, 4 * S};
  const int region = ref_region<S>(i);
  if (flags & bit[region]) return read_ref<S>(plane, w, x0, y0, i);
  for (int r = region - 1; r >= 0; --r)
    if (flags & bit[r]) return read_ref<S>(plane, w, x0, y0, last[r]);
  for (int r = region + 1; r < 5; ++r)
    if (flags & bit[r]) return read_ref<S>(plane, w, x0, y0, first[r]);
  return mid;
}

// 8.4.4.2.3 filterFlag for luma (ops/intra.py _filter_flag).
template <int S>
__device__ __forceinline__ bool filter_flag(int mode) {
  if (mode == 1 || S == 4) return false;
  const int d26 = mode > 26 ? mode - 26 : 26 - mode;
  const int d10 = mode > 10 ? mode - 10 : 10 - mode;
  const int dist = d26 < d10 ? d26 : d10;
  return dist > (S == 8 ? 7 : (S == 16 ? 1 : 0));
}

// Prediction of sample (x, y) for `mode`.  p: the reference vector the
// mode reads (smoothed where filterFlag holds); u: unfiltered refs for
// the luma boundary fixups.
template <int S, int LOG2S>
__device__ int predict(const int* p, const int* u, int mode, int x, int y,
                       bool fixups, int maxv) {
#define LEFT(arr, yy) (arr)[2 * S - 1 - (yy)]
#define TOP(arr, xx) (arr)[2 * S + 1 + (xx)]
  if (mode == 0) {
    return ((S - 1 - x) * LEFT(p, y) + (x + 1) * TOP(p, S) +
            (S - 1 - y) * TOP(p, x) + (y + 1) * LEFT(p, S) + S) >>
           (LOG2S + 1);
  }
  if (mode == 1) {
    int sum = S;
    for (int k = 0; k < S; ++k) sum += TOP(p, k) + LEFT(p, k);
    const int dc = sum >> (LOG2S + 1);
    if (!fixups) return dc;
    if (x == 0 && y == 0) return (LEFT(u, 0) + 2 * dc + TOP(u, 0) + 2) >> 2;
    if (y == 0) return (TOP(u, x) + 3 * dc + 2) >> 2;
    if (x == 0) return (LEFT(u, y) + 3 * dc + 2) >> 2;
    return dc;
  }
  const int corner = u[2 * S];
  if (fixups && mode == 10 && y == 0)
    return clamp_int(LEFT(u, 0) + ((TOP(u, x) - corner) >> 1), 0, maxv);
  if (fixups && mode == 26 && x == 0)
    return clamp_int(TOP(u, 0) + ((LEFT(u, y) - corner) >> 1), 0, maxv);
  const int angle = kAngle[mode - 2];
  const bool vertical = mode >= 18;
  const int t = vertical ? y + 1 : x + 1;
  const int idx = (t * angle) >> 5;
  const int fact = (t * angle) & 31;
  const int base = (vertical ? x : y) + idx + 1;
  // Extended main reference array (8.4.4.2.6): k >= 0 reads the main
  // side, k < 0 projects onto the other side through invAngle.
  auto ext = [&](int k) -> int {
    if (k >= 0) return vertical ? TOP(p, k - 1) : LEFT(p, k - 1);
    const int j = -1 + ((k * kInvAngle[mode - 11] + 128) >> 8);
    return vertical ? LEFT(p, j) : TOP(p, j);
  };
  int acc = (32 - fact) * ext(base);
  if (fact) acc += fact * ext(base + 1);
  return (acc + 16) >> 5;
#undef LEFT
#undef TOP
}

// One thread block per (frame, plane) item; SS = S*S threads per slot,
// `spp` slots of a step at a time.  Thread t of a slot owns sample
// (t / S, t % S) of the block and entry (t / S, t % S) of every
// transform stage.
template <int S, int LOG2S, int SPP_MAX>
__global__ void __launch_bounds__(SPP_MAX * S * S)
    wavefront_kernel(Params p) {
  constexpr int SS = S * S;
  constexpr int R = 4 * S + 1;
  __shared__ int s_dct[SS];
  __shared__ int s_ref[SPP_MAX][R];
  __shared__ int s_flt[SPP_MAX][R];
  __shared__ int s_a[SPP_MAX][SS];
  __shared__ int s_b[SPP_MAX][SS];

  const int spp = blockDim.x / SS;
  const int g = threadIdx.x / SS;
  const int t = threadIdx.x % SS;
  const int ty = t / S, tx = t % S;
  const size_t plane = (size_t)p.h * p.w;
  const int32_t* orig = p.orig + blockIdx.x * plane;
  uint8_t* rec = p.rec + blockIdx.x * plane;
  const int32_t* modes = p.modes + (size_t)(blockIdx.x % p.bm) * p.nblk;
  const uint8_t* inter_of =
      p.inter ? p.inter + (size_t)(blockIdx.x % p.bm) * p.nblk : nullptr;
  const uint8_t* mc = p.mc ? p.mc + blockIdx.x * plane : nullptr;
  int16_t* levels = p.levels + (size_t)blockIdx.x * p.nblk * SS;
  const int mid = 1 << (p.bitdepth - 1);
  const int maxv = (1 << p.bitdepth) - 1;
  const int shift1 = LOG2S + p.bitdepth - 9;
  const int ishift2 = 20 - p.bitdepth;
  int* ref = s_ref[g];
  int* flt = s_flt[g];
  int* a = s_a[g];
  int* b = s_b[g];

  for (int i = threadIdx.x; i < SS; i += blockDim.x) s_dct[i] = p.dct[i];
  __syncthreads();

  for (int step = 0; step < p.n_steps; ++step) {
    for (int base = 0; base < p.n_slots; base += spp) {
      const int slot = base + g;
      int bid = p.nblk, flags = 0;
      if (slot < p.n_slots) {
        bid = p.sched[(step * p.n_slots + slot) * 2];
        flags = p.sched[(step * p.n_slots + slot) * 2 + 1];
      }
      // Pad slots (and groups past the last slot) only join barriers.
      const bool active = bid < p.nblk;
      const int x0 = active ? (bid % p.blocks_x) * S : 0;
      const int y0 = active ? (bid / p.blocks_x) * S : 0;
      const int mode = active ? modes[bid] : 0;
      // Inter blocks skip the reference build and the intra prediction.
      const bool inter = active && inter_of != nullptr && inter_of[bid];
      const bool intra = active && !inter;

      if (intra)
        for (int i = t; i < R; i += SS)
          ref[i] = build_ref<S>(rec, p.w, x0, y0, flags, i, mid);
      __syncthreads();

      const bool smooth = p.luma && filter_flag<S>(mode);
      if (intra)
        for (int i = t; i < R; i += SS)
          flt[i] = (smooth && i > 0 && i < R - 1)
                       ? (ref[i - 1] + 2 * ref[i] + ref[i + 1] + 2) >> 2
                       : ref[i];
      __syncthreads();

      int pred = 0;
      if (active) {
        const int at = (y0 + ty) * p.w + x0 + tx;
        pred = inter ? mc[at]
                     : predict<S, LOG2S>(flt, ref, mode, tx, ty,
                                         p.luma != 0, maxv);
        a[t] = orig[at] - pred;
      }
      __syncthreads();

      // Forward stage 1 (columns): E[k][m] = sum_n T[k][n] X[n][m].
      if (active) {
        int acc = 0;
#pragma unroll
        for (int n = 0; n < S; ++n) acc += s_dct[ty * S + n] * a[n * S + tx];
        b[t] = round_shift(acc, shift1);
      }
      __syncthreads();

      // Forward stage 2 (rows): C[k][l] = sum_m T[l][m] E[k][m]; then
      // flat quantization and dequantization.
      if (active) {
        int acc = 0;
#pragma unroll
        for (int m = 0; m < S; ++m) acc += s_dct[tx * S + m] * b[ty * S + m];
        const int c = round_shift(acc, LOG2S + 6);
        const int mag = c < 0 ? -c : c;
        const int q_offset = inter ? p.q_offset_inter : p.q_offset;
        int lv = (mag * p.q_scale + q_offset) >> p.q_bits;
        lv = lv > 32767 ? 32767 : lv;
        lv = c < 0 ? -lv : lv;
        levels[(size_t)bid * SS + t] = (int16_t)lv;
        a[t] = clamp_int(
            (lv * p.dq_mult + (1 << (p.dq_shift - 1))) >> p.dq_shift,
            -32768, 32767);
      }
      __syncthreads();

      // Inverse stage 1: E[n][m] = sum_k T[k][n] D[k][m], clipped.
      if (active) {
        int acc = 0;
#pragma unroll
        for (int k = 0; k < S; ++k) acc += s_dct[k * S + ty] * a[k * S + tx];
        b[t] = clamp_int(round_shift(acc, 7), -32768, 32767);
      }
      __syncthreads();

      // Inverse stage 2: r[n][l] = sum_m T[m][l] E[n][m]; reconstruct.
      if (active) {
        int acc = 0;
#pragma unroll
        for (int m = 0; m < S; ++m) acc += s_dct[m * S + tx] * b[ty * S + m];
        const int r = clamp_int(round_shift(acc, ishift2), -32768, 32767);
        rec[(y0 + ty) * p.w + x0 + tx] = (uint8_t)clamp_int(pred + r, 0, maxv);
      }
      // Ends the pass: this step's samples are visible to the next.
      __syncthreads();
    }
  }
}

template <int S, int LOG2S>
void launch(const Params& p, int nb, cudaStream_t stream) {
  constexpr int kSppMax = 1024 / (S * S);
  const int spp = p.n_slots < kSppMax ? p.n_slots : kSppMax;
  wavefront_kernel<S, LOG2S, kSppMax><<<nb, spp * S * S, 0, stream>>>(p);
}

}  // namespace

// inter and mc are both null (intra variant) or both set (inter).
extern "C" int ktt_wavefront_recon(
    const int32_t* orig, const int32_t* modes, const int32_t* sched,
    const int32_t* dct, const uint8_t* inter, const uint8_t* mc,
    uint8_t* rec, int16_t* levels, int nb, int bm, int h, int w,
    int blocks_x, int nblk, int n_steps, int n_slots, int s, int luma,
    int bitdepth, int q_scale, int q_bits, int q_offset,
    int q_offset_inter, int dq_mult, int dq_shift, void* stream) {
  if ((inter == nullptr) != (mc == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  Params p{orig,     modes,    sched,    dct,      inter,          mc,
           rec,      levels,   bm,       h,        w,              blocks_x,
           nblk,     n_steps,  n_slots,  luma,     bitdepth,       q_scale,
           q_bits,   q_offset, q_offset_inter,     dq_mult,        dq_shift};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (s) {
    case 4:
      launch<4, 2>(p, nb, st);
      break;
    case 8:
      launch<8, 3>(p, nb, st);
      break;
    case 16:
      launch<16, 4>(p, nb, st);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
