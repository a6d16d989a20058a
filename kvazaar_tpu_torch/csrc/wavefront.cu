// Intra/inter wavefront reconstruction for Hopper (sm_90a).
//
// Replaces the TPU kernel of kvazaar_tpu/ops/wavefront_pallas.py:149
// (_make_kernel, launched by wavefront_plane_pallas at :338) in both its
// variants.  For every block of a fixed CU grid, in wavefront step
// order: an intra block builds the 4S+1 reference samples with 8.4.4.2.2
// substitution, applies the luma [1 2 1] filter and predicts the coded
// mode (planar, DC, angular, 8.4.4.2.4-6) with the luma DC/10/26
// boundary fixups below S=32; an inter block (P frames, the `inter=True`
// variant) takes its motion-compensated prediction instead.  Then residual,
// forward DCT, flat quantization (rounding 171/512 intra, 85/512
// inter) at the plane's QP or, given a per-block QP map (LCU rate
// control, ROI and AQ; the TPU kernel has none, and the JAX package
// reconstructs such frames with its XLA scan), at each block's own QP,
// dequant, inverse DCT and clip.  Outputs are the levels of
// every block (raster block order) and the reconstructed planes; inter
// blocks feed later intra neighbours through the edge state like any
// other block.
//
// What bounds it on the card: neither bytes nor operations but the
// latency of one wavefront step.  A 832x480 luma plane at S=16 is 224
// dependent steps of at most 13 blocks; each plane of a frame is one
// thread block on one SM (a P frame fills 3 of 132 SMs), and a step is
// one dependent chain per block: reference build, prediction, four
// transform stages, quantization, reconstruction, then the barrier that
// makes the step's samples visible to the next.  The bytes (some tens of
// MB per launch) would take microseconds.  Measured on an H100: the
// step time follows the length of one warp's chain, not the SM's issue
// rate (splitting a step's blocks over a 2-CTA cluster did not shorten
// it, nor did moving the transforms to the tensor cores, whose int/fp
// conversions lengthen the chain).
//
// What this design does about it:
// - One pass per step.  A slot group runs one block: two warps at S=32,
//   a whole warp at S=16 and S=8 (so blocks of different modes never
//   share a warp), 8 lanes at S=4.  Stages inside a group synchronise
//   with __syncwarp, or at S=32 with the group's own named barrier; the
//   step ends with the one __syncthreads that publishes its
//   reconstruction.  A step with more blocks than groups loops the
//   groups without a block barrier.
// - Wavefront state in shared memory: the bottom row (hrow) and right
//   column (vcol) of every block of the last K block rows, the TPU
//   kernel's hrow/vcol edge buffers, as a ring of samples (uint8, or
//   16-bit at 10-bit) indexed by block row modulo K.  The wrapper
//   derives K from the schedule (the smallest depth at which no block
//   overwrites an edge before its last reader's step).  Reference
//   builds read only this ring; the reconstructed plane in global
//   memory is written and never read.
// - Step-independent inputs off the chain: the schedule, modes, inter
//   flags and availability are packed into one word per block, in step
//   order, once per launch (a global table of the thread block's own);
//   each group loads the word of its block two steps ahead into a
//   register and copies the source and MC samples of its next step's
//   block into a shared double buffer (cp.async) while the current step
//   runs.  Shared memory thus holds the step offsets, the edge ring, the
//   coefficient tables and the groups' buffers: it grows with the
//   plane's width and height, not with its area (layout_of below).
// - A short chain per step: substitution from a bit mask of available
//   regions, angular prediction from an extended main reference built
//   once per block (no branch per sample), divisions by the grid width
//   and ring depth as multiply-highs, and each 1-D transform split over
//   the lanes of a row by its even-odd symmetry (the partial butterfly
//   of the HEVC reference encoders), with per-lane coefficient tables.
// - Luma and chroma of a batch are one launch: the first CTAs run the
//   luma plane at S, the rest Cb and Cr at S/2, each on its own SM, so a
//   P frame's chroma runs beside its luma instead of after it.
// - Luma S=32 (the CU 32 grid, whose chroma is S=16; the TPU kernel
//   stops at S=16 and the JAX package reconstructs cu 32 with an XLA
//   scan) keeps the even-odd split of the smaller sizes by giving a
//   block two warps: each lane owns one row and, of every 1-D
//   transform, the even or the odd half of its outputs, so no lane
//   holds more than 16 outputs.  Its luma intra path applies the [1 2 1]
//   reference filter for every mode but DC, 10 and 26
//   (intraHorVerDistThres 0) and no boundary fixups; the JAX package
//   applies no strong intra smoothing, and nor does this kernel.
// - 10-bit (Main 10) samples are an instance of their own at every CU
//   size, QP map or not (the TPU kernel is 8-bit only; the JAX package
//   reconstructs 10-bit frames with its XLA scan): 16-bit samples in the
//   edge ring and rec, int16 source and MC planes staged as 2-byte
//   samples (which keeps a 3840-wide cu 32 launch inside the opt-in
//   shared memory, where int32 staging would not fit), mid-grey 512,
//   clip 1023, forward shift log2 S + 1, inverse shift 10 and the
//   quantizer's shifts at bitdepth 10 (without a QpBdOffset, as the
//   JAX package quantizes).
// - Lossless coding (transquant bypass) is an instance of its own at
//   every CU size and sample depth, without QP maps (the TPU kernel has
//   none; the JAX package reconstructs lossless frames with its XLA
//   scan): the forward and inverse transforms and the quantizers are
//   compiled out, a block's levels are its residual (source minus the
//   intra or MC prediction) and its reconstruction is its source.  With
//   implicit RDPCM, a run-time flag of that instance only, an intra block
//   of mode 10 codes the horizontal and one of mode 26 the vertical
//   differences of its residual (luma and chroma, through the shared
//   mode; inter blocks never), the lanes reading their neighbours'
//   residuals through the group's transform buffer, and luma predicts
//   without the DC / 10 / 26 boundary fixups.
// - Tiles (a uniform tile grid, --tiles) cut every prediction dependency,
//   so every tile of an item is a thread block of its own, with its own
//   step range and an edge ring over its own rows, ring_w its width and K
//   its own depth (3 for the tiles of a 1920x1088 or 3840x2176 3x3 grid,
//   where one ring over the whole frame would need K = 12..16 and more
//   shared memory than a block may have).  A 1080p frame at 3x3 then
//   runs on 9 SMs per plane.  Tiled plans have instances of their own
//   (without QP maps, which the configuration refuses under tiles), so
//   that the untiled ones keep their code and registers.
// - RDOQ and sign-data hiding (the JAX package sends both past its TPU
//   kernel to its XLA scan) are the run-time flags of instances of their
//   own (TQ), at every CU size, sample depth, QP map or tile plan, so that
//   the other instances keep their code and registers.  RDOQ is the JAX
//   package's vectorized form: each coefficient takes the cheapest of
//   {0, l - 1, l} (l its round-half level) by pixel-domain distortion
//   plus lambda times a static rate (the remainder bits from the
//   wrapper's table, the plain version's), then each 4x4 group whose
//   zeroed distortion is below its kept cost plus lambda is zeroed; its
//   float32 arithmetic rounds exactly where the plain version's does, in
//   the orders of the JAX package's fixed-grid programs (explicit _rn
//   intrinsics, no contraction into FMA: lambda times the rate rounded on
//   its own, the kept costs' group sums row after row; F2 in
//   ROADMAP.md).  Sign hiding then fixes the parity
//   of each 4x4 group in the block's scan (scanIdx by the plane's mode:
//   mode-dependent for luma S <= 8 and chroma S = 4, diagonal otherwise
//   and for inter blocks).  Levels, best costs and zeroed costs pass
//   through the group's transform buffers and its consumed source buffer,
//   and one lane per 4x4 group makes the group decisions.
// - Explicit chroma modes (--rd 3): the chroma planes of a launch may take
//   their own mode table (Params::cmodes), read only when the schedule is
//   packed, by the TQ and the lossless instances (a lossy launch with
//   chroma modes and neither tool runs the TQ instance with both flags
//   off), so that the other instances keep their code.
// - The intra-NxN point (fixed CU 4: 8x8 CUs coded PART_NxN; the JAX
//   package reconstructs it with its XLA scan) has instances of its own,
//   CU = 4, 8- and 10-bit, plain, TQ or lossless: luma alone on the plan
//   of 4x4 blocks, 8 lanes a block, the DST-VII of 8.6.4.2 from a table of
//   its own (kDst4; it has no even-odd symmetry, so each output is a full
//   4-term sum), the luma DC / 10 / 26 fixups and no [1 2 1] filter.
//   Transform skip is a run-time flag of the lossy ones: both roundtrips
//   run (the skip coefficients through the same quantizer and sign
//   hiding), and the block keeps the cheaper by the plain version's
//   float32 cost (an exact integer SSD, the rate terms of the wrapper's
//   table summed by shuffles in its order, one multiply-add in double),
//   writing its decision per block.  Its chroma, one 4x4 TB per 8x8 CU, is
//   a chroma-only launch of the cu 8 instances on the cu 8 plan.
// - Scaling lists (--scaling-list default, --cqmfile; the TPU kernel has
//   none and the JAX package reconstructs such frames with its XLA scan)
//   are instances of their own (SL) at every CU size, sample depth, tile
//   plan and TQ or not, never with QP maps or lossless, which the
//   configuration refuses with them, so that the flat instances keep
//   their code and registers.  Each plane of a launch brings its (4, S,
//   S) int32 tables at its QP % 6: the quantizer scale (QUANT_SCALES << 4)
//   / m and the dequantizer multiplier INV_QUANT_SCALES * m of its intra
//   and its inter blocks (the block's inter bit picks one), each stored
//   transposed (column x, row y at x * S + y), so that the lanes of a
//   group, one coefficient row each, read consecutive words (read row by
//   row, one load of a warp touched S cache lines and the S = 32 launch
//   ran 1.5-1.7x the flat one).  They are read-only global loads (16 KiB
//   a plane at S = 32, which the 8-bit cu 32 launch at 832x480, at 219632
//   of 232448 bytes, cannot add to its shared memory), in place of the
//   flat scale and multiplier of the quantizer, RDOQ and the
//   dequantizer.  The quantizer keeps its shift and rounding offsets; the
//   dequantizer follows the reference's scaling-list schedule with sh =
//   bitdepth + log2 S - 5 - QP / 6: (l m + 2^(sh-1)) >> sh when sh > 0,
//   else the product clipped to int16 and shifted up by -sh.
//
// Plain C interface (ktt_wavefront_recon, ktt_wavefront_layout); the
// PyTorch wrapper in kvazaar_tpu_torch/ops/wavefront.py derives the
// schedule tables and the ring depth, allocates the outputs, checks the
// inputs and loads this library with ctypes.

#include <cstdint>
#include <type_traits>

#include <cuda_runtime.h>

// One plane kind of a launch: nb items (frames) of (h, w) samples at
// block size s.  orig and mc hold uint8 or int32 samples at 8-bit and
// int16 samples at 10-bit (orig_bytes, mc_bytes); rec holds uint8
// samples at 8-bit and 16-bit ones at 10-bit; mc is null for the intra
// variant.  qp, where set, holds
// each block's QP (0..51, this plane's: the chroma planes' are mapped
// through Table 8-10), shared by the items like the modes; the blocks
// then quantize at their own QP, and q_scale, q_bits, q_offset,
// q_offset_inter and dq_mult are unused.
struct KttPlane {
  const void* orig;
  const void* mc;
  void* rec;          // (nb, h, w)
  int16_t* levels;    // (nb, nblk, s, s)
  const int32_t* qp;  // (bm, nblk) or null
  int nb, s, h, w, luma, orig_bytes, mc_bytes;
  int q_scale, q_bits, q_offset, q_offset_inter, dq_mult, dq_shift;
};

namespace {

// Sample depth of an instance: 8-bit (uint8 samples in the edge ring and
// rec) or, HBD, 10-bit (16-bit samples; the TPU kernel stops at 8-bit and
// the JAX package reconstructs 10-bit frames with its XLA scan).  SB is
// the bytes of one staged source or MC sample: int32 or uint8 planes at
// 8-bit (a stage slot holds int32), int16 planes at 10-bit.
template <bool HBD>
struct Depth {
  using Pix = std::conditional_t<HBD, uint16_t, uint8_t>;
  static constexpr int BITS = HBD ? 10 : 8;
  static constexpr int MID = 1 << (BITS - 1), MAXV = (1 << BITS) - 1;
  static constexpr int SB = HBD ? 2 : 4;
};

// HEVC transform matrix for nTbS = 32 (8.6.4.2); the S-point matrix is
// rows k * (32 / S), columns 0..S-1.
__constant__ int kT32[32][32] = {
    {64, 64, 64, 64, 64, 64, 64, 64, 64, 64, 64, 64, 64, 64, 64, 64, 64, 64, 64,
     64, 64, 64, 64, 64, 64, 64, 64, 64, 64, 64, 64, 64},
    {90, 90, 88, 85, 82, 78, 73, 67, 61, 54, 46, 38, 31, 22, 13, 4, -4, -13,
     -22, -31, -38, -46, -54, -61, -67, -73, -78, -82, -85, -88, -90, -90},
    {90, 87, 80, 70, 57, 43, 25, 9, -9, -25, -43, -57, -70, -80, -87, -90, -90,
     -87, -80, -70, -57, -43, -25, -9, 9, 25, 43, 57, 70, 80, 87, 90},
    {90, 82, 67, 46, 22, -4, -31, -54, -73, -85, -90, -88, -78, -61, -38, -13,
     13, 38, 61, 78, 88, 90, 85, 73, 54, 31, 4, -22, -46, -67, -82, -90},
    {89, 75, 50, 18, -18, -50, -75, -89, -89, -75, -50, -18, 18, 50, 75, 89, 89,
     75, 50, 18, -18, -50, -75, -89, -89, -75, -50, -18, 18, 50, 75, 89},
    {88, 67, 31, -13, -54, -82, -90, -78, -46, -4, 38, 73, 90, 85, 61, 22, -22,
     -61, -85, -90, -73, -38, 4, 46, 78, 90, 82, 54, 13, -31, -67, -88},
    {87, 57, 9, -43, -80, -90, -70, -25, 25, 70, 90, 80, 43, -9, -57, -87, -87,
     -57, -9, 43, 80, 90, 70, 25, -25, -70, -90, -80, -43, 9, 57, 87},
    {85, 46, -13, -67, -90, -73, -22, 38, 82, 88, 54, -4, -61, -90, -78, -31,
     31, 78, 90, 61, 4, -54, -88, -82, -38, 22, 73, 90, 67, 13, -46, -85},
    {83, 36, -36, -83, -83, -36, 36, 83, 83, 36, -36, -83, -83, -36, 36, 83, 83,
     36, -36, -83, -83, -36, 36, 83, 83, 36, -36, -83, -83, -36, 36, 83},
    {82, 22, -54, -90, -61, 13, 78, 85, 31, -46, -90, -67, 4, 73, 88, 38, -38,
     -88, -73, -4, 67, 90, 46, -31, -85, -78, -13, 61, 90, 54, -22, -82},
    {80, 9, -70, -87, -25, 57, 90, 43, -43, -90, -57, 25, 87, 70, -9, -80, -80,
     -9, 70, 87, 25, -57, -90, -43, 43, 90, 57, -25, -87, -70, 9, 80},
    {78, -4, -82, -73, 13, 85, 67, -22, -88, -61, 31, 90, 54, -38, -90, -46, 46,
     90, 38, -54, -90, -31, 61, 88, 22, -67, -85, -13, 73, 82, 4, -78},
    {75, -18, -89, -50, 50, 89, 18, -75, -75, 18, 89, 50, -50, -89, -18, 75, 75,
     -18, -89, -50, 50, 89, 18, -75, -75, 18, 89, 50, -50, -89, -18, 75},
    {73, -31, -90, -22, 78, 67, -38, -90, -13, 82, 61, -46, -88, -4, 85, 54,
     -54, -85, 4, 88, 46, -61, -82, 13, 90, 38, -67, -78, 22, 90, 31, -73},
    {70, -43, -87, 9, 90, 25, -80, -57, 57, 80, -25, -90, -9, 87, 43, -70, -70,
     43, 87, -9, -90, -25, 80, 57, -57, -80, 25, 90, 9, -87, -43, 70},
    {67, -54, -78, 38, 85, -22, -90, 4, 90, 13, -88, -31, 82, 46, -73, -61, 61,
     73, -46, -82, 31, 88, -13, -90, -4, 90, 22, -85, -38, 78, 54, -67},
    {64, -64, -64, 64, 64, -64, -64, 64, 64, -64, -64, 64, 64, -64, -64, 64, 64,
     -64, -64, 64, 64, -64, -64, 64, 64, -64, -64, 64, 64, -64, -64, 64},
    {61, -73, -46, 82, 31, -88, -13, 90, -4, -90, 22, 85, -38, -78, 54, 67, -67,
     -54, 78, 38, -85, -22, 90, 4, -90, 13, 88, -31, -82, 46, 73, -61},
    {57, -80, -25, 90, -9, -87, 43, 70, -70, -43, 87, 9, -90, 25, 80, -57, -57,
     80, 25, -90, 9, 87, -43, -70, 70, 43, -87, -9, 90, -25, -80, 57},
    {54, -85, -4, 88, -46, -61, 82, 13, -90, 38, 67, -78, -22, 90, -31, -73, 73,
     31, -90, 22, 78, -67, -38, 90, -13, -82, 61, 46, -88, 4, 85, -54},
    {50, -89, 18, 75, -75, -18, 89, -50, -50, 89, -18, -75, 75, 18, -89, 50, 50,
     -89, 18, 75, -75, -18, 89, -50, -50, 89, -18, -75, 75, 18, -89, 50},
    {46, -90, 38, 54, -90, 31, 61, -88, 22, 67, -85, 13, 73, -82, 4, 78, -78,
     -4, 82, -73, -13, 85, -67, -22, 88, -61, -31, 90, -54, -38, 90, -46},
    {43, -90, 57, 25, -87, 70, 9, -80, 80, -9, -70, 87, -25, -57, 90, -43, -43,
     90, -57, -25, 87, -70, -9, 80, -80, 9, 70, -87, 25, 57, -90, 43},
    {38, -88, 73, -4, -67, 90, -46, -31, 85, -78, 13, 61, -90, 54, 22, -82, 82,
     -22, -54, 90, -61, -13, 78, -85, 31, 46, -90, 67, 4, -73, 88, -38},
    {36, -83, 83, -36, -36, 83, -83, 36, 36, -83, 83, -36, -36, 83, -83, 36, 36,
     -83, 83, -36, -36, 83, -83, 36, 36, -83, 83, -36, -36, 83, -83, 36},
    {31, -78, 90, -61, 4, 54, -88, 82, -38, -22, 73, -90, 67, -13, -46, 85, -85,
     46, 13, -67, 90, -73, 22, 38, -82, 88, -54, -4, 61, -90, 78, -31},
    {25, -70, 90, -80, 43, 9, -57, 87, -87, 57, -9, -43, 80, -90, 70, -25, -25,
     70, -90, 80, -43, -9, 57, -87, 87, -57, 9, 43, -80, 90, -70, 25},
    {22, -61, 85, -90, 73, -38, -4, 46, -78, 90, -82, 54, -13, -31, 67, -88, 88,
     -67, 31, 13, -54, 82, -90, 78, -46, 4, 38, -73, 90, -85, 61, -22},
    {18, -50, 75, -89, 89, -75, 50, -18, -18, 50, -75, 89, -89, 75, -50, 18, 18,
     -50, 75, -89, 89, -75, 50, -18, -18, 50, -75, 89, -89, 75, -50, 18},
    {13, -38, 61, -78, 88, -90, 85, -73, 54, -31, 4, 22, -46, 67, -82, 90, -90,
     82, -67, 46, -22, -4, 31, -54, 73, -85, 90, -88, 78, -61, 38, -13},
    {9, -25, 43, -57, 70, -80, 87, -90, 90, -87, 80, -70, 57, -43, 25, -9, -9,
     25, -43, 57, -70, 80, -87, 90, -90, 87, -80, 70, -57, 43, -25, 9},
    {4, -13, 22, -31, 38, -46, 54, -61, 67, -73, 78, -82, 85, -88, 90, -90, 90,
     -90, 88, -85, 82, -78, 73, -67, 61, -54, 46, -38, 31, -22, 13, -4}};

// H.265 Table 8-4 (index mode - 2) and Table 8-5 (index mode - 11).
__constant__ int kAngle[33] = {
    32, 26, 21, 17, 13, 9, 5, 2, 0, -2, -5, -9, -13, -17, -21, -26, -32,
    -26, -21, -17, -13, -9, -5, -2, 0, 2, 5, 9, 13, 17, 21, 26, 32};
__constant__ int kInvAngle[15] = {
    -4096, -1638, -910, -630, -482, -390, -315, -256,
    -315, -390, -482, -630, -910, -1638, -4096};

// H.265 8.6.4.2 DST-VII of the 4x4 intra luma TBs (the intra-NxN point's
// cu 4 instances; a table of its own, so that the other instances keep
// their coefficient tables and registers).
__constant__ int kDst4[4][4] = {{29, 55, 74, 84},
                                {74, 74, 0, -74},
                                {84, -29, -74, 55},
                                {55, -84, 74, -29}};

// Quantizer and dequantizer scales per QP % 6 (8.6.3; the flat list).
__constant__ int kQuantScale[6] = {26214, 23302, 20560, 18396, 16384, 14564};
__constant__ int kInvQuantScale[6] = {40, 45, 51, 57, 64, 72};

// Position in the scan of each raster position (y * 4 + x) of a 4x4
// group, per scanIdx (0 diagonal, 1 horizontal, 2 vertical; ops/scan.py).
__constant__ int kScan4Pos[3][16] = {
    {0, 2, 5, 9, 1, 4, 8, 12, 3, 7, 11, 14, 6, 10, 13, 15},
    {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15},
    {0, 4, 8, 12, 1, 5, 9, 13, 2, 6, 10, 14, 3, 7, 11, 15}};

// Packed per-block word: block id, availability mask, coded mode, inter
// flag.  Bit r of the mask is set when reference region r is available,
// in the substitution scan order of 8.4.4.2.2: 0 below-left, 1 left, 2
// above-left corner, 3 above, 4 above-right.  The wrapper's blk_info
// holds the step-order position in the low kAvailShift bits.
constexpr int kAvailShift = 20, kModeShift = 25, kInterBit = 31;
constexpr uint32_t kPosMask = (1u << kAvailShift) - 1;
constexpr int kMaxBlocks = 1 << kAvailShift;

struct Params {
  KttPlane plane[3];
  int item_end[3];          // cumulative item counts of the planes
  int n_planes;
  const uint32_t* blk_info;  // (nblk) position in its tile's step order
                             // | mask << 20
  const int32_t* step_start; // (n_tiles, n_steps + 1): per tile, the first
                             // position of each of its steps, then its
                             // block count (repeated past its last step)
  const int32_t* modes;      // (bm, nblk); item i uses row i % bm
  const uint8_t* inter;      // (bm, nblk) bool, shared like modes; null
                             // for the intra variant
  uint32_t* entries;         // (items x tiles, tile_blocks) packed words
                             // in step order, written by the kernel
  int bm, blocks_x, nblk, n_steps, n_slots;  // steps and slots: the most
                                             // of any tile (a tile with
                                             // fewer runs empty steps)
  int ring, ring_w;          // ring depth K and row stride (the widest
                             // tile's width in the widest plane)
  int off_ring, off_coef, off_groups;  // shared memory offsets (bytes);
                                       // the step offsets start at 0
  // Implicit RDPCM (the bypass instance only).  Last, so that the
  // fields before it keep their offsets: placed after ring_w, it made
  // the other cu 16 instances 4 % slower on an H100.
  int rdpcm;
  // Tiles: (n_tiles, 4) ints, each tile's first block column and row,
  // width and height in blocks; one thread block per (item, tile), every
  // tile from step 0 (tiles cut every prediction dependency);
  // tile_blocks: the most blocks of any tile.
  const int4* tile_info;
  int n_tiles, tile_blocks;
  // Explicit chroma modes (bm, nblk), shared like modes, or null: the
  // chroma planes then take modes (DM).
  const int32_t* cmodes;
  // RDOQ and sign hiding (the TQ instances only): the flags, lambda
  // rounded to float32, the all-zero candidate's rate term
  // float32(lambda * 0.15f) and the remainder-bits table (32768 floats,
  // ops/quant.rem_bits_np).
  const float* rem_bits;
  float lam, zero_cost;
  int rdoq, signhide;
  // Transform skip (the cu 4 instances only, never with RDOQ): the flag,
  // the (items, nblk) int32 decisions written per block, and the
  // decision's rate term per level magnitude (32768 floats,
  // ops/quant.tskip_bits_np).
  int tskip;
  int32_t* skip_out;
  const float* tskip_bits;
  // Scaling lists (the SL instances only): per plane, its (4, S, S) int32
  // tables (quantizer scale intra, inter, dequantizer multiplier intra,
  // inter; each transposed, position (y, x) at x * S + y) and its
  // dequantizer shift bitdepth + log2 S - 5 - QP / 6.
  const int32_t* sl_tab[3];
  int sl_shift[3];
};

// Words of one S x S block of staged samples of sb bytes each.
template <int S>
__host__ __device__ constexpr int block_words(int sb) {
  return S * S * sb / 4;
}

// Words of one slot group's shared memory, a multiple of 4: a double
// buffer of the source and MC samples of the group's block (S x S each,
// sb bytes a sample), the reference and filtered reference vectors (4S+1,
// padded to 4S+2), the extended main reference of the angular modes
// (indices -S..2S+1) and two S x (S+1) transform buffers.
template <int S>
__host__ __device__ constexpr int group_words(int sb) {
  return (4 * block_words<S>(sb) + 2 * (4 * S + 2) + (3 * S + 2) +
          2 * S * (S + 1) + 3) /
         4 * 4;
}

// Reference vector regions in scan order (see kAvailShift) and their
// first and last index.
template <int S>
__device__ __forceinline__ int ref_region(int i) {
  return i < S ? 0 : (i < 2 * S ? 1 : (i == 2 * S ? 2 : (i <= 3 * S ? 3
                                                                     : 4)));
}

template <int S>
__device__ __forceinline__ int region_first(int r) {
  return r <= 2 ? r * S : (r - 1) * S + 1;
}

template <int S>
__device__ __forceinline__ int region_last(int r) {
  return r <= 1 ? (r + 1) * S - 1 : r * S;
}

// Asynchronous global -> shared copy of B bytes (cp.async).
template <int B>
__device__ __forceinline__ void cp_async(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if constexpr (B == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
                 "l"(src)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(d),
                 "l"(src), "n"(B)
                 : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// n / d for n, d >= 0 with n d < 2^32 (block ids by the grid width, block
// rows by the ring depth; ktt_wavefront_recon checks the bound) as a
// multiply-high by m = ceil(2^32 / d), m from reciprocal(d).
__device__ __forceinline__ uint32_t reciprocal(int d) {
  return d == 1 ? 0u : (uint32_t)((0x100000000ull + d - 1) / d);
}

__device__ __forceinline__ int div_by(int n, int d, uint32_t m) {
  return d == 1 ? n : (int)__umulhi((uint32_t)n, m);
}

__device__ __forceinline__ int round_shift(int x, int s) {
  return (x + (1 << (s - 1))) >> s;
}

__device__ __forceinline__ int clamp_int(int x, int lo, int hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

// Lanes of a slot group.  A group of L lanes runs one block: lane
// (y, q) = (lane % S, lane / S) owns row y and, of each 1-D transform,
// vector y and part q of P = L / S parts.  S=32 takes two warps, S=16
// and S=8 a whole warp (so the blocks of a warp never diverge on their
// modes), S=4 a quarter.  A part is O = S / P samples of the row: the M = O / 2
// columns q*M.. and their mirrors S-1-(q*M..), the pairs that the
// even-odd transform couples.
template <int S>
struct Shape {
  static constexpr int L = S == 4 ? 8 : (S == 32 ? 64 : 32);
  static constexpr int P = L / S;
  static constexpr int O = S / P;
  static constexpr int M = O / 2;
  static constexpr int LOG2 = S == 32 ? 5 : (S == 16 ? 4 : (S == 8 ? 3 : 2));
};

// Column of a lane's sample i (i < M: q*M + i; then the mirrors).
template <int S>
__device__ __forceinline__ int owned_col(int q, int i) {
  constexpr int M = Shape<S>::M;
  return i < M ? q * M + i : S - 1 - (q * M + i - M);
}

// Shared-memory coefficient tables of one lane part q (ints):
// forward, (O, S/2): row i = C[k_i][0..S/2) for the part's outputs k_i
// = 2 ((q >> 1) O + i) + (q & 1), all even or all odd; inverse, (M, S):
// row i = C[0..S)[q*M + i].  C[k][n] = kT32[k * 32 / S][n].
template <int S>
__device__ __forceinline__ int fwd_out(int q, int i) {
  return 2 * ((q >> 1) * Shape<S>::O + i) + (q & 1);
}

template <int S>
__device__ void fill_coefs(int* coef) {
  using Sh = Shape<S>;
  constexpr int NF = Sh::P * Sh::O * (S / 2), NI = Sh::P * Sh::M * S;
  for (int t = threadIdx.x; t < NF; t += blockDim.x) {
    const int q = t / (Sh::O * (S / 2)), i = t / (S / 2) % Sh::O;
    coef[t] = kT32[fwd_out<S>(q, i) * (32 / S)][t % (S / 2)];
  }
  for (int t = threadIdx.x; t < NI; t += blockDim.x) {
    const int q = t / (Sh::M * S), i = t / S % Sh::M;
    coef[NF + t] = kT32[(t % S) * (32 / S)][q * Sh::M + i];
  }
}

// Forward part: out[i] = sum_n C[k_i][n] v[n] over the full vector v,
// as C[k_i][n] (v[n] +- v[S-1-n]) for n < S/2: even rows are symmetric,
// odd rows antisymmetric (sgn = -1 for the odd parts).
template <int S>
__device__ __forceinline__ void fwd_part(const int* v, const int* cf,
                                         int sgn, int* out) {
  constexpr int H = S / 2;
  int w[H];
#pragma unroll
  for (int n = 0; n < H; ++n) w[n] = v[n] + sgn * v[S - 1 - n];
#pragma unroll
  for (int i = 0; i < Shape<S>::O; ++i) {
    int acc = 0;
    if constexpr (H >= 4) {
#pragma unroll
      for (int n = 0; n < H; n += 4) {
        const int4 c = *reinterpret_cast<const int4*>(cf + i * H + n);
        acc += c.x * w[n] + c.y * w[n + 1] + c.z * w[n + 2] + c.w * w[n + 3];
      }
    } else {
      const int2 c = *reinterpret_cast<const int2*>(cf + i * H);
      acc = c.x * w[0] + c.y * w[1];
    }
    out[i] = acc;
  }
}

// Inverse part: for the part's columns n_i = q*M + i, x[n_i] = ev + od
// (lo[i]) and x[S-1-n_i] = ev - od (hi[i]), where ev and od sum C[k][n_i]
// v[k] over the even and the odd k.
template <int S>
__device__ __forceinline__ void inv_part(const int* v, const int* ci,
                                         int* lo, int* hi) {
#pragma unroll
  for (int i = 0; i < Shape<S>::M; ++i) {
    int ev = 0, od = 0;
#pragma unroll
    for (int k = 0; k < S; k += 4) {
      const int4 c = *reinterpret_cast<const int4*>(ci + i * S + k);
      ev += c.x * v[k] + c.z * v[k + 2];
      od += c.y * v[k + 1] + c.w * v[k + 3];
    }
    lo[i] = ev + od;
    hi[i] = ev - od;
  }
}

// DST-VII parts of a lane of a 4x4 block, in fwd_part's and inv_part's
// roles: forward, out[i] = sum_n D[k_i][n] v[n] for the part's outputs
// k_i = fwd_out<4>(q, i); inverse, lo = sum_k D[k][q] v[k] (column q)
// and hi = sum_k D[k][3 - q] v[k] (its mirror).  The DST has no even-odd
// symmetry, so each output is a full 4-term sum.
__device__ __forceinline__ void dst_fwd_part(const int* v, int q, int* out) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int k = 2 * i + q;
    out[i] = kDst4[k][0] * v[0] + kDst4[k][1] * v[1] + kDst4[k][2] * v[2] +
             kDst4[k][3] * v[3];
  }
}

__device__ __forceinline__ void dst_inv_part(const int* v, int q, int* lo,
                                             int* hi) {
  lo[0] = kDst4[0][q] * v[0] + kDst4[1][q] * v[1] + kDst4[2][q] * v[2] +
          kDst4[3][q] * v[3];
  hi[0] = kDst4[0][3 - q] * v[0] + kDst4[1][3 - q] * v[1] +
          kDst4[2][3 - q] * v[2] + kDst4[3][3 - q] * v[3];
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

// Copies the S x S samples of SB bytes each of a block (origin off, row
// stride w) of a plane into dst (rows of S samples), with the L lanes of
// a group, in copies of at most 16 bytes.
template <int S, int SB>
__device__ __forceinline__ void copy_block(void* dst, const void* plane,
                                           size_t off, int w, int lane) {
  constexpr int L = Shape<S>::L;
  constexpr int B = SB * S < 16 ? SB * S : 16, CPR = SB * S / B;
  for (int c = lane; c < S * CPR; c += L) {
    const int r = c / CPR, k = c % CPR;
    cp_async<B>(static_cast<uint8_t*>(dst) + SB * r * S + B * k,
                static_cast<const uint8_t*>(plane) +
                    SB * (off + (size_t)r * w) + B * k);
  }
}

// Stages a block of a plane: int16 samples at HBD, else uint8 or int32
// (bytes).  The sample type is fixed per instance, so that the 8-bit
// instances keep their code (and registers) as they were.
template <int S, bool HBD>
__device__ __forceinline__ void stage_block(void* dst, const void* plane,
                                            int bytes, size_t off, int w,
                                            int lane) {
  if constexpr (HBD)
    copy_block<S, 2>(dst, plane, off, w, lane);
  else if (bytes == 4)
    copy_block<S, 4>(dst, plane, off, w, lane);
  else
    copy_block<S, 1>(dst, plane, off, w, lane);
}

// Sample (y, x) of a staged block: int16 samples at HBD, else uint8 or
// int32 (bytes).
template <int S, bool HBD>
__device__ __forceinline__ int staged(const int* buf, int bytes, int y,
                                      int x) {
  if constexpr (HBD)
    return reinterpret_cast<const int16_t*>(buf)[y * S + x];
  else
    return bytes == 1 ? reinterpret_cast<const uint8_t*>(buf)[y * S + x]
                      : buf[y * S + x];
}

// float32 a + lam * b rounded once, as the plain version forms it (the
// product of two floats is exact in double): the transform-skip
// decision's cost.
__device__ __forceinline__ float fma_like(float a, float lam, float b) {
  return __double2float_rn(
      __dadd_rn((double)a, __dmul_rn((double)lam, (double)b)));
}

// The reference's scaling-list dequantization of level lv by the
// per-position multiplier m at shift sh (Params::sl_shift), clipped to
// int16.
__device__ __forceinline__ int dequant_sl(int lv, int m, int sh) {
  const int d = sh > 0 ? (lv * m + (1 << (sh - 1))) >> sh
                       : clamp_int(lv * m, -32768, 32767) << -sh;
  return clamp_int(d, -32768, 32767);
}

// RDOQ or the flat quantizer, then sign hiding, of a lane's coefficients
// out[] (row y, columns fwd_out(q, i)) in a TQ instance: leaves the final
// levels in la (row stride S + 1).  best_c (the block's staged source,
// consumed by the residual; at least S * S words) takes each
// coefficient's best cost and lb (stride S + 1) its zeroed cost; one lane
// per 4x4 group then zeroes groups (RDOQ) and fixes parities (sign
// hiding).  sync is the group's barrier.  SL: the scale and multiplier
// come per position from the block's scaling-list tables slt (its intra
// or inter half) and dequantize at shift sl_sh (dequant_sl).
template <int S, bool HBD, bool SL, typename Sync>
__device__ __forceinline__ void quantize_tools(
    const Params& p, int dq_shift, int* la, int* lb, float* best_c,
    const int* out, int y, int q, int lane, bool luma, bool inter, int mode,
    int q_scale, int q_bits, int q_offset, int dq_mult,
    [[maybe_unused]] const int32_t* slt, [[maybe_unused]] int sl_sh,
    Sync sync) {
  using Sh = Shape<S>;
  constexpr int O = Sh::O, L = Sh::L, LOG2S = Sh::LOG2, SP = S + 1;
  float* zero_c = reinterpret_cast<float*>(lb);
  constexpr float kInvGain =
      1.0f / (float)(1 << (2 * (15 - Depth<HBD>::BITS - LOG2S)));
  auto dist = [&](int lv, int mag, int dm) -> float {
    int d;
    if constexpr (SL)
      d = dequant_sl(lv, dm, sl_sh);
    else
      d = clamp_int((lv * dm + (1 << (dq_shift - 1))) >> dq_shift, -32768,
                    32767);
    const float e = __int2float_rn(d - mag);
    return __fmul_rn(__fmul_rn(e, e), kInvGain);
  };
  auto rate = [&](int lv) -> float {
    return lv > 0 ? __fadd_rn(lv > 1 ? 4.0f : 3.0f, p.rem_bits[lv]) : 0.15f;
  };
  // SL: the lane's scales and multipliers, loaded together before use.
  [[maybe_unused]] int qsv[O], dmv[O];
  if constexpr (SL) {
#pragma unroll
    for (int i = 0; i < O; ++i) {
      const int l = fwd_out<S>(q, i);
      qsv[i] = __ldg(slt + l * S + y);
      dmv[i] = __ldg(slt + 2 * S * S + l * S + y);
    }
  }
#pragma unroll
  for (int i = 0; i < O; ++i) {
    const int l = fwd_out<S>(q, i);
    const int c = round_shift(out[i], LOG2S + 6);
    const int mag = c < 0 ? -c : c;
    int qs = q_scale, dm = dq_mult;
    if constexpr (SL) {
      qs = qsv[i];
      dm = dmv[i];
    }
    int lv;
    if (p.rdoq) {
      // Candidates 0, max(l1 - 1, 0) and l1, l1 the round-half level;
      // the first of the cheapest.
      const int l1 = min((mag * qs + (1 << (q_bits - 1))) >> q_bits, 32767);
      const int l0 = l1 > 0 ? l1 - 1 : 0;
      const float d0 = dist(0, mag, dm);
      float best = __fadd_rn(d0, p.zero_cost);
      lv = 0;
      // lambda * rate rounded on its own, then added (the JAX
      // package's fixed-grid programs: F2 in ROADMAP.md).
      const float c1 =
          __fadd_rn(dist(l0, mag, dm), __fmul_rn(rate(l0), p.lam));
      if (c1 < best) {
        best = c1;
        lv = l0;
      }
      const float c2 =
          __fadd_rn(dist(l1, mag, dm), __fmul_rn(rate(l1), p.lam));
      if (c2 < best) {
        best = c2;
        lv = l1;
      }
      best_c[y * S + l] = best;
      zero_c[y * SP + l] = d0;
    } else {
      lv = min((mag * qs + q_offset) >> q_bits, 32767);
    }
    la[y * SP + l] = c < 0 ? -lv : lv;
  }
  sync();
  // scanIdx of the block (7.4.9.11): the plane's mode for intra blocks of
  // luma S <= 8 and chroma S = 4.
  int sidx = 0;
  if (!inter && (luma ? S <= 8 : S == 4))
    sidx = mode >= 6 && mode <= 14 ? 2 : (mode >= 22 && mode <= 30);
  constexpr int NSB = S / 4;
  for (int gi = lane; gi < NSB * NSB; gi += L) {
    const int gy = gi / NSB, gx = gi - gy * NSB;
    int* gl = la + 4 * gy * SP + 4 * gx;
    if (p.rdoq) {
      // Group sums in the plain version's orders (ops/quant.py): the
      // kept costs row after row, each row's 4 columns reduced as
      // ((sum + c0) + c2) + (c1 + c3); the zeroed ones each row left to
      // right, then (row 0 + row 2) + (row 1 + row 3).
      float keep = 0.0f, zr[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float* b = best_c + (4 * gy + r) * S + 4 * gx;
        const float* z = zero_c + (4 * gy + r) * SP + 4 * gx;
        keep = __fadd_rn(__fadd_rn(r ? __fadd_rn(keep, b[0]) : b[0], b[2]),
                         __fadd_rn(b[1], b[3]));
        zr[r] = __fadd_rn(__fadd_rn(__fadd_rn(z[0], z[1]), z[2]), z[3]);
      }
      const float zero =
          __fadd_rn(__fadd_rn(zr[0], zr[2]), __fadd_rn(zr[1], zr[3]));
      if (zero < __fadd_rn(keep, p.lam)) {
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int k = 0; k < 4; ++k) gl[r * SP + k] = 0;
      }
    }
    if (p.signhide) {
      // The first nonzero coefficient in scan order grows by one in
      // magnitude where the group's parity disagrees with its sign and
      // its first and last nonzero are more than 3 apart.
      int first = 16, last = -1, sum = 0, fv = 0, fat = 0;
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int v = gl[r * SP + k];
          if (v != 0) {
            const int pos = kScan4Pos[sidx][r * 4 + k];
            if (pos < first) {
              first = pos;
              fv = v;
              fat = r * SP + k;
            }
            last = pos > last ? pos : last;
            sum += v < 0 ? -v : v;
          }
        }
      if (last - first > 3 && (sum & 1) != (fv < 0))
        gl[fat] += fv < 0 ? -1 : 1;
    }
  }
  sync();
}

// One tile of one plane item (one frame of one plane kind) in thread
// block order; QP: the planes carry per-block QP maps (a separate
// instance, so that the scalar path keeps its registers); HBD: 10-bit
// samples; LL: lossless (transquant bypass); TILED: a tile of a tiled
// plan; TQ: RDOQ and sign hiding as run-time flags (never with LL);
// NXN: the intra-NxN point's luma (the cu 4 instances: S = 4 with the
// DST-VII, and the transform-skip decision as a run-time flag).  The
// edge ring holds the tile's own columns (ring column x -
// tile_x0, tile_x0 the tile's first sample column) of K block rows (ring
// row by mod K; K is the tile's depth, which only differences of rows
// decide).  SL: the plane's scaling-list tables sl_tab ((4, S, S), see
// Params::sl_tab) and dequantizer shift sl_sh replace the flat scale and
// multiplier (never with QP or LL).
template <int S, bool QP, bool HBD, bool LL, bool TILED, bool TQ, bool NXN,
          bool SL>
__device__ void run_plane(const Params& p, const KttPlane& pl, int item,
                          int tile_x0, unsigned char* smem,
                          [[maybe_unused]] const int32_t* sl_tab,
                          [[maybe_unused]] int sl_sh) {
  static_assert(!NXN || (S == 4 && !QP && !TILED), "NxN: S = 4 alone");
  static_assert(!SL || (!QP && !LL), "SL: neither QP maps nor lossless");
  using Sh = Shape<S>;
  using D = Depth<HBD>;
  using Pix = typename D::Pix;
  constexpr int L = Sh::L, O = Sh::O, M = Sh::M, LOG2S = Sh::LOG2;
  constexpr int R = 4 * S + 1, RP = 4 * S + 2, SP = S + 1;
  constexpr int kMid = D::MID, kMaxV = D::MAXV;
  constexpr int BW = block_words<S>(D::SB);
  // Groups past the last slot find no block in any step and only join
  // the step barriers.
  const int groups = min((int)blockDim.x / L, p.n_slots);
  const int g = threadIdx.x / L;
  const int lane = threadIdx.x % L, y = lane % S, q = lane / S;
  const unsigned mask =
      L >= 32 ? 0xffffffffu
              : ((1u << (L & 31)) - 1) << ((threadIdx.x & 31) & ~(L - 1));
  // Barrier of the group's lanes: its warp, or at L = 64 named barrier
  // g + 1 (0 is __syncthreads; at most 8 groups of 64).
  auto group_sync = [&]() {
    if constexpr (L > 32)
      asm volatile("bar.sync %0, %1;\n" ::"r"(g + 1), "n"(Shape<S>::L)
                   : "memory");
    else
      __syncwarp(mask);
  };

  const uint32_t* entries =
      p.entries + (size_t)blockIdx.x * (TILED ? p.tile_blocks : p.nblk);
  const int* steps = reinterpret_cast<const int*>(smem);
  Pix* hrow = reinterpret_cast<Pix*>(smem + p.off_ring);
  // Under tiles the ring's base shifts by the tile's first column, so
  // that blocks index it by their plane column.
  if constexpr (TILED) hrow -= tile_x0;
  Pix* vcol = hrow + p.ring * p.ring_w;
  const int* coef = reinterpret_cast<const int*>(smem + p.off_coef);
  const int* cf = coef + q * O * (S / 2);
  const int* ci = coef + Sh::P * O * (S / 2) + q * M * S;
  int* stage = reinterpret_cast<int*>(smem + p.off_groups) +
               g * group_words<S>(D::SB);
  int* ref = stage + 4 * BW;
  int* flt = ref + RP;
  int* mref = flt + RP;  // mref[S + k], k = -S..2S+1
  int* buf_a = mref + 3 * S + 2;
  int* buf_b = buf_a + S * SP;

  const size_t plane = (size_t)pl.h * pl.w;
  const void* orig = static_cast<const uint8_t*>(pl.orig) +
                     item * plane * pl.orig_bytes;
  const void* mc = pl.mc ? static_cast<const uint8_t*>(pl.mc) +
                               item * plane * pl.mc_bytes
                         : nullptr;
  Pix* rec = static_cast<Pix*>(pl.rec) + item * plane;
  int16_t* levels = pl.levels + (size_t)item * p.nblk * S * S;
  const int w = pl.w, ring = p.ring, ring_w = p.ring_w;
  const bool luma = pl.luma != 0;
  // The luma boundary fixups (DC, modes 10 and 26), which implicit RDPCM
  // turns off.
  const bool fixups = luma && !(LL && p.rdpcm);
  constexpr int shift1 = LOG2S + D::BITS - 9;
  const int sgn = 1 - 2 * (q & 1);
  const uint32_t m_bx = reciprocal(p.blocks_x), m_ring = reciprocal(ring);
  [[maybe_unused]] const int32_t* qp_row =
      QP ? pl.qp + (size_t)(item % p.bm) * p.nblk : nullptr;

  // Starts the copies of the source (and, for an inter block, the MC)
  // samples of the block of packed word e into buffer buf; the caller
  // commits them as one group.
  auto prefetch = [&](uint32_t e, int buf) {
    const int bid = e & kPosMask;
    const int by = div_by(bid, p.blocks_x, m_bx);
    const size_t off = ((size_t)by * w + bid - by * p.blocks_x) * S;
    int* dst = stage + buf * 2 * BW;
    stage_block<S, HBD>(dst, orig, pl.orig_bytes, off, w, lane);
    if (mc != nullptr && ((e >> kInterBit) & 1))
      stage_block<S, HBD>(dst + BW, mc, pl.mc_bytes, off, w, lane);
  };

  auto process = [&](uint32_t e, const int* src) {
    const int bid = e & kPosMask;
    const unsigned avail = (e >> kAvailShift) & 31;
    const int mode = (e >> kModeShift) & 63;
    const bool inter = (e >> kInterBit) & 1;
    const int by = div_by(bid, p.blocks_x, m_bx), bx = bid - by * p.blocks_x;
    const int x0 = bx * S, y0 = by * S;
    const int rc = by - div_by(by, ring, m_ring) * ring;
    // The block's quantizer: the plane's, or from its own QP (qbits =
    // 14 + QP / 6 + 15 - bitdepth - log2 S; no QpBdOffset, as in the JAX
    // package's quant_params).  The load has no use before
    // the quantization, so its latency hides behind the prediction and
    // the forward transform.
    int q_scale = pl.q_scale, q_bits = pl.q_bits, dq_mult = pl.dq_mult;
    int q_offset = inter ? pl.q_offset_inter : pl.q_offset;
    if constexpr (SL) {
      // The block's scaling-list table lines into L1 ahead of the
      // quantization, behind the prediction and the forward transform.
      const int32_t* t = sl_tab + (inter ? S * S : 0);
#pragma unroll
      for (int i = 0; i < O; ++i) {
        const int32_t* at = t + fwd_out<S>(q, i) * S + y;
        asm volatile("prefetch.global.L1 [%0];" ::"l"(at));
        asm volatile("prefetch.global.L1 [%0];" ::"l"(at + 2 * S * S));
      }
    }
    if constexpr (QP) {
      const int qp = qp_row[bid], per = qp / 6, rem = qp - 6 * per;
      q_scale = kQuantScale[rem];
      q_bits = 29 - D::BITS - LOG2S + per;
      q_offset = (inter ? 85 : 171) << (q_bits - 9);
      dq_mult = kInvQuantScale[rem] << per;
    }

    int pred[O];
    if (inter) {
#pragma unroll
      for (int i = 0; i < O; ++i)
        pred[i] =
            staged<S, HBD>(src + BW, pl.mc_bytes, y, owned_col<S>(q, i));
    } else {
      const int ra = rc == 0 ? ring - 1 : rc - 1;
      const int rb = rc + 1 == ring ? 0 : rc + 1;
      // Sample i of the reference vector from the edge ring.
      auto read_ref = [&](int i) -> int {
        if (i < 2 * S) {
          const int dy = 2 * S - 1 - i;
          return vcol[(dy < S ? rc : rb) * ring_w + (bx - 1) * S +
                      (dy & (S - 1))];
        }
        return hrow[ra * ring_w + x0 + i - 2 * S - 1];
      };
      // 8.4.4.2.2 substitution at region granularity (availability is
      // whole region on a uniform CU grid): an unavailable region takes
      // the last sample of the nearest available region before it, or,
      // with none before, the first sample of the first available
      // region after it; with none available every sample is mid-grey.
      for (int i = lane; i < R; i += L) {
        const int r = ref_region<S>(i);
        int src_i = i;
        if (!((avail >> r) & 1)) {
          const unsigned below = avail & ((1u << r) - 1);
          const unsigned above = avail & (31u << (r + 1)) & 31u;
          src_i = below ? region_last<S>(31 - __clz(below))
                        : (above ? region_first<S>(__ffs(above) - 1) : -1);
        }
        ref[i] = src_i < 0 ? kMid : read_ref(src_i);
      }
      group_sync();
      const int* pp = ref;
      if (luma && filter_flag<S>(mode)) {
        for (int i = lane; i < R; i += L)
          flt[i] = (i > 0 && i < R - 1)
                       ? (ref[i - 1] + 2 * ref[i] + ref[i + 1] + 2) >> 2
                       : ref[i];
        group_sync();
        pp = flt;
      }
#define LEFT(arr, yy) (arr)[2 * S - 1 - (yy)]
#define TOP(arr, xx) (arr)[2 * S + 1 + (xx)]
      if (mode == 0) {  // planar (8.4.4.2.5)
        const int left = LEFT(pp, y), top_r = TOP(pp, S), left_b = LEFT(pp, S);
#pragma unroll
        for (int i = 0; i < O; ++i) {
          const int x = owned_col<S>(q, i);
          pred[i] = ((S - 1 - x) * left + (x + 1) * top_r +
                     (S - 1 - y) * TOP(pp, x) + (y + 1) * left_b + S) >>
                    (LOG2S + 1);
        }
      } else if (mode == 1) {  // DC, with the luma boundary fixups (S < 32)
        int sum = S;
#pragma unroll
        for (int k = 0; k < S; ++k) sum += TOP(pp, k) + LEFT(pp, k);
        const int dc = sum >> (LOG2S + 1);
#pragma unroll
        for (int i = 0; i < O; ++i) {
          const int x = owned_col<S>(q, i);
          int v = dc;
          if (fixups && S < 32 && y == 0)
            v = x == 0 ? (LEFT(ref, 0) + 2 * dc + TOP(ref, 0) + 2) >> 2
                       : (TOP(ref, x) + 3 * dc + 2) >> 2;
          else if (fixups && S < 32 && x == 0)
            v = (LEFT(ref, y) + 3 * dc + 2) >> 2;
          pred[i] = v;
        }
      } else {  // angular (8.4.4.2.6)
        const int angle = kAngle[mode - 2];
        const bool vertical = mode >= 18;
        const int side = vertical ? 1 : -1;
        // Extended main reference mref[S + k]: k >= 0 the main side
        // (top row for vertical modes, left column for horizontal ones,
        // k = 0 the corner); k < 0 projected from the other side through
        // invAngle.  Entries no sample reads stay 0.
        const int k_min = angle < 0 ? (S * angle) >> 5 : 0;
        for (int k = lane - S; k <= 2 * S + 1; k += L) {
          int v = 0;
          if (k >= 0) {
            const int at = 2 * S + side * k;
            if (at >= 0 && at <= 4 * S) v = pp[at];
          } else if (k >= k_min) {
            v = pp[2 * S - side * ((k * kInvAngle[mode - 11] + 128) >> 8)];
          }
          mref[S + k] = v;
        }
        group_sync();
        const int corner = ref[2 * S];
#pragma unroll
        for (int i = 0; i < O; ++i) {
          const int x = owned_col<S>(q, i);
          const int ta = (vertical ? y + 1 : x + 1) * angle;
          const int at = S + (vertical ? x : y) + (ta >> 5) + 1;
          const int f = ta & 31;
          int v = ((32 - f) * mref[at] + f * mref[at + 1] + 16) >> 5;
          if (fixups && S < 32 && mode == 10 && y == 0)
            v = clamp_int(LEFT(ref, 0) + ((TOP(ref, x) - corner) >> 1), 0,
                          kMaxV);
          if (fixups && S < 32 && mode == 26 && x == 0)
            v = clamp_int(TOP(ref, 0) + ((LEFT(ref, y) - corner) >> 1), 0,
                          kMaxV);
          pred[i] = v;
        }
      }
#undef LEFT
#undef TOP
    }

    int px[O];
    if constexpr (LL) {
      // Transquant bypass: the residual, or its DPCM along the mode's
      // direction, is the level array; the reconstruction is the source.
      // The residual goes through buf_a, where each lane reads its left
      // (mode 10) or upper (mode 26) neighbour.
      int res[O];
#pragma unroll
      for (int i = 0; i < O; ++i) {
        px[i] = staged<S, HBD>(src, pl.orig_bytes, y, owned_col<S>(q, i));
        res[i] = px[i] - pred[i];
        buf_a[y * SP + owned_col<S>(q, i)] = res[i];
      }
      const int dpcm = p.rdpcm && !inter ? mode : -1;
      group_sync();
      int16_t* lv_row = levels + ((size_t)bid * S + y) * S;
#pragma unroll
      for (int i = 0; i < O; ++i) {
        const int x = owned_col<S>(q, i);
        int lv = res[i];
        if (dpcm == 10 && x > 0) lv -= buf_a[y * SP + x - 1];
        if (dpcm == 26 && y > 0) lv -= buf_a[(y - 1) * SP + x];
        lv_row[x] = (int16_t)lv;
      }
    } else {
      int v[S], out[O];
      // Residual; forward stage 1 (columns): E[k][m] = sum_n T[k][n]
      // X[n][m], lane (m, q) computing the part's k.
#pragma unroll
      for (int i = 0; i < O; ++i)
        buf_a[y * SP + owned_col<S>(q, i)] =
            staged<S, HBD>(src, pl.orig_bytes, y, owned_col<S>(q, i)) -
            pred[i];
      group_sync();
#pragma unroll
      for (int n = 0; n < S; ++n) v[n] = buf_a[n * SP + y];
      // The transform-skip candidate's residual at the lane's coefficient
      // positions (row y, columns fwd_out(q, i)).
      [[maybe_unused]] int rs[O];
      if constexpr (NXN) {
#pragma unroll
        for (int i = 0; i < O; ++i) rs[i] = buf_a[y * SP + fwd_out<S>(q, i)];
        dst_fwd_part(v, q, out);
      } else {
        fwd_part<S>(v, cf, sgn, out);
      }
#pragma unroll
      for (int i = 0; i < O; ++i)
        buf_b[fwd_out<S>(q, i) * SP + y] = round_shift(out[i], shift1);
      // Forward stage 2 (rows): C[k][l] = sum_m T[l][m] E[k][m], lane
      // (k, q); flat quantization and dequantization.
      group_sync();
#pragma unroll
      for (int m = 0; m < S; ++m) v[m] = buf_b[y * SP + m];
      // The TQ instances keep the zeroed costs in buf_b: its row peers
      // must have read it first.
      if constexpr (TQ) group_sync();
      if constexpr (NXN)
        dst_fwd_part(v, q, out);
      else
        fwd_part<S>(v, cf, sgn, out);
      int16_t* lv_row = levels + ((size_t)bid * S + y) * S;
      // The block's scaling-list tables: its intra or inter half.
      [[maybe_unused]] const int32_t* slt = nullptr;
      if constexpr (SL) slt = sl_tab + (inter ? S * S : 0);
      // Quantization of the lane's coefficients out[] (round_shift(out,
      // log2 S + 6) each) into lvq[], their dequantized values into
      // buf_a, and the levels into lv_row.
      int lvq[O];
      auto quantize_lane = [&]() {
        if constexpr (TQ) {
          quantize_tools<S, HBD, SL>(
              p, pl.dq_shift, buf_a, buf_b,
              reinterpret_cast<float*>(const_cast<int*>(src)), out, y, q,
              lane, luma, inter, mode, q_scale, q_bits, q_offset, dq_mult,
              slt, sl_sh, group_sync);
#pragma unroll
          for (int i = 0; i < O; ++i) lvq[i] = buf_a[y * SP + fwd_out<S>(q, i)];
        } else if constexpr (SL) {
          // The lane's scales, then its multipliers, each loaded together
          // (a load between global stores waited for them).
          int tv[O];
#pragma unroll
          for (int i = 0; i < O; ++i)
            tv[i] = __ldg(slt + fwd_out<S>(q, i) * S + y);
#pragma unroll
          for (int i = 0; i < O; ++i) {
            const int c = round_shift(out[i], LOG2S + 6);
            const int mag = c < 0 ? -c : c;
            const int lv = min((mag * tv[i] + q_offset) >> q_bits, 32767);
            lvq[i] = c < 0 ? -lv : lv;
          }
#pragma unroll
          for (int i = 0; i < O; ++i)
            tv[i] = __ldg(slt + 2 * S * S + fwd_out<S>(q, i) * S + y);
#pragma unroll
          for (int i = 0; i < O; ++i) {
            const int l = fwd_out<S>(q, i);
            lv_row[l] = (int16_t)lvq[i];
            buf_a[y * SP + l] = dequant_sl(lvq[i], tv[i], sl_sh);
          }
          return;
        } else {
#pragma unroll
          for (int i = 0; i < O; ++i) {
            const int c = round_shift(out[i], LOG2S + 6);
            const int mag = c < 0 ? -c : c;
            int lv = (mag * q_scale + q_offset) >> q_bits;
            lv = lv > 32767 ? 32767 : lv;
            lvq[i] = c < 0 ? -lv : lv;
          }
        }
#pragma unroll
        for (int i = 0; i < O; ++i) {
          const int l = fwd_out<S>(q, i);
          lv_row[l] = (int16_t)lvq[i];
          if constexpr (SL)
            buf_a[y * SP + l] = dequant_sl(
                lvq[i], __ldg(slt + 2 * S * S + l * S + y), sl_sh);
          else
            buf_a[y * SP + l] = clamp_int(
                (lvq[i] * dq_mult + (1 << (pl.dq_shift - 1))) >> pl.dq_shift,
                -32768, 32767);
        }
      };
      quantize_lane();
      // Inverse stage 1 (columns): E[n][m] = sum_k T[k][n] D[k][m],
      // clipped, lane (m, q) computing n = q*M.. and their mirrors.
      group_sync();
      int lo[M], hi[M];
#pragma unroll
      for (int k = 0; k < S; ++k) v[k] = buf_a[k * SP + y];
      if constexpr (NXN)
        dst_inv_part(v, q, lo, hi);
      else
        inv_part<S>(v, ci, lo, hi);
#pragma unroll
      for (int i = 0; i < M; ++i) {
        buf_b[(q * M + i) * SP + y] =
            clamp_int(round_shift(lo[i], 7), -32768, 32767);
        buf_b[(S - 1 - q * M - i) * SP + y] =
            clamp_int(round_shift(hi[i], 7), -32768, 32767);
      }
      // Inverse stage 2 (rows): r[n][l] = sum_m T[m][l] E[n][m], lane
      // (n, q) computing its own columns; reconstruct.
      group_sync();
#pragma unroll
      for (int m = 0; m < S; ++m) v[m] = buf_b[y * SP + m];
      if constexpr (NXN)
        dst_inv_part(v, q, lo, hi);
      else
        inv_part<S>(v, ci, lo, hi);
      constexpr int shift2 = 20 - D::BITS;
#pragma unroll
      for (int i = 0; i < M; ++i) {
        px[i] = clamp_int(pred[i] + clamp_int(round_shift(lo[i], shift2),
                                              -32768, 32767), 0, kMaxV);
        px[M + i] = clamp_int(
            pred[M + i] + clamp_int(round_shift(hi[i], shift2), -32768, 32767),
            0, kMaxV);
      }
      if constexpr (NXN && !SL) {
        if (p.tskip) {
          // Transform skip (8.6.4.2): the coefficients are the residual
          // << (15 - bitdepth - 2), through the same quantizer (out[]
          // carries them << 8, which round_shift(., 8) undoes exactly),
          // the reconstruction ((dq << 7) + rnd) >> (20 - bitdepth).
          // The cheaper candidate by ssd + lambda * bits stays, ties to
          // the transform, each cost rounded as the plain version's
          // (encoder/intra_recon.tskip_cost).
          int lvt[O], pxt[O];
#pragma unroll
          for (int i = 0; i < O; ++i) {
            lvt[i] = lvq[i];
            pxt[i] = px[i];
            out[i] = rs[i] << (21 - D::BITS);
          }
          group_sync();
          quantize_lane();
          group_sync();
          constexpr int sh_i = 20 - D::BITS;
#pragma unroll
          for (int i = 0; i < O; ++i)
            px[i] = clamp_int(
                pred[i] + (((buf_a[y * SP + owned_col<S>(q, i)] << 7) +
                            (1 << (sh_i - 1))) >> sh_i),
                0, kMaxV);
          // Per lane: both candidates' SSD over its own columns, and the
          // rate terms of its levels (row y, columns q and q + 2).
          int ssd_t = 0, ssd_s = 0;
          float bt[O], bs[O];
#pragma unroll
          for (int i = 0; i < O; ++i) {
            const int o = staged<S, HBD>(src, pl.orig_bytes, y,
                                         owned_col<S>(q, i));
            ssd_t += (pxt[i] - o) * (pxt[i] - o);
            ssd_s += (px[i] - o) * (px[i] - o);
            bt[i] = __ldg(p.tskip_bits + (lvt[i] < 0 ? -lvt[i] : lvt[i]));
            bs[i] = __ldg(p.tskip_bits + (lvq[i] < 0 ? -lvq[i] : lvq[i]));
          }
#pragma unroll
          for (int off = 4; off > 0; off >>= 1) {
            ssd_t += __shfl_xor_sync(mask, ssd_t, off, 8);
            ssd_s += __shfl_xor_sync(mask, ssd_s, off, 8);
          }
          // Bits in the plain version's order: each row left to right
          // (the partner lane, q ^ 1, holds columns 1 and 3), then (row 0
          // + row 2) + (row 1 + row 3), plus 1.
          auto bits = [&](const float* b) -> float {
            const float c1 = __shfl_xor_sync(mask, b[0], 4, 8);
            const float c3 = __shfl_xor_sync(mask, b[1], 4, 8);
            float r = __fadd_rn(__fadd_rn(__fadd_rn(b[0], c1), b[1]), c3);
            r = __fadd_rn(r, __shfl_xor_sync(mask, r, 2, 8));
            r = __fadd_rn(r, __shfl_xor_sync(mask, r, 1, 8));
            return __fadd_rn(__shfl_sync(mask, r, 0, 8), 1.0f);
          };
          const float cost_t =
              fma_like(__int2float_rn(ssd_t), p.lam, bits(bt));
          const float cost_s =
              fma_like(__int2float_rn(ssd_s), p.lam, bits(bs));
          const bool skip = cost_s < cost_t;
          if (!skip) {
#pragma unroll
            for (int i = 0; i < O; ++i) {
              lv_row[fwd_out<S>(q, i)] = (int16_t)lvt[i];
              px[i] = pxt[i];
            }
          }
          if (lane == 0)
            p.skip_out[(size_t)item * p.nblk + bid] = skip ? 1 : 0;
        }
      }
    }
    Pix* rec_row = rec + (size_t)(y0 + y) * w + x0;
    Pix* edge_row = hrow + rc * ring_w + x0;
    const int a = q * M, b = S - q * M - M;  // the two column runs
    if constexpr (!HBD && M % 4 == 0) {
#pragma unroll
      for (int t = 0; t < M; t += 4) {
        const uint32_t wa = px[t] | px[t + 1] << 8 | px[t + 2] << 16 |
                            px[t + 3] << 24;
        const uint32_t wb = px[2 * M - 1 - t] | px[2 * M - 2 - t] << 8 |
                            px[2 * M - 3 - t] << 16 | px[2 * M - 4 - t] << 24;
        *reinterpret_cast<uint32_t*>(rec_row + a + t) = wa;
        *reinterpret_cast<uint32_t*>(rec_row + b + t) = wb;
        if (y == S - 1) {
          *reinterpret_cast<uint32_t*>(edge_row + a + t) = wa;
          *reinterpret_cast<uint32_t*>(edge_row + b + t) = wb;
        }
      }
    } else {
#pragma unroll
      for (int t = 0; t < M; ++t) {
        rec_row[a + t] = (Pix)px[t];
        rec_row[b + t] = (Pix)px[2 * M - 1 - t];
        if (y == S - 1) {
          edge_row[a + t] = (Pix)px[t];
          edge_row[b + t] = (Pix)px[2 * M - 1 - t];
        }
      }
    }
    // Column S-1 is lane part 0's first mirrored sample.
    if (q == 0) vcol[rc * ring_w + x0 + y] = (Pix)px[M];
  };

  // Thread-block-wide step loop.  Each group's first block of step t + 1
  // is copied into the other half of its double buffer while step t
  // runs (one copy group committed per step, empty when there is no
  // block, so that waiting for all but the newest group finds the
  // current block's copies done), and the packed word of its first
  // block of step t + 2 is loaded; a step with more blocks than groups
  // loads and copies the rest in turn.
  const bool active = g < groups;
  // Packed word of group g's first block of step t, 0 for none.
  auto first_of = [&](int t) -> uint32_t {
    return active && t < p.n_steps && g < steps[t + 1] - steps[t]
               ? entries[steps[t] + g]
               : 0u;
  };
  uint32_t cur = first_of(0), nxt = first_of(1);
  if (active && g < steps[1] - steps[0]) prefetch(cur, 0);
  cp_async_commit();
  for (int step = 0; step < p.n_steps; ++step) {
    const int start = steps[step], n = steps[step + 1] - start;
    const int buf = step & 1;
    const uint32_t after = first_of(step + 2);
    if (active) {
      if (step + 1 < p.n_steps && g < steps[step + 2] - steps[step + 1])
        prefetch(nxt, buf ^ 1);
      cp_async_commit();
      for (int slot = g; slot < n; slot += groups) {
        uint32_t e = cur;
        if (slot == g) {
          cp_async_wait<1>();
        } else {
          e = entries[start + slot];
          prefetch(e, buf);
          cp_async_commit();
          cp_async_wait<0>();
        }
        group_sync();
        process(e, stage + buf * 2 * BW);
      }
    }
    cur = nxt;
    nxt = after;
    // Ends the step: its edges are visible to the next.
    __syncthreads();
  }
  cp_async_wait<0>();
}

// Thread block bound of the kernel of CU size cu: 16 groups of 32 lanes
// at cu 16 and 8 groups of 64 at cu 32 (128 registers a thread), 32
// groups at cu 8 (whose S=8 and S=4 paths need fewer registers) and 128
// groups of 8 lanes at cu 4.
__host__ __device__ constexpr int max_threads(int cu) {
  return cu <= 8 ? 1024 : 512;
}

// Ints of the coefficient tables of block size S (fill_coefs).
template <int S>
constexpr int coef_words() {
  return Shape<S>::P * Shape<S>::O * (S / 2) + Shape<S>::P * Shape<S>::M * S;
}

constexpr long long align16(long long n) { return (n + 15) / 16 * 16; }

// Launch layout of the kernel of CU size CU at sample depth HBD: threads
// (a group of lanes per slot of the widest step, up to max_threads, whole
// warps) and dynamic shared memory in 16-byte aligned parts, in bytes:
// the step offsets (int32) at 0, the edge ring (hrow and vcol, ring rows
// of ring_w samples each), the coefficient tables of block size CU (the
// larger table) and the slot groups' buffers of whichever block size
// needs more.  bytes is -1 past INT_MAX.
struct Layout {
  int threads, off_ring, off_coef, off_groups, bytes;
};

template <int CU, bool HBD>
Layout layout_of(int n_steps, int n_slots, int ring, int ring_w) {
  // CL: the chroma block size (the cu 4 instances run luma alone).
  constexpr int CL = CU == 4 ? 4 : CU / 2;
  constexpr int L = Shape<CU>::L, LC = Shape<CL>::L, SB = Depth<HBD>::SB;
  Layout l{};
  const int groups =
      n_slots < max_threads(CU) / L ? n_slots : max_threads(CU) / L;
  l.threads = (groups * L + 31) / 32 * 32;
  const int g_lo = n_slots < l.threads / LC ? n_slots : l.threads / LC;
  const long long buffers =
      4LL * (groups * group_words<CU>(SB) > g_lo * group_words<CL>(SB)
                 ? groups * group_words<CU>(SB)
                 : g_lo * group_words<CL>(SB));
  const long long off_ring = align16(4LL * (n_steps + 1));
  const long long off_coef =
      off_ring + align16(2LL * ring * ring_w *
                         (long long)sizeof(typename Depth<HBD>::Pix));
  const long long off_groups = off_coef + 4 * coef_words<CU>();
  const long long bytes = off_groups + buffers;
  if (bytes > 0x7fffffffLL) {
    l.bytes = -1;
    return l;
  }
  l.off_ring = (int)off_ring;
  l.off_coef = (int)off_coef;
  l.off_groups = (int)off_groups;
  l.bytes = (int)bytes;
  return l;
}

template <bool HBD>
Layout layout_at(int cu, int n_steps, int n_slots, int ring, int ring_w) {
  return cu == 32   ? layout_of<32, HBD>(n_steps, n_slots, ring, ring_w)
         : cu == 16 ? layout_of<16, HBD>(n_steps, n_slots, ring, ring_w)
         : cu == 8  ? layout_of<8, HBD>(n_steps, n_slots, ring, ring_w)
                    : layout_of<4, HBD>(n_steps, n_slots, ring, ring_w);
}

Layout layout_for(int cu, bool hbd, int n_steps, int n_slots, int ring,
                  int ring_w) {
  return hbd ? layout_at<true>(cu, n_steps, n_slots, ring, ring_w)
             : layout_at<false>(cu, n_steps, n_slots, ring, ring_w);
}

// Kernel of the plans of CU size CU: planes of block size CU (luma) and
// CU / 2 (chroma), or at CU 4 (the intra-NxN point) luma alone at S = 4
// with the DST-VII; QP: the planes carry per-block QP maps; HBD: 10-bit
// samples; LL: lossless (transquant bypass, never with QP maps); TILED:
// a tiled plan, a thread block per (item, tile) (never with QP maps, which
// the configuration refuses under tiles; a separate instance, so that the
// untiled ones keep their registers: in them the tile code made ptxas
// spill).
template <int CU, bool QP, bool HBD, bool LL, bool TILED, bool TQ, bool SL>
__global__ void __launch_bounds__(max_threads(CU))
    wavefront_kernel(const Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  // Thread block = (item of all planes, tile): `all` counts the items of
  // every plane kind, t the tile.
  const int all = TILED ? blockIdx.x / p.n_tiles : blockIdx.x;
  const int t = TILED ? blockIdx.x - all * p.n_tiles : 0;
  int k = 0;
  while (k + 1 < p.n_planes && all >= p.item_end[k]) ++k;
  const int item = all - (k ? p.item_end[k - 1] : 0);
  const KttPlane& pl = p.plane[k];
  // The tile's (bx0, by0, width, height) in blocks; an untiled plan's
  // one tile is the plane.
  const int4 ta = TILED ? p.tile_info[t] : make_int4(0, 0, 0, 0);

  // Pack the schedule, modes and inter flags of this tile once, in step
  // order, into this thread block's row of the entries table.
  uint32_t* entries =
      p.entries + (size_t)blockIdx.x * (TILED ? p.tile_blocks : p.nblk);
  int* steps = reinterpret_cast<int*>(smem);
  const int row = item % p.bm;
  // Explicit chroma modes: the TQ and lossless instances (the wrapper
  // sends any other launch with them to TQ, with its tools off).
  const int32_t* modes =
      ((TQ || LL) && !pl.luma && p.cmodes != nullptr ? p.cmodes : p.modes) +
      (size_t)row * p.nblk;
  const uint8_t* inter = p.inter ? p.inter + (size_t)row * p.nblk : nullptr;
  auto pack = [&](int b) {
    const uint32_t info = p.blk_info[b];
    uint32_t e = (uint32_t)b | (info & ~kPosMask) |
                 ((uint32_t)(modes[b] & 63) << kModeShift);
    if (inter != nullptr && inter[b]) e |= 1u << kInterBit;
    entries[info & kPosMask] = e;
  };
  if constexpr (TILED) {
    for (int i = threadIdx.x; i < ta.z * ta.w; i += blockDim.x) {
      const int r = i / ta.z;
      pack((ta.y + r) * p.blocks_x + ta.x + i - r * ta.z);
    }
  } else {
    for (int b = threadIdx.x; b < p.nblk; b += blockDim.x) pack(b);
  }
  for (int i = threadIdx.x; i <= p.n_steps; i += blockDim.x)
    steps[i] = p.step_start[t * (p.n_steps + 1) + i];
  int* coef = reinterpret_cast<int*>(smem + p.off_coef);
  if constexpr (CU > 4) {
    if (pl.s == CU)
      fill_coefs<CU>(coef);
    else
      fill_coefs<CU / 2>(coef);
  }
  __syncthreads();

  const int32_t* sl_tab = SL ? p.sl_tab[k] : nullptr;
  const int sl_sh = SL ? p.sl_shift[k] : 0;
  if constexpr (CU == 4)
    run_plane<4, false, HBD, LL, false, TQ, true, SL>(p, pl, item, 0, smem,
                                                      sl_tab, sl_sh);
  else if (pl.s == CU)
    run_plane<CU, QP, HBD, LL, TILED, TQ, false, SL>(
        p, pl, item, ta.x * CU, smem, sl_tab, sl_sh);
  else
    run_plane<CU / 2, QP, HBD, LL, TILED, TQ, false, SL>(
        p, pl, item, ta.x * (CU / 2), smem, sl_tab, sl_sh);
}

// The kernel instance of CU size cu (32, 16 or 8) at 8 or 10 bits: with
// or without QP maps, or lossless; untiled or, without QP maps, tiled;
// with RDOQ / sign hiding (tq) or not, never lossless; with a scaling list
// (sl) or not, never with QP maps or lossless.  These are the
// combinations the configuration accepts.
using KernelFn = void (*)(const Params);

template <int CU, bool HBD, bool TILED, bool TQ>
KernelFn kernel_tq(bool qp, bool sl) {
  if (sl) return wavefront_kernel<CU, false, HBD, false, TILED, TQ, true>;
  if constexpr (TILED)
    return wavefront_kernel<CU, false, HBD, false, true, TQ, false>;
  else
    return qp ? wavefront_kernel<CU, true, HBD, false, false, TQ, false>
              : wavefront_kernel<CU, false, HBD, false, false, TQ, false>;
}

template <int CU, bool HBD, bool TILED>
KernelFn kernel_of(bool qp, bool ll, bool tq, bool sl) {
  if (ll) return wavefront_kernel<CU, false, HBD, true, TILED, false, false>;
  return tq ? kernel_tq<CU, HBD, TILED, true>(qp, sl)
            : kernel_tq<CU, HBD, TILED, false>(qp, sl);
}

template <bool HBD, bool TQ>
KernelFn kernel_cu4(bool ll, bool sl) {
  if (ll) return wavefront_kernel<4, false, HBD, true, false, false, false>;
  return sl ? wavefront_kernel<4, false, HBD, false, false, TQ, true>
            : wavefront_kernel<4, false, HBD, false, false, TQ, false>;
}

template <bool HBD, bool TILED>
KernelFn kernel_at(int cu, bool qp, bool ll, bool tq, bool sl) {
  // cu 4 (untiled, without QP maps): plain, TQ or lossless, with or
  // without a scaling list, each with the transform-skip flag of its
  // lossy flat instances.
  if constexpr (!TILED)
    if (cu == 4)
      return tq ? kernel_cu4<HBD, true>(ll, sl)
                : kernel_cu4<HBD, false>(ll, sl);
  return cu == 32   ? kernel_of<32, HBD, TILED>(qp, ll, tq, sl)
         : cu == 16 ? kernel_of<16, HBD, TILED>(qp, ll, tq, sl)
                    : kernel_of<8, HBD, TILED>(qp, ll, tq, sl);
}

KernelFn kernel_for(int cu, bool qp, bool hbd, bool ll, bool tiled, bool tq,
                    bool sl) {
  return tiled ? (hbd ? kernel_at<true, true>(cu, qp, ll, tq, sl)
                      : kernel_at<false, true>(cu, qp, ll, tq, sl))
               : (hbd ? kernel_at<true, false>(cu, qp, ll, tq, sl)
                      : kernel_at<false, false>(cu, qp, ll, tq, sl));
}

}  // namespace

// Threads and dynamic shared memory (bytes) of a launch of the kernel of
// CU size cu (32, 16, 8 or 4: the plan's; a chroma-only launch on a cu 8
// plan runs the cu 8 kernel) at bitdepth 8 or 10, on a plan of n_steps
// steps of at most n_slots blocks with an edge ring of `ring` rows of
// ring_w samples.  Returns a cudaError_t.
extern "C" int ktt_wavefront_layout(int cu, int bitdepth, int n_steps,
                                    int n_slots, int ring, int ring_w,
                                    int* threads, int* smem_bytes) {
  if ((cu != 4 && cu != 8 && cu != 16 && cu != 32) ||
      (bitdepth != 8 && bitdepth != 10) || n_steps < 1 || n_slots < 1 ||
      ring < 1 || ring_w < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const Layout l =
      layout_for(cu, bitdepth == 10, n_steps, n_slots, ring, ring_w);
  *threads = l.threads;
  *smem_bytes = l.bytes;
  return l.bytes < 0 ? static_cast<int>(cudaErrorInvalidValue) : 0;
}

// Launch over n_planes plane kinds (1..3): one thread block per item and
// tile, the planes' items in order, an item's tiles in a row.  tile_info
// is the device table of n_tiles tiles (Params::tile_info, 16-byte
// aligned) and tile_bw the widest tile's width in blocks; n_steps and
// n_slots are the most steps and slots of any tile, step_start has
// n_steps + 1 entries per tile.  Block sizes: the largest s is 32 (the
// others 32 or 16), 16 (the others 16 or 8) or at most 8 (the others 8
// or 4: a chroma-only launch of 4x4 blocks runs the cu 8 kernel), or one
// luma plane at s = 4 (the intra-NxN point: the cu 4 kernel, untiled,
// intra, without qp).  inter and every
// plane's mc are all null (intra variant) or all set (inter); so are the
// planes' qp, which hold values in 0..51.  lossless (transquant bypass)
// takes no qp; rdpcm (implicit RDPCM) needs lossless.  entries
// is scratch of (items x n_tiles, tile_blocks) uint32 on the device,
// tile_blocks the most blocks of any tile.  ring is the edge
// ring's depth and ring_w at least tile_bw times the largest s.  bitdepth 8
// takes uint8 or int32 orig and mc and writes uint8 rec; 10 takes int16
// orig and mc and writes 16-bit rec.  cmodes (bm, nblk) are the chroma
// planes' modes, or null for the luma modes.  rdoq and signhide (never
// with lossless) select the TQ instance; rdoq needs rem_bits (32768
// floats on the device), lam (float32) and zero_cost = float32(lam *
// 0.15f).  tskip (a cu 4 launch, neither lossless nor rdoq) decides
// transform skip per block into skip_out ((items, nblk) int32), with the
// rate terms tskip_bits (32768 floats on the device).  sl_tabs, where
// not null (a host array of n_planes pointers), selects the scaling-list
// instance: each plane's (4, S, S) int32 device tables (quantizer scale
// intra, inter, dequantizer multiplier intra, inter, each transposed:
// position (y, x) at x * S + y) at its QP % 6, with
// its dequantizer shift bitdepth + log2 S - 5 - QP / 6 in sl_shift (a
// host array); never with qp, lossless or tskip.  Returns a
// cudaError_t; a layout the device cannot give is refused by
// cudaFuncSetAttribute.
extern "C" int ktt_wavefront_recon(
    const KttPlane* planes, int n_planes, int bitdepth,
    const uint32_t* blk_info, const int32_t* step_start,
    const int32_t* modes, const uint8_t* inter, uint32_t* entries, int bm,
    int blocks_x, int nblk, int n_steps, int n_slots, int ring, int ring_w,
    int lossless, int rdpcm, const int4* tile_info, int n_tiles,
    int tile_bw, int tile_blocks, const int32_t* cmodes, int rdoq,
    int signhide, float lam, float zero_cost, const float* rem_bits,
    int tskip, int32_t* skip_out, const float* tskip_bits,
    const int32_t* const* sl_tabs, const int* sl_shift, void* stream) {
  if (n_planes < 1 || n_planes > 3 || nblk < 1 || nblk > kMaxBlocks ||
      blocks_x < 1 || (long long)nblk * blocks_x >= (1LL << 32) ||
      tile_info == nullptr || n_tiles < 1 || n_tiles > nblk ||
      tile_bw < 1 || tile_bw > blocks_x || tile_blocks < 1 ||
      tile_blocks > nblk || (n_tiles > 1 && planes[0].qp != nullptr) ||
      (n_tiles == 1 && tile_blocks != nblk) ||
      bm < 1 || n_steps < 1 || n_slots < 1 || ring < 1 || ring_w < 1 ||
      (bitdepth != 8 && bitdepth != 10) || (rdpcm && !lossless) ||
      (lossless && planes[0].qp != nullptr) ||
      (lossless && (rdoq || signhide)) || (rdoq && rem_bits == nullptr) ||
      (sl_tabs != nullptr &&
       (lossless || tskip || planes[0].qp != nullptr || sl_shift == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  const bool hbd = bitdepth == 10;
  Params p{};
  int items = 0, s_max = 0;
  const bool qp = planes[0].qp != nullptr;
  for (int i = 0; i < n_planes; ++i) {
    const KttPlane& pl = planes[i];
    const bool bytes_ok =
        hbd ? pl.orig_bytes == 2 && (pl.mc == nullptr || pl.mc_bytes == 2)
            : (pl.orig_bytes == 1 || pl.orig_bytes == 4) &&
                  (pl.mc == nullptr || pl.mc_bytes == 1 || pl.mc_bytes == 4);
    if ((pl.s != 4 && pl.s != 8 && pl.s != 16 && pl.s != 32) ||
        (inter == nullptr) != (pl.mc == nullptr) || pl.s * tile_bw > ring_w ||
        qp != (pl.qp != nullptr) || !bytes_ok)
      return static_cast<int>(cudaErrorInvalidValue);
    s_max = pl.s > s_max ? pl.s : s_max;
    if (sl_tabs != nullptr) {
      if (sl_tabs[i] == nullptr)
        return static_cast<int>(cudaErrorInvalidValue);
      p.sl_tab[i] = sl_tabs[i];
      p.sl_shift[i] = sl_shift[i];
    }
    p.plane[i] = pl;
    items += pl.nb;
    p.item_end[i] = items;
  }
  const bool nxn = s_max == 4 && planes[0].luma;
  const int cu = nxn ? 4 : (s_max > 8 ? s_max : 8);
  for (int i = 0; i < n_planes; ++i)
    if (planes[i].s != cu && planes[i].s != cu / 2)
      return static_cast<int>(cudaErrorInvalidValue);
  if ((nxn && (n_planes != 1 || qp || n_tiles > 1 || inter != nullptr)) ||
      (tskip && (!nxn || lossless || rdoq || skip_out == nullptr ||
                 tskip_bits == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  const Layout l = layout_for(cu, hbd, n_steps, n_slots, ring, ring_w);
  if (l.bytes < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (items == 0) return 0;
  if ((long long)items * n_tiles > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  p.n_planes = n_planes;
  p.blk_info = blk_info;
  p.step_start = step_start;
  p.modes = modes;
  p.inter = inter;
  p.entries = entries;
  p.bm = bm;
  p.blocks_x = blocks_x;
  p.nblk = nblk;
  p.n_steps = n_steps;
  p.n_slots = n_slots;
  p.ring = ring;
  p.ring_w = ring_w;
  p.rdpcm = rdpcm != 0;
  p.off_ring = l.off_ring;
  p.off_coef = l.off_coef;
  p.off_groups = l.off_groups;
  p.tile_info = tile_info;
  p.n_tiles = n_tiles;
  p.tile_blocks = tile_blocks;
  p.cmodes = cmodes;
  p.rem_bits = rem_bits;
  p.lam = lam;
  p.zero_cost = zero_cost;
  p.rdoq = rdoq != 0;
  p.signhide = signhide != 0;
  p.tskip = tskip != 0;
  p.skip_out = skip_out;
  p.tskip_bits = tskip_bits;
  const KernelFn kernel =
      kernel_for(cu, qp, hbd, lossless != 0, n_tiles > 1,
                 rdoq || signhide || (cmodes != nullptr && !lossless),
                 sl_tabs != nullptr);
  if (l.bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, l.bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<items * n_tiles, l.threads, l.bytes,
           static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// Shared memory a thread block of this device may opt in to (bytes).
extern "C" int ktt_wavefront_smem_optin(int device, int* bytes) {
  return static_cast<int>(cudaDeviceGetAttribute(
      bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, device));
}
