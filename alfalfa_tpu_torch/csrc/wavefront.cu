// wavefront_decode: the sequentially dependent half of VP8 frame
// reconstruction for G frames in lockstep: intra prediction, then the
// normal loop filter, both over macroblock anti-diagonals d = 2*row + col.
//
// Replaces the TPU kernels alfalfa_tpu/ops/wavefront_pm.py:
// wavefront_frame_batch_pm (_intra_phase, _lf_phase; K1, entry
// wavefront_decode_launch), alfalfa_tpu/ops/intra_pallas.py:intra_frame
// (K4, entry intra_frame_launch: the intra phase alone) and
// alfalfa_tpu/ops/lf_pallas.py:lf_pallas (K5, entry loop_filter_launch: the
// filter phase alone, all three planes in one persistent launch, where the
// TPU kernel is called once per plane).  The device code is
// wavefront_device.cuh.  Kept from them: the arithmetic and the two
// ordering rules.  (1) Intra prediction of MB (r, c)
// reads the UNFILTERED pixels of (r, c-1), (r-1, c-1), (r-1, c) and
// (r-1, c+1).  (2) The loop filter of MB (r, c) reads 4 and writes 3 pixels
// into (r, c-1) and (r-1, c) and must find them already filtered by their
// own macroblocks and by (r-1, c+1).  Both hold along d = 2r + c.  Not kept:
// the skewed diagonal storage, the ring of slabs, the pixel-major transpose
// and the permutation matmuls, which exist because that machine cannot
// gather or transpose cheaply.  Here the planes live in global memory (L2
// holds them at 720p G=16) and a block addresses its neighbours directly.
//
// Design of K4 (the simple right form): one launch copies the
// inter-predicted tiles into the planes; then one launch per diagonal
// predicts the intra macroblocks of that diagonal (grid: MBs of the
// diagonal x G, 256 threads, B_PRED's 16 sub-blocks as a serial chain in
// warp 0).  Stream order between launches is the only synchronisation.
// Launches per frame: 1 + (2*(R-1) + C).  K1, K4 and K5 take dense
// (G, R, C, ...) tiles and (G, H, W) planes, where the TPU kernels took
// skewed (n_diags, R_pad, P) slabs: the skew is a layout of that machine,
// not of the function.
//
// Design of K5: one launch per call, persistent (row_sched.cuh).  A warp
// takes a (row, frame) ticket, the frame inner, and walks its row left to
// right, waiting before (r, c)'s horizontal edges for row r-1 of its frame
// to have published min(c + 2, C) macroblocks (ROW_LAG in ops/lf_cuda.py:
// (r-1, c+1)'s left edge writes pixels of (r-1, c) that (r, c)'s top edge
// reads); (r, c)'s vertical edges, which read only row r, run before the
// wait.  The input
// copy is folded into the walk: a macroblock reads its own pixels from the
// input and writes them to the output itself, since no one else writes
// them before (r, c+1) and (r+1, c), which come later; its left halo is
// the previous macroblock's last columns, kept in shared memory, and its
// halo above comes from the output, through L2.  The input may be one
// frame broadcast over the G levels of the encoders' loop-filter search
// (a batch stride of 0).  The per-macroblock filter is lf_filter_window,
// K1's.
//
// Design of K1: K5's walk with the reconstruction folded in, one launch
// per call, persistent.  A warp takes a (row, frame) ticket, the frame
// inner, and walks its row; each macroblock (r, c) is reconstructed, then
// filtered, then c + 1 is published.  One counter per (frame, row) at lag
// 2 (ROW_LAG in ops/wavefront_cuda.py) serves both rules: (r, c) waits for
// row r-1 to have published min(c + 2, C), so (r-1, c+1) is reconstructed
// (rule 1) and filtered (rule 2).  Two sets of pixels: the filtered planes
// the call returns, and the unfiltered bottom pixel row of every
// macroblock (a sixteenth of the planes), which is all of rule 1 that
// crosses rows: the left column comes from the previous macroblock of the
// same walk, kept in a register per lane.  So no unfiltered plane is kept
// whole, only the pixels another block reads.  An inter macroblock (its
// rows are its stage-B tile, read a macroblock ahead: K4's untile launch
// folded into the walk) is in place, its bottom row kept and its vertical
// edges filtered before the wait.  An intra one is predicted after it,
// from L2 loads of row r-1's bottom rows and from its residual, which the
// warp copied into shared memory a macroblock ahead (cp.async): no load
// waits behind the acquire but those of pixels the row above wrote.  A
// B_PRED macroblock's 16 sub-blocks run on the warp as K7's do: 10 steps
// along the diagonals 2 sr + sc, two sub-blocks a step on the half-warps,
// where K4's kernel chains 16 on one half-warp.  The filter is K5's step
// (lf_filter_window, the left halo kept in shared memory, the halo above
// from the output through L2).  A block is one warp: at 720p, G=16, the
// card holds all 720 (row, frame) warps at once.
//
// Bound: on paper memory (tiles and residuals in, planes out, about
// 6 bytes per luma pixel; K5: planes in and out); in practice the critical
// path: one dependent launch per diagonal for K4, each a small grid, with
// the B_PRED chain of 16 dependent steps inside the intra ones; 2*(R-1) +
// C macroblocks one after another for K5 and K1, each a wait on the row
// above, an L2 load, the horizontal edges and the stores (an inter
// macroblock's vertical edges overlap the wait), and in K1 an intra
// macroblock's prediction (B_PRED: 10 dependent steps).

#include "wavefront_device.cuh"

static WaveArgs wave_args(void* Y, void* U, void* V, const void* ty,
                          const void* tu, const void* tv, const void* ry,
                          const void* ru, const void* rv, const void* mbp,
                          const void* bmode, int G, int R, int C) {
  WaveArgs a;
  a.Y = (uint8_t*)Y; a.U = (uint8_t*)U; a.V = (uint8_t*)V;
  a.ty = (const uint8_t*)ty; a.tu = (const uint8_t*)tu; a.tv = (const uint8_t*)tv;
  a.ry = (const int16_t*)ry; a.ru = (const int16_t*)ru; a.rv = (const int16_t*)rv;
  a.mbp = (const int16_t*)mbp;
  a.bmode = (const uint8_t*)bmode;
  a.G = G; a.R = R; a.C = C;
  return a;
}

// One intra_diag_kernel launch per diagonal, in diagonal order on ``st``.
// Returns the launches issued.
static int enqueue_diagonals(const WaveArgs& a, cudaStream_t st) {
  int issued = 0;
  const int nd = 2 * (a.R - 1) + a.C;
  for (int d = 0; d < nd; ++d) {
    const int lo = d - a.C + 1;
    const int r_lo = lo > 0 ? (lo + 1) / 2 : 0;
    const int r_hi = d / 2 < a.R - 1 ? d / 2 : a.R - 1;
    const int n = r_hi - r_lo + 1;
    if (n <= 0) continue;
    intra_diag_kernel<<<dim3(n, a.G), 256, 0, st>>>(a, d, r_lo);
    ++issued;
  }
  return issued;
}

// Each entry enqueues its launches on ``stream``, writes the number of
// kernel launches it issued to ``*n_launched`` and returns
// cudaGetLastError() after the last one (launch errors are sticky until
// read).

// K1: intra prediction and loop filter of G frames, one persistent launch
// of G * R warps.  The filtered planes are written whole; ey / eu / ev
// ((G,R,16C), (G,R,8C)) receive every macroblock's unfiltered bottom pixel
// row; mbp words 0-9 are read; ``sched`` is 1 + G * R zeroed ints (the
// ticket, then the rows' progress), ``lag`` the wait rule's lag (2).
extern "C" int wavefront_decode_launch(
    void* Y, void* U, void* V, void* ey, void* eu, void* ev, const void* ty,
    const void* tu, const void* tv, const void* ry, const void* ru,
    const void* rv, const void* mbp, const void* bmode, int G, int R, int C,
    void* sched, int lag, void* stream, int* n_launched) {
  WaveRowArgs a;
  a.Y = (uint8_t*)Y; a.U = (uint8_t*)U; a.V = (uint8_t*)V;
  a.ey = (uint8_t*)ey; a.eu = (uint8_t*)eu; a.ev = (uint8_t*)ev;
  a.ty = (const uint8_t*)ty; a.tu = (const uint8_t*)tu; a.tv = (const uint8_t*)tv;
  a.ry = (const int16_t*)ry; a.ru = (const int16_t*)ru; a.rv = (const int16_t*)rv;
  a.mbp = (const int16_t*)mbp;
  a.bmode = (const uint8_t*)bmode;
  a.G = G; a.R = R; a.C = C;
  a.rs.ticket = (int*)sched;
  a.rs.progress = (int*)sched + 1;
  a.rs.lag = lag;
  wave_row_kernel<<<G * R, 32, 0, (cudaStream_t)stream>>>(a);
  *n_launched = 1;
  return (int)cudaGetLastError();
}

// Blocks of K1's kernel the card ``device`` holds at once (0 on an error).
extern "C" int wavefront_decode_resident(int device) {
  int per_sm = 0, sms = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, wave_row_kernel,
                                                    32, 0) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device) !=
          cudaSuccess)
    return 0;
  return per_sm * sms;
}

// K4: untile and intra prediction; the planes come out unfiltered.
extern "C" int intra_frame_launch(
    void* Y, void* U, void* V, const void* ty, const void* tu, const void* tv,
    const void* ry, const void* ru, const void* rv, const void* mbp,
    const void* bmode, int G, int R, int C, void* stream, int* n_launched) {
  const WaveArgs a = wave_args(Y, U, V, ty, tu, tv, ry, ru, rv, mbp, bmode,
                               G, R, C);
  cudaStream_t st = (cudaStream_t)stream;
  untile_kernel<<<dim3(C, R, G), 256, 0, st>>>(a);
  *n_launched = 1 + enqueue_diagonals(a, st);
  return (int)cudaGetLastError();
}

// K5: the loop filter of whole planes, one persistent launch of G * R
// warps.  The input planes hold G frames (``in_batch`` 1) or one frame for
// all G (0); the output planes are written whole, the input never.  mbp
// words 4-9 are read (level 0 = macroblock not filtered); ``sched`` is
// 1 + G * R zeroed ints (the ticket, then the rows' progress), ``lag`` the
// wait rule's lag (2).
extern "C" int loop_filter_launch(
    void* Y, void* U, void* V, const void* y_in, const void* u_in,
    const void* v_in, int in_batch, const void* mbp, int G, int R, int C,
    void* sched, int lag, void* stream, int* n_launched) {
  LfRowArgs a;
  a.Y = (uint8_t*)Y; a.U = (uint8_t*)U; a.V = (uint8_t*)V;
  a.y_in = (const uint8_t*)y_in; a.u_in = (const uint8_t*)u_in;
  a.v_in = (const uint8_t*)v_in;
  a.in_y = in_batch ? (size_t)R * 16 * C * 16 : 0;
  a.in_c = a.in_y / 4;
  a.mbp = (const int16_t*)mbp;
  a.G = G; a.R = R; a.C = C;
  a.rs.ticket = (int*)sched;
  a.rs.progress = (int*)sched + 1;
  a.rs.lag = lag;
  lf_row_kernel<<<G * R, 32, 0, (cudaStream_t)stream>>>(a);
  *n_launched = 1;
  return (int)cudaGetLastError();
}

// Blocks of K5's kernel the card ``device`` holds at once (0 on an error).
extern "C" int loop_filter_resident(int device) {
  int per_sm = 0, sms = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, lf_row_kernel,
                                                    32, 0) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device) !=
          cudaSuccess)
    return 0;
  return per_sm * sms;
}
