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
// K1, K4 and K5 take dense (G, R, C, ...) tiles and (G, H, W) planes,
// where the TPU kernels took skewed (n_diags, R_pad, P) slabs: the skew is
// a layout of that machine, not of the function.  Each is one persistent
// launch a call on the row scheduler of row_sched.cuh.
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
// rows are its stage-B tile, read a macroblock ahead) is in place, its bottom row kept and its vertical
// edges filtered before the wait.  An intra one is predicted after it,
// from L2 loads of row r-1's bottom rows and from its residual, which the
// warp copied into shared memory a macroblock ahead (cp.async): no load
// waits behind the acquire but those of pixels the row above wrote.  A
// B_PRED macroblock's 16 sub-blocks run on the warp as K7's do: 10 steps
// along the diagonals 2 sr + sc, two sub-blocks a step on the half-warps,
// where a serial chain takes 16.  The filter is K5's step
// (lf_filter_window, the left halo kept in shared memory, the halo above
// from the output through L2).  A block is one warp: at 720p, G=16, the
// card holds all 720 (row, frame) warps at once.
//
// Design of K4: K1's walk without the filter, one launch per call,
// persistent.  A block of K4_WARPS warps takes a (row, frame) ticket, the
// frame inner.  Its warps first copy the row's inter macroblocks (their
// stage-B tiles are their reconstruction and read nothing the launch
// writes) and the row publishes up to its first intra macroblock; then
// the intra macroblocks in order, each waiting for row r-1 to have
// published min(c + 2, C) (ROW_LAG in ops/intra_cuda.py: the prediction
// reads (r-1, c+1)), reconstructed with K1's step, and publishing up to
// the next intra macroblock, so a run of inter macroblocks costs one
// release.  Nothing is filtered, so the pixels above come from the output
// planes themselves through L2 and K1's bottom-row arrays are not needed.
// Warp 0 runs the luma rows (B_PRED's 10-step chain), warp 1 the chroma
// rows beside it; the other warps only share out the copies.
//
// Bound: on paper memory (tiles and residuals in, planes out, about
// 6 bytes per luma pixel; K5: planes in and out); in practice the critical
// path: 2*(R-1) + C macroblocks one after another, each a wait on the row
// above and an L2 load; in K5 and K1 the horizontal edges and the stores
// (an inter macroblock's vertical edges overlap the wait), in K1 and K4 an
// intra macroblock's prediction (B_PRED: 10 dependent steps).  An
// interframe's chain in K4 is only as long as its chained intra
// macroblocks: the inter ones are copied before any wait.

#include "wavefront_device.cuh"

// The warps of K4's block (see intra_row_kernel).
#define K4_WARPS 4

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

// K4: intra prediction of G frames, one persistent launch of G * R blocks;
// the planes are written whole and come out unfiltered.  mbp words 0-3 are
// read; ``sched`` is 1 + G * R zeroed ints (the ticket, then the rows'
// progress), ``lag`` the wait rule's lag (2).
extern "C" int intra_frame_launch(
    void* Y, void* U, void* V, const void* ty, const void* tu, const void* tv,
    const void* ry, const void* ru, const void* rv, const void* mbp,
    const void* bmode, int G, int R, int C, void* sched, int lag,
    void* stream, int* n_launched) {
  IntraRowArgs a;
  a.Y = (uint8_t*)Y; a.U = (uint8_t*)U; a.V = (uint8_t*)V;
  a.ty = (const uint8_t*)ty; a.tu = (const uint8_t*)tu; a.tv = (const uint8_t*)tv;
  a.ry = (const int16_t*)ry; a.ru = (const int16_t*)ru; a.rv = (const int16_t*)rv;
  a.mbp = (const int16_t*)mbp;
  a.bmode = (const uint8_t*)bmode;
  a.G = G; a.R = R; a.C = C;
  a.rs.ticket = (int*)sched;
  a.rs.progress = (int*)sched + 1;
  a.rs.lag = lag;
  intra_row_kernel<K4_WARPS><<<G * R, 32 * K4_WARPS, 0, (cudaStream_t)stream>>>(a);
  *n_launched = 1;
  return (int)cudaGetLastError();
}

// Blocks of K4's kernel the card ``device`` holds at once (0 on an error).
extern "C" int intra_frame_resident(int device) {
  int per_sm = 0, sms = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, intra_row_kernel<K4_WARPS>, 32 * K4_WARPS, 0) !=
          cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device) !=
          cudaSuccess)
    return 0;
  return per_sm * sms;
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
