"""ExCamera's cluster encode in one call: chunks encoded in parallel, then
stitched by the serial rebase (the pipeline the reference realises with
xc-enc -I/-O state files under its external mu framework; SURVEY.md
sections 2.9, 3.3).  The counterpart of the JAX package's
parallel/cluster.py.

Phase 1 encodes each chunk independently in a worker process: it starts
with a key frame and is terminated (every reference refreshed on its last
frame, xc-terminate-chunk's semantics), so its exit state is fully
described by that last reference.  Phase 2 stitches serially: each
chunk's leading key frame is re-encoded as an interframe against the
previous chunk's exit state and its other frames rebased
(encoder/reencode.py), so the stream decodes continuously.

The JAX package keeps its workers on the host, because a TPU has one
client.  Here every worker encodes on ``device`` (default CUDA): each
``spawn`` process has its own CUDA context on the card, and a kernel's
first build is safe under concurrency (``_build``: a temporary file per
process, renamed into place).  A chunk's exit state crosses processes as
``.state`` bytes.
"""
import multiprocessing
from concurrent.futures import ProcessPoolExecutor


def _encode_one_chunk(args):
    """Worker: encode one chunk on its own and terminate it.  Returns
    (payloads, the exit state as .state bytes, the exit minihash)."""
    (frames, w, h, y_ac_qi, ssim_target, quality, two_pass, device) = args
    from alfalfa_tpu_torch.decoder.decoder import Decoder
    from alfalfa_tpu_torch.encoder.encoder import Encoder
    from alfalfa_tpu_torch.encoder.serializer import refresh_all_references
    from alfalfa_tpu_torch.state import serdes

    enc = Encoder(w, h, quality=quality, two_pass=two_pass, device=device)
    payloads = []
    for f in frames:
        if ssim_target is not None:
            payloads.append(enc.encode_with_minimum_ssim(f, ssim_target))
        else:
            payloads.append(enc.encode_with_quantizer(f, y_ac_qi))

    # terminate the chunk: the last frame refreshes every reference (its
    # tag shown, as the JAX package writes it); the chunk is decoded along
    # for its exit state
    dec = Decoder(w, h, device=device)
    out = []
    for i, payload in enumerate(payloads):
        if i == len(payloads) - 1:
            payload = refresh_all_references(payload, dec.state.copy(), w, h,
                                             show=True)
        dec.decode_frame(payload)
        out.append(payload)

    return out, serdes.save_decoder(dec.state, dec.references), dec.minihash()


def parallel_encode(frames, width, height, writer, y_ac_qi=None,
                    ssim_target=None, chunk_frames=6, workers=None,
                    quality="best", two_pass=False, kf_q_weight=0.5,
                    log=None, device=None):
    """Encode ``frames`` ([(y, u, v)]) into ``writer`` (an IVFWriter) by
    parallel chunk encodes and the serial rebase, every frame on
    ``device`` (default CUDA).  ``workers`` processes (None: one a CPU
    core) encode the chunks; with one worker or one chunk they are
    encoded in this process.  Returns per-chunk stats."""
    import torch
    from alfalfa_tpu_torch.decoder.decoder import Decoder
    from alfalfa_tpu_torch.encoder import reencode as RB
    from alfalfa_tpu_torch.encoder.encoder import Encoder
    from alfalfa_tpu_torch.state import serdes

    device = torch.device("cuda" if device is None else device)
    chunks = [frames[i:i + chunk_frames]
              for i in range(0, len(frames), chunk_frames)]
    jobs = [(c, width, height, y_ac_qi, ssim_target, quality, two_pass,
             str(device)) for c in chunks]

    # phase 1: independent chunk encodes in parallel processes
    if workers == 1 or len(chunks) == 1:
        results = [_encode_one_chunk(j) for j in jobs]
    else:
        # spawn: a forked child cannot use its parent's CUDA context
        ctx = multiprocessing.get_context("spawn")
        with ProcessPoolExecutor(max_workers=workers, mp_context=ctx) as pool:
            results = list(pool.map(_encode_one_chunk, jobs))
    if log:
        log(f"phase 1: {len(chunks)} chunks encoded")

    # phase 2: the serial rebase chain; the rebasing encoder takes the
    # quality but not two-pass, as the JAX package's does
    stats = []
    enc = None
    for g, (payloads, state_bytes, _) in enumerate(results):
        if g == 0:
            for p in payloads:
                writer.append_frame(p)
            enc = Encoder(width, height, quality=quality, device=device)
            enc.state, enc.references = serdes.load_decoder(state_bytes,
                                                            device=device)
            enc.frame_no = 1
            stats.append({"chunk": 0, "rebased": False,
                          "bytes": sum(len(p) for p in payloads)})
            continue

        # this chunk's own encode is the prediction stream
        pred = RB.parse_prediction(payloads,
                                   Decoder(width, height, device=device))
        n_before = writer.frame_count
        RB.reencode(enc, chunks[g], pred, kf_q_weight, False, writer)
        stats.append({"chunk": g, "rebased": True,
                      "frames": writer.frame_count - n_before})
        if log:
            log(f"phase 2: chunk {g} rebased")
    return stats
