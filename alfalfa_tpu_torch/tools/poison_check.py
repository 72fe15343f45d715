"""The card half of the port's memory-safety check: every hand-written
kernel's case run under fills that change only what a memory fault reads.

``compute-sanitizer`` does not run on the machine with the card, so the
check is made of what does: PyTorch, the kernels' own wrappers and one
small CUDA library, ``csrc/poison.cu``.  A case runs once a pattern
(PATTERNS: 0x00, then 0xFF); before each run

- every tensor of the arguments (nested in tuples, lists and dicts) is
  copied into a buffer of its own, with GUARD bytes of the pattern before
  and after it (``guard``): its strides, and its address modulo GUARD, are
  kept, so the wrappers' contiguity and alignment checks still pass; a
  tensor met twice is copied once;
- the caching allocator's free blocks are filled with the pattern
  (``fill_cached``: allocate, fill, free, no ``empty_cache``);
- what the wrapper allocates for its kernel (outputs, schedules,
  scratch: every ``ops/alloc.py`` call) is carved out of a buffer of its
  own between GUARD bytes of the pattern (``carve``), uninitialised
  tensors holding the pattern, zeroed ones zero;
- the shared memory of every SM is filled with it (``poison_shared``).

After each run the outputs must be ``torch.equal`` to the plain version's,
and every guard, around the arguments and around what the wrapper
allocated, must still hold the pattern.  A kernel that reads shared or
global memory it did not write, or reads past the end of what it was
given, sees the pattern, so its outputs change between the fills; one
that writes past the end of an argument or of an output breaks a guard.
``controls`` runs the faults of ``csrc/poison.cu`` through the same
check, the proof that it sees them on the card at hand.

    from alfalfa_tpu_torch.tools import poison_check as pc
    pc.check_case(call, args, want)    # [one dict a run]
    pc.controls("cuda")                # {control: result}

``chip_smoke.py``'s ``memory_checks`` phase runs it over every kernel case
of its ``kernels`` phase and over corrupted streams through the
single-frame ``Decoder``.
"""
import ctypes
import functools

import torch

from alfalfa_tpu_torch._build import c_entry, launch, load_kernel
from alfalfa_tpu_torch.ops import alloc

GUARD = 256
PATTERNS = (0x00, 0xFF)
# the caching allocator's small pool takes requests of up to 1 MiB
SMALL_REQUEST = 1 << 20


@functools.cache
def _entries():
    P, I, U = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint
    return {"poison": c_entry("poison", "poison_shared_launch", [U]),
            "shared": c_entry("poison", "control_shared_launch",
                              [P, I, I, I]),
            "read_past": c_entry("poison", "control_read_past_launch",
                                 [P, P, I]),
            "write_past": c_entry("poison", "control_write_past_launch",
                                  [P, I])}


def _device(device):
    device = torch.device(device)
    if device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


def shared_geometry():
    """(SMs, bytes of shared memory poison_shared fills on each)."""
    sms, bytes_ = ctypes.c_int(0), ctypes.c_int(0)
    rc = load_kernel("poison").poison_shared_geometry(ctypes.byref(sms),
                                                      ctypes.byref(bytes_))
    if rc:
        raise RuntimeError("poison_shared_geometry: CUDA error %d" % rc)
    return sms.value, bytes_.value


def poison_shared(byte, device):
    """Fill the shared memory of every SM of ``device`` with ``byte``."""
    device = _device(device)
    launch(_entries()["poison"], "poison_shared", device, byte * 0x01010101)


def _free_blocks(index):
    """[(bytes, small pool)] of the caching allocator's free blocks on the
    device ``index``, the largest first."""
    out = []
    for seg in torch.cuda.memory_snapshot():
        if seg["device"] != index:
            continue
        small = seg["segment_type"] == "small"
        out += [(b["size"], small) for b in seg["blocks"]
                if b["state"] == "inactive"]
    return sorted(out, reverse=True)


def fill_cached(byte, device):
    """Fill the free blocks the caching allocator holds on ``device`` with
    ``byte``: allocate a tensor the size of each (a small-pool block in
    pieces the small pool takes), fill, free; the blocks go back to the
    cache holding ``byte``.  Returns (bytes filled, free bytes left
    unfilled)."""
    device = _device(device)
    held = []
    for _ in range(4):
        blocks = _free_blocks(device.index)
        if not blocks:
            break
        for size, small in blocks:
            while size > 0:
                n = min(size, SMALL_REQUEST) if small else size
                held.append(torch.empty(n, dtype=torch.uint8, device=device))
                size -= n
    left = sum(s for s, _ in _free_blocks(device.index))
    filled = 0
    while held:
        filled += held.pop().fill_(byte).numel()
    return filled, left


def _extent(t):
    """Bytes from ``t``'s first element to the end of its last."""
    return (1 + sum((n - 1) * s for n, s in zip(t.shape, t.stride()))) \
        * t.element_size()


def _guarded_copy(t, byte, guards):
    """``t`` copied into a buffer of its own between GUARD-byte guards of
    ``byte`` (the copy's address is ``t``'s modulo GUARD); the buffer and
    the copy's byte range are appended to ``guards``."""
    extent = _extent(t)
    lead = GUARD + t.data_ptr() % GUARD
    buf = torch.full((lead + extent + GUARD,), byte, dtype=torch.uint8,
                     device=t.device)
    # what t spans of its storage, byte for byte
    src = t.as_strided((extent // t.element_size(),), (1,),
                       t.storage_offset())
    body = buf[lead:lead + extent].view(t.dtype)
    body.copy_(src)
    guards.append((buf, lead, lead + extent))
    return body.as_strided(t.shape, t.stride())


def guard(args, byte):
    """(``args`` with every CUDA tensor replaced by a guarded copy, the
    guards: [(buffer, first byte of the copy, end of the copy)])."""
    memo, guards = {}, []

    def walk(x):
        if isinstance(x, torch.Tensor):
            if x.device.type != "cuda" or x.numel() == 0:
                return x
            if id(x) not in memo:
                memo[id(x)] = _guarded_copy(x, byte, guards)
            return memo[id(x)]
        if isinstance(x, tuple):
            return tuple(walk(v) for v in x)
        if isinstance(x, list):
            return [walk(v) for v in x]
        if isinstance(x, dict):
            return {k: walk(v) for k, v in x.items()}
        return x

    return walk(args), guards


def carve(byte, guards):
    """An ``ops/alloc.py`` allocator that carves each tensor out of a
    buffer of its own, between GUARD bytes of ``byte`` (the tensor 256-byte
    aligned; uninitialised it holds ``byte``, zeroed it is 0); the buffer
    and the tensor's byte range are appended to ``guards``."""
    def allocate(shape, dtype, device, zero):
        nbytes = torch.Size(shape).numel() * dtype.itemsize
        buf = torch.full((GUARD + nbytes + GUARD,), byte, dtype=torch.uint8,
                         device=device)
        body = buf[GUARD:GUARD + nbytes]
        if zero:
            body.zero_()
        guards.append((buf, GUARD, GUARD + nbytes))
        return body.view(dtype).view(shape)
    return allocate


def broken_guards(guards, byte):
    """How many of ``guards`` no longer hold ``byte`` before or after
    their copy."""
    return sum(bool((buf[:lo] != byte).any() or (buf[hi:] != byte).any())
               for buf, lo, hi in guards)


def _tuple(x):
    return tuple(x) if isinstance(x, (tuple, list)) else (x,)


def check_case(call, args, want, patterns=PATTERNS):
    """``call(*args)`` on the current CUDA device once a pattern, each run
    after ``guard``, ``fill_cached`` and ``poison_shared`` with it, and
    what it allocates through ``ops/alloc.py`` carved between guards
    (``carve``); ``want``: the plain version's outputs.  Returns one dict
    a run: its pattern, whether its outputs are ``torch.equal`` to
    ``want`` and their largest difference, the guards around the
    arguments and around the allocated tensors and those it broke, and
    the cache bytes filled and left unfilled."""
    device = _device("cuda")
    want = _tuple(want)
    runs = []
    for byte in patterns:
        gargs, guards = guard(args, byte)
        filled, left = fill_cached(byte, device)
        poison_shared(byte, device)
        carved = []
        alloc.allocate = carve(byte, carved)
        try:
            out = _tuple(call(*gargs))
            torch.cuda.synchronize(device)
        finally:
            alloc.allocate = alloc._torch_allocate
        equal = len(out) == len(want) and all(
            x.shape == y.shape and torch.equal(x, y) for x, y in zip(out, want))
        err = max((int((x.to(torch.int64) - y.to(torch.int64)).abs().max())
                   for x, y in zip(out, want)
                   if x.shape == y.shape and x.numel()), default=0)
        runs.append(dict(pattern=byte, equal=equal, max_abs_err=err,
                         guards=len(guards),
                         broken_guards=broken_guards(guards, byte),
                         allocated_guards=len(carved),
                         broken_allocated_guards=broken_guards(carved, byte),
                         cache_filled=filled, cache_left=left))
        del gargs, guards, carved, out
    return runs


def caught(runs):
    """Whether a check's runs show a fault: an output unequal to the plain
    version's, or a broken guard."""
    return any(not r["equal"] or r["broken_guards"]
               or r["broken_allocated_guards"] for r in runs)


def controls(device, n=1000, word=2048, smem=16384):
    """The four positive controls of csrc/poison.cu through check_case:
    {"shared_uninitialised", "read_past_input", "write_past_output",
    "write_past_allocated_output"}, each {"runs", "caught", ...}.  Caught
    means that every run shows the fault as the fill made it: the shared
    control read the pattern on every block, the read control the pattern
    past the input's end, the write controls broke the guard after their
    output (one given as an argument, one allocated through
    ``ops/alloc.py`` as a wrapper allocates its outputs).  Their plain
    versions: the shared control reads 0 (a word written before it is
    read), the read control writes 0 where the kernel reads past the
    input, the write controls fill their n elements only."""
    device = _device(device)
    e = _entries()
    sms, _ = shared_geometry()
    seen = []

    def shared():
        out = torch.empty(sms, dtype=torch.int32, device=device)
        launch(e["shared"], "control_shared", device, out.data_ptr(), sms,
               word, smem)
        seen.append(sorted(set(out.tolist())))
        return out

    def read_past(x):
        out = torch.empty(n, dtype=torch.int32, device=device)
        launch(e["read_past"], "control_read_past", device, x.data_ptr(),
               out.data_ptr(), n)
        seen.append(int(out[-1]))
        return out

    def write_past(buf):
        launch(e["write_past"], "control_write_past", device, buf.data_ptr(),
               n)
        return buf

    def word_of(byte):      # the pattern as an int32
        return int.from_bytes(bytes([byte] * 4), "little", signed=True)

    x = torch.arange(n, dtype=torch.int32, device=device)
    res = {}
    runs = check_case(shared, (), torch.zeros(sms, dtype=torch.int32,
                                              device=device))
    res["shared_uninitialised"] = dict(
        runs=runs, values_read=seen[:],
        caught=[[word_of(b)] for b in PATTERNS] == seen)
    seen.clear()
    runs = check_case(read_past, (x,), torch.cat([x[1:], x[:1] * 0]))
    res["read_past_input"] = dict(
        runs=runs, values_read_past_end=seen[:],
        caught=[word_of(b) for b in PATTERNS] == seen)
    runs = check_case(write_past, (torch.zeros_like(x),), x)
    res["write_past_output"] = dict(
        runs=runs, caught=all(r["broken_guards"] == 1 for r in runs))

    def write_past_allocated():
        return write_past(alloc.empty(n, torch.int32, device))

    runs = check_case(write_past_allocated, (), x)
    res["write_past_allocated_output"] = dict(
        runs=runs, caught=all(r["broken_allocated_guards"] == 1
                              and not r["broken_guards"] for r in runs))
    return res
