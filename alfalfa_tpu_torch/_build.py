"""Build and load the CUDA kernels under csrc/, and what their wrappers
share: the C entry's handle, the call that raises on a CUDA error, the
argument checks.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled by ``nvcc``
into its own shared library ``build/lib<name>.so`` (no PyTorch headers, so
a build takes seconds) and loaded with ctypes: a library per source, not
one for all, so that ``build_all`` can start one ``nvcc`` per source at
once and the build time stays that of the slowest source as kernels are
added.  The build happens at first use, from the sources in this package
only.  A library is rebuilt when its source, or a header beside it
(``csrc/*.cuh``), is newer.
"""
import ctypes
import glob
import os
import shutil
import subprocess
import threading

import torch

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC_DIR = os.path.join(_HERE, "csrc")
BUILD_DIR = os.path.join(_HERE, "build")
KERNEL_SOURCES = ("sixtap_mc", "wavefront", "enc_intra", "enc_inter",
                  "enc_decide", "enc_intra_fixup", "rebase_residues")
# the memory check's library (tools/poison_check.py): built beside the
# kernels, linked into none of them
CHECK_SOURCES = ("poison",)

# -Xptxas -v: the compiler output lists registers and shared memory per kernel
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LOCK = threading.Lock()
_LIBS = {}


def _nvcc():
    exe = shutil.which("nvcc")
    if exe:
        return exe
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    exe = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(exe):
        raise RuntimeError("nvcc not found: the CUDA kernels of "
                           "alfalfa_tpu_torch are built on a machine with "
                           "the CUDA toolkit")
    return exe


def _paths(name):
    return (os.path.join(CSRC_DIR, name + ".cu"),
            os.path.join(BUILD_DIR, "lib%s.so" % name))


def _stale(name):
    src, so = _paths(name)
    if not os.path.exists(so):
        return True
    deps = [src] + glob.glob(os.path.join(CSRC_DIR, "*.cuh"))
    return os.path.getmtime(so) < max(os.path.getmtime(p) for p in deps)


def _start(name):
    src, so = _paths(name)
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = "%s.tmp.%d" % (so, os.getpid())
    proc = subprocess.Popen([_nvcc(), *NVCC_FLAGS, "-o", tmp, src],
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    return proc, tmp, so


def _finish(name, proc, tmp, so):
    out = proc.communicate()[0].decode(errors="replace")
    if proc.returncode != 0:
        raise RuntimeError("nvcc failed for %s.cu:\n%s" % (name, out))
    os.replace(tmp, so)
    return out


def build_all():
    """Compile every stale kernel source and the memory check's, all
    compilers started together.  Returns {name: compiler output} of those
    it compiled."""
    with _LOCK:
        jobs = {n: _start(n) for n in KERNEL_SOURCES + CHECK_SOURCES
                if _stale(n)}
        return {n: _finish(n, *job) for n, job in jobs.items()}


def load_kernel(name):
    """ctypes handle of ``build/lib<name>.so``, building it if needed."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            if _stale(name):
                _finish(name, *_start(name))
            lib = _LIBS[name] = ctypes.CDLL(_paths(name)[1])
        return lib


def c_entry(lib, fn, argtypes):
    """ctypes handle of the C entry ``fn`` of ``build/lib<lib>.so``.  Every
    entry takes ``argtypes`` followed by the CUDA stream and an ``int*``
    into which it writes the kernel launches it issued, and returns the
    CUDA error code."""
    f = getattr(load_kernel(lib), fn)
    f.restype = ctypes.c_int
    f.argtypes = list(argtypes) + [ctypes.c_void_p,
                                   ctypes.POINTER(ctypes.c_int)]
    return f


def launch(entry, name, device, *args):
    """Call the C entry on ``device``'s current stream; raise on a CUDA
    error.  Returns the number of kernel launches the entry issued.

    The stream is read as PyTorch's own launchers read it (its raw
    handle for a device index), and the device is switched only when it is
    not the current one: the context manager and the Stream object cost
    more host time than a small kernel takes on the card."""
    index = device.index
    current = torch.cuda.current_device()
    if index is not None and index != current:
        with torch.cuda.device(device):
            return launch(entry, name, torch.device("cuda", index), *args)
    issued = ctypes.c_int(0)
    rc = entry(*args, torch._C._cuda_getCurrentRawStream(current),
               ctypes.byref(issued))
    if rc != 0:
        raise RuntimeError("%s launch failed: CUDA error %d" % (name, rc))
    return issued.value


def resident_blocks(lib, fn, device, *flags):
    """What the C function ``fn(int device, int flags...)`` of
    ``build/lib<lib>.so`` returns: the blocks of its kernel that ``device``
    holds at once."""
    f = getattr(load_kernel(lib), fn)
    f.restype = ctypes.c_int
    f.argtypes = [ctypes.c_int] * (1 + len(flags))
    index = torch.device(device).index
    return f(torch.cuda.current_device() if index is None else index, *flags)


def check_aligned(**tensors):
    """Raise unless each ``name=(tensor, bytes)`` starts on a multiple of
    ``bytes`` (what a kernel's asynchronous copies of it need)."""
    for name, (t, align) in tensors.items():
        if t.data_ptr() % align:
            raise ValueError("%s must start on a multiple of %d bytes"
                             % (name, align))


def check_map(name, t, shape, device):
    """Raise unless the per-macroblock map ``t`` is on ``device`` with
    ``shape`` (any dtype: the wrapper packs it)."""
    if t.device != device or tuple(t.shape) != tuple(shape):
        raise ValueError("%s must be %s on %s" % (name, tuple(shape), device))


def check_tensor(name, t, dtype, shape, device):
    """Raise unless ``t`` is what a kernel takes: on ``device``, of
    ``dtype`` and ``shape``, contiguous."""
    if t.device != device:
        raise ValueError("%s on %s, expected %s" % (name, t.device, device))
    if t.dtype != dtype:
        raise TypeError("%s is %s, expected %s" % (name, t.dtype, dtype))
    if tuple(t.shape) != tuple(shape):
        raise ValueError("%s has shape %s, expected %s"
                         % (name, tuple(t.shape), tuple(shape)))
    if not t.is_contiguous():
        raise ValueError("%s is not contiguous" % name)
