"""Build and load the CUDA kernels under csrc/, and the argument check
their wrappers share.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled by ``nvcc``
into its own shared library ``build/lib<name>.so`` (no PyTorch headers, so
a build takes seconds) and loaded with ctypes: a library per source, not
one for all, so that ``build_all`` can start one ``nvcc`` per source at
once and the build time stays that of the slowest source as kernels are
added.  The build happens at first use, from the sources in this package
only.  A library is rebuilt when its source is newer.
"""
import ctypes
import os
import shutil
import subprocess
import threading

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC_DIR = os.path.join(_HERE, "csrc")
BUILD_DIR = os.path.join(_HERE, "build")
KERNEL_SOURCES = ("sixtap_mc", "wavefront")

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
    return not os.path.exists(so) or os.path.getmtime(so) < os.path.getmtime(src)


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
    """Compile every stale kernel source, all compilers started together.
    Returns {name: compiler output} of those it compiled."""
    with _LOCK:
        jobs = {n: _start(n) for n in KERNEL_SOURCES if _stale(n)}
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
