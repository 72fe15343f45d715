"""Shared build/load helper for the native (.cc) fast paths.

Libraries are compiled with -march=native, so a cached .so is only valid on
the CPU (and with the flags) it was built for.  We embed a fingerprint of
the compile flags + host CPU feature set + g++ version in the .so filename;
a flag change or a different host simply misses the cache and rebuilds,
instead of SIGILLing at call time.
"""
import ctypes
import functools
import hashlib
import os
import subprocess
import threading

FLAGS = ("-O3", "-march=native", "-shared", "-fPIC", "-pthread")

# ASAN/UBSAN build mode (ALFALFA_SANITIZE=1): the native layer parses
# untrusted bitstreams with manual index arithmetic, so a fuzz suite
# (tools/sanitize_fuzz.py) re-runs against these builds in a process with
# libasan preloaded.  They go to a directory of their own, so that no
# sanitised library ever lies where the main path loads its own.
SANITIZE = os.environ.get("ALFALFA_SANITIZE") == "1"
SANITIZE_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "build", "sanitize")
if SANITIZE:
    FLAGS = ("-O1", "-g", "-march=native", "-shared", "-fPIC", "-pthread",
             "-fsanitize=address,undefined", "-fno-sanitize-recover=all")

_LOCK = threading.Lock()


@functools.lru_cache()
def _host_tag():
    h = hashlib.sha1(" ".join(FLAGS).encode())
    try:
        with open("/proc/cpuinfo", "rb") as f:
            for line in f:
                if line.startswith(b"flags"):
                    h.update(line)
                    break
    except OSError:
        pass
    try:
        h.update(subprocess.run(["g++", "-dumpfullversion"],
                                capture_output=True).stdout)
    except OSError:
        pass
    return h.hexdigest()[:10]


def load_library(src_path):
    """Compile (if needed) and dlopen the library for ``src_path``.

    Thread- and process-safe: first use can come from parallel encoder
    threads (or pool workers), so the compile goes to a private temp
    file and lands with an atomic rename; the in-process lock keeps two
    threads from compiling the same source twice."""
    here = os.path.dirname(os.path.abspath(src_path))
    base = os.path.splitext(os.path.basename(src_path))[0]
    out = SANITIZE_DIR if SANITIZE else here
    so = os.path.join(out, "lib%s.%s.so" % (base, _host_tag()))
    with _LOCK:
        os.makedirs(out, exist_ok=True)
        if (not os.path.exists(so)
                or os.path.getmtime(so) < os.path.getmtime(src_path)):
            tmp = "%s.tmp.%d" % (so, os.getpid())
            subprocess.run(["g++", *FLAGS, "-o", tmp, src_path],
                           check=True, capture_output=True)
            os.replace(tmp, so)
    return ctypes.CDLL(so)
