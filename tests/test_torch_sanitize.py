"""The port's safety gates on the CPU: every module imports on its own,
and the native layer's fuzz run (alfalfa_tpu_torch/tools/sanitize_fuzz.py)
passes, on the main build and, under ``-m slow``, built with ASAN and UBSAN.

The card's half of the gate is chip_smoke.py's memory_checks phase
(tools/poison_check.py): compute-sanitizer does not run on the machine with
the card.  Nothing here imports JAX: the sanitizer runtime is preloaded into
the fuzz run's whole process.
"""
import os
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

REPO = Path(__file__).parent.parent

# Imports each module of the port as the first of the port in this process,
# one after another: between modules every alfalfa_tpu_torch entry leaves
# sys.modules, torch stays.  Prints the modules that failed.
IMPORT_EACH = r"""
import importlib, os, sys
import torch
root = "alfalfa_tpu_torch"
names = []
for d, dirs, files in os.walk(root):
    dirs[:] = sorted(x for x in dirs if x not in ("build", "__pycache__"))
    for f in sorted(files):
        if f.endswith(".py"):
            m = os.path.join(d, f)[:-3].replace(os.sep, ".")
            names.append(m[:-len(".__init__")] if m.endswith(".__init__")
                         else m)
failed = []
for name in names:
    for k in [k for k in sys.modules if k.split(".")[0] == root]:
        del sys.modules[k]
    try:
        importlib.import_module(name)
    except Exception as e:
        failed.append("%s: %r" % (name, e))
print("imported %d modules" % len(names))
print("\n".join(failed))
sys.exit(1 if failed or len(names) < 50 else 0)
"""


def _run(argv, env=None, timeout=600):
    return subprocess.run(argv, cwd=REPO, env=env, capture_output=True,
                          text=True, timeout=timeout)


def test_every_module_imports_first():
    """No import cycle: each module of the port can be the first one a
    process imports (ops.enc_intra, ops.rebase and ops.rebase_cuda raised
    ImportError when the encoder package imported its Encoder eagerly)."""
    r = _run([sys.executable, "-c", IMPORT_EACH], timeout=300)
    assert r.returncode == 0, r.stdout[-4000:] + r.stderr[-4000:]


def test_sanitize_fuzz_quick_unsanitized():
    """The fuzz run's four stages, once each on the smallest fixture,
    against the main build."""
    r = _run([sys.executable, "-m", "alfalfa_tpu_torch.tools.sanitize_fuzz",
              "--unsanitized", "--quick"])
    assert r.returncode == 0, r.stdout[-4000:] + r.stderr[-4000:]
    assert r.stdout.rstrip().endswith("sanitize_fuzz: all stages passed")


@pytest.mark.slow
def test_native_layer_under_asan_ubsan():
    """The whole fuzz run against the native layer built with
    -fsanitize=address,undefined (ALFALFA_SANITIZE=1, into a build
    directory of its own), libasan preloaded: bit-exact decodes, the GOP
    token parse on every engine and thread count, corrupted streams
    through the concealing decoder, the host encoders and the host
    patch."""
    lib = subprocess.run(["g++", "-print-file-name=libasan.so"],
                         capture_output=True, text=True).stdout.strip()
    if not lib or not os.path.exists(lib):
        pytest.skip("libasan not available")
    env = dict(os.environ, ALFALFA_SANITIZE="1", LD_PRELOAD=lib,
               # Python's allocations live until exit: no leak check; the
               # faults hunted here abort (-fno-sanitize-recover)
               ASAN_OPTIONS="detect_leaks=0:abort_on_error=1",
               UBSAN_OPTIONS="halt_on_error=1:print_stacktrace=1")
    r = _run([sys.executable, "-m", "alfalfa_tpu_torch.tools.sanitize_fuzz"],
             env=env, timeout=3600)
    assert r.returncode == 0 and r.stdout.rstrip().endswith(
        "sanitize_fuzz: all stages passed"), (
        "rc %d\n--- stdout ---\n%s\n--- stderr ---\n%s"
        % (r.returncode, r.stdout[-4000:], r.stderr[-4000:]))
