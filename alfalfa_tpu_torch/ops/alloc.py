"""Where the CUDA wrappers allocate what their kernels write.

Every output, scratch buffer and schedule word that a wrapper of
``ops/*_cuda.py`` hands to its kernel comes from ``empty`` or ``zeros``
here, through the one function ``allocate``.  A check may swap that
function for its own: ``tools/poison_check.py`` carves each tensor out of
a buffer between guards of its fill, so that a kernel writing past the end
of an output it was given breaks a guard.
"""
import torch


def _torch_allocate(shape, dtype, device, zero):
    return (torch.zeros if zero else torch.empty)(shape, dtype=dtype,
                                                  device=device)


allocate = _torch_allocate


def _shape(shape):
    return (shape,) if isinstance(shape, int) else tuple(shape)


def empty(shape, dtype, device):
    """An uninitialised tensor the kernel writes whole."""
    return allocate(_shape(shape), dtype, device, False)


def zeros(shape, dtype, device):
    """A zeroed tensor (the schedules' tickets and progress words)."""
    return allocate(_shape(shape), dtype, device, True)
