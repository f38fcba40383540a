"""Shared checks and ctypes plumbing of the kernel wrappers."""

from __future__ import annotations

import ctypes

import torch

from . import _build

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong


def route(x):
    """'plain' for a CPU tensor, 'kernel' for a CUDA tensor; any other
    device raises. The plain version is taken ONLY because the tensor
    lies on the CPU: a CUDA tensor launches the kernel or raises."""
    if x.device.type == "cpu":
        return "plain"
    if x.device.type == "cuda":
        return "kernel"
    raise ValueError(f"no kernel for device {x.device}")


def same_device(name, ref, *tensors):
    for t in tensors:
        if t.device != ref.device:
            raise ValueError(
                f"{name}: every operand must be on {ref.device}, got "
                f"{t.device}")


def bind(lib_name, fn_name, argtypes):
    """The C entry point `fn_name` of ``csrc/<lib_name>.cu`` (built and
    loaded on first use) with its ctypes signature declared."""
    lib = _build.load(lib_name)
    fn = getattr(lib, fn_name)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = _I
        lib.cuda_error_string.argtypes = [_I]
        lib.cuda_error_string.restype = ctypes.c_char_p
    return lib, fn


def launch(lib, fn, what, device, *args):
    """Call `fn` on `device`'s current stream (read in the calling
    thread), passing the device's SM count (the persistent grids size
    themselves by it), and raise on a non-zero cudaGetLastError()."""
    with torch.cuda.device(device):
        sms = torch.cuda.get_device_properties(device).multi_processor_count
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(*args, sms, stream)
    if err != 0:
        msg = lib.cuda_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA launch failed ({err}: {msg})")
