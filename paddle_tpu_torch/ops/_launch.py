"""Shared checks and ctypes plumbing of the kernel wrappers."""

from __future__ import annotations

import ctypes
import threading

import torch

from . import _build

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong


_counts_lock = threading.Lock()


def count(holder, key="launches"):
    """Add one to a kernel's launch counter, exactly however many
    threads launch at once (fleet replicas step from their own
    threads): ``holder.<key>`` for an attribute counter (B7-B9's
    ``fn.launches``), ``holder[key]`` for a dict of counters (B1-B6).
    Every read-add-store of a counter goes through this one lock."""
    with _counts_lock:
        if isinstance(holder, dict):
            holder[key] += 1
        else:
            setattr(holder, key, getattr(holder, key) + 1)


def route(x):
    """'plain' for a CPU tensor, 'kernel' for a CUDA tensor; any other
    device raises. The plain version is taken ONLY because the tensor
    lies on the CPU: a CUDA tensor launches the kernel or raises."""
    if x.device.type == "cpu":
        return "plain"
    if x.device.type == "cuda":
        return "kernel"
    raise ValueError(f"no kernel for device {x.device}")


# the dtype codes the C entry points take (csrc/half16.cuh)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


def dtype_code(t):
    """0 for float32, 1 for bfloat16, 2 for float16 (the instantiation a
    kernel launches; each dtype its own, none converted to another)."""
    return _DTYPE_CODES[t.dtype]


def aligned(t):
    """`t` contiguous with a 16-byte aligned base (the kernels read rows
    in 16-byte vectors)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def same_device(name, ref, *tensors):
    for t in tensors:
        if t.device != ref.device:
            raise ValueError(
                f"{name}: every operand must be on {ref.device}, got "
                f"{t.device}")


def bind(lib_name, fn_name, argtypes, restype=_I):
    """The C entry point `fn_name` of ``csrc/<lib_name>.cu`` (built and
    loaded on first use) with its ctypes signature declared."""
    lib = _build.load(lib_name)
    fn = getattr(lib, fn_name)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = restype
        lib.cuda_error_string.argtypes = [_I]
        lib.cuda_error_string.restype = ctypes.c_char_p
    return lib, fn


def occupancy(lib_name, fn_name, *args):
    """What a kernel entry launches for the int `args` on the current
    card, from its occupancy entry `fn_name`: ``{registers, local_bytes,
    threads, smem_bytes, blocks_per_sm}`` (a report; no op calls it)."""
    lib, fn = bind(lib_name, fn_name, [_I] * len(args) + [_P])
    out = (ctypes.c_int * 5)()
    err = fn(*args, out)
    if err != 0:
        raise RuntimeError(f"{fn_name}: {lib.cuda_error_string(err).decode()}")
    return dict(zip(("registers", "local_bytes", "threads", "smem_bytes",
                     "blocks_per_sm"), out))


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
