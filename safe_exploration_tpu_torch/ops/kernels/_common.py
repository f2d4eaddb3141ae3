"""Argument checks and launch plumbing shared by the kernel wrappers."""

from __future__ import annotations

import ctypes

import torch

__all__ = ["VP", "INT", "check", "is_f64", "on_cuda", "raise_on_error",
           "stream_ptr"]

VP = ctypes.c_void_p
INT = ctypes.c_int


def on_cuda(*tensors: torch.Tensor) -> bool:
    """True when every tensor is on one CUDA device, False when all are on
    the CPU; raises on a mix or on any other device."""
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"tensors on different devices: {sorted(map(str, devices))}")
    dev = devices.pop()
    if dev.type == "cpu":
        return False
    if dev.type == "cuda":
        return True
    raise ValueError(f"unsupported device {dev}")


def check(name: str, *tensors: torch.Tensor) -> None:
    """Same float dtype (f32 or f64) and contiguous, for a kernel launch."""
    dtypes = {t.dtype for t in tensors}
    if len(dtypes) != 1 or dtypes.pop() not in (torch.float32, torch.float64):
        raise TypeError(f"{name}: needs one dtype, float32 or float64; got "
                        f"{[t.dtype for t in tensors]}")
    for t in tensors:
        if not t.is_contiguous():
            raise ValueError(f"{name}: inputs must be contiguous")


def is_f64(t: torch.Tensor) -> int:
    return int(t.dtype == torch.float64)


def stream_ptr(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def raise_on_error(name: str, code: int) -> None:
    if code != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError {code}")
