"""Device resolution for the port's entry points."""
from __future__ import annotations

import contextlib
from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]]) -> torch.device:
    """``None`` means the card. Without a CUDA device, only an explicit
    CPU request is honoured: nothing falls back to the CPU quietly. An
    explicit ``"meta"`` gives shapes without data (a dispatch census at
    no cost)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: pass device='cpu' to run on the CPU")
        if dev.index is None:        # "cuda" and "cuda:<current>" agree
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type not in ("cpu", "meta"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def on_device(x, device: torch.device) -> torch.Tensor:
    """``x`` as a tensor on ``device``: a tensor is moved (nothing happens
    where it already lies, so a captured step body may call this), other
    data is copied up."""
    if isinstance(x, torch.Tensor):
        return x.to(device)
    return torch.as_tensor(x, device=device)


def on_stream(stream: Optional["torch.cuda.Stream"]):
    """A context that makes ``stream`` the current CUDA stream of the
    calling thread (nothing for ``None``, an engine on the CPU)."""
    if stream is None:
        return contextlib.nullcontext()
    return torch.cuda.stream(stream)
