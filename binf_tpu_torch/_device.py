"""Where an entry point runs: the card unless the caller asks for the CPU."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means ``"cuda"``, resolved to the current card's index.  A
    CUDA device with no card present raises: the port never falls back to
    the CPU on its own."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type != "cuda":
        return dev
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the plain "
            "PyTorch versions on the CPU"
        )
    # "cuda" names the current card; tensors report it with its index
    return dev if dev.index is not None else torch.device("cuda", torch.cuda.current_device())
