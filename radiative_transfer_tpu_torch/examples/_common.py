"""What the examples share: the shipped decks, the device, and the kernel
wrappers' launch counts."""

from __future__ import annotations

import argparse
import os

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def deck(name: str) -> str:
    """Path of a shipped deck in the repo's prm/."""
    return os.path.join(ROOT, "prm", name)


def add_device(ap: argparse.ArgumentParser) -> None:
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="run on the card (default) or on the CPU")


def device_of(name: str) -> torch.device:
    """`name` as a torch.device; ``cuda`` without a card raises."""
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device; pass --device cpu to run on the "
                           "CPU")
    return dev


def sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _wrapper_modules():
    from ..ops import cuda_adjoint, cuda_df, cuda_fused, cuda_sweep

    return cuda_sweep, cuda_df, cuda_adjoint, cuda_fused


def reset_launch_counts() -> None:
    """Zero every kernel wrapper's launch count."""
    for mod in _wrapper_modules():
        mod.reset_launch_counts()


def launch_counts() -> dict:
    """{wrapper name: launches} of every wrapper that launched since the
    last reset_launch_counts()."""
    out = {}
    for mod in _wrapper_modules():
        for name, obj in vars(mod).items():
            n = getattr(obj, "launches", 0)
            if callable(obj) and name.endswith("_launch") and n:
                out[name] = n
    return out
