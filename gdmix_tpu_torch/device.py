"""Device selection and small shape helpers."""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """`device` as a torch.device; by default the current card (the first,
    or the one a multi-process job gave this process:
    workflow/distributed.py maybe_initialize_distributed), and an error
    when there is none. The CPU, where every kernel wrapper takes its plain
    PyTorch version, is had only by asking for it (device="cpu", or
    --device=cpu on the command lines)."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: gdmix_tpu_torch runs on a card unless the CPU "
            "is asked for (device='cpu', or --device=cpu on the command "
            "line)")
    return torch.device("cuda", torch.cuda.current_device())


def pop_device_flag(argv):
    """(argv without its --device=<d> / --device <d> flags, the last <d> or
    None): the trainer's flags go to the params parsers without it."""
    rest, device, it = [], None, iter(argv)
    for a in it:
        if a == "--device":
            device = next(it, None)
        elif a.startswith("--device="):
            device = a.split("=", 1)[1]
        else:
            rest.append(a)
    return rest, device


def pad_to_multiple(n: int, multiple: int) -> int:
    return ((n + multiple - 1) // multiple) * multiple
