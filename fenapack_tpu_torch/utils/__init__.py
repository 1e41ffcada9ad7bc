import torch


def default_dtype(device, cuda: str = "mixed") -> str:
    """The entry points' ``--dtype`` when none is given, picked by device as
    the JAX demos pick it by backend: ``float64`` on the CPU, ``cuda`` (the
    entry point's own choice, ``mixed`` or ``float32``) on a CUDA device."""
    return "float64" if torch.device(device).type == "cpu" else cuda
