"""The device an entry point was asked for."""

import torch


def check_device(device):
    """torch.device(device); raises if it is a CUDA device and there is
    none (nothing falls back to the CPU)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device {} was asked for, but "
                           "torch.cuda.is_available() is false; pass "
                           "device='cpu' to run on the CPU".format(device))
    return device
