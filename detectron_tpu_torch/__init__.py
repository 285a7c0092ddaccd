"""detectron_tpu_torch — the PyTorch + CUDA port of detectron_tpu.

The JAX package (detectron_tpu/) stays the reference. This package runs the
same model on an NVIDIA H100 in eager PyTorch, with the same cfg surface
(its own copy of the config module, with a cfg object of its own), the
same params tree (JAX layout, carried over by models/bridge.py) and the same
public layouts (NHWC activations, (B, R, 4) boxes in scaled-image
coordinates, the same output dict as detect_graph). It runs Mask R-CNN
R-50-FPN inference (core/test.py::detect_graph) and the training step
(parallel/train_step.py::train_step), on one device or on a world of
processes, one per device (parallel/mesh.py).

Each Pallas kernel on the ported path is a hand-written CUDA kernel for
sm_90a under csrc/, built with nvcc at first use and bound through ctypes
(ops/cuda/). Beside each kernel its wrapper module keeps a plain PyTorch
version of the same function; the wrapper runs that plain version only for
tensors on the CPU, and for a CUDA tensor launches the kernel or raises.

This package never imports jax or detectron_tpu. Its entry points run on
the card unless the caller passes CPU tensors.
"""

__version__ = "0.1.0"
