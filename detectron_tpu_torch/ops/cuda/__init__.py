"""Wrappers of the port's hand-written CUDA kernels (sources in csrc/).

Each wrapper module holds the kernel's wrapper and, beside it, a plain
PyTorch version of the same function. The wrapper runs the plain version
only for tensors on the CPU; for CUDA tensors it launches the kernel (on
the current stream) or raises. Each wrapper counts its launches in a plain
integer attribute, `<wrapper>.launches`.
"""

# Names of the port's CUDA kernels (csrc/*.cu), as the profiler lists them.
# K4's deterministic variant: its pre-pass (reach, scan, fill) and its
# accumulate.
DET_KERNELS = ("roi_reach_kernel", "roi_tile_scan_kernel",
               "roi_tile_fill_kernel", "roi_window_accum_det_kernel")
PORT_KERNELS = ("nms_iou_mask_kernel", "nms_scan", "roi_window_pool_kernel",
                "roi_window_accum_kernel", "stem_pool",
                "fused_res2") + DET_KERNELS
