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
                "fused_res2", "channel_epilogue_kernel") + DET_KERNELS


def wrappers():
    """{name: wrapper} of every kernel: K1-K6, K4's deterministic variant
    and the conv epilogue."""
    from detectron_tpu_torch.ops.cuda import channel_epilogue as ce
    from detectron_tpu_torch.ops.cuda import fused_stem_kernel as fk
    from detectron_tpu_torch.ops.cuda import nms_kernel
    from detectron_tpu_torch.ops.cuda import roi_align_kernel as rk

    return {"nms_keep_mask": nms_kernel.nms_keep_mask,
            "roi_window_pool": rk.roi_window_pool,
            "roi_window_pool_seg": rk.roi_window_pool_seg,
            "roi_window_accum": rk.roi_window_accum,
            "roi_window_accum_det": rk.roi_window_accum_det,
            "stem_pool": fk.stem_pool, "fused_res2": fk.fused_res2,
            "channel_epilogue": ce.channel_epilogue}


def reset_launches(names=None):
    """Sets to 0 the launch counts of the wrappers named (an iterable of
    wrappers() keys; every kernel's by default). Returns {name: wrapper}
    of them."""
    every = wrappers()
    chosen = {k: every[k] for k in (every if names is None else names)}
    for fn in chosen.values():
        fn.launches = 0
    return chosen


def launch_counts(names=None):
    """{name: launches} of the wrappers named (every kernel's by
    default)."""
    every = wrappers()
    return {k: every[k].launches for k in (every if names is None else names)}
