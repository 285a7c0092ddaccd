"""Host syncs a batch: the program's own count of the reads that wait for
the device (detectron_tpu_torch/utils/tracing.py, its `sync.*` counters:
a read of a device value on the host, or a blocking copy from pageable
host memory), over its detect_graph calls (`call.detect_graph`), through
the run so far: warm-up, window and traced stretch, every call on the
cell's own shapes. None for a program without the counters."""


def read(ctx):
    try:
        from detectron_tpu_torch.utils import tracing
    except ImportError:
        return None
    counts = tracing.counts()
    calls = counts.get("call.detect_graph")
    if not calls:
        return None
    return sum(v for k, v in counts.items() if k.startswith("sync.")) / calls
