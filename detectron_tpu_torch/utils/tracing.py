"""The port's spans and counters.

Spans. `span(name)` is a context manager, and `spanned(name)` the
decorator that wraps a whole function in it, that opens the profiler
range "dt.<name>" while a torch profiler records (torch.profiler.profile),
so its ranges land in the trace beside the kernels, on the profiler's
clock, and nothing else turns them on. With no profiler recording it
checks one flag and enters nothing. The innermost `dt.*` range open at
an instant names the stage the program is in (tools/trace_summary.py's
table by span):

    dt.detect_graph, dt.detect_raw,         the detection entry points
    dt.detect_graph_with_proposals          (core/test.py)
    dt.body, dt.fpn                         the conv body, the FPN
    dt.rpn, dt.proposals                    RPN head, proposal generation
    dt.roi_xform                            every RoI transform route
    dt.box_head, dt.mask_head, dt.kps_head  the heads and their outputs
    dt.tail                                 the detection tail: softmax,
                                            decode, NMS, top-D, and the
                                            mask and keypoint branches
                                            outside their heads and RoI
                                            transforms
    dt.train_step, dt.backward,             the training step
    dt.optimizer                            (parallel/train_step.py)

Counters. Plain integers by name, for this process: `sync.<site>` counts
the host syncs at `site`, the statements that wait for the device (a
read of a device value on the host, or a blocking copy from pageable
host memory; on a card each drains the stream, and the device then waits
for the host's next launches; the count is of the sites run, so a CPU
run counts them too). A site's name starts with its module's name. In a
trace each sync is a cudaStreamSynchronize call, which trace_summary
places in its span. `call.detect_graph` counts the detect_graph calls.
counts() adds the kernel wrappers' launch counts (ops/cuda) as
`launch.<wrapper>`; reset() zeroes them all.
"""

import collections
import contextlib
import functools

import torch

PREFIX = "dt."

_profiling = torch._C._autograd._profiler_enabled
_OFF = contextlib.nullcontext()
_counts = collections.Counter()


def span(name):
    """The profiler range PREFIX + name while a profiler records; else a
    context that does nothing."""
    if not _profiling():
        return _OFF
    return torch.profiler.record_function(PREFIX + name)


def spanned(name):
    """Decorator: runs the function inside span(name)."""
    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return inner
    return wrap


def sync(site, n=1):
    """Counts n host syncs at `site` (counter `sync.<site>`): call it
    beside the statements that wait for the device there."""
    _counts["sync." + site] += n


def count(name):
    """Adds 1 to the counter `name`."""
    _counts[name] += 1


def counts():
    """{name: count} of every counter, the kernel wrappers' launches as
    `launch.<wrapper>` among them."""
    from detectron_tpu_torch.ops import cuda

    out = dict(_counts)
    out.update(("launch." + k, v) for k, v in cuda.launch_counts().items())
    return out


def reset():
    """Zeroes every counter, the kernel wrappers' launch counts too."""
    from detectron_tpu_torch.ops import cuda

    _counts.clear()
    cuda.reset_launches()
