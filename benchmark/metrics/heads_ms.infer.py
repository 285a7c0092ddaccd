"""Device milliseconds an image that the trace's stage attribution
(trace.py, STAGES) puts in the 'heads' stage, over the batches traced
with stacks."""

STAGE = "heads"


def read(ctx):
    seconds = ctx.stage_s.get(STAGE)
    if not seconds or not ctx.stage_images:
        return None
    return 1e3 * seconds / ctx.stage_images
