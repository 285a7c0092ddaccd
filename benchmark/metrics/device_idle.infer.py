"""Share of the traced stretch in which no operation ran on the device,
in %: 1 - busy / window, over a few batches traced without stacks."""


def read(ctx):
    if not ctx.window_s or not ctx.busy_s:
        return None
    return 100.0 * (1.0 - ctx.busy_s / ctx.window_s)
