"""The whole batch's share of the card's dense peak, in %: the benchmark's
own FLOP count of an image (flops.py: convolutions and fully connected
layers at the slots the program runs) times the window's images a second,
over the peak of the configuration's compute dtype."""


def read(ctx):
    if not ctx.flops_per_image or not ctx.img_per_s:
        return None
    return 100.0 * ctx.flops_per_image * ctx.img_per_s / ctx.peak_flops
