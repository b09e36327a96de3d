"""What a lost disk costs a whole-object read: each object's whole GET
after the loss over its whole GET before it, due to last byte, the median
over objects, the pairs due around the loss left out (layers.get_loss_x)."""

from benchmark import layers


def read(ctx):
    return layers.get_loss_x(ctx["records"], ctx.get("loss"))
