"""Replacement reads of the survivor gather (gather.replace stages) per
GET that decoded on the fly: how long a chain of failed reads a degraded
GET sits behind. Nothing where no GET span holds a replacement or a decode."""


def read(ctx):
    gets = [s for s in ctx["spans"] if s["op"] == "access.get"]
    replaced = sum(n == "gather.replace" for s in gets for n, _, _ in s["stages"])
    degraded = sum(any(n == "decode" for n, _, _ in s["stages"]) for s in gets)
    if replaced == 0 or degraded == 0:
        return None
    return replaced / degraded
