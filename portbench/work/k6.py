"""K6's work (the closest hit of one wavefront bounce over a large
scene, one launch per bounce and frame): what the problem needs, counted
from the shapes and the plain reference's rays, never from the kernel's
tree, clusters or visits.

Bytes: each ray the bounce traces (alive before it) read once (origin,
direction, limit: 28 B) and its (t, winner) written (8 B); each ray with a
winner also gets the winner's 34-float shading row (136 B); every
triangle read once (v0, e1, e2: 36 B). Operations: 45 for each (ray,
triangle) pair that the exact Möller-Trumbore test accepts below the
ray's limit.
"""

MT_FLOPS = 45
RAY_IN, RAY_OUT, ROW, TRI = 28, 8, 136, 36


def count(ctx):
    """[(bytes, operations)] of one image's K6 launches: the counts of the
    checked images, per image, spread evenly over each bounce's frames."""
    c, s = ctx.counts, ctx.settings
    images = max(1, int(ctx.numbers.get("_images", 1)))
    frames = int(ctx.cell.traffic.get("frames", 1)) * s.spp
    out = []
    for b in range(s.bounces):
        live = (c.rays[b] - c.dead[b]) / (images * frames)
        hits = c.live[b] / (images * frames)
        pairs = c.accepted_pairs[b] / (images * frames)
        nbytes = live * (RAY_IN + RAY_OUT) + hits * ROW + ctx.triangles * TRI
        out += [(nbytes, pairs * MT_FLOPS)] * frames
    return out
