"""K1 / K2's work (the fused forward of the mega path: K1 the first
bounce with its raygen, K2 each later bounce; one launch per bounce and
frame): bytes and float operations the problem needs, counted from the
cell's shapes and the plain reference's ray classes, never from the
kernels' tiles, culls or counters.

Bytes, by ray class (``chip_smoke.fwd_bytes``): K1 reads a ray's pixel
id and writes its state (o, d, beta, alive, radiance, winner, occlusion
bits, seed: 64 B), 68 B a ray; K2 reads a ray that is not alive's alive
and (o, d, beta) and writes its pass-through (o, d, beta, radiance,
alive, winner, occlusion bits), 100 B, and a ray alive also its seed,
104 B. The occlusion bits (one word a ray, a bit a light) are in the
state each writes. Once a launch: each triangle's (v0, e1, e2) that the
tests read (36 B) and its 28-float shading row (112 B), and each light's
10 floats (40 B).

Operations (each +, -, *, /, min, max, compare-select, sqrt, pow counts
one; a dot 5, a normalize 11): 45 for each (ray, triangle) pair that
the exact Möller-Trumbore test accepts below the ray's limit, on the
rays alive before the bounce; per light that a ray whose path goes on
sees, the light's weight (``FLOPS[type]``) and, with direct specular,
its specular term (``FLOPS["dspec"]``). k4.py's table counts a light's
weight with its adjoint, several times the forward's; these are the
forward's alone, by the same rule. With shadow rays, each shadow ray
that finds an occluder counts one accepted pair (45): the first occluder
ends an any-hit search, so at least one test is run, and the reference's
counts (``Counts.seen``) do not show how many a search needs before it.
A shadow ray that reaches its light counts nothing here, though it is
tested against every triangle that is not culled: the counts show none
of those tests, which no occluder accepts. Both undercount, so the share
reads low, never above the roofline.
"""

MT_FLOPS = 45
FLOPS = {"point": 26, "spot": 49, "directional": 20, "dspec": 27}
RAY0, DEAD, ALIVE = 68, 100, 104
TRI, ROW, LIGHT = 36, 112, 40


def launch(s, c, b: int, per: int, triangles: int, lights: int):
    """(bytes, operations) of one launch at bounce ``b``: the counts ``c``
    (a reference.tracer.Counts) over ``per`` launches of that bounce."""
    rays, dead = c.rays[b] / per, c.dead[b] / per
    if b == 0:
        nbytes = rays * RAY0
    else:
        nbytes = dead * DEAD + (rays - dead) * ALIVE
    nbytes += triangles * (TRI + ROW) + lights * LIGHT
    dspec = FLOPS["dspec"] if s.direct_specular else 0
    seen = sum(n * (FLOPS[kind] + dspec) for kind, n in c.seen[b].items())
    pairs = c.accepted_pairs[b]
    if s.shadow_rays:
        pairs += c.on[b] * lights - sum(c.seen[b].values())
    return nbytes, (pairs * MT_FLOPS + seen) / per


def count(ctx):
    """[(bytes, operations)] of one image's K1 / K2 launches: the counts of
    the checked images, per image, spread evenly over each bounce's
    frames."""
    c, s = ctx.counts, ctx.settings
    images = max(1, int(ctx.numbers.get("_images", 1)))
    frames = int(ctx.cell.traffic.get("frames", 1)) * s.spp
    lights = len(ctx.cell.config["scene"]["lights"])
    out = []
    for b in range(s.bounces):
        out += [launch(s, c, b, images * frames, ctx.triangles, lights)] * frames
    return out
