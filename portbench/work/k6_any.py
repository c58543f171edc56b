"""K6's any-hit work (the shadow rays of one wavefront bounce toward one
light over a large scene, one launch per light, bounce and frame): what
the problem needs, counted from the shapes and the plain reference's ray
classes, never from the kernel's tree, clusters, visits or the rays the
program hands it.

Bytes: each shadow ray the problem needs, one per light for each ray
whose path goes on after the bounce (``Counts.on[b]``), read once
(origin, direction, limit: 28 B) and its answer written (4 B); every
triangle read once a launch (v0, e1, e2: 36 B). Operations: 45 for each
blocked shadow ray (``on x L - sum(Counts.seen[b])``, as work/k1k2.py
counts them): the first occluder's accepted Möller-Trumbore test, which
ends the search.

Both undercount, so the share reads low and never above the roofline:
the program hands every lane of the wavefront to each launch, those whose
path ended too; the tree's boxes are not counted; a blocked ray may test
triangles before its first occluder, and a ray that reaches its light is
tested against every triangle whose box it meets, none of which the
reference's counts show. The launches of one bounce split its blocked
rays evenly over the lights (the counts keep them by light type, not by
light).

``seconds`` is the device time of the any-hit launches in a trace: the
instances of ``clustered_kernel`` whose template argument is ``true``
(``clustered_kernel<true>``); the closest-hit ones are ``<false>``.
"""

MT_FLOPS = 45
RAY_IN, RAY_OUT, TRI = 28, 4, 36
KERNEL = "clustered_kernel"


def launch(c, b: int, per: int, triangles: int, lights: int):
    """(bytes, operations) of one light's launch at bounce ``b``: the counts
    ``c`` (a reference.tracer.Counts) over ``per`` frames of that bounce."""
    on = c.on[b] / per
    blocked = (c.on[b] * lights - sum(c.seen[b].values())) / per
    return on * (RAY_IN + RAY_OUT) + triangles * TRI, blocked / lights * MT_FLOPS


def count(ctx):
    """[(bytes, operations)] of one image's any-hit launches: the counts of
    the checked images, per image, spread evenly over each bounce's frames;
    none without shadow rays."""
    c, s = ctx.counts, ctx.settings
    if not s.shadow_rays:
        return []
    images = max(1, int(ctx.numbers.get("_images", 1)))
    frames = int(ctx.cell.traffic.get("frames", 1)) * s.spp
    lights = len(ctx.cell.config["scene"]["lights"])
    out = []
    for b in range(s.bounces):
        out += [launch(c, b, images * frames, ctx.triangles, lights)] * (lights * frames)
    return out


def mode(name: str):
    """True for an any-hit instance of K6 (``clustered_kernel<true>``),
    False for a closest-hit one, None for any other kernel."""
    i = name.find(KERNEL + "<")
    if i < 0:
        return None
    return {"true": True, "false": False}.get(name[i + len(KERNEL) + 1:].split(">", 1)[0])


def seconds(trace, any_hit: bool = True) -> float:
    """Device seconds of K6's any-hit (or closest-hit) launches in a trace."""
    return sum((b - a) / 1e9 for n, a, b in trace.device if mode(n) is any_hit)
