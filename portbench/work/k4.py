"""K4's work (the backward of bounces 1 .. B-1, one launch each): bytes
and float operations the problem needs, counted by ray class from the
plain reference's own per-bounce state (never from the program's).

Bytes: a dead ray reads alive and the (o, d, beta) cotangents and writes
d(o, d, beta) (76 B); an alive ray that misses also reads its winner and
the radiance cotangent (92 B); a ray with a winner reads its state (o, d,
beta, alive, seed, winner, and occlusion with shadow rays) and the four
cotangents, and writes d(o, d, beta).

Operations (each +, -, *, /, min, max, compare-select, sqrt, exp, log,
sin, cos, pow counts one; a dot 5, a cross 9, a normalize 11, a
normalize's adjoint 30): per ray with a winner the winner point and its
adjoint, the next-ray update and the emission (LIVE), plus the BRDF
sample of its lobe; per path that goes on the adjoint's head and the
basis's adjoint (ON), the lobe's adjoint, and per light it sees the
light's weight and adjoint (and direct specular's); soft edges per live
ray.
"""

FLOPS = {"live": 303, "diffuse": 77, "blinn": 165, "ggx": 170, "on": 145,
         "diffuse_adj": 67, "blinn_adj": 266, "ggx_adj": 282, "point": 159, "spot": 219,
         "directional": 119, "dspec": 113, "soft": 58}


def launch(s, c, b: int):
    """(bytes, operations) of the backward of bounce ``b`` on the rays of
    ``c`` (a reference.tracer.Counts)."""
    occ = 4 if s.shadow_rays else 0
    alive = c.rays[b] - c.dead[b]
    nbytes = c.dead[b] * 76 + (alive - c.live[b]) * 92 + c.live[b] * (48 + occ + 48 + 36)
    lobe = "ggx" if s.specular_model == "ggx" else "blinn"
    soft = FLOPS["soft"] if s.soft_edge_sigma > 0 else 0
    dspec = FLOPS["dspec"] if s.direct_specular else 0
    live_spec, on_spec = c.live_spec[b], c.on_spec[b]
    ops = c.live[b] * (FLOPS["live"] + soft)
    ops += (c.live[b] - live_spec) * FLOPS["diffuse"] + live_spec * FLOPS[lobe]
    ops += (c.on[b] * FLOPS["on"] + (c.on[b] - on_spec) * FLOPS["diffuse_adj"]
            + on_spec * FLOPS[lobe + "_adj"])
    ops += sum(n * (FLOPS[kind] + dspec) for kind, n in c.seen[b].items())
    return nbytes, ops


def count(ctx):
    """[(bytes, operations)] of one training step's K4 launches."""
    return [launch(ctx.settings, ctx.counts, b) for b in range(1, ctx.settings.bounces)]
