"""A model of the cluster-traversal kernel's walk (``csrc/clustered.cu``)
in PyTorch, vectorised over rays, for the tests and the smoke run.

``walk`` repeats the kernel step by step: the root's slab test, then per
inner node the slab tests at t_init of its children that exist (all
ARITY of an inner level, the real leaf rows of the last), the hit
children sorted by (entry, index) with the kernel's compare-exchange
network, the nearest entered at once and the others pushed far to near;
per cluster the Möller–Trumbore tests of its real slots in slot order
with the tie rule; then the next node popped. No node is culled by the
best t found so far: the walk visits every cluster that the plain
version tests, and any mode ends at the first hit. It returns the
kernel's (t, slot) and its counts. Arithmetic is float32 in the kernel's
operation order, so on the same inputs the counts are the kernel's
exactly.
"""

from __future__ import annotations

import torch

from ..intersect import ray_triangle_edges
from .clustered import ARITY, CLUSTER, LANES, ClusteredGeometry, _inverse, _NO_KEY

_INF = float("inf")
_CHUNK = 1 << 15


def _slab_rows(rows, o, inv, t_far):
    """(entry [n, k], hit [n, k]) of each ray's own k boxes ``rows`` [n, k,
    8] (csrc/traverse.cuh slab, clustered._slab's operation order)."""
    t1 = (rows[..., 0:3] - o[:, None]) * inv[:, None]
    t2 = (rows[..., 3:6] - o[:, None]) * inv[:, None]
    lo, hi = torch.minimum(t1, t2), torch.maximum(t1, t2)
    tmin = torch.maximum(torch.maximum(lo[..., 0], lo[..., 1]), lo[..., 2])
    tmax = torch.minimum(torch.minimum(hi[..., 0], hi[..., 1]), hi[..., 2])
    entry = torch.clamp(tmin, min=0.0)
    return entry, torch.minimum(tmax, t_far[:, None]) >= entry


class _Walk:
    """The state of a walk over one chunk of rays."""

    def __init__(self, cg: ClusteredGeometry, o, d, t_init, backface_cull: bool,
                 any_hit: bool):
        self.cg, self.o, self.d = cg, o, d
        self.cull, self.any = backface_cull, any_hit
        self.inv = _inverse(d)
        R = o.shape[0]
        self.t_init = t_init
        self.best = t_init.clone()
        self.slot = torch.full((R,), -1, dtype=torch.int64, device=o.device)
        self.stats = torch.zeros((R, 3), dtype=torch.int64, device=o.device)
        self.found = torch.zeros((R,), dtype=torch.bool, device=o.device)
        self.lane = torch.arange(CLUSTER, device=o.device)

    def bound(self, r):
        """The limit of rays ``r``'s slab tests: their t_init."""
        return self.t_init[r]

    def visit(self, r, c) -> None:
        """Rays ``r`` each test the real slots of their cluster ``c``."""
        cg = self.cg
        slots = c[:, None] * CLUSTER + self.lane
        count = cg.cl_count[c].to(torch.int64)
        rec = cg.tris[slots]
        t, _, _, valid = ray_triangle_edges(self.o[r][:, None], self.d[r][:, None],
                                            rec[..., 0:3], rec[..., 3:6], rec[..., 6:9],
                                            self.cull)
        valid = valid & (self.lane < count[:, None])
        best, cur = self.best[r], self.slot[r]
        self.stats[r, 1] += 1
        pick = lambda x, k: x.gather(1, k[:, None])[:, 0]
        if self.any:
            # The first slot below the limit ends the walk, at the end of
            # the round of LANES slots that holds it.
            ok = valid & (t < best[:, None])
            has = ok.any(dim=1)
            first = ok.to(torch.int32).argmax(dim=1)
            done = torch.minimum(count, (first // LANES + 1) * LANES)
            self.stats[r, 0] += torch.where(has, done, count)
            self.best[r] = torch.where(has, pick(t, first), best)
            self.slot[r] = torch.where(has, pick(slots, first), cur)
            self.found[r] |= has
            return
        # In slot order the kernel keeps the least (t bits, id) key of the
        # slots with t < best, or t == best once it holds a winner.
        self.stats[r, 0] += count
        ids = cg.slot_to_tri.to(torch.int64)
        cand = valid & ((t < best[:, None]) | ((t == best[:, None]) & (cur >= 0)[:, None]))
        key = (t.contiguous().view(torch.int32).to(torch.int64) << 32) | ids[slots]
        kmin, pos = torch.where(cand, key, torch.full_like(key, _NO_KEY)).min(dim=1)
        cur_key = torch.where(
            cur >= 0, (best.view(torch.int32).to(torch.int64) << 32) | ids[cur.clamp(min=0)],
            torch.full_like(cur, _NO_KEY))
        take = kmin < cur_key
        self.best[r] = torch.where(take, pick(t, pos), best)
        self.slot[r] = torch.where(take, pick(slots, pos), cur)

    def run(self) -> None:
        cg = self.cg
        R, dev = self.o.shape[0], self.o.device
        n_inner = cg.tree.shape[0]
        n_rows = n_inner + cg.cl_count.shape[0]
        depth = cg.depth
        stk_node = torch.zeros((R, (ARITY - 1) * depth + 1), dtype=torch.int64, device=dev)
        sp = torch.zeros((R,), dtype=torch.int64, device=dev)
        every = torch.arange(R, device=dev)
        _, hit = _slab_rows(cg.tree[None, 0:1].expand(R, 1, 8), self.o, self.inv,
                            self.bound(every))
        self.stats[:, 2] = 1
        node = torch.where(hit[:, 0], 0, -1)
        kids = torch.arange(ARITY, device=dev)
        while True:
            inner = (node >= 0) & (node < n_inner)
            leaf = node >= n_inner
            if not bool((inner | leaf).any()):
                return
            pop = torch.zeros((R,), dtype=torch.bool, device=dev)
            r = inner.nonzero()[:, 0]
            if r.numel():
                ids = node[r, None] * ARITY + 1 + kids
                # Children past the last real leaf row are not tested.
                is_node, is_leaf = ids < n_inner, (ids >= n_inner) & (ids < n_rows)
                rows = cg.tree.new_zeros(ids.shape + (8,))
                rows[is_node] = cg.tree[ids[is_node]]
                rows[is_leaf] = cg.cl_aabb[ids[is_leaf] - n_inner]
                entry, h = _slab_rows(rows, self.o[r], self.inv[r], self.bound(r))
                h &= is_node | is_leaf
                self.stats[r, 2] += (is_node | is_leaf).sum(dim=1)
                key = torch.where(h, entry, torch.full_like(entry, _INF))
                for m in range(1, ARITY):          # the kernel's network
                    for k in range(m, 0, -1):
                        sw = key[:, k - 1] > key[:, k]
                        for a in (key, ids):
                            lo_, hi_ = a[:, k - 1].clone(), a[:, k].clone()
                            a[:, k - 1] = torch.where(sw, hi_, lo_)
                            a[:, k] = torch.where(sw, lo_, hi_)
                for k in range(ARITY - 1, 0, -1):  # far to near
                    m = key[:, k] != _INF
                    rr = r[m]
                    stk_node[rr, sp[rr]] = ids[m, k]
                    sp[rr] += 1
                go = key[:, 0] != _INF
                node[r] = torch.where(go, ids[:, 0], -1)
                pop[r] = ~go
            r = leaf.nonzero()[:, 0]
            if r.numel():
                self.visit(r, node[r] - n_inner)
                node[r] = -1
                pop[r] = True
                if self.any:
                    pop &= ~self.found
            r = (pop & (sp > 0)).nonzero()[:, 0]
            sp[r] -= 1
            node[r] = stk_node[r, sp[r]]


def walk(cg: ClusteredGeometry, o, d, t_init, backface_cull: bool = False,
         any_hit: bool = False):
    """The kernel's walk over rays o, d [R, 3] below ``t_init`` [R]: (t
    [R], slot [R] int32, -1 and t_init on a miss, stats [R, 3] int32:
    Möller–Trumbore tests, cluster visits and box tests per ray). In any
    mode only ``slot >= 0`` is defined, as in the kernel."""
    out = []
    for s0 in range(0, o.shape[0], _CHUNK):
        w = _Walk(cg, *(a[s0:s0 + _CHUNK] for a in (o, d, t_init)), backface_cull, any_hit)
        w.run()
        out.append((w.best, w.slot, w.stats))
    if not out:
        z = o.new_zeros((0,))
        return z, z.to(torch.int32), o.new_zeros((0, 3), dtype=torch.int32)
    t, slot, stats = (torch.cat(x) for x in zip(*out))
    return t, slot.to(torch.int32), stats.to(torch.int32)
