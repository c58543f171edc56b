"""Compiled programs: the port's counterpart of ``jax.jit``, on CUDA graphs.

``jit(fn, static_argnames=...)`` returns a callable that, on a CUDA
device, runs ``fn`` as a captured CUDA graph (``torch.cuda.CUDAGraph``)
and replays it on later calls, as ``jax.jit`` runs one executable per
key. The hand-written kernels and PyTorch's operations are captured as
they are, so a replay computes bitwise what an eager call computes on the
same inputs: the same kernels in the same order. ``torch.autograd.grad``
inside ``fn`` is captured too, so ``jit`` of a value-and-grad function
is one program of forward and backward.

The key (one graph each): the static arguments (hashable values such as
``cfg`` and ``frames``); the structure of the other arguments
(dataclasses, tuples, lists, dicts; their non-tensor leaves, such as None
or an accel's layout name, are part of it); the shape, dtype and device
of every tensor leaf; the light types of every ``Lights`` among them
(``ops/lights.light_types``, read on the host once per tensor, since the
integrator unrolls its light loop by type); and whether grad mode is on.

The first call with a key runs ``fn`` eagerly on the caller's arguments
and returns that result: the warm-up a capture needs (the kernels'
build, lazy caches, CUDA module loading, the autograd engine). Then
``fn`` is captured on copies of the tensor leaves, the graph's static
inputs, in a memory pool of its own. A later call copies its leaves'
values into the static inputs, replays, and returns clones of the
outputs, which the next replay cannot overwrite. A replay adds the
kernel launches that the capture recorded to ``ops/cuda/build.LAUNCHES``,
and the rays it handed them to ``build.RAYS``: the kernels' counters all
live there, so a new kernel adds nothing here.

What a graph freezes: every Python value ``fn`` computes with (an int
frame becomes a constant) and the addresses of tensors it closes over,
whose values it reads at each replay. A value that changes between calls
goes in as a tensor argument, as the frame of ``scan_frames`` does.

When a call is compiled (``Compiled.captures``): the device-mesh
static arguments (``DeviceMesh``, as the parallel paths take) add every
axis's group backend to the key, and ``comm.Axis.capturable`` says
whether a graph can hold its collectives.

==========  ==================  =================  ==========================
tensors     groups              what runs          why
==========  ==================  =================  ==========================
on CUDA     none, or all NCCL   a captured graph   the normal case
on the CPU  any                 eager              the caller asked for the CPU
on CUDA     a gloo group        eager, announced   gloo stages every collective
                                once on stderr     through host memory, which
                                                   no CUDA graph can hold
==========  ==================  =================  ==========================

Inside ``disable_jit()`` (``jax.disable_jit``) every compiled call runs
eagerly: the reference that a compiled call is held against.

A key with a group is captured with ``capture_error_mode="thread_local"``:
in the default global mode a CUDA call from another thread during the
capture, such as the NCCL watchdog's event queries, can abort it. The collectives'
byte counts (``comm.BYTES``) are counted like the launches: the capture's
are undone, and each replay adds them. A capture that fails raises;
nothing runs eagerly in place of a graph.

Spans and counts. While a profiler records (``torch.profiler.profile``),
a compiled call opens host ranges in its trace, on the clock of the
device's events: ``mrt.jit.call`` around every call outside
``disable_jit()``, and inside it ``mrt.jit.key`` (the key of the call),
then on a replay ``mrt.jit.copy_in`` (the leaves copied into the static
inputs), ``mrt.jit.launch`` (the graph's replay) and ``mrt.jit.outputs``
(the counts added, the outputs cloned); on a key's first call
``mrt.jit.warmup`` (the eager run that is returned) and
``mrt.jit.capture``; and ``mrt.jit.eager`` around a call that is not
captured. With no profiler recording a span is one shared no-op context.
``COUNTS`` is always kept and survives ``clear()``: ``replays``,
``copy_in_bytes`` and ``copy_in_leaves`` (added per replay), ``warmups`` /
``warmup_s`` and ``captures`` / ``capture_s`` (host seconds, the device
synchronised on both sides of each, on a key's first call only), and
``eager``, the calls that ran without a graph (on the CPU, or on CUDA
over a gloo group); and ``<name>_rays`` for each name of
``build.RAYS`` (``clustered_closest_rays`` / ``clustered_any_rays``, the
rays handed to K6; ``shade_fused_rays`` / ``shade_adjoint_rays`` /
``shade_plain_rays``, the rays the wavefront shaded in its fused kernel,
differentiated in its adjoint kernel and shaded in PyTorch;
``mega_fwd_rays`` / ``mega_shadow_rays``, the rays handed to K1 / K2 and
those times the lights where they cast shadow rays; ``wave_shadow_rays``,
the shadow-ray slots the wavefront's light loop hands its any-hit
intersector), the rays that a key's capture counted, added per replay:
over ``replays``, a steady call's rays, which no eager call dilutes. The
benchmark (``portbench/metrics/jit_*``, ``k6_ns_per_ray.render``,
``k6_any_ns_per_ray.render``, ``k1k2_ns_per_ray.render``) reads the
spans from its trace and ``COUNTS`` after its window.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import functools
import inspect
import sys
import time
from typing import Any, Callable, Iterator, List, Tuple

import torch
import torch.autograd.profiler as _profiler
from torch.distributed.device_mesh import DeviceMesh

from .models.scene import Lights
from .ops import lights as lights_mod
from .ops.cuda import build
from .parallel import comm

# The counters whose captured counts a replay adds again.
_COUNTERS = (build.LAUNCHES, build.RAYS, comm.BYTES)
_LEAF = "tensor"
_CONST = "const"
# (function, staged groups) already announced by Compiled._announce.
_ANNOUNCED = set()
# Whether disable_jit() is in force.
_disabled = False
# Work of the compiled calls, always counted (see the module note).
COUNTS = {"replays": 0, "copy_in_bytes": 0, "copy_in_leaves": 0, "warmups": 0,
          "warmup_s": 0.0, "captures": 0, "capture_s": 0.0, "eager": 0,
          **{k + "_rays": 0 for k in build.RAYS}}
# The lightest host range of the profiler's trace that this torch has.
_RANGE = getattr(torch._C._profiler, "_RecordFunctionFast", torch.profiler.record_function)
_OFF = contextlib.nullcontext()


def _span(name: str):
    """A range named ``name`` in the trace of the profiler that records,
    or, with none recording, the shared no-op context."""
    if _profiler._is_profiler_enabled:
        return _RANGE(name)
    return _OFF


def _sync(device: torch.device) -> None:
    """Wait for ``device``'s work (around a key's warm-up and capture)."""
    torch.cuda.synchronize(device)


def flatten(tree) -> Tuple[List[torch.Tensor], Any]:
    """(tensor leaves in order, hashable structure). Dataclasses, tuples
    (named ones too), lists and dicts are nodes; any other value is a
    constant of the structure and must be hashable."""
    leaves: List[torch.Tensor] = []
    return leaves, _walk(tree, leaves)


def _walk(x, leaves: List[torch.Tensor]):
    if isinstance(x, torch.Tensor):
        leaves.append(x)
        return _LEAF
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        names = tuple(f.name for f in dataclasses.fields(x))
        return (type(x), names, tuple(_walk(getattr(x, n), leaves) for n in names))
    if isinstance(x, (tuple, list)):
        return (type(x), None, tuple(_walk(v, leaves) for v in x))
    if isinstance(x, dict):
        names = tuple(x)
        return (dict, names, tuple(_walk(x[n], leaves) for n in names))
    hash(x)   # a static value must be hashable to key a graph
    return (_CONST, type(x), x)


def unflatten(treedef, leaves) -> Any:
    """Inverse of ``flatten``: the structure with ``leaves`` in order.
    Module-level recursion, not a closure that calls itself: such a closure
    is a reference cycle that would keep ``leaves`` (a replay's output
    clones) alive until the garbage collector runs."""
    return _build(treedef, iter(leaves))


def _build(d, it):
    if d == _LEAF:
        return next(it)
    if d[0] == _CONST:
        return d[2]
    cls, names, kids = d
    vals = [_build(k, it) for k in kids]
    if cls is dict:
        return dict(zip(names, vals))
    if dataclasses.is_dataclass(cls):
        return cls(**dict(zip(names, vals)))
    if hasattr(cls, "_fields"):
        return cls(*vals)
    return cls(vals)


def _lights_in(tree) -> Iterator[Lights]:
    """Every ``Lights`` of a tree, in ``flatten``'s order."""
    if isinstance(tree, Lights):
        yield tree
    elif dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        for f in dataclasses.fields(tree):
            yield from _lights_in(getattr(tree, f.name))
    elif isinstance(tree, (tuple, list)):
        for v in tree:
            yield from _lights_in(v)
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _lights_in(v)


def _snapshot():
    return [dict(c) for c in _COUNTERS]


@contextlib.contextmanager
def _capture(graph, device: torch.device, mode: str):
    """Capture into ``graph`` on ``device`` (``capture_error_mode``)."""
    with torch.cuda.device(device), torch.cuda.graph(graph, capture_error_mode=mode):
        yield


class _Program:
    """One captured graph: its static inputs, outputs, and the counts that
    a replay adds."""

    def __init__(self, compiled: "Compiled", static: dict, treedef, leaves, types,
                 device: torch.device, mode: str):
        self.inputs = [t.detach().clone() for t in leaves]
        dynamic = unflatten(treedef, self.inputs)
        for lights, ty in zip(_lights_in(dynamic), types):
            lights_mod.remember_light_types(lights.light_type, ty)
        args = compiled._bind({**dynamic, **static})
        before = _snapshot()
        self.graph = torch.cuda.CUDAGraph()
        try:
            with _capture(self.graph, device, mode):
                out = compiled.fn(*args.args, **args.kwargs)
        except Exception as e:
            raise RuntimeError(f"jit: capturing {compiled.__qualname__} on {device} "
                               f"failed: {e}") from e
        finally:
            after = _snapshot()
            for counts, b in zip(_COUNTERS, before):
                counts.update(b)
        # (counter, name, count) of what a replay adds, worked out once.
        self.adds = [(COUNTS, "replays", 1),
                     (COUNTS, "copy_in_bytes", sum(t.nbytes for t in self.inputs)),
                     (COUNTS, "copy_in_leaves", len(self.inputs))]
        for counts, a, b in zip(_COUNTERS, after, before):
            self.adds += [(counts, k, a[k] - b[k]) for k in a if a[k] != b[k]]
            if counts is build.RAYS:
                self.adds += [(COUNTS, k + "_rays", a[k] - b[k]) for k in a if a[k] != b[k]]
        for counts, k, _ in self.adds:
            counts.setdefault(k, 0)
        self.out_leaves, self.out_def = flatten(out)

    def replay(self, leaves):
        with _span("mrt.jit.copy_in"):
            for static, x in zip(self.inputs, leaves):
                static.copy_(x)
        with _span("mrt.jit.launch"):
            self.graph.replay()
        with _span("mrt.jit.outputs"):
            for counts, k, v in self.adds:
                counts[k] += v
            return unflatten(self.out_def, [t.clone() for t in self.out_leaves])


class Compiled:
    """``fn`` as compiled programs, one per key (see the module note)."""

    def __init__(self, fn: Callable, static_argnames=()):
        self.fn = fn
        self._sig = inspect.signature(fn)
        self.static_argnames = tuple(static_argnames)
        unknown = set(self.static_argnames) - set(self._sig.parameters)
        if unknown:
            raise ValueError(f"static_argnames {sorted(unknown)} are not parameters of {fn}")
        self._programs = {}
        functools.update_wrapper(self, fn)

    def _bind(self, arguments: dict) -> inspect.BoundArguments:
        ordered = collections.OrderedDict(
            (n, arguments[n]) for n in self._sig.parameters if n in arguments)
        return inspect.BoundArguments(self._sig, ordered)

    def key(self, *args, **kwargs):
        """(key, tensor leaves, light types, device) of a call. The key's
        last entry holds (axis name, backend, capturable) of every
        dimension of the ``DeviceMesh`` static arguments."""
        bound = self._sig.bind(*args, **kwargs)
        bound.apply_defaults()
        static = tuple((n, bound.arguments[n]) for n in self.static_argnames)
        dynamic = {n: v for n, v in bound.arguments.items()
                   if n not in self.static_argnames}
        leaves, treedef = flatten(dynamic)
        devices = {t.device for t in leaves}
        if len(devices) != 1:
            raise ValueError(f"{self.__qualname__}: a compiled call takes tensor arguments "
                             f"on one device, got {sorted(map(str, devices))}")
        types = tuple(lights_mod.light_types(x) for x in _lights_in(dynamic))
        specs = tuple((tuple(t.shape), t.dtype) for t in leaves)
        hash(static)
        axes = [comm.Axis(v, name) for _, v in static if isinstance(v, DeviceMesh)
                for name in v.mesh_dim_names or ()]
        groups = tuple((a.name, a.backend, a.capturable) for a in axes)
        key = (static, treedef, specs, types, devices.pop(), torch.is_grad_enabled(), groups)
        return key, leaves, types, key[4]

    @staticmethod
    def captures(key) -> bool:
        """The rule of the module note: a graph for tensors on CUDA whose
        groups (if any) are all capturable; eager otherwise."""
        return key[4].type == "cuda" and all(c for _, _, c in key[6])

    def _announce(self, key) -> None:
        """Say once on stderr that a call on CUDA runs eagerly because of
        its host-transport groups."""
        staged = tuple((name, backend) for name, backend, c in key[6] if not c)
        if key[4].type != "cuda" or (self.__qualname__, staged) in _ANNOUNCED:
            return
        _ANNOUNCED.add((self.__qualname__, staged))
        names = ", ".join(f"{name} ({backend})" for name, backend in staged)
        print(f"[jit] {self.__qualname__} runs eagerly on {key[4]}: the groups of axes "
              f"{names} stage their collectives through host memory, which no CUDA "
              "graph can hold", file=sys.stderr, flush=True)

    def __call__(self, *args, **kwargs):
        if _disabled:
            return self.fn(*args, **kwargs)
        with _span("mrt.jit.call"):
            with _span("mrt.jit.key"):
                key, leaves, types, device = self.key(*args, **kwargs)
            if not self.captures(key):
                self._announce(key)
                COUNTS["eager"] += 1
                with _span("mrt.jit.eager"):
                    return self.fn(*args, **kwargs)
            if torch.is_grad_enabled() and any(t.requires_grad for t in leaves):
                raise ValueError(f"{self.__qualname__}: an argument requires grad, and a "
                                 "compiled call is not differentiable from outside; take "
                                 "the gradient inside the function (jit of a "
                                 "value-and-grad function)")
            program = self._programs.get(key)
            if program is not None:
                return program.replay(leaves)
            _sync(device)
            t0 = time.perf_counter()
            with _span("mrt.jit.warmup"):
                out = self.fn(*args, **kwargs)    # the warm-up, returned
                _sync(device)
            t1 = time.perf_counter()
            COUNTS["warmups"] += 1
            COUNTS["warmup_s"] += t1 - t0
            with _span("mrt.jit.capture"):
                mode = "thread_local" if key[6] else "global"
                program = _Program(self, dict(key[0]), key[1], leaves, types, device, mode)
                _sync(device)
            t2 = time.perf_counter()
            self._programs[key] = program
            COUNTS["captures"] += 1
            COUNTS["capture_s"] += t2 - t1
            return out

    def clear(self) -> None:
        """Drop every captured graph (and its memory pool)."""
        self._programs.clear()


@contextlib.contextmanager
def disable_jit():
    """Run every compiled call inside eagerly (``jax.disable_jit``)."""
    global _disabled
    before, _disabled = _disabled, True
    try:
        yield
    finally:
        _disabled = before


def jit(fn: Callable = None, *, static_argnames=()):
    """``fn`` as a compiled program on CUDA (``Compiled``); the arguments
    named in ``static_argnames`` are part of the key. Usable as a
    decorator, with or without arguments."""
    if fn is None:
        return functools.partial(jit, static_argnames=static_argnames)
    return Compiled(fn, static_argnames)
