"""The kernel-call seam of the port (``ops/cuda/build.py``) on the CPU.

``build.launch`` is the one way a wrapper calls an entry point of the
kernel library. Here the library is a stand-in whose entry returns a
chosen error code, and the device guard a stand-in stream, so the
launch's order of work shows without a card: the arguments (tensors by
their data pointers) and the stream go to the entry, an error raises
under the launch's name before anything is counted, and a launch that
succeeds counts once, with the rays it was given. The kernels themselves
run on the card: tests/test_torch_cuda.py.
"""

import contextlib

import pytest
import torch

from mini_opencl_raytracer_tpu_torch.ops.cuda import build

STREAM = 42


class _Library:
    """The library's place: ``mrt_clustered`` records its arguments and
    returns ``err``."""

    def __init__(self, err: int):
        self.err, self.calls = err, []

    def mrt_clustered(self, *args):
        self.calls.append(args)
        return self.err

    def mrt_error_string(self, err):
        return b"stand-in error"


@pytest.mark.parametrize("err", [0, 700])
def test_launch_checks_then_counts(monkeypatch, err):
    """The entry gets ``args(stream)`` with each tensor as its data
    pointer, then the stream. A nonzero error raises with the launch's
    name and counts nothing; 0 counts one launch and the given rays."""
    lib = _Library(err)
    monkeypatch.setattr(build, "library", lambda: lib)
    monkeypatch.setattr(build, "_on", lambda device: contextlib.nullcontext(STREAM))
    t = torch.zeros(3)
    before = dict(build.LAUNCHES), dict(build.RAYS)

    def launch():
        build.launch("clustered_any", torch.device("cuda", 0),
                     lambda stream: (7, t, None, stream),
                     rays={"clustered_any": 9, "mega_shadow": 4})

    if err:
        with pytest.raises(RuntimeError, match="clustered_any: CUDA error 700"):
            launch()
        assert (build.LAUNCHES, build.RAYS) == before
    else:
        launch()
        assert build.LAUNCHES == before[0] | {"clustered_any": before[0]["clustered_any"] + 1}
        assert build.RAYS == before[1] | {"clustered_any": before[1]["clustered_any"] + 9,
                                          "mega_shadow": before[1]["mega_shadow"] + 4}
    assert lib.calls == [(7, t.data_ptr(), None, STREAM, STREAM)]


def _entry_points():
    """{name: [C parameter types]} of every ``extern "C"`` function of
    csrc/*.cu, read from the sources."""
    import re
    out = {}
    for src in sorted(build.CSRC.glob("*.cu")):
        text = src.read_text()
        for m in re.finditer(r'extern "C" [\w\s\*]+?\b(mrt_\w+)\(([^)]*)\)', text):
            params = [" ".join(p.split()) for p in m.group(2).split(",") if p.strip()]
            out[m.group(1)] = [re.sub(r"\s*\b\w+$", "", p) if p != "void" else p
                               for p in params]
    return out


def _ctype(c_type: str):
    if "*" in c_type:
        return build._P
    return {"int": build._I, "long long": __import__("ctypes").c_longlong}[c_type]


@pytest.mark.parametrize("name", sorted(build._SIGNATURES))
def test_signatures_match_the_entry_points(name):
    """Each entry point's ctypes signature in ``build._SIGNATURES`` has the
    C function's parameters, in number and kind (a pointer as c_void_p,
    int as c_int, long long as c_longlong), read from csrc/*.cu; every
    launch name maps to a declared entry."""
    entries = _entry_points()
    assert name in entries, f"{name} is not an extern \"C\" function of csrc/*.cu"
    argtypes, _ = build._SIGNATURES[name]
    assert argtypes == [_ctype(t) for t in entries[name]], entries[name]
    assert set(build._ENTRIES.values()) <= set(build._SIGNATURES)


def test_raygen_is_declared():
    """The wavefront's raygen kernel: launch ``raygen`` calls
    ``mrt_raygen`` (csrc/raygen.cu), and ``RAYS`` counts the rays it
    generated and those PyTorch generated on a CUDA device."""
    assert build._ENTRIES["raygen"] == "mrt_raygen" and "raygen" in build.LAUNCHES
    assert build._SIGNATURES["mrt_raygen"] == ([build._P] * 7, build._I)
    assert {"raygen_fused", "raygen_plain"} <= set(build.RAYS)
    assert (build.CSRC / "raygen.cu").exists() and (build.CSRC / "raygen.cuh").exists()
