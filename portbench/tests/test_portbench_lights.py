"""A configuration's lights: ``scene.lights`` takes the string "point" and
light records (reference/scenes.py). Every malformed record is refused
with the light's index and the key named; "point" and its record give the
same arrays; the configurations that BENCHMARK.json had before records
existed give the arrays they gave then; and BASELINE.json config 2's two lights,
written as records, are the program's scene with those lights, bit for
bit."""

import copy
import hashlib
import json
from pathlib import Path

import numpy as np
import pytest
import torch

import mini_opencl_raytracer_tpu_torch as P
from mini_opencl_raytracer_tpu_torch.convert import scene_to_numpy
from portbench.reference import scenes
from portbench.tests.config2 import CONFIG2_LIGHTS

ROOT = Path(__file__).resolve().parents[2]

# POINT_LIGHT as a record.
POINT_RECORD = {**scenes.POINT_LIGHT, "type": "point"}

# sha256 of every leaf (path, dtype, shape, bytes, in path order) of each
# configuration's scene as make_scene gave it before it took records.
DIGESTS = {
    "cornell-1080p-b9": "1c665e1429146767ee0c5ed45634e3b805fdea906401ace96c2133c0b4a66940",
    "bunny-512-b2": "c4214975f03d0c9fa002455d585b9dee2a6a069cc9335d1899a0284356bae120",
    "sponza-4k-b1": "c68658f33942d93866a202938ce6ddd25b371aac2f45e3b83afb78e316196319",
}


def _configs():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    return {c["name"]: json.loads((ROOT / c["file"]).read_text()) for c in bench["configs"]}


def _digest(arrays) -> str:
    h = hashlib.sha256()
    for k in sorted(arrays):
        a = arrays[k]
        h.update(k.encode())
        h.update(str(a.dtype).encode())
        h.update(str(a.shape).encode())
        h.update(a.tobytes())
    return h.hexdigest()


def _assert_same_arrays(ref, got):
    assert got.keys() == ref.keys()
    for k in ref:
        assert got[k].dtype == ref[k].dtype, k
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)


def test_configurations_read_as_before():
    """Each configuration that DIGESTS names; one added later is not held."""
    configs = _configs()
    for name, digest in DIGESTS.items():
        assert name in configs, name
        assert _digest(scenes.make_scene(configs[name]["scene"])) == digest, name


@pytest.mark.parametrize("name", sorted(DIGESTS))
def test_point_is_its_record(name):
    spec = _configs()[name]["scene"]
    assert spec["lights"] == ["point"]
    rec = {**spec, "lights": [POINT_RECORD]}
    _assert_same_arrays(scenes.make_scene(spec), scenes.make_scene(rec))


def test_config2_lights_are_the_program_scene():
    """The Cornell scene block with config 2's two light records is the
    program's cornell_scene with the lights run_all.py:113-119 sets, and
    ["point"] is the record form of Lights.default_point()."""
    spec = {"room": "cornell", "objects": [], "lights": CONFIG2_LIGHTS}
    t = lambda v, dt=torch.float32: torch.tensor(v, dtype=dt)
    lights = P.Lights(position=t([[0.0, -10.0, 16.0], [4.0, 2.0, 14.0]]),
                      direction=t([[-0.5, 0.4, -0.1], [0.0, 0.5, -1.0]]),
                      light_type=t([P.LIGHT_POINT, P.LIGHT_POINT], torch.int32),
                      intensity=t([16.0, 8.0]), attenuation=t([0.8, 0.8]),
                      cos_cutoff=t([0.9, 0.9]))
    _assert_same_arrays(scenes.make_scene(spec),
                        scene_to_numpy(P.cornell_scene(lights=lights, device="cpu")))
    d = scene_to_numpy(P.cornell_scene(lights=P.Lights.default_point(device="cpu"),
                                       device="cpu"))
    record = {"type": "point", "position": d["lights.position"][0].tolist(),
              "direction": d["lights.direction"][0].tolist(),
              "intensity": float(d["lights.intensity"][0]),
              "attenuation": float(d["lights.attenuation"][0]),
              "cos_cutoff": float(d["lights.cos_cutoff"][0])}
    assert int(d["lights.light_type"][0]) == scenes.LIGHT_TYPES["point"] == P.LIGHT_POINT
    _assert_same_arrays(scenes.make_scene({"room": "cornell", "lights": ["point"]}),
                        scenes.make_scene({"room": "cornell", "lights": [record]}))
    _assert_same_arrays(scenes.make_scene({"room": "cornell", "lights": ["point"]}), d)


def test_records_of_every_type_and_mixed_forms():
    types = {"directional": P.LIGHT_DIRECTIONAL, "point": P.LIGHT_POINT, "spot": P.LIGHT_SPOT}
    assert scenes.LIGHT_TYPES == types
    recs = [{**CONFIG2_LIGHTS[1], "type": name, "intensity": float(i + 1)}
            for i, name in enumerate(types)]
    a = scenes.make_scene({"room": "cornell", "lights": ["point", *recs, "point"]})
    assert a["lights.light_type"].tolist() == [1, 0, 1, 2, 1]
    assert a["lights.light_type"].dtype == np.int32
    for key in ("position", "direction", "intensity", "attenuation", "cos_cutoff"):
        assert a[f"lights.{key}"].dtype == np.float32, key
    assert a["lights.position"].shape == (5, 3)
    assert a["lights.intensity"].tolist() == [16.0, 1.0, 2.0, 3.0, 16.0]
    np.testing.assert_array_equal(a["lights.direction"][2],
                                  np.float32(CONFIG2_LIGHTS[1]["direction"]))


def _without(key):
    rec = copy.deepcopy(CONFIG2_LIGHTS[1])
    del rec[key]
    return rec


def _with(key, value):
    return {**copy.deepcopy(CONFIG2_LIGHTS[1]), key: value}


MALFORMED = [
    *[(f"missing-{k}", _without(k), k) for k in scenes.LIGHT_KEYS],
    ("extra-key", _with("radius", 1.0), "radius"),
    ("extra-color", _with("color", [1.0, 1.0, 1.0]), "color"),
    ("type-unknown", _with("type", "area"), "type"),
    ("type-number", _with("type", 1), "type"),
    ("position-short", _with("position", [4.0, 2.0]), "position"),
    ("direction-long", _with("direction", [0.0, 0.5, -1.0, 0.0]), "direction"),
    ("position-scalar", _with("position", 4.0), "position"),
    ("intensity-list", _with("intensity", [8.0]), "intensity"),
    ("intensity-nan", _with("intensity", float("nan")), "intensity"),
    ("attenuation-inf", _with("attenuation", float("inf")), "attenuation"),
    ("cos_cutoff-over-float32", _with("cos_cutoff", 1e39), "cos_cutoff"),
    ("direction-nan", _with("direction", [0.0, float("nan"), -1.0]), "direction"),
    ("position-string", _with("position", [4.0, "2", 14.0]), "position"),
    ("intensity-bool", _with("intensity", True), "intensity"),
    ("intensity-null", _with("intensity", None), "intensity"),
]


@pytest.mark.parametrize("record,key", [(r, k) for _, r, k in MALFORMED],
                         ids=[name for name, _, _ in MALFORMED])
def test_malformed_record_is_refused(record, key):
    with pytest.raises(ValueError) as err:
        scenes.make_scene({"room": "cornell", "lights": ["point", record]})
    assert "scene.lights[1]" in str(err.value) and repr(key) in str(err.value), err.value


@pytest.mark.parametrize("lights", [[], "point", ["area"], [3]],
                         ids=["empty", "not-a-list", "unknown-name", "not-a-record"])
def test_malformed_light_list_is_refused(lights):
    with pytest.raises(ValueError, match=r"scene\.lights"):
        scenes.make_scene({"room": "cornell", "lights": lights})
