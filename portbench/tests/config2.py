"""BASELINE.json config 2's light path (benchmarks/run_all.py config_2), as
a configuration writes it: its two point lights as light records of the
scene block (reference/scenes.py), and the render block's flags."""

CONFIG2_LIGHTS = [
    {"type": "point", "position": [0.0, -10.0, 16.0], "direction": [-0.5, 0.4, -0.1],
     "intensity": 16.0, "attenuation": 0.8, "cos_cutoff": 0.9},
    {"type": "point", "position": [4.0, 2.0, 14.0], "direction": [0.0, 0.5, -1.0],
     "intensity": 8.0, "attenuation": 0.8, "cos_cutoff": 0.9},
]
# Shadow rays and the direct specular term.
CONFIG2 = {"shadow_rays": True, "direct_specular": True}
