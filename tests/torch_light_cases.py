"""Light sets for the tests of shade's light loop (K8,
``kernels/shade_lights.py``), as numpy arrays in ``Lights.shader_arrays()``'s
layout: the bench scene's sun, spot and area light with a point light
added (all four types), each type alone, S = 1 to 4 mixed, the four with
one light inactive, with lights that cast no shadow, with equal penumbra
and umbra angles, with falloff 0, with a type outside the four (its L is
(1, 1, 1)), an empty light set (one zero light, inactive), and 33 lights
(more than one K8b launch takes). Imports neither JAX nor tpurt.
"""
import numpy as np


def four_lights(r) -> dict:
    """The renderer's lights (the bench scene's three) and a point light."""
    from tpurt_torch.scene.lights import PointLight

    base = r.lights.shader_arrays()
    point = PointLight(pos=[1.0, -3.0, -1.0], color=[2.0, 1.8, 1.5],
                       falloff_distance=10.0, casts_shadows=True)
    row = dict(point.shader_data(), active=1.0)
    return {k: np.concatenate([v, np.asarray([row[k]], v.dtype)])
            for k, v in base.items()}


def light_cases(r) -> dict:
    """name -> light arrays, every case of the module docstring."""
    from tpurt_torch.scene.lights import Lights

    four = four_lights(r)
    types = four["light_type"]
    assert sorted(types.tolist()) == [0, 1, 2, 3]

    def pick(idx):
        return {k: np.array(v[idx]) for k, v in four.items()}

    cases = {name: pick([int(np.flatnonzero(types == t)[0])])
             for name, t in (("point", 0), ("spot", 1), ("directional", 2),
                             ("area", 3))}
    for s in (1, 2, 3, 4):
        cases[f"mixed{s}"] = pick(list(range(s)))
    edits = dict(
        inactive=lambda c: c["active"].__setitem__(1, 0.0),
        no_shadow=lambda c: c["casts_shadows"].__setitem__(slice(0, 2), 0),
        equal_angles=lambda c: c["umbra_angle"].__setitem__(
            slice(None), c["penumbra_angle"]),
        no_falloff=lambda c: c["falloff_distance"].__setitem__(slice(None),
                                                               0.0),
        other_type=lambda c: c["light_type"].__setitem__(3, 7))
    for name, edit in edits.items():
        case = pick([0, 1, 2, 3])
        edit(case)
        cases[name] = case
    cases["empty"] = Lights().shader_arrays()
    cases["many"] = pick([i % 4 for i in range(33)])
    return cases
