"""K1's procedural envelope on the CPU, the cellular fields: the cellular
shape tier (``demo_variant(shape_basis="cellular")``, the 8-cell Worley
shape) and the profile the ``.tscn`` importer builds from the reference
demo (a 27-cell cellular ridged 8-octave shape per step, hat-sum coverage
knots, LOD 1), each through the port's ``Scene.render`` against JAX's at
the cloud tolerance; the helpers and tolerances are
``test_torch_envelope.py``'s.
"""

import pytest

from test_torch_envelope import CELLULAR_CASES, check_case, eager_jax  # noqa: F401


@pytest.mark.parametrize("case", list(CELLULAR_CASES))
def test_scene_render_matches_jax(case, eager_jax):  # noqa: F811
    check_case(case)
