"""K1's procedural envelope on the CPU, the fields: perlin, simplex and
ping-pong (weighted) coverage, coverage K = 4 and 16 (hat-sum knots),
procedural shape knots K_s = 8 and a 16-row LOD group, each through the
port's ``Scene.render`` against JAX's at the cloud tolerance; the helpers
and tolerances are ``test_torch_envelope.py``'s.
"""

import pytest

from test_torch_envelope import FIELD_CASES, check_case, eager_jax  # noqa: F401


@pytest.mark.parametrize("case", list(FIELD_CASES))
def test_scene_render_matches_jax(case, eager_jax):  # noqa: F811
    check_case(case)
