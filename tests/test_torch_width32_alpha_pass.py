"""The two-level alpha pass alone at width 32 against the reference's
``VKRT_WIDE=32`` machine, with the cases and tolerances of
``tests/test_torch_instancing.py``: the small bistro toward its foliage, and
the panel stack at the round cap.
"""

import pytest

from test_torch_instancing import _alpha_pass_case, _check_alpha_outcome, _check_alpha_pass
from test_torch_traverse import isolated_reference  # noqa: F401 (autouse)


@pytest.mark.parametrize("scene", ["bistro", "stack0", "stack05"])
@pytest.mark.parametrize("kind", ["closest", "any"])
def test_alpha_pass_w32_matches_reference(scene, kind):
    """The alpha pass alone at width 32 against the reference's
    ``VKRT_WIDE=32`` machine (``tests/test_torch_instancing.py``'s cases:
    the small bistro toward its foliage, the panel stack at the round cap)."""
    port = _check_alpha_pass(*_alpha_pass_case(scene, 32, kind), kind)
    _check_alpha_outcome(scene, port)
