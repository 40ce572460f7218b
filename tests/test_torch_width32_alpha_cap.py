"""The two-level alpha pass alone at width 32 against the reference's
``VKRT_WIDE=32`` machine on the panel stack at opacity 0: every candidate
rejected, each ray at the round cap (``tests/test_torch_instancing.py``'s
case and tolerances). Split by subject from
``tests/test_torch_width32_alpha_pass.py``, which keeps the small bistro
and the half-opacity stack.
"""

import pytest

from test_torch_instancing import _alpha_pass_case, _check_alpha_outcome, _check_alpha_pass
from test_torch_traverse import isolated_reference, one_torch_thread  # noqa: F401 (fixtures)

pytestmark = pytest.mark.usefixtures("one_torch_thread")


@pytest.mark.parametrize("scene", ["stack0"])
@pytest.mark.parametrize("kind", ["closest", "any"])
def test_alpha_pass_w32_matches_reference(scene, kind):
    """The alpha pass alone at width 32 against the reference's
    ``VKRT_WIDE=32`` machine (``tests/test_torch_instancing.py``'s cases:
    the small bistro toward its foliage, the panel stack at the round cap)."""
    port = _check_alpha_pass(*_alpha_pass_case(scene, 32, kind), kind)
    _check_alpha_outcome(scene, port)
