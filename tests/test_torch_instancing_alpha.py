"""The two-level alpha pass alone: the port's round loop against the
reference's ``_two_level_alpha_pass`` (Pallas in interpret mode,
``VKRT_FUSED=1``) on the small bistro's rays toward its foliage and on the
panel stack, and the 64-round cap that decides the stack. Split by subject
from ``tests/test_torch_instancing.py``, whose helpers and tolerances these
tests use.
"""

import numpy as np
import pytest
import torch

from test_torch_instancing import (  # noqa: F401 (the autouse fixture)
    STACK_PANELS, _alpha_pass_case, _check_alpha_outcome, _check_alpha_pass, _fused_reference,
)
from test_torch_traverse import isolated_reference, one_torch_thread  # noqa: F401 (fixtures)
from vk_raytrace_torch.ops import tlas

pytestmark = pytest.mark.usefixtures("one_torch_thread")


@pytest.mark.parametrize("scene", ["bistro", "stack0", "stack05"])
@pytest.mark.parametrize("kind", ["closest", "any"])
def test_alpha_pass_matches_reference(scene, kind):
    """The alpha pass alone at width 16: the small bistro toward its
    foliage, and the panel stack (opacity 0 meets the 64-round cap)."""
    port = _check_alpha_pass(*_alpha_pass_case(scene, 16, kind), kind)
    _check_alpha_outcome(scene, port)


def test_round_cap_decides_the_stack():
    """The opacity-0 stack with the cap raised past its 66 rounds: every
    live ray reaches the alpha-1 panel. So the cap, not the scene, ends the
    rays in ``test_alpha_pass_matches_reference[*-stack0]``."""
    case, o, d, t_max, seed, act = _alpha_pass_case("stack0", 16, "closest")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tlas, "_A_MAX_ROUNDS", 2 * STACK_PANELS + 2)
        out = tlas._two_level_alpha_pass(
            case.acc, case.pack, torch.from_numpy(o), torch.from_numpy(d), torch.from_numpy(t_max),
            torch.from_numpy(seed.astype(np.int64)), torch.from_numpy(act), False, True)
    np.testing.assert_array_equal(out[1].numpy() >= 0, act)
    np.testing.assert_allclose(out[0].numpy()[act], 9.0)  # z = 10 down to the panel at z = 1
