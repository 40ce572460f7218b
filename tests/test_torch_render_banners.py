"""The slice end to end with the atrium's alpha-tested banners: the port's
``Renderer(device="cpu")`` against the reference ``Renderer`` as in
``test_torch_render.py`` (its gates: 99% of pixels within rtol 1e-3 / atol
1e-4, ray counts within 0.1%). The reference runs its fused Pallas path
(``VKRT_FUSED=1``, interpret mode) so that its alpha test uses the same
candidate rounds as the port.
"""

import pytest

from test_torch_render import _check, _render_pair
from test_torch_traverse import isolated_reference, one_torch_thread  # noqa: F401 (fixtures)

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def test_render_matches_reference_with_banners(monkeypatch):
    monkeypatch.setenv("VKRT_FUSED", "1")
    _check(*_render_pair(banners=True))
