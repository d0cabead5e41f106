"""Cross-module fixture, caller side: the capture root lives here, the
violation lives in helper.py.  A per-module pass sees a clean file in
both places; the whole-program pass marks helper.scale as captured and
the host-sync rule fires at the ``.item()`` it contains."""

from tests.torch_analysis_fixtures.xmod.helper import scale


def fused_scale(x):
    return scale(x, 2.0)
