"""The W8A8 chain's dtype conversions ride inside the arithmetic pass
beside them (``torch_ops._dequant``, ``quantize``, ``_act_quant``,
``add(qadd=)``, ``_decode``): each form equals the separate casts it
replaced (``tests/separate_casts.py``) bit for bit on the CPU, and counts
its fused passes as ``w8a8.cast_fused``."""
import pytest

import separate_casts as sc


@pytest.mark.parametrize("case", sc.FORMS)
def test_fused_cast_equals_the_separate_casts(case):
    sc.check_form(case, "cpu")
