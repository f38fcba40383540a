"""Port parity: auto_cast level O2 in float16 against paddle_tpu's
dispatch rewrite, function by function: every public function of
nn.functional (the first case of each in tests/torch_nn_cases.py) with
float32 inputs: the output dtypes and the set of ALL op names the call
casts under are the reference's (the bf16 half, and how the names are
recorded: test_torch_amp_o2.py).
"""

from __future__ import annotations

import pytest

from test_torch_amp_o2 import _first_cases, check_functional_o2, \
    recorded  # noqa: F401


@pytest.mark.parametrize("case", _first_cases(), ids=lambda c: c.fn)
def test_functional_o2_f16_dtype_and_op_names(case, recorded):
    check_functional_o2(case, "float16", recorded)
