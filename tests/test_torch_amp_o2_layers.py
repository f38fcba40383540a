"""Port parity: auto_cast level O2 against paddle_tpu's dispatch rewrite,
layer by layer: every layer class of the shared table
(tests/torch_nn_cases.py; its first case), built with the same values in
both packages and called with float32 inputs under O2 in bf16: the
output dtypes and the set of ALL op names the call casts under are the
reference's (see test_torch_amp_o2.py). Which names cast does not
depend on the low dtype, so f16 is left to the functional and model
files, which run both.
"""

from __future__ import annotations

import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import amp as jamp

from paddle_tpu_torch import amp as tamp
from test_torch_amp_o2 import _dtypes, _first_cases, recorded  # noqa: F401
from torch_nn_cases import L_CASES
from torch_nn_parity import flat, layer_pair


@pytest.mark.parametrize("case", _first_cases(L_CASES), ids=lambda c: c.fn)
def test_layer_o2_dtype_and_op_names(case, recorded, dtype="bfloat16"):
    """Every layer class of the table (its first case), built with the
    same values in both packages, called under O2: output dtypes and the
    set of cast op names (the RNN cells' gates, Flatten's ``flatten``,
    the stacked RNNs' fused ``rnn`` op)."""
    ref, port = recorded
    ctor, call = case.call
    jm, tm, _ = layer_pair(ctor, case.train)
    arrays = case.inputs()
    ref.clear()
    port.clear()
    with jamp.auto_cast(enable=True, level="O2", dtype=dtype):
        ts = [paddle.to_tensor(a) for a in arrays]
        want = [str(o._value.dtype) for o in
                flat(call(jm, *ts) if call else jm(*ts))]
    with tamp.auto_cast(enable=True, level="O2", dtype=dtype):
        ts = [torch.tensor(a) for a in arrays]
        got = [str(o.dtype).replace("torch.", "") for o in
               flat(call(tm, *ts) if call else tm(*ts))]
    assert _dtypes(got) == _dtypes(want), (case.fn, got, want)
    assert set(port) == set(ref), (case.fn, sorted(set(port) - set(ref)),
                                   sorted(set(ref) - set(port)))
