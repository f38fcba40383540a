"""Port parity: auto_cast level O2 against paddle_tpu's dispatch rewrite,
function by function.

Under O2 the reference casts the floating inputs of EVERY op it
dispatches (``paddle_tpu.core.dispatch._amp_rewrite``): the black list
to float32, every other op, Tensor operators (``x + h`` is
``elementwise_add``) and Tensor methods (``reshape``, ``transpose``,
...) included, to the low dtype. The port casts at each op's entry
through ``amp.cast`` under the reference's op name. Here every public
function of nn.functional (the first case of each in the shared table,
tests/torch_nn_cases.py) with float32 inputs under O2 in bf16 (here)
and in f16 (test_torch_amp_o2_f16.py): the output dtypes, and the set
of ALL op names the call casts under (recorded on both sides), are the
reference's. The layer classes are in test_torch_amp_o2_layers.py and
whole model forwards in test_torch_amp_o2_models.py (the `recorded`
fixture below serves them all).
"""

from __future__ import annotations

import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import amp as jamp

import paddle_tpu_torch.nn.functional as TF
from paddle_tpu_torch import amp as tamp
from torch_nn_cases import F_CASES
from torch_nn_parity import JREF, flat

DTYPES = ("bfloat16", "float16")


def _first_cases(cases=F_CASES):
    seen, out = set(), []
    for c in cases:
        if c.fn not in seen:
            seen.add(c.fn)
            out.append(c)
    return out


@pytest.fixture
def recorded(monkeypatch):
    """Two lists that collect, in call order, the op names the reference
    rewrites (every dispatch) and the port casts under."""
    from paddle_tpu.core import dispatch

    ref, port = [], []
    rewrite, cast = dispatch._amp_rewrite, tamp.cast

    def rec_ref(op_name, arrs):
        ref.append(op_name)
        return rewrite(op_name, arrs)

    def rec_port(op_name, *tensors):
        port.append(op_name)
        return cast(op_name, *tensors)

    monkeypatch.setattr(dispatch, "_amp_rewrite", rec_ref)
    monkeypatch.setattr(tamp, "cast", rec_port)
    return ref, port


def _dtypes(outs):
    # x64 is off in the reference: its integer outputs are int32
    ints = {"int32": "int", "int64": "int"}
    return [ints.get(d, d) for d in outs]


def check_functional_o2(case, dtype, recorded):
    """One functional case under O2 in `dtype` in both packages: the
    output dtypes and the set of cast op names."""
    ref, port = recorded
    arrays = case.inputs()
    with jamp.auto_cast(enable=True, level="O2", dtype=dtype):
        want = [str(o._value.dtype) for o in
                flat(case.call(JREF, *(paddle.to_tensor(a)
                                       for a in arrays)))]
    with tamp.auto_cast(enable=True, level="O2", dtype=dtype):
        got = [str(o.dtype).replace("torch.", "") for o in
               flat(case.call(TF, *(torch.tensor(a) for a in arrays)))]
    assert _dtypes(got) == _dtypes(want), (case.fn, got, want)
    assert set(port) == set(ref), (case.fn, sorted(set(port) - set(ref)),
                                   sorted(set(ref) - set(port)))


@pytest.mark.parametrize("case", _first_cases(), ids=lambda c: c.fn)
def test_functional_o2_dtype_and_op_names(case, recorded):
    check_functional_o2(case, "bfloat16", recorded)
