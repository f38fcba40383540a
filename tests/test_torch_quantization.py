"""Port parity: the frozen-int8 state (`quantize_state_int8`,
`dequantize_state`, `is_quantized_state`) must be bitwise equal to
paddle_tpu's on a real GPT `state_values` dict."""

from __future__ import annotations

import numpy as np
import torch

from paddle_tpu.engine import state_values
from paddle_tpu.quantization import (
    dequantize_state as j_dequantize_state,
    quantize_state_int8 as j_quantize_state_int8,
)

from paddle_tpu_torch import quantization as tq
from torch_parity import build_pair


def test_quantize_and_dequantize_state_bitwise():
    jm, _, _ = build_pair(seed=1)
    vals = {k: np.asarray(v) for k, v in state_values(jm).items()}
    jq = j_quantize_state_int8(vals)
    tvals = {k: torch.from_numpy(v.copy()) for k, v in vals.items()}
    tqv = tq.quantize_state_int8(tvals)
    assert sorted(tqv) == sorted(jq)
    assert tq.is_quantized_state(tqv) and not tq.is_quantized_state(tvals)
    for k in jq:
        got, want = tqv[k].numpy(), np.asarray(jq[k])
        assert got.dtype == want.dtype, k
        np.testing.assert_array_equal(got, want, err_msg=k)
    jd = j_dequantize_state(jq)
    td = tq.dequantize_state(tqv)
    assert sorted(td) == sorted(vals)
    for k in jd:
        np.testing.assert_array_equal(td[k].numpy(), np.asarray(jd[k]),
                                      err_msg=k)
