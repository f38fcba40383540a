"""Port parity: paddle_tpu_torch.profiler (host spans, op profiling,
device captures on torch.profiler) and observe's device-time
attribution against paddle_tpu's, on the CPU.

- `classify_op` gives the reference's bucket on every case of the
  reference's own rules test, and puts the demangled kernel names of a
  card trace (every hand-written kernel of csrc/ and cuBLAS, cuDNN,
  torch and NCCL kernels, copied as strings) into the buckets of the
  port's kernel table; no hand-written kernel lands in "other".
- `device_op_table`, `device_op_events`, `attribute` and
  `overlap_report` read a synthetic CUDA chrome trace: kernels, a
  memset and a device-to-device copy count, host<->device copies and
  host rows do not; the sums are exact. `overlap_stats` equals the
  reference's on the same events.
- A CUDA capture without a kernel row raises; a ``device="cpu"``
  capture counts the outermost ``aten::`` op of each thread only, and
  a `RecordEvent` opened while it runs lands in it.
- `Engine.attribute_step` on a 2-layer ERNIE on the CPU: real steps,
  buckets summing to ``total_us`` (rtol 1e-9, float sums in another
  order), a nonzero matmul bucket.
- Host spans nest; `percentiles` and `export_chrome_tracing` equal the
  reference's on the same recorded spans; `profile(op_detail=True)`
  records torch ops as "op" events only inside its scope.
"""

from __future__ import annotations

import json
import os

import numpy as np
import pytest
import torch

from paddle_tpu import observe as jobs
from paddle_tpu import profiler as jprof

from paddle_tpu_torch import observe as tobs
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch import profiler as tprof
from paddle_tpu_torch.engine import Engine as TEngine
from paddle_tpu_torch.nlp.transformers import ernie as ternie
from torch_parity import ERNIE_TINY, VOCAB

# tests/test_observe.py::test_classify_op_rules
REFERENCE_CASES = [
    ("dot.5", "matmul"), ("broadcast_maximum_fusion", "elementwise"),
    ("convert.2", "elementwise"), ("all-reduce.1", "collective"),
    ("flash_attention_fwd", "attention"),
    ("TfrtCpuExecutable::Execute", None), ("PjitFunction(f)", None),
    ("shard_args", None), ("$src.py:12 fn", None),
    ("all_gather_fusion", "collective"), ("all-gather.3", "collective"),
    ("reduce_scatter.1", "collective"),
    ("reduce-scatter.271", "collective"),
    ("collective-permute.2", "collective"),
    ("collective_permute_start", "collective"),
    ("all_to_all.4", "collective"), ("call.3", None), ("while.2", None),
    ("conditional", None), ("call", None),
    ("recall_fusion", "elementwise"),
]

# kernel names as torch.profiler's trace prints them on an NVIDIA H100
# 80GB HBM3 (the port's paths at small widths: ERNIE in bf16 / f32 and
# under FLAGS_lowp_matmul, ResNet-18 in bf16 / f32, gpt2-small decode),
# with the bucket each belongs in: every hand-written kernel of csrc/
# that a path launches, then cuBLAS, cuDNN (one name left mangled by
# the profiler), torch and NCCL kernels
CARD_KERNELS = [
    ("void (anonymous namespace)::fwd_kernel_mma<64>((anonymous "
     "namespace)::Params)",
     "attention"),
    ("void (anonymous namespace)::dq_kernel_mma<64>((anonymous "
     "namespace)::Params)",
     "attention"),
    ("void (anonymous namespace)::dkv_kernel_mma<64>((anonymous "
     "namespace)::Params)",
     "attention"),
    ("void (anonymous namespace)::fwd_kernel<64>((anonymous "
     "namespace)::Params)",
     "attention"),
    ("void (anonymous namespace)::dq_kernel<64>((anonymous "
     "namespace)::Params)",
     "attention"),
    ("void (anonymous namespace)::dkv_kernel<64>((anonymous "
     "namespace)::Params)",
     "attention"),
    ("void (anonymous namespace)::lse_kernel<1024>(CUtensorMap_st, "
     "CUtensorMap_st, (anonymous namespace)::Args)",
     "matmul"),
    ("void (anonymous namespace)::wg_kernel<1, 128>((anonymous "
     "namespace)::Args)",
     "matmul"),
    ("void (anonymous namespace)::wg_kernel<2, 128>((anonymous "
     "namespace)::Args)",
     "matmul"),
    ("void (anonymous namespace)::tc_kernel<1, 32, 1024>((anonymous "
     "namespace)::Args)",
     "matmul"),
    ("void (anonymous namespace)::f32_kernel<0, 128>((anonymous "
     "namespace)::Args)",
     "matmul"),
    ("void (anonymous namespace)::dq_stream<1>(CUtensorMap_st, "
     "(anonymous namespace)::DqArgs)",
     "matmul"),
    ("void w8a8::w8a8_stream<1>(CUtensorMap_st, w8a8::Args)",
     "matmul"),
    ("void qmm::qmm_wg<false>(CUtensorMap_st, CUtensorMap_st, float "
     "const*, float const*, float*, int, int, int)",
     "matmul"),
    ("void qmm::qmm_wg<true>(CUtensorMap_st, CUtensorMap_st, float "
     "const*, float const*, float*, int, int, int)",
     "matmul"),
    ("void qmm::quant_rows<__nv_bfloat16, false>(__nv_bfloat16 const*,"
     " float const*, float, void*, int, int, int, int, long long, long"
     " long)",
     "elementwise"),
    ("void qmm::quant_cols<float, true>(float const*, float const*, "
     "float, void*, int, int, int, long long, long long)",
     "elementwise"),
    ("void (anonymous namespace)::wg_conv<128, 3>((anonymous "
     "namespace)::Args)",
     "matmul"),
    ("(anonymous namespace)::f32_conv((anonymous namespace)::Args)",
     "matmul"),
    ("nvjet_tst_128x128_64x6_2x1_v_bz_NTT",
     "matmul"),
    ("sm80_xmma_gemm_f32f32_f32f32_f32_nn_n_tilesize64x64x8_stage3_war"
     "psize1x4x1_ffma_aligna4_alignc4_execute_kernel__5x_cublas",
     "matmul"),
    ("sm90_xmma_wgrad_indexed_implicit_gemm_bf16bf16_bf16f32_f32_nhwck"
     "rsc_nhwc_tilesize128x64x64_warpgroupsize1x1x1_g1_execute_segment"
     "_k_off_kernel__5x_cudnn",
     "matmul"),
    ("void cutlass::Kernel2<cutlass_80_simt_sgemm_64x64_8x5_nn_align1>"
     "(cutlass_80_simt_sgemm_64x64_8x5_nn_align1::Params)",
     "matmul"),
    ("void cutlass__5x_cudnn::Kernel<cutlass_tensorop_bf16_s16816wgrad"
     "_optimized_bf16_128x64_64x3_nhwc_align8>(cutlass_tensorop_bf16_s"
     "16816wgrad_optimized_bf16_128x64_64x3_nhwc_align8::Params)",
     "matmul"),
    ("_ZN17cutlass__5x_cudnn6KernelINS_4conv6kernel23ImplicitGemmConvo"
     "lutionINS1_11threadblock22ImplicitGemmMultistageINS_4gemm9GemmSh"
     "apeILi64ELi128ELi32EEENS4_52Conv2dWgradOutputGradientTileAccessI"
     "teratorOptimizedINS_11MatrixShapeILi64ELi32EEENS_10bfloat16_tENS"
     "_9transform29PitchLinearWarpRakedThreadMapINS_16PitchLinearShape"
     "ILi64ELi32EEELi128ENSF_ILi8ELi4EEELi8EEENS_12AlignedArrayISC_Li8"
     "ELi16EEEEENSD_11threadblock25RegularTileAccessIteratorISB_SC_NS_"
     "6layout40ColumnMajorTensorOpMultiplicandCongruousILi16ELi64EEELi"
     "1ESI_Li16EEELNS_4arch14CacheOperation4KindE0ENS4_48Conv2dWgradAc"
     "tivationTileAccessIteratorOptimizedINSA_ILi32ELi128EEESC_NSE_INS"
     "F_ILi128ELi32EEELi128ESH_Li8EEESK_EENSN_ISW_SC_NSO_37RowMajorTen"
     "sorOpMultiplicandCongruousILi16ELi64EEELi0ESY_Li16EEELSU_0ENS6_1"
     "1threadblock9MmaPolicyINS6_4warp11MmaTensorOpINS7_ILi32ELi64ELi3"
     "2EEESC_SQ_SC_S11_fNSO_8RowMajorENS15_17MmaTensorOpPolicyINSS_3Mm"
     "aINS7_ILi16ELi8ELi16EEELi32ESC_S18_SC_NSO_11ColumnMajorEfS18_NSS"
     "_13OpMultiplyAddEEENSA_ILi1ELi1EEEEELi1ELb0EbEENSA_ILi0ELi0EEES1"
     "I_Li1EEELi6EbEENS_8epilogue11threadblock8EpilogueIS8_S1H_Li1ENS1"
     "M_22PredicatedTileIteratorINS1M_26OutputTileOptimalThreadMapINS1"
     "M_15OutputTileShapeILi128ELi8ELi2ELi1ELi1EEENS1Q_ILi1ELi4ELi1ELi"
     "1ELi4EEELi128ELi4ELi32EEEfLb0ENSO_9NoPermuteELb0EEENS1L_4warp24F"
     "ragmentIteratorTensorOpIS17_S1B_fNS_5ArrayIfLi4ELb1EEES18_EENS1W"
     "_20TileIteratorTensorOpIS17_S1B_fS18_EENS1M_18SharedLoadIterator"
     "INS1T_18CompactedThreadMapEfLi16EEENS1L_6thread17LinearCombinati"
     "onIfLi4EffLNS26_9ScaleType4KindE0ELNS_15FloatRoundStyleE2EEENSA_"
     "ILi0ELi8EEELi2ELi1EEENS13_30GemmIdentityThreadblockSwizzleILi4EE"
     "ELNS1_8OperatorE2ENS1_17Conv2dProblemSizeELNS1_9GroupModeE0EEEEE"
     "vNT_6ParamsE",
     "matmul"),
    ("void wgrad_alg0_engine<float, 128, 5, 5, 3, 3, 3, false, "
     "512>(int, int, int, float const*, int, float*, float const*, "
     "kernel_grad_params, unsigned long long, int, float, int, int, "
     "int, int)",
     "matmul"),
    ("void cudnn::winograd_nonfused::winogradWgradOutput4x4<float, flo"
     "at>(cudnn::winograd_nonfused::WinogradWgradOutputParams<float, "
     "float>)",
     "matmul"),
    ("void cudnn::engines_precompiled::nchwToNhwcKernel<__nv_bfloat16,"
     " __nv_bfloat16, float, false, true, (cudnnKernelDataType_t)0>(cu"
     "dnn::engines_precompiled::nchw2nhwc_params_t<float>, "
     "__nv_bfloat16 const*, __nv_bfloat16*)",
     "elementwise"),
    ("void at::native::vectorized_elementwise_kernel<4, "
     "at::native::CUDAFunctor_add<float>, std::array<char*, 3ul> "
     ">(int, at::native::CUDAFunctor_add<float>, std::array<char*, "
     "3ul>)",
     "elementwise"),
    ("void at::native::reduce_kernel<512, 1, "
     "at::native::ReduceOp<float, at::native::func_wrapper_t<float, "
     "at::native::MaxNanFunctor<float> >, unsigned int, float, 4, 4> "
     ">(at::native::ReduceOp<float, at::native::func_wrapper_t<float, "
     "at::native::MaxNanFunctor<float> >, unsigned int, float, 4, 4>)",
     "elementwise"),
    ("void at::native::_scatter_gather_elementwise_kernel<128, 8, "
     "at::native::_cuda_scatter_gather_internal_kernel<true, float, "
     "long>::operator()<at::native::ReduceAdd>(at::TensorIterator&, "
     "long, long, long, at::native::ReduceAdd "
     "const&)::{lambda(int)#1}>(int, "
     "at::native::_cuda_scatter_gather_internal_kernel<true, float, "
     "long>::operator()<at::native::ReduceAdd>(at::TensorIterator&, "
     "long, long, long, at::native::ReduceAdd "
     "const&)::{lambda(int)#1})",
     "elementwise"),
    ("void at::native::vectorized_gather_kernel<16, long>(char*, "
     "char*, long*, int, long, long, long, long, bool)",
     "elementwise"),
    ("void at::native::(anonymous namespace)::CatArrayBatchedCopy_vect"
     "orized<at::native::(anonymous namespace)::OpaqueType<4u>, "
     "unsigned int, 1, 128, 1, 16, 4>(char*, at::native::(anonymous "
     "namespace)::CatArrInputTensorMetadata<at::native::(anonymous "
     "namespace)::OpaqueType<4u>, unsigned int, 128, 1>, "
     "at::native::(anonymous namespace)::TensorSizeStride<unsigned "
     "int, 4u>, int, unsigned int)",
     "elementwise"),
    ("void at::native::(anonymous "
     "namespace)::distribution_elementwise_grid_stride_kernel<float, "
     "4, at::native::templates::cuda::uniform_and_transform<float, "
     "float, at::CUDAGeneratorImpl*, at::native::templates::cuda::bern"
     "oulli_kernel<at::CUDAGeneratorImpl*>(at::TensorIteratorBase&, "
     "double, at::CUDAGeneratorImpl*)::{lambda()#1}::operator()() "
     "const::{lambda()#7}::operator()() "
     "const::{lambda(float)#1}>(at::TensorIteratorBase&, "
     "at::CUDAGeneratorImpl*, at::native::templates::cuda::bernoulli_k"
     "ernel<at::CUDAGeneratorImpl*>(at::TensorIteratorBase&, double, "
     "at::CUDAGeneratorImpl*)::{lambda()#1}::operator()() "
     "const::{lambda()#7}::operator()() const::{lambda(float)#1})::{la"
     "mbda(curandStatePhilox4_32_10*)#2}, at::native::(anonymous "
     "namespace)::distribution_nullary_kernel<float, float, float4, "
     "at::CUDAGeneratorImpl*, "
     "at::native::templates::cuda::uniform_and_transform<float, float,"
     " at::CUDAGeneratorImpl*, at::native::templates::cuda::bernoulli_"
     "kernel<at::CUDAGeneratorImpl*>(at::TensorIteratorBase&, double, "
     "at::CUDAGeneratorImpl*)::{lambda()#1}::operator()() "
     "const::{lambda()#7}::operator()() "
     "const::{lambda(float)#1}>(at::TensorIteratorBase&, "
     "at::CUDAGeneratorImpl*, at::native::templates::cuda::bernoulli_k"
     "ernel<at::CUDAGeneratorImpl*>(at::TensorIteratorBase&, double, "
     "at::CUDAGeneratorImpl*)::{lambda()#1}::operator()() "
     "const::{lambda()#7}::operator()() const::{lambda(float)#1})::{la"
     "mbda(curandStatePhilox4_32_10*)#2}, at::native::templates::cuda:"
     ":bernoulli_kernel<at::CUDAGeneratorImpl*>(at::TensorIteratorBase"
     "&, double, at::CUDAGeneratorImpl*)::{lambda()#1}::operator()() "
     "const::{lambda()#7}::operator()() "
     "const::{lambda(float)#1}>(at::TensorIteratorBase&, "
     "at::CUDAGeneratorImpl*, "
     "at::native::templates::cuda::uniform_and_transform<float, float,"
     " at::CUDAGeneratorImpl*, at::native::templates::cuda::bernoulli_"
     "kernel<at::CUDAGeneratorImpl*>(at::TensorIteratorBase&, double, "
     "at::CUDAGeneratorImpl*)::{lambda()#1}::operator()() "
     "const::{lambda()#7}::operator()() "
     "const::{lambda(float)#1}>(at::TensorIteratorBase&, "
     "at::CUDAGeneratorImpl*, at::native::templates::cuda::bernoulli_k"
     "ernel<at::CUDAGeneratorImpl*>(at::TensorIteratorBase&, double, "
     "at::CUDAGeneratorImpl*)::{lambda()#1}::operator()() "
     "const::{lambda()#7}::operator()() "
     "const::{lambda(float)#1})::{lambda(curandStatePhilox4_32_10*)#2}"
     " const&, at::native::templates::cuda::bernoulli_kernel<at::CUDAG"
     "eneratorImpl*>(at::TensorIteratorBase&, double, "
     "at::CUDAGeneratorImpl*)::{lambda()#1}::operator()() "
     "const::{lambda()#7}::operator()() "
     "const::{lambda(float)#1})::{lambda(int, float)#1}>(long, "
     "at::PhiloxCudaState, "
     "at::native::templates::cuda::uniform_and_transform<float, float,"
     " at::CUDAGeneratorImpl*, at::native::templates::cuda::bernoulli_"
     "kernel<at::CUDAGeneratorImpl*>(at::TensorIteratorBase&, double, "
     "at::CUDAGeneratorImpl*)::{lambda()#1}::operator()() "
     "const::{lambda()#7}::operator()() "
     "const::{lambda(float)#1}>(at::TensorIteratorBase&, "
     "at::CUDAGeneratorImpl*, at::native::templates::cuda::bernoulli_k"
     "ernel<at::CUDAGeneratorImpl*>(at::TensorIteratorBase&, double, "
     "at::CUDAGeneratorImpl*)::{lambda()#1}::operator()() "
     "const::{lambda()#7}::operator()() const::{lambda(float)#1})::{la"
     "mbda(curandStatePhilox4_32_10*)#2}, at::native::(anonymous "
     "namespace)::distribution_nullary_kernel<float, float, float4, "
     "at::CUDAGeneratorImpl*, "
     "at::native::templates::cuda::uniform_and_transform<float, float,"
     " at::CUDAGeneratorImpl*, at::native::templates::cuda::bernoulli_"
     "kernel<at::CUDAGeneratorImpl*>(at::TensorIteratorBase&, double, "
     "at::CUDAGeneratorImpl*)::{lambda()#1}::operator()() "
     "const::{lambda()#7}::operator()() "
     "const::{lambda(float)#1}>(at::TensorIteratorBase&, "
     "at::CUDAGeneratorImpl*, at::native::templates::cuda::bernoulli_k"
     "ernel<at::CUDAGeneratorImpl*>(at::TensorIteratorBase&, double, "
     "at::CUDAGeneratorImpl*)::{lambda()#1}::operator()() "
     "const::{lambda()#7}::operator()() const::{lambda(float)#1})::{la"
     "mbda(curandStatePhilox4_32_10*)#2}, at::native::templates::cuda:"
     ":bernoulli_kernel<at::CUDAGeneratorImpl*>(at::TensorIteratorBase"
     "&, double, at::CUDAGeneratorImpl*)::{lambda()#1}::operator()() "
     "const::{lambda()#7}::operator()() "
     "const::{lambda(float)#1}>(at::TensorIteratorBase&, "
     "at::CUDAGeneratorImpl*, "
     "at::native::templates::cuda::uniform_and_transform<float, float,"
     " at::CUDAGeneratorImpl*, at::native::templates::cuda::bernoulli_"
     "kernel<at::CUDAGeneratorImpl*>(at::TensorIteratorBase&, double, "
     "at::CUDAGeneratorImpl*)::{lambda()#1}::operator()() "
     "const::{lambda()#7}::operator()() "
     "const::{lambda(float)#1}>(at::TensorIteratorBase&, "
     "at::CUDAGeneratorImpl*, at::native::templates::cuda::bernoulli_k"
     "ernel<at::CUDAGeneratorImpl*>(at::TensorIteratorBase&, double, "
     "at::CUDAGeneratorImpl*)::{lambda()#1}::operator()() "
     "const::{lambda()#7}::operator()() "
     "const::{lambda(float)#1})::{lambda(curandStatePhilox4_32_10*)#2}"
     " const&, at::native::templates::cuda::bernoulli_kernel<at::CUDAG"
     "eneratorImpl*>(at::TensorIteratorBase&, double, "
     "at::CUDAGeneratorImpl*)::{lambda()#1}::operator()() "
     "const::{lambda()#7}::operator()() "
     "const::{lambda(float)#1})::{lambda(int, float)#1})",
     "elementwise"),
    ("void (anonymous namespace)::softmax_warp_forward<float, float, "
     "float, 10, true, false>(float*, float const*, int, int, int, "
     "bool const*, int, bool)",
     "attention"),
    ("void at::native::(anonymous "
     "namespace)::vectorized_layer_norm_kernel<float, float, "
     "false>(int, float, float const*, float const*, float const*, "
     "float*, float*, float*)",
     "other"),
    ("void at::native::(anonymous "
     "namespace)::embedding_backward_feature_kernel<float, float, "
     "long>(long const*, float const*, float*, int, long, int)",
     "other"),
    ("Memcpy DtoD (Device -> Device)",
     "elementwise"),
    ("Memset (Device)",
     "elementwise"),
    # two ranks on two H100s
    ("ncclDevKernel_AllReduce_Sum_f32_RING_LL(ncclDevKernelArgsStorage<4"
     "096ul>)",
     "collective"),
    ("ncclDevKernel_AllGather_RING_LL(ncclDevKernelArgsStorage<4096ul>)",
     "collective"),
    ("ncclDevKernel_ReduceScatter_Sum_f32_RING_LL(ncclDevKernelArgsStora"
     "ge<4096ul>)",
     "collective"),
]

# the hand-written kernels' base names, as csrc/ declares them
HAND_WRITTEN = ("fwd_kernel_mma", "dq_kernel_mma", "dkv_kernel_mma",
                "fwd_kernel", "dq_kernel", "dkv_kernel", "keep_mask_kernel",
                "lse_kernel", "wg_kernel", "tc_kernel", "f32_kernel",
                "dq_stream", "w8a8_stream", "qmm_wg", "quant_rows",
                "quant_cols", "wg_conv", "f32_conv")


@pytest.fixture(autouse=True)
def _clean():
    tprof.reset()
    jprof.reset()
    yield
    tprof.reset()
    jprof.reset()


@pytest.mark.parametrize("name,bucket", REFERENCE_CASES,
                         ids=[c[0] for c in REFERENCE_CASES])
def test_classify_op_agrees_with_reference(name, bucket):
    assert jobs.classify_op(name) == bucket
    assert tobs.classify_op(name) == bucket


@pytest.mark.parametrize("name,bucket", CARD_KERNELS,
                         ids=[c[0][:48] for c in CARD_KERNELS])
def test_classify_op_card_kernel_names(name, bucket):
    assert tobs.classify_op(name) == bucket


def test_every_hand_written_kernel_is_in_the_table():
    names = [n for n, _ in CARD_KERNELS]
    for base in HAND_WRITTEN:
        if base == "keep_mask_kernel":     # launched by no path
            continue
        row = next(n for n in names if f"::{base}<" in n or
                   f"::{base}(" in n)
        assert tobs.classify_op(row) != "other", row
    import importlib
    import pathlib
    import re

    timeline = importlib.import_module("paddle_tpu_torch.observe.timeline")
    assert set(HAND_WRITTEN) <= set(timeline._KERNELS)
    # ... and they are all the __global__ functions of csrc/
    csrc = pathlib.Path(__file__).resolve().parent.parent / \
        "paddle_tpu_torch" / "csrc"
    declared = set()
    for path in csrc.glob("*.cu*"):
        declared.update(re.findall(
            r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s*)?"
            r"(\w+)\s*\(", path.read_text()))
    assert declared == set(HAND_WRITTEN)
    assert all(timeline._KERNELS[k][1].startswith("B")
               for k in HAND_WRITTEN)


# ---------------------------------------------------------------------------
# device tables over a synthetic capture
# ---------------------------------------------------------------------------

def _card(fragment):
    return next(n for n, _ in CARD_KERNELS if fragment in n)


GEMM = _card("nvjet_tst")
FLASH = _card("fwd_kernel_mma")
ADD = _card("CUDAFunctor_add")
NCCL = _card("ncclDevKernel_AllReduce")


def _x(name, cat, ts, dur, **args):
    return {"ph": "X", "cat": cat, "name": name, "pid": 1, "tid": 7,
            "ts": ts, "dur": dur, "args": args}


def _write(path, events):
    with open(path, "w") as f:
        json.dump({"traceEvents": events, "deviceProperties": []}, f)
    return str(path)


def _synthetic(tmp_path):
    evs = [
        _x("aten::mm", "cpu_op", 0.0, 50.0),
        _x("step.device-step", "user_annotation", 0.0, 500.0),
        _x("cudaLaunchKernel", "cuda_runtime", 1.0, 3.0),
        _x(GEMM, "kernel", 10.0, 100.0, stream=7),
        _x(GEMM, "kernel", 300.0, 50.0, stream=7),
        _x(FLASH, "kernel", 110.0, 40.0, stream=7),
        _x(ADD, "kernel", 150.0, 10.0, stream=7),
        _x(NCCL, "kernel", 60.0, 80.0, stream=9),
        _x("Memset (Device)", "gpu_memset", 160.0, 2.0, stream=7),
        _x("Memcpy DtoD (Device -> Device)", "gpu_memcpy", 162.0, 6.0,
           stream=7),
        _x("Memcpy HtoD (Pageable -> Device)", "gpu_memcpy", 170.0, 30.0,
           stream=7),
        _x("Memcpy DtoH (Device -> Pageable)", "gpu_memcpy", 200.0, 20.0,
           stream=7),
        {"ph": "s", "cat": "ac2g", "name": "ac2g", "ts": 1.0, "id": 3},
    ]
    d = tmp_path / "capture"
    d.mkdir()
    _write(d / "synthetic.cuda.trace.json", evs)
    return str(d)


def test_device_tables_attribute_and_overlap_on_synthetic_trace(tmp_path):
    logdir = _synthetic(tmp_path)
    table, rows = tprof.device_op_table(logdir)
    by = {r["name"]: r for r in rows}
    assert set(by) == {GEMM, FLASH, ADD, NCCL, "Memset (Device)",
                       "Memcpy DtoD (Device -> Device)"}
    assert by[GEMM] == {"name": GEMM, "calls": 2, "total": 150.0,
                        "avg": 75.0, "max": 100.0, "min": 50.0}
    assert rows[0]["name"] == GEMM            # sorted by total
    assert "Device op" in table and "Total(us)" in table
    evs = tprof.device_op_events(logdir)
    assert len(evs) == 7
    assert {e["line"] for e in evs} == {"stream 7", "stream 9"}
    assert sum(e["dur_us"] for e in evs) == 288.0
    rep = tobs.attribute(logdir, top=3)
    assert rep["buckets"] == {"matmul": 150.0, "attention": 40.0,
                              "collective": 80.0, "elementwise": 18.0,
                              "other": 0.0}
    assert rep["total_us"] == 288.0
    assert [o["name"] for o in rep["top_ops"]] == [GEMM, NCCL, FLASH]
    ov = tobs.overlap_report(logdir)
    # NCCL [60, 140] against the compute union [10, 150]: fully hidden
    assert ov["collective_us"] == 80.0 and ov["compute_us"] == 190.0
    assert ov["hidden_collective_us"] == 80.0
    assert ov["exposed_collective_us"] == 0.0
    assert ov["total_us"] == 288.0


def test_overlap_stats_equal_reference_on_the_same_events():
    evs = [{"name": n, "line": "l", "start_us": s, "dur_us": d}
           for n, s, d in (("dot.1", 0.0, 10.0), ("all-reduce.2", 5.0, 20.0),
                           ("fusion.3", 30.0, 4.0),
                           ("softmax_fusion", 8.0, 30.0),
                           ("collective-permute.1", 50.0, 5.0),
                           ("TfrtCpuExecutable::Execute", 0.0, 99.0))]
    assert tobs.overlap_stats(evs) == jobs.overlap_stats(evs)


def test_cuda_capture_without_kernel_rows_raises(tmp_path):
    d = tmp_path / "cap"
    d.mkdir()
    _write(d / "empty.cuda.trace.json", [
        _x("aten::mm", "cpu_op", 0.0, 50.0),
        _x("Memcpy HtoD (Pageable -> Device)", "gpu_memcpy", 1.0, 3.0)])
    with pytest.raises(RuntimeError, match="no kernel rows"):
        tprof.device_op_table(str(d))
    with pytest.raises(FileNotFoundError):
        tprof.device_op_table(str(tmp_path / "nothing"))


def test_cpu_capture_counts_outermost_aten_ops_and_spans(tmp_path):
    lin = torch.nn.Linear(8, 4)
    x = torch.randn(3, 8)
    logdir = str(tmp_path / "cpu")
    tprof.start_trace(logdir, device="cpu")
    try:
        with tprof.RecordEvent("step.probe"):
            lin(x).sum().backward()
    finally:
        path = tprof.stop_trace()
    assert path.endswith(".cpu.trace.json") and os.path.exists(path)
    with open(path) as f:
        raw = json.load(f)["traceEvents"]
    assert any(e.get("cat") == "user_annotation" and
               e["name"] == "step.probe" for e in raw)
    names = [r["name"] for r in tprof.device_op_table(logdir)[1]]
    assert "aten::linear" in names
    # aten::addmm runs inside aten::linear: not counted again
    assert "aten::addmm" not in names
    assert "aten::mm" in names               # the backward's own op
    assert all(n.startswith("aten::") for n in names)
    assert tobs.attribute(logdir)["buckets"]["matmul"] > 0
    assert [e["name"] for e in tprof.events()] == ["step.probe"]


def test_attribute_step_on_cpu_ernie(tmp_path):
    tm = ternie.ErnieForPretraining(ternie.ErnieConfig(**ERNIE_TINY),
                                    device="cpu")
    crit = ternie.ErniePretrainingCriterion()
    eng = TEngine(tm, topt.AdamW(learning_rate=1e-3,
                                 parameters=tm.parameters()),
                  lambda out, mlm, nsp: crit(out[0], out[1], mlm, nsp),
                  device="cpu")
    with pytest.raises(RuntimeError, match="train_batch"):
        eng.attribute_step()
    rng = np.random.RandomState(0)
    ids = rng.randint(0, VOCAB, (2, 32)).astype(np.int32)
    mlm = np.where(rng.rand(2, 32) > 0.3, -100, ids).astype(np.int32)
    eng.train_batch((ids, np.zeros_like(ids)),
                    (mlm, np.zeros((2,), np.int32)))
    rep = eng.attribute_step(logdir=str(tmp_path / "a"), steps=2)
    assert eng.state.step == 3
    assert rep["total_us"] > 0
    assert sum(rep["buckets"].values()) == pytest.approx(
        rep["total_us"], rel=1e-9)
    assert rep["buckets"]["matmul"] > 0
    assert sum(rep["fractions"].values()) == pytest.approx(1.0)
    assert all(o["bucket"] in tobs.BUCKETS for o in rep["top_ops"])
    ov = eng.overlap_report(logdir=str(tmp_path / "o"))
    assert ov["collective_us"] == 0.0 and ov["compute_us"] > 0


# ---------------------------------------------------------------------------
# host spans, op profiling, summary and chrome export
# ---------------------------------------------------------------------------


def _feed_spans(mod):
    with mod._lock:
        for i, d in enumerate((10.0, 20.0, 30.0, 40.0)):
            mod._events.append({"name": "lat", "cat": "host",
                                "ts": 100.0 + i, "dur": d, "tid": 1,
                                "depth": 0})
        mod._events.append({"name": "other", "cat": "op", "ts": 99.0,
                            "dur": 999.0, "tid": 2, "depth": 1})
    mod.RecordMemEvent("alloc", bytes=4096, place="device:0")


def test_percentiles_summary_and_chrome_export_match_reference(tmp_path):
    _feed_spans(jprof)
    _feed_spans(tprof)
    assert tprof.percentiles("lat") == jprof.percentiles("lat")
    assert tprof.percentiles("lat", (50,)) == {50: 25.0}
    with pytest.raises(ValueError):
        tprof.percentiles("absent")
    assert tprof.summary() == jprof.summary()
    got = json.load(open(tprof.export_chrome_tracing(
        str(tmp_path / "t.json"))))
    want = json.load(open(jprof.export_chrome_tracing(
        str(tmp_path / "j.json"))))
    for ev in got["traceEvents"] + want["traceEvents"]:
        if ev["ph"] == "C":
            del ev["ts"]          # the memory event's own clock read
    assert got == want


def test_record_event_nests_and_op_profiling_is_scoped():
    with tprof.RecordEvent("outer"):
        with tprof.RecordEvent("inner"):
            pass
    evs = {e["name"]: e for e in tprof.events()}
    assert evs["inner"]["depth"] == 1 and evs["outer"]["depth"] == 0
    assert evs["outer"]["dur"] >= evs["inner"]["dur"]
    x = torch.ones(4, 4)
    with tprof.profile(op_detail=True):
        assert tprof.is_op_profiling_enabled()
        (torch.mm(x, x) + x).sum()
    assert not tprof.is_op_profiling_enabled()
    table = tprof.summary()
    assert "aten::mm" in table and "aten::add" in table
    assert "Calls" in table and "Total(us)" in table
    before = len(tprof.events())
    torch.mm(x, x)
    assert len(tprof.events()) == before
    stats = tprof.record_device_memory("probe", device="cpu")
    assert stats["bytes_in_use"] == 0
    assert tprof.mem_events()[-1]["annotation"] == "probe"
