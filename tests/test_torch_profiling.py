"""mmd_tpu_torch/profiling.py's reduction of a torch.profiler window, on
made-up events (record-function ranges left out), and profile_kernels.py's reading of ptxas output (the
profilers themselves need a card, the ptxas report nvcc)."""

from collections import namedtuple

import pytest
import torch
from torch.autograd import DeviceType

from mmd_tpu_torch import profile_kernels
from mmd_tpu_torch.profiling import device_summary

Evt = namedtuple("Evt", "key device_type device_time_total count")


def test_device_summary_names_groups_and_idle_share():
    cuda, cpu = DeviceType.CUDA, DeviceType.CPU
    events = [Evt("void flash_fwd_kernel<32, float>", cuda, 3000.0, 2),
              Evt("ampere_sgemm_128x64_nn", cuda, 1000.0, 4),
              Evt("aten::mm", cpu, 5000.0, 4),
              Evt("Memcpy HtoD (Pageable -> Device)", cuda, 500.0, 1),
              Evt("some_kernel", cuda, 500.0, 1)]
    kernels = {"flash_fwd_kernel": "flash_attn_fwd",
               "dropout_kernel": "dropout"}
    s = device_summary(events, 10.0, kernels,
                       (("some", "mine"),), top=2)
    assert s["device_busy_ms"] == 5.0          # the host operator left out
    assert s["idle_share"] == 0.5
    assert s["device_events"] == 8
    assert s["device_ms_by_group"] == {"flash_attn_fwd": 3.0, "other": 1.5,
                                       "mine": 0.5}
    assert list(s["device_ms_top"]) == ["flash_attn_fwd",
                                        "ampere_sgemm_128x64_nn"]
    assert s["kernels_ms"] == {"flash_attn_fwd": 3.0, "dropout": 0.0}
    s = device_summary(events, 10.0, kernels)
    assert s["device_ms_by_group"] == {"flash_attn_fwd": 3.0, "matmul": 1.0,
                                       "copies": 0.5, "other": 0.5}


Ann = namedtuple("Ann", "key device_type device_time_total count "
                        "is_user_annotation")


def test_device_summary_leaves_out_record_function_ranges():
    """A record-function range on the card (AdamW.step) spans kernels that
    are counted on their own: its time is not counted again."""
    cuda = DeviceType.CUDA
    events = [Ann("Optimizer.step#AdamW.step", cuda, 2000.0, 1, True),
              Ann("void multi_tensor_apply_kernel<>", cuda, 1500.0, 3,
                  False),
              Ann("void flash_fwd_kernel<32, float>", cuda, 500.0, 1,
                  False)]
    s = device_summary(events, 4.0, {"flash_fwd_kernel": "flash_attn_fwd"},
                       (("multi_tensor_apply", "optimizer"),))
    assert s["device_busy_ms"] == 2.0
    assert s["idle_share"] == 0.5
    assert s["device_events"] == 4
    assert s["device_ms_by_group"] == {"optimizer": 1.5,
                                       "flash_attn_fwd": 0.5}
    assert "Optimizer.step#AdamW.step" not in s["device_ms_top"]


PTXAS_LOG = """\
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_Z4dkdvILi64EEvv' for 'sm_90a'
ptxas info    : Function properties for _Z4dkdvILi64EEvv
    16 bytes stack frame, 12 bytes spill stores, 20 bytes spill loads
ptxas info    : Used 168 registers, used 1 barriers, 16 bytes cumulative stack size
ptxas info    : Compiling entry function '_Z6rowdotv' for 'sm_90a'
ptxas info    : Function properties for _Z6rowdotv
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 30 registers, used 0 barriers
"""


def test_parse_ptxas_reads_registers_and_spills():
    assert profile_kernels.parse_ptxas(PTXAS_LOG) == [
        {"kernel": "_Z4dkdvILi64EEvv", "stack": 16, "spill_stores": 12,
         "spill_loads": 20, "registers": 168},
        {"kernel": "_Z6rowdotv", "stack": 0, "spill_stores": 0,
         "spill_loads": 0, "registers": 30}]


def test_flash_calls_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("the refusal shows only without a CUDA device")
    with pytest.raises(SystemExit, match="CUDA device"):
        profile_kernels.main(["flash_calls"])


def test_swin_calls_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("the refusal shows only without a CUDA device")
    with pytest.raises(SystemExit, match="CUDA device"):
        profile_kernels.main(["swin_calls"])


def test_swin_bwd_calls_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("the refusal shows only without a CUDA device")
    with pytest.raises(SystemExit, match="CUDA device"):
        profile_kernels.main(["swin_bwd_calls"])


def test_swin_infer_calls_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("the refusal shows only without a CUDA device")
    with pytest.raises(SystemExit, match="CUDA device"):
        profile_kernels.main(["swin_infer_calls"])


def test_mlp_bwd_calls_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("the refusal shows only without a CUDA device")
    with pytest.raises(SystemExit, match="CUDA device"):
        profile_kernels.main(["mlp_bwd_calls"])


def test_mlp_fwd_calls_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("the refusal shows only without a CUDA device")
    with pytest.raises(SystemExit, match="CUDA device"):
        profile_kernels.main(["mlp_fwd_calls"])


def test_topk_calls_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("the refusal shows only without a CUDA device")
    with pytest.raises(SystemExit, match="CUDA device"):
        profile_kernels.main(["topk_calls"])


def test_ptxas_remarks_keep_warnings_and_serialized_wgmma():
    log = PTXAS_LOG + (
        "ptxas info    : (C7514) Potential Performance Loss: wgmma.mma_async "
        "instructions are serialized due to non wgmma instructions reading "
        "accumulator registers\n"
        "x.cu(3): warning #177-D: variable \"n\" was declared but never "
        "referenced\n")
    got = profile_kernels.ptxas_remarks(log)
    assert len(got) == 2
    assert "C7514" in got[0] and "warning #177-D" in got[1]


def test_ln_calls_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("the refusal shows only without a CUDA device")
    with pytest.raises(SystemExit, match="CUDA device"):
        profile_kernels.main(["ln_calls"])
